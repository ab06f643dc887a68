#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and `nvcc`.
It imports only the port (`src/repro_torch`), never JAX or the reference
package, and runs these phases:

  1. build   compile the hand-written kernels (`kernels/csrc/*.cu`, one
             nvcc per source, started together) for sm_90a; print the build
             time, the card's name and power limit.
  2. kernel vs plain
             the prologue's radix sort against `torch.sort(stable=True)`
             (order and sorted slots bit for bit) at n=2**22, p=16384 on
             uniform, Zipf 0.99, all_same, all-IDLE, out-of-range and any
             int32 slots, and at p = 1, 700, 3000 and 2**20 (512 tiles);
             the passes it ran (3 at n=2**22); then the four engine-round
             kernels (`round_prologue`, `fast_round`, `slow_round`,
             `round_epilogue`) against their plain PyTorch versions on the
             card, bit for bit on every output and on the updated table,
             the last three with their branch taken and not taken (then
             nothing may change): spectra none / low / all_same, a long
             segment with chained CAS lanes and later links (k = 3, 5, 20),
             all seven op kinds, several k (odd included), and the main
             path's shapes (Zipf 0.99 and the long segment too); then the
             four kernels as `make_round` runs them against the plain round
             (`make_round(mode="xla")`) at n=2**22, k=4, p=2**20 on both
             branches (1024 epilogue tiles, more than the card holds at
             once: the epilogue's blocks take tickets).
  3. main path
             `atomics.apply` at n=2**22, k=4, p=16384 for seqlock, indirect,
             cached_wf and cached_me: (a) distinct slots, all kinds; (b)
             read-only with duplicate slots; (c) uniform slots, 20 %
             updates; (d) Zipf 0.99 slots, 20 % updates; (e) an LL batch,
             then SC/VALIDATE on the linked slots.  Launch counts are reset
             just before and read just after; the four kernels must have
             run, and each batch must have taken the branch its predicate
             (read after the batch) names.  The same batches replay through
             the numpy sequential oracle: results, links, logical values,
             versions and `read()` must agree exactly.
  3b. table ops
             the raw-table layer (`kernels/ops.py`, `llsc_commit`): its five
             kernels against their plain versions (k = 1, 3, 4, 5, 16,
             CacheHash kw/vw = 1/1, 2/2, 4/2, and full width;
             `cas_apply_rounds` against the round loop on uniform, Zipf
             0.99, one hot cell, LOAD lanes, truncated rounds and negative
             ranks), then, with the counts reset, `bigatomic_load`,
             `bigatomic_update_rounds` (uniform, Zipf 0.99, one hot cell:
             one `cas_apply_rounds` launch each, no `cas_apply_round`),
             `llsc_commit_round`, `commit_round` on cached_me and
             `cachehash_find` at n = m = 2**22, p = q = 16384, each equal to
             a numpy oracle; the path's four kernels must have run, and
             `commit_round` must have taken the fast branch.  Then each
             entry point's
             and kernel's time, the plain versions', the round loop's it
             replaced, and the device-busy share.
  4. timing  per layout and batch (a), (c), (d): one `apply` (donate)
             captured in a CUDA graph and replayed once, which must equal
             the eager `apply` and the numpy oracle (a capture that fails
             fails the phase); then the median time per `apply`, eager and
             replayed (CUDA events), the device operations and device time
             of each (torch.profiler), the branch the batch took (its
             predicate, read after the timed window), the four kernels
             alone, their plain versions, `torch.sort` alone (the
             prologue's library yardstick), and the host-side steps around
             them; the run fails if a layout's device operations per eager
             `apply` exceed `DEVICE_OPS_LIMIT`, if a device operation of
             `torch.sort` or the sort key's `masked_fill` shows in the
             profiled `apply`, or if a memset runs right before a round
             kernel; then `slow_round` alone on one cell, a long segment,
             Zipf 0.99, and Zipf 0.99 at k = 20, each beside its longest
             segment.
  5. guard   the integrity scrub (`guard`, `runtime.LocalTarget`): the
             digest kernel bit for bit against its plain version (k = 1,
             3, 4, 5, 16 at n = 1003; full width, also against numpy);
             then, with the counts reset, per layout at n=2**22: batch (a),
             a checkpoint, a STORE batch to 4096 distinct cells, the
             baseline digest, 64 seeded bit flips and torn writes on
             distinct cells (half dirty; a `bptr` flip on indirect and
             cached_wf, a version flip on cached_me), `Scrubber.scrub`:
             detected = the injected cells, repaired = the clean ones with
             the checkpoint's values, quarantined = the dirty ones, the
             invariants naming the pointer and version faults; a batch
             through `mask_ops` equal to the numpy oracle with every
             poisoned lane failed; a second scrub clean.  Then the times of
             `cell_digest`, the digest kernel, its plain version,
             `check_invariants` and `Scrubber.scrub`, and of the
             whole-table row gather (`table[idx]` against
             `layout.gather_rows`, 2**22 rows of 16 bytes).
  6. attention
             `flash_attention` against `flash_attention_plain` at the
             attention widths of glm4_9b (t=4096, causal, bf16),
             mixtral_8x7b (t=8192, window 4096, bf16 and fp32),
             hubert_xlarge (t=4096, hd=80, bidirectional, bf16) and
             recurrentgemma_9b (t=4096, hd=256, kvh=1, window 2048, bf16),
             a ragged fp32 case (t=1000), bf16 at hd=64 (t=4096), three
             ragged bf16 cases at b=2 (t=1000, and tq != tkv), hd=16 at
             b=2 (tq 1000, tkv 1200) in bf16 and fp32, and bf16 at hd=100
             (t=1000), with the counts reset (bf16 within 1e-3 + 1e-2
             |want|, fp32 within 1e-4 + 1e-4 |want|); each case must have
             launched the kernel it names (`kernel_for`: the wgmma kernel
             for bf16 at hd 16 / 32 / 64 / 80 / 128 / 256, the 3xTF32
             kernel for fp32 at hd 16 / 32 / 64 / 80 / 128, the CUDA-core
             kernel for the rest, here hd 100); then each case's time, its
             bound (operations over the peak of the kernel's type, three
             passes on the 3xTF32 kernel), the plain version's and
             `scaled_dot_product_attention`'s.

Exits non-zero on any failure, without the result line.  On success the
last lines are the card (nvidia-smi), a JSON line with one entry per
kernel, and `{"ok": true, "device": {...}}`.  Details go to
`chiprun_out/chip_smoke.json`.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
N, K, P = 2 ** 22, 4, 16384
STRATEGIES = ("seqlock", "indirect", "cached_wf", "cached_me")
HBM_BYTES_PER_S = 3.35e12       # H100 SXM published memory rate
TABLE_OPS_CU = "src/repro_torch/kernels/csrc/table_ops.cu"
KERNELS = {
    "fast_round": ("src/repro_torch/kernels/csrc/engine_round.cu",
                   "src/repro/kernels/engine_round.py:340"),
    "slow_round": ("src/repro_torch/kernels/csrc/engine_round.cu",
                   "src/repro/kernels/engine_round.py:506"),
    # the host code around the two Pallas rounds: the sort, the predicate
    # (`fast_path_ok`) and the gathers into the sorted order before them,
    # the rebuild and stats after them (`_slow_pallas`, `_assemble_fast`)
    "round_prologue": ("src/repro_torch/kernels/csrc/engine_round.cu",
                       "src/repro/kernels/engine_round.py:103"),
    "round_epilogue": ("src/repro_torch/kernels/csrc/engine_round.cu",
                       "src/repro/kernels/engine_round.py:525"),
    "seqlock_gather": (TABLE_OPS_CU, "src/repro/kernels/seqlock_gather.py:105"),
    "cas_apply_round": (TABLE_OPS_CU, "src/repro/kernels/cas_apply.py:154"),
    "cas_apply_rounds": (TABLE_OPS_CU, "src/repro/kernels/cas_apply.py:154"),
    "llsc_commit_round": (TABLE_OPS_CU,
                          "src/repro/kernels/llsc_commit.py:77"),
    "cachehash_probe": (TABLE_OPS_CU,
                        "src/repro/kernels/cachehash_probe.py:81"),
    "digest_rows": ("src/repro_torch/kernels/csrc/scrub_digest.cu",
                    "src/repro/guard/scrub.py:91"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:120"),
    "flash_attention_wgmma": (
        "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
        "src/repro/kernels/flash_attention.py:120"),
    "flash_attention_tf32x3": (
        "src/repro_torch/kernels/csrc/flash_attention_tf32x3.cu",
        "src/repro/kernels/flash_attention.py:120"),
}
ROUND_KERNELS = ("round_prologue", "fast_round", "slow_round",
                 "round_epilogue")
TABLE_KERNELS = ("seqlock_gather", "cas_apply_round", "cas_apply_rounds",
                 "llsc_commit_round", "cachehash_probe")
TABLE_PATH_KERNELS = ("seqlock_gather", "cas_apply_rounds",
                      "llsc_commit_round", "cachehash_probe")
GUARD_STORES, GUARD_FAULTS = 4096, 64      # the scrub path's batch, faults
M, KW, VW, MAX_CHAIN = 2 ** 22, 2, 2, 8     # CacheHash: buckets, key/value
STORE, CAS, FULL = 1, 2, 1                  # words, chain depth; constants
NEXT_END = 2 ** 32 - 1                      # next word of a chain's end
# Device operations per eager `apply` at the timing phase's shapes: with
# the sort as `torch.sort` and a memset before each of the prologue and the
# epilogue (the round before the sort moved into the prologue), and the
# most this version may take, its own count.  The count is exact, not a
# mean: the host launches the same operations on every call (it reads
# nothing back), and it is taken from a call whose every launch left its
# device operation in the trace.
TORCH_SORT_DEVICE_OPS = {"seqlock": 37, "indirect": 55, "cached_wf": 62,
                         "cached_me": 55}
DEVICE_OPS_LIMIT = {"seqlock": 18, "indirect": 36, "cached_wf": 43,
                    "cached_me": 36}
# Device operations an `apply` no longer runs: `torch.sort`'s kernels and
# the sort key's masked fill.
OLD_SORT_OPS = ("RadixSort", "radix_sort", "masked_fill", "sort_postprocess",
                "segmented_sort", "fill_index")
# The CUDA API calls that put an operation on the device.
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cuMemcpy",
                "cudaMemset", "cuMemset", "cudaGraphLaunch", "cuGraphLaunch")
# The first kernel each round-kernel wrapper launches.
ROUND_FIRST_KERNELS = ("round_prologue_kernel", "round_epilogue_kernel")
SORT_SPECTRA = ("uniform", "zipf", "all_same", "all_idle", "out_of_range",
                "int32")


def log(*args):
    print(*args, flush=True)


def ops_by_call(events, device, reps):
    """The device operations of each of `reps` annotated calls
    (`smoke_call_<i>`) in a profiler trace's `events`, each operation in
    `device` found by its launch's correlation id, each launch by the
    host-side annotation around it; and the counts of the calls whose
    every launch left its operation in the trace."""
    spans = {ev["name"]: (ev["ts"], ev["ts"] + ev["dur"]) for ev in events
             if ev.get("cat") == "user_annotation" and
             ev.get("name", "").startswith("smoke_call_")}
    spans = [spans.get(f"smoke_call_{i}") for i in range(reps)]
    launch_call = {}                        # correlation id -> call
    for ev in events:
        corr = ev.get("args", {}).get("correlation")
        if corr is None or not ev.get("name", "").startswith(LAUNCH_CALLS):
            continue
        for i, span in enumerate(spans):
            if span and span[0] <= ev["ts"] <= span[1]:
                launch_call[corr] = i
    missing = [0] * reps                    # launches with no operation
    for i in launch_call.values():
        missing[i] += 1
    ops = [0] * reps
    seen = set()
    for ev in device:
        corr = ev.get("args", {}).get("correlation")
        if corr in launch_call:
            ops[launch_call[corr]] += 1
            if corr not in seen:
                seen.add(corr)
                missing[launch_call[corr]] -= 1
    return ops, [ops[i] for i in range(reps)
                 if ops[i] and missing[i] == 0]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


class Smoke:
    def __init__(self, torch, atomics, engine, er, convert, tk):
        self.torch, self.atomics, self.engine = torch, atomics, engine
        self.er, self.convert, self.tk = er, convert, tk
        self.dev = torch.device("cuda", 0)
        self.max_err = dict.fromkeys(KERNELS, 0)

    # -- helpers -------------------------------------------------------------

    def words(self, arr):
        return self.convert.tensor(arr, self.dev, word=True)

    def np_words(self, t):
        return self.convert.array(t, word=True)

    def time_ms(self, fn, reps=20, warmup=3, setup=None):
        """Median ms per call, CUDA events around each call.  With `setup`,
        each call is `fn(*setup())`, its operands made and synchronised
        before its events: a call that updates its operands in place is
        timed on fresh copies of them."""
        torch = self.torch
        pairs = []
        for _ in range(warmup + reps):
            args = ()
            if setup is not None:
                args = setup()
                torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn(*args)
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in pairs[warmup:])

    def device_ms(self, fn, reps=20, setup=None):
        """Device ms per call of a launch-only `fn` (no host syncs): the
        calls queue behind a spin kernel, so the events bracket the
        kernels alone and not the host's time to launch them.  With
        `setup`, every call gets its own operands `setup()`, all made
        before the spin."""
        torch = self.torch
        fresh = [setup() if setup is not None else ()
                 for _ in range(reps + 1)]
        fn(*fresh[0])
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)       # ~50 ms while the host enqueues
        a.record()
        for args in fresh[1:]:
            fn(*args)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    def device_busy(self, run, reps=5, trace=None, setup=None):
        """Share of the wall time of `run` (which ends synchronised) that
        the card spends in kernels, memcpys and memsets, from a
        torch.profiler trace; plus the kernels' device time by name, and
        the device operations of each call (each operation found by its
        launch's correlation id, each launch by the call's annotation):
        `device_ops_per_apply` is the most among the calls whose every
        launch left its operation in the trace (the profiler can drop the
        first call's), None if none did.  With `setup`, each call is
        `run(*setup())`, made before the trace."""
        from torch.profiler import ProfilerActivity, profile, record_function
        torch = self.torch
        fresh = [setup() if setup is not None else () for _ in range(reps)]
        torch.cuda.synchronize()
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                for i, args in enumerate(fresh):
                    with record_function(f"smoke_call_{i}"):
                        run(*args)
                wall_us = (time.perf_counter() - t) * 1e6
            path = trace or (ROOT / "chiprun_out" / "apply_trace.tmp.json")
            prof.export_chrome_trace(str(path))
            events = json.loads(Path(path).read_text())["traceEvents"]
        except Exception as err:          # the profiler is optional here
            return {"error": f"not measured: {err!r}"}
        finally:
            torch.cuda.synchronize()
        busy, by_name = 0.0, {}
        device = sorted((ev for ev in events if ev.get("cat") in
                         ("kernel", "gpu_memcpy", "gpu_memset")),
                        key=lambda ev: ev.get("ts", 0.0))
        for ev in device:
            busy += ev.get("dur", 0.0)
            name = ev.get("name", "?")[:60]
            by_name[name] = by_name.get(name, 0.0) + ev.get("dur", 0.0)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        ops, whole = ops_by_call(events, device, reps)
        return {"device_busy_share": busy / wall_us,
                "device_ops": [(ev.get("cat"), ev.get("name", "?"))
                               for ev in device],
                "device_us_per_apply": busy / reps,
                "device_ops_per_apply": max(whole) if whole else None,
                "device_ops_by_call": ops,
                "top_device_us_per_apply": {k: v / reps for k, v in top}}

    def compare(self, name, got, want):
        """Bit-for-bit equality of kernel vs plain outputs; tracks the max
        absolute difference of the uint32 values (0 when equal)."""
        for i, (x, y) in enumerate(zip(got, want)):
            y = y.to(x.dtype)
            if not self.torch.equal(x, y):
                diff = (x.to(self.torch.int64) & 0xFFFFFFFF) - \
                    (y.to(self.torch.int64) & 0xFFFFFFFF)
                err = int(diff.abs().max())
                self.max_err[name] = max(self.max_err[name], err)
                raise SystemExit(f"{name}: output {i} differs from the plain "
                                 f"version (max abs err {err})")

    # -- batches ---------------------------------------------------------------

    @staticmethod
    def spectrum_batch(rng, n, k, p, spectrum, current, ver):
        """All seven kinds over slots: none (distinct), low (n / 8 slots),
        all_same (one cell), zipf (Zipf 0.99, as bench_atomics), long (60 %
        of the lanes on one cell, whose CAS lanes often expect the row an
        earlier lane wrote and whose links often match a later version)."""
        kind = rng.integers(0, 7, p).astype(np.int32)
        if spectrum == "none":
            slot = rng.choice(n, p, replace=False).astype(np.int32)
        elif spectrum == "low":
            slot = rng.integers(0, max(n // 8, 2), p).astype(np.int32)
        elif spectrum == "zipf":
            slot = ((rng.zipf(1.01, p) - 1) % n).astype(np.int32)
        elif spectrum == "long":
            slot = rng.integers(0, n, p).astype(np.int32)
            slot[rng.random(p) < 0.6] = rng.integers(0, n)
        else:
            slot = np.full(p, rng.integers(0, n), np.int32)
        expected = rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32)
        take = rng.random(p) < 0.5
        expected[take] = current[slot[take]]
        desired = rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32)
        cslot = np.where(rng.random(p) < 0.7, slot,
                         rng.integers(-1, n, p)).astype(np.int32)
        vnow = ver[np.clip(cslot, 0, n - 1)]
        cver = np.where(rng.random(p) < 0.8, vnow, vnow + 2).astype(np.uint32)
        if spectrum == "long":
            hot = np.flatnonzero(slot == np.bincount(slot).argmax())
            later = rng.random(len(hot)) < 0.4
            expected[hot[1:][later[1:]]] = desired[hot[:-1][later[1:]]]
            cver[hot] += (2 * rng.integers(0, len(hot) // 4 + 1,
                                           len(hot))).astype(np.uint32)
        ctx = (cslot, cver, np.zeros((p, k), np.uint32), rng.random(p) < 0.8)
        return (kind, slot, expected, desired), ctx

    def round_args(self, n, ops, ctx):
        """What the round hands its three kernels for `ops`: the batch and
        links on the card, the sort, the predicate, and the replay's sorted
        lane operands."""
        er = self.er
        ops = self.convert.op_batch(ops, self.dev)
        ctx = self.convert.link_ctx(ctx, self.dev)
        pro = er.round_prologue_plain(n, ops, ctx)
        return SimpleNamespace(
            ops=ops, ctx=ctx, s_slot=pro.s_slot, order=pro.order,
            s_kind=pro.s_kind, fast=pro.fast, slow=pro[2:7], prologue=pro)

    def round_out(self, p, k):
        """A `RoundOut` filled with values no kernel writes."""
        out = self.er.RoundOut.empty(p, k, self.dev)
        for t in (out.value, out.ctx.slot, out.ctx.version, out.ctx.value,
                  out.okw, out.stats, out.dirty):
            t.fill_(-7)
        out.success.fill_(True)
        out.ctx.linked.fill_(True)
        return out

    @staticmethod
    def out_tensors(out):
        return (out.value, out.success, *out.ctx, out.okw, out.stats,
                out.dirty)

    def flag(self, value):
        return self.torch.tensor(value, device=self.dev)

    # -- phase 2 -------------------------------------------------------------

    @staticmethod
    def sort_batch(rng, n, p, spectrum):
        """(kind, slot) of p lanes for the sort: uniform slots in [0, n),
        Zipf 0.99, one slot, every lane IDLE, active lanes on negative
        slots and slots >= n among uniform ones, or any int32; a quarter
        of the lanes IDLE (all_idle: all)."""
        kind = rng.integers(0, 7, p).astype(np.int32)
        kind[rng.random(p) < 0.25] = 3
        if spectrum == "zipf":
            slot = (rng.zipf(1.01, p) - 1) % n
        elif spectrum == "all_same":
            slot = np.full(p, rng.integers(0, n))
        elif spectrum == "int32":
            slot = rng.integers(-2 ** 31, 2 ** 31, p)
        else:
            slot = rng.integers(0, n, p)
        if spectrum == "all_idle":
            kind[:] = 3
        if spectrum == "out_of_range":
            bad = rng.random(p) < 0.2
            slot[bad] = rng.choice(np.array([-1, -2 ** 31, n, n + 1,
                                             2 ** 31 - 1]), int(bad.sum()))
            kind[bad] = rng.integers(0, 7, int(bad.sum()))
        return kind, slot.astype(np.int32)

    def sort_vs_torch(self, n, p, spectrum, seed):
        """The prologue's sort against `torch.sort(stable=True)` of the same
        keys (`sort_slots`), order and sorted slots bit for bit; returns the
        passes it ran (the digits that vary, left in its scratch)."""
        er, torch = self.er, self.torch
        rng = np.random.default_rng(seed)
        kind, slot = self.sort_batch(rng, n, p, spectrum)
        zeros = np.zeros((p, K), np.uint32)
        ops = self.convert.op_batch((kind, slot, zeros, zeros), self.dev)
        ctx = self.convert.link_ctx((slot, np.zeros(p, np.uint32), zeros,
                                     np.ones(p, bool)), self.dev)
        got = er.round_prologue(n, ops, ctx)
        want = er.sort_slots(n, ops)
        torch.cuda.synchronize()
        self.compare("round_prologue", (got.s_slot, got.order), want)
        return bin(int(got.scratch[1])).count("1")

    def kernel_vs_plain(self, n, k, p, spectrum, seed):
        """Each kernel against its plain version: `round_prologue` on the
        batch and on its collision-free or read-only form; with its branch
        taken and not taken, `slow_round` on the batch, `fast_round` on the
        other form, and `round_epilogue` after each."""
        er, torch = self.er, self.torch
        rng = np.random.default_rng(seed)
        data = rng.integers(0, 2 ** 32, (n, k), dtype=np.uint32)
        ver = (rng.integers(0, 8, n) * 2).astype(np.uint32)
        ops, ctx = self.spectrum_batch(rng, n, k, p, spectrum, data, ver)
        d, v = self.words(data), self.words(ver)
        # the fast kernel's contract: collision-free, or else read-only
        kind = ops[0]
        read_only = np.where(np.isin(kind, [1, 2, 5]), 0, kind)
        fast_ops = ops if spectrum == "none" else \
            (read_only.astype(np.int32), *ops[1:])

        r = self.round_args(n, ops, ctx)
        rf = self.round_args(n, fast_ops, ctx)
        for rr in (r, rf):
            got = er.round_prologue(n, rr.ops, rr.ctx)
            torch.cuda.synchronize()
            self.compare("round_prologue", got[:7], rr.prologue[:7])
        for taken in (False, True):           # the slow branch taken
            fast = self.flag(not taken)
            got = er.slow_round(d.clone(), v.clone(), *r.slow, fast=fast)
            want = er.slow_round_plain(d.clone(), v.clone(), *r.slow,
                                       fast=fast)
            torch.cuda.synchronize()
            self.compare("slow_round", got if taken else got[:2],
                         want if taken else (d, v))
        slow_ver, slow_out = want[1], want[2:]

        if not bool(rf.fast):
            raise SystemExit(f"{spectrum}: the fast batch fails the predicate")
        for taken in (False, True):
            fast = self.flag(taken)
            dk, vk, dp, vp = d.clone(), v.clone(), d.clone(), v.clone()
            got = er.fast_round(fast, dk, vk, rf.ctx, rf.ops,
                                self.round_out(p, k))
            want = er.fast_round_plain(fast, dp, vp, rf.ctx, rf.ops,
                                       self.round_out(p, k))
            torch.cuda.synchronize()
            self.compare("fast_round", (dk, vk, *self.out_tensors(got)),
                         (dp, vp, *self.out_tensors(want)))
            if not taken:
                self.compare("fast_round", (dk, vk, *self.out_tensors(got)),
                             (d, v, *self.out_tensors(self.round_out(p, k))))

        # the epilogue after either branch; after the fast one it must
        # leave the fast round's lane outputs alone
        for rr, fast, out, version, outs in (
                (r, self.flag(False), self.round_out(p, k), slow_ver,
                 slow_out),
                (rf, rf.fast, want, vp, None)):
            if outs is None:
                outs = er.slow_round(dp.clone(), vp.clone(), *rr.slow,
                                     fast=fast)[2:]
            got, mine = (er.RoundOut(*(clone(x) if isinstance(x, tuple)
                                       else x.clone() for x in out))
                         for _ in range(2))
            args = (fast, n, rr.ctx, rr.order, rr.s_slot, rr.s_kind, *outs,
                    version)
            er.round_epilogue(*args, got, er.round_scratch(p, self.dev))
            er.round_epilogue_plain(*args, mine)
            torch.cuda.synchronize()
            self.compare("round_epilogue", self.out_tensors(got),
                         self.out_tensors(mine))
            if bool(fast):
                self.compare("round_epilogue", self.out_tensors(got)[:7],
                             self.out_tensors(out)[:7])

    def round_vs_plain_round(self, n, k, p, spectrum, seed):
        """The round's four kernels as `make_round` runs them against the
        plain round (`make_round(mode="xla")`) on the same table and batch:
        table, links, results, stats and dirty list bit for bit.  Returns
        the branch taken."""
        er, torch = self.er, self.torch
        rng = np.random.default_rng(seed)
        data = rng.integers(0, 2 ** 32, (n, k), dtype=np.uint32)
        ver = (rng.integers(0, 8, n) * 2).astype(np.uint32)
        ops_np, ctx_np = self.spectrum_batch(rng, n, k, p, spectrum, data,
                                             ver)
        ops = self.convert.op_batch(ops_np, self.dev)
        ctx = self.convert.link_ctx(ctx_np, self.dev)
        d, v = self.words(data), self.words(ver)
        got, want = (er.make_round(n, k, mode=mode)(d.clone(), v.clone(),
                                                    ctx, ops)
                     for mode in ("pallas", "xla"))
        torch.cuda.synchronize()

        def flat(out):
            return [x for part in out for x in
                    (part if isinstance(part, tuple) else (part,))]

        self.compare("round_epilogue", flat(got), flat(want))
        return self.branch(ops)

    # -- phase 3 -------------------------------------------------------------

    @staticmethod
    def update_mix(rng, slot, p, k, current):
        u = rng.random(p) < 0.2
        kind = np.where(u, np.where(rng.random(p) < 0.5, 2, 1), 0)
        expected = rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32)
        take = rng.random(p) < 0.5
        expected[take] = current[slot[take]]
        return (kind.astype(np.int32), slot.astype(np.int32), expected,
                rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32))

    def main_batch(self, name, rng, current, ctx_slot):
        n, k, p = N, K, P
        words = rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32)
        zeros = np.zeros((p, k), np.uint32)
        if name == "a_distinct_all_kinds":
            slot = rng.choice(n, p, replace=False).astype(np.int32)
            expected = np.where((rng.random(p) < 0.5)[:, None],
                                current[slot], words)
            return (rng.integers(0, 7, p).astype(np.int32), slot, expected,
                    rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32))
        if name == "b_read_only_dup":
            kind = rng.choice([0, 3, 4, 6], p).astype(np.int32)
            return (kind, rng.integers(0, 1024, p).astype(np.int32), zeros,
                    zeros)
        if name == "c_uniform_u20":
            return self.update_mix(rng, rng.integers(0, n, p), p, k, current)
        if name == "d_zipf099_u20":
            slot = (rng.zipf(1.01, size=p) - 1) % n   # as bench_atomics
            return self.update_mix(rng, slot, p, k, current)
        if name == "e1_ll":
            return (np.full(p, 4, np.int32),
                    rng.integers(0, n, p).astype(np.int32), zeros, zeros)
        kind = np.where(rng.random(p) < 0.7, 5, 6).astype(np.int32)
        return kind, ctx_slot.astype(np.int32), zeros, words

    def branch(self, ops):
        """The branch the round takes for `ops`: its predicate, read back."""
        return "fast" if bool(self.er.fast_path_ok(N, ops)) else "slow"

    def main_path(self, strategy, seed):
        """Drive `atomics.apply` through batches (a)-(e); returns the
        recorded batches and outputs, plus per-batch branches."""
        atomics, torch = self.atomics, self.torch
        spec = atomics.AtomicSpec(N, K, strategy, p_max=P)
        rng = np.random.default_rng(seed)
        initial = rng.integers(0, 2 ** 32, (N, K), dtype=np.uint32)
        state = atomics.init(spec, initial, device=self.dev)
        ctx = atomics.init_ctx(P, K, device=self.dev)
        record = []
        names = ["a_distinct_all_kinds", "b_read_only_dup", "c_uniform_u20",
                 "d_zipf099_u20", "e1_ll", "e2_sc_validate"]
        torch.cuda.synchronize()
        self.tk.reset_launch_counts()
        t0 = time.perf_counter()
        for name in names:
            current = self.np_words(atomics.logical(spec, state))
            ops = self.main_batch(name, rng, current,
                                  ctx.slot.cpu().numpy())
            batch = self.convert.op_batch(ops, self.dev)
            state, ctx, res, stats, traffic = atomics.apply(
                spec, state, batch, ctx, donate=True)
            record.append((name, ops, self.branch(batch),
                           self.convert.to_numpy(res),
                           self.convert.to_numpy(ctx),
                           {f: int(x) for f, x in zip(stats._fields, stats)}))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: self.tk.WRAPPERS[name].launches
                    for name in ROUND_KERNELS}
        final = (self.np_words(atomics.logical(spec, state)),
                 self.np_words(state.version))
        vals, ok = atomics.read(spec, state, np.arange(N))
        return (spec, state, initial, record, launches, final,
                (self.np_words(vals), ok.cpu().numpy()), wall)

    def check_main_path(self, strategy, initial, record, launches, final,
                        read):
        engine = self.engine
        expect = {"a_distinct_all_kinds": "fast", "b_read_only_dup": "fast",
                  "c_uniform_u20": "slow", "d_zipf099_u20": "slow",
                  "e1_ll": "fast"}
        data, ver = initial.copy(), np.zeros(N, np.uint32)
        ctx = (np.full(P, -1, np.int32), np.zeros(P, np.uint32),
               np.zeros((P, K), np.uint32), np.zeros(P, bool))
        for name, ops, branch, res, got_ctx, stats in record:
            if name in expect and branch != expect[name]:
                raise SystemExit(f"{strategy}/{name}: took the {branch} "
                                 f"branch, expected {expect[name]}")
            moved = None
            data, ver_next, ctx, ref = engine.apply_ops_reference(
                data, ver, ctx, ops)
            moved = int((ver_next != ver).sum())
            ver = ver_next
            if stats["n_dirty_cells"] != moved:
                raise SystemExit(f"{strategy}/{name}: n_dirty_cells "
                                 f"{stats['n_dirty_cells']}, oracle {moved}")
            for what, a, b in (("value", res[0], ref.value),
                               ("success", res[1], ref.success),
                               *((f"ctx.{f}", x, y) for f, x, y in zip(
                                   engine.LinkCtx._fields, got_ctx, ctx))):
                if not np.array_equal(a, b):
                    raise SystemExit(f"{strategy}/{name}: {what} differs "
                                     "from the sequential oracle")
        if not (np.array_equal(final[0], data)
                and np.array_equal(final[1], ver)):
            raise SystemExit(f"{strategy}: final table differs from oracle")
        vals, ok = read
        if not ok.all() or not np.array_equal(vals, data):
            raise SystemExit(f"{strategy}: read() differs from logical")
        for name, count in launches.items():
            if count <= 0:
                raise SystemExit(f"{strategy}: {name} never launched on the "
                                 "main path")

    # -- phase 4 -------------------------------------------------------------

    def captured_apply(self, spec, state, ops, ctx, ops_np):
        """One `apply` (donate) of `ops` captured in a CUDA graph on a copy
        of `state` and replayed once: it must equal the eager `apply` on
        another copy, field by field, and the numpy oracle.  Returns the
        graph (replaying it again re-runs the batch on its copy)."""
        atomics, torch, engine = self.atomics, self.torch, self.engine
        eager = atomics.apply(spec, clone(state), ops, ctx, donate=True)
        mine = clone(state)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                out = atomics.apply(spec, mine, ops, ctx, donate=True)
            graph.replay()
            torch.cuda.synchronize()
        except Exception as err:           # a failed capture fails the phase
            raise SystemExit(f"{spec.strategy}: capturing apply in a CUDA "
                             f"graph failed: {err!r}") from err
        for part, (a, b) in enumerate(zip(out, eager)):
            for i, (x, y) in enumerate(zip(a, b)):
                if not torch.equal(x, y):
                    raise SystemExit(f"{spec.strategy}: the replayed apply "
                                     f"differs from the eager one (output "
                                     f"{part}.{i})")
        data, ver, o_ctx, ref = engine.apply_ops_reference(
            self.np_words(atomics.logical(spec, state)),
            self.np_words(state.version), self.convert.to_numpy(ctx), ops_np)
        got = (self.np_words(atomics.logical(spec, out[0])),
               self.np_words(out[0].version),
               *self.convert.to_numpy(out[1]),
               *self.convert.to_numpy(out[2]))
        for i, (x, y) in enumerate(zip(got, (data, ver, *o_ctx, *ref))):
            if not np.array_equal(x, y):
                raise SystemExit(f"{spec.strategy}: the replayed apply "
                                 f"differs from the oracle (output {i})")
        return graph

    def timing(self, strategy, spec, state, rng):
        """Per batch (a), (c), (d): the captured apply checked, then the
        median ms per apply eager and replayed, their device operations and
        time, the branch, the kernels alone, their plain versions, and the
        host-side steps around them."""
        atomics, engine, er, torch = (self.atomics, self.engine, self.er,
                                      self.torch)
        impl = atomics.get_strategy(strategy)
        ctx = atomics.init_ctx(P, K, device=self.dev)
        out = {}
        for name in ("a_distinct_all_kinds", "c_uniform_u20",
                     "d_zipf099_u20"):
            current = self.np_words(atomics.logical(spec, state))
            ops_np = self.main_batch(name, rng, current, None)
            ops = self.convert.op_batch(ops_np, self.dev)
            graph = self.captured_apply(spec, state, ops, ctx, ops_np)
            row = {}
            host = []
            # the table the batch was made for, for the kernels alone
            d = impl.engine_view(state).clone()
            v = state.version.clone()

            def run():
                nonlocal state
                t = time.perf_counter()
                state, *_ = atomics.apply(spec, state, ops, ctx, donate=True)
                torch.cuda.synchronize()
                host.append(time.perf_counter() - t)

            def replay():
                graph.replay()
                torch.cuda.synchronize()

            row["apply_ms"] = self.time_ms(run)
            row["apply_host_clock_ms"] = statistics.median(host) * 1e3
            row["ops_per_s"] = P / (row["apply_ms"] * 1e-3)
            row["replay_ms"] = self.time_ms(graph.replay)
            row["replay_device_ms"] = self.device_ms(graph.replay)
            row["branch"] = self.branch(ops)
            r = self.round_args(N, ops_np, self.convert.to_numpy(ctx))
            fast = r.fast

            def fresh():
                return d.clone(), v.clone()

            def fast_kernel(dd, vv, plain=False):
                fn = er.fast_round_plain if plain else er.fast_round
                return fn(fast, dd, vv, r.ctx, r.ops, out_buf)

            def slow_kernel(dd, vv, plain=False):
                fn = er.slow_round_plain if plain else er.slow_round
                return fn(dd, vv, *r.slow, fast=fast)

            out_buf = self.round_out(P, K)
            dd, vv = fresh()                 # the round's table, as it runs
            fast_kernel(dd, vv)
            slow_out = slow_kernel(dd, vv)[2:]

            def epilogue(scratch, plain=False):
                fn = er.round_epilogue_plain if plain else er.round_epilogue
                return fn(fast, N, r.ctx, r.order, r.s_slot, r.s_kind,
                          *slow_out, vv, out_buf, scratch)

            def prologue(plain=False):
                fn = er.round_prologue_plain if plain else er.round_prologue
                return fn(N, r.ops, r.ctx)

            def scratch():                   # as a prologue leaves it
                return (er.round_scratch(P, self.dev),)

            kernels = {}
            for kname, call, setup in (("round_prologue", prologue, None),
                                       ("fast_round", fast_kernel, fresh),
                                       ("slow_round", slow_kernel, fresh),
                                       ("round_epilogue", epilogue,
                                        scratch)):
                kernels[kname] = {
                    "ms": self.device_ms(call, setup=setup),
                    "with_launch_ms": self.time_ms(call, setup=setup),
                    "plain_ms": self.time_ms(
                        lambda *a: call(*a, plain=True), reps=5, warmup=1,
                        setup=setup)}
            row["kernels"] = kernels
            key = er.sort_key(N, r.ops)
            kernels["round_prologue"]["library_ms"] = self.device_ms(
                lambda: torch.sort(key, stable=True))
            steps = {
                "check_kinds": lambda: engine.check_kinds(
                    ops.kind, engine.TABLE_KINDS, "table"),
                "sort": lambda: er.sort_slots(N, ops),
            }
            scratch = clone(state)
            stats = engine.ApplyStats(*(torch.full(
                (), P, dtype=torch.int32, device=self.dev) for _ in range(6)))
            dirty = torch.arange(P, dtype=torch.int32, device=self.dev) * 7
            steps["commit"] = lambda: impl.commit(
                scratch, scratch.data, scratch.version, stats, dirty, P)
            steps["traffic"] = lambda: impl.traffic(stats, K, P)
            row["host_steps_ms"] = {k: self.time_ms(fn, reps=10)
                                    for k, fn in steps.items()}
            row["host_side_ms"] = row["apply_ms"] - sum(
                kern["ms"] for kern in kernels.values())
            row["longest_segment"] = longest_segment(torch, r.s_slot, N)
            for kname, tier in (("fast_round", "fast"),
                                ("slow_round", "slow")):
                # a kernel whose branch is not taken reads the flag alone
                kernels[kname]["bytes"] = self.round_bytes(
                    N, K, r, tier, d, v) if tier == row["branch"] else 1
            kernels["round_prologue"]["bytes"] = self.prologue_bytes(K, P)
            live = r.s_slot[(r.s_slot >= 0) & (r.s_slot < N)]
            kernels["round_epilogue"]["bytes"] = self.epilogue_bytes(
                K, P, row["branch"], int(torch.unique(live).numel()))
            for kern in kernels.values():
                kern["bound_ms"] = kern["bytes"] / HBM_BYTES_PER_S * 1e3
            trace = (ROOT / "chiprun_out" / f"apply_trace_{strategy}_{name}"
                     ".json") if strategy == "cached_me" else None
            row["profile"] = self.device_busy(run, trace=trace)
            row["replay_profile"] = self.device_busy(replay)
            self.check_device_ops(strategy, name, row["profile"])
            out[name] = row
            del graph
        return state, out

    @staticmethod
    def check_device_ops(strategy, name, prof):
        """Fail unless the profiled eager `apply` ran at most
        DEVICE_OPS_LIMIT device operations, none of the old sort's, and no
        memset right before a round kernel."""
        where = f"{strategy}/{name}"
        if "device_ops" not in prof:
            raise SystemExit(f"{where}: device operations not measured "
                             f"({prof.get('error')})")
        count = prof["device_ops_per_apply"]
        if count is None:
            raise SystemExit(f"{where}: no call left all its device "
                             f"operations in the trace "
                             f"({prof['device_ops_by_call']})")
        if count > DEVICE_OPS_LIMIT[strategy]:
            raise SystemExit(f"{where}: {count} device operations per apply,"
                             f" more than {DEVICE_OPS_LIMIT[strategy]}")
        ops = prof["device_ops"]
        old = [nm for _, nm in ops if any(o in nm for o in OLD_SORT_OPS)]
        if old:
            raise SystemExit(f"{where}: the apply still runs {old[0]}")
        for (cat, _), (_, nm) in zip(ops, ops[1:]):
            if cat == "gpu_memset" and any(k in nm for k in
                                           ROUND_FIRST_KERNELS):
                raise SystemExit(f"{where}: a memset runs before {nm}")

    def slow_spectra(self):
        """`slow_round` alone on one cell, a long segment (60 % of the
        lanes on one cell), Zipf 0.99, and Zipf 0.99 at k = 20 (a thread
        per segment): device ms (each rep on a fresh copy of the table),
        bound and longest segment."""
        torch, er = self.torch, self.er
        out = {}
        for i, (spectrum, k) in enumerate((("all_same", K), ("long", K),
                                           ("zipf", K), ("zipf", 20))):
            rng = np.random.default_rng(7 + i)
            data = rng.integers(0, 2 ** 32, (N, k), dtype=np.uint32)
            ver = np.zeros(N, np.uint32)
            ops, ctx = self.spectrum_batch(rng, N, k, P, spectrum, data, ver)
            r = self.round_args(N, ops, ctx)
            d, v = self.words(data), self.words(ver)
            row = {"k": k,
                   "longest_segment": longest_segment(torch, r.s_slot, N),
                   "ms": self.device_ms(
                       lambda dd, vv: er.slow_round(dd, vv, *r.slow), reps=5,
                       setup=lambda: (d.clone(), v.clone())),
                   "bytes": self.round_bytes(N, k, r, "slow", d, v)}
            row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
            out[f"{spectrum}_k{k}"] = row
        return out

    def round_bytes(self, n, k, r, tier, data, version):
        """Bytes the round's kernel of `tier` must move on these inputs
        (its branch taken): every lane operand read once, every output
        written once, each distinct live row (and its version) read once,
        each written row written once."""
        torch, er = self.torch, self.er
        p = r.s_slot.shape[0]
        live = r.s_slot[r.s_slot < n]
        rows = int(torch.unique(live[live >= 0]).numel())
        d0, v0 = data.clone(), version.clone()
        if tier == "fast":
            er.fast_round(self.flag(True), d0, v0, r.ctx, r.ops,
                          self.round_out(p, k))
            # slot, kind, expected, desired, the link; value, success, the
            # new link, okw
            lane_in = p * (4 + 4 + 8 * k + (4 + 4 + 4 * k + 1))
            lane_out = p * (4 * k + 1 + (4 + 4 + 4 * k + 1) + 4)
        else:
            er.slow_round(d0, v0, *r.slow)
            lane_in = p * (4 + 4 + 4 + 8 * k)
            lane_out = p * (4 * k + 4 + 4)
        written = int(((d0 != data).any(1) | (v0 != version)).sum())
        return lane_in + lane_out + (rows + written) * (4 * k + 4)

    @staticmethod
    def prologue_bytes(k, p):
        """Bytes `round_prologue` must move: each lane's slot, kind, rows
        and link in; the sorted order and slots, and each lane's kind, link
        version and rows in the sorted order out (and the flag)."""
        lane_in = p * (4 + 4 + 8 * k + (4 + 4 + 1))
        lane_out = p * (4 + 4 + 4 + 4 + 8 * k)
        return lane_in + lane_out + 1

    @staticmethod
    def epilogue_bytes(k, p, branch, cells):
        """Bytes `round_epilogue` must move on `branch`: the sorted order,
        slots and kinds and each lane's success in; on the slow branch the
        replay's outputs, the links and the version of each of the `cells`
        in, the lanes' results and new links out; the stats and the dirty
        list out."""
        sorted_in = p * (4 + 4 + 4 + 4)
        link = p * (4 + 4 + 4 * k + 1)
        lanes = (p * (4 * k + 4) + link + 4 * cells) \
            + (p * (4 * k + 1) + link) if branch == "slow" else 0
        return sorted_in + lanes + 6 * 4 + p * 4


# ---------------------------------------------------------------------------
# Phase 3b: the raw-table kernel layer (kernels/ops.py, llsc_commit).
# ---------------------------------------------------------------------------

def np_hash(keys, m):
    """`ops.hash_keys` in numpy uint32 arithmetic (its oracle)."""
    h = np.zeros(keys.shape[0], np.uint32)
    for j in range(keys.shape[1]):
        h = (h ^ keys[:, j]) * np.uint32(0x9E3779B1)
        h = h ^ (h >> np.uint32(15))
    return (h % np.uint32(m)).astype(np.int32)


def longest_segment(torch, slot, n):
    """The most lanes on one cell among the lanes with a slot in [0, n)."""
    live = slot[(slot >= 0) & (slot < n)]
    return int(torch.unique(live, return_counts=True)[1].max()) \
        if live.numel() else 0


def clone(tensors):
    """A copy of a tuple (or named tuple) of tensors."""
    copies = [x.clone() for x in tensors]
    return (type(tensors)(*copies) if hasattr(tensors, "_fields")
            else tuple(copies))


def seg_rank(sorted_ids):
    """Each entry's rank among the equal ids before it (ids sorted)."""
    idx = np.arange(len(sorted_ids))
    start = np.r_[True, sorted_ids[1:] != sorted_ids[:-1]]
    return (idx - np.maximum.accumulate(np.where(start, idx, 0))).astype(
        np.int32)


def update_batch(rng, p, n, k, slots, current, update_frac=1.0, chain=0.0):
    """A STORE/CAS batch as the reference's `random_batch` (LOAD lanes where
    update_frac < 1), half the comparands current and a share `chain` of
    the lanes expecting the row the lane before on their cell wrote; sorted
    by slot, with each op's round (its rank on its cell).  slots: uniform,
    zipf (Zipf 0.99, as bench_atomics) or hot (one cell)."""
    if slots == "zipf":
        slot = (rng.zipf(1.01, p) - 1) % n
    elif slots == "hot":
        slot = np.full(p, rng.integers(0, n))
    else:
        slot = rng.integers(0, n, p)
    kind = np.where(rng.random(p) < 0.5, CAS, STORE).astype(np.int32)
    if update_frac < 1.0:
        kind[rng.random(p) >= update_frac] = 0
    desired = rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32)
    expected = rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32)
    use_cur = rng.random(p) < 0.5
    expected = np.where(use_cur[:, None], current[slot], expected)
    order = np.argsort(slot, kind="stable")
    s_slot = slot[order].astype(np.int32)
    kind, expected, desired = kind[order], expected[order], desired[order]
    if chain:
        follow = np.flatnonzero((rng.random(p - 1) < chain)
                                & (s_slot[1:] == s_slot[:-1])) + 1
        expected[follow] = desired[follow - 1]
    return (kind, s_slot, expected, desired), seg_rank(s_slot)


def rounds_loop(tk, data, meta, slot, kind, expected, desired, rounds,
                upd_rank):
    """`ops.bigatomic_update_rounds` as it was before `cas_apply_rounds`:
    the `cas_apply_round` kernel once per round, as the reference drives its
    Pallas kernel; timed here beside the one-launch kernel."""
    import torch
    n1 = data.shape[0]
    p, k = expected.shape
    success = torch.zeros((p,), dtype=torch.int32, device=data.device)
    witness = torch.zeros((p, k), dtype=data.dtype, device=data.device)
    for t in range(rounds):
        live = upd_rank == t
        data, meta, succ, wit = tk.cas_apply_round(
            data, meta, torch.where(live, slot, n1 - 1),
            torch.where(live, kind, 0), expected, desired)
        success = torch.where(live, succ[:, 0], success)
        witness = torch.where(live[:, None], wit, witness)
    return data, meta, success, witness


def build_cachehash(rng, m, n_keys):
    """A CacheHash table of `n_keys` distinct 2-word keys placed by the
    hash: a bucket's first key inline in `cells`, the rest chained in
    `chain_pool` (at most MAX_CHAIN deep; deeper keys are left out).
    Returns (cells, chain_pool, placed keys as uint64, their values, their
    chain depth (0 = inline), every key drawn as uint64)."""
    cw = KW + VW + 3                     # [key | value | next | flags | ver]
    drawn = np.unique(rng.integers(1, 2 ** 64, int(n_keys * 1.01),
                                   dtype=np.uint64))
    drawn = drawn[rng.permutation(len(drawn))[:n_keys]]
    keys = drawn.view(np.uint32).reshape(-1, KW)
    vals = rng.integers(0, 2 ** 32, (len(keys), VW), dtype=np.uint32)
    bucket = np_hash(keys, m)
    order = np.argsort(bucket, kind="stable")
    k64, vals, bucket = drawn[order], vals[order], bucket[order]
    depth = seg_rank(bucket)
    keep = depth <= MAX_CHAIN
    k64, vals, bucket, depth = k64[keep], vals[keep], bucket[keep], \
        depth[keep]
    rows = np.zeros((len(k64), cw), np.uint32)
    rows[:, :KW] = k64.view(np.uint32).reshape(-1, KW)
    rows[:, KW:KW + VW] = vals
    rows[:, KW + VW + 1] = FULL
    chained = depth > 0
    node = np.cumsum(chained) - 1                     # chain-pool index
    has_next = np.r_[bucket[1:] == bucket[:-1], False]
    rows[:, KW + VW] = np.where(has_next, np.r_[node[1:], 0], NEXT_END)
    cells = np.zeros((m, cw), np.uint32)
    cells[bucket[~chained]] = rows[~chained]
    return cells, rows[chained], k64, vals, depth, drawn


class TableOps:
    """Phase 3b: the raw-table layer's kernels against their plain
    versions, its entry points at full width against numpy oracles, and
    their times."""

    def __init__(self, smoke, tk, ops, llsc, ref):
        self.s, self.torch, self.dev = smoke, smoke.torch, smoke.dev
        self.tk, self.ops, self.llsc, self.ref = tk, ops, llsc, ref
        self.w = smoke.words

    def ints(self, arr):
        return self.s.convert.tensor(np.asarray(arr, np.int32), self.dev)

    def fail(self, what):
        raise SystemExit(f"table ops: {what}")

    def same(self, what, got, want):
        """Exact equality of a port result (words as uint32) and numpy."""
        if isinstance(got, self.torch.Tensor):
            word = got.dtype == self.torch.int32 and want.dtype == np.uint32
            got = self.s.convert.array(got, word=word)
        if got.shape != want.shape or not np.array_equal(got, want):
            self.fail(f"{what} differs from the numpy oracle")

    # -- inputs ----------------------------------------------------------------

    @staticmethod
    def table(rng, n1, k, locked=0.05, marked=0.05):
        """data[n1, k] and meta[n1, 2]: even versions, a share odd (locked),
        a share of rows marked, and row 0's version about to wrap."""
        data = rng.integers(0, 2 ** 32, (n1, k), dtype=np.uint32)
        meta = np.zeros((n1, 2), np.uint32)
        meta[:, 0] = (rng.integers(0, 2 ** 30, n1) * 2
                      + (rng.random(n1) < locked)).astype(np.uint32)
        meta[:, 1] = rng.random(n1) < marked
        meta[0, 0] = 2 ** 32 - 2
        return data, meta

    @staticmethod
    def lanes(rng, n, p, live_frac=0.9):
        """Distinct real slots for a share of p lanes, the dummy row n for
        the rest, interleaved."""
        n_real = min(int(p * live_frac), n)
        slot = np.full(p, n, np.int32)
        slot[:n_real] = rng.choice(n, n_real, replace=False)
        perm = rng.permutation(p)
        return slot[perm], (np.arange(p) < n_real)[perm]

    def cas_lanes(self, rng, data, n, k, p):
        slot, real = self.lanes(rng, n, p)
        kind = np.where(real, rng.choice([STORE, CAS], p), 0).astype(np.int32)
        kind[real & (rng.random(p) < 0.1)] = 0       # read-and-fail lanes
        expected = rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32)
        take = rng.random(p) < 0.5
        expected[take] = data[slot[take]]
        return (slot, kind, expected,
                rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32))

    def llsc_lanes(self, rng, meta, n, k, p):
        slot, real = self.lanes(rng, n, p)
        cur = meta[slot, 0]
        link = np.where(rng.random(p) < 0.5, cur, cur + np.uint32(2))
        return (slot, real.astype(np.int32), link.astype(np.uint32),
                rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32))

    @staticmethod
    def probe_inputs(rng, m, kw, vw, q):
        cw = kw + vw + 3
        cells = rng.integers(0, 2 ** 32, (m, cw), dtype=np.uint32)
        cells[:, kw + vw] = np.where(rng.random(m) < 0.5, NEXT_END,
                                     rng.integers(0, 64, m))
        cells[:, kw + vw + 1] = np.where(rng.random(m) < 0.6, FULL,
                                         rng.choice([0, 2], m))
        bidx = rng.integers(0, m, q).astype(np.int32)
        keys = rng.integers(0, 2 ** 32, (q, kw), dtype=np.uint32)
        take = rng.random(q) < 0.5
        keys[take] = cells[bidx[take], :kw]
        return cells, bidx, keys

    # -- kernels against their plain versions -----------------------------------

    def kernel_vs_plain(self):
        """Bit for bit on every output and on the updated tables: k = 1, 3,
        4, 5, 16 at q = p = 1003 (not a multiple of 8), locked / marked /
        wrapping rows, dead lanes on row n and out of range, three CacheHash
        layouts, and the full-width shapes.  Returns the case count."""
        tk, ref, w, ints = self.tk, self.ref, self.w, self.ints
        rng = np.random.default_rng(2000)
        cases = 0
        for n, k, p in [(4096, k, 1003) for k in (1, 3, 4, 5, 16)] + \
                [(N, K, P)]:
            data, meta = self.table(rng, n + 1, k)
            d, m = w(data), w(meta)
            idx = rng.integers(0, n, p).astype(np.int32)
            idx[:2] = [-1, n + 1]                     # dead lanes
            self.s.compare("seqlock_gather", tk.seqlock_gather(d, m, ints(idx)),
                           ref.seqlock_gather_ref(d, m, ints(idx)))
            for name, lanes, kern, plain in (
                    ("cas_apply_round", self.cas_lanes(rng, data, n, k, p),
                     tk.cas_apply_round, ref.cas_apply_round_ref),
                    ("llsc_commit_round", self.llsc_lanes(rng, meta, n, k, p),
                     tk.llsc_commit_round, ref.llsc_commit_round_ref)):
                args = (ints(lanes[0]), ints(lanes[1]), w(lanes[2]),
                        w(lanes[3]))
                got = kern(d.clone(), m.clone(), *args)
                want = plain(d.clone(), m.clone(), *args)
                self.s.compare(name, got, want)
            cases += 3
        for m_, kw, vw, q in [(4096, 1, 1, 1003), (4096, 2, 2, 1003),
                              (4096, 4, 2, 1003), (M, KW, VW, P)]:
            cells, bidx, keys = self.probe_inputs(rng, m_, kw, vw, q)
            args = (w(cells), ints(bidx), w(keys))
            self.s.compare("cachehash_probe",
                           tk.cachehash_probe(*args, kw=kw, vw=vw),
                           ref.cachehash_probe_ref(*args, kw=kw, vw=vw))
            cases += 1
        self.torch.cuda.synchronize()
        return cases

    # (n, k, p, slots, update_frac, chain, share of the rounds run,
    #  negative ranks)
    ROUNDS_CASES = [(4096, k, 1003, "zipf", 0.8, 0.3, 1.0, False)
                    for k in (1, 3, 4, 5, 16)] + [
        (4096, 3, 1003, "hot", 0.9, 0.3, 0.6, False),
        (4096, 5, 1003, "zipf", 1.0, 0.3, 1.0, True),
        (N, K, P, "uniform", 1.0, 0.0, 1.0, False),
        (N, K, P, "zipf", 1.0, 0.0, 1.0, False),
        (N, K, P, "hot", 1.0, 0.3, 1.0, False),
        (N, K, P, "zipf", 0.8, 0.3, 1.0, False),
        (N, K, P, "zipf", 1.0, 0.3, 0.7, False)]

    def rounds_vs_plain(self):
        """`cas_apply_rounds` against its plain version (the round loop),
        bit for bit on success, witness, table and meta: k = 1, 3, 4, 5, 16
        at p = 1003 (Zipf, LOAD lanes, CAS lanes expecting an earlier
        lane's row), truncated rounds, negative ranks, and at full width
        uniform, Zipf 0.99, one hot cell, LOAD lanes and truncated rounds.
        Returns each case's (name, longest segment, rounds)."""
        tk, ref, w, ints = self.tk, self.ref, self.w, self.ints
        rng = np.random.default_rng(2500)
        out = []
        for n, k, p, slots, frac, chain, share, neg in self.ROUNDS_CASES:
            data, meta = self.table(rng, n + 1, k)
            batch, rank = update_batch(rng, p, n, k, slots, data[:n], frac,
                                       chain)
            longest = int(rank.max()) + 1
            rounds = max(1, int(longest * share))
            if neg:
                rank[rng.random(p) < 0.2] = -1
            kind, slot, expected, desired = batch
            args = (ints(slot), ints(kind), w(expected), w(desired), rounds,
                    ints(rank))
            d, m = w(data), w(meta)
            got = tk.cas_apply_rounds(d.clone(), m.clone(), *args)
            want = ref.cas_apply_rounds_ref(d.clone(), m.clone(), *args)
            self.s.compare("cas_apply_rounds", got, want)
            out.append((f"n={n} k={k} {slots} u={frac} chain={chain}"
                         + (" neg" if neg else ""), longest, rounds))
        self.torch.cuda.synchronize()
        return out

    # -- the path through the ops layer ------------------------------------------

    def main_path(self, atomics, engine, convert):
        """Drive the layer's entry points once at full width, with the
        launch counts reset just before; check each against numpy.
        Returns the launch counts, the branch the engine round took under
        `commit_round`, and the operands for the timing: each call's
        inputs, with a copy (`pre_*`) of each table or state as it was
        before the call that updated it."""
        torch, tk, ops, llsc, w, ints = (self.torch, self.tk, self.ops,
                                         self.llsc, self.w, self.ints)
        rng = np.random.default_rng(3000)
        n, k, p = N, K, P
        data, meta = self.table(rng, n + 1, k)
        d, m = convert.raw_table(data, meta, self.dev)
        op = {}
        torch.cuda.synchronize()
        tk.reset_launch_counts()

        # bigatomic_load: uniform slots over locked and marked rows
        idx = rng.integers(0, n, p).astype(np.int32)
        op["idx"] = ints(idx)
        vals, ok = ops.bigatomic_load(d, m, op["idx"])
        self.same("bigatomic_load values", vals, data[idx])
        self.same("bigatomic_load ok", ok, (meta[idx, 0] % 2 == 0)
                  & (meta[idx, 1] == 0))

        # bigatomic_update_rounds: uniform, Zipf 0.99 and one hot cell; one
        # cas_apply_rounds launch per call, whatever the rounds
        ctx0 = (np.full(p, -1, np.int32), np.zeros(p, np.uint32),
                np.zeros((p, k), np.uint32), np.zeros(p, bool))
        op["rounds"] = {}
        for name in ("uniform", "zipf099", "hot"):
            slots = "zipf" if name == "zipf099" else name
            batch, rank = update_batch(rng, p, n, k, slots, data[:n])
            rounds = int(rank.max()) + 1
            kind, slot, expected, desired = batch
            args = (ints(slot), ints(kind), w(expected), w(desired), rounds,
                    ints(rank))
            op["pre_update_" + name] = (d.clone(), m.clone())
            before = tk.cas_apply_rounds.launches
            _, _, succ, wit = ops.bigatomic_update_rounds(d, m, *args)
            if tk.cas_apply_rounds.launches - before != 1:
                self.fail(f"update rounds ({name}): "
                          f"{tk.cas_apply_rounds.launches - before} "
                          "cas_apply_rounds launches, expected 1")
            new_data, new_ver, _, res = engine.apply_ops_reference(
                data[:n], meta[:n, 0], ctx0, batch)
            data[:n], meta[:n, 0] = new_data, new_ver
            self.same(f"update rounds ({name}) success", succ,
                      res.success.astype(np.int32))
            self.same(f"update rounds ({name}) witness", wit, res.value)
            self.same(f"update rounds ({name}) table", d, data)
            self.same(f"update rounds ({name}) meta", m, meta)
            op["update_" + name] = args
            op["rounds"][name] = rounds       # = the longest segment
            if name == "uniform":                  # round 0, for the kernel
                live = rank == 0
                op["cas_round0"] = (
                    ints(np.where(live, slot, n)),
                    ints(np.where(live, kind, 0)), w(expected), w(desired))

        # llsc_commit_round: distinct live slots, half the links stale
        slot, live, link, desired = self.llsc_lanes(rng, meta, n, k, p)
        op["llsc"] = (ints(slot), ints(live), w(link), w(desired))
        op["pre_llsc"] = (d.clone(), m.clone())
        _, _, succ, wit = tk.llsc_commit_round(d, m, *op["llsc"])
        win = live.astype(bool) & (meta[slot, 0] == link)
        self.same("llsc_commit_round witness", wit, data[slot])
        data[slot[win]] = desired[win]
        meta[slot[win], 0] += np.uint32(2)
        self.same("llsc_commit_round success", succ,
                  win.astype(np.int32)[:, None])
        self.same("llsc_commit_round table", d, data)
        self.same("llsc_commit_round meta", m, meta)
        if not 0.3 < win.mean() < 0.6:
            self.fail(f"llsc_commit_round: {win.mean():.2f} of lanes won")

        # commit_round on cached_me: LL, a STORE to some linked cells, SC
        spec = atomics.AtomicSpec(n, k, "cached_me", p_max=p)
        initial = rng.integers(0, 2 ** 32, (n, k), dtype=np.uint32)
        state = atomics.init(spec, initial, device=self.dev)
        ctx = atomics.init_ctx(p, k, device=self.dev)
        cells_ll = rng.choice(n, p, replace=False).astype(np.int32)
        zeros = np.zeros((p, k), np.uint32)
        batches = [
            (np.full(p, engine.LL, np.int32), cells_ll, zeros, zeros),
            (np.where(rng.random(p) < 0.25, STORE, engine.IDLE).astype(
                np.int32), cells_ll, zeros,
             rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32))]
        for batch in batches:
            state, ctx, *_ = atomics.apply(
                spec, state, convert.op_batch(batch, self.dev), ctx,
                donate=True)
        sc_slots = np.where(rng.random(p) < 0.9, cells_ll, n).astype(np.int32)
        sc_des = rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32)
        op["commit"] = (spec, ints(sc_slots), w(sc_des))
        op["pre_commit"] = (clone(state), clone(ctx))
        state, ctx, succ, wit = llsc.commit_round(
            spec, state, ctx, *op["commit"][1:], donate=True)
        # the branch the engine round took: its predicate on the batch
        fast_in_commit = self.s.branch(engine.OpBatch(
            torch.where(op["commit"][1] < n, engine.SC, engine.IDLE).to(
                torch.int32), op["commit"][1], op["commit"][2],
            op["commit"][2]))
        o_data, o_ver, o_ctx = initial, np.zeros(n, np.uint32), ctx0
        batches.append((np.where(sc_slots < n, engine.SC, engine.IDLE).astype(
            np.int32), sc_slots, zeros, sc_des))
        for batch in batches:
            o_data, o_ver, o_ctx, o_res = engine.apply_ops_reference(
                o_data, o_ver, o_ctx, batch)
        self.same("commit_round success", succ, o_res.success)
        self.same("commit_round witness", wit, o_res.value)
        self.same("commit_round logical", atomics.logical(spec, state),
                  o_data)
        self.same("commit_round versions", state.version, o_ver)
        for f, got, want in zip(engine.LinkCtx._fields, ctx, o_ctx):
            self.same(f"commit_round ctx.{f}", got, np.asarray(want))
        op["commit_wins"] = float(o_res.success.mean())

        # cachehash_find: 2**21 keys in 2**22 buckets; a third of the
        # queries inline hits, a third chain hits, a third absent
        t0 = time.perf_counter()
        cells, pool, k64, vals, depth, drawn = build_cachehash(rng, M, M // 2)
        third = p // 3
        absent = rng.integers(1, 2 ** 64, 2 * third, dtype=np.uint64)
        absent = absent[~np.isin(absent, drawn)][:p - 2 * third]
        q64 = np.concatenate([rng.choice(k64[depth == 0], third),
                              rng.choice(k64[depth > 0], third), absent])
        q64 = q64[rng.permutation(p)]
        qk = q64.view(np.uint32).reshape(-1, KW)
        op["build_cachehash_s"] = time.perf_counter() - t0
        op["max_depth"] = int(depth.max())
        cells_t, pool_t = convert.cachehash_tables(cells, pool, self.dev)
        op["find"] = (cells_t, pool_t, w(qk))
        bidx = np_hash(qk, M)
        self.same("hash_keys", ops.hash_keys(op["find"][2], M), bidx)
        found, val = ops.cachehash_find(*op["find"], kw=KW, vw=VW,
                                        max_chain=MAX_CHAIN)
        sorted_k = np.argsort(k64)
        pos = np.minimum(np.searchsorted(k64[sorted_k], q64), len(k64) - 1)
        hit = k64[sorted_k][pos] == q64
        want = np.where(hit[:, None], vals[sorted_k][pos],
                        cells[bidx, KW:KW + VW])
        self.same("cachehash_find found", found, hit)
        self.same("cachehash_find value", val, want)
        op["probe"] = (cells_t, ints(bidx), op["find"][2])
        op["find_mix"] = [int(hit.sum()), int((~hit).sum())]

        torch.cuda.synchronize()
        counts = tk.launch_counts()
        for name in TABLE_PATH_KERNELS:
            if counts[name] <= 0:
                self.fail(f"{name} never launched on the table-ops path")
        if counts["cas_apply_round"] != 0:
            self.fail("bigatomic_update_rounds launched cas_apply_round")
        if fast_in_commit != "fast":
            self.fail("commit_round did not take the fast branch")
        return counts, fast_in_commit, op

    # -- timing ------------------------------------------------------------------

    def timing(self, op):
        """Median ms of each entry point (CUDA events, launch included) and
        its device-busy share; each kernel's device time, its plain
        version's time and its bound in bytes.  Every call that updates its
        table, and every kernel rep, runs on a fresh copy of the table (or
        state and links) that the checked call saw, so each rep does the
        checked call's work."""
        torch, tk, ops, llsc, ref = (self.torch, self.tk, self.ops, self.llsc,
                                     self.ref)
        s = self.s

        def fresh(key):
            return lambda: clone(op[key])

        d0, m0 = op["pre_update_uniform"]         # the table the load read
        spec, sc_slots, sc_des = op["commit"]
        entry = {
            "bigatomic_load": (
                lambda: ops.bigatomic_load(d0, m0, op["idx"]), None),
            "bigatomic_update_rounds_uniform": (
                lambda d, m: ops.bigatomic_update_rounds(
                    d, m, *op["update_uniform"]),
                fresh("pre_update_uniform")),
            "bigatomic_update_rounds_zipf099": (
                lambda d, m: ops.bigatomic_update_rounds(
                    d, m, *op["update_zipf099"]),
                fresh("pre_update_zipf099")),
            "bigatomic_update_rounds_hot": (
                lambda d, m: ops.bigatomic_update_rounds(
                    d, m, *op["update_hot"]),
                fresh("pre_update_hot")),
            "llsc_commit_round": (
                lambda d, m: tk.llsc_commit_round(d, m, *op["llsc"]),
                fresh("pre_llsc")),
            "commit_round": (
                lambda state, ctx: llsc.commit_round(
                    spec, state, ctx, sc_slots, sc_des, donate=True),
                lambda: tuple(map(clone, op["pre_commit"]))),
            "cachehash_find": (
                lambda: ops.cachehash_find(*op["find"], kw=KW, vw=VW,
                                           max_chain=MAX_CHAIN), None),
        }
        entries = {}
        for name, (fn, setup) in entry.items():
            def run(*args, fn=fn):
                fn(*args)
                torch.cuda.synchronize()
            entries[name] = {"ms": s.time_ms(fn, setup=setup),
                             "profile": s.device_busy(run, setup=setup)}
        # `bigatomic_update_rounds` as it was (a launch per round), for the
        # comparison in this run; the hot cell's 16384 rounds once
        for name, reps in (("uniform", 20), ("zipf099", 5), ("hot", 1)):
            entries["rounds_loop_" + name] = {"ms": s.time_ms(
                lambda d, m, a=op["update_" + name]: rounds_loop(
                    tk, d, m, *a), reps=reps, warmup=1,
                setup=fresh("pre_update_" + name))}
        # every kernel rep, read-only ones too, gets its own copy of the
        # table: rows left in L2 by the rep before would halve its time
        kernels = {
            "seqlock_gather": (
                lambda d, m: tk.seqlock_gather(d, m, op["idx"]),
                lambda d, m: ref.seqlock_gather_ref(d, m, op["idx"]),
                fresh("pre_update_uniform"), 5),
            "cas_apply_round": (
                lambda d, m: tk.cas_apply_round(d, m, *op["cas_round0"]),
                lambda d, m: ref.cas_apply_round_ref(d, m, *op["cas_round0"]),
                fresh("pre_update_uniform"), 5),
            "llsc_commit_round": (
                lambda d, m: tk.llsc_commit_round(d, m, *op["llsc"]),
                lambda d, m: ref.llsc_commit_round_ref(d, m, *op["llsc"]),
                fresh("pre_llsc"), 5),
            "cachehash_probe": (
                lambda cells: tk.cachehash_probe(cells, *op["probe"][1:],
                                                 kw=KW, vw=VW),
                lambda cells: ref.cachehash_probe_ref(cells, *op["probe"][1:],
                                                      kw=KW, vw=VW),
                lambda: (op["probe"][0].clone(),), 5),
        }
        for key, name, reps in (("zipf099", "cas_apply_rounds", 5),
                                ("uniform", "cas_apply_rounds_uniform", 5),
                                ("hot", "cas_apply_rounds_hot", 1)):
            kernels[name] = (
                lambda d, m, a=op["update_" + key]: tk.cas_apply_rounds(
                    d, m, *a),
                lambda d, m, a=op["update_" + key]: ref.cas_apply_rounds_ref(
                    d, m, *a),
                fresh("pre_update_" + key), reps)
        rows = {}
        for name, (fn, plain, setup, reps) in kernels.items():
            nbytes, written = self.kernel_bytes(name, op)
            rows[name] = {
                "ms": s.device_ms(fn, setup=setup),
                "with_launch_ms": s.time_ms(fn, setup=setup),
                "plain_ms": s.time_ms(plain, reps=reps, warmup=1, setup=setup),
                "bytes": nbytes, "written_rows": written,
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        idx64 = op["idx"].to(torch.int64)
        rows["seqlock_gather"]["index_select_ms"] = s.device_ms(
            lambda d, m: d.index_select(0, idx64),
            setup=fresh("pre_update_uniform"))
        return entries, rows

    def kernel_bytes(self, name, op):
        """Bytes the kernel must move on the timed inputs, and the rows it
        writes: each lane operand read once and each output written once;
        each distinct row it reads (data words, and the meta words it
        reads) once; each row it writes (data and version) once."""
        torch, tk = self.torch, self.tk
        k = op["pre_llsc"][0].shape[1]

        def distinct(idx):
            return int(torch.unique(idx).numel())

        if name == "seqlock_gather":
            q = op["idx"].shape[0]
            return (q * 4 + distinct(op["idx"]) * (4 * k + 8)
                    + q * (4 * k + 4)), 0
        if name == "cachehash_probe":
            cells, bidx, _ = op["probe"]
            q = bidx.shape[0]
            return (q * (4 + 4 * KW) + q * (12 + 4 * VW)
                    + distinct(bidx) * 4 * (KW + VW + 2)), 0
        if name.startswith("cas_apply_rounds"):
            key = {"cas_apply_rounds": "zipf099"}.get(
                name, name.rsplit("_", 1)[-1])
            args, table = op["update_" + key], op["pre_update_" + key]
            slot, rounds, rank = args[0], args[4], args[5]
            p = slot.shape[0]
            d, m = clone(table)
            tk.cas_apply_rounds(d, m, *args)
            written = int(((d != table[0]).any(1) | (m != table[1]).any(1))
                          .sum())
            live = (rank >= 0) & (rank < rounds)
            # slot, kind, rank, expected, desired; success, witness; each
            # row a live lane reads (data and version) once; each row written
            return (p * (12 + 8 * k) + p * (4 + 4 * k)
                    + distinct(slot[live]) * (4 * k + 4)
                    + written * (4 * k + 4)), written
        if name == "cas_apply_round":
            args, table = op["cas_round0"], op["pre_update_uniform"]
        else:
            args, table = op["llsc"], op["pre_llsc"]
        p = args[0].shape[0]
        succ = getattr(tk, name)(*clone(table), *args)[2]
        written = int(succ.sum())
        if name == "cas_apply_round":   # slot, kind, expected, desired
            return (p * (8 + 8 * k) + p * (4 + 4 * k)
                    + distinct(args[0]) * 4 * k
                    + written * (4 * k + 8)), written
        return (p * (12 + 4 * k) + p * (4 + 4 * k)   # slot, live, link, des.
                + distinct(args[0]) * (4 * k + 4)
                + written * (4 * k + 4)), written


# ---------------------------------------------------------------------------
# Phase 5: the integrity-scrub path (guard, runtime.LocalTarget).
# ---------------------------------------------------------------------------

def np_digest(logical, versions):
    """The FNV-1a cell digest in numpy uint32 arithmetic (its oracle)."""
    h = np.full(versions.shape, 2166136261, np.uint32)
    with np.errstate(over="ignore"):
        for j in range(logical.shape[1]):
            h = (h ^ logical[:, j]) * np.uint32(16777619)
        return (h ^ versions) * np.uint32(16777619)


class GuardPhase:
    """Phase 5: the digest kernel against its plain version and numpy, then
    per layout the scrub path at n = 2**22 (checkpoint, a STORE batch,
    baseline, 64 seeded faults, `Scrubber.scrub`, `mask_ops`, a second
    scrub), each step checked; then its times."""

    def __init__(self, smoke, guard, inject, runtime, digest):
        self.s, self.torch, self.dev = smoke, smoke.torch, smoke.dev
        self.guard, self.inject = guard, inject
        self.runtime, self.digest = runtime, digest

    def fail(self, what):
        raise SystemExit(f"guard: {what}")

    def kernel_vs_plain(self):
        """Bit for bit at k = 1, 3, 4, 5, 16 with n = 1003, and at full
        width against `np_digest` too.  Returns the case count."""
        rng = np.random.default_rng(5000)
        w, dg = self.s.words, self.digest
        cases = 0
        for n, k in [(1003, k) for k in (1, 3, 4, 5, 16)] + [(N, K)]:
            vals = rng.integers(0, 2 ** 32, (n, k), dtype=np.uint32)
            ver = rng.integers(0, 2 ** 32, n, dtype=np.uint32)
            got = dg.digest_rows(w(vals), w(ver))
            self.s.compare("digest_rows", (got,),
                           (dg.digest_rows_plain(w(vals), w(ver)),))
            if n == N and not np.array_equal(self.s.np_words(got),
                                              np_digest(vals, ver)):
                self.fail("digest_rows differs from the numpy oracle")
            cases += 1
        self.torch.cuda.synchronize()
        return cases

    def layout(self, strategy, seed):
        """Drive the scrub path for one layout and check it.  Returns the
        operands of the timing: the spec, the checkpoint, the STORE batch
        and its success, the faulted state and the baseline."""
        s, torch, dev = self.s, self.torch, self.dev
        atomics, convert = s.atomics, s.convert
        Fault = self.runtime.Fault
        spec = atomics.AtomicSpec(N, K, strategy, p_max=P)
        rng = np.random.default_rng(seed)
        initial = rng.integers(0, 2 ** 32, (N, K), dtype=np.uint32)
        target = self.runtime.LocalTarget(spec, initial, device=dev)
        ctx = atomics.init_ctx(P, K, device=dev)
        batch_a = s.main_batch("a_distinct_all_kinds", rng, initial, None)
        target.issue(convert.op_batch(batch_a, dev), ctx)
        scrubber = self.guard.Scrubber(spec, device=dev)
        ckpt = target.snapshot()
        scrubber.set_checkpoint(ckpt)
        ckpt_np = {f: s.np_words(x) for f, x in ckpt.items()}

        # a STORE batch to distinct cells
        dirty = rng.choice(N, GUARD_STORES, replace=False).astype(np.int32)
        stores = atomics.stores(dirty, rng.integers(
            0, 2 ** 32, (GUARD_STORES, K), dtype=np.uint32), k=K, device=dev)
        store_success = target.issue(stores, None).result.success
        scrubber.note_results(stores, store_success)
        baseline = scrubber.digest_of(target)
        snap = target.snapshot()
        if not np.array_equal(s.np_words(baseline), np_digest(
                s.np_words(snap["logical"]), s.np_words(snap["versions"]))):
            self.fail(f"{strategy}: baseline digest differs from numpy")

        # faults on distinct cells, half of them dirty
        half = GUARD_FAULTS // 2
        clean = np.setdiff1d(np.arange(N), dirty)
        victims = np.concatenate([rng.choice(dirty, half, replace=False),
                                  rng.choice(clean, half, replace=False)])
        named = {"indirect": ("pointer_range", dict(field="bptr", bit=30)),
                 "cached_wf": ("pointer_range", dict(field="bptr", bit=30)),
                 "cached_me": ("tagged_null", dict(field="version", bit=1))}
        for i, slot in enumerate(victims):
            kind = "bit_flip" if i % 2 == 0 else "torn_write"
            extra = named[strategy][1] if i == 0 and strategy in named \
                else {}
            target.state, _ = self.inject.inject_table_fault(
                spec, target.state, Fault(1, kind, slot=int(slot), **extra),
                np.random.default_rng([seed, i]))
        faulted = clone(target.state)

        report = scrubber.scrub(target, round_idx=1, baseline=baseline)
        dirty_v, clean_v = sorted(victims[:half].tolist()), \
            sorted(victims[half:].tolist())
        if report.detected != sorted(victims.tolist()):
            self.fail(f"{strategy}: detected {len(report.detected)} cells, "
                      f"not exactly the {GUARD_FAULTS} injected")
        if report.repaired != clean_v or report.quarantined != dirty_v:
            self.fail(f"{strategy}: repaired/quarantined are not the clean/"
                      "dirty victims")
        if strategy in named:
            name = named[strategy][0]
            if int(victims[0]) not in report.invariant_violations.get(name,
                                                                      []):
                self.fail(f"{strategy}: {name} does not name the fault")
        snap = target.snapshot()
        logical, versions = (s.np_words(snap["logical"]),
                             s.np_words(snap["versions"]))
        if not (np.array_equal(logical[clean_v], ckpt_np["logical"][clean_v])
                and np.array_equal(versions[clean_v],
                                   ckpt_np["versions"][clean_v])):
            self.fail(f"{strategy}: repaired cells differ from the "
                      "checkpoint")

        # a batch through mask_ops, half its updates aimed at the
        # quarantined cells, against the numpy oracle
        slot = np.concatenate([dirty_v, rng.choice(N, P - half)])
        slot = slot[rng.permutation(P)].astype(np.int32)
        ops = s.update_mix(rng, slot, P, K, logical)
        masked, bad = scrubber.mask_ops(convert.op_batch(ops, dev))
        want_bad = np.isin(slot, dirty_v) & (ops[0] != 3)
        if bad is None or not np.array_equal(bad.cpu().numpy(), want_bad):
            self.fail(f"{strategy}: mask_ops masked the wrong lanes")
        h = target.issue(masked, None)
        masked_np = (np.where(want_bad, 3, ops[0]).astype(np.int32),
                     *ops[1:])
        ctx0 = (np.full(P, -1, np.int32), np.zeros(P, np.uint32),
                np.zeros((P, K), np.uint32), np.zeros(P, bool))
        o_data, o_ver, _, o_res = s.engine.apply_ops_reference(
            logical, versions, ctx0, masked_np)
        success = h.result.success.cpu().numpy()
        if success[want_bad].any():
            self.fail(f"{strategy}: a poisoned lane reported success")
        if not (np.array_equal(success, o_res.success) and np.array_equal(
                s.np_words(h.result.value), o_res.value)):
            self.fail(f"{strategy}: mask_ops batch differs from the oracle")
        snap = target.snapshot()
        if not (np.array_equal(s.np_words(snap["logical"]), o_data)
                and np.array_equal(s.np_words(snap["versions"]), o_ver)):
            self.fail(f"{strategy}: table after the batch differs from the "
                      "oracle")
        scrubber.note_results(masked, h.result.success)
        second = scrubber.scrub(target, round_idx=2,
                                baseline=scrubber.digest_of(target))
        if not second.clean or second.poisoned_total != half:
            self.fail(f"{strategy}: the second scrub found "
                      f"{len(second.detected)} new cells")
        torch.cuda.synchronize()
        return {"spec": spec, "ckpt": ckpt, "stores": (stores,
                store_success), "faulted": faulted, "baseline": baseline,
                "report": report.to_json(), "second": second.to_json()}

    def timing(self, op):
        """Median ms (CUDA events) of `cell_digest`, the digest kernel
        alone (device time), its plain version, `check_invariants` and
        `Scrubber.scrub` on a clean table and with the 64 faults, each rep
        on a fresh copy of the state and scrubber the checked run saw."""
        s, torch = self.s, self.torch
        spec, faulted, baseline = op["spec"], op["faulted"], op["baseline"]
        impl = s.atomics.get_strategy(spec.strategy)
        dg, guard = self.digest, self.guard
        vals = impl.logical(faulted).contiguous()
        ver = faulted.version

        def fresh_vals():
            return vals.clone(), ver.clone()

        def fresh_scrub(state):
            def setup():
                target = self.runtime.LocalTarget(spec, device=self.dev)
                target.state = clone(state)
                sc = guard.Scrubber(spec, device=self.dev)
                sc.set_checkpoint(op["ckpt"])
                sc.note_results(*op["stores"])
                return sc, target
            return setup

        def scrub(sc, target):
            sc.scrub(target, round_idx=1, baseline=baseline)

        row = {
            "cell_digest_ms": s.time_ms(lambda: guard.cell_digest(spec,
                                                                  faulted)),
            "digest_kernel_ms": s.device_ms(dg.digest_rows,
                                            setup=fresh_vals),
            "digest_plain_ms": s.time_ms(dg.digest_rows_plain, reps=5,
                                         warmup=1, setup=fresh_vals),
            "check_invariants_ms": s.time_ms(
                lambda: guard.check_invariants(spec, faulted)),
            "scrub_faulted_ms": s.time_ms(scrub, reps=10, warmup=2,
                                          setup=fresh_scrub(faulted)),
        }
        # the clean table: the scrub of the repaired, reloaded state
        sc, target = fresh_scrub(faulted)()
        scrub(sc, target)
        clean_state = clone(target.state)
        clean_base = guard.cell_digest(spec, clean_state)

        def clean_scrub(sc, target):
            sc.scrub(target, round_idx=2, baseline=clean_base)
        row["scrub_clean_ms"] = s.time_ms(clean_scrub, reps=10, warmup=2,
                                          setup=fresh_scrub(clean_state))

        def run(sc, target):
            scrub(sc, target)
            torch.cuda.synchronize()
        row["scrub_faulted_profile"] = s.device_busy(
            run, setup=fresh_scrub(faulted))
        nbytes = vals.numel() * 4 + ver.numel() * 4 + ver.numel() * 4
        row["digest_bytes"] = nbytes
        row["digest_bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
        return row

    def row_gather(self, layout):
        """Device ms of the whole-table row gather that indirect's
        `logical` and the node-pool invariants run: PyTorch's `table[idx]`
        against `layout.gather_rows`, for N rows of K words, with an
        identity and a random permutation index; the two must agree."""
        s, torch = self.s, self.torch
        gen = torch.Generator(device=self.dev).manual_seed(7100)
        table = torch.randint(-2 ** 31, 2 ** 31 - 1, (N, K), generator=gen,
                              device=self.dev, dtype=torch.int32)
        out = {}
        for name, idx in (("identity", torch.arange(N, device=self.dev)),
                          ("permutation", torch.randperm(
                              N, generator=gen, device=self.dev))):
            if not torch.equal(layout.gather_rows(table, idx), table[idx]):
                self.fail(f"gather_rows differs from table[idx] ({name})")
            out[name] = {
                "index_ms": s.device_ms(lambda: table[idx]),
                "gather_rows_ms": s.device_ms(
                    lambda: layout.gather_rows(table, idx))}
        return out


# ---------------------------------------------------------------------------
# Phase 6: attention (kernels/flash_attention.py).
# ---------------------------------------------------------------------------

# H100 SXM dense peaks: bf16 and TF32 tensor cores, fp32 on the CUDA cores
BF16_FLOPS, TF32_FLOPS, FP32_FLOPS = 989e12, 495e12, 67e12
# bf16: both sides compute in fp32 and round to bf16, so they may differ by
# one bf16 ulp, at most 2^-7 of the value (rtol 1e-2), or by atol 1e-3 near
# 0.  fp32: the summation order differs from the plain version's.
BF16_TOL, FP32_TOL = (1e-3, 1e-2), (1e-4, 1e-4)
WGMMA, TF32X3, CORES = ("flash_attention_wgmma", "flash_attention_tf32x3",
                        "flash_attention")
# (peak, passes) of each kernel's bound: the 3xTF32 kernel runs every
# product three times on the TF32 tensor cores
KERNEL_PEAK = {WGMMA: (BF16_FLOPS, 1), TF32X3: (TF32_FLOPS, 3),
               CORES: (FP32_FLOPS, 1)}


class AttnCase(NamedTuple):
    b: int
    tq: int
    tkv: int
    h: int
    kvh: int
    hd: int
    causal: bool
    window: int
    dtype: str
    tol: tuple            # (atol, rtol)
    kernel: str           # the kernel the case must launch


ATTENTION_CASES = {
    "glm4_9b_t4096": AttnCase(1, 4096, 4096, 32, 2, 128, True, 0,
                              "bfloat16", BF16_TOL, WGMMA),
    "mixtral_8x7b_t8192_w4096": AttnCase(1, 8192, 8192, 32, 8, 128, True,
                                         4096, "bfloat16", BF16_TOL, WGMMA),
    "glm4_9b_t1000_fp32": AttnCase(1, 1000, 1000, 32, 2, 128, True, 0,
                                   "float32", FP32_TOL, TF32X3),
    # the window mask and the tiles it skips, held at the fp32 tolerance
    "mixtral_8x7b_t8192_w4096_fp32": AttnCase(1, 8192, 8192, 32, 8, 128,
                                              True, 4096, "float32",
                                              FP32_TOL, TF32X3),
    # the wgmma kernel's other head dims: an encoder (hd 80) and local
    # attention with one kv head (hd 256)
    "hubert_xlarge_t4096": AttnCase(1, 4096, 4096, 16, 16, 80, False, 0,
                                    "bfloat16", BF16_TOL, WGMMA),
    "recurrentgemma_9b_t4096_w2048": AttnCase(1, 4096, 4096, 16, 1, 256,
                                              True, 2048, "bfloat16",
                                              BF16_TOL, WGMMA),
    # mixtral_8x7b's heads at hd 64, the wgmma kernel's single-chunk width
    "hd64_h32_kv8_t4096": AttnCase(1, 4096, 4096, 32, 8, 64, True, 0,
                                   "bfloat16", BF16_TOL, WGMMA),
    # the tiny configs' head dim (d_model 64, 4 heads) at b = 2 and ragged
    # ends, in each dtype: hd 16 reads 48 (bf16) or 16 (fp32) zero columns
    # past hd through TMA's out-of-bounds fill
    "hd16_b2_q1000_kv1200": AttnCase(2, 1000, 1200, 32, 8, 16, True, 0,
                                     "bfloat16", BF16_TOL, WGMMA),
    "hd16_b2_q1000_kv1200_fp32": AttnCase(2, 1000, 1200, 32, 8, 16, True, 0,
                                          "float32", FP32_TOL, TF32X3),
    # a head dim no tensor-core kernel is built for (not a multiple of 16
    # or 32 columns) stays on the CUDA cores
    "hd100_t1000": AttnCase(1, 1000, 1000, 32, 8, 100, True, 0, "bfloat16",
                            BF16_TOL, CORES),
    # b = 2 and ends that are no multiple of a tile, one per wgmma head
    # dim: the kernel's ragged-key mask, its store cut-off at tq and the
    # batch coordinate of its TMA maps; tq != tkv in the last two, and in
    # the last one rows 899-999 have no live key (`fill_dead_rows`)
    "glm4_9b_b2_t1000": AttnCase(2, 1000, 1000, 32, 2, 128, True, 0,
                                 "bfloat16", BF16_TOL, WGMMA),
    "hubert_xlarge_b2_q1000_kv1200": AttnCase(2, 1000, 1200, 16, 16, 80,
                                              False, 0, "bfloat16",
                                              BF16_TOL, WGMMA),
    "recurrentgemma_9b_b2_q1000_kv700_w200": AttnCase(
        2, 1000, 700, 16, 1, 256, True, 200, "bfloat16", BF16_TOL, WGMMA),
}
# the case each attention kernel's entry in the kernels line reports
ATTENTION_ROW = {WGMMA: "glm4_9b_t4096",
                 TF32X3: "mixtral_8x7b_t8192_w4096_fp32",
                 CORES: "hd100_t1000"}


def live_pairs(tq, tkv, causal, window):
    """(query, key) pairs the masks leave live, for tq queries and tkv
    keys."""
    q = np.arange(tq, dtype=np.int64)
    hi = np.minimum(q + 1, tkv) if causal else np.full(tq, tkv)
    lo = np.maximum(q - window + 1, 0) if window > 0 else np.zeros(tq, int)
    return int(np.maximum(hi - lo, 0).sum())


class AttentionPhase:
    """Phase 6: `flash_attention` against `flash_attention_plain` on the
    card at the attention widths of the cases in `ATTENTION_CASES`; then
    the kernel's, the plain version's and `scaled_dot_product_attention`'s
    times."""

    def __init__(self, smoke, fa):
        self.s, self.torch, self.dev, self.fa = smoke, smoke.torch, \
            smoke.dev, fa

    def inputs(self, name, seed):
        c = ATTENTION_CASES[name]
        torch = self.torch
        gen = torch.Generator(device=self.dev).manual_seed(seed)
        dt = getattr(torch, c.dtype)
        return tuple(torch.randn(shape, generator=gen, device=self.dev,
                                 dtype=torch.float32).to(dt)
                     for shape in ((c.b, c.tq, c.h, c.hd),
                                   (c.b, c.tkv, c.kvh, c.hd),
                                   (c.b, c.tkv, c.kvh, c.hd)))

    def path(self):
        """Every case once through `flash_attention`, with the launch counts
        reset just before; each case must launch one kernel, the one it
        names, and its output be finite and within tolerance of the plain
        version.  Returns the
        launches per kernel, the kernel of each case and the largest
        errors."""
        torch, fa, tk = self.torch, self.fa, self.s.tk
        outs, ran = {}, {}
        torch.cuda.synchronize()
        tk.reset_launch_counts()
        for i, (name, c) in enumerate(ATTENTION_CASES.items()):
            before = tk.launch_counts()
            outs[name] = fa.flash_attention(*self.inputs(name, 6000 + i),
                                            causal=c.causal, window=c.window)
            after = tk.launch_counts()
            ran[name] = [k for k in fa.KERNELS if after[k] != before[k]]
        torch.cuda.synchronize()
        launches = {k: tk.launch_counts()[k] for k in fa.KERNELS}
        for name, kernels in ran.items():
            want = ATTENTION_CASES[name].kernel
            if kernels != [want]:
                raise SystemExit(f"attention {name}: launched {kernels}, "
                                 f"expected [{want}]")
        if any(n <= 0 for n in launches.values()):
            raise SystemExit(f"attention: a kernel never launched "
                             f"({launches})")
        errs = {}
        for i, (name, out) in enumerate(outs.items()):
            c = ATTENTION_CASES[name]
            atol, rtol = c.tol
            want = fa.flash_attention_plain(*self.inputs(name, 6000 + i),
                                            causal=c.causal, window=c.window)
            got, want = out.float(), want.float()
            if out.shape != (c.b, c.tq, c.h, c.hd) or \
                    not torch.isfinite(got).all():
                raise SystemExit(f"attention {name}: output not finite or of "
                                 "the wrong shape")
            err = (got - want).abs()
            errs[name] = float(err.max())
            if bool((err > atol + rtol * want.abs()).any()):
                raise SystemExit(f"attention {name}: differs from the plain "
                                 f"version (max abs err {errs[name]})")
        return launches, {n: k[0] for n, k in ran.items()}, errs

    def timing(self, name, seed):
        torch, fa, s = self.torch, self.fa, self.s
        c = ATTENTION_CASES[name]
        causal, window = c.causal, c.window
        q, k, v = self.inputs(name, seed)
        row = {"kernel": fa.kernel_for(q.dtype, c.hd),
            "ms": s.device_ms(lambda: fa.flash_attention(
                q, k, v, causal=causal, window=window), reps=10),
            "plain_ms": s.time_ms(lambda: fa.flash_attention_plain(
                q, k, v, causal=causal, window=window), reps=3, warmup=1)}
        # the library yardstick: SDPA on [b, h, t, hd] views, with a mask
        # where there is a window
        sdpa = torch.nn.functional.scaled_dot_product_attention
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        mask = None
        if window > 0:
            qpos = torch.arange(c.tq, device=self.dev)[:, None]
            kpos = torch.arange(c.tkv, device=self.dev)[None, :]
            mask = (kpos <= qpos) & (kpos > qpos - window)
        try:                          # a yardstick, not part of the port
            row["library_ms"] = s.device_ms(lambda: sdpa(
                qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
                enable_gqa=True), reps=10)
        except RuntimeError as err:
            row["library_ms"] = None
            row["library_error"] = f"not measured: {err!r}"[:300]
        # read q, k and v once, write o once
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        flops = 4 * c.b * c.h * c.hd * live_pairs(c.tq, c.tkv, causal,
                                                  window)
        peak, passes = KERNEL_PEAK[row["kernel"]]
        row.update(bytes=nbytes, flops=flops, passes=passes,
                   bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                   flops_ms=passes * flops / peak * 1e3)
        row["bound_ms"] = max(row["bytes_ms"], row["flops_ms"])
        row["bound_by"] = "bytes" if row["bytes_ms"] > row["flops_ms"] \
            else "operations"
        return row


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              "root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch import atomics, convert, guard, runtime
    from repro_torch.core import engine, layout
    from repro_torch import kernels as tk
    from repro_torch.guard import inject
    from repro_torch.kernels import _build, llsc_commit, ops, ref
    from repro_torch.kernels import engine_round as er
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import scrub_digest

    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} card {torch.cuda.get_device_name(0)}")
    card = card_line()
    log(f"card: {card}")
    out_dir = ROOT / "chiprun_out"          # details and profiler traces
    out_dir.mkdir(exist_ok=True)

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_build.SIGNATURES)) as pool:  # nvcc's at once
        libs = list(pool.map(_build.build, _build.SIGNATURES))
    for name in _build.SIGNATURES:
        _build.load(name)
    build_s = time.perf_counter() - t0
    log(f"[build] {', '.join(lib.name for lib in libs)} in {build_s:.2f} s")

    smoke = Smoke(torch, atomics, engine, er, convert, tk)

    # -- 2. kernel vs plain ----------------------------------------------------
    t0 = time.perf_counter()
    sort_cases = [(N, P, s) for s in SORT_SPECTRA]
    sort_cases += [(N, p, "uniform") for p in (1, 700, 3000, 2 ** 20)]
    passes = {}
    for i, (n, p, spectrum) in enumerate(sort_cases):
        passes[f"{spectrum}_p{p}"] = smoke.sort_vs_torch(n, p, spectrum,
                                                         seed=500 + i)
    if passes[f"uniform_p{P}"] != 3:
        raise SystemExit(f"the sort ran {passes[f'uniform_p{P}']} passes "
                         "on 23-bit keys, not 3")
    log(f"[kernel-vs-plain] the prologue's sort equals torch.sort(stable="
        f"True) in {len(sort_cases)} cases (n = 2**22) in "
        f"{time.perf_counter() - t0:.1f} s; passes run {passes}")
    t0 = time.perf_counter()
    cases = [(4096, k, 2048, s) for k in (1, 3, 4, 5, 16, 20)
             for s in ("none", "low", "all_same")]
    cases += [(4096, k, 2048, "long") for k in (3, 5, 20)]
    cases += [(N, K, P, s) for s in ("none", "low", "all_same", "zipf",
                                     "long")]
    for i, (n, k, p, spectrum) in enumerate(cases):
        smoke.kernel_vs_plain(n, k, p, spectrum, seed=1000 + i)
    log(f"[kernel-vs-plain] {len(cases)} cases x 4 kernels, each branch "
        f"taken and not, bit-identical in {time.perf_counter() - t0:.1f} s "
        f"(spectra none / low / all_same / zipf / long; k = 1, 3, 4, 5, 16, "
        f"20)")
    # p = 2**20: 1024 epilogue tiles of 512 threads, more than the card
    # holds at once, so the epilogue's blocks take tickets
    t0 = time.perf_counter()
    branches = [smoke.round_vs_plain_round(N, K, 2 ** 20, spectrum,
                                           seed=1500 + i)
                for i, spectrum in enumerate(("none", "low"))]
    if branches != ["fast", "slow"]:
        raise SystemExit(f"p = 2**20: branches {branches}, not fast, slow")
    log(f"[kernel-vs-plain] the round's kernels equal the plain round "
        f"(make_round mode xla) at n = 2**22, p = 2**20 on both branches in "
        f"{time.perf_counter() - t0:.1f} s")

    # -- 3. main path --------------------------------------------------------
    totals = dict.fromkeys(ROUND_KERNELS, 0)
    timings = {}
    states = {}
    for si, strategy in enumerate(STRATEGIES):
        (spec, state, initial, record, launches, final, read,
         wall) = smoke.main_path(strategy, seed=si)
        for name in totals:
            totals[name] += launches[name]
        smoke.check_main_path(strategy, initial, record, launches, final,
                              read)
        tiers = " ".join(f"{name}:{tier}" for name, _, tier, *_ in record)
        log(f"[main-path] {strategy}: 6 batches in {wall:.3f} s, launches "
            f"{launches}, branches {tiers}; oracle-equal")
        states[strategy] = (spec, state)
    launches_main = dict(totals)

    # -- 3b. table ops -----------------------------------------------------------
    table = TableOps(smoke, tk, ops, llsc_commit, ref)
    t0 = time.perf_counter()
    n_cases = table.kernel_vs_plain()
    log(f"[table-ops] {n_cases} cases x 4 kernels bit-identical to their "
        f"plain versions in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rounds_cases = table.rounds_vs_plain()
    log(f"[table-ops] cas_apply_rounds bit-identical to the round loop in "
        f"{len(rounds_cases)} cases in {time.perf_counter() - t0:.1f} s "
        "(longest segment / rounds): " + "; ".join(
            f"{name} {longest}/{rounds}"
            for name, longest, rounds in rounds_cases))
    t0 = time.perf_counter()
    counts, fast_in_commit, op = table.main_path(atomics, engine, convert)
    table_wall = time.perf_counter() - t0
    for name in TABLE_KERNELS:
        launches_main[name] = counts[name]
    log(f"[table-ops] path in {table_wall:.2f} s (CacheHash build "
        f"{op['build_cachehash_s']:.2f} s, chains <= {op['max_depth']}, "
        f"queries hit/miss {op['find_mix']}), update rounds (= longest "
        f"segment) {op['rounds']}, launches {counts}, commit_round's "
        f"branch {fast_in_commit}; oracle-equal")
    table_entries, table_kernels = table.timing(op)
    for name, row in table_entries.items():
        prof = row.get("profile", {})
        log(f"[table-timing] {name:32s} {row['ms']:.4f} ms, device busy "
            f"{prof.get('device_busy_share', prof.get('error'))}")
    for name, row in table_kernels.items():
        log(f"[table-timing] kernel {name:24s} {row['ms']:.5f} ms device / "
            f"{row['with_launch_ms']:.4f} ms with launch, plain "
            f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.6f} ms "
            f"({row['bytes']} B, {row['written_rows']} rows written)")
    log(f"[table-timing] note: data.index_select(0, idx) "
        f"{table_kernels['seqlock_gather']['index_select_ms']:.5f} ms device")
    log(f"[table-timing] longest segment: {op['rounds']}")
    del op, table
    torch.cuda.empty_cache()

    # -- 4. timing -------------------------------------------------------------
    rng = np.random.default_rng(99)
    for strategy in STRATEGIES:
        spec, state = states.pop(strategy)
        _, timings[strategy] = smoke.timing(strategy, spec, state, rng)
        for name, row in timings[strategy].items():
            log(f"[timing] {strategy:9s} {name:20s} {row['branch']} (longest "
                f"segment {row['longest_segment']}): apply "
                f"{row['apply_ms']:.4f} ms ({row['ops_per_s']:.4g} ops/s), "
                f"replayed graph {row['replay_ms']:.4f} ms "
                f"({row['replay_device_ms']:.4f} ms device), host side "
                f"{row['host_side_ms']:.4f} ms "
                + json.dumps({k: round(v, 4)
                              for k, v in row['host_steps_ms'].items()}))
            for kname, kern in row["kernels"].items():
                log(f"[timing] {strategy:9s} {name:20s} {kname:14s} "
                    f"{kern['ms']:.5f} ms device / {kern['with_launch_ms']:.4f}"
                    f" ms with launch, plain {kern['plain_ms']:.4f} ms, bound "
                    f"{kern['bound_ms']:.6f} ms")
            log(f"[timing] {strategy:9s} {name:20s} torch.sort alone "
                f"{row['kernels']['round_prologue']['library_ms']:.5f} ms; "
                f"device operations per eager apply "
                f"{row['profile']['device_ops_per_apply']} (with torch.sort "
                f"{TORCH_SORT_DEVICE_OPS[strategy]}, limit "
                f"{DEVICE_OPS_LIMIT[strategy]})")
            for what in ("profile", "replay_profile"):
                prof = row[what]
                log(f"[{what}] {strategy:9s} {name:20s} " + json.dumps(
                    {k: (round(v, 4) if isinstance(v, float) else v)
                     for k, v in prof.items()
                     if k not in ("top_device_us_per_apply", "device_ops")})
                    + " top " + json.dumps({k: round(v, 2) for k, v in
                                            prof.get("top_device_us_per_apply",
                                                     {}).items()}))
        del state
        torch.cuda.empty_cache()

    slow_cases = smoke.slow_spectra()
    for name, row in slow_cases.items():
        log(f"[timing] slow_round {name} (p={P}, longest segment "
            f"{row['longest_segment']}): {row['ms']:.4f} ms device, bound "
            f"{row['bound_ms']:.6f} ms")
    torch.cuda.empty_cache()

    # -- 5. guard ----------------------------------------------------------------
    gp = GuardPhase(smoke, guard, inject, runtime, scrub_digest)
    t0 = time.perf_counter()
    n_cases = gp.kernel_vs_plain()
    log(f"[guard] digest_rows bit-identical to its plain version in "
        f"{n_cases} cases (k = 1, 3, 4, 5, 16 at n = 1003; full width, also "
        f"to numpy) in {time.perf_counter() - t0:.1f} s")
    guard_ops, guard_timing = {}, {}
    torch.cuda.synchronize()
    tk.reset_launch_counts()
    t0 = time.perf_counter()
    for si, strategy in enumerate(STRATEGIES):
        guard_ops[strategy] = gp.layout(strategy, seed=7000 + si)
        rep = guard_ops[strategy]["report"]
        log(f"[guard] {strategy}: {GUARD_FAULTS} faults, detected "
            f"{len(rep['detected'])},"
            f" repaired {len(rep['repaired'])}, quarantined "
            f"{len(rep['quarantined'])}, invariants "
            f"{ {k: len(v) for k, v in rep['invariant_violations'].items()} }"
            f"; mask_ops batch oracle-equal; second scrub clean")
    guard_wall = time.perf_counter() - t0
    guard_launches = tk.launch_counts()
    launches_main["digest_rows"] = guard_launches["digest_rows"]
    if guard_launches["digest_rows"] <= 0:
        raise SystemExit("guard: digest_rows never launched on the path")
    log(f"[guard] path in {guard_wall:.2f} s, launches {guard_launches}")
    for strategy in STRATEGIES:
        op = guard_ops.pop(strategy)
        row = gp.timing(op)
        row["report"], row["second"] = op["report"], op["second"]
        guard_timing[strategy] = row
        prof = row["scrub_faulted_profile"]
        log(f"[guard-timing] {strategy:9s} cell_digest "
            f"{row['cell_digest_ms']:.4f} ms, digest kernel "
            f"{row['digest_kernel_ms'] * 1e3:.2f} us device (bound "
            f"{row['digest_bound_ms'] * 1e3:.2f} us), plain "
            f"{row['digest_plain_ms']:.4f} ms, check_invariants "
            f"{row['check_invariants_ms']:.4f} ms, Scrubber.scrub clean "
            f"{row['scrub_clean_ms']:.3f} ms / 64 faults "
            f"{row['scrub_faulted_ms']:.3f} ms, device busy "
            f"{prof.get('device_busy_share', prof.get('error'))}")
        del op
        torch.cuda.empty_cache()
    row_gather = gp.row_gather(layout)
    for name, row in row_gather.items():
        log(f"[guard-timing] row gather of {N} x {K * 4} B rows, {name} "
            f"index: table[idx] {row['index_ms'] * 1e3:.1f} us, gather_rows "
            f"{row['gather_rows_ms'] * 1e3:.1f} us device")
    torch.cuda.empty_cache()

    # -- 6. attention -------------------------------------------------------------
    ap = AttentionPhase(smoke, fa)
    t0 = time.perf_counter()
    attn_launches, attn_kernel, attn_err = ap.path()
    launches_main.update(attn_launches)
    for name in attn_launches:
        smoke.max_err[name] = max(err for case, err in attn_err.items()
                                  if attn_kernel[case] == name)
    log(f"[attention] {len(ATTENTION_CASES)} cases within tolerance of the "
        f"plain version in {time.perf_counter() - t0:.1f} s, launches "
        f"{attn_launches}, kernels {attn_kernel}, max abs err {attn_err}")
    attn_timing = {}
    for i, name in enumerate(ATTENTION_CASES):
        attn_timing[name] = row = ap.timing(name, 6000 + i)
        log(f"[attention-timing] {name:30s} {row['kernel']:22s} "
            f"{row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}: bytes {row['bytes_ms']:.4f} / FLOPs "
            f"{row['flops_ms']:.4f} ms), plain {row['plain_ms']:.4f} ms, "
            f"sdpa {row['library_ms']}")
        torch.cuda.empty_cache()

    # -- report ----------------------------------------------------------------
    ref = timings["cached_me"]
    rows = []
    for name, bench in (("round_prologue", "c_uniform_u20"),
                        ("fast_round", "a_distinct_all_kinds"),
                        ("slow_round", "c_uniform_u20"),
                        ("round_epilogue", "c_uniform_u20")):
        t = ref[bench]["kernels"][name]
        rows.append({
            "name": name, "route": "cuda", "source": KERNELS[name][0],
            "replaces": KERNELS[name][1], "launches": launches_main[name],
            "max_abs_err": smoke.max_err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "library_ms": t.get("library_ms")})
    for name in TABLE_KERNELS:
        t = table_kernels[name]
        rows.append({
            "name": name, "route": "cuda", "source": KERNELS[name][0],
            "replaces": KERNELS[name][1], "launches": launches_main[name],
            "max_abs_err": smoke.max_err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "library_ms": None})
    g = guard_timing["seqlock"]
    rows.append({
        "name": "digest_rows", "route": "cuda",
        "source": KERNELS["digest_rows"][0],
        "replaces": KERNELS["digest_rows"][1],
        "launches": launches_main["digest_rows"],
        "max_abs_err": smoke.max_err["digest_rows"],
        "ms": g["digest_kernel_ms"], "plain_ms": g["digest_plain_ms"],
        "bound_ms": g["digest_bound_ms"], "bound_by": "bytes",
        "library_ms": None})
    for name, case in ATTENTION_ROW.items():
        a = attn_timing[case]
        rows.append({
            "name": name, "route": "cuda", "source": KERNELS[name][0],
            "replaces": KERNELS[name][1], "launches": launches_main[name],
            "max_abs_err": smoke.max_err[name], "ms": a["ms"],
            "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
            "bound_by": a["bound_by"], "library_ms": a["library_ms"]})
    details = {"card": card, "build_s": build_s, "n": N, "k": K, "p": P,
               "sort_passes": passes,
               "launches_main_path": launches_main, "timing": timings,
               "slow_round_cases": slow_cases,
               "table_ops": {"m": M, "kw": KW, "vw": VW,
                             "path_wall_s": table_wall,
                             "commit_round_branch": fast_in_commit,
                             "entry_points": table_entries,
                             "kernels": table_kernels},
               "guard": {"path_wall_s": guard_wall,
                         "launches": guard_launches, "timing": guard_timing,
                         "row_gather": row_gather},
               "attention": {"cases": {n: c._asdict() for n, c in
                                       ATTENTION_CASES.items()},
                             "launches": attn_launches,
                             "kernel": attn_kernel,
                             "max_abs_err": attn_err, "timing": attn_timing},
               "kernels": rows}
    (out_dir / "chip_smoke.json").write_text(json.dumps(details, indent=1))
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
