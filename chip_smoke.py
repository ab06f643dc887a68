#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and `nvcc`.
It imports only the port (`src/repro_torch`), never JAX or the reference
package, and runs four phases:

  1. build   compile the hand-written kernels (`kernels/csrc/*.cu`) with
             nvcc for sm_90a; print the build time, the card's name and
             power limit.
  2. kernel vs plain
             each kernel against its plain PyTorch version on the card, bit
             for bit on every output and on the updated table: spectra none
             / low / all_same, all seven op kinds, several k (odd included),
             and the main path's shapes.
  3. main path
             `atomics.apply` at n=2**22, k=4, p=16384 for seqlock, indirect,
             cached_wf and cached_me: (a) distinct slots, all kinds; (b)
             read-only with duplicate slots; (c) uniform slots, 20 %
             updates; (d) Zipf 0.99 slots, 20 % updates; (e) an LL batch,
             then SC/VALIDATE on the linked slots.  Launch counts are reset
             just before and read just after; both kernels must have run.
             The same batches replay through the numpy sequential oracle:
             results, links, logical values, versions and `read()` must
             agree exactly.
  4. timing  median time per `apply` by tier (CUDA events), the kernels
             alone, their plain versions, and the host-side steps around
             them.

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
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
N, K, P = 2 ** 22, 4, 16384
STRATEGIES = ("seqlock", "indirect", "cached_wf", "cached_me")
HBM_BYTES_PER_S = 3.35e12       # H100 SXM published memory rate
KERNELS = {
    "fast_round": ("src/repro_torch/kernels/csrc/engine_round.cu",
                   "src/repro/kernels/engine_round.py:340"),
    "slow_round": ("src/repro_torch/kernels/csrc/engine_round.cu",
                   "src/repro/kernels/engine_round.py:506"),
}


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


class Smoke:
    def __init__(self, torch, atomics, engine, er, convert):
        self.torch, self.atomics, self.engine = torch, atomics, engine
        self.er, self.convert = er, convert
        self.dev = torch.device("cuda", 0)
        self.max_err = {"fast_round": 0, "slow_round": 0}

    # -- helpers -------------------------------------------------------------

    def words(self, arr):
        return self.convert.tensor(arr, self.dev, word=True)

    def np_words(self, t):
        return self.convert.array(t, word=True)

    def time_ms(self, fn, reps=20, warmup=3):
        """Median ms per call, CUDA events around each call."""
        torch = self.torch
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in pairs)

    def device_ms(self, fn, reps=20):
        """Device ms per call of a launch-only `fn` (no host syncs): the
        calls queue behind a spin kernel, so the events bracket the
        kernels alone and not the host's time to launch them."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)       # ~50 ms while the host enqueues
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    def device_busy(self, run, reps=5, trace=None):
        """Share of the wall time of `run` (which ends synchronised) that
        the card spends in kernels, memcpys and memsets, from a
        torch.profiler trace; plus the kernels' device time by name."""
        from torch.profiler import ProfilerActivity, profile
        torch = self.torch
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                for _ in range(reps):
                    run()
                wall_us = (time.perf_counter() - t) * 1e6
            path = trace or (ROOT / "chiprun_out" / "apply_trace.tmp.json")
            prof.export_chrome_trace(str(path))
            events = json.loads(Path(path).read_text())["traceEvents"]
        except Exception as err:          # the profiler is optional here
            return {"error": f"not measured: {err!r}"}
        finally:
            torch.cuda.synchronize()
        busy, by_name = 0.0, {}
        for ev in events:
            if ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
                busy += ev.get("dur", 0.0)
                name = ev.get("name", "?")[:60]
                by_name[name] = by_name.get(name, 0.0) + ev.get("dur", 0.0)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        return {"device_busy_share": busy / wall_us,
                "device_us_per_apply": busy / reps,
                "device_ops_per_apply": sum(
                    1 for ev in events if ev.get("cat") in
                    ("kernel", "gpu_memcpy", "gpu_memset")) / reps,
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
        kind = rng.integers(0, 7, p).astype(np.int32)
        if spectrum == "none":
            slot = rng.choice(n, p, replace=False).astype(np.int32)
        elif spectrum == "low":
            slot = rng.integers(0, max(n // 8, 2), p).astype(np.int32)
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
        ctx = (cslot, cver, np.zeros((p, k), np.uint32), rng.random(p) < 0.8)
        return (kind, slot, expected, desired), ctx

    def round_inputs(self, n, ops, ctx, tier):
        """The wrapper operands the round builds for `ops` (fast: lane
        order, inactive lanes at n; slow: sorted by (slot, lane))."""
        engine = self.engine
        ops = self.convert.op_batch(ops, self.dev)
        ctx = self.convert.link_ctx(ctx, self.dev)
        if tier == "fast":
            slot = self.torch.where(ops.kind != engine.IDLE, ops.slot, n)
            return (slot, ops.kind, engine.poisoned_link_ver(ctx, ops.slot),
                    ops.expected, ops.desired)
        lanes = engine.sort_lanes(n, ctx, ops)
        return (lanes.slot, lanes.kind, lanes.link_ver, lanes.expected,
                lanes.desired)

    # -- phase 2 -------------------------------------------------------------

    def kernel_vs_plain(self, n, k, p, spectrum, seed):
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
        for tier, batch in (("slow", ops), ("fast", fast_ops)):
            args = self.round_inputs(n, batch, ctx, tier)
            kern = er.fast_round if tier == "fast" else er.slow_round
            plain = er.fast_round_plain if tier == "fast" \
                else er.slow_round_plain
            got = kern(d.clone(), v.clone(), *args)
            want = plain(d.clone(), v.clone(), *args)
            torch.cuda.synchronize()
            self.compare(f"{tier}_round", got, want)

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

    def main_path(self, strategy, seed):
        """Drive `atomics.apply` through batches (a)-(e); returns the
        recorded batches and outputs, plus per-batch tiers."""
        atomics, er, torch = self.atomics, self.er, self.torch
        spec = atomics.AtomicSpec(N, K, strategy, p_max=P)
        rng = np.random.default_rng(seed)
        initial = rng.integers(0, 2 ** 32, (N, K), dtype=np.uint32)
        state = atomics.init(spec, initial, device=self.dev)
        ctx = atomics.init_ctx(P, K, device=self.dev)
        record = []
        names = ["a_distinct_all_kinds", "b_read_only_dup", "c_uniform_u20",
                 "d_zipf099_u20", "e1_ll", "e2_sc_validate"]
        torch.cuda.synchronize()
        er.reset_launch_counts()
        t0 = time.perf_counter()
        for name in names:
            current = self.np_words(atomics.logical(spec, state))
            ops = self.main_batch(name, rng, current,
                                  ctx.slot.cpu().numpy())
            f0, s0 = er.fast_round.launches, er.slow_round.launches
            state, ctx, res, stats, traffic = atomics.apply(
                spec, state, self.convert.op_batch(ops, self.dev), ctx,
                donate=True)
            tier = ("fast" if er.fast_round.launches > f0 else "") + \
                ("slow" if er.slow_round.launches > s0 else "")
            record.append((name, ops, tier, self.convert.to_numpy(res),
                           self.convert.to_numpy(ctx),
                           {f: int(x) for f, x in zip(stats._fields, stats)}))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"fast_round": er.fast_round.launches,
                    "slow_round": er.slow_round.launches}
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
        for name, ops, tier, res, got_ctx, stats in record:
            if name in expect and tier != expect[name]:
                raise SystemExit(f"{strategy}/{name}: ran the {tier or 'no'} "
                                 f"kernel, expected {expect[name]}")
            data, ver, ctx, ref = engine.apply_ops_reference(data, ver, ctx,
                                                             ops)
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

    def timing(self, strategy, spec, state, rng):
        """Median ms per apply by tier, the kernels alone, their plain
        versions, and the host-side steps around them."""
        atomics, engine, er, torch = (self.atomics, self.engine, self.er,
                                      self.torch)
        impl = atomics.get_strategy(strategy)
        current = self.np_words(atomics.logical(spec, state))
        ctx = atomics.init_ctx(P, K, device=self.dev)
        out = {}
        for tier, name in (("fast", "a_distinct_all_kinds"),
                           ("slow", "c_uniform_u20"),
                           ("slow", "d_zipf099_u20")):
            ops_np = self.main_batch(name, rng, current, None)
            ops = self.convert.op_batch(ops_np, self.dev)
            row = {"tier": tier}
            host = []

            def run():
                nonlocal state
                t = time.perf_counter()
                state, *_ = atomics.apply(spec, state, ops, ctx, donate=True)
                torch.cuda.synchronize()
                host.append(time.perf_counter() - t)

            row["apply_ms"] = self.time_ms(run)
            row["apply_host_clock_ms"] = statistics.median(host) * 1e3
            row["ops_per_s"] = P / (row["apply_ms"] * 1e-3)
            ctx_np = self.convert.to_numpy(ctx)
            args = self.round_inputs(N, ops_np, ctx_np, tier)
            d = impl.engine_view(state).clone()
            v = state.version.clone()
            kern = er.fast_round if tier == "fast" else er.slow_round
            plain = er.fast_round_plain if tier == "fast" \
                else er.slow_round_plain
            row["kernel_ms"] = self.device_ms(lambda: kern(d, v, *args))
            row["kernel_with_launch_ms"] = self.time_ms(
                lambda: kern(d, v, *args))
            row["plain_ms"] = self.time_ms(lambda: plain(d, v, *args),
                                           reps=5, warmup=1)
            steps = {
                "check_kinds": lambda: engine.check_kinds(
                    ops.kind, engine.TABLE_KINDS, "table"),
                "version_copy": lambda: state.version.clone(),
                "predicate_readback": lambda: bool(
                    er.fast_path_ok(N, ops)),
            }
            if tier == "slow":
                lanes = engine.sort_lanes(N, ctx, ops)
                _, _, val, verpt, succ = er.slow_round(d, v, *args)
                steps["sort_pre"] = lambda: engine.sort_lanes(N, ctx, ops)
                steps["rebuild_stats_post"] = lambda: engine.rebuild(
                    N, ctx, lanes, val, verpt, succ != 0)
            else:
                link_ver = engine.poisoned_link_ver(ctx, ops.slot)
                _, _, wit, verpt, okw = er.fast_round(d, v, *args)
                steps["assemble_post"] = lambda: er._assemble_fast(
                    N, ctx, ops, link_ver, wit, verpt, okw != 0, d, v)
            scratch = atomics.TableState(*(x.clone() for x in state))
            new_version = scratch.version.clone()
            new_version[:P] += 2
            n_upd = torch.tensor(P, dtype=torch.int32, device=self.dev)
            steps["commit"] = lambda: impl.commit(
                scratch, scratch.data, new_version, n_upd, P)
            row["host_steps_ms"] = {k: self.time_ms(fn, reps=10)
                                    for k, fn in steps.items()}
            row["host_side_ms"] = row["apply_ms"] - row["kernel_ms"]
            row["bytes"] = self.round_bytes(N, K, args, tier, d, v)
            row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
            trace = (ROOT / "chiprun_out" / f"apply_trace_{strategy}_{name}"
                     ".json") if strategy == "cached_me" else None
            row["profile"] = self.device_busy(run, trace=trace)
            out[name] = row
        return state, out

    def round_bytes(self, n, k, args, tier, data, version):
        """Bytes the round must move on these inputs: every lane operand
        read once, every output written once, each distinct live row (and
        its version) read once, each written row written once."""
        torch = self.torch
        slot = args[0]
        p = slot.shape[0]
        live = (slot >= 0) & (slot < n)
        rows = int(torch.unique(slot[live]).numel())
        kern = self.er.fast_round if tier == "fast" else self.er.slow_round
        d0, v0 = data.clone(), version.clone()
        kern(d0, v0, *args)
        written = int(((d0 != data).any(1) | (v0 != version)).sum())
        lane_in = p * (4 + 4 + 4 + 4 * k + 4 * k)
        lane_out = p * (4 * k + 4 + 4)
        return lane_in + lane_out + (rows + written) * (4 * k + 4)


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
    from repro_torch import atomics, convert
    from repro_torch.core import engine
    from repro_torch.kernels import _build
    from repro_torch.kernels import engine_round as er

    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} card {torch.cuda.get_device_name(0)}")
    card = card_line()
    log(f"card: {card}")
    out_dir = ROOT / "chiprun_out"          # details and profiler traces
    out_dir.mkdir(exist_ok=True)

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    build_s = time.perf_counter() - t0
    log(f"[build] {lib.name} in {build_s:.2f} s")

    smoke = Smoke(torch, atomics, engine, er, convert)

    # -- 2. kernel vs plain ----------------------------------------------------
    t0 = time.perf_counter()
    cases = [(4096, k, 2048, s) for k in (1, 3, 4, 5, 16, 20)
             for s in ("none", "low", "all_same")]
    cases += [(N, K, P, s) for s in ("none", "low", "all_same")]
    for i, (n, k, p, spectrum) in enumerate(cases):
        smoke.kernel_vs_plain(n, k, p, spectrum, seed=1000 + i)
    log(f"[kernel-vs-plain] {len(cases)} cases x 2 kernels bit-identical "
        f"in {time.perf_counter() - t0:.1f} s")

    # -- 3. main path --------------------------------------------------------
    totals = {"fast_round": 0, "slow_round": 0}
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
            f"{launches}, tiers {tiers}; oracle-equal")
        states[strategy] = (spec, state)
    launches_main = dict(totals)

    # -- 4. timing -------------------------------------------------------------
    rng = np.random.default_rng(99)
    for strategy in STRATEGIES:
        spec, state = states.pop(strategy)
        _, timings[strategy] = smoke.timing(strategy, spec, state, rng)
        for name, row in timings[strategy].items():
            log(f"[timing] {strategy:9s} {name:20s} {row['tier']}: apply "
                f"{row['apply_ms']:.4f} ms ({row['ops_per_s']:.4g} ops/s), "
                f"kernel {row['kernel_ms']:.4f} ms device / "
                f"{row['kernel_with_launch_ms']:.4f} ms with launch, plain "
                f"{row['plain_ms']:.4f} ms, host side "
                f"{row['host_side_ms']:.4f} ms, bound "
                f"{row['bound_ms']:.6f} ms "
                + json.dumps({k: round(v, 4)
                              for k, v in row['host_steps_ms'].items()}))
            prof = row["profile"]
            log(f"[profile] {strategy:9s} {name:20s} " + json.dumps(
                {k: (round(v, 4) if isinstance(v, float) else v)
                 for k, v in prof.items() if k != "top_device_us_per_apply"})
                + " top " + json.dumps({k: round(v, 2) for k, v in prof.get(
                    "top_device_us_per_apply", {}).items()}))
        del state
        torch.cuda.empty_cache()

    # worst case of the slow kernel: every lane on one cell
    rng = np.random.default_rng(7)
    data = rng.integers(0, 2 ** 32, (N, K), dtype=np.uint32)
    ver = np.zeros(N, np.uint32)
    ops, ctx = smoke.spectrum_batch(rng, N, K, P, "all_same", data, ver)
    args = smoke.round_inputs(N, ops, ctx, "slow")
    d, v = smoke.words(data), smoke.words(ver)
    worst_ms = smoke.device_ms(lambda: er.slow_round(d, v, *args), reps=5)
    log(f"[timing] slow_round all_same (one cell, p={P}): {worst_ms:.4f} ms")

    # -- report ----------------------------------------------------------------
    ref = timings["cached_me"]
    rows = []
    for name, bench in (("fast_round", "a_distinct_all_kinds"),
                        ("slow_round", "c_uniform_u20")):
        t = ref[bench]
        rows.append({
            "name": name, "route": "cuda", "source": KERNELS[name][0],
            "replaces": KERNELS[name][1], "launches": launches_main[name],
            "max_abs_err": smoke.max_err[name], "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "library_ms": None})
    details = {"card": card, "build_s": build_s, "n": N, "k": K, "p": P,
               "launches_main_path": launches_main, "timing": timings,
               "slow_round_all_same_ms": worst_ms, "kernels": rows}
    (out_dir / "chip_smoke.json").write_text(json.dumps(details, indent=1))
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
