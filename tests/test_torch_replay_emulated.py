"""The engine-round and table kernels compiled for the CPU and held bit for
bit against their plain versions: the segment replay
(`kernels/csrc/segment_replay.cuh`, behind `slow_round` in
`engine_round.cu` and `cas_apply_rounds` in `table_ops.cu`), the
round's prologue (its radix sort against `torch.sort(stable=True)`), fast
round and epilogue (`engine_round.cu`), and the one-round table kernels
of `table_ops.cu`: the gather, the SC and STORE/CAS commit rounds, the
CacheHash probe and find (`ref.*_ref`).

There is no CUDA compiler or card here, so `tests/cuda_emu/cuda_runtime.h`
stands in for the CUDA runtime: a block runs as one thread per CUDA thread,
meeting at every warp shuffle, ballot and match and at `__syncthreads()`;
blocks run in blockIdx order.  g++
compiles the two sources as they are, apart from their `kernel<<<...>>>`
launches, which become calls of the emulator, and the tests call the C
entry points with CPU tensors.  This checks the kernels' logic: windows
and segment ownership, the write-mask fixed point, the row carried across
chunks, dead lanes, the thread per segment at other widths; the prologue's
sort (the digit histograms, the ranks within a tile, the look-back between
tiles, the passes it skips), gathers and predicate; the fast round's
results and links; the epilogue's lanes put back, its block-wide scans and
the look-back between its tiles that carries the stats, its dirty-slot
list; that the prologue leaves the epilogue's scratch ready; that
every kernel leaves everything alone when the predicate says its branch
is not taken; the gather at the swept widths and between them, on
16-byte vectors and word by word; the commit rounds' two trips at every k (rows past the 16
words a lane holds), the CacheHash kernel at its instantiated widths and
at run-time ones, the find's hash, clamp, cycles and max_chain.  Their speed, and what nvcc makes of them,
only a card can show (`chip_smoke.py`).  Tolerance is zero."""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import engine as tengine
from repro_torch.kernels import _build, ref
from repro_torch.kernels import engine_round as ter

EMU = Path(__file__).resolve().parent / "cuda_emu"
LAUNCH = re.compile(r"([A-Za-z_][\w:]*(?:<[^<>;]*>)?)<<<(.*?)>>>\(", re.S)
KS = [1, 3, 4, 5, 16, 20]                      # 20: a thread per segment


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """engine_round and table_ops compiled by g++ against the emulator."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    out = tmp_path_factory.mktemp("replay_emu")
    for src in _build.sources("engine_round") + _build.sources("table_ops"):
        text = LAUNCH.sub(lambda m: f"EmuLaunch({m.group(2)})({m.group(1)})(",
                          src.read_text())
        (out / src.name).write_text(text)
    loaded = {}
    for name in ("engine_round", "table_ops"):
        so = out / f"lib{name}.so"
        proc = subprocess.run(
            ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-w",
             "-I", str(EMU), "-x", "c++", str(out / f"{name}.cu"), "-o",
             str(so), "-lpthread"], capture_output=True, text=True,
            timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in _build.SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        loaded[name] = lib
    return loaded


def words(a):
    return convert.tensor(a, "cpu", word=True)


def ints(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


def sorted_slots(rng, n, p, spectrum):
    """Slots for p lanes: none (distinct), low (n / 8 cells), hot (one
    cell), long (60 % on one cell, the rest uniform), sorted."""
    if spectrum == "none":
        slot = rng.choice(n, p, replace=False)
    elif spectrum == "low":
        slot = rng.integers(0, n // 8, p)
    elif spectrum == "hot":
        slot = np.full(p, rng.integers(0, n))
    else:
        slot = rng.integers(0, n, p)
        slot[rng.random(p) < 0.6] = rng.integers(0, n)
    return np.sort(slot).astype(np.int32)


def chain(rng, slot, expected, desired, share=0.4):
    """A share of the lanes expect the row the lane before on their cell
    wrote."""
    if len(slot) < 2:
        return
    follow = np.flatnonzero((rng.random(len(slot) - 1) < share)
                            & (slot[1:] == slot[:-1])) + 1
    expected[follow] = desired[follow - 1]


def same(got, want, label):
    for i, (x, y) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(x.numpy(), y.to(x.dtype).numpy(),
                                      err_msg=f"{label}: output {i}")


@pytest.mark.parametrize("spectrum", ["none", "low", "hot", "long"])
@pytest.mark.parametrize("k", KS)
def test_slow_round_matches_plain(libs, k, spectrum):
    """The slow round over 161 sorted lanes (five warps, the last partial):
    all seven kinds, IDLE lanes and two out-of-table slots, chained CAS
    lanes and links to later versions; outputs and table bit for bit."""
    n, p = 256, 161
    rng = np.random.default_rng(k * 10 + len(spectrum))
    data = rng.integers(0, 2 ** 32, (n, k), dtype=np.uint32)
    ver = (rng.integers(0, 8, n) * 2).astype(np.uint32)
    kind = rng.integers(0, 7, p).astype(np.int32)
    slot = sorted_slots(rng, n, p, spectrum)
    slot[kind == tengine.IDLE] = n
    slot[:2] = [-3, -1]
    order = np.argsort(slot, kind="stable")
    kind, slot = kind[order], slot[order]
    expected = rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32)
    desired = rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32)
    take = rng.random(p) < 0.3
    expected[take] = data[np.clip(slot[take], 0, n - 1)]
    chain(rng, slot, expected, desired)
    link = (ver[np.clip(slot, 0, n - 1)] + 2 * rng.integers(0, 8, p)) \
        .astype(np.uint32)
    link[rng.random(p) < 0.2] = 1
    args = (ints(slot), ints(kind), words(link), words(expected),
            words(desired))
    d, v = words(data), words(ver)
    want = ter.slow_round_plain(d.clone(), v.clone(), *args)
    got_d, got_v = d.clone(), v.clone()
    val = torch.full((p, k), 7, dtype=torch.int32)
    verpt = torch.full((p,), 7, dtype=torch.int32)
    succ = torch.full((p,), 7, dtype=torch.int32)
    assert libs["engine_round"].slow_round(
        None, got_d.data_ptr(), got_v.data_ptr(), n, k,
        *(a.data_ptr() for a in args), p, val.data_ptr(), verpt.data_ptr(),
        succ.data_ptr(), 0, None) == 0
    same((got_d, got_v, val, verpt, succ), want, f"k={k} {spectrum}")
    # the fast branch taken: the replay returns at once
    fast = torch.ones((), dtype=torch.bool)
    before = [x.clone() for x in (got_d, got_v, val, verpt, succ)]
    assert libs["engine_round"].slow_round(
        fast.data_ptr(), got_d.data_ptr(), got_v.data_ptr(), n, k,
        *(a.data_ptr() for a in args), p, val.data_ptr(), verpt.data_ptr(),
        succ.data_ptr(), 0, None) == 0
    same((got_d, got_v, val, verpt, succ), before, "fast branch")


@pytest.mark.parametrize("case", ["uniform", "zipf-loads", "hot",
                                  "truncated", "no-round"])
@pytest.mark.parametrize("k", KS)
def test_cas_apply_rounds_matches_round_loop(libs, k, case):
    """All rounds in one launch against the round loop: 150 lanes sorted
    by slot over a table with a dummy row, LOAD lanes, chained CAS lanes,
    fewer rounds than the longest segment, lanes of no round (negative
    ranks); success, witness, table and meta bit for bit."""
    n, p = 64, 150
    rng = np.random.default_rng(k * 100 + len(case))
    data = rng.integers(0, 2 ** 32, (n + 1, k), dtype=np.uint32)
    meta = np.stack([rng.integers(0, 2 ** 31, n + 1) * 2,
                     rng.random(n + 1) < 0.1], 1).astype(np.uint32)
    meta[0, 0] = 2 ** 32 - 2                            # wraps
    if case == "zipf-loads":
        slot = np.sort((rng.zipf(1.3, p) - 1) % n).astype(np.int32)
    else:
        slot = sorted_slots(rng, n, p, "hot" if case == "hot" else "low")
    kind = np.where(rng.random(p) < 0.5, ref.CAS, ref.STORE).astype(np.int32)
    if case == "zipf-loads":
        kind[rng.random(p) < 0.3] = 0
    expected = rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32)
    desired = rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32)
    take = rng.random(p) < 0.4
    expected[take] = data[slot[take]]
    chain(rng, slot, expected, desired)
    idx = np.arange(p)
    start = np.r_[True, slot[1:] != slot[:-1]]
    rank = (idx - np.maximum.accumulate(np.where(start, idx, 0))).astype(
        np.int32)
    rounds = int(rank.max()) + 1
    if case == "truncated":
        rounds = max(1, rounds // 2)
    if case == "no-round":
        rank[rng.random(p) < 0.3] = -1
    args = (ints(slot), ints(kind), words(expected), words(desired),
            ints(rank))
    d, m = words(data), words(meta)
    want = ref.cas_apply_rounds_ref(d.clone(), m.clone(), *args[:4], rounds,
                                    args[4])
    got_d, got_m = d.clone(), m.clone()
    succ = torch.full((p,), 7, dtype=torch.int32)
    wit = torch.full((p, k), 7, dtype=torch.int32)
    assert libs["table_ops"].cas_apply_rounds(
        got_d.data_ptr(), got_m.data_ptr(), n + 1, k,
        *(a.data_ptr() for a in args), rounds, p, succ.data_ptr(),
        wit.data_ptr(), 0, None) == 0
    same((got_d, got_m, succ, wit), want, f"k={k} {case}")
    assert want[2].any() and not want[2].all()


# ---------------------------------------------------------------------------
# The fast round and the epilogue.
# ---------------------------------------------------------------------------

def round_case(seed, n, k, p, spectrum):
    """A batch of all seven kinds over `spectrum` slots (none: distinct;
    low: n / 8 cells; hot: one cell; read: low, read-only kinds) with
    links live, stale, on other cells and dead, as numpy arrays; the table
    (data, version) it runs on."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 2 ** 32, (n, k), dtype=np.uint32)
    ver = (rng.integers(0, 8, n) * 2).astype(np.uint32)
    kinds = [0, 3, 4, 6] if spectrum == "read" else range(7)
    kind = rng.choice(np.asarray(kinds), p).astype(np.int32)
    if spectrum == "none":
        slot = rng.choice(n, p, replace=False)
    elif spectrum == "hot":
        slot = np.full(p, rng.integers(0, n))
    else:
        slot = rng.integers(0, max(n // 8, 2), p)
    slot = slot.astype(np.int32)
    expected = rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32)
    take = rng.random(p) < 0.5
    expected[take] = data[slot[take]]
    desired = rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32)
    chain(rng, slot, expected, desired)
    cslot = np.where(rng.random(p) < 0.7, slot,
                     rng.integers(-1, n, p)).astype(np.int32)
    cver = ver[np.clip(cslot, 0, n - 1)] + 2 * (rng.random(p) < 0.3)
    ctx = (cslot, cver.astype(np.uint32),
           rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32),
           rng.random(p) < 0.8)
    return data, ver, (kind, slot, expected, desired), ctx


def out_sentinel(p, k):
    """`RoundOut` filled with values no kernel writes."""
    out = ter.RoundOut.empty(p, k, "cpu")
    for t in (out.value, out.ctx.slot, out.ctx.version, out.ctx.value,
              out.okw, out.stats, out.dirty):
        t.fill_(-7)
    out.success.fill_(True)
    out.ctx.linked.fill_(True)
    return out


def out_tensors(out):
    return (out.value, out.success, *out.ctx, out.okw, out.stats, out.dirty)


def call_fast(lib, fast, d, v, ctx, ops, out):
    n, k = d.shape
    assert lib.fast_round(
        fast.data_ptr(), d.data_ptr(), v.data_ptr(), n, k,
        ops.slot.data_ptr(), ops.kind.data_ptr(), ops.expected.data_ptr(),
        ops.desired.data_ptr(), *(x.data_ptr() for x in ctx), ops.p,
        out.value.data_ptr(), out.success.data_ptr(),
        *(x.data_ptr() for x in out.ctx), out.okw.data_ptr(), 0, None) == 0


def call_prologue(lib, n, ops, ctx):
    """The prologue's entry point on `ops`: its outputs, the scratch (left
    for the epilogue) filled with garbage before the call."""
    p, k = ops.p, ops.k
    def fill(*shape):
        return torch.full(shape, -7, dtype=torch.int32)
    out = ter.Prologue(torch.tensor(False), fill(p), fill(p), fill(p),
                       fill(p), fill(p, k), fill(p, k),
                       fill(lib.round_scratch(p)))
    assert lib.round_prologue(
        n, k, p, ops.slot.data_ptr(), ops.kind.data_ptr(),
        ops.expected.data_ptr(), ops.desired.data_ptr(),
        ctx.slot.data_ptr(), ctx.version.data_ptr(), ctx.linked.data_ptr(),
        *(x.data_ptr() for x in out[1:7]), out.fast.data_ptr(),
        out.scratch.data_ptr(), 0, None) == 0
    return out


def call_epilogue(lib, fast, n, ctx, order, s_slot, s_kind, val_s, verpt_s,
                  succ_s, version, out, scratch):
    p, k = val_s.shape
    assert lib.round_epilogue(
        fast.data_ptr(), n, k, p, order.data_ptr(), s_slot.data_ptr(),
        s_kind.data_ptr(), val_s.data_ptr(), verpt_s.data_ptr(),
        succ_s.data_ptr(), version.data_ptr(), *(x.data_ptr() for x in ctx),
        out.value.data_ptr(), out.success.data_ptr(),
        *(x.data_ptr() for x in out.ctx), out.okw.data_ptr(),
        out.stats.data_ptr(), out.dirty.data_ptr(), scratch.data_ptr(), 0,
        None) == 0


@pytest.mark.parametrize("case", ["none", "read", "low", "hot", "dead",
                                  "empty"])
@pytest.mark.parametrize("k", [1, 4, 20])
@pytest.mark.parametrize("p", [150, 700, 2200])
def test_round_prologue_matches_plain(libs, p, k, case):
    """The prologue's sorted order, sorted lane operands and predicate on
    one sort tile and on three (the tiles meet by the look-back, the two
    blocks the emulated card holds take turns over them, and the
    predicate's facts meet through the blocks' atomics): collision-free
    (fast), read-only with duplicates (fast),
    colliding with writes (slow), one hot cell (slow), an active lane
    outside [0, n) in an otherwise collision-free batch (slow), and no
    lane at all."""
    n = 4 * p
    spectrum = {"dead": "none", "empty": "none"}.get(case, case)
    data, ver, ops_np, ctx_np = round_case(p + k, n, k, p, spectrum)
    if case == "dead":
        ops_np[0][p // 2] = tengine.LOAD
        ops_np[1][p // 2] = n + 3
    if case == "empty":
        ops_np = tuple(x[:0] for x in ops_np)
        ctx_np = tuple(x[:0] for x in ctx_np)
    ops = convert.op_batch(ops_np, "cpu")
    ctx = convert.link_ctx(ctx_np, "cpu")
    got = call_prologue(libs["engine_round"], n, ops, ctx)
    want = ter.round_prologue_plain(n, ops, ctx)
    same(got[:7], want[:7], f"p={p} k={k} {case}")
    assert bool(got.fast) == (case in ("none", "read", "empty"))


@pytest.mark.parametrize("spectrum", ["none", "read", "low"])
@pytest.mark.parametrize("k", [1, 3, 4, 20])
def test_fast_round_matches_plain(libs, k, spectrum):
    """The fast round on 200 lanes (seven warps, the last partial): a
    collision-free batch of all seven kinds or a read-only one with
    duplicate slots, IDLE lanes and three dead slots, links of every sort;
    table, values, success, links and okw bit for bit.  With the predicate
    False (a colliding batch with writes), both leave the table and every
    output alone."""
    n, p = 256, 200
    data, ver, ops_np, ctx_np = round_case(k + len(spectrum), n, k, p,
                                           spectrum)
    ops_np[0][:3] = tengine.IDLE         # dead slots on IDLE lanes: the
    ops_np[1][:3] = [-1, n, n + 5]       # predicate holds
    ops = convert.op_batch(ops_np, "cpu")
    ctx = convert.link_ctx(ctx_np, "cpu")
    s_slot = ter.sort_slots(n, ops)[0]
    assert bool(ter.fast_flag(n, ops, s_slot)) == (spectrum != "low")
    for fast in ((False,) if spectrum == "low" else (True, False)):
        flag = torch.tensor(fast)
        d, v = words(data), words(ver)
        want = ter.fast_round_plain(flag, d.clone(), v.clone(), ctx, ops,
                                    out_sentinel(p, k))
        got_d, got_v = d.clone(), v.clone()
        got = out_sentinel(p, k)
        call_fast(libs["engine_round"], flag, got_d, got_v, ctx, ops, got)
        want_d, want_v = d.clone(), v.clone()
        ter.fast_round_plain(flag, want_d, want_v, ctx, ops,
                             out_sentinel(p, k))
        same((got_d, got_v, *out_tensors(got)),
             (want_d, want_v, *out_tensors(want)),
             f"k={k} {spectrum} fast={fast}")
        if not fast:
            same((got_d, got_v), (d, v), "not taken")
    assert want.okw.any() or spectrum == "read"


@pytest.mark.parametrize("case", ["slow-low", "slow-hot", "slow-none",
                                  "fast-none", "fast-read"])
@pytest.mark.parametrize("k,p", [(k, p) for k in (1, 4, 20)
                                 for p in (150, 2500)]
                         + [(4, 9000), (3, 3100), (4, 2000), (4, 0)])
def test_round_epilogue_matches_plain(libs, p, k, case):
    """The epilogue after the plain fast or slow round of a batch: on the
    slow branch over contended slots (n / 8 cells; one hot cell; distinct)
    and on the fast branch (distinct slots; read-only duplicates), with
    IDLE lanes and, on the slow branch, two dead slots.  p = 2000 gives
    two tiles of 1024 lanes, which the emulated card holds at once (a
    tile a block, by blockIdx); p = 2500 three, p = 3100 four and p = 9000
    nine, more than it holds (a tile a block, by the block's ticket); the
    tiles meet through the look-back (the last tile writes the stats);
    p = 0 none.
    Lane outputs, stats and the dirty-slot list bit for bit; on the fast
    branch the fast round's outputs are left as they were."""
    branch, spectrum = case.split("-")
    n = 4 * p or 64
    data, ver, ops_np, ctx_np = round_case(p + k + len(case), n, k, p,
                                           spectrum)
    if branch == "slow" and p:
        ops_np[1][:2] = [-2, n + 1]
    ops = convert.op_batch(ops_np, "cpu")
    ctx = convert.link_ctx(ctx_np, "cpu")
    fast = torch.tensor(branch == "fast")
    d, v = words(data), words(ver)
    s_slot, order = ter.sort_slots(n, ops)
    s_kind = ops.kind[order]
    assert bool(ter.fast_flag(n, ops, s_slot)) == (branch == "fast" or p == 0)
    out = out_sentinel(p, k)
    ter.fast_round_plain(fast, d, v, ctx, ops, out)
    _, _, val_s, verpt_s, succ_s = ter.slow_round_plain(
        d, v, s_slot, s_kind, tengine.poisoned_link_ver(ctx, ops.slot)[order],
        ops.expected[order], ops.desired[order], fast=fast)
    want = ter.RoundOut(*(x.clone() for x in out[:2]),
                        tengine.LinkCtx(*(x.clone() for x in out.ctx)),
                        *(x.clone() for x in out[3:]))
    got = ter.RoundOut(*(x.clone() for x in out[:2]),
                       tengine.LinkCtx(*(x.clone() for x in out.ctx)),
                       *(x.clone() for x in out[3:]))
    ter.round_epilogue_plain(fast, n, ctx, order, s_slot, s_kind, val_s,
                             verpt_s, succ_s, v, want)
    lib = libs["engine_round"]
    scratch = torch.zeros(lib.round_scratch(p), dtype=torch.int32)
    call_epilogue(lib, fast, n, ctx, order, s_slot, s_kind, val_s, verpt_s,
                  succ_s, v, got, scratch)
    same(out_tensors(got), out_tensors(want), f"p={p} k={k} {case}")
    if branch == "fast":
        same(out_tensors(got)[:7], out_tensors(out)[:7], "fast lanes")
    assert int(want.stats[5]) > 0 or spectrum == "read" or p == 0


# ---------------------------------------------------------------------------
# The prologue's sort, and the round's four kernels together.
# ---------------------------------------------------------------------------

SORT_SPECTRA = ["uniform", "zipf", "all_same", "all_idle", "out_of_range",
                "int32"]


def sort_batch(rng, n, p, spectrum):
    """(kind, slot) of p lanes: uniform slots in [0, n), Zipf 0.99 slots,
    one slot, every lane IDLE, active lanes on negative slots and slots
    >= n among uniform ones, or any int32; a quarter of the lanes IDLE
    (but all_idle: all)."""
    kind = rng.integers(0, 7, p).astype(np.int32)
    kind[rng.random(p) < 0.25] = tengine.IDLE
    if spectrum == "zipf":
        slot = (rng.zipf(1.01, p) - 1) % n
    elif spectrum == "all_same":
        slot = np.full(p, rng.integers(0, n))
    elif spectrum == "int32":
        slot = rng.integers(-2 ** 31, 2 ** 31, p)
    else:
        slot = rng.integers(0, n, p)
    if spectrum == "all_idle":
        kind[:] = tengine.IDLE
    if spectrum == "out_of_range":
        bad = rng.random(p) < 0.2
        slot[bad] = rng.choice(np.array([-1, -2 ** 31, n, n + 1,
                                         2 ** 31 - 1]), int(bad.sum()))
        kind[bad] = rng.integers(0, 7, int(bad.sum()))
    return kind, slot.astype(np.int32)


def sorted_by_kernel(lib, n, kind, slot, k=1):
    """The prologue's (order, s_slot, varying-digit mask) for the batch."""
    p = len(kind)
    rng = np.random.default_rng(p)
    ops = convert.op_batch((kind, slot, rng.integers(0, 2 ** 32, (p, k),
                                                     dtype=np.uint32),
                            np.zeros((p, k), np.uint32)), "cpu")
    ctx = convert.link_ctx((slot, np.zeros(p, np.uint32),
                            np.zeros((p, k), np.uint32), np.ones(p, bool)),
                           "cpu")
    got = call_prologue(lib, n, ops, ctx)
    want = ter.sort_slots(n, ops)
    return got, want, int(got.scratch[1]) if p else 0


@pytest.mark.parametrize("spectrum", SORT_SPECTRA)
@pytest.mark.parametrize("p", [1, 700, 2500])
def test_sort_matches_torch_sort(libs, p, spectrum):
    """The prologue's radix sort against `torch.sort(stable=True)` of the
    same keys (`sort_slots`), order and sorted slots bit for bit: one lane,
    under one tile of 1024, and 2.4 tiles (not a multiple of the tile; the
    two blocks the emulated card holds take turns over them); slots
    uniform, Zipf 0.99, all the same, all lanes IDLE,
    active lanes outside [0, n) (negative, n and beyond, the int32
    extremes), and any int32 (every digit varies)."""
    n = 5000
    rng = np.random.default_rng(p * 7 + SORT_SPECTRA.index(spectrum))
    got, want, _ = sorted_by_kernel(libs["engine_round"], n,
                                    *sort_batch(rng, n, p, spectrum))
    same((got.s_slot, got.order), want, f"p={p} {spectrum}")


@pytest.mark.parametrize("spectrum,n,passes", [
    ("uniform", 2 ** 22, 3), ("zipf", 2 ** 22, 3), ("all_same", 2 ** 22, 0),
    ("all_idle", 2 ** 22, 0), ("uniform", 200, 1), ("int32", 2 ** 22, 4)])
def test_sort_skips_the_digits_no_key_varies_in(libs, spectrum, n, passes):
    """The passes the sort runs, from the mask of varying digits it leaves
    in the scratch: at n = 2^22 the keys take 23 bits and the top digit is
    the same in every key, so three passes sort; one slot or all lanes
    IDLE, none (the lanes stay in order); slots below 200, one; any int32,
    all four.  No lane is IDLE but in all_idle.  The order equals
    `torch.sort`'s each time."""
    rng = np.random.default_rng(n + passes)
    kind, slot = sort_batch(rng, n, 1200, spectrum)
    if spectrum != "all_idle":
        kind[kind == tengine.IDLE] = tengine.LOAD
    got, want, mask = sorted_by_kernel(libs["engine_round"], n, kind, slot)
    same((got.s_slot, got.order), want, f"n={n} {spectrum}")
    assert bin(mask).count("1") == passes, mask


@pytest.mark.parametrize("spectrum", ["none", "read", "low", "hot"])
@pytest.mark.parametrize("k,p", [(4, 150), (1, 1100), (3, 2200)])
def test_kernel_round_matches_plain_round(libs, p, k, spectrum):
    """The round's four kernels one after another, as `make_round` runs
    them, the epilogue on the scratch the prologue left (filled with
    garbage before it): table, lane outputs, links, stats and dirty list
    equal the plain round's (`make_round(mode="xla")`) bit for bit, on
    both branches."""
    lib = libs["engine_round"]
    n = 4 * p
    data, ver, ops_np, ctx_np = round_case(3 * p + k, n, k, p, spectrum)
    ops = convert.op_batch(ops_np, "cpu")
    ctx = convert.link_ctx(ctx_np, "cpu")
    d, v = words(data), words(ver)
    want = ter.make_round(n, k, mode="xla")(d.clone(), v.clone(), ctx, ops)
    got_d, got_v = d.clone(), v.clone()
    pro = call_prologue(lib, n, ops, ctx)
    out = out_sentinel(p, k)
    call_fast(lib, pro.fast, got_d, got_v, ctx, ops, out)
    val = torch.empty((p, k), dtype=torch.int32)
    verpt = torch.empty((p,), dtype=torch.int32)
    succ = torch.empty((p,), dtype=torch.int32)
    assert lib.slow_round(
        pro.fast.data_ptr(), got_d.data_ptr(), got_v.data_ptr(), n, k,
        *(x.data_ptr() for x in pro[2:7]), p, val.data_ptr(),
        verpt.data_ptr(), succ.data_ptr(), 0, None) == 0
    call_epilogue(lib, pro.fast, n, ctx, pro.order, pro.s_slot, pro.s_kind,
                  val, verpt, succ, got_v, out, pro.scratch)
    got = (got_d, got_v, *out.ctx, out.value, out.success,
           *(out.stats[i] for i in range(6)), out.dirty)
    same(got, [x for part in want for x in
               (part if isinstance(part, tuple) else (part,))],
         f"p={p} k={k} {spectrum}")
    assert bool(pro.fast) == (spectrum in ("none", "read"))


# ---------------------------------------------------------------------------
# The one-round table kernels: the SC and STORE/CAS commit rounds, the
# CacheHash probe and find.
# ---------------------------------------------------------------------------

ROUND_KS = [1, 3, 4, 5, 16, 17, 20]        # 17, 20: rows past 16 words
# the widths bench_atomics.py sweeps (1, 2, 4, 8, 16) and three others
GATHER_KS = [1, 2, 3, 4, 5, 8, 16, 20]
# (kw, vw): the shapes the CacheHash kernel is instantiated for, then two
# it runs at run-time widths
HASH_SHAPES = [(1, 1), (2, 2), (4, 2), (1, 3), (3, 1), (2, 0)]
FULL, NEXT_END = ref.FULL, np.uint32(2 ** 32 - 1)


def commit_table(rng, n, k):
    """data[n + 1, k] and meta[n + 1, 2]: even versions, a quarter odd
    (locked), a quarter of the rows marked, versions about to wrap."""
    data = rng.integers(0, 2 ** 32, (n + 1, k), dtype=np.uint32)
    meta = np.stack([rng.integers(0, 2 ** 31, n + 1) * 2
                     + (rng.random(n + 1) < 0.25),
                     rng.random(n + 1) < 0.25], 1).astype(np.uint32)
    meta[rng.random(n + 1) < 0.2, 0] = 2 ** 32 - 2
    return data, meta


def commit_lanes(rng, n, p):
    """Distinct live slots for most lanes, the dummy row n for some, and
    slots out of range (-1, n + 1, the int32 extremes)."""
    slot = np.full(p, n, np.int32)
    live = rng.random(p) < 0.8
    slot[live] = rng.choice(n, int(live.sum()), replace=False)
    bad = np.flatnonzero(~live)[:4]
    slot[bad] = [-1, n + 1, -2 ** 31, 2 ** 31 - 1][:len(bad)]
    return slot


@pytest.mark.parametrize("round_kind", ["llsc_commit_round",
                                        "cas_apply_round"])
@pytest.mark.parametrize("k", ROUND_KS)
def test_commit_round_matches_plain(libs, k, round_kind):
    """The SC round and one STORE/CAS round over 300 lanes (the last
    block partial): live lanes on distinct rows, locked and marked ones
    among them, dead lanes on the dummy row and outside [0, n + 1),
    versions that wrap; half the links or comparands current.  Table,
    meta, success and witness bit for bit against the plain round, on the
    16-byte path (k % 4 == 0) and the word path, rows past the 16 words a
    lane holds included."""
    n, p = 400, 300
    rng = np.random.default_rng(k * 7 + len(round_kind))
    data, meta = commit_table(rng, n, k)
    slot = commit_lanes(rng, n, p)
    cur = np.clip(slot, 0, n)
    desired = rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32)
    if round_kind == "llsc_commit_round":
        flag = (rng.random(p) < 0.85).astype(np.int32)
        operand = np.where(rng.random(p) < 0.5, meta[cur, 0],
                           meta[cur, 0] + np.uint32(2)).astype(np.uint32)
        plain = ref.llsc_commit_round_ref
    else:
        flag = rng.choice(np.array([0, ref.STORE, ref.CAS, 5], np.int32), p,
                          p=[0.1, 0.3, 0.5, 0.1])
        operand = rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32)
        take = rng.random(p) < 0.5
        operand[take] = data[cur[take]]
        plain = ref.cas_apply_round_ref
    flag[slot == n] = 0               # the dummy row's lanes only read it
    args = (ints(slot), ints(flag), words(operand), words(desired))
    d, m = words(data), words(meta)
    want = plain(d.clone(), m.clone(), *args)
    got_d, got_m = d.clone(), m.clone()
    succ = torch.full((p, 1), 7, dtype=torch.int32)
    wit = torch.full((p, k), 7, dtype=torch.int32)
    assert getattr(libs["table_ops"], round_kind)(
        got_d.data_ptr(), got_m.data_ptr(), n + 1, k,
        *(a.data_ptr() for a in args), p, succ.data_ptr(), wit.data_ptr(),
        0, None) == 0
    same((got_d, got_m, succ, wit), want, f"{round_kind} k={k}")
    assert want[2].any() and not want[2].all()
    assert (want[1][:, 0] == 0).any()                   # a version wrapped


def placed(t, off):
    """A copy of t in fresh memory, `off` words past a 64-byte boundary."""
    buf = torch.empty(t.numel() + 16, dtype=t.dtype)
    assert buf.data_ptr() % 64 == 0
    out = buf[off:off + t.numel()].view(t.shape)
    out.copy_(t)
    return out


GATHER_OFFSETS = ["none", "data", "vals", "meta"]


@pytest.mark.parametrize("offset", GATHER_OFFSETS)
@pytest.mark.parametrize("k", GATHER_KS)
def test_seqlock_gather_matches_plain(libs, k, offset):
    """The gather over 300 lanes (the last block partial): locked, marked
    and wrapping rows, dead lanes at -1, n and n + 7; values and ok bit for
    bit against the plain gather.  With every operand aligned it reads
    16-byte row vectors where k % 4 == 0; data or vals one word off
    (`offset`) makes it read the row word by word.  (A 16-byte access
    that is not aligned faults on the card, not here: `chip_smoke.py`
    runs the word path on shifted tables there.)"""
    q = 300
    rng = np.random.default_rng(k * 13 + GATHER_OFFSETS.index(offset))
    data, meta = commit_table(rng, 400, k)
    n = data.shape[0]
    idx = rng.integers(0, n, q).astype(np.int32)
    idx[[0, 150, 299]] = [-1, n, n + 7]
    d, m, ix = words(data), words(meta), ints(idx)
    want = ref.seqlock_gather_ref(d, m, ix)
    vals, ok = (torch.full((q, k), 7, dtype=torch.int32),
                torch.full((q, 1), 7, dtype=torch.int32))
    d, m, vals = (placed(t, int(offset == name)) for t, name in
                  ((d, "data"), (m, "meta"), (vals, "vals")))
    assert libs["table_ops"].seqlock_gather(
        d.data_ptr(), m.data_ptr(), n, k, ix.data_ptr(), q, vals.data_ptr(),
        ok.data_ptr(), 0, None) == 0
    same((vals, ok), want, f"k={k} offset={offset}")
    assert want[1].any() and not want[1][1:150].all()


@pytest.mark.parametrize("kw,vw", HASH_SHAPES)
def test_cachehash_probe_matches_plain(libs, kw, vw):
    """The bare probe over 300 queries: full rows with a terminated or
    chained next, empty rows with flags 0 or 2, half the queries carrying
    their bucket's key, dead lanes at buckets -1, m, m + 5 and the int32
    extremes; hit, empty, value and next bit for bit."""
    m, q = 257, 300
    rng = np.random.default_rng(kw * 10 + vw)
    cw = kw + vw + 3
    cells = rng.integers(0, 2 ** 32, (m, cw), dtype=np.uint32)
    cells[:, kw + vw] = np.where(rng.random(m) < 0.5, NEXT_END,
                                 rng.integers(0, 64, m))
    cells[:, kw + vw + 1] = np.where(rng.random(m) < 0.6, FULL,
                                     rng.choice([0, 2], m))
    bidx = rng.integers(0, m, q).astype(np.int32)
    bidx[:5] = [-1, m, m + 5, -2 ** 31, 2 ** 31 - 1]
    keys = rng.integers(0, 2 ** 32, (q, kw), dtype=np.uint32)
    take = rng.random(q) < 0.5
    keys[take] = cells[np.clip(bidx[take], 0, m - 1), :kw]
    args = (words(cells), ints(bidx), words(keys))
    want = ref.cachehash_probe_ref(*args, kw=kw, vw=vw)
    got = [torch.full(x.shape, 7, dtype=torch.int32) for x in want]
    assert libs["table_ops"].cachehash_probe(
        args[0].data_ptr(), m, cw, args[1].data_ptr(), args[2].data_ptr(), q,
        kw, vw, *(x.data_ptr() for x in got), 0, None) == 0
    same(got, want, f"kw={kw} vw={vw}")
    assert want[0].any() and not want[0].all()


def bucket_of(keys, m):
    """Each key's bucket by `ref.hash_keys` (held to the reference's hash in
    tests/test_torch_kernels.py)."""
    return ref.hash_keys(words(keys), m).numpy()


def find_case(rng, m, kw, vw, q, shape):
    """A CacheHash table and q queries: the queries' keys placed by the
    hash inline or at chain depths 1 to 11 in front of their bucket's
    chain (so chains run from 0 to 20 nodes deep), some left out; rows
    empty with flags 0 or 2.  `shape`: "plain"; "clamp" (some nexts past
    the pool's end, one of them in front of the pool's last node, which
    holds query 0's key); "cycle" (some chains loop back to their first
    node)."""
    cw = kw + vw + 3
    cells = rng.integers(0, 2 ** 32, (m, cw), dtype=np.uint32)
    cells[:, kw + vw] = NEXT_END
    cells[:, kw + vw + 1] = np.where(rng.random(m) < 0.85, FULL,
                                     rng.choice([0, 2], m))
    keys = rng.integers(0, 2 ** 32, (q, kw), dtype=np.uint32)
    bucket = bucket_of(keys, m)
    pool = []

    def node(key, nxt):
        row = rng.integers(0, 2 ** 32, cw, dtype=np.uint32)
        row[:kw], row[kw + vw] = key, nxt
        pool.append(row)
        return len(pool) - 1

    first = {}                               # bucket -> its chain's head
    for i in range(q):
        depth, b = int(rng.integers(-1, 12)), bucket[i]
        if depth == 0:
            cells[b, :kw], cells[b, kw + vw + 1] = keys[i], FULL
        elif depth > 0:
            nxt = node(keys[i], cells[b, kw + vw])
            for _ in range(depth - 1):
                nxt = node(rng.integers(0, 2 ** 32, kw, dtype=np.uint32), nxt)
            cells[b, kw + vw] = nxt
            first.setdefault(b, nxt)
    if shape == "clamp":                 # query 0's key: past the end
        b = bucket[0]
        cells[b, kw + vw + 1] = FULL
        cells[b, :kw] = ~keys[0]
        cells[b, kw + vw] = node(~keys[0], len(pool) + 6)
        node(keys[0], NEXT_END)
    pool = np.array(pool, np.uint32).reshape(-1, cw)
    c = len(pool)
    if shape == "clamp":
        ends = np.flatnonzero(pool[:, kw + vw] == NEXT_END)
        pick = ends[rng.random(len(ends)) < 0.5]
        pool[pick, kw + vw] = rng.choice(np.array([c, c + 7, 2 ** 31 - 1],
                                                  np.uint32), len(pick))
    if shape == "cycle":
        for b, head in first.items():
            tail = head
            while pool[tail, kw + vw] != NEXT_END:
                tail = int(pool[tail, kw + vw])
            if rng.random() < 0.5:
                pool[tail, kw + vw] = head
    return cells, pool, keys


def call_find(lib, cells, pool, keys, kw, vw, max_chain):
    q = keys.shape[0]
    found = torch.ones((q,), dtype=torch.bool)
    value = torch.full((q, vw), 7, dtype=torch.int32)
    err = lib.cachehash_find(
        cells.data_ptr(), cells.shape[0], cells.shape[1], pool.data_ptr(),
        pool.shape[0], keys.data_ptr(), q, kw, vw, max_chain,
        found.data_ptr(), value.data_ptr(), 0, None)
    return err, (found, value)


@pytest.mark.parametrize("shape", ["plain", "clamp", "cycle"])
@pytest.mark.parametrize("kw,vw", HASH_SHAPES)
def test_cachehash_find_matches_plain(libs, kw, vw, shape):
    """The find kernel against `ref.cachehash_find_ref` over 300 queries
    in m = 97 buckets (not a power of two: the hash's `% m` unsigned):
    inline hits, chain hits at depths 1 to 11, keys left out, buckets
    whose chain ends past the pool (the clamp) or loops back on itself;
    max_chain = 8, 3 (chain hits deeper than it missed), 0 (the probe
    alone) and 40 (every cycle walked until max_chain runs out).  found
    and value bit for bit."""
    m, q = 97, 300
    rng = np.random.default_rng(kw * 100 + vw * 10 + len(shape))
    cells, pool, keys = map(words, find_case(rng, m, kw, vw, q, shape))
    hits = {}
    for max_chain in (8, 3, 0, 40):
        want = ref.cachehash_find_ref(cells, pool, keys, kw=kw, vw=vw,
                                      max_chain=max_chain)
        err, got = call_find(libs["table_ops"], cells, pool, keys, kw, vw,
                             max_chain)
        assert err == 0
        same(got, want, f"kw={kw} vw={vw} {shape} max_chain={max_chain}")
        hits[max_chain] = int(want[0].sum())
    assert 0 < hits[0] < hits[3] < hits[8] <= hits[40] < q, hits


def test_cachehash_find_edges(libs):
    """A large table (m = 2^20 + 7: buckets past 2^19, the hash's top bits
    in play), no query, and an empty pool: with max_chain = 0 it equals
    the plain version, with max_chain > 0 the entry point refuses it
    (cudaErrorInvalidValue) where the plain version raises, as it does
    for an empty table."""
    rng = np.random.default_rng(31)
    lib = libs["table_ops"]
    m, kw, vw = 2 ** 20 + 7, 2, 2
    keys = rng.integers(0, 2 ** 32, (260, kw), dtype=np.uint32)
    cells = np.zeros((m, kw + vw + 3), np.uint32)
    bucket = bucket_of(keys, m)
    cells[bucket[::2], :kw] = keys[::2]
    cells[bucket[::2], kw + vw + 1] = FULL
    cells[bucket, kw:kw + vw] = rng.integers(0, 2 ** 32, (260, vw),
                                             dtype=np.uint32)
    cells[:, kw + vw] = NEXT_END
    cells, keys = words(cells), words(keys)
    pool = words(np.zeros((0, kw + vw + 3), np.uint32))
    want = ref.cachehash_find_ref(cells, pool, keys, kw=kw, vw=vw,
                                  max_chain=0)
    err, got = call_find(lib, cells, pool, keys, kw, vw, 0)
    assert err == 0 and int(want[0].sum()) == 130
    same(got, want, "m = 2^20 + 7")
    assert call_find(lib, cells, pool, keys[:0], kw, vw, 8)[0] == 0
    with pytest.raises(IndexError):
        ref.cachehash_find_ref(cells, pool, keys, kw=kw, vw=vw, max_chain=8)
    assert call_find(lib, cells, pool, keys, kw, vw, 8)[0] != 0
    empty = cells[:0]
    with pytest.raises(RuntimeError, match="ZeroDivision"):
        ref.cachehash_find_ref(empty, cells, keys, kw=kw, vw=vw)
    assert call_find(lib, empty, cells, keys, kw, vw, 8)[0] != 0

