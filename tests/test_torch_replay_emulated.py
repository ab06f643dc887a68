"""The segment-replay kernels (`kernels/csrc/segment_replay.cuh`, behind
`slow_round` in `engine_round.cu` and `cas_apply_rounds` in `table_ops.cu`)
compiled for the CPU and held bit for bit against their plain versions.

There is no CUDA compiler or card here, so `tests/cuda_emu/cuda_runtime.h`
stands in for the CUDA runtime: each warp runs as 32 threads that meet at
every shuffle and ballot.  g++ compiles the two sources as they are, apart
from their `kernel<<<...>>>(args)` launches, which become calls of the
emulator, and the tests call the C entry points with CPU tensors.  This
checks the kernels' logic: windows and segment ownership, the write-mask
fixed point, the row carried across chunks, dead lanes, the thread per
segment at other widths.  Their speed, and what nvcc makes of them, only a
card can show (`chip_smoke.py`).  Tolerance is zero."""

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
        got_d.data_ptr(), got_v.data_ptr(), n, k, *(a.data_ptr()
                                                    for a in args),
        p, val.data_ptr(), verpt.data_ptr(), succ.data_ptr(), 0, None) == 0
    same((got_d, got_v, val, verpt, succ), want, f"k={k} {spectrum}")


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
