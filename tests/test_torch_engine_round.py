"""The port's fused engine round (`repro_torch.kernels.engine_round`) against
the JAX reference: both tiers and `off` against JAX `engine.linearize` over
the three collision spectra, the plain fast/slow rounds against the Pallas
kernels run in interpret mode (one subprocess), the fast-path predicate's
false-positive safety, ctx truncation and the wrappers' dispatch rules.
Tolerance is zero: words compare as uint32 bit patterns."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import _np_fast_path_ok
from repro.core import engine as jengine
from repro_torch import atomics as tatomics
from repro_torch import convert
from repro_torch.core import engine as tengine
from repro_torch.kernels import _build
from repro_torch.kernels import engine_round as ter

SPECTRA = ["none", "low", "all_same"]
ALL_KINDS = [0, 1, 2, 3, 4, 5, 6]
READ_KINDS = [tengine.LOAD, tengine.IDLE, tengine.LL, tengine.VALIDATE]
ROOT = Path(__file__).resolve().parents[1]
NAMES = ["data", "version", "ctx.slot", "ctx.version", "ctx.value",
         "ctx.linked", "res.value", "res.success", "rounds", "n_updates",
         "n_loads", "n_cas_fail", "n_raced_loads", "n_dirty_cells"]


def make_table(n, k, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 2 ** 32, (n, k), dtype=np.uint32)
    ver = (rng.integers(0, 8, n) * 2).astype(np.uint32)
    return data, ver


def make_batch(rng, n, k, p, spectrum, kinds=ALL_KINDS, data=None, ver=None):
    """A mixed batch + a LinkCtx with live/stale/mismatched links (numpy
    tuples in the reference's field order)."""
    kind = rng.choice(np.asarray(kinds), p).astype(np.int32)
    if spectrum == "none":
        slots = rng.choice(n, p, replace=False).astype(np.int32)
    elif spectrum == "low":
        slots = rng.integers(0, max(n // 8, 2), p).astype(np.int32)
    else:
        slots = np.full(p, rng.integers(0, n), np.int32)
    expected = rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32)
    if data is not None:                    # let ~half the CASes succeed
        take = rng.random(p) < 0.5
        expected[take] = data[slots[take]]
    desired = rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32)
    cslot = np.where(rng.random(p) < 0.7, slots,
                     rng.integers(-1, n, p)).astype(np.int32)
    vnow = ver[np.clip(cslot, 0, n - 1)]
    cver = np.where(rng.random(p) < 0.8, vnow, vnow + 2).astype(np.uint32)
    ctx = (cslot, cver, rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32),
           rng.random(p) < 0.8)
    return (kind, slots, expected, desired), ctx


def jax_linearize(data, ver, ctx, ops):
    out = jengine.linearize(
        jnp.asarray(data), jnp.asarray(ver),
        jengine.LinkCtx(*map(jnp.asarray, ctx)),
        jengine.OpBatch(*map(jnp.asarray, ops)))
    d, v, c, r, s = out
    return [np.asarray(d), np.asarray(v), *map(np.asarray, c),
            *map(np.asarray, r), *map(np.asarray, s)]


def port_round(round_fn, data, ver, ctx, ops):
    d, v, c, r, s = round_fn(
        convert.tensor(data, "cpu", word=True),
        convert.tensor(ver, "cpu", word=True),
        convert.link_ctx(ctx, "cpu"), convert.op_batch(ops, "cpu"))
    return [convert.array(d, word=True), convert.array(v, word=True),
            *convert.to_numpy(c), *convert.to_numpy(r), *convert.to_numpy(s)]


def assert_same(ref, out, label):
    assert len(ref) == len(out)
    for name, a, b in zip(NAMES, ref, out):
        np.testing.assert_array_equal(
            a, b, err_msg=f"{label}: port diverges from linearize on {name}")


# ---------------------------------------------------------------------------
# Round vs JAX linearize: bit-identical on every in-contract batch.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["xla", "pallas", "off"])
@pytest.mark.parametrize("spectrum", SPECTRA)
def test_round_matches_jax_linearize(mode, spectrum):
    n, k, p = 32, 4, 24
    rng = np.random.default_rng(SPECTRA.index(spectrum) * 10 + len(mode))
    data, ver = make_table(n, k)
    round_fn = ter.make_round(n, k, mode=mode)
    for trial in range(3):
        ops, ctx = make_batch(rng, n, k, p, spectrum, data=data, ver=ver)
        ref = jax_linearize(data, ver, ctx, ops)
        assert_same(ref, port_round(round_fn, data, ver, ctx, ops),
                    f"{mode}/{spectrum}/trial{trial}")
        data, ver = ref[0], ref[1]          # chain batches across state


@pytest.mark.parametrize("mode", ["xla", "pallas"])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_round_matches_jax_linearize_odd_width(mode, k):
    n, p = 16, 11
    rng = np.random.default_rng(k)
    data, ver = make_table(n, k, seed=k)
    round_fn = ter.make_round(n, k, mode=mode)
    for spectrum in SPECTRA:
        ops, ctx = make_batch(rng, n, k, p, spectrum, data=data, ver=ver)
        assert_same(jax_linearize(data, ver, ctx, ops),
                    port_round(round_fn, data, ver, ctx, ops),
                    f"{mode}/k={k}/{spectrum}")


@pytest.mark.parametrize("mode", ["xla", "pallas"])
def test_read_only_collisions_take_fast_path_and_match(mode):
    n, k, p = 8, 2, 10
    rng = np.random.default_rng(3)
    data, ver = make_table(n, k, seed=3)
    ops, ctx = make_batch(rng, n, k, p, "all_same", kinds=READ_KINDS,
                          data=data, ver=ver)
    assert bool(ter.fast_path_ok(n, convert.op_batch(ops, "cpu")))
    assert_same(jax_linearize(data, ver, ctx, ops),
                port_round(ter.make_round(n, k, mode=mode), data, ver, ctx,
                           ops), mode)


@pytest.mark.parametrize("mode", ["xla", "pallas"])
def test_ctx_wider_than_batch_is_truncated(mode):
    """linearize reads the first p lanes of a wider ctx and returns a
    batch-width ctx; both tiers must do the same."""
    n, k, p = 16, 2, 6
    rng = np.random.default_rng(17)
    data, ver = make_table(n, k, seed=17)
    for spectrum in ("none", "low"):
        ops, _ = make_batch(rng, n, k, p, spectrum, data=data, ver=ver)
        _, wide = make_batch(rng, n, k, p + 5, "low", data=data, ver=ver)
        ref = jax_linearize(data, ver, wide, ops)
        out = port_round(ter.make_round(n, k, mode=mode), data, ver, wide,
                         ops)
        assert out[2].shape == (p,)
        assert_same(ref, out, f"{mode}/{spectrum}/wide ctx")


# ---------------------------------------------------------------------------
# The plain rounds against the Pallas kernels themselves (interpret mode).
# ---------------------------------------------------------------------------

_PALLAS_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    from jax.experimental.pallas import tpu as pltpu
    if not hasattr(pltpu, "TPUMemorySpace"):   # renamed in newer jax
        pltpu.TPUMemorySpace = pltpu.MemorySpace
    import jax.numpy as jnp
    from repro.kernels import engine_round as er

    cases = np.load(sys.argv[1])
    out = {}
    for name in sorted({key.split("/")[0] for key in cases.files}):
        a = [jnp.asarray(cases[f"{name}/{f}"]) for f in
             ("data", "version", "slot", "kind", "link_ver", "expected",
              "desired")]
        fn = er.fast_round_pallas if name.startswith("fast") \\
            else er.slow_round_pallas
        for i, x in enumerate(fn(*a, interpret=True)):
            out[f"{name}/{i}"] = np.asarray(x)
    np.savez(sys.argv[2], **out)
""")


def _pallas_cases():
    """Seeded round inputs in the kernels' contract: fast cases are
    collision-free or read-only, slow cases sorted by (slot, lane)."""
    cases = {}
    for ci, (k, spectrum) in enumerate([(4, "none"), (4, "low"),
                                        (4, "all_same"), (3, "low"),
                                        (1, "none"), (5, "all_same")]):
        n, p = 32, 19
        rng = np.random.default_rng(100 + ci)
        data, ver = make_table(n, k, seed=ci)
        kinds = ALL_KINDS if spectrum == "none" else READ_KINDS
        for tier in ("fast", "slow"):
            ops, ctx = make_batch(rng, n, k, p, spectrum,
                                  kinds=kinds if tier == "fast" else ALL_KINDS,
                                  data=data, ver=ver)
            kind, slot, expected, desired = ops
            slot = np.where(kind != tengine.IDLE, slot, n).astype(np.int32)
            link_ok = ctx[3] & (ctx[0] == ops[1])
            link_ver = np.where(link_ok, ctx[1], 1).astype(np.uint32)
            if tier == "slow":
                if ci == 1:                  # out-of-contract negative slots
                    slot[:2] = [-1, -3]
                order = np.argsort(slot, kind="stable")
                kind, slot, link_ver = kind[order], slot[order], \
                    link_ver[order]
                expected, desired = expected[order], desired[order]
            name = f"{tier}{ci}"
            for f, x in (("data", data), ("version", ver), ("slot", slot),
                         ("kind", kind), ("link_ver", link_ver),
                         ("expected", expected), ("desired", desired)):
                cases[f"{name}/{f}"] = x
    return cases


def test_plain_rounds_match_pallas_kernels_interpret(tmp_path):
    """One subprocess installs the jax alias the reference needs, runs
    `fast_round_pallas` / `slow_round_pallas` with interpret=True on seeded
    inputs, and the plain rounds (via the wrappers, which pick the plain
    version for CPU tensors) must reproduce every output bit for bit."""
    cases = _pallas_cases()
    np.savez(tmp_path / "in.npz", **cases)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _PALLAS_SCRIPT, str(tmp_path / "in.npz"),
         str(tmp_path / "out.npz")],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = np.load(tmp_path / "out.npz")
    names = sorted({key.split("/")[0] for key in cases})
    assert len(names) == 12
    launches = (ter.fast_round.launches, ter.slow_round.launches)
    for name in names:
        fn = ter.fast_round if name.startswith("fast") else ter.slow_round
        args = [convert.tensor(cases[f"{name}/{f}"], "cpu",
                               word=f in ("data", "version", "link_ver",
                                          "expected", "desired"))
                for f in ("data", "version", "slot", "kind", "link_ver",
                          "expected", "desired")]
        out = fn(*args)
        for i, x in enumerate(out):
            got = convert.array(x, word=i != 4)
            want = ref[f"{name}/{i}"]
            np.testing.assert_array_equal(
                got, want.view(np.uint32) if i != 4 else want,
                err_msg=f"{name}: output {i} differs from the Pallas kernel")
    # CPU tensors never launch a kernel.
    assert (ter.fast_round.launches, ter.slow_round.launches) == launches


def _long_segment_case(k, p=230, n=24, seed=0):
    """One cell segment of p - 12 lanes (all seven kinds; a share of CAS
    lanes expecting the row the lane before wrote, of links a later
    version) between a few lanes on other cells, two dead slots and IDLE
    lanes on n: the sorted inputs of the slow kernel."""
    rng = np.random.default_rng(seed)
    data, ver = make_table(n, k, seed=seed)
    kind = rng.choice(np.asarray(ALL_KINDS), p).astype(np.int32)
    slot = np.full(p, 7, np.int32)
    slot[:6] = [-2, -1, 1, 3, 3, 5]
    slot[-6:] = [9, 9, 12, 20, 23, 23]
    slot = np.where(kind != tengine.IDLE, slot, n)
    order = np.argsort(slot, kind="stable")
    kind, slot = kind[order], slot[order]
    expected = rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32)
    desired = rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32)
    take = rng.random(p) < 0.3
    expected[take] = data[np.clip(slot[take], 0, n - 1)]
    chain = np.flatnonzero((rng.random(p - 1) < 0.4)
                           & (slot[1:] == slot[:-1])) + 1
    expected[chain] = desired[chain - 1]
    link_ver = (ver[np.clip(slot, 0, n - 1)]
                + 2 * rng.integers(0, 12, p)).astype(np.uint32)
    link_ver[rng.random(p) < 0.2] = 1                  # poisoned links
    return dict(data=data, version=ver, slot=slot, kind=kind,
                link_ver=link_ver, expected=expected, desired=desired)


@pytest.mark.parametrize("k", [3, 4])
def test_slow_round_long_segment_matches_pallas(tmp_path, k):
    """`slow_round` (its plain version on the CPU) on one 218-lane cell
    segment with all seven kinds, chained CAS lanes and links to later
    versions, against `slow_round_pallas` in interpret mode: every output
    and the table, bit for bit; CAS and SC lanes both win and lose."""
    case = _long_segment_case(k, seed=k)
    np.savez(tmp_path / "in.npz", **{f"slow{k}/{f}": x
                                     for f, x in case.items()})
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _PALLAS_SCRIPT, str(tmp_path / "in.npz"),
         str(tmp_path / "out.npz")],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = np.load(tmp_path / "out.npz")
    args = [convert.tensor(case[f], "cpu", word=f not in ("slot", "kind"))
            for f in ("data", "version", "slot", "kind", "link_ver",
                      "expected", "desired")]
    out = ter.slow_round(*args)
    for i, x in enumerate(out):
        want = ref[f"slow{k}/{i}"]
        np.testing.assert_array_equal(
            convert.array(x, word=i != 4), want.view(np.uint32)
            if i != 4 else want, err_msg=f"k={k}: output {i} differs")
    succ = out[4].numpy() != 0
    for kd in (tengine.CAS, tengine.SC):
        lanes = (case["kind"] == kd) & (case["slot"] == 7)
        assert succ[lanes].any() and not succ[lanes].all()


# ---------------------------------------------------------------------------
# The fast-path predicate: false positives are impossible.
# ---------------------------------------------------------------------------

def test_predicate_rejects_colliding_writes_and_out_of_range():
    n, k = 16, 2
    ops = tatomics.make_ops(np.full(8, tatomics.STORE), np.zeros(8), k=k,
                            device="cpu")
    assert not bool(ter.fast_path_ok(n, ops))
    ops = tatomics.make_ops([tatomics.LOAD, tatomics.STORE], [3, n + 2], k=k,
                            device="cpu")
    assert not bool(ter.fast_path_ok(n, ops))
    ops = tatomics.make_ops([tatomics.LOAD, tatomics.STORE, tatomics.SC],
                            [3, 7, 11], k=k, device="cpu")
    assert bool(ter.fast_path_ok(n, ops))


def test_predicate_never_false_positive_property():
    """Random batches: the port's predicate equals the numpy predicate of
    the shared oracle, and whenever it says fast the batch really is
    read-only or duplicate-free among active in-range lanes."""
    n, k, p = 64, 2, 8
    rng = np.random.default_rng(7)
    hits = 0
    for trial in range(200):
        kind = rng.choice(np.asarray(ALL_KINDS), p).astype(np.int32)
        lo, hi = (-2, n + 2) if trial % 2 else (0, n)
        slots = rng.integers(lo, hi, p).astype(np.int32)
        fast = bool(ter.fast_path_ok(
            n, tatomics.make_ops(kind, slots, k=k, device="cpu")))
        assert fast == _np_fast_path_ok(n, kind, slots)
        active = kind != tengine.IDLE
        writes = active & np.isin(kind, [tengine.STORE, tengine.CAS,
                                         tengine.SC])
        asl = slots[active]
        if fast:
            hits += 1
            assert np.all((asl >= 0) & (asl < n)), "fast with out-of-range"
            assert (not writes.any()) or len(np.unique(asl)) == len(asl), \
                "fast path accepted a colliding batch with writes"
    assert hits > 0


def test_path_counts():
    n, k = 8, 2
    ops = tatomics.make_ops([tatomics.LOAD, tatomics.STORE], [1, 2], k=k,
                            device="cpu")
    eligible, taken = ter.path_counts(n, ops, fused=True)
    assert bool(eligible) and bool(taken)
    eligible, taken = ter.path_counts(n, ops, fused=False)
    assert bool(eligible) and not bool(taken)


# ---------------------------------------------------------------------------
# Wrappers, modes and the build.
# ---------------------------------------------------------------------------

def test_slow_round_negative_slot_is_failed_noop():
    n, k = 8, 2
    data, ver = make_table(n, k, seed=21)
    des = np.arange(3 * k, dtype=np.uint32).reshape(3, k) + 1
    slot = np.array([-5, -1, 3], np.int32)                # sorted
    kind = np.array([tengine.LOAD, tengine.STORE, tengine.STORE], np.int32)
    d, v, val, verpt, succ = ter.slow_round(
        convert.tensor(data, "cpu", word=True),
        convert.tensor(ver, "cpu", word=True), torch.from_numpy(slot),
        torch.from_numpy(kind), torch.ones(3, dtype=torch.int32),
        torch.zeros((3, k), dtype=torch.int32),
        convert.tensor(des, "cpu", word=True))
    expect = data.copy()
    expect[3] = des[2]
    np.testing.assert_array_equal(convert.array(d, word=True), expect)
    assert succ.tolist() == [0, 0, 1]
    assert not val[:2].any() and not verpt[:2].any()


def test_modes(monkeypatch):
    monkeypatch.delenv("BIGATOMIC_ENGINE_KERNEL", raising=False)
    assert ter.configured_mode() == "auto"
    assert ter.resolved_mode() == "pallas"
    for mode in ("pallas", "xla", "off"):
        monkeypatch.setenv("BIGATOMIC_ENGINE_KERNEL", mode)
        assert ter.resolved_mode() == mode
    spec = tatomics.AtomicSpec(8, 2, "cached_me", p_max=4)
    assert tengine.round_for(spec) is tengine.linearize
    monkeypatch.setenv("BIGATOMIC_ENGINE_KERNEL", "bogus")
    with pytest.raises(ValueError):
        ter.configured_mode()


def test_builtin_strategies_lower_their_round():
    for name in ("seqlock", "indirect", "cached_wf", "cached_me"):
        impl = tatomics.get_strategy(name)
        fn = impl.lower_round(tatomics.AtomicSpec(8, 2, name), mode="xla")
        assert callable(fn) and fn is not tengine.linearize
    for name in ("plain", "simplock"):
        impl = tatomics.get_strategy(name)
        assert impl.lower_round(tatomics.AtomicSpec(8, 2, name),
                                mode="pallas") is None


def test_wrappers_reject_other_devices_and_missing_nvcc(monkeypatch,
                                                       tmp_path):
    meta = torch.zeros((4, 2), dtype=torch.int32, device="meta")
    lane = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        ter.fast_round(meta, lane[:1].expand(4), lane, lane, lane,
                       meta[:2], meta[:2])
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()
