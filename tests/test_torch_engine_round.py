"""The port's fused engine round (`repro_torch.kernels.engine_round`) against
the JAX reference: both tiers and `off` against JAX `engine.linearize` over
the three collision spectra (and each round's dirty-slot list against the
cells whose version moved), the kernel tier's fast path against the
reference's Pallas fast path and the plain slow round against the Pallas
slow kernel, run in interpret mode (one subprocess), the fast-path
predicate's false-positive safety, ctx truncation and the wrappers'
dispatch rules.  Tolerance is zero: words compare as uint32 bit patterns."""

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
    """The round's outputs as numpy arrays in `NAMES` order; its dirty-slot
    list must name exactly the cells whose version moved, ascending."""
    d, v, c, r, s, dirty = round_fn(
        convert.tensor(data, "cpu", word=True),
        convert.tensor(ver, "cpu", word=True),
        convert.link_ctx(ctx, "cpu"), convert.op_batch(ops, "cpu"))
    out = [convert.array(d, word=True), convert.array(v, word=True),
           *convert.to_numpy(c), *convert.to_numpy(r), *convert.to_numpy(s)]
    n, p = data.shape[0], ops[0].shape[0]
    moved = np.flatnonzero(out[1] != ver)
    want = np.full(p, n, np.int32)
    want[:len(moved)] = moved
    np.testing.assert_array_equal(dirty.numpy(), want,
                                  err_msg="dirty slots != cells written")
    assert int(s.n_dirty_cells) == len(moved)
    return out


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

    from repro.core import engine

    cases = np.load(sys.argv[1])
    out = {}
    for name in sorted({key.split("/")[0] for key in cases.files}):
        def arr(*fields):
            return [jnp.asarray(cases[f"{name}/{f}"]) for f in fields]
        if name.startswith("fast"):         # the fast path, results too
            data, version = arr("data", "version")
            got = er._fast_pallas(
                data.shape[0], data, version,
                engine.LinkCtx(*arr("c_slot", "c_version", "c_value",
                                    "c_linked")),
                engine.OpBatch(*arr("kind", "ops_slot", "expected",
                                    "desired")),
                block=er.DEFAULT_BLOCK, interpret=True)
            got = [got[0], got[1], *got[2], *got[3], *got[4]]
        else:
            got = er.slow_round_pallas(
                *arr("data", "version", "slot", "kind", "link_ver",
                     "expected", "desired"), interpret=True)
        for i, x in enumerate(got):
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
                         ("expected", expected), ("desired", desired),
                         ("ops_slot", ops[1]),
                         *zip(("c_slot", "c_version", "c_value",
                               "c_linked"), ctx)):
                cases[f"{name}/{f}"] = x
    return cases


def test_plain_rounds_match_pallas_kernels_interpret(tmp_path):
    """One subprocess installs the jax alias the reference needs and runs,
    with interpret=True on seeded inputs, the reference's fast path
    (`fast_round_pallas` and its assembly: table, links, results, stats)
    on collision-free or read-only batches and `slow_round_pallas` on
    sorted ones.  The kernel tier's round (the wrappers pick the plain
    versions for CPU tensors) must reproduce the first bit for bit,
    `_assemble_fast`'s stats included, and `slow_round` the second."""
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
    launches = (ter.fast_round.launches, ter.slow_round.launches,
                ter.round_epilogue.launches)
    for name in names:
        def case(*fields):
            return [cases[f"{name}/{f}"] for f in fields]
        if name.startswith("fast"):
            data, ver = case("data", "version")
            ops = case("kind", "ops_slot", "expected", "desired")
            assert bool(ter.fast_path_ok(data.shape[0],
                                         convert.op_batch(ops, "cpu")))
            out = port_round(ter.make_round(*data.shape, mode="pallas"),
                             data, ver, case("c_slot", "c_version",
                                             "c_value", "c_linked"), ops)
            want = [ref[f"{name}/{i}"] for i in range(len(NAMES))]
            assert_same(want, out, f"{name}: the fast path")
            continue
        args = [convert.tensor(cases[f"{name}/{f}"], "cpu",
                               word=f in ("data", "version", "link_ver",
                                          "expected", "desired"))
                for f in ("data", "version", "slot", "kind", "link_ver",
                          "expected", "desired")]
        out = ter.slow_round(*args)
        for i, x in enumerate(out):
            got = convert.array(x, word=i != 4)
            want = ref[f"{name}/{i}"]
            np.testing.assert_array_equal(
                got, want.view(np.uint32) if i != 4 else want,
                err_msg=f"{name}: output {i} differs from the Pallas kernel")
    # CPU tensors never launch a kernel.
    assert (ter.fast_round.launches, ter.slow_round.launches,
            ter.round_epilogue.launches) == launches


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
    flag = torch.ones((), dtype=torch.bool, device="meta")
    ctx = tengine.LinkCtx(lane, lane, meta[:2], lane.bool())
    ops = tengine.OpBatch(lane, lane, meta[:2], meta[:2])
    out = ter.RoundOut.empty(2, 2, "meta")
    for call in (lambda: ter.fast_round(flag, meta, lane[:1].expand(4), ctx,
                                        ops, out),
                 lambda: ter.slow_round(meta, lane[:1].expand(4), lane,
                                        lane, lane, meta[:2], meta[:2]),
                 lambda: ter.round_epilogue(flag, 4, ctx, lane, lane, lane,
                                            meta[:2], lane, lane,
                                            lane[:1].expand(4), out, lane),
                 lambda: ter.round_prologue(4, ops, ctx)):
        with pytest.raises(ValueError):
            call()
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


# ---------------------------------------------------------------------------
# The kernel tier's apply: against the reference's, branch against branch,
# and with every host read forbidden.
# ---------------------------------------------------------------------------

LOCK_FREE = ["seqlock", "indirect", "cached_wf", "cached_me"]
APPLY_SPECTRA = ["none", "low", "all_same", "zipf", "long", "read_dup",
                 "llsc"]


def spectrum_ops(rng, spectrum, step, n, k, p, current, ctx_slot):
    """Batch `step` of a sequence over `spectrum` (numpy, the reference's
    field order): all seven kinds over distinct slots (none), n / 8 cells
    (low), one cell (all_same), Zipf 0.99 slots (zipf), or 60 % of the
    lanes on one cell with chained CAS lanes (long); read-only kinds on
    four cells (read_dup); LL batches, each followed by SC / VALIDATE on
    the lanes' links (llsc)."""
    kind = rng.integers(0, 7, p).astype(np.int32)
    if spectrum == "none":
        slot = rng.choice(n, p, replace=False)
    elif spectrum == "low":
        slot = rng.integers(0, n // 8, p)
    elif spectrum == "all_same":
        slot = np.full(p, rng.integers(0, n))
    elif spectrum == "zipf":
        slot = (rng.zipf(1.01, p) - 1) % n
    elif spectrum == "long":
        slot = rng.integers(0, n, p)
        slot[rng.random(p) < 0.6] = rng.integers(0, n)
    elif spectrum == "read_dup":
        kind = rng.choice(np.asarray(READ_KINDS), p).astype(np.int32)
        slot = rng.integers(0, 4, p)
    else:
        ll = step % 2 == 0
        kind = np.full(p, tengine.LL, np.int32) if ll else np.where(
            rng.random(p) < 0.7, tengine.SC, tengine.VALIDATE).astype(
                np.int32)
        slot = rng.integers(0, n, p) if ll else np.clip(ctx_slot, 0, n - 1)
    slot = slot.astype(np.int32)
    expected = rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32)
    take = rng.random(p) < 0.5
    expected[take] = current[slot[take]]
    desired = rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32)
    if spectrum == "long":                 # CAS lanes expecting the row the
        order = np.argsort(slot, kind="stable")      # lane before wrote
        follow = order[1:][(slot[order[1:]] == slot[order[:-1]])
                           & (rng.random(p - 1) < 0.4)]
        before = order[:-1][np.isin(order[1:], follow)]
        expected[follow] = desired[before]
    return kind, slot, expected, desired


def jax_apply(jspec, jstate, ops, ctx):
    """The reference's `_apply_impl` with the round fixed to `linearize`
    (bit-identical to its fused round, which this jax cannot import)."""
    from repro import atomics as jatomics
    impl = jatomics.get_strategy(jspec.strategy)
    nd, nv, nctx, res, stats = jengine.linearize(
        impl.engine_view(jstate), jstate.version,
        jengine.LinkCtx(*map(jnp.asarray, ctx)),
        jengine.OpBatch(*map(jnp.asarray, ops)))
    new_state = impl.commit(jstate, nd, nv, stats.n_updates, ops[0].shape[0])
    return (new_state, nctx, res, stats,
            impl.traffic(stats, jspec.k, ops[0].shape[0]))


@pytest.mark.parametrize("spectrum", APPLY_SPECTRA)
@pytest.mark.parametrize("strategy", LOCK_FREE)
def test_kernel_tier_apply_matches_jax(strategy, spectrum, monkeypatch):
    """Four batches of `spectrum` through the kernel tier's `apply`
    (`donate=True`; its kernels' plain versions on the CPU) and through
    the reference's: every TableState leaf, link, result, stat and
    Traffic field bit for bit, and each batch on the branch its predicate
    names (none and read_dup fast, all_same and long slow)."""
    from repro import atomics as jatomics
    monkeypatch.setenv("BIGATOMIC_ENGINE_KERNEL", "pallas")
    n, k, p = 48, 3, 16
    rng = np.random.default_rng(LOCK_FREE.index(strategy) * 10
                                + APPLY_SPECTRA.index(spectrum))
    initial = rng.integers(0, 2 ** 32, (n, k), dtype=np.uint32)
    jspec = jatomics.AtomicSpec(n, k, strategy, p)
    tspec = tatomics.AtomicSpec(n, k, strategy, p)
    jstate = jatomics.init(jspec, initial)
    tstate = tatomics.init(tspec, initial, device="cpu")
    ctx = tuple(np.asarray(x) for x in jatomics.init_ctx(p, k))
    tctx = convert.link_ctx(ctx, "cpu")
    for step in range(4):
        current = np.asarray(jatomics.logical(jspec, jstate))
        ops = spectrum_ops(rng, spectrum, step, n, k, p, current, ctx[0])
        batch = convert.op_batch(ops, "cpu")
        fast = bool(ter.fast_path_ok(n, batch))
        assert fast == _np_fast_path_ok(n, ops[0], ops[1]), step
        if spectrum in ("none", "read_dup", "all_same", "long"):
            assert fast == (spectrum in ("none", "read_dup")), step
        jout = jax_apply(jspec, jstate, ops, ctx)
        tout = tatomics.apply(tspec, tstate, batch, tctx, donate=True)
        ref = [np.asarray(x) for part in jout for x in part]
        got = [x for part in tout for x in convert.to_numpy(part)]
        assert len(ref) == len(got)
        for i, (a, b) in enumerate(zip(ref, got)):
            np.testing.assert_array_equal(
                a, b, err_msg=f"{strategy}/{spectrum} step {step}: leaf {i}")
        jstate, tstate, tctx = jout[0], tout[0], tout[1]
        ctx = tuple(np.asarray(x) for x in jout[1])


def test_out_of_range_active_slot_is_a_failed_noop(monkeypatch):
    """An active lane outside [0, n) in an otherwise collision-free batch:
    the predicate fails, the slow path leaves the lane a failed no-op with
    zero outputs, and the round equals `linearize` (the port's `off`
    tier) on every output; the other lanes equal the sequential oracle.
    Then the same rule on read-only and LL / SC / VALIDATE-only batches
    (`OUT_OF_RANGE_BATCHES`), on every tier and layout."""
    n, k, p = 32, 2, 12
    rng = np.random.default_rng(23)
    data, ver = make_table(n, k, seed=23)
    ops, ctx = make_batch(rng, n, k, p, "none", data=data, ver=ver)
    ops[0][[3, 7]] = [tengine.STORE, tengine.LOAD]
    ops[1][[3, 7]] = [-4, n + 2]
    assert not bool(ter.fast_path_ok(n, convert.op_batch(ops, "cpu")))
    out = port_round(ter.make_round(n, k, mode="pallas"), data, ver, ctx,
                     ops)
    assert_same(port_round(tengine.linearize, data, ver, ctx, ops), out,
                "out of range")
    assert not out[7][[3, 7]].any() and not out[6][[3, 7]].any()
    keep = np.ones(p, bool)
    keep[[3, 7]] = False
    odata, over, _, ores = tengine.apply_ops_reference(
        data, ver, ctx, tuple(np.where(keep, x.T, x.T * 0).T if x.ndim > 1
                              else np.where(keep, x, tengine.IDLE)
                              if x is ops[0] else x for x in ops))
    np.testing.assert_array_equal(out[0], odata)
    np.testing.assert_array_equal(out[1], over)
    np.testing.assert_array_equal(out[7][keep], ores.success[keep])
    for name in OUT_OF_RANGE_BATCHES:
        assert_out_of_range_lanes_fail_everywhere(name, monkeypatch)


# Batches without STORE / CAS lanes whose active lanes name slots outside
# [0, n) (n = 4): `linearize` replays them in `_pure_sc_sorted`.  "load" is
# the batch of ROADMAP Queue 3 item 4.  (kinds, slots, ctx slots)
OUT_OF_RANGE_BATCHES = {
    "load": ([tengine.LOAD] * 4, [0, 4, -1, 7], [-1, -1, -1, -1]),
    "read_mixed": ([tengine.LOAD, tengine.LL, tengine.VALIDATE,
                    tengine.IDLE], [5, -1, 1, 2], [0, -1, 1, 2]),
    "ll_sc_validate": ([tengine.LL, tengine.SC, tengine.VALIDATE,
                        tengine.LL], [0, 4, -2, 7], [0, 4, -2, 7]),
    "sc_validate": ([tengine.SC, tengine.SC, tengine.VALIDATE,
                     tengine.SC], [1, -3, 9, 1], [1, -3, 9, 1]),
}
ALL_LAYOUTS = ["plain", "simplock", *LOCK_FREE]


def assert_out_of_range_lanes_fail_everywhere(name, monkeypatch):
    """`name`'s batch through `atomics.apply` on every layout and every
    tier (`off`: `linearize`; `xla` and `pallas`: the kernel round's plain
    twins on the CPU, which the CUDA kernels are held equal to): one
    answer everywhere.  Each out-of-range lane is a failed no-op with zero
    value (and, for an LL, a zero link version and value); the in-range
    lanes and the table equal the sequential oracle run on the batch with
    those lanes made IDLE.  (The reference instead wraps a negative slot
    and clamps the gather: its LOAD at -1 reads row 3 and succeeds.)"""
    n, k, p = 4, 2, 4
    kinds, slots, cslots = (np.asarray(x, np.int32)
                            for x in OUT_OF_RANGE_BATCHES[name])
    initial = np.arange(n * k, dtype=np.uint32).reshape(n, k)
    desired = np.full((p, k), 9, np.uint32)
    ops = (kinds, slots, np.zeros((p, k), np.uint32), desired)
    ctx = (cslots, np.zeros(p, np.uint32), np.zeros((p, k), np.uint32),
           np.ones(p, bool))
    dead = (kinds != tengine.IDLE) & ((slots < 0) | (slots >= n))
    o_data, o_ver, o_ctx, o_res = tengine.apply_ops_reference(
        initial, np.zeros(n, np.uint32), ctx,
        (np.where(dead, tengine.IDLE, kinds), slots, ops[2], desired))
    answers = {}
    for mode in ("off", "xla", "pallas"):
        monkeypatch.setenv("BIGATOMIC_ENGINE_KERNEL", mode)
        for layout in ALL_LAYOUTS:
            spec = tatomics.AtomicSpec(n, k, layout, p)
            state = tatomics.init(spec, initial, device="cpu")
            new_state, new_ctx, res, _, _ = tatomics.apply(
                spec, state, convert.op_batch(ops, "cpu"),
                convert.link_ctx(ctx, "cpu"))
            got = [convert.array(tatomics.logical(spec, new_state),
                                 word=True),
                   *convert.to_numpy(new_ctx), *convert.to_numpy(res)]
            label = f"{name}/{mode}/{layout}"
            answers[label] = got
            table, c_slot, c_ver, c_val, _, value, success = got
            np.testing.assert_array_equal(table, o_data, err_msg=label)
            assert not success[dead].any(), label
            assert not value[dead].any(), label
            np.testing.assert_array_equal(value[~dead],
                                          o_res.value[~dead], err_msg=label)
            np.testing.assert_array_equal(
                success[~dead], o_res.success[~dead], err_msg=label)
            ll_dead = dead & (kinds == tengine.LL)
            assert not c_ver[ll_dead].any(), label
            assert not c_val[ll_dead].any(), label
    first, *rest = answers
    for label in rest:
        for a, b in zip(answers[first], answers[label]):
            np.testing.assert_array_equal(a, b, err_msg=f"{first} vs {label}")


def test_success_without_write_of_the_reference_is_not_copied(monkeypatch):
    """ROADMAP Queue 3 item 4's record of a fault of the reference: kinds
    STORE / LOAD / CAS / LL at slots [4, 3, 5, -2], the CAS expecting row
    3.  The reference clamp-gathers slot 5 to row 3, reports the CAS a
    success and writes nothing (success [F, T, T, T]); the port fails
    both out-of-range writes, as its kernels do (success [F, T, F, F],
    one failed CAS), on every tier, and leaves the table as it was."""
    n, k, p = 4, 2, 4
    initial = np.arange(n * k, dtype=np.uint32).reshape(n, k)
    expected = np.zeros((p, k), np.uint32)
    expected[2] = initial[3]
    ops = (np.asarray([tengine.STORE, tengine.LOAD, tengine.CAS, tengine.LL],
                      np.int32), np.asarray([4, 3, 5, -2], np.int32),
           expected, np.full((p, k), 9, np.uint32))
    for mode in ("off", "xla", "pallas"):
        monkeypatch.setenv("BIGATOMIC_ENGINE_KERNEL", mode)
        spec = tatomics.AtomicSpec(n, k, "cached_me", p)
        state, _, res, stats, _ = tatomics.apply(
            spec, tatomics.init(spec, initial, device="cpu"),
            convert.op_batch(ops, "cpu"))
        assert res.success.tolist() == [False, True, False, False], mode
        assert int(stats.n_cas_fail) == 1, mode
        np.testing.assert_array_equal(
            convert.array(tatomics.logical(spec, state), word=True),
            initial, err_msg=mode)


@pytest.mark.parametrize("spectrum", ["none", "read_dup", "read_same"])
@pytest.mark.parametrize("seed", range(3))
def test_fast_and_slow_branch_agree_where_the_predicate_admits(
        spectrum, seed, monkeypatch):
    """On every batch the predicate admits (collision-free with writes,
    read-only with duplicate slots, read-only on one cell), the slow branch
    forced in its place gives the same table, links, results, stats and
    dirty slots: `_assemble_fast`'s stats (which the Pallas test pins to
    the fast branch) and `stats_on_sorted`'s agree."""
    n, k, p = 40, 2, 24
    rng = np.random.default_rng(seed)
    data, ver = make_table(n, k, seed=seed)
    kinds = ALL_KINDS if spectrum == "none" else READ_KINDS
    ops, ctx = make_batch(rng, n, k, p,
                          {"read_dup": "low", "read_same": "all_same"}.get(
                              spectrum, spectrum),
                          kinds=kinds, data=data, ver=ver)
    assert bool(ter.fast_path_ok(n, convert.op_batch(ops, "cpu")))
    round_fn = ter.make_round(n, k, mode="pallas")
    fast_out = port_round(round_fn, data, ver, ctx, ops)
    plain = ter.round_prologue_plain
    monkeypatch.setattr(ter, "round_prologue_plain", lambda *a: plain(
        *a)._replace(fast=torch.tensor(False)))
    slow_out = port_round(round_fn, data, ver, ctx, ops)
    assert_same(fast_out, slow_out, f"{spectrum} seed {seed}")


def test_kernel_tier_reads_nothing_back(monkeypatch):
    """The kernel tier's host code (the round and the layout's commit, as
    `engine.run_round` runs them, and the traffic model) on a fast and a
    slow batch per lock-free layout, with every way a tensor reaches the
    host patched to raise.  Only the replay's plain version reads its
    round count back (the kernel does not); it is replaced by its recorded
    outputs.  The outputs equal an unpatched run's."""
    n, k, p = 40, 2, 16
    rng = np.random.default_rng(5)
    for strategy in LOCK_FREE:
        spec = tatomics.AtomicSpec(n, k, strategy, p)
        impl = tatomics.get_strategy(strategy)
        initial = rng.integers(0, 2 ** 32, (n, k), dtype=np.uint32)
        base = tatomics.init(spec, initial, device="cpu")
        for spectrum in ("none", "low"):
            ops_np, ctx_np = make_batch(rng, n, k, p, spectrum,
                                        data=initial,
                                        ver=np.zeros(n, np.uint32))
            ops = convert.op_batch(ops_np, "cpu")
            ctx = convert.link_ctx(ctx_np, "cpu")
            recorded = []
            slow = ter.slow_round

            def record(*a, **kw):
                out = slow(*a, **kw)
                recorded.append([x.clone() for x in out])
                return out

            def replay(data, version, *a, **kw):
                d, v, *rest = recorded[0]
                data.copy_(d)
                version.copy_(v)
                return (data, version, *rest)

            def run(state):
                round_fn = ter.make_round(n, k, mode="pallas")
                new_state, new_ctx, res, stats = tengine.run_round(
                    impl, round_fn, state, ctx, ops, donate=True)
                return [*new_state, *new_ctx, *res, *stats,
                        *impl.traffic(stats, k, p)]

            with monkeypatch.context() as m:
                m.setattr(ter, "slow_round", record)
                want = run(tatomics.TableState(*(x.clone() for x in base)))
            with monkeypatch.context() as m:
                m.setattr(ter, "slow_round", replay)
                for name in ("__bool__", "__int__", "__index__", "__float__",
                             "item", "tolist", "numpy"):
                    m.setattr(torch.Tensor, name, _no_host_read(name))
                got = run(tatomics.TableState(*(x.clone() for x in base)))
            for i, (a, b) in enumerate(zip(got, want)):
                assert torch.equal(a, b), f"{strategy}/{spectrum}: {i}"


def _no_host_read(name):
    def read(self, *args, **kwargs):
        raise AssertionError(f"Tensor.{name}: the kernel tier read a "
                             f"tensor back to the host")
    return read
