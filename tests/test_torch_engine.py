"""The port's engine (`repro_torch.core.engine`) against the JAX reference:
`linearize` and `stats_on_sorted` against JAX `engine.linearize` /
`engine.stats_on_sorted`, the port's numpy `apply_ops_reference` against
the reference's, both against the shared `TableOracle`, and `make_ops`
validation.  Tolerance is zero: words compare as uint32 bit patterns."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import TableOracle, mixed_batch
from repro import atomics as jatomics
from repro.core import engine as jengine
from repro_torch import atomics as tatomics
from repro_torch import convert
from repro_torch.core import engine as tengine

STRATEGIES = ["plain", "simplock", "seqlock", "indirect", "cached_wf",
              "cached_me"]


def _np(nt):
    return [np.asarray(x) for x in nt]


def test_kind_constants_match_reference():
    for name in ("LOAD", "STORE", "CAS", "IDLE", "LL", "SC", "VALIDATE",
                 "FIND", "INSERT", "DELETE", "TABLE_KINDS", "HASH_KINDS"):
        assert getattr(tengine, name) == getattr(jengine, name), name
    for cls in ("OpBatch", "LinkCtx", "ApplyResult", "ApplyStats"):
        assert getattr(tengine, cls)._fields == getattr(jengine, cls)._fields


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_linearize_matches_jax_and_oracle_over_mixed_batches(strategy):
    """A chain of `oracle.mixed_batch` batches (all seven kinds, SC and
    VALIDATE mostly on live links) over each layout's engine view: the
    port's `linearize` equals JAX `linearize` on every output and the
    shared sequential oracle on values, versions, results and links."""
    n, k, p = 12, 3, 16
    rng = np.random.default_rng(STRATEGIES.index(strategy))
    initial = rng.integers(0, 2 ** 32, (n, k), dtype=np.uint32)
    spec = jatomics.AtomicSpec(n, k, strategy, p_max=p)
    jstate = jatomics.init(spec, initial)
    impl = jatomics.get_strategy(strategy)
    data = np.asarray(impl.engine_view(jstate))
    ver = np.asarray(jstate.version)
    ctx = _np(jatomics.init_ctx(p, k))
    oracle = TableOracle(n, k, p, initial)
    for step in range(6):
        ops = _np(mixed_batch(rng, jengine.LinkCtx(*ctx), p=p, n=n, k=k,
                                current=data))
        jout = jengine.linearize(jnp.asarray(data), jnp.asarray(ver),
                                 jengine.LinkCtx(*map(jnp.asarray, ctx)),
                                 jengine.OpBatch(*map(jnp.asarray, ops)))
        tout = tengine.linearize(convert.tensor(data, "cpu", word=True),
                                 convert.tensor(ver, "cpu", word=True),
                                 convert.link_ctx(ctx, "cpu"),
                                 convert.op_batch(ops, "cpu"))
        ref = [np.asarray(jout[0]), np.asarray(jout[1]),
               *_np(jout[2]), *_np(jout[3]), *_np(jout[4])]
        got = [convert.array(tout[0], word=True),
               convert.array(tout[1], word=True),
               *convert.to_numpy(tout[2]), *convert.to_numpy(tout[3]),
               *convert.to_numpy(tout[4])]
        for i, (a, b) in enumerate(zip(ref, got)):
            np.testing.assert_array_equal(a, b,
                                          err_msg=f"step {step} leaf {i}")
        res = oracle.step_and_check(
            jengine.OpBatch(*ops), result=tengine.ApplyResult(got[6], got[7]),
            logical=got[0], version=got[1],
            ctx=tengine.LinkCtx(*got[2:6]), msg=f"{strategy} step {step}")
        assert res is not None
        data, ver, ctx = got[0], got[1], got[2:6]


def test_linearize_pure_sc_closed_form_matches_jax():
    """Batches without STORE/CAS take the one-round closed form; several
    SC lanes per cell (first eligible wins) and stale links included."""
    n, k, p = 6, 2, 20
    rng = np.random.default_rng(5)
    data = rng.integers(0, 2 ** 32, (n, k), dtype=np.uint32)
    ver = (rng.integers(0, 4, n) * 2).astype(np.uint32)
    for trial in range(4):
        kind = rng.choice([tengine.LOAD, tengine.LL, tengine.SC,
                           tengine.VALIDATE, tengine.IDLE], p).astype(np.int32)
        slot = rng.integers(0, n, p).astype(np.int32)
        ops = (kind, slot, np.zeros((p, k), np.uint32),
               rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32))
        cslot = np.where(rng.random(p) < 0.8, slot,
                         rng.integers(0, n, p)).astype(np.int32)
        cver = np.where(rng.random(p) < 0.7, ver[cslot],
                        ver[cslot] + 2).astype(np.uint32)
        ctx = (cslot, cver, np.zeros((p, k), np.uint32), rng.random(p) < 0.9)
        jout = jengine.linearize(jnp.asarray(data), jnp.asarray(ver),
                                 jengine.LinkCtx(*map(jnp.asarray, ctx)),
                                 jengine.OpBatch(*map(jnp.asarray, ops)))
        tout = tengine.linearize(convert.tensor(data, "cpu", word=True),
                                 convert.tensor(ver, "cpu", word=True),
                                 convert.link_ctx(ctx, "cpu"),
                                 convert.op_batch(ops, "cpu"))
        assert int(jout[4].rounds) <= 1
        np.testing.assert_array_equal(np.asarray(jout[0]),
                                      convert.array(tout[0], word=True))
        np.testing.assert_array_equal(np.asarray(jout[1]),
                                      convert.array(tout[1], word=True))
        for a, b in zip([*_np(jout[2]), *_np(jout[3]), *_np(jout[4])],
                        [*convert.to_numpy(tout[2]),
                         *convert.to_numpy(tout[3]),
                         *convert.to_numpy(tout[4])]):
            np.testing.assert_array_equal(a, b, err_msg=f"trial {trial}")
        data, ver = np.asarray(jout[0]), np.asarray(jout[1])


@pytest.mark.parametrize("seed", range(4))
def test_stats_on_sorted_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n, p = 10, 40
    s_slot = np.sort(rng.integers(0, n + 1, p)).astype(np.int32)
    s_kind = rng.integers(0, 7, p).astype(np.int32)
    succ = rng.random(p) < 0.5
    ref = jengine.stats_on_sorted(n, jnp.asarray(s_slot), jnp.asarray(s_kind),
                                  jnp.asarray(succ))
    got = tengine.stats_on_sorted(n, torch.from_numpy(s_slot),
                                  torch.from_numpy(s_kind),
                                  torch.from_numpy(succ))
    for name, a, b in zip(jengine.ApplyStats._fields, ref, got):
        assert b.dtype == torch.int32, name
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)


def test_apply_ops_reference_matches_jax_reference():
    n, k, p = 8, 3, 30
    rng = np.random.default_rng(11)
    data = rng.integers(0, 2 ** 32, (n, k), dtype=np.uint32)
    ver = np.zeros(n, np.uint32)
    ctx = _np(jatomics.init_ctx(p, k))
    for _ in range(3):
        ops = _np(mixed_batch(rng, jengine.LinkCtx(*ctx), p=p, n=n, k=k,
                                current=data))
        ref = jengine.apply_ops_reference(data, ver, jengine.LinkCtx(*ctx),
                                          jengine.OpBatch(*ops))
        got = tengine.apply_ops_reference(data, ver, ctx, ops)
        for a, b in zip([ref[0], ref[1], *ref[2], *ref[3]],
                        [got[0], got[1], *got[2], *got[3]]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        data, ver, ctx = ref[0], ref[1], _np(ref[2])


def test_make_ops_validates_and_coerces():
    k = 2
    with pytest.raises(ValueError, match="unknown op kinds"):
        tatomics.make_ops([0, 11], [0, 1], k=k, device="cpu")
    with pytest.raises(ValueError, match="slot shape"):
        tatomics.make_ops([0, 1], [0], k=k, device="cpu")
    with pytest.raises(ValueError, match="desired shape"):
        tatomics.make_ops([0, 1], [0, 1], desired=np.zeros((2, 3)), k=k,
                          device="cpu")
    with pytest.raises(ValueError, match="rank-1"):
        tatomics.make_ops([[0, 1]], [0, 1], k=k, device="cpu")
    words = np.array([[0xFFFFFFFF, 7], [2 ** 31, 0]], np.uint32)
    for form in (words, words.astype(np.int64), torch.from_numpy(
            words.view(np.int32)), words.view(np.int32)):
        ops = tatomics.make_ops(np.array([1, 2], np.int64), [0, 1],
                                expected=form, desired=form, k=k,
                                device="cpu")
        assert ops.kind.dtype == ops.slot.dtype == torch.int32
        assert ops.expected.dtype == ops.desired.dtype == torch.int32
        np.testing.assert_array_equal(convert.array(ops.desired, word=True),
                                      words)
    ref = jatomics.make_ops([1, 2], [0, 1], words, words, k=k)
    np.testing.assert_array_equal(np.asarray(ref.expected),
                                  convert.array(ops.expected, word=True))
    assert tatomics.loads([1, 2], k=k, device="cpu").kind.tolist() == [0, 0]
    assert tatomics.stores([1], words[:1], k=k,
                           device="cpu").kind.tolist() == [1]
    assert tatomics.cas_ops([1], words[:1], words[:1], k=k,
                            device="cpu").kind.tolist() == [2]
    assert tatomics.sync_ops([4, 5], [0, 0], k=k,
                             device="cpu").kind.tolist() == [4, 5]


def test_check_kinds_rejects_hash_kinds_in_apply():
    spec = tatomics.AtomicSpec(4, 2, "seqlock", p_max=2)
    state = tatomics.init(spec, device="cpu")
    ops = tatomics.make_ops([tengine.FIND, tengine.LOAD], [0, 1], k=2,
                            device="cpu")
    with pytest.raises(ValueError, match="not table ops"):
        tatomics.apply(spec, state, ops)


def test_creating_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tatomics.make_ops([0], [0], k=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tatomics.init_ctx(2, 2)
