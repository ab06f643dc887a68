"""The port's layouts (`repro_torch.core.layout`, `core/strategies.py`,
`core/registry.py`) against the JAX reference for all six registered
strategies: `init`, `logical`, `read`, `memory_bytes`, `state_nbytes`,
`begin_update` (torn writers), `check_invariants`, and the FIFO free ring.
Tolerance is zero: words compare as uint32 bit patterns."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import atomics as jatomics
from repro.core import layout as jlayout
from repro_torch import atomics as tatomics
from repro_torch import convert
from repro_torch.core import layout as tlayout
from torch_threads import one_thread  # noqa: F401

STRATEGIES = ["plain", "simplock", "seqlock", "indirect", "cached_wf",
              "cached_me"]


def _jnp_state(state):
    return tuple(np.asarray(x) for x in state)


def assert_state_equal(jstate, tstate, msg=""):
    ref = _jnp_state(jstate)
    got = convert.to_numpy(tstate)
    for name, a, b in zip(jlayout.TableState._fields, ref, got):
        assert a.dtype == b.dtype, f"{msg}: {name} dtype {a.dtype} {b.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=f"{msg}: {name}")


def _pair(strategy, n=10, k=3, p_max=4, seed=0):
    rng = np.random.default_rng(seed)
    initial = rng.integers(0, 2 ** 32, (n, k), dtype=np.uint32)
    jspec = jatomics.AtomicSpec(n, k, strategy, p_max)
    tspec = tatomics.AtomicSpec(n, k, strategy, p_max)
    return (jspec, jatomics.init(jspec, initial), tspec,
            tatomics.init(tspec, initial, device="cpu"))


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_init_logical_read_match(strategy):
    jspec, jstate, tspec, tstate = _pair(strategy)
    assert_state_equal(jstate, tstate, "init")
    np.testing.assert_array_equal(
        np.asarray(jatomics.logical(jspec, jstate)),
        convert.array(tatomics.logical(tspec, tstate), word=True))
    slots = np.array([0, 3, 3, 9], np.int32)
    jv, jok = jatomics.read(jspec, jstate, jnp.asarray(slots))
    tv, tok = tatomics.read(tspec, tstate, slots)
    np.testing.assert_array_equal(np.asarray(jv), convert.array(tv, word=True))
    np.testing.assert_array_equal(np.asarray(jok), tok.numpy())


@pytest.mark.parametrize("slots", [[0, 4], [-5], [-1]])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_read_of_out_of_range_slots_matches_reference(strategy, slots):
    """ROADMAP Queue 3 item 5: `AtomicSpec(4, 2, s, 2)` over
    `arange(8).reshape(4, 2)`, read at slots outside [0, n).  The
    reference's gather wraps a negative slot, then clamps (slot 4 reads
    row 3, -5 row 0, -1 row 3); `engine.read` and the strategy's own `read`
    give the same rows and ok, where they raised before."""
    initial = np.arange(8, dtype=np.uint32).reshape(4, 2)
    jspec = jatomics.AtomicSpec(4, 2, strategy, 2)
    tspec = tatomics.AtomicSpec(4, 2, strategy, 2)
    jstate = jatomics.init(jspec, initial)
    tstate = tatomics.init(tspec, initial, device="cpu")
    q = np.asarray(slots, np.int32)
    jv, jok = jatomics.read(jspec, jstate, jnp.asarray(q))
    for tv, tok in (tatomics.read(tspec, tstate, q),
                    tatomics.get_strategy(strategy).read(
                        tstate, torch.from_numpy(q).long())):
        np.testing.assert_array_equal(np.asarray(jv),
                                      convert.array(tv, word=True))
        np.testing.assert_array_equal(np.asarray(jok), tok.numpy())


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_memory_bytes_and_state_nbytes_match(strategy):
    for n, k, p in ((10, 3, 4), (64, 4, 16), (7, 1, 2)):
        jspec = jatomics.AtomicSpec(n, k, strategy, p)
        tspec = tatomics.AtomicSpec(n, k, strategy, p)
        assert tatomics.memory_bytes(tspec) == jatomics.memory_bytes(jspec)
        assert tatomics.state_nbytes(tatomics.init(tspec, device="cpu")) \
            == jatomics.state_nbytes(jatomics.init(jspec))


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_begin_update_torn_reads_match(strategy):
    """A writer frozen mid-update: the layouts' states, logical values and
    honest reads (blocked readers, backup fallbacks) agree bit for bit,
    and the passed state is left untouched."""
    jspec, jstate, tspec, tstate = _pair(strategy, seed=1)
    before = convert.to_numpy(tstate)
    new_value = np.array([0xFFFFFFFF, 1, 2 ** 31], np.uint32)
    for torn in (None, 1):
        jt = jatomics.begin_update(jspec, jstate, 4, new_value, torn)
        tt = tatomics.begin_update(tspec, tstate, 4, new_value, torn)
        assert_state_equal(jt, tt, f"torn={torn}")
        jv, jok = jatomics.read(jspec, jt, jnp.arange(10))
        tv, tok = tatomics.read(tspec, tt, np.arange(10))
        np.testing.assert_array_equal(np.asarray(jv),
                                      convert.array(tv, word=True))
        np.testing.assert_array_equal(np.asarray(jok), tok.numpy())
        np.testing.assert_array_equal(
            np.asarray(jatomics.logical(jspec, jt)),
            convert.array(tatomics.logical(tspec, tt), word=True))
        jinv = jatomics.get_strategy(strategy).check_invariants(jspec, jt)
        tinv = tatomics.get_strategy(strategy).check_invariants(tspec, tt)
        assert sorted(jinv) == sorted(tinv)
        for name in jinv:
            np.testing.assert_array_equal(np.asarray(jinv[name]),
                                          tinv[name].numpy(), err_msg=name)
    for a, b in zip(before, convert.to_numpy(tstate)):
        np.testing.assert_array_equal(a, b)


def test_ring_alloc_free_and_sim_alloc_match():
    """The FIFO free ring: a batch's pops (with the head wrapping past the
    end) and its pushes of the retired nodes, `ring_take` then
    `ring_return` against the reference's `ring_alloc` then `ring_free`,
    and the simulator's single pop."""
    n, k, p = 6, 2, 3
    jspec = jatomics.AtomicSpec(n, k, "indirect", p)
    jstate = jatomics.init(jspec)
    tstate = tatomics.init(tatomics.AtomicSpec(n, k, "indirect", p),
                           device="cpu")
    m = jstate.free_ring.shape[0]
    for want in (3, 2, 3, 1, 3, 0):
        jslots, jstate = jlayout.ring_alloc(jstate, jnp.uint32(want), p)
        pos, tslots = tlayout.ring_take(tstate, p)
        live = torch.arange(p) < want
        np.testing.assert_array_equal(
            np.asarray(jslots), torch.where(live, tslots, -1).numpy())
        retired = (np.arange(p) + want * 5) % m
        jstate = jlayout.ring_free(jstate, jnp.asarray(retired, jnp.int32),
                                   jnp.uint32(want), p)
        tstate = tlayout.ring_return(
            tstate, pos, torch.from_numpy(retired.astype(np.int32)), live,
            torch.tensor(want, dtype=torch.int32))
        assert_state_equal(jstate, tstate, f"ring want={want}")
    jslot, jstate = jlayout.sim_alloc(jstate)
    tslot, tstate = tlayout.sim_alloc(tstate)
    assert int(jslot) == int(tslot)
    assert_state_equal(jstate, tstate, "sim_alloc")


def test_word_helpers_keep_bits():
    words = np.array([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1], np.uint32)
    t = tlayout.as_words(words, "cpu")
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(convert.array(t, word=True), words)
    np.testing.assert_array_equal(tlayout.as_u64(t).numpy(),
                                  words.astype(np.int64))
    np.testing.assert_array_equal(
        tlayout.to_word(tlayout.as_u64(t) + 2).numpy().view(np.uint32),
        words + np.uint32(2))
    # the cached_me tag: arithmetic shift of the int32 bits == logical
    # shift of the uint32, once the top two bits are masked
    np.testing.assert_array_equal(
        ((t >> 1) & 0x3FFFFFFF).numpy(),
        ((words >> 1).astype(np.int32) & 0x3FFFFFFF))


def test_convert_round_trip_and_registry():
    _, jstate, _, _ = _pair("cached_wf")
    tstate = convert.table_state(_jnp_state(jstate), "cpu")
    assert_state_equal(jstate, tstate, "round trip")
    assert tatomics.registered_strategies() == \
        jatomics.registered_strategies()

    class PlainClone(tatomics.StrategyImpl):
        name = "torch_layout_test_plugin"

    impl = tatomics.register_strategy(PlainClone)
    try:
        with pytest.raises(ValueError, match="already registered"):
            tatomics.register_strategy(PlainClone)
        assert tatomics.get_strategy(impl.name) is impl
    finally:
        tatomics.unregister_strategy(impl.name)
    with pytest.raises(KeyError):
        tatomics.get_strategy(impl.name)


@pytest.mark.parametrize("strategy", ["indirect", "cached_wf", "cached_me"])
def test_node_ring_stays_fifo_past_2p_allocations(strategy):
    """Many more node allocations than the ring holds: every cell keeps a
    distinct live node, the free ring keeps the rest, and the logical
    values equal the sequential oracle.  (The reference's node-pool ring
    pops NULL once 2p nodes are allocated; ROADMAP.md, Queue 3.)"""
    n, k, p = 16, 2, 3
    spec = tatomics.AtomicSpec(n, k, strategy, p)
    state = tatomics.init(spec, device="cpu")
    data, ver = np.zeros((n, k), np.uint32), np.zeros(n, np.uint32)
    ctx = convert.to_numpy(tatomics.init_ctx(p, k, device="cpu"))
    rng = np.random.default_rng(4)
    for _ in range(12):                     # up to 36 allocations vs 2p = 6
        ops = (np.full(p, tatomics.STORE, np.int32),
               rng.choice(n, p, replace=False).astype(np.int32),
               np.zeros((p, k), np.uint32),
               rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32))
        state, *_ = tatomics.apply(spec, state, convert.op_batch(ops, "cpu"))
        data, ver, ctx, _ = tatomics.apply_ops_reference(data, ver, ctx, ops)
        np.testing.assert_array_equal(
            convert.array(tatomics.logical(spec, state), word=True), data)
        np.testing.assert_array_equal(convert.array(state.version, word=True),
                                      ver)
        if strategy != "cached_me":
            ring = state.free_ring.numpy()
            live = state.bptr.numpy()
            free = ring[ring != -1]
            assert len(free) == 2 * p and (live >= 0).all()
            assert sorted(np.concatenate([live, free]).tolist()) == \
                list(range(n + 2 * p)), "a node was lost or duplicated"


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 8, 16])
def test_gather_rows_equals_indexing(k):
    """`layout.gather_rows` copies the same bits as `table[idx]`, through
    its 16-byte flat view where the rows allow it and plain indexing
    elsewhere (odd rows, an offset view)."""
    rng = np.random.default_rng(k)
    table = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (37, k),
                                          dtype=np.int64).astype(np.int32))
    idx = torch.from_numpy(rng.integers(0, 37, 50))
    for t in (table, table[1:]):
        i = idx.clamp(max=t.shape[0] - 1)
        assert torch.equal(tlayout.gather_rows(t, i), t[i])
    nan = torch.full((4, 4), 0x7FC00001, dtype=torch.int32)    # NaN bits
    assert torch.equal(tlayout.gather_rows(nan, torch.tensor([2, 0])),
                       nan[[2, 0]])


def _chain_batch(rng, n, k, p, current):
    """STOREs, CASes and loads over a few cells, one of them a CAS chain
    that ends at the value it started from (A -> B -> A): dirty only by
    its version."""
    cells = rng.choice(n, 5, replace=False)
    kind = rng.choice([0, 1, 2, 4], p).astype(np.int32)
    slot = rng.choice(cells[1:], p).astype(np.int32)
    expected = rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32)
    take = rng.random(p) < 0.5
    expected[take] = current[slot[take]]
    desired = rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32)
    a, b = current[cells[0]], rng.integers(0, 2 ** 32, k, dtype=np.uint32)
    kind[:2], slot[:2] = tatomics.CAS, cells[0]
    expected[0], desired[0], expected[1], desired[1] = a, b, b, a
    return kind, slot, expected, desired


@pytest.mark.parametrize("strategy", ["seqlock", "indirect", "cached_wf",
                                      "cached_me"])
@pytest.mark.parametrize("seed", range(3))
def test_dirty_slot_commit_matches_reference_commit(strategy, seed):
    """The layouts' commit from the round's dirty-slot list against the
    reference's commit, which diffs the versions over the whole table, on
    the same pre-batch state and the same post-batch table, over batches
    that stay below 2p node allocations: a CAS chain that ends at its
    starting value (dirty by version), STOREs, failing CASes and loads on
    shared cells, and a collision-free batch; cached_me's tagged nulls
    included.  Every TableState leaf bit for bit."""
    from repro.core import engine as jengine
    n, k, p = 40, 2, 8
    rng = np.random.default_rng(seed)
    jspec, jstate, tspec, tstate = _pair(strategy, n, k, p, seed)
    jimpl = jatomics.get_strategy(strategy)
    timpl = tatomics.get_strategy(strategy)
    ctx = convert.to_numpy(tatomics.init_ctx(p, k, device="cpu"))
    allocated = 0
    for step in range(3):
        current = np.asarray(jatomics.logical(jspec, jstate))
        if step == 2:
            slot = rng.choice(n, p, replace=False).astype(np.int32)
            ops = (np.full(p, tatomics.STORE, np.int32), slot,
                   np.zeros((p, k), np.uint32),
                   rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32))
        else:
            ops = _chain_batch(rng, n, k, p, current)
        nd, nv, _, _, jstats = jengine.linearize(
            jimpl.engine_view(jstate), jstate.version,
            jengine.LinkCtx(*map(jnp.asarray, ctx)),
            jengine.OpBatch(*map(jnp.asarray, ops)))
        want = jimpl.commit(jstate, nd, nv, jstats.n_updates, p)
        round_fn = tatomics.get_strategy(strategy).lower_round(
            tspec, mode="pallas")
        d, v, _, _, tstats, dirty = round_fn(
            timpl.engine_view(tstate), tstate.version,
            convert.link_ctx(ctx, "cpu"), convert.op_batch(ops, "cpu"))
        got = timpl.commit(tstate, d, v, tstats, dirty, p)
        assert_state_equal(want, got, f"{strategy} step {step}")
        moved = np.asarray(nv) != np.asarray(jstate.version)
        if step == 0:
            assert moved[ops[1][0]] and \
                (np.asarray(nd)[ops[1][0]] == current[ops[1][0]]).all()
        allocated += int(moved.sum())
        jstate, tstate = want, got
    assert allocated < 2 * p
