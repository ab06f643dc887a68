"""The port's CacheHash (`repro_torch.core.cachehash`) against the JAX
reference, which runs in this process (its bucket rounds are plain `jnp`,
no Pallas kernel).

The same seeded batches go through `apply_hash` of both packages, inline
(CacheHash) and chaining, on the four lock-free layouts: the whole
`HashState` (bucket table leaf by leaf, pool, ring, cursors, count), the
`HashResult` and the `HashStats` are equal bit for bit (words as uint32)
while the table's node rings stay below 2 * p_max allocations.  Past that
point the reference's INDIRECT / CACHED_WF node ring loses nodes (a fault
of the reference, ROADMAP Queue 3) and the port is held to the dict oracle
instead.  Covered: path-copy deletes at chain depth >= 2, overflow at
`max_chain`, IDLE lanes, FIND-only batches, keys >= 2^31, ring cursors
near 2^32, the legacy `OpBatch` / `apply_hash_ops` / `CacheHash`, `items`,
`free_slots_available`, bad kinds, and exactly one host read per
`apply_hash`."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import cachehash as jch
from repro.core.specs import HashSpec as JSpec
from repro_torch.core import cachehash as tch
from repro_torch.core import deprecation
from repro_torch.core.specs import HashSpec as TSpec

LOCK_FREE = ["seqlock", "indirect", "cached_wf", "cached_me"]
FIND, INSERT, DELETE, IDLE = 7, 8, 9, 3


def bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype in (np.int32, np.uint32) else x


def leaves(state):
    return [bits(x) for x in (*state.table, *state[1:])]


def assert_state_equal(jstate, tstate, label):
    for i, (a, b) in enumerate(zip(leaves(jstate), leaves(tstate))):
        np.testing.assert_array_equal(b, a, err_msg=f"{label}: leaf {i}")


def assert_apply_equal(jout, tout, label):
    assert_state_equal(jout[0], tout[0], label)
    for name, a, b in zip(jch.HashResult._fields, jout[1], tout[1]):
        np.testing.assert_array_equal(bits(b), bits(a),
                                      err_msg=f"{label}: result {name}")
    for name, a, b in zip(jch.HashStats._fields, jout[2], tout[2]):
        np.testing.assert_array_equal(bits(b), bits(a),
                                      err_msg=f"{label}: stats {name}")


def specs(nb, vw, strategy, p_max, **kw):
    return (JSpec(nb, vw, strategy, p_max, **kw),
            TSpec(nb, vw, strategy, p_max, **kw))


def batch(rng, q, key_space, vw, *, kinds=(FIND, INSERT, DELETE, IDLE),
          weights=None, high=False):
    kind = rng.choice(np.asarray(kinds, np.int32), q, p=weights)
    keys = rng.integers(0, key_space, q).astype(np.uint32)
    if high:
        keys = keys + np.uint32(2 ** 31 + 12345)
    vals = rng.integers(0, 2 ** 32, (q, vw), dtype=np.uint32)
    return kind.astype(np.int32), keys, vals


def both_apply(jspec, tspec, jstate, tstate, ops):
    kind, keys, vals = ops
    jout = jch.apply_hash(jspec, jstate,
                          jch.make_hash_ops(kind, keys, vals, vw=jspec.vw))
    tout = tch.apply_hash(tspec, tstate, tch.make_hash_ops(
        kind, keys, vals, vw=tspec.vw, device="cpu"))
    return jout, tout


@pytest.mark.parametrize("inline", [True, False], ids=["inline", "chaining"])
@pytest.mark.parametrize("strategy", LOCK_FREE)
def test_apply_hash_matches_reference(strategy, inline):
    """Insert-heavy then mixed batches on 8 buckets (chains several links
    deep, path-copy deletes at depth >= 2), a FIND-only batch, keys above
    2^31 and IDLE lanes: every state leaf, result and stat."""
    jspec, tspec = specs(8, 2, strategy, 256, inline=inline, max_chain=6)
    jstate, tstate = jch.init_hash(jspec), tch.init_hash(tspec, device="cpu")
    rng = np.random.default_rng(LOCK_FREE.index(strategy) * 2 + inline)
    plan = [dict(weights=[0.1, 0.8, 0.05, 0.05]),
            dict(weights=[0.1, 0.8, 0.05, 0.05], high=True),
            dict(weights=[0.3, 0.2, 0.4, 0.1]),
            dict(kinds=(FIND, IDLE), weights=[0.9, 0.1]),
            dict(weights=[0.2, 0.3, 0.4, 0.1], high=True),
            dict(weights=[0.1, 0.1, 0.7, 0.1])]
    depth2 = 0
    for step, kw in enumerate(plan):
        ops = batch(rng, 24, 40, 2, **kw)
        deep = {k for k, v in _depths(jstate, jspec).items() if v >= 2}
        depth2 += int(np.isin(ops[1][ops[0] == DELETE],
                              np.fromiter(deep, np.uint32)).sum())
        jout, tout = both_apply(jspec, tspec, jstate, tstate, ops)
        assert_apply_equal(jout, tout, f"{strategy}/{inline} step {step}")
        jstate, tstate = jout[0], tout[0]
    assert depth2 > 0, "no delete reached chain depth >= 2"
    assert tch.items(tstate, inline=inline, vw=2).keys() == \
        jch.items(jstate, inline=inline, vw=2).keys()
    for key, value in jch.items(jstate, inline=inline, vw=2).items():
        np.testing.assert_array_equal(
            tch.items(tstate, inline=inline, vw=2)[key], value)
    assert tch.free_slots_available(tstate) == \
        jch.free_slots_available(jstate)


def _depths(state, spec):
    """{key: chain depth} of the reference table (0 = the inlined link)."""
    data = np.asarray(state.table.data)
    pool = np.asarray(state.pool)
    out = {}
    for b in range(data.shape[0]):
        if spec.inline:
            if data[b, -1] == np.uint32(0xFFFFFFFF):
                continue
            out[int(data[b, 0])] = 0
            cur, d = data[b, -1], 1
        else:
            cur, d = data[b, 0], 1
        while cur < np.uint32(0xFFFFFFFE):
            out[int(pool[int(cur), 0])] = d
            cur, d = pool[int(cur), -1], d + 1
    return out


@pytest.mark.parametrize("inline", [True, False], ids=["inline", "chaining"])
def test_overflow_at_max_chain(inline):
    """Two buckets, max_chain 3: once a chain is full, INSERTs of new keys
    overflow and fail; FINDs and DELETEs past it report overflow."""
    jspec, tspec = specs(2, 1, "cached_me", 128, inline=inline, max_chain=3)
    jstate, tstate = jch.init_hash(jspec), tch.init_hash(tspec, device="cpu")
    rng = np.random.default_rng(8)
    overflowed = 0
    for step in range(4):
        kinds = (INSERT,) if step < 2 else (FIND, INSERT, DELETE)
        ops = batch(rng, 16, 60, 1, kinds=kinds)
        jout, tout = both_apply(jspec, tspec, jstate, tstate, ops)
        assert_apply_equal(jout, tout, f"overflow step {step}")
        overflowed += int(bits(tout[1].overflow).sum())
        jstate, tstate = jout[0], tout[0]
    assert overflowed > 0


@pytest.mark.parametrize("strategy", LOCK_FREE)
def test_ring_cursors_near_2_32(strategy):
    """The pool ring's head and tail a few allocations short of 2^32: the
    cursors wrap as the reference's uint32 ones do."""
    jspec, tspec = specs(4, 2, strategy, 256, max_chain=5)
    jstate = jch.init_hash(jspec)
    tstate = tch.init_hash(tspec, device="cpu")
    cap = jspec.pool_cap
    head = 2 ** 32 - 7
    jstate = jstate._replace(ring_head=jnp.uint32(head),
                             ring_tail=jnp.uint32((head + cap) % 2 ** 32))
    tstate = tstate._replace(
        ring_head=torch.tensor(head - 2 ** 32, dtype=torch.int32),
        ring_tail=torch.tensor(((head + cap) % 2 ** 32), dtype=torch.int32))
    rng = np.random.default_rng(9)
    for step in range(4):
        ops = batch(rng, 12, 30, 2, weights=[0.1, 0.6, 0.25, 0.05])
        jout, tout = both_apply(jspec, tspec, jstate, tstate, ops)
        assert_apply_equal(jout, tout, f"{strategy} wrap step {step}")
        jstate, tstate = jout[0], tout[0]
    assert (int(tstate.ring_head) & 0xFFFFFFFF) < 2 ** 31   # it wrapped
    assert tch.free_slots_available(tstate) == \
        jch.free_slots_available(jstate)


def test_hash_u32_matches_reference():
    rng = np.random.default_rng(0)
    keys = np.concatenate([rng.integers(0, 2 ** 32, 1000, dtype=np.uint32),
                           np.asarray([0, 1, 2 ** 31, 2 ** 32 - 1],
                                      np.uint32)])
    got = tch.hash_u32(torch.from_numpy(keys.view(np.int32))).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32),
                                  np.asarray(jch.hash_u32(jnp.asarray(keys))))


@pytest.mark.parametrize("strategy", ["indirect", "cached_wf", "seqlock",
                                      "cached_me"])
def test_past_the_node_ring_the_port_equals_the_dict_oracle(strategy):
    """Many batches against a small p_max: the bucket table's node-pool
    layouts allocate more than 2 * p_max nodes.  The port's results and
    contents equal the dict oracle's throughout; the reference's INDIRECT
    and CACHED_WF bucket tables lose their nodes there (their free ring
    walks into its padding), so their logical buckets stop matching."""
    from repro.core import bigatomic as jba
    from repro_torch.core import engine as tengine
    jspec, tspec = specs(16, 1, strategy, 8, max_chain=8)
    jstate, tstate = jch.init_hash(jspec), tch.init_hash(tspec, device="cpu")
    model = {}
    rng = np.random.default_rng(4)
    for step in range(10):
        kind, keys, vals = batch(rng, 16, 50, 1,
                                 weights=[0.2, 0.5, 0.25, 0.05])
        ops = tch.make_hash_ops(kind, keys, vals, vw=1, device="cpu")
        model, want = tch.apply_reference(model, ops, vw=1)
        tstate, res, _ = tch.apply_hash(tspec, tstate, ops)
        np.testing.assert_array_equal(bits(res.found), want.found)
        np.testing.assert_array_equal(bits(res.value), want.value)
        jstate, _, _ = jch.apply_hash(
            jspec, jstate, jch.make_hash_ops(kind, keys, vals, vw=1))
    got = tch.items(tstate, inline=True, vw=1)
    assert got.keys() == model.keys()
    for key in model:
        np.testing.assert_array_equal(got[key], model[key])
    logical = bits(tengine.logical(tspec.cell_spec(), tstate.table))
    np.testing.assert_array_equal(logical, bits(tstate.table.data))
    if strategy in ("indirect", "cached_wf"):
        # the reference has installed NULL node pointers; the port has not
        assert (np.asarray(jstate.table.bptr) < 0).any()
        assert (bits(tstate.table.bptr).view(np.int32) >= 0).all()
        ref_logical = np.asarray(jba.logical(jstate.table, strategy))
        assert np.array_equal(ref_logical, np.asarray(jstate.table.data)) \
            == (strategy == "cached_wf")      # its reads go to the cache


class _Syncs(TorchDispatchMode):
    """Record dispatched operations that read a tensor back to the host
    or upload host data (on a card: a sync): scalar reads, data-dependent
    shapes, bool-mask indexing, tensors made from host values
    (`lift_fresh`: a write of a Python scalar into a tensor, say)."""

    SYNC = ("aten._local_scalar_dense", "aten.nonzero", "aten.masked_select",
            "aten.lift_fresh",
            "aten.unique", "aten._unique2", "aten.unique_consecutive",
            "aten.equal", "aten.is_nonzero", "aten.repeat_interleave")

    def __init__(self):
        super().__init__()
        self.syncs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        if name in self.SYNC:
            self.syncs.append(name)
        if name.startswith(("aten.index", "aten.index_put")):
            idx = args[1] if len(args) > 1 else ()
            if any(isinstance(t, torch.Tensor) and t.dtype == torch.bool
                   for t in (idx or ())):
                self.syncs.append(name + "(bool mask)")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("inline", [True, False])
@pytest.mark.parametrize("strategy", LOCK_FREE)
def test_one_host_read_per_apply_hash(strategy, inline, monkeypatch):
    """A mutating and a FIND-only `apply_hash` each read the host exactly
    once (`tolist` of the round count and flags) and dispatch no other
    operation that reads back; with host kinds too, where the check is
    made before upload."""
    tspec = TSpec(16, 2, strategy, 64, inline=inline)
    state = tch.init_hash(tspec, device="cpu")
    rng = np.random.default_rng(2)
    reads = []
    for name in ("tolist", "item", "__bool__", "__int__", "__index__",
                 "__float__", "numpy"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, _name=name, **kw):
            reads.append(_name)
            return _orig(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, counted)
    for kinds in ((FIND, INSERT, DELETE, IDLE), (FIND, IDLE)):
        kind, keys, vals = batch(rng, 20, 30, 2, kinds=kinds)
        ops = tch.make_hash_ops(kind, keys, vals, vw=2, device="cpu")
        reads.clear()
        with _Syncs() as rec:
            state, res, stats = tch.apply_hash(tspec, state, ops)
        assert reads == ["tolist"], reads
        assert rec.syncs == [], rec.syncs


def test_bad_kinds_are_rejected():
    tspec = TSpec(8, 1, "cached_me", 16)
    state = tch.init_hash(tspec, device="cpu")
    from repro_torch.core import engine as tengine
    ops = tengine.OpBatch(torch.tensor([FIND, 1], dtype=torch.int32),
                          torch.tensor([1, 2], dtype=torch.int32),
                          torch.zeros((2, 1), dtype=torch.int32),
                          torch.zeros((2, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="hash"):
        tch.apply_hash(tspec, state, ops)
    with pytest.raises(ValueError, match="hash"):
        tch.apply_hash(tspec, state, ops._replace(
            kind=np.asarray([FIND, 2], np.int32)))


def test_apply_hash_keeps_the_callers_state_unless_donated():
    tspec = TSpec(8, 1, "indirect", 16)
    state = tch.init_hash(tspec, device="cpu")
    before = [x.clone() for x in (*state.table, *state[1:])]
    ops = tch.make_hash_ops(np.full(4, INSERT, np.int32), [1, 2, 3, 4],
                            np.ones((4, 1), np.uint32), vw=1, device="cpu")
    new, _, _ = tch.apply_hash(tspec, state, ops)
    for a, b in zip((*state.table, *state[1:]), before):
        assert torch.equal(a, b)
    assert tch.items(new, inline=True, vw=1).keys() == {1, 2, 3, 4}
    donated, _, _ = tch.apply_hash(tspec, state, ops, donate=True)
    assert donated.pool.data_ptr() == state.pool.data_ptr()


@pytest.mark.parametrize("inline", [True, False])
def test_legacy_surface_matches_reference(inline):
    """The v1 `OpBatch` through `apply_hash_ops` (one warning), the
    stateful `CacheHash` insert / find / delete / items, and `init`."""
    deprecation.reset()
    rng = np.random.default_rng(12)
    q, vw = 12, 2
    kind = rng.integers(0, 4, q).astype(np.int32)
    kind[:6] = 1                                  # v1 INSERT
    keys = rng.integers(0, 20, q).astype(np.uint32)
    vals = rng.integers(0, 2 ** 32, (q, vw), dtype=np.uint32)
    jstate = jch.init(8, vw, "cached_wf", 64, inline=inline)
    tstate = tch.init(8, vw, "cached_wf", 64, inline=inline, device="cpu")
    assert_state_equal(jstate, tstate, "init")
    jops = jch.OpBatch(jnp.asarray(kind), jnp.asarray(keys),
                       jnp.asarray(vals))
    tops = tch.OpBatch(torch.from_numpy(kind),
                       torch.from_numpy(keys.view(np.int32)),
                       torch.from_numpy(vals.view(np.int32)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jout = jch.apply_hash_ops(jstate, jops, strategy="cached_wf",
                                  inline=inline, vw=vw)
    with pytest.warns(DeprecationWarning, match="apply_hash_ops"):
        tout = tch.apply_hash_ops(tstate, tops, strategy="cached_wf",
                                  inline=inline, vw=vw)
    assert_apply_equal(jout, tout, "apply_hash_ops")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tch.apply_hash_ops(tout[0], tops, strategy="cached_wf",
                           inline=inline, vw=vw)     # silent the 2nd time
    model, want = tch.apply_reference({}, tops, vw)
    np.testing.assert_array_equal(bits(tout[1].found), want.found)

    jt = jch.CacheHash(8, vw, "indirect", 64, inline=inline)
    tt = tch.CacheHash(8, vw, "indirect", 64, inline=inline, device="cpu")
    for name, args in (("insert", (keys[:8], vals[:8])),
                       ("find", (keys,)), ("delete", (keys[2:6],)),
                       ("find", (keys,))):
        jr, js = getattr(jt, name)(*args)
        tr, ts = getattr(tt, name)(*args)
        assert_apply_equal((jt.state, jr, js), (tt.state, tr, ts), name)
    assert tt.items().keys() == jt.items().keys()
    assert (tt.nb, tt.vw, tt.strategy, tt.inline, tt.max_chain) == \
        (jt.nb, jt.vw, jt.strategy, jt.inline, jt.max_chain)
