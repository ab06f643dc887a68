"""Optimistic transactional map over CacheHash (PyTorch).

A map transaction declares a READ SET (keys whose values it observes) and a
WRITE SET (keys it upserts or deletes, with write values computed by a
function of the read values).  A batch of T transactions executes
serializably: every committed transaction behaves as if its reads and
writes happened atomically at its commit point, in the claimed order
(commit round, then txn id).

Protocol, per attempt round (optimistic concurrency control, batch-step):

  1. read       one CacheHash FIND batch fetches every contending txn's
                read set.
  2. compute    `fn(read_values, read_found) -> write_values`.
  3. arbitrate  a txn wins iff no lower-id contending txn touches any of
                its written keys (read OR write) and no lower-id txn
                writes any of its read keys: two scatter-mins over the
                bucket domain (conservative: bucket-granular).  Winners are
                pairwise conflict-free, so their reads stay valid through
                every same-round commit.
  4. validate   winners re-FIND their read sets and compare against step 1.
  5. commit     ONE hash batch: DELETE lanes then INSERT lanes in lane
                order; CacheHash linearizes per bucket in lane order, so
                delete-then-insert is an atomic upsert; pure deletes skip
                the INSERT lane.

Losers retry after Dice-style backoff (`sync.queue.BackoffPolicy`); the
lowest contending txn id always wins, so every round commits at least one
txn and the loop terminates.  `transact` is a host loop over the port's
`cachehash.apply_hash` (one host read per hash batch) that reads its loop
condition once per round, where the reference runs a `lax.while_loop`;
`transact_dist` runs the same rounds over a mesh-sharded CacheHash
(`core.distributed.apply_hash_global`), with the reference's host loop.
Keys are words (int32 tensors holding the uint32 bits); `fn` is a plain
callable on tensors (word[T, R, vw], bool[T, R]) -> words[T, W, vw].
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import cachehash as ch
from repro_torch.core import distributed as dsb
from repro_torch.core import engine
from repro_torch.core.engine import DELETE, FIND, IDLE, INSERT, OpBatch
from repro_torch.core.layout import (WORD_DTYPE, TableState, as_words,
                                     resolve_device)
from repro_torch.core.specs import HashSpec
from repro_torch.sync.queue import BackoffPolicy
from repro_torch.txn.mcas import (_host, _host_words, _policy_delay,
                                  max_rounds_bound)


class MapTxns(NamedTuple):
    """T map transactions.

    read_key:    word[T, R]  keys observed (masked by read_mask)
    read_mask:   bool[T, R]
    write_key:   word[T, W]  keys written (masked by write_mask)
    write_mask:  bool[T, W]
    write_del:   bool[T, W]    True = delete the key; False = upsert
    write_value: word[T, W, vw] upsert values used when `fn is None`
    """

    read_key: torch.Tensor
    read_mask: torch.Tensor
    write_key: torch.Tensor
    write_mask: torch.Tensor
    write_del: torch.Tensor
    write_value: torch.Tensor

    @property
    def t(self) -> int:
        return self.read_key.shape[0]


class MapResult(NamedTuple):
    """read_value/read_found: each txn's read set AS OBSERVED at its commit
    point; round: 1-based commit round; attempts: arbitration losses;
    rounds: total rounds the batch took."""

    read_value: torch.Tensor
    read_found: torch.Tensor
    round: torch.Tensor
    attempts: torch.Tensor
    rounds: torch.Tensor


def make_map_txns(read_key, write_key, *, read_mask=None, write_mask=None,
                  write_del=None, write_value=None, vw: int = 1,
                  device="cuda") -> MapTxns:
    """Checked constructor: rank-2 key arrays sharing T, masks matching,
    no duplicate live write keys within one transaction (checked on the
    host).  `write_value` ([T, W, vw], coerced to words) feeds fn-less
    transactions; it defaults to zeros of width `vw`."""
    dev = resolve_device(device)
    wk_host = engine.host_copy(write_key)
    read_key = as_words(read_key, dev)
    write_key = as_words(write_key, dev)
    if read_key.dim() != 2 or write_key.dim() != 2:
        raise ValueError(f"keys must be rank-2 [T, ...]: read "
                         f"{tuple(read_key.shape)}, write "
                         f"{tuple(write_key.shape)}")
    t, r = read_key.shape
    tw, w = write_key.shape
    if tw != t:
        raise ValueError(f"read/write txn counts differ: {t} vs {tw}")

    def mask(m, shape, default):
        if m is None:
            return torch.full(shape, default, dtype=torch.bool, device=dev)
        m = torch.as_tensor(m).to(device=dev, dtype=torch.bool)
        if tuple(m.shape) != shape:
            raise ValueError(f"mask shape {tuple(m.shape)} != {shape}")
        return m

    wm_host = (np.ones((t, w), bool) if write_mask is None
               else engine.host_copy(write_mask))
    read_mask = mask(read_mask, (t, r), True)
    write_mask = mask(write_mask, (t, w), True)
    write_del = mask(write_del, (t, w), False)
    if write_value is None:
        write_value = torch.zeros((t, w, vw), dtype=WORD_DTYPE, device=dev)
    else:
        write_value = as_words(write_value, dev)
        if write_value.dim() != 3 or tuple(write_value.shape[:2]) != (t, w):
            raise ValueError(f"write_value shape {tuple(write_value.shape)} "
                             f"!= ({t}, {w}, vw)")
    if wk_host is not None and wm_host is not None:
        wk_host = _host_words(wk_host)
        wm_host = np.asarray(wm_host, bool)
        for i in range(t):
            live = wk_host[i][wm_host[i]]
            if len(np.unique(live)) != len(live):
                raise ValueError(f"transaction {i} writes duplicate keys: "
                                 f"{sorted(live.tolist())}")
    return MapTxns(read_key, read_mask, write_key, write_mask, write_del,
                   write_value)


def _winners(txns: MapTxns, active, nb: int):
    """Conflict arbitration over the bucket domain: txn i wins iff
    (a) no active j < i reads-or-writes any bucket i writes, and
    (b) no active j < i writes any bucket i reads.  The winner set is
    pairwise conflict-free and always contains the lowest active id.
    Each lowest id per bucket is a scatter-min into an (nb + 1)-sized
    buffer whose last entry takes the masked lanes, as the reference's."""
    t = txns.t
    dev = active.device
    gid = torch.arange(t, dtype=torch.int32, device=dev)

    def bucket(keys):
        return ch.hash_u32(keys) & (nb - 1)

    def scatter_min(b, mask):
        flat_b = torch.where(mask, b, nb).reshape(-1)
        flat_g = torch.where(mask, gid[:, None], t).reshape(-1)
        out = torch.full((nb + 1,), t, dtype=torch.int32, device=dev)
        return out.scatter_reduce_(0, flat_b, flat_g.to(torch.int32), "amin")

    rb = bucket(txns.read_key)
    wb = bucket(txns.write_key)
    r_live = txns.read_mask & active[:, None]
    w_live = txns.write_mask & active[:, None]
    wmin = scatter_min(wb, w_live)               # lowest active WRITER
    amin = torch.minimum(wmin, scatter_min(rb, r_live))  # lowest TOUCHER

    def per_txn_ok(cond, mask):
        return (cond | ~mask).all(1)

    ok_w = per_txn_ok(amin[wb] >= gid[:, None], w_live)
    ok_r = per_txn_ok(wmin[rb] >= gid[:, None], r_live)
    return active & ok_w & ok_r


def _hash_ops(kind, key, vw: int, value=None) -> OpBatch:
    """A hash batch in the unified schema from kinds the protocol made
    (known valid, so no check reads them back)."""
    q = key.shape[0]
    desired = (torch.zeros((q, vw), dtype=WORD_DTYPE, device=key.device)
               if value is None else value)
    return OpBatch(kind.to(torch.int32), key, torch.zeros_like(desired),
                   desired)


def _round(happly, spec: HashSpec, txns: MapTxns, fn, state, active):
    """One OCC attempt round.  Returns (state', committed[T],
    read_value[T,R,vw], read_found[T,R])."""
    t, vw = txns.t, spec.vw
    r = txns.read_key.shape[1]
    w = txns.write_key.shape[1]
    rk = txns.read_key.reshape(t * r)
    r_act = (txns.read_mask & active[:, None]).reshape(t * r)

    # 1. read ---------------------------------------------------------------
    state, res = happly(state, _hash_ops(torch.where(r_act, FIND, IDLE), rk,
                                         vw))
    rv = res.value.reshape(t, r, vw)
    rf = res.found.reshape(t, r)

    # 2. compute (fn=None: the txns carry their write values) ---------------
    wv = txns.write_value if fn is None else as_words(fn(rv, rf), rv.device)
    if tuple(wv.shape) != (t, w, vw):
        raise ValueError(f"fn returned shape {tuple(wv.shape)}, want "
                         f"({t}, {w}, {vw})")

    # 3. arbitrate ----------------------------------------------------------
    winner = _winners(txns, active, spec.nb)

    # 4. validate (winners re-read; must equal step 1) ----------------------
    v_act = (txns.read_mask & winner[:, None]).reshape(t * r)
    state, vres = happly(state, _hash_ops(torch.where(v_act, FIND, IDLE),
                                          rk, vw))
    vf = vres.found.reshape(t, r)
    vvals = vres.value.reshape(t, r, vw)
    same = (vf == rf) & ((vvals == rv).all(2) | ~rf)
    confirmed = winner & (same | ~txns.read_mask).all(1)

    # 5. commit: DELETE lanes then INSERT lanes, one batch ------------------
    wk = txns.write_key.reshape(t * w)
    d_lane = (txns.write_mask & confirmed[:, None]).reshape(t * w)
    i_lane = d_lane & ~txns.write_del.reshape(t * w)
    kinds = torch.cat([torch.where(d_lane, DELETE, IDLE),
                       torch.where(i_lane, INSERT, IDLE)])
    vals = torch.cat([torch.zeros((t * w, vw), dtype=WORD_DTYPE,
                                  device=wk.device), wv.reshape(t * w, vw)])
    state, _ = happly(state, _hash_ops(kinds, torch.cat([wk, wk]), vw, vals))
    return state, confirmed, rv, rf


def _own_hash(state: ch.HashState) -> ch.HashState:
    """A copy of a CacheHash state the round loop may update in place."""
    return ch.HashState(TableState(*(x.clone() for x in state.table)),
                        *(x.clone() for x in state[1:]))


def transact(spec: HashSpec, state, txns: MapTxns, fn, *,
             policy: BackoffPolicy = BackoffPolicy("none"),
             max_rounds: int | None = None):
    """Run a batch of map transactions to serializable commit.

    `fn(read_values word[T,R,vw], read_found bool[T,R]) -> write_values
    [T,W,vw]` is a callable on tensors (None: the txns' `write_value`).
    Each round is three `apply_hash` batches (one host read each) and one
    host read of the loop condition.  `state` is copied once on entry, so
    the caller's stays valid.  Returns (state', MapResult); the claimed
    serialization is `linearization_order(result)`."""
    if max_rounds is None:
        max_rounds = max_rounds_bound(txns.t, policy)
    t, vw = txns.t, spec.vw
    r = txns.read_key.shape[1]
    dev = txns.read_key.device
    state = _own_hash(state)

    def happly(st, ops):
        st, res, _ = ch.apply_hash(spec, st, ops, donate=True)
        return st, res

    def zeros(shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    rnd = zeros(())
    pending = torch.ones((t,), dtype=torch.bool, device=dev)
    round_res, attempts, delay = zeros((t,)), zeros((t,)), zeros((t,))
    orv, orf = zeros((t, r, vw), WORD_DTYPE), zeros((t, r), torch.bool)
    go = max_rounds > 0 and t > 0          # all pending at the start
    while go:
        rnd = rnd + 1
        active = pending & (delay <= 0)
        state, committed, rv, rf = _round(happly, spec, txns, fn, state,
                                          active)
        orv = torch.where(committed[:, None, None], rv, orv)
        orf = torch.where(committed[:, None], rf, orf)
        round_res = torch.where(committed, rnd, round_res)
        pending = pending & ~committed
        lost = active & ~committed
        attempts = attempts + lost.to(torch.int32)
        delay = torch.where(lost, _policy_delay(policy, attempts),
                            (delay - 1).clamp(min=0))
        go = bool((rnd < max_rounds) & pending.any())    # host read
    return state, MapResult(orv, orf, round_res, attempts, rnd)


def transact_dist(mesh, dspec, dstate, txns: MapTxns, fn, *,
                  policy: BackoffPolicy = BackoffPolicy("none"),
                  max_rounds: int | None = None):
    """`transact` over a mesh-sharded CacheHash: the same round logic, but
    every hash batch routes by key owner through
    `distributed.apply_hash_global` (capacity = the whole batch, so no
    lane overflows), so transactions whose read / write sets span shards
    commit atomically.  Every rank of the mesh calls it with the same
    `txns` and its own shard's `dstate` (copied once on entry) and gets
    the same `MapResult`; arbitration runs over the global `dspec.inner`.

    The host loop is the reference's: a round in which every pending txn
    is backing off runs no batch; losers' delays are set after the
    others' count down.  Raises RuntimeError when `max_rounds` rounds
    leave a txn pending."""
    hs: HashSpec = dspec.inner
    if max_rounds is None:
        max_rounds = max_rounds_bound(txns.t, policy)
    dev = mesh.device
    dstate = dsb.DistState(_own_hash(dstate.local), mesh)

    def happly(st, ops):
        st, res, _ovf = dsb.apply_hash_global(mesh, dspec, st, ops,
                                              whole_batch_route=True,
                                              donate=True)
        return st, res

    t, vw = txns.t, hs.vw
    r = txns.read_key.shape[1]
    pending = np.ones((t,), bool)
    round_res = np.zeros((t,), np.int32)
    attempts = np.zeros((t,), np.int32)
    delay = np.zeros((t,), np.int32)
    orv = np.zeros((t, r, vw), np.uint32)
    orf = np.zeros((t, r), bool)
    rnd = 0
    while pending.any() and rnd < max_rounds:
        rnd += 1
        active = pending & (delay <= 0)
        if not active.any():
            delay = np.maximum(delay - 1, 0)
            continue
        dstate, committed, rv, rf = _round(
            happly, hs, txns, fn, dstate, torch.from_numpy(active).to(dev))
        committed = _host(committed)
        orv = np.where(committed[:, None, None], _host_words(rv), orv)
        orf = np.where(committed[:, None], _host(rf), orf)
        round_res = np.where(committed, rnd, round_res).astype(np.int32)
        pending &= ~committed
        lost = active & ~committed
        attempts = attempts + lost.astype(np.int32)
        delay = np.maximum(delay - 1, 0)
        for i in np.nonzero(lost)[0]:
            delay[i] = policy.delay(int(attempts[i]))
    if pending.any():
        raise RuntimeError(f"transact_dist round bound exceeded "
                           f"({max_rounds}); pending="
                           f"{np.nonzero(pending)[0].tolist()}")
    return dstate, MapResult(
        torch.from_numpy(orv.view(np.int32)).to(dev),
        torch.from_numpy(orf).to(dev), torch.from_numpy(round_res).to(dev),
        torch.from_numpy(attempts).to(dev),
        torch.tensor(rnd, dtype=torch.int32, device=dev))


def linearization_order(result: MapResult) -> np.ndarray:
    """Txn ids in the claimed serialization: commit round, then txn id."""
    rnd = _host(result.round)
    ids = np.arange(rnd.shape[0])
    return ids[np.lexsort((ids, rnd))]


def transact_reference(model: dict, txns: MapTxns, fn, order, vw: int):
    """Sequential replay defining the semantics: apply whole transactions
    one at a time in `order` against a dict model (int key -> uint32[vw]);
    `fn` is called on CPU tensors of one txn.  Returns (model',
    read_value[T,R,vw], read_found[T,R])."""
    rk = _host_words(txns.read_key)
    rm = _host(txns.read_mask)
    wk = _host_words(txns.write_key)
    wm = _host(txns.write_mask)
    wd = _host(txns.write_del)
    wvals = _host_words(txns.write_value)
    t, r = rk.shape
    w = wk.shape[1]
    out_v = np.zeros((t, r, vw), np.uint32)
    out_f = np.zeros((t, r), bool)
    for i in np.asarray(order, np.int64):
        rv = np.zeros((1, r, vw), np.uint32)
        rf = np.zeros((1, r), bool)
        for j in range(r):
            if rm[i, j] and int(rk[i, j]) in model:
                rv[0, j] = model[int(rk[i, j])]
                rf[0, j] = True
        wv = wvals[i] if fn is None else _host_words(
            fn(torch.from_numpy(rv.view(np.int32)),
               torch.from_numpy(rf)))[0]
        for j in range(w):
            if not wm[i, j]:
                continue
            key = int(wk[i, j])
            if wd[i, j]:
                model.pop(key, None)
            else:
                model[key] = np.asarray(wv[j], np.uint32).copy()
        out_v[i], out_f[i] = rv[0], rf[0]
    return model, out_v, out_f
