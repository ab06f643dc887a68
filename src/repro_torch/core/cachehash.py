"""CacheHash — the paper's §4 separate-chaining hash table with the first
link *inlined* into the bucket array as a big atomic, plus the no-inline
`Chaining` baseline (PyTorch).

Bucket cell layout (a big atomic of ``cellw = 2 + vw`` words):
    [key, value(vw words), next]
``next`` codes: EMPTY (no first link — length-0 list), NULLP (no successor —
length-1 list), else an index into the chain-node pool.  The distinction
between EMPTY and NULLP is the paper's stolen flag bit.  The Chaining
baseline's cell is one word, the chain's head code.

Semantics (faithful to §4):
  find    — walk the chain, return the value if present.
  insert  — add-if-absent; new elements become the *inlined first link*, the
            previous first link is copied out to a fresh pool node.
  delete  — inline hit: the successor node (if any) is copied INTO the bucket
            and retired; chain hit: *path copying* — links ahead of the victim
            are copied to fresh nodes, the bucket's big-atomic cell is CAS'd
            to the new chain head, old links retired.

Chain nodes are written once and are immutable until retired; only the
bucket cell mutates, which is why it must be a big atomic.  The bucket
array is a `TableState` of the spec's strategy, and its layout is kept by
that strategy's `commit`, so CacheHash over seqlock / cached_me / cached_wf
/ indirect and the Chaining baseline are one implementation.

Batch execution mirrors the unified engine: ops are grouped by bucket
(`torch.sort(stable=True)`) and serialized per bucket in lane order
(`L = max ops per bucket` rounds); rounds touch disjoint buckets, so every
scatter of a round writes distinct rows.  A batch with no INSERT/DELETE is
one chain walk over the live table (`_find_only`).  Pool slots come from
an explicit FIFO ring (head = alloc cursor, tail = free cursor), the
deterministic stand-in for the paper's hazard-pointer reclamation.

The reference (`repro.core.cachehash`) runs its rounds as plain `jnp`
outside any Pallas kernel, so they are plain PyTorch tensor operations
here.  Differences of form:

  * words are int32 tensors holding the uint32 bits; the hash, the codes
    and the ring cursors, which need unsigned arithmetic, go through
    int64 (`as_u64` / `to_word`) and give the reference's bits for every
    word;
  * gathers normalize and clamp their index as the reference's do, and
    scatters drop an out-of-range index as its `mode="drop"` does;
  * the round loop and the FIND-only branch are chosen on the host: each
    `apply_hash` reads (rounds, any INSERT/DELETE, any bad kind) back in
    ONE copy — exactly one host sync per call — where the reference's
    `lax.while_loop` / `lax.cond` decide on the device;
  * the layout's `commit` is handed the modified buckets in ascending order
    (from the sorted buckets, no pass over the table), their number and
    the number of modifications, the reference's `n_upd`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import bigatomic as ba
from repro_torch.core import engine
from repro_torch.core.deprecation import warn_once
from repro_torch.core.layout import (WORD_DTYPE, TableState, as_u64,
                                     as_words, clamped_index, gather_rows,
                                     resolve_device, scatter_set, to_word)
from repro_torch.core.registry import get_strategy
from repro_torch.core.specs import DEFAULT_STRATEGY, HashSpec

# Legacy kind numbering (v1).  The unified namespace uses engine.FIND /
# INSERT / DELETE; `_TO_UNIFIED` maps v1 batches onto it.
FIND = 0
INSERT = 1
DELETE = 2
IDLE = 3

_TO_UNIFIED = (engine.FIND, engine.INSERT, engine.DELETE, engine.IDLE)

EMPTY = -1        # 0xFFFFFFFF: bucket has no first link
NULLP = -2        # 0xFFFFFFFE: link has no successor
_MASK = 0xFFFFFFFF


def _is_node(code: torch.Tensor) -> torch.Tensor:
    """The reference's `code < _CODE_MIN` on the uint32 word: every word
    but EMPTY and NULLP names a pool node."""
    return (code != EMPTY) & (code != NULLP)


class HashState(NamedTuple):
    """The table's tensors (words as int32 bits)."""

    table: TableState        # bucket cells [nb, cellw] (+ strategy fields)
    pool: torch.Tensor       # chain nodes [cap, 2+vw]
    free_ring: torch.Tensor  # int32[cap] FIFO ring of free pool slots
    ring_head: torch.Tensor  # word alloc cursor (monotonic, used mod cap)
    ring_tail: torch.Tensor  # word free cursor  (monotonic, used mod cap)
    count: torch.Tensor      # word: live elements


class HashResult(NamedTuple):
    found: torch.Tensor      # FIND: key present; INSERT/DELETE: op succeeded
    value: torch.Tensor      # FIND: the value (zeros if absent)
    overflow: torch.Tensor   # walk exceeded max_chain (should never fire)


class HashStats(NamedTuple):
    rounds: torch.Tensor      # int32: bucket-contention serialization rounds
    chain_steps: torch.Tensor  # int32: dependent pool gathers
    inline_hits: torch.Tensor  # int32: live ops resolved at the first link
    allocs: torch.Tensor      # word
    frees: torch.Tensor       # word


class OpBatch(NamedTuple):
    """Legacy 3-field hash batch (v1).  New code: `make_hash_ops`."""

    kind: torch.Tensor       # int32[q]  (v1 numbering)
    key: torch.Tensor        # word[q]
    value: torch.Tensor      # word[q, vw]


def make_hash_ops(kind, key, value=None, *, vw: int,
                  device="cuda") -> engine.OpBatch:
    """Build a unified-schema hash batch: `slot` carries the uint32 key
    bit-pattern, `desired[:, :vw]` the value.  Kinds are the unified
    FIND/INSERT/DELETE/IDLE constants."""
    dev = resolve_device(device)
    return engine.make_ops(kind, as_words(key, dev), desired=value, k=vw,
                           device=dev)


def _to_unified(ops) -> engine.OpBatch:
    """Accept a legacy 3-field OpBatch or a unified batch; return unified."""
    if isinstance(ops, OpBatch) or hasattr(ops, "key"):
        dev = ops.kind.device
        table = torch.tensor(_TO_UNIFIED, dtype=torch.int32, device=dev)
        return make_hash_ops(table[ops.kind.long().clamp(0, 3)], ops.key,
                             ops.value, vw=ops.value.shape[1], device=dev)
    return ops


def hash_u32(key: torch.Tensor) -> torch.Tensor:
    """splitmix-style avalanche of the uint32 key bits, as int64 in
    [0, 2^32); buckets = hash & (nb-1).  The multiplies wrap at 2^32 as the
    reference's uint32 ones do."""
    h = as_u64(key)
    h = ((h ^ (h >> 16)) * 0x45D9F3B) & _MASK
    h = ((h ^ (h >> 16)) * 0x45D9F3B) & _MASK
    return h ^ (h >> 16)


def _word(x: int, device) -> torch.Tensor:
    return to_word(torch.tensor(x, dtype=torch.int64, device=device))


def _empty_cells(shape, device) -> torch.Tensor:
    """Zero words with the last word of each cell EMPTY, made on `device`
    (a pad, not a write of a host scalar, which would upload it)."""
    zeros = torch.zeros((*shape[:-1], shape[-1] - 1), dtype=WORD_DTYPE,
                        device=device)
    return torch.nn.functional.pad(zeros, (0, 1), value=EMPTY)


def init_hash(spec: HashSpec, *, device="cuda") -> HashState:
    """Build the initial `HashState` for `spec` on `device`."""
    dev = resolve_device(device)
    nb, vw, cellw = spec.nb, spec.vw, spec.cellw
    data = _empty_cells((nb, cellw), dev)
    table = get_strategy(spec.strategy).init(nb, cellw, spec.p_max, data)
    cap = spec.pool_cap
    return HashState(table,
                     torch.zeros((cap, 2 + vw), dtype=WORD_DTYPE, device=dev),
                     torch.arange(cap, dtype=torch.int32, device=dev),
                     _word(0, dev), _word(cap, dev), _word(0, dev))


def init(nb: int, vw: int, strategy, p_max: int, *, inline: bool = True,
         chain_factor: float = 2.0, device="cuda") -> HashState:
    """DEPRECATED shim: use `init_hash(HashSpec(...))`."""
    return init_hash(HashSpec(nb, vw, ba.strategy_name(strategy), p_max,
                              inline=inline, chain_factor=chain_factor),
                     device=device)


# ---------------------------------------------------------------------------
# Sequential oracle (python dict) — defines the semantics.
# ---------------------------------------------------------------------------

def _np_words(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy().view(np.uint32) if x.dtype == WORD_DTYPE \
            else x.cpu().numpy()
    return np.asarray(x)


def apply_reference(model: dict, ops, vw: int):
    """Apply the batch one op at a time in lane order to `model` (a dict
    key -> uint32[vw]).  Returns (model, HashResult-as-numpy)."""
    ops = _to_unified(ops)
    kind = _np_words(ops.kind)
    key = _np_words(ops.slot).astype(np.uint32)
    value = _np_words(ops.desired)[:, :vw].astype(np.uint32)
    q = kind.shape[0]
    found = np.zeros(q, bool)
    out = np.zeros((q, vw), np.uint32)
    for i in range(q):
        k = int(key[i])
        if kind[i] == engine.FIND:
            if k in model:
                found[i] = True
                out[i] = model[k]
        elif kind[i] == engine.INSERT:
            if k not in model:        # add-if-absent (paper semantics)
                model[k] = value[i].copy()
                found[i] = True
        elif kind[i] == engine.DELETE:
            if k in model:
                del model[k]
                found[i] = True
    return model, HashResult(found, out, np.zeros(q, bool))


# ---------------------------------------------------------------------------
# Vectorized batched ops.
# ---------------------------------------------------------------------------

def _put(dst: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
         live: torch.Tensor) -> None:
    """In place: `dst[idx[i]] = vals[i]` for live lanes, the reference's
    `.at[idx].set(vals, mode="drop")` with dead lanes at an out-of-range
    index: a negative index counts from the end, one still outside
    [0, m) is dropped.  Live targets are distinct (one lane per bucket
    per round, distinct pool slots)."""
    m = dst.shape[0]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + m, idx)
    live = live & (idx >= 0) & (idx < m)
    vals = vals.to(dst.dtype)
    if vals.dim() < dst.dim():
        vals = vals.expand(idx.shape[0], *dst.shape[1:])
    scatter_set(dst, idx.clamp(0, m - 1), vals, live)


def _sum(x: torch.Tensor) -> torch.Tensor:
    return x.sum(dtype=torch.int64)


class _Walk(NamedTuple):
    cell: torch.Tensor         # word[q, cellw] the bucket cell
    is_empty: torch.Tensor     # bool[q]
    found_depth: torch.Tensor  # int64[q]: 0 inline, j+1 pool depth, -1 none
    vis: torch.Tensor          # int32[q, max_chain] nodes visited, -1 none
    steps: torch.Tensor        # int64[q] pool gathers
    overflow: torch.Tensor     # bool[q]


def _walk(spec: HashSpec, data, pool, b_idx, key) -> _Walk:
    """Vectorized bounded chain walk (the reference's `walk`)."""
    nb, cap = data.shape[0], pool.shape[0]
    cell = gather_rows(data, b_idx.clamp(max=nb - 1).long())
    q = key.shape[0]
    if spec.inline:
        c_next = cell[:, -1]
        is_empty = c_next == EMPTY
        found0 = ~is_empty & (cell[:, 0] == key)
        cur = torch.where(found0 | is_empty, NULLP, c_next)
    else:
        c_next = cell[:, 0]
        is_empty = c_next == EMPTY
        found0 = torch.zeros_like(is_empty)
        cur = torch.where(is_empty, NULLP, c_next)
    found_depth = torch.where(found0, 0, -1)
    steps = torch.zeros((q,), dtype=torch.int64, device=key.device)
    vis = []
    for j in range(spec.max_chain):
        is_node = _is_node(cur) & (found_depth < 0)
        row = gather_rows(pool,
                          clamped_index(torch.where(is_node, cur, 0), cap))
        hit = is_node & (row[:, 0] == key)
        found_depth = torch.where(hit, j + 1, found_depth)
        vis.append(torch.where(is_node, cur, -1))
        steps = steps + is_node
        cur = torch.where(is_node & ~hit, row[:, -1], NULLP)
    overflow = _is_node(cur) & (found_depth < 0)
    return _Walk(cell, is_empty, found_depth, torch.stack(vis, 1), steps,
                 overflow)


def _found_value(spec: HashSpec, w: _Walk, pool):
    """(found node index, found value) from a walk: the inlined first link
    when found_depth == 0, else the pool node at that depth.  The one
    definition of FIND value extraction, shared by the round loop and the
    FIND-only branch."""
    vw, cap = spec.vw, pool.shape[0]
    fd = w.found_depth
    node_at_fd = w.vis.gather(
        1, (fd - 1).clamp(0, spec.max_chain - 1)[:, None])[:, 0]
    pool_val = gather_rows(pool,
                           clamped_index(node_at_fd.clamp(min=0), cap))
    pool_val = pool_val[:, 1:1 + vw]
    if spec.inline:
        inline_val = w.cell[:, 1:1 + vw]
    else:
        inline_val = torch.zeros_like(pool_val)
    return node_at_fd, torch.where((fd == 0)[:, None], inline_val, pool_val)


class _Sorted(NamedTuple):
    """The batch grouped by bucket (stable), inactive lanes at nb."""

    order: torch.Tensor
    bucket: torch.Tensor       # int32[q] sorted
    kind: torch.Tensor
    key: torch.Tensor          # word[q]
    value: torch.Tensor        # word[q, vw]
    rank: torch.Tensor         # int64[q] position in the bucket's segment
    active: torch.Tensor       # bool[q]


def _sort(spec: HashSpec, ops: engine.OpBatch) -> _Sorted:
    nb, q = spec.nb, ops.p
    active = ops.kind != engine.IDLE
    bucket = torch.where(active, (hash_u32(ops.slot) & (nb - 1)).to(
        torch.int32), nb)
    s_bucket, order = torch.sort(bucket, stable=True)
    idx = torch.arange(q, dtype=torch.int64, device=bucket.device)
    seg_start = torch.ones(q, dtype=torch.bool, device=bucket.device)
    seg_start[1:] = s_bucket[1:] != s_bucket[:-1]
    start_idx = torch.cummax(torch.where(seg_start, idx, -1), 0).values
    return _Sorted(order, s_bucket, ops.kind[order], ops.slot[order],
                   ops.desired[order, :spec.vw], idx - start_idx,
                   active[order])


class _Carry:
    """The round loop's state: the tables (updated in place) and the
    per-lane results and counts."""

    def __init__(self, state: HashState, q: int, vw: int):
        dev = state.pool.device
        self.data = state.table.data
        self.ver = state.table.version
        self.pool = state.pool
        self.ring = state.free_ring
        self.head = as_u64(state.ring_head)
        self.tail = as_u64(state.ring_tail)
        self.count = as_u64(state.count)
        self.found = torch.zeros((q,), dtype=torch.bool, device=dev)
        self.value = torch.zeros((q, vw), dtype=WORD_DTYPE, device=dev)
        self.over = torch.zeros((q,), dtype=torch.bool, device=dev)
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        self.chain_steps = self.inline_hits = self.allocs = self.frees = zero
        self.n_upd = zero
        self.modified = torch.zeros((q,), dtype=torch.bool, device=dev)


def _round(spec: HashSpec, s: _Sorted, c: _Carry, t: int) -> None:
    """One serialization round (the reference's `round_body`): the t-th op
    of every bucket, in place on the carry."""
    inline, vw, max_chain = spec.inline, spec.vw, spec.max_chain
    nb, cap = c.data.shape[0], c.pool.shape[0]
    q = s.kind.shape[0]
    cellw_pool = 2 + vw
    grab_n = min(q * max_chain, cap)
    live = s.active & (s.rank == t) & (s.bucket < nb)
    w = _walk(spec, c.data, c.pool, s.bucket, s.key)
    fd, vis, cell, is_empty = w.found_depth, w.vis, w.cell, w.is_empty
    found = fd >= 0
    c.chain_steps = c.chain_steps + _sum(torch.where(live, w.steps, 0))
    c.inline_hits = c.inline_hits + _sum(live & ((fd == 0) | is_empty))

    # ---- FIND ---------------------------------------------------------------
    f_live = live & (s.kind == engine.FIND)
    node_at_fd, fval = _found_value(spec, w, c.pool)
    c.value = torch.where((f_live & found)[:, None], fval, c.value)
    c.found = torch.where(f_live, found, c.found)

    # ---- allocation plan (conflict-free: disjoint buckets) ------------------
    i_live = live & (s.kind == engine.INSERT) & ~found & ~w.overflow
    d_live = live & (s.kind == engine.DELETE) & found
    ins_need = (i_live & ~is_empty if inline else i_live).long()
    del_need = torch.where(d_live & (fd >= 1), (fd - 1).clamp(min=0), 0)
    need = ins_need + del_need
    off = torch.cumsum(need, 0) - need
    total = _sum(need)
    ranks = torch.arange(grab_n, dtype=torch.int64, device=c.pool.device)
    grab = c.ring[((c.head + ranks) & _MASK) % cap]

    def slot_at(o):
        return grab[o.clamp(0, grab_n - 1)]

    c.head = (c.head + total) & _MASK
    c.allocs = c.allocs + total

    # ---- INSERT ---------------------------------------------------------------
    new_node = slot_at(off)
    if inline:
        _put(c.pool, new_node, cell, i_live & ~is_empty)  # displaced link
        new_next = torch.where(is_empty, NULLP, new_node)
        _put(c.data, s.bucket,
             torch.cat([s.key[:, None], s.value, new_next[:, None]], 1),
             i_live)
    else:
        old_head = torch.where(is_empty, NULLP, cell[:, 0])
        _put(c.pool, new_node,
             torch.cat([s.key[:, None], s.value, old_head[:, None]], 1),
             i_live)
        _put(c.data[:, 0], s.bucket, new_node, i_live)
    c.found = torch.where(live & (s.kind == engine.INSERT), i_live, c.found)

    # ---- DELETE -----------------------------------------------------------------
    # Case A (inline only): the victim is the inlined first link (fd == 0).
    freed_a = torch.full((q,), -1, dtype=torch.int32, device=c.pool.device)
    if inline:
        a_live = d_live & (fd == 0)
        succ = cell[:, -1]
        has_succ = _is_node(succ)
        empty_cell = _empty_cells((spec.cellw,), c.data.device)
        _put(c.data, s.bucket, empty_cell, a_live & ~has_succ)
        succ_i = torch.where(has_succ, succ, 0)
        _put(c.data, s.bucket,
             gather_rows(c.pool, clamped_index(succ_i, cap)),
             a_live & has_succ)
        freed_a = torch.where(a_live & has_succ, succ_i, freed_a)

    # Case B: the victim at chain depth fd >= 1 -> path copy.
    b_live = d_live & (fd >= 1)
    tail_code = gather_rows(c.pool,
                            clamped_index(node_at_fd.clamp(min=0), cap))
    tail_code = tail_code[:, -1]
    ncopies = torch.where(b_live, (fd - 1).clamp(min=0), 0)
    copy_base = off + ins_need
    new_head_code = torch.where(ncopies > 0, slot_at(copy_base), tail_code)
    # The links ahead of the victim (depth j + 1, j < ncopies) copied to
    # fresh slots, each pointing at the next copy (the last at the tail),
    # all (lane, j) pairs in one scatter: the reference's loop over j
    # writes fresh slots only, so no copy reads another's destination.
    j = torch.arange(max_chain - 1, device=c.pool.device)[None, :]
    nxt = torch.where(j + 1 < ncopies[:, None],
                      slot_at(copy_base[:, None] + j + 1), tail_code[:, None])
    rows = gather_rows(c.pool,
                       clamped_index(vis[:, :-1].clamp(min=0), cap)
                       .reshape(-1)).view(q, max_chain - 1, cellw_pool)
    rows = torch.cat([rows[..., :-1], nxt[..., None]], -1)
    _put(c.pool, slot_at(copy_base[:, None] + j).reshape(-1),
         rows.reshape(-1, cellw_pool),
         (b_live[:, None] & (j < ncopies[:, None])).reshape(-1))
    if inline:
        _put(c.data[:, -1], s.bucket, new_head_code, b_live)
    else:
        _put(c.data[:, 0], s.bucket,
             torch.where(new_head_code == NULLP, EMPTY, new_head_code),
             b_live)
    c.found = torch.where(live & (s.kind == engine.DELETE), d_live, c.found)
    c.over = torch.where(live, w.overflow, c.over)

    # ---- retire: case A successor, case B originals(1..fd-1) + victim ------
    n_retired = torch.where(b_live, fd, 0) + (freed_a >= 0)
    roff = torch.cumsum(n_retired, 0) - n_retired
    j = torch.arange(max_chain, device=c.pool.device)[None, :]
    src = torch.where(b_live[:, None], vis,
                      torch.where(j == 0, freed_a[:, None], -1))
    _put(c.ring, (((c.tail + roff[:, None] + j) & _MASK) % cap).reshape(-1),
         src.reshape(-1),
         ((j < n_retired[:, None]) & (src >= 0)).reshape(-1))
    rtotal = _sum(n_retired)
    c.tail = (c.tail + rtotal) & _MASK
    c.frees = c.frees + rtotal

    c.count = (c.count + _sum(i_live) - _sum(d_live)) & _MASK
    modified = i_live | d_live
    c.ver.index_add_(0, s.bucket.clamp(max=nb - 1).long(),
                     2 * modified.to(c.ver.dtype))
    c.n_upd = c.n_upd + _sum(modified)
    c.modified = c.modified | modified


def _find_only(spec: HashSpec, state: HashState, s: _Sorted, c: _Carry):
    """The probe fast path: FINDs commute even on the same bucket, so a
    mutation-free batch is ONE chain walk over the live table — no round
    loop, no alloc/retire, state untouched."""
    nb = state.table.version.shape[0]
    w = _walk(spec, state.table.data, state.pool, s.bucket, s.key)
    found = w.found_depth >= 0
    live = s.active & (s.bucket < nb)
    f_live = live & (s.kind == engine.FIND)
    _, fval = _found_value(spec, w, state.pool)
    c.value = torch.where((f_live & found)[:, None], fval, 0)
    c.found = f_live & found
    c.over = live & w.overflow
    c.chain_steps = _sum(torch.where(live, w.steps, 0))
    c.inline_hits = _sum(live & ((w.found_depth == 0) | w.is_empty))


def apply_hash(spec: HashSpec, state: HashState, ops: engine.OpBatch, *,
               donate: bool = False):
    """Apply a batch of FIND/INSERT/DELETE ops, linearized in lane order.

    `ops` is in the unified schema (`make_hash_ops`) on the state's device.
    Reads (rounds, any INSERT/DELETE, kinds outside FIND/INSERT/DELETE/IDLE)
    back to the host in ONE copy: exactly one host sync per call.  By
    default the state is copied before a mutating batch, so the caller's
    `state` stays valid; `donate=True` updates its buffers in place (the
    caller must not reuse it).

    Returns (new_state, HashResult, HashStats)."""
    dev = state.pool.device
    if not isinstance(ops.kind, torch.Tensor):    # host kinds: check here
        engine.check_kinds(ops.kind, engine.HASH_KINDS, "hash")
    ops = engine.canonicalize_ops(ops, dev)
    q = ops.p
    s = _sort(spec, ops)
    nb = state.table.version.shape[0]
    n_rounds = torch.where(s.active, s.rank, -1).max() + 1 if q else \
        torch.zeros((), dtype=torch.int64, device=dev)
    has_mut = ((ops.kind == engine.INSERT) | (ops.kind == engine.DELETE)
               ).any()
    bad = ~((ops.kind == engine.FIND) | (ops.kind == engine.INSERT)
            | (ops.kind == engine.DELETE) | (ops.kind == engine.IDLE))
    n_rounds, has_mut, n_bad = torch.stack(
        [n_rounds, has_mut.long(), bad.sum()]).tolist()   # the host sync
    if n_bad:
        engine.check_kinds(ops.kind, engine.HASH_KINDS, "hash")
    if not has_mut:
        c = _Carry(state, q, spec.vw)
        _find_only(spec, state, s, c)
        new_state = state
    else:
        if not donate:
            state = HashState(TableState(*(x.clone() for x in state.table)),
                              *(x.clone() for x in state[1:]))
        c = _Carry(state, q, spec.vw)
        for t in range(n_rounds):
            _round(spec, s, c, t)
        new_state = _commit(spec, state, s, c, q)
    inv = torch.empty_like(s.order)
    inv[s.order] = torch.arange(q, dtype=s.order.dtype, device=dev)
    result = HashResult(c.found[inv], c.value[inv], c.over[inv])
    stats = HashStats(
        torch.full((), n_rounds, dtype=torch.int32, device=dev),
        c.chain_steps.to(torch.int32), c.inline_hits.to(torch.int32),
        to_word(c.allocs), to_word(c.frees))
    return new_state, result, stats


def _commit(spec: HashSpec, state: HashState, s: _Sorted, c: _Carry,
            q: int) -> HashState:
    """Reconcile the bucket table's layout: the modified buckets in
    ascending order (from the sorted buckets), their number, and the number
    of modifications (the reference's `n_upd`, which CACHED_ME's ring
    advance reads)."""
    nb = state.table.version.shape[0]
    idx, seg_start, _, end_idx = engine._segments(s.bucket)
    starts = (seg_start & engine._any_from_here(c.modified, idx, end_idx)
              & (s.bucket < nb))
    dirty = engine.compact_starts(nb, s.bucket, starts)
    zero = torch.zeros((), dtype=torch.int32, device=dirty.device)
    stats = engine.ApplyStats(zero, c.n_upd.to(torch.int32), zero, zero,
                              zero, starts.sum(dtype=torch.int32))
    table = get_strategy(spec.strategy).commit(
        state.table, c.data, c.ver, stats, dirty, min(q, nb))
    return HashState(table, c.pool, c.ring, to_word(c.head),
                     to_word(c.tail), to_word(c.count))


def apply_hash_ops(state: HashState, ops, *, strategy: str, inline: bool,
                   vw: int, max_chain: int = 8):
    """DEPRECATED shim: use `apply_hash(HashSpec(...), state, ops)`.
    Warns `DeprecationWarning` once per process."""
    warn_once("core.cachehash.apply_hash_ops",
              "cachehash.apply_hash(HashSpec(...), state, ops)")
    nb = state.table.version.shape[0]
    spec = HashSpec(nb, vw, ba.strategy_name(strategy), inline=inline,
                    max_chain=max_chain)
    return apply_hash(spec, state, _to_unified(ops))


# ---------------------------------------------------------------------------
# Host-side inspection: enumerate the table's contents.
# ---------------------------------------------------------------------------

def contents(state: HashState, *, inline: bool, vw: int):
    """Every (key, value) the table holds, as numpy arrays (uint32[m],
    uint32[m, vw]) in the order `items` walks them: bucket by bucket, the
    inlined link first, then down the chain.  Walks all chains at once, a
    depth per step (at most 10 000 pool links per chain, as `items`)."""
    data = _np_words(state.table.data)
    pool = _np_words(state.pool)
    nb = data.shape[0]
    buckets = np.arange(nb)
    parts = []                                       # (bucket, depth, rows)
    if inline:
        has = data[:, -1] != np.uint32(0xFFFFFFFF)
        parts.append((buckets[has], np.zeros(has.sum(), np.int64),
                      data[has, :1 + vw]))
        cur, owner = data[has, -1], buckets[has]
    else:
        cur, owner = data[:, 0], buckets
    depth = 1
    while depth <= 10_000:
        live = cur < np.uint32(0xFFFFFFFE)
        cur, owner = cur[live], owner[live]
        if not cur.size:
            break
        rows = pool[cur.astype(np.int64)]
        parts.append((owner, np.full(cur.size, depth, np.int64),
                      rows[:, :1 + vw]))
        cur = rows[:, -1]
        depth += 1
    if not parts:
        return np.zeros(0, np.uint32), np.zeros((0, vw), np.uint32)
    owner = np.concatenate([p[0] for p in parts])
    depth = np.concatenate([p[1] for p in parts])
    rows = np.concatenate([p[2] for p in parts])
    order = np.lexsort((depth, owner))
    return rows[order, 0].copy(), rows[order, 1:1 + vw].copy()


def items(state: HashState, *, inline: bool, vw: int) -> dict:
    """The table's contents as {key: uint32[vw]} (a later link of the
    same key overwrites an earlier one, as the reference's walk does)."""
    keys, values = contents(state, inline=inline, vw=vw)
    return {int(k): v for k, v in zip(keys, values)}


def free_slots_available(state: HashState) -> int:
    """Free pool slots remaining (tail - head in the FIFO ring, mod 2^32)."""
    head, tail = (int(x) & _MASK for x in (state.ring_head, state.ring_tail))
    return (tail - head) % (1 << 32)


class CacheHash:
    """Stateful DEPRECATION shim.  strategy + inline select the paper's
    variants: CacheHash = inline=True over {seqlock, cached_me, cached_wf,
    indirect}; Chaining baseline = inline=False.  New code should hold a
    `HashSpec` + `HashState` and call `apply_hash` directly."""

    def __init__(self, nb: int | None = None, vw: int = 1,
                 strategy: str | None = None, p_max: int = 1024,
                 *, inline: bool = True, max_chain: int = 8,
                 chain_factor: float = 2.0, spec: HashSpec | None = None,
                 device="cuda"):
        if spec is None:
            if nb is None:
                raise ValueError("pass either nb or spec")
            spec = HashSpec(nb, vw,
                            ba.strategy_name(strategy) if strategy is not None
                            else DEFAULT_STRATEGY,
                            p_max, inline=inline, max_chain=max_chain,
                            chain_factor=chain_factor)
        self.spec = spec
        self.state = init_hash(spec, device=device)

    @property
    def device(self) -> torch.device:
        return self.state.pool.device

    @property
    def nb(self) -> int:
        return self.spec.nb

    @property
    def vw(self) -> int:
        return self.spec.vw

    @property
    def strategy(self) -> str:
        return self.spec.strategy

    @property
    def inline(self) -> bool:
        return self.spec.inline

    @property
    def max_chain(self) -> int:
        return self.spec.max_chain

    def apply(self, ops):
        self.state, result, stats = apply_hash(self.spec, self.state,
                                               _to_unified(ops), donate=True)
        return result, stats

    def find(self, keys):
        return self.apply(self._ops(engine.FIND, keys))

    def insert(self, keys, values):
        q = len(keys)
        values = as_words(values, self.device).reshape(q, self.vw)
        return self.apply(make_hash_ops(
            np.full((q,), engine.INSERT, np.int32), keys, values, vw=self.vw,
            device=self.device))

    def delete(self, keys):
        return self.apply(self._ops(engine.DELETE, keys))

    def _ops(self, kind, keys):
        q = len(keys)
        return make_hash_ops(np.full((q,), kind, np.int32), keys, vw=self.vw,
                             device=self.device)

    def items(self) -> dict:
        return items(self.state, inline=self.inline, vw=self.vw)
