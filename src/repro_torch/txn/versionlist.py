"""Per-slot bounded version lists over big atomics (PyTorch).

The paper's §2 names version lists as a headline application: "allows the
first version, most commonly accessed, to be stored inline and updated
atomically".  This module is that application on the engine:

  head cells   The newest version of every slot lives INLINE in a
               `cellw = k + 2` word big-atomic cell, [value(k), ts, prev],
               of an ordinary `AtomicSpec` table.  Publishing is ONE
               engine STORE batch (`atomics.apply`), so value, timestamp
               and chain pointer can never tear apart, and every
               registered strategy gets version lists.
  node pool    Older versions sit in a per-slot ring of `depth - 1`
               immutable pool nodes (`pool[n, depth-1, k+2]`).  A publish
               copies the displaced head into its ring position
               (`count % (depth-1)`) and links the new head to it; a node
               is overwritten only after depth-1 further publishes of its
               slot, so every chain is bounded to the `depth` newest
               versions.

`snapshot_read(spec, state, slots, ts)` returns, per queried slot, the
newest version with timestamp <= ts.  Reads past the retained window are
reported (`ok=False`, lap detection via the strict timestamp decrease of a
healthy chain), never silently wrong.

Timestamps are caller-supplied uint32 words and must be strictly
increasing per slot.  Words are int32 tensors holding the uint32 bits:
timestamps are compared, and ring positions and chain pointers formed,
on the unsigned value in int64 (`as_u64`), so a timestamp at or above
2^31 reads as the reference's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import engine, registry
from repro_torch.core.engine import STORE, OpBatch
from repro_torch.core.layout import (WORD_DTYPE, TableState, as_u64,
                                     as_words, clamped_index, resolve_device,
                                     scatter_set, to_word, wrapped_index)
from repro_torch.core.specs import VersionSpec

NULLV = -1          # the word 0xFFFFFFFF: "no older version" terminator


class VersionState(NamedTuple):
    """Head table + version-node pool + per-slot publish count.

    table: TableState of the `spec.head_spec()` big-atomic head cells
    pool:  word[n, depth-1, k+2] per-slot ring of displaced versions
    count: word[n] publishes per slot (ring cursor + version index)
    """

    table: TableState
    pool: torch.Tensor
    count: torch.Tensor


def init(spec: VersionSpec, initial=None, ts0: int = 0, *,
         device="cuda") -> VersionState:
    """Every slot starts with one inline version (`initial` values, ts=ts0)
    and an empty chain."""
    dev = resolve_device(device)
    n, k = spec.n, spec.k
    vals = (torch.zeros((n, k), dtype=WORD_DTYPE, device=dev)
            if initial is None else as_words(initial, dev))
    if tuple(vals.shape) != (n, k):
        raise ValueError(f"initial shape {tuple(vals.shape)} != ({n}, {k})")
    ts = to_word(torch.full((n, 1), ts0, dtype=torch.int64, device=dev))
    cells = torch.cat([vals, ts, torch.full((n, 1), NULLV, dtype=WORD_DTYPE,
                                            device=dev)], 1)
    table = engine.init(spec.head_spec(), cells, device=dev)
    pool = torch.zeros((n, spec.ring_depth, spec.cellw), dtype=WORD_DTYPE,
                       device=dev)
    return VersionState(table, pool,
                        torch.zeros((n,), dtype=WORD_DTYPE, device=dev))


def publish(spec: VersionSpec, state: VersionState, slots, values, ts
            ) -> VersionState:
    """Install a new version (value, ts) at each of `slots`: one engine
    STORE batch (`atomics.apply`'s round and commit on the head table),
    whose witnessed pre-values (the displaced heads) move into the
    per-slot pool rings.

    Slots must be distinct within one batch (checked on the host: slots on
    a card are copied back once, unless there is only one or the stream is
    being captured) and `ts` strictly greater than each slot's current head
    timestamp (caller contract).  The caller's `state` stays valid.  A
    slot outside [0, n) is read clamped and written nowhere, as the
    reference's gathers and scatters treat it (a negative slot first
    counts from the end)."""
    dev = state.pool.device
    q = slots.numel() if isinstance(slots, torch.Tensor) else np.size(slots)
    host = engine.host_copy(slots) if q > 1 else None
    if host is not None and len(np.unique(host)) != host.size:
        raise ValueError(f"publish slots must be distinct within one "
                         f"batch: {sorted(host.tolist())}")
    slots = engine._as_i32(slots, dev).reshape(-1)
    values = as_words(values, dev)
    ts = as_words(ts, dev).reshape(-1)
    rd = spec.ring_depth
    s64, live = wrapped_index(slots, spec.n)
    # The displaced head's ring position and global chain pointer (uint32).
    pos = as_u64(state.count[s64]) % rd
    prev = to_word(as_u64(slots) * rd + pos)
    new_cells = torch.cat([values, ts[:, None], prev[:, None]], 1)
    ops = OpBatch(torch.full_like(slots, STORE),
                  torch.where(live, s64, spec.n).to(torch.int32),
                  torch.zeros_like(new_cells), new_cells)
    hspec = spec.head_spec()
    impl = registry.get_strategy(hspec.strategy)
    table, _, res, _ = engine.run_round(
        impl, engine.round_for(hspec, impl), state.table,
        engine.init_ctx(ops.p, hspec.k, device=dev), ops, donate=False)
    pool = state.pool.clone()
    flat = pool.view(spec.n * rd, spec.cellw)
    scatter_set(flat, s64 * rd + pos, res.value, live)
    count = state.count.clone()
    count.index_add_(0, s64, live.to(count.dtype))
    return VersionState(table, pool, count)


def snapshot_read(spec: VersionSpec, state: VersionState, slots, ts):
    """Timestamped snapshot of an arbitrary slot set.

    Per queried slot: the value + timestamp of the newest version with
    version-ts <= ts[i] (unsigned).  ok=False when the head cell is torn
    (blocking strategies only) or the requested time predates the bounded
    chain (version evicted).  No host read.  The head read counts nothing
    under BIGATOMIC_OBS=counters, as in the reference, where the whole
    read is one jitted program.

    Returns (values word[q, k], found_ts word[q], ok bool[q])."""
    dev = state.pool.device
    n, k, rd = spec.n, spec.k, spec.ring_depth
    slots = engine._as_i32(slots, dev).reshape(-1)
    ts = as_u64(as_words(ts, dev).reshape(-1))
    heads, hok = registry.get_strategy(spec.strategy).read(state.table,
                                                           slots.long())
    hval, hts, hprev = heads[:, :k], as_u64(heads[:, k]), heads[:, k + 1]

    m = n * rd
    flat = state.pool.reshape(m, spec.cellw)
    found = hts <= ts
    values = torch.where(found[:, None], hval, 0)
    found_ts = torch.where(found, hts, 0)
    cur = torch.where(found, NULLV, hprev)     # walk only unresolved lanes
    prev_ts = hts
    for _ in range(rd):
        is_node = cur != NULLV
        node = flat[clamped_index(torch.where(is_node, cur, 0), m)]
        nts = as_u64(node[:, k])
        # A healthy chain strictly decreases in ts; a recycled ring slot
        # holds a NEWER version and breaks the invariant: lap detected.
        valid = is_node & (nts < prev_ts)
        hit = valid & (nts <= ts)
        values = torch.where(hit[:, None], node[:, :k], values)
        found_ts = torch.where(hit, nts, found_ts)
        found = found | hit
        cur = torch.where(valid & ~hit, node[:, k + 1], NULLV)
        prev_ts = torch.where(valid, nts, prev_ts)
    return values, to_word(found_ts), hok & found


def latest(spec: VersionSpec, state: VersionState, slots):
    """Newest version of each slot: (values word[q, k], ts word[q],
    ok[q])."""
    slots = engine._as_i32(slots, state.pool.device).reshape(-1)
    heads, hok = engine.read(spec.head_spec(), state.table, slots)
    return heads[:, :spec.k], heads[:, spec.k], hok


def history(spec: VersionSpec, state: VersionState, slot: int) -> list:
    """Host-side debug/test helper: the retained (ts, value) chain of one
    slot, newest first, values as uint32 arrays (walks exactly like
    `snapshot_read`).  Reads the head and each visited node back."""
    def words(t):
        return t.cpu().numpy().view(np.uint32)

    head = words(engine.logical(spec.head_spec(), state.table)[slot])
    flat = state.pool.reshape(spec.n * spec.ring_depth, spec.cellw)
    k = spec.k
    out = [(int(head[k]), head[:k].copy())]
    cur, prev_ts = head[k + 1], head[k]
    for _ in range(spec.ring_depth):
        if cur == np.uint32(0xFFFFFFFF):
            break
        node = words(flat[int(cur)])
        if not node[k] < prev_ts:
            break                               # lapped (recycled ring slot)
        out.append((int(node[k]), node[:k].copy()))
        cur, prev_ts = node[k + 1], node[k]
    return out
