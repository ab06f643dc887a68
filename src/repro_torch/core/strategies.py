"""The paper's big-atomic memory layouts as registered `StrategyImpl`s.

Every strategy provides the *same* linearizable batch semantics (the unified
engine in `repro_torch.core.engine`) but a *different* memory layout, reader
protocol and traffic profile:

  SEQLOCK    data[n,k] + ver[n].            1 gather/load; blocking on torn state.
  INDIRECT   ptr[n] -> pool[n+2p, k].       2 *dependent* gathers per load; never blocks.
  CACHED_WF  cache[n,k] + ver[n] + bptr[n] -> pool[n+2p,k].  1 gather fast path,
             backup fallback on race; never blocks.  Space 2nk + O(pk).
  CACHED_ME  cache[n,k] + ver[n] + bptr[n](tagged null) -> pool[3p,k].  1 gather
             fast path; backup only *during* a race; space nk + O(pk).
  SIMPLOCK   data[n,k] + lock[n].           lock RMW on every op; blocks readers.
  PLAIN      data[n,k], no protocol.        negative control: returns torn data.

Node reclamation uses a FIFO ring of free slots (`core.layout.ring_alloc`).
`commit` hooks update the pool, pointers and ring in place; the engine hands
them a private copy of the state unless the caller donates it.
"""

from __future__ import annotations

import torch

from repro_torch.core.layout import (NULL, TableState, Traffic, WORD_BYTES,
                                     WORD_DTYPE, _empty, as_u64, gather_rows,
                                     ring_alloc, ring_free, scatter_set,
                                     sim_alloc)
from repro_torch.core.registry import StrategyImpl, register_strategy


def _i32(x, dev) -> torch.Tensor:
    return torch.as_tensor(x, device=dev).to(torch.int32)


def _node_index(bptr: torch.Tensor, m: int) -> torch.Tensor:
    """Node indices as the reference's gather reads `pool[bptr]`: a
    negative pointer counts from the end, then the index is clamped into
    [0, m).  At rest every pointer is in range; a corrupted one (the
    integrity scrub's input) must still read in bounds on a card."""
    idx = bptr.long()
    return torch.where(idx < 0, idx + m, idx).clamp(0, m - 1)


class _KernelLowering:
    """Mixin: lower the engine round to the fused fast/slow round
    (`repro_torch.kernels.engine_round`).  The four paper layouts share it:
    they all linearize against the same (engine_view, version) pair.
    PLAIN/SIMPLOCK and plug-ins keep the base `lower_round` (None)."""

    def lower_round(self, spec, *, mode: str):
        from repro_torch.kernels import engine_round
        return engine_round.make_round(spec.n, spec.k, mode=mode)


@register_strategy
class Plain(StrategyImpl):
    """Negative control: no protocol, readers may observe torn cells."""

    name = "plain"
    lock_free = False


class _Versioned(StrategyImpl):
    """Shared base for layouts that keep data[n,k] + an even/odd version."""

    def memory_bytes(self, n, k, p):
        return n * (k + 1) * WORD_BYTES

    def check_invariants(self, spec, state):
        # At a quiescent point every writer has unlocked: versions even.
        return {"version_parity": (state.version & 1) != 0}


@register_strategy
class Seqlock(_KernelLowering, _Versioned):
    name = "seqlock"
    blocks_readers = True

    def read(self, state, slots):
        v1 = state.version[slots]
        val = state.data[slots]
        v2 = state.version[slots]
        ok = (v1 == v2) & ((v1 & 1) == 0)
        return val, ok

    def traffic(self, stats, k, p):
        w = WORD_BYTES
        cell = k * w
        loads, raced, upd = stats.n_loads, stats.n_raced_loads, stats.n_updates
        br = loads * (cell + 2 * w) + raced * (cell + 2 * w) + upd * (cell + 2 * w)
        bw = upd * (cell + 2 * w)
        chains = torch.where(raced > 0, 2, 1)
        return Traffic(br.to(torch.float32), bw.to(torch.float32),
                       chains.to(torch.int32), upd.to(torch.int32))

    def begin_update(self, state, slot, new_value, torn_words):
        data = state.data.clone()
        data[slot, :torn_words] = new_value[:torn_words]
        version = state.version.clone()
        version[slot] += 1                                  # odd = locked
        return state._replace(version=version, data=data)


@register_strategy
class Simplock(_Versioned):
    name = "simplock"
    blocks_readers = True

    def init(self, n, k, p_max, data):
        base = super().init(n, k, p_max, data)
        return base._replace(lock=torch.zeros((n,), dtype=WORD_DTYPE,
                                              device=data.device))

    def read(self, state, slots):
        held = state.lock[slots] != 0
        return state.data[slots], ~held

    def traffic(self, stats, k, p):
        w = WORD_BYTES
        cell = k * w
        loads, upd = stats.n_loads, stats.n_updates
        br = (loads + upd) * (cell + w)
        bw = upd * cell + (loads + upd) * 2 * w        # lock/unlock writes
        dev = loads.device
        return Traffic(br.to(torch.float32), bw.to(torch.float32),
                       _i32(2, dev),                   # lock precedes data
                       (loads + upd).to(torch.int32))

    def begin_update(self, state, slot, new_value, torn_words):
        data = state.data.clone()
        data[slot, :torn_words] = new_value[:torn_words]
        lock = state.lock.clone()
        lock[slot] = 1
        return state._replace(lock=lock, data=data)

    def check_invariants(self, spec, state):
        out = super().check_invariants(spec, state)
        out["lock_released"] = state.lock != 0      # no holder at rest
        return out


class _NodePool(_Versioned):
    """Shared base for INDIRECT / CACHED_WF: pool of n + 2p immutable nodes.

    The free ring is an array of n + 2p entries whose first 2p positions
    hold the free nodes (the rest is NULL padding), so ring positions run
    modulo 2p (`ring_size`)."""

    @staticmethod
    def ring_size(state) -> int:
        return state.pool.shape[0] - state.version.shape[0]

    def init(self, n, k, p_max, data):
        dev = data.device
        # n installed nodes + 2p slack (SMR in-flight bound).
        m = n + 2 * p_max
        pool = torch.zeros((m, k), dtype=WORD_DTYPE, device=dev)
        pool[:n] = data
        bptr = torch.arange(n, dtype=torch.int32, device=dev)  # cell i -> node i
        free_ring = torch.cat(
            [torch.arange(n, m, dtype=torch.int32, device=dev),
             torch.full((n,), NULL, dtype=torch.int32, device=dev)])
        mark = (torch.zeros((n,), dtype=torch.bool, device=dev)
                if self.name == "cached_wf" else _empty(torch.bool, device=dev))
        return TableState(data, torch.zeros((n,), dtype=WORD_DTYPE, device=dev),
                          bptr, mark, _empty(WORD_DTYPE, device=dev), pool,
                          free_ring, _empty(WORD_DTYPE, (), device=dev),
                          _empty(WORD_DTYPE, (), device=dev))

    def commit(self, state, new_data, new_version, n_updates, p):
        # One fresh node per dirty cell holds the final value; the old node is
        # retired to the ring.  (Intermediate values of a CAS chain live and
        # die inside the batch; they are counted in stats.n_updates.)
        n = state.version.shape[0]
        dev = new_data.device
        max_d = min(n, p)
        dirty = new_version != state.version
        # Dirty slots in ascending order, without a host sync: the r-th
        # dirty slot is where the running dirty count first reaches r + 1
        # (n past the last one).
        cum = torch.cumsum(dirty, 0)
        d_count = cum[-1]
        dslots = torch.searchsorted(
            cum, torch.arange(1, max_d + 1, dtype=cum.dtype, device=dev))
        live = dslots < n
        safe = dslots.clamp(max=n - 1)
        size = self.ring_size(state)
        new_nodes, st2 = ring_alloc(state, d_count, max_d, size)
        old_nodes = state.bptr[safe]
        scatter_set(st2.pool, new_nodes, new_data[safe], live)
        scatter_set(st2.bptr, dslots, new_nodes, live)
        st3 = st2._replace(data=new_data, version=new_version)
        return ring_free(st3, torch.where(live, old_nodes, NULL), d_count,
                         max_d, size)

    def memory_bytes(self, n, k, p):
        w = WORD_BYTES
        pool = (n + 2 * p) * k * w + (n + 2 * p) * w    # pool + ring
        if self.name == "indirect":
            return n * w + pool                          # ptr + pool + ring
        return n * (k + 2) * w + pool


@register_strategy
class Indirect(_KernelLowering, _NodePool):
    name = "indirect"
    lock_free = True

    def logical(self, state):
        return gather_rows(state.pool,
                           _node_index(state.bptr, state.pool.shape[0]))

    def engine_view(self, state):
        # `commit` writes new_data into the shadow alongside the node swing,
        # so the shadow always equals pool[bptr]; reading it saves the
        # dependent gather on every engine batch (reads never touch it).
        return state.data

    def read(self, state, slots):
        node = _node_index(state.bptr[slots], state.pool.shape[0])
        return state.pool[node], torch.ones(
            (slots.shape[0],), dtype=torch.bool, device=slots.device)

    def traffic(self, stats, k, p):
        w = WORD_BYTES
        cell = k * w
        loads, upd, dirty = stats.n_loads, stats.n_updates, stats.n_dirty_cells
        br = loads * (w + cell) + upd * (w + cell)
        bw = upd * cell + dirty * w
        return Traffic(br.to(torch.float32), bw.to(torch.float32),
                       _i32(2, loads.device),           # ptr chase on EVERY load
                       upd.to(torch.int32))

    def begin_update(self, state, slot, new_value, torn_words):
        # Node written; pointer swing (the linearization point) pending.
        free_slot, state = sim_alloc(state, self.ring_size(state))
        pool = state.pool.clone()
        pool[free_slot.long()] = new_value
        return state._replace(pool=pool)

    def check_invariants(self, spec, state):
        out = super().check_invariants(spec, state)
        m = state.pool.shape[0]
        bad_ptr = (state.bptr < 0) | (state.bptr >= m)
        node = gather_rows(state.pool, state.bptr.clamp(0, m - 1).long())
        out["pointer_range"] = bad_ptr
        # commit maintains data as an exact shadow of pool[bptr]
        out["shadow_agrees"] = ~bad_ptr & (node != state.data).any(1)
        return out


class _Cached(_NodePool):
    """Shared traffic model for the two cached layouts (1-gather fast path)."""

    def traffic(self, stats, k, p):
        w = WORD_BYTES
        cell = k * w
        loads, raced, upd = stats.n_loads, stats.n_raced_loads, stats.n_updates
        fast = loads - raced
        br = fast * (cell + 2 * w) + raced * (cell + 2 * w + cell) + upd * (cell + 3 * w)
        bw = upd * (2 * cell + 3 * w)                   # node + cache + ver/ptr
        chains = torch.where(raced > 0, 2, 1)           # fast path: ONE gather
        return Traffic(br.to(torch.float32), bw.to(torch.float32),
                       chains.to(torch.int32),
                       (2 * upd).to(torch.int32))       # ptr CAS + ver lock


@register_strategy
class CachedWF(_KernelLowering, _Cached):
    name = "cached_wf"
    lock_free = True

    def commit(self, state, new_data, new_version, n_updates, p):
        new_state = super().commit(state, new_data, new_version, n_updates, p)
        # Batch completes cleanly: every dirty cell ends validated (unmarked)
        # with cache == backup.
        return new_state._replace(mark=torch.zeros_like(state.mark))

    def read(self, state, slots):
        v1 = state.version[slots]
        val = state.data[slots]
        marked = state.mark[slots]
        v2 = state.version[slots]
        fastok = (~marked) & (v1 == v2) & ((v1 & 1) == 0)
        backup = state.pool[_node_index(state.bptr[slots],
                                        state.pool.shape[0])]  # slow path
        return (torch.where(fastok[:, None], val, backup),
                torch.ones((slots.shape[0],), dtype=torch.bool,
                           device=slots.device))

    def begin_update(self, state, slot, new_value, torn_words):
        # Linearization point (pointer install) HAS happened: new node is the
        # truth; cache is mid-copy and marked invalid; version odd.
        data = state.data.clone()
        data[slot, :torn_words] = new_value[:torn_words]
        free_slot, state = sim_alloc(state, self.ring_size(state))
        pool = state.pool.clone()
        pool[free_slot.long()] = new_value
        bptr, mark, version = (state.bptr.clone(), state.mark.clone(),
                               state.version.clone())
        bptr[slot] = free_slot
        mark[slot] = True
        version[slot] += 1
        return state._replace(pool=pool, bptr=bptr, mark=mark,
                              version=version, data=data)

    def check_invariants(self, spec, state):
        out = super().check_invariants(spec, state)
        m = state.pool.shape[0]
        bad_ptr = (state.bptr < 0) | (state.bptr >= m)
        backup = gather_rows(state.pool, state.bptr.clamp(0, m - 1).long())
        out["pointer_range"] = bad_ptr
        # every batch ends validated: cache == backup, marks clear
        out["cache_matches_backup"] = ~bad_ptr & (backup != state.data).any(1)
        out["mark_clear"] = state.mark
        return out


def _tag(version: torch.Tensor) -> torch.Tensor:
    """The CACHED_ME tagged-null tag, (ver >> 1) & 0x3FFFFFFF.  The mask
    drops the two top bits, so an arithmetic shift of the int32 word gives
    the bits a logical shift of the uint32 does."""
    return (version >> 1) & 0x3FFFFFFF


@register_strategy
class CachedME(_KernelLowering, _Cached):
    name = "cached_me"
    lock_free = True

    def init(self, n, k, p_max, data):
        dev = data.device
        m = max(3 * p_max, 1)
        pool = torch.zeros((m, k), dtype=WORD_DTYPE, device=dev)
        bptr = torch.full((n,), NULL, dtype=torch.int32, device=dev)
        free_ring = torch.arange(m, dtype=torch.int32, device=dev)
        return TableState(data, torch.zeros((n,), dtype=WORD_DTYPE, device=dev),
                          bptr, mark=_empty(torch.bool, device=dev),
                          lock=_empty(WORD_DTYPE, device=dev), pool=pool,
                          free_ring=free_ring,
                          ring_head=_empty(WORD_DTYPE, (), device=dev),
                          alloc_gen=_empty(WORD_DTYPE, (), device=dev))

    def commit(self, state, new_data, new_version, n_updates, p):
        # Transient backups: installed during the update, uninstalled after
        # the cache copy (backup returns to tagged null carrying the version).
        # Pool slots cycle through the 3p ring within the batch; the final
        # layout has all-null bptr (paper §3.2 invariant).
        dirty = new_version != state.version
        ring_cap = state.free_ring.shape[0]
        u_count = as_u64(torch.as_tensor(n_updates)).clamp(max=ring_cap)
        max_u = min(p, ring_cap)
        slots_alloc, st2 = ring_alloc(state, u_count, max_u)
        # All transients are freed within the batch: push them straight back.
        st3 = ring_free(st2, slots_alloc, u_count, max_u)
        # Tagged null: encode low version bits so a stale CAS can't ABA.
        bptr = torch.where(dirty, -(_tag(new_version) + 2), st3.bptr)
        return st3._replace(data=new_data, version=new_version, bptr=bptr)

    def read(self, state, slots):
        v1 = state.version[slots]
        val = state.data[slots]
        bp = state.bptr[slots]
        is_null = bp < 0
        v2 = state.version[slots]
        fastok = is_null & (v1 == v2) & ((v1 & 1) == 0)
        # slow path: live node; the reference's gather clamps above
        backup = state.pool[bp.clamp(0, state.pool.shape[0] - 1).long()]
        # If bptr is a real node, the node holds the live value (invariant);
        # either way the reader makes progress -> ok is always True.
        return (torch.where(fastok[:, None], val, backup),
                torch.ones((slots.shape[0],), dtype=torch.bool,
                           device=slots.device))

    def begin_update(self, state, slot, new_value, torn_words):
        data = state.data.clone()
        data[slot, :torn_words] = new_value[:torn_words]
        free_slot, state = sim_alloc(state)
        pool = state.pool.clone()
        pool[free_slot.long()] = new_value
        bptr, version = state.bptr.clone(), state.version.clone()
        bptr[slot] = free_slot
        version[slot] += 1
        return state._replace(pool=pool, bptr=bptr, version=version,
                              data=data)

    def memory_bytes(self, n, k, p):
        w = WORD_BYTES
        return n * (k + 2) * w + 3 * p * k * w + 3 * p * w

    def check_invariants(self, spec, state):
        out = super().check_invariants(spec, state)
        # At rest every bptr is null (paper §3.2): either the init/restore
        # NULL or the tagged null commit leaves, whose tag must agree with
        # the cell's version (-(tag+2) with tag = (ver >> 1) & 0x3FFFFFFF).
        ok = (state.bptr == NULL) | (state.bptr == -(_tag(state.version) + 2))
        out["tagged_null"] = ~ok
        return out
