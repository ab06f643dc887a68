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

Node reclamation uses a FIFO ring of free slots (`core.layout.ring_take`,
`ring_return`).  `commit` hooks update the pool, pointers and ring in
place; the engine hands them a private copy of the state unless the caller
donates it, and the list of the cells the batch wrote, so no hook passes
over the whole table (but CACHED_WF's mark clear, as in the reference).
"""

from __future__ import annotations

import torch

from repro_torch.core.layout import (NULL, TableState, Traffic, WORD_BYTES,
                                     WORD_DTYPE, _empty, clamped_index,
                                     gather_rows, ring_advance, ring_return,
                                     ring_take, sim_alloc)
from repro_torch.core.registry import StrategyImpl, register_strategy


def _i32(x, dev) -> torch.Tensor:
    """An int32 constant made on the device (a fill, which a CUDA graph can
    capture; a copy from the host it cannot)."""
    return torch.full((), x, dtype=torch.int32, device=dev)


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
        slots = clamped_index(slots, state.data.shape[0])
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
        slots = clamped_index(slots, state.data.shape[0])
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

    def commit(self, state, new_data, new_version, stats, dirty, p):
        # One fresh node per dirty cell holds the final value; the old node is
        # retired to the ring.  (Intermediate values of a CAS chain live and
        # die inside the batch; they are counted in stats.n_updates.)  The
        # r-th dirty cell in slot order takes the r-th node popped, as the
        # reference's scan over the table hands them out.
        n = state.version.shape[0]
        max_d = min(n, p)
        dslots = dirty[:max_d]
        live = dslots < n                       # the list is padded with n
        safe = dslots.clamp(max=n - 1).long()
        size = self.ring_size(state)
        pos, new_nodes = ring_take(state, max_d, size)
        nodes = new_nodes.long()
        # Lanes past the dirty count write back the node rows they read, so
        # the pool writes go to distinct rows with no mask of their own;
        # their pointer lanes (cell n - 1) add nothing.
        state.pool[nodes] = torch.where(live[:, None],
                                        gather_rows(new_data, safe),
                                        gather_rows(state.pool, nodes))
        old_nodes = state.bptr[safe]
        state.bptr.index_add_(0, safe, (new_nodes - old_nodes) * live)
        st = state._replace(data=new_data, version=new_version)
        return ring_return(st, pos, old_nodes, live, stats.n_dirty_cells,
                           size)

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
                           clamped_index(state.bptr, state.pool.shape[0]))

    def engine_view(self, state):
        # `commit` writes new_data into the shadow alongside the node swing,
        # so the shadow always equals pool[bptr]; reading it saves the
        # dependent gather on every engine batch (reads never touch it).
        return state.data

    def read(self, state, slots):
        slots = clamped_index(slots, state.data.shape[0])
        node = clamped_index(state.bptr[slots], state.pool.shape[0])
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

    def commit(self, state, new_data, new_version, stats, dirty, p):
        new_state = super().commit(state, new_data, new_version, stats,
                                   dirty, p)
        # Batch completes cleanly: every dirty cell ends validated (unmarked)
        # with cache == backup.
        return new_state._replace(mark=torch.zeros_like(state.mark))

    def read(self, state, slots):
        slots = clamped_index(slots, state.data.shape[0])
        v1 = state.version[slots]
        val = state.data[slots]
        marked = state.mark[slots]
        v2 = state.version[slots]
        fastok = (~marked) & (v1 == v2) & ((v1 & 1) == 0)
        backup = state.pool[clamped_index(state.bptr[slots],
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

    def commit(self, state, new_data, new_version, stats, dirty, p):
        # Transient backups: installed during the update, uninstalled after
        # the cache copy (backup returns to tagged null carrying the version).
        # Pool slots cycle through the 3p ring within the batch and every one
        # comes back where it was taken, so only the head and the count
        # move; the final layout has all-null bptr (paper §3.2 invariant).
        n = state.version.shape[0]
        ring_cap = state.free_ring.shape[0]
        st = ring_advance(state, stats.n_updates.clamp(max=ring_cap))
        # Tagged null: encode low version bits so a stale CAS can't ABA.
        # Padding lanes (slot n) aim at cell 0 and add nothing.
        dslots = dirty[:min(n, p)]
        live = dslots < n
        safe = dslots.clamp(max=n - 1).long()
        tagged = -(_tag(new_version[safe]) + 2)
        st.bptr.index_add_(0, safe, (tagged - st.bptr[safe]) * live)
        return st._replace(data=new_data, version=new_version)

    def read(self, state, slots):
        slots = clamped_index(slots, state.data.shape[0])
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
