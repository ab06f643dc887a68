"""Shared big-atomic layout state and reclamation-ring helpers (PyTorch).

`TableState` is the one NamedTuple of tensors every strategy layout lives
in (unused fields are size-0 tensors).  Strategy-specific interpretation of
the fields lives in `repro_torch.core.strategies` behind the `StrategyImpl`
protocol; this module owns the state container, the FIFO free-ring
allocator shared by the node-based layouts, and the word helpers.

Words and versions are stored as `torch.int32` holding the bits of the
reference's uint32 (torch's uint32 lacks add, shifts, `%`, `index_put_` and
`max`).  Addition, equality and parity agree bit for bit; arithmetic that
is not bit-identical under a signed type (ring positions, `% m`) is done in
int64 on the unsigned value (`as_u64`) and narrowed back with `to_word`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

WORD_BYTES = 4                # 32-bit words
WORD_DTYPE = torch.int32      # bits of a uint32 word
NULL = -1


def resolve_device(device) -> torch.device:
    """The device a tensor-creating function builds on.  `cuda` (the
    default everywhere) raises when no card is present: nothing silently
    runs on the CPU unless the caller asked for it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return device


def as_u64(x: torch.Tensor) -> torch.Tensor:
    """The unsigned 32-bit value of a word tensor, widened to int64."""
    return x.to(torch.int64) & 0xFFFFFFFF


def to_word(x: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of an integer tensor as a word (int32 bits)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(WORD_DTYPE)


def as_words(x, device) -> torch.Tensor:
    """Coerce words (uint32/int32 arrays or tensors, Python ints) to the
    int32 word tensor on `device`, keeping the low 32 bits."""
    if isinstance(x, torch.Tensor):
        if x.dtype == WORD_DTYPE:
            return x.to(device)
        if x.dtype == torch.uint32:
            return x.view(WORD_DTYPE).to(device)
        return to_word(x).to(device)
    arr = np.asarray(x)
    if arr.dtype != np.uint32:
        arr = (arr.astype(np.int64) & 0xFFFFFFFF).astype(np.uint32)
    arr = np.ascontiguousarray(arr).view(np.int32)
    return torch.from_numpy(arr.copy()).to(device)


def scatter_set(dst: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
                live: torch.Tensor) -> None:
    """In place: `dst[idx[i]] = vals[i]` for every live lane i; other lanes
    are dropped (the reference's `.at[].set(mode="drop")`).

    Live targets must be distinct.  The write adds `vals - dst[idx]` (zero
    on dropped lanes, which aim at row 0), so the result is exact in
    wrapping int32 whatever the order of the adds, and dropping lanes needs
    no host sync."""
    safe = torch.where(live, idx, 0).to(torch.int64)
    mask = live.view(-1, *([1] * (vals.dim() - 1)))
    delta = torch.where(mask, vals - dst[safe], 0).to(dst.dtype)
    dst.index_add_(0, safe, delta)


class TableState(NamedTuple):
    """Unified state; unused fields are size-0 tensors for lean strategies.

    data:      word[n, k]  inline cache / value array (INDIRECT: engine shadow,
               not part of the logical layout — reads never touch it).
    version:   word[n]     seqlock version (even = unlocked).
    bptr:      int32[n]    backup / indirect node index; -1 null; for
               CACHED_ME, -(tag+2) encodes a *tagged* null (paper §3.2).
    mark:      bool[n]     CACHED_WF invalid-mark on the backup pointer.
    lock:      word[n]     SIMPLOCK lock word (0 = free).
    pool:      word[m, k]  node pool.
    free_ring: int32[m]    FIFO ring of free node indices.
    ring_head: word[]      next allocation position (mod ring size).
    alloc_gen: word[]      total allocations ever (reclamation generation).
    """

    data: torch.Tensor
    version: torch.Tensor
    bptr: torch.Tensor
    mark: torch.Tensor
    lock: torch.Tensor
    pool: torch.Tensor
    free_ring: torch.Tensor
    ring_head: torch.Tensor
    alloc_gen: torch.Tensor


class Traffic(NamedTuple):
    """Analytic memory traffic for one batch (roofline inputs).

    bytes_read / bytes_written: float32 modeled bytes.
    dep_chains: number of *dependent* gather rounds on the critical path
                (1 = fully pipelineable, 2 = pointer chase).
    rmw_ops:    single-word atomic RMWs (CAS/lock) — contention proxy.
    """

    bytes_read: torch.Tensor
    bytes_written: torch.Tensor
    dep_chains: torch.Tensor
    rmw_ops: torch.Tensor


def _empty(dtype, shape=(0,), *, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


def _ring_size(state: TableState, size: int | None) -> int:
    return state.free_ring.shape[0] if size is None else size


def ring_alloc(state: TableState, want: torch.Tensor, max_want: int,
               size: int | None = None):
    """Pop up to `max_want` node slots from the FIFO free ring (masked by
    rank < want).  Clears the consumed ring entries in place.

    `size` is the number of free entries the ring holds, positions
    [0, size) of `free_ring` (default: all of it).  The node-pool layouts
    keep 2p free nodes in a ring array of n + 2p entries and pass 2p; the
    reference takes positions modulo the whole array there, which pops its
    NULL padding once 2p nodes have been allocated (ROADMAP.md, Queue 3).
    Returns (slots[max_want], new_state)."""
    m = _ring_size(state, size)
    dev = state.free_ring.device
    want = as_u64(torch.as_tensor(want, device=dev))
    ranks = torch.arange(max_want, dtype=torch.int64, device=dev)
    pos = (as_u64(state.ring_head) + ranks) % m
    slots = state.free_ring[pos]
    live = ranks < want
    # Consumed entries are cleared (debug hygiene; not required for safety).
    scatter_set(state.free_ring, pos, torch.full_like(slots, NULL), live)
    new_head = (as_u64(state.ring_head) + want) % m
    return torch.where(live, slots, NULL), state._replace(
        ring_head=to_word(new_head),
        alloc_gen=to_word(as_u64(state.alloc_gen) + want))


def ring_free(state: TableState, slots: torch.Tensor, count: torch.Tensor,
              live_total: int, size: int | None = None) -> TableState:
    """Push retired node slots at the ring tail, in place.  The ring is
    full at rest and every alloc is matched by one free in the same batch,
    so the tail is the head before the alloc: `count` entries behind the
    new head, the positions just consumed."""
    m = _ring_size(state, size)
    dev = state.free_ring.device
    count = as_u64(torch.as_tensor(count, device=dev))
    ranks = torch.arange(live_total, dtype=torch.int64, device=dev)
    live = ranks < count
    pos = (as_u64(state.ring_head) + m - count + ranks) % m
    scatter_set(state.free_ring, pos,
                torch.where(live, slots, NULL).to(torch.int32), live)
    return state


def sim_alloc(state: TableState, size: int | None = None):
    """Pop ONE node slot for the torn-state simulator (each frozen writer
    must hold a distinct node, like a distinct thread's private slab)."""
    m = _ring_size(state, size)
    head = as_u64(state.ring_head)
    slot = state.free_ring[head]
    return slot, state._replace(
        ring_head=to_word((head + 1) % m),
        alloc_gen=to_word(as_u64(state.alloc_gen) + 1))


def state_nbytes(state: TableState) -> int:
    """Actual bytes held by the state (validates memory_bytes in tests)."""
    return sum(x.numel() * x.element_size() for x in state)
