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


def clamped_index(idx: torch.Tensor, m: int) -> torch.Tensor:
    """A gather index as the reference's gathers read it: a negative index
    counts from the end, then the index is clamped into [0, m) (int64).
    In range at rest; a corrupted pointer (the integrity scrub's input)
    must still read in bounds on a card."""
    idx = idx.long()
    return torch.where(idx < 0, idx + m, idx).clamp(0, m - 1)


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`table[idx]` for a contiguous [m, k] table and int64 row indices in
    [0, m).

    Rows that are a multiple of 16 bytes gather as 16-byte elements of a
    flat view (bits are copied, never computed on): on an H100, PyTorch's
    row gather for such rows (`vectorized_gather_kernel<16>`) runs far
    below the memory rate and the flat form near it.  `chip_smoke.py`
    times both at 2^22 rows (PERF.md, Findings: the row gather)."""
    k = table.shape[1]
    row_bytes = k * table.element_size()
    if (row_bytes % 16 or not table.is_contiguous()
            or table.storage_offset() * table.element_size() % 16):
        return table[idx]
    per = row_bytes // 16
    flat = table.view(-1).view(torch.complex128)
    if per > 1:
        idx = (idx[:, None] * per
               + torch.arange(per, device=idx.device)).view(-1)
    return flat[idx].view(table.dtype).view(-1, k)


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


def ring_take(state: TableState, max_want: int, size: int | None = None):
    """The ring positions of the next `max_want` pops from the FIFO free
    ring, and the node slots they hold: (pos int64[max_want],
    slots int32[max_want]).  Reads only; `ring_return` completes the swap.

    `size` is the number of free entries the ring holds, positions
    [0, size) of `free_ring` (default: all of it).  The node-pool layouts
    keep 2p free nodes in a ring array of n + 2p entries and pass 2p; the
    reference takes positions modulo the whole array there, which pops its
    NULL padding once 2p nodes have been allocated (ROADMAP.md, Queue 3)."""
    m = _ring_size(state, size)
    ranks = torch.arange(max_want, dtype=torch.int64,
                         device=state.free_ring.device)
    pos = (state.ring_head + ranks) % m
    return pos, state.free_ring[pos]


def ring_return(state: TableState, pos, retired, live, count,
                size: int | None = None) -> TableState:
    """Finish a batch's node swap, in place: `count` nodes were popped at
    `pos` (`ring_take`) and the retired ones are pushed where they were
    (the ring is full at rest and every pop is matched by a push in the
    same batch, so the tail is the head before the pops).  `live` marks
    the lanes of `pos` that were popped.  Bit-identical to the reference's
    `ring_alloc` then `ring_free`, which clears the popped entries and
    refills the same positions."""
    state.free_ring[pos] = torch.where(live, retired.to(torch.int32),
                                       state.free_ring[pos])
    return ring_advance(state, count, size)


def ring_advance(state: TableState, count, size: int | None = None):
    """Move the ring head and the allocation count on by `count` (int32
    0-d): a batch whose nodes all came back where they were taken."""
    m = _ring_size(state, size)
    return state._replace(
        ring_head=((state.ring_head + count) % m).to(WORD_DTYPE),
        alloc_gen=(state.alloc_gen + count).to(WORD_DTYPE))


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
