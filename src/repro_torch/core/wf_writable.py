"""Cached-WaitFree-Writable (paper §3.3, Algorithm 3): wait-free load +
store + CAS built over a Load/CAS big atomic, via a write-buffer W and a
mark-matching help protocol (PyTorch).

State per atomic i:
    Z[i]       the central (k+2)-word triple (value, seq, zmark);
    W[i]       write-buffer: index into a node pool, plus a wmark bit.
Invariant: zmark != wmark  <=>  there is a PENDING store (installed in W,
not yet transferred to Z).  Transfer = CAS on Z that copies W's value,
bumps seq, and flips zmark to re-match, done by ANY helper (writers and
CASers both help; that is what makes stores wait-free).

Batch adaptation: one step applies a batch of ops.  The protocol's
cross-thread interleavings become cross-STEP interleavings: `begin_store`
installs into W and returns without transferring (the descheduled
writer); any later batch, even one of CAS ops only, transfers the pending
write first (helping), as Algorithm 3's help_write call in cas().

Words and seq are int32 tensors holding the reference's uint32 bits; the
pool cursor and seq halving are taken on the unsigned value.  Every
function returns a new state and leaves the one it was given valid.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import semantics as sem
from repro_torch.core.engine import CAS, OpBatch
from repro_torch.core.layout import (WORD_DTYPE, as_u64, as_words,
                                     resolve_device, scatter_set, to_word)

NULLW = -1


class WritableState(NamedTuple):
    z_value: torch.Tensor     # word[n, k]  Z.value
    z_seq: torch.Tensor       # word[n]     Z.seq (ABA guard)
    z_mark: torch.Tensor      # bool[n]     Z.mark
    w_node: torch.Tensor      # int32[n]    W pointer (pool index, -1 none)
    w_mark: torch.Tensor      # bool[n]     mark carried by W
    pool: torch.Tensor        # word[m, k]  write-buffer nodes
    pool_next: torch.Tensor   # word[]      bump allocator (ring)


def init(n: int, k: int, p_max: int = 64, initial=None, *,
         device="cuda") -> WritableState:
    dev = resolve_device(device)
    data = (torch.zeros((n, k), dtype=WORD_DTYPE, device=dev)
            if initial is None else as_words(initial, dev))
    m = max(2 * p_max, 2)
    return WritableState(
        z_value=data,
        z_seq=torch.zeros((n,), dtype=WORD_DTYPE, device=dev),
        z_mark=torch.zeros((n,), dtype=torch.bool, device=dev),
        w_node=torch.full((n,), NULLW, dtype=torch.int32, device=dev),
        w_mark=torch.zeros((n,), dtype=torch.bool, device=dev),
        pool=torch.zeros((m, k), dtype=WORD_DTYPE, device=dev),
        pool_next=torch.zeros((), dtype=WORD_DTYPE, device=dev),
    )


def pending(st: WritableState) -> torch.Tensor:
    """bool[n]: marks mismatched <=> a store is installed but untransferred."""
    return st.z_mark != st.w_mark


def load(st: WritableState, slots) -> torch.Tensor:
    """Wait-free: one read of Z.value (Line 11).  Pending writes in W are
    invisible until transferred: they linearize at transfer time."""
    slots = torch.as_tensor(slots).to(st.z_value.device).long()
    return st.z_value[slots]


def help_write(st: WritableState) -> WritableState:
    """Transfer every pending write from W to Z (Lines 35-41): the helper
    resolves ALL mismatched cells at once; seq += 1 and zmark flips to
    re-match (the CAS on Z of Algorithm 3)."""
    mism = pending(st)
    w_val = st.pool[st.w_node.clamp(min=0).long()]
    return st._replace(
        z_value=torch.where(mism[:, None], w_val, st.z_value),
        z_seq=torch.where(mism, st.z_seq + 1, st.z_seq),
        z_mark=torch.where(mism, st.w_mark, st.z_mark))


def _cursor(st: WritableState) -> torch.Tensor:
    """The next pool node, `pool_next % m` on the unsigned cursor."""
    return as_u64(st.pool_next) % st.pool.shape[0]


def begin_store(st: WritableState, slot: int, value) -> WritableState:
    """First half of store(): install the node in W and mismatch the marks
    (Lines 19-20), then 'get descheduled': NO transfer.  Any later operation
    completes it (helping).

    If a pending write already exists on this slot, or the value is the
    current one, the writer linearizes silently (Lines 17-18): the state is
    returned unchanged but for the cursor.  The branch is a mask on the
    device, never read back."""
    dev = st.z_value.device
    value = as_words(value, dev).reshape(-1)
    already = pending(st)[slot]
    same = (st.z_value[slot] == value).all()
    do = ~(already | same)
    node = _cursor(st).reshape(1)
    pool = st.pool.index_copy(
        0, node, torch.where(do, value, st.pool.index_select(0, node)))
    w_node = st.w_node.clone()
    w_node[slot] = torch.where(do, node[0].to(torch.int32), w_node[slot])
    w_mark = st.w_mark.clone()
    w_mark[slot] = torch.where(do, ~st.z_mark[slot], w_mark[slot])
    return st._replace(pool=pool, w_node=w_node, w_mark=w_mark,
                       pool_next=st.pool_next + do.to(WORD_DTYPE))


def store(st: WritableState, slot: int, value) -> WritableState:
    """Complete store: install + help (Line 23; batched help is total)."""
    return help_write(begin_store(st, slot, value))


def cas_batch(st: WritableState, slots, expected, desired):
    """Batched CAS (Lines 25-33): helpers first (transfer pending writes),
    then the compare-exchange on Z with seq bump.  Within the batch,
    same-slot CASes serialize in lane order (the engine's linearization).

    Returns (state', success bool[p])."""
    st = help_write(st)                      # Line 30: casers help writers
    dev = st.z_value.device
    slots = torch.as_tensor(slots).to(device=dev, dtype=torch.int32)
    ops = OpBatch(torch.full_like(slots, CAS), slots,
                  as_words(expected, dev), as_words(desired, dev))
    new_val, new_seq_x2, res, _ = sem.apply_batch(
        st.z_value.clone(), st.z_seq * 2, ops)   # parity-versioned engine
    return st._replace(z_value=new_val,
                       z_seq=to_word(as_u64(new_seq_x2) // 2)), res.success


def _last_lane_per_index(idx: torch.Tensor, size: int) -> torch.Tensor:
    """bool[p]: lane i is the LAST lane naming idx[i] (lane-order
    linearization of duplicate scatters; `index_put_` with duplicate
    indices has no defined winner on a card).  A scatter-amax of the lane
    index, no host read."""
    p = idx.shape[0]
    lane = torch.arange(p, device=idx.device)
    last = torch.full((size,), -1, dtype=torch.int64, device=idx.device)
    last.scatter_reduce_(0, idx, lane, "amax")
    return last[idx] == lane


def store_batch(st: WritableState, slots, values) -> WritableState:
    """Batched stores: install every lane's write (last lane per slot wins,
    = lane-order linearization), then transfer."""
    dev = st.z_value.device
    slots = torch.as_tensor(slots).to(dev).long()
    values = as_words(values, dev)
    n, m = st.z_value.shape[0], st.pool.shape[0]
    p = slots.shape[0]
    nodes = (_cursor(st) + torch.arange(p, device=dev)) % m
    pool = st.pool.clone()                     # nodes repeat when p > m
    scatter_set(pool, nodes, values, _last_lane_per_index(nodes, m))
    w_node = st.w_node.clone()
    scatter_set(w_node, slots, nodes.to(torch.int32),
                _last_lane_per_index(slots, n))
    w_mark = st.w_mark.clone()
    w_mark[slots] = ~st.z_mark[slots]          # equal on every lane of a slot
    st = st._replace(pool=pool, w_node=w_node, w_mark=w_mark,
                     pool_next=to_word(as_u64(st.pool_next) + p))
    return help_write(st)


# ---------------------------------------------------------------------------
# Sequential oracle for linearizability tests
# ---------------------------------------------------------------------------

def oracle_apply(values: np.ndarray, script: list[tuple]) -> tuple:
    """Apply a script of ('load',s) / ('begin_store',s,v) / ('store',s,v) /
    ('cas',s,e,d) / ('help',) sequentially; pending stores take effect at
    the next help or op that helps.  Returns (values, outputs)."""
    values = np.array(values, copy=True)
    pending_w: dict[int, np.ndarray] = {}
    out = []

    def flush():
        for s, v in list(pending_w.items()):
            values[s] = v
        pending_w.clear()

    for op in script:
        if op[0] == "load":
            out.append(values[op[1]].copy())
        elif op[0] == "begin_store":
            s, v = op[1], np.asarray(op[2])
            if s not in pending_w and not np.array_equal(values[s], v):
                pending_w[s] = v
        elif op[0] == "store":
            s, v = op[1], np.asarray(op[2])
            had_pending = s in pending_w
            flush()
            # Algorithm 3: a store that finds a pending write on its slot
            # linearizes SILENTLY immediately before that write's transfer;
            # its own value never appears (Line 18 false-branch).  Same for
            # a store of the current value (Line 17).
            if not had_pending and not np.array_equal(values[s], v):
                values[s] = v
        elif op[0] == "help":
            flush()
        elif op[0] == "cas":
            flush()                       # casers help first
            s, e, d = op[1], np.asarray(op[2]), np.asarray(op[3])
            ok = np.array_equal(values[s], e)
            if ok:
                values[s] = d
            out.append(ok)
    return values, out
