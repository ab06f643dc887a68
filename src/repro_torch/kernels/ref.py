"""Plain PyTorch versions of the raw-table kernels (the definition of
correctness).

Each function computes exactly what the corresponding CUDA kernel in
`csrc/table_ops.cu` computes, with vectorised gathers and `where`: within a
round the live slots are distinct, so gathering every lane's pre-round row
at once is the sequential order.  `cas_apply_rounds_ref` is the round loop
that the one-launch `cas_apply_rounds` kernel replays per segment.  The wrappers run these on CPU tensors,
and the tests hold them bit for bit against the reference's Pallas kernels
and numpy oracles.  Words are int32 bits (see `core/layout.py`).

Like the kernels, the two rounds update `data` and `meta` in place and
return them, and a lane whose row index lies outside the table is dead:
zero outputs and no table access (a CacheHash probe reports an empty bucket
with next = -1).  `indirect_gather_ref` models the INDIRECT strategy's two
dependent gathers; it has no kernel.
"""

from __future__ import annotations

import torch

from repro_torch.core.layout import scatter_set

STORE = 1
CAS = 2
# flags word values of a CacheHash cell (matches core.cachehash)
EMPTY = 0
FULL = 1


def _rows(table: torch.Tensor, idx: torch.Tensor):
    """(in-range mask, clamped int64 index, gathered rows with zeros on
    out-of-range lanes)."""
    inb = (idx >= 0) & (idx < table.shape[0])
    safe = idx.clamp(0, table.shape[0] - 1).to(torch.int64)
    return inb, safe, torch.where(inb[:, None], table[safe], 0)


def seqlock_gather_ref(data, meta, idx):
    """(values word[q, k], ok int32[q, 1]): ok = version even & mark == 0."""
    inb, _, vals = _rows(data, idx)
    m = _rows(meta, idx)[2]
    ok = inb & ((m[:, 0] & 1) == 0) & (m[:, 1] == 0)
    return vals, ok.to(torch.int32)[:, None]


def indirect_gather_ref(ptr, pool, idx):
    """INDIRECT load: gather the pointer, then gather the node it names.
    Two *dependent* gathers — the traffic/latency baseline CacheHash beats."""
    return pool[ptr[idx.to(torch.int64)].to(torch.int64)]


def _commit(data, meta, safe, ok, desired):
    scatter_set(data, safe, desired, ok)
    bump = torch.stack([2 * ok.to(meta.dtype), torch.zeros_like(
        ok, dtype=meta.dtype)], 1)
    meta.index_add_(0, safe, bump)


def cas_apply_round_ref(data, meta, slot, kind, expected, desired):
    """One conflict-free STORE/CAS round (live slots distinct; dead lanes on
    the dummy row n).  Returns (data, meta, success int32[p, 1], witness
    word[p, k])."""
    inb, safe, cur = _rows(data, slot)
    kind = kind.reshape(-1)
    live = inb & ((kind == STORE) | (kind == CAS))
    ok = live & ((kind == STORE) | (cur == expected).all(1))
    _commit(data, meta, safe, ok, desired)
    return data, meta, ok.to(torch.int32)[:, None], cur


def cas_apply_rounds_ref(data, meta, slot, kind, expected, desired,
                         rounds: int, upd_rank):
    """`rounds` rounds of `cas_apply_round_ref`: round t takes the lanes
    with upd_rank == t; the others point at the dummy row n with kind 0.
    Returns (data, meta, success int32[p], witness word[p, k]), zero for a
    lane in no round."""
    n1 = data.shape[0]
    p, k = expected.shape
    success = torch.zeros((p,), dtype=torch.int32, device=data.device)
    witness = torch.zeros((p, k), dtype=data.dtype, device=data.device)
    for t in range(rounds):
        live = upd_rank == t
        slot_t = torch.where(live, slot, n1 - 1)
        kind_t = torch.where(live, kind, 0)
        data, meta, succ, wit = cas_apply_round_ref(data, meta, slot_t,
                                                    kind_t, expected, desired)
        success = torch.where(live, succ[:, 0], success)
        witness = torch.where(live[:, None], wit, witness)
    return data, meta, success, witness


def llsc_commit_round_ref(data, meta, slot, live, link_ver, desired):
    """One SC commit round (distinct live slots; dead lanes on row n):
    success = live & meta[slot, 0] == link_ver.  Returns (data, meta,
    success int32[p, 1], witness word[p, k])."""
    inb, safe, cur = _rows(data, slot)
    ver = meta[safe, 0]
    ok = inb & (live.reshape(-1) != 0) & (ver == link_ver.reshape(-1))
    _commit(data, meta, safe, ok, desired)
    return data, meta, ok.to(torch.int32)[:, None], cur


def cachehash_probe_ref(cells, bucket_idx, query_keys, *, kw, vw):
    """(hit int32[q, 1], empty int32[q, 1], value word[q, vw], next
    int32[q, 1]) for cell rows [key kw | value vw | next | flags | ...]."""
    inb, _, cell = _rows(cells, bucket_idx)
    key = cell[:, :kw]
    nxt = torch.where(inb, cell[:, kw + vw], -1)
    is_full = inb & (cell[:, kw + vw + 1] == FULL)
    hit = is_full & (key == query_keys).all(1)
    i32 = torch.int32
    return (hit.to(i32)[:, None], (~is_full).to(i32)[:, None],
            cell[:, kw:kw + vw].contiguous(), nxt[:, None])
