"""Plain PyTorch versions of the raw-table kernels (the definition of
correctness).

Each function computes exactly what the corresponding CUDA kernel in
`csrc/table_ops.cu` computes, with vectorised gathers and `where`: within a
round the live slots are distinct, so gathering every lane's pre-round row
at once is the sequential order.  `cas_apply_rounds_ref` is the round loop
that the one-launch `cas_apply_rounds` kernel replays per segment;
`cachehash_find_ref` is `hash_keys`, the probe and the chain walk as
tensor code, each lane walking in step with the others, that the find
kernel runs in one thread a query.  The wrappers run these on CPU tensors,
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

from repro_torch.core.layout import as_u64, scatter_set

STORE = 1
CAS = 2
# flags word values of a CacheHash cell (matches core.cachehash)
EMPTY = 0
FULL = 1
_GOLDEN = 0x9E3779B1
_MASK = 0xFFFFFFFF


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


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """h * c modulo 2^32 for int64 h in [0, 2^32), without int64 overflow:
    c is split into 16-bit halves."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def hash_keys(keys: torch.Tensor, m: int) -> torch.Tensor:
    """Fibonacci-style multiplicative hash of word[q, kw] -> bucket
    int32[q], in uint32 arithmetic: the words are widened to int64 as
    unsigned values, so `>>` is logical and `% m` unsigned."""
    h = torch.zeros(keys.shape[0], dtype=torch.int64, device=keys.device)
    for j in range(keys.shape[1]):
        h = _mul32(h ^ as_u64(keys[:, j]), _GOLDEN)
        h = h ^ (h >> 15)
    return (h % m).to(torch.int32)


def cachehash_find_ref(cells, chain_pool, query_keys, *, kw, vw,
                       max_chain=8):
    """(found bool[q], value word[q, vw]): the probe of the hashed bucket's
    inlined first link, then a chain walk of at most `max_chain` steps for
    every lane at once; a node is chain_pool[clamp(cur, 0, c - 1)], a step
    hits on the key alone, and on a miss the value is the bucket's
    inlined value."""
    m = cells.shape[0]
    last = chain_pool.shape[0] - 1
    bidx = hash_keys(query_keys, m)
    hit, empty, value, nxt = cachehash_probe_ref(cells, bidx, query_keys,
                                                 kw=kw, vw=vw)
    found = hit[:, 0] != 0
    cur = nxt[:, 0]
    done = found | (empty[:, 0] != 0) | (cur < 0)
    val = value
    for _ in range(max_chain):                      # slow path: chain walk
        node = chain_pool[cur.clamp(0, last).to(torch.int64)]
        nkey = node[:, :kw]
        nval = node[:, kw:kw + vw]
        nnxt = node[:, kw + vw]
        step_hit = ~done & (cur >= 0) & (nkey == query_keys).all(1)
        val = torch.where(step_hit[:, None], nval, val)
        found = found | step_hit
        done = done | step_hit | (nnxt < 0) | (cur < 0)
        cur = torch.where(done, cur, nnxt)
    return found, val
