"""The raw-table layer: public functions around the table kernels.

Plain tensor code around the kernels, structured as the reference's
`kernels/ops.py`: a batched load (`seqlock_gather`), multi-round STORE/CAS
(`cas_apply_rounds`: every round in one kernel launch, where the reference
launches its Pallas kernel once per round), the CacheHash hash and lookup
(`cachehash_probe`, then a bounded chain walk).  The tensors' device picks
the kernel (CUDA) or its plain version (CPU); the reference's
`interpret=` arguments, `on_cpu()` and the 128-lane `pad_cells` do not
carry over.
"""

from __future__ import annotations

import torch

from repro_torch.core.layout import as_u64
from repro_torch.kernels.cachehash_probe import cachehash_probe
from repro_torch.kernels.cas_apply import cas_apply_rounds
from repro_torch.kernels.seqlock_gather import seqlock_gather

_GOLDEN = 0x9E3779B1
_MASK = 0xFFFFFFFF


def bigatomic_load(data, meta, idx):
    """Fast-path batched load (kernel) -> (values word[q, k], ok bool[q])."""
    vals, ok = seqlock_gather(data, meta, idx)
    return vals, ok[:, 0] != 0


def bigatomic_update_rounds(data, meta, slot, kind, expected, desired,
                            rounds: int, upd_rank):
    """Apply `rounds` combining rounds of STORE/CAS with `cas_apply_rounds`
    (one kernel launch on a card).

    slot/kind/expected/desired are the SORTED op list (lanes sorted by
    slot); upd_rank[i] is op i's serialization round, and within a round
    the live slots are distinct (so a cell's live ops rise in round with
    lane order).  A lane in round t < rounds is live; a LOAD lane reads its
    witness and fails, as in the reference; a lane in no round gets zeros.
    Updates `data` and `meta` in place; returns (data, meta, success
    int32[p], witness word[p, k])."""
    return cas_apply_rounds(data, meta, slot, kind, expected, desired,
                            rounds, upd_rank)


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


def cachehash_find(cells, chain_pool, query_keys, *, kw: int, vw: int,
                   max_chain: int = 8):
    """Full CacheHash lookup: kernel probe of the inlined first link, then a
    bounded chain walk for the rare collision case.

    cells: word[m, cw]; chain_pool: word[c, cw] (same layout); returns
    (found bool[q], value word[q, vw]).  On a miss the value is the
    bucket's inlined value, as in the reference; chain nodes match on the
    key alone."""
    m = cells.shape[0]
    last = chain_pool.shape[0] - 1
    bidx = hash_keys(query_keys, m)
    hit, empty, value, nxt = cachehash_probe(cells, bidx, query_keys, kw=kw,
                                             vw=vw)
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
