"""CacheHash bucket probe with the first chain link inlined.

CacheHash inlines the first link of each chain into the bucket array, so
the common case (a hit on the first link, or a miss on an empty bucket)
costs ONE memory access: one read of the bucket row

    cell = [key kw | value vw | next | flags | version | pad]

at a bucket index the caller hashed.  `cachehash_probe` replaces the
reference's Pallas kernel with the CUDA kernel `cachehash_kernel`
(`csrc/table_ops.cu`, FIND = false): one thread per query compares the
inlined key and emits (hit, empty, value, next).  `cachehash_find` is the
whole lookup of the reference's `ops.cachehash_find` in one launch of the
same kernel (FIND = true): one thread per query hashes its key, probes its
bucket and walks the chain for the rare collision case.  The reference
left the hash to the host and the walk to jnp because a TPU grid step is
one row DMA and a dependent pointer chase a separate gather wave; a CUDA
thread follows `next` itself.
"""

from __future__ import annotations

import torch

from repro_torch.core.layout import WORD_DTYPE
from repro_torch.kernels import _build
from repro_torch.kernels.ref import (
    EMPTY, FULL, cachehash_find_ref, cachehash_probe_ref,
)

__all__ = ["EMPTY", "FULL", "cachehash_find", "cachehash_probe"]


def _check_widths(who, cw, kw, vw):
    if kw < 1 or vw < 0 or cw < kw + vw + 2:
        raise ValueError(f"{who}: a {cw}-word cell cannot hold kw={kw} key "
                         f"words, vw={vw} value words, next and flags")


def cachehash_probe(cells, bucket_idx, query_keys, *, kw: int, vw: int):
    """cells: word[m, cw] bucket array (cw >= kw + vw + 2); bucket_idx:
    int32[q]; query_keys: word[q, kw].

    Returns (hit int32[q, 1], empty int32[q, 1], value word[q, vw], next
    int32[q, 1]); next is the next word's bits as int32, so 0xFFFFFFFF is
    the terminator -1.  A bucket index outside [0, m) is a dead lane that
    reports an empty bucket: hit 0, empty 1, zero value, next -1.

    CPU tensors run `ref.cachehash_probe_ref`; CUDA tensors launch the
    kernel or raise."""
    m, cw = cells.shape
    q = bucket_idx.shape[0]
    _check_widths("cachehash_probe", cw, kw, vw)
    dev = cells.device
    _build.check(dev, ("cells", cells, WORD_DTYPE, (m, cw)),
                 ("bucket_idx", bucket_idx, torch.int32, (q,)),
                 ("query_keys", query_keys, WORD_DTYPE, (q, kw)))
    if _build.runs_plain(dev, "cachehash_probe"):
        return cachehash_probe_ref(cells, bucket_idx, query_keys, kw=kw,
                                   vw=vw)
    i32 = torch.int32
    hit = torch.empty((q, 1), dtype=i32, device=dev)
    empty = torch.empty((q, 1), dtype=i32, device=dev)
    value = torch.empty((q, vw), dtype=WORD_DTYPE, device=dev)
    nxt = torch.empty((q, 1), dtype=i32, device=dev)
    if q:
        _build.launch("table_ops", "cachehash_probe", dev, cells.data_ptr(),
                      m, cw, bucket_idx.data_ptr(), query_keys.data_ptr(), q,
                      kw, vw, hit.data_ptr(), empty.data_ptr(),
                      value.data_ptr(), nxt.data_ptr())
        cachehash_probe.launches += 1
    return hit, empty, value, nxt


def cachehash_find(cells, chain_pool, query_keys, *, kw: int, vw: int,
                   max_chain: int = 8):
    """Full CacheHash lookup: the key hashed (`ref.hash_keys`), the inlined
    first link of its bucket probed, then a chain walk of at most
    `max_chain` steps for the rare collision case.

    cells: word[m, cw]; chain_pool: word[c, cw] (same layout); query_keys:
    word[q, kw].  Returns (found bool[q], value word[q, vw]).  On a miss
    the value is the bucket's inlined value, as in the reference; chain
    nodes match on the key alone, and a `next` past the pool's end reads
    its last node.

    CPU tensors run `ref.cachehash_find_ref`; CUDA tensors launch the find
    kernel once and nothing else, or raise (an empty table, or an empty
    pool with max_chain > 0, raises as the plain version does)."""
    m, cw = cells.shape
    c = chain_pool.shape[0]
    q = query_keys.shape[0]
    _check_widths("cachehash_find", cw, kw, vw)
    dev = cells.device
    _build.check(dev, ("cells", cells, WORD_DTYPE, (m, cw)),
                 ("chain_pool", chain_pool, WORD_DTYPE, (c, cw)),
                 ("query_keys", query_keys, WORD_DTYPE, (q, kw)))
    if _build.runs_plain(dev, "cachehash_find"):
        return cachehash_find_ref(cells, chain_pool, query_keys, kw=kw,
                                  vw=vw, max_chain=max_chain)
    max_chain = max(0, min(int(max_chain), 2 ** 31 - 1))
    if q and m == 0:                      # the plain version's `% m`
        raise RuntimeError("ZeroDivisionError")
    if q and c == 0 and max_chain:        # its gather from an empty pool
        raise IndexError("index is out of bounds for dimension with size 0")
    found = torch.empty((q,), dtype=torch.bool, device=dev)
    value = torch.empty((q, vw), dtype=WORD_DTYPE, device=dev)
    if q:
        _build.launch("table_ops", "cachehash_find", dev, cells.data_ptr(),
                      m, cw, chain_pool.data_ptr(), c,
                      query_keys.data_ptr(), q, kw, vw, max_chain,
                      found.data_ptr(), value.data_ptr())
        cachehash_find.launches += 1
    return found, value


cachehash_probe.launches = 0
cachehash_find.launches = 0
