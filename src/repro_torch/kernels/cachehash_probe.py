"""CacheHash bucket probe with the first chain link inlined.

CacheHash inlines the first link of each chain into the bucket array, so
the common case (a hit on the first link, or a miss on an empty bucket)
costs ONE memory access: one read of the bucket row

    cell = [key kw | value vw | next | flags | version | pad]

at a bucket index the caller hashed.  `cachehash_probe` replaces the
reference's Pallas kernel with the CUDA kernel `cachehash_probe_kernel`
(`csrc/table_ops.cu`): one thread per query compares the inlined key and
emits (hit, empty, value, next).  The chain walk for the rare collision
case stays in plain tensor code (`ops.cachehash_find`).
"""

from __future__ import annotations

import torch

from repro_torch.core.layout import WORD_DTYPE
from repro_torch.kernels import _build
from repro_torch.kernels.ref import EMPTY, FULL, cachehash_probe_ref

__all__ = ["EMPTY", "FULL", "cachehash_probe"]


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
    if kw < 1 or vw < 0 or cw < kw + vw + 2:
        raise ValueError(f"cachehash_probe: a {cw}-word cell cannot hold "
                         f"kw={kw} key words, vw={vw} value words, next and "
                         "flags")
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


cachehash_probe.launches = 0
