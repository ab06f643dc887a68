"""The version-validated k-word cell gather (the fast path of a load).

A big-atomic load is ONE contiguous cell read: the data row plus its two
metadata words (version, mark), no pointer chase.  `seqlock_gather`
replaces the reference's Pallas kernel of the same name with the CUDA
kernel `seqlock_gather_kernel` (`csrc/table_ops.cu`): one thread per query
reads its row and meta row and reports ok = version even & mark == 0; the
caller sends !ok rows to the slow path.  The reference's lane tiles of 8 and
their padding do not carry over.
"""

from __future__ import annotations

import torch

from repro_torch.core.layout import WORD_DTYPE
from repro_torch.kernels import _build
from repro_torch.kernels.ref import seqlock_gather_ref


def seqlock_gather(data: torch.Tensor, meta: torch.Tensor, idx: torch.Tensor):
    """data: word[n, k]; meta: word[n, 2] = (version, mark); idx: int32[q]
    in [0, n).  Returns (values word[q, k], ok int32[q, 1]).  An idx outside
    [0, n) is a dead lane: zero values, ok 0, no table access.

    CPU tensors run `ref.seqlock_gather_ref`; CUDA tensors launch the
    kernel or raise."""
    n, k = data.shape
    q = idx.shape[0]
    dev = data.device
    _build.check(dev, ("data", data, WORD_DTYPE, (n, k)),
                 ("meta", meta, WORD_DTYPE, (n, 2)),
                 ("idx", idx, torch.int32, (q,)))
    if _build.runs_plain(dev, "seqlock_gather"):
        return seqlock_gather_ref(data, meta, idx)
    vals = torch.empty((q, k), dtype=WORD_DTYPE, device=dev)
    ok = torch.empty((q, 1), dtype=torch.int32, device=dev)
    if q:
        _build.launch("table_ops", "seqlock_gather", dev, data.data_ptr(),
                      meta.data_ptr(), n, k, idx.data_ptr(), q,
                      vals.data_ptr(), ok.data_ptr())
        seqlock_gather.launches += 1
    return vals, ok


seqlock_gather.launches = 0
