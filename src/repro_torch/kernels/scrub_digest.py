"""The per-cell FNV-1a digest of the integrity scrub.

`digest_rows(vals, ver)` replaces the reference's Pallas pass
`guard/scrub.py::_digest_pallas` with the CUDA kernel `digest_rows_kernel`
(`csrc/scrub_digest.cu`): one thread per cell chains its k logical words,
then its version, through `h = (h ^ w) * FNV_PRIME` from `FNV_OFFSET`, in
uint32 with wraparound.  `digest_rows_plain` is the same function in plain
PyTorch (the twin of the reference's `_digest_xla`).  The wrapper lives
here rather than in `guard` so that `kernels.WRAPPERS` can list it without
an import cycle.
"""

from __future__ import annotations

import torch

from repro_torch.core.layout import WORD_DTYPE, as_u64, to_word
from repro_torch.kernels import _build

FNV_OFFSET = 2166136261
FNV_PRIME = 16777619


def digest_rows_plain(vals: torch.Tensor, ver: torch.Tensor) -> torch.Tensor:
    """word[n] digest of word rows `vals[n, k]` and versions `ver[n]`.

    Products are taken in int64 on the unsigned value and masked to 32
    bits: a value below 2^32 times FNV_PRIME (below 2^25) fits."""
    h = torch.full(ver.shape, FNV_OFFSET, dtype=torch.int64,
                   device=ver.device)
    for j in range(vals.shape[1]):
        h = ((h ^ as_u64(vals[:, j])) * FNV_PRIME) & 0xFFFFFFFF
    return to_word(((h ^ as_u64(ver)) * FNV_PRIME) & 0xFFFFFFFF)


def digest_rows(vals: torch.Tensor, ver: torch.Tensor) -> torch.Tensor:
    """vals: word[n, k]; ver: word[n].  Returns the word[n] digest.

    CPU tensors run `digest_rows_plain`; CUDA tensors launch the kernel or
    raise."""
    n, k = vals.shape
    dev = vals.device
    _build.check(dev, ("vals", vals, WORD_DTYPE, (n, k)),
                 ("ver", ver, WORD_DTYPE, (n,)))
    if _build.runs_plain(dev, "digest_rows"):
        return digest_rows_plain(vals, ver)
    out = torch.empty((n,), dtype=WORD_DTYPE, device=dev)
    if n:
        _build.launch("scrub_digest", "digest_rows", dev, vals.data_ptr(),
                      ver.data_ptr(), n, k, out.data_ptr())
        digest_rows.launches += 1
    return out


digest_rows.launches = 0
