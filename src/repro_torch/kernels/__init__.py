"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

  engine_round     the fused engine round: `fast_round` for collision-free
                   batches, `slow_round` for sorted contended batches
                   (`csrc/engine_round.cu`)
  seqlock_gather   version-validated k-word cell gather (the fast path)
  cas_apply        one conflict-free combining round of STORE/CAS
  llsc_commit      fused validate + commit SC round, and the spec-routed
                   `commit_round` over the engine round
  cachehash_probe  CacheHash bucket probe with the inlined first link
                   (the last four: `csrc/table_ops.cu`)
  scrub_digest     the integrity scrub's per-cell FNV-1a digest,
                   `digest_rows` (`csrc/scrub_digest.cu`)
  flash_attention  forward attention with an online softmax
                   (`csrc/flash_attention.cu`)

`ops.py` holds the raw-table layer around them, `ref.py` the plain versions
of the table kernels.  Importing the package builds nothing: each kernel
library is compiled at its first launch (`_build.py`).  The reference's
names `fast_round_pallas` / `slow_round_pallas` stand for `fast_round` /
`slow_round`.
"""

from repro_torch.kernels.cachehash_probe import cachehash_probe  # noqa: F401
from repro_torch.kernels.cas_apply import cas_apply_round  # noqa: F401
from repro_torch.kernels.engine_round import (  # noqa: F401
    fast_path_ok, fast_round, make_round, slow_round,
)
# (bound under another name: `kernels.flash_attention` stays the module)
from repro_torch.kernels.flash_attention import (
    flash_attention as _flash_attention,
)
from repro_torch.kernels.llsc_commit import llsc_commit_round  # noqa: F401
from repro_torch.kernels.scrub_digest import digest_rows  # noqa: F401
from repro_torch.kernels.seqlock_gather import seqlock_gather  # noqa: F401

fast_round_pallas = fast_round
slow_round_pallas = slow_round

# Every kernel wrapper, by the name its `.launches` count is reported under.
WRAPPERS = {fn.__name__: fn for fn in (
    fast_round, slow_round, seqlock_gather, cas_apply_round,
    llsc_commit_round, cachehash_probe, digest_rows, _flash_attention)}


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    """Zero the launch count of every kernel wrapper."""
    for fn in WRAPPERS.values():
        fn.launches = 0
