"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

  engine_round     the fused engine round: `round_prologue` for the
                   predicate and the sorted lanes, `fast_round` for
                   collision-free batches, `slow_round` for sorted
                   contended batches, `round_epilogue` for the results,
                   stats and dirty cells of both (`csrc/engine_round.cu`)
  seqlock_gather   version-validated k-word cell gather (the fast path)
  cas_apply        one conflict-free combining round of STORE/CAS, and
                   all the rounds of a sorted op list in one launch
                   (`cas_apply_rounds`, the segment replay it shares with
                   `slow_round`: `csrc/segment_replay.cuh`)
  llsc_commit      fused validate + commit SC round, and the spec-routed
                   `commit_round` over the engine round
  cachehash_probe  CacheHash bucket probe with the inlined first link,
                   and the whole lookup in one launch (`cachehash_find`:
                   hash, probe, chain walk; the last four:
                   `csrc/table_ops.cu`)
  scrub_digest     the integrity scrub's per-cell FNV-1a digest,
                   `digest_rows` (`csrc/scrub_digest.cu`)
  flash_attention  forward attention with an online softmax: the wgmma
                   kernel for bf16 at every head dim 1-256
                   (`csrc/flash_attention_wgmma.cu`), the 3xTF32 kernel
                   for fp32 at every head dim 1-256
                   (`csrc/flash_attention_tf32x3.cu`); its backward,
                   bf16 on the tensor cores from the forward's LSE
                   (`csrc/flash_attention_bwd_wgmma.cu`), fp32 on the
                   CUDA cores (`csrc/flash_attention_bwd.cu`), behind the
                   autograd Function `FlashAttention`

`ops.py` holds the raw-table layer around them, `ref.py` the plain versions
of the table kernels.  Importing the package builds nothing: each kernel
library is compiled at its first launch (`_build.py`).  The reference's
names `fast_round_pallas` / `slow_round_pallas` stand for `fast_round` /
`slow_round`.
"""

from repro_torch.kernels.cachehash_probe import (  # noqa: F401
    cachehash_find, cachehash_probe,
)
from repro_torch.kernels.cas_apply import (  # noqa: F401
    cas_apply_round, cas_apply_rounds,
)
from repro_torch.kernels.engine_round import (  # noqa: F401
    fast_path_ok, fast_round, make_round, round_epilogue, round_prologue,
    slow_round,
)
from repro_torch.kernels.flash_attention import BACKWARD as _ATTENTION_BWD
from repro_torch.kernels.flash_attention import KERNELS as _ATTENTION
from repro_torch.kernels.llsc_commit import llsc_commit_round  # noqa: F401
from repro_torch.kernels.scrub_digest import digest_rows  # noqa: F401
from repro_torch.kernels.seqlock_gather import seqlock_gather  # noqa: F401

fast_round_pallas = fast_round
slow_round_pallas = slow_round

# Every kernel's launcher, by the name its `.launches` count is reported
# under: the wrapper itself, or for attention one launcher per kernel.
WRAPPERS = {fn.__name__: fn for fn in (
    round_prologue, fast_round, slow_round, round_epilogue, seqlock_gather,
    cas_apply_round, cas_apply_rounds, llsc_commit_round, cachehash_probe,
    cachehash_find, digest_rows)} \
    | _ATTENTION | _ATTENTION_BWD


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    """Zero the launch count of every kernel wrapper."""
    for fn in WRAPPERS.values():
        fn.launches = 0
