"""The raw-table layer: public functions around the table kernels.

Plain tensor code around the kernels, structured as the reference's
`kernels/ops.py`: a batched load (`seqlock_gather`), multi-round STORE/CAS
(`cas_apply_rounds`: every round in one kernel launch, where the reference
launches its Pallas kernel once per round), the CacheHash hash
(`hash_keys`, tensor code) and lookup (`cachehash_find`: hash, probe and
bounded chain walk in one kernel launch, where the reference hashes and
walks in jnp around its probe kernel).  The tensors' device picks the
kernel (CUDA) or its plain version (CPU); the reference's `interpret=`
arguments, `on_cpu()` and the 128-lane `pad_cells` do not carry over.
"""

from __future__ import annotations

from repro_torch.kernels.cachehash_probe import cachehash_find
from repro_torch.kernels.cas_apply import cas_apply_rounds
from repro_torch.kernels.ref import hash_keys
from repro_torch.kernels.seqlock_gather import seqlock_gather

__all__ = ["bigatomic_load", "bigatomic_update_rounds", "cachehash_find",
           "hash_keys"]


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
