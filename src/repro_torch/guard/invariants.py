"""Structural invariants of the big-atomic layouts.

Each registered strategy exposes its at-rest redundancy through the
`StrategyImpl.check_invariants(spec, state)` registry hook; this module is
the front door the scrub pass (and tests) call.  An *invariant* here is a
property every quiescent state reachable by the engine satisfies, so any
violation proves corruption (no false positives), while satisfying all of
them proves nothing: a flipped data bit leaves every structural invariant
intact, which is what the scrub digest is for.

Per-layout invariants (`core/strategies.py`):

  all versioned     version_parity       even version at rest
  simplock          lock_released        no lock word held at rest
  indirect          pointer_range        bptr in [0, pool)
                    shadow_agrees        data == pool[bptr]
  cached_wf         pointer_range        bptr in [0, pool)
                    cache_matches_backup data == pool[bptr]
                    mark_clear           no invalidation mark at rest
  cached_me         tagged_null          bptr is NULL or -(tag+2) with
                                         tag = (version >> 1) & 0x3FFFFFFF

The version-list checks (`check_version_list`) come with the transactions
slice.
"""

from __future__ import annotations

import torch

from repro_torch.core.registry import get_strategy


def check_invariants(spec, state) -> dict:
    """{invariant_name: bool[n] violation mask} for the table's strategy
    at a quiescent point (no batch in flight); masks lie on the table's
    device."""
    return get_strategy(spec.strategy).check_invariants(spec, state)


def violation_mask(spec, state) -> torch.Tensor:
    """bool[n] on the table's device: cells violating ANY structural
    invariant."""
    out = torch.zeros((spec.n,), dtype=torch.bool,
                      device=state.version.device)
    for m in check_invariants(spec, state).values():
        out |= m
    return out
