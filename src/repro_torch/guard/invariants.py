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
  version lists     head_prev_agrees     head's prev pointer names the ring
                                         slot the last publish displaced
                    head_ts_newest       every published pool node is older
                                         than the inline head
"""

from __future__ import annotations

import torch

from repro_torch.core.layout import as_u64, to_word
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


def check_version_list(vspec, vstate) -> dict:
    """Head/pool agreement for `txn.versionlist` chains (bool[n] masks on
    the state's device, no host read).

    A healthy slot's inline head is its newest version: the head's `prev`
    word names exactly the ring slot the last publish displaced into
    (NULLV before any publish), and every published pool node carries a
    strictly older timestamp than the head (`publish` requires strictly
    increasing ts per slot).  Timestamps, counts and pointers compare as
    the reference's uint32 words."""
    from repro_torch.txn.versionlist import NULLV
    k, rd = vspec.k, vspec.ring_depth
    head = get_strategy(vspec.strategy).logical(vstate.table)   # [n, k+2]
    hts, hprev = as_u64(head[:, k]), head[:, k + 1]
    cnt = as_u64(vstate.count)
    dev = cnt.device
    slots = torch.arange(vspec.n, dtype=torch.int64, device=dev)
    last_pos = torch.where(cnt > 0, (cnt - 1) % rd, 0)
    expect = torch.where(cnt > 0, to_word(slots * rd + last_pos), NULLV)
    pool_ts = as_u64(vstate.pool[:, :, k])                      # [n, rd]
    published = (torch.arange(rd, device=dev)[None, :]
                 < cnt.clamp(max=rd)[:, None])
    return {
        "head_prev_agrees": hprev != expect,
        "head_ts_newest": (published & (pool_ts >= hts[:, None])).any(1),
    }
