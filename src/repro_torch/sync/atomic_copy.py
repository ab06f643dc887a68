"""Linearizable big-atomic -> big-atomic copy, built on LL/SC.

Blelloch & Wei's atomic copy reads a source cell and writes its k words to
a destination cell so that the whole transfer is observable at a single
point.  In the batch-step model a `copy_batch` call applies q copies in
lane order; copies may chain (lane j's source is lane i's destination) and
may collide (two lanes, one destination) — the sequential oracle defines
the result.

Lanes are scheduled into *waves* such that no lane shares a
source-after-write or destination with an earlier unfinished lane.  A wave
is two unified-engine calls:

  1. one mixed batch: LL lanes link every destination while LOAD lanes read
     every source, linearized together in one call;
  2. SC every destination with the loaded source bytes.

Within a wave nothing intervenes between a lane's source read and its SC,
so the SC always succeeds and the loop ends in at most q waves.  Wave
scheduling is host-side (numpy) because the conflict graph is
data-dependent; each wave's table work is `atomics.apply`, so every
layout's maintenance (and the round's kernels, on a card) is exercised.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.specs import AtomicSpec


def copy_batch_reference(data: np.ndarray, version: np.ndarray,
                         src: np.ndarray, dst: np.ndarray):
    """Sequential oracle: copies applied one at a time in lane order."""
    data = np.array(data, copy=True)
    version = np.array(version, copy=True)
    for s, d in zip(np.asarray(src), np.asarray(dst)):
        data[d] = data[s]
        version[d] += 2
    return data, version


def _waves(src: np.ndarray, dst: np.ndarray) -> list[np.ndarray]:
    """Partition lanes into waves.  For earlier lane i and later lane j:
    j reads/writes what i writes (dst_i in {src_j, dst_j}) -> j waits a full
    wave; i reads what j writes (src_i == dst_j) -> j may not run EARLIER
    than i (same wave is fine: a wave's reads all precede its writes).

    The reference's double loop over lane pairs, with the inner loop over
    the earlier lanes done as numpy array operations: the same depths,
    O(q) Python steps."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    q = len(src)
    depth = np.zeros(q, np.int64)
    for j in range(1, q):
        before = depth[:j]
        wait = (dst[:j] == src[j]) | (dst[:j] == dst[j])
        same = src[:j] == dst[j]
        d = 0
        if wait.any():
            d = int(before[wait].max()) + 1
        if same.any():
            d = max(d, int(before[same].max()))
        depth[j] = d
    return [np.nonzero(depth == t)[0] for t in range(int(depth.max()) + 1)] \
        if q else []


def copy_batch(spec: AtomicSpec, state, src, dst):
    """Atomically copy cell src[i] -> dst[i] for each lane, in lane order.

    Returns (state', n_waves).  Linearizable: matches
    `copy_batch_reference` on the logical values for every strategy.  The
    caller's `state` stays valid (the first wave copies it; the later ones
    update that copy in place)."""
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    k = spec.k
    dev = state.version.device
    n_waves = 0
    for lanes in _waves(src, dst):
        m = len(lanes)
        donate = n_waves > 0
        # 1. One mixed batch: lanes 0..m-1 LL the destinations, lanes
        #    m..2m-1 LOAD the sources — a single linearization.
        kind = np.concatenate([np.full(m, engine.LL, np.int32),
                               np.full(m, engine.LOAD, np.int32)])
        slots = np.concatenate([dst[lanes], src[lanes]])
        ctx = engine.init_ctx(2 * m, k, device=dev)
        state, ctx, res, _, _ = engine.apply(
            spec, state, engine.make_ops(kind, slots, k=k, device=dev), ctx,
            donate=donate)
        src_vals = res.value[m:]
        # 2. Commit; fresh links with nothing in between => always succeeds.
        kind = np.concatenate([np.full(m, engine.SC, np.int32),
                               np.full(m, engine.IDLE, np.int32)])
        desired = torch.cat([src_vals, torch.zeros_like(src_vals)])
        state, ctx, _res, _, _ = engine.apply(
            spec, state, engine.make_ops(kind, slots, desired=desired, k=k,
                                         device=dev), ctx, donate=True)
        n_waves += 1
    return state, n_waves
