"""v1 load/store/CAS batch semantics — a facade over the unified engine.

The vectorised linearizer lives in `repro_torch.core.engine.linearize`.
What remains here is the v1 surface of the JAX package's module:

  * the kind constants LOAD/STORE/CAS/IDLE (numerically identical to the
    unified namespace, so a v1 `OpBatch` IS a valid unified batch),
  * `apply_batch(data, version, ops)` — the raw-tensor entry point,
  * `apply_batch_reference` — the sequential numpy oracle that defines
    store/CAS correctness,
  * `make_op_batch` / `random_batch` — batch constructors shared by tests
    and benchmarks.

Table-level callers should use `repro_torch.atomics.apply(spec, state,
ops)`.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import engine
from repro_torch.core.engine import (  # noqa: F401  (v1 re-exports)
    CAS, IDLE, LOAD, STORE, ApplyResult, ApplyStats, OpBatch,
)
from repro_torch.core.layout import WORD_DTYPE  # noqa: F401  (v1 re-export)


def make_op_batch(kind, slot, expected=None, desired=None, *, k: int,
                  device="cuda") -> OpBatch:
    """Checked constructor (validation + dtype coercion in `engine.make_ops`)."""
    return engine.make_ops(kind, slot, expected, desired, k=k, device=device)


def apply_batch_reference(data: np.ndarray, version: np.ndarray, ops):
    """Apply ops one at a time in lane order.  Pure numpy, for tests.

    Returns (new_data, new_version, ApplyResult-as-numpy)."""
    p, k = np.asarray(ops[3]).shape
    ctx = engine.LinkCtx(np.full(p, -1, np.int32), np.zeros(p, np.uint32),
                         np.zeros((p, k), np.uint32), np.zeros(p, bool))
    new_data, new_version, _, result = engine.apply_ops_reference(
        data, version, ctx, ops)
    return new_data, new_version, result


def apply_batch(data, version, ops: OpBatch):
    """Linearize and apply a batch of ops.  Returns (data, version, result,
    stats).

    `data` is word[n, k]; `version` word[n] (bumped by 2 per successful
    update).  Both are updated in place, as the reference donates them:
    the caller must not reuse the tensors it passed."""
    ops = engine.canonicalize_ops(ops, data.device)
    new_data, new_version, _, result, stats, _ = engine.linearize(
        data, version, engine.init_ctx(ops.p, ops.k, device=data.device),
        ops)
    return new_data, new_version, result, stats


def random_batch(rng: np.random.Generator, *, p: int, n: int, k: int,
                 update_frac: float = 0.5, zipf: float = 0.0,
                 current: np.ndarray | None = None,
                 device="cuda") -> OpBatch:
    """Paper-style workload: u%% updates (half store, half CAS), Zipfian
    slots; the reference's draws, in the same order, from `rng`.

    If `current` (the live table) is given, half the CAS ops use the true
    current value as `expected` so they succeed; otherwise comparands are
    random (mostly failing)."""
    if zipf <= 0.0:
        slots = rng.integers(0, n, size=p)
    else:
        ranks = rng.zipf(max(zipf, 1.01), size=p)   # zipf >= 1 required
        slots = (ranks - 1) % n
    u = rng.random(p) < update_frac
    is_cas = rng.random(p) < 0.5
    kind = np.where(u, np.where(is_cas, CAS, STORE), LOAD).astype(np.int32)
    desired = rng.integers(0, 2**32, size=(p, k), dtype=np.uint32)
    expected = rng.integers(0, 2**32, size=(p, k), dtype=np.uint32)
    if current is not None:
        use_cur = rng.random(p) < 0.5
        expected = np.where(use_cur[:, None], current[slots], expected)
    return engine.make_ops(kind, slots.astype(np.int32), expected, desired,
                           k=k, device=device)
