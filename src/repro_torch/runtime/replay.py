"""Sequential replay of an executor history: the multi-stream interleaving
as ONE linearization.

`replay_history` replays a `runtime.Executor` issue history (S streams'
batches in their issue interleaving, each with its claimed per-batch order)
through one sequential numpy oracle, `core.engine.apply_ops_reference`, and
diffs every delivered result.  Stream `si` owns a fixed lane slice of a
width-`sum(widths)` oracle, so per-stream LL/SC link state persists across
batches exactly as the executor's per-stream `LinkCtx` does; lanes of other
streams are IDLE in a stream's step and change nothing, so the replay steps
only the owning stream's lanes.  The reference's
`tests/oracle.replay_executor_history` is the same replay; this copy lets
the port's chaos harness and `chip_smoke.py` check a history without it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.core import engine


class ReplayOracle(NamedTuple):
    """The replay's final table (uint32 words)."""
    data: np.ndarray
    version: np.ndarray


def replay_history(n: int, k: int, widths, history, *, initial=None,
                   check: bool = True) -> ReplayOracle:
    """Replay `history` (retired `IssueRec`s: value/success filled) through
    the sequential oracle; with `check`, raise AssertionError on the first
    delivered value or success that differs.  Returns the oracle's final
    data and versions for end-state diffs against the target."""
    data = np.zeros((n, k), np.uint32) if initial is None \
        else np.array(initial, np.uint32)
    version = np.zeros((n,), np.uint32)
    ctx = [engine.LinkCtx(np.full((w,), -1, np.int32),
                          np.zeros((w,), np.uint32),
                          np.zeros((w, k), np.uint32), np.zeros((w,), bool))
           for w in widths]
    for rec in history:
        si, w = rec.stream, widths[rec.stream]
        kind = np.asarray(rec.ops.kind)
        q = kind.shape[0]
        assert q <= w, f"stream {si} batch width {q} > declared {w}"
        order = np.arange(q) if rec.order is None \
            else np.asarray(rec.order, np.int64)
        ops = engine.OpBatch(kind[order], np.asarray(rec.ops.slot)[order],
                             np.asarray(rec.ops.expected)[order],
                             np.asarray(rec.ops.desired)[order])
        sub_ctx = engine.LinkCtx(*(np.asarray(x)[order] for x in ctx[si]))
        data, version, new_ctx, res = engine.apply_ops_reference(
            data, version, sub_ctx, ops, copy=False)
        merged = engine.LinkCtx(*(np.array(x, copy=True) for x in ctx[si]))
        for field, rows in zip(engine.LinkCtx._fields, new_ctx):
            getattr(merged, field)[order] = rows
        ctx[si] = merged
        value = np.zeros((q, k), np.uint32)
        success = np.zeros((q,), bool)
        value[order] = res.value
        success[order] = res.success
        if not check:
            continue
        msg = f"stream {si} seq {rec.seq}"
        np.testing.assert_array_equal(rec.value, value,
                                      err_msg=f"{msg}: values")
        np.testing.assert_array_equal(rec.success, success,
                                      err_msg=f"{msg}: success")
        if rec.overflow is not None:
            assert not np.asarray(rec.success)[rec.overflow].any(), \
                f"{msg}: overflow lanes must report success=False"
    return ReplayOracle(data, version)
