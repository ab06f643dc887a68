"""k-word Load-Linked / Store-Conditional — the v1 shim over `atomics.apply`.

LL/SC is the paper's headline application of big atomics: a k-word LL
records the cell's *version* alongside its value, and the matching SC
commits iff the version is still the one that was linked.  Because the
comparison is on the version — not the value — SC is immune to ABA (a cell
restored to its linked bytes after intervening commits still fails) and to
lapped linkers (a lane that held its link across many other commits).

LL/SC is not a separate subsystem: the unified engine linearizes LL / SC /
VALIDATE lanes in the same batch as LOAD / STORE / CAS, and a batch with
no store/CAS lanes resolves on the round's fast path or its closed form.
New code should call

    repro_torch.atomics.apply(spec, state, ops, ctx)

with the sync kinds of `repro_torch.atomics` (LL / SC / VALIDATE).  This
module keeps the v1 surface — `SyncOpBatch` (its own kind numbering),
`apply_sync`, the `ll` / `sc` / `validate` wrappers and the sequential
oracle; `apply_sync` warns once and defers to the unified engine.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import bigatomic as ba
from repro_torch.core import engine
from repro_torch.core.deprecation import warn_once
from repro_torch.core.engine import LinkCtx, init_ctx  # noqa: F401
from repro_torch.core.layout import WORD_DTYPE, as_words, resolve_device

# Legacy sync op kinds (v1 numbering, distinct from the unified namespace;
# `_TO_UNIFIED` maps them onto engine.LL / engine.SC / engine.VALIDATE).
LL = 0     # load-linked: read value, link (slot, version)
SC = 1     # store-conditional: commit desired iff link still valid
VL = 2     # validate: is my link still valid?  (never writes)
IDLE = 3   # padding lane

_TO_UNIFIED = (engine.LL, engine.SC, engine.VALIDATE, engine.IDLE)


class SyncOpBatch(NamedTuple):
    """Legacy batch of p sync ops.  kind: int32[p] (v1 numbering);
    slot: int32[p]; desired: word[p, k] (SC payload; ignored otherwise)."""

    kind: torch.Tensor
    slot: torch.Tensor
    desired: torch.Tensor

    @property
    def p(self) -> int:
        return self.kind.shape[0]


SyncResult = engine.ApplyResult


def make_sync_batch(kind, slot, desired=None, *, k: int,
                    device="cuda") -> SyncOpBatch:
    dev = resolve_device(device)
    kind = engine._as_i32(kind, dev)
    slot = engine._as_i32(slot, dev)
    p = kind.shape[0]
    desired = (torch.zeros((p, k), dtype=WORD_DTYPE, device=dev)
               if desired is None else as_words(desired, dev))
    return SyncOpBatch(kind, slot, desired)


def to_unified(ops: SyncOpBatch, *, k: int) -> engine.OpBatch:
    """Translate a legacy sync batch into the unified op schema (kinds
    outside 0-3 clip into it, as the reference's do)."""
    dev = ops.kind.device
    table = torch.tensor(_TO_UNIFIED, dtype=torch.int32, device=dev)
    kind = table[ops.kind.clamp(0, 3).long()]
    return engine.make_ops(kind, ops.slot, desired=ops.desired, k=k,
                           device=dev)


# ---------------------------------------------------------------------------
# Sequential oracle (numpy) — THE definition of correctness.
# ---------------------------------------------------------------------------

def apply_sync_reference(data: np.ndarray, version: np.ndarray, ctx, ops):
    """Apply sync ops one at a time in lane order.  Pure numpy, for tests:
    words as uint32, `ctx` and `ops` NamedTuples or tuples of arrays in
    their field order.

    Returns (new_data, new_version, new_ctx, SyncResult-as-numpy)."""
    data = np.array(data, copy=True)
    version = np.array(version, copy=True)
    c_slot, c_ver, c_val, c_lnk = (np.array(x, copy=True) for x in ctx)
    kind, slot, desired = (np.asarray(x) for x in ops)
    p, k = desired.shape
    value = np.zeros((p, k), data.dtype)
    success = np.zeros((p,), bool)
    for i in range(p):
        s = slot[i]
        if kind[i] == IDLE:
            continue
        cur = data[s].copy()
        value[i] = cur
        if kind[i] == LL:
            c_slot[i], c_ver[i], c_val[i], c_lnk[i] = \
                s, version[s], cur, True
            success[i] = True
        elif kind[i] == VL:
            success[i] = bool(c_lnk[i] and c_slot[i] == s
                              and c_ver[i] == version[s])
        elif kind[i] == SC:
            ok = bool(c_lnk[i] and c_slot[i] == s
                      and c_ver[i] == version[s])
            if ok:
                data[s] = desired[i]
                version[s] += 2
            c_lnk[i] = False            # any SC attempt consumes the link
            success[i] = ok
    new_ctx = LinkCtx(c_slot, c_ver, c_val, c_lnk)
    return data, version, new_ctx, SyncResult(value, success)


# ---------------------------------------------------------------------------
# Shims over the unified engine.
# ---------------------------------------------------------------------------

def _apply_unified(state, ctx, ops: SyncOpBatch, *, strategy: str, k: int):
    """Translate the legacy batch and run the unified engine; everything in
    `repro_torch.sync` routes through here, never through the warning
    `apply_sync`."""
    spec = ba._spec(state, strategy, k)
    return engine.apply(spec, state, to_unified(ops, k=k), ctx)


def apply_sync(state, ctx: LinkCtx, ops: SyncOpBatch, *, strategy: str,
               k: int):
    """DEPRECATED shim: use `repro_torch.atomics.apply(spec, state, ops,
    ctx)` with unified kinds.  Returns (state', ctx', SyncResult, stats,
    Traffic).  Warns `DeprecationWarning` once per process."""
    warn_once("sync.llsc.apply_sync",
              "repro_torch.atomics.apply(spec, state, ops, ctx)")
    return _apply_unified(state, ctx, ops, strategy=strategy, k=k)


def _batch(kind: int, state, slots, desired, k: int) -> SyncOpBatch:
    dev = state.version.device
    slots = engine._as_i32(slots, dev)
    return make_sync_batch(torch.full_like(slots, kind), slots, desired, k=k,
                           device=dev)


def ll(state, ctx, slots, *, strategy: str, k: int):
    """Link every lane i to slots[i].  Returns (ctx', values)."""
    _, ctx, res, _, _ = _apply_unified(
        state, ctx, _batch(LL, state, slots, None, k), strategy=strategy,
        k=k)
    return ctx, res.value


def sc(state, ctx, slots, desired, *, strategy: str, k: int):
    """Conditionally commit desired[i] to slots[i].  Returns
    (state', ctx', success)."""
    state, ctx, res, _, _ = _apply_unified(
        state, ctx, _batch(SC, state, slots, desired, k), strategy=strategy,
        k=k)
    return state, ctx, res.success


def validate(state, ctx, slots, *, strategy: str, k: int):
    """Is each lane's link still valid?  Returns bool[p]."""
    _, _, res, _, _ = _apply_unified(
        state, ctx, _batch(VL, state, slots, None, k), strategy=strategy,
        k=k)
    return res.success
