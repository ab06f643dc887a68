"""Fused validate + conditional commit for one SC round.

An SC batch linearizes in ONE round (at most one SC per cell can succeed
per batch), so once same-cell losers are filtered the commit is one
embarrassingly parallel pass: for each live lane, validate the link
(`meta[slot, 0] == link_ver`) and, iff it holds, write the k-word payload
and bump the version.  `llsc_commit_round` replaces the reference's Pallas
kernel with the CUDA kernel `llsc_commit_round_kernel`
(`csrc/table_ops.cu`): one thread per lane, writing only where it
succeeded.

`commit_round` is the spec-routed entry point: table state in, table state
out, through the engine's fused round (`engine_round.make_round`), which
subsumes this kernel since a pure-SC batch over distinct cells is exactly a
collision-free batch.
"""

from __future__ import annotations

import torch

from repro_torch.core.layout import WORD_DTYPE, TableState, as_words
from repro_torch.core.registry import get_strategy
from repro_torch.core.specs import AtomicSpec
from repro_torch.kernels import _build
from repro_torch.kernels.ref import llsc_commit_round_ref


def llsc_commit_round(data, meta, slot, live, link_ver, desired):
    """One fused SC commit round.  data: word[n+1, k] (row n = dummy);
    meta: word[n+1, 2] (word 0 = version); slot: int32[p] (dead lanes ->
    n); live: int32 or bool [p]; link_ver: word[p]; desired: word[p, k].
    Live slots must be distinct and < n.

    Updates `data` and `meta` in place (success = live & meta[slot, 0] ==
    link_ver: the row := desired and version += 2) and returns (data, meta,
    success int32[p, 1], witness word[p, k] = each lane's pre-round row).
    A slot outside [0, n+1) is a dead lane with a zero witness.

    CPU tensors run `ref.llsc_commit_round_ref`; CUDA tensors launch the
    kernel or raise."""
    n1, k = data.shape
    p = slot.shape[0]
    live = live.reshape(p).to(torch.int32)
    link_ver = link_ver.reshape(p)
    dev = data.device
    _build.check(dev, ("data", data, WORD_DTYPE, (n1, k)),
                 ("meta", meta, WORD_DTYPE, (n1, 2)),
                 ("slot", slot, torch.int32, (p,)),
                 ("live", live, torch.int32, (p,)),
                 ("link_ver", link_ver, WORD_DTYPE, (p,)),
                 ("desired", desired, WORD_DTYPE, (p, k)))
    if _build.runs_plain(dev, "llsc_commit_round"):
        return llsc_commit_round_ref(data, meta, slot, live, link_ver,
                                     desired)
    succ = torch.empty((p, 1), dtype=torch.int32, device=dev)
    wit = torch.empty((p, k), dtype=WORD_DTYPE, device=dev)
    if p:
        _build.launch("table_ops", "llsc_commit_round", dev, data.data_ptr(),
                      meta.data_ptr(), n1, k, slot.data_ptr(),
                      live.data_ptr(), link_ver.data_ptr(),
                      desired.data_ptr(), p, succ.data_ptr(), wit.data_ptr())
        llsc_commit_round.launches += 1
    return data, meta, succ, wit


llsc_commit_round.launches = 0


# ---------------------------------------------------------------------------
# Spec-routed entry point: table in, table out.
# ---------------------------------------------------------------------------

def commit_round(spec: AtomicSpec, state: TableState, ctx, slots, desired,
                 *, donate: bool = False):
    """Run one SC commit round against a `TableState`, routed by spec.

    Every lane with slot < spec.n is an SC with `desired`; lanes with
    slot == spec.n are idle.  The round is the engine round of the
    configured engine-kernel mode (`engine_round.make_round`), so a
    collision-free batch runs the fast-round kernel.  Caller contract
    (the one-SC-per-cell fast path): live lanes target DISTINCT cells.

    Like `atomics.apply`, it copies the state first unless `donate=True`,
    in which case it updates the passed state's buffers.

    Returns (state', ctx', success bool[p], witness word[p, k])."""
    from repro_torch.core import engine
    from repro_torch.kernels import engine_round

    n, k = spec.n, spec.k
    device = state.data.device
    slots = engine._as_i32(slots, device)
    p = slots.shape[0]
    kind = torch.where(slots < n, engine.SC, engine.IDLE).to(torch.int32)
    ops = engine.OpBatch(kind, slots,
                         torch.zeros((p, k), dtype=WORD_DTYPE, device=device),
                         as_words(desired, device))
    new_state, new_ctx, result, _ = engine.run_round(
        get_strategy(spec.strategy), engine_round.make_round(n, k), state,
        engine.canonicalize_ctx(ctx, device), ops, donate=donate)
    return new_state, new_ctx, result.success, result.value
