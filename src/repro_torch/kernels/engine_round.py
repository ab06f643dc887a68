"""The fused engine round: a collision-free fast path and a sorted slow path,
chosen on the device.

  prologue    `round_prologue`: every batch sorted by (slot, lane) once
              (stable; inactive lanes at n; the kernel's radix sort gives
              `torch.sort(stable=True)`'s order, `sort_slots`); the
              predicate (`fast_flag`), from the sorted slots: every active
              slot lies in [0, n), AND the batch is read-only (no
              STORE/CAS/SC) OR no two active lanes share a slot; and the
              lanes' operands in the sorted order for the slow path.  The
              predicate stays on the device as a bool tensor; nothing
              reads it back.  It is conservative: a colliding batch with a
              write can NEVER take the fast path.
  fast path   `fast_round`: every lane is independent; one pass gathers each
              lane's row, evaluates LOAD/STORE/CAS/LL/SC/VALIDATE in
              registers, writes the row back where it wrote, and writes the
              lane's value, success, new link and write flag.
  slow path   `slow_round`: the sorted lanes replayed in order per cell
              segment, each dirty row written back once.
  epilogue    `round_epilogue`: on the slow branch, the replay's outputs back
              in lane order and the new links; on both branches, the
              `ApplyStats` (one int32[6], `engine.stats_on_sorted`'s
              definition) and the cells written in ascending slot order
              (`engine.dirty_slots`), which the layout's `commit` reads.

The four kernels are launched on every batch, and the three after the
prologue each return at once when the flag says their branch is not
taken: the reference's `lax.cond` on the device.  A round is so a fixed
sequence of launches with no host sync, which a CUDA graph can capture.

Each kernel (`csrc/engine_round.cu`) has a plain PyTorch version beside it
(`round_prologue_plain`, `fast_round_plain`, `engine.slow_round_plain`,
`round_epilogue_plain`) that honours the flag as its kernel does: it leaves
the table and its outputs alone when its branch is not taken.  A wrapper
given CPU tensors runs the plain version; given CUDA tensors it launches
the kernel or raises.  Each wrapper counts its kernel launches in
`.launches`.

The round returned by `make_round` has the `engine.linearize` signature and
return values and is bit-identical to it on every in-contract batch (slots
of active lanes in [0, n)).  It updates the `data` and `version` it is
given in place, as the reference's kernels alias the table through.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from repro_torch.core import engine
from repro_torch.core.engine import (
    CAS, IDLE, LL, LOAD, SC, STORE, VALIDATE, ApplyResult, ApplyStats,
    LinkCtx, OpBatch, poisoned_link_ver,
)
from repro_torch.core.layout import WORD_DTYPE, gather_rows, scatter_set

_MODES = ("auto", "pallas", "xla", "off")
_WRITE_KINDS = (1 << STORE) | (1 << CAS) | (1 << SC)   # a bit per kind


def configured_mode() -> str:
    """The engine-kernel mode requested by the environment.

    BIGATOMIC_ENGINE_KERNEL = auto (default) | pallas | xla | off:
      auto    the kernel tier;
      pallas  the kernel tier: hand-written CUDA kernels on CUDA tensors
              (their plain versions on CPU tensors);
      xla     the plain-tensor tier: the same round with the plain versions
              on every device;
      off     pure `engine.linearize` everywhere.
    The names are the reference's, so one CI matrix drives both packages.
    """
    mode = os.environ.get("BIGATOMIC_ENGINE_KERNEL", "auto")
    if mode not in _MODES:
        raise ValueError(f"BIGATOMIC_ENGINE_KERNEL={mode!r}; "
                         f"expected one of {_MODES}")
    return mode


def resolved_mode(mode: str | None = None) -> str:
    """Resolve `auto`: the kernel tier ('pallas') on every device."""
    mode = mode or configured_mode()
    if mode not in _MODES:
        raise ValueError(f"engine-kernel mode {mode!r}; expected one of "
                         f"{_MODES}")
    return "pallas" if mode == "auto" else mode


# ---------------------------------------------------------------------------
# The sort and the fast-path predicate.
# ---------------------------------------------------------------------------

def sort_key(n: int, ops: OpBatch) -> torch.Tensor:
    """The batch's slots with inactive lanes at n: what the round sorts."""
    return ops.slot.masked_fill(ops.kind == IDLE, n)


def sort_slots(n: int, ops: OpBatch):
    """(s_slot, order): `sort_key` sorted stably, and the permutation
    (int32) that sorts it; the plain version of the prologue's sort."""
    s_slot, order = torch.sort(sort_key(n, ops), stable=True)
    return s_slot, order.to(torch.int32)


def fast_flag(n: int, ops: OpBatch, s_slot) -> torch.Tensor:
    """The fast-path predicate as a 0-d bool tensor, from the sorted slots
    (`sort_slots`): (a) every active slot is in [0, n), AND (b) the batch
    is read-only OR no two adjacent sorted slots below n are equal.  (b)'s
    pairs need not exclude lanes outside [0, n): where one is active, (a)
    fails anyway.  False positives are impossible: a colliding batch with
    any write fails (b)."""
    kind, slot = ops.kind, ops.slot
    out_of_range = ((kind != IDLE) & ((slot < 0) | (slot >= n))).any()
    # kinds outside 0-31 (the caller's contract) count as no write
    writes = (torch.bitwise_right_shift(_WRITE_KINDS, kind.clamp(0, 31))
              & 1).any()
    dup = ((s_slot[1:] == s_slot[:-1]) & (s_slot[1:] < n)).any()
    return ~(out_of_range | (writes & dup))


def fast_path_ok(n: int, ops: OpBatch) -> torch.Tensor:
    """The round's predicate for `ops` (a 0-d bool tensor): `fast_flag` of
    its sorted slots."""
    return fast_flag(n, ops, sort_slots(n, ops)[0])


def path_counts(n: int, ops: OpBatch, *, fused: bool):
    """(eligible, taken): the fast-path predicate, and the branch the
    round resolves the batch to (never fast when the round is `linearize`)."""
    eligible = fast_path_ok(n, ops)
    taken = eligible if fused else torch.zeros_like(eligible)
    return eligible, taken


# ---------------------------------------------------------------------------
# The round's outputs, written by the branch that runs.
# ---------------------------------------------------------------------------

class RoundOut(NamedTuple):
    """The outputs of one round, in lane order.  `fast_round` writes value,
    success, ctx and okw on the fast branch, `round_epilogue` the first
    three on the slow branch and stats and dirty on both.

    value:   word[p, k]  the value each lane witnessed (0 on IDLE lanes)
    success: bool[p]
    ctx:     LinkCtx     the new links (batch width)
    okw:     int32[p]    the lane wrote its cell (fast branch only)
    stats:   int32[6]    the `ApplyStats` fields, in order
    dirty:   int32[p]    the cells written, ascending, padded with n
    """

    value: torch.Tensor
    success: torch.Tensor
    ctx: LinkCtx
    okw: torch.Tensor
    stats: torch.Tensor
    dirty: torch.Tensor

    @classmethod
    def empty(cls, p: int, k: int, device) -> "RoundOut":
        def e(shape, dtype=torch.int32):
            return torch.empty(shape, dtype=dtype, device=device)
        return cls(e((p, k)), e((p,), torch.bool),
                   LinkCtx(e((p,)), e((p,)), e((p, k)), e((p,), torch.bool)),
                   e((p,)), e((6,)), e((p,)))


def _put(fast, dst, src) -> None:
    """`dst` becomes `src` where the 0-d flag `fast` holds."""
    dst.copy_(torch.where(fast, src, dst))


class Prologue(NamedTuple):
    """`round_prologue`'s outputs: the predicate (bool[]), the sorted order
    (`order`: int32[p], the permutation; `s_slot`: the sorted keys), the
    slow path's lane operands in it, and the round's scratch, which
    `round_epilogue` reads as the prologue left it (size 0 from the plain
    version)."""

    fast: torch.Tensor
    order: torch.Tensor
    s_slot: torch.Tensor
    s_kind: torch.Tensor
    s_link_ver: torch.Tensor
    s_expected: torch.Tensor
    s_desired: torch.Tensor
    scratch: torch.Tensor


# ---------------------------------------------------------------------------
# Plain versions of the four kernels.
# ---------------------------------------------------------------------------

def round_prologue_plain(n: int, ops: OpBatch, ctx: LinkCtx) -> Prologue:
    """Plain PyTorch prologue: the sort (`sort_slots`), `fast_flag`, and
    each lane's kind, link version (odd-poisoned unless its link names its
    cell) and rows in the sorted order.  `ctx` is batch width."""
    s_slot, order = sort_slots(n, ops)
    return Prologue(fast_flag(n, ops, s_slot), order, s_slot,
                    ops.kind[order], poisoned_link_ver(ctx, ops.slot)[order],
                    gather_rows(ops.expected, order),
                    gather_rows(ops.desired, order),
                    torch.empty((0,), dtype=torch.int32,
                                device=s_slot.device))


def fast_round_plain(fast, data, version, ctx: LinkCtx, ops: OpBatch,
                     out: RoundOut) -> RoundOut:
    """Plain PyTorch fast round: one gather, register math, one masked
    scatter, then the per-lane results and links.  Where the 0-d bool
    `fast` is False it writes nothing.  Lanes with a slot outside [0, n)
    are dead: they read zeros and write nothing.  Precondition (fast):
    live writing lanes target distinct slots.  Updates the table in place
    and writes value, success, ctx and okw of `out`."""
    n = data.shape[0]
    kind, slot = ops.kind, ops.slot
    active = kind != IDLE
    live = active & (slot >= 0) & (slot < n)
    safe = slot.clamp(0, n - 1).long()
    cur = torch.where(live[:, None], data[safe], 0)
    ver = torch.where(live, version[safe], 0)
    link_ver = poisoned_link_ver(ctx, slot)     # poisoned-odd never matches
    match = (cur == ops.expected).all(1)
    okw = live & ((kind == STORE) | ((kind == CAS) & match)
                  | ((kind == SC) & (link_ver == ver)))
    success = torch.where(
        (kind == LOAD) | (kind == LL) | (kind == STORE), active,
        torch.where(kind == VALIDATE, link_ver == ver,
                    ((kind == CAS) | (kind == SC)) & okw))
    is_ll = kind == LL
    new_ctx = (torch.where(is_ll, slot, ctx.slot),
               torch.where(is_ll, ver, ctx.version),
               torch.where(is_ll[:, None], cur, ctx.value),
               torch.where(is_ll, True,
                           torch.where(kind == SC, False, ctx.linked)))
    wrote = okw & fast
    scatter_set(data, safe, ops.desired, wrote)
    version.index_add_(0, safe, 2 * wrote.to(version.dtype))
    for dst, src in zip((out.value, out.success, *out.ctx, out.okw),
                        (cur, success, *new_ctx, okw.to(torch.int32))):
        _put(fast, dst, src)
    return out


def slow_round_plain(data, version, s_slot, s_kind, s_link_ver, s_expected,
                     s_desired, *, fast=None):
    """`engine.slow_round_plain`, the sorted replay, with success as int32
    as the kernel gives it.  Where the 0-d bool `fast` is True it leaves
    the table alone and its outputs are zeros."""
    d, v, val, ver, succ = engine.slow_round_plain(
        data, version, s_slot, s_kind, s_link_ver, s_expected, s_desired,
        fast=fast)
    return d, v, val, ver, succ.to(torch.int32)


def round_epilogue_plain(fast, n: int, ctx: LinkCtx, order, s_slot, s_kind,
                         val_s, verpt_s, succ_s, version, out: RoundOut,
                         scratch=None) -> RoundOut:
    """Plain PyTorch epilogue over the sorted order.  On the slow branch
    (`fast` False) `engine.rebuild` puts the sorted replay's outputs
    (val_s, verpt_s, succ_s) back in lane order with the new links; on
    both, the stats and the dirty-slot list, with each lane's success taken
    from the branch that ran (the fast round's okw: on the STORE/CAS/SC
    lanes, the only ones these read, it is the success).  `ctx` is batch
    width.  `version`, the table's versions after the round, is what the
    kernel tests a cell's dirtiness on; this version reads the successes,
    which say the same.  Writes into `out`; `scratch` (the kernel's) is
    not read."""
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], dtype=order.dtype,
                              device=order.device)
    succ = torch.where(fast, out.okw[order] != 0, succ_s != 0)
    lanes = engine.SortedLanes(order, inv, s_slot, s_kind, None, None, None)
    new_ctx, result, stats, dirty = engine.rebuild(n, ctx, lanes, val_s,
                                                   verpt_s, succ)
    for dst, src in zip((out.value, out.success, *out.ctx),
                        (*result, *new_ctx)):
        _put(~fast, dst, src)
    out.stats.copy_(torch.stack(list(stats)))
    out.dirty.copy_(dirty)
    return out


# ---------------------------------------------------------------------------
# The kernel wrappers: the kernel on CUDA tensors, the plain version on CPU.
# ---------------------------------------------------------------------------

def _on_card(device: torch.device, who: str) -> bool:
    from repro_torch.kernels import _build
    return not _build.runs_plain(device, who)


def _check_round(data, version, kind, slot, link_ver, expected, desired,
                 fast):
    """Validate a round's table and lane operands (lane arrays of width
    p; `link_ver` may be None) against the table's device."""
    from repro_torch.kernels import _build

    n, k = data.shape
    p = slot.shape[0]
    ops = [("data", data, WORD_DTYPE, (n, k)),
           ("version", version, WORD_DTYPE, (n,)),
           ("slot", slot, torch.int32, (p,)),
           ("kind", kind, torch.int32, (p,)),
           ("expected", expected, WORD_DTYPE, (p, k)),
           ("desired", desired, WORD_DTYPE, (p, k))]
    if link_ver is not None:
        ops.append(("link_ver", link_ver, WORD_DTYPE, (p,)))
    if fast is not None:
        ops.append(("fast", fast, torch.bool, ()))
    _build.check(data.device, *ops)


def _check_lanes(device, p: int, k: int, ctx: LinkCtx,
                 out: RoundOut) -> None:
    """Validate the links in and the round's lane outputs."""
    from repro_torch.kernels import _build
    _build.check(device, *((f"{what}.{f}", x, dtype, shape)
                           for what, c in (("ctx", ctx), ("out.ctx", out.ctx))
                           for f, x, dtype, shape in zip(
                               LinkCtx._fields, c,
                               (torch.int32, WORD_DTYPE, WORD_DTYPE,
                                torch.bool), ((p,), (p,), (p, k), (p,)))),
                 ("value", out.value, WORD_DTYPE, (p, k)),
                 ("success", out.success, torch.bool, (p,)),
                 ("okw", out.okw, torch.int32, (p,)))


def round_scratch(p: int, device) -> torch.Tensor:
    """A fresh scratch for the kernels of a round of p lanes on a card
    (int32, all zeros): what `round_epilogue` needs when no `round_prologue`
    of the same round prepared it."""
    from repro_torch.kernels import _build
    return torch.zeros((_build.load("engine_round").round_scratch(p),),
                       dtype=torch.int32, device=device)


def round_prologue(n: int, ops: OpBatch, ctx: LinkCtx) -> Prologue:
    """The round's pre-step; replaces the reference's stable argsort of
    the slots, `fast_path_ok` (its n-sized count array) and the gathers
    into the sorted order around `slow_round_pallas`.

    ops: the batch (raw slots); ctx: the batch-width links.  Returns a
    `Prologue`: the sorted order as `sort_slots` gives it, the predicate,
    the sorted operands and the round's scratch.

    CPU tensors run `round_prologue_plain`; CUDA tensors launch the CUDA
    kernel `round_prologue_kernel` (`csrc/engine_round.cu`: the radix
    sort, the gathers and the predicate in one cooperative launch) or
    raise."""
    dev = ops.slot.device
    if not _on_card(dev, "round_prologue"):
        return round_prologue_plain(n, ops, ctx)
    from repro_torch.kernels import _build

    p, k = ops.p, ops.k
    _build.check(dev, ("kind", ops.kind, torch.int32, (p,)),
                 ("slot", ops.slot, torch.int32, (p,)),
                 ("expected", ops.expected, WORD_DTYPE, (p, k)),
                 ("desired", ops.desired, WORD_DTYPE, (p, k)),
                 ("ctx.slot", ctx.slot, torch.int32, (p,)),
                 ("ctx.version", ctx.version, WORD_DTYPE, (p,)),
                 ("ctx.linked", ctx.linked, torch.bool, (p,)))

    def e(shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = Prologue(e((), torch.bool), e((p,)), e((p,)), e((p,)),
                   e((p,), WORD_DTYPE), e((p, k), WORD_DTYPE),
                   e((p, k), WORD_DTYPE),
                   e((_build.load("engine_round").round_scratch(p),)))
    _build.launch("engine_round", "round_prologue", dev, n, k, p,
                  ops.slot.data_ptr(), ops.kind.data_ptr(),
                  ops.expected.data_ptr(), ops.desired.data_ptr(),
                  ctx.slot.data_ptr(), ctx.version.data_ptr(),
                  ctx.linked.data_ptr(),
                  *(x.data_ptr() for x in out[1:7]), out.fast.data_ptr(),
                  out.scratch.data_ptr())
    round_prologue.launches += 1
    return out


def fast_round(fast, data, version, ctx: LinkCtx, ops: OpBatch,
               out: RoundOut) -> RoundOut:
    """One fast-path pass; replaces the reference's `fast_round_pallas`
    and its host-side assembly (`_assemble_fast`).

    fast: bool[] the predicate (the kernel returns at once when False);
    data: word[n, k]; version: word[n]; ctx: the batch-width links; ops:
    the batch (raw slots; lanes outside [0, n) are dead).  Precondition:
    live writing lanes target distinct slots (or the batch is read-only).
    Updates the table in place; writes value, success, ctx and okw of
    `out` (see `RoundOut`).

    CPU tensors run `fast_round_plain`; CUDA tensors launch the CUDA kernel
    `fast_round_kernel` or raise."""
    if not _on_card(data.device, "fast_round"):
        return fast_round_plain(fast, data, version, ctx, ops, out)
    from repro_torch.kernels import _build

    n, k = data.shape
    p = ops.p
    _check_round(data, version, ops.kind, ops.slot, None, ops.expected,
                 ops.desired, fast)
    _check_lanes(data.device, p, k, ctx, out)
    if p == 0:
        return out
    _build.launch("engine_round", "fast_round", data.device, fast.data_ptr(),
                  data.data_ptr(), version.data_ptr(), n, k,
                  ops.slot.data_ptr(), ops.kind.data_ptr(),
                  ops.expected.data_ptr(), ops.desired.data_ptr(),
                  ctx.slot.data_ptr(), ctx.version.data_ptr(),
                  ctx.value.data_ptr(), ctx.linked.data_ptr(), p,
                  out.value.data_ptr(), out.success.data_ptr(),
                  out.ctx.slot.data_ptr(), out.ctx.version.data_ptr(),
                  out.ctx.value.data_ptr(), out.ctx.linked.data_ptr(),
                  out.okw.data_ptr())
    fast_round.launches += 1
    return out


def slow_round(data, version, s_slot, s_kind, s_link_ver, s_expected,
               s_desired, *, fast=None):
    """One sequential-replay pass over lanes SORTED by (slot, lane);
    replaces the reference's `slow_round_pallas`.

    Every cell segment loads its row once, applies its ops in order with
    full LOAD/STORE/CAS/LL/SC/VALIDATE semantics and writes the row back
    once.  Lanes whose slot lies outside [0, n) are failed no-ops with zero
    outputs.  Updates the table in place; returns (data, version,
    val_pt[p, k], ver_pt[p], success int32[p]) in the sorted order.  With
    `fast` (bool[]), the kernel returns at once where it is True: the
    table is left alone and the outputs are undefined (the plain version's
    are zeros).

    CPU tensors run `slow_round_plain`; CUDA tensors launch the segment
    replay of `csrc/segment_replay.cuh` or raise."""
    if not _on_card(data.device, "slow_round"):
        return slow_round_plain(data, version, s_slot, s_kind, s_link_ver,
                                s_expected, s_desired, fast=fast)
    from repro_torch.kernels import _build

    n, k = data.shape
    p = s_slot.shape[0]
    _check_round(data, version, s_kind, s_slot, s_link_ver, s_expected,
                 s_desired, fast)
    dev = data.device
    val = torch.empty((p, k), dtype=WORD_DTYPE, device=dev)
    ver = torch.empty((p,), dtype=WORD_DTYPE, device=dev)
    ok = torch.empty((p,), dtype=torch.int32, device=dev)
    if p == 0:
        return data, version, val, ver, ok
    _build.launch("engine_round", "slow_round", dev,
                  None if fast is None else fast.data_ptr(),
                  data.data_ptr(), version.data_ptr(), n, k,
                  s_slot.data_ptr(), s_kind.data_ptr(),
                  s_link_ver.data_ptr(), s_expected.data_ptr(),
                  s_desired.data_ptr(), p, val.data_ptr(), ver.data_ptr(),
                  ok.data_ptr())
    slow_round.launches += 1
    return data, version, val, ver, ok


def round_epilogue(fast, n: int, ctx: LinkCtx, order, s_slot, s_kind,
                   val_s, verpt_s, succ_s, version, out: RoundOut,
                   scratch) -> RoundOut:
    """The round's post-step over the sorted order; replaces the host code
    around `slow_round_pallas` (`engine.rebuild`, `stats_on_sorted`) and
    the layouts' whole-table diff of the versions.

    fast: bool[]; ctx: the batch-width links; order: int32[p], the sorting
    permutation; s_slot / s_kind: int32[p] sorted (inactive lanes at n);
    val_s / verpt_s / succ_s: `slow_round`'s outputs; version: the table's
    versions after the round; scratch: the round's, as its
    `round_prologue` left it (`Prologue.scratch`), or `round_scratch(p)`.
    On the slow branch it writes value, success and ctx of `out` in lane
    order; on both, the stats and the dirty-slot list (see
    `round_epilogue_plain`).

    CPU tensors run `round_epilogue_plain`; CUDA tensors launch the CUDA
    kernel `round_epilogue_kernel` or raise."""
    dev = s_slot.device
    if not _on_card(dev, "round_epilogue"):
        return round_epilogue_plain(fast, n, ctx, order, s_slot, s_kind,
                                    val_s, verpt_s, succ_s, version, out)
    from repro_torch.kernels import _build

    p, k = val_s.shape
    _build.check(dev, ("fast", fast, torch.bool, ()),
                 ("order", order, torch.int32, (p,)),
                 ("s_slot", s_slot, torch.int32, (p,)),
                 ("s_kind", s_kind, torch.int32, (p,)),
                 ("val_s", val_s, WORD_DTYPE, (p, k)),
                 ("verpt_s", verpt_s, WORD_DTYPE, (p,)),
                 ("succ_s", succ_s, torch.int32, (p,)),
                 ("version", version, WORD_DTYPE, (n,)),
                 ("stats", out.stats, torch.int32, (6,)),
                 ("dirty", out.dirty, torch.int32, (p,)),
                 ("scratch", scratch, torch.int32,
                  (_build.load("engine_round").round_scratch(p),)))
    _check_lanes(dev, p, k, ctx, out)
    _build.launch("engine_round", "round_epilogue", dev, fast.data_ptr(), n,
                  k, p, order.data_ptr(), s_slot.data_ptr(),
                  s_kind.data_ptr(), val_s.data_ptr(), verpt_s.data_ptr(),
                  succ_s.data_ptr(), version.data_ptr(), ctx.slot.data_ptr(),
                  ctx.version.data_ptr(), ctx.value.data_ptr(),
                  ctx.linked.data_ptr(), out.value.data_ptr(),
                  out.success.data_ptr(), out.ctx.slot.data_ptr(),
                  out.ctx.version.data_ptr(), out.ctx.value.data_ptr(),
                  out.ctx.linked.data_ptr(), out.okw.data_ptr(),
                  out.stats.data_ptr(), out.dirty.data_ptr(),
                  scratch.data_ptr())
    round_epilogue.launches += 1
    return out


round_prologue.launches = 0
fast_round.launches = 0
slow_round.launches = 0
round_epilogue.launches = 0


# ---------------------------------------------------------------------------
# The round factory: what StrategyImpl.lower_round hands the engine.
# ---------------------------------------------------------------------------

def make_round(n: int, k: int, *, mode: str | None = None):
    """Build a fused round callable with the `engine.linearize` signature
    and return values: (data, version, ctx, ops) -> (data', version',
    ctx', ApplyResult, ApplyStats, dirty slots), updating `data` and
    `version` in place.

    mode  'pallas' the kernel tier: `round_prologue`, `fast_round`,
                   `slow_round`, `round_epilogue`;
          'xla'    the same round with their plain versions;
          'off'    `linearize` itself; None resolves `configured_mode()`.
    """
    r_mode = resolved_mode(mode)
    if r_mode == "off":
        return engine.linearize
    prologue_fn, fast_fn, slow_fn, epilogue_fn = (
        (round_prologue, fast_round, slow_round, round_epilogue)
        if r_mode == "pallas" else
        (round_prologue_plain, fast_round_plain, slow_round_plain,
         round_epilogue_plain))

    def round_fn(data, version, ctx: LinkCtx, ops: OpBatch):
        # linearize gathers ctx lanes by sorted lane index, which for a ctx
        # wider than the batch means "the first p lanes"; replicate that so
        # both tiers see (and return) batch-width ctx exactly as it does.
        p = ops.p
        if ctx.slot.shape[0] != p:
            ctx = LinkCtx(*(x[:p] for x in ctx))
        pro = prologue_fn(n, ops, ctx)
        out = RoundOut.empty(p, k, data.device)
        fast_fn(pro.fast, data, version, ctx, ops, out)
        _, _, val_s, verpt_s, succ_s = slow_fn(
            data, version, *pro[2:7], fast=pro.fast)
        epilogue_fn(pro.fast, n, ctx, pro.order, pro.s_slot, pro.s_kind,
                    val_s, verpt_s, succ_s, version, out, pro.scratch)
        return (data, version, out.ctx, ApplyResult(out.value, out.success),
                ApplyStats(*out.stats), out.dirty)

    return round_fn
