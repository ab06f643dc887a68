"""The fused engine round: a collision-free fast path and a sorted slow path.

  fast path   When a batch has no intra-batch slot collisions (or is
              read-only, where collisions cannot matter), every lane is
              independent: one pass gathers each lane's cell row, evaluates
              LOAD/STORE/CAS/LL/SC/VALIDATE in registers and writes the row
              back where it wrote — no sort, no scans, no rounds.

  slow path   Contended batches sort by (slot, lane) once; one pass then
              replays the sorted lanes sequentially per cell segment and
              writes each dirty row back once.

  dispatch    `fast_path_ok` is one cheap duplicate-count check.  The
              reference picks the branch on the device (`lax.cond`); this
              port reads the predicate back to the host (one sync per round)
              and launches one branch.  The predicate is conservative: a
              colliding batch with a write can NEVER take the fast path.

Each path has a hand-written CUDA kernel for Hopper
(`csrc/engine_round.cu`, wrappers `fast_round` / `slow_round`) and a plain
PyTorch version of the same function beside it (`fast_round_plain` /
`engine.slow_round_plain`).  A wrapper given CPU tensors runs the plain
version; given CUDA tensors it launches the kernel or raises.  Each wrapper
counts its kernel launches in `.launches`.

The round returned by `make_round` has the `engine.linearize` signature and
is bit-identical to it on every in-contract batch (slots of active lanes in
[0, n)).  It updates the `data` and `version` it is given in place, as the
reference's kernels alias the table through.
"""

from __future__ import annotations

import os

import torch

from repro_torch.core import engine
from repro_torch.core.engine import (
    ApplyResult, ApplyStats, CAS, IDLE, LL, LOAD, LinkCtx, OpBatch, SC,
    STORE, VALIDATE, poisoned_link_ver,
)
from repro_torch.core.layout import WORD_DTYPE, scatter_set

_MODES = ("auto", "pallas", "xla", "off")


def configured_mode() -> str:
    """The engine-kernel mode requested by the environment.

    BIGATOMIC_ENGINE_KERNEL = auto (default) | pallas | xla | off:
      auto    the kernel tier;
      pallas  the kernel tier: hand-written CUDA kernels on CUDA tensors
              (their plain versions on CPU tensors);
      xla     the plain-tensor tier: fast path in plain PyTorch, `linearize`
              for contended batches;
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
# The fast-path predicate: one duplicate-count check.
# ---------------------------------------------------------------------------

def fast_path_ok(n: int, ops: OpBatch) -> torch.Tensor:
    """True (a bool tensor) iff every lane of the batch is provably
    independent: (a) every active slot is in [0, n), AND (b) the batch is
    read-only (no STORE/CAS/SC) OR no two active lanes share a slot (one
    scatter-add of lane counts, then a max; `torch.bincount` would read its
    input's max back to the host on a card).  False positives are
    impossible: a colliding batch with any write fails (b)."""
    kind, slot = ops.kind, ops.slot
    active = kind != IDLE
    in_range = (slot >= 0) & (slot < n)
    all_in = ~(active & ~in_range).any()
    is_write = active & ((kind == STORE) | (kind == CAS) | (kind == SC))
    read_only = ~is_write.any()
    cslot = torch.where(active & in_range, slot, n).to(torch.int64)
    counts = torch.zeros(n + 1, dtype=torch.int32, device=slot.device)
    counts.index_add_(0, cslot, torch.ones_like(slot))
    no_dup = counts[:n].max() <= 1
    return all_in & (read_only | no_dup)


def path_counts(n: int, ops: OpBatch, *, fused: bool):
    """(eligible, taken): the fast-path predicate, and the branch the
    round resolves the batch to (never fast when the round is `linearize`)."""
    eligible = fast_path_ok(n, ops)
    taken = eligible if fused else torch.zeros_like(eligible)
    return eligible, taken


# ---------------------------------------------------------------------------
# The two rounds: wrappers (kernel on CUDA, plain on CPU) + plain versions.
# ---------------------------------------------------------------------------

def fast_round_plain(data, version, slot, kind, link_ver, expected, desired):
    """Plain PyTorch fast round: one gather, register math, one masked
    scatter.  Lanes with a slot outside [0, n) are dead and return zeros.
    Precondition: live writing lanes target distinct slots.  Updates the
    table in place; returns (data, version, witness[p, k], ver_pt[p],
    okw int32[p])."""
    n = data.shape[0]
    live = (slot >= 0) & (slot < n)
    safe = slot.clamp(0, n - 1).to(torch.int64)
    cur = torch.where(live[:, None], data[safe], 0)
    ver = torch.where(live, version[safe], 0)
    match = (cur == expected).all(1)
    okw = live & ((kind == STORE) | ((kind == CAS) & match)
                  | ((kind == SC) & (link_ver == ver)))
    scatter_set(data, safe, desired, okw)
    version.index_add_(0, safe, 2 * okw.to(version.dtype))
    return data, version, cur, ver, okw.to(torch.int32)


slow_round_plain = engine.slow_round_plain


def _launch(fn_name, data, version, slot, kind, link_ver, expected,
            desired):
    """Validate the round's operands and launch kernel `fn_name` on the
    current stream.  Returns the output tensors."""
    from repro_torch.kernels import _build

    n, k = data.shape
    p = slot.shape[0]
    dev = data.device
    _build.check(dev,
                 ("data", data, WORD_DTYPE, (n, k)),
                 ("version", version, WORD_DTYPE, (n,)),
                 ("slot", slot, torch.int32, (p,)),
                 ("kind", kind, torch.int32, (p,)),
                 ("link_ver", link_ver, WORD_DTYPE, (p,)),
                 ("expected", expected, WORD_DTYPE, (p, k)),
                 ("desired", desired, WORD_DTYPE, (p, k)))
    val = torch.empty((p, k), dtype=WORD_DTYPE, device=dev)
    ver = torch.empty((p,), dtype=WORD_DTYPE, device=dev)
    ok = torch.empty((p,), dtype=torch.int32, device=dev)
    if p == 0:
        return val, ver, ok
    _build.launch("engine_round", fn_name, dev, data.data_ptr(),
                  version.data_ptr(), n, k, slot.data_ptr(), kind.data_ptr(),
                  link_ver.data_ptr(), expected.data_ptr(),
                  desired.data_ptr(), p, val.data_ptr(), ver.data_ptr(),
                  ok.data_ptr())
    return val, ver, ok


def fast_round(data, version, slot, kind, link_ver, expected, desired):
    """One fast-path pass; replaces the reference's `fast_round_pallas`.

    data: word[n, k]; version: word[n]; slot: int32[p] (inactive lanes ->
    n); link_ver: word[p] (odd-poisoned when the lane's link cannot
    validate).  Precondition: live writing lanes target distinct slots (or
    the batch is read-only).  Updates the table in place.  Returns (data,
    version, witness[p, k], ver_pt[p], okw int32[p]).

    CPU tensors run `fast_round_plain`; CUDA tensors launch the CUDA kernel
    `fast_round_kernel` or raise."""
    if data.device.type == "cpu":
        return fast_round_plain(data, version, slot, kind, link_ver,
                                expected, desired)
    if data.device.type != "cuda":
        raise ValueError(f"fast_round: unsupported device {data.device}")
    out = _launch("fast_round", data, version, slot, kind, link_ver,
                  expected, desired)
    fast_round.launches += 1
    return (data, version) + out


def slow_round(data, version, s_slot, s_kind, s_link_ver, s_expected,
               s_desired):
    """One sequential-replay pass over lanes SORTED by (slot, lane);
    replaces the reference's `slow_round_pallas`.

    Every cell segment loads its row once, applies its ops in order with
    full LOAD/STORE/CAS/LL/SC/VALIDATE semantics and writes the row back
    once.  Lanes whose slot lies outside [0, n) are failed no-ops with zero
    outputs.  Updates the table in place; returns (data, version,
    val_pt[p, k], ver_pt[p], success int32[p]) in the sorted order.

    CPU tensors run `slow_round_plain`; CUDA tensors launch the CUDA kernel
    `slow_round_kernel` or raise."""
    if data.device.type == "cpu":
        d, v, val, ver, succ = slow_round_plain(
            data, version, s_slot, s_kind, s_link_ver, s_expected, s_desired)
        return d, v, val, ver, succ.to(torch.int32)
    if data.device.type != "cuda":
        raise ValueError(f"slow_round: unsupported device {data.device}")
    out = _launch("slow_round", data, version, s_slot, s_kind, s_link_ver,
                  s_expected, s_desired)
    slow_round.launches += 1
    return (data, version) + out


fast_round.launches = 0
slow_round.launches = 0


# ---------------------------------------------------------------------------
# Host-side assembly around the rounds.
# ---------------------------------------------------------------------------

def _assemble_fast(n: int, ctx: LinkCtx, ops: OpBatch, link_ver, cur, ver,
                   okw, new_data, new_version):
    """Per-lane results / ctx / stats for an independent (fast-path) batch.

    cur/ver are each lane's pre-batch cell value+version; okw is write
    success for STORE/CAS/SC lanes (False elsewhere)."""
    kind = ops.kind
    active = kind != IDLE
    is_read = (kind == LOAD) | (kind == LL)
    is_valcas = active & ((kind == STORE) | (kind == CAS))
    is_sc = active & (kind == SC)
    is_upd = is_valcas | is_sc

    vl_ok = link_ver == ver                      # poisoned-odd never matches
    success = torch.where(
        is_read | (kind == STORE), active,
        torch.where(kind == VALIDATE, vl_ok,
                    torch.where(is_upd, okw, False)))
    value = torch.where(active[:, None], cur, 0)

    is_ll = (kind == LL) & active
    new_ctx = LinkCtx(
        slot=torch.where(is_ll, ops.slot, ctx.slot),
        version=torch.where(is_ll, ver, ctx.version),
        value=torch.where(is_ll[:, None], cur, ctx.value),
        linked=torch.where(is_ll, True,
                           torch.where(kind == SC, False, ctx.linked)),
    )
    i32 = torch.int32
    stats = ApplyStats(
        rounds=is_upd.any().to(i32),
        n_updates=(is_valcas | (is_sc & okw)).sum().to(i32),
        n_loads=(active & is_read).sum().to(i32),
        n_cas_fail=((((kind == CAS) & active) | is_sc) & ~okw).sum().to(i32),
        # No two lanes share a written cell on the fast path, so no load
        # ever races a write and every successful write dirties its own cell.
        n_raced_loads=torch.zeros((), dtype=i32, device=kind.device),
        n_dirty_cells=okw.sum().to(i32),
    )
    return new_data, new_version, new_ctx, ApplyResult(value, success), stats


def _fast(round_pass, n: int, data, version, ctx: LinkCtx, ops: OpBatch):
    slot = torch.where(ops.kind != IDLE, ops.slot, n)
    link_ver = poisoned_link_ver(ctx, ops.slot)
    new_data, new_version, wit, verpt, okw = round_pass(
        data, version, slot, ops.kind, link_ver, ops.expected, ops.desired)
    return _assemble_fast(n, ctx, ops, link_ver, wit, verpt, okw != 0,
                          new_data, new_version)


def _slow(n: int, data, version, ctx: LinkCtx, ops: OpBatch):
    """Sort once, replay in one kernel pass, then rebuild ctx/result/stats
    exactly as `linearize` defines them."""
    lanes = engine.sort_lanes(n, ctx, ops)
    new_data, new_version, val_s, verpt_s, succ_i = slow_round(
        data, version, lanes.slot, lanes.kind, lanes.link_ver,
        lanes.expected, lanes.desired)
    new_ctx, result, stats = engine.rebuild(n, ctx, lanes, val_s, verpt_s,
                                            succ_i != 0)
    return new_data, new_version, new_ctx, result, stats


# ---------------------------------------------------------------------------
# The round factory: what StrategyImpl.lower_round hands the engine.
# ---------------------------------------------------------------------------

def make_round(n: int, k: int, *, mode: str | None = None):
    """Build a fused round callable with the `engine.linearize` signature:
    (data, version, ctx, ops) -> (data', version', ctx', ApplyResult,
    ApplyStats), updating `data` and `version` in place.

    mode  'pallas' the kernel tier: `fast_round` / `slow_round`;
          'xla'    the plain tier: `fast_round_plain`, `linearize` slow path;
          'off'    `linearize` itself; None resolves `configured_mode()`.
    """
    r_mode = resolved_mode(mode)
    if r_mode == "off":
        return engine.linearize

    def round_fn(data, version, ctx: LinkCtx, ops: OpBatch):
        # linearize gathers ctx lanes by sorted lane index, which for a ctx
        # wider than the batch means "the first p lanes"; replicate that so
        # both tiers see (and return) batch-width ctx exactly as it does.
        if ctx.slot.shape[0] != ops.p:
            ctx = LinkCtx(*(x[:ops.p] for x in ctx))
        take_fast = bool(fast_path_ok(n, ops))      # host sync
        if r_mode == "pallas":
            if take_fast:
                return _fast(fast_round, n, data, version, ctx, ops)
            return _slow(n, data, version, ctx, ops)
        if take_fast:
            return _fast(fast_round_plain, n, data, version, ctx, ops)
        return engine.linearize(data, version, ctx, ops)

    return round_fn
