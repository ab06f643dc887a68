"""The unified big-atomic engine: ONE op schema, ONE linearization (PyTorch).

One `OpBatch` whose per-lane `kind` covers LOAD / STORE / CAS / IDLE (value
ops), LL / SC / VALIDATE (version ops with a per-lane `LinkCtx`) and the
hash kinds FIND / INSERT / DELETE (reserved for the CacheHash layer).  The
seven table kinds get one vectorised linearization, `linearize`, that is
bit-identical to the sequential oracle `apply_ops_reference`: ops apply in
lane order; STORE/CAS serialize within a cell segment; SC commits iff its
lane's link version still matches the cell.

`apply(spec, state, ops, ctx)` is the single table-level entry point.  The
round it runs comes from `round_for(spec)`: the strategy's lowered fused
round (`repro_torch.kernels.engine_round`, the hand-written CUDA kernels on
a card) when the layout provides one, else the plain `linearize`.

Host syncs (device-to-host reads where the reference branched on the
device):
  * `check_kinds` copies kinds that are already on a card back to validate
    them, as the reference's `np.asarray` does, except while the stream is
    being captured into a CUDA graph (kinds given on the host are checked
    there before the upload);
  * `linearize` (the `xla` and `off` tiers) reads `any(STORE|CAS)` to pick
    its branch and, on the general branch, the number of combining rounds
    L.
The kernel tier's round (`kernels/engine_round.py`) and the layouts'
`commit` read nothing back, so a kernel-tier `apply` on kinds that are the
caller's contract can be captured in a CUDA graph.  `apply_round` takes
host (numpy) ops, checks their kinds on the host, uploads them through
pinned buffers and copies its results back the same way: such a round
waits for nothing on the stream (the executor's issue path).

Telemetry (`repro_torch.obs`, BIGATOMIC_OBS=counters): a round given
`telem=` counts its batch into the device counters after it resolves it,
from the sorted slots and the predicate it already holds, with in-place
adds and no host read.  With counters off no round is given `telem` and
`apply` runs exactly the operations it runs without telemetry.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import registry
from repro_torch.core.layout import (WORD_DTYPE, TableState, as_words,
                                     clamped_index, resolve_device,
                                     scatter_set)
from repro_torch.core.specs import AtomicSpec
from repro_torch.obs import telemetry as obs_telemetry

# Op kinds (the reference's numeric values).
LOAD = 0
STORE = 1
CAS = 2
IDLE = 3      # padding lane: reports invalid
LL = 4        # load-linked: read value, link (slot, version)
SC = 5        # store-conditional: commit desired iff link still valid
VALIDATE = 6  # is my link still valid?  (never writes)
FIND = 7
INSERT = 8
DELETE = 9

TABLE_KINDS = (LOAD, STORE, CAS, IDLE, LL, SC, VALIDATE)
HASH_KINDS = (FIND, INSERT, DELETE, IDLE)


class OpBatch(NamedTuple):
    """A batch of `p` operations over an `(n, k)` table.

    kind:     int32[p]   — one of the kind constants above
    slot:     int32[p]   — target cell index in [0, n)
    expected: word[p, k] — CAS comparand (ignored otherwise)
    desired:  word[p, k] — value to write (STORE / successful CAS / SC)
    """

    kind: torch.Tensor
    slot: torch.Tensor
    expected: torch.Tensor
    desired: torch.Tensor

    @property
    def p(self) -> int:
        return self.kind.shape[0]

    @property
    def k(self) -> int:
        return self.desired.shape[1]


class LinkCtx(NamedTuple):
    """Per-lane link state, carried across batches.

    slot:    int32[p]   linked cell (-1 = never linked)
    version: word[p]    version observed at the LL
    value:   word[p,k]  value observed at the LL
    linked:  bool[p]    link is live (consumed by any SC attempt)
    """

    slot: torch.Tensor
    version: torch.Tensor
    value: torch.Tensor
    linked: torch.Tensor


class ApplyResult(NamedTuple):
    """Per-lane results of a linearized batch.

    value:   word[p, k] — the value witnessed at the op's linearization point.
    success: bool[p]    — CAS/SC success, VALIDATE link validity
                          (LOAD/STORE/LL: True, IDLE: False).
    """

    value: torch.Tensor
    success: torch.Tensor


class ApplyStats(NamedTuple):
    """Traffic/contention statistics for one batch (int32 scalars).

    rounds:        serialization rounds L (1 on the pure-sync fast path).
    n_updates:     store/CAS lanes + successful SC lanes (writes attempted).
    n_loads:       LOAD + LL lanes.
    n_cas_fail:    CAS/SC lanes that failed.
    n_raced_loads: loads whose cell had >=1 write in this batch.
    n_dirty_cells: distinct cells receiving >=1 successful write.
    """

    rounds: torch.Tensor
    n_updates: torch.Tensor
    n_loads: torch.Tensor
    n_cas_fail: torch.Tensor
    n_raced_loads: torch.Tensor
    n_dirty_cells: torch.Tensor


def init_ctx(p: int, k: int, *, device="cuda") -> LinkCtx:
    dev = resolve_device(device)
    return LinkCtx(
        slot=torch.full((p,), -1, dtype=torch.int32, device=dev),
        version=torch.zeros((p,), dtype=WORD_DTYPE, device=dev),
        value=torch.zeros((p, k), dtype=WORD_DTYPE, device=dev),
        linked=torch.zeros((p,), dtype=torch.bool, device=dev),
    )


def _as_i32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32)
    return torch.as_tensor(np.asarray(x, dtype=np.int64),
                           device=device).to(torch.int32)


def make_ops(kind, slot, expected=None, desired=None, *, k: int,
             device="cuda") -> OpBatch:
    """THE checked op-batch constructor: every public wrapper routes through
    here so validation and dtype coercion can never be skipped.

    Checks kind values are known and shapes line up with the batch width p
    and cell width k.  Word payloads (uint32 or int32 arrays/tensors) become
    int32 word tensors on `device` with the same bits."""
    try:                        # on the host, before anything is uploaded
        check_kinds(kind, tuple(range(DELETE + 1)), "known")
    except ValueError as err:
        raise ValueError(f"unknown op kinds: {err}") from None
    dev = resolve_device(device)
    kind = _as_i32(kind, dev)
    slot = _as_i32(slot, dev)
    if kind.dim() != 1:
        raise ValueError(f"kind must be rank-1, got shape {tuple(kind.shape)}")
    p = kind.shape[0]
    if tuple(slot.shape) != (p,):
        raise ValueError(f"slot shape {tuple(slot.shape)} != ({p},)")
    zeros = torch.zeros((p, k), dtype=WORD_DTYPE, device=dev)
    expected = zeros if expected is None else as_words(expected, dev)
    desired = zeros.clone() if desired is None else as_words(desired, dev)
    for name, arr in (("expected", expected), ("desired", desired)):
        if tuple(arr.shape) != (p, k):
            raise ValueError(f"{name} shape {tuple(arr.shape)} != ({p}, {k})")
    return OpBatch(kind, slot, expected, desired)


def loads(slots, *, k: int, device="cuda") -> OpBatch:
    slots = _as_i32(slots, resolve_device(device))
    return make_ops(torch.full_like(slots, LOAD), slots, k=k, device=device)


def stores(slots, desired, *, k: int, device="cuda") -> OpBatch:
    slots = _as_i32(slots, resolve_device(device))
    return make_ops(torch.full_like(slots, STORE), slots, desired=desired,
                    k=k, device=device)


def cas_ops(slots, expected, desired, *, k: int, device="cuda") -> OpBatch:
    slots = _as_i32(slots, resolve_device(device))
    return make_ops(torch.full_like(slots, CAS), slots, expected=expected,
                    desired=desired, k=k, device=device)


def sync_ops(kind, slots, desired=None, *, k: int, device="cuda") -> OpBatch:
    return make_ops(kind, slots, desired=desired, k=k, device=device)


# ---------------------------------------------------------------------------
# Sequential oracle (numpy) — THE definition of correctness.
# ---------------------------------------------------------------------------

def apply_ops_reference(data: np.ndarray, version: np.ndarray, ctx, ops, *,
                        copy: bool = True):
    """Apply mixed table ops one at a time in lane order.  Pure numpy.

    Inputs are numpy arrays (words as uint32; see `repro_torch.convert`) or
    NamedTuples of them.  Returns (new_data, new_version, new_ctx,
    ApplyResult-as-numpy).  `copy=False` updates `data` and `version` in
    place (and returns them): for a long replay over a large table."""
    if copy:
        data = np.array(data, copy=True)
        version = np.array(version, copy=True)
    c_slot = np.array(ctx[0], copy=True)
    c_ver = np.array(ctx[1], copy=True)
    c_val = np.array(ctx[2], copy=True)
    c_lnk = np.array(ctx[3], copy=True)
    kind = np.asarray(ops[0])
    slot = np.asarray(ops[1])
    expected = np.asarray(ops[2])
    desired = np.asarray(ops[3])
    p, k = desired.shape
    value = np.zeros((p, k), dtype=data.dtype)
    success = np.zeros((p,), dtype=bool)
    for i in range(p):
        s = slot[i]
        if kind[i] == IDLE:
            continue
        cur = data[s].copy()
        value[i] = cur
        if kind[i] == LOAD:
            success[i] = True
        elif kind[i] == STORE:
            data[s] = desired[i]
            version[s] += 2
            success[i] = True
        elif kind[i] == CAS:
            if np.array_equal(cur, expected[i]):
                data[s] = desired[i]
                version[s] += 2
                success[i] = True
        elif kind[i] == LL:
            c_slot[i], c_ver[i], c_val[i], c_lnk[i] = \
                s, version[s], cur, True
            success[i] = True
        elif kind[i] == VALIDATE:
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
        else:
            raise ValueError(f"lane {i}: kind {kind[i]} is not a table op")
    new_ctx = LinkCtx(c_slot, c_ver, c_val, c_lnk)
    return data, version, new_ctx, ApplyResult(value, success)


# ---------------------------------------------------------------------------
# Segment helpers on (slot, lane)-sorted lanes.
#
# The reference uses an associative segmented max-scan; every use of it
# scans lane indices (or flags), which grow along the sorted order, so a
# global `cummax` clipped at the segment start gives the same answer.
# ---------------------------------------------------------------------------

def _segments(s_slot: torch.Tensor):
    """(idx, seg_start, start_idx, end_idx) for sorted slots: each lane's
    index, whether it starts a segment, and its segment's first and last
    lane."""
    p = s_slot.shape[0]
    idx = torch.arange(p, dtype=torch.int64, device=s_slot.device)
    seg_start = torch.ones(p, dtype=torch.bool, device=s_slot.device)
    seg_start[1:] = s_slot[1:] != s_slot[:-1]
    seg_end = torch.ones_like(seg_start)
    seg_end[:-1] = seg_start[1:]
    start_idx = torch.cummax(torch.where(seg_start, idx, -1), 0).values
    end_idx = _rev_cummin(torch.where(seg_end, idx, p))
    return idx, seg_start, start_idx, end_idx


def _rev_cummin(x):
    return torch.flip(torch.cummin(torch.flip(x, [0]), 0).values, [0])


def _last_in_segment(flags, idx, start_idx):
    """Per lane: index of the last flagged lane at or before it within its
    segment, else -1 (the reference's segmented max-scan of flagged idx)."""
    last = torch.cummax(torch.where(flags, idx, -1), 0).values
    return torch.where(last >= start_idx, last, -1)


def _any_from_here(flags, idx, end_idx):
    """Per lane: is any lane at or after it within its segment flagged?
    (The reference's `_seg_broadcast_any`, a reversed segmented scan; at a
    segment start it is the whole segment's any.)"""
    nxt = _rev_cummin(torch.where(flags, idx, flags.shape[0]))
    return nxt <= end_idx


def _upd_rank(is_upd, start_idx):
    """Segment-local exclusive count of updates before each lane."""
    cum = torch.cumsum(is_upd, 0)
    excl = cum - is_upd.to(cum.dtype)
    return excl - excl[start_idx]


def _i32sum(x) -> torch.Tensor:
    return x.sum().to(torch.int32)


def stats_on_sorted(n: int, s_slot, s_kind, succ_s) -> ApplyStats:
    """`ApplyStats` from the (slot, lane)-sorted order — THE single
    definition: `linearize` and the kernel round's plain epilogue call it,
    and `round_epilogue_kernel` (`kernels/csrc/engine_round.cu`) computes
    the same on both of its branches.

    succ_s is per-lane success in sorted order (read only on STORE/CAS/SC
    lanes)."""
    idx, _, start_idx, end_idx = _segments(s_slot)
    is_valcas = (s_kind == STORE) | (s_kind == CAS)
    is_sc = (s_kind == SC) & (s_slot < n)
    is_upd = is_valcas | is_sc
    is_read = (s_kind == LOAD) | (s_kind == LL)
    upd_rank = _upd_rank(is_upd, start_idx)
    # the rank of the last update of its segment; -1 pads an empty batch
    last = torch.nn.functional.pad(torch.where(is_upd, upd_rank, -1), (0, 1),
                                   value=-1)
    n_rounds = torch.where(is_upd.any(), last.max() + 1, 0)
    wrote = is_valcas | (is_sc & succ_s)
    seg_any_wrote = _any_from_here(wrote, idx, end_idx)
    return ApplyStats(
        rounds=torch.where(is_valcas.any(), n_rounds,
                           torch.where(is_sc.any(), 1, 0)).to(torch.int32),
        n_updates=_i32sum(wrote),
        n_loads=_i32sum(is_read),
        n_cas_fail=_i32sum(((s_kind == CAS) | is_sc) & ~succ_s),
        n_raced_loads=_i32sum(is_read & seg_any_wrote),
        n_dirty_cells=_i32sum(_dirty_starts(n, s_slot, s_kind, succ_s)),
    )


def _dirty_starts(n: int, s_slot, s_kind, succ_s):
    """Per sorted lane: does it start the segment of a cell (slot < n) that
    a lane of the batch wrote (a successful STORE/CAS/SC)?"""
    idx, seg_start, _, end_idx = _segments(s_slot)
    is_upd = (s_kind == STORE) | (s_kind == CAS) | ((s_kind == SC)
                                                     & (s_slot < n))
    return (seg_start & _any_from_here(succ_s & is_upd, idx, end_idx)
            & (s_slot < n))


def dirty_slots(n: int, s_slot, s_kind, succ_s) -> torch.Tensor:
    """The cells the batch wrote, from the (slot, lane)-sorted order: an
    int32[p] list in ascending slot order, padded with n.  Its length up
    to the padding is `stats_on_sorted(...).n_dirty_cells`.  The layouts'
    `commit` hands out nodes in this order, as the reference's scan over
    the whole table does."""
    return compact_starts(n, s_slot,
                          _dirty_starts(n, s_slot, s_kind, succ_s))


def compact_starts(n: int, s_slot, flag) -> torch.Tensor:
    """The sorted slots of the lanes `flag` marks (each a segment's first
    lane), in order, as an int32[p] list padded with n: p-sized operations,
    no host read."""
    p = s_slot.shape[0]
    rank = torch.cumsum(flag, 0) - flag.to(torch.int64)
    out = torch.full((p + 1,), n, dtype=torch.int32, device=s_slot.device)
    out[torch.where(flag, rank, p)] = s_slot.to(torch.int32)
    return out[:p]


# ---------------------------------------------------------------------------
# Vectorised linearization — bit-identical to the oracle.
# ---------------------------------------------------------------------------

def lane_success(s_kind, live, s_link_ver, verpt_s, succ_upd):
    """Per-lane success: LOAD/STORE/LL succeed on a live cell, VALIDATE iff
    its link version equals the cell's version at its turn, CAS/SC per their
    write, IDLE and dead lanes never."""
    return live & torch.where(
        (s_kind == LOAD) | (s_kind == STORE) | (s_kind == LL), True,
        torch.where(s_kind == VALIDATE, s_link_ver == verpt_s,
                    torch.where((s_kind == CAS) | (s_kind == SC),
                                succ_upd, False)))


def slow_round_plain(data, version, s_slot, s_kind, s_link_ver, s_expected,
                     s_desired, *, fast=None):
    """Sequential replay over lanes sorted by (slot, lane), vectorised as L
    combining rounds: round t applies the t-th write of every cell segment
    in parallel (gather -> check -> masked scatter).  Reads the round count
    L back to the host.

    Updates `data` and `version` in place and returns (data, version,
    val_pt[p, k], ver_pt[p], success[p]) in the sorted order.  A lane whose
    slot lies outside [0, n) is dead: zeros and success False.  Where the
    0-d bool `fast` is True (the kernel round's fast branch) every lane is
    dead: the table is left alone."""
    n = data.shape[0]
    idx, _, start_idx, _ = _segments(s_slot)
    live = (s_slot >= 0) & (s_slot < n)
    if fast is not None:
        live = live & ~fast
    safe = s_slot.clamp(0, n - 1).to(torch.int64)
    is_upd = live & ((s_kind == STORE) | (s_kind == CAS) | (s_kind == SC))
    upd_rank = _upd_rank(is_upd, start_idx)
    n_rounds = int(torch.where(is_upd, upd_rank, -1).max()) + 1 \
        if s_slot.numel() else 0

    init_vals = data[safe]
    ver0 = version[safe]
    res_after = torch.zeros_like(init_vals)    # value AFTER each write lane
    ver_after = torch.zeros_like(ver0)         # version AFTER each write lane
    witness = torch.zeros_like(init_vals)      # value BEFORE each write lane
    wver = torch.zeros_like(ver0)              # version BEFORE each write lane
    succ = torch.zeros_like(live)
    for t in range(n_rounds):
        lt = is_upd & (upd_rank == t)
        cur = data[safe]
        curv = version[safe]
        match = (cur == s_expected).all(1)
        ok = lt & ((s_kind == STORE) | ((s_kind == CAS) & match)
                   | ((s_kind == SC) & (s_link_ver == curv)))
        scatter_set(data, safe, s_desired, ok)
        version.index_add_(0, safe, 2 * ok.to(version.dtype))
        res_after = torch.where(lt[:, None],
                                torch.where(ok[:, None], s_desired, cur),
                                res_after)
        ver_after = torch.where(lt, curv + 2 * ok.to(curv.dtype), ver_after)
        witness = torch.where(lt[:, None], cur, witness)
        wver = torch.where(lt, curv, wver)
        succ = torch.where(lt, ok, succ)

    # Non-write lanes observe the last write preceding them in-segment.
    prev = _last_in_segment(is_upd, idx, start_idx)
    has_prev = prev >= 0
    pi = prev.clamp(min=0)
    val_pt = torch.where(has_prev[:, None], res_after[pi], init_vals)
    ver_pt = torch.where(has_prev, ver_after[pi], ver0)
    val_s = torch.where(is_upd[:, None], witness, val_pt)
    verpt_s = torch.where(is_upd, wver, ver_pt)
    val_s = torch.where(live[:, None], val_s, 0)
    verpt_s = torch.where(live, verpt_s, 0)
    return (data, version, val_s, verpt_s,
            lane_success(s_kind, live, s_link_ver, verpt_s, succ))


def _pure_sc_sorted(data, version, s_slot, s_kind, s_link_ver, s_desired):
    """One-round closed form for batches without STORE/CAS lanes: every
    SC's link predates the batch, so the first eligible SC per cell wins
    and every later SC on that cell is already stale.  Updates the table in
    place; returns (data, version, val_s, verpt_s, success) sorted.  A lane
    whose slot lies outside [0, n) is dead: zeros and success False, as in
    `slow_round_plain`."""
    n = data.shape[0]
    idx, seg_start, start_idx, _ = _segments(s_slot)
    live = (s_slot >= 0) & (s_slot < n)
    safe = s_slot.clamp(0, n - 1).to(torch.int64)
    init_vals = data[safe]
    ver0 = version[safe]
    eligible = live & (s_kind == SC) & (s_link_ver == ver0)
    elig_last = _last_in_segment(eligible, idx, start_idx)
    elig_before = torch.zeros_like(eligible)
    elig_before[1:] = elig_last[:-1] >= 0
    elig_before &= ~seg_start
    win = eligible & ~elig_before
    # Lanes strictly after the winner observe the committed value/version.
    wpos = _last_in_segment(win, idx, start_idx)
    post_excl = (wpos >= 0) & ~win
    val_s = torch.where(post_excl[:, None], s_desired[wpos.clamp(min=0)],
                        init_vals)
    verpt_s = ver0 + 2 * post_excl.to(ver0.dtype)
    val_s = torch.where(live[:, None], val_s, 0)
    verpt_s = torch.where(live, verpt_s, 0)
    scatter_set(data, safe, s_desired, win)
    version.index_add_(0, safe, 2 * win.to(version.dtype))
    return (data, version, val_s, verpt_s,
            lane_success(s_kind, live, s_link_ver, verpt_s, win))


class SortedLanes(NamedTuple):
    """A batch permuted into (slot, lane) order, inactive lanes at slot n."""

    order: torch.Tensor
    inv: torch.Tensor
    slot: torch.Tensor
    kind: torch.Tensor
    link_ver: torch.Tensor
    expected: torch.Tensor
    desired: torch.Tensor


def poisoned_link_ver(ctx: LinkCtx, slot) -> torch.Tensor:
    """A lane's link version, odd-poisoned when the link cannot validate
    (dead link or link naming a different cell) — cell versions are always
    even, so a poisoned link never matches."""
    link_ok = ctx.linked & (ctx.slot == slot)
    return torch.where(link_ok, ctx.version, 1)


def sort_lanes(n: int, ctx: LinkCtx, ops: OpBatch) -> SortedLanes:
    """The slow round's pre-step: one stable sort by slot (inactive lanes
    -> n), its inverse permutation, and the sorted lane arrays.  `ctx` may
    be wider than the batch; its first p lanes are the batch's."""
    p = ops.p
    active = ops.kind != IDLE
    slot = torch.where(active, ops.slot, n)
    order = torch.argsort(slot, stable=True)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(p, dtype=order.dtype, device=order.device)
    c = LinkCtx(*(x[:p] for x in ctx))
    return SortedLanes(order, inv, slot[order], ops.kind[order],
                       poisoned_link_ver(c, ops.slot)[order],
                       ops.expected[order], ops.desired[order])


def rebuild(n: int, ctx: LinkCtx, lanes: SortedLanes, val_s, verpt_s,
            s_success):
    """The slow round's post-step: ctx, per-lane results (back in lane
    order), stats and the dirty-slot list from the sorted replay's
    outputs."""
    order, inv = lanes.order, lanes.inv
    s_slot, s_kind = lanes.slot, lanes.kind
    is_ll = (s_kind == LL) & (s_slot < n)
    n_slot = torch.where(is_ll, s_slot, ctx.slot[order])
    n_ver = torch.where(is_ll, verpt_s, ctx.version[order])
    n_val = torch.where(is_ll[:, None], val_s, ctx.value[order])
    n_lnk = torch.where(is_ll, True,
                        torch.where(s_kind == SC, False, ctx.linked[order]))
    new_ctx = LinkCtx(n_slot[inv], n_ver[inv], n_val[inv], n_lnk[inv])
    s_value = torch.where((s_kind != IDLE)[:, None], val_s, 0)
    result = ApplyResult(s_value[inv], s_success[inv])
    return (new_ctx, result, stats_on_sorted(n, s_slot, s_kind, s_success),
            dirty_slots(n, s_slot, s_kind, s_success))


def linearize(data, version, ctx: LinkCtx, ops: OpBatch, *, telem=None):
    """Linearize a mixed LOAD/STORE/CAS/LL/SC/VALIDATE batch in lane order.

    `data` is word[n, k] and `version` word[n] (bumped by 2 per successful
    write); both are updated in place.  Returns (data', version', ctx',
    ApplyResult, ApplyStats, dirty slots: `dirty_slots`).  Active lanes
    must name slots in [0, n): the reference clamp-gathers an out-of-range
    slot, this port treats it as a failed no-op, as the kernels do.  With
    `telem` (`obs.telemetry.carry_in`), the batch is counted, never as
    taken by the fast path."""
    n = data.shape[0]
    lanes = sort_lanes(n, ctx, ops)
    is_valcas = (lanes.kind == STORE) | (lanes.kind == CAS)
    if bool(is_valcas.any()):                       # host sync
        data, version, val_s, verpt_s, succ_s = slow_round_plain(
            data, version, lanes.slot, lanes.kind, lanes.link_ver,
            lanes.expected, lanes.desired)
    else:
        data, version, val_s, verpt_s, succ_s = _pure_sc_sorted(
            data, version, lanes.slot, lanes.kind, lanes.link_ver,
            lanes.desired)
    out = (data, version) + rebuild(n, ctx, lanes, val_s, verpt_s, succ_s)
    if telem is not None:
        obs_telemetry.count_table(
            telem, n, ops, out[3], out[4], s_slot=lanes.slot,
            eligible=_engine_round().fast_flag(n, ops, lanes.slot),
            taken=torch.zeros((), dtype=torch.bool, device=data.device))
    return out


# ---------------------------------------------------------------------------
# Txn-group lane metadata: conflict arbitration for multi-lane transactions.
# ---------------------------------------------------------------------------

def arbitrate_groups(slot, group, eligible, *, n: int, n_groups: int):
    """The linearizer's lane-order rule lifted to whole lane GROUPS.

    A transaction (`repro_torch.txn.mcas`) is a group of lanes that must
    commit all-or-nothing.  The lowest-id eligible group claiming a cell
    wins that cell, and a group is a WINNER iff it wins every cell it
    claims.  Winners are therefore pairwise cell-disjoint, so a pure-SC
    commit batch of all their lanes resolves on the engine's one-round
    fast path with every SC succeeding.  The lowest-id eligible group
    always wins all its cells, so >= 1 group resolves per round.

    slot:     int32[p]  claimed cell per lane (out-of-range = unused lane)
    group:    int32[p]  owning group id per lane, in [0, n_groups)
    eligible: bool[p]   lane belongs to a group contending this round

    Returns bool[n_groups]: the winner mask.  The lowest group per cell is
    a scatter-min into an (n + 1)-sized buffer whose last entry takes the
    dead lanes, as the reference's; no host read."""
    dev = slot.device
    in_range = (slot >= 0) & (slot < n)
    live = eligible & in_range
    claim = torch.where(live, slot, n).long()
    gid = torch.where(live, group, n_groups).to(torch.int32)
    cell_min = torch.full((n + 1,), n_groups, dtype=torch.int32, device=dev)
    cell_min.scatter_reduce_(0, claim, gid, "amin")
    lane_wins = (cell_min[claim] == group).to(torch.int32)
    # A group wins iff ALL its live lanes win (scatter-AND via min).
    grp = torch.ones((n_groups + 1,), dtype=torch.int32, device=dev)
    grp.scatter_reduce_(0, gid.long(), lane_wins, "amin")
    return grp[:n_groups] > 0


# ---------------------------------------------------------------------------
# Round lowering: strategies may swap `linearize` for a fused kernel round.
# ---------------------------------------------------------------------------

def _engine_round():
    from repro_torch.kernels import engine_round  # lazy: kernels import engine
    return engine_round


def round_for(spec: AtomicSpec, impl=None, mode: str | None = None):
    """The execution round for `spec`: the strategy's lowered kernel round
    when it provides one and the engine-kernel mode allows it, else the
    plain `linearize`.  The returned callable has the `linearize`
    signature and return values."""
    mode = _engine_round().resolved_mode(mode)
    if mode == "off":
        return linearize
    if impl is None:
        impl = registry.get_strategy(spec.strategy)
    lowered = impl.lower_round(spec, mode=mode)
    return linearize if lowered is None else lowered


def canonicalize_ops(ops: OpBatch, device) -> OpBatch:
    """Coerce an op batch to the canonical dtypes (int32 kinds/slots, int32
    word bits) on `device`."""
    return OpBatch(_as_i32(ops.kind, device), _as_i32(ops.slot, device),
                   as_words(ops.expected, device),
                   as_words(ops.desired, device))


def canonicalize_ctx(ctx: LinkCtx, device) -> LinkCtx:
    linked = ctx.linked
    linked = (linked.to(device=device, dtype=torch.bool)
              if isinstance(linked, torch.Tensor)
              else torch.as_tensor(np.asarray(linked, bool), device=device))
    return LinkCtx(_as_i32(ctx.slot, device), as_words(ctx.version, device),
                   as_words(ctx.value, device), linked)


# ---------------------------------------------------------------------------
# The single public entry point: apply(spec, state, ops [, ctx]).
# ---------------------------------------------------------------------------

def host_copy(x) -> np.ndarray | None:
    """`x` as a numpy array for a check on the host: a tensor on a card is
    copied back (one sync, as the reference's `np.asarray` of a concrete
    array), except while the current stream is being captured into a CUDA
    graph, where it is the caller's contract and None is returned (the
    reference's traced input skips the check)."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda and torch.cuda.is_current_stream_capturing():
            return None
        return x.cpu().numpy()
    return np.asarray(x)


def check_kinds(kind, allowed, what: str) -> None:
    """Reject op kinds outside `allowed`, checked on the host.  Kinds on a
    card are copied back first (one sync, as the reference's `np.asarray`
    of a concrete array), except while the current stream is being
    captured into a CUDA graph: there, as the reference's traced kinds,
    they are the caller's contract."""
    kind = host_copy(kind)
    if kind is None:
        return
    bad = ~np.isin(kind, allowed)
    if bad.any():
        raise ValueError(f"op kinds {np.unique(kind[bad]).tolist()} are not "
                         f"{what} ops (allowed: {sorted(allowed)})")


def apply(spec: AtomicSpec, state: TableState, ops: OpBatch,
          ctx: LinkCtx | None = None, *, donate: bool = False):
    """Linearize `ops` against the table; maintain the strategy's layout.

    Runs on the state's device; ops and ctx are coerced to the canonical
    dtypes there.  `ctx` carries per-lane LL/SC links across batches; omit
    it for batches without LL/SC/VALIDATE lanes.

    Ownership: the round and the layout's `commit` update the table in
    place.  By default `apply` first copies the state, so the caller's
    `state` stays valid (the reference's non-donated jit).  `donate=True`
    skips that copy and updates the passed state's buffers; the caller must
    not reuse it afterwards.  With `donate=True`, on the kernel tier and
    kinds that are the caller's contract (see `check_kinds`), `apply` reads
    nothing back to the host and can be captured in a CUDA graph.

    Under BIGATOMIC_OBS=counters (or trace) the batch is counted into the
    device counters of `repro_torch.obs` by in-place adds after the round:
    no host read, and a captured `apply` counts on every replay.  Off, no
    counter is made or touched.

    Returns (state', ctx', ApplyResult, ApplyStats, Traffic)."""
    check_kinds(ops.kind, TABLE_KINDS, "table")
    return apply_checked(spec, state, ops, ctx, donate=donate)


def apply_checked(spec: AtomicSpec, state: TableState, ops: OpBatch,
                  ctx: LinkCtx | None = None, *, donate: bool = False):
    """`apply` after its kind check, which the caller has made (on the
    host, before uploading the ops): reads nothing back to the host on the
    kernel tier with `donate=True`, whatever device the kinds are on."""
    device = state.data.device
    ops = canonicalize_ops(ops, device)
    ctx = (init_ctx(ops.p, spec.k, device=device) if ctx is None
           else canonicalize_ctx(ctx, device))
    impl = registry.get_strategy(spec.strategy)
    new_state, new_ctx, result, stats = run_round(
        impl, round_for(spec, impl), state, ctx, ops, donate=donate,
        telem=obs_telemetry.carry_in(device))
    traffic = impl.traffic(stats, spec.k, ops.p)
    return new_state, new_ctx, result, stats, traffic


def run_round(impl, round_fn, state: TableState, ctx: LinkCtx, ops: OpBatch,
              *, donate: bool, telem=None):
    """Run `round_fn` on canonical `ops`/`ctx` and commit it to the layout,
    with `apply`'s ownership rule: copy the state first unless `donate`.
    The round updates the table in place and names the cells it wrote;
    `commit` reconciles only those.  `telem` (`obs.telemetry.carry_in`),
    when not None, is handed to the round, which counts the batch.
    Returns (state', ctx', ApplyResult, ApplyStats)."""
    if not donate:
        state = TableState(*(x.clone() for x in state))
    counted = {} if telem is None else {"telem": telem}
    new_data, new_version, new_ctx, result, stats, dirty = round_fn(
        impl.engine_view(state), state.version, ctx, ops, **counted)
    new_state = impl.commit(state, new_data, new_version, stats, dirty,
                            ops.p)
    return new_state, new_ctx, result, stats


def upload_ops(ops: OpBatch, device) -> tuple[OpBatch, tuple]:
    """Host ops (numpy) as canonical tensors on `device`; returns (ops,
    staged buffers).

    On a card each array is copied into a pinned host buffer and uploaded
    with `non_blocking=True`, so the upload waits for nothing already
    queued on the stream (a pageable upload waits for all of it).  The
    staged buffers are returned: keep them referenced until the round that
    reads them has run.  On the CPU the arrays are copied plainly."""
    device = torch.device(device)
    if device.type != "cuda":
        return canonicalize_ops(ops, device), ()
    staged = tuple(x.pin_memory() for x in canonicalize_ops(ops, "cpu"))
    return OpBatch(*(t.to(device, non_blocking=True) for t in staged)), staged


class RoundHandle:
    """A dispatched-but-not-awaited engine round.

    The outputs of `apply_round` may still be computing on the card; the
    handle names the five outputs, queues copies of the per-lane results
    into pinned host buffers behind the round (non-blocking) and records a
    CUDA event after them.  An executor can chain `state`/`ctx` into the
    next round (same stream), and `wait()` then `host_result()` read the
    results without touching the card: waiting on one round never waits
    for rounds issued after it.  `staged` keeps the round's uploaded
    inputs alive until the handle is dropped."""

    __slots__ = ("state", "ctx", "result", "stats", "traffic", "_event",
                 "_host", "_staged")

    def __init__(self, state, ctx, result, stats, traffic, *, staged=()):
        self.state = state
        self.ctx = ctx
        self.result = result
        self.stats = stats
        self.traffic = traffic
        self._staged = staged
        self._host = (result.value, result.success)
        self._event = None
        if state.data.is_cuda:
            self._host = tuple(
                torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                .copy_(x, non_blocking=True) for x in self._host)
            self._event = torch.cuda.Event()
            self._event.record()

    def ready(self) -> bool:
        """True iff every output is computed (non-blocking)."""
        return self._event is None or self._event.query()

    def wait(self) -> "RoundHandle":
        if self._event is not None:
            self._event.synchronize()
        return self

    def host_result(self) -> tuple[np.ndarray, np.ndarray]:
        """(value uint32[p, k], success bool[p]) as numpy copies; call
        after `wait()`."""
        value, success = (x.numpy() for x in self._host)
        return value.view(np.uint32).copy(), success.copy()


def apply_round(spec: AtomicSpec, state, ops: OpBatch,
                ctx: LinkCtx | None = None, *, donate: bool = False
                ) -> RoundHandle:
    """`apply` on host (numpy) ops as an overlappable round: identical
    semantics, the outputs wrapped in a `RoundHandle`.  The ops are
    kind-checked on the host and uploaded without waiting on the stream
    (`upload_ops`), and the results come back the same way
    (`host_result`): on the kernel tier with `donate=True`, the round
    reads nothing back.  Ops already on a device go through `apply`."""
    if isinstance(ops.kind, torch.Tensor):
        raise TypeError("apply_round takes host (numpy) ops; `apply` takes "
                        "tensors")
    check_kinds(ops.kind, TABLE_KINDS, "table")
    ops, staged = upload_ops(ops, state.data.device)
    return RoundHandle(*apply_checked(spec, state, ops, ctx, donate=donate),
                       staged=staged)


def init(spec: AtomicSpec, initial=None, *, device="cuda") -> TableState:
    """Build the initial `TableState` for `spec` on `device`."""
    dev = resolve_device(device)
    data = (torch.zeros((spec.n, spec.k), dtype=WORD_DTYPE, device=dev)
            if initial is None else as_words(initial, dev))
    if tuple(data.shape) != (spec.n, spec.k):
        raise ValueError(f"initial shape {tuple(data.shape)} != "
                         f"({spec.n}, {spec.k})")
    return registry.get_strategy(spec.strategy).init(spec.n, spec.k,
                                                     spec.p_max, data)


def read(spec: AtomicSpec, state: TableState, slots):
    """Honest per-strategy read protocol.  Returns (values[q, k], ok[q]).

    ok=False means the reader observed a torn/locked cell and must retry
    (blocking strategies only); lock-free strategies always return ok=True
    with a consistent value.  Under BIGATOMIC_OBS=counters the ok=False
    lanes count into `read.torn_retries` on the device.  A slot outside
    [0, n) reads as the reference's gather does: a negative slot counts
    from the end, then the slot is clamped into [0, n)."""
    slots = clamped_index(_as_i32(slots, state.data.device),
                          state.data.shape[0])
    values, ok = registry.get_strategy(spec.strategy).read(state, slots)
    telem = obs_telemetry.carry_in(state.data.device)
    if telem is not None:
        obs_telemetry.count_read(telem.telem, ok)
    return values, ok


def logical(spec: AtomicSpec, state: TableState):
    """The current logical value of every cell, derived from the layout."""
    return registry.get_strategy(spec.strategy).logical(state)
