"""Batched k-word MCAS over big atomics: multi-location atomicity on the
unified engine (PyTorch).

A transaction is a group of up to W (slot, expected, desired) lanes that
commit ALL-OR-NOTHING: if every claimed cell still holds its expected value
at the transaction's linearization point, all W desired values are written
(each cell's version bumps by 2, exactly as a store); otherwise nothing is
written and the transaction reports failure with the witnessed values.
This is the CAS-semantics MCAS of Blelloch & Wei ("LL/SC and Atomic Copy",
arXiv:1911.09671): multi-word atomicity built from LL/SC, with NO
descriptors; the batch-step engine arbitrates conflicts directly.

Protocol, per attempt round (three engine batches through the strategy's
round, `engine.run_round(impl, engine.round_for(spec, impl), ...)`, so
every layout gets MCAS and, on a card, every batch runs the round's four
CUDA kernels):

  1. LL-all       every lane of every contending txn load-links its cell.
                  A lane whose value != expected fails its whole txn NOW
                  (the txn linearizes at this read: the failure witness).
  2. VALIDATE-all surviving txns validate every link (links can only die
                  if a caller interleaves foreign traffic between rounds).
  3. arbitrate    `engine.arbitrate_groups`: lowest txn id claiming a cell
                  wins it; a txn is a winner iff it wins EVERY cell it
                  claims.  Winners are pairwise cell-disjoint.
  4. SC-commit    ONE pure-SC batch commits every winner lane (the round's
                  fast path: every link predates the batch and winners
                  never share a cell, so every SC succeeds).

Losers (ready but out-arbitrated) retry after a Dice-style abort backoff
(`repro_torch.sync.queue.BackoffPolicy`, arXiv:1305.5800) measured in
rounds.  The lowest pending txn id always wins arbitration, so every round
either fails or commits at least one txn: termination within `max_rounds`.

The CLAIMED linearization: round-major, failures before commits within a
round, txn id within each class; `linearization_order(result)` emits it,
and `mcas_reference` is the sequential replay that defines the semantics.

Host reads: `mcas_round` reads nothing back (on the kernel tier a caller
can capture one round in a CUDA graph); `mcas` is a host loop over it that
reads the loop condition `(r < max_rounds) & pending.any()` once per round
and nothing else, where the reference runs a `lax.while_loop` on the
device.  `make_txns` reads the slots back once for its duplicate check,
except under capture.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import engine, registry
from repro_torch.core.engine import IDLE, LL, SC, VALIDATE, OpBatch
from repro_torch.core.layout import (WORD_DTYPE, TableState, as_words,
                                     resolve_device)
from repro_torch.core.specs import AtomicSpec
from repro_torch.obs import telemetry as obs_telemetry
from repro_torch.sync.queue import BackoffPolicy


class TxnBatch(NamedTuple):
    """T transactions of up to W lanes each.

    slot:     int32[T, W]  claimed cell per lane; -1 = unused (txn width < W)
    expected: word[T, W, k]  per-lane comparand
    desired:  word[T, W, k]  per-lane value to install on commit
    """

    slot: torch.Tensor
    expected: torch.Tensor
    desired: torch.Tensor

    @property
    def t(self) -> int:
        return self.slot.shape[0]

    @property
    def w(self) -> int:
        return self.slot.shape[1]


class McasResult(NamedTuple):
    """Per-transaction results of one `mcas` call.

    success:  bool[T]     txn committed (all lanes written atomically)
    witness:  word[T,W,k] value of each claimed cell at the txn's
                          linearization point (failed txns: the mismatching
                          read; committed txns: the pre-write values)
    round:    int32[T]    1-based attempt round at which the txn resolved
    attempts: int32[T]    arbitration losses before resolving
    rounds:   int32[]     total rounds the batch took
    """

    success: torch.Tensor
    witness: torch.Tensor
    round: torch.Tensor
    attempts: torch.Tensor
    rounds: torch.Tensor


def make_txns(slot, expected=None, desired=None, *, k: int,
              device="cuda") -> TxnBatch:
    """THE checked transaction constructor (mirrors `engine.make_ops`).

    Checks: slot is rank-2 [T, W]; expected/desired are [T, W, k] (a
    mismatched trailing dim is the "mismatched k" error); no duplicate live
    slots within one transaction (on the host: slots given on a card are
    copied back once, except under capture).  Word payloads become int32
    word tensors on `device` with the same bits."""
    dev = resolve_device(device)
    host = engine.host_copy(slot)
    slot = engine._as_i32(slot, dev)
    if slot.dim() != 2:
        raise ValueError(f"slot must be rank-2 [T, W], got shape "
                         f"{tuple(slot.shape)}")
    t, w = slot.shape
    if t == 0 or w == 0:
        raise ValueError(f"need at least one transaction lane: "
                         f"{tuple(slot.shape)}")
    zeros = torch.zeros((t, w, k), dtype=WORD_DTYPE, device=dev)
    expected = zeros if expected is None else as_words(expected, dev)
    desired = zeros.clone() if desired is None else as_words(desired, dev)
    for name, arr in (("expected", expected), ("desired", desired)):
        if tuple(arr.shape) != (t, w, k):
            raise ValueError(f"{name} shape {tuple(arr.shape)} != ({t}, {w}, "
                             f"{k}) (mismatched k?)")
    if host is not None:
        host = host.astype(np.int64)
        for i in range(t):
            live = host[i][host[i] >= 0]
            if len(np.unique(live)) != len(live):
                raise ValueError(f"transaction {i} claims duplicate slots: "
                                 f"{sorted(live.tolist())}")
    return TxnBatch(slot, expected, desired)


def _policy_delay(policy: BackoffPolicy, attempts: torch.Tensor
                  ) -> torch.Tensor:
    """`policy.delay` on int32 tensors: exp is min(base << clip(attempts -
    1, 0, 16), cap) with the shift in int32, as the reference's."""
    if policy.kind == "none":
        return torch.zeros_like(attempts)
    if policy.kind == "const":
        return torch.full_like(attempts, policy.base)
    if policy.kind == "exp":
        e = (attempts - 1).clamp(0, 16)
        return torch.bitwise_left_shift(
            torch.full_like(attempts, policy.base), e).clamp(max=policy.cap)
    raise ValueError(f"unknown backoff kind {policy.kind!r}")


def max_rounds_bound(t: int, policy: BackoffPolicy) -> int:
    """Rounds after which every txn has provably resolved: >= 1 txn resolves
    per backoff window, and a window is at most max-delay + 1 rounds."""
    max_delay = {"none": 0, "const": policy.base, "exp": policy.cap}
    return t * (max_delay.get(policy.kind, policy.cap) + 2) + 4


class McasCarry(NamedTuple):
    """The protocol state between attempt rounds, so that `mcas_round`
    driven to drain is bit-identical to `mcas`.

    r:         int32[]     rounds run so far
    pending:   bool[T]     txns not yet resolved
    success:   bool[T]     txns committed
    witness:   word[T*W,k] flattened per-lane witness values
    round_res: int32[T]    1-based round each txn resolved in (0 = pending)
    attempts:  int32[T]    arbitration losses so far
    delay:     int32[T]    backoff rounds left before the txn re-contends
    """

    r: torch.Tensor
    pending: torch.Tensor
    success: torch.Tensor
    witness: torch.Tensor
    round_res: torch.Tensor
    attempts: torch.Tensor
    delay: torch.Tensor


def _round_step(spec: AtomicSpec, impl, round_fn, state, txns: TxnBatch,
                carry: McasCarry, policy: BackoffPolicy, telem=None):
    """ONE attempt round (LL-all / VALIDATE-all / arbitrate / SC-commit),
    the body both `mcas` and `mcas_round` run.  The three batches share
    one fresh link context; they update `state` in place.  Reads nothing
    back to the host.  `telem` (`obs.telemetry.carry_in`) counts the
    round's committed / failed / lost masks into the mcas.* counters.
    Returns (state', carry')."""
    t, w, k, n = txns.t, txns.w, spec.k, spec.n
    p = t * w
    dev = txns.slot.device
    f_slot = txns.slot.reshape(p)
    f_exp = txns.expected.reshape(p, k)
    f_des = txns.desired.reshape(p, k)
    lane_txn = torch.arange(p, device=dev) // w
    lane_used = (f_slot >= 0) & (f_slot < n)
    safe_slot = torch.where(lane_used, f_slot, 0)
    zeros = torch.zeros((p, k), dtype=WORD_DTYPE, device=dev)

    def per_txn_all(flag_lane):
        """AND a per-lane flag over each txn's USED lanes (unused: True)."""
        return (flag_lane | ~lane_used).reshape(t, w).all(1)

    def batch(lanes, kind, ctx, desired):
        ops = OpBatch(torch.where(lanes, kind, IDLE).to(torch.int32),
                      safe_slot, zeros, desired)
        return engine.run_round(impl, round_fn, state, ctx, ops, donate=True)

    r, pending, success, witness, round_res, attempts, delay = carry
    r = r + 1
    active_t = pending & (delay <= 0)

    # 1. LL-all --------------------------------------------------------------
    state, ctx, res1, _ = batch(active_t[lane_txn] & lane_used, LL,
                                engine.init_ctx(p, k, device=dev), zeros)
    vals = res1.value
    txn_match = per_txn_all((vals == f_exp).all(1))
    failed_now = active_t & ~txn_match

    # 2. VALIDATE-all --------------------------------------------------------
    ready_lane = (active_t & txn_match)[lane_txn] & lane_used
    state, ctx, res2, _ = batch(ready_lane, VALIDATE, ctx, zeros)
    ready_t = active_t & txn_match & per_txn_all(res2.success)

    # 3. arbitrate -----------------------------------------------------------
    winner_t = ready_t & engine.arbitrate_groups(
        safe_slot, lane_txn.to(torch.int32), ready_t[lane_txn] & lane_used,
        n=n, n_groups=t)

    # 4. SC-commit (one round: pure-SC fast path, disjoint cells) ------------
    state, ctx, res3, _ = batch(winner_t[lane_txn] & lane_used, SC, ctx,
                                f_des)
    committed = winner_t & per_txn_all(res3.success)

    # 5. bookkeeping ---------------------------------------------------------
    resolved = failed_now | committed
    res_lane = resolved[lane_txn] & lane_used
    witness = torch.where(res_lane[:, None], vals, witness)
    success = success | committed
    round_res = torch.where(resolved, r, round_res)
    pending = pending & ~resolved
    lost = ready_t & ~committed
    attempts = attempts + lost.to(torch.int32)
    delay = torch.where(lost, _policy_delay(policy, attempts),
                        (delay - 1).clamp(min=0))
    if telem is not None:
        obs_telemetry.count_mcas_round(telem.telem, committed, failed_now,
                                       lost)
    return state, McasCarry(r, pending, success, witness, round_res,
                            attempts, delay)


def _check_width(spec: AtomicSpec, txns: TxnBatch) -> None:
    if txns.expected.shape[2] != spec.k:
        raise ValueError(f"txn word width {txns.expected.shape[2]} != "
                         f"spec.k {spec.k}")


def _owned(state: TableState, donate: bool) -> TableState:
    return state if donate else TableState(*(x.clone() for x in state))


def mcas(spec: AtomicSpec, state, txns: TxnBatch, *,
         policy: BackoffPolicy = BackoffPolicy("none"),
         max_rounds: int | None = None, donate: bool = False):
    """Commit a batch of k-word MCAS transactions against the table.

    Runs rounds until every txn resolved or `max_rounds` (default: the
    provable bound) ran, reading the loop condition back once per round.
    Copies `state` once on entry unless `donate=True` (then the caller
    must not reuse it), as `apply` does.  Under BIGATOMIC_OBS=counters the
    rounds count into the mcas.* device counters.  Returns (state',
    McasResult); the claimed linearization order is
    `linearization_order(result)`."""
    _check_width(spec, txns)
    if max_rounds is None:
        max_rounds = max_rounds_bound(txns.t, policy)
    state = _owned(state, donate)
    impl = registry.get_strategy(spec.strategy)
    round_fn = engine.round_for(spec, impl)
    telem = obs_telemetry.carry_in(state.data.device)
    carry = mcas_begin(txns)
    go = max_rounds > 0 and txns.t > 0     # a fresh carry: all pending
    while go:
        state, carry = _round_step(spec, impl, round_fn, state, txns, carry,
                                   policy, telem)
        go = bool((carry.r < max_rounds) & carry.pending.any())  # host read
    return state, mcas_finish(txns, carry)


# ---------------------------------------------------------------------------
# Cooperative rounds: the SAME protocol advanced one round per call, so a
# scheduler can run other streams' batches between contended retries.
# ---------------------------------------------------------------------------

def mcas_begin(txns: TxnBatch) -> McasCarry:
    """The fresh carry `mcas` starts from, on the txns' device; hand it to
    `mcas_round` to run the identical protocol cooperatively."""
    t, w, k = txns.t, txns.w, txns.expected.shape[2]
    dev = txns.slot.device

    def zeros(shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return McasCarry(zeros(()), torch.ones((t,), dtype=torch.bool,
                                           device=dev),
                     zeros((t,), torch.bool), zeros((t * w, k), WORD_DTYPE),
                     zeros((t,)), zeros((t,)), zeros((t,)))


def mcas_round(spec: AtomicSpec, state, txns: TxnBatch, carry: McasCarry, *,
               policy: BackoffPolicy = BackoffPolicy("none"),
               donate: bool = False):
    """Advance the MCAS protocol by ONE attempt round (LL-all /
    VALIDATE-all / arbitrate / SC-commit) and return (state', carry').

    Reads nothing back to the host: on the kernel tier, with
    `donate=True`, a round can be captured in a CUDA graph.  Links never
    span rounds (each round builds and consumes its own ctx), so a caller
    may interleave foreign batches against `state` between rounds: pending
    txns re-read on their next attempt.  Driving this to
    `not carry.pending.any()` gives bit-identical results to `mcas` with
    the same policy; `mcas_finish` packages them.  `state` is copied first
    unless `donate=True`."""
    _check_width(spec, txns)
    state = _owned(state, donate)
    impl = registry.get_strategy(spec.strategy)
    return _round_step(spec, impl, engine.round_for(spec, impl), state, txns,
                       carry, policy,
                       obs_telemetry.carry_in(state.data.device))


def mcas_finish(txns: TxnBatch, carry: McasCarry) -> McasResult:
    """Package a drained cooperative run as the standard `McasResult`."""
    t, w, k = txns.t, txns.w, txns.expected.shape[2]
    return McasResult(carry.success, carry.witness.reshape(t, w, k),
                      carry.round_res, carry.attempts, carry.r)


# ---------------------------------------------------------------------------
# The claimed order + the sequential replay that defines the semantics.
# ---------------------------------------------------------------------------

def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _host_words(x) -> np.ndarray:
    """Words as numpy uint32 (int32 word tensors or arrays keep their
    bits)."""
    x = _host(x)
    if x.dtype == np.int32:
        return x.view(np.uint32)
    return x if x.dtype == np.uint32 else \
        (x.astype(np.int64) & 0xFFFFFFFF).astype(np.uint32)


def linearization_order(result: McasResult) -> np.ndarray:
    """Txn ids in the claimed linearization: round-major, failures before
    commits within a round (failures witness the pre-commit values), txn id
    within each class.  Txns that never resolved (round == 0, possible only
    under a caller-supplied `max_rounds` below the provable bound) never
    executed and are excluded."""
    rnd = _host(result.round)
    suc = _host(result.success).astype(np.int64)
    ids = np.arange(rnd.shape[0])
    order = ids[np.lexsort((ids, suc, rnd))]
    return order[rnd[order] > 0]


def mcas_reference(data: np.ndarray, version: np.ndarray, txns: TxnBatch,
                   order) -> tuple:
    """Replay whole transactions one at a time in `order`.  Pure numpy
    (words as uint32; `txns` may hold tensors).

    Returns (data', version', success[T], witness[T, W, k])."""
    data = np.array(_host_words(data), copy=True)
    version = np.array(_host_words(version), copy=True)
    slot = _host(txns.slot)
    expected = _host_words(txns.expected)
    desired = _host_words(txns.desired)
    t, w, k = expected.shape
    success = np.zeros((t,), bool)
    witness = np.zeros((t, w, k), data.dtype)
    for i in np.asarray(order, np.int64):
        used = [j for j in range(w)
                if 0 <= slot[i, j] < data.shape[0]]
        ok = True
        for j in used:
            witness[i, j] = data[slot[i, j]]
            if not np.array_equal(data[slot[i, j]], expected[i, j]):
                ok = False
        if ok:
            for j in used:
                data[slot[i, j]] = desired[i, j]
                version[slot[i, j]] += 2
            success[i] = True
    return data, version, success, witness
