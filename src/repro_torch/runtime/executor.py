"""The oversubscribed multi-stream executor, on one device or sharded.

Big atomics pay off when MORE logical workers than hardware slots keep the
engine's fast path saturated while stalled streams wait out contention.
This module is that regime as a scheduler:

  streams      S logical op streams (`runtime.streams`) share ONE
               big-atomic target.  Each scheduling round visits every live
               stream and issues at most one batch.
  in-flight    every issued round is queued on the card's one stream and
               not waited for: the executor holds up to `slots *
               oversubscription` un-retired rounds, so stream i+1's host
               work overlaps stream i's device round.  An issue uploads its
               host ops through pinned buffers without blocking and queues
               copies of its results into pinned buffers behind the round,
               with an event after them (`engine.apply_round`);
               retiring a round waits for that event only, never for rounds
               issued after it.  Donation updates the table in place, so the
               window holds no copies of it.
  targets      `LocalTarget` wraps one table on one device
               (`engine.apply_round`).  `DistTarget` wraps a table sharded
               over a `core.distributed` mesh in the single-controller
               form: every rank of the mesh runs the same `Executor` over
               the same streams and passes each global batch; the rank runs
               its own lanes and gets every lane's result back
               (`distributed.apply_global`), so every rank journals the
               whole batch.  With `n_nodes > 1` the round routes
               hierarchically.
  lockstep     with a `DistTarget` every rank must take the same host
               branch, or the next collectives pair up wrong.  Once a round
               the ranks agree on the watchdog's latency vector and on the
               preemption flag (one `all_reduce(MAX)` over the mesh); an
               issue whose host preparation raises on any rank raises on
               every rank (one more `all_reduce` an issue) and is rolled
               back alike; an error inside the collectives ends every rank.
               A disk checkpoint is written by the mesh's first rank while
               the others wait for it.
  faults       `runtime.faults.FaultInjector` injects delay / preempt /
               shard-loss at exact (round, issue) points and data-plane
               faults at drained round boundaries.  Delays surface through
               the StragglerWatchdog (flagged streams skip their next issue
               slot); preemption drains, checkpoints and stops cleanly;
               shard loss discards in-flight rounds, restores the last
               round-boundary checkpoint, reshards onto the survivors
               (`elastic.reshard_dist`: versions kept, so LL links survive)
               and replays the issue journal with the NEW geometry's
               claimed orders.  Against a `LocalTarget` a shard loss
               raises: there is nothing to reshard onto.
  history      every ops issue is journaled (stream, seq, ops, claimed
               order, delivered results); `runtime.replay.replay_history`
               replays the whole multi-stream interleaving, across a
               recovery too, through one sequential numpy oracle.

Nothing here blocks except retirement past the in-flight budget and the
explicit drains at checkpoint, scrub and recovery boundaries.  Checkpoints
kept in memory stay on the table's device; a disk checkpoint holds the
words as uint32, the bytes the reference's executor writes.
"""

from __future__ import annotations

import dataclasses
import os
import time
from collections import deque

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core import distributed as dsb
from repro_torch.core import engine
from repro_torch.core.layout import as_words, resolve_device
from repro_torch.obs.recorder import Recorder


def _ops_np(ops: engine.OpBatch) -> engine.OpBatch:
    """Numpy copies of a host op batch, words as uint32."""
    return engine.OpBatch(np.array(ops.kind, np.int32),
                          np.array(ops.slot, np.int32),
                          np.array(ops.expected).astype(np.uint32),
                          np.array(ops.desired).astype(np.uint32))


def _host_payload(payload: dict) -> dict:
    """An in-memory checkpoint (tensors) as the numpy arrays a disk
    checkpoint holds, words as uint32."""
    return {"table": {name: convert.array(x, word=True)
                      for name, x in payload["table"].items()},
            "ctx": {key: dict(zip(engine.LinkCtx._fields, convert.to_numpy(
                engine.LinkCtx(**c)))) for key, c in payload["ctx"].items()}}


# ---------------------------------------------------------------------------
# Targets: the shared big-atomic structure the streams contend on.
# ---------------------------------------------------------------------------

class LocalTarget:
    """Single-device table; `issue` updates it in place.

    Snapshots are `{"logical", "versions"}` dicts of word tensors on the
    table's device (the plane the integrity scrub checkpoints and
    repairs); `load` takes those or the reference's numpy uint32."""

    kind = "local"

    def __init__(self, spec, initial=None, *, device="cuda"):
        self.spec = spec
        self.device = resolve_device(device)
        self.state = engine.init(spec, initial, device=self.device)

    @property
    def width(self) -> int:
        return self.spec.n          # no lane cap beyond table size

    @property
    def n_shards(self) -> int:
        return 1

    def issue(self, ops, ctx, *, donate=True):
        """One round of host (numpy) `ops`; returns an `engine.RoundHandle`
        whose results come back by `host_result()` after `wait()`."""
        h = engine.apply_round(self.spec, self.state, ops, ctx,
                               donate=donate)
        self.state = h.state
        return h

    def snapshot(self) -> dict:
        """A copy of the logical plane and the versions (word tensors)."""
        return {"logical": engine.logical(self.spec, self.state).clone(),
                "versions": self.state.version.clone()}

    def load(self, snap: dict) -> None:
        """Rebuild the layout from a snapshot (numpy uint32 or word
        tensors); the snapshot's buffers are copied, never aliased."""
        logical = as_words(snap["logical"], self.device).clone()
        versions = as_words(snap["versions"], self.device).clone()
        self.state = engine.init(self.spec, logical, device=self.device
                                 )._replace(version=versions)

    def shrink(self, n_surviving: int):
        raise RuntimeError("shard loss against a LocalTarget is fatal: "
                           "nothing to reshard onto")


class IssueFailed(RuntimeError):
    """An issue whose host preparation raised on some rank of a
    `DistTarget`'s mesh: every rank raises it, before any collective of
    the round, so every rank rolls the same batch back."""


class DistTarget:
    """Mesh-sharded table in the single-controller form.

    Every rank of `mesh` builds the same target and runs the same
    `Executor` over the same streams: each issue is a GLOBAL batch of up
    to `p_global` host lanes, passed alike by every rank.  The rank runs
    its own `p_local` lanes through `distributed.apply_global`, which
    all-gathers every lane's value, success, overflow and link, so every
    rank's journal holds the whole batch.  The claimed order is
    `linearization_order(dspec, ops)` on the host batch (no gather).
    `snapshot()` is the gathered global `{"logical", "versions"}`; `load`
    rebuilds each rank's shard with `init_dist` and splices its row of the
    versions back.  `shrink(n)` calls `mesh_factory(n)` (which builds the
    survivors' mesh: `make_mesh` is collective, so every rank shrinks at
    the same point) and then `elastic.reshard_dist`, keeping values,
    versions and `p_global`."""

    kind = "dist"

    def __init__(self, mesh, dspec, initial=None, *, mesh_factory=None):
        self.mesh, self.dspec = mesh, dspec
        self.device = mesh.device
        self.state = dsb.init_dist(mesh, dspec, initial)
        # n_surviving -> (mesh, dspec): how to rebuild after shard loss
        self.mesh_factory = mesh_factory

    @property
    def width(self) -> int:
        return self.dspec.p_global

    @property
    def n_shards(self) -> int:
        return self.dspec.n_shards

    def _prepare(self, ops):
        """Host work that may raise: kinds and width checked, the lanes
        IDLE-padded to p_global, the claimed order, the upload."""
        engine.check_kinds(ops.kind, engine.TABLE_KINDS, "table")
        p = self.dspec.p_global
        q = np.asarray(ops.kind).shape[0]
        if q > p:
            raise ValueError(f"batch width {q} > p_global {p}")
        host = _ops_np(ops)
        if q < p:
            pad = p - q
            k = host.desired.shape[1]
            host = engine.OpBatch(
                np.concatenate([host.kind, np.full(pad, engine.IDLE,
                                                   np.int32)]),
                np.concatenate([host.slot, np.zeros(pad, np.int32)]),
                np.concatenate([host.expected, np.zeros((pad, k),
                                                        np.uint32)]),
                np.concatenate([host.desired, np.zeros((pad, k),
                                                       np.uint32)]))
        order, _ = dsb.linearization_order(self.dspec, host)
        dev_ops, staged = engine.upload_ops(host, self.device)
        return q, order, dev_ops, staged

    def issue(self, ops, ctx, *, donate=True):
        """One round of host (numpy) `ops`, the global batch; returns a
        `DistIssue` whose results come back by `host_result()` after
        `wait()`.  Raises `IssueFailed` on every rank when the host
        preparation raised on any."""
        err = None
        try:
            q, order, dev_ops, staged = self._prepare(ops)
        except Exception as e:                  # agreed below, then raised
            err = e
        if dsb.agree_max(self.mesh, [err is not None])[0]:
            raise IssueFailed("an issue's host preparation raised on a rank "
                              "of the mesh") from err
        p, k = self.dspec.p_global, self.dspec.inner.k
        ctx = engine.canonicalize_ctx(ctx, self.device)
        if ctx.slot.shape[0] < p:
            blank = engine.init_ctx(p - ctx.slot.shape[0], k,
                                    device=self.device)
            ctx = engine.LinkCtx(*(torch.cat([a, b])
                                   for a, b in zip(ctx, blank)))
        self.state, nctx, res, ovf = dsb.apply_global(
            self.mesh, self.dspec, self.state, dev_ops, ctx, donate=donate)
        if q < p:
            nctx = engine.LinkCtx(*(x[:q] for x in nctx))
        return DistIssue(self.state, nctx, res.value[:q], res.success[:q],
                         ovf[:q], order, staged)

    def snapshot(self) -> dict:
        """The gathered global logical plane and versions (word tensors on
        the mesh's device, on every rank)."""
        return {"logical": dsb.logical(self.dspec, self.state),
                "versions": dsb.versions(self.dspec, self.state)}

    def load(self, snap: dict) -> None:
        """Rebuild this rank's shard from a global snapshot (numpy uint32
        or word tensors) with its row of the versions spliced back: LL
        links restored alongside MUST see their pre-checkpoint versions."""
        logical = as_words(snap["logical"], self.device)
        st = dsb.init_dist(self.mesh, self.dspec, logical)
        row = _split_versions(self.dspec, snap["versions"], self.device)[
            dsb.shard_index(self.mesh, self.dspec)]
        self.state = dsb.DistState(st.local._replace(version=row.clone()),
                                   self.mesh)

    def shrink(self, n_surviving: int) -> None:
        if self.mesh_factory is None:
            raise RuntimeError("shard loss needs mesh_factory= to rebuild "
                               "the mesh on the survivors")
        from repro_torch.runtime.elastic import reshard_dist
        mesh, dspec = self.mesh_factory(n_surviving)
        if dspec.p_global != self.dspec.p_global:
            raise ValueError(f"mesh_factory({n_surviving}) changes p_global "
                             f"{self.dspec.p_global} -> {dspec.p_global}: "
                             "the streams' lanes and links would not fit")
        self.state = reshard_dist(self.dspec, self.state, dspec, mesh)
        self.mesh, self.dspec, self.device = mesh, dspec, mesh.device
        if not mesh.member:
            raise RuntimeError("this rank holds no shard of the survivors' "
                               "mesh: it leaves the run")


class DistIssue:
    """An issued sharded round: the rank's new shard, every lane's link
    context and the claimed order; the gathered value, success and
    overflow are copied to pinned host buffers behind the round with an
    event after them (on the CPU they are the results themselves)."""

    __slots__ = ("state", "ctx", "order", "_host", "_event", "_staged")

    def __init__(self, state, ctx, value, success, overflow, order,
                 staged=()):
        self.state, self.ctx, self.order = state, ctx, order
        self._staged = staged
        self._host = (value, success, overflow)
        self._event = None
        if value.is_cuda:
            self._host = tuple(
                torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                .copy_(x, non_blocking=True) for x in self._host)
            self._event = torch.cuda.Event()
            self._event.record()

    def wait(self) -> "DistIssue":
        if self._event is not None:
            self._event.synchronize()
        return self

    def host_result(self) -> tuple[np.ndarray, np.ndarray]:
        """(value uint32[q, k], success bool[q]) as numpy copies; call
        after `wait()`."""
        value, success = (x.numpy() for x in self._host[:2])
        return value.view(np.uint32).copy(), success.copy()

    @property
    def overflow(self) -> np.ndarray:
        """The route-capacity overflow mask (bool[q]); after `wait()`."""
        return self._host[2].numpy().copy()


def _split_versions(dspec, vers, device):
    """The global version vector as [n_shards, n_local] word rows, row i
    the shard i holds (the inverse of `distributed.versions`)."""
    vers = as_words(vers, device)
    s, nl = dspec.n_shards, dspec.n_local
    return vers.reshape(nl, s).T.contiguous() if dspec.interleave \
        else vers.reshape(s, nl)


# ---------------------------------------------------------------------------
# The issue journal.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class IssueRec:
    """One issued ops batch: everything a sequential replay needs, filled
    in two phases (ops and order at issue, results at retire)."""

    stream: int
    seq: int
    ops: engine.OpBatch                    # numpy copies, words uint32
    order: np.ndarray | None = None        # claimed order (None = lane order)
    overflow: np.ndarray | None = None
    value: np.ndarray | None = None
    success: np.ndarray | None = None


@dataclasses.dataclass
class Recovery:
    round: int
    shard: int
    n_shards: int          # surviving shard count
    replayed: int          # journaled batches re-issued
    latency_s: float


@dataclasses.dataclass
class StreamShed:
    """A stream dropped after exhausting its retry budget (graceful
    degradation: the run continues without it)."""
    stream: int
    round: int
    reason: str
    attempts: int


# ---------------------------------------------------------------------------
# The executor.
# ---------------------------------------------------------------------------

class Executor:
    """Schedule S streams against one target with more in-flight rounds
    than compute slots.

    target:           `LocalTarget` / `DistTarget` (None for pure
                      kind="host" stream sets, e.g. serving).  With a
                      `DistTarget` every rank of its mesh builds the same
                      executor over the same streams (see `lockstep`).
    streams:          `runtime.streams` objects (kinds "ops", "round",
                      "host" mix freely; "round" needs a LocalTarget).
    slots:            modeled compute slots per device.
    oversubscription: in-flight budget = slots * oversubscription.
    watchdog:         `StragglerWatchdog(n_hosts=len(streams))`, fed the
                      per-stream issue latencies the Recorder keeps;
                      flagged streams are deprioritized (skip their next
                      slot).
    recorder:         `obs.Recorder` sink for round/issue/lifecycle events
                      (a fresh one is built if omitted); its clock is
                      injectable.
    guard:            `PreemptionGuard` (or compatible) polled at round
                      boundaries; `request_stop()` drains + checkpoints.
                      With a `DistTarget` the ranks agree on the flag once
                      a round, so a real signal stops a sharded run at the
                      next round boundary, not mid-round (an injected
                      preempt fault fires at the same point on every rank
                      and stops it there).
    injector:         `faults.FaultInjector`, polled before every issue
                      (scheduling faults) and at drained round boundaries
                      (data-plane faults, `poll_boundary`).
    checkpoint_dir /  atomic disk checkpoints (`checkpoint.disk`) every N
    checkpoint_every  rounds at a drained round boundary; an in-memory copy
                      on the table's device is always kept (it backs
                      shard-loss recovery).  With a `DistTarget` the mesh's
                      first rank writes and the others wait for it; the
                      directory must be one every rank reads.
    retry_budget /    graceful degradation: a stream whose issue raises or
    backoff           whose every lane targets quarantined cells counts a
                      failed attempt, waits out `backoff.delay(attempts)`
                      rounds (`sync.queue.BackoffPolicy`), and is SHED with
                      a recorded reason once attempts exceed the budget.
    scrub_every       with BIGATOMIC_GUARD=on, run the integrity scrub
                      (`guard.scrub`) every N drained round boundaries;
                      repairs from the last checkpoint, quarantines what it
                      can't.  Guard off: no scrubber exists and the issue
                      path runs exactly what it runs without the guard.
    """

    def __init__(self, target, streams, *, slots: int = 2,
                 oversubscription: int = 2, watchdog=None, guard=None,
                 injector=None, checkpoint_dir: str | None = None,
                 checkpoint_every: int = 0, donate: bool = True,
                 recorder: Recorder | None = None, retry_budget: int = 3,
                 backoff=None, scrub_every: int = 1):
        self.target = target
        self.streams = list(streams)
        self.slots = slots
        self.oversubscription = oversubscription
        self.budget = max(1, slots * oversubscription)
        self.watchdog = watchdog
        self.guard = guard
        self.injector = injector
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.donate = donate
        self.recorder = recorder if recorder is not None else Recorder()

        self._inflight: deque = deque()
        # a sharded target: every rank takes the same host branch
        self._lockstep = target is not None and target.kind == "dist"
        self._stop = False                       # agreed / injected stop
        device = getattr(target, "device", "cpu")
        self._ctx = {i: engine.init_ctx(s.width, self._k(), device=device)
                     for i, s in enumerate(self.streams)
                     if s.kind == "ops"}
        self._seq = {i: 0 for i in range(len(self.streams))}
        self._round = 0
        self._skip: set[int] = set()
        self._delays: dict[int, list] = {}      # si -> [seconds, rounds left]
        self._last_ck = None                     # (payload, meta, hist_len)
        self.history: list[IssueRec] = []
        self.recoveries: list[Recovery] = []
        self.checkpoints: list[int] = []
        self.issues = 0
        self.deprioritized = 0
        self.stopped = False

        self.retry_budget = retry_budget
        if backoff is None:
            from repro_torch.sync.queue import BackoffPolicy
            backoff = BackoffPolicy("exp", base=1, cap=8)
        self.backoff = backoff
        self.scrub_every = scrub_every
        self.shed: list[StreamShed] = []
        self._shed_set: set[int] = set()
        self._attempts: dict[int, int] = {}
        self._cooldown: dict[int, int] = {}      # si -> rounds to sit out
        self.data_faults: list = []              # (round, Fault, info)
        self.scrubber = None
        if target is not None:
            from repro_torch import guard as _guard
            if _guard.enabled():
                self.scrubber = _guard.Scrubber(
                    self._table_spec(), n=self._n_cells(),
                    device=target.device)

    def _table_spec(self):
        """The table's `AtomicSpec` (a sharded target's inner spec)."""
        return self.target.spec if self.target.kind == "local" \
            else self.target.dspec.inner

    def _n_cells(self) -> int:
        if self.target.kind == "local":
            return self.target.spec.n
        d = self.target.dspec
        return d.n_shards * d.n_local

    def _k(self) -> int:
        return 1 if self.target is None else self._table_spec().k

    def _should_stop(self) -> bool:
        """Stop at the next check?  With a `DistTarget` only the agreed or
        injected stop counts (the same on every rank); else the guard."""
        if self._lockstep:
            return self._stop
        return self.guard is not None and self.guard.should_stop

    # -- issue / retire ------------------------------------------------------

    def _retire_one(self) -> None:
        rec, h, stream, tok = self._inflight.popleft()
        if hasattr(h, "finish"):                 # host-stream token
            h.finish()
            self.recorder.end_issue(tok)
            return
        h.wait()                                 # this round's event only
        if rec is None:                          # "round" stream step
            self.recorder.end_issue(tok)
            return
        rec.value, rec.success = h.host_result()
        ovf = getattr(h, "overflow", None)
        rec.overflow = None if ovf is None else np.asarray(ovf)
        if self.scrubber is not None:
            self.scrubber.note_results(rec.ops, rec.success)
        self.recorder.end_issue(tok, args={"seq": rec.seq})
        stream.deliver(rec.seq, rec.value, rec.success, rec.overflow)

    def _drain(self) -> None:
        while self._inflight:
            self._retire_one()

    def _trim(self) -> None:
        while len(self._inflight) > self.budget:
            self._retire_one()

    def _issue(self, si: int, stream) -> bool:
        name = getattr(stream, "name", None) or f"s{si}"
        if stream.kind == "ops":
            ops = stream.next_batch()
            if ops is None:
                return False
            poisoned = None
            if self.scrubber is not None:
                # quarantined cells: lanes rewritten to IDLE on the host
                # before the upload, so they report success=False; the
                # MASKED ops are journaled, keeping the replay in agreement
                ops, poisoned = self.scrubber.mask_ops(ops)
            seq = self._seq[si]
            self._seq[si] += 1
            span = self.recorder.begin_issue(si, name)
            try:
                h = self.target.issue(ops, self._ctx[si], donate=self.donate)
            except Exception as err:
                # roll the stream back so the SAME batch retries after the
                # backoff window; non-seekable streams can't retry.  A
                # sharded issue rolls back only when every rank raised
                # alike (`IssueFailed`); an error inside its collectives
                # ends the run on every rank.
                if self._lockstep and not isinstance(err, IssueFailed):
                    raise
                self.recorder.cancel_issue(span)
                self._seq[si] = seq
                if not hasattr(stream, "seek"):
                    raise
                stream.seek(seq)
                self._note_failure(si, "issue raised")
                return False
            self._ctx[si] = h.ctx
            rec = IssueRec(si, seq, _ops_np(ops),
                           order=getattr(h, "order", None))
            self.history.append(rec)
            self._inflight.append((rec, h, stream, span))
            if poisoned is not None and \
                    not (rec.ops.kind != engine.IDLE).any():
                self._note_failure(si, "all lanes target quarantined cells")
            elif si in self._attempts:
                del self._attempts[si]          # progress resets the budget
        elif stream.kind == "round":
            if self.target.kind != "local":
                raise RuntimeError("round streams (MCAS) drive a "
                                   "LocalTarget")
            if stream.done():
                return False
            span = self.recorder.begin_issue(si, name)
            self.target.state = stream.step(self.target.spec,
                                            self.target.state)
            if self.scrubber is not None:
                # round streams mutate state outside the journal: the
                # scrubber can't attribute writes per slot, so the whole
                # table goes dirty (quarantine-only until next checkpoint)
                self.scrubber.note_untracked()
            self._inflight.append((None, _CarryHandle(self.target.device),
                                   None, span))
        elif stream.kind == "host":
            span = self.recorder.begin_issue(si, name)
            tok = stream.issue()
            if tok is None:
                self.recorder.cancel_issue(span)
                return False
            self._inflight.append((None, tok, None, span))
        else:
            raise ValueError(f"unknown stream kind {stream.kind!r}")
        self.issues += 1
        self._trim()
        return True

    # -- faults --------------------------------------------------------------

    def _poll_faults(self, issues_in_round: int) -> None:
        if self.injector is None:
            return
        for f in self.injector.poll(self._round, issues_in_round):
            if f.kind == "delay":
                self._delays[f.stream] = [f.seconds, f.rounds]
            elif f.kind == "preempt":
                if self.guard is None:
                    from repro_torch.runtime.preemption import \
                        PreemptionGuard
                    self.guard = PreemptionGuard()
                self.guard.request_stop()
                self._stop = True                # fires on every rank alike
            elif f.kind == "shard_loss":
                self._recover(f.shard)

    def _extra_delay(self, si: int) -> float:
        d = self._delays.get(si)
        return d[0] if d and d[1] > 0 else 0.0

    def _note_failure(self, si: int, reason: str) -> None:
        a = self._attempts.get(si, 0) + 1
        self._attempts[si] = a
        if a > self.retry_budget:
            self.shed.append(StreamShed(stream=si, round=self._round,
                                        reason=reason, attempts=a))
            self._shed_set.add(si)
            self._cooldown.pop(si, None)
            self.recorder.shed(self._round, si, reason)
        else:
            self._cooldown[si] = int(self.backoff.delay(a))

    def _guard_boundary(self) -> None:
        """Drained-round-boundary work: apply due data-plane faults, then
        scrub.  The baseline digest is taken AFTER the drain but BEFORE
        injection, so every boundary-injected bit flip / torn write is a
        guaranteed digest mismatch (see guard/scrub.py)."""
        if self.target is None:
            return
        due = self.injector.poll_boundary(self._round) \
            if self.injector is not None else []
        scrub_due = self.scrubber is not None and self.scrub_every \
            and self._round % self.scrub_every == 0
        if not due and not scrub_due:
            return
        self._drain()
        baseline = self.scrubber.digest_of(self.target) \
            if self.scrubber is not None else None
        for f, rng in due:
            self._apply_data_fault(f, rng)
        if self.scrubber is not None:
            rep = self.scrubber.scrub(self.target, round_idx=self._round,
                                      baseline=baseline)
            self.recorder.scrub(self._round, rep)

    def _apply_data_fault(self, f, rng) -> None:
        from repro_torch.guard.inject import (inject_snapshot_fault,
                                              inject_table_fault)
        if f.kind in ("bit_flip", "torn_write"):
            if self.target.kind == "local":
                self.target.state, info = inject_table_fault(
                    self.target.spec, self.target.state, f, rng)
            else:
                snap, info = inject_snapshot_fault(self.target.snapshot(),
                                                   f, rng)
                self.target.load(snap)
        elif f.kind == "stale_resurrect":
            if self._last_ck is None:
                return
            payload, meta, _ = self._last_ck
            self.target.load(payload["table"])
            info = {"kind": f.kind, "from_round": meta["round"]}
        elif f.kind in ("ckpt_corrupt", "ckpt_truncate"):
            info = self._damage_checkpoint(f, rng)
            if info is None:
                return                           # no disk checkpoint to hit
        else:
            raise ValueError(f"unknown data fault {f.kind!r}")
        self.data_faults.append((self._round, f, info))
        self.recorder.data_fault(self._round, f.kind, info)

    def _damage_checkpoint(self, f, rng):
        """Hit the newest disk checkpoint once.  With a `DistTarget` every
        rank draws the same victim, offset and bit (the fault's own rng)
        and records the same info, the writer alone damages the file, and
        the ranks meet before and after: the same seeded flip applied by
        every rank would undo itself."""
        from repro_torch.checkpoint.disk import list_steps
        if not self.checkpoint_dir:
            return None
        steps = list_steps(self.checkpoint_dir)
        if not steps:
            return None
        step = steps[-1]
        path = os.path.join(self.checkpoint_dir, f"step_{step:08d}")
        leaves = sorted(fn for fn in os.listdir(path)
                        if fn.endswith(".npy"))
        if not leaves:
            return None
        victim = os.path.join(path, leaves[int(rng.integers(len(leaves)))])
        size = os.path.getsize(victim)
        info = {"kind": f.kind, "step": step,
                "leaf": os.path.basename(victim)}
        if f.kind == "ckpt_corrupt":
            off = int(rng.integers(size))
            bit = int(rng.integers(8))
            info["offset"] = off
        self._meet()                             # every rank has drawn
        if self._writer():
            with open(victim, "r+b") as fh:
                if f.kind == "ckpt_truncate":
                    fh.truncate(size // 2)
                else:
                    fh.seek(off)
                    byte = fh.read(1)[0]
                    fh.seek(off)
                    fh.write(bytes([byte ^ (1 << bit)]))
        self._meet()
        return info

    def _writer(self) -> bool:
        """Does this process write the disk checkpoints?  (A sharded run's
        mesh's first rank; every process otherwise.)"""
        if not self._lockstep:
            return True
        import torch.distributed as tdist
        return tdist.get_rank() == self.target.mesh.ranks[0]

    def _meet(self, failed: bool = False) -> bool:
        """With a `DistTarget`: wait for every rank of the mesh and return
        whether any of them `failed` (one `all_reduce(MAX)`); else
        `failed`."""
        if not self._lockstep:
            return failed
        return bool(dsb.agree_max(self.target.mesh, [failed])[0])

    # -- checkpoint / recovery ----------------------------------------------

    def _ck_state(self) -> dict:
        """The recovery point on the table's device (copies; no host
        read): the table snapshot and every ops stream's link context."""
        return {"table": self.target.snapshot(),
                "ctx": {str(si): {name: x.clone() for name, x in
                                  ctx._asdict().items()}
                        for si, ctx in self._ctx.items()}}

    def _ck_template(self) -> dict:
        """The shapes and dtypes of a disk checkpoint's arrays (words as
        uint32), uninitialised: the template a restore fills."""
        n, k = self._n_cells(), self._table_spec().k

        def word(shape):
            return np.empty(tuple(shape), np.uint32)

        return {"table": {"logical": word((n, k)),
                          "versions": word((n,))},
                "ctx": {str(si): {"slot": np.empty(tuple(c.slot.shape),
                                                   np.int32),
                                  "version": word(c.version.shape),
                                  "value": word(c.value.shape),
                                  "linked": np.empty(tuple(c.linked.shape),
                                                     bool)}
                        for si, c in self._ctx.items()}}

    def checkpoint(self) -> None:
        """Drain and snapshot at a round boundary: the in-memory recovery
        point (on the device) and, with `checkpoint_dir`, a disk
        checkpoint for a preemption resume (with a `DistTarget`: written
        by the mesh's first rank, every rank waiting for it, and a failed
        write raising on every rank)."""
        self._drain()
        payload = self._ck_state()
        meta = {"round": self._round,
                "seq": {str(si): int(q) for si, q in self._seq.items()},
                "n_shards": self.target.n_shards}
        self._last_ck = (payload, meta, len(self.history))
        if self.scrubber is not None:
            self.scrubber.set_checkpoint(payload["table"])
        if self.checkpoint_dir:
            from repro_torch.checkpoint.disk import save_checkpoint
            err = None
            if self._writer():
                try:
                    save_checkpoint(self.checkpoint_dir, self._round,
                                    _host_payload(payload), meta=meta)
                except Exception as e:          # agreed below, then raised
                    err = e
            if self._meet(err is not None):
                raise RuntimeError("the disk checkpoint of round "
                                   f"{self._round} failed") from err
        self.checkpoints.append(self._round)
        self.recorder.checkpoint(self._round)

    def _load_ck(self, payload: dict, meta: dict, hist_len: int) -> list:
        """Common restore: state, ctxs, seqs, stream cursors.  Returns the
        journal suffix, the (stream, seq) pairs issued after the
        checkpoint, which the journal loses.  Link contexts go to the
        device here, at the drained boundary."""
        journal = [(r.stream, r.seq) for r in self.history[hist_len:]]
        del self.history[hist_len:]
        self.target.load(payload["table"])
        for key, c in payload["ctx"].items():
            self._ctx[int(key)] = engine.canonicalize_ctx(
                engine.LinkCtx(**dict(c)), self.target.device)
        for key, q in meta["seq"].items():
            si = int(key)
            self._seq[si] = int(q)
            if hasattr(self.streams[si], "seek"):   # ops streams only
                self.streams[si].seek(int(q))
        return journal

    def _recover(self, shard: int) -> None:
        """Shard-loss recovery: discard in-flight, restore the last
        checkpoint, reshard onto the survivors (`target.shrink`: a
        `LocalTarget` raises, having nothing to reshard onto), replay the
        journal in its recorded interleaving (deliveries are idempotent by
        seq: results issued after the checkpoint were provisional), drain,
        and checkpoint the post-recovery state."""
        if self._last_ck is None:
            raise RuntimeError("shard loss before the first checkpoint")
        t0 = time.perf_counter()
        self._inflight.clear()                  # results may span the loss
        payload, meta, hist_len = self._last_ck
        journal = self._load_ck(payload, meta, hist_len)
        self.target.shrink(self.target.n_shards - 1)
        for si, seq in journal:
            assert self._seq[si] == seq, (si, self._seq[si], seq)
            self._issue(si, self.streams[si])
        self._drain()
        # the post-recovery state is the new baseline
        self.checkpoint()
        rec = Recovery(self._round, shard, self.target.n_shards,
                       len(journal), time.perf_counter() - t0)
        self.recoveries.append(rec)
        self.recorder.recovery(rec.round, shard, rec.replayed, rec.latency_s)

    def resume(self, checkpoint_dir: str | None = None) -> int:
        """Resume from the newest VERIFYING disk checkpoint (preemption
        restart): restores table state + link ctxs + stream cursors;
        `run()` then continues bit-identically with the pre-preemption
        schedule.  A corrupt or truncated newest step is skipped
        (`checkpoint.disk.restore_latest`).  With a `DistTarget` every
        rank of the mesh reads the same directory."""
        from repro_torch.checkpoint import disk
        ckdir = checkpoint_dir or self.checkpoint_dir
        payload, meta, _step = disk.restore_latest(ckdir, self._ck_template())
        self._load_ck(payload, meta, len(self.history))
        self._round = int(meta["round"])
        self._last_ck = (payload, meta, len(self.history))
        if self.scrubber is not None:
            self.scrubber.set_checkpoint(payload["table"])
        return self._round

    # -- the scheduling loop -------------------------------------------------

    def _live_streams(self):
        return [s for si, s in enumerate(self.streams)
                if si not in self._shed_set]

    def done(self) -> bool:
        return all(s.done() for s in self._live_streams()) \
            and not self._inflight

    def _run_round(self) -> None:
        self._round += 1
        rcd = self.recorder
        rcd.round_begin(self._round)
        issued = 0
        for si, stream in enumerate(self.streams):
            self._poll_faults(issued)
            if self._should_stop():
                return
            if si in self._shed_set or stream.done():
                continue
            cd = self._cooldown.get(si, 0)
            if cd > 0:
                self._cooldown[si] = cd - 1     # backoff: sit out the round
                continue
            if si in self._skip:
                self._skip.discard(si)          # deprioritized: skip ONE slot
                continue
            t0 = rcd.clock()            # injectable (obs.Recorder(clock=))
            if self._issue(si, stream):
                issued += 1
                rcd.issue_latency(si, rcd.clock() - t0
                                  + self._extra_delay(si))
        if not issued and self._inflight:
            # nothing issuable until in-flight work retires (e.g. a decode
            # whose successor needs its tokens): guarantee progress
            self._retire_one()
        self._poll_faults(issued)
        for d in self._delays.values():
            d[1] -= 1
        rcd.round_end(self._round)
        lat = rcd.latency_vector(len(self.streams)) \
            if self.watchdog is not None and rcd.round_issued() else []
        if self._lockstep:
            # the round's one agreement: the latencies each rank measured
            # (the watchdog then flags the same streams everywhere) and a
            # stop requested on any rank (a signal is per process)
            signalled = self.guard is not None and self.guard.should_stop
            *lat, stop = dsb.agree_max(self.target.mesh,
                                       lat + [signalled])
            if stop:
                self._stop = True
                if self.guard is not None:
                    self.guard.request_stop()
        if lat:
            plan = self.watchdog.observe(lat)
            if plan.flagged:
                rcd.straggler_flags(self._round, plan.flagged)
                self._skip |= set(plan.flagged)
                self.deprioritized += len(plan.flagged)

    def run(self, max_rounds: int = 10_000):
        """Drive every stream to completion (or a clean preempted stop);
        returns `self.report()`."""
        if self.target is not None and self._last_ck is None \
                and not self.history:
            self.checkpoint()                   # round-0 recovery baseline
        while not all(s.done() for s in self._live_streams()):
            if self._round >= max_rounds:
                raise RuntimeError(f"executor exceeded {max_rounds} rounds")
            self._run_round()
            self._guard_boundary()
            if self._should_stop():
                self.recorder.preempt(self._round,
                                      drained=len(self._inflight))
                if self.target is not None:
                    self.checkpoint()
                else:
                    self._drain()
                self.stopped = True
                return self.report()
            if self.checkpoint_every and self.target is not None \
                    and self._round % self.checkpoint_every == 0:
                self.checkpoint()
        self._drain()
        return self.report()

    def report(self) -> dict:
        return {
            "rounds": self._round,
            "issues": self.issues,
            "streams": len(self.streams),
            "budget": self.budget,
            "stopped": self.stopped,
            "deprioritized": self.deprioritized,
            "checkpoints": list(self.checkpoints),
            "recoveries": [dataclasses.asdict(r) for r in self.recoveries],
            "faults_fired": [dataclasses.asdict(f) for f in
                             (self.injector.fired if self.injector else [])],
            "shed": [dataclasses.asdict(s) for s in self.shed],
            "data_faults": [{"round": r, **info}
                            for r, _f, info in self.data_faults],
            "scrubs": [rep.to_json() for rep in
                       (self.scrubber.reports if self.scrubber else [])],
            "poisoned": int(self.scrubber.poison_host.sum())
            if self.scrubber else 0,
            "events": self.recorder.metrics(),
        }


class _CarryHandle:
    """Retirement handle for a "round" stream step: a CUDA event recorded
    after the step, waited for alone (nothing to wait for on the CPU)."""

    __slots__ = ("_event",)

    def __init__(self, device):
        self._event = None
        if torch.device(device).type == "cuda":
            self._event = torch.cuda.Event()
            self._event.record()

    def wait(self):
        if self._event is not None:
            self._event.synchronize()
