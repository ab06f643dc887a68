"""The oversubscribed multi-stream executor, on one device.

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
  target       `LocalTarget` wraps one table on one device
               (`engine.apply_round`).  The sharded target, elastic
               resharding and shard-loss recovery onto a smaller mesh are
               not ported: against a `LocalTarget` a shard loss raises.
  faults       `runtime.faults.FaultInjector` injects delay / preempt /
               shard-loss at exact (round, issue) points and data-plane
               faults at drained round boundaries.  Delays surface through
               the StragglerWatchdog (flagged streams skip their next issue
               slot); preemption drains, checkpoints and stops cleanly.
  history      every ops issue is journaled (stream, seq, ops, claimed
               order, delivered results); `runtime.replay.replay_history`
               replays the whole multi-stream interleaving through one
               sequential numpy oracle.

Nothing here blocks except retirement past the in-flight budget and the
explicit drains at checkpoint and scrub boundaries.  Checkpoints kept in
memory stay on the table's device; a disk checkpoint holds the words as
uint32, the bytes the reference's executor writes.
"""

from __future__ import annotations

import dataclasses
import os
from collections import deque

import numpy as np
import torch

from repro_torch import convert
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

    target:           `LocalTarget` (None for pure kind="host" stream sets,
                      e.g. serving).
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
    injector:         `faults.FaultInjector`, polled before every issue
                      (scheduling faults) and at drained round boundaries
                      (data-plane faults, `poll_boundary`).
    checkpoint_dir /  atomic disk checkpoints (`checkpoint.disk`) every N
    checkpoint_every  rounds at a drained round boundary; an in-memory copy
                      on the table's device is always kept.
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
                self.scrubber = _guard.Scrubber(target.spec,
                                                device=target.device)

    def _k(self) -> int:
        return 1 if self.target is None else self.target.spec.k

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
            except Exception:
                # roll the stream back so the SAME batch retries after the
                # backoff window; non-seekable streams can't retry
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
        if f.kind == "ckpt_truncate":
            with open(victim, "r+b") as fh:
                fh.truncate(size // 2)
            return info
        off = int(rng.integers(size))
        with open(victim, "r+b") as fh:
            fh.seek(off)
            byte = fh.read(1)[0]
            fh.seek(off)
            fh.write(bytes([byte ^ (1 << int(rng.integers(8)))]))
        info["offset"] = off
        return info

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
        spec = self.target.spec

        def word(shape):
            return np.empty(tuple(shape), np.uint32)

        return {"table": {"logical": word((spec.n, spec.k)),
                          "versions": word((spec.n,))},
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
        checkpoint for a preemption resume."""
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
            save_checkpoint(self.checkpoint_dir, self._round,
                            _host_payload(payload), meta=meta)
        self.checkpoints.append(self._round)
        self.recorder.checkpoint(self._round)

    def _load_ck(self, payload: dict, meta: dict, hist_len: int) -> None:
        """Common restore: state, ctxs, seqs, stream cursors; the journal
        loses what was issued after the checkpoint.  Link contexts go to
        the device here, at the drained boundary."""
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

    def _recover(self, shard: int) -> None:
        """Shard-loss recovery: discard in-flight, restore the last
        checkpoint, reshard onto the survivors.  The only target here, a
        `LocalTarget`, has nothing to reshard onto: its `shrink` raises,
        leaving the state the reference leaves.  Replaying the journal
        onto a smaller mesh comes with the sharded target."""
        if self._last_ck is None:
            raise RuntimeError("shard loss before the first checkpoint")
        self._inflight.clear()                  # results may span the loss
        self._load_ck(*self._last_ck)
        self.target.shrink(self.target.n_shards - 1)

    def resume(self, checkpoint_dir: str | None = None) -> int:
        """Resume from the newest VERIFYING disk checkpoint (preemption
        restart): restores table state + link ctxs + stream cursors;
        `run()` then continues bit-identically with the pre-preemption
        schedule.  A corrupt or truncated newest step is skipped
        (`checkpoint.disk.restore_latest`)."""
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
            if self.guard is not None and self.guard.should_stop:
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
        if self.watchdog is not None and rcd.round_issued():
            plan = self.watchdog.observe(
                rcd.latency_vector(len(self.streams)))
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
            if self.guard is not None and self.guard.should_stop:
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
