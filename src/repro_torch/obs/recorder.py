"""Tier-2 observability: the host-side executor timeline.

The executor already journals everything a timeline needs — per-issue
`IssueRec`s, round boundaries, checkpoint/restore, shard-loss recoveries,
preempt drains, watchdog flags.  `Recorder` is the sink those hooks feed:

  * always (any BIGATOMIC_OBS mode): per-round issue-latency bookkeeping —
    this replaces the executor's old ad-hoc `_last_times` dict as the
    input to `runtime.stragglers.StragglerWatchdog` — plus event counts.
  * under BIGATOMIC_OBS=trace: Chrome-trace/Perfetto span events, one
    timeline track per logical stream (pid 0) and one per device slot
    (pid 1), exported by `obs.export.chrome_trace`.

The Recorder is pure host-side Python: it touches no tensor and costs a
few dict writes per issue when tracing is off.
"""

from __future__ import annotations

import time

from repro_torch.obs import telemetry as _telemetry

# Chrome-trace pids: one process per conceptual track group.
PID_STREAMS = 0
PID_SLOTS = 1


class Recorder:
    """Collects executor events; see `obs.export` for serialization.

    trace: force the span-event tier on/off; defaults to the static
        BIGATOMIC_OBS flag (`trace_on()`), read once at construction.
    clock: seconds-returning monotonic clock (injectable for tests).
    """

    def __init__(self, *, trace: bool | None = None, clock=time.perf_counter):
        self.trace = _telemetry.trace_on() if trace is None else trace
        self.clock = clock
        self._t0 = clock()
        self.events: list[dict] = []     # chrome-trace events (trace tier)
        self.counts: dict[str, int] = {}
        self.flags: list[tuple[int, list[int]]] = []  # (round, streams)
        # Issue-latency bookkeeping (the watchdog's input): latest latency
        # per stream this round, and the last-known latency per stream ever.
        self._round_lat: dict[int, float] = {}
        self._last_lat: dict[int, float] = {}
        # Device-slot track allocation: lowest free slot id per span.
        self._free_slots: list[int] = []
        self._next_slot = 0
        self._names: dict[tuple[int, int], str] = {}

    # -- clock helpers ----------------------------------------------------

    def _us(self) -> float:
        return (self.clock() - self._t0) * 1e6

    def _bump(self, name: str, v: int = 1) -> None:
        self.counts[name] = self.counts.get(name, 0) + v

    def _meta(self, pid: int, tid: int, name: str) -> None:
        if self._names.setdefault((pid, tid), name) == name:
            self.events.append({"ph": "M", "name": "thread_name", "pid": pid,
                                "tid": tid, "args": {"name": name}})

    # -- round / issue hooks (called by runtime.executor) ------------------

    def round_begin(self, round_idx: int) -> None:
        self._round_lat.clear()
        self._bump("exec.rounds")

    def round_end(self, round_idx: int) -> None:
        self._last_lat.update(self._round_lat)

    def issue_latency(self, stream_idx: int, seconds: float) -> None:
        """Record the host-side issue latency of one stream this round."""
        self._round_lat[stream_idx] = seconds
        self._bump("exec.issues")

    def round_issued(self) -> bool:
        return bool(self._round_lat)

    def latency_vector(self, n_streams: int) -> list[float]:
        """Per-stream latencies for `StragglerWatchdog.observe`: streams
        quiet this round carry their last-known latency, streams never seen
        carry the fleet's current median (so they read as healthy)."""
        lats = sorted(self._round_lat.values())
        fill = lats[len(lats) // 2]
        return [self._last_lat.get(si, self._round_lat.get(si, fill))
                for si in range(n_streams)]

    def straggler_flags(self, round_idx: int, flagged) -> None:
        flagged = sorted(flagged)
        self.flags.append((round_idx, flagged))
        self._bump("exec.straggler_flags", len(flagged))
        self.instant(f"straggler:{flagged}", pid=PID_STREAMS,
                     tid=flagged[0] if flagged else 0)

    # -- span events (trace tier) -----------------------------------------

    def begin_issue(self, stream_idx: int, stream_name: str):
        """Open a span: returns an opaque token for `end_issue`, or None
        when the trace tier is off (hot-path callers pass it straight
        back, no branching needed)."""
        if not self.trace:
            return None
        if self._free_slots:
            slot = self._free_slots.pop()
        else:
            slot = self._next_slot
            self._next_slot += 1
        self._meta(PID_STREAMS, stream_idx, f"stream:{stream_name}")
        self._meta(PID_SLOTS, slot, f"slot:{slot}")
        return (stream_idx, slot, self._us())

    def end_issue(self, token, *, name: str = "issue",
                  args: dict | None = None) -> None:
        """Close a span at retire time: emits one complete ("X") event on
        the stream track and one on the device-slot track."""
        if token is None:
            return
        stream_idx, slot, t0 = token
        dur = max(self._us() - t0, 0.01)
        base = {"ph": "X", "name": name, "ts": t0, "dur": dur,
                "args": args or {}}
        self.events.append({**base, "pid": PID_STREAMS, "tid": stream_idx})
        self.events.append({**base, "pid": PID_SLOTS, "tid": slot})
        self._free_slots.append(slot)
        self._bump("exec.retires")

    def cancel_issue(self, token) -> None:
        """Abandon a span whose issue turned out to be a no-op: frees the
        device slot, emits nothing."""
        if token is not None:
            self._free_slots.append(token[1])

    def instant(self, name: str, *, pid: int = PID_STREAMS,
                tid: int = 0, args: dict | None = None) -> None:
        if not self.trace:
            return
        self.events.append({"ph": "i", "name": name, "ts": self._us(),
                            "pid": pid, "tid": tid, "s": "g",
                            "args": args or {}})

    # -- lifecycle events --------------------------------------------------

    def checkpoint(self, round_idx: int) -> None:
        self._bump("exec.checkpoints")
        self.instant(f"checkpoint@{round_idx}")

    def recovery(self, round_idx: int, shard: int, replayed: int,
                 latency_s: float) -> None:
        self._bump("exec.recoveries")
        self._bump("exec.replayed", replayed)
        self.instant(f"recover:shard{shard}", args={
            "round": round_idx, "replayed": replayed,
            "latency_s": latency_s})

    def preempt(self, round_idx: int, drained: int) -> None:
        self._bump("exec.preempts")
        self.instant(f"preempt@{round_idx}", args={"drained": drained})

    def data_fault(self, round_idx: int, kind: str, info: dict) -> None:
        self._bump("exec.data_faults")
        self.instant(f"fault:{kind}@{round_idx}", args=info)

    def scrub(self, round_idx: int, report) -> None:
        self._bump("exec.scrubs")
        self._bump("guard.cells_detected", len(report.detected))
        self._bump("guard.cells_repaired", len(report.repaired))
        self._bump("guard.cells_quarantined", len(report.quarantined))
        self.instant(f"scrub@{round_idx}", args={
            "detected": report.detected, "repaired": report.repaired,
            "quarantined": report.quarantined,
            "latency_s": report.latency_s})

    def shed(self, round_idx: int, stream: int, reason: str) -> None:
        self._bump("exec.shed")
        self.instant(f"shed:s{stream}", args={"round": round_idx,
                                              "reason": reason})

    # -- output ------------------------------------------------------------

    def metrics(self) -> dict:
        """Host counter snapshot (merged with the in-graph counters by
        `obs.export.write_metrics_jsonl`)."""
        return dict(self.counts)
