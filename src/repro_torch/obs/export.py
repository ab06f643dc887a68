"""Serialization for the observability subsystem: Chrome-trace/Perfetto
JSON for `Recorder` timelines, JSONL for counter snapshots.

The trace format is the Chrome trace-event JSON object form — loadable in
Perfetto (ui.perfetto.dev) and chrome://tracing.  The metrics sink is one
JSON object per line with the stable schema

    {"metric": "<name from obs.telemetry.snapshot>", "value": <int|float>}

so downstream tooling can stream-parse it without knowing the full set of
metric names in advance.
"""

from __future__ import annotations

import json

from repro_torch.obs.recorder import PID_SLOTS, PID_STREAMS
from repro_torch.obs.telemetry import derived, snapshot


def chrome_trace(recorder) -> dict:
    """The full Chrome-trace document for a `Recorder`: process metadata
    for the two track groups plus every recorded event."""
    events = [
        {"ph": "M", "name": "process_name", "pid": PID_STREAMS,
         "args": {"name": "logical streams"}},
        {"ph": "M", "name": "process_name", "pid": PID_SLOTS,
         "args": {"name": "device slots"}},
    ]
    events.extend(recorder.events)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(recorder, path: str) -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace(recorder), f)
        f.write("\n")


def write_metrics_jsonl(path: str, extra: dict | None = None) -> None:
    """Dump the global counter snapshot (+ derived rates, + any `extra`
    host counters such as `Recorder.metrics()`) as one metric per line."""
    snap = snapshot()
    snap.update(derived(snap))
    if extra:
        snap.update(extra)
    with open(path, "w") as f:
        for name in sorted(snap):
            f.write(json.dumps({"metric": name, "value": snap[name]}))
            f.write("\n")
