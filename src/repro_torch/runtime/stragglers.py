"""Straggler detection: for hosts of a training job, or for the executor's
streams (`runtime.executor.Executor` feeds it each stream's issue latency).

Each host reports its step wall time; the watchdog keeps a sliding window of
the last `patience` times per host and flags a host when the MEDIAN of its
full window exceeds `threshold` x the fleet median (lower median of per-host
medians).  Window-median — not EWMA — because a single 30x GC/network blip
must not trip the detector: the blip occupies one window slot and the median
ignores it, while a genuinely degraded host fills its whole window and trips
after exactly `patience` steps.

The decision output is a *plan*: which hosts to swap with hot spares, or —
with no spares left — which to drop via the elastic shrink path.  Pure logic,
no cluster dependencies; the launcher consumes the plan.  At 1000+ nodes the
fleet median is robust to up to half the fleet degrading simultaneously.
"""

from __future__ import annotations

import dataclasses
from collections import deque


@dataclasses.dataclass
class StragglerPlan:
    flagged: list            # host ids currently over threshold
    swap: dict               # host id -> spare id (as far as spares last)
    shrink: list             # flagged hosts left over with no spare


def _median(xs) -> float:
    s = sorted(xs)
    return s[(len(s) - 1) // 2]          # lower median (robust for n=2)


class StragglerWatchdog:
    def __init__(self, n_hosts: int, *, threshold: float = 1.5,
                 patience: int = 3, spares: list | None = None):
        self.n_hosts = n_hosts
        self.threshold = threshold
        self.patience = max(patience, 1)
        self.window = [deque(maxlen=self.patience) for _ in range(n_hosts)]
        self.spares = list(spares or [])

    def observe(self, step_times: list[float]) -> StragglerPlan:
        assert len(step_times) == self.n_hosts
        for i, t in enumerate(step_times):
            self.window[i].append(float(t))
        host_med = [_median(w) if w else 0.0 for w in self.window]
        fleet = _median(host_med)
        flagged = [
            i for i in range(self.n_hosts)
            if len(self.window[i]) == self.patience and fleet > 0
            and host_med[i] > self.threshold * fleet
        ]
        swap, shrink = {}, []
        for h in flagged:
            if self.spares:
                swap[h] = self.spares.pop(0)
            else:
                shrink.append(h)
        for h in swap:                       # swapped hosts start fresh
            self.window[h].clear()
        return StragglerPlan(flagged, swap, shrink)
