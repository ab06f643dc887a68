"""repro_torch.obs — two-tier observability.

Tier 1 (`obs.telemetry`): int32 counters on the device, added to in place
after each engine round, gated by BIGATOMIC_OBS=off|counters|trace so that
`off` launches nothing and makes nothing.

Tier 2 (`obs.recorder` + `obs.export`): the host-side executor timeline —
Chrome-trace/Perfetto spans per logical stream and per device slot, plus
a JSONL metrics sink with a stable name schema.
"""

from repro_torch.obs.export import (chrome_trace, write_chrome_trace,
                                    write_metrics_jsonl)
from repro_torch.obs.recorder import Recorder
from repro_torch.obs.telemetry import (Telemetry, configured_mode,
                                       counters_on, derived, init_telemetry,
                                       record, reset, snapshot, trace_on)

__all__ = [
    "Telemetry", "configured_mode", "counters_on", "trace_on",
    "init_telemetry", "record", "reset", "snapshot", "derived",
    "Recorder", "chrome_trace", "write_chrome_trace", "write_metrics_jsonl",
]
