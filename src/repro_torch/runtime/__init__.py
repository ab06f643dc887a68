"""repro_torch.runtime — the execution layer.

So far the single-device `LocalTarget` and the fault records; the
multi-stream `Executor`, `FaultInjector`, the sharded target, elastic
resharding, preemption and the straggler watchdog come with the runtime
slice.
"""

from repro_torch.runtime.executor import LocalTarget  # noqa: F401
from repro_torch.runtime.faults import (  # noqa: F401
    DATA_KINDS, SCHED_KINDS, Fault)
