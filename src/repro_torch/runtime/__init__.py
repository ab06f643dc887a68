"""repro_torch.runtime — the execution and robustness layer.

`Executor` schedules oversubscribed logical streams against one big-atomic
target (`LocalTarget`, one device) with fault injection, checkpoints and
the integrity guard; the watchdog, the preemption guard and the history
replay it composes are exported alongside.  The sharded target, elastic
resharding and shard-loss recovery onto a smaller mesh are not ported.
"""

from repro_torch.runtime.preemption import PreemptionGuard  # noqa: F401
from repro_torch.runtime.stragglers import (  # noqa: F401
    StragglerPlan, StragglerWatchdog)
from repro_torch.runtime.executor import (  # noqa: F401
    Executor, IssueRec, LocalTarget, Recovery, StreamShed)
from repro_torch.runtime.streams import (  # noqa: F401
    AdmissionStream, DecodeStream, InFlight, McasStream, SyntheticStream,
    serving_streams)
from repro_torch.runtime.faults import (  # noqa: F401
    DATA_KINDS, SCHED_KINDS, Fault, FaultInjector)
from repro_torch.runtime.replay import replay_history  # noqa: F401
