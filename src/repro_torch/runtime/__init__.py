"""repro_torch.runtime — the execution and robustness layer.

`Executor` schedules oversubscribed logical streams against one big-atomic
target, `LocalTarget` (one device) or `DistTarget` (a table sharded over a
`core.distributed` mesh, every rank running the same executor), with fault
injection, checkpoints, shard-loss recovery onto the survivors and the
integrity guard; the watchdog, the preemption guard, elastic resharding
(`elastic`) and the history replay it composes are exported alongside.
"""

from repro_torch.runtime.preemption import PreemptionGuard  # noqa: F401
from repro_torch.runtime.stragglers import (  # noqa: F401
    StragglerPlan, StragglerWatchdog)
from repro_torch.runtime.elastic import (  # noqa: F401
    MeshPlan, elastic_mesh, mesh_plan, reshard_dist, reshard_state)
from repro_torch.runtime.executor import (  # noqa: F401
    DistTarget, Executor, IssueRec, LocalTarget, Recovery, StreamShed)
from repro_torch.runtime.streams import (  # noqa: F401
    AdmissionStream, DecodeStream, InFlight, McasStream, SyntheticStream,
    serving_streams)
from repro_torch.runtime.faults import (  # noqa: F401
    DATA_KINDS, SCHED_KINDS, Fault, FaultInjector)
from repro_torch.runtime.replay import replay_history  # noqa: F401
