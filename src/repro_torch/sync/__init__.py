"""repro_torch.sync — retry-safe synchronization primitives over big atomics.

Layered as Blelloch & Wei ("LL/SC and Atomic Copy") prescribe:

  llsc        the v1 shim for k-word LL / SC / validate; these are kinds of
              the unified engine (`repro_torch.atomics.apply`), mixable
              with load/store/CAS lanes.  Only the deprecated `apply_sync`
              warns, once, when called
  atomic_copy linearizable big-atomic -> big-atomic copy built on LL/SC
              (one mixed LL+LOAD batch, then an SC batch, per wave)
  queue       bounded MPMC ring queue (Vyukov-style tickets) whose head,
              tail and slot cells are big atomics driven through LL/SC,
              with Dice-style bounded-backoff contention management
"""

from repro_torch.sync.llsc import (  # noqa: F401
    IDLE, LL, SC, VL, LinkCtx, SyncOpBatch, SyncResult, apply_sync,
    apply_sync_reference, init_ctx, make_sync_batch,
)
from repro_torch.sync.atomic_copy import (  # noqa: F401
    copy_batch, copy_batch_reference,
)
from repro_torch.sync.queue import BackoffPolicy, BigQueue  # noqa: F401
