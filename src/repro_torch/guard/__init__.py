"""repro_torch.guard — integrity scrubbing and graceful degradation.

Data-plane faults (`guard.inject`) can corrupt live big-atomic state (bit
flips, torn k-word writes); this package detects that corruption at drained
round boundaries, repairs what the last checkpoint still vouches for, and
quarantines the rest so later ops report `success=False` instead of serving
garbage.

  invariants   per-strategy structural checks via the
               `StrategyImpl.check_invariants` registry hook (seqlock
               parity, indirect pointer/shadow agreement, cached_wf/
               cached_me tag consistency).
  scrub        whole-table digest + invariant pass classifying each cell
               clean / repairable / quarantined (`ScrubReport`); the
               digest is `kernels.scrub_digest.digest_rows` (the CUDA
               kernel on a CUDA table).
  inject       seeded bit flips and torn writes, on the table or on a
               snapshot.

The `BIGATOMIC_GUARD` gate, the chaos harness and the version-list
invariants come with the runtime and transactions slices, which read them.
"""

from __future__ import annotations

from repro_torch.guard.invariants import (  # noqa: F401
    check_invariants, violation_mask,
)
from repro_torch.guard.scrub import (  # noqa: F401
    ScrubReport, Scrubber, cell_digest, scrub,
)

