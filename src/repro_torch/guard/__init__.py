"""repro_torch.guard — integrity scrubbing and graceful degradation.

Data-plane faults (`guard.inject`) can corrupt live big-atomic state (bit
flips, torn k-word writes); this package detects that corruption at drained
round boundaries, repairs what the last checkpoint still vouches for, and
quarantines the rest so later ops report `success=False` instead of serving
garbage.

  invariants   per-strategy structural checks via the
               `StrategyImpl.check_invariants` registry hook (seqlock
               parity, indirect pointer/shadow agreement, cached_wf/
               cached_me tag consistency), and the version lists' head /
               pool agreement (`check_version_list`).
  scrub        whole-table digest + invariant pass classifying each cell
               clean / repairable / quarantined (`ScrubReport`); the
               digest is `kernels.scrub_digest.digest_rows` (the CUDA
               kernel on a CUDA table).
  inject       seeded bit flips and torn writes, on the table or on a
               snapshot.

The `BIGATOMIC_GUARD` gate and the chaos harness come with the runtime
slice, which reads them.
"""

from __future__ import annotations

from repro_torch.guard.invariants import (  # noqa: F401
    check_invariants, check_version_list, violation_mask,
)
from repro_torch.guard.scrub import (  # noqa: F401
    ScrubReport, Scrubber, cell_digest, scrub,
)

