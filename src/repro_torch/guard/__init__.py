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
  chaos        seeded harness composing random scheduling + data-plane
               fault schedules over executor runs, replayed through the
               port's sequential history replay (`runtime.replay`): the
               zero-undetected-corruptions gate.

Gate: `BIGATOMIC_GUARD` = off (default) | on, read per executor
construction.  Off, the executor builds no `Scrubber` and its issue path
runs exactly the operations it runs without the guard.
"""

from __future__ import annotations

import os

from repro_torch.guard.invariants import (  # noqa: F401
    check_invariants, check_version_list, violation_mask,
)
from repro_torch.guard.scrub import (  # noqa: F401
    ScrubReport, Scrubber, cell_digest, scrub,
)


def configured() -> str:
    mode = os.environ.get("BIGATOMIC_GUARD", "off")
    if mode not in ("off", "on"):
        raise ValueError(f"BIGATOMIC_GUARD={mode!r}; expected off|on")
    return mode


def enabled() -> bool:
    """True when the guard tier is requested (read per call)."""
    return configured() == "on"
