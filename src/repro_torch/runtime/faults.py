"""Fault records for the executor and the integrity guard.

Two fault families share one schedule.  *Scheduling* faults perturb when
work runs; *data-plane* faults corrupt the state the work runs against
(`repro_torch.guard.inject` realizes those):

  kind="delay"       stream `stream`'s reported step time is inflated by
                     `seconds` for `rounds` consecutive rounds.
  kind="preempt"     the executor drains, checkpoints and stops cleanly.
  kind="shard_loss"  a shard of a distributed target dies mid-round.

  kind="bit_flip"        flip one bit of one live table word (a cell's
                         data/backup word or its version word).
  kind="torn_write"      overwrite only a prefix of a k-word cell without
                         touching its version.
  kind="stale_resurrect" re-load the table from the last checkpoint.
  kind="ckpt_corrupt"    damage / truncate one leaf of the newest disk
  kind="ckpt_truncate"   checkpoint.

Every choice a data-plane fault leaves unspecified (victim slot, word, bit,
torn-prefix length) is drawn from the numpy `Generator` its caller passes
to `guard.inject`, so a seed fixes the corruption.  The `FaultInjector`
that fires a schedule comes with the executor.
"""

from __future__ import annotations

import dataclasses

SCHED_KINDS = ("delay", "preempt", "shard_loss")
DATA_KINDS = ("bit_flip", "torn_write", "stale_resurrect",
              "ckpt_corrupt", "ckpt_truncate")


@dataclasses.dataclass(frozen=True)
class Fault:
    round: int                    # 1-based executor round the fault fires in
    kind: str                     # SCHED_KINDS | DATA_KINDS
    stream: int | None = None     # delay: which stream is slow
    shard: int | None = None      # shard_loss / stale_resurrect: which shard
    seconds: float = 0.0          # delay: added reported step time
    rounds: int = 1               # delay: consecutive rounds affected
    after_issues: int = 0         # fire only after this many issues in-round
    # -- data-plane knobs (None = drawn from the caller's seeded rng) -------
    slot: int | None = None       # bit_flip/torn_write: victim cell
    word: int | None = None       # bit_flip: word in [0, k] (k = version)
    bit: int | None = None        # bit_flip: bit index in [0, 32)
    words: int | None = None      # torn_write: prefix length in [1, k]
    field: str | None = None      # bit_flip: raw layout field override
                                  #   ("data" | "version" | "bptr" | "pool")

    def __post_init__(self):
        if self.kind not in SCHED_KINDS + DATA_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.kind == "delay" and self.stream is None:
            raise ValueError("delay faults need stream=")

    @property
    def data_plane(self) -> bool:
        return self.kind in DATA_KINDS
