"""Fault records for the executor and the integrity guard.

Two fault families share one schedule.  *Scheduling* faults perturb when
work runs; *data-plane* faults corrupt the state the work runs against
(`repro_torch.guard.inject` realizes those):

  kind="delay"       stream `stream`'s reported step time is inflated by
                     `seconds` for `rounds` consecutive rounds: the
                     StragglerWatchdog sees a degraded stream and the
                     executor deprioritizes it (skips its next issue slot).
  kind="preempt"     the executor drains, checkpoints and stops cleanly
                     (a resumed executor continues bit-identically).
  kind="shard_loss"  a shard of a distributed target dies mid-round: the
                     executor restores the last checkpoint, reshards a
                     `DistTarget` onto the survivors and replays the issue
                     journal; against the single-device `LocalTarget` it is
                     fatal (`shrink` raises).

  kind="bit_flip"        flip one bit of one live table word (a cell's
                         data/backup word or its version word).
  kind="torn_write"      overwrite only a prefix of a k-word cell without
                         touching its version.
  kind="stale_resurrect" re-load the table from the last checkpoint.
  kind="ckpt_corrupt"    damage / truncate one leaf of the newest disk
  kind="ckpt_truncate"   checkpoint.

`after_issues` makes a scheduling fault genuinely mid-round: it fires only
after that many issue slots of its round have already dispatched.

Ordering contract (what makes chaos schedules reproducible):

  * Scheduling faults fire at the first `poll(round_idx, issues_done)`
    with ``round_idx > f.round or (round_idx == f.round and issues_done >=
    f.after_issues)``; simultaneous faults fire in schedule-list order.
  * Data-plane faults are deferred to the DRAINED round boundary at the
    end of round ``f.round`` (``after_issues`` is ignored: live state is
    only well-defined with nothing in flight) and applied there in
    schedule-list order, before the guard's scrub pass runs.
  * Every choice a fault leaves unspecified (victim slot, word, bit,
    torn-prefix length, victim checkpoint leaf) is drawn on the host from
    a per-fault ``np.random.default_rng(np.random.SeedSequence([seed,
    index]))`` stream, where ``index`` is the fault's position in the
    ORIGINAL schedule list, so one fault's draws never shift another's and
    one seed gives the same corruption in the port and the reference.
  * With a `DistTarget` every rank of the mesh runs the same schedule, so
    every fault fires at the same point on every rank with the same
    draws; a disk-checkpoint fault damages the directory once (its writer
    applies it).
"""

from __future__ import annotations

import dataclasses

import numpy as np

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


class FaultInjector:
    """Fires each fault exactly once; `fired` is the audit log.

    The executor polls scheduling faults before every issue
    (`poll(round_idx, issues_done)`) and data-plane faults at every
    drained round boundary (`poll_boundary(round_idx)`).  See the module
    docstring for the ordering and determinism contract; `seed` makes the
    unspecified choices of every data-plane fault reproducible."""

    def __init__(self, faults: list[Fault], *, seed: int = 0):
        self.seed = seed
        indexed = list(enumerate(faults))
        self._pending = sorted(
            ((i, f) for i, f in indexed if not f.data_plane),
            key=lambda kv: (kv[1].round, kv[1].after_issues))
        self._pending_data = sorted(
            ((i, f) for i, f in indexed if f.data_plane),
            key=lambda kv: (kv[1].round, kv[0]))
        self.fired: list[Fault] = []

    def rng(self, index: int) -> np.random.Generator:
        """The per-fault random stream (position in the original list)."""
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, index]))

    def poll(self, round_idx: int, issues_done: int) -> list[Fault]:
        """Due scheduling faults (fires each exactly once)."""
        out, keep = [], []
        for i, f in self._pending:
            due = (round_idx > f.round
                   or (round_idx == f.round and issues_done >= f.after_issues))
            (out if due else keep).append((i, f))
        self._pending = keep
        self.fired.extend(f for _, f in out)
        return [f for _, f in out]

    def poll_boundary(self, round_idx: int
                      ) -> list[tuple[Fault, np.random.Generator]]:
        """Due data-plane faults with their seeded rngs, in schedule order;
        the executor calls this at the drained boundary ending each round."""
        out, keep = [], []
        for i, f in self._pending_data:
            (out if f.round <= round_idx else keep).append((i, f))
        self._pending_data = keep
        self.fired.extend(f for _, f in out)
        return [(f, self.rng(i)) for i, f in out]

    @property
    def pending_data(self) -> bool:
        return bool(self._pending_data)

    @property
    def exhausted(self) -> bool:
        return not self._pending and not self._pending_data
