"""Whole-table integrity scrub: digest + invariants -> repair/quarantine.

The scrub pass runs at drained round boundaries (no batch in flight) and
classifies every cell:

  clean        digest matches the pre-boundary baseline and every
               structural invariant holds.
  repairable   corruption detected AND the cell has not been written
               since the last checkpoint: the checkpoint's (logical,
               version) pair is still the truth, so the cell is spliced
               back and the target reloads (a full layout rebuild, which
               also restores indirect/cached internals).
  quarantined  corruption detected on a cell that WAS written since the
               checkpoint (or before any checkpoint exists): no trusted
               copy survives, so the cell is poisoned.  Later ops against
               it are rewritten to IDLE before issue and report
               `success=False`.

Detection is a per-cell FNV-1a digest over the cell's LOGICAL value row
plus its version word.  Each step `h -> (h ^ w) * PRIME` is a bijection of
`h` for fixed `w` (PRIME is odd), so any single-cell change to any word
changes the digest: bit flips and torn writes are detected with
probability 1.  Structural invariants (guard/invariants.py) catch
corruption the logical plane cannot see (cached_wf backup flips, bptr
damage).

The digest is one function of (logical row, version) whatever the layout,
so every layout runs it through `kernels.scrub_digest.digest_rows`: the
CUDA kernel on a CUDA table, the plain PyTorch digest on a CPU one.  The
reference ties the kernel tier to the layouts that lower the engine round,
a TPU-era coupling the port drops.  Masks, digests and
the scrubber's poison and dirty sets stay on the table's device; only the
slot lists of a report go to the host.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core.engine import CAS, IDLE, SC, STORE, canonicalize_ops
from repro_torch.core.layout import as_words, resolve_device
from repro_torch.core.registry import get_strategy
from repro_torch.guard import invariants as _inv
from repro_torch.kernels import scrub_digest
from repro_torch.kernels.scrub_digest import digest_rows

FNV_OFFSET = np.uint32(scrub_digest.FNV_OFFSET)
FNV_PRIME = np.uint32(scrub_digest.FNV_PRIME)


def digest_np(logical, versions) -> np.ndarray:
    """Numpy digest (the oracle, and the snapshot-plane digest)."""
    vals = np.asarray(logical, np.uint32)
    ver = np.asarray(versions, np.uint32)
    h = np.full(ver.shape, FNV_OFFSET, np.uint32)
    with np.errstate(over="ignore"):
        for j in range(vals.shape[1]):
            h = (h ^ vals[:, j]) * FNV_PRIME
        h = (h ^ ver) * FNV_PRIME
    return h


def cell_digest(spec, state) -> torch.Tensor:
    """word[n] FNV-1a digest of each cell's (logical row, version), on the
    table's device: the kernel on a CUDA table, its plain version on a CPU
    one (`digest_rows`), for every layout."""
    impl = get_strategy(spec.strategy)
    return digest_rows(impl.logical(state).contiguous(), state.version)


# ---------------------------------------------------------------------------
# reports
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ScrubReport:
    """One scrub pass's classification (slot lists are global indices)."""
    round: int
    strategy: str
    n: int
    digest_checked: bool                  # had a pre-boundary baseline
    digest_mismatch: list
    invariant_violations: dict            # name -> [slots]
    detected: list                        # newly-anomalous, not yet poisoned
    contained: list                       # anomalous but already quarantined
    repaired: list
    quarantined: list
    poisoned_total: int
    latency_s: float

    @property
    def clean(self) -> bool:
        return not self.detected and not self.contained

    def to_json(self) -> dict:
        out = dataclasses.asdict(self)
        out["clean"] = self.clean
        return out


def _mask_slots(mask: torch.Tensor) -> list:
    return torch.nonzero(mask).flatten().tolist()


def _np_words(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return convert.array(x, word=True)
    return np.asarray(x, np.uint32)


def scrub(spec, state, *, baseline=None, round_idx: int = 0) -> ScrubReport:
    """Standalone detection-only scrub of a quiescent table state.

    `baseline`: the word[n] digest from `cell_digest` (or its uint32 numpy
    bits) taken at an earlier trusted point; None skips the digest check
    (invariants only)."""
    t0 = time.perf_counter()
    dev = state.version.device
    inv = {}
    for name, m in _inv.check_invariants(spec, state).items():
        slots = _mask_slots(m)
        if slots:
            inv[name] = slots
    mismatch = []
    if baseline is not None:
        mismatch = _mask_slots(cell_digest(spec, state)
                               != as_words(baseline, dev))
    detected = sorted(set(mismatch).union(*inv.values()))
    return ScrubReport(
        round=round_idx, strategy=spec.strategy, n=spec.n,
        digest_checked=baseline is not None, digest_mismatch=mismatch,
        invariant_violations=inv, detected=detected, contained=[],
        repaired=[], quarantined=detected, poisoned_total=len(detected),
        latency_s=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# executor-side scrubber: baseline digests, dirty tracking, repair
# ---------------------------------------------------------------------------

class Scrubber:
    """Owns the guard state a run threads through: the sticky poison mask,
    dirty-since-checkpoint tracking (what repair may touch), and the last
    checkpoint's logical plane (what repair splices from).  All three are
    tensors on `device`, the table's."""

    def __init__(self, spec, *, n: int | None = None, device="cuda"):
        self.spec = spec
        self.n = spec.n if n is None else n
        self.device = resolve_device(device)
        self.poison = torch.zeros((self.n,), dtype=torch.bool,
                                  device=self.device)
        # no checkpoint yet: every cell is dirty
        self.dirty = torch.ones((self.n,), dtype=torch.bool,
                                device=self.device)
        self._ckpt = None                       # {"logical","versions"}
        self.reports: list[ScrubReport] = []

    # -- baseline / bookkeeping -------------------------------------------
    def digest_of(self, target) -> torch.Tensor:
        """The target's word[n] digest on the scrubber's device."""
        if target.kind == "local":
            return cell_digest(target.spec, target.state)
        snap = target.snapshot()
        return as_words(digest_np(_np_words(snap["logical"]),
                                  _np_words(snap["versions"])), self.device)

    def set_checkpoint(self, table_snap: dict) -> None:
        """A round-boundary checkpoint was taken: it becomes repair truth
        and every cell becomes clean relative to it."""
        snap = convert.snapshot(table_snap, self.device)
        self._ckpt = {name: x.clone() for name, x in snap.items()}
        self.dirty.zero_()

    def note_results(self, ops, success) -> None:
        """Mark cells written by a retired batch dirty (STORE/CAS/SC that
        reported success; failed writes don't move the cell).  No host
        sync: lanes that wrote nothing mark a spare row."""
        ops = canonicalize_ops(ops, self.device)
        success = torch.as_tensor(success, device=self.device).bool()
        kind, slot = ops.kind, ops.slot
        wrote = ((kind == STORE) | (kind == CAS) | (kind == SC)) & success \
            & (slot >= 0) & (slot < self.n)
        hit = torch.zeros((self.n + 1,), dtype=torch.bool,
                          device=self.device)
        hit[torch.where(wrote, slot, self.n).long()] = True
        self.dirty |= hit[:self.n]

    def note_untracked(self) -> None:
        """A mutation the journal can't attribute per slot: conservatively
        dirty the whole table."""
        self.dirty.fill_(True)

    # -- poison contract ---------------------------------------------------
    def mask_ops(self, ops):
        """Rewrite lanes aimed at quarantined cells to IDLE; returns
        (masked_ops, bool[q] poisoned-lane mask or None).  The MASKED ops
        are what gets issued, so those lanes report success=False."""
        ops = canonicalize_ops(ops, self.device)
        kind, slot = ops.kind, ops.slot
        bad = self.poison[slot.clamp(0, self.n - 1).long()] & (kind != IDLE)
        if not bool(bad.any()):                  # host sync
            return ops, None
        return ops._replace(kind=torch.where(bad, IDLE, kind)), bad

    # -- the pass ----------------------------------------------------------
    def scrub(self, target, *, round_idx: int, baseline) -> ScrubReport:
        t0 = time.perf_counter()
        if target.kind == "local":
            inv_masks = _inv.check_invariants(target.spec, target.state)
            digest = cell_digest(target.spec, target.state)
        else:
            snap = target.snapshot()
            logical, versions = (_np_words(snap["logical"]),
                                 _np_words(snap["versions"]))
            # snapshot plane: parity is the one invariant visible globally
            inv_masks = {"version_parity": torch.from_numpy(
                versions % 2 != 0).to(self.device)}
            digest = as_words(digest_np(logical, versions), self.device)

        anomaly = torch.zeros((self.n,), dtype=torch.bool, device=self.device)
        inv = {}
        for name, m in inv_masks.items():
            slots = _mask_slots(m)
            if slots:
                inv[name] = slots
                anomaly |= m
        mismatch = torch.zeros_like(anomaly)
        if baseline is not None:
            mismatch = digest != as_words(baseline, self.device)
            anomaly |= mismatch

        detected = anomaly & ~self.poison
        contained = anomaly & self.poison
        repairable = detected & ~self.dirty if self._ckpt is not None \
            else torch.zeros_like(anomaly)
        quarantine = detected & ~repairable

        if bool(detected.any()):                 # host sync
            snap = convert.snapshot(target.snapshot(), self.device)
            logical, versions = snap["logical"], snap["versions"]
            if self._ckpt is not None:
                logical = torch.where(repairable[:, None],
                                      self._ckpt["logical"], logical)
                versions = torch.where(repairable, self._ckpt["versions"],
                                       versions)
            # full reload even when nothing was repairable: init rebuilds
            # the layout (pointers, pool, parity) consistently, so a
            # quarantined cell is structurally sound, just untrusted
            target.load({"logical": logical, "versions": versions})
            self.poison |= quarantine

        report = ScrubReport(
            round=round_idx,
            strategy=getattr(self.spec, "strategy", "?"), n=self.n,
            digest_checked=baseline is not None,
            digest_mismatch=_mask_slots(mismatch),
            invariant_violations=inv,
            detected=_mask_slots(detected),
            contained=_mask_slots(contained),
            repaired=_mask_slots(repairable),
            quarantined=_mask_slots(quarantine),
            poisoned_total=int(self.poison.sum()),
            latency_s=time.perf_counter() - t0)
        self.reports.append(report)
        return report
