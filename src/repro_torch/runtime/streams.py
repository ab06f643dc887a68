"""Logical op streams for the multi-stream executor.

A *stream* is one logical worker issuing work against a shared big-atomic
target: the oversubscription regime has more streams than hardware slots,
and `repro_torch.runtime.executor` schedules them.  Three stream kinds:

  kind="ops"    produces `engine.OpBatch`es of numpy arrays; the executor
                owns the table state and the stream's per-lane `LinkCtx`,
                runs each batch through the engine round (donated, so the
                table is updated in place) and delivers the per-lane results
                back as numpy.  `SyntheticStream` below is the deterministic
                workload generator (batch b is a pure function of (seed, b),
                so checkpoint resume and fault replay never regenerate
                different ops).
  kind="round"  holds a multi-round protocol and advances it ONE round per
                scheduling slot: `McasStream` wraps `txn.mcas.mcas_round`
                so MCAS retry loops yield to the scheduler between attempt
                rounds.
  kind="host"   produces opaque in-flight work via `issue()`; the returned
                token's `finish()` completes it when the executor retires
                the slot.  `serving_streams` exposes a `ServingEngine`'s
                admission and decode paths as two such streams, so prefill
                compute overlaps the in-flight decode.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import engine


class InFlight:
    """Opaque in-flight work from a kind="host" stream: `finish()` runs the
    completion (host-side) half when the executor retires the slot."""

    __slots__ = ("_finish",)

    def __init__(self, finish):
        self._finish = finish

    def finish(self):
        if self._finish is not None:
            fn, self._finish = self._finish, None
            fn()


class SyntheticStream:
    """Deterministic mixed-op workload: batch b is a pure function of
    (seed, b), so a resumed or fault-replayed executor reissues bit-identical
    ops without the stream journaling anything.  Batches are numpy arrays,
    drawn exactly as the reference's `SyntheticStream` draws them.

    Lane layout per batch: the first half of the lanes are *sync* lanes that
    LL a cell on even batches and SC the same cell on the following odd batch
    (links therefore span batches, and SCs race writes from OTHER streams);
    the second half draws LOAD/STORE/CAS uniformly.  `hot_frac` of all lanes
    collapse onto cells [0, hot_cells) to dial contention up.
    """

    kind = "ops"

    def __init__(self, name: str, seed: int, *, n: int, k: int, width: int,
                 n_batches: int, slot_lo: int = 0, slot_hi: int | None = None,
                 hot_cells: int = 0, hot_frac: float = 0.0):
        self.name = name
        self.seed = seed
        self.n, self.k, self.width = n, k, width
        self.n_batches = n_batches
        self.slot_lo = slot_lo
        self.slot_hi = n if slot_hi is None else slot_hi
        self.hot_cells, self.hot_frac = hot_cells, hot_frac
        self._i = 0
        self.results: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    def _gen(self, b: int) -> engine.OpBatch:
        q, k = self.width, self.k
        # The LL (batch 2m) and its SC (batch 2m+1) share one rng draw so
        # the pair targets the same cell.
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, b // 2]))
        slot = rng.integers(self.slot_lo, self.slot_hi, q).astype(np.int32)
        if self.hot_cells and self.hot_frac > 0:
            hot = rng.random(q) < self.hot_frac
            slot = np.where(hot, rng.integers(0, self.hot_cells, q),
                            slot).astype(np.int32)
        n_sync = q // 2
        kind = np.empty(q, np.int32)
        kind[:n_sync] = engine.LL if b % 2 == 0 else engine.SC
        kind[n_sync:] = rng.choice(
            [engine.LOAD, engine.STORE, engine.CAS], q - n_sync)
        # value-op payloads vary per batch (not per pair)
        vrng = np.random.default_rng(np.random.SeedSequence([self.seed, b,
                                                             0xBEEF]))
        expected = vrng.integers(0, 2 ** 32, (q, k), dtype=np.uint32)
        desired = vrng.integers(0, 2 ** 32, (q, k), dtype=np.uint32)
        return engine.OpBatch(kind, slot, expected, desired)

    def next_batch(self) -> engine.OpBatch | None:
        if self._i >= self.n_batches:
            return None
        ops = self._gen(self._i)
        self._i += 1
        return ops

    def seek(self, seq: int) -> None:
        """Fast-forward the cursor on checkpoint resume: batches < seq were
        already executed and live in the restored state."""
        self._i = int(seq)

    def deliver(self, seq: int, value: np.ndarray, success: np.ndarray,
                overflow=None) -> None:
        """Results land here (idempotent by seq: fault replay re-delivers,
        last write wins)."""
        self.results[int(seq)] = (np.asarray(value), np.asarray(success))

    def done(self) -> bool:
        return self._i >= self.n_batches


class McasStream:
    """A batch of MCAS transactions advanced ONE protocol round per
    scheduling slot (`txn.mcas.mcas_round`): between attempt rounds the
    executor is free to run other streams' batches, so contended retries
    yield instead of spinning.  The executor owns the table, so each round
    is donated (the table is updated in place).  `done()` reads the
    carry's pending mask back once a round, as the reference's does."""

    kind = "round"

    def __init__(self, name: str, txns, *, policy=None):
        from repro_torch.sync.queue import BackoffPolicy
        self.name = name
        self.txns = txns
        self.policy = policy or BackoffPolicy("none")
        self.carry = None
        self.rounds_run = 0

    def step(self, spec, state):
        """Advance one round against the executor-owned state; returns the
        new state (chained in place of the old)."""
        from repro_torch.txn import mcas as txn_mcas
        if self.carry is None:
            self.carry = txn_mcas.mcas_begin(self.txns)
        state, self.carry = txn_mcas.mcas_round(
            spec, state, self.txns, self.carry, policy=self.policy,
            donate=True)
        self.rounds_run += 1
        return state

    def done(self) -> bool:
        if self.carry is None:
            return False
        return not bool(self.carry.pending.any())        # host read

    def result(self):
        from repro_torch.txn import mcas as txn_mcas
        if self.carry is None or not self.done():
            raise RuntimeError("mcas stream still pending")
        return txn_mcas.mcas_finish(self.txns, self.carry)


# ---------------------------------------------------------------------------
# Serving: admission and decode as two decoupled executor streams.
# ---------------------------------------------------------------------------

class DecodeStream:
    """Dispatches the fused decode step for the live slots WITHOUT fetching
    tokens; sampling and retirement run at retire time, after admission
    has had the card for prefill compute."""

    kind = "host"

    def __init__(self, eng):
        self.name = "decode"
        self.eng = eng

    def issue(self) -> InFlight | None:
        eng = self.eng
        if eng.decode_inflight:       # next step's tokens depend on this one
            return None
        live = [i for i, s in enumerate(eng.slots) if s.active]
        if not live:
            if eng._pending_retire:
                eng.flush_retires()
            return None
        pend = eng.dispatch_decode(live)
        return InFlight(lambda: eng.finish_decode(live, pend))

    def done(self) -> bool:
        eng = self.eng
        return not any(s.active for s in eng.slots) and not eng.pending() \
            and not eng._pending_retire


class AdmissionStream:
    """Claims (request, slot) pairs and runs the prefill forwards (device
    work that overlaps the in-flight decode), deferring the page-table
    commit to retire time (after the decode's paged state lands).

    The stream is not done while a commit is in flight: its requests have
    left the admission queue but hold no live slot yet, so the decode
    stream sees nothing to do, and an executor that stopped there would
    never decode them.  (The reference's stream reports done as soon as
    the queue is empty, and its `run_pipelined` returns those requests
    with their first token only when every slot retires in one step and
    requests still wait; ROADMAP.md, Queue 3.)"""

    kind = "host"

    def __init__(self, eng):
        self.name = "admission"
        self.eng = eng
        self._uncommitted = 0

    def issue(self) -> InFlight | None:
        eng = self.eng
        admitted = eng.admit_compute()
        if not admitted:
            return None
        self._uncommitted += 1

        def commit():
            eng.commit_admissions(admitted)
            self._uncommitted -= 1
        return InFlight(commit)

    def done(self) -> bool:
        return not self.eng.pending() and not self._uncommitted


def serving_streams(eng):
    """(DecodeStream, AdmissionStream) over a `ServingEngine`: schedule
    them with `repro_torch.runtime.Executor(target=None, streams=[...])`
    and the engine produces tokens identical to `run_to_completion`, with
    admission prefill overlapping the in-flight decode."""
    return DecodeStream(eng), AdmissionStream(eng)
