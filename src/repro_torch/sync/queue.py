"""Bounded MPMC ring queue over big atomics, driven through LL/SC.

Layout (one big-atomic table, k >= 2 words per cell, capacity C >= 2):

    cell 0        HEAD   word0 = dequeue ticket counter
    cell 1        TAIL   word0 = enqueue ticket counter
    cell 2+j      slot j word0 = sequence tag, words 1.. = payload

Tickets are Vyukov-style: slot j starts with seq = j; an enqueue that
claimed ticket t (slot t mod C) publishes (seq=t+1, payload) in ONE atomic
k-word store — payload and tag can never tear apart, which is exactly what
big atomics buy over a word-at-a-time ring.  A dequeue that claimed ticket h
consumes the slot and recycles it with seq = h + C.

Claiming is an LL/SC on the counter cell through the unified engine
(`repro_torch.atomics.apply` on `QueueSpec.table_spec()`): LL reads the
ticket and links the cell, SC commits ticket+1 iff no other lane committed
in between — a pure-sync batch, so the engine resolves it on its one-round
fast path.  Per batch-round at most one enqueuer and one dequeuer win;
losers retry under the contention-management policy of Dice, Hendler &
Mirsky (arXiv:1305.5800) — bounded constant or capped-exponential backoff
measured in ROUNDS, the batch-step analogue of their wasted-CAS spin loops.
The benchmarks compare the policies; `none` makes commit order deterministic
(lane order), which the linearizability tests exploit.

Non-blocking semantics: an enqueue on a stably-full queue and a dequeue on a
stably-empty queue return failure ("stably" = no pending opposite-kind lane
in the same call could change the verdict; such lanes defer instead).

The ring state is the table's `TableState` (`.state`, on the queue's
device); `BigQueue` is the host-side retry loop around it.  With `mesh` /
`n_shards > 1` the ring's cells shard over the mesh axis (`._dstate`,
this rank's shard) and every round runs through
`core.distributed.apply_global`: every rank of the mesh calls the same
queue method with the same arguments and sees every lane's result, so
the retry loop takes the same branches, and issues the same collectives,
on every rank.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.core import distributed as dsb
from repro_torch.core import engine
from repro_torch.core.layout import resolve_device
from repro_torch.core.specs import (DEFAULT_STRATEGY, QUEUE_HEAD,
                                    QUEUE_SLOT0, QUEUE_TAIL, AtomicSpec,
                                    QueueSpec)
from repro_torch.obs import telemetry as obs_telemetry

HEAD, TAIL, SLOT0 = QUEUE_HEAD, QUEUE_TAIL, QUEUE_SLOT0

# run_batch op kinds
ENQ, DEQ, QIDLE = 0, 1, 2


class BackoffPolicy(NamedTuple):
    """Deterministic retry schedule after a lost SC (delay in rounds).

    kind: 'none' | 'const' | 'exp'.  `exp` is capped (Dice et al.: unbounded
    exponential over-serializes; a small cap wins under steady contention).
    """

    kind: str = "none"
    base: int = 1
    cap: int = 8

    def delay(self, attempts: int) -> int:
        if self.kind == "none":
            return 0
        if self.kind == "const":
            return self.base
        if self.kind == "exp":
            return min(self.base * (2 ** max(attempts - 1, 0)), self.cap)
        raise ValueError(self.kind)


def _np_words(t) -> np.ndarray:
    """Word tensor -> numpy uint32 (a host read)."""
    return t.cpu().numpy().view(np.uint32)


class BigQueue:
    """Bounded MPMC queue; every cell a big atomic, every claim an LL/SC.

    The table lives on `device` ("cuda" by default).  With `mesh` /
    `n_shards > 1` the ring's cells shard over the mesh axis `shard_axis`
    (on the mesh's device) and every claim / publish round routes through
    `core.distributed.apply_global`: the sharded decode-slot / admission
    path of the serving engine.  The host retry loop is unchanged; only
    the table execution layer swaps.  One shard stays local.
    """

    def __init__(self, capacity: int | None = None, *, k: int = 2,
                 strategy: str | None = None,
                 policy: BackoffPolicy = BackoffPolicy("none"),
                 p_max: int = 64, max_rounds: int | None = None,
                 initial_items=None, spec: QueueSpec | None = None,
                 mesh=None, shard_axis: str = "shard", n_shards: int = 1,
                 device="cuda"):
        if spec is None:
            if capacity is None:
                raise ValueError("pass either capacity or spec")
            spec = QueueSpec(capacity, k=k,
                             strategy=strategy or DEFAULT_STRATEGY,
                             p_max=p_max)
        self.spec = spec
        self._tspec = spec.table_spec()
        self.policy = policy
        self.max_rounds = max_rounds or 16 * (spec.capacity + spec.p_max + 8)
        C, k, n = spec.capacity, spec.k, self._tspec.n
        initial = np.zeros((n, k), np.uint32)
        initial[SLOT0:, 0] = np.arange(C, dtype=np.uint32)
        if initial_items is not None:
            # Pre-image of m enqueues (tickets 0..m-1), written directly
            # into the initial layout: O(1) instead of m contended rounds.
            items = self._payload(initial_items)
            m = len(items)
            if m > C:
                raise ValueError(f"{m} initial items > capacity {C}")
            initial[SLOT0:SLOT0 + m, 0] = \
                np.arange(1, m + 1, dtype=np.uint32)
            initial[SLOT0:SLOT0 + m, 1:] = items
            initial[TAIL, 0] = m
        self._mesh = mesh if n_shards > 1 else None
        if self._mesh is not None:
            # Cell count padded up to a multiple of the shard count; the
            # padding cells exist but no op ever targets them.
            n_pad = -(-n // n_shards) * n_shards
            self._dist_inner = AtomicSpec(n_pad, k, spec.strategy,
                                          spec.p_max)
            pad = np.zeros((n_pad, k), np.uint32)
            pad[:n] = initial
            self.device = self._mesh.device
            self._dspec = dsb.DistSpec(self._dist_inner, shard_axis,
                                       n_shards, 1)
            self._dstate = dsb.init_dist(self._mesh, self._dspec, pad)
            self.state = None
        else:
            self.device = resolve_device(device)
            self.state = engine.init(self._tspec, initial, device=self.device)
        self.commit_log: list[tuple[str, int, int]] = []  # (kind, lane, ticket)

    # -- v1 attribute surface ------------------------------------------------

    @property
    def capacity(self) -> int:
        return self.spec.capacity

    @property
    def k(self) -> int:
        return self.spec.k

    @property
    def strategy(self) -> str:
        return self.spec.strategy

    # -- execution layer -------------------------------------------------

    def _ops(self, kind, slot, desired=None):
        return engine.make_ops(kind, slot, desired=desired, k=self.k,
                               device=self.device)

    def _apply_ops(self, ops, ctx):
        """One unified batch against the ring table; returns (result, ctx').
        The queue owns its state, so the round updates it in place.

        Sharded, the batch routes through `distributed.apply_global`, whose
        default capacity can never overflow."""
        if self._mesh is None:
            self.state, ctx, res, _, _ = engine.apply(
                self._tspec, self.state, ops, ctx, donate=True)
            return res, ctx
        self._dstate, ctx, res, _ovf = dsb.apply_global(
            self._mesh, self._dspec, self._dstate, ops, ctx, donate=True)
        return res, ctx

    def _read_cells(self, cells) -> np.ndarray:
        """Linearizable read of ring cells (uint32 words on the host): the
        strategy's honest read protocol locally, a routed LOAD batch when
        sharded."""
        cells = np.asarray(cells, np.int32)
        if self._mesh is None:
            vals, _ = engine.read(self._tspec, self.state, cells)
            return _np_words(vals)
        res, _ = self._apply_ops(engine.loads(cells, k=self.k,
                                              device=self.device), None)
        return _np_words(res.value)

    # -- introspection -------------------------------------------------------

    def _counters(self) -> tuple[int, int]:
        vals = self._read_cells([HEAD, TAIL])
        return int(vals[0, 0]), int(vals[1, 0])

    def __len__(self) -> int:
        h, t = self._counters()
        return (t - h) % (1 << 32)

    # -- public ops ----------------------------------------------------------

    def enqueue_batch(self, values) -> np.ndarray:
        """Enqueue values[i] from lane i.  Returns success bool[p]."""
        values = self._payload(values)
        _, succ, _ = self.run_batch(np.full(len(values), ENQ), values)
        return succ

    def dequeue_batch(self, p: int):
        """Dequeue into p lanes.  Returns (payload uint32[p, k-1],
        success bool[p]); payload rows of failed lanes are zero."""
        out, succ, _ = self.run_batch(np.full(p, DEQ))
        return out, succ

    def _payload(self, values) -> np.ndarray:
        values = np.asarray(values, np.uint32)
        if values.ndim == 1:
            values = values[:, None]
        if values.shape[1] != self.k - 1:
            raise ValueError(f"payload width {values.shape[1]} != k-1 "
                             f"({self.k - 1})")
        return values

    # -- the round loop ------------------------------------------------------

    def run_batch(self, kinds, values=None):
        """Run a mixed batch of ENQ/DEQ/QIDLE lane-ops to completion.

        Returns (payload uint32[p, k-1], success bool[p], rounds).  With
        policy 'none' commit order equals lane order per counter; with
        backoff it is the recorded `commit_log` order (still a valid
        linearization).
        """
        kinds = np.asarray(kinds, np.int32)
        p = len(kinds)
        C, k = self.capacity, self.k
        values = self._payload(values) if values is not None else \
            np.zeros((p, k - 1), np.uint32)

        pending = kinds != QIDLE
        success = np.zeros(p, bool)
        out = np.zeros((p, k - 1), np.uint32)
        attempts = np.zeros(p, np.int64)
        delay = np.zeros(p, np.int64)
        counter_cell = np.where(kinds == ENQ, TAIL, HEAD).astype(np.int32)
        ctx = engine.init_ctx(p, k, device=self.device)
        rounds = 0
        # Host-side telemetry (repro_torch.obs): a few int adds per round,
        # one `record` call at the end (itself a no-op unless
        # BIGATOMIC_OBS=counters).  The signals are the loop's own masks.
        n_full = n_empty = n_lost = n_backoff = 0

        while pending.any():
            rounds += 1
            if rounds > self.max_rounds:
                raise RuntimeError(
                    f"queue round bound exceeded ({self.max_rounds}); "
                    f"pending={np.nonzero(pending)[0].tolist()}")
            active = pending & (delay == 0)
            if not active.any():
                delay = np.maximum(delay - 1, 0)
                continue

            # 1. LL the counter cell (tail for ENQ lanes, head for DEQ).
            ops1 = self._ops(np.where(active, engine.LL, engine.IDLE),
                             counter_cell)
            res1, ctx = self._apply_ops(ops1, ctx)
            tick = _np_words(res1.value[:, 0])

            # 2. Honest reads: my ring slot + the opposite counter.
            slot_cell = (SLOT0 + (tick % np.uint32(C))).astype(np.int32)
            other_cell = np.where(kinds == ENQ, HEAD, TAIL).astype(np.int32)
            rvals = self._read_cells(np.concatenate([slot_cell, other_cell]))
            seq = rvals[:p, 0].astype(np.uint32)
            other = rvals[p:, 0].astype(np.uint32)

            is_enq = active & (kinds == ENQ)
            is_deq = active & (kinds == DEQ)
            enq_ready = is_enq & (seq == tick)
            deq_ready = is_deq & (seq == tick + np.uint32(1))
            enq_full = is_enq & ~enq_ready       # C >= 2: seq != t <=> full
            deq_empty = is_deq & ~deq_ready & (other == tick)
            n_full += int(enq_full.sum())
            n_empty += int(deq_empty.sum())

            # Stably full/empty only if no pending opposite-kind lane could
            # still flip the verdict; otherwise defer and retry.
            if not (pending & (kinds == DEQ)).any():
                pending[enq_full] = False
            if not (pending & (kinds == ENQ)).any():
                pending[deq_empty] = False

            attempt = enq_ready | deq_ready
            if not attempt.any():
                delay = np.maximum(delay - 1, 0)
                continue

            # 3. SC the counter (claim ticket `tick` by committing tick+1);
            #    the slot publish rides the same round as a follow-up STORE
            #    once the winners are known.
            des = np.zeros((p, k), np.uint32)
            des[:, 0] = tick + np.uint32(1)
            ops2 = self._ops(np.where(attempt, engine.SC, engine.IDLE),
                             counter_cell, des)
            res2, ctx = self._apply_ops(ops2, ctx)
            won = res2.success.cpu().numpy() & attempt

            # 4. Winners publish their slot in one atomic k-word store:
            #    ENQ: (t+1, payload)   DEQ: (h+C, zeros) — recycled.
            st_des = np.zeros((p, k), np.uint32)
            st_des[:, 0] = np.where(kinds == ENQ, tick + np.uint32(1),
                                    tick + np.uint32(C))
            st_des[:, 1:] = np.where((kinds == ENQ)[:, None], values, 0)
            ops3 = self._ops(np.where(won, engine.STORE, engine.IDLE),
                             slot_cell, st_des)
            self._apply_ops(ops3, None)

            # 5. Bookkeeping: payload capture, commit log, backoff.
            for lane in np.nonzero(won & (kinds == ENQ))[0]:
                self.commit_log.append(("enq", int(lane), int(tick[lane])))
            for lane in np.nonzero(won & (kinds == DEQ))[0]:
                out[lane] = rvals[lane, 1:]
                self.commit_log.append(("deq", int(lane), int(tick[lane])))
            success |= won
            pending &= ~won
            lost = attempt & ~won
            attempts[lost] += 1
            n_lost += int(lost.sum())
            for lane in np.nonzero(lost)[0]:
                delay[lane] = self.policy.delay(int(attempts[lane]))
                n_backoff += 1
            delay[~active] = np.maximum(delay[~active] - 1, 0)

        obs_telemetry.record(**{
            "queue.rounds": rounds,
            "queue.enq": int((success & (kinds == ENQ)).sum()),
            "queue.deq": int((success & (kinds == DEQ)).sum()),
            "queue.enq_full": n_full,
            "queue.deq_empty": n_empty,
            "queue.sc_lost": n_lost,
            "queue.backoff": n_backoff,
        })
        return out, success, rounds
