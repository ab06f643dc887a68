"""Continuous-batching serving engine over the paged KV cache.

The port of the JAX package's `serving/engine.py`.  Requests are admitted into `max_batch` decode slots as they arrive; every
`step()` decodes ONE token for all live slots in one batched forward
against page-gathered KV, then appends the new K/V through the page table
(CacheHash INSERT on page-boundary crossings).  Finished sequences release
their pages (CacheHash DELETE) without stalling the other slots.

Admission is lock-free big atomics: request intake is an MPMC
`sync.queue.BigQueue` of request ids, decode-slot claim / retirement a
second BigQueue cycling the slot indices, and the physical-page free list
inside `paged_kv` a third.  Each step's page-table mutations (the deferred
retirement deletes plus this step's page-boundary appends) commit as ONE
transaction (`paged_kv.txn_bookkeep` over `txn.map`).

`fused=True` (the default) runs the decode data path (page-table FIND ->
KV gather -> batched forward -> KV append) as one call: `dispatch_count`
counts 1 per fused step and 4 per unfused step, the reference's meaning.
The reference jits the fused step into one program; here the step's
`apply_hash` reads its round count back to the host once per call, so the
step cannot be captured into a CUDA graph yet (ROADMAP Queue 2 items
1-2).
A decode step's host reads are pinned by tests/test_torch_serving.py.

Sampling: temperature 0 is greedy (argmax, the first index on ties), the
same tokens as the reference from the same weights.  Temperature > 0 draws
by Gumbel-max from a `torch.Generator` seeded with `seed`, on the engine's
device: the draws cannot equal `jax.random`'s.

`run_pipelined` serves through `runtime.Executor`: admission
(`admit_compute` / `commit_admissions`) and decode (`dispatch_decode` /
`finish_decode`) as two decoupled streams, so prefills overlap the decode
in flight.

With `mesh=` (a `core.distributed.Mesh`) the page table is a CacheHash
sharded over the mesh axis `shard_axis`, and the admission, slot and
free-page rings are sharded `BigQueue`s: every page-table batch and ring
round routes by owner, and each step's bookkeeping commits through
`txn.map.transact_dist`.  The model and the K/V page pools are
replicated.  Every rank of the mesh runs the same host program (the same
`submit`s and `step`s with its own copy of the weights); every result a
host decision reads is gathered to every rank, so the ranks take the same
branches and issue the same collectives, and their tokens are those of
the engine without a mesh.  `run_pipelined` works with a mesh too: the
executor's schedule follows host state only (no event polls).  Scope, as
the reference's: causal full-attention archs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.layout import resolve_device
from repro_torch.core.specs import DEFAULT_STRATEGY
from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import forward
from repro_torch.obs import telemetry as obs_telemetry
from repro_torch.serving import paged_kv as pk
from repro_torch.sync.queue import BigQueue


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # int32[T]
    max_new_tokens: int = 16
    temperature: float = 0.0           # 0 = greedy
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass(frozen=True)
class OverloadPolicy:
    """Admission control under overload.  The engine is *saturated* when
    no decode slot is free AND the admission queue sits at or above
    `watermark` of its capacity; after more than `patience` consecutive
    saturated submissions, new requests are shed with a typed verdict."""
    watermark: float = 0.75
    patience: int = 2


@dataclasses.dataclass(frozen=True)
class Admitted:
    """submit() verdict: the request id is on the admission ring."""
    rid: int
    queue_depth: int


@dataclasses.dataclass(frozen=True)
class Shed:
    """submit() verdict: the request was refused under overload."""
    rid: int
    reason: str
    queue_depth: int
    free_slots: int


@dataclasses.dataclass
class _Slot:
    rid: int = -1
    seq_id: int = -1
    pos: int = 0                       # next position to decode
    new_tokens: int = 0
    active: bool = False


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 4,
                 n_pages: int | None = None, page_size: int | None = None,
                 max_pages_per_seq: int = 32, strategy: str | None = None,
                 max_queue: int = 256, seed: int = 0, fused: bool = True,
                 mesh=None, shard_axis: str = "shard",
                 txn_bookkeeping: bool = True,
                 overload: OverloadPolicy | None = None, device="cuda"):
        assert all(k == "attn" for k in cfg.layer_kinds) and \
            cfg.causal and cfg.window == 0, \
            "paged engine serves causal full-attention archs; use " \
            "make_serve_step for SSM / hybrid / SWA / encoder"
        # with a mesh, everything lives on the mesh's device
        self.device = mesh.device if mesh is not None \
            else resolve_device(device)
        n_shards = mesh.size(shard_axis) if mesh is not None else 1
        self.mesh = mesh
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.max_pages = max_pages_per_seq
        spec = pk.make_spec(cfg, n_pages if n_pages is not None else 256,
                            page_size if page_size is not None else 16,
                            max_batch, strategy or DEFAULT_STRATEGY,
                            n_shards=n_shards, axis=shard_axis)
        self.paged = pk.init(cfg, spec, mesh=mesh, device=self.device)
        self.slots = [_Slot() for _ in range(max_batch)]
        # Lock-free intake: rids wait in an MPMC big-atomic queue; decode
        # slots cycle through a second one (claim = dequeue, retire = enq).
        # With a mesh both rings, like the page table, are sharded.
        self.admit_q = BigQueue(max(max_queue, 2), k=2,
                                strategy=spec.table.strategy, mesh=mesh,
                                shard_axis=shard_axis, n_shards=n_shards,
                                device=self.device)
        self.slot_q = BigQueue(max(max_batch, 2), k=2,
                               strategy=spec.table.strategy,
                               initial_items=np.arange(max_batch,
                                                       dtype=np.uint32),
                               mesh=mesh, shard_axis=shard_axis,
                               n_shards=n_shards, device=self.device)
        self.requests: dict[int, Request] = {}
        self._next_seq = 0
        self.seed = seed
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.fused = fused
        self.dispatch_count = 0        # decode-path dispatches
        # Retire deletes defer to the next step's transaction;
        # `_pending_retire` holds them meanwhile.
        self.txn_bookkeeping = txn_bookkeeping
        self._pending_retire: list[tuple[int, int]] = []
        self._decode_inflight = False
        self.overload = overload
        self._overload_streak = 0
        self.shed_count = 0

    # -- public API ---------------------------------------------------------

    def submit(self, req: Request) -> Admitted | Shed:
        """Lock-free intake: the request id rides the admission queue; the
        Request object is parked in the host-side registry.  With an
        `OverloadPolicy`, sustained saturation (and a full ring) sheds the
        request; without one, a full ring raises RuntimeError."""
        if req.rid < 0 or req.rid >= 2 ** 32:
            raise ValueError("rid must fit in a uint32 payload word")
        depth, free = len(self.admit_q), len(self.slot_q)
        if self.overload is not None:
            saturated = free == 0 and \
                depth >= self.overload.watermark * self.admit_q.capacity
            self._overload_streak = self._overload_streak + 1 if saturated \
                else 0
            if saturated and self._overload_streak > self.overload.patience:
                return self._shed(req, "sustained overload", depth, free)
        ok = self.admit_q.enqueue_batch(np.asarray([req.rid], np.uint32))
        if not ok[0]:
            if self.overload is not None:
                return self._shed(req, "admission queue full", depth, free)
            raise RuntimeError("admission queue full")
        self.requests[req.rid] = req
        return Admitted(rid=req.rid, queue_depth=depth + 1)

    def _shed(self, req: Request, reason: str, depth: int,
              free: int) -> Shed:
        self.shed_count += 1
        obs_telemetry.record(**{"serving.shed": 1})
        return Shed(rid=req.rid, reason=reason, queue_depth=depth,
                    free_slots=free)

    def step(self):
        """Admit waiting requests into free slots, then decode one token for
        every active slot.  Returns the number of live slots."""
        if self._pending_retire and \
                min(len(self.admit_q), len(self.slot_q)) > 0:
            # Admission will prefill this step: commit the deferred
            # retirement deletes FIRST so their pages are free for the
            # prefill allocs.
            self.paged, _ = pk.txn_bookkeep(self.paged,
                                            self._drain_retires(), [])
        self._admit()
        live = [i for i, s in enumerate(self.slots) if s.active]
        if live:
            self._decode(live)
        elif self._pending_retire:
            # No decode this step: flush the deferred retirement deletes as
            # their own transaction so pages recycle promptly.
            self.paged, _ = pk.txn_bookkeep(self.paged,
                                            self._drain_retires(), [])
        return len(live)

    def pending(self) -> int:
        """Requests waiting in the admission queue (a counter-cell read)."""
        return len(self.admit_q)

    def run_to_completion(self, max_steps: int = 1000):
        for _ in range(max_steps):
            if not self.step() and not self.pending():
                break
        return {r.rid: r.out_tokens for r in self.requests.values()}

    def run_pipelined(self, max_steps: int = 1000):
        """Serve through `runtime.Executor`: admission and decode run as
        two DECOUPLED streams, so prefill forwards (device compute) overlap
        the in-flight decode instead of serializing in front of it as
        `step()` does.  Greedy sampling is batch-composition independent,
        so per-request tokens are identical to `run_to_completion`."""
        from repro_torch.runtime.executor import Executor
        from repro_torch.runtime.streams import serving_streams
        decode, admission = serving_streams(self)
        ex = Executor(None, [admission, decode], slots=1, oversubscription=2)
        ex.run(max_rounds=max_steps)
        return {r.rid: r.out_tokens for r in self.requests.values()}

    # -- admission / prefill -------------------------------------------------

    def _claim(self):
        """Claim (request, slot) pairs through the two big-atomic queues."""
        n = min(len(self.admit_q), len(self.slot_q))
        if not n:
            return []
        rids, ok_r = self.admit_q.dequeue_batch(n)
        slot_ids, ok_s = self.slot_q.dequeue_batch(n)
        assert ok_r.all() and ok_s.all()      # sole consumer of both queues
        return [(int(r), int(s)) for r, s in zip(rids[:, 0], slot_ids[:, 0])]

    def _admit(self):
        pairs = self._claim()
        for j, (rid, si) in enumerate(pairs):
            try:
                self._prefill_into(si, self.requests[rid])
            except Exception:
                self._requeue_failed(si, pairs, j)
                raise

    def _requeue_failed(self, si: int, pairs, j: int) -> None:
        # The failing request is dropped, but its slot and every
        # not-yet-admitted pair go back on their rings so nothing leaks;
        # anything submitted later is re-enqueued BEHIND the survivors.
        self.slot_q.enqueue_batch(
            np.asarray([si] + [s for _, s in pairs[j + 1:]], np.uint32))
        survivors = [r for r, _ in pairs[j + 1:]]
        depth = len(self.admit_q)
        if survivors:
            later = []
            if depth:
                vals, ok = self.admit_q.dequeue_batch(depth)
                later = [int(v) for v in vals[ok, 0]]
            self.admit_q.enqueue_batch(
                np.asarray(survivors + later, np.uint32))

    def _prefill_compute(self, req: Request):
        """The device-heavy half of admission: the prefill forward + first
        token.  Touches no engine state beyond the sampling generator."""
        T = len(req.prompt)
        tokens = torch.as_tensor(np.asarray(req.prompt, np.int32)[None]).to(
            self.device)
        batch = {"tokens": tokens}
        if self.cfg.family == "vlm":
            batch["positions"] = torch.arange(
                T, dtype=torch.int32, device=self.device)[None, :, None] \
                .expand(1, T, 3)
        logits, cache, _ = forward(self.params, self.cfg, batch,
                                   mode="prefill")
        k, v = self._cache_to_layers(cache)          # [L, T, kvh, hd]
        tok = int(self._sample(logits[:, -1])[0])
        return k, v, tok

    def _prefill_commit(self, slot_idx: int, rid: int, k, v, tok: int):
        """The page-table half: alloc pages, write the prompt KV, publish
        the slot."""
        slot = self.slots[slot_idx]
        req = self.requests[rid]
        seq_id = self._next_seq
        self._next_seq += 1
        T = len(req.prompt)
        P = self.paged.page_size
        n_pages = (T + P - 1) // P
        self.paged, phys = pk.alloc_pages(
            self.paged, [seq_id] * n_pages, list(range(n_pages)))
        self.paged = pk.write_prompt(self.paged, phys, k, v)
        req.out_tokens.append(tok)
        slot.rid, slot.seq_id, slot.pos = req.rid, seq_id, T
        slot.new_tokens, slot.active = 1, True
        obs_telemetry.record(**{"serving.admitted": 1})

    def _prefill_into(self, slot_idx: int, req: Request):
        k, v, tok = self._prefill_compute(req)
        self._prefill_commit(slot_idx, req.rid, k, v, tok)

    @staticmethod
    def _cache_to_layers(cache):
        ks, vs = [], []
        for layer in cache.get("stack", ()):          # period tuple
            ks.append(layer["k"][:, 0])               # [n_full, T, kvh, hd]
            vs.append(layer["v"][:, 0])
        for layer in cache.get("tail", ()):
            ks.append(layer["k"][0][None])
            vs.append(layer["v"][0][None])
        return torch.cat(ks, 0), torch.cat(vs, 0)

    # -- decode --------------------------------------------------------------

    def _decode_batch(self, params, tokens, pos, k_dense, v_dense):
        """One batched decode step against gathered KV.  Returns (logits,
        new k/v for the produced token [L, b, kvh, hd])."""
        cfg = self.cfg
        period = len(cfg.block_pattern)
        n_full = cfg.n_layers // period
        tail_n = cfg.n_layers % period
        cache = {}
        if n_full:
            cache["stack"] = ({"k": k_dense[:n_full], "v": v_dense[:n_full]},)
        if tail_n:
            cache["tail"] = tuple(
                {"k": k_dense[n_full + j], "v": v_dense[n_full + j]}
                for j in range(tail_n))
        logits, new_cache, _ = forward(params, cfg,
                                       {"tokens": tokens, "pos": pos},
                                       mode="decode", cache=cache)
        b_idx = torch.arange(tokens.shape[0], device=tokens.device)
        p = pos.long()
        nk, nv = [], []
        if n_full:
            nk.append(new_cache["stack"][0]["k"][:, b_idx, p])
            nv.append(new_cache["stack"][0]["v"][:, b_idx, p])
        for j in range(tail_n):
            nk.append(new_cache["tail"][j]["k"][b_idx, p][None])
            nv.append(new_cache["tail"][j]["v"][b_idx, p][None])
        return logits, torch.cat(nk, 0), torch.cat(nv, 0)

    def _fused_step(self, params, pstate, tokens, pos, seq_ids):
        """The decode data path as one call: page-table lookup -> KV gather
        -> batched forward -> KV append."""
        spec = self.paged.spec
        P = spec.page_size
        pstate, phys, k_dense, v_dense, _ = pk.lookup_and_gather(
            spec, pstate, seq_ids, self.max_pages, mesh=self.mesh)
        logits, nk, nv = self._decode_batch(params, tokens, pos,
                                            k_dense, v_dense)
        b = tokens.shape[0]
        phys_page = phys[torch.arange(b, device=pos.device),
                         (pos // P).long()]
        pstate = pk.append_token_fn(spec, pstate, phys_page, pos % P, nk, nv)
        return pstate, logits

    def _drain_retires(self):
        retires, self._pending_retire = self._pending_retire, []
        return retires

    def _decode(self, live):
        logits = self._dispatch_decode(live)
        self._finish_decode(live, logits)

    def _dispatch_decode(self, live):
        P = self.paged.page_size
        dev = self.device
        seq_ids = [self.slots[i].seq_id for i in live]
        pos_np = np.asarray([self.slots[i].pos for i in live], np.int32)
        # page-boundary crossings allocate through the big-atomic table
        need = [(s, int(p) // P) for s, p in zip(seq_ids, pos_np)
                if p % P == 0]
        if self.txn_bookkeeping:
            # ONE transaction: deferred retirement deletes + this step's
            # page-table appends, all-or-nothing.
            self.paged, _ = pk.txn_bookkeep(self.paged,
                                            self._drain_retires(), need)
        elif need:
            self.paged, _ = pk.alloc_pages(
                self.paged, [n[0] for n in need], [n[1] for n in need])
        tokens = torch.as_tensor(np.asarray(
            [self.requests[self.slots[i].rid].out_tokens[-1] for i in live],
            np.int32)[:, None]).to(dev)
        pos = torch.as_tensor(pos_np).to(dev)
        if self.fused:
            pstate, logits = self._fused_step(
                self.params, self.paged.state, tokens, pos,
                torch.as_tensor(np.asarray(seq_ids, np.int32)).to(dev))
            self.paged.state = pstate
            self.dispatch_count += 1
        else:
            # The reference's v1 path: four separate dispatches per step.
            self.paged, phys = pk.lookup_pages(self.paged, seq_ids,
                                               self.max_pages)
            k_dense, v_dense, _ = pk.gather_kv(self.paged, phys)
            logits, nk, nv = self._decode_batch(self.params, tokens, pos,
                                                k_dense, v_dense)
            rows = torch.arange(len(live), device=dev)
            self.paged = pk.append_token(
                self.paged, phys[rows, (pos // P).long()], pos % P, nk, nv)
            self.dispatch_count += 4
        obs_telemetry.record(**{
            "serving.decode_steps": 1,
            "serving.dispatches": 1 if self.fused else 4,
            "serving.decode_tokens": len(live),
        })
        return logits

    def _finish_decode(self, live, logits):
        toks = self._sample(logits[:, 0])
        for j, i in enumerate(live):
            slot = self.slots[i]
            req = self.requests[slot.rid]
            req.out_tokens.append(int(toks[j]))
            slot.pos += 1
            slot.new_tokens += 1
            if slot.new_tokens >= req.max_new_tokens:
                self._retire(i)

    # -- pipelined halves (runtime.streams drives these) ---------------------

    @property
    def decode_inflight(self) -> bool:
        return self._decode_inflight

    def dispatch_decode(self, live):
        """Issue the fused decode for `live` slots WITHOUT consuming the
        logits: the paged state is committed (chained for whatever issues
        next) and the returned logits are a tensor still computing on the
        card.  `finish_decode` completes the step; exactly one decode may be
        in flight (the next step's input tokens depend on this one's)."""
        if not self.fused:
            raise RuntimeError("pipelined decode needs fused=True (the v1 "
                               "4-dispatch path has nothing to overlap)")
        if self._decode_inflight:
            raise RuntimeError("a decode is already in flight; finish it "
                               "before dispatching the next")
        self._decode_inflight = True
        return self._dispatch_decode(live)

    def finish_decode(self, live, logits) -> None:
        """Host half of a dispatched decode: sample, append tokens, retire
        finished slots (their page-table deletes defer to the next
        bookkeeping transaction, exactly as in `step()`)."""
        self._finish_decode(live, logits)
        self._decode_inflight = False

    # -- the decoupled admission halves -------------------------------------

    def admit_compute(self) -> list:
        """Claim every admissible (request, slot) pair and run their
        prefill forwards, deferring the page-table commit to
        `commit_admissions`.  Returns the admitted list (empty = nothing to
        admit)."""
        pairs = self._claim()
        admitted = []
        for j, (rid, si) in enumerate(pairs):
            try:
                k, v, tok = self._prefill_compute(self.requests[rid])
            except Exception:
                self._requeue_failed(si, pairs, j)
                raise
            admitted.append((si, rid, k, v, tok))
        return admitted

    def commit_admissions(self, admitted) -> None:
        """Publish computed admissions into the page table + slots; the
        deferred retirement deletes commit FIRST."""
        self.flush_retires()
        for si, rid, k, v, tok in admitted:
            self._prefill_commit(si, rid, k, v, tok)

    def flush_retires(self) -> None:
        """Commit deferred retirement deletes as their own transaction."""
        if self._pending_retire:
            self.paged, _ = pk.txn_bookkeep(self.paged,
                                            self._drain_retires(), [])

    def _retire(self, i):
        slot = self.slots[i]
        req = self.requests[slot.rid]
        req.done = True
        P = self.paged.page_size
        used = (slot.pos + P) // P          # pages incl. current partial
        if self.txn_bookkeeping:
            self._pending_retire.append((slot.seq_id, used))
        else:
            self.paged = pk.free_pages(self.paged, slot.seq_id, used)
        self.slots[i] = _Slot()
        self.slot_q.enqueue_batch(np.asarray([i], np.uint32))
        obs_telemetry.record(**{"serving.retired": 1})

    def _sample(self, logits):
        """Next tokens (numpy int) from logits [b, vocab]: one host read."""
        if self.requests and all(r.temperature == 0.0
                                 for r in self.requests.values()):
            return torch.argmax(logits, -1).cpu().numpy()
        temp = max(next(iter(self.requests.values())).temperature, 1e-4)
        u = torch.rand(logits.shape, generator=self._gen,
                       device=logits.device)
        u = u.clamp(min=torch.finfo(torch.float32).tiny)
        gumbel = -torch.log(-torch.log(u))
        return torch.argmax(logits.float() / temp + gumbel, -1).cpu().numpy()
