"""Paged KV cache whose page table is a CacheHash of big atomics.

The port of the JAX package's `serving/paged_kv.py`.  The page table maps a logical page key (seq_id << 20 | page_no) to a physical
page index; every lookup is a CacheHash FIND (`core.cachehash.apply_hash`),
page allocation and release are INSERT / DELETE, and the free physical
pages ride a big-atomic ring (`sync.queue.BigQueue`, LL/SC claims).

`PagedSpec` holds the static geometry, `PagedState` the device state (page
table + page pools), `PagedKV` ties them to the free ring.  Physical pages
live in one pool per K and V: [n_attn_layers, n_pages, page_size, kvh,
hd].  Functions return new states and leave the ones they were given
valid, as the reference's.

With `n_shards > 1` the page table is a mesh-sharded CacheHash
(`core.distributed`) and the free ring a sharded `BigQueue`: every
page-table batch (decode lookups, admission inserts, retirement deletes,
the bookkeeping transaction through `txn.map.transact_dist`) routes by
key owner over `spec.axis`, each shard applying its slice with its own
node pool, and every rank passes the same global batch and reads the
whole result (`distributed.apply_hash_global`).  The K/V page pools stay
replicated.  Recurrent layers (ssm / rglru) get no dense slot states here: the
reference builds them, but its engine serves only full-attention configs
and nothing reads them (recurrent configs serve through
`launch.steps.make_serve_step`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import cachehash as ch
from repro_torch.core import distributed as dsb
from repro_torch.core import engine
from repro_torch.core.layout import as_u64, resolve_device, to_word
from repro_torch.core.specs import DEFAULT_STRATEGY, HashSpec, QueueSpec
from repro_torch.models.common import ModelConfig
from repro_torch.sync.queue import BigQueue

SEQ_SHIFT = 20                     # key = seq_id << 20 | page_no
PAGE_MASK = (1 << SEQ_SHIFT) - 1


@dataclasses.dataclass(frozen=True)
class PagedSpec:
    """Static geometry of the paged cache.  With `n_shards > 1` the page
    table and the free ring shard over the mesh axis `axis`."""

    n_pages: int
    page_size: int
    max_seqs: int
    table: HashSpec
    ring: QueueSpec
    n_shards: int = 1
    axis: str = "shard"


class PagedState(NamedTuple):
    """Page table + physical pools."""

    table: object                  # ch.HashState, or this rank's shard
    #                                (distributed.DistState) when sharded
    k_pages: torch.Tensor          # [L_attn, n_pages, P, kvh, hd]
    v_pages: torch.Tensor


@dataclasses.dataclass
class PagedKV:
    """Host-side owner: spec + state + big-atomic free ring.  The engine is
    the sole owner; the mutating functions below return `self`."""

    spec: PagedSpec
    state: PagedState
    free: BigQueue
    mesh: object = None            # distributed.Mesh when spec.n_shards > 1

    @property
    def page_size(self) -> int:
        return self.spec.page_size

    @property
    def strategy(self) -> str:
        return self.spec.table.strategy

    @property
    def device(self) -> torch.device:
        return self.state.k_pages.device


def page_key(seq_id, page_no):
    """The page table's key (uint32 bits): numpy uint32 for host values,
    an int32 word tensor when either argument is a tensor."""
    if isinstance(seq_id, torch.Tensor) or isinstance(page_no, torch.Tensor):
        dev = (seq_id if isinstance(seq_id, torch.Tensor) else page_no).device
        s = as_u64(torch.as_tensor(seq_id, device=dev))
        p = as_u64(torch.as_tensor(page_no, device=dev))
        return to_word((s << SEQ_SHIFT) | p)
    return ((np.asarray(seq_id).astype(np.uint32) << np.uint32(SEQ_SHIFT))
            | np.asarray(page_no).astype(np.uint32))


def make_spec(cfg: ModelConfig, n_pages: int, page_size: int, max_seqs: int,
              strategy: str = DEFAULT_STRATEGY, *, n_shards: int = 1,
              axis: str = "shard") -> PagedSpec:
    if n_shards & (n_shards - 1):
        raise ValueError(f"n_shards must be a power of two (the page table "
                         f"is a power-of-two CacheHash): {n_shards}")
    nb = 1
    while nb < max(2 * n_pages, n_shards):
        nb *= 2
    return PagedSpec(
        n_pages=n_pages, page_size=page_size, max_seqs=max_seqs,
        table=HashSpec(nb, vw=1, strategy=strategy,
                       p_max=max(max_seqs, 64)),
        ring=QueueSpec(max(n_pages, 2), k=2, strategy=strategy,
                       p_max=max(max_seqs, 64)),
        n_shards=n_shards, axis=axis)


def init(cfg: ModelConfig, spec: PagedSpec, mesh=None, *,
         device="cuda") -> PagedKV:
    """The empty cache on `device` (with a mesh, on the mesh's device): an
    empty page table, zero pools and every physical page on the free ring
    (in descending order, as the reference's).  `spec.n_shards > 1` needs
    the mesh whose axis `spec.axis` it shards over; every rank calls it."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    l_attn = sum(k == "attn" for k in cfg.layer_kinds)
    kv = (l_attn, spec.n_pages, spec.page_size, cfg.n_kv_heads, cfg.hd)
    if spec.n_shards > 1:
        if mesh is None:
            raise ValueError("spec.n_shards > 1 requires a mesh")
        table = dsb.init_dist(mesh, _table_dspec(spec))
    else:
        table = ch.init_hash(spec.table, device=dev)
    free = BigQueue(spec=spec.ring,
                    initial_items=np.arange(spec.n_pages - 1, -1, -1,
                                            dtype=np.uint32),
                    mesh=mesh, shard_axis=spec.axis, n_shards=spec.n_shards,
                    device=dev)
    state = PagedState(table=table,
                       k_pages=torch.zeros(kv, dtype=cfg.cdtype(),
                                           device=dev),
                       v_pages=torch.zeros(kv, dtype=cfg.cdtype(),
                                           device=dev))
    return PagedKV(spec=spec, state=state, free=free, mesh=mesh)


def init_paged(cfg: ModelConfig, n_pages: int, page_size: int,
               max_seqs: int, strategy: str = None, *,
               device="cuda") -> PagedKV:
    """DEPRECATED shim: use `init(cfg, make_spec(...))`."""
    return init(cfg, make_spec(cfg, n_pages, page_size, max_seqs,
                               strategy or DEFAULT_STRATEGY), device=device)


# ---------------------------------------------------------------------------
# Page-table ops on the device state: the decode step composes these.
# ---------------------------------------------------------------------------

def _table_dspec(spec: PagedSpec):
    """The DistSpec of the sharded page table (the global-batch calls size
    its lanes to each batch)."""
    return dsb.DistSpec(spec.table, spec.axis, spec.n_shards, 1)


def _hash_apply(spec: PagedSpec, table, kind, keys, values=None, mesh=None):
    """One page-table batch on the local CacheHash (`apply_hash`: one host
    read) or, with `spec.n_shards > 1`, on the mesh-sharded one
    (`distributed.apply_hash_global`).  Returns (table', HashResult) for
    the whole batch."""
    sharded = spec.n_shards > 1
    dev = mesh.device if sharded else table.pool.device
    keys = torch.as_tensor(np.asarray(keys, np.uint32).view(np.int32)) \
        if not isinstance(keys, torch.Tensor) else keys
    q = keys.shape[0]
    # host kinds: checked on the host, uploaded, never read back
    ops = ch.make_hash_ops(np.full(q, kind, np.int32), keys.to(dev),
                           torch.zeros((q, 1), dtype=torch.int32, device=dev)
                           if values is None else values, vw=1, device=dev)
    if not sharded:
        table, res, _ = ch.apply_hash(spec.table, table, ops)
        return table, res
    table, res, _overflow = dsb.apply_hash_global(mesh, _table_dspec(spec),
                                                  table, ops)
    return table, res


def _phys(res, shape):
    """Physical pages from a FIND: the value where found, else -1."""
    return torch.where(res.found, res.value[:, 0], -1).reshape(shape)


def lookup_and_gather(spec: PagedSpec, pstate: PagedState, seq_ids,
                      n_pages_per_seq: int, mesh=None):
    """Batched page-table lookup + KV gather: one CacheHash FIND per
    (seq, page), key-owner-routed when the table is sharded, then the
    page-granular gather decode attention reads.  Returns (pstate',
    phys[b, n_pages_per_seq], k, v, valid)."""
    dev = pstate.k_pages.device
    seq_ids = torch.as_tensor(seq_ids).to(dev)
    b = seq_ids.shape[0]
    pages = torch.arange(n_pages_per_seq, device=dev)
    keys = page_key(seq_ids[:, None], pages[None, :]).reshape(-1)
    table, res = _hash_apply(spec, pstate.table, engine.FIND, keys,
                             mesh=mesh)
    phys = _phys(res, (b, n_pages_per_seq))
    pstate = pstate._replace(table=table)
    k, v, valid = gather_fn(spec, pstate, phys)
    return pstate, phys, k, v, valid


def gather_fn(spec: PagedSpec, pstate: PagedState, phys):
    """phys: int32[b, max_pages] (-1 pad) -> K/V [L, b, max_pages*P, kvh,
    hd] plus a validity mask [b, max_pages*P]."""
    b, mp = phys.shape
    P = spec.page_size
    safe = phys.clamp(min=0).long()
    k = pstate.k_pages[:, safe]            # [L, b, mp, P, kvh, hd]
    v = pstate.v_pages[:, safe]
    L = k.shape[0]
    k = k.reshape(L, b, mp * P, *k.shape[4:])
    v = v.reshape(L, b, mp * P, *v.shape[4:])
    valid = (phys >= 0).repeat_interleave(P, dim=1)
    return k, v, valid


def append_token_fn(spec: PagedSpec, pstate: PagedState, phys_page, offset,
                    k_tok, v_tok) -> PagedState:
    """Write one new token's K/V for a batch of sequences.  phys_page:
    int32[b]; offset: int32[b] in [0, P); k/v_tok: [L_attn, b, kvh, hd]."""
    L, b = k_tok.shape[0], k_tok.shape[1]
    dev = k_tok.device
    li = torch.arange(L, device=dev)[:, None].expand(L, b).reshape(-1)
    pi = phys_page.long()[None].expand(L, b).reshape(-1)
    oi = offset.long()[None].expand(L, b).reshape(-1)
    k_pages = pstate.k_pages.index_put(
        (li, pi, oi), k_tok.reshape(-1, *k_tok.shape[2:]))
    v_pages = pstate.v_pages.index_put(
        (li, pi, oi), v_tok.reshape(-1, *v_tok.shape[2:]))
    return pstate._replace(k_pages=k_pages, v_pages=v_pages)


# ---------------------------------------------------------------------------
# Host-side page lifecycle (admission / retirement, big-atomic free ring)
# ---------------------------------------------------------------------------

def _words_np(t) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def txn_bookkeep(paged: PagedKV, retires, allocs):
    """One decode step's page-table bookkeeping as ONE transaction:
    retirement deletes + page-boundary inserts commit all-or-nothing
    through the transactional map (`txn.map.transact`), with the retired
    mappings as the transaction's read set.  On a sharded page table the
    commit rides the key-owner-routed collective (`txn.map.transact_dist`),
    so cross-shard bookkeeping stays atomic.

    retires: [(seq_id, n_pages_used)]; allocs: [(seq_id, page_no)].
    Returns (paged, phys int32[len(allocs)]).  Freed physical pages go back
    on the ring BEFORE the alloc dequeues, so a same-step retire + alloc
    never starves the pool."""
    from repro_torch.txn import map as txn_map
    dev = paged.device
    q_alloc = len(allocs)
    ret_keys: list[int] = []
    for seq_id, used in retires:
        ret_keys += [int(page_key(seq_id, p)) for p in range(used)]
    if not ret_keys and not q_alloc:
        return paged, torch.zeros((0,), dtype=torch.int32, device=dev)
    if ret_keys:
        table, res = _hash_apply(paged.spec, paged.state.table, engine.FIND,
                                 ret_keys, mesh=paged.mesh)
        paged.state = paged.state._replace(table=table)
        found = res.found.cpu().numpy()
        freed = _words_np(res.value[:, 0])[found]
        if len(freed):
            ok = paged.free.enqueue_batch(freed)
            assert ok.all()               # ring is sized to hold every page
    if q_alloc > len(paged.free):
        raise RuntimeError(f"out of KV pages ({q_alloc} wanted, "
                           f"{len(paged.free)} free)")
    phys = np.zeros((0,), np.int32)
    if q_alloc:
        vals, ok = paged.free.dequeue_batch(q_alloc)
        assert ok.all()                   # guarded by the length check above
        phys = vals[:, 0].astype(np.int32)
    alloc_keys = [int(page_key(s, p)) for s, p in allocs]
    w = len(ret_keys) + q_alloc
    wval = np.zeros((1, w, 1), np.uint32)
    wval[0, len(ret_keys):, 0] = phys
    txns = txn_map.make_map_txns(
        np.asarray(ret_keys or [0], np.uint32)[None],
        np.asarray(ret_keys + alloc_keys, np.uint32)[None],
        read_mask=np.asarray([bool(ret_keys)] * max(len(ret_keys), 1))[None],
        write_del=np.asarray([True] * len(ret_keys)
                             + [False] * q_alloc)[None],
        write_value=wval, device=dev)
    if paged.spec.n_shards == 1:
        table, _res = txn_map.transact(paged.spec.table, paged.state.table,
                                       txns, None)
    else:
        table, _res = txn_map.transact_dist(
            paged.mesh, _table_dspec(paged.spec),
            paged.state.table, txns, None)
    paged.state = paged.state._replace(table=table)
    return paged, torch.as_tensor(phys).to(dev)


def alloc_pages(paged: PagedKV, seq_ids, page_nos):
    """Map (seq, page_no) -> fresh physical pages via CacheHash INSERT.
    Physical pages come off the big-atomic free ring (LL/SC dequeues).
    Returns (paged, phys int32[q])."""
    q = len(seq_ids)
    if q > len(paged.free):
        raise RuntimeError(f"out of KV pages ({q} wanted, "
                           f"{len(paged.free)} free)")
    vals, ok = paged.free.dequeue_batch(q)
    assert ok.all()                       # guarded by the length check above
    phys = vals[:, 0].astype(np.int32)
    dev = paged.device
    table, _ = _hash_apply(
        paged.spec, paged.state.table, engine.INSERT,
        page_key(np.asarray(seq_ids), np.asarray(page_nos)),
        torch.as_tensor(phys[:, None]).to(dev), mesh=paged.mesh)
    paged.state = paged.state._replace(table=table)
    return paged, torch.as_tensor(phys).to(dev)


def lookup_pages(paged: PagedKV, seq_ids, n_pages_per_seq: int):
    """Batched page-table lookup: seq b, pages 0..max -> phys[b, max]
    (-1 where unmapped), one CacheHash FIND per (seq, page)."""
    seq_ids = np.asarray(seq_ids, np.uint32)
    b = seq_ids.shape[0]
    keys = page_key(seq_ids[:, None],
                    np.arange(n_pages_per_seq, dtype=np.uint32)[None, :])
    table, res = _hash_apply(paged.spec, paged.state.table, engine.FIND,
                             keys.reshape(-1), mesh=paged.mesh)
    paged.state = paged.state._replace(table=table)
    return paged, _phys(res, (b, n_pages_per_seq))


def free_pages(paged: PagedKV, seq_id: int, n_pages_used: int) -> PagedKV:
    """Release a finished sequence's pages: CacheHash DELETE + free-ring
    push."""
    if n_pages_used == 0:
        return paged
    keys = page_key(np.full((n_pages_used,), seq_id, np.uint32),
                    np.arange(n_pages_used, dtype=np.uint32))
    table, res = _hash_apply(paged.spec, paged.state.table, engine.FIND,
                             keys, mesh=paged.mesh)
    phys = _words_np(res.value[:, 0])[res.found.cpu().numpy()]
    table, _ = _hash_apply(paged.spec, table, engine.DELETE, keys,
                           mesh=paged.mesh)
    if len(phys):
        ok = paged.free.enqueue_batch(phys)
        assert ok.all()                   # ring is sized to hold every page
    paged.state = paged.state._replace(table=table)
    return paged


# ---------------------------------------------------------------------------
# Physical page I/O (host call style; the fused step uses the *_fn forms)
# ---------------------------------------------------------------------------

def write_prompt(paged: PagedKV, phys_pages, layer_k, layer_v) -> PagedKV:
    """Scatter a prompt's K/V into its pages.  layer_k/v: [L_attn, T, kvh,
    hd] (one sequence); phys_pages: int32[ceil(T/P)]."""
    P = paged.page_size
    L, T = layer_k.shape[0], layer_k.shape[1]
    n_full = T // P
    phys_pages = torch.as_tensor(phys_pages).to(layer_k.device).long()
    k_pages = paged.state.k_pages.clone()
    v_pages = paged.state.v_pages.clone()
    if n_full:
        k_pages[:, phys_pages[:n_full]] = layer_k[:, :n_full * P].reshape(
            L, n_full, P, *layer_k.shape[2:])
        v_pages[:, phys_pages[:n_full]] = layer_v[:, :n_full * P].reshape(
            L, n_full, P, *layer_v.shape[2:])
    rem = T - n_full * P
    if rem:
        k_pages[:, phys_pages[n_full], :rem] = layer_k[:, n_full * P:]
        v_pages[:, phys_pages[n_full], :rem] = layer_v[:, n_full * P:]
    paged.state = paged.state._replace(k_pages=k_pages, v_pages=v_pages)
    return paged


def append_token(paged: PagedKV, phys_page, offset, k_tok, v_tok) -> PagedKV:
    """Write one new token's K/V for a batch of sequences (host call)."""
    paged.state = append_token_fn(paged.spec, paged.state, phys_page, offset,
                                  k_tok, v_tok)
    return paged


def gather_kv(paged: PagedKV, phys):
    """Host-call form of `gather_fn` (v1 signature)."""
    return gather_fn(paged.spec, paged.state, phys)
