"""Mesh-sharded big atomics over `torch.distributed` (PyTorch).

A structure's n cells shard over one mesh axis; each shard owns a
contiguous block of cells (or the `slot % n_shards` residue class with
`interleave=True`) and its own `p_local`-lane slice of the op batch.  One
collective round-trip executes a globally linearizable batch over the full
op schema:

  1. route   — each rank buckets its lanes by owner shard and exchanges
               them with ONE fixed-capacity `all_to_all_single` (capacity
               `cap` per (src, dst) pair), every field packed into one
               int32 buffer: kind, local slot, expected, desired, link
               version and a link-matches-slot bit, so the owner can
               arbitrate links it has never seen (the routed per-owner
               `LinkCtx`).  Lanes beyond capacity are not silently
               dropped: they surface in the returned per-lane `overflow`
               mask with `success=False` and leave the table untouched.
  2. apply   — every shard runs the local engine round on the lanes it
               owns: `engine.run_round` over `engine.round_for`, which on
               a card is the hand-written kernel round (`round_prologue`,
               `fast_round` / `slow_round`, `round_epilogue`) and on the
               CPU the plain `linearize`, so every registered layout runs
               sharded unchanged.  The order is (owner, src shard, lane):
               a fixed total order, so the result equals a sequential
               application in that order (`linearization_order` emits it).
  3. return  — value, success and the LL-linked version ride one inverse
               `all_to_all_single` back to the issuing lane, which merges
               them into its per-lane `LinkCtx`.

The execution model is multi-controller: every rank of the mesh calls the
same function with its own shard's state and its own lanes (lane j of the
rank on shard i is global lane `i * p_local + j`, as the reference lays
its global batch out source-major).  A mesh (`make_mesh`) holds one
process group per axis and one over all its ranks: NCCL with tensors on
the card, gloo with tensors on the CPU or on the card (staged through the
host, so several ranks can share one card).  It may hold a subset of the
world (`ranks=`, as the reference builds meshes from device subsets); a
rank outside it has `member` False, holds no shard and enters none of its
collectives, and every entry point given such a mesh raises.  Ranks that
differ only along an axis the spec does not shard over compute the same
shard, as the reference's replicas do.  `agree_max` is the one
all_reduce a host decision needs to be the same on every rank.

`apply_global` / `apply_hash_global` are the single-controller form the
reference's clients call: every rank passes the same GLOBAL batch, runs
its own `p_local` lanes of it, and all-gathers every lane's result (and
link) over the shard axis, so host logic that branches on results (a
queue's claim loop, a map's pending set) sees the same values on every
rank and the ranks issue the same collectives.

`apply_hash` runs the same round for a `HashSpec` CacheHash (ops route by
key owner, every shard applies its slice with `cachehash.apply_hash`);
`mcas` is the two-round prepare/commit cross-shard MCAS.  The host-side
`linearization_order` and the word counts `collective_words` /
`mcas_collective_words` are the reference's, line for line.  The v1
surface (`ShardedTable`, `init_sharded`, `make_apply`, `reference_apply`)
survives as deprecation shims.

Host reads: `apply` reads the kinds back once (`engine.check_kinds`) and
nothing else on the kernel tier; `apply_hash` adds `cachehash.apply_hash`'s
one read; `mcas` reads the gathered batch sizes once and one flag pair a
round (after the round's `all_reduce`, which keeps every rank in the same
sequence of collectives).  `logical`, `versions` and `hash_items`
all-gather over the shard axes and return the global view on every rank.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import cachehash as ch
from repro_torch.core import engine
from repro_torch.core import registry
from repro_torch.core.deprecation import warn_once
from repro_torch.core.layout import (WORD_DTYPE, TableState, as_words,
                                     resolve_device)
from repro_torch.core.specs import AtomicSpec, HashSpec
from repro_torch.obs import telemetry as obs_telemetry


# ---------------------------------------------------------------------------
# The mesh: one process group per axis over the default group.
# ---------------------------------------------------------------------------

class Mesh:
    """This rank's view of a logical device mesh.

    shape / axis_names: the mesh geometry, laid row-major over `ranks` (the
    world ranks the mesh holds, in order); member: whether this rank is one
    of them; coords: this rank's coordinate on each axis (empty outside the
    mesh); groups: per axis, the process group of the ranks that differ
    from this one only along that axis (in coordinate order; empty outside
    the mesh); group: every rank of the mesh as one group (None outside
    it); device: where the mesh's tensors live.  A rank outside the mesh
    holds no shard of it and enters none of its collectives: every entry
    point of this module given such a mesh raises."""

    def __init__(self, shape, axis_names, coords, groups, device, *,
                 ranks=None, group=None):
        self.shape = tuple(shape)
        self.axis_names = tuple(axis_names)
        self.ranks = tuple(range(math.prod(self.shape))) if ranks is None \
            else tuple(int(r) for r in ranks)
        self.member = coords is not None
        self.coords = dict(zip(self.axis_names, coords)) if self.member \
            else {}
        self.groups = groups
        self.group = group
        self.device = device

    def size(self, axis: str) -> int:
        return dict(zip(self.axis_names, self.shape))[axis]

    def __repr__(self):
        where = f"coords={self.coords}" if self.member else "not a member"
        return (f"Mesh(shape={self.shape}, axis_names={self.axis_names}, "
                f"ranks={self.ranks}, {where}, device={self.device})")


def _member(mesh) -> None:
    """Raise on a rank outside `mesh` (it holds no shard and would wait in
    collectives its mesh's ranks never join)."""
    if not getattr(mesh, "member", True):
        raise ValueError(f"this rank is not a member of {mesh!r}: it holds "
                         "no shard and enters none of its collectives")


def _backend_carries(backend: str, device: torch.device) -> bool:
    """Can a group of `backend` run all_to_all / all_gather on tensors of
    `device`?  NCCL carries card tensors only; gloo carries CPU tensors
    and card tensors too, staged through the host (so several ranks can
    share one card).  `backend` may list one per device type:
    "cpu:gloo,cuda:nccl"."""
    backend = str(backend).lower()
    if device.type == "cuda":
        return "nccl" in backend or "gloo" in backend
    return "gloo" in backend


def make_mesh(shape, axis_names, *, ranks=None, device="cuda",
              timeout=None) -> Mesh:
    """The mesh `shape` x `axis_names` over `ranks` of the initialised
    default process group (default: the first prod(shape) ranks of the
    world).  The mesh's rank i sits at the row-major coordinate of i.
    Every rank of the world calls it, in the mesh or not, and creates
    every subgroup, its own or not, in the same order (`dist.new_group` is
    collective over the world); a rank keeps its own.  A rank outside
    `ranks` gets a mesh with `member` False.  `timeout` (a
    `datetime.timedelta`) bounds each collective of those subgroups; None
    is `dist.new_group`'s default, which does not inherit the default
    group's.  Raises when the group's backend cannot carry tensors on
    `device` (NCCL with "cpu")."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    shape, axis_names = tuple(int(x) for x in shape), tuple(axis_names)
    if len(shape) != len(axis_names) or len(set(axis_names)) != len(shape):
        raise ValueError(f"mesh shape {shape} and axis names {axis_names} "
                         "must pair up, names distinct")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised default process "
                           "group (torch.distributed.init_process_group)")
    world = dist.get_world_size()
    size = math.prod(shape)
    ranks = list(range(size)) if ranks is None else [int(r) for r in ranks]
    if len(ranks) != size or len(set(ranks)) != size or \
            not all(0 <= r < world for r in ranks):
        raise ValueError(f"mesh {shape} holds {size} ranks; got ranks "
                         f"{ranks} of a world of {world}")
    backend = dist.get_backend()
    if not _backend_carries(backend, dev):
        raise ValueError(f"a {backend!r} process group cannot carry tensors "
                         f"on {dev}: use nccl or gloo with cuda, gloo with "
                         "cpu")
    rank = dist.get_rank()
    grid = np.asarray(ranks).reshape(shape)
    groups = {}
    for a, name in enumerate(axis_names):
        lines = np.moveaxis(grid, a, -1).reshape(-1, shape[a])
        for line in lines.tolist():             # every rank, same order
            group = dist.new_group(line, timeout=timeout)
            if rank in line:
                groups[name] = group
    whole = dist.group.WORLD if size == world and ranks == sorted(ranks) \
        else dist.new_group(ranks, timeout=timeout)
    if rank not in ranks:
        return Mesh(shape, axis_names, None, {}, dev, ranks=ranks)
    coords = np.unravel_index(ranks.index(rank), shape)
    return Mesh(shape, axis_names, [int(c) for c in coords], groups, dev,
                ranks=ranks, group=whole)


def agree_max(mesh: Mesh, values) -> list:
    """The elementwise max of `values` (floats) over every rank of the
    mesh, returned on each: ONE `all_reduce(MAX)` over the mesh's group,
    so host decisions made from it are the same on every rank.  A mesh of
    one rank returns `values` and calls no collective."""
    _member(mesh)
    values = [float(v) for v in values]
    if len(mesh.ranks) == 1 or not values:
        return values
    dev = torch.device("cpu") if _backend_carries(
        dist.get_backend(mesh.group), torch.device("cpu")) else mesh.device
    t = torch.tensor(values, dtype=torch.float64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return t.tolist()                                  # the host read


# ---------------------------------------------------------------------------
# Specs and state.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DistSpec:
    """Static shape of a sharded structure: an inner spec + mesh geometry.

    inner:          the structure being sharded (`AtomicSpec` or `HashSpec`);
                    its strategy resolves through the registry per shard.
    axis:           mesh axis name the cells and lanes shard over.
    n_shards:       devices along `axis` (cells split n / n_shards each).
    p_local:        op lanes issued per device; p_global = n_shards * p_local.
    route_capacity: per-(src, dst) slots in the all_to_all buffers (default
                    p_local, which can never overflow ops a device issues).
                    The collective bytes are EXACTLY proportional to this.
    dedup_loads:    loads of one cell from one source device whose cell sees
                    only loads from that source route ONCE; duplicates are
                    filled locally from the representative (safe: the order
                    is source-major, such loads are adjacent).
    interleave:     owner = slot % n_shards instead of contiguous blocks
                    (tables only; spreads contiguous-slot hotspots).
    n_nodes:        > 1 factors the shard axis as (n_nodes, devs_per_node)
                    and routes HIERARCHICALLY (tables only): phase 1 is an
                    intra-node all_to_all over `axis` that combines each
                    node's lanes onto the relay device whose in-node index
                    matches the owner's, phase 2 is ONE cross-node
                    all_to_all over `node_axis`.  Cross-node words drop from
                    n_shards*cap to n_nodes*node_capacity per device.
    node_axis:      mesh axis of size n_nodes the cross-node hop runs over.
    node_capacity:  per-(relay, dst-node) slots in the phase-2 buffers
                    (default devs_per_node * cap, which can never overflow).
    """

    inner: Any                       # AtomicSpec | HashSpec
    axis: str = "shard"
    n_shards: int = 1
    p_local: int = 64
    route_capacity: int | None = None
    dedup_loads: bool = False
    interleave: bool = False
    n_nodes: int = 1
    node_axis: str = "node"
    node_capacity: int | None = None

    def __post_init__(self):
        if self.n_shards <= 0 or self.p_local <= 0:
            raise ValueError(f"mesh geometry must be positive: {self}")
        if self.n_nodes <= 0:
            raise ValueError("n_nodes must be positive")
        if self.n_nodes > 1:
            if isinstance(self.inner, HashSpec):
                raise ValueError("hierarchical routing applies to tables "
                                 "only (hash ops route flat)")
            if self.n_shards % self.n_nodes:
                raise ValueError(f"n_shards={self.n_shards} not divisible "
                                 f"by n_nodes={self.n_nodes}")
        if self.node_capacity is not None and self.node_capacity <= 0:
            raise ValueError("node_capacity must be positive")
        if isinstance(self.inner, HashSpec):
            if self.interleave:
                raise ValueError("interleave applies to tables only (hash "
                                 "buckets route by hash top bits)")
            if self.dedup_loads:
                raise ValueError("dedup_loads applies to tables only (hash "
                                 "FINDs are not dedup'd)")
            if self.inner.nb % self.n_shards:
                raise ValueError(f"nb={self.inner.nb} not divisible by "
                                 f"n_shards={self.n_shards}")
        elif isinstance(self.inner, AtomicSpec):
            if self.inner.n % self.n_shards:
                raise ValueError(f"n={self.inner.n} not divisible by "
                                 f"n_shards={self.n_shards}")
        else:
            raise TypeError(f"inner must be AtomicSpec or HashSpec: "
                            f"{type(self.inner)}")
        if self.route_capacity is not None and self.route_capacity <= 0:
            raise ValueError("route_capacity must be positive")

    # -- derived geometry ----------------------------------------------------

    @property
    def is_hash(self) -> bool:
        return isinstance(self.inner, HashSpec)

    @property
    def n_global(self) -> int:
        return self.inner.nb if self.is_hash else self.inner.n

    @property
    def n_local(self) -> int:
        return self.n_global // self.n_shards

    @property
    def p_global(self) -> int:
        return self.n_shards * self.p_local

    @property
    def cap(self) -> int:
        return self.route_capacity or self.p_local

    @property
    def devs_per_node(self) -> int:
        return self.n_shards // self.n_nodes

    @property
    def cap2(self) -> int:
        """Phase-2 per-(relay, dst-node) capacity (hierarchical only)."""
        return self.node_capacity or self.devs_per_node * self.cap

    def local_spec(self):
        """The per-shard spec the local engine runs (same strategy name, so
        the registry resolves the same `StrategyImpl` on every shard)."""
        if self.is_hash:
            return dataclasses.replace(self.inner, nb=self.n_local)
        return dataclasses.replace(self.inner, n=self.n_local)


class DistState(NamedTuple):
    """This rank's shard of a sharded structure.

    local: the shard's own state, whatever the strategy's `init` builds
           (`TableState`) or `cachehash.init_hash` builds (`HashState`);
           the distribution layer never looks inside it.
    mesh:  the mesh it lives on (`logical`, `versions` and `hash_items`
           gather over it)."""

    local: Any
    mesh: Any = None


def _check_mesh(mesh: Mesh, dspec: DistSpec) -> None:
    if dspec.n_nodes > 1:
        got = (mesh.size(dspec.node_axis), mesh.size(dspec.axis))
        want = (dspec.n_nodes, dspec.devs_per_node)
        if got != want:
            raise ValueError(f"mesh axes ({dspec.node_axis!r}, "
                             f"{dspec.axis!r}) have {got} devices, spec "
                             f"says {want}")
    elif mesh.size(dspec.axis) != dspec.n_shards:
        raise ValueError(f"mesh axis {dspec.axis!r} has "
                         f"{mesh.size(dspec.axis)} devices, spec "
                         f"says {dspec.n_shards}")


def shard_index(mesh: Mesh, dspec: DistSpec) -> int:
    """The shard this rank holds: its coordinate on `axis` (hierarchical
    specs: node * devs_per_node + in-node index, the reference's
    `P((node_axis, axis))` placement)."""
    if dspec.n_nodes > 1:
        return (mesh.coords[dspec.node_axis] * dspec.devs_per_node
                + mesh.coords[dspec.axis])
    return mesh.coords[dspec.axis]


def init_dist(mesh: Mesh, dspec: DistSpec, initial=None) -> DistState:
    """This rank's initial shard.  `initial` (tables only) is the word[n, k]
    array (numpy, or a word tensor: the shard is copied from it on the
    mesh's device) of initial GLOBAL logical values; the shard takes its
    block (or, with `interleave`, its residue class `initial[i::s]`)."""
    s = dspec.n_shards
    _member(mesh)
    _check_mesh(mesh, dspec)
    lsp = dspec.local_spec()
    i = shard_index(mesh, dspec)
    if dspec.is_hash:
        if initial is not None:
            raise ValueError("hash tables initialize empty; insert instead")
        return DistState(ch.init_hash(lsp, device=mesh.device), mesh)
    shard = None
    if initial is not None:
        if not isinstance(initial, torch.Tensor):
            initial = np.asarray(initial)
        if tuple(initial.shape) != (dspec.n_global, lsp.k):
            raise ValueError(f"initial shape {tuple(initial.shape)} != "
                             f"({dspec.n_global}, {lsp.k})")
        shard = (initial[i::s] if dspec.interleave
                 else initial[i * dspec.n_local:(i + 1) * dspec.n_local])
        shard = as_words(shard, mesh.device).clone() \
            if isinstance(shard, torch.Tensor) else np.ascontiguousarray(shard)
    return DistState(engine.init(lsp, shard, device=mesh.device), mesh)


def init_dist_ctx(mesh: Mesh, dspec: DistSpec) -> engine.LinkCtx:
    """A fresh p_local-lane LinkCtx for this rank's lanes."""
    _member(mesh)
    return engine.init_ctx(dspec.p_local, dspec.inner.k, device=mesh.device)


# ---------------------------------------------------------------------------
# The route -> apply -> return round (tables: full LOAD/STORE/CAS/LL/SC/
# VALIDATE schema with a routed per-owner LinkCtx).
# ---------------------------------------------------------------------------

def _floordiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _owner_and_local(dspec: DistSpec, slot):
    """Owner shard + local cell index of each (table) global slot: `//`
    and `%` floor, as the reference's."""
    s = dspec.n_shards
    if dspec.interleave:
        return torch.remainder(slot, s), _floordiv(slot, s)
    return (_floordiv(slot, dspec.n_local).clamp(0, s - 1),
            torch.remainder(slot, dspec.n_local))


def _inverse(order):
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], dtype=order.dtype,
                              device=order.device)
    return inv


def _dst_ranks(owner, cap: int, s: int, p: int):
    """Rank of each lane within its (src, dst) bucket + the fits mask."""
    order = torch.argsort(owner, stable=True)
    s_owner = owner[order]
    idx = torch.arange(p, dtype=torch.int64, device=owner.device)
    seg_start = torch.ones(p, dtype=torch.bool, device=owner.device)
    seg_start[1:] = s_owner[1:] != s_owner[:-1]
    start = torch.cummax(torch.where(seg_start, idx, -1), 0).values
    rank = (idx - start)[_inverse(order)]
    fits = (rank < cap) & (owner < s)
    return rank, fits


def _packer(dst, size: int):
    """Masked scatter of [p, W] int32 lane rows into a [size, W] send
    buffer; `dst == size` drops (a spare last row, sliced off).  `fill`
    is the [W] row an empty slot holds."""
    def pack(rows, fill):
        buf = fill.expand(size + 1, -1).clone()
        buf[dst] = rows
        return buf[:size]
    return pack


def _a2a(group, s: int, cap: int):
    """ONE `all_to_all_single` of a packed [s * cap, W] int32 buffer:
    block j goes to the group's rank j; returns the received [s, cap, W]."""
    def go(buf):
        buf = buf.contiguous()
        out = torch.empty_like(buf)
        dist.all_to_all_single(out, buf, group=group)
        return out.reshape(s, cap, -1)
    return go


def _i32(x):
    return x.to(torch.int32)


def _cols(r, a: int, b: int | None = None):
    """Columns a (or a:b) of a received [rows, W] buffer as a contiguous
    tensor, as the round's kernels read their operands."""
    return (r[:, a] if b is None else r[:, a:b]).contiguous()


@functools.lru_cache(maxsize=64)
def _row(*vals, k_cols=(), device):
    """A fill row: scalar columns then zero word blocks of the given
    widths, as one int32 [W] tensor, made by fills on `device` (no copy
    from the host, which would wait on the stream); read only."""
    parts = [torch.full((1,), v, dtype=torch.int32, device=device)
             for v in vals]
    parts.append(torch.zeros(sum(k_cols), dtype=torch.int32, device=device))
    return torch.cat(parts)


def _dedup(kind, slot, n: int, p: int):
    """Source-side load dedup: in each same-slot group whose active lanes
    are ALL loads, every load after the first becomes IDLE and inherits the
    first lane's routed answer.  Returns (kind', rep[p])."""
    lane = torch.arange(p, dtype=torch.int64, device=kind.device)
    active = kind != engine.IDLE
    key = torch.where(active, slot, n)              # idle lanes group apart
    d_order = torch.argsort(key, stable=True)
    d_inv = _inverse(d_order)
    ds = key[d_order]
    dk = kind[d_order]
    _, d_start, start_idx, end_idx = engine._segments(ds)
    nonload = (dk != engine.LOAD) & (ds < n)
    # the whole segment's any, read at the segment's start
    any_nonload = engine._any_from_here(nonload, lane, end_idx)[start_idx]
    dup = (dk == engine.LOAD) & (ds < n) & ~any_nonload & ~d_start
    rep = torch.where(dup, d_order[start_idx], d_order)[d_inv]
    return torch.where(rep != lane, engine.IDLE, kind), rep


def _gather_back(b, owner, fits, rank, s: int):
    """Each source lane's row of the returned [s, cap, W] buffer (the
    reference's clipped owner / rank gather; unfit lanes read row 0)."""
    safe_owner = owner.clamp(0, s - 1).long()
    safe_pos = torch.where(fits, rank, 0).long()
    return b[safe_owner, safe_pos]


def _local_round(lsp, st, octx, rops):
    """The owner's round: the layout's engine round (the kernel round on
    a card), updating the shard's state in place."""
    impl = registry.get_strategy(lsp.strategy)
    st, nctx, res, _ = engine.run_round(impl, engine.round_for(lsp, impl),
                                        st, octx, rops, donate=True)
    return st, nctx, res


def _merge_ctx(ctx, slot, kind, executed, value, ret_ver):
    is_ll = executed & (kind == engine.LL)
    is_sc = executed & (kind == engine.SC)     # dropped SCs keep their link
    return engine.LinkCtx(
        slot=torch.where(is_ll, slot, ctx.slot),
        version=torch.where(is_ll, ret_ver, ctx.version),
        value=torch.where(is_ll[:, None], value, ctx.value),
        linked=torch.where(is_ll, True,
                           torch.where(is_sc, False, ctx.linked)))


def _table_round(mesh: Mesh, dspec: DistSpec, st, ctx, ops):
    """The flat route -> apply -> return round on this rank's p_local
    lanes.  Out: [s, cap, 2k+4] (kind, local slot, expected[k],
    desired[k], link version, link ok); back: [s, cap, k+2] (value[k],
    success, linked version)."""
    s, cap = dspec.n_shards, dspec.cap
    lsp: AtomicSpec = dspec.local_spec()
    p_local, k = dspec.p_local, lsp.k
    dev = ops.kind.device
    kind, slot = ops.kind, ops.slot
    active0 = kind != engine.IDLE

    rep = torch.arange(p_local, dtype=torch.int64, device=dev)
    if dspec.dedup_loads:
        kind, rep = _dedup(kind, slot, dspec.n_global, p_local)
    active = kind != engine.IDLE

    owner, lslot = _owner_and_local(dspec, slot)
    owner = torch.where(active, owner, s)
    rank, fits = _dst_ranks(owner, cap, s, p_local)

    # -- route out: ops + the link info the owner needs to arbitrate --------
    link_ok = ctx.linked & (ctx.slot == slot)     # global-slot compare
    dst = torch.where(fits, owner * cap + rank, s * cap)
    lanes = torch.cat([_i32(torch.where(fits, kind, engine.IDLE))[:, None],
                       _i32(lslot)[:, None], ops.expected, ops.desired,
                       ctx.version[:, None], _i32(link_ok)[:, None]], 1)
    pack = _packer(dst, s * cap)
    go = _a2a(mesh.groups[dspec.axis], s, cap)
    r = go(pack(lanes, _row(engine.IDLE, 0, k_cols=(2 * k, 2),
                            device=dev))).reshape(s * cap, -1)
    r_lok = r[:, 2 * k + 3] != 0
    r_slot = _cols(r, 1)

    # -- apply: the owner's engine round against a routed per-owner ctx ------
    octx = engine.LinkCtx(
        slot=torch.where(r_lok, r_slot, -1), version=_cols(r, 2 * k + 2),
        value=torch.zeros((s * cap, k), dtype=WORD_DTYPE, device=dev),
        linked=r_lok)
    rops = engine.OpBatch(_cols(r, 0), r_slot, _cols(r, 2, 2 + k),
                          _cols(r, 2 + k, 2 + 2 * k))
    st, new_octx, res = _local_round(lsp, st, octx, rops)

    # -- route back: values, success, and the LL-linked version -------------
    b = go(torch.cat([res.value, _i32(res.success)[:, None],
                      new_octx.version[:, None]], 1))
    row = _gather_back(b, owner, fits, rank, s)
    value = torch.where(fits[:, None], row[:, :k], 0)[rep]
    success = (fits & (row[:, k] != 0))[rep]
    overflow = active0 & ~fits[rep]
    nctx = _merge_ctx(ctx, slot, kind, fits, value, row[:, k + 1])
    return st, nctx, value, success, overflow


def _table_round_2level(mesh: Mesh, dspec: DistSpec, st, ctx, ops):
    """Hierarchical route -> apply -> return: intra-node combine onto the
    relay device whose in-node index matches the owner's, then ONE
    cross-node all_to_all.

    The owner of shard o = o_node * d + o_dev sits at mesh coordinate
    (o_node, o_dev); phase 1 (over `axis`, within each node) moves every
    lane to the local device with index o_dev, phase 2 (over `node_axis`)
    moves it to the owner node.  Owner-side lane order is [src_node,
    phase-2 rank], and phase-2 ranks follow relay-lane order [src_dev,
    phase-1 rank]: the claimed total order is (owner, src node, src dev,
    lane).  Capacity rejects at EITHER hop surface in the returned
    per-lane overflow mask.  Phase 1 out [d, cap1, 2k+5] (the owner node
    rides along), phase 2 out [nn, cap2, 2k+4], back [nn, cap2, k+2] then
    [d, cap1, k+3] (the executed bit rides the last hop)."""
    nn, d = dspec.n_nodes, dspec.devs_per_node
    cap1, cap2 = dspec.cap, dspec.cap2
    lsp: AtomicSpec = dspec.local_spec()
    p_local, k = dspec.p_local, lsp.k
    dev = ops.kind.device
    kind, slot = ops.kind, ops.slot
    active0 = kind != engine.IDLE

    rep = torch.arange(p_local, dtype=torch.int64, device=dev)
    if dspec.dedup_loads:
        kind, rep = _dedup(kind, slot, dspec.n_global, p_local)
    active = kind != engine.IDLE

    owner, lslot = _owner_and_local(dspec, slot)
    o_node = torch.where(active, _floordiv(owner, d), nn)
    o_dev = torch.where(active, torch.remainder(owner, d), d)

    # -- phase 1 out: intra-node combine onto the o_dev relay ---------------
    link_ok = ctx.linked & (ctx.slot == slot)
    rank1, fits1 = _dst_ranks(o_dev, cap1, d, p_local)
    dst1 = torch.where(fits1, o_dev * cap1 + rank1, d * cap1)
    go1 = _a2a(mesh.groups[dspec.axis], d, cap1)
    lanes1 = torch.cat([_i32(torch.where(fits1, kind, engine.IDLE))[:, None],
                        _i32(lslot)[:, None], _i32(o_node)[:, None],
                        ops.expected, ops.desired, ctx.version[:, None],
                        _i32(link_ok)[:, None]], 1)
    r1 = go1(_packer(dst1, d * cap1)(
        lanes1, _row(engine.IDLE, 0, nn, k_cols=(2 * k, 2), device=dev))
    ).reshape(d * cap1, -1)

    # -- phase 2 out: ONE cross-node hop to the owner node ------------------
    key2 = torch.where(r1[:, 0] != engine.IDLE, r1[:, 2], nn)
    rank2, fits2 = _dst_ranks(key2, cap2, nn, d * cap1)
    dst2 = torch.where(fits2, key2 * cap2 + rank2, nn * cap2)
    go2 = _a2a(mesh.groups[dspec.node_axis], nn, cap2)
    lanes2 = torch.cat([torch.where(fits2, r1[:, 0], engine.IDLE)[:, None],
                        r1[:, 1:2], r1[:, 3:]], 1)
    r2 = go2(_packer(dst2, nn * cap2)(
        lanes2, _row(engine.IDLE, 0, k_cols=(2 * k, 2), device=dev))
    ).reshape(nn * cap2, -1)
    r2_lok = r2[:, 2 * k + 3] != 0
    r2_slot = _cols(r2, 1)

    # -- apply at the owner (same engine round as the flat path) ------------
    octx = engine.LinkCtx(
        slot=torch.where(r2_lok, r2_slot, -1), version=_cols(r2, 2 * k + 2),
        value=torch.zeros((nn * cap2, k), dtype=WORD_DTYPE, device=dev),
        linked=r2_lok)
    rops = engine.OpBatch(_cols(r2, 0), r2_slot, _cols(r2, 2, 2 + k),
                          _cols(r2, 2 + k, 2 + 2 * k))
    st, new_octx, res = _local_round(lsp, st, octx, rops)

    # -- return hop 2: owner node -> relay ----------------------------------
    b2 = go2(torch.cat([res.value, _i32(res.success)[:, None],
                        new_octx.version[:, None]], 1))
    row2 = _gather_back(b2, key2, fits2, rank2, nn)
    v1 = torch.where(fits2[:, None], row2[:, :k], 0)
    s1 = fits2 & (row2[:, k] != 0)

    # -- return hop 1: relay -> source (the fits2 bit rides back so the
    #    source learns which lanes ACTUALLY executed) ------------------------
    b1 = go1(torch.cat([v1, _i32(s1)[:, None], row2[:, k + 1:k + 2],
                        _i32(fits2)[:, None]], 1))
    row1 = _gather_back(b1, o_dev, fits1, rank1, d)
    executed = fits1 & (row1[:, k + 2] != 0)
    value = torch.where(executed[:, None], row1[:, :k], 0)[rep]
    success = (executed & (row1[:, k] != 0))[rep]
    overflow = active0 & ~executed[rep]
    nctx = _merge_ctx(ctx, slot, kind, executed, value, row1[:, k + 1])
    return st, nctx, value, success, overflow


def _pad_ops(ops: engine.OpBatch, p: int) -> engine.OpBatch:
    """IDLE-pad the lane axis up to p (callers may issue fewer lanes)."""
    q = ops.kind.shape[0]
    if q == p:
        return ops
    pad, k, dev = p - q, ops.desired.shape[1], ops.kind.device
    return engine.OpBatch(
        torch.cat([ops.kind, torch.full((pad,), engine.IDLE,
                                        dtype=torch.int32, device=dev)]),
        torch.cat([ops.slot, torch.zeros(pad, dtype=torch.int32,
                                         device=dev)]),
        torch.cat([ops.expected, torch.zeros((pad, k), dtype=WORD_DTYPE,
                                             device=dev)]),
        torch.cat([ops.desired, torch.zeros((pad, k), dtype=WORD_DTYPE,
                                            device=dev)]))


def _pad_ctx(ctx: engine.LinkCtx, p: int, k: int) -> engine.LinkCtx:
    q = ctx.slot.shape[0]
    if q == p:
        return ctx
    blank = engine.init_ctx(p - q, k, device=ctx.slot.device)
    return engine.LinkCtx(*[torch.cat([a, b]) for a, b in zip(ctx, blank)])


def _check_width(q: int, dspec: DistSpec) -> None:
    if q > dspec.p_local:
        raise ValueError(f"batch width {q} > p_local {dspec.p_local}")


def _own(local: TableState, donate: bool) -> TableState:
    """The shard's table, copied unless the caller donates it."""
    return local if donate else TableState(*(x.clone() for x in local))


def apply(mesh: Mesh, dspec: DistSpec, dstate: DistState, ops: engine.OpBatch,
          ctx: engine.LinkCtx | None = None, *, donate: bool = False):
    """Linearize a mixed table batch across the mesh in ONE collective round.

    Every rank of the mesh calls this with its own shard's `dstate` and its
    own `ops`: up to p_local lanes (global lanes `shard * p_local + j`;
    missing trailing lanes are IDLE-padded and their results trimmed
    away).  `ctx` carries the rank's per-lane LL/SC links across batches.
    The shard's state is copied first unless `donate=True` (then the
    caller must not reuse it), as `engine.apply`.

    Returns (dstate', ctx', ApplyResult, overflow) for the rank's lanes,
    where `overflow` is the per-lane bool mask of ops rejected by route
    capacity — reported, never silently dropped; rejected lanes have
    success=False and no table effect."""
    if dspec.is_hash:
        raise TypeError("hash DistSpec: use distributed.apply_hash")
    _member(mesh)
    engine.check_kinds(ops.kind, engine.TABLE_KINDS, "table")  # host read
    dev = mesh.device
    q, k = ops.kind.shape[0], dspec.inner.k
    _check_width(q, dspec)
    ops = _pad_ops(engine.canonicalize_ops(ops, dev), dspec.p_local)
    ctx = engine.init_ctx(dspec.p_local, k, device=dev) if ctx is None \
        else _pad_ctx(engine.canonicalize_ctx(ctx, dev), dspec.p_local, k)
    fn = _table_round_2level if dspec.n_nodes > 1 else _table_round
    local, nctx, value, success, overflow = fn(
        mesh, dspec, _own(dstate.local, donate), ctx, ops)
    if q != dspec.p_local:
        nctx = engine.LinkCtx(*[x[:q] for x in nctx])
        value, success, overflow = value[:q], success[:q], overflow[:q]
    if obs_telemetry.counters_on():
        obs_telemetry.record_dist(overflow, collective_words(dspec), dev)
    return (DistState(local, mesh), nctx, engine.ApplyResult(value, success),
            overflow)


class DistRoundHandle:
    """An in-flight distributed round (the collective analog of
    `engine.RoundHandle`): on a card a CUDA event is recorded after the
    round's work, so `ready()` polls it and `wait()` blocks on it; on the
    CPU the round has run when `apply_round` returns.  `order` (when
    requested) is the host-side claimed linearization of the global
    batch, computed up front."""

    __slots__ = ("state", "ctx", "result", "overflow", "order", "_event")

    def __init__(self, state, ctx, result, overflow, order=None):
        self.state = state
        self.ctx = ctx
        self.result = result
        self.overflow = overflow
        self.order = order
        self._event = None
        if overflow.is_cuda:
            self._event = torch.cuda.Event()
            self._event.record()

    def ready(self) -> bool:
        return self._event is None or self._event.query()

    def wait(self) -> "DistRoundHandle":
        if self._event is not None:
            self._event.synchronize()
        return self


def apply_round(mesh: Mesh, dspec: DistSpec, dstate: DistState,
                ops: engine.OpBatch, ctx: engine.LinkCtx | None = None, *,
                with_order: bool = False,
                donate: bool = False) -> DistRoundHandle:
    """`apply` wrapped as an overlappable handle; with `with_order=True`
    the claimed linearization of the global batch rides along (the ranks'
    kinds and slots are all-gathered over the shard axes for it)."""
    _member(mesh)
    order = None
    if with_order:
        dev = mesh.device
        p = dspec.p_local
        ops_d = _pad_ops(engine.canonicalize_ops(ops, dev), p)
        kind = _gather_shards(mesh, dspec, ops_d.kind).reshape(-1)
        slot = _gather_shards(mesh, dspec, ops_d.slot).reshape(-1)
        order, _ = linearization_order(
            dspec, engine.OpBatch(kind.cpu().numpy(), slot.cpu().numpy(),
                                  None, None))
    state, nctx, res, ovf = apply(mesh, dspec, dstate, ops, ctx,
                                  donate=donate)
    return DistRoundHandle(state, nctx, res, ovf, order)


# ---------------------------------------------------------------------------
# Cross-shard MCAS: the two-round prepare/commit collective.
# ---------------------------------------------------------------------------

def _mcas_round(mesh: Mesh, dspec: DistSpec, st, t_local: int, w: int,
                slot, expected, desired, active):
    """One prepare/commit round pair for this rank's `t_local`
    transactions of width `w`:

      prepare — every active txn lane routes (cell, expected, desired,
                global txn id) to its owner shard; the owner LLs the cell
                through the local engine round, checks expected, and
                VOTES: a lane's vote is yes iff it matched AND its txn id
                is the lowest matching id claiming that cell.  Match, vote
                and the witnessed value route back.
      decide  — the SOURCE holds all of its txn's lanes, so the commit
                mask is local: commit iff every lane matched and voted.
      commit  — the commit bit routes out over the SAME lane packing (so
                it lands on the owner's prepare-round link ctx), the owner
                SCs every committing lane, and SC success routes back.

    Out [s, cap, 2k+3] (live, local slot, expected[k], desired[k], gid),
    back [s, cap, k+2] (match, vote, witness[k]); commit out and back one
    word each.  Returns (state', match_t, success_t, witness)."""
    s = dspec.n_shards
    lsp: AtomicSpec = dspec.local_spec()
    k = lsp.k
    dev = slot.device
    p_lane = t_local * w
    cap = p_lane                 # a source owns p_lane lanes: never overflows
    my = shard_index(mesh, dspec)
    txn_of = torch.arange(p_lane, device=dev) // w
    gid = my * t_local + txn_of
    f_slot = slot.reshape(p_lane)
    lane_used = (f_slot >= 0) & (f_slot < dspec.n_global)
    live = active[txn_of] & lane_used

    owner, lslot = _owner_and_local(dspec, torch.where(lane_used, f_slot, 0))
    owner = torch.where(live, owner, s)
    rank, fits = _dst_ranks(owner, cap, s, p_lane)

    # -- prepare: route (cell, expected, desired, gid) to the owner ---------
    dst = torch.where(fits, owner * cap + rank, s * cap)
    pack = _packer(dst, s * cap)
    go = _a2a(mesh.groups[dspec.axis], s, cap)
    lanes = torch.cat([_i32(fits)[:, None], _i32(lslot)[:, None],
                       expected.reshape(p_lane, k),
                       desired.reshape(p_lane, k), _i32(gid)[:, None]], 1)
    r = go(pack(lanes, torch.cat([_row(0, 0, k_cols=(2 * k,), device=dev),
                                  _row(s * t_local, device=dev)]))
           ).reshape(s * cap, -1)
    r_live, r_slot = r[:, 0] != 0, _cols(r, 1)
    r_exp, r_des = _cols(r, 2, 2 + k), _cols(r, 2 + k, 2 + 2 * k)
    r_gid = r[:, -1]

    zeros = torch.zeros((s * cap, k), dtype=WORD_DTYPE, device=dev)
    ops1 = engine.OpBatch(_i32(torch.where(r_live, engine.LL, engine.IDLE)),
                          r_slot, zeros, zeros)
    st, octx, res1 = _local_round(
        lsp, st, engine.init_ctx(s * cap, k, device=dev), ops1)
    vals = res1.value
    match = r_live & (vals == r_exp).all(1)
    # per-owner vote: lowest MATCHING txn id claiming each local cell
    n_loc = dspec.n_local
    claim = torch.where(match, r_slot, n_loc).long()
    cgid = torch.where(match, r_gid, s * t_local)
    cell_min = torch.full((n_loc + 1,), s * t_local, dtype=torch.int32,
                          device=dev)
    cell_min.scatter_reduce_(0, claim, cgid, "amin")
    vote = match & (cell_min[claim] == r_gid)

    # -- route match/vote/witness back to the source ------------------------
    b = go(torch.cat([_i32(match)[:, None], _i32(vote)[:, None], vals], 1))
    row = _gather_back(b, owner, fits, rank, s)
    l_match = fits & (row[:, 0] != 0)
    l_vote = fits & (row[:, 1] != 0)
    l_wit = torch.where(fits[:, None], row[:, 2:], 0)

    def per_txn_all(flag):
        return (flag | ~lane_used).reshape(t_local, w).all(1)

    match_t = active & per_txn_all(l_match)
    commit_t = match_t & per_txn_all(l_vote)

    # -- commit: the commit bit rides the SAME packing onto the same owner
    #    lanes (prepare-round links), then SC success rides back -----------
    commit_lane = commit_t[txn_of] & lane_used & fits
    r_commit = go(pack(_i32(commit_lane)[:, None],
                       _row(0, device=dev))).reshape(s * cap) != 0
    ops2 = engine.OpBatch(_i32(torch.where(r_commit, engine.SC, engine.IDLE)),
                          r_slot, zeros, r_des)
    st, _, res2 = _local_round(lsp, st, octx, ops2)
    b_sc = go(_i32(res2.success)[:, None])
    l_sc = fits & (_gather_back(b_sc, owner, fits, rank, s)[:, 0] != 0)
    success_t = commit_t & per_txn_all(l_sc)
    return st, match_t, success_t, l_wit.reshape(t_local, w, k)


def mcas(mesh: Mesh, dspec: DistSpec, dstate: DistState, txns, *,
         policy=None, max_rounds: int | None = None, donate: bool = False):
    """Cross-shard k-word MCAS: transactions whose lanes span shards commit
    all-or-nothing through the two-round prepare/commit collective.

    Each rank passes its own transactions (a `txn.mcas.TxnBatch`, any
    number of rows, none included); global txn ids are
    `shard * t_local + row`, t_local the most any rank passes, so callers
    splitting a global batch source-major (txn i from shard
    i // ceil(T / n_shards)) get the reference's ids.  Retries of
    arbitration losers follow the queue's Dice-style `BackoffPolicy`
    (default none).  The loop continues while ANY rank has a pending
    transaction: one `all_reduce(MAX)` of (pending, active) a round keeps
    every rank in the same sequence of collectives.  `max_rounds` defaults
    to the bound for the global T.  The shard's state is copied first
    unless `donate=True`.

    Returns (dstate', McasResult): `rounds` is global, the other fields
    are this rank's transactions' (`txn.mcas.linearization_order` of the
    rows gathered in global id order gives the claimed order)."""
    from repro_torch.sync.queue import BackoffPolicy
    from repro_torch.txn import mcas as txn_mcas
    if dspec.is_hash:
        raise TypeError("hash DistSpec: MCAS runs on tables")
    if dspec.n_nodes > 1:
        raise NotImplementedError("cross-shard MCAS routes flat; build its "
                                  "DistSpec with n_nodes=1")
    _member(mesh)
    policy = policy or BackoffPolicy("none")
    dev = mesh.device
    k = dspec.inner.k
    t_mine, w = txns.slot.shape[0], txns.slot.shape[1]
    if txns.expected.shape[2] != k:
        raise ValueError(f"txn word width {txns.expected.shape[2]} != "
                         f"spec.k {k}")
    group = mesh.groups[dspec.axis]
    s = dspec.n_shards
    sizes = [torch.empty(2, dtype=torch.int32, device=dev) for _ in range(s)]
    mine = torch.stack([torch.full((), x, dtype=torch.int32, device=dev)
                        for x in (t_mine, w)])
    dist.all_gather(sizes, mine, group=group)
    sizes = torch.stack(sizes).cpu().numpy()               # one host read
    if (sizes[:, 1] != w).any():
        raise ValueError(f"txn widths differ across ranks: "
                         f"{sizes[:, 1].tolist()}")
    t_global, t_local = int(sizes[:, 0].sum()), int(sizes[:, 0].max())
    if max_rounds is None:
        max_rounds = txn_mcas.max_rounds_bound(t_global, policy)
    pad = t_local - t_mine
    slot = torch.cat([engine._as_i32(txns.slot, dev),
                      torch.full((pad, w), -1, dtype=torch.int32,
                                 device=dev)])
    wz = torch.zeros((pad, w, k), dtype=WORD_DTYPE, device=dev)
    expected = torch.cat([txns.expected.to(dev), wz])
    desired = torch.cat([txns.desired.to(dev), wz])
    st = _own(dstate.local, donate)

    def zeros(dtype=torch.int32, shape=(t_local,)):
        return torch.zeros(shape, dtype=dtype, device=dev)

    pending = torch.arange(t_local, device=dev) < t_mine
    success = zeros(torch.bool)
    witness = zeros(WORD_DTYPE, (t_local, w, k))
    round_res, attempts, delay = zeros(), zeros(), zeros()
    rnd = 0
    while True:
        flags = torch.stack([pending.any(), (pending & (delay <= 0)).any()]
                            ).to(torch.int32)
        dist.all_reduce(flags, op=dist.ReduceOp.MAX, group=group)
        any_pending, any_active = flags.tolist()           # the host read
        if not any_pending:
            break
        rnd += 1
        if rnd > max_rounds:
            raise RuntimeError(
                f"mcas round bound exceeded ({max_rounds}); pending="
                f"{torch.nonzero(pending).flatten().tolist()}")
        if not any_active:
            delay = (delay - 1).clamp(min=0)
            continue
        active = pending & (delay <= 0)
        st, match_t, success_t, wit = _mcas_round(
            mesh, dspec, st, t_local, w, slot, expected, desired, active)
        failed = active & ~match_t
        committed = active & success_t
        resolved = failed | committed
        witness = torch.where(resolved[:, None, None], wit, witness)
        success = success | committed
        round_res = torch.where(resolved, rnd, round_res)
        pending = pending & ~resolved
        lost = active & ~resolved
        attempts = attempts + _i32(lost)
        delay = torch.where(lost, txn_mcas._policy_delay(policy, attempts),
                            (delay - 1).clamp(min=0))
    result = txn_mcas.McasResult(
        success[:t_mine], witness[:t_mine], round_res[:t_mine],
        attempts[:t_mine], torch.full((), rnd, dtype=torch.int32, device=dev))
    return DistState(st, mesh), result


def mcas_collective_words(dspec: DistSpec, t_local: int, w: int) -> int:
    """Words per device per prepare/commit round pair (4 all_to_alls):
    out (slot, expected[k], desired[k], gid, live) + back (match, vote,
    witness[k]) + commit out/back (2)."""
    return dspec.n_shards * t_local * w * (3 * dspec.inner.k + 7)


# ---------------------------------------------------------------------------
# Sharded CacheHash: FIND/INSERT/DELETE route by key owner.
# ---------------------------------------------------------------------------

def _hash_owner(dspec: DistSpec, key_bits):
    """Owner shard of each key: top bits of the bucket hash (the local
    apply re-derives the local bucket from the SAME hash's low bits)."""
    hs: HashSpec = dspec.inner
    gb = ch.hash_u32(key_bits) & (hs.nb - 1)
    return _floordiv(gb, dspec.n_local)


def apply_hash(mesh: Mesh, dspec: DistSpec, dstate: DistState,
               ops: engine.OpBatch, *, donate: bool = False):
    """Key-owner-routed sharded CacheHash batch (unified hash schema) on
    this rank's up to p_local lanes.  Out and back [s, cap, vw+2] each:
    (kind, key, value[vw]) and (found, value[vw], walk overflow).

    Returns (dstate', HashResult, overflow) — the same overflow contract as
    `apply`: capacity-rejected lanes are reported with found=False, never
    silently dropped, and never touch any shard's table."""
    if not dspec.is_hash:
        raise TypeError("table DistSpec: use distributed.apply")
    _member(mesh)
    engine.check_kinds(ops.kind, engine.HASH_KINDS, "hash")   # host read
    dev = mesh.device
    s, cap = dspec.n_shards, dspec.cap
    lsp: HashSpec = dspec.local_spec()
    vw = lsp.vw
    q = ops.kind.shape[0]
    _check_width(q, dspec)
    ops = _pad_ops(engine.canonicalize_ops(ops, dev), dspec.p_local)
    active = ops.kind != engine.IDLE
    owner = torch.where(active, _hash_owner(dspec, ops.slot), s)
    rank, fits = _dst_ranks(owner, cap, s, dspec.p_local)

    dst = torch.where(fits, owner * cap + rank, s * cap)
    lanes = torch.cat([_i32(torch.where(fits, ops.kind, engine.IDLE))[:, None],
                       ops.slot[:, None], ops.desired[:, :vw]], 1)
    go = _a2a(mesh.groups[dspec.axis], s, cap)
    r = go(_packer(dst, s * cap)(
        lanes, _row(engine.IDLE, 0, k_cols=(vw,), device=dev))
    ).reshape(s * cap, -1)
    rops = engine.OpBatch(_cols(r, 0), _cols(r, 1),
                          torch.zeros((s * cap, vw), dtype=WORD_DTYPE,
                                      device=dev), _cols(r, 2, 2 + vw))
    st, res, _stats = ch.apply_hash(lsp, dstate.local, rops, donate=donate)

    b = go(torch.cat([_i32(res.found)[:, None], res.value,
                      _i32(res.overflow)[:, None]], 1))
    row = _gather_back(b, owner, fits, rank, s)
    found = fits & (row[:, 0] != 0)
    val = torch.where(fits[:, None], row[:, 1:1 + vw], 0)
    walk_over = fits & (row[:, 1 + vw] != 0)
    overflow = active & ~fits
    return (DistState(st, mesh), ch.HashResult(found[:q], val[:q],
                                               walk_over[:q]), overflow[:q])


# ---------------------------------------------------------------------------
# The global-batch form: every rank passes the whole batch, reads it whole.
# ---------------------------------------------------------------------------

def _my_lanes(mesh: Mesh, dspec: DistSpec, x):
    """This rank's p_local rows of a p_global-row tensor."""
    i, pl = shard_index(mesh, dspec), dspec.p_local
    return x[i * pl:(i + 1) * pl]


def _gather_lanes(mesh: Mesh, dspec: DistSpec, cols, q: int):
    """ONE all_gather over the shard axis of this rank's [p_local, W]
    int32 result columns; returns the global [q, W] rows, lane order."""
    packed = torch.cat([_i32(c).reshape(dspec.p_local, -1) for c in cols], 1)
    return _gather_shards(mesh, dspec, packed).reshape(dspec.p_global, -1)[:q]


def _global_spec(dspec: DistSpec, q: int, whole_batch_route: bool = False):
    """`dspec` for a q-lane global batch: the lanes IDLE-padded to a
    multiple of n_shards, each rank issuing q_pad / n_shards of them (the
    spec's own p_local is not used).  The route capacity stays the spec's
    (default p_local, which can never overflow: a source owns only p_local
    lanes), or with `whole_batch_route` is the padded batch, so one shard
    may receive every lane."""
    p_local = max(-(-q // dspec.n_shards), 1)
    return dataclasses.replace(
        dspec, p_local=p_local,
        route_capacity=(dspec.n_shards * p_local if whole_batch_route
                        else dspec.route_capacity))


def apply_global(mesh: Mesh, dspec: DistSpec, dstate: DistState,
                 ops: engine.OpBatch, ctx: engine.LinkCtx | None = None, *,
                 donate: bool = False):
    """`apply` on a GLOBAL batch of any width (`_global_spec`: lane i
    issues from shard i // p_local), passed alike by every rank of the
    mesh: the rank runs its own lanes through `apply`, then value,
    success, overflow and the link context ride one all_gather over the
    shard axis, packed as [p_local, 2k + 5] int32.  Returns (dstate',
    ctx', ApplyResult, overflow) for the whole batch on every rank, as the
    reference's `apply` does on its one controller."""
    if dspec.is_hash:
        raise TypeError("hash DistSpec: use distributed.apply_hash_global")
    _member(mesh)
    dev, k = mesh.device, dspec.inner.k
    q = ops.kind.shape[0]
    dspec = _global_spec(dspec, q)
    ops = _pad_ops(engine.canonicalize_ops(ops, dev), dspec.p_global)
    ctx = engine.init_ctx(dspec.p_global, k, device=dev) if ctx is None \
        else _pad_ctx(engine.canonicalize_ctx(ctx, dev), dspec.p_global, k)
    dstate, nctx, res, overflow = apply(
        mesh, dspec, dstate, engine.OpBatch(*(_my_lanes(mesh, dspec, x)
                                              for x in ops)),
        engine.LinkCtx(*(_my_lanes(mesh, dspec, x) for x in ctx)),
        donate=donate)
    g = _gather_lanes(mesh, dspec, [res.value, res.success, overflow,
                                    nctx.slot, nctx.version, nctx.value,
                                    nctx.linked], q)
    gctx = engine.LinkCtx(slot=_cols(g, k + 2), version=_cols(g, k + 3),
                          value=_cols(g, k + 4, 2 * k + 4),
                          linked=g[:, 2 * k + 4] != 0)
    return (dstate, gctx, engine.ApplyResult(_cols(g, 0, k), g[:, k] != 0),
            g[:, k + 1] != 0)


def apply_hash_global(mesh: Mesh, dspec: DistSpec, dstate: DistState,
                      ops: engine.OpBatch, *, whole_batch_route: bool = False,
                      donate: bool = False):
    """`apply_hash` on a GLOBAL batch of any width (`_global_spec`, which
    also reads `whole_batch_route`), passed alike by every rank: the rank
    runs its own lanes, then found, value, the walk overflow and the route
    overflow ride one all_gather over the shard axis ([p_local, vw + 3]
    int32).  Returns (dstate', HashResult, overflow) for the whole batch
    on every rank."""
    if not dspec.is_hash:
        raise TypeError("table DistSpec: use distributed.apply_global")
    _member(mesh)
    dev, vw = mesh.device, dspec.inner.vw
    q = ops.kind.shape[0]
    dspec = _global_spec(dspec, q, whole_batch_route)
    ops = _pad_ops(engine.canonicalize_ops(ops, dev), dspec.p_global)
    dstate, res, overflow = apply_hash(
        mesh, dspec, dstate, engine.OpBatch(*(_my_lanes(mesh, dspec, x)
                                              for x in ops)), donate=donate)
    g = _gather_lanes(mesh, dspec, [res.found, res.value, res.overflow,
                                    overflow], q)
    return (dstate, ch.HashResult(g[:, 0] != 0, _cols(g, 1, 1 + vw),
                                  g[:, 1 + vw] != 0), g[:, 2 + vw] != 0)


# ---------------------------------------------------------------------------
# Host-side inspection: the global view, gathered on every rank.
# ---------------------------------------------------------------------------

def _gather(x, group, size: int):
    """[size, *x.shape]: `x` from each rank of `group`, in group order."""
    if x.numel() == 0:
        return x.new_empty((size,) + tuple(x.shape))
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.stack(parts)


def _gather_shards(mesh: Mesh, dspec: DistSpec, x):
    """[n_shards, *x.shape]: every shard's `x`, in shard order (the
    hierarchical spec's shards node-major)."""
    if dspec.n_nodes > 1:
        inner = _gather(x, mesh.groups[dspec.axis], dspec.devs_per_node)
        out = _gather(inner, mesh.groups[dspec.node_axis], dspec.n_nodes)
        return out.reshape((dspec.n_shards,) + tuple(x.shape))
    return _gather(x, mesh.groups[dspec.axis], dspec.n_shards)


def logical(dspec: DistSpec, dstate: DistState) -> torch.Tensor:
    """Global logical values [n, k], de-sharded (tables only); every rank
    of the mesh must call it."""
    _member(dstate.mesh)
    impl = registry.get_strategy(dspec.inner.strategy)
    vals = _gather_shards(dstate.mesh, dspec,
                          impl.logical(dstate.local))       # [s, n_local, k]
    if dspec.interleave:
        return vals.transpose(0, 1).reshape(dspec.n_global, -1)
    return vals.reshape(dspec.n_global, -1)


def versions(dspec: DistSpec, dstate: DistState) -> torch.Tensor:
    """Global cell versions [n] (tables only); every rank must call it."""
    _member(dstate.mesh)
    ver = _gather_shards(dstate.mesh, dspec, dstate.local.version)
    if dspec.interleave:
        return ver.transpose(0, 1).reshape(-1)
    return ver.reshape(-1)


def hash_items(dspec: DistSpec, dstate: DistState) -> dict:
    """All (key, value) pairs across every shard's CacheHash; every rank
    must call it."""
    _member(dstate.mesh)
    hs: HashSpec = dspec.inner
    local = dstate.local
    leaves = [*local.table, *local[1:]]
    stacked = [_gather_shards(dstate.mesh, dspec, x.reshape(-1)).cpu()
               for x in leaves]
    out: dict = {}
    for i in range(dspec.n_shards):
        parts = [g[i].reshape(x.shape) for g, x in zip(stacked, leaves)]
        shard = ch.HashState(TableState(*parts[:len(local.table)]),
                             *parts[len(local.table):])
        out.update(ch.items(shard, inline=hs.inline, vw=hs.vw))
    return out


def collective_words(dspec: DistSpec) -> int:
    """Exact words each device moves through the all_to_alls per batch
    (the roofline term).  Hierarchical specs split into an intra-node
    term (phase 1 also carries the owner node id) and a cross-node term
    (phase 2 also rides the executed bit back) — the CROSS-NODE words drop
    from n_shards*cap to n_nodes*cap2 per device."""
    if not dspec.is_hash and dspec.n_nodes > 1:
        k = dspec.inner.k
        return (dspec.devs_per_node * dspec.cap * (3 * k + 8)
                + dspec.n_nodes * dspec.cap2 * (3 * k + 7))
    per_lane = (2 * dspec.inner.vw + 4) if dspec.is_hash \
        else (3 * dspec.inner.k + 6)
    return dspec.n_shards * dspec.cap * per_lane


# ---------------------------------------------------------------------------
# The claimed linearization (host-side, for the oracle harness).
# ---------------------------------------------------------------------------

def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _hash_u32_np(key):
    """Host-side bucket hash: evaluate THE port's implementation so device
    routing and the claimed order can never diverge."""
    bits = np.ascontiguousarray(np.asarray(key).astype(np.int64)
                                & 0xFFFFFFFF).astype(np.uint32)
    return ch.hash_u32(torch.from_numpy(bits.view(np.int32))).numpy() \
        .astype(np.uint32)


def linearization_order(dspec: DistSpec, ops: engine.OpBatch):
    """The total order `apply`/`apply_hash` claims for a GLOBAL batch (the
    ranks' lanes concatenated in shard order).

    Returns (order, overflow): `order` lists the executed lane ids in the
    claimed global sequence (owner-major, then source device, then in-bucket
    rank = lane order; dedup'd loads ride directly after their
    representative), `overflow` is the bool[p_global] mask of
    capacity-rejected lanes.

    Hierarchical specs (n_nodes > 1) claim (owner, src node, src device,
    lane) with capacity charged at BOTH hops: cap per (src device, in-node
    owner index) — lanes bound for different nodes share a relay budget —
    then cap2 per (relay, owner node) in relay-lane arrival order.
    """
    kind = _host(ops.kind)
    slot = _host(ops.slot)
    p, s, pl, cap = dspec.p_global, dspec.n_shards, dspec.p_local, dspec.cap
    q = kind.shape[0]
    if q > p:
        raise ValueError(f"batch width {q} > p_global {p}")
    if q < p:                                  # mirror apply's IDLE padding
        kind = np.concatenate([kind, np.full(p - q, engine.IDLE, np.int32)])
        slot = np.concatenate([slot, np.zeros(p - q, np.int32)])
    if dspec.is_hash:
        gb = (_hash_u32_np(slot) & np.uint32(dspec.inner.nb - 1)) \
            .astype(np.int64)
        owner_of = gb // dspec.n_local
    elif dspec.interleave:
        owner_of = slot % s
    else:
        owner_of = np.clip(slot // dspec.n_local, 0, s - 1)

    active = kind != engine.IDLE
    rep = np.arange(p)
    dups: dict[int, list[int]] = {}
    if dspec.dedup_loads and not dspec.is_hash:
        for src in range(s):
            groups: dict[int, list[int]] = {}
            for i in range(src * pl, (src + 1) * pl):
                if active[i]:
                    groups.setdefault(int(slot[i]), []).append(i)
            for lanes in groups.values():
                if all(kind[i] == engine.LOAD for i in lanes) \
                        and len(lanes) > 1:
                    first = lanes[0]
                    dups[first] = lanes[1:]
                    for i in lanes[1:]:
                        rep[i] = first

    overflow = np.zeros(p, bool)
    order: list[int] = []
    if not dspec.is_hash and dspec.n_nodes > 1:
        nn, d, cap2 = dspec.n_nodes, dspec.devs_per_node, dspec.cap2
        # phase 1: per source device, cap lanes per in-node owner index
        # (relay) — relay buffers fill src-device-major, lane order.
        relay: dict[tuple[int, int], list[int]] = {
            (m, j): [] for m in range(nn) for j in range(d)}
        for g in range(s):
            m = g // d
            cnt1: dict[int, int] = {}
            for i in range(g * pl, (g + 1) * pl):
                if not active[i] or rep[i] != i:
                    continue
                j = int(owner_of[i]) % d
                c = cnt1.get(j, 0)
                if c < cap:
                    relay[(m, j)].append(i)
                    cnt1[j] = c + 1
                else:
                    overflow[i] = True
                    for x in dups.get(i, []):
                        overflow[x] = True
        # phase 2: per relay, cap2 lanes per owner node, arrival order.
        accepted: dict[tuple[int, int], list[int]] = {}
        for (m, j), lanes in relay.items():
            cnt2: dict[int, int] = {}
            for i in lanes:
                onode = int(owner_of[i]) // d
                c = cnt2.get(onode, 0)
                if c < cap2:
                    accepted.setdefault((int(owner_of[i]), m), []).append(i)
                    cnt2[onode] = c + 1
                else:
                    overflow[i] = True
                    for x in dups.get(i, []):
                        overflow[x] = True
        for o in range(s):
            for m in range(nn):
                for i in accepted.get((o, m), []):
                    order.append(i)
                    order.extend(dups.get(i, []))
        return np.asarray(order, np.int64), overflow[:q]
    for o in range(s):
        for src in range(s):
            cnt = 0
            for i in range(src * pl, (src + 1) * pl):
                if not active[i] or rep[i] != i or owner_of[i] != o:
                    continue
                if cnt < cap:
                    order.append(i)
                    order.extend(dups.get(i, []))
                    cnt += 1
                else:
                    overflow[i] = True
                    for j in dups.get(i, []):
                        overflow[j] = True
    return np.asarray(order, np.int64), overflow[:q]


# ---------------------------------------------------------------------------
# DEPRECATED v1 surface: raw (data, version) PLAIN table, load/store/CAS.
# ---------------------------------------------------------------------------

class ShardedTable(NamedTuple):
    """DEPRECATED raw sharded table; new code holds a `DistSpec`+`DistState`.
    Each rank holds its own contiguous block of rows."""

    data: torch.Tensor        # word[n_local, k], this rank's block
    version: torch.Tensor     # word[n_local]


def init_sharded(mesh: Mesh, axis: str, n: int, k: int,
                 initial=None) -> ShardedTable:
    """DEPRECATED shim: use `init_dist(mesh, DistSpec(AtomicSpec(...)))`.
    `initial` is the global word[n, k] array; the rank keeps its block."""
    warn_once("core.distributed.init_sharded",
              "distributed.init_dist(mesh, DistSpec(...))")
    n_shards = mesh.size(axis)
    assert n % n_shards == 0, (n, n_shards)
    n_local, i = n // n_shards, mesh.coords[axis]
    dev = mesh.device
    data = torch.zeros((n_local, k), dtype=WORD_DTYPE, device=dev)
    if initial is not None:
        block = np.asarray(initial)[i * n_local:(i + 1) * n_local]
        data = as_words(np.ascontiguousarray(block), dev)
    return ShardedTable(data, torch.zeros(n_local, dtype=WORD_DTYPE,
                                          device=dev))


def _plain_local(table: ShardedTable, k: int) -> TableState:
    """A PLAIN-layout local state viewing this rank's raw block."""
    dev = table.data.device

    def z(dt, shape):
        return torch.zeros(shape, dtype=dt, device=dev)
    return TableState(
        data=table.data, version=table.version,
        bptr=z(torch.int32, (0,)), mark=z(torch.bool, (0,)),
        lock=z(WORD_DTYPE, (0,)), pool=z(WORD_DTYPE, (0, k)),
        free_ring=z(torch.int32, (0,)),
        ring_head=z(WORD_DTYPE, ()), alloc_gen=z(WORD_DTYPE, ()))


def make_apply(mesh: Mesh, axis: str, n: int, k: int, p_local: int,
               *, route_capacity: int | None = None,
               dedup_loads: bool = False, interleave: bool = False):
    """DEPRECATED shim: use `distributed.apply(mesh, DistSpec(...), ...)`.

    Returned fn keeps the v1 contract: (table, ops) ->
    (table', result, overflow_count), on this rank's block and lanes;
    `overflow_count` is the whole batch's (summed over the shard axis)."""
    warn_once("core.distributed.make_apply",
              "distributed.apply(mesh, DistSpec(...), state, ops)")
    s = mesh.size(axis)
    dspec = DistSpec(AtomicSpec(n, k, "plain"), axis, s, p_local,
                     route_capacity=route_capacity, dedup_loads=dedup_loads,
                     interleave=interleave)

    def apply_ops(table: ShardedTable, ops: engine.OpBatch):
        st = DistState(_plain_local(table, k), mesh)
        st, _, res, overflow = apply(mesh, dspec, st, ops)
        count = overflow.sum(dtype=torch.int32).reshape(1)
        dist.all_reduce(count, group=mesh.groups[axis])
        return (ShardedTable(st.local.data, st.local.version), res,
                count.reshape(()))

    return apply_ops


def reference_apply(data, version, ops: engine.OpBatch, *, n_shards: int,
                    p_local: int, interleave: bool = False):
    """DEPRECATED sequential oracle (v1 signature) on the global batch;
    new tests use `tests/oracle.py` + `linearization_order`."""
    from repro_torch.core import semantics as sem
    data = np.asarray(data)
    dspec = DistSpec(AtomicSpec(data.shape[0], data.shape[1], "plain"),
                     "shard", n_shards, p_local, interleave=interleave)
    seq, overflow = linearization_order(dspec, ops)
    kind = _host(ops.kind)
    reordered = (kind[seq], _host(ops.slot)[seq],
                 _host(ops.expected)[seq], _host(ops.desired)[seq])
    d2, v2, res = sem.apply_batch_reference(data, np.asarray(version),
                                            reordered)
    p = kind.shape[0]
    k = data.shape[1]
    value = np.zeros((p, k), data.dtype)
    success = np.zeros((p,), bool)
    value[seq] = np.asarray(res.value)
    success[seq] = np.asarray(res.success)
    return d2, v2, engine.ApplyResult(value, success), \
        np.nonzero(overflow)[0].tolist()
