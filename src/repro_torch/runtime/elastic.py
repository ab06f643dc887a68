"""Elastic scaling: rebuild the mesh for whatever ranks survive and reshard
the state onto it.

Checkpoints are mesh-agnostic (global leaves; the placement table is
re-derived from the config), so growing or shrinking after losing a host
is the same operation: make a new mesh, recompute the placements, move
the data.  The only global invariant the caller must keep is
`global_batch % batch_shards == 0`: `elastic_mesh` picks the largest
(data, model) factorization that preserves it.

Every rank of the world calls `elastic_mesh`, `reshard_state` and
`reshard_dist` at the same point (they build process groups or move data
over the world, which are collective); a rank outside the new mesh gets
back a state that holds nothing.
"""

from __future__ import annotations

import logging
from typing import NamedTuple

import torch
import torch.distributed as tdist

from repro_torch import dist
from repro_torch.core import distributed as dsb
from repro_torch.models.common import tree_map

logger = logging.getLogger(__name__)


class MeshPlan(NamedTuple):
    """What `elastic_mesh` decided: the (data, model) factorization plus the
    devices it could NOT use — dropped devices are REPORTED, never silently
    truncated away (a 7-survivor cluster quietly running on 4 devices is a
    capacity bug, not a convenience)."""

    data: int
    model: int
    used: int
    dropped: int


def mesh_plan(n_devices: int, *, model_parallel: int = 1,
              global_batch: int | None = None) -> MeshPlan:
    """Largest usable (data, model) factorization of `n_devices` preserving
    `global_batch % data == 0`, with the dropped-device count."""
    model = model_parallel
    while model > 1 and n_devices % model != 0:
        model //= 2
    data = n_devices // model
    if global_batch is not None:
        while data > 1 and global_batch % data != 0:
            data //= 2
    used = data * model
    return MeshPlan(data, model, used, n_devices - used)


def elastic_mesh(n_devices: int, *, model_parallel: int = 1,
                 global_batch: int | None = None, device="cuda",
                 timeout=None) -> dsb.Mesh:
    """Largest usable (data, model) mesh on the first `n_devices` ranks of
    the world: `make_mesh` over the first `plan.used` of them.  When the
    factorization cannot use every device, the dropped count is logged
    (see `mesh_plan` for the programmatic report)."""
    plan = mesh_plan(n_devices, model_parallel=model_parallel,
                     global_batch=global_batch)
    if plan.dropped:
        logger.warning(
            "elastic_mesh: dropping %d of %d devices (largest usable mesh "
            "is data=%d x model=%d%s)", plan.dropped, n_devices, plan.data,
            plan.model,
            f" under global_batch={global_batch}" if global_batch else "")
    return dsb.make_mesh((plan.data, plan.model), ("data", "model"),
                         ranks=range(plan.used), device=device,
                         timeout=timeout)


def _to_all(x, holders, mesh, shape, dtype):
    """The global tensor `x` (None where this rank does not hold it) on
    every rank of `mesh`: when some rank of the mesh is not among
    `holders` (world ranks, in order), one broadcast of its bytes over the
    world from the first holder (every rank of the world calls it)."""
    if all(r in holders for r in mesh.ranks):
        return x
    if x is None:
        x = torch.empty(shape, dtype=dtype, device=mesh.device)
    else:
        x = x.to(mesh.device).contiguous()
    buf = x.reshape(-1).view(torch.uint8)
    tdist.broadcast(buf, src=holders[0])
    return x


def _reshard_leaf(x, placement, mesh):
    world = range(tdist.get_world_size())
    if isinstance(x, dist.ShardedLeaf):
        holders = x.mesh.ranks
        g = dist.gather_leaf(x) if x.mesh.member else None
        shape, dtype = x.shape, x.dtype
    else:                                   # every rank holds the leaf
        holders, g, shape, dtype = world, x, tuple(x.shape), x.dtype
    g = _to_all(g, holders, mesh, shape, dtype)
    if not mesh.member:
        return dist.ShardedLeaf(None, placement, shape, dtype, mesh)
    return dist.shard_leaf(g, placement, mesh)


def reshard_state(state, cfg, mesh: dsb.Mesh):
    """The (params, opt_state) training state placed for `mesh`: params by
    `dist.param_shardings`, both AdamW moments mirroring them, the step
    replicated.  Leaves come in as global tensors (every rank holding the
    same) or as the `ShardedLeaf`s of an earlier reshard, and go out as
    `ShardedLeaf`s; a rank outside `mesh` gets leaves that hold nothing
    (`local=None`).  Every rank of the world calls it."""
    rules = dist.make_rules(cfg, mesh)
    params, opt = state
    p_sh = dist.param_shardings(params, cfg, mesh, rules)
    o_sh = {"m": p_sh, "v": p_sh, "step": dist.Placement()}

    def move(x, placement):
        return _reshard_leaf(x, placement, mesh)
    return tree_map(move, params, p_sh), tree_map(move, opt, o_sh)


def reshard_dist(old_dspec, dstate, new_dspec, mesh: dsb.Mesh):
    """Re-shard a big-atomic `DistState` onto a new mesh / shard count,
    preserving logical values AND per-cell versions.

    Versions are load-bearing across a recovery boundary: an executor
    resuming from a checkpoint replays batches whose LinkCtx rows hold
    version numbers from BEFORE the fault — if resharding re-initialized
    versions to zero, every outstanding LL link would spuriously die (or
    worse, spuriously survive).  So the global view (`distributed.logical`
    / `versions`, gathered over the old mesh) reaches every rank of the new
    mesh (a broadcast over the world from the old mesh's first rank when
    the new mesh holds ranks the old one did not), the state is rebuilt at
    the new geometry with `init_dist`, and each rank splices its row of
    the split versions back.  Every rank of the world calls it; a rank
    outside the new mesh gets `DistState(None, mesh)`."""
    from repro_torch.runtime.executor import _split_versions
    if old_dspec.is_hash or new_dspec.is_hash:
        raise TypeError("reshard_dist reshards tables")
    if (old_dspec.n_global, old_dspec.inner.k) != \
            (new_dspec.n_global, new_dspec.inner.k):
        raise ValueError(f"geometry change: {old_dspec.inner} -> "
                         f"{new_dspec.inner}")
    old = dstate.mesh
    vals = vers = None
    if old.member:
        vals = dsb.logical(old_dspec, dstate)
        vers = dsb.versions(old_dspec, dstate)
    n, k = new_dspec.n_global, new_dspec.inner.k
    vals = _to_all(vals, old.ranks, mesh, (n, k), torch.int32)
    vers = _to_all(vers, old.ranks, mesh, (n,), torch.int32)
    if not mesh.member:
        return dsb.DistState(None, mesh)
    new = dsb.init_dist(mesh, new_dspec, vals)
    row = _split_versions(new_dspec, vers, mesh.device)[
        dsb.shard_index(mesh, new_dspec)]
    return dsb.DistState(new.local._replace(version=row.clone()), mesh)
