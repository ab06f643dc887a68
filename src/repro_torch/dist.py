"""Tensor-parallel placement over the port's `core.distributed.Mesh`: the
placement half of the reference's `dist.py`.

`make_rules(cfg, mesh)` is the reference's logical-name -> mesh-axis table:

    batch                  -> ('pod', 'data')   whichever exist on the mesh
    seq                    -> replicated (no context parallelism by default)
    heads / kv_heads / mlp / vocab / experts / expert_mlp / embed
                           -> 'model'           when the mesh has one

`param_shardings(params, cfg, mesh, rules)` gives each parameter leaf its
placement, a `Placement` whose `spec` is the reference's `PartitionSpec`
for the same shape and mesh as a tuple: the largest dim divisible by the
'model' axis (and at least its size) shards over it, `("model", None)` or
`(None, "model")`, and everything else (norm scales, odd shapes, every
leaf when the axis has one device) replicates, `()`.  Optimizer moments
mirror it.

A leaf held on a mesh is a `ShardedLeaf`: this rank's slice plus its
placement, the global shape and dtype, and the mesh.  `shard_leaf` cuts
it from the global leaf (the rank's block of the sharded dim, at its
'model' coordinate), `gather_leaf` gives the global leaf back bit for bit
(one all_gather over the 'model' axis, of the slice's bytes).  A rank
outside the mesh holds `local=None`.

The annotation half, `axis_rules`, `shard` and `batch_shardings`, comes
with sharded training (`launch.train.train(mesh=...)`): it annotates a
model that runs sharded.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as tdist

from repro_torch.models.common import tree_map

# Logical axes that map onto the tensor/expert-parallel mesh axis.
MODEL_AXES = ("heads", "kv_heads", "mlp", "vocab", "experts", "expert_mlp",
              "embed")


def make_rules(cfg, mesh) -> dict:
    """Logical-name -> mesh-axis table for this (config, mesh) pair."""
    axes = set(mesh.axis_names)
    batch = tuple(a for a in ("pod", "data") if a in axes)
    model = "model" if "model" in axes else None
    rules: dict = {"batch": batch or None, "seq": None}
    for name in MODEL_AXES:
        rules[name] = model
    return rules


def _axis_sizes(mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.shape))


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a leaf lives on a mesh: `spec` as the reference's
    `PartitionSpec` entries, () when replicated."""

    spec: tuple = ()

    @property
    def dim(self) -> int | None:
        """The dim that shards over 'model' (None: replicated)."""
        return self.spec.index("model") if "model" in self.spec else None


def param_shardings(params, cfg, mesh, rules: dict):
    """Tensor-parallel placements for a parameter tree (nested dicts,
    tuples, lists; leaves tensors or `ShardedLeaf`s), as a tree of
    `Placement`s of the same structure: the largest dim divisible by the
    'model' axis shards over it; everything else replicates.  Mirrored by
    optimizer moments."""
    model_n = _axis_sizes(mesh).get("model", 1)

    def leaf(x):
        shape = tuple(getattr(x, "shape", ()))
        if model_n > 1 and len(shape) >= 2:
            dims = sorted(range(len(shape)), key=lambda i: -shape[i])
            for i in dims:
                if shape[i] >= model_n and shape[i] % model_n == 0:
                    ax: list = [None] * len(shape)
                    ax[i] = "model"
                    return Placement(tuple(ax))
        return Placement()

    return tree_map(leaf, params)


@dataclasses.dataclass
class ShardedLeaf:
    """One leaf on a mesh: this rank's slice (`local`, None outside the
    mesh) of the global leaf of `shape` and `dtype`, placed by
    `placement` on `mesh`."""

    local: torch.Tensor | None
    placement: Placement
    shape: tuple
    dtype: torch.dtype
    mesh: object

    @property
    def spec(self) -> tuple:
        return self.placement.spec


def shard_leaf(x: torch.Tensor, placement: Placement, mesh) -> ShardedLeaf:
    """The rank's slice of the global leaf `x` under `placement` (a copy
    on the mesh's device; nothing outside the mesh)."""
    shape, dtype = tuple(x.shape), x.dtype
    if not mesh.member:
        return ShardedLeaf(None, placement, shape, dtype, mesh)
    x = x.to(mesh.device)
    d = placement.dim
    if d is not None:
        part = shape[d] // _axis_sizes(mesh)["model"]
        x = x.narrow(d, mesh.coords["model"] * part, part)
    return ShardedLeaf(x.clone(), placement, shape, dtype, mesh)


def _as_bytes(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().reshape(-1).view(torch.uint8)


def gather_leaf(leaf: ShardedLeaf) -> torch.Tensor:
    """The global leaf, bit for bit, on every rank of the leaf's mesh (an
    all_gather over the 'model' axis when the leaf is sharded); raises
    outside the mesh."""
    mesh = leaf.mesh
    if not mesh.member:
        raise ValueError("this rank is not a member of the leaf's mesh")
    d = leaf.placement.dim
    if d is None:
        return leaf.local
    n = _axis_sizes(mesh)["model"]
    b = _as_bytes(leaf.local)
    parts = [torch.empty_like(b) for _ in range(n)]
    tdist.all_gather(parts, b, group=mesh.groups["model"])
    shape = tuple(leaf.local.shape)
    return torch.cat([p.view(leaf.dtype).reshape(shape) for p in parts], d)
