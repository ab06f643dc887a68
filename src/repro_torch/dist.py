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

The annotation half serves sharded training (`launch.train.train(mesh=
...)`).  `axis_rules(mesh, rules)` activates a (mesh, rules) pair, as the
reference's context; `shard(x, *names)` is the reference's annotation
(the identity outside a context, a `ValueError` on a rank mismatch
inside one).  The port runs one program per rank on its own rows and
slices, so where the reference's compiler splits an annotated tensor, a
layer asks `local_slices(shape, *names)` (or `local_slice(size, name)`)
for this rank's `(start, length)` of each dim under `spec`, the
reference's `_spec` rules: a dim maps to its rule's mesh axes, a mapping
dropped when the dim is not divisible by their size or when an axis is
already used by an earlier dim (a reduced config of 4 heads at 'model' 8
replicates its heads, as the reference's does).  `batch_shardings` gives
the reference's per-leaf batch placement (the leading axis over the batch
axes when divisible, else replicated) and `local_rows` this rank's rows.

The collectives a tensor-parallel layer needs sit in autograd Functions
paired so that each one's backward is right: `to_model` (identity, its
backward a sum over 'model': the input of a layer whose weight is cut),
`sum_over_model` (a sum over 'model', its backward the identity: the
partial products of a cut contraction).
Sums run in fp32, so a bf16 partial is rounded once, after the sum.
`to_compute` brings a leaf from its stored slice (`Placement`, the largest
divisible dim) to the slice a layer computes with (a `Cut`): an
all-to-all over 'model' when both are even splits of different dims,
else an all-gather and a cut; its backward brings the gradient back to
the stored slice (the inverse all-to-all; or this rank's block of the
whole gradient, summed over 'model' first where the cuts overlap and
each rank's gradient is a part, `Cut.partial`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import NamedTuple

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
    on the mesh's device, where only the slice goes; nothing outside the
    mesh)."""
    shape, dtype = tuple(x.shape), x.dtype
    if not mesh.member:
        return ShardedLeaf(None, placement, shape, dtype, mesh)
    d = placement.dim
    if d is not None:
        part = shape[d] // _axis_sizes(mesh)["model"]
        x = x.narrow(d, mesh.coords["model"] * part, part)
    return ShardedLeaf(x.to(mesh.device, copy=True), placement, shape, dtype,
                       mesh)


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


# ---------------------------------------------------------------------------
# The annotation half: axis_rules, shard, the slice helpers, batch placement
# ---------------------------------------------------------------------------

class _Ctx(NamedTuple):
    mesh: object
    rules: dict


_STACK: list[_Ctx] = []


@contextlib.contextmanager
def axis_rules(mesh, rules: dict):
    """Activate (mesh, rules) for the annotations and slice helpers run
    inside."""
    _STACK.append(_Ctx(mesh, rules))
    try:
        yield
    finally:
        _STACK.pop()


def current() -> _Ctx | None:
    """The innermost active (mesh, rules), or None."""
    return _STACK[-1] if _STACK else None


def spec(shape, names, mesh, rules: dict) -> tuple:
    """The reference's `_spec`: per dim, the mesh axis (or tuple of axes)
    it shards over, None where it replicates."""
    sizes = _axis_sizes(mesh)
    used: set = set()
    out = []
    for dim, name in zip(shape, names):
        mapped = rules.get(name) if name is not None else None
        if mapped is None:
            out.append(None)
            continue
        axes = mapped if isinstance(mapped, tuple) else (mapped,)
        axes = tuple(a for a in axes if a not in used)
        n = math.prod(sizes[a] for a in axes) if axes else 1
        if n <= 1 or dim % n != 0:
            out.append(None)
            continue
        used.update(axes)
        out.append(axes if len(axes) > 1 else axes[0])
    return tuple(out)


def shard(x, *names):
    """The reference's annotation of `x` (rank == len(names)).  Outside an
    `axis_rules` context it returns `x`; inside one it checks the rank and
    returns `x`: each rank already holds its slice (`local_slices`)."""
    if not _STACK:
        return x
    if x.ndim != len(names):
        raise ValueError(f"shard(): rank {x.ndim} != {len(names)} names")
    return x


def _axes(entry) -> tuple:
    return entry if isinstance(entry, tuple) else (entry,)


def _coord(mesh, axes) -> int:
    """This rank's row-major coordinate over `axes` (the order in which a
    `PartitionSpec` entry of several axes splits its dim)."""
    c = 0
    for a in axes:
        c = c * mesh.size(a) + mesh.coords[a]
    return c


def local_slices(shape, *names) -> tuple:
    """This rank's `(start, length)` of each dim of a global `shape`
    annotated with `names` under the active context (`spec`'s rules); the
    whole dim where it replicates, and every dim outside a context."""
    ctx = current()
    if ctx is None:
        return tuple((0, int(d)) for d in shape)
    out = []
    for dim, entry in zip(shape, spec(shape, names, ctx.mesh, ctx.rules)):
        if entry is None:
            out.append((0, int(dim)))
            continue
        axes = _axes(entry)
        part = int(dim) // math.prod(ctx.mesh.size(a) for a in axes)
        out.append((_coord(ctx.mesh, axes) * part, part))
    return tuple(out)


def local_slice(size: int, name: str) -> tuple:
    """`(start, length)` of a dim of `size` annotated `name` on this rank
    (the whole dim where it replicates or outside a context)."""
    return local_slices((size,), name)[0]


def batch_shardings(batch, mesh, rules: dict):
    """Data-parallel placements for an input tree (numpy arrays or
    tensors), as `Placement`s: the leading axis over the batch mesh axes
    when divisible, replicated otherwise."""
    baxes = _axes(rules.get("batch") or ())
    sizes = _axis_sizes(mesh)
    n = math.prod(sizes[a] for a in baxes) if baxes else 1

    def leaf(x):
        shape = tuple(getattr(x, "shape", ()))
        if n > 1 and len(shape) >= 1 and shape[0] % n == 0:
            return Placement((baxes if len(baxes) > 1 else baxes[0],))
        return Placement()

    return tree_map(leaf, batch)


def local_rows(batch, mesh, rules: dict):
    """This rank's rows of a global input tree under `batch_shardings`
    (views; every row of a replicated leaf)."""
    def leaf(x, placement):
        if not placement.spec:
            return x
        axes = _axes(placement.spec[0])
        part = x.shape[0] // math.prod(mesh.size(a) for a in axes)
        lo = _coord(mesh, axes) * part
        return x[lo:lo + part]

    return tree_map(leaf, batch, batch_shardings(batch, mesh, rules))


def batch_axes(mesh, rules: dict) -> tuple:
    """The batch mesh axes of more than one rank."""
    return tuple(a for a in _axes(rules.get("batch") or ())
                 if mesh.size(a) > 1)


# ---------------------------------------------------------------------------
# Tensor-parallel collectives, each paired with its backward
# ---------------------------------------------------------------------------

class ModelAxis(NamedTuple):
    """The active context's 'model' axis: its group, size and this rank's
    index on it."""

    group: object
    size: int
    index: int


def model_axis() -> ModelAxis | None:
    """The active context's 'model' axis when it has more than one rank,
    else None (the layers then take their one-device path)."""
    ctx = current()
    if ctx is None or "model" not in ctx.mesh.axis_names or \
            ctx.mesh.size("model") < 2:
        return None
    return ModelAxis(ctx.mesh.groups["model"], ctx.mesh.size("model"),
                     ctx.mesh.coords["model"])


def _all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over `group`, added in fp32 and returned in x's
    dtype (x is left as it was)."""
    buf = x.to(torch.float32, copy=True)
    tdist.all_reduce(buf, group=group)
    return buf.to(x.dtype)


class _ToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_sum(g, ctx.group), None


class _SumOverModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def to_model(x: torch.Tensor) -> torch.Tensor:
    """`x` unchanged; its gradient summed over 'model' (the input of a
    product whose weight each rank holds a cut of)."""
    ax = model_axis()
    return x if ax is None else _ToModel.apply(x, ax.group)


def sum_over_model(x: torch.Tensor) -> torch.Tensor:
    """`x` summed over 'model' (partial products); its gradient passes
    unchanged."""
    ax = model_axis()
    return x if ax is None else _SumOverModel.apply(x, ax.group)


# ---------------------------------------------------------------------------
# Storage layout -> compute layout
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Cut:
    """The slice of a leaf a layer computes with on this rank: `length`
    entries of dim `dim` from `start` (dim None: the whole leaf).
    `partial`: the ranks' cuts overlap and each rank's gradient is a part
    of the leaf's (they add up over 'model')."""

    dim: int | None = None
    start: int = 0
    length: int = 0
    partial: bool = False

    def even(self, size: int, m: int, index: int) -> bool:
        """Is this rank's cut block `index` of `m` even blocks of a dim of
        `size`?"""
        return (self.dim is not None and not self.partial
                and size % m == 0 and self.length == size // m
                and self.start == index * self.length)


def _all_gather_dim(x: torch.Tensor, dim: int, group, n: int):
    """The `n` ranks' `x` concatenated along `dim`, in group order (one
    all_gather of the bytes)."""
    b = _as_bytes(x)
    parts = [torch.empty_like(b) for _ in range(n)]
    tdist.all_gather(parts, b, group=group)
    shape = tuple(x.shape)
    return torch.cat([p.view(x.dtype).reshape(shape) for p in parts], dim)


def _all_to_all(x: torch.Tensor, split: int, join: int, group, n: int):
    """Block j of `x` along `split` goes to rank j; what comes back from
    the ranks is joined along `join`, in group order (one
    all_to_all_single of the bytes)."""
    send = torch.stack(x.chunk(n, split)).contiguous()
    flat = _as_bytes(send)
    recv = torch.empty_like(flat)
    tdist.all_to_all_single(recv, flat, group=group)
    return torch.cat(recv.view(x.dtype).reshape(send.shape).unbind(0), join)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split, join, group, n):
        ctx.args = (split, join, group, n)
        return _all_to_all(x, split, join, group, n)

    @staticmethod
    def backward(ctx, g):
        split, join, group, n = ctx.args
        return _all_to_all(g, join, split, group, n), None, None, None, None


class _GatherCut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sdim, cut, shape, ax):
        ctx.args = (sdim, cut, shape, ax, tuple(x.shape))
        full = x if sdim is None else _all_gather_dim(x, sdim, ax.group,
                                                      ax.size)
        if cut.dim is None:
            return full
        return full.narrow(cut.dim, cut.start, cut.length).clone()

    @staticmethod
    def backward(ctx, g):
        sdim, cut, shape, ax, local = ctx.args
        if cut.dim is None:
            full = g                           # whole on every rank
        elif cut.partial:
            full = g.new_zeros(shape)
            full.narrow(cut.dim, cut.start, cut.length).copy_(g)
            full = _all_reduce_sum(full, ax.group)
        else:
            full = _all_gather_dim(g.contiguous(), cut.dim, ax.group,
                                   ax.size)
        if sdim is None:
            return full, None, None, None, None
        part = local[sdim]
        return (full.narrow(sdim, ax.index * part, part).clone(), None, None,
                None, None)


def to_compute(x: torch.Tensor, placement: Placement, shape: tuple,
               cut: Cut) -> torch.Tensor:
    """A leaf of global `shape`, held as its stored slice `x` (under
    `placement`), as the `cut` a layer computes with on this rank; its
    gradient comes back as the stored slice's.  A slice that is already
    the cut passes unchanged."""
    ax = model_axis()
    sdim = placement.dim
    if ax is None:
        return x
    shape = tuple(shape)
    if cut.dim is not None and cut.dim == sdim and \
            cut.even(shape[sdim], ax.size, ax.index):
        return x
    if sdim is not None and cut.dim is not None and cut.dim != sdim and \
            cut.even(shape[cut.dim], ax.size, ax.index):
        return _AllToAll.apply(x, cut.dim, sdim, ax.group, ax.size)
    if sdim is None and cut.dim is None:
        return x
    return _GatherCut.apply(x, sdim, cut, shape, ax)
