"""Meshes over the ranks of the `torch.distributed` world: the port of the
JAX package's `launch/mesh.py`, over `core.distributed.make_mesh` (one
process group per axis; every rank of the world calls these, at the same
point).

Mesh axes:
  single pod:  (data=16, model=16)          - 256 ranks
  multi-pod:   (pod=2, data=16, model=16)   - 512 ranks, 'pod' data
                                              parallel too
'pod' and 'data' carry the batch, 'model' the tensor-parallel cuts
(`repro_torch.dist`).
"""

from __future__ import annotations

import math

import torch.distributed as tdist

from repro_torch.core import distributed as dsb


def _world() -> int:
    return tdist.get_world_size() if tdist.is_initialized() else 1


def make_production_mesh(*, multi_pod: bool = False, device="cuda",
                         timeout=None) -> dsb.Mesh:
    """The production mesh; raises unless the world has its 256 (512)
    ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if _world() != math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs "
                         f"{math.prod(shape)} ranks; the world has "
                         f"{_world()}")
    return dsb.make_mesh(shape, axes, device=device, timeout=timeout)


def make_mesh(shape: tuple, axes: tuple, *, device="cuda",
              timeout=None) -> dsb.Mesh:
    """An arbitrary mesh over the first prod(shape) ranks of the world."""
    return dsb.make_mesh(shape, axes, device=device, timeout=timeout)


def make_host_mesh(model: int = 1, *, device="cuda",
                   timeout=None) -> dsb.Mesh:
    """(data = world / model, model) over the whole world."""
    n = _world()
    if n % model:
        raise ValueError(f"a world of {n} ranks has no 'model' axis of "
                         f"{model}")
    return dsb.make_mesh((n // model, model), ("data", "model"),
                         device=device, timeout=timeout)


def describe(mesh) -> str:
    return " x ".join(f"{a}={s}" for a, s in zip(mesh.axis_names,
                                                 mesh.shape))
