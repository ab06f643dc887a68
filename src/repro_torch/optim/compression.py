"""Gradient compression for the data-parallel all-reduce (bf16 / int8 with
a per-tensor scale and error feedback): the port of the JAX package's
`optim/compression.py`.

On one device there is no all-reduce: the train step compresses and
decompresses at once, so the update sees what the all-reduce would have
carried.  The residual (what the rounding lost) is carried in fp32 to the
next step's compression.  The int8 scales travel in `meta`, never in the
gradient tree.  `torch.round` rounds half to even, as `jnp.round` does.
On a mesh the step compresses each rank's slices after the gradient's
reduction; an int8 leaf held as slices over `group` (`sharded`) takes its
scale from the whole leaf's largest magnitude (a max over `group`).
"""

from __future__ import annotations

import torch
import torch.distributed as tdist

from repro_torch.models.common import tree_map
from repro_torch.optim.adamw import leaves
from repro_torch.optim.adamw import unflatten as _unflatten


def compress_grads(grads, residual, mode: str = "bf16", *, sharded=None,
                   group=None):
    """Returns (compressed_tree, new_residual_tree, meta).

    mode: none | bf16 | int8.  `meta` is passed to decompress_grads.  The
    compressed tree has the structure of `grads` (bf16 / int8 leaves)."""
    if mode == "none":
        return grads, residual, ("none", None)
    g_leaves = leaves(grads)
    r_leaves = leaves(residual) if residual is not None else \
        [torch.zeros(g.shape, dtype=torch.float32, device=g.device)
         for g in g_leaves]
    if mode == "bf16":
        comped, new_res = [], []
        for g, r in zip(g_leaves, r_leaves):
            tot = g.float() + r
            q = tot.to(torch.bfloat16)
            comped.append(q)
            new_res.append(tot - q.float())
        return (_unflatten(grads, comped), _unflatten(grads, new_res),
                ("bf16", None))
    if mode == "int8":
        comped, new_res, scales = [], [], []
        flags = leaves(sharded) if sharded is not None else \
            [False] * len(g_leaves)
        for g, r, f in zip(g_leaves, r_leaves, flags):
            tot = g.float() + r
            amax = tot.abs().max()
            if f and group is not None:
                tdist.all_reduce(amax, op=tdist.ReduceOp.MAX, group=group)
            scale = torch.clamp(amax, min=1e-12) / 127.0
            q = torch.clamp(torch.round(tot / scale), -127, 127).to(
                torch.int8)
            comped.append(q)
            scales.append(scale)
            new_res.append(tot - q.float() * scale)
        return (_unflatten(grads, comped), _unflatten(grads, new_res),
                ("int8", scales))
    raise ValueError(mode)


def decompress_grads(comped, meta):
    mode, scales = meta if isinstance(meta, tuple) else (meta, None)
    if mode in (None, "none"):
        return comped
    if mode == "bf16":
        return tree_map(lambda g: g.float(), comped)
    if mode == "int8":
        return _unflatten(comped, [q.float() * s for q, s in
                                   zip(leaves(comped), scales)])
    raise ValueError(mode)
