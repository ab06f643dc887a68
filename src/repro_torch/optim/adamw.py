"""AdamW with global-norm clipping and a warmup-stable-decay schedule: the
port of the JAX package's `optim/adamw.py`.

Functional over the params tree (nested dicts and tuples of tensors), as
the reference: `adamw_update` returns a new tree and leaves its inputs
alone.  The arithmetic is fp32 whatever the parameter's dtype; the moments
are stored in `moment_dtype`.  Every number stays on the device (the
norm, the learning rate and the step are 0-d tensors): no host read.

On a mesh each rank updates its slices (`sharded`: a tree of bools, the
leaf is a slice over `group`; the update is elementwise, so slicing is
exact) and clips by the norm of the GLOBAL gradient: the sharded leaves'
sums of squares summed over `group` (one all_reduce), a replicated leaf
counted once.

An update is elementwise, so each leaf is updated in slices of at most
`UPDATE_SLICE` elements, the same arithmetic for every element: at
glm4_9b's width the embedding alone has 6.2e8 parameters, and its fp32
temporaries all at once would take some 15 GB.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as tdist

from repro_torch.models.common import tree_map

UPDATE_SLICE = 1 << 26                 # elements of a leaf updated at once


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup: int = 100
    total_steps: int = 10_000
    moment_dtype: str = "float32"    # bfloat16 for the 400B-class models


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def leaves(tree) -> list:
    """The leaves in the reference's (jax.tree) order: dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def unflatten(like, flat):
    """The inverse of `leaves`: `flat`, in that order, in the structure of
    `like` (dict keys in `like`'s order)."""
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            done = {k: build(node[k]) for k in sorted(node)}
            return {k: done[k] for k in node}
        if isinstance(node, (tuple, list)):
            return type(node)(build(v) for v in node)
        return next(it)
    return build(like)


def wsd_schedule(cfg: AdamWConfig, step):
    """The learning rate at `step` (a tensor): linear warmup, then a
    cosine decay to a tenth of `lr` by `total_steps`."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup)
                       / max(cfg.total_steps - cfg.warmup, 1), 0.0, 1.0)
    decay = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (0.1 + 0.9 * decay)


def adamw_init(params, cfg: AdamWConfig) -> dict:
    mdt = _dtype(cfg.moment_dtype)
    first = leaves(params)[0]

    def zeros(p):
        return torch.zeros(p.shape, dtype=mdt, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


def global_norm(tree, *, sharded=None, group=None):
    """sqrt of the sum of squares of every float leaf, in fp32 (int32
    leaves skipped), summed leaf by leaf in the reference's order.  With
    `sharded` (bools in `tree`'s structure) and `group`: the norm of the
    global tree, each sharded leaf's sum of squares summed over `group`."""
    xs = leaves(tree)
    flags = leaves(sharded) if sharded is not None else [False] * len(xs)
    sqs = [(torch.sum(torch.square(x.float())), f)
           for x, f in zip(xs, flags) if x.dtype != torch.int32]
    if group is not None and any(f for _, f in sqs):
        vec = torch.stack([sq if f else torch.zeros_like(sq)
                           for sq, f in sqs])
        tdist.all_reduce(vec, group=group)
        sqs = [(vec[i] if f else sq, f) for i, (sq, f) in enumerate(sqs)]
    total = None
    for sq, _ in sqs:
        total = sq if total is None else total + sq
    if total is None:
        return torch.zeros(())
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm, *, sharded=None, group=None):
    """(grads scaled so their global norm is at most `max_norm`, each in
    its own dtype; the norm before)."""
    g = global_norm(grads, sharded=sharded, group=group)
    scale = torch.clamp(max_norm / torch.clamp(g, min=1e-9), max=1.0)
    return tree_map(lambda x: (x.float() * scale).to(x.dtype), grads), g


def _update_leaf(p, g, m, v, lr, bc1, bc2, cfg: AdamWConfig, mdt):
    """One leaf's new (p, m, v), slice by slice."""
    out_p = torch.empty_like(p)
    out_m = torch.empty(p.shape, dtype=mdt, device=p.device)
    out_v = torch.empty(p.shape, dtype=mdt, device=p.device)
    flat = [t.reshape(-1) for t in (p, g, m, v, out_p, out_m, out_v)]
    n = flat[0].numel()
    for lo in range(0, n, UPDATE_SLICE):
        ps, gs, ms, vs, ops, oms, ovs = (t[lo:lo + UPDATE_SLICE]
                                         for t in flat)
        g32 = gs.float()
        m32 = cfg.b1 * ms.float() + (1 - cfg.b1) * g32
        v32 = cfg.b2 * vs.float() + (1 - cfg.b2) * g32 * g32
        mh = m32 / bc1
        vh = v32 / bc2
        p32 = ps.float()
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p32
        ops.copy_(p32 - lr * delta)
        oms.copy_(m32)
        ovs.copy_(v32)
    return out_p, out_m, out_v


def adamw_update(params, grads, state, cfg: AdamWConfig, *, sharded=None,
                 group=None):
    """Returns (new_params, new_state, metrics {grad_norm, lr}); on a
    mesh, of this rank's slices (`sharded`, `group`: see the module)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, sharded=sharded,
                                       group=group)
    step = state["step"] + 1
    lr = wsd_schedule(cfg, step)
    bc1 = 1.0 - cfg.b1 ** step.float()
    bc2 = 1.0 - cfg.b2 ** step.float()
    mdt = _dtype(cfg.moment_dtype)
    out = tree_map(lambda p, g, m, v: _update_leaf(p, g, m, v, lr, bc1, bc2,
                                                   cfg, mdt),
                   params, grads, state["m"], state["v"])

    def part(i):
        return tree_map(lambda _, t: t[i], params, out)
    return part(0), {"m": part(1), "v": part(2), "step": step}, \
        {"grad_norm": gnorm, "lr": lr}
