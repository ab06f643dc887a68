"""Step functions: train / prefill / serve (decode), as the reference's
`launch/steps.py` makes them, for every config (attention, MoE, SSM and
hybrid), and the train step on a mesh for the dense decoders and the
encoder."""

from __future__ import annotations

import torch
import torch.distributed as tdist

from repro_torch import dist
from repro_torch.models.common import ModelConfig, tree_leaves, tree_map
from repro_torch.models.transformer import (compute_cuts, forward,
                                            init_params, lm_loss,
                                            lm_loss_terms)
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               compress_grads, decompress_grads)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    grad_compression: str = "none"):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    The gradient of `lm_loss` is `torch.autograd.grad` over the leaves (a
    leaf the loss does not reach gets zeros, as `jax.grad` gives it); with
    `grad_compression` (bf16 / int8) it is compressed and decompressed as
    the data-parallel all-reduce would carry it; then one AdamW update.
    `metrics`: loss, grad_norm, lr, 0-d tensors on the device (no host
    read).  The inputs are left as they were.

    Under an active `dist.axis_rules` context the step is the mesh's
    (`sharded_step`): params and AdamW state are trees of
    `dist.ShardedLeaf` on the context's mesh (`runtime.reshard_state`'s
    placement), `batch` the GLOBAL batch."""

    def train_step(params, opt_state, batch):
        if dist.current() is not None:
            return sharded_step(cfg, opt_cfg, grad_compression, params,
                                opt_state, batch)
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        leaves = tree_leaves(live)
        loss = lm_loss(live, cfg, batch)
        grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True))
        grads = tree_map(lambda p: _or_zeros(next(grads), p), live)
        del live, leaves
        if grad_compression != "none":
            grads, _, meta = compress_grads(grads, None, grad_compression)
            grads = decompress_grads(grads, meta)
        new_params, new_opt, metrics = adamw_update(params, grads, opt_state,
                                                    opt_cfg)
        metrics["loss"] = loss.detach()
        return new_params, new_opt, metrics

    return train_step


def _n_targets(cfg: ModelConfig, batch: dict) -> int:
    """The positions `lm_loss` averages over in `batch` (next-token for a
    causal model, every position for the encoder)."""
    targets = batch["tokens"] if cfg.input_mode == "tokens" \
        else batch["labels"]
    b, t = targets.shape[:2]
    return b * (t - 1 if cfg.causal else t)


def _sum_over_batch(mesh, rules, loss, grads: list):
    """The loss and the gradient leaves summed over the batch mesh axes
    (one all_reduce of them all a batch axis, in fp32; each leaf back in
    its dtype)."""
    axes = dist.batch_axes(mesh, rules)
    if not axes:
        return loss, grads
    flat = torch.cat([loss.reshape(1).float()]
                     + [g.reshape(-1).float() for g in grads])
    for a in axes:
        tdist.all_reduce(flat, group=mesh.groups[a])
    out, at = [], 1
    for g in grads:
        out.append(flat[at:at + g.numel()].reshape(g.shape).to(g.dtype))
        at += g.numel()
    return flat[0], out


def sharded_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                 grad_compression: str, params, opt_state, batch):
    """One train step on the active context's mesh, the same program on
    every rank: this rank's rows of the global `batch` (`dist.local_rows`;
    every row where the batch axes do not divide them), each stored slice
    brought to the cut its layer computes with (`dist.to_compute` over
    `transformer.compute_cuts`), the loss the GLOBAL mean (the rank's CE
    sum over the global target count, summed over the batch axes), the
    gradient back in the stored slices and summed over the batch axes,
    compressed after that reduction, clipped by the global norm, and one
    AdamW update of each rank's slices.  Returns ShardedLeaf trees."""
    mesh, rules = dist.current()
    ax = dist.model_axis()
    group = ax.group if ax is not None else None
    n = _n_targets(cfg, batch)
    split = any(p.spec for p in tree_leaves(
        dist.batch_shardings(batch, mesh, rules)))
    local_batch = dist.local_rows(batch, mesh, rules)
    live = tree_map(lambda p: p.local.detach().requires_grad_(), params)
    cuts = compute_cuts(tree_map(lambda p: p.shape, params), cfg)
    compute = tree_map(lambda x, p, c: dist.to_compute(x, p.placement,
                                                       p.shape, c),
                       live, params, cuts)
    ce, aux = lm_loss_terms(compute, cfg, local_batch)
    loss = ce / n + aux
    leaves = tree_leaves(live)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [_or_zeros(g, p) for g, p in zip(grads, leaves)]
    del compute, leaves
    if split:
        loss, grads = _sum_over_batch(mesh, rules, loss.detach(), grads)
    it = iter(grads)
    grads = tree_map(lambda p: next(it), live)
    del live
    sharded = tree_map(lambda p: p.placement.dim is not None, params)
    if grad_compression != "none":
        grads, _, meta = compress_grads(grads, None, grad_compression,
                                        sharded=sharded, group=group)
        grads = decompress_grads(grads, meta)
    local = tree_map(lambda p: p.local, (params, opt_state))
    new_p, new_s, metrics = adamw_update(*local[:1], grads, local[1],
                                         opt_cfg, sharded=sharded,
                                         group=group)

    def wrap(x, like):
        return dist.ShardedLeaf(x, like.placement, like.shape, like.dtype,
                                like.mesh)
    metrics["loss"] = loss.detach()
    return tree_map(wrap, new_p, params), tree_map(wrap, new_s, opt_state), \
        metrics


def _or_zeros(g, p):
    return torch.zeros_like(p, requires_grad=False) if g is None else g


def init_train_state(cfg: ModelConfig, opt_cfg: AdamWConfig, seed: int = 0,
                     *, device="cuda"):
    """(params drawn from `seed` on `device`, AdamW state of zeros)."""
    params = init_params(cfg, seed, device=device)
    return params, adamw_init(params, opt_cfg)


def make_prefill_step(cfg: ModelConfig, max_len: int = 0):
    """(params, batch) -> (last-token logits, cache).

    `max_len` sizes the KV cache beyond the prompt so decode can append
    (recurrent layers' state has a fixed size);
    `forward` slices to the last position before the head projection."""

    def prefill_step(params, batch):
        logits, cache, _ = forward(params, cfg, batch, mode="prefill",
                                   max_len=max_len)
        return logits, cache

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """(params, cache, batch{tokens[b,1], pos[b]}) -> (logits, new_cache).

    One new token per sequence against a seq_len KV/state cache; the cache
    the caller passes stays valid."""

    def serve_step(params, cache, batch):
        logits, new_cache, _ = forward(params, cfg, batch, mode="decode",
                                       cache=cache)
        return logits, new_cache

    return serve_step
