"""Step functions: train / prefill / serve (decode), as the reference's
`launch/steps.py` makes them, for every config (attention, MoE, SSM and
hybrid)."""

from __future__ import annotations

import torch

from repro_torch.models.common import ModelConfig, tree_leaves, tree_map
from repro_torch.models.transformer import forward, init_params, lm_loss
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
    read).  The inputs are left as they were."""

    def train_step(params, opt_state, batch):
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
