"""Step functions: prefill and serve (decode), as the reference's
`launch/steps.py` makes them, for every config (attention, MoE, SSM and
hybrid).  The train step waits for `lm_loss` and the optimizer (ROADMAP
Queue 1 item 5d)."""

from __future__ import annotations

from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import forward


def make_train_step(cfg: ModelConfig, opt_cfg=None,
                    grad_compression: str = "none"):
    """Not ported yet: the train step needs `lm_loss` and `optim`."""
    raise NotImplementedError(
        "make_train_step needs lm_loss and the optimizer, which repro_torch "
        "does not port yet (ROADMAP Queue 1 item 5d)")


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
