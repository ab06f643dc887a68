"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

The port of the JAX package's `models/rglru.py`:

    a_t = exp(-c * softplus(Lambda) * r_t),   r_t = sigmoid(W_a x_t)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t),
    i_t = sigmoid(W_x x_t)

over time as an associative scan (`models.scan`, the reference's
recursion), O(1) a decode step.  The Griffin recurrent block wraps it: two
branches (conv + RG-LRU, GeLU), multiplied, projected out.  `jax.nn.gelu`
is the tanh approximation.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig
from repro_torch.models.scan import associative_scan
from repro_torch.models.ssm import causal_conv

_C = 8.0  # Griffin's fixed scaling constant


def _gate_inputs(x, r, i, lam):
    """(a, b_in) of the recurrence h = a h_prev + b_in, in fp32."""
    log_a = -_C * F.softplus(lam.float()) * torch.sigmoid(r.float())
    a = torch.exp(log_a)
    gated = torch.sigmoid(i.float()) * x.float()
    b_in = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * gated
    return a, b_in


def rglru_scan(x, r, i, lam):
    """x, r, i: [b, t, w]; lam: [w].  Returns (y [b, t, w], h_last [b, w]),
    fp32."""
    a, b_in = _gate_inputs(x, r, i, lam)

    def combine(left, right):
        al, bl = left
        ar, br = right
        return (al * ar, br + bl * ar)

    _, h = associative_scan(combine, (a, b_in), dim=1)
    return h, h[:, -1]


def rglru_step(x, r, i, lam, h_prev):
    """One-token recurrence.  x, r, i: [b, 1, w]; h_prev: [b, w]."""
    a, b_in = _gate_inputs(x[:, 0], r[:, 0], i[:, 0], lam)
    h = a * h_prev + b_in
    return h[:, None], h


def rglru_block(x, params, cfg: ModelConfig, *, cache=None):
    """The Griffin recurrent block.  x: [b, t, d]; cache (decode):
    {conv [b, k-1, w], h [b, w]}, written in place with the step's new
    state, as the attention mixer writes its KV cache.  Returns (y
    [b, t, d], the new cache: `cache` itself in decode)."""

    def proj(v, name):
        return torch.matmul(v, params[name].to(x.dtype))

    xr, xg = proj(x, "w_rec"), proj(x, "w_gelu")
    conv_state = cache["conv"] if cache is not None else None
    xc, new_conv = causal_conv(xr, params["conv_w"], conv_state)
    r, i = proj(xc, "w_a"), proj(xc, "w_x")
    if cache is None:
        h, h_last = rglru_scan(xc, r, i, params["lam"])
    else:
        h, h_last = rglru_step(xc, r, i, params["lam"], cache["h"])
    h = h.to(x.dtype) * F.gelu(xg.float(), approximate="tanh").to(x.dtype)
    out = proj(h, "w_out")
    if cache is None:
        return out, {"conv": new_conv, "h": h_last}
    cache["conv"].copy_(new_conv)
    cache["h"].copy_(h_last)
    return out, cache


def init_rglru_params(init, cfg: ModelConfig, dtype, layers: int = 0) -> dict:
    """The reference's `init_rglru_params` shapes, dtypes and scales, drawn
    by `init` (the transformer's `_Init`); `layers` of them stacked."""
    d = cfg.d_model
    w = cfg.rglru_width or d

    def lin(shape):
        return init.normal(shape, dtype, 1 / math.sqrt(shape[0]),
                           layers=layers)

    return {
        "w_rec": lin((d, w)),
        "w_gelu": lin((d, w)),
        "conv_w": init.normal((4, w), dtype, 0.1, layers=layers),
        "w_a": lin((w, w)),
        "w_x": lin((w, w)),
        "lam": init.const(torch.linspace(0.0, 3.0, w), layers=layers),
        "w_out": lin((w, d)),
    }


def init_rglru_cache(batch: int, cfg: ModelConfig, dtype, *, device="cuda"):
    w = cfg.rglru_width or cfg.d_model
    return {"conv": torch.zeros((batch, 3, w), dtype=dtype, device=device),
            "h": torch.zeros((batch, w), dtype=torch.float32, device=device)}
