"""Mamba-2 SSD (state-space duality) block, chunked.

The port of the JAX package's `models/ssm.py`.  The recurrence
h_t = exp(a_t) h_{t-1} + B_t x_t^T,  y_t = C_t h_t + D x_t  runs chunkwise
(arXiv:2405.21060 §6): within a chunk of length Q its quadratic dual form,
across chunks an associative scan of the [nh, hd, state] states
(`models.scan`, the reference's recursion).  Decode is the O(1) step.
z / x / B / C / dt are separate projections, as in the reference.

The reference's three-operand einsums are split into explicit steps here:
a contraction that materialised [b, nc, Q, Q, nh, hd] would take ~13 GB
at b 2, t 2048, nh 48.  Every `exp` is of a value clipped to [-60, 0],
and the state is fp32, as in the reference.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig
from repro_torch.models.scan import associative_scan

# The SSD chunk of `ssm_block`, as in the reference: a prefill or train
# forward of t tokens needs t % CHUNK == 0 (or t < CHUNK).
CHUNK = 256


def _decay(x):
    return torch.exp(torch.clamp(x, -60.0, 0.0))


def ssd_chunked(x, dt, A_log, B, C, D, *, chunk: int = 256):
    """x: [b, t, nh, hd]; dt: [b, t, nh]; A_log: [nh]; B, C: [b, t, state]
    (one group, broadcast over heads); D: [nh].  Returns (y [b, t, nh, hd]
    in x's dtype, final_state [b, nh, hd, state] fp32)."""
    b, t, nh, hd = x.shape
    state = B.shape[-1]
    chunk = min(chunk, t)
    assert t % chunk == 0
    nc = t // chunk

    a = -torch.exp(A_log.float())                              # [nh] (< 0)
    dt = F.softplus(dt.float())                                # [b, t, nh]
    dA = dt * a                                                # (<= 0)
    xdt = x.float() * dt[..., None]                            # dt-scaled

    xc = xdt.reshape(b, nc, chunk, nh, hd)
    dAc = dA.reshape(b, nc, chunk, nh)
    Bc = B.float().reshape(b, nc, chunk, state)
    Cc = C.float().reshape(b, nc, chunk, state)

    # cumulative decay within each chunk
    seg = torch.cumsum(dAc, dim=2)                             # [b,nc,Q,nh]
    total = seg[:, :, -1:, :]                                  # [b,nc,1,nh]

    # ---- intra-chunk (quadratic dual form) ------------------------------
    # decay[i, j] = exp(seg_i - seg_j) for j <= i, else 0: [b,nc,Q,Q,nh]
    decay = _decay(seg[:, :, :, None, :] - seg[:, :, None, :, :])
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))
    decay = torch.where(causal[None, None, :, :, None], decay, 0.0)
    cb = torch.matmul(Cc, Bc.transpose(-1, -2))                # [b,nc,Q,Q]
    # y_intra[i] = sum_j cb[i,j] decay[i,j] x[j], per head
    m = (cb[..., None] * decay).permute(0, 1, 4, 2, 3)         # [b,nc,nh,Q,Q]
    del decay
    y = torch.matmul(m, xc.permute(0, 1, 3, 2, 4))             # [b,nc,nh,Q,hd]
    del m

    # ---- chunk states + inter-chunk scan ----------------------------------
    w = _decay(total - seg)                                    # [b,nc,Q,nh]
    # states[h, d, s] = sum_j B[j, s] w[j, h] x[j, h, d]
    wx = (w[..., None] * xc).reshape(b, nc, chunk, nh * hd)
    states = torch.matmul(wx.transpose(-1, -2), Bc)            # [b,nc,nh*hd,S]
    states = states.reshape(b, nc, nh, hd, state)
    chunk_decay = _decay(total[:, :, 0, :])                    # [b,nc,nh]

    def combine(left, right):
        dl, sl = left
        dr, sr = right
        return (dl * dr, sr + sl * dr[..., None, None])

    _, st_scan = associative_scan(combine, (chunk_decay, states), dim=1)
    init_states = torch.cat([torch.zeros_like(st_scan[:, :1]),
                             st_scan[:, :-1]], dim=1)

    # ---- inter-chunk output -----------------------------------------------
    # y_inter[i, h, d] = exp(seg[i, h]) sum_s C[i, s] init[h, d, s]
    out_decay = _decay(seg)                                    # [b,nc,Q,nh]
    y_inter = torch.matmul(init_states.reshape(b, nc, nh * hd, state),
                           Cc.transpose(-1, -2))               # [b,nc,nh*hd,Q]
    y_inter = y_inter.reshape(b, nc, nh, hd, chunk).permute(0, 1, 2, 4, 3)
    y_inter = y_inter * out_decay.permute(0, 1, 3, 2)[..., None]

    y = (y + y_inter).permute(0, 1, 3, 2, 4).reshape(b, t, nh, hd)
    y = y + x.float() * D.float()[None, None, :, None]
    final_state = st_scan[:, -1]                               # [b,nh,hd,S]
    return y.to(x.dtype), final_state


def ssd_decode_step(x, dt, A_log, B, C, D, h_prev):
    """One-token recurrence.  x: [b, 1, nh, hd]; B, C: [b, 1, state];
    h_prev: [b, nh, hd, state].  Returns (y [b, 1, nh, hd], h_new)."""
    a = -torch.exp(A_log.float())
    dt = F.softplus(dt.float())[:, 0]                          # [b, nh]
    dA = _decay(dt * a)                                        # [b, nh]
    xdt = x.float()[:, 0] * dt[..., None]                      # [b, nh, hd]
    Bt = B.float()[:, 0]                                       # [b, state]
    Ct = C.float()[:, 0]
    h_new = h_prev * dA[..., None, None] + \
        xdt[..., None] * Bt[:, None, None, :]
    y = torch.matmul(h_new, Ct[:, None, :, None])[..., 0]      # [b, nh, hd]
    y = y + x.float()[:, 0] * D.float()[None, :, None]
    return y[:, None].to(x.dtype), h_new


def causal_conv(x, w, conv_state=None):
    """Depthwise causal conv + SiLU.  x: [b, t, c]; w: [k, c].  Returns (y,
    new_state [b, k-1, c]); `conv_state` (decode) is the previous k - 1
    inputs."""
    k = w.shape[0]
    if conv_state is not None:
        xin = torch.cat([conv_state.to(x.dtype), x], dim=1)
    else:
        xin = F.pad(x, (0, 0, k - 1, 0))
    new_state = xin[:, -(k - 1):]
    t = x.shape[1]
    y = xin[:, 0:t] * w[0]
    for i in range(1, k):
        y = y + xin[:, i:i + t] * w[i]
    return F.silu(y.float()).to(x.dtype), new_state


def ssm_block(x, params, cfg: ModelConfig, *, cache=None):
    """The mamba2 mixer: projections -> conv -> SSD -> gate -> out_proj.
    x: [b, t, d]; cache (decode): {conv_x, conv_B, conv_C, state}, written
    in place with the step's new state, as the attention mixer writes its
    KV cache.  Returns (y [b, t, d], the new cache: `cache` itself in
    decode)."""
    b, t, d = x.shape
    d_in = cfg.ssm_expand * cfg.d_model
    hd = cfg.ssm_headdim
    nh = d_in // hd

    def proj(name):
        return torch.matmul(x, params[name].to(x.dtype))

    z, xi, Braw, Craw, dt = (proj(n) for n in ("w_z", "w_x", "w_B", "w_C",
                                               "w_dt"))
    cs = cache or {}
    xc, new_cx = causal_conv(xi, params["conv_x"], cs.get("conv_x"))
    B, new_cb = causal_conv(Braw, params["conv_B"], cs.get("conv_B"))
    C, new_cc = causal_conv(Craw, params["conv_C"], cs.get("conv_C"))
    xh = xc.reshape(b, t, nh, hd)
    dtb = dt + params["dt_bias"].to(dt.dtype)

    if cache is None:
        y, final_state = ssd_chunked(xh, dtb, params["A_log"], B, C,
                                     params["D"], chunk=CHUNK)
    else:
        y, final_state = ssd_decode_step(xh, dtb, params["A_log"], B, C,
                                         params["D"], cache["state"])
    y = y.reshape(b, t, d_in)
    y = y * F.silu(z.float()).to(y.dtype)                      # gate
    out = torch.matmul(y, params["out_proj"].to(y.dtype))
    new = {"conv_x": new_cx, "conv_B": new_cb, "conv_C": new_cc,
           "state": final_state}
    if cache is None:
        return out, new
    for name, v in new.items():
        cache[name].copy_(v)
    return out, cache


def init_ssm_params(init, cfg: ModelConfig, dtype, layers: int = 0) -> dict:
    """The reference's `init_ssm_params` shapes, dtypes and scales, drawn by
    `init` (the transformer's `_Init`); `layers` of them stacked."""
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    nh = d_in // cfg.ssm_headdim
    S = cfg.ssm_state

    def lin(shape):
        return init.normal(shape, dtype, 1 / math.sqrt(shape[0]),
                           layers=layers)

    def conv(c):
        return init.normal((cfg.ssm_conv, c), dtype, 0.1, layers=layers)

    return {
        "w_z": lin((d, d_in)),
        "w_x": lin((d, d_in)),
        "w_B": lin((d, S)),
        "w_C": lin((d, S)),
        "w_dt": lin((d, nh)),
        "conv_x": conv(d_in),
        "conv_B": conv(S),
        "conv_C": conv(S),
        "A_log": init.const(torch.log(torch.linspace(1.0, 16.0, nh)),
                            layers=layers),
        "D": init.const(torch.ones(nh), layers=layers),
        "dt_bias": init.const(torch.zeros(nh), layers=layers),
        "out_proj": lin((d_in, d)),
    }


def init_ssm_cache(batch: int, cfg: ModelConfig, dtype, *, device="cuda"):
    d_in = cfg.ssm_expand * cfg.d_model
    nh = d_in // cfg.ssm_headdim
    km1 = cfg.ssm_conv - 1

    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    return {"conv_x": zeros((batch, km1, d_in), dtype),
            "conv_B": zeros((batch, km1, cfg.ssm_state), dtype),
            "conv_C": zeros((batch, km1, cfg.ssm_state), dtype),
            "state": zeros((batch, nh, cfg.ssm_headdim, cfg.ssm_state),
                           torch.float32)}
