"""Forward attention with an online softmax (flash attention).

`flash_attention(q, k, v, causal=, window=)` replaces the reference's
Pallas kernel `kernels/flash_attention.py::flash_attention_tpu` with the
CUDA kernel `flash_attention_kernel` (`csrc/flash_attention.cu`).  It reads
the model's `[b, t, h, hd]` layout directly (the Pallas wrapper's
transposes and padding do not carry over), handles causal, sliding-window
(`key > query - window`) and ragged-length masks and GQA (query head i
reads kv head `i // (h // kvh)`), accumulates in fp32 and returns q's
type.  The Pallas `q_block` / `kv_block` tiling hints do not carry over
either: the kernel picks its own tile, and the output does not depend on
it.  A query row with no live key (a window that ends before the keys do)
gives zeros; the Pallas kernel gives there a mean of masked value rows that
depends on its tiling, which the port does not copy.

`flash_attention_plain` is the same online-softmax recurrence in plain
PyTorch, over query and key blocks of 512, so its memory stays bounded at
long sequences.  `hbm_bytes_model` is the reference's traffic model.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
BLOCK = 512                  # the plain version's query and key block


def _live(qpos, kpos, tkv: int, causal: bool, window: int):
    mask = (kpos < tkv)[None, :]
    if causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])
    if window > 0:
        mask = mask & (kpos[None, :] > qpos[:, None] - window)
    return mask


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0):
    """q: [b, tq, h, hd]; k, v: [b, tkv, kvh, hd].  Returns [b, tq, h, hd]
    in q's dtype, computed in fp32.  Key blocks masked for a whole query
    block are skipped; masked scores contribute p = 0."""
    b, tq, h, hd = q.shape
    tkv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    # [b, h, t, hd] in fp32; kv head of query head i is i // g
    qf = q.float().permute(0, 2, 1, 3)
    kf = k.float().repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
    vf = v.float().repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
    out = torch.empty((b, h, tq, hd), dtype=torch.float32, device=dev)
    for q_lo in range(0, tq, BLOCK):
        q_hi = min(q_lo + BLOCK, tq)
        qpos = torch.arange(q_lo, q_hi, device=dev)
        qb = qf[:, :, q_lo:q_hi]
        m = torch.full((b, h, q_hi - q_lo), NEG_INF, device=dev)
        l = torch.zeros((b, h, q_hi - q_lo), device=dev)
        acc = torch.zeros((b, h, q_hi - q_lo, hd), device=dev)
        for k_lo in range(0, tkv, BLOCK):
            k_hi = min(k_lo + BLOCK, tkv)
            if causal and k_lo > q_hi - 1:
                break
            if window > 0 and k_hi - 1 <= q_lo - window:
                continue
            kpos = torch.arange(k_lo, k_hi, device=dev)
            mask = _live(qpos, kpos, tkv, causal, window)
            s = torch.matmul(qb, kf[:, :, k_lo:k_hi].transpose(-1, -2)) \
                * scale
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.matmul(p, vf[:, :, k_lo:k_hi])
            m = m_new
        out[:, :, q_lo:q_hi] = acc / l.clamp(min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype).contiguous()


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: [b, tq, h, hd]; k, v: [b, tkv, kvh, hd]; fp32 or bf16, one dtype,
    h % kvh == 0, 1 <= hd <= 256.  Returns [b, tq, h, hd] in q's dtype.

    CPU tensors run `flash_attention_plain`; CUDA tensors launch the kernel
    or raise."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be [b, t, heads, hd]")
    b, tq, h, hd = q.shape
    tkv, kvh = k.shape[1], k.shape[2]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention: dtype {q.dtype}; expected "
                         "float32 or bfloat16")
    if not 1 <= hd <= 256:
        raise ValueError(f"flash_attention: head dim {hd} not in [1, 256]")
    if kvh == 0 or h % kvh:
        raise ValueError(f"flash_attention: {h} query heads are not a "
                         f"multiple of {kvh} kv heads")
    dev = q.device
    _build.check(dev, ("q", q, q.dtype, (b, tq, h, hd)),
                 ("k", k, q.dtype, (b, tkv, kvh, hd)),
                 ("v", v, q.dtype, (b, tkv, kvh, hd)))
    if _build.runs_plain(dev, "flash_attention"):
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    out = torch.empty_like(q)
    if q.numel():
        _build.launch("flash_attention", "flash_attention", dev,
                      q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), b, tq, tkv, h, kvh, hd,
                      1.0 / math.sqrt(hd), int(causal), int(window),
                      int(q.dtype == torch.bfloat16))
        flash_attention.launches += 1
    return out


flash_attention.launches = 0


def hbm_bytes_model(b, t, h, kvh, hd, *, dtype_bytes=2, train=True) -> float:
    """Analytic HBM traffic of the kernel per layer.  Train counts fwd +
    recompute + bwd (dq/dk/dv) sweeps; inference counts the single fwd
    sweep: read q, k and v once, write o once."""
    q_bytes = b * t * h * hd * dtype_bytes
    kv_bytes = 2 * b * t * kvh * hd * dtype_bytes
    fwd = 2 * q_bytes + kv_bytes
    if not train:
        return fwd
    bwd = 3 * q_bytes + 2 * kv_bytes + 2 * q_bytes + kv_bytes
    return fwd + bwd
