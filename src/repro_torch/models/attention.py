"""GQA attention: pair-list flash (online-softmax) attention for train and
prefill, dense cache attention for decode.

The port of the JAX package's `models/attention.py`.  `flash_attention`
is held to the reference's pure-jnp pair-list function: the (q block, kv
block) pairs that can hold a live entry are enumerated statically
(`_block_pairs`) and visited in order, each folding its block into the
online-softmax state of its q block.  `flash_attention_pairs` is that
function in plain PyTorch.

On a card, `flash_attention` launches the port's CUDA attention kernels
(`repro_torch.kernels.flash_attention`, the kernel `kernel_for` names:
the wgmma kernel for bf16 at the dense configs' head dims) whenever the
options are ones the kernels compute: no query offset, no softcap and fp32
scores (`kernel_route`), through the autograd Function `FlashAttention`,
whose backward is the backward kernels (the forward keeps each row's LSE
for it only where grad mode is on): training's gradient follows the
kernels.  The rule is static: any other options run the plain pair-list
version (differentiated by autograd), and a kernel that fails to build or
launch raises.  On the CPU the plain pair-list version runs.
`decode_attention` is plain PyTorch in the reference's form (no TPU
kernel backs it).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import ModelConfig, apply_rope, rope_tables

NEG_INF = -1e30


def _block_pairs(nq: int, nkv: int, q_block: int, kv_block: int,
                 causal: bool, window: int, q_offset: int = 0):
    """Static list of (qi, kj) block pairs that contain unmasked entries."""
    pairs = []
    for qi in range(nq):
        q_lo = q_offset + qi * q_block
        q_hi = q_lo + q_block - 1
        for kj in range(nkv):
            k_lo = kj * kv_block
            k_hi = k_lo + kv_block - 1
            if causal and k_lo > q_hi:
                continue                       # entirely in the future
            if window > 0 and k_hi < q_lo - window + 1:
                continue                       # entirely outside the window
            pairs.append((qi, kj))
    return pairs


def kernel_route(q, *, q_offset: int = 0, softcap: float = 0.0,
                 score_dtype=torch.float32) -> bool:
    """True iff `flash_attention` launches the CUDA kernels for these
    options: q on a card, no query offset, no softcap, fp32 scores."""
    return (q.is_cuda and q_offset == 0 and softcap == 0
            and score_dtype == torch.float32)


def flash_attention(q, k, v, *, causal: bool, window: int = 0,
                    q_block: int = 512, kv_block: int = 512,
                    q_offset: int = 0, softcap: float = 0.0,
                    score_dtype=torch.float32):
    """q: [b, tq, h, hd]; k, v: [b, tkv, kvh, hd] (GQA: h % kvh == 0).

    Returns [b, tq, h, hd] in q's dtype.  `q_offset` shifts query
    positions (prefill of a suffix against a longer cache); `score_dtype`
    bf16 keeps the score and probability blocks in bf16, the softmax
    statistics in fp32.  See the module docstring for the kernel route."""
    if kernel_route(q, q_offset=q_offset, softcap=softcap,
                    score_dtype=score_dtype):
        from repro_torch.kernels import flash_attention as fa
        return fa.FlashAttention.apply(q.contiguous(), k.contiguous(),
                                       v.contiguous(), causal, window,
                                       q_block, kv_block,
                                       torch.is_grad_enabled())
    return flash_attention_pairs(q, k, v, causal=causal, window=window,
                                 q_block=q_block, kv_block=kv_block,
                                 q_offset=q_offset, softcap=softcap,
                                 score_dtype=score_dtype)


def flash_attention_pairs(q, k, v, *, causal: bool, window: int = 0,
                          q_block: int = 512, kv_block: int = 512,
                          q_offset: int = 0, softcap: float = 0.0,
                          score_dtype=torch.float32):
    """The reference's pair-list function in plain PyTorch, step for step:
    ragged tails padded to block multiples (padded keys masked, padded
    query rows sliced off), then one online-softmax update per live block
    pair, in `_block_pairs` order."""
    b, tq, h, hd = q.shape
    _, tkv, kvh, _ = k.shape
    assert h % kvh == 0
    group = h // kvh
    q_block = min(q_block, tq)
    kv_block = min(kv_block, tkv)
    tq_orig, tkv_orig = tq, tkv
    q_pad = (-tq) % q_block
    kv_pad = (-tkv) % kv_block
    if q_pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, q_pad))
        tq += q_pad
    if kv_pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, kv_pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, kv_pad))
        tkv += kv_pad
    nq, nkv = tq // q_block, tkv // kv_block
    scale = 1.0 / np.sqrt(hd)
    dev = q.device
    sd = score_dtype

    qb = q.reshape(b, nq, q_block, h, hd)
    kb = k.reshape(b, nkv, kv_block, kvh, hd)
    vb = v.reshape(b, nkv, kv_block, kvh, hd)
    # each q block's online-softmax state, replaced (never written in
    # place, so autograd can differentiate the recurrence)
    acc = [torch.zeros((b, q_block, h, hd), dtype=torch.float32,
                       device=dev)] * nq
    m = [torch.full((b, q_block, h), NEG_INF, dtype=torch.float32,
                    device=dev)] * nq
    l = [torch.zeros((b, q_block, h), dtype=torch.float32, device=dev)] * nq
    q_pos_in_block = torch.arange(q_block, dtype=torch.int32, device=dev)
    k_pos_in_block = torch.arange(kv_block, dtype=torch.int32, device=dev)

    for qi, kj in _block_pairs(nq, nkv, q_block, kv_block, causal, window,
                               q_offset):
        qg = qb[:, qi].reshape(b, q_block, kvh, group, hd)
        s = _einsum("bqkgd,bskd->bqkgs", qg.to(sd), kb[:, kj].to(sd),
                    sd) * scale
        if softcap > 0:
            s = softcap * torch.tanh(s / softcap)
        qpos = q_offset + qi * q_block + q_pos_in_block
        kpos = kj * kv_block + k_pos_in_block
        mask = (kpos[None, :] < tkv_orig).expand(q_block, kv_block)
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        if window > 0:
            mask = mask & (kpos[None, :] > qpos[:, None] - window)
        s = torch.where(mask[None, :, None, None, :], s,
                        torch.tensor(NEG_INF, dtype=s.dtype, device=dev))
        s = s.reshape(b, q_block, kvh * group, kv_block)
        m_blk = s.float().amax(-1)
        m_cur, l_cur, a_cur = m[qi], l[qi], acc[qi]
        m_new = torch.maximum(m_cur, m_blk)
        corr = torch.exp(m_cur - m_new)
        p = torch.exp(s.float() - m_new[..., None]).to(sd)
        pg = p.reshape(b, q_block, kvh, group, kv_block)
        pv = _einsum("bqkgs,bskd->bqkgd", pg, vb[:, kj].to(sd),
                     torch.float32).reshape(b, q_block, kvh * group, hd)
        acc[qi] = a_cur * corr[..., None] + pv
        l[qi] = l_cur * corr + p.float().sum(-1)
        m[qi] = m_new
    out = torch.stack(acc, 1) / torch.clamp(torch.stack(l, 1)[..., None],
                                            min=1e-30)
    out = out.reshape(b, tq, h, hd)
    if q_pad:
        out = out[:, :tq_orig]
    return out.to(q.dtype)


def _einsum(eq: str, a, b, out_dtype):
    """`jnp.einsum(..., preferred_element_type=out_dtype)`: fp32 operands
    (exact for bf16 ones) when the result is fp32, else in the operands'
    dtype."""
    if out_dtype == torch.float32:
        return torch.einsum(eq, a.float(), b.float())
    return torch.einsum(eq, a, b).to(out_dtype)


def decode_attention(q, k_cache, v_cache, pos, *, window: int = 0,
                     softcap: float = 0.0):
    """Single-position decode.  q: [b, 1, h, hd]; caches: [b, S, kvh, hd];
    pos: int32[b], the index of the token being produced (attends to
    <= pos).  Computed in fp32."""
    b, _, h, hd = q.shape
    _, S, kvh, _ = k_cache.shape
    kpos = torch.arange(S, dtype=torch.int32, device=q.device)
    mask = kpos[None, :] <= pos[:, None]                   # [b, S]
    if window > 0:
        mask = mask & (kpos[None, :] > pos[:, None] - window)
    return _cache_attention(q, k_cache, v_cache, mask, softcap)


def ring_decode_attention(q, k_cache, v_cache, pos, kpos, window: int,
                          softcap: float = 0.0):
    """Decode against a ring (windowed) cache.  q: [b, 1, h, hd]; caches:
    [b, W, kvh, hd]; pos: int32[b]; kpos: int32[b, W], the absolute
    position in each ring slot (negative = unwritten)."""
    mask = (kpos >= 0) & (kpos <= pos[:, None]) & \
        (kpos > pos[:, None] - window)
    return _cache_attention(q, k_cache, v_cache, mask, softcap)


def _cache_attention(q, k_cache, v_cache, mask, softcap):
    """One query position per row against its cache, masked by `mask`
    [b, S]: the reference's einsums `bkgd,bskd->bkgs` and
    `bkgs,bskd->bkgd` in fp32, as batched matmuls."""
    b, _, h, hd = q.shape
    kvh = k_cache.shape[2]
    group = h // kvh
    scale = 1.0 / np.sqrt(hd)
    qg = q.reshape(b, kvh, group, hd).float()
    s = torch.matmul(qg, k_cache.float().permute(0, 2, 3, 1)) * scale
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)    # [b,kvh,g,S]
    p = torch.softmax(s, dim=-1)
    out = torch.matmul(p, v_cache.float().permute(0, 2, 1, 3))
    return out.reshape(b, 1, h, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Attention layer (projections + rope; residual wiring lives in transformer)
# ---------------------------------------------------------------------------

def project(x, w):
    """`einsum("btd,d...->bt...", x, w)` as one matmul: x [b, t, d], w
    [d, ...] in x's dtype."""
    out = torch.matmul(x, w.to(x.dtype).reshape(w.shape[0], -1))
    return out.reshape(*x.shape[:-1], *w.shape[1:])


def attn_qkv(x, wq, wk, wv, positions, cfg: ModelConfig, rope=None):
    """Project + rope.  x: [b, t, d] -> q[b,t,h,hd], k/v[b,t,kvh,hd].
    `rope`, when given, is `rope_tables` of `positions`."""
    q, k, v = project(x, wq), project(x, wk), project(x, wv)
    if cfg.family != "ssm":
        if rope is None:
            rope = rope_tables(positions, q.shape[-1], cfg.rope_theta,
                               cfg.mrope_sections)
        q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections, rope)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections, rope)
    return q, k, v


def attn_out(o, wo, x_dtype):
    """`einsum("bthk,hkd->btd", o, wo)` as one matmul."""
    b, t, h, hk = o.shape
    return torch.matmul(o.reshape(b, t, h * hk),
                        wo.to(o.dtype).reshape(h * hk, -1)).to(x_dtype)
