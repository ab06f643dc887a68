"""Forward attention with an online softmax (flash attention).

`flash_attention(q, k, v, causal=, window=, q_block=, kv_block=)` replaces
the reference's Pallas kernel `kernels/flash_attention.py::
flash_attention_tpu` with one of two CUDA kernels, chosen by the dtype
(`kernel_for`):

  flash_attention_wgmma   bf16 at every head dim 1-256: tensor cores
                          (wgmma) (`csrc/flash_attention_wgmma.cu`)
  flash_attention_tf32x3  fp32 at every head dim 1-256: tensor cores, each
                          product as three TF32 products (hi/lo split)
                          (`csrc/flash_attention_tf32x3.cu`)

Both kernels are built for a few padded widths
(`WGMMA_WIDTHS`, `TF32_WIDTHS`) and run head dim hd at the smallest one
at or above it (`padded_width`), the columns past hd zeros in shared memory
and never stored.  They load their tiles with TMA, whose tensor maps need
rows that are a multiple of 16 bytes: where a row of hd elements is not,
the wrapper runs them on copies of q, k and v zero-padded to
`aligned_head_dim` (a multiple of 8 bf16 or 4 fp32 elements) with the
scale of the real hd, and keeps the first hd columns of the output.

Both read the model's `[b, t, h, hd]` layout directly (the Pallas
wrapper's transposes and padding do not carry over), handle causal,
sliding-window (`key > query - window`) and ragged-length masks and GQA
(query head i reads kv head `i // (h // kvh)`), keep the softmax
statistics in fp32 and return q's type.  The kernels pick their own tiles;
`q_block` / `kv_block` name the reference's, and matter only for a query
row with no live key (a window that ends before the keys do,
`qpos >= tkv + window - 1`): the Pallas kernel gives such a row the mean of
v over the kv tiles it visits for the row's q block, zero-padded positions
counted, and `fill_dead_rows` gives it the same value on both the plain
and the kernel path.

`flash_attention_plain` is the same online-softmax recurrence in plain
PyTorch, over query and key blocks of 512 in fp32, so its memory stays
bounded at long sequences.  `hbm_bytes_model` is the reference's traffic
model.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

NEG_INF = -1e30
BLOCK = 512                  # the plain version's query and key block
# The padded widths each tensor-core kernel is built for (W / hd <= 1.25
# from hd 64 up); the same lists are WGMMA_WIDTHS and TF32_WIDTHS in the
# kernels' sources.  Past 128 the 3xTF32 kernel splits O between its two
# consumers (`csrc/flash_attention_tf32x3.cu`).
WGMMA_WIDTHS = (16, 32, 64, 80, 96, 112, 128, 160, 192, 224, 256)
TF32_WIDTHS = WGMMA_WIDTHS


def padded_width(dtype: torch.dtype, hd: int) -> int | None:
    """The width a tensor-core kernel runs head dim `hd` at: the smallest
    one it is built for that is at least hd (bf16 on the wgmma kernel, fp32
    on the 3xTF32 one); None past the widest."""
    widths = WGMMA_WIDTHS if dtype == torch.bfloat16 else TF32_WIDTHS
    return next((w for w in widths if w >= hd), None)


def kernel_for(dtype: torch.dtype, hd: int) -> str:
    """Name of the CUDA kernel that a call with this dtype and head dim
    (1-256) launches on the card: the wgmma kernel for bf16, the 3xTF32
    kernel for fp32."""
    if dtype == torch.bfloat16:
        return "flash_attention_wgmma"
    return "flash_attention_tf32x3"


def aligned_head_dim(dtype: torch.dtype, hd: int) -> int:
    """The head dim a tensor-core kernel is launched with for head dim hd:
    hd rounded up to a row of a multiple of 16 bytes (8 bf16 or 4 fp32
    elements), as its TMA maps need; the wrapper zero-pads q, k and v to
    it where it is larger."""
    per = 16 // dtype.itemsize
    return -(-hd // per) * per


def _live(qpos, kpos, tkv: int, causal: bool, window: int):
    mask = (kpos < tkv)[None, :]
    if causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])
    if window > 0:
        mask = mask & (kpos[None, :] > qpos[:, None] - window)
    return mask


def first_dead_row(tq: int, tkv: int, window: int) -> int:
    """The first query row with no live key (tq if there is none): with a
    window, rows at or past tkv + window - 1, whose window ends before the
    keys do."""
    if window <= 0:
        return tq
    return min(tq, max(0, tkv + window - 1))


def fill_dead_rows(out, v, *, causal: bool, window: int, q_block: int,
                   kv_block: int):
    """Give the rows of `out` [b, tq, h, hd] that have no live key the
    value of `flash_attention_tpu` at blocks `q_block` / `kv_block`, in
    place: every score it visits there is the finite NEG_INF, so p = 1 at
    every position of the kv tiles it visits for the row's q block, and the
    row is the mean of v (its kv head) over them, zero-padded positions past
    tkv counted (0 where it visits none).  Returns `out`."""
    b, tq, h, hd = out.shape
    tkv, kvh = v.shape[1], v.shape[2]
    first = first_dead_row(tq, tkv, window)
    if first >= tq or tkv == 0:
        return out
    qb, kvb = min(q_block, tq), min(kv_block, tkv)
    nkv = -(-tkv // kvb)
    # [b, nkv, kvh, hd]: v summed over each kv tile, in fp32
    tiles = torch.zeros((b, nkv * kvb, kvh, hd), dtype=torch.float32,
                        device=v.device)
    tiles[:, :tkv] = v.float()
    tiles = tiles.view(b, nkv, kvb, kvh, hd).sum(2)
    for qi in range(first // qb, -(-tq // qb)):
        q_lo = qi * qb
        # the reference's block skip: tiles [lo, hi) are visited
        hi = min(nkv, (q_lo + qb - 1) // kvb + 1) if causal else nkv
        lo = max(0, (q_lo - window - kvb + 1) // kvb + 1)
        val = tiles[:, lo:max(lo, hi)].sum(1) / max(1, (hi - lo) * kvb)
        rows = slice(max(q_lo, first), min(q_lo + qb, tq))
        out[:, rows] = val.repeat_interleave(h // kvh, dim=1)[:, None].to(
            out.dtype)
    return out


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          q_block: int = 512, kv_block: int = 512):
    """q: [b, tq, h, hd]; k, v: [b, tkv, kvh, hd].  Returns [b, tq, h, hd]
    in q's dtype, computed in fp32.  Key blocks masked for a whole query
    block are skipped; masked scores contribute p = 0; rows with no live
    key get the reference's value at `q_block` / `kv_block`
    (`fill_dead_rows`)."""
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
    out = out.permute(0, 2, 1, 3).to(q.dtype).contiguous()
    return fill_dead_rows(out, v, causal=causal, window=window,
                          q_block=q_block, kv_block=kv_block)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_block: int = 512, kv_block: int = 512):
    """q: [b, tq, h, hd]; k, v: [b, tkv, kvh, hd]; fp32 or bf16, one dtype,
    h % kvh == 0, 1 <= hd <= 256, q_block, kv_block >= 1.  Returns
    [b, tq, h, hd] in q's dtype.

    CPU tensors run `flash_attention_plain`; CUDA tensors launch the kernel
    that `kernel_for(dtype, hd)` names, or raise."""
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
    if q_block < 1 or kv_block < 1:
        raise ValueError(f"flash_attention: blocks {q_block}, {kv_block} "
                         "must be positive")
    dev = q.device
    _build.check(dev, ("q", q, q.dtype, (b, tq, h, hd)),
                 ("k", k, q.dtype, (b, tkv, kvh, hd)),
                 ("v", v, q.dtype, (b, tkv, kvh, hd)))
    if _build.runs_plain(dev, "flash_attention"):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_block=q_block, kv_block=kv_block)
    out = torch.empty_like(q)
    if q.numel():
        KERNELS[kernel_for(q.dtype, hd)](q, k, v, out, causal, window)
    return fill_dead_rows(out, v, causal=causal, window=window,
                          q_block=q_block, kv_block=kv_block)


def _tma_launch(name, q, k, v, out, causal, window):
    """Launch the TMA kernel `name` (`csrc/<name>.cu`), whose TMA maps need
    16-byte aligned tensors with rows of a multiple of 16 bytes: where hd
    is below `aligned_head_dim`, it runs on copies of q, k and v
    zero-padded to it, with the scale of the real hd, and `out` takes the
    first hd columns of the padded output."""
    b, tq, h, hd = q.shape
    hd_k = aligned_head_dim(q.dtype, hd)
    o = out
    if hd_k != hd:
        q, k, v = (F.pad(t, (0, hd_k - hd)) for t in (q, k, v))
        o = q.new_empty((b, tq, h, hd_k))
    for arg, t in (("q", q), ("k", k), ("v", v), ("out", o)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {arg} is not 16-byte "
                             "aligned")
    _build.launch(name, name, q.device,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  b, tq, k.shape[1], h, k.shape[2], hd_k, 1.0 / math.sqrt(hd),
                  int(causal), int(window))
    if o is not out:
        out.copy_(o[..., :hd])


def _wgmma_kernel(q, k, v, out, causal, window):
    """Launch `flash_attention_wgmma_kernel`
    (`csrc/flash_attention_wgmma.cu`)."""
    _tma_launch("flash_attention_wgmma", q, k, v, out, causal, window)
    _wgmma_kernel.launches += 1


def _tf32x3_kernel(q, k, v, out, causal, window):
    """Launch `flash_attention_tf32x3_kernel`
    (`csrc/flash_attention_tf32x3.cu`)."""
    _tma_launch("flash_attention_tf32x3", q, k, v, out, causal, window)
    _tf32x3_kernel.launches += 1


_wgmma_kernel.launches = 0
_tf32x3_kernel.launches = 0
# Each CUDA kernel's launcher, by the name its launches are counted under.
KERNELS = {"flash_attention_wgmma": _wgmma_kernel,
           "flash_attention_tf32x3": _tf32x3_kernel}


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
