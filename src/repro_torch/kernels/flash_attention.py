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

The gradient: `FlashAttention` (a `torch.autograd.Function`) saves q, k,
v, the output and, where autograd will use it, each row's log-sum-exp
(LSE) of the scaled scores, which both forward kernels and the plain
version write beside the output (`with_lse=True`; the kernels in a
template instance of their own, so inference runs the one without it).
Its backward `flash_attention_bwd` (no TPU kernel: the reference
differentiates its plain attention with XLA) launches, on a card, one of
two kernels by the dtype (`bwd_kernel_for`), both from the saved LSE:

  flash_attention_bwd_wgmma   bf16: tensor cores (wgmma)
                              (`csrc/flash_attention_bwd_wgmma.cu`)
  flash_attention_bwd_tf32x3  fp32: tensor cores, each product as three
                              TF32 products
                              (`csrc/flash_attention_bwd_tf32x3.cu`)

or its plain twin `flash_attention_bwd_plain` on the CPU.  A query row with
no live key has no gradient: the backward raises there.
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


def _heads_first(q, k, v, g: int):
    """q, k, v as [b, heads, t, hd] in the plain versions' arithmetic type
    (fp32; fp64 for fp64 inputs), k and v repeated to the query heads."""
    dt = torch.float64 if q.dtype == torch.float64 else torch.float32
    return (q.to(dt).permute(0, 2, 1, 3),
            k.to(dt).repeat_interleave(g, dim=2).permute(0, 2, 1, 3),
            v.to(dt).repeat_interleave(g, dim=2).permute(0, 2, 1, 3))


def _key_blocks(q_lo: int, q_hi: int, tkv: int, causal: bool, window: int):
    """The plain versions' key blocks [k_lo, k_hi) that may hold a live
    key for query rows [q_lo, q_hi)."""
    for k_lo in range(0, tkv, BLOCK):
        k_hi = min(k_lo + BLOCK, tkv)
        if causal and k_lo > q_hi - 1:
            break
        if window > 0 and k_hi - 1 <= q_lo - window:
            continue
        yield k_lo, k_hi


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          q_block: int = 512, kv_block: int = 512,
                          with_lse: bool = False):
    """q: [b, tq, h, hd]; k, v: [b, tkv, kvh, hd].  Returns [b, tq, h, hd]
    in q's dtype, computed in fp32.  Key blocks masked for a whole query
    block are skipped; masked scores contribute p = 0; rows with no live
    key get the reference's value at `q_block` / `kv_block`
    (`fill_dead_rows`).  `with_lse`: returns (out, lse), lse each row's
    log-sum-exp of the scaled live scores [b, h, tq] in the arithmetic
    type (-inf on a row with no live key)."""
    b, tq, h, hd = q.shape
    tkv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    # [b, h, t, hd] in fp32 (fp64 for fp64 inputs); kv head of query head
    # i is i // g
    qf, kf, vf = _heads_first(q, k, v, g)
    out = torch.empty((b, h, tq, hd), dtype=qf.dtype, device=dev)
    lse = torch.empty((b, h, tq), dtype=qf.dtype, device=dev)
    for q_lo in range(0, tq, BLOCK):
        q_hi = min(q_lo + BLOCK, tq)
        qpos = torch.arange(q_lo, q_hi, device=dev)
        qb = qf[:, :, q_lo:q_hi]
        m = torch.full((b, h, q_hi - q_lo), NEG_INF, dtype=qf.dtype,
                       device=dev)
        l = torch.zeros((b, h, q_hi - q_lo), dtype=qf.dtype, device=dev)
        acc = torch.zeros((b, h, q_hi - q_lo, hd), dtype=qf.dtype,
                          device=dev)
        for k_lo, k_hi in _key_blocks(q_lo, q_hi, tkv, causal, window):
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
        lse[:, :, q_lo:q_hi] = m + torch.log(l)
    out = out.permute(0, 2, 1, 3).to(q.dtype).contiguous()
    out = fill_dead_rows(out, v, causal=causal, window=window,
                         q_block=q_block, kv_block=kv_block)
    return (out, lse) if with_lse else out


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_block: int = 512, kv_block: int = 512,
                    with_lse: bool = False):
    """q: [b, tq, h, hd]; k, v: [b, tkv, kvh, hd]; fp32 or bf16 (on the
    CPU also fp64), one dtype, h % kvh == 0, 1 <= hd <= 256, q_block,
    kv_block >= 1.  Returns [b, tq, h, hd] in q's dtype; `with_lse`:
    (out, lse), lse each row's log-sum-exp of the scaled scores [b, h, tq]
    (`flash_attention_plain`'s; fp32 from either kernel).

    CPU tensors run `flash_attention_plain`; CUDA tensors launch the kernel
    that `kernel_for(dtype, hd)` names, or raise.  No autograd graph: the
    gradient goes through `FlashAttention`."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be [b, t, heads, hd]")
    b, tq, h, hd = q.shape
    tkv, kvh = k.shape[1], k.shape[2]
    _check_dtype("flash_attention", q)
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
                                     q_block=q_block, kv_block=kv_block,
                                     with_lse=with_lse)
    out = torch.empty_like(q)
    lse = None
    if with_lse:
        lse = torch.empty((b, h, tq), dtype=torch.float32, device=dev)
    if q.numel():
        KERNELS[kernel_for(q.dtype, hd)](q, k, v, out, causal, window,
                                         lse=lse)
    out = fill_dead_rows(out, v, causal=causal, window=window,
                         q_block=q_block, kv_block=kv_block)
    return (out, lse) if with_lse else out


def _check_dtype(who: str, q) -> None:
    """fp32 or bf16; fp64 too on the CPU (the plain versions, for
    gradcheck)."""
    ok = (torch.float32, torch.bfloat16) + \
        ((torch.float64,) if q.device.type == "cpu" else ())
    if q.dtype not in ok:
        raise ValueError(f"{who}: dtype {q.dtype}; expected float32 or "
                         "bfloat16")


def flash_attention_bwd_plain(q, k, v, out, dout, *, causal: bool = True,
                              window: int = 0, lse=None):
    """The FlashAttention-2 backward in plain PyTorch, the kernels' twin:
    over query blocks of 512, each row's log-sum-exp over its live keys
    (`lse` [b, h, tq], the forward's, where given; recomputed where not),
    then per live key block P = exp(S - LSE) recomputed, dV += P^T dO,
    dS = P o (dO V^T - D) with D = rowsum(dO o O), dQ += scale dS K,
    dK += scale dS^T Q; dk and dv summed over each kv head's g query heads.
    fp32 (fp64 for fp64 inputs); returns (dq, dk, dv) in the inputs'
    dtypes.  Raises where a row has no live key."""
    b, tq, h, hd = q.shape
    tkv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    _no_dead_rows(tq, tkv, window)
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    qf, kf, vf = _heads_first(q, k, v, g)
    of = out.to(qf.dtype).permute(0, 2, 1, 3)
    dof = dout.to(qf.dtype).permute(0, 2, 1, 3)
    dsum = (dof * of).sum(-1)                                 # D [b, h, tq]
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for q_lo in range(0, tq, BLOCK):
        q_hi = min(q_lo + BLOCK, tq)
        qpos = torch.arange(q_lo, q_hi, device=dev)
        qb, dob = qf[:, :, q_lo:q_hi], dof[:, :, q_lo:q_hi]
        blocks = list(_key_blocks(q_lo, q_hi, tkv, causal, window))

        def scores(k_lo, k_hi):
            kpos = torch.arange(k_lo, k_hi, device=dev)
            mask = _live(qpos, kpos, tkv, causal, window)
            s = torch.matmul(qb, kf[:, :, k_lo:k_hi].transpose(-1, -2)) \
                * scale
            return torch.where(mask, s, NEG_INF), mask

        if lse is None:
            m = torch.full((b, h, q_hi - q_lo), NEG_INF, dtype=qf.dtype,
                           device=dev)
            l = torch.zeros_like(m)
            for k_lo, k_hi in blocks:
                s, mask = scores(k_lo, k_hi)
                m_new = torch.maximum(m, s.amax(-1))
                p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
                l = l * torch.exp(m - m_new) + p.sum(-1)
                m = m_new
            row_lse = m + torch.log(l)
        else:
            row_lse = lse[:, :, q_lo:q_hi].to(qf.dtype)
        for k_lo, k_hi in blocks:
            s, mask = scores(k_lo, k_hi)
            p = torch.where(mask, torch.exp(s - row_lse[..., None]), 0.0)
            kb, vb = kf[:, :, k_lo:k_hi], vf[:, :, k_lo:k_hi]
            dv[:, :, k_lo:k_hi] += torch.matmul(p.transpose(-1, -2), dob)
            dp = torch.matmul(dob, vb.transpose(-1, -2))
            ds = p * (dp - dsum[:, :, q_lo:q_hi, None])
            dq[:, :, q_lo:q_hi] += torch.matmul(ds, kb) * scale
            dk[:, :, k_lo:k_hi] += torch.matmul(ds.transpose(-1, -2), qb) \
                * scale

    def per_kv_head(x, like):        # [b, h, tkv, hd] -> [b, tkv, kvh, hd]
        x = x.reshape(b, kvh, g, tkv, hd).sum(2)
        return x.permute(0, 2, 1, 3).to(like.dtype).contiguous()
    return (dq.permute(0, 2, 1, 3).to(q.dtype).contiguous(),
            per_kv_head(dk, k), per_kv_head(dv, v))


def _no_dead_rows(tq: int, tkv: int, window: int) -> None:
    """The backward is defined where every query row has a live key; a
    row with none (`fill_dead_rows`' value) has no gradient, and no
    self-attention training reaches one."""
    if tq and (tkv == 0 or first_dead_row(tq, tkv, window) < tq):
        raise ValueError(
            f"flash_attention backward: query rows from "
            f"{first_dead_row(tq, tkv, window) if tkv else 0} of {tq} have "
            f"no live key (tkv {tkv}, window {window}); their value is "
            "filled, not attended, and has no gradient")


def bwd_kernel_for(dtype: torch.dtype) -> str:
    """Name of the backward kernel a call with this dtype launches on the
    card: the wgmma kernel for bf16, the 3xTF32 kernel for fp32."""
    if dtype == torch.bfloat16:
        return "flash_attention_bwd_wgmma"
    return "flash_attention_bwd_tf32x3"


def flash_attention_bwd(q, k, v, out, dout, *, causal: bool = True,
                        window: int = 0, lse=None):
    """(dq, dk, dv) of `flash_attention(q, k, v, causal=, window=)` = out,
    for the output gradient `dout` [b, tq, h, hd].  Operands as the
    forward's, `out` and `dout` shaped and typed as q; all contiguous;
    `lse` the forward's (`with_lse=True`), fp32 [b, h, tq] on a card.

    CPU tensors run `flash_attention_bwd_plain` (from `lse` where given);
    CUDA tensors launch the kernel `bwd_kernel_for(dtype)` names from
    `lse`, or raise (also without `lse`).  Raises where a query row has no
    live key."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash_attention_bwd: q, k, v must be "
                         "[b, t, heads, hd]")
    b, tq, h, hd = q.shape
    tkv, kvh = k.shape[1], k.shape[2]
    _check_dtype("flash_attention_bwd", q)
    if not 1 <= hd <= 256:
        raise ValueError(f"flash_attention_bwd: head dim {hd} not in "
                         "[1, 256]")
    if kvh == 0 or h % kvh:
        raise ValueError(f"flash_attention_bwd: {h} query heads are not a "
                         f"multiple of {kvh} kv heads")
    dev = q.device
    _build.check(dev, ("q", q, q.dtype, (b, tq, h, hd)),
                 ("k", k, q.dtype, (b, tkv, kvh, hd)),
                 ("v", v, q.dtype, (b, tkv, kvh, hd)),
                 ("out", out, q.dtype, (b, tq, h, hd)),
                 ("dout", dout, q.dtype, (b, tq, h, hd)))
    _no_dead_rows(tq, tkv, window)
    if _build.runs_plain(dev, "flash_attention_bwd"):
        return flash_attention_bwd_plain(q, k, v, out, dout, causal=causal,
                                         window=window, lse=lse)
    if lse is None:
        raise ValueError("flash_attention_bwd: the kernels take the "
                         "forward's LSE (flash_attention(..., "
                         "with_lse=True))")
    _build.check(dev, ("lse", lse, torch.float32, (b, h, tq)))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if not q.numel():
        return dq, dk.zero_(), dv.zero_()
    BACKWARD[bwd_kernel_for(q.dtype)](q, k, v, out, dout, lse, dq, dk, dv,
                                      causal, window)
    return dq, dk, dv


def bwd_splits(b: int, tkv: int, h: int, kvh: int, sms: int) -> int:
    """How many blocks of either backward's dK/dV kernel share a kv
    head's group of h / kvh query heads: the most, dividing the group, that
    keep its grid within four waves of `sms` blocks (one block an SM).  Its
    blocks take 64 keys."""
    blocks = -(-tkv // 64) * kvh * b
    g = h // kvh
    return max(d for d in range(1, g + 1)
               if g % d == 0 and (d == 1 or blocks * d <= 4 * sms))


def _bwd_tma_launch(name, q, k, v, out, dout, lse, dq, dk, dv, causal,
                    window, fault):
    """Launch the backward kernel `name` (`csrc/<name>.cu`: D, dK/dV's
    partials, their sum, dQ) from the forward's `lse`.  Its TMA maps need
    what the forward's do (`_tma_launch`): where hd is below
    `aligned_head_dim` it runs on zero-padded copies of q, k, v, out and
    dout, and dq, dk, dv take the first hd columns.  `fault` plants one of
    the source's `Fault`s (D left out, the GQA sum over one head, the
    causal mask off by one: 1, 2, 3), for a check that the comparison
    with the plain version catches it; 0 on every path."""
    b, tq, h, hd = q.shape
    tkv, kvh = k.shape[1], k.shape[2]
    hd_k = aligned_head_dim(q.dtype, hd)
    ins, outs = (q, k, v, out, dout), (dq, dk, dv)
    if hd_k != hd:
        ins = tuple(F.pad(t, (0, hd_k - hd)) for t in ins)
        outs = tuple(t.new_empty(t.shape[:-1] + (hd_k,)) for t in outs)
    for arg, t in zip(("q", "k", "v", "out", "dout", "dq", "dk", "dv"),
                      ins + outs):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention_bwd: {arg} is not 16-byte "
                             "aligned")
    dev = q.device
    splits = bwd_splits(b, tkv, h, kvh, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    dsum = torch.empty((b, h, tq), dtype=torch.float32, device=dev)
    parts = torch.empty((2, splits, b, tkv, kvh, hd_k), dtype=torch.float32,
                        device=dev)
    _build.launch(name, name,
                  dev, *(t.data_ptr() for t in ins[:3]), ins[3].data_ptr(),
                  ins[4].data_ptr(), lse.data_ptr(),
                  *(t.data_ptr() for t in outs), dsum.data_ptr(),
                  parts.data_ptr(), b, tq, tkv, h, kvh, hd_k,
                  1.0 / math.sqrt(hd), int(causal), int(window), splits,
                  int(fault))
    for t, o in zip((dq, dk, dv), outs):
        if o is not t:
            t.copy_(o[..., :hd])


def _bwd_wgmma_kernel(q, k, v, out, dout, lse, dq, dk, dv, causal, window,
                      fault: int = 0):
    """Launch `flash_attention_bwd_wgmma` (bf16; `_bwd_tma_launch`)."""
    _bwd_tma_launch("flash_attention_bwd_wgmma", q, k, v, out, dout, lse, dq,
                    dk, dv, causal, window, fault)
    _bwd_wgmma_kernel.launches += 1


def _bwd_tf32x3_kernel(q, k, v, out, dout, lse, dq, dk, dv, causal, window,
                       fault: int = 0):
    """Launch `flash_attention_bwd_tf32x3` (fp32; `_bwd_tma_launch`)."""
    _bwd_tma_launch("flash_attention_bwd_tf32x3", q, k, v, out, dout, lse,
                    dq, dk, dv, causal, window, fault)
    _bwd_tf32x3_kernel.launches += 1


class FlashAttention(torch.autograd.Function):
    """`flash_attention` with a gradient: the forward is the wrapper's
    (the forward kernel on a card, the plain version on the CPU), saving
    q, k, v, the output and, where `keep_lse` and an input needs a
    gradient, the forward's LSE; the backward is `flash_attention_bwd`
    (the backward kernel on a card, its plain twin on the CPU).  Callers
    pass `keep_lse=torch.is_grad_enabled()`: inside `forward` autograd has
    turned grad mode off, and `ctx.needs_input_grad` follows the inputs'
    `requires_grad` even under `torch.no_grad()`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_block, kv_block,
                keep_lse=True):
        lse = None
        if keep_lse and any(ctx.needs_input_grad[:3]):
            out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                       q_block=q_block, kv_block=kv_block,
                                       with_lse=True)
        else:
            out = flash_attention(q, k, v, causal=causal, window=window,
                                  q_block=q_block, kv_block=kv_block)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(),
                                         causal=ctx.causal,
                                         window=ctx.window, lse=lse)
        return dq, dk, dv, None, None, None, None, None


def _tma_launch(name, q, k, v, out, causal, window, *extra):
    """Launch the TMA kernel `name` (`csrc/<name>.cu`), whose TMA maps need
    16-byte aligned tensors with rows of a multiple of 16 bytes: where hd
    is below `aligned_head_dim`, it runs on copies of q, k and v
    zero-padded to it, with the scale of the real hd, and `out` takes the
    first hd columns of the padded output.  `extra`: pointers passed after
    the output's (the LSE's)."""
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
                  *extra, b, tq, k.shape[1], h, k.shape[2], hd_k,
                  1.0 / math.sqrt(hd), int(causal), int(window))
    if o is not out:
        out.copy_(o[..., :hd])


def _wgmma_kernel(q, k, v, out, causal, window, lse=None):
    """Launch `flash_attention_wgmma_kernel`
    (`csrc/flash_attention_wgmma.cu`), writing each row's LSE into `lse`
    (fp32 [b, h, tq]) where given: the pointer is null otherwise."""
    _tma_launch("flash_attention_wgmma", q, k, v, out, causal, window,
                None if lse is None else lse.data_ptr())
    _wgmma_kernel.launches += 1


def _tf32x3_kernel(q, k, v, out, causal, window, lse=None):
    """Launch `flash_attention_tf32x3_kernel`
    (`csrc/flash_attention_tf32x3.cu`), writing each row's LSE into `lse`
    (fp32 [b, h, tq]) where given: the pointer is null otherwise."""
    _tma_launch("flash_attention_tf32x3", q, k, v, out, causal, window,
                None if lse is None else lse.data_ptr())
    _tf32x3_kernel.launches += 1


_wgmma_kernel.launches = 0
_tf32x3_kernel.launches = 0
_bwd_wgmma_kernel.launches = 0
_bwd_tf32x3_kernel.launches = 0
# Each forward kernel's launcher, by the name its launches are counted
# under; the backward's in BACKWARD (`bwd_kernel_for`).
KERNELS = {"flash_attention_wgmma": _wgmma_kernel,
           "flash_attention_tf32x3": _tf32x3_kernel}
BACKWARD = {"flash_attention_bwd_wgmma": _bwd_wgmma_kernel,
            "flash_attention_bwd_tf32x3": _bwd_tf32x3_kernel}


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
