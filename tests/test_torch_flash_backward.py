"""The backward of attention: `kernels.flash_attention.FlashAttention`
(the autograd Function the kernel route runs), its backward
`flash_attention_bwd`, the plain twin `flash_attention_bwd_plain`, the
forward's log-sum-exp (LSE) that both kernel routes take from the
forward, the 3xTF32 backward's arithmetic emulated in PyTorch, and the
CUDA headers without tensor cores (`csrc/tf32_convert.cuh`, the 3xTF32
kernels' converters; `csrc/flash_attention_bwd_prep.cuh`, the backward's
D and dK/dV-sum passes) compiled for the CPU.

  * `flash_attention_bwd_plain` against autograd of `flash_attention_plain`
    (fp64: within 1e-10 of the gradient's largest entry) and against
    `jax.vjp` of the reference's pair-list `repro.models.attention.
    flash_attention` (fp32: within FP32_REL of the largest entry), over
    causal / window / non-causal, GQA, ragged tq != tkv and head dims
    7 / 16 / 100;
  * the plain forward's LSE against `torch.logsumexp` of the dense masked
    scores, and the plain backward from it equal to the one that
    recomputes it (fp64, same cases);
  * `torch.autograd.gradcheck` of the Function's CPU path in fp64;
  * `FlashAttention` asking its forward for the LSE where grad mode is on
    and an input needs a gradient, and passing it to the backward; asking
    for none under `torch.no_grad()`; the card branches' launches
    recorded (both forward kernels pass an LSE pointer only where asked,
    each dtype's backward kernel takes it, none without it);
  * the raise where a query row has no live key;
  * `csrc/flash_attention_bwd_tf32x3.cu`'s arithmetic: every product as
    three TF32 products in the kernel's arrangement (`emulated_backward`),
    within the chip's fp32 tolerance (BWD_TOL_FP32 of each gradient's
    largest entry) of the fp64 plain backward at every padded width; one
    TF32 pass is not.  (Its wgmma kernels run only on a card:
    `chip_smoke.py`'s training phase holds them to the plain backward,
    with three planted faults.)
  * tests/cuda_emu/ (the CUDA runtime emulated with a fiber per CUDA
    thread, 3-D grids, warp shuffles, bf16) lets g++ compile the headers,
    launches rewritten into calls of the emulator: the converters' lo
    copies and key-ordered transposes at W 16, 128 and 256 bit for bit
    against plain PyTorch; `attn_bwd_prep` (D = rowsum(dO o O)) and
    `attn_bwd_dkdv_sum` (the dK/dV partials summed) in fp32 and bf16; D
    left out fails.  Skipped without g++.  The module runs on one
    intra-op thread, and its cases are small: the emulator runs a fiber
    per CUDA thread, beside the other test workers."""

import ctypes
import math
import re
import shutil
import subprocess
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa

from torch_threads import one_thread  # noqa: F401

EMU = Path(__file__).resolve().parent / "cuda_emu"
LAUNCH = re.compile(r"([A-Za-z_][\w:]*(?:<[^<>;]*>)?)<<<(.*?)>>>\(", re.S)
FP32_REL = 1e-5
BF16_REL = 2 ** -7
# (b, tq, tkv, h, kvh, hd, causal, window)
CASES = {
    "causal_gqa": (2, 70, 70, 4, 2, 16, True, 0),
    "window_gqa4": (1, 600, 600, 4, 1, 7, True, 100),
    "noncausal_ragged": (2, 50, 80, 2, 2, 16, False, 0),
    "causal_ragged_hd100": (1, 90, 110, 4, 2, 100, True, 0),
    "window_ragged_long": (1, 700, 650, 2, 1, 16, True, 300),
}


def _inputs(case, dtype, seed=0):
    b, tq, tkv, h, kvh, hd, *_ = case
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in
                   ((b, tq, h, hd), (b, tkv, kvh, hd), (b, tkv, kvh, hd),
                    (b, tq, h, hd)))
    return tuple(torch.from_numpy(x).to(dtype) for x in (q, k, v, do))


def _close(got, want, rel, label):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = g.double(), w.double()
        atol = rel * max(float(w.abs().max()), 1e-30)
        err = float((g - w).abs().max())
        assert err <= atol, f"{label} {name}: err {err} > {atol}"


@pytest.mark.parametrize("name", list(CASES))
def test_plain_backward_is_autograd_of_plain_forward(name):
    b, tq, tkv, h, kvh, hd, causal, window = CASES[name]
    q, k, v, do = _inputs(CASES[name], torch.float64)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention_plain(*leaves, causal=causal, window=window)
    want = torch.autograd.grad(out, leaves, do)
    got = fa.flash_attention_bwd_plain(q, k, v, out.detach(), do,
                                       causal=causal, window=window)
    assert [t.dtype for t in got] == [torch.float64] * 3
    _close(got, want, 1e-10, name)


def _dense_lse(q, k, causal, window):
    """Each row's log-sum-exp of the scaled live scores, [b, h, tq], from
    the dense masked score matrix."""
    b, tq, h, hd = q.shape
    tkv, kvh = k.shape[1], k.shape[2]
    kr = k.repeat_interleave(h // kvh, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kr) / math.sqrt(hd)
    qpos, kpos = torch.arange(tq)[:, None], torch.arange(tkv)[None, :]
    live = torch.ones(tq, tkv, dtype=torch.bool)
    if causal:
        live &= kpos <= qpos
    if window > 0:
        live &= kpos > qpos - window
    return torch.logsumexp(s.masked_fill(~live, -math.inf), dim=-1)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_forward_lse_is_logsumexp(name):
    b, tq, tkv, h, kvh, hd, causal, window = CASES[name]
    q, k, v, _ = _inputs(CASES[name], torch.float64)
    out, lse = fa.flash_attention(q, k, v, causal=causal, window=window,
                                  with_lse=True)
    assert lse.shape == (b, h, tq) and lse.dtype == torch.float64
    assert torch.equal(out, fa.flash_attention_plain(
        q, k, v, causal=causal, window=window))
    torch.testing.assert_close(lse, _dense_lse(q, k, causal, window),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_backward_from_lse_equals_recomputed(name):
    """Given the forward's LSE, the plain backward skips its first pass
    and gives what it gives when it recomputes the LSE."""
    b, tq, tkv, h, kvh, hd, causal, window = CASES[name]
    q, k, v, do = _inputs(CASES[name], torch.float64)
    out, lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                        window=window, with_lse=True)
    want = fa.flash_attention_bwd_plain(q, k, v, out, do, causal=causal,
                                        window=window)
    got = fa.flash_attention_bwd(q, k, v, out, do, causal=causal,
                                 window=window, lse=lse)
    _close(got, want, 1e-12, name)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_backward_matches_reference_vjp(name):
    """The reference's pair-list attention (`q_block = kv_block = 32`)
    differentiated by `jax.vjp`."""
    import jax
    import jax.numpy as jnp
    from repro.models import attention as jattn
    b, tq, tkv, h, kvh, hd, causal, window = CASES[name]
    q, k, v, do = _inputs(CASES[name], torch.float32)

    def f(q, k, v):
        return jattn.flash_attention(q, k, v, causal=causal, window=window,
                                     q_block=32, kv_block=32)
    out, vjp = jax.vjp(f, *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    want = [torch.from_numpy(np.array(g)) for g in vjp(jnp.asarray(
        do.numpy()))]
    got = fa.flash_attention_bwd_plain(q, k, v,
                                       torch.from_numpy(np.array(out)),
                                       do, causal=causal, window=window)
    _close(got, want, FP32_REL, name)


def test_function_gradcheck_cpu_fp64():
    """`FlashAttention.apply` on CPU fp64 tensors: its backward (the plain
    twin) against numerical derivatives, causal with a window and GQA."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(s)).requires_grad_()
               for s in ((1, 12, 4, 5), (1, 12, 2, 5), (1, 12, 2, 5)))
    for causal, window in ((True, 5), (False, 0)):
        assert torch.autograd.gradcheck(
            lambda q, k, v: fa.FlashAttention.apply(q, k, v, causal, window,
                                                    4, 4), (q, k, v))


def _spy_lse(monkeypatch):
    """Record what `FlashAttention` asks its forward for (`with_lse`) and
    passes to its backward (`lse`)."""
    seen = {"forward": [], "backward": []}
    fwd, bwd = fa.flash_attention, fa.flash_attention_bwd

    def forward(*args, **kw):
        seen["forward"].append(kw.get("with_lse", False))
        return fwd(*args, **kw)

    def backward(*args, **kw):
        seen["backward"].append(kw.get("lse"))
        return bwd(*args, **kw)
    monkeypatch.setattr(fa, "flash_attention", forward)
    monkeypatch.setattr(fa, "flash_attention_bwd", backward)
    return seen


def test_function_passes_the_saved_lse(monkeypatch):
    """With grad mode on and an input that needs a gradient, the forward
    is asked for its LSE, and the backward gets that LSE (the forward's
    own, equal to the plain version's) and gives its gradient."""
    from repro_torch.models import attention as tattn
    monkeypatch.setattr(tattn, "kernel_route", lambda q, **kw: True)
    seen = _spy_lse(monkeypatch)
    q, k, v, do = _inputs(CASES["window_gqa4"], torch.float32)
    q.requires_grad_()
    out = tattn.flash_attention(q, k, v, causal=True, window=100)
    (dq,) = torch.autograd.grad(out, q, do)
    assert seen["forward"] == [True]
    (lse,) = seen["backward"]
    _, want_lse = fa.flash_attention_plain(q.detach(), k, v, causal=True,
                                           window=100, with_lse=True)
    assert torch.equal(lse, want_lse)
    want = fa.flash_attention_bwd_plain(q.detach(), k, v, out.detach(), do,
                                        causal=True, window=100)[0]
    assert torch.equal(dq, want)


def test_function_keeps_no_lse_without_grad(monkeypatch):
    """Under `torch.no_grad()` (serving's and the families' prefills) the
    forward is asked for no LSE even where the inputs require a gradient
    (`ctx.needs_input_grad` follows `requires_grad` there), and neither
    is it where no input needs one."""
    from repro_torch.models import attention as tattn
    monkeypatch.setattr(tattn, "kernel_route", lambda q, **kw: True)
    seen = _spy_lse(monkeypatch)
    q, k, v, _ = _inputs(CASES["causal_gqa"], torch.float32)
    want = fa.flash_attention_plain(q, k, v, causal=True)
    q.requires_grad_()
    with torch.no_grad():
        out = tattn.flash_attention(q, k, v, causal=True)
    assert torch.equal(out, want)
    out = tattn.flash_attention(q.detach(), k, v, causal=True)
    assert not out.requires_grad and torch.equal(out, want)
    assert seen == {"forward": [False, False], "backward": []}


def _record_launches(monkeypatch):
    """The card branches of the wrappers on CPU tensors, each launch
    recorded as (library, entry point, arguments) instead of made."""
    calls = []
    monkeypatch.setattr(_build, "runs_plain", lambda dev, who: False)
    monkeypatch.setattr(_build, "launch", lambda name, fn, dev, *args:
                        calls.append((name, fn, args)))
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev:
                        types.SimpleNamespace(multi_processor_count=132))
    return calls


def test_forward_card_branch_writes_lse_where_asked(monkeypatch):
    """bf16 on a card: one `flash_attention_wgmma` launch with the LSE's
    pointer where `with_lse` (fp32 [b, h, tq]) and a null one where not;
    fp32 launches the 3xTF32 kernel, which writes one where asked too."""
    from repro_torch import kernels as tk
    calls = _record_launches(monkeypatch)
    tk.reset_launch_counts()
    b, tq, tkv, h, kvh, hd = 1, 40, 40, 4, 2, 16
    q, k, v, _ = _inputs((b, tq, tkv, h, kvh, hd), torch.bfloat16)
    out, lse = fa.flash_attention(q, k, v, causal=True, with_lse=True)
    assert lse.shape == (b, h, tq) and lse.dtype == torch.float32
    fa.flash_attention(q, k, v, causal=True)
    (lib, fn, args), (_, _, plain_args) = calls
    want = len(_build.SIGNATURES[lib][fn]) - 2       # less device, stream
    assert lib == fn == "flash_attention_wgmma" and len(args) == want
    assert args[4] == lse.data_ptr() and plain_args[4] is None
    assert args[5:] == plain_args[5:] == (b, tq, tkv, h, kvh, hd,
                                          1 / math.sqrt(hd), 1, 0)
    q32, k32, v32 = (t.float() for t in (q, k, v))
    out32, lse32 = fa.flash_attention(q32, k32, v32, causal=True,
                                      with_lse=True)
    assert lse32.shape == (b, h, tq) and lse32.dtype == torch.float32
    assert calls[-1][0] == "flash_attention_tf32x3"
    counts = tk.launch_counts()
    assert counts["flash_attention_wgmma"] == 2
    assert counts["flash_attention_tf32x3"] == 1


def test_tf32x3_forward_card_branch_passes_the_lse(monkeypatch):
    """fp32 on a card: `flash_attention_tf32x3` gets the LSE's pointer
    where `with_lse` and a null one where not (the instance without the
    store), the rest of its arguments equal; hd 7 runs zero-padded to 8."""
    calls = _record_launches(monkeypatch)
    b, tq, tkv, h, kvh, hd = 1, 40, 50, 4, 2, 7
    q, k, v, _ = _inputs((b, tq, tkv, h, kvh, hd), torch.float32)
    _, lse = fa.flash_attention(q, k, v, causal=True, window=9,
                                with_lse=True)
    fa.flash_attention(q, k, v, causal=True, window=9)
    (lib, fn, args), (_, _, plain_args) = calls
    assert lib == fn == "flash_attention_tf32x3"
    assert len(args) == len(_build.SIGNATURES[lib][fn]) - 2
    assert args[4] == lse.data_ptr() and plain_args[4] is None
    assert lse.shape == (b, h, tq) and lse.dtype == torch.float32
    assert args[5:] == plain_args[5:] == (b, tq, tkv, h, kvh, 8,
                                          1 / math.sqrt(hd), 1, 9)


def test_backward_card_branch_routes_by_dtype(monkeypatch):
    """On a card bf16 launches `flash_attention_bwd_wgmma` once and fp32
    `flash_attention_bwd_tf32x3` once, each from the forward's LSE (hd 7
    zero-padded to 8 and 4, the group of 4 heads split over `bwd_splits`
    blocks); each launch counted under its own name."""
    from repro_torch import kernels as tk
    calls = _record_launches(monkeypatch)
    tk.reset_launch_counts()
    b, tq, tkv, h, kvh, hd = 1, 70, 70, 4, 1, 7
    splits = fa.bwd_splits(b, tkv, h, kvh, 132)
    assert splits == 4
    for dtype, hd_k in ((torch.bfloat16, 8), (torch.float32, 8)):
        q, k, v, do = _inputs((b, tq, tkv, h, kvh, hd), dtype)
        out, lse = fa.flash_attention_plain(q, k, v, causal=True,
                                            with_lse=True)
        got = fa.flash_attention_bwd(q, k, v, out, do, causal=True, lse=lse)
        assert [t.shape for t in got] == [q.shape, k.shape, v.shape]
        assert [t.dtype for t in got] == [dtype] * 3
        lib, fn, args = calls[-1]
        assert lib == fn == fa.bwd_kernel_for(dtype)
        assert len(args) == len(_build.SIGNATURES[lib][fn]) - 2
        assert args[5] == lse.data_ptr()
        assert args[11:] == (b, tq, tkv, h, kvh, hd_k, 1 / math.sqrt(hd), 1,
                             0, splits, 0)
    assert [c[0] for c in calls] == ["flash_attention_bwd_wgmma",
                                     "flash_attention_bwd_tf32x3"]
    counts = tk.launch_counts()
    assert counts["flash_attention_bwd_wgmma"] == 1
    assert counts["flash_attention_bwd_tf32x3"] == 1
    tk.reset_launch_counts()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_backward_card_branch_needs_the_lse(monkeypatch, dtype):
    """On a card either dtype's backward raises without the forward's LSE,
    before any launch: no route recomputes it."""
    calls = _record_launches(monkeypatch)
    q, k, v, do = _inputs((1, 30, 30, 2, 1, 16), getattr(torch, dtype))
    out = fa.flash_attention_plain(q, k, v, causal=True)
    with pytest.raises(ValueError, match="LSE"):
        fa.flash_attention_bwd(q, k, v, out, do, causal=True)
    assert calls == []


def test_function_keeps_the_fp32_lse_on_a_card(monkeypatch):
    """Under grad mode `FlashAttention` on fp32 card tensors asks the
    3xTF32 forward for its LSE and hands that buffer to the 3xTF32
    backward; without grad mode it asks for none."""
    from repro_torch.models import attention as tattn
    calls = _record_launches(monkeypatch)
    monkeypatch.setattr(tattn, "kernel_route", lambda q, **kw: True)
    q, k, v, do = _inputs((1, 30, 30, 2, 1, 16), torch.float32)
    q.requires_grad_()
    out = tattn.flash_attention(q, k, v, causal=True)
    torch.autograd.grad(out, q, do)
    (fwd, fwd_fn, fwd_args), (bwd, bwd_fn, bwd_args) = calls
    assert fwd == "flash_attention_tf32x3" and fwd_args[4] is not None
    assert bwd == "flash_attention_bwd_tf32x3"
    assert bwd_args[5] == fwd_args[4]
    with torch.no_grad():
        tattn.flash_attention(q, k, v, causal=True)
    assert calls[-1][0] == "flash_attention_tf32x3" and calls[-1][2][4] is None


def test_backward_raises_on_rows_without_live_keys():
    """A window that ends before the keys do leaves query rows with no
    live key (their forward value is filled, not attended): the backward
    raises rather than give them a gradient; so does an empty key set."""
    q, k, v, do = _inputs((1, 40, 10, 2, 1, 8, True, 4), torch.float32)
    out = fa.flash_attention(q, k, v, causal=True, window=4)
    with pytest.raises(ValueError, match="no live key"):
        fa.flash_attention_bwd(q, k, v, out, do, causal=True, window=4)
    with pytest.raises(ValueError, match="no live key"):
        fa.flash_attention_bwd_plain(q, k, v, out, do, causal=True,
                                     window=4)
    e = k[:, :0].contiguous()
    with pytest.raises(ValueError, match="no live key"):
        fa.flash_attention_bwd(q, e, e, out, do, causal=True)


def test_model_route_uses_the_function(monkeypatch):
    """`models.attention.flash_attention` on the kernel route goes through
    `FlashAttention` (so autograd reaches the backward kernel): with the
    route forced on CPU tensors, the gradient is the Function's."""
    from repro_torch.models import attention as tattn
    calls = []
    orig = fa.flash_attention_bwd

    def spy(*args, **kw):
        calls.append(kw)
        return orig(*args, **kw)
    monkeypatch.setattr(tattn, "kernel_route", lambda q, **kw: True)
    monkeypatch.setattr(fa, "flash_attention_bwd", spy)
    q, k, v, do = _inputs(CASES["causal_gqa"], torch.float32)
    q.requires_grad_()
    out = tattn.flash_attention(q, k, v, causal=True)
    (dq,) = torch.autograd.grad(out, q, do)
    ((kw,),) = [calls]
    assert sorted(kw) == ["causal", "lse", "window"]
    assert kw["causal"] is True and kw["window"] == 0
    assert torch.equal(kw["lse"], fa.flash_attention_plain(
        q.detach(), k, v, causal=True, with_lse=True)[1])
    want = fa.flash_attention_bwd_plain(q.detach(), k, v, out.detach(), do,
                                        causal=True)[0]
    assert torch.equal(dq, want)


# ---------------------------------------------------------------------------
# The 3xTF32 backward's arithmetic, emulated on the CPU
# ---------------------------------------------------------------------------

def _emulated(out, name, text):
    """`text` (a CUDA source) compiled by g++ against the emulator into
    `out / lib<name>.so`, launches rewritten into calls of the emulator."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    src = out / f"{name}.cu"
    src.write_text(LAUNCH.sub(
        lambda m: f"EmuLaunch({m.group(2)})({m.group(1)})(", text))
    so = out / f"lib{name}.so"
    proc = subprocess.run(
        ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-w", "-I",
         str(EMU), "-x", "c++", str(src), "-o", str(so), "-lpthread"], capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return ctypes.CDLL(str(so))


# two q tiles where the case allows, GQA, each padded width once
KERNEL_CASES = {
    "causal_gqa_hd16": (1, 70, 70, 2, 1, 16, True, 0),
    "window_hd7": (1, 100, 100, 2, 1, 7, True, 30),
    "noncausal_ragged_hd40": (2, 50, 80, 2, 2, 40, False, 0),
    "causal_ragged_hd100": (1, 60, 90, 2, 1, 100, True, 0),
    "causal_hd130": (1, 40, 40, 2, 1, 130, True, 0),
    "window_gqa_hd256": (1, 90, 90, 4, 1, 256, True, 40),
}
BWD_TOL_FP32 = 1e-4     # chip_smoke.py's BWD_TOL["float32"]


def tf32(x):
    """x with the low 13 mantissa bits cleared: what a TF32 operand of the
    tensor cores keeps."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x):
    """x as its TF32 terms (hi, lo): lo = x - hi is exact in fp32, and the
    tensor cores read it as a TF32 operand too."""
    hi = tf32(x)
    return hi, tf32(x - hi)


def matmul_tf32x3(a, b):
    """a @ b as the 3xTF32 kernels form a product: a_hi b_hi + a_hi b_lo +
    a_lo b_hi, each term of TF32 operands (exact products) in fp32."""
    (a_hi, a_lo), (b_hi, b_lo) = split(a), split(b)
    return a_hi @ b_hi + a_hi @ b_lo + a_lo @ b_hi


def matmul_tf32(a, b):
    return tf32(a) @ tf32(b)


def emulated_backward(matmul, q, k, v, out, do, lse, causal, window):
    """(dq, dk, dv) as `csrc/flash_attention_bwd_tf32x3.cu` forms them from
    the forward's `lse`, fp32, every product through `matmul`: the dK/dV
    kernel's S^T = K Q^T and dP^T = V dO^T, P^T and dS^T = P^T o (dP^T - D)
    in fp32, dV += P^T dO and dK += dS^T Q (A split into hi and lo from
    the accumulator, B the transposed tiles) over its passes of 96
    columns past W 128; the dQ kernel's S = Q K^T and dP = dO V^T again, dQ += dS K over
    its consumers' column halves past W 128; dk and dq scaled once."""
    b, tq, h, hd = q.shape
    tkv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    w = fa.padded_width(torch.float32, hd)
    scale = 1.0 / math.sqrt(hd)
    qf, of, dof = (t.permute(0, 2, 1, 3) for t in (q, out, do))
    kf, vf = (t.repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
              for t in (k, v))
    qpos, kpos = torch.arange(tq)[:, None], torch.arange(tkv)[None, :]
    live = torch.ones(tq, tkv, dtype=torch.bool)
    if causal:
        live &= kpos <= qpos
    if window > 0:
        live &= kpos > qpos - window
    dsum = (dof * of).sum(-1)                                 # D [b, h, tq]
    # dK / dV: keys are M
    st = matmul(kf, qf.transpose(-1, -2))
    pt = torch.where(live.T, torch.exp(st * scale - lse[:, :, None]), 0.0)
    dst = pt * (matmul(vf, dof.transpose(-1, -2)) - dsum[:, :, None])
    passes = [slice(c, c + 96) for c in range(0, hd, 96)] if w > 128 \
        else [slice(0, hd)]
    dv = torch.cat([matmul(pt, dof[..., c]) for c in passes], -1)
    dk = torch.cat([matmul(dst, qf[..., c]) for c in passes], -1) * scale
    # dQ: queries are M
    s = matmul(qf, kf.transpose(-1, -2))
    p = torch.where(live, torch.exp(s * scale - lse[..., None]), 0.0)
    ds = p * (matmul(dof, vf.transpose(-1, -2)) - dsum[..., None])
    halves = [slice(0, w // 2), slice(w // 2, hd)] if w > 128 \
        else [slice(0, hd)]
    dq = torch.cat([matmul(ds, kf[..., c]) for c in halves], -1) * scale

    def per_kv_head(x):              # [b, h, tkv, hd] -> [b, tkv, kvh, hd]
        return x.reshape(b, kvh, g, tkv, hd).sum(2).permute(0, 2, 1, 3)
    return dq.permute(0, 2, 1, 3), per_kv_head(dk), per_kv_head(dv)


@pytest.mark.parametrize("name", list(KERNEL_CASES))
def test_tf32x3_backward_meets_the_fp32_tolerance(name):
    """The 3xTF32 backward's arithmetic, emulated on the CPU from the plain
    forward's LSE, is within BWD_TOL_FP32 of each gradient's largest entry
    of the plain backward in fp64; one TF32 pass is not, so the tolerance
    tells the two apart."""
    b, tq, tkv, h, kvh, hd, causal, window = KERNEL_CASES[name]
    q, k, v, do = _inputs(KERNEL_CASES[name], torch.float32, seed=len(name))
    out, lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                        window=window, with_lse=True)
    want = fa.flash_attention_bwd_plain(
        *(t.double() for t in (q, k, v, out, do)), causal=causal,
        window=window)
    got = emulated_backward(matmul_tf32x3, q, k, v, out, do, lse, causal,
                            window)
    _close(got, want, BWD_TOL_FP32, name)
    one = emulated_backward(matmul_tf32, q, k, v, out, do, lse, causal,
                            window)
    with pytest.raises(AssertionError):
        _close(one, want, BWD_TOL_FP32, f"{name} one TF32 pass")


# ---------------------------------------------------------------------------
# The 3xTF32 kernels' converters, compiled for the CPU
# ---------------------------------------------------------------------------

CONVERT = """
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>
namespace {
SWIZZLED
#include "tf32_convert.cuh"
__global__ void lo_kernel(const uint8_t* src, uint8_t* dst, uint32_t bytes) {
  lo_tile(src, dst, bytes, threadIdx.x, blockDim.x);
}
template <int kKeys>
__global__ void t_kernel(const uint8_t* src, uint8_t* dst, uint8_t* dst_lo,
                         int c0, int rows, int t_rows) {
  transpose_tile<kKeys>(src, dst, dst_lo, c0, rows, t_rows, threadIdx.x,
                        blockDim.x);
}
}
extern "C" int lo(const void* src, void* dst, unsigned bytes) {
  lo_kernel<<<1, 96>>>(static_cast<const uint8_t*>(src),
                       static_cast<uint8_t*>(dst), bytes);
  return 0;
}
extern "C" int transpose(int keys, const void* src, void* dst, void* dst_lo,
                         int c0, int rows, int t_rows) {
  auto* s = static_cast<const uint8_t*>(src);
  auto* d = static_cast<uint8_t*>(dst);
  auto* l = static_cast<uint8_t*>(dst_lo);
  if (keys == 16) t_kernel<16><<<1, 96>>>(s, d, l, c0, rows, t_rows);
  else if (keys == 32) t_kernel<32><<<1, 96>>>(s, d, l, c0, rows, t_rows);
  else if (keys == 64) t_kernel<64><<<1, 96>>>(s, d, l, c0, rows, t_rows);
  else return 1;
  return 0;
}
"""
# What each kernel's converters prepare at W 16, 128 and 256: a tile of
# `keys` rows (the dK/dV kernel's kQ query rows, the dQ kernel's kKeys
# keys) and its transposes, (first column, rows) of t_rows rows each
CONVERT_CASES = {
    "dkdv_w16": (16, 64, [(0, 16)], 16),
    "dkdv_w128": (128, 16, [(0, 128)], 128),
    "dkdv_w256": (256, 16, [(0, 96), (96, 96), (192, 64)], 96),
    "dq_w16": (16, 32, [(0, 16)], 16),
    "dq_w128": (128, 16, [(0, 128)], 128),
    "dq_w256": (256, 16, [(0, 256)], 256),
}


@pytest.fixture(scope="module")
def convert(tmp_path_factory):
    """`csrc/tf32_convert.cuh` compiled by g++ against the emulator, with
    `swizzled` (TMA's 128-byte swizzle) taken from `csrc/tma_wgmma.cuh`."""
    fn = re.search(r"__device__ __forceinline__ uint32_t swizzled\(.*?\n}\n",
                   (_build.CSRC / "tma_wgmma.cuh").read_text(), re.S)
    text = CONVERT.replace("SWIZZLED", fn.group(0)).replace(
        '#include "tf32_convert.cuh"',
        (_build.CSRC / "tf32_convert.cuh").read_text())
    lib = _emulated(tmp_path_factory.mktemp("convert"), "convert", text)
    _P, _I = ctypes.c_void_p, ctypes.c_int
    lib.lo.argtypes = [_P, _P, ctypes.c_uint]
    lib.transpose.argtypes = [_I, _P, _P, _P, _I, _I, _I]
    lib.lo.restype = lib.transpose.restype = _I
    return lib


def swizzled_offsets(rows, cols):
    """Byte offset of each fp32 element [rows, cols] in a TMA tile of
    128-byte rows, 32 columns a chunk of `rows` rows, 128-byte swizzle
    (16-byte unit u of row r at u ^ r % 8)."""
    r, c = torch.arange(rows)[:, None], torch.arange(cols)[None, :]
    unit = (c % 32) // 4
    return (c // 32) * rows * 128 + r * 128 + ((unit ^ (r % 8)) << 4) \
        + 4 * (c % 4)


def transposed_offsets(keys, rows, t_rows):
    """Byte offset of (row n, key) in a transposed tile: each 8 keys in
    the order 0 2 4 6 1 3 5 7; 16 keys a 64-byte row (64-byte swizzle:
    unit u at u ^ (n / 2) % 4), else 128-byte rows of 32 keys, a chunk of
    t_rows rows per 32 keys (128-byte swizzle)."""
    n, key = torch.arange(rows)[:, None], torch.arange(keys)[None, :]
    pos = 8 * (key // 8) + (key % 8) // 2 + 4 * (key % 2)
    u = pos // 4
    if keys == 16:
        return n * 64 + ((u ^ ((n >> 1) & 3)) << 4) + 4 * (pos % 4)
    return (u // 8) * t_rows * 128 + n * 128 + (((u % 8) ^ (n % 8)) << 4) \
        + 4 * (pos % 4)


@pytest.mark.parametrize("name", list(CONVERT_CASES))
def test_converters_split_and_transpose_in_key_order(convert, name):
    """A stage's lo copy (x - x_hi, x_hi its top 19 bits) and the
    transposes of its tile, as each kernel's converters write them at W 16,
    128 and 256, equal plain PyTorch's bit for bit: row n of a transpose
    holds column c0 + n of the tile's rows in the key order the register
    fragments of the accumulator products want."""
    width, keys, parts, t_rows = CONVERT_CASES[name]
    cols = -(-width // 32) * 32
    rng = np.random.default_rng(width + keys)
    x = torch.from_numpy(rng.standard_normal((keys, cols)).astype(
        np.float32))
    tile = torch.zeros(keys * cols, dtype=torch.float32)
    tile[swizzled_offsets(keys, cols).flatten() // 4] = x.flatten()
    lo = torch.full_like(tile, float("nan"))
    assert convert.lo(tile.data_ptr(), lo.data_ptr(), tile.numel() * 4) == 0
    assert torch.equal(lo, tile - tf32(tile))
    for c0, rows in parts:
        size = t_rows * keys
        t, t_lo = (torch.full((size,), float("nan")) for _ in range(2))
        assert convert.transpose(keys, tile.data_ptr(), t.data_ptr(),
                                 t_lo.data_ptr(), c0, rows, t_rows) == 0
        at = transposed_offsets(keys, rows, t_rows) // 4
        want = x[:, c0:c0 + rows].T
        assert torch.equal(t[at], want), (name, c0)
        assert torch.equal(t_lo[at], want - tf32(want)), (name, c0)


# ---------------------------------------------------------------------------
# The bf16 route's passes without tensor cores, compiled for the CPU
# ---------------------------------------------------------------------------

PASSES = """
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
namespace {
#include "flash_attention_bwd_prep.cuh"
}
extern "C" int prep(const void* o, const void* dout, void* dsum, int b,
                    int tq, int h, int hd, int is_bf16, int fault) {
  auto* d = static_cast<float*>(dsum);
  return (int)(is_bf16 ? launch_prep<__nv_bfloat16>(o, dout, d, b, tq, h,
                                                    hd, fault, nullptr)
                       : launch_prep<float>(o, dout, d, b, tq, h, hd, fault,
                                            nullptr));
}
extern "C" int dkdv_sum(const void* parts, void* dk, void* dv, long n,
                        int splits, float scale, int is_bf16) {
  auto* p = static_cast<const float*>(parts);
  return (int)(is_bf16 ? launch_dkdv_sum<__nv_bfloat16>(p, dk, dv, n, splits,
                                                        scale, nullptr)
                       : launch_dkdv_sum<float>(p, dk, dv, n, splits, scale,
                                                nullptr));
}
"""
# (b, tq, h, hd): the kernel takes rows of a multiple of 16 bytes
PREP_CASES = {"b2_hd16": (2, 37, 3, 16), "b1_hd136": (1, 20, 2, 136)}


@pytest.fixture(scope="module")
def passes(tmp_path_factory):
    header = '#include "flash_attention_bwd_prep.cuh"'
    text = PASSES.replace(header, (_build.CSRC / header.split('"')[1])
                          .read_text())
    lib = _emulated(tmp_path_factory.mktemp("bwd_passes"), "passes", text)
    _P, _I = ctypes.c_void_p, ctypes.c_int
    lib.prep.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I]
    lib.dkdv_sum.argtypes = [_P, _P, _P, ctypes.c_long, _I, ctypes.c_float,
                             _I]
    lib.prep.restype = lib.dkdv_sum.restype = ctypes.c_int
    return lib


def _prep(lib, o, do, fault=0):
    b, tq, h, hd = o.shape
    dsum = torch.full((b, h, tq), float("nan"))
    assert lib.prep(o.data_ptr(), do.data_ptr(), dsum.data_ptr(), b, tq, h,
                    hd, int(o.dtype == torch.bfloat16), fault) == 0
    return dsum


@pytest.mark.parametrize("name,dtype", [(n, d) for n in PREP_CASES
                                        for d in ("float32", "bfloat16")])
def test_prep_kernel_matches_plain(passes, name, dtype):
    """D = rowsum(dO o O) [b, h, tq] in fp32 from fp32 or bf16 rows: the
    products exact in fp32, so within FP32_REL of its largest entry (sums
    in another order)."""
    b, tq, h, hd = PREP_CASES[name]
    rng = np.random.default_rng(hd)
    o, do = (torch.from_numpy(rng.standard_normal((b, tq, h, hd)).astype(
        np.float32)).to(getattr(torch, dtype)) for _ in range(2))
    want = (o.double() * do.double()).sum(-1).permute(0, 2, 1)
    got = _prep(passes, o, do)
    err = float((got.double() - want).abs().max())
    assert err <= FP32_REL * float(want.abs().max()), err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prep_fault_fails_the_tolerance(passes, dtype):
    """D left out (fault 1) puts D outside that tolerance."""
    b, tq, h, hd = PREP_CASES["b2_hd16"]
    rng = np.random.default_rng(1)
    o, do = (torch.from_numpy(rng.standard_normal((b, tq, h, hd)).astype(
        np.float32)).to(getattr(torch, dtype)) for _ in range(2))
    want = (o.double() * do.double()).sum(-1).permute(0, 2, 1)
    got = _prep(passes, o, do, fault=1)
    assert float((got.double() - want).abs().max()) > \
        FP32_REL * float(want.abs().max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dkdv_sum_matches_plain(passes, dtype):
    """dk = scale * the splits' partials summed in order, dv the sum, in
    the route's dtype: equal to the same sum in PyTorch rounded once."""
    splits, n = 3, 1000
    rng = np.random.default_rng(splits)
    parts = torch.from_numpy(rng.standard_normal((2, splits, n)).astype(
        np.float32))
    dt = getattr(torch, dtype)
    dk, dv = torch.empty(n, dtype=dt), torch.empty(n, dtype=dt)
    scale = 0.125
    assert passes.dkdv_sum(parts.data_ptr(), dk.data_ptr(), dv.data_ptr(), n,
                           splits, scale, int(dt == torch.bfloat16)) == 0
    acc = torch.zeros((2, n))
    for s in range(splits):
        acc += parts[:, s]
    assert torch.equal(dk, (acc[0] * scale).to(dt))
    assert torch.equal(dv, acc[1].to(dt))
