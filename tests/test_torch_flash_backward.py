"""The backward of attention: `kernels.flash_attention.FlashAttention`
(the autograd Function the kernel route runs), its backward
`flash_attention_bwd`, the plain twin `flash_attention_bwd_plain`, and
the CUDA kernel `csrc/flash_attention_bwd.cu` compiled for the CPU.

  * `flash_attention_bwd_plain` against autograd of `flash_attention_plain`
    (fp64: within 1e-10 of the gradient's largest entry) and against
    `jax.vjp` of the reference's pair-list `repro.models.attention.
    flash_attention` (fp32: within FP32_REL of the largest entry), over
    causal / window / non-causal, GQA, ragged tq != tkv and head dims
    7 / 16 / 100;
  * `torch.autograd.gradcheck` of the Function's CPU path in fp64;
  * the raise where a query row has no live key;
  * the kernel: tests/cuda_emu/ (the CUDA runtime emulated with a thread
    per CUDA thread, 3-D grids, warp shuffles, bf16) lets g++ compile
    `flash_attention_bwd.cu` as it is, launches rewritten into calls of
    the emulator; its fp32 instantiation is held against the plain
    backward within FP32_REL of each gradient's largest entry (sums in
    another order) at every padded width (hd 7 -> 32, 40 -> 64, 100 ->
    128, 130 -> 256), its bf16 one at two of them within BF16_REL
    (outputs rounded to bf16: one ulp, 2^-8 relative, plus the fp32
    order); the three faults the source can plant (D left out, the GQA
    sum over one head, the causal mask off by one) must each fail that
    tolerance.  Skipped without g++.  The module runs on one intra-op
    thread, and its cases are small: the emulator runs a thread per CUDA
    thread, beside the other test workers."""

import ctypes
import math
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa

from test_torch_train import one_thread  # noqa: F401

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
    assert calls == [{"causal": True, "window": 0}]
    want = fa.flash_attention_bwd_plain(q.detach(), k, v, out.detach(), do,
                                        causal=True)[0]
    assert torch.equal(dq, want)


# ---------------------------------------------------------------------------
# The kernel, compiled for the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def kernel(tmp_path_factory):
    """`flash_attention_bwd`'s C entry point, compiled by g++ against the
    emulator."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    out = tmp_path_factory.mktemp("bwd_emu")
    src = _build.source("flash_attention_bwd")
    text = LAUNCH.sub(lambda m: f"EmuLaunch({m.group(2)})({m.group(1)})(",
                      src.read_text())
    (out / src.name).write_text(text)
    so = out / "libflash_attention_bwd.so"
    proc = subprocess.run(
        ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-w", "-I",
         str(EMU), "-x", "c++", str(out / src.name), "-o", str(so),
         "-lpthread"], capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    fn = ctypes.CDLL(str(so)).flash_attention_bwd
    fn.argtypes = _build.SIGNATURES["flash_attention_bwd"][
        "flash_attention_bwd"]
    fn.restype = ctypes.c_int
    return fn


def _launch(fn, q, k, v, out, do, causal, window, fault=0):
    b, tq, h, hd = q.shape
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    lse = torch.empty((b, h, tq))
    dsum = torch.empty((b, h, tq))
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             lse.data_ptr(), dsum.data_ptr(), b, tq, k.shape[1], h,
             k.shape[2], hd, 1.0 / math.sqrt(hd), int(causal), int(window),
             int(q.dtype == torch.bfloat16), fault, 0, None)
    assert err == 0
    return dq, dk, dv


# two q tiles where the case allows, GQA, each padded width once
KERNEL_CASES = {
    "causal_gqa_hd16": (1, 70, 70, 2, 1, 16, True, 0),
    "window_hd7": (1, 100, 100, 2, 1, 7, True, 30),
    "noncausal_ragged_hd40": (2, 50, 80, 2, 2, 40, False, 0),
    "causal_ragged_hd100": (1, 60, 90, 2, 1, 100, True, 0),
    "causal_hd130": (1, 40, 40, 2, 1, 130, True, 0),
}


@pytest.mark.parametrize("name,dtype", [
    *((n, "float32") for n in KERNEL_CASES),
    ("causal_gqa_hd16", "bfloat16"), ("causal_ragged_hd100", "bfloat16")])
def test_kernel_matches_plain_backward(kernel, name, dtype):
    case = KERNEL_CASES[name]
    b, tq, tkv, h, kvh, hd, causal, window = case
    dt = getattr(torch, dtype)
    q, k, v, do = _inputs(case, dt, seed=len(name))
    out = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    want = fa.flash_attention_bwd_plain(q, k, v, out, do, causal=causal,
                                        window=window)
    got = _launch(kernel, q, k, v, out, do, causal, window)
    assert [t.dtype for t in got] == [dt] * 3
    _close(got, [w.float() for w in want],
            FP32_REL if dtype == "float32" else BF16_REL, name)


@pytest.mark.parametrize("fault,case", [
    (1, "causal_gqa_hd16"), (2, "causal_gqa_hd16"), (3, "causal_gqa_hd16"),
    (1, "noncausal_ragged_hd40")])
def test_planted_faults_fail_the_tolerance(kernel, fault, case):
    """D left out (1), the GQA sum over one query head (2) and the causal
    mask off by one (3) each put the kernel outside the fp32 tolerance."""
    b, tq, tkv, h, kvh, hd, causal, window = KERNEL_CASES[case]
    q, k, v, do = _inputs(KERNEL_CASES[case], torch.float32, seed=1)
    out = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    want = fa.flash_attention_bwd_plain(q, k, v, out, do, causal=causal,
                                        window=window)
    got = _launch(kernel, q, k, v, out, do, causal, window, fault)
    with pytest.raises(AssertionError):
        _close(got, want, FP32_REL, f"fault {fault}")
