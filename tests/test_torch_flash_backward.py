"""The backward of attention: `kernels.flash_attention.FlashAttention`
(the autograd Function the kernel route runs), its backward
`flash_attention_bwd`, the plain twin `flash_attention_bwd_plain`, the
forward's log-sum-exp (LSE) that the bf16 route takes from the forward,
and the CUDA sources `csrc/flash_attention_bwd.cu` (fp32) and
`csrc/flash_attention_bwd_prep.cuh` (the bf16 route's passes without
tensor cores) compiled for the CPU.

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
    for none under `torch.no_grad()`;
  * the raise where a query row has no live key;
  * the kernels: tests/cuda_emu/ (the CUDA runtime emulated with a thread
    per CUDA thread, 3-D grids, warp shuffles, bf16) lets g++ compile
    `flash_attention_bwd.cu` as it is, launches rewritten into calls of
    the emulator; it is held against the plain backward within FP32_REL
    of each gradient's largest entry (sums in another order) at every
    padded width (hd 7 -> 32, 40 -> 64, 100 -> 128, 130 -> 256); the
    three faults the source can plant (D left out, the GQA sum over one
    head, the causal mask off by one) must each fail that tolerance.
    The bf16 route's `attn_bwd_prep` (D = rowsum(dO o O)) and
    `attn_bwd_dkdv_sum` (the dK/dV partials summed) are compiled the same
    way, in fp32 and bf16, against plain PyTorch; D left out fails.  (The
    route's wgmma kernels run only on a card: `chip_smoke.py`'s training
    phase holds them to the plain backward.)  Skipped without g++.  The
    module runs on one intra-op thread, and its cases are small: the
    emulator runs a thread per CUDA thread, beside the other test
    workers."""

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
    fp32 launches the 3xTF32 kernel, which writes no LSE (None)."""
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
    assert lse32 is None and calls[-1][0] == "flash_attention_tf32x3"
    assert tk.launch_counts()["flash_attention_wgmma"] == 2


def test_backward_card_branch_routes_by_dtype(monkeypatch):
    """On a card bf16 launches `flash_attention_bwd_wgmma` once, from the
    forward's LSE (hd 7 zero-padded to 8, the group of 4 heads split
    over `bwd_splits` blocks), and raises without an LSE before any
    launch; fp32 launches the CUDA-core `flash_attention_bwd`; each
    launch counted under its own name."""
    from repro_torch import kernels as tk
    calls = _record_launches(monkeypatch)
    tk.reset_launch_counts()
    b, tq, tkv, h, kvh, hd = 1, 70, 70, 4, 1, 7
    q, k, v, do = _inputs((b, tq, tkv, h, kvh, hd), torch.bfloat16)
    out, lse = fa.flash_attention_plain(q, k, v, causal=True, with_lse=True)
    with pytest.raises(ValueError, match="LSE"):
        fa.flash_attention_bwd(q, k, v, out, do, causal=True)
    assert calls == []
    got = fa.flash_attention_bwd(q, k, v, out, do, causal=True, lse=lse)
    assert [t.shape for t in got] == [q.shape, k.shape, v.shape]
    assert [t.dtype for t in got] == [torch.bfloat16] * 3
    ((lib, fn, args),) = calls
    assert lib == fn == fa.bwd_kernel_for(torch.bfloat16)
    assert len(args) == len(_build.SIGNATURES[lib][fn]) - 2
    splits = fa.bwd_splits(b, tkv, h, kvh, 132)
    assert splits == 4 and args[5] == lse.data_ptr()
    assert args[11:] == (b, tq, tkv, h, kvh, 8, 1 / math.sqrt(hd), 1, 0,
                         splits, 0)
    q32, k32, v32, o32, do32 = (t.float() for t in (q, k, v, out, do))
    fa.flash_attention_bwd(q32, k32, v32, o32, do32, causal=True)
    assert calls[-1][0] == fa.bwd_kernel_for(torch.float32) == \
        "flash_attention_bwd"
    assert len(calls[-1][2]) == len(_build.SIGNATURES[
        "flash_attention_bwd"]["flash_attention_bwd"]) - 2
    counts = tk.launch_counts()
    assert counts["flash_attention_bwd_wgmma"] == 1
    assert counts["flash_attention_bwd"] == 1
    tk.reset_launch_counts()


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
# The kernel, compiled for the CPU
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


@pytest.fixture(scope="module")
def kernel(tmp_path_factory):
    """`flash_attention_bwd`'s C entry point, compiled by g++ against the
    emulator."""
    src = _build.source("flash_attention_bwd")
    lib = _emulated(tmp_path_factory.mktemp("bwd_emu"), src.stem,
                    src.read_text())
    fn = lib.flash_attention_bwd
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
             fault, 0, None)
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


@pytest.mark.parametrize("name,dtype",
                         [(n, "float32") for n in KERNEL_CASES])
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
    _close(got, want, FP32_REL, name)


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
