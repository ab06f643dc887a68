"""The port's flash attention (`repro_torch.kernels.flash_attention`)
against the JAX reference, on the CPU.

The same seeded numpy inputs go through `flash_attention` on CPU tensors
(its plain version) and through the reference's pure-jnp oracle
`repro.models.attention.flash_attention`; one subprocess installs the jax
alias the Pallas kernel needs on this jax and runs
`flash_attention_tpu(..., interpret=True)` on every case.  The cases and
tolerances are those of `tests/test_flash_kernel.py`: fp32 rtol = atol =
2e-5, bf16 2e-2.  Three ragged cases with rows that have no live key also
go through the Pallas kernel, and every row, those included, equals it.
Which CUDA kernel a call on the card launches is a pure function of
(dtype, head dim), `kernel_for`, tested here with the padded width
(`padded_width`) it runs at and the head dim it is launched with
(`aligned_head_dim`); head dims the card pads (7, 100, 200) go through the
same oracle and Pallas checks, and zero-padding to the width is checked to
change nothing.  The kernels themselves run only on the card
(`chip_smoke.py`).  The 3xTF32 kernel's arithmetic (operands cut to TF32,
three products) is emulated in plain PyTorch and held to the fp32
tolerance the card's run uses.
"""

import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import flash_attention as flash_ref

from repro_torch import kernels as tk
from repro_torch.kernels.flash_attention import (KERNELS, TF32_WIDTHS,
                                                 WGMMA_WIDTHS,
                                                 aligned_head_dim,
                                                 fill_dead_rows,
                                                 first_dead_row,
                                                 flash_attention,
                                                 flash_attention_plain,
                                                 hbm_bytes_model, kernel_for,
                                                 padded_width)
from torch_threads import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]

CASES = [
    # b, t, h, kvh, hd, causal, window, qb, kvb (the JAX tests' blocks)
    (1, 64, 2, 2, 16, True, 0, 32, 32),
    (2, 128, 4, 2, 32, True, 0, 64, 64),
    (1, 96, 4, 1, 16, True, 0, 32, 32),       # GQA g=4
    (2, 64, 2, 2, 16, False, 0, 32, 32),      # bidirectional (encoder)
    (1, 128, 4, 4, 16, True, 32, 32, 32),     # sliding window
    (1, 64, 8, 2, 64, True, 0, 64, 16),       # tall kv blocks
]
BF16 = (2, 64, 4, 2, 32, True, 0, 32, 32)
# bf16 at a head dim the card serves with the wgmma kernel, with a window
BF16_HD80 = (2, 64, 4, 2, 80, True, 20, 32, 32)
DENSE = (1, 48, 2, 2, 16, True, 0, 16, 16)
RAGGED = {
    # b, tq, tkv, h, kvh, hd, causal, window, qb, kvb: rows 60-69 have no
    # live key (a window that ends before the keys do)
    "ragged_causal_w16": (1, 70, 45, 4, 2, 24, True, 16, 32, 32),
    "ragged_bidir_w16": (1, 70, 45, 4, 2, 24, False, 16, 32, 32),
    # rows 84-99, in two q blocks that visit different kv tiles; tkv is not
    # a multiple of kvb, and the window spans two q blocks
    "ragged_causal_w40": (1, 100, 45, 4, 2, 24, True, 40, 32, 32),
}
# Head dims that no tensor-core kernel width equals, so the card pads them
# (hd 7 and 100 also in the wrapper, to rows of 16 bytes, in bf16; 200 is
# bf16 only on the tensor cores): b, tq, tkv, h, kvh, hd, causal, window,
# qb, kvb; ragged, a window, every row with a live key.
PADDED = {f"{prefix}hd{hd}": (1, 90, 70, 4, 1, hd, True, 24, 32, 32)
          for prefix in ("", "bf16_") for hd in (7, 100, 200)}


def make(b, tq, tkv, h, kvh, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, tq, h, hd)).astype(np.float32),
            rng.standard_normal((b, tkv, kvh, hd)).astype(np.float32),
            rng.standard_normal((b, tkv, kvh, hd)).astype(np.float32))


def port(q, k, v, dtype=torch.float32, **kw):
    before = tk.launch_counts()
    out = flash_attention(*(torch.from_numpy(x).to(dtype) for x in (q, k, v)),
                          **kw)
    assert tk.launch_counts() == before       # the CPU runs the plain one
    assert out.dtype == dtype
    return out.float().numpy()


def jax_ref(q, k, v, dtype=jnp.float32, **kw):
    out = flash_ref(*(jnp.asarray(x, dtype) for x in (q, k, v)), **kw)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("b,t,h,kvh,hd,causal,window,qb,kvb", CASES)
def test_flash_matches_jax_oracle(b, t, h, kvh, hd, causal, window, qb, kvb):
    q, k, v = make(b, t, t, h, kvh, hd)
    got = port(q, k, v, causal=causal, window=window)
    want = jax_ref(q, k, v, causal=causal, window=window, q_block=qb,
                   kv_block=kvb)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_flash_bf16_matches_jax_oracle():
    b, t, h, kvh, hd, causal, _, qb, kvb = BF16
    q, k, v = make(b, t, t, h, kvh, hd)
    got = port(q, k, v, torch.bfloat16, causal=causal)
    want = jax_ref(q, k, v, jnp.bfloat16, causal=causal, q_block=qb,
                   kv_block=kvb)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


def test_flash_matches_dense_softmax():
    b, t, h, _, hd, *_ = DENSE
    q, k, v = make(b, t, t, h, h, hd, seed=3)
    got = port(q, k, v, causal=True)
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(hd)
    s = jnp.where(np.tril(np.ones((t, t), bool))[None, None], s, -1e30)
    want = jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(s, -1), v)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)


_TPU_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    from jax.experimental.pallas import tpu as pltpu
    if not hasattr(pltpu, "TPUMemorySpace"):   # renamed in newer jax
        pltpu.TPUMemorySpace = pltpu.MemorySpace
    import jax.numpy as jnp
    from repro.kernels.flash_attention import (flash_attention_tpu,
                                               hbm_bytes_model)
    arrays = np.load(sys.argv[1])
    out = {}
    for name in sorted({key.split("/")[0] for key in arrays}):
        dtype = jnp.bfloat16 if name.startswith("bf16") else jnp.float32
        q, k, v = (jnp.asarray(arrays[f"{name}/{x}"], dtype) for x in "qkv")
        causal, window, qb, kvb = (int(x) for x in arrays[f"{name}/static"])
        got = flash_attention_tpu(q, k, v, causal=bool(causal),
                                  window=window, q_block=qb, kv_block=kvb,
                                  interpret=True)
        out[name] = np.asarray(got, np.float32)
    for i, args in enumerate(((1, 4096, 32, 2, 128), (2, 8192, 32, 8, 128))):
        for train in (True, False):
            out[f"hbm_model/{i}/{train}"] = np.float64(
                hbm_bytes_model(*args, train=train))
    np.savez(sys.argv[2], **out)
""")

ALL = {f"case{i}": c for i, c in enumerate(CASES)}
ALL["bf16"] = BF16
ALL["bf16_hd80"] = BF16_HD80
ALL["dense"] = DENSE


def case_inputs(name):
    b, t, h, kvh, hd, *_ = ALL[name]
    return make(b, t, t, h, kvh, hd, seed=3 if name == "dense" else 0)


@pytest.fixture(scope="module")
def tpu_out(tmp_path_factory):
    """Every case through the Pallas kernel (interpret mode), in one
    subprocess."""
    tmp = tmp_path_factory.mktemp("jax_flash")
    arrays = {}
    for name, (b, t, h, kvh, hd, causal, window, qb, kvb) in ALL.items():
        for x, a in zip("qkv", case_inputs(name)):
            arrays[f"{name}/{x}"] = a
        arrays[f"{name}/static"] = np.array([causal, window, qb, kvb])
    for name, (b, tq, tkv, h, kvh, hd, causal, window, qb,
               kvb) in {**RAGGED, **PADDED}.items():
        for x, a in zip("qkv", make(b, tq, tkv, h, kvh, hd, seed=11)):
            arrays[f"{name}/{x}"] = a
        arrays[f"{name}/static"] = np.array([causal, window, qb, kvb])
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _TPU_SCRIPT, str(tmp / "in.npz"),
         str(tmp / "out.npz")],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("name", list(ALL))
def test_flash_matches_pallas_kernel(tpu_out, name):
    _, _, _, _, _, causal, window, _, _ = ALL[name]
    q, k, v = case_inputs(name)
    bf16 = name.startswith("bf16")
    tol = 2e-2 if bf16 else 2e-5
    dtype = torch.bfloat16 if bf16 else torch.float32
    got = port(q, k, v, dtype, causal=causal, window=window)
    np.testing.assert_allclose(got, tpu_out[name], rtol=tol, atol=tol)


def test_ragged_lengths_and_fully_masked_rows():
    """tq != tkv with ragged ends against a dense reference; a row with no
    live key (a window that ends before the keys do) gives the reference's
    value at the default blocks of 512: one q block and one kv tile of all
    45 keys, so the mean of v over them."""
    rng = np.random.default_rng(11)
    b, tq, tkv, h, kvh, hd = 1, 70, 45, 4, 2, 24
    q = torch.from_numpy(rng.standard_normal((b, tq, h, hd)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((b, tkv, kvh, hd)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((b, tkv, kvh, hd)).astype(
        np.float32))
    for causal, window in ((True, 0), (False, 0), (True, 16), (False, 16)):
        got = flash_attention(q, k, v, causal=causal, window=window)
        kk = k.repeat_interleave(h // kvh, dim=2)
        vv = v.repeat_interleave(h // kvh, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", q, kk) / math.sqrt(hd)
        qpos, kpos = torch.arange(tq)[:, None], torch.arange(tkv)[None, :]
        live = torch.ones(tq, tkv, dtype=torch.bool)
        if causal:
            live &= kpos <= qpos
        if window:
            live &= kpos > qpos - window
        p = torch.where(live, torch.softmax(s.masked_fill(~live, -1e30), -1),
                        0.0)
        want = torch.einsum("bhqk,bkhd->bqhd", p, vv)
        dead = ~live.any(1)
        assert bool(dead.any()) == bool(window)   # rows past tkv + window
        want[:, dead] = vv.mean(1, keepdim=True)
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_plain_blocks_cover_long_sequences():
    """Sequences over one plain block of 512 (several q and kv blocks,
    causal and window skips) agree with a dense reference."""
    rng = np.random.default_rng(12)
    b, t, h, kvh, hd = 1, 1100, 2, 1, 8
    q, k, v = (torch.from_numpy(rng.standard_normal((b, t, x, hd)).astype(
        np.float32)) for x in (h, kvh, kvh))
    for window in (0, 300):
        got = flash_attention_plain(q, k, v, causal=True, window=window)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k.expand(b, t, h, hd)) \
            / math.sqrt(hd)
        live = torch.tril(torch.ones(t, t, dtype=torch.bool))
        if window:
            live &= torch.arange(t)[None, :] > torch.arange(t)[:, None] - window
        want = torch.einsum("bhqk,bkhd->bqhd",
                            torch.softmax(s.masked_fill(~live, -1e30), -1),
                            v.expand(b, t, h, hd))
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros((1, 8, 4, 16))
    kv = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="dtype"):
        flash_attention(q.half(), kv.half(), kv.half())
    with pytest.raises(ValueError, match="head dim"):
        z = torch.zeros((1, 8, 2, 300))
        flash_attention(z, z, z)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, torch.zeros((1, 8, 3, 16)), torch.zeros((1, 8, 3,
                                                                     16)))
    with pytest.raises(ValueError, match="k:"):
        flash_attention(q, kv.bfloat16(), kv)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q, kv.transpose(1, 2).contiguous().transpose(1, 2),
                        kv)
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(q.to("meta"), kv.to("meta"), kv.to("meta"))
    with pytest.raises(ValueError, match="blocks"):
        flash_attention(q, kv, kv, q_block=0)


def test_hbm_bytes_model_is_the_reference_model(tpu_out):
    for i, args in enumerate(((1, 4096, 32, 2, 128), (2, 8192, 32, 8, 128))):
        for train in (True, False):
            assert hbm_bytes_model(*args, train=train) == \
                tpu_out[f"hbm_model/{i}/{train}"]
    # glm4_9b's forward at t = 4096 in bf16: 71.3 MB, 21 us at 3.35 TB/s
    assert hbm_bytes_model(1, 4096, 32, 2, 128, train=False) == 71303168


@pytest.mark.parametrize("name", list(RAGGED))
def test_dead_rows_match_pallas_kernel(tpu_out, name):
    """tq != tkv, ragged, with a window: every row equals the Pallas kernel
    at the same blocks, the rows with no live key included (there it
    returns the mean of the masked and zero-padded v rows of the kv tiles
    it visits, which `fill_dead_rows` computes)."""
    b, tq, tkv, h, kvh, hd, causal, window, qb, kvb = RAGGED[name]
    q, k, v = make(b, tq, tkv, h, kvh, hd, seed=11)
    got = port(q, k, v, causal=causal, window=window, q_block=qb,
               kv_block=kvb)
    want = tpu_out[name]
    qpos, kpos = np.arange(tq)[:, None], np.arange(tkv)[None, :]
    live = kpos > qpos - window
    if causal:
        live &= kpos <= qpos
    dead = ~live.any(1)
    assert dead.sum() == tq - first_dead_row(tq, tkv, window) > 0
    assert np.isfinite(want).all() and want[:, dead].any()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


# hd: the width and the head dim the kernel is launched with (hd padded
# to rows of a multiple of 16 bytes) of a bf16 call, then of an fp32 call.
ROUTES = {
    1: (16, 8, 16, 4), 7: (16, 8, 16, 8), 16: (16, 16, 16, 16),
    50: (64, 56, 64, 52), 80: (80, 80, 80, 80), 96: (96, 96, 96, 96),
    100: (112, 104, 112, 100), 127: (128, 128, 128, 128),
    128: (128, 128, 128, 128), 129: (160, 136, 160, 132),
    200: (224, 200, 224, 200), 256: (256, 256, 256, 256),
}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("hd", list(ROUTES))
def test_kernel_for_names_each_route(hd, dtype):
    """bf16 at every head dim goes to the wgmma kernel and fp32 at every
    head dim to the 3xTF32 kernel, each at the smallest width it is built
    for at or above hd, launched with hd rounded up to rows of a multiple
    of 16 bytes (TMA's strides; the wrapper zero-pads to it)."""
    bf16 = dtype == "bfloat16"
    width, hd_k = ROUTES[hd][:2] if bf16 else ROUTES[hd][2:]
    dt = getattr(torch, dtype)
    assert padded_width(dt, hd) == width
    assert kernel_for(dt, hd) == ("flash_attention_wgmma" if bf16
                                  else "flash_attention_tf32x3")
    assert aligned_head_dim(dt, hd) == hd_k
    assert hd <= hd_k <= width and (hd_k * dt.itemsize) % 16 == 0


def test_padded_widths_cost_at_most_a_quarter():
    """From hd 64 up a padded width is at most 1.25 hd, so the padding
    costs the tensor cores at most a quarter more work; every hd in 1-256
    has a width in both dtypes, the smallest of the kernel's widths at or
    above it, on the dtype's kernel."""
    assert WGMMA_WIDTHS == (16, 32, 64, 80, 96, 112, 128, 160, 192, 224, 256)
    assert TF32_WIDTHS == WGMMA_WIDTHS
    for dtype, widths in ((torch.bfloat16, WGMMA_WIDTHS),
                          (torch.float32, TF32_WIDTHS)):
        for hd in range(1, 257):
            w = padded_width(dtype, hd)
            assert w == min(x for x in widths if x >= hd)
            assert w % 16 == 0
            assert hd < 64 or w <= 1.25 * hd
            assert kernel_for(dtype, hd) == (
                "flash_attention_wgmma" if dtype == torch.bfloat16
                else "flash_attention_tf32x3")
        assert padded_width(dtype, 257) is None
    assert sorted(KERNELS) == ["flash_attention_tf32x3",
                               "flash_attention_wgmma"]


def test_fill_dead_rows_touches_only_dead_rows():
    """`fill_dead_rows` writes the rows with no live key and no other, with
    each q block's mean over the kv tiles the reference visits."""
    rng = np.random.default_rng(4)
    b, tq, tkv, h, kvh, hd, window = 2, 100, 45, 4, 2, 8, 40
    v = torch.from_numpy(rng.standard_normal((b, tkv, kvh, hd)).astype(
        np.float32))
    out = torch.full((b, tq, h, hd), 7.0)
    fill_dead_rows(out, v, causal=True, window=window, q_block=32,
                   kv_block=32)
    assert first_dead_row(tq, tkv, window) == 84
    assert (out[:, :84] == 7.0).all()
    vv = v.repeat_interleave(h // kvh, dim=2)
    # q block 2 (rows 64-95) visits kv tiles 0-1, block 3 (96-99) tile 1
    torch.testing.assert_close(out[:, 84:96],
                               (vv.sum(1) / 64)[:, None].expand(b, 12, h, hd))
    torch.testing.assert_close(out[:, 96:],
                               (vv[:, 32:].sum(1) / 32)[:, None].expand(
                                   b, 4, h, hd))
    assert first_dead_row(tq, tkv, 0) == tq


# The tensor-core kernels' head dims below 80: the tiny configs' hd 16 and
# hd 64, in both dtypes, with ragged ends (tq != tkv, neither a multiple of
# a tile) and windows; no row is left without a live key.
SMALL_HD = {
    # b, tq, tkv, h, kvh, causal, window
    "ragged_causal": (2, 100, 120, 4, 2, True, 0),
    "ragged_causal_w24": (1, 90, 70, 4, 1, True, 24),
    "bidir_w16": (1, 77, 77, 4, 4, False, 16),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("name", list(SMALL_HD))
def test_small_head_dims_match_jax_oracle(name, hd, dtype):
    b, tq, tkv, h, kvh, causal, window = SMALL_HD[name]
    assert first_dead_row(tq, tkv, window) == tq
    q, k, v = make(b, tq, tkv, h, kvh, hd, seed=hd)
    bf16 = dtype == "bfloat16"
    got = port(q, k, v, getattr(torch, dtype), causal=causal, window=window)
    want = jax_ref(q, k, v, jnp.bfloat16 if bf16 else jnp.float32,
                   causal=causal, window=window)
    tol = 2e-2 if bf16 else 2e-5
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


# chip_smoke.py holds the fp32 kernels to atol + rtol |want| of the plain
# version with these values, unchanged for the 3xTF32 kernel.
FP32_TOL = (1e-4, 1e-4)
# The fp32 chip cases' widths, t cut down: glm4_9b (t 1000 on the card),
# mixtral_8x7b (t 8192, window 4096) and the tiny configs' hd 16 at b = 2
# (tq 1000, tkv 1200); past hd 128, where the kernel's consumers split the
# reduction of S: hd 129 (t 1000 on the card) at b = 2 with ragged ends,
# hd 200 with a window (t 4096, window 2048) and recurrentgemma_9b's hd 256
# with its one kv head (t 4096, window 2048).
TF32_CASES = {
    # b, tq, tkv, h, kvh, hd, causal, window
    "glm4_9b": (1, 256, 256, 32, 2, 128, True, 0),
    "mixtral_8x7b_w": (1, 320, 320, 32, 8, 128, True, 96),
    "hd16_b2_ragged": (2, 100, 120, 32, 8, 16, True, 0),
    "hd129_b2_ragged": (2, 100, 120, 8, 2, 129, True, 0),
    "hd200_w": (1, 300, 300, 4, 1, 200, True, 96),
    "recurrentgemma_9b_hd256_w": (1, 300, 300, 4, 1, 256, True, 96),
}


def tf32(x):
    """x with the low 13 mantissa bits cleared: what a TF32 operand of the
    tensor cores keeps."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def matmul_tf32x3(a, b):
    """a @ b as the 3xTF32 kernel forms it: a_hi b_hi + a_hi b_lo +
    a_lo b_hi, x_hi = tf32(x), x_lo = x - x_hi (exact), each term of TF32
    operands (exact products) summed in fp32."""
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    return a_hi @ b_hi + a_hi @ b_lo + a_lo @ b_hi


def matmul_tf32(a, b):
    return tf32(a) @ tf32(b)


def scores_split_tf32x3(a, b):
    """a @ b (a [.., m, hd], b [.., hd, n]) as the 3xTF32 kernel forms S
    past hd 128: consumer c takes columns [16 c, 16 c + 16) of every 32,
    and sums Q_hi K_hi, Q_hi K_lo (one m64n32k8 product, the two halves of
    its columns) and Q_lo K_hi over them, each in fp32; S is the fp32 sum
    of the two partials."""
    half = torch.arange(a.shape[-1]) % 32 >= 16
    parts = []
    for cols in (~half, half):
        x, y = a[..., cols], b[..., cols, :]
        x_hi, y_hi = tf32(x), tf32(y)
        x_lo, y_lo = tf32(x - x_hi), tf32(y - y_hi)
        parts.append(x_hi @ y_hi + x_hi @ y_lo + x_lo @ y_hi)
    return parts[0] + parts[1]


def attention_with(matmul, q, k, v, causal, window, scores=None):
    """Dense softmax attention in fp32 with both products through
    `matmul` (S through `scores` where given); q [b, tq, h, hd], k / v
    [b, tkv, kvh, hd]."""
    h, kvh, hd = q.shape[2], k.shape[2], q.shape[3]
    qf = q.permute(0, 2, 1, 3)
    kf = k.repeat_interleave(h // kvh, dim=2).permute(0, 2, 1, 3)
    vf = v.repeat_interleave(h // kvh, dim=2).permute(0, 2, 1, 3)
    s = (scores or matmul)(qf, kf.transpose(-1, -2)) / math.sqrt(hd)
    qpos = torch.arange(q.shape[1])[:, None]
    kpos = torch.arange(k.shape[1])[None, :]
    live = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool)
    if causal:
        live &= kpos <= qpos
    if window:
        live &= kpos > qpos - window
    s = s.masked_fill(~live, -1e30)
    p = torch.where(live, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    out = matmul(p, vf) / p.sum(-1, keepdim=True)
    return out.permute(0, 2, 1, 3)


@pytest.mark.parametrize("name", list(TF32_CASES))
def test_tf32x3_split_meets_the_fp32_tolerance(name):
    """The 3xTF32 kernel's arithmetic, emulated on the CPU, stays within the
    fp32 tolerance of `flash_attention_plain` (past hd 128 with S as the
    fp32 sum of two half-width partials, one a consumer); one TF32 pass
    does not, so the tolerance tells the two apart."""
    b, tq, tkv, h, kvh, hd, causal, window = TF32_CASES[name]
    q, k, v = (torch.from_numpy(x) for x in make(b, tq, tkv, h, kvh, hd,
                                                 seed=21))
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    atol, rtol = FP32_TOL
    bound = atol + rtol * want.abs()
    got = attention_with(matmul_tf32x3, q, k, v, causal, window,
                         scores=scores_split_tf32x3 if hd > 128 else None)
    assert float(((got - want).abs() - bound).max()) <= 0
    one = attention_with(matmul_tf32, q, k, v, causal, window)
    assert bool(((one - want).abs() > bound).any())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [7, 100, 200])
@pytest.mark.parametrize("name", list(SMALL_HD))
def test_padded_head_dims_match_jax_oracle(name, hd, dtype):
    """Head dims the card runs at a padded width (hd 7, 100, 200) in both
    dtypes, ragged, with windows: the plain version against the JAX
    oracle."""
    b, tq, tkv, h, kvh, causal, window = SMALL_HD[name]
    q, k, v = make(b, tq, tkv, h, kvh, hd, seed=hd + 1)
    bf16 = dtype == "bfloat16"
    got = port(q, k, v, getattr(torch, dtype), causal=causal, window=window)
    want = jax_ref(q, k, v, jnp.bfloat16 if bf16 else jnp.float32,
                   causal=causal, window=window)
    tol = 2e-2 if bf16 else 2e-5
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("name", list(PADDED))
def test_padded_head_dims_match_pallas_kernel(tpu_out, name):
    """The same head dims against the Pallas kernel in interpret mode, at
    its blocks of 32."""
    b, tq, tkv, h, kvh, hd, causal, window, qb, kvb = PADDED[name]
    assert first_dead_row(tq, tkv, window) == tq
    q, k, v = make(b, tq, tkv, h, kvh, hd, seed=11)
    bf16 = name.startswith("bf16")
    tol = 2e-2 if bf16 else 2e-5
    got = port(q, k, v, torch.bfloat16 if bf16 else torch.float32,
               causal=causal, window=window, q_block=qb, kv_block=kvb)
    np.testing.assert_allclose(got, tpu_out[name], rtol=tol, atol=tol)


# bf16 output may round one ulp apart when the fp32 sums differ in order
BF16_ULP_TOL = (1e-3, 1e-2)


@pytest.mark.parametrize("dtype,hd", [("bfloat16", 7), ("bfloat16", 50),
                                      ("bfloat16", 100), ("bfloat16", 200),
                                      ("float32", 7), ("float32", 50),
                                      ("float32", 100)])
def test_zero_padding_to_the_kernel_width_changes_nothing(dtype, hd):
    """What the tensor-core kernels compute for a head dim below their
    width: Q, K and V zero-padded to W = padded_width(dtype, hd) (the
    wrapper's padding to aligned_head_dim, then the kernel's in shared
    memory), scores scaled by the real hd's 1 / sqrt(hd), give the
    unpadded attention in the first hd columns and exact zeros past them
    (the columns the kernels never store).  The plain version scales by
    1 / sqrt(W) at width W, so Q is scaled by sqrt(W / hd) in fp32 first."""
    dt = getattr(torch, dtype)
    w = padded_width(dt, hd)
    assert hd <= aligned_head_dim(dt, hd) <= w and w > hd
    b, tq, tkv, h, kvh = 2, 100, 120, 4, 2
    q, k, v = (torch.from_numpy(x).to(dt)
               for x in make(b, tq, tkv, h, kvh, hd, seed=hd + 5))

    def pad(x):
        return torch.nn.functional.pad(x.float(), (0, w - hd))

    for causal, window in ((True, 0), (True, 24), (False, 16)):
        want = flash_attention_plain(q, k, v, causal=causal, window=window)
        got = flash_attention_plain(pad(q) * math.sqrt(w / hd), pad(k),
                                    pad(v), causal=causal,
                                    window=window).to(dt)
        assert bool((got[..., hd:] == 0).all())
        # fp32: the file's oracle tolerance (Q's scaling rounds once more)
        atol, rtol = BF16_ULP_TOL if dtype == "bfloat16" else (2e-5, 2e-5)
        torch.testing.assert_close(got[..., :hd], want, atol=atol, rtol=rtol)
