"""The port's flash attention (`repro_torch.kernels.flash_attention`)
against the JAX reference, on the CPU.

The same seeded numpy inputs go through `flash_attention` on CPU tensors
(its plain version) and through the reference's pure-jnp oracle
`repro.models.attention.flash_attention`; one subprocess installs the jax
alias the Pallas kernel needs on this jax and runs
`flash_attention_tpu(..., interpret=True)` on every case.  The cases and
tolerances are those of `tests/test_flash_kernel.py`: fp32 rtol = atol =
2e-5, bf16 2e-2.  Two ragged cases with rows that have no live key also go
through the Pallas kernel: there the port returns 0 where the reference
returns a mean that depends on its tiling.
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
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain,
                                                 hbm_bytes_model)

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
DENSE = (1, 48, 2, 2, 16, True, 0, 16, 16)
RAGGED = {
    # b, tq, tkv, h, kvh, hd, causal, window, qb, kvb: rows 60-69 have no
    # live key (a window that ends before the keys do)
    "ragged_causal_w16": (1, 70, 45, 4, 2, 24, True, 16, 32, 32),
    "ragged_bidir_w16": (1, 70, 45, 4, 2, 24, False, 16, 32, 32),
}


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
               kvb) in RAGGED.items():
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
    tol = 2e-2 if name == "bf16" else 2e-5
    dtype = torch.bfloat16 if name == "bf16" else torch.float32
    got = port(q, k, v, dtype, causal=causal, window=window)
    np.testing.assert_allclose(got, tpu_out[name], rtol=tol, atol=tol)


def test_ragged_lengths_and_fully_masked_rows():
    """tq != tkv with ragged ends against a dense reference; a row with no
    live key (a window that ends before the keys do) gives zeros, never
    NaN."""
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
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
        dead = ~live.any(1)
        assert bool(dead.any()) == bool(window)   # rows past tkv + window
        assert not got[:, dead].any()


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


def test_hbm_bytes_model_is_the_reference_model(tpu_out):
    for i, args in enumerate(((1, 4096, 32, 2, 128), (2, 8192, 32, 8, 128))):
        for train in (True, False):
            assert hbm_bytes_model(*args, train=train) == \
                tpu_out[f"hbm_model/{i}/{train}"]
    # glm4_9b's forward at t = 4096 in bf16: 71.3 MB, 21 us at 3.35 TB/s
    assert hbm_bytes_model(1, 4096, 32, 2, 128, train=False) == 71303168


@pytest.mark.parametrize("name", list(RAGGED))
def test_dead_rows_depart_from_pallas_kernel(tpu_out, name):
    """tq != tkv, ragged, with a window: every row with a live key equals
    the Pallas kernel.  A row with no live key is 0 in the port; the Pallas
    kernel returns there the mean of the masked (and zero-padded) v rows of
    the kv tiles it visited, a result of its tiling (ROADMAP.md, Queue 3),
    which the port does not copy."""
    b, tq, tkv, h, kvh, hd, causal, window, _, _ = RAGGED[name]
    q, k, v = make(b, tq, tkv, h, kvh, hd, seed=11)
    got = port(q, k, v, causal=causal, window=window)
    want = tpu_out[name]
    qpos, kpos = np.arange(tq)[:, None], np.arange(tkv)[None, :]
    live = kpos > qpos - window
    if causal:
        live &= kpos <= qpos
    dead = ~live.any(1)
    assert dead.sum() == 10
    np.testing.assert_allclose(got[:, ~dead], want[:, ~dead], rtol=2e-5,
                               atol=2e-5)
    assert not got[:, dead].any()
    assert np.isfinite(want).all() and want[:, dead].any()
