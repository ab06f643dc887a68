"""The port's models (`repro_torch.models`, `repro_torch.configs`,
`repro_torch.launch.steps`) against the JAX reference.

Each scenario is written once against a small adapter (`_Pkg`) and run
twice: in one subprocess on the reference (with the jax alias the
reference's Pallas modules need, 4 threads: its time is XLA compiles),
which also saves the weights its `init_params` drew; then in this process
on the port, on those weights converted (`convert.model_params`).  The
scenarios, on the reduced configs of the six ported architectures:

  forward/<arch>      fp32, b = 2, t = 40 (ragged against 32-blocks):
                      train, prefill (cache to t + 4) and one decode step
                      at position t (hubert, an encoder: train and prefill)
  consistency/<arch>  tests/test_models_smoke.py::
                      test_prefill_then_decode_consistency (t = 64)
  multi_token/deepseek_7b
                      test_multi_token_decode_matches_forward (4 steps)
  bf16/glm4_9b        the forward scenario in the config's own bf16
  window/glm4_9b      the forward scenario with a 24-position window (the
                      ring cache and its decode attention)

fp32 logits must be within atol 1e-4 of the reference's and their greedy
tokens identical; bf16 logits within BF16_ATOL + BF16_RTOL |want|, two
bf16 ulps (bf16 keeps 8 bits of mantissa and the two packages round
intermediate sums in different orders: the largest difference seen is
0.022 on logits up to 3.5).  On the port alone, the reference tests' own checks
(rtol = atol = 2e-3 and equal argmax between decode and the full
forward), the NotImplementedError stubs, the attention route's rule, and
`convert.model_params` round trips."""

import dataclasses
import os
import subprocess
import sys
import textwrap
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORTED = ["deepseek_7b", "glm4_9b", "codeqwen15_7b", "nemotron_4_15b",
          "qwen2_vl_7b", "hubert_xlarge"]
CAUSAL = [a for a in PORTED if a != "hubert_xlarge"]
FP32_ATOL = 1e-4
BF16_ATOL, BF16_RTOL = 4e-2, 2 ** -6     # two bf16 ulps, relative


def _fp32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def flatten(tree, prefix="params") -> dict:
    """A params tree as {path: numpy}, bfloat16 leaves as their uint16
    bits under `path@bf16`."""
    if isinstance(tree, dict):
        return {k: v for name, sub in tree.items()
                for k, v in flatten(sub, f"{prefix}/{name}").items()}
    if isinstance(tree, (tuple, list)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in flatten(sub, f"{prefix}/{i}").items()}
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":
        return {f"{prefix}@bf16": arr.view(np.uint16)}
    return {prefix: arr}


def unflatten(flat: dict, prefix="params"):
    """The inverse of `flatten` as the port's params (CPU tensors); path
    parts that are numbers are tuple positions."""
    root: dict = {}
    for key, arr in flat.items():
        path, _, tag = key.partition("@")
        parts = path.split("/")[1:]
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        t = torch.from_numpy(np.array(arr))
        node[parts[-1]] = (t.view(torch.int16).view(torch.bfloat16)
                           if tag == "bf16" else t)

    def fix(node):
        if not isinstance(node, dict):
            return node
        if all(k.isdigit() for k in node):
            return tuple(fix(node[str(i)]) for i in range(len(node)))
        return {k: fix(v) for k, v in node.items()}
    return fix(root)


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


class _Pkg:
    """One package's entry points, as the scenarios call them.  The port's
    `params` are the reference's, read from its saved run."""

    def __init__(self, which: str, reference: dict | None = None):
        self.which = which
        self.saved: dict = {}
        if which == "ref":
            import jax
            import jax.numpy as jnp
            from repro.configs import get_config
            from repro.launch import steps
            from repro.models import transformer
            self._jax, self.jnp = jax, jnp
            self.i32 = jnp.int32
        else:
            from repro_torch.configs import get_config
            from repro_torch.launch import steps
            from repro_torch.models import transformer
            self.reference = reference
            self.i32 = torch.int32
        self.get_config, self.steps, self.tm = get_config, steps, transformer

    def params(self, name: str, cfg, key: int):
        if self.which == "ref":
            p = self.tm.init_params(cfg, self._jax.random.PRNGKey(key))
            self.saved.update({f"{name}|{k}": v
                               for k, v in flatten(p).items()})
            return p
        prefix = f"{name}|"
        return unflatten({k[len(prefix):]: v for k, v in
                          self.reference.items() if k.startswith(prefix)
                          and k[len(prefix):].startswith("params")})

    def array(self, x, dtype=None):
        if self.which == "ref":
            return self.jnp.asarray(x, dtype)
        t = torch.from_numpy(np.array(x))
        return t if dtype is None else t.to(dtype)

    def bf16(self):
        return self.jnp.bfloat16 if self.which == "ref" else torch.bfloat16

    def forward(self, params, cfg, batch, **kw):
        return self.tm.forward(params, cfg, batch, **kw)


def _inputs(P, cfg, rng, b, t):
    if cfg.input_mode == "features":
        return {"features": P.array(rng.standard_normal(
            (b, t, cfg.feature_dim)).astype(np.float32))}
    toks = rng.integers(0, cfg.vocab, (b, t + 1)).astype(np.int32)
    batch = {"tokens": P.array(toks[:, :t])}
    if cfg.family == "vlm":
        batch["vision_embeds"] = P.array(rng.standard_normal(
            (b, 6, cfg.d_model)).astype(np.float32))
    return batch, toks


def scenario_forward(P, arch, dtype="float32", window=0):
    """train / prefill / one decode step on the reduced config (with a
    sliding window: a ring cache, the prefill keeping its last `window`
    positions)."""
    name = (f"{'bf16' if dtype == 'bfloat16' else 'window' if window else 'forward'}"
            f"/{arch}")
    cfg = dataclasses.replace(P.get_config(arch, reduced=True),
                              window=window)
    if dtype == "float32":
        cfg = _fp32(cfg)
    params = P.params(name, cfg, 5)
    rng = np.random.default_rng(PORTED.index(arch))
    b, t = 2, 40
    out = {}
    if cfg.input_mode == "features":
        batch = _inputs(P, cfg, rng, b, t)
    else:
        batch, toks = _inputs(P, cfg, rng, b, t)
    logits, _, _ = P.forward(params, cfg, batch, mode="train")
    out["train"] = as_np(logits)
    logits, cache = P.steps.make_prefill_step(cfg, max_len=t + 4)(params,
                                                                   batch)
    out["prefill"] = as_np(logits)
    if cfg.causal:
        dec = {"tokens": P.array(toks[:, t:t + 1]),
               "pos": P.array(np.full(b, t, np.int32))}
        logits, _ = P.steps.make_serve_step(cfg)(params, cache, dec)
        out["decode"] = as_np(logits)
    return out


def scenario_consistency(P, arch):
    """test_prefill_then_decode_consistency: prefill T, decode token T;
    the logits of a full forward over T + 1 tokens at position T."""
    name = f"consistency/{arch}"
    cfg = _fp32(P.get_config(arch, reduced=True))
    B, T = 2, 64
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (B, T + 1)).astype(np.int32)
    params = P.params(name, cfg, 1)

    def full_batch(t):
        batch = {"tokens": P.array(toks[:, :t])}
        if cfg.family == "vlm":
            batch["vision_embeds"] = P.array(
                np.zeros((B, 8, cfg.d_model), np.float32), P.bf16())
            batch["positions"] = P.array(np.broadcast_to(
                np.arange(t, dtype=np.int32)[None, :, None], (B, t, 3)))
        return batch

    logits_full, _, _ = P.forward(params, cfg, full_batch(T + 1),
                                  mode="train")
    _, cache = P.steps.make_prefill_step(cfg, max_len=T + 1)(
        params, full_batch(T))
    logits_dec, _ = P.steps.make_serve_step(cfg)(
        params, cache, {"tokens": P.array(toks[:, T:T + 1]),
                        "pos": P.array(np.full((B,), T, np.int32))})
    return {"full": as_np(logits_full[:, -1]),
            "decode": as_np(logits_dec[:, 0])}


def scenario_multi_token(P, arch):
    """test_multi_token_decode_matches_forward: decode 4 tokens against a
    teacher-forced full forward."""
    name = f"multi_token/{arch}"
    cfg = _fp32(P.get_config(arch, reduced=True))
    B, T, D = 2, 32, 4
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab, (B, T + D)).astype(np.int32)
    params = P.params(name, cfg, 3)
    logits_full, _, _ = P.forward(params, cfg, {"tokens": P.array(toks)},
                                  mode="train")
    _, cache = P.steps.make_prefill_step(cfg, max_len=T + D)(
        params, {"tokens": P.array(toks[:, :T])})
    out = {"full": as_np(logits_full[:, T:T + D])}
    serve = P.steps.make_serve_step(cfg)
    for d in range(D):
        logits_dec, cache = serve(params, cache, {
            "tokens": P.array(toks[:, T + d:T + d + 1]),
            "pos": P.array(np.full((B,), T + d, np.int32))})
        out[f"decode{d}"] = as_np(logits_dec[:, 0])
    return out


SCENARIOS = {
    **{f"forward/{a}": (scenario_forward, (a,)) for a in PORTED},
    **{f"consistency/{a}": (scenario_consistency, (a,)) for a in CAUSAL},
    "multi_token/deepseek_7b": (scenario_multi_token, ("deepseek_7b",)),
    "bf16/glm4_9b": (scenario_forward, ("glm4_9b", "bfloat16")),
    "window/glm4_9b": (scenario_forward, ("glm4_9b", "float32", 24)),
}


def run_reference(workers: int = 4) -> dict:
    """Every scenario on the reference: {"name|key": array}, its weights
    under "name|params/...".  The scenarios share nothing, so threads may
    run them at once (the reference's time is XLA compiles)."""
    P = _Pkg("ref")

    def run(item):
        name, (fn, args) = item
        return name, fn(P, *args)

    with ThreadPoolExecutor(workers) as pool:
        runs = list(pool.map(run, SCENARIOS.items()))
    out = dict(P.saved)
    out.update({f"{name}|{key}": value for name, res in runs
                for key, value in res.items()})
    return out


_REFERENCE_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    from jax.experimental.pallas import tpu as pltpu
    if not hasattr(pltpu, "TPUMemorySpace"):   # renamed in newer jax
        pltpu.TPUMemorySpace = pltpu.MemorySpace
    import test_torch_models
    np.savez(sys.argv[1], **test_torch_models.run_reference())
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("models_ref") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT / 'tests'}")
    env.pop("BIGATOMIC_OBS", None)
    proc = subprocess.run([sys.executable, "-c", _REFERENCE_SCRIPT,
                           str(path)], env=env, capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(path))


@pytest.fixture(scope="module")
def port_runs(reference):
    runs = {}

    def get(name):
        if name not in runs:
            fn, args = SCENARIOS[name]
            runs[name] = fn(_Pkg("port", reference), *args)
        return runs[name]
    return get


def _want(reference, name):
    return {key.split("|", 1)[1]: v for key, v in reference.items()
            if key.split("|", 1)[0] == name
            and not key.split("|", 1)[1].startswith("params")}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_reference(name, reference, port_runs):
    """Logits within the scenario's tolerance of the reference's; in fp32
    the greedy tokens identical too."""
    got, want = port_runs(name), _want(reference, name)
    assert sorted(got) == sorted(want)
    bf16 = name.startswith("bf16/")
    for key in want:
        np.testing.assert_allclose(
            got[key], want[key], rtol=BF16_RTOL if bf16 else 0,
            atol=BF16_ATOL if bf16 else FP32_ATOL, err_msg=f"{name}: {key}")
        if not bf16:
            np.testing.assert_array_equal(
                got[key].argmax(-1), want[key].argmax(-1),
                err_msg=f"{name}: {key} greedy tokens")


@pytest.mark.parametrize("arch", CAUSAL)
def test_prefill_then_decode_consistency(arch, port_runs):
    """The reference test's own check, on the port: decode at position T
    equals the full forward there (rtol = atol = 2e-3, equal argmax)."""
    out = port_runs(f"consistency/{arch}")
    np.testing.assert_allclose(out["full"], out["decode"], rtol=2e-3,
                               atol=2e-3)
    assert (out["full"].argmax(-1) == out["decode"].argmax(-1)).all()


def test_multi_token_decode_matches_forward(port_runs):
    out = port_runs("multi_token/deepseek_7b")
    for d in range(4):
        np.testing.assert_allclose(out["full"][:, d], out[f"decode{d}"],
                                   rtol=2e-3, atol=2e-3)
        assert (out["full"][:, d].argmax(-1)
                == out[f"decode{d}"].argmax(-1)).all(), d


# ---------------------------------------------------------------------------
# In process: conversion, the attention route, the stubs.
# ---------------------------------------------------------------------------

def test_model_params_round_trip():
    """`convert.model_params` keeps the tree, shapes, dtypes and bits
    (bfloat16 included), `model_params_to_numpy` inverts it, and the
    tree is the one the port's own `init_params` makes."""
    import jax
    from repro.configs import get_config as jget
    from repro.models.transformer import init_params
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tt
    ref = init_params(jget("qwen2_vl_7b", reduced=True),
                      jax.random.PRNGKey(0))
    port = convert.model_params(jax.tree.map(np.asarray, ref), "cpu")
    flat_ref = flatten(ref)
    flat_back = flatten(convert.model_params_to_numpy(port))
    assert sorted(flat_back) == sorted(flat_ref)
    for key in flat_ref:
        np.testing.assert_array_equal(flat_back[key], flat_ref[key], key)
    shapes = flatten(tt.init_params(get_config("qwen2_vl_7b", reduced=True),
                                    device="meta"), "params")
    got = flatten(port)
    assert sorted(got) == sorted(shapes)
    for key, t in got.items():
        assert (shapes[key].shape, shapes[key].dtype) == (t.shape, t.dtype)


@pytest.mark.parametrize("arch", PORTED)
def test_init_cache_matches_reference(arch):
    """`init_cache`: the reference's tree, shapes and dtypes, zeros."""
    import jax
    from repro.configs import get_config as jget
    from repro.models.transformer import init_cache
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tt
    want = flatten(init_cache(jget(arch, reduced=True), 2, 50))
    got = flatten(tt.init_cache(get_config(arch, reduced=True), 2, 50,
                                device="cpu"))
    assert sorted(got) == sorted(k.replace("@bf16", "") for k in want)
    for key, t in got.items():
        ref = want.get(key, want.get(f"{key}@bf16"))
        assert tuple(t.shape) == ref.shape, key
        assert (t.dtype == torch.bfloat16) == (f"{key}@bf16" in want), key
        assert not t.any(), key


def test_init_params_shapes_and_scales():
    """The port's own draws: the reference's tree and shapes, `dense_init`'s
    truncation and scale, and the same tensors from the same seed."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tt
    cfg = get_config("glm4_9b", reduced=True)
    a = tt.init_params(cfg, seed=3, device="cpu")
    b = tt.init_params(cfg, seed=3, device="cpu")
    wq = a["stack"][0]["attn"]["wq"].float()
    assert wq.shape == (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.hd)
    assert wq.abs().max() <= 2 / np.sqrt(cfg.d_model) + 1e-6
    assert 0.7 < float(wq.std() * np.sqrt(cfg.d_model)) < 1.0
    assert a["embed"].float().abs().max() <= 2.0
    assert torch.equal(a["head"], b["head"])
    assert cfg.n_params() == sum(
        x.numel() for x in __import__("repro_torch.models.common",
                                      fromlist=["tree_leaves"])
        .tree_leaves(a))


def test_attention_route_rule():
    """`flash_attention` launches the CUDA kernels only for a tensor on a
    card, no query offset, no softcap and fp32 scores; on the CPU it runs
    the pair-list version, equal to the reference's jnp function."""
    import jax.numpy as jnp
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    card = types.SimpleNamespace(is_cuda=True)
    assert tattn.kernel_route(card)
    assert not tattn.kernel_route(card, q_offset=8)
    assert not tattn.kernel_route(card, softcap=30.0)
    assert not tattn.kernel_route(card, score_dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 50, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 70, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 70, 2, 16)).astype(np.float32)
    assert not tattn.kernel_route(torch.from_numpy(q))
    for kw in ({"causal": True}, {"causal": False, "window": 24},
               {"causal": True, "q_offset": 20, "softcap": 5.0}):
        want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), q_block=16,
                                     kv_block=32, **kw)
        got = tattn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), q_block=16,
                                    kv_block=32, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=FP32_ATOL, err_msg=str(kw))


def test_rope_and_mrope_positions_match_reference():
    """`make_mrope_positions` and `apply_rope`, plain and with M-RoPE
    sections (qwen2_vl's reduced split), against the reference."""
    import jax.numpy as jnp
    from repro.models import common as jc
    from repro_torch.models import common as tc
    np.testing.assert_array_equal(
        tc.make_mrope_positions(2, 5, device="cpu").numpy(),
        np.asarray(jc.make_mrope_positions(2, 5)))
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    for positions, sections in (
            (rng.integers(0, 300, (2, 5)).astype(np.int32), ()),
            (rng.integers(0, 300, (2, 5, 3)).astype(np.int32), (4, 2, 2))):
        want = jc.apply_rope(jnp.asarray(x), jnp.asarray(positions), 1e4,
                             sections)
        got = tc.apply_rope(torch.from_numpy(x), torch.from_numpy(positions),
                            1e4, sections)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=FP32_ATOL, err_msg=str(sections))


def test_unported_paths_raise_not_implemented():
    """The stub that remains of ROADMAP Queue 1 item 8 (distribution)
    raises NotImplementedError naming it: `train(mesh=...)` (8e).  (The
    sharded clients and serving, 8b-8c, run since they were ported:
    tests/test_torch_distributed_serving.py.)"""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES, reduced_shape
    from repro_torch.launch.train import train
    cfg = get_config("deepseek_7b", reduced=True)
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        train(cfg, reduced_shape(SHAPES["train_4k"]), steps=1,
              mesh=object(), device="cpu")


def test_entry_points_default_to_the_card(monkeypatch):
    """Without `device=`, the port's constructors build on the card (and
    say so when there is none)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tt
    from repro_torch.serving import paged_kv as pk
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("deepseek_7b", reduced=True)
    for build in (lambda: tt.init_params(cfg),
                  lambda: tt.init_cache(cfg, 1, 8),
                  lambda: pk.init(cfg, pk.make_spec(cfg, 8, 4, 2))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
