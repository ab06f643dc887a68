"""The port's MoE, SSM and RG-LRU families (`repro_torch.models.moe`,
`ssm`, `rglru`, `scan`, and the four configs that need them) against the
JAX reference.

As in tests/test_torch_models.py, each scenario is written once against
the adapter (`_Pkg`, here with the family modules) and run twice: in one
subprocess on the reference (4 threads), which saves the weights its
`init_params` drew; then in this process on the port, on those weights
converted.  The scenarios, on the reduced configs of mixtral_8x7b,
llama4_maverick_400b_a17b, mamba2_780m and recurrentgemma_9b:

  forward/<arch>      fp32, b = 2, t = 40: train, prefill (cache to t + 4)
                      and one decode step at position t
  consistency/<arch>  test_prefill_then_decode_consistency (t = 64)
  multi_token/<arch>  test_multi_token_decode_matches_forward (4 steps)
                      for mamba2, recurrentgemma and mixtral: the decode
                      state advancing in the stacked cache
  bf16/<arch>         the forward scenario in the config's own bf16
  moe_drops/<arch>    `moe_ffn` on layer 0's experts with capacity
                      dispatch at cf 1.0 (pairs are dropped), and the
                      forward with it
  moe_groups/<arch>   the same at cf 1.25 with `moe_groups = 2`
  moe_ties/<arch>     cf 1.0 with router columns 0 and 1 identical and
                      four tokens of zeros (every expert tied)
  ssd_chunked         chunk 8, t 40: five chunks through the inter-chunk
                      scan
  rglru_scan          t 40

Routing (`expert_idx`, `rank`, `keep`, `dest`, and the groups and
capacity) must be equal bit for bit; fp32 values within atol 1e-4 with
equal greedy tokens; bf16 logits within BF16_ATOL + BF16_RTOL |want|.
The reference runs with XLA's excess precision off
(`--xla_allow_excess_precision=false`), so that its compiled layer scan
rounds every bf16 operation as written, as the port and the reference's
own operations one by one do: with it on, the fused scan kept one bf16
intermediate wider in bf16/mixtral_8x7b, a token's expert choice moved,
and its logits differed from the same layers run one operation at a time
by 0.875.
In process: the port's own consistency checks, the decode state written
back into the caller's copy of the stacked cache and not into the
caller's, every full config's parameter shapes against
`jax.eval_shape(init_params)`, the caches, and the rank's max-scan
against the generic scan and the reference."""

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

from test_torch_models import (BF16_ATOL, BF16_RTOL, FP32_ATOL, _fp32,
                               _inputs, _Pkg, as_np, flatten,
                               scenario_consistency, scenario_multi_token)

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = ["mixtral_8x7b", "llama4_maverick_400b_a17b", "mamba2_780m",
            "recurrentgemma_9b"]
MOE = ["mixtral_8x7b", "llama4_maverick_400b_a17b"]
MULTI_TOKEN = ["mamba2_780m", "recurrentgemma_9b", "mixtral_8x7b"]
# routing outputs compared bit for bit
EXACT = ("expert_idx", "rank", "keep", "dest", "groups_capacity")


class _FamPkg(_Pkg):
    """`_Pkg` with the family modules.  On the reference the forward, the
    steps and `moe_ffn` run under `jax.jit`: one compile each, where
    the recurrent blocks' and the rank's associative scans run op by op
    would compile hundreds of small programs."""

    def __init__(self, which: str, reference: dict | None = None):
        super().__init__(which, reference)
        if which == "ref":
            import jax
            from repro.models import moe, rglru, ssm
            steps = self.steps
            self.steps = types.SimpleNamespace(
                make_prefill_step=lambda cfg, max_len=0: jax.jit(
                    steps.make_prefill_step(cfg, max_len)),
                make_serve_step=lambda cfg: jax.jit(
                    steps.make_serve_step(cfg)))
        else:
            from repro_torch.models import moe, rglru, ssm
        self.moe, self.ssm, self.rglru = moe, ssm, rglru

    def call(self, fn, *args, static=(), **kw):
        """fn(*args, **kw), on the reference compiled with the keywords
        `static` as static arguments."""
        if self.which == "ref":
            return self._jax.jit(fn, static_argnames=static)(*args, **kw)
        return fn(*args, **kw)

    def forward(self, params, cfg, batch, **kw):
        return self.call(self.tm.forward, params, cfg=cfg, batch=batch,
                         static=("cfg", "mode", "max_len"), **kw)


def scenario_forward(P, arch, dtype="float32"):
    """train / prefill / one decode step on the reduced config."""
    name = f"{'bf16' if dtype == 'bfloat16' else 'forward'}/{arch}"
    cfg = P.get_config(arch, reduced=True)
    if dtype == "float32":
        cfg = _fp32(cfg)
    params = P.params(name, cfg, 5)
    rng = np.random.default_rng(10 + FAMILIES.index(arch))
    b, t = 2, 40
    batch, toks = _inputs(P, cfg, rng, b, t)
    logits, _, _ = P.forward(params, cfg, batch, mode="train")
    out = {"train": as_np(logits)}
    logits, cache = P.steps.make_prefill_step(cfg, max_len=t + 4)(params,
                                                                   batch)
    out["prefill"] = as_np(logits)
    dec = {"tokens": P.array(toks[:, t:t + 1]),
           "pos": P.array(np.full(b, t, np.int32))}
    logits, _ = P.steps.make_serve_step(cfg)(params, cache, dec)
    out["decode"] = as_np(logits)
    return out


def _routing(P, cfg, mlp, x, dropless=False):
    """`moe_ffn` and its routing, per dispatch group."""
    b, s, d = x.shape
    E, topk = cfg.n_experts, cfg.top_k
    if P.which == "ref":
        import jax
        import jax.numpy as jnp
        from jax import lax
        xa = jnp.asarray(x)
        y, aux = P.call(P.moe.moe_ffn, xa, mlp["router"], mlp.get("w_gate"),
                        mlp["w_up"], mlp["w_down"], cfg=cfg,
                        dropless=dropless, static=("cfg", "dropless"))
        # the groups and capacity, as the reference's moe_ffn forms them
        T = b * s
        G = cfg.moe_groups if (cfg.moe_groups > 1 and not dropless
                               and T % cfg.moe_groups == 0) else 1
        Tg = T // G
        C = Tg if dropless else int(np.ceil(Tg / E * cfg.capacity_factor
                                            * max(topk, 1)))
        @jax.jit
        def routing(xg, router):
            dest, keep, gates, _ = jax.vmap(
                lambda xi: P.moe._route(xi, router, cfg, C))(xg)
            probs = jax.nn.softmax(jnp.einsum(
                "gtd,de->gte", xg, router.astype(jnp.float32)), axis=-1)
            _, idx = lax.top_k(probs, topk)
            rank = jax.vmap(lambda e: P.moe._expert_rank(e, Tg, topk))(idx)
            return idx, rank, keep, dest, gates

        idx, rank, keep, dest, gates = routing(xa.reshape(G, Tg, d),
                                               mlp["router"])
    else:
        xt = torch.from_numpy(x)
        y, aux = P.moe.moe_ffn(xt, mlp["router"], mlp.get("w_gate"),
                               mlp["w_up"], mlp["w_down"], cfg,
                               dropless=dropless)
        G, C = P.moe.group_capacity(cfg, b * s, dropless)
        r = P.moe.route(xt.reshape(G, -1, d), mlp["router"], cfg, C)
        idx, rank, keep, dest, gates = (r.expert_idx, r.rank, r.keep,
                                        r.dest, r.gates)
    ints = {"expert_idx": idx, "rank": rank, "keep": keep, "dest": dest}
    out = {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v
                         ).astype(np.int64) for k, v in ints.items()}
    out.update(groups_capacity=np.array([G, C]), gates=as_np(gates),
               y=as_np(y), aux=as_np(aux))
    return out


def scenario_moe(P, arch, kind):
    """Layer 0's experts of the reduced fp32 config on random tokens, with
    capacity dispatch: `drops` (cf 1.0), `groups` (moe_groups 2), `ties`
    (cf 1.0, router columns 0 and 1 equal, four tokens of zeros)."""
    name = f"moe_{kind}/{arch}"
    cfg = dataclasses.replace(_fp32(P.get_config(arch, reduced=True)),
                              moe_dropless=False)
    cfg = dataclasses.replace(cfg, **{
        "drops": {"capacity_factor": 1.0},
        "groups": {"moe_groups": 2},
        "ties": {"capacity_factor": 1.0}}[kind])
    params = P.params(name, cfg, 7)
    mlp = {k: v[0] for k, v in params["stack"][0]["mlp"].items()}
    rng = np.random.default_rng(20 + MOE.index(arch))
    x = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    if kind == "ties":
        col = mlp["router"][:, 0]
        mlp["router"] = (mlp["router"].at[:, 1].set(col) if P.which == "ref"
                         else torch.cat([col[:, None], col[:, None],
                                         mlp["router"][:, 2:]], 1))
        x[0, :4] = 0.0
    out = _routing(P, cfg, mlp, x)
    if kind == "drops":
        batch, _ = _inputs(P, cfg, rng, 2, 40)
        out["train"] = as_np(P.forward(params, cfg, batch, mode="train")[0])
    return out


def scenario_ssd(P):
    """`ssd_chunked` at chunk 8 over t 40 (five chunks)."""
    rng = np.random.default_rng(30)
    b, t, nh, hd, S = 2, 40, 3, 4, 5
    f32 = np.float32
    args = [rng.standard_normal((b, t, nh, hd)).astype(f32),
            rng.standard_normal((b, t, nh)).astype(f32),
            np.log(np.linspace(1.0, 16.0, nh)).astype(f32),
            rng.standard_normal((b, t, S)).astype(f32),
            rng.standard_normal((b, t, S)).astype(f32),
            rng.standard_normal(nh).astype(f32)]
    y, state = P.call(P.ssm.ssd_chunked, *(P.array(a) for a in args),
                      chunk=8, static=("chunk",))
    return {"y": as_np(y), "state": as_np(state)}


def scenario_rglru(P):
    """`rglru_scan` over t 40."""
    rng = np.random.default_rng(31)
    b, t, w = 2, 40, 6
    x, r, i = (rng.standard_normal((b, t, w)).astype(np.float32)
               for _ in range(3))
    lam = np.linspace(0.0, 3.0, w).astype(np.float32)
    h, last = P.call(P.rglru.rglru_scan,
                     *(P.array(a) for a in (x, r, i, lam)))
    return {"h": as_np(h), "h_last": as_np(last)}


SCENARIOS = {
    **{f"forward/{a}": (scenario_forward, (a,)) for a in FAMILIES},
    **{f"consistency/{a}": (scenario_consistency, (a,)) for a in FAMILIES},
    **{f"multi_token/{a}": (scenario_multi_token, (a,)) for a in MULTI_TOKEN},
    **{f"bf16/{a}": (scenario_forward, (a, "bfloat16")) for a in FAMILIES},
    **{f"moe_{k}/{a}": (scenario_moe, (a, k)) for a in MOE
       for k in ("drops", "groups", "ties")},
    "ssd_chunked": (scenario_ssd, ()),
    "rglru_scan": (scenario_rglru, ()),
}


def run_reference(workers: int = 4) -> dict:
    """Every scenario on the reference: {"name|key": array}, its weights
    under "name|params/..."."""
    P = _FamPkg("ref")

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
    import test_torch_models_families
    np.savez(sys.argv[1], **test_torch_models_families.run_reference())
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("families_ref") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT / 'tests'}",
               XLA_FLAGS=" ".join([os.environ.get("XLA_FLAGS", ""),
                                   "--xla_allow_excess_precision=false"]))
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
            runs[name] = fn(_FamPkg("port", reference), *args)
        return runs[name]
    return get


def _want(reference, name):
    return {key.split("|", 1)[1]: v for key, v in reference.items()
            if key.split("|", 1)[0] == name
            and not key.split("|", 1)[1].startswith("params")}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_reference(name, reference, port_runs):
    """Routing equal bit for bit; values within the scenario's tolerance
    of the reference's; fp32 logits' greedy tokens identical."""
    got, want = port_runs(name), _want(reference, name)
    assert sorted(got) == sorted(want)
    bf16 = name.startswith("bf16/")
    for key in want:
        if key in EXACT:
            np.testing.assert_array_equal(got[key], want[key],
                                          err_msg=f"{name}: {key}")
            continue
        np.testing.assert_allclose(
            got[key], want[key], rtol=BF16_RTOL if bf16 else 0,
            atol=BF16_ATOL if bf16 else FP32_ATOL, err_msg=f"{name}: {key}")
        logits = key in ("train", "prefill", "full") or \
            key.startswith("decode")
        if logits and not bf16:
            np.testing.assert_array_equal(
                got[key].argmax(-1), want[key].argmax(-1),
                err_msg=f"{name}: {key} greedy tokens")


@pytest.mark.parametrize("arch", MOE)
def test_moe_scenarios_drop_group_and_tie(arch, reference):
    """The reference's routing in the MoE scenarios shows what each is
    for: pairs dropped at cf 1.0, two groups, and the tied tokens routed
    to the lowest experts."""
    topk = {"mixtral_8x7b": 2, "llama4_maverick_400b_a17b": 1}[arch]
    drops = _want(reference, f"moe_drops/{arch}")
    assert not drops["keep"].all()
    assert drops["groups_capacity"][0] == 1
    assert _want(reference, f"moe_groups/{arch}")["groups_capacity"][0] == 2
    ties = _want(reference, f"moe_ties/{arch}")
    assert not ties["keep"].all()
    np.testing.assert_array_equal(ties["expert_idx"][0, :4],
                                  np.tile(np.arange(topk), (4, 1)))


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_then_decode_consistency(arch, port_runs):
    """The reference test's own check, on the port: decode at position T
    equals the full forward there (rtol = atol = 2e-3, equal argmax)."""
    out = port_runs(f"consistency/{arch}")
    np.testing.assert_allclose(out["full"], out["decode"], rtol=2e-3,
                               atol=2e-3)
    assert (out["full"].argmax(-1) == out["decode"].argmax(-1)).all()


@pytest.mark.parametrize("arch", MULTI_TOKEN)
def test_multi_token_decode_matches_forward(arch, port_runs):
    """Four decode steps from the stacked cache against the teacher-forced
    forward: the recurrent state advances step by step."""
    out = port_runs(f"multi_token/{arch}")
    for d in range(4):
        np.testing.assert_allclose(out["full"][:, d], out[f"decode{d}"],
                                   rtol=2e-3, atol=2e-3)
        assert (out["full"][:, d].argmax(-1)
                == out[f"decode{d}"].argmax(-1)).all(), d


# ---------------------------------------------------------------------------
# In process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mamba2_780m", "recurrentgemma_9b"])
def test_decode_writes_state_into_its_copy_of_the_stacked_cache(arch):
    """A decode step returns the advanced recurrent state in the stacked
    cache (and the tail's), and leaves the caller's cache as it was."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tt
    cfg = _fp32(get_config(arch, reduced=True))
    params = tt.init_params(cfg, seed=4, device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 9), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(0))
    _, cache = steps.make_prefill_step(cfg, max_len=12)(
        params, {"tokens": toks[:, :8]})
    before = {k: v.clone() for k, v in flatten(cache, "cache").items()}
    _, new = steps.make_serve_step(cfg)(params, cache, {
        "tokens": toks[:, 8:], "pos": torch.full((2,), 8,
                                                 dtype=torch.int32)})
    after = flatten(new, "cache")
    for key, was in before.items():
        assert torch.equal(flatten(cache, "cache")[key], was), key
    state = "state" if arch == "mamba2_780m" else "h"
    moved = [k for k in after if k.endswith(f"/{state}")]
    assert any(k.startswith("cache/stack") for k in moved)
    if cfg.n_layers % len(cfg.block_pattern):
        assert any(k.startswith("cache/tail") for k in moved)
    for key in moved:
        assert not torch.equal(after[key], before[key]), key
        assert torch.isfinite(after[key]).all(), key


@pytest.mark.parametrize("arch", ["hubert_xlarge", "deepseek_7b",
                                  "glm4_9b", "codeqwen15_7b",
                                  "nemotron_4_15b", "qwen2_vl_7b"]
                         + FAMILIES)
def test_init_params_shapes_match_reference(arch):
    """Every full config's parameter tree, shapes and dtypes, made on the
    meta device (nothing allocated), against the reference's
    `jax.eval_shape(init_params)`."""
    import jax
    from repro.configs import get_config as jget
    from repro.models.transformer import init_params
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tt
    want = _shapes(jax.eval_shape(lambda: init_params(
        jget(arch), jax.random.PRNGKey(0))))
    got = _shapes(tt.init_params(get_config(arch), device="meta"))
    assert got == want


def _shapes(tree, prefix="params") -> dict:
    """{path: (shape, dtype name)} of a params tree's leaves."""
    if isinstance(tree, dict):
        return {k: v for name, sub in tree.items()
                for k, v in _shapes(sub, f"{prefix}/{name}").items()}
    if isinstance(tree, (tuple, list)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _shapes(sub, f"{prefix}/{i}").items()}
    return {prefix: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


@pytest.mark.parametrize("arch", FAMILIES)
def test_model_params_carries_the_family_leaves(arch):
    """`convert.model_params` on the reference's `init_params`: every leaf
    of the port's tree, bits and dtype kept, and back through
    `model_params_to_numpy`; the fp32 router, A_log, D, dt_bias and lam,
    the bf16 experts and convs among them."""
    import jax
    from repro.configs import get_config as jget
    from repro.models.transformer import init_params
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tt
    ref = init_params(jget(arch, reduced=True), jax.random.PRNGKey(2))
    port = convert.model_params(jax.tree.map(np.asarray, ref), "cpu")
    want = flatten(ref)
    back = flatten(convert.model_params_to_numpy(port))
    assert sorted(back) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(back[key], want[key], key)
    assert _shapes(port) == _shapes(tt.init_params(
        get_config(arch, reduced=True), device="meta"))
    leaves = {k.rsplit("/", 1)[-1]: t.dtype for k, t in
              flatten(port).items()}
    fp32 = {"llama4_maverick_400b_a17b": ["router"],
            "mixtral_8x7b": ["router"],
            "mamba2_780m": ["A_log", "D", "dt_bias"],
            "recurrentgemma_9b": ["lam"]}[arch]
    bf16 = {"llama4_maverick_400b_a17b": ["w_up", "w_down", "w_gate"],
            "mixtral_8x7b": ["w_up", "w_down", "w_gate"],
            "mamba2_780m": ["conv_x", "conv_B", "conv_C"],
            "recurrentgemma_9b": ["conv_w"]}[arch]
    assert all(leaves[k] == torch.float32 for k in fp32)
    assert all(leaves[k] == torch.bfloat16 for k in bf16)


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_cache_matches_reference(arch):
    """`init_cache` with recurrent layers: the reference's tree, shapes and
    dtypes, zeros."""
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


def test_rank_scan_equals_cummax_and_reference():
    """The rank's segment-start max-scan: `torch.cummax` (the port's)
    equals `scan.associative_scan` with the reference's combine, and
    `moe.expert_rank` the reference's `_expert_rank`, on expert choices
    with long runs of one expert."""
    import jax
    import jax.numpy as jnp
    from repro.models import moe as jmoe
    from repro_torch.models import moe, scan
    rng = np.random.default_rng(40)
    for T, topk, E in ((1, 1, 4), (37, 2, 4), (64, 1, 3), (200, 2, 8)):
        idx = rng.integers(0, E, (T, topk))
        idx[T // 3:T // 2] = 1                    # a long segment
        flat = torch.from_numpy(idx.reshape(1, -1))
        ar = torch.arange(flat.shape[1])[None]
        seg = torch.rand(flat.shape, generator=torch.Generator()
                         .manual_seed(T)) < 0.3
        seg[:, 0] = True

        def combine(a, b):
            return (a[0] | b[0], torch.where(b[0], b[1],
                                             torch.maximum(a[1], b[1])))
        vals = torch.where(seg, ar, -1)
        _, by_scan = scan.associative_scan(combine, (seg, vals), dim=1)
        assert torch.equal(by_scan, torch.cummax(vals, dim=1).values)
        want = np.asarray(jax.jit(jmoe._expert_rank, static_argnums=(
            1, 2))(jnp.asarray(idx, jnp.int32), T, topk))
        got = moe.expert_rank(torch.from_numpy(idx)[None])[0].numpy()
        np.testing.assert_array_equal(got, want)


def test_associative_scan_matches_lax():
    """`scan.associative_scan` against `lax.associative_scan` on the linear
    recurrence (a non-commutative combine) at lengths 1 to 17, along a
    middle dim: within one fp32 rounding of the reference's order."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from repro_torch.models import scan
    rng = np.random.default_rng(41)

    def combine(left, right):
        (al, bl), (ar, br) = left, right
        return al * ar, br + bl * ar

    @jax.jit
    def scan_lax(a, b):
        return lax.associative_scan(combine, (a, b), axis=1)
    for n in range(1, 18):
        a = rng.uniform(0.5, 1.0, (3, n, 2)).astype(np.float32)
        b = rng.standard_normal((3, n, 2)).astype(np.float32)
        want = scan_lax(jnp.asarray(a), jnp.asarray(b))
        got = scan.associative_scan(combine, (torch.from_numpy(a),
                                              torch.from_numpy(b)), dim=1)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6, err_msg=str(n))
