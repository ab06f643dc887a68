"""The port's training path (`repro_torch.models.transformer.lm_loss`,
`launch.steps.make_train_step` / `init_train_state`, `optim`, `data`,
`launch.train.train`) against the JAX reference on the CPU.

Each step case runs once on the reference, in one subprocess (the jax
alias its Pallas modules need; XLA's excess precision off, as in
tests/test_torch_models_families.py; one `jax.jit` of loss + grad + step a
case, compiled on 4 threads at once), which saves its `init_params`
weights, the loss, every gradient leaf and the state after one AdamW step;
then in this process on the port, on those weights and AdamW state
(`convert.model_params`, `convert.opt_state`), on the port's own batch
(`DataPipeline`, byte for byte the reference's).  The cases here, on the
reduced configs at `reduced_shape(train_4k)` (b 2, t 128):

  fp32/<arch>        the six attention-only configs in fp32
  chunked/glm4_9b    `loss_chunk = 4` (127 targets: one padded position)
  bf16/glm4_9b       the config's own bf16
  compress_<m>/deepseek_7b
                     a step with `grad_compression` bf16 and int8
  loop/glm4_9b       the reference's composed steps (`init_train_state` +
                     `make_train_step` over `DataPipeline`), 4 steps,
                     against the port's `train()` resumed from a step-0
                     checkpoint of the reference's initial state
tests/test_torch_train_families.py runs the same for mixtral_8x7b,
llama4_maverick, mamba2_780m and recurrentgemma_9b, and mixtral with
capacity drops.

Tolerances: the loss within FP32_RTOL of the reference's (bf16: 2^-8
relative, the CE summed in fp32 over bf16 logits); each gradient leaf
within FP32_ATOL_REL x its largest magnitude (the two packages sum the
same products in other orders, and a leaf's entries near zero carry the
absolute error of its large ones; mamba2's A_log, dt_bias and w_dt,
sums of cancelling terms, within CANCELLING_ATOL_REL, set from a float64 run;
bf16: BF16_ATOL_REL, two bf16 ulps of 2^-7 on the leaf's largest entries,
rounded at other places in the two packages); `grad_norm` to the same relative bound, `lr` within
FP32_RTOL, `step` exact.  The step starts from an AdamW state as after 5
steps (`moments`), and the gradient bound is carried through it, with a
quantum of the compression where there is one, to a bound per element of
m, v and the new parameters (`compare_case`).  The step itself (clip,
moments, update, compression) is checked bit for bit on equal inputs in
process: `compress_grads` / `decompress_grads` over several steps of error
feedback, `clip_by_global_norm`, `wsd_schedule`.  On the port alone:
remat on equals remat off bit for bit, the chunked loss equals the
monolithic one within FP32_RTOL, `lm_loss` and `make_train_step` run for
every family, and `train()` stopped by a `PreemptionGuard` after step 2
and resumed from its checkpoint ends bit-identical to the straight run."""

import dataclasses
import os
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_models import flatten
from torch_threads import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["hubert_xlarge", "llama4_maverick_400b_a17b", "mixtral_8x7b",
         "deepseek_7b", "glm4_9b", "codeqwen15_7b", "nemotron_4_15b",
         "mamba2_780m", "recurrentgemma_9b", "qwen2_vl_7b"]
DENSE = ["deepseek_7b", "glm4_9b", "codeqwen15_7b", "nemotron_4_15b",
         "qwen2_vl_7b", "hubert_xlarge"]
OPT = {"lr": 1e-3, "warmup": 2, "total_steps": 10}
SEED = 3                                # the data pipeline's
LOOP_STEPS = 4
FP32_RTOL = 1e-5
FP32_ATOL_REL = 1e-5
BF16_RTOL = 2 ** -8
BF16_ATOL_REL = 2 ** -6
# fp32 leaves whose gradient is a sum over every position of terms far
# larger than the sum (mamba2's SSD: the decay's A_log, the step's dt_bias
# and w_dt): against the port run in fp64, the port's fp32 gradient errs
# by 1.3e-4 / 1.1e-5 / 7.8e-6 of the leaf's largest entry, the
# reference's by 2.7e-4 / 2.9e-5 / 8.8e-6 (b 2, t 128)
CANCELLING_ATOL_REL = {"A_log": 1e-3, "dt_bias": 1e-4, "w_dt": 1e-4}


def case_config(get_config, arch: str, variant: dict, fp32: bool):
    cfg = dataclasses.replace(get_config(arch, reduced=True), **variant)
    if fp32:
        cfg = dataclasses.replace(cfg, param_dtype="float32",
                                  compute_dtype="float32")
    return cfg


# name -> (arch, config replacements, fp32, grad_compression)
CASES = {
    **{f"fp32/{a}": (a, {}, True, "none") for a in DENSE},
    "chunked/glm4_9b": ("glm4_9b", {"loss_chunk": 4}, True, "none"),
    "bf16/glm4_9b": ("glm4_9b", {}, False, "none"),
    "compress_bf16/deepseek_7b": ("deepseek_7b", {}, True, "bf16"),
    "compress_int8/deepseek_7b": ("deepseek_7b", {}, True, "int8"),
}


# ---------------------------------------------------------------------------
# The reference (run in a subprocess)
# ---------------------------------------------------------------------------

def _ref_case(name, case) -> dict:
    import jax
    from repro.configs import get_config
    from repro.configs.shapes import SHAPES, reduced_shape
    from repro.data import synthetic_batch
    from repro.models.transformer import init_params, lm_loss
    from repro.optim import (AdamWConfig, adamw_init, adamw_update,
                             compress_grads, decompress_grads)
    arch, variant, fp32, comp = case
    cfg = case_config(get_config, arch, variant, fp32)
    opt = AdamWConfig(**OPT)
    params = init_params(cfg, jax.random.PRNGKey(ARCHS.index(arch)))
    state = moments(adamw_init(params, opt), ARCHS.index(arch))
    batch = synthetic_batch(cfg, reduced_shape(SHAPES["train_4k"]),
                            seed=SEED, step=0)

    @jax.jit
    def run(params, state, batch):
        # make_train_step's body, with the gradient kept
        loss, grads = jax.value_and_grad(
            lambda p: lm_loss(p, cfg, batch))(params)
        g = grads
        if comp != "none":
            g, _, meta = compress_grads(g, None, comp)
            g = decompress_grads(g, meta)
        new_p, new_s, metrics = adamw_update(params, g, state, opt)
        return loss, grads, new_p, new_s, metrics

    loss, grads, new_p, new_s, metrics = run(params, state, batch)
    out = {"loss": np.asarray(loss), "step": np.asarray(new_s["step"]),
           "grad_norm": np.asarray(metrics["grad_norm"]),
           "lr": np.asarray(metrics["lr"]),
           "step0": np.asarray(state["step"])}
    for prefix, tree in (("params", params), ("m0", state["m"]),
                         ("v0", state["v"]), ("grads", grads),
                         ("new", new_p), ("m", new_s["m"]),
                         ("v", new_s["v"])):
        out.update(flatten(tree, prefix))
    return {f"{name}|{k}": v for k, v in out.items()}


def moments(state, seed: int):
    """An AdamW state as after 5 steps: m ~ N(0, 1e-3), v ~ U(0.5, 1.5)
    x 1e-5, in the moments' dtype, so one step's update is
    m / sqrt(v) and not the sign of the gradient (which a rounding
    difference in a gradient near 0 would flip)."""
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(100 + seed)
    return {"m": jax.tree.map(lambda x: jnp.asarray(
                rng.standard_normal(x.shape) * 1e-3, x.dtype), state["m"]),
            "v": jax.tree.map(lambda x: jnp.asarray(
                rng.uniform(0.5, 1.5, x.shape) * 1e-5, x.dtype), state["v"]),
            "step": jnp.asarray(5, jnp.int32)}


def _ref_loop() -> dict:
    """The reference's composed training: its initial state and the
    losses of LOOP_STEPS steps of `make_train_step` over `DataPipeline`,
    with `train()`'s default AdamWConfig for that many steps."""
    import jax
    from repro.configs import get_config
    from repro.configs.shapes import SHAPES, reduced_shape
    from repro.data import DataPipeline
    from repro.launch.steps import init_train_state, make_train_step
    from repro.optim import AdamWConfig
    cfg = case_config(get_config, "glm4_9b", {}, True)
    opt = AdamWConfig(lr=3e-4, warmup=max(LOOP_STEPS // 20, 1),
                      total_steps=LOOP_STEPS)
    params, state = init_train_state(cfg, opt, 7)
    out = dict(flatten(params, "params"))
    step = jax.jit(make_train_step(cfg, opt))
    pipe = DataPipeline(cfg, reduced_shape(SHAPES["train_4k"]), seed=SEED)
    losses = []
    for i in range(LOOP_STEPS):
        params, state, metrics = step(params, state, pipe.batch(i))
        losses.append(float(metrics["loss"]))
    out["losses"] = np.asarray(losses, np.float64)
    return {f"loop/glm4_9b|{k}": v for k, v in out.items()}


def run_reference(cases=None, loop: bool = True, workers: int = 4) -> dict:
    cases = CASES if cases is None else cases
    jobs = [lambda n=n, c=c: _ref_case(n, c) for n, c in cases.items()]
    if loop:
        jobs.append(_ref_loop)
    with ThreadPoolExecutor(workers) as pool:
        parts = list(pool.map(lambda job: job(), jobs))
    return {k: v for part in parts for k, v in part.items()}


_REFERENCE_SCRIPT = textwrap.dedent("""
    import importlib
    import sys
    import numpy as np
    from jax.experimental.pallas import tpu as pltpu
    if not hasattr(pltpu, "TPUMemorySpace"):   # renamed in newer jax
        pltpu.TPUMemorySpace = pltpu.MemorySpace
    mod = importlib.import_module(sys.argv[2])
    np.savez(sys.argv[1], **mod.run_reference())
""")


def reference_run(tmp_path_factory, module: str) -> dict:
    """`module.run_reference()` in a subprocess, as {key: array}."""
    path = tmp_path_factory.mktemp("train_ref") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT / 'tests'}",
               XLA_FLAGS=" ".join([os.environ.get("XLA_FLAGS", ""),
                                   "--xla_allow_excess_precision=false"]))
    env.pop("BIGATOMIC_OBS", None)
    proc = subprocess.run([sys.executable, "-c", _REFERENCE_SCRIPT,
                           str(path), module], env=env, capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(path))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return reference_run(tmp_path_factory, "test_torch_train")


# ---------------------------------------------------------------------------
# The port
# ---------------------------------------------------------------------------

def tree_of(reference: dict, prefix: str):
    """The saved leaves under `prefix/` as the reference's tree of numpy
    arrays (bfloat16 as ml_dtypes.bfloat16); path parts that are numbers
    are tuple positions."""
    import ml_dtypes
    root: dict = {}
    for key, arr in reference.items():
        path, _, tag = key.partition("@")
        parts = path.split("/")
        if parts[0] != prefix:
            continue
        node = root
        for part in parts[1:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = (np.asarray(arr).view(ml_dtypes.bfloat16)
                           if tag == "bf16" else np.asarray(arr))

    def fix(node):
        if not isinstance(node, dict):
            return node
        if all(k.isdigit() for k in node):
            return tuple(fix(node[str(i)]) for i in range(len(node)))
        return {k: fix(v) for k, v in node.items()}
    return fix(root)


def case_of(reference: dict, name: str) -> dict:
    return {k.split("|", 1)[1]: v for k, v in reference.items()
            if k.split("|", 1)[0] == name}


def port_case(name, case, saved: dict) -> dict:
    """The port's loss, gradients and one train step on the reference's
    weights and AdamW state; the same keys as `_ref_case`."""
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES, reduced_shape
    from repro_torch.data import DataPipeline, to_device
    from repro_torch.launch.steps import _or_zeros, make_train_step
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.transformer import lm_loss
    from repro_torch.optim import AdamWConfig
    from repro_torch.models.common import tree_map
    arch, variant, fp32, comp = case
    cfg = case_config(get_config, arch, variant, fp32)
    opt = AdamWConfig(**OPT)
    params = convert.model_params(tree_of(saved, "params"), "cpu")
    state = convert.opt_state({"m": tree_of(saved, "m0"),
                               "v": tree_of(saved, "v0"),
                               "step": saved["step0"]}, "cpu")
    batch = to_device(DataPipeline(
        cfg, reduced_shape(SHAPES["train_4k"]), seed=SEED).batch(0), "cpu")
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = lm_loss(live, cfg, batch)
    grads = iter(torch.autograd.grad(loss, tree_leaves(live),
                                     allow_unused=True))
    grads = tree_map(lambda p: _or_zeros(next(grads), p), live)
    new_p, new_s, metrics = make_train_step(cfg, opt, comp)(params, state,
                                                            batch)
    out = {"loss": loss.detach(), "step": new_s["step"],
           "grad_norm": metrics["grad_norm"], "lr": metrics["lr"]}
    for prefix, tree in (("grads", grads), ("new", new_p), ("m", new_s["m"]),
                         ("v", new_s["v"])):
        out.update(flatten(tree, prefix))
    return out


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.detach().numpy()
    return np.asarray(x)


def _want(arr, key: str) -> np.ndarray:
    """A saved array as float (bfloat16 bits widened) or as it is."""
    if key.endswith("@bf16"):
        return (np.asarray(arr).astype(np.uint32) << 16).view(np.float32)
    return np.asarray(arr)


# the relative size of one quantum of each gradient compression
QUANTUM = {"none": 0.0, "bf16": 2 ** -8, "int8": 1 / 127}


def compare_case(name: str, got: dict, want: dict, bf16: bool,
                 compression: str = "none") -> None:
    """Hold the port's case to the reference's.  Gradients: within `rel`
    x the leaf's largest magnitude.  That bound dg (plus a compression
    quantum) carried through the step: m within (1 - b1) dg, v within
    (1 - b2) 2 |g|max dg, each new parameter within lr |du| (u = mh /
    (sqrt(vh) + eps), |du| <= dmh / (s + eps) + |mh| dvh / (2 s (s +
    eps)^2), s = sqrt(vh), from the reference's moments) plus a rounding
    of the parameter (2 fp32 ulps; one bf16 ulp, 2^-7 |p|, in bf16);
    moments also within FP32_RTOL of their largest magnitude."""
    rtol = BF16_RTOL if bf16 else FP32_RTOL
    rel = BF16_ATOL_REL if bf16 else FP32_ATOL_REL
    np.testing.assert_allclose(_np(got["loss"]), want["loss"], rtol=rtol,
                               err_msg=f"{name}: loss")
    assert int(got["step"]) == int(want["step"])
    np.testing.assert_allclose(_np(got["grad_norm"]), want["grad_norm"],
                               rtol=rel, err_msg=f"{name}: grad_norm")
    np.testing.assert_allclose(_np(got["lr"]), want["lr"], rtol=FP32_RTOL,
                               err_msg=f"{name}: lr")
    by_path = {k.split("@", 1)[0]: _want(v, k).astype(np.float64)
               for k, v in want.items()}
    b1, b2, eps = 0.9, 0.95, 1e-8
    step = float(want["step"])
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    lr = float(want["lr"])
    leaves = [k.split("/", 1)[1] for k in by_path if k.startswith("grads/")]
    assert len(leaves) == len([k for k in got if k.startswith("grads/")])
    for leaf in leaves:
        w = {h: by_path[f"{h}/{leaf}"] for h in ("grads", "new", "m", "v",
                                                 "params")}
        g = {h: _np(got[f"{h}/{leaf}"]).astype(np.float64)
             for h in ("grads", "new", "m", "v")}
        gmax = max(np.abs(w["grads"]).max(), 1e-30)
        leaf_rel = rel if bf16 else \
            CANCELLING_ATOL_REL.get(leaf.rsplit("/", 1)[-1], rel)
        dg = (leaf_rel + QUANTUM[compression]) * gmax
        dm = (1 - b1) * dg + FP32_RTOL * np.abs(w["m"]).max()
        dv = (1 - b2) * 2 * gmax * dg + FP32_RTOL * np.abs(w["v"]).max()
        s = np.sqrt(w["v"] / bc2)
        du = (dm / bc1) / (s + eps) + np.abs(w["m"] / bc1) * (dv / bc2) \
            / (2 * s * (s + eps) ** 2)
        ulp = 2 ** -7 if bf16 else 2 ** -22
        bounds = {"grads": leaf_rel * gmax, "m": dm, "v": dv,
                  "new": lr * du + ulp * np.abs(w["params"])}
        for h, bound in bounds.items():
            assert g[h].shape == w[h].shape, (name, h, leaf)
            err = np.abs(g[h] - w[h])
            worst = np.unravel_index(np.argmax(err - bound), err.shape)
            assert (err <= bound).all(), (
                f"{name}: {h}/{leaf} at {worst}: {g[h][worst]} vs "
                f"{w[h][worst]} (bound {np.broadcast_to(bound, err.shape)[worst]})")


@pytest.mark.parametrize("name", list(CASES))
def test_train_step_matches_reference(name, reference):
    """Loss, every gradient leaf (the router's and the aux loss's
    included) and the state after one AdamW step, against the
    reference's on its own weights."""
    saved = case_of(reference, name)
    got = port_case(name, CASES[name], saved)
    compare_case(name, got, saved, bf16=not CASES[name][2],
                 compression=CASES[name][3])


def test_chunked_loss_equals_monolithic(reference):
    """`loss_chunk > 0` (the head and the CE chunk by chunk, each under
    checkpoint) gives the monolithic loss and gradients."""
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES, reduced_shape
    from repro_torch.data import DataPipeline, to_device
    from repro_torch.models.common import tree_leaves, tree_unflatten
    from repro_torch.models.transformer import lm_loss
    saved = case_of(reference, "chunked/glm4_9b")
    params = convert.model_params(tree_of(saved, "params"), "cpu")
    results = []
    for chunk in (0, 4, 5):
        cfg = case_config(get_config, "glm4_9b", {"loss_chunk": chunk},
                          True)
        batch = to_device(DataPipeline(
            cfg, reduced_shape(SHAPES["train_4k"]), seed=SEED).batch(0),
            "cpu")
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss = lm_loss(tree_unflatten(params, leaves), cfg, batch)
        results.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    (l0, g0), *chunked = results
    for loss, grads in chunked:
        np.testing.assert_allclose(loss.numpy(), l0.numpy(), rtol=FP32_RTOL)
        for a, b in zip(grads, g0):
            np.testing.assert_allclose(
                a.numpy(), b.numpy(), rtol=0,
                atol=FP32_ATOL_REL * max(float(b.abs().max()), 1e-30))


@pytest.mark.parametrize("arch", ["glm4_9b", "mixtral_8x7b", "mamba2_780m",
                                  "recurrentgemma_9b"])
def test_remat_equals_no_remat(arch):
    """`cfg.remat` (each period under `checkpoint`) changes nothing: the
    loss and every gradient bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES, reduced_shape
    from repro_torch.data import DataPipeline, to_device
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.transformer import init_params, lm_loss
    out = []
    for remat in (True, False):
        cfg = case_config(get_config, arch, {"remat": remat}, True)
        params = init_params(cfg, 4, device="cpu")
        batch = to_device(DataPipeline(
            cfg, reduced_shape(SHAPES["train_4k"]), seed=SEED).batch(1),
            "cpu")
        leaves = [p.requires_grad_() for p in tree_leaves(params)]
        loss = lm_loss(params, cfg, batch)
        out.append((loss, torch.autograd.grad(loss, leaves,
                                              allow_unused=True)))
    (la, ga), (lb, gb) = out
    assert torch.equal(la, lb)
    for a, b in zip(ga, gb):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_train_step_run_for_every_family(arch):
    """`lm_loss` and `make_train_step` (the stubs until this slice) run
    for every config in its own dtype: a finite loss and gradient norm,
    finite parameters of their dtypes after the step, every leaf the loss
    reaches moved, the step counter advanced and the input state left as
    it was."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES, reduced_shape
    from repro_torch.data import DataPipeline, to_device
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.models.common import tree_leaves, tree_unflatten
    from repro_torch.models.transformer import lm_loss
    from repro_torch.optim import AdamWConfig
    cfg = get_config(arch, reduced=True)
    opt = AdamWConfig(**OPT)
    params, state = init_train_state(cfg, opt, 1, device="cpu")
    batch = to_device(DataPipeline(
        cfg, reduced_shape(SHAPES["train_4k"]), seed=SEED).batch(0), "cpu")
    before = [p.clone() for p in tree_leaves(params)]
    new_p, new_s, metrics = make_train_step(cfg, opt)(params, state, batch)
    assert torch.isfinite(metrics["loss"]) and metrics["loss"] > 0
    assert torch.isfinite(metrics["grad_norm"]) and metrics["grad_norm"] > 0
    assert int(new_s["step"]) == 1 and int(state["step"]) == 0
    live = [p.detach().requires_grad_() for p in tree_leaves(params)]
    grads = torch.autograd.grad(lm_loss(tree_unflatten(params, live), cfg,
                                        batch), live, allow_unused=True)
    for old, p, new, g in zip(before, tree_leaves(params),
                              tree_leaves(new_p), grads):
        assert torch.equal(old, p)
        assert new.dtype == old.dtype and new.shape == old.shape
        assert torch.isfinite(new.float()).all()
        if g is not None and bool(g.any()):
            assert not torch.equal(new, old)


# ---------------------------------------------------------------------------
# Data, schedule, clipping and compression (in process)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_data_pipeline_batches_are_the_references(arch):
    """`DataPipeline` batches equal the reference's byte for byte (tokens,
    features, labels, qwen2-vl's positions), at two steps, for one host
    and for host 1 of 2; the memmap source too (glm4_9b)."""
    from repro.configs import get_config as jget
    from repro.data import DataPipeline as JPipe
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import Shape
    from repro_torch.data import DataPipeline
    shape = Shape("train_4k", 96, 4, "train")
    for step, host, n_hosts in ((0, 0, 1), (5, 1, 2)):
        got = DataPipeline(get_config(arch, reduced=True), shape, seed=11,
                           host_id=host, n_hosts=n_hosts).batch(step)
        want = JPipe(jget(arch, reduced=True), shape, seed=11,
                     host_id=host, n_hosts=n_hosts).batch(step)
        assert sorted(got) == sorted(want)
        for key in want:
            w, g = np.asarray(want[key]), np.asarray(got[key])
            assert g.dtype == w.dtype and g.shape == w.shape, key
            assert g.tobytes() == w.tobytes(), (arch, key, step)


def test_data_pipeline_bf16_without_ml_dtypes(monkeypatch, tmp_path):
    """Without ml_dtypes, bf16 features come as their uint16 bits, the
    same bytes, and `to_device` makes the same bfloat16 tensor; the
    memmap source draws the reference's documents."""
    from repro.configs import get_config as jget
    from repro.data import DataPipeline as JPipe
    from repro.data import make_memmap_corpus as jcorpus
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import Shape
    from repro_torch.data import (DataPipeline, make_memmap_corpus,
                                  to_device)
    shape = Shape("train_4k", 64, 2, "train")
    cfg = get_config("hubert_xlarge", reduced=True)
    assert cfg.compute_dtype == "bfloat16"
    with_ml = DataPipeline(cfg, shape, seed=2).batch(1)
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    bits = DataPipeline(cfg, shape, seed=2).batch(1)
    monkeypatch.undo()
    assert bits["features"].dtype == np.uint16
    assert bits["features"].tobytes() == with_ml["features"].tobytes()
    assert torch.equal(to_device(bits, "cpu")["features"],
                       to_device(with_ml, "cpu")["features"])
    path = make_memmap_corpus(str(tmp_path / "c.bin"), 4096, 256, seed=1)
    jpath = jcorpus(str(tmp_path / "j.bin"), 4096, 256, seed=1)
    assert Path(path).read_bytes() == Path(jpath).read_bytes()
    g = get_config("glm4_9b", reduced=True)
    got = DataPipeline(g, shape, seed=4, source="memmap",
                       memmap_path=path).batch(3)
    want = JPipe(jget("glm4_9b", reduced=True), shape, seed=4,
                 source="memmap", memmap_path=jpath).batch(3)
    assert got["tokens"].tobytes() == np.asarray(want["tokens"]).tobytes()


def test_wsd_schedule_matches_reference():
    """The learning rate at every step 0..total (warmup 3, total 20, and
    warmup 0), within one fp32 ulp of the reference's."""
    import jax.numpy as jnp
    from repro.optim import AdamWConfig as JCfg
    from repro.optim import wsd_schedule as jwsd
    from repro_torch.optim import AdamWConfig, wsd_schedule
    for kw in ({"warmup": 3, "total_steps": 20}, {"warmup": 0,
                                                  "total_steps": 7}):
        steps = np.arange(0, kw["total_steps"] + 3, dtype=np.int32)
        want = np.asarray(jwsd(JCfg(lr=2e-3, **kw), jnp.asarray(steps)))
        got = wsd_schedule(AdamWConfig(lr=2e-3, **kw),
                           torch.from_numpy(steps)).numpy()
        np.testing.assert_allclose(got, want, rtol=2 ** -23, atol=0,
                                   err_msg=str(kw))


def _grad_tree(rng, scale=1.0):
    """A gradient-shaped tree: dict keys out of order, a tuple of layers,
    an int32 leaf (skipped by the norm)."""
    return {"w": rng.standard_normal((5, 7)).astype(np.float32) * scale,
            "a": (rng.standard_normal((3,)).astype(np.float32),
                  rng.standard_normal((2, 2)).astype(np.float32) * 40),
            "n": rng.integers(-50, 50, (4,)).astype(np.int32)}


def _to_jax(tree):
    import jax
    import jax.numpy as jnp
    return jax.tree.map(jnp.asarray, tree)


def _to_port(tree):
    from repro_torch.models.common import tree_map
    return tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def _same_tree(got, want, label):
    """Port tree (tensors) equal to a jax tree bit for bit."""
    import jax
    g = {k: v for k, v in flatten(got, "t").items()}
    w = {k.split("@")[0]: np.asarray(v) for k, v in
         flatten(jax.tree.map(np.asarray, want), "t").items()}
    assert sorted(g) == sorted(w), label
    for k in w:
        gv = g[k].numpy() if g[k].dtype != torch.bfloat16 else \
            g[k].view(torch.int16).numpy().view(np.uint16)
        wv = w[k]
        if wv.dtype.name == "bfloat16":
            wv = wv.view(np.uint16)
        assert gv.dtype == wv.dtype, (label, k)
        assert gv.tobytes() == wv.tobytes(), (label, k)


def test_clip_by_global_norm_matches_reference():
    """`global_norm` (int32 leaves skipped) and `clip_by_global_norm`
    (every leaf scaled in its own dtype, the int32 one too), clipping and
    not, bit for bit with the reference's."""
    import jax.numpy as jnp
    from repro.optim import clip_by_global_norm as jclip
    from repro_torch.optim import clip_by_global_norm
    rng = np.random.default_rng(0)
    tree = _grad_tree(rng)
    for max_norm in (1.0, 1e4):
        want, wn = jclip(_to_jax(tree), max_norm)
        got, gn = clip_by_global_norm(_to_port(tree), max_norm)
        assert gn.numpy().tobytes() == np.asarray(wn).tobytes()
        assert np.asarray(jnp.asarray(wn)) > 1.0
        _same_tree(got, want, f"clip {max_norm}")


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_compression_matches_reference_with_error_feedback(mode):
    """`compress_grads` / `decompress_grads` over 4 steps, the residual of
    each step fed to the next (error feedback), bit for bit with the
    reference's: the compressed tree, the residual, the int8 scales and
    what decompression gives; `none` passes the tree through."""
    from repro.optim import compress_grads as jcomp
    from repro.optim import decompress_grads as jdecomp
    from repro_torch.optim import compress_grads, decompress_grads
    rng = np.random.default_rng(1)
    jres = tres = None
    for step in range(4):
        tree = {k: v for k, v in _grad_tree(rng, 10.0 ** -step).items()
                if k != "n"}
        jc, jres, jmeta = jcomp(_to_jax(tree), jres, mode)
        tc, tres, tmeta = compress_grads(_to_port(tree), tres, mode)
        _same_tree(tc, jc, f"{mode} step {step} compressed")
        _same_tree(tres, jres, f"{mode} step {step} residual")
        assert tmeta[0] == jmeta[0] == mode
        if mode == "int8":
            assert [s.numpy().tobytes() for s in tmeta[1]] == \
                [np.asarray(s).tobytes() for s in jmeta[1]]
        _same_tree(decompress_grads(tc, tmeta), jdecomp(jc, jmeta),
                   f"{mode} step {step} decompressed")
    same = _to_port({"w": np.ones(3, np.float32)})
    assert compress_grads(same, None, "none")[0] is same


# ---------------------------------------------------------------------------
# The train loop
# ---------------------------------------------------------------------------

class _StopAfter:
    """A caller's PreemptionGuard stand-in whose flag is set at the
    `n`-th poll (the loop polls after every step)."""

    def __init__(self, n: int):
        self.n, self.polls = n, 0

    @property
    def should_stop(self) -> bool:
        self.polls += 1
        return self.polls >= self.n


def _loop_checkpoint(reference, path):
    """A step-0 checkpoint of the reference's initial state (its weights,
    AdamW zeros) for `train()` to resume from."""
    from repro_torch import convert
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.optim import AdamWConfig, adamw_init
    saved = case_of(reference, "loop/glm4_9b")
    params = convert.model_params(tree_of(saved, "params"), "cpu")
    state = adamw_init(params, AdamWConfig())
    save_checkpoint(str(path), 0, (params, state), meta={"next_step": 0})
    return saved["losses"]


def test_train_resumes_bit_identical_and_matches_reference(reference,
                                                           tmp_path):
    """`train()` on reduced glm4_9b (fp32) from the reference's initial
    state, 4 steps straight; the same run stopped by a PreemptionGuard
    after step 2 and resumed from its checkpoint ends bit-identical
    (params, AdamW state, the later losses); the losses equal the
    reference's composed steps within FP32_RTOL (loss 0 within 1e-5 x
    the CE), and fall."""
    from repro_torch.checkpoint import list_steps
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES, reduced_shape
    from repro_torch.launch.train import train
    cfg = case_config(get_config, "glm4_9b", {}, True)
    shape = reduced_shape(SHAPES["train_4k"])
    runs = {}
    for name in ("straight", "preempted"):
        ckpt = tmp_path / name
        want = _loop_checkpoint(reference, ckpt)
        kw = dict(steps=LOOP_STEPS, ckpt_dir=str(ckpt), ckpt_every=100,
                  seed=SEED, log_every=0, device="cpu")
        if name == "preempted":
            _, _, first = train(cfg, shape, guard=_StopAfter(2), **kw)
            assert len(first["loss"]) == 2
            assert list_steps(str(ckpt)) == [0, 2]
            p, s, second = train(cfg, shape, **kw)
            losses = first["loss"] + second["loss"]
        else:
            p, s, hist = train(cfg, shape, **kw)
            losses = hist["loss"]
        assert list_steps(str(ckpt))[-1] == LOOP_STEPS
        runs[name] = (p, s, losses)
    (pa, sa, la), (pb, sb, lb) = runs["straight"], runs["preempted"]
    assert la == lb
    for a, b in zip(flatten((pa, sa)).values(), flatten((pb, sb)).values()):
        assert torch.equal(a, b)
    np.testing.assert_allclose(la, want, rtol=FP32_RTOL)
    assert la[-1] < la[0]


def test_train_with_a_mesh_raises():
    """`train(mesh=...)` runs the dense configs (tests/
    test_torch_train_sharded.py); an SSM or hybrid config on a mesh of two
    ranks raises NotImplementedError naming Queue 1 item 8f, before any
    collective (the mesh here has no process group), and so does a rank
    outside its mesh with a dense one."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES, reduced_shape
    from repro_torch.core import distributed as dsb
    from repro_torch.launch.train import train
    shape = reduced_shape(SHAPES["train_4k"])
    mesh = dsb.Mesh((2, 1), ("data", "model"), [1, 0], {}, "cpu")
    for arch in ("mamba2_780m", "recurrentgemma_9b"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 8f"):
            train(get_config(arch, reduced=True), shape, steps=1, mesh=mesh,
                  device="cpu")
    outside = dsb.Mesh((2, 1), ("data", "model"), None, {}, "cpu")
    with pytest.raises(ValueError, match="not a member"):
        train(get_config("glm4_9b", reduced=True), shape, steps=1,
              mesh=outside, device="cpu")
