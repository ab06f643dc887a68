"""The training path of the MoE, SSM and RG-LRU families against the JAX
reference on the CPU: tests/test_torch_train.py's step cases (one
reference subprocess, `jax.jit` of loss + grad + step a case; the port on
the reference's weights and AdamW state, its own byte-identical batch),
with its tolerances (`test_torch_train.compare_case`), for:

  fp32/<arch>          mixtral_8x7b (top-2, sliding window, dropless),
                       llama4_maverick (top-1), mamba2_780m (the SSD and
                       the associative scan through autograd),
                       recurrentgemma_9b (RG-LRU, local attention)
  drops/mixtral_8x7b   `moe_dropless = False`: capacity dispatch, pairs
                       dropped, the aux loss

Every gradient leaf is compared, the router's (through the gates and the
aux loss's mean probabilities; the one-hot counts carry none) included."""

import numpy as np
import pytest

from test_torch_train import (case_of, compare_case, port_case,
                              reference_run)
from torch_threads import one_thread  # noqa: F401
from test_torch_train import run_reference as _run

FAMILIES = ["mixtral_8x7b", "llama4_maverick_400b_a17b", "mamba2_780m",
            "recurrentgemma_9b"]
CASES = {
    **{f"fp32/{a}": (a, {}, True, "none") for a in FAMILIES},
    "drops/mixtral_8x7b": ("mixtral_8x7b", {"moe_dropless": False,
                                            "capacity_factor": 1.0}, True,
                           "none"),
}


def run_reference() -> dict:
    return _run(CASES, loop=False)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return reference_run(tmp_path_factory, "test_torch_train_families")


@pytest.mark.parametrize("name", list(CASES))
def test_train_step_matches_reference(name, reference):
    """Loss, every gradient leaf and the state after one AdamW step,
    against the reference's on its own weights."""
    saved = case_of(reference, name)
    got = port_case(name, CASES[name], saved)
    compare_case(name, got, saved, bf16=False)


def test_capacity_drops_happen():
    """The drops case drops pairs (so its gradients cover the dropped
    path): mixtral's reduced config at cf 1.0 over the case's batch."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES, reduced_shape
    from repro_torch.data import DataPipeline, to_device
    from repro_torch.models import moe, transformer
    from test_torch_train import SEED
    arch, variant, _, _ = CASES["drops/mixtral_8x7b"]
    cfg = dataclasses.replace(get_config(arch, reduced=True), **variant,
                              param_dtype="float32", compute_dtype="float32")
    params = transformer.init_params(cfg, 0, device="cpu")
    batch = to_device(DataPipeline(
        cfg, reduced_shape(SHAPES["train_4k"]), seed=SEED).batch(0), "cpu")
    x, _ = transformer.embed_inputs(params, cfg, batch, "train")
    mlp = params["stack"][0]["mlp"]
    b, t, d = x.shape
    G, C = moe.group_capacity(cfg, b * t, dropless=False)
    r = moe.route(x.reshape(G, -1, d), mlp["router"][0], cfg, C)
    assert not bool(r.keep.all()) and bool(r.keep.any())
    assert np.isfinite(float(r.aux.mean())) and torch.isfinite(x).all()
