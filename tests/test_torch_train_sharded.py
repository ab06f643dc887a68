"""Sharded training: `repro_torch.launch.train.train(mesh=...)` (data
parallel over 'data', tensor parallel over 'model'), the annotation half
of `repro_torch.dist` and `repro_torch.launch.mesh`, against the port's
one-device `train()` and the reference's live sharded step.

Every case runs once on ONE world of 8 gloo ranks (`torch_dist_world.py`,
job "train", one program on every rank) beside ONE reference subprocess
on 8 fake XLA host devices.  The configs are reduced and in fp32, the
shape (t 32, global batch 8) and AdamW as `torch_dist_world.TRAIN_*`;
each run resumes from a one-device step-0 checkpoint this module writes
(the port's `init_params` and an AdamW state as after 5 steps, so an
update is m / sqrt(v), not the sign of a gradient near 0):

  <arch>/<d>x<m>   glm4_9b (GQA: kv 2 of 4 heads, so at 'model' 4 each
                   rank reads one kv head of a replicated k/v, and at 8
                   the heads replicate), deepseek_7b and hubert_xlarge
                   (features, non-causal) at (data, model) = (8, 1),
                   (1, 8), (2, 4), (4, 2), 3 steps; first step 1's
                   gradients, taken as the step takes them
  chunked_tied/glm4_9b/2x4     `loss_chunk = 4` and `tie_embeddings`
  compress_bf16/deepseek_7b/4x2  `grad_compression="bf16"`
  preempt          glm4 at (2, 4): rank 3's guard alone says stop at its
                   2nd poll; every rank stops after step 2 with the
                   checkpoint written, then resumes at (2, 4) and, from a
                   copy, at (4, 2); a one-device run resumes from another
                   copy
  from_one         a one-device step-2 checkpoint resumed at (2, 4)
  fresh            glm4 at (2, 4) without a checkpoint, from the seed
  refuse           mixtral_8x7b and mamba2_780m at (2, 4) raise the 8f
                   error on every rank, and the world goes on
  ref/<d>x<m>      2 steps at (2, 4) and (4, 2) from the reference's own
                   initial state, against its `jax.jit(make_train_step)`
                   under `dist.axis_rules` on an auto-axis `Mesh`

Tolerances (fp32; the mesh sums the same products in other orders:
partial products over 'model', the batch axes' sums, the CE's sum-exp
over vocab slices): each loss and grad norm within RTOL; each step-1
gradient leaf within GRAD_ATOL_REL x its largest magnitude; after the
steps, each parameter within PARAM_ATOL (lr x an update error of ~1e-4
relative a step: from the moments' state the update is m / sqrt(v), which
a gradient error of GRAD_ATOL_REL moves by that much, never by the 2 lr of
a flipped sign) and each moment within MOMENT_ATOL_REL x its leaf's
largest magnitude.  A resume at the mesh it was written at ends bit for
bit equal to the straight run.
"""

import dataclasses
import pickle
import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import torch_dist_world as W
from repro_torch import dist
from repro_torch.core import distributed as dsb
from torch_threads import one_thread  # noqa: F401

MESHES = [(8, 1), (1, 8), (2, 4), (4, 2)]
ARCHS = ["glm4_9b", "deepseek_7b", "hubert_xlarge"]
STEPS = 3
SEED = 7
REF_SEED = 11
REF_MESHES = [(2, 4), (4, 2)]
REF_STEPS = 2
RTOL = 1e-5
GRAD_ATOL_REL = 1e-5
PARAM_ATOL = 1e-6
MOMENT_ATOL_REL = 1e-5


def _mesh_name(mesh) -> str:
    return "x".join(map(str, mesh))


# name -> (arch, config replacements, grad_compression, mesh)
RUNS = {f"{a}/{_mesh_name(m)}": (a, {}, "none", m)
        for a in ARCHS for m in MESHES}
RUNS["chunked_tied/glm4_9b/2x4"] = (
    "glm4_9b", {"loss_chunk": 4, "tie_embeddings": True}, "none", (2, 4))
RUNS["compress_bf16/deepseek_7b/4x2"] = ("deepseek_7b", {}, "bf16", (4, 2))
REFUSED = ["mixtral_8x7b", "mamba2_780m"]
# the annotation half: the reference's annotation points on reduced shapes
SPEC_MESHES = [((8, 1), ("data", "model")), ((1, 8), ("data", "model")),
               ((2, 4), ("data", "model")), ((4, 2), ("data", "model")),
               ((2, 2, 2), ("pod", "data", "model"))]
SPECS = [((8, 32, 4, 16), ("batch", "seq", "heads", None)),
         ((8, 32, 2, 16), ("batch", "seq", "kv_heads", None)),
         ((6, 32, 6, 16), ("batch", "seq", "heads", None)),
         ((2, 32, 128), ("batch", "seq", "mlp")),
         ((8, 32, 64), ("batch", "seq", None)),
         ((8, 32, 256), ("batch", "seq", "vocab")),
         ((4, 64, 32), ("batch", None, None)),
         ((4, 8, 5, 128), ("batch", "experts", None, "expert_mlp")),
         ((8, 16), ("heads", "mlp")),
         ((3, 8), ("batch", "vocab"))]
SPEC_BATCH = {"tokens": (8, 32), "labels": (6, 32), "pos": (8,)}


def _key(arch, variant, comp):
    return (arch, tuple(sorted(variant.items())), comp)


def _cfg(arch, variant):
    from repro_torch.configs import get_config
    return W.train_config(get_config, arch, variant)


def _shape():
    from repro_torch.configs.shapes import Shape
    t, b = W.TRAIN_SHAPE
    return Shape("train", t, b, "train")


def _opt():
    from repro_torch.optim import AdamWConfig
    return AdamWConfig(**W.TRAIN_OPT)


def _initial_checkpoint(cfg, path):
    """The port's params from SEED and an AdamW state as after 5 steps, as
    a one-device step-0 checkpoint."""
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.launch.steps import init_train_state
    params, state = init_train_state(cfg, _opt(), SEED, device="cpu")
    state = W.moment_state(state, SEED, torch.zeros_like,
                           lambda a, like: torch.as_tensor(a, dtype=like.dtype))
    save_checkpoint(str(path), 0, (params, state), meta={"next_step": 0})


def _one_device(cfg, comp, ckdir, steps=STEPS) -> dict:
    """The port's one-device `train()` from `ckdir` (None: from SEED's
    params, AdamW zeros), and the gradients of `lm_loss` on its step-0
    state."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.data import DataPipeline, to_device
    from repro_torch.launch import steps as st
    from repro_torch.launch.train import train
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.transformer import lm_loss
    out = {}
    if steps == STEPS and ckdir is not None:
        template = st.init_train_state(cfg, _opt(), 0, device="meta")
        state, _ = restore_checkpoint(str(ckdir), 0, template, device="cpu")
        batch = to_device(DataPipeline(cfg, _shape(), seed=W.TRAIN_DATA_SEED)
                          .batch(0), "cpu")
        live = tree_map(lambda x: x.detach().requires_grad_(), state[0])
        grads = iter(torch.autograd.grad(lm_loss(live, cfg, batch),
                                         tree_leaves(live),
                                         allow_unused=True))
        grads = tree_map(lambda x: st._or_zeros(next(grads), x), live)
        out["grads"] = {p: W.bits(x) for p, x in W.walk(grads)}
    p, s, hist = train(cfg, _shape(), steps=steps,
                       ckpt_dir=ckdir and str(ckdir),
                       seed=W.TRAIN_DATA_SEED, opt_cfg=_opt(),
                       grad_compression=comp, log_every=0, ckpt_every=100,
                       device="cpu")
    out.update(loss=hist["loss"], grad_norm=hist["grad_norm"],
               final={p: W.bits(x) for p, x in W.walk((p, s))})
    return out


def build(tmp):
    """The cases, each run's checkpoint directory, and the one-device
    jobs (key -> (cfg, comp, checkpoint dir)) that need no world."""
    masters = {}
    for name, (arch, variant, comp, _) in RUNS.items():
        key = _key(arch, variant, "init")
        if key not in masters:
            masters[key] = tmp / f"init_{len(masters)}"
            _initial_checkpoint(_cfg(arch, variant), masters[key])

    def fresh(master, name):
        dst = tmp / "runs" / name.replace("/", "_")
        shutil.copytree(master, dst)
        return str(dst)
    cases, jobs = [], {}
    for name, (arch, variant, comp, mesh) in RUNS.items():
        master = masters[_key(arch, variant, "init")]
        cases.append(dict(name=name, kind="train", arch=arch, variant=variant,
                          comp=comp, mesh=(mesh, ("data", "model")),
                          steps=STEPS, probe=True, ckdir=fresh(master, name)))
        key = _key(arch, variant, comp)
        if key not in jobs:
            jobs[key] = (_cfg(arch, variant), comp,
                         fresh(master, f"one/{len(jobs)}"))
    glm4 = masters[_key("glm4_9b", {}, "init")]
    copies = [str(tmp / "runs" / "preempt_other"),
              str(tmp / "runs" / "preempt_one")]
    cases.append(dict(name="preempt", kind="train_preempt", arch="glm4_9b",
                      mesh=((2, 4), ("data", "model")), steps=STEPS,
                      stop_rank=3, stop_at=2, copies=copies,
                      resume_mesh=((4, 2), ("data", "model")),
                      ckdir=fresh(glm4, "preempt")))
    one2 = fresh(glm4, "one2")
    two = _one_device(_cfg("glm4_9b", {}), "none", one2, steps=2)
    cases.append(dict(name="from_one", kind="train", arch="glm4_9b",
                      mesh=((2, 4), ("data", "model")), steps=STEPS,
                      ckdir=one2))
    cases.append(dict(name="fresh", kind="train", arch="glm4_9b",
                      mesh=((2, 4), ("data", "model")), steps=STEPS,
                      ckdir=None))
    cases.append(dict(name="refuse", kind="train_refuse", archs=REFUSED,
                      mesh=((2, 4), ("data", "model"))))
    state = str(tmp / "ref_state.pkl")
    for mesh in REF_MESHES:
        dst = tmp / "runs" / f"ref_{_mesh_name(mesh)}"
        dst.mkdir(parents=True)
        cases.append(dict(name=f"ref/{_mesh_name(mesh)}", kind="train_ref",
                          arch="glm4_9b", mesh=(mesh, ("data", "model")),
                          steps=REF_STEPS, state=state, ckdir=str(dst)))
    cases.append(dict(name="ref", kind="train_ref", arch="glm4_9b",
                      seed=REF_SEED, meshes=REF_MESHES, steps=REF_STEPS,
                      state=state, ref=True, world=False))
    cases.append(dict(name="specs", kind="train_specs", meshes=SPEC_MESHES,
                      specs=SPECS, batch=SPEC_BATCH, ref=True, world=False))
    return cases, jobs, copies, two


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world beside the reference's run; the one-device runs in this
    process meanwhile."""
    tmp = tmp_path_factory.mktemp("train_sharded")
    cases, jobs, copies, two = build(tmp)
    inputs = tmp / "cases.pkl"
    inputs.write_bytes(pickle.dumps(cases))
    with W.reference("train", inputs, tmp / "ref.pkl") as ref, \
            ThreadPoolExecutor(1) as pool:
        world = pool.submit(W.run_world, "train", inputs, tmp / "world",
                            timeout=240)
        one = {key: _one_device(cfg, comp, ckdir)
               for key, (cfg, comp, ckdir) in jobs.items()}
        rcs, tails, seconds = world.result()
        assert not any(rcs), "\n".join(tails)
        ref_out = W.finish_reference(ref, tmp / "ref.pkl")
    # a one-device run resumed from the (2, 4) run's step-2 checkpoint
    resumed = _one_device(_cfg("glm4_9b", {}), "none", copies[1])
    fresh = _one_device(_cfg("glm4_9b", {}), "none", None)
    return {"cases": {c["name"]: c for c in cases},
            "world": W.load_world(tmp / "world"), "ref": ref_out,
            "one": one, "resumed": resumed, "two": two, "fresh": fresh,
            "seconds": seconds}


def _one(runs, name):
    arch, variant, comp, _ = RUNS[name]
    return runs["one"][_key(arch, variant, comp)]


def _close_state(got: dict, want: dict, label: str, quantum: float = 0.0,
                 grads: dict | None = None) -> None:
    """Final params within PARAM_ATOL, moments within MOMENT_ATOL_REL of
    their leaf's largest magnitude, the step equal.  With gradient
    compression (`quantum`, its relative rounding: two runs whose
    gradients differ by GRAD_ATOL_REL may round an element one quantum
    apart), each step adds to m (1 - b1) q |g|max, to v (1 - b2) 2 q
    |g|max^2 and to a parameter lr (1 - b1) q |g|max / (bc1 sqrt(v)),
    |g|max the leaf's largest step-1 gradient (`grads`), v its smallest
    final second moment."""
    assert got.keys() == want.keys(), label
    b1, b2, lr = 0.9, 0.95, W.TRAIN_OPT["lr"]
    step = int(want[(1, "step")])
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape and g.dtype == w.dtype, (label, path)
        if path == (1, "step"):
            assert np.array_equal(g, w), (label, path)
            continue
        leaf = path[1:] if path[0] == 0 else path[2:]
        extra = 0.0
        if quantum:
            gmax = np.abs(grads[leaf]).max()
            vmin = want[(1, "v") + leaf].min()
            dm = STEPS * (1 - b1) * quantum * gmax
            extra = {"m": dm, "v": STEPS * (1 - b2) * 2 * quantum * gmax ** 2,
                     "p": lr * dm / ((1 - b1 ** (step - STEPS + 1))
                                     * np.sqrt(vmin))}[
                "p" if path[0] == 0 else path[1]]
        tol = PARAM_ATOL if path[0] == 0 else \
            MOMENT_ATOL_REL * max(np.abs(w).max(), 1e-30)
        np.testing.assert_allclose(g, w, rtol=0, atol=tol + extra,
                                   err_msg=f"{label}: {path}")


def _close_history(got: dict, want: dict, label: str, lo: int = 0) -> None:
    np.testing.assert_allclose(got["loss"], want["loss"][lo:], rtol=RTOL,
                               err_msg=f"{label}: losses")
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"][lo:],
                               rtol=RTOL, err_msg=f"{label}: grad norms")


@pytest.mark.parametrize("name", list(RUNS))
def test_train_matches_one_device(name, runs):
    """3 steps of `train(mesh=...)` against the one-device `train()`:
    losses and grad norms, step 1's gradients (and its loss and norm),
    the final params and both moments, gathered."""
    got, want = runs["world"][0][name], _one(runs, name)
    _close_history(got, want, name)
    assert got["probe"][0] == pytest.approx(want["loss"][0], rel=RTOL)
    assert got["probe"][1] == pytest.approx(want["grad_norm"][0], rel=RTOL)
    assert got["grads"].keys() == want["grads"].keys()
    for path, w in want["grads"].items():
        np.testing.assert_allclose(
            got["grads"][path], w, rtol=0,
            atol=GRAD_ATOL_REL * max(np.abs(w).max(), 1e-30),
            err_msg=f"{name}: step 1's gradient {path}")
    quantum = {"none": 0.0, "bf16": 2 ** -8}[RUNS[name][2]]
    _close_state(got["final"], want["final"], name, quantum, want["grads"])


@pytest.mark.parametrize("name", list(RUNS))
def test_ranks_agree_and_hold_their_slices(name, runs):
    """Every rank reads the same losses and grad norms; every sharded
    leaf's stored slice (params and both moments) holds 1/m of its
    elements, on its placement's dim, and a replicated leaf all of
    them."""
    recs = [rec[name] for rec in runs["world"]]
    m = RUNS[name][3][1]
    for r, rec in enumerate(recs):
        assert rec["loss"] == recs[0]["loss"], r
        assert rec["grad_norm"] == recs[0]["grad_norm"], r
        for path, (spec, local, shape) in rec["slices"].items():
            if "model" in spec and m > 1:
                d = spec.index("model")
                assert local[d] * m == shape[d], (r, path)
                assert local[:d] + local[d + 1:] == shape[:d] + shape[d + 1:]
            else:
                assert local == shape, (r, path)
    sharded = [p for p, (spec, _, _) in recs[0]["slices"].items()
               if "model" in spec]
    assert (len(sharded) > 0) == (m > 1)


@pytest.mark.parametrize("name", [n for n, r in RUNS.items() if r[3][1] > 1])
def test_replicated_leaves_get_equal_gradients_on_model_ranks(name, runs):
    """The leaves a rank computes whole (norms, the features projection,
    heads that do not split) get bit-equal gradients on every rank of a
    'model' group, in the compute layout: the collectives' backward pairs
    make each complete."""
    recs = [rec[name] for rec in runs["world"]]
    groups: dict = {}
    for rec in recs:
        groups.setdefault(rec["coords"]["data"], []).append(rec["whole"])
    for data, members in groups.items():
        assert members[0], data
        for other in members[1:]:
            assert other.keys() == members[0].keys()
            for path, g in members[0].items():
                assert np.array_equal(other[path], g), (data, path)


def test_preemption_on_one_rank_stops_every_rank(runs):
    """Rank 3's flag alone stops every rank after step 2 with the step-2
    checkpoint written; resumed at (2, 4) the run ends bit for bit equal
    to the straight (2, 4) run (losses too)."""
    straight = runs["world"][0]["glm4_9b/2x4"]
    for r, rec in enumerate(runs["world"]):
        p = rec["preempt"]
        assert len(p["first"]) == 2 and p["steps"] == [0, 2], r
        assert len(p["second"]) == 1, r
        assert p["first"] + p["second"] == straight["loss"], r
    got = runs["world"][0]["preempt"]["final"]
    assert got.keys() == straight["final"].keys()
    for path, x in straight["final"].items():
        assert np.array_equal(got[path], x), path


def test_checkpoints_cross_meshes_and_one_device(runs):
    """A (2, 4) step-2 checkpoint resumed at (4, 2) and on one device, and
    a one-device step-2 checkpoint resumed at (2, 4): each run ends within
    the tolerances of the uninterrupted one-device run."""
    want = _one(runs, "glm4_9b/2x4")
    p = runs["world"][0]["preempt"]
    _close_history({"loss": p["third"], "grad_norm": []},
                   {"loss": want["loss"], "grad_norm": []}, "at (4, 2)", 2)
    _close_state(p["final_other"], want["final"], "(2, 4) -> (4, 2)")
    _close_history(runs["resumed"], want, "(2, 4) -> one device", 2)
    _close_state(runs["resumed"]["final"], want["final"],
                 "(2, 4) -> one device")
    np.testing.assert_allclose(runs["two"]["loss"], want["loss"][:2],
                               rtol=0)
    one = runs["world"][0]["from_one"]
    _close_history(one, want, "one device -> (2, 4)", 2)
    _close_state(one["final"], want["final"], "one device -> (2, 4)")


def test_fresh_run_matches_one_device(runs):
    """Without a checkpoint every rank draws the params from the seed and
    keeps its slices, the AdamW moments zeros of the slices' shapes: the
    losses and grad norms of 3 steps against the one-device run's within
    RTOL.  (From zero moments the first update is lr sign(g), so the
    params are held only through the later steps' losses.)"""
    for r, rec in enumerate(runs["world"]):
        _close_history(rec["fresh"], runs["fresh"], f"fresh, rank {r}")
    for path, (spec, local, shape) in runs["world"][0]["fresh"][
            "slices"].items():
        if path[0] == 1 and path[1] in ("m", "v") and "model" in spec:
            assert local[spec.index("model")] * 4 == shape[spec.index(
                "model")], path


def test_moe_and_ssm_refuse_on_every_rank(runs):
    """mixtral_8x7b and mamba2_780m at (2, 4) raise NotImplementedError
    naming Queue 1 item 8f on every rank, before any collective (in well
    under the group timeout), and the world goes on to its next case."""
    for r, rec in enumerate(runs["world"]):
        for arch in REFUSED:
            msg, seconds = rec["refuse"][arch]
            assert "Queue 1 item 8f" in msg, (r, arch, msg)
            assert seconds < W.PG_TIMEOUT_S / 4, (r, arch, seconds)
        assert "ref/2x4" in rec


@pytest.mark.parametrize("mesh", REF_MESHES, ids=_mesh_name)
def test_matches_reference_live_sharded_step(mesh, runs):
    """2 steps at (2, 4) and (4, 2) from the reference's initial state
    against its `jit(make_train_step)` under `axis_rules` on the same
    mesh: losses and grad norms within RTOL, the params and moments after
    them within the tolerances above."""
    got = runs["world"][0][f"ref/{_mesh_name(mesh)}"]
    want = runs["ref"]["ref"][tuple(mesh)]
    _close_history(got, want, f"reference at {mesh}")
    _close_state(got["final"], want["final"], f"reference at {mesh}")
    for rec in runs["world"][1:]:
        assert rec[f"ref/{_mesh_name(mesh)}"]["loss"] == got["loss"]


@pytest.mark.parametrize("mesh", SPEC_MESHES, ids=lambda m: _mesh_name(m[0]))
def test_annotation_half_matches_reference(mesh, runs):
    """`dist.spec`, `dist.local_slices` on every rank of the mesh and
    `dist.batch_shardings` against the reference's `_spec`, each device's
    slice of its `NamedSharding` and its `batch_shardings`, on the model's
    annotation shapes (dims that do not divide, an axis used twice, the
    ('pod', 'data') batch)."""
    shape, axes = mesh
    want = runs["ref"]["specs"][(tuple(shape), tuple(axes))]
    first = dsb.Mesh(shape, axes, [0] * len(shape), {}, "cpu")
    rules = dist.make_rules(None, first)
    for (dims, names), (spec, by_coord) in want["specs"].items():
        assert len(by_coord) == np.prod(shape)
        for coord, slices in by_coord.items():
            fake = dsb.Mesh(shape, axes, list(coord), {}, "cpu")
            assert dist.spec(dims, names, fake, rules) == spec
            with dist.axis_rules(fake, rules):
                assert dist.local_slices(dims, *names) == slices, \
                    (dims, names, coord)
    batch = {k: np.zeros(v, np.int32) for k, v in SPEC_BATCH.items()}
    got = dist.batch_shardings(batch, first, rules)
    assert {k: p.spec for k, p in got.items()} == want["batch"]


def test_shard_is_the_annotation_and_local_rows_cut_the_batch():
    """`shard` returns its input outside a context and inside one, and
    raises the reference's ValueError on a rank mismatch there;
    `local_rows` gives each rank its block of rows (every row where the
    batch axes do not divide them); `launch.mesh.describe`."""
    from repro_torch.launch.mesh import describe
    x = torch.zeros(2, 3)
    assert dist.shard(x, "batch", None) is x
    fake = dsb.Mesh((2, 2), ("data", "model"), [1, 0], {}, "cpu")
    rules = dist.make_rules(None, fake)
    with dist.axis_rules(fake, rules):
        assert dist.shard(x, "batch", None) is x
        with pytest.raises(ValueError, match="rank 2 != 3 names"):
            dist.shard(x, "batch", "seq", None)
    assert dist.current() is None
    batch = {"tokens": np.arange(8 * 3).reshape(8, 3), "odd": np.arange(3)}
    rows = dist.local_rows(batch, fake, rules)
    assert np.array_equal(rows["tokens"], batch["tokens"][4:8])
    assert rows["odd"] is batch["odd"]
    assert describe(fake) == "data=2 x model=2"


def test_launch_meshes_check_the_world():
    """`launch.mesh` builds over the `torch.distributed` world: the
    production mesh needs its 256 (512) ranks and the host mesh a 'model'
    axis that divides the world (here no group: a world of one)."""
    from repro_torch.launch import mesh as lm
    with pytest.raises(ValueError, match="needs 256 ranks"):
        lm.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="needs 512 ranks"):
        lm.make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(ValueError, match="no 'model' axis of 3"):
        lm.make_host_mesh(3, device="cpu")


@pytest.mark.parametrize("spec", [("model", None), (None, "model"), ()],
                         ids=["dim0", "dim1", "replicated"])
def test_shard_leaf_moves_only_the_slice(spec):
    """`dist.shard_leaf` cuts the rank's slice where the leaf lies and
    moves only that to the mesh's device (here 'meta'): a resume on a mesh
    reads the checkpoint into host memory, and no rank's device then holds
    more of a leaf than its slice."""
    from torch.overrides import TorchFunctionMode
    moved = []

    class Record(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is torch.Tensor.to:
                moved.append(tuple(args[0].shape))
            return func(*args, **(kwargs or {}))
    mesh = dsb.Mesh((2, 4), ("data", "model"), [1, 2], {}, "meta")
    x = torch.arange(16 * 8, dtype=torch.float32).reshape(16, 8)
    with Record():
        leaf = dist.shard_leaf(x, dist.Placement(spec), mesh)
    want = {("model", None): (4, 8), (None, "model"): (16, 2),
            (): (16, 8)}[spec]
    assert moved == [want]
    assert leaf.local.device.type == "meta"
    assert tuple(leaf.local.shape) == want and leaf.shape == (16, 8)
