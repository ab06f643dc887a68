"""End-to-end trainer: config -> train loop with checkpoint and resume,
preemption safety, a straggler watchdog and the versioned in-memory
snapshot store (the big-atomics multiversioning application), on one
device or on a mesh.  The port of the JAX package's `launch/train.py`.

Each step publishes (params, opt_state) into `core.multiversion`'s store;
a checkpoint is written from a validated snapshot of it
(`checkpoint.save_checkpoint`), and a run with a checkpoint directory
resumes from its newest step: the data are a pure function of (seed,
step), so a resumed run takes the same batches.

On a mesh (`mesh=`, a `core.distributed.Mesh` of axes 'data' (and 'pod')
and 'model') every rank of the mesh calls `train` with the same
arguments and runs the same program, multi-controller: data parallel
over the batch axes, tensor parallel over 'model' (`launch.steps.
sharded_step`), for the dense decoders and the encoder.  The state is
placed by `runtime.reshard_state` (each rank holds its slice of every
sharded parameter and of both AdamW moments); each step takes the global
batch `pipe.batch(step)` and the step cuts its rows; the store holds the
rank's slices.  A checkpoint is the one-device format: the validated
snapshot gathered over 'model', written by the mesh's first rank, then a
barrier, so a run resumes from another mesh's or one device's
checkpoints.  Every host branch reads agreed values: the checkpoint step
to resume from, and once a step the stop flag with every rank's step
time (one `all_reduce(MAX)`, which the watchdog reads); the loss, read
once a step, is the same on every rank.  MoE, SSM and hybrid configs on
a mesh of more than one rank raise NotImplementedError (ROADMAP Queue 1
item 8f) before any collective.

  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b \\
      --reduced --device cpu --steps 50 --ckpt-dir CKPT --ckpt-every 20
  torchrun --nproc-per-node 8 -m repro_torch.launch.train --arch glm4-9b \\
      --reduced --device cpu --steps 4
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time

import torch
import torch.distributed as tdist

from repro_torch import dist
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES, Shape, reduced_shape
from repro_torch.core import distributed as dsb
from repro_torch.core import multiversion as mv
from repro_torch.core.layout import resolve_device
from repro_torch.data import DataPipeline, to_device
from repro_torch.launch.mesh import describe, make_host_mesh
from repro_torch.launch.steps import init_train_state, make_train_step
from repro_torch.models.common import tree_map
from repro_torch.models.transformer import init_params
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime import PreemptionGuard, StragglerWatchdog
from repro_torch.runtime.elastic import reshard_state


def _check_family(cfg, mesh) -> None:
    """Raise NotImplementedError for a MoE, SSM or hybrid config on a mesh
    of more than one rank (a host check: every rank raises, before any
    collective)."""
    if len(mesh.ranks) < 2 or not (cfg.is_moe or any(
            kind != "attn" for kind in cfg.block_pattern)):
        return
    raise NotImplementedError(
        f"train(mesh=...): {cfg.name} ({cfg.family}) on {len(mesh.ranks)} "
        "ranks is not ported yet: sharded training runs the dense decoders "
        "and the encoder; MoE (a global expert ranking, expert "
        "parallelism), SSM and hybrid configs wait for ROADMAP Queue 1 "
        "item 8f")


def _sharded_init(cfg, opt_cfg: AdamWConfig, seed: int, mesh):
    """Fresh params drawn on every rank from `seed` and cut to the rank's
    slices, AdamW moments as zeros of the slices' shapes (never whole: at
    glm4_9b's width the fp32 moments are 13 GB a rank)."""
    params = init_params(cfg, seed, device=mesh.device)
    rules = dist.make_rules(cfg, mesh)
    params = tree_map(lambda x, pl: dist.shard_leaf(x, pl, mesh), params,
                      dist.param_shardings(params, cfg, mesh, rules))
    local = adamw_init(tree_map(lambda p: p.local, params), opt_cfg)

    def wrap(x, p):
        return dist.ShardedLeaf(x, p.placement, p.shape, x.dtype, mesh)
    return params, {"m": tree_map(wrap, local["m"], params),
                    "v": tree_map(wrap, local["v"], params),
                    "step": dist.ShardedLeaf(local["step"], dist.Placement(),
                                             (), torch.int32, mesh)}


def _gathered(state, like, writer: bool):
    """The one-device state of a snapshot of slices (`state`, in the tree
    of the ShardedLeafs `like`): each leaf gathered over 'model' (every
    rank joins), kept on the host by the writer alone."""
    def leaf(x, ref):
        full = dist.gather_leaf(dist.ShardedLeaf(x, ref.placement, ref.shape,
                                                 ref.dtype, ref.mesh))
        return full.cpu() if writer else None
    return tree_map(leaf, state, like)


def train(cfg, shape: Shape, *, steps: int, ckpt_dir: str | None = None,
          ckpt_every: int = 50, seed: int = 0, lr: float = 3e-4,
          grad_compression: str = "none", mesh=None, snapshot_slots: int = 2,
          log_every: int = 10, guard: PreemptionGuard | None = None,
          opt_cfg: AdamWConfig | None = None, device="cuda"):
    """Returns (params, opt_state, history {loss, grad_norm, step_time});
    on a mesh, params and opt_state are trees of the rank's
    `dist.ShardedLeaf`s (`dist.gather_leaf` gives a leaf whole).

    `snapshot_slots`: copies of the train state the store's ring holds
    (each as large as the state).  `guard`: a caller's PreemptionGuard,
    polled after every step (default: one of its own, installed around the
    loop); when it says stop (on any rank of the mesh), a checkpoint is
    written and the loop ends.  `mesh`: see the module; `device` is then
    the mesh's."""
    if mesh is not None:
        _check_family(cfg, mesh)
        if not mesh.member:
            raise ValueError(f"train(mesh=...): this rank is not a member "
                             f"of {mesh!r}")
        device = mesh.device
    device = resolve_device(device)
    opt_cfg = opt_cfg or AdamWConfig(lr=lr, warmup=max(steps // 20, 1),
                                     total_steps=steps)
    pipe = DataPipeline(cfg, shape, seed=seed)

    last = latest_step(ckpt_dir) if ckpt_dir else None
    if mesh is not None:                  # every rank resumes the same step
        last = int(dsb.agree_max(mesh, [-1 if last is None else last])[0])
        last = None if last < 0 else last
    start = 0
    if last is None and mesh is not None:
        params, opt_state = _sharded_init(cfg, opt_cfg, seed, mesh)
    elif last is None:
        params, opt_state = init_train_state(cfg, opt_cfg, seed,
                                             device=device)
    else:
        # the template's shapes and dtypes come from the meta device, no
        # weights drawn; one device: the state straight onto it; a mesh:
        # onto the host, each rank then moving only its slices to its
        # device, leaf by leaf (the whole state may not fit there)
        template = init_train_state(cfg, opt_cfg, seed, device="meta")
        (params, opt_state), meta = restore_checkpoint(
            ckpt_dir, last, template,
            device=device if mesh is None else "cpu")
        if mesh is not None:
            params, opt_state = reshard_state((params, opt_state), cfg, mesh)
        start = int(meta.get("next_step", last))
        print(f"[train] resumed from step_{last:08d} -> step {start}")

    if mesh is None:
        rules_ctx = contextlib.nullcontext()
        n_hosts, writer = 1, True
    else:
        rules_ctx = dist.axis_rules(mesh, dist.make_rules(cfg, mesh))
        n_hosts = len(mesh.ranks)
        writer = tdist.get_rank() == mesh.ranks[0]

    def local(state):
        return state if mesh is None else tree_map(lambda x: x.local, state)

    step_fn = make_train_step(cfg, opt_cfg, grad_compression)
    store = mv.init_store(local((params, opt_state)), n_slots=snapshot_slots)
    watchdog = StragglerWatchdog(n_hosts=n_hosts)
    history = {"loss": [], "grad_norm": [], "step_time": []}
    own_guard = guard is None
    guard = guard or PreemptionGuard()
    with guard if own_guard else contextlib.nullcontext(), rules_ctx:
        for step in range(start, steps):
            t0 = time.perf_counter()
            batch = to_device(pipe.batch(step), device)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])        # waits for the step
            dt = time.perf_counter() - t0
            history["loss"].append(loss)
            history["grad_norm"].append(float(metrics["grad_norm"]))
            history["step_time"].append(dt)
            stopping = guard.should_stop
            times = [dt]
            if mesh is not None:     # one agreement: the flag, every time
                mine = [0.0] * n_hosts
                mine[mesh.ranks.index(tdist.get_rank())] = dt
                stop, *times = dsb.agree_max(mesh, [stopping] + mine)
                stopping = bool(stop)
            watchdog.observe(times)
            # publish into the versioned store (readers snapshot it)
            store = mv.publish(store, local((params, opt_state)), step + 1)
            if log_every and step % log_every == 0:
                print(f"[train] step {step} loss {loss:.4f} "
                      f"({dt * 1e3:.0f} ms)", flush=True)
            if ckpt_dir and (stopping or (step + 1) % ckpt_every == 0
                             or step + 1 == steps):
                snap = mv.snapshot_with_validation(store)
                state = snap.state if mesh is None else _gathered(
                    snap.state, (params, opt_state), writer)
                if writer:
                    save_checkpoint(ckpt_dir, step + 1, state,
                                    meta={"next_step": step + 1,
                                          "arch": cfg.name})
                if mesh is not None:
                    tdist.barrier(group=mesh.group)
                del snap, state
            if stopping:
                print(f"[train] preempted at step {step + 1}; "
                      "checkpoint written, exiting cleanly")
                break
    return params, opt_state, history


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES))
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config + tiny shape (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "bf16", "int8"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_config(args.arch, reduced=args.reduced)
    shape = SHAPES[args.shape]
    if args.reduced:
        shape = reduced_shape(shape)
    mesh = None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:   # under torchrun
        device = resolve_device(args.device)
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        tdist.init_process_group("nccl" if device.type == "cuda"
                                 else "gloo")
        mesh = make_host_mesh(device=args.device)
    where = describe(mesh) if mesh is not None else args.device
    print(f"[train] {cfg.name}  shape={shape}  mesh={where}")
    try:
        _, _, hist = train(cfg, shape, steps=args.steps,
                           ckpt_dir=args.ckpt_dir,
                           ckpt_every=args.ckpt_every, seed=args.seed,
                           lr=args.lr,
                           grad_compression=args.grad_compression,
                           mesh=mesh, device=args.device)
    finally:
        if mesh is not None:
            tdist.destroy_process_group()
    print(f"[train] done: loss {hist['loss'][0]:.4f} -> "
          f"{hist['loss'][-1]:.4f} over {len(hist['loss'])} steps")


if __name__ == "__main__":
    main()
