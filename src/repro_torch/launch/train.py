"""End-to-end trainer on one device: config -> train loop with checkpoint
and resume, preemption safety, a straggler watchdog and the versioned
in-memory snapshot store (the big-atomics multiversioning application).
The port of the JAX package's `launch/train.py`, without its mesh: a
sharded run (`mesh=`) raises NotImplementedError until the port has one
(ROADMAP Queue 1 item 8e).

Each step publishes (params, opt_state) into `core.multiversion`'s store;
a checkpoint is written from a validated snapshot of it
(`checkpoint.save_checkpoint`), and a run with a checkpoint directory
resumes from its newest step: the data are a pure function of (seed,
step), so a resumed run takes the same batches.

  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b \\
      --reduced --device cpu --steps 50 --ckpt-dir CKPT --ckpt-every 20
"""

from __future__ import annotations

import argparse
import contextlib
import time

from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES, Shape, reduced_shape
from repro_torch.core import multiversion as mv
from repro_torch.core.layout import resolve_device
from repro_torch.data import DataPipeline, to_device
from repro_torch.launch.steps import init_train_state, make_train_step
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import PreemptionGuard, StragglerWatchdog


def train(cfg, shape: Shape, *, steps: int, ckpt_dir: str | None = None,
          ckpt_every: int = 50, seed: int = 0, lr: float = 3e-4,
          grad_compression: str = "none", mesh=None, snapshot_slots: int = 2,
          log_every: int = 10, guard: PreemptionGuard | None = None,
          opt_cfg: AdamWConfig | None = None, device="cuda"):
    """Returns (params, opt_state, history {loss, grad_norm, step_time}).

    `snapshot_slots`: copies of the train state the store's ring holds
    (each as large as the state).  `guard`: a caller's PreemptionGuard,
    polled after every step (default: one of its own, installed around the
    loop); when it says stop, a checkpoint is written and the loop ends."""
    if mesh is not None:
        raise NotImplementedError(
            "train(mesh=...): sharded training is not ported yet (ROADMAP "
            "Queue 1 item 8e); train on one device")
    device = resolve_device(device)
    opt_cfg = opt_cfg or AdamWConfig(lr=lr, warmup=max(steps // 20, 1),
                                     total_steps=steps)
    pipe = DataPipeline(cfg, shape, seed=seed)

    last = latest_step(ckpt_dir) if ckpt_dir else None
    start = 0
    if last is None:
        params, opt_state = init_train_state(cfg, opt_cfg, seed,
                                             device=device)
    else:
        # the checkpoint's state straight onto the device: the template's
        # shapes and dtypes come from the meta device, no weights drawn
        template = init_train_state(cfg, opt_cfg, seed, device="meta")
        (params, opt_state), meta = restore_checkpoint(
            ckpt_dir, last, template, device=device)
        start = int(meta.get("next_step", last))
        print(f"[train] resumed from step_{last:08d} -> step {start}")

    step_fn = make_train_step(cfg, opt_cfg, grad_compression)
    store = mv.init_store((params, opt_state), n_slots=snapshot_slots)
    watchdog = StragglerWatchdog(n_hosts=1)
    history = {"loss": [], "grad_norm": [], "step_time": []}
    own_guard = guard is None
    guard = guard or PreemptionGuard()
    with guard if own_guard else contextlib.nullcontext():
        for step in range(start, steps):
            t0 = time.perf_counter()
            batch = to_device(pipe.batch(step), device)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])        # waits for the step
            dt = time.perf_counter() - t0
            history["loss"].append(loss)
            history["grad_norm"].append(float(metrics["grad_norm"]))
            history["step_time"].append(dt)
            watchdog.observe([dt])
            # publish into the versioned store (readers snapshot it)
            store = mv.publish(store, (params, opt_state), step + 1)
            if log_every and step % log_every == 0:
                print(f"[train] step {step} loss {loss:.4f} "
                      f"({dt * 1e3:.0f} ms)", flush=True)
            stopping = guard.should_stop
            if ckpt_dir and (stopping or (step + 1) % ckpt_every == 0
                             or step + 1 == steps):
                snap = mv.snapshot_with_validation(store)
                save_checkpoint(ckpt_dir, step + 1, snap.state,
                                meta={"next_step": step + 1,
                                      "arch": cfg.name})
                del snap
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
    print(f"[train] {cfg.name}  shape={shape}  device={args.device}")
    _, _, hist = train(cfg, shape, steps=args.steps, ckpt_dir=args.ckpt_dir,
                       ckpt_every=args.ckpt_every, seed=args.seed,
                       lr=args.lr, grad_compression=args.grad_compression,
                       device=args.device)
    print(f"[train] done: loss {hist['loss'][0]:.4f} -> "
          f"{hist['loss'][-1]:.4f} over {len(hist['loss'])} steps")


if __name__ == "__main__":
    main()
