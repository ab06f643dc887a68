#!/usr/bin/env python3
"""The attention backward kernels alone on one NVIDIA card: a quicker look
than `chip_smoke.py`'s training phase while a backward kernel is being
changed.

    python3 backward_probe.py [--kernels-from DIR] [--dtype DTYPE]
                              [--time] [--steps] [CASE ...]

Run from the root of a checkout on a machine with a CUDA card and `nvcc`.
It builds the dtype's backward library (`flash_attention.bwd_kernel_for`)
and the forward ones, prints what `ptxas -v` said of each function of the
backward (registers, spills), then runs each case of
`chip_smoke.BWD_SHAPES` and `SMALL` (all, or those named) from the
forward kernel's output and LSE: the backward's largest error against
`flash_attention_bwd_plain` as a share of each gradient's largest entry
(dq, dk, dv), whether a second call gives the same bits, the forward
kernel's LSE against the plain one's, and on `chip_smoke.BWD_CASE` the
planted faults' readings.  `--time` adds the backward's device ms (CUDA
events, 5 calls after a warm-up) and a profiled split of its launches.
`--steps` times instead one fp32 train step of every reduced config on
the card (`launch.steps.make_train_step`, the backward's client in
`chip_smoke.py`'s phase 14): host ms, synchronised, the median of 5 after
a warm-up.  A case that fails is reported and the next one runs; the
exit code is 1 if any failed.  Details go to
`chiprun_out/backward_probe.json`.

`--kernels-from DIR` runs the same cases on the port of another checkout
(`DIR/src/repro_torch`, e.g. the parent commit unpacked with `git
archive`), in its own build directory: to compare two versions on one
card, run parent, change, change, parent in one call.  A checkout whose
fp32 forward writes no LSE runs its backward from none, and its faults
are not planted.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# (b, tq, tkv, h, kvh, hd, causal, window): every padded width past the
# configs', ragged ends and windows, at sizes that run in milliseconds
SMALL = {
    "hd16_gqa": (1, 70, 70, 2, 1, 16, True, 0),
    "hd32": (1, 130, 130, 2, 1, 32, True, 0),
    "hd64_ragged": (2, 50, 80, 2, 2, 64, False, 0),
    "hd80_ragged": (1, 150, 170, 2, 1, 80, True, 0),
    "hd96": (1, 150, 150, 2, 1, 96, False, 0),
    "hd112": (1, 150, 150, 2, 1, 112, True, 0),
    "hd128_gqa": (1, 200, 200, 4, 2, 128, True, 0),
    "hd160_ragged": (1, 200, 230, 2, 1, 160, True, 0),
    "hd184_ragged": (2, 150, 150, 4, 2, 184, False, 0),
    "hd224": (1, 150, 150, 2, 1, 224, True, 0),
    "hd256_window": (1, 300, 300, 4, 1, 256, True, 100),
}


def ptxas_lines(log: str) -> list[str]:
    """Each function's registers and spills from a `ptxas -v` log."""
    rows, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            g = re.search(r"(attn_\w+?|fill_\w+?)(?:ILi(\d+)E|I[fN])",
                          m.group(1))
            name = (f"{g.group(1)}<{g.group(2)}>" if g and g.group(2)
                    else g.group(1) if g else m.group(1)[:40])
        elif name and "spill" in line:
            rows.append(f"{name}: {line.strip()}")
        elif name and "Used" in line:
            rows[-1] += "; " + line.split("info    :")[-1].strip()
    return rows


def main(argv) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--kernels-from", type=Path, default=ROOT)
    parser.add_argument("--dtype", default="float32",
                        choices=("float32", "bfloat16"))
    parser.add_argument("--time", action="store_true")
    parser.add_argument("--steps", action="store_true")
    parser.add_argument("names", nargs="*")
    opts = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("backward_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(opts.kernels_from.resolve() / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    if opts.steps:
        return train_steps(torch, cs)
    dtype = getattr(torch, opts.dtype)
    name = fa.bwd_kernel_for(dtype)
    print(cs.card_line(), f"{name} from {fa.__file__}", flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor() as pool:       # one nvcc a library, together
        list(pool.map(_build.build, (name, *fa.KERNELS)))
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    lines = ptxas_lines(_build.library_path(name).with_suffix(".log")
                        .read_text())
    spilling = [x for x in lines if "0 bytes spill stores, 0 bytes spill "
                "loads" not in x]
    print(f"[ptxas] {name}: {len(lines)} functions, {len(spilling)} with "
          "spills", flush=True)
    print("\n".join(f"  {x}" for x in lines), flush=True)

    dev = torch.device("cuda")
    cases = {**cs.BWD_SHAPES, **SMALL}
    results, failed = {"ptxas": lines}, 0
    for i, (case, shape) in enumerate(cases.items()):
        if opts.names and case not in opts.names:
            continue
        b, tq, tkv, h, kvh, hd, causal, window = shape
        try:
            gen = torch.Generator(device=dev).manual_seed(14100 + i)
            q, k, v, do = (torch.randn(s, generator=gen, device=dev).to(dtype)
                           for s in ((b, tq, h, hd), (b, tkv, kvh, hd),
                                     (b, tkv, kvh, hd), (b, tq, h, hd)))
            o, lse = fa.flash_attention(q, k, v, causal=causal,
                                        window=window, with_lse=True)

            def bwd():
                return fa.flash_attention_bwd(q, k, v, o, do, causal=causal,
                                              window=window, lse=lse)
            got = bwd()
            want = fa.flash_attention_bwd_plain(q, k, v, o, do,
                                                causal=causal, window=window)
            r = cs.TrainPhase.reading(got, want)
            again = bwd()
            row = {"reading": r,
                   "same_bits": all(torch.equal(x, y)
                                    for x, y in zip(got, again))}
            if lse is not None:
                _, plain = fa.flash_attention_plain(
                    q, k, v, causal=causal, window=window, with_lse=True)
                row["lse_err"] = float((lse - plain).abs().max())
            ok = max(r) <= cs.BWD_TOL[opts.dtype] and row["same_bits"]
            launch = fa.BACKWARD.get(name)
            if case == cs.BWD_CASE and lse is not None and launch:
                row["faults"] = {}
                for fault, what in cs.BWD_FAULTS.items():
                    bad = tuple(torch.empty_like(t) for t in (q, k, v))
                    launch(q, k, v, o, do, lse, *bad, causal, window,
                           fault=fault)
                    row["faults"][what] = rf = cs.TrainPhase.reading(bad,
                                                                     want)
                    ok = ok and max(rf) > cs.BWD_TOL[opts.dtype]
            if opts.time:
                row["ms"] = time_ms(torch, bwd)
                row["kernels_ms"] = profile(torch, bwd)
                row["bound_ms"] = cs.bwd_bound(*shape, opts.dtype)[2]
            del got, want, again
        except Exception:                  # report it, go on to the next
            row, ok = {"error": traceback.format_exc()[-2000:]}, False
        failed += not ok
        results[case] = row
        print(f"{'ok  ' if ok else 'FAIL'} {case} {json.dumps(row)}",
              flush=True)
        torch.cuda.empty_cache()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "backward_probe.json").write_text(json.dumps(results,
                                                            indent=1))
    return 1 if failed else 0


def train_steps(torch, cs) -> int:
    """Host ms of one fp32 train step of each reduced config on the card,
    from `chip_smoke.TrainPhase.card_vs_cpu`'s state (a 5-step AdamW
    state, `train_4k` reduced)."""
    import dataclasses
    import statistics
    import numpy as np
    from repro_torch import configs, data, optim
    from repro_torch.configs import shapes
    from repro_torch.launch import steps
    from repro_torch.models import common
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    with ThreadPoolExecutor() as pool:
        list(pool.map(_build.build, (fa.bwd_kernel_for(torch.float32),
                                     *fa.KERNELS)))
    dev = torch.device("cuda")
    results = {}
    for i, arch in enumerate(configs.ARCHS):
        cfg = dataclasses.replace(configs.get_config(arch, reduced=True),
                                  param_dtype="float32",
                                  compute_dtype="float32")
        opt = optim.AdamWConfig(**cs.TRAIN_OPT)
        params, _ = steps.init_train_state(cfg, opt, 7 + i, device=dev)
        rng = np.random.default_rng(i)
        state = {k: common.tree_map(lambda p, k=k: torch.from_numpy(
            (rng.standard_normal(p.shape) * 1e-3 if k == "m"
             else rng.uniform(0.5, 1.5, p.shape) * 1e-5).astype(
                np.float32)).to(dev), params) for k in ("m", "v")}
        state["step"] = torch.tensor(5, dtype=torch.int32, device=dev)
        shape = shapes.reduced_shape(shapes.SHAPES["train_4k"])
        batch = data.to_device(data.DataPipeline(cfg, shape, seed=i)
                               .batch(0), dev)
        step = steps.make_train_step(cfg, opt)
        ms = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(params, state, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        results[arch] = {"ms": statistics.median(ms[1:]), "all": ms}
        print(f"step {arch} {json.dumps(results[arch])}", flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "backward_probe_steps.json").write_text(json.dumps(results,
                                                                  indent=1))
    return 0


def time_ms(torch, fn, reps: int = 5) -> float:
    """Device ms of fn: CUDA events around reps calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile(torch, fn, reps: int = 3) -> dict:
    """Device ms a call of each kernel fn launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.device_time_total / 1e3 / reps
            for e in prof.key_averages() if e.device_time_total > 0}


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
