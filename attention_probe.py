#!/usr/bin/env python3
"""The attention kernels alone on one NVIDIA card: a quicker look than
`chip_smoke.py` while a kernel is being changed.

    python3 attention_probe.py [--kernels-from DIR] [CASE ...]

Run from the root of a checkout on a machine with a CUDA card and `nvcc`.
It builds the forward attention libraries (`flash_attention.KERNELS`:
`kernels/csrc/flash_attention_wgmma.cu`, `flash_attention_tf32x3.cu`)
and prints what `ptxas -v` said of each kernel (registers, spills), then
runs each case of `chip_smoke.ATTENTION_CASES` (all, or those named):
which kernel it launched, its largest error against
`flash_attention_plain` and that error over the case's tolerance, and the
times `chip_smoke.AttentionPhase.timing` takes (kernel, bound, SDPA);
for a case whose head dim the wrapper zero-pads for TMA, also the split
of its time: the kernel alone on padded inputs, the three pads and the
output's copy (device ms each).
A case that fails is reported and the next one runs; the exit code is 1
if any failed.  Details go to `chiprun_out/attention_probe.json`.

`--kernels-from DIR` runs the same cases on the port of another checkout
(`DIR/src/repro_torch`, e.g. the parent commit unpacked with `git
archive`): its routes, kernels and build directory, each case held to the
kernel that checkout routes it to.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main(argv) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--kernels-from", type=Path, default=ROOT)
    parser.add_argument("names", nargs="*")
    opts = parser.parse_args(argv)
    names = opts.names
    import torch
    if not torch.cuda.is_available():
        print("attention_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(opts.kernels_from.resolve() / "src"))
    import chip_smoke as cs
    from repro_torch import atomics, convert
    from repro_torch import kernels as tk
    from repro_torch.core import engine
    from repro_torch.kernels import _build
    from repro_torch.kernels import engine_round as er
    from repro_torch.kernels import flash_attention as fa

    print(cs.card_line(), f"kernels from {fa.__file__}", flush=True)
    t0 = time.perf_counter()
    for lib in fa.KERNELS:                  # the forward kernels' libraries
        _build.build(lib)
        print(f"[build] {lib} {time.perf_counter() - t0:.1f} s", flush=True)
        log = _build.library_path(lib).with_suffix(".log").read_text()
        for line in log.splitlines():
            if "Compiling entry" in line and "_kernelI" in line:
                end = line.index("_kernelI")     # <name>_kernelI<args>EEv...
                start = line.rfind("flash_attention", 0, end)
                args = line[end + 8:line.index("EEv", end)]
                print(f"  {line[start:end]}_kernel<{args}>")
            elif "Compiling entry" in line:      # a helper kernel
                print("  " + line.split("'")[1] if "'" in line else line)
            elif "registers" in line or "spill" in line:
                print("    " + line.strip())
    phase = cs.AttentionPhase(cs.Smoke(torch, atomics, engine, er, convert,
                                       tk), fa)
    results, failed = {}, 0
    for i, (name, c) in enumerate(cs.ATTENTION_CASES.items()):
        if names and name not in names:
            continue
        try:
            tk.reset_launch_counts()
            q, k, v = phase.inputs(name, 6000 + i)
            out = fa.flash_attention(q, k, v, causal=c.causal,
                                     window=c.window)
            torch.cuda.synchronize()
            ran = [n for n, count in tk.launch_counts().items() if count]
            routed = c.kernel if opts.kernels_from.resolve() == ROOT else \
                fa.kernel_for(q.dtype, c.hd)
            want = fa.flash_attention_plain(q, k, v, causal=c.causal,
                                            window=c.window).float()
            err = (out.float() - want).abs()
            atol, rtol = c.tol
            over = float((err / (atol + rtol * want.abs())).max())
            row = {"ran": ran, "max_abs_err": float(err.max()),
                   "err_over_tol": over,
                   "finite": bool(torch.isfinite(out).all())}
            row.update({key: val for key, val in
                        phase.timing(name, 6000 + i).items()
                        if key in ("ms", "bound_ms", "library_ms",
                                   "library_causal_ms")})
            if fa.padded_width(q.dtype, c.hd) is not None and \
                    fa.aligned_head_dim(q.dtype, c.hd) != c.hd:
                row["split"] = split(phase.s, fa, _build, c, q, k, v)
            ok = ran == [routed] and over <= 1 and row["finite"]
        except Exception:                  # report it, go on to the next
            row, ok = {"error": traceback.format_exc()[-2000:]}, False
            torch.cuda.synchronize()
        failed += not ok
        results[name] = row
        print(f"{'ok  ' if ok else 'FAIL'} {name} {json.dumps(row)}",
              flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "attention_probe.json").write_text(json.dumps(results,
                                                             indent=1))
    return 1 if failed else 0


def split(smoke, fa, build, c, q, k, v):
    """Device ms of the padded route's parts: the tensor-core kernel alone
    on q, k, v padded to `aligned_head_dim`, the three pads, and the copy
    of the output's first hd columns."""
    import ctypes
    import math
    import torch.nn.functional as F
    hd = c.hd
    hd_k = fa.aligned_head_dim(q.dtype, hd)
    name = fa.kernel_for(q.dtype, hd)
    qp, kp, vp = (F.pad(t, (0, hd_k - hd)) for t in (q, k, v))
    o, out = q.new_empty(q.shape[:3] + (hd_k,)), q.new_empty(q.shape)

    # a null LSE pointer where the kernel takes one (the instance without
    # the LSE store, as inference runs it)
    sig = build.SIGNATURES[name][name]
    no_lse = [None] * (sig.index(ctypes.c_int) - 4)

    def kernel():
        build.launch(name, name, q.device, qp.data_ptr(), kp.data_ptr(),
                     vp.data_ptr(), o.data_ptr(), *no_lse, c.b, c.tq, c.tkv,
                     c.h, c.kvh, hd_k, 1.0 / math.sqrt(hd), int(c.causal),
                     int(c.window))

    return {"kernel_ms": smoke.device_ms(kernel),
            "pads_ms": smoke.device_ms(
                lambda: [F.pad(t, (0, hd_k - hd)) for t in (q, k, v)]),
            "out_copy_ms": smoke.device_ms(
                lambda: out.copy_(o[..., :hd]))}


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
