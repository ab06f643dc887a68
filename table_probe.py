#!/usr/bin/env python3
"""The raw-table kernels alone on one NVIDIA card: `chip_smoke.py`'s
table-ops phase without the other phases.

    python3 table_probe.py [--from DIR] [--tag NAME] [--sass]

Run from the root of a checkout on a machine with a CUDA card and `nvcc`.
It builds `kernels/csrc/table_ops.cu` (and `engine_round.cu`, which
`commit_round` launches), copies what `ptxas -v` said of each kernel to
`chiprun_out/<tag>_ptxas.log` (with `--sass`, the library's SASS to
`chiprun_out/<tag>.sass`), then runs the phase as `chip_smoke.py` does
(`TableOps.kernel_vs_plain`, `main_path`, `timing`: every check and gate
of the phase holds) and prints one JSON line: each entry point's ms,
device-busy share, device operations and device µs, and each kernel's
device, with-launch, plain and bound times.

`--from DIR` runs the phase of another checkout (`DIR/chip_smoke.py` over
`DIR/src/repro_torch`, e.g. the parent commit unpacked with `git
archive`), its kernels built in its own `build/`.  Run two checkouts in
turns in one call to compare them on the same card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PROFILE_KEYS = ("device_busy_share", "device_ops_per_apply",
                "device_us_per_apply", "error")
KERNEL_KEYS = ("ms", "with_launch_ms", "plain_ms", "bound_ms", "bytes",
               "written_rows")


def main(argv) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--from", dest="checkout", type=Path, default=ROOT)
    parser.add_argument("--tag", default="table")
    parser.add_argument("--sass", action="store_true")
    opts = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("table_probe: no CUDA device", file=sys.stderr)
        return 2
    checkout = opts.checkout.resolve()
    sys.path[:0] = [str(checkout / "src"), str(checkout)]
    import chip_smoke as cs
    from repro_torch import atomics, convert
    from repro_torch import kernels as tk
    from repro_torch.core import engine
    from repro_torch.kernels import _build, llsc_commit, ops, ref
    from repro_torch.kernels import engine_round as er

    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (checkout / "chiprun_out").mkdir(exist_ok=True)   # its profiler traces
    t0 = time.perf_counter()
    lib = _build.build("table_ops")
    _build.build("engine_round")
    print(f"[{opts.tag}] {cs.card_line()}; built {lib.name} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    (out / f"{opts.tag}_ptxas.log").write_text(
        lib.with_suffix(".log").read_text())
    if opts.sass:
        cuobjdump = Path(_build.nvcc()).with_name("cuobjdump")
        sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                              capture_output=True, text=True, check=True)
        (out / f"{opts.tag}.sass").write_text(sass.stdout)
    smoke = cs.Smoke(torch, atomics, engine, er, convert, tk)
    table = cs.TableOps(smoke, tk, ops, llsc_commit, ref)
    cases = table.kernel_vs_plain()
    counts, _, op = table.main_path(atomics, engine, convert)
    print(f"[{opts.tag}] {cases} kernel-vs-plain cases equal; path launches "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    entries, kernels = table.timing(op)
    print(f"[{opts.tag}] " + json.dumps({
        "entries": {name: {"ms": row["ms"], **{
            k: row.get("profile", {}).get(k) for k in PROFILE_KEYS}}
            for name, row in entries.items()},
        "kernels": {name: {k: row[k] for k in KERNEL_KEYS}
                    for name, row in kernels.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
