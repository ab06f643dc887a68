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
device-busy share, device operations and device µs, each kernel's
device, with-launch, plain and bound times, and `seqlock_gather` at each
width of `gather_sweep` (k = 1, 4, 8, 16 at n = 2**22, held to its plain
version at each width, then timed).

`--from DIR` runs the phase of another checkout (`DIR/chip_smoke.py` over
`DIR/src/repro_torch`, e.g. the parent commit unpacked with `git
archive`), its kernels built in its own `build/`; this script's
`gather_sweep` times that checkout's kernel on the same inputs.  Run two
checkouts in turns in one call to compare them on the same card.
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
GATHER_WIDTHS = (1, 4, 8, 16)       # of bench_atomics.py's k sweep


def gather_sweep(cs, smoke, gather, plain):
    """`gather` (a checkout's `seqlock_gather`, with that checkout's
    `chip_smoke` as `cs` and its `Smoke` as `smoke`) at each row width k
    of `GATHER_WIDTHS` on a table of n = 2**22 rows, q = 16384 uniform
    lanes: held to `plain` once, then its device ms (each rep on a fresh copy of
    the table: rows left in L2 by the rep before would halve its time),
    the kernel's own duration in a profiler trace (`trace_us`, without the
    gaps between launches), its ms with the launch, the plain version's
    ms, `index_select` of the same rows, and its bound: the index, each
    distinct row with its meta pair, and the outputs, over 3.35 TB/s.
    Returns {k: row}."""
    torch = smoke.torch
    N, P = cs.N, cs.P
    gen = torch.Generator(device=smoke.dev).manual_seed(4000)
    idx = torch.randint(0, N, (P,), generator=gen, device=smoke.dev,
                        dtype=torch.int32)
    idx64 = idx.to(torch.int64)
    distinct = int(torch.unique(idx).numel())
    rows = {}
    for k in GATHER_WIDTHS:
        data = torch.randint(-2 ** 31, 2 ** 31, (N, k), generator=gen,
                             device=smoke.dev, dtype=torch.int32)
        meta = torch.randint(0, 2 ** 31, (N, 2), generator=gen,
                             device=smoke.dev, dtype=torch.int32)
        meta[:, 1] = torch.rand(N, generator=gen, device=smoke.dev) < 0.05
        smoke.compare("seqlock_gather", gather(data, meta, idx),
                      plain(data, meta, idx))

        def fresh():
            return data.clone(), meta.clone()

        nbytes = P * 4 + distinct * (4 * k + 8) + P * (4 * k + 4)
        rows[k] = {
            "ms": smoke.device_ms(lambda d, m: gather(d, m, idx),
                                  setup=fresh),
            "with_launch_ms": smoke.time_ms(lambda d, m: gather(d, m, idx),
                                            setup=fresh),
            "plain_ms": smoke.time_ms(lambda d, m: plain(d, m, idx), reps=5,
                                      warmup=1, setup=fresh),
            "index_select_ms": smoke.device_ms(
                lambda d, m: d.index_select(0, idx64), setup=fresh),
            "trace_us": smoke.device_busy(
                lambda d, m: (gather(d, m, idx), torch.cuda.synchronize()),
                reps=10, setup=fresh).get("device_us_per_apply"),
            "bytes": nbytes, "bound_ms": nbytes / cs.HBM_BYTES_PER_S * 1e3}
        del data, meta
        torch.cuda.empty_cache()
    return rows


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
    widths = gather_sweep(cs, smoke, tk.seqlock_gather,
                          ref.seqlock_gather_ref)
    print(f"[{opts.tag}] " + json.dumps({
        "entries": {name: {"ms": row["ms"], **{
            k: row.get("profile", {}).get(k) for k in PROFILE_KEYS}}
            for name, row in entries.items()},
        "kernels": {name: {k: row[k] for k in KERNEL_KEYS}
                    for name, row in kernels.items()},
        "seqlock_gather_widths": widths}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
