#!/usr/bin/env python3
"""What phase 13 of `chip_smoke.py` reads on a sound decode and on a
decode with a fault planted, on one NVIDIA card: the evidence that its
bf16 bounds (`FAMILY_TOL`'s row term, `ROUTE_NOISE`) lie between the two.

    python3 families_probe.py [CASE ...]

Run from the root of a checkout on a machine with a CUDA card and `nvcc`.
Each case of `chip_smoke.FAMILY_CASES` (all, or those named) is drawn and
served exactly as phase 13 draws and serves it (same seed, prompt and
greedy tokens); then its decode is replayed, teacher-forced with those
tokens, once sound and once for each fault that applies, and each replay
is held to `forward(mode="train")` by phase 13's own check.  The faults:

  stale_state   the recurrent blocks' decode does not write back the SSM
                state (`state`) or the RG-LRU state (`h`): a step starts
                from the prefill's state, the conv windows still advance
  stale_all     neither those nor the conv windows are written back
  wrong_expert  at the one decode (step, layer, token) whose k-th and
                (k+1)-th router probabilities are nearest
                `WRONG_EXPERT_GAP` apart, the (k+1)-th expert replaces the
                k-th

For each replay: the row factor the position needing most would need to
pass (`row_reading`), the router's noise and the gaps where experts moved
(MoE), the largest error, and what the check said.  The exit code is 1 if
a sound replay fails the check, or a fault passes it in every case of its
config (a bf16 case and its fp32 twin: phase 13 runs both).  Details go
to `chiprun_out/families_probe.json`.
"""

from __future__ import annotations

import contextlib
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WRONG_EXPERT_GAP = 0.02


@contextlib.contextmanager
def stale(ssm, rglru, keys):
    """The recurrent blocks' decode writes none of `keys` back into the
    cache (each runs on a private copy of those entries)."""
    saved = ssm.ssm_block, rglru.rglru_block

    def private(block):
        def run(x, params, cfg, *, cache=None):
            if cache is None:
                return block(x, params, cfg)
            mine = {k: v.clone() if k in keys else v
                    for k, v in cache.items()}
            y, _ = block(x, params, cfg, cache=mine)
            return y, cache
        return run
    ssm.ssm_block, rglru.rglru_block = (private(b) for b in saved)
    try:
        yield
    finally:
        ssm.ssm_block, rglru.rglru_block = saved


@contextlib.contextmanager
def wrong_expert(moe, call, token):
    """At `moe.top_k`'s `call`-th call from here (counted from 0), token
    row `token` takes its (k+1)-th expert in place of its k-th."""
    top_k, seen = moe.top_k, [0]

    def faulty(probs, k):
        vals, idx = top_k(probs, k)
        if seen[0] == call:                 # probs: [G, Tg, E]
            g, t = divmod(token, probs.shape[1])
            v1, i1 = top_k(probs, k + 1)
            vals, idx = vals.clone(), idx.clone()
            vals[g, t, k - 1], idx[g, t, k - 1] = v1[g, t, k], i1[g, t, k]
        seen[0] += 1
        return vals, idx
    moe.top_k = faulty
    try:
        yield
    finally:
        moe.top_k = top_k


def nearest_gap(torch, routes, layers, k, gap):
    """(call, token, gap): among the decode's routing calls (the log's
    entries after the prefill's, one a MoE layer), the token whose k-th
    and (k+1)-th probabilities are nearest `gap` apart."""
    best = None
    for call, (_, probs) in enumerate(routes):
        if call < layers:
            continue
        top = torch.sort(probs, -1, descending=True).values
        d = (top[:, k - 1] - top[:, k]).tolist()
        for token, g in enumerate(d):
            if best is None or abs(g - gap) < abs(best[2] - gap):
                best = (call, token, g)
    return best


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("families_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch import atomics, configs, convert
    from repro_torch import kernels as tk
    from repro_torch.core import engine
    from repro_torch.kernels import _build
    from repro_torch.kernels import engine_round as er
    from repro_torch.launch import steps
    from repro_torch.models import common, moe, rglru, ssm, transformer

    print(cs.card_line(), flush=True)
    libs = [n for n in _build.SIGNATURES if n.startswith("flash_attention")]
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(_build.build, libs))
    smoke = cs.Smoke(torch, atomics, engine, er, convert, tk)
    fp = cs.FamiliesPhase(smoke, (configs, transformer, steps, moe, ssm,
                                  common))
    said = []
    fp.fail = said.append                 # record what the check says
    names = argv or list(cs.FAMILY_CASES)
    out = []
    for name in names:
        case = cs.FAMILY_CASES[name]
        seed = cs.FAMILY_SEED + 10 * list(cs.FAMILY_CASES).index(name)
        cfg = fp.config(case)
        tol = cs.FAMILY_TOL[case.dtype]
        params = transformer.init_params(cfg, seed=seed, device=fp.dev)
        prompt = fp.prompt(cfg, case, seed)
        tokens = fp.served_run(cfg, params, prompt)["tokens"]
        runs = [("sound", contextlib.nullcontext)]
        if set(cfg.layer_kinds) & {"ssm", "rglru"}:
            runs.append(("stale_state",
                         lambda: stale(ssm, rglru, ("state", "h"))))
            runs.append(("stale_all", lambda: stale(ssm, rglru, (
                "state", "h", "conv", "conv_x", "conv_B", "conv_C"))))
        for run, fault in runs:
            said.clear()
            with fault():
                cfg_c, rows, routes = fp.decode_rows(cfg, params, prompt,
                                                     tokens)
            check = fp.consistency(cfg_c, params, prompt, tokens, rows, tol,
                                   name, routes)
            if run == "sound" and cfg.is_moe:
                at = nearest_gap(torch, routes,
                                 len(routes) // (cs.FAMILY_STEPS + 1),
                                 cfg.top_k, WRONG_EXPERT_GAP)
                runs.append(("wrong_expert",
                             lambda: wrong_expert(moe, at[0], at[1])))
            row = {"case": name, "run": run, "caught": list(said),
                   **{k: check.get(k) for k in (
                       "row_reading", "row_reading_moved", "max_abs_err",
                       "logits_rms", "router_noise", "moved_gaps",
                       "first_moved_layer", "positions_compared")}}
            if run == "wrong_expert":
                row["planted"] = dict(zip(("call", "token", "gap"), at))
            out.append(row)
            print(json.dumps(row), flush=True)
            del rows, routes
        del params
        torch.cuda.empty_cache()
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "families_probe.json").write_text(
        json.dumps(out, indent=1))
    failed = [r["case"] for r in out if r["run"] == "sound" and r["caught"]]
    faults = [r for r in out if r["run"] != "sound"]

    def config_run(r):
        return cs.FAMILY_CASES[r["case"]].arch, r["run"]
    missed = sorted({config_run(r) for r in faults}
                    - {config_run(r) for r in faults if r["caught"]})
    print(f"families_probe: {len(out)} replays; sound ones failed: "
          f"{failed}; faults no case of their config caught: {missed}",
          flush=True)
    return 1 if failed or missed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
