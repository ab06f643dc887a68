"""Seeded chaos harness: random fault schedules over executor runs.

The zero-undetected-corruptions gate: a chaos run composes a seeded
schedule of scheduling faults (delays) and data-plane faults (bit flips,
torn writes, stale resurrections, checkpoint damage) over an oversubscribed
multi-stream executor with the guard on, then `verify_chaos` replays the
surviving issue history through the sequential oracle
(`runtime.replay.replay_history`) and checks three things:

  1. every result the executor DELIVERED bit-agrees with the oracle's
     replay of the journaled (post-masking) ops: linearizability held
     across every fault;
  2. the live table bit-agrees with the oracle on every NON-quarantined
     cell: corruption never leaked into served state;
  3. every injected bit_flip / torn_write appears in some scrub report's
     detected (or contained, if it hit an already-poisoned cell) set, and
     ends the run repaired or quarantined.  A corruption ERASED by a
     stale_resurrect applied later at the same boundary is exempt: the
     resurrect reloaded the table from the checkpoint.

Everything is a pure function of (seed, strategy): schedules, stream
workloads and the injector's per-fault rngs, all drawn with numpy as the
reference's harness draws them, so a failure replays from the seed alone
and one seed gives the same faults in both packages.

    PYTHONPATH=src python -m repro_torch.guard.chaos --seeds 10 --device cpu
"""

from __future__ import annotations

import os

import numpy as np

from repro_torch import convert
from repro_torch.core import engine
from repro_torch.core.specs import AtomicSpec
from repro_torch.runtime.executor import Executor, LocalTarget
from repro_torch.runtime.faults import Fault, FaultInjector
from repro_torch.runtime.replay import replay_history
from repro_torch.runtime.streams import SyntheticStream

CHAOS_STRATEGIES = ("seqlock", "indirect", "cached_wf", "cached_me")


def random_schedule(rng, *, rounds: int, n_streams: int,
                    data_faults: int = 3, sched_faults: int = 1,
                    ckpt_faults: int = 0) -> list[Fault]:
    """Draw a fault schedule: every choice comes from `rng`, so the
    schedule is a pure function of the caller's seed."""
    faults: list[Fault] = []
    for _ in range(sched_faults):
        faults.append(Fault(
            round=int(rng.integers(1, rounds + 1)), kind="delay",
            stream=int(rng.integers(n_streams)),
            seconds=float(rng.uniform(1e-4, 1e-3)),
            rounds=int(rng.integers(1, 3))))
    # stale resurrections quarantine every dirty cell at once, so keep
    # them rare relative to single-cell corruptions
    kinds = ["bit_flip"] * 5 + ["torn_write"] * 4 + ["stale_resurrect"]
    for _ in range(data_faults):
        faults.append(Fault(
            round=int(rng.integers(1, rounds + 1)),
            kind=kinds[int(rng.integers(len(kinds)))]))
    for _ in range(ckpt_faults):
        faults.append(Fault(
            round=int(rng.integers(1, rounds + 1)),
            kind="ckpt_corrupt" if rng.integers(2) else "ckpt_truncate"))
    return faults


def run_chaos(seed: int, strategy: str, *, n: int = 24, k: int = 2,
              width: int = 6, n_streams: int = 3, n_batches: int = 4,
              data_faults: int = 3, sched_faults: int = 1,
              ckpt_faults: int = 0, checkpoint_every: int = 2,
              scrub_every: int = 1, checkpoint_dir: str | None = None,
              retry_budget: int = 2, initial=None, device="cuda") -> dict:
    """One seeded chaos run with the guard forced on; returns the executor,
    its report, and everything `verify_chaos` needs.  `initial`: the
    table's first words (numpy uint32; default zeros, as the reference)."""
    rng = np.random.default_rng(np.random.SeedSequence(
        [seed, CHAOS_STRATEGIES.index(strategy)
         if strategy in CHAOS_STRATEGIES else 97]))
    spec = AtomicSpec(n, k, strategy, max(16, width))
    streams = [SyntheticStream(f"s{i}", seed=seed * 131 + i, n=n, k=k,
                               width=width, n_batches=n_batches)
               for i in range(n_streams)]
    schedule = random_schedule(rng, rounds=n_batches, n_streams=n_streams,
                               data_faults=data_faults,
                               sched_faults=sched_faults,
                               ckpt_faults=ckpt_faults)
    injector = FaultInjector(schedule, seed=seed)
    prev = os.environ.get("BIGATOMIC_GUARD")
    os.environ["BIGATOMIC_GUARD"] = "on"
    try:
        ex = Executor(LocalTarget(spec, initial, device=device), streams,
                      checkpoint_every=checkpoint_every,
                      checkpoint_dir=checkpoint_dir, injector=injector,
                      scrub_every=scrub_every, retry_budget=retry_budget)
    finally:
        if prev is None:
            os.environ.pop("BIGATOMIC_GUARD", None)
        else:
            os.environ["BIGATOMIC_GUARD"] = prev
    report = ex.run()
    return {"seed": seed, "strategy": strategy, "spec": spec,
            "schedule": schedule, "executor": ex, "report": report,
            "initial": initial}


def verify_chaos(result: dict) -> dict:
    """Replay a chaos run through the sequential oracle; returns the
    verdict dict (see the module docstring for the three checks)."""
    ex, spec = result["executor"], result["spec"]
    widths = [s.width for s in ex.streams]
    # check 1: every delivered result matches the oracle (raises on diff)
    oracle = replay_history(spec.n, spec.k, widths, ex.history,
                            initial=result.get("initial"), check=True)
    poison = ex.scrubber.poison_host
    live_logical = convert.array(engine.logical(spec, ex.target.state),
                                 word=True)
    live_version = convert.array(ex.target.state.version, word=True)
    clean = ~poison
    # check 2: non-quarantined live state bit-agrees with the oracle
    mismatched = np.zeros((spec.n,), bool)
    mismatched[clean] |= (live_logical[clean] != oracle.data[clean]).any(1)
    mismatched[clean] |= live_version[clean] != oracle.version[clean]
    undetected = np.flatnonzero(mismatched).tolist()
    # check 3: every injected single-cell corruption was seen + resolved,
    # except one a later stale_resurrect at the same boundary erased
    by_round = {}
    for rep in ex.scrubber.reports:
        by_round.setdefault(rep.round, []).append(rep)
    last_resurrect = {}              # round -> index of last resurrect
    for idx, (rnd, fault, _info) in enumerate(ex.data_faults):
        if fault.kind == "stale_resurrect":
            last_resurrect[rnd] = idx
    unseen, unresolved, erased = [], [], []
    for idx, (rnd, fault, info) in enumerate(ex.data_faults):
        if fault.kind not in ("bit_flip", "torn_write"):
            continue
        slot = info["slot"]
        reps = by_round.get(rnd, [])
        seen = any(slot in rep.detected or slot in rep.contained
                   for rep in reps)
        resolved = any(slot in rep.repaired or slot in rep.quarantined
                       or slot in rep.contained for rep in reps)
        if not (seen and resolved) and idx < last_resurrect.get(rnd, -1):
            erased.append({"round": rnd, **info})
            continue
        if not seen:
            unseen.append({"round": rnd, **info})
        if not resolved:
            unresolved.append({"round": rnd, **info})
    return {
        "seed": result["seed"], "strategy": result["strategy"],
        "ok": not undetected and not unseen and not unresolved,
        "undetected_corruptions": undetected,
        "undetected_injections": unseen,
        "unresolved_injections": unresolved,
        "erased_injections": erased,
        "injected_data_faults": len(ex.data_faults),
        "quarantined": int(poison.sum()),
        "shed_streams": len(ex.shed),
        "scrub_reports": [rep.to_json() for rep in ex.scrubber.reports],
    }


def main(argv=None) -> int:
    """Seeded chaos sweep: run `--seeds` schedules per strategy, write every
    verdict (with its ScrubReports) as one JSON document, and exit non-zero
    if ANY run had an undetected corruption."""
    import argparse
    import json
    import tempfile

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--strategies", default=",".join(CHAOS_STRATEGIES))
    ap.add_argument("--ckpt-faults", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="benchmarks/results/chaos_reports.json")
    args = ap.parse_args(argv)

    verdicts, bad = [], 0
    for strategy in args.strategies.split(","):
        for seed in range(args.seeds):
            with tempfile.TemporaryDirectory(prefix="chaos_ck_") as ckdir:
                res = run_chaos(seed, strategy, data_faults=2 + seed % 3,
                                sched_faults=seed % 2,
                                ckpt_faults=args.ckpt_faults,
                                checkpoint_dir=ckdir
                                if args.ckpt_faults else None,
                                device=args.device)
                v = verify_chaos(res)
            verdicts.append(v)
            bad += not v["ok"]
            print(f"chaos {strategy:10s} seed={seed:3d} "
                  f"ok={v['ok']} injected={v['injected_data_faults']} "
                  f"quarantined={v['quarantined']}")
    doc = {"runs": len(verdicts), "failed": bad, "verdicts": verdicts}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1, default=float)
        f.write("\n")
    print(f"{len(verdicts)} chaos runs, {bad} failed -> {args.out}")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
