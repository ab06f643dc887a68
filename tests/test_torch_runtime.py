"""The port's execution layer (`repro_torch.runtime`: the oversubscribed
`Executor` over `LocalTarget`, the streams, `FaultInjector`, the straggler
watchdog, the preemption guard, the history replay;
`repro_torch.checkpoint.disk`; `repro_torch.guard.chaos` and the
`BIGATOMIC_GUARD` gate) against the JAX reference, on the CPU.

Each scenario below is written once against a small adapter (`_Pkg`) and
run twice: in this process on the port, and in ONE subprocess (with the jax
alias the reference's Pallas modules need) on the reference.  The
scenarios are the executor cases of tests/test_runtime.py and the guard
cases of tests/test_guard.py that need the executor, at their sizes (n =
16-32, k = 2, width 4-8).  Every value a scenario returns must be equal:
each issue's ops, delivered values and successes, the executor's report
without its wall-time fields (`latency_s`), the fired faults, the scrub
reports, the final table and versions, restored checkpoints.  Every
scenario runs with the same tick clock in its Recorder, so issue
latencies, and what the watchdog does with them, are the same in both.

Checkpoints cross the packages: the port writes an executor checkpoint
and a state with every dtype (bfloat16 included) before the subprocess
starts; the subprocess restores them through the reference and writes its
own, which this process restores through the port; both executors'
manifests (keys, files, CRCs, meta) must be equal.  In process: the
port's `replay_history` against `tests/oracle.replay_executor_history` on
the scenarios' histories, the issue path with every tensor-to-host read
patched to raise (guard off and on), the guard off building nothing and
launching nothing more, and the gate's validation.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
STRATEGIES = ("seqlock", "indirect", "cached_wf", "cached_me")
CHAOS_SEEDS = (0, 1, 2)


class _TickClock:
    """Stand-in for perf_counter: every call advances 1 ms, so each issue
    measures exactly one tick and injected delays dominate."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.001
        return self.t


class _Pkg:
    """One package's entry points, as the scenarios call them."""

    def __init__(self, which: str):
        self.which = which
        if which == "ref":
            from repro import atomics, guard
            from repro.checkpoint import disk
            from repro.core import engine
            from repro.guard import chaos
            from repro.obs import Recorder
            from repro.runtime import (Executor, Fault, FaultInjector,
                                       LocalTarget, McasStream,
                                       PreemptionGuard, StragglerWatchdog,
                                       SyntheticStream)
            from repro.sync.queue import BackoffPolicy
            self.LocalTarget = LocalTarget
            self.run_chaos = chaos.run_chaos
            self.make_txns = atomics.make_txns
            self.ck_template = lambda ex: ex._ck_payload()
        else:
            from repro_torch import atomics, guard
            from repro_torch.checkpoint import disk
            from repro_torch.core import engine
            from repro_torch.guard import chaos
            from repro_torch.obs import Recorder
            from repro_torch.runtime import (Executor, Fault, FaultInjector,
                                             LocalTarget, McasStream,
                                             PreemptionGuard,
                                             StragglerWatchdog,
                                             SyntheticStream)
            from repro_torch.sync.queue import BackoffPolicy
            self.LocalTarget = functools.partial(LocalTarget, device="cpu")
            self.run_chaos = functools.partial(chaos.run_chaos,
                                               device="cpu")
            self.make_txns = functools.partial(atomics.make_txns,
                                               device="cpu")
            self.ck_template = lambda ex: ex._ck_template()
        self.atomics, self.guard, self.disk, self.engine = (atomics, guard,
                                                            disk, engine)
        self.chaos, self.Recorder, self.Executor = chaos, Recorder, Executor
        self.Fault, self.FaultInjector = Fault, FaultInjector
        self.McasStream, self.PreemptionGuard = McasStream, PreemptionGuard
        self.StragglerWatchdog = StragglerWatchdog
        self.SyntheticStream, self.BackoffPolicy = (SyntheticStream,
                                                    BackoffPolicy)

    def spec(self, n, k, strategy, p_max):
        return self.atomics.AtomicSpec(n, k, strategy, p_max)

    def executor(self, target, streams, **kw):
        kw.setdefault("recorder", self.Recorder(trace=False,
                                                clock=_TickClock()))
        return self.Executor(target, streams, **kw)

    def table(self, target) -> dict:
        return {"logical": words(self.engine.logical(target.spec,
                                                     target.state)),
                "versions": words(target.state.version)}


def words(x) -> list:
    """Words (uint32 numpy, int32 tensors, jax arrays) as uint32 lists."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x)
    if x.dtype in (np.int32, np.uint32):
        x = x.view(np.uint32)
    return x.tolist()


def history(ex) -> list:
    return [[r.stream, r.seq, *(words(x) for x in r.ops),
             words(r.value), np.asarray(r.success, bool).tolist()]
            for r in ex.history]


def report(rep: dict) -> dict:
    """An executor report without its wall-time fields."""
    rep = json.loads(json.dumps(rep, default=float))
    for rec in rep["recoveries"]:
        del rec["latency_s"]
    for scrub in rep["scrubs"]:
        del scrub["latency_s"]
    return rep


def synth(P, n_streams, *, n, k, width, n_batches, seed0=50):
    return [P.SyntheticStream(f"s{i}", seed=seed0 + i, n=n, k=k,
                              width=width, n_batches=n_batches, hot_cells=3,
                              hot_frac=0.25)
            for i in range(n_streams)]


def with_guard(mode):
    """Run a scenario with BIGATOMIC_GUARD set (None: unset)."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(P, *args):
            prev = os.environ.get("BIGATOMIC_GUARD")
            if mode is None:
                os.environ.pop("BIGATOMIC_GUARD", None)
            else:
                os.environ["BIGATOMIC_GUARD"] = mode
            try:
                return fn(P, *args)
            finally:
                if prev is None:
                    os.environ.pop("BIGATOMIC_GUARD", None)
                else:
                    os.environ["BIGATOMIC_GUARD"] = prev
        return run
    return wrap


# ---------------------------------------------------------------------------
# Scenarios: tests/test_runtime.py
# ---------------------------------------------------------------------------

@with_guard(None)
def scenario_oversubscribed(P, tmp):
    """test_executor_oversubscribed_local_matches_oracle."""
    n, k, width = 24, 2, 8
    init = np.random.default_rng(0).integers(0, 2 ** 32, (n, k),
                                             dtype=np.uint32)
    target = P.LocalTarget(P.spec(n, k, "seqlock", 64), init)
    ex = P.executor(target, synth(P, 3, n=n, k=k, width=width, n_batches=5),
                    slots=1, oversubscription=4)
    rep = ex.run()
    return {"report": report(rep), "budget": ex.budget,
            "history": history(ex), "table": P.table(target)}


@with_guard(None)
def scenario_preempt_resume(P, tmp):
    """test_executor_preempt_checkpoint_resume; its checkpoint directory
    is kept for the other package to resume from."""
    n, k, width = 24, 2, 8
    spec = P.spec(n, k, "seqlock", 64)
    init = np.random.default_rng(1).integers(0, 2 ** 32, (n, k),
                                             dtype=np.uint32)
    ref = P.LocalTarget(spec, init)
    P.executor(ref, synth(P, 2, n=n, k=k, width=width, n_batches=6)).run()
    d = os.path.join(tmp, f"preempt_{P.which}")
    t1 = P.LocalTarget(spec, init)
    ex1 = P.executor(t1, synth(P, 2, n=n, k=k, width=width, n_batches=6),
                     injector=P.FaultInjector([P.Fault(round=3,
                                                       kind="preempt")]),
                     checkpoint_dir=d)
    rep1 = ex1.run()
    t2 = P.LocalTarget(spec, init)
    ex2 = P.executor(t2, synth(P, 2, n=n, k=k, width=width, n_batches=6),
                     checkpoint_dir=d)
    resumed = ex2.resume()
    rep2 = ex2.run()
    with open(os.path.join(d, f"step_{P.disk.latest_step(d):08d}",
                           "manifest.json")) as f:
        manifest = json.load(f)
    return {"uninterrupted": P.table(ref), "report1": report(rep1),
            "history1": history(ex1), "steps": P.disk.list_steps(d),
            "resumed_round": resumed, "report2": report(rep2),
            "history2": history(ex2), "table": P.table(t2),
            "manifest": manifest}


@with_guard(None)
def scenario_watchdog(P, tmp):
    """test_executor_watchdog_deprioritizes_delayed_stream."""
    n, k, width = 24, 2, 8
    target = P.LocalTarget(P.spec(n, k, "seqlock", 64))
    streams = synth(P, 3, n=n, k=k, width=width, n_batches=8)
    ex = P.executor(
        target, streams, slots=1, oversubscription=4,
        watchdog=P.StragglerWatchdog(n_hosts=3, threshold=1.5, patience=2),
        injector=P.FaultInjector([P.Fault(round=1, kind="delay", stream=1,
                                          seconds=0.05, rounds=4)]))
    rep = ex.run()
    assert rep["deprioritized"] > 0 and all(s.done() for s in streams)
    return {"report": report(rep), "flags": ex.recorder.flags,
            "history": history(ex), "table": P.table(target)}


@with_guard(None)
def scenario_straggler_patience(P, tmp):
    """test_straggler_flagged_after_exactly_patience_rounds."""
    n, k, width, patience = 24, 2, 8, 3
    target = P.LocalTarget(P.spec(n, k, "seqlock", 64))
    ex = P.executor(
        target, synth(P, 4, n=n, k=k, width=width, n_batches=10),
        slots=1, oversubscription=4,
        watchdog=P.StragglerWatchdog(n_hosts=4, threshold=1.5,
                                     patience=patience),
        injector=P.FaultInjector([P.Fault(round=1, kind="delay", stream=2,
                                          seconds=0.05, rounds=10)]))
    ex.run()
    assert ex.recorder.flags[0] == (patience, [2])
    return {"flags": ex.recorder.flags, "metrics": ex.recorder.metrics(),
            "history": history(ex), "table": P.table(target)}


@with_guard(None)
def scenario_mcas_stream(P, tmp):
    """test_mcas_stream_yields_between_rounds."""
    n, k, width, t, w = 32, 2, 8, 4, 2
    spec = P.spec(n, k, "seqlock", 64)
    rng = np.random.default_rng(2)
    init = rng.integers(0, 2 ** 32, (n, k), dtype=np.uint32)
    target = P.LocalTarget(spec, init)
    slots = rng.permutation(16)[: t * w].reshape(t, w).astype(np.int32)
    desired = rng.integers(0, 2 ** 32, (t, w, k), dtype=np.uint32)
    txns = P.make_txns(slots, init[slots], desired, k=k)
    ops_stream = P.SyntheticStream("ops", seed=9, n=n, k=k, width=width,
                                   n_batches=4, slot_lo=16, slot_hi=32)
    mc = P.McasStream("mcas", txns)
    ex = P.executor(target, [ops_stream, mc], slots=1, oversubscription=2)
    rep = ex.run()
    res = mc.result()
    got = P.table(target)
    assert np.asarray(words(res.success), bool).all()
    assert np.array_equal(np.asarray(got["logical"])[slots.ravel()],
                          desired.reshape(-1, k))
    return {"report": report(rep), "rounds_run": mc.rounds_run,
            "success": words(res.success), "witness": words(res.witness),
            "history": history(ex), "table": got}


# ---------------------------------------------------------------------------
# Scenarios: tests/test_guard.py
# ---------------------------------------------------------------------------

def chaos_run(P, res):
    ex = res["executor"]
    verdict = P.chaos.verify_chaos(res)
    for scrub in verdict["scrub_reports"]:
        del scrub["latency_s"]
    assert verdict["ok"], verdict
    return {"verdict": verdict, "report": report(res["report"]),
            "schedule": [dataclasses.asdict(f) for f in res["schedule"]],
            "history": history(ex), "table": P.table(ex.target)}


def scenario_chaos(P, tmp, strategy):
    """test_chaos_zero_undetected_corruptions, seeds `CHAOS_SEEDS`."""
    return {str(seed): chaos_run(P, P.run_chaos(
        seed, strategy, data_faults=2 + seed % 3, sched_faults=seed % 2,
        n_batches=3 + seed % 2, width=5))
        for seed in CHAOS_SEEDS}


def scenario_chaos_ckpt_damage(P, tmp):
    """test_chaos_with_checkpoint_damage."""
    d = os.path.join(tmp, f"chaos_{P.which}")
    res = P.run_chaos(5, "seqlock", ckpt_faults=2, data_faults=1,
                      checkpoint_dir=d)
    out = chaos_run(P, res)
    damaged = [info for _r, f, info in res["executor"].data_faults
               if f.kind in ("ckpt_corrupt", "ckpt_truncate")]
    assert damaged
    state, meta, step = P.disk.restore_latest(
        d, P.ck_template(res["executor"]))
    assert not P.disk.verify_checkpoint(d, damaged[0]["step"]) \
        or step >= damaged[0]["step"]
    out.update(damaged=damaged, restored_step=step, meta=meta,
               restored={key: words(v) for key, v in state["table"].items()})
    return out


@with_guard("on")
def scenario_poisoned_shed(P, tmp):
    """test_poisoned_cells_fail_ops_and_streams_shed."""
    n, k, width = 16, 2, 4
    spec = P.spec(n, k, "seqlock", 16)
    victims = [P.SyntheticStream(f"s{i}", seed=500 + i, n=n, k=k,
                                 width=width, n_batches=8, slot_lo=0,
                                 slot_hi=4) for i in range(4)]
    healthy = P.SyntheticStream("healthy", seed=555, n=n, k=k, width=width,
                                n_batches=8, slot_lo=4)
    faults = [P.Fault(round=2, kind="bit_flip", slot=s, field="data")
              for s in range(4)]
    ex = P.executor(P.LocalTarget(spec), victims + [healthy],
                    injector=P.FaultInjector(faults, seed=3),
                    checkpoint_every=0, retry_budget=1,
                    backoff=P.BackoffPolicy("none"))
    rep = ex.run()
    assert rep["poisoned"] == 4 and rep["events"]["exec.shed"] == 4
    assert sorted(s["stream"] for s in rep["shed"]) == [0, 1, 2, 3]
    assert healthy.done() and not victims[0].done()
    return {"report": report(rep), "history": history(ex),
            "table": P.table(ex.target)}


@with_guard(None)
def scenario_issue_raises(P, tmp):
    """test_issue_exception_retries_then_sheds."""
    target = P.LocalTarget(P.spec(8, 2, "seqlock", 8))
    boom = {"left": 100}
    real_issue = target.issue

    def flaky_issue(ops, ctx, *, donate=True):
        if boom["left"] > 0:
            boom["left"] -= 1
            raise RuntimeError("injected issue failure")
        return real_issue(ops, ctx, donate=donate)

    target.issue = flaky_issue
    s = P.SyntheticStream("s0", seed=1, n=8, k=2, width=4, n_batches=3)
    ex = P.executor(target, [s], retry_budget=2,
                    backoff=P.BackoffPolicy("none"))
    rep = ex.run()
    assert rep["shed"][0]["reason"] == "issue raised"
    assert rep["shed"][0]["attempts"] == 3 and not s.done()
    return {"report": report(rep), "left": boom["left"]}


@with_guard(None)
def scenario_resume_skips_damaged(P, tmp):
    """test_executor_resume_skips_damaged_newest."""
    n, k, width = 16, 2, 4
    d = os.path.join(tmp, f"damaged_{P.which}")

    def mk(ckdir=None):
        streams = [P.SyntheticStream("s0", seed=77, n=n, k=k, width=width,
                                     n_batches=6)]
        return P.executor(P.LocalTarget(P.spec(n, k, "seqlock", 16)),
                          streams, checkpoint_dir=ckdir, checkpoint_every=2)

    ex1 = mk(d)
    ex1.run()
    want = P.table(ex1.target)
    steps = P.disk.list_steps(d)
    newest = os.path.join(d, f"step_{steps[-1]:08d}")
    victim = os.path.join(newest, sorted(f for f in os.listdir(newest)
                                         if f.endswith(".npy"))[0])
    with open(victim, "rb") as f:
        head = f.read(8)
    with open(victim, "wb") as f:
        f.write(head)
    assert not P.disk.verify_checkpoint(d, steps[-1])
    ex2 = mk()
    resumed = ex2.resume(d)
    assert resumed == steps[-2]
    rep = ex2.run()
    assert P.table(ex2.target) == want
    return {"steps": steps, "resumed": resumed, "report": report(rep),
            "table": want, "history": history(ex2)}


def scenario_disk_fallback(P, tmp):
    """test_restore_latest_falls_back_past_damage and
    test_restore_latest_no_verifying_step, on numpy states."""
    d = os.path.join(tmp, f"fallback_{P.which}")
    state = {"x": np.arange(16, dtype=np.uint32)}
    for step, add in ((1, 0), (2, 100), (3, 200)):
        P.disk.save_checkpoint(d, step, {"x": state["x"] + add})
    leaf3 = os.path.join(d, "step_00000003", "x.npy")
    raw = bytearray(open(leaf3, "rb").read())
    raw[-1] ^= 0xFF
    open(leaf3, "wb").write(bytes(raw))
    leaf2 = os.path.join(d, "step_00000002", "x.npy")
    data = open(leaf2, "rb").read()
    open(leaf2, "wb").write(data[: len(data) // 2])
    verified = [P.disk.verify_checkpoint(d, s) for s in (1, 2, 3)]
    restored, _meta, step = P.disk.restore_latest(d, state)
    try:
        P.disk.restore_checkpoint(d, 3, state, verify=True)
        damaged_raises = False
    except P.disk.CheckpointError:
        damaged_raises = True
    empty = os.path.join(tmp, f"empty_{P.which}")
    try:
        P.disk.restore_latest(empty, state)
        outcome = "restored"
    except FileNotFoundError:
        outcome = "no steps"
    P.disk.save_checkpoint(empty, 1, state)
    open(os.path.join(empty, "step_00000001", "x.npy"), "wb").close()
    try:
        P.disk.restore_latest(empty, state)
        outcome2 = "restored"
    except P.disk.CheckpointError:
        outcome2 = "none verifies"
    return {"verified": verified, "step": step,
            "restored": words(restored["x"]),
            "damaged_raises": damaged_raises, "outcomes": [outcome,
                                                          outcome2]}


SCENARIOS = {
    "oversubscribed": (scenario_oversubscribed, ()),
    "preempt_resume": (scenario_preempt_resume, ()),
    "watchdog": (scenario_watchdog, ()),
    "straggler_patience": (scenario_straggler_patience, ()),
    "mcas_stream": (scenario_mcas_stream, ()),
    **{f"chaos_{s}": (scenario_chaos, (s,)) for s in STRATEGIES},
    "chaos_ckpt_damage": (scenario_chaos_ckpt_damage, ()),
    "poisoned_shed": (scenario_poisoned_shed, ()),
    "issue_raises": (scenario_issue_raises, ()),
    "resume_skips_damaged": (scenario_resume_skips_damaged, ()),
    "disk_fallback": (scenario_disk_fallback, ()),
}


# ---------------------------------------------------------------------------
# Checkpoints across the packages.
# ---------------------------------------------------------------------------

DTYPES_STATE = {"f32": np.linspace(0, 1, 12, dtype=np.float32).reshape(3, 4),
                "u32": np.arange(8, dtype=np.uint32) * 0x9E3779B1,
                "bf16": np.arange(6, dtype=np.float32) * 1.5 - 2,
                "b": np.array([True, False])}


def dtypes_state(which: str) -> dict:
    """DTYPES_STATE as each package holds it: bfloat16 as
    `ml_dtypes.bfloat16` numpy for the reference, tensors for the port."""
    if which == "ref":
        import ml_dtypes
        return {**DTYPES_STATE,
                "bf16": DTYPES_STATE["bf16"].astype(ml_dtypes.bfloat16)}
    return {"f32": torch.from_numpy(DTYPES_STATE["f32"]),
            "u32": torch.from_numpy(DTYPES_STATE["u32"]),
            "bf16": torch.from_numpy(DTYPES_STATE["bf16"]).bfloat16(),
            "b": torch.from_numpy(DTYPES_STATE["b"])}


def leaf_bytes(x) -> list:
    """A restored leaf's raw bytes (tensor or array)."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        x = x.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[
            x.element_size()]).numpy()
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8).tolist()


def cross_restore(P, ck_dirs: dict) -> dict:
    """Restore the other package's checkpoints: its every-dtype state
    (bytes of each leaf), and its preempted executor's, through `resume`
    and a run to the end (the final table)."""
    out = {}
    d = ck_dirs["dtypes"]
    template = dtypes_state(P.which)
    back, _meta = P.disk.restore_checkpoint(d, 3, template, verify=True)
    out["dtypes"] = {key: leaf_bytes(back[key]) for key in sorted(back)}
    n, k, width = 24, 2, 8
    spec = P.spec(n, k, "seqlock", 64)
    init = np.random.default_rng(1).integers(0, 2 ** 32, (n, k),
                                             dtype=np.uint32)
    prev = os.environ.pop("BIGATOMIC_GUARD", None)
    try:
        ex = P.executor(P.LocalTarget(spec, init),
                        synth(P, 2, n=n, k=k, width=width, n_batches=6))
        out["resumed_round"] = ex.resume(ck_dirs["executor"])
        ex.run()
    finally:
        if prev is not None:
            os.environ["BIGATOMIC_GUARD"] = prev
    out["table"] = P.table(ex.target)
    return out


def write_dtypes(P, d):
    P.disk.save_checkpoint(d, 3, dtypes_state(P.which), meta={"at": 3})
    with open(os.path.join(d, "step_00000003", "manifest.json")) as f:
        return json.load(f)


def run_reference(tmp: str, port_dirs: dict) -> dict:
    """Every scenario on the reference, then its restores of the port's
    checkpoints and its own every-dtype checkpoint."""
    P = _Pkg("ref")
    out = {name: fn(P, tmp, *args) for name, (fn, args) in SCENARIOS.items()}
    out["dtypes_manifest"] = write_dtypes(P, os.path.join(tmp, "dtypes_ref"))
    out["cross"] = cross_restore(P, port_dirs)
    return out


_REFERENCE_SCRIPT = textwrap.dedent("""
    import json, sys
    from jax.experimental.pallas import tpu as pltpu
    if not hasattr(pltpu, "TPUMemorySpace"):   # renamed in newer jax
        pltpu.TPUMemorySpace = pltpu.MemorySpace
    import test_torch_runtime
    out = test_torch_runtime.run_reference(sys.argv[1],
                                           json.loads(sys.argv[2]))
    print(json.dumps(out, default=float))
""")


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(port results, reference results, tmp dir).  The port's cross-
    package checkpoints are written first, for the subprocess to read."""
    tmp = str(tmp_path_factory.mktemp("runtime"))
    P = _Pkg("port")
    port = {"dtypes_manifest": write_dtypes(P, os.path.join(tmp,
                                                            "dtypes_port")),
            "preempt_resume": scenario_preempt_resume(P, tmp)}
    port_dirs = {"dtypes": os.path.join(tmp, "dtypes_port"),
                 "executor": os.path.join(tmp, "preempt_port")}
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT / 'tests'}")
    env.pop("BIGATOMIC_GUARD", None)
    env.pop("BIGATOMIC_OBS", None)
    proc = subprocess.run([sys.executable, "-c", _REFERENCE_SCRIPT, tmp,
                           json.dumps(port_dirs)], env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = json.loads(proc.stdout.strip().splitlines()[-1])
    return port, ref, tmp


def jsonable(x):
    return json.loads(json.dumps(x, default=float))


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_reference(name, both, monkeypatch):
    monkeypatch.delenv("BIGATOMIC_OBS", raising=False)
    port, ref, tmp = both
    fn, args = SCENARIOS[name]
    got = port.get(name)
    if got is None:
        got = fn(_Pkg("port"), tmp, *args)
    got, want = jsonable(got), ref[name]
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key] == want[key], f"{name}: {key}"


def test_checkpoints_cross_the_packages(both):
    """A checkpoint written by either package restores through the other:
    the every-dtype state leaf by leaf (bytes), the preempted executor's
    by `resume` and a run to the end (the uninterrupted table); the two
    executors' manifests and the two every-dtype manifests are equal
    (keys, files, dtypes, shapes, CRCs, meta)."""
    port, ref, tmp = both
    assert port["preempt_resume"]["manifest"] == \
        ref["preempt_resume"]["manifest"]
    assert jsonable(port["dtypes_manifest"]) == ref["dtypes_manifest"]
    want_bytes = {key: leaf_bytes(v) for key, v in
                  sorted(dtypes_state("port").items())}
    assert ref["cross"]["dtypes"] == want_bytes          # port -> reference
    mine = cross_restore(_Pkg("port"), {
        "dtypes": os.path.join(tmp, "dtypes_ref"),
        "executor": os.path.join(tmp, "preempt_ref")})
    assert mine["dtypes"] == want_bytes                  # reference -> port
    uninterrupted = port["preempt_resume"]["uninterrupted"]
    for got in (mine, ref["cross"]):
        assert got["resumed_round"] == \
            port["preempt_resume"]["resumed_round"]
        assert got["table"] == uninterrupted
    manifest = port["dtypes_manifest"]["leaves"]
    assert manifest["bf16"]["dtype"] == "bfloat16"
    assert manifest["u32"]["crc32"] == zlib.crc32(
        DTYPES_STATE["u32"].tobytes())


def test_checkpoint_crc_roundtrip_all_dtypes(tmp_path):
    """test_checkpoint_crc_roundtrip_all_dtypes on the port's tensors: each
    leaf comes back with its dtype and bits, on the CPU or as a tensor
    from a numpy template (`device=`, words as int32 bits)."""
    from repro_torch.checkpoint import disk
    state = dtypes_state("port")
    disk.save_checkpoint(str(tmp_path), 3, state)
    assert disk.verify_checkpoint(str(tmp_path), 3)
    back, _ = disk.restore_checkpoint(str(tmp_path), 3, state, verify=True)
    for key, want in state.items():
        assert back[key].dtype == want.dtype, key
        assert leaf_bytes(back[key]) == leaf_bytes(want), key
    back, _ = disk.restore_checkpoint(str(tmp_path), 3,
                                      {"u32": DTYPES_STATE["u32"]},
                                      device="cpu")
    assert back["u32"].dtype == torch.int32
    assert leaf_bytes(back["u32"]) == leaf_bytes(DTYPES_STATE["u32"])


# ---------------------------------------------------------------------------
# In process: the history replay, the issue path's host reads, the gate.
# ---------------------------------------------------------------------------

def _histories():
    """Port executor runs whose histories the replays compare: the
    oversubscribed run, a poisoned run (masked lanes) and a chaos run."""
    P = _Pkg("port")
    out = []
    init = np.random.default_rng(0).integers(0, 2 ** 32, (24, 2),
                                             dtype=np.uint32)
    target = P.LocalTarget(P.spec(24, 2, "cached_wf", 64), init)
    ex = P.executor(target, synth(P, 3, n=24, k=2, width=8, n_batches=6),
                    slots=1, oversubscription=4)
    ex.run()
    out.append((24, 2, [8] * 3, ex, init))
    res = P.run_chaos(3, "indirect", data_faults=3, sched_faults=1,
                      width=5)
    out.append((24, 2, [5] * 3, res["executor"], None))
    return out


def test_replay_history_matches_the_reference_oracle():
    """`runtime.replay_history` equals `tests/oracle.replay_executor_history`
    on the same histories (final table, versions; both check every
    delivered result), and both catch a flipped delivered bit."""
    from oracle import replay_executor_history

    from repro_torch import convert
    from repro_torch.core import engine
    from repro_torch.runtime import replay_history
    for n, k, widths, ex, init in _histories():
        mine = replay_history(n, k, widths, ex.history, initial=init)
        theirs = replay_executor_history(n, k, widths, ex.history,
                                         initial=init)
        np.testing.assert_array_equal(mine.data, theirs.data)
        np.testing.assert_array_equal(mine.version, theirs.version)
        if ex.scrubber is None:
            np.testing.assert_array_equal(mine.data, convert.array(
                engine.logical(ex.target.spec, ex.target.state), word=True))
        bad = ex.history[-1]
        bad.value = bad.value.copy()
        bad.value[0, 0] ^= 1
        with pytest.raises(AssertionError):
            replay_history(n, k, widths, ex.history, initial=init)
        with pytest.raises(AssertionError):
            replay_executor_history(n, k, widths, ex.history, initial=init)


HOST_READS = ("__bool__", "__int__", "__index__", "__float__", "item",
              "tolist", "numpy", "cpu")


def _in_plain_replay() -> bool:
    """True under `slow_round_plain`: the slow round's plain version reads
    its round count back, where its CUDA kernel reads nothing."""
    frame = sys._getframe(2)
    while frame is not None:
        if frame.f_code.co_name == "slow_round_plain":
            return True
        frame = frame.f_back
    return False


@pytest.mark.parametrize("guard", ["off", "on"])
def test_issue_path_reads_nothing_back(guard, monkeypatch):
    """Every `Executor._issue` of ops streams, with every way a tensor
    reaches the host patched to raise (but the plain slow round's own
    read): the host ops are kind-checked, masked (guard on, with
    quarantined cells) and uploaded without a read, the round reads
    nothing back, and the results stay on the device until retirement.
    The run still equals the replay."""
    from repro_torch.runtime import Executor, replay_history
    P = _Pkg("port")
    monkeypatch.setenv("BIGATOMIC_GUARD", guard)
    n, k, width = 24, 2, 8
    faults = [P.Fault(round=1, kind="bit_flip", slot=s, field="data")
              for s in (0, 1)] if guard == "on" else []
    ex = P.executor(P.LocalTarget(P.spec(n, k, "cached_me", 64)),
                    synth(P, 3, n=n, k=k, width=width, n_batches=6),
                    injector=P.FaultInjector(faults, seed=1),
                    checkpoint_every=0, slots=1, oversubscription=64)
    issued = []
    real_issue = Executor._issue

    def guarded_issue(self, si, stream):
        with monkeypatch.context() as m:
            for name in HOST_READS:
                orig = getattr(torch.Tensor, name)

                def no_read(t, *a, _name=name, _orig=orig, **kw):
                    if _in_plain_replay():
                        return _orig(t, *a, **kw)
                    raise AssertionError(f"Tensor.{_name} at issue")
                m.setattr(torch.Tensor, name, no_read)
            ok = real_issue(self, si, stream)
        issued.append(ok)
        return ok

    monkeypatch.setattr(Executor, "_issue", guarded_issue)
    rep = ex.run()
    assert sum(issued) == rep["issues"] == 18
    if guard == "on":
        assert rep["poisoned"] >= 1
        assert any((r.ops.kind == 3).any() for r in ex.history)
    replay_history(n, k, [width] * 3, ex.history)


def test_guard_off_builds_nothing_and_launches_nothing_more(monkeypatch):
    """BIGATOMIC_GUARD unset: no scrubber, no scrub or shed state, no
    kernel launched beyond an unguarded run's (`launch_counts`), and the
    same table as a guarded run without faults."""
    from repro_torch import kernels as tk
    P = _Pkg("port")

    def run_once(seed):
        streams = [P.SyntheticStream(f"s{i}", seed=seed + i, n=16, k=2,
                                     width=4, n_batches=3)
                   for i in range(2)]
        ex = P.executor(P.LocalTarget(P.spec(16, 2, "cached_me", 16)),
                        streams)
        return ex, ex.run()

    monkeypatch.delenv("BIGATOMIC_GUARD", raising=False)
    before = tk.launch_counts()
    ex, rep = run_once(900)
    assert tk.launch_counts() == before
    assert ex.scrubber is None
    assert rep["scrubs"] == [] and rep["poisoned"] == 0
    assert "exec.scrubs" not in rep["events"]
    monkeypatch.setenv("BIGATOMIC_GUARD", "on")
    guarded, grep = run_once(900)
    assert guarded.scrubber is not None and grep["scrubs"]
    assert P.table(guarded.target) == P.table(ex.target)


def test_guard_env_validation(monkeypatch):
    from repro_torch import guard
    monkeypatch.setenv("BIGATOMIC_GUARD", "sideways")
    with pytest.raises(ValueError, match="BIGATOMIC_GUARD"):
        guard.configured()
    with pytest.raises(ValueError, match="BIGATOMIC_GUARD"):
        _Pkg("port").executor(_Pkg("port").LocalTarget(
            _Pkg("port").spec(8, 2, "seqlock", 8)), [])
    monkeypatch.setenv("BIGATOMIC_GUARD", "on")
    assert guard.enabled()
    monkeypatch.delenv("BIGATOMIC_GUARD")
    assert guard.configured() == "off" and not guard.enabled()


def test_preemption_guard_flag_and_handler_restore():
    """test_preemption_guard_flag and
    test_preemption_guard_restores_handlers_on_enter_failure on the port:
    handlers are installed only on enter, and a failed enter rolls back
    the ones it installed."""
    import signal

    from repro_torch.runtime import PreemptionGuard
    guard = PreemptionGuard()
    assert not guard.should_stop
    with guard as g:
        assert not g.should_stop
        g.request_stop()
        assert g.should_stop
    marker = lambda signum, frame: None          # noqa: E731
    old = signal.signal(signal.SIGTERM, marker)
    try:
        PreemptionGuard(signals=(signal.SIGTERM,))
        assert signal.getsignal(signal.SIGTERM) is marker   # not on init
        with pytest.raises((ValueError, OSError)):
            with PreemptionGuard(signals=(signal.SIGTERM, 10 ** 6)):
                pytest.fail("enter must not succeed")
        assert signal.getsignal(signal.SIGTERM) is marker
        with PreemptionGuard(signals=(signal.SIGTERM,)):
            assert signal.getsignal(signal.SIGTERM) is not marker
        assert signal.getsignal(signal.SIGTERM) is marker
    finally:
        signal.signal(signal.SIGTERM, old)


def test_straggler_watchdog_plans():
    """test_straggler_flags_after_patience and
    test_straggler_blip_does_not_flag on the port."""
    from repro_torch.runtime import StragglerWatchdog
    w = StragglerWatchdog(n_hosts=4, threshold=1.5, patience=3,
                          spares=["spare0"])
    for _ in range(2):
        assert w.observe([1.0, 1.0, 1.0, 5.0]).flagged == []
    plan = w.observe([1.0, 1.0, 1.0, 5.0])
    assert (plan.flagged, plan.swap, plan.shrink) == ([3],
                                                      {3: "spare0"}, [])
    assert StragglerWatchdog(n_hosts=2, patience=1).observe(
        [1.0, 9.0]).shrink == [1]
    w = StragglerWatchdog(n_hosts=3, patience=2)
    w.observe([1.0, 1.0, 1.0])
    assert w.observe([1.0, 1.0, 30.0]).flagged == []
    assert w.observe([1.0, 1.0, 1.0]).flagged == []


def test_shard_loss_against_a_local_target_raises():
    """A shard loss has no mesh to reshard onto: `shrink` raises after the
    in-memory checkpoint is restored, as the reference's LocalTarget."""
    P = _Pkg("port")
    ex = P.executor(P.LocalTarget(P.spec(16, 2, "seqlock", 16)),
                    synth(P, 2, n=16, k=2, width=4, n_batches=4),
                    injector=P.FaultInjector([P.Fault(round=2,
                                                      kind="shard_loss",
                                                      shard=0)]))
    with pytest.raises(RuntimeError, match="LocalTarget is fatal"):
        ex.run()
