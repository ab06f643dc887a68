"""The port's observability (`repro_torch.obs`) against the JAX reference.

  * counters: the same seeded batches (the oracle's mixed batches and the
    engine-round spectra) through the port's `atomics.apply` under
    BIGATOMIC_OBS=counters, on the four lock-free layouts, in
    BIGATOMIC_ENGINE_KERNEL modes auto (the kernel tier's host code, its
    kernels' plain versions on the CPU), xla and off: `snapshot()` equals
    `tests/oracle.py::TelemetryOracle`'s recount and the reference's own
    `snapshot()` (one subprocess with the jax alias the reference needs),
    every key, exactly;
  * off is free: no counter tensor is made and `apply` dispatches exactly
    the operations it dispatches with counting on, less the count's own;
  * on adds no host read: the kernel tier's host code with every
    tensor-to-host read patched to raise, counters off and on;
  * the contention histogram from the sorted slots equals the numpy
    recount on any slots, out-of-range ones included; int32 wrap;
  * `chrome_trace` / `write_metrics_jsonl` / `derived`, `count_mcas_round`
    and `record_dist` equal the reference's on the same inputs.
Tolerance is zero throughout."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from oracle import (TableOracle, TelemetryOracle, _np_contention_hist,
                    mixed_batch)
from repro.core import engine as jengine
from repro_torch import atomics as tatomics
from repro_torch import convert
from repro_torch import obs as tobs
from repro_torch.core import engine as tengine
from repro_torch.kernels import engine_round as ter
from repro_torch.obs import telemetry as ttel
from test_torch_engine_round import (LOCK_FREE, _no_host_read, make_batch,
                                     spectrum_ops)

ROOT = Path(__file__).resolve().parents[1]
N, K, P = 48, 2, 16
MODES = ("auto", "xla", "off")
SPECTRA = ("none", "read_dup", "all_same", "zipf", "long", "llsc")


def obs_batches(strategy):
    """(initial table, batches): three oracle mixed batches, then each
    engine-round spectrum (the LL/SC one as an LL batch and its SC /
    VALIDATE batch), as numpy tuples in the reference's field order.  The
    batches depend only on the sequential oracle, never on the package
    under test."""
    rng = np.random.default_rng(LOCK_FREE.index(strategy) + 40)
    initial = rng.integers(0, 2 ** 32, (N, K), dtype=np.uint32)
    oc = TableOracle(N, K, P, initial=initial)
    out = []

    def step(ops):
        ops = tuple(np.asarray(x) for x in ops)
        oc.step(jengine.OpBatch(*ops))
        out.append(ops)

    for _ in range(3):
        step(mixed_batch(rng, oc.ctx, p=P, n=N, k=K, current=oc.data))
    for spectrum in SPECTRA:
        for s in range(2 if spectrum == "llsc" else 1):
            step(spectrum_ops(rng, spectrum, s, N, K, P, oc.data,
                              np.asarray(oc.ctx.slot)))
    return initial, out


# ---------------------------------------------------------------------------
# The reference's snapshots, from one subprocess.
# ---------------------------------------------------------------------------

_REFERENCE_SCRIPT = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    from jax.experimental.pallas import tpu as pltpu
    if not hasattr(pltpu, "TPUMemorySpace"):   # renamed in newer jax
        pltpu.TPUMemorySpace = pltpu.MemorySpace
    import jax.numpy as jnp
    from repro import atomics, obs
    from repro.core import engine

    cases = np.load(sys.argv[1])
    strategies = json.loads(sys.argv[3])
    os.environ["BIGATOMIC_OBS"] = "counters"
    out = {}
    for strategy in strategies:
        initial = cases[f"{strategy}/initial"]
        n, k = initial.shape
        nb = int(cases[f"{strategy}/count"])
        for mode in ("xla", "off"):
            os.environ["BIGATOMIC_ENGINE_KERNEL"] = mode
            obs.reset()
            p = cases[f"{strategy}/0/kind"].shape[0]
            spec = atomics.AtomicSpec(n, k, strategy, p)
            state = atomics.init(spec, initial)
            ctx = atomics.init_ctx(p, k)
            for b in range(nb):
                ops = engine.OpBatch(*(jnp.asarray(cases[f"{strategy}/{b}/{f}"])
                                       for f in engine.OpBatch._fields))
                state, ctx, *_ = atomics.apply(spec, state, ops, ctx)
            atomics.read(spec, state, np.arange(n, dtype=np.int32))
            torn = atomics.begin_update(spec, state, 3,
                                        np.arange(k, dtype=np.uint32))
            atomics.read(spec, torn, np.arange(n, dtype=np.int32))
            out[f"{strategy}/{mode}"] = obs.snapshot()
    json.dump(out, open(sys.argv[2], "w"))
""")


@pytest.fixture(scope="module")
def reference_snapshots(tmp_path_factory):
    """{"strategy/mode": the reference's snapshot} for modes xla (its
    fused round) and off, over `obs_batches` plus a full read and a read
    of the table with cell 3 caught mid-update."""
    tmp = tmp_path_factory.mktemp("obs_ref")
    cases = {}
    for strategy in LOCK_FREE:
        initial, batches = obs_batches(strategy)
        cases[f"{strategy}/initial"] = initial
        cases[f"{strategy}/count"] = np.asarray(len(batches))
        for b, ops in enumerate(batches):
            for f, x in zip(jengine.OpBatch._fields, ops):
                cases[f"{strategy}/{b}/{f}"] = x
    np.savez(tmp / "in.npz", **cases)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT / 'tests'}")
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE_SCRIPT, str(tmp / "in.npz"),
         str(tmp / "out.json"), json.dumps(LOCK_FREE)],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads((tmp / "out.json").read_text())


def port_sweep(strategy, mode, monkeypatch):
    """The port's snapshot over the same batches and reads, with the
    results each batch delivered."""
    monkeypatch.setenv("BIGATOMIC_OBS", "counters")
    monkeypatch.setenv("BIGATOMIC_ENGINE_KERNEL", mode)
    tobs.reset()
    initial, batches = obs_batches(strategy)
    spec = tatomics.AtomicSpec(N, K, strategy, P)
    state = tatomics.init(spec, initial, device="cpu")
    ctx = tatomics.init_ctx(P, K, device="cpu")
    delivered = []
    for ops in batches:
        state, ctx, res, _, _ = tatomics.apply(
            spec, state, convert.op_batch(ops, "cpu"), ctx)
        delivered.append((ops, res))
    _, ok = tatomics.read(spec, state, np.arange(N))
    torn = tatomics.begin_update(spec, state, 3, np.arange(K))
    _, ok_torn = tatomics.read(spec, torn, np.arange(N))
    return tobs.snapshot(), delivered, (ok, ok_torn)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("strategy", LOCK_FREE)
def test_counters_match_oracle_and_reference(strategy, mode, monkeypatch,
                                             reference_snapshots):
    snap, delivered, reads = port_sweep(strategy, mode, monkeypatch)
    tel = TelemetryOracle(N)
    fused = mode != "off"
    for ops, res in delivered:
        tel.count_table_batch(jengine.OpBatch(*ops),
                              jengine.ApplyResult(*convert.to_numpy(res)),
                              fused=fused)
    for ok in reads:
        tel.count_read(ok.numpy())
    want = tel.counts()
    assert {k: snap[k] for k in want} == want
    ref = reference_snapshots[f"{strategy}/{'off' if mode == 'off' else 'xla'}"]
    assert snap == ref
    assert snap["engine.batches"] == len(delivered)
    assert snap["read.torn_retries"] == (1 if strategy == "seqlock" else 0)
    if fused:                        # the sweep takes both branches
        assert 0 < snap["engine.fast.taken"] < len(delivered)


def test_counters_do_not_perturb_results(monkeypatch):
    """Counting on and off give the same states, links and results."""
    outs = []
    for mode in ("off", "counters"):
        monkeypatch.setenv("BIGATOMIC_OBS", mode)
        initial, batches = obs_batches("cached_wf")
        spec = tatomics.AtomicSpec(N, K, "cached_wf", P)
        state = tatomics.init(spec, initial, device="cpu")
        ctx = tatomics.init_ctx(P, K, device="cpu")
        got = []
        for ops in batches:
            state, ctx, res, stats, traffic = tatomics.apply(
                spec, state, convert.op_batch(ops, "cpu"), ctx)
            got += [*state, *ctx, *res, *stats, *traffic]
        outs.append(got)
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Off is free; on reads nothing back.
# ---------------------------------------------------------------------------

class _Ops(TorchDispatchMode):
    """Record the name of every operation dispatched."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("strategy", LOCK_FREE)
def test_off_makes_no_counter_and_adds_no_operation(strategy, monkeypatch):
    """BIGATOMIC_OBS unset: a kernel-tier `apply` makes no counter tensor
    and dispatches exactly the operations of a counted `apply` less one
    contiguous run of operations: the count, issued after the round.  The
    launch counts are the same either way."""
    monkeypatch.setenv("BIGATOMIC_ENGINE_KERNEL", "auto")
    ttel._telem.clear()
    n, k, p = 40, 2, 16
    rng = np.random.default_rng(3)
    initial = rng.integers(0, 2 ** 32, (n, k), dtype=np.uint32)
    spec = tatomics.AtomicSpec(n, k, strategy, p)
    traces, launches = {}, {}
    for mode in ("off", "counters"):
        monkeypatch.setenv("BIGATOMIC_OBS", mode)
        ops, ctx = make_batch(np.random.default_rng(9), n, k, p, "low",
                              data=initial, ver=np.zeros(n, np.uint32))
        state = tatomics.init(spec, initial, device="cpu")
        batch = convert.op_batch(ops, "cpu")
        tctx = convert.link_ctx(ctx, "cpu")
        from repro_torch import kernels as tk
        tk.reset_launch_counts()
        with _Ops() as rec:
            tatomics.apply(spec, state, batch, tctx, donate=True)
        traces[mode] = rec.names
        launches[mode] = tk.launch_counts()
        if mode == "off":
            assert not ttel._telem, "counting off made a counter tensor"
            ttel.telemetry("cpu")     # made before the counted trace
    off, on = traces["off"], traces["counters"]
    assert launches["off"] == launches["counters"]
    extra = len(on) - len(off)
    assert extra > 0
    starts = [i for i in range(len(off) + 1)
              if on[:i] == off[:i] and on[i + extra:] == off[i:]]
    assert starts, "the counted apply is not the uncounted one plus a run"
    assert any("searchsorted" in name
               for name in on[starts[0]:starts[0] + extra])


@pytest.mark.parametrize("obs_mode", ["off", "counters"])
def test_kernel_tier_reads_nothing_back_with_counters(obs_mode, monkeypatch):
    """The kernel tier's host code (`engine.run_round` with the round of
    `make_round(mode="pallas")`, the layout's commit, the traffic model and
    the count) on a fast and a slow batch per layout, with every way a
    tensor reaches the host patched to raise (the replay's plain version,
    which reads its round count, replaced by its recorded outputs).  The
    outputs and the counters equal an unpatched run's."""
    monkeypatch.setenv("BIGATOMIC_OBS", obs_mode)
    n, k, p = 40, 2, 16
    rng = np.random.default_rng(5)
    for strategy in LOCK_FREE:
        spec = tatomics.AtomicSpec(n, k, strategy, p)
        impl = tatomics.get_strategy(strategy)
        initial = rng.integers(0, 2 ** 32, (n, k), dtype=np.uint32)
        base = tatomics.init(spec, initial, device="cpu")
        for spectrum in ("none", "low"):
            ops_np, ctx_np = make_batch(rng, n, k, p, spectrum, data=initial,
                                        ver=np.zeros(n, np.uint32))
            ops = convert.op_batch(ops_np, "cpu")
            ctx = convert.link_ctx(ctx_np, "cpu")
            recorded = []
            slow = ter.slow_round

            def record(*a, **kw):
                out = slow(*a, **kw)
                recorded.append([x.clone() for x in out])
                return out

            def replay(data, version, *a, **kw):
                d, v, *rest = recorded[0]
                data.copy_(d)
                version.copy_(v)
                return (data, version, *rest)

            def run(state):
                tobs.reset()
                telem = ttel.carry_in("cpu")
                assert (telem is None) == (obs_mode == "off")
                new_state, new_ctx, res, stats = tengine.run_round(
                    impl, ter.make_round(n, k, mode="pallas"), state, ctx,
                    ops, donate=True, telem=telem)
                counters = [] if telem is None else \
                    [x.clone() for x in telem.telem]
                return [*new_state, *new_ctx, *res, *stats,
                        *impl.traffic(stats, k, p), *counters]

            with monkeypatch.context() as m:
                m.setattr(ter, "slow_round", record)
                want = run(tatomics.TableState(*(x.clone() for x in base)))
            with monkeypatch.context() as m:
                m.setattr(ter, "slow_round", replay)
                for name in ("__bool__", "__int__", "__index__", "__float__",
                             "item", "tolist", "numpy"):
                    m.setattr(torch.Tensor, name, _no_host_read(name))
                got = run(tatomics.TableState(*(x.clone() for x in base)))
            assert len(got) == len(want)
            for i, (a, b) in enumerate(zip(got, want)):
                assert torch.equal(a, b), f"{strategy}/{spectrum}: {i}"


def test_reset_zeroes_in_place_and_counts_accumulate(monkeypatch):
    """`reset` zeroes the same tensors (a captured graph keeps counting
    into them); two applies count twice what one does; int32 wraps at
    2^31 as the reference's counters do."""
    monkeypatch.setenv("BIGATOMIC_OBS", "counters")
    spec = tatomics.AtomicSpec(16, 2, "cached_me", 8)
    state = tatomics.init(spec, device="cpu")
    ops = tatomics.stores(np.arange(8) % 3, np.ones((8, 2), np.uint32), k=2,
                          device="cpu")
    t = ttel.telemetry("cpu")
    ptr = t.batches.data_ptr()
    tobs.reset()
    state, *_ = tatomics.apply(spec, state, ops)
    once = tobs.snapshot()
    state, *_ = tatomics.apply(spec, state, ops)
    twice = tobs.snapshot()
    assert twice == {k: 2 * v for k, v in once.items()}
    assert once["engine.contention.log2_01"] == 3      # cells of 3, 3, 2
    tobs.reset()
    assert ttel.telemetry("cpu").batches.data_ptr() == ptr
    assert not any(tobs.snapshot().values())
    ttel.telemetry("cpu").batches.fill_(2 ** 31 - 1)
    tatomics.apply(spec, state, ops)
    assert tobs.snapshot()["engine.batches"] == -2 ** 31
    tobs.reset()


def test_flag_flip_mid_process(monkeypatch):
    monkeypatch.setenv("BIGATOMIC_OBS", "counters")
    tobs.reset()
    spec = tatomics.AtomicSpec(16, 2, "seqlock", 8)
    ops = tatomics.stores(np.arange(8), np.ones((8, 2), np.uint32), k=2,
                          device="cpu")
    tatomics.apply(spec, tatomics.init(spec, device="cpu"), ops)
    assert tobs.snapshot()["engine.batches"] == 1
    monkeypatch.setenv("BIGATOMIC_OBS", "off")
    tatomics.apply(spec, tatomics.init(spec, device="cpu"), ops)
    tobs.record(**{"queue.rounds": 5})                # off: not recorded
    snap = tobs.snapshot()
    assert snap["engine.batches"] == 1 and "queue.rounds" not in snap
    monkeypatch.setenv("BIGATOMIC_OBS", "bogus")
    with pytest.raises(ValueError):
        ttel.configured_mode()


@pytest.mark.parametrize("seed", range(6))
def test_contention_hist_matches_numpy(seed):
    """The histogram from the sorted slots equals the numpy recount
    (`oracle._np_contention_hist`) on IDLE lanes, negative and
    out-of-range slots, and cells of up to 2^15 lanes and more."""
    rng = np.random.default_rng(seed)
    n = 64
    p = [1, 7, 300, 2 ** 15, 2 ** 15 + 3, 5000][seed]
    kind = rng.integers(0, 7, p).astype(np.int32)
    slot = rng.integers(-3, n + 3, p).astype(np.int32)
    if seed >= 3:                      # one hot cell
        slot[rng.random(p) < 0.95] = 5
    ops = convert.op_batch((kind, slot, np.zeros((p, 1), np.uint32),
                            np.zeros((p, 1), np.uint32)), "cpu")
    s_slot, _ = ter.sort_slots(n, ops)
    c = ttel._consts(torch.device("cpu"))
    got = ttel.contention_hist(n, s_slot, c.thresholds).numpy()
    np.testing.assert_array_equal(got, _np_contention_hist(n, kind, slot))


def test_contention_bucket_matches_reference():
    from repro.obs import telemetry as jtel
    c = np.array([1, 2, 3, 4, 7, 8, 1000, 2 ** 15 - 1, 2 ** 15, 2 ** 20],
                 np.int32)
    np.testing.assert_array_equal(
        ttel.contention_bucket(torch.from_numpy(c)).numpy(),
        np.asarray(jtel.contention_bucket(c)))


def test_mcas_and_dist_counters_match_reference(monkeypatch):
    """`count_mcas_round` and `record_dist` against the reference's on the
    same masks (the JAX functions run in this process: they reach no
    Pallas kernel)."""
    import jax.numpy as jnp
    from repro.obs import telemetry as jtel
    rng = np.random.default_rng(1)
    jt = jtel.init_telemetry()
    monkeypatch.setenv("BIGATOMIC_OBS", "counters")
    tobs.reset()
    tt = ttel.telemetry("cpu")
    for _ in range(3):
        masks = [rng.random(9) < 0.5 for _ in range(3)]
        jt = jtel.count_mcas_round(jt, *map(jnp.asarray, masks))
        ttel.count_mcas_round(tt, *map(torch.from_numpy, masks))
    jtel.reset()
    monkeypatch.setattr(jtel, "_telem", jt)
    for words in (3, 5):
        ovf = rng.random(7) < 0.3
        jtel.record_dist(jnp.asarray(ovf), words)
        ttel.record_dist(ovf, words, device="cpu")
    want = jtel.snapshot()
    got = tobs.snapshot()
    keys = [k for k in want if k.startswith(("mcas.", "dist."))]
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert got["mcas.rounds"] == 3 and got["dist.rounds"] == 2
    tobs.reset()


# ---------------------------------------------------------------------------
# Recorder / export: pure host code, held to the reference's output.
# ---------------------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.00125
        return self.t


class _Report:
    detected, repaired, quarantined, latency_s = [3, 5], [3], [5], 0.25


def _drive(recorder):
    """The same executor-shaped event stream for either package."""
    for r in range(3):
        recorder.round_begin(r)
        tokens = [recorder.begin_issue(s, f"s{s}") for s in range(3)]
        for s, tok in enumerate(tokens):
            recorder.issue_latency(s, 0.001 * (s + r + 1))
            if s == 2 and r == 1:
                recorder.cancel_issue(tok)
            else:
                recorder.end_issue(tok, name="issue", args={"r": r})
        if r == 1:
            recorder.straggler_flags(r, [2, 0])
        recorder.round_end(r)
    recorder.checkpoint(3)
    recorder.recovery(3, 1, 4, 0.5)
    recorder.preempt(4, 2)
    recorder.data_fault(4, "bit_flip", {"slot": 7})
    recorder.scrub(5, _Report())
    recorder.shed(5, 1, "overload")
    return recorder.latency_vector(4)


@pytest.mark.parametrize("trace", [True, False])
def test_recorder_and_export_match_reference(trace, tmp_path, monkeypatch):
    from repro import obs as jobs
    from repro.obs import export as jexport
    jr = jobs.Recorder(trace=trace, clock=_Clock())
    tr = tobs.Recorder(trace=trace, clock=_Clock())
    assert _drive(tr) == _drive(jr)
    assert tr.metrics() == jr.metrics()
    assert tr.flags == jr.flags
    assert tobs.chrome_trace(tr) == jexport.chrome_trace(jr)
    monkeypatch.setenv("BIGATOMIC_OBS", "counters")
    jobs.reset()
    tobs.reset()
    for mod in (jobs, tobs):
        mod.record(**{"queue.rounds": 7, "queue.sc_lost": 2})
    jexport.write_metrics_jsonl(str(tmp_path / "ref.jsonl"), jr.metrics())
    tobs.write_metrics_jsonl(str(tmp_path / "port.jsonl"), tr.metrics())
    assert (tmp_path / "port.jsonl").read_text() == \
        (tmp_path / "ref.jsonl").read_text()
    jexport.write_chrome_trace(jr, str(tmp_path / "ref.json"))
    tobs.write_chrome_trace(tr, str(tmp_path / "port.json"))
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "ref.json").read_text()
    snap = dict(tobs.snapshot(), **{"engine.batches": 10,
                                    "engine.fast.taken": 4,
                                    "engine.fast.eligible": 6,
                                    "engine.rounds.slow": 9})
    assert tobs.derived(snap) == jobs.derived(snap)
    assert tobs.derived({}) == jobs.derived({})
    jobs.reset()
    tobs.reset()
