"""The port's sync layer (`repro_torch.sync`) and v1 shims
(`core.bigatomic`, `core.semantics`, `core.deprecation`) against the JAX
reference.

Each scenario below is written once against a small adapter (`_Pkg`) and
run twice: in this process on the port (CPU tensors), and in one
subprocess, with the jax alias the reference needs, on the reference.
Every array a scenario returns — table states leaf by leaf, links,
per-lane results, stats, traffic, queue payloads, commit logs, wave
counts, telemetry snapshots — must be equal bit for bit (words compare as
uint32).  The scenarios: random LL/SC/VALIDATE batches through
`atomics.apply` and the legacy `apply_sync`; the `test_llsc.py` cases
(ABA, a lapped linker, one SC per cell per batch); `copy_batch` with its
wave counts; `BigQueue` under the none / const / exp policies with its
commit log and host counters (BIGATOMIC_OBS=counters); the v1 table
shims.  In-process tests add the numpy oracles (`apply_sync_reference`,
`copy_batch_reference`, a sequential FIFO), `_waves` against the
reference's double loop, the warn-once contract and the sharded queue's
refusal."""

import os
import subprocess
import sys
import textwrap
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
LOCK_FREE = ["seqlock", "indirect", "cached_wf", "cached_me"]


def bits(x) -> np.ndarray:
    """A result as numpy; 32-bit integers as their uint32 bits."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype in (np.int32, np.uint32) else x


class _Pkg:
    """One package's entry points, as the scenarios call them."""

    def __init__(self, which: str):
        self.which = which
        if which == "ref":
            from repro import atomics, obs
            from repro.core import bigatomic as ba
            from repro.core import semantics as sem
            from repro.sync import atomic_copy as ac
            from repro.sync import llsc
            from repro.sync import queue
            self.kw = {}
        else:
            from repro_torch import atomics, obs
            from repro_torch.core import bigatomic as ba
            from repro_torch.core import semantics as sem
            from repro_torch.sync import atomic_copy as ac
            from repro_torch.sync import llsc
            from repro_torch.sync import queue
            self.kw = {"device": "cpu"}
        self.atomics, self.obs, self.ba, self.sem = atomics, obs, ba, sem
        self.ac, self.llsc, self.queue = ac, llsc, queue


def _leaves(out: dict, name: str, tree) -> None:
    for i, leaf in enumerate(tree):
        out[f"{name}/{i}"] = bits(leaf)


def _sync_kinds(rng, ctx_slot, linked, n, p):
    """Unified LL/SC/VALIDATE/IDLE kinds; SC/VALIDATE lanes mostly aim at
    their link (tracked here from the LL lanes' slots)."""
    kind = np.asarray([4, 5, 6, 3], np.int32)[rng.integers(0, 4, p)]
    slot = rng.integers(0, n, p).astype(np.int32)
    aim = ((kind == 5) | (kind == 6)) & linked & (rng.random(p) < 0.7)
    slot[aim] = ctx_slot[aim]
    return kind, slot


def scenario_sync_random(P, strategy):
    """Random LL/SC/VALIDATE batches, threading links, alternately through
    `atomics.apply` and the legacy `llsc.apply_sync` (v1 kinds)."""
    out = {}
    n, k, p = 12, 3, 16
    rng = np.random.default_rng(LOCK_FREE.index(strategy))
    init = rng.integers(0, 2 ** 32, (n, k), dtype=np.uint32)
    spec = P.atomics.AtomicSpec(n, k, strategy, p_max=64)
    state = P.atomics.init(spec, init, **P.kw)
    ctx = P.atomics.init_ctx(p, k, **P.kw)
    ctx_slot = np.full(p, -1, np.int32)
    linked = np.zeros(p, bool)
    to_v1 = {4: 0, 5: 1, 6: 2, 3: 3}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for step in range(6):
            kind, slot = _sync_kinds(rng, ctx_slot, linked, n, p)
            desired = rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32)
            if step % 2:
                ops = P.llsc.make_sync_batch(
                    np.vectorize(to_v1.get)(kind).astype(np.int32), slot,
                    desired, k=k, **P.kw)
                res = P.llsc.apply_sync(state, ctx, ops, strategy=strategy,
                                        k=k)
            else:
                ops = P.atomics.make_ops(kind, slot, desired=desired, k=k,
                                         **P.kw)
                res = P.atomics.apply(spec, state, ops, ctx)
            state, ctx = res[0], res[1]
            for name, part in zip(("state", "ctx", "res", "stats",
                                   "traffic"), res):
                _leaves(out, f"{step}/{name}", part)
            ll = kind == 4
            ctx_slot[ll] = slot[ll]
            linked = np.where(ll, True, np.where(kind == 5, False, linked))
    return out


def scenario_aba_and_lapped(P, strategy):
    """The ABA and lapped-linker cases of `test_llsc.py`: every success
    flag and the final tables."""
    out = {}
    n, k = 4, 3
    a = np.arange(n * k, dtype=np.uint32).reshape(n, k)
    state = P.ba.init(n, k, strategy, 16, a, **P.kw)
    ctx = P.llsc.init_ctx(1, k, **P.kw)
    ctx, vals = P.llsc.ll(state, ctx, [2], strategy=strategy, k=k)
    original = bits(vals[0])
    spec = P.atomics.AtomicSpec(n, k, strategy, p_max=16)
    for payload in ((original + 1).astype(np.uint32), original):
        state, *_ = P.atomics.apply(spec, state, P.atomics.stores(
            [2], payload[None], k=k, **P.kw))
    out["aba/validate"] = bits(P.llsc.validate(state, ctx, [2],
                                               strategy=strategy, k=k))
    state, ctx, succ = P.llsc.sc(state, ctx, [2], original[None],
                                 strategy=strategy, k=k)
    out["aba/sc"] = bits(succ)
    _leaves(out, "aba/state", state)

    n, k, p = 4, 2, 8
    state = P.ba.init(n, k, strategy, 64, **P.kw)
    ctx = P.llsc.init_ctx(p, k, **P.kw)
    ctx, _ = P.llsc.ll(state, ctx, np.zeros(p, np.int32), strategy=strategy,
                       k=k)
    spec = P.atomics.AtomicSpec(n, k, strategy, p_max=64)
    wins = []
    for lane in range(1, p):
        kind = np.full(p, 3, np.int32)
        kind[lane] = 5
        ops = P.atomics.make_ops(kind, np.zeros(p, np.int32),
                                 desired=np.full((p, k), lane, np.uint32),
                                 k=k, **P.kw)
        state, ctx, res, _, _ = P.atomics.apply(spec, state, ops, ctx)
        wins.append(bits(res.success))
        if lane + 1 < p:
            kind = np.full(p, 3, np.int32)
            kind[lane + 1] = 4
            ops = P.atomics.make_ops(kind, np.zeros(p, np.int32), k=k,
                                     **P.kw)
            state, ctx, _, _, _ = P.atomics.apply(spec, state, ops, ctx)
    out["lapped/wins"] = np.stack(wins)
    out["lapped/validate"] = bits(P.llsc.validate(state, ctx, [0],
                                                  strategy=strategy, k=k))
    state, ctx, succ = P.llsc.sc(state, ctx, [0],
                                 np.zeros((1, k), np.uint32),
                                 strategy=strategy, k=k)
    out["lapped/sc"] = bits(succ)
    _leaves(out, "lapped/state", state)
    _leaves(out, "lapped/ctx", ctx)

    n, k, p = 2, 2, 8                  # one SC per cell per batch
    state = P.ba.init(n, k, strategy, 32, **P.kw)
    ctx = P.llsc.init_ctx(p, k, **P.kw)
    ctx, _ = P.llsc.ll(state, ctx, np.zeros(p, np.int32), strategy=strategy,
                       k=k)
    desired = np.tile(np.arange(p, dtype=np.uint32)[:, None], (1, k))
    state, ctx, succ = P.llsc.sc(state, ctx, np.zeros(p, np.int32), desired,
                                 strategy=strategy, k=k)
    out["one_sc/succ"] = bits(succ)
    out["one_sc/logical"] = bits(P.ba.logical(state, strategy))
    _leaves(out, "one_sc/ctx", ctx)
    return out


def scenario_copy(P, strategy):
    """`copy_batch` on overlapping, chained and colliding lanes: the table
    (every leaf) and the wave count per trial."""
    out = {}
    rng = np.random.default_rng(7)
    n, k = 10, 4
    spec = P.atomics.AtomicSpec(n, k, strategy, p_max=64)
    init = rng.integers(0, 2 ** 32, (n, k), dtype=np.uint32)
    state = P.atomics.init(spec, init, **P.kw)
    for trial in range(5):
        q = int(rng.integers(1, 10))
        src = rng.integers(0, n, q)
        dst = rng.integers(0, n, q)
        state, waves = P.ac.copy_batch(spec, state, src, dst)
        out[f"{trial}/waves"] = np.asarray(waves)
        out[f"{trial}/logical"] = bits(P.atomics.logical(spec, state))
        _leaves(out, f"{trial}/state", state)
    return out


QUEUE_POLICIES = {"none": (), "const": (1,), "exp": (1, 4)}


def scenario_queue(P, strategy, policy):
    """Mixed ENQ/DEQ/QIDLE races through `run_batch`, then
    `enqueue_batch` / `dequeue_batch`, a full and an empty race, with
    counters on: every payload, success, round count, the commit log,
    `len`, the ring table, and the telemetry snapshot (the engine counters
    of the queue's rounds and the queue's host counters)."""
    q_mod = P.queue
    os.environ["BIGATOMIC_OBS"] = "counters"
    P.obs.reset()
    try:
        out = {}
        rng = np.random.default_rng(13)
        C, p = 4, 6
        q = q_mod.BigQueue(C, k=2, strategy=strategy,
                           policy=q_mod.BackoffPolicy(
                               policy, *QUEUE_POLICIES[policy]), **P.kw)
        serial = 0
        for step in range(6):
            kinds = rng.integers(0, 3, p)
            vals = np.zeros((p, 1), np.uint32)
            for i in np.nonzero(kinds == 0)[0]:
                vals[i, 0] = serial * p + i
                serial += 1
            payload, succ, rounds = q.run_batch(kinds, vals)
            out[f"{step}/out"], out[f"{step}/succ"] = payload, succ
            out[f"{step}/rounds"] = np.asarray(rounds)
        out["enq"] = q.enqueue_batch(np.arange(5, dtype=np.uint32) + 50)
        out["deq"], out["deq_succ"] = q.dequeue_batch(C + 2)
        out["len"] = np.asarray(len(q))
        out["log"] = np.asarray([(kind == "enq", lane, t)
                                 for kind, lane, t in q.commit_log])
        _leaves(out, "table", q.state)
        q2 = q_mod.BigQueue(3, k=4, strategy=strategy,
                            initial_items=[[1, 2, 3], [4, 5, 6]], **P.kw)
        out["init/len"] = np.asarray(len(q2))
        out["init/deq"], out["init/succ"] = q2.dequeue_batch(3)
        snap = P.obs.snapshot()
        out["snapshot"] = np.asarray([snap[key] for key in sorted(snap)])
        out["snapshot_keys"] = np.asarray(sorted(snap))
        return out
    finally:
        os.environ.pop("BIGATOMIC_OBS", None)
        P.obs.reset()


def scenario_v1_shims(P, strategy):
    """`bigatomic.apply_ops` (warns once), `BigAtomicTable`
    store / cas / load / logical / memory_bytes, `read_protocol` on a
    writer frozen by `begin_update`, `commit_layout`, and
    `semantics.random_batch` / `apply_batch`."""
    out = {}
    rng = np.random.default_rng(23 + LOCK_FREE.index(strategy))
    n, k, p = 20, 3, 8
    init = rng.integers(0, 2 ** 32, (n, k), dtype=np.uint32)
    state = P.ba.init(n, k, strategy, 64, init, **P.kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for step in range(3):
            cur = bits(P.ba.logical(state, strategy))
            ops = P.sem.random_batch(rng, p=p, n=n, k=k, update_frac=0.6,
                                     current=cur, **P.kw)
            state, res, stats, traffic = P.ba.apply_ops(
                state, ops, strategy=strategy, k=k)
            for name, part in (("res", res), ("stats", stats),
                               ("traffic", traffic)):
                _leaves(out, f"apply_ops/{step}/{name}", part)
        _leaves(out, "apply_ops/state", state)
    vals, ok = P.ba.read_protocol(state, np.arange(n), strategy=strategy)
    out["read/vals"], out["read/ok"] = bits(vals), bits(ok)
    torn = P.ba.begin_update(state, 4, np.arange(k, dtype=np.uint32) + 9,
                             strategy=strategy)
    vals, ok = P.ba.read_protocol(torn, np.arange(n), strategy=strategy)
    out["torn/vals"], out["torn/ok"] = bits(vals), bits(ok)
    out["memory_bytes"] = np.asarray(P.ba.memory_bytes(n, k, 64, strategy))

    table = P.ba.BigAtomicTable(n, k, strategy, 64, init, **P.kw)
    slots = np.asarray([1, 5, 5, 7], np.int32)
    vals = rng.integers(0, 2 ** 32, (4, k), dtype=np.uint32)
    for name, part in zip(("res", "stats", "traffic"),
                          table.store(slots, vals)):
        _leaves(out, f"table/store/{name}", part)
    expected = np.stack([vals[0], vals[0], vals[2], init[7]])
    for name, part in zip(("res", "stats", "traffic"),
                          table.cas(slots, expected, vals[::-1].copy())):
        _leaves(out, f"table/cas/{name}", part)
    got, ok = table.load(np.arange(n), return_ok=True)
    out["table/load"], out["table/ok"] = bits(got), bits(ok)
    out["table/logical"] = bits(table.logical())
    out["table/memory_bytes"] = np.asarray(table.memory_bytes())
    _leaves(out, "table/state", table.state)

    data = bits(P.ba.logical(state, strategy)).copy()
    data[[2, 9]] += 1
    version = bits(state.version).copy()
    version[[2, 9]] += 2
    new = P.ba.commit_layout(state, P.atomics.init(
        P.atomics.AtomicSpec(n, k, strategy, 64), data, **P.kw).data,
        _as_version(P, version), np.int32(2), strategy, p)
    out["commit_layout/logical"] = bits(P.ba.logical(new, strategy))
    _leaves(out, "commit_layout/state", new)

    ops = P.sem.random_batch(rng, p=p, n=n, k=k, **P.kw)
    d, v, res, stats = P.sem.apply_batch(
        _as_table(P, init), _as_version(P, np.zeros(n, np.uint32)), ops)
    _leaves(out, "apply_batch", (d, v, *res, *stats))
    return out


def _as_table(P, arr):
    if P.which == "ref":
        import jax.numpy as jnp
        return jnp.asarray(arr)
    from repro_torch import convert
    return convert.tensor(arr, "cpu", word=True)


_as_version = _as_table


SCENARIOS = {
    **{f"sync_random/{s}": (scenario_sync_random, (s,)) for s in LOCK_FREE},
    **{f"aba_lapped/{s}": (scenario_aba_and_lapped, (s,)) for s in LOCK_FREE},
    **{f"copy/{s}": (scenario_copy, (s,)) for s in LOCK_FREE},
    **{f"queue/{s}/{pol}": (scenario_queue, (s, pol))
       for s in ("seqlock", "cached_me") for pol in QUEUE_POLICIES},
    **{f"v1/{s}": (scenario_v1_shims, (s,)) for s in LOCK_FREE},
}


def run_scenarios(which: str) -> dict:
    P = _Pkg(which)
    out = {}
    for name, (fn, args) in SCENARIOS.items():
        for key, value in fn(P, *args).items():
            out[f"{name}|{key}"] = value
    return out


_REFERENCE_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    from jax.experimental.pallas import tpu as pltpu
    if not hasattr(pltpu, "TPUMemorySpace"):   # renamed in newer jax
        pltpu.TPUMemorySpace = pltpu.MemorySpace
    import test_torch_sync
    np.savez(sys.argv[1], **test_torch_sync.run_scenarios("ref"))
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("sync_ref") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT / 'tests'}")
    env.pop("BIGATOMIC_OBS", None)
    proc = subprocess.run([sys.executable, "-c", _REFERENCE_SCRIPT,
                           str(path)], env=env, capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(path))


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_reference(name, reference, monkeypatch):
    monkeypatch.delenv("BIGATOMIC_OBS", raising=False)
    fn, args = SCENARIOS[name]
    got = fn(_Pkg("port"), *args)
    want = {key.split("|", 1)[1]: v for key, v in reference.items()
            if key.split("|", 1)[0] == name}
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(
            np.asarray(got[key]), want[key], err_msg=f"{name}: {key}")


# ---------------------------------------------------------------------------
# In-process: the numpy oracles, _waves, warn-once, refusals.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", LOCK_FREE)
def test_sync_batches_match_numpy_oracle(strategy):
    from repro_torch import atomics
    from repro_torch.sync import llsc
    rng = np.random.default_rng(31)
    n, k, p = 9, 2, 12
    init = rng.integers(0, 2 ** 32, (n, k), dtype=np.uint32)
    spec = atomics.AtomicSpec(n, k, strategy, p_max=64)
    state = atomics.init(spec, init, device="cpu")
    ctx = atomics.init_ctx(p, k, device="cpu")
    data, ver = init, np.zeros(n, np.uint32)
    rctx = (np.full(p, -1, np.int32), np.zeros(p, np.uint32),
            np.zeros((p, k), np.uint32), np.zeros(p, bool))
    for _ in range(5):
        kind, slot = _sync_kinds(rng, rctx[0], rctx[3], n, p)
        v1 = np.select([kind == 4, kind == 5, kind == 6], [0, 1, 2],
                       3).astype(np.int32)
        desired = rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32)
        ops = llsc.make_sync_batch(v1, slot, desired, k=k, device="cpu")
        data, ver, rctx, ref = llsc.apply_sync_reference(
            data, ver, rctx, (v1, slot, desired))
        state, ctx, res, _, _ = llsc._apply_unified(
            state, ctx, ops, strategy=strategy, k=k)
        np.testing.assert_array_equal(bits(res.value), ref.value)
        np.testing.assert_array_equal(bits(res.success), ref.success)
        np.testing.assert_array_equal(
            bits(atomics.logical(spec, state)), data)
        np.testing.assert_array_equal(bits(state.version), ver)
        for a, b in zip(ctx, rctx):
            np.testing.assert_array_equal(bits(a), bits(b))


@pytest.mark.parametrize("seed", range(5))
def test_waves_equal_reference_double_loop(seed):
    from repro.sync import atomic_copy as jac
    from repro_torch.sync import atomic_copy as tac
    rng = np.random.default_rng(seed)
    q = [0, 1, 9, 60, 200][seed]
    n = [4, 4, 6, 30, 1000][seed]
    src, dst = rng.integers(0, n, q), rng.integers(0, n, q)
    got, want = tac._waves(src, dst), jac._waves(src, dst)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("strategy", LOCK_FREE)
def test_copy_batch_matches_numpy_oracle_and_keeps_caller_state(strategy):
    from repro_torch import atomics
    from repro_torch.sync import atomic_copy as tac
    rng = np.random.default_rng(3)
    n, k = 16, 2
    spec = atomics.AtomicSpec(n, k, strategy, p_max=64)
    init = rng.integers(0, 2 ** 32, (n, k), dtype=np.uint32)
    state = atomics.init(spec, init, device="cpu")
    before = [x.clone() for x in state]
    src, dst = rng.integers(0, n, 12), rng.integers(0, n, 12)
    new, waves = tac.copy_batch(spec, state, src, dst)
    data, ver = tac.copy_batch_reference(init, np.zeros(n, np.uint32), src,
                                         dst)
    assert waves == len(tac._waves(src, dst)) > 1
    np.testing.assert_array_equal(bits(atomics.logical(spec, new)), data)
    np.testing.assert_array_equal(bits(new.version), ver)
    for a, b in zip(state, before):
        assert torch.equal(a, b)


@pytest.mark.parametrize("policy", list(QUEUE_POLICIES))
def test_queue_fifo_against_sequential_replay(policy):
    """Half ENQ, half DEQ lanes over several batches: replaying the commit
    log in order through a sequential FIFO gives every payload each
    dequeuing lane received; tickets are dense."""
    from collections import deque

    from repro_torch.sync.queue import DEQ, ENQ, BackoffPolicy, BigQueue
    rng = np.random.default_rng(5)
    q = BigQueue(8, k=2, strategy="cached_me", p_max=16, device="cpu",
                 policy=BackoffPolicy(policy, *QUEUE_POLICIES[policy]))
    fifo = deque()
    n_deq = 0
    for step in range(4):
        kinds = rng.permutation(np.repeat([ENQ, DEQ], 8))
        vals = (np.arange(16, dtype=np.uint32) + 100 * step)[:, None]
        start = len(q.commit_log)
        out, succ, _ = q.run_batch(kinds, vals)
        for kind, lane, _ in q.commit_log[start:]:
            if kind == "enq":
                fifo.append(int(vals[lane, 0]))
            else:
                assert int(out[lane, 0]) == fifo.popleft()
                n_deq += 1
        assert succ.sum() == len(q.commit_log) - start
    enq_t = [t for kind, _, t in q.commit_log if kind == "enq"]
    deq_t = [t for kind, _, t in q.commit_log if kind == "deq"]
    assert enq_t == list(range(len(enq_t)))
    assert deq_t == list(range(len(deq_t))) and len(deq_t) == n_deq > 0
    assert len(q) == len(fifo)


def test_one_shard_queue_given_a_mesh_stays_local():
    """The reference's rule `mesh if n_shards > 1 else None`: a one-shard
    queue ignores the mesh (never touched here) and runs on its own table,
    as the same queue built without one does."""
    from repro_torch.sync.queue import BigQueue
    rng = np.random.default_rng(6)
    kw = dict(k=2, strategy="cached_me", initial_items=[[7], [8]],
              device="cpu")
    local = BigQueue(8, mesh=object(), n_shards=1, **kw)
    assert local._mesh is None and local.state is not None
    plain = BigQueue(8, **kw)
    for _ in range(3):
        kinds = rng.integers(0, 3, 12).astype(np.int32)
        vals = rng.integers(0, 2 ** 32, (12, 1), dtype=np.uint32)
        for a, b in zip(local.run_batch(kinds, vals),
                        plain.run_batch(kinds, vals)):
            np.testing.assert_array_equal(a, b)
    assert local.commit_log == plain.commit_log
    assert len(local) == len(plain)
    for a, b in zip(local.state, plain.state):
        assert torch.equal(a, b)


def test_deprecated_entry_points_warn_once():
    from repro_torch import atomics
    from repro_torch.core import bigatomic as ba
    from repro_torch.core import deprecation
    from repro_torch.sync import llsc
    deprecation.reset()
    state = ba.init(8, 2, "cached_me", 16, device="cpu")
    ops = atomics.stores([1, 2], np.ones((2, 2), np.uint32), k=2,
                         device="cpu")
    sync = llsc.make_sync_batch([0, 0], [1, 2], k=2, device="cpu")
    ctx = llsc.init_ctx(2, 2, device="cpu")
    for call, name in (
            (lambda: ba.apply_ops(state, ops, strategy="cached_me", k=2),
             "core.bigatomic.apply_ops"),
            (lambda: llsc.apply_sync(state, ctx, sync, strategy="cached_me",
                                     k=2), "sync.llsc.apply_sync")):
        with pytest.warns(DeprecationWarning, match=name):
            call()
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            call()                                 # the second is silent
    deprecation.reset("core.bigatomic.apply_ops")
    with pytest.warns(DeprecationWarning):
        ba.apply_ops(state, ops, strategy="cached_me", k=2)
    assert ba.strategy_name(ba.Strategy.CACHED_WF) == "cached_wf"
