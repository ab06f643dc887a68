"""The port's versioned snapshot store (`repro_torch.core.multiversion`)
and wait-free writable big atomic (`repro_torch.core.wf_writable`,
Algorithm 3) against the JAX reference.

Each scenario is written once against a small adapter (`_Pkg`) and run on
the port (CPU tensors) in this process and on the reference in one
subprocess with the jax alias it needs (its version-list publish runs
`engine.round_for`, which imports its Pallas module).  Every array a
scenario returns must be equal bit for bit (words as uint32, floats by
their bits).  The scenarios are those of `tests/test_multiversion_wf.py`
(the hypothesis property replaced by seeded scripts drawn with numpy),
plus `step_at` across publishes and `store_batch` with duplicate slots
followed by `cas_batch`.  In-process tests hold the port to the
reference tests' own checks and to `wf.oracle_apply`."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def bits(x) -> np.ndarray:
    """A result as numpy; 32-bit integers and floats as their uint32
    bits."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x)
    if x.dtype in (np.int32, np.uint32, np.float32):
        return x.view(np.uint32)
    return x


class _Pkg:
    """One package's entry points, as the scenarios call them."""

    def __init__(self, which: str):
        self.which = which
        if which == "ref":
            import jax
            import jax.numpy as jnp
            from repro.core import multiversion as mv
            from repro.core import wf_writable as wf
            self.tree_map = jax.tree.map
            self.f32, self.i32 = jnp.float32, jnp.int32
            self.array = jnp.asarray
            self.kw = {}
        else:
            from repro_torch.core import multiversion as mv
            from repro_torch.core import wf_writable as wf
            self.tree_map = mv.tree_map
            self.f32, self.i32 = torch.float32, torch.int32
            self.array = torch.as_tensor
            self.kw = {"device": "cpu"}
        self.mv, self.wf = mv, wf

    def tiny_state(self, seed=0):
        rng = np.random.default_rng(seed)
        return {"w": self.array(rng.standard_normal((4, 4)).astype(
                    np.float32)),
                "b": self.array(rng.standard_normal((4,)).astype(
                    np.float32)),
                "step": self.array(np.int32(0))}

    def scalar(self, x):
        return self.array(np.int32(x))


def record_store(P, out, key, store):
    for name, leaf in (("w", store.slots["w"]), ("b", store.slots["b"]),
                       ("step", store.slots["step"])):
        out[f"{key}/slots_{name}"] = bits(leaf)
    out[f"{key}/version"] = bits(store.version)
    out[f"{key}/steps"] = bits(store.step)
    out[f"{key}/head"] = bits(store.head)
    out[f"{key}/count"] = bits(store.vstate.count)
    out[f"{key}/pool"] = bits(store.vstate.pool)


def record_snap(out, key, snap):
    for name in ("w", "b", "step"):
        out[f"{key}/state_{name}"] = bits(snap.state[name])
    out[f"{key}/step"] = bits(snap.step)
    out[f"{key}/slot"] = bits(snap.slot)
    out[f"{key}/version"] = bits(snap.version)


# ---------------------------------------------------------------------------
# multiversion
# ---------------------------------------------------------------------------

def scenario_mv_roundtrip(P):
    """test_publish_snapshot_roundtrip."""
    s0 = P.tiny_state()
    store = P.mv.init_store(s0, n_slots=3)
    s1 = P.tree_map(lambda x: x + 1, s0)
    store = P.mv.publish(store, s1, step=1)
    out = {}
    record_snap(out, "snap", P.mv.snapshot_with_validation(store))
    record_store(P, out, "store", store)
    return out


def scenario_mv_torn(P):
    """test_reader_never_sees_torn_state: the writer frozen mid-copy."""
    s0 = P.tiny_state()
    store = P.mv.init_store(s0, n_slots=2)
    s1 = P.tree_map(lambda x: x + 100.0, s0)
    store = P.mv.publish(store, s1, step=1)
    s2 = P.tree_map(lambda x: x + 999.0, s1)
    torn = P.mv.begin_publish(store, s2)
    out = {}
    record_snap(out, "snap", P.mv.snapshot_with_validation(torn))
    bad_slot = (int(torn.head) + 1) % 2
    bad = P.mv.Snapshot(P.tree_map(lambda b: b[bad_slot], torn.slots),
                        torn.step[bad_slot], P.scalar(bad_slot),
                        torn.version[bad_slot])
    out["bad_valid"] = bits(P.mv.validate(torn, bad))
    record_store(P, out, "torn", torn)
    out["s2_w"] = bits(s2["w"])
    return out


def scenario_mv_sequence(P):
    """test_publish_sequence_head_always_consistent, with `step_at` of
    every publish time after each publish."""
    s = P.tiny_state()
    store = P.mv.init_store(s, n_slots=2)
    out = {}
    for i in range(1, 6):
        s = P.tree_map(lambda x: x * 1.1 if x.dtype == P.f32 else x, s)
        store = P.mv.publish(store, s, step=i)
        record_snap(out, f"p{i}", P.mv.snapshot_with_validation(store))
        for ts in range(0, 7):
            steps, ok = P.mv.step_at(store, ts)
            out[f"p{i}/step_at{ts}"] = bits(steps)
            out[f"p{i}/step_at{ts}_ok"] = bits(ok)
    record_store(P, out, "store", store)
    return out


# ---------------------------------------------------------------------------
# wf_writable (Algorithm 3)
# ---------------------------------------------------------------------------

def record_wf(out, key, st):
    for name, leaf in zip(st._fields, st):
        out[f"{key}/{name}"] = bits(leaf)


def scenario_wf_basic(P):
    """test_load_store_cas_basic."""
    wf = P.wf
    st = wf.init(n=4, k=2, **P.kw)
    st = wf.store(st, 1, [7, 8])
    out = {"load0": bits(wf.load(st, P.array(np.asarray([1]))))}
    st, ok = wf.cas_batch(st, P.array(np.asarray([1])), [[7, 8]], [[9, 10]])
    out["ok0"] = bits(ok)
    st, ok = wf.cas_batch(st, P.array(np.asarray([1])), [[7, 8]], [[0, 0]])
    out["ok1"] = bits(ok)
    out["load1"] = bits(wf.load(st, P.array(np.asarray([1]))))
    record_wf(out, "state", st)
    return out


def scenario_wf_pending(P):
    """test_pending_store_invisible_until_helped_then_transfers."""
    wf = P.wf
    slot0 = P.array(np.asarray([0]))
    st = wf.init(n=2, k=2, **P.kw)
    st = wf.store(st, 0, [1, 1])
    st = wf.begin_store(st, 0, [2, 2])
    out = {"pending0": bits(wf.pending(st)),
           "load0": bits(wf.load(st, slot0))}
    st, ok = wf.cas_batch(st, slot0, [[1, 1]], [[3, 3]])
    out["ok"] = bits(ok)
    out["load1"] = bits(wf.load(st, slot0))
    out["pending1"] = bits(wf.pending(st))
    record_wf(out, "state", st)
    return out


def scenario_wf_same_value(P):
    """test_store_to_same_value_is_silent."""
    wf = P.wf
    st = wf.init(n=2, k=2, **P.kw)
    st = wf.store(st, 0, [5, 5])
    st = wf.begin_store(st, 0, [5, 5])
    out = {"pending": bits(wf.pending(st))}
    record_wf(out, "state", st)
    return out


def scenario_wf_second_writer(P):
    """test_second_writer_linearizes_silently_before_pending."""
    wf = P.wf
    st = wf.init(n=2, k=2, **P.kw)
    st = wf.begin_store(st, 0, [1, 1])
    st = wf.begin_store(st, 0, [2, 2])
    st = wf.help_write(st)
    out = {"load": bits(wf.load(st, P.array(np.asarray([0]))))}
    record_wf(out, "state", st)
    return out


WF_SCRIPTS = [(int(s), int(n), int(m)) for s, n, m in zip(
    *(np.random.default_rng(2024).integers(lo, hi, 20)
      for lo, hi in ((0, 2 ** 31), (1, 7), (1, 25))))]


def scenario_wf_script(P, seed, n, n_ops):
    """test_wf_writable_linearizable_vs_oracle's random scripts of load /
    begin_store / store / help / cas on k = 2 atomics (one seeded draw per
    case, in the property's order)."""
    wf = P.wf
    rng = np.random.default_rng(seed)
    st = wf.init(n=n, k=2, p_max=n_ops + 4, **P.kw)
    out = {"vals0": bits(st.z_value)}
    kinds, slots, vals = [], [], []
    results = []
    for _ in range(n_ops):
        s = int(rng.integers(0, n))
        kind = str(rng.choice(["load", "begin_store", "store", "help",
                               "cas"]))
        kinds.append(["load", "begin_store", "store", "help",
                      "cas"].index(kind))
        slots.append(s)
        e = np.zeros(2, np.uint32)
        v = np.zeros(2, np.uint32)
        if kind == "load":
            results.append(bits(wf.load(st, P.array(np.asarray([s]))))[0])
        elif kind in ("begin_store", "store"):
            v = rng.integers(0, 5, 2).astype(np.uint32)
            st = getattr(wf, kind)(st, s, v)
        elif kind == "help":
            st = wf.help_write(st)
        else:
            e = rng.integers(0, 5, 2).astype(np.uint32)
            v = rng.integers(0, 5, 2).astype(np.uint32)
            st, ok = wf.cas_batch(st, P.array(np.asarray([s])), e[None],
                                  v[None])
            results.append(np.asarray([bool(np.asarray(bits(ok))[0])] * 2,
                                      np.uint32))
        vals.append(np.stack([e, v]))
    st = wf.help_write(st)
    out["kinds"] = np.asarray(kinds, np.int32)
    out["slots"] = np.asarray(slots, np.int32)
    out["vals"] = np.asarray(vals, np.uint32).reshape(n_ops, 2, 2)
    out["results"] = np.asarray(results, np.uint32).reshape(-1, 2)
    record_wf(out, "state", st)
    return out


def scenario_wf_batches(P):
    """`store_batch` with duplicate slots (the last lane per slot wins),
    twice (the pool cursor advances), then `cas_batch` with duplicate
    slots, half the lanes expecting the live values."""
    wf = P.wf
    rng = np.random.default_rng(77)
    n, k, p = 12, 3, 40
    st = wf.init(n=n, k=k, p_max=p,
                 initial=rng.integers(0, 2 ** 32, (n, k), dtype=np.uint32),
                 **P.kw)
    out = {"vals0": bits(st.z_value)}
    for i in range(2):
        slots = rng.integers(0, n, p).astype(np.int32)
        vals = rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32)
        st = wf.store_batch(st, P.array(slots), vals)
        out[f"store{i}/slots"], out[f"store{i}/vals"] = slots, vals
        record_wf(out, f"store{i}", st)
    slots = rng.integers(0, n, p).astype(np.int32)
    cur = bits(st.z_value)
    expected = np.where((rng.random(p) < 0.5)[:, None], cur[slots],
                        rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32))
    desired = rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32)
    st, ok = wf.cas_batch(st, P.array(slots), expected, desired)
    out["cas/slots"], out["cas/expected"], out["cas/desired"] = (
        slots, expected, desired)
    out["cas/ok"] = bits(ok)
    record_wf(out, "cas", st)
    return out


def scenario_wf_out_of_range(P):
    """ROADMAP Queue 3 item 5: `init(4, 2, 4, arange(8).reshape(4, 2))`,
    then `load` at [0, 4], [-5] and [-1], `store_batch` at [0, 4] and
    `cas_batch` at [-5, 1] expecting rows 0 and 1.  The reference's
    gathers wrap a negative slot then clamp, its scatters drop what lies
    outside [0, n): the CAS at -5 succeeds and writes nothing."""
    wf = P.wf
    initial = np.arange(8, dtype=np.uint32).reshape(4, 2)
    st = wf.init(4, 2, 4, initial, **P.kw)
    out = {}
    for i, slots in enumerate(([0, 4], [-5], [-1])):
        out[f"load{i}"] = bits(wf.load(st, P.array(np.asarray(slots,
                                                              np.int32))))
    stored = wf.store_batch(st, P.array(np.asarray([0, 4], np.int32)),
                            np.full((2, 2), 9, np.uint32))
    record_wf(out, "store", stored)
    cased, ok = wf.cas_batch(st, P.array(np.asarray([-5, 1], np.int32)),
                             initial[[0, 1]], np.full((2, 2), 7, np.uint32))
    out["cas/ok"] = bits(ok)
    record_wf(out, "cas", cased)
    return out


SCENARIOS = {
    "wf_out_of_range": (scenario_wf_out_of_range, ()),
    "mv_roundtrip": (scenario_mv_roundtrip, ()),
    "mv_torn": (scenario_mv_torn, ()),
    "mv_sequence": (scenario_mv_sequence, ()),
    "wf_basic": (scenario_wf_basic, ()),
    "wf_pending": (scenario_wf_pending, ()),
    "wf_same_value": (scenario_wf_same_value, ()),
    "wf_second_writer": (scenario_wf_second_writer, ()),
    **{f"wf_script/{i}": (scenario_wf_script, args)
       for i, args in enumerate(WF_SCRIPTS)},
    "wf_batches": (scenario_wf_batches, ()),
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
    import test_torch_multiversion_wf as t
    np.savez(sys.argv[1], **t.run_scenarios("ref"))
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("mvwf_ref") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT / 'tests'}")
    env.pop("BIGATOMIC_OBS", None)
    proc = subprocess.run([sys.executable, "-c", _REFERENCE_SCRIPT,
                           str(path)], env=env, capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(path))


@pytest.fixture(scope="module")
def port_runs():
    """Each scenario run once on the port, on first use."""
    runs = {}

    def get(name):
        if name not in runs:
            fn, args = SCENARIOS[name]
            runs[name] = fn(_Pkg("port"), *args)
        return runs[name]
    return get


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_reference(name, reference, port_runs):
    got = port_runs(name)
    want = {key.split("|", 1)[1]: v for key, v in reference.items()
            if key.split("|", 1)[0] == name}
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(
            np.asarray(got[key]), want[key], err_msg=f"{name}: {key}")


# ---------------------------------------------------------------------------
# In-process: the reference tests' own checks, the sequential oracle.
# ---------------------------------------------------------------------------

def f32(x) -> np.ndarray:
    return np.asarray(x, np.uint32).view(np.float32)


def test_publish_snapshot_roundtrip(port_runs):
    out = port_runs("mv_roundtrip")
    s0 = _Pkg("port").tiny_state()
    assert int(out["snap/step"]) == 1
    np.testing.assert_array_equal(f32(out["snap/state_w"]),
                                  s0["w"].numpy() + 1)


def test_reader_never_sees_torn_state(port_runs):
    out = port_runs("mv_torn")
    s0 = _Pkg("port").tiny_state()
    s1w = s0["w"].numpy() + np.float32(100.0)
    np.testing.assert_array_equal(f32(out["snap/state_w"]), s1w)
    assert not bool(out["bad_valid"])
    bad_slot = (int(out["torn/head"]) + 1) % 2
    w = f32(out["torn/slots_w"])[bad_slot].reshape(-1)
    s2w = f32(out["s2_w"]).reshape(-1)
    assert (w[:8] == s2w[:8]).all()
    assert not (w[8:] == s2w[8:]).all()
    assert int(out["torn/version"][bad_slot]) % 2 == 1


def test_publish_sequence_head_always_consistent(port_runs):
    """Every publish validates, its step is the head's, versions stay
    even; `step_at(ts)` names the step each slot held at publish ts
    (slot = ts % 2 published step ts), ok only within its chain's last
    two versions."""
    out = port_runs("mv_sequence")
    for i in range(1, 6):
        assert int(out[f"p{i}/step"]) == i
        assert int(out[f"p{i}/version"]) % 2 == 0
        for ts in range(0, 7):
            steps, ok = out[f"p{i}/step_at{ts}"], out[f"p{i}/step_at{ts}_ok"]
            for s in (0, 1):
                pubs = [0] + [t for t in range(1, i + 1) if t % 2 == s]
                older = [t for t in pubs if t <= ts]
                want_ok = bool(older) and older[-1] in pubs[-2:]
                assert bool(ok[s]) == want_ok, (i, ts, s)
                if want_ok:
                    assert int(steps[s]) == older[-1], (i, ts, s)


@pytest.mark.parametrize("name", [f"wf_script/{i}"
                                  for i in range(len(WF_SCRIPTS))])
def test_wf_script_matches_oracle(name, port_runs):
    """test_wf_writable_linearizable_vs_oracle: the port's run equals the
    sequential oracle with help-point semantics (the final help
    mirrored)."""
    from repro_torch.core import wf_writable as wf
    out = port_runs(name)
    names = ["load", "begin_store", "store", "help", "cas"]
    script = []
    for kind, s, (e, v) in zip(out["kinds"], out["slots"], out["vals"]):
        op = names[int(kind)]
        script.append({"load": ("load", int(s)), "help": ("help",),
                       "cas": ("cas", int(s), e, v)}.get(
                           op, (op, int(s), v)))
    script.append(("help",))
    ref_vals, ref_outs = wf.oracle_apply(out["vals0"], script)
    np.testing.assert_array_equal(out["state/z_value"], ref_vals)
    assert len(out["results"]) == len(ref_outs)
    for got, want in zip(out["results"], ref_outs):
        if isinstance(want, bool):
            assert bool(got[0]) == want
        else:
            np.testing.assert_array_equal(got, want)


def test_wf_batches_match_oracle(port_runs):
    """`store_batch` with duplicate slots is the lanes' stores in lane
    order (the last per slot wins), `cas_batch` the lanes' CASes in lane
    order after helping: `oracle_apply` on the same script."""
    from repro_torch.core import wf_writable as wf
    out = port_runs("wf_batches")
    vals = out["vals0"]
    for i in range(2):
        assert len(set(out[f"store{i}/slots"].tolist())) < \
            len(out[f"store{i}/slots"])
        vals, _ = wf.oracle_apply(vals, [
            ("store", int(s), v) for s, v in zip(out[f"store{i}/slots"],
                                                 out[f"store{i}/vals"])])
        np.testing.assert_array_equal(out[f"store{i}/z_value"], vals)
        assert not (out[f"store{i}/z_mark"] != out[f"store{i}/w_mark"]).any()
    vals, oks = wf.oracle_apply(vals, [
        ("cas", int(s), e, d) for s, e, d in zip(
            out["cas/slots"], out["cas/expected"], out["cas/desired"])])
    np.testing.assert_array_equal(out["cas/z_value"], vals)
    np.testing.assert_array_equal(out["cas/ok"], oks)
    assert 0 < np.asarray(oks).sum() < len(oks)


def test_store_batch_last_lane_wins_past_the_pool():
    """More lanes than pool nodes: nodes repeat, and each repeated node
    and each slot keeps its last lane, as lane order says."""
    from repro_torch.core import wf_writable as wf
    st = wf.init(n=3, k=1, p_max=2, device="cpu")          # m = 4 nodes
    slots = torch.tensor([0, 1, 2, 0, 1, 2], dtype=torch.int32)
    vals = np.arange(1, 7, dtype=np.uint32)[:, None]
    st = wf.store_batch(st, slots, vals)
    # lanes 3..5 wrote nodes 3, 0, 1 last; slots 0, 1, 2 point at them
    assert st.w_node.tolist() == [3, 0, 1]
    assert st.z_value[:, 0].tolist() == [4, 5, 6]
    assert int(st.pool_next) == 6


def test_wf_functions_leave_their_input_state():
    from repro_torch.core import wf_writable as wf
    st = wf.init(n=4, k=2, device="cpu")
    st = wf.begin_store(st, 1, [3, 4])
    before = [x.clone() for x in st]
    wf.help_write(st)
    wf.store(st, 2, [1, 1])
    wf.cas_batch(st, torch.tensor([1]), [[0, 0]], [[5, 5]])
    wf.store_batch(st, torch.tensor([1, 1, 3]), np.ones((3, 2), np.uint32))
    for a, b in zip(st, before):
        assert torch.equal(a, b)


def test_multiversion_tree_map_and_no_host_read_publish(monkeypatch):
    """`tree_map` keeps dict / list / tuple / NamedTuple structure, and
    `publish` and `snapshot` read nothing back to the host on the kernel
    tier (but for `slow_round`'s plain version, which reads its round
    count where the kernel does not; its reads are not counted)."""
    from repro_torch.core import multiversion as mv
    from repro_torch.kernels import engine_round as ter
    monkeypatch.setenv("BIGATOMIC_ENGINE_KERNEL", "pallas")
    state = {"a": [torch.ones(2), (torch.zeros(3),)],
             "b": mv.Snapshot(torch.ones(1), torch.zeros(1), torch.zeros(1),
                              torch.zeros(1))}
    doubled = mv.tree_map(lambda x: x * 2, state)
    assert isinstance(doubled["a"][1], tuple)
    assert isinstance(doubled["b"], mv.Snapshot)
    assert doubled["a"][0].tolist() == [2.0, 2.0]
    store = mv.init_store(state, n_slots=2)
    reads = []
    slow = ter.slow_round

    def quiet_slow(*a, **kw):
        n = len(reads)
        out = slow(*a, **kw)
        del reads[n:]
        return out

    for name in ("__bool__", "__int__", "__index__", "__float__", "item",
                 "tolist", "numpy"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, _name=name, **kw):
            reads.append(_name)
            return _orig(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, counted)
    monkeypatch.setattr(ter, "slow_round", quiet_slow)
    store = mv.publish(store, doubled, torch.tensor(3))
    snap = mv.snapshot(store)
    calls = list(reads)
    monkeypatch.undo()
    assert calls == [], calls
    assert int(snap.step) == 3 and int(snap.slot) == 1
    assert snap.state["a"][0].tolist() == [2.0, 2.0]
