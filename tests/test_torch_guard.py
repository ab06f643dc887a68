"""The port's integrity-scrub path (`repro_torch.guard`, the digest kernel's
plain version, `runtime.faults.Fault`, `runtime.executor.LocalTarget`)
against the JAX reference, on the CPU.

  * invariant parity: the port's `check_invariants` masks equal
    `repro.guard.invariants.check_invariants` bit for bit, for every
    layout, clean and with each invariant broken;
  * digest parity: `digest_rows_plain` equals the reference's `_digest_xla`,
    `_digest_pallas(interpret=True)` and `digest_np`, and `cell_digest`
    equals `_cell_digest(..., "xla" | "pallas", True)`, bit for bit;
  * inject parity: the same `Fault` and seed give the same `info` and the
    same state bits;
  * scrub parity: one subprocess installs the jax alias the reference's
    `cell_digest` needs on this jax and runs a seeded scenario (checkpoint,
    STORE batch, baseline, eight faults, scrub, `mask_ops`, two more
    scrubs) over the reference's `LocalTarget` / `Scrubber`; the port runs
    the same scenario source here and must give the same reports (all
    fields but `latency_s`), the same planes after repair and the same
    results.

Tolerance is zero: words compare as uint32 bit patterns.  States of the
node-pool layouts see fewer than 2 * p_max allocations, below which the
port's node ring equals the reference's (ROADMAP.md, Queue 3).
"""

import functools
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core.layout import TableState as JTableState
from repro.core.specs import AtomicSpec as JSpec
from repro.guard import inject as jinject
from repro.guard.invariants import check_invariants as jcheck_invariants
from repro.guard.scrub import _cell_digest, _digest_pallas, _digest_xla
from repro.guard.scrub import digest_np as jdigest_np
from repro.runtime.faults import Fault as JFault

from repro_torch import atomics, convert
from repro_torch import kernels as tk
from repro_torch.core import engine
from repro_torch.guard import inject, invariants
from repro_torch.guard.scrub import (FNV_OFFSET, FNV_PRIME, Scrubber,
                                     cell_digest, digest_np, scrub)
from repro_torch.kernels.scrub_digest import digest_rows, digest_rows_plain
from repro_torch.runtime import DATA_KINDS, SCHED_KINDS, Fault, LocalTarget

ROOT = Path(__file__).resolve().parents[1]
LAYOUTS = ("plain", "simplock", "seqlock", "indirect", "cached_wf",
           "cached_me")
N, K, P_MAX = 16, 3, 8


# ---------------------------------------------------------------------------
# Seeded states, carried to both packages as numpy.
# ---------------------------------------------------------------------------

def port_state(strategy, seed):
    """A port state from seeded data after one STORE batch to five
    distinct cells, cell 5 among them (so cached_me holds tagged nulls and
    the node pools have moved), and its spec."""
    spec = atomics.AtomicSpec(N, K, strategy, p_max=P_MAX)
    rng = np.random.default_rng(seed)
    init = rng.integers(0, 2 ** 32, (N, K), dtype=np.uint32)
    state = atomics.init(spec, init, device="cpu")
    slots = np.r_[5, rng.choice(np.delete(np.arange(N), 5), 4,
                                replace=False)]
    desired = rng.integers(0, 2 ** 32, (5, K), dtype=np.uint32)
    state, *_ = atomics.apply(spec, state, atomics.stores(
        slots, desired, k=K, device="cpu"))
    return spec, state


def to_jax(state):
    return JTableState(*(jnp.asarray(x) for x in convert.to_numpy(state)))


def assert_same_state(port, ref, label):
    for f, got, want in zip(JTableState._fields, convert.to_numpy(port),
                            ref):
        want = np.asarray(want)
        assert got.dtype == want.dtype, f"{label}: {f} dtype"
        np.testing.assert_array_equal(got, want, err_msg=f"{label}: {f}")


def masks_np(masks):
    return {name: np.asarray(m) for name, m in masks.items()}


def assert_same_masks(port_masks, ref_masks, label):
    port_masks = {name: m.numpy() for name, m in port_masks.items()}
    ref_masks = masks_np(ref_masks)
    assert sorted(port_masks) == sorted(ref_masks), label
    for name in ref_masks:
        np.testing.assert_array_equal(port_masks[name], ref_masks[name],
                                      err_msg=f"{label}: {name}")


# ---------------------------------------------------------------------------
# Invariants.
# ---------------------------------------------------------------------------

# (layout, fault fields) breaking each invariant the layout has
BREAKS = [
    ("seqlock", dict(field="version", bit=0), "version_parity"),
    ("simplock", dict(field="version", bit=0), "version_parity"),
    ("indirect", dict(field="bptr", bit=20), "pointer_range"),
    ("indirect", dict(field="pool", word=0, bit=7), "shadow_agrees"),
    ("cached_wf", dict(field="bptr", bit=20), "pointer_range"),
    ("cached_wf", dict(field="pool", word=1, bit=31), "cache_matches_backup"),
    ("cached_me", dict(field="bptr", bit=3), "tagged_null"),
    ("cached_me", dict(field="version", bit=1), "tagged_null"),
]


@pytest.mark.parametrize("strategy", LAYOUTS)
def test_invariants_clean_match_reference(strategy):
    spec, state = port_state(strategy, 1)
    jspec = JSpec(N, K, strategy, P_MAX)
    port = invariants.check_invariants(spec, state)
    assert_same_masks(port, jcheck_invariants(jspec, to_jax(state)),
                      strategy)
    assert not invariants.violation_mask(spec, state).any()


@pytest.mark.parametrize("strategy,fields,name", BREAKS)
def test_invariants_broken_by_fault_match_reference(strategy, fields, name):
    spec, state = port_state(strategy, 2)
    jspec = JSpec(N, K, strategy, P_MAX)
    jstate = to_jax(state)
    rng_p, rng_j = np.random.default_rng(3), np.random.default_rng(3)
    bad, _ = inject.inject_table_fault(
        spec, state, Fault(round=1, kind="bit_flip", slot=5, **fields), rng_p)
    jbad, _ = jinject.inject_table_fault(
        jspec, jstate, JFault(round=1, kind="bit_flip", slot=5, **fields),
        rng_j)
    port = invariants.check_invariants(spec, bad)
    assert_same_masks(port, jcheck_invariants(jspec, jbad), strategy)
    assert port[name].nonzero().flatten().tolist() == [5]
    assert invariants.violation_mask(spec, bad).nonzero().flatten() \
        .tolist() == [5]


@pytest.mark.parametrize("strategy,fields,name", BREAKS + [
    ("indirect", dict(field="bptr", bit=31), "pointer_range"),
    ("indirect", dict(field="bptr", bit=3), "shadow_agrees")])
def test_cell_digest_of_corrupted_state_matches_reference(strategy, fields,
                                                          name):
    """A pointer out of range (or negative) reads the node the reference's
    clamped gather reads, so the digests agree."""
    spec, state = port_state(strategy, 2)
    jspec = JSpec(N, K, strategy, P_MAX)
    fault = dict(round=1, kind="bit_flip", slot=5, **fields)
    bad, _ = inject.inject_table_fault(spec, state, Fault(**fault),
                                       np.random.default_rng(3))
    jbad, _ = jinject.inject_table_fault(jspec, to_jax(state),
                                         JFault(**fault),
                                         np.random.default_rng(3))
    np.testing.assert_array_equal(
        convert.array(cell_digest(spec, bad), word=True),
        np.asarray(_cell_digest(jspec, jbad, "xla", True)))
    assert invariants.check_invariants(spec, bad)[name][5]


@pytest.mark.parametrize("strategy,field", [("simplock", "lock"),
                                            ("cached_wf", "mark")])
def test_invariants_no_fault_reaches_match_reference(strategy, field):
    """lock_released and mark_clear: set the word directly."""
    spec, state = port_state(strategy, 4)
    jspec = JSpec(N, K, strategy, P_MAX)
    arrays = list(convert.to_numpy(state))
    i = JTableState._fields.index(field)
    arrays[i] = arrays[i].copy()
    arrays[i][[2, 9]] = 1
    bad = convert.table_state(arrays, "cpu")
    port = invariants.check_invariants(spec, bad)
    assert_same_masks(port, jcheck_invariants(
        jspec, JTableState(*(jnp.asarray(x) for x in arrays))), strategy)
    name = "lock_released" if field == "lock" else "mark_clear"
    assert port[name].nonzero().flatten().tolist() == [2, 9]


# ---------------------------------------------------------------------------
# Digest.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 3, 4, 5, 16])
def test_digest_matches_reference_twins(k):
    rng = np.random.default_rng(10 + k)
    n = 37                                        # not a multiple of 8
    vals = rng.integers(0, 2 ** 32, (n, k), dtype=np.uint32)
    ver = rng.integers(0, 2 ** 32, n, dtype=np.uint32)
    vals[0] = 0
    ver[1] = 2 ** 32 - 1
    got = convert.array(digest_rows_plain(
        convert.tensor(vals, "cpu", word=True),
        convert.tensor(ver, "cpu", word=True)), word=True)
    np.testing.assert_array_equal(got, np.asarray(_digest_xla(
        jnp.asarray(vals), jnp.asarray(ver))))
    np.testing.assert_array_equal(got, np.asarray(_digest_pallas(
        jnp.asarray(vals), jnp.asarray(ver), interpret=True)))
    np.testing.assert_array_equal(got, jdigest_np(vals, ver))
    np.testing.assert_array_equal(got, digest_np(vals, ver))
    before = tk.launch_counts()
    wrapped = digest_rows(convert.tensor(vals, "cpu", word=True),
                          convert.tensor(ver, "cpu", word=True))
    np.testing.assert_array_equal(convert.array(wrapped, word=True), got)
    assert tk.launch_counts() == before         # the CPU runs the plain one


@pytest.mark.parametrize("strategy", LAYOUTS)
@pytest.mark.parametrize("ref_mode", ["xla", "pallas"])
def test_cell_digest_matches_reference(strategy, ref_mode):
    """Every layout digests through `digest_rows`; the reference's digest
    is the same in both of its tiers (Pallas in interpret mode)."""
    spec, state = port_state(strategy, 5)
    want = np.asarray(_cell_digest(JSpec(N, K, strategy, P_MAX),
                                   to_jax(state), ref_mode, True))
    got = cell_digest(spec, state)
    assert got.dtype == torch.int32 and got.shape == (N,)
    np.testing.assert_array_equal(convert.array(got, word=True), want)


def test_fnv_constants_and_wrapper_checks():
    assert (int(FNV_OFFSET), int(FNV_PRIME)) == (2166136261, 16777619)
    with pytest.raises(ValueError, match="ver"):
        digest_rows(torch.zeros((4, 2), dtype=torch.int32),
                    torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="vals"):
        digest_rows(torch.zeros((4, 2), dtype=torch.int64),
                    torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="unsupported device"):
        digest_rows(torch.zeros((4, 2), dtype=torch.int32, device="meta"),
                    torch.zeros(4, dtype=torch.int32, device="meta"))


# ---------------------------------------------------------------------------
# Inject.
# ---------------------------------------------------------------------------

INJECT_CASES = [(s, "torn_write", {}) for s in LAYOUTS] + \
    [(s, "torn_write", {"words": 1}) for s in ("seqlock", "indirect")] + \
    [(s, "bit_flip", {}) for s in LAYOUTS] + \
    [(s, "bit_flip", {"field": f}) for s in LAYOUTS
     for f in ("data", "version", "pool", "bptr")
     if not (f == "bptr" and s in ("plain", "simplock", "seqlock"))] + \
    [("seqlock", "bit_flip", {"word": K, "bit": 31})]


@pytest.mark.parametrize("strategy,kind,fields", INJECT_CASES)
def test_inject_table_fault_matches_reference(strategy, kind, fields):
    """Eight seeds each: the same info dict and the same state bits, or
    the same error (field="pool" on a layout without a node pointer)."""
    spec, state = port_state(strategy, 6)
    jspec = JSpec(N, K, strategy, P_MAX)
    jstate = to_jax(state)
    before = convert.to_numpy(state)
    for seed in range(8):
        fault = dict(round=1, kind=kind, **fields)
        try:
            got, info = inject.inject_table_fault(
                spec, state, Fault(**fault), np.random.default_rng(seed))
        except IndexError:           # a layout with no pointer to follow
            with pytest.raises(IndexError):
                jinject.inject_table_fault(jspec, jstate, JFault(**fault),
                                           np.random.default_rng(seed))
            assert fields.get("field") == "pool"
            continue
        want, jinfo = jinject.inject_table_fault(
            jspec, jstate, JFault(**fault), np.random.default_rng(seed))
        assert info == jinfo, (seed, info, jinfo)
        assert_same_state(got, want, f"{strategy} seed {seed}")
    for x, y in zip(convert.to_numpy(state), before):
        np.testing.assert_array_equal(x, y)      # the input is untouched


@pytest.mark.parametrize("kind,fields", [
    ("bit_flip", {}), ("bit_flip", {"word": 2}), ("bit_flip", {"word": K}),
    ("torn_write", {}), ("torn_write", {"words": K})])
def test_inject_snapshot_fault_matches_reference(kind, fields):
    rng = np.random.default_rng(7)
    snap = {"logical": rng.integers(0, 2 ** 32, (N, K), dtype=np.uint32),
            "versions": (rng.integers(0, 8, N) * 2).astype(np.uint32)}
    port_snap = convert.snapshot(snap, "cpu")
    for seed in range(8):
        fault = dict(round=1, kind=kind, **fields)
        got, info = inject.inject_snapshot_fault(
            port_snap, Fault(**fault), np.random.default_rng(seed))
        want, jinfo = jinject.inject_snapshot_fault(
            snap, JFault(**fault), np.random.default_rng(seed))
        assert info == jinfo
        for f in ("logical", "versions"):
            np.testing.assert_array_equal(
                convert.array(got[f], word=True), want[f])
    np.testing.assert_array_equal(
        convert.array(port_snap["logical"], word=True), snap["logical"])


def test_faults_reject_what_the_reference_rejects():
    assert SCHED_KINDS == ("delay", "preempt", "shard_loss")
    assert "bit_flip" in DATA_KINDS and Fault(1, "torn_write").data_plane
    assert not Fault(1, "preempt").data_plane
    with pytest.raises(ValueError, match="unknown fault kind"):
        Fault(1, "meteor")
    with pytest.raises(ValueError, match="stream"):
        Fault(1, "delay")
    spec, state = port_state("seqlock", 8)
    with pytest.raises(ValueError, match="not a state fault"):
        inject.inject_table_fault(spec, state, Fault(1, "preempt"),
                                  np.random.default_rng(0))


# ---------------------------------------------------------------------------
# Scrub and Scrubber: one scenario, run by both packages.
# ---------------------------------------------------------------------------

SCENARIO = textwrap.dedent("""
    import numpy as np

    def run_scenario(api, strategy, seed):
        '''checkpoint; a STORE batch; baseline; eight seeded faults, half on
        dirty cells; a standalone scrub and the Scrubber's; mask_ops on a
        batch aimed at the quarantined cells; a scrub against a fresh
        baseline and one against the first.  Returns JSON-able results.'''
        n, k, p_max = 64, 3, 16
        STORE, LOAD = 1, 0
        words = api["words"]
        spec = api["AtomicSpec"](n, k, strategy, p_max=p_max)
        rng = np.random.default_rng(seed)
        initial = rng.integers(0, 2 ** 32, (n, k), dtype=np.uint32)
        target = api["LocalTarget"](spec, initial)
        scrubber = api["Scrubber"](spec)
        out = {}
        scrubber.set_checkpoint(target.snapshot())
        dirty = rng.choice(n, 8, replace=False)
        desired = rng.integers(0, 2 ** 32, (8, k), dtype=np.uint32)
        ops = api["make_ops"](np.full(8, STORE), dirty, None, desired, k)
        h = target.issue(ops, None)
        scrubber.note_results(ops, h.result.success)
        baseline = scrubber.digest_of(target)
        out["baseline"] = words(baseline).tolist()
        clean = np.setdiff1d(np.arange(n), dirty)
        victims = np.concatenate([rng.choice(dirty, 4, replace=False),
                                  rng.choice(clean, 4, replace=False)])
        out["infos"] = []
        for i, slot in enumerate(victims):
            kind = "bit_flip" if i % 2 == 0 else "torn_write"
            fault = api["Fault"](round=1, kind=kind, slot=int(slot))
            target.state, info = api["inject_table_fault"](
                spec, target.state, fault,
                np.random.default_rng([seed, i]))
            out["infos"].append(info)
        out["standalone"] = api["scrub"](spec, target.state,
                                         baseline=baseline).to_json()
        out["standalone_invariants_only"] = api["scrub"](
            spec, target.state).to_json()
        out["r1"] = scrubber.scrub(target, round_idx=1,
                                   baseline=baseline).to_json()
        snap = target.snapshot()
        out["logical1"] = words(snap["logical"]).tolist()
        out["versions1"] = words(snap["versions"]).tolist()
        aim = np.concatenate([victims, rng.choice(clean, 6, replace=False)])
        kind = np.where(rng.random(len(aim)) < 0.5, STORE, LOAD)
        desired = rng.integers(0, 2 ** 32, (len(aim), k), dtype=np.uint32)
        ops = api["make_ops"](kind, aim, None, desired, k)
        masked, bad = scrubber.mask_ops(ops)
        out["bad"] = None if bad is None else np.asarray(
            api["bools"](bad)).tolist()
        h = target.issue(masked, None)
        out["value"] = words(h.result.value).tolist()
        out["success"] = np.asarray(api["bools"](h.result.success)).tolist()
        scrubber.note_results(masked, h.result.success)
        out["r2"] = scrubber.scrub(target, round_idx=2,
                                   baseline=scrubber.digest_of(target)
                                   ).to_json()
        out["r3"] = scrubber.scrub(target, round_idx=3,
                                   baseline=baseline).to_json()
        snap = target.snapshot()
        out["logical3"] = words(snap["logical"]).tolist()
        out["versions3"] = words(snap["versions"]).tolist()
        for r in ("standalone", "standalone_invariants_only", "r1", "r2",
                  "r3"):
            del out[r]["latency_s"]
        return out
""")

_JAX_SCRIPT = textwrap.dedent("""
    import json, sys
    import numpy as np
    from jax.experimental.pallas import tpu as pltpu
    if not hasattr(pltpu, "TPUMemorySpace"):   # renamed in newer jax
        pltpu.TPUMemorySpace = pltpu.MemorySpace
    from repro.core import engine
    from repro.core.specs import AtomicSpec
    from repro.guard.inject import inject_table_fault
    from repro.guard.scrub import Scrubber, scrub
    from repro.runtime.executor import LocalTarget
    from repro.runtime.faults import Fault

    api = dict(
        AtomicSpec=lambda n, k, s, p_max: AtomicSpec(n, k, s, p_max),
        LocalTarget=LocalTarget, Scrubber=Scrubber, scrub=scrub,
        inject_table_fault=inject_table_fault, Fault=Fault,
        make_ops=lambda kind, slot, exp, des, k: engine.make_ops(
            kind, slot, exp, des, k=k),
        words=lambda x: np.asarray(x, np.uint32),
        bools=lambda x: np.asarray(x, bool))
    exec(sys.argv[1])
    strategies = json.loads(sys.argv[2])
    print(json.dumps({s: run_scenario(api, s, 100 + i)
                      for i, s in enumerate(strategies)}))
""")


def host_ops(kind, slot, expected=None, desired=None, k=2):
    """A checked op batch as the host (numpy) arrays the scrubber's
    `mask_ops` / `note_results` and `LocalTarget.issue` take."""
    return engine.OpBatch(*convert.to_numpy(engine.make_ops(
        kind, slot, expected, desired, k=k, device="cpu")))


def port_api():
    return dict(
        AtomicSpec=atomics.AtomicSpec,
        LocalTarget=functools.partial(LocalTarget, device="cpu"),
        Scrubber=functools.partial(Scrubber, device="cpu"), scrub=scrub,
        inject_table_fault=inject.inject_table_fault, Fault=Fault,
        make_ops=host_ops,
        words=lambda x: convert.array(x, word=True),
        bools=lambda x: np.asarray(x, bool))


@pytest.fixture(scope="module")
def jax_scenarios():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_SCRIPT, SCENARIO, json.dumps(LAYOUTS)],
        env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("strategy", LAYOUTS)
def test_scrubber_scenario_matches_reference(jax_scenarios, strategy):
    scope = {}
    exec(SCENARIO, scope)
    before = tk.launch_counts()
    got = json.loads(json.dumps(scope["run_scenario"](
        port_api(), strategy, 100 + LAYOUTS.index(strategy))))
    want = jax_scenarios[strategy]
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key] == want[key], f"{strategy}: {key}"
    assert tk.launch_counts() == before
    # the scenario does what it says: 8 detections, 4 repaired (clean
    # cells), 4 quarantined (dirty ones), then a clean scrub
    r1 = got["r1"]
    assert len(r1["detected"]) == 8 and len(r1["repaired"]) == 4
    assert len(r1["quarantined"]) == 4 and r1["poisoned_total"] == 4
    assert got["r2"]["clean"] and got["r2"]["poisoned_total"] == 4
    # a quarantined cell whose corruption the reload erased (a cached_wf
    # backup flip) matches the first baseline again
    assert got["r3"]["contained"]
    assert set(got["r3"]["contained"]) <= set(r1["quarantined"])
    assert sum(got["bad"]) == 4
    assert not any(s for s, b in zip(got["success"], got["bad"]) if b)


def test_scrubber_tracks_dirty_cells_on_device():
    """Host ops and results mark the host `dirty` mask; `mask_ops` masks
    host ops against the host copy of the device `poison`."""
    spec = atomics.AtomicSpec(8, 2, "cached_me", p_max=4)
    sc = Scrubber(spec, device="cpu")
    assert sc.dirty.all() and isinstance(sc.dirty, np.ndarray)
    assert sc.poison.device.type == "cpu"
    target = LocalTarget(spec, device="cpu")
    sc.set_checkpoint(target.snapshot())
    assert not sc.dirty.any()
    ops = host_ops([1, 2, 0, 1], [3, 5, 6, 3], None,
                   np.ones((4, 2), np.uint32))
    sc.note_results(ops, np.array([True, False, True, True]))
    assert np.flatnonzero(sc.dirty).tolist() == [3]
    sc.note_untracked()
    assert sc.dirty.all()
    masked, bad = sc.mask_ops(ops)
    assert bad is None and masked.kind.tolist() == [1, 2, 0, 1]
    sc.poison[3] = sc.poison_host[3] = True
    masked, bad = sc.mask_ops(host_ops([1, 3, 0], [3, 3, 99]))
    assert bad.tolist() == [True, False, False]   # IDLE stays; 99 clamps
    assert masked.kind.tolist() == [engine.IDLE, engine.IDLE, 0]


def test_local_target_snapshot_and_load_copy():
    spec = atomics.AtomicSpec(8, 2, "seqlock", p_max=4)
    target = LocalTarget(spec, np.arange(16, dtype=np.uint32).reshape(8, 2),
                         device="cpu")
    assert (target.kind, target.width, target.n_shards) == ("local", 8, 1)
    snap = target.snapshot()
    target.issue(host_ops([1], [1], None, [[7, 7]]), None)
    assert snap["logical"][1].tolist() == [2, 3]        # a copy
    target.load(snap)
    target.issue(host_ops([1], [2], None, [[9, 9]]), None)
    assert snap["logical"][2].tolist() == [4, 5]        # never aliased
    assert int(target.state.version[2]) == 2
    with pytest.raises(RuntimeError, match="fatal"):
        target.shrink(1)


def test_entry_points_default_to_cuda():
    spec = atomics.AtomicSpec(4, 2, "seqlock", p_max=2)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is usable")
    for make in (lambda: LocalTarget(spec), lambda: Scrubber(spec),
                 lambda: convert.snapshot({"logical": np.zeros((4, 2)),
                                           "versions": np.zeros(4)})):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


# ---------------------------------------------------------------------------
# `read` on a corrupt `bptr`.
# ---------------------------------------------------------------------------

# (layout, bit of bptr[5] flipped): indirect / cached_wf pointers past the
# pool (bit 20) or negative below -m (bit 31); cached_me's tagged null made
# a huge node index (bit 31) or another negative tag (bit 3)
BPTR_FAULTS = [("indirect", 20), ("indirect", 31), ("cached_wf", 20),
               ("cached_wf", 31), ("cached_me", 31), ("cached_me", 3)]
READ_N, READ_K, READ_P = 16, 2, 4

_READ_SCRIPT = textwrap.dedent("""
    import json, sys
    import numpy as np
    from jax.experimental.pallas import tpu as pltpu
    if not hasattr(pltpu, "TPUMemorySpace"):   # renamed in newer jax
        pltpu.TPUMemorySpace = pltpu.MemorySpace
    import jax.numpy as jnp
    from repro.core import engine
    from repro.core.layout import TableState
    from repro.core.specs import AtomicSpec
    from repro.guard.inject import inject_table_fault
    from repro.runtime.faults import Fault

    arrays = np.load(sys.argv[1])
    out = {}
    for name in sorted({key.split("/")[0] for key in arrays}):
        strategy, bit = name.split(":")[:2]
        spec = AtomicSpec(%(n)d, %(k)d, strategy, %(p)d)
        state = TableState(*(jnp.asarray(arrays[f"{name}/{f}"])
                             for f in TableState._fields))
        bad, _ = inject_table_fault(
            spec, state, Fault(round=0, kind="bit_flip", slot=5,
                               field="bptr", bit=int(bit)),
            np.random.default_rng(0))
        vals, ok = engine.read(spec, bad, jnp.arange(%(n)d))
        out[name] = {"vals": np.asarray(vals, np.uint32).tolist(),
                     "ok": np.asarray(ok, bool).tolist(),
                     "bptr5": int(bad.bptr[5])}
    print(json.dumps(out))
""" % dict(n=READ_N, k=READ_K, p=READ_P))


def read_states():
    """For each fault: the state of ROADMAP's report (`init` from seeded
    data), and the same state with the node pool filled with seeded words,
    so that every node index reads a different row."""
    out = {}
    for i, (strategy, bit) in enumerate(BPTR_FAULTS):
        spec = atomics.AtomicSpec(READ_N, READ_K, strategy, p_max=READ_P)
        rng = np.random.default_rng(40 + i)
        init = rng.integers(0, 2 ** 32, (READ_N, READ_K), dtype=np.uint32)
        arrays = list(convert.to_numpy(atomics.init(spec, init,
                                                    device="cpu")))
        out[f"{strategy}:{bit}:init"] = arrays
        pool = JTableState._fields.index("pool")
        arrays = list(arrays)
        arrays[pool] = rng.integers(0, 2 ** 32, arrays[pool].shape,
                                    dtype=np.uint32)
        out[f"{strategy}:{bit}:pool"] = arrays
    return out


@pytest.fixture(scope="module")
def jax_reads(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_read")
    np.savez(tmp / "in.npz", **{
        f"{name}/{f}": a for name, arrays in read_states().items()
        for f, a in zip(JTableState._fields, arrays)})
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _READ_SCRIPT, str(tmp / "in.npz")],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("variant", ["init", "pool"])
@pytest.mark.parametrize("strategy,bit", BPTR_FAULTS)
def test_read_of_corrupt_bptr_matches_reference(jax_reads, strategy, bit,
                                                variant):
    """`read` after a `bptr` bit flip on slot 5 reads the node the
    reference's gather reads (a negative pointer counts from the end on
    indirect / cached_wf, cached_me takes max(bptr, 0), and every index
    is clamped into the pool), bit for bit, and raises nothing."""
    name = f"{strategy}:{bit}:{variant}"
    spec = atomics.AtomicSpec(READ_N, READ_K, strategy, p_max=READ_P)
    state = convert.table_state(read_states()[name], "cpu")
    bad, _ = inject.inject_table_fault(
        spec, state, Fault(round=0, kind="bit_flip", slot=5, field="bptr",
                           bit=bit), np.random.default_rng(0))
    want = jax_reads[name]
    assert int(bad.bptr[5]) == want["bptr5"]
    vals, ok = atomics.read(spec, bad, torch.arange(READ_N))
    np.testing.assert_array_equal(convert.array(vals, word=True),
                                  np.asarray(want["vals"], np.uint32))
    assert ok.tolist() == want["ok"]
