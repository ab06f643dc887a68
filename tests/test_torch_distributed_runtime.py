"""The port's sharded runtime (`repro_torch.runtime.DistTarget`, shard-loss
recovery with journal replay, `runtime.elastic` and the placement half of
`repro_torch.dist`) against the reference's live `DistTarget` runs, the
shared oracles and the port's own replay.

Every case runs once on ONE world of 8 gloo ranks (`torch_dist_world.py`,
each rank running the same `Executor` over the same streams, the
single-controller form) beside ONE reference subprocess on 8 fake XLA
host devices that runs the cases marked `ref`:

  executor     `tests/dist_checks.py`'s `executor` scenario: n = 32, k = 2,
               p_global 32, `seqlock` and `cached_wf`, S = 2, 4, 8 streams
               of 3 batches, the mesh (s, 8 // s) halving on a shard loss,
               a `shard_loss` of shard 5 at round 2 after one issue,
               `checkpoint_every=2`, plus a `delay` fault under the
               watchdog and a tick clock in both packages' Recorders.  All
               8 ranks' records are identical, and each issue (stream, seq,
               ops, claimed order, overflow, value, success), the
               recoveries (but `latency_s`), the checkpoints, the flags,
               the final table and the width equal the reference's bit for
               bit; `runtime.replay_history` and
               `tests/oracle.replay_executor_history` replay it.
  twolevel     n_nodes = 2 (mesh (2, 4) ("node", "shard")), S = 4, no
               fault, against the reference the same way.
  elastic      `reshard_dist` 8 -> 6 -> 4 -> 8 at n = 48: values and
               versions equal the reference's at every hop, ranks 6-7 hold
               no shard of the 6- and 4-rank meshes, and an LL link taken
               before the trip commits after it.
  train        deepseek_7b reduced's train state through `elastic_mesh(n,
               model_parallel=2, global_batch=2)` + `reshard_state` for
               n = 8, 6, 4, 8: every leaf's placement equals the
               reference's `param_shardings` spec, and every leaf gathered
               at the end equals the initial one bit for bit.
  lockstep     plants on one rank alone: its preemption flag (every rank
               stops at the same round boundary), its clock making a stream
               slow (every rank's watchdog flags it), its issue raising
               once in its host preparation (every rank rolls the batch
               back; a shard loss at round 3 follows, restored from the
               round-2 checkpoint); every rank ends in the same state.
  disk         a guarded run (BIGATOMIC_GUARD=on, a bit flip the scrub
               repairs from the last checkpoint) with disk checkpoints,
               one writer, and a
               `ckpt_corrupt` of the newest step: a fresh executor resumes
               past it (the CRC fallback) on every rank and ends equal.

Beside the world, a world of two in which one rank's issue fails inside
its round (past the issue's agreement) must end with an error on the
other rank within the group's 5 s timeout, never by the test's kill.
`mesh_plan` is checked against the reference's in process.
"""

import pickle
import types
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import torch_dist_world as W
from repro_torch import atomics
from repro_torch.core import distributed as dsb
from torch_threads import one_thread  # noqa: F401

EXEC_STRATEGIES = ("seqlock", "cached_wf")
EXEC = [f"executor/{st}/S{s}" for st in EXEC_STRATEGIES for s in (2, 4, 8)]
TWO_LEVEL = ["twolevel/cached_me/S4"]
ELASTIC = ["elastic/seqlock", "elastic/cached_wf"]
LOCKSTEP = ["lockstep/preempt", "lockstep/clock", "lockstep/raise"]
DISK = "disk/cached_me"
N, K, P_GLOBAL = 32, 2, 32
HOPS = (8, 6, 4, 8)
SHARD_LOSS = dict(round=2, kind="shard_loss", shard=5, after_issues=1)
DELAY = dict(round=1, kind="delay", stream=0, seconds=0.05, rounds=4)


def _exec_case(name, strategy, s, init, **extra):
    return {"name": name, "kind": "executor", "strategy": strategy, "n": N,
            "k": K, "p_global": P_GLOBAL, "streams": s, "n_batches": 3,
            "seed": 1000 + 10 * s, "init": init, "checkpoint_every": 2,
            "watchdog": True, **extra}


def build(tmp):
    cases = []
    for st in EXEC_STRATEGIES:
        # the scenario's draws: one initial table per S, in order
        rng = np.random.default_rng(zlib.crc32(st.encode()) ^ 0xE7)
        for s in (2, 4, 8):
            init = rng.integers(0, 2 ** 32, (N, K), dtype=np.uint32)
            cases.append(_exec_case(f"executor/{st}/S{s}", st, s, init,
                                    faults=[SHARD_LOSS, DELAY], ref=True))
    rng = np.random.default_rng(0x2E11)
    cases.append(_exec_case(TWO_LEVEL[0], "cached_me", 4,
                            rng.integers(0, 2 ** 32, (N, K), dtype=np.uint32),
                            two_level=True, ref=True))
    rng = np.random.default_rng(11)
    init48 = rng.integers(0, 2 ** 32, (48, K), dtype=np.uint32)
    for name in ELASTIC:
        cases.append(dict(name=name, kind="elastic",
                          strategy=name.split("/")[1], n=48, k=K,
                          init=init48, hops=HOPS[1:], ref=True))
    cases.append(dict(name="train", kind="train_elastic", hops=HOPS,
                      ref=True))
    rng = np.random.default_rng(0x10C5)
    init = rng.integers(0, 2 ** 32, (N, K), dtype=np.uint32)
    cases.append(_exec_case("lockstep/preempt", "seqlock", 4, init,
                            faults=[SHARD_LOSS], plant=("preempt", 3, 2)))
    cases.append(_exec_case("lockstep/clock", "seqlock", 4, init,
                            plant=("clock", 2, 1)))
    # the loss after the round-2 checkpoint: its versions are not zero
    cases.append(_exec_case("lockstep/raise", "seqlock", 4, init,
                            faults=[dict(SHARD_LOSS, round=3)],
                            plant=("raise", 5, 3)))
    cases.append(_exec_case(
        DISK, "cached_me", 3, init, n_batches=4, checkpoint_every=3,
        watchdog=False, guard=True, ckdir=str(tmp / "ck_disk"),
        slot_hi=N // 2, hot=(0, 0.0),
        faults=[dict(round=2, kind="bit_flip", slot=N // 2 + 3),
                dict(round=4, kind="ckpt_corrupt")], fault_seed=7))
    return cases


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world beside the reference's run and the two-rank world whose
    issue fails inside its round."""
    tmp = tmp_path_factory.mktemp("dist_runtime")
    cases = build(tmp)
    inputs = tmp / "cases.pkl"
    inputs.write_bytes(pickle.dumps(cases))
    with W.reference("runtime", inputs, tmp / "ref.pkl") as ref, \
            ThreadPoolExecutor(1) as pool:
        failing = pool.submit(_issue_error_world, tmp / "issue_error")
        rcs, tails, seconds = W.run_world("runtime", inputs, tmp / "world",
                                          timeout=240)
        ref_out = W.finish_reference(ref, tmp / "ref.pkl")
    assert not any(rcs), "\n".join(tails)
    return {"cases": {c["name"]: c for c in cases},
            "world": W.load_world(tmp / "world"), "ref": ref_out,
            "issue_error": failing.result()}


def _issue_error_world(tmp):
    case = dict(_exec_case("issue_error", "seqlock", 2, np.zeros(
        (N, K), np.uint32)), watchdog=False)
    tmp.mkdir()
    inputs = tmp / "cases.pkl"
    inputs.write_bytes(pickle.dumps([case]))
    return W.run_world("issue_error", inputs, tmp / "world", world=2,
                       timeout=60, pg_timeout=5)


def _agreed(runs, name, skip=("saves",)):
    """Rank 0's record of `name`, after checking that every rank saw the
    same."""
    recs = [out[name] for out in runs["world"]]
    first = pickle.dumps({k: v for k, v in recs[0].items() if k not in skip})
    for r, rec in enumerate(recs[1:], 1):
        got = pickle.dumps({k: v for k, v in rec.items() if k not in skip})
        assert got == first, f"{name}: rank {r} ended in another state"
    return recs[0]


def _same(a, b, msg):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=msg)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), msg
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{msg}[{i}]")
    else:
        assert a == b, f"{msg}: {a!r} != {b!r}"


def _records(rec):
    """The recorded issues as `IssueRec`-shaped records for the replays."""
    out = []
    for stream, seq, kind, slot, exp, des, order, ovf, value, success \
            in rec["history"]:
        out.append(types.SimpleNamespace(
            stream=stream, seq=seq,
            ops=atomics.OpBatch(kind.view(np.int32), slot.view(np.int32),
                                exp, des),
            order=order, overflow=ovf, value=value, success=success))
    return out


def _replays(runs, name, rec):
    """`runtime.replay_history` and the reference's
    `replay_executor_history` over the whole history, each equal to the
    final table."""
    from oracle import replay_executor_history
    from repro_torch.runtime import replay_history
    case = runs["cases"][name]
    widths = [case["p_global"]] * case["streams"]
    hist = _records(rec)
    for replay in (replay_history, replay_executor_history):
        oracle = replay(case["n"], case["k"], widths, hist,
                        initial=case["init"])
        np.testing.assert_array_equal(np.asarray(oracle.data, np.uint32),
                                      rec["logical"], err_msg=name)
        np.testing.assert_array_equal(np.asarray(oracle.version, np.uint32),
                                      rec["versions"], err_msg=name)


COMPARED = ("history", "recoveries", "checkpoints", "rounds", "issues",
            "stopped", "deprioritized", "flags", "shed", "logical",
            "versions", "width", "n_shards")


@pytest.mark.parametrize("name", EXEC + TWO_LEVEL)
def test_executor_equals_reference_live_run(runs, name):
    """Every rank's history, recovery, checkpoints, flags and final table
    equal the reference's live `DistTarget` run bit for bit."""
    rec = _agreed(runs, name)
    ref = runs["ref"][name]
    for key in COMPARED:
        _same(rec[key], ref[key], f"{name}: {key}")
    assert rec["width"] == P_GLOBAL
    if name in EXEC:
        (recovery,) = rec["recoveries"]
        assert recovery["n_shards"] == 4 and recovery["shard"] == 5
        assert recovery["replayed"] >= 1
        assert rec["n_shards"] == 4
    else:
        assert rec["recoveries"] == [] and rec["n_shards"] == 8


@pytest.mark.parametrize("name", EXEC + TWO_LEVEL)
def test_executor_history_replays(runs, name):
    """The whole history, across the recovery, replays through the port's
    replay and the reference's oracle to the final table."""
    _replays(runs, name, _agreed(runs, name))


def test_watchdog_flags_the_delayed_stream_in_both(runs):
    """The delay fault makes stream 0 slow under the tick clock: the
    watchdog flags it, on every rank and in the reference alike."""
    flagged = [name for name in EXEC if _agreed(runs, name)["flags"]]
    assert flagged, "no case flagged a stream"
    for name in flagged:
        assert all(f == [0] for _, f in _agreed(runs, name)["flags"])
        assert _agreed(runs, name)["deprioritized"] > 0


@pytest.mark.parametrize("name", ELASTIC)
def test_reshard_dist_round_trip(runs, name):
    """8 -> 6 -> 4 -> 8: values and versions equal the reference's at every
    hop on the ranks of the hop's mesh; ranks 6-7 are outside the 6- and
    4-rank meshes; the LL link taken before the trip commits after it."""
    ref = runs["ref"][name]
    recs = [out[name] for out in runs["world"]]
    for r, rec in enumerate(recs):
        for hop, want in zip(rec["hops"], ref["hops"]):
            s = hop["s"]
            assert hop["member"] == (r < s), (r, s)
            if hop["member"]:
                np.testing.assert_array_equal(hop["logical"],
                                              want["logical"])
                np.testing.assert_array_equal(hop["versions"],
                                              want["versions"])
        assert rec["sc_success"] and ref["sc_success"]
        np.testing.assert_array_equal(rec["logical_after"],
                                      ref["logical_after"])
        assert (rec["logical_after"][5] == 55).all()
    assert int(ref["hops"][0]["versions"][7]) == 2


def test_train_state_round_trips_with_reference_placements(runs):
    """Each hop's mesh is the reference's plan, every param leaf's
    placement equals the reference's `param_shardings` spec for the same
    shapes, ranks outside a mesh hold nothing, and every leaf gathered
    after 8 -> 6 -> 4 -> 8 equals the initial one bit for bit."""
    ref = runs["ref"]["train"]
    sharded = 0
    for r, out in enumerate(runs["world"]):
        rec = out["train"]
        for hop, want in zip(rec["hops"], ref["hops"]):
            assert hop["shape"] == want["shape"]
            assert hop["member"] == (r in hop["ranks"])
            assert set(hop["placements"]) == set(ref["shapes"])
            assert hop["placements"] == want["placements"], hop["n"]
            assert all(hop["held"]) if hop["member"] \
                else not any(hop["held"])
            sharded += sum(spec != () for spec in hop["placements"].values())
        if rec["hops"][-1]["member"]:
            assert rec["n_leaves"] > 10 and all(rec["equal"]), r
        else:
            assert "equal" not in rec
    assert sharded > 0


def test_mesh_plan_matches_reference():
    from repro.runtime import elastic as ref_elastic
    from repro_torch.runtime import elastic
    for n in range(1, 17):
        for mp in (1, 2, 3, 4, 8):
            for gb in (None, 1, 2, 6, 8, 12):
                got = elastic.mesh_plan(n, model_parallel=mp,
                                        global_batch=gb)
                want = ref_elastic.mesh_plan(n, model_parallel=mp,
                                             global_batch=gb)
                assert tuple(got) == tuple(want), (n, mp, gb)
    assert elastic.mesh_plan(6, model_parallel=2, global_batch=2).dropped \
        == 4


def test_lockstep_preempt_on_one_rank_stops_every_rank(runs):
    """Rank 3 alone is signalled at round 2: every rank stops at that
    round's boundary, checkpointed, in the same state."""
    rec = _agreed(runs, "lockstep/preempt")
    assert rec["stopped"] and rec["rounds"] == 2
    assert rec["checkpoints"][-1] == 2
    assert rec["recoveries"][0]["n_shards"] == 4
    _replays(runs, "lockstep/preempt", rec)


def test_lockstep_one_slow_clock_flags_on_every_rank(runs):
    """Rank 2 alone measures stream 1 slow: the agreed latencies make
    every rank's watchdog flag stream 1 and skip its next slot."""
    rec = _agreed(runs, "lockstep/clock")
    assert rec["flags"] and all(f == [1] for _, f in rec["flags"])
    assert rec["deprioritized"] > 0
    _replays(runs, "lockstep/clock", rec)


def test_lockstep_one_raising_issue_rolls_back_everywhere(runs):
    """Rank 5's third issue raises in its host preparation: every rank
    rolls the same batch back (one failure, "issue raised"), retries it
    after the backoff and finishes every batch in the same state, across
    a shard loss recovered from the round-2 checkpoint (whose versions
    the reshard must keep for the replay to hold)."""
    rec = _agreed(runs, "lockstep/raise")
    (recovery,) = rec["recoveries"]
    assert recovery["round"] == 3 and 2 in rec["checkpoints"]
    assert len(rec["failures"]) == 1 and \
        rec["failures"][0][2] == "issue raised"
    case = runs["cases"]["lockstep/raise"]
    seqs = {(s, q) for s, q, *_ in rec["history"]}
    assert seqs == {(s, q) for s in range(case["streams"])
                    for q in range(case["n_batches"])}
    assert not rec["shed"]
    _replays(runs, "lockstep/raise", rec)


def test_disk_checkpoint_one_writer_scrub_and_crc_fallback(runs):
    """With `checkpoint_dir` only the mesh's first rank writes; the scrub
    repairs the bit flip (in the half of the table the streams never
    write) on every rank; the `ckpt_corrupt` of the newest
    step (round 3) sends every rank's resume past it to step 0, and the
    resumed run ends in the first run's table on every rank."""
    rec = _agreed(runs, DISK)
    saves = [out[DISK]["saves"] for out in runs["world"]]
    assert saves[0][:2] == [0, 3] and not any(saves[1:]), saves
    kinds = [f["kind"] for f in rec["data_faults"]]
    assert kinds == ["bit_flip", "ckpt_corrupt"]
    assert [sc["repaired"] for sc in rec["scrubs"] if sc["detected"]] \
        == [[N // 2 + 3]]
    assert rec["resumed_round"] == 0
    assert rec["steps_on_disk"] == [0, 3]
    for key in ("logical", "versions"):
        np.testing.assert_array_equal(rec["resumed"][key], rec[key])
    _replays(runs, DISK, rec)


def test_an_error_inside_a_round_ends_every_rank(runs):
    """Rank 1's issue fails inside its round: its executor does not roll
    the batch back alone but ends; rank 0, waiting in the collective rank
    1 never joins, fails at the group's 5 s timeout, well inside the
    world's 60 s."""
    rcs, tails, seconds = runs["issue_error"]
    assert rcs[0] != 0, tails[0]
    assert seconds < 45, seconds
    assert "timed out" in tails[0].lower(), tails[0]
    assert "rank 1 ended its run" in tails[1], tails[1]


def test_entry_points_raise_outside_the_mesh():
    """A rank outside a mesh holds no shard of it: every entry point given
    such a mesh raises before any collective."""
    import torch
    from repro_torch.runtime import DistTarget, reshard_dist
    mesh = dsb.Mesh((2,), ("shard",), None, {}, torch.device("cpu"),
                    ranks=(1, 2))
    assert not mesh.member and mesh.coords == {} and mesh.ranks == (1, 2)
    ts = dsb.DistSpec(atomics.AtomicSpec(16, 2), "shard", 2, 4)
    hs = dsb.DistSpec(atomics.HashSpec(64, vw=1), "shard", 2, 4)
    ops = atomics.make_ops(np.zeros(4, np.int32), np.zeros(4, np.int32),
                           k=2, device="cpu")
    outside = dsb.DistState(None, mesh)
    for call in (lambda: dsb.init_dist(mesh, ts),
                 lambda: dsb.init_dist_ctx(mesh, ts),
                 lambda: dsb.apply(mesh, ts, outside, ops),
                 lambda: dsb.apply_round(mesh, ts, outside, ops),
                 lambda: dsb.apply_global(mesh, ts, outside, ops),
                 lambda: dsb.apply_hash(mesh, hs, outside, ops),
                 lambda: dsb.apply_hash_global(mesh, hs, outside, ops),
                 lambda: dsb.logical(ts, outside),
                 lambda: dsb.versions(ts, outside),
                 lambda: dsb.hash_items(hs, outside),
                 lambda: dsb.agree_max(mesh, [1.0]),
                 lambda: DistTarget(mesh, ts)):
        with pytest.raises(ValueError, match="not a member"):
            call()
    with pytest.raises(TypeError, match="reshards tables"):
        reshard_dist(hs, outside, ts, mesh)
    with pytest.raises(ValueError, match="geometry change"):
        reshard_dist(ts, outside, dsb.DistSpec(atomics.AtomicSpec(32, 2),
                                               "shard", 2, 4), mesh)
