"""The port's sharded clients (`repro_torch.core.distributed`:
`apply_hash`, the key-owner-routed CacheHash, and `mcas`, the two-round
prepare/commit cross-shard MCAS) against the shared oracles and the JAX
reference.

The `hash` and `mcas` scenarios of `tests/dist_checks.py` on the four
lock-free layouts at 2, 4 and 8 shards, the hot-key capacity contract,
the all-shards-spanning abort / commit pair, and MCAS under contention
with exponential backoff where one rank holds no transactions while the
others retry, run once on a world of 8 gloo ranks
(`torch_dist_world.py`); ONE subprocess runs a named subset on the
reference over 8 fake XLA host devices.  Hash batches are drawn here from
numpy seeds and replayed through `HashOracle` in the claimed
`linearization_order`; MCAS batches are drawn on every rank from a seed
against the live logical values (as `dist_checks.py` draws them against
its oracle's), and each step is replayed through `TxnOracle` in the
order the result claims, after checking that the same draw against the
oracle's values gives the same batch.  A planted hang — a rank that
leaves `mcas`'s loop early — must fail its world within the group's
timeout."""

import pickle
import zlib

import numpy as np
import pytest

import torch_dist_world as W
from oracle import HashOracle, TxnOracle, hash_batch
from repro import atomics as ref_atomics
from repro.core import cachehash as ref_ch
from repro.txn import mcas as ref_mcas
from repro_torch import atomics
from repro_torch.core import distributed as dsb
from torch_threads import one_thread  # noqa: F401

LOCK_FREE = ["seqlock", "indirect", "cached_wf", "cached_me"]
SHARDS = (2, 4, 8)
HASH = [f"hash/{st}/s{s}" for st in LOCK_FREE for s in SHARDS]
HASH_HOT = [f"hash_hot/{st}" for st in LOCK_FREE]
MCAS = [f"mcas/{st}/s{s}" for st in LOCK_FREE for s in SHARDS]
SPAN = [f"mcas_span/{st}" for st in LOCK_FREE]
UNEQUAL = [f"mcas_unequal/{st}" for st in LOCK_FREE]
REF_CASES = ["hash/seqlock/s4", "hash/cached_me/s4", "mcas/seqlock/s4",
             "mcas/cached_me/s4", "mcas_unequal/cached_me"]


def _mesh(s):
    return ((s, 8 // s), ("shard", "rest"))


def _case(name, kind, s, inner, dist=None, **extra):
    return dict(name=name, kind=kind, mesh=_mesh(s), inner=inner,
                dist=dict(axis="shard", n_shards=s, **(dist or {})),
                ref=name in REF_CASES, **extra)


def build():
    cases, expected = [], {}
    for st in LOCK_FREE:
        rng = np.random.default_rng(zlib.crc32(st.encode()) ^ 0x5A5A)
        for s in SHARDS:
            name = f"hash/{st}/s{s}"
            case = _case(name, "hash", s, ("hash", 64, 1, st, 64),
                         dict(p_local=6), init=None, batches=[])
            spec = W.make_dspec(atomics, dsb, case)
            oracle, want = HashOracle(vw=1), []
            for _ in range(3):
                ops = hash_batch(rng, p=spec.p_global, key_space=40, vw=1)
                case["batches"].append((np.array(ops.kind),
                                        np.array(ops.slot),
                                        np.array(ops.desired)))
                want.append(_hash_step(spec, oracle, ops))
            cases.append(case)
            expected[name] = want
        # hot key: every lane of source 0 inserts the same key, cap 2
        s, pl, cap = 4, 6, 2
        name = f"hash_hot/{st}"
        case = _case(name, "hash", s, ("hash", 64, 1, st, 64),
                     dict(p_local=pl, route_capacity=cap), init=None)
        spec = W.make_dspec(atomics, dsb, case)
        kind = np.full(spec.p_global, atomics.IDLE, np.int32)
        kind[:pl] = atomics.INSERT
        keys = np.full(spec.p_global, 12345, np.uint32)
        vals = np.arange(spec.p_global, dtype=np.uint32)[:, None]
        case["batches"] = [(kind, keys, vals)]
        ops = ref_ch.make_hash_ops(kind, keys, vals, vw=1)
        expected[name] = [_hash_step(spec, HashOracle(vw=1), ops)]
        cases.append(case)
    for st in LOCK_FREE:
        rng = np.random.default_rng(zlib.crc32(st.encode()) ^ 0x7777)
        n, k = 24, 2
        for s, w in zip(SHARDS, (1, 2, 3)):
            cases.append(_case(
                f"mcas/{st}/s{s}", "mcas", s, ("atomic", n, k, st, 64),
                dict(p_local=8),
                init=rng.integers(0, 2 ** 32, (n, k), dtype=np.uint32),
                mcas=dict(seed=int(rng.integers(2 ** 31)), steps=3, t=8,
                          w=w, match_frac=0.6, policy=("none",))))
        # one txn over all four shards: a stale lane on the last aborts it,
        # the fixed comparand commits it on every shard at once
        init = rng.integers(0, 2 ** 32, (n, k), dtype=np.uint32)
        span = np.asarray([[0, 6, 12, 18]], np.int32)
        stale = init[span[0]][None].copy()
        stale[0, 3] += 1
        five = np.full((1, 4, k), 5, np.uint32)
        cases.append(_case(
            f"mcas_span/{st}", "mcas", 4, ("atomic", n, k, st, 64),
            dict(p_local=8), init=init,
            mcas=dict(policy=("none",), txns=[
                (span, stale, five), (span, init[span[0]][None], five)])))
        # contention on 8 cells, T = 5 over 4 shards: ranks 0 and 1 hold
        # two txns, rank 2 one, rank 3 none; losers back off exponentially
        cases.append(_case(
            f"mcas_unequal/{st}", "mcas", 4, ("atomic", 8, k, st, 64),
            dict(p_local=8),
            init=rng.integers(0, 2 ** 32, (8, k), dtype=np.uint32),
            mcas=dict(seed=int(rng.integers(2 ** 31)), steps=3, t=5, w=2,
                      match_frac=1.0, policy=("exp", 1, 4))))
    return cases, expected


def _hash_step(spec, oracle, ops):
    order, ovf = dsb.linearization_order(
        spec, atomics.OpBatch(np.asarray(ops.kind), np.asarray(ops.slot),
                              None, None))
    ref = oracle.step(ops, order)
    keys = np.asarray(sorted(oracle.model), np.uint32)
    return {"order": order, "overflow": ovf, "found": ref.found,
            "value": ref.value, "keys": keys,
            "values": np.asarray([np.ravel(oracle.model[x])
                                  for x in keys.tolist()],
                                 np.uint32).reshape(-1, oracle.vw)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world's run and the reference's, started together."""
    tmp = tmp_path_factory.mktemp("dist_clients")
    cases, expected = build()
    inputs = tmp / "cases.pkl"
    inputs.write_bytes(pickle.dumps(cases))
    with W.reference("clients", inputs, tmp / "ref.pkl") as ref:
        rcs, tails, seconds = W.run_world("clients", inputs, tmp / "world",
                                          timeout=240)
        assert not any(rcs), "\n".join(tails)
        ref_out = W.finish_reference(ref, tmp / "ref.pkl")
    return {"cases": {c["name"]: c for c in cases}, "expected": expected,
            "world": W.load_world(tmp / "world"), "ref": ref_out}


def _by_shard(runs, name):
    """Each shard's record of `name`, after checking that ranks holding
    the same shard saw the same."""
    recs = {}
    for out in runs["world"]:
        rec = out[name]
        if rec["shard"] in recs:
            for a, b in zip(recs[rec["shard"]]["steps"], rec["steps"]):
                for key in a:
                    np.testing.assert_equal(a[key], b[key],
                                            err_msg=f"{name}: replica {key}")
        else:
            recs[rec["shard"]] = rec
    return recs


def _hash_global(runs, name):
    spec = W.make_dspec(atomics, dsb, runs["cases"][name])
    recs = _by_shard(runs, name)
    steps = []
    for j in range(len(runs["cases"][name]["batches"])):
        got = [recs[sh]["steps"][j] for sh in range(spec.n_shards)]
        step = {key: np.concatenate([g[key] for g in got])
                for key in ("found", "value", "walk_over", "overflow")}
        step.update(keys=got[0]["keys"], values=got[0]["values"],
                    words=got[0]["words"])
        steps.append(step)
    return spec, steps


def _assert_hash_step(msg, got, want):
    np.testing.assert_array_equal(got["overflow"], want["overflow"],
                                  err_msg=f"{msg}: overflow")
    np.testing.assert_array_equal(got["found"], want["found"],
                                  err_msg=f"{msg}: found")
    np.testing.assert_array_equal(got["value"], want["value"],
                                  err_msg=f"{msg}: values")
    assert not np.asarray(got["walk_over"]).any()
    assert not np.asarray(got["found"])[want["overflow"]].any()
    np.testing.assert_array_equal(got["keys"], want["keys"],
                                  err_msg=f"{msg}: keys")
    np.testing.assert_array_equal(got["values"], want["values"],
                                  err_msg=f"{msg}: contents")


@pytest.mark.parametrize("name", HASH + HASH_HOT)
def test_sharded_hash_matches_oracle(runs, name):
    """Found, values, overflow and every shard's contents against the
    dict model replaying the claimed order."""
    spec, steps = _hash_global(runs, name)
    for j, (got, want) in enumerate(zip(steps, runs["expected"][name])):
        _assert_hash_step(f"{name} step {j}", got, want)
    if name.startswith("hash_hot"):
        assert steps[0]["overflow"].sum() == spec.p_local - spec.cap


@pytest.mark.parametrize("name", [n for n in REF_CASES
                                  if n.startswith("hash")])
def test_sharded_hash_matches_reference(runs, name):
    got = runs["ref"][name]["steps"]
    want = runs["expected"][name]
    assert len(got) == len(want)
    for j, (g, w) in enumerate(zip(got, want)):
        _assert_hash_step(f"{name} step {j} (reference)", g, w)


@pytest.mark.parametrize("name", ["hash/cached_wf/s2", "hash/seqlock/s8",
                                  "hash_hot/indirect"])
def test_hash_words_handed_to_all_to_all(runs, name):
    """One `all_to_all_single` out and one back, [s, cap, vw+2] each:
    `collective_words(dspec)` in all."""
    spec, steps = _hash_global(runs, name)
    per = spec.n_shards * spec.cap * (spec.inner.vw + 2)
    assert 2 * per == dsb.collective_words(spec)
    for step in steps:
        assert step["words"] == [per, per]


def _mcas_steps(runs, name, src=None):
    """The MCAS steps of `name` as global results (rows placed by txn id);
    `src` the reference's record instead of the world's."""
    case = runs["cases"][name]
    spec = W.make_dspec(atomics, dsb, case)
    if src is not None:
        return spec, src[name]["steps"]
    recs = _by_shard(runs, name)
    steps = []
    for j in range(len(recs[0]["steps"])):
        first = recs[0]["steps"][j]
        slot, exp, des = first["txns"]
        t, w = slot.shape
        k = spec.inner.k
        step = {"txns": first["txns"], "rounds": first["rounds"],
                "logical": first["logical"], "versions": first["versions"],
                "success": np.zeros(t, bool),
                "witness": np.zeros((t, w, k), np.uint32),
                "round": np.zeros(t, np.uint32),
                "attempts": np.zeros(t, np.uint32), "ranks": {}}
        for sh, rec in recs.items():
            got = rec["steps"][j]
            for key in ("rounds", "logical", "versions"):
                np.testing.assert_array_equal(got[key], step[key])
            lo, hi = got["rows"]
            for key in ("success", "witness", "round", "attempts"):
                step[key][lo:hi] = got[key]
            step["ranks"][sh] = (hi - lo, got["words"])
        steps.append(step)
    return spec, steps


def _check_mcas(runs, name, steps):
    """Replay every step through `TxnOracle` in the order the result
    claims; a drawn batch must be the same draw against the oracle's
    values."""
    case = runs["cases"][name]
    n, k = case["inner"][1], case["inner"][2]
    m = case["mcas"]
    oracle = TxnOracle(n, k, initial=case["init"])
    rng = None if m.get("txns") else np.random.default_rng(m["seed"])
    for j, step in enumerate(steps):
        slot, exp, des = step["txns"]
        if rng is not None:
            redraw = W.txn_arrays(rng, t=m["t"], w=m["w"], n=n, k=k,
                                  current=oracle.data,
                                  match_frac=m["match_frac"])
            for a, b in zip(redraw, step["txns"]):
                np.testing.assert_array_equal(a, b, err_msg=f"{name} {j}")
        result = ref_mcas.McasResult(
            np.asarray(step["success"]), np.asarray(step["witness"]),
            np.asarray(step["round"]).astype(np.int32),
            np.asarray(step["attempts"]).astype(np.int32),
            np.int32(step["rounds"]))
        oracle.step_and_check(ref_atomics.make_txns(slot, exp, des, k=k),
                              result=result, logical=step["logical"],
                              version=step["versions"],
                              msg=f"{name} step {j}")


@pytest.mark.parametrize("name", MCAS + SPAN + UNEQUAL)
def test_sharded_mcas_matches_txn_oracle(runs, name):
    _, steps = _mcas_steps(runs, name)
    _check_mcas(runs, name, steps)


@pytest.mark.parametrize("name", [n for n in REF_CASES
                                  if n.startswith("mcas")])
def test_sharded_mcas_matches_reference(runs, name):
    """The reference's live sharded `mcas` draws the same batches against
    its own live values and gives the same per-txn results, rounds,
    logical values and versions."""
    _, got = _mcas_steps(runs, name)
    _, want = _mcas_steps(runs, name, src=runs["ref"])
    assert len(got) == len(want)
    for j, (g, w) in enumerate(zip(got, want)):
        for key in ("success", "witness", "round", "attempts", "rounds",
                    "logical", "versions"):
            np.testing.assert_array_equal(np.asarray(g[key]),
                                          np.asarray(w[key]),
                                          err_msg=f"{name} {j}: {key}")
        for a, b in zip(g["txns"], w["txns"]):
            np.testing.assert_array_equal(a, b)
    _check_mcas(runs, name, want)


@pytest.mark.parametrize("strategy", LOCK_FREE)
def test_cross_shard_mcas_is_all_or_nothing(runs, strategy):
    """The spanning txn aborts on one stale lane (nothing written on any
    shard) and commits everywhere once its comparand is fixed."""
    name = f"mcas_span/{strategy}"
    _, (abort, commit) = _mcas_steps(runs, name)
    init = runs["cases"][name]["init"]
    assert not abort["success"][0]
    np.testing.assert_array_equal(abort["logical"], init)
    assert commit["success"][0]
    np.testing.assert_array_equal(commit["logical"][[0, 6, 12, 18]],
                                  np.full((4, 2), 5, np.uint32))


@pytest.mark.parametrize("strategy", LOCK_FREE)
def test_mcas_with_a_rank_holding_no_transactions(runs, strategy):
    """Rank 3 holds none of the T = 5 transactions while the others lose
    arbitration and retry: every rank runs the same rounds and finishes."""
    _, steps = _mcas_steps(runs, f"mcas_unequal/{strategy}")
    assert sum(int(st["attempts"].sum()) for st in steps) > 0
    for st in steps:
        assert st["ranks"][3][0] == 0 and st["ranks"][2][0] == 1
        assert (st["round"] > 0).all()


@pytest.mark.parametrize("name", ["mcas/seqlock/s2", "mcas/indirect/s8",
                                  "mcas_unequal/cached_wf"])
def test_mcas_words_handed_to_all_to_all(runs, name):
    """Each attempted round hands four `all_to_all_single`s [s, cap, 2k+3],
    [s, cap, k+2], [s, cap, 1], [s, cap, 1] with cap = t_local * w:
    `mcas_collective_words(dspec, t_local, w)` a round."""
    spec, steps = _mcas_steps(runs, name)
    s, k = spec.n_shards, spec.inner.k
    for step in steps:
        t, w = step["txns"][0].shape
        t_local = -(-t // s)
        cap = t_local * w
        per = [s * cap * (2 * k + 3), s * cap * (k + 2), s * cap, s * cap]
        assert sum(per) == dsb.mcas_collective_words(spec, t_local, w)
        for _, words in step["ranks"].values():
            assert 0 < len(words) // 4 <= step["rounds"]
            assert words == per * (len(words) // 4)


def test_planted_hang_fails_within_its_limit(tmp_path):
    """Rank 1 of two leaves `mcas`'s loop after its first round; rank 0,
    whose own txn committed, waits in the next round's `all_reduce` and
    must fail at the group's 5 s timeout, well inside the world's 60 s."""
    n, k = 8, 2
    init = np.arange(n * k, dtype=np.uint32).reshape(n, k)
    slot = np.asarray([[0, 1], [0, 2]], np.int32)      # both claim cell 0
    exp = init[slot]
    case = dict(name="hang", kind="mcas", mesh=((2,), ("shard",)),
                inner=("atomic", n, k, "cached_me", 64),
                dist=dict(axis="shard", n_shards=2, p_local=8), init=init,
                mcas=dict(policy=("none",), txns=[
                    (slot, exp, np.full((2, 2, k), 7, np.uint32))]))
    inputs = tmp_path / "cases.pkl"
    inputs.write_bytes(pickle.dumps([case]))
    rcs, tails, seconds = W.run_world("hang", inputs, tmp_path / "world",
                                      world=2, timeout=60, pg_timeout=5)
    assert rcs[0] != 0, tails[0]
    assert seconds < 45, seconds
    assert "timed out" in tails[0].lower(), tails[0]


def test_mcas_rejects_mismatched_widths_and_hash_specs():
    hs = dsb.DistSpec(atomics.HashSpec(64, vw=1), "shard", 2, 4)
    with pytest.raises(TypeError, match="MCAS runs on tables"):
        dsb.mcas(None, hs, None, None)
    two = dsb.DistSpec(atomics.AtomicSpec(16, 2), "shard", 4, 4, n_nodes=2)
    with pytest.raises(NotImplementedError, match="routes flat"):
        dsb.mcas(None, two, None, None)
    with pytest.raises(TypeError, match="use distributed.apply"):
        dsb.apply_hash(None, dsb.DistSpec(atomics.AtomicSpec(16, 2)), None,
                       atomics.OpBatch(np.zeros(1, np.int32), None, None,
                                       None))
    with pytest.raises(TypeError, match="use distributed.apply_hash"):
        dsb.apply(None, hs, None, None)


def test_hash_u32_routing_matches_reference():
    """The owner of every key (the top bits of the bucket hash) and the
    host-side hash equal the reference's, keys across 2^31 included."""
    import jax.numpy as jnp
    keys = np.concatenate([np.arange(4096, dtype=np.uint32),
                           np.arange(2 ** 31 - 8, 2 ** 31 + 8,
                                     dtype=np.uint32),
                           np.asarray([2 ** 32 - 1], np.uint32)])
    want = np.asarray(ref_ch.hash_u32(jnp.asarray(keys, jnp.uint32)))
    np.testing.assert_array_equal(dsb._hash_u32_np(keys), want)
    import torch
    spec = dsb.DistSpec(atomics.HashSpec(64, vw=1), "shard", 4, 4)
    owner = dsb._hash_owner(spec, torch.from_numpy(keys.view(np.int32)))
    np.testing.assert_array_equal(owner.numpy(),
                                  (want & np.uint32(63)) // spec.n_local)
