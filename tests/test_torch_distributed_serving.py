"""The port's sharded serving path (`repro_torch.core.distributed`'s
global-batch form `apply_global` / `apply_hash_global`, the sharded
`BigQueue`, `txn.map.transact_dist`, the sharded page table and
`ServingEngine(mesh=...)`) against the reference, the shared oracles and
the port's one-device paths.

The live JAX sharded clients cannot run on jax 0.9 (their scenarios in
`tests/dist_checks.py` stop with `ShardingTypeError`), so the cases here
are those scenarios' (`txnmap`, `txn_plugin`, `serving`, and the sharded
rings under them) held against `tests/oracle.py`, against the port's
one-device clients (which `test_torch_txn.py`, `test_torch_sync.py` and
`test_torch_serving.py` hold against the reference) and, for serving,
against the reference's one-device engine run beside the world.  Every
case runs once on ONE world of 8 gloo ranks (`torch_dist_world.py`); each
rank passes the same global calls and must see the same results as every
other rank:

  txnmap      four lock-free layouts at 2 and 4 shards, two drawn steps
              and the one-key conflict storm (`rounds == T`), and two
              under exponential backoff: the `MapResult` and contents
              equal the one-device `transact` bit for bit and `MapOracle`
              replaying the claimed order; every all_to_all carries the
              whole batch (route capacity = the batch, as the reference
              sets it) and rounds with no active txn run none.  Too small
              a `max_rounds` raises on every rank alike.
  txn_plugin  a strategy registered in the world runs `transact_dist`.
  queue       four layouts at 2, 4 and 8 shards (and exponential backoff
              at 4): enqueue past a full ring of three, dequeue, a mixed
              batch; outputs, commit log, `len`, ring cells and versions
              equal the one-device queue's, and every routed batch
              replays through `TableOracle` in `linearization_order`.
  serving     deepseek_7b reduced, fp32, mesh (2, 4) ("shard", "rest"),
              on the weights the reference's `init_params` drew: tokens of
              `run_to_completion` and `run_pipelined` equal the
              reference's one-device engine on the same requests and the
              port's engine without a mesh, `dispatch_count == n_new - 1`.

A planted divergence (one rank of two skips a `len()`, the routed LOAD
every rank must join) must fail its world within the group's timeout."""

import dataclasses
import pickle
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import torch_dist_world as W
from repro_torch import atomics
from repro_torch.core import distributed as dsb

LOCK_FREE = ["seqlock", "indirect", "cached_wf", "cached_me"]
TXNMAP = [f"txnmap/{st}/s{s}" for st in LOCK_FREE for s in (2, 4)]
TXNMAP_EXP = ["txnmap_exp/cached_me/s4", "txnmap_exp/seqlock/s2"]
EXP = ("exp", 1, 4)
QUEUE = [f"queue/{st}/s{s}" for st in LOCK_FREE for s in (2, 4, 8)]
QUEUE += ["queue_exp/cached_me/s4"]
SERVE = dict(arch="deepseek_7b", seed=0, new=3,
             cfg=dict(param_dtype="float32", compute_dtype="float32"),
             engine=dict(max_batch=2, n_pages=16, page_size=4,
                         max_pages_per_seq=4, strategy="cached_me"))


def _mesh(s):
    return ((s, 8 // s), ("shard", "rest"))


def _map_steps(rng):
    """`scenario_txnmap`'s draws: two steps of T = 5 (R = W = 2, read
    masks, deletes) writing their reads back, then T = 4 txns incrementing
    key 17."""
    steps = []
    t, r, w = 5, 2, 2
    for _ in range(2):
        steps.append((
            rng.integers(0, 30, (t, r)).astype(np.uint32),
            np.stack([rng.choice(30, size=w, replace=False)
                      for _ in range(t)]).astype(np.uint32),
            rng.random((t, r)) < 0.8, None, rng.random((t, w)) < 0.2,
            "copy"))
    storm = np.full((4, 1), 17, np.uint32)
    steps.append((storm, storm, None, None, None, "sum_plus_one"))
    return steps


def _queue_calls(rng, p=6):
    """Enqueue four into a ring of three (one stably full), dequeue two,
    then a contended mixed batch of ENQ / DEQ / IDLE lanes."""
    kinds = rng.integers(0, 3, p).astype(np.int32)
    kinds[:2] = (0, 1)
    return [("enq", np.arange(1, 5, dtype=np.uint32)[:, None] * 11),
            ("deq", 2),
            ("run", kinds, rng.integers(0, 2 ** 32, (p, 1), dtype=np.uint32))]


def _txnmap(name, steps, **extra):
    kind, st, shards = name.split("/")
    s = int(shards[1:])
    return dict(name=name, kind="txnmap", mesh=_mesh(s),
                inner=("hash", 64, 1, st, 64),
                dist=dict(axis="shard", n_shards=s, p_local=4),
                map=steps, **extra)


def build(params_path):
    """Every case of the world; the serving case's weights are the
    reference's, which its run writes to `params_path`."""
    cases = []
    for st in LOCK_FREE:
        rng = np.random.default_rng(zlib.crc32(st.encode()) ^ 0x3333)
        for s in (2, 4):
            cases.append(_txnmap(f"txnmap/{st}/s{s}", _map_steps(rng)))
    for name in TXNMAP_EXP:
        cases.append(_txnmap(name, _map_steps(np.random.default_rng(
            zlib.crc32(name.encode()))), policy=EXP))
    # four txns on one key cannot all commit in two rounds: every rank
    # raises alike, and the cases after it still run
    cases.append(_txnmap("txnmap_bound/cached_me/s2", _map_steps(
        np.random.default_rng(7))[-1:], max_rounds=2))
    storm = np.full((3, 1), 8, np.uint32)
    cases.append(dict(
        _txnmap(f"txn_plugin/{W.PLUGIN}/s4",
                [(storm, storm, None, None, None, "sum_plus_one")],
                plugin=True), name="txn_plugin"))
    for name in QUEUE:
        kind, st, shards = name.split("/")
        s = int(shards[1:])
        rng = np.random.default_rng(zlib.crc32(name.encode()))
        cases.append(dict(
            name=name, kind="queue", mesh=_mesh(s),
            dist=dict(axis="shard", n_shards=s),
            queue=dict(capacity=3, k=2, strategy=st, p_max=64,
                       policy=EXP if kind == "queue_exp" else ("none",),
                       calls=_queue_calls(rng))))
    cases.append(dict(name="serving", kind="serving", ref=True,
                      mesh=((2, 4), ("shard", "rest")),
                      dist=dict(axis="shard"),
                      serve=dict(SERVE, prompts=_prompts(),
                                 params=str(params_path))))
    return cases


def _serve_cfg():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(SERVE["arch"], reduced=True),
                               **SERVE["cfg"])


def _prompts():
    rng = np.random.default_rng(0)
    vocab = _serve_cfg().vocab
    return [rng.integers(0, vocab, 9).astype(np.int32),
            rng.integers(0, vocab, 5).astype(np.int32)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world beside the reference's run (its one-device engine on the
    serving case), whose weights the serving case waits for."""
    tmp = tmp_path_factory.mktemp("dist_serving")
    cases = build(tmp / "ref_params.pkl")
    inputs = tmp / "cases.pkl"
    inputs.write_bytes(pickle.dumps(cases))
    ref = W.start_reference("serving", inputs, tmp / "ref.pkl")
    with ThreadPoolExecutor(1) as pool:     # meanwhile, the planted hang
        skip_len = pool.submit(_skipped_len_world, tmp / "skip_len")
        rcs, tails, seconds = W.run_world("serving", inputs, tmp / "world",
                                          timeout=240)
        ref_out = W.finish_reference(ref, tmp / "ref.pkl")
    assert not any(rcs), "\n".join(tails)
    return {"cases": {c["name"]: c for c in cases},
            "world": W.load_world(tmp / "world"), "ref": ref_out,
            "params": tmp / "ref_params.pkl",
            "skip_len": skip_len.result()}


def _skipped_len_world(tmp):
    """A world of two in which rank 1 answers `len()` of a sharded ring
    without the routed LOAD (and stays in the world)."""
    case = dict(name="len", kind="length", mesh=((2,), ("shard",)),
                dist=dict(axis="shard", n_shards=2),
                queue=dict(capacity=8, k=2, strategy="cached_me",
                           initial=np.arange(3, dtype=np.uint32)))
    tmp.mkdir()
    inputs = tmp / "cases.pkl"
    inputs.write_bytes(pickle.dumps([case]))
    return W.run_world("skip_len", inputs, tmp / "world", world=2,
                       timeout=60, pg_timeout=5)


def _agreed(runs, name, skip=("shard",)):
    """Rank 0's record of `name`, after checking that every rank saw the
    same (each rank issued the same global calls)."""
    recs = [out[name] for out in runs["world"]]
    first = pickle.dumps({k: v for k, v in recs[0].items() if k not in skip})
    for r, rec in enumerate(recs[1:], 1):
        got = pickle.dumps({k: v for k, v in rec.items() if k not in skip})
        assert got == first, f"{name}: rank {r} saw other results"
    return recs[0]


def _ref_txns(step):
    from repro.txn import map as ref_map
    rk, wk, rm, wm, wd, fname = step
    return ref_map.make_map_txns(rk, wk, read_mask=rm, write_mask=wm,
                                 write_del=wd), W.MAP_FNS[fname]


def _map_result(fields):
    from repro.txn import map as ref_map
    value, found, rnd, attempts, rounds = fields
    return ref_map.MapResult(value, found.astype(bool),
                             rnd.astype(np.int32), attempts.astype(np.int32),
                             int(rounds))


@pytest.mark.parametrize("name", TXNMAP + TXNMAP_EXP + ["txn_plugin"])
def test_transact_dist_matches_map_oracle(runs, name):
    """Read sets observed at the commit point and the sharded table's
    contents against the dict model replaying the claimed order."""
    from oracle import MapOracle
    rec = _agreed(runs, name)
    oracle = MapOracle(vw=1)
    for j, (step, got) in enumerate(zip(runs["cases"][name]["map"],
                                        rec["steps"])):
        txns, fn = _ref_txns(step)
        keys, values = got["items"]
        oracle.step_and_check(
            txns, fn, result=_map_result(got["dist"]),
            items={int(k): v for k, v in zip(keys, values)},
            msg=f"{name} step {j}")
    if step[-1] == "sum_plus_one":           # the conflict storm
        t = step[0].shape[0]
        if "policy" not in runs["cases"][name]:
            assert int(got["dist"][4]) == t
        assert oracle.model[int(step[0][0, 0])][0] == t


@pytest.mark.parametrize("name", TXNMAP_EXP)
def test_transact_dist_backs_off_the_storm(runs, name):
    """Under exponential backoff (base 1, cap 4) the four-txn storm on one
    key commits one txn per active round, and the rounds in which every
    pending txn backs off run no batch: the k-th to commit lost k - 1
    times and waited 1, 2, then 4 rounds, so the commits land in rounds
    1, 3, 6 and 11 on every rank."""
    rec = _agreed(runs, name)
    value, found, rnd, attempts, rounds = rec["steps"][-1]["dist"]
    order = np.argsort(rnd.view(np.int32), kind="stable")
    assert int(rounds) == 11
    np.testing.assert_array_equal(rnd.view(np.int32)[order], [1, 3, 6, 11])
    np.testing.assert_array_equal(attempts.view(np.int32)[order],
                                  [0, 1, 2, 3])
    np.testing.assert_array_equal(value.view(np.int32)[order, 0, 0],
                                  [0, 1, 2, 3])


def test_transact_dist_round_bound_raises_on_every_rank(runs):
    """`max_rounds` too small for the storm: every rank raises the
    reference's RuntimeError at the same round, issuing no collective
    the others skip (the world's later cases run on)."""
    name = "txnmap_bound/cached_me/s2"
    recs = [out[name] for out in runs["world"]]
    for r, rec in enumerate(recs):
        assert rec["steps"] == [], f"rank {r}"
        assert "round bound exceeded (2)" in rec.get("error", ""), f"rank {r}"
    assert len({rec["error"] for rec in recs}) == 1
    assert "serving" in runs["world"][0]


@pytest.mark.parametrize("name", TXNMAP + TXNMAP_EXP + ["txn_plugin"])
def test_transact_dist_equals_one_device_transact(runs, name):
    """The sharded map's result equals the one-device `transact`'s bit for
    bit, and so do the contents: under backoff too, where the sharded
    loop skips the rounds in which every pending txn waits and the
    one-device loop runs them empty."""
    from repro.txn import map as ref_map
    rec = _agreed(runs, name)
    for j, got in enumerate(rec["steps"]):
        for field, a, b in zip(ref_map.MapResult._fields, got["dist"],
                               got["one"]):
            np.testing.assert_array_equal(a, b,
                                          err_msg=f"{name} {j}: {field}")
        for a, b in zip(got["items"], got["items_one"]):
            np.testing.assert_array_equal(a, b, err_msg=f"{name} {j}")


@pytest.mark.parametrize("name", ["txnmap/seqlock/s2", "txnmap/cached_me/s4",
                                  "txn_plugin"] + TXNMAP_EXP)
def test_transact_dist_routes_the_whole_batch(runs, name):
    """Each hash batch (read, validate, commit) hands two all_to_alls of
    [s, q_pad, vw + 2]: route capacity = the padded batch, so a shard may
    receive every lane.  Only rounds with an active txn run the batches:
    each commits some txn, so they are the distinct commit rounds."""
    case = runs["cases"][name]
    s = case["dist"]["n_shards"]
    rec = _agreed(runs, name)
    for step, got in zip(case["map"], rec["steps"]):
        t, r = step[0].shape
        w = step[1].shape[1]
        active_rounds = len(np.unique(got["dist"][2]))

        def pad(q):
            return -(-q // s) * s
        per_round = [s * pad(q) * 3 for q in (t * r, t * r, 2 * t * w)
                     for _ in range(2)]
        assert got["words"] == per_round * active_rounds
        if "policy" not in case:
            assert active_rounds == int(got["dist"][4])


@pytest.mark.parametrize("name", QUEUE)
def test_sharded_queue_equals_one_device_queue(runs, name):
    """Per call: payloads, success, rounds; the commit log, `len`, the
    ring's cells and versions, against the one-device `BigQueue` on the
    same calls."""
    rec = _agreed(runs, name)
    for j, call in enumerate(rec["calls"]):
        msg = f"{name} call {j}"
        for a, b in zip(call["sharded"], call["one"]):
            np.testing.assert_array_equal(a, b, err_msg=msg)
        assert call["len"][0] == call["len"][1], msg
        assert call["log"][0] == call["log"][1], msg
        for key in ("cells", "versions"):
            np.testing.assert_array_equal(*call[key], err_msg=f"{msg} {key}")
    out, success, _ = rec["calls"][0]["sharded"]
    assert success.sum() == 3 and not success[3]         # ring of three


@pytest.mark.parametrize("name", QUEUE)
def test_sharded_queue_batches_replay_through_table_oracle(runs, name):
    """Every routed batch of the sharded ring, replayed in the order
    `linearization_order` claims: values, success, links, cells and
    versions."""
    from oracle import TableOracle
    from repro import atomics as ref_atomics
    case = runs["cases"][name]
    s, qc = case["dist"]["n_shards"], case["queue"]
    rec = _agreed(runs, name)
    n_pad, k = rec["n_pad"], qc["k"]
    initial = np.zeros((n_pad, k), np.uint32)
    initial[2:2 + qc["capacity"], 0] = np.arange(qc["capacity"])
    oracle = TableOracle(n_pad, k, 1, initial=initial)
    assert len(rec["routed"]) > 20
    for j, b in enumerate(rec["routed"]):
        kind, slot, exp, des = b["ops"]
        p = kind.shape[0]
        dspec = dsb.DistSpec(atomics.AtomicSpec(n_pad, k, qc["strategy"],
                                                qc["p_max"]),
                             "shard", s, b["p_local"])
        order, overflow = dsb.linearization_order(
            dspec, atomics.OpBatch(kind.view(np.int32), slot.view(np.int32),
                                   None, None))
        assert not overflow.any() and not b["overflow"].any()
        oracle.p = p
        oracle.ctx = ref_atomics.LinkCtx(
            *(TableOracle(1, k, p).ctx if b["ctx"] is None else b["ctx"]))
        ref = oracle.step(ref_atomics.OpBatch(
            kind.view(np.int32), slot.view(np.int32), exp, des), order)
        oracle.check(result=ref_atomics.ApplyResult(b["value"],
                                                    b["success"] != 0),
                     ref=ref, logical=b["logical"], version=b["versions"],
                     ctx=b["nctx"], msg=f"{name} batch {j}")


@pytest.fixture(scope="module")
def unsharded(runs):
    """The port's engine without a mesh on the same weights and requests."""
    from repro_torch import convert
    from repro_torch.serving import Request, ServingEngine
    cfg = _serve_cfg()
    params = convert.model_params(
        pickle.loads(runs["params"].read_bytes()), device="cpu")
    eng = ServingEngine(cfg, params, device="cpu", **SERVE["engine"])
    for rid, prompt in enumerate(_prompts()):
        eng.submit(Request(rid=rid, prompt=prompt,
                           max_new_tokens=SERVE["new"]))
    tokens = eng.run_to_completion(max_steps=40)
    return {"tokens": tokens, "dispatch_count": eng.dispatch_count,
            "free": len(eng.paged.free)}


@pytest.mark.parametrize("how", ["run_to_completion", "run_pipelined"])
def test_sharded_engine_tokens_equal_unsharded(runs, unsharded, how):
    """Sharded page table and rings, on the reference's weights: the same
    tokens as the reference's one-device engine on the same requests (and
    as the port's engine without a mesh), one fused dispatch a decode
    step, every page back on the ring and the table empty at the end, on
    every rank."""
    ref = runs["ref"]["serving"]
    rec = _agreed(runs, "serving")[how]
    assert rec["spec_shards"] == 2
    assert rec["tokens"] == ref["tokens"]
    assert rec["tokens"] == unsharded["tokens"]
    assert all(len(v) == SERVE["new"] for v in rec["tokens"].values())
    if how == "run_to_completion":
        assert rec["dispatch_count"] == ref["dispatch_count"] \
            == SERVE["new"] - 1
        assert rec["dispatch_count"] == unsharded["dispatch_count"]
    assert rec["items"] == ref["items"] == {}
    assert rec["free"] == ref["free"] == unsharded["free"] \
        == SERVE["engine"]["n_pages"]


def test_skipped_len_fails_within_the_group_timeout(runs):
    """Rank 0, waiting in the LOAD's all_to_all that rank 1 skipped, must
    fail at the group's 5 s timeout, well inside the world's 60 s."""
    rcs, tails, seconds = runs["skip_len"]
    assert rcs[0] != 0, tails[0]
    assert seconds < 45, seconds
    assert "timed out" in tails[0].lower(), tails[0]


def test_global_forms_check_their_spec_and_width():
    import types

    import torch
    mesh = types.SimpleNamespace(device=torch.device("cpu"))
    hs = dsb.DistSpec(atomics.HashSpec(64, vw=1), "shard", 2, 4)
    ts = dsb.DistSpec(atomics.AtomicSpec(16, 2), "shard", 2, 4)
    with pytest.raises(TypeError, match="apply_hash_global"):
        dsb.apply_global(mesh, hs, None, None)
    with pytest.raises(TypeError, match="apply_global"):
        dsb.apply_hash_global(mesh, ts, None, None)
    from repro_torch.serving import paged_kv as pk
    cfg = _serve_cfg()
    spec = pk.make_spec(cfg, 16, 4, 2, n_shards=2)
    assert spec.n_shards == 2 and spec.table.nb == 32
    with pytest.raises(ValueError, match="requires a mesh"):
        pk.init(cfg, spec, device="cpu")
    with pytest.raises(ValueError, match="power of two"):
        pk.make_spec(cfg, 16, 4, 2, n_shards=3)
