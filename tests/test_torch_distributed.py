"""The port's sharded table (`repro_torch.core.distributed`: `apply` over
`torch.distributed`) against the shared oracle and the JAX reference.

The scenarios of `tests/dist_checks.py` (mixed batches on the four
lock-free layouts at 2, 4 and 8 shards, the routing levers, the LL/SC
adversaries through the routing layer, the capacity-overflow contract, a
test-registered strategy, two-level routing) plus one shard against
`atomics.apply` are drawn here from numpy seeds, replayed through
`tests/oracle.py`'s `TableOracle` in the claimed `linearization_order`,
and run once on a world of 8 gloo ranks (`torch_dist_world.py`, one
thread a rank, `make_mesh((s, 8 // s), ("shard", "rest"))`: ranks that
differ only in `rest` compute the same shard), while ONE subprocess runs
a named subset on the reference over 8 fake XLA host devices.  Each case
is a test of its own over those shared results, bit for bit (words as
uint32): per-lane value, success, overflow and `LinkCtx`, the global
logical values and versions every rank gathers, and the words each
`all_to_all_single` carried.  In process: `linearization_order`,
`collective_words` and `DistSpec`'s errors against the reference's, the
v1 `reference_apply`, the `convert` round trip and the mesh's default
device."""

import dataclasses
import pickle
import zlib

import numpy as np
import pytest
import torch

import torch_dist_world as W
from oracle import TableOracle, mixed_batch
from repro import atomics as ref_atomics
from repro.core import distributed as ref_dsb
from repro.core import engine as ref_engine
from repro_torch import atomics, convert
from repro_torch.core import distributed as dsb
from torch_threads import one_thread  # noqa: F401

LOCK_FREE = ["seqlock", "indirect", "cached_wf", "cached_me"]
SHARDS = (2, 4, 8)
LEVERS = [(d, i, c) for d in (False, True) for i in (False, True)
          for c in (None, 3)]
TWO_LEVEL = [(i, c) for i in (False, True) for c in (False, True)]


def _lever_name(d, i, c):
    return f"levers/dedup{int(d)}/ilv{int(i)}/cap{c or 'p'}"


def _two_name(strategy, i, c):
    return f"twolevel/{strategy}/ilv{int(i)}/{'capped' if c else 'open'}"


MIXED = [f"mixed/{st}/s{s}" for st in LOCK_FREE for s in SHARDS]
ADVERSARY = [f"sync_adversary/{st}" for st in LOCK_FREE]
OVERFLOW = [f"overflow/{st}" for st in LOCK_FREE]
TWOLEVEL = [_two_name(st, i, c) for st in LOCK_FREE for i, c in TWO_LEVEL]
TABLE_CASES = (MIXED + [_lever_name(*x) for x in LEVERS] + ADVERSARY
               + OVERFLOW + ["plugin"] + TWOLEVEL)
ONE_SHARD = [f"oneshard/{st}" for st in LOCK_FREE]
COUNTED = "levers/dedup0/ilv0/cap3"      # run under BIGATOMIC_OBS=counters
# run on the reference too (its sharded `apply` is live on 8 host devices)
REF_CASES = ([f"mixed/{st}/s4" for st in LOCK_FREE]
             + [_lever_name(True, True, 3)]
             + [_two_name("cached_me", False, False),
                _two_name("cached_me", True, True)])


def _ops_np(ops):
    return tuple(np.array(x) for x in ops)


def _mesh(s):
    return ((s, 8 // s), ("shard", "rest"))


class _Builder:
    """Draws each scenario's batches as `dist_checks.py` does and replays
    them through `TableOracle` in the claimed order."""

    def __init__(self):
        self.cases, self.expected = [], {}

    def drive(self, name, mesh, inner, dist, init, steps, make_ops, *,
              width=None, **extra):
        n, k = inner[1], inner[2]
        dspec = dsb.DistSpec(atomics.AtomicSpec(n, k, inner[3],
                                                p_max=inner[4]), **dist)
        oracle = TableOracle(n, k, dspec.p_global, initial=init)
        batches, want = [], []
        for _ in range(steps):
            ops = _ops_np(make_ops(oracle))
            if width is not None:             # each rank's trailing lanes
                idle = (np.arange(dspec.p_global) % dspec.p_local) >= width
                ops[0][idle] = atomics.IDLE
            order, ovf = dsb.linearization_order(dspec, atomics.OpBatch(*ops))
            ref = oracle.step(ref_engine.OpBatch(*ops), order)
            batches.append(ops)
            want.append({"order": order, "overflow": ovf,
                         "value": ref.value, "success": ref.success,
                         "ctx": [np.array(x, copy=True) for x in oracle.ctx],
                         "logical": oracle.data.copy(),
                         "versions": oracle.version.copy()})
        case = dict(name=name, kind="table", mesh=mesh, inner=inner,
                    dist=dist, init=init, batches=batches,
                    ref=name in REF_CASES, **extra)
        if width is not None:
            case["width"] = width
        self.cases.append(case)
        self.expected[name] = want
        return want

    def mixed(self, strategy):
        rng = np.random.default_rng(zlib.crc32(strategy.encode()))
        n, k, pl = 48, 3, 6
        for s in SHARDS:
            init = rng.integers(0, 2 ** 32, (n, k), dtype=np.uint32)
            self.drive(f"mixed/{strategy}/s{s}", _mesh(s),
                       ("atomic", n, k, strategy, 64),
                       dict(axis="shard", n_shards=s, p_local=pl), init, 3,
                       lambda o, s=s: mixed_batch(rng, o.ctx, p=s * pl, n=n,
                                                  k=k, current=o.data))

    def levers(self):
        n, k, s, pl = 32, 2, 4, 8
        rng = np.random.default_rng(29)
        init = rng.integers(0, 2 ** 32, (n, k), dtype=np.uint32)

        def hot_batch(oracle):
            p = s * pl
            kind = np.where(rng.random(p) < 0.7, atomics.LOAD,
                            rng.integers(0, 7, p)).astype(np.int32)
            slot = rng.integers(0, 6, p).astype(np.int32)      # hot cells
            desired = rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32)
            expected = np.where((rng.random(p) < 0.5)[:, None],
                                oracle.data[slot],
                                rng.integers(0, 2 ** 32, (p, k),
                                             dtype=np.uint32)
                                ).astype(np.uint32)
            return kind, slot, expected, desired

        for d, i, c in LEVERS:
            self.drive(_lever_name(d, i, c), _mesh(s),
                       ("atomic", n, k, "cached_me", 64),
                       dict(axis="shard", n_shards=s, p_local=pl,
                            route_capacity=c, dedup_loads=d, interleave=i),
                       init, 2, hot_batch, round=True,
                       obs=_lever_name(d, i, c) == COUNTED)

    def sync_adversary(self, strategy):
        """ABA through a remote shard and the lapped linker; `checks` are
        (step, lane, must succeed) the scenario asserts."""
        n, k, s, pl = 16, 2, 4, 4
        p = s * pl
        rng = np.random.default_rng(5)
        init = rng.integers(0, 2 ** 32, (n, k), dtype=np.uint32)
        cell = 9
        original = init[cell]
        plan = [{0: (atomics.LL, cell, None)},
                {5: (atomics.STORE, cell, (original + 1).astype(np.uint32))},
                {5: (atomics.STORE, cell, original)},
                {0: (atomics.VALIDATE, cell, None)},
                {0: (atomics.SC, cell, original)},
                {0: (atomics.LL, 0, None)}]
        checks = [(3, 0, False), (4, 0, False)]
        for lane in range(1, p):
            plan.append({lane: (atomics.LL, 0, None)})
            plan.append({lane: (atomics.SC, 0, np.full(k, lane, np.uint32))})
            checks.append((len(plan) - 1, lane, True))
        plan.append({0: (atomics.SC, 0, np.zeros(k, np.uint32))})
        checks.append((len(plan) - 1, 0, False))
        steps = iter(plan)

        def batch(_oracle):
            kind = np.full(p, atomics.IDLE, np.int32)
            slot = np.zeros(p, np.int32)
            desired = np.zeros((p, k), np.uint32)
            for lane, (kd, sl, des) in next(steps).items():
                kind[lane], slot[lane] = kd, sl
                if des is not None:
                    desired[lane] = des
            return kind, slot, np.zeros((p, k), np.uint32), desired

        self.drive(f"sync_adversary/{strategy}", _mesh(s),
                   ("atomic", n, k, strategy, 64),
                   dict(axis="shard", n_shards=s, p_local=pl), init,
                   len(plan), batch)
        return checks

    def overflow(self, strategy):
        n, k, s, pl, cap = 32, 2, 4, 8, 3
        p = s * pl
        rng = np.random.default_rng(7)
        init = rng.integers(0, 2 ** 32, (n, k), dtype=np.uint32)
        kind = np.full(p, atomics.IDLE, np.int32)
        slot = np.zeros(p, np.int32)
        desired = rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32)
        for lane in range(pl):
            kind[lane] = atomics.STORE if lane % 2 == 0 else atomics.LOAD
            slot[lane] = lane                      # owner shard 0
        for src in range(1, s):
            base = src * pl
            kind[base], slot[base] = atomics.STORE, src
            kind[base + 1], slot[base + 1] = atomics.LOAD, src + 8 * src
        ops = (kind, slot, np.zeros((p, k), np.uint32), desired)
        self.drive(f"overflow/{strategy}", _mesh(s),
                   ("atomic", n, k, strategy, 64),
                   dict(axis="shard", n_shards=s, p_local=pl,
                        route_capacity=cap), init, 1, lambda _o: ops)

    def plugin(self):
        rng = np.random.default_rng(23)
        n, k, s, pl = 24, 2, 4, 4
        init = rng.integers(0, 2 ** 32, (n, k), dtype=np.uint32)
        self.drive("plugin", _mesh(s), ("atomic", n, k, W.PLUGIN, 32),
                   dict(axis="shard", n_shards=s, p_local=pl), init, 3,
                   lambda o: mixed_batch(rng, o.ctx, p=s * pl, n=n, k=k,
                                         current=o.data),
                   width=3, plugin=True)

    def twolevel(self, strategy):
        rng = np.random.default_rng(zlib.crc32(strategy.encode()) ^ 0x2E11)
        n, k, pl = 48, 3, 4
        for i, c in TWO_LEVEL:
            caps = dict(route_capacity=3, node_capacity=5) if c else {}
            init = rng.integers(0, 2 ** 32, (n, k), dtype=np.uint32)
            self.drive(_two_name(strategy, i, c), ((2, 4), ("node", "shard")),
                       ("atomic", n, k, strategy, 64),
                       dict(axis="shard", n_shards=8, p_local=pl, n_nodes=2,
                            node_axis="node", interleave=i, **caps),
                       init, 3,
                       lambda o: mixed_batch(rng, o.ctx, p=8 * pl, n=n, k=k,
                                             current=o.data))

    def oneshard(self, strategy):
        rng = np.random.default_rng(zlib.crc32(strategy.encode()) ^ 0x1)
        n, k, pl = 48, 3, 6
        init = rng.integers(0, 2 ** 32, (n, k), dtype=np.uint32)
        name = f"oneshard/{strategy}"
        self.drive(name, _mesh(1), ("atomic", n, k, strategy, 64),
                   dict(axis="shard", n_shards=1, p_local=pl), init, 3,
                   lambda o: mixed_batch(rng, o.ctx, p=pl, n=n, k=k,
                                         current=o.data))
        self.cases[-1]["kind"] = "oneshard"


    def v1(self):
        """`init_sharded` + `make_apply` (PLAIN, load / store / CAS): the
        reference's `reference_apply` on the global batch is the want."""
        import warnings
        rng = np.random.default_rng(31)
        n, k, s, pl = 16, 2, 4, 4
        p = s * pl
        data = rng.integers(0, 2 ** 32, (n, k), dtype=np.uint32)
        case = dict(name="v1", kind="v1", mesh=_mesh(s),
                    inner=("atomic", n, k, "plain", 64),
                    dist=dict(axis="shard", n_shards=s, p_local=pl),
                    init=data, batches=[])
        version, want = np.zeros(n, np.uint32), []
        for _ in range(2):
            slot = rng.integers(0, n, p).astype(np.int32)
            ops = (rng.integers(0, 3, p).astype(np.int32), slot,
                   np.where((rng.random(p) < 0.5)[:, None], data[slot],
                            0).astype(np.uint32),
                   rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32))
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", DeprecationWarning)
                data, version, res, ovf = ref_dsb.reference_apply(
                    data, version, ref_engine.OpBatch(*ops), n_shards=s,
                    p_local=pl)
            data, version = np.asarray(data), np.asarray(version)
            case["batches"].append(ops)
            want.append({"data": data, "version": version,
                         "value": np.asarray(res.value),
                         "success": np.asarray(res.success),
                         "count": len(ovf)})
        self.cases.append(case)
        self.expected["v1"] = want


def build():
    b = _Builder()
    b.v1()
    for st in LOCK_FREE:
        b.mixed(st)
    b.levers()
    checks = {st: b.sync_adversary(st) for st in LOCK_FREE}
    for st in LOCK_FREE:
        b.overflow(st)
    b.plugin()
    for st in LOCK_FREE:
        b.twolevel(st)
    for st in LOCK_FREE:
        b.oneshard(st)
    return b.cases, b.expected, checks


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world's run and the reference's, started together."""
    tmp = tmp_path_factory.mktemp("dist_tables")
    cases, expected, checks = build()
    inputs = tmp / "cases.pkl"
    inputs.write_bytes(pickle.dumps(cases))
    with W.reference("tables", inputs, tmp / "ref.pkl") as ref:
        rcs, tails, seconds = W.run_world("tables", inputs, tmp / "world",
                                          timeout=240)
        assert not any(rcs), "\n".join(tails)
        ref_out = W.finish_reference(ref, tmp / "ref.pkl")
    return {"cases": {c["name"]: c for c in cases}, "expected": expected,
            "checks": checks, "world": W.load_world(tmp / "world"),
            "ref": ref_out}


def _global_steps(runs, name):
    """The world's per-step results of `name` as global lane arrays, after
    checking that ranks holding the same shard saw the same."""
    case = runs["cases"][name]
    recs = {}
    for out in runs["world"]:
        rec = out[name]
        if rec["shard"] in recs:               # a replica: must agree
            for a, b in zip(recs[rec["shard"]]["steps"], rec["steps"]):
                for key in a:
                    np.testing.assert_equal(a[key], b[key],
                                            err_msg=f"{name}: replica {key}")
        else:
            recs[rec["shard"]] = rec
    spec = W.make_dspec(atomics, dsb, case)
    pl, k = spec.p_local, spec.inner.k
    width = case.get("width", pl)
    steps = []
    for j in range(len(case["batches"])):
        value = np.zeros((spec.p_global, k), np.uint32)
        success = np.zeros(spec.p_global, bool)
        overflow = np.zeros(spec.p_global, bool)
        ctx = [np.full(spec.p_global, -1, np.int32),
               np.zeros(spec.p_global, np.uint32),
               np.zeros((spec.p_global, k), np.uint32),
               np.zeros(spec.p_global, bool)]
        for sh in range(spec.n_shards):
            got = recs[sh]["steps"][j]
            lanes = slice(sh * pl, sh * pl + width)
            value[lanes], success[lanes] = got["value"], got["success"]
            overflow[lanes] = got["overflow"]
            for field, x in zip(ctx, got["ctx"]):
                field[lanes] = x.view(field.dtype)
        steps.append({"value": value, "success": success,
                      "overflow": overflow, "ctx": ctx,
                      "logical": recs[0]["steps"][j]["logical"],
                      "versions": recs[0]["steps"][j]["versions"],
                      "words": recs[0]["steps"][j]["words"]})
    return steps


def _assert_step(name, j, got, want, *, ctx=True):
    msg = f"{name} step {j}"
    np.testing.assert_array_equal(got["overflow"], want["overflow"],
                                  err_msg=f"{msg}: overflow")
    np.testing.assert_array_equal(got["value"], want["value"],
                                  err_msg=f"{msg}: values")
    np.testing.assert_array_equal(got["success"], want["success"],
                                  err_msg=f"{msg}: success")
    assert not np.asarray(got["success"])[want["overflow"]].any()
    np.testing.assert_array_equal(got["logical"], want["logical"],
                                  err_msg=f"{msg}: logical")
    np.testing.assert_array_equal(got["versions"], want["versions"],
                                  err_msg=f"{msg}: versions")
    if ctx:
        for field, a, b in zip(ref_engine.LinkCtx._fields, got["ctx"],
                               want["ctx"]):
            np.testing.assert_array_equal(np.asarray(a).astype(b.dtype), b,
                                          err_msg=f"{msg}: ctx.{field}")


@pytest.mark.parametrize("name", TABLE_CASES)
def test_sharded_apply_matches_oracle(runs, name):
    """Every step of every scenario, on every rank, equals the oracle's
    replay of the claimed order."""
    want = runs["expected"][name]
    for j, got in enumerate(_global_steps(runs, name)):
        _assert_step(name, j, got, want[j])


@pytest.mark.parametrize("name", REF_CASES)
def test_sharded_apply_matches_reference(runs, name):
    """The reference's live sharded `apply` on the same batches: the same
    per-lane results, links, logical values and versions."""
    got = runs["ref"][name]["steps"]
    want = runs["expected"][name]
    assert len(got) == len(want)
    for j, (g, w) in enumerate(zip(got, want)):
        _assert_step(f"{name} (reference)", j, g, w)


@pytest.mark.parametrize("name", ["levers/dedup1/ilv1/capp",
                                  _two_name("cached_me", True, True)])
def test_init_dist_is_the_reference_state_converted(runs, name):
    """Each rank's `init_dist` shard equals `convert.dist_state` of the
    reference's stacked `init_dist` state, and `dist_state_to_numpy` of the
    ranks' shards gives that state back."""
    case = runs["cases"][name]
    if not case["ref"]:
        stacked = _reference_init_stacked(case)
    else:
        stacked = runs["ref"][name]["init"]
    shards = {out[name]["shard"]: out[name]["init_local"]
              for out in runs["world"]}
    states = []
    for sh in sorted(shards):
        st = convert.dist_state(stacked, sh, device="cpu")
        states.append(st)
        for field, a, b in zip(st.local._fields, st.local, shards[sh]):
            np.testing.assert_array_equal(W.bits(a), b,
                                          err_msg=f"shard {sh}: {field}")
    for a, b in zip(convert.dist_state_to_numpy(states), stacked):
        np.testing.assert_array_equal(a, b)


def _reference_init_stacked(case):
    """The reference's `init_dist` leaves for `case`, stacked per shard
    as `init_dist` stacks them (its per-shard `engine.init`)."""
    import jax
    dspec = W.make_dspec(ref_atomics, ref_dsb, case)
    lsp = dspec.local_spec()
    s, init = dspec.n_shards, case["init"]
    shards = [init[i::s] if dspec.interleave else
              init[i * dspec.n_local:(i + 1) * dspec.n_local]
              for i in range(s)]
    locals_ = [jax.tree.map(np.asarray, ref_engine.init(lsp, x))
               for x in shards]
    return [W.bits(np.stack(xs)) for xs in zip(*locals_)]


@pytest.mark.parametrize("strategy", LOCK_FREE)
def test_sync_adversaries_through_routing(runs, strategy):
    """ABA restored on a remote shard fails VALIDATE and SC; every fresh
    link's SC succeeds; the lapped linker's SC fails."""
    name = f"sync_adversary/{strategy}"
    steps = _global_steps(runs, name)
    for j, lane, ok in runs["checks"][strategy]:
        assert bool(steps[j]["success"][lane]) == ok, (j, lane)
    np.testing.assert_array_equal(steps[2]["logical"][9],
                                  runs["cases"][name]["init"][9])


@pytest.mark.parametrize("strategy", LOCK_FREE)
def test_overflow_lanes_are_reported(runs, strategy):
    """Source 0's lanes 3..7 exceed route_capacity=3 toward shard 0: they
    are reported, fail, and leave no trace (the oracle skips them)."""
    got = _global_steps(runs, f"overflow/{strategy}")[0]
    assert list(np.nonzero(got["overflow"])[0]) == [3, 4, 5, 6, 7]
    assert not got["success"][3:8].any()


@pytest.mark.parametrize("name", ["mixed/seqlock/s4", "mixed/cached_me/s8",
                                  "levers/dedup0/ilv1/cap3",
                                  _two_name("cached_wf", False, False),
                                  _two_name("cached_me", True, True)])
def test_words_handed_to_all_to_all(runs, name):
    """Flat specs: one `all_to_all_single` out ([s, cap, 2k+4]) and one
    back ([s, cap, k+2]), `collective_words(dspec)` in all.  Two-level:
    phase 1 out [d, cap, 2k+5], phase 2 out [nn, cap2, 2k+4], back
    [nn, cap2, k+2] and [d, cap, k+3]: the reference's
    `collective_words` counts one word more per phase-2 lane than the
    route moves (3k + 7 where out and back are 3k + 6), and the port
    keeps its formula."""
    case = runs["cases"][name]
    spec = W.make_dspec(atomics, dsb, case)
    k = spec.inner.k
    if spec.n_nodes == 1:
        s, cap = spec.n_shards, spec.cap
        want = [s * cap * (2 * k + 4), s * cap * (k + 2)]
        assert sum(want) == dsb.collective_words(spec)
    else:
        d, nn, cap, cap2 = (spec.devs_per_node, spec.n_nodes, spec.cap,
                            spec.cap2)
        want = [d * cap * (2 * k + 5), nn * cap2 * (2 * k + 4),
                nn * cap2 * (k + 2), d * cap * (k + 3)]
        assert sum(want) == dsb.collective_words(spec) - nn * cap2
    for out in runs["world"]:
        for step in out[name]["steps"]:
            assert step["words"] == want


@pytest.mark.parametrize("strategy", LOCK_FREE)
def test_one_shard_apply_equals_atomics_apply(runs, strategy):
    """At one shard (an all_to_all to self each way) `dist.apply` equals
    `atomics.apply` on the same state, batch and ctx, field by field, and
    the oracle."""
    name = f"oneshard/{strategy}"
    want = runs["expected"][name]
    for out in runs["world"]:
        for j, step in enumerate(out[name]["steps"]):
            for a, b in zip(step["dist"], step["apply"]):
                np.testing.assert_array_equal(a, b)
            value, success, *ctx, lg, ver = step["dist"]
            _assert_step(name, j, {"value": value, "success": success,
                                   "overflow": step["overflow"],
                                   "ctx": ctx, "logical": lg,
                                   "versions": ver}, want[j])


@pytest.mark.parametrize("name", [_lever_name(*x) for x in LEVERS])
def test_apply_round_claims_the_order(runs, name):
    """`apply_round(..., with_order=True)` gathers the ranks' kinds and
    slots and claims `linearization_order` of the global batch; its
    handle is ready once waited on."""
    want = runs["expected"][name]
    for out in runs["world"]:
        for j, step in enumerate(out[name]["steps"]):
            assert step["ready"]
            np.testing.assert_array_equal(step["order"], want[j]["order"])


def test_counters_count_each_rank_s_rounds(runs):
    """Under BIGATOMIC_OBS=counters each rank counts its own collective
    rounds, `collective_words(dspec)` each, and its own lanes' route
    overflow (summed over the shards: the batch's, as the reference's
    one controller counts it); the local rounds count no engine batch,
    as the reference's `linearize` inside `shard_map` does not."""
    case = runs["cases"][COUNTED]
    spec = W.make_dspec(atomics, dsb, case)
    steps = len(case["batches"])
    total = {}
    for out in runs["world"]:
        rec = out[COUNTED]
        snap = rec["snapshot"]
        assert snap["dist.rounds"] == steps
        assert snap["dist.words"] == steps * dsb.collective_words(spec)
        assert snap["dist.route_overflow"] == sum(
            int(st["overflow"].sum()) for st in rec["steps"])
        assert snap["engine.batches"] == 0
        total[rec["shard"]] = snap["dist.route_overflow"]
    want = sum(int(w["overflow"].sum()) for w in runs["expected"][COUNTED])
    assert want > 0 and sum(total.values()) == want


def test_v1_make_apply_matches_reference_apply(runs):
    """The v1 shims on every rank's block: the blocks in shard order are
    the reference's `reference_apply` table, the lanes its results, and
    every rank's overflow count the batch's."""
    want = runs["expected"]["v1"]
    recs = {out["v1"]["shard"]: out["v1"] for out in runs["world"]}
    for out in runs["world"]:
        for j, step in enumerate(out["v1"]["steps"]):
            assert step["count"] == want[j]["count"]
    for j, w in enumerate(want):
        got = [recs[sh]["steps"][j] for sh in sorted(recs)]
        np.testing.assert_array_equal(
            np.concatenate([g["data"] for g in got]), w["data"])
        np.testing.assert_array_equal(
            np.concatenate([g["version"] for g in got]), w["version"])
        np.testing.assert_array_equal(
            np.concatenate([g["value"] for g in got]), w["value"])
        np.testing.assert_array_equal(
            np.concatenate([g["success"] for g in got]), w["success"])


def test_every_rank_holds_the_same_global_view(runs):
    """`logical` and `versions` all-gather: all 8 ranks, replicas
    included, return the same global arrays."""
    for name in TABLE_CASES:
        first = runs["world"][0][name]["steps"]
        for out in runs["world"][1:]:
            for a, b in zip(first, out[name]["steps"]):
                np.testing.assert_array_equal(a["logical"], b["logical"])
                np.testing.assert_array_equal(a["versions"], b["versions"])


# ---------------------------------------------------------------------------
# In process: the host-side pieces against the reference's.
# ---------------------------------------------------------------------------

SPEC_VARIANTS = {
    "flat": dict(),
    "cap2": dict(route_capacity=2),
    "dedup": dict(dedup_loads=True),
    "interleave": dict(interleave=True),
    "dedup_interleave_cap3": dict(dedup_loads=True, interleave=True,
                                  route_capacity=3),
    "two_level": dict(n_nodes=2),
    "two_level_capped": dict(n_nodes=2, route_capacity=2, node_capacity=3),
    "two_level_interleave_dedup": dict(n_nodes=2, interleave=True,
                                       dedup_loads=True, route_capacity=3),
}


def _both_specs(variant, *, n=32, k=2, s=4, pl=8, hash_=False):
    out = []
    for mod_atomics, mod in ((ref_atomics, ref_dsb), (atomics, dsb)):
        inner = (mod_atomics.HashSpec(64, vw=2) if hash_ else
                 mod_atomics.AtomicSpec(n, k))
        out.append(mod.DistSpec(inner, "shard", s, pl,
                                **SPEC_VARIANTS.get(variant, {})))
    return out


@pytest.mark.parametrize("variant", list(SPEC_VARIANTS) + ["hash"])
def test_linearization_order_matches_reference(variant):
    """The claimed order and overflow mask, over hot-slot batches with
    out-of-range slots, narrower batches, every lever and hash specs."""
    ref_spec, spec = _both_specs(variant, hash_=variant == "hash")
    rng = np.random.default_rng(zlib.crc32(variant.encode()))
    for trial in range(6):
        q = spec.p_global - (trial % 3)
        kind = np.where(rng.random(q) < 0.6, atomics.LOAD,
                        rng.integers(0, 7, q)).astype(np.int32)
        if variant == "hash":
            kind = rng.integers(atomics.FIND, atomics.DELETE + 1,
                                q).astype(np.int32)
            kind[rng.random(q) < 0.1] = atomics.IDLE
        slot = rng.integers(-3, 40 if trial % 2 else 6, q).astype(np.int32)
        ops = (kind, slot, None, None)
        want = ref_dsb.linearization_order(ref_spec,
                                           ref_engine.OpBatch(*ops))
        got = dsb.linearization_order(spec, atomics.OpBatch(*ops))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("variant", list(SPEC_VARIANTS) + ["hash"])
def test_collective_words_match_reference(variant):
    ref_spec, spec = _both_specs(variant, hash_=variant == "hash")
    assert dsb.collective_words(spec) == ref_dsb.collective_words(ref_spec)
    if not spec.is_hash:
        for t_local, w in ((1, 1), (3, 2), (8, 4)):
            assert dsb.mcas_collective_words(spec, t_local, w) == \
                ref_dsb.mcas_collective_words(ref_spec, t_local, w)
    for field in ("n_global", "n_local", "p_global", "cap", "devs_per_node",
                  "cap2"):
        assert getattr(spec, field) == getattr(ref_spec, field)
    assert dataclasses.asdict(spec.local_spec()) == \
        dataclasses.asdict(ref_spec.local_spec())


BAD_SPECS = {
    "zero_shards": (("atomic",), dict(n_shards=0)),
    "zero_lanes": (("atomic",), dict(p_local=0)),
    "zero_nodes": (("atomic",), dict(n_nodes=0)),
    "hash_two_level": (("hash",), dict(n_shards=4, n_nodes=2)),
    "nodes_not_dividing": (("atomic",), dict(n_shards=4, n_nodes=3)),
    "zero_node_capacity": (("atomic",), dict(node_capacity=0)),
    "hash_interleave": (("hash",), dict(interleave=True)),
    "hash_dedup": (("hash",), dict(dedup_loads=True)),
    "hash_nb": (("hash",), dict(n_shards=3)),
    "table_n": (("atomic",), dict(n_shards=5)),
    "inner_type": (("other",), dict()),
    "zero_capacity": (("atomic",), dict(route_capacity=0)),
}


@pytest.mark.parametrize("case", list(BAD_SPECS))
def test_dist_spec_errors_match_reference(case):
    (what,), kw = BAD_SPECS[case]
    errors = []
    for mod_atomics, mod in ((ref_atomics, ref_dsb), (atomics, dsb)):
        inner = {"atomic": lambda: mod_atomics.AtomicSpec(32, 2),
                 "hash": lambda: mod_atomics.HashSpec(64, vw=1),
                 "other": lambda: (32, 2)}[what]()
        with pytest.raises((ValueError, TypeError)) as err:
            mod.DistSpec(inner, **kw)
        errors.append((err.type, str(err.value)))
    assert errors[0] == errors[1]


def test_make_mesh_defaults_to_the_card():
    """Without `device=` the mesh is on the card: here, with none, it
    raises before touching a process group; on the CPU it needs one."""
    with pytest.raises(RuntimeError, match="CUDA"):
        dsb.make_mesh((1,), ("shard",))
    with pytest.raises(RuntimeError, match="process group"):
        dsb.make_mesh((1,), ("shard",), device="cpu")


def test_public_names_match_reference():
    import inspect
    names = {name for name, obj in vars(ref_dsb).items()
             if not name.startswith("_")
             and getattr(obj, "__module__", None) == ref_dsb.__name__}
    missing = sorted(n for n in names if not hasattr(dsb, n))
    assert not missing, missing
    assert inspect.signature(dsb.linearization_order).parameters.keys() == \
        inspect.signature(ref_dsb.linearization_order).parameters.keys()
    assert atomics.dist is dsb
    assert atomics.DistSpec is dsb.DistSpec
    assert atomics.DistState is dsb.DistState


@pytest.mark.parametrize("interleave", [False, True])
def test_reference_apply_shim_matches_reference(interleave):
    import warnings
    rng = np.random.default_rng(3 + interleave)
    n, k, s, pl = 16, 2, 4, 4
    data = rng.integers(0, 2 ** 32, (n, k), dtype=np.uint32)
    version = np.zeros(n, np.uint32)
    p = s * pl
    ops = (rng.integers(0, 3, p).astype(np.int32),
           rng.integers(0, n, p).astype(np.int32),
           np.where((rng.random(p) < 0.5)[:, None], data[rng.integers(
               0, n, p)], 0).astype(np.uint32),
           rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = ref_dsb.reference_apply(data, version,
                                       ref_engine.OpBatch(*ops),
                                       n_shards=s, p_local=pl,
                                       interleave=interleave)
        got = dsb.reference_apply(data, version, atomics.OpBatch(*ops),
                                  n_shards=s, p_local=pl,
                                  interleave=interleave)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(got[2], want[2]):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert got[3] == want[3]


@pytest.mark.parametrize("what", ["table", "hash"])
def test_convert_dist_state_round_trip(what):
    """A stacked reference state -> the port's per-shard states -> back,
    bit for bit; each shard equals the port's own `init` of it."""
    import jax
    from repro.core import cachehash as ref_ch
    from repro_torch.core import cachehash as ch
    from repro_torch.core import engine
    s = 4
    rng = np.random.default_rng(11)
    if what == "table":
        spec = atomics.AtomicSpec(8, 3, "cached_me", p_max=4)
        init = rng.integers(0, 2 ** 32, (s * 8, 3), dtype=np.uint32)
        refs = [ref_engine.init(ref_atomics.AtomicSpec(8, 3, "cached_me",
                                                       p_max=4),
                                init[i * 8:(i + 1) * 8]) for i in range(s)]
        mine = [engine.init(spec, init[i * 8:(i + 1) * 8], device="cpu")
                for i in range(s)]
    else:
        refs = [ref_ch.init_hash(ref_atomics.HashSpec(16, vw=2))
                for _ in range(s)]
        mine = [ch.init_hash(atomics.HashSpec(16, vw=2), device="cpu")
                for _ in range(s)]
    stacked = jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                           *refs)
    states = [convert.dist_state(stacked, i, device="cpu") for i in range(s)]
    for st, own in zip(states, mine):
        flat = jax.tree.leaves(tuple(st.local))
        for a, b in zip(flat, jax.tree.leaves(tuple(own))):
            assert torch.equal(a, b)
    back = convert.dist_state_to_numpy(states)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(stacked)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
