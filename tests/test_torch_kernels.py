"""The port's raw-table kernel layer (`repro_torch.kernels`: seqlock_gather,
cas_apply, llsc_commit, cachehash_probe and ops) against the JAX reference.

One subprocess installs the jax alias the reference's Pallas kernels need
on this jax, runs the four kernels with interpret=True, the reference's
`ops` functions and `llsc_commit.commit_round(..., interpret=True)` on
seeded numpy inputs; the port's wrappers on CPU tensors (which run the
plain versions of `kernels/ref.py`) must reproduce every output bit for
bit, dead-lane witnesses and the updated tables included.  Property tests
hold the plain versions against numpy oracles, and the last tests pin the
wrappers' device rules and the kernel build.  Tolerance is zero: words
compare as uint32 bit patterns."""

import ctypes
import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch import atomics as tatomics
from repro_torch import convert
from repro_torch import kernels as tk
from repro_torch.core import engine as tengine
from repro_torch.kernels import _build, llsc_commit, ops, ref
from torch_threads import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
STORE, CAS, FULL = ref.STORE, ref.CAS, ref.FULL
NEXT_END = np.uint32(2 ** 32 - 1)              # next = -1: end of chain


# ---------------------------------------------------------------------------
# Seeded inputs (numpy, the reference's uint32 words).
# ---------------------------------------------------------------------------

def make_table(rng, n1, k, locked=0.0, marked=0.0):
    """data uint32[n1, k] and meta uint32[n1, 2] = (version, mark): even
    versions, a share of them odd (locked), a share of rows marked."""
    data = rng.integers(0, 2 ** 32, (n1, k), dtype=np.uint32)
    meta = np.zeros((n1, 2), np.uint32)
    meta[:, 0] = rng.integers(0, 8, n1) * 2 + (rng.random(n1) < locked)
    meta[:, 1] = rng.random(n1) < marked
    return data, meta


def round_lanes(rng, n, p, live_frac=0.7):
    """p lanes over a table of n cells + dummy row n: distinct real slots
    for a share of the lanes, the dummy row for the rest, interleaved."""
    n_real = min(int(p * live_frac) + 1, n, p)
    slot = np.full(p, n, np.int32)
    slot[:n_real] = rng.choice(n, n_real, replace=False)
    perm = rng.permutation(p)
    return slot[perm], (np.arange(p) < n_real)[perm]


def cas_case(rng, n, k, p):
    data, meta = make_table(rng, n + 1, k, locked=0.2, marked=0.2)
    slot, real = round_lanes(rng, n, p)
    kind = np.where(real, rng.choice([STORE, CAS], p), 0).astype(np.int32)
    kind[real & (rng.random(p) < 0.15)] = 0        # LOAD-like dead lanes
    expected = rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32)
    take = rng.random(p) < 0.5
    expected[take] = data[slot[take]]
    first = np.flatnonzero(kind == STORE)
    if first.size:                                 # version wraps mod 2^32
        meta[slot[first[0]], 0] = 2 ** 32 - 2
    return dict(data=data, meta=meta, slot=slot, kind=kind,
                expected=expected,
                desired=rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32))


def llsc_case(rng, n, k, p):
    data, meta = make_table(rng, n + 1, k, locked=0.2, marked=0.2)
    slot, real = round_lanes(rng, n, p)
    live = (real & (rng.random(p) < 0.85)).astype(np.int32)
    cur = meta[slot, 0]
    link_ver = np.where(rng.random(p) < 0.5, cur, cur + 2).astype(np.uint32)
    ok = np.flatnonzero(live & (link_ver == cur))
    if ok.size:
        meta[slot[ok[0]], 0] = link_ver[ok[0]] = 2 ** 32 - 2
    return dict(data=data, meta=meta, slot=slot, live=live,
                link_ver=link_ver,
                desired=rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32))


def probe_case(rng, m, kw, vw, q):
    """Bucket rows [key | value | next | flags | version]: full rows with a
    terminated or chained next, empty rows holding garbage and flags 0 or
    2; half the queries carry their bucket's key."""
    cw = kw + vw + 3
    cells = rng.integers(0, 2 ** 32, (m, cw), dtype=np.uint32)
    full = rng.random(m) < 0.6
    cells[:, kw + vw] = np.where(rng.random(m) < 0.5, NEXT_END,
                                 rng.integers(0, 8, m))
    cells[:, kw + vw + 1] = np.where(full, FULL,
                                     rng.choice([0, 2], m)).astype(np.uint32)
    bidx = rng.integers(0, m, q).astype(np.int32)
    keys = rng.integers(0, 2 ** 32, (q, kw), dtype=np.uint32)
    take = rng.random(q) < 0.5
    keys[take] = cells[bidx[take], :kw]
    return dict(cells=cells, bucket_idx=bidx, query_keys=keys)


def np_hash(keys, m):
    """The reference's multiplicative hash in numpy uint32 arithmetic."""
    h = np.zeros(keys.shape[0], np.uint32)
    for j in range(keys.shape[1]):
        h = (h ^ keys[:, j]) * np.uint32(0x9E3779B1)
        h = h ^ (h >> np.uint32(15))
    return (h % np.uint32(m)).astype(np.int32)


def build_cachehash(rng, m, kw, vw, n_keys, max_chain=8):
    """A CacheHash table holding `n_keys` distinct keys placed by the hash:
    the first key of a bucket inline, the rest in `chain_pool` chains (at
    most `max_chain` deep; keys past that are left out).  Returns (cells,
    chain_pool, keys, values, depth) for the placed keys, depth 0 =
    inline."""
    cw = kw + vw + 3
    keys = np.unique(rng.integers(1, 2 ** 32, (n_keys, kw), dtype=np.uint32),
                     axis=0)
    keys = keys[rng.permutation(len(keys))]
    vals = rng.integers(0, 2 ** 32, (len(keys), vw), dtype=np.uint32)
    bucket = np_hash(keys, m)
    order = np.argsort(bucket, kind="stable")
    keys, vals, bucket = keys[order], vals[order], bucket[order]
    idx = np.arange(len(keys))
    start = np.r_[True, bucket[1:] != bucket[:-1]]
    depth = idx - np.maximum.accumulate(np.where(start, idx, 0))
    keep = depth <= max_chain
    keys, vals, bucket, depth = keys[keep], vals[keep], bucket[keep], \
        depth[keep]
    rows = np.zeros((len(keys), cw), np.uint32)
    rows[:, :kw], rows[:, kw:kw + vw] = keys, vals
    rows[:, kw + vw + 1] = FULL
    chained = depth > 0
    node = np.cumsum(chained) - 1                  # chain-pool index
    has_next = np.r_[bucket[1:] == bucket[:-1], False]
    nxt_node = np.r_[node[1:], 0]
    rows[:, kw + vw] = np.where(has_next, nxt_node, NEXT_END)
    cells = np.zeros((m, cw), np.uint32)
    cells[bucket[~chained]] = rows[~chained]
    pool = np.zeros((max(int(chained.sum()), 1), cw), np.uint32)
    pool[:chained.sum()] = rows[chained]
    return cells, pool, keys, vals, depth


def chain_case(rng, m, kw, vw, n_keys, shape):
    """A CacheHash table of `n_keys` keys in m buckets (chains up to 8
    deep) and queries: placed keys inline and chained, and absent ones.
    shape "clamp": each chain's last node points past the pool's end (the
    walk reads the pool's last node), and so does the link to the pool's
    last node, whose key is queried; "cycle": each chain's last node
    points back at its first; "plain": as built."""
    cells, pool, keys, _, depth = build_cachehash(rng, m, kw, vw, n_keys)
    c = len(pool)
    if shape == "clamp":
        cells[cells[:, kw + vw] == c - 1, kw + vw] = c + 3
        pool[pool[:, kw + vw] == c - 1, kw + vw] = c + 3
    heads = (cells[:, kw + vw + 1] == FULL) & (cells[:, kw + vw] < c)
    for b in np.flatnonzero(heads):
        head = tail = int(cells[b, kw + vw])
        while pool[tail, kw + vw] < c:
            tail = int(pool[tail, kw + vw])
        if shape == "clamp":
            pool[tail, kw + vw] = c + 3
        elif shape == "cycle":
            pool[tail, kw + vw] = head
    absent = rng.integers(0, 2 ** 32, (20, kw), dtype=np.uint32)
    qk = np.concatenate([keys[depth == 0][:15], keys[depth > 0][:25],
                         absent, pool[-1:, :kw]])
    return cells, pool, qk


def update_case(rng, n, k, p, zipf, update_frac, one_cell=False,
                chain=0.0):
    """A random_batch-style STORE/CAS/LOAD batch, sorted by slot and ranked
    into rounds as the reference's tests do.  one_cell: every lane on one
    slot; chain: the share of lanes whose comparand is the desired row of
    the lane before on their cell."""
    data0, meta = make_table(rng, n + 1, k)
    slot = ((rng.zipf(1.5, p) - 1) % n if zipf else rng.integers(0, n, p))
    if one_cell:
        slot = np.full(p, slot[0])
    u = rng.random(p) < update_frac
    kind = np.where(u, np.where(rng.random(p) < 0.5, CAS, STORE), 0)
    expected = rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32)
    take = rng.random(p) < 0.5
    expected[take] = data0[slot[take]]
    desired = rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32)
    order = np.argsort(slot, kind="stable")
    s_slot = slot[order].astype(np.int32)
    expected, desired = expected[order], desired[order]
    idx = np.arange(p)
    start = np.r_[True, s_slot[1:] != s_slot[:-1]]
    rank = (idx - np.maximum.accumulate(np.where(start, idx, 0)))
    follow = np.flatnonzero((rng.random(p) < chain)[1:] & ~start[1:]) + 1
    expected[follow] = desired[follow - 1]
    return dict(data=data0, meta=meta, slot=s_slot,
                kind=kind[order].astype(np.int32), expected=expected,
                desired=desired, upd_rank=rank.astype(np.int32)), \
        int(rank.max()) + 1


def commit_case(rng, n, k, p):
    """An initial table, a LinkCtx with current, stale, unlinked and
    mismatched links, and an SC batch over distinct slots (dead: n)."""
    slot, real = round_lanes(rng, n, p)
    c_slot = np.where(rng.random(p) < 0.85, slot, rng.integers(0, n, p))
    c_ver = np.where(rng.random(p) < 0.6, 0, 2).astype(np.uint32)
    return dict(initial=rng.integers(0, 2 ** 32, (n, k), dtype=np.uint32),
                c_slot=c_slot.astype(np.int32), c_ver=c_ver,
                c_val=rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32),
                c_linked=rng.random(p) < 0.8, slots=slot,
                desired=rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32))


# The inputs the one-launch replay of `bigatomic_update_rounds` finds hard:
# {name: (update_case arguments, rounds left out)}.
UPDATE_HARD = {
    "one-cell": ((10, 4, 40, False, 0.8, True, 0.4), 0),
    "loads-in-long-segments": ((4, 3, 36, True, 0.5, False, 0.3), 0),
    "truncated": ((6, 4, 30, True, 1.0, False, 0.3), 3),
    "one-cell-truncated": ((9, 2, 33, False, 0.9, True, 0.5), 12),
    "k1": ((8, 1, 33, True, 0.8, False, 0.4), 0),
    "k3": ((8, 3, 35, True, 0.8, False, 0.4), 0),
    "k5-loads": ((8, 5, 35, True, 0.7, False, 0.4), 0),
    "k16": ((8, 16, 34, True, 0.8, False, 0.4), 0),
}


def _cases():
    """{name: (function, static kwargs, {arg: array})}, seeded."""
    rng = np.random.default_rng(2024)
    cases = {}
    for n, k, q in [(8, 4, 5), (64, 8, 64), (16, 16, 100), (33, 3, 13),
                    (40, 5, 27), (20, 1, 9)]:
        data, meta = make_table(rng, n, k, locked=0.2, marked=0.2)
        cases[f"seqlock_gather-n{n}-k{k}-q{q}"] = (
            "seqlock_gather", {},
            dict(data=data, meta=meta,
                 idx=rng.integers(0, n, q).astype(np.int32)))
    for n, k, p in [(8, 4, 6), (64, 8, 32), (31, 3, 13), (40, 5, 21),
                    (16, 1, 11), (24, 16, 9)]:
        cases[f"cas_apply_round-n{n}-k{k}-p{p}"] = (
            "cas_apply_round", {}, cas_case(rng, n, k, p))
        cases[f"llsc_commit_round-n{n}-k{k}-p{p}"] = (
            "llsc_commit_round", {}, llsc_case(rng, n, k, p))
    for m, kw, vw, q in [(16, 1, 1, 8), (64, 2, 2, 33), (128, 4, 2, 64),
                         (32, 2, 4, 13)]:
        cases[f"cachehash_probe-m{m}-kw{kw}-vw{vw}-q{q}"] = (
            "cachehash_probe", dict(kw=kw, vw=vw), probe_case(rng, m, kw, vw,
                                                              q))
    data, meta = make_table(rng, 51, 4, locked=0.2, marked=0.2)
    cases["bigatomic_load"] = ("bigatomic_load", {}, dict(
        data=data, meta=meta, idx=rng.integers(0, 50, 37).astype(np.int32)))
    for name, args in [("uniform", (16, 4, 24, False, 1.0)),
                       ("hot-with-loads", (12, 3, 29, True, 0.7)),
                       ("k5", (20, 5, 17, True, 1.0))]:
        arrays, rounds = update_case(rng, *args)
        cases[f"bigatomic_update_rounds-{name}"] = (
            "bigatomic_update_rounds", dict(rounds=rounds), arrays)
    for name, (args, cut) in UPDATE_HARD.items():
        arrays, rounds = update_case(rng, *args)
        cases[f"bigatomic_update_rounds-{name}"] = (
            "bigatomic_update_rounds", dict(rounds=rounds - cut), arrays)
    for m, kw in [(1000, 2), (97, 1), (2 ** 20 + 7, 4), (2 ** 22, 2), (1, 3)]:
        keys = rng.integers(0, 2 ** 32, (40, kw), dtype=np.uint32)
        keys[0] = 2 ** 32 - 1
        keys[1] = 2 ** 31
        cases[f"hash_keys-m{m}-kw{kw}"] = ("hash_keys", dict(m=m),
                                           dict(keys=keys))
    for m, kw, vw, n_keys in [(64, 2, 2, 90), (32, 1, 3, 70)]:
        cells, pool, keys, _, depth = build_cachehash(rng, m, kw, vw, n_keys)
        absent = rng.integers(0, 2 ** 32, (10, kw), dtype=np.uint32)
        qk = np.concatenate([keys[depth == 0][:10], keys[depth > 0][:10],
                             absent])
        cases[f"cachehash_find-m{m}-kw{kw}-vw{vw}"] = (
            "cachehash_find", dict(kw=kw, vw=vw),
            dict(cells=cells, chain_pool=pool, query_keys=qk))
    for shape, max_chain in [("clamp", 8), ("cycle", 8), ("cycle", 30),
                             ("plain", 0)]:
        cells, pool, qk = chain_case(rng, 16, 2, 2, 60, shape)
        cases[f"cachehash_find-{shape}-max_chain{max_chain}"] = (
            "cachehash_find", dict(kw=2, vw=2, max_chain=max_chain),
            dict(cells=cells, chain_pool=pool, query_keys=qk))
    for strategy in ("seqlock", "indirect", "cached_wf", "cached_me"):
        cases[f"commit_round-{strategy}"] = (
            "commit_round", dict(strategy=strategy, n=16, k=3, p_max=12),
            commit_case(rng, 16, 3, 12))
    return cases


CASES = _cases()

_JAX_SCRIPT = textwrap.dedent("""
    import json, sys
    import numpy as np
    from jax.experimental.pallas import tpu as pltpu
    if not hasattr(pltpu, "TPUMemorySpace"):   # renamed in newer jax
        pltpu.TPUMemorySpace = pltpu.MemorySpace
    import jax.numpy as jnp
    from repro.core import engine, strategies  # noqa: F401 (registers)
    from repro.core.specs import AtomicSpec
    from repro.kernels import llsc_commit, ops
    from repro.kernels.cachehash_probe import cachehash_probe
    from repro.kernels.cas_apply import cas_apply_round
    from repro.kernels.seqlock_gather import seqlock_gather

    FNS = {"seqlock_gather": seqlock_gather,
           "cas_apply_round": cas_apply_round,
           "llsc_commit_round": llsc_commit.llsc_commit_round,
           "cachehash_probe": cachehash_probe,
           "bigatomic_load": ops.bigatomic_load,
           "bigatomic_update_rounds": ops.bigatomic_update_rounds,
           "cachehash_find": ops.cachehash_find}
    cases = json.load(open(sys.argv[1]))
    arrays = np.load(sys.argv[2])
    out = {}
    for name, (fn, static, names) in cases.items():
        a = {f: jnp.asarray(arrays[f"{name}/{f}"]) for f in names}
        if fn == "hash_keys":
            outs = [ops.hash_keys(a["keys"], static["m"])]
        elif fn == "commit_round":
            spec = AtomicSpec(static["n"], static["k"], static["strategy"],
                              p_max=static["p_max"])
            state = engine.init(spec, a["initial"])
            for i, x in enumerate(state):
                out[f"{name}/init{i}"] = np.asarray(x)
            ctx = engine.LinkCtx(a["c_slot"], a["c_ver"], a["c_val"],
                                 a["c_linked"])
            st2, ctx2, succ, wit = llsc_commit.commit_round(
                spec, state, ctx, a["slots"], a["desired"], interpret=True)
            outs = [*st2, *ctx2, succ, wit]
        else:
            outs = FNS[fn](**a, **static, interpret=True)
        for i, x in enumerate(outs):
            out[f"{name}/{i}"] = np.asarray(x)
    np.savez(sys.argv[3], **out)
""")


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    """Every case through the reference, in one subprocess."""
    tmp = tmp_path_factory.mktemp("jax_table_ops")
    spec = {name: (fn, static, sorted(arrays))
            for name, (fn, static, arrays) in CASES.items()}
    (tmp / "cases.json").write_text(json.dumps(spec))
    np.savez(tmp / "in.npz", **{f"{name}/{f}": x
                                for name, (_, _, arrays) in CASES.items()
                                for f, x in arrays.items()})
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_SCRIPT, str(tmp / "cases.json"),
         str(tmp / "in.npz"), str(tmp / "out.npz")],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(tmp / "out.npz"))


def to_port(x):
    """A reference array as a port tensor on the CPU (uint32 -> word)."""
    return convert.tensor(x, "cpu", word=x.dtype == np.uint32)


def assert_bits(got, want, label):
    """Equal shape and bits; word tensors compare as uint32."""
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    if want.dtype == np.uint32 and got.dtype == np.int32:
        got = got.view(np.uint32)
    assert got.shape == want.shape, f"{label}: {got.shape} vs {want.shape}"
    np.testing.assert_array_equal(got, want, err_msg=label)


def run_port(fn, static, arrays):
    a = {f: to_port(x) for f, x in arrays.items()}
    if fn in ("seqlock_gather", "cas_apply_round", "llsc_commit_round",
              "cachehash_probe"):
        out = getattr(tk, fn)(**a, **static)
    else:
        out = getattr(ops, fn)(**a, **static)
    return out if isinstance(out, tuple) else (out,)


# ---------------------------------------------------------------------------
# (a), (b): the port against the reference's kernels, ops and commit_round.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [n for n in CASES
                                  if not n.startswith("commit_round")])
def test_port_matches_reference(jax_out, name):
    """Kernels (interpret mode) and `ops` functions: every output equal bit
    for bit, the in-place updated tables and dead lanes included; no CPU
    call launches a kernel."""
    fn, static, arrays = CASES[name]
    before = tk.launch_counts()
    out = run_port(fn, static, arrays)
    want = [jax_out[f"{name}/{i}"] for i in range(len(out))]
    assert f"{name}/{len(out)}" not in jax_out
    for i, (g, w) in enumerate(zip(out, want)):
        assert_bits(g, w, f"{name}: output {i}")
    assert tk.launch_counts() == before


@pytest.mark.parametrize("strategy",
                         ["seqlock", "indirect", "cached_wf", "cached_me"])
def test_commit_round_matches_reference(jax_out, strategy):
    """`commit_round` on the reference's initial state: the new state, ctx,
    success and witness equal the reference's (which runs the Pallas fast
    round in interpret mode)."""
    name = f"commit_round-{strategy}"
    _, static, a = CASES[name]
    spec = tatomics.AtomicSpec(static["n"], static["k"], strategy,
                               p_max=static["p_max"])
    n_fields = len(tatomics.TableState._fields)
    state = convert.table_state(
        [jax_out[f"{name}/init{i}"] for i in range(n_fields)], "cpu")
    ctx = convert.link_ctx((a["c_slot"], a["c_ver"], a["c_val"],
                            a["c_linked"]), "cpu")
    new_state, new_ctx, succ, wit = llsc_commit.commit_round(
        spec, state, ctx, torch.from_numpy(a["slots"]),
        convert.tensor(a["desired"], "cpu", word=True))
    got = [*convert.to_numpy(new_state), *convert.to_numpy(new_ctx),
           succ.numpy(), convert.array(wit, word=True)]
    for i, g in enumerate(got):
        assert_bits(g, jax_out[f"{name}/{i}"], f"{name}: output {i}")
    assert succ.any() and not succ.all()


def test_commit_round_leaves_state_unless_donated():
    spec = tatomics.AtomicSpec(8, 2, "cached_me", p_max=4)
    state = tatomics.init(spec, device="cpu")
    ctx = tengine.LinkCtx(torch.tensor([1, 2], dtype=torch.int32),
                          torch.zeros(2, dtype=torch.int32),
                          torch.zeros((2, 2), dtype=torch.int32),
                          torch.ones(2, dtype=torch.bool))
    desired = np.array([[5, 6], [7, 8]], np.uint32)
    new, _, succ, _ = llsc_commit.commit_round(spec, state, ctx, [1, 2],
                                               desired)
    assert succ.tolist() == [True, True]
    assert not state.data.any() and int(new.version[1]) == 2
    new, *_ = llsc_commit.commit_round(spec, state, ctx, [1, 2], desired,
                                       donate=True)
    assert new.data.data_ptr() == state.data.data_ptr()
    assert state.data[1].tolist() == [5, 6] and int(new.version[2]) == 2


# ---------------------------------------------------------------------------
# (c): property tests of the plain versions against numpy oracles.
# ---------------------------------------------------------------------------

def np_round(data, meta, slot, lane_ok):
    """Sequential numpy round: lane i reads row slot[i] (the witness) and,
    iff lane_ok(i, row, version), writes desired and bumps the version."""
    data, meta = data.copy(), meta.copy()
    p = slot.shape[0]
    succ = np.zeros((p, 1), np.int32)
    wit = np.zeros((p, data.shape[1]), np.uint32)
    for i in range(p):
        s = slot[i]
        wit[i] = data[s]
        ok, desired = lane_ok(i, data[s], meta[s, 0])
        if ok:
            data[s] = desired
            meta[s:s + 1, 0] += np.uint32(2)     # wraps mod 2^32
            succ[i, 0] = 1
    return data, meta, succ, wit


def port_call(fn, arrays, **static):
    return fn(**{f: to_port(x) for f, x in arrays.items()}, **static)


@settings(max_examples=25, deadline=None)
@given(n=st.integers(2, 64), k=st.integers(1, 16), q=st.integers(1, 40),
       seed=st.integers(0, 2 ** 31))
def test_seqlock_gather_property(n, k, q, seed):
    rng = np.random.default_rng(seed)
    data, meta = make_table(rng, n, k, locked=0.3, marked=0.3)
    idx = rng.integers(0, n, q).astype(np.int32)
    vals, ok = port_call(tk.seqlock_gather, dict(data=data, meta=meta,
                                                 idx=idx))
    assert_bits(vals, data[idx], "values")
    want = ((meta[idx, 0] % 2 == 0) & (meta[idx, 1] == 0)).astype(np.int32)
    assert_bits(ok, want[:, None], "ok")


@settings(max_examples=25, deadline=None)
@given(n=st.integers(2, 32), k=st.integers(1, 9), p=st.integers(1, 24),
       seed=st.integers(0, 2 ** 31))
def test_cas_apply_round_property(n, k, p, seed):
    rng = np.random.default_rng(seed)
    a = cas_case(rng, n, k, p)

    def lane_ok(i, row, _):
        ok = a["kind"][i] == STORE or (
            a["kind"][i] == CAS and np.array_equal(row, a["expected"][i]))
        return ok, a["desired"][i]

    want = np_round(a["data"], a["meta"], a["slot"], lane_ok)
    for i, (g, w) in enumerate(zip(port_call(tk.cas_apply_round, a), want)):
        assert_bits(g, w, f"output {i}")


@settings(max_examples=25, deadline=None)
@given(n=st.integers(2, 32), k=st.integers(1, 9), p=st.integers(1, 24),
       seed=st.integers(0, 2 ** 31))
def test_llsc_commit_round_property(n, k, p, seed):
    rng = np.random.default_rng(seed)
    a = llsc_case(rng, n, k, p)

    def lane_ok(i, _, ver):
        return bool(a["live"][i]) and ver == a["link_ver"][i], \
            a["desired"][i]

    want = np_round(a["data"], a["meta"], a["slot"], lane_ok)
    for i, (g, w) in enumerate(zip(port_call(tk.llsc_commit_round, a),
                                   want)):
        assert_bits(g, w, f"output {i}")


@settings(max_examples=25, deadline=None)
@given(m=st.integers(1, 64), kw=st.integers(1, 4), vw=st.integers(0, 4),
       q=st.integers(1, 40), seed=st.integers(0, 2 ** 31))
def test_cachehash_probe_property(m, kw, vw, q, seed):
    rng = np.random.default_rng(seed)
    a = probe_case(rng, m, kw, vw, q)
    hit, empty, value, nxt = port_call(tk.cachehash_probe, a, kw=kw, vw=vw)
    cell = a["cells"][a["bucket_idx"]]
    full = cell[:, kw + vw + 1] == FULL
    match = full & (cell[:, :kw] == a["query_keys"]).all(1)
    assert_bits(hit, match.astype(np.int32)[:, None], "hit")
    assert_bits(empty, (~full).astype(np.int32)[:, None], "empty")
    assert_bits(value, cell[:, kw:kw + vw], "value")
    assert_bits(nxt, cell[:, kw + vw].view(np.int32)[:, None], "next")


@settings(max_examples=20, deadline=None)
@given(n=st.integers(2, 24), k=st.integers(1, 6), p=st.integers(1, 40),
       zipf=st.booleans(), seed=st.integers(0, 2 ** 31))
def test_update_rounds_vs_sequential_oracle(n, k, p, zipf, seed):
    """STORE/CAS batches through `bigatomic_update_rounds` equal the port's
    sequential oracle `engine.apply_ops_reference`: table, versions,
    success and witnesses (the oracle's per-lane value)."""
    rng = np.random.default_rng(seed)
    a, rounds = update_case(rng, n, k, p, zipf, 1.0)
    d, m, succ, wit = port_call(ops.bigatomic_update_rounds, a,
                                rounds=rounds)
    ctx = (np.full(p, -1, np.int32), np.zeros(p, np.uint32),
           np.zeros((p, k), np.uint32), np.zeros(p, bool))
    sorted_ops = (a["kind"], a["slot"], a["expected"], a["desired"])
    data, ver, _, res = tengine.apply_ops_reference(
        a["data"][:n], a["meta"][:n, 0], ctx, sorted_ops)
    assert_bits(d[:n], data, "data")
    assert_bits(m[:n, 0], ver, "versions")
    assert_bits(m[:, 1], a["meta"][:, 1], "marks")
    assert_bits(d[n], a["data"][n], "dummy row")
    assert_bits(succ, res.success.astype(np.int32), "success")
    assert_bits(wit, res.value, "witness")


@pytest.mark.parametrize("name", [*UPDATE_HARD, "negative-ranks",
                                  "out-of-table-slots"])
def test_update_rounds_hard_cases_vs_sequential_oracle(name):
    """`bigatomic_update_rounds` on the inputs its one-launch replay finds
    hard (every lane on one cell, LOAD lanes inside long segments, fewer
    rounds than the longest segment, k = 1 ... 16, lanes of no round,
    slots outside the table) against the sequential oracle run on the live
    lanes alone: table, versions, marks, dummy row, success (STORE/CAS
    lanes; LOAD lanes read and fail) and witnesses; a lane in no round
    gets zeros."""
    rng = np.random.default_rng(sum(map(ord, name)))
    args, cut = UPDATE_HARD.get(name, ((12, 4, 40, True, 0.8, False, 0.3), 0))
    a, rounds = update_case(rng, *args)
    rounds -= cut
    n, k, p = args[0], args[1], args[2]
    if name == "negative-ranks":
        a["upd_rank"][rng.random(p) < 0.3] = -1
    if name == "out-of-table-slots":                # sorted: first and last
        a["slot"][0], a["slot"][-1] = -1, n + 1
    live = (a["upd_rank"] >= 0) & (a["upd_rank"] < rounds) \
        & (a["slot"] >= 0) & (a["slot"] <= n)
    d, m, succ, wit = port_call(ops.bigatomic_update_rounds, a,
                                rounds=rounds)
    ctx = (np.full(p, -1, np.int32), np.zeros(p, np.uint32),
           np.zeros((p, k), np.uint32), np.zeros(p, bool))
    sorted_ops = (np.where(live, a["kind"], tengine.IDLE), a["slot"],
                  a["expected"], a["desired"])
    data, ver, _, res = tengine.apply_ops_reference(
        a["data"][:n], a["meta"][:n, 0], ctx, sorted_ops)
    writes = np.isin(a["kind"], [STORE, CAS])
    assert_bits(d[:n], data, "data")
    assert_bits(m[:n, 0], ver, "versions")
    assert_bits(m[:, 1], a["meta"][:, 1], "marks")
    assert_bits(d[n], a["data"][n], "dummy row")
    assert_bits(succ, (res.success & writes).astype(np.int32), "success")
    assert_bits(wit, res.value, "witness")
    assert live.any()
    if cut or name in ("negative-ranks", "out-of-table-slots"):
        assert not live.all()


@settings(max_examples=30, deadline=None)
@given(m=st.integers(1, 2 ** 31 - 1), kw=st.integers(1, 4),
       q=st.integers(1, 30), seed=st.integers(0, 2 ** 31))
def test_hash_keys_property(m, kw, q, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2 ** 32, (q, kw), dtype=np.uint32)
    keys[0] |= np.uint32(2 ** 31)
    assert_bits(ops.hash_keys(to_port(keys), m), np_hash(keys, m), "bucket")


@settings(max_examples=15, deadline=None)
@given(m=st.integers(1, 48), n_keys=st.integers(1, 120),
       kw=st.integers(1, 3), vw=st.integers(1, 3),
       seed=st.integers(0, 2 ** 31))
def test_cachehash_find_vs_dict(m, n_keys, kw, vw, seed):
    """Placed keys are found with their values (inline and chained);
    absent keys are not, and return the bucket's inlined value."""
    rng = np.random.default_rng(seed)
    cells, pool, keys, vals, _ = build_cachehash(rng, m, kw, vw, n_keys)
    table = {tuple(key): val for key, val in zip(keys, vals)}
    absent = rng.integers(0, 2 ** 32, (8, kw), dtype=np.uint32)
    qk = np.concatenate([keys, absent])
    found, val = port_call(ops.cachehash_find,
                           dict(cells=cells, chain_pool=pool, query_keys=qk),
                           kw=kw, vw=vw)
    bucket = np_hash(qk, m)
    for i, key in enumerate(qk):
        want = table.get(tuple(key))
        assert bool(found[i]) == (want is not None)
        expect = cells[bucket[i], kw:kw + vw] if want is None else want
        assert_bits(val[i], expect, f"value {i}")


def test_indirect_gather_ref_is_two_dependent_gathers():
    rng = np.random.default_rng(11)
    pool = rng.integers(0, 2 ** 32, (9, 3), dtype=np.uint32)
    ptr = rng.integers(0, 9, 6).astype(np.int32)
    idx = np.array([5, 0, 3, 3], np.int32)
    got = ref.indirect_gather_ref(to_port(ptr), to_port(pool), to_port(idx))
    assert_bits(got, pool[ptr[idx]], "indirect gather")


# ---------------------------------------------------------------------------
# (d), (e): launch counts, device rules, the build.
# ---------------------------------------------------------------------------

def _cpu_calls():
    """One CPU call of each table wrapper, as (name, thunk)."""
    rng = np.random.default_rng(5)
    a = cas_case(rng, 8, 4, 6)
    b = llsc_case(rng, 8, 4, 6)
    c = probe_case(rng, 16, 2, 2, 5)
    u, rounds = update_case(rng, 8, 4, 12, True, 0.8)
    return [
        ("seqlock_gather", lambda: port_call(
            tk.seqlock_gather, dict(data=a["data"], meta=a["meta"],
                                    idx=a["slot"]))),
        ("cas_apply_round", lambda: port_call(tk.cas_apply_round, a)),
        ("cas_apply_rounds", lambda: port_call(tk.cas_apply_rounds, u,
                                               rounds=rounds)),
        ("llsc_commit_round", lambda: port_call(tk.llsc_commit_round, b)),
        ("cachehash_probe", lambda: port_call(tk.cachehash_probe, c, kw=2,
                                              vw=2)),
        ("cachehash_find", lambda: port_call(
            tk.cachehash_find, dict(cells=c["cells"],
                                    chain_pool=c["cells"][:3],
                                    query_keys=c["query_keys"]),
            kw=2, vw=2)),
    ]


def test_cpu_tensors_never_launch_and_counts_reset():
    tk.reset_launch_counts()
    assert set(tk.launch_counts()) == {
        "round_prologue", "fast_round", "slow_round", "round_epilogue",
        "seqlock_gather", "cas_apply_round",
        "cas_apply_rounds", "llsc_commit_round", "cachehash_probe",
        "cachehash_find", "digest_rows", "flash_attention_wgmma", "flash_attention_tf32x3",
        "flash_attention_bwd_wgmma", "flash_attention_bwd_tf32x3"}
    for _, call in _cpu_calls():
        call()
    assert not any(tk.launch_counts().values())
    tk.seqlock_gather.launches = 3
    tk.reset_launch_counts()
    assert not any(tk.launch_counts().values())


def _meta_args(name, device_of):
    """Operands of wrapper `name` (n=4, k=2, p=q=3) with each operand's
    device chosen by `device_of(operand name)`."""
    def t(arg, shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=device_of(arg))
    if name == "seqlock_gather":
        return (t("data", (4, 2)), t("meta", (4, 2)), t("idx", (3,)))
    if name == "cachehash_probe":
        return (t("cells", (4, 7)), t("bucket_idx", (3,)),
                t("query_keys", (3, 2)))
    if name == "cachehash_find":
        return (t("cells", (4, 7)), t("chain_pool", (2, 7)),
                t("query_keys", (3, 2)))
    rounds = (t("upd_rank", (3,)),) if name == "cas_apply_rounds" else ()
    return (t("data", (5, 2)), t("meta", (5, 2)), t("slot", (3,)),
            t("flag", (3,)), t("operand", (3, 2) if name.startswith(
                "cas_apply_round") else (3,)), t("desired", (3, 2)), *rounds)


@pytest.mark.parametrize("name", ["seqlock_gather", "cas_apply_round",
                                  "cas_apply_rounds", "llsc_commit_round",
                                  "cachehash_probe", "cachehash_find"])
def test_wrappers_reject_meta_and_mixed_devices(name):
    fn = getattr(tk, name)
    if name == "cas_apply_rounds":           # rounds between the tensors
        def fn(*args):
            return tk.cas_apply_rounds(*args[:6], 2, args[6])
    static = dict(kw=2, vw=2) if name.startswith("cachehash") else {}
    before = tk.launch_counts()
    with pytest.raises(ValueError, match="unsupported device"):
        fn(*_meta_args(name, lambda _: "meta"), **static)
    for odd in ("idx", "slot", "desired", "query_keys", "meta", "upd_rank",
                "chain_pool"):
        args = _meta_args(name, lambda arg: "meta" if arg == odd else "cpu")
        if all(a.device.type == "cpu" for a in args):
            continue
        with pytest.raises(ValueError, match="is on meta"):
            fn(*args, **static)
    assert tk.launch_counts() == before


def test_wrappers_reject_bad_shapes_and_dtypes():
    d = torch.zeros((5, 4), dtype=torch.int32)
    m = torch.zeros((5, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="idx"):
        tk.seqlock_gather(d, m, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError, match="meta"):
        tk.seqlock_gather(d, m[:4], torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="expected"):
        tk.cas_apply_round(d, m, torch.zeros(2, dtype=torch.int32),
                           torch.zeros(2, dtype=torch.int32),
                           torch.zeros((2, 3), dtype=torch.int32),
                           torch.zeros((2, 4), dtype=torch.int32))
    lanes = [torch.zeros(2, dtype=torch.int32) for _ in range(2)]
    words = [torch.zeros((2, 4), dtype=torch.int32) for _ in range(2)]
    with pytest.raises(ValueError, match="upd_rank"):
        tk.cas_apply_rounds(d, m, *lanes, *words, 1,
                            torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="desired"):
        tk.cas_apply_rounds(d, m, *lanes, words[0],
                            torch.zeros((2, 3), dtype=torch.int32), 1,
                            torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="meta"):
        tk.cas_apply_rounds(d, m.T.contiguous(), *lanes, *words, 1,
                            torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="cannot hold"):
        tk.cachehash_probe(torch.zeros((4, 5), dtype=torch.int32),
                           torch.zeros(2, dtype=torch.int32),
                           torch.zeros((2, 2), dtype=torch.int32), kw=2,
                           vw=2)
    cells = torch.zeros((4, 7), dtype=torch.int32)
    keys = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="cannot hold"):
        tk.cachehash_find(cells, cells, keys, kw=2, vw=4)
    with pytest.raises(ValueError, match="chain_pool"):
        tk.cachehash_find(cells, torch.zeros((3, 6), dtype=torch.int32), keys,
                          kw=2, vw=2)
    with pytest.raises(ValueError, match="query_keys"):
        tk.cachehash_find(cells, cells, keys, kw=1, vw=2)


def test_out_of_range_rows_are_dead_lanes():
    rng = np.random.default_rng(9)
    data, meta = make_table(rng, 6, 3)
    meta[:, 0] = 0
    idx = np.array([-1, 2, 6, 99], np.int32)
    vals, ok = port_call(tk.seqlock_gather, dict(data=data, meta=meta,
                                                 idx=idx))
    assert ok[:, 0].tolist() == [0, 1, 0, 0]
    assert not vals[[0, 2, 3]].any()
    d, m, succ, wit = tk.cas_apply_round(
        to_port(data), to_port(meta), torch.tensor([-2, 6], dtype=torch.int32),
        torch.full((2,), STORE, dtype=torch.int32),
        torch.zeros((2, 3), dtype=torch.int32),
        torch.ones((2, 3), dtype=torch.int32))
    assert not succ.any() and not wit.any()
    assert_bits(d, data, "table untouched")
    hit, empty, value, nxt = tk.cachehash_probe(
        torch.ones((4, 7), dtype=torch.int32),
        torch.tensor([4, -1], dtype=torch.int32),
        torch.ones((2, 2), dtype=torch.int32), kw=2, vw=2)
    assert hit.sum() == 0 and empty.sum() == 2 and nxt.tolist() == [[-1]] * 2
    assert not value.any()


def test_every_library_needs_nvcc(monkeypatch, tmp_path):
    """No nvcc: building or loading either library raises; nothing falls
    back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    for name in _build.SIGNATURES:
        for build in (_build.build, _build.load):
            with pytest.raises(RuntimeError, match="nvcc not found"):
                build(name)
    with pytest.raises(ValueError, match="no kernel library"):
        _build.library_path("bogus")


def test_library_path_hashes_the_included_header(monkeypatch, tmp_path):
    """Editing `segment_replay.cuh` (or `tma_wgmma.cuh`, or
    `tf32_convert.cuh`) renames the libraries that include it (so a stale
    build is never loaded) and no other."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for path in _build.CSRC.iterdir():
        (csrc / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert _build.sources("table_ops") == [csrc / "table_ops.cu",
                                           csrc / "segment_replay.cuh"]
    before = {name: _build.library_path(name) for name in _build.SIGNATURES}
    with open(csrc / "segment_replay.cuh", "a") as f:
        f.write("// edited\n")
    after = {name: _build.library_path(name) for name in _build.SIGNATURES}
    changed = {name for name in before if before[name] != after[name]}
    assert changed == {"engine_round", "table_ops"}
    with open(csrc / "tma_wgmma.cuh", "a") as f:
        f.write("// edited\n")
    last = {name: _build.library_path(name) for name in _build.SIGNATURES}
    changed = {name for name in after if after[name] != last[name]}
    assert changed == {"flash_attention_wgmma", "flash_attention_tf32x3",
                       "flash_attention_bwd_wgmma",
                       "flash_attention_bwd_tf32x3"}
    with open(csrc / "tf32_convert.cuh", "a") as f:
        f.write("// edited\n")
    tf32 = {name: _build.library_path(name) for name in _build.SIGNATURES}
    changed = {name for name in last if last[name] != tf32[name]}
    assert changed == {"flash_attention_tf32x3", "flash_attention_bwd_tf32x3"}


def test_library_paths_are_keyed_by_each_source():
    paths = {name: _build.library_path(name) for name in _build.SIGNATURES}
    assert set(paths) == {"engine_round", "table_ops", "scrub_digest",
                          "flash_attention_wgmma", "flash_attention_tf32x3",
                          "flash_attention_bwd_wgmma",
                          "flash_attention_bwd_tf32x3"}
    for name, path in paths.items():
        assert path.parent == _build.BUILD_DIR
        assert re.fullmatch(rf"{name}_[0-9a-f]{{16}}\.so", path.name)


def test_c_entry_points_match_declared_signatures():
    """Each library's extern "C" functions take as many parameters as
    `_build.SIGNATURES` declares (nvcc is absent here, so this is the
    check that Python and C agree), and each has its error string."""
    for name, fns in _build.SIGNATURES.items():
        text = _build.source(name).read_text()
        c_part = text[text.index('extern "C"'):]
        assert f"const char* {name}_error_string(int err)" in c_part
        for fn, argtypes in fns.items():
            found = re.search(rf"\nint {fn}\(([^)]*)\)", c_part)
            assert found, f"{name}.cu has no entry point {fn}"
            c_args = ["ptr" if "*" in a else
                      "float" if a.split()[0] == "float" else "int"
                      for a in found.group(1).split(",")]
            py_args = ["ptr" if t is ctypes.c_void_p else
                       "float" if t is ctypes.c_float else "int"
                       for t in argtypes]
            assert c_args == py_args, fn


def test_find_on_a_card_is_one_launch_and_raises_as_plain(monkeypatch):
    """The find's card branch, its launch recorded instead of made: one
    `cachehash_find` launch of `table_ops` with the declared arguments and
    nothing else, its count up by one; an empty pool with max_chain > 0
    and an empty table raise what the plain version raises, before any
    launch; max_chain = 0 over an empty pool launches."""
    calls = []
    monkeypatch.setattr(_build, "runs_plain", lambda dev, who: False)
    monkeypatch.setattr(_build, "launch",
                        lambda lib, fn, dev, *args: calls.append((lib, fn,
                                                                  args)))
    cells = torch.zeros((8, 7), dtype=torch.int32)
    keys = torch.zeros((3, 2), dtype=torch.int32)
    empty_pool = cells[:0]
    tk.reset_launch_counts()
    found, value = ops.cachehash_find(cells, cells[:4], keys, kw=2, vw=2,
                                      max_chain=-5)
    assert found.dtype == torch.bool and tuple(value.shape) == (3, 2)
    assert [c[:2] for c in calls] == [("table_ops", "cachehash_find")]
    assert len(calls[0][2]) == len(
        _build.SIGNATURES["table_ops"]["cachehash_find"]) - 2
    assert calls[0][2][1:3] == (8, 7) and calls[0][2][4] == 4
    assert calls[0][2][6:10] == (3, 2, 2, 0)        # max_chain clamped
    assert tk.launch_counts()["cachehash_find"] == 1
    for pool, static, err in [
            (empty_pool, dict(max_chain=8), IndexError),
            (cells, dict(), RuntimeError)]:
        table = cells[:0] if err is RuntimeError else cells
        with pytest.raises(err):
            ref.cachehash_find_ref(table, pool, keys, kw=2, vw=2, **static)
        with pytest.raises(err):
            ops.cachehash_find(table, pool, keys, kw=2, vw=2, **static)
    ops.cachehash_find(cells, empty_pool, keys, kw=2, vw=2, max_chain=0)
    ops.cachehash_find(cells, empty_pool, keys[:0], kw=2, vw=2)
    assert len(calls) == 2 and tk.launch_counts()["cachehash_find"] == 2
    tk.reset_launch_counts()
