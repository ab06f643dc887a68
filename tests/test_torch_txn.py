"""The port's transaction layer (`repro_torch.txn`: k-word MCAS, bounded
version lists, the transactional map; `engine.arbitrate_groups`;
`guard.check_version_list`) against the JAX reference.

Each scenario below is written once against a small adapter (`_Pkg`) and
run twice: in this process on the port (CPU tensors), and in one
subprocess, with the jax alias the reference needs (`engine.round_for`
imports its Pallas module), on the reference (4 threads).  Every array a
scenario returns — its inputs, per-txn results, logical values, versions,
version-list state, snapshot reads, invariant masks, map contents — must
be equal bit for bit (words compare as uint32).  The scenarios are those
of `tests/test_txn.py` at its sizes, plus timestamps at and above 2^31,
`max_rounds` below the bound, exp backoff under high contention, the
cooperative `mcas_round` driven to drain, and version-list chains
corrupted by `guard.inject`.  In-process tests add `TxnOracle` /
`MapOracle` (tests/oracle.py) replays, the port's own numpy references,
the host-read contract of `mcas_round` / `mcas`, the mcas.* counters,
`arbitrate_groups` and `_policy_delay` against the reference's (plain
jnp, in process), and the constructors' checks.  One more scenario runs
on both packages under BIGATOMIC_OBS=counters: the version lists' reads
and `obs.snapshot()` after them."""

import os
import subprocess
import sys
import textwrap
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from oracle import MapOracle, TxnOracle

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
            from repro.core import cachehash as ch
            from repro.core import engine
            from repro.guard import inject, invariants
            from repro.runtime.faults import Fault
            from repro.sync.queue import BackoffPolicy
            from repro.txn import map as txn_map
            from repro.txn import mcas as txn_mcas
            from repro.txn import versionlist as vl
            self.kw = {}
        else:
            from repro_torch import atomics, obs
            from repro_torch.core import cachehash as ch
            from repro_torch.core import engine
            from repro_torch.guard import inject, invariants
            from repro_torch.runtime.faults import Fault
            from repro_torch.sync.queue import BackoffPolicy
            from repro_torch.txn import map as txn_map
            from repro_torch.txn import mcas as txn_mcas
            from repro_torch.txn import versionlist as vl
            self.kw = {"device": "cpu"}
        self.atomics, self.ch, self.engine, self.obs = atomics, ch, engine, obs
        self.inject, self.invariants, self.Fault = inject, invariants, Fault
        self.Backoff, self.map, self.mcas_mod, self.vl = (
            BackoffPolicy, txn_map, txn_mcas, vl)


def _fn_sum_plus_one(rv, rf):
    """Write value = sum of the read set + 1 (broadcast over W=1); works
    on jnp arrays and torch tensors alike."""
    return rv.sum(axis=1, keepdims=True) + 1


def _fn_copy_reads(rv, rf):
    """Write W values = the R read values (requires R == W)."""
    return rv


MAP_FNS = {"sum_plus_one": _fn_sum_plus_one, "copy_reads": _fn_copy_reads,
           "none": None}


# ---------------------------------------------------------------------------
# Shared recording helpers.
# ---------------------------------------------------------------------------

def txn_arrays(rng, *, t, w, n, k, current, match_frac=0.6):
    """`oracle.txn_batch`'s draws, as numpy arrays: mixed widths (-1
    padded), distinct slots per txn, `match_frac` of txns expecting the
    current values."""
    slot = np.full((t, w), -1, np.int32)
    for i in range(t):
        width = int(rng.integers(1, w + 1))
        slot[i, :width] = rng.choice(n, size=min(width, n), replace=False)
    expected = rng.integers(0, 2 ** 32, (t, w, k), dtype=np.uint32)
    fresh = rng.random(t) < match_frac
    for i in range(t):
        if fresh[i]:
            for j in range(w):
                if slot[i, j] >= 0:
                    expected[i, j] = current[slot[i, j]]
    desired = rng.integers(0, 2 ** 32, (t, w, k), dtype=np.uint32)
    return slot, expected, desired


MCAS_FIELDS = ("success", "witness", "round", "attempts", "rounds")


def record_mcas(P, out, key, spec, state, arrays, **kw):
    """One `atomics.mcas` call on the txns `arrays` (slot, expected,
    desired), its inputs and results recorded under `key`."""
    txns = P.atomics.make_txns(*arrays, k=spec.k, **P.kw)
    state, res = P.atomics.mcas(spec, state, txns, **kw)
    for name, x in zip(("slot", "expected", "desired"), arrays):
        out[f"{key}/in_{name}"] = np.asarray(x)
    for f in MCAS_FIELDS:
        out[f"{key}/{f}"] = bits(getattr(res, f))
    out[f"{key}/logical"] = bits(P.atomics.logical(spec, state))
    out[f"{key}/version"] = bits(state.version)
    return state


def current(P, spec, state):
    return bits(P.atomics.logical(spec, state))


# ---------------------------------------------------------------------------
# MCAS scenarios (tests/test_txn.py, plus the new cases).
# ---------------------------------------------------------------------------

def scenario_mcas_random(P, strategy):
    """test_mcas_matches_txn_oracle: width x contention x strategy."""
    rng = np.random.default_rng(zlib.crc32(strategy.encode()))
    out = {}
    for w, n in ((1, 4), (2, 6), (4, 10)):
        k = int(rng.integers(1, 4))
        t = int(rng.integers(2, 9))
        spec = P.atomics.AtomicSpec(n, k, strategy, p_max=128)
        init = rng.integers(0, 2 ** 32, (n, k), dtype=np.uint32)
        state = P.atomics.init(spec, init, **P.kw)
        out[f"w{w}/init"] = init
        for step in range(4):
            arrays = txn_arrays(rng, t=t, w=w, n=n, k=k,
                                current=current(P, spec, state))
            state = record_mcas(P, out, f"w{w}/s{step}", spec, state, arrays)
    return out


def scenario_mcas_all_match(P):
    """test_mcas_all_match_conflicts_serialize."""
    n, k, w, t = 6, 2, 2, 8
    rng = np.random.default_rng(3)
    spec = P.atomics.AtomicSpec(n, k, "cached_me", p_max=64)
    init = rng.integers(0, 2 ** 32, (n, k), dtype=np.uint32)
    state = P.atomics.init(spec, init, **P.kw)
    slot = np.stack([rng.choice(n, size=w, replace=False)
                     for _ in range(t)]).astype(np.int32)
    arrays = (slot, init[slot],
              rng.integers(0, 2 ** 32, (t, w, k), dtype=np.uint32))
    out = {"r/init": init}
    record_mcas(P, out, "r/s0", spec, state, arrays)
    return out


def _policy(P, name):
    return {"none": P.Backoff("none"), "const": P.Backoff("const", 2),
            "exp": P.Backoff("exp", 1, 4)}[name]


def scenario_mcas_backoff(P, policy):
    """test_mcas_backoff_policies_preserve_semantics."""
    n, k, w, t = 4, 2, 2, 6
    rng = np.random.default_rng(11)
    spec = P.atomics.AtomicSpec(n, k, "indirect", p_max=64)
    init = rng.integers(0, 2 ** 32, (n, k), dtype=np.uint32)
    state = P.atomics.init(spec, init, **P.kw)
    out = {"r/init": init}
    for step in range(3):
        arrays = txn_arrays(rng, t=t, w=w, n=n, k=k,
                            current=current(P, spec, state), match_frac=0.9)
        state = record_mcas(P, out, f"r/s{step}", spec, state, arrays,
                            policy=_policy(P, policy))
    return out


def scenario_mcas_aborted(P):
    """test_mcas_aborted_txns_leave_no_trace."""
    n, k = 4, 2
    spec = P.atomics.AtomicSpec(n, k, "cached_wf", p_max=32)
    init = np.arange(n * k, dtype=np.uint32).reshape(n, k)
    state = P.atomics.init(spec, init, **P.kw)
    arrays = (np.asarray([[0, 1], [2, 3]], np.int32),
              np.full((2, 2, k), 999, np.uint32),
              np.zeros((2, 2, k), np.uint32))
    out = {"r/init": init}
    record_mcas(P, out, "r/s0", spec, state, arrays)
    return out


def scenario_mcas_aba(P):
    """test_mcas_is_cas_semantics_not_llsc: A -> B -> A between calls, the
    txn compares values and commits."""
    n, k = 2, 2
    spec = P.atomics.AtomicSpec(n, k, "cached_me", p_max=16)
    init = np.asarray([[1, 2], [3, 4]], np.uint32)
    state = P.atomics.init(spec, init, **P.kw)
    for payload in ([[9, 9]], [[1, 2]]):
        state, _, _, _, _ = P.atomics.apply(
            spec, state, P.atomics.stores(
                [0], np.asarray(payload, np.uint32), k=k, **P.kw))
    arrays = (np.asarray([[0, 1]], np.int32), init[None][:, [0, 1]],
              np.full((1, 2, k), 7, np.uint32))
    out = {}
    record_mcas(P, out, "r/s0", spec, state, arrays)
    return out


def scenario_mcas_plugin(P):
    """test_mcas_plugin_strategy: a strategy registered here runs MCAS."""
    class PlainCloneTxn(P.atomics.StrategyImpl):
        name = "txn_plugin_check"

    P.atomics.register_strategy(PlainCloneTxn(), overwrite=True)
    try:
        rng = np.random.default_rng(7)
        n, k, w, t = 6, 2, 2, 6
        spec = P.atomics.AtomicSpec(n, k, "txn_plugin_check", p_max=64)
        init = rng.integers(0, 2 ** 32, (n, k), dtype=np.uint32)
        state = P.atomics.init(spec, init, **P.kw)
        out = {"r/init": init}
        for step in range(3):
            arrays = txn_arrays(rng, t=t, w=w, n=n, k=k,
                                current=current(P, spec, state))
            state = record_mcas(P, out, f"r/s{step}", spec, state, arrays)
        return out
    finally:
        P.atomics.unregister_strategy("txn_plugin_check")


def scenario_mcas_truncated(P):
    """`max_rounds` below the provable bound: the txns still pending keep
    round 0 and never executed; the next call's state shows only the
    resolved ones."""
    n, k, w, t = 4, 2, 2, 10
    rng = np.random.default_rng(21)
    spec = P.atomics.AtomicSpec(n, k, "seqlock", p_max=64)
    init = rng.integers(0, 2 ** 32, (n, k), dtype=np.uint32)
    state = P.atomics.init(spec, init, **P.kw)
    out = {"r/init": init}
    for step, rounds in enumerate((2, 1, 3)):
        arrays = txn_arrays(rng, t=t, w=w, n=n, k=k,
                            current=current(P, spec, state), match_frac=1.0)
        state = record_mcas(P, out, f"r/s{step}", spec, state, arrays,
                            max_rounds=rounds)
    return out


def scenario_mcas_hot(P, strategy, policy):
    """`benchmarks/bench_txn.py`'s high-contention shape, scaled to the
    reference tests: T = 16 txns of W = 4 lanes over n = 8 cells, all
    expecting the live values, under `policy`."""
    n, k, w, t = 8, 2, 4, 16
    rng = np.random.default_rng(zlib.crc32(f"{strategy}/{policy}".encode()))
    spec = P.atomics.AtomicSpec(n, k, strategy, p_max=128)
    init = rng.integers(0, 2 ** 32, (n, k), dtype=np.uint32)
    state = P.atomics.init(spec, init, **P.kw)
    out = {"r/init": init}
    for step in range(2):
        slot = np.stack([rng.choice(n, size=w, replace=False)
                         for _ in range(t)]).astype(np.int32)
        cur = current(P, spec, state)
        arrays = (slot, cur[slot],
                  rng.integers(0, 2 ** 32, (t, w, k), dtype=np.uint32))
        state = record_mcas(P, out, f"r/s{step}", spec, state, arrays,
                            policy=_policy(P, policy))
    return out


def scenario_mcas_coop(P, strategy):
    """`mcas_round` from `mcas_begin` driven to drain, then
    `mcas_finish`, on one copy of the table; `mcas` with the same policy
    on another: both recorded (they must be equal)."""
    n, k, w, t = 5, 3, 3, 9
    rng = np.random.default_rng(zlib.crc32(f"coop/{strategy}".encode()))
    spec = P.atomics.AtomicSpec(n, k, strategy, p_max=64)
    init = rng.integers(0, 2 ** 32, (n, k), dtype=np.uint32)
    policy = P.Backoff("exp", 1, 4)
    arrays = txn_arrays(rng, t=t, w=w, n=n, k=k, current=init,
                        match_frac=0.8)
    out = {"r/init": init}
    record_mcas(P, out, "r/s0", spec, P.atomics.init(spec, init, **P.kw),
                arrays, policy=policy)
    state = P.atomics.init(spec, init, **P.kw)
    txns = P.atomics.make_txns(*arrays, k=k, **P.kw)
    m = P.mcas_mod
    carry = m.mcas_begin(txns)
    while bool(np.asarray(bits(carry.pending)).any()):
        state, carry = m.mcas_round(spec, state, txns, carry, policy=policy)
    res = m.mcas_finish(txns, carry)
    for f in MCAS_FIELDS:
        out[f"coop/{f}"] = bits(getattr(res, f))
    out["coop/logical"] = bits(P.atomics.logical(spec, state))
    out["coop/version"] = bits(state.version)
    return out


# ---------------------------------------------------------------------------
# Version lists.
# ---------------------------------------------------------------------------

def record_versions(P, out, key, spec, st):
    head = P.atomics.logical(spec.head_spec(), st.table)
    out[f"{key}/head"] = bits(head)
    out[f"{key}/head_version"] = bits(st.table.version)
    out[f"{key}/pool"] = bits(st.pool)
    out[f"{key}/count"] = bits(st.count)


def scenario_vl_snapshot(P, strategy):
    """test_versionlist_snapshot_reads: every (slot, ts) query."""
    vl = P.vl
    spec = P.atomics.VersionSpec(n=4, k=2, depth=3, strategy=strategy,
                                 p_max=32)
    st = vl.init(spec, np.zeros((4, 2), np.uint32), **P.kw)
    for ts in range(1, 7):
        slot = ts % 2
        st = vl.publish(spec, st, [slot], [[ts, ts * 10]], [ts])
    out = {}
    for slot in (0, 1):
        for q_ts in range(0, 8):
            vals, fts, ok = vl.snapshot_read(spec, st, [slot], [q_ts])
            out[f"q{slot}_{q_ts}/vals"] = bits(vals)
            out[f"q{slot}_{q_ts}/fts"] = bits(fts)
            out[f"q{slot}_{q_ts}/ok"] = bits(ok)
    record_versions(P, out, "state", spec, st)
    return out


def scenario_vl_out_of_range(P, strategy):
    """ROADMAP Queue 3 item 5: `VersionSpec(n=4, k=2, depth=3)`, `publish`
    to slots [0, 4] (slot 4 is dropped: count [1, 0, 0, 0]), then to [-1]
    (row 3), then `snapshot_read` and `latest` of [0, 4], [-5] and [-1]:
    reads wrap a negative slot then clamp, as the reference's gathers."""
    vl = P.vl
    spec = P.atomics.VersionSpec(n=4, k=2, depth=3, strategy=strategy,
                                 p_max=4)
    st = vl.init(spec, np.arange(8, dtype=np.uint32).reshape(4, 2),
                 **P.kw)
    st = vl.publish(spec, st, np.asarray([0, 4], np.int32),
                    np.full((2, 2), 9, np.uint32), np.asarray([5, 5],
                                                              np.uint32))
    out = {}
    record_versions(P, out, "publish0", spec, st)
    st = vl.publish(spec, st, np.asarray([-1], np.int32),
                    np.full((1, 2), 8, np.uint32), np.asarray([6],
                                                              np.uint32))
    record_versions(P, out, "publish1", spec, st)
    for i, slots in enumerate(([0, 4], [-5], [-1])):
        q = np.asarray(slots, np.int32)
        for name, x in zip(("vals", "fts", "ok"), vl.snapshot_read(
                spec, st, q, np.full(len(slots), 5, np.uint32))):
            out[f"snap{i}/{name}"] = bits(x)
        for name, x in zip(("vals", "ts", "ok"), vl.latest(spec, st, q)):
            out[f"latest{i}/{name}"] = bits(x)
    return out


def scenario_vl_multi_slot(P):
    """test_versionlist_multi_slot_snapshot_is_consistent."""
    vl = P.vl
    spec = P.atomics.VersionSpec(n=3, k=1, depth=4, strategy="cached_me",
                                 p_max=32)
    st = vl.init(spec, **P.kw)
    rng = np.random.default_rng(5)
    state_now = [0, 0, 0]
    out = {}
    for ts in range(1, 9):
        slot = int(rng.integers(0, 3))
        state_now[slot] = ts * 100 + slot
        st = vl.publish(spec, st, [slot], [[state_now[slot]]], [ts])
        out[f"want{ts}"] = np.asarray(state_now, np.uint32)
    for ts in range(1, 9):
        vals, fts, ok = vl.snapshot_read(spec, st, [0, 1, 2], [ts] * 3)
        out[f"read{ts}/vals"] = bits(vals)
        out[f"read{ts}/fts"] = bits(fts)
        out[f"read{ts}/ok"] = bits(ok)
    record_versions(P, out, "state", spec, st)
    return out


TS_BASE = 2 ** 31 - 3          # publishes cross 2^31


def scenario_vl_high_ts(P, strategy):
    """Timestamps at and above 2^31 (unsigned compares), several slots per
    publish, a subset of slots republished so their rings lap; reads at
    every ts around the publishes, `latest`, `history` and
    `check_version_list` on the healthy chains."""
    vl = P.vl
    n, k = 6, 2
    spec = P.atomics.VersionSpec(n=n, k=k, depth=3, strategy=strategy,
                                 p_max=16)
    rng = np.random.default_rng(zlib.crc32(f"hits/{strategy}".encode()))
    st = vl.init(spec, rng.integers(0, 2 ** 32, (n, k), dtype=np.uint32),
                 ts0=TS_BASE - 1, **P.kw)
    for i in range(6):
        slots = np.asarray([0, 1, 2] if i % 2 == 0 else [0, 4, 5], np.int32)
        vals = rng.integers(0, 2 ** 32, (3, k), dtype=np.uint32)
        ts = np.full(3, TS_BASE + i, np.uint32)
        st = vl.publish(spec, st, slots, vals, ts)
    out = {}
    q_slots = np.repeat(np.arange(n, dtype=np.int32), 9)
    q_ts = np.tile(np.arange(TS_BASE - 2, TS_BASE + 7, dtype=np.int64),
                   n).astype(np.uint32)
    vals, fts, ok = vl.snapshot_read(spec, st, q_slots, q_ts)
    out["read/vals"], out["read/fts"], out["read/ok"] = (bits(vals),
                                                         bits(fts), bits(ok))
    lv, lts, lok = vl.latest(spec, st, np.arange(n, dtype=np.int32))
    out["latest/vals"], out["latest/ts"], out["latest/ok"] = (
        bits(lv), bits(lts), bits(lok))
    for s in range(n):
        hist = vl.history(spec, st, s)
        out[f"history{s}/ts"] = np.asarray([h[0] for h in hist], np.int64)
        out[f"history{s}/vals"] = np.stack([bits(h[1]) for h in hist])
    for name, m in P.invariants.check_version_list(spec, st).items():
        out[f"healthy/{name}"] = bits(m)
    record_versions(P, out, "state", spec, st)
    return out


def scenario_vl_guard(P, strategy):
    """`check_version_list` on chains corrupted by `guard.inject`: a bit of
    a head's prev pointer, a set bit of a head's timestamp (now older than
    its pool), and a whole torn head row."""
    vl = P.vl
    n, k = 5, 2
    spec = P.atomics.VersionSpec(n=n, k=k, depth=3, strategy=strategy,
                                 p_max=16)
    st = vl.init(spec, **P.kw)
    for ts in range(1, 5):
        st = vl.publish(spec, st, [0, 1, 2], [[ts, ts]] * 3, [ts] * 3)
    hspec = spec.head_spec()
    faults = {"prev_bit": P.Fault(round=0, kind="bit_flip", slot=1,
                                  word=k + 1, bit=0),
              "ts_bit": P.Fault(round=0, kind="bit_flip", slot=2, word=k,
                                bit=2),
              "torn_row": P.Fault(round=0, kind="torn_write", slot=0,
                                  words=k + 2)}
    out = {}
    for i, (name, fault) in enumerate(faults.items()):
        table, info = P.inject.inject_table_fault(
            hspec, st.table, fault, np.random.default_rng(100 + i))
        bad = st._replace(table=table)
        for inv, m in P.invariants.check_version_list(spec, bad).items():
            out[f"{name}/{inv}"] = bits(m)
        out[f"{name}/head"] = bits(P.atomics.logical(hspec, table))
    return out


def scenario_vl_counters(P, strategy):
    """Under BIGATOMIC_OBS=counters (the caller turns it on): publishes,
    then `snapshot_read` and `latest` of a clean head table and of one
    with head 1 caught mid-update, the counters recorded after the reads
    and again after `latest`.  The reference's publish and snapshot_read
    are jitted programs, which count nothing; its `latest` counts the
    torn head into read.torn_retries."""
    vl = P.vl
    n, k = 4, 2
    spec = P.atomics.VersionSpec(n=n, k=k, depth=3, strategy=strategy,
                                 p_max=16)
    hspec = spec.head_spec()
    P.obs.reset()
    st = vl.init(spec, **P.kw)
    for ts in range(1, 4):
        st = vl.publish(spec, st, [0, 1, 2], [[ts, ts]] * 3, [ts] * 3)
    torn = st._replace(table=P.atomics.begin_update(
        hspec, st.table, 1, np.arange(hspec.k, dtype=np.uint32)))
    slots = np.arange(n, dtype=np.int32)
    out = {}
    for name, s in (("clean", st), ("torn", torn)):
        vals, fts, ok = vl.snapshot_read(spec, s, slots,
                                         np.full(n, 2, np.uint32))
        out[f"{name}/vals"], out[f"{name}/fts"], out[f"{name}/ok"] = (
            bits(vals), bits(fts), bits(ok))
    for key, v in P.obs.snapshot().items():
        out[f"after_reads/{key}"] = np.asarray(v)
    for name, s in (("clean", st), ("torn", torn)):
        out[f"{name}/latest_ok"] = bits(vl.latest(spec, s, slots)[2])
    for key, v in P.obs.snapshot().items():
        out[f"after_latest/{key}"] = np.asarray(v)
    P.obs.reset()
    return out


# ---------------------------------------------------------------------------
# The transactional map.
# ---------------------------------------------------------------------------

MAP_TXN_FIELDS = ("read_key", "read_mask", "write_key", "write_mask",
                  "write_del", "write_value")
MAP_RES_FIELDS = ("read_value", "read_found", "round", "attempts", "rounds")


def record_map(P, out, key, hs, state, txns, fn_name, **kw):
    state, res = P.map.transact(hs, state, txns, MAP_FNS[fn_name], **kw)
    for f in MAP_TXN_FIELDS:
        out[f"{key}/in_{f}"] = bits(getattr(txns, f))
    for f in MAP_RES_FIELDS:
        out[f"{key}/{f}"] = bits(getattr(res, f))
    items = P.ch.items(state, inline=hs.inline, vw=hs.vw)
    keys = np.asarray(sorted(int(x) for x in items), np.uint32)
    out[f"{key}/item_keys"] = keys
    out[f"{key}/item_vals"] = np.asarray(
        [bits(items[int(x)]).reshape(-1) for x in keys],
        np.uint32).reshape(-1, hs.vw)
    out[f"{key}/fn"] = np.asarray(list(MAP_FNS).index(fn_name))
    out[f"{key}/vw"] = np.asarray(hs.vw)
    return state


def scenario_map_counter(P, strategy, policy="none"):
    """test_txn_map_counter_increments_serialize: T txns read-modify-write
    one key (under `policy`)."""
    t = 5 if policy == "none" else 8
    hs = P.atomics.HashSpec(16, vw=1, strategy=strategy, p_max=64)
    state = P.ch.init_hash(hs, **P.kw)
    txns = P.map.make_map_txns(np.full((t, 1), 9, np.uint32),
                               np.full((t, 1), 9, np.uint32), **P.kw)
    out = {}
    record_map(P, out, "r/s0", hs, state, txns, "sum_plus_one",
               policy=_policy(P, policy))
    return out


def scenario_map_random(P, strategy):
    """test_txn_map_random_txns_match_oracle."""
    rng = np.random.default_rng(zlib.crc32(strategy.encode()) ^ 0xA5)
    hs = P.atomics.HashSpec(32, vw=2, strategy=strategy, p_max=128)
    state = P.ch.init_hash(hs, **P.kw)
    t, r, w, key_space = 6, 2, 2, 12
    out = {}
    for step in range(4):
        txns = P.map.make_map_txns(
            rng.integers(0, key_space, (t, r)).astype(np.uint32),
            np.stack([rng.choice(key_space, size=w, replace=False)
                      for _ in range(t)]).astype(np.uint32),
            read_mask=rng.random((t, r)) < 0.8,
            write_del=rng.random((t, w)) < 0.25, **P.kw)
        state = record_map(P, out, f"r/s{step}", hs, state, txns,
                           "copy_reads")
    return out


def scenario_map_provided(P):
    """test_txn_map_provided_write_values_and_deletes (fn=None)."""
    hs = P.atomics.HashSpec(16, vw=1, strategy="cached_me", p_max=64)
    state = P.ch.init_hash(hs, **P.kw)
    seed = P.map.make_map_txns(
        np.zeros((1, 1), np.uint32), np.asarray([[1, 2, 3]], np.uint32),
        read_mask=np.zeros((1, 1), bool),
        write_value=np.asarray([[[10], [20], [30]]], np.uint32), **P.kw)
    out = {}
    state = record_map(P, out, "r/s0", hs, state, seed, "none")
    txns = P.map.make_map_txns(
        np.asarray([[1, 2]], np.uint32), np.asarray([[1, 4]], np.uint32),
        write_del=np.asarray([[True, False]]),
        write_value=np.asarray([[[0], [40]]], np.uint32), **P.kw)
    record_map(P, out, "r/s1", hs, state, txns, "none")
    return out


def scenario_map_plugin(P):
    """test_txn_map_plugin_strategy."""
    class PlainCloneMap(P.atomics.StrategyImpl):
        name = "txnmap_plugin_check"

    P.atomics.register_strategy(PlainCloneMap(), overwrite=True)
    try:
        hs = P.atomics.HashSpec(16, vw=1, strategy="txnmap_plugin_check",
                                p_max=64)
        state = P.ch.init_hash(hs, **P.kw)
        t = 4
        txns = P.map.make_map_txns(np.full((t, 1), 3, np.uint32),
                                   np.full((t, 1), 3, np.uint32), **P.kw)
        out = {}
        record_map(P, out, "r/s0", hs, state, txns, "sum_plus_one")
        return out
    finally:
        P.atomics.unregister_strategy("txnmap_plugin_check")


MCAS_SCENARIOS = {
    **{f"mcas_random/{s}": (scenario_mcas_random, (s,)) for s in LOCK_FREE},
    "mcas_all_match": (scenario_mcas_all_match, ()),
    **{f"mcas_backoff/{p}": (scenario_mcas_backoff, (p,))
       for p in ("const", "exp")},
    "mcas_aborted": (scenario_mcas_aborted, ()),
    "mcas_plugin": (scenario_mcas_plugin, ()),
    "mcas_truncated": (scenario_mcas_truncated, ()),
    "mcas_hot/cached_me/exp": (scenario_mcas_hot, ("cached_me", "exp")),
    "mcas_hot/seqlock/none": (scenario_mcas_hot, ("seqlock", "none")),
    "mcas_coop/indirect": (scenario_mcas_coop, ("indirect",)),
}
MAP_SCENARIOS = {
    **{f"map_counter/{s}": (scenario_map_counter, (s,)) for s in LOCK_FREE},
    "map_counter/cached_me/exp": (scenario_map_counter, ("cached_me",
                                                         "exp")),
    **{f"map_random/{s}": (scenario_map_random, (s,)) for s in LOCK_FREE},
    "map_provided": (scenario_map_provided, ()),
    "map_plugin": (scenario_map_plugin, ()),
}
SCENARIOS = {
    **MCAS_SCENARIOS,
    "mcas_aba": (scenario_mcas_aba, ()),
    **{f"vl_snapshot/{s}": (scenario_vl_snapshot, (s,)) for s in LOCK_FREE},
    "vl_multi_slot": (scenario_vl_multi_slot, ()),
    **{f"vl_out_of_range/{s}": (scenario_vl_out_of_range, (s,))
       for s in LOCK_FREE},
    **{f"vl_high_ts/{s}": (scenario_vl_high_ts, (s,))
       for s in ("seqlock", "cached_me")},
    **{f"vl_guard/{s}": (scenario_vl_guard, (s,))
       for s in ("seqlock", "indirect")},
    **MAP_SCENARIOS,
}


# Run one at a time with BIGATOMIC_OBS=counters: the counters are global.
COUNTER_SCENARIOS = {f"vl_counters/{s}": (scenario_vl_counters, (s,))
                     for s in ("seqlock", "cached_me")}


def run_scenarios(which: str, workers: int = 1) -> dict:
    """Every scenario on one package, flattened to {"name|key": array}.
    The scenarios share nothing (their own seeds, tables and plug-in
    names), so `workers` threads may run them at once: the reference's
    time is mostly XLA compiles, which release the GIL."""
    P = _Pkg(which)

    def run(item):
        name, (fn, args) = item
        return name, fn(P, *args)

    with ThreadPoolExecutor(workers) as pool:
        runs = list(pool.map(run, SCENARIOS.items()))
    return {f"{name}|{key}": value for name, out in runs
            for key, value in out.items()}


_REFERENCE_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    from jax.experimental.pallas import tpu as pltpu
    if not hasattr(pltpu, "TPUMemorySpace"):   # renamed in newer jax
        pltpu.TPUMemorySpace = pltpu.MemorySpace
    import os
    import test_torch_txn as t
    out = t.run_scenarios("ref", workers=4)
    os.environ["BIGATOMIC_OBS"] = "counters"
    P = t._Pkg("ref")
    for name, (fn, args) in t.COUNTER_SCENARIOS.items():
        out.update({f"{name}|{key}": v for key, v in fn(P, *args).items()})
    np.savez(sys.argv[1], **out)
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("txn_ref") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT / 'tests'}")
    env.pop("BIGATOMIC_OBS", None)
    proc = subprocess.run([sys.executable, "-c", _REFERENCE_SCRIPT,
                           str(path)], env=env, capture_output=True,
                          text=True, timeout=1200)
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
def test_scenario_matches_reference(name, reference, port_runs,
                                    monkeypatch):
    monkeypatch.delenv("BIGATOMIC_OBS", raising=False)
    got = port_runs(name)
    want = {key.split("|", 1)[1]: v for key, v in reference.items()
            if key.split("|", 1)[0] == name}
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(
            np.asarray(got[key]), want[key], err_msg=f"{name}: {key}")


@pytest.mark.parametrize("name", list(COUNTER_SCENARIOS))
def test_counter_scenario_matches_reference(name, reference, monkeypatch):
    """The version lists' reads under BIGATOMIC_OBS=counters: the port's
    results and `obs.snapshot()` equal the reference's, and only `latest`
    counts a torn head."""
    monkeypatch.setenv("BIGATOMIC_OBS", "counters")
    fn, args = COUNTER_SCENARIOS[name]
    got = fn(_Pkg("port"), *args)
    want = {key.split("|", 1)[1]: v for key, v in reference.items()
            if key.split("|", 1)[0] == name}
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(
            np.asarray(got[key]), want[key], err_msg=f"{name}: {key}")
    torn = 1 if name.endswith("seqlock") else 0
    assert int(got["after_reads/read.torn_retries"]) == 0
    assert int(got["after_latest/read.torn_retries"]) == torn
    assert bool(got["torn/ok"][1]) == (not torn)


# ---------------------------------------------------------------------------
# In-process: the whole-transaction oracles and the port's numpy references.
# ---------------------------------------------------------------------------

def _steps(out, run):
    keys = {k.split("/")[1] for k in out if k.startswith(f"{run}/s")}
    return sorted(keys, key=lambda s: int(s[1:]))


def _mcas_result_np(out, key):
    from repro.txn import mcas as jmcas
    return jmcas.McasResult(*(out[f"{key}/{f}"] for f in MCAS_FIELDS))


@pytest.mark.parametrize("name", list(MCAS_SCENARIOS))
def test_mcas_scenario_matches_txn_oracle(name, port_runs):
    """The port's run replayed step by step through `TxnOracle` in its
    claimed order (success, witness, logical values, versions), and the
    port's own `mcas_reference` / `linearization_order` agreeing."""
    from repro.txn import mcas as jmcas
    from repro_torch.txn import mcas as tmcas
    out = port_runs(name)
    for run in sorted({k.split("/")[0] for k in out if k.endswith("/init")}):
        init = out[f"{run}/init"]
        n, k = init.shape
        oracle = TxnOracle(n, k, initial=init)
        for step in _steps(out, run):
            key = f"{run}/{step}"
            txns = jmcas.TxnBatch(*(out[f"{key}/in_{f}"] for f in
                                    ("slot", "expected", "desired")))
            res = _mcas_result_np(out, key)
            before = (oracle.data.copy(), oracle.version.copy())
            oracle.step_and_check(txns, result=res,
                                  logical=out[f"{key}/logical"],
                                  version=out[f"{key}/version"],
                                  msg=f"{name} {key}")
            order = tmcas.linearization_order(res)
            np.testing.assert_array_equal(order,
                                          jmcas.linearization_order(res))
            for a, b in zip(tmcas.mcas_reference(*before, txns, order),
                            (oracle.data, oracle.version, res.success,
                             res.witness)):
                np.testing.assert_array_equal(a, b)
    if name.startswith("mcas_coop"):
        for f in (*MCAS_FIELDS, "logical", "version"):
            np.testing.assert_array_equal(out[f"coop/{f}"], out[f"r/s0/{f}"],
                                          err_msg=f"mcas_round vs mcas: {f}")


def test_mcas_truncated_rounds_leave_txns_pending(port_runs):
    out = port_runs("mcas_truncated")
    left = 0
    for step, cap in enumerate((2, 1, 3)):
        rnd = out[f"r/s{step}/round"]
        assert int(out[f"r/s{step}/rounds"]) <= cap
        assert (rnd <= cap).all()
        assert not out[f"r/s{step}/success"][rnd == 0].any()
        left += int((rnd == 0).sum())
    assert left > 0


def test_mcas_aba_commits_and_oracle_agrees(port_runs):
    """A -> B -> A between mcas calls: expected compares VALUES, so the txn
    commits (unlike SC, which compares versions)."""
    from repro.txn import mcas as jmcas
    out = port_runs("mcas_aba")
    assert bool(out["r/s0/success"][0])
    oracle = TxnOracle(2, 2, initial=np.asarray([[1, 2], [3, 4]], np.uint32))
    oracle.version[0] += 4
    txns = jmcas.TxnBatch(*(out[f"r/s0/in_{f}"] for f in
                            ("slot", "expected", "desired")))
    oracle.step_and_check(txns, result=_mcas_result_np(out, "r/s0"),
                          logical=out["r/s0/logical"],
                          version=out["r/s0/version"], msg="aba")


def _map_txns_np(out, key):
    from repro.txn import map as jmap
    return jmap.MapTxns(*(out[f"{key}/in_{f}"] for f in MAP_TXN_FIELDS))


@pytest.mark.parametrize("name", list(MAP_SCENARIOS))
def test_map_scenario_matches_map_oracle(name, port_runs):
    """The port's run replayed through `MapOracle` in its claimed
    serialization (read sets, contents), and the port's own
    `transact_reference` agreeing."""
    from repro.txn import map as jmap
    from repro_torch.txn import map as tmap
    out = port_runs(name)
    vw = int(out["r/s0/vw"])
    oracle = MapOracle(vw=vw)
    model = {}
    for step in _steps(out, "r"):
        key = f"r/{step}"
        txns = _map_txns_np(out, key)
        fn = list(MAP_FNS.values())[int(out[f"{key}/fn"])]
        res = jmap.MapResult(*(out[f"{key}/{f}"] for f in MAP_RES_FIELDS))
        items = dict(zip(out[f"{key}/item_keys"].tolist(),
                         out[f"{key}/item_vals"]))
        oracle.step_and_check(txns, fn, result=res, items=items,
                              msg=f"{name} {key}")
        order = tmap.linearization_order(res)
        np.testing.assert_array_equal(order, jmap.linearization_order(res))
        model, rv, rf = tmap.transact_reference(model, txns, fn, order, vw)
        np.testing.assert_array_equal(rv, res.read_value)
        np.testing.assert_array_equal(rf, res.read_found)
        assert {k: list(v) for k, v in model.items()} == \
            {k: list(v) for k, v in oracle.model.items()}
    if name.startswith("map_counter"):
        t = out["r/s0/in_read_key"].shape[0]
        assert oracle.model[9][0] == t
        if name.count("/") == 1:
            assert int(out["r/s0/rounds"]) == t     # one commit per round


@pytest.mark.parametrize("strategy", LOCK_FREE)
def test_versionlist_reads_answer_retained_versions(strategy, port_runs):
    """test_versionlist_snapshot_reads' own check: every retained (slot,
    ts) answers exactly; evicted ones refuse."""
    out = port_runs(f"vl_snapshot/{strategy}")
    written = {0: {0: [0, 0]}, 1: {0: [0, 0]}}
    for ts in range(1, 7):
        written[ts % 2][ts] = [ts, ts * 10]
    for slot in (0, 1):
        tss = sorted(written[slot])
        for q_ts in range(0, 8):
            key = f"q{slot}_{q_ts}"
            want_ts = max((x for x in tss if x <= q_ts), default=None)
            if want_ts is not None and want_ts in tss[-3:]:
                assert bool(out[f"{key}/ok"][0]), (slot, q_ts)
                assert int(out[f"{key}/fts"][0]) == want_ts
                np.testing.assert_array_equal(out[f"{key}/vals"][0],
                                              written[slot][want_ts])
            else:
                assert not bool(out[f"{key}/ok"][0]), (slot, q_ts)


def test_versionlist_multi_slot_reads_are_consistent(port_runs):
    out = port_runs("vl_multi_slot")
    for ts in range(6, 9):                      # within every chain's window
        assert out[f"read{ts}/ok"].all()
        np.testing.assert_array_equal(out[f"read{ts}/vals"][:, 0],
                                      out[f"want{ts}"])


@pytest.mark.parametrize("strategy", ["seqlock", "cached_me"])
def test_versionlist_high_timestamps_match_numpy_model(strategy, port_runs):
    """Timestamps across 2^31 against a numpy model of the chains: each
    slot's versions, the newest `depth` retained, unsigned compares."""
    out = port_runs(f"vl_high_ts/{strategy}")
    n, k, depth = 6, 2, 3
    rng = np.random.default_rng(zlib.crc32(f"hits/{strategy}".encode()))
    hist = {s: [(TS_BASE - 1, v)] for s, v in enumerate(
        rng.integers(0, 2 ** 32, (n, k), dtype=np.uint32))}
    for i in range(6):
        slots = [0, 1, 2] if i % 2 == 0 else [0, 4, 5]
        vals = rng.integers(0, 2 ** 32, (3, k), dtype=np.uint32)
        for s, v in zip(slots, vals):
            hist[s].append((TS_BASE + i, v))
    q = 0
    for s in range(n):
        kept = hist[s][-depth:]
        for q_ts in range(TS_BASE - 2, TS_BASE + 7):
            older = [h for h in hist[s] if h[0] <= q_ts]
            want = older[-1] if older else None
            ok = want is not None and any(want[0] == h[0] for h in kept)
            assert bool(out["read/ok"][q]) == ok, (s, q_ts)
            if ok:
                assert int(out["read/fts"][q]) == want[0]
                np.testing.assert_array_equal(out["read/vals"][q], want[1])
            q += 1
        np.testing.assert_array_equal(out[f"history{s}/ts"],
                                      [h[0] for h in kept[::-1]])
    assert not out["healthy/head_prev_agrees"].any()
    assert not out["healthy/head_ts_newest"].any()


@pytest.mark.parametrize("strategy", ["seqlock", "indirect"])
def test_check_version_list_flags_injected_faults(strategy, port_runs):
    out = port_runs(f"vl_guard/{strategy}")
    assert out["prev_bit/head_prev_agrees"].tolist() == [0, 1, 0, 0, 0]
    assert out["ts_bit/head_ts_newest"][2]
    assert out["torn_row/head_prev_agrees"][0] \
        or out["torn_row/head_ts_newest"][0]


# ---------------------------------------------------------------------------
# In-process: the mode matrix, arbitration, backoff, host reads, counters.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["auto", "xla", "off"])
def test_mcas_same_on_every_engine_tier(mode, reference, monkeypatch):
    """`mcas` on the kernel tier (the wrappers' plain versions here), the
    plain-tensor tier and `linearize` gives the reference's results."""
    monkeypatch.setenv("BIGATOMIC_ENGINE_KERNEL", mode)
    name = "mcas_random/cached_wf"
    got = scenario_mcas_random(_Pkg("port"), "cached_wf")
    for key, value in got.items():
        np.testing.assert_array_equal(value, reference[f"{name}|{key}"],
                                      err_msg=f"{mode}: {key}")


def test_arbitrate_groups_matches_reference():
    from repro.core import engine as jengine
    from repro_torch.core import engine as tengine
    rng = np.random.default_rng(9)
    for n, p, g in ((8, 24, 6), (3, 40, 40), (64, 16, 4), (5, 1, 1)):
        for _ in range(20):
            slot = rng.integers(-2, n + 2, p).astype(np.int32)
            group = rng.integers(0, g, p).astype(np.int32)
            elig = rng.random(p) < 0.7
            want = np.asarray(jengine.arbitrate_groups(
                jnp.asarray(slot), jnp.asarray(group), jnp.asarray(elig),
                n=n, n_groups=g))
            got = tengine.arbitrate_groups(
                torch.from_numpy(slot), torch.from_numpy(group),
                torch.from_numpy(elig), n=n, n_groups=g)
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("policy", [("none", 1, 8), ("const", 3, 8),
                                    ("exp", 1, 4), ("exp", 3, 1000),
                                    ("exp", 1 << 20, 2 ** 31 - 1)])
def test_policy_delay_matches_reference(policy):
    """The exp backoff's int32 shift (clipped at 16, capped) and the other
    policies, attempts 0..40, against the reference's traced form."""
    from repro.sync.queue import BackoffPolicy as JPolicy
    from repro.txn.mcas import _policy_delay as j_delay
    from repro_torch.sync.queue import BackoffPolicy as TPolicy
    from repro_torch.txn.mcas import _policy_delay as t_delay
    attempts = np.arange(41, dtype=np.int32)
    want = np.asarray(j_delay(JPolicy(*policy), jnp.asarray(attempts)))
    got = t_delay(TPolicy(*policy), torch.from_numpy(attempts))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _hot_txns(strategy="cached_me", seed=4, n=6, k=2, w=3, t=8):
    """A contended MCAS batch: every txn expects the live values."""
    from repro_torch import atomics
    rng = np.random.default_rng(seed)
    init = rng.integers(0, 2 ** 32, (n, k), dtype=np.uint32)
    slot = np.stack([rng.choice(n, size=w, replace=False)
                     for _ in range(t)]).astype(np.int32)
    spec = atomics.AtomicSpec(n, k, strategy, p_max=64)
    txns = atomics.make_txns(slot, init[slot], rng.integers(
        0, 2 ** 32, (t, w, k), dtype=np.uint32), k=k, device="cpu")
    return spec, atomics.init(spec, init, device="cpu"), txns


class _Syncs(TorchDispatchMode):
    """Record dispatched operations that read a tensor back to the host or
    upload host data (on a card: a sync)."""

    SYNC = ("aten._local_scalar_dense", "aten.nonzero", "aten.masked_select",
            "aten.lift_fresh", "aten.unique", "aten._unique2",
            "aten.unique_consecutive", "aten.equal", "aten.is_nonzero",
            "aten.repeat_interleave")

    def __init__(self):
        super().__init__()
        self.syncs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        if name in self.SYNC:
            self.syncs.append(name)
        if name.startswith(("aten.index", "aten.index_put")):
            idx = args[1] if len(args) > 1 else ()
            if any(isinstance(x, torch.Tensor) and x.dtype == torch.bool
                   for x in (idx or ())):
                self.syncs.append(name + "(bool mask)")
        return func(*args, **(kwargs or {}))


_READS = ("__bool__", "__int__", "__index__", "__float__", "item", "tolist",
          "numpy")


@pytest.mark.parametrize("strategy", LOCK_FREE)
def test_mcas_round_reads_nothing_back(strategy, monkeypatch):
    """One `mcas_round` on the kernel tier (every layout), with every way a
    tensor reaches the host patched to raise and no dispatched operation
    that reads back or uploads.  Only `slow_round`'s plain version reads
    its round count (the kernel does not); it is replaced by its recorded
    outputs.  Every round of the batch equals an unpatched run's."""
    from repro_torch import atomics
    from repro_torch.kernels import engine_round as ter
    from repro_torch.txn import mcas as tmcas
    monkeypatch.setenv("BIGATOMIC_ENGINE_KERNEL", "pallas")
    monkeypatch.delenv("BIGATOMIC_OBS", raising=False)
    spec, state, txns = _hot_txns(strategy)
    slow = ter.slow_round
    recorded = []

    def record(*a, **kw):
        out = slow(*a, **kw)
        recorded.append([x.clone() for x in out])
        return out

    def replay(data, version, *a, **kw):
        d, v, *rest = recorded.pop(0)
        data.copy_(d)
        version.copy_(v)
        return (data, version, *rest)

    def rounds(patched):
        st, carry, outs = state, tmcas.mcas_begin(txns), []
        for _ in range(4):
            with monkeypatch.context() as m:
                if patched:
                    m.setattr(ter, "slow_round", replay)
                    for name in _READS:
                        m.setattr(torch.Tensor, name, _no_host_read(name))
                    with _Syncs() as rec:
                        st, carry = tmcas.mcas_round(spec, st, txns, carry,
                                                     donate=True)
                    assert rec.syncs == [], rec.syncs
                else:
                    m.setattr(ter, "slow_round", record)
                    st, carry = tmcas.mcas_round(spec, st, txns, carry)
            outs.append([x.clone() for x in (*st, *carry)])
        return outs

    want = rounds(False)
    state = atomics.TableState(*(x.clone() for x in state))
    got = rounds(True)
    assert not recorded
    for r, (a, b) in enumerate(zip(got, want)):
        for i, (x, y) in enumerate(zip(a, b)):
            assert torch.equal(x, y), f"{strategy}: round {r}, output {i}"


def _no_host_read(name):
    def read(self, *args, **kwargs):
        raise AssertionError(f"Tensor.{name}: mcas_round read a tensor "
                             f"back to the host")
    return read


@pytest.mark.parametrize("policy", [("none",), ("exp", 1, 4)])
def test_mcas_reads_once_per_round(policy, monkeypatch):
    """`mcas` reads exactly one value back per round (the loop condition)
    on the kernel tier, with the slow round's plain read left out as
    above: reads == rounds."""
    from repro_torch.kernels import engine_round as ter
    from repro_torch.sync.queue import BackoffPolicy
    from repro_torch.txn import mcas as tmcas
    monkeypatch.setenv("BIGATOMIC_ENGINE_KERNEL", "pallas")
    monkeypatch.delenv("BIGATOMIC_OBS", raising=False)
    spec, state, txns = _hot_txns(t=10)
    pol = BackoffPolicy(*policy)
    want_state, want = tmcas.mcas(spec, state, txns, policy=pol)
    reads = []
    slow = ter.slow_round

    def quiet_slow(*a, **kw):
        n = len(reads)
        out = slow(*a, **kw)
        del reads[n:]                      # the plain version's own read
        return out

    for name in _READS:
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, _name=name, **kw):
            reads.append(_name)
            return _orig(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, counted)
    monkeypatch.setattr(ter, "slow_round", quiet_slow)
    got_state, got = tmcas.mcas(spec, state, txns, policy=pol)
    calls = list(reads)
    monkeypatch.undo()
    rounds = int(want.rounds)
    assert rounds > 1
    assert calls == ["__bool__"] * rounds, calls
    for a, b in zip((*got_state, *got), (*want_state, *want)):
        assert torch.equal(a, b)


def test_mcas_counts_its_rounds(monkeypatch):
    """BIGATOMIC_OBS=counters: mcas.* counters equal the result's own
    commits, aborts, rounds and arbitration losses; the engine counters
    see nothing (the rounds bypass `apply`, as the reference's)."""
    from repro_torch import obs
    from repro_torch.txn import mcas as tmcas
    monkeypatch.setenv("BIGATOMIC_OBS", "counters")
    obs.reset()
    try:
        spec, state, txns = _hot_txns(t=10)
        _, res = tmcas.mcas(spec, state, txns)
        snap = obs.snapshot()
        success = res.success.numpy()
        assert snap["mcas.commits"] == int(success.sum())
        assert snap["mcas.aborts"] == int((~success).sum())
        assert snap["mcas.rounds"] == int(res.rounds)
        assert snap["mcas.backoff"] == int(res.attempts.sum())
        assert snap["engine.batches"] == 0
    finally:
        obs.reset()


def test_mcas_leaves_the_callers_state_unless_donated():
    from repro_torch.txn import mcas as tmcas
    spec, state, txns = _hot_txns()
    before = [x.clone() for x in state]
    new_state, res = tmcas.mcas(spec, state, txns)
    assert res.success.any()
    for a, b in zip(state, before):
        assert torch.equal(a, b)
    donated, _ = tmcas.mcas(spec, state, txns, donate=True)
    assert donated.data.data_ptr() == state.data.data_ptr()
    assert torch.equal(donated.data, new_state.data)


def test_make_txns_validation():
    from repro_torch import atomics
    with pytest.raises(ValueError, match="duplicate slots"):
        atomics.make_txns([[1, 1]], k=2, device="cpu")
    with pytest.raises(ValueError, match="duplicate slots"):
        atomics.make_txns(torch.tensor([[2, -1, 2]]), k=2, device="cpu")
    with pytest.raises(ValueError, match="mismatched k"):
        atomics.make_txns([[0, 1]], desired=np.zeros((1, 2, 3), np.uint32),
                          k=2, device="cpu")
    with pytest.raises(ValueError, match="rank-2"):
        atomics.make_txns([0, 1], k=2, device="cpu")
    spec = atomics.AtomicSpec(4, 3, "cached_me", p_max=8)
    with pytest.raises(ValueError, match="txn word width"):
        atomics.mcas(spec, atomics.init(spec, device="cpu"),
                     atomics.make_txns([[0]], k=2, device="cpu"))
    t = atomics.make_txns([[0, -1], [-1, -1]], k=2, device="cpu")
    assert (t.t, t.w) == (2, 2)


def test_versionlist_publish_validation():
    from repro_torch import atomics
    from repro_torch.txn import versionlist as vl
    spec = atomics.VersionSpec(n=4, k=1, depth=2)
    st = vl.init(spec, device="cpu")
    with pytest.raises(ValueError, match="distinct"):
        vl.publish(spec, st, [1, 1], [[1], [2]], [1, 2])
    with pytest.raises(ValueError, match="distinct"):
        vl.publish(spec, st, torch.tensor([3, 0, 3]), [[1], [2], [3]],
                   [1, 2, 3])
    with pytest.raises(ValueError, match="depth"):
        atomics.VersionSpec(n=4, k=1, depth=1)
    new = vl.publish(spec, st, [2], [[5]], [1])       # st stays valid
    assert int(st.count[2]) == 0 and int(new.count[2]) == 1


def test_make_map_txns_validation():
    from repro_torch.txn import map as tmap
    with pytest.raises(ValueError, match="duplicate keys"):
        tmap.make_map_txns(np.zeros((1, 1), np.uint32),
                           np.asarray([[5, 5]], np.uint32), device="cpu")
    tmap.make_map_txns(np.zeros((1, 1), np.uint32),
                       np.asarray([[5, 5]], np.uint32),
                       write_mask=[[True, False]], device="cpu")
    with pytest.raises(ValueError, match="rank-2"):
        tmap.make_map_txns(np.zeros((2,), np.uint32),
                           np.zeros((2, 1), np.uint32), device="cpu")
    with pytest.raises(ValueError, match="txn counts"):
        tmap.make_map_txns(np.zeros((2, 1), np.uint32),
                           np.zeros((3, 1), np.uint32), device="cpu")


def test_atomics_facade_exports_txn_layer():
    from repro_torch import atomics, guard
    from repro_torch.core.specs import VersionSpec
    from repro_torch.txn import map as tmap
    from repro_torch.txn import mcas as tmcas
    assert atomics.mcas is tmcas.mcas
    assert atomics.make_txns is tmcas.make_txns
    assert atomics.TxnBatch is tmcas.TxnBatch
    assert atomics.McasResult is tmcas.McasResult
    assert atomics.VersionSpec is VersionSpec
    assert atomics.txn.transact is tmap.transact
    assert atomics.txn.run_mcas is tmcas.mcas
    assert guard.check_version_list is not None
    from repro_torch.core import distributed
    assert atomics.dist is distributed       # the sharded MCAS: dist.mcas
    assert atomics.dist.mcas is not atomics.mcas
