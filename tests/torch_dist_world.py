"""Gloo worlds for the port's distributed tests, and the JAX reference's
runs of the same cases.

A test module writes its cases (plain dicts of numpy arrays, pickled) and
calls `run_world(job, ...)`: it starts one process per rank of a gloo
world on 127.0.0.1 (`python tests/torch_dist_world.py rank ...`), each with
one thread and a process-group timeout, and waits at most `timeout`
seconds, killing every rank when one fails or the time is up.  Each rank
runs the job's cases on `repro_torch.core.distributed` (it imports no JAX)
and pickles what it saw to `<out>/rank<r>.pkl`.  `start_reference` runs
the cases marked `ref` through `repro.core.distributed` in one subprocess
on 8 fake XLA host devices.

Case dicts:
  name, kind        "table" | "oneshard" | "v1" | "hash" | "mcas" |
                    "txnmap" | "queue" | "serving" | "executor" |
                    "elastic" | "train_elastic"
  mesh              (shape, axis names) of the 8-rank world
  inner             ("atomic", n, k, strategy, p_max) or
                    ("hash", nb, vw, strategy, p_max)
  dist              DistSpec keywords besides `inner`
  init              global word[n, k] initial values (uint32) or None
  batches           table: global (kind, slot, expected, desired) per step;
                    hash: global (kind, key, value)
  width             lanes each rank passes (<= p_local; the rest IDLE)
  mcas              seed, steps, t, w, match_frac, policy, txns (explicit
                    global (slot, expected, desired) steps, else drawn
                    from the seed against the live logical values)
  plugin            register the test strategy `dist_plugin_check`
  round, obs        table: through `apply_round` with its order; under
                    BIGATOMIC_OBS=counters, the snapshot recorded
  map               txnmap: global (read_key, write_key, read_mask,
                    write_mask, write_del, fn name) per step, each through
                    `transact_dist` and the one-device `transact`;
                    `policy` (BackoffPolicy arguments) and `max_rounds`
  queue             capacity, k, strategy, p_max, policy and the global
                    calls ("enq", values) / ("deq", p) / ("run", kinds,
                    values), on a sharded and a one-device `BigQueue`;
                    every routed batch recorded
  serve             serving: config, engine keywords, prompts, new tokens,
                    the path of the reference's weights (its `ref` run
                    draws them and writes them there; the ranks wait)
  executor          a `runtime.Executor` over a `DistTarget` (the
                    `executor` scenario): strategy, n, k, p_global, streams
                    (S), n_batches, hot, seed, init, faults (Fault
                    keywords), checkpoint_every, watchdog, slot_hi (the
                    streams' cells below it), and either
                    `halving` (the mesh (s, 8 // s) ("shard", "rest"), s
                    halving on a shard loss) or `two_level` (mesh (2, 4)
                    ("node", "shard"), n_nodes 2); optional `guard`
                    (BIGATOMIC_GUARD=on), `ckdir` (disk checkpoints, then a
                    fresh executor resumes from them) and `plant` (one
                    rank's preemption flag, clock or issue: see
                    `_Rank.executor`).  Every issue record, the recoveries,
                    checkpoints, flags and the final table are recorded.
  elastic           `reshard_dist` 8 -> 6 -> 4 -> 8 at (n, k, strategy):
                    values and versions after each hop, an LL link taken
                    before the trip and its SC after it
  train_elastic     deepseek_7b reduced's train state through
                    `elastic_mesh(n, model_parallel=2, global_batch=2)` and
                    `reshard_state` for n in `hops`: each hop's placements,
                    membership, and every leaf gathered at the end
  train             `launch.train.train(mesh=...)` on the case's reduced
                    config in fp32 (`train_config`): `arch`, `variant`,
                    `comp`, `steps`, resumed from `ckdir` (a one-device
                    checkpoint the test wrote); with `probe`, first one
                    step on the checkpoint's state with its gradients
                    kept and the gradients of the leaves every rank
                    computes whole (`compute_cuts`)
  train_preempt     a stop flag on rank `stop_rank` alone at its
                    `stop_at`-th poll, then resumed at the same mesh and
                    (from a copy) at `resume_mesh`
  train_refuse      `train(mesh=...)` on each of `archs`: the error each
                    rank raised
  train_ref         `train(mesh=...)` from the reference's initial state
                    (`state`, which the reference's run writes; the ranks
                    wait), to hold against its live sharded step
  train_specs       (reference only) `dist._spec`, each device's slice and
                    `batch_shardings` for the case's shapes and meshes
  ref               also run on the reference
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import pickle
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
PG_TIMEOUT_S = 60
PLUGIN = "dist_plugin_check"


def map_fn_copy(rv, rf):
    """Write the read values back (R == W); numpy, jnp and torch alike."""
    return rv


def map_fn_sum_plus_one(rv, rf):
    """The counter: the read set's sum + 1 (W == 1)."""
    return rv.sum(axis=1, keepdims=True) + 1


MAP_FNS = {"copy": map_fn_copy, "sum_plus_one": map_fn_sum_plus_one}


def np_ctx(ctx) -> tuple:
    """A LinkCtx as numpy (slot int32, version / value uint32, linked)."""
    slot, version, value, linked = (
        x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)
        for x in ctx)
    return (slot.astype(np.int32), bits(version), bits(value),
            linked.astype(bool))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra) -> dict:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]),
        OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", **extra)
    env.pop("BIGATOMIC_OBS", None)
    return env


def run_world(job: str, inputs, out_dir, *, world: int = WORLD,
              timeout: float = 240, pg_timeout: float = PG_TIMEOUT_S):
    """Run `job` on `world` gloo ranks; returns (return codes, each rank's
    stderr tail, seconds).  A rank that fails, or the time limit, ends
    every rank."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    port = free_port()
    logs = [open(out_dir / f"rank{r}.log", "w") for r in range(world)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, __file__, "rank", job, str(inputs), str(out_dir),
         str(r), str(world), str(port), str(pg_timeout)],
        env=_env(), stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(world)]
    try:
        while True:
            rcs = [p.poll() for p in procs]
            if all(rc is not None for rc in rcs) or any(rc for rc in rcs) \
                    or time.perf_counter() - t0 > timeout:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        rcs = [p.wait() for p in procs]
        for f in logs:
            f.close()
    seconds = time.perf_counter() - t0
    tails = [(out_dir / f"rank{r}.log").read_text()[-3000:]
             for r in range(world)]
    return rcs, tails, seconds


def load_world(out_dir, world: int = WORLD) -> list:
    return [pickle.loads((Path(out_dir) / f"rank{r}.pkl").read_bytes())
            for r in range(world)]


def start_reference(job: str, inputs, out_path) -> subprocess.Popen:
    """The reference's run of the cases marked `ref`, in the background."""
    env = _env(JAX_PLATFORMS="cpu", XLA_FLAGS=" ".join(
        [os.environ.get("XLA_FLAGS", ""),
         "--xla_force_host_platform_device_count=8"]).strip())
    return subprocess.Popen(
        [sys.executable, __file__, "ref", job, str(inputs), str(out_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


@contextlib.contextmanager
def reference(job: str, inputs, out_path):
    """`start_reference`'s process, killed and reaped on the way out if it
    is still running (a test that fails before `finish_reference` leaves
    no process behind)."""
    proc = start_reference(job, inputs, out_path)
    try:
        yield proc
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        proc.stdout.close()


def finish_reference(proc: subprocess.Popen, out_path, timeout: float = 240):
    try:
        log, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        log, _ = proc.communicate()
    assert proc.returncode == 0, log[-4000:]
    return pickle.loads(Path(out_path).read_bytes())


def bits(x) -> np.ndarray:
    """A result as numpy (a copy: a state updated in place later leaves it
    as it was); 32-bit integers as their uint32 bits."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy().copy()
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype in (np.int32, np.uint32) else x


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


def make_dspec(atomics, dsb, case):
    kind, *args = case["inner"]
    if kind == "atomic":
        n, k, strategy, p_max = args
        inner = atomics.AtomicSpec(n, k, strategy, p_max=p_max)
    else:
        nb, vw, strategy, p_max = args
        inner = atomics.HashSpec(nb, vw=vw, strategy=strategy, p_max=p_max)
    return dsb.DistSpec(inner, **case["dist"])


def txn_steps(case, logical):
    """Yield each MCAS step's global (slot, expected, desired), drawn
    against `logical()` (the live global values) unless explicit."""
    m = case["mcas"]
    if m.get("txns") is not None:
        yield from m["txns"]
        return
    rng = np.random.default_rng(m["seed"])
    n, k = case["inner"][1], case["inner"][2]
    for _ in range(m["steps"]):
        yield txn_arrays(rng, t=m["t"], w=m["w"], n=n, k=k,
                         current=logical(), match_frac=m["match_frac"])


class TickClock:
    """Stand-in for perf_counter: every call advances 1 ms, so each issue
    measures one tick and injected delays dominate (the same in both
    packages)."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.001
        return self.t


def walk(tree, prefix=()):
    """(path, leaf) over a nested dict / tuple / list tree, dicts by key."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from walk(tree[key], prefix + (key,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from walk(v, prefix + (i,))
    else:
        yield prefix, tree


def run_executor(rt, Recorder, case, target, *, recorder=None, guard=None):
    """The case's executor on `target` (either package's `runtime`):
    SyntheticStreams of the case's seeds, its faults, watchdog and
    checkpoints, a tick clock."""
    s, n, k, w = case["streams"], case["n"], case["k"], case["p_global"]
    hot = case.get("hot", (4, 0.3))
    streams = [rt.SyntheticStream(f"s{i}", seed=case["seed"] + i, n=n, k=k,
                                  width=w, n_batches=case["n_batches"],
                                  slot_hi=case.get("slot_hi"),
                                  hot_cells=hot[0], hot_frac=hot[1])
               for i in range(s)]
    inj = rt.FaultInjector([rt.Fault(**f) for f in case.get("faults", [])],
                           seed=case.get("fault_seed", 0))
    return rt.Executor(
        target, streams, slots=1, oversubscription=4,
        watchdog=rt.StragglerWatchdog(n_hosts=s) if case.get("watchdog")
        else None, injector=inj, guard=guard,
        checkpoint_every=case.get("checkpoint_every", 0),
        checkpoint_dir=case.get("ckdir"),
        recorder=recorder or Recorder(trace=False, clock=TickClock()))


def executor_record(ex, rep, logical, versions) -> dict:
    """What an executor run is compared on: every issue (stream, seq, ops,
    claimed order, overflow, value, success), the report's recoveries
    without `latency_s`, checkpoints, rounds, issues, flags, the shed
    streams, data faults and scrubs, and the final table."""
    hist = [(r.stream, r.seq, *(bits(x) for x in r.ops),
             None if r.order is None else np.asarray(r.order, np.int64),
             bits(r.overflow), bits(r.value), bits(r.success))
            for r in ex.history]
    return {
        "history": hist,
        "recoveries": [{k_: v for k_, v in r.items() if k_ != "latency_s"}
                       for r in rep["recoveries"]],
        "checkpoints": list(rep["checkpoints"]), "rounds": rep["rounds"],
        "issues": rep["issues"], "stopped": rep["stopped"],
        "deprioritized": rep["deprioritized"],
        "flags": [(r, list(f)) for r, f in ex.recorder.flags],
        "shed": rep["shed"], "data_faults": rep["data_faults"],
        "scrubs": [{k_: v for k_, v in sc.items() if k_ != "latency_s"}
                   for sc in rep["scrubs"]],
        "logical": bits(logical), "versions": bits(versions),
        "width": ex.target.width, "n_shards": ex.target.n_shards}


# Sharded training: the shape (seq, global batch: every data axis of the
# 8-rank meshes divides it), AdamW and data seed of every `train*` case.
TRAIN_SHAPE = (32, 8)
TRAIN_OPT = {"lr": 1e-3, "warmup": 1, "total_steps": 10}
TRAIN_DATA_SEED = 5


def train_config(get_config, arch: str, variant: dict):
    """A train case's config: `arch` reduced, in fp32, with `variant`."""
    return dataclasses.replace(get_config(arch, reduced=True),
                               param_dtype="float32",
                               compute_dtype="float32", **variant)


def moment_state(state, seed: int, zeros_like, cast):
    """An AdamW state as after 5 steps (m ~ N(0, 1e-3), v ~ U(0.5, 1.5) x
    1e-5, step 5; drawn leaf by leaf in `walk` order), so an update is m /
    sqrt(v) and not the sign of a gradient near 0 that a rounding moves.
    `cast(array, like)` makes a leaf of either package."""
    rng = np.random.default_rng(100 + seed)
    m = {path: rng.standard_normal(tuple(x.shape)) * 1e-3
         for path, x in walk(state["m"])}
    v = {path: rng.uniform(0.5, 1.5, tuple(x.shape)) * 1e-5
         for path, x in walk(state["v"])}

    def rebuild(tree, vals, prefix=()):
        if isinstance(tree, dict):
            return {k: rebuild(t, vals, prefix + (k,))
                    for k, t in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(rebuild(t, vals, prefix + (i,))
                              for i, t in enumerate(tree))
        return cast(vals[prefix], tree)
    return {"m": rebuild(state["m"], m), "v": rebuild(state["v"], v),
            "step": zeros_like(state["step"]) + 5}


class _StopAfter:
    """A preemption guard whose flag rises at its `n`-th poll on one rank
    alone (`planted`), as a signal delivered to one process would."""

    def __init__(self, planted: bool, n: int):
        self.planted, self.n, self.polls = planted, n, 0

    @property
    def should_stop(self) -> bool:
        self.polls += 1
        return self.planted and self.polls >= self.n


class _SignalAt:
    """A preemption guard whose flag is set on one rank alone once its
    executor reaches round `at` (as a signal delivered to one process
    would be)."""

    def __init__(self, planted: bool, at: int):
        self.planted, self.at, self.ex, self._set = planted, at, None, False

    @property
    def should_stop(self) -> bool:
        return self._set or (self.planted and self.ex._round >= self.at)

    def request_stop(self):
        self._set = True


# ---------------------------------------------------------------------------
# One rank of the port's world.
# ---------------------------------------------------------------------------

class _Rank:
    def __init__(self, pg_timeout: float):
        import torch
        import torch.distributed as dist
        from repro_torch import atomics
        from repro_torch.core import cachehash as ch
        from repro_torch.core import distributed as dsb
        from repro_torch.sync.queue import BackoffPolicy
        from repro_torch.txn import mcas as txn_mcas
        self.torch, self.dist, self.atomics, self.ch = torch, dist, atomics, ch
        self.dsb, self.Backoff, self.txn_mcas = dsb, BackoffPolicy, txn_mcas
        self.meshes = {}
        self.timeout = datetime.timedelta(seconds=pg_timeout)
        self.words = []
        a2a = dist.all_to_all_single

        def counted(out, inp, *args, **kw):  # the words each call hands over
            self.words.append(inp.numel())
            return a2a(out, inp, *args, **kw)
        dist.all_to_all_single = counted

    def mesh(self, case):
        key = (tuple(case["mesh"][0]), tuple(case["mesh"][1]))
        if key not in self.meshes:              # every rank, same order
            self.meshes[key] = self.dsb.make_mesh(*key, device="cpu",
                                                  timeout=self.timeout)
        return self.meshes[key]

    def setup(self, case):
        if case.get("plugin"):
            class PlainCloneDist(self.atomics.StrategyImpl):
                name = PLUGIN
            self.atomics.register_strategy(PlainCloneDist(), overwrite=True)
        mesh = self.mesh(case)
        dspec = make_dspec(self.atomics, self.dsb, case)
        return mesh, dspec, self.dsb.shard_index(mesh, dspec)

    def lanes(self, case, dspec, shard):
        pl = dspec.p_local
        return slice(shard * pl, shard * pl + case.get("width", pl))

    def table(self, case):
        """`apply` a step (`apply_round` with its claimed order where the
        case says `round`); with `obs`, under BIGATOMIC_OBS=counters, the
        rank's `obs.snapshot()` after the last step."""
        from repro_torch import obs
        dsb, atomics = self.dsb, self.atomics
        mesh, dspec, shard = self.setup(case)
        k = dspec.inner.k
        st = dsb.init_dist(mesh, dspec, case["init"])
        out = {"shard": shard, "init_local": [bits(x) for x in st.local],
               "steps": []}
        ctx = dsb.init_dist_ctx(mesh, dspec)
        lanes = self.lanes(case, dspec, shard)
        if case.get("obs"):
            os.environ["BIGATOMIC_OBS"] = "counters"
            obs.reset()
        for kind, slot, exp, des in case["batches"]:
            ops = atomics.make_ops(kind[lanes], slot[lanes], exp[lanes],
                                   des[lanes], k=k, device="cpu")
            self.words.clear()
            step = {}
            if case.get("round"):
                h = dsb.apply_round(mesh, dspec, st, ops, ctx,
                                    with_order=True)
                step["ready"] = h.wait().ready()
                st, ctx, res, ovf = h.state, h.ctx, h.result, h.overflow
                step["order"] = h.order
            else:
                st, ctx, res, ovf = dsb.apply(mesh, dspec, st, ops, ctx)
            step["words"] = list(self.words)
            step.update({
                "value": bits(res.value), "success": bits(res.success),
                "overflow": bits(ovf), "ctx": [bits(x) for x in ctx],
                "logical": bits(dsb.logical(dspec, st)),
                "versions": bits(dsb.versions(dspec, st))})
            out["steps"].append(step)
        if case.get("obs"):
            out["snapshot"] = obs.snapshot()
            os.environ.pop("BIGATOMIC_OBS")
        return out

    def v1(self, case):
        """The v1 shims: `init_sharded` + `make_apply` (PLAIN, load /
        store / CAS) on the rank's block and lanes."""
        dsb, atomics = self.dsb, self.atomics
        mesh = self.mesh(case)
        n, k, pl = case["inner"][1], case["inner"][2], case["dist"]["p_local"]
        shard = mesh.coords["shard"]
        table = dsb.init_sharded(mesh, "shard", n, k, case["init"])
        fn = dsb.make_apply(mesh, "shard", n, k, pl)
        out = {"shard": shard, "steps": []}
        lanes = slice(shard * pl, (shard + 1) * pl)
        for kind, slot, exp, des in case["batches"]:
            table, res, count = fn(table, atomics.make_ops(
                kind[lanes], slot[lanes], exp[lanes], des[lanes], k=k,
                device="cpu"))
            out["steps"].append({
                "value": bits(res.value), "success": bits(res.success),
                "count": int(count), "data": bits(table.data),
                "version": bits(table.version)})
        return out

    def oneshard(self, case):
        """s = 1: `dist.apply` (an all_to_all to self each way) against
        `atomics.apply` on the same state, batch and ctx."""
        dsb, atomics = self.dsb, self.atomics
        mesh, dspec, _ = self.setup(case)
        spec, k = dspec.inner, dspec.inner.k
        st = dsb.init_dist(mesh, dspec, case["init"])
        plain = atomics.init(spec, case["init"], device="cpu")
        ctx = dsb.init_dist_ctx(mesh, dspec)
        pctx = atomics.init_ctx(dspec.p_local, k, device="cpu")
        out = {"steps": []}
        for kind, slot, exp, des in case["batches"]:
            ops = atomics.make_ops(kind, slot, exp, des, k=k, device="cpu")
            st, ctx, res, ovf = dsb.apply(mesh, dspec, st, ops, ctx)
            plain, pctx, pres, _, _ = atomics.apply(spec, plain, ops, pctx)
            out["steps"].append({
                "overflow": bits(ovf),
                "dist": [bits(x) for x in (*res, *ctx,
                                           dsb.logical(dspec, st),
                                           dsb.versions(dspec, st))],
                "apply": [bits(x) for x in (*pres, *pctx,
                                            atomics.logical(spec, plain),
                                            plain.version)]})
        return out

    def hash(self, case):
        dsb, ch = self.dsb, self.ch
        mesh, dspec, shard = self.setup(case)
        vw = dspec.inner.vw
        st = dsb.init_dist(mesh, dspec)
        out = {"shard": shard, "steps": []}
        lanes = self.lanes(case, dspec, shard)
        for kind, key, val in case["batches"]:
            ops = ch.make_hash_ops(kind[lanes], key[lanes], val[lanes],
                                   vw=vw, device="cpu")
            self.words.clear()
            st, res, ovf = dsb.apply_hash(mesh, dspec, st, ops)
            words = list(self.words)
            items = dsb.hash_items(dspec, st)
            keys = np.asarray(sorted(items), np.uint32)
            out["steps"].append({
                "found": bits(res.found), "value": bits(res.value),
                "walk_over": bits(res.overflow), "overflow": bits(ovf),
                "words": words, "keys": keys,
                "values": np.asarray([bits(items[x]) for x in keys.tolist()],
                                     np.uint32).reshape(-1, vw)})
        return out

    def txnmap(self, case):
        """Each step through `transact_dist` on the sharded CacheHash and
        through the one-device `transact` on a local one (both under the
        case's `policy` and `max_rounds`): both results, both contents,
        the words each all_to_all handed over; a `RuntimeError` of
        `transact_dist` ends the case, its message recorded."""
        from repro_torch.txn import map as tmap
        dsb, ch = self.dsb, self.ch
        mesh, dspec, shard = self.setup(case)
        hs = dspec.inner
        st = dsb.init_dist(mesh, dspec)
        one = ch.init_hash(hs, device="cpu")
        out = {"shard": shard, "steps": []}

        def contents(items):
            keys = np.asarray(sorted(items), np.uint32)
            return keys, np.asarray([bits(items[x]) for x in keys.tolist()],
                                    np.uint32).reshape(-1, hs.vw)
        kw = dict(policy=self.Backoff(*case.get("policy", ("none",))),
                  max_rounds=case.get("max_rounds"))
        for rk, wk, rm, wm, wd, fname in case["map"]:
            txns = tmap.make_map_txns(rk, wk, read_mask=rm, write_mask=wm,
                                      write_del=wd, vw=hs.vw, device="cpu")
            fn = MAP_FNS[fname]
            self.words.clear()
            try:
                st, res = tmap.transact_dist(mesh, dspec, st, txns, fn, **kw)
            except RuntimeError as err:         # every rank alike, or a hang
                out["error"] = str(err)
                break
            words = list(self.words)
            one, res1 = tmap.transact(hs, one, txns, fn, **kw)
            out["steps"].append({
                "dist": [bits(x) for x in res], "one": [bits(x) for x in res1],
                "words": words,
                "items": contents(dsb.hash_items(dspec, st)),
                "items_one": contents(ch.items(one, inline=hs.inline,
                                               vw=hs.vw))})
        return out

    def queue(self, case):
        """The same calls on a sharded `BigQueue` and a one-device one:
        each call's outputs, the commit log, `len`, the ring's cells and
        versions; every routed batch of the sharded queue (its global
        ops, the ctx in and out, results, logical values and versions
        after it)."""
        from repro_torch.sync.queue import BigQueue
        dsb, atomics = self.dsb, self.atomics
        mesh = self.mesh(case)
        s, qc = case["dist"]["n_shards"], case["queue"]
        kw = dict(capacity=qc["capacity"], k=qc["k"],
                  strategy=qc["strategy"], p_max=qc["p_max"],
                  policy=self.Backoff(*qc["policy"]), device="cpu")
        shq = BigQueue(**kw, mesh=mesh, shard_axis=case["dist"]["axis"],
                       n_shards=s)
        oneq = BigQueue(**kw)
        n = oneq._tspec.n
        view = dsb.DistSpec(shq._dist_inner, case["dist"]["axis"], s, 1)
        routed = []
        apply_global = dsb.apply_global

        def recorded(mesh_, dspec, dstate, ops, ctx=None, **kwargs):
            got = apply_global(mesh_, dspec, dstate, ops, ctx, **kwargs)
            st, nctx, res, ovf = got
            q = ops.kind.shape[0]                 # IDLE-padded to s lanes
            routed.append({
                "p_local": -(-q // dspec.n_shards),
                "ops": [bits(x) for x in ops],
                "ctx": None if ctx is None else np_ctx(ctx),
                "value": bits(res.value), "success": bits(res.success),
                "overflow": bits(ovf), "nctx": np_ctx(nctx),
                "logical": bits(dsb.logical(dspec, st)),
                "versions": bits(dsb.versions(dspec, st))})
            return got

        def run(q, call):
            if call[0] == "enq":
                got = q.run_batch(np.zeros(len(call[1]), np.int32), call[1])
            elif call[0] == "deq":
                got = q.run_batch(np.ones(call[1], np.int32))
            else:
                got = q.run_batch(call[1], call[2])
            return [bits(x) for x in got[:2]] + [int(got[2])]

        out = {"shard": dsb.shard_index(mesh, view), "calls": []}
        dsb.apply_global = recorded
        try:
            for call in qc["calls"]:
                rec = {"sharded": run(shq, call), "one": run(oneq, call)}
                rec["len"] = (len(shq), len(oneq))
                rec["log"] = (list(shq.commit_log), list(oneq.commit_log))
                rec["cells"] = (bits(dsb.logical(view, shq._dstate))[:n],
                                bits(atomics.logical(oneq._tspec,
                                                     oneq.state)))
                rec["versions"] = (bits(dsb.versions(view, shq._dstate))[:n],
                                   bits(oneq.state.version))
                out["calls"].append(rec)
        finally:
            dsb.apply_global = apply_global
        out["routed"] = routed
        out["n_pad"] = shq._dist_inner.n
        return out

    def length(self, case):
        """`len()` of a sharded `BigQueue` holding `initial` items."""
        from repro_torch.sync.queue import BigQueue
        qc = case["queue"]
        q = BigQueue(qc["capacity"], k=qc["k"], strategy=qc["strategy"],
                     initial_items=qc["initial"], mesh=self.mesh(case),
                     n_shards=case["dist"]["n_shards"], device="cpu")
        return {"len": len(q)}

    def serving(self, case):
        """`ServingEngine(mesh=...)` on the reference's weights
        (`serve["params"]`): `run_to_completion` and `run_pipelined` on
        fresh engines, the tokens, `dispatch_count`, the
        page table's contents and the free ring's length after the run."""
        import dataclasses

        from repro_torch import convert
        from repro_torch.configs import get_config
        from repro_torch.serving import Request, ServingEngine
        dsb = self.dsb
        mesh = self.mesh(case)
        sv = case["serve"]
        cfg = dataclasses.replace(get_config(sv["arch"], reduced=True),
                                  **sv["cfg"])
        path, t0 = Path(sv["params"]), time.perf_counter()
        while not path.exists():        # the reference's run draws them
            if time.perf_counter() - t0 > 120:
                raise TimeoutError(f"{path} never written")
            time.sleep(0.05)
        params = convert.model_params(pickle.loads(path.read_bytes()),
                                      device="cpu")
        out = {"shard": mesh.coords[case["dist"]["axis"]]}
        for how in ("run_to_completion", "run_pipelined"):
            eng = ServingEngine(cfg, params, mesh=mesh,
                                shard_axis=case["dist"]["axis"],
                                device="cpu", **sv["engine"])
            for rid, prompt in enumerate(sv["prompts"]):
                eng.submit(Request(rid=rid, prompt=prompt,
                                   max_new_tokens=sv["new"]))
            tokens = getattr(eng, how)(max_steps=40)
            table = eng.paged.state.table
            dspec = dsb.DistSpec(eng.paged.spec.table,
                                 case["dist"]["axis"],
                                 eng.paged.spec.n_shards, 1)
            out[how] = {"tokens": tokens,
                        "dispatch_count": eng.dispatch_count,
                        "items": dsb.hash_items(dspec, table),
                        "free": len(eng.paged.free),
                        "spec_shards": eng.paged.spec.n_shards}
        return out

    def _factory(self, case):
        """n_surviving -> (mesh, dspec): the `executor` scenario's halving
        geometry, the mesh (s, world // s) ("shard", "rest") cached by
        shape (every rank builds it at the same point)."""
        n, k = case["n"], case["k"]
        world = self.dist.get_world_size()

        def factory(n_surviving):
            s = 1
            while s * 2 <= n_surviving and n % (s * 2) == 0:
                s *= 2
            mesh = self.mesh({"mesh": ((s, world // s), ("shard", "rest"))})
            return mesh, self.dsb.DistSpec(
                self.atomics.AtomicSpec(n, k, case["strategy"], p_max=64),
                "shard", s, case["p_global"] // s)
        return factory

    def executor(self, case):
        """The case's executor over a `DistTarget` on every rank.  Plants
        (`plant` = (what, rank, arg)): "preempt" sets rank's preemption
        flag alone at round arg; "clock" makes rank's recorded latency of
        stream arg 50 ms slower; "raise" makes rank's arg-th issue raise
        in its host preparation, once.  With `ckdir` the run checkpoints
        to disk (the mesh's first rank writing: each rank counts its own
        writes), then a fresh executor resumes from the newest verifying
        step and runs to the end."""
        from repro_torch import runtime as rt
        from repro_torch.checkpoint import disk
        from repro_torch.obs import Recorder
        dsb = self.dsb
        rank = self.dist.get_rank()
        what, at, arg = case.get("plant") or (None, -1, None)
        if case.get("two_level"):
            mesh = self.mesh({"mesh": ((2, 4), ("node", "shard"))})
            dspec = dsb.DistSpec(
                self.atomics.AtomicSpec(case["n"], case["k"],
                                        case["strategy"], p_max=64),
                "shard", 8, case["p_global"] // 8, n_nodes=2,
                node_axis="node")
            factory = None
        else:
            factory = self._factory(case)
            mesh, dspec = factory(self.dist.get_world_size())
        saves = []
        save = disk.save_checkpoint

        def counted(*a, **kw):
            saves.append(a[1])
            return save(*a, **kw)
        disk.save_checkpoint = counted
        if case.get("guard"):
            os.environ["BIGATOMIC_GUARD"] = "on"
        try:
            target = rt.DistTarget(mesh, dspec, case["init"],
                                   mesh_factory=factory)
            recorder = Recorder(trace=False, clock=TickClock())
            if what == "clock" and rank == at:
                lat = recorder.issue_latency
                recorder.issue_latency = lambda si, sec: lat(
                    si, sec + (0.05 if si == arg else 0.0))
            guard = _SignalAt(what == "preempt" and rank == at, arg) \
                if what == "preempt" else None
            ex = run_executor(rt, Recorder, case, target, recorder=recorder,
                              guard=guard)
            if guard is not None:
                guard.ex = ex
            if what == "raise" and rank == at:
                prep, calls = target._prepare, []

                def raising(ops):
                    calls.append(1)
                    if len(calls) == arg:
                        raise RuntimeError("planted: this rank's host "
                                           "preparation raised")
                    return prep(ops)
                target._prepare = raising
            failures = []
            note = ex._note_failure
            ex._note_failure = lambda si, reason: (
                failures.append((ex._round, si, reason)), note(si, reason))
            rep = ex.run()
            out = executor_record(ex, rep, dsb.logical(target.dspec,
                                                       target.state),
                                  dsb.versions(target.dspec, target.state))
            out["failures"] = failures
            if case.get("ckdir"):
                target2 = rt.DistTarget(mesh, dspec, case["init"],
                                        mesh_factory=factory)
                ex2 = run_executor(rt, Recorder, dict(case, faults=[]),
                                   target2)
                out["resumed_round"] = ex2.resume()
                rep2 = ex2.run()
                out["resumed"] = executor_record(
                    ex2, rep2, dsb.logical(target2.dspec, target2.state),
                    dsb.versions(target2.dspec, target2.state))
                out["steps_on_disk"] = disk.list_steps(case["ckdir"])
        finally:
            disk.save_checkpoint = save
            os.environ.pop("BIGATOMIC_GUARD", None)
        out["saves"] = saves
        return out

    def elastic(self, case):
        """`reshard_dist` 8 -> 6 -> 4 -> 8 (the `elastic` scenario's
        table): an LL of cell 5 and a STORE of 77 to cell 7 first, the
        values and versions after each hop (on the ranks of its mesh;
        None elsewhere), then the SC of cell 5 with the link taken before
        the trip."""
        from repro_torch.runtime import reshard_dist
        dsb, atomics = self.dsb, self.atomics
        n, k = case["n"], case["k"]

        def geo(s):
            mesh = self.mesh({"mesh": ((s,), ("shard",))})
            return mesh, dsb.DistSpec(
                atomics.AtomicSpec(n, k, case["strategy"], p_max=64),
                "shard", s, 8)
        mesh, dspec = geo(8)
        st = dsb.init_dist(mesh, dspec, case["init"])
        p = dspec.p_global
        kind = np.full(p, atomics.IDLE, np.int32)
        slot = np.zeros(p, np.int32)
        desired = np.zeros((p, k), np.uint32)
        kind[0], slot[0] = atomics.LL, 5
        kind[1], slot[1], desired[1] = atomics.STORE, 7, 77
        zeros = np.zeros((p, k), np.uint32)
        st, ctx, _, _ = dsb.apply_global(mesh, dspec, st, atomics.make_ops(
            kind, slot, zeros, desired, k=k, device="cpu"))
        out = {"hops": []}
        for s in case["hops"]:
            mesh2, dspec2 = geo(s)
            st = reshard_dist(dspec, st, dspec2, mesh2)
            mesh, dspec = mesh2, dspec2
            out["hops"].append({
                "s": s, "member": mesh.member,
                "logical": bits(dsb.logical(dspec, st)) if mesh.member
                else None,
                "versions": bits(dsb.versions(dspec, st)) if mesh.member
                else None})
        kind = np.full(p, atomics.IDLE, np.int32)
        kind[0], slot[0], desired[0] = atomics.SC, 5, 55
        st, ctx, res, _ = dsb.apply_global(mesh, dspec, st, atomics.make_ops(
            kind, slot, zeros, desired, k=k, device="cpu"), ctx)
        out["sc_success"] = bool(res.success[0])
        out["logical_after"] = bits(dsb.logical(dspec, st))
        return out

    def train_elastic(self, case):
        """deepseek_7b reduced's (params, AdamW state) through
        `elastic_mesh` + `reshard_state` for each n of `hops`: per hop the
        mesh's plan, this rank's membership and every param leaf's
        placement; at the end, on the ranks of the last mesh, whether
        every gathered leaf (params, both moments, the step) equals the
        initial one bit for bit."""
        import torch
        from repro_torch import dist
        from repro_torch.configs import get_config
        from repro_torch.launch.steps import init_train_state
        from repro_torch.optim import AdamWConfig
        from repro_torch.runtime import elastic_mesh, reshard_state
        cfg = get_config("deepseek_7b", reduced=True)
        state = init_train_state(cfg, AdamWConfig(warmup=1, total_steps=2),
                                 0, device="cpu")
        want = [(path, x.clone()) for path, x in walk(state)]
        out = {"hops": []}
        mesh = None
        for n_dev in case["hops"]:
            mesh = elastic_mesh(n_dev, model_parallel=2, global_batch=2,
                                device="cpu", timeout=self.timeout)
            state = reshard_state(state, cfg, mesh)
            out["hops"].append({
                "n": n_dev, "shape": mesh.shape, "ranks": mesh.ranks,
                "member": mesh.member,
                "placements": {path: leaf.spec for path, leaf in
                               walk(state[0])},
                "held": [leaf.local is not None
                         for _, leaf in walk(state)]})
        if mesh.member:
            got = [(path, dist.gather_leaf(leaf)) for path, leaf in
                   walk(state)]
            out["equal"] = [
                (a == b and x.dtype == y.dtype and x.shape == y.shape
                 and torch.equal(x.reshape(-1).view(torch.uint8),
                                 y.reshape(-1).view(torch.uint8)))
                for (a, x), (b, y) in zip(want, got)]
            out["n_leaves"] = len(want)
        return out

    # -- sharded training ---------------------------------------------------

    def _train_setup(self, case):
        from repro_torch.configs import get_config
        from repro_torch.configs.shapes import Shape
        from repro_torch.optim import AdamWConfig
        cfg = train_config(get_config, case["arch"], case.get("variant", {}))
        t, b = TRAIN_SHAPE
        opt = AdamWConfig(**TRAIN_OPT)
        kw = dict(seed=TRAIN_DATA_SEED, opt_cfg=opt, log_every=0,
                  ckpt_every=100, grad_compression=case.get("comp", "none"))
        return cfg, Shape("train", t, b, "train"), opt, kw

    def _gathered(self, tree):
        """Every leaf of a ShardedLeaf tree whole (each rank joins the
        gathers), as numpy on rank 0, None elsewhere."""
        from repro_torch import dist
        got = {path: bits(dist.gather_leaf(leaf)) for path, leaf in
               walk(tree)}
        return got if self.dist.get_rank() == 0 else None

    def _probe(self, case, cfg, shape, opt, mesh):
        """Step 1's gradients on the checkpoint's state, taken as the
        mesh's step takes them (each stored slice to its compute cut, the
        rank's rows, the global mean, summed over the batch axes), gathered;
        its loss and global grad norm (after compression, as the step's);
        and (with a 'model' axis) the gradients of the leaves this rank
        computes whole, in the compute layout (their bytes)."""
        torch = self.torch
        from repro_torch import dist
        from repro_torch.checkpoint import restore_checkpoint
        from repro_torch.data import DataPipeline, to_device
        from repro_torch.launch import steps as st
        from repro_torch.models.common import tree_leaves, tree_map
        from repro_torch.models.transformer import (compute_cuts,
                                                    lm_loss_terms)
        from repro_torch.optim import (compress_grads, decompress_grads,
                                       global_norm)
        from repro_torch.runtime import reshard_state
        template = st.init_train_state(cfg, opt, 0, device="meta")
        state, _ = restore_checkpoint(case["ckdir"], 0, template,
                                      device="cpu")
        params, _ = reshard_state(state, cfg, mesh)
        batch = to_device(DataPipeline(cfg, shape, seed=TRAIN_DATA_SEED)
                          .batch(0), "cpu")
        rules = dist.make_rules(cfg, mesh)
        ax = mesh.groups["model"] if mesh.size("model") > 1 else None
        with dist.axis_rules(mesh, rules):
            live = tree_map(lambda p: p.local.detach().requires_grad_(),
                            params)
            cuts = compute_cuts(tree_map(lambda p: p.shape, params), cfg)
            comp = tree_map(lambda x, p, c: dist.to_compute(
                x, p.placement, p.shape, c), live, params, cuts)
            ce, aux = lm_loss_terms(comp, cfg,
                                    dist.local_rows(batch, mesh, rules))
            loss = ce / st._n_targets(cfg, batch) + aux
            whole = [(path, x) for (path, c), (_, x) in
                     zip(_insertion(cuts), _insertion(comp))
                     if c.dim is None]
            leaves = tree_leaves(live)
            grads = torch.autograd.grad(
                loss, leaves + [x for _, x in whole], allow_unused=True)
            mine = [st._or_zeros(g, p) for g, p in zip(grads, leaves)]
            loss, mine = st._sum_over_batch(mesh, rules, loss.detach(),
                                            mine)
        it = iter(mine)
        tree = tree_map(lambda p: next(it), live)
        out = {"grads": self._gathered(tree_map(
            lambda g, p: dist.ShardedLeaf(g, p.placement, p.shape, p.dtype,
                                          mesh), tree, params))}
        sharded = tree_map(lambda p: p.placement.dim is not None, params)
        comp_name = case.get("comp", "none")
        if comp_name != "none":
            tree, _, meta = compress_grads(tree, None, comp_name,
                                           sharded=sharded, group=ax)
            tree = decompress_grads(tree, meta)
        out["probe"] = (float(loss), float(global_norm(
            tree, sharded=sharded, group=ax)))
        if ax is not None:
            out["whole"] = {path: bits(g) for (path, _), g in
                            zip(whole, grads[len(leaves):])
                            if g is not None}
        return out

    def train(self, case):
        from repro_torch.launch.train import train
        mesh = self.mesh(case)
        cfg, shape, opt, kw = self._train_setup(case)
        out = {"coords": dict(mesh.coords)}
        if case.get("probe"):
            out.update(self._probe(case, cfg, shape, opt, mesh))
        p, s, hist = train(cfg, shape, steps=case["steps"],
                           ckpt_dir=case["ckdir"], mesh=mesh, **kw)
        out["loss"], out["grad_norm"] = hist["loss"], hist["grad_norm"]
        out["slices"] = {path: (leaf.spec, tuple(leaf.local.shape),
                                tuple(leaf.shape))
                         for path, leaf in walk((p, s))}
        out["final"] = self._gathered((p, s))
        return out

    def train_preempt(self, case):
        from repro_torch.checkpoint import list_steps
        from repro_torch.launch.train import train
        mesh = self.mesh(case)
        cfg, shape, opt, kw = self._train_setup(case)
        rank, ck = self.dist.get_rank(), case["ckdir"]
        guard = _StopAfter(rank == case["stop_rank"], case["stop_at"])
        _, _, first = train(cfg, shape, steps=case["steps"], ckpt_dir=ck,
                            mesh=mesh, guard=guard, **kw)
        out = {"first": first["loss"], "steps": list_steps(ck)}
        if rank == 0:
            for dst in case["copies"]:
                shutil.copytree(ck, dst)
        self.dist.barrier()
        p, s, second = train(cfg, shape, steps=case["steps"], ckpt_dir=ck,
                             mesh=mesh, **kw)
        out["second"] = second["loss"]
        out["final"] = self._gathered((p, s))
        other = self.mesh({"mesh": case["resume_mesh"]})
        p, s, third = train(cfg, shape, steps=case["steps"],
                            ckpt_dir=case["copies"][0], mesh=other, **kw)
        out["third"] = third["loss"]
        out["final_other"] = self._gathered((p, s))
        return out

    def train_refuse(self, case):
        from repro_torch.configs import get_config
        from repro_torch.configs.shapes import Shape
        from repro_torch.launch.train import train
        mesh = self.mesh(case)
        out = {}
        for arch in case["archs"]:
            t0 = time.perf_counter()
            try:
                train(get_config(arch, reduced=True), Shape("t", 16, 8, "t"),
                      steps=1, mesh=mesh, log_every=0)
                out[arch] = ("ran", time.perf_counter() - t0)
            except NotImplementedError as err:
                out[arch] = (str(err), time.perf_counter() - t0)
        return out

    def train_ref(self, case):
        """`train(mesh=...)` from the reference's initial state (rank 0
        writes it as a step-0 checkpoint into each case's `ckdir`, once)."""
        from repro_torch import convert
        from repro_torch.checkpoint import latest_step, save_checkpoint
        from repro_torch.launch.train import train
        path, t0 = Path(case["state"]), time.perf_counter()
        while not path.exists():           # the reference's run writes it
            if time.perf_counter() - t0 > 200:
                raise TimeoutError("the reference's initial state never "
                                   "came")
            time.sleep(0.05)
        if self.dist.get_rank() == 0 and latest_step(case["ckdir"]) is None:
            ref = pickle.loads(path.read_bytes())
            state = (convert.model_params(ref["params"], "cpu"),
                     convert.opt_state(ref["opt"], "cpu"))
            save_checkpoint(case["ckdir"], 0, state, meta={"next_step": 0})
        self.dist.barrier()
        mesh = self.mesh(case)
        cfg, shape, opt, kw = self._train_setup(case)
        p, s, hist = train(cfg, shape, steps=case["steps"],
                           ckpt_dir=case["ckdir"], mesh=mesh, **kw)
        return {"loss": hist["loss"], "grad_norm": hist["grad_norm"],
                "final": self._gathered((p, s))}

    def mcas(self, case):
        torch, dsb, txn_mcas = self.torch, self.dsb, self.txn_mcas
        mesh, dspec, shard = self.setup(case)
        s, k = dspec.n_shards, dspec.inner.k
        m = case["mcas"]
        policy = self.Backoff(*m["policy"])
        st = dsb.init_dist(mesh, dspec, case["init"])
        out = {"shard": shard, "steps": []}

        def logical():
            return bits(dsb.logical(dspec, st))
        for slot, exp, des in txn_steps(case, logical):
            t, w = slot.shape
            t_local = -(-t // s)
            rows = slice(min(shard * t_local, t),
                         min((shard + 1) * t_local, t))
            if rows.stop > rows.start:
                txns = txn_mcas.make_txns(slot[rows], exp[rows], des[rows],
                                          k=k, device="cpu")
            else:                                   # this rank holds none
                txns = txn_mcas.TxnBatch(
                    torch.zeros((0, w), dtype=torch.int32),
                    torch.zeros((0, w, k), dtype=torch.int32),
                    torch.zeros((0, w, k), dtype=torch.int32))
            self.words.clear()
            st, res = dsb.mcas(mesh, dspec, st, txns, policy=policy)
            out["steps"].append({
                "txns": (slot, exp, des), "rows": (rows.start, rows.stop),
                "success": bits(res.success), "witness": bits(res.witness),
                "round": bits(res.round), "attempts": bits(res.attempts),
                "rounds": int(res.rounds), "words": list(self.words),
                "logical": logical(),
                "versions": bits(dsb.versions(dspec, st))})
        return out


def _insertion(tree, prefix=()):
    """(path, leaf) in insertion order (the order `tree_leaves` takes)."""
    if isinstance(tree, dict):
        for key, v in tree.items():
            yield from _insertion(v, prefix + (key,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _insertion(v, prefix + (i,))
    else:
        yield prefix, tree


def rank_main(job, inputs, out_dir, rank, world, port, pg_timeout):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=pg_timeout))
    cases = pickle.loads(Path(inputs).read_bytes())
    r = _Rank(pg_timeout)
    if job == "hang":
        _plant_hang(r, rank)
    if job == "skip_len":
        _plant_skipped_len(rank)
    if job == "issue_error":
        return _issue_error(r, cases[0], rank)
    out = {}
    for case in cases:
        if case.get("world", True):
            t0 = time.perf_counter()
            out[case["name"]] = getattr(r, case["kind"])(case)
            print(f"[rank {rank}] {case['name']}: "
                  f"{time.perf_counter() - t0:.2f} s", flush=True)
    (Path(out_dir) / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
    if job == "skip_len" and rank == 1:
        time.sleep(3600)          # stay in the world, as a stuck rank would
    dist.destroy_process_group()


def _plant_hang(r: _Rank, rank: int) -> None:
    """Rank 1 leaves `mcas`'s loop after its first round and never calls
    another collective: every other rank must fail at its next one."""
    if rank != 1:
        return
    dist = r.dist
    reduce = dist.all_reduce
    calls = []

    def leave(*args, **kw):
        calls.append(1)
        if len(calls) > 1:
            time.sleep(3600)
        return reduce(*args, **kw)
    dist.all_reduce = leave


def _issue_error(r: _Rank, case, rank: int) -> None:
    """Rank 1's second `apply_global` raises inside a `DistTarget` issue,
    past the issue's agreement (as an error in the collectives would):
    its executor must not roll the batch back alone but end, and rank 1
    then stays in the world, as a stuck rank would.  Every other rank
    must fail at the collective rank 1 never joins."""
    dsb = r.dsb
    if rank == 1:
        apply_global, calls = dsb.apply_global, []

        def failing(*a, **kw):
            calls.append(1)
            if len(calls) == 2:
                raise RuntimeError("planted: an error inside the round")
            return apply_global(*a, **kw)
        dsb.apply_global = failing
        try:
            r.executor(case)
        except RuntimeError as err:
            print(f"rank 1 ended its run: {err}", flush=True)
            time.sleep(3600)
        raise SystemExit("rank 1's executor went on past the error")
    r.executor(case)


def _plant_skipped_len(rank: int) -> None:
    """Rank 1's sharded queues answer `len()` with 0, skipping the routed
    LOAD: every other rank must fail at the collective rank 1 never
    joins."""
    if rank != 1:
        return
    from repro_torch.sync.queue import BigQueue
    counted = BigQueue.__len__
    BigQueue.__len__ = lambda self: 0 if self._mesh is not None \
        else counted(self)


# ---------------------------------------------------------------------------
# The reference's run (one process, 8 fake XLA host devices).
# ---------------------------------------------------------------------------

def ref_main(job, inputs, out_path):
    import jax
    from jax.experimental.pallas import tpu as pltpu
    if not hasattr(pltpu, "TPUMemorySpace"):   # renamed in newer jax
        pltpu.TPUMemorySpace = pltpu.MemorySpace
    from repro import atomics
    from repro.core import cachehash as ch
    from repro.core import distributed as dsb
    from repro.sync.queue import BackoffPolicy

    global_view = ref_global_view
    cases = pickle.loads(Path(inputs).read_bytes())
    out = {}
    for case in cases:
        if not case.get("ref"):
            continue
        if case["kind"] == "serving":
            out[case["name"]] = ref_serving(case)
            continue
        if case["kind"] in REF_RUNTIME:
            out[case["name"]] = REF_RUNTIME[case["kind"]](case)
            continue
        mesh = jax.make_mesh(tuple(case["mesh"][0]), tuple(case["mesh"][1]))
        dspec = make_dspec(atomics, dsb, case)
        rec = {"steps": []}
        if case["kind"] == "table":
            k = dspec.inner.k
            st = dsb.init_dist(mesh, dspec, case["init"])
            rec["init"] = [bits(x) for x in st.local]      # stacked leaves
            ctx = dsb.init_dist_ctx(mesh, dspec)
            for kind, slot, exp, des in case["batches"]:
                st, ctx, res, ovf = dsb.apply(
                    mesh, dspec, st,
                    atomics.make_ops(kind, slot, exp, des, k=k), ctx)
                lg, ver = global_view(dspec, st)
                rec["steps"].append({
                    "value": bits(res.value), "success": bits(res.success),
                    "overflow": bits(ovf), "ctx": [bits(x) for x in ctx],
                    "logical": lg, "versions": ver})
        elif case["kind"] == "hash":
            st = dsb.init_dist(mesh, dspec)
            for kind, key, val in case["batches"]:
                st, res, ovf = dsb.apply_hash(
                    mesh, dspec, st,
                    ch.make_hash_ops(kind, key, val, vw=dspec.inner.vw))
                items = dsb.hash_items(dspec, st)
                keys = np.asarray(sorted(items), np.uint32)
                rec["steps"].append({
                    "found": bits(res.found), "value": bits(res.value),
                    "walk_over": bits(res.overflow), "overflow": bits(ovf),
                    "keys": keys, "values": np.asarray(
                        [bits(items[x]) for x in keys.tolist()],
                        np.uint32).reshape(-1, dspec.inner.vw)})
        else:
            st = dsb.init_dist(mesh, dspec, case["init"])
            policy = BackoffPolicy(*case["mcas"]["policy"])

            def logical():
                return global_view(dspec, st)[0]
            for slot, exp, des in txn_steps(case, logical):
                txns = atomics.make_txns(slot, exp, des, k=dspec.inner.k)
                st, res = dsb.mcas(mesh, dspec, st, txns, policy=policy)
                lg, ver = global_view(dspec, st)
                rec["steps"].append({
                    "txns": (slot, exp, des),
                    "success": bits(res.success),
                    "witness": bits(res.witness), "round": bits(res.round),
                    "attempts": bits(res.attempts),
                    "rounds": int(res.rounds), "logical": lg,
                    "versions": ver})
        out[case["name"]] = rec
    Path(out_path).write_bytes(pickle.dumps(out))


def ref_global_view(dspec, st):
    """The reference's (logical, versions), de-sharded in numpy from the
    stacked leaves where its own helpers cannot reshape (interleaved and
    two-level states on jax 0.9)."""
    import jax
    import jax.numpy as jnp
    from repro.core import distributed as dsb
    from repro.core import registry
    if not dspec.interleave and dspec.n_nodes == 1:
        return (bits(dsb.logical(dspec, st)),
                bits(dsb.versions(dspec, st)))
    impl = registry.get_strategy(dspec.inner.strategy)
    leaves = jax.tree.map(np.asarray, st.local)
    vals = np.stack([bits(impl.logical(jax.tree.map(
        lambda x, i=i: jnp.asarray(x[i]), leaves)))
        for i in range(dspec.n_shards)])
    ver = bits(leaves.version)
    if dspec.interleave:
        vals, ver = np.swapaxes(vals, 0, 1), np.swapaxes(ver, 0, 1)
    return vals.reshape(dspec.n_global, -1), ver.reshape(-1)


def ref_serving(case) -> dict:
    """The reference's one-device `ServingEngine` on the case's config and
    requests, on the weights its own `init_params` draws.  Those weights
    (numpy, in the params' tree) go to `serve["params"]` before the
    engine runs; the port's ranks wait for them there."""
    import dataclasses

    import jax
    from repro.configs import get_config
    from repro.core import cachehash as ch
    from repro.models.transformer import init_params
    from repro.serving import Request, ServingEngine
    sv = case["serve"]
    cfg = dataclasses.replace(get_config(sv["arch"], reduced=True),
                              **sv["cfg"])
    params = init_params(cfg, jax.random.PRNGKey(sv["seed"]))
    tmp = Path(sv["params"] + ".part")
    tmp.write_bytes(pickle.dumps(jax.tree.map(np.asarray, params)))
    os.replace(tmp, sv["params"])
    eng = ServingEngine(cfg, params, **sv["engine"])
    for rid, prompt in enumerate(sv["prompts"]):
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=sv["new"]))
    tokens = eng.run_to_completion(max_steps=40)
    items = ch.items(eng.paged.state.table, inline=True, vw=1)
    return {"tokens": {int(r): [int(x) for x in v]
                       for r, v in tokens.items()},
            "dispatch_count": int(eng.dispatch_count),
            "free": len(eng.paged.free),
            "items": {int(x): bits(v) for x, v in items.items()}}


def ref_executor(case) -> dict:
    """The reference's `DistTarget` executor on the case (8 fake devices,
    the mesh (s, 8 // s) ("shard", "rest") or (2, 4) ("node", "shard"))."""
    import jax
    from repro import atomics
    from repro import runtime as rt
    from repro.core import distributed as dsb
    from repro.obs import Recorder
    n, k = case["n"], case["k"]
    inner = atomics.AtomicSpec(n, k, case["strategy"], p_max=64)
    if case.get("two_level"):
        mesh = jax.make_mesh((2, 4), ("node", "shard"))
        dspec = dsb.DistSpec(inner, "shard", 8, case["p_global"] // 8,
                             n_nodes=2, node_axis="node")
        factory = None
    else:
        def factory(n_surviving):
            s = 1
            while s * 2 <= n_surviving and n % (s * 2) == 0:
                s *= 2
            return (jax.make_mesh((s, 8 // s), ("shard", "rest")),
                    dsb.DistSpec(inner, "shard", s, case["p_global"] // s))
        mesh, dspec = factory(8)
    target = rt.DistTarget(mesh, dspec, case["init"], mesh_factory=factory)
    ex = run_executor(rt, Recorder, case, target)
    rep = ex.run()
    return executor_record(ex, rep, *ref_global_view(target.dspec,
                                                     target.state))


def ref_elastic(case) -> dict:
    """The reference's `elastic` scenario table on the case: the same
    records as `_Rank.elastic`."""
    import jax
    from jax.sharding import Mesh
    from repro import atomics
    from repro.core import distributed as dsb
    from repro.runtime import reshard_dist
    n, k = case["n"], case["k"]

    def geo(s):
        mesh = Mesh(np.asarray(jax.devices()[:s]), ("shard",))
        return mesh, dsb.DistSpec(
            atomics.AtomicSpec(n, k, case["strategy"], p_max=64), "shard", s,
            8)
    mesh, dspec = geo(8)
    st = dsb.init_dist(mesh, dspec, case["init"])
    ctx = dsb.init_dist_ctx(mesh, dspec)
    p = dspec.p_global
    kind = np.full(p, atomics.IDLE, np.int32)
    slot = np.zeros(p, np.int32)
    desired = np.zeros((p, k), np.uint32)
    kind[0], slot[0] = atomics.LL, 5
    kind[1], slot[1], desired[1] = atomics.STORE, 7, 77
    st, ctx, _, _ = dsb.apply(mesh, dspec, st, atomics.make_ops(
        kind, slot, desired=desired, k=k), ctx)
    out = {"hops": []}
    for s in case["hops"]:
        mesh2, dspec2 = geo(s)
        st = reshard_dist(dspec, st, dspec2, mesh2)
        mesh, dspec = mesh2, dspec2
        out["hops"].append({"s": s,
                            "logical": bits(dsb.logical(dspec, st)),
                            "versions": bits(dsb.versions(dspec, st))})
    kind = np.full(p, atomics.IDLE, np.int32)
    kind[0], slot[0], desired[0] = atomics.SC, 5, 55
    st, ctx, res, _ = dsb.apply(mesh, dspec, st, atomics.make_ops(
        kind, slot, desired=desired, k=k), ctx)
    out["sc_success"] = bool(np.asarray(res.success)[0])
    out["logical_after"] = bits(dsb.logical(dspec, st))
    return out


def ref_train_elastic(case) -> dict:
    """The reference's placements (`dist.param_shardings` over
    `elastic_mesh(n, model_parallel=2, global_batch=2)`) of its own
    deepseek_7b reduced params, per hop, with each leaf's shape."""
    from repro import dist
    from repro.configs import get_config
    from repro.launch.steps import init_train_state
    from repro.optim import AdamWConfig
    from repro.runtime import elastic_mesh
    cfg = get_config("deepseek_7b", reduced=True)
    params, _ = init_train_state(cfg, AdamWConfig(warmup=1, total_steps=2),
                                 0)
    out = {"shapes": {path: tuple(x.shape) for path, x in walk(params)},
           "hops": []}
    for n_dev in case["hops"]:
        mesh = elastic_mesh(n_dev, model_parallel=2, global_batch=2)
        sh = dist.param_shardings(params, cfg, mesh,
                                  dist.make_rules(cfg, mesh))
        out["hops"].append({
            "n": n_dev, "shape": tuple(mesh.devices.shape),
            "placements": {path: tuple(x.spec) for path, x in walk(sh)}})
    return out


def ref_train(case) -> dict:
    """The reference's live sharded step on the case's config: its own
    initial params and an AdamW state as after 5 steps (written to
    `state` first, for the port's ranks), then `jax.jit(make_train_step)`
    under `dist.axis_rules` on each of `meshes` (auto axes: `Mesh` over
    the devices reshaped, as `elastic_mesh` builds it), `steps` steps of
    `synthetic_batch` placed by `batch_shardings`: losses, grad norms and
    the final params and moments, per mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro import dist
    from repro.configs import get_config
    from repro.configs.shapes import Shape
    from repro.data import synthetic_batch
    from repro.launch.steps import make_train_step
    from repro.models.transformer import init_params
    from repro.optim import AdamWConfig, adamw_init
    from repro.runtime import reshard_state
    cfg = train_config(get_config, case["arch"], {})
    opt = AdamWConfig(**TRAIN_OPT)
    params = init_params(cfg, jax.random.PRNGKey(case["seed"]))
    state = moment_state(adamw_init(params, opt), case["seed"],
                         jnp.zeros_like,
                         lambda a, like: jnp.asarray(a, like.dtype))
    tmp = Path(case["state"] + ".part")
    tmp.write_bytes(pickle.dumps({
        "params": jax.tree.map(np.asarray, params),
        "opt": jax.tree.map(np.asarray, state)}))
    os.replace(tmp, case["state"])
    t, b = TRAIN_SHAPE
    shape = Shape("train", t, b, "train")
    out = {}
    for mshape in case["meshes"]:
        mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(mshape),
                    ("data", "model"))
        rules = dist.make_rules(cfg, mesh)
        p, s = reshard_state((params, state), cfg, mesh)
        rec = {"loss": [], "grad_norm": []}
        with dist.axis_rules(mesh, rules):
            step = jax.jit(make_train_step(cfg, opt))
            for i in range(case["steps"]):
                batch = synthetic_batch(cfg, shape, seed=TRAIN_DATA_SEED,
                                        step=i)
                p, s, m = step(p, s, jax.device_put(
                    batch, dist.batch_shardings(batch, mesh, rules)))
                rec["loss"].append(float(m["loss"]))
                rec["grad_norm"].append(float(m["grad_norm"]))
        rec["final"] = {path: bits(np.asarray(x)) for path, x in
                        walk((p, s))}
        out[tuple(mshape)] = rec
    return out


def ref_train_specs(case) -> dict:
    """The reference's `dist._spec` of each (shape, names) in `specs` and
    `batch_shardings` of `batch` (shapes) on each mesh of `meshes`
    ((shape, axes) over the first devices), with each device's slice of
    every dim as (start, length), by the device's mesh coordinate."""
    import jax
    from jax.sharding import Mesh, NamedSharding
    from repro import dist
    out = {}
    for mshape, axes in case["meshes"]:
        n = int(np.prod(mshape))
        devs = np.asarray(jax.devices()[:n]).reshape(mshape)
        mesh = Mesh(devs, axes)
        rules = dist.make_rules(None, mesh)
        coords = {d.id: c for c, d in np.ndenumerate(devs)}
        specs = {}
        for shape, names in case["specs"]:
            spec = dist._spec(shape, names, mesh, rules)
            idx = NamedSharding(mesh, spec).devices_indices_map(tuple(shape))
            specs[(tuple(shape), tuple(names))] = (tuple(spec), {
                coords[d.id]: tuple((sl.start or 0, (sl.stop or dim)
                                     - (sl.start or 0))
                                    for sl, dim in zip(ix, shape))
                for d, ix in idx.items()})
        batch = {k: jax.ShapeDtypeStruct(v, np.int32)
                 for k, v in case["batch"].items()}
        out[(tuple(mshape), tuple(axes))] = {
            "specs": specs, "batch": {k: tuple(v.spec) for k, v in
                                      dist.batch_shardings(batch, mesh,
                                                           rules).items()}}
    return out


REF_RUNTIME = {"executor": ref_executor, "elastic": ref_elastic,
               "train_elastic": ref_train_elastic, "train_ref": ref_train,
               "train_specs": ref_train_specs}


if __name__ == "__main__":
    if sys.argv[1] == "rank":
        job, inputs, out_dir = sys.argv[2:5]
        rank, world, port = (int(x) for x in sys.argv[5:8])
        rank_main(job, inputs, out_dir, rank, world, port,
                  float(sys.argv[8]))
    else:
        ref_main(*sys.argv[2:5])
