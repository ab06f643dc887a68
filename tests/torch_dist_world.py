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
                    "txnmap" | "queue" | "serving"
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
  ref               also run on the reference
"""

from __future__ import annotations

import datetime
import os
import pickle
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
    out = {case["name"]: getattr(r, case["kind"])(case) for case in cases}
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
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    if not hasattr(pltpu, "TPUMemorySpace"):   # renamed in newer jax
        pltpu.TPUMemorySpace = pltpu.MemorySpace
    from repro import atomics
    from repro.core import cachehash as ch
    from repro.core import distributed as dsb
    from repro.core import registry
    from repro.sync.queue import BackoffPolicy

    def global_view(dspec, st):
        """(logical, versions) de-sharded in numpy from the stacked
        leaves where the reference's own helpers cannot reshape."""
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

    cases = pickle.loads(Path(inputs).read_bytes())
    out = {}
    for case in cases:
        if not case.get("ref"):
            continue
        if case["kind"] == "serving":
            out[case["name"]] = ref_serving(case)
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


if __name__ == "__main__":
    if sys.argv[1] == "rank":
        job, inputs, out_dir = sys.argv[2:5]
        rank, world, port = (int(x) for x in sys.argv[5:8])
        rank_main(job, inputs, out_dir, rank, world, port,
                  float(sys.argv[8]))
    else:
        ref_main(*sys.argv[2:5])
