"""The port's paged-KV server (`repro_torch.serving`: `paged_kv` over the
CacheHash page table, the BigQueue rings and the transactional map;
`ServingEngine`) against the JAX reference.

Each scenario of tests/test_serving.py (the pipelined one through the
port's `runtime.Executor`) is written once against a small adapter (`_Pkg`) and
run twice: in one subprocess on the reference (with the jax alias its
Pallas modules need, 4 threads: its time is XLA compiles), which also
saves the weights its `init_params` drew; then in this process on the
port, on those weights converted (`convert.model_params`), on the CPU.
Every array a scenario returns must be equal: the greedy tokens of the
paged engine and of the dense path (`make_prefill_step` +
`make_serve_step`), `dispatch_count`, the free-page count, the free ring's
table and the page table's contents after the run, `lookup_pages`
results, the verdict of a failed admission and the verdicts of
`OverloadPolicy`.

In process: the host reads of a decode step pinned (every way a tensor
reaches the host counted), the greedy rule on ties and the seeded
sampler.  The mesh-sharded engine: tests/test_torch_distributed_serving.py."""

import dataclasses
import os
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_models import flatten, unflatten
from torch_threads import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def bits(x) -> np.ndarray:
    """A result as numpy; 32-bit integers as their uint32 bits."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype in (np.int32, np.uint32) else x


class _Pkg:
    """One package's entry points, as the scenarios call them.  The port's
    `params` are the reference's, read from its saved run."""

    def __init__(self, which: str, reference: dict | None = None):
        self.which = which
        self.saved: dict = {}
        if which == "ref":
            import jax
            import jax.numpy as jnp
            from repro.configs import get_config
            from repro.core import cachehash
            from repro.launch import steps
            from repro.models import transformer
            from repro.serving import OverloadPolicy, Request, ServingEngine
            from repro.serving import paged_kv
            self._jax, self.jnp = jax, jnp
            self.kw = {}
        else:
            from repro_torch.configs import get_config
            from repro_torch.core import cachehash
            from repro_torch.launch import steps
            from repro_torch.models import transformer
            from repro_torch.serving import (OverloadPolicy, Request,
                                             ServingEngine)
            from repro_torch.serving import paged_kv
            self.reference = reference
            self.kw = {"device": "cpu"}
        self.get_config, self.steps, self.tm = get_config, steps, transformer
        self.Request, self.Engine, self.pk = Request, ServingEngine, paged_kv
        self.Overload = OverloadPolicy
        self.ch = cachehash

    def cfg(self):
        return dataclasses.replace(
            self.get_config("deepseek_7b", reduced=True),
            param_dtype="float32", compute_dtype="float32")

    def params(self, name: str, cfg, key: int):
        if self.which == "ref":
            p = self.tm.init_params(cfg, self._jax.random.PRNGKey(key))
            self.saved.update({f"{name}|{k}": v
                               for k, v in flatten(p).items()})
            return p
        prefix = f"{name}|"
        return unflatten({k[len(prefix):]: v for k, v in
                          self.reference.items() if k.startswith(prefix)
                          and k[len(prefix):].startswith("params")})

    def array(self, x):
        return (self.jnp.asarray(x) if self.which == "ref"
                else torch.from_numpy(np.array(x)))

    def argmax(self, x) -> int:
        return int(self.jnp.argmax(x) if self.which == "ref"
                   else torch.argmax(x))

    def engine(self, cfg, params, **kw):
        return self.Engine(cfg, params, **kw, **self.kw)

    def dense_greedy(self, cfg, params, prompt, n_new):
        """The dense slot-cache path: prefill, then greedy decode steps."""
        T = len(prompt)
        prefill = self.steps.make_prefill_step(cfg, max_len=T + n_new)
        serve = self.steps.make_serve_step(cfg)
        if self.which == "ref":
            serve = self._jax.jit(serve)
        logits, cache = prefill(params, {"tokens": self.array(prompt[None])})
        toks = [self.argmax(logits[0, -1])]
        for d in range(n_new - 1):
            batch = {"tokens": self.array(np.asarray([[toks[-1]]], np.int32)),
                     "pos": self.array(np.asarray([T + d], np.int32))}
            logits, cache = serve(params, cache, batch)
            toks.append(self.argmax(logits[0, 0]))
        return toks

    def record_engine(self, out, key, eng):
        """The engine's page pool and tables after a run."""
        out[f"{key}/dispatch"] = np.asarray(eng.dispatch_count)
        out[f"{key}/free"] = np.asarray(len(eng.paged.free))
        out[f"{key}/free_ring"] = bits(eng.paged.free.state.data)
        out[f"{key}/slot_ring"] = bits(eng.slot_q.state.data)
        self.record_table(out, key, eng.paged)

    def record_table(self, out, key, paged):
        items = self.ch.items(paged.state.table, inline=True, vw=1)
        keys = sorted(items)
        out[f"{key}/table_keys"] = np.asarray(keys, np.uint32)
        out[f"{key}/table_values"] = np.asarray(
            [np.asarray(items[k]).reshape(-1)[0] for k in keys], np.uint32)


def tokens(out, key, stream):
    out[key] = np.asarray(stream, np.int64)


def scenario_dense_match(P):
    """test_paged_engine_matches_dense_path."""
    cfg = P.cfg()
    params = P.params("dense_match", cfg, 0)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, 20).astype(
        np.int32)
    out = {}
    tokens(out, "dense", P.dense_greedy(cfg, params, prompt, 6))
    eng = P.engine(cfg, params, max_batch=2, n_pages=32, page_size=8,
                   max_pages_per_seq=8)
    eng.submit(P.Request(rid=0, prompt=prompt, max_new_tokens=6))
    tokens(out, "paged", eng.run_to_completion()[0])
    P.record_engine(out, "engine", eng)
    return out


def scenario_two_concurrent(P):
    """test_two_concurrent_requests_and_retirement."""
    cfg = P.cfg()
    params = P.params("two_concurrent", cfg, 1)
    rng = np.random.default_rng(1)
    p1 = rng.integers(0, cfg.vocab, 12).astype(np.int32)
    p2 = rng.integers(0, cfg.vocab, 17).astype(np.int32)
    out = {}
    tokens(out, "dense1", P.dense_greedy(cfg, params, p1, 3))
    tokens(out, "dense2", P.dense_greedy(cfg, params, p2, 8))
    eng = P.engine(cfg, params, max_batch=2, n_pages=24, page_size=8,
                   max_pages_per_seq=8)
    out["free0"] = np.asarray(len(eng.paged.free))
    eng.submit(P.Request(rid=1, prompt=p1, max_new_tokens=3))
    eng.submit(P.Request(rid=2, prompt=p2, max_new_tokens=8))
    got = eng.run_to_completion()
    tokens(out, "paged1", got[1])
    tokens(out, "paged2", got[2])
    P.record_engine(out, "engine", eng)
    return out


def scenario_pool_exhaustion(P):
    """test_page_pool_exhaustion_raises."""
    cfg = P.cfg()
    params = P.params("pool_exhaustion", cfg, 0)
    eng = P.engine(cfg, params, max_batch=1, n_pages=2, page_size=8,
                   max_pages_per_seq=4)
    eng.submit(P.Request(rid=0, prompt=np.zeros(40, np.int32),
                         max_new_tokens=2))
    with pytest.raises(RuntimeError, match="out of KV pages") as err:
        eng.step()
    out = {"message": np.asarray(str(err.value)),
           "slot_q": np.asarray(len(eng.slot_q)),
           "admit_q": np.asarray(len(eng.admit_q))}
    P.record_engine(out, "engine", eng)
    return out


def scenario_lookup(P):
    """test_page_table_lookup_consistency."""
    cfg = P.cfg()
    paged = P.pk.init_paged(cfg, n_pages=16, page_size=4, max_seqs=4,
                            **P.kw)
    paged, phys = P.pk.alloc_pages(paged, [7, 7, 9], [0, 1, 0])
    out = {"phys": bits(phys)}
    paged, got = P.pk.lookup_pages(paged, [7, 9], 3)
    out["lookup0"] = bits(got)
    paged = P.pk.free_pages(paged, 7, 2)
    paged, got = P.pk.lookup_pages(paged, [7], 2)
    out["lookup1"] = bits(got)
    out["free"] = np.asarray(len(paged.free))
    out["free_ring"] = bits(paged.free.state.data)
    P.record_table(out, "paged", paged)
    return out


def scenario_txn_bookkeeping(P):
    """test_txn_bookkeeping_keeps_one_dispatch_and_tokens: the engine with
    and without the transactional bookkeeping."""
    cfg = P.cfg()
    params = P.params("txn_bookkeeping", cfg, 2)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, 11).astype(np.int32),
               rng.integers(0, cfg.vocab, 6).astype(np.int32)]
    out = {}
    for txn in (True, False):
        eng = P.engine(cfg, params, max_batch=2, n_pages=24, page_size=4,
                       max_pages_per_seq=8, txn_bookkeeping=txn)
        out[f"{txn}/free0"] = np.asarray(len(eng.paged.free))
        for rid, p in enumerate(prompts):
            eng.submit(P.Request(rid=rid, prompt=p, max_new_tokens=5))
        got = eng.run_to_completion()
        for rid in got:
            tokens(out, f"{txn}/paged{rid}", got[rid])
        out[f"{txn}/pending_retire"] = np.asarray(len(eng._pending_retire))
        P.record_engine(out, f"{txn}/engine", eng)
    return out


def scenario_frees_before_admission(P):
    """test_txn_bookkeeping_frees_pages_before_admission."""
    cfg = P.cfg()
    params = P.params("frees_before_admission", cfg, 3)
    rng = np.random.default_rng(3)
    eng = P.engine(cfg, params, max_batch=1, n_pages=4, page_size=4,
                   max_pages_per_seq=4)
    out = {"free0": np.asarray(len(eng.paged.free))}
    for rid in range(2):
        eng.submit(P.Request(rid=rid, prompt=rng.integers(
            0, cfg.vocab, 11).astype(np.int32), max_new_tokens=2))
    got = eng.run_to_completion()
    for rid in got:
        tokens(out, f"paged{rid}", got[rid])
    P.record_engine(out, "engine", eng)
    return out


def scenario_failed_admission(P):
    """test_failed_admission_leaks_nothing."""
    cfg = P.cfg()
    params = P.params("failed_admission", cfg, 0)
    eng = P.engine(cfg, params, max_batch=2, n_pages=2, page_size=8,
                   max_pages_per_seq=4)
    eng.submit(P.Request(rid=0, prompt=np.zeros(40, np.int32),
                         max_new_tokens=2))
    eng.submit(P.Request(rid=1, prompt=np.zeros(4, np.int32),
                         max_new_tokens=2))
    with pytest.raises(RuntimeError, match="out of KV pages"):
        eng.step()
    out = {"slot_q": np.asarray(len(eng.slot_q)),
           "admit_q": np.asarray(len(eng.admit_q))}
    got = eng.run_to_completion()
    tokens(out, "paged1", got[1])
    P.record_engine(out, "engine", eng)
    return out


def scenario_overload(P):
    """`OverloadPolicy`: with the one decode slot busy, submissions at or
    past the watermark are admitted until the admission ring is full
    (then shed: queue full) or the streak exceeds `patience` (then shed:
    sustained overload); the admitted requests still complete."""
    cfg = P.cfg()
    params = P.params("overload", cfg, 4)
    eng = P.engine(cfg, params, max_batch=1, n_pages=16, page_size=8,
                   max_pages_per_seq=4, max_queue=4,
                   overload=P.Overload(watermark=0.5, patience=3))
    prompts = np.random.default_rng(4).integers(0, cfg.vocab, (7, 5))
    verdicts = []
    for rid, prompt in enumerate(prompts.astype(np.int32)):
        v = eng.submit(P.Request(rid=rid, prompt=prompt, max_new_tokens=4))
        verdicts.append(f"{type(v).__name__} {v.rid} {v.queue_depth} "
                        + (f"{v.reason} {v.free_slots}"
                           if type(v).__name__ == "Shed" else ""))
        if rid == 0:
            eng.step()                  # request 0 takes the only slot
    out = {"verdicts": np.asarray(verdicts),
           "shed_count": np.asarray(eng.shed_count)}
    got = eng.run_to_completion()
    for rid in sorted(got):
        tokens(out, f"paged{rid}", got[rid])
    P.record_engine(out, "engine", eng)
    return out


def scenario_pipelined(P):
    """test_pipelined_engine_matches_run_to_completion: the executor-driven
    loop (`run_pipelined`, admission and decode as two streams) against
    the sequential one on fresh engines over the same requests."""
    cfg = P.cfg()
    params = P.params("pipelined", cfg, 4)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, t).astype(np.int32)
               for t in (13, 7, 5)]

    def fresh():
        eng = P.engine(cfg, params, max_batch=2, n_pages=24, page_size=4,
                       max_pages_per_seq=8)
        for rid, p in enumerate(prompts):
            eng.submit(P.Request(rid=rid, prompt=p, max_new_tokens=4 + rid))
        return eng

    a = fresh()
    want = a.run_to_completion()
    b = fresh()
    free0 = len(b.paged.free)
    got = b.run_pipelined()
    out = {"dispatch_sequential": np.asarray(a.dispatch_count),
           "free_change": np.asarray(len(b.paged.free) - free0),
           "pending_retire": np.asarray(len(b._pending_retire))}
    for rid in sorted(want):
        tokens(out, f"sequential{rid}", want[rid])
        tokens(out, f"pipelined{rid}", got[rid])
    P.record_engine(out, "engine", b)
    return out


SCENARIOS = {
    "dense_match": (scenario_dense_match, ()),
    "two_concurrent": (scenario_two_concurrent, ()),
    "pool_exhaustion": (scenario_pool_exhaustion, ()),
    "lookup": (scenario_lookup, ()),
    "txn_bookkeeping": (scenario_txn_bookkeeping, ()),
    "frees_before_admission": (scenario_frees_before_admission, ()),
    "failed_admission": (scenario_failed_admission, ()),
    "overload": (scenario_overload, ()),
    "pipelined": (scenario_pipelined, ()),
}


def run_reference(workers: int = 4) -> dict:
    """Every scenario on the reference: {"name|key": array}, its weights
    under "name|params/...".  The scenarios share nothing, so threads may
    run them at once."""
    P = _Pkg("ref")

    def run(item):
        name, (fn, args) = item
        return name, fn(P, *args)

    with ThreadPoolExecutor(workers) as pool:
        runs = list(pool.map(run, SCENARIOS.items()))
    out = dict(P.saved)
    out.update({f"{name}|{key}": value for name, res in runs
                for key, value in res.items()})
    return out


_REFERENCE_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    from jax.experimental.pallas import tpu as pltpu
    if not hasattr(pltpu, "TPUMemorySpace"):   # renamed in newer jax
        pltpu.TPUMemorySpace = pltpu.MemorySpace
    import test_torch_serving
    np.savez(sys.argv[1], **test_torch_serving.run_reference())
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("serving_ref") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT / 'tests'}")
    env.pop("BIGATOMIC_OBS", None)
    proc = subprocess.run([sys.executable, "-c", _REFERENCE_SCRIPT,
                           str(path)], env=env, capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(path))


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_reference(name, reference, monkeypatch):
    monkeypatch.delenv("BIGATOMIC_OBS", raising=False)
    fn, args = SCENARIOS[name]
    got = fn(_Pkg("port", reference), *args)
    want = {key.split("|", 1)[1]: v for key, v in reference.items()
            if key.split("|", 1)[0] == name
            and not key.split("|", 1)[1].startswith("params")}
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), want[key],
                                      err_msg=f"{name}: {key}")
    for key in got:                       # the reference test's own checks
        if key.startswith("paged") and f"dense{key[5:]}" in got:
            np.testing.assert_array_equal(got[key], got[f"dense{key[5:]}"])
        if key.startswith("pipelined"):
            np.testing.assert_array_equal(got[key],
                                          got[f"sequential{key[9:]}"])
    if name == "pipelined":
        # decoupling may cost at most one extra fused step per admission
        # wave, never fewer; every page recycled
        seq = int(got["dispatch_sequential"])
        assert seq <= int(got["engine/dispatch"]) <= seq + 2
        assert int(got["free_change"]) == 0
        assert int(got["pending_retire"]) == 0


# ---------------------------------------------------------------------------
# In process: host reads per decode step, sampling, stubs.
# ---------------------------------------------------------------------------

HOST_READS = ("__bool__", "__int__", "__index__", "__float__", "item",
              "tolist", "numpy")


def _in_plain_replay() -> bool:
    """True when called under `slow_round_plain`: the slow round's plain
    version reads its round count back, where its CUDA kernel, which the
    card runs in its place, reads nothing."""
    frame = sys._getframe(2)
    while frame is not None:
        if frame.f_code.co_name == "slow_round_plain":
            return True
        frame = frame.f_back
    return False


@pytest.fixture
def count_host_reads(monkeypatch):
    """Counts every way a tensor's value reaches the host (on a card each
    is one device-to-host copy and sync), but for the plain replay's."""
    counter = {"n": 0}
    for name in HOST_READS:
        orig = getattr(torch.Tensor, name)

        def wrapped(self, *a, _orig=orig, **kw):
            if not _in_plain_replay():
                counter["n"] += 1
            return _orig(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, wrapped)
    return counter


def _engine(**kw):
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import ServingEngine
    cfg = dataclasses.replace(get_config("deepseek_7b", reduced=True),
                              param_dtype="float32", compute_dtype="float32")
    params = init_params(cfg, seed=0, device="cpu")
    return ServingEngine(cfg, params, max_batch=2, n_pages=16, page_size=4,
                         max_pages_per_seq=4, device="cpu", **kw)


# Host reads of one decode step (ROADMAP Queue 1 item 6), one live
# sequence, no admission and no retirement pending:
#   no crossing:  2 admission checks (len of the admission and slot rings)
#                 + 1 page-table FIND (`apply_hash`) + 1 greedy sample = 4
#   a crossing:   those 4, + 1 free-ring length, + one LL/SC dequeue round
#                 (3 `apply` kind checks + 3 reads) = 6, + one
#                 transaction round (3 `apply_hash` + 1 loop test) = 4:
#                 15
DECODE_HOST_READS = {"no_crossing": 4, "crossing": 15}


@pytest.mark.parametrize("fused", [True, False])
def test_decode_step_host_reads_are_pinned(fused, count_host_reads):
    """A decode step's host reads, counted with every tensor-to-host read
    patched: 4 without a page-boundary crossing, 15 with one
    (`DECODE_HOST_READS`), fused or not; `dispatch_count` keeps the
    reference's meaning (1 per fused step, 4 per unfused)."""
    from repro_torch.serving import Request
    eng = _engine(fused=fused)
    eng.submit(Request(rid=0, prompt=np.arange(6, dtype=np.int32),
                       max_new_tokens=8))
    eng.step()                                  # admission + decode at 6
    per_step = 1 if fused else 4
    assert eng.dispatch_count == per_step
    for what, pos in (("no_crossing", 7), ("crossing", 8)):
        assert eng.slots[0].pos == pos
        count_host_reads["n"] = 0
        assert eng.step() == 1
        assert count_host_reads["n"] == DECODE_HOST_READS[what], what
    assert eng.dispatch_count == 3 * per_step


def test_greedy_sampling_takes_the_first_of_ties():
    eng = _engine()
    from repro_torch.serving import Request
    eng.requests[0] = Request(rid=0, prompt=np.zeros(1, np.int32))
    logits = torch.tensor([[0.0, 2.0, 2.0, 1.0], [3.0, 3.0, 3.0, 3.0]])
    assert eng._sample(logits).tolist() == [1, 0]


def test_temperature_sampling_draws_from_the_seeded_generator():
    """Temperature > 0: Gumbel-max draws from a generator seeded with the
    engine's `seed` (the same seed, the same tokens; not jax.random's)."""
    from repro_torch.serving import Request
    draws = []
    for seed in (7, 7, 8):
        eng = _engine(seed=seed)
        eng.requests[0] = Request(rid=0, prompt=np.zeros(1, np.int32),
                                  temperature=1.0)
        logits = torch.zeros((64, 50))
        draws.append(np.concatenate([eng._sample(logits) for _ in range(4)]))
    np.testing.assert_array_equal(draws[0], draws[1])
    assert (draws[0] != draws[2]).any()
    assert len(np.unique(draws[0])) > 20            # spread over the vocab


def test_run_pipelined_serves_requests_waiting_when_every_slot_retires():
    """Every slot retires in one step while requests wait: the admission
    stream stays not done until its commit lands, so the waiting requests
    are decoded to the end, as `run_to_completion` decodes them.  (The
    reference's `run_pipelined` stops with them at their first token:
    ROADMAP.md, Queue 3.)"""
    from repro_torch.serving import Request
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 64, t).astype(np.int32) for t in (5, 6, 7, 8)]

    def fresh():
        eng = _engine()
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=p, max_new_tokens=3))
        return eng

    want = fresh().run_to_completion()
    eng = fresh()
    assert eng.run_pipelined() == want
    assert all(len(toks) == 3 for toks in want.values())
    assert not eng.decode_inflight and not eng._pending_retire
