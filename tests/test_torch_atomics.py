"""The slice as a whole: `repro_torch.atomics.apply` against the JAX apply
composed as its `_apply_impl` composes it with `linearize` (engine view ->
round -> commit -> traffic), over 5-batch sequences for all six strategies
and every engine-kernel mode; the device rule; and the port's independence
from JAX and from the reference package.  Tolerance is zero: every
TableState leaf, ctx, result, stats and Traffic field compares exactly,
words as uint32 bit patterns."""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from oracle import mixed_batch
from repro import atomics as jatomics
from repro.core import engine as jengine
from repro_torch import atomics as tatomics
from repro_torch import convert
from repro_torch.kernels import engine_round as ter

ROOT = Path(__file__).resolve().parents[1]
STRATEGIES = ["plain", "simplock", "seqlock", "indirect", "cached_wf",
              "cached_me"]


def jax_apply(spec, state, ops, ctx):
    """The reference's `_apply_impl` with the round fixed to `linearize`
    (the reference's fused round needs the TPU kernels module, which this
    jax cannot import; its round is bit-identical to `linearize`)."""
    impl = jatomics.get_strategy(spec.strategy)
    nd, nv, nctx, res, stats = jengine.linearize(
        impl.engine_view(state), state.version, ctx, ops)
    new_state = impl.commit(state, nd, nv, stats.n_updates, ops.p)
    return new_state, nctx, res, stats, impl.traffic(stats, spec.k, ops.p)


def _batch(step, rng, n, k, p, ctx, current):
    """Five batch shapes: mixed kinds with collisions, collision-free mixed
    kinds, read-only with duplicates, contended 20 % updates, and SC /
    VALIDATE on the lanes' links."""
    words = rng.integers(0, 2 ** 32, (p, k), np.uint32)
    if step == 0:
        return mixed_batch(rng, ctx, p=p, n=n, k=k, current=current)
    if step == 1:
        kind = rng.integers(0, 7, p).astype(np.int32)
        slot = rng.choice(n, p, replace=False).astype(np.int32)
        return jatomics.make_ops(kind, slot, current[slot], words, k=k)
    if step == 2:
        kind = rng.choice([0, 3, 4, 6], p).astype(np.int32)
        return jatomics.make_ops(kind, rng.integers(0, 3, p), k=k)
    if step == 3:
        u = rng.random(p) < 0.2
        kind = np.where(u, np.where(rng.random(p) < 0.5, 2, 1),
                        0).astype(np.int32)
        slot = rng.integers(0, n // 2, p).astype(np.int32)
        return jatomics.make_ops(kind, slot, current[slot], words, k=k)
    kind = np.where(rng.random(p) < 0.7, 5, 6).astype(np.int32)
    return jatomics.make_ops(kind, np.asarray(ctx.slot).clip(0, n - 1),
                             desired=words, k=k)


def _np(nt):
    return [np.asarray(x) for x in nt]


@pytest.mark.parametrize("mode", ["pallas", "xla", "off"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_apply_sequence_matches_jax(strategy, mode, monkeypatch):
    monkeypatch.setenv("BIGATOMIC_ENGINE_KERNEL", mode)
    n, k, p = 24, 3, 12
    rng = np.random.default_rng(STRATEGIES.index(strategy))
    initial = rng.integers(0, 2 ** 32, (n, k), dtype=np.uint32)
    jspec = jatomics.AtomicSpec(n, k, strategy, p)
    tspec = tatomics.AtomicSpec(n, k, strategy, p)
    jstate = jatomics.init(jspec, initial)
    tstate = tatomics.init(tspec, initial, device="cpu")
    jctx = jatomics.init_ctx(p, k)
    tctx = None                       # the port's default ctx == init_ctx
    fields = ["state." + f for f in jatomics.TableState._fields] + \
        ["ctx." + f for f in jengine.LinkCtx._fields] + \
        ["result." + f for f in jengine.ApplyResult._fields] + \
        ["stats." + f for f in jengine.ApplyStats._fields] + \
        ["traffic." + f for f in jatomics.Traffic._fields]
    for step in range(5):
        jops = _batch(step, rng, n, k, p, jctx,
                      np.asarray(jatomics.logical(jspec, jstate)))
        tops = convert.op_batch(_np(jops), "cpu")
        before = convert.to_numpy(tstate)
        jout = jax_apply(jspec, jstate, jops, jctx)
        tout = tatomics.apply(tspec, tstate, tops, tctx)
        ref = [x for part in jout for x in _np(part)]
        got = [x for part in tout for x in convert.to_numpy(part)]
        assert len(ref) == len(got) == len(fields)
        for name, a, b in zip(fields, ref, got):
            assert a.dtype == b.dtype, f"step {step}: {name} dtype"
            np.testing.assert_array_equal(
                a, b, err_msg=f"{strategy}/{mode} step {step}: {name}")
        # the caller's state is untouched without donate
        for a, b in zip(before, convert.to_numpy(tstate)):
            np.testing.assert_array_equal(a, b)
        jstate, jctx = jout[0], jout[1]
        tstate, tctx = tout[0], tout[1]
    vals, ok = tatomics.read(tspec, tstate, np.arange(n))
    if not tatomics.get_strategy(strategy).blocks_readers:
        assert ok.all()
    np.testing.assert_array_equal(
        convert.array(vals, word=True)[ok.numpy()],
        convert.array(tatomics.logical(tspec, tstate), word=True)[ok.numpy()])


def test_apply_round_donate_and_fast_tier_counts():
    spec = tatomics.AtomicSpec(16, 2, "seqlock", p_max=4)
    ops = tatomics.stores(np.arange(4), np.ones((4, 2), np.uint32), k=2,
                          device="cpu")
    ref = tatomics.apply(spec, tatomics.init(spec, device="cpu"), ops)
    state = tatomics.init(spec, device="cpu")
    handle = tatomics.apply_round(
        spec, state, tatomics.OpBatch(*convert.to_numpy(ops)), donate=True)
    assert handle.ready() and handle.wait() is handle
    np.testing.assert_array_equal(handle.state.data.numpy(),
                                  ref[0].data.numpy())
    np.testing.assert_array_equal(handle.state.version.numpy(),
                                  ref[0].version.numpy())
    # donate=True updated the passed table in place
    np.testing.assert_array_equal(state.data.numpy(), ref[0].data.numpy())
    assert int(handle.stats.rounds) == 1
    # CPU tensors run the plain versions: no kernel launch is counted
    assert ter.round_prologue.launches == ter.fast_round.launches == \
        ter.slow_round.launches == ter.round_epilogue.launches == 0


def test_init_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = tatomics.AtomicSpec(8, 2, "cached_me", p_max=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tatomics.init(spec)
    assert tatomics.init(spec, device="cpu").data.device.type == "cpu"


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_reference():
    """AST scan of every module of the port and `chip_smoke.py`, then a
    fresh interpreter that refuses to import `jax` or `repro` imports the
    whole port and runs one apply, one scrub of an injected fault and one
    attention on the CPU."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: {mod}"
    script = textwrap.dedent("""
        import importlib.abc, sys

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    raise ImportError(f"blocked import of {name}")
                return None

        sys.meta_path.insert(0, Block())
        import numpy as np
        from repro_torch import atomics, convert
        from repro_torch.kernels import _build, engine_round, llsc_commit, ops
        import repro_torch.guard, repro_torch.runtime
        import repro_torch.kernels.flash_attention
        from repro_torch.guard import inject
        from repro_torch.kernels.flash_attention import flash_attention
        spec = atomics.AtomicSpec(8, 2, "cached_me", p_max=4)
        state = atomics.init(spec, device="cpu")
        batch = atomics.stores([1, 1, 2], np.ones((3, 2), np.uint32), k=2,
                               device="cpu")
        state, *_ = atomics.apply(spec, state, batch)
        assert int(state.version[1]) == 4
        state, _, succ, _ = llsc_commit.commit_round(
            spec, state, atomics.init_ctx(1, 2, device="cpu"), [3],
            np.ones((1, 2), np.uint32))
        assert not bool(succ[0])
        data, meta = convert.raw_table(np.ones((5, 2), np.uint32),
                                       np.zeros((5, 2), np.uint32), "cpu")
        vals, ok = ops.bigatomic_load(data, meta, convert.tensor(
            np.arange(4, dtype=np.int32), "cpu"))
        assert bool(ok.all()) and int(ops.hash_keys(vals, 7)[0]) >= 0
        target = repro_torch.runtime.LocalTarget(spec, device="cpu")
        sc = repro_torch.guard.Scrubber(spec, device="cpu")
        base = sc.digest_of(target)
        target.state, _ = inject.inject_table_fault(
            spec, target.state, repro_torch.runtime.Fault(1, "bit_flip",
                                                          slot=2),
            np.random.default_rng(0))
        assert sc.scrub(target, round_idx=1, baseline=base).detected == [2]
        import torch
        x = torch.ones((1, 4, 2, 8))
        assert flash_attention(x, x, x).shape == (1, 4, 2, 8)
        bad = [m for m in sys.modules if m.split(".")[0] in
               ("jax", "jaxlib", "repro")]
        assert not bad, bad
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "ok"
