"""repro_torch.atomics — the single public entry point for big atomics.

A k-word linearizable register with load/store/CAS and LL/SC:

  Specs          AtomicSpec / HashSpec / QueueSpec — frozen descriptions
                 of shape + strategy.
  States         TableState / HashState / LinkCtx / the queue's ring
                 table — NamedTuples of tensors.
  One op schema  OpBatch with per-lane kind LOAD / STORE / CAS / LL / SC /
                 VALIDATE (+ FIND / INSERT / DELETE for CacheHash,
                 `core.cachehash.apply_hash`), one linearization for mixed
                 batches.
  Registry       StrategyImpl + register_strategy(): layouts plug in
                 without touching core.

Canonical usage:

    from repro_torch import atomics

    spec = atomics.AtomicSpec(n=1024, k=4, strategy="cached_me", p_max=256)
    state = atomics.init(spec)                          # on the card
    ops = atomics.make_ops(kind, slot, expected, desired, k=spec.k)
    state, ctx, res, stats, traffic = atomics.apply(spec, state, ops, ctx)
    vals, ok = atomics.read(spec, state, slots)        # honest layout read

Every tensor-creating function takes `device=` ("cuda" by default; pass
"cpu" to run the plain PyTorch versions on the CPU).  Legacy entry points
(`core.bigatomic.apply_ops`, `sync.llsc.apply_sync`,
`core.cachehash.apply_hash_ops`, the `BigAtomicTable` / `CacheHash`
wrappers) are thin shims over this module.

The transaction layer: k-word MCAS (`atomics.mcas`, checked txn
construction via `atomics.make_txns`), bounded version lists
(`VersionSpec`, `txn.versionlist`) and the optimistic transactional map
(`txn.map`), all registry-dispatched.  The reference's mesh layer (`dist`,
`DistSpec`, the sharded MCAS) is not ported yet.
"""

from repro_torch.core.engine import (  # noqa: F401
    CAS, DELETE, FIND, IDLE, INSERT, LL, LOAD, SC, STORE, VALIDATE,
    ApplyResult, ApplyStats, LinkCtx, OpBatch, RoundHandle,
    apply, apply_ops_reference, apply_round, cas_ops, init, init_ctx,
    linearize, loads, logical, make_ops, read, stores, sync_ops,
)
from repro_torch.core.layout import (  # noqa: F401
    TableState, Traffic, WORD_BYTES, WORD_DTYPE, as_words, state_nbytes,
)
from repro_torch.core.registry import (  # noqa: F401
    StrategyImpl, get_strategy, register_strategy, registered_strategies,
    unregister_strategy,
)
from repro_torch.core.specs import (  # noqa: F401
    DEFAULT_STRATEGY, AtomicSpec, HashSpec, QueueSpec, VersionSpec,
)
from repro_torch.core import strategies as _builtin_strategies  # noqa: F401
from repro_torch import txn  # noqa: F401
from repro_torch.txn.mcas import (  # noqa: F401
    McasResult, TxnBatch, make_txns, mcas,
)


def memory_bytes(spec: AtomicSpec) -> int:
    """Exact bytes of the layout (paper Table 1 / §5.5 forms)."""
    return get_strategy(spec.strategy).memory_bytes(spec.n, spec.k,
                                                    spec.p_max)


def begin_update(spec: AtomicSpec, state, slot: int, new_value,
                 torn_words: int | None = None):
    """Freeze a writer at its most vulnerable point (mid-cache-copy), as
    oversubscription deschedules a lock-holder in the paper.  Test/bench
    adversary; returns a new state and leaves `state` as it was."""
    new_value = as_words(new_value, state.data.device)
    torn = spec.k // 2 if torn_words is None else torn_words
    return get_strategy(spec.strategy).begin_update(state, slot, new_value,
                                                    torn)
