"""Big-atomic tables — the v1 surface over the v2 `repro_torch.atomics` API.

Layouts are `StrategyImpl`s in `repro_torch.core.strategies`,
linearization is the unified engine in `repro_torch.core.engine`, and the
canonical entry point is

    repro_torch.atomics.apply(spec, state, ops [, ctx])

This module keeps the JAX package's v1 surface — `init` / `logical` /
`apply_ops` / `read_protocol` / `commit_layout` / `begin_update` /
`memory_bytes` and the stateful `BigAtomicTable` — as thin shims.  Every
path dispatches through the registry, so a strategy registered from
anywhere works here too.  The deprecated entry point `apply_ops` warns
once per process, as the reference's does.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.deprecation import warn_once
from repro_torch.core.layout import (  # noqa: F401  (re-exports: v1 surface)
    NULL, WORD_BYTES, TableState, Traffic, as_words, state_nbytes,
)
from repro_torch.core.registry import get_strategy
from repro_torch.core.specs import DEFAULT_STRATEGY, AtomicSpec


class Strategy(str, enum.Enum):
    """The built-in layouts (legacy enum).  The v2 API uses plain registry
    names so third-party strategies are first-class; `strategy_name`
    accepts both."""

    SEQLOCK = "seqlock"
    INDIRECT = "indirect"
    CACHED_WF = "cached_wf"
    CACHED_ME = "cached_me"
    SIMPLOCK = "simplock"
    PLAIN = "plain"


def strategy_name(strategy) -> str:
    """Normalize a Strategy enum / string to its registry name."""
    return strategy.value if isinstance(strategy, Strategy) else str(strategy)


def _spec(state: TableState, strategy, k: int | None = None,
          p_max: int = 1024) -> AtomicSpec:
    n = state.version.shape[0]
    k = state.data.shape[1] if k is None else k
    return AtomicSpec(n, k, strategy_name(strategy), p_max)


def init(n: int, k: int, strategy, p_max: int, initial=None, *,
         device="cuda") -> TableState:
    """Build the initial state for a table of n cells x k words."""
    return engine.init(AtomicSpec(n, k, strategy_name(strategy), p_max),
                       initial, device=device)


def logical(state: TableState, strategy) -> torch.Tensor:
    """The current logical value of every cell, derived from the layout."""
    return get_strategy(strategy_name(strategy)).logical(state)


def commit_layout(state: TableState, new_data, new_version, n_updates,
                  strategy, p: int) -> TableState:
    """Reconcile a strategy's layout after the logical values have advanced
    from `state`'s to (`new_data`, `new_version`), the reference's v1
    contract: the cells written are those whose version moved, found by a
    pass over the whole table (one host read).  Returns a new state;
    `state` stays as it was.  The engine and CacheHash call the layouts'
    `commit` with the dirty-cell list they already hold instead."""
    n = state.version.shape[0]
    moved = torch.nonzero(new_version != state.version).flatten()
    dirty = torch.full((max(p, 1),), n, dtype=torch.int32,
                       device=state.version.device)
    m = min(moved.numel(), dirty.numel())
    dirty[:m] = moved[:m].to(torch.int32)
    dev = state.version.device
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    stats = engine.ApplyStats(
        zero, torch.as_tensor(n_updates, device=dev).to(torch.int32), zero,
        zero, zero, torch.full((), moved.numel(), dtype=torch.int32,
                               device=dev))
    state = TableState(*(x.clone() for x in state))
    return get_strategy(strategy_name(strategy)).commit(
        state, new_data, new_version, stats, dirty, p)


def apply_ops(state: TableState, ops: engine.OpBatch, *, strategy: str,
              k: int):
    """DEPRECATED shim: use `repro_torch.atomics.apply(spec, state, ops)`.
    Warns `DeprecationWarning` once per process.

    Returns (new_state, ApplyResult, ApplyStats, Traffic)."""
    warn_once("core.bigatomic.apply_ops",
              "repro_torch.atomics.apply(spec, state, ops)")
    new_state, _, result, stats, traffic = engine.apply(
        _spec(state, strategy, k), state, ops)
    return new_state, result, stats, traffic


def read_protocol(state: TableState, slots, *, strategy: str):
    """Read cells using ONLY the strategy's layout fields, as the paper's
    load would.  Returns (values[q,k], ok[q]); ok=False means the reader is
    blocked (seqlock torn / simplock held) and must retry."""
    return engine.read(_spec(state, strategy), state, slots)


def begin_update(state: TableState, slot: int, new_value, *, strategy: str,
                 torn_words: int | None = None) -> TableState:
    """Freeze a writer at its most vulnerable point (mid-cache-copy), as
    oversubscription deschedules a lock-holder in the paper (see
    `repro_torch.atomics.begin_update`)."""
    k = state.data.shape[1] if state.data.numel() else state.pool.shape[1]
    torn = k // 2 if torn_words is None else torn_words
    new_value = as_words(new_value, state.data.device)
    return get_strategy(strategy_name(strategy)).begin_update(
        state, slot, new_value, torn)


def memory_bytes(n: int, k: int, p: int, strategy) -> int:
    """Exact bytes of the layout, matching the paper's Table 1 / §5.5 forms."""
    return get_strategy(strategy_name(strategy)).memory_bytes(n, k, p)


class BigAtomicTable:
    """Thin stateful shim over `repro_torch.atomics` — new code should hold
    an `AtomicSpec` + `TableState` and call `atomics.apply` directly."""

    def __init__(self, n: int, k: int, strategy=None, p_max: int = 1024,
                 initial: np.ndarray | None = None, *, device="cuda"):
        name = strategy_name(strategy) if strategy is not None \
            else DEFAULT_STRATEGY
        self.spec = AtomicSpec(n, k, name, p_max)
        self.state = engine.init(self.spec, initial, device=device)

    @property
    def device(self) -> torch.device:
        return self.state.version.device

    @property
    def n(self) -> int:
        return self.spec.n

    @property
    def k(self) -> int:
        return self.spec.k

    @property
    def p_max(self) -> int:
        return self.spec.p_max

    @property
    def strategy(self) -> str:
        return self.spec.strategy

    def apply(self, ops: engine.OpBatch):
        self.state, _, result, stats, traffic = engine.apply(
            self.spec, self.state, ops)
        return result, stats, traffic

    def load(self, slots, *, return_ok: bool = False):
        """Honest per-strategy read of `slots`: values[q, k], or (values,
        ok) with `return_ok=True`; ok[i] False means a blocking strategy's
        reader observed a torn or locked cell and must retry."""
        vals, ok = engine.read(self.spec, self.state, slots)
        return (vals, ok) if return_ok else vals

    def store(self, slots, values):
        return self.apply(engine.stores(slots, values, k=self.k,
                                        device=self.device))

    def cas(self, slots, expected, desired):
        return self.apply(engine.cas_ops(slots, expected, desired, k=self.k,
                                         device=self.device))

    def logical(self) -> torch.Tensor:
        return engine.logical(self.spec, self.state)

    def memory_bytes(self) -> int:
        return memory_bytes(self.n, self.k, self.p_max, self.strategy)
