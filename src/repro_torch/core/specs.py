"""Static specs: the shape of a big-atomic table.

A spec is a small frozen (hashable) dataclass describing the *shape* of a
structure — table size, words per cell, strategy name, concurrency bound.
Every `apply`-style entry point is `fn(spec, state, ops)`.

`DEFAULT_STRATEGY` honours the `BIGATOMIC_STRATEGY` environment variable, as
the JAX package does, so one CI matrix drives both packages.
"""

from __future__ import annotations

import dataclasses
import os

DEFAULT_STRATEGY = os.environ.get("BIGATOMIC_STRATEGY", "cached_me")

# Queue cell indices (the ring layout prefix; see repro_torch.sync.queue).
QUEUE_HEAD, QUEUE_TAIL, QUEUE_SLOT0 = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class AtomicSpec:
    """A table of `n` big atomics of `k` words under `strategy`, sized for
    at most `p_max` concurrent lanes (node-pool / SMR in-flight bound)."""

    n: int
    k: int
    strategy: str = DEFAULT_STRATEGY
    p_max: int = 1024

    def __post_init__(self):
        if self.n <= 0 or self.k <= 0 or self.p_max <= 0:
            raise ValueError(f"AtomicSpec sizes must be positive: {self}")
        if not isinstance(self.strategy, str) or not self.strategy:
            raise ValueError(f"strategy must be a registry name: {self}")


@dataclasses.dataclass(frozen=True)
class HashSpec:
    """A CacheHash of `nb` buckets holding `vw`-word values.

    inline=True is the paper's CacheHash (first link inlined into the bucket
    big atomic); inline=False is the Chaining baseline.  The bucket array is
    an `AtomicSpec(nb, cellw, strategy, p_max)` table (`cell_spec()`)."""

    nb: int
    vw: int = 1
    strategy: str = DEFAULT_STRATEGY
    p_max: int = 1024
    inline: bool = True
    max_chain: int = 8
    chain_factor: float = 2.0

    def __post_init__(self):
        if self.nb & (self.nb - 1) != 0:
            raise ValueError(f"nb must be a power of two: {self.nb}")
        if self.vw <= 0 or self.max_chain <= 0:
            raise ValueError(f"HashSpec sizes must be positive: {self}")

    @property
    def cellw(self) -> int:
        return (2 + self.vw) if self.inline else 1

    @property
    def pool_cap(self) -> int:
        return int(self.nb * self.chain_factor) + 2 * self.p_max

    def cell_spec(self) -> AtomicSpec:
        return AtomicSpec(self.nb, self.cellw, self.strategy, self.p_max)


@dataclasses.dataclass(frozen=True)
class VersionSpec:
    """A table of `n` version lists: per-slot bounded chains of `k`-word
    timestamped versions (the paper's version-list application).

    The newest version of every slot lives INLINE in a big-atomic head cell
    of `cellw = k + 2` words — [value(k), ts, prev] — on an ordinary
    `AtomicSpec` table (`head_spec()`), so head updates ride the unified
    engine and every registered strategy.  Older versions sit in a per-slot
    ring of `depth - 1` immutable pool nodes; a node is overwritten only
    after `depth - 1` further publishes of its slot, which bounds every
    chain to the `depth` newest versions (reads past that report ok=False:
    honesty, not silence)."""

    n: int
    k: int
    depth: int = 4
    strategy: str = DEFAULT_STRATEGY
    p_max: int = 256

    def __post_init__(self):
        if self.n <= 0 or self.k <= 0 or self.p_max <= 0:
            raise ValueError(f"VersionSpec sizes must be positive: {self}")
        if self.depth < 2:
            raise ValueError(f"depth must be >= 2 (inline head + >= 1 "
                             f"pooled version): {self}")

    @property
    def cellw(self) -> int:
        return self.k + 2            # [value(k), ts, prev]

    @property
    def ring_depth(self) -> int:
        return self.depth - 1        # pooled (non-inline) versions per slot

    def head_spec(self) -> AtomicSpec:
        return AtomicSpec(self.n, self.cellw, self.strategy, self.p_max)


@dataclasses.dataclass(frozen=True)
class QueueSpec:
    """A bounded MPMC ticket-ring of `capacity` slots whose head, tail and
    slot cells are `k`-word big atomics (1 seq word + k-1 payload words)."""

    capacity: int
    k: int = 2
    strategy: str = DEFAULT_STRATEGY
    p_max: int = 64

    def __post_init__(self):
        if self.capacity < 2:
            raise ValueError("capacity must be >= 2 (seq tags are ambiguous "
                             "for a 1-slot ring)")
        if self.k < 2:
            raise ValueError("k must be >= 2 (seq word + >=1 payload word)")

    def table_spec(self) -> AtomicSpec:
        return AtomicSpec(QUEUE_SLOT0 + self.capacity, self.k, self.strategy,
                          self.p_max)
