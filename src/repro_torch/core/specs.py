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
