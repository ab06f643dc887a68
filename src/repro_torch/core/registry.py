"""Strategy registry: big-atomic memory layouts plug into the core engine.

`StrategyImpl` is the boundary between the unified engine
(`repro_torch.core.engine`), which linearizes a batch of ops against
logical values, and a memory layout, which decides how the k-word register
is stored and read.  New layouts register themselves here and are usable
from `atomics.apply` without touching core:

    from repro_torch import atomics

    class MyLayout(atomics.StrategyImpl):
        name = "my_layout"

    atomics.register_strategy(MyLayout())

The base class implements the PLAIN protocol (raw data + version, no reader
protection), so a minimal subclass only sets `name`.  Hooks take and return
tensors on the state's device; `commit` may update the layout's buffers in
place (`engine.apply` hands it a private copy unless the caller donates).
"""

from __future__ import annotations

import torch

from repro_torch.core.layout import (TableState, Traffic, WORD_BYTES,
                                     WORD_DTYPE, _empty, clamped_index)


class StrategyImpl:
    """Protocol for a big-atomic memory layout (defaults = PLAIN).

    name:           registry key; `AtomicSpec.strategy` strings resolve here.
    lock_free:      readers always make progress from any observed state.
    blocks_readers: the honest read protocol can return ok=False (retry).
    """

    name: str | None = None
    lock_free: bool = False
    blocks_readers: bool = False

    # -- setup ---------------------------------------------------------------

    def init(self, n: int, k: int, p_max: int, data) -> TableState:
        """Build the initial layout for a table of n cells x k words; `data`
        is the word[n, k] tensor of initial logical values (its device is
        the table's)."""
        dev = data.device
        return TableState(
            data, _empty(WORD_DTYPE, (n,), device=dev),
            _empty(torch.int32, device=dev), _empty(torch.bool, device=dev),
            _empty(WORD_DTYPE, device=dev),
            _empty(WORD_DTYPE, (0, k), device=dev),
            _empty(torch.int32, device=dev),
            _empty(WORD_DTYPE, (), device=dev),
            _empty(WORD_DTYPE, (), device=dev))

    # -- engine hooks --------------------------------------------------------

    def logical(self, state: TableState):
        """The current logical value of every cell, derived from the layout."""
        return state.data

    def engine_view(self, state: TableState):
        """The word[n, k] tensor the unified engine linearizes against
        (and updates in place).  Defaults to `logical(state)`."""
        return self.logical(state)

    def commit(self, state: TableState, new_data, new_version, stats,
               dirty, p: int) -> TableState:
        """Reconcile the layout after the logical values have advanced.

        The round has updated the engine view and `state.version` in place;
        `new_data` / `new_version` are the post-batch values.  `stats` is
        the batch's `ApplyStats` (`n_updates`: update writes performed, for
        node-pool accounting; `n_dirty_cells`: cells written); `dirty` the
        cells written, int32[p] in ascending slot order padded with n
        (`engine.dirty_slots`); `p` the batch width.  The built-in hooks
        touch only those cells (but CACHED_WF, which clears every mark as
        the reference does)."""
        return state._replace(data=new_data, version=new_version)

    def read(self, state: TableState, slots):
        """Honest reader protocol: values + ok mask from layout fields only.
        ok=False means the reader is *blocked* (torn state / lock held).
        Slots are clamped as the reference's gather clamps them."""
        slots = clamped_index(slots, state.data.shape[0])
        return state.data[slots], torch.ones(
            (slots.shape[0],), dtype=torch.bool, device=slots.device)

    def check_invariants(self, spec, state: TableState) -> dict:
        """Structural invariants of the layout at a QUIESCENT point.
        Returns ``{invariant_name: bool[n] violation mask}``."""
        return {}

    def lower_round(self, spec, *, mode: str):
        """Hand the engine a fused execution round for this layout, or None.

        Called by `engine.round_for` with the resolved engine-kernel mode
        ('pallas' = the hand-written kernel tier, 'xla' = the plain-tensor
        tier; 'off' never reaches here).  None keeps the plain `linearize`
        path (the default for plug-in strategies).  The round takes the
        `linearize` arguments and, under BIGATOMIC_OBS=counters, the
        keyword `telem`, which it hands to `obs.telemetry.count_table`."""
        return None

    def traffic(self, stats, k: int, p: int) -> Traffic:
        """Analytic memory bytes + dependency depth per batch (roofline)."""
        w = WORD_BYTES
        cell = k * w
        loads = stats.n_loads
        upd = stats.n_updates
        dev = loads.device
        return Traffic(
            (loads * cell + upd * cell).to(torch.float32),
            (upd * cell).to(torch.float32),
            torch.tensor(1, dtype=torch.int32, device=dev),
            torch.tensor(0, dtype=torch.int32, device=dev))

    # -- simulation / accounting (host-side) ---------------------------------

    def begin_update(self, state: TableState, slot: int, new_value,
                     torn_words: int) -> TableState:
        """Freeze a writer at its most vulnerable point (torn-state test).
        Returns a new state; the passed one is left as it was."""
        data = state.data.clone()
        data[slot, :torn_words] = new_value[:torn_words]
        return state._replace(data=data)

    def memory_bytes(self, n: int, k: int, p: int) -> int:
        """Exact bytes of the layout (paper Table 1 / §5.5 forms)."""
        return n * k * WORD_BYTES


_REGISTRY: dict[str, StrategyImpl] = {}


def register_strategy(impl: StrategyImpl | type, *,
                      overwrite: bool = False) -> StrategyImpl:
    """Add a layout to the dispatch table (usable as a class decorator).
    Raises on duplicate names unless `overwrite=True`."""
    if isinstance(impl, type):
        impl = impl()
    if not impl.name:
        raise ValueError("StrategyImpl.name must be a non-empty string")
    if impl.name in _REGISTRY and not overwrite:
        raise ValueError(f"strategy {impl.name!r} already registered "
                         "(pass overwrite=True to replace)")
    _REGISTRY[impl.name] = impl
    return impl


def unregister_strategy(name: str) -> None:
    """Remove a registered layout (test hygiene)."""
    _REGISTRY.pop(name, None)


def get_strategy(name: str) -> StrategyImpl:
    """Resolve a strategy name to its implementation."""
    if name not in _REGISTRY:
        # Built-ins self-register on first use; lazy import avoids a cycle.
        from repro_torch.core import strategies  # noqa: F401
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown big-atomic strategy {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def registered_strategies() -> tuple[str, ...]:
    get_strategy("plain")  # force built-in registration
    return tuple(sorted(_REGISTRY))
