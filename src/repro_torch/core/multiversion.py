"""Versioned snapshot store: the paper's multiversioning application (§2:
"allows the first version, most commonly accessed, to be stored inline and
updated atomically"), applied to what a training framework multi-versions:
the train state (PyTorch).

The store's version/step/head bookkeeping rides `repro_torch.txn.
versionlist`: a per-slot bounded version chain whose head cell is a big
atomic on the unified engine.  The payload ring (`slots`, a nested dict /
list / tuple of tensors stacked to [S, ...]) holds the states themselves;
every piece of METADATA a reader validates against lives in the version
list's head table:

  * the per-ring-slot `version` IS the head table's big-atomic cell
    version (even = consistent; a publish is one engine STORE, +2), and
  * the per-slot `step` is the head cell's inline value word.

The head table is pinned to the `seqlock` layout (data + even/odd version
IS a seqlock), so `begin_publish` (freeze the writer mid-copy) is the odd-
version torn state of that layout.

The reader protocol: `snapshot()` reads head, then the slot, then
`validate()` confirms the version is even and unchanged.  `step_at(store,
t)` is a timestamped read of which training step each ring slot held at
publish-time `t`, off the bounded version chain.

Everything is functional (states in, states out): `publish` leaves the
store it was given valid.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.layout import as_u64, as_words, to_word
from repro_torch.core.specs import VersionSpec
from repro_torch.models.common import tree_map  # noqa: F401 (mv.tree_map)
from repro_torch.txn import versionlist as vl

# The head table stores one word of payload per ring slot (the training
# step); depth 2 = inline head + one pooled predecessor per slot, enough to
# answer step_at() across the writer's most recent lap.
_K = 1
_DEPTH = 2
_STRATEGY = "seqlock"          # the layout whose protocol this module is


def _vspec(n_slots: int) -> VersionSpec:
    return VersionSpec(n=n_slots, k=_K, depth=_DEPTH, strategy=_STRATEGY,
                       p_max=64)


def _at(buf: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """`buf[slot]` for a 0-d slot tensor, without reading it back."""
    return buf.index_select(0, slot.reshape(1).long())[0]


class VersionedStore(NamedTuple):
    slots: Any                # tree of tensors, each leaf stacked to [S, ...]
    vstate: vl.VersionState   # head table: [step] per slot + chain metadata
    head: torch.Tensor        # int32[], freshest consistent slot

    @property
    def version(self) -> torch.Tensor:
        """word[S]; even = consistent (the head table's cell versions)."""
        return self.vstate.table.version

    @property
    def step(self) -> torch.Tensor:
        """int32[S], training step held by each slot (head cell word 0)."""
        return self.vstate.table.data[:, 0]


def init_store(state, n_slots: int = 2) -> VersionedStore:
    """Ring of `n_slots` copies of `state` (slot 0 = the initial state) on
    the device of its first leaf."""
    leaves = []
    tree_map(leaves.append, state)
    dev = leaves[0].device
    slots = tree_map(
        lambda x: x[None].expand((n_slots,) + tuple(x.shape)).clone(), state)
    return VersionedStore(
        slots=slots, vstate=vl.init(_vspec(n_slots), device=dev),
        head=torch.zeros((), dtype=torch.int32, device=dev))


def publish(store: VersionedStore, state, step) -> VersionedStore:
    """Writer: install `state` as the freshest snapshot.  O(bytes) copy; no
    reader can block it (readers only validate).

    The payload copy lands in the ring (each leaf cast to its ring's
    dtype, as the reference's `.at[].set`); the metadata update (step word +
    version bump, +2, stays even) is ONE engine STORE on the slot's
    big-atomic head cell; swinging `head` is the linearization point.  The
    publish timestamp is the global publish count + 1 (uint32).  No host
    read."""
    n = store.version.shape[0]
    slot = (store.head + 1) % n
    idx = slot.reshape(1).long()
    slots = tree_map(
        lambda buf, x: buf.index_copy(0, idx, x[None].to(buf.dtype)),
        store.slots, state)
    ts = to_word(as_u64(store.vstate.count).sum() + 1)   # publish counter
    dev = store.head.device
    vstate = vl.publish(_vspec(n), store.vstate, slot.reshape(1),
                        as_words(step, dev).reshape(1, _K), ts.reshape(1))
    return VersionedStore(slots, vstate, slot.to(torch.int32))


class Snapshot(NamedTuple):
    state: Any
    step: torch.Tensor
    slot: torch.Tensor
    version: torch.Tensor


def snapshot(store: VersionedStore) -> Snapshot:
    """Reader fast path: head -> slot -> validate."""
    slot = store.head
    state = tree_map(lambda buf: _at(buf, slot), store.slots)
    return Snapshot(state, _at(store.step, slot), slot,
                    _at(store.version, slot))


def validate(store: VersionedStore, snap: Snapshot) -> torch.Tensor:
    """True iff `snap` is still a consistent snapshot (version unchanged and
    even).  A checkpointer calls this AFTER serializing: if False, the bytes
    written may be torn across publishes; retry from the new head."""
    v = _at(store.version, snap.slot)
    return (v == snap.version) & ((v & 1) == 0)


def snapshot_with_validation(store: VersionedStore, *, max_retries: int = 3):
    """Host-side reader loop: snapshot, validate (one host read), retry.
    With S >= 2 slots a single retry suffices unless the writer publishes S
    times during one read."""
    for _ in range(max_retries):
        snap = snapshot(store)
        if bool(validate(store, snap)):
            return snap
    raise RuntimeError("snapshot validation failed after retries "
                       "(writer lapped the reader repeatedly)")


def step_at(store: VersionedStore, publish_ts):
    """Timestamped metadata read off the version chains: the training step
    each ring slot held at global publish time `publish_ts` (word[S] step,
    bool[S] ok; ok=False where that history is evicted or torn)."""
    n = store.version.shape[0]
    dev = store.head.device
    slots = torch.arange(n, dtype=torch.int32, device=dev)
    ts = as_words(publish_ts, dev).reshape(-1).expand(n)
    vals, _fts, ok = vl.snapshot_read(_vspec(n), store.vstate, slots, ts)
    return vals[:, 0], ok


# ---------------------------------------------------------------------------
# Torn-state simulation (the oversubscription analogue, for tests)
# ---------------------------------------------------------------------------

def begin_publish(store: VersionedStore, state) -> VersionedStore:
    """Freeze the writer mid-copy (payload half-written, head-cell version
    bumped ODD, `head` not yet swung): readers using the protocol keep
    returning the OLD consistent snapshot; a naive reader of the torn slot
    returns a mix (the negative control).  This is the version list's head
    table in its seqlock role: odd = locked."""
    n = store.version.shape[0]
    slot = (store.head + 1) % n
    idx = slot.reshape(1).long()
    table = store.vstate.table
    table = table._replace(version=table.version.index_add(
        0, idx, torch.ones_like(idx, dtype=table.version.dtype)))

    def half_copy(buf, x):
        flat = x.reshape(-1)
        half = flat.shape[0] // 2
        cur = _at(buf, slot).reshape(-1)
        torn = torch.cat([flat[:half], cur[half:]]).reshape(x.shape)
        return buf.index_copy(0, idx, torn[None].to(buf.dtype))

    slots = tree_map(half_copy, store.slots, state)
    return store._replace(slots=slots,
                          vstate=store.vstate._replace(table=table))
