"""Data-plane fault realization: mutate live big-atomic state.

`runtime.faults.Fault` says what kind of corruption fires; this module says
what it does to the table, per strategy, at a drained round boundary:

  bit_flip     XOR one bit of one live table word.  The victim word is the
               cell's value storage in its OWN layout -- seqlock/cached_me
               flip `data`, indirect flips the live pool node, cached_wf
               flips either the cache row or its backup node -- or the
               version word (word == k).  `field=` overrides the choice
               ("data" | "version" | "pool" | "bptr") for invariant-
               targeted tests.
  torn_write   overwrite a prefix of the cell's k-word value row WITHOUT
               touching the version.  The first garbage word is forced to
               differ from the live word, so the corruption is never a
               no-op.

Both return `(new_state, info)` with the realized choices.  Every free
choice is drawn on the host from the caller's numpy `Generator`, in the
reference's order, so one seed gives the same `info` and the same
corrupted bits in both packages.  The corruption itself is one indexed
write into a clone of the one field that changes, on the table's device;
the rest of the state is shared with the input, never copied to the host.

`inject_snapshot_fault` corrupts a `{"logical", "versions"}` snapshot
instead (the snapshot-plane path: the layout rebuilds consistently on
load, the value/version corruption is the same).
"""

from __future__ import annotations

import numpy as np
import torch


def _bit(bit: int) -> int:
    """The int32 word with only `bit` set."""
    return int(np.uint32(1 << bit).view(np.int32))


def _value_field(strategy: str, rng) -> str:
    if strategy == "indirect":
        return "pool"
    if strategy == "cached_wf":
        return str(rng.choice(["data", "pool"]))
    return "data"


def _flipped(t: torch.Tensor, index, bit: int) -> torch.Tensor:
    out = t.clone()
    out[index] ^= _bit(bit)
    return out


def _word(x) -> int:
    """A word tensor element as its uint32 value."""
    return int(x) & 0xFFFFFFFF


def _torn(row_head: int, words: int, rng) -> torch.Tensor:
    """The reference's garbage prefix: `words` random words, the first
    forced to differ from the live word `row_head`."""
    garbage = rng.integers(0, 2 ** 32, words, dtype=np.uint32)
    garbage[0] = np.uint32(row_head) ^ np.uint32(rng.integers(1, 2 ** 32))
    return torch.from_numpy(garbage.view(np.int32))


def inject_table_fault(spec, state, fault, rng):
    """Apply one bit_flip / torn_write to a quiescent `TableState`."""
    n, k = spec.n, spec.k
    slot = fault.slot if fault.slot is not None else int(rng.integers(n))
    info = {"kind": fault.kind, "slot": slot}

    if fault.kind == "bit_flip":
        word = fault.word if fault.word is not None \
            else int(rng.integers(k + 1))
        bit = fault.bit if fault.bit is not None else int(rng.integers(32))
        field = fault.field
        if field is None:
            field = "version" if word == k else _value_field(spec.strategy,
                                                             rng)
        info.update(word=word, bit=bit, field=field)
        if field == "version":
            return state._replace(
                version=_flipped(state.version, slot, bit)), info
        if field == "bptr":
            return state._replace(bptr=_flipped(state.bptr, slot, bit)), info
        w = min(word, k - 1)
        if field == "pool":
            node = int(state.bptr[slot])
            if 0 <= node < state.pool.shape[0]:
                info["node"] = node
                return state._replace(
                    pool=_flipped(state.pool, (node, w), bit)), info
            field = "data"              # no live node: fall through
            info["field"] = field
        return state._replace(data=_flipped(state.data, (slot, w), bit)), info

    if fault.kind == "torn_write":
        words = fault.words if fault.words is not None \
            else int(rng.integers(1, k + 1))
        words = max(1, min(words, k))
        info.update(words=words)
        if spec.strategy == "indirect":
            node = int(state.bptr[slot])
            garbage = _torn(_word(state.pool[node, 0]), words, rng)
            pool = state.pool.clone()
            pool[node, :words] = garbage.to(pool.device)
            info["node"] = node
            return state._replace(pool=pool), info
        garbage = _torn(_word(state.data[slot, 0]), words, rng)
        data = state.data.clone()
        data[slot, :words] = garbage.to(data.device)
        return state._replace(data=data), info

    raise ValueError(f"not a state fault: {fault.kind!r}")


def inject_snapshot_fault(snap: dict, fault, rng):
    """bit_flip / torn_write against a {'logical', 'versions'} snapshot of
    word tensors; returns (new snapshot, info) and leaves `snap` as it
    was."""
    logical, versions = snap["logical"], snap["versions"]
    n, k = logical.shape
    slot = fault.slot if fault.slot is not None else int(rng.integers(n))
    info = {"kind": fault.kind, "slot": slot}
    if fault.kind == "bit_flip":
        word = fault.word if fault.word is not None \
            else int(rng.integers(k + 1))
        bit = fault.bit if fault.bit is not None else int(rng.integers(32))
        info.update(word=word, bit=bit,
                    field="version" if word == k else "data")
        if word == k:
            versions = _flipped(versions, slot, bit)
        else:
            logical = _flipped(logical, (slot, word), bit)
    elif fault.kind == "torn_write":
        words = fault.words if fault.words is not None \
            else int(rng.integers(1, k + 1))
        words = max(1, min(words, k))
        garbage = _torn(_word(logical[slot, 0]), words, rng)
        logical = logical.clone()
        logical[slot, :words] = garbage.to(logical.device)
        info.update(words=words)
    else:
        raise ValueError(f"not a state fault: {fault.kind!r}")
    return {"logical": logical, "versions": versions}, info
