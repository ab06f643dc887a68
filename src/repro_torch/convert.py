"""Carry state between numpy and the port's NamedTuples of tensors.

The port stores 32-bit words as int32 tensors; numpy (and the JAX package)
hold them as uint32.  The conversion is a bit-preserving `.view`, never a
value cast.  Inputs are sequences in the field order of the NamedTuple
they become (the order the JAX package's NamedTuples share), so callers can
pass a reference object, a tuple or a list.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import ApplyResult, ApplyStats, LinkCtx, OpBatch
from repro_torch.core.layout import (TableState, Traffic, as_words,
                                     resolve_device)

# Which fields hold 32-bit words (uint32 in numpy), per NamedTuple type.
_WORD_FIELDS = {
    TableState: ("data", "version", "lock", "pool", "ring_head", "alloc_gen"),
    LinkCtx: ("version", "value"),
    OpBatch: ("expected", "desired"),
    ApplyResult: ("value",),
    ApplyStats: (),
    Traffic: (),
}


def tensor(arr, device, *, word: bool = False) -> torch.Tensor:
    """One numpy array (or array-like) as a tensor on `device`; `word=True`
    reinterprets uint32 bits as int32."""
    arr = np.array(arr, dtype=np.uint32 if word else None, order="C")
    if word:                         # (np.ascontiguousarray would make a
        arr = arr.view(np.int32)     # 0-d word, e.g. ring_head, 1-d)
    return torch.from_numpy(arr).to(device)


def array(t: torch.Tensor, *, word: bool = False) -> np.ndarray:
    """One tensor as a numpy array; `word=True` gives the uint32 view."""
    out = t.detach().cpu().numpy()
    return out.view(np.uint32) if word else out


def to_torch(cls, fields, device="cuda"):
    """Build a `cls` NamedTuple (TableState, LinkCtx, OpBatch, ...) from
    numpy arrays given in its field order."""
    fields = tuple(fields)
    if len(fields) != len(cls._fields):
        raise ValueError(f"{cls.__name__} has {len(cls._fields)} fields, got "
                         f"{len(fields)}")
    words = _WORD_FIELDS[cls]
    return cls(*(tensor(x, device, word=name in words)
                 for name, x in zip(cls._fields, fields)))


def to_numpy(nt) -> tuple:
    """A port NamedTuple as a tuple of numpy arrays in field order, words
    as uint32."""
    words = _WORD_FIELDS[type(nt)]
    return tuple(array(x, word=name in words)
                 for name, x in zip(nt._fields, nt))


def raw_table(data, meta, device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """The raw-table layer's (data word[n+1, k], meta word[n+1, 2]) from
    the reference's uint32 arrays (row n is the dummy row)."""
    return tensor(data, device, word=True), tensor(meta, device, word=True)


def cachehash_tables(cells, chain_pool, device="cuda"
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """CacheHash's (cells word[m, cw], chain_pool word[c, cw]) from the
    reference's uint32 arrays."""
    return (tensor(cells, device, word=True),
            tensor(chain_pool, device, word=True))


def snapshot(snap, device="cuda") -> dict:
    """A `{"logical", "versions"}` table snapshot (numpy uint32, as the
    reference's targets give it, or port tensors) as word tensors on
    `device`."""
    dev = resolve_device(device)
    return {"logical": as_words(snap["logical"], dev),
            "versions": as_words(snap["versions"], dev)}


def table_state(fields, device="cuda") -> TableState:
    return to_torch(TableState, fields, device)


def link_ctx(fields, device="cuda") -> LinkCtx:
    return to_torch(LinkCtx, fields, device)


def op_batch(fields, device="cuda") -> OpBatch:
    return to_torch(OpBatch, fields, device)
