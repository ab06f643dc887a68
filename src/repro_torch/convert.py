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


def model_params(tree, device="cuda"):
    """The reference's `init_params` tree (its leaves as numpy arrays, or
    anything `np.asarray` takes: jax arrays, ml_dtypes bfloat16) as the
    port's params on `device`: the same nested dicts and tuples, each
    leaf a tensor of the same shape and dtype (bfloat16 bits kept)."""
    if isinstance(tree, dict):
        return {k: model_params(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(model_params(v, device) for v in tree)
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.uint16).astype(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, order="C")).to(device)


def model_params_to_numpy(params):
    """The reverse of `model_params`: the port's params as numpy arrays in
    the same tree (bfloat16 as `ml_dtypes.bfloat16` when that package is
    there, else its raw uint16 bits)."""
    if isinstance(params, dict):
        return {k: model_params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, (tuple, list)):
        return tuple(model_params_to_numpy(v) for v in params)
    t = params.detach().cpu()
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).numpy().view(np.uint16)
        try:
            import ml_dtypes
        except ImportError:
            return bits
        return bits.view(ml_dtypes.bfloat16)
    return t.numpy()
