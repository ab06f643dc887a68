"""`lax.associative_scan` along one dim, for the recurrent blocks.

The port's copy of the JAX scan: the same odd/even recursion (combine
adjacent pairs, scan the half-length result, then fill the even positions
from the odd ones), so each element is combined in the reference's order
and the float rounding follows it.  `fn(a, b)` takes and returns tuples of
tensors and is applied elementwise along `dim`.
"""

from __future__ import annotations

from typing import Callable

import torch


def associative_scan(fn: Callable, elems: tuple, dim: int = 0) -> tuple:
    """Inclusive scan of the tuple of tensors `elems` along `dim` with the
    associative `fn`: element i of the result is fn(... fn(e0, e1) ...,
    ei), computed as `jax.lax.associative_scan` computes it."""
    elems = tuple(elems)
    dim = dim % elems[0].dim()
    n = elems[0].shape[dim]
    if any(e.shape[dim] != n for e in elems):
        raise ValueError(f"associative_scan: lengths along dim {dim} "
                         f"differ: {[tuple(e.shape) for e in elems]}")
    return tuple(_scan(fn, elems, dim))


def _slice(x, start, stop, step, dim):
    idx = [slice(None)] * x.dim()
    idx[dim] = slice(start, stop, step)
    return x[tuple(idx)]


def _scan(fn, elems, dim):
    n = elems[0].shape[dim]
    if n < 2:
        return elems
    # combine adjacent pairs, then scan the half-length result
    reduced = fn(tuple(_slice(e, 0, n - 1, 2, dim) for e in elems),
                 tuple(_slice(e, 1, None, 2, dim) for e in elems))
    odd = _scan(fn, tuple(reduced), dim)
    # the even positions from the odd ones (position 0 is elems[0])
    if n % 2 == 0:
        even = fn(tuple(_slice(o, 0, -1, 1, dim) for o in odd),
                  tuple(_slice(e, 2, None, 2, dim) for e in elems))
    else:
        even = fn(tuple(odd), tuple(_slice(e, 2, None, 2, dim)
                                    for e in elems))
    even = [torch.cat([_slice(e, 0, 1, 1, dim), r], dim=dim)
            for e, r in zip(elems, even)]
    return [_interleave(a, b, dim) for a, b in zip(even, odd)]


def _interleave(a, b, dim):
    """a0 b0 a1 b1 ... along `dim` (len(a) == len(b) or len(b) + 1)."""
    na, nb = a.shape[dim], b.shape[dim]
    shape = list(a.shape)
    shape[dim] = na + nb
    out = a.new_empty(shape)
    _slice(out, 0, None, 2, dim).copy_(a)
    _slice(out, 1, None, 2, dim).copy_(b)
    return out
