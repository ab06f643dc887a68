"""Assigned input shapes (same four for every architecture).

  train_4k     seq 4,096   global_batch 256   -> train_step
  prefill_32k  seq 32,768  global_batch 32    -> prefill_step
  decode_32k   seq 32,768  global_batch 128   -> serve_step (1 token, 32k cache)
  long_500k    seq 524,288 global_batch 1     -> serve_step (sub-quadratic only)

`applicable()` encodes the assignment's skips: encoder-only archs have no
decode step; pure full-attention archs skip long_500k."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


SHAPES = {
    "train_4k": Shape("train_4k", 4_096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32_768, 128, "decode"),
    "long_500k": Shape("long_500k", 524_288, 1, "decode"),
}


def applicable(cfg, shape: Shape) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) per the assignment rules."""
    if shape.kind == "decode":
        if not cfg.causal:
            return False, "encoder-only: no decode step"
        if shape.name == "long_500k" and not cfg.sub_quadratic:
            return False, "pure full attention: 500k dense decode out of scope"
    if shape.kind == "prefill" and not cfg.causal:
        # encoder 'prefill' = one full forward pass over 32k frames
        return True, ""
    return True, ""


def reduced_shape(shape: Shape) -> Shape:
    """Tiny version of a shape for CPU smoke tests."""
    return Shape(shape.name, min(shape.seq_len, 128),
                 min(shape.global_batch, 2), shape.kind)
