"""Deterministic, resumable data pipeline: the port of the JAX package's
`data/pipeline.py`.

`batch(step)` is a pure function of (seed, step, host_id, n_hosts): the
pipeline keeps no cursor, so resuming at step N is asking for batch N.
The batches are numpy arrays, byte for byte the reference's: the same
Philox key, counter ([0, 0, step, row]) and order of draws per row.
`to_device` makes tensors of them for the model.

Two sources:
  synthetic  a seeded Zipf-ish token stream (token = floor(vocab * u^3));
  memmap     fixed-length documents from a token memmap on disk
             (`make_memmap_corpus` builds one).

bf16 features (hubert with a bf16 compute dtype) come as
`ml_dtypes.bfloat16` where that package is installed, as the reference's
do, else as their uint16 bits; either way the bytes are the float32
draws rounded to nearest even.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.shapes import Shape
from repro_torch.models.common import ModelConfig


def _rng_for(seed: int, step: int, shard: int) -> np.random.Generator:
    # Philox is counter-based: one generator per (step, row), no state
    # carried from step to step.
    return np.random.Generator(np.random.Philox(key=seed,
                                                counter=[0, 0, step, shard]))


def _bf16(x: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 (round to nearest even), as
    `ml_dtypes.bfloat16` when installed, else its uint16 bits."""
    bits = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16)
    bits = bits.numpy().view(np.uint16)
    try:
        import ml_dtypes
    except ImportError:
        return bits
    return bits.view(ml_dtypes.bfloat16)


def synthetic_batch(cfg: ModelConfig, shape: Shape, *, seed: int, step: int,
                    host_id: int = 0, n_hosts: int = 1) -> dict:
    """This host's shard of global batch `step`, as numpy arrays."""
    B, S = shape.global_batch, shape.seq_len
    if B % n_hosts:
        raise ValueError(f"global batch {B} is not a multiple of {n_hosts} "
                         "hosts")
    b = B // n_hosts
    rows = []
    for r in range(b):
        g_row = host_id * b + r                   # global row id
        rng = _rng_for(seed, step, g_row)
        # Zipf-ish skew: token ~ floor(v * u^3) concentrates mass on low ids
        u = rng.random(S)
        rows.append((cfg.vocab * u ** 3).astype(np.int32))
    toks = np.stack(rows)
    if cfg.input_mode == "features":
        rng = _rng_for(seed, step, 10_000_000 + host_id)
        feats = rng.standard_normal((b, S, cfg.feature_dim)).astype(
            np.float32) * 0.1
        return {"features": _bf16(feats) if cfg.compute_dtype == "bfloat16"
                else feats,
                "labels": toks}
    batch = {"tokens": toks}
    if cfg.family == "vlm":
        batch["positions"] = np.broadcast_to(
            np.arange(S, dtype=np.int32)[None, :, None], (b, S, 3)).copy()
    return batch


def make_memmap_corpus(path: str, n_tokens: int, vocab: int,
                       seed: int = 0) -> str:
    """Build a token memmap for the memmap source (tests / examples)."""
    rng = np.random.default_rng(seed)
    arr = np.memmap(path, dtype=np.int32, mode="w+", shape=(n_tokens,))
    chunk = 1 << 20
    for lo in range(0, n_tokens, chunk):
        hi = min(lo + chunk, n_tokens)
        arr[lo:hi] = rng.integers(0, vocab, hi - lo, dtype=np.int32)
    arr.flush()
    return path


def to_device(batch: dict, device="cuda") -> dict:
    """A numpy batch as tensors on `device`: bf16 features (either form
    `synthetic_batch` gives) as bfloat16 with their bits kept."""
    out = {}
    for name, arr in batch.items():
        arr = np.ascontiguousarray(arr)
        if arr.dtype.name == "bfloat16" or (name == "features"
                                            and arr.dtype == np.uint16):
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        out[name] = t.to(device)
    return out


@dataclasses.dataclass
class DataPipeline:
    cfg: ModelConfig
    shape: Shape
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1
    source: str = "synthetic"          # synthetic | memmap
    memmap_path: str | None = None
    _mm: np.ndarray | None = dataclasses.field(default=None, repr=False)

    def batch(self, step: int) -> dict:
        if self.source == "synthetic":
            return synthetic_batch(self.cfg, self.shape, seed=self.seed,
                                   step=step, host_id=self.host_id,
                                   n_hosts=self.n_hosts)
        if self._mm is None:
            self._mm = np.memmap(self.memmap_path, dtype=np.int32, mode="r")
        B, S = self.shape.global_batch, self.shape.seq_len
        b = B // self.n_hosts
        n_docs = len(self._mm) // S
        rows = []
        for r in range(b):
            g_row = self.host_id * b + r
            rng = _rng_for(self.seed, step, g_row)
            d = int(rng.integers(0, n_docs))
            rows.append(np.asarray(self._mm[d * S:(d + 1) * S]))
        return {"tokens": np.stack(rows)}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1
