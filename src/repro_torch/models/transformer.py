"""The LM stack: one `forward()` for train / prefill / decode.

The port of the JAX package's `models/transformer.py`, for the configs
whose layers are all attention without experts (dense decoders, the
qwen2-vl backbone, the hubert encoder).  Parameters are a nested dict in
the reference's tree: the layers of each block-pattern period stacked
along a leading axis (`params["stack"]`, a tuple with one dict per period
position), remainder layers unstacked (`params["tail"]`).  The reference
scans over the stack; here a Python loop indexes it, one layer at a time.
`dist.shard` is the identity on one device and is dropped.

Not ported yet, each raising NotImplementedError (ROADMAP Queue 1 item
5): mixture-of-experts MLPs, SSM and RG-LRU blocks, and `lm_loss` (the
training path).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.layout import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.common import (ModelConfig, check_ported, dense_init,
                                       norm, rope_tables)

MODES = ("train", "prefill", "decode")


def _generator(seed: int, device) -> torch.Generator | None:
    if torch.device(device).type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(seed)


class _Init:
    """`dense_init` over one generator, drawn in the reference's order of
    leaves; a stacked leaf draws each layer's slice in turn."""

    def __init__(self, seed: int, device):
        self.device = resolve_device(device)
        self.gen = _generator(seed, self.device)

    def __call__(self, shape, dtype, scale=None, *, layers: int = 0):
        if not layers:
            return dense_init(self.gen, shape, dtype, scale,
                              device=self.device)
        out = torch.empty((layers, *shape), dtype=dtype, device=self.device)
        if self.device.type != "meta":
            for i in range(layers):
                out[i] = dense_init(self.gen, shape, dtype, scale,
                                    device=self.device)
        return out


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def _init_layer(init: _Init, cfg: ModelConfig, dtype,
                layers: int = 0) -> dict:
    """One attention layer's parameters (`layers` of them stacked)."""
    d, h, kv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                       cfg.d_ff)
    lead = (layers,) if layers else ()

    def zeros(*shape):
        return torch.zeros((*lead, *shape), dtype=torch.float32,
                           device=init.device)

    p: dict[str, Any] = {"norm_mix": zeros(d)}
    p["attn"] = {"wq": init((d, h, hd), dtype, layers=layers),
                 "wk": init((d, kv, hd), dtype, layers=layers),
                 "wv": init((d, kv, hd), dtype, layers=layers),
                 "wo": init((h, hd, d), dtype, layers=layers)}
    if cfg.d_ff > 0:
        p["norm_mlp"] = zeros(d)
        mlp = {"w_up": init((d, f), dtype, layers=layers),
               "w_down": init((f, d), dtype, layers=layers)}
        if cfg.mlp == "swiglu":
            mlp["w_gate"] = init((d, f), dtype, layers=layers)
        p["mlp"] = mlp
    return p


def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda") -> dict:
    """Random parameters in the reference's tree and shapes, with
    `dense_init`'s scales, drawn on `device` from a `torch.Generator`
    seeded with `seed` (the draws are not the reference's: to hold the
    port to the reference, convert its `init_params` with
    `repro_torch.convert.model_params`).  `device="meta"` gives the
    shapes alone."""
    check_ported(cfg)
    dtype = cfg.pdtype()
    period = len(cfg.block_pattern)
    n_full, tail_n = cfg.n_layers // period, cfg.n_layers % period
    init = _Init(seed, device)
    params: dict[str, Any] = {}
    if cfg.input_mode == "tokens":
        params["embed"] = init((cfg.vocab, cfg.d_model), dtype, scale=1.0)
    else:
        params["embed"] = init((cfg.feature_dim, cfg.d_model), dtype)
    if cfg.family == "vlm":
        params["vision_proj"] = init((cfg.d_model, cfg.d_model), dtype)
    if n_full:
        params["stack"] = tuple(_init_layer(init, cfg, dtype, n_full)
                                for _ in range(period))
    if tail_n:
        params["tail"] = tuple(_init_layer(init, cfg, dtype)
                               for _ in range(tail_n))
    params["final_norm"] = torch.zeros((cfg.d_model,), dtype=torch.float32,
                                       device=init.device)
    if not cfg.tie_embeddings:
        params["head"] = init((cfg.d_model, cfg.vocab), dtype)
    return params


def _index(tree, i: int):
    """Layer `i` of a stacked subtree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# KV caches
# ---------------------------------------------------------------------------

def _attn_cache_len(cfg: ModelConfig, max_len: int) -> int:
    return min(max_len, cfg.window) if cfg.window > 0 else max_len


def init_layer_cache(kind: str, cfg: ModelConfig, batch: int, max_len: int,
                     dtype, *, device="cuda"):
    if kind != "attn":
        check_ported(cfg)
    shape = (batch, _attn_cache_len(cfg, max_len), cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda") -> dict:
    check_ported(cfg)
    device = resolve_device(device)
    dtype = cfg.cdtype()
    period = len(cfg.block_pattern)
    n_full, tail_n = cfg.n_layers // period, cfg.n_layers % period
    cache: dict[str, Any] = {}
    if n_full:
        cache["stack"] = tuple(
            {name: x[None].expand(n_full, *x.shape).clone()
             for name, x in init_layer_cache(k, cfg, batch, max_len, dtype,
                                             device=device).items()}
            for k in cfg.block_pattern)
    if tail_n:
        cache["tail"] = tuple(
            init_layer_cache(cfg.block_pattern[j % period], cfg, batch,
                             max_len, dtype, device=device)
            for j in range(tail_n))
    return cache


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------

def _mlp_apply(x, p, cfg: ModelConfig, mode: str = "train"):
    if cfg.is_moe:
        check_ported(cfg)
    u = attn.project(x, p["w_up"])
    if cfg.mlp == "swiglu":
        g = attn.project(x, p["w_gate"])
        h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    elif cfg.mlp == "sqrelu":
        h = torch.square(torch.relu(u.float())).to(x.dtype)
    else:  # gelu (jax.nn.gelu's default: the tanh approximation)
        h = torch.nn.functional.gelu(u.float(), approximate="tanh").to(
            x.dtype)
    y = attn.project(h, p["w_down"])
    return y, torch.zeros((), dtype=torch.float32, device=x.device)


def _attn_apply(x, p, cfg: ModelConfig, positions, cache, mode,
                max_len: int = 0, rope=None):
    """The attention mixer.  In decode mode `cache` ({"k", "v"}
    [b, S, kvh, hd]) is written in place at each row's position: the
    caller hands over a private copy (`forward` clones the cache it was
    given once).  `rope`: `rope_tables` of `positions`, or None."""
    q, k, v = attn.attn_qkv(x, p["wq"], p["wk"], p["wv"], positions, cfg,
                            rope)
    if mode == "decode":
        pos = positions[:, 0, 0] if cfg.mrope_sections else positions[:, 0]
        W = cache["k"].shape[1]
        slot = (pos % W if cfg.window > 0 else pos).long()
        b_idx = torch.arange(x.shape[0], device=x.device)
        k_cache, v_cache = cache["k"], cache["v"]
        k_cache[b_idx, slot] = k[:, 0]
        v_cache[b_idx, slot] = v[:, 0]
        if cfg.window > 0:
            j = torch.arange(W, dtype=torch.int32, device=x.device)
            kpos = pos[:, None] - torch.remainder(pos[:, None] - j[None, :],
                                                  W)
            o = attn.ring_decode_attention(q, k_cache, v_cache, pos, kpos,
                                           cfg.window)
        else:
            o = attn.decode_attention(q, k_cache, v_cache, pos,
                                      window=cfg.window)
        new_cache = {"k": k_cache, "v": v_cache}
    else:
        o = attn.flash_attention(q, k, v, causal=cfg.causal,
                                 window=cfg.window, q_block=cfg.q_block,
                                 kv_block=cfg.kv_block,
                                 score_dtype=_DT[cfg.score_dtype])
        if mode == "prefill":
            # Keys of position p land at slot p % L (a ring for windowed
            # attention; identity for full attention, L == max_len >= T).
            T = k.shape[1]
            L = _attn_cache_len(cfg, max(max_len, T))
            if T == L:
                new_cache = {"k": k, "v": v}
            elif T < L:
                pad = (0, 0, 0, 0, 0, L - T)
                new_cache = {"k": torch.nn.functional.pad(k, pad),
                             "v": torch.nn.functional.pad(v, pad)}
            else:  # windowed: keep the last L positions, ring layout
                slot = torch.arange(T - L, T, device=x.device) % L
                new_cache = {}
                for name, t in (("k", k), ("v", v)):
                    ring = torch.zeros_like(t[:, :L])
                    ring[:, slot] = t[:, T - L:]
                    new_cache[name] = ring
        else:
            new_cache = None
    y = attn.attn_out(o, p["wo"], x.dtype)
    return y, new_cache


_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def apply_layer(x, p, kind: str, cfg: ModelConfig, positions, cache, mode,
                max_len: int = 0, rope=None):
    """Pre-norm temporal mixer + (optional) MLP, residual wiring.  `rope`:
    the forward's `rope_tables`, shared by its layers, or None."""
    if kind != "attn":
        check_ported(cfg)
    h = norm(x, p["norm_mix"], cfg)
    y, new_cache = _attn_apply(h, p["attn"], cfg, positions, cache, mode,
                               max_len, rope)
    x = x + y
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.d_ff > 0:
        h = norm(x, p["norm_mlp"], cfg)
        y, aux = _mlp_apply(h, p["mlp"], cfg, mode)
        x = x + y
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# Full forward
# ---------------------------------------------------------------------------

def embed_inputs(params, cfg: ModelConfig, batch: dict, mode: str):
    """Returns (x [b,t,d], positions)."""
    cdt = cfg.cdtype()
    if cfg.input_mode == "features":
        x = torch.einsum("btf,fd->btd", batch["features"].to(cdt),
                         params["embed"].to(cdt))
        b, t = x.shape[:2]
        dev = x.device
    else:
        tokens = batch["tokens"]
        b, t = tokens.shape
        dev = tokens.device
        x = params["embed"].to(cdt)[tokens.long()]
        if cfg.family == "vlm" and "vision_embeds" in batch:
            ve = torch.einsum("bpd,de->bpe", batch["vision_embeds"].to(cdt),
                              params["vision_proj"].to(cdt))
            x = torch.cat([ve, x[:, ve.shape[1]:]], dim=1)
    if mode == "decode":
        pos = batch["pos"].to(torch.int32)
        positions = (pos[:, None, None].expand(b, 1, 3)
                     if cfg.mrope_sections else pos[:, None])
    elif "positions" in batch:
        positions = batch["positions"]
    else:
        ar = torch.arange(t, dtype=torch.int32, device=dev)
        positions = (ar[None, :, None].expand(b, t, 3)
                     if cfg.mrope_sections else ar[None, :].expand(b, t))
    return x, positions


def forward(params, cfg: ModelConfig, batch: dict, *, mode: str = "train",
            cache=None, max_len: int = 0):
    """mode: train (no cache) | prefill (build cache) | decode (use cache).

    `max_len` sizes the prefill cache (>= prompt length) so later decode
    steps have headroom; 0 means exactly the prompt length.  In decode
    mode the cache is copied once and the copy updated, so the caller's
    stays valid (the reference's functional update).

    Returns (logits, new_cache, aux_loss)."""
    check_ported(cfg)
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    x, positions = embed_inputs(params, cfg, batch, mode)
    period = len(cfg.block_pattern)
    n_full, tail_n = cfg.n_layers // period, cfg.n_layers % period
    aux_acc = torch.zeros((), dtype=torch.float32, device=x.device)
    if mode == "decode":
        cache = _clone(cache)
    rope = rope_tables(positions, cfg.hd, cfg.rope_theta,
                       cfg.mrope_sections)

    stack_cache = None
    if n_full:
        per_pos = [[] for _ in range(period)]
        for i in range(n_full):
            for j, kind in enumerate(cfg.block_pattern):
                c_in = (_index(cache["stack"][j], i) if mode == "decode"
                        else None)
                x, nc, aux = apply_layer(x, _index(params["stack"][j], i),
                                         kind, cfg, positions, c_in, mode,
                                         max_len, rope)
                per_pos[j].append(nc)
                aux_acc = aux_acc + aux
        if mode == "decode":
            stack_cache = cache["stack"]        # written in place
        elif mode == "prefill":
            stack_cache = tuple(
                {name: torch.stack([c[name] for c in cs])
                 for name in cs[0]} for cs in per_pos)

    tail_cache = []
    for j in range(tail_n):
        c_in = cache["tail"][j] if mode == "decode" else None
        x, nc, aux = apply_layer(x, params["tail"][j],
                                 cfg.block_pattern[j % period], cfg,
                                 positions, c_in, mode, max_len, rope)
        tail_cache.append(nc)
        aux_acc = aux_acc + aux

    if mode == "prefill":
        # Serving prefill needs the last position's logits only: slice
        # BEFORE the head so [b, t, vocab] never materializes.
        x = x[:, -1:]
    x = norm(x, params["final_norm"], cfg)
    head = (params["embed"].T if cfg.tie_embeddings
            else params["head"]).to(cfg.cdtype())
    logits = torch.matmul(x, head)
    if cfg.logit_softcap > 0:
        logits = cfg.logit_softcap * torch.tanh(
            logits.float() / cfg.logit_softcap)

    new_cache = None
    if mode in ("prefill", "decode"):
        new_cache = {}
        if stack_cache is not None:
            new_cache["stack"] = stack_cache
        if tail_n:
            new_cache["tail"] = tuple(tail_cache)
    return logits, new_cache, aux_acc


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone(v) for v in tree)
    return tree.clone()


def lm_loss(params, cfg: ModelConfig, batch: dict):
    """Next-token CE: the training path, not ported yet."""
    raise NotImplementedError(
        "lm_loss and training are not ported yet (ROADMAP Queue 1 item 5)")
