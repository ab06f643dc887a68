"""The LM stack: one `forward()` for train / prefill / decode.

The port of the JAX package's `models/transformer.py`, for all ten
configs: dense decoders, MoE (llama4-maverick top-1, mixtral top-2 +
sliding window), SSM (mamba2's SSD), the hybrid (recurrentgemma: RG-LRU,
RG-LRU, local attention), the hubert encoder and the qwen2-vl backbone.
Parameters are a nested dict in the reference's tree: the layers of each
block-pattern period stacked along a leading axis (`params["stack"]`, a
tuple with one dict per period position), remainder layers unstacked
(`params["tail"]`).  The reference scans over the stack; here a Python
loop indexes it, one layer at a time.  `dist.shard` is the identity on
one device and is dropped.

Not ported yet: `lm_loss` (the training path, ROADMAP Queue 1 item 5d),
which raises NotImplementedError.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.layout import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (ModelConfig, dense_init, norm,
                                       normal_init, rope_tables)

MODES = ("train", "prefill", "decode")


def _generator(seed: int, device) -> torch.Generator | None:
    if torch.device(device).type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(seed)


class _Init:
    """The weight draws (`dense_init`, `normal_init`) over one generator,
    in the reference's order of leaves; a stacked leaf draws each layer's
    slice in turn, in place."""

    def __init__(self, seed: int, device):
        self.device = resolve_device(device)
        self.gen = _generator(seed, self.device)

    def __call__(self, shape, dtype, scale=None, *, layers: int = 0):
        return self._stacked(lambda out: dense_init(
            self.gen, shape, dtype, scale, device=self.device, out=out),
            shape, dtype, layers)

    def normal(self, shape, dtype, std, *, layers: int = 0):
        """A normal of standard deviation `std` (the recurrent blocks')."""
        return self._stacked(lambda out: normal_init(
            self.gen, shape, dtype, std, device=self.device, out=out),
            shape, dtype, layers)

    def const(self, value: torch.Tensor, *, layers: int = 0):
        """`value` (made on the CPU, fp32) on the device, per layer."""
        value = value.to(self.device)
        return value.expand(layers, *value.shape).clone() if layers \
            else value

    def _stacked(self, draw, shape, dtype, layers):
        if not layers:
            return draw(None)
        out = torch.empty((layers, *shape), dtype=dtype, device=self.device)
        for i in range(layers):
            draw(out[i])
        return out


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def _init_mlp(init: _Init, cfg: ModelConfig, dtype, layers: int) -> dict:
    """The MLP's weights, or with experts the fp32 router and [E, ...]
    expert weights."""
    d, f = cfg.d_model, cfg.d_ff
    lead = (cfg.n_experts,) if cfg.is_moe else ()
    p = {}
    if cfg.is_moe:
        p["router"] = init((d, cfg.n_experts), torch.float32, layers=layers)
    p["w_up"] = init((*lead, d, f), dtype, layers=layers)
    p["w_down"] = init((*lead, f, d), dtype, layers=layers)
    if cfg.mlp == "swiglu":
        p["w_gate"] = init((*lead, d, f), dtype, layers=layers)
    return p


def _init_layer(init: _Init, kind: str, cfg: ModelConfig, dtype,
                layers: int = 0) -> dict:
    """One layer's parameters of block kind `kind` (`layers` of them
    stacked): its mixer, then (d_ff > 0) its MLP or MoE."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    lead = (layers,) if layers else ()

    def zeros(*shape):
        return torch.zeros((*lead, *shape), dtype=torch.float32,
                           device=init.device)

    p: dict[str, Any] = {"norm_mix": zeros(d)}
    if kind == "attn":
        p["attn"] = {"wq": init((d, h, hd), dtype, layers=layers),
                     "wk": init((d, kv, hd), dtype, layers=layers),
                     "wv": init((d, kv, hd), dtype, layers=layers),
                     "wo": init((h, hd, d), dtype, layers=layers)}
    elif kind == "ssm":
        p["ssm"] = ssm_mod.init_ssm_params(init, cfg, dtype, layers)
    elif kind == "rglru":
        p["rglru"] = rglru_mod.init_rglru_params(init, cfg, dtype, layers)
    else:
        raise ValueError(kind)
    if cfg.d_ff > 0:
        p["norm_mlp"] = zeros(d)
        p["mlp"] = _init_mlp(init, cfg, dtype, layers)
    return p


def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda") -> dict:
    """Random parameters in the reference's tree and shapes, with
    `dense_init`'s scales, drawn on `device` from a `torch.Generator`
    seeded with `seed` (the draws are not the reference's: to hold the
    port to the reference, convert its `init_params` with
    `repro_torch.convert.model_params`).  `device="meta"` gives the
    shapes alone."""
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
        params["stack"] = tuple(_init_layer(init, kind, cfg, dtype, n_full)
                                for kind in cfg.block_pattern)
    if tail_n:
        params["tail"] = tuple(
            _init_layer(init, cfg.block_pattern[j % period], cfg, dtype)
            for j in range(tail_n))
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
# KV / state caches
# ---------------------------------------------------------------------------

def _attn_cache_len(cfg: ModelConfig, max_len: int) -> int:
    return min(max_len, cfg.window) if cfg.window > 0 else max_len


def init_layer_cache(kind: str, cfg: ModelConfig, batch: int, max_len: int,
                     dtype, *, device="cuda"):
    if kind == "ssm":
        return ssm_mod.init_ssm_cache(batch, cfg, dtype, device=device)
    if kind == "rglru":
        return rglru_mod.init_rglru_cache(batch, cfg, dtype, device=device)
    if kind != "attn":
        raise ValueError(kind)
    shape = (batch, _attn_cache_len(cfg, max_len), cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda") -> dict:
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
        # Decode never drops tokens (serving must be exact); train and
        # prefill use capacity-factor dispatch unless the config is
        # dropless.
        dropless = cfg.moe_dropless or mode == "decode"
        return moe_mod.moe_ffn(x, p["router"], p.get("w_gate"), p["w_up"],
                               p["w_down"], cfg, dropless=dropless)
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
    """Pre-norm temporal mixer + (optional) MLP / MoE, residual wiring.
    `rope`: the forward's `rope_tables`, shared by its layers, or None.
    In decode every mixer writes its new state into `cache` in place;
    prefill returns the new state, train None."""
    h = norm(x, p["norm_mix"], cfg)
    if kind == "attn":
        y, new_cache = _attn_apply(h, p["attn"], cfg, positions, cache,
                                   mode, max_len, rope)
    elif kind in ("ssm", "rglru"):
        block = ssm_mod.ssm_block if kind == "ssm" else rglru_mod.rglru_block
        y, new_cache = block(h, p[kind], cfg,
                             cache=cache if mode == "decode" else None)
        if mode == "train":
            new_cache = None
    else:
        raise ValueError(kind)
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
                if mode != "decode":     # decode wrote its views in place
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
        "lm_loss and training are not ported yet (ROADMAP Queue 1 item 5d)")
