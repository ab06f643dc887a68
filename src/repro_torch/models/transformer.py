"""The LM stack: one `forward()` for train / prefill / decode.

The port of the JAX package's `models/transformer.py`, for all ten
configs: dense decoders, MoE (llama4-maverick top-1, mixtral top-2 +
sliding window), SSM (mamba2's SSD), the hybrid (recurrentgemma: RG-LRU,
RG-LRU, local attention), the hubert encoder and the qwen2-vl backbone.
Parameters are a nested dict in the reference's tree: the layers of each
block-pattern period stacked along a leading axis (`params["stack"]`, a
tuple with one dict per period position), remainder layers unstacked
(`params["tail"]`).  The reference scans over the stack; here a Python
loop takes one layer at a time, from views that `unbind` makes once a
forward (indexing `stack[i]` per layer would make each layer's backward
write a zero tensor the size of the whole stack).

Tensor parallelism: under an active `dist.axis_rules` whose 'model' axis
has more than one rank, each rank runs the same program on its slices,
cut where the reference annotates (`dist.local_slices`): attention on its
query heads (`_Heads`: the kv heads they read, the GQA group kept), the
MLP on its `d_ff` slice, each product summed over 'model' after its cut
contraction (`wo`, `w_down`); the embedding looks up the rank's vocab
rows and sums over 'model'; the head's logits are the rank's vocab slice
and the cross-entropy is vocab-parallel (`_VocabCE`: max and sum-exp
reduced over 'model', the gold logit from the rank that owns it).  Norms
stay replicated.  `compute_cuts` names the slice of every parameter leaf
a rank computes with (`dist.Cut`).  On one device, and outside a
context, every layer takes its one-device path.

Training: `lm_loss` (next-token CE, or per-position CE for the encoder,
plus 0.01 x the MoE load-balancing loss), monolithic through
`forward(mode="train")` or, with `cfg.loss_chunk > 0`, the head and the
CE chunk by chunk (`_trunk`).  `cfg.remat` checkpoints each block-pattern
period (`torch.utils.checkpoint`, non-reentrant), as the reference's
`jax.checkpoint` of its scan body: only the period's input is kept, and
the period runs again in the backward.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as tdist
from torch.utils.checkpoint import checkpoint

from repro_torch import dist
from repro_torch.core.layout import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (ModelConfig, dense_init, norm,
                                       normal_init, rope_tables, tree_map)

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


def _unbind(tree, n: int) -> list:
    """The `n` layers of a stacked subtree, each leaf `unbind` once (views,
    no copy; one backward node a leaf, whose gradient is stacked once)."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(tree.unbind(0))


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
    cut = _mlp_cut(cfg)
    if cut:
        x = dist.to_model(x)
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
    if cut:
        y = dist.sum_over_model(y)
    return y, torch.zeros((), dtype=torch.float32, device=x.device)


def _mlp_cut(cfg: ModelConfig) -> bool:
    """Does this rank hold a slice of `d_ff` (tensor parallel)?"""
    return dist.model_axis() is not None and \
        dist.local_slice(cfg.d_ff, "mlp")[1] < cfg.d_ff


class _Heads(NamedTuple):
    """This rank's attention heads under tensor parallelism: query heads
    [q0, q0 + nq), the kv heads [kv0, kv0 + nkv) they read (a cut of its
    own where the kv heads replicate, `partial`), and `expand` (each query
    head's kv head, when the rank's query heads are no whole GQA groups of
    those kv heads), else None."""

    q0: int
    nq: int
    kv0: int
    nkv: int
    partial: bool
    expand: tuple | None


def _heads(cfg: ModelConfig) -> _Heads | None:
    """This rank's heads, or None where attention is not cut (one device,
    no context, or a head count the 'model' axis does not divide: every
    rank then computes the whole attention, as the reference replicates
    it)."""
    if dist.model_axis() is None:
        return None
    q0, nq = dist.local_slice(cfg.n_heads, "heads")
    if nq == cfg.n_heads:
        return None
    kv0, nkv = dist.local_slice(cfg.n_kv_heads, "kv_heads")
    if nkv < cfg.n_kv_heads:
        return _Heads(q0, nq, kv0, nkv, False, None)
    group = cfg.n_heads // cfg.n_kv_heads
    own = [(q0 + i) // group for i in range(nq)]
    kv0, nkv = own[0], own[-1] - own[0] + 1
    per = nq // nkv
    expand = None
    if nq % nkv or any(h - kv0 != i // per for i, h in enumerate(own)):
        expand = tuple(h - kv0 for h in own)
    return _Heads(q0, nq, kv0, nkv, True, expand)


def _attn_apply(x, p, cfg: ModelConfig, positions, cache, mode,
                max_len: int = 0, rope=None):
    """The attention mixer.  In decode mode `cache` ({"k", "v"}
    [b, S, kvh, hd]) is written in place at each row's position: the
    caller hands over a private copy (`forward` clones the cache it was
    given once).  `rope`: `rope_tables` of `positions`, or None."""
    heads = _heads(cfg)
    if heads is not None:
        x = dist.to_model(x)
    q, k, v = attn.attn_qkv(x, p["wq"], p["wk"], p["wv"], positions, cfg,
                            rope)
    if heads is not None and heads.expand is not None:
        idx = torch.tensor(heads.expand, device=x.device)
        k, v = k.index_select(2, idx), v.index_select(2, idx)
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
    if heads is not None:
        y = dist.sum_over_model(y)
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
        v0, nv = dist.local_slice(cfg.vocab, "vocab")
        if dist.model_axis() is not None and nv < cfg.vocab:
            # vocab-parallel: this rank's rows, zeros elsewhere, summed
            idx = tokens.long() - v0
            own = (idx >= 0) & (idx < nv)
            x = params["embed"].to(cdt)[idx.clamp(0, nv - 1)]
            x = dist.sum_over_model(torch.where(own[..., None], x, 0.0))
        else:
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
    if n_full and mode == "train":
        x, aux_acc = _train_stack(params, cfg, x, positions, rope)
    elif n_full:
        layers = [_unbind(p, n_full) for p in params["stack"]]
        per_pos = [[] for _ in range(period)]
        for i in range(n_full):
            for j, kind in enumerate(cfg.block_pattern):
                c_in = (_index(cache["stack"][j], i) if mode == "decode"
                        else None)
                x, nc, aux = apply_layer(x, layers[j][i], kind, cfg,
                                         positions, c_in, mode, max_len,
                                         rope)
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


# ---------------------------------------------------------------------------
# Training: the layer stack under remat, and the losses
# ---------------------------------------------------------------------------

def _train_stack(params, cfg: ModelConfig, x, positions, rope):
    """The stacked periods in train mode, each under `checkpoint` when
    `cfg.remat` (the reference's `jax.checkpoint` of its scan body).
    Returns (x, the periods' aux loss summed)."""
    period = len(cfg.block_pattern)
    n_full = cfg.n_layers // period
    layers = [_unbind(p, n_full) for p in params["stack"]]

    def period_body(x, layer_ps):
        aux_tot = torch.zeros((), dtype=torch.float32, device=x.device)
        for j, kind in enumerate(cfg.block_pattern):
            x, _, aux = apply_layer(x, layer_ps[j], kind, cfg, positions,
                                    None, "train", 0, rope)
            aux_tot = aux_tot + aux
        return x, aux_tot

    aux_acc = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_full):
        layer_ps = [layers[j][i] for j in range(period)]
        if cfg.remat:
            x, aux = checkpoint(period_body, x, layer_ps,
                                use_reentrant=False)
        else:
            x, aux = period_body(x, layer_ps)
        aux_acc = aux_acc + aux
    return x, aux_acc


def _trunk(params, cfg: ModelConfig, x, positions):
    """Train-mode layer stack + final norm, head NOT applied.
    Returns (hidden [b,t,d], aux_loss)."""
    period = len(cfg.block_pattern)
    n_full, tail_n = cfg.n_layers // period, cfg.n_layers % period
    rope = rope_tables(positions, cfg.hd, cfg.rope_theta,
                       cfg.mrope_sections)
    aux_acc = torch.zeros((), dtype=torch.float32, device=x.device)
    if n_full:
        x, aux_acc = _train_stack(params, cfg, x, positions, rope)
    for j in range(tail_n):
        x, _, aux = apply_layer(x, params["tail"][j],
                                cfg.block_pattern[j % period], cfg,
                                positions, None, "train", 0, rope)
        aux_acc = aux_acc + aux
    return norm(x, params["final_norm"], cfg), aux_acc


def _ce_terms(logits, targets):
    """logsumexp - gold logit per position, in fp32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return logz - gold


def _ce_from_logits(logits, targets):
    """The summed CE of `logits` [..., vocab] against int `targets`
    [...], in fp32."""
    return torch.sum(_ce_terms(logits, targets))


def _head(params, cfg: ModelConfig):
    return (params["embed"].T if cfg.tie_embeddings
            else params["head"]).to(cfg.cdtype())


def _chunk_ce(h, targets, valid, head, softcap: float, v0=None):
    """One loss chunk: the head projection and its CE, summed over the
    valid positions (`v0`: the first vocab row of a vocab-parallel
    head's cut)."""
    logits = torch.matmul(h, head)
    if softcap > 0:
        logits = softcap * torch.tanh(logits.float() / softcap)
    terms = _ce_terms(logits, targets) if v0 is None else \
        _VocabCE.apply(logits, targets, v0, dist.model_axis().group)
    return torch.sum(torch.where(valid[None, :], terms, 0.0))


def _chunked_ce(h, targets, head, cfg: ModelConfig, v0=None):
    """The CE of hidden states `h` [b, t, d] against `targets` [b, t],
    summed: `cfg.loss_chunk` chunks of positions (the last padded), each
    chunk's head projection and CE under `checkpoint`, so the [b, t,
    vocab] logits never materialise, forward or backward (the reference
    maps over the chunks with `lax.map`)."""
    tm1 = h.shape[1]
    nc = cfg.loss_chunk
    pad = (-tm1) % nc
    if pad:
        h = torch.nn.functional.pad(h, (0, 0, 0, pad))
        targets = torch.nn.functional.pad(targets, (0, pad))
    per = (tm1 + pad) // nc
    valid = (torch.arange(tm1 + pad, device=h.device) < tm1).reshape(nc, per)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for j in range(nc):
        sl = slice(j * per, (j + 1) * per)
        total = total + checkpoint(
            _chunk_ce, h[:, sl], targets[:, sl], valid[j], head,
            cfg.logit_softcap, v0, use_reentrant=False)
    return total


class _VocabCE(torch.autograd.Function):
    """`_ce_terms` of vocab-cut logits [..., V / m] (this rank's rows from
    `v0`): the max and the sum of exponentials reduced over 'model', the
    gold logit from the rank that owns it (a sum with the others' zeros);
    the backward is local: softmax - one-hot, on the rank's columns."""

    @staticmethod
    def forward(ctx, logits, targets, v0, group):
        lf = logits.float()
        nv = lf.shape[-1]
        m = lf.amax(-1)
        tdist.all_reduce(m, op=tdist.ReduceOp.MAX, group=group)
        p = torch.exp(lf - m[..., None])
        s = p.sum(-1)
        tdist.all_reduce(s, group=group)
        idx = targets.long() - v0
        own = (idx >= 0) & (idx < nv)
        safe = idx.clamp(0, nv - 1)
        gold = torch.where(own, torch.gather(lf, -1, safe[..., None])[..., 0],
                           0.0)
        tdist.all_reduce(gold, group=group)
        p.div_(s[..., None])
        ctx.save_for_backward(p, safe, own)
        ctx.dtype = logits.dtype
        return torch.log(s) + m - gold

    @staticmethod
    def backward(ctx, g):
        p, safe, own = ctx.saved_tensors
        grad = p * g[..., None]
        grad.scatter_add_(-1, safe[..., None],
                          -torch.where(own, g, 0.0)[..., None])
        return grad.to(ctx.dtype), None, None, None


def _vocab_start(cfg: ModelConfig):
    """The first vocab row of this rank's cut of the head, or None where
    the head is not cut."""
    if dist.model_axis() is None:
        return None
    v0, nv = dist.local_slice(cfg.vocab, "vocab")
    return v0 if nv < cfg.vocab else None


def lm_loss_terms(params, cfg: ModelConfig, batch: dict):
    """(the CE summed over this rank's targets, 0.01 x the MoE
    load-balancing loss): the parts of `lm_loss` a sharded step adds up
    over the batch axes, its loss the sum over the GLOBAL target count.
    Under tensor parallelism the head and the CE are vocab-parallel
    (`_VocabCE`), monolithic or, with `cfg.loss_chunk`, chunk by chunk."""
    targets = batch["tokens"] if cfg.input_mode == "tokens" \
        else batch["labels"]
    x, positions = embed_inputs(params, cfg, batch, "train")
    h, aux = _trunk(params, cfg, x, positions)
    head = _head(params, cfg)
    v0 = _vocab_start(cfg)
    if v0 is not None:
        h = dist.to_model(h)
    if cfg.causal:
        targets, h = targets[:, 1:], h[:, :-1]
    if cfg.loss_chunk and cfg.causal:
        return _chunked_ce(h, targets, head, cfg, v0), 0.01 * aux
    valid = torch.ones(h.shape[1], dtype=torch.bool, device=h.device)
    return _chunk_ce(h, targets, valid, head, cfg.logit_softcap, v0), \
        0.01 * aux


def compute_cuts(shapes, cfg: ModelConfig):
    """For a parameter tree of global shapes (tuples), the `dist.Cut`
    each leaf is computed with on this rank under the active context:
    the embedding and head by vocab rows, `wq` / `wo` by query heads,
    `wk` / `wv` by the kv heads the rank's query heads read, the MLP by
    `d_ff`; the whole leaf elsewhere (norms, the features projection,
    `vision_proj`, and any dim the 'model' axis does not divide)."""
    heads = _heads(cfg)
    v0 = _vocab_start(cfg)
    nv = cfg.vocab // dist.model_axis().size if v0 is not None else 0
    f0, nf = dist.local_slice(cfg.d_ff, "mlp") if cfg.d_ff else (0, 0)
    mlp = _mlp_cut(cfg) if cfg.d_ff and not cfg.is_moe else False

    def layer(p, lead):
        out = {}
        for name, x in p.items():
            if isinstance(x, dict):
                out[name] = layer(x, lead) if name in ("attn", "mlp") \
                    else tree_map(lambda _: dist.Cut(), x)
                continue
            if name in ("wq", "wo") and heads is not None:
                d = lead + (1 if name == "wq" else 0)
                out[name] = dist.Cut(d, heads.q0, heads.nq)
            elif name in ("wk", "wv") and heads is not None:
                out[name] = dist.Cut(lead + 1, heads.kv0, heads.nkv,
                                     heads.partial)
            elif name in ("w_up", "w_gate", "w_down") and mlp:
                d = lead + (0 if name == "w_down" else 1)
                out[name] = dist.Cut(d, f0, nf)
            else:
                out[name] = dist.Cut()
        return out

    cuts = {}
    for name, x in shapes.items():
        if name == "stack":
            cuts[name] = tuple(layer(p, 1) for p in x)
        elif name == "tail":
            cuts[name] = tuple(layer(p, 0) for p in x)
        elif name == "embed" and cfg.input_mode == "tokens" and \
                v0 is not None:
            cuts[name] = dist.Cut(0, v0, nv)
        elif name == "head" and v0 is not None:
            cuts[name] = dist.Cut(1, v0, nv)
        else:
            cuts[name] = dist.Cut()
    return cuts


def lm_loss(params, cfg: ModelConfig, batch: dict):
    """Next-token CE (causal) / per-position CE (encoder).  Scalar mean,
    plus 0.01 x the MoE load-balancing loss.

    With cfg.loss_chunk > 0 (causal) the CE is `_chunked_ce`'s."""
    targets = batch["tokens"] if cfg.input_mode == "tokens"         else batch["labels"]
    if cfg.loss_chunk and cfg.causal:
        x, positions = embed_inputs(params, cfg, batch, "train")
        h, aux = _trunk(params, cfg, x, positions)
        b, tm1 = targets.shape[0], targets.shape[1] - 1
        total = _chunked_ce(h[:, :-1], targets[:, 1:], _head(params, cfg),
                            cfg)
        return total / (b * tm1) + 0.01 * aux

    logits, _, aux = forward(params, cfg, batch, mode="train")
    if cfg.causal:
        targets = targets[:, 1:]
        logits = logits[:, :-1]
    return torch.mean(_ce_terms(logits, targets)) + 0.01 * aux
