"""Mixture-of-Experts FFN with capacity-based token dispatch.

The port of the JAX package's `models/moe.py`.  Tokens pick their top-k
experts; within each expert, (token, choice) pairs are ranked by a stable
sort and those at rank C or beyond are dropped, C = ceil(T/E * cf * k)
(`dropless`: C = T, nothing dropped).  Dispatch scatters each kept pair to
row expert * C + rank of an [E * C, d] buffer, the experts run as one
batched product per weight, and the combine gathers each pair's row back,
weighted by its gate, in fp32.

`cfg.moe_groups > 1` (not dropless, T divisible by it) splits the tokens
into G groups, each routed on its own with capacity C / G; G = 1 is the
reference's global dispatch.  Both run here as one path with a leading
group axis.  The reference's `dist.shard` is the identity on one device
and is dropped.

Ties: `lax.top_k` takes the lower expert index on equal probabilities, so
the top k here are the first k of a stable descending sort; the rank's
segment-start max-scan is `torch.cummax`, equal to the reference's
integer `associative_scan`.  The router runs in fp32 whatever the model's
dtype.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.models.common import ModelConfig

# The expert products run over slices of experts whose [experts, C, d_ff]
# intermediates stay under this many bytes each: a dropless dispatch has C
# = T, and all E experts at once would not fit beside the weights.
EXPERT_SLICE_BYTES = 1 << 30


class Routing(NamedTuple):
    """Each (token, choice) pair's routing, per group: [G, Tg, topk]."""

    expert_idx: torch.Tensor       # int64: the chosen experts, best first
    gates: torch.Tensor            # fp32: their (renormalised) probabilities
    rank: torch.Tensor             # int64: the pair's rank in its expert
    keep: torch.Tensor             # bool: rank < C
    dest: torch.Tensor             # int64: expert * C + rank, or E * C
    aux: torch.Tensor              # fp32 [G]: the load-balancing loss


def group_capacity(cfg: ModelConfig, T: int,
                   dropless: bool) -> tuple[int, int]:
    """(G, C): the dispatch groups and each group's capacity for T
    tokens."""
    E, topk = cfg.n_experts, cfg.top_k
    G = cfg.moe_groups if (cfg.moe_groups > 1 and not dropless
                           and T % cfg.moe_groups == 0) else 1
    Tg = T // G
    if dropless:
        C = Tg
    else:
        C = int(math.ceil(Tg / E * cfg.capacity_factor * max(topk, 1)))
    return G, max(C, 1)


def moe_ffn(x, router_w, w_gate, w_up, w_down, cfg: ModelConfig,
            dropless: bool = False):
    """x: [b, s, d].  router_w: [d, E].  experts: [E, d, f] / [E, f, d].

    `dropless=True` sizes capacity at the worst case (C = T), so no token
    is dropped: decode and `cfg.moe_dropless` use it.  Returns ([b, s, d]
    in x's dtype, aux_loss scalar)."""
    b, s, d = x.shape
    E = cfg.n_experts
    G, C = group_capacity(cfg, b * s, dropless)
    xg = x.reshape(G, -1, d)
    r = route(xg, router_w, cfg, C)
    buf = dispatch(xg, r.dest, E * C)
    out_e = experts(buf.view(G, E, C, d), w_gate, w_up, w_down, cfg.mlp)
    y = combine(out_e.reshape(G, E * C, d), r)
    return y.to(x.dtype).reshape(b, s, d), r.aux.mean()


def route(xg, router_w, cfg: ModelConfig, C: int) -> Routing:
    """Routing only, per group.  xg: [G, Tg, d]."""
    E, topk = cfg.n_experts, cfg.top_k
    logits = torch.matmul(xg.float(), router_w.float())       # [G, Tg, E]
    probs = torch.softmax(logits, dim=-1)
    gates, expert_idx = top_k(probs, topk)
    if topk > 1:
        gates = gates / gates.sum(-1, keepdim=True)
    # load-balancing auxiliary loss (Switch-style)
    me = probs.mean(1)                                         # [G, E]
    ce = torch.nn.functional.one_hot(expert_idx[..., 0], E).float().mean(1)
    aux = E * (me * ce).sum(-1)
    rank = expert_rank(expert_idx)
    keep = rank < C
    dest = torch.where(keep, expert_idx * C + rank,
                       torch.full_like(rank, E * C))
    return Routing(expert_idx, gates, rank, keep, dest, aux)


def top_k(probs, k: int):
    """`lax.top_k` along the last dim: the k largest, ties to the lower
    index (the first k of a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def expert_rank(expert_idx):
    """Rank of each (token, choice) pair among the pairs routed to its
    expert, in (token, choice) order.  expert_idx: [G, Tg, topk]."""
    G = expert_idx.shape[0]
    flat = expert_idx.reshape(G, -1)
    sort_idx = torch.argsort(flat, dim=-1, stable=True)
    sorted_expert = torch.gather(flat, -1, sort_idx)
    ar = torch.arange(flat.shape[1], device=flat.device).expand_as(flat)
    seg_start = torch.ones_like(flat, dtype=torch.bool)
    seg_start[:, 1:] = sorted_expert[:, 1:] != sorted_expert[:, :-1]
    # index of each element's segment start (the reference's inclusive
    # max-scan; position 0 always starts a segment)
    start_pos = torch.cummax(torch.where(seg_start, ar, -1), dim=-1).values
    rank = torch.empty_like(flat).scatter_(-1, sort_idx, ar - start_pos)
    return rank.view(expert_idx.shape)


def dispatch(xg, dest, rows: int):
    """[G, rows, d]: row dest of group g holds token t's input for each
    kept pair (dest = rows for a dropped pair, which lands in a spare row
    that is cut off: the reference's `mode="drop"`)."""
    G, Tg, d = xg.shape
    buf = xg.new_zeros((G, rows + 1, d))
    g_idx = torch.arange(G, device=xg.device)[:, None]
    for j in range(dest.shape[-1]):
        buf[g_idx, dest[..., j]] = xg
    return buf[:, :rows]


def experts(buf, w_gate, w_up, w_down, mlp: str):
    """The expert MLPs on their capacity rows.  buf: [G, E, C, d] ->
    [G, E, C, d], products in buf's dtype (the reference's `gecd,edf->gecf`
    and `gecf,efd->gecd`), over slices of experts."""
    G, E, C, d = buf.shape
    f = w_up.shape[-1]
    dt = buf.dtype
    xe = buf.transpose(0, 1).reshape(E, G * C, d)
    out = torch.empty_like(xe)
    per_expert = G * C * f * 4          # the largest intermediate, fp32
    step = max(1, min(E, EXPERT_SLICE_BYTES // max(per_expert, 1)))
    for e0 in range(0, E, step):
        sl = slice(e0, e0 + step)
        u = torch.bmm(xe[sl], w_up[sl].to(dt))
        if mlp == "swiglu":
            g = torch.bmm(xe[sl], w_gate[sl].to(dt))
            h = torch.nn.functional.silu(g.float()).to(dt) * u
            del g
        else:
            h = torch.square(torch.relu(u.float())).to(dt)
        del u
        out[sl] = torch.bmm(h, w_down[sl].to(dt))
        del h
    return out.view(E, G, C, d).transpose(0, 1)


def combine(out_e, r: Routing):
    """fp32 [G, Tg, d]: each token's kept pairs' expert rows (row
    min(dest, E*C - 1)), weighted by their gates, summed in choice
    order."""
    G, rows, d = out_e.shape
    Tg = r.dest.shape[1]
    g_idx = torch.arange(G, device=out_e.device)[:, None]
    y = torch.zeros((G, Tg, d), dtype=torch.float32, device=out_e.device)
    for j in range(r.dest.shape[-1]):
        contrib = out_e[g_idx, r.dest[..., j].clamp(max=rows - 1)].float()
        contrib = torch.where(r.keep[..., j, None], contrib, 0.0)
        y = y + contrib * r.gates[..., j, None]
    return y
