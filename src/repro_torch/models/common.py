"""Shared model components: config, norms, embeddings, RoPE (incl. M-RoPE).

The port of the JAX package's `models/common.py`.  `ModelConfig` is a copy
of the reference's dataclass (the same fields and defaults), with its
dtypes as torch dtypes.  Norms and RoPE compute in fp32 and return the
input's dtype, as the reference's do.
"""

from __future__ import annotations

import dataclasses
import math

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One config object drives every architecture (see repro_torch.configs).
    The reference's fields and defaults, unchanged."""

    name: str
    family: str                    # dense | moe | ssm | hybrid | encoder | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    mlp: str = "swiglu"            # swiglu | sqrelu | gelu
    norm: str = "rms"              # rms | ln
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_dropless: bool = False
    # attention
    causal: bool = True
    window: int = 0                # sliding-window size (0 = full attention)
    rope_theta: float = 1e6
    mrope_sections: tuple[int, ...] = ()   # qwen2-vl M-RoPE half-dim split
    logit_softcap: float = 0.0
    # ssm (mamba2 SSD)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    # hybrid (recurrentgemma): per-layer block kinds, cycled over layers
    block_pattern: tuple[str, ...] = ("attn",)    # attn | ssm | rglru
    rglru_width: int = 0           # 0 -> d_model
    # encoder/frontend
    input_mode: str = "tokens"     # tokens | features (stub frontend)
    feature_dim: int = 0
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    # dtypes / training
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    score_dtype: str = "float32"
    loss_chunk: int = 0
    moe_groups: int = 0
    # attention blocking (flash-style pair-list attention)
    q_block: int = 512
    kv_block: int = 512

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def attn_free(self) -> bool:
        return "attn" not in self.block_pattern

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode at 500k context?  (SSM/hybrid/windowed.)"""
        return self.attn_free or self.window > 0 or all(
            k != "attn" or self.window > 0 for k in self.block_pattern)

    @property
    def layer_kinds(self) -> tuple[str, ...]:
        """Block kind of every layer (pattern cycled)."""
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.n_layers))

    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    def n_params(self) -> int:
        """Total parameter count (from the parameter shapes, made on the
        meta device: nothing is allocated)."""
        from repro_torch.models.transformer import init_params
        params = init_params(self, seed=0, device="meta")
        return sum(x.numel() for x in tree_leaves(params))

    def n_active_params(self) -> int:
        """Active params per token (MoE: routed top_k of n_experts)."""
        total = self.n_params()
        if not self.is_moe:
            return total
        expert_p = 3 * self.d_model * self.d_ff  # swiglu expert
        return total - self.n_layers * (self.n_experts - self.top_k) \
            * expert_p


def tree_leaves(tree) -> list:
    """The tensors of a nested dict / tuple / list, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps):
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def layer_norm(x, scale, eps):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    return (((x - mu) * torch.rsqrt(var + eps))
            * (1.0 + scale.float())).to(dt)


def norm(x, scale, cfg: ModelConfig):
    return rms_norm(x, scale, cfg.norm_eps) if cfg.norm == "rms" \
        else layer_norm(x, scale, cfg.norm_eps)


# ---------------------------------------------------------------------------
# RoPE (+ M-RoPE for qwen2-vl)
# ---------------------------------------------------------------------------

def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return 1.0 / torch.pow(float(theta), exps)


def rope_tables(positions, hd: int, theta: float,
                sections: tuple[int, ...] = ()):
    """(cos, sin) of the rotation angles, [..., t, 1, hd/2] in fp32, for
    `apply_rope`: made once per forward and shared by every layer.
    positions: [..., t] or [..., t, 3] (M-RoPE: the half-dim axis split
    into `sections`, t/h/w, each rotated by its own coordinate)."""
    dev = positions.device
    freqs = rope_freqs(hd, theta, dev)                    # [hd/2]
    if sections:
        assert sum(sections) == hd // 2, (sections, hd)
        sec_id = torch.cat([torch.full((n,), i, device=dev)
                            for i, n in enumerate(sections)])
        ang = positions[..., sec_id].float() * freqs      # [..., t, hd/2]
    else:
        ang = positions[..., None].float() * freqs        # [..., t, hd/2]
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def apply_rope(x, positions, theta: float, sections: tuple[int, ...] = (),
               tables=None):
    """x: [..., t, h, hd]; positions: [..., t] or [..., t, 3] (M-RoPE).
    `tables`, when given, is `rope_tables` of these positions."""
    cos, sin = tables if tables is not None else rope_tables(
        positions, x.shape[-1], theta, sections)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def make_mrope_positions(batch: int, seq: int, *, device="cuda"):
    """Stub M-RoPE positions for text-only input: t == h == w == arange."""
    ar = torch.arange(seq, dtype=torch.int32, device=device)
    return ar[None, :, None].expand(batch, seq, 3)


# ---------------------------------------------------------------------------
# Parameter init helpers
# ---------------------------------------------------------------------------

def dense_init(generator, shape, dtype, scale=None, *, device=None,
               out=None):
    """The reference's `dense_init` scales: a normal truncated to [-2, 2]
    (drawn in fp32 from `generator`), times `scale` or 1/sqrt(fan_in),
    cast to `dtype` (into `out` when given).  The draws are torch's, not
    `jax.random`'s: weights that must equal the reference's are converted
    from its `init_params` (`repro_torch.convert.model_params`).
    `generator=None` on the meta device allocates nothing."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    s = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    return _draw(shape, dtype, device, out,
                 lambda t: torch.nn.init.trunc_normal_(
                     t, 0.0, 1.0, -2.0, 2.0, generator=generator).mul_(s))


def normal_init(generator, shape, dtype, std, *, device=None, out=None):
    """A normal of standard deviation `std` (drawn in fp32 from
    `generator`), cast to `dtype`: the reference's `jax.random.normal(...)
    * std` weights of the recurrent blocks."""
    return _draw(shape, dtype, device, out,
                 lambda t: t.normal_(0.0, std, generator=generator))


# The largest fp32 draw made at once; a larger tensor is drawn in slices
# along its first axis (a layer of llama4's experts is 21 GB in fp32).
DRAW_BYTES = 1 << 30


def _draw(shape, dtype, device, out, fill):
    if out is None:
        out = torch.empty(shape, dtype=dtype, device=device)
    if out.device.type == "meta":
        return out
    rows = max(1, DRAW_BYTES // (4 * math.prod(shape[1:])))
    for i in range(0, shape[0], rows):
        n = min(rows, shape[0] - i)
        out[i:i + n] = fill(torch.empty((n, *shape[1:]),
                                        dtype=torch.float32,
                                        device=out.device))
    return out
