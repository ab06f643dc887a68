"""qwen2-vl-7b [vlm]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064 — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].
Vision frontend is a STUB: input_specs provides precomputed patch
embeddings; M-RoPE positions [B, S, 3] supplied by the pipeline."""
import dataclasses
from repro_torch.models.common import ModelConfig

def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b", family="vlm", n_layers=28, d_model=3584,
        n_heads=28, n_kv_heads=4, d_ff=18944, vocab=152064,
        mlp="swiglu", mrope_sections=(16, 24, 24), rope_theta=1e6,
    )

def reduced() -> ModelConfig:
    return dataclasses.replace(config(), n_layers=2, d_model=64, n_heads=4,
                               n_kv_heads=2, d_ff=128, vocab=256,
                               mrope_sections=(4, 2, 2),
                               q_block=32, kv_block=32)
