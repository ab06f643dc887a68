"""mixtral-8x7b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, 8 experts top-2, sliding window 4096 [arXiv:2401.04088; hf]."""
import dataclasses
from repro_torch.models.common import ModelConfig

def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b", family="moe", n_layers=32, d_model=4096,
        n_heads=32, n_kv_heads=8, d_ff=14336, vocab=32000,
        mlp="swiglu", n_experts=8, top_k=2, window=4096, rope_theta=1e6,
    )

def reduced() -> ModelConfig:
    return dataclasses.replace(config(), n_layers=2, d_model=64, n_heads=4,
                               n_kv_heads=2, d_ff=128, vocab=256,
                               n_experts=4, top_k=2, window=64,
                               q_block=32, kv_block=32, moe_dropless=True)
