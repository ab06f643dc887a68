"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8)
d_ff=8192, vocab=202048, MoE 128 experts top-1 — early fusion
[hf:meta-llama/Llama-4-*; unverified]."""
import dataclasses
from repro_torch.models.common import ModelConfig

def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b", family="moe", n_layers=48,
        d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192, vocab=202048,
        mlp="swiglu", n_experts=128, top_k=1, rope_theta=5e5,
    )

def reduced() -> ModelConfig:
    return dataclasses.replace(config(), n_layers=2, d_model=64, n_heads=4,
                               n_kv_heads=2, d_ff=96, vocab=256,
                               n_experts=8, top_k=1,
                               q_block=32, kv_block=32, moe_dropless=True)
