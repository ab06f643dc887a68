"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (GQA kv=1, MQA)
d_ff=12288 vocab=256000 — RG-LRU + local attention (window 2048), pattern
1 attn : 2 recurrent [arXiv:2402.19427; unverified]."""
import dataclasses
from repro_torch.models.common import ModelConfig

def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b", family="hybrid", n_layers=38, d_model=4096,
        n_heads=16, n_kv_heads=1, d_ff=12288, vocab=256000,
        mlp="gelu", block_pattern=("rglru", "rglru", "attn"),
        window=2048, rglru_width=4096, logit_softcap=30.0, rope_theta=1e4,
    )

def reduced() -> ModelConfig:
    return dataclasses.replace(config(), n_layers=5, d_model=64, n_heads=4,
                               n_kv_heads=1, d_ff=128, vocab=256, window=64,
                               rglru_width=64, q_block=32, kv_block=32)
