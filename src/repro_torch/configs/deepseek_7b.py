"""deepseek-7b [dense]: 30L d_model=4096 32H (kv=32, i.e. MHA) d_ff=11008
vocab=102400 — llama-arch [arXiv:2401.02954; hf]."""
import dataclasses
from repro_torch.models.common import ModelConfig

def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-7b", family="dense", n_layers=30, d_model=4096,
        n_heads=32, n_kv_heads=32, d_ff=11008, vocab=102400,
        mlp="swiglu", rope_theta=1e4,
    )

def reduced() -> ModelConfig:
    return dataclasses.replace(config(), n_layers=2, d_model=64, n_heads=4,
                               n_kv_heads=4, d_ff=128, vocab=256,
                               q_block=32, kv_block=32)
