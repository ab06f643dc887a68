"""codeqwen1.5-7b [dense]: 32L d_model=4096 32H (kv=32) d_ff=13440
vocab=92416 — qwen1.5-arch [hf:Qwen/CodeQwen1.5-7B; hf]."""
import dataclasses
from repro_torch.models.common import ModelConfig

def config() -> ModelConfig:
    return ModelConfig(
        name="codeqwen1.5-7b", family="dense", n_layers=32, d_model=4096,
        n_heads=32, n_kv_heads=32, d_ff=13440, vocab=92416,
        mlp="swiglu", rope_theta=1e6,
    )

def reduced() -> ModelConfig:
    return dataclasses.replace(config(), n_layers=2, d_model=64, n_heads=4,
                               n_kv_heads=4, d_ff=128, vocab=256,
                               q_block=32, kv_block=32)
