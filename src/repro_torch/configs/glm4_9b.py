"""glm4-9b [dense]: 40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552
— RoPE, GQA [hf:THUDM/glm-4-9b; hf]."""
import dataclasses
from repro_torch.models.common import ModelConfig

def config() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b", family="dense", n_layers=40, d_model=4096,
        n_heads=32, n_kv_heads=2, d_ff=13696, vocab=151552,
        mlp="swiglu", rope_theta=1e4,
    )

def reduced() -> ModelConfig:
    return dataclasses.replace(config(), n_layers=2, d_model=64, n_heads=4,
                               n_kv_heads=2, d_ff=128, vocab=256,
                               q_block=32, kv_block=32)
