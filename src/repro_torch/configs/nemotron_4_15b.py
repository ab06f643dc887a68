"""nemotron-4-15b [dense]: 32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000 — GQA, squared-ReLU MLP [arXiv:2402.16819; unverified]."""
import dataclasses
from repro_torch.models.common import ModelConfig

def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b", family="dense", n_layers=32, d_model=6144,
        n_heads=48, n_kv_heads=8, d_ff=24576, vocab=256000,
        mlp="sqrelu", norm="ln", rope_theta=1e4,
    )

def reduced() -> ModelConfig:
    return dataclasses.replace(config(), n_layers=2, d_model=96, n_heads=6,
                               n_kv_heads=2, d_ff=192, vocab=256,
                               q_block=32, kv_block=32)
