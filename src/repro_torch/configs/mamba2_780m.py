"""mamba2-780m [ssm]: 48L d_model=1536, attention-free, d_ff=0, vocab=50280,
ssm_state=128 — SSD (state-space duality) [arXiv:2405.21060; unverified]."""
import dataclasses
from repro_torch.models.common import ModelConfig

def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m", family="ssm", n_layers=48, d_model=1536,
        n_heads=1, n_kv_heads=1, d_ff=0, vocab=50280,
        block_pattern=("ssm",), ssm_state=128, ssm_headdim=64,
        tie_embeddings=True,
    )

def reduced() -> ModelConfig:
    return dataclasses.replace(config(), n_layers=2, d_model=64, vocab=256,
                               ssm_state=16, ssm_headdim=16,
                               q_block=32, kv_block=32)
