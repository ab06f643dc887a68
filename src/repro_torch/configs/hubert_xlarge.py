"""hubert-xlarge [audio]: 48L encoder-only d_model=1280 16H d_ff=5120
vocab=504 (cluster targets) — same arch as wav2vec2 [arXiv:2106.07447;
unverified].  Audio frontend is a STUB: inputs are precomputed frame
embeddings [B, T, 1280]; no decode step (encoder-only)."""
import dataclasses
from repro_torch.models.common import ModelConfig

def config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge", family="encoder", n_layers=48, d_model=1280,
        n_heads=16, n_kv_heads=16, d_ff=5120, vocab=504,
        mlp="gelu", norm="ln", causal=False,
        input_mode="features", feature_dim=1280,
    )

def reduced() -> ModelConfig:
    return dataclasses.replace(config(), n_layers=2, d_model=64, n_heads=4,
                               n_kv_heads=4, d_ff=128, vocab=64,
                               feature_dim=64, q_block=32, kv_block=32)
