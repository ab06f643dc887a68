"""Model definitions (the port of `repro.models`): dense, encoder and
VLM-backbone transformers over `models.common` and `models.attention`."""
from repro_torch.models.common import ModelConfig  # noqa: F401
from repro_torch.models.transformer import (  # noqa: F401
    forward, init_cache, init_params, lm_loss,
)
