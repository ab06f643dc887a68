"""Model definitions (the port of `repro.models`): the LM stack
(`transformer`) over `common`, `attention`, the MoE FFN (`moe`), the
Mamba-2 SSD block (`ssm`), the RG-LRU block (`rglru`) and their scan
(`scan`)."""
from repro_torch.models.common import ModelConfig  # noqa: F401
from repro_torch.models.transformer import (  # noqa: F401
    forward, init_cache, init_params, lm_loss,
)
