from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig, adamw_init, adamw_update, clip_by_global_norm, global_norm,
    wsd_schedule,
)
from repro_torch.optim.compression import (  # noqa: F401
    compress_grads, decompress_grads,
)
