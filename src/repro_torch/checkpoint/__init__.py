"""repro_torch.checkpoint — atomic, CRC-verified disk checkpoints."""

from repro_torch.checkpoint.disk import (  # noqa: F401
    CheckpointError, save_checkpoint, restore_checkpoint, restore_latest,
    verify_checkpoint, latest_step, list_steps,
)
