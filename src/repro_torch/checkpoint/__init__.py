"""The port's checkpointing (the counterpart of ``repro/checkpoint``)."""

from repro_torch.checkpoint.manager import (CheckpointCorruptError,
                                            CheckpointManager)

__all__ = ["CheckpointCorruptError", "CheckpointManager"]
