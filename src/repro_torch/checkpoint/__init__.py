"""Checkpoint substrate of the port (atomic, async, validated restore)."""

from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
