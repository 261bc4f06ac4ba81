"""Checkpoints of the training path, in the reference's on-disk format."""

from .store import CheckpointConfig, CheckpointManager

__all__ = ["CheckpointConfig", "CheckpointManager"]
