"""Checkpoints in the JAX package's format, without JAX (paddle_tpu/io
counterpart)."""

from paddle_tpu_torch.io.checkpoint import (
    AsyncCheckpointer, CheckpointIntegrityError, CheckpointManager,
    checkpoint_step, latest_checkpoint, list_checkpoints, load_checkpoint,
    read_metadata, save_checkpoint, verify_checkpoint)

__all__ = ["AsyncCheckpointer", "CheckpointIntegrityError",
           "CheckpointManager", "checkpoint_step", "latest_checkpoint",
           "list_checkpoints", "load_checkpoint", "read_metadata",
           "save_checkpoint", "verify_checkpoint"]
