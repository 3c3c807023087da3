"""Checkpoints in the JAX package's format and the inference export, without
JAX (paddle_tpu/io counterpart)."""

from paddle_tpu_torch.io.checkpoint import (
    AsyncCheckpointer, CheckpointIntegrityError, CheckpointManager,
    checkpoint_step, latest_checkpoint, list_checkpoints, load_checkpoint,
    load_persistables, read_metadata, save_checkpoint, save_persistables,
    verify_checkpoint)
from paddle_tpu_torch.io.inference import (InferencePredictor,
                                           load_inference_model,
                                           save_inference_model)

__all__ = ["AsyncCheckpointer", "CheckpointIntegrityError",
           "CheckpointManager", "InferencePredictor", "checkpoint_step",
           "latest_checkpoint", "list_checkpoints", "load_checkpoint",
           "load_inference_model", "load_persistables", "read_metadata",
           "save_checkpoint", "save_inference_model", "save_persistables",
           "verify_checkpoint"]
