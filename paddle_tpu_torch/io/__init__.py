"""Reading the JAX package's artifacts without JAX (paddle_tpu/io
counterpart)."""

from paddle_tpu_torch.io.checkpoint import load_checkpoint

__all__ = ["load_checkpoint"]
