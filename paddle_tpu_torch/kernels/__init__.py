"""Attention of the port: plain PyTorch versions plus the hand-written
CUDA kernels that replace the JAX package's Pallas kernels (csrc/,
built by build.py at first use, never at import)."""

from paddle_tpu_torch.kernels import attention, paged_attention
