"""Dense layers of the port (paddle_tpu/nn counterpart)."""

from paddle_tpu_torch.nn.layers import Dropout, Embedding, LayerNorm, Linear

__all__ = ["Dropout", "Embedding", "LayerNorm", "Linear"]
