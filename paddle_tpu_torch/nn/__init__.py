"""The layers of the port (paddle_tpu/nn counterpart). JAX's `Module`
and `Context` are not ported: the port's layers are `torch.nn.Module`s
(`Sequential` comes from `core.module`)."""

from paddle_tpu_torch.core.module import Sequential
from paddle_tpu_torch.nn import initializers
from paddle_tpu_torch.nn.layers import (
    BatchNorm, Conv2D, Conv2DTranspose, Conv3D, Conv3DTranspose, DataNorm,
    Dropout, Embedding, GroupNorm, LayerNorm, Linear, avg_pool2d,
    avg_pool3d, global_avg_pool2d, lrn, max_pool2d, max_pool3d,
)
from paddle_tpu_torch.nn.rnn import BiRNN, GRUCell, LSTMCell, RNN, StackedLSTM
from paddle_tpu_torch.nn.sampled import NCE, HierarchicalSigmoid

__all__ = ["BatchNorm", "BiRNN", "Conv2D", "Conv2DTranspose", "Conv3D",
           "Conv3DTranspose", "DataNorm", "Dropout", "Embedding", "GRUCell",
           "GroupNorm", "HierarchicalSigmoid", "LSTMCell", "LayerNorm",
           "Linear", "NCE", "RNN", "Sequential", "StackedLSTM", "avg_pool2d",
           "avg_pool3d", "global_avg_pool2d", "initializers", "lrn",
           "max_pool2d", "max_pool3d"]
