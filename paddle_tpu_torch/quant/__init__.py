"""Quantization and model compression of the port (paddle_tpu/quant
counterpart): fake-quant ops and QAT layers, post-training calibration
and int8 weight storage, magnitude pruning, true int8 compute
(`int8_compute.freeze_int8`) and the KV-block int8 codec."""

from paddle_tpu_torch.quant.fake_quant import (
    dequantize, fake_quant_abs_max, fake_quant_channel_abs_max,
    fake_quant_moving_average, int8_matmul, qrange, quantize)
from paddle_tpu_torch.quant.layers import (QuantConv2D, QuantLinear,
                                           quantize_model)
from paddle_tpu_torch.quant.ptq import (
    calibrate, dequantize_weights, quantize_weights, quantized_nbytes)
from paddle_tpu_torch.quant.prune import (
    apply_masks, magnitude_masks, masked_train_step, select_ratios,
    sensitivity_analysis, sparsity)

__all__ = [
    "dequantize", "fake_quant_abs_max", "fake_quant_channel_abs_max",
    "fake_quant_moving_average", "int8_matmul", "qrange", "quantize",
    "QuantConv2D", "QuantLinear", "quantize_model",
    "calibrate", "dequantize_weights", "quantize_weights",
    "quantized_nbytes",
    "apply_masks", "magnitude_masks", "masked_train_step",
    "select_ratios", "sensitivity_analysis", "sparsity",
]
