"""Quantization of the port (paddle_tpu/quant counterpart): so far the
KV-block int8 codec of the in-device compressed tier."""
