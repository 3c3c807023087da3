"""Models of the port (paddle_tpu/models counterpart)."""

from paddle_tpu_torch.models.convert import (load_jax_opt_state,
                                             load_jax_params, to_jax_opt_state,
                                             to_jax_params)
from paddle_tpu_torch.models.transformer import (BertEncoder, CausalLM,
                                                 DecoderLayer, EncoderLayer,
                                                 MultiHeadAttention,
                                                 Transformer, init_kv_caches)

__all__ = ["BertEncoder", "CausalLM", "DecoderLayer", "EncoderLayer",
           "MultiHeadAttention", "Transformer", "init_kv_caches",
           "load_jax_opt_state", "load_jax_params", "to_jax_opt_state",
           "to_jax_params"]
