"""Models of the port (paddle_tpu/models counterpart)."""

from paddle_tpu_torch.models.convert import (load_jax_params, to_jax_opt_state,
                                             to_jax_params)
from paddle_tpu_torch.models.transformer import CausalLM

__all__ = ["CausalLM", "load_jax_params", "to_jax_opt_state",
           "to_jax_params"]
