"""Host-side utilities of the port: event streams, the flag registry,
tree keys and seeded generators."""

from paddle_tpu_torch.utils.flags import FLAGS, get_flags, set_flags

__all__ = ["FLAGS", "get_flags", "set_flags"]
