"""paddle_tpu_torch: the PyTorch + CUDA port of paddle_tpu.

The JAX package `paddle_tpu` stays the reference; this package mirrors
its module names (engine/, kernels/, models/, nn/, obs/, utils/) so each
part has an obvious counterpart, and imports neither `jax` nor
`paddle_tpu`. Plain tensor code is PyTorch; every kernel that the JAX
package wrote in Pallas for the TPU is a hand-written CUDA kernel under
`kernels/csrc/`, built at first use (kernels/build.py).

Entry points default to the CUDA card (`device.resolve_device`) and
raise without one unless the caller passes `device="cpu"`.
"""

from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.utils.flags import FLAGS, get_flags, set_flags

__all__ = ["FLAGS", "get_flags", "resolve_device", "set_flags"]
