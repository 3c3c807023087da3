"""The port's DLPack interop (`paddle_tpu_torch.utils.interop`) against
the three DLPack tests of tests/test_prune_interop.py, plus arrays passed
between the packages both ways (a JAX array to the port, a port tensor
to JAX) and numpy, without copies. The port's array type is
`torch.Tensor`, so `from_torch` / `tree_from_torch` return what they are
given."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from paddle_tpu.utils import interop as JI
from paddle_tpu_torch.utils.interop import (from_dlpack, from_torch,
                                            to_dlpack, to_torch,
                                            tree_from_torch)


# --------------------------- tests/test_prune_interop.py's DLPack mirrors

def test_dlpack_torch_roundtrip():
    x = jnp.arange(12.0).reshape(3, 4)
    t = to_torch(x)
    assert isinstance(t, torch.Tensor) and tuple(t.shape) == (3, 4)
    back = from_torch(t)
    np.testing.assert_allclose(back.numpy(), np.asarray(x))
    tree = tree_from_torch({"a": torch.ones(2, 2), "b": 3})
    assert isinstance(tree["a"], torch.Tensor) and tree["b"] == 3


def test_to_dlpack_capsule():
    cap = to_dlpack(torch.ones((2, 2)))
    assert "dltensor" in repr(cap)
    # the capsule is consumable by a capsule consumer
    t = torch.utils.dlpack.from_dlpack(to_dlpack(torch.ones((2, 2))))
    assert tuple(t.shape) == (2, 2)
    assert tuple(from_dlpack(to_dlpack(torch.ones(3))).shape) == (3,)


def test_from_dlpack_protocol_object():
    arr = from_dlpack(np.arange(6.0).reshape(2, 3))
    assert isinstance(arr, torch.Tensor)
    np.testing.assert_allclose(arr.numpy(), np.arange(6.0).reshape(2, 3))


# ------------------------------------------------------ across packages

def test_jax_array_to_the_port():
    x = jnp.arange(20, dtype=jnp.float32).reshape(4, 5) * 0.5
    for conv in (from_dlpack, to_torch, JI.to_torch):
        t = conv(x)
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), np.asarray(x))


def test_port_tensor_to_jax():
    t = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    for conv in (jax.dlpack.from_dlpack, JI.from_torch, JI.from_dlpack):
        a = conv(t)
        assert isinstance(a, jax.Array) and a.dtype == jnp.int32
        np.testing.assert_array_equal(np.asarray(a), t.numpy())
    tree = JI.tree_from_torch({"w": t, "n": 1})
    assert isinstance(tree["w"], jax.Array) and tree["n"] == 1


def test_from_dlpack_is_zero_copy():
    a = np.zeros(8, np.float32)
    t = from_dlpack(a)
    a[3] = 7.0                       # the tensor sees the producer's write
    assert float(t[3]) == 7.0
    assert t.data_ptr() == a.ctypes.data
    src = torch.arange(5.0)
    same = from_dlpack(to_dlpack(src))
    assert same.data_ptr() == src.data_ptr() and same.device == src.device


def test_from_torch_returns_what_it_is_given():
    t = torch.ones(3)
    tree = {"a": t, "b": [t, 2]}
    assert from_torch(t) is t
    assert tree_from_torch(tree) is tree
