"""The port's fused BatchNorm + ReLU (`nn/fused_bn.py`, a
`torch.autograd.Function`) against tests/test_fused_bn.py's five tests
and against JAX's `bn_relu_train` (a `custom_vjp`): forward and
gradients on the same numpy inputs, the tiny-gamma case included.

`test_resnet_block_trains_with_fused_bn` runs `ResNet((1, 1, 1, 1))` at
64x64 (JAX's runs `resnet50`): twelve steps of the full ResNet-50 at
64x64 take well over the few seconds a tier-1 test may on the CPU, and
the fused path is the same in every block.

Bars: forward 1e-5 relative (atol 1e-5, as JAX's test); gradients
within 1e-5 of each tensor's largest element against JAX's custom
backward, 2e-4 against the unfused autograd (JAX's bar: the
reconstruction of x_hat from z rounds differently).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn.fused_bn import bn_relu_train as jax_bn_relu_train
from paddle_tpu_torch.core import Trainer
from paddle_tpu_torch.models import vision as V
from paddle_tpu_torch.nn.fused_bn import bn_relu_train
from paddle_tpu_torch.nn.layers import BatchNorm
from paddle_tpu_torch.ops import functional as F
from paddle_tpu_torch.optim import Momentum
from paddle_tpu_torch.testing import one_torch_thread


@pytest.fixture(autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _t(x):
    return torch.from_numpy(np.array(x))


def _unfused(x, gamma, beta, eps):
    xf = x.float()
    axes = tuple(range(x.dim() - 1))
    mean = xf.mean(dim=axes)
    var = torch.clamp(xf.square().mean(dim=axes) - mean.square(), min=0.0)
    return torch.relu((xf - mean) * torch.rsqrt(var + eps) * gamma + beta)


def test_forward_matches_unfused():
    rs = np.random.RandomState(0)
    x = _t(rs.randn(8, 5, 5, 16).astype(np.float32))
    gamma = _t((rs.rand(16) + 0.5).astype(np.float32))
    beta = _t(rs.randn(16).astype(np.float32))
    y, mean, var = bn_relu_train(x, gamma, beta, 1e-5)
    np.testing.assert_allclose(y.numpy(), _unfused(x, gamma, beta,
                                                   1e-5).numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mean.numpy(), x.mean(dim=(0, 1, 2)).numpy(),
                               rtol=1e-5, atol=1e-5)


def _grads(fn, x, gamma, beta, t):
    args = [a.clone().requires_grad_(True) for a in (x, gamma, beta)]
    ((fn(*args) - t) ** 2).sum().backward()
    return [a.grad for a in args]


def test_grads_match_unfused():
    rs = np.random.RandomState(1)
    x = _t(rs.randn(4, 3, 3, 8).astype(np.float32))
    gamma = _t((rs.rand(8) + 0.5).astype(np.float32))
    beta = _t((rs.randn(8) * 0.2).astype(np.float32))
    t = _t(rs.randn(4, 3, 3, 8).astype(np.float32))
    gf = _grads(lambda a, g, b: bn_relu_train(a, g, b, 1e-5)[0],
                x, gamma, beta, t)
    gu = _grads(lambda a, g, b: _unfused(a, g, b, 1e-5), x, gamma, beta, t)
    for a, b in zip(gf, gu):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-4)


TINY_GAMMA = np.array([0.0, 1e-9, 0.5, -1e-9, 1.0, -0.5, 2.0, 1e-7],
                      np.float32)


def test_grads_survive_tiny_gamma():
    x = _t(np.random.RandomState(2).randn(4, 8).astype(np.float32))
    args = [a.clone().requires_grad_(True)
            for a in (x, _t(TINY_GAMMA), torch.zeros(8))]
    (bn_relu_train(*args, 1e-5)[0] ** 2).sum().backward()
    for a in args:
        assert torch.isfinite(a.grad).all()


def test_batchnorm_layer_fused_vs_unfused():
    x = _t(np.random.RandomState(3).randn(8, 4, 4, 8).astype(np.float32))
    fused = BatchNorm(8, fuse_relu=True).train()
    plain = BatchNorm(8).train()
    np.testing.assert_allclose(fused(x).detach().numpy(),
                               torch.relu(plain(x)).detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    for a, b in ((fused.mean, plain.mean), (fused.var, plain.var)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)
    # the eval path applies the ReLU too (the layer owns its activation)
    assert float(fused.eval()(x).detach().min()) >= 0.0


def test_resnet_block_trains_with_fused_bn(monkeypatch):
    orig_init = V._ConvBN.__init__

    def fused_init(self, in_features, features, kernel, stride=1,
                   padding="SAME", groups=1, act=F.relu, dtype=torch.float32,
                   device=None):
        orig_init(self, in_features, features, kernel, stride=stride,
                  padding=padding, groups=groups, act=act, dtype=dtype,
                  device=device)
        if act is F.relu:
            self.bn = BatchNorm(features, fuse_relu=True, device=device)
            self.act = None

    monkeypatch.setattr(V._ConvBN, "__init__", fused_init)
    torch.manual_seed(4)
    model = V.ResNet((1, 1, 1, 1), num_classes=10, device="cpu")
    assert sum(m.fuse_relu for m in model.modules()
               if isinstance(m, BatchNorm)) == 9
    rs = np.random.RandomState(4)
    x = _t(rs.randn(8, 64, 64, 3).astype(np.float32))
    y = _t(rs.randint(0, 10, 8))

    def loss_fn(module, batch, generator, training):
        return F.softmax_with_cross_entropy(module(batch[0]),
                                            batch[1]).mean(), {}

    tr = Trainer(model, Momentum(model.parameters(), 0.005, momentum=0.9),
                 loss_fn)
    losses = [float(tr.train_step((x, y))["loss"]) for _ in range(12)]
    assert np.isfinite(losses[-1])
    assert losses[-1] < losses[0]


# ------------------------------------------------- parity with JAX

@pytest.mark.parametrize("case", ["nhwc", "tiny_gamma", "rows"])
def test_matches_jax_forward_and_grads(case):
    rs = np.random.RandomState(5)
    if case == "tiny_gamma":
        x = rs.randn(4, 8).astype(np.float32)
        gamma = TINY_GAMMA
    else:
        x = rs.randn(*((6, 3, 4, 8) if case == "nhwc" else (32, 8))
                     ).astype(np.float32)
        gamma = (rs.rand(8) + 0.5).astype(np.float32)
    beta = (rs.randn(8) * 0.3).astype(np.float32)
    t = rs.randn(*x.shape).astype(np.float32)

    def jloss(a, g, b):
        y, _, _ = jax_bn_relu_train(a, g, b, 1e-5)
        return jnp.sum((y - t) ** 2), y
    (_, jy), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                             has_aux=True))(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    _, jmean, jvar = jax_bn_relu_train(jnp.asarray(x), jnp.asarray(gamma),
                                       jnp.asarray(beta), 1e-5)
    args = [_t(a).requires_grad_(True) for a in (x, gamma, beta)]
    y, mean, var = bn_relu_train(*args, 1e-5)
    ((y - _t(t)) ** 2).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), rtol=1e-5,
                               atol=1e-6)
    for got, want in zip(args, jg):
        want = np.asarray(want)
        np.testing.assert_allclose(got.grad.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()))
