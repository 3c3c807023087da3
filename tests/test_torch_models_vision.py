"""The port's vision zoo (`models/vision.py`) against
tests/test_models_vision.py's eight tests and against the JAX models on
the same weights: a tree in JAX's layout (paths and shapes held to
JAX's `init`), loaded by path with `load_jax_params`, BatchNorm `state`
included, with the norms' scales, biases and running stats made random
so their placement shows.

JAX marks `test_se_resnext_tiny` and `test_googlenet_tiny` slow for
JAX's compile time; the port's counterparts run here on the port alone,
and parity is held one block at a time (one `_SEResNeXtBlock`, one
`_Inception`). Parity: `MLP`, `LeNet`, `VGG(11)` at 32x32 and `AlexNet`
at 224 in eval mode; `ResNet((1, 1, 1, 1))` at 64x64 in train mode
(logits, the new `state` and every gradient); the `s2d_stem`; a `state`
round trip through `to_jax_params` / `load_jax_params`; trees made by
JAX's own `init` (a ResNet, SSDLite, DataNorm), their `state` moved by
a JAX training forward, loaded strictly and given back leaf for leaf.

Bars: whole models and their BN buffers within 1e-4 of each tensor's
largest element (float32 error compounds through depth); the ResNet's
gradients in norm, against a float-noise control (`_train_parity`);
single blocks 1e-5. JAX runs each model function jitted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import vision as JV
from paddle_tpu_torch.models import (MLP, AlexNet, GoogLeNet, LeNet, ResNet,
                                     SEResNeXt, VGG, load_jax_params,
                                     resnet50, to_jax_params)
from paddle_tpu_torch.models import vision as V
from paddle_tpu_torch.models.convert import param_path
from paddle_tpu_torch.nn.layers import Linear
from paddle_tpu_torch.testing import one_torch_thread
from paddle_tpu_torch.utils.tree import flatten_with_keys, nest


@pytest.fixture(autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


CPU = dict(device="cpu")


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_vars(jax_model, model, x, seed=1):
    """A JAX `variables` tree for both packages, as numpy, loaded into
    `model` by path: the port's seeded init, with every norm's running
    stats, scale and bias drawn at random (init makes 0 / 1 / 1 / 0), so
    their placement shows. Its paths and shapes are held to JAX's `init` on x first
    (`jax.eval_shape`: nothing compiled)."""
    want = jax.eval_shape(lambda a: jax_model.init(0, a), jnp.asarray(x))
    torch.manual_seed(seed)
    for mod in model.modules():        # a fresh init from the seed
        for name, p in mod.named_parameters(recurse=False):
            if name in ("weight", "wx", "wh", "wp") and p.dim() > 1:
                torch.nn.init.normal_(p, 0.0, (2.0 / np.prod(
                    p.shape[:-1])) ** 0.5)
    rs = np.random.RandomState(seed)
    flat = {}
    for k, a in flatten_with_keys(to_jax_params(model)):
        norm_param = "bn" in k.split("/")[-2] and k.startswith("params/")
        if k.endswith("/var") or (norm_param and k.endswith("/scale")):
            a = (rs.rand(*a.shape) + 0.5).astype(np.float32)
        elif k.endswith("/mean") or (norm_param and k.endswith("/bias")):
            a = (rs.randn(*a.shape) * 0.2).astype(np.float32)
        flat[k] = a
    assert {k: tuple(a.shape) for k, a in flat.items()} == {
        k: tuple(a.shape) for k, a in flatten_with_keys(want)}
    v = nest(flat)
    load_jax_params(model, v)
    return v


def _rel_close(got, want, bar, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= bar * float(np.abs(want).max()), (what, err)


def _eval_parity(jax_model, model, x, bar=1e-4):
    v = _jax_vars(jax_model, model, x)
    want = jax.jit(jax_model.apply)(v, jnp.asarray(x))
    with torch.no_grad():
        got = model.eval()(_t(x))
    _rel_close(got, want, bar)
    return v


# ---------------------------------------- tests/test_models_vision.py mirrors

def test_mlp_and_lenet():
    x = _t(_x((2, 28, 28, 1)))
    assert MLP(num_classes=10, **CPU)(x).shape == (2, 10)
    assert LeNet(num_classes=10, **CPU)(x).shape == (2, 10)


def test_resnet_tiny():
    model = ResNet(layers=(1, 1, 1, 1), num_classes=7, **CPU).train()
    out = model(_t(_x((2, 64, 64, 3))))
    assert out.shape == (2, 7)
    # BN state exists (mean and var of 17 norms) and moved from its init
    state = to_jax_params(model)["state"]
    assert len(dict(flatten_with_keys(state))) == 2 * 17
    assert float(model.stem.bn.mean.abs().sum()) > 0


def test_resnet_s2d_stem():
    model = ResNet(layers=(1, 1, 1, 1), num_classes=7, s2d_stem=True,
                   **CPU).train()
    out = model(_t(_x((2, 64, 64, 3))))
    ref = ResNet(layers=(1, 1, 1, 1), num_classes=7, **CPU).train()
    assert ref(_t(_x((2, 64, 64, 3)))).shape == out.shape == (2, 7)
    assert tuple(model.stem.conv.weight.shape) == (4, 4, 12, 64)
    with pytest.raises(ValueError, match="even"):
        model(_t(_x((1, 63, 64, 3))))


def test_vgg_tiny():
    model = VGG(depth=11, num_classes=5, in_shape=(32, 32, 3), **CPU)
    assert model(_t(_x((1, 32, 32, 3)))).shape == (1, 5)


def test_se_resnext_tiny():
    model = SEResNeXt(layers=(1, 1, 1, 1), cardinality=8, num_classes=6,
                      **CPU)
    assert model(_t(_x((1, 64, 64, 3)))).shape == (1, 6)


def test_googlenet_tiny():
    assert GoogLeNet(num_classes=4, **CPU)(_t(_x((1, 64, 64, 3)))).shape \
        == (1, 4)


def test_alexnet():
    assert AlexNet(num_classes=4, **CPU)(_t(_x((1, 224, 224, 3)))).shape \
        == (1, 4)


def test_weight_sharing_same_child_twice():
    class Shared(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = Linear(8, 8)

        def forward(self, x):
            return self.fc(self.fc(x))

    m = Shared()
    m(torch.zeros(2, 8)).sum().backward()
    assert len(list(m.parameters())) == 2
    assert set(to_jax_params(m)["params"]["fc"]) == {"weight", "bias"}


# ---------------------------------------------------- parity with JAX

@pytest.mark.parametrize("name", ["mlp", "lenet", "vgg11_32", "alexnet"])
def test_eval_matches_jax(name):
    if name == "mlp":
        pair, shape = (JV.MLP(num_classes=10), MLP(**CPU)), (2, 28, 28, 1)
    elif name == "lenet":
        pair, shape = (JV.LeNet(), LeNet(**CPU)), (2, 28, 28, 1)
    elif name == "vgg11_32":
        pair = (JV.VGG(11, num_classes=5),
                VGG(11, num_classes=5, in_shape=(32, 32, 3), **CPU))
        shape = (2, 32, 32, 3)
    else:
        pair = (JV.AlexNet(num_classes=4), AlexNet(num_classes=4, **CPU))
        shape = (1, 224, 224, 3)
    _eval_parity(*pair, _x(shape))


def _port_grads(model, x, labels):
    """One train-mode forward + backward of the port: (logits, every
    gradient by JAX path)."""
    model.zero_grad(set_to_none=True)
    logits = model.train()(_t(x))
    torch.nn.functional.cross_entropy(logits, _t(labels).long()).backward()
    return logits, {param_path(n): p.grad.clone()
                    for n, p in model.named_parameters()}


def _train_parity(jax_model, model, x, labels):
    """One train-mode forward + backward in both packages, on drawn norm
    scales and biases: the logits and the new BN state within 1e-4 of
    their largest element; each gradient in norm within 1e-2 of its own
    norm (plus 1e-6 of the model's largest gradient element per sqrt
    of its size) plus twice its float noise.

    The noise is the largest change of that gradient in the port when
    the input moves by 1e-5 relative, 3 times. JAX's BatchNorm
    computes E[x^2] - E[x]^2 in float32 (even under x64), which puts
    the packages' activations apart by more than float32's rounding; a
    ReLU whose input lies that close to 0 gates differently, and one
    such gate can move a BN bias's gradient past the 1e-2 bar. The
    shaken inputs flip gates at the same rate, so the noise term takes
    such tensors in; a wrong backward moves a gradient the same way on
    every input and stays outside."""
    v = _jax_vars(jax_model, model, x)

    def jloss(params, xx):
        logits, mut = jax_model.apply({"params": params,
                                       "state": v["state"]}, xx,
                                      training=True, mutable=True)
        lse = jax.nn.logsumexp(logits, axis=-1)
        picked = jnp.take_along_axis(logits, labels[:, None], 1)[:, 0]
        return jnp.mean(lse - picked), (logits, mut["state"])
    (_, (jlogits, jstate)), jgrads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(v["params"],
                                                 jnp.asarray(x))
    start = {n: b.clone() for n, b in model.named_buffers()}
    logits, pg = _port_grads(model, x, labels)
    _rel_close(logits, jlogits, 1e-4, "logits")
    got_state = dict(flatten_with_keys(to_jax_params(model)["state"]))
    want_state = dict(flatten_with_keys(jax.device_get(jstate)))
    assert set(got_state) == set(want_state)
    for k in want_state:
        _rel_close(got_state[k], want_state[k], 1e-4, k)
    rs = np.random.RandomState(7)
    noise = dict.fromkeys(pg, 0.0)
    for _ in range(3):
        for n, b in model.named_buffers():
            b.copy_(start[n])
        xs = (x * (1 + 1e-5 * rs.randn(*x.shape))).astype(np.float32)
        for k, g in _port_grads(model, xs, labels)[1].items():
            noise[k] = max(noise[k], float((g - pg[k]).norm()))
    jg = {k: _t(a) for k, a in flatten_with_keys(jax.device_get(jgrads))}
    assert set(jg) == set(pg)
    top = max(float(w.abs().max()) for w in jg.values())
    for k, w in jg.items():
        bar = (1e-2 * float(w.norm()) + 1e-6 * top * w.numel() ** 0.5
               + 2 * noise[k])
        assert float((pg[k] - w).norm()) <= bar, (k, float(
            (pg[k] - w).norm()), bar)


def test_resnet_train_step_matches_jax():
    _train_parity(JV.ResNet((1, 1, 1, 1), num_classes=7),
                  ResNet((1, 1, 1, 1), num_classes=7, **CPU),
                  _x((4, 64, 64, 3), 2),
                  np.random.RandomState(0).randint(0, 7, 4))


def test_resnet_s2d_stem_matches_jax():
    _eval_parity(JV.ResNet((1, 1, 1, 1), num_classes=7, s2d_stem=True),
                 ResNet((1, 1, 1, 1), num_classes=7, s2d_stem=True, **CPU),
                 _x((2, 32, 32, 3), 3))


def test_state_round_trip():
    """A JAX-layout tree (the port's seeded init, its running stats
    drawn) loads into a fresh ResNet and comes back leaf for leaf."""
    torch.manual_seed(5)
    src = ResNet((1, 1, 1, 1), num_classes=3, **CPU)
    rs = np.random.RandomState(5)
    v = nest({k: (rs.rand(*np.shape(a)).astype(np.float32)
                  if k.startswith("state/") else a)
              for k, a in flatten_with_keys(to_jax_params(src))})
    model = load_jax_params(ResNet((1, 1, 1, 1), num_classes=3, **CPU), v)
    back = to_jax_params(model)
    a, b = dict(flatten_with_keys(back)), dict(flatten_with_keys(v))
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    # a missing or extra state key, or a wrong shape, is refused
    bad = nest({k: x for k, x in b.items() if not k.endswith("stem/bn/var")})
    with pytest.raises(ValueError, match="missing"):
        load_jax_params(model, bad)
    with pytest.raises(ValueError, match="state"):
        load_jax_params(model, {"params": v["params"]})
    wrong = dict(b)
    wrong["state/stem/bn/mean"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(model, nest(wrong))
    with pytest.raises(ValueError, match="collections"):
        load_jax_params(model, {**v, "cache": {"k": np.zeros(1)}})


@pytest.mark.parametrize("block", ["se_resnext", "inception"])
def test_blocks_match_jax(block):
    """One SE-ResNeXt block (strided, projected, grouped, with
    squeeze-excite) and one inception block, in train mode."""
    if block == "se_resnext":
        jm = JV._SEResNeXtBlock(32, cardinality=8, stride=2, downsample=True)
        pm = V._SEResNeXtBlock(16, 32, cardinality=8, stride=2,
                               downsample=True)
        x = _x((2, 9, 8, 16), 3)
    else:
        jm = JV._Inception(8, 6, 12, 4, 6, 5)
        pm = V._Inception(10, 8, 6, 12, 4, 6, 5)
        x = _x((2, 7, 6, 10), 3)
    v = _jax_vars(jm, pm, x)
    want, mut = jax.jit(lambda vv, a: jm.apply(vv, a, training=True,
                                               mutable=True))(
        v, jnp.asarray(x))
    got = pm.train()(_t(x))
    _rel_close(got, want, 1e-5)
    state = dict(flatten_with_keys(to_jax_params(pm)["state"]))
    for k, w in flatten_with_keys(jax.device_get(mut["state"])):
        _rel_close(state[k], w, 1e-5, k)


def test_resnet50_has_jax_tree():
    """resnet50's tree: every path and shape of JAX's init
    (`jax.eval_shape`, nothing compiled) and 25,557,032 parameters."""
    want = jax.eval_shape(lambda a: JV.resnet50().init(0, a),
                          jnp.zeros((1, 64, 64, 3)))
    got = to_jax_params(resnet50(**CPU))
    shapes = {k: tuple(np.shape(a)) for k, a in flatten_with_keys(got)}
    assert shapes == {k: tuple(a.shape) for k, a in flatten_with_keys(want)}
    assert sum(int(np.prod(s)) for k, s in shapes.items()
               if k.startswith("params/")) == 25_557_032


@pytest.mark.parametrize("model", ["resnet", "ssdlite", "datanorm"])
def test_jax_initialised_trees_load_with_state(model):
    """A tree JAX's `init` made, its `state` moved by one JAX training
    forward, loads strictly into the port's model, and `to_jax_params`
    gives the same tree back leaf for leaf."""
    from paddle_tpu.models.detection import SSDLite as JaxSSDLite
    from paddle_tpu.nn.layers import DataNorm as JaxDataNorm
    from paddle_tpu_torch.models.detection import SSDLite
    from paddle_tpu_torch.nn.layers import DataNorm
    if model == "resnet":
        jm = JV.ResNet((1, 1, 1, 1), num_classes=3)
        pm = ResNet((1, 1, 1, 1), num_classes=3, **CPU)
        x = _x((2, 32, 32, 3), 6)
    elif model == "ssdlite":
        jm = JaxSSDLite(num_classes=2, image_size=32)
        pm = SSDLite(num_classes=2, image_size=32, **CPU)
        x = _x((2, 32, 32, 3), 7)
    else:
        jm, pm = JaxDataNorm(), DataNorm(5)
        x = _x((6, 5), 8)

    def init_and_step(a):
        v = jm.init(0, a)
        _, mut = jm.apply(v, a, training=True, mutable=True)
        return {**v, "state": mut["state"]}
    v = jax.device_get(jax.jit(init_and_step)(jnp.asarray(x)))
    assert v["state"]
    load_jax_params(pm, v)
    got = dict(flatten_with_keys(to_jax_params(pm)))
    want = dict(flatten_with_keys(v))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
