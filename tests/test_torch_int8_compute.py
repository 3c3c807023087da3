"""The port's true-int8 path (`quant/int8_compute.py`) against
tests/test_int8_compute.py's six tests and against the JAX package's
`freeze_int8` on the same weights and inputs.

ResNet((1, 1, 1, 1)) at 16x16 (the port's seeded init, loaded into JAX
by path) is frozen by both packages with one calibration batch, once for
the module; JAX's freeze runs its own `freeze_int8` with the model's
`init` and `apply` jitted (attributes of the instance; the package is
untouched), since eagerly it compiles every primitive it meets.

- Every int8 `weight` and f32 `w_scale` equals JAX's exactly; every
  calibrated `act_scale` is within 1e-6 of JAX's (relative).
- The logits are within 1e-4 of the largest |logit|. The float32 ops
  between the int8 layers (BatchNorm, the rescale) differ from XLA's in
  the last bit, so an activation that lies on a rounding midpoint can
  flip one level, which moves every later layer: each flipped layer
  must have seen JAX's input up to float32 noise, and is then fed JAX's
  input so that the bar holds from there on; the flips are counted in
  the assertion messages (`_assert_same_function`).
- A JAX-frozen tree loads into the port's frozen model and computes
  JAX's function by the same rule; fed the inputs JAX's layers saw, every
  int8 layer's activations and int32 accumulators equal JAX's exactly.
  The port's frozen tree, saved by the port's `save_checkpoint`, reads
  back in JAX's `load_checkpoint` leaf for leaf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from paddle_tpu.io import load_checkpoint as jax_load_checkpoint
from paddle_tpu.models import vision as JV
from paddle_tpu.nn.layers import normalize_padding
from paddle_tpu.quant import int8_compute as JI
from paddle_tpu_torch.io import save_checkpoint
from paddle_tpu_torch.models import (CausalLM, ResNet, load_jax_params,
                                     to_jax_params)
from paddle_tpu_torch.models.convert import param_path
from paddle_tpu_torch.nn.layers import Linear
from paddle_tpu_torch.quant.fake_quant import int8_mm
from paddle_tpu_torch.quant.int8_compute import (QMAX, INT8_LAYERS,
                                                 Int8Conv2D, Int8Linear,
                                                 _act_quant, freeze_int8,
                                                 int8_conv2d)
from paddle_tpu_torch.testing import one_torch_thread
from paddle_tpu_torch.utils.tree import flatten_with_keys

CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _t(x):
    return torch.from_numpy(np.array(x))


def _resnet(seed=0):
    torch.manual_seed(seed)
    return ResNet((1, 1, 1, 1), 10, **CPU)


def _rel(out, ref):
    return float(np.abs(out - ref).max() / (np.abs(ref).max() + 1e-9))


# ---------------------------------- tests/test_int8_compute.py's six

def test_linear_scheme_exactness(rng):
    """Int8Linear == the symmetric per-channel formula applied by hand:
    y = (xq @ wq) * xs * ws / 127^2 + b."""
    lin = Linear(6, 8, **CPU)
    x = rng.randn(4, 6).astype(np.float32)
    w = lin.weight.detach().numpy().copy()
    b = lin.bias.detach().numpy().copy()
    qlin, _ = freeze_int8(lin)
    assert isinstance(qlin, Int8Linear)
    with torch.no_grad():
        got = qlin(_t(x)).numpy()
    ws = np.maximum(np.abs(w).max(axis=0), 1e-12)
    wq = np.clip(np.round(w / ws * QMAX), -QMAX, QMAX)
    xs = max(np.abs(x).max(), 1e-12)
    xq = np.clip(np.round(x / xs * QMAX), -QMAX, QMAX)
    want = (xq @ wq) * xs * ws / (QMAX * QMAX) + b
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_freeze_stores_int8_weights():
    _, tree = freeze_int8(_resnet())
    flat = flatten_with_keys(tree["params"])
    n8 = [k for k, leaf in flat if leaf.dtype == np.int8]
    scales = [k for k, _ in flat if k.endswith("/w_scale")]
    assert len(n8) >= 10 and len(n8) == len(scales)


def test_model_accuracy_close_to_float(rng):
    model = _resnet()
    x = _t(rng.randn(4, 32, 32, 3).astype(np.float32))
    with torch.no_grad():
        ref = model(x).numpy()
        qmodel, _ = freeze_int8(model)
        out = qmodel(x).numpy()
    assert _rel(out, ref) < 0.1
    assert (out.argmax(-1) == ref.argmax(-1)).mean() >= 0.75


def test_calibrated_static_scales(rng):
    model = _resnet()
    x = _t(rng.randn(4, 32, 32, 3).astype(np.float32))
    with torch.no_grad():
        ref = model(x).numpy()
    calib = [_t(rng.randn(4, 32, 32, 3).astype(np.float32))
             for _ in range(3)]
    qmodel, tree = freeze_int8(model, calib_batches=calib)
    scales = [leaf for k, leaf in flatten_with_keys(tree["state"])
              if k.endswith("act_scale")]
    assert scales and all(s > 0 for s in scales)
    assert all(m.static_act for m in qmodel.modules()
               if isinstance(m, INT8_LAYERS))
    with torch.no_grad():
        out = qmodel(x).numpy()
    assert _rel(out, ref) < 0.15
    assert (out.argmax(-1) == ref.argmax(-1)).mean() >= 0.75


def test_empty_calibration_rejected():
    with pytest.raises(ValueError, match="empty calib_batches"):
        freeze_int8(Linear(3, 4, **CPU), calib_batches=[])


def test_lm_head_int8(rng):
    """The untied CausalLM (its head a plain Linear) freezes to int8 and
    still gives close logits."""
    torch.manual_seed(0)
    model = CausalLM(61, model_dim=16, num_heads=2, num_layers=1,
                     ffn_dim=32, dropout=0.0, max_len=16,
                     tie_embeddings=False, **CPU)
    tok = _t(rng.randint(0, 61, (2, 8)).astype(np.int32))
    with torch.no_grad():
        ref = model(tok).numpy()
        qmodel, _ = freeze_int8(model)
        out = qmodel(tok).numpy()
    assert isinstance(qmodel.head, Int8Linear)
    assert _rel(out, ref) < 0.2


# ----------------------------------------------------- parity with JAX

def _jax_freeze(jax_model, variables, calib):
    """JAX's own freeze_int8, its model's init and apply jitted."""
    jax_model.init = jax.jit(jax_model.init)
    jax_model.apply = jax.jit(jax_model.apply,
                              static_argnames=("training", "mutable"))
    try:
        return JI.freeze_int8(jax_model, variables, calib)
    finally:
        del jax_model.init, jax_model.apply


def _jax_run(jq, jvars, x):
    """JAX's frozen model jitted on x: (logits, {layer path: (float input,
    output)} of every int8 layer in call order), the layers' forwards
    wrapped on their instances with a host callback."""
    rec = {}

    def wrap(module, prefix=""):
        for name, child in module.children().items():
            path = f"{prefix}/{name}" if prefix else name
            if isinstance(child, (JI.Int8Linear, JI.Int8Conv2D)):
                def forward(cx, a, _orig=child.forward, _path=path):
                    y = _orig(cx, a)
                    jax.debug.callback(
                        lambda u, v, _p=_path: rec.__setitem__(
                            _p, (np.asarray(u), np.asarray(v))), a, y,
                        ordered=True)
                    return y
                child.forward = forward
            wrap(child, path)
    wrap(jq)
    logits = jax.jit(lambda v, a: jq.apply(v, a, training=False))(jvars, x)
    return np.asarray(logits), rec


def _port_run(model, x, forced=None):
    """The port's frozen model on x: (logits, {layer path: float input}
    of every int8 layer). The layers named in `forced` ({path: float
    input}) get that input in place of their own; the record keeps
    their own."""
    rec, forced = {}, forced or {}

    def pre(mod, args, path):
        rec[path] = args[0].detach().numpy().copy()
        if path in forced:
            return (_t(forced[path]),) + tuple(args[1:])
        return None

    hooks = [m.register_forward_pre_hook(
        lambda mod, args, _p=param_path(n + ".x")[:-2]: pre(mod, args, _p))
        for n, m in model.named_modules() if isinstance(m, INT8_LAYERS)]
    try:
        with torch.no_grad():
            logits = model(_t(x)).numpy()
    finally:
        for h in hooks:
            h.remove()
    return logits, rec


def _scale(tree, path) -> float:
    node = tree["state"]
    for part in path.split("/"):
        node = node[part]
    return float(node["act_scale"])


def _levels(a, scale):
    return np.clip(np.round(a / max(scale, 1e-12) * QMAX), -QMAX, QMAX)


def _assert_same_function(model, x, jax_run, port_tree, jax_tree):
    """The port's logits within 1e-4 of JAX's largest |logit|, with every
    int8 layer quantizing its input to JAX's levels.

    The float32 ops between int8 layers (BatchNorm, the rescale) differ
    from XLA's in the last bit, so an input on a rounding midpoint can
    flip one level, which moves every later layer. So the port runs
    again with the first flipped layer fed JAX's input, until no layer
    flips; each flipped layer must have seen JAX's input up to float32
    noise (1e-6 of its largest element, its scale within 1e-6
    relative). The logits of that last run are held to the bar, and the
    flips are counted in every message."""
    jlogits, jrec = jax_run
    forced, flips = {}, {}
    while True:
        logits, rec = _port_run(model, x, forced)
        assert list(rec) and set(rec) == set(jrec)
        new = None
        for path, (ja, _) in jrec.items():    # JAX's call order
            s, js = _scale(port_tree, path), _scale(jax_tree, path)
            fed = forced.get(path, rec[path])
            n = int((_levels(fed, s) != _levels(ja, js)).sum())
            assert not (n and path in forced), (
                f"{path} fed JAX's input still flips {n} levels (scales "
                f"{s} / {js}); flips {flips}")
            if n:
                new = path, n
                break
        if new is None:
            break
        path, n = new
        ja = jrec[path][0]
        noise = float(np.abs(rec[path] - ja).max() / np.abs(ja).max())
        s, js = _scale(port_tree, path), _scale(jax_tree, path)
        flips[path] = n
        assert noise <= 1e-6 and abs(s - js) <= 1e-6 * js, (
            f"int8 flip at {path} from inputs {noise} apart (relative), "
            f"scales {s} / {js}: not float32 noise; flips {flips}")
        forced[path] = ja
    err = float(np.abs(logits - jlogits).max())
    bar = 1e-4 * float(np.abs(jlogits).max())
    assert err <= bar, (f"logits differ by {err} (bar {bar}) with the "
                        f"flipped layers fed JAX's inputs; flips {flips}")
    return flips


@pytest.fixture(scope="module")
def frozen():
    """ResNet((1, 1, 1, 1)) at 16x16 frozen by both packages on one
    calibration batch, and run on another batch."""
    with one_torch_thread():
        rs = np.random.RandomState(7)
        calib, x = (rs.randn(4, 16, 16, 3).astype(np.float32)
                    for _ in range(2))
        port = _resnet(3)
        tree = to_jax_params(port)
        qport, qtree = freeze_int8(port, None, [_t(calib)])
        jq, jvars = _jax_freeze(JV.ResNet((1, 1, 1, 1), 10),
                                jax.tree.map(jnp.asarray, tree),
                                [(jnp.asarray(calib),)])
        jvars = jax.tree.map(np.asarray, jvars)
        return dict(x=x, qport=qport, qtree=qtree, jvars=jvars,
                    jax=_jax_run(jq, jvars, x))


def test_frozen_weights_and_scales_equal_jax(frozen):
    got = dict(flatten_with_keys(frozen["qtree"]))
    want = dict(flatten_with_keys(frozen["jvars"]))
    assert set(got) == set(want)
    n8 = 0
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype, k
        if k.endswith("/act_scale"):
            assert abs(float(g) - float(w)) <= 1e-6 * abs(float(w)), k
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
            n8 += w.dtype == np.int8
    assert n8 >= 10


def test_frozen_logits_match_jax(frozen):
    _assert_same_function(frozen["qport"], frozen["x"], frozen["jax"],
                          frozen["qtree"], frozen["jvars"])


def _loaded(frozen):
    """A port model frozen on its own, then loaded with JAX's frozen
    tree (int8 weights, scales and act_scales) by path."""
    q, _ = freeze_int8(_resnet(11), None,
                       [_t(np.zeros((1, 16, 16, 3), np.float32))])
    load_jax_params(q, frozen["jvars"])
    assert isinstance(q.stem.conv, Int8Conv2D)
    return q


def test_jax_frozen_tree_loads_into_port(frozen):
    """JAX's frozen tree in the port computes JAX's function: the logits
    as `_assert_same_function` holds them."""
    q = _loaded(frozen)
    _assert_same_function(q, frozen["x"], frozen["jax"], frozen["jvars"],
                          frozen["jvars"])


def test_every_layer_matches_jax_on_jax_inputs(frozen):
    """Each int8 layer of the port model holding JAX's tree, fed the float
    input JAX's layer saw: its int8 activations and int32 accumulators
    equal JAX's exactly (the quantization of the same input with the same
    scale, and the int8 product), its output within 1e-6 of JAX's."""
    q = _loaded(frozen)
    layers = {param_path(n + ".x")[:-2]: m for n, m in q.named_modules()
              if isinstance(m, INT8_LAYERS)}
    jvars = frozen["jvars"]
    for path, (ja, jy) in frozen["jax"][1].items():
        layer = layers[path]
        xq, _ = _act_quant(layer, _t(ja))
        want = _levels(ja, _scale(jvars, path)).astype(np.int8)
        np.testing.assert_array_equal(xq.numpy(), want, err_msg=path)
        w8 = layer.weight
        acc = (int8_mm(xq.reshape(-1, xq.shape[-1]), w8)
               if isinstance(layer, Int8Linear) else
               int8_conv2d(xq, w8, layer.stride, layer.padding,
                           layer.dilation, layer.groups))
        jacc = _jax_acc(layer, want, w8.numpy())
        np.testing.assert_array_equal(acc.numpy().reshape(jacc.shape), jacc,
                                      err_msg=path)
        with torch.no_grad():
            y = layer(_t(ja)).numpy()
        assert np.abs(y - jy).max() <= 1e-6 * np.abs(jy).max(), path


def _jax_acc(layer, xq, w8):
    """JAX's int32 accumulators of one int8 layer (int8_compute.py:107,
    :147)."""
    if isinstance(layer, Int8Linear):
        return np.asarray(lax.dot_general(
            jnp.asarray(xq), jnp.asarray(w8), (((xq.ndim - 1,), (0,)),
                                               ((), ())),
            preferred_element_type=jnp.int32))
    return np.asarray(lax.conv_general_dilated(
        jnp.asarray(xq), jnp.asarray(w8), window_strides=layer.stride,
        padding=normalize_padding(layer.padding),
        rhs_dilation=layer.dilation, feature_group_count=layer.groups,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))


def test_port_frozen_tree_reads_in_jax(frozen, tmp_path):
    save_checkpoint(str(tmp_path / "ck"), frozen["qtree"])
    back = jax_load_checkpoint(str(tmp_path / "ck"),
                               target=jax.tree.map(jnp.asarray,
                                                   frozen["jvars"]))
    for (k, a), b in zip(flatten_with_keys(frozen["qtree"]),
                         jax.tree_util.tree_leaves(back)):
        b = np.asarray(b)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
