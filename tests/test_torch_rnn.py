"""The port's recurrent layers (`nn/rnn.py`) against tests/test_rnn.py's
six tests and against the JAX layers on the same weights: `LSTMCell`
(with and without `proj_size`), `GRUCell`, `BiRNN` and `StackedLSTM`,
with and without lengths, forward and reverse — outputs, final carries
and the gradients of the input and every weight. JAX's trees load by
path (`cell/wx`, `fwd/cell/wx`, `rnns_0/cell/wx`).

Bars: outputs and carries float32 to 1e-5 relative (atol 1e-6; a step
is a few matmuls and gates, and the error compounds over the time
steps only through contracting gates); gradients within 1e-5 of each
tensor's largest element. JAX runs each function jitted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn import rnn as JR
from paddle_tpu_torch.models import load_jax_params, to_jax_params
from paddle_tpu_torch.models.convert import param_path
from paddle_tpu_torch.nn.rnn import (BiRNN, GRUCell, LSTMCell, RNN,
                                     StackedLSTM)
from paddle_tpu_torch.testing import one_torch_thread
from paddle_tpu_torch.utils.tree import flatten_with_keys, nest


@pytest.fixture(autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _t(x):
    return torch.from_numpy(np.array(x))


def _np_sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


# ------------------------------------------------ tests/test_rnn.py mirrors

def test_lstm_cell_matches_numpy(rng):
    model = RNN(LSTMCell(3, hidden=5, forget_bias=0.0))
    x = rng.randn(2, 3).astype(np.float32)
    y, (h, c) = model(_t(x)[:, None, :])
    p = model.cell
    z = x @ p.wx.detach().numpy() + p.bias.detach().numpy()
    i, f, g, o = np.split(z, 4, axis=-1)
    c_ref = _np_sigmoid(f) * 0 + _np_sigmoid(i) * np.tanh(g)
    h_ref = _np_sigmoid(o) * np.tanh(c_ref)
    np.testing.assert_allclose(h.detach().numpy(), h_ref, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(y[:, 0].detach().numpy(), h_ref, rtol=1e-5,
                               atol=1e-5)


def test_dynamic_rnn_masking_freezes_finished_rows(rng):
    model = RNN(LSTMCell(2, hidden=4))
    x = _t(rng.randn(3, 6, 2).astype(np.float32))
    y, (h, c) = model(x, torch.tensor([6, 2, 4]))
    _, (h2, _) = model(x[1:2, :2])
    np.testing.assert_allclose(h[1].detach().numpy(), h2[0].detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(y[1, 2:].detach().numpy(), 0.0, atol=1e-6)


def test_gru_learns_and_shapes(rng):
    y, h = RNN(GRUCell(3, 8))(_t(rng.randn(4, 5, 3).astype(np.float32)))
    assert y.shape == (4, 5, 8) and h.shape == (4, 8)


def test_birnn_concat(rng):
    y, _ = BiRNN(LSTMCell(3, 4), LSTMCell(3, 4))(
        _t(rng.randn(2, 5, 3).astype(np.float32)))
    assert y.shape == (2, 5, 8)


def test_stacked_lstm_grad_flows(rng):
    model = StackedLSTM(3, hidden=6, layers=2)
    y, _ = model(_t(rng.randn(2, 4, 3).astype(np.float32)))
    (y ** 2).sum().backward()
    norms = [float(p.grad.norm()) for p in model.parameters()]
    assert all(np.isfinite(n) for n in norms)
    assert any(n > 0 for n in norms)


def test_lstmp_projection():
    cell = LSTMCell(5, 16, proj_size=8)
    carry = cell.init_carry(4)
    assert carry[0].shape == (4, 8)
    assert carry[1].shape == (4, 16)
    (h2, c2), out = cell(carry, torch.ones(4, 5))
    assert h2.shape == (4, 8) and c2.shape == (4, 16) and out.shape == (4, 8)


# ------------------------------------------------ parity with JAX

B, T, D = 3, 6, 4
LENGTHS = np.array([6, 2, 4])


def _models(kind):
    """(JAX module, port module) for each layer kind."""
    if kind == "lstm":
        return JR.RNN(JR.LSTMCell(5, forget_bias=0.5)), RNN(
            LSTMCell(D, 5, forget_bias=0.5))
    if kind == "lstm_reverse":
        return (JR.RNN(JR.LSTMCell(5), reverse=True),
                RNN(LSTMCell(D, 5), reverse=True))
    if kind == "lstmp":
        return JR.RNN(JR.LSTMCell(6, proj_size=3)), RNN(
            LSTMCell(D, 6, proj_size=3))
    if kind == "gru":
        return JR.RNN(JR.GRUCell(5)), RNN(GRUCell(D, 5))
    if kind == "gru_reverse":
        return (JR.RNN(JR.GRUCell(5), reverse=True),
                RNN(GRUCell(D, 5), reverse=True))
    if kind == "birnn":
        return (JR.BiRNN(JR.LSTMCell(4), JR.GRUCell(3)),
                BiRNN(LSTMCell(D, 4), GRUCell(D, 3)))
    if kind == "stacked":
        return JR.StackedLSTM(5, layers=3), StackedLSTM(D, 5, layers=3)
    raise ValueError(kind)


def _flat(out):
    leaves = []
    for v in (out if isinstance(out, (tuple, list)) else [out]):
        leaves += _flat(v) if isinstance(v, (tuple, list)) else [v]
    return leaves


@pytest.mark.parametrize("lengths", [False, True], ids=["dense", "lengths"])
@pytest.mark.parametrize("kind", ["lstm", "lstm_reverse", "lstmp", "gru",
                                  "gru_reverse", "birnn", "stacked"])
def test_matches_jax(kind, lengths):
    rs = np.random.RandomState(7)
    x = rs.randn(B, T, D).astype(np.float32)
    jm, pm = _models(kind)
    # the port's seeded init, with random biases (init makes zeros), held
    # to JAX's init tree (paths and shapes; nothing compiled)
    torch.manual_seed(7)
    flat = dict(flatten_with_keys(to_jax_params(_models(kind)[1])))
    for k in flat:
        if k.endswith("bias"):
            flat[k] = rs.randn(*flat[k].shape).astype(np.float32) * 0.3
    want = jax.eval_shape(lambda a: jm.init(0, a), jnp.asarray(x))
    assert {k: tuple(a.shape) for k, a in flat.items()} == {
        k: tuple(a.shape) for k, a in flatten_with_keys(want)}
    v = nest(flat)
    load_jax_params(pm, v)
    lens = LENGTHS if lengths else None

    def jfwd(params, xx):
        return jm.apply({"params": params}, xx,
                        None if lens is None else jnp.asarray(lens))
    jout = jax.jit(jfwd)(v["params"], jnp.asarray(x))
    jleaves = _flat(jout)
    r = [rs.randn(*np.shape(a)).astype(np.float32) for a in jleaves]

    def jloss(params, xx):
        return sum(jnp.sum(a * b) for a, b in zip(_flat(jfwd(params, xx)),
                                                 r))
    jdp, jdx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(v["params"],
                                                        jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    pout = pm(xt, None if lens is None else _t(lens))
    pleaves = _flat(pout)
    assert len(pleaves) == len(jleaves)
    for got, want in zip(pleaves, jleaves):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
    sum((a * _t(b)).sum() for a, b in zip(pleaves, r)).backward()
    grads = dict(flatten_with_keys({"params": jax.device_get(jdp)}))
    port = {"params/" + param_path(n): p.grad
            for n, p in pm.named_parameters()}
    for path, want in [("x", jdx)] + sorted(grads.items()):
        got = xt.grad if path == "x" else port[path]
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()),
                                   err_msg=path)
    assert set(to_jax_params(pm)["params"]) == set(v["params"])


def test_gru_bf16_promotes_at_the_bias_like_jax():
    """x @ wx in bf16 plus the float32 bias promotes to float32, in both
    packages: the new carry is float32."""
    x = np.random.RandomState(8).randn(2, D).astype(np.float32)
    jcell = JR.GRUCell(5, dtype=jnp.bfloat16)
    h0 = jcell.init_carry(2)
    v = jax.device_get(jcell.init(0, h0, jnp.asarray(x)))
    pcell = GRUCell(D, 5, dtype=torch.bfloat16)
    load_jax_params(pcell, v)
    (jh, _) = jcell.apply(v, h0, jnp.asarray(x))
    ph, _ = pcell(pcell.init_carry(2), _t(x))
    assert jh.dtype == jnp.float32 and ph.dtype == torch.float32
    np.testing.assert_allclose(ph.detach().numpy(), np.asarray(jh),
                               rtol=1e-2, atol=1e-2)
