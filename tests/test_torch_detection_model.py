"""The port's SSD-lite (`models/detection.py`) against
tests/test_detection_model.py and the JAX model on the same weights.

`test_ssd_match_exact_prior` is mirrored here; JAX's
`test_ssd_trains_to_above_chance_map` is mirrored in
tests/test_torch_book.py with the other end-to-end chapters.
Parity: `SSDLite.priors()`; the forward in train mode (with the new
BatchNorm `state`) and in eval mode; `ssd_match` with padded gt rows
and forced matches; `ssd_loss` and its gradient; `ssd_detect`. The
weights are a tree in JAX's layout (the port's seeded init with drawn
norms, its paths and shapes held to JAX's `init` by `jax.eval_shape`),
loaded by path with `load_jax_params`.

Bars: priors, match targets and detections 1e-5 (float32 box
arithmetic); the model's outputs, state and the loss's gradients
within 1e-4 of each tensor's largest element (float32 error compounds
through the layers). Matches and labels are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import detection as JD
from paddle_tpu_torch.models import load_jax_params, to_jax_params
from paddle_tpu_torch.models.convert import param_path
from paddle_tpu_torch.models.detection import (SSDLite, ssd_detect,
                                               ssd_loss, ssd_match)
from paddle_tpu_torch.testing import one_torch_thread
from paddle_tpu_torch.utils.tree import flatten_with_keys, nest


@pytest.fixture(autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


IMG = 96
NCLS = 4


def _t(x):
    return torch.from_numpy(np.array(x))


def test_ssd_match_exact_prior():
    priors, _ = SSDLite(num_classes=NCLS, image_size=IMG,
                        device="cpu").priors()
    gt = torch.cat([priors[100:101], torch.zeros(3, 4)])
    conf_t, loc_t, pos = ssd_match(priors, gt, torch.tensor([2, 0, 0, 0]),
                                   torch.tensor(1))
    assert bool(pos[100])
    assert int(conf_t[100]) == 3          # label 2 -> class id 3 (bg=0)
    np.testing.assert_allclose(loc_t[100].numpy(), 0.0, atol=1e-4)


# ---------------------------------------------------- parity with JAX

def _pair(seed=0):
    jm = JD.SSDLite(num_classes=NCLS, image_size=IMG)
    pm = SSDLite(num_classes=NCLS, image_size=IMG, device="cpu")
    x = np.random.RandomState(seed).rand(2, IMG, IMG, 3).astype(np.float32)
    want = jax.eval_shape(lambda a: jm.init(0, a), jnp.asarray(x))
    rs = np.random.RandomState(seed + 1)
    flat = {}
    for k, a in flatten_with_keys(to_jax_params(pm)):
        if a.ndim > 1:
            a = (rs.randn(*a.shape) * (2.0 / np.prod(a.shape[:-1])) ** 0.5
                 ).astype(np.float32)
        elif k.endswith(("/var", "/scale")):
            a = (rs.rand(*a.shape) + 0.5).astype(np.float32)
        else:
            a = (rs.randn(*a.shape) * 0.1).astype(np.float32)
        flat[k] = a
    assert {k: a.shape for k, a in flat.items()} == {
        k: tuple(a.shape) for k, a in flatten_with_keys(want)}
    v = nest(flat)
    load_jax_params(pm, v)
    return jm, pm, v, x


def _gt(priors, seed=2):
    """Two images' padded gt: image 0 has 3 boxes (one equal to a prior:
    a forced match), image 1 has 1; rows past the count are padding
    that overlaps many priors (it must match nothing)."""
    rs = np.random.RandomState(seed)
    boxes = np.zeros((2, 4, 4), np.float32)
    for i, n in enumerate((3, 1)):
        for j in range(4):
            lo = rs.rand(2) * 0.6
            boxes[i, j] = np.concatenate([lo, lo + 0.15 + rs.rand(2) * 0.3])
    boxes[0, 2] = np.asarray(priors[321])
    labels = rs.randint(0, NCLS, (2, 4))
    return boxes, labels, np.array([3, 1])


def _close(got, want, bar, what="", floor=0.0):
    """|got - want| within bar x the larger of want's largest element
    and `floor` (1 for coordinates in [0, 1])."""
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    err = float(np.abs(got - want).max())
    assert err <= bar * max(float(np.abs(want).max()), floor), (what, err)


def test_priors_match_jax():
    jm, pm, _, _ = _pair()
    jp, jv = jax.jit(jm.priors)()
    pp, pv = pm.priors()
    assert pp.shape == (1080, 4)
    _close(pp, jp, 1e-6, floor=1.0)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


def test_forward_matches_jax_train_and_eval():
    jm, pm, v, x = _pair()
    (jcls, jloc), mut = jax.jit(lambda vv, a: jm.apply(
        vv, a, training=True, mutable=True))(v, jnp.asarray(x))
    cls, loc = pm.train()(_t(x))
    _close(cls, jcls, 1e-4, "cls")
    _close(loc, jloc, 1e-4, "loc")
    got = dict(flatten_with_keys(to_jax_params(pm)["state"]))
    for k, w in flatten_with_keys(jax.device_get(mut["state"])):
        _close(got[k], w, 1e-4, k)
    jcls, jloc = jax.jit(jm.apply)({"params": v["params"],
                                    "state": mut["state"]}, jnp.asarray(x))
    with torch.no_grad():
        cls, loc = pm.eval()(_t(x))
    _close(cls, jcls, 1e-4, "eval cls")
    _close(loc, jloc, 1e-4, "eval loc")


def test_ssd_match_matches_jax():
    priors, _ = SSDLite(num_classes=NCLS, image_size=IMG,
                        device="cpu").priors()
    boxes, labels, nb = _gt(priors.numpy())
    jmatch = jax.jit(JD.ssd_match)
    for i in range(2):
        want = jmatch(jnp.asarray(priors.numpy()), jnp.asarray(boxes[i]),
                      jnp.asarray(labels[i]), jnp.asarray(nb[i]))
        got = ssd_match(priors, _t(boxes[i]), _t(labels[i]), _t(nb[i]))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        _close(got[1], want[1], 1e-5, "loc_target", floor=1.0)
        assert int(got[2].sum()) >= nb[i]
    assert bool(ssd_match(priors, _t(boxes[0]), _t(labels[0]),
                          _t(nb[0]))[2][321])


def test_ssd_loss_and_grad_match_jax():
    jm, pm, v, x = _pair(3)
    priors, _ = pm.priors()
    boxes, labels, nb = _gt(priors.numpy(), 4)
    jpri = jnp.asarray(priors.numpy())

    def jloss(params):
        (c, lc), _ = jm.apply({"params": params, "state": v["state"]},
                              jnp.asarray(x), training=True, mutable=True)
        return JD.ssd_loss(c, lc, jpri, jnp.asarray(boxes),
                           jnp.asarray(labels), jnp.asarray(nb))
    want, jg = jax.jit(jax.value_and_grad(jloss))(v["params"])
    cls, loc = pm.train()(_t(x))
    loss = ssd_loss(cls, loc, priors, _t(boxes), _t(labels), _t(nb))
    loss.backward()
    assert loss.item() == pytest.approx(float(want), rel=1e-5)
    pg = {"params/" + param_path(n): p.grad
          for n, p in pm.named_parameters()}
    for k, w in flatten_with_keys({"params": jax.device_get(jg)}):
        _close(pg[k], w, 1e-4, k)


def test_ssd_detect_matches_jax():
    jm, pm, v, x = _pair(5)
    priors, var = pm.priors()
    with torch.no_grad():
        cls, loc = pm(_t(x))
    cls = cls * 3.0                         # sharper scores: some pass 0.3
    want, wcount = jax.jit(lambda *a: JD.ssd_detect(
        *a, score_threshold=0.3))(*(jnp.asarray(t.numpy())
                                    for t in (cls, loc, priors, var)))
    got, count = ssd_detect(cls, loc, priors, var, score_threshold=0.3)
    np.testing.assert_array_equal(count.numpy(), np.asarray(wcount))
    assert int(count.sum()) > 0
    np.testing.assert_array_equal(got[..., 0].numpy(),
                                  np.asarray(want[..., 0]))
    _close(got, want, 1e-5, "detections", floor=1.0)
