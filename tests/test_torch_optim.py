"""The port's optimizers and learning-rate schedules against the JAX
package's: SGD, Adam and AdamW under each grad_clip kind and each
regularization; the other eleven (Momentum plain and Nesterov,
LarsMomentum, Adagrad, DecayedAdagrad, Adamax, Adadelta, RMSProp plain
and centered with momentum, Ftrl, ProximalGD, ProximalAdagrad, Lamb)
with no pre-processing, a global-norm clip and l2 regularization;
`ModelAverage`; every optimizer's slot names and initial slots against
JAX's `init`; and all nine schedules at steps 0-50, to 1e-6 relative.

Both sides compute in float32 in the same order, except reductions (a
clip norm sums in another order) and XLA's freedom to contract a
multiply-add. So "relative" is to each tensor's largest magnitude: an
element that cancels to near 0 (a moment m = 0.9 m + 0.1 g) keeps the
absolute error of its inputs, not a relative one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.optim import lr_schedules as jsched
from paddle_tpu.optim import optimizer as jopt
from paddle_tpu_torch.models import to_jax_opt_state
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.optim import lr_schedules as tsched
from paddle_tpu_torch.optim import optimizer as topt

TOL = dict(rtol=1e-6, atol=1e-9)


def _close(got, want, **kw):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()), **kw)
SHAPES = {"a": (3, 4), "b": (5,), "c": (2, 2, 2)}


def _params(seed):
    rs = np.random.default_rng(seed)
    return {k: rs.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def _run(name, lr, steps=3, **kw):
    """Apply `steps` updates with the same numpy gradients on both sides
    (`lr` a float, or a (JAX, port) pair of schedules); returns (jax
    params, jax slots, port params, port slots)."""
    jlr, tlr = lr if isinstance(lr, tuple) else (lr, lr)
    init = _params(0)
    rs = np.random.default_rng(1)
    grads = [{k: (2.0 * rs.standard_normal(s)).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(steps)]
    jo = getattr(jopt, name)(jlr, **kw)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    js = jo.init(jp)
    for g in grads:
        jp, js = jo.apply(jp, {k: jnp.asarray(v) for k, v in g.items()}, js)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in init.items()}
    to = getattr(topt, name)(list(tp.values()), tlr, **kw)
    for g in grads:
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        to.step()
    assert int(js["step"]) == to.step_count == steps
    assert set(to.SLOTS) == set(js["slots"])
    tslots = {slot: {k: to.state[p][slot].numpy() for k, p in tp.items()}
              for slot in js["slots"]}
    return (jp, js["slots"], {k: p.detach().numpy() for k, p in tp.items()},
            tslots)


CLIPS = [None, ("value", 0.5), ("norm", 1.0), ("global_norm", 1.5)]
REGS = [None, ("l2", 0.01), ("l1", 0.02)]


@pytest.mark.parametrize("reg", REGS, ids=lambda r: r and r[0])
@pytest.mark.parametrize("clip", CLIPS, ids=lambda c: c and c[0])
@pytest.mark.parametrize("name", ["SGD", "Adam", "AdamW"])
def test_optimizer_matches_jax(name, clip, reg):
    jp, jslots, tp, tslots = _run(name, 1e-2, grad_clip=clip,
                                  regularization=reg)
    for k in SHAPES:
        _close(tp[k], jp[k], err_msg=f"param {k}")
        for slot, tree in jslots.items():
            assert tslots[slot][k].dtype == np.float32
            _close(tslots[slot][k], tree[k], err_msg=f"slot {slot}/{k}")


def test_adam_weight_decay_and_schedule_lr_match_jax():
    jp, jslots, tp, tslots = _run(
        "Adam", (jsched.noam_decay(64, 4), tsched.noam_decay(64, 4)),
        steps=5, weight_decay=0.05)
    for k in SHAPES:
        _close(tp[k], jp[k])
        _close(tslots["v"][k], jslots["v"][k])


def test_bad_kinds_raise():
    p = [torch.nn.Parameter(torch.zeros(2))]
    with pytest.raises(ValueError, match="grad_clip"):
        topt.SGD(p, 0.1, grad_clip=("max", 1.0))
    with pytest.raises(ValueError, match="regularization"):
        topt.Adam(p, 0.1, regularization=("l3", 1.0))


def test_missing_grad_updates_with_zero_like_jax():
    """A parameter without a gradient still steps (Adam's moments decay),
    as every JAX leaf gets a gradient."""
    p = torch.nn.Parameter(torch.ones(3))
    opt = topt.Adam([p], 0.1)
    p.grad = torch.ones(3)
    opt.step()
    before = p.detach().clone()
    p.grad = None
    opt.step()
    assert not torch.equal(p.detach(), before)
    assert opt.step_count == 2


OPTIMIZERS = {
    "Momentum": ("Momentum", 0.05, {}),
    "Momentum_nesterov": ("Momentum", 0.05, dict(use_nesterov=True)),
    "LarsMomentum": ("LarsMomentum", 0.5, dict(lars_coeff=0.1)),
    "Adagrad": ("Adagrad", 0.05, dict(initial_accumulator_value=0.1)),
    "DecayedAdagrad": ("DecayedAdagrad", 0.05, {}),
    "Adamax": ("Adamax", 0.01, {}),
    "Adadelta": ("Adadelta", 1.0, {}),
    "RMSProp": ("RMSProp", 0.01, {}),
    "RMSProp_centered": ("RMSProp", 0.01, dict(centered=True,
                                               momentum=0.5)),
    "Ftrl": ("Ftrl", 0.05, dict(l1=0.01, l2=0.02)),
    "ProximalGD": ("ProximalGD", 0.05, dict(l1=0.01, l2=0.02)),
    "ProximalAdagrad": ("ProximalAdagrad", 0.05, dict(l1=0.01, l2=0.02)),
    "Lamb": ("Lamb", 0.01, {}),
}
PREPROCESS = {
    "plain": {},
    "grad_clip": dict(grad_clip=("global_norm", 1.5)),
    "regularization": dict(regularization=("l2", 0.01)),
}
ALL = ["SGD", "Momentum", "LarsMomentum", "Adagrad", "DecayedAdagrad",
       "Adam", "AdamW", "Adamax", "Adadelta", "RMSProp", "Ftrl",
       "ProximalGD", "ProximalAdagrad", "Lamb"]


@pytest.mark.parametrize("prep", sorted(PREPROCESS))
@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_other_optimizers_match_jax(opt, prep):
    name, lr, kw = OPTIMIZERS[opt]
    jp, jslots, tp, tslots = _run(name, lr, **kw, **PREPROCESS[prep])
    for k in SHAPES:
        _close(tp[k], jp[k], err_msg=f"param {k}")
        for slot, tree in jslots.items():
            assert tslots[slot][k].dtype == np.float32
            _close(tslots[slot][k], tree[k], err_msg=f"slot {slot}/{k}")


def test_model_average_matches_jax():
    init = _params(2)
    rs = np.random.default_rng(3)
    seq = [{k: rs.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()} for _ in range(3)]
    jma = jopt.ModelAverage(decay=0.9)
    javg = jma.init({k: jnp.asarray(v) for k, v in init.items()})
    tma = topt.ModelAverage(decay=0.9)
    tparams = [torch.from_numpy(init[k].copy()) for k in SHAPES]
    tavg = tma.init(tparams)
    for params in seq:
        javg = jma.update(javg, {k: jnp.asarray(v) for k, v in params.items()})
        out = tma.update(tavg, [torch.from_numpy(params[k]) for k in SHAPES])
        assert out is tavg
    for k, a in zip(SHAPES, tavg):
        assert a.dtype == torch.float32
        _close(a.numpy(), javg[k])


class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = Linear(3, 2)
        self.out = Linear(2, 1)


@pytest.mark.parametrize("name", ALL)
def test_slot_names_and_initial_slots_match_jax_init(name):
    """Before any step, to_jax_opt_state gives the slot names, paths and
    values of JAX's `init` on the same parameters (Adagrad's
    accumulator starts at its initial value, not at zero)."""
    model = _Tiny()
    kw = dict(initial_accumulator_value=0.25) if name == "Adagrad" else {}
    opt = getattr(topt, name)(model.parameters(), 0.1, **kw)
    params = {"fc": {"weight": np.zeros((3, 2), np.float32),
                     "bias": np.zeros(2, np.float32)},
              "out": {"weight": np.zeros((2, 1), np.float32),
                      "bias": np.zeros(1, np.float32)}}
    want = getattr(jopt, name)(0.1, **kw).init(
        jax.tree_util.tree_map(jnp.asarray, params))
    got = to_jax_opt_state(model, opt)
    assert int(got["step"]) == 0
    assert (jax.tree_util.tree_structure(got["slots"])
            == jax.tree_util.tree_structure(want["slots"]))
    for g, w in zip(jax.tree_util.tree_leaves(got["slots"]),
                    jax.tree_util.tree_leaves(want["slots"])):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_slots_update_in_place():
    """Each step writes into the slot tensors the first step made, so a
    view taken between steps (Trainer.state) stays live."""
    p = torch.nn.Parameter(torch.ones(4))
    opt = topt.RMSProp([p], 0.1, centered=True, momentum=0.9)
    p.grad = torch.ones(4)
    opt.step()
    held = dict(opt.state[p])
    before = {k: v.clone() for k, v in held.items()}
    opt.step()
    for k, v in held.items():
        assert opt.state[p][k] is v
    assert not torch.equal(held["mom"], before["mom"])


SCHEDULES = {
    "constant": lambda m: m.constant(0.3),
    "exponential": lambda m: m.exponential_decay(0.5, 7, 0.8),
    "exponential_staircase": lambda m: m.exponential_decay(0.5, 7, 0.8,
                                                           staircase=True),
    "natural_exp": lambda m: m.natural_exp_decay(0.4, 5, 0.3),
    "natural_exp_staircase": lambda m: m.natural_exp_decay(
        0.4, 5, 0.3, staircase=True),
    "inverse_time": lambda m: m.inverse_time_decay(0.2, 3, 0.5),
    "inverse_time_staircase": lambda m: m.inverse_time_decay(
        0.2, 3, 0.5, staircase=True),
    "polynomial": lambda m: m.polynomial_decay(0.1, 30, 1e-3, power=2.0),
    "polynomial_cycle": lambda m: m.polynomial_decay(0.1, 12, 1e-3,
                                                     power=1.5, cycle=True),
    "piecewise": lambda m: m.piecewise_decay([5, 17, 40],
                                             [1.0, 0.5, 0.1, 0.01]),
    "cosine": lambda m: m.cosine_decay(0.7, 4, 9),
    "noam": lambda m: m.noam_decay(512, 10, 2.0),
    "linear_warmup": lambda m: m.linear_warmup(m.cosine_decay(0.5, 3, 10),
                                               12, start_lr=0.01),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax(name):
    js, ts = SCHEDULES[name](jsched), SCHEDULES[name](tsched)
    for step in range(51):
        want = np.asarray(js(jnp.asarray(step, jnp.int32)))
        got = ts(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, **TOL,
                                   err_msg=f"step {step}")
        np.testing.assert_allclose(ts(step).numpy(), want, **TOL)
