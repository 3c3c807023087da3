"""The op library's control flow, lattices, extras and detection families
and the metrics, port against JAX, over the shared case table
`paddle_tpu_torch.testing.op_cases`.

- Every case's outputs: the port in float64 within 1e-12 of JAX in
  float64, and the port in float32 within 1e-6 of JAX's float64 program
  on the same float32-rounded inputs (one compiled program serves both
  runs); a case whose float32 behaviour differs from that program
  (`x32`) or that JAX cannot run in float64 (`jax_f64=False`) is held
  against JAX in float32, and an op that computes in float32 whatever
  its input (`f32_inside`) is held in the float32 run alone. Integers
  and booleans exactly (index outputs are int64 in the port where
  JAX's are int32). JAX runs each case as one jitted program, the
  `eager` cases outside jit.
- The gradients of the differentiable cases (CTC, CRF, grid_sampler,
  roi_align and the other RoI pools, yolov3_loss and the extras'
  losses) against `jax.grad` of the same weighted sum, float64, within
  1e-5 relative.
- The random ops draw other numbers than JAX's: each package's draws
  pass the case's range and distribution `check`, and the port's repeat
  under one seed.
- The samplers' selection is fed JAX's own uniform draw
  (`jax.random.uniform(key, (n,))`) and equals JAX's function exactly.
- The table names every public function of the five modules, and the
  port has a counterpart of every public function of JAX's.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.metrics as JM
import paddle_tpu.ops.control_flow as JCF
import paddle_tpu.ops.detection as JD
import paddle_tpu.ops.extras as JE
import paddle_tpu.ops.lattice as JL
from paddle_tpu_torch import metrics as PM
from paddle_tpu_torch.ops import control_flow, detection, extras, lattice
from paddle_tpu_torch.testing import op_cases as oc

SAMPLER_KEY = 11
TOL = {"float64": 1e-12, "float32": 1e-6}


def _jax_ops():
    key = jax.random.key(SAMPLER_KEY)
    det = types.SimpleNamespace(**vars(JD))
    det.rpn_target_assign_by_uniform = (
        lambda a, g, v, u, *args, **kw: JD.rpn_target_assign(
            a, g, v, key, *args, **kw))
    det.generate_proposal_labels_by_uniform = (
        lambda r, g, c, v, u, *args, **kw: JD.generate_proposal_labels(
            r, g, c, v, key, *args, **kw))
    return types.SimpleNamespace(cf=JCF, lat=JL, ext=JE, det=det, met=JM,
                                 xp=jnp, place={}, rng=jax.random.key)


def _inputs(c, dtype, jax_dtype=None):
    """The case's inputs, floats rounded to `dtype` and then held in
    `jax_dtype` (default `dtype`)."""
    arrays = [np.asarray(a) for a in c.inputs(np.random.RandomState(0))]
    arrays = [a.astype(dtype).astype(jax_dtype or dtype)
              if a.dtype.kind == "f" else a for a in arrays]
    if c.uniform is not None:
        n = arrays[c.uniform].shape[0]
        arrays[c.uniform] = np.asarray(jax.random.uniform(
            jax.random.key(SAMPLER_KEY), (n,)))
    return arrays


JAX_OPS = _jax_ops()
# one jitted program a case, so that its float64 and float32 runs share
# the compiled executable
JITTED = {n: jax.jit(lambda *xs, c=c: c.call(JAX_OPS, *xs))
          for n, c in oc.CASES.items()}


def _jax(c, arrays):
    xs = [jnp.asarray(a) for a in arrays]
    return c.call(JAX_OPS, *xs) if c.eager else JITTED[c.name](*xs)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _port(c, arrays, dtype):
    return c.call(oc.PortOps("cpu"), *oc.to_torch(arrays, dtype, "cpu"))


def _x64(on: bool):
    return jax.enable_x64(on)


DETERMINISTIC = [(n, dtype) for n, c in sorted(oc.CASES.items())
                 for dtype in ("float64", "float32") if not c.random
                 and (dtype == "float32" or (c.jax_f64 and not c.f32_inside))]


@pytest.mark.parametrize("name,dtype", DETERMINISTIC)
def test_case_matches_jax(name, dtype):
    c = oc.CASES[name]
    tol = TOL[dtype]
    x64 = c.jax_f64 and not (dtype == "float32" and c.x32)
    with _x64(x64):
        arrays = _inputs(c, dtype, "float64" if x64 else None)
        want = [_np(w) for w in oc.leaves(_jax(c, arrays))]
    arrays = [a.astype(dtype) if a.dtype.kind == "f" else a for a in arrays]
    port = oc.leaves(_port(c, arrays, getattr(torch, dtype)))
    got = [_np(g) for g in port]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        if w.dtype.kind == "f":
            if isinstance(port[i], torch.Tensor):
                assert g.dtype == (dtype if w.dtype == np.float64
                                   else w.dtype), (i, g.dtype, w.dtype)
            np.testing.assert_allclose(g.astype(np.float64), w, rtol=tol,
                                       atol=tol, err_msg=f"{name} output {i}")
        elif w.dtype.kind in "biu":
            assert g.dtype.kind == w.dtype.kind or \
                {g.dtype.kind, w.dtype.kind} == {"i", "u"}, (i, g.dtype)
            np.testing.assert_array_equal(g.astype(np.int64),
                                          w.astype(np.int64),
                                          err_msg=f"{name} output {i}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{name} output {i}")


GRADS = sorted(n for n, c in oc.CASES.items() if c.grad)


@pytest.mark.parametrize("name", GRADS)
def test_gradients_match_jax_grad(name):
    c = oc.CASES[name]
    with _x64(True):
        arrays = _inputs(c, "float64")
        xs = oc.to_torch(arrays, torch.float64, "cpu")
        for i in c.grad:
            xs[i].requires_grad_(True)
        out = [o for o in oc.leaves(c.call(oc.PortOps("cpu"), *xs))
               if isinstance(o, torch.Tensor) and o.is_floating_point()]
        rs = np.random.RandomState(3)
        weights = [rs.randn(*o.shape) for o in out]
        total = sum(torch.sum(torch.as_tensor(w) * o)
                    for w, o in zip(weights, out))
        got = torch.autograd.grad(total, [xs[i] for i in c.grad])
        m = JAX_OPS

        def scalar(*ps):
            args = [jnp.asarray(a) for a in arrays]
            for i, p in zip(c.grad, ps):
                args[i] = p
            leaves = [o for o in oc.leaves(c.call(m, *args))
                      if jnp.issubdtype(o.dtype, jnp.floating)]
            return sum(jnp.sum(w * o) for w, o in zip(weights, leaves))
        grad = jax.grad(scalar, argnums=tuple(range(len(c.grad))))
        want = (grad if c.eager else jax.jit(grad))(
            *[jnp.asarray(arrays[i]) for i in c.grad])
    for i, g, w in zip(c.grad, got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(
            g.numpy(), w, rtol=1e-5, atol=1e-5 * max(1.0, np.abs(w).max()),
            err_msg=f"{name} d/d input {i}")


RANDOM = sorted(n for n, c in oc.CASES.items() if c.random)


@pytest.mark.parametrize("name", RANDOM)
def test_random_ops_hold_range_and_repeat(name):
    c = oc.CASES[name]
    arrays = _inputs(c, "float32")
    a = _port(c, arrays, torch.float32)
    b = _port(c, arrays, torch.float32)
    c.check(a, *arrays)
    for x, y in zip(oc.leaves(a), oc.leaves(b)):
        np.testing.assert_array_equal(_np(x), _np(y))
    c.check(_jax(c, arrays), *arrays)


def test_the_table_covers_every_public_function():
    port = {"control_flow": control_flow, "lattice": lattice,
            "extras": extras, "detection": detection, "metrics": PM.metrics}
    jax_mods = {"control_flow": JCF, "lattice": JL, "extras": JE,
                "detection": JD, "metrics": JM.metrics}
    covered = {f for c in oc.CASES.values() for f in c.covers}
    for mod in oc.MODULES:
        names = oc.public_functions(port[mod])
        missing = [n for n in oc.public_functions(jax_mods[mod])
                   if n not in names]
        assert not missing, (mod, missing)
        untested = [n for n in names if f"{mod}.{n}" not in covered]
        assert not untested, (mod, untested)
    assert sorted(n for n in dir(PM) if not n.startswith("_")
                  and n != "metrics") == sorted(
        n for n in dir(JM) if not n.startswith("_") and n != "metrics")
