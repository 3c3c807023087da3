"""Numeric-gradient op-test harness (port of
paddle_tpu/testing/op_test.py; the reference OpTest's
`get_numeric_gradient` and `check_grad`).

Every differentiable op's analytic gradient (`torch.autograd`) is held
against central finite differences, in float64 so that the differences'
truncation error, not float32 rounding, sets the tolerance. The
function's outputs are first projected to one scalar by random weights
drawn from `np.random.RandomState(seed)`, output leaf by output leaf in
the order JAX flattens them, as the JAX harness draws them: a plain
sum would let sign errors that cancel across elements slip through.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.utils.tree import flatten_with_keys, map_leaves


def _is_float(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_floating_point()
    return np.issubdtype(np.asarray(x).dtype, np.floating)


def _f64(x) -> torch.Tensor:
    """A leaf as a tensor: floats in float64, the rest as they are."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t.double() if t.is_floating_point() else t


def _leaves(tree):
    return [leaf for _, leaf in flatten_with_keys(tree)]


def _scalarize(f: Callable, args: tuple, rng: np.random.RandomState):
    """f wrapped to return sum(w_i * out_i) for fixed random weights w,
    one array a floating output leaf."""
    with torch.no_grad():
        flat = _leaves(f(*args))
    weights = [torch.as_tensor(rng.randn(*tuple(o.shape)), dtype=o.dtype)
               if _is_float(o) else None for o in flat]

    def scalar_f(*a):
        tot = torch.zeros((), dtype=torch.float64)
        for w, o in zip(weights, _leaves(f(*a))):
            if w is not None:
                tot = tot + torch.sum(w * o.to(w.dtype))
        return tot.double()

    return scalar_f


def numeric_grad(scalar_f: Callable, args: tuple, argnum: int,
                 eps: float = 1e-5) -> np.ndarray:
    """Central-difference gradient of a scalar function w.r.t.
    args[argnum], one element at a time (O(n) evaluations, for the tiny
    shapes op tests use)."""
    x = np.asarray(args[argnum].detach().numpy(), np.float64)
    grad = np.zeros_like(x)
    flat = x.reshape(-1)
    gflat = grad.reshape(-1)
    with torch.no_grad():
        for i in range(flat.size):
            for sign in (+1.0, -1.0):
                pert = flat.copy()
                pert[i] += sign * eps
                new_args = list(args)
                new_args[argnum] = torch.from_numpy(pert.reshape(x.shape))
                gflat[i] += sign * float(scalar_f(*new_args))
            gflat[i] /= 2.0 * eps
    return grad


def check_grad(f: Callable, *args: Any,
               argnums: Optional[Sequence[int]] = None,
               eps: float = 1e-5, rtol: float = 5e-4, atol: float = 5e-5,
               seed: int = 0, name: str = "") -> None:
    """Assert torch.autograd's gradient of f matches finite differences
    at `args` (numpy arrays or tensors, taken in float64).

    argnums defaults to every floating-point positional argument.
    Raises AssertionError with each argument's max abs/rel error on a
    mismatch."""
    args = tuple(map_leaves(_f64, a) for a in args)
    if argnums is None:
        argnums = [i for i, a in enumerate(args)
                   if all(_is_float(leaf) for leaf in _leaves(a))]
    rng = np.random.RandomState(seed)
    scalar_f = _scalarize(f, args, rng)
    inputs = [args[i].clone().requires_grad_(True) for i in argnums]
    live = list(args)
    for i, t in zip(argnums, inputs):
        live[i] = t
    analytic = torch.autograd.grad(scalar_f(*live), inputs,
                                   allow_unused=True)
    for an, g, x in zip(argnums, analytic, inputs):
        num = numeric_grad(scalar_f, args, an, eps=eps)
        got = (np.zeros_like(num) if g is None
               else g.detach().numpy().astype(np.float64))
        err = np.abs(got - num)
        denom = np.maximum(np.abs(num), 1.0)
        ok = np.all(err <= atol + rtol * denom)
        assert ok, (
            f"gradient mismatch {name or getattr(f, '__name__', f)} "
            f"arg {an}: max_abs_err={err.max():.3e} "
            f"max_rel_err={(err / denom).max():.3e} "
            f"(eps={eps}, rtol={rtol}, atol={atol})\n"
            f"analytic:\n{got}\nnumeric:\n{num}")


def check_output(f: Callable, ref: Callable, *args: Any,
                 rtol: float = 1e-5, atol: float = 1e-6,
                 name: str = "") -> None:
    """Assert f(*args) (args as tensors) matches a numpy reference
    implementation (the reference OpTest.check_output)."""
    with torch.no_grad():
        got = _leaves(f(*[torch.as_tensor(np.asarray(a)) for a in args]))
    want = _leaves(ref(*[np.asarray(a) for a in args]))
    assert len(got) == len(want), (
        f"{name}: output arity {len(got)} != reference {len(want)}")
    for g, w in zip(got, want):
        g = g.detach().cpu().numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_allclose(np.asarray(g), w, rtol=rtol, atol=atol,
                                   err_msg=f"output mismatch in {name}")
