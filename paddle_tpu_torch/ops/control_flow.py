"""Control-flow ops (port of paddle_tpu/ops/control_flow.py): while /
cond / switch / case, the piecewise lookup, StaticRNN and scan.

JAX traces both branches and loops inside one compiled program; here
they are Python control flow over tensor ops. The loops whose contract
is a data-dependent trip count or branch (`while_loop`, `cond`,
`switch`, `case`) read their predicate on the host; `static_rnn` and
`scan` run a fixed number of steps and never do. The JAX semantics
kept:

- `switch` clamps the index into range, as `lax.switch` does (a Python
  list index would wrap a negative one);
- `case` takes the first true predicate; with `default=None` the last
  pair's function is the default and its predicate is never read;
- `static_rnn` with `lengths` freezes each row's state past its length
  and zeroes its padded outputs; with `reverse` the position of step s
  is T - 1 - s;
- `scan` is `lax.scan` over pytrees (dicts, lists, tuples), `unroll`
  accepted and ignored.

Bounds, predicates and indices may be Python numbers or 0-d tensors.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple

import torch

from paddle_tpu_torch.device import DeviceLike, resolve_device
from paddle_tpu_torch.utils.tree import flatten_with_keys, map_leaves

Pytree = Any


def _leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_keys(tree)]


def while_loop(cond_fn: Callable[[Pytree], Any],
               body_fn: Callable[[Pytree], Pytree],
               init: Pytree,
               max_iter: Optional[int] = None) -> Pytree:
    """`while cond_fn(x): x = body_fn(x)` with pytree state; `max_iter`
    bounds the trip count."""
    x, i = init, 0
    while (max_iter is None or i < max_iter) and bool(cond_fn(x)):
        x = body_fn(x)
        i += 1
    return x


def fori_loop(lower, upper, body_fn: Callable[[Any, Pytree], Pytree],
              init: Pytree) -> Pytree:
    """`for i in range(lower, upper): x = body_fn(i, x)`."""
    x = init
    for i in range(int(lower), int(upper)):
        x = body_fn(i, x)
    return x


def cond(pred, true_fn: Callable, false_fn: Callable, *operands) -> Pytree:
    """Two-way conditional: one branch runs."""
    return true_fn(*operands) if bool(pred) else false_fn(*operands)


def switch(index, branches: Sequence[Callable], *operands) -> Pytree:
    """N-way branch by integer index, clamped into range."""
    i = min(max(int(index), 0), len(branches) - 1)
    return branches[i](*operands)


def case(pred_fn_pairs: Sequence[Tuple[Any, Callable]],
         default: Optional[Callable] = None,
         operands: Tuple = ()) -> Pytree:
    """The function of the first true predicate, else `default`; branch
    functions take *operands (passed by keyword)."""
    pairs = list(pred_fn_pairs)
    if default is None:
        *pairs, (_, default) = pairs
    for pred, fn in pairs:
        if bool(pred):
            return fn(*operands)
    return default(*operands)


def piecewise(x, boundaries: Sequence[float], values: Sequence[Any],
              device: DeviceLike = None):
    """values[i] where x < boundaries[i], else values[-1] (the Switch
    idiom behind piecewise_decay). The result lies on the device of the
    first tensor among x and values, else on `device` (default the
    card)."""
    if len(values) != len(boundaries) + 1:
        raise ValueError("need len(values) == len(boundaries) + 1")
    tensors = [v for v in (x, *values) if isinstance(v, torch.Tensor)]
    dev = tensors[0].device if tensors else resolve_device(device)
    b = torch.as_tensor(boundaries, device=dev)
    idx = torch.sum(torch.as_tensor(x, device=dev) >= b)
    return torch.stack([torch.as_tensor(v, device=dev) for v in values])[idx]


def static_rnn(step_fn: Callable[[Pytree, Pytree], Tuple[Pytree, Pytree]],
               inputs: Pytree, init_state: Pytree,
               lengths: Optional[torch.Tensor] = None,
               reverse: bool = False) -> Tuple[Pytree, Pytree]:
    """step_fn(state, x_t) -> (new_state, y_t) over [B, T, ...] inputs.
    Returns (ys [B, T, ...], final_state); with `lengths` the state
    freezes past each row's length (final_state is the last valid one)
    and padded outputs are zero."""
    t = _leaves(inputs)[0].shape[1]
    state, ys = init_state, []
    for step in range(t):
        pos = t - 1 - step if reverse else step
        new_state, y = step_fn(state, map_leaves(lambda a: a[:, pos], inputs))
        if lengths is not None:
            alive = pos < lengths

            def keep(new, old, alive=alive):
                m = alive.reshape((-1,) + (1,) * (new.ndim - 1))
                return torch.where(m, new, old)
            new_state = map_leaves(keep, new_state, state)
            y = map_leaves(lambda a: keep(a, torch.zeros_like(a)), y)
        state = new_state
        ys.append(y)
    if reverse:
        ys.reverse()
    return map_leaves(lambda *steps: torch.stack(steps, 1), *ys), state


def scan(f: Callable, init: Pytree, xs: Pytree, length: Optional[int] = None,
         reverse: bool = False, unroll: int = 1):
    """lax.scan: (final carry, ys stacked on a new leading axis), ys[i]
    from xs[i] also when `reverse` runs the steps from the end."""
    n = length if xs is None else _leaves(xs)[0].shape[0]
    carry, ys = init, []
    for i in (range(n - 1, -1, -1) if reverse else range(n)):
        x = None if xs is None else map_leaves(lambda a: a[i], xs)
        carry, y = f(carry, x)
        ys.append(y)
    if reverse:
        ys.reverse()
    if not ys or not _leaves(ys[0]):
        return carry, None
    return carry, map_leaves(lambda *steps: torch.stack(
        [torch.as_tensor(s) for s in steps]), *ys)
