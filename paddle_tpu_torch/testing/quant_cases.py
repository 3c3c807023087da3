"""One table of tiny cases for `quant/`: the fake-quant ops and their
straight-through gradients, `int8_matmul`, the int8 layers and the QAT
layers; numpy inputs made from a seed, and a call that runs them through
either package.

Each `QuantCase` draws float32 inputs with `inputs(rs)` and runs them
with `call(M, *arrays)`, which returns {name: output}. `M` is the
package's adapter: `M.fq` (its `quant.fake_quant`), `M.array(a)` (an
input on its device), `M.grad(f, x)` (the gradient of sum(f(x)) in x),
and four layer runners, each building a float layer from the given
weights and returning the tensors the parity checks compare:

- `int8_linear(x, w, b, calib)` / `int8_conv(x, w, b, conv, calib)`:
  the layer frozen by `freeze_int8` (calibrated on the batches `calib`
  when there are any): {"weight" int8, "w_scale", "xq" int8 (the
  quantized input), "acc" int32 (the layer's accumulators), "y", and
  "act_scale" when calibrated};
- `quant_linear(x, w, b, x2)` / `quant_conv(x, w, b, conv, x2)`: the
  QAT layer fed x then x2 in training mode (the activation scale after
  each), then x in eval mode, and the gradients of sum(y ** 2) of the
  first training output in x and in the weight.

`conv` holds the convolution's settings: {"stride", "padding",
"dilation", "groups"}. `PortAdapter(device)` is the port's adapter; the
CPU parity test (tests/test_torch_quant.py) brings the JAX one.
`sweep(device)` runs every case through the port on `device` and on the
CPU: int8 and int32 outputs equal exactly, floats within `FLOAT_BAR` of
each output's largest element.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch.nn.layers import Conv2D, Linear
from paddle_tpu_torch.quant import fake_quant
from paddle_tpu_torch.quant.int8_compute import (_act_quant, freeze_int8,
                                                 int8_conv2d)
from paddle_tpu_torch.quant.layers import QuantConv2D, QuantLinear
from paddle_tpu_torch.testing.nn_cases import no_tf32

#: a float output's bar, relative to its largest element
FLOAT_BAR = 1e-6


@dataclass(frozen=True)
class QuantCase:
    name: str
    inputs: Callable[[np.random.RandomState], Tuple[np.ndarray, ...]]
    call: Callable[..., Dict[str, Any]]


CASES: Dict[str, QuantCase] = {}


def case(name: str):
    def register(fn):
        inputs, call = fn()
        CASES[name] = QuantCase(name, inputs, call)
        return fn
    return register


def _f32(a) -> np.ndarray:
    return np.asarray(a, np.float32)


# ------------------------------------------------------------ fake quant

@case("fake_quant_ops")
def _():
    def inputs(rs):
        x = _f32(rs.randn(6, 10) * 3.0)
        w = _f32(rs.randn(5, 7) * np.array([1, 10, 0.1, 3, 0.5, 2, 7]))
        return x, w, _f32(0.8), _f32(1.5)

    def call(M, x, w, s, running):
        fq = M.fq
        q = fq.quantize(x, s, 8)
        abs_q, abs_s = fq.fake_quant_abs_max(x)
        ch_q, ch_s = fq.fake_quant_channel_abs_max(w, 8, axis=-1)
        ma0, s0 = fq.fake_quant_moving_average(x, running * 0, 8)
        ma1, s1 = fq.fake_quant_moving_average(x, running, 8)
        ma2, s2 = fq.fake_quant_moving_average(x * 2, running, 8,
                                               update=False)
        return {
            "quantize": q, "quantize_4bit": fq.quantize(x, s, 4),
            "dequantize": fq.dequantize(q, s, 8),
            "abs_max": abs_q, "abs_max_scale": abs_s,
            "channel": ch_q, "channel_scale": ch_s,
            "moving_first": ma0, "moving_first_scale": s0,
            "moving": ma1, "moving_scale": s1,
            "moving_frozen": ma2, "moving_frozen_scale": s2,
            "grad_abs_max": M.grad(
                lambda a: fq.fake_quant_abs_max(a)[0] ** 2, x),
            "grad_channel": M.grad(
                lambda a: fq.fake_quant_channel_abs_max(a)[0] ** 2, w),
            "grad_moving": M.grad(
                lambda a: fq.fake_quant_moving_average(a, running)[0] ** 2,
                x)}
    return inputs, call


@case("int8_matmul")
def _():
    def inputs(rs):
        # 5 rows (CUDA's int8 GEMM wants more than 16), K 20 and N 12 (it
        # wants multiples of 8), then a K of 147 (ResNet-50's stem)
        return (_f32(rs.randn(5, 20)), _f32(rs.randn(20, 12)),
                _f32(rs.randn(40, 147)), _f32(rs.randn(147, 24)))

    def call(M, x, w, x2, w2):
        fq = M.fq
        out = {}
        for tag, a, b in (("small", x, w), ("stem", x2, w2)):
            xs = fq.abs_max_scale(a)
            ws = fq.abs_max_scale(b, axis=0)
            out[tag] = fq.int8_matmul(a, b, xs, ws)
        return out
    return inputs, call


# ------------------------------------------------------------ int8 layers

def _linear_case(name: str, m: int, k: int, n: int, calib: int = 0):
    @case(name)
    def _():
        def inputs(rs):
            return (_f32(rs.randn(m, k) * 2), _f32(rs.randn(k, n) * 0.3),
                    _f32(rs.randn(n) * 0.1),
                    *[_f32(rs.randn(m, k) * 2) for _ in range(calib)])

        def call(M, x, w, b, *cal):
            return M.int8_linear(x, w, b, cal)
        return inputs, call


_linear_case("int8_linear_few_rows", 3, 20, 12)
_linear_case("int8_linear_static", 33, 64, 48, calib=2)


def _conv_case(name: str, x_shape, w_shape, stride=1, padding="SAME",
               dilation=1, groups=1, calib: int = 0):
    conv = dict(stride=stride, padding=padding, dilation=dilation,
                groups=groups)

    @case(name)
    def _():
        def inputs(rs):
            fan_in = np.prod(w_shape[:3])
            return (_f32(rs.randn(*x_shape)),
                    _f32(rs.randn(*w_shape) / np.sqrt(fan_in)),
                    _f32(rs.randn(w_shape[-1]) * 0.1),
                    *[_f32(rs.randn(*x_shape)) for _ in range(calib)])

        def call(M, x, w, b, *cal):
            return M.int8_conv(x, w, b, conv, cal)
        return inputs, call


_conv_case("int8_conv_same", (2, 9, 8, 8), (3, 3, 8, 16))
_conv_case("int8_conv_valid", (2, 9, 8, 8), (3, 3, 8, 16), padding="VALID")
_conv_case("int8_conv_explicit_pads", (2, 9, 8, 8), (3, 2, 8, 8),
           padding=[(1, 2), (0, 1)])
_conv_case("int8_conv_stride2_odd", (2, 9, 11, 8), (3, 3, 8, 8), stride=2)
_conv_case("int8_conv_dilation2", (2, 11, 10, 8), (3, 3, 8, 8),
           dilation=2)
_conv_case("int8_conv_groups4", (2, 8, 8, 16), (3, 3, 4, 16), groups=4)
_conv_case("int8_conv_stem_7x7x3", (2, 32, 32, 3), (7, 7, 3, 64),
           stride=2)
_conv_case("int8_conv_one_row", (1, 3, 3, 8), (3, 3, 8, 8),
           padding="VALID")
_conv_case("int8_conv_static", (2, 9, 8, 8), (3, 3, 8, 16), calib=2)


# ------------------------------------------------------------ QAT layers

@case("quant_linear")
def _():
    def inputs(rs):
        return (_f32(rs.randn(8, 12)), _f32(rs.randn(12, 6) * 0.3),
                _f32(rs.randn(6) * 0.1), _f32(rs.randn(8, 12) * 3))

    def call(M, x, w, b, x2):
        return M.quant_linear(x, w, b, x2)
    return inputs, call


@case("quant_conv2d")
def _():
    conv = dict(stride=2, padding="SAME", dilation=1, groups=1)

    def inputs(rs):
        return (_f32(rs.randn(2, 7, 7, 4)), _f32(rs.randn(3, 3, 4, 6) * 0.3),
                _f32(rs.randn(6) * 0.1), _f32(rs.randn(2, 7, 7, 4) * 3))

    def call(M, x, w, b, x2):
        return M.quant_conv(x, w, b, conv, x2)
    return inputs, call


# ------------------------------------------------------------ the port

class PortAdapter:
    """`M` for the port on `device`."""

    fq = fake_quant

    def __init__(self, device):
        self.device = torch.device(device)

    def array(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(a)).to(self.device)

    def grad(self, f: Callable, x: torch.Tensor) -> torch.Tensor:
        x = x.detach().clone().requires_grad_(True)
        f(x).sum().backward()
        return x.grad

    def _layer(self, layer, w, b):
        with torch.no_grad():
            layer.weight.copy_(w)
            layer.bias.copy_(b)
        return layer

    def _frozen(self, layer, x, calib: Sequence, acc: Callable):
        q, _ = freeze_int8(layer, None, list(calib) or None)
        xq, _ = _act_quant(q, x)
        out = {"weight": q.weight, "w_scale": q.w_scale, "xq": xq,
               "acc": acc(q, xq), "y": q(x)}
        if calib:
            out["act_scale"] = q.act_scale
        return out

    def int8_linear(self, x, w, b, calib=()):
        layer = self._layer(Linear(w.shape[0], w.shape[1],
                                   device=self.device), w, b)
        return self._frozen(layer, x, calib, lambda q, xq: fake_quant.int8_mm(
            xq.reshape(-1, xq.shape[-1]), q.weight))

    def int8_conv(self, x, w, b, conv, calib=()):
        layer = self._layer(Conv2D(w.shape[2] * conv["groups"], w.shape[3],
                                   w.shape[:2], device=self.device, **conv),
                            w, b)
        return self._frozen(layer, x, calib, lambda q, xq: int8_conv2d(
            xq, q.weight, q.stride, q.padding, q.dilation, q.groups))

    def _qat(self, layer, x, x2):
        layer.train()
        xg = x.detach().clone().requires_grad_(True)
        y = layer(xg)
        (y ** 2).sum().backward()
        s1 = layer.act_scale.clone()
        layer(x2)
        s2 = layer.act_scale.clone()
        layer.eval()
        return {"y_train": y, "act_scale_1": s1, "act_scale_2": s2,
                "y_eval": layer(x), "grad_x": xg.grad,
                "grad_w": layer.weight.grad}

    def quant_linear(self, x, w, b, x2):
        layer = self._layer(QuantLinear(w.shape[0], w.shape[1],
                                        device=self.device), w, b)
        return self._qat(layer, x, x2)

    def quant_conv(self, x, w, b, conv, x2):
        layer = self._layer(QuantConv2D(w.shape[2] * conv["groups"],
                                        w.shape[3], w.shape[:2],
                                        device=self.device, **conv), w, b)
        return self._qat(layer, x, x2)


def run_case(c: QuantCase, M, seed: int = 0) -> Dict[str, Any]:
    """One case through the adapter `M` on inputs drawn from `seed`."""
    arrays = c.inputs(np.random.RandomState(seed))
    return c.call(M, *[M.array(a) for a in arrays])


def host(out: Dict[str, Any]) -> Dict[str, np.ndarray]:
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in out.items()}


def compare(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray],
            what: str) -> Dict[str, float]:
    """int8 / int32 outputs equal exactly, floats within FLOAT_BAR of the
    largest |want| element; returns each float output's error over its
    largest element. Raises AssertionError naming the output."""
    assert set(got) == set(want), (what, sorted(got), sorted(want))
    errs = {}
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype, \
            (what, k, g.shape, w.shape, g.dtype, w.dtype)
        if w.dtype.kind != "f":
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")
            continue
        scale = float(np.abs(w).max()) or 1.0
        errs[k] = float(np.abs(g.astype(np.float64) - w).max()) / scale
        assert errs[k] <= FLOAT_BAR, (what, k, errs[k])
    return errs


def sweep(device, seed: int = 0) -> Dict[str, float]:
    """Every case through the port on `device` against the CPU, TF32
    off: {case: its worst float error over its largest element}. Raises
    AssertionError on the first mismatch."""
    report = {}
    with no_tf32():
        for name, c in CASES.items():
            torch.manual_seed(seed)
            want = host(run_case(c, PortAdapter("cpu"), seed))
            torch.manual_seed(seed)
            got_dev = run_case(c, PortAdapter(device), seed)
            for k, v in got_dev.items():
                assert v.device.type == torch.device(device).type, (name, k)
            errs = compare(host(got_dev), want, name)
            report[name] = max(errs.values(), default=0.0)
    return report
