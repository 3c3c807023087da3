"""The `nn` layers on one device against the CPU: one case a layer
setting, for `tests/test_torch_nn_gpu.py` and `chip_smoke.py`'s `zoo`
phase.

Each case builds a module (seeded, on the CPU), copies it to the
device, feeds both the same seeded float32 inputs, and compares the
outputs, the gradients of the float inputs and of every parameter
(against seeded cotangents), and the persistent buffers after the
forward (BatchNorm's and DataNorm's running statistics). Each tensor's
error is max |device - cpu| over its own largest |cpu| element; the bar
is `BAR` (1e-4: cuDNN and the card's reductions sum in other orders
than the CPU). `sweep(device)` returns each case's worst error over the
bar and raises if any exceeds 1. TF32 is off inside the sweep.
"""

from __future__ import annotations

import contextlib
import copy
from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch
from torch import nn

from paddle_tpu_torch.nn import layers as L
from paddle_tpu_torch.nn.fused_bn import bn_relu_train
from paddle_tpu_torch.nn.rnn import BiRNN, GRUCell, LSTMCell, RNN
from paddle_tpu_torch.nn.sampled import NCE, HierarchicalSigmoid, nce_loss

BAR = 1e-4


class Fn(nn.Module):
    """A function of tensors as a module (for the pools, lrn and
    bn_relu_train, whose [C] vectors ride as parameters)."""

    def __init__(self, fn: Callable, params: Sequence[np.ndarray] = ()):
        super().__init__()
        self.fn = fn
        self.ps = nn.ParameterList(
            nn.Parameter(torch.from_numpy(np.asarray(p, np.float32)))
            for p in params)

    def forward(self, *xs):
        return self.fn(*xs, *self.ps)


class WithInts(nn.Module):
    """A module called with fixed integer tensors after its float
    inputs (lengths, labels, negatives), moved with it."""

    def __init__(self, module: nn.Module, ints: Sequence[np.ndarray],
                 call: Callable):
        super().__init__()
        self.module = module
        self.call = call
        for i, a in enumerate(ints):
            self.register_buffer(f"i{i}", torch.from_numpy(np.asarray(a)),
                                 persistent=False)
        self.n = len(ints)

    def forward(self, *xs):
        return self.call(self.module, *xs,
                         *[getattr(self, f"i{i}") for i in range(self.n)])


@dataclass
class NNCase:
    build: Callable[[], nn.Module]
    shapes: Sequence[tuple]          # the float inputs' shapes
    train: bool = True


def _rs(seed: int) -> np.random.RandomState:
    return np.random.RandomState(seed)


def _rnn_call(m, x, lengths):
    return m(x, lengths)


def _nce_call(m, x, labels, neg):
    return nce_loss(x, labels, m.weight, m.bias, neg, m.num_classes,
                    m.probs)


def _cases() -> Dict[str, NNCase]:
    lens = np.array([7, 3, 5, 1])
    g = _rs(3)
    neg = g.randint(0, 40, (6, 5))
    labels = g.randint(0, 40, 6)
    hs_labels = g.randint(0, 13, 6)
    return {
        "conv2d_same_s2_even": NNCase(
            lambda: L.Conv2D(8, 16, 3, stride=2), [(2, 16, 16, 8)]),
        "conv2d_same_s2_odd_groups": NNCase(
            lambda: L.Conv2D(8, 16, 3, stride=2, groups=4),
            [(2, 15, 17, 8)]),
        "conv2d_same_s2_dilation": NNCase(
            lambda: L.Conv2D(8, 12, 3, stride=2, dilation=2),
            [(2, 15, 16, 8)]),
        "conv2d_transpose_same": NNCase(
            lambda: L.Conv2DTranspose(6, 8, 4, stride=2), [(2, 7, 8, 6)]),
        "conv2d_transpose_valid": NNCase(
            lambda: L.Conv2DTranspose(6, 8, 3, stride=2, padding="VALID"),
            [(2, 7, 8, 6)]),
        "conv3d_transpose_same": NNCase(
            lambda: L.Conv3DTranspose(4, 6, 3, stride=2), [(1, 4, 5, 6, 4)]),
        "conv3d_transpose_valid": NNCase(
            lambda: L.Conv3DTranspose(4, 6, 2, stride=3, padding="VALID"),
            [(1, 4, 5, 6, 4)]),
        "max_pool2d_same": NNCase(
            lambda: Fn(lambda x: L.max_pool2d(x, 3, 2, "SAME")),
            [(2, 9, 8, 4)]),
        "avg_pool2d_same_exclude_pad": NNCase(
            lambda: Fn(lambda x: L.avg_pool2d(x, 3, 2, "SAME", False)),
            [(2, 9, 8, 4)]),
        "avg_pool2d_same": NNCase(
            lambda: Fn(lambda x: L.avg_pool2d(x, 3, 2, "SAME")),
            [(2, 9, 8, 4)]),
        "pools_3d": NNCase(
            lambda: Fn(lambda x: L.max_pool3d(x, 2, 2, "SAME")
                       + L.avg_pool3d(x, 2, 2, "SAME")), [(1, 5, 6, 7, 3)]),
        "lrn": NNCase(lambda: Fn(lambda x: L.lrn(x, 5)), [(2, 4, 5, 9)]),
        "group_norm": NNCase(lambda: L.GroupNorm(16, groups=4),
                             [(2, 6, 5, 16)]),
        "batch_norm_train": NNCase(lambda: L.BatchNorm(16),
                                   [(4, 6, 5, 16)]),
        "batch_norm_eval": NNCase(lambda: L.BatchNorm(16), [(4, 6, 5, 16)],
                                  train=False),
        "data_norm": NNCase(lambda: L.DataNorm(6), [(32, 6)]),
        "bn_relu_train": NNCase(
            lambda: Fn(lambda x, ga, be: bn_relu_train(x, ga, be, 1e-5)[0],
                       [_rs(4).rand(16) + 0.5, _rs(5).randn(16) * 0.2]),
            [(4, 6, 5, 16)]),
        "lstm_lengths": NNCase(
            lambda: WithInts(RNN(LSTMCell(6, 10, proj_size=4)), [lens],
                             _rnn_call), [(4, 7, 6)]),
        "gru_reverse_lengths": NNCase(
            lambda: WithInts(RNN(GRUCell(6, 10), reverse=True), [lens],
                             _rnn_call), [(4, 7, 6)]),
        "birnn_lengths": NNCase(
            lambda: WithInts(BiRNN(LSTMCell(6, 8), GRUCell(6, 5)), [lens],
                             _rnn_call), [(4, 7, 6)]),
        "nce_fixed_negatives": NNCase(
            lambda: WithInts(NCE(40, 12, num_neg=5), [labels, neg],
                             _nce_call),
            [(6, 12)]),
        "hierarchical_sigmoid": NNCase(
            lambda: WithInts(HierarchicalSigmoid(13, 12), [hs_labels],
                             lambda m, x, lab: m(x, lab)), [(6, 12)]),
    }


CASES = _cases()


def leaves(out) -> List[torch.Tensor]:
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in leaves(o)]
    return [out]


def gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over want's largest |element| (0 for 0 == 0)."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    return err / scale if scale > 0 else err


@contextlib.contextmanager
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _run(module: nn.Module, case: NNCase, device, seed: int):
    """Forward, backward against seeded cotangents; returns {name:
    tensor} of outputs, input and parameter grads and buffers."""
    module = module.to(device).train(case.train)
    xs = [torch.from_numpy(_rs(seed + i).randn(*s).astype(np.float32))
          .to(device).requires_grad_(True)
          for i, s in enumerate(case.shapes)]
    outs = leaves(module(*xs))
    rs = _rs(seed + 100)
    cot = [torch.from_numpy(rs.randn(*o.shape).astype(np.float32))
           .to(device) for o in outs]
    sum((o.float() * c).sum() for o, c in zip(outs, cot)).backward()
    got = {f"out{i}": o for i, o in enumerate(outs)}
    got.update({f"grad_x{i}": x.grad for i, x in enumerate(xs)})
    got.update({f"grad_{n}": p.grad for n, p in module.named_parameters()})
    got.update({f"buffer_{n}": b for n, b in module.named_buffers()})
    return got


def run_case(name: str, device, seed: int = 0) -> Dict[str, float]:
    """One case on `device` against the CPU: each compared tensor's
    error over BAR, and that the device's outputs stay on the device."""
    case = CASES[name]
    torch.manual_seed(seed)
    cpu_module = case.build()
    dev_module = copy.deepcopy(cpu_module)
    want = _run(cpu_module, case, "cpu", seed)
    got = _run(dev_module, case, device, seed)
    assert set(got) == set(want), (name, sorted(got), sorted(want))
    out = {}
    for k, w in want.items():
        g = got[k]
        assert (g is None) == (w is None), (name, k)
        if g is None:
            continue
        assert g.device.type == torch.device(device).type, (name, k)
        out[k] = gap(g, w) / BAR
    return out


def sweep(device, seed: int = 0) -> Dict[str, dict]:
    """Every case on `device` against the CPU, TF32 off: {case: {"worst":
    error over the bar, "tensor": its name}}. Raises AssertionError
    naming the case and tensor past the bar."""
    report = {}
    with no_tf32():
        for name in CASES:
            ratios = run_case(name, device, seed)
            worst = max(ratios, key=ratios.get)
            report[name] = {"worst": ratios[worst], "tensor": worst}
            assert ratios[worst] <= 1.0, (name, worst, ratios[worst])
    return report
