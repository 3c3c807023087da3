"""The `nn` layers on the card against the CPU (marked `gpu`): every
case of `paddle_tpu_torch.testing.nn_cases` (the convolutions with
"SAME" at stride 2 on even and odd sizes, groups and dilation, the
transposed convolutions, the pools, `lrn`, `GroupNorm`, `BatchNorm` in
train and eval mode, `DataNorm`, `bn_relu_train`, LSTM / GRU / BiRNN
with lengths, NCE on fixed negatives and the hierarchical sigmoid), each
output, gradient and buffer within 1e-4 of its largest CPU element, TF32
off. The tests decide inside their bodies whether a card exists and skip
without one. This file imports no JAX:

    PTPU_TEST_REAL_DEVICE=1 python -m pytest tests/test_torch_nn_gpu.py -m gpu
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.models import ResNet
from paddle_tpu_torch.testing import nn_cases

pytestmark = pytest.mark.gpu


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the layers are compared with the "
                    "CPU)")
    return torch.device("cuda")


@pytest.mark.parametrize("case", sorted(nn_cases.CASES))
def test_layer_on_the_card_equals_the_cpu(case):
    dev = _card()
    with nn_cases.no_tf32():
        ratios = nn_cases.run_case(case, dev)
    worst = max(ratios, key=ratios.get)
    assert ratios[worst] <= 1.0, (worst, ratios[worst])


def test_resnet_forward_on_the_card_runs_channels_last():
    """The convolutions see channels-last views: a ResNet forward in
    eval mode on the card equals the CPU's, and its conv outputs are
    NHWC-contiguous (no layout copy between layers)."""
    dev = _card()
    torch.manual_seed(0)
    cpu = ResNet((1, 1, 1, 1), num_classes=5, device="cpu")
    card = ResNet((1, 1, 1, 1), num_classes=5, device=dev)
    card.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(np.random.RandomState(0).randn(
        2, 64, 64, 3).astype(np.float32))
    contiguous = []
    hook = card.blocks[1].b.conv.register_forward_hook(
        lambda m, i, o: contiguous.append(o.is_contiguous()))
    with nn_cases.no_tf32(), torch.no_grad():
        got = card(x.to(dev)).cpu()
        want = cpu(x)
    hook.remove()
    assert contiguous == [True]
    assert nn_cases.gap(got, want) <= 1e-4
