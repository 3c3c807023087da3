"""The op library's control flow, lattices, extras and detection ops and
the metrics on the card (marked `gpu`): every case of
`paddle_tpu_torch.testing.op_cases` runs on CUDA tensors and on CPU
tensors, and the card's outputs stay on the card and equal the CPU's
(`op_cases.sweep`'s rule). The tests decide inside their bodies whether
a card exists and skip without one. This file imports no JAX:

    PTPU_TEST_REAL_DEVICE=1 python -m pytest tests/test_torch_ops_gpu.py -m gpu
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import detection, lattice
from paddle_tpu_torch.testing import op_cases

pytestmark = pytest.mark.gpu


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the sweep compares it with the CPU)")
    return torch.device("cuda")


def test_every_op_case_runs_on_the_card_and_equals_the_cpu():
    rep = op_cases.sweep(_card())
    assert rep["swept"] == len(op_cases.CASES)
    assert rep["ops"] >= 93


@pytest.mark.parametrize("seed", [1, 2])
def test_multiclass_nms_on_the_card_equals_the_cpu(seed):
    dev = _card()
    g = torch.Generator().manual_seed(seed)
    xy = torch.rand((600, 2), generator=g) * 280
    boxes = torch.cat([xy, xy + 8 + torch.rand((600, 2), generator=g) * 60], 1)
    scores = torch.softmax(2 * torch.randn((600, 21), generator=g), -1).T
    args = (0.01, 0.45, 100, 50)
    want = detection.multiclass_nms(boxes, scores.contiguous(), *args)
    got = detection.multiclass_nms(boxes.to(dev), scores.contiguous().to(dev),
                                   *args)
    assert got[0].device.type == "cuda"
    np.testing.assert_array_equal(got[0].cpu().numpy(), want[0].numpy())
    assert int(got[1]) == int(want[1])


def test_ctc_loss_and_gradient_on_the_card_equal_the_cpu():
    dev = _card()
    g = torch.Generator().manual_seed(0)
    logits = torch.randn((4, 50, 29), generator=g)
    labels = torch.randint(1, 29, (4, 12), generator=g)
    lab_len = torch.tensor([12, 5, 0, 9])
    in_len = torch.tensor([50, 50, 30, 7])      # row 3 cannot align

    def run(x, *a):
        x = x.clone().requires_grad_(True)
        loss = lattice.ctc_loss(torch.log_softmax(x, -1), *a)
        return loss.detach(), torch.autograd.grad(loss.sum(), x)[0]
    want = run(logits, labels, in_len, lab_len)
    got = run(*(t.to(dev) for t in (logits, labels, in_len, lab_len)))
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(got[1].cpu().numpy(), want[1].numpy(),
                               rtol=1e-5, atol=1e-6)
