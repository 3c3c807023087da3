"""`quant/` and the inference export on the card (marked `gpu`): every
case of `paddle_tpu_torch.testing.quant_cases` on the card against the
CPU (int8 and int32 exactly, floats within 1e-6 of their largest
element, TF32 off), `int8_mm` over the shapes `torch._int_mm` refuses
as they are, and a small BERT exported on the card whose predictor
launches kernel 4 through its operator once a layer. The tests decide
inside their bodies whether a card exists and skip without one. This
file imports no JAX:

    PTPU_TEST_REAL_DEVICE=1 python -m pytest tests/test_torch_quant_gpu.py -m gpu
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.io import InferencePredictor, save_inference_model
from paddle_tpu_torch.kernels import flash
from paddle_tpu_torch.models import BertEncoder
from paddle_tpu_torch.quant.fake_quant import int8_mm
from paddle_tpu_torch.testing import quant_cases

pytestmark = pytest.mark.gpu


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the int8 GEMM and kernel 4 run "
                    "there)")
    return torch.device("cuda")


@pytest.mark.parametrize("name", sorted(quant_cases.CASES))
def test_quant_case_on_the_card_equals_the_cpu(name):
    dev = _card()
    c = quant_cases.CASES[name]
    with quant_cases.no_tf32():
        want = quant_cases.host(quant_cases.run_case(
            c, quant_cases.PortAdapter("cpu")))
        got = quant_cases.host(quant_cases.run_case(
            c, quant_cases.PortAdapter(dev)))
    quant_cases.compare(got, want, name)


@pytest.mark.parametrize("m,k,n", [(1, 8, 8), (17, 147, 64), (33, 64, 48),
                                   (100, 20, 12), (1003, 576, 64)])
def test_int8_mm_pads_what_int_mm_refuses(m, k, n):
    dev = _card()
    rs = np.random.RandomState(m)
    a = rs.randint(-127, 128, (m, k)).astype(np.int8)
    b = rs.randint(-127, 128, (k, n)).astype(np.int8)
    got = int8_mm(torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  a.astype(np.int64) @ b.astype(np.int64))


def test_exported_bert_launches_kernel_4_on_the_card(tmp_path):
    dev = _card()
    torch.manual_seed(0)
    bert = BertEncoder(vocab=50, model_dim=64, num_heads=4, num_layers=2,
                       ffn_dim=128, max_len=32, dropout=0.0, device=dev)

    class Entry(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.bert = bert

        def forward(self, tokens, lengths):
            return self.bert(tokens, lengths=lengths)
    entry = Entry()
    tokens = np.random.RandomState(1).randint(0, 50, (4, 32))
    lengths = np.array([32, 20, 9, 1])
    save_inference_model(str(tmp_path / "bert"), entry, None,
                         [tokens, lengths], input_names=["tokens",
                                                         "lengths"])
    pred = InferencePredictor(str(tmp_path / "bert"), device=dev)
    feed = {"tokens": tokens, "lengths": lengths}
    flash.flash_fwd.launches = 0
    got = pred.run(feed)[0]
    assert flash.flash_fwd.launches == 2
    with torch.no_grad():
        want = entry(torch.from_numpy(tokens).to(dev).int(),
                     torch.from_numpy(lengths).to(dev).int()).cpu().numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
