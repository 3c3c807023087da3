"""The port's inference export (`io/inference.py`) against
tests/test_io.py's `test_inference_export_roundtrip` and
`test_v1_checkpoint_read_compat`, and against the JAX package's export
(tests/test_torch_checkpoint.py mirrors the other checkpoint tests;
the two sharded ones wait for ROADMAP item 10's meshes).

- For the same MLP weights and input, the port writes JAX's
  `signature.json` byte for byte and JAX's `params` leaves.
- A CausalLM export written by the port (with `serve_meta`) is served by
  JAX's `ServeEngine.from_saved_model` with the port engine's greedy
  float32 streams.
- A JAX export (`model.stablehlo`, no `model.pt2`) is refused with a
  ValueError naming StableHLO.
- A pure fn(variables, *inputs) exports and runs with whatever weights
  it is given, as JAX's does.
- With `mha`'s flash gate opened on the CPU, the exported graph records
  kernel 4's operator once a layer, and the predictor, which runs it,
  gives the module's output (on the card that operator launches the
  CUDA kernel; `chip_smoke.py` phase `export` counts the launches).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.engine import ServeEngine as JaxServeEngine
from paddle_tpu.io import load_checkpoint as jax_load_checkpoint
from paddle_tpu.io import save_inference_model as jax_save_inference_model
from paddle_tpu.models import MLP as JMLP
from paddle_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from paddle_tpu_torch.core import Trainer, supervised_loss
from paddle_tpu_torch.engine import ServeEngine
from paddle_tpu_torch.engine.engine import serve_metadata
from paddle_tpu_torch.io import (InferencePredictor, load_checkpoint,
                                 load_inference_model, save_inference_model)
from paddle_tpu_torch.kernels import attention
from paddle_tpu_torch.models import (MLP, BertEncoder, CausalLM,
                                     load_jax_params, to_jax_params)
from paddle_tpu_torch.obs.metrics import MetricsRegistry
from paddle_tpu_torch.ops import softmax_with_cross_entropy
from paddle_tpu_torch.optim import SGD
from paddle_tpu_torch.testing import causal_lm_tree, one_torch_thread
from paddle_tpu_torch.utils.tree import flatten_with_keys

CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _mlp():
    torch.manual_seed(0)
    return MLP(hidden=(16,), num_classes=3, in_shape=(1, 1, 6), **CPU)


def _x():
    return np.random.RandomState(0).randn(4, 6).astype(np.float32)


def test_inference_export_roundtrip(tmp_path):
    trainer = Trainer(_mlp(), SGD(_mlp().parameters(), 0.1),
                      supervised_loss(softmax_with_cross_entropy))
    model_dir = str(tmp_path / "model")
    x = _x()
    save_inference_model(model_dir, trainer.module, None, [x],
                         input_names=["x"])
    fn, variables, sig = load_inference_model(model_dir, **CPU)
    assert sig["input_names"] == ["x"]
    with torch.no_grad():
        expected = trainer.module(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(fn(variables, x).numpy(), expected,
                               rtol=1e-5, atol=1e-5)
    out = InferencePredictor(model_dir, **CPU).run({"x": x})
    np.testing.assert_allclose(out[0], expected, rtol=1e-5, atol=1e-5)


def test_v1_checkpoint_read_compat(tmp_path):
    """Old single-file checkpoints (version 1) still load."""
    tree = {"w": np.arange(6.0).reshape(2, 3), "b": np.zeros(3)}
    path = str(tmp_path / "old")
    os.makedirs(path)
    leaves, arrays = [], {}
    for i, (k, v) in enumerate(sorted(tree.items())):
        arrays[f"a{i}"] = v
        leaves.append({"key": k, "slot": f"a{i}", "shape": list(v.shape),
                       "dtype": str(v.dtype)})
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump({"version": 1, "step": 7, "metadata": {},
                   "leaves": leaves}, f)
    restored = load_checkpoint(path, target=tree)
    np.testing.assert_allclose(restored["w"], tree["w"])
    np.testing.assert_allclose(restored["b"], tree["b"])


# ----------------------------------------------------- parity with JAX

@pytest.fixture(scope="module")
def jax_mlp_export(tmp_path_factory):
    """JAX's export of the port's MLP weights on _x()."""
    path = str(tmp_path_factory.mktemp("jax") / "mlp")
    variables = jax.tree.map(jnp.asarray, to_jax_params(_mlp()))
    jax_save_inference_model(path, JMLP(hidden=(16,), num_classes=3),
                             variables, [_x()], input_names=["x"])
    return path


def test_signature_and_params_equal_jax(jax_mlp_export, tmp_path):
    path = str(tmp_path / "port")
    save_inference_model(path, _mlp(), None, [_x()], input_names=["x"])
    with open(os.path.join(path, "signature.json"), "rb") as f:
        got = f.read()
    with open(os.path.join(jax_mlp_export, "signature.json"), "rb") as f:
        assert got == f.read()
    want = jax.device_get(jax_load_checkpoint(
        os.path.join(jax_mlp_export, "params")))
    port = load_checkpoint(os.path.join(path, "params"))
    for (k, a), (k2, b) in zip(flatten_with_keys(port),
                               flatten_with_keys(want)):
        assert k == k2 and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_stablehlo_only_directory_is_refused(jax_mlp_export):
    assert os.path.exists(os.path.join(jax_mlp_export, "model.stablehlo"))
    for load in (load_inference_model, InferencePredictor):
        with pytest.raises(ValueError, match="StableHLO"):
            load(jax_mlp_export, **CPU)


ENGINE = dict(max_batch_size=4, block_size=4, num_blocks=64,
              max_prefill_tokens=8, tile_q=4)
PROMPTS = [[5, 9, 2], [7, 1, 1, 3, 8, 30, 31, 2, 9, 40, 41], [4],
           [3, 17, 29, 41, 5, 9, 13, 50, 1, 2]]


def test_port_written_causal_lm_export_serves_in_jax(tmp_path):
    dims = dict(model_dim=16, num_heads=4, num_layers=2, ffn_dim=32)
    model = load_jax_params(
        CausalLM(61, dropout=0.0, max_len=64, **dims, **CPU),
        causal_lm_tree(5, 61, **dims))
    path = str(tmp_path / "lm")
    save_inference_model(path, model, None, [np.zeros((1, 8), np.int32)],
                         input_names=["tokens"],
                         serve_meta=serve_metadata(model))
    want = JaxServeEngine.from_saved_model(
        path, registry=JaxRegistry(), **ENGINE).generate(
            PROMPTS, max_new_tokens=8)
    got = ServeEngine.from_saved_model(
        path, device="cpu", registry=MetricsRegistry(), **ENGINE).generate(
            PROMPTS, max_new_tokens=8)
    assert got == want
    assert any(len(set(s)) > 1 for s in got)      # not one repeated token


def test_fn_export_takes_its_weights(tmp_path):
    """A pure fn(variables, x) exports with its variables as the
    program's tensors; the loaded callable computes with the weights it
    is handed, as JAX's exported fn does."""
    def fn(variables, x):
        return {"y": x @ variables["w"] + variables["b"], "s": x.sum(-1)}
    variables = {"w": np.ones((6, 2), np.float32),
                 "b": np.zeros(2, np.float32)}
    path = str(tmp_path / "fn")
    save_inference_model(path, fn, variables, [_x()], **CPU)
    call, loaded, sig = load_inference_model(path, **CPU)
    assert sig["inputs"] == [{"shape": [4, 6], "dtype": "float32"}]
    x = _x()
    other = {"w": np.full((6, 2), 2.0, np.float32),
             "b": np.ones(2, np.float32)}
    out = call(other, x)
    np.testing.assert_allclose(out["y"].numpy(), x @ other["w"] + 1.0,
                               rtol=1e-6)
    s, y = InferencePredictor(path, **CPU).run([x])     # sorted keys
    np.testing.assert_allclose(y, x @ variables["w"], rtol=1e-6)
    np.testing.assert_allclose(s, x.sum(-1), rtol=1e-6)


def test_kernel4_operator_is_recorded(tmp_path, monkeypatch):
    """`mha`'s flash gate forced open on the CPU: BERT's exported graph
    calls kernel 4's operator once a layer and holds no softmax, and the
    predictor (the operator's CPU body, the plain version) gives the
    module's hidden states."""
    monkeypatch.setattr(attention, "would_use_flash",
                        lambda q, k, has_mask=False: not has_mask)
    torch.manual_seed(0)
    bert = BertEncoder(vocab=50, model_dim=16, num_heads=2, num_layers=2,
                       ffn_dim=32, max_len=12, dropout=0.0, **CPU)

    class Entry(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.bert = bert

        def forward(self, tokens, lengths):
            return self.bert(tokens, lengths=lengths)
    tokens = np.random.RandomState(1).randint(0, 50, (3, 12))
    lengths = np.array([12, 7, 3])
    path = str(tmp_path / "bert")
    save_inference_model(path, Entry(), None, [tokens, lengths],
                         input_names=["tokens", "lengths"])
    pred = InferencePredictor(path, **CPU)
    targets = [str(n.target) for n in pred.program.graph.nodes
               if n.op == "call_function"]
    assert sum("paddle_tpu_torch.flash_fwd" in t for t in targets) == 2
    assert not any("softmax" in t for t in targets)
    with torch.no_grad():
        want = Entry()(torch.from_numpy(tokens),
                       torch.from_numpy(lengths)).numpy()
    got = pred.run({"tokens": tokens, "lengths": lengths})[0]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
