"""`ServeEngine.from_saved_model` of the port against the JAX package's.

The JAX package exports a tiny CausalLM with
`paddle_tpu.testing.fixtures.export_causal_lm` (format v2 params); the
port reads the directory with numpy only (paddle_tpu_torch/io) and its
engine must give the JAX engine's greedy streams exactly. The same
directory rewritten as a format-v1 checkpoint (one arrays.npz) must
load to the same weights, and a directory without the `serve` block
must raise as the JAX engine does. The port's own numpy writer
(`testing.write_serving_export`, what chip_smoke.py serves from) must
write a directory the JAX package loads.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest

from paddle_tpu.engine import ServeEngine as JaxServeEngine
from paddle_tpu.engine.engine import serve_metadata as jax_serve_metadata
from paddle_tpu.io.checkpoint import load_checkpoint as jax_load_checkpoint
from paddle_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from paddle_tpu.testing.fixtures import export_causal_lm
from paddle_tpu_torch.engine import ServeEngine, serve_metadata
from paddle_tpu_torch.io import load_checkpoint
from paddle_tpu_torch.models import CausalLM
from paddle_tpu_torch.obs.metrics import MetricsRegistry
from paddle_tpu_torch.testing import causal_lm_tree, write_serving_export

ENGINE = dict(max_batch_size=4, block_size=4, num_blocks=64,
              max_prefill_tokens=8, tile_q=4)
PROMPTS = [[5, 9, 2], [7, 1, 1, 3, 8, 30, 31, 2, 9, 40, 41], [4],
           [3, 17, 29, 41, 5, 9, 13, 50, 1, 2]]


@pytest.fixture(scope="module")
def export_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("export") / "lm")
    export_causal_lm(path, num_kv_heads=1)      # GQA 2:1, vocab 61, d 16
    return path


def _leaves(tree, prefix=""):
    for key, val in tree.items():
        name = f"{prefix}/{key}"
        if isinstance(val, dict):
            yield from _leaves(val, name)
        else:
            yield name, np.asarray(val)


def _to_v1(src: str, dst: str) -> str:
    """The same export with its params as a format-v1 checkpoint: one
    arrays.npz and a manifest whose leaves name their slots (the layout
    tests/test_io.py::test_v1_checkpoint_read_compat writes)."""
    shutil.copytree(src, dst)
    params = os.path.join(dst, "params")
    leaves = sorted(_leaves(load_checkpoint(params)))
    shutil.rmtree(params)
    os.makedirs(params)
    np.savez(os.path.join(params, "arrays.npz"),
             **{f"a{i}": arr for i, (_, arr) in enumerate(leaves)})
    with open(os.path.join(params, "manifest.json"), "w") as f:
        json.dump({"version": 1, "step": 0, "metadata": {},
                   "leaves": [{"key": k[1:], "slot": f"a{i}",
                               "shape": list(a.shape),
                               "dtype": str(a.dtype)}
                              for i, (k, a) in enumerate(leaves)]}, f)
    return dst


def _jax_streams(path):
    eng = JaxServeEngine.from_saved_model(path, registry=JaxRegistry(),
                                          **ENGINE)
    return eng.generate(PROMPTS, max_new_tokens=8), eng


def _port_streams(path):
    eng = ServeEngine.from_saved_model(path, device="cpu",
                                       registry=MetricsRegistry(), **ENGINE)
    return eng.generate(PROMPTS, max_new_tokens=8), eng


def test_reader_matches_jax_loader(export_dir):
    got = dict(_leaves(load_checkpoint(os.path.join(export_dir, "params"))))
    want = dict(_leaves(jax.device_get(jax_load_checkpoint(
        os.path.join(export_dir, "params")))))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        assert np.array_equal(got[key], want[key]), key


@pytest.mark.parametrize("form", ["v2", "v1"])
def test_from_saved_model_streams_match_jax_engine(export_dir, tmp_path,
                                                   form):
    path = (export_dir if form == "v2"
            else _to_v1(export_dir, str(tmp_path / "v1")))
    got, eng = _port_streams(path)
    want, ref = _jax_streams(export_dir)
    assert got == want
    assert eng.max_seq_len == ref.max_seq_len == 64   # defaults to max_len
    assert serve_metadata(eng.model) == jax_serve_metadata(ref.model)
    eng.cache.assert_quiesced()


def test_engine_kwargs_reach_the_engine(export_dir):
    eng = ServeEngine.from_saved_model(
        export_dir, device="cpu", registry=MetricsRegistry(),
        max_seq_len=32, kv_compress_blocks=8, **ENGINE)
    assert eng.max_seq_len == 32
    assert eng.cache.compress_enabled and eng.kv_direct_int8
    assert eng.model.device.type == "cpu"


def test_missing_serve_block_raises(export_dir, tmp_path):
    path = str(tmp_path / "noserve")
    shutil.copytree(export_dir, path)
    sig_path = os.path.join(path, "signature.json")
    with open(sig_path) as f:
        sig = json.load(f)
    del sig["serve"]
    with open(sig_path, "w") as f:
        json.dump(sig, f)
    with pytest.raises(ValueError, match="no `serve` metadata"):
        ServeEngine.from_saved_model(path, device="cpu")
    with pytest.raises(ValueError, match="no `serve` metadata"):
        JaxServeEngine.from_saved_model(path)


def test_corrupt_shard_raises(export_dir, tmp_path):
    path = str(tmp_path / "corrupt")
    shutil.copytree(export_dir, path)
    shard = os.path.join(path, "params", "shards-p0.npz")
    with open(shard, "r+b") as f:
        f.seek(100)
        byte = f.read(1)
        f.seek(100)
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(ValueError, match="corrupt"):
        load_checkpoint(os.path.join(path, "params"))


def test_numpy_writer_loads_in_the_jax_package(tmp_path):
    """A directory written by the port's numpy writer serves the same
    streams through the JAX engine and through the port's."""
    dims = dict(model_dim=16, num_heads=4, num_layers=2, ffn_dim=32,
                num_kv_heads=2)
    model = CausalLM(61, dropout=0.0, max_len=64, device="cpu", **dims)
    path = write_serving_export(str(tmp_path / "np"),
                                causal_lm_tree(3, 61, **dims),
                                serve_metadata(model))
    want, _ = _jax_streams(path)
    got, _ = _port_streams(path)
    assert got == want
