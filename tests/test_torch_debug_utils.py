"""The port's introspection utilities (`paddle_tpu_torch.utils.debug`)
against tests/test_debug_utils.py's five tests, with the port's program
stages (`fx`, `export`) in place of JAX's; plus the refusal of JAX's
stage names, `census_from_text` equal in both packages on the same HLO
and StableHLO text, and `module_tree` / `module_tree_dot` printing what
JAX's print for the same tree carried across by `load_jax_params`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.utils import debug as JD
from paddle_tpu_torch.models import DeepFM, LeNet, load_jax_params
from paddle_tpu_torch.utils import debug as D
from paddle_tpu_torch.utils.debug import dump_hlo, memory_stats, module_tree


def _f(a, b):
    return torch.tanh(a @ b)


# ------------------------------------- tests/test_debug_utils.py mirrors

def test_memory_stats_reports_bytes():
    x = torch.ones((128, 128))
    stats = memory_stats()
    assert isinstance(stats, dict) and stats
    one = next(iter(stats.values()))
    assert "bytes_in_use" in one
    assert one["bytes_in_use"] > 0
    cpu = memory_stats("cpu")
    assert cpu["source"] == "live_tensors_walk"
    assert cpu["bytes_in_use"] >= x.numel() * 4
    assert cpu["num_live_buffers"] >= 1


def test_dump_hlo_stages():
    a, b = torch.ones((4, 8)), torch.ones((8, 2))
    fx = dump_hlo(_f, a, b, stage="fx")
    assert "aten.tanh" in fx and "aten.mm" in fx
    ex = dump_hlo(_f, a, b, stage="export")
    assert "ExportedProgram" in ex and "aten.tanh" in ex
    assert "Graph signature" in ex


def test_module_tree_printer():
    m = LeNet(num_classes=10, device="cpu")
    txt = module_tree(m)
    assert "LeNet" in txt
    assert "conv1" in txt and "fc2" in txt
    assert "params=" in txt
    # weight shapes shown, in JAX's layout (HWIO)
    assert "(5, 5, 1, 20)" in txt


def test_module_tree_dot():
    from paddle_tpu_torch.utils.debug import module_tree_dot
    m = LeNet(num_classes=10, device="cpu")
    dot = module_tree_dot(m)
    assert dot.startswith("digraph")
    assert "LeNet" in dot and "conv1" in dot
    assert "->" in dot and dot.rstrip().endswith("}")
    assert "params=" in dot


def test_op_census():
    """The op-frequency table (benchmark/op_frequence.py capability)."""
    from paddle_tpu_torch.utils import op_census

    def f(x, w):
        return torch.tanh(x @ w) @ w

    x, w = torch.ones((4, 8)), torch.ones((8, 8))
    for stage in ("fx", "export"):
        census = op_census(f, x, w, stage=stage)
        assert census, stage
        assert any("mm" in k or "matmul" in k for k in census), (stage,
                                                                 census)
        # sorted most-frequent-first
        vals = list(census.values())
        assert vals == sorted(vals, reverse=True)
    assert op_census(f, x, w) == {"mm": 2, "tanh": 1}


# ----------------------------------------------------- the port's stages

@pytest.mark.parametrize("stage", ["jaxpr", "stablehlo", "optimized"])
def test_jax_stages_are_refused_by_name(stage):
    a, b = torch.ones((2, 3)), torch.ones((3, 2))
    with pytest.raises(ValueError, match=f"{stage}.*'fx'.*'export'"):
        dump_hlo(_f, a, b, stage=stage)
    with pytest.raises(ValueError, match="'fx'"):
        D.op_census(_f, a, b, stage=stage)


def test_unknown_stage_raises():
    with pytest.raises(ValueError, match="fx | export"):
        dump_hlo(_f, torch.ones(1, 1), torch.ones(1, 1), stage="asm")


def test_census_from_text_equals_jaxs_on_hlo():
    """The same HLO / StableHLO text gives the same table in both."""
    def f(x, w):
        return jnp.tanh(x @ w) @ w + 1.0

    x, w = jnp.ones((4, 8)), jnp.ones((8, 8))
    for stage in ("stablehlo", "optimized"):
        text = JD.dump_hlo(f, x, w, stage=stage)
        want = JD.census_from_text(text)
        assert want and D.census_from_text(text) == want


def test_census_counts_the_ports_graphs_and_nothing_else():
    a, b = torch.ones((4, 8)), torch.ones((8, 2))
    fx = dump_hlo(_f, a, b, stage="fx")
    assert D.census_from_text(fx) == {"mm": 1, "tanh": 1}
    # JAX's parser finds no HLO op in the port's graph text
    assert "mm" not in JD.census_from_text(fx)


def test_memory_stats_keys_by_device_string():
    stats = memory_stats()
    assert set(stats) == ({f"cuda:{i}"
                           for i in range(torch.cuda.device_count())}
                          if torch.cuda.is_available() else {"cpu"})
    assert memory_stats(torch.device("cpu"))["source"] == \
        "live_tensors_walk"


def test_executor_cache_stats_reexported():
    from paddle_tpu_torch.core import Executor
    ex = Executor(place="cpu")
    ex.run(lambda x: {"y": x + 1}, {"x": np.ones(2, np.float32)})
    assert {"entries": 1, "hits": 0, "misses": 1, "evictions": 0} in \
        D.executor_cache_stats()


# ------------------------------------------- the same tree, both printers

def _jax_tree_and_models(jax_model, model, *inputs):
    variables = jax.jit(jax_model.init)(jax.random.key(0), *inputs)
    load_jax_params(model, jax.device_get(variables))
    return variables


def test_module_tree_matches_jax_on_lenet():
    from paddle_tpu.models import LeNet as JLeNet
    jm = JLeNet(num_classes=10)
    m = LeNet(num_classes=10, device="cpu")
    v = _jax_tree_and_models(jm, m, jnp.zeros((1, 28, 28, 1)))
    assert module_tree(m) == JD.module_tree(jm, v)
    assert D.module_tree_dot(m) == JD.module_tree_dot(jm, v)
    # an explicit tree prints as the module's own
    assert module_tree(m, jax.device_get(v)) == module_tree(m)


def test_module_tree_matches_jax_on_deepfm_lists():
    """A ModuleList's items print as JAX names a list of modules:
    `mlp_0`, `mlp_1`."""
    from paddle_tpu.models.nlp import DeepFM as JDeepFM
    kw = dict(num_fields=3, vocab_per_field=5, dense_dim=2, embed_dim=4,
              mlp_dims=(6, 5))
    jm = JDeepFM(**kw)
    m = DeepFM(**kw, device="cpu")
    v = _jax_tree_and_models(jm, m, jnp.zeros((1, 2)),
                             jnp.zeros((1, 3), jnp.int32))
    txt = module_tree(m)
    assert txt == JD.module_tree(jm, v)
    assert "  mlp_0: Linear params=" in txt and "mlp_1" in txt
