"""The port's pruning (`quant/prune.py`) against the five pruning tests of
tests/test_prune_interop.py and against the JAX package on the same tree.
(That file's three DLPack tests wait for the port's `utils/interop`,
ROADMAP item 10.)

The parity tests take one trained MLP's parameters in JAX's layout (the
port's `Trainer.state().params`, as numpy) through both packages: the
masks equal JAX's exactly, element and channel granularity and a
per-path ratio dict alike; `sensitivity_analysis` gives JAX's keys and,
with each package evaluating its own model on the pruned tree, losses
within 1e-5 of JAX's.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import MLP as JMLP
from paddle_tpu.ops import functional as JF
from paddle_tpu.quant import prune as JP
from paddle_tpu_torch.core import Trainer, supervised_loss
from paddle_tpu_torch.metrics import accuracy
from paddle_tpu_torch.models import MLP, load_jax_params
from paddle_tpu_torch.models.convert import param_path
from paddle_tpu_torch.ops import softmax_with_cross_entropy
from paddle_tpu_torch.optim import Adam
from paddle_tpu_torch.quant.prune import (apply_masks, magnitude_masks,
                                          masked_train_step, select_ratios,
                                          sensitivity_analysis, sparsity)
from paddle_tpu_torch.testing import one_torch_thread
from paddle_tpu_torch.utils.tree import flatten_with_keys


@pytest.fixture(autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _trained_mlp(rng_seed=0, steps=40):
    torch.manual_seed(rng_seed)
    model = MLP(hidden=(32,), num_classes=4, in_shape=(1, 1, 8),
                device="cpu")
    tr = Trainer(model, Adam(model.parameters(), 5e-2),
                 supervised_loss(softmax_with_cross_entropy,
                                 metrics={"acc": accuracy}))
    rs = np.random.RandomState(rng_seed)
    w = rs.randn(8, 4)
    x = rs.randn(128, 8).astype(np.float32)
    y = (x @ w).argmax(-1).astype(np.int64)
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    for _ in range(steps):
        f = tr.train_step(batch)
    return model, tr, batch, f


@pytest.fixture(scope="module")
def trained():
    with one_torch_thread():
        model, tr, batch, _ = _trained_mlp()
        params = jax.tree.map(lambda t: t.numpy().copy(),
                              tr.state().params)
        return model, params, batch


def _loss(model, params, batch) -> float:
    """The mean cross-entropy of `model` under the tree `params`."""
    flat = dict(flatten_with_keys(params))
    weights = {n: torch.as_tensor(flat[param_path(n)])
               for n, _ in model.named_parameters()}
    with torch.no_grad():
        out = torch.func.functional_call(model, weights, (batch[0],))
        return float(softmax_with_cross_entropy(out, batch[1]).mean())


# ---------------------------- tests/test_prune_interop.py's five

def test_magnitude_masks_hit_ratio(trained):
    _, params, _ = trained
    masks = magnitude_masks(params, 0.5)
    assert 0.45 <= sparsity(masks) <= 0.55
    pruned = apply_masks(params, masks)
    for (_, p), (_, m) in zip(flatten_with_keys(pruned),
                              flatten_with_keys(masks)):
        assert torch.all((p == 0) | (m == 1))


def test_channel_pruning_zeroes_whole_columns(trained):
    _, params, _ = trained
    masks = magnitude_masks(params, 0.5, granularity="channel")
    for k, m in flatten_with_keys(masks):
        if k.endswith("weight"):
            col = m.reshape(-1, m.shape[-1])
            assert torch.all(col.min(0).values == col.max(0).values)


def test_prune_finetune_recovers_accuracy():
    model, tr, batch, _ = _trained_mlp()
    masks = magnitude_masks(tr.state().params, 0.5)
    load_jax_params(model, {"params": apply_masks(tr.state().params,
                                                  masks)})
    step = masked_train_step(tr, masks)
    for _ in range(30):
        f = step(batch)
    assert sparsity(magnitude_masks(tr.state().params, 0.0)) == 0.0
    w = model.fcs[0].weight.detach()
    assert torch.all(w[masks["fcs_0"]["weight"] == 0] == 0)
    assert float(f["acc"]) > 0.8


def test_sensitivity_and_ratio_selection(trained):
    model, params, batch = trained
    sens = sensitivity_analysis(lambda p: _loss(model, p, batch), params,
                                ratios=(0.3, 0.9))
    assert sens
    for per in sens.values():
        assert per[0.9] >= per[0.0] - 1e-6
    assert all(r == 0.9 for r in select_ratios(sens, budget=1e9).values())
    assert all(r in (0.0, 0.3, 0.9)
               for r in select_ratios(sens, budget=0.0).values())


def test_sensitivity_prunes_only_target_layer():
    """Anchored matching: one layer's probe must not prune a layer whose
    path merely shares a suffix."""
    w = torch.arange(16.0).reshape(4, 4) + 1.0
    params = {"fc": {"weight": w}, "head": {"fc": {"weight": w}}}
    masks = magnitude_masks(params, {re.escape("fc/weight"): 0.5})
    assert float(masks["fc"]["weight"].sum()) == 8
    assert float(masks["head"]["fc"]["weight"].sum()) == 16


# ----------------------------------------------------- parity with JAX

@pytest.mark.parametrize("ratio,granularity", [
    (0.5, "element"), (0.7, "channel"),
    ({re.escape("fcs_0/weight"): 0.6, "head/.*": 0.3}, "element")],
    ids=["element", "channel", "per_path"])
def test_masks_equal_jax(trained, ratio, granularity):
    _, params, _ = trained
    got = magnitude_masks(params, ratio, granularity=granularity)
    want = JP.magnitude_masks(jax.tree.map(jnp.asarray, params), ratio,
                              granularity=granularity)
    for (k, a), b in zip(flatten_with_keys(got),
                         jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=k)
    assert sparsity(got) == JP.sparsity(want)


def test_sensitivity_keys_equal_jax(trained):
    model, params, batch = trained
    jm = JMLP(hidden=(32,), num_classes=4)
    x, y = jnp.asarray(batch[0].numpy()), jnp.asarray(batch[1].numpy())
    jloss = jax.jit(lambda p: jnp.mean(JF.softmax_with_cross_entropy(
        jm.apply({"params": p}, x), y)))
    want = JP.sensitivity_analysis(lambda p: float(jloss(p)),
                                   jax.tree.map(jnp.asarray, params),
                                   ratios=(0.3, 0.9))
    got = sensitivity_analysis(lambda p: _loss(model, p, batch), params,
                               ratios=(0.3, 0.9))
    assert list(got) == list(want) and got
    for path, per in want.items():
        assert list(got[path]) == list(per)
        for r, loss in per.items():
            assert abs(got[path][r] - loss) <= 1e-5 * max(abs(loss), 1.0), \
                (path, r)
    assert select_ratios(got, 0.05) == JP.select_ratios(want, 0.05)
