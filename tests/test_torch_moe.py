"""Expert parallelism of the port (paddle_tpu_torch/parallel/moe.py)
against the JAX package, mirroring tests/test_moe.py by name. One world
of 8 gloo ranks on JAX's ep=4 x dp=2 mesh runs the cases of
paddle_tpu_torch/testing/parallel_cases.py: each rank's experts are its
slice of the same numpy-seeded weights, and its outputs, routing and
gradients are held against JAX's (2e-5 on outputs, the JAX test's bar;
5e-3 on gradients)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.parallel.mesh import make_mesh as jax_make_mesh
from paddle_tpu.parallel.moe import (load_balancing_loss as jax_lb,
                                     moe_ffn as jax_moe_ffn,
                                     moe_ffn_a2a as jax_moe_ffn_a2a)
from paddle_tpu_torch.optim import Adam
from paddle_tpu_torch.parallel.moe import (load_balancing_loss, moe_ffn,
                                           moe_partition_specs)
from paddle_tpu_torch.testing import parallel_cases as P

E, D = P.MOE_E, P.MOE_D


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return P.world_once(tmp_path_factory.getbasetemp(), "moe_world",
                        lambda _: P.run_world(8, ("moe", "moe_pressure")))


@pytest.fixture(scope="module")
def params():
    return P.moe_params(0)


def jparams(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def tparams(p):
    return {k: torch.from_numpy(v.copy()) for k, v in p.items()}


def joined(ranks, key, dim=0):
    """A token-sharded result: ranks 0-3 (dp 0) joined on `dim`, ranks
    4-7 (dp 1) equal to them."""
    for r in range(4):
        np.testing.assert_array_equal(ranks[r + 4][key], ranks[r][key])
    return np.concatenate([ranks[r][key] for r in range(4)], dim)


def same_on_all(ranks, key):
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[key], ranks[0][key])
    return ranks[0][key]


def test_moe_ep_matches_dense(world, params):
    x = jnp.asarray(P.moe_tokens(0, 24))
    y_dense, aux_d = jax.jit(jax_moe_ffn)(jparams(params), x)
    y = same_on_all(world["moe"], "ep/y")
    np.testing.assert_allclose(y, np.asarray(y_dense), rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(same_on_all(world["moe"], "ep/index"),
                                  np.asarray(aux_d["expert_index"]))


def test_moe_routes_to_multiple_experts(params):
    x = P.moe_tokens(1, 256)
    _, aux = moe_ffn(tparams(params), torch.from_numpy(x))
    used = np.unique(aux["expert_index"].numpy())
    assert len(used) >= 2
    _, jaux = jax.jit(jax_moe_ffn)(jparams(params), jnp.asarray(x))
    np.testing.assert_array_equal(aux["expert_index"].numpy(),
                                  np.asarray(jaux["expert_index"]))


def test_load_balancing_loss_uniform_is_one():
    probs = torch.full((64, E), 1.0 / E)
    idx = torch.arange(64) % E
    loss = load_balancing_loss({"router_probs": probs, "expert_index": idx})
    assert float(loss) == pytest.approx(1.0, rel=1e-5)
    want = jax_lb({"router_probs": jnp.asarray(probs.numpy()),
                   "expert_index": jnp.asarray(idx.numpy())})
    assert float(loss) == pytest.approx(float(want), rel=1e-6)


def test_moe_topk_masked_matches_dense(world, params):
    x = jnp.asarray(P.moe_tokens(3, 24))
    y_dense, _ = jax.jit(lambda p, x: jax_moe_ffn(p, x, k=2))(
        jparams(params), x)
    np.testing.assert_allclose(same_on_all(world["moe"], "topk/y"),
                               np.asarray(y_dense), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("k", [1, 2])
def test_moe_a2a_matches_masked_with_ample_capacity(world, params, k):
    ranks = world["moe"]
    assert float(same_on_all(ranks, f"a2a{k}/dropped")) == 0.0
    y_a2a = joined(ranks, f"a2a{k}/y")
    masked = same_on_all(ranks, f"a2a{k}/masked")
    np.testing.assert_allclose(y_a2a, masked, rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(joined(ranks, f"a2a{k}/index"),
                                  same_on_all(ranks, f"a2a{k}/masked_index"))
    mesh = jax_make_mesh(ep=4, dp=2)
    x = jnp.asarray(P.moe_tokens(4))
    y_jax, aux = jax.jit(lambda p, x: jax_moe_ffn_a2a(
        p, x, mesh=mesh, k=k, capacity_factor=E / k))(jparams(params), x)
    np.testing.assert_allclose(y_a2a, np.asarray(y_jax), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_array_equal(joined(ranks, f"a2a{k}/index"),
                                  np.asarray(aux["expert_index"]))


def test_moe_a2a_drops_past_capacity(world, params):
    ranks = world["moe"]
    drop = float(same_on_all(ranks, "drops/dropped"))
    cap = int(same_on_all(ranks, "drops/capacity"))
    assert drop > 0.5
    y = joined(ranks, "drops/y")
    zero_rows = np.all(y == 0, axis=-1)
    assert zero_rows.sum() == 32 - cap * 4
    mesh = jax_make_mesh(ep=4, dp=2)
    hot = np.tile(np.random.RandomState(5).randn(1, D).astype(np.float32),
                  (32, 1))
    y_jax, aux = jax.jit(lambda p, x: jax_moe_ffn_a2a(
        p, x, mesh=mesh, k=1, capacity_factor=1.0))(jparams(params),
                                                     jnp.asarray(hot))
    assert int(aux["capacity"]) == cap
    assert float(aux["dropped_fraction"]) == pytest.approx(drop)
    np.testing.assert_allclose(y, np.asarray(y_jax), rtol=2e-5, atol=2e-5)


def test_moe_a2a_gradients_flow(world, params):
    """Every leaf gets a gradient; the experts' slices and the gate
    (summed over the ranks' tokens) equal jax.grad of the summed MSE."""
    ranks = world["moe"]
    mesh = jax_make_mesh(ep=4, dp=2)
    x, t = (jnp.asarray(P.moe_tokens(s)) for s in (6, 106))

    def loss_fn(p):
        y, _ = jax_moe_ffn_a2a(p, x, mesh=mesh, k=2, capacity_factor=2.0)
        return jnp.sum((y - t) ** 2)

    g = jax.jit(jax.grad(loss_fn))(jparams(params))
    gate = sum(ranks[r]["a2a_grads/gate"] for r in range(4))
    for name in ("gate", "w1", "w2"):
        got = gate if name == "gate" else joined(ranks, f"a2a_grads/{name}")
        assert np.abs(got).sum() > 0, f"no grad for {name}"
        np.testing.assert_allclose(got, np.asarray(g[name]), rtol=5e-3,
                                   atol=5e-3, err_msg=name)


def test_moe_routing_diversifies_under_training(params):
    """The balance loss rebalances a collapsed router (JAX's test, on one
    rank)."""
    rs = np.random.RandomState(7)
    x = torch.from_numpy((rs.rand(256, D) + 0.5).astype(np.float32))
    t = torch.from_numpy(rs.randn(256, D).astype(np.float32))
    p0 = dict(params)
    p0["gate"] = params["gate"].copy()
    p0["gate"][:, 0] += 0.3
    p = {k: v.requires_grad_() for k, v in tparams(p0).items()}
    _, aux0 = moe_ffn(p, x, k=1)
    f0 = np.bincount(aux0["expert_index"].numpy(), minlength=E) / 256
    _, jaux0 = jax.jit(lambda p, x: jax_moe_ffn(p, x, k=1))(
        jparams(p0), jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(aux0["expert_index"].numpy(),
                                  np.asarray(jaux0["expert_index"]))
    opt = Adam(list(p.values()), 3e-2)
    for _ in range(60):
        y, aux = moe_ffn(p, x, k=1)
        opt.zero_grad(set_to_none=True)
        (torch.mean((y - t) ** 2) + 0.1 * load_balancing_loss(aux)).backward()
        opt.step()
    _, aux1 = moe_ffn(p, x, k=1)
    f1 = np.bincount(aux1["expert_index"].numpy(), minlength=E) / 256
    assert f0.max() > 0.9
    assert f1.max() < 0.7
    assert (f1 > 0.05).sum() >= 2


def test_moe_trains_router_and_experts(world, params):
    """The masked path's gradients (MSE + 0.01 x the balance loss): every
    leaf's, the experts' rank slices, equal jax.grad's."""
    ranks = world["moe"]
    mesh = jax_make_mesh(ep=4, dp=2)
    x, t = (jnp.asarray(P.moe_tokens(s)) for s in (2, 102))

    def loss_fn(p):
        y, aux = jax_moe_ffn(p, x, mesh=mesh)
        return jnp.mean((y - t) ** 2) + 0.01 * jax_lb(aux)

    g = jax.jit(jax.grad(loss_fn))(jparams(params))
    for name in ("gate", "w1", "w2"):
        got = (same_on_all(ranks, f"masked_grads/{name}") if name == "gate"
               else joined(ranks, f"masked_grads/{name}"))
        assert np.abs(got).sum() > 0, f"no grad for {name}"
        np.testing.assert_allclose(got, np.asarray(g[name]), rtol=5e-3,
                                   atol=5e-3, err_msg=name)
    specs = moe_partition_specs()
    assert specs["w1"] == specs["w2"] == ("ep", None, None)


def test_moe_a2a_under_capacity_pressure(world):
    """A router skewed to expert 0 at capacity factor 1 drops tokens;
    training lowers the loss and the balance loss the drop rate."""
    r = world["moe_pressure"]
    mains, drops = same_on_all(r, "mains"), same_on_all(r, "drops")
    assert drops[0] > 0.2, drops[0]
    assert mains[-1] < mains[0], (mains[0], mains[-1])
    assert drops[-1] < 0.5 * drops[0], (drops[0], drops[-1])
    mesh = jax_make_mesh(ep=4, dp=2)
    rs = np.random.RandomState(11)
    x = jnp.asarray((rs.rand(256, D) + 0.5).astype(np.float32))
    p0 = P.moe_params(0)
    p0["gate"] = p0["gate"].copy()
    p0["gate"][:, 0] += 0.3
    _, aux = jax.jit(lambda p: jax_moe_ffn_a2a(
        p, x, mesh=mesh, k=1, capacity_factor=1.0))(jparams(p0))
    assert float(aux["dropped_fraction"]) == pytest.approx(float(drops[0]))
