"""Pipeline parallelism of the port (paddle_tpu_torch/parallel/
pipeline.py) against the JAX package, mirroring tests/test_pipeline.py
by name. One world of 8 gloo ranks runs the cases of
paddle_tpu_torch/testing/parallel_cases.py on JAX's meshes (pp=4 x
dp=2, pp=2 x tp=2 x dp=2, pp=2 x sp=2 x dp=2, pp=2 x tp=2 x sp=2,
pp=2 x ep=2 x dp=2, pp=2 x ep=4), the models built from the same
numpy-seeded weights as the JAX models here. Each rank's slices are
joined and held against the JAX functions: the first step's loss
within 2e-4 relative, its gradients leaf by leaf within 5e-3 of
jax.grad, the post-Adam parameters within 2e-3 (JAX's bars); the two
schedules of the port agree within 1e-5.

The JAX reference is the pipelined loss written densely with JAX's own
blocks: each data-parallel shard split into JAX's interleaved
microbatches, every stage applied in order (`lm_block` /
`moe_lm_block`), the microbatch losses and stage balance losses
averaged as `pipeline_stream` averages them. For a dense LM it is the
dense forward's cross-entropy."""

import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.io import checkpoint as jckpt
from paddle_tpu.ops import functional as JF
from paddle_tpu.optim.optimizer import Adam as JaxAdam
from paddle_tpu.parallel import (DistStrategy as JaxDistStrategy,
                                 MeshConfig as JaxMeshConfig,
                                 MeshTrainer as JaxMeshTrainer,
                                 make_mesh as jax_make_mesh)
from paddle_tpu.parallel import pipeline as JP
from paddle_tpu_torch.parallel.mesh import AXIS_ORDER, Mesh
from paddle_tpu_torch.parallel.pipeline import pipelined_lm_loss
from paddle_tpu_torch.testing import mesh_cases as M
from paddle_tpu_torch.testing import parallel_cases as P
from paddle_tpu_torch.utils.tree import flatten_with_keys

WORLD = ("toy", "pipe_dp", "pipe_extra", "pipe_generate", "pipe_ckpt",
         "pipe_tp", "pipe_sp", "pipe_tp_sp", "pipe_ulysses_refusal",
         "pipe_ep", "pipe_ep4")


def jax_model(kind, **kw):
    vocab, d, h, f, s, max_len, e = P.LM_DIMS[kind]
    if e is None:
        return JP.PipelinedLM(vocab, d_model=d, n_heads=h, d_ff=f,
                              num_stages=s, max_len=max_len)
    return JP.PipelinedMoELM(vocab, d_model=d, n_heads=h, d_ff=f,
                             num_stages=s, max_len=max_len, num_experts=e,
                             **kw)


def jax_tree(kind):
    return jax.tree.map(jnp.asarray, P.pipe_tree(kind)["params"])


def _jax_trainer(kind, mesh):
    return JaxMeshTrainer(
        jax_model(kind), JaxAdam(1e-2),
        JP.pipelined_lm_loss(mesh, num_microbatches=8), mesh,
        strategy=JaxDistStrategy(batch_axes=("dp",)),
        rules=JP.pipeline_rules())


def _make_world(root):
    # a JAX checkpoint of the pp=4 x dp=2 model after one step, for the
    # ranks to resume
    mesh = jax_make_mesh(JaxMeshConfig(pp=4, dp=2))
    tr = _jax_trainer("lm", mesh)
    x, y = P.lm_tokens(5)
    ts = tr.init_state(jnp.asarray(x))
    ts = type(ts)(jax.device_put(jax_tree("lm"), tr._state_shardings.params),
                  ts.state, ts.opt_state, ts.step)
    ts, _ = tr.train_step(ts, tr.put_batch((x, y)))
    jax_path = jckpt.save_checkpoint(str(root / "jax"), ts, step=1)
    os.makedirs(root / "port")
    res = P.run_world(8, WORLD, env={"PTPU_JAX_CKPT": jax_path,
                                     "PTPU_WORLD_CKPT": str(root / "port")},
                      timeout=600)
    state = {"params/" + k: np.asarray(v) for k, v in
             flatten_with_keys(jax.device_get(ts.params))}
    for s, t in ts.opt_state["slots"].items():
        state.update({f"slots/{s}/{k}": np.asarray(v) for k, v in
                      flatten_with_keys(jax.device_get(t))})
    return res, str(root), state


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    res, root, state = P.world_once(tmp_path_factory.getbasetemp(),
                                    "pipe_world", _make_world)
    return res, Path(root), state


def ref_loss(kind, m, dp, lb_weight=0.0, model_kw=None):
    """The pipelined loss, densely in JAX: the mean over the dp shards of
    the microbatches' mean CE plus lb_weight x the stages' mean balance
    loss (JAX's blocks scanned over the stages, vmapped over the
    microbatches)."""
    model = jax_model(kind, **(model_kw or {}))
    moe = P.LM_DIMS[kind][-1] is not None

    def fn(p, x, y):
        if not moe:
            logits = model.apply({"params": p}, x)
            return jnp.mean(JF.softmax_with_cross_entropy(
                logits.astype(jnp.float32), y))
        xs = jnp.concatenate([JP._microbatch(a, m) for a in jnp.split(x, dp)])
        ys = jnp.concatenate([JP._microbatch(a, m) for a in jnp.split(y, dp)])

        def one(xt, yt):
            h = p["embed"][xt] + p["pos"][:xt.shape[1]]

            def body(a, sp):
                return JP.moe_lm_block(sp, a, model.n_heads, k=model.top_k,
                                       capacity_factor=model.capacity_factor)
            a, lbs = jax.lax.scan(body, h, p["stages"])
            ce = JP._lm_consume(False)((p["lnf_s"], p["lnf_b"], p["head"]),
                                       a, yt)
            return ce, jnp.sum(lbs)

        ce, lbs = jax.vmap(one)(xs, ys)
        return jnp.mean(ce) + lb_weight * jnp.mean(lbs) / model.num_stages
    return fn


def reference(kind, seed, m, dp=2, b=16, lb_weight=0.0, model_kw=None):
    """(loss, grads, params after one Adam 1e-2 step) of the dense JAX
    reference on pipe_tree(kind) and lm_tokens(seed)."""
    vocab, t = P.LM_DIMS[kind][0], P.LM_DIMS[kind][5]
    x, y = (jnp.asarray(a) for a in P.lm_tokens(seed, b, t, vocab))
    p = jax_tree(kind)
    loss, g = jax.jit(jax.value_and_grad(
        ref_loss(kind, m, dp, lb_weight, model_kw)))(p, x, y)
    opt = JaxAdam(1e-2)
    p1, _ = opt.apply(p, g, opt.init(p))
    flat = lambda tree: {k: np.asarray(v) for k, v in
                         flatten_with_keys(jax.device_get(tree))}
    return float(loss), flat(g), flat(p1)


def joined(res, run, what):
    return M.join(res, f"{run}/{what}")


def first_loss(res, run):
    losses = [float(r[f"{run}/losses"][0]) for r in res]
    assert max(losses) - min(losses) <= 1e-6 * abs(losses[0]), losses
    return losses[0]


def assert_run_matches(res, run, kind, seed, m, dp=2, b=16, lb_weight=0.0,
                       model_kw=None, params=True):
    loss, grads, p1 = reference(kind, seed, m, dp, b, lb_weight, model_kw)
    assert first_loss(res, run) == pytest.approx(loss, rel=2e-4, abs=2e-4)
    got = joined(res, run, "grads")
    assert sorted(got) == sorted(grads)
    for k, g in grads.items():
        np.testing.assert_allclose(got[k], g, rtol=5e-3, atol=5e-3,
                                   err_msg=k)
    if params:
        got = joined(res, run, "step1/params")
        for k, v in p1.items():
            np.testing.assert_allclose(got[k], v, rtol=2e-3, atol=2e-3,
                                       err_msg=k)


def assert_runs_agree(res, a, b, rel=1e-5):
    assert first_loss(res, a) == pytest.approx(first_loss(res, b), rel=rel,
                                               abs=rel)
    ga, gb = joined(res, a, "grads"), joined(res, b, "grads")
    for k in ga:
        np.testing.assert_allclose(ga[k], gb[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    pa, pb = joined(res, a, "step1/params"), joined(res, b, "step1/params")
    for k in pa:
        np.testing.assert_allclose(pa[k], pb[k], rtol=5e-3, atol=2e-3,
                                   err_msg=k)


# -- the toy stages ----------------------------------------------------------


def toy_sequential(st, x):
    for w, b in zip(st["w"], st["b"]):
        x = jnp.tanh(x @ w + b)
    return x


def stage_rows(res, key, s=4):
    """Rank r holds stage r // 2 of the pp=4 x dp=2 mesh: the stage slices
    of a whole-stack gradient, joined (zeros elsewhere on each rank)."""
    out = np.zeros_like(res[0][key])
    v = out.shape[0] // s
    for r, rr in enumerate(res):
        st = r // 2
        sl = slice(st * v, (st + 1) * v)
        assert not np.any(np.delete(rr[key], np.s_[sl], 0))
        out[sl] = rr[key][sl]
    return out


def test_pipeline_matches_sequential(world):
    res = world[0]["toy"]
    st = P.toy_stages(0, 4, 16)
    xs = np.random.RandomState(50).randn(6, 4, 16).astype(np.float32)
    want = jax.vmap(lambda x: toy_sequential(st, x))(jnp.asarray(xs))
    for r in res:
        assert r["apply/out"].shape == (6, 4, 16)
        np.testing.assert_allclose(r["apply/out"], np.asarray(want),
                                   rtol=2e-5, atol=2e-5)


def _toy_loss(st, x, y):
    return jnp.mean((toy_sequential(st, x) - y) ** 2)


def test_pipeline_grads_flow_to_all_stages(world):
    res = world[0]["toy"]
    gw = stage_rows(res, "grads4/dw")
    assert gw.shape == (4, 8, 8)
    for s in range(4):
        assert np.abs(gw[s]).sum() > 0, f"stage {s} got zero grad"
    st = P.toy_stages(1)
    rs = np.random.RandomState(51)
    x, y = (jnp.asarray(rs.randn(8, 8).astype(np.float32)) for _ in range(2))
    want = float(_toy_loss(st, x, y))
    for r in res:
        assert float(r["grads4/loss"]) == pytest.approx(want, rel=1e-5)


def test_pipeline_grad_matches_sequential_grad(world):
    res = world[0]["toy"]
    st = jax.tree.map(jnp.asarray, P.toy_stages(2))
    rs = np.random.RandomState(52)
    x, y = (jnp.asarray(rs.randn(8, 8).astype(np.float32)) for _ in range(2))
    g = jax.grad(_toy_loss)(st, x, y)
    for k in ("w", "b"):
        np.testing.assert_allclose(stage_rows(res, f"grads2/d{k}"),
                                   np.asarray(g[k]), rtol=1e-4, atol=1e-5)


# -- PipelinedLM through MeshTrainer (pp x dp) ------------------------------------


def test_pipelined_lm_trains_on_pp_dp(world):
    res = world[0]["pipe_dp"]
    losses = res[0]["trains/losses"]
    assert losses[-1] < losses[0], losses
    # stage params and Adam's moments are sharded over pp: a rank holds
    # one of the four stages
    for prefix in ("trains/final/params", "trains/final/slots/m"):
        parts = M.split(res[0], prefix)
        w, region = parts["stages/w_qkv"]
        assert w.shape == (1, 16, 48) and region[0] == slice(0, 1)
        assert parts["embed"][1] == (slice(0, 32), slice(0, 16))


def test_pipelined_lm_loss_matches_dense_forward(world):
    res = world[0]["pipe_dp"]
    x, y = P.lm_tokens(3)
    model = jax_model("lm")
    logits = model.apply({"params": jax_tree("lm")}, jnp.asarray(x))
    want = float(jnp.mean(JF.softmax_with_cross_entropy(
        logits.astype(jnp.float32), jnp.asarray(y))))
    assert first_loss(res, "trains") == pytest.approx(want, rel=2e-4,
                                                      abs=2e-4)


def test_pipelined_lm_parity_vs_single_device(world):
    """The first step against the dense JAX step: loss, every gradient
    and the post-Adam parameters (each rank's slices joined)."""
    assert_run_matches(world[0]["pipe_dp"], "trains", "lm", 3, 8)


def test_pipeline_virtual_stages_deeper_than_axis(world):
    """8 stages on pp=4: two virtual stages a rank per tick (the fused
    head, within 1e-5 of the plain one)."""
    assert_run_matches(world[0]["pipe_dp"], "virtual", "lm8", 4, 8)


def test_pipeline_single_device_runs_all_stages():
    from paddle_tpu_torch.parallel import make_mesh
    from paddle_tpu_torch.ops.functional import softmax_with_cross_entropy
    one = make_mesh(devices=["cpu"])
    model = P.build_lm("lm", "cpu")
    x, y = (torch.as_tensor(a).long() for a in P.lm_tokens(4))
    loss, _ = pipelined_lm_loss(one, num_microbatches=2)(model, (x, y),
                                                         None, True)
    jlogits = jax_model("lm").apply({"params": jax_tree("lm")},
                                    jnp.asarray(x.numpy()))
    want = float(jnp.mean(JF.softmax_with_cross_entropy(
        jlogits.astype(jnp.float32), jnp.asarray(y.numpy()))))
    loss = float(loss.detach())
    assert loss == pytest.approx(want, rel=2e-4, abs=2e-4)
    with torch.no_grad():
        dense = softmax_with_cross_entropy(model(x).float(), y).mean()
    assert loss == pytest.approx(float(dense), rel=1e-5)


def test_pipeline_rejects_non_divisible_stage_stack(world):
    """3 stages on pp=4 fail loudly: at the trainer (the rank's slice
    does not split) and at the stream's own check."""
    res = world[0]
    for r in res["pipe_extra"]:
        assert "does not split" in str(r["refused"])
    for r in res["toy"]:
        assert "must be a multiple" in str(r["refused"])


def test_pipelined_lm_checkpoint_roundtrip(world):
    """Save after 2 steps, restore onto the pp shardings, step on: the
    resumed step equals the straight one."""
    res = world[0]["pipe_ckpt"]
    for r in res:
        assert float(r["straight"]) == pytest.approx(float(r["resumed"]),
                                                     rel=1e-5)
    a, b = M.join(res, "straight/params"), M.join(res, "resumed/params")
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_pipelined_lm_trains_with_remat(world):
    r = world[0]["pipe_extra"][0]
    assert float(r["plain/losses"][0]) == pytest.approx(
        float(r["remat/losses"][0]), rel=1e-6)


def test_pipelined_lm_3d_pp_tp_dp(world):
    """pp=2 x tp=2 x dp=2: Megatron tp inside each stage. Stage weights
    and moments are sharded over pp and tp; the step matches JAX's."""
    res = world[0]["pipe_tp"]
    for prefix in ("tp/final/params", "tp/final/slots/m"):
        w, region = M.split(res[0], prefix)["stages/w_qkv"]
        assert w.shape == (1, 16, 24), w.shape
        assert region[2] == slice(0, 24)
    assert_run_matches(res, "tp", "lm2", 7, 4)


# -- PipelinedMoELM: pp x ep x dp ------------------------------------------------


def test_pipelined_moe_lm_trains_pp_ep_dp(world):
    res = world[0]["pipe_ep"]
    w, _ = M.split(res[0], "moe_trains/final/slots/m")["stages/moe_w1"]
    assert w.shape == (1, 2, 16, 32), w.shape       # pp and ep halves
    losses = res[0]["moe_trains/losses"]
    assert losses[-1] < losses[0], losses
    assert_run_matches(res, "moe_trains", "moe", 8, 4, lb_weight=0.01)


def test_pipelined_moe_lm_ce_parity_vs_dense(world):
    """pp=2 x ep=4, lb 0, capacity 4 (no drops): the streamed CE equals
    the dense forward's; gradients and the step match JAX's."""
    res = world[0]["pipe_ep4"]
    x, y = P.lm_tokens(9, 8)
    model = jax_model("moe", capacity_factor=4.0)
    logits = model.apply({"params": jax_tree("moe")}, jnp.asarray(x))
    want = float(jnp.mean(JF.softmax_with_cross_entropy(
        logits.astype(jnp.float32), jnp.asarray(y))))
    assert first_loss(res, "moe_parity") == pytest.approx(want, rel=2e-4,
                                                          abs=2e-4)
    assert_run_matches(res, "moe_parity", "moe", 9, 4, dp=1, b=8,
                       model_kw=dict(capacity_factor=4.0))


# -- sequence parallelism inside the stages ---------------------------------------


def test_pipelined_lm_sp_ring_attention(world):
    """pp=2 x sp=2 x dp=2: the stages run the ring over sequence
    shards."""
    assert_run_matches(world[0]["pipe_sp"], "ring", "lm2", 11, 4)


def test_pipelined_lm_4d_pp_tp_sp(world):
    assert_run_matches(world[0]["pipe_tp_sp"], "ring4d", "lm2", 12, 4, dp=1)


def test_pipeline_stream_low_rank_targets(world):
    """Scalar targets a microbatch row: the loss of the sequential
    stages."""
    st = P.toy_stages(13)
    rs = np.random.RandomState(63)
    x = jnp.asarray(rs.randn(8, 8).astype(np.float32))
    tv = jnp.asarray(rs.randn(8).astype(np.float32))
    want = float(jnp.mean((jnp.mean(toy_sequential(st, x), -1) - tv) ** 2))
    for r in world[0]["toy"]:
        assert np.isfinite(float(r["low_rank/loss"]))
        assert float(r["low_rank/loss"]) == pytest.approx(want, rel=1e-5)


def test_pipeline_apply_virtual_stages(world):
    st = P.toy_stages(14, 8, 8)
    xs = np.random.RandomState(64).randn(4, 3, 8).astype(np.float32)
    want = jax.vmap(lambda x: toy_sequential(st, x))(jnp.asarray(xs))
    for r in world[0]["toy"]:
        np.testing.assert_allclose(r["apply8/out"], np.asarray(want),
                                   rtol=2e-5, atol=2e-5)


def test_pipelined_lm_generate_and_export(world, tmp_path):
    """Train the (+1 mod V) stream through the pipeline (8 ranks), then
    on one rank: greedy generate follows the pattern, sampling stays in
    the vocabulary, and the export serves the module's logits (the
    model is JAX's at this size; its logits are held against JAX's on
    the same weights)."""
    from paddle_tpu_torch.io.inference import (InferencePredictor,
                                               save_inference_model)
    from paddle_tpu_torch.models import load_jax_params
    res = world[0]["pipe_generate"]
    params = M.join(res, "params")
    model = load_jax_params(P.build_lm("lm_gen", "cpu"), _nest(params))
    prompt = torch.tensor([[3, 4, 5, 6], [20, 21, 22, 23]])
    out = model.generate(prompt, 4)
    np.testing.assert_array_equal(out.numpy(),
                                  [[3, 4, 5, 6, 7, 8, 9, 10],
                                   [20, 21, 22, 23, 24, 25, 26, 27]])
    sampled = model.generate(prompt, 3, generator=torch.Generator()
                             .manual_seed(0), temperature=1.0)
    assert int(sampled.max()) < 32 and tuple(sampled.shape) == (2, 7)
    x = torch.as_tensor(P.plus_one_tokens()[0]).long()
    d = str(tmp_path / "lm")
    save_inference_model(d, model, None, [x], input_names=["tokens"])
    served = InferencePredictor(d, device="cpu").run([x.numpy()])[0]
    with torch.no_grad():
        want = model(x).numpy()
    np.testing.assert_allclose(served, want, rtol=2e-5, atol=2e-5)
    jlogits = jax_model("lm_gen").apply(
        {"params": jax.tree.map(jnp.asarray, _nest(params)["params"])},
        jnp.asarray(x.numpy()))
    np.testing.assert_allclose(want, np.asarray(jlogits), rtol=1e-4,
                               atol=1e-4)


def _nest(flat):
    from paddle_tpu_torch.utils.tree import nest
    return {"params": nest(flat)}


def test_pipelined_lm_sp_ulysses(world):
    assert_run_matches(world[0]["pipe_sp"], "ulysses", "lm2", 16, 4)


def test_pipelined_lm_ulysses_composes_with_tp(world):
    """pp=2 x tp=2 x sp=2 with 4 heads (2 a tp shard, split by sp=2);
    with 2 heads the one head a tp shard cannot split."""
    assert_run_matches(world[0]["pipe_tp_sp"], "ulysses_tp", "lm2h4", 17, 4,
                       dp=1)
    for r in world[0]["pipe_ulysses_refusal"]:
        assert "divide heads per tp" in str(r["refused"])


def test_pipelined_lm_fused_ce_matches_plain(world):
    assert_runs_agree(world[0]["pipe_dp"], "fused", "trains")


def test_pipelined_moe_lm_fused_ce_matches_plain(world):
    assert_runs_agree(world[0]["pipe_ep"], "moe_fused", "moe_trains")


# -- 1F1B ------------------------------------------------------------------------


def test_1f1b_loss_and_grads_match_gpipe_and_dense(world):
    res = world[0]["pipe_dp"]
    assert_runs_agree(res, "f1b", "trains")
    assert_run_matches(res, "f1b", "lm", 3, 8)


def test_1f1b_trains(world):
    """Four 1F1B steps lower the loss, step by step as GPipe's."""
    res = world[0]["pipe_dp"]
    a, b = res[0]["f1b/losses"], res[0]["trains/losses"]
    assert a[-1] < a[0], a
    np.testing.assert_allclose(a, b, rtol=1e-4)


def test_1f1b_composes_with_tp(world):
    res = world[0]["pipe_tp"]
    assert_runs_agree(res, "f1b_tp", "tp")
    assert_run_matches(res, "f1b_tp", "lm2", 7, 4)


def test_1f1b_virtual_stages_and_fused_ce(world):
    res = world[0]["pipe_dp"]
    assert_runs_agree(res, "f1b_virtual", "virtual")
    assert_run_matches(res, "f1b_virtual", "lm8", 4, 8, params=False)


def test_1f1b_rejects_sp():
    devs = np.empty(8, dtype=object)
    devs[:] = [torch.device("cpu")] * 8
    mesh = Mesh(devs.reshape(2, 2, 1, 1, 2, 1), AXIS_ORDER)
    with pytest.raises(ValueError, match="1f1b"):
        pipelined_lm_loss(mesh, sp_axis="sp", schedule="1f1b")


def test_1f1b_activation_liveness_below_gpipe(world):
    """The reason 1F1B exists: a rank's peak saved-for-backward bytes
    (torch.autograd.graph.saved_tensors_hooks) are O(S) under 1F1B and
    O(M) under GPipe; at M 8, S 4 1F1B holds under half on every rank.
    The two losses are equal."""
    for r in world[0]["pipe_extra"]:
        assert 2 * int(r["live/1f1b"]) < int(r["live/gpipe"]), (
            int(r["live/1f1b"]), int(r["live/gpipe"]))
        assert float(r["live/1f1b_loss"]) == pytest.approx(
            float(r["live/gpipe_loss"]), rel=1e-6)


def test_pipelined_eval_runs_the_forward_sweep_alone(world):
    """An eval step (under no_grad) runs the forward sweep and nothing
    of the backward: at M 8, S 4 its collective calls are the sweep's
    M + S - 2 hops, the stages' loss total and the batch-axis mean, under
    either schedule, and its loss is the train step's on the same
    weights."""
    m, s = 8, 4
    for r in world[0]["pipe_extra"]:
        for schedule in ("gpipe", "1f1b"):
            assert int(r[f"eval/{schedule}_calls"]) == m + s - 2 + 2
            assert float(r[f"eval/{schedule}_loss"]) == pytest.approx(
                float(r[f"eval/{schedule}_train_loss"]), rel=1e-6)


def test_1f1b_moe_matches_gpipe(world):
    res = world[0]["pipe_ep"]
    assert_runs_agree(res, "moe_f1b", "moe_trains")
    assert_run_matches(res, "moe_f1b", "moe", 8, 4, lb_weight=0.01)


# -- checkpoints across the packages ---------------------------------------------


@pytest.mark.parametrize("kind", ["lm", "moe"])
def test_pipelined_trees_carry_both_ways(kind):
    """JAX's own init of PipelinedLM / PipelinedMoELM loads into the
    port's model by path and comes back bit for bit; the port's dense
    forward on it equals JAX's."""
    from paddle_tpu_torch.models import load_jax_params, to_jax_params
    x = P.lm_tokens(0)[0]
    model = jax_model(kind)
    variables = jax.device_get(model.init(jax.random.key(0),
                                          jnp.asarray(x)))
    port = load_jax_params(P.build_lm(kind, "cpu"), variables)
    back = dict(flatten_with_keys(to_jax_params(port)))
    want = dict(flatten_with_keys(variables))
    assert sorted(back) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)
    with torch.no_grad():
        got = port(torch.as_tensor(x).long()).numpy()
    np.testing.assert_allclose(got, np.asarray(model.apply(
        variables, jnp.asarray(x))), rtol=1e-5, atol=1e-5)


def test_jax_pipelined_checkpoint_resumes_on_port_ranks(world):
    """JAX's pp=4 x dp=2 checkpoint onto 8 port ranks: each rank holds
    exactly its stage slices of every parameter and moment."""
    res, _, want = world
    for r in res["pipe_ckpt"]:
        assert int(r["from_jax_step"]) == 1
        got = M.split(r, "from_jax")
        assert sorted(got) == sorted(want)
        for k, arr in want.items():
            data, region = got[k]
            np.testing.assert_array_equal(data, arr[region], err_msg=k)


def test_port_pipelined_checkpoint_resumes_on_jax_mesh(world):
    """The ranks' checkpoint after 2 steps in JAX's load_checkpoint with
    a pp=4 x dp=2 MeshTrainer's shardings: every leaf equals the ranks'
    pieces joined, and the stage stacks come back sharded over pp."""
    res, root, _ = world
    mesh = jax_make_mesh(JaxMeshConfig(pp=4, dp=2))
    tr = _jax_trainer("lm", mesh)
    target = tr.init_state(jnp.asarray(P.lm_tokens(5)[0]))
    restored = jckpt.load_checkpoint(str(root / "port" / "pipe"),
                                     target=target,
                                     shardings=tr._state_shardings)
    assert int(restored.step) == 2
    got = {"params/" + k: np.asarray(v) for k, v in
           flatten_with_keys(jax.device_get(restored.params))}
    for s, t in restored.opt_state["slots"].items():
        got.update({f"slots/{s}/{k}": np.asarray(v) for k, v in
                    flatten_with_keys(jax.device_get(t))})
    for r in res["pipe_ckpt"]:
        for k, (data, region) in M.split(r, "saved").items():
            np.testing.assert_array_equal(got[k][region], data, err_msg=k)
    assert "pp" in str(restored.params["stages"]["w_qkv"].sharding.spec)
