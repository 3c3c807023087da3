"""The port's training over a mesh of ranks (paddle_tpu_torch/parallel:
mesh.py, trainer.py, the differentiable collectives, sync-BN) against
the JAX package: mirrors of the tests of tests/test_parallel.py that
tests/test_torch_distributed.py does not mirror, plus what only a
process-a-rank port has to pin:

- each rank's slices after a dp=2 x fsdp=2 REDUCE run equal the
  `addressable_shards` data of JAX's device of the same rank after the
  same steps;
- the trainer's gradient contract, leaf by leaf, for
  `transformer_tp_rules` on a tiny Transformer at dp=2 x tp=2;
- remat == no-remat bit for bit with dropout > 0;
- dropout inside the tp region draws each tp rank's own masks, and
  dropout on replicated activations the same masks on every tp rank;
- the bad-step guard skips the same step on every rank when only one
  rank's batch holds a NaN;
- sync-BN over dp=4 equals a single-device BatchNorm over the global
  batch, forward and gradients (no JAX test pins sync-BN).

One world of 4 gloo ranks on the CPU (parallel/launch.py) runs every
scenario of paddle_tpu_torch/testing/mesh_cases.py this file reads,
once for the module. JAX runs in this process on the virtual CPU
devices tests/conftest.py makes; both packages start from the same
numpy-seeded weights and batches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu.core.executor import Trainer as JaxTrainer
from paddle_tpu.core.executor import TrainState as JaxTrainState
from paddle_tpu.core.executor import supervised_loss as jax_supervised_loss
from paddle_tpu.models import MLP as JaxMLP
from paddle_tpu.models.transformer import Transformer as JaxTransformer
from paddle_tpu.ops import functional as JF
from paddle_tpu.optim.optimizer import SGD as JaxSGD
from paddle_tpu.optim.optimizer import Adam as JaxAdam
from paddle_tpu.parallel import DistStrategy as JaxDistStrategy
from paddle_tpu.parallel import MeshConfig as JaxMeshConfig
from paddle_tpu.parallel import MeshTrainer as JaxMeshTrainer
from paddle_tpu.parallel import ReduceStrategy as JaxReduceStrategy
from paddle_tpu.parallel import make_mesh as jax_make_mesh
from paddle_tpu.parallel import sharding as jsh
from paddle_tpu_torch.parallel import ShardingRules, shard_variables
from paddle_tpu_torch.parallel.mesh import AXIS_ORDER, Mesh
from paddle_tpu_torch.parallel.sharding import (fsdp_rules, named_sharding,
                                                transformer_tp_rules)
from paddle_tpu_torch.testing import mesh_cases as M
from paddle_tpu_torch.testing import one_torch_thread
from paddle_tpu_torch.utils.tree import flatten_with_keys

WORLD = ("mlp_dp", "mlp_dp_learns", "mlp_accum", "mlp_zero", "mlp_eval",
         "tf_tp", "tf_remat", "tf_tp_masks", "mlp_guard", "bn_sync",
         "mesh_shapes", "mlp_clip_norm", "mlp_clip_global", "mlp_freed",
         "bert_tp")


@pytest.fixture(autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def world():
    return M.run_world(4, WORLD, device="cpu")


# -- helpers -------------------------------------------------------------

def _jax_ts(trainer, tree, example):
    ts = trainer.init_state(*example)
    params = jax.tree_util.tree_map(jnp.asarray, tree["params"])
    return JaxTrainState(params, ts.state, trainer.optimizer.init(params),
                         ts.step)


def _jax_cls_loss():
    return jax_supervised_loss(
        lambda lg, y: JF.softmax_with_cross_entropy(lg, y))


def _jax_mlp(model):
    hidden, _, classes = M.MLP_SHAPES[model]
    return JaxMLP(hidden=hidden, num_classes=classes)


def _jax_single(name, steps=None, opt=None):
    """JAX's single-device Trainer over a scenario's model and batches:
    (losses, final params flat by path)."""
    sc = M.SCENARIOS[name]
    bs = M.batches(sc, steps)
    opt = opt or {"sgd": JaxSGD, "adam": JaxAdam}[sc.optimizer[0]](
        sc.optimizer[1])
    tr = JaxTrainer(_jax_mlp(sc.model), opt, _jax_cls_loss(), seed=0)
    ts = _jax_ts(tr, M.jax_tree(sc.model), (jnp.zeros(bs[0][0].shape),))
    losses = []
    for i, (x, y) in enumerate(bs):
        ts, f = tr.train_step(ts, (jnp.asarray(x), jnp.asarray(y)),
                              rng=jax.random.key(i))
        losses.append(float(f["loss"]))
    return losses, {k: np.asarray(v) for k, v in flatten_with_keys(
        jax.device_get(ts.params))}


# -- mirrors of tests/test_parallel.py ------------------------------------

def test_make_mesh_shapes(world):
    for r, res in enumerate(world["mesh_shapes"]):
        assert (int(res["dp"]), int(res["tp"])) == (2, 2)
        assert int(res["inferred_dp"]) == 2
        assert int(res["local_fsdp"]) == 4
        assert bool(res["refused"])
        shape = tuple({"dp": 2, "tp": 2}.get(a, 1) for a in AXIS_ORDER)
        assert tuple(res["coords"]) == np.unravel_index(r, shape)
        assert int(res["tp_rank"]) == r % 2
        assert int(res["batch_group"]) == 2     # dp only: fsdp is 1


def test_mesh_trainer_dp_learns(world):
    ranks = world["mlp_dp_learns"]
    assert ranks[0]["losses"][-1] < 1.0
    for res in ranks:
        np.testing.assert_array_equal(res["losses"], ranks[0]["losses"])
        for path, (data, region) in M.split(res, "params").items():
            # ALL_REDUCE: parameters whole on every rank, and equal
            assert region == tuple(slice(0, d) for d in data.shape)
            np.testing.assert_array_equal(
                data, M.split(ranks[0], "params")[path][0])


def test_mesh_trainer_zero_shards_params_and_moments(world):
    ranks = world["mlp_zero"]
    assert ranks[0]["losses"][-1] < 1.2
    for res in ranks:
        big, region = M.split(res, "params")["fcs_0/weight"]
        assert big.shape == (8, 64) and region in (
            (slice(0, 8), slice(0, 64)), (slice(0, 8), slice(64, 128)))
        # Adam's moments follow their parameter (a true ZeRO)
        for slot in ("m", "v"):
            m, mregion = M.split(res, f"slots/{slot}")["fcs_0/weight"]
            assert m.shape == big.shape
            assert mregion == region


def test_mesh_matches_single_device(world):
    """A dp=4 run matches JAX's single-device Trainer on the whole batch
    (tests/test_parallel.py:130-152's bar)."""
    losses, params = _jax_single("mlp_dp")
    for res in world["mlp_dp"]:
        np.testing.assert_allclose(res["losses"][-1], losses[-1], rtol=2e-4)
        got = M.join([res], "params")
        for path, want in params.items():
            np.testing.assert_allclose(got[path], want, rtol=1e-4,
                                       atol=1e-5, err_msg=path)


def test_gradient_accumulation_matches_big_batch(world):
    """accum=4 over the global batch 32 (each rank's microbatch i its
    slice of the global microbatch i) == one step on the whole batch,
    and both == JAX's single-device step."""
    _, want = _jax_single("mlp_accum")
    for res in world["mlp_accum"]:
        acc = M.join([res], "accum/params")
        base = M.join([res], "base/params")
        for path in want:
            np.testing.assert_allclose(acc[path], base[path], rtol=1e-4,
                                       atol=1e-5, err_msg=path)
            np.testing.assert_allclose(acc[path], want[path], rtol=1e-4,
                                       atol=1e-5, err_msg=path)


def _jax_tf():
    return JaxTransformer(dropout=0.0, **M.TF_DIMS)


def _jax_seq_loss(module, variables, batch, rng, training):
    src, trg_in, trg_out = batch
    logits, mut = module.apply(variables, src, trg_in, training=training,
                               rngs=rng, mutable=True)
    loss = jnp.mean(JF.softmax_with_cross_entropy(logits, trg_out))
    return (loss, {}), mut.get("state", {})


def test_transformer_tp_matches_single_device(world):
    """Megatron tp (transformer_tp_rules) over dp=2 x tp=2 against JAX's
    single-device Trainer (tests/test_parallel.py:195-228's bars), with
    the projections really sharded over tp."""
    sc = M.SCENARIOS["tf_tp"]
    tr = JaxTrainer(_jax_tf(), JaxSGD(0.05), _jax_seq_loss, seed=0)
    src, trg_in, trg_out = M.seq_batch(sc.batch)
    ts = _jax_ts(tr, M.jax_tree("tiny_tf"), (jnp.asarray(src),
                                             jnp.asarray(trg_in)))
    batch = tuple(jnp.asarray(a) for a in (src, trg_in, trg_out))
    losses = []
    for i in range(sc.steps):
        ts, f = tr.train_step(ts, batch, rng=jax.random.key(100 + i))
        losses.append(float(f["loss"]))
    ranks = world["tf_tp"]
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["losses"], losses, rtol=1e-3)
        leaves = M.split(res, "params")
        q, qs = leaves["enc_layers_0/attn/q_proj/weight"]
        assert q.shape == (16, 8)
        assert qs[1] == (slice(0, 8) if r % 2 == 0 else slice(8, 16))
        o, _ = leaves["enc_layers_0/attn/out_proj/weight"]
        assert o.shape == (8, 16)
    got = M.join(ranks, "params")
    for path, want in flatten_with_keys(jax.device_get(ts.params)):
        np.testing.assert_allclose(got[path], np.asarray(want), rtol=2e-3,
                                   atol=2e-4, err_msg=path)


def test_shard_variables_roundtrip():
    """Rank r's slices of an 8-rank dp mesh are what JAX's NamedSharding
    puts on its device r, and they join back into the tree."""
    tree = {"w": np.arange(16.0).reshape(8, 2)}
    rules = ShardingRules([(r"w$", ("dp", None))])
    jmesh = jax_make_mesh(JaxMeshConfig(dp=8))
    placed = jsh.shard_variables(jmesh, tree, jsh.ShardingRules(
        [(r"w$", ("dp", None))]))
    by_dev = {s.device: np.asarray(s.data)
              for s in placed["w"].addressable_shards}
    parts = []
    for r in range(8):
        mesh = Mesh(np.array(["cpu"] * 8, dtype=object).reshape(
            1, 8, 1, 1, 1, 1), AXIS_ORDER, rank=r)
        part = shard_variables(tree, rules, mesh=mesh)["w"]
        np.testing.assert_array_equal(part, by_dev[jmesh.devices.flat[r]])
        assert named_sharding(mesh, "dp", None).shard_shape((8, 2)) == (1, 2)
        parts.append(part)
    np.testing.assert_array_equal(np.concatenate(parts), tree["w"])


def test_sharding_rules_fsdp_fallback_composes():
    rules = transformer_tp_rules()
    assert rules.spec_for("enc/q_proj/weight", (512, 512)) == (None, "tp")
    assert rules.spec_for("misc/weight", (128, 512)) == (None, "fsdp")
    assert rules.spec_for("somewhere/gamma", (512,)) == ()
    rules.add(r"special/weight$", ("sp", None))
    assert rules.spec_for("x/special/weight", (4, 4)) == ("sp", None)
    assert rules.spec_for("misc2/weight", (128, 512)) == (None, "fsdp")
    fr = fsdp_rules(min_size=10 ** 6)
    assert fr.spec_for("small/weight", (10, 10)) == ()
    assert fr.spec_for("big/weight", (2048, 2048)) == ("fsdp", None)


def test_eval_step_keeps_state_sharded(world):
    """REDUCE eval gathers the shards for the forward only: the module
    still holds its shards after, and the loss is the global batch's
    (JAX's single-device eval on the same weights)."""
    sc = M.SCENARIOS["mlp_eval"]
    x, y = M.batches(sc, 1)[0]
    tr = JaxTrainer(_jax_mlp(sc.model), JaxSGD(0.1), _jax_cls_loss())
    ts = _jax_ts(tr, M.jax_tree(sc.model), (jnp.zeros(x.shape),))
    want = float(tr.eval_step(ts, (jnp.asarray(x), jnp.asarray(y)))["loss"])
    for res in world["mlp_eval"]:
        assert bool(res["kept_shards"])
        assert "[16, 32]" in str(res["shapes"])      # fcs.0.weight's shard
        np.testing.assert_allclose(float(res["loss"]), want, rtol=1e-5)


def test_sharded_embedding_checkpoint_guard(tmp_path):
    from paddle_tpu_torch.io.checkpoint import read_metadata, save_checkpoint
    from paddle_tpu_torch.parallel.embedding import (
        ShardedEmbedding, checkpoint_meta, validate_checkpoint_meta)
    emb = ShardedEmbedding(1000, 16, device="cpu")
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, {"w": np.zeros((4,))},
                    metadata=checkpoint_meta(emb))
    meta = read_metadata(path)
    validate_checkpoint_meta(meta, emb)
    emb2 = ShardedEmbedding(1001, 16, device="cpu")
    with pytest.raises(ValueError, match="geometry changed"):
        validate_checkpoint_meta(meta, emb2)
    validate_checkpoint_meta({}, emb2)


# -- what the port's ranks must keep by hand -------------------------------

def test_rank_slices_equal_jax_device_shards(world):
    """After 3 REDUCE steps on dp=2 x fsdp=2, rank r holds the slices
    of JAX's device r: parameters and both Adam moments, same index,
    same values."""
    sc = M.SCENARIOS["mlp_zero"]
    bs = M.batches(sc, 3)
    mesh = jax_make_mesh(JaxMeshConfig(dp=2, fsdp=2),
                         devices=jax.devices()[:4])
    tr = JaxMeshTrainer(
        _jax_mlp(sc.model), JaxAdam(sc.optimizer[1]), _jax_cls_loss(), mesh,
        strategy=JaxDistStrategy(reduce_strategy=JaxReduceStrategy.REDUCE),
        rules=jsh.fsdp_rules(min_size=128))
    ts = tr.init_state(jnp.zeros(bs[0][0].shape))
    tree = jax.tree_util.tree_map(jnp.asarray,
                                  M.jax_tree(sc.model)["params"])
    params = jax.tree_util.tree_map(
        lambda v, a: jax.device_put(v, a.sharding), tree, ts.params)
    ts = JaxTrainState(params, ts.state, jax.tree_util.tree_map(
        lambda a: jax.device_put(jnp.zeros_like(a), a.sharding),
        ts.opt_state), ts.step)
    for i, (x, y) in enumerate(bs):
        ts, _ = tr.train_step(ts, tr.put_batch((x, y)),
                              rng=jax.random.key(i))
    jleaves = dict(flatten_with_keys({
        "params": ts.params, **{f"slots/{s}": t for s, t in
                                ts.opt_state["slots"].items()}}))
    checked = 0
    for r, res in enumerate(world["mlp_zero"]):
        dev = mesh.devices.flat[r]
        for prefix in ("at3/params", "at3/slots/m", "at3/slots/v"):
            for path, (data, region) in M.split(res, prefix).items():
                arr = jleaves[f"{prefix[4:]}/{path}"]
                shard = next(s for s in arr.addressable_shards
                             if s.device == dev)
                want_spans = [[s.start or 0, d if s.stop is None
                               else s.stop] for s, d in zip(shard.index,
                                                            arr.shape)]
                np.testing.assert_array_equal(
                    [[s.start, s.stop] for s in region], want_spans)
                np.testing.assert_allclose(data, np.asarray(shard.data),
                                           rtol=1e-4, atol=1e-5,
                                           err_msg=f"rank {r} {prefix}/"
                                                   f"{path}")
                checked += 1
    assert checked == 4 * 3 * 4


def test_tp_gradient_contract_leaf_by_leaf(world):
    """After the backward and the batch-axis mean of the first step,
    every rank's gradient of every leaf is its own slice of JAX's
    single-device gradient over the whole batch (a whole leaf: the whole
    gradient), and a leaf whole across tp has the same gradient bits on
    both tp ranks."""
    sc = M.SCENARIOS["tf_tp"]
    model = _jax_tf()
    params = jax.tree_util.tree_map(jnp.asarray,
                                    M.jax_tree("tiny_tf")["params"])
    batch = tuple(jnp.asarray(a) for a in M.seq_batch(sc.batch))

    def loss(p):
        (l, _), _ = _jax_seq_loss(model, {"params": p}, batch, None, True)
        return l
    want = dict(flatten_with_keys(jax.device_get(jax.grad(loss)(params))))
    ranks = world["tf_tp"]
    rules = transformer_tp_rules()
    for r, res in enumerate(ranks):
        pieces = M.split(res, "params")
        for path, g in want.items():
            got = res[f"grad/{path}"]
            np.testing.assert_allclose(got, np.asarray(g)[pieces[path][1]],
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"rank {r} {path}")
            if "tp" not in rules.spec_for(path, np.shape(g)):
                np.testing.assert_array_equal(
                    got, ranks[r ^ 1][f"grad/{path}"], err_msg=path)


def test_remat_equals_no_remat_bit_for_bit(world):
    """Dropout 0.1 at dp=2 x tp=2: the recomputed forward draws the
    same masks, so remat and no-remat give the same bits."""
    for res in world["tf_remat"]:
        np.testing.assert_array_equal(res["remat/losses"],
                                      res["plain/losses"])
        plain = M.join([res], "plain/params")
        for path, v in M.join([res], "remat/params").items():
            np.testing.assert_array_equal(v, plain[path], err_msg=path)


def test_tp_dropout_masks_are_the_ranks_own(world):
    """Dropout 0.1 at dp=2 x tp=2, where the two tp ranks of a dp row
    share their batch coordinate and so the step generator. Inside the
    tp region (the attention of each rank's heads, the FFN's hidden
    columns) the tp ranks draw different masks, as one device drawing
    the whole activation would; on the replicated activations
    (embeddings, residual branches) the same, or the replicas would
    part. A rerun from the same seed draws the same masks."""
    ranks = world["tf_tp_masks"]
    counts = {"attn": 6, "ffn": 4, "replicated": 12}
    for a, b in ((0, 1), (2, 3)):
        for site, n in counts.items():
            keys = [f"run0/{site}/{i}" for i in range(n)]
            assert f"run0/{site}/{n}" not in ranks[a]
            for k in keys:
                m = ranks[a][k]
                assert 0.0 < m.mean() < 1.0, k       # the mask drops some
                same = np.array_equal(m, ranks[b][k])
                assert same == (site == "replicated"), (a, b, k)
    for r, res in enumerate(ranks):
        for k, m in res.items():
            if k.startswith("run0/"):
                np.testing.assert_array_equal(
                    m, res["run1/" + k[len("run0/"):]],
                    err_msg=f"rank {r} {k}")


def test_guard_skips_the_same_step_on_every_rank(world):
    """A NaN in one rank's rows of step 1: every rank skips step 1 (the
    flag is max-reduced over the world before the host reads it), and
    the ranks' parameters stay equal."""
    ranks = world["mlp_guard"]
    for res in ranks:
        assert res["bad"].tolist() == [False, True, False]
        assert int(res["step"]) == 2 and int(res["opt_step"]) == 2
        for path, (v, _) in M.split(res, "params").items():
            np.testing.assert_array_equal(
                v, M.split(ranks[0], "params")[path][0])


def test_sync_bn_equals_single_device_over_the_global_batch(world):
    """BatchNorm(axis_name="dp") over 4 ranks of 8 rows == the same
    BatchNorm on one device over the 32 rows: the losses, the first
    step's gradients, the parameters and the running statistics."""
    single = M.run_single("bn_sync")
    for res in world["bn_sync"]:
        np.testing.assert_allclose(res["losses"], single["losses"],
                                   rtol=1e-5)
        for k, v in single.items():
            if k.startswith(("grad/", "params/", "state/")) and "#" not in k:
                np.testing.assert_allclose(res[k], v, rtol=1e-5, atol=1e-6,
                                           err_msg=k)


@pytest.mark.parametrize("name", ["mlp_clip_norm", "mlp_clip_global"])
def test_norm_clipping_spans_the_shards(world, name):
    """Norm and global-norm clipping over ZeRO-sharded gradients take
    each norm over every rank's part (and count a part held by several
    ranks once): dp=2 x fsdp=2 == the single-rank run."""
    single = M.run_single(name)
    ranks = world[name]
    np.testing.assert_allclose(ranks[0]["losses"], single["losses"],
                               rtol=1e-5)
    got = M.join(ranks, "params")
    for k, v in single.items():
        if k.startswith("params/") and "#" not in k:
            np.testing.assert_allclose(got[k[len("params/"):]], v,
                                       rtol=1e-4, atol=1e-6, err_msg=k)


def test_a_dropped_trainer_frees_its_tensors(world):
    """A ZeRO trainer with norm clipping (the optimizer's hook over the
    shards set), stepped and dropped, goes with its last reference: no
    cycle between it and its optimizer keeps a finished run's
    parameters and slots on the card until a cycle collection."""
    for res in world["mlp_freed"]:
        assert bool(res["freed"])


def test_bert_tp_matches_one_rank(world):
    """BertEncoder (fused head-major qkv, padding as segment ids, the
    tied MLM head gathered over tp) at dp=2 x tp=2 under
    transformer_tp_rules == its single-rank run."""
    single = M.run_single("bert_tp")
    ranks = world["bert_tp"]
    for res in ranks:
        np.testing.assert_allclose(res["losses"], single["losses"],
                                   rtol=1e-5)
        qkv, _ = M.split(res, "params")["layers_0/attn/qkv/weight"]
        assert qkv.shape == (16, 24)                  # 2 of 4 heads
    got = M.join(ranks, "params")
    for k, v in single.items():
        if k.startswith("params/") and "#" not in k:
            np.testing.assert_allclose(got[k[len("params/"):]], v,
                                       rtol=1e-4, atol=1e-6, err_msg=k)

