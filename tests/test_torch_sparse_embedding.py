"""The port's sharded sparse embedding (paddle_tpu_torch/parallel/
embedding.py): mirrors of tests/test_sparse_embedding.py on a world of
4 gloo ranks (dp=2 x fsdp=2, parallel/launch.py) running the embedding
scenarios of paddle_tpu_torch/testing/mesh_cases.py, against JAX's
dense Embedding and the port's single-rank runs:

- the lookup over the row-sharded table equals the dense lookup, and
  its gradient equals the dense gradient with untouched rows zero;
- DeepFM(embedding_cls=ShardedEmbedding) trains, each rank holding half
  the table, and matches its single-rank run;
- the vocabulary is padded to a multiple of the axis;
- the ctr_synthetic reader feeds it through DataFeeder(sharding=);
- the trap of a batch sharded over the table's own axis (the ids are
  gathered over the axis first) matches the single-rank run too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu.core.module import PARAMS
from paddle_tpu.nn.layers import Embedding as JaxEmbedding
from paddle_tpu_torch.parallel.embedding import ShardedEmbedding
from paddle_tpu_torch.parallel.mesh import AXIS_ORDER, Mesh
from paddle_tpu_torch.testing import mesh_cases as M
from paddle_tpu_torch.testing import one_torch_thread

WORLD = ("emb_lookup", "deepfm_sharded", "deepfm_split_ids",
         "deepfm_reader")


@pytest.fixture(autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def world():
    return M.run_world(4, WORLD, device="cpu")


def _fsdp_coord(rank):
    return rank % 2          # dp=2 x fsdp=2, fsdp the minor axis


def test_lookup_parity_with_dense(world):
    table = M.emb_table()
    ids, _ = M.emb_ids()
    dense = JaxEmbedding(M.EMB_VOCAB, M.EMB_DIM)
    want = np.asarray(dense.apply({PARAMS: {"weight": jnp.asarray(table)}},
                                  jnp.asarray(ids)))
    for res in world["emb_lookup"]:
        np.testing.assert_allclose(res["lookup"], want, rtol=1e-6)
        assert int(res["rows"]) == 16          # 32 rows over fsdp=2


def test_gradient_parity_and_sparsity(world):
    """The backward scatters into each rank's own rows: joined, they are
    the dense gradient, and the rows no id touched are zero."""
    table = M.emb_table()[:32]
    _, ids = M.emb_ids()
    dense = JaxEmbedding(32, M.EMB_DIM)

    def loss(t):
        return jnp.sum(jnp.square(dense.apply({PARAMS: {"weight": t}},
                                              jnp.asarray(ids))))
    want = np.asarray(jax.grad(loss)(jnp.asarray(table)))
    got = np.zeros_like(want)
    for r, res in enumerate(world["emb_lookup"]):
        c = _fsdp_coord(r)
        got[16 * c:16 * (c + 1)] = res["table_grad"]
        np.testing.assert_allclose(res["table_grad"],
                                   want[16 * c:16 * (c + 1)],
                                   rtol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.all(got[16:] == 0)


def test_deepfm_sharded_trains_and_shards(world):
    """DeepFM with the sharded table on dp=2 x fsdp=2: each rank holds
    half the table's rows, the loss falls, and the run matches the
    single-rank one within 1e-5."""
    single = M.run_single("deepfm_sharded")
    for res in world["deepfm_sharded"]:
        data, region = M.split(res, "params")["table/weight"]
        assert data.shape[0] == region[0].stop - region[0].start == 128 // 2
        assert np.isfinite(res["losses"]).all()
        assert res["losses"][-1] < res["losses"][0]
        np.testing.assert_allclose(res["losses"], single["losses"],
                                   atol=1e-5)


def test_vocab_padding_unused_rows():
    mesh = Mesh(np.array(["cpu"] * 8, dtype=object).reshape(
        1, 2, 4, 1, 1, 1), AXIS_ORDER)
    emb = ShardedEmbedding(10, 4, axis="fsdp", mesh=mesh, batch_axes=(),
                           device="cpu")
    # 10 rows padded up to a multiple of fsdp=4
    assert tuple(emb.weight.shape) == (12, 4)


def test_deepfm_with_ctr_reader(world):
    for res in world["deepfm_reader"]:
        assert np.isfinite(res["losses"]).all() and len(res["losses"]) == 4
        assert set(res["rows"].tolist()) == {8}        # 16 rows over dp=2


def test_ids_sharded_over_the_table_axis(world):
    """The batch sharded over dp and fsdp, the table over fsdp: peers
    on fsdp hold different ids, which the lookup gathers first; the
    run matches the single-rank one within 1e-5."""
    single = M.run_single("deepfm_split_ids")
    for res in world["deepfm_split_ids"]:
        np.testing.assert_allclose(res["losses"], single["losses"],
                                   atol=1e-5)
        data, region = M.split(res, "params")["table/weight"]
        np.testing.assert_allclose(data, single["params/table/weight"][region],
                                   rtol=1e-5, atol=1e-6)
