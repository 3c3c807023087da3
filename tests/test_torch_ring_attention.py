"""Ring and Ulysses attention of the port (paddle_tpu_torch/parallel/
ring.py) against the JAX package, mirroring tests/test_ring_attention.py
by name. One world of 8 gloo ranks runs the cases of
paddle_tpu_torch/testing/parallel_cases.py on JAX's meshes (sp=8 and
sp=4 x dp=2); each rank's output and gradient shards are held against
the JAX function's on the same numpy-seeded inputs, at JAX's bars:
2e-4 on outputs, 5e-3 on gradients. On the CPU the flash kernels run
their plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.attention import reference_attention
from paddle_tpu.parallel import MeshConfig, make_mesh as jax_make_mesh
from paddle_tpu.parallel.ring import (ring_attention as jax_ring_attention,
                                      ring_flash_attention as jax_ring_flash,
                                      zigzag_shard as jax_zigzag_shard,
                                      zigzag_unshard as jax_zigzag_unshard)
from paddle_tpu_torch.parallel import ring as R
from paddle_tpu_torch.parallel.mesh import AXIS_ORDER, Mesh
from paddle_tpu_torch.testing import parallel_cases as P

WORLD = ("ring_dense", "ring_grads", "ring_flash", "ulysses")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return P.world_once(tmp_path_factory.getbasetemp(), "ring_world",
                        lambda _: P.run_world(8, WORLD))


def joined(ranks, key, sizes, axis="sp", dim=1):
    """The shards of `key` along `axis` joined on `dim` (the ranks whose
    other coordinates are 0), after checking that the replicas (dp)
    hold the same."""
    shape = tuple(sizes.get(a, 1) for a in AXIS_ORDER)
    by = {}
    for r, res in enumerate(ranks):
        c = dict(zip(AXIS_ORDER, np.unravel_index(r, shape)))
        rest = tuple(c[a] for a in AXIS_ORDER if a != axis)
        by.setdefault(rest, {})[int(c[axis])] = res[key]
    parts = list(by.values())
    for other in parts[1:]:
        for i, x in other.items():
            np.testing.assert_array_equal(x, parts[0][i])
    return np.concatenate([parts[0][i] for i in sorted(parts[0])], dim)


def causal_mask(t):
    return (jnp.arange(t)[None, :] <= jnp.arange(t)[:, None])[None, None]


def dense_grads(q, k, v, causal):
    def loss(q, k, v):
        return jnp.sum(reference_attention(
            q, k, v, mask=causal_mask(q.shape[1]) if causal else None) ** 2)
    return jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)


SP4 = dict(sp=4, dp=2)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_reference(world, causal):
    q, k, v = (jnp.asarray(x) for x in P.qkv(2, 64, 2, 16, 0, 1.0))
    got = joined(world["ring_dense"], f"out_c{int(causal)}", dict(sp=8))
    mesh = jax_make_mesh(MeshConfig(sp=8))
    out = jax.jit(lambda q, k, v: jax_ring_attention(
        q, k, v, mesh, causal=causal))(q, k, v)
    np.testing.assert_allclose(got, np.asarray(out), rtol=2e-4, atol=2e-5)
    ref = reference_attention(q, k, v,
                              mask=causal_mask(64) if causal else None)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=2e-4, atol=2e-5)


def test_ring_attention_grads_flow(world):
    got = joined(world["ring_grads"], "grad", SP4)
    assert np.isfinite(got).all() and np.linalg.norm(got) > 0
    q = jnp.asarray(P.qkv(2, 32, 2, 8, 1, 1.0)[0])
    want = jax.jit(jax.grad(lambda q: jnp.sum(reference_attention(
        q, q, q, mask=causal_mask(32)) ** 2)))(q)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=2e-4)


class TestRingFlash:
    """ring_flash_attention: kernel 4 on each block with the (o, lse)
    merge, kernels 5 and 6 in the ring-level backward, zig-zag causal
    balance."""

    def _case(self, world, name):
        t, seed, causal, zigzag, grads = P.RING_FLASH[name]
        q, k, v = (jnp.asarray(x) for x in P.qkv(1, t, 2, 32, seed))
        ranks = world["ring_flash"]
        got = {n: joined(ranks, f"{name}/{n}", SP4)
               for n in ("out", "dq", "dk", "dv")
               if f"{name}/{n}" in ranks[0]}
        if zigzag:
            got = {n: np.asarray(jax_zigzag_unshard(jnp.asarray(x), 4))
                   for n, x in got.items()}
        return (q, k, v), causal, got

    def _against_reference(self, world, name):
        (q, k, v), causal, got = self._case(world, name)
        want = reference_attention(
            q, k, v, mask=causal_mask(q.shape[1]) if causal else None)
        np.testing.assert_allclose(got["out"], np.asarray(want),
                                   rtol=2e-4, atol=2e-4)
        if "dq" in got:
            for n, g in zip(("dq", "dk", "dv"),
                            dense_grads(q, k, v, causal)):
                np.testing.assert_allclose(got[n], np.asarray(g),
                                           rtol=5e-3, atol=5e-3, err_msg=n)
        return (q, k, v), causal, got

    def _against_jax_ring(self, world, name):
        (q, k, v), causal, got = self._against_reference(world, name)
        mesh = jax_make_mesh(MeshConfig(sp=4, dp=2))
        out = jax.jit(lambda q, k, v: jax_ring_flash(
            q, k, v, mesh, "sp", causal=causal))(q, k, v)
        np.testing.assert_allclose(got["out"], np.asarray(out),
                                   rtol=2e-4, atol=2e-4)

    def test_full_attention_parity(self, world):
        self._against_reference(world, "full")

    def test_causal_parity(self, world):
        self._against_jax_ring(world, "causal")

    def test_causal_grads_match_dense(self, world):
        self._against_reference(world, "causal_grads")

    def test_zigzag_causal_parity_and_grads(self, world):
        self._against_reference(world, "zigzag")

    def test_zigzag_shard_roundtrip(self):
        x = np.arange(32.0, dtype=np.float32).reshape(1, 32, 1, 1)
        z = R.zigzag_shard(torch.from_numpy(x), 4)
        np.testing.assert_array_equal(R.zigzag_unshard(z, 4).numpy(), x)
        np.testing.assert_array_equal(z[0, :8, 0, 0].numpy(),
                                      [0, 1, 2, 3, 28, 29, 30, 31])
        np.testing.assert_array_equal(
            z.numpy(), np.asarray(jax_zigzag_shard(jnp.asarray(x), 4)))

    def test_ring_flash_nondivisible_block_length(self, world):
        """T 768 over sp 4: 192 a rank, not a multiple of the kernels'
        tiles (JAX picks a divisor block; the port's kernels bound-check
        their tails)."""
        self._against_jax_ring(world, "nondivisible")


class TestUlysses:
    """All-to-all (Ulysses) sequence parallelism: full-attention parity
    and gradients on the sp mesh."""

    def test_parity_and_grads(self, world):
        q, k, v = (jnp.asarray(x) for x in P.qkv(1, 256, 4, 32, 0))
        ranks = world["ulysses"]
        got = {n: joined(ranks, n, SP4) for n in ("out", "dq", "dk", "dv")}
        want = reference_attention(q, k, v, mask=causal_mask(256))
        np.testing.assert_allclose(got["out"], np.asarray(want),
                                   rtol=2e-4, atol=2e-4)
        for n, g in zip(("dq", "dk", "dv"), dense_grads(q, k, v, True)):
            np.testing.assert_allclose(got[n], np.asarray(g), rtol=5e-3,
                                       atol=5e-3, err_msg=n)

    def test_rejects_indivisible_heads(self):
        devs = np.empty(4, dtype=object)
        devs[:] = [torch.device("cpu")] * 4
        mesh = Mesh(devs.reshape(1, 1, 1, 1, 4, 1), AXIS_ORDER)
        x = torch.zeros((1, 16, 3, 16))          # 3 heads, sp=4
        with pytest.raises(ValueError, match="not divisible"):
            R.ulysses_attention(x, x, x, mesh, "sp")
