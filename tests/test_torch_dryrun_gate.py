"""The dry-run parity gate on the port: every phase of
`__graft_entry__._dryrun_impl(8)` (__graft_entry__.py:99-405) run on a
world of 8 gloo ranks on the CPU and held against the same phase on one
rank, with JAX's tolerances — so a finite-but-wrong sharded step fails
here, as the reference's dist tests assert dist-vs-local loss deltas.

The phases (paddle_tpu_torch/testing/parallel_cases.py, `run_dry_*`):
an MLP on dp=4 x fsdp=2 with accumulation; a Transformer on dp=2 x tp=4;
PipelinedLM on pp=2 x tp=2 x sp=2 under GPipe and on pp=2 x tp=2 x dp=2
under 1F1B, both with the fused CE, against the dense step; the MoE FFN
masked and all_to_all on ep=4 x dp=2; PipelinedMoELM on pp=2 x ep=2 x
dp=2 against its dense step; ring and Ulysses attention on sp=8 against
dense causal attention. One world runs them all, once a test run.
"""

import numpy as np
import pytest

from paddle_tpu_torch.testing import mesh_cases as M
from paddle_tpu_torch.testing import one_torch_thread
from paddle_tpu_torch.testing import parallel_cases as P

TOL = 2e-4     # float32; sharded vs local reduction order
# Post-Adam parameters: the bias-corrected first step is ~lr * sign(g),
# so for a near-zero gradient a reduction-order wobble can flip the
# update's sign — a 2 * lr delta with no sharding fault (JAX's PTOL).
PTOL = 2e-3
N = 8


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return P.world_once(tmp_path_factory.getbasetemp(), "dryrun_world",
                        lambda _: P.run_world(N, P.DRY_CASES))


def _single(case: str):
    with one_torch_thread():
        return P.CASES[case][1](None)


def _max_err(got, want) -> float:
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    return max(float(np.max(np.abs(np.asarray(got[k], np.float32)
                                   - np.asarray(want[k], np.float32))))
               for k in want)


def _trained(ranks, ref):
    """(loss, gradient, parameter) errors of a trained phase: every
    rank's loss against the one rank's, the ranks' pieces joined."""
    loss = max(abs(float(r["loss"]) - float(ref["loss"])) for r in ranks)
    return (loss, _max_err(M.join(ranks, "grads"), M.join([ref], "grads")),
            _max_err(M.join(ranks, "params"), M.join([ref], "params")))


def _dense_attention(q: np.ndarray) -> np.ndarray:
    """Single-rank exact causal attention with q = k = v, float64."""
    q = q.astype(np.float64)
    s = np.einsum("bqhd,bkhd->bhqk", q, q) / np.sqrt(q.shape[-1])
    t = q.shape[1]
    s = np.where(np.tril(np.ones((t, t), bool))[None, None], s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, q)


def _moe_errs(ranks, ref):
    """The MoE phase, masked and a2a: loss and gradient errors. The
    experts sit over the ep ranks of dp coordinate 0 (ranks 0-3)."""
    ep = ranks[:4]
    errs = {}
    for path in ("masked", "a2a"):
        if path == "masked":
            loss = max(abs(float(r["masked/loss"]) - float(ref["masked/loss"]))
                       for r in ranks)
            gate = ep[0]["masked/gate"]
            for r in ranks:        # replicated: the whole gradient on each
                np.testing.assert_array_equal(r["masked/gate"], gate)
        else:
            loss = abs(sum(float(r["a2a/loss_part"]) for r in ep)
                       - float(ref["masked/loss"]))
            gate = sum(r["a2a/gate"] for r in ep)
        got = {"gate": gate,
               **{w: np.concatenate([r[f"{path}/{w}"] for r in ep])
                  for w in ("w1", "w2")}}
        want = {w: ref[f"masked/{w}"] for w in ("gate", "w1", "w2")}
        errs[f"moe_{path}_loss"] = loss
        errs[f"moe_{path}_grads"] = _max_err(got, want)
    return errs


PHASES = ("mlp", "transformer", "pipeline", "pipeline_1f1b", "moe",
          "moe_pipeline", "ring_ulysses")
CASE = dict(zip(PHASES, P.DRY_CASES))


@pytest.mark.parametrize("phase", PHASES)
def test_dryrun_phase_matches_one_rank(world, phase):
    """One phase of the 8-rank dry run against one rank: losses,
    attention outputs and the reduced gradients within TOL (JAX's gate
    holds gradients in its MoE phase only; a gradient off by a constant
    factor passes one Adam step's parameters, which are near lr *
    sign(g)), post-Adam parameters within PTOL."""
    case = CASE[phase]
    ranks = world[case]
    if phase == "ring_ulysses":
        want = _dense_attention(P.dry_ring_q())
        for name in ("ring", "ulysses"):
            got = np.concatenate([r[name] for r in ranks], axis=1)
            err = float(np.max(np.abs(got - want)))
            assert err < TOL, f"{name} attention parity: {err:.2e}"
        return
    ref = _single(case)
    if phase == "moe":
        errs = _moe_errs(ranks, ref)
        assert all(v < TOL for v in errs.values()), f"moe parity: {errs}"
        return
    loss_err, grad_err, param_err = _trained(ranks, ref)
    assert loss_err < TOL, f"{phase} loss parity: {loss_err:.2e}"
    assert grad_err < TOL, f"{phase} gradient parity: {grad_err:.2e}"
    assert param_err < PTOL, f"{phase} param parity: {param_err:.2e}"
    assert np.isfinite(float(ref["loss"]))
