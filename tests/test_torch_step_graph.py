"""The port's step program (engine/step_graph.py) against the JAX
engine's jitted `_step_fn`.

On the CPU the program is the eager step over the staged operands; on
the card it is a captured CUDA graph (tests/test_torch_kernels_gpu.py).
Here: for the same traffic the nine operands the port stages each step
equal, element for element, the ones the JAX engine passes to its
`_step_fn` (read by wrapping that engine instance's attribute), with the
int8 tier off and on, and the greedy streams are equal; the compile
gauge is the program cache's size; the launch accounting of a capture
restores the counters and adds its rise per replay; a pool rebound under
the program raises; the pad-only step (the capture's warm-up) writes
nothing but scratch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.engine import ServeEngine as JaxServeEngine
from paddle_tpu.models.transformer import CausalLM as JaxCausalLM
from paddle_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from paddle_tpu_torch.engine import ServeEngine
from paddle_tpu_torch.engine.step_graph import OPERANDS
from paddle_tpu_torch.kernels import paged_attention as paged
from paddle_tpu_torch.models import CausalLM, load_jax_params
from paddle_tpu_torch.obs.metrics import MetricsRegistry
from paddle_tpu_torch.testing import causal_lm_tree

VOCAB = 61
DIMS = dict(model_dim=16, num_heads=4, num_layers=2, ffn_dim=32,
            num_kv_heads=2)
# a pool small enough that the fillers recycle the prefix's fp blocks
ENGINE = dict(max_batch_size=4, block_size=4, num_blocks=16,
              max_prefill_tokens=8, tile_q=4)

PREFIX = [7, 3, 7, 3, 11, 2, 5, 9, 1, 1, 4, 8]
# wave 1: a prompt chunked over three steps with a short prompt's decode
# rows riding them; fillers; wave 2 on the shared prefix and on the last
# filler (a prefix hit with the tier off, where the fillers evict PREFIX)
WAVE1 = [PREFIX + [6, 2, 40, 41, 42, 43, 44, 45], [5, 9, 2]]
FILLERS = [[[50] * 8], [[30] * 16], [[31] * 16], [[32] * 16]]
WAVE2 = [PREFIX + [6, 2, 33], PREFIX + [20, 21], [32] * 16 + [1, 2]]


@pytest.fixture(scope="module")
def models():
    tree = causal_lm_tree(0, VOCAB, **DIMS)
    jm = JaxCausalLM(VOCAB, dropout=0.0, max_len=64, **DIMS)
    tm = CausalLM(VOCAB, dropout=0.0, max_len=64, device="cpu", **DIMS)
    load_jax_params(tm, tree)
    return jm, jax.tree_util.tree_map(jnp.asarray, tree), tm


def _port(tm, **kw):
    return ServeEngine(tm, device="cpu", registry=MetricsRegistry(),
                       **dict(ENGINE, **kw))


def _traffic(eng):
    out = eng.generate(WAVE1, max_new_tokens=6)
    for wave in FILLERS:
        out += eng.generate(wave, max_new_tokens=6)
    return out + eng.generate(WAVE2, max_new_tokens=6)


def _record_port(eng):
    """Every step's staged operands, as the step program reads them."""
    calls, run = [], eng.step_graph.run

    def recorded():
        calls.append({k: v.copy() for k, v in
                      eng.step_graph.operands.items()})
        return run()
    eng.step_graph.run = recorded
    return calls


def _record_jax(eng):
    """Every step's operands as the JAX engine passes them to its
    jitted `_step_fn` (the wrapper keeps the jit cache's size)."""
    calls, step_fn = [], eng._step_fn

    def recorded(variables, tokens, positions, pools, qpools, qscales,
                 *rest):
        calls.append({k: np.asarray(a) for k, a in
                      zip(OPERANDS, (tokens, positions, *rest))})
        return step_fn(variables, tokens, positions, pools, qpools,
                       qscales, *rest)
    recorded._cache_size = step_fn._cache_size
    eng._step_fn = recorded
    return calls


@pytest.mark.parametrize("compress", [0, 24])
def test_staged_operands_equal_jax_step_fn_operands(models, compress):
    """Two waves on a shared prefix, a chunked prompt with a decode
    rider, fillers that recycle the prefix's fp blocks: every step's
    nine operands equal JAX's element for element (int32 both; JAX's
    last_idx is [B, spec_len = 1]), and so do the greedy streams. With
    the int8 tier on, wave 2 reads the prefix in place (negative
    table ids)."""
    jm, jvars, tm = models
    port = _port(tm, kv_compress_blocks=compress)
    ref = JaxServeEngine(jm, jvars, registry=JaxRegistry(),
                         **dict(ENGINE, kv_compress_blocks=compress))
    got_ops, want_ops = _record_port(port), _record_jax(ref)
    assert _traffic(port) == _traffic(ref)
    assert len(got_ops) == len(want_ops) == port.steps
    for step, (got, want) in enumerate(zip(got_ops, want_ops)):
        assert want["last_idx"].shape == (ENGINE["max_batch_size"], 1)
        want["last_idx"] = want["last_idx"][:, 0]
        for name in OPERANDS:
            assert got[name].dtype == want[name].dtype == np.int32, name
            np.testing.assert_array_equal(got[name], want[name],
                                          err_msg=f"step {step}: {name}")
    # the traffic holds what it claims: a step with a prefill chunk and
    # a decode row, and with the tier on an int8-resident table entry
    lengths = [ops["context_lens"] - ops["q_starts"] for ops in got_ops]
    assert any((n > 1).any() and (n[:-1] == 1).any() for n in lengths)
    assert port.cache.hit_tokens > 0
    if compress:
        assert any((ops["block_tables"] < 0).any() for ops in got_ops)
        assert port.cache.stats()["direct_int8_reads"] > 0


@pytest.mark.parametrize("compress", [0, 24])
def test_compiles_gauge_is_the_program_cache_size(models, compress):
    """ptpu_engine_compiles reads the program cache: one entry (the
    eager step on the CPU, no graph) across mixed traffic, as JAX's
    gauge reads its jit cache."""
    port = _port(models[2], kv_compress_blocks=compress)
    _traffic(port)
    assert port.step_graph.compiles == 1
    assert port.step_graph.graphs == []
    assert port.obs.get("ptpu_engine_compiles").value == 1
    assert len(port.step_shapes) == 1
    port.cache.assert_quiesced()


class _Counters:
    a = 5
    b = 0


def test_captured_launches_restore_and_replay():
    """The warm-up's and the capture's counts are put back; each replay
    adds the capture's rise; a capture that raises still restores."""
    acct = paged.CapturedLaunches(((_Counters, "a"), (_Counters, "b")))

    def warm_up():
        _Counters.a += 2
        _Counters.b += 2

    def record():
        _Counters.a += 3
        return "graph"
    assert acct.capture(record, warm_up=warm_up) == "graph"
    assert (_Counters.a, _Counters.b) == (5, 0)
    assert acct.per_replay == (3, 0)
    acct.replay()
    acct.replay()
    assert (_Counters.a, _Counters.b) == (11, 0)

    def broken():
        _Counters.b += 1
        raise RuntimeError("capture failed")
    with pytest.raises(RuntimeError, match="capture failed"):
        acct.capture(broken)
    assert (_Counters.a, _Counters.b) == (11, 0)
    # by default it keeps the paged wrappers' three counters
    assert paged.CapturedLaunches().counters == paged.LAUNCH_COUNTERS
    assert {(f.__name__, a) for f, a in paged.LAUNCH_COUNTERS} == {
        ("ragged_paged_attention", "launches"),
        ("ragged_paged_attention", "mixed_launches"),
        ("paged_attention", "launches")}


@pytest.mark.parametrize("which", ["pools", "qpools", "qscales"])
def test_rebound_pool_raises(models, which):
    """A pool the program was built over, rebound to a new tensor,
    raises at the next step instead of being read at a stale address."""
    port = _port(models[2], kv_compress_blocks=24)
    port.generate([[5, 9, 2]], max_new_tokens=2)
    layers = getattr(port.cache, which)
    layers[1] = (layers[1][0].clone(), layers[1][1])
    with pytest.raises(RuntimeError, match="pools moved"):
        port.generate([[5, 9, 2]], max_new_tokens=2)


def test_pad_only_step_writes_only_scratch(models):
    """The step the capture runs (`clear()` then a step): every tile on
    the null row, every slot scratch; no block but scratch block 0
    changes."""
    port = _port(models[2], kv_compress_blocks=24)
    port.generate([PREFIX], max_new_tokens=3)
    before = [t.clone() for pair in port.cache.pools for t in pair]
    port.step_graph.clear()
    logits = port.step_graph.run()
    assert logits.shape == (ENGINE["max_batch_size"], VOCAB)
    assert np.isfinite(logits).all()
    after = [t for pair in port.cache.pools for t in pair]
    for old, new in zip(before, after):
        assert torch.equal(old[1:], new[1:])


def test_prompt_ids_must_fit_int32(models):
    port = _port(models[2])
    with pytest.raises(ValueError, match="int32"):
        port.add_request([5, 2 ** 31])
