"""The port's benchmark harness and model zoo (paddle_tpu_torch/benchmark,
ops/fused_ce.py's mfu_flops_correction) against the JAX package's:
a mirror of tests/test_benchmark.py at tiny sizes on the CPU, plus the
FLOP counts held against JAX's `compiled_flops`.

FLOPs: JAX reads XLA's cost analysis of the compiled step; the port
runs the step once under torch.utils.flop_counter. The two agree on
matmuls (within 1% on a dense SGD step, whose elementwise work is
under 1%). They differ, by design of the counters, on two things the
tests pin:
- elementwise work (activations, softmax, LayerNorm, the optimizer's
  update): XLA counts it, the flop counter does not, so the port's
  train-step count sits below JAX's by that work;
- a SAME-padded convolution: XLA counts only the taps inside the image,
  the flop counter every tap of the window, so a small image's forward
  counts above JAX's.
"""

import dataclasses
import io
import json
import os
import re
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import benchmark as jbench
from paddle_tpu.benchmark import harness as jharness
from paddle_tpu.benchmark import models as jmodels
from paddle_tpu.ops import fused_ce as jfused
from paddle_tpu_torch import benchmark as pbench
from paddle_tpu_torch.benchmark import harness as pharness
from paddle_tpu_torch.benchmark import models as pmodels
from paddle_tpu_torch.ops import fused_ce as pfused
from paddle_tpu_torch.testing import one_torch_thread
from paddle_tpu_torch.testing.mesh_cases import REPO_ROOT

CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _fields(cls):
    return [f.name for f in dataclasses.fields(cls)]


# -- the registry and the result -----------------------------------------

def test_registry_covers_reference_zoo():
    # the reference zoo: mnist, vgg, resnet, se_resnext,
    # machine_translation (transformer), stacked_dynamic_lstm
    for name in ("mnist", "vgg16", "resnet50", "se_resnext50",
                 "transformer", "stacked_lstm", "deepfm"):
        assert name in pbench.MODELS
    # every JAX spec under its name; every JAX infer model, and the
    # port's served LM
    assert set(pbench.MODELS) == set(jbench.MODELS)
    assert set(jmodels.INFER_MODELS) | {"causal_lm", "causal_lm_int8kv"} \
        == set(pmodels.INFER_MODELS)
    assert pmodels.BASELINES == jmodels.BASELINES
    assert pmodels.INFER_BASELINES == jmodels.INFER_BASELINES
    assert pmodels.LM_BASE == jmodels.LM_BASE
    assert pmodels.LM_VOCAB == jmodels.LM_VOCAB
    assert _fields(pbench.BenchResult) == _fields(jbench.BenchResult)
    assert pbench.__all__ == jbench.__all__


def test_run_timed_counts_steps():
    calls = []

    def step(state):
        calls.append(1)
        return state + 1, state

    sec, steps, final = pbench.run_timed(step, torch.zeros(()),
                                         min_time=0.01, warmup=2)
    assert steps >= 8 and sec > 0
    assert len(calls) == steps + 2
    assert float(final) == len(calls)
    # JAX's window counts its calls the same way: warmup + every step
    jcalls = []

    def jstep(state):
        jcalls.append(1)
        return state + 1, state

    _, jsteps, _ = jbench.run_timed(jstep, jnp.zeros(()), min_time=0.01,
                                    warmup=2)
    assert jsteps >= 8 and len(jcalls) == jsteps + 2


# the port's count over JAX's on the same spec (tiny batch): the
# elementwise work XLA counts and the flop counter does not
SPEC_FLOP_RATIO = {
    "mnist": (dict(batch_size=16), 0.9556),
    "deepfm": (dict(batch_size=64), 0.9350),
}


@pytest.mark.parametrize("name", sorted(SPEC_FLOP_RATIO))
def test_spec_bench_result(name):
    """test_mnist_bench_result and test_deepfm_bench_result: the result's
    fields, unit and batch as JAX's spec gives them, the FLOPs pinned."""
    kw, ratio = SPEC_FLOP_RATIO[name]
    r = pbench.run_model(name, min_time=0.05, device=CPU, **kw)
    j = jbench.run_model(name, min_time=0.01, **kw)
    assert r.value > 0 and r.ms_per_step > 0 and r.steps >= 40
    assert (r.model, r.unit, r.batch_size) == (j.model, j.unit, j.batch_size)
    assert r.mfu is None and j.mfu is None            # no card, no peak
    assert r.device == "cpu"
    assert r.vs_baseline == j.vs_baseline is None
    d = r.to_dict()
    assert set(d) == set(j.to_dict())
    assert set(d) >= {"model", "unit", "value", "ms_per_step", "mfu",
                      "flops_per_step", "device", "vs_baseline"}
    assert r.flops_per_step < j.flops_per_step
    assert r.flops_per_step / j.flops_per_step == pytest.approx(ratio,
                                                                abs=5e-3)


def test_mesh_bench():
    """mnist under MeshTrainer on a dp=2 mesh: two CPU ranks of
    parallel/launch.py running the CLI; rank 0 prints the result."""
    from paddle_tpu_torch.parallel.launch import launch
    env = {"PYTHONPATH": os.pathsep.join(
        [REPO_ROOT, os.environ.get("PYTHONPATH", "")])}
    procs = launch(2, [sys.executable, "-m", "paddle_tpu_torch.benchmark",
                       "--model", "mnist", "--batch_size", "16",
                       "--min_time", "0.05", "--dp", "2", "--json",
                       "--device", "cpu"], device="cpu", env=env,
                   timeout=240)
    lines = [json.loads(ln) for ln in procs[0].stdout.splitlines()
             if ln.startswith("{")]
    assert len(lines) == 1 and lines[0]["model"] == "mnist"
    assert lines[0]["value"] > 0 and lines[0]["batch_size"] == 16
    assert not any(ln.startswith("{") for ln in
                   procs[1].stdout.splitlines())


def test_compiled_flops_positive():
    a = torch.ones((64, 64))
    flops = pbench.compiled_flops(lambda x, y: x @ y, a, a)
    assert flops == 2 * 64 ** 3
    ja = jnp.ones((64, 64))
    jflops = jbench.compiled_flops(jax.jit(lambda x, y: x @ y), ja, ja)
    assert flops == pytest.approx(jflops, rel=1e-2)
    # a call that raises counts nothing, as JAX's lowering failure
    assert pbench.compiled_flops(lambda: 1 / 0) is None


def _dense_mlp_step(opt: str):
    """One MLP (1024 -> 512 -> 512 -> 10, batch 64) train step in each
    package from the same numpy weights: (port count, JAX count,
    analytic matmul count, parameter count)."""
    from paddle_tpu.core.executor import Trainer as JTrainer
    from paddle_tpu.core.executor import supervised_loss as jsup
    from paddle_tpu.models import vision as JV
    from paddle_tpu.ops import functional as JF
    from paddle_tpu.optim import optimizer as JO
    from paddle_tpu_torch.core import Trainer, supervised_loss
    from paddle_tpu_torch.models import MLP, load_jax_params
    from paddle_tpu_torch.ops import functional as F
    from paddle_tpu_torch.optim import SGD, Adam
    widths, bs = [1024, 512, 512, 10], 64
    rs = np.random.RandomState(0)
    x = rs.randn(bs, widths[0]).astype(np.float32)
    y = rs.randint(0, 10, bs).astype(np.int64)

    jm = JV.MLP(hidden=tuple(widths[1:-1]), num_classes=widths[-1])
    jopt = JO.SGD(0.1) if opt == "sgd" else JO.Adam(1e-3)
    jt = JTrainer(jm, jopt, jsup(lambda lg, t: JF.softmax_with_cross_entropy(
        lg.astype(jnp.float32), t)))
    ts = jt.init_state(jnp.zeros((bs, widths[0])))
    ts, _ = jt.train_step(ts, (x, y), rng=jax.random.key(0))
    jflops = jbench.compiled_flops(jt._train_step, ts, (x, y),
                                   jax.random.key(0))

    m = MLP(hidden=tuple(widths[1:-1]), num_classes=widths[-1],
            in_shape=(1, 1, widths[0]), device=CPU)
    load_jax_params(m, jax.tree_util.tree_map(np.asarray, ts.variables))
    popt = (SGD(m.parameters(), 0.1) if opt == "sgd"
            else Adam(m.parameters(), 1e-3))
    tr = Trainer(m, popt, supervised_loss(
        lambda lg, t: F.softmax_with_cross_entropy(lg.float(), t)))
    flops = pbench.compiled_flops(tr.train_step,
                                  (torch.from_numpy(x), torch.from_numpy(y)))
    pairs = list(zip(widths, widths[1:]))
    # fwd 2, weight grads 2, input grads 2 but the first layer's
    analytic = sum(6 * bs * a * b for a, b in pairs) \
        - 2 * bs * widths[0] * widths[1]
    params = sum(a * b + b for a, b in pairs)
    return flops, jflops, analytic, params


def test_compiled_flops_pins_a_dense_mlp_step_to_jax():
    """The port's count of an SGD step is its matmuls exactly and within
    1% of JAX's; under Adam JAX also counts the update's elementwise
    work, 13.5 FLOPs a parameter on this XLA."""
    flops, jflops, analytic, _ = _dense_mlp_step("sgd")
    assert flops == analytic
    assert flops == pytest.approx(jflops, rel=1e-2)
    flops, jflops, analytic, params = _dense_mlp_step("adam")
    assert flops == analytic
    assert (jflops - flops) / params == pytest.approx(13.5, abs=0.1)


def test_peak_flops_lookup(monkeypatch):
    # CPU -> unknown, as JAX's on its CPU devices
    assert pbench.device_peak_flops() is None
    assert jbench.device_peak_flops() is None
    # an H100 hits the table: the bf16 rate, float32 outside the tensor
    # cores; a CPU device stays unknown
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    assert pbench.device_peak_flops() == 989.4e12
    assert pharness.PEAK_FLOPS_BF16["NVIDIA H100 80GB HBM3"] == 989.4e12
    assert pbench.device_peak_flops(32) == 66.9e12
    assert pbench.device_peak_flops(device=CPU) is None


def test_run_infer_resnet_smoke():
    """Inference mode (reference IntelOptimizedPaddle.md infer table
    surface) at a 32x32 image: the eval forward, vs_baseline from the
    published bs=1 number, and the forward's FLOPs above JAX's count of
    the same forward (what JAX's run_infer reports) by the padding taps
    of its SAME convolutions."""
    from paddle_tpu.models import vision as JV
    r = pmodels.run_infer("resnet50", batch_size=1, img=32, min_time=0.1,
                          device=CPU)
    assert r.value > 0
    assert r.unit == "imgs/s"
    assert r.vs_baseline is not None      # published bs=1 number exists
    assert r.model == "resnet50_infer"
    assert r.steps % 2 == 0               # K = 2 forwards a step on a CPU
    jm = JV.resnet50(1000)
    x = jnp.asarray(np.random.RandomState(0).randn(1, 32, 32, 3),
                    jnp.float32)
    variables = jm.init(jax.random.key(0), x)
    jflops = jbench.compiled_flops(
        jax.jit(lambda v, a: jm.apply(v, a, training=False)), variables, x)
    assert r.flops_per_step / jflops == pytest.approx(1.2198, abs=5e-3)


def test_conv_padding_taps_explain_the_infer_gap():
    """What the infer gap is: a 3x3 SAME convolution counts every tap in
    the port and only in-image taps in XLA."""
    for hw, xla in ((1, 8192.0), (4, 819200.0)):
        x = torch.ones((1, hw, hw, 64))
        w = torch.ones((64, 64, 3, 3))
        f = pbench.compiled_flops(lambda a: torch.nn.functional.conv2d(
            a.permute(0, 3, 1, 2), w, padding=1), x)
        assert f == 2 * hw * hw * 9 * 64 * 64
        jx, jw = jnp.ones((1, hw, hw, 64)), jnp.ones((3, 3, 64, 64))
        jf = jbench.compiled_flops(jax.jit(
            lambda a, b: jax.lax.conv_general_dilated(
                a, b, (1, 1), "SAME",
                dimension_numbers=("NHWC", "HWIO", "NHWC"))), jx, jw)
        assert jf == xla < f


@pytest.mark.parametrize("name", ["causal_lm", "causal_lm_int8kv"])
def test_run_infer_causal_lm(name):
    """The port's served-LM inference bench at a tiny width: generated
    tokens a second through a ServeEngine, fp KV pools or the in-device
    int8 tier, and its analytic FLOPs."""
    widths = dict(vocab=61, model_dim=32, num_heads=4, num_layers=2,
                  ffn_dim=64, max_len=16, prompt=6, new=3)
    r = pmodels.run_infer(name, batch_size=2, min_time=0.02, device=CPU,
                          **widths)
    assert r.model == f"{name}_infer" and r.unit == "tokens/s"
    assert r.value > 0 and r.batch_size == 2 and r.steps >= 40
    assert r.value == pytest.approx(2 * 3 / (r.ms_per_step / 1e3))
    assert r.flops_per_step == pmodels.lm_infer_flops(2, 6, 3, 32, 2, 64, 61)


def test_bert_bench_and_scaling():
    """BERT MLM spec (BASELINE BERT row) runs, and the scaling sweep
    reports per-rank efficiency with the shared-core normalization —
    the same rows and summary keys as JAX's sweep over its CPU mesh."""
    from paddle_tpu.benchmark.scaling import run_scaling as jscaling
    from paddle_tpu.benchmark.scaling import scaling_summary as jsummary
    from paddle_tpu_torch.benchmark.scaling import (run_scaling,
                                                    scaling_summary)
    r = pbench.run_model("bert_tiny", batch_size=4, min_time=0.05,
                         device=CPU)
    assert r.unit == "tokens/s" and r.value > 0
    rows = run_scaling("bert_tiny", sizes=(1, 2), per_chip_batch=4,
                       min_time=0.05, device=CPU, timeout=240)
    jrows = jscaling("bert_tiny", sizes=(1, 2), per_chip_batch=4,
                     min_time=0.01)
    assert [set(x) for x in rows] == [set(x) for x in jrows]
    assert [x["dp"] for x in rows] == [1, 2] and rows[0]["efficiency"] == 1
    assert all(x["unit"] == "tokens/s" and x["device"] == "cpu"
               for x in rows)
    s = scaling_summary(rows, prefix="bert_")
    assert set(s) == set(jsummary(jrows, prefix="bert_"))
    assert "bert_dp2_scaling_eff" in s
    assert s["scaling_platform"] == "cpu"
    assert "bert_dp2_vs_shared_core_ideal" in s
    # past the ranks there are: a skipped row, as JAX's past its devices
    big = 1 << 20
    assert run_scaling("bert_tiny", sizes=(big,), device=CPU) == \
        [{"dp": big, "skipped": f"only {os.cpu_count()} devices"}]


def test_fused_ce_chunks_counted_each():
    """The port's counter sees every vocab chunk of linear_cross_entropy
    (8*N*D*chunk each; JAX's XLA counts the scan body once), so the
    correction takes counted_chunks = the chunk count, and both
    packages land on the unfused head's 6*N*D*V."""
    N, D, c = 64, 32, 128
    rs = np.random.RandomState(0)
    h = rs.randn(N, D).astype(np.float32)

    def flops_for(vocab):
        tgt = rs.randint(0, vocab, (N,))
        w = rs.randn(D, vocab).astype(np.float32)
        th = torch.from_numpy(h).requires_grad_(True)
        tw = torch.from_numpy(w).requires_grad_(True)

        def step():
            loss = pfused.linear_cross_entropy(
                th, tw, torch.from_numpy(tgt), None, chunk=c).sum()
            loss.backward()

        jf = jax.jit(jax.grad(
            lambda a, b: jnp.sum(jfused.linear_cross_entropy(
                a, b, jnp.asarray(tgt, jnp.int32), None, chunk=c)),
            argnums=(0, 1)))
        return (pbench.compiled_flops(step),
                jbench.compiled_flops(jf, jnp.asarray(h), jnp.asarray(w)))

    body = 8 * N * D * c
    for trips in (2, 4):
        vocab = trips * c
        got, jgot = flops_for(vocab)
        assert got == trips * body
        model = 6.0 * N * D * vocab
        assert got + pfused.mfu_flops_correction(
            N, D, vocab, c, counted_chunks=trips) == model
        # JAX: the body once, plus its elementwise softmax work
        fixed = jgot + jfused.mfu_flops_correction(N, D, vocab, c)
        assert fixed == pytest.approx(model, rel=0.03)


@pytest.mark.parametrize("n,d,v,chunk", [
    (4096, 512, 32000, 8192), (16384, 512, 32000, 8192),
    (64, 32, 100, 8192), (300, 96, 1000, 256), (8, 16, 257, 128)])
def test_mfu_flops_correction_matches_jax(n, d, v, chunk):
    assert pfused.mfu_flops_correction(n, d, v, chunk) == \
        jfused.mfu_flops_correction(n, d, v, chunk)
    assert pfused.effective_chunk(v, chunk) == jfused.effective_chunk(
        v, chunk)


def test_chain_k_threads_the_carry_as_jax():
    """K chained calls: the carry folds every output (x 1e-30) into the
    next call, and the result equals JAX's chain_k on the same inputs."""
    calls = []
    x = np.arange(6, dtype=np.float32).reshape(2, 3) + 1.0

    def fn(c, a):
        calls.append(1)
        return a * 2.0 + c, a.sum() + c

    got = pharness.chain_k(fn, 3)(torch.ones(()), torch.from_numpy(x))
    want = jharness.chain_k(lambda c, a: (a * 2.0 + c, a.sum() + c), 3)(
        jnp.ones(()), jnp.asarray(x))
    assert len(calls) == 3
    assert float(got) == pytest.approx(float(want), rel=1e-6)


def test_retry_transient_prints_the_first_failure(capsys):
    tries = []

    def flaky():
        tries.append(1)
        if len(tries) == 1:
            raise OSError("response body closed")
        return 7

    assert pharness.retry_transient(flaky) == 7
    assert "attempt 1/2 failed: OSError" in capsys.readouterr().err
    with pytest.raises(ValueError):
        pharness.retry_transient(lambda: int("x"))


def test_cli_prints_what_jax_prints(tmp_path):
    """`python -m paddle_tpu_torch.benchmark` prints JAX's table line and
    JSON keys, and its --resume_file skips finished models."""
    from paddle_tpu.benchmark.__main__ import main as jmain
    from paddle_tpu_torch.benchmark.__main__ import main
    args = ["--model", "mlp", "--batch_size", "8", "--min_time", "0.01"]

    def run(fn, extra):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert fn(args + extra) == 0
        return buf.getvalue().splitlines()

    line = r"\s+mlp\s+[\d.]+ imgs/s\s+[\d.]+ ms/step\s+\S+ TF/s  MFU\s+\S+" \
           r"\s+vs_ref\s+\S+\s+\[cpu\]"
    got, want = run(main, ["--device", "cpu"]), run(jmain, [])
    assert len(got) == len(want) == 1
    assert re.fullmatch(line, got[0]) and re.fullmatch(line, want[0])
    got = json.loads(run(main, ["--device", "cpu", "--json"])[0])
    assert set(got) == set(json.loads(run(jmain, ["--json"])[0]))
    done = tmp_path / "done.txt"
    run(main, ["--device", "cpu", "--resume_file", str(done)])
    assert done.read_text() == "mlp\n"
    assert run(main, ["--device", "cpu", "--resume_file", str(done)]) == \
        [f"           mlp  (done in {done}; skipped)"]
