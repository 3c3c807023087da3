"""The port's C-ABI serving shim (paddle_tpu_torch/serving) against the
JAX package's predictor: tests/test_serving.py on the port.

The model is an MLP whose weights come from JAX's `init`: the JAX side
serves its own export of them (`InferencePredictor`, StableHLO), the
port's shim serves the port's export of the same weights (`model.pt2`)
through the C ABI, in process (ctypes) and from the two C++ programs.
Everything runs with device "cpu" — the one argument the port's ABI adds
to JAX's. JAX's wall-clock clone-throughput test is not mirrored: its
bar (4 clones reach 0.5x the serial calls a second) is held on the card
by chip_smoke.py's `cabi` phase.
"""

import os
import threading

import numpy as np
import pytest
import torch

from paddle_tpu.io.inference import InferencePredictor as JaxPredictor
from paddle_tpu_torch import serving
from paddle_tpu_torch.io import InferencePredictor, save_inference_model
from paddle_tpu_torch.models import MLP, load_jax_params
from paddle_tpu_torch.serving import CPredictor
from paddle_tpu_torch.utils import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the demo's deterministic ramp input (demo.cc)
RAMP = (np.arange(24) % 100 / 100.0).astype(np.float32).reshape(4, 6)


SYS_PATH = serving.program_sys_path()


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    # the C++ programs run beside the other test workers: one intra-op
    # thread each
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """(the port's export, JAX's export) of one MLP's JAX weights."""
    import jax
    from paddle_tpu.models import MLP as JaxMLP
    from paddle_tpu.testing import export_servable

    root = tmp_path_factory.mktemp("serving")
    jmodel = JaxMLP(hidden=(8,), num_classes=3)
    x = np.zeros((4, 6), np.float32)
    variables = jmodel.init(0, x)
    jax_dir = export_servable(str(root / "jax"), jmodel, variables, [x],
                              input_names=["x"])
    model = MLP(hidden=(8,), num_classes=3, in_shape=(6, 1, 1),
                device="cpu")
    load_jax_params(model, jax.device_get(variables))
    port_dir = save_inference_model(str(root / "port"), model, None,
                                    [torch.from_numpy(x)],
                                    input_names=["x"])
    return port_dir, jax_dir


def test_cpredictor_matches_python(dirs):
    port_dir, jax_dir = dirs
    x = np.linspace(-1, 1, 24).astype(np.float32).reshape(4, 6)
    want = JaxPredictor(jax_dir).run([x])
    py = InferencePredictor(port_dir, device="cpu").run([x])
    cp = CPredictor(port_dir, sys_path=SYS_PATH, device="cpu")
    try:
        c_out = cp.run([x])
        assert len(c_out) == len(want) == len(py)
        for a, b, c in zip(c_out, want, py):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
            np.testing.assert_array_equal(a, c)
        # second run reuses the loaded program (ZeroCopyRun cadence)
        c_out2 = cp.run([x])
        np.testing.assert_array_equal(c_out2[0], c_out[0])
    finally:
        cp.close()


def test_cpredictor_bad_model_dir():
    with pytest.raises(RuntimeError, match="ptpu_create failed"):
        CPredictor("/nonexistent/model", sys_path=REPO, device="cpu")


def test_stablehlo_export_is_refused_by_name(dirs):
    _, jax_dir = dirs
    with pytest.raises(RuntimeError,
                       match="ptpu_create failed.*model.stablehlo"):
        CPredictor(jax_dir, sys_path=REPO, device="cpu")


def test_default_device_is_the_card(dirs):
    # no card here, and the ABI does not drop to the CPU on its own
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError,
                       match='ptpu_create failed.*device="cpu"'):
        CPredictor(dirs[0], sys_path=REPO)


def test_library_builds():
    lib = serving.build_library()
    assert os.path.exists(lib)
    assert os.path.dirname(lib) == str(native.BUILD_DIR)
    assert os.path.basename(lib).startswith("libptpu_serving-")


def test_a_failed_build_raises_with_gxx_output(tmp_path, monkeypatch):
    (tmp_path / "serving.cc").write_text("int main( { return 0; }\n")
    monkeypatch.setattr(serving, "_SRC_DIR", str(tmp_path))
    with pytest.raises(native.NativeBuildError, match="error"):
        serving.build_library()


def test_cpp_demo_binary(dirs):
    """Compile and run the standalone C++ consumer; its printed output sum
    must match the Python predictors on the same deterministic input."""
    port_dir, jax_dir = dirs
    proc = serving.run_demo(port_dir, "cpu", timeout=300)
    assert proc.returncode == 0, f"demo failed:\n{proc.stdout}\n{proc.stderr}"
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("output 0")]
    assert line, proc.stdout
    assert "shape=4x3" in line[0] and "dtype=0" in line[0]
    c_sum = float(line[0].split("sum=")[1])
    # summed in float64, as the demo sums
    py_sum = float(InferencePredictor(port_dir, device="cpu")
                   .run([RAMP])[0].astype(np.float64).sum())
    jax_sum = float(JaxPredictor(jax_dir).run([RAMP])[0]
                    .astype(np.float64).sum())
    assert abs(c_sum - py_sum) < 1e-4 * max(1.0, abs(py_sum))
    assert abs(c_sum - jax_sum) < 1e-4 * max(1.0, abs(jax_sum))


def test_cpp_train_demo(tmp_path):
    """Native C++ trainer demo (reference train/demo/demo_trainer.cc):
    the C++ binary owns the loop of a paddle_tpu_torch Trainer, the loss
    falls, and the checkpoint it asks for loads in either package."""
    ckpt = str(tmp_path / "cpp_ckpt")
    proc = serving.run_train_demo(ckpt, "cpu")
    assert proc.returncode == 0, \
        f"train demo failed:\n{proc.stdout}\n{proc.stderr}"
    assert "TRAIN DEMO OK" in proc.stdout
    from paddle_tpu.io.checkpoint import load_checkpoint as jax_load
    from paddle_tpu_torch.io.checkpoint import load_checkpoint
    tree, jtree = load_checkpoint(ckpt), jax_load(ckpt)
    assert "params" in tree and "opt" in tree
    assert set(tree) == set(jtree)
    w = tree["params"]["head"]["weight"]
    assert w.shape == (32, 4)
    np.testing.assert_array_equal(
        np.asarray(w), np.asarray(jtree["params"]["head"]["weight"]))


def test_cpredictor_clone_concurrent(dirs):
    """Reference threading contract (paddle_api.h: one predictor per
    thread via Clone): cloned handles serve concurrently with no output
    cross-talk; run() on a clone matches the single-threaded answer for
    that thread's input every time."""
    port_dir, _ = dirs
    base = CPredictor(port_dir, sys_path=SYS_PATH, device="cpu")
    n_threads, n_runs = 4, 15
    rs = np.random.RandomState(0)
    inputs = [rs.randn(4, 6).astype(np.float32) for _ in range(n_threads)]
    want = [base.run([x])[0] for x in inputs]   # single-thread reference

    clones = [base.clone() for _ in range(n_threads)]
    errors = []

    def worker(i):
        try:
            for _ in range(n_runs):
                out = clones[i].run([inputs[i]])[0]
                np.testing.assert_array_equal(out, want[i])
        except Exception as e:   # surfaced below; threads must not die
            errors.append((i, e))

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    # a hung worker must FAIL (and must not let cleanup free in-use handles)
    assert not any(t.is_alive() for t in threads), "worker thread hung"
    try:
        assert not errors, errors
    finally:
        for c in clones:
            c.close()
        base.close()


def test_clones_may_share_the_program(dirs):
    """Why clones may share one predictor: `run` launches its program
    under a lock, and the program module holds the very weights `run`
    calls it with, so even unserialized, `functional_call`'s swap-in on
    one thread and restore on another would exchange equal tensors."""
    pred = InferencePredictor(dirs[0], device="cpu")
    assert pred._lock.acquire(blocking=False)
    pred._lock.release()
    own = dict(pred.program.named_parameters())
    own.update(pred.program.named_buffers())
    assert pred._state and set(pred._state) <= set(own)
    for name, t in pred._state.items():
        assert torch.equal(own[name], t), name


def test_bf16_input_through_the_c_abi(tmp_path, dirs):
    """A bfloat16 input crosses the ABI as its bits (no numpy bfloat16
    needed) and gives what the Python predictor gives on the same
    tensor; against the float32 model on the rounded input it differs by
    bf16 rounding only."""
    port_dir, _ = dirs
    f32 = InferencePredictor(port_dir, device="cpu")
    model = MLP(hidden=(8,), num_classes=3, in_shape=(6, 1, 1),
                dtype=torch.bfloat16, device="cpu")
    load_jax_params(model, {"params": {
        k: {n: np.asarray(v) for n, v in leaves.items()}
        for k, leaves in f32.variables["params"].items()}})
    bf16_dir = save_inference_model(
        str(tmp_path / "bf16"), model, None,
        [torch.zeros(4, 6, dtype=torch.bfloat16)], input_names=["x"])
    x = torch.linspace(-1, 1, 24).reshape(4, 6).to(torch.bfloat16)
    py = InferencePredictor(bf16_dir, device="cpu").run([x])[0]
    cp = CPredictor(bf16_dir, sys_path=SYS_PATH, device="cpu")
    try:
        got = cp.run([x])[0]
    finally:
        cp.close()
    assert got.dtype == np.float32                # bf16 comes back as f32
    np.testing.assert_array_equal(got, py)
    ref = f32.run([x.float().numpy()])[0]
    np.testing.assert_allclose(got, ref, rtol=3e-2, atol=3e-2)
