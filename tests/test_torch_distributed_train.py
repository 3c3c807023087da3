"""The port's multi-process training runtime: mirrors of the 9 tests of
tests/test_distributed.py over the port's launcher
(paddle_tpu_torch/parallel/launch.py) and its worker modules
(paddle_tpu_torch/testing/dist_worker.py, elastic_worker.py,
dist_worker_deepfm.py), every rank a process on the CPU over gloo:

- the 2-rank cluster: the world's collective and a dp MeshTrainer whose
  ranks see the same global losses, equal to a 1-rank run's;
- straggler detection over the workers' live /metrics bodies;
- the launcher's failure report and free_port;
- a rank killed mid-run: the survivor is terminated with a peer-failure
  report, and the restart resumes from the last sharded checkpoint and
  reproduces the uninterrupted loss curve;
- SIGTERM preemption: an emergency checkpoint, the preemption exit code,
  and an exact resume;
- checkpoints written by the async worker thread across ranks;
- DeepFM with ShardedEmbedding over 2 ranks against the 1-rank run
  within 1e-5.

The JAX workers run JAX processes; these run the port's, so the
references are the port's own 1-rank runs and uninterrupted runs, as
the JAX tests' are JAX's.
"""

import json
import os
import sys

import numpy as np
import pytest

from paddle_tpu_torch.parallel.launch import free_port, launch
from paddle_tpu_torch.testing import one_torch_thread

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _env(extra=None):
    env = {"PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                           "")}
    env.update(extra or {})
    return env


def _module(name):
    return [sys.executable, "-m", f"paddle_tpu_torch.testing.{name}"]


def _last_json(stdout):
    return json.loads([ln for ln in stdout.splitlines()
                       if ln.startswith("{") and '"evt"' not in ln][-1])


def _run(nproc, worker, extra=None, **kw):
    return [_last_json(r.stdout) for r in
            launch(nproc, _module(worker), device="cpu", env=_env(extra),
                   timeout=kw.pop("timeout", 240), **kw)]


@pytest.fixture(scope="module")
def cluster():
    return _run(2, "dist_worker")


def test_two_process_cluster(cluster):
    assert {o["proc"] for o in cluster} == {0, 1}
    for o in cluster:
        assert o["nprocs"] == 2
        assert o["psum"] == pytest.approx(3.0)      # (0 + 1) + (1 + 1)
    np.testing.assert_allclose(cluster[0]["losses"], cluster[1]["losses"],
                               rtol=1e-6)
    assert cluster[0]["losses"][-1] < cluster[0]["losses"][0]


def test_matches_single_process(cluster):
    """The 2-rank dp run == a 1-rank run of the same global batch."""
    solo = _run(1, "dist_worker")[0]
    assert solo["nprocs"] == 1
    np.testing.assert_allclose(cluster[0]["losses"], solo["losses"],
                               atol=1e-5)


def test_straggler_detection_two_workers():
    """A rank whose input pipeline stalls is flagged by its input wait,
    read from the workers' own /metrics scrapes. Blame cannot come from
    step time: the steps run in lock step, so the healthy rank's step
    absorbs the stall in the gradient all-reduce, and on a loaded host
    either rank's step wall can be the longer; the dispersion gauge
    reports their ratio."""
    from paddle_tpu_torch.obs.metrics import MetricsRegistry
    from paddle_tpu_torch.obs.straggler import StragglerDetector
    outs = _run(2, "dist_worker", {"PTPU_WORKER_METRICS": "1",
                                   "PTPU_WORKER_SLOW_PROC": "1",
                                   "PTPU_WORKER_SLOW_MS": "40"})
    expositions = {}
    for o in outs:
        assert "ptpu_train_step_ms" in o["exposition"]
        assert "ptpu_train_input_wait_ms" in o["exposition"]
        expositions[f"w{o['proc']}"] = o["exposition"]
    reg = MetricsRegistry()
    det = StragglerDetector(registry=reg)
    verdict = det.update(expositions)
    assert verdict["w1"]["straggler"] is True
    assert verdict["w0"]["straggler"] is False
    assert verdict["w1"]["input_wait_ms"] > 10 * verdict["w0"][
        "input_wait_ms"]
    g = reg.get("ptpu_train_straggler")
    assert g.labels(worker="w1").value == 1.0
    assert g.labels(worker="w0").value == 0.0
    steps = [verdict[w]["step_ms"] for w in ("w0", "w1")]
    assert reg.get("ptpu_train_step_dispersion").value == pytest.approx(
        max(steps) / min(steps))
    assert "ptpu_train_step_ms_count" in det.fleet_exposition(expositions)


def test_launcher_reports_failures():
    with pytest.raises(RuntimeError, match="boom|rc="):
        launch(2, [sys.executable, "-c", "raise SystemExit('boom')"],
               device="cpu", env=_env(), timeout=60)
    # a survivor that would hang (in a collective whose peer died) is
    # terminated after the grace, and the report names it
    script = ("import os, sys, time\n"
              "if os.environ['PTPU_PROCESS_ID'] == '1': sys.exit(17)\n"
              "time.sleep(60)\n")
    with pytest.raises(RuntimeError) as e:
        launch(2, [sys.executable, "-c", script], device="cpu", env=_env(),
               timeout=60, peer_failure_grace=1.0)
    assert "peer failure: proc 1 died (rc=17)" in str(e.value)
    assert "survivors [0] terminated" in str(e.value)


def test_free_port():
    p1, p2 = free_port(), free_port()
    assert 1024 <= p1 <= 65535 and 1024 <= p2 <= 65535


@pytest.fixture(scope="module")
def clean_curve(tmp_path_factory):
    """The uninterrupted 8-step curve. Batches are keyed by the global
    step, so it is every shorter run's reference too."""
    return _run(2, "elastic_worker", {
        "PTPU_CKPT_DIR": str(tmp_path_factory.mktemp("clean")),
        "PTPU_TOTAL_STEPS": "8"})[0]["losses"]


def test_fault_injection_and_elastic_restart(tmp_path, clean_curve):
    """Kill rank 1 at step 3: the launch fails fast with a clear
    peer-death report (gloo's connection to the dead peer resets, so the
    survivor fails in its next collective, or the watchdog terminates
    it); the restart resumes each rank's pieces from the last committed
    checkpoint and reproduces the uninterrupted curve."""
    ckpt = str(tmp_path / "elastic")
    total = {"PTPU_CKPT_DIR": ckpt, "PTPU_TOTAL_STEPS": "6"}
    with pytest.raises(RuntimeError) as e:
        launch(2, _module("elastic_worker"), device="cpu",
               env=_env({**total, "PTPU_FAULT_PROC": "1",
                         "PTPU_FAULT_STEP": "3"}),
               timeout=240, peer_failure_grace=3.0)
    msg = str(e.value)
    assert "peer failure: proc 1 died (rc=17)" in msg
    assert ("survivors [0] terminated" in msg
            or "--- proc 0 rc=1\n" in msg)

    outs = _run(2, "elastic_worker", total)
    assert all(o["start_step"] == 3 for o in outs)
    assert outs[0]["steps"] == [3, 4, 5]
    np.testing.assert_allclose(outs[0]["losses"], clean_curve[3:6],
                               atol=1e-5)


def test_sigterm_preemption_resumes_exactly(tmp_path, clean_curve):
    """SIGTERM at step 4 on both ranks: the supervisor writes an
    emergency sharded checkpoint at the step boundary and exits with the
    preemption code; the restart resumes at step 4 and reproduces the
    uninterrupted curve (save_every=3 makes the emergency save the one
    that counts)."""
    from paddle_tpu_torch.io.checkpoint import (checkpoint_step,
                                                latest_checkpoint)
    from paddle_tpu_torch.resilience.errors import PREEMPT_EXIT_CODE
    ckpt = str(tmp_path / "preempt")
    base = {"PTPU_CKPT_DIR": ckpt, "PTPU_TOTAL_STEPS": "8",
            "PTPU_SAVE_EVERY": "3"}
    with pytest.raises(RuntimeError) as e:
        launch(2, _module("elastic_worker"), device="cpu",
               env=_env({**base, "PTPU_CHAOS_SIGTERM_STEP": "4"}),
               timeout=240, peer_failure_grace=5.0)
    msg = str(e.value)
    assert f"rc={PREEMPT_EXIT_CODE}" in msg
    assert '"evt": "preempt"' in msg
    assert checkpoint_step(latest_checkpoint(ckpt)) == 4

    outs = _run(2, "elastic_worker", base)
    assert all(o["start_step"] == 4 for o in outs)
    assert outs[0]["steps"] == [4, 5, 6, 7]
    np.testing.assert_allclose(outs[0]["losses"], clean_curve[4:],
                               atol=1e-5)


def test_two_process_async_checkpoint(tmp_path, clean_curve):
    """Async checkpoints across ranks: each rank's worker thread meets
    its peers at the store barriers while training goes on; the last
    checkpoint resumes with nothing left to do, and the curve equals the
    synchronous saves' (the clean run's)."""
    ckpt = str(tmp_path / "async")
    env = {"PTPU_CKPT_DIR": ckpt, "PTPU_TOTAL_STEPS": "4",
           "PTPU_ASYNC_CKPT": "1"}
    outs = _run(2, "elastic_worker", env)
    assert outs[0]["steps"] == [0, 1, 2, 3]
    again = _run(2, "elastic_worker", env)
    assert all(o["start_step"] == 4 and o["steps"] == [] for o in again)
    np.testing.assert_allclose(outs[0]["losses"], clean_curve[:4],
                               atol=1e-6)


def test_two_process_sharded_embedding_deepfm():
    """DeepFM + ShardedEmbedding over 2 ranks (the table's rows split
    between them) matches the 1-rank run within 1e-5."""
    outs = _run(2, "dist_worker_deepfm")
    assert {o["proc"] for o in outs} == {0, 1}
    for o in outs:
        assert o["local_rows"] == o["total_rows"] // 2
    np.testing.assert_allclose(outs[0]["losses"], outs[1]["losses"],
                               rtol=1e-6)
    assert outs[0]["losses"][-1] < outs[0]["losses"][0]
    solo = _run(1, "dist_worker_deepfm")[0]
    assert solo["local_rows"] == solo["total_rows"]
    np.testing.assert_allclose(outs[0]["losses"], solo["losses"],
                               atol=1e-5)
