"""The port's profiler (paddle_tpu_torch/profiler) against the JAX
package's: tests/test_profiler.py's eleven tests on the port, each
holding the port's output to JAX's where both produce one — the same
host events give the same table rows and text, the same profiles merge
to the same trace, the same device events give the same op table — and
the host spans of the port's Trainer, Executor and MeshTrainer in
`merged_chrome_trace`, structured as JAX's.

The device-trace tests parse a synthetic trace in torch.profiler's
shape (kernels linked by `External id` to the `cpu_op` that launched
them, with that op's FLOPs) where JAX's parse one with `hlo_category`;
the real capture runs on the CPU here (no kernels) and on the card in
chip_smoke.py's `profile` phase.
"""

import glob
import gzip
import importlib
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu.profiler as jprof
import paddle_tpu_torch.profiler as prof

# the modules (each package's `profiler` and `device_trace` attributes
# are the context managers of those names)
pmod = importlib.import_module("paddle_tpu_torch.profiler.profiler")
jmod = importlib.import_module("paddle_tpu.profiler.profiler")
dt = importlib.import_module("paddle_tpu_torch.profiler.device_trace")
jdt = importlib.import_module("paddle_tpu.profiler.device_trace")

pytestmark = pytest.mark.obs


@pytest.fixture(autouse=True)
def _stopped():
    # each test starts and ends with both profilers off and empty
    yield
    for m in (pmod, jmod):
        if m._enabled:
            m.stop_profiler(print_table=False)
        m.reset_profiler()


def test_record_event_table():
    prof.start_profiler()
    for _ in range(3):
        with prof.RecordEvent("work"):
            np.dot(np.ones((64, 64)), np.ones((64, 64)))
    with prof.RecordEvent("other"):
        pass
    rows = prof.stop_profiler(sorted_key="total", print_table=False)
    by_name = {r["name"]: r for r in rows}
    assert by_name["work"]["calls"] == 3
    assert by_name["other"]["calls"] == 1
    assert rows[0]["name"] == "work"  # sorted by total time
    assert abs(sum(r["ratio"] for r in rows) - 1.0) < 1e-6


@pytest.mark.parametrize("key", ["total", "calls", "max", "min", "ave"])
def test_tables_equal_jax_on_the_same_events(key):
    events = [{"name": n, "ts": 1000.0 * i, "dur": d, "tid": 7}
              for i, (n, d) in enumerate([("a", 5.0), ("b", 40.0),
                                          ("a", 7.5), ("c", 1.0),
                                          ("b", 2.0), ("a", 100.25)])]
    pmod._events[:] = [dict(e) for e in events]
    jmod._events[:] = [dict(e) for e in events]
    rows, jrows = prof.profile_table(key), jprof.profile_table(key)
    assert rows == jrows
    assert pmod.format_table(rows, key) == jmod.format_table(jrows, key)
    assert (prof.events_to_chrome_trace(pid=3)
            == jprof.events_to_chrome_trace(pid=3))


def test_disabled_records_nothing():
    prof.reset_profiler()
    with prof.RecordEvent("ignored"):
        pass
    assert prof.get_events() == []


def test_profiler_context_and_chrome_trace(tmp_path):
    path = str(tmp_path / "prof.json")
    with prof.profiler(profile_path=path):
        with prof.RecordEvent("span"):
            pass
    trace = json.load(open(path))
    names = [e["name"] for e in trace["traceEvents"] if e["ph"] == "X"]
    assert "span" in names


def test_record_function_decorator():
    @prof.record_function("decorated")
    def f(x):
        return x + 1

    prof.start_profiler()
    assert f(1) == 2
    rows = prof.stop_profiler(print_table=False)
    assert any(r["name"] == "decorated" for r in rows)


def _port_trainer():
    from paddle_tpu_torch.core.executor import Trainer, supervised_loss
    from paddle_tpu_torch.models import MLP
    from paddle_tpu_torch.ops import functional as F
    from paddle_tpu_torch.optim.optimizer import SGD

    model = MLP(hidden=(8,), num_classes=4, in_shape=(8, 1, 1),
                device="cpu")
    trainer = Trainer(model, SGD(model.parameters(), 0.1), supervised_loss(
        lambda o, y: F.softmax_with_cross_entropy(o, y)))
    return trainer, (torch.ones(4, 8), torch.zeros(4, dtype=torch.int64))


def test_train_step_instrumented():
    trainer, batch = _port_trainer()
    prof.start_profiler()
    trainer.train_step(batch)
    rows = prof.stop_profiler(print_table=False)
    assert any(r["name"] == "Trainer.train_step" for r in rows)


def _structure(trace):
    """A merged trace without its times: each process row, each thread
    row, and each span's (pid, name, cat, ph)."""
    evs = trace["traceEvents"]
    return (sorted((e["pid"], e["args"]["name"]) for e in evs
                   if e["ph"] == "M" and e["name"] == "process_name"),
            sorted((e["pid"], e["args"]["name"]) for e in evs
                   if e["ph"] == "M" and e["name"] == "thread_name"),
            sorted((e["pid"], e["name"], e.get("cat"), e["ph"])
                   for e in evs if e["ph"] != "M"))


def _lifecycle(tracer, rid):
    tracer.on_enqueue(rid)
    tracer.on_admit(rid)
    tracer.on_first_token(rid)
    tracer.on_finish(rid, reason="length")


def test_merged_trace_carries_the_train_step_span_as_jaxs():
    import jax.numpy as jnp
    from paddle_tpu.core.executor import Trainer as JaxTrainer
    from paddle_tpu.core.executor import supervised_loss as jax_loss
    from paddle_tpu.models import MLP as JaxMLP
    from paddle_tpu.obs import RequestTracer as JaxTracer
    from paddle_tpu.obs import merged_chrome_trace as jax_merged
    from paddle_tpu.ops import functional as JF
    from paddle_tpu.optim.optimizer import SGD as JaxSGD
    from paddle_tpu_torch.obs import RequestTracer, merged_chrome_trace

    trainer, batch = _port_trainer()
    prof.start_profiler()
    trainer.train_step(batch)
    tracer = RequestTracer()
    _lifecycle(tracer, 3)
    trace = merged_chrome_trace(tracer)
    prof.stop_profiler(print_table=False)

    jt = JaxTrainer(JaxMLP(hidden=(8,), num_classes=4), JaxSGD(0.1),
                    jax_loss(lambda o, y: JF.softmax_with_cross_entropy(o, y)))
    x = jnp.ones((4, 8))
    ts = jt.init_state(x)
    jprof.start_profiler()
    jt.train_step(ts, (x, jnp.zeros((4,), jnp.int32)))
    jtracer = JaxTracer()
    _lifecycle(jtracer, 3)
    jtrace = jax_merged(jtracer)
    jprof.stop_profiler(print_table=False)

    host = [e for e in trace["traceEvents"] if e["ph"] == "X"
            and e["name"] == "Trainer.train_step"]
    assert len(host) == 1 and host[0]["cat"] == "host"
    assert host[0]["pid"] == 0 and host[0]["dur"] > 0
    assert _structure(trace) == _structure(jtrace)
    assert ("engine host" in
            [e["args"]["name"] for e in trace["traceEvents"]
             if e["name"] == "process_name" and e["pid"] == 0])


def test_executor_and_mesh_trainer_steps_record_spans():
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.parallel import MeshTrainer, make_mesh

    exe = Executor(place="cpu")
    trainer, batch = _port_trainer()
    mesh_trainer = MeshTrainer(trainer.module, trainer.optimizer,
                               trainer.loss_fn,
                               mesh=make_mesh(devices=["cpu"]))
    prof.start_profiler()
    exe.run(lambda x: {"y": x * 2}, feed={"x": np.ones(3, np.float32)})
    mesh_trainer.train_step(batch)
    rows = prof.stop_profiler(print_table=False)
    assert {r["name"]: r["calls"] for r in rows} == {
        "Executor.run": 1, "MeshTrainer.train_step": 1}


def _write_profiles(p, tmp_path, tag):
    paths = []
    for name in ("a", "b"):
        path = str(tmp_path / f"{tag}_{name}.json")
        p.start_profiler()
        with p.RecordEvent(name):
            pass
        p.stop_profiler(profile_path=path, print_table=False)
        paths.append(path)
    return paths


def test_timeline_merge(tmp_path):
    p1, p2 = _write_profiles(prof, tmp_path, "t")
    out = str(tmp_path / "merged.json")
    trace = prof.merge_profiles({"trainer1": p1, "trainer2": p2}, out)
    pids = {e["pid"] for e in trace["traceEvents"]}
    assert pids == {0, 1}
    spans = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    assert {e["name"] for e in spans} == {"a", "b"}
    assert json.load(open(out)) == trace


def test_merge_equals_jaxs_on_the_same_profiles(tmp_path):
    p1, p2 = _write_profiles(prof, tmp_path, "port")
    paths = {"trainer1": p1, "trainer2": p2}
    assert prof.merge_profiles(paths) == jprof.merge_profiles(paths)
    # the command line too
    out, jout = str(tmp_path / "m.json"), str(tmp_path / "jm.json")
    arg = f"trainer1={p1},trainer2={p2}"
    prof.timeline.main(["--profile_path", arg, "--timeline_path", out])
    jprof.timeline.main(["--profile_path", arg, "--timeline_path", jout])
    assert json.load(open(out)) == json.load(open(jout))


def _trace_events(trace_dir):
    files = glob.glob(os.path.join(trace_dir, "*.trace.json.gz"))
    assert len(files) == 1, files
    with gzip.open(files[0], "rt") as f:
        return json.load(f)["traceEvents"]


def test_annotate_device_trace(tmp_path):
    # the region shows in the trace as a user annotation over its ops
    # (on the card also as a gpu_user_annotation over its kernels)
    trace_dir = str(tmp_path / "traces")
    prof.start_profiler(trace_dir=trace_dir)
    with prof.annotate("matmul_region"):
        out = torch.ones(16, 16) @ torch.ones(16, 16)
    rows = prof.stop_profiler(print_table=False)
    assert float(out.sum()) == 16 * 256
    assert [r["name"] for r in rows] == ["matmul_region"]
    evs = _trace_events(trace_dir)
    region = [e for e in evs if e.get("cat") == "user_annotation"
              and e["name"] == "matmul_region"]
    assert len(region) == 1
    inside = [e for e in evs if e.get("cat") == "cpu_op"
              and region[0]["ts"] <= e["ts"]
              <= region[0]["ts"] + region[0]["dur"]]
    assert "aten::mm" in {e["name"] for e in inside}


def test_device_trace_capture(tmp_path):
    trace_dir = str(tmp_path / "traces")
    prof.start_profiler(trace_dir=trace_dir)
    out = torch.ones(32, 32) @ torch.ones(32, 32)
    prof.stop_profiler(print_table=False)
    found = []
    for _, _, files in os.walk(trace_dir):
        found += files
    assert found, "torch.profiler produced no trace files"
    assert float(out[0, 0]) == 32
    # the mm carries its FLOPs (2 * 32^3), joined from the profiler
    mm = [e for e in _trace_events(trace_dir)
          if e.get("cat") == "cpu_op" and e["name"] == "aten::mm"]
    assert [e["args"]["flops"] for e in mm] == [2 * 32 ** 3]


# (host op, its flops, [(kernel, dur us), ...]) in launch order; the
# same table makes the torch.profiler-shaped trace and JAX's
OPS = [
    ("aten::mm", 2_000_000, [("sm90_gemm_bf16", 1000)]),
    ("paddle_tpu_torch::flash_fwd", 0, [("fwd_tc_kernel", 500)]),
    ("aten::mm", 2_000_000, [("sm90_gemm_bf16", 1000)]),
    ("aten::copy_", 0, [("Memcpy DtoD", 100)]),
]


class TestDeviceTrace:
    """Device-tier op tables (reference device_tracer.h + EnableProfiler
    table) over a synthetic trace in torch.profiler's shape; on the card
    the same parser consumes start_profiler's capture."""

    def _fake_trace(self, tmp_path):
        d = tmp_path / "run1"
        os.makedirs(d)
        events, ts = [], 0
        for ext, (op, flops, kernels) in enumerate(OPS, start=1):
            args = {"External id": ext}
            if flops:
                args["flops"] = flops
            events.append({"ph": "X", "cat": "cpu_op", "name": op,
                           "pid": 1, "tid": 1, "ts": ts, "dur": 5,
                           "args": args})
            for name, dur in kernels:
                cat = "gpu_memcpy" if name.startswith("Memcpy") else "kernel"
                events.append({"ph": "X", "cat": cat, "name": name,
                               "pid": 0, "tid": 7, "ts": ts, "dur": dur,
                               "args": {"External id": ext,
                                        "correlation": 100 + ext}})
                ts += dur
        events += [
            # spans kernels already counted: never device time
            {"ph": "X", "cat": "gpu_user_annotation", "name": "region",
             "pid": 0, "tid": 8, "ts": 0, "dur": ts,
             "args": {"External id": 99}},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "pid": 1, "tid": 1, "ts": 0, "dur": 3,
             "args": {"External id": 1, "correlation": 101}},
            {"ph": "M", "pid": 0, "name": "process_name",
             "args": {"name": "GPU 0"}},
        ]
        with gzip.open(d / "host.123.trace.json.gz", "wt") as f:
            json.dump({"traceEvents": events}, f)
        return str(tmp_path)

    def _jax_fake_trace(self, tmp_path):
        d = tmp_path / "jax" / "plugins" / "profile" / "run1"
        os.makedirs(d)
        events, ts = [], 0
        for op, flops, kernels in OPS:
            for name, dur in kernels:
                events.append({"ph": "X", "pid": 3, "tid": 3, "ts": ts,
                               "dur": dur, "name": name,
                               "args": {"hlo_category": op,
                                        "bytes_accessed": "0",
                                        "model_flops": str(flops)}})
                ts += dur
        with gzip.open(d / "host.trace.json.gz", "wt") as f:
            json.dump({"traceEvents": events}, f)
        return str(tmp_path / "jax")

    def test_op_table_by_category(self, tmp_path):
        rows = prof.op_table(self._fake_trace(tmp_path), steps=2)
        assert rows[0].name == "aten::mm"
        assert rows[0].total_ms == 1.0           # 2000us / 2 steps
        assert rows[0].count == 1
        assert rows[0].tflops > 0 and rows[0].flops == 2_000_000
        assert rows[0].gbps == 0                 # no bytes in the trace
        assert rows[1].name == "paddle_tpu_torch::flash_fwd"
        assert rows[2].name == "aten::copy_"     # the memcpy counts
        assert len(rows) == 3
        txt = prof.format_table(rows)
        assert "aten::mm" in txt and "total device time" in txt

    def test_op_table_by_op(self, tmp_path):
        rows = prof.op_table(self._fake_trace(tmp_path), by="op", steps=1)
        names = [r.name for r in rows]
        assert names == ["sm90_gemm_bf16", "fwd_tc_kernel", "Memcpy DtoD"]

    @pytest.mark.parametrize("by", ["category", "op"])
    @pytest.mark.parametrize("steps", [1, 2])
    def test_op_table_equals_jaxs_on_the_same_ops(self, tmp_path, by, steps):
        rows = dt.op_table(self._fake_trace(tmp_path / "port"), by=by,
                           steps=steps)
        jrows = jdt.op_table(self._jax_fake_trace(tmp_path), by=by,
                             steps=steps)
        assert [vars(r) for r in rows] == [vars(r) for r in jrows]
        assert dt.format_table(rows) == jdt.format_table(jrows)
        top = dt.op_table(self._fake_trace(tmp_path / "b"), by=by,
                          steps=steps, top=1)
        assert [vars(r) for r in top] == [vars(jrows[0])]

    def test_op_table_without_a_trace_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError, match="no trace.json.gz"):
            prof.op_table(str(tmp_path))

    def test_device_trace_contextmanager_on_cpu(self, tmp_path):
        with prof.device_trace(str(tmp_path / "tr")):
            y = torch.ones(64, 64) @ torch.ones(64, 64)
        assert float(y[0, 0]) == 64
        # a CPU capture holds no device events, so the table is empty;
        # the capture itself writes its file
        files = glob.glob(str(tmp_path / "tr") + "/*.trace.json.gz")
        assert len(files) == 1
        assert prof.op_table(str(tmp_path / "tr")) == []
