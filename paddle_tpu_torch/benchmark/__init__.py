"""Benchmark harness + model zoo (port of paddle_tpu/benchmark/; the
reference's fluid_benchmark.py capability). Run
`python -m paddle_tpu_torch.benchmark --help`."""

from paddle_tpu_torch.benchmark.harness import (
    BenchResult, bench_trainer, compiled_flops, device_peak_flops, run_timed)
from paddle_tpu_torch.benchmark.models import MODELS, run_model

__all__ = ["BenchResult", "bench_trainer", "compiled_flops",
           "device_peak_flops", "run_timed", "MODELS", "run_model"]
