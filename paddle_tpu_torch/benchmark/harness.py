"""Benchmark harness: timed training windows with MFU accounting (port
of paddle_tpu/benchmark/harness.py).

What a benchmark must report to be honest, as in JAX's:

- a timed window >= `min_time` seconds (adaptive step count), fully
  synchronised with `torch.cuda.synchronize` on the port's device at
  the window edges only, so the launch queue stays filled inside the
  window (on the CPU every op has finished when it returns);
- FLOPs per step counted, not guessed: JAX reads XLA's cost analysis of
  the compiled executable, which PyTorch has no counterpart of; the
  port runs the step once under `torch.utils.flop_counter.FlopCounterMode`
  (matmuls, convolutions and PyTorch's own attention; elementwise work
  and the port's custom kernels count 0, which the model specs correct
  analytically where it matters, as JAX corrects its Pallas calls);
  MFU = FLOPs / second over the card's published peak.

Across ranks (a MeshTrainer over `torch.distributed`) every rank runs
the same window; the window's time is the slowest rank's, and the
ranks agree on every step count, so their collectives stay in step.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from paddle_tpu_torch.obs.goodput import PEAK_FLOPS
from paddle_tpu_torch.utils.tree import flatten_with_keys

# Published dense bf16 peak FLOP/s per card, keyed by
# torch.cuda.get_device_name() (obs/goodput.PEAK_FLOPS, which also holds
# the float32 rate)
PEAK_FLOPS_BF16 = {name: rates[16] for name, rates in PEAK_FLOPS.items()}


def device_peak_flops(dtype_bits: int = 16,
                      device: Optional[torch.device] = None
                      ) -> Optional[float]:
    """Peak FLOP/s of the card, or None if unknown (no card, a CPU
    `device`, or a card the table does not list). Widths over 16 bits
    read the float32 rate (the port leaves TF32 off)."""
    if not torch.cuda.is_available() or (
            device is not None and torch.device(device).type != "cuda"):
        return None
    rates = PEAK_FLOPS.get(torch.cuda.get_device_name(), {})
    return rates.get(16 if dtype_bits <= 16 else 32)


def retry_transient(fn: Callable[[], Any], attempts: int = 2) -> Any:
    """Run fn(); retry on failure. Shared by the benchmark CLI and
    scripts so the guard cannot drift.

    The first failure is PRINTED before retrying: deterministic failures
    (OOM, shape errors) inevitably fail twice, and a silent first attempt
    would both hide that a retry happened and make the failure look
    twice as slow as it was."""
    last = None
    for i in range(attempts):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — any transient counts
            last = e
            if i + 1 < attempts:
                print(f"[retry_transient] attempt {i + 1}/{attempts} failed: "
                      f"{type(e).__name__}: {e}; retrying",
                      file=sys.stderr, flush=True)
    raise last


def _tensors(out):
    return [leaf for _, leaf in flatten_with_keys(out)
            if isinstance(leaf, torch.Tensor)]


def chain_k(fn: Callable, k: int) -> Callable:
    """K chained calls for run_timed's caller contract.

    `fn(carry, *args) -> tensor or tuple of tensors` runs K times
    eagerly, with a scalar carry derived from EVERY output threaded into
    the next call — touching all outputs so no output goes unread,
    scaled by 1e-30 rather than 0 so the next call still depends on the
    previous one — then one `torch.cuda.synchronize` (JAX runs the K
    iterations as one program). The returned callable maps
    (carry, *args) -> carry; divide the measured step time by K."""
    def kstep(s, *args):
        c = s
        for _ in range(k):
            outs = fn(c, *args)
            if not isinstance(outs, (tuple, list)):
                outs = (outs,)
            carry = outs[0].reshape(-1)[0]
            for o in outs[1:]:
                carry = carry + o.reshape(-1)[0].to(carry.dtype)
            c = (carry * 1e-30).to(s.dtype)
        _sync(c)
        return c
    return kstep


_SUSTAINED: Optional[float] = None


def sustained_matmul_flops(min_time: float = 1.5) -> Optional[float]:
    """Sustained bf16 matmul rate of the card (FLOP/s), cached per
    process (the first call's measurement wins).

    Chains of 10 state-chained 8192x8192 `torch.matmul`s (step k+1
    consumes step k's output — the run_timed caller contract): what a
    perfectly matmul-dense program can reach, to set beside the data
    sheet's peak. Returns None without a card."""
    global _SUSTAINED
    if _SUSTAINED is not None:
        return _SUSTAINED
    if not torch.cuda.is_available():
        return None
    n, chain = 8192, 10
    g = torch.Generator(device="cuda").manual_seed(0)
    a = (torch.randn(n, n, device="cuda", generator=g) * 0.01).bfloat16()
    b = (torch.randn(n, n, device="cuda", generator=g) * 0.01).bfloat16()

    def step(s):
        for _ in range(chain):
            s = s @ b
        return s, s

    sec, _, _ = run_timed(step, a, min_time=min_time,
                          device=torch.device("cuda"))
    _SUSTAINED = chain * 2 * n ** 3 / sec
    return _SUSTAINED


def compiled_flops(fn: Callable, *args, **kwargs) -> Optional[float]:
    """FLOPs of one call `fn(*args, **kwargs)`, counted by running it
    once under `torch.utils.flop_counter.FlopCounterMode` (the call's
    backward too, when it runs one). None when nothing was counted or
    the call failed.

    JAX's counterpart lowers and compiles without running; this one
    RUNS the call, so a train step passed here takes a step."""
    from torch.utils.flop_counter import FlopCounterMode
    try:
        with FlopCounterMode(display=False) as counter:
            fn(*args, **kwargs)
        f = counter.get_total_flops()
        return float(f) if f else None
    except Exception:  # noqa: BLE001 — a count is optional, as JAX's
        return None


@dataclasses.dataclass
class BenchResult:
    model: str
    unit: str                       # "imgs/s", "tokens/s", "samples/s"
    value: float                    # items per second
    ms_per_step: float
    steps: int
    batch_size: int
    flops_per_step: Optional[float]
    tflops_per_sec: Optional[float]
    mfu: Optional[float]            # fraction of the card's peak
    device: str
    vs_baseline: Optional[float]

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        return {k: (round(v, 4) if isinstance(v, float) else v)
                for k, v in d.items()}


def device_name(device: Optional[torch.device] = None) -> str:
    """The card's name (`torch.cuda.get_device_name`), or "cpu"."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and torch.cuda.is_available():
        return torch.cuda.get_device_name(dev)
    return dev.type


def _sync(out, device: Optional[torch.device] = None) -> None:
    """Wait until the card has run everything enqueued: a CUDA
    synchronize of `device`, or of the device of `out`'s first tensor.
    A no-op on the CPU, where an op has finished when it returns."""
    if device is None:
        leaves = _tensors(out)
        device = leaves[0].device if leaves else None
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _world_max(*values: float) -> Tuple[float, ...]:
    """Each value's maximum over the ranks of a torch.distributed world
    (the values themselves outside one), so every rank takes the same
    decision from its own clock."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return values
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor(values, dtype=torch.float64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return tuple(float(v) for v in t.cpu())


def run_timed(step_once: Callable[[Any], Tuple[Any, Any]], state,
              min_time: float = 2.0, warmup: int = 3,
              device: Optional[torch.device] = None
              ) -> Tuple[float, int, Any]:
    """Time `state, out = step_once(state)` by two-window subtraction.

    A window edge (a synchronize, the host clock) has a fixed cost, so a
    single window overstates a short step. Time a small window T_A (N_A
    steps + sync) and a large one T_B (N_B steps + sync): per_step =
    (T_B - T_A) / (N_B - N_A) cancels the fixed cost. N_B grows
    (x4) until the subtracted window covers >= min_time. `device` is
    the one to synchronise (default: the device of `out`'s first
    tensor).

    CALLER CONTRACT: step k+1's computation must CONSUME step k's output
    (thread it through `state`), so a window times dependent work.
    Training steps chain through their parameters; for inference or
    kernel timing, fold a scalar from the previous output back into the
    input (see run_infer, chain_k).

    Returns (seconds_per_step, steps_timed_total, final_state)."""
    out = None
    for _ in range(max(warmup, 1)):
        state, out = step_once(state)
    _sync(out, device)

    n_a = 8
    t0 = time.perf_counter()
    for _ in range(n_a):
        state, out = step_once(state)
    _sync(out, device)
    t_a, = _world_max(time.perf_counter() - t0)

    # upper-bound estimate of per-step time picks the first N_B try
    est = t_a / n_a
    n_b = max(4 * n_a, int(min_time / max(est, 1e-9)))
    total_steps = n_a
    while True:
        n_b = min(n_b, 1_000_000)
        t0 = time.perf_counter()
        for _ in range(n_b):
            state, out = step_once(state)
        _sync(out, device)
        t_b, = _world_max(time.perf_counter() - t0)
        total_steps += n_b
        if t_b - t_a >= min_time or n_b >= 1_000_000:
            break
        n_b *= 4
    per_step = (t_b - t_a) / (n_b - n_a)
    return max(per_step, 1e-12), total_steps, state


def _trainer_device(trainer) -> torch.device:
    mesh = getattr(trainer, "mesh", None)
    if mesh is not None:
        return mesh.device
    return next(trainer.module.parameters()).device


def bench_trainer(name: str, trainer, batch, items_per_step: int,
                  unit: str, batch_size: int, min_time: float = 2.0,
                  baseline: Optional[float] = None,
                  baseline_is_ms: bool = False,
                  extra_flops: float = 0.0) -> BenchResult:
    """Benchmark one (trainer, batch): the common wrapper of every model
    spec in models.py. `trainer` is core.executor.Trainer or
    parallel.trainer.MeshTrainer (the same `train_step(batch)`); it
    holds its state (JAX's passes a TrainState), and the batch is
    already on its device.

    The FLOPs are counted on one step before the window
    (`compiled_flops`), on this rank's part of the batch under a mesh.
    extra_flops: an analytic correction added to that count for work
    the counter does not see or sees on another basis — the flash
    kernels (custom operators, counted 0, as XLA scores a Pallas call)
    and the fused cross-entropy's chunk loop (models.py). Keep
    corrections analytic and matmul-only — never estimates of fused
    elementwise work."""
    device = _trainer_device(trainer)

    def step_once(state):
        return state, trainer.train_step(batch)["loss"]

    flops = compiled_flops(trainer.train_step, batch)
    if flops:
        flops += extra_flops
    sec_per_step, steps, _ = run_timed(step_once, None, min_time=min_time,
                                       device=device)

    tflops = (flops / sec_per_step / 1e12) if flops else None
    peak = device_peak_flops(device=device)
    mfu = (flops / sec_per_step / peak) if (flops and peak) else None
    value = items_per_step / sec_per_step
    vs = None
    if baseline:
        vs = (baseline / (sec_per_step * 1e3) if baseline_is_ms
              else value / baseline)
    return BenchResult(
        model=name, unit=unit, value=value,
        ms_per_step=sec_per_step * 1e3, steps=steps,
        batch_size=batch_size,
        flops_per_step=flops, tflops_per_sec=tflops, mfu=mfu,
        device=device_name(device), vs_baseline=vs)
