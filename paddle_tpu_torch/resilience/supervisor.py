"""Run supervisor: preemption-safe training with bad-step rollback
(port of paddle_tpu/resilience/supervisor.py).

The runtime itself handles what a fleet of accelerators does to a
multi-hour job —

- **Preemption** (spot reclaim, maintenance): SIGTERM/SIGINT handlers
  defer the signal to the next step boundary, write one synchronous
  emergency checkpoint, emit a `preempt` event and exit with
  PREEMPT_EXIT_CODE so the scheduler can tell "safe to reschedule"
  from "crashed". Preemption is assumed fleet-wide (every process gets
  the signal, as a slice reclaim delivers it), so the emergency
  save's commit barriers line up across processes.
- **Hung steps**: a watchdog thread flags a step that exceeds its
  deadline (`hang` event) — the observable for a wedged collective or
  a dead coordinator, which otherwise presents as silence.
- **Bad steps**: `train_resilient` absorbs the MeshTrainer bad-step
  guard — skipped updates retry the same global step (batches are
  keyed by step, so recovered runs stay bit-for-bit identical to
  fault-free ones), and a blown budget rolls back to the newest intact
  checkpoint (`rollback` event) before continuing.

The port's trainers hold their state (`trainer.state()` is a view of
the live tensors, `trainer.load_state(ts)` copies a tree in), so
`train_resilient` takes the trainer alone where JAX threads a
`TrainState` through the loop: saves write `trainer.state()`, and a
rollback restores into it.
"""

from __future__ import annotations

import contextlib
import os
import signal
import sys
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

from paddle_tpu_torch.io.checkpoint import (
    CheckpointManager, checkpoint_step, latest_checkpoint)
from paddle_tpu_torch.obs.goodput import MFUMeter
from paddle_tpu_torch.obs.metrics import default_registry
from paddle_tpu_torch.resilience import chaos
from paddle_tpu_torch.resilience.errors import (
    BadStepBudgetExceeded, PREEMPT_EXIT_CODE)
from paddle_tpu_torch.utils.log import resilience_event

Pytree = Any

# resilience counters (OBSERVABILITY.md): the production-side view of
# what the chaos harness asserts in tests — recorded alongside the
# resilience_event stream so a scrape shows fault pressure without
# log parsing
_REG = default_registry()
_PREEMPTS = _REG.counter(
    "ptpu_resilience_preempts_total", "Preemption signals honored")
_HANGS = _REG.counter(
    "ptpu_resilience_hangs_total", "Steps flagged by the watchdog")
_ROLLBACKS = _REG.counter(
    "ptpu_resilience_rollbacks_total",
    "Blown bad-step budgets rolled back to a checkpoint")
_BAD_STEPS = _REG.counter(
    "ptpu_resilience_bad_steps_total", "Skipped (retried) steps")
_EMERGENCY_CKPTS = _REG.counter(
    "ptpu_resilience_emergency_ckpts_total",
    "Synchronous emergency checkpoints written")


class RunSupervisor:
    """Install with `with RunSupervisor(manager) as sup:` around the
    training loop; call `sup.maybe_preempt_exit(ts, step)` at each step
    boundary and wrap the step in `sup.watch_step(step)`.

    Signals are only ever RECORDED by the handler — acting on them
    mid-step would tear the state; the loop converts the flag into an
    emergency checkpoint at the next boundary, where the state is a
    consistent (params, opt, step) triple.
    """

    def __init__(self, manager: Optional[CheckpointManager] = None, *,
                 exit_code: int = PREEMPT_EXIT_CODE,
                 watchdog_timeout_s: Optional[float] = None,
                 on_hang: Optional[Callable[[int, float], None]] = None,
                 _exit_fn: Callable[[int], None] = os._exit):
        self.manager = manager
        self.exit_code = exit_code
        self.watchdog_timeout_s = watchdog_timeout_s
        self.on_hang = on_hang
        self._exit_fn = _exit_fn
        self._signal: Optional[int] = None
        self._old_handlers: Dict[int, Any] = {}
        self._watch: Optional[Tuple[int, float]] = None  # (step, t0)
        self._watch_lock = threading.Lock()
        self._watch_stop = threading.Event()
        self._watch_thread: Optional[threading.Thread] = None
        self.hung_steps: list = []

    # -- signal plumbing --------------------------------------------------
    @property
    def preempted(self) -> Optional[int]:
        """Signal number received, or None."""
        return self._signal

    def _on_signal(self, signum, frame) -> None:
        self._signal = signum

    def install(self) -> "RunSupervisor":
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._old_handlers[sig] = signal.signal(sig, self._on_signal)
            except ValueError:
                pass  # not the main thread: poll-only supervisor
        self.start_watchdog()
        return self

    def uninstall(self) -> None:
        for sig, old in self._old_handlers.items():
            try:
                signal.signal(sig, old)
            except ValueError:
                pass
        self._old_handlers.clear()
        self.stop_watchdog()

    def start_watchdog(self) -> None:
        """Start ONLY the hung-step watchdog (no signal handlers) —
        what the serve front-end uses: its own drain handler owns
        SIGTERM, but it still wants stall detection + the on_hang
        postmortem hook around engine steps."""
        if self.watchdog_timeout_s and self._watch_thread is None:
            self._watch_stop.clear()
            self._watch_thread = threading.Thread(
                target=self._watchdog, daemon=True, name="ptpu-watchdog")
            self._watch_thread.start()

    def stop_watchdog(self) -> None:
        self._watch_stop.set()
        if self._watch_thread is not None:
            self._watch_thread.join(timeout=5)
            self._watch_thread = None

    def __enter__(self) -> "RunSupervisor":
        return self.install()

    def __exit__(self, *exc) -> bool:
        self.uninstall()
        return False

    # -- preemption -------------------------------------------------------
    def emergency_checkpoint(self, ts: Pytree, step: int) -> Optional[str]:
        """Synchronously persist `ts` as the checkpoint for `step`
        (skipped when one for this step is already committed — e.g. the
        signal landed right after a periodic save)."""
        if self.manager is None:
            return None
        self.manager.wait()
        latest = latest_checkpoint(self.manager.directory)
        if latest is not None and checkpoint_step(latest) == step:
            return latest
        path = self.manager.save(ts, step=step)
        self.manager.wait()
        _EMERGENCY_CKPTS.inc()
        return path

    def maybe_preempt_exit(self, ts: Pytree, step: int) -> None:
        """At a step boundary: if a signal arrived, checkpoint and exit
        the process with the preemption exit code. Does not return in
        that case."""
        if self._signal is None:
            return
        path = self.emergency_checkpoint(ts, step)
        _PREEMPTS.inc()
        resilience_event("preempt", signal=int(self._signal), step=step,
                         ckpt=path, exit_code=self.exit_code)
        sys.stdout.flush()
        sys.stderr.flush()
        self._exit_fn(self.exit_code)

    # -- step watchdog ----------------------------------------------------
    def watch_step(self, step: int) -> "_StepWatch":
        return _StepWatch(self, step)

    def _watchdog(self) -> None:
        poll = max(0.05, (self.watchdog_timeout_s or 1.0) / 4.0)
        flagged: Optional[int] = None
        while not self._watch_stop.wait(poll):
            with self._watch_lock:
                watch = self._watch
            if watch is None:
                flagged = None
                continue
            step, t0 = watch
            elapsed = time.monotonic() - t0
            if elapsed > self.watchdog_timeout_s and flagged != step:
                flagged = step
                self.hung_steps.append(step)
                _HANGS.inc()
                resilience_event("hang", step=step,
                                 elapsed_s=round(elapsed, 3),
                                 timeout_s=self.watchdog_timeout_s)
                if self.on_hang is not None:
                    # on_hang is the postmortem path (the serve loop
                    # mounts the flight recorder here) — it must never
                    # kill the watchdog, which is the only observer of
                    # a wedged step
                    try:
                        self.on_hang(step, elapsed)
                    except Exception as e:
                        resilience_event("hang_hook_error", step=step,
                                         error=repr(e))


class _StepWatch:
    def __init__(self, sup: RunSupervisor, step: int):
        self._sup = sup
        self._step = step

    def __enter__(self):
        with self._sup._watch_lock:
            self._sup._watch = (self._step, time.monotonic())
        return self

    def __exit__(self, *exc) -> bool:
        with self._sup._watch_lock:
            self._sup._watch = None
        return False


def train_resilient(trainer, batch_for: Callable[[int], Any],
                    total_steps: int, manager: CheckpointManager, *,
                    start_step: int = 0, save_every: int = 1,
                    supervisor: Optional[RunSupervisor] = None,
                    generator_for_step: Optional[Callable[[int], Any]] = None,
                    on_step: Optional[Callable[[int, Dict], None]] = None,
                    max_rollbacks: int = 8,
                    registry=None, goodput=None, flops_per_step=None,
                    flight_recorder=None, memory_monitor=None,
                    memory_sample_every: int = 1):
    """Fault-tolerant step loop over `batch_for(global_step)`; returns
    `trainer.state()`.

    `trainer` is the port's `Trainer` or `MeshTrainer` (anything with
    `train_step(batch, generator=None) -> fetches`, `state()` and
    `load_state(ts)`). The global step only advances on a FINITE step:
    a skipped bad step (the MeshTrainer guard's `bad_step` fetch)
    retries the same batch (deterministic data => recovered loss
    curves match fault-free ones bit-for-bit), and a blown bad-step
    budget rolls the trainer back to the newest intact checkpoint and
    rewinds the loop there. `generator_for_step(step)` gives the
    step's `torch.Generator` (default: the trainer's own, derived from
    its step). Chaos hooks (`maybe_sigterm`, `poison_batch`) are
    threaded through so the whole loop is testable under injection;
    they are no-ops unless armed via PTPU_CHAOS_*.

    Telemetry (all optional, off by default):
    - `registry` turns on the trainer's step-phase families plus
      `ptpu_train_input_wait_ms` timed around `batch_for`.
    - `goodput` (obs.goodput.GoodputLedger) wraps every step attempt
      in an attribution window and charges checkpoint saves / rollback
      restores as explicit pauses; installed here if not already.
    - `flops_per_step` feeds an obs.goodput.MFUMeter with productive
      step wall time (`ptpu_train_mfu`; absent where the peak is
      unknown).
    - `flight_recorder` (obs.FlightRecorder) is installed and mounted
      on the supervisor's hang hook so a wedged step dumps a bundle
      naming the stuck step.
    - `memory_monitor` (obs.DeviceMemoryMonitor) is sampled every
      `memory_sample_every` completed steps.
    """
    own_sup = supervisor is None
    sup = supervisor or RunSupervisor(manager)
    if own_sup:
        sup.install()
    h_input = None
    if registry is not None:
        enable = getattr(trainer, "enable_metrics", None)
        if enable is not None:
            enable(registry)
        h_input = registry.histogram(
            "ptpu_train_input_wait_ms",
            "Host wall time producing the step's input batch")
    mfu = None
    if flops_per_step:
        mfu = MFUMeter(flops_per_step, registry=registry)
    own_goodput = goodput is not None and not goodput.installed
    if own_goodput:
        goodput.install()
    own_rec = flight_recorder is not None and not flight_recorder.installed
    if own_rec:
        flight_recorder.install()
    if flight_recorder is not None and sup.on_hang is None:
        # the hang hook is the postmortem mount point: the bundle names
        # the stuck step the same way a wedged serve loop's does
        def _dump_hang(step, elapsed, _rec=flight_recorder):
            _rec.dump("watchdog_hang", step=step,
                      elapsed_s=round(elapsed, 3))
        sup.on_hang = _dump_hang

    def _pause(cause):
        if goodput is not None:
            return goodput.pause(cause)
        return contextlib.nullcontext()

    rollbacks = 0
    step = start_step
    try:
        while step < total_steps:
            chaos.maybe_sigterm(step)
            if sup.preempted is not None:
                sup.maybe_preempt_exit(trainer.state(), step)
            t_in = time.perf_counter()
            raw = batch_for(step)
            if h_input is not None:
                h_input.observe((time.perf_counter() - t_in) * 1e3)
            batch = chaos.poison_batch(raw, step)
            gen = (generator_for_step(step)
                   if generator_for_step is not None else None)
            window = (goodput.attempt() if goodput is not None
                      else contextlib.nullcontext())
            t0 = time.perf_counter()
            try:
                with window, sup.watch_step(step):
                    fetches = trainer.train_step(batch, generator=gen)
            except BadStepBudgetExceeded:
                rollbacks += 1
                if rollbacks > max_rollbacks:
                    raise
                with _pause("rollback"):
                    restored, rstep = manager.restore_latest(
                        trainer.state())
                    if restored is None:
                        raise
                    trainer.load_state(restored)
                _ROLLBACKS.inc()
                resilience_event("rollback", from_step=step,
                                 to_step=rstep, rollbacks=rollbacks)
                step = rstep
                reset = getattr(trainer, "reset_bad_steps", None)
                if reset is not None:
                    reset()
                continue
            except Exception as e:
                if flight_recorder is not None:
                    flight_recorder.dump("train_crash", step=step,
                                         error=repr(e))
                raise
            if fetches.pop("bad_step", False):
                _BAD_STEPS.inc()
                continue  # the update was skipped; retry this step
            if mfu is not None:
                mfu.observe_step(time.perf_counter() - t0)
            if on_step is not None:
                on_step(step, fetches)
            step += 1
            if memory_monitor is not None and memory_sample_every \
                    and step % memory_sample_every == 0:
                memory_monitor.sample()
            if save_every and step % save_every == 0:
                with _pause("checkpoint"):
                    manager.save(trainer.state(), step=step)
        if save_every and total_steps % save_every != 0:
            with _pause("checkpoint"):
                manager.save(trainer.state(), step=total_steps)
        with _pause("checkpoint"):
            manager.wait()
        return trainer.state()
    finally:
        if own_rec:
            flight_recorder.uninstall()
        if own_goodput:
            goodput.uninstall()
        if own_sup:
            sup.uninstall()
