"""Tensor-parallel serving across processes: the leader's command stream
and the worker ranks that replay it.

The JAX engine drives its tp devices from one process (GSPMD). The port
is SPMD over torch.distributed instead: rank 0 is the `ServeEngine` the
caller holds — scheduler, cache bookkeeping, sampling, host tier — and
ranks 1..N-1 are worker processes started by it
(`python -m paddle_tpu_torch.engine.tp_worker`). A worker holds its
shard of the weights and its head slices of the KV pools, runs no
scheduler, and replays what the leader sends, in the leader's order:

- STEP: the step's staged int32 operands (the engine's one fixed-size
  operand buffer, engine/step_graph.py) in one broadcast, then the step
  on every rank, with its in-step collectives (out_proj's fp sum and
  fc2's serving allreduce, parallel/serve_collective.py);
- COW, COMPRESS, PROMOTE: a flush's fixed-width lanes (a compressed
  block's scale is the MAX of the ranks' scales, reduced on the data
  plane, so every rank quantizes with the whole block's scale);
- LOAD: a host-tier revival's lanes, each rank sent its head slice of
  the global payload;
- READ: a block (fp) or an int8 slot leaving the device (demotion,
  spill): every rank sends its head slice to the leader, which joins
  them in head order;
- PROBE: the allreduce probe the engine times at construction;
- STATE: a worker's launch counts, pool bytes, int8 scales and program
  count (so the leader's counters cover every rank);
- CLOSE: the worker exits 0.

A command's header (its op and a few int arguments) goes down each
worker's stdin pipe, so a worker waits for its next command without a
deadline: an idle engine sends none for as long as it is idle. The end
of the pipe (the leader's exit) ends the worker at once, as does the
leader's death (PR_SET_PDEATHSIG). What a command carries goes over two
groups private to the engine (built on its own TCP store,
parallel/distributed.private_groups): the control plane is always gloo
(operands, lanes, payloads), the data plane carries the in-step
collectives — NCCL when every rank has its own card, gloo on the CPU or
when ranks share a card. The rendezvous and both groups' collectives
time out after TP_TIMEOUT_S, so a rank that dies within a command makes
its peers raise instead of hang.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import pickle
import signal
import subprocess
import sys
import time
import weakref
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.parallel.collective import AxisGroup, broadcast
from paddle_tpu_torch.parallel.distributed import private_groups, serve_store

OP_STEP, OP_COW, OP_COMPRESS, OP_PROMOTE, OP_LOAD, OP_READ, OP_PROBE, \
    OP_STATE, OP_CLOSE = range(1, 10)
_HEADER = 8                     # int64 words of a command header
_KINDS = ("fp", "int8")         # READ's kinds
_LANE_OPS = {"cow": OP_COW, "compress": OP_COMPRESS, "promote": OP_PROMOTE}


TP_TIMEOUT_S = 120.0    # the rendezvous and every collective of a command
START_TIMEOUT_S = 300.0  # a worker's interpreter start and imports


def _header(op: int, *args: int) -> bytes:
    words = np.zeros(_HEADER, np.int64)
    words[0] = op
    words[1:1 + len(args)] = args
    return words.tobytes()


def _next_command(fd: int) -> Optional[List[int]]:
    """The next header on the pipe `fd`: [op, args...]; None at its end
    (the leader is gone)."""
    buf = b""
    while len(buf) < _HEADER * 8:
        part = os.read(fd, _HEADER * 8 - len(buf))
        if not part:
            return None
        buf += part
    return np.frombuffer(buf, np.int64).tolist()


def param_bytes(module: torch.nn.Module) -> int:
    """Bytes of `module`'s parameters (a rank's weight shard)."""
    return sum(p.numel() * p.element_size() for p in module.parameters())


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A host tensor's bytes as a flat uint8 view (any dtype rides the
    control plane as bytes)."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def _send(ctl: AxisGroup, t: torch.Tensor, dst: int) -> None:
    ctl.pg.send([_wire(t)], dst, 0).wait()


def _recv_into(ctl: AxisGroup, t: torch.Tensor, src: int) -> torch.Tensor:
    ctl.pg.recv([t.reshape(-1).view(torch.uint8)], src, 0).wait()
    return t


def _send_obj(ctl: AxisGroup, obj, dst: int) -> None:
    blob = torch.frombuffer(bytearray(pickle.dumps(obj)), dtype=torch.uint8)
    _send(ctl, torch.tensor([blob.numel()], dtype=torch.int64), dst)
    _send(ctl, blob, dst)


def _recv_obj(ctl: AxisGroup, src: int):
    n = _recv_into(ctl, torch.zeros(1, dtype=torch.int64), src)
    blob = _recv_into(ctl, torch.empty(int(n), dtype=torch.uint8), src)
    return pickle.loads(blob.numpy().tobytes())


def launch_counts() -> Dict[str, int]:
    """This process's paged-kernel launch counters, by
    "<wrapper>.<counter>"."""
    from paddle_tpu_torch.kernels import paged_attention as paged
    return {f"{fn.__name__}.{attr}": getattr(fn, attr)
            for fn, attr in paged.LAUNCH_COUNTERS}


def _zero_counters() -> None:
    from paddle_tpu_torch.kernels import paged_attention as paged
    with paged.COUNT_LOCK:
        for fn, attr in paged.LAUNCH_COUNTERS:
            setattr(fn, attr, 0)


def _slices(cache, kind: str, index: int) -> torch.Tensor:
    """This rank's stacked host slices of one block or int8 slot:
    [2L, bs, Hkv/tp, hd], every layer's k then v."""
    pools = cache.pools if kind == "fp" else cache.qpools
    return torch.stack([t[index] for pair in pools for t in pair]).cpu()


def _shutdown(procs: List[subprocess.Popen], codes: List[Optional[int]],
              joined: bool, timeout_s: float = 30.0) -> None:
    """Stop the workers: CLOSE down each pipe once they have joined the
    groups (before that, a kill: a worker in the rendezvous reads no
    command), then join each, killing one that does not exit in
    `timeout_s`; `codes` gets the exit codes."""
    for p in procs:
        try:
            if joined:
                p.stdin.write(_header(OP_CLOSE))
            elif p.poll() is None:
                p.kill()
            p.stdin.close()
        except OSError:         # a worker already gone: its pipe is shut
            pass
    for p in procs:
        try:
            p.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    codes[:] = [p.returncode for p in procs]


class TPLeader:
    """Rank 0's end of the command stream. Built by a tp `ServeEngine`:
    starts ranks 1..size-1, makes the two groups, and sends each worker
    `spec` (what it needs to build its model, cache and step) and its
    weight shard (`shards[r]`, a flat {path: float32 array} tree)."""

    def __init__(self, size: int, devices: Sequence[torch.device],
                 data_backend: str, spec: dict,
                 shards: Sequence[Dict[str, np.ndarray]]):
        self.size = size
        self.devices = list(devices)
        self.data_backend = data_backend
        self.exit_codes: List[Optional[int]] = []
        timeout = TP_TIMEOUT_S
        store = serve_store(timeout)
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
        self.procs = [subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.engine.tp_worker",
             "--port", str(store.port), "--rank", str(r),
             "--size", str(size), "--device", str(self.devices[r]),
             "--data-backend", data_backend, "--timeout", str(timeout)],
            env=env, stdin=subprocess.PIPE, bufsize=0)
            for r in range(1, size)]
        self._finalizer = weakref.finalize(
            self, _shutdown, self.procs, self.exit_codes, False)
        try:
            self._await_workers(store)
            groups = private_groups(store, 0, size, ("gloo", data_backend),
                                    timeout, device=self.devices[0])
        except BaseException:
            self.close()
            raise
        self._store = store
        self.ctl = AxisGroup(groups["0:gloo"], "gloo")
        self.data = AxisGroup(groups[f"1:{data_backend}"], data_backend)
        self._finalizer.detach()
        self._finalizer = weakref.finalize(
            self, _shutdown, self.procs, self.exit_codes, True)
        for r in range(1, size):
            paths = sorted(shards[r])
            _send_obj(self.ctl, dict(spec, params=[
                (p, tuple(shards[r][p].shape)) for p in paths]), r)
            flat = np.concatenate([np.asarray(shards[r][p], np.float32)
                                   .reshape(-1) for p in paths])
            _send(self.ctl, torch.from_numpy(flat), r)

    def _await_workers(self, store) -> None:
        """Wait until every worker has imported the port and is about to
        join the groups; a worker that exits first raises at once."""
        keys = [f"ready/{r}" for r in range(1, self.size)]
        deadline = time.monotonic() + START_TIMEOUT_S
        while not store.check(keys):
            dead = [(r + 1, p.returncode) for r, p in enumerate(self.procs)
                    if p.poll() is not None]
            if dead:
                raise RuntimeError(f"tp worker ranks {dead} (rank, exit "
                                   "code) exited before joining")
            if time.monotonic() > deadline:
                raise RuntimeError(f"tp workers did not start in "
                                   f"{START_TIMEOUT_S:.0f} s")
            time.sleep(0.02)

    # -- the command stream ------------------------------------------------
    def _command(self, op: int, *args: int) -> None:
        if not self._finalizer.alive:
            raise RuntimeError("the tp engine's workers are closed")
        header = _header(op, *args)
        for r, p in enumerate(self.procs, 1):
            try:
                p.stdin.write(header)
            except OSError as e:
                raise RuntimeError(f"tp worker rank {r} is gone (exit code "
                                   f"{p.poll()})") from e

    def step(self, operands: torch.Tensor) -> None:
        """STEP: every worker takes `operands` (the step's staged int32
        buffer) and runs the step beside the leader."""
        self._command(OP_STEP)
        broadcast(operands, self.ctl)

    def lanes(self, kind: str, a: np.ndarray, b: np.ndarray) -> None:
        """COW / COMPRESS / PROMOTE (`kind` "cow", "compress",
        "promote") over one fixed-width batch of lanes (a, b), in the
        engine's argument order."""
        self._command(_LANE_OPS[kind])
        broadcast(torch.from_numpy(np.stack([a, b])), self.ctl)

    def load(self, blocks: np.ndarray, host: torch.Tensor) -> torch.Tensor:
        """LOAD: one revival batch. `host` is the global payload [L, 2,
        lanes, bs, Hkv, hd]; each worker is sent its head slice, and the
        leader's own slice is returned."""
        self._command(OP_LOAD)
        broadcast(torch.from_numpy(blocks), self.ctl)
        parts = host.chunk(self.size, dim=4)
        for r in range(1, self.size):
            _send(self.ctl, parts[r], r)
        return parts[0].contiguous()

    def gather_heads(self, kind: str, index: int,
                     local: torch.Tensor) -> torch.Tensor:
        """READ: the global [2L, bs, Hkv, hd] of block (kind "fp") or
        int8 slot (kind "int8") `index`, every rank's head slice in head
        order; `local` is the leader's."""
        self._command(OP_READ, _KINDS.index(kind), index)
        parts = [local] + [_recv_into(self.ctl, torch.empty_like(local), r)
                           for r in range(1, self.size)]
        return torch.cat(parts, dim=2)

    def probe(self, shape: Sequence[int]) -> None:
        """PROBE: every worker runs the allreduce probe beside the
        leader."""
        self._command(OP_PROBE, *shape)

    def state(self, reset_launches: bool = False) -> List[dict]:
        """STATE: each worker's {rank, launches, pool_bytes, qscales,
        compiles}, rank order; `reset_launches` zeroes the workers'
        launch counts after they are read."""
        self._command(OP_STATE, int(reset_launches))
        return [_recv_obj(self.ctl, r) for r in range(1, self.size)]

    def close(self) -> List[Optional[int]]:
        """Stop and join the workers (idempotent); their exit codes."""
        self._finalizer()
        return self.exit_codes


# -- the worker --------------------------------------------------------------

def build_shard(model: dict, params: Dict[str, np.ndarray],
                device: torch.device, rank: int, size: int):
    """Rank `rank` of `size`'s shard of a CausalLM: `model` its
    constructor's arguments (the dtype by name), `params` the rank's
    slices as a flat {JAX path: array} tree (parallel/sharding
    .shard_variables). Built on the host, cut to the rank's widths and
    loaded there, and only then moved to `device`, so the device never
    holds more than the shard."""
    from paddle_tpu_torch.models import CausalLM, load_jax_params
    from paddle_tpu_torch.parallel.sharding import (serve_tp_rules,
                                                    shard_module)
    from paddle_tpu_torch.utils.tree import nest

    shard = CausalLM(dropout=0.0, device="cpu",
                     **dict(model, dtype=getattr(torch, model["dtype"])))
    shard_module(shard, serve_tp_rules(), rank, size)
    load_jax_params(shard, nest(params))
    shard.to(device)
    shard.device = device
    return shard


def _build(spec: dict, flat: np.ndarray, device: torch.device, tp):
    """A worker's model (its weight shard), cache (its pool slices) and
    step program (eager, over `tp`)."""
    from paddle_tpu_torch.engine.paged_cache import PagedKVCache
    from paddle_tpu_torch.engine.step_graph import StepGraph
    from paddle_tpu_torch.obs.metrics import MetricsRegistry

    params, off = {}, 0
    for path, shape in spec["params"]:
        n = int(np.prod(shape))
        params[path] = flat[off:off + n].reshape(shape)
        off += n
    model = build_shard(spec["model"], params, device, tp.rank, tp.size)
    cache = PagedKVCache(dtype=model.dtype, device=device,
                         registry=MetricsRegistry(), tp_size=tp.size,
                         **spec["cache"])
    graph = StepGraph(model, cache, tp=tp, **spec["graph"])
    return model, cache, graph


def serve_commands(ctl: AxisGroup, data: AxisGroup, device: torch.device,
                   spec: dict, flat: np.ndarray, commands: int = 0) -> int:
    """The worker's loop: build this rank's shard, then replay the
    commands whose headers come down the pipe `commands` (stdin) until
    CLOSE. Returns the exit code (0); the pipe's end without CLOSE (the
    leader gone) raises."""
    from paddle_tpu_torch.parallel.collective import all_reduce
    from paddle_tpu_torch.parallel.serve_collective import (
        ServeTP, allreduce_probe_ms)

    tp = ServeTP(data, ctl.size, **spec["tp"])
    model, cache, graph = _build(spec, flat, device, tp)
    lanes = torch.zeros((2, spec["lanes"]), dtype=torch.int64)
    payload = torch.empty((len(cache.pools), 2, spec["lanes"])
                          + cache.pool_shape()[1:], dtype=cache.dtype)

    def reduce_max(t):
        return all_reduce(t, data, "max")

    while True:
        words = _next_command(commands)
        if words is None:
            raise RuntimeError("the tp leader closed the command pipe "
                               "without CLOSE")
        op, *args = words
        if op == OP_CLOSE:
            return 0
        if op == OP_STEP:
            graph.host_operands.copy_(broadcast(graph.host_operands, ctl))
            graph.run()
        elif op in (OP_COW, OP_COMPRESS, OP_PROMOTE):
            a, b = broadcast(lanes, ctl).to(device)
            if op == OP_COW:
                cache.copy_blocks(a, b)
            elif op == OP_COMPRESS:
                cache.compress_lanes(a, b, reduce_max)
            else:
                cache.promote_lanes(a, b)
        elif op == OP_LOAD:
            idx = broadcast(lanes[0], ctl).to(device)
            cache.write_lanes(idx, _recv_into(ctl, payload, 0).to(device))
        elif op == OP_READ:
            _send(ctl, _slices(cache, _KINDS[args[0]], args[1]), 0)
        elif op == OP_PROBE:
            shape = tuple(a for a in args if a > 0)
            allreduce_probe_ms(data, tp.mode, shape=shape, chunk=tp.chunk,
                               device=device)
        elif op == OP_STATE:
            _send_obj(ctl, {
                "rank": ctl.rank, "launches": launch_counts(),
                "pool_bytes": cache.per_chip_pool_bytes(),
                "param_bytes": param_bytes(model),
                "qscales": [(k.cpu().numpy(), v.cpu().numpy())
                            for k, v in cache.qscales],
                "compiles": graph.compiles}, 0)
            if args[0]:
                _zero_counters()
        else:
            raise RuntimeError(f"unknown tp command {op}")


def _die_with_parent() -> None:
    """Linux: SIGTERM this worker when the leader's process ends."""
    try:
        ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, signal.SIGTERM)
    except (OSError, AttributeError):
        pass


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="one worker rank of a tensor-parallel ServeEngine "
                    "(started by the engine; not run by hand)")
    p.add_argument("--port", type=int, required=True,
                   help="the leader's TCP store port on 127.0.0.1")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--size", type=int, required=True)
    p.add_argument("--device", required=True)
    p.add_argument("--data-backend", choices=("gloo", "nccl"),
                   required=True)
    p.add_argument("--timeout", type=float, required=True,
                   help="seconds the rendezvous and a collective may take")
    a = p.parse_args(argv)
    _die_with_parent()
    import datetime
    import torch.distributed as dist

    device = torch.device(a.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        # ranks on the CPU share the host's cores: one thread a worker,
        # so the ranks' thread pools do not spin against each other
        torch.set_num_threads(1)
    timeout = a.timeout
    dist.TCPStore("127.0.0.1", a.port, is_master=False,
                  timeout=datetime.timedelta(seconds=timeout)).set(
                      f"ready/{a.rank}", "1")
    groups = private_groups(a.port, a.rank, a.size, ("gloo", a.data_backend),
                            timeout, device=device)
    ctl = AxisGroup(groups["0:gloo"], "gloo")
    data = AxisGroup(groups[f"1:{a.data_backend}"], a.data_backend)
    spec = _recv_obj(ctl, 0)
    n = sum(int(np.prod(s)) for _, s in spec["params"])
    flat = _recv_into(ctl, torch.empty(n, dtype=torch.float32), 0).numpy()
    return serve_commands(ctl, data, device, spec, flat)


if __name__ == "__main__":
    sys.exit(main())
