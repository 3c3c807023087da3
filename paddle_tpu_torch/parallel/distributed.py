"""Multi-process bootstrap (port of paddle_tpu/parallel/distributed.py).

`init_distributed` keeps the JAX package's contract on
`torch.distributed.init_process_group`: the coordinator, the process
count and this process's index come from the arguments or from
PTPU_COORDINATOR / PTPU_NUM_PROCESSES / PTPU_PROCESS_ID; with none of
them the process runs alone (no group is made); the rendezvous is
retried with backoff (`_init_retry_policy`, the `init_distributed`
chaos site). A coordinator is a `tcp://host:port` address (a bare
`host:port`, as JAX takes, is read as one).

`private_groups` is the same rendezvous for a group that belongs to one
object rather than to the process: a tensor-parallel engine
(engine/tp_worker.py) builds its control and data groups on a TCP store
of its own, so one process can hold several engines, one after the
other or at once, and never touches the process's default group.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Optional, Sequence

import torch.distributed as dist

from paddle_tpu_torch.resilience import chaos as _chaos
from paddle_tpu_torch.resilience.retry import (RetryPolicy, retry_call,
                                               shared_budget)

_initialized = False


def _init_retry_policy() -> RetryPolicy:
    """Rendezvous flaps (coordinator not up yet) are the normal startup
    of a preemptible fleet, so first-contact failures get real retries.
    Knobs: PTPU_INIT_RETRIES (attempts, default 3) and PTPU_RETRY_SCALE
    (global sleep scale, see resilience.retry)."""
    try:
        attempts = int(os.environ.get("PTPU_INIT_RETRIES", "3"))
    except ValueError:
        attempts = 3
    return RetryPolicy(attempts=max(1, attempts), base_delay=0.5,
                       max_delay=15.0, retry_on=(RuntimeError, OSError))


def _tcp(address: str) -> str:
    return address if "://" in address else f"tcp://{address}"


_INIT_TIMEOUT_S = 300.0       # the default group's collectives


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Join the (gloo) process group of a multi-process run. Idempotent.
    Single-process when nothing is configured. The rendezvous is
    retried with exponential backoff and deterministic jitter
    (resilience.retry)."""
    global _initialized
    if _initialized:
        return
    coordinator = coordinator or os.environ.get("PTPU_COORDINATOR")
    if num_processes is None:
        env = os.environ.get("PTPU_NUM_PROCESSES")
        num_processes = int(env) if env else None
    if process_id is None:
        env = os.environ.get("PTPU_PROCESS_ID")
        process_id = int(env) if env else None
    if coordinator is None and num_processes is None:
        _initialized = True  # single-process mode
        return

    def rendezvous():
        _chaos.maybe_fail("init_distributed")
        dist.init_process_group(
            backend="gloo", init_method=_tcp(coordinator),
            world_size=num_processes, rank=process_id,
            timeout=datetime.timedelta(seconds=_INIT_TIMEOUT_S))

    retry_call(rendezvous, policy=_init_retry_policy(),
               name="init_distributed", budget=shared_budget())
    _initialized = True


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """The trainer_id == 0 checks throughout the reference."""
    return process_index() == 0


def _new_backend(name: str, store, rank: int, size: int,
                 timeout: datetime.timedelta, device=None):
    """A c10d backend of `name` ("gloo" or "nccl") over `store`. Gloo
    connects over the loopback interface: every rank of a group made
    here runs on this host."""
    if name == "gloo":
        opts = dist.ProcessGroupGloo._Options()
        opts._devices = [dist.ProcessGroupGloo.create_device(
            hostname="127.0.0.1")]
        opts._timeout = timeout
        return dist.ProcessGroupGloo(store, rank, size, opts)
    if name == "nccl":
        import torch
        torch.cuda.set_device(device)
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = timeout
        return dist.ProcessGroupNCCL(store, rank, size, opts)
    raise ValueError(f"unknown backend {name!r}: 'gloo' or 'nccl'")


def serve_store(timeout_s: float) -> dist.TCPStore:
    """A TCP store served by this process on a free loopback port
    (`.port`); its clients connect with `private_groups`."""
    return dist.TCPStore("127.0.0.1", 0, is_master=True,
                         timeout=datetime.timedelta(seconds=timeout_s),
                         wait_for_workers=False)


def private_groups(store_or_port, rank: int, size: int,
                   backends: Sequence[str] = ("gloo",),
                   timeout_s: float = 300.0,
                   device=None) -> Dict[str, object]:
    """One group of `size` ranks for each name in `backends`, private
    to the caller: rank 0 passes the store it serves (`serve_store`),
    the others that store's port. Keys are "<i>:<backend>" in the
    order given. The rendezvous is retried as `init_distributed`'s;
    the groups' collectives time out after `timeout_s`, so a rank that
    died makes its peers raise instead of hang."""
    timeout = datetime.timedelta(seconds=timeout_s)

    def rendezvous():
        _chaos.maybe_fail("init_distributed")
        store = (store_or_port if rank == 0 else
                 dist.TCPStore("127.0.0.1", int(store_or_port),
                               is_master=False, timeout=timeout))
        return {f"{i}:{b}": _new_backend(
                    b, dist.PrefixStore(f"{i}:{b}/", store), rank, size,
                    timeout, device)
                for i, b in enumerate(backends)}

    return retry_call(rendezvous, policy=_init_retry_policy(),
                      name="init_distributed", budget=shared_budget())
