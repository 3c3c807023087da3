"""Multi-process launcher (port of paddle_tpu/parallel/launch.py).

One process a rank, wired by the PTPU_* environment that
parallel/distributed.init_distributed and parallel/mesh.make_mesh read:

    python -m paddle_tpu_torch.parallel.launch --nproc 4 --device cpu \\
        train.py --lr 0.1
    python -m paddle_tpu_torch.parallel.launch --nproc 2 --device cpu \\
        -m paddle_tpu_torch.testing.dist_worker

- PTPU_COORDINATOR, PTPU_NUM_PROCESSES, PTPU_PROCESS_ID: the rendezvous
  (`tcp://host:port`, the world size, this rank);
- PTPU_DEVICES: every rank's device in rank order; PTPU_BACKEND: the
  data plane's backend.

Where the ranks run is chosen, never switched on failure:
- default: rank i on card i over NCCL; more ranks than cards raises;
- `device="cpu"` (`--device cpu`): every rank on the CPU over gloo, one
  torch thread a rank unless OMP_NUM_THREADS says otherwise;
- `share_card=True` (`--share-card`): every rank on cuda:0 over gloo
  (NCCL refuses two ranks on one device; gloo stages through host
  memory).

A rendezvous on this host binds gloo to the loopback interface.

Failure detection: a watchdog polls the children, and when one dies with
a nonzero rc while peers still run, the peers get `peer_failure_grace`
seconds to notice and are then terminated, so survivors fail fast with a
"peer failure: proc K died (rc=N)" report instead of hanging in a
collective until `timeout`. RuntimeError carries every process's rc and
log tail.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import threading
import time
from typing import List, Optional, Sequence


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_placement(nproc: int, device: Optional[str] = None,
                   share_card: bool = False):
    """(every rank's device, backend) of a launch."""
    if device is not None and share_card:
        raise ValueError("give device= or share_card, not both")
    if device == "cpu":
        return ["cpu"] * nproc, "gloo"
    if device is not None:
        raise ValueError(f"device {device!r}: 'cpu', or no device for the "
                         "cards")
    import torch
    cards = torch.cuda.device_count()
    if share_card:
        if cards < 1:
            raise RuntimeError("share_card: no CUDA device is available")
        return ["cuda:0"] * nproc, "gloo"
    if nproc > cards:
        raise ValueError(f"{nproc} ranks over {cards} cards: pass "
                         "share_card=True (gloo on one card) or "
                         "device='cpu'")
    return [f"cuda:{i}" for i in range(nproc)], "nccl"


def _loopback(host: str) -> bool:
    return host in ("127.0.0.1", "localhost", "::1")


def launch(nproc: int, command: Sequence[str],
           coordinator: Optional[str] = None,
           device: Optional[str] = None, share_card: bool = False,
           env: Optional[dict] = None,
           timeout: float = 600.0,
           peer_failure_grace: float = 5.0
           ) -> List[subprocess.CompletedProcess]:
    """Spawn `nproc` copies of `command`, one rank each, wired into one
    torch.distributed world. Returns each process's CompletedProcess
    (stdout and stderr captured); raises RuntimeError when any failed."""
    devices, backend = rank_placement(nproc, device, share_card)
    coordinator = coordinator or f"127.0.0.1:{free_port()}"
    host = coordinator.rsplit("://", 1)[-1].rsplit(":", 1)[0]
    procs = []
    for i in range(nproc):
        penv = dict(os.environ)
        penv.update(env or {})
        penv["PTPU_COORDINATOR"] = coordinator
        penv["PTPU_NUM_PROCESSES"] = str(nproc)
        penv["PTPU_PROCESS_ID"] = str(i)
        penv["PTPU_DEVICES"] = ",".join(devices)
        penv["PTPU_BACKEND"] = backend
        if device == "cpu":
            penv.setdefault("OMP_NUM_THREADS", "1")
        if _loopback(host) and os.path.exists("/sys/class/net/lo"):
            penv.setdefault("GLOO_SOCKET_IFNAME", "lo")
        procs.append(subprocess.Popen(
            list(command), env=penv, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))

    # Drain threads start at once: a child that logs more than the pipe
    # buffer must never block on write while the watchdog polls.
    outputs: List[Optional[tuple]] = [None] * nproc

    def drain(i, p):
        outputs[i] = p.communicate()

    threads = [threading.Thread(target=drain, args=(i, p), daemon=True)
               for i, p in enumerate(procs)]
    for t in threads:
        t.start()

    deadline = time.monotonic() + timeout
    first_fault: Optional[int] = None
    fault_time = 0.0
    killed_as_survivor: List[int] = []
    while True:
        codes = [p.poll() for p in procs]
        if all(c is not None for c in codes):
            break
        now = time.monotonic()
        if first_fault is None:
            for i, c in enumerate(codes):
                if c is not None and c != 0:
                    first_fault, fault_time = i, now
                    break
        if first_fault is not None and now - fault_time > peer_failure_grace:
            for i, p in enumerate(procs):
                if p.poll() is None:
                    killed_as_survivor.append(i)
                    p.terminate()
            break
        if now > deadline:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            break
        time.sleep(0.05)

    results = []
    for i, (p, t) in enumerate(zip(procs, threads)):
        t.join(timeout=30)
        if t.is_alive():                 # terminate did not stick
            p.kill()
            t.join(timeout=10)
        out, err = outputs[i] or ("", "")
        results.append(subprocess.CompletedProcess(
            p.args, p.returncode if p.returncode is not None else -9,
            out, err))
    if any(r.returncode != 0 for r in results):
        msgs = []
        if first_fault is not None:
            msgs.append(
                f"peer failure: proc {first_fault} died "
                f"(rc={results[first_fault].returncode}); survivors "
                f"{killed_as_survivor} terminated after "
                f"{peer_failure_grace}s grace")
        for i, r in enumerate(results):
            msgs.append(f"--- proc {i} rc={r.returncode}\n"
                        f"stdout:\n{r.stdout[-2000:]}\n"
                        f"stderr:\n{r.stderr[-2000:]}")
        raise RuntimeError(f"launch of {command!r} failed:\n"
                           + "\n".join(msgs))
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch.parallel.launch",
        description="Run a script as NPROC ranks of one torch.distributed "
                    "world (rank i on card i over NCCL by default).")
    p.add_argument("--nproc", type=int, required=True)
    p.add_argument("--coordinator", default=None,
                   help="host:port (default: a free local port)")
    where = p.add_mutually_exclusive_group()
    where.add_argument("--device", choices=["cpu"], default=None,
                       help="every rank on the CPU over gloo")
    where.add_argument("--share-card", action="store_true",
                       help="every rank on cuda:0 over gloo")
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("-m", dest="module", default=None,
                   help="run a library module as the script (python -m)")
    p.add_argument("script", nargs=argparse.REMAINDER,
                   help="script and its args")
    args = p.parse_args(argv)
    head = ["-m", args.module] if args.module else []
    if not head and not args.script:
        p.error("missing script to launch")
    results = launch(args.nproc, [sys.executable] + head + args.script,
                     coordinator=args.coordinator, device=args.device,
                     share_card=args.share_card, timeout=args.timeout)
    for r in results:
        sys.stdout.write(r.stdout)
        sys.stderr.write(r.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
