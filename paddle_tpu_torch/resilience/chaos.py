"""Deterministic fault injection for the resilience layer (port of
paddle_tpu/resilience/chaos.py, reading the same variables).

The failure modes a fleet of accelerators serves up, each behind a
`PTPU_CHAOS_*` env var so both in-process tests and subprocess
clusters can arm them without code changes:

    PTPU_CHAOS_CKPT_IO=N        first N checkpoint shard writes raise OSError
    PTPU_CHAOS_CKPT_READ=N      first N shard-file opens on load raise OSError
    PTPU_CHAOS_BARRIER=N        first N checkpoint barrier waits raise
    PTPU_CHAOS_INIT_FAIL=N      first N distributed-init attempts raise
    PTPU_CHAOS_SIGTERM_STEP=S   SIGTERM self at the start of step S
    PTPU_CHAOS_SIGTERM_PROC=P   ...only on process P (default: every process)
    PTPU_CHAOS_NAN_STEP=S[:E]   poison batches at global steps S..E with NaN
    PTPU_CHAOS_NAN_ATTEMPTS=K   ...for the first K attempts at each step (dflt 1)
    PTPU_CHAOS_CORRUPT_STEP=S   corrupt ckpt-S right after it commits
    PTPU_CHAOS_CORRUPT_MODE=M   truncate (default) | manifest
    PTPU_CHAOS_KVXFER_CORRUPT=N first N fleet KV-transfer blobs this
                                process pulls arrive bit-rotted

Wire-level faults ride the same contract through `NetChaosProxy` — an
in-process TCP proxy a test or serve_bench parks in front of a
replica so the ROUTER's failover paths (breaker, retry budget,
hedging) are exercised against real socket behaviour, not mocks:

    PTPU_CHAOS_NET_REFUSE=N     first N connects reset before any byte
    PTPU_CHAOS_NET_5XX=N        first N requests answered 503 locally
    PTPU_CHAOS_NET_BLACKHOLE=N  first N conns swallowed: request read,
                                nothing ever sent back, socket held open
    PTPU_CHAOS_NET_BLACKHOLE_AFTER=B  ...after relaying B response bytes
                                (0 = swallow from the first byte)
    PTPU_CHAOS_NET_SLOW=N       first N responses delayed...
    PTPU_CHAOS_NET_SLOW_MS=M    ...by M ms before their first byte

Everything is deterministic: counters are plain per-process integers,
no RNG — the same env produces the same fault schedule every run,
which is what lets the chaos matrix assert bit-for-bit recovery.
All hooks are no-ops (one dict lookup) when the env is unarmed.
"""

from __future__ import annotations

import os
import signal
import socket
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from paddle_tpu_torch.utils.log import resilience_event
from paddle_tpu_torch.utils.tree import map_leaves

_SITES = {
    "ckpt_write": "PTPU_CHAOS_CKPT_IO",
    "ckpt_read": "PTPU_CHAOS_CKPT_READ",
    "barrier": "PTPU_CHAOS_BARRIER",
    "init_distributed": "PTPU_CHAOS_INIT_FAIL",
}

# site -> remaining injection budget (None until first read of the env)
_budget: Dict[str, Optional[int]] = {}
# global step -> remaining poisoned attempts
_nan_left: Dict[int, int] = {}
_sigterm_fired = False


def reset() -> None:
    """Forget all consumed budgets and re-read the env on next use."""
    global _sigterm_fired
    _budget.clear()
    _nan_left.clear()
    _sigterm_fired = False


reload = reset  # alias: tests set os.environ then chaos.reload()


def _int_env(var: str, default: int = 0) -> int:
    try:
        return int(os.environ.get(var, default))
    except ValueError:
        return default


def maybe_fail(site: str) -> None:
    """Raise an injected fault at `site` while its budget lasts."""
    var = _SITES[site]
    left = _budget.get(site)
    if left is None:
        left = _budget[site] = _int_env(var)
    if left <= 0:
        return
    _budget[site] = left - 1
    resilience_event("chaos_inject", site=site, remaining=left - 1)
    exc = OSError if site.startswith("ckpt") else RuntimeError
    raise exc(f"chaos: injected {site} failure ({var}, {left - 1} left)")


def _proc_index() -> int:
    """PTPU_PROCESS_ID, else the rank in an initialised
    torch.distributed group, else 0."""
    env = os.environ.get("PTPU_PROCESS_ID")
    if env is not None:
        return int(env)
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def maybe_sigterm(step: int) -> None:
    """Deliver SIGTERM to this process at the start of `step` — the
    spot-preemption simulation. Sleeps briefly after os.kill so the
    handler (main thread) runs before the caller's next preemption
    check: the emergency checkpoint then lands at a deterministic step."""
    global _sigterm_fired
    if _sigterm_fired:
        return
    at = _int_env("PTPU_CHAOS_SIGTERM_STEP", -1)
    if at < 0 or step != at:
        return
    proc = _int_env("PTPU_CHAOS_SIGTERM_PROC", -1)
    if proc >= 0 and _proc_index() != proc:
        return
    _sigterm_fired = True
    resilience_event("chaos_inject", site="sigterm", step=step)
    os.kill(os.getpid(), signal.SIGTERM)
    time.sleep(0.05)  # interrupted by the signal; handler has run after


def _nan_window() -> Optional[Tuple[int, int]]:
    spec = os.environ.get("PTPU_CHAOS_NAN_STEP")
    if not spec:
        return None
    lo, _, hi = spec.partition(":")
    return int(lo), int(hi) if hi else int(lo)


def poison_batch(batch: Any, step: int) -> Any:
    """Return `batch` with every floating leaf (tensor or numpy array)
    multiplied by NaN while the per-step attempt budget lasts (a
    bad-host simulation the bad-step guard must absorb). Integer leaves
    (token ids, labels) pass through."""
    window = _nan_window()
    if window is None or not (window[0] <= step <= window[1]):
        return batch
    left = _nan_left.get(step)
    if left is None:
        left = _nan_left[step] = _int_env("PTPU_CHAOS_NAN_ATTEMPTS", 1)
    if left <= 0:
        return batch
    _nan_left[step] = left - 1
    resilience_event("chaos_inject", site="nan", step=step,
                     remaining=left - 1)

    def nanify(x):
        if isinstance(x, torch.Tensor):
            return x * float("nan") if x.is_floating_point() else x
        if hasattr(x, "dtype") and np.issubdtype(x.dtype, np.floating):
            return x * np.nan
        return x
    return map_leaves(nanify, batch)


# -- checkpoint corruption (also used directly by tests + chaos_sweep) ------

def corrupt_truncate_shard(path: str) -> str:
    """Truncate the first shard .npz in checkpoint dir `path` to half —
    a torn write on a shared FS. Returns the mangled file."""
    names = sorted(n for n in os.listdir(path)
                   if n.startswith("shards-p") and n.endswith(".npz"))
    target = os.path.join(path, names[0])
    size = os.path.getsize(target)
    with open(target, "r+b") as f:
        f.truncate(max(1, size // 2))
    return target


def corrupt_flip_manifest(path: str) -> str:
    """Flip bytes in the middle of manifest.json — bit rot / partial
    overwrite. Returns the mangled file."""
    target = os.path.join(path, "manifest.json")
    with open(target, "r+b") as f:
        data = f.read()
        mid = len(data) // 2
        f.seek(mid)
        f.write(bytes(b ^ 0xFF for b in data[mid:mid + 8]))
    return target


def maybe_corrupt_checkpoint(path: str, step: Optional[int]) -> None:
    """Called by CheckpointManager right after a save commits: mangle
    ckpt-{PTPU_CHAOS_CORRUPT_STEP} per PTPU_CHAOS_CORRUPT_MODE."""
    at = _int_env("PTPU_CHAOS_CORRUPT_STEP", -1)
    if at < 0 or step != at:
        return
    mode = os.environ.get("PTPU_CHAOS_CORRUPT_MODE", "truncate")
    target = (corrupt_flip_manifest(path) if mode == "manifest"
              else corrupt_truncate_shard(path))
    resilience_event("chaos_inject", site="corrupt", step=step,
                     mode=mode, file=os.path.basename(target))


# -- fleet KV-transfer corruption (the serve layer's pull path) ------------

def maybe_corrupt_kvxfer(data: bytes) -> bytes:
    """Flip bytes mid-payload in the first PTPU_CHAOS_KVXFER_CORRUPT
    kv-transfer blobs THIS process pulls (the serve layer's KV transfer,
    serve/kvxfer.py, calls it on every fetched /kvblocks body) — bit
    rot on the fleet wire. The
    puller's crc check must reject the blob and fall back to plain
    re-prefill; the chaos matrix (tools/chaos_sweep.py kvxfer:corrupt)
    asserts exactly that. Same budget contract as every other knob:
    deterministic count, armed by env, reset()/reload() re-reads."""
    left = _budget.get("kvxfer_corrupt")
    if left is None:
        left = _budget["kvxfer_corrupt"] = \
            _int_env("PTPU_CHAOS_KVXFER_CORRUPT")
    if left <= 0 or not data:
        return data
    _budget["kvxfer_corrupt"] = left - 1
    resilience_event("chaos_inject", site="kvxfer_corrupt",
                     remaining=left - 1, nbytes=len(data))
    mid = len(data) // 2
    return (data[:mid] + bytes(b ^ 0xFF for b in data[mid:mid + 8])
            + data[mid + 8:])


# -- wire-level chaos: in-process TCP fault proxy ---------------------------

class NetChaosProxy:
    """TCP proxy with a deterministic per-connection fault schedule.

    `NetChaosProxy(upstream_port).start()` listens on an ephemeral
    port; point the router at `http://127.0.0.1:{proxy.port}` and every
    connection is classified ONCE, under the lock, against the
    remaining fault budgets — counters, no RNG, same schedule every
    run — then handled entirely outside it:

      refuse     accept + immediate RST (SO_LINGER 0): the connect-
                 refused path — the router's breaker must count it
      http_503   a canned local `503 chaos` without touching upstream:
                 the retryable-status path
      blackhole  request bytes swallowed, nothing ever written back,
                 socket HELD OPEN — the accept-queue / mid-stream
                 black-hole: only a timeout or a hedge saves the client.
                 `blackhole_after > 0` relays that many response bytes
                 first, turning it into a mid-stream stall
      slow       first response byte delayed `slow_ms` — the straggler
                 a hedged request should beat
      relay      no fault: transparent byte pump both ways

    Budgets load from `PTPU_CHAOS_NET_*` at construction; tests and
    serve_bench can also drive them programmatically via `arm()` /
    `heal()` mid-run (e.g. black-hole one replica while traffic is
    live). `stats()` reports faults actually delivered."""

    _MODES = ("refuse", "http_503", "blackhole", "slow")
    _ENV = {"refuse": "PTPU_CHAOS_NET_REFUSE",
            "http_503": "PTPU_CHAOS_NET_5XX",
            "blackhole": "PTPU_CHAOS_NET_BLACKHOLE",
            "slow": "PTPU_CHAOS_NET_SLOW"}

    def __init__(self, upstream_port: int, upstream_host: str = "127.0.0.1",
                 host: str = "127.0.0.1", port: int = 0):
        self.upstream = (upstream_host, upstream_port)
        self.host = host
        self.port = port
        self._lock = threading.Lock()
        # mode -> remaining injection budget     # guarded-by: self._lock
        self._budget: Dict[str, int] = {
            m: _int_env(self._ENV[m]) for m in self._MODES}
        # mode -> faults delivered               # guarded-by: self._lock
        self._delivered: Dict[str, int] = {m: 0 for m in self._MODES}
        self.blackhole_after = _int_env("PTPU_CHAOS_NET_BLACKHOLE_AFTER")
        self.slow_ms = _int_env("PTPU_CHAOS_NET_SLOW_MS", 200)
        self._lsock: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None
        self._conns: List[socket.socket] = []    # guarded-by: self._lock
        self._closing = False                    # guarded-by: self._lock

    # -- control ------------------------------------------------------------

    def arm(self, mode: str, n: int = 1 << 30) -> None:
        """Set `mode`'s remaining budget to n (default: effectively
        forever, until heal())."""
        if mode not in self._MODES:
            raise ValueError(f"unknown net-chaos mode {mode!r}")
        with self._lock:
            self._budget[mode] = n

    def heal(self) -> None:
        """Clear every fault budget: the proxy becomes a pure relay."""
        with self._lock:
            for m in self._MODES:
                self._budget[m] = 0

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._delivered)

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "NetChaosProxy":
        self._lsock = socket.create_server((self.host, self.port))
        self.port = self._lsock.getsockname()[1]
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True, name="ptpu-net-chaos")
        self._thread.start()
        return self

    def stop(self) -> None:
        with self._lock:
            self._closing = True
            conns, self._conns = self._conns, []
        if self._lsock is not None:
            # shutdown() wakes the accept() the loop thread is blocked in
            # (close() alone does not on Linux, and stop() would then wait
            # out the join's timeout)
            for end in (lambda: self._lsock.shutdown(socket.SHUT_RDWR),
                        self._lsock.close):
                try:
                    end()
                except OSError:
                    pass
        for c in conns:
            try:
                c.close()
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "NetChaosProxy":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    # -- data path ----------------------------------------------------------

    def _classify(self) -> Optional[str]:
        """Spend one fault budget for a fresh connection (priority
        order = _MODES); None == relay cleanly."""
        with self._lock:
            for m in self._MODES:
                if self._budget[m] > 0:
                    self._budget[m] -= 1
                    self._delivered[m] += 1
                    remaining = self._budget[m]
                    break
            else:
                return None
        resilience_event("chaos_net", mode=m, port=self.port,
                         remaining=remaining)
        return m

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _ = self._lsock.accept()
            except OSError:
                return                          # listener closed: stop()
            with self._lock:
                if self._closing:
                    conn.close()
                    return
                self._conns.append(conn)
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()

    def _handle(self, conn: socket.socket) -> None:
        mode = self._classify()
        try:
            if mode == "refuse":
                # linger-0 close turns FIN into RST: a true refusal
                conn.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                                b"\x01\x00\x00\x00\x00\x00\x00\x00")
                conn.close()
                return
            if mode == "http_503":
                self._swallow_request(conn)
                body = b"chaos: injected 503\n"
                conn.sendall(
                    b"HTTP/1.1 503 Service Unavailable\r\n"
                    b"Content-Type: text/plain\r\n"
                    b"Content-Length: " + str(len(body)).encode() +
                    b"\r\nConnection: close\r\n\r\n" + body)
                conn.close()
                return
            if mode == "blackhole" and self.blackhole_after <= 0:
                # swallow forever: recv until the CLIENT gives up
                while conn.recv(65536):
                    pass
                conn.close()
                return
            self._relay(conn, mode)
        except OSError:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _swallow_request(self, conn: socket.socket) -> None:
        """Read until the request head is plausibly complete (blank
        line) so the client never sees a write error before our
        response."""
        buf = b""
        conn.settimeout(1.0)
        try:
            while b"\r\n\r\n" not in buf:
                chunk = conn.recv(65536)
                if not chunk:
                    return
                buf += chunk
        except socket.timeout:
            return

    def _relay(self, conn: socket.socket, mode: Optional[str]) -> None:
        """Transparent pump, with the slow / mid-stream-blackhole faults
        applied to the upstream->client direction."""
        up = socket.create_connection(self.upstream, timeout=10)
        with self._lock:
            if self._closing:
                up.close()
                return
            self._conns.append(up)
        stop_fwd = threading.Event()

        def pump_up() -> None:                  # client -> upstream
            try:
                while True:
                    data = conn.recv(65536)
                    if not data:
                        break
                    up.sendall(data)
                try:
                    up.shutdown(socket.SHUT_WR)
                except OSError:
                    pass
            except OSError:
                pass

        def pump_down() -> None:                # upstream -> client
            sent = 0
            first = True
            try:
                while True:
                    data = up.recv(65536)
                    if not data:
                        break
                    if stop_fwd.is_set():
                        continue                # black-holed mid-stream
                    if first and mode == "slow":
                        time.sleep(self.slow_ms / 1000.0)
                    first = False
                    if mode == "blackhole":
                        room = self.blackhole_after - sent
                        if room <= 0:
                            stop_fwd.set()
                            continue
                        data = data[:room]
                    conn.sendall(data)
                    sent += len(data)
                if not stop_fwd.is_set():
                    try:
                        conn.shutdown(socket.SHUT_WR)
                    except OSError:
                        pass
            except OSError:
                pass

        t_up = threading.Thread(target=pump_up, daemon=True)
        t_down = threading.Thread(target=pump_down, daemon=True)
        t_up.start()
        t_down.start()
        t_up.join()
        t_down.join()
        try:
            up.close()
        except OSError:
            pass
