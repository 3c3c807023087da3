"""Checkpoints in the JAX package's format, written and read with numpy
only (the port's own copy of paddle_tpu/io/checkpoint.py,
single-process).

Format version 2 (a directory):
    manifest.json           {"version": 2, "step": S, "metadata": {...},
                             "process_count": P, "files": {fname:
                             {"crc32", "bytes"}}, "leaves": [{"key",
                             "shape", "dtype"}, ...]}
    shards-p{K}.npz         the pieces process K owned, by slot name
    shard_index-p{K}.json   [{"leaf": i, "slot": name,
                              "index": [[start, stop], ...]}, ...]
Each leaf is assembled from every piece whose index slices cover part
of it; a leaf left incomplete raises. Format version 1 (read only):
manifest.json whose leaves carry a "slot" each, and one arrays.npz
holding every leaf whole.

Leaves are keyed as JAX's pytree paths join them (utils/tree.py): a
`TrainState` is written under `0/...` (params), `1/...` (state),
`2/slots/...` and `2/step`, and `3`, so each package reads the other's
checkpoint.

Across processes (a `torch.distributed` world, one process a rank) every
rank writes its own pieces to `shards-p{rank}.npz` and
`shard_index-p{rank}.json`: a leaf that is a `Piece` (parallel/sharding,
what `MeshTrainer.state()` gives) writes its data under its index when
the rank owns it (the lowest of the ranks holding that part, as JAX
writes replica 0), any other leaf is written whole by rank 0. The ranks
stage into `<path>.ptmp` and meet at barriers between the stage, shard
and commit phases; rank 0 records every file's CRC32 and the
`process_count` in the manifest and renames the directory into place.
The barriers go over the process group's TCP store (a key per rank and
a per-name sequence; the `barrier` chaos site; retried), never as a
c10d collective, so `AsyncCheckpointer`'s worker thread can run them
while the main thread keeps training. A rank that fails drops a marker
(`<path>.err-p{rank}`) before the next barrier and every rank checks for
markers after it, so one bad disk raises everywhere instead of hanging.

`load_checkpoint(path, target=trainer.state())` reads only each Piece's
own region, from a checkpoint of any process count and any geometry.

`save_checkpoint` takes its snapshot on the calling thread before it
returns anything: the port's optimizers update parameters and slots in
place, so a writer that held the tensors would write a later step's
values. `AsyncCheckpointer` writes that snapshot on a background thread;
`CheckpointManager` adds `ckpt-{step}` directories, `max_to_keep`
rotation and a restore that falls back over a corrupt newest checkpoint.

Shard writes and shard reads go through `retry_call` (shared-FS
hiccups: bounded retries on OSError, drawn from the process's shared
retry budget), with the `ckpt_write` / `ckpt_read` chaos sites inside
the retried call; content errors (a CRC mismatch) are not retried.
"""

from __future__ import annotations

import datetime
import glob
import json
import math
import os
import re
import shutil
import tempfile
import threading
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from paddle_tpu_torch.resilience import chaos as _chaos
from paddle_tpu_torch.resilience.retry import (RetryPolicy, retry_call,
                                               shared_budget)
from paddle_tpu_torch.utils.log import resilience_event
from paddle_tpu_torch.utils.tree import (flatten_with_keys, nest,
                                         unflatten_like)

_MANIFEST = "manifest.json"
_ARRAYS = "arrays.npz"
_CKPT_RE = re.compile(r"^ckpt-(\d+)$")

# Shared-FS writes/reads see transient errors (NFS timeouts, object-store
# 5xx); bounded retries here, content errors (CRC) are NOT retryable.
_IO_RETRY = RetryPolicy(attempts=3, base_delay=0.1, max_delay=2.0,
                        retry_on=(OSError,))
# A barrier re-wait sets the same per-rank key again (idempotent), but a
# deadline error means the peers moved on: re-waiting can only hang.
_BARRIER_RETRY = RetryPolicy(
    attempts=2, base_delay=0.2, max_delay=2.0, retry_on=(RuntimeError,),
    giveup=lambda e: "deadline" in str(e).lower()
    or "timed out" in str(e).lower() or "timeout" in str(e).lower())
_BARRIER_TIMEOUT_S = 600.0


def _world() -> Tuple[int, int]:
    """(this process's rank, the process count) of the torch.distributed
    world, (0, 1) alone."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


_barrier_lock = threading.Lock()
_barrier_seq: Dict[str, int] = {}   # per-barrier-name use counts


def _barrier(name: str) -> None:
    """A cross-process barrier over the default group's TCP store: each
    rank sets its own key and waits for every rank's. Not a c10d
    collective, so an async save's worker thread can meet its peers
    while the main thread runs the training step's collectives. The
    per-NAME sequence (the name embeds the path and the stage)
    disambiguates repeated saves to one path without coupling
    independent save streams."""
    rank, count = _world()
    if count <= 1:
        return
    store = dist.distributed_c10d._get_default_store()
    with _barrier_lock:
        seq = _barrier_seq.get(name, 0)
        _barrier_seq[name] = seq + 1
    key = f"ptpu-ckpt:{seq}:{name}"

    def wait():
        _chaos.maybe_fail("barrier")
        store.set(f"{key}/{rank}", "1")
        store.wait([f"{key}/{r}" for r in range(count)],
                   datetime.timedelta(seconds=_BARRIER_TIMEOUT_S))
    retry_call(wait, policy=_BARRIER_RETRY, name="barrier",
               budget=shared_budget())


# -- failure markers around the barriers ---------------------------------

def _marker(path: str, proc: int) -> str:
    return os.path.abspath(path) + f".err-p{proc}"


def _mark_failure(path: str, proc: int, exc: BaseException) -> None:
    try:
        with open(_marker(path, proc), "w") as f:
            f.write(f"{type(exc).__name__}: {exc}")
    except OSError:
        pass  # the check below still sees this rank's own exception


def _check_failures(path: str) -> None:
    markers = sorted(glob.glob(glob.escape(os.path.abspath(path))
                               + ".err-p*"))
    if markers:
        msgs = []
        for m in markers:
            try:
                with open(m) as f:
                    msgs.append(f"{os.path.basename(m)}: {f.read()}")
            except OSError:
                msgs.append(os.path.basename(m))
        raise RuntimeError(
            f"checkpoint save to {path} failed on a peer process:\n  "
            + "\n  ".join(msgs))


def _clear_markers(path: str) -> None:
    for m in glob.glob(glob.escape(os.path.abspath(path)) + ".err-p*"):
        try:
            os.remove(m)
        except OSError:
            pass


class CheckpointIntegrityError(RuntimeError, ValueError):
    """A checkpoint on disk whose content cannot be trusted: a missing
    file, or a CRC32 or size that disagrees with the manifest (a torn
    write, bit rot). `CheckpointManager.restore_latest` skips it. A
    RuntimeError as in JAX, and a ValueError as the port's reader raised
    before it had this class."""


def _crc32_file(path: str) -> Tuple[int, int]:
    crc, size = 0, 0
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            crc = zlib.crc32(block, crc)
            size += len(block)
    return crc, size


def _verify(path: str, fname: str, sums: Dict[str, dict]) -> None:
    meta = sums.get(fname)
    if meta is None:            # v1 and older v2 manifests carry no sums
        return
    full = os.path.join(path, fname)
    if not os.path.exists(full):
        raise CheckpointIntegrityError(f"checkpoint {path}: missing {fname}")
    crc, size = _crc32_file(full)
    if crc != meta["crc32"] or size != meta["bytes"]:
        raise CheckpointIntegrityError(
            f"checkpoint {path}: {fname} corrupt (crc32 {crc:#x}, {size} "
            f"bytes; manifest says {meta['crc32']:#x}, {meta['bytes']} "
            "bytes)")


# -- writing ------------------------------------------------------------

def _host_copy(leaf, key: str) -> np.ndarray:
    """A host numpy copy of a tensor (a pinned non-blocking copy from the
    card), an array or a scalar."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            raise TypeError(f"leaf {key!r} is bfloat16, which numpy "
                            "cannot hold; cast it to float32")
        if leaf.is_cuda:
            buf = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=True)
            buf.copy_(leaf, non_blocking=True)
            return buf.numpy()
        return leaf.numpy().copy()
    return np.array(leaf, copy=True)


def _snapshot(tree) -> Tuple[List[dict], Dict[str, np.ndarray],
                             List[dict], int, int]:
    """The pieces of `tree` this process writes, as host numpy that
    nothing else references: (the leaves' manifest records, {slot:
    array}, the shard index, this rank, the process count). A `Piece`
    leaf writes its data under its index when this rank owns it; any
    other leaf is written whole by rank 0. Each card that holds a leaf
    is synchronised first, so a value still being written on any of its
    streams has landed; CUDA tensors are copied into pinned host buffers
    by non-blocking copies on the current stream, which is synchronised
    once. Returns only when every copy has landed."""
    from paddle_tpu_torch.parallel.sharding import Piece
    rank, count = _world()
    flat = flatten_with_keys(tree)

    def data(leaf):
        return leaf.data if isinstance(leaf, Piece) else leaf
    devices = {data(leaf).device for _, leaf in flat
               if isinstance(data(leaf), torch.Tensor)
               and data(leaf).is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)
    leaves, shards, index = [], {}, []
    for i, (key, leaf) in enumerate(flat):
        if isinstance(leaf, Piece):
            shape = leaf.shape
            dtype = str(_host_dtype(leaf.data))
            if leaf.owner:
                slot = f"a{i}_s{len(index)}"
                shards[slot] = _host_copy(leaf.data, key)
                index.append({"leaf": i, "slot": slot,
                              "index": leaf.spans()})
        else:
            if rank == 0:
                arr = _host_copy(leaf, key)
                slot = f"a{i}_s{len(index)}"
                shards[slot] = arr
                index.append({"leaf": i, "slot": slot,
                              "index": [[0, d] for d in arr.shape]})
            shape = tuple(np.shape(leaf))
            dtype = str(_host_dtype(leaf))
        leaves.append({"key": key, "shape": list(shape), "dtype": dtype})
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()
    return leaves, shards, index, rank, count


def _host_dtype(leaf) -> np.dtype:
    if isinstance(leaf, torch.Tensor):
        return torch.empty((), dtype=leaf.dtype).numpy().dtype
    return np.asarray(leaf).dtype


def _write_snapshot(path: str, snap, step: Optional[int],
                    metadata: Optional[Dict]) -> str:
    """The file and commit phase over a host snapshot (no device access;
    safe on a background thread): stage, record each file's CRC32 and
    size in the manifest, then rename into place. Across processes the
    ranks stage into one `<path>.ptmp` and meet at the stage, shard and
    commit barriers, rank 0 writing the manifest and renaming."""
    leaves, shards, index, rank, count = snap
    multi = count > 1
    if multi:
        tmp = os.path.abspath(path) + ".ptmp"
        if rank == 0:
            _clear_markers(path)
            try:
                shutil.rmtree(tmp, ignore_errors=True)
                os.makedirs(tmp, exist_ok=True)
            except BaseException as e:
                _mark_failure(path, rank, e)
        _barrier(f"ckpt-stage:{path}")
        _check_failures(path)
    else:
        _clear_markers(path)
        tmp = tempfile.mkdtemp(
            dir=os.path.dirname(os.path.abspath(path)) or ".")
    sname, iname = f"shards-p{rank}.npz", f"shard_index-p{rank}.json"
    try:
        try:
            def write_shards():
                _chaos.maybe_fail("ckpt_write")
                np.savez(os.path.join(tmp, sname), **shards)
                with open(os.path.join(tmp, iname), "w") as f:
                    json.dump(index, f)
            retry_call(write_shards, policy=_IO_RETRY, name="ckpt_write",
                       budget=shared_budget())
        except BaseException as e:
            if multi:
                _mark_failure(path, rank, e)
            raise
        finally:
            _barrier(f"ckpt-shards:{path}")
        _check_failures(path)
        if rank == 0:
            try:
                files = {}
                for p in range(count):
                    for name in (f"shard_index-p{p}.json",
                                 f"shards-p{p}.npz"):
                        crc, size = _crc32_file(os.path.join(tmp, name))
                        files[name] = {"crc32": crc, "bytes": size}
                manifest = {"version": 2,
                            "step": None if step is None else int(step),
                            "metadata": metadata or {},
                            "process_count": count,
                            "files": files, "leaves": leaves}
                with open(os.path.join(tmp, _MANIFEST), "w") as f:
                    json.dump(manifest, f, indent=1)
                if os.path.isdir(path):
                    shutil.rmtree(path)
                os.replace(tmp, path)
            except BaseException as e:
                if multi:
                    _mark_failure(path, rank, e)
                raise
            finally:
                _barrier(f"ckpt-commit:{path}")
        else:
            _barrier(f"ckpt-commit:{path}")
        _check_failures(path)
    except BaseException:
        if rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)
        raise
    return path


def save_checkpoint(path: str, tree, step: Optional[int] = None,
                    metadata: Optional[Dict] = None) -> str:
    """Write `tree` (nested dicts, lists, a `TrainState`; tensor, numpy
    or scalar leaves) to directory `path` atomically. Returns the path."""
    return _write_snapshot(path, _snapshot(tree), step, metadata)


# -- reading ------------------------------------------------------------

def _pieces(path: str, manifest: dict
            ) -> Dict[int, List[Tuple[List[List[int]], str, str]]]:
    """leaf ordinal -> [(index spans, file, slot)]."""
    if manifest.get("version", 1) == 1:
        return {i: [([[0, d] for d in leaf["shape"]], _ARRAYS,
                     leaf["slot"])]
                for i, leaf in enumerate(manifest["leaves"])}
    sums = manifest.get("files") or {}
    out: Dict[int, list] = {}
    for p in range(manifest.get("process_count", 1)):
        iname = f"shard_index-p{p}.json"
        _verify(path, iname, sums)
        with open(os.path.join(path, iname)) as f:
            for rec in json.load(f):
                out.setdefault(rec["leaf"], []).append(
                    (rec["index"], f"shards-p{p}.npz", rec["slot"]))
    return out


def _read_leaves(path: str, manifest: dict,
                 wanted: Dict[int, Optional[List[List[int]]]]
                 ) -> Dict[int, np.ndarray]:
    """The leaves of ordinals `wanted`, each the region given ([[start,
    stop], ...] per dim; None for the whole leaf) assembled from the
    pieces that overlap it. Only the shard files those pieces live in
    are opened (and verified)."""
    sums = manifest.get("files") or {}
    files: Dict[str, Any] = {}
    out = {}
    try:
        table = _pieces(path, manifest)
        for i, region in wanted.items():
            leaf = manifest["leaves"][i]
            want = region or [[0, d] for d in leaf["shape"]]
            rshape = tuple(b - a for a, b in want)
            arr = np.zeros(rshape, np.dtype(leaf["dtype"]))
            filled = 0
            for spans, fname, slot in table.get(i, []):
                inter = [(max(a, c), min(b, d))
                         for (a, b), (c, d) in zip(want, spans)]
                if any(lo >= hi for lo, hi in inter):
                    continue
                if fname not in files:
                    _verify(path, fname, sums)

                    def load(fname=fname):
                        _chaos.maybe_fail("ckpt_read")
                        return np.load(os.path.join(path, fname))
                    files[fname] = retry_call(load, policy=_IO_RETRY,
                                              name="ckpt_read",
                                              budget=shared_budget())
                dst = tuple(slice(lo - a, hi - a)
                            for (lo, hi), (a, _) in zip(inter, want))
                src = tuple(slice(lo - c, hi - c)
                            for (lo, hi), (c, _) in zip(inter, spans))
                arr[dst] = files[fname][slot][src]
                filled += math.prod(hi - lo for lo, hi in inter)
            if filled < math.prod(rshape):
                raise ValueError(f"checkpoint {path}: leaf {leaf['key']!r} "
                                 "is not covered by its shard pieces")
            out[i] = arr
    finally:
        for npz in files.values():
            npz.close()
    return out


def _like(arr: np.ndarray, ref):
    """A loaded leaf in the form of its target leaf: a Piece of the
    target's index, a tensor of the target's dtype on its device, numpy
    of its dtype, or numpy."""
    from paddle_tpu_torch.parallel.sharding import Piece
    if isinstance(ref, Piece):
        return Piece(_like(arr, ref.data), ref.shape, ref.index, ref.owner)
    if isinstance(ref, torch.Tensor):
        return torch.from_numpy(arr).to(device=ref.device, dtype=ref.dtype)
    if isinstance(ref, np.ndarray):
        return arr.astype(ref.dtype, copy=False)
    return arr


def load_checkpoint(path: str, target=None):
    """Load the checkpoint directory `path` (paddle_tpu/io/checkpoint.py:486).

    Without `target`, every leaf as numpy in a nested dict keyed by the
    "/"-split keys, e.g. {"params": {"embed": {"weight": array}}}. With
    `target` (a tree of tensors or arrays, such as `Trainer.state()`)
    the result mirrors its structure: a target leaf the checkpoint lacks
    raises FileNotFoundError (as JAX's does), a shape that differs
    raises ValueError, and each leaf comes back in its target leaf's
    dtype, tensors on the target's device. A `Piece` leaf (a rank's part,
    as `MeshTrainer.state()` gives) reads only its own region and comes
    back as a Piece. A shard file whose CRC32 or size disagrees with the
    manifest raises CheckpointIntegrityError."""
    from paddle_tpu_torch.parallel.sharding import Piece
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    key_to_leaf = {leaf["key"]: i
                   for i, leaf in enumerate(manifest["leaves"])}
    if target is None:
        arrays = _read_leaves(path, manifest,
                              dict.fromkeys(range(len(key_to_leaf))))
        return nest({key: arrays[i] for key, i in key_to_leaf.items()})
    flat = flatten_with_keys(target)
    missing = [k for k, _ in flat if k not in key_to_leaf]
    if missing:
        raise FileNotFoundError(f"checkpoint {path} missing {len(missing)} "
                                f"leaves, e.g. {missing[:5]}")
    for key, ref in flat:
        shape = tuple(manifest["leaves"][key_to_leaf[key]]["shape"])
        want = ref.shape if isinstance(ref, Piece) else tuple(np.shape(ref))
        if shape != tuple(want):
            raise ValueError(f"leaf {key}: checkpoint shape {shape} != "
                             f"target {tuple(want)}")
    arrays = _read_leaves(path, manifest, {
        key_to_leaf[k]: ref.spans() if isinstance(ref, Piece) else None
        for k, ref in flat})
    return unflatten_like(target, iter(
        _like(arrays[key_to_leaf[k]], ref) for k, ref in flat))


def read_metadata(path: str) -> Dict:
    """The manifest's metadata dict, without loading any data."""
    with open(os.path.join(path, _MANIFEST)) as f:
        return json.load(f).get("metadata", {}) or {}


# Fluid-compatible aliases (io.py save_persistables / load_persistables),
# as JAX's checkpoint.py:579-581 keeps them
save_persistables = save_checkpoint
load_persistables = load_checkpoint


def list_checkpoints(directory: str) -> List[Tuple[int, str]]:
    """Committed checkpoints as [(step, path)], NEWEST first: only exact
    `ckpt-{step}` names that hold a manifest."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = _CKPT_RE.match(name)
        if m and os.path.exists(os.path.join(directory, name, _MANIFEST)):
            out.append((int(m.group(1)), os.path.join(directory, name)))
    out.sort(reverse=True)
    return out


def latest_checkpoint(directory: str) -> Optional[str]:
    ckpts = list_checkpoints(directory)
    return ckpts[0][1] if ckpts else None


def checkpoint_step(path: str) -> Optional[int]:
    """The manifest's recorded step (None for stepless saves)."""
    with open(os.path.join(path, _MANIFEST)) as f:
        return json.load(f).get("step")


def verify_checkpoint(path: str) -> Dict:
    """Validate a committed checkpoint end to end and return its
    manifest: the manifest parses, every recorded file exists, and every
    CRC32 and size matches (checkpoints without sums pass on the
    existence of their files). Raises CheckpointIntegrityError with the
    first failure."""
    try:
        with open(os.path.join(path, _MANIFEST)) as f:
            manifest = json.load(f)
    except OSError as e:
        raise CheckpointIntegrityError(
            f"checkpoint {path}: manifest unreadable ({e})") from e
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CheckpointIntegrityError(
            f"checkpoint {path}: manifest is not valid JSON ({e})") from e
    files = manifest.get("files")
    if files:
        for fname in sorted(files):
            _verify(path, fname, files)
    else:
        names = ([_ARRAYS] if manifest.get("version", 1) == 1 else
                 [f"{kind}-p{p}.{ext}"
                  for p in range(manifest.get("process_count", 1))
                  for kind, ext in (("shards", "npz"),
                                    ("shard_index", "json"))])
        for fname in names:
            if not os.path.exists(os.path.join(path, fname)):
                raise CheckpointIntegrityError(
                    f"checkpoint {path}: missing {fname}")
    return manifest


# -- background writes and the manager ------------------------------------

class AsyncCheckpointer:
    """Checkpoint writes on a background thread
    (paddle_tpu/io/checkpoint.py:658). `save` takes the host snapshot ON
    THE CALLING THREAD (the next train step updates the tensors in
    place) and hands the file writes to a worker thread.

    Single-writer ordering: a save while one is in flight joins it
    first. A background failure re-raises on the next save() or wait().
    Call wait() before reading the checkpoint back."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, path: str, tree, step: Optional[int] = None,
             metadata: Optional[Dict] = None,
             _after: Optional[Callable[[], None]] = None) -> str:
        self.wait()
        snap = _snapshot(tree)

        def work():
            try:
                _write_snapshot(path, snap, step, metadata)
                if _after is not None:
                    _after()
            except BaseException as e:  # surfaced on next save()/wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True,
                                        name="ptpu-async-ckpt")
        self._thread.start()
        return path

    def wait(self) -> None:
        """Join the in-flight write; re-raise its failure, if any."""
        t, self._thread = self._thread, None
        if t is not None:
            t.join()
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint save failed") from err


class CheckpointManager:
    """`ckpt-{step}` directories under `directory`, the newest
    `max_to_keep` kept (paddle_tpu/io/checkpoint.py:706).

    `async_save=True` routes saves through AsyncCheckpointer: `save`
    returns once the snapshot is on the host, and the write and the
    rotation run behind training. `wait()` (also called by
    restore_latest) drains the write in flight."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 async_save: bool = False):
        self.directory = directory
        self.max_to_keep = max_to_keep
        self._async = AsyncCheckpointer() if async_save else None
        os.makedirs(directory, exist_ok=True)
        # Failure markers (`ckpt-{step}.err-p{K}`) a crashed multi-process
        # save of a previous run left behind would poison this run's
        # saves; sweep them before any save starts, as JAX's manager
        # does.
        for name in os.listdir(directory):
            if ".err-p" in name:
                try:
                    os.remove(os.path.join(directory, name))
                except OSError:
                    pass

    def save(self, tree, step: int, metadata: Optional[Dict] = None) -> str:
        path = os.path.join(self.directory, f"ckpt-{step}")
        if self._async is not None:
            return self._async.save(
                path, tree, step=step, metadata=metadata,
                _after=lambda: self._post_commit(path, step))
        save_checkpoint(path, tree, step=step, metadata=metadata)
        self._post_commit(path, step)
        return path

    def _post_commit(self, path: str, step: int) -> None:
        # chaos corruption happens AFTER commit, so a torn-checkpoint
        # scenario matches a real torn write: the manifest promises
        # content the files no longer have; once, by rank 0
        if _world()[0] == 0:
            _chaos.maybe_corrupt_checkpoint(path, step)
        self._gc()

    def wait(self) -> None:
        if self._async is not None:
            self._async.wait()

    def restore_latest(self, target=None) -> Tuple[Any, Optional[int]]:
        """(tree, step) of the newest INTACT checkpoint, or (None, None).
        A newest one that fails verification, cannot be read or does not
        fit `target` is rejected with a `ckpt_reject` event on the
        `resilience` stream, and the next-newest is tried."""
        self.wait()   # an in-flight async save IS the latest checkpoint
        for step, path in list_checkpoints(self.directory):
            try:
                manifest = verify_checkpoint(path)
                return load_checkpoint(path, target), manifest.get("step")
            except (CheckpointIntegrityError, OSError, ValueError,
                    KeyError) as e:
                resilience_event("ckpt_reject",
                                 ckpt=os.path.basename(path), step=step,
                                 reason=f"{type(e).__name__}: {e}")
        return None, None

    def _gc(self) -> None:
        steps = sorted(int(m.group(1)) for m in
                       map(_CKPT_RE.match, os.listdir(self.directory)) if m)
        for step in steps[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, f"ckpt-{step}"),
                          ignore_errors=True)
