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
checkpoint. The port writes as one process (`shards-p0.npz`, every leaf
whole); it reads the pieces of any process count.

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

import json
import os
import re
import shutil
import tempfile
import threading
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

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

def _snapshot(tree) -> Tuple[List[dict], Dict[str, np.ndarray],
                             List[dict]]:
    """Every leaf of `tree` as host numpy that nothing else references:
    (the leaves' manifest records, {slot: array}, the shard index; every
    leaf whole). Each card that holds a leaf is synchronised first, so
    that a value still being written on any of its streams (a side
    stream included) has landed; the CUDA tensors are then copied into
    pinned host buffers by non-blocking copies on the current stream,
    which is synchronised once; everything else is copied. Returns only
    when every copy has landed."""
    flat = flatten_with_keys(tree)
    devices = {leaf.device for _, leaf in flat
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)
    leaves, shards, index = [], {}, []
    for i, (key, leaf) in enumerate(flat):
        slot = f"a{i}_s{i}"
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach()
            if leaf.dtype == torch.bfloat16:
                raise TypeError(f"leaf {key!r} is bfloat16, which numpy "
                                "cannot hold; cast it to float32")
            if leaf.is_cuda:
                buf = torch.empty(leaf.shape, dtype=leaf.dtype,
                                  pin_memory=True)
                buf.copy_(leaf, non_blocking=True)
                arr = buf.numpy()
            else:
                arr = leaf.numpy().copy()
        else:
            arr = np.array(leaf, copy=True)
        shards[slot] = arr
        leaves.append({"key": key, "shape": list(arr.shape),
                       "dtype": str(arr.dtype)})
        index.append({"leaf": i, "slot": slot,
                      "index": [[0, d] for d in arr.shape]})
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()
    return leaves, shards, index


def _write_snapshot(path: str, snap, step: Optional[int],
                    metadata: Optional[Dict]) -> str:
    """The file and commit phase over a host snapshot (no device access;
    safe on a background thread): stage in a temporary directory beside
    `path`, record each file's CRC32 and size in the manifest, then
    rename into place."""
    leaves, shards, index = snap
    tmp = tempfile.mkdtemp(dir=os.path.dirname(os.path.abspath(path)) or ".")
    try:
        def write_shards():
            _chaos.maybe_fail("ckpt_write")
            np.savez(os.path.join(tmp, "shards-p0.npz"), **shards)
            with open(os.path.join(tmp, "shard_index-p0.json"), "w") as f:
                json.dump(index, f)
        retry_call(write_shards, policy=_IO_RETRY, name="ckpt_write",
                   budget=shared_budget())
        files = {}
        for name in ("shard_index-p0.json", "shards-p0.npz"):
            crc, size = _crc32_file(os.path.join(tmp, name))
            files[name] = {"crc32": crc, "bytes": size}
        manifest = {"version": 2,
                    "step": None if step is None else int(step),
                    "metadata": metadata or {}, "process_count": 1,
                    "files": files, "leaves": leaves}
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
    except BaseException:
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


def _read_leaves(path: str, manifest: dict, wanted: List[int]
                 ) -> Dict[int, np.ndarray]:
    """The leaves of ordinals `wanted`, each assembled from its pieces."""
    sums = manifest.get("files") or {}
    files: Dict[str, Any] = {}
    out = {}
    try:
        table = _pieces(path, manifest)
        for i in wanted:
            leaf = manifest["leaves"][i]
            shape = tuple(leaf["shape"])
            arr = np.zeros(shape, np.dtype(leaf["dtype"]))
            filled = np.zeros(shape, bool)
            for spans, fname, slot in table.get(i, []):
                if fname not in files:
                    _verify(path, fname, sums)

                    def load(fname=fname):
                        _chaos.maybe_fail("ckpt_read")
                        return np.load(os.path.join(path, fname))
                    files[fname] = retry_call(load, policy=_IO_RETRY,
                                              name="ckpt_read",
                                              budget=shared_budget())
                region = tuple(slice(a, b) for a, b in spans)
                arr[region] = files[fname][slot]
                filled[region] = True
            if not filled.all():
                raise ValueError(f"checkpoint {path}: leaf {leaf['key']!r} "
                                 "is not covered by its shard pieces")
            out[i] = arr
    finally:
        for npz in files.values():
            npz.close()
    return out


def _like(arr: np.ndarray, ref):
    """A loaded leaf in the form of its target leaf: a tensor of the
    target's dtype on its device, numpy of its dtype, or numpy."""
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
    dtype, tensors on the target's device. A shard file whose CRC32 or
    size disagrees with the manifest raises CheckpointIntegrityError."""
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    key_to_leaf = {leaf["key"]: i
                   for i, leaf in enumerate(manifest["leaves"])}
    if target is None:
        arrays = _read_leaves(path, manifest, list(range(len(key_to_leaf))))
        return nest({key: arrays[i] for key, i in key_to_leaf.items()})
    flat = flatten_with_keys(target)
    missing = [k for k, _ in flat if k not in key_to_leaf]
    if missing:
        raise FileNotFoundError(f"checkpoint {path} missing {len(missing)} "
                                f"leaves, e.g. {missing[:5]}")
    for key, ref in flat:
        shape = tuple(manifest["leaves"][key_to_leaf[key]]["shape"])
        if shape != tuple(np.shape(ref)):
            raise ValueError(f"leaf {key}: checkpoint shape {shape} != "
                             f"target {tuple(np.shape(ref))}")
    arrays = _read_leaves(path, manifest, [key_to_leaf[k] for k, _ in flat])
    return unflatten_like(target, iter(
        _like(arrays[key_to_leaf[k]], ref) for k, ref in flat))


def read_metadata(path: str) -> Dict:
    """The manifest's metadata dict, without loading any data."""
    with open(os.path.join(path, _MANIFEST)) as f:
        return json.load(f).get("metadata", {}) or {}


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
        # saves once the port writes across processes; sweep them
        # before any save starts, as JAX's manager does.
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
        # content the files no longer have
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
