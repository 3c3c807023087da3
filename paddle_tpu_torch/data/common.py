"""Dataset cache utilities (the port's own copy of
paddle_tpu/data/common.py, pure Python).

Capability-equivalent of Paddle's python/paddle/dataset/common.py
(DATA_HOME cache dir, md5file integrity check, download, split /
cluster_files_reader for sharded file sets). `download` verifies a
pre-placed file instead of fetching: nothing is downloaded, and the
cache layout and integrity contract are the same.
"""

from __future__ import annotations

import glob as _glob
import hashlib
import os
import pickle
from typing import Any, Callable, Iterator, List, Optional

from paddle_tpu_torch.utils.flags import FLAGS


def data_home() -> str:
    """≈ common.DATA_HOME."""
    return FLAGS.get("data_dir")


def md5file(fname: str) -> str:
    """Streaming md5 of a file (common.py md5file)."""
    h = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def download(url: str, module_name: str, md5sum: Optional[str] = None,
             save_name: Optional[str] = None) -> str:
    """Resolve (and verify) a dataset file in the cache
    (common.py download). No egress here: the file must already exist
    under data_home()/module_name; a missing file raises with the exact
    path + URL the operator should fetch out-of-band."""
    fname = save_name or url.split("/")[-1]
    path = os.path.join(data_home(), module_name, fname)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"dataset file {path!r} not found and this environment has no "
            f"network egress; fetch {url!r} out-of-band and place it there")
    if md5sum and md5file(path) != md5sum:
        raise IOError(f"md5 mismatch for {path!r} (corrupt download?)")
    return path


def split(reader: Callable, line_count: int, suffix: str = "%05d.pickle",
          dumper: Callable = None) -> List[str]:
    """Split a reader into pickled chunk files (common.py split) — the
    pre-sharding step for cluster training file assignment."""
    dumper = dumper or pickle.dump
    out, lines, index = [], [], 0
    base = suffix if "%" in suffix else suffix + "-%05d"

    def flush():
        nonlocal lines, index
        if not lines:
            return
        name = base % index
        with open(name, "wb") as f:
            dumper(lines, f)
        out.append(name)
        lines = []
        index += 1

    for item in reader():
        lines.append(item)
        if len(lines) >= line_count:
            flush()
    flush()
    return out


def cluster_files_reader(files_pattern: str, trainer_count: int,
                         trainer_id: int,
                         loader: Callable = None) -> Callable:
    """Round-robin file assignment per trainer (common.py
    cluster_files_reader): trainer k reads files [k::trainer_count] —
    the file-level data sharding the pserver mode used, each process
    reading its own files."""
    loader = loader or pickle.load

    def reader() -> Iterator[Any]:
        files = sorted(_glob.glob(files_pattern))
        my = files[trainer_id::trainer_count]
        for fname in my:
            with open(fname, "rb") as f:
                for item in loader(f):
                    yield item
    return reader
