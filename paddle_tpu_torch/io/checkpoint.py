"""Read a checkpoint written by the JAX package, with numpy only (its own
copy of the format of paddle_tpu/io/checkpoint.py:18-33, 486-512).

Format version 2 (a directory):
    manifest.json           {"version": 2, "process_count": P,
                             "leaves": [{"key", "shape", "dtype"}, ...],
                             "files": {fname: {"crc32", "bytes"}}, ...}
    shards-p{K}.npz         the pieces process K owned, by slot name
    shard_index-p{K}.json   [{"leaf": i, "slot": name,
                              "index": [[start, stop], ...]}, ...]
Each leaf is assembled from every piece whose index slices cover part
of it; a leaf left incomplete raises.

Format version 1: manifest.json whose leaves carry a "slot" each, and
one arrays.npz holding every leaf whole.

`load_checkpoint(path)` returns a nested dict keyed by the "/"-split
leaf keys, e.g. {"params": {"embed": {"weight": array}}}, which is
what models/convert.py's `load_jax_params` takes. A shard file whose
CRC32 or size disagrees with the manifest's record raises.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Dict, List, Tuple

import numpy as np

_MANIFEST = "manifest.json"
_ARRAYS = "arrays.npz"


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
    crc, size = _crc32_file(os.path.join(path, fname))
    if crc != meta["crc32"] or size != meta["bytes"]:
        raise ValueError(f"checkpoint {path}: {fname} corrupt (crc32 "
                         f"{crc:#x}, {size} bytes; manifest says "
                         f"{meta['crc32']:#x}, {meta['bytes']} bytes)")


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


def load_checkpoint(path: str) -> Dict:
    """Every leaf of the checkpoint at `path` as numpy, nested by key."""
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    sums = manifest.get("files") or {}
    files: Dict[str, np.lib.npyio.NpzFile] = {}
    out: Dict = {}
    try:
        table = _pieces(path, manifest)
        for i, leaf in enumerate(manifest["leaves"]):
            shape = tuple(leaf["shape"])
            arr = np.zeros(shape, np.dtype(leaf["dtype"]))
            filled = np.zeros(shape, bool)
            for spans, fname, slot in table.get(i, []):
                if fname not in files:
                    _verify(path, fname, sums)
                    files[fname] = np.load(os.path.join(path, fname))
                region = tuple(slice(a, b) for a, b in spans)
                arr[region] = files[fname][slot]
                filled[region] = True
            if not filled.all():
                raise ValueError(f"checkpoint {path}: leaf {leaf['key']!r} "
                                 "is not covered by its shard pieces")
            node = out
            *parents, name = leaf["key"].split("/")
            for part in parents:
                node = node.setdefault(part, {})
            node[name] = arr
    finally:
        for npz in files.values():
            npz.close()
    return out
