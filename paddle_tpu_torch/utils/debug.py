"""Introspection utilities (port of paddle_tpu/utils/debug.py): device
memory stats, program dumps and op censuses, module trees.

- `memory_stats` ≈ Fluid's get_mem_usage (pybind.cc) and
  contrib/memory_usage_calc.py: on the card PyTorch's caching allocator
  (`torch.cuda.memory_stats`) under JAX's keys, on the CPU a walk of
  the live tensors, as JAX walks `jax.live_arrays()`;
- `dump_hlo` / `op_census` ≈ Program.to_string, debugger.py and
  benchmark/op_frequence.py. JAX dumps its XLA program at three stages
  (`jaxpr`, `stablehlo`, `optimized`), none of which PyTorch has: the
  port dumps the graphs it has, the ATen graph that `make_fx` traces
  (`fx`) and the `torch.export` program (`export`), and refuses JAX's
  stage names by name;
- `module_tree` / `module_tree_dot` ≈ the Program/Block printer and
  net_drawer.py, over an `nn.Module`, with JAX's names (a ModuleList's
  items are `{name}_{i}`, as JAX names a list of modules) and the
  parameters in JAX's layout, so a model loaded by `load_jax_params`
  prints as the JAX model does.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

# the port's program stages, and JAX's, which it refuses by name
STAGES = {"fx": "the ATen graph traced by make_fx",
          "export": "the torch.export program"}
JAX_STAGES = ("jaxpr", "stablehlo", "optimized")


def _devices(device) -> List[torch.device]:
    if device is not None:
        d = torch.device(device)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        return [d]
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def memory_stats(device=None) -> Dict[str, Any]:
    """Per-device memory statistics, keyed by `str(device)` ("cuda:0",
    "cpu"), or one device's when `device` is given.

    On a card: {bytes_in_use, peak_bytes_in_use, num_allocs,
    bytes_reserved, bytes_limit, source} from PyTorch's caching
    allocator (`bytes_in_use` is `torch.cuda.memory_allocated`). On the
    CPU: {bytes_in_use, num_live_buffers, source: "live_tensors_walk"},
    the distinct storages of the live tensors. `device=None` means every
    card, or the CPU without one.
    """
    from paddle_tpu_torch.obs.devicemem import _live_storages
    devs = _devices(device)
    out = {}
    for d in devs:
        if d.type == "cuda":
            s = torch.cuda.memory_stats(d)
            stats = {
                "bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
                "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak",
                                               0)),
                "num_allocs": int(s.get("allocation.all.allocated", 0)),
                "bytes_reserved": int(s.get("reserved_bytes.all.current",
                                            0)),
                "bytes_limit": int(
                    torch.cuda.get_device_properties(d).total_memory),
                "source": "torch.cuda.memory_stats"}
        else:
            live = _live_storages(d)
            stats = {"bytes_in_use": sum(live.values()),
                     "num_live_buffers": len(live),
                     "source": "live_tensors_walk"}
        out[str(d)] = stats
    return out if device is None else out[str(devs[0])]


def executor_cache_stats():
    """The program-cache stats of every live Executor (entries, hits,
    misses, evictions): the host-side complement of memory_stats."""
    from paddle_tpu_torch.core.executor import executor_cache_stats as _s
    return _s()


class _AsModule(nn.Module):
    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args, **kwargs):
        return self.fn(*args, **kwargs)


def dump_hlo(fn: Callable, *args, stage: str = "export",
             static_argnums=(), **kwargs) -> str:
    """Text dump of the program `fn(*args, **kwargs)` runs.

    stage: "fx" (the ATen graph that `make_fx` traces, with shapes) or
    "export" (the `torch.export` program, portable, with its graph
    signature). JAX's stages ("jaxpr", "stablehlo", "optimized") raise
    ValueError naming these. `static_argnums` is JAX's signature: the
    port's traces take every non-tensor argument as a constant anyway.
    """
    del static_argnums
    if stage in JAX_STAGES:
        raise ValueError(
            f"stage {stage!r} is an XLA program stage of the JAX package; "
            f"PyTorch has none: the port's stages are "
            + ", ".join(f"{k!r} ({v})" for k, v in STAGES.items()))
    if stage == "fx":
        from torch.fx.experimental.proxy_tensor import make_fx
        gm = make_fx(lambda *a: fn(*a, **kwargs))(*args)
        return gm.print_readable(print_output=False)
    if stage == "export":
        module = fn if isinstance(fn, nn.Module) else _AsModule(fn)
        return str(torch.export.export(module, tuple(args), kwargs or None))
    raise ValueError(f"unknown stage {stage!r}; use "
                     + " | ".join(STAGES))


def op_census(fn: Callable, *args, stage: str = "fx",
              static_argnums=(), **kwargs) -> Dict[str, int]:
    """Op-type frequency table of the program, most frequent first
    (≈ Fluid's benchmark/op_frequence.py, over the ATen graph here)."""
    return census_from_text(dump_hlo(fn, *args, stage=stage,
                                     static_argnums=static_argnums,
                                     **kwargs))


def census_from_text(text: str) -> Dict[str, int]:
    """op_census over program text: the port's graphs (`aten.<op>`
    calls, keyed by the op without namespace and overload), and, as in
    the JAX package, HLO and StableHLO text, parsed the same way, so the
    same text gives the same table in both packages."""
    counts: Dict[str, int] = {}
    # HLO: "%name = <type> opcode(...)" where <type> may be a tuple
    # "(s32[], f32[8,8]{1,0:T(8,128)})" — the opcode is the first
    # lowercase identifier directly followed by "(" after the "=" (tile
    # annotations like T(8,128) start uppercase, so they don't match).
    hlo_op = re.compile(r"=\s+[^=]*?\s([a-z][a-z0-9_\-]*)\(")
    aten_op = re.compile(r"\baten\.([A-Za-z0-9_]+)(?:\.[A-Za-z0-9_]+)?\(")
    for line in text.splitlines():
        line = line.strip()
        op = None
        if "stablehlo." in line or "mhlo." in line:
            # StableHLO (MLIR): "%0 = stablehlo.opcode ..."
            for tok in line.replace("(", " ").split():
                if tok.startswith(("stablehlo.", "mhlo.")):
                    op = tok.split(".", 1)[1].rstrip('"')
                    break
        elif "aten." in line:
            # the port's graphs: "mm = torch.ops.aten.mm.default(a, b)"
            m = aten_op.search(line)
            if m:
                op = m.group(1)
        elif "= " in line and not line.startswith(("HloModule", "ENTRY",
                                                   "//", "#")):
            m = hlo_op.search(line)
            if m:
                op = m.group(1)
        if op:
            counts[op] = counts.get(op, 0) + 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


def _children(m: nn.Module) -> List[Tuple[str, nn.Module]]:
    """A module's children under JAX's names: a ModuleList's items
    become `{name}_{i}`, as JAX registers a list of modules."""
    out = []
    for name, child in m.named_children():
        if isinstance(child, nn.ModuleList):
            out += [(f"{name}_{i}", c) for i, c in enumerate(child)]
        else:
            out.append((name, child))
    return out


def _params_tree(module: nn.Module, variables: Optional[Dict]) -> Dict:
    """The parameters to print: `variables` (a JAX variables dict or a
    bare params tree) when given, else the module's own, by JAX path."""
    if variables is not None:
        return variables.get("params", variables) or {}
    from paddle_tpu_torch.models.convert import param_path
    from paddle_tpu_torch.utils.tree import nest
    return nest({param_path(n): p.detach()
                 for n, p in module.named_parameters()})


def _size(v: Any) -> int:
    return int(np.prod(tuple(getattr(v, "shape", ())), dtype=np.int64))


def _count_params(p: Any) -> int:
    if not isinstance(p, dict):
        return 0
    return sum(_count_params(v) if isinstance(v, dict) else _size(v)
               for v in p.values())


def module_tree(module: nn.Module, variables: Optional[Dict] = None,
                _name: str = "", _indent: int = 0) -> str:
    """Pretty-print a module hierarchy with parameter shapes and counts
    (≈ Fluid's Program printer, framework.py to_string, at module
    granularity). A module's own parameters print in name order, the
    order of a JAX tree that came out of a jitted init."""
    lines: List[str] = []
    params = _params_tree(module, variables)

    def walk(m: nn.Module, name: str, p: Any, indent: int):
        own = {k: p[k] for k in sorted(p) if not isinstance(p[k], dict)
               } if isinstance(p, dict) else {}
        n_params = _count_params(p)
        head = "  " * indent + (name or type(m).__name__)
        desc = type(m).__name__
        extra = f" params={n_params:,}" if n_params else ""
        lines.append(f"{head}: {desc}{extra}")
        for k, v in own.items():
            shape = tuple(getattr(v, "shape", ()))
            lines.append("  " * (indent + 1) + f".{k} {shape}")
        for cname, child in _children(m):
            cp = p.get(cname) if isinstance(p, dict) else None
            walk(child, cname, cp, indent + 1)

    walk(module, _name, params, _indent)
    return "\n".join(lines)


def module_tree_dot(module: nn.Module,
                    variables: Optional[Dict] = None) -> str:
    """Graphviz dot source for a module hierarchy (≈ Fluid's
    graph_viz_pass.cc and net_drawer.py): render with `dot -Tpng`. Node
    labels carry the module class and parameter counts."""
    params = _params_tree(module, variables)
    lines = ["digraph module_tree {",
             '  node [shape=box, fontname="monospace", fontsize=10];']
    counter = [0]

    def walk(m: nn.Module, name: str, p: Any) -> str:
        nid = f"n{counter[0]}"
        counter[0] += 1
        n_params = _count_params(p)
        label = f"{name or type(m).__name__}\\n{type(m).__name__}"
        if n_params:
            label += f"\\nparams={n_params:,}"
        lines.append(f'  {nid} [label="{label}"];')
        for cname, child in _children(m):
            cp = p.get(cname) if isinstance(p, dict) else None
            cid = walk(child, cname, cp)
            lines.append(f"  {nid} -> {cid};")
        return nid

    walk(module, "", params)
    lines.append("}")
    return "\n".join(lines)
