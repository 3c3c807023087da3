"""Inference model export and load (port of paddle_tpu/io/inference.py).

An export is a directory:

    model.pt2        the computation: `torch.export.export` of the
                     module's eval forward (or of `fn`) over the example
                     inputs, written by `torch.export.save`, with the
                     map from its tensors to the tree paths below
    params/          the weights, a checkpoint (io/checkpoint.py) of the
                     variables in JAX's tree paths ({"params", "state"},
                     empty collections dropped as JAX's `_prune_empty`
                     drops them)
    signature.json   {"version": 1, "input_names": [...], "inputs":
                     [{"shape", "dtype"}], "serve": {...} optional},
                     dtypes as numpy names ("float32"), as JAX writes it

JAX writes `model.stablehlo` where the port writes `model.pt2`; the
other two are the same, so JAX's `ServeEngine.from_saved_model` serves a
CausalLM export the port wrote and the port's serves JAX's. The port
cannot run StableHLO: loading a directory that holds only
`model.stablehlo` raises ValueError. A `.pt2` is read by the PyTorch
that wrote it; nothing promises that one moves between versions.

Kernel 4 is recorded in an export made on the card as the operator
`paddle_tpu_torch::flash_fwd` (kernels/flash.py), so the predictor
launches the hand-written kernel. Example inputs are taken as JAX takes
them (`jnp.asarray` without x64): int64 and float64 become int32 and
float32, and the predictor converts its feeds the same way. Exported
programs are shape- and dtype-static, as JAX's are.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from paddle_tpu_torch.device import DeviceLike, resolve_device
from paddle_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from paddle_tpu_torch.kernels import flash  # noqa: F401  (registers the op)
from paddle_tpu_torch.models.convert import (jax_path, load_jax_params,
                                             param_path, persistent_buffers,
                                             to_jax_params)
from paddle_tpu_torch.utils.tree import flatten_with_keys, unflatten_like

_SIG = "signature.json"
_PT2 = "model.pt2"
_HLO = "model.stablehlo"
_PARAMS = "params"
#: the map {exported tensor name: tree path}, stored inside model.pt2
_PATHS = "tree_paths.json"

#: JAX's dtype canonicalisation without x64
_CANONICAL = {torch.int64: torch.int32, torch.float64: torch.float32,
              torch.complex128: torch.complex64}


def _prune_empty(tree):
    """Drop empty sub-dicts (a stateless model's empty `state`), so the
    written tree matches what a checkpoint round trip gives back."""
    if isinstance(tree, dict):
        out = {k: _prune_empty(v) for k, v in tree.items()}
        return {k: v for k, v in out.items()
                if not (isinstance(v, dict) and not v)}
    return tree


def dtype_name(dtype: torch.dtype) -> str:
    """A torch dtype by its numpy name ("float32", "int32", "bfloat16")."""
    return str(dtype).replace("torch.", "")


def as_input(x, device: torch.device) -> torch.Tensor:
    """A feed or example input as the exported program takes it: a
    tensor on `device`, int64 / float64 narrowed as `jnp.asarray` does."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
    return t.to(device=device, dtype=_CANONICAL.get(t.dtype, t.dtype))


def write_export(path: str, variables, signature: Dict) -> str:
    """The two parts of an export that both packages read: `params` (a
    checkpoint of `variables`, empty collections dropped) and
    `signature.json`. Returns `path`."""
    os.makedirs(path, exist_ok=True)
    save_checkpoint(os.path.join(path, _PARAMS), _prune_empty(variables))
    with open(os.path.join(path, _SIG), "w") as f:
        json.dump(signature, f, indent=1)
    return path


class _FnModule(nn.Module):
    """A pure fn(variables, *inputs) as a module that holds the leaves of
    `variables` as buffers v0, v1, ... in tree order."""

    def __init__(self, fn: Callable, variables, device: torch.device):
        super().__init__()
        self.fn = fn
        self.tree = variables
        self.n = 0
        for _, leaf in flatten_with_keys(variables):
            self.register_buffer(f"v{self.n}", as_input(leaf, device))
            self.n += 1

    def forward(self, *inputs):
        leaves = (getattr(self, f"v{i}") for i in range(self.n))
        return self.fn(unflatten_like(self.tree, leaves), *inputs)


def save_inference_model(path: str, module_or_fn, variables=None,
                         example_inputs: Sequence[Any] = (),
                         input_names: Optional[Sequence[str]] = None,
                         serve_meta: Optional[Dict] = None,
                         device: DeviceLike = None) -> str:
    """Export a servable model directory.

    module_or_fn: an `nn.Module` (its forward in eval mode is exported;
    `variables`, a JAX-layout tree, is loaded into it first when given,
    else its own weights are written) or a pure fn(variables, *inputs)
    (then `variables` is required and its leaves go to `device`, default
    the card). Example inputs go to the module's device.

    serve_meta: recorded as the manifest's `serve` block
    (`engine.serve_metadata(model)` for a CausalLM), which
    `ServeEngine.from_saved_model` reads in either package."""
    if isinstance(module_or_fn, nn.Module):
        module = module_or_fn
        if variables is not None:
            load_jax_params(module, variables)
        device = next(module.parameters()).device
        variables = to_jax_params(module)
        paths = {n: jax_path(n) for n, _ in module.named_parameters()}
        paths.update({n: "state/" + param_path(n)
                      for n, _ in persistent_buffers(module)})
    else:
        if variables is None:
            raise ValueError("exporting a fn needs its variables")
        device = resolve_device(device)
        module = _FnModule(module_or_fn, variables, device)
        paths = {f"v{i}": key for i, (key, _) in
                 enumerate(flatten_with_keys(variables))}
    inputs = tuple(as_input(x, device) for x in example_inputs)
    was_training = module.training
    module.eval()
    try:
        with torch.no_grad():
            exported = torch.export.export(module, inputs)
    finally:
        module.train(was_training)
    os.makedirs(path, exist_ok=True)
    torch.export.save(exported, os.path.join(path, _PT2),
                      extra_files={_PATHS: json.dumps(paths)})
    sig = {
        "version": 1,
        "input_names": list(input_names or
                            [f"x{i}" for i in range(len(inputs))]),
        "inputs": [{"shape": list(x.shape), "dtype": dtype_name(x.dtype)}
                   for x in inputs],
    }
    if serve_meta is not None:
        sig["serve"] = dict(serve_meta)
    return write_export(path, variables, sig)


def _program(path: str):
    """(the exported program, its {tensor name: tree path})."""
    pt2 = os.path.join(path, _PT2)
    if not os.path.exists(pt2):
        if os.path.exists(os.path.join(path, _HLO)):
            raise ValueError(
                f"{path} holds a StableHLO export (model.stablehlo), which "
                "the PyTorch port cannot run; ServeEngine.from_saved_model "
                "reads a serving export's params and signature.json")
        raise FileNotFoundError(f"{path} has no {_PT2}")
    extra = {_PATHS: ""}
    exported = torch.export.load(pt2, extra_files=extra)
    return exported, json.loads(extra[_PATHS])


def _state(paths: Dict[str, str], variables,
           device: torch.device) -> Dict[str, torch.Tensor]:
    flat = dict(flatten_with_keys(variables))
    return {name: as_input(flat[p], device) for name, p in paths.items()}


def load_inference_model(path: str, device: DeviceLike = None
                         ) -> Tuple[Callable, Dict, Dict]:
    """Returns (callable(variables, *inputs), variables, signature), as
    JAX's does: `variables` is the numpy tree of `params`, the callable
    runs the exported program on `device` (default the card) with the
    weights it is given. A directory that holds only `model.stablehlo`
    (a JAX export) raises ValueError."""
    exported, paths = _program(path)
    device = resolve_device(device)
    program = exported.module().to(device)
    variables = load_checkpoint(os.path.join(path, _PARAMS))
    with open(os.path.join(path, _SIG)) as f:
        sig = json.load(f)

    def call(variables, *inputs):
        with torch.no_grad():
            return torch.func.functional_call(
                program, _state(paths, variables, device),
                tuple(as_input(x, device) for x in inputs))
    return call, variables, sig


class InferencePredictor:
    """A predictor over an exported model (JAX's `InferencePredictor`):
    the program and the export's weights on `device` (default the card)
    once, then `run(feed)` (a positional list or a name-keyed dict)
    returns numpy outputs in JAX's leaf order."""

    def __init__(self, model_dir: str, device: DeviceLike = None):
        exported, paths = _program(model_dir)
        self.device = resolve_device(device)
        self.variables = load_checkpoint(os.path.join(model_dir, _PARAMS))
        with open(os.path.join(model_dir, _SIG)) as f:
            self.signature = json.load(f)
        self.program = exported.module().to(self.device)
        self._state = _state(paths, self.variables, self.device)
        self._input_names = self.signature["input_names"]

    def run(self, feed) -> List[np.ndarray]:
        if isinstance(feed, dict):
            inputs = [feed[n] for n in self._input_names]
        else:
            inputs = list(feed)
        with torch.no_grad():
            out = torch.func.functional_call(
                self.program, self._state,
                tuple(as_input(x, self.device) for x in inputs))
        # JAX's leaf order (dict entries by sorted key); bfloat16, which
        # numpy lacks, as float32
        return [(leaf.float() if leaf.dtype == torch.bfloat16 else leaf)
                .cpu().numpy() for _, leaf in flatten_with_keys(out)]
