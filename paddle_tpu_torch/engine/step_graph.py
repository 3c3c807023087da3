"""The serve step as one captured program (port of the `jit_step` /
`_step_fn` block of paddle_tpu/engine/engine.py:388-446).

The JAX engine compiles `CausalLM.ragged_step_paged` once with `jax.jit`
and calls that program every step; its `ptpu_engine_compiles` gauge
reads the program cache. On the card the counterpart is a CUDA graph:
`StepGraph` captures the step once, when the engine is built, and every
step replays it, the first included. A graph bakes in addresses, so
everything it reads or writes keeps one address for its life:

- the step's nine int32 operands are views into ONE device buffer,
  filled each step from a pinned host buffer of the same layout by a
  single non-blocking copy;
- the logits land in a static float32 output (the cast to float32 is
  inside the graph), [B, V], or [B, spec_len, V] for an engine that
  speculates (`spec_len` = 1 + spec_k logit positions a row, fixed when
  the engine is built, as JAX's last_idx [B, spec_len] is), and one
  non-blocking copy moves them to a pinned host buffer before the
  step's one synchronisation;
- the KV pools, and with the int8 tier its pools and scales, are
  allocated once by the cache and written in place: their addresses are
  recorded at capture and checked, on the host, before every step, and
  a moved pool raises;
- the weights are the model's parameters, which `load_jax_params`
  updates in place (a model whose parameters are rebound needs a new
  engine);
- the attention kernels' split workspaces come from the graph's private
  memory pool.

On the CPU nothing is captured: the same staging feeds the eager step,
which is the program cache's one entry, and computes what the engine
computed before the graph existed (the model widens the int32 ids,
slots and indices with `.long()`).

A tensor-parallel step (`tp`, a ServeTP) runs eagerly on every rank, on
the card too: it is the cache's one entry, over this rank's shard of
the model and its pool slices. `before_step` (the tp leader's) is
called with the host operand buffer before each step, to send it to the
other ranks; a worker fills `host_operands` from that broadcast.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, Optional

import numpy as np
import torch

from paddle_tpu_torch.kernels import paged_attention as paged

# the step's operands in `CausalLM.ragged_step_paged`'s order (the pools
# go between positions and block_tables)
OPERANDS = ("tokens", "positions", "block_tables", "context_lens",
            "q_starts", "tile_rows", "tile_offs", "slots", "last_idx")
_ALIGN = 4        # int32 elements: each operand starts on 16 bytes
_INT32_MAX = 2 ** 31 - 1


class StepGraph:
    """The engine's step program over fixed operand buffers.

    `operands` maps each operand name to a numpy view of the host
    staging buffer: `clear()` sets every one to the pad-only step (every
    tile on the null row `max_batch_size` at context 1 with an all-zero
    table, every token 0 at position 0 writing scratch slot 0), the
    engine writes the plan's rows over it, and `run()` returns the
    step's float32 logits, last_idx's shape + (V,), as a host array that
    the next `run()` overwrites. last_idx is [max_batch_size] for
    `spec_len` 1 (the engine without speculation: JAX's [B, 1] without
    its unit axis, so its operands and logits keep their layout) and
    [max_batch_size, spec_len] otherwise."""

    def __init__(self, model, cache, flat_tokens: int, tile_q: int,
                 max_batch_size: int, max_blocks: int, spec_len: int = 1,
                 tp=None, before_step=None):
        if cache.num_blocks * cache.block_size > _INT32_MAX:
            raise ValueError(
                f"{cache.num_blocks} blocks of {cache.block_size} give slot "
                "ids past int32, the step's operand type")
        self.model = model
        self.cache = cache
        self.device = cache.device
        self.tp = tp
        self.before_step = before_step
        b = max_batch_size
        shapes = {"tokens": (flat_tokens,), "positions": (flat_tokens,),
                  "block_tables": (b + 1, max_blocks),
                  "context_lens": (b + 1,), "q_starts": (b + 1,),
                  "tile_rows": (flat_tokens // tile_q,),
                  "tile_offs": (flat_tokens // tile_q,),
                  "slots": (flat_tokens,),
                  "last_idx": (b,) if spec_len == 1 else (b, spec_len)}
        spans, total = {}, 0
        for name in OPERANDS:
            n = int(np.prod(shapes[name]))
            spans[name] = (total, n)
            total += -(-n // _ALIGN) * _ALIGN
        cuda = self.device.type == "cuda"
        self._host = torch.zeros(total, dtype=torch.int32, pin_memory=cuda)
        self._dev = (torch.zeros(total, dtype=torch.int32, device=self.device)
                     if cuda else self._host)
        host = self._host.numpy()
        self.operands: Dict[str, np.ndarray] = {
            name: host[o:o + n].reshape(shapes[name])
            for name, (o, n) in spans.items()}
        self._views = [self._dev[o:o + n].view(shapes[name])
                       for name, (o, n) in spans.items()]
        self.operands["context_lens"][:] = 1
        self.operands["tile_rows"][:] = b
        self._pad = host.copy()
        # the program cache, keyed by the operand shape signature as
        # jax.jit's is: the captured graph on the card, None for the
        # eager step on the CPU
        self.signature = tuple((name, shapes[name], "int32")
                               for name in OPERANDS)
        self._programs: Dict[tuple, Optional[torch.cuda.CUDAGraph]] = {}
        self._addresses = self._pool_addresses()
        self._launches = paged.CapturedLaunches()
        self._logits: Optional[torch.Tensor] = None
        # host ms of the warm-up step and of the capture (instantiation
        # included), on the card
        self.warmup_ms: Optional[float] = None
        self.capture_ms: Optional[float] = None
        if cuda and tp is None:
            self._capture(shapes["last_idx"] + (model.vocab,))
        else:
            self._programs[self.signature] = None

    @property
    def compiles(self) -> int:
        """Programs in the cache: what `ptpu_engine_compiles` reads."""
        return len(self._programs)

    @property
    def graphs(self) -> list:
        """The captured CUDA graphs (none on the CPU)."""
        return [g for g in self._programs.values() if g is not None]

    @property
    def host_operands(self) -> torch.Tensor:
        """The host staging buffer every operand is a view of (int32,
        one fixed size)."""
        return self._host

    def clear(self) -> None:
        """Reset the host operands to the pad-only step."""
        np.copyto(self._host.numpy(), self._pad)

    def _pool_addresses(self) -> tuple:
        c = self.cache
        return tuple(t.data_ptr() for pair in (*c.pools, *c.qpools,
                                               *c.qscales) for t in pair)

    def _step(self) -> torch.Tensor:
        """The eager step over the device operands and the cache's
        pools (the model writes the step's k/v into them in place)."""
        v = self._views
        return self.model.ragged_step_paged(
            v[0], v[1], self.cache.pools, *v[2:], qpools=self.cache.qpools,
            qscales=self.cache.qscales, tp=self.tp)

    def _capture(self, logits_shape: tuple) -> None:
        """Warm up on a side stream, capture one step there and rejoin
        the current stream; both run the pad-only step, which writes
        only scratch. The warm-up's kernel launches are set-up and are
        not counted; the capture records how many each replay makes."""
        dev = self.device
        self._dev.copy_(self._host)
        self._host_logits = torch.empty(logits_shape, dtype=torch.float32,
                                        pin_memory=True)
        graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))

        def warm_up():
            t0 = time.perf_counter()
            with torch.cuda.stream(stream), torch.inference_mode():
                self._step()
            stream.synchronize()
            self.warmup_ms = (time.perf_counter() - t0) * 1e3

        def capture():
            # no garbage collection while capturing: collecting an engine
            # that became garbage would destroy its graph, a CUDA call
            # that invalidates this capture; collect before instead
            gc.collect()
            enabled = gc.isenabled()
            gc.disable()
            try:
                t0 = time.perf_counter()
                with torch.inference_mode(), torch.cuda.graph(graph,
                                                              stream=stream):
                    out = self._step().float()
                self.capture_ms = (time.perf_counter() - t0) * 1e3
            finally:
                if enabled:
                    gc.enable()
            return out

        self._logits = self._launches.capture(capture, warm_up=warm_up)
        torch.cuda.current_stream(dev).wait_stream(stream)
        self._programs[self.signature] = graph

    def _check_addresses(self) -> None:
        """Raise if a pool the program was built over has moved."""
        if self._pool_addresses() != self._addresses:
            raise RuntimeError(
                "the KV pools moved since the step program was built over "
                "them; the engine's pools must be written in place")

    def run(self) -> np.ndarray:
        """One step over the staged operands: replay the graph on the
        card, run the eager step on the CPU or under tp. Returns the
        logits."""
        self._check_addresses()
        if self.before_step is not None:
            self.before_step(self._host)
        graph = self._programs[self.signature]
        if graph is None:
            if self._dev is not self._host:
                self._dev.copy_(self._host)
            with torch.inference_mode():
                self._logits = self._step().float()
            return self._logits.cpu().numpy()
        self._dev.copy_(self._host, non_blocking=True)
        graph.replay()
        self._launches.replay()
        self._host_logits.copy_(self._logits, non_blocking=True)
        # the one synchronisation of a step: after it the logits are on
        # the host, and the operand copy has run, so the next step may
        # refill the pinned operand buffer
        torch.cuda.current_stream(self.device).synchronize()
        return self._host_logits.numpy()

    def eager(self) -> torch.Tensor:
        """The eager step over the staged device operands and the same
        pools, float32 logits on the device: what the program replaces.
        Writing the same k/v to the same slots again, it reads the state
        the last step read (a check of the graph; its launches count)."""
        with torch.inference_mode():
            return self._step().float()

    @property
    def logits(self) -> torch.Tensor:
        """The last step's float32 logits on the device: on the card the
        graph's static output, which the next replay overwrites."""
        return self._logits
