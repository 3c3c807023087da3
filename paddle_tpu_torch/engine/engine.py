"""ServeEngine: the online inference serve loop (port of
paddle_tpu/engine/engine.py).

A refcounted `PagedKVCache` holds KV state in block pools (prefix-
shared, copy-on-write), a `Scheduler` plans one MIXED batch per step
(decode rows + prefill chunks), and this engine runs each step as ONE
`CausalLM.ragged_step_paged` call, samples tokens on the host with
numpy, streams them to per-request callbacks, and emits structured
`serve_event` JSON (utils/log.py).

One fixed shape, one program — the JAX engine's one-compile rule: every
step runs at a FIXED shape. The step's rows are packed into a single
[T] token array, T = round_up(chunk_budget, tile_q) + max_batch_size *
round_up(1 + spec_k, tile_q), with each row's tokens in a tile_q-aligned
segment and per-tile
metadata mapping tiles back to rows. Row membership, chunk boundaries
and prefix-cache hits only change int32 operand VALUES, never shapes.
The operands are staged in fixed buffers (step_graph.py), and on the
card the step is ONE CUDA graph, captured when the engine is built and
replayed every step; `ptpu_engine_compiles` reads the size of that
program cache (1), as JAX's reads its jit cache, and `step_shapes`
(every operand signature packed) checks the shape beside it. Pad
positions scatter to the reserved scratch block 0 (context_len 1,
slot 0) so they can never touch a live sequence. COW block copies run
in fixed-width batches of _COPY_LANES lanes; unused lanes copy scratch
block 0 onto itself.

Rows of a batch are computed independently by every op in the step,
so a request's logits are identical whether it shares the batch or
runs alone: the attention kernel splits a row's kv axis at fixed
positions anchored at position 0 (set by dtype and head dim, never by
the batch) and combines the splits in order, and masked lanes underflow
to exact zeros. Sampling derives its rng stream from (request seed,
absolute position), never from batch composition, so scheduling
decisions can't change a request's output.

In-device int8 KV tier (`kv_compress_blocks > 0`): cold prefix blocks
quantize into the cache's int8 pools, and a prefix hit on one is read
in place by the step's mixed attention kernel (or promoted back to fp,
per `kv_promote_hits`). The quantize and promote traffic runs as
fixed-lane `index_copy_` scatters before the step. With the tier on,
EVERY step passes the int8 pools, so the step keeps one shape under
fp -> int8 -> fp churn.

Three features ride that determinism with no new program:

- SPECULATIVE DECODING (spec_k > 0, engine/draft.py): a model-free
  prompt-lookup drafter proposes up to k tokens per decode-ready
  sequence; the scheduler widens that row's window to 1 + k tokens (the
  multi-token shape a prefill chunk has) so the one step scores all
  positions, and last_idx gathers spec_len = 1 + spec_k hidden states
  a row. Verification accepts the longest draft prefix where each
  draft token equals what _sample produces at its position anyway —
  exact under greedy AND temperature. Rejected positions roll back by
  not advancing the cache: their stale k/v past the sequence's length
  is reserved again and overwritten by later steps.
- PARALLEL SAMPLING (add_request(n=...)): a finished prefill forks into
  n candidates sharing every prompt block (refcount bump + COW), each
  sampling under seed + i from the same logits row; candidate streams
  equal solo runs with those seeds.
- HOST KV TIER (host_tier_bytes > 0, engine/kvtier.py): cached-free
  blocks the pool recycles, preempted sequences' committed blocks and
  evicted int8 entries demote to host RAM (int8-quantized with
  kv_tier_int8); a prompt that walks into the tier revives those
  blocks by fixed-lane in-place writes before the step, instead of
  re-prefilling them. `tier_spill_dir` warm-starts the tier from a
  spill; `demote_finished` demotes every finished request's blocks.

`ServeEngine.from_saved_model(dir)` serves a model exported by the JAX
package (`save_inference_model(..., serve_meta=serve_metadata(model))`),
reading it without JAX (io/checkpoint.py).

The serve layer (paddle_tpu_torch/serve/) reads the engine through
`kv_prefix_directory` (the /kvprefixes advertisement) and `debug_state`
(/debug and the flight recorder), between steps on its engine thread.

TENSOR-PARALLEL SERVING (tp_size > 1): the engine is rank 0 of tp_size
ranks and starts the others as worker processes (engine/tp_worker.py).
Rank r runs on device[r] (by default cuda:r; "cpu" puts every rank on
the CPU) with its shard of the weights (parallel/sharding.
serve_tp_rules; each shard is cut on the host and only then moved to its
device, and `engine.model` is rank 0's shard) and its head slices of
the KV pools; the engine keeps
the scheduler, the cache's bookkeeping, sampling and the host tier, and
sends the workers each step's operands and each flush's lanes. The
row-parallel fc2 reduce takes PTPU_SERVE_ALLREDUCE's mode, read once
here ("int8" quantized by default, "fp" the exact sum). Every rank runs
the step eagerly (one program: `ptpu_engine_compiles` reads 1). tp_size
1 is the engine above, with no process group and no worker. `close()`
stops the workers; a finalizer does when the engine is collected.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from paddle_tpu_torch.device import DeviceLike, indexed, resolve_device
from paddle_tpu_torch.engine.draft import NgramDrafter
from paddle_tpu_torch.engine.kvtier import (HostKVTier, prefix_digest,
                                           to_torch)
from paddle_tpu_torch.engine.paged_cache import PagedKVCache
from paddle_tpu_torch.engine.scheduler import (RUNNING, Request, Scheduler,
                                               StepRow)
from paddle_tpu_torch.engine.step_graph import StepGraph
from paddle_tpu_torch.io.checkpoint import load_checkpoint
from paddle_tpu_torch.models import CausalLM, load_jax_params
from paddle_tpu_torch.obs.metrics import MetricsRegistry, default_registry
from paddle_tpu_torch.obs.tracing import RequestTracer
from paddle_tpu_torch.utils.log import serve_event

_COPY_LANES = 8     # COW copies flushed through one fixed-shape call
# tier lanes (compress, promote, host revival) a call: the same width, so
# a tp worker's one lane buffer takes every flush
_TIER_LANES = _COPY_LANES


def tp_devices(tp_size: int, device=None) -> List[torch.device]:
    """The device of each rank of a tp engine: `device` a sequence of
    tp_size devices; "cpu" every rank on the CPU; None (or "cuda")
    cuda:0 .. cuda:tp_size-1, which needs that many cards."""
    if device is None or (isinstance(device, (str, torch.device))
                          and str(device) == "cuda"):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < tp_size:
            raise ValueError(
                f"tp_size={tp_size} needs {tp_size} CUDA devices, have {n}: "
                f"pass device=['cuda:0'] * {tp_size} to run every rank on "
                "one card (over gloo), or device='cpu' to run them on the "
                "CPU")
        return [torch.device("cuda", i) for i in range(tp_size)]
    if isinstance(device, (str, torch.device)):
        dev = resolve_device(device)
        if dev.type != "cpu":
            raise ValueError(
                f"device={device!r} for tp_size={tp_size}: a tp engine takes "
                "one device a rank, as a sequence, or 'cpu'")
        return [dev] * tp_size
    devs = [indexed(resolve_device(d)) for d in device]
    if len(devs) != tp_size:
        raise ValueError(f"{len(devs)} devices for tp_size={tp_size}")
    return devs


def serve_metadata(model) -> dict:
    """Introspect a CausalLM into the manifest `serve` block: everything
    needed to rebuild the module and size its KV pools."""
    attn = model.blocks[0].attn
    return {
        "model_type": "causal_lm",
        "vocab": model.vocab,
        "model_dim": model.model_dim,
        "num_heads": attn.num_heads,
        "num_kv_heads": attn.num_kv_heads,
        "head_dim": attn.head_dim,
        "num_layers": len(model.blocks),
        "ffn_dim": model.blocks[0].ffn.fc1.out_features,
        "max_len": model.max_len,
        "tie_embeddings": model.tie_embeddings,
        "fused_qkv": attn.fused_qkv,
    }


def _sample(logits: np.ndarray, req: Request, pos: int
            ) -> "tuple[int, float]":
    """Host-side sampling for one row: (token, log-probability of that
    token under the sampling distribution — greedy scores against the
    plain softmax). Deterministic in (req.seed, pos): the same request
    samples the same token at the same position no matter what batch
    it rode in. Verbatim from the JAX engine, so it ports bit for
    bit."""
    if req.temperature <= 0.0:
        tok = int(np.argmax(logits))
        z = logits.astype(np.float64)
        z = z - z.max()
        return tok, float(z[tok] - np.log(np.exp(z).sum()))
    z = logits.astype(np.float64) / req.temperature
    if 0 < req.top_k < z.size:
        kth = np.partition(z, -req.top_k)[-req.top_k]
        z = np.where(z < kth, -np.inf, z)
    z = z - z.max()
    p = np.exp(z)
    p /= p.sum()
    rng = np.random.default_rng([req.seed & 0x7FFFFFFF, pos])
    tok = int(rng.choice(z.size, p=p))
    return tok, float(np.log(p[tok]))


class ServeEngine:
    """Continuous-batching serve loop over a CausalLM.

    add_request() enqueues; step() advances the world by one scheduler
    plan — ONE mixed batch of decode rows and prefill chunks through a
    single step call; run() drains the queue. Token callbacks fire as
    tokens are sampled.

    `max_prefill_tokens` is the per-step CHUNK budget: prompts longer
    than it are admitted anyway and prefilled across several steps,
    with decode rows riding the same steps. Budgets above the model's
    usable context are clamped; budgets < 1 are rejected. `tile_q` is
    the ragged packing's query-tile granularity.
    `enable_prefix_cache=False` turns off block sharing.
    `kv_compress_blocks` > 0 sizes the in-device int8 tier (0 is the
    plain engine, bit for bit); `kv_promote_hits` 0 reads compressed
    hits in place, 1 always promotes them to fp, N > 1 promotes a
    prefix once it has been hit N times. `spec_k` > 0 speculates up to
    spec_k drafted tokens a decode row (`drafter`, by default an
    NgramDrafter(k=spec_k); a drafter's k widens spec_k to fit).
    `host_tier_bytes` > 0 hangs a host KV tier of that byte budget
    behind the pool (`kv_tier_int8` quantizes it, `tier_spill_dir`
    warm-starts it from a spill, `demote_finished` demotes finished
    requests into it). `device` defaults to the CUDA card and must be
    the model's device. `tp_size` > 1 serves over that many ranks
    (tensor parallelism: `device` is then a sequence of one device a
    rank, or "cpu"; `model`, on any device, is only read to cut the
    ranks' shards, and `self.model` is rank 0's); `close()` stops its
    workers."""

    def __init__(self, model, max_batch_size: int = 4,
                 block_size: int = 16, num_blocks: int = 256,
                 max_seq_len: Optional[int] = None,
                 max_prefill_tokens: int = 512,
                 tile_q: int = 8,
                 enable_prefix_cache: bool = True,
                 spec_k: int = 0,
                 drafter=None,
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[RequestTracer] = None,
                 host_tier_bytes: int = 0,
                 kv_tier_int8: bool = False,
                 tier_spill_dir: Optional[str] = None,
                 kv_compress_blocks: int = 0,
                 kv_promote_hits: int = 0,
                 tp_size: int = 1,
                 demote_finished: bool = False,
                 device: Union[DeviceLike, Sequence[DeviceLike]] = None):
        attn = model.blocks[0].attn
        self.tp_size = int(tp_size)
        self._serve_tp = None
        self._tp = None               # the workers' command stream
        self.tp_devices: Optional[List[torch.device]] = None
        self.tp_backend: Optional[str] = None     # the data plane's
        if self.tp_size > 1:
            # every check before any process starts
            ffn_dim = model.blocks[0].ffn.fc1.out_features
            for name, n in (("num_heads", attn.num_heads),
                            ("num_kv_heads", attn.num_kv_heads),
                            ("ffn_dim", ffn_dim)):
                if n % self.tp_size:
                    raise ValueError(
                        f"{name}={n} not divisible by tp_size="
                        f"{self.tp_size}: tensor parallelism splits heads "
                        "(KV pools over kv heads, so GQA groups stay on "
                        "one rank) and ffn features evenly")
            self.tp_devices = tp_devices(self.tp_size, device)
            self.device = self.tp_devices[0]
        else:
            self.device = resolve_device(device)
            if indexed(self.device) != indexed(model.device):
                raise ValueError(f"engine device {self.device} != model "
                                 f"device {model.device}")
        self.obs = registry if registry is not None else default_registry()
        self.tracer = tracer if tracer is not None else RequestTracer()
        self.max_seq_len = min(max_seq_len or model.max_len, model.max_len)
        self.max_batch_size = max_batch_size
        if max_prefill_tokens < 1:
            raise ValueError(
                f"max_prefill_tokens {max_prefill_tokens} < 1: the chunk "
                "budget must admit at least one prompt token per step")
        if tile_q < 1:
            raise ValueError(f"tile_q {tile_q} < 1")
        if max_prefill_tokens > self.max_seq_len:
            # a single chunk can never exceed the usable context, so a
            # larger budget only inflates the step shape
            serve_event("serve_config_clamp", field="max_prefill_tokens",
                        requested=max_prefill_tokens,
                        clamped_to=self.max_seq_len)
            max_prefill_tokens = self.max_seq_len
        self.tile_q = tile_q
        # speculative decoding: a decode row becomes a window of up to
        # 1 + spec_k tokens, and last_idx gathers spec_len positions a
        # row; both are fixed here, so the step keeps one shape
        if spec_k < 0:
            raise ValueError(f"spec_k {spec_k} < 0")
        if drafter is None and spec_k > 0:
            drafter = NgramDrafter(k=spec_k)
        if drafter is not None:
            # the step's shape must fit the drafter's longest window
            spec_k = max(spec_k, drafter.k)
        self.spec_k = spec_k
        self.spec_len = spec_k + 1          # logit positions a row
        self.drafter = drafter
        # flat step sizing: every row's segment is tile-aligned, so the
        # worst case is max_batch_size rows each wasting tile_q - 1
        # slots on top of the chunk budget (decode windows grow to
        # 1 + spec_k tokens under speculation)
        self.flat_tokens = (
            -(-max_prefill_tokens // tile_q) * tile_q
            + max_batch_size * (-(-self.spec_len // tile_q) * tile_q))
        self.num_tiles = self.flat_tokens // tile_q
        # the host KV tier: cached-free evictions, preemptions (and with
        # demote_finished, finishes) demote block KV to host arrays, and
        # admission revives them with in-place lane writes
        self.host_tier = (
            HostKVTier(host_tier_bytes, int8=kv_tier_int8,
                       registry=self.obs)
            if host_tier_bytes > 0 else None)
        self.demote_finished = bool(demote_finished)
        self.tier_spill_dir = tier_spill_dir
        if self.host_tier is not None and tier_spill_dir:
            # warm restart from an earlier process's spill; a missing,
            # partial or foreign spill loads nothing (a cold start)
            loaded = self.host_tier.load_spill(tier_spill_dir)
            if loaded:
                serve_event("tier_warm_start", dir=tier_spill_dir,
                            blocks=loaded)
        cache_kw = dict(
            num_layers=len(model.blocks), num_blocks=num_blocks,
            block_size=block_size, num_kv_heads=attn.num_kv_heads,
            head_dim=attn.head_dim, enable_prefix_cache=enable_prefix_cache,
            compress_blocks=kv_compress_blocks)
        # the model the step runs: under tp rank 0's shard, and the
        # caller's model is only read (to the host) to cut the shards
        self.model = (self._start_tp(model, cache_kw)
                      if self.tp_size > 1 else model)
        self.cache = PagedKVCache(
            dtype=model.dtype, device=self.device, registry=self.obs,
            host_tier=self.host_tier, promote_hits=kv_promote_hits,
            tp_size=self.tp_size, **cache_kw)
        if self._tp is not None:
            self.cache.gather_heads = self._tp.gather_heads
        if self.host_tier is not None:
            # prime the tier's eager paths — the demote gather and the
            # revival lane write (pad lanes only: zeros into scratch
            # block 0) — so the first real demotion or revival does not
            # pay their first-call cost mid-request
            self.cache._block_layers(0)
            self._write_revivals([])
        self.max_blocks_per_seq = self.cache.blocks_for(self.max_seq_len)
        self.scheduler = Scheduler(
            self.cache, max_batch_size=max_batch_size,
            max_prefill_tokens=max_prefill_tokens,
            max_seq_len=self.max_seq_len - 1,  # leave room for >=1 new token
            drafter=self.drafter)
        self.scheduler.on_preempt = self._on_preempt
        self.scheduler.on_admit = self._on_admit
        self.finished: Dict[int, Request] = {}
        self.steps = 0
        self.prefill_tokens_computed = 0
        self.peak_occupancy = 0.0
        self.max_chunk_tokens = 0       # largest prefill step actually run
        # every distinct step-operand shape signature packed: stays at one
        self.step_shapes: set = set()
        # the step program over fixed operand buffers: on the card a
        # CUDA graph, captured here; every step replays it
        self.step_graph = StepGraph(
            self.model, self.cache, self.flat_tokens, tile_q,
            max_batch_size, self.max_blocks_per_seq, self.spec_len,
            tp=self._serve_tp,
            before_step=None if self._tp is None else self._tp.step)
        self._register_metrics()
        self._m_tp_size.set(float(self.tp_size))
        if self._tp is not None:
            # a one-shot probe of the serving allreduce, every rank in it,
            # into ptpu_serve_allreduce_ms{mode} (the step itself is not
            # timed per collective)
            from paddle_tpu_torch.parallel.serve_collective import \
                allreduce_probe_ms
            shape = (1, model.model_dim)
            self._tp.probe(shape)
            self._allreduce_probe_ms = allreduce_probe_ms(
                self._serve_tp.group, self._serve_tp.mode, shape=shape,
                chunk=self._serve_tp.chunk, device=self.device)
            self._m_allreduce.labels(mode=self._serve_tp.mode).observe(
                self._allreduce_probe_ms)

    def _start_tp(self, model, cache_kw: dict):
        """Start ranks 1..tp_size-1 and send each its weight shard and
        the shapes it serves at; returns rank 0's shard of `model`, built
        as the workers build theirs (the caller's model keeps its
        weights)."""
        # imported here: `python -m paddle_tpu_torch.engine.tp_worker`
        # must find the worker module not yet imported by the package
        from paddle_tpu_torch.engine.tp_worker import TPLeader, build_shard
        from paddle_tpu_torch.models.convert import to_jax_params
        from paddle_tpu_torch.parallel.serve_collective import (
            DEFAULT_CHUNK, ServeTP, resolve_mode)
        from paddle_tpu_torch.parallel.sharding import (serve_tp_rules,
                                                        shard_variables)
        from paddle_tpu_torch.utils.tree import flatten_with_keys

        tp, devs = self.tp_size, self.tp_devices
        mode = resolve_mode()
        # NCCL when every rank has a card of its own; gloo on the CPU or
        # when ranks share a card (NCCL refuses two ranks on one device)
        backend = ("nccl" if all(d.type == "cuda" for d in devs)
                   and len(set(devs)) == tp else "gloo")
        self.tp_backend = backend
        if self.device.type == "cuda":
            from paddle_tpu_torch.kernels import paged_attention as paged
            paged._library()      # built once, before the workers load it
        meta = serve_metadata(model)
        rules = serve_tp_rules()
        tree = to_jax_params(model)
        shards = [dict(flatten_with_keys(shard_variables(tree, rules, r, tp)))
                  for r in range(tp)]
        spec = {
            "model": dict({k: meta[k] for k in (
                "vocab", "model_dim", "num_heads", "num_layers", "ffn_dim",
                "max_len", "tie_embeddings", "fused_qkv", "num_kv_heads")},
                dtype=str(model.dtype).split(".")[-1]),
            "cache": cache_kw,
            "graph": dict(flat_tokens=self.flat_tokens, tile_q=self.tile_q,
                          max_batch_size=self.max_batch_size,
                          max_blocks=-(-self.max_seq_len
                                       // cache_kw["block_size"]),
                          spec_len=self.spec_len),
            "tp": dict(mode=mode, chunk=DEFAULT_CHUNK),
            "lanes": _TIER_LANES}
        self._tp = TPLeader(tp, devs, backend, spec, shards)
        self._serve_tp = ServeTP(self._tp.data, tp, mode=mode,
                                 chunk=DEFAULT_CHUNK)
        return build_shard(spec["model"], shards[0], devs[0], 0, tp)

    # -- tensor-parallel ranks ----------------------------------------------
    def close(self) -> None:
        """Stop and join a tp engine's workers (a no-op at tp_size 1, and
        when already closed); `worker_exit_codes` holds their codes."""
        if self._tp is not None:
            self._tp.close()

    @property
    def worker_exit_codes(self) -> List[Optional[int]]:
        """The workers' exit codes after `close()` (rank order from 1)."""
        return [] if self._tp is None else list(self._tp.exit_codes)

    def rank_state(self, reset_launches: bool = False) -> List[dict]:
        """Every rank's {rank, launches, pool_bytes, param_bytes, qscales,
        compiles}: the leader's own, then the workers' over the command
        stream (`launches` are the kernel wrappers' counters of that
        rank's process; `param_bytes` its weight shard's;
        `reset_launches` zeroes the workers' launches after reading)."""
        from paddle_tpu_torch.engine.tp_worker import (launch_counts,
                                                       param_bytes)
        own = {"rank": 0, "launches": launch_counts(),
               "pool_bytes": self.cache.per_chip_pool_bytes(),
               "param_bytes": param_bytes(self.model),
               "qscales": [(k.cpu().numpy(), v.cpu().numpy())
                           for k, v in self.cache.qscales],
               "compiles": self.step_graph.compiles}
        if self._tp is None:
            return [own]
        return [own] + self._tp.state(reset_launches)

    # -- construction from an exported artifact ---------------------------
    @classmethod
    def from_saved_model(cls, model_dir: str,
                         device: Union[DeviceLike,
                                       Sequence[DeviceLike]] = None,
                         **engine_kwargs) -> "ServeEngine":
        """Build model + engine from a directory the JAX package's
        `save_inference_model` wrote with the manifest's `serve` block
        (`serve_metadata`): the model is rebuilt from `signature.json`
        and its weights read from the `params` checkpoint with numpy.
        `max_seq_len` defaults to the model's max_len. `device`
        defaults to the CUDA card; with `tp_size` > 1 it is the ranks'
        devices (`tp_devices`), and the whole model is built on the
        host, where the ranks' shards are cut from it."""
        with open(os.path.join(model_dir, "signature.json")) as f:
            sig = json.load(f)
        meta = sig.get("serve")
        if meta is None:
            raise ValueError(
                f"{model_dir} has no `serve` metadata in its manifest; "
                "re-export with save_inference_model(..., "
                "serve_meta=serve_metadata(model))")
        model = CausalLM(
            vocab=meta["vocab"], model_dim=meta["model_dim"],
            num_heads=meta["num_heads"], num_layers=meta["num_layers"],
            ffn_dim=meta["ffn_dim"], dropout=0.0, max_len=meta["max_len"],
            tie_embeddings=meta["tie_embeddings"],
            fused_qkv=meta["fused_qkv"],
            num_kv_heads=meta["num_kv_heads"],
            device="cpu" if engine_kwargs.get("tp_size", 1) > 1 else device)
        load_jax_params(model, load_checkpoint(
            os.path.join(model_dir, "params")))
        engine_kwargs.setdefault("max_seq_len", meta["max_len"])
        return cls(model, device=device, **engine_kwargs)

    # -- telemetry --------------------------------------------------------
    def _register_metrics(self) -> None:
        """Metric families this engine records (the JAX engine's names).
        Families are get-or-create: engines sharing a registry share
        series. Everything here is host-side bookkeeping."""
        m = self.obs
        self._m_ttft = m.histogram(
            "ptpu_serve_ttft_ms", "Enqueue to first token (ms)")
        self._m_tpot = m.histogram(
            "ptpu_serve_tpot_ms",
            "Per-request mean decode latency per output token (ms)")
        self._m_queue_wait = m.histogram(
            "ptpu_serve_queue_wait_ms", "Enqueue to first admission (ms)")
        self._m_e2e = m.histogram(
            "ptpu_serve_e2e_ms", "Enqueue to finish (ms)")
        self._m_step = m.histogram(
            "ptpu_serve_step_ms", "Engine step wall time (ms)",
            labelnames=("kind",))        # kind=decode|prefill|mixed|spec
        self._m_reqs = m.counter(
            "ptpu_serve_requests_total", "Finished requests",
            labelnames=("reason",))      # reason=eos|length|cancelled
        self._m_tp_size = m.gauge(
            "ptpu_serve_tp_size",
            "Tensor-parallel degree of the serving ranks (1 = "
            "single-device)")
        self._m_allreduce = m.histogram(
            "ptpu_serve_allreduce_ms",
            "Decode-MLP allreduce probe wall time at engine construction "
            "(ms)", labelnames=("mode",))        # mode=fp|int8
        self._m_tokens = m.counter(
            "ptpu_serve_tokens_total", "Token flow through the engine",
            labelnames=("kind",))        # kind=prefill|cached|generated
        self._m_steps = m.counter(
            "ptpu_engine_steps_total", "Mixed steps executed")
        self._m_compiles = m.gauge(
            "ptpu_engine_compiles",
            "Step programs built: captured CUDA graphs on the card, the "
            "eager step on the CPU (stays at 1 across arbitrary traffic)")
        self._m_occ = m.gauge(
            "ptpu_kv_occupancy", "Fraction of allocatable blocks in use")
        self._m_hit = m.gauge(
            "ptpu_kv_hit_rate",
            "Cumulative fraction of prompt tokens served from the "
            "prefix cache")
        self._m_shared = m.gauge(
            "ptpu_kv_shared_blocks", "Blocks with refcount > 1")
        self._m_compressed = m.gauge(
            "ptpu_kv_compressed_blocks",
            "Prefix blocks resident in the device int8 compressed pool")
        self._m_pool_eff = m.gauge(
            "ptpu_kv_pool_effective_bytes",
            "fp-equivalent KV bytes the device holds: the fp pool plus "
            "every compressed entry at the fp bytes it stands in for")
        self._m_queue_depth = m.gauge(
            "ptpu_sched_queue_depth", "Requests waiting for admission")
        self._m_running = m.gauge(
            "ptpu_sched_running", "Requests in the running set")
        self._m_decode_rows = m.gauge(
            "ptpu_sched_decode_rows", "Decode rows in the last step")
        self._m_prefill_rows = m.gauge(
            "ptpu_sched_prefill_rows", "Prefill chunks in the last step")
        self._m_budget_util = m.gauge(
            "ptpu_sched_chunk_budget_util",
            "Chunk tokens / max_prefill_tokens of the last "
            "prefill-bearing step")
        self._m_preempts = m.counter(
            "ptpu_sched_preemptions_total", "Recompute preemptions")
        # speculative decoding: acceptance telemetry (the step latency
        # rides ptpu_serve_step_ms{kind="spec"} beside "decode")
        self._m_spec_drafted = m.counter(
            "ptpu_spec_drafted_tokens_total",
            "Draft tokens proposed for batched verification")
        self._m_spec_accepted = m.counter(
            "ptpu_spec_accepted_tokens_total",
            "Draft tokens accepted (emitted beyond the base token)")
        self._m_spec_rejected = m.counter(
            "ptpu_spec_rejected_tokens_total",
            "Draft tokens rejected (their written KV rolled back)")
        self._m_spec_ratio = m.histogram(
            "ptpu_spec_acceptance_ratio",
            "Per-speculative-row accepted/drafted ratio")

    def _on_admit(self, req: Request) -> None:
        """Scheduler hook: a request left the wait queue. Queue-wait is
        observed only on FIRST admission."""
        now = time.monotonic()
        if req.admit_time == 0.0:
            self._m_queue_wait.observe((now - req.enqueue_time) * 1e3)
        req.admit_time = now
        self.tracer.on_admit(req.req_id)
        self._set_sched_gauges()

    def _set_sched_gauges(self) -> None:
        self._m_queue_depth.set(self.scheduler.queue_depth)
        self._m_running.set(len(self.scheduler.running))

    def metrics_text(self) -> str:
        """Prometheus exposition of this engine's registry."""
        return self.obs.render_prometheus()

    # -- intake -----------------------------------------------------------
    def add_request(self, prompt: List[int], max_new_tokens: int = 32,
                    temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                    eos_id: Optional[int] = None,
                    callback: Optional[Callable[[int], None]] = None,
                    deadline_ms: Optional[float] = None,
                    n: int = 1,
                    fork_callback: Optional[Callable] = None) -> Request:
        """Enqueue one completion. `n > 1` is parallel sampling: when
        this request's prefill finishes, the engine forks n - 1 sibling
        candidates off its prompt blocks (refcount bump, no copy), each
        sampling with seed + i, and all n decode together. The returned
        primary is candidate 0; its `forks` list holds the siblings.
        fork_callback(i) returns sibling i's token callback (or None for
        a silent candidate)."""
        if not prompt:
            raise ValueError("empty prompt")
        if not 1 <= n <= self.max_batch_size:
            raise ValueError(
                f"n {n} not in [1, max_batch_size={self.max_batch_size}]: "
                "every candidate needs a batch slot to decode")
        if not all(-2 ** 31 <= t < 2 ** 31 for t in prompt):
            raise ValueError("prompt ids must fit int32, the step's "
                             "operand type")
        if len(prompt) + 1 > self.max_seq_len:
            raise ValueError(f"prompt len {len(prompt)} leaves no room to "
                             f"generate under max_seq_len {self.max_seq_len}")
        if self.cache.blocks_for(len(prompt) + 1) > self.cache.num_blocks - 1:
            raise ValueError(
                f"prompt len {len(prompt)} cannot fit the KV pool even "
                f"alone ({self.cache.num_blocks - 1} blocks of "
                f"{self.cache.block_size}); raise num_blocks")
        req = Request(prompt=list(prompt), max_new_tokens=max_new_tokens,
                      temperature=temperature, top_k=top_k, seed=seed,
                      eos_id=eos_id, callback=callback,
                      n_candidates=n, fork_callback=fork_callback)
        req.enqueue_time = time.monotonic()
        if deadline_ms is not None:
            req.deadline = req.enqueue_time + deadline_ms / 1e3
        self.scheduler.add(req)
        self.tracer.on_enqueue(req.req_id)
        self._set_sched_gauges()
        serve_event("serve_admit", req_id=req.req_id,
                    prompt_len=len(prompt),
                    queue_depth=self.scheduler.queue_depth)
        return req

    def cancel(self, req: Request, reason: str = "cancelled") -> bool:
        """Tear a request down mid-flight: frees its KV blocks (shared
        prefix blocks drop one refcount), counts it under
        requests{reason=...}, and closes its trace. Returns False when
        it already finished. Between steps only."""
        if not self.scheduler.cancel(req):
            return False
        req.finish_time = time.monotonic()
        req.finish_reason = reason
        self.finished[req.req_id] = req
        self._m_reqs.labels(reason=reason).inc()
        self._set_sched_gauges()
        self._m_occ.set(self.cache.occupancy())
        self.tracer.on_finish(req.req_id, reason)
        serve_event("serve_cancel", req_id=req.req_id, reason=reason,
                    tokens=req.num_generated,
                    occupancy=round(self.cache.occupancy(), 4))
        return True

    def cancel_group(self, req: Request, reason: str = "cancelled") -> int:
        """Cancel a parallel-sampling group: the primary and every fork
        it spawned, so all n candidates drop their block references
        (the shared prompt's refcounts return to baseline). Safe for
        n == 1 and before the fork happened (the siblings are then never
        created). Returns how many candidates were cancelled."""
        return sum(1 for r in [req] + req.forks
                   if self.cancel(r, reason))

    # -- serve loop --------------------------------------------------------
    def step(self) -> bool:
        """Advance one scheduler plan (one mixed batch through the
        single step call). Returns False when idle."""
        t0 = time.perf_counter()
        rows = self.scheduler.next_batch()
        if rows is None:
            return False
        self.steps += 1
        # publish the coldness clock, then sweep: blocks the plan just
        # admitted are hot, so only idle prefix content stages quantize
        # lanes for this step's _flush_compress
        self.cache.step_now = self.steps
        if self.cache.compress_enabled:
            self.cache.compress_cold()
        n_chunks, n_decodes, chunk_tokens, n_drafted = \
            self._step_mixed(rows)
        self.peak_occupancy = max(self.peak_occupancy,
                                  self.cache.occupancy())
        # "spec" wins over mixed/decode, so the latency of steps that
        # speculate is separable from plain decode's
        kind = ("spec" if n_drafted
                else "mixed" if n_chunks and n_decodes
                else "prefill" if n_chunks else "decode")
        self._m_step.labels(kind=kind).observe(
            (time.perf_counter() - t0) * 1e3)
        self._m_steps.inc()
        self._m_compiles.set(self.step_graph.compiles)
        self._m_occ.set(self.cache.occupancy())
        self._m_hit.set(self.cache.hit_rate())
        self._m_shared.set(self.cache.shared_blocks)
        self._m_compressed.set(float(self.cache.compressed_resident))
        self._m_pool_eff.set(float(self.cache.effective_pool_bytes()))
        self._m_queue_depth.set(self.scheduler.queue_depth)
        self._m_running.set(len(self.scheduler.running))
        self._m_decode_rows.set(n_decodes)
        self._m_prefill_rows.set(n_chunks)
        if n_chunks:
            self._m_budget_util.set(
                chunk_tokens / self.scheduler.max_prefill_tokens)
        return True

    def run(self) -> Dict[int, List[int]]:
        """Drain the queue; returns {req_id: generated token ids}."""
        while self.step():
            pass
        return {rid: self._generated_of(r)
                for rid, r in self.finished.items()}

    # -- internals ---------------------------------------------------------
    def _flush_cow(self) -> None:
        """Replay queued copy-on-write block copies on the device pools
        BEFORE the step that writes the fresh blocks, in fixed-width
        _COPY_LANES batches; pad lanes copy scratch block 0 onto
        itself."""
        copies = self.cache.drain_copies()
        for i in range(0, len(copies), _COPY_LANES):
            self._run_lanes("cow", self.cache.copy_blocks,
                            *self._lanes(copies, i))

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    @staticmethod
    def _lanes(jobs, i: int) -> "tuple[np.ndarray, np.ndarray]":
        """Fixed-width (_TIER_LANES) index pairs of jobs[i:i +
        _TIER_LANES] — (src, dst) copies, (fp block, int8 slot) tier
        jobs; unused lanes are (0, 0), the scratch block and slot."""
        a = np.zeros((_TIER_LANES,), np.int64)
        b = np.zeros((_TIER_LANES,), np.int64)
        for j, (x, y) in enumerate(jobs[i:i + _TIER_LANES]):
            a[j], b[j] = x, y
        return a, b

    def _run_lanes(self, kind: str, fn, a: np.ndarray, b: np.ndarray,
                   *extra) -> None:
        """One flush batch of `kind` ("cow", "compress", "promote"): sent
        to the workers under tp, then run here on this rank's pools."""
        if self._tp is not None:
            self._tp.lanes(kind, a, b)
        fn(self._to_device(a), self._to_device(b), *extra)

    def _reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        from paddle_tpu_torch.parallel.collective import all_reduce
        return all_reduce(t, self._serve_tp.group, "max")

    def _flush_compress(self) -> None:
        """Quantize staged cold fp blocks into the int8 pools — FIRST
        among the pre-step flushes, so the quantize lanes read every src
        block before a promote or COW copy can overwrite it. Pad lanes
        quantize fp scratch block 0 into int8 scratch slot 0. Under tp a
        block's scale is the MAX over the ranks' head slices."""
        jobs = self.cache.drain_compress()
        reduce_max = None if self._tp is None else self._reduce_max
        for i in range(0, len(jobs), _TIER_LANES):
            self._run_lanes("compress", self.cache.compress_lanes,
                            *self._lanes(jobs, i), reduce_max)

    def _flush_tier_loads(self) -> None:
        """Write staged host-tier revivals into the pools — after
        _flush_promote and BEFORE _flush_cow (a just-revived block can be
        a same-plan COW src) and the step that reads them — in batches
        of _TIER_LANES lanes."""
        loads = self.cache.drain_host_loads()
        for i in range(0, len(loads), _TIER_LANES):
            self._write_revivals(loads[i:i + _TIER_LANES])

    def _write_revivals(self, batch) -> None:
        """One fixed-width revival write: every layer's k and v of up to
        _TIER_LANES (block, layers) loads go to the card in one copy,
        then into the pools IN PLACE with index_copy_ (the step's graph
        holds the pools' addresses). Unused lanes write zeros into
        scratch block 0. Payloads in another dtype than the pool's are
        cast (round to nearest even). The tier holds global blocks; under
        tp each worker is sent its head slice."""
        kp0 = self.cache.pools[0][0]
        host = torch.zeros((len(self.cache.pools), 2, _TIER_LANES)
                           + self.cache.pool_shape(1)[1:], dtype=kp0.dtype)
        blocks = np.zeros((_TIER_LANES,), np.int64)
        for j, (b, layers) in enumerate(batch):
            blocks[j] = b
            for li, (k, v) in enumerate(layers):
                host[li, 0, j] = to_torch(k)
                host[li, 1, j] = to_torch(v)
        if self._tp is not None:
            host = self._tp.load(blocks, host)
        self.cache.write_lanes(self._to_device(blocks),
                               host.to(self.device))

    def _flush_promote(self) -> None:
        """Dequantize staged compressed-tier hits into their claimed fp
        blocks — after _flush_compress (a promote may read a slot the
        same plan just filled) and before host loads, COW copies and
        the step. Pad lanes write int8 scratch slot 0 into fp scratch
        block 0."""
        jobs = self.cache.drain_promotes()
        for i in range(0, len(jobs), _TIER_LANES):
            self._run_lanes("promote", self.cache.promote_lanes,
                            *self._lanes(jobs, i))

    @property
    def kv_direct_int8(self) -> bool:
        """Whether this engine's step reads int8-resident blocks in place
        (no promote round trip)."""
        return self.cache.compress_enabled and self.cache.direct_read_enabled

    def kv_prefix_directory(self, limit: int = 512) -> List[dict]:
        """This replica's fleet-directory advertisement: the warm
        prefixes it can serve without re-prefill, as {len, digest, tier}
        rows (device = prefix-index entries, device_int8 = in-device
        compressed entries, host = tier entries). Digests are crc32 over
        little-endian u32 token ids, the encoding the router's
        prefix_shard hashes. Engine-loop thread only (reads the unlocked
        prefix index); the serve front-end snapshots it between steps."""
        out = [{"len": len(key), "digest": prefix_digest(key),
                "tier": "device"}
               for key in self.cache.prefix_keys(limit)]
        if self.cache.compress_enabled:
            out.extend({"len": len(key), "digest": prefix_digest(key),
                        "tier": "device_int8"}
                       for key in self.cache.compressed_keys(limit))
        if self.host_tier is not None:
            out.extend({"len": ln, "digest": dg, "tier": "host"}
                       for ln, dg in self.host_tier.advertised(limit))
        return out

    @staticmethod
    def _request_summary(req: Request) -> dict:
        return {
            "req_id": req.req_id,
            "state": req.state,
            "prompt_len": len(req.prompt),
            "generated": req.num_generated,
            "prefill_pos": req.prefill_pos,
            "cached_tokens": req.cached_tokens,
            "preemptions": req.preemptions,
            "deadline": None if req.deadline == float("inf")
            else req.deadline,
            "n_candidates": req.n_candidates,
        }

    def debug_state(self) -> dict:
        """Introspection snapshot for /debug and the flight recorder: the
        wait queue and running set as request summaries, block-pool
        occupancy, and the host-tier summary. Engine-loop thread for a
        consistent view; the flight recorder may also call it from a
        watchdog thread while the engine loop is wedged: it only reads,
        so a torn read is the worst case."""
        pool = {
            "num_blocks": self.cache.num_blocks,
            "block_size": self.cache.block_size,
            "free_blocks": self.cache.free_blocks,
            "used_blocks": self.cache.used_blocks,
            "shared_blocks": self.cache.shared_blocks,
            "occupancy": round(self.cache.occupancy(), 4),
        }
        out = {
            "steps": self.steps,
            "queue_depth": self.scheduler.queue_depth,
            "waiting": [self._request_summary(r)
                        for r in self.scheduler.waiting],
            "running": [self._request_summary(r)
                        for r in self.scheduler.running],
            "pool": pool,
            "cache": self.cache.stats(),
        }
        if self.host_tier is not None:
            out["host_tier"] = self.host_tier.stats()
        if self._serve_tp is not None:
            out["tp"] = repr(self._serve_tp)
        return out

    def _step_mixed(self, rows: List[StepRow]
                    ) -> "tuple[int, int, int, int]":
        """Pack the plan's rows — decode rows AND prefill chunks — into
        the step program's staged operands and run ONE step. Row i's
        token window [start, start+length) lands in a tile_q-aligned
        segment of the [T] arrays; per-row metadata (block table,
        chunk-end context, start position) sits at index i, and the null
        row at index max_batch_size backs pad tiles (ctx 1, scratch
        table). For a plain decode row the window is [seq_len,
        seq_len+1) of req.tokens — the last generated token at its
        next-token position. A SPECULATIVE row widens it to [seq_len,
        seq_len+1+k): the base token and its k drafted tokens, each
        scattering its own k/v before attention reads it, as a chunk's
        tokens do. last_idx holds spec_len flat indices a row: one per
        window position for a decode row (a 1-token row repeats its
        one), the chunk's last token for a chunk. Returns (chunks,
        decode rows, chunk tokens, drafted tokens)."""
        self._flush_compress()
        self._flush_promote()
        self._flush_tier_loads()
        self._flush_cow()
        t_flat, tq = self.flat_tokens, self.tile_q
        mb = self.max_blocks_per_seq
        # pad positions scatter into scratch block 0 (slot < bs), pad
        # tiles point at the null row (ctx 1, scratch table)
        self.step_graph.clear()
        ops = self.step_graph.operands
        tokens, positions, slots = (ops["tokens"], ops["positions"],
                                    ops["slots"])
        block_tables, context_lens = ops["block_tables"], ops["context_lens"]
        q_starts, last_idx = ops["q_starts"], ops["last_idx"]
        tile_rows, tile_offs = ops["tile_rows"], ops["tile_offs"]
        last_idx = last_idx.reshape(self.max_batch_size, self.spec_len)
        cursor = 0
        for i, row in enumerate(rows):
            r = row.req
            if row.draft:
                # draft tokens live only in the plan, not in req.tokens
                tokens[cursor:cursor + row.length] = \
                    [r.tokens[row.start]] + row.draft
            else:
                tokens[cursor:cursor + row.length] = \
                    r.tokens[row.start:row.start + row.length]
            positions[cursor:cursor + row.length] = np.arange(
                row.start, row.start + row.length)
            for p in range(row.length):
                slots[cursor + p] = self.cache.slot_of(r.req_id,
                                                       row.start + p)
            block_tables[i] = self.cache.padded_table(r.req_id, mb)
            context_lens[i] = row.start + row.length
            q_starts[i] = row.start
            if row.decode:
                for j in range(self.spec_len):
                    last_idx[i, j] = cursor + min(j, row.length - 1)
            else:
                last_idx[i, :] = cursor + row.length - 1
            ntiles = -(-row.length // tq)
            t0 = cursor // tq
            for k in range(ntiles):
                tile_rows[t0 + k] = i
                tile_offs[t0 + k] = k * tq
            cursor += ntiles * tq
        self.step_shapes.add(tuple((a.shape, a.dtype.str)
                                   for a in ops.values()))
        logits = self.step_graph.run().reshape(
            self.max_batch_size, self.spec_len, -1)
        chunks = [w for w in rows if not w.decode]
        decodes = [w for w in rows if w.decode]
        computed = sum(w.length for w in chunks)
        now = time.monotonic()
        drafted = accepted = 0
        for i, row in enumerate(rows):
            r = row.req
            if row.decode:
                # the step wrote r.generated[-1]'s k/v at the reserved
                # slot
                self.cache.advance(r.req_id, r.generated[-1])
                row_accepted = 0
                for j in range(len(row.draft) + 1):
                    # logits[i, j] scored window position start + j: it
                    # predicts the token at cache seq_len, which the
                    # advances keep in step with j
                    tok, lp = _sample(logits[i, j], r,
                                      self.cache.seq_len(r.req_id))
                    r.logprob_sum += lp
                    self._emit_token(r, tok)
                    if r.finish_reason or j >= len(row.draft):
                        break
                    if row.draft[j] != tok:
                        # the first rejection: everything past seq_len is
                        # dead; rolling back is NOT advancing, and later
                        # steps overwrite the stale k/v
                        break
                    # draft j verified: the k/v this step scattered for
                    # it IS the true token's, so the next column counts
                    self.cache.advance(r.req_id, tok)
                    row_accepted += 1
                if row.draft:
                    drafted += len(row.draft)
                    accepted += row_accepted
                    self._m_spec_drafted.inc(len(row.draft))
                    self._m_spec_accepted.inc(row_accepted)
                    self._m_spec_rejected.inc(len(row.draft) - row_accepted)
                    self._m_spec_ratio.observe(row_accepted / len(row.draft))
            else:
                self.cache.commit_prefill(r.req_id, row.start + row.length)
                self.tracer.on_chunk(r.req_id, row.start, row.length)
                if row.start + row.length == len(r.prompt):  # final chunk
                    if r.n_candidates > 1 and not r.forks:
                        # fork BEFORE the primary samples: each sibling
                        # samples its first token from the same row
                        # under its own seed
                        self._fork_candidates(r, logits[i, 0], now)
                    tok, lp = _sample(logits[i, 0], r, len(r.prompt))
                    r.logprob_sum += lp
                    if not r.first_token_time:
                        r.first_token_time = now
                    self.tracer.on_first_token(r.req_id)
                    self._emit_token(r, tok)
        if chunks:
            # a request's prefix-hit tokens are attributed to the step
            # its FIRST chunk runs (start == cached_tokens), so summing
            # `cached` over a drain equals hit_tokens
            cached = sum(w.req.cached_tokens for w in chunks
                         if w.start == w.req.cached_tokens)
            self.prefill_tokens_computed += computed
            self.max_chunk_tokens = max(self.max_chunk_tokens, computed)
            self._m_tokens.labels(kind="prefill").inc(computed)
            if cached:
                self._m_tokens.labels(kind="cached").inc(cached)
            serve_event("serve_prefill", batch=len(chunks),
                        flat_t=t_flat, tokens=computed, cached=cached,
                        step=self.steps, cow=self.cache.cow_copies,
                        shared_blocks=self.cache.shared_blocks,
                        hit_rate=round(self.cache.hit_rate(), 4),
                        occupancy=round(self.cache.occupancy(), 4),
                        queue_depth=self.scheduler.queue_depth)
        if decodes:
            serve_event("serve_decode", batch=len(decodes),
                        step=self.steps, drafted=drafted,
                        accepted=accepted,
                        occupancy=round(self.cache.occupancy(), 4),
                        queue_depth=self.scheduler.queue_depth)
        return len(chunks), len(decodes), computed, drafted

    def _fork_candidates(self, primary: Request, logits_row: np.ndarray,
                         now: float) -> None:
        """Split a finished prefill into n parallel-sampling candidates.
        Each sibling's sequence shares EVERY prompt block with the
        primary (fork_sequence bumps refcounts; COW gives a candidate a
        private copy the first time it writes into a shared block), so
        the prompt is prefilled and held once for any n. Siblings join
        the running set decode-ready and sample their FIRST token from
        the same final-chunk logits row under seed + i: since _sample is
        deterministic in (seed, position) and the step's rows are
        batch-invariant, candidate i's stream equals a solo run
        submitted with that seed."""
        for i in range(1, primary.n_candidates):
            cb = (primary.fork_callback(i)
                  if primary.fork_callback is not None else None)
            sib = Request(
                prompt=list(primary.prompt),
                max_new_tokens=primary.max_new_tokens,
                temperature=primary.temperature,
                top_k=primary.top_k,
                seed=primary.seed + i,
                eos_id=primary.eos_id,
                callback=cb,
                deadline=primary.deadline,
                cand_index=i,
                parent=primary)
            sib.enqueue_time = primary.enqueue_time
            sib.admit_time = primary.admit_time
            sib.prefill_pos = len(sib.prompt)      # decode-ready
            sib.cached_tokens = len(sib.prompt)    # whole prompt shared
            sib.state = RUNNING
            self.cache.fork_sequence(primary.req_id, sib.req_id)
            self.scheduler.running.append(sib)
            primary.forks.append(sib)
            self.tracer.on_enqueue(sib.req_id)
            self.tracer.on_admit(sib.req_id)
            tok, lp = _sample(logits_row, sib, len(sib.prompt))
            sib.logprob_sum += lp
            sib.first_token_time = now
            self.tracer.on_first_token(sib.req_id)
            self._emit_token(sib, tok)
        self._set_sched_gauges()
        serve_event("serve_fork", req_id=primary.req_id,
                    candidates=primary.n_candidates,
                    shared_blocks=self.cache.shared_blocks,
                    occupancy=round(self.cache.occupancy(), 4))

    def _emit_token(self, req: Request, tok: int) -> None:
        req.generated.append(tok)
        self._m_tokens.labels(kind="generated").inc()
        if req.callback is not None:
            req.callback(tok)
        hit_eos = req.eos_id is not None and tok == req.eos_id
        out_of_room = (len(req.tokens) >= self.max_seq_len - 1)
        if hit_eos or req.num_generated >= req.max_new_tokens or out_of_room:
            self._finish(req, "eos" if hit_eos else "length")

    def _finish(self, req: Request, reason: str) -> None:
        req.finish_time = time.monotonic()
        if self.demote_finished and self.host_tier is not None:
            # demote BEFORE the scheduler frees the blocks, so the tier
            # holds exactly the prefix this request committed
            self.cache.demote_sequence(req.req_id, reason="finish")
        self.scheduler.finish(req, reason)
        self.finished[req.req_id] = req
        ttft_ms = (req.first_token_time - req.enqueue_time) * 1e3
        decode_s = max(req.finish_time - req.first_token_time, 1e-9)
        n_gen = req.num_generated
        self._m_ttft.observe(ttft_ms)
        self._m_e2e.observe((req.finish_time - req.enqueue_time) * 1e3)
        if n_gen > 1:
            self._m_tpot.observe(decode_s * 1e3 / (n_gen - 1))
        self._m_reqs.labels(reason=reason).inc()
        self._set_sched_gauges()
        self.tracer.on_finish(req.req_id, reason)
        serve_event("serve_done", req_id=req.req_id, reason=reason,
                    tokens=n_gen, ttft_ms=round(ttft_ms, 3),
                    decode_tok_s=round(max(n_gen - 1, 0) / decode_s, 2),
                    cached_tokens=req.cached_tokens,
                    preemptions=req.preemptions)

    def _on_preempt(self, req: Request) -> None:
        self._m_preempts.inc()
        self._set_sched_gauges()
        self.tracer.on_preempt(req.req_id)
        serve_event("serve_preempt", req_id=req.req_id,
                    kept_tokens=len(req.prompt),
                    occupancy=round(self.cache.occupancy(), 4))

    # -- observability -----------------------------------------------------
    def stats(self) -> Dict[str, float]:
        """Cumulative serve counters: prefix-cache hit rate, prefill
        tokens actually computed, COW/shared block counts, peak block
        occupancy."""
        out = self.cache.stats()
        out.update({
            "prefill_tokens_computed": self.prefill_tokens_computed,
            "peak_occupancy": round(self.peak_occupancy, 4),
            "max_chunk_tokens": self.max_chunk_tokens,
            "steps": self.steps,
        })
        return out

    def reset_stats(self) -> None:
        """Zero the cumulative counters (after a warmup drain) without
        touching live state; also zeroes this engine's metrics registry
        IN PLACE and the request tracer."""
        self.cache.reset_stats()
        self.prefill_tokens_computed = 0
        self.peak_occupancy = 0.0
        self.max_chunk_tokens = 0
        self.steps = 0
        self.obs.reset()
        self.tracer.reset()
        # static-config series survive the zeroing: the tp degree, the
        # construction-time allreduce probe and a tier's warm start
        # describe this engine, not the traffic the reset baselines
        self._m_tp_size.set(float(self.tp_size))
        if self.host_tier is not None:
            self.host_tier.republish_boot_state()
        if self._serve_tp is not None:
            self._m_allreduce.labels(mode=self._serve_tp.mode).observe(
                self._allreduce_probe_ms)

    # -- convenience --------------------------------------------------------
    def generate(self, prompts: List[List[int]], max_new_tokens: int = 32,
                 **kwargs) -> List[List[int]]:
        """Batch-submit prompts, drain, return generations in order."""
        reqs = [self.add_request(p, max_new_tokens=max_new_tokens, **kwargs)
                for p in prompts]
        self.run()
        return [self._generated_of(r) for r in reqs]

    @staticmethod
    def _generated_of(req: Request) -> List[int]:
        """All tokens generated for a request, reassembling the ones a
        preemption folded into the prompt."""
        if req.preempt_carry:
            carried = req.prompt[len(req.prompt) - req.preempt_carry:]
            return list(carried) + list(req.generated)
        return list(req.generated)
