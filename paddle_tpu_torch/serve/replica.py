"""Replica CLI: one serving process = model + engine + front-end (port of
paddle_tpu/serve/replica.py).

`python -m paddle_tpu_torch.serve.replica --port 0 ...` builds a
CausalLM — either `--model-dir`, an export of the JAX package's
save_inference_model() (read without JAX, ServeEngine.from_saved_model),
or fresh weights drawn from a torch.Generator seeded with --init-seed:
every replica started with the same seed and dims holds IDENTICAL
weights (not the JAX package's weights for that seed: the two packages
draw from different generators) — wraps it in a ServeEngine and a
ServeFrontend, warms the one step program, and prints a single
`serve_listening` JSON line carrying the bound port (ephemeral with
--port 0) for the parent to read back.

`--device` picks where it serves: the CUDA card by default, the CPU only
when `--device cpu` is passed. Without a card and without `--device cpu`
the replica exits non-zero with a message; it never serves on the CPU
unasked. `--tp-size N` serves a tensor-parallel engine over N ranks
(engine/tp_worker.py): on the card one card a rank, cuda:0..N-1 (fewer
cards exit non-zero naming the count); with `--device cpu` N gloo ranks
on the CPU.

SIGTERM drains: in-flight streams finish (bounded by
--drain-deadline-s), then the process exits 75 (PREEMPT_EXIT_CODE) —
the same "safe to reschedule" contract as the training runtime.
"""

from __future__ import annotations

import argparse
import math
import sys
from typing import List, Optional

import torch

from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.models import CausalLM


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ptpu serve replica")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="0 binds an ephemeral port (printed in the "
                        "serve_listening line)")
    # model: a saved export, or a fresh deterministic init
    p.add_argument("--model-dir", default=None,
                   help="save_inference_model() directory with serve "
                        "metadata; omitting it builds a fresh model")
    p.add_argument("--vocab", type=int, default=61)
    p.add_argument("--model-dim", type=int, default=16)
    p.add_argument("--num-heads", type=int, default=4)
    p.add_argument("--num-layers", type=int, default=2)
    p.add_argument("--ffn-dim", type=int, default=32)
    p.add_argument("--max-len", type=int, default=64)
    p.add_argument("--init-seed", type=int, default=0,
                   help="torch.Generator seed for the fresh weights: same "
                        "seed + dims = identical weights on every "
                        "replica; also the byte tokenizer's seed")
    p.add_argument("--device", default="cuda",
                   help="where to serve: the CUDA card (default) or "
                        "'cpu', which must be asked for")
    # engine
    p.add_argument("--max-batch-size", type=int, default=4)
    p.add_argument("--block-size", type=int, default=4)
    p.add_argument("--num-blocks", type=int, default=64)
    p.add_argument("--max-prefill-tokens", type=int, default=64)
    p.add_argument("--tile-q", type=int, default=8)
    p.add_argument("--no-prefix-cache", action="store_true")
    p.add_argument("--spec-k", type=int, default=0,
                   help="speculative draft length (0 disables; > 0 "
                        "turns on the n-gram self-drafter)")
    p.add_argument("--host-tier-bytes", type=int, default=0,
                   help="host-RAM KV tier byte budget (0 disables; "
                        "> 0 demotes evicted/preempted blocks to host "
                        "and revives them by lane copies — "
                        "engine/kvtier.py)")
    p.add_argument("--kv-tier-int8", action="store_true",
                   help="store host-tier blocks int8-quantized "
                        "(roughly doubles the tier's effective budget)")
    p.add_argument("--kv-compress-blocks", type=int, default=0,
                   help="device int8 KV compression pool size in blocks "
                        "(0 disables): cold cached-free / idle shared "
                        "prefix blocks are quantized in place on device "
                        "and read in place by the mixed step on a prefix "
                        "hit — engine/paged_cache.py")
    p.add_argument("--tier-spill-dir", default=None,
                   help="warm-restart directory for the host KV tier: "
                        "the tier spills here when a drain completes "
                        "(and every --tier-spill-interval-s when > 0), "
                        "and a fresh boot warm-starts from the spill — "
                        "restart with the SAME dir to revive warm KV")
    p.add_argument("--tier-spill-interval-s", type=float, default=0.0,
                   help="also spill the host tier periodically (0 = "
                        "drain-time only); lets a SIGKILLed replica "
                        "warm-start from a recent snapshot")
    p.add_argument("--tp-size", type=int, default=1,
                   help="tensor-parallel degree: > 1 serves over that many "
                        "ranks, one card each (cuda:0..N-1), or all on "
                        "the CPU with --device cpu")
    p.add_argument("--phase", default="mixed",
                   choices=("prefill", "decode", "mixed"),
                   help="disaggregated-serving phase advertised to the "
                        "router (serve/kvxfer.py): a prefill replica "
                        "demotes every finished request's prefix blocks "
                        "into the host tier so decode replicas can pull "
                        "them over GET /kvblocks/<digest>")
    # fleet membership (serve/router.py POST /register)
    p.add_argument("--router-url", default=None,
                   help="router base url: heartbeat POST /register so "
                        "this replica joins (and re-joins after a "
                        "restart) without being on the router's argv")
    p.add_argument("--register-interval-s", type=float, default=2.0,
                   help="registration heartbeat cadence")
    # front-end / admission / drain
    p.add_argument("--max-queue-depth", type=int, default=64)
    p.add_argument("--drain-deadline-s", type=float, default=30.0)
    p.add_argument("--default-max-new-tokens", type=int, default=32)
    p.add_argument("--default-deadline-ms", type=float, default=None)
    # front-door security (serve/aio.py) + slow-client eviction
    p.add_argument("--tls-cert", default=None,
                   help="PEM certificate chain: serve https on the "
                        "asyncio transport (requires --tls-key)")
    p.add_argument("--tls-key", default=None,
                   help="PEM private key for --tls-cert")
    p.add_argument("--auth-token", default=None,
                   help="require 'Authorization: Bearer <token>' on "
                        "every route except /healthz (401 otherwise)")
    p.add_argument("--write-deadline-s", type=float, default=30.0,
                   help="slow-client eviction: a stream whose client "
                        "stops draining our writes for this long is "
                        "aborted and its engine work cancelled")
    # observability / postmortem
    p.add_argument("--dir-interval-s", type=float, default=0.25,
                   help="refresh cadence for the /kvprefixes "
                        "advertisement, /debug snapshot and scheduler "
                        "gauges")
    p.add_argument("--watchdog-s", type=float, default=0.0,
                   help="flag an engine step stuck longer than this "
                        "and dump a flight-recorder bundle "
                        "(0 disables the watchdog)")
    p.add_argument("--flightrec-out", default=None,
                   help="directory for postmortem flightrec-*.json "
                        "bundles (omit to keep them in memory only, "
                        "readable via /debug/flightrec)")
    p.add_argument("--flightrec-capacity", type=int, default=256,
                   help="events retained in the flight-recorder ring")
    p.add_argument("--enable-chaos", action="store_true",
                   help="mount GET /debug/stall/<s> (wedges the engine "
                        "loop for <s> seconds — bench/test fault "
                        "injection; NEVER enable in production)")
    # SLO objectives (obs/slo.py default_objectives)
    p.add_argument("--slo-ttft-ms", type=float, default=500.0)
    p.add_argument("--slo-tpot-ms", type=float, default=200.0)
    p.add_argument("--slo-queue-wait-ms", type=float, default=1000.0)
    p.add_argument("--slo-target", type=float, default=0.99)
    p.add_argument("--slo-short-window-s", type=float, default=5.0)
    p.add_argument("--slo-long-window-s", type=float, default=60.0)
    p.add_argument("--slo-burn-threshold", type=float, default=1.0)
    p.add_argument("--slo-min-samples", type=int, default=4)
    p.add_argument("--slo-interval-s", type=float, default=0.25)
    return p


def serving_device(a: argparse.Namespace):
    """Where the replica serves: `--device` (the card by default), or
    with `--tp-size` > 1 the ranks' devices. Raises RuntimeError when it
    names a card that is not there, and ValueError when --tp-size needs
    more cards than there are."""
    try:
        dev = resolve_device(a.device)
    except RuntimeError:
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to serve on the CPU") from None
    if a.tp_size > 1:
        from paddle_tpu_torch.engine.engine import tp_devices
        return tp_devices(a.tp_size, "cpu" if dev.type == "cpu" else None)
    return dev


def seeded_causal_lm(a: argparse.Namespace,
                     device: torch.device) -> CausalLM:
    """A fresh CausalLM whose weights are drawn on the CPU from a
    torch.Generator seeded with `--init-seed`, in parameter order, by
    the JAX initializers' distributions (glorot-uniform matrices, N(0,
    0.02) embeddings; biases and LayerNorm keep their constant init),
    then moved to `device`: the same seed and dims give the same
    weights on every replica and every device."""
    model = CausalLM(vocab=a.vocab, model_dim=a.model_dim,
                     num_heads=a.num_heads, num_layers=a.num_layers,
                     ffn_dim=a.ffn_dim, dropout=0.0, max_len=a.max_len,
                     device=device)
    gen = torch.Generator().manual_seed(a.init_seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() < 2:
                continue
            if name.startswith("embed."):
                w = torch.randn(p.shape, generator=gen) * 0.02
            else:
                lim = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
                w = (torch.rand(p.shape, generator=gen) * 2 - 1) * lim
            p.copy_(w.to(p.dtype))
    return model


def build_frontend(a: argparse.Namespace):
    """Everything up to (not including) start(): importable by tests
    that want an in-process replica with CLI-identical wiring. Raises
    RuntimeError without a card unless `--device cpu`."""
    from paddle_tpu_torch.engine.engine import ServeEngine
    from paddle_tpu_torch.obs.metrics import MetricsRegistry
    from paddle_tpu_torch.obs.slo import SLOMonitor, default_objectives
    from paddle_tpu_torch.serve.frontend import ServeFrontend

    device = serving_device(a)
    model_device = device[0] if isinstance(device, list) else device
    registry = MetricsRegistry()    # private: one process, one story
    engine_kw = dict(
        max_batch_size=a.max_batch_size, block_size=a.block_size,
        num_blocks=a.num_blocks, max_prefill_tokens=a.max_prefill_tokens,
        tile_q=a.tile_q, enable_prefix_cache=not a.no_prefix_cache,
        spec_k=a.spec_k, registry=registry,
        host_tier_bytes=a.host_tier_bytes, kv_tier_int8=a.kv_tier_int8,
        kv_compress_blocks=a.kv_compress_blocks,
        tier_spill_dir=a.tier_spill_dir, tp_size=a.tp_size,
        demote_finished=(a.phase == "prefill"), device=device)
    if a.model_dir:
        engine = ServeEngine.from_saved_model(a.model_dir, **engine_kw)
    else:
        engine = ServeEngine(seeded_causal_lm(a, model_device), **engine_kw)
    slo = SLOMonitor(
        registry,
        objectives=default_objectives(
            ttft_ms=a.slo_ttft_ms, tpot_ms=a.slo_tpot_ms,
            queue_wait_ms=a.slo_queue_wait_ms, target=a.slo_target),
        short_window_s=a.slo_short_window_s,
        long_window_s=a.slo_long_window_s,
        burn_threshold=a.slo_burn_threshold,
        min_samples=a.slo_min_samples)
    return ServeFrontend(
        engine, host=a.host, port=a.port, slo=slo,
        slo_interval_s=a.slo_interval_s,
        max_queue_depth=a.max_queue_depth,
        drain_deadline_s=a.drain_deadline_s,
        default_max_new_tokens=a.default_max_new_tokens,
        default_deadline_ms=a.default_deadline_ms,
        dir_interval_s=a.dir_interval_s,
        watchdog_s=a.watchdog_s,
        flightrec_out=a.flightrec_out,
        flightrec_capacity=a.flightrec_capacity,
        enable_chaos=a.enable_chaos,
        router_url=a.router_url,
        register_interval_s=a.register_interval_s,
        tier_spill_interval_s=a.tier_spill_interval_s,
        phase=a.phase, tokenizer_seed=a.init_seed,
        tls_cert=a.tls_cert, tls_key=a.tls_key,
        auth_token=a.auth_token,
        write_deadline_s=a.write_deadline_s)


def main(argv: Optional[List[str]] = None) -> int:
    a = build_parser().parse_args(argv)
    try:
        serving_device(a)
    except (RuntimeError, ValueError) as e:
        print(f"paddle_tpu_torch.serve.replica: {e}", file=sys.stderr)
        return 2
    frontend = build_frontend(a)
    try:
        frontend.start().install_signals()
        code = frontend.wait()      # blocks until a drain completes
        frontend._teardown()
    finally:
        frontend.engine.close()     # a tp engine's workers
    return code if code is not None else 0


if __name__ == "__main__":
    sys.exit(main())
