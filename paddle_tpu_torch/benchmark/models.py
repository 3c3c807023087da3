"""Benchmark model zoo (port of paddle_tpu/benchmark/models.py) — the
reference's benchmark/fluid/models/ (mnist, vgg, resnet, se_resnext,
machine_translation, stacked_dynamic_lstm) plus the CTR model and the
extra nets the reference publishes baselines for (AlexNet, GoogLeNet).

Each spec builds (trainer, batch) on synthetic data with JAX's
benchmark shapes, widths and default batch sizes — the port's models
from `paddle_tpu_torch.models`, its `Trainer` or `MeshTrainer` — then
hands off to harness.bench_trainer. Weights are the models' own random
init under `torch.manual_seed(0)`; inputs come from
`np.random.RandomState(0)`, as JAX's. Published reference numbers ride
along as `baseline` so every result carries a vs_baseline ratio.

A spec runs on the card unless the caller passes `device="cpu"` (or a
mesh, whose device it takes). `run_infer` times eval forwards of the
vision nets, and — the port's addition — generated tokens through a
`ServeEngine` over a `CausalLM` at the repo's LM widths: "causal_lm"
over fp KV pools (the ragged paged-attention kernel every step), and
"causal_lm_int8kv" with the in-device int8 KV tier on (the mixed
kernel every step).
"""

from __future__ import annotations

import contextlib
import logging
from typing import Callable, Dict, Optional

import numpy as np
import torch

from paddle_tpu_torch.benchmark.harness import (BenchResult, bench_trainer,
                                                chain_k, compiled_flops,
                                                device_name,
                                                device_peak_flops, run_timed)
from paddle_tpu_torch.core.executor import Trainer, supervised_loss
from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.metrics import accuracy
from paddle_tpu_torch.ops import functional as F
from paddle_tpu_torch.optim import Adam, Momentum
from paddle_tpu_torch.utils.tree import map_leaves

# Published reference numbers (BASELINE.md). value = items/s unless ms.
BASELINES = {
    "resnet50": 81.69,        # imgs/s bs=64, 2x Xeon MKL-DNN
    "vgg16": 28.46,           # VGG-19 imgs/s bs=64 (closest published)
    "alexnet": 399.00,        # imgs/s bs=64
    "googlenet": 250.46,      # imgs/s bs=64
    "stacked_lstm": 184.0,    # ms/batch bs=64 hidden=512, K40m
}


def _trainer_for(model, loss_fn, optimizer, mesh=None, strategy=None,
                 rules=None):
    if mesh is not None:
        from paddle_tpu_torch.parallel.trainer import MeshTrainer
        return MeshTrainer(model, optimizer, loss_fn, mesh,
                           strategy=strategy, rules=rules)
    return Trainer(model, optimizer, loss_fn)


def _put(trainer, batch, device: torch.device):
    """The host batch (numpy arrays) on the trainer's device: a
    MeshTrainer's `put_batch` (this rank's slice), else whole."""
    if hasattr(trainer, "put_batch"):
        return trainer.put_batch(batch)
    return map_leaves(lambda x: torch.as_tensor(x).to(device), batch)


def _ce(logits, y):
    return F.softmax_with_cross_entropy(logits.float(), y)


def _classify_trainer(model, optimizer, mesh, strategy, rules):
    loss_fn = supervised_loss(_ce, metrics={"acc": accuracy})
    return _trainer_for(model, loss_fn, optimizer, mesh, strategy, rules)


def _device(mesh, device) -> torch.device:
    return mesh.device if mesh is not None else resolve_device(device)


def _image_spec(model_ctor, img: int = 224, classes: int = 1000,
                default_bs: int = 64):
    def build(name, batch_size, dtype, mesh, strategy, rules, min_time,
              device=None):
        dev = _device(mesh, device)
        bs = batch_size or default_bs
        torch.manual_seed(0)
        model = model_ctor(classes, dtype, img, dev)
        trainer = _classify_trainer(
            model, Momentum(model.parameters(), 0.1, momentum=0.9), mesh,
            strategy, rules)
        rs = np.random.RandomState(0)
        x = rs.randn(bs, img, img, 3).astype(np.float32)
        y = rs.randint(0, classes, bs).astype(np.int64)
        batch = _put(trainer, (x, y), dev)
        return bench_trainer(name, trainer, batch, items_per_step=bs,
                             unit="imgs/s", batch_size=bs, min_time=min_time,
                             baseline=BASELINES.get(name))
    return build


def _mnist(name, batch_size, dtype, mesh, strategy, rules, min_time,
           device=None):
    from paddle_tpu_torch.models import LeNet
    dev = _device(mesh, device)
    bs = batch_size or 128
    torch.manual_seed(0)
    model = LeNet(num_classes=10, dtype=dtype, device=dev)
    trainer = _classify_trainer(model, Adam(model.parameters(), 1e-3), mesh,
                                strategy, rules)
    rs = np.random.RandomState(0)
    x = rs.randn(bs, 28, 28, 1).astype(np.float32)
    y = rs.randint(0, 10, bs).astype(np.int64)
    batch = _put(trainer, (x, y), dev)
    return bench_trainer(name, trainer, batch, items_per_step=bs,
                         unit="imgs/s", batch_size=bs, min_time=min_time)


def _fused_ce_correction(tokens: int, dim: int, vocab: int) -> float:
    """The fused cross-entropy's MFU correction for the port's count,
    which sees every vocab chunk of the eager loop."""
    from paddle_tpu_torch.ops.fused_ce import (effective_chunk,
                                               mfu_flops_correction)
    chunks = -(-vocab // effective_chunk(vocab))
    return mfu_flops_correction(tokens, dim, vocab, counted_chunks=chunks)


def _flash_correction(q_shape, device: torch.device, layers: int,
                      causal: bool) -> float:
    """FLOPs of the flash kernels, which the counter scores 0 (custom
    operators): on the model basis, 6*B*T^2*D a layer causal (fwd 2,
    bwd 4, half the full matmul count), twice that full, recompute
    excluded. 0 when `mha` takes the dense path, whose T^2 matmuls the
    counter does count."""
    from paddle_tpu_torch.kernels.attention import would_use_flash
    b, t, h, d = q_shape
    q = torch.empty((1, 1, h, d), device=device)
    if not would_use_flash(q, q):
        return 0.0
    per_layer = 6.0 * b * float(t) ** 2 * h * d
    return per_layer * layers * (1 if causal else 2)


def _transformer(name, batch_size, dtype, mesh, strategy, rules, min_time,
                 device=None, seq_len: int = 256, vocab: int = 32000,
                 fused_qkv: bool = False, raw_ce: bool = False,
                 fused_ce: bool = False, model_dim: int = 512,
                 num_heads: int = 8, num_layers: int = 6,
                 ffn_dim: int = 2048):
    """Transformer-base WMT (machine_translation.py / dist_transformer.py):
    tokens/s on the teacher-forced train step.

    fused_qkv / raw_ce / fused_ce are JAX's perf-variant knobs:
    Megatron-packed projections; feeding the logits straight to the
    internally-promoting CE instead of a float32 copy first; and the
    chunked linear_cross_entropy that never materializes [B, T, V]
    (ops/fused_ce.py). The widths are Transformer-base's unless given
    (tests run it narrow). Without a source mask every attention of the
    step — the encoder's, the decoder's causal self-attention and the
    cross-attention — takes the flash kernels on the card."""
    from paddle_tpu_torch.models import Transformer
    from paddle_tpu_torch.ops.fused_ce import linear_cross_entropy
    dev = _device(mesh, device)
    bs = batch_size or 32
    dim, heads, layers = model_dim, num_heads, num_layers
    torch.manual_seed(0)
    model = Transformer(src_vocab=vocab, trg_vocab=vocab, model_dim=dim,
                        num_heads=heads, num_layers=layers, ffn_dim=ffn_dim,
                        dropout=0.0, max_len=seq_len + 1, dtype=dtype,
                        fused_qkv=fused_qkv, device=dev)

    def loss_fn(module, batch, generator, training):
        src, trg_in, trg_out = batch
        if fused_ce:
            hid = module(src, trg_in, return_hidden=True,
                         generator=generator)
            head = module.head
            loss = linear_cross_entropy(
                hid, head.weight.to(hid.dtype), trg_out,
                head.bias.to(hid.dtype)).mean()
            return loss, {}
        logits = module(src, trg_in, generator=generator)
        if not raw_ce:
            logits = logits.float()
        return F.softmax_with_cross_entropy(logits, trg_out).mean(), {}

    trainer = _trainer_for(model, loss_fn, Adam(model.parameters(), 1e-4),
                           mesh, strategy, rules)
    rs = np.random.RandomState(0)
    src = rs.randint(0, vocab, (bs, seq_len)).astype(np.int32)
    trg = rs.randint(0, vocab, (bs, seq_len + 1)).astype(np.int32)
    batch = _put(trainer, (src, trg[:, :-1], trg[:, 1:]), dev)
    tokens = bs * seq_len
    local = batch[0].shape[0]          # this rank's rows under a mesh
    extra_flops = 0.0
    if fused_ce:
        extra_flops = _fused_ce_correction(local * seq_len, dim, vocab)
    shape = (local, seq_len, heads, dim // heads)
    # encoder self-attention and cross-attention full, decoder causal
    extra_flops += (_flash_correction(shape, dev, 2 * layers, False)
                    + _flash_correction(shape, dev, layers, True))
    return bench_trainer(name, trainer, batch, items_per_step=tokens,
                         unit="tokens/s", batch_size=bs, min_time=min_time,
                         extra_flops=extra_flops)


# CausalLM size shared by the lm_longctx train bench and the
# causal_lm inference bench ("same model size" by construction)
LM_BASE = dict(model_dim=512, num_heads=8, num_layers=6, ffn_dim=2048,
               dropout=0.0)
LM_VOCAB = 32000


def _lm_loss(module, batch, generator, training):
    """Mean fused cross-entropy of a CausalLM over its pre-head hidden
    states (no [T, V] logits), the head weights cast to their dtype."""
    from paddle_tpu_torch.ops.fused_ce import linear_cross_entropy
    inp, tgt = batch
    hid = module(inp, return_hidden=True, generator=generator)
    w, b_ = module.head_weights()
    return linear_cross_entropy(
        hid, w.to(hid.dtype), tgt,
        None if b_ is None else b_.to(hid.dtype)).mean(), {}


def _lm_longctx(name, batch_size, dtype, mesh, strategy, rules, min_time,
                device=None, seq_len: int = 16384, vocab: int = LM_VOCAB,
                **lm_widths):
    """Single-card long-context causal-LM train step: CausalLM with the
    block-causal flash kernels (O(T) score memory) + the chunked fused
    CE (no [T, V] logits) — the pairing that makes 16k-token LM training
    fit one card at all. `lm_widths` override LM_BASE's (tests run it
    narrow).

    MFU accounting: the flash kernels are custom operators the FLOP
    counter scores at zero, and the fused CE's chunks are counted each
    at 8*N*D*chunk — both corrected analytically on the model-FLOPs
    basis (causal attention at half the full matmul count, recompute
    excluded; see bench_trainer's extra_flops)."""
    from paddle_tpu_torch.models import CausalLM
    dev = _device(mesh, device)
    lm = dict(LM_BASE, **lm_widths)
    bs = batch_size or 1
    dim, heads, layers = lm["model_dim"], lm["num_heads"], lm["num_layers"]
    torch.manual_seed(0)
    model = CausalLM(vocab, max_len=seq_len, dtype=dtype, device=dev, **lm)
    trainer = _trainer_for(model, _lm_loss, Adam(model.parameters(), 1e-4),
                           mesh, strategy, rules)
    rs = np.random.RandomState(0)
    tok = rs.randint(0, vocab, (bs, seq_len + 1)).astype(np.int32)
    batch = _put(trainer, (tok[:, :-1], tok[:, 1:]), dev)
    tokens = bs * seq_len
    local = batch[0].shape[0]
    extra_flops = _fused_ce_correction(local * seq_len, dim, vocab)
    extra_flops += _flash_correction((local, seq_len, heads, dim // heads),
                                     dev, layers, True)
    return bench_trainer(name, trainer, batch, items_per_step=tokens,
                         unit="tokens/s", batch_size=bs, min_time=min_time,
                         extra_flops=extra_flops)


def _stacked_lstm(name, batch_size, dtype, mesh, strategy, rules, min_time,
                  device=None, seq_len: int = 100, vocab: int = 10000):
    """Stacked-LSTM text classifier (stacked_dynamic_lstm.py; the LSTM
    headline number README.md:112-120 is ms/batch bs=64 hidden=512)."""
    from paddle_tpu_torch.models import TextClassifier
    dev = _device(mesh, device)
    bs = batch_size or 64
    torch.manual_seed(0)
    model = TextClassifier(vocab=vocab, embed_dim=128, hidden=512, layers=2,
                           device=dev)
    trainer = _classify_trainer(model, Adam(model.parameters(), 1e-3), mesh,
                                strategy, rules)
    rs = np.random.RandomState(0)
    toks = rs.randint(0, vocab, (bs, seq_len)).astype(np.int32)
    y = rs.randint(0, 2, bs).astype(np.int64)
    batch = _put(trainer, (toks, y), dev)
    return bench_trainer(name, trainer, batch,
                         items_per_step=bs * seq_len, unit="tokens/s",
                         batch_size=bs, min_time=min_time,
                         baseline=BASELINES.get(name), baseline_is_ms=True)


def _bert(name, batch_size, dtype, mesh, strategy, rules, min_time,
          device=None, seq_len: int = 128, vocab: int = 30522,
          model_dim: int = 768, num_layers: int = 12, num_heads: int = 12,
          ffn_dim: int = 3072, mask_frac: float = 0.15,
          fused_qkv: bool = False):
    """BERT-base MLM pretraining step (BASELINE BERT row: pod-scale
    allreduce / 8->32 chip scaling). A static masked-position count keeps
    one step shape."""
    from paddle_tpu_torch.models import BertEncoder
    dev = _device(mesh, device)
    bs = batch_size or 32
    k = max(1, int(seq_len * mask_frac))
    torch.manual_seed(0)
    model = BertEncoder(vocab=vocab, model_dim=model_dim,
                        num_heads=num_heads, num_layers=num_layers,
                        ffn_dim=ffn_dim, max_len=seq_len, dropout=0.0,
                        dtype=dtype, fused_qkv=fused_qkv, device=dev)

    def loss_fn(module, batch, generator, training):
        tokens, positions, labels = batch
        logits = module(tokens, positions, generator=generator)
        return F.softmax_with_cross_entropy(logits.float(),
                                            labels).mean(), {}

    trainer = _trainer_for(model, loss_fn, Adam(model.parameters(), 1e-4),
                           mesh, strategy, rules)
    rs = np.random.RandomState(0)
    tokens = rs.randint(0, vocab, (bs, seq_len)).astype(np.int32)
    positions = np.sort(
        rs.rand(bs, seq_len).argsort(axis=1)[:, :k], axis=1).astype(np.int32)
    labels = rs.randint(0, vocab, (bs, k)).astype(np.int32)
    batch = _put(trainer, (tokens, positions, labels), dev)
    local = batch[0].shape[0]
    extra_flops = _flash_correction(
        (local, seq_len, num_heads, model_dim // num_heads), dev,
        num_layers, False)
    return bench_trainer(name, trainer, batch,
                         items_per_step=bs * seq_len, unit="tokens/s",
                         batch_size=bs, min_time=min_time,
                         extra_flops=extra_flops)


def _bert_tiny(name, batch_size, dtype, mesh, strategy, rules, min_time,
               device=None):
    """Small-config BERT for CPU-mesh scaling CI (same code path)."""
    return _bert(name, batch_size, dtype, mesh, strategy, rules, min_time,
                 device=device, seq_len=32, vocab=1024, model_dim=64,
                 num_layers=2, num_heads=4, ffn_dim=128)


def _deepfm(name, batch_size, dtype, mesh, strategy, rules, min_time,
            device=None, fields: int = 26, vocab_per_field: int = 1000,
            dense_dim: int = 13):
    """DeepFM CTR (dist_ctr capability; BASELINE DeepFM target)."""
    from paddle_tpu_torch.models import DeepFM
    dev = _device(mesh, device)
    bs = batch_size or 512
    torch.manual_seed(0)
    model = DeepFM(num_fields=fields, vocab_per_field=vocab_per_field,
                   dense_dim=dense_dim, device=dev)

    def loss_fn(module, batch, generator, training):
        dense, sparse, y = batch
        logit = module(dense, sparse, generator=generator)
        return F.sigmoid_cross_entropy_with_logits(logit, y).mean(), {}

    trainer = _trainer_for(model, loss_fn, Adam(model.parameters(), 1e-3),
                           mesh, strategy, rules)
    rs = np.random.RandomState(0)
    dense = rs.randn(bs, dense_dim).astype(np.float32)
    sparse = rs.randint(0, vocab_per_field, (bs, fields)).astype(np.int32)
    y = rs.randint(0, 2, bs).astype(np.float32)
    batch = _put(trainer, (dense, sparse, y), dev)
    return bench_trainer(name, trainer, batch, items_per_step=bs,
                         unit="samples/s", batch_size=bs, min_time=min_time)


def _registry() -> Dict[str, Callable]:
    from paddle_tpu_torch.models import vision as V
    return {
        "mnist": _mnist,
        "mlp": _image_spec(lambda classes, dtype, img, dev: V.MLP(
            num_classes=classes, in_shape=(img, img, 3), dtype=dtype,
            device=dev), img=28, classes=10, default_bs=128),
        "alexnet": _image_spec(lambda classes, dtype, img, dev: V.AlexNet(
            classes, in_shape=(img, img, 3), dtype=dtype, device=dev)),
        "vgg16": _image_spec(lambda classes, dtype, img, dev: V.vgg16(
            classes, in_shape=(img, img, 3), dtype=dtype, device=dev)),
        "resnet50": _image_spec(lambda classes, dtype, img, dev: V.resnet50(
            classes, dtype=dtype, device=dev)),
        "se_resnext50": _image_spec(
            lambda classes, dtype, img, dev: V.se_resnext50(
                classes, dtype=dtype, device=dev)),
        "googlenet": _image_spec(lambda classes, dtype, img, dev: V.GoogLeNet(
            classes, dtype=dtype, device=dev)),
        "transformer": _transformer,
        "lm_longctx": _lm_longctx,
        "bert": _bert,
        "bert_tiny": _bert_tiny,
        "stacked_lstm": _stacked_lstm,
        "deepfm": _deepfm,
    }


MODELS = _registry()


def run_model(name: str, batch_size: Optional[int] = None,
              dtype: torch.dtype = torch.float32, mesh=None, strategy=None,
              rules=None, min_time: float = 2.0, device=None,
              **model_kwargs) -> BenchResult:
    """Train-step throughput of the registry's model `name` on the card
    (`device="cpu"` for the CPU; under `mesh`, its device and ranks)."""
    if name not in MODELS:
        raise ValueError(f"unknown benchmark model {name!r}; "
                         f"choose from {sorted(MODELS)}")
    return MODELS[name](name, batch_size, dtype, mesh, strategy, rules,
                        min_time, device=device, **model_kwargs)


# Published reference INFERENCE numbers (BASELINE.md: Xeon E5-2650v4,
# MKL-DNN): imgs/s at the listed batch size.
INFER_BASELINES = {
    ("resnet50", 1): 107.83,
    ("resnet50", 16): 217.69,
    ("googlenet", 16): 600.94,
    ("alexnet", 16): 850.51,
    ("vgg16", 1): 75.07,        # VGG-19 figure; closest published
}

# the causal_lm inference traffic: a wave of `batch_size` prompts of
# PROMPT tokens, NEW greedy tokens each, through one ServeEngine
LM_INFER = dict(prompt=128, new=32, block_size=16, tile_q=8,
                max_prefill=512, compress_blocks=256)


def _infer_models():
    from paddle_tpu_torch.models import vision as V

    def image(ctor):
        return lambda d, img, dev: ctor(d, img, dev)

    return {
        "resnet50": image(lambda d, img, dev: V.resnet50(
            1000, dtype=d, device=dev)),
        "googlenet": image(lambda d, img, dev: V.GoogLeNet(
            1000, dtype=d, device=dev)),
        "alexnet": image(lambda d, img, dev: V.AlexNet(
            1000, in_shape=(img, img, 3), dtype=d, device=dev)),
        "vgg16": image(lambda d, img, dev: V.vgg16(
            1000, in_shape=(img, img, 3), dtype=d, device=dev)),
        "causal_lm": None,
        "causal_lm_int8kv": None,
    }


# derived from the ctor table so the CLI gate and run_infer can
# never drift apart
INFER_MODELS = tuple(sorted(_infer_models()))


def lm_infer_flops(batch: int, prompt: int, new: int, dim: int,
                   layers: int, ffn: int, vocab: int,
                   kv_dim: Optional[int] = None) -> float:
    """Model FLOPs of one causal_lm wave: 2 a weight a token through the
    projections, FFN and head over the prompt and the new - 1 tokens fed
    back, plus 4*D a visible (query, key) pair a layer (scores and
    values): P(P+1)/2 pairs a prompt, c + 1 for the token at position
    c."""
    kv = dim if kv_dim is None else kv_dim
    weights = layers * (2 * dim * dim + 2 * dim * kv + 2 * dim * ffn) \
        + dim * vocab
    tokens = prompt + new - 1
    pairs = prompt * (prompt + 1) // 2 + sum(
        c + 1 for c in range(prompt, prompt + new - 1))
    return float(batch) * (2.0 * weights * tokens + 4.0 * dim * layers * pairs)


@contextlib.contextmanager
def _quiet_serve():
    """The engine's serve stream prints a JSON line a step; keep a
    benchmark's output to its results."""
    lg = logging.getLogger("paddle_tpu_torch.serve")
    was, lg.disabled = lg.disabled, True
    try:
        yield
    finally:
        lg.disabled = was


def _run_infer_lm(name: str, batch_size: int, dtype: torch.dtype,
                  min_time: float, dev: torch.device,
                  vocab: int = LM_VOCAB, prompt: int = LM_INFER["prompt"],
                  new: int = LM_INFER["new"], max_len: int = 2048,
                  **lm_widths) -> BenchResult:
    """Generated tokens/s of a ServeEngine: each timed step is one wave
    of `batch_size` greedy requests of `prompt` tokens, `new` tokens
    each, drained. Wave k's prompts come from RandomState(k), their first
    token folded with the previous wave's first generated token (the
    run_timed caller contract)."""
    from paddle_tpu_torch.engine import ServeEngine
    from paddle_tpu_torch.models import CausalLM
    from paddle_tpu_torch.obs.metrics import MetricsRegistry
    lm = dict(LM_BASE, **lm_widths)
    c = LM_INFER
    p, bsz = prompt, c["block_size"]
    per_seq = -(-(p + new) // bsz)
    torch.manual_seed(0)
    model = CausalLM(vocab, max_len=max(max_len, p + new), dtype=dtype,
                     device=dev, **lm)
    int8 = name == "causal_lm_int8kv"
    engine = ServeEngine(
        model, max_batch_size=batch_size, block_size=bsz,
        num_blocks=2 * batch_size * per_seq + 1,
        max_prefill_tokens=max(c["max_prefill"], p), tile_q=c["tile_q"],
        kv_compress_blocks=c["compress_blocks"] if int8 else 0,
        registry=MetricsRegistry(), device=dev)

    def wave(state):
        k, prev = state
        prompts = np.random.RandomState(k).randint(0, vocab,
                                                   (batch_size, p))
        prompts[0, 0] = (prompts[0, 0] + prev) % vocab
        out = engine.generate(prompts.tolist(), max_new_tokens=new)
        return (k + 1, out[0][0]), None

    with _quiet_serve():
        sec, steps, _ = run_timed(wave, (0, 0), min_time=min_time,
                                  device=dev)
    flops = lm_infer_flops(batch_size, p, new, lm["model_dim"],
                           lm["num_layers"], lm["ffn_dim"], vocab)
    peak = device_peak_flops(device=dev)
    return BenchResult(
        model=f"{name}_infer", unit="tokens/s",
        value=batch_size * new / sec, ms_per_step=sec * 1e3, steps=steps,
        batch_size=batch_size, flops_per_step=flops,
        tflops_per_sec=flops / sec / 1e12,
        mfu=(flops / sec / peak) if peak else None,
        device=device_name(dev), vs_baseline=None)


def run_infer(name: str, batch_size: int = 16,
              dtype: torch.dtype = torch.float32, min_time: float = 2.0,
              img: int = 224, device=None, **lm_widths) -> BenchResult:
    """Inference throughput (reference IntelOptimizedPaddle.md infer
    table; the served-model path: eval-mode forward, no grads), on the
    card unless `device="cpu"`. The causal_lm models take LM_BASE's
    widths, overridden by `lm_widths` (and `vocab`, `max_len` and the
    wave's `prompt` and `new` tokens)."""
    ctors = _infer_models()
    if name not in ctors:
        raise ValueError(f"unknown infer model {name!r}; "
                         f"choose from {sorted(ctors)}")
    dev = resolve_device(device)
    if ctors[name] is None:
        return _run_infer_lm(name, batch_size, dtype, min_time, dev,
                             **lm_widths)
    torch.manual_seed(0)
    model = ctors[name](dtype, img, dev)
    model.eval()
    rs = np.random.RandomState(0)
    x = torch.as_tensor(rs.randn(batch_size, img, img, 3),
                        dtype=torch.float32).to(dev)

    # K forwards chained in one step (chain_k) and the carry chained
    # across steps (run_timed's caller contract)
    K = 8 if dev.type == "cuda" else 2

    def fwd(c, xx):
        return model(xx + c)

    kfwd = chain_k(fwd, K)

    def step(s):
        s2 = kfwd(s, x)
        return s2, s2

    with torch.no_grad():
        sec_k, steps, _ = run_timed(step, torch.zeros((), device=dev),
                                    min_time=min_time, device=dev)
        flops = compiled_flops(model, x)
    sec = sec_k / K
    steps *= K
    peak = device_peak_flops(device=dev)
    baseline = INFER_BASELINES.get((name, batch_size))
    value = batch_size / sec
    return BenchResult(
        model=f"{name}_infer", unit="imgs/s", value=value,
        ms_per_step=sec * 1e3, steps=steps, batch_size=batch_size,
        flops_per_step=flops,
        tflops_per_sec=(flops / sec / 1e12) if flops else None,
        mfu=(flops / sec / peak) if (flops and peak) else None,
        device=device_name(dev),
        vs_baseline=(value / baseline) if baseline else None)
