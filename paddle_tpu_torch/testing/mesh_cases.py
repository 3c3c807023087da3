"""One table of mesh scenarios (in the pattern of op_cases, nn_cases and
quant_cases): each names a mesh, a strategy, sharding rules, a model
with its weights, a stream of global batches and a step count, and a
runner that drives them on one rank and returns what the rank holds
after (flat {key: numpy array}; a sharded leaf as `pieces` records it,
which `split` reads back a rank at a time and `join` whole).

    python -m paddle_tpu_torch.testing.mesh_cases   # one rank of a world

`run_world(n, names, device)` launches n ranks through
parallel/launch.py, each running the named scenarios in order over one
mesh a scenario, and returns every rank's results; `run_single(name)`
runs a scenario's model on one rank with the whole batch (the
single-device reference). The CPU tests hold the ranks against the JAX
package on the same numpy-seeded weights and batches (`jax_tree`,
`batches`); chip_smoke.py reads the table too.

Weights are JAX-layout numpy trees drawn from a seed (the MLP's and the
Transformer's), or the port's own seeded init where only port runs are
compared (DeepFM, the sync-BN model).
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import tempfile
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

REPO_ROOT = str(Path(__file__).resolve().parents[2])


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A mesh (axis sizes), the model key, the runner kind, the steps,
    the optimizer (name, lr), DistStrategy fields, the rule key and the
    batch stream key."""
    mesh: Dict[str, int]
    model: str
    kind: str = "train"
    steps: int = 3
    optimizer: Tuple[str, float] = ("sgd", 0.05)
    strategy: Dict[str, Any] = dataclasses.field(default_factory=dict)
    rules: str = "whole"
    feed: str = "cls8"
    batch: int = 32
    record: Tuple[str, ...] = ()
    clip: Optional[Tuple[str, float]] = None


SCENARIOS: Dict[str, Scenario] = {
    # tests/test_parallel.py's dp cases on a 4-rank dp mesh
    "mlp_dp": Scenario(dict(dp=4), "mlp", steps=10),
    "mlp_dp_learns": Scenario(dict(dp=4), "mlp", steps=40,
                              optimizer=("adam", 1e-2)),
    "mlp_accum": Scenario(dict(dp=4), "mlp", kind="accum", steps=1,
                          optimizer=("sgd", 0.1)),
    # ZeRO: params, grads and Adam slots sharded over fsdp
    "mlp_zero": Scenario(dict(dp=2, fsdp=2), "mlp128", steps=40,
                         optimizer=("adam", 1e-2),
                         strategy=dict(reduce_strategy="reduce"),
                         rules="fsdp128", record=("pieces@3",)),
    # norm clipping over sharded gradients (each norm spans ranks)
    "mlp_clip_norm": Scenario(dict(dp=2, fsdp=2), "mlp128", steps=3,
                              optimizer=("adam", 1e-2),
                              strategy=dict(reduce_strategy="reduce"),
                              rules="fsdp128", clip=("norm", 0.05)),
    "mlp_clip_global": Scenario(dict(dp=2, fsdp=2), "mlp128", steps=3,
                                optimizer=("adam", 1e-2),
                                strategy=dict(reduce_strategy="reduce"),
                                rules="fsdp128", clip=("global_norm", 0.1)),
    "mlp_freed": Scenario(dict(dp=2, fsdp=2), "mlp128", kind="freed",
                          steps=1, optimizer=("adam", 1e-2),
                          strategy=dict(reduce_strategy="reduce"),
                          rules="fsdp128", clip=("global_norm", 0.1)),
    "mlp_eval": Scenario(dict(dp=2, fsdp=2), "mlp64x2", kind="eval",
                         strategy=dict(reduce_strategy="reduce"),
                         rules="fsdp128", feed="cls16", batch=8),
    # Megatron tp on a tiny Transformer, batch over dp only
    "tf_tp": Scenario(dict(dp=2, tp=2), "tiny_tf", steps=3,
                      strategy=dict(batch_axes=("dp",)), rules="tp",
                      feed="seq", batch=8, record=("grads@1",)),
    "bert_tp": Scenario(dict(dp=2, tp=2), "tiny_bert", steps=3,
                        strategy=dict(batch_axes=("dp",)), rules="tp",
                        feed="mlm", batch=8),
    "tf_remat": Scenario(dict(dp=2, tp=2), "tiny_tf_drop", kind="remat",
                         steps=2, strategy=dict(batch_axes=("dp",)),
                         rules="tp", feed="seq", batch=8),
    "tf_tp_masks": Scenario(dict(dp=2, tp=2), "tiny_tf_drop",
                            kind="tp_masks", steps=1,
                            strategy=dict(batch_axes=("dp",)), rules="tp",
                            feed="seq", batch=8),
    "mlp_guard": Scenario(dict(dp=4), "mlp", kind="guard", steps=3,
                          optimizer=("adam", 1e-2),
                          strategy=dict(bad_step_budget=3)),
    "bn_sync": Scenario(dict(dp=4), "bn_mlp", steps=3,
                        optimizer=("sgd", 0.1), record=("grads@1",)),
    "mesh_shapes": Scenario(dict(dp=2, tp=2), "none", kind="shapes"),
    # the sharded embedding (tests/test_sparse_embedding.py)
    "emb_lookup": Scenario(dict(dp=2, fsdp=2), "none", kind="lookup"),
    "deepfm_sharded": Scenario(dict(dp=2, fsdp=2), "deepfm", steps=10,
                               optimizer=("adam", 1e-2),
                               strategy=dict(batch_axes=("dp",)),
                               rules="deepfm", feed="ctr", batch=16),
    "deepfm_split_ids": Scenario(dict(dp=2, fsdp=2), "deepfm", steps=4,
                                 optimizer=("adam", 1e-2),
                                 rules="embedding", feed="ctr", batch=16),
    "deepfm_reader": Scenario(dict(dp=2, fsdp=2), "deepfm6", kind="reader",
                              optimizer=("adam", 1e-2),
                              strategy=dict(batch_axes=("dp",)),
                              rules="embedding", feed="ctr", batch=16),
    # sharded checkpoints (tests/test_io.py)
    "ckpt_roundtrip": Scenario(dict(dp=2, fsdp=2), "mlp64", kind="ckpt",
                               steps=1, optimizer=("adam", 1e-3),
                               strategy=dict(reduce_strategy="reduce"),
                               rules="fsdp64", feed="cls32", batch=16),
    "ckpt_restore_step": Scenario(dict(dp=2, fsdp=2), "mlp64c4",
                                  kind="ckpt_restore", steps=1,
                                  strategy=dict(reduce_strategy="reduce"),
                                  rules="fsdp64", feed="cls6", batch=8),
    "ckpt_from_jax": Scenario(dict(dp=2, fsdp=2), "mlp64", kind="from_jax",
                              optimizer=("adam", 1e-3),
                              strategy=dict(reduce_strategy="reduce"),
                              rules="fsdp64", feed="cls32", batch=16),
    "ckpt_to_jax": Scenario(dict(dp=2, fsdp=2), "mlp64", kind="to_jax",
                            steps=2, optimizer=("adam", 1e-3),
                            strategy=dict(reduce_strategy="reduce"),
                            rules="fsdp64", feed="cls32", batch=16),
    # chip_smoke.py's mesh_train: the repo's LM under each mode (the LM
    # configuration and the runs come from PTPU_LM, `lm_conf`)
    "lm_dp": Scenario(dict(dp=2), "lm", kind="lm"),
    "lm_fsdp": Scenario(dict(fsdp=2), "lm", kind="lm",
                        strategy=dict(reduce_strategy="reduce"),
                        rules="fsdp_lm"),
    "lm_tp": Scenario(dict(tp=2), "lm", kind="lm", rules="tp"),
    "lm_zero_save": Scenario(dict(dp=2, fsdp=2), "lm", kind="lm_save",
                             strategy=dict(reduce_strategy="reduce"),
                             rules="fsdp_lm"),
    "lm_zero_resume": Scenario(dict(dp=2, fsdp=2), "lm", kind="lm_resume",
                               strategy=dict(reduce_strategy="reduce"),
                               rules="fsdp_lm"),
}


# -- weights --------------------------------------------------------------

MLP_SHAPES = {"mlp": ((16,), 8, 4), "mlp128": ((128,), 8, 4),
              "mlp64x2": ((64, 64), 16, 4), "mlp64": ((64,), 32, 8),
              "mlp64c4": ((64,), 6, 4)}
TF_DIMS = dict(src_vocab=32, trg_vocab=32, model_dim=16, num_heads=4,
               num_layers=2, ffn_dim=32, max_len=16)
BERT_DIMS = dict(vocab=32, model_dim=16, num_heads=4, num_layers=2,
                 ffn_dim=32, max_len=16)


def mlp_tree(hidden: Sequence[int], n_in: int, classes: int,
             seed: int = 0) -> Dict:
    """A JAX-layout MLP tree (`fcs_{i}`, `head`) of glorot-uniform
    weights and small random biases."""
    rng = np.random.default_rng(seed)
    params = {}
    widths = [n_in, *hidden]

    def lin(a, b):
        lim = np.sqrt(6.0 / (a + b))
        return {"weight": rng.uniform(-lim, lim, (a, b)).astype(np.float32),
                "bias": (0.01 * rng.standard_normal(b)).astype(np.float32)}
    for i, (a, b) in enumerate(zip(widths, widths[1:])):
        params[f"fcs_{i}"] = lin(a, b)
    params["head"] = lin(widths[-1], classes)
    return {"params": params}


def jax_tree(model: str, seed: int = 0) -> Dict:
    """The numpy weights of a table model in JAX's layout."""
    if model in MLP_SHAPES:
        return mlp_tree(*MLP_SHAPES[model], seed=seed)
    if model.startswith("tiny_tf"):
        from paddle_tpu_torch.testing import transformer_tree
        d = TF_DIMS
        return transformer_tree(seed, d["src_vocab"], d["trg_vocab"],
                                d["model_dim"], d["num_heads"],
                                d["num_layers"], d["ffn_dim"],
                                random_norms=True)
    if model == "tiny_bert":
        from paddle_tpu_torch.testing import bert_tree
        return bert_tree(seed, fused_qkv=True, random_norms=True,
                         **BERT_DIMS)
    raise KeyError(model)


class BNNet(nn.Module):
    """Linear, BatchNorm (synchronised over `axis_name`), ReLU, Linear."""

    def __init__(self, axis_name=None, device="cpu"):
        super().__init__()
        from paddle_tpu_torch.nn.layers import BatchNorm, Linear
        self.fc = Linear(8, 16, device=device)
        self.bn = BatchNorm(16, axis_name=axis_name, device=device)
        self.head = Linear(16, 4, device=device)

    def forward(self, x, generator=None):
        return self.head(torch.relu(self.bn(self.fc(x))))


def build(model: str, device, mesh=None, seed: int = 0) -> nn.Module:
    """The port module of a table model, its weights loaded (every rank
    builds the same)."""
    from paddle_tpu_torch.models import load_jax_params
    if model in MLP_SHAPES:
        from paddle_tpu_torch.models.vision import MLP
        hidden, n_in, classes = MLP_SHAPES[model]
        m = MLP(hidden=hidden, num_classes=classes, in_shape=(n_in, 1, 1),
                device=device)
        return load_jax_params(m, jax_tree(model, seed))
    if model.startswith("tiny_tf"):
        from paddle_tpu_torch.models import Transformer
        m = Transformer(dropout=0.1 if model.endswith("drop") else 0.0,
                        device=device, **TF_DIMS)
        return load_jax_params(m, jax_tree(model, seed))
    if model == "tiny_bert":
        from paddle_tpu_torch.models import BertEncoder
        m = BertEncoder(dropout=0.0, fused_qkv=True, device=device,
                        **BERT_DIMS)
        return load_jax_params(m, jax_tree(model, seed))
    # the port's own init, drawn on the CPU and then moved, so ranks on
    # cards start from the CPU reference's weights (a CUDA generator
    # draws other bits from the same seed)
    torch.manual_seed(seed)
    if model == "bn_mlp":
        return BNNet("dp", "cpu").to(device)
    if model.startswith("deepfm"):
        from paddle_tpu_torch.models.nlp import DeepFM
        from paddle_tpu_torch.parallel.embedding import ShardedEmbedding
        fields = 6 if model == "deepfm6" else 4
        vocab = 40 if model == "deepfm6" else 32
        return DeepFM(num_fields=fields, vocab_per_field=vocab,
                      dense_dim=8 if model == "deepfm6" else 6, embed_dim=8,
                      mlp_dims=(32,) if model == "deepfm6" else (32, 32),
                      embedding_cls=ShardedEmbedding, device="cpu",
                      axis="fsdp", mesh=mesh, batch_axes=("dp",)).to(device)
    raise KeyError(model)


def rules(key: str):
    from paddle_tpu_torch.parallel import sharding as S
    from paddle_tpu_torch.parallel.embedding import embedding_rules
    if key == "whole":
        return None
    if key.startswith("fsdp"):
        return S.fsdp_rules(min_size=int(key[4:]))
    if key == "tp":
        return S.transformer_tp_rules()
    if key == "embedding":
        return embedding_rules("fsdp")
    if key == "deepfm":
        r = S.fsdp_rules(min_size=1 << 30)     # the dense tower whole
        return r.add(r"(table|w1)/weight$", ("fsdp", None))
    raise KeyError(key)


# -- batches and losses -----------------------------------------------------

def cls_batches(n: int, bs: int, dim: int = 8, classes: int = 4,
                seed: int = 0) -> List[Tuple[np.ndarray, np.ndarray]]:
    """tests/test_parallel.py's `_batches`: a linear teacher's labels."""
    rng = np.random.RandomState(seed)
    w = rng.randn(dim, classes)
    out = []
    for _ in range(n):
        x = rng.randn(bs, dim).astype(np.float32)
        y = np.argmax(x @ w + 0.1 * rng.randn(bs, classes), -1)
        out.append((x, y.astype(np.int64)))
    return out


def seq_batch(bs: int = 8) -> Tuple[np.ndarray, ...]:
    """tests/test_parallel.py's tp batch: (src, trg_in, trg_out)."""
    rs = np.random.RandomState(0)
    src = rs.randint(0, 32, (bs, 6)).astype(np.int32)
    trg = rs.randint(0, 32, (bs, 7)).astype(np.int32)
    return src, trg[:, :-1], trg[:, 1:]


def mlm_batch(bs: int) -> Tuple[np.ndarray, ...]:
    """(tokens [B, 12], lengths [B], mask positions [B, 3], labels)."""
    rs = np.random.RandomState(5)
    lengths = rs.randint(6, 13, bs).astype(np.int32)
    pos = np.stack([rs.choice(int(n), 3, replace=False) for n in lengths])
    return (rs.randint(0, 32, (bs, 12)).astype(np.int32), lengths,
            pos.astype(np.int32), rs.randint(0, 32, (bs, 3)).astype(np.int32))


def ctr_batch(bs: int, fields: int = 4, vocab: int = 32,
              dense: int = 6) -> Tuple[np.ndarray, ...]:
    rs = np.random.RandomState(100)
    return (rs.randn(bs, dense).astype(np.float32),
            rs.randint(0, vocab, (bs, fields)).astype(np.int32),
            rs.randint(0, 2, bs).astype(np.float32))


def batches(sc: Scenario, steps: Optional[int] = None) -> List:
    n = sc.steps if steps is None else steps
    if sc.feed.startswith("cls"):
        dims = {"cls8": (8, 4), "cls16": (16, 4), "cls32": (32, 8),
                "cls6": (6, 4)}[sc.feed]
        return cls_batches(n, sc.batch, *dims)
    if sc.feed == "seq":
        return [seq_batch(sc.batch)] * n
    if sc.feed == "ctr":
        return [ctr_batch(sc.batch)] * n
    if sc.feed == "mlm":
        return [mlm_batch(sc.batch)] * n
    raise KeyError(sc.feed)


def loss_fn(sc: Scenario) -> Callable:
    from paddle_tpu_torch.core import supervised_loss
    from paddle_tpu_torch.ops import functional as F
    if sc.feed.startswith("cls"):
        return supervised_loss(
            lambda lg, y: F.softmax_with_cross_entropy(lg, y))
    if sc.feed == "seq":
        def seq_loss(module, batch, generator, training):
            src, trg_in, trg_out = batch
            logits = module(src, trg_in, generator=generator)
            return torch.mean(F.softmax_with_cross_entropy(
                logits, trg_out.long())), {}
        return seq_loss

    if sc.feed == "mlm":
        def mlm_loss(module, batch, generator, training):
            tokens, lengths, pos, labels = batch
            logits = module(tokens, mask_positions=pos, lengths=lengths,
                            generator=generator)
            return torch.mean(F.softmax_with_cross_entropy(
                logits, labels.long())), {}
        return mlm_loss

    def ctr_loss(module, batch, generator, training):
        dense, sparse, y = batch
        logit = module(dense, sparse)
        return torch.mean(F.sigmoid_cross_entropy_with_logits(logit, y)), {}
    return ctr_loss


def strategy(sc: Scenario, **over):
    from paddle_tpu_torch.parallel import DistStrategy, ReduceStrategy
    kw = {**sc.strategy, **over}
    if "reduce_strategy" in kw:
        kw["reduce_strategy"] = ReduceStrategy(kw["reduce_strategy"])
    return DistStrategy(**kw)


def trainer(sc: Scenario, mesh, device, **over):
    from paddle_tpu_torch.optim import SGD, Adam
    from paddle_tpu_torch.parallel import MeshTrainer
    model = build(sc.model, device, mesh)
    opt_cls = {"sgd": SGD, "adam": Adam}[sc.optimizer[0]]
    return MeshTrainer(model, opt_cls(model.parameters(), sc.optimizer[1],
                                      grad_clip=sc.clip),
                       loss_fn(sc), mesh, strategy=strategy(sc, **over),
                       rules=rules(sc.rules), seed=0)


# -- recording --------------------------------------------------------------

def _host(t: torch.Tensor) -> np.ndarray:
    """A float32 numpy copy (never a view of a live tensor)."""
    return t.detach().float().cpu().numpy().copy()


def pieces(tree, prefix: str) -> Dict[str, np.ndarray]:
    """{prefix/path: data, prefix/path#index: spans, #shape: the global
    shape, #owner} of a tree of Pieces (whole tensors: the data alone)."""
    from paddle_tpu_torch.parallel.sharding import Piece
    from paddle_tpu_torch.utils.tree import flatten_with_keys
    out = {}
    for k, v in flatten_with_keys(tree):
        if isinstance(v, Piece):
            out[f"{prefix}/{k}"] = _host(v.data)
            out[f"{prefix}/{k}#index"] = np.asarray(v.spans(), np.int64)
            out[f"{prefix}/{k}#shape"] = np.asarray(v.shape, np.int64)
            out[f"{prefix}/{k}#owner"] = np.asarray(v.owner)
        else:
            out[f"{prefix}/{k}"] = (_host(v) if isinstance(v, torch.Tensor)
                                    else np.array(v))
    return out


def split(res: Dict[str, np.ndarray], prefix: str = ""
          ) -> Dict[str, Tuple[np.ndarray, Optional[Tuple[slice, ...]]]]:
    """One rank's leaves that `pieces` recorded under `prefix` (every
    key with ""), by path: (data, the region of the global leaf it
    holds), the region None for a whole tensor."""
    head = prefix + "/" if prefix else ""
    out = {}
    for k, v in res.items():
        if k.startswith(head) and "#" not in k:
            spans = res.get(k + "#index")
            out[k[len(head):]] = (v, None if spans is None else tuple(
                slice(int(a), int(b)) for a, b in spans))
    return out


def join(ranks: Sequence[Dict[str, np.ndarray]], prefix: str
         ) -> Dict[str, np.ndarray]:
    """Every leaf under `prefix` whole, at its recorded global shape,
    joined from the ranks' pieces (a whole tensor as it is)."""
    head = prefix + "/" if prefix else ""
    out: Dict[str, np.ndarray] = {}
    for res in ranks:
        for path, (data, region) in split(res, prefix).items():
            if region is None:
                out[path] = data
                continue
            if path not in out:
                out[path] = np.zeros(tuple(int(d) for d in res[
                    f"{head}{path}#shape"]), np.float32)
            out[path][region] = data
    return out


def grads(tr) -> Dict[str, np.ndarray]:
    from paddle_tpu_torch.models.convert import param_path
    return {f"grad/{param_path(n)}": _host(p.grad)
            for n, p in tr.module.named_parameters() if p.grad is not None}


def _state(tr, prefix: str = "") -> Dict[str, np.ndarray]:
    ts = tr.state()
    out = pieces(ts.params, f"{prefix}params")
    for s, t in ts.opt_state["slots"].items():
        out.update(pieces(t, f"{prefix}slots/{s}"))
    return out


# -- runners (one rank; `mesh` None is the single-device reference) ---------

def _device(mesh):
    return mesh.device if mesh is not None else torch.device("cpu")


def _mesh_or_single(mesh, device):
    from paddle_tpu_torch.parallel import make_mesh
    return mesh if mesh is not None else make_mesh(devices=[device])


def run_train(sc: Scenario, mesh) -> Dict[str, np.ndarray]:
    dev = _device(mesh)
    tr = trainer(sc, _mesh_or_single(mesh, dev), dev)
    out: Dict[str, np.ndarray] = {}
    losses = []
    for i, b in enumerate(batches(sc)):
        losses.append(float(tr.train_step(tr.put_batch(b))["loss"]))
        if f"grads@{i + 1}" in sc.record:
            out.update(grads(tr))
        if f"pieces@{i + 1}" in sc.record:
            out.update(_state(tr, f"at{i + 1}/"))
    out["losses"] = np.asarray(losses)
    out.update(_state(tr))
    out.update(pieces(tr.state().state, "state"))
    return out


def run_accum(sc: Scenario, mesh) -> Dict[str, np.ndarray]:
    dev = _device(mesh)
    mesh = _mesh_or_single(mesh, dev)
    out = {}
    for name, accum in (("base", 1), ("accum", 4)):
        tr = trainer(sc, mesh, dev, gradient_accumulation_steps=accum)
        b = batches(sc)[0]
        tr.train_step(tr.put_batch(b), generator=torch.Generator().manual_seed(11))
        out.update(_state(tr, f"{name}/"))
    return out


def run_remat(sc: Scenario, mesh) -> Dict[str, np.ndarray]:
    dev = _device(mesh)
    mesh = _mesh_or_single(mesh, dev)
    out = {}
    for name, remat in (("plain", False), ("remat", True)):
        tr = trainer(sc, mesh, dev, remat=remat)
        losses = [float(tr.train_step(tr.put_batch(b))["loss"])
                  for b in batches(sc)]
        out[f"{name}/losses"] = np.asarray(losses)
        out.update(_state(tr, f"{name}/"))
    return out


def run_tp_masks(sc: Scenario, mesh) -> Dict[str, np.ndarray]:
    """One step of the dropout Transformer, run twice from one step
    generator: the keep mask of every dropout drawn, in order, by site:
    `attn` (the attention probabilities of this rank's heads) and `ffn`
    (the FFN hidden layer's columns), inside the tp region, and
    `replicated` (the embeddings' and the residual branches' dropout).
    Each mask is the draw of the dropout itself, on ones, from a copy of
    its generator."""
    from paddle_tpu_torch.kernels import attention
    from paddle_tpu_torch.nn.layers import Dropout
    dev = _device(mesh)
    real = attention._dropout_probs

    def copy(gen):
        g = torch.Generator(device=gen.device)
        g.set_state(gen.get_state())
        return g
    out = {}
    for run in range(2):
        tr = trainer(sc, mesh, dev)
        masks: Dict[str, List[np.ndarray]] = {
            "attn": [], "ffn": [], "replicated": []}

        def probs(p, rate, generator):
            if rate > 0.0 and generator is not None:
                masks["attn"].append(_host(real(torch.ones_like(p), rate,
                                                copy(generator)) != 0))
            return real(p, rate, generator)

        def pre_hook(site):
            def hook(mod, args):
                x, gen = args
                masks[site].append(_host(Dropout.forward(
                    mod, torch.ones_like(x), copy(gen)) != 0))
            return hook
        hooks = [m.register_forward_pre_hook(pre_hook(
                     "ffn" if n.endswith("ffn.drop") else "replicated"))
                 for n, m in tr.module.named_modules()
                 if isinstance(m, Dropout) and not n.endswith("attn.drop")]
        attention._dropout_probs = probs
        try:
            tr.train_step(tr.put_batch(batches(sc)[0]),
                          generator=torch.Generator().manual_seed(5))
        finally:
            attention._dropout_probs = real
            for h in hooks:
                h.remove()
        for site, ms in masks.items():
            for i, m in enumerate(ms):
                out[f"run{run}/{site}/{i}"] = m
    return out


def run_freed(sc: Scenario, mesh) -> Dict[str, np.ndarray]:
    """A sharded trainer with norm clipping, stepped once and dropped:
    whether its last reference went with it, so that no reference cycle
    keeps its tensors until a cycle collection."""
    import gc
    import weakref
    dev = _device(mesh)
    tr = trainer(sc, _mesh_or_single(mesh, dev), dev)
    tr.train_step(tr.put_batch(batches(sc)[0]))
    ref = weakref.ref(tr)
    enabled = gc.isenabled()
    gc.disable()
    try:
        del tr
        freed = ref() is None
    finally:
        if enabled:
            gc.enable()
    return {"freed": np.asarray(freed)}


def run_guard(sc: Scenario, mesh) -> Dict[str, np.ndarray]:
    """Step 1's global batch holds a NaN only in the rows of the third
    of four batch parts (one rank's on a dp=4 mesh)."""
    dev = _device(mesh)
    tr = trainer(sc, _mesh_or_single(mesh, dev), dev)
    bad, losses = [], []
    for i, (x, y) in enumerate(batches(sc)):
        if i == 1:
            x = x.copy()
            q = x.shape[0] // 4
            x[2 * q] = np.nan
        f = tr.train_step(tr.put_batch((x, y)))
        bad.append(bool(f["bad_step"]))
        losses.append(float(f["loss"]))
    return {"bad": np.asarray(bad), "step": np.asarray(tr.step),
            "opt_step": np.asarray(tr.optimizer.step_count),
            "losses": np.asarray(losses), **_state(tr)}


def run_eval(sc: Scenario, mesh) -> Dict[str, np.ndarray]:
    dev = _device(mesh)
    tr = trainer(sc, _mesh_or_single(mesh, dev), dev)
    x, y = batches(sc, 1)[0]
    before = {n: tuple(p.shape) for n, p in tr.module.named_parameters()}
    loss = float(tr.eval_step(tr.put_batch((x, y)))["loss"])
    after = {n: tuple(p.shape) for n, p in tr.module.named_parameters()}
    return {"loss": np.asarray(loss),
            "kept_shards": np.asarray(before == after),
            "shapes": np.asarray(json.dumps(after))}


def run_shapes(sc: Scenario, mesh) -> Dict[str, np.ndarray]:
    """tests/test_parallel.py's make_mesh and local_mesh shapes on the
    world's ranks."""
    from paddle_tpu_torch.parallel import MeshConfig, local_mesh, make_mesh
    devs = list(mesh.devices.flat)
    m = make_mesh(MeshConfig(dp=2, tp=2), devices=devs)
    inferred = make_mesh(MeshConfig(dp=-1, tp=2), devices=devs)
    try:
        make_mesh(MeshConfig(dp=3, tp=2), devices=devs)
        refused = False
    except ValueError:
        refused = True
    local = local_mesh(axis="fsdp")        # the PTPU_DEVICES world
    return {"dp": np.asarray(m.shape["dp"]), "tp": np.asarray(m.shape["tp"]),
            "local_fsdp": np.asarray(local.shape["fsdp"]),
            "inferred_dp": np.asarray(inferred.shape["dp"]),
            "refused": np.asarray(refused),
            "coords": np.asarray([m.coords[a] for a in m.axis_names]),
            "tp_rank": np.asarray(m.group("tp").rank),
            "batch_group": np.asarray(m.group(("dp", "fsdp")).size)}


EMB_VOCAB, EMB_DIM = 64, 8


def emb_table(vocab: int = EMB_VOCAB, dim: int = EMB_DIM) -> np.ndarray:
    return (0.02 * np.random.default_rng(3).standard_normal(
        (vocab, dim))).astype(np.float32)


def emb_ids() -> Tuple[np.ndarray, np.ndarray]:
    """(lookup ids [6, 3], gradient ids [5] all < 16)."""
    rs = np.random.RandomState(0)
    return rs.randint(0, EMB_VOCAB, (6, 3)), rs.randint(0, 16, (5,))


def run_lookup(sc: Scenario, mesh) -> Dict[str, np.ndarray]:
    """ShardedEmbedding on the mesh against the whole table: the
    forward and the local rows' gradient."""
    from paddle_tpu_torch.parallel.embedding import (ShardedEmbedding,
                                                     shard_table)
    dev = _device(mesh)
    table = emb_table()
    out = {}
    ids, gids = emb_ids()
    for name, vocab, x in (("lookup", EMB_VOCAB, ids),
                           ("grad", 32, gids)):
        emb = ShardedEmbedding(vocab, EMB_DIM, axis="fsdp", mesh=mesh,
                               batch_axes=(), device=dev)
        with torch.no_grad():
            emb.weight.data = torch.from_numpy(
                shard_table(mesh, table[:vocab])).to(dev)
        with mesh:
            y = emb(torch.from_numpy(x).to(dev))
            if name == "grad":
                torch.sum(torch.square(y)).backward()
                out["table_grad"] = _host(emb.weight.grad)
        out[name] = _host(y)
    out["rows"] = np.asarray(emb.weight.shape[0])
    return out


def run_reader(sc: Scenario, mesh) -> Dict[str, np.ndarray]:
    """The ctr_synthetic reader into DeepFM(ShardedEmbedding) through
    DataFeeder(sharding=trainer.batch_sharding())."""
    from paddle_tpu_torch.data import DataFeeder
    from paddle_tpu_torch.data.datasets import ctr_synthetic
    from paddle_tpu_torch.data.readers import batch as batch_reader
    dev = _device(mesh)
    tr = trainer(sc, _mesh_or_single(mesh, dev), dev)
    feeder = DataFeeder(["dense", "sparse", "y"],
                        dtypes={"y": np.float32},
                        sharding=tr.batch_sharding())
    reader = batch_reader(ctr_synthetic(6, 40, 8, synthetic_n=64), sc.batch)
    losses, rows = [], []
    for b in reader():
        f = feeder.feed(b)
        rows.append(f["dense"].shape[0])
        losses.append(float(tr.train_step(
            (f["dense"], f["sparse"], f["y"]))["loss"]))
    return {"losses": np.asarray(losses), "rows": np.asarray(rows)}


def _ckpt_dir() -> str:
    return os.environ["PTPU_WORLD_CKPT"]


def run_ckpt(sc: Scenario, mesh) -> Dict[str, np.ndarray]:
    """tests/test_io.py's sharded round trip: one REDUCE step, save,
    restore onto `trainer.state()` (each rank reads its own regions), and
    the restored state steps on."""
    from paddle_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
    dev = _device(mesh)
    tr = trainer(sc, mesh, dev)
    b0, b1 = batches(sc, 2)
    tr.train_step(tr.put_batch(b0))
    path = save_checkpoint(os.path.join(_ckpt_dir(), sc.kind), tr.state(),
                           step=1)
    out = _state(tr, "saved/")
    restored = load_checkpoint(path, target=tr.state())
    out.update(_state_of(restored, "restored/"))
    tr2 = trainer(sc, mesh, dev)
    tr2.load_state(restored)
    out["loss_after"] = np.asarray(float(
        tr2.train_step(tr2.put_batch(b1))["loss"]))
    out["loss_straight"] = np.asarray(float(
        tr.train_step(tr.put_batch(b1))["loss"]))
    return out


def _state_of(ts, prefix: str) -> Dict[str, np.ndarray]:
    out = pieces(ts.params, f"{prefix}params")
    for s, t in ts.opt_state["slots"].items():
        out.update(pieces(t, f"{prefix}slots/{s}"))
    return out


def run_ckpt_restore(sc: Scenario, mesh) -> Dict[str, np.ndarray]:
    """A CheckpointManager save and restore_latest onto the trainer's
    sharded target, then a step from the restored state."""
    from paddle_tpu_torch.io.checkpoint import CheckpointManager
    dev = _device(mesh)
    tr = trainer(sc, mesh, dev)
    mgr = CheckpointManager(os.path.join(_ckpt_dir(), sc.kind))
    mgr.save(tr.state(), step=1)
    restored, step = mgr.restore_latest(tr.state())
    tr.load_state(restored)
    x, y = batches(sc, 1)[0]
    loss = float(tr.train_step(tr.put_batch((x, y)))["loss"])
    return {"step": np.asarray(step), "loss": np.asarray(loss),
            **_state_of(restored, "restored/")}


def run_from_jax(sc: Scenario, mesh) -> Dict[str, np.ndarray]:
    """Load a checkpoint the JAX package wrote (PTPU_JAX_CKPT) onto this
    rank's target: each rank reads its own regions."""
    from paddle_tpu_torch.io.checkpoint import load_checkpoint
    dev = _device(mesh)
    tr = trainer(sc, mesh, dev)
    restored = load_checkpoint(os.environ["PTPU_JAX_CKPT"],
                               target=tr.state())
    tr.load_state(restored)
    return {"step": np.asarray(tr.step), **_state(tr)}


def run_to_jax(sc: Scenario, mesh) -> Dict[str, np.ndarray]:
    """Train, then write a sharded checkpoint for the JAX package."""
    from paddle_tpu_torch.io.checkpoint import save_checkpoint
    dev = _device(mesh)
    tr = trainer(sc, mesh, dev)
    for b in batches(sc):
        tr.train_step(tr.put_batch(b))
    save_checkpoint(os.path.join(_ckpt_dir(), sc.kind), tr.state(),
                    step=tr.step)
    return _state(tr)


# -- the repo's LM (chip_smoke.py's mesh_train) -----------------------------

def lm_conf(vocab: int, max_len: int, lm: Dict, seed: int, lr: float,
            runs: Sequence[Dict], save_step: int = 2,
            fsdp_min_size: int = 1 << 16) -> Dict:
    """The JSON-able LM configuration the ranks read from PTPU_LM: the
    model (`lm` without its depth), the weights' seed, Adam's lr, the
    runs, each {"name", "dtype", "layers", "batch", "seq", "steps"} (and
    "params": record the final parameters), the ZeRO run's save step and
    the fsdp rules' min_size (`fsdp_rules()`'s default at full size)."""
    return dict(vocab=vocab, max_len=max_len,
                lm={k: v for k, v in lm.items() if k != "num_layers"},
                seed=seed, lr=lr, runs=list(runs), save_step=save_step,
                fsdp_min_size=fsdp_min_size)


def lm_loss(module, batch, generator, training):
    """Mean fused cross-entropy over the pre-head hidden states, the head
    weights cast to the model's dtype (examples/train_causal_lm.py)."""
    from paddle_tpu_torch.ops import linear_cross_entropy
    inp, tgt = batch
    hid = module(inp, return_hidden=True, generator=generator)
    w, bias = module.head_weights()
    return linear_cross_entropy(
        hid, w.to(hid.dtype), tgt,
        None if bias is None else bias.to(hid.dtype)).mean(), {}


def lm_batches(conf: Dict, run: Dict) -> List[Tuple[np.ndarray, ...]]:
    """The run's global batches: the learnable stream, one seed a step."""
    from paddle_tpu_torch.testing import lm_stream
    return [lm_stream(np.random.default_rng(conf["seed"] + 17 + i),
                      run["batch"], run["seq"], conf["vocab"])
            for i in range(run["steps"])]


def lm_trainer(sc: Optional[Scenario], mesh, conf: Dict, run: Dict,
               device=None):
    """A MeshTrainer over the LM of `run`'s depth and dtype (Adam at
    conf["lr"], or the run's {"optimizer", "lr"}), its weights the first
    layers of causal_lm_tree(conf["seed"], ...)."""
    from paddle_tpu_torch.models import CausalLM, load_jax_params
    from paddle_tpu_torch.optim import SGD, Adam
    from paddle_tpu_torch.parallel import MeshTrainer, make_mesh
    from paddle_tpu_torch.testing import causal_lm_tree
    dev = mesh.device if mesh is not None else torch.device(device)
    mesh = mesh if mesh is not None else make_mesh(devices=[dev])
    lm = dict(conf["lm"], num_layers=run["layers"])
    tree = causal_lm_tree(conf["seed"], conf["vocab"], lm["model_dim"],
                          lm["num_heads"], lm["num_layers"], lm["ffn_dim"])
    model = CausalLM(vocab=conf["vocab"], max_len=conf["max_len"],
                     dtype=getattr(torch, run["dtype"]), device=dev, **lm)
    load_jax_params(model, tree)
    over = {} if sc is None else sc.strategy
    st = strategy(Scenario({}, "lm", strategy=over))
    if sc is None:
        placed = None
    elif sc.rules == "fsdp_lm":
        from paddle_tpu_torch.parallel.sharding import fsdp_rules
        placed = fsdp_rules(min_size=conf["fsdp_min_size"])
    else:
        placed = rules(sc.rules)
    opt = {"adam": Adam, "sgd": SGD}[run.get("optimizer", "adam")](
        model.parameters(), run.get("lr", conf["lr"]))
    return MeshTrainer(model, opt, lm_loss, mesh, strategy=st, rules=placed,
                       seed=0)


def _flash_launches() -> Dict[str, int]:
    from paddle_tpu_torch.kernels import flash
    return {fn.__name__: fn.launches
            for fn in (flash.flash_fwd, flash.flash_dq, flash.flash_dkv)}


def _reset_flash_launches() -> None:
    from paddle_tpu_torch.kernels import flash
    for fn in (flash.flash_fwd, flash.flash_dq, flash.flash_dkv):
        fn.launches = 0


def lm_steps(tr, batches: Sequence, name: str) -> Dict[str, np.ndarray]:
    """Step `tr` over `batches`, each loss read at once: the losses, host
    ms a step, collective calls and seconds, flash launches (counts set
    to 0 just before), peak device bytes and the parameter + slot bytes
    this rank holds."""
    from paddle_tpu_torch.parallel import collective as C
    dev = tr.mesh.device
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    _reset_flash_launches()
    calls, secs = C.STATS["calls"], C.STATS["seconds"]
    import time
    losses, ms = [], []
    for b in batches:
        t0 = time.perf_counter()
        losses.append(float(tr.train_step(tr.put_batch(b))["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    held = sum(p.numel() * p.element_size() for p in tr.module.parameters())
    held += sum(t.numel() * t.element_size()
                for p in tr.module.parameters()
                for t in tr.optimizer.slots_of(p).values())
    out = {f"{name}/losses": np.asarray(losses),
           f"{name}/step_ms": np.asarray(ms),
           f"{name}/collective_calls": np.asarray(C.STATS["calls"] - calls),
           f"{name}/collective_s": np.asarray(C.STATS["seconds"] - secs),
           f"{name}/state_bytes": np.asarray(held),
           f"{name}/peak_bytes": np.asarray(
               torch.cuda.max_memory_allocated(dev) if cuda else -1)}
    for k, v in _flash_launches().items():
        out[f"{name}/launches/{k}"] = np.asarray(v)
    return out


def _lm_setup(mesh) -> Dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return json.loads(os.environ["PTPU_LM"])


def run_lm(sc: Scenario, mesh) -> Dict[str, np.ndarray]:
    """Each run of PTPU_LM on this rank: a fresh trainer from the same
    weights, its steps and what they measured."""
    conf = _lm_setup(mesh)
    out = {}
    for run in conf["runs"]:
        tr = lm_trainer(sc, mesh, conf, run)
        out.update(lm_steps(tr, lm_batches(conf, run), run["name"]))
        if run.get("params"):
            out.update(pieces(tr.state().params, f"{run['name']}/params"))
        del tr
    return out


def _lm_ckpt(conf: Dict):
    from paddle_tpu_torch.io.checkpoint import CheckpointManager
    return CheckpointManager(os.path.join(_ckpt_dir(), "lm_zero"),
                             async_save=True)


def run_lm_save(sc: Scenario, mesh) -> Dict[str, np.ndarray]:
    """The last run of PTPU_LM straight through, its state saved (async)
    after `save_step` steps."""
    conf = _lm_setup(mesh)
    run = conf["runs"][-1]
    tr = lm_trainer(sc, mesh, conf, run)
    mgr = _lm_ckpt(conf)
    batches = lm_batches(conf, run)
    k = conf["save_step"]
    out = lm_steps(tr, batches[:k], "first")
    mgr.save(tr.state(), step=tr.step)
    out.update(lm_steps(tr, batches[k:], "rest"))
    mgr.wait()
    out.update(pieces(tr.state().params, "params"))
    return out


def run_lm_resume(sc: Scenario, mesh) -> Dict[str, np.ndarray]:
    """A fresh trainer restored from run_lm_save's checkpoint (each rank
    its own regions), then the remaining steps."""
    conf = _lm_setup(mesh)
    run = conf["runs"][-1]
    tr = lm_trainer(sc, mesh, conf, run)
    restored, step = _lm_ckpt(conf).restore_latest(tr.state())
    tr.load_state(restored)
    out = {"step": np.asarray(step)}
    out.update(lm_steps(tr, lm_batches(conf, run)[step:], "rest"))
    out.update(pieces(tr.state().params, "params"))
    return out


RUNNERS: Dict[str, Callable] = {
    "train": run_train, "accum": run_accum, "remat": run_remat,
    "tp_masks": run_tp_masks, "freed": run_freed, "guard": run_guard, "eval": run_eval, "shapes": run_shapes,
    "lookup": run_lookup, "reader": run_reader, "ckpt": run_ckpt,
    "ckpt_restore": run_ckpt_restore, "from_jax": run_from_jax,
    "to_jax": run_to_jax, "lm": run_lm, "lm_save": run_lm_save,
    "lm_resume": run_lm_resume}


def run_scenario(name: str, mesh) -> Dict[str, np.ndarray]:
    sc = SCENARIOS[name]
    return RUNNERS[sc.kind](sc, mesh)


def run_single(name: str) -> Dict[str, np.ndarray]:
    """The scenario's model on one CPU rank with the whole batch."""
    sc = SCENARIOS[name]
    return RUNNERS[sc.kind](sc, None)


# -- the world --------------------------------------------------------------

def main() -> int:
    """One rank: run PTPU_SCENARIOS (comma-separated) in order over one
    mesh a scenario, writing `{name}-r{rank}.npz` to PTPU_WORLD_OUT."""
    from paddle_tpu_torch.parallel import MeshConfig, make_mesh
    from paddle_tpu_torch.parallel.distributed import (init_distributed,
                                                       process_index)
    init_distributed()
    rank = process_index()
    devices = os.environ.get("PTPU_DEVICES", "cpu").split(",")
    if torch.device(devices[rank]).type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(torch.device(devices[rank]))
    out_dir = os.environ["PTPU_WORLD_OUT"]
    meshes: Dict[Tuple, Any] = {}
    for name in os.environ["PTPU_SCENARIOS"].split(","):
        sc = SCENARIOS[name]
        key = tuple(sorted(sc.mesh.items()))
        if key not in meshes:
            meshes[key] = make_mesh(MeshConfig(**sc.mesh))
        res = run_scenario(name, meshes[key])
        np.savez(os.path.join(out_dir, f"{name}-r{rank}.npz"), **res)
        print(json.dumps({"scenario": name, "rank": rank}), flush=True)
    torch.distributed.destroy_process_group()
    return 0


def run_world(n: int, names: Sequence[str], device: Optional[str] = "cpu",
              share_card: bool = False, env: Optional[Dict] = None,
              timeout: float = 300.0) -> Dict[str, List[Dict]]:
    """Launch n ranks (parallel/launch.py) that run the scenarios `names`
    in order; returns {name: [rank 0's results, rank 1's, ...]}."""
    from paddle_tpu_torch.parallel.launch import launch
    with tempfile.TemporaryDirectory() as out:
        penv = {"PYTHONPATH": os.pathsep.join(
                    [REPO_ROOT, os.environ.get("PYTHONPATH", "")]),
                "PTPU_SCENARIOS": ",".join(names), "PTPU_WORLD_OUT": out,
                **(env or {})}
        launch(n, [sys.executable, "-m", "paddle_tpu_torch.testing.mesh_cases"],
               device=device, share_card=share_card, env=penv,
               timeout=timeout)
        res = {}
        for name in names:
            res[name] = []
            for r in range(n):
                with np.load(os.path.join(out, f"{name}-r{r}.npz")) as z:
                    res[name].append({k: z[k] for k in z.files})
        return res


if __name__ == "__main__":
    sys.exit(main())
