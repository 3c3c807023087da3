"""The sp, pp and ep axes' cases, in mesh_cases's pattern: each names a
mesh and a runner that drives parallel/ring.py, moe.py or pipeline.py
on one rank and returns what the rank holds after (flat {key: numpy
array}; a sharded leaf recorded by `mesh_cases.pieces`).

    python -m paddle_tpu_torch.testing.parallel_cases   # one rank

`run_world(n, names)` launches n ranks through parallel/launch.py, each
running the named cases in order (one mesh a shape, made once), and
returns every rank's results. The inputs and weights are numpy arrays
drawn from seeds by the functions below, so the CPU tests feed the
same ones to the JAX package and hold each rank's slice against JAX's
device shard; chip_mesh_nccl.py runs the exact cases on cards.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch.testing.mesh_cases import REPO_ROOT, pieces

# -- inputs and weights --------------------------------------------------------


def qkv(b: int, t: int, h: int, d: int, seed: int,
        scale: float = 0.5) -> Tuple[np.ndarray, ...]:
    """Three float32 [B, T, H, D] arrays from RandomState(seed)."""
    rs = np.random.RandomState(seed)
    return tuple((rs.randn(b, t, h, d) * scale).astype(np.float32)
                 for _ in range(3))


MOE_E, MOE_D, MOE_HID = 4, 16, 32


def moe_params(seed: int = 0, e: int = MOE_E, d: int = MOE_D,
               hid: int = MOE_HID) -> Dict[str, np.ndarray]:
    """init_moe_params' layout and scales, drawn with numpy."""
    rs = np.random.RandomState(seed)
    s1, s2 = (2.0 / d) ** 0.5, (2.0 / hid) ** 0.5
    return {"gate": (rs.randn(d, e) * s1).astype(np.float32),
            "w1": (rs.randn(e, d, hid) * s1).astype(np.float32),
            "w2": (rs.randn(e, hid, d) * s2).astype(np.float32)}


def moe_tokens(seed: int, n: int = 32, d: int = MOE_D) -> np.ndarray:
    return np.random.RandomState(seed).randn(n, d).astype(np.float32)


# PipelinedLM configurations: (vocab, d_model, n_heads, d_ff, stages,
# max_len, experts or None)
LM_DIMS = {
    "lm": (32, 16, 2, 32, 4, 8, None),
    "lm8": (32, 16, 2, 32, 8, 8, None),
    "lm2": (32, 16, 2, 32, 2, 8, None),
    "lm2h4": (32, 16, 4, 32, 2, 8, None),
    "lm3": (32, 16, 2, 32, 3, 8, None),
    "lm_gen": (32, 32, 4, 64, 4, 16, None),
    "lm_live": (64, 64, 4, 128, 4, 32, None),
    "moe": (32, 16, 2, 32, 2, 8, 4),
}


def pipe_tree(kind: str, seed: int = 0) -> Dict:
    """A JAX-layout PipelinedLM / PipelinedMoELM `variables` tree of
    random weights: normal(0.02) tables, glorot-uniform matrices on JAX's
    fans of the stacked shape, LayerNorm scales near 1."""
    vocab, d, _, f, s, max_len, e = LM_DIMS[kind]
    rs = np.random.RandomState(seed + 1000)

    def glorot(*shape):
        rf = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
        lim = np.sqrt(6.0 / ((shape[-2] + shape[-1]) * rf))
        return rs.uniform(-lim, lim, shape).astype(np.float32)

    def near(shape, c):
        return (c + 0.05 * rs.randn(*shape)).astype(np.float32)

    stages = {"w_qkv": glorot(s, d, 3 * d), "w_o": glorot(s, d, d),
              "ln1_s": near((s, d), 1.0), "ln1_b": near((s, d), 0.0),
              "ln2_s": near((s, d), 1.0), "ln2_b": near((s, d), 0.0)}
    if e is None:
        stages.update(w1=glorot(s, d, f), b1=near((s, f), 0.0),
                      w2=glorot(s, f, d), b2=near((s, d), 0.0))
    else:
        stages.update(gate=(0.02 * rs.randn(s, d, e)).astype(np.float32),
                      moe_w1=glorot(s, e, d, f), moe_w2=glorot(s, e, f, d))
    return {"params": {
        "embed": (0.02 * rs.randn(vocab, d)).astype(np.float32),
        "pos": (0.02 * rs.randn(max_len, d)).astype(np.float32),
        "stages": stages,
        "lnf_s": near((d,), 1.0), "lnf_b": near((d,), 0.0),
        "head": glorot(d, vocab)}}


def lm_tokens(seed: int, b: int = 16, t: int = 8,
              vocab: int = 32) -> Tuple[np.ndarray, np.ndarray]:
    """tests/test_pipeline.py's `_lm_and_batch` batch: (inputs, next
    tokens) of RandomState(seed).randint."""
    tok = np.random.RandomState(seed).randint(0, vocab, (b, t + 1)).astype(
        np.int32)
    return tok[:, :-1], tok[:, 1:]


def plus_one_tokens(seed: int = 15, b: int = 16, t: int = 8,
                    vocab: int = 32) -> Tuple[np.ndarray, np.ndarray]:
    """The (+1 mod V) stream of test_pipelined_lm_generate_and_export."""
    start = np.random.RandomState(seed).randint(0, vocab, (b, 1))
    seq = (start + np.arange(t + 1)) % vocab
    return seq[:, :-1].astype(np.int32), seq[:, 1:].astype(np.int32)


def build_lm(kind: str, device, seed: int = 0, **kw):
    """The port model of `kind` with pipe_tree(kind, seed) loaded."""
    from paddle_tpu_torch.models import load_jax_params
    from paddle_tpu_torch.parallel.pipeline import PipelinedLM, PipelinedMoELM
    vocab, d, h, f, s, max_len, e = LM_DIMS[kind]
    if e is None:
        m = PipelinedLM(vocab, d, h, f, s, max_len, device=device)
    else:
        m = PipelinedMoELM(vocab, d, h, f, s, max_len, num_experts=e,
                           device=device, **kw)
    return load_jax_params(m, pipe_tree(kind, seed))


# -- helpers ----------------------------------------------------------------------

def _dev(mesh) -> torch.device:
    return mesh.device


def _t(x, mesh) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(x)).to(_dev(mesh))


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def shard(x: np.ndarray, mesh, axis: str, dim: int) -> np.ndarray:
    """This rank's contiguous part of `x` along `dim` over `axis`."""
    n = mesh.shape[axis]
    c = mesh.coords[axis]
    part = x.shape[dim] // n
    return np.take(x, np.arange(c * part, (c + 1) * part), axis=dim)


def _grad_pieces(tr, prefix: str = "grads") -> Dict[str, np.ndarray]:
    """The trainer's reduced gradients as Pieces (this rank's slices)."""
    from paddle_tpu_torch.parallel.sharding import Piece
    from paddle_tpu_torch.utils.tree import nest
    flat = {}
    for n, p in tr.module.named_parameters():
        pl = tr._plans[n]
        flat[pl.path] = Piece(p.grad, pl.shape, pl.index, pl.owner)
    return pieces(nest(flat), prefix)


# -- ring -------------------------------------------------------------------------

def run_ring_dense(mesh) -> Dict[str, np.ndarray]:
    """tests/test_ring_attention.py::test_ring_attention_matches_reference
    on sp=8: the dense ring, both maskings."""
    from paddle_tpu_torch.parallel.ring import ring_attention
    q, k, v = (shard(x, mesh, "sp", 1) for x in qkv(2, 64, 2, 16, 0, 1.0))
    return {f"out_c{int(c)}": _host(ring_attention(
        _t(q, mesh), _t(k, mesh), _t(v, mesh), mesh, causal=c))
        for c in (False, True)}


def run_ring_grads(mesh) -> Dict[str, np.ndarray]:
    """test_ring_attention_grads_flow: d sum(o^2) / dq with q = k = v."""
    from paddle_tpu_torch.parallel.ring import ring_attention
    q = _t(shard(qkv(2, 32, 2, 8, 1, 1.0)[0], mesh, "sp", 1),
           mesh).requires_grad_()
    torch.sum(ring_attention(q, q, q, mesh, causal=True) ** 2).backward()
    return {"grad": _host(q.grad)}


RING_FLASH = {  # name: (T, seed, causal, zigzag, grads)
    "full": (256, 0, False, False, False),
    "causal": (256, 1, True, False, False),
    "causal_grads": (128, 2, True, False, True),
    "zigzag": (256, 3, True, True, True),
    "nondivisible": (768, 4, True, False, False),
}


def run_ring_flash(mesh) -> Dict[str, np.ndarray]:
    """TestRingFlash's cases: each rank's output shard and, where the
    JAX test takes them, the gradients of sum(o^2) on its shards (in the
    zig-zag order for the zig-zag case)."""
    from paddle_tpu_torch.parallel.ring import (ring_flash_attention,
                                                zigzag_shard)
    out = {}
    sp = mesh.shape["sp"]
    for name, (t, seed, causal, zigzag, want_grads) in RING_FLASH.items():
        glob = [torch.from_numpy(x) for x in qkv(1, t, 2, 32, seed)]
        if zigzag:
            glob = [zigzag_shard(x, sp) for x in glob]
        q, k, v = (_t(shard(x.numpy(), mesh, "sp", 1), mesh)
                   .requires_grad_(want_grads) for x in glob)
        o = ring_flash_attention(q, k, v, mesh, causal=causal,
                                 zigzag=zigzag)
        out[f"{name}/out"] = _host(o)
        if want_grads:
            torch.sum(o ** 2).backward()
            for n_, x in (("dq", q), ("dk", k), ("dv", v)):
                out[f"{name}/{n_}"] = _host(x.grad)
    return out


def run_ulysses(mesh) -> Dict[str, np.ndarray]:
    """TestUlysses.test_parity_and_grads: output and gradient shards."""
    from paddle_tpu_torch.parallel.ring import ulysses_attention
    q, k, v = (_t(shard(x, mesh, "sp", 1), mesh).requires_grad_()
               for x in qkv(1, 256, 4, 32, 0))
    o = ulysses_attention(q, k, v, mesh, causal=True)
    torch.sum(o ** 2).backward()
    return {"out": _host(o), "dq": _host(q.grad), "dk": _host(k.grad),
            "dv": _host(v.grad)}


# -- moe --------------------------------------------------------------------------

def _moe_local(mesh, requires_grad: bool = False, params=None):
    """This rank's experts of moe_params(0) (the gate whole)."""
    p = params or moe_params(0)
    out = {"gate": _t(p["gate"], mesh),
           "w1": _t(shard(p["w1"], mesh, "ep", 0), mesh),
           "w2": _t(shard(p["w2"], mesh, "ep", 0), mesh)}
    return {k: v.requires_grad_(requires_grad) for k, v in out.items()}


def run_moe(mesh) -> Dict[str, np.ndarray]:
    """tests/test_moe.py's ep=4 cases: masked dispatch (k 1 and 2), a2a
    against masked at ample capacity, drops past capacity, and the
    gradients of both paths."""
    from paddle_tpu_torch.parallel.moe import moe_ffn, moe_ffn_a2a
    out = {}
    p = _moe_local(mesh)
    for name, seed, k in (("ep", 0, 1), ("topk", 3, 2)):
        y, aux = moe_ffn(p, _t(moe_tokens(seed, 24), mesh), mesh=mesh, k=k)
        out[f"{name}/y"] = _host(y)
        out[f"{name}/index"] = aux["expert_index"].cpu().numpy()
    x = moe_tokens(4)
    for k in (1, 2):
        ym, am = moe_ffn(p, _t(x, mesh), mesh=mesh, k=k)
        ya, aa = moe_ffn_a2a(p, _t(shard(x, mesh, "ep", 0), mesh), mesh,
                             k=k, capacity_factor=MOE_E / k)
        out[f"a2a{k}/masked"] = _host(ym)
        out[f"a2a{k}/y"] = _host(ya)
        out[f"a2a{k}/index"] = aa["expert_index"].cpu().numpy()
        out[f"a2a{k}/masked_index"] = am["expert_index"].cpu().numpy()
        out[f"a2a{k}/dropped"] = _host(aa["dropped_fraction"])
    hot = np.tile(np.random.RandomState(5).randn(1, MOE_D).astype(
        np.float32), (32, 1))
    y, aux = moe_ffn_a2a(p, _t(shard(hot, mesh, "ep", 0), mesh), mesh, k=1,
                         capacity_factor=1.0)
    out["drops/y"] = _host(y)
    out["drops/dropped"] = _host(aux["dropped_fraction"])
    out["drops/capacity"] = aux["capacity"].numpy()
    # gradients: the a2a path (MSE on this rank's tokens) and the masked
    # path (MSE + the balance loss), every leaf's this rank's slice
    x, tgt = moe_tokens(6), moe_tokens(106)
    pg = _moe_local(mesh, True)
    y, _ = moe_ffn_a2a(pg, _t(shard(x, mesh, "ep", 0), mesh), mesh, k=2,
                       capacity_factor=2.0)
    torch.sum((y - _t(shard(tgt, mesh, "ep", 0), mesh)) ** 2).backward()
    out.update({f"a2a_grads/{n}": _host(t.grad) for n, t in pg.items()})
    from paddle_tpu_torch.parallel.moe import load_balancing_loss
    x, tgt = moe_tokens(2), moe_tokens(102)
    pg = _moe_local(mesh, True)
    y, aux = moe_ffn(pg, _t(x, mesh), mesh=mesh)
    (torch.mean((y - _t(tgt, mesh)) ** 2)
     + 0.01 * load_balancing_loss(aux)).backward()
    out.update({f"masked_grads/{n}": _host(t.grad) for n, t in pg.items()})
    return out


def run_moe_pressure(mesh) -> Dict[str, np.ndarray]:
    """test_moe_a2a_under_capacity_pressure: a router skewed to expert 0
    at capacity factor 1 drops tokens; 60 Adam steps on the tokens' mean
    MSE + 0.1 x the balance loss (this rank's tokens; the gate's
    gradient averaged over the axis, each expert's over the ranks'
    losses) lower the loss and the drops."""
    from paddle_tpu_torch.optim import Adam
    from paddle_tpu_torch.parallel import collective as C
    from paddle_tpu_torch.parallel.moe import load_balancing_loss, moe_ffn_a2a
    rs = np.random.RandomState(11)
    x = (rs.rand(256, MOE_D) + 0.5).astype(np.float32)
    tgt = (rs.randn(256, MOE_D) * 0.1).astype(np.float32)
    p0 = moe_params(0)
    p0["gate"] = p0["gate"].copy()
    p0["gate"][:, 0] += 0.3
    p = _moe_local(mesh, True, p0)
    g = mesh.group("ep")
    xl, tl = (_t(shard(a, mesh, "ep", 0), mesh) for a in (x, tgt))
    opt = Adam(list(p.values()), 3e-2)
    mains, drops = [], []
    for _ in range(60):
        y, aux = moe_ffn_a2a(p, xl, mesh, k=1, capacity_factor=1.0)
        main = torch.mean((y - tl) ** 2)
        opt.zero_grad(set_to_none=True)
        (main + 0.1 * load_balancing_loss(aux)).backward()
        with torch.no_grad():
            p["gate"].grad = C.all_reduce(p["gate"].grad, g, "mean")
            for n in ("w1", "w2"):
                p[n].grad /= g.size
        opt.step()
        mains.append(float(C.all_reduce(main.detach(), g, "mean")))
        drops.append(float(aux["dropped_fraction"]))
    return {"mains": np.asarray(mains), "drops": np.asarray(drops)}


# -- pipelines: the toy stages ------------------------------------------------------

TOY_S, TOY_D = 4, 8


def toy_stages(seed: int, n: int = TOY_S, d: int = TOY_D
               ) -> Dict[str, np.ndarray]:
    """tests/test_pipeline.py's `make_params` stacked: n stages of
    tanh(x @ w + b)."""
    rs = np.random.RandomState(seed)
    ws, bs = [], []
    for _ in range(n):
        ws.append((rs.randn(d, d) * 0.3).astype(np.float32))
        bs.append((rs.randn(d) * 0.1).astype(np.float32))
    return {"w": np.stack(ws), "b": np.stack(bs)}


def toy_stage(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def run_toy(mesh) -> Dict[str, np.ndarray]:
    """The toy-stage tests on pp=4: pipeline_apply (4 and 8 stages),
    pipeline_loss_fn's loss and this rank's stage gradients (M 4 and 2),
    scalar targets, and the non-divisible stack's refusal."""
    from paddle_tpu_torch.parallel.pipeline import (pipeline_apply,
                                                    pipeline_loss_fn)
    out = {}
    for name, seed, n, shape in (("apply", 0, TOY_S, (6, 4, 16)),
                                 ("apply8", 14, 2 * TOY_S, (4, 3, 8))):
        d = shape[-1]
        st = toy_stages(seed, n, d)
        rs = np.random.RandomState(seed + 50)
        xs = (rs.randn(*shape)).astype(np.float32)
        y = pipeline_apply(toy_stage, {k: _t(v, mesh) for k, v in
                                       st.items()}, _t(xs, mesh), mesh)
        out[f"{name}/out"] = _host(y)
    mse = (lambda pred, t: torch.mean((pred - t) ** 2))
    for name, seed, m in (("grads4", 1, 4), ("grads2", 2, 2)):
        st = {k: _t(v, mesh).requires_grad_() for k, v in
              toy_stages(seed).items()}
        rs = np.random.RandomState(seed + 50)
        x, y = (rs.randn(8, TOY_D).astype(np.float32) for _ in range(2))
        loss = pipeline_loss_fn(toy_stage, mse, mesh,
                                num_microbatches=m)(st, _t(x, mesh),
                                                    _t(y, mesh))
        loss.backward()
        out[f"{name}/loss"] = _host(loss)
        out.update({f"{name}/d{k}": _host(v.grad) for k, v in st.items()})
    st = {k: _t(v, mesh) for k, v in toy_stages(13).items()}
    rs = np.random.RandomState(63)
    x = rs.randn(8, TOY_D).astype(np.float32)
    tv = rs.randn(8).astype(np.float32)
    out["low_rank/loss"] = _host(pipeline_loss_fn(
        toy_stage, lambda pred, t: (torch.mean(pred, -1) - t) ** 2, mesh,
        num_microbatches=4)(st, _t(x, mesh), _t(tv, mesh)))
    bad = {"w": torch.zeros((3, 4, 4), device=_dev(mesh))}
    try:
        pipeline_loss_fn(lambda p, x: x @ p["w"], mse, mesh)(
            bad, torch.zeros((8, 4), device=_dev(mesh)),
            torch.zeros((8, 4), device=_dev(mesh)))
        out["refused"] = np.asarray("")
    except ValueError as e:
        out["refused"] = np.asarray(str(e))
    return out


# -- pipelines: PipelinedLM through MeshTrainer --------------------------------------

def lm_trainer(mesh, kind: str, rules=None, lr: float = 1e-2,
               remat: bool = False, model_kw=None, **loss_kw):
    """A MeshTrainer over build_lm(kind) with pipelined_(moe_)lm_loss and
    Adam(lr), batch over dp."""
    from paddle_tpu_torch.optim import Adam
    from paddle_tpu_torch.parallel import DistStrategy, MeshTrainer
    from paddle_tpu_torch.parallel.pipeline import (
        pipeline_moe_rules, pipeline_rules, pipelined_lm_loss,
        pipelined_moe_lm_loss)
    model = build_lm(kind, _dev(mesh), **(model_kw or {}))
    moe = LM_DIMS[kind][-1] is not None
    loss = (pipelined_moe_lm_loss if moe else pipelined_lm_loss)(
        mesh, **loss_kw)
    if rules is None:
        rules = pipeline_moe_rules() if moe else pipeline_rules(
            tp_axis=loss_kw.get("tp_axis"))
    return MeshTrainer(model, Adam(model.parameters(), lr), loss, mesh,
                       strategy=DistStrategy(batch_axes=("dp",),
                                             remat=remat), rules=rules)


def _train(tr, batch, steps: int, prefix: str,
           record: bool = True) -> Dict[str, np.ndarray]:
    """`steps` steps on one batch: the losses, the reduced gradients of
    step 1 and (with `record`) the state after it and after the last."""
    from paddle_tpu_torch.testing.mesh_cases import _state
    out, losses = {}, []
    db = tr.put_batch(batch)
    for i in range(steps):
        losses.append(float(tr.train_step(db)["loss"]))
        if i == 0 and record:
            out.update(_grad_pieces(tr, f"{prefix}/grads"))
            out.update(_state(tr, f"{prefix}/step1/"))
    out[f"{prefix}/losses"] = np.asarray(losses)
    if record:
        out.update(_state(tr, f"{prefix}/final/"))
    return out


# name: (model kind, batch seed, steps, loss_fn arguments); a run's
# first step is held against JAX, the schedules against each other
PIPE_RUNS = {
    "pipe_dp": {
        "trains": ("lm", 3, 4, dict(num_microbatches=8)),
        "f1b": ("lm", 3, 4, dict(num_microbatches=8, schedule="1f1b")),
        "fused": ("lm", 3, 1, dict(num_microbatches=8, fused_ce=True)),
        "virtual": ("lm8", 4, 1, dict(num_microbatches=8, fused_ce=True)),
        "f1b_virtual": ("lm8", 4, 1, dict(num_microbatches=8,
                                           fused_ce=True, schedule="1f1b")),
    },
    "pipe_tp": {
        "tp": ("lm2", 7, 1, dict(num_microbatches=4, tp_axis="tp")),
        "f1b_tp": ("lm2", 7, 1, dict(num_microbatches=4, tp_axis="tp",
                                     schedule="1f1b")),
    },
    "pipe_sp": {
        "ring": ("lm2", 11, 1, dict(num_microbatches=4, sp_axis="sp")),
        "ulysses": ("lm2", 16, 1, dict(num_microbatches=4, sp_axis="sp",
                                       sp_mode="ulysses")),
    },
    "pipe_tp_sp": {
        "ring4d": ("lm2", 12, 1, dict(num_microbatches=4, tp_axis="tp",
                                      sp_axis="sp")),
        "ulysses_tp": ("lm2h4", 17, 1, dict(num_microbatches=4,
                                            tp_axis="tp", sp_axis="sp",
                                            sp_mode="ulysses")),
    },
    "pipe_ep": {
        "moe_trains": ("moe", 8, 4, dict(num_microbatches=4,
                                         lb_weight=0.01)),
        "moe_fused": ("moe", 8, 1, dict(num_microbatches=4,
                                        fused_ce=True)),
        "moe_f1b": ("moe", 8, 1, dict(num_microbatches=4,
                                      schedule="1f1b")),
    },
    "pipe_ep4": {
        "moe_parity": ("moe", 9, 1, dict(num_microbatches=4,
                                         lb_weight=0.0)),
    },
    # chip_mesh_nccl.py: both schedules on pp=2 x dp=2, a card a rank
    "nccl_pipe": {
        "gpipe": ("lm2", 11, 1, dict(num_microbatches=4)),
        "f1b": ("lm2", 11, 1, dict(num_microbatches=4, schedule="1f1b")),
    },
}

# test_pipelined_moe_lm_ce_parity_vs_dense's model (capacity 4: no
# drops) and batch
MOE_KW = {"moe_parity": dict(capacity_factor=4.0)}
MOE_BATCH = {"moe_parity": 8}


def run_pipe(mesh, case: str) -> Dict[str, np.ndarray]:
    out = {}
    for name, (kind, seed, steps, kw) in PIPE_RUNS[case].items():
        vocab, t = LM_DIMS[kind][0], LM_DIMS[kind][5]
        batch = lm_tokens(seed, MOE_BATCH.get(name, 16), t, vocab)
        tr = lm_trainer(mesh, kind, model_kw=MOE_KW.get(name), **kw)
        out.update(_train(tr, batch, steps, name))
    return out


def run_pipe_extra(mesh) -> Dict[str, np.ndarray]:
    """On pp=4 x dp=2: remat against plain, the refusal of 3 stages, the
    refusal of ulysses past the heads, the activation liveness of both
    schedules, and each schedule's eval step (its loss, its collective
    calls) beside the train step's loss on the same weights."""
    from paddle_tpu_torch.parallel import collective as C
    from paddle_tpu_torch.parallel.pipeline import (pipelined_lm_loss,
                                                    saved_bytes)
    out = {}
    batch = lm_tokens(6)
    for name, remat in (("plain", False), ("remat", True)):
        tr = lm_trainer(mesh, "lm", remat=remat, num_microbatches=8)
        out.update(_train(tr, batch, 1, name, record=False))
    for schedule in ("gpipe", "1f1b"):
        tr = lm_trainer(mesh, "lm", num_microbatches=8, schedule=schedule)
        db = tr.put_batch(batch)
        calls = C.STATS["calls"]
        out[f"eval/{schedule}_loss"] = _host(tr.eval_step(db)["loss"])
        out[f"eval/{schedule}_calls"] = np.asarray(C.STATS["calls"] - calls)
        out[f"eval/{schedule}_train_loss"] = _host(
            tr.train_step(db)["loss"])
    try:
        lm_trainer(mesh, "lm3", num_microbatches=8)
        out["refused"] = np.asarray("")
    except ValueError as e:
        out["refused"] = np.asarray(str(e))
    # liveness: value and gradients of the loss at M 8, S 4
    vocab, _, _, _, _, t, _ = LM_DIMS["lm_live"]
    tok = np.random.RandomState(0).randint(0, vocab, (32, t + 1))
    local = tuple(_t(shard(a, mesh, "dp", 0), mesh)
                  for a in (tok[:, :-1], tok[:, 1:]))
    model = build_lm("lm_live", _dev(mesh))
    from paddle_tpu_torch.parallel.sharding import ShardingRules, shard_module
    shard_module(model, ShardingRules([(r"(^|/)stages/", ("pp",))]),
                 mesh=mesh)
    for schedule in ("gpipe", "1f1b"):
        fn = pipelined_lm_loss(mesh, num_microbatches=8, schedule=schedule)
        with saved_bytes() as live:
            loss, _ = fn(model, local, None, True)
            torch.autograd.grad(loss, list(model.parameters()),
                                allow_unused=True)
        out[f"live/{schedule}"] = np.asarray(live.peak)
        out[f"live/{schedule}_loss"] = _host(loss)
    return out


def run_pipe_ulysses_refusal(mesh) -> Dict[str, np.ndarray]:
    """pp2 x tp2 x sp2: 2 heads over tp=2 leave 1 a shard, which sp=2
    cannot split."""
    try:
        tr = lm_trainer(mesh, "lm2", num_microbatches=4, tp_axis="tp",
                        sp_axis="sp", sp_mode="ulysses")
        tr.train_step(tr.put_batch(lm_tokens(17)))
        return {"refused": np.asarray("")}
    except ValueError as e:
        return {"refused": np.asarray(str(e))}


def run_pipe_generate(mesh) -> Dict[str, np.ndarray]:
    """test_pipelined_lm_generate_and_export's training: 60 GPipe steps
    on the (+1 mod V) stream; the final parameters."""
    from paddle_tpu_torch.testing.mesh_cases import _state
    tr = lm_trainer(mesh, "lm_gen", num_microbatches=4)
    db = tr.put_batch(plus_one_tokens())
    losses = [float(tr.train_step(db)["loss"]) for _ in range(60)]
    return {"losses": np.asarray(losses), **_state(tr)}


def _ckpt_dir() -> str:
    return os.environ["PTPU_WORLD_CKPT"]


def run_pipe_ckpt(mesh) -> Dict[str, np.ndarray]:
    """test_pipelined_lm_checkpoint_roundtrip (2 steps, save, a third
    straight and resumed), then both cross-package directions: a JAX
    checkpoint (PTPU_JAX_CKPT, when set) onto this rank's target, and
    this world's state after 2 steps saved for JAX."""
    from paddle_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
    from paddle_tpu_torch.testing.mesh_cases import _state, _state_of
    batch = lm_tokens(5)
    tr = lm_trainer(mesh, "lm", num_microbatches=8)
    db = tr.put_batch(batch)
    for _ in range(2):
        tr.train_step(db)
    path = save_checkpoint(os.path.join(_ckpt_dir(), "pipe"), tr.state(),
                           step=2)
    out = _state(tr, "saved/")
    out["straight"] = np.asarray(float(tr.train_step(db)["loss"]))
    out.update(_state(tr, "straight/"))
    tr2 = lm_trainer(mesh, "lm", num_microbatches=8)
    tr2.load_state(load_checkpoint(path, target=tr2.state()))
    out["resumed"] = np.asarray(float(tr2.train_step(db)["loss"]))
    out.update(_state(tr2, "resumed/"))
    if os.environ.get("PTPU_JAX_CKPT"):
        tr3 = lm_trainer(mesh, "lm", num_microbatches=8)
        restored = load_checkpoint(os.environ["PTPU_JAX_CKPT"],
                                   target=tr3.state())
        out.update(_state_of(restored, "from_jax/"))
        tr3.load_state(restored)
        out["from_jax_step"] = np.asarray(tr3.step)
    return out


# -- the dry-run gate: __graft_entry__._dryrun_impl(8)'s phases -------------------
# Each runner drives one phase on one rank of its mesh — or, with mesh
# None, on one CPU rank: the reference the phase is held against (the
# pipelines' reference is the dense step, as JAX's). The widths, seeds,
# batches and optimizers are _dryrun_impl's at 8 devices.

DRY_TF = dict(src_vocab=64, trg_vocab=64, model_dim=32, num_heads=4,
              num_layers=2, ffn_dim=64)
DRY_MOE = dict(e=8, d=16, hid=32, tokens=32)


def _dry_mesh(mesh):
    from paddle_tpu_torch.parallel import make_mesh
    return mesh if mesh is not None else make_mesh(devices=["cpu"])


def _dry_step(tr, batch) -> Dict[str, np.ndarray]:
    """One step: the loss, the reduced gradients (this rank's pieces) and
    the state after."""
    from paddle_tpu_torch.testing.mesh_cases import _state
    loss = tr.train_step(tr.put_batch(batch))["loss"]
    return {"loss": np.asarray(float(loss)), **_grad_pieces(tr),
            **_state(tr)}


def run_dry_mlp(mesh) -> Dict[str, np.ndarray]:
    """Phase 1: an MLP on dp x fsdp (ZeRO under REDUCE, fsdp_rules at
    min_size 64) with 2 accumulated microbatches, one Adam step."""
    from paddle_tpu_torch.core.executor import supervised_loss
    from paddle_tpu_torch.models import load_jax_params
    from paddle_tpu_torch.models.vision import MLP
    from paddle_tpu_torch.ops.functional import softmax_with_cross_entropy
    from paddle_tpu_torch.optim import Adam
    from paddle_tpu_torch.parallel import (DistStrategy, MeshTrainer,
                                           ReduceStrategy)
    from paddle_tpu_torch.parallel.sharding import fsdp_rules
    from paddle_tpu_torch.testing.mesh_cases import mlp_tree
    mesh = _dry_mesh(mesh)
    m = load_jax_params(MLP(hidden=(64, 64), num_classes=8,
                            in_shape=(16, 1, 1), device=mesh.device),
                        mlp_tree((64, 64), 16, 8, seed=0))
    tr = MeshTrainer(m, Adam(m.parameters(), 1e-3),
                     supervised_loss(softmax_with_cross_entropy), mesh,
                     strategy=DistStrategy(
                         reduce_strategy=ReduceStrategy.REDUCE,
                         gradient_accumulation_steps=2),
                     rules=fsdp_rules(min_size=64))
    x = np.random.RandomState(0).randn(32, 16).astype(np.float32)
    y = np.random.RandomState(1).randint(0, 8, 32).astype(np.int64)
    return _dry_step(tr, (x, y))


def run_dry_tf(mesh) -> Dict[str, np.ndarray]:
    """Phase 2: a Transformer on dp x tp (Megatron rules), batch over dp,
    one Adam step."""
    from paddle_tpu_torch.models import Transformer, load_jax_params
    from paddle_tpu_torch.ops.functional import softmax_with_cross_entropy
    from paddle_tpu_torch.optim import Adam
    from paddle_tpu_torch.parallel import DistStrategy, MeshTrainer
    from paddle_tpu_torch.parallel.sharding import transformer_tp_rules
    from paddle_tpu_torch.testing import transformer_tree
    mesh = _dry_mesh(mesh)
    d = DRY_TF
    m = load_jax_params(
        Transformer(dropout=0.0, max_len=32, device=mesh.device, **d),
        transformer_tree(0, d["src_vocab"], d["trg_vocab"], d["model_dim"],
                         d["num_heads"], d["num_layers"], d["ffn_dim"],
                         random_norms=True))

    def loss_fn(module, batch, generator, training):
        src, trg_in, trg_out = batch
        logits = module(src, trg_in, generator=generator)
        return softmax_with_cross_entropy(logits, trg_out).mean(), {}

    tr = MeshTrainer(m, Adam(m.parameters(), 1e-3), loss_fn, mesh,
                     strategy=DistStrategy(batch_axes=("dp",)),
                     rules=transformer_tp_rules())
    rs = np.random.RandomState(2)
    src = rs.randint(0, 64, (4, 8)).astype(np.int32)
    trg = rs.randint(0, 64, (4, 9)).astype(np.int32)
    return _dry_step(tr, (src, trg[:, :-1], trg[:, 1:]))


def dry_dense_lm(kind: str, batch, **model_kw) -> Dict[str, np.ndarray]:
    """The pipelines' reference: one dense Adam (1e-2) step of
    build_lm(kind) on one CPU rank — its forward's mean CE (JAX's
    `dense_lm_loss`); the loss, the gradients and the parameters
    after."""
    from paddle_tpu_torch.models.convert import param_path
    from paddle_tpu_torch.ops.functional import softmax_with_cross_entropy
    from paddle_tpu_torch.optim import Adam
    from paddle_tpu_torch.testing.mesh_cases import pieces
    from paddle_tpu_torch.utils.tree import nest
    model = build_lm(kind, "cpu", **model_kw)
    opt = Adam(model.parameters(), 1e-2)
    x, y = (torch.from_numpy(np.ascontiguousarray(a)) for a in batch)
    loss = softmax_with_cross_entropy(model(x).float(), y).mean()
    loss.backward()
    opt.step()
    named = list(model.named_parameters())
    return {"loss": np.asarray(float(loss.detach())),
            **pieces(nest({param_path(n): p.grad for n, p in named}),
                     "grads"),
            **pieces(nest({param_path(n): p.detach() for n, p in named}),
                     "params")}


def dry_pipe_batch() -> Tuple[np.ndarray, np.ndarray]:
    tok = np.random.RandomState(3).randint(0, 32, (8, 9)).astype(np.int32)
    return tok[:, :-1], tok[:, 1:]


def dry_moe_lm_batch() -> Tuple[np.ndarray, np.ndarray]:
    tok = np.random.RandomState(44).randint(0, 32, (16, 9)).astype(np.int32)
    return tok[:, :-1], tok[:, 1:]


def run_dry_pipe(mesh) -> Dict[str, np.ndarray]:
    """Phase 3: PipelinedLM (4 stages, v = 2 on pp=2) under GPipe with
    Megatron tp and ring attention inside each stage and the fused CE,
    4 microbatches, one Adam step; the dense step without a mesh."""
    if mesh is None:
        return dry_dense_lm("lm", dry_pipe_batch())
    tr = lm_trainer(mesh, "lm", num_microbatches=4, tp_axis="tp",
                    sp_axis="sp", fused_ce=True)
    return _dry_step(tr, dry_pipe_batch())


def run_dry_1f1b(mesh) -> Dict[str, np.ndarray]:
    """Phase 3b: the same model and batch under 1F1B over pp x tp x dp
    (sp folded into dp), fused CE; the dense step without a mesh."""
    if mesh is None:
        return dry_dense_lm("lm", dry_pipe_batch())
    tr = lm_trainer(mesh, "lm", num_microbatches=4, tp_axis="tp",
                    fused_ce=True, schedule="1f1b")
    return _dry_step(tr, dry_pipe_batch())


def run_dry_moe(mesh) -> Dict[str, np.ndarray]:
    """Phase 4: mean(y^2) + 0.01 x the balance loss of the MoE FFN (8
    experts, D 16, hidden 32, top-2) on 32 tokens and its gradients,
    masked (tokens whole on every rank) and all_to_all (tokens over ep,
    capacity factor E/k: no drops). The a2a loss is the sum of the
    ranks' parts: sum(y_r^2) / (T D) + 0.01 (E / n) sum_e f_e P_e,r with
    f the routed shares over every token (no gradient) and P_e,r the
    rank's mean router probabilities, so the ranks' gate gradients sum
    to the gradient of the whole loss. Without a mesh: moe_ffn on one
    rank."""
    from paddle_tpu_torch.parallel import collective as C
    from paddle_tpu_torch.parallel.moe import (load_balancing_loss, moe_ffn,
                                               moe_ffn_a2a)
    c = DRY_MOE
    p = moe_params(4, e=c["e"], d=c["d"], hid=c["hid"])
    x = np.random.RandomState(4).randn(c["tokens"], c["d"]).astype(
        np.float32)

    def lossed(prefix, params, y, aux):
        loss = torch.mean(y ** 2) + 0.01 * load_balancing_loss(aux)
        loss.backward()
        return {f"{prefix}/loss": _host(loss),
                **{f"{prefix}/{n}": _host(t.grad) for n, t in params.items()}}

    if mesh is None:
        pg = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
        return lossed("masked", pg, *moe_ffn(pg, torch.from_numpy(x), k=2))
    out = {}
    pg = _moe_local(mesh, True, p)
    out.update(lossed("masked", pg, *moe_ffn(pg, _t(x, mesh), mesh=mesh,
                                             k=2)))
    pg = _moe_local(mesh, True, p)
    y, aux = moe_ffn_a2a(pg, _t(shard(x, mesh, "ep", 0), mesh), mesh, k=2,
                         capacity_factor=c["e"] / 2)
    e, n = c["e"], mesh.shape["ep"]
    probs = aux["router_probs"]
    f = torch.nn.functional.one_hot(aux["expert_index"].long(), e).to(
        probs.dtype).mean(0)
    f = C.all_reduce(f, mesh.group("ep"), "mean")
    part = (torch.sum(y ** 2) / (c["tokens"] * c["d"])
            + 0.01 * e / n * torch.sum(f * probs.mean(0)))
    part.backward()
    out["a2a/loss_part"] = _host(part)
    out.update({f"a2a/{k}": _host(t.grad) for k, t in pg.items()})
    return out


def run_dry_moe_lm(mesh) -> Dict[str, np.ndarray]:
    """Phase 4b: PipelinedMoELM (2 stages, 4 experts each, capacity
    factor 2 = E/k: no drops) on pp x ep x dp, 4 microbatches, no
    balance loss, one Adam step; the dense step without a mesh."""
    if mesh is None:
        return dry_dense_lm("moe", dry_moe_lm_batch(), capacity_factor=2.0)
    tr = lm_trainer(mesh, "moe", model_kw=dict(capacity_factor=2.0),
                    num_microbatches=4, lb_weight=0.0)
    return _dry_step(tr, dry_moe_lm_batch())


def dry_ring_q() -> np.ndarray:
    """Phase 5's q = k = v: [2, 64, 8, 32] from RandomState(5)."""
    return np.random.RandomState(5).randn(2, 64, 8, 32).astype(np.float32)


def run_dry_ring(mesh) -> Dict[str, np.ndarray]:
    """Phase 5: causal ring attention and Ulysses over sp (the rank's
    output shards)."""
    from paddle_tpu_torch.parallel.ring import ring_attention, ulysses_attention
    q = _t(shard(dry_ring_q(), mesh, "sp", 1), mesh)
    return {"ring": _host(ring_attention(q, q, q, mesh, causal=True)),
            "ulysses": _host(ulysses_attention(q, q, q, mesh, causal=True))}


DRY_CASES = ("dry_mlp", "dry_tf", "dry_pipe", "dry_1f1b", "dry_moe",
             "dry_moe_lm", "dry_ring")


# -- chip_smoke.py's mesh_parallel: the slice's paths at full width ------------
# (PTPU_PAR, `par_conf`, gives the shapes; the ranks share the card)

def par_conf(ring: Dict, pipe: Dict, moe: Dict, moe_lm: Dict,
             ref_path: str, moe_ref_path: str) -> Dict:
    """The JSON-able configuration the ranks read from PTPU_PAR: the
    long-context shapes, the pipeline's and the experts' runs, and where
    the parent wrote the final parameters of the dense PipelinedLM and
    PipelinedMoELM steps."""
    return dict(ring=ring, pipe=pipe, moe=moe, moe_lm=moe_lm,
                ref_path=ref_path, moe_ref_path=moe_ref_path)


def _par() -> Dict:
    return json.loads(os.environ["PTPU_PAR"])


def _flash_counts() -> Dict[str, int]:
    from paddle_tpu_torch.testing.mesh_cases import _flash_launches
    return _flash_launches()


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _median_ms(fn, dev, iters: int) -> float:
    """The median ms of `iters` synchronised calls after one untimed."""
    import time
    fn()
    ms = []
    for _ in range(iters):
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms))


def _reset_peak(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _peak(dev) -> int:
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" \
        else -1


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want| (the bf16 kernel bar's scale)."""
    want = want.float()
    return float((got.float() - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


def ring_inputs(conf: Dict, dev):
    """The long-context case's whole q, k, v and dO, drawn on the CPU
    from conf["seed"] (every rank draws the same)."""
    b, t, h, d = conf["shape"]
    gen = torch.Generator().manual_seed(conf["seed"])
    dtype = getattr(torch, conf["dtype"])
    return [(torch.randn((b, t, h, d), generator=gen) * 0.5).to(
        dev, dtype) for _ in range(4)]


def plain_attention(q, k, v, do, causal: bool) -> List[torch.Tensor]:
    """o, dq, dk and dv of softmax(q k^T / sqrt(D)) v for [B, T, H, D]
    inputs and the output gradient `do`, in float32 plain PyTorch, one
    (batch, head) at a time: [T, T] scores each (1 GiB at T 16384)."""
    b, t, h, d = q.shape
    outs = [torch.empty(q.shape, dtype=torch.float32, device=q.device)
            for _ in range(4)]
    hide = (torch.ones((t, t), dtype=torch.bool, device=q.device)
            .triu_(1) if causal else None)
    for i in range(b):
        for j in range(h):
            qq, kk, vv = (x[i, :, j].to(torch.float32, copy=True)
                          .requires_grad_() for x in (q, k, v))
            sc = (qq @ kk.T) * d ** -0.5
            if causal:
                sc = sc.masked_fill(hide, float("-inf"))
            o = torch.softmax(sc, -1) @ vv
            del sc
            o.backward(do[i, :, j].float())
            for buf, val in zip(outs, (o, qq.grad, kk.grad, vv.grad)):
                buf[i, :, j] = val.detach()
    return outs


RING_VARIANTS = ("causal", "zigzag", "full", "ulysses")


def run_chip_ring(mesh) -> Dict[str, np.ndarray]:
    """Ring flash (causal contiguous, causal zig-zag, non-causal) and
    Ulysses (causal) at the configured shape on sp ranks: each variant's
    forward and backward once with the kernel counts set to 0 just
    before (their launches and the collective calls and host seconds
    after), the rank's shards of o, dq, dk and dv against plain float32
    attention on the whole sequence (`plain_attention`, on this rank's
    device) and against one rank's `flash_attention` on it (max error
    over the largest magnitude), the peak bytes of that run, and the
    forward and forward + backward ms (medians)."""
    from paddle_tpu_torch.kernels import flash
    from paddle_tpu_torch.parallel import collective as C
    from paddle_tpu_torch.parallel.ring import (ring_flash_attention,
                                                ulysses_attention,
                                                zigzag_shard)
    from paddle_tpu_torch.testing.mesh_cases import _reset_flash_launches
    conf = _par()["ring"]
    dev = mesh.device
    sp = mesh.shape["sp"]
    q, k, v, do = ring_inputs(conf, dev)
    out = {}
    for variant in RING_VARIANTS:
        causal = variant != "full"
        zig = variant == "zigzag"

        def local(x):
            x = zigzag_shard(x, sp) if zig else x
            return x.chunk(sp, 1)[mesh.coords["sp"]].contiguous()

        ql, kl, vl, dol = (local(x) for x in (q, k, v, do))

        def run(grad: bool):
            qq, kk, vv = (x.detach().requires_grad_(grad)
                          for x in (ql, kl, vl))
            if variant == "ulysses":
                o = ulysses_attention(qq, kk, vv, mesh, causal=True)
            else:
                o = ring_flash_attention(qq, kk, vv, mesh, causal=causal,
                                         zigzag=zig)
            if grad:
                o.backward(dol)
            return o, qq, kk, vv

        _sync(dev)
        _reset_peak(dev)
        _reset_flash_launches()
        calls, secs = C.STATS["calls"], C.STATS["seconds"]
        o, qq, kk, vv = run(True)
        _sync(dev)
        out[f"{variant}/launches"] = np.asarray(
            [_flash_counts()[n] for n in ("flash_fwd", "flash_dq",
                                          "flash_dkv")])
        out[f"{variant}/collective_calls"] = np.asarray(
            C.STATS["calls"] - calls)
        out[f"{variant}/collective_s"] = np.asarray(
            C.STATS["seconds"] - secs)
        out[f"{variant}/peak_bytes"] = np.asarray(_peak(dev))
        got = (o, qq.grad, kk.grad, vv.grad)
        for name, g, want in zip(("o", "dq", "dk", "dv"), got,
                                 plain_attention(q, k, v, do, causal)):
            out[f"{variant}/err_{name}"] = np.asarray(
                _rel_err(g, local(want)))
        del want
        # one rank's kernels on the whole sequence (launched after the
        # counts were read)
        wq, wk, wv = (x.detach().requires_grad_() for x in (q, k, v))
        wo = flash.flash_attention(wq, wk, wv, causal=causal)
        wo.backward(do)
        for name, g, want in zip(("o", "dq", "dk", "dv"), got,
                                 (wo, wq.grad, wk.grad, wv.grad)):
            out[f"{variant}/err_flash_{name}"] = np.asarray(
                _rel_err(g, local(want)))
        del o, qq, kk, vv, wq, wk, wv, wo, got, want
        with torch.no_grad():
            out[f"{variant}/fwd_ms"] = np.asarray(_median_ms(
                lambda: run(False), dev, conf["iters"]))
        out[f"{variant}/fwd_bwd_ms"] = np.asarray(_median_ms(
            lambda: run(True), dev, conf["iters"]))
    return out


def pipe_batches(conf: Dict) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The pipeline run's batches: random tokens, one seed a step."""
    out = []
    for i in range(conf["steps"]):
        tok = np.random.RandomState(conf["seed"] + i).randint(
            0, conf["vocab"], (conf["batch"], conf["seq"] + 1))
        out.append((tok[:, :-1].astype(np.int64), tok[:, 1:].astype(
            np.int64)))
    return out


def pipe_model(conf: Dict, dev, moe: bool = False):
    """PipelinedLM (or PipelinedMoELM) of `conf`, initialised on the CPU
    from conf["seed"] (the same weights on every rank and in the
    parent), then moved to `dev`."""
    from paddle_tpu_torch.parallel.pipeline import PipelinedLM, PipelinedMoELM
    torch.manual_seed(conf["seed"])
    args = (conf["vocab"], conf["d_model"], conf["n_heads"], conf["d_ff"],
            conf["stages"], conf["max_len"])
    m = (PipelinedMoELM(*args, num_experts=conf["experts"]) if moe
         else PipelinedLM(*args))
    return m.to(dev)


def dense_pipe_steps(conf: Dict, dev, moe: bool = False
                     ) -> Tuple[List[float], Dict]:
    """One rank's dense steps (PipelinedLM.forward, or PipelinedMoELM's,
    the mean CE, Adam at conf["lr"]) on the pipeline run's batches:
    (losses, the final parameters by JAX path)."""
    from paddle_tpu_torch.models.convert import param_path
    from paddle_tpu_torch.ops.functional import softmax_with_cross_entropy
    from paddle_tpu_torch.optim import Adam
    model = pipe_model(conf, dev, moe)
    opt = Adam(model.parameters(), conf["lr"])
    losses = []
    for x, y in pipe_batches(conf):
        x, y = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
        opt.zero_grad(set_to_none=True)
        loss = softmax_with_cross_entropy(model(x).float(), y).mean()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    return losses, {param_path(n): p.detach() for n, p in
                    model.named_parameters()}


def _param_gap(tr, want: Dict[str, torch.Tensor]) -> float:
    """The largest absolute gap of the trainer's parameters (this rank's
    slices) to the whole parameters `want` by JAX path."""
    gap = 0.0
    for n, p in tr.module.named_parameters():
        pl = tr._plans[n]
        gap = max(gap, float((p.detach() - want[pl.path][pl.index])
                             .abs().max()))
    return gap


def run_chip_pipe(mesh) -> Dict[str, np.ndarray]:
    """PipelinedLM over pp ranks under GPipe and then 1F1B: the run's
    Adam steps through MeshTrainer, each schedule's losses, step ms,
    peak bytes and collective calls, and the largest absolute gap of
    this rank's slices to the dense steps' final parameters at
    ref_path."""
    import time
    from paddle_tpu_torch.optim import Adam
    from paddle_tpu_torch.parallel import collective as C
    from paddle_tpu_torch.parallel import DistStrategy, MeshTrainer
    from paddle_tpu_torch.parallel.pipeline import (pipeline_rules,
                                                    pipelined_lm_loss)
    par = _par()
    conf = par["pipe"]
    dev = mesh.device
    want = torch.load(par["ref_path"], map_location=dev)
    out = {}
    for schedule in ("gpipe", "1f1b"):
        model = pipe_model(conf, dev)
        tr = MeshTrainer(model, Adam(model.parameters(), conf["lr"]),
                         pipelined_lm_loss(mesh, num_microbatches=conf["m"],
                                           schedule=schedule),
                         mesh, strategy=DistStrategy(batch_axes=("dp",)),
                         rules=pipeline_rules())
        _sync(dev)
        _reset_peak(dev)
        calls, secs = C.STATS["calls"], C.STATS["seconds"]
        losses, ms = [], []
        for b in pipe_batches(conf):
            _sync(dev)
            t0 = time.perf_counter()
            losses.append(float(tr.train_step(tr.put_batch(b))["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
        out[f"{schedule}/losses"] = np.asarray(losses)
        out[f"{schedule}/step_ms"] = np.asarray(ms)
        out[f"{schedule}/peak_bytes"] = np.asarray(_peak(dev))
        out[f"{schedule}/collective_calls"] = np.asarray(
            C.STATS["calls"] - calls)
        out[f"{schedule}/collective_s"] = np.asarray(
            C.STATS["seconds"] - secs)
        out[f"{schedule}/param_gap"] = np.asarray(_param_gap(tr, want))
        del tr, model
    return out


def moe_case(conf: Dict, dev):
    """The experts case's whole parameters, tokens and loss weights,
    drawn on the CPU from conf["seed"]."""
    gen = torch.Generator().manual_seed(conf["seed"])
    e, d, hid, t = conf["experts"], conf["d"], conf["hid"], conf["tokens"]
    dtype = getattr(torch, conf["dtype"])
    s1, s2 = (2.0 / d) ** 0.5, (2.0 / hid) ** 0.5
    p = {"gate": torch.randn((d, e), generator=gen) * s1,
         "w1": torch.randn((e, d, hid), generator=gen) * s1,
         "w2": torch.randn((e, hid, d), generator=gen) * s2}
    x = torch.randn((t, d), generator=gen)
    w = torch.randn((t, d), generator=gen)
    return ({k: v.to(dev, dtype) for k, v in p.items()}, x.to(dev, dtype),
            w.to(dev))


def run_chip_moe(mesh) -> Dict[str, np.ndarray]:
    """moe_ffn (masked) and moe_ffn_a2a at each capacity factor on ep
    ranks, forward and backward of sum(y * w): y (this rank's tokens for
    a2a) and the gate's gradient (a2a's summed over the ranks) against
    one rank's moe_ffn over every expert, the dropped fraction, the ms
    (median) and, at ample capacity, a2a against masked."""
    from paddle_tpu_torch.parallel import collective as C
    from paddle_tpu_torch.parallel.moe import moe_ffn, moe_ffn_a2a
    conf = _par()["moe"]
    dev = mesh.device
    n, r = mesh.shape["ep"], mesh.coords["ep"]
    p, x, w = moe_case(conf, dev)
    k = conf["k"]
    g = mesh.group("ep")
    whole = {kk: v.detach().requires_grad_(kk == "gate")
             for kk, v in p.items()}
    y_ref, _ = moe_ffn(whole, x, k=k)
    (y_ref.float() * w).sum().backward()
    gate_ref = whole["gate"].grad

    def mine(kk, v):
        v = v if kk == "gate" else v.chunk(n, 0)[r]
        return v.detach().clone().requires_grad_(kk == "gate")

    out = {}

    def masked():
        pl = {kk: mine(kk, v) for kk, v in p.items()}
        y, _ = moe_ffn(pl, x, mesh=mesh, k=k)
        (y.float() * w).sum().backward()
        return y, pl["gate"].grad, None

    def a2a(cf):
        def go():
            pl = {kk: mine(kk, v) for kk, v in p.items()}
            y, aux = moe_ffn_a2a(pl, x.chunk(n, 0)[r], mesh, k=k,
                                 capacity_factor=cf)
            (y.float() * w.chunk(n, 0)[r]).sum().backward()
            return y, C.all_reduce(pl["gate"].grad, g), aux
        return go

    runs = [("masked", masked)] + [(f"a2a_cf{cf}", a2a(cf))
                                   for cf in conf["cfs"]]
    ys = {}
    for name, fn in runs:
        y, gate, aux = fn()
        want = y_ref if name == "masked" else y_ref.chunk(n, 0)[r]
        out[f"{name}/err_y"] = np.asarray(_rel_err(y, want))
        out[f"{name}/err_gate"] = np.asarray(_rel_err(gate, gate_ref))
        out[f"{name}/dropped"] = np.asarray(
            0.0 if aux is None else float(aux["dropped_fraction"]))
        out[f"{name}/ms"] = np.asarray(_median_ms(fn, dev, conf["iters"]))
        ys[name] = y.detach()
    ample = f"a2a_cf{conf['cfs'][-1]}"
    out["a2a_vs_masked"] = np.asarray(_rel_err(
        ys[ample], ys["masked"].chunk(n, 0)[r]))
    return out


def run_chip_moe_lm(mesh) -> Dict[str, np.ndarray]:
    """PipelinedMoELM over pp x ep ranks (GPipe, lb 0): the run's Adam
    steps through MeshTrainer, their losses and step ms, and the largest
    absolute gap of this rank's slices to the dense steps' final
    parameters at moe_ref_path."""
    import time
    from paddle_tpu_torch.optim import Adam
    from paddle_tpu_torch.parallel import DistStrategy, MeshTrainer
    from paddle_tpu_torch.parallel.pipeline import (pipeline_moe_rules,
                                                    pipelined_moe_lm_loss)
    par = _par()
    conf = par["moe_lm"]
    dev = mesh.device
    model = pipe_model(conf, dev, moe=True)
    tr = MeshTrainer(model, Adam(model.parameters(), conf["lr"]),
                     pipelined_moe_lm_loss(mesh, num_microbatches=conf["m"],
                                           lb_weight=0.0),
                     mesh, strategy=DistStrategy(batch_axes=("dp",)),
                     rules=pipeline_moe_rules())
    losses, ms = [], []
    for b in pipe_batches(conf):
        _sync(dev)
        t0 = time.perf_counter()
        losses.append(float(tr.train_step(tr.put_batch(b))["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    want = torch.load(par["moe_ref_path"], map_location=dev)
    return {"losses": np.asarray(losses), "step_ms": np.asarray(ms),
            "param_gap": np.asarray(_param_gap(tr, want))}


CASES: Dict[str, Tuple[Dict[str, int], Callable]] = {
    "ring_dense": (dict(sp=8), run_ring_dense),
    "ring_grads": (dict(sp=4, dp=2), run_ring_grads),
    "ring_flash": (dict(sp=4, dp=2), run_ring_flash),
    "ulysses": (dict(sp=4, dp=2), run_ulysses),
    "moe": (dict(ep=4, dp=2), run_moe),
    "moe_pressure": (dict(ep=4, dp=2), run_moe_pressure),
    "toy": (dict(pp=4, dp=2), run_toy),
    "pipe_dp": (dict(pp=4, dp=2), lambda m: run_pipe(m, "pipe_dp")),
    "pipe_extra": (dict(pp=4, dp=2), run_pipe_extra),
    "pipe_generate": (dict(pp=4, dp=2), run_pipe_generate),
    "pipe_ckpt": (dict(pp=4, dp=2), run_pipe_ckpt),
    "pipe_tp": (dict(pp=2, tp=2, dp=2), lambda m: run_pipe(m, "pipe_tp")),
    "pipe_sp": (dict(pp=2, sp=2, dp=2), lambda m: run_pipe(m, "pipe_sp")),
    "pipe_tp_sp": (dict(pp=2, tp=2, sp=2),
                   lambda m: run_pipe(m, "pipe_tp_sp")),
    "pipe_ulysses_refusal": (dict(pp=2, tp=2, sp=2),
                             run_pipe_ulysses_refusal),
    "pipe_ep": (dict(pp=2, ep=2, dp=2), lambda m: run_pipe(m, "pipe_ep")),
    "pipe_ep4": (dict(pp=2, ep=4), lambda m: run_pipe(m, "pipe_ep4")),
    # chip_mesh_nccl.py's 4-rank cases (a card a rank)
    "ring_flash4": (dict(sp=4), run_ring_flash),
    "ulysses4": (dict(sp=4), run_ulysses),
    "nccl_pipe": (dict(pp=2, dp=2), lambda m: run_pipe(m, "nccl_pipe")),
    "moe4": (dict(ep=4), run_moe),
    "chip_ring": (dict(sp=2), run_chip_ring),
    "chip_pipe": (dict(pp=2), run_chip_pipe),
    "chip_moe": (dict(ep=2), run_chip_moe),
    "chip_moe_lm": (dict(pp=2, ep=2), run_chip_moe_lm),
    # the dry-run gate (tests/test_torch_dryrun_gate.py): 8 ranks
    "dry_mlp": (dict(dp=4, fsdp=2), run_dry_mlp),
    "dry_tf": (dict(dp=2, tp=4), run_dry_tf),
    "dry_pipe": (dict(pp=2, tp=2, sp=2), run_dry_pipe),
    "dry_1f1b": (dict(pp=2, tp=2, dp=2), run_dry_1f1b),
    "dry_moe": (dict(ep=4, dp=2), run_dry_moe),
    "dry_moe_lm": (dict(pp=2, ep=2, dp=2), run_dry_moe_lm),
    "dry_ring": (dict(sp=8), run_dry_ring),
}


# -- the world --------------------------------------------------------------------

def main() -> int:
    """One rank: run PTPU_CASES (comma-separated) in order, one mesh a
    shape, writing `{name}-r{rank}.npz` to PTPU_WORLD_OUT."""
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
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    out_dir = os.environ["PTPU_WORLD_OUT"]
    meshes: Dict[Tuple, object] = {}
    for name in os.environ["PTPU_CASES"].split(","):
        shape, fn = CASES[name]
        key = tuple(sorted(shape.items()))
        if key not in meshes:
            meshes[key] = make_mesh(MeshConfig(**shape))
        torch.manual_seed(0)
        res = fn(meshes[key])
        np.savez(os.path.join(out_dir, f"{name}-r{rank}.npz"), **res)
        print(json.dumps({"case": name, "rank": rank}), flush=True)
    torch.distributed.destroy_process_group()
    return 0


def world_once(basetemp, key: str, make: Callable) -> Dict:
    """`make(directory)`'s result, made once for a pytest session: the
    first test worker to ask makes it under a lock and pickles it beside
    `basetemp` (parallel workers share the parent of their basetemps);
    the others wait and read it. A world of 8 ranks then starts once,
    whichever workers its tests land on."""
    import fcntl
    import pickle
    from pathlib import Path
    base = Path(basetemp)
    shared = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    d = shared / key
    with open(shared / f"{key}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        done = d / "result.pkl"
        if not done.exists():
            d.mkdir(exist_ok=True)
            res = make(d)
            with open(d / "part.pkl", "wb") as f:
                pickle.dump(res, f)
            os.replace(d / "part.pkl", done)
        with open(done, "rb") as f:
            return pickle.load(f)


def run_world(n: int, names: Sequence[str], device: Optional[str] = "cpu",
              share_card: bool = False, env: Optional[Dict] = None,
              timeout: float = 300.0) -> Dict[str, List[Dict]]:
    """Launch n ranks that run the cases `names` in order; returns
    {name: [rank 0's results, rank 1's, ...]}."""
    from paddle_tpu_torch.parallel.launch import launch
    with tempfile.TemporaryDirectory() as out:
        penv = {"PYTHONPATH": os.pathsep.join(
                    [REPO_ROOT, os.environ.get("PYTHONPATH", "")]),
                "PTPU_CASES": ",".join(names), "PTPU_WORLD_OUT": out,
                **(env or {})}
        launch(n, [sys.executable, "-m",
                   "paddle_tpu_torch.testing.parallel_cases"],
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
