"""Pipeline parallelism over the mesh's "pp" axis: GPipe and 1F1B
schedules, `PipelinedLM` and `PipelinedMoELM` (port of
paddle_tpu/parallel/pipeline.py).

The model is S_total equal-width stages whose parameters are stacked on
a leading dim sharded over pp (S ranks): each rank holds v = S_total / S
consecutive stages and chains them inside one tick. M microbatches
stream through M + S - 1 ticks; at tick t stage s runs microbatch
t - s, and activations hop one stage a tick by `ppermute`.

JAX differentiates through its conveyor scan and XLA orders the
collectives. Ranks of different stages hold different autograd graphs,
and one `backward()` through collectives could call them in different
orders on different ranks, so the port writes the schedules out:

- `pipeline_stream` (GPipe): one autograd Function whose forward runs
  the forward sweep, keeping each tick's local graph with its boundary
  activation detached, then the backward sweep tick by tick in reverse
  (JAX's transposed scan), cotangents hopping back by the reverse
  `ppermute`; its backward only scales the gradients it computed. A
  tick's local graph runs only the collectives of the stage's own tp,
  sp or ep peers, which hold the same graph.
- `pipeline_stream_1f1b`: the same Function around JAX's interleaved
  schedule (`pipeline.py:319-476`): stage s runs the forward of
  microbatch t - s and the backward of t - 2(S-1) + s at tick t,
  recomputing the stage from a stash of its inputs (depth <= 2S - 1), so
  activations stay O(S), not O(M). Same loss and gradients as GPipe.
- Under `torch.no_grad()` (an eval) either stream runs GPipe's forward
  sweep alone and returns the loss, as JAX's eval runs the forward.
- `pipeline_apply` returns the outputs and is differentiated by
  autograd: every rank runs every tick (bubble ticks on zeros, as JAX's
  SPMD program), so every rank's graph has the same shape.

Both streams take this rank's stage stack (dict of [v, ...] tensors),
the replicated consume parameters, microbatches xs [M, mb, ...] and
targets ys [M, ...] whole on every rank of the pp axis, and return the
loss, the same on every rank. Departures from JAX: the microbatches
are not strided over pp and injected by a masked psum: every pp rank
holds its data-parallel slice of the batch already (`put_batch`), so
stage 0 reads microbatch t itself and the last stage its targets, and
the input gradient comes back through `copy_to_axis`. Idle (bubble)
ticks compute nothing in the streams.

Gradients a rank's leaves need summed across ranks (JAX's psum
transposes) are added with `copy_to_axis`: the consume parameters over
pp and the sequence axes, the stage stack over the sequence axes, xs
over pp (so every pp rank gets the whole input gradient), the
embedding over the sequence axes; the loss is averaged over the
sequence axes. MeshTrainer averages over its batch axes (JAX's
`batch_axes` argument is the trainer's business here).
"""

from __future__ import annotations

import functools
import threading
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from paddle_tpu_torch.nn import initializers as I
from paddle_tpu_torch.parallel import collective as C
from paddle_tpu_torch.parallel.sharding import ShardingRules

Params = Dict[str, torch.Tensor]


def stack_stage_params(per_stage: Sequence[Params]) -> Params:
    """Stack per-stage parameter dicts on a new leading dim (shard it over
    "pp")."""
    return {k: torch.stack([p[k] for p in per_stage])
            for k in per_stage[0]}


def _check_stages(stacked: Params, s: int, axis: str) -> int:
    """The stage stack must divide onto the axis: each rank holds v =
    S_total / S consecutive stages. Returns v."""
    lead = next(iter(stacked.values())).shape[0] if stacked else s
    if lead % s:
        raise ValueError(
            f"stacked stage dim {lead} must be a multiple of mesh "
            f"'{axis}' size {s} (v consecutive stages per device)")
    return lead // s


def _local_stages(stacked: Params, s: int, stage: int, axis: str) -> Params:
    """This rank's v stages of a whole stack."""
    v = _check_stages(stacked, s, axis)
    return {k: p[stage * v:(stage + 1) * v] for k, p in stacked.items()}


def _chain(stage_fn: Callable, params_v: Params, x: torch.Tensor):
    """This rank's v stages in order (one tick's compute): (y, the
    summed stage-aux scalar in float32)."""
    v = next(iter(params_v.values())).shape[0] if params_v else 1
    aux = torch.zeros((), device=x.device)
    for i in range(v):
        out = stage_fn({k: p[i] for k, p in params_v.items()}, x)
        if isinstance(out, tuple):
            x, a = out
            aux = aux + a.float()
        else:
            x = out
    return x, aux


def _microbatch(x: torch.Tensor, m: int) -> torch.Tensor:
    """[B, ...] -> [m, B/m, ...] with row b in microbatch b mod m (JAX's
    interleaved assignment)."""
    b = x.shape[0]
    return x.reshape((b // m, m) + tuple(x.shape[1:])).transpose(0, 1)


# -- saved-tensor accounting -------------------------------------------------

_LOCAL = threading.local()


class _Held:
    """A saved tensor and its bytes, uncounted when autograd frees it."""
    __slots__ = ("t", "n", "tracker")

    def __init__(self, t, tracker):
        self.t, self.tracker = t, tracker
        self.n = t.numel() * t.element_size()
        tracker.live += self.n
        tracker.peak = max(tracker.peak, tracker.live)

    def __del__(self):
        self.tracker.live -= self.n


def _pack(t):
    tracker = getattr(_LOCAL, "tracker", None)
    return t if tracker is None else _Held(t, tracker)


def _unpack(h):
    return h.t if isinstance(h, _Held) else h


class saved_bytes:
    """`with saved_bytes() as s:` — `s.peak`, the most bytes that
    autograd held saved for backward at once on this thread while open
    (inside the schedules too): a rank's activation liveness."""

    def __enter__(self):
        self.live = self.peak = 0
        self._prev = getattr(_LOCAL, "tracker", None)
        _LOCAL.tracker = self
        self._hooks = torch.autograd.graph.saved_tensors_hooks(_pack,
                                                               _unpack)
        self._hooks.__enter__()
        return self

    def __exit__(self, *exc):
        self._hooks.__exit__(*exc)
        _LOCAL.tracker = self._prev


# -- the schedules -------------------------------------------------------------

class _Precomputed(torch.autograd.Function):
    """forward: run(*tensors) -> (loss, gradient of each tensor);
    backward: those gradients times the incoming one."""

    @staticmethod
    def forward(ctx, run, *tensors):
        leaves = [t.detach().requires_grad_(t.is_floating_point())
                  for t in tensors]
        # the schedule's own local graphs: an outer checkpoint's hooks
        # must not see (and replay) them
        with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
                _pack, _unpack):
            loss, grads = run(*leaves)
        ctx.grads = grads
        return loss.detach()

    @staticmethod
    def backward(ctx, g):
        return (None, *(None if d is None else d * g for d in ctx.grads))


class _Pipe:
    """One call's schedule: the stage and consume functions, the pp
    group, this rank's stage, S, v and M."""

    def __init__(self, stage_fn, consume_fn, mesh, axis, v, m):
        self.stage_fn, self.consume_fn = stage_fn, consume_fn
        self.s = mesh.shape[axis]
        self.stage = mesh.coords[axis]
        self.group = mesh.maybe_group(axis)
        self.v, self.m = v, m

    def hop(self, x, shift: int):
        return x if self.group is None else C.ppermute(
            x, self.group, C.ring_perm(self.s, shift))

    def total(self, acc, sacc):
        tot = torch.stack([acc, sacc])
        if self.group is not None:
            tot = C.all_reduce(tot, self.group)
        return tot[0] / self.m + tot[1] / (self.s * self.v * self.m)


def _grads(outs, cots, ins):
    """autograd.grad of (outs, cots) into `ins`, zeros where unused;
    outs that need no gradient are left out."""
    pairs = [(o, c) for o, c in zip(outs, cots) if o.requires_grad]
    gs = torch.autograd.grad([o for o, _ in pairs], ins,
                             [c for _, c in pairs], allow_unused=True)
    return [torch.zeros_like(x) if g is None else g for g, x in zip(gs, ins)]


def _schedule_inputs(p: _Pipe, names, n_aux, leaves):
    """(stage params by name, consume params, xs, ys, a zero activation,
    the consume's cotangent 1/M and the stage-aux's 1/(S v M))."""
    xs = leaves[-2]
    dev = xs.device
    return (dict(zip(names, leaves[:len(names)])),
            list(leaves[len(names):len(names) + n_aux]), xs, leaves[-1],
            torch.zeros_like(xs[0]), torch.tensor(1.0 / p.m, device=dev),
            torch.tensor(1.0 / (p.s * p.v * p.m), device=dev))


def _forward_sweep(p: _Pipe, params: Params, aux, xs, ys):
    """GPipe's forward sweep: (the loss, each microbatch's tick (x, y,
    stage aux, consumed loss or None), their local graphs kept when grad
    is on)."""
    s, stage, m = p.s, p.stage, p.m
    total = m + s - 1
    acc = sacc = torch.zeros((), device=xs.device)
    ticks = {}
    buf = zero = torch.zeros_like(xs[0])
    for t in range(total):
        j = t - stage
        y = zero
        if 0 <= j < m:
            x = (xs[j] if stage == 0 else buf).detach().requires_grad_()
            y, a = _chain(p.stage_fn, params, x)
            sacc = sacc + a.detach()
            li = None
            if stage == s - 1:
                li = p.consume_fn(aux, y, ys[j]).float()
                acc = acc + li.detach()
            ticks[j] = (x, y, a, li)
            y = y.detach()
        if t != total - 1:
            buf = p.hop(y, 1)
    return p.total(acc, sacc), ticks


def _gpipe(p: _Pipe, names, n_aux, *leaves):
    """GPipe: the forward sweep, then the backward sweep in reverse tick
    order. Returns (loss, gradients of leaves)."""
    params, aux, xs, ys, zero, one_m, aux_cot = _schedule_inputs(
        p, names, n_aux, leaves)
    s, stage, m = p.s, p.stage, p.m
    total = m + s - 1
    loss, ticks = _forward_sweep(p, params, aux, xs, ys)

    dp = [torch.zeros_like(x) for x in params.values()]
    da = [torch.zeros_like(x) for x in aux]
    dxs = torch.zeros_like(xs)
    g_buf = zero
    for t in reversed(range(total)):
        j = t - stage
        dx = zero
        if 0 <= j < m:
            x, y, a, li = ticks.pop(j)
            last = li is not None
            gs = _grads([li if last else y, a],
                        [one_m if last else g_buf, aux_cot],
                        [x, *params.values(), *(aux if last else [])])
            dx = gs[0]
            dp = [u + w for u, w in zip(dp, gs[1:1 + len(dp)])]
            if last:
                da = [u + w for u, w in zip(da, gs[1 + len(dp):])]
            if stage == 0:
                dxs[j] = dx
        if t != 0:
            g_buf = p.hop(dx, -1)
    return loss, (*dp, *da, dxs, None)


def _one_f_one_b(p: _Pipe, names, n_aux, *leaves):
    """1F1B: one forward and one recomputed backward a tick
    (`pipeline.py:394-464`). Returns (loss, gradients of leaves)."""
    params, aux, xs, ys, zero, one_m, aux_cot = _schedule_inputs(
        p, names, n_aux, leaves)
    s, stage, m = p.s, p.stage, p.m
    acc = sacc = torch.zeros((), device=xs.device)
    dp = [torch.zeros_like(x) for x in params.values()]
    da = [torch.zeros_like(x) for x in aux]
    dxs = torch.zeros_like(xs)
    stash = {}
    fwd_buf = bwd_buf = zero
    total = m + 2 * (s - 1)
    for t in range(total):
        # forward: stage s runs microbatch t - s
        j_f = t - stage
        y = zero
        if 0 <= j_f < m:
            x_t = xs[j_f] if stage == 0 else fwd_buf
            stash[j_f] = x_t
            with torch.no_grad():
                y, a = _chain(p.stage_fn, params, x_t)
            sacc = sacc + a
        # the last stage consumes microbatch t - (S-1) and seeds its
        # cotangent the same tick
        j = t - (s - 1)
        dy = None
        if stage == s - 1 and 0 <= j < m:
            y_leaf = y.detach().requires_grad_()
            li = p.consume_fn(aux, y_leaf, ys[j]).float()
            acc = acc + li.detach()
            gs = _grads([li], [one_m], [y_leaf, *aux])
            dy = gs[0]
            da = [u + w for u, w in zip(da, gs[1:])]
        # backward: stage s runs microbatch t - 2(S-1) + s from its stash
        j_b = t - 2 * (s - 1) + stage
        dx = zero
        if 0 <= j_b < m:
            x_saved = stash.pop(j_b).detach().requires_grad_()
            y2, a2 = _chain(p.stage_fn, params, x_saved)
            gs = _grads([y2, a2], [dy if dy is not None else bwd_buf,
                                   aux_cot],
                        [x_saved, *params.values()])
            dx = gs[0]
            dp = [u + w for u, w in zip(dp, gs[1:])]
            if stage == 0:
                dxs[j_b] = dx
        if t != total - 1:
            fwd_buf = p.hop(y, 1)
            bwd_buf = p.hop(dx, -1)
    return p.total(acc, sacc), (*dp, *da, dxs, None)


def _stream(schedule: Callable, stage_fn: Callable, consume_fn: Callable,
            mesh, axis: str, seq_axes: Sequence[str]):
    seq_axes = tuple(seq_axes)

    def fn(stacked: Params, aux_params: Sequence[torch.Tensor],
           xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
        names = list(stacked)
        v = next(iter(stacked.values())).shape[0] if stacked else 1
        p = _Pipe(stage_fn, consume_fn, mesh, axis, v, xs.shape[0])
        seq = mesh.maybe_group(seq_axes) if seq_axes else None
        if not torch.is_grad_enabled():
            # an eval: the forward sweep alone (either schedule's loss)
            loss = _forward_sweep(p, stacked, list(aux_params), xs, ys)[0]
            return (loss if seq is None
                    else C.reduce_from_axis(loss, seq) / seq.size)
        outer = mesh.maybe_group((axis,) + seq_axes)
        tensors = [C.copy_to_axis(x, seq) if seq is not None else x
                   for x in stacked.values()]
        tensors += [C.copy_to_axis(a, outer) if outer is not None else a
                    for a in aux_params]
        tensors.append(C.copy_to_axis(xs, p.group)
                       if p.group is not None else xs)
        run = functools.partial(schedule, p, names, len(aux_params))
        loss = _Precomputed.apply(run, *tensors, ys)
        if seq is not None:
            loss = C.reduce_from_axis(loss, seq) / seq.size
        return loss
    return fn


def pipeline_stream(stage_fn: Callable, consume_fn: Callable, mesh,
                    axis: str = "pp", seq_axes: Sequence[str] = ()):
    """fn(stacked, aux_params, xs, ys) -> the mean loss, GPipe.

    stacked: this rank's stage stack; stage_fn(params, x) -> y (y.shape
    == x.shape) or (y, stage-aux scalar), the scalar averaged over every
    valid (stage, microbatch) pair and added to the loss.
    consume_fn(aux_params, y, target) -> the microbatch's loss scalar on
    the last stage. `seq_axes`: axes the sequence dim (xs dim 2) is
    sharded over; stage_fn handles the cross-shard attention, and the
    loss is averaged over the shards."""
    return _stream(_gpipe, stage_fn, consume_fn, mesh, axis, seq_axes)


def pipeline_stream_1f1b(stage_fn: Callable, consume_fn: Callable, mesh,
                         axis: str = "pp"):
    """The 1F1B schedule: `pipeline_stream`'s contract and value, O(S)
    activation liveness instead of O(M) (no sequence axes, as JAX's)."""
    return _stream(_one_f_one_b, stage_fn, consume_fn, mesh, axis, ())


def pipeline_apply(stage_fn: Callable, stacked_params: Params,
                   microbatches: torch.Tensor, mesh,
                   axis: str = "pp") -> torch.Tensor:
    """The stacked stages over M microbatches [M, mb, ...] (whole on
    every rank): returns the [M, mb, ...] outputs on every rank.
    stacked_params is the whole stack (its leading dim a multiple of the
    axis size). Differentiable end to end."""
    s = mesh.shape[axis]
    stage = mesh.coords[axis]
    params = _local_stages(stacked_params, s, stage, axis)
    m = microbatches.shape[0]
    if m < 1:
        raise ValueError("need at least one microbatch")
    group = mesh.maybe_group(axis)
    is0 = torch.tensor(stage == 0, device=microbatches.device)
    zero = torch.zeros_like(microbatches[0])
    buf, outs = zero, []
    for t in range(m + s - 1):
        x_t = torch.where(is0, microbatches[t] if t < m else zero, buf)
        y, _ = _chain(stage_fn, params, x_t)
        if t >= s - 1:
            outs.append(y)
        if group is not None and t != m + s - 2:
            buf = C.ppermute(y, group, C.ring_perm(s))
    out = torch.stack(outs)
    return C.broadcast(out, group, s - 1) if group is not None else out


def pipeline_loss_fn(stage_fn: Callable, loss_of_outputs: Callable, mesh,
                     axis: str = "pp",
                     num_microbatches: Optional[int] = None):
    """fn(stacked_params, x, y) -> loss: the batch split into
    microbatches (default the axis size) and streamed through
    `pipeline_stream`, averaging loss_of_outputs(pred, target).
    stacked_params is the whole stack; each rank runs its v stages."""
    stream = pipeline_stream(
        stage_fn, lambda _aux, pred, tgt: torch.mean(
            loss_of_outputs(pred, tgt)), mesh, axis)

    def fn(stacked_params: Params, x: torch.Tensor, y: torch.Tensor):
        s = mesh.shape[axis]
        local = _local_stages(stacked_params, s, mesh.coords[axis], axis)
        m = num_microbatches or s
        return stream(local, (), _microbatch(x, m), _microbatch(y, m))
    return fn


# -- the blocks -------------------------------------------------------------------

SP_MODES = ("ring", "ulysses")


def _layernorm(x, scale, bias, eps: float = 1e-5):
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def _dense_causal(q, k, v, t: int):
    hd = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / (hd ** 0.5)
    pos = torch.arange(t, device=q.device)
    s = torch.where(pos[None, :] <= pos[:, None], s, -1e30)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)


def _attention(p: Params, x: torch.Tensor, n_heads: int,
               tp: Optional[C.AxisGroup] = None,
               sp: Optional[C.AxisGroup] = None, sp_size: int = 1,
               sp_mode: str = "ring") -> torch.Tensor:
    """Pre-LN causal self-attention with its residual. qkv columns are
    packed head-major ([head, role, head_dim]), so under `tp` the
    weights hold whole heads (w_qkv's output dim, w_o's input dim) and
    the sub-layer enters through copy_to_axis and leaves through
    reduce_from_axis. Under `sp`, x is the rank's [mb, T/sp, D] shard
    and the core runs sequence-parallel: "ring" (the dense ring) or
    "ulysses" (all_to_all seq <-> heads, dense attention over H/sp
    heads)."""
    from paddle_tpu_torch.parallel.ring import ring_attention_inner
    if sp is not None and sp_mode not in SP_MODES:
        raise ValueError(f"sp_mode must be one of {SP_MODES}, "
                         f"got {sp_mode!r}")
    b, t, d = x.shape
    hd = d // n_heads
    h = _layernorm(x, p["ln1_s"], p["ln1_b"])
    if tp is not None:
        h = C.copy_to_axis(h, tp)
    qkv = h @ p["w_qkv"]
    local_heads = qkv.shape[-1] // (3 * hd)
    qkv = qkv.reshape(b, t, local_heads, 3, hd)
    q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
    if sp is not None and sp_mode == "ring":
        o = ring_attention_inner(q, k, v, sp, sp_size, causal=True)
    elif sp is not None:
        def a2a(z, fwd):
            return C.all_to_all(z, sp, 2 if fwd else 1, 1 if fwd else 2)
        o = a2a(_dense_causal(a2a(q, True), a2a(k, True), a2a(v, True),
                              t * sp_size), False)
    else:
        o = _dense_causal(q, k, v, t)
    out = o.reshape(b, t, local_heads * hd) @ p["w_o"]
    if tp is not None:
        out = C.reduce_from_axis(out, tp)
    return x + out


def lm_block(p: Params, x: torch.Tensor, n_heads: int,
             tp: Optional[C.AxisGroup] = None,
             sp: Optional[C.AxisGroup] = None, sp_size: int = 1,
             sp_mode: str = "ring") -> torch.Tensor:
    """One pre-LN causal transformer block ([mb, T, D] -> [mb, T, D]) of
    a stage slice of PipelinedLM's stack; the FFN splits w1 / b1 on the
    output dim and w2 on the input dim under tp."""
    x = _attention(p, x, n_heads, tp, sp, sp_size, sp_mode)
    h2 = _layernorm(x, p["ln2_s"], p["ln2_b"])
    if tp is not None:
        h2 = C.copy_to_axis(h2, tp)
    out = torch.relu(h2 @ p["w1"] + p["b1"]) @ p["w2"]
    if tp is not None:
        out = C.reduce_from_axis(out, tp)
    return x + out + p["b2"]


def moe_lm_block(p: Params, x: torch.Tensor, n_heads: int,
                 ep: Optional[C.AxisGroup] = None, k: int = 2,
                 capacity_factor: float = 2.0):
    """lm_block with a top-k MoE FFN (`moe_ffn_local`; the rank's expert
    slices under `ep`): (y, the load-balance scalar)."""
    from paddle_tpu_torch.parallel.moe import moe_ffn_local
    b, t, d = x.shape
    x = _attention(p, x, n_heads)
    h2 = _layernorm(x, p["ln2_s"], p["ln2_b"])
    y, aux = moe_ffn_local(
        {"gate": p["gate"], "w1": p["moe_w1"], "w2": p["moe_w2"]},
        h2.reshape(b * t, d), axis=ep, k=k, capacity_factor=capacity_factor)
    return x + y.reshape(b, t, d), aux["load_balance"]


def _lm_consume(fused_ce: bool):
    """The last stage's loss: final LayerNorm, the vocab head and the
    mean cross-entropy of the microbatch (`linear_cross_entropy` with
    fused_ce: no [tokens, V] logits)."""
    def consume(aux, y_mb, tgt_mb):
        lnf_s, lnf_b, head = aux
        h = _layernorm(y_mb, lnf_s, lnf_b)
        if fused_ce:
            from paddle_tpu_torch.ops.fused_ce import linear_cross_entropy
            return torch.mean(linear_cross_entropy(h, head, tgt_mb))
        from paddle_tpu_torch.ops.functional import (
            softmax_with_cross_entropy)
        return torch.mean(softmax_with_cross_entropy((h @ head).float(),
                                                     tgt_mb))
    return consume


# -- the models ------------------------------------------------------------------

class _Stages(nn.Module):
    """The stacked stage parameters ([S, ...] each). `local_specs()`
    tells MeshTrainer they are consumed at their rank's slice (stage dim
    over pp, Megatron dims over tp, experts over ep), so nothing is
    gathered for use."""

    def __init__(self, shapes: Dict[str, Tuple], inits: Dict[str, Callable],
                 specs: Dict[str, Tuple], device=None):
        super().__init__()
        for name, shape in shapes.items():
            self.register_parameter(name, I.parameter(inits[name], shape,
                                                      device))
        self._specs = specs

    def local_specs(self) -> Dict[str, Tuple]:
        return dict(self._specs)


_LM_SPECS = {"w_qkv": ("pp", None, "tp"), "w_o": ("pp", "tp", None),
             "w1": ("pp", None, "tp"), "b1": ("pp", "tp"),
             "w2": ("pp", "tp", None), "b2": ("pp",),
             "ln1_s": ("pp",), "ln1_b": ("pp",),
             "ln2_s": ("pp",), "ln2_b": ("pp",)}


class PipelinedLM(nn.Module):
    """A decoder-only LM whose transformer blocks are S pipeline stages.
    embed / pos / lnf_* / head are replicated; the blocks are stacked
    under `stages` ([S, ...], JAX's names and layout; `pipeline_rules`).
    `forward` runs the dense computation (init, eval, one-device
    parity); `pipelined_lm_loss` trains the same parameters through the
    pipeline."""

    def __init__(self, vocab: int, d_model: int = 64, n_heads: int = 4,
                 d_ff: int = 128, num_stages: int = 4, max_len: int = 128,
                 device=None):
        super().__init__()
        if d_model % n_heads:
            raise ValueError("n_heads must divide d_model")
        self.vocab, self.d_model, self.n_heads = vocab, d_model, n_heads
        self.d_ff, self.num_stages, self.max_len = d_ff, num_stages, max_len
        d, s = d_model, num_stages
        self.embed = I.parameter(I.normal(0.0, 0.02), (vocab, d), device)
        self.pos = I.parameter(I.normal(0.0, 0.02), (max_len, d), device)
        shapes = {"w_qkv": (s, d, 3 * d), "w_o": (s, d, d),
                  "ln1_s": (s, d), "ln1_b": (s, d),
                  "ln2_s": (s, d), "ln2_b": (s, d), **self._ffn_shapes()}
        inits = {n: (I.constant(1.0) if n.endswith("_s") else
                     I.constant(0.0) if n.startswith(("ln", "b")) else
                     I.normal(0.0, 0.02) if n == "gate" else I.xavier())
                 for n in shapes}
        specs = {n: self._specs().get(n, ("pp",)) for n in shapes}
        self.stages = _Stages(shapes, inits, specs, device)
        self.lnf_s = I.parameter(I.constant(1.0), (d,), device)
        self.lnf_b = I.parameter(I.constant(0.0), (d,), device)
        self.head = I.parameter(I.xavier(), (d, vocab), device)

    def _ffn_shapes(self) -> Dict[str, Tuple]:
        d, f, s = self.d_model, self.d_ff, self.num_stages
        return {"w1": (s, d, f), "b1": (s, f), "w2": (s, f, d), "b2": (s, d)}

    def _specs(self) -> Dict[str, Tuple]:
        return _LM_SPECS

    def stage_params(self) -> Params:
        return dict(self.stages.named_parameters())

    def _block(self, p: Params, x: torch.Tensor) -> torch.Tensor:
        return lm_block(p, x, self.n_heads)

    def forward(self, tokens: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = self.embed[tokens] + self.pos[:tokens.shape[1]]
        stages = self.stage_params()
        for i in range(self.num_stages):
            x = self._block({k: v[i] for k, v in stages.items()}, x)
        return _layernorm(x, self.lnf_s, self.lnf_b) @ self.head

    @torch.no_grad()
    def generate(self, prompt: torch.Tensor, num_steps: int,
                 generator: Optional[torch.Generator] = None,
                 temperature: float = 0.0) -> torch.Tensor:
        """[B, T0] prompt -> [B, T0 + num_steps]: each step the full dense
        causal forward (the recompute decode); greedy at temperature 0,
        else softmax sampling from `generator`."""
        b, t0 = prompt.shape
        if t0 < 1:
            raise ValueError("generate needs a non-empty prompt (the "
                             "first step conditions on its last token)")
        total = t0 + num_steps
        if total > self.max_len:
            raise ValueError(f"prompt {t0} + steps {num_steps} exceeds "
                             f"max_len {self.max_len}")
        if temperature > 0.0 and generator is None:
            raise ValueError("sampling (temperature > 0) needs a generator")
        tokens = torch.zeros((b, total), dtype=torch.long,
                             device=self.embed.device)
        tokens[:, :t0] = prompt
        for i in range(t0, total):
            logits = self(tokens)[:, i - 1].float()
            if temperature > 0.0:
                nxt = torch.multinomial(torch.softmax(logits / temperature,
                                                      -1), 1,
                                        generator=generator)[:, 0]
            else:
                nxt = torch.argmax(logits, -1)
            tokens[:, i] = nxt
        return tokens


_MOE_SPECS = {"moe_w1": ("pp", "ep"), "moe_w2": ("pp", "ep")}


class PipelinedMoELM(PipelinedLM):
    """PipelinedLM with each stage's FFN a top-k MoE FFN (pp x ep x dp):
    stages over pp, each stage's experts over ep (`moe_lm_block`).
    `forward` is the dense computation over the same parameters (exact
    parity with the pipeline when the capacity is ample)."""

    def __init__(self, vocab: int, d_model: int = 64, n_heads: int = 4,
                 d_ff: int = 128, num_stages: int = 4, max_len: int = 128,
                 num_experts: int = 4, top_k: int = 2,
                 capacity_factor: float = 2.0, device=None):
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor = capacity_factor
        super().__init__(vocab, d_model, n_heads, d_ff, num_stages, max_len,
                         device)

    def _ffn_shapes(self) -> Dict[str, Tuple]:
        d, f, s, e = (self.d_model, self.d_ff, self.num_stages,
                      self.num_experts)
        return {"gate": (s, d, e), "moe_w1": (s, e, d, f),
                "moe_w2": (s, e, f, d)}

    def _specs(self) -> Dict[str, Tuple]:
        return _MOE_SPECS

    def _block(self, p: Params, x: torch.Tensor) -> torch.Tensor:
        return moe_lm_block(p, x, self.n_heads, k=self.top_k,
                            capacity_factor=self.capacity_factor)[0]


# -- rules and loss functions ----------------------------------------------------

def _stage_specs(axis: str, tp_axis: Optional[str]):
    if tp_axis is None:
        return None
    return {"w_qkv": (axis, None, tp_axis), "w_o": (axis, tp_axis, None),
            "w1": (axis, None, tp_axis), "b1": (axis, tp_axis),
            "w2": (axis, tp_axis, None), "b2": (axis,),
            "ln1_s": (axis,), "ln1_b": (axis,),
            "ln2_s": (axis,), "ln2_b": (axis,)}


def _moe_stage_specs(axis: str, ep_axis: Optional[str]):
    if ep_axis is None:
        return None
    base = {name: (axis,) for name in ("w_qkv", "w_o", "ln1_s", "ln1_b",
                                       "gate", "ln2_s", "ln2_b")}
    base["moe_w1"] = (axis, ep_axis)
    base["moe_w2"] = (axis, ep_axis)
    return base


def _rules_from_specs(axis: str, specs) -> ShardingRules:
    if specs is None:
        return ShardingRules([(r"(^|/)stages/", (axis,))])
    return ShardingRules(
        [(rf"(^|/)stages/{name}$", spec) for name, spec in specs.items()]
        + [(r"(^|/)stages/", (axis,))])


def pipeline_rules(axis: str = "pp",
                   tp_axis: Optional[str] = None) -> ShardingRules:
    """Sharding rules for PipelinedLM (and its optimizer slots): stage
    stacks over `axis`; with `tp_axis`, the stage matmul weights split
    Megatron-style too; embed / pos / head whole."""
    return _rules_from_specs(axis, _stage_specs(axis, tp_axis))


def pipeline_moe_rules(axis: str = "pp",
                       ep_axis: Optional[str] = "ep") -> ShardingRules:
    """Sharding rules for PipelinedMoELM: stage stacks over `axis`,
    expert stacks over `ep_axis` too."""
    return _rules_from_specs(axis, _moe_stage_specs(axis, ep_axis))


def _wide(mesh, name: Optional[str]) -> Optional[str]:
    return name if name is not None and mesh.shape.get(name, 1) > 1 \
        else None


def _check_schedule(schedule: str) -> None:
    if schedule not in ("gpipe", "1f1b"):
        raise ValueError(f"schedule must be 'gpipe' or '1f1b', "
                         f"got {schedule!r}")


def _embedded(module, tok_in, tok_out, m: int, seq, sp_size: int):
    """The microbatched embeddings and targets of this rank's sequence
    shard; embed and pos summed over the sequence shards (the streams
    sum xs's gradient over pp)."""
    b, t = tok_in.shape
    if b % m:
        raise ValueError(f"microbatch count {m} must divide batch size {b}")
    embed, pos = module.embed, module.pos
    lo, n = 0, t
    if seq is not None:
        embed, pos = C.copy_to_axis(embed, seq), C.copy_to_axis(pos, seq)
        n = t // sp_size
        lo = seq.rank * n
    h = embed[tok_in[:, lo:lo + n]] + pos[lo:lo + n]
    return _microbatch(h, m), _microbatch(tok_out[:, lo:lo + n], m)


def pipelined_moe_lm_loss(mesh, axis: str = "pp",
                          num_microbatches: Optional[int] = None,
                          ep_axis: Optional[str] = "ep",
                          lb_weight: float = 0.01, fused_ce: bool = False,
                          schedule: str = "gpipe"):
    """MeshTrainer loss_fn training PipelinedMoELM: the CE streamed on the
    last stage plus lb_weight x the Switch load-balance loss averaged
    over every (stage, microbatch); expert stacks over `ep_axis`
    (pp x ep x dp, with `pipeline_moe_rules(axis, ep_axis)`)."""
    _check_schedule(schedule)
    ep = _wide(mesh, ep_axis)

    def loss_fn(module, batch, generator, training):
        tok_in, tok_out = batch
        s = mesh.shape[axis]
        m = num_microbatches or 2 * s
        if ep is not None and module.num_experts % mesh.shape[ep]:
            raise ValueError(f"ep={mesh.shape[ep]} must divide num_experts "
                             f"({module.num_experts})")
        eg = mesh.maybe_group(ep) if ep else None
        xs, ys = _embedded(module, tok_in, tok_out, m, None, 1)

        def stage(sp_, x):
            y, lb = moe_lm_block(sp_, x, module.n_heads, ep=eg,
                                 k=module.top_k,
                                 capacity_factor=module.capacity_factor)
            return y, lb_weight * lb

        builder = (pipeline_stream_1f1b if schedule == "1f1b"
                   else pipeline_stream)
        stream = builder(stage, _lm_consume(fused_ce), mesh, axis)
        loss = stream(module.stage_params(),
                      (module.lnf_s, module.lnf_b, module.head), xs, ys)
        return loss, {}
    return loss_fn


def pipelined_lm_loss(mesh, axis: str = "pp",
                      num_microbatches: Optional[int] = None,
                      tp_axis: Optional[str] = None,
                      sp_axis: Optional[str] = None, sp_mode: str = "ring",
                      fused_ce: bool = False, schedule: str = "gpipe"):
    """MeshTrainer loss_fn training PipelinedLM through the pipeline.

    batch = (tokens_in [B, T], tokens_out [B, T]), this rank's slice over
    the trainer's batch axes; num_microbatches (default 2 S) divides it.
    The embedding runs before the pipeline, the head and cross-entropy
    on the last stage. `tp_axis`: Megatron tp inside each stage (pair
    with `pipeline_rules(axis, tp_axis)`). `sp_axis`: the sequence
    shards over it and stages run "ring" or "ulysses" attention (GPipe
    only). `fused_ce`: `linear_cross_entropy`, no [tokens, V] logits.
    `schedule`: "gpipe" or "1f1b" (same loss and gradients)."""
    _check_schedule(schedule)
    tp = _wide(mesh, tp_axis)
    sp = _wide(mesh, sp_axis)
    sp_size = mesh.shape[sp] if sp else 1
    if sp_mode not in SP_MODES:
        raise ValueError(f"sp_mode must be one of {SP_MODES}, "
                         f"got {sp_mode!r}")
    if schedule == "1f1b" and sp is not None:
        raise ValueError("schedule='1f1b' does not compose with sp yet; "
                         "use the gpipe schedule for sequence parallelism")

    def loss_fn(module, batch, generator, training):
        tok_in, tok_out = batch
        s = mesh.shape[axis]
        m = num_microbatches or 2 * s
        t = tok_in.shape[1]
        if tp is not None:
            nt = mesh.shape[tp]
            if module.n_heads % nt or module.d_ff % nt:
                raise ValueError(
                    f"tp={nt} must divide n_heads ({module.n_heads}) "
                    f"and d_ff ({module.d_ff})")
        if sp is not None and t % sp_size:
            raise ValueError(
                f"sp={sp_size} must divide sequence length {t}")
        if sp is not None and sp_mode == "ulysses":
            per_tp = module.n_heads // (mesh.shape[tp] if tp else 1)
            if per_tp % sp_size:
                raise ValueError(
                    f"ulysses sp={sp_size} must divide heads per tp "
                    f"shard ({per_tp})")
        tg = mesh.maybe_group(tp) if tp else None
        sg = mesh.maybe_group(sp) if sp else None
        xs, ys = _embedded(module, tok_in, tok_out, m, sg, sp_size)
        block = functools.partial(lm_block, n_heads=module.n_heads, tp=tg,
                                  sp=sg, sp_size=sp_size, sp_mode=sp_mode)
        if schedule == "1f1b":
            stream = pipeline_stream_1f1b(block, _lm_consume(fused_ce),
                                          mesh, axis)
        else:
            stream = pipeline_stream(block, _lm_consume(fused_ce), mesh,
                                     axis, seq_axes=(sp,) if sp else ())
        loss = stream(module.stage_params(),
                      (module.lnf_s, module.lnf_b, module.head), xs, ys)
        return loss, {}
    return loss_fn


__all__ = ["PipelinedLM", "PipelinedMoELM", "lm_block", "moe_lm_block",
           "pipeline_apply", "pipeline_loss_fn", "pipeline_moe_rules",
           "pipeline_rules", "pipeline_stream", "pipeline_stream_1f1b",
           "pipelined_lm_loss", "pipelined_moe_lm_loss", "saved_bytes",
           "stack_stage_params"]
