"""Expert parallelism: a mixture-of-experts FFN sharded over the mesh's
"ep" axis (port of paddle_tpu/parallel/moe.py).

Two dispatch strategies over the same routed-FFN semantics, as JAX's:

- `moe_ffn`, masked dispatch: every rank runs its local experts over the
  whole token set with non-routed tokens zeroed, and one all-reduce over
  ep combines. Exact (no drops), at E x the dense FFN's FLOPs.
- `moe_ffn_a2a`, GShard / Switch all_to_all dispatch: tokens are sharded
  over ep; each rank packs its tokens into capacity-bounded [E, C, D]
  buffers, one all_to_all ships them to the experts' owners, experts run
  on their own tokens, and the reverse all_to_all brings the outputs
  home. Tokens routed past capacity are dropped (contribute zero).
- `moe_ffn_local`, for callers already running one rank of the axis (a
  pipeline stage) with activations replicated over it: each rank packs
  only its own experts' slots and one all-reduce combines.

Every rank of the axis calls these in the same order with its own
expert slices (`w1` / `w2` [E/n, ...]; `moe_partition_specs`) and the
whole `gate`. Top-k routing (k=1 Switch, k=2 GShard) weights the expert
OUTPUT by the router probability, so the masked and a2a paths agree
exactly with ample capacity.

The bookkeeping matches JAX's bit for bit: top-k ties go to the lower
expert index (a stable sort; `lax.top_k`'s rule, which `torch.topk`
does not promise), capacity slots come from a cumsum in token-major,
k-minor order, rows at or past capacity are dropped from the scatter,
and the combine gathers a dropped slot clamped to slot C - 1 and
multiplies it by 0, as JAX's clamped gather does. A token's k slot
outputs are summed in slot order (a [T, k, D] sum, not atomics).

Gradients follow the Megatron rule at the expert region's entry and
exit: the region's inputs (the tokens and their routing weights) go
through `copy_to_axis` (their gradient summed over the ranks' experts),
its output through `reduce_from_axis`. The router probabilities given
back in `aux` (for `load_balancing_loss`) stay outside the region, so
the balance loss's gradient is counted once. Under `moe_ffn_a2a` the
gate's gradient is this rank's tokens' share (tokens are sharded like a
batch); the caller sums or averages it over the axis as its loss does.
Experts are plain `torch.matmul` products, as JAX computes them outside
any Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from paddle_tpu_torch.parallel import collective as C


def init_moe_params(num_experts: int, d_model: int, d_hidden: int,
                    generator: Optional[torch.Generator] = None,
                    dtype=torch.float32, device=None
                    ) -> Dict[str, torch.Tensor]:
    """Stacked expert weights (leading dim = experts; shard over "ep"),
    normal draws at JAX's scales (the bits differ from JAX's PRNG)."""
    s1 = (2.0 / d_model) ** 0.5
    s2 = (2.0 / d_hidden) ** 0.5

    def normal(shape, scale):
        return (torch.randn(shape, generator=generator) * scale).to(
            dtype=dtype, device=device)
    return {"gate": normal((d_model, num_experts), s1),
            "w1": normal((num_experts, d_model, d_hidden), s1),
            "w2": normal((num_experts, d_hidden, d_model), s2)}


def moe_partition_specs() -> Dict[str, Tuple]:
    """The specs of init_moe_params' leaves (experts over "ep")."""
    return {"gate": (), "w1": ("ep", None, None), "w2": ("ep", None, None)}


def _expert_ffn(w1, w2, x):
    """relu(x @ w1) @ w2, batched over the leading expert dim."""
    return torch.relu(x @ w1) @ w2


def _top_k(probs: torch.Tensor, k: int):
    """`lax.top_k`: the k largest, ties to the lower index."""
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    return top_p[:, :k], top_i[:, :k]


def _route(gate, x, k: int):
    """Router: (probs [T, E] f32, top_p [T, k], top_i [T, k], sel [T, E]
    {0, 1} chosen-mask, wgt [T, E] prob-if-chosen-else-0)."""
    e = gate.shape[-1]
    logits = x @ gate.to(x.dtype)
    probs = torch.softmax(logits.float(), dim=-1)
    top_p, top_i = _top_k(probs, k)
    onehots = torch.nn.functional.one_hot(top_i, e).to(probs.dtype)
    sel = onehots.sum(1)
    wgt = torch.einsum("tke,tk->te", onehots, top_p)
    return probs, top_p, top_i, sel, wgt


def moe_ffn(params: Dict[str, torch.Tensor], x: torch.Tensor, mesh=None,
            axis: str = "ep", k: int = 1
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Top-k MoE FFN, masked dispatch. x [tokens, D] (whole on every
    rank) -> (y [tokens, D], aux). aux carries `router_probs` [tokens, E]
    and `expert_index` [tokens] (top-1). With a mesh whose `axis` spans
    ranks, `params["w1"]` / `["w2"]` are this rank's experts and one
    all-reduce combines; without, every expert runs here. Exact."""
    probs, _, top_i, sel, wgt = _route(params["gate"], x, k)
    sel, wgt = sel.to(x.dtype), wgt.to(x.dtype)
    group = mesh.maybe_group(axis) if mesh is not None else None
    w1, w2 = params["w1"].to(x.dtype), params["w2"].to(x.dtype)
    first = 0
    xin = x
    if group is not None:
        first = group.rank * w1.shape[0]
        xin, wgt = C.copy_to_axis(x, group), C.copy_to_axis(wgt, group)
    y = torch.zeros_like(x)
    for j in range(w1.shape[0]):
        e = first + j
        y = y + wgt[:, e, None] * _expert_ffn(w1[j], w2[j],
                                              xin * sel[:, e, None])
    if group is not None:
        y = C.reduce_from_axis(y, group)
    return y, {"router_probs": probs, "expert_index": top_i[:, 0]}


def _route_slots(gate, x, k: int, cap: int):
    """Capacity-dispatch bookkeeping shared by the a2a and local paths:
    (probs [T, E], top_i [T, k], flat_e [T k], flat_p [T k], tok [T k]
    slot -> token row, pos [T k] position within its expert, keep [T k])."""
    e = gate.shape[-1]
    t = x.shape[0]
    probs, top_p, top_i, _, _ = _route(gate, x, k)
    flat_e = top_i.reshape(-1)
    flat_p = top_p.reshape(-1).to(x.dtype)
    tok = torch.arange(t, device=x.device).repeat_interleave(k)
    onehot = torch.nn.functional.one_hot(flat_e, e)
    pos = (torch.cumsum(onehot, 0) * onehot).sum(-1) - 1
    return probs, top_i, flat_e, flat_p, tok, pos, pos < cap


def _pack(x_tok, rows, pos_c, n_rows: int, cap: int):
    """[n_rows, cap, D] buffer with slot (rows[i], pos_c[i]) = x_tok[i];
    slots at pos_c == cap are dropped (JAX's scatter mode="drop")."""
    buf = x_tok.new_zeros((n_rows, cap + 1, x_tok.shape[-1]))
    buf = buf.index_put((rows, pos_c), x_tok)
    return buf[:, :cap]


def _combine(out_buf, rows, pos_c, weight, t: int, k: int):
    """Each slot's expert output (a dropped slot clamped to cap - 1, as
    JAX's gather clamps) times its weight, summed over a token's k slots
    in slot order."""
    cap = out_buf.shape[1]
    slot = out_buf[rows, pos_c.clamp_max(cap - 1)] * weight[:, None]
    return slot.view(t, k, -1).sum(1)


def moe_ffn_a2a(params: Dict[str, torch.Tensor], x: torch.Tensor, mesh,
                axis: str = "ep", k: int = 2, capacity_factor: float = 1.25
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Top-k MoE FFN, all_to_all token dispatch. x: this rank's
    [T/n, D] token shard; `params["w1"]` / `["w2"]` this rank's E/n
    experts. Per rank and expert the capacity is C = ceil(T/n k / E cf);
    tokens past it are DROPPED (`dropped_fraction` in aux, the mean over
    the axis). Returns (this rank's y shard, aux with this rank's
    router_probs and expert_index, dropped_fraction and capacity)."""
    group = mesh.maybe_group(axis)
    n = mesh.shape[axis]
    e = params["w1"].shape[0] * n
    t_l = x.shape[0]
    cap = max(1, math.ceil(t_l * k / e * capacity_factor))
    probs, top_i, flat_e, flat_p, tok, pos, keep = _route_slots(
        params["gate"], x, k, cap)
    pos_c = torch.where(keep, pos, cap)
    buf = _pack(x[tok], flat_e, pos_c, e, cap)                  # [E, C, D]
    # ship tokens to the experts' owners: [E, C, D] -> [E/n, n C, D]
    recv = C.all_to_all(buf, group, 0, 1) if group is not None else buf
    h = _expert_ffn(params["w1"].to(x.dtype), params["w2"].to(x.dtype),
                    recv)
    out_buf = C.all_to_all(h, group, 1, 0) if group is not None else h
    y = _combine(out_buf, flat_e, pos_c, flat_p * keep, t_l, k)
    dropped = torch.mean(1.0 - keep.float())
    if group is not None:
        dropped = C.all_reduce(dropped.detach(), group, "mean")
    return y, {"router_probs": probs, "expert_index": top_i[:, 0],
               "dropped_fraction": dropped,
               "capacity": torch.tensor(cap)}


def moe_ffn_local(params: Dict[str, torch.Tensor], x: torch.Tensor,
                  axis: Optional[C.AxisGroup] = None, k: int = 2,
                  capacity_factor: float = 1.25
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Top-k MoE FFN for callers already running one rank of `axis` (a
    pipeline stage): `params["w1"]` / `["w2"]` are the rank's expert
    slices (whole stacks when axis is None), `params["gate"]` is whole
    [D, E], and x [T, D] is replicated over the axis. Every rank routes
    identically and packs capacity-bounded buffers for its own experts;
    one all-reduce combines. Returns (y [T, D], aux with router_probs,
    expert_index, dropped_fraction and load_balance, the Switch loss)."""
    e_local = params["w1"].shape[0]
    e = params["gate"].shape[-1]
    t = x.shape[0]
    cap = max(1, math.ceil(t * k / e * capacity_factor))
    probs, top_i, flat_e, flat_p, tok, pos, keep = _route_slots(
        params["gate"], x, k, cap)
    first = axis.rank * e_local if axis is not None else 0
    mine = (flat_e >= first) & (flat_e < first + e_local)
    le = (flat_e - first).clamp(0, e_local - 1)
    pos_c = torch.where(keep & mine, pos, cap)
    xin = x
    if axis is not None:
        xin, flat_p = C.copy_to_axis(x, axis), C.copy_to_axis(flat_p, axis)
    buf = _pack(xin[tok], le, pos_c, e_local, cap)
    h = _expert_ffn(params["w1"].to(x.dtype), params["w2"].to(x.dtype), buf)
    y = _combine(h, le, pos_c, flat_p * (keep & mine), t, k)
    if axis is not None:
        y = C.reduce_from_axis(y, axis)
    aux = {"router_probs": probs, "expert_index": top_i[:, 0],
           "dropped_fraction": torch.mean(1.0 - keep.float())}
    aux["load_balance"] = load_balancing_loss(aux)
    return y, aux


def load_balancing_loss(aux: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The Switch auxiliary loss E * sum_e f_e P_e (f_e the share of
    tokens routed to e, P_e its mean router probability); 1 at uniform
    routing."""
    probs = aux["router_probs"]
    e = probs.shape[-1]
    f = torch.nn.functional.one_hot(aux["expert_index"].long(), e).to(
        probs.dtype).mean(0)
    return e * torch.sum(f * probs.mean(0))


__all__ = ["init_moe_params", "load_balancing_loss", "moe_ffn",
           "moe_ffn_a2a", "moe_ffn_local", "moe_partition_specs"]
