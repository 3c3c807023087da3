"""Recurrent layers (port of paddle_tpu/nn/rnn.py): LSTM and GRU cells
and the sequence layers that run them over padded batches.

JAX scans the time axis with `lax.scan`; here a Python loop over time
runs batched tensor ops, with nothing read back to the host between
steps. Layout: batch-major [B, T, D] in and out. The semantics are
JAX's, exactly:

- the LSTM gates split i, f, g, o, with `forget_bias` inside the
  forget gate's sigmoid; `proj_size` projects h through `wp` [H, P]
  before it recurs (the lstmp op);
- the GRU takes n = tanh(xn + r * hn), its bias on the input side only,
  and adds that float32 bias to x @ wx without a cast, so a bf16 GRU
  promotes to float32 there, as JAX's does;
- with `lengths`, a step past a row's length leaves its carry as it was
  by mixing new * m + old * (1 - m) (a blend, not a select) and zeroes
  its output;
- `reverse` runs the padded sequence backwards and masks at the
  original position, so a short row starts from its initial carry at
  position length - 1.

Weights: `wx` [D, 4H] (GRU 3H, glorot-uniform), `wh` [H or P, ...]
(orthogonal), `bias` (zeros) and the projection `wp`; the cell of an
`RNN` is its child `cell`, so the paths are JAX's (`cell/wx`).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from paddle_tpu_torch.nn import initializers as I


class LSTMCell(nn.Module):
    """LSTM cell: carry (h [B, P or H], c [B, H])."""

    def __init__(self, input_size: int, hidden: int,
                 forget_bias: float = 1.0, proj_size: int = 0,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.hidden = hidden
        self.forget_bias = forget_bias
        self.proj_size = proj_size
        self.dtype = dtype
        h_dim = proj_size or hidden
        self.wx = I.parameter(I.glorot_uniform, (input_size, 4 * hidden),
                              device)
        self.wh = I.parameter(I.orthogonal(), (h_dim, 4 * hidden), device)
        self.bias = I.parameter(I.zeros, (4 * hidden,), device)
        self.wp = (I.parameter(I.glorot_uniform, (hidden, proj_size),
                               device) if proj_size else None)

    def forward(self, carry, x: torch.Tensor):
        h, c = carry
        dt = self.dtype
        z = (x.to(dt) @ self.wx.to(dt) + h.to(dt) @ self.wh.to(dt)
             + self.bias.to(dt))
        i, f, g, o = torch.chunk(z, 4, dim=-1)
        new_c = (torch.sigmoid(f + self.forget_bias) * c
                 + torch.sigmoid(i) * torch.tanh(g))
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        if self.wp is not None:
            new_h = new_h @ self.wp.to(new_h.dtype)
        return (new_h, new_c), new_h

    def init_carry(self, batch: int, device=None):
        dev = device if device is not None else self.wx.device
        h = torch.zeros((batch, self.proj_size or self.hidden),
                        dtype=self.dtype, device=dev)
        return (h, torch.zeros((batch, self.hidden), dtype=self.dtype,
                               device=dev))


class GRUCell(nn.Module):
    """GRU cell: carry h [B, H]."""

    def __init__(self, input_size: int, hidden: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.hidden = hidden
        self.dtype = dtype
        self.wx = I.parameter(I.glorot_uniform, (input_size, 3 * hidden),
                              device)
        self.wh = I.parameter(I.orthogonal(), (hidden, 3 * hidden), device)
        self.bias = I.parameter(I.zeros, (3 * hidden,), device)

    def forward(self, carry, x: torch.Tensor):
        h = carry
        dt = self.dtype
        xz = x.to(dt) @ self.wx.to(dt) + self.bias
        hz = h.to(dt) @ self.wh.to(dt)
        xr, xu, xn = torch.chunk(xz, 3, dim=-1)
        hr, hu, hn = torch.chunk(hz, 3, dim=-1)
        r = torch.sigmoid(xr + hr)
        u = torch.sigmoid(xu + hu)
        n = torch.tanh(xn + r * hn)
        new_h = (1 - u) * n + u * h
        return new_h, new_h

    def init_carry(self, batch: int, device=None):
        dev = device if device is not None else self.wx.device
        return torch.zeros((batch, self.hidden), dtype=self.dtype,
                           device=dev)


def _mix(new, old, m):
    if isinstance(new, tuple):
        return tuple(_mix(a, b, m) for a, b in zip(new, old))
    return new * m + old * (1 - m)


def scan_cell(cell: nn.Module, x_bt: torch.Tensor, carry,
              lengths: Optional[torch.Tensor] = None,
              reverse: bool = False):
    """Run `cell` over x [B, T, D] from `carry`: (final carry, outputs
    [B, T, out]). With `lengths`, a row stops at its length (its carry
    kept, its outputs 0); `reverse` walks positions T - 1 down to 0."""
    t_total = x_bt.shape[1]
    if lengths is not None:
        lengths = torch.as_tensor(lengths, device=x_bt.device)
    ys = [None] * t_total
    order = range(t_total - 1, -1, -1) if reverse else range(t_total)
    for p in order:
        new_carry, y = cell(carry, x_bt[:, p])
        if lengths is not None:
            alive = (lengths > p)[:, None].to(y.dtype)
            new_carry = _mix(new_carry, carry, alive)
            y = y * alive
        carry = new_carry
        ys[p] = y
    return carry, torch.stack(ys, dim=1)


class RNN(nn.Module):
    """One direction of a recurrent layer over a padded batch: forward
    (x [B, T, D], lengths, initial_carry) -> (outputs [B, T, H], final
    carry)."""

    def __init__(self, cell: nn.Module, reverse: bool = False):
        super().__init__()
        self.cell = cell
        self.reverse = reverse

    def forward(self, x: torch.Tensor, lengths=None, initial_carry=None):
        carry = (initial_carry if initial_carry is not None
                 else self.cell.init_carry(x.shape[0], x.device))
        final, ys = scan_cell(self.cell, x, carry, lengths, self.reverse)
        return ys, final


class BiRNN(nn.Module):
    """A forward and a reversed RNN over the same input, outputs
    concatenated on the last axis; the carries as (fwd, bwd)."""

    def __init__(self, fwd_cell: nn.Module, bwd_cell: nn.Module):
        super().__init__()
        self.fwd = RNN(fwd_cell)
        self.bwd = RNN(bwd_cell, reverse=True)

    def forward(self, x: torch.Tensor, lengths=None):
        yf, cf = self.fwd(x, lengths)
        yb, cb = self.bwd(x, lengths)
        return torch.cat([yf, yb], dim=-1), (cf, cb)


class StackedLSTM(nn.Module):
    """`layers` LSTMs, each over the previous one's outputs; returns the
    last layer's outputs and final carry."""

    def __init__(self, input_size: int, hidden: int, layers: int = 2,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.rnns = nn.ModuleList(
            RNN(LSTMCell(input_size if i == 0 else hidden, hidden,
                         dtype=dtype, device=device))
            for i in range(layers))

    def forward(self, x: torch.Tensor, lengths=None):
        final = None
        for rnn in self.rnns:
            x, final = rnn(x, lengths)
        return x, final
