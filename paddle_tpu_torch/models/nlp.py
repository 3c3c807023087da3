"""The NLP and recommendation model zoo (port of
paddle_tpu/models/nlp.py): `Word2Vec`, `TextClassifier` (the stacked-
LSTM classifier), `Seq2Seq` (a GRU encoder and an additive-attention
GRU decoder), `DeepFM` and `Recommender`.

Module names are JAX's (`lstm.rnns.0.cell.wx` is JAX's
`lstm/rnns_0/cell/wx`), so `load_jax_params` copies a JAX tree; each
Linear and cell takes its input width, which JAX infers. JAX's
`lax.scan` over the decoder's target steps is a Python loop of batched
ops here. Models default to the CUDA card and start in eval mode.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from paddle_tpu_torch.device import DeviceLike, resolve_device
from paddle_tpu_torch.nn.layers import Embedding, Linear
from paddle_tpu_torch.nn.rnn import GRUCell, RNN, StackedLSTM
from paddle_tpu_torch.ops import functional as F
from paddle_tpu_torch.ops.sequence import sequence_mask, sequence_pool


class Word2Vec(nn.Module):
    """N-gram LM: `context` shared embeddings concatenated, a ReLU
    Linear, then vocab logits."""

    def __init__(self, vocab: int, embed_dim: int = 32, hidden: int = 256,
                 context: int = 4, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.device = device
        self.context = context
        self.embed = Embedding(vocab, embed_dim, device=device)
        self.fc = Linear(context * embed_dim, hidden, device=device)
        self.head = Linear(hidden, vocab, device=device)
        self.eval()

    def forward(self, context_tokens: torch.Tensor) -> torch.Tensor:
        """context_tokens [B, context] -> logits [B, V]."""
        e = self.embed(context_tokens)
        h = F.relu(self.fc(e.reshape(e.shape[0], -1)))
        return self.head(h)


class TextClassifier(nn.Module):
    """Stacked-LSTM text classifier: embedding, `layers` LSTMs, a pool
    over time (max without lengths; `pool` of `sequence_pool` with
    them) and the head."""

    def __init__(self, vocab: int, embed_dim: int = 128, hidden: int = 512,
                 layers: int = 2, num_classes: int = 2, pool: str = "max",
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.device = device
        self.pool = pool
        self.embed = Embedding(vocab, embed_dim, device=device)
        self.lstm = StackedLSTM(embed_dim, hidden, layers=layers,
                                device=device)
        self.head = Linear(hidden, num_classes, device=device)
        self.eval()

    def forward(self, tokens: torch.Tensor, lengths=None) -> torch.Tensor:
        y, _ = self.lstm(self.embed(tokens), lengths)
        if lengths is not None:
            pooled = sequence_pool(y, lengths, self.pool)
        else:
            pooled = torch.amax(y, dim=1)
        return self.head(pooled)


class Seq2Seq(nn.Module):
    """GRU encoder-decoder with additive attention, teacher-forced:
    forward(src [B, Ts], trg [B, Tt], src_lengths) -> logits [B, Tt, V].
    Each decoder step attends over the encoder outputs (score v' tanh(Wq
    h + Wk m), padding at -1e9) and feeds [embedding, context] to the
    cell."""

    def __init__(self, src_vocab: int, trg_vocab: int, embed_dim: int = 128,
                 hidden: int = 256, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.device = device
        self.hidden = hidden
        self.src_embed = Embedding(src_vocab, embed_dim, device=device)
        self.trg_embed = Embedding(trg_vocab, embed_dim, device=device)
        self.encoder = RNN(GRUCell(embed_dim, hidden, device=device))
        self.dec_cell = GRUCell(embed_dim + hidden, hidden, device=device)
        self.attn_q = Linear(hidden, hidden, use_bias=False, device=device)
        self.attn_k = Linear(hidden, hidden, use_bias=False, device=device)
        self.attn_v = Linear(hidden, 1, use_bias=False, device=device)
        self.head = Linear(hidden, trg_vocab, device=device)
        self.eval()

    def _attend(self, h, memory, keys, src_maskf):
        q = self.attn_q(h)[:, None, :]
        score = self.attn_v(torch.tanh(q + keys))[..., 0]
        score = torch.where(src_maskf > 0, score,
                            torch.full_like(score, -1e9))
        w = F.softmax(score, axis=-1)
        return torch.einsum("bt,btd->bd", w, memory)

    def forward(self, src_tokens: torch.Tensor, trg_tokens: torch.Tensor,
                src_lengths=None) -> torch.Tensor:
        memory, h = self.encoder(self.src_embed(src_tokens), src_lengths)
        ts = src_tokens.shape[1]
        maskf = (sequence_mask(torch.as_tensor(src_lengths,
                                               device=memory.device),
                               ts, torch.float32)
                 if src_lengths is not None
                 else torch.ones(src_tokens.shape, device=memory.device))
        keys = self.attn_k(memory)
        emb = self.trg_embed(trg_tokens)
        ys = []
        for t in range(emb.shape[1]):
            ctx_vec = self._attend(h, memory, keys, maskf)
            h, y = self.dec_cell(h, torch.cat([emb[:, t], ctx_vec], dim=-1))
            ys.append(y)
        return self.head(torch.stack(ys, dim=1))


class DeepFM(nn.Module):
    """DeepFM CTR model: per-field ids into one flat table (field
    offsets) plus a dense-feature embedding; first-order weights, the FM
    second-order term 0.5 ((sum v)^2 - sum v^2) and a deep ReLU tower,
    summed into a logit [B]. `embedding_cls(num, dim, device=...,
    **embed_kw)` builds both tables (default `Embedding`)."""

    def __init__(self, num_fields: int, vocab_per_field: int,
                 dense_dim: int, embed_dim: int = 16,
                 mlp_dims: Sequence[int] = (400, 400, 400),
                 embedding_cls=None, device: DeviceLike = None,
                 **embed_kw):
        super().__init__()
        device = resolve_device(device)
        self.device = device
        self.num_fields = num_fields
        self.vocab_per_field = vocab_per_field
        cls = embedding_cls or Embedding
        rows = num_fields * vocab_per_field
        self.table = cls(rows, embed_dim, device=device, **embed_kw)
        self.w1 = cls(rows, 1, device=device, **embed_kw)
        self.dense_fc = Linear(dense_dim, embed_dim, device=device)
        widths = [(num_fields + 1) * embed_dim, *mlp_dims]
        self.mlp = nn.ModuleList(Linear(a, b, device=device)
                                 for a, b in zip(widths, widths[1:]))
        self.out = Linear(widths[-1], 1, device=device)
        self.eval()

    def forward(self, dense: torch.Tensor,
                sparse_ids: torch.Tensor) -> torch.Tensor:
        """dense [B, Dd], sparse_ids [B, F] -> logit [B]."""
        offsets = (torch.arange(self.num_fields, device=sparse_ids.device)
                   * self.vocab_per_field)[None]
        flat_ids = sparse_ids + offsets
        emb = self.table(flat_ids)
        all_emb = torch.cat([emb, self.dense_fc(dense)[:, None, :]], dim=1)
        s = torch.sum(all_emb, dim=1)
        fm = 0.5 * torch.sum(s.square() - torch.sum(all_emb.square(), dim=1),
                             dim=-1)
        first = torch.sum(self.w1(flat_ids)[..., 0], dim=-1)
        h = all_emb.reshape(all_emb.shape[0], -1)
        for fc in self.mlp:
            h = F.relu(fc(h))
        return first + fm + self.out(h)[:, 0]


class Recommender(nn.Module):
    """Dual-tower recommender: tanh Linears over user and item
    embeddings, scored by cosine similarity x 5."""

    def __init__(self, num_users: int, num_items: int, embed_dim: int = 32,
                 hidden: int = 64, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.device = device
        self.user_embed = Embedding(num_users, embed_dim, device=device)
        self.item_embed = Embedding(num_items, embed_dim, device=device)
        self.user_fc = Linear(embed_dim, hidden, device=device)
        self.item_fc = Linear(embed_dim, hidden, device=device)
        self.eval()

    def forward(self, user_ids: torch.Tensor,
                item_ids: torch.Tensor) -> torch.Tensor:
        u = torch.tanh(self.user_fc(self.user_embed(user_ids)))
        i = torch.tanh(self.item_fc(self.item_embed(item_ids)))
        return F.cos_sim(u, i) * 5.0
