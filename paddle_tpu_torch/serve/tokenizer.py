"""Seed-deterministic byte-level tokenizer for the serve front door (port
of paddle_tpu/serve/tokenizer.py, a copy: the same (vocab, seed) gives
the same ids in either package).

The serving API has always taken raw token id lists — fine for
benchmarks, hostile to clients (ROADMAP "async front door"). This
module closes that gap WITHOUT shipping a vocab artifact: the mapping
is derived entirely from (vocab_size, seed), so every replica built
with the same model dims and init seed tokenizes identically — the
same property the fleet already leans on for weights (the same export,
or the same --init-seed, on every replica => byte-identical greedy
decode).

Scheme: each UTF-8 byte becomes exactly TWO token ids — the high and
low nibble, each looked up in its own 16-entry alphabet drawn from a
seeded permutation of the model vocab. Fixed width makes the encoding
trivially injective (decode inverts pair by pair), nibble alphabets
keep it usable down to tiny test vocabs (needs vocab >= 16, the
replica default is 61), and the permutation spreads prompt mass over
the vocab so a text prompt exercises the same embedding rows a random
token benchmark does.

This is deliberately NOT a learned tokenizer — it is the smallest
deterministic front door that lets `{"prompt": "some text"}` hit
`/v1/completions` and round-trip through `/v1/tokenize`; a real BPE
vocab can replace the byte mapping behind the same encode/decode
surface later.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


class ByteTokenizer:
    """`ByteTokenizer(vocab, seed).encode(text)` -> token ids (2 per
    UTF-8 byte); `decode(ids)` inverts it. Same (vocab, seed) =>
    identical mapping in every process."""

    def __init__(self, vocab: int, seed: int = 0):
        if vocab < 16:
            raise ValueError(
                f"vocab {vocab} < 16: the byte tokenizer needs 16 "
                "distinct ids per nibble alphabet")
        self.vocab = int(vocab)
        self.seed = int(seed)
        rs = np.random.RandomState(self.seed)
        # two sequential draws from ONE seeded stream: distinct
        # alphabets, still fully determined by (vocab, seed)
        self._hi = [int(t) for t in rs.permutation(self.vocab)[:16]]
        self._lo = [int(t) for t in rs.permutation(self.vocab)[:16]]
        self._hi_inv = {t: i for i, t in enumerate(self._hi)}
        self._lo_inv = {t: i for i, t in enumerate(self._lo)}

    def encode(self, text: str) -> List[int]:
        out: List[int] = []
        for b in text.encode("utf-8"):
            out.append(self._hi[b >> 4])
            out.append(self._lo[b & 0xF])
        return out

    def decode(self, tokens: Sequence[int]) -> str:
        """Invert encode(). Raises ValueError on ids outside the
        alphabets or an odd-length sequence (generated tokens are NOT
        generally decodable — only encode() output round-trips)."""
        if len(tokens) % 2:
            raise ValueError(
                f"token count {len(tokens)} is odd: byte encoding is "
                "2 tokens per byte")
        data = bytearray()
        for i in range(0, len(tokens), 2):
            hi = self._hi_inv.get(int(tokens[i]))
            lo = self._lo_inv.get(int(tokens[i + 1]))
            if hi is None or lo is None:
                raise ValueError(
                    f"token pair ({tokens[i]}, {tokens[i + 1]}) at "
                    f"position {i} is not in the byte alphabets")
            data.append((hi << 4) | lo)
        return data.decode("utf-8")
