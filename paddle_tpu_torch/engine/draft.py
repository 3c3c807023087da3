"""Self-speculative drafting: prompt-lookup / n-gram proposal (port of
paddle_tpu/engine/draft.py; pure Python, the port's own copy).

Decode is memory-bound — every step streams the whole KV working set
to emit ONE token per sequence — so the ragged step has compute to
spare. Speculative decoding spends that headroom: propose k tokens
cheaply, verify all k in one batched step (the same multi-token
StepRow shape a prefill chunk uses), and emit every accepted token.
The net is fewer steps per token at EXACTLY the same output
(engine.py's verification accepts a draft token only when it equals
the token the target distribution would have sampled anyway).

This drafter is MODEL-FREE (no second network, no extra weights on the
card): it proposes by PROMPT LOOKUP — find the most recent earlier
occurrence of the sequence's own trailing n-gram and propose the
tokens that followed it. When history never repeats, the drafter
proposes nothing and the engine plans a plain one-token decode row —
speculation can make a step emit more, never make output different.

Pure host code on Python lists: drafting launches nothing on the card.
"""

from __future__ import annotations

from typing import List, Optional, Sequence


class NgramDrafter:
    """Prompt-lookup drafter: longest-match-first over the request's
    own token history.

    `propose(tokens)` scans for PRIOR occurrences of the history's
    trailing n-gram, trying n = max_ngram down to min_ngram, and returns
    up to `k` tokens that followed the chosen occurrence. Among
    occurrences of the same n, the most recent one with a FULL k-token
    continuation wins; a match flush against the tail only has the
    tail's leftovers to offer (a constant run would draft a single
    token forever), so matches whose continuation is cut short by the
    end of history defer to earlier ones that can fill the window. When
    no occurrence has a full window, the longest available continuation
    wins (most recent on ties). Deterministic throughout.

    Returns [] when nothing matches; the scheduler then plans a plain
    1-token decode row.
    """

    def __init__(self, k: int = 4, max_ngram: int = 3,
                 min_ngram: int = 1):
        if k < 1:
            raise ValueError(f"k {k} < 1")
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(
                f"need 1 <= min_ngram ({min_ngram}) <= max_ngram "
                f"({max_ngram})")
        self.k = k
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def propose(self, tokens: Sequence[int],
                max_tokens: Optional[int] = None) -> List[int]:
        """Draft up to min(k, max_tokens) continuation tokens for a
        sequence whose full history (prompt + generated) is `tokens`."""
        cap = self.k if max_tokens is None else min(self.k, max_tokens)
        n_hist = len(tokens)
        if cap < 1 or n_hist < self.min_ngram + 1:
            return []
        for n in range(min(self.max_ngram, n_hist - 1),
                       self.min_ngram - 1, -1):
            pattern = tuple(tokens[n_hist - n:])
            best: List[int] = []
            # most recent PRIOR occurrence with a full cap-token
            # continuation; the match must end before the history's
            # tail so at least one continuation token exists
            for i in range(n_hist - n - 1, -1, -1):
                if tuple(tokens[i:i + n]) == pattern:
                    cont = list(tokens[i + n:i + n + cap])
                    if len(cont) == cap:
                        return cont
                    if len(cont) > len(best):
                        best = cont
            if best:
                return best
        return []
