"""Self-speculative n-gram drafter (no second model); a copy of
``repro.serving.drafter``.

Speculative decoding needs cheap draft tokens; a second "draft model"
doubles the deployment surface (two param sets, two tuning scenarios, two
failure domains). The self-speculative alternative used here proposes
continuations from the sequence's *own* history: an n-gram suffix-match
table over ``prompt + tokens`` (prompt-lookup decoding, as in vLLM's
ngram speculator). LLM output is locally repetitive — code, JSON,
boilerplate, and the repetition loops of greedy sampling — so a suffix
that occurred before is a strong predictor of what follows it.

The drafter is pure host-side state (no torch): the engine feeds it the
committed token stream (``observe``) and asks for K-1 draft tokens
(``propose``). Rejected drafts never enter the stream, so observation is
append-only even though the engine rolls back KV positions.

Correctness never depends on draft quality: the verify kernel scores
drafts against the real model and the scheduler commits only the matched
prefix (plus the model's own next token), so a cold or adversarial
drafter degrades throughput, not output.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple


class NgramDrafter:
    """Suffix-match table over one sequence's token stream.

    For every position ``i`` and order ``n`` in [min_n, max_n], the n-gram
    ``stream[i-n:i]`` maps to ``stream[i]`` — last occurrence wins, so the
    table tracks the *most recent* continuation of each context. Proposing
    walks orders longest-first (the longest matching suffix is the most
    specific predictor) and extends speculatively: accepted proposals join
    the lookup context so one call drafts a whole K-token run.
    """

    def __init__(self, min_n: int = 1, max_n: int = 4):
        assert 1 <= min_n <= max_n
        self.min_n = int(min_n)
        self.max_n = int(max_n)
        self._table: Dict[Tuple[int, ...], int] = {}
        self._stream: List[int] = []

    @property
    def observed(self) -> int:
        return len(self._stream)

    def observe(self, stream: Sequence[int]) -> None:
        """Ingest the committed stream (prompt + tokens). Must be an
        append-only extension of what was previously observed — the
        engine only ever commits accepted tokens, so rollback never
        shrinks it."""
        n_seen = len(self._stream)
        assert len(stream) >= n_seen, "stream must grow append-only"
        for i in range(n_seen, len(stream)):
            tok = int(stream[i])
            self._stream.append(tok)
            for n in range(self.min_n, self.max_n + 1):
                if i >= n:
                    key = tuple(self._stream[i - n:i])
                    self._table[key] = tok

    def _lookup(self, ctx: List[int]) -> Optional[int]:
        for n in range(self.max_n, self.min_n - 1, -1):
            if len(ctx) < n:
                continue
            tok = self._table.get(tuple(ctx[-n:]))
            if tok is not None:
                return tok
        return None

    def propose(self, k: int) -> List[int]:
        """Draft ``k`` continuation tokens for the observed stream. Always
        returns exactly ``k`` tokens (fixed verify shapes downstream): misses
        fall back to repeating the last token — a cheap guess that greedy
        repetition loops frequently reward, and a harmless one when wrong
        (the verifier rejects it at zero correctness cost)."""
        ctx = list(self._stream)
        fallback = ctx[-1] if ctx else 0
        out: List[int] = []
        for _ in range(max(0, k)):
            tok = self._lookup(ctx)
            if tok is None:
                tok = fallback
            out.append(tok)
            ctx.append(tok)
            fallback = tok
        return out
