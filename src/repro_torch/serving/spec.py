"""Draft-then-verify speculative decoding: the drafter side (port of
``repro/serving/spec.py``; pure host code).

A **drafter** proposes k tokens per slot from the slot's own history;
one verify step (``training/steps.build_verify_step_slots[_paged]``)
scores all k+1 positions against the pool's KV at once, and the
scheduler accepts the longest prefix of drafts that matches what the
per-``(rid, step)`` sampler draws sequentially — so speculative streams
equal non-speculative ones, and a verify step that accepts a drafts
advances the request by a+1 tokens for one model call.

``NGramDrafter`` predicts by longest-suffix n-gram lookup over the
request's prompt + generated tokens.  Any object with
``draft(history, k) -> list[int]`` plugs into ``Scheduler(drafter=...)``
/ ``ServeEngine(drafter=...)``; a wrong draft costs only its rejected KV
write, which the next step overwrites before any causal mask admits it.
"""

from __future__ import annotations


class Drafter:
    """Protocol: propose k tokens likely to follow ``history``.

    ``history`` is the request's full token prefix — prompt plus every
    emitted token, including the pending one not yet in KV — and the
    return value is exactly ``k`` proposed continuation tokens.  Drafts
    never affect correctness (a mismatch just ends the accepted burst),
    only the accepted-tokens/verify-step ratio.
    """

    def draft(self, history: list[int], k: int) -> list[int]:
        raise NotImplementedError


class NGramDrafter(Drafter):
    """Longest-suffix n-gram drafter over the request's own history.

    For each proposed token: take the history's last-n suffix for
    n = max_n..1, find that n-gram's most recent earlier occurrence, and
    propose the token that followed it; if no suffix recurs, repeat the
    last token.  The proposal is appended to a working copy of the
    history, so one call drafts a k-token continuation.
    """

    def __init__(self, max_n: int = 3):
        if max_n < 1:
            raise ValueError(f"max_n {max_n} < 1")
        self.max_n = max_n
        self.calls = 0                # draft() invocations
        self.drafted_tokens = 0       # k summed over calls
        self.ngram_hits = 0           # proposals from a recurring suffix
        self.fallbacks = 0            # proposals from repeat-last

    def _next(self, hist: list[int]) -> int:
        L = len(hist)
        for n in range(min(self.max_n, L - 1), 0, -1):
            suffix = hist[L - n:]
            # most recent earlier occurrence of the suffix n-gram
            for p in range(L - n - 1, -1, -1):
                if hist[p:p + n] == suffix:
                    self.ngram_hits += 1
                    return hist[p + n]
        self.fallbacks += 1
        return hist[-1]

    def draft(self, history: list[int], k: int) -> list[int]:
        self.calls += 1
        self.drafted_tokens += k
        hist = [int(t) for t in history]
        if not hist:
            return [0] * k
        out = []
        for _ in range(k):
            t = self._next(hist)
            out.append(t)
            hist.append(t)
        return out
