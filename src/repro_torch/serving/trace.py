"""Synthetic request traces (port of ``zipf_trace`` and
``repetitive_trace`` from ``repro/serving/trace.py``).

Real serving traffic is heavy-tailed: many short exchanges, a few long
generations.  ``zipf_trace`` draws both the prompt and the generation
lengths from a clipped Zipf law; prompt lengths are bucketed to powers
of two; ``repetitive_trace`` is the speculative-decoding probe's.  The
draws come from ``np.random.RandomState(seed)`` in the
reference's order, so both packages build the same requests.
"""

from __future__ import annotations

import numpy as np

from repro_torch.serving.scheduler import Request

PROMPT_BUCKETS = (4, 8, 16, 32, 64, 128)


def _bucket(n: int, max_prompt: int) -> int:
    for b in PROMPT_BUCKETS:
        if n <= b:
            return min(b, max_prompt)
    return max_prompt


def zipf_trace(n: int, vocab_size: int, *, max_prompt: int = 32,
               max_new: int = 32, alpha: float = 1.3, seed: int = 0,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 1.0) -> list[Request]:
    """n requests with Zipf-distributed prompt/generation lengths."""
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        plen = _bucket(int(np.clip(rng.zipf(alpha), 1, max_prompt)),
                       max_prompt)
        nnew = int(np.clip(rng.zipf(alpha), 1, max_new))
        prompt = rng.randint(1, max(vocab_size - 1, 2),
                             size=(plen,)).astype(np.int32)
        reqs.append(Request(rid=i, prompt=prompt, max_new_tokens=nnew,
                            temperature=temperature, top_k=top_k,
                            top_p=top_p))
    return reqs


def repetitive_trace(n: int, vocab_size: int, *, prompt_len: int = 8,
                     max_new: int = 48, seed: int = 0,
                     temperature: float = 0.0, top_k: int = 0,
                     top_p: float = 1.0) -> list[Request]:
    """n requests where draft-then-verify pays: short prompts cycling a
    random period of 2 to 4 tokens, long generations.  On a small-vocab
    model (``picolm-4-smoke``) the greedy continuation is
    n-gram-predictable too."""
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        period = int(rng.randint(2, 5))
        base = rng.randint(1, max(vocab_size - 1, 2), size=(period,))
        prompt = np.resize(base, prompt_len).astype(np.int32)
        reqs.append(Request(rid=i, prompt=prompt, max_new_tokens=max_new,
                            temperature=temperature, top_k=top_k,
                            top_p=top_p))
    return reqs
