"""Synthetic request traces and open-loop arrival presets (port of
``repro/serving/trace.py``).

Real serving traffic is heavy-tailed: many short exchanges, a few long
generations.  ``zipf_trace`` draws both the prompt and the generation
lengths from a clipped Zipf law, prompt lengths bucketed to powers of
two; ``longprompt_trace`` clusters prompts near ``max_prompt`` (the
prefill-stall regime); ``sharedprefix_trace`` opens every prompt with
one of a few Zipf-popular shared heads (the prefix cache's regime);
``uniform_trace`` gives same-length requests; ``repetitive_trace`` is
the speculative-decoding probe's, and ``trace_repetitiveness`` measures
a trace's n-gram self-overlap for the tuner's ``serve_spec_k``.

Traces are closed-loop by default (``arrival_vstep == 0``).
``poisson_arrivals`` / ``bursty_arrivals`` / ``with_arrivals`` stamp
open-loop arrivals on the virtual step clock.  Every draw comes from
``np.random.RandomState(seed)`` in the reference's order, so both
packages build the same requests and the same arrival schedule.
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


def longprompt_trace(n: int, vocab_size: int, *, max_prompt: int = 128,
                     max_new: int = 16, alpha: float = 1.5, seed: int = 0,
                     temperature: float = 0.0, top_k: int = 0,
                     top_p: float = 1.0) -> list[Request]:
    """n requests whose prompt lengths cluster *near* ``max_prompt``.

    The shortfall below max_prompt is the Zipf draw (so most prompts sit
    at the top bucket, a tail reaches down to ~max_prompt/4) and the
    generations are short — the prefill-stall regime: admission cost
    dominates decode cost, which is exactly where blocking prompt
    ingestion serializes the fleet and chunked prefill pays off.
    Deterministic for a fixed seed, like every trace here.
    """
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        short = int(np.clip(rng.zipf(alpha) - 1, 0, max_prompt * 3 // 4))
        plen = _bucket(max_prompt - short, max_prompt)
        nnew = int(np.clip(rng.zipf(alpha), 1, max_new))
        prompt = rng.randint(1, max(vocab_size - 1, 2),
                             size=(plen,)).astype(np.int32)
        reqs.append(Request(rid=i, prompt=prompt, max_new_tokens=nnew,
                            temperature=temperature, top_k=top_k,
                            top_p=top_p))
    return reqs


def sharedprefix_trace(n: int, vocab_size: int, *, n_heads: int = 4,
                       head_len: int = 32, max_suffix: int = 24,
                       max_new: int = 8, alpha: float = 1.2, seed: int = 0,
                       temperature: float = 0.0, top_k: int = 0,
                       top_p: float = 1.0) -> list[Request]:
    """n requests whose prompts open with one of ``n_heads`` shared heads.

    Head popularity is Zipf-clustered (head 0 dominates, like a fleet
    where most traffic shares one system preamble and a tail of few-shot
    templates splits the rest), and each request appends a private
    Zipf-length suffix of at least one token.  ``head_len`` defaults to
    two 16-token KV pages, so a page-aligned prefix cache has whole
    pages to reuse — the regime the shared-prefix cache is judged in.
    Deterministic for a fixed seed, like every trace here.
    """
    rng = np.random.RandomState(seed)
    heads = rng.randint(1, max(vocab_size - 1, 2),
                        size=(n_heads, head_len)).astype(np.int32)
    reqs = []
    for i in range(n):
        h = min(int(rng.zipf(alpha)) - 1, n_heads - 1)
        slen = int(np.clip(rng.zipf(alpha), 1, max_suffix))
        suffix = rng.randint(1, max(vocab_size - 1, 2),
                             size=(slen,)).astype(np.int32)
        nnew = int(np.clip(rng.zipf(alpha), 1, max_new))
        reqs.append(Request(rid=i,
                            prompt=np.concatenate([heads[h], suffix]),
                            max_new_tokens=nnew,
                            temperature=temperature, top_k=top_k,
                            top_p=top_p))
    return reqs


def uniform_trace(n: int, vocab_size: int, *, prompt_len: int = 16,
                  max_new: int = 8, seed: int = 0,
                  temperature: float = 0.0, top_k: int = 0,
                  top_p: float = 1.0) -> list[Request]:
    """n same-length requests — the static/continuous equivalence case."""
    rng = np.random.RandomState(seed)
    return [Request(rid=i,
                    prompt=rng.randint(1, max(vocab_size - 1, 2),
                                       size=(prompt_len,)).astype(np.int32),
                    max_new_tokens=max_new,
                    temperature=temperature, top_k=top_k, top_p=top_p)
            for i in range(n)]


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


ARRIVAL_MODES = ("closed", "poisson", "bursty")


def poisson_arrivals(requests, *, mean_gap: float = 4.0,
                     seed: int = 0) -> list[Request]:
    """Stamp ``arrival_vstep`` with a Poisson arrival process.

    Inter-arrival gaps are exponential with mean ``mean_gap`` virtual
    steps; arrivals are the floored cumulative sum, so the first request
    can land at vstep 0 and ties are possible (a burst admitted in one
    round).  Mutates and returns ``requests`` in trace order.
    """
    rng = np.random.RandomState(seed)
    t = 0.0
    for req in requests:
        t += float(rng.exponential(mean_gap))
        req.arrival_vstep = int(t)
    return requests


def bursty_arrivals(requests, *, mean_gap: float = 4.0, burst: float = 4.0,
                    period: float = 64.0, seed: int = 0) -> list[Request]:
    """Stamp ``arrival_vstep`` with a diurnally modulated Poisson process.

    The instantaneous rate swings sinusoidally with ``period`` (vsteps):
    at the peak the mean gap is ``mean_gap / burst`` (a rush), at the
    trough it is ``mean_gap`` (quiet) — the day/night shape production
    admission has to absorb.  Deterministic for a fixed seed.
    """
    if burst < 1.0:
        raise ValueError(f"burst must be >= 1, got {burst}")
    rng = np.random.RandomState(seed)
    t = 0.0
    for req in requests:
        phase = 0.5 * (1.0 + np.sin(2.0 * np.pi * t / period))
        local_gap = mean_gap / (1.0 + (burst - 1.0) * phase)
        t += float(rng.exponential(local_gap))
        req.arrival_vstep = int(t)
    return requests


def with_arrivals(requests, mode: str = "closed", *, mean_gap: float = 4.0,
                  seed: int = 0, **kw) -> list[Request]:
    """Dispatch on ``mode`` in ``ARRIVAL_MODES``; ``closed`` zeroes stamps."""
    if mode == "closed":
        for req in requests:
            req.arrival_vstep = 0
        return requests
    if mode == "poisson":
        return poisson_arrivals(requests, mean_gap=mean_gap, seed=seed, **kw)
    if mode == "bursty":
        return bursty_arrivals(requests, mean_gap=mean_gap, seed=seed, **kw)
    raise ValueError(f"unknown arrival mode {mode!r}; "
                     f"choose from {ARRIVAL_MODES}")


def trace_repetitiveness(requests, max_n: int = 3) -> float:
    """Mean n-gram self-overlap of a trace's prompts, in [0, 1].

    For each prompt position past the first ``max_n`` tokens: does the
    ``max_n``-gram ending there occur earlier in the prompt?  The hit
    fraction is exactly the n-gram drafter's hit condition evaluated on
    the only tokens known before generation starts, so it proxies the
    per-draft accept probability — the tuner turns it into
    ``plan.serve_spec_k`` via the napkin estimate in
    ``core/tuning.spec_k_for``.
    """
    hits = total = 0
    for req in requests:
        p = [int(t) for t in np.asarray(req.prompt)]
        for i in range(max_n, len(p)):
            gram = p[i - max_n + 1:i + 1]
            # every earlier start, including the window ending at i-1
            # (j = i - max_n); excluding it undercounts short-period
            # cycles and the tuner picks too-small serve_spec_k
            found = any(p[j:j + max_n] == gram
                        for j in range(i - max_n + 1))
            hits += bool(found)
            total += 1
    return hits / total if total else 0.0
