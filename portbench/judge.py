"""The check that decides ``correct``: what the program served, held
against the plain reference.

Once the window has closed and the program is freed, a sample of the
requests finished in the window is drawn from the seed, the longest
among them.  The reference draws the weights again, runs each sampled
request's prompt and served tokens through its float32 forward, with the
mixture of experts routed in the groups the program's steps formed, and
reads how far each served token's logit lies below its best.  The widest
of those gaps, and their mean, are the numbers a cell's limits file can
compare (``report.GAPS``).

The control puts the reference in the program's place in float8: at the
same positions, its own first choice, read by the float32 reference in
the same way.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import reference

SAMPLE_TOKENS = 600       # served tokens compared, at least
SAMPLE_MAX = 16           # requests compared, at most


def sample(rec, seed: int) -> list:
    """The requests finished in the window that are compared: the one
    that served the most tokens, then others in an order drawn from the
    seed, until SAMPLE_TOKENS served tokens or SAMPLE_MAX requests.
    A request the pool preempted (re-prefilled under another
    composition) or that ended at its first token is not drawn."""
    done = sorted((r for r in rec.reqs.values()
                   if r.tokens and rec.in_window(r.done)
                   and r.preemptions == 0 and len(r.tokens) > 1),
                  key=lambda r: r.rid)
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.tokens), -r.rid))
    rest = [r for r in done if r is not longest]
    order = np.random.default_rng([abs(int(seed)), 3]).permutation(len(rest))
    out, served = [longest], len(longest.tokens)
    for i in order:
        if served >= SAMPLE_TOKENS or len(out) >= SAMPLE_MAX:
            break
        out.append(rest[i])
        served += len(rest[i].tokens)
    return out


def excluded(rec) -> int:
    """Requests finished in the window that the sample may not draw."""
    return sum(1 for r in rec.reqs.values()
               if r.tokens and rec.in_window(r.done) and r.preemptions)


@torch.no_grad()
def check(rec, model: dict, seed: int, device: str,
          control: bool = False) -> dict:
    """The gaps of the sample's served tokens (``_spread``: ``gap``,
    ``gap_mean``, ...), the tokens and requests compared, and with
    ``control`` the same of the fp8 control's choices (``control_gap``,
    ``control_gap_mean``, ...)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    reqs = sample(rec, seed)
    out = {"gap": 0.0, "tokens": 0, "requests": len(reqs),
           "excluded": excluded(rec)}
    if not reqs:
        out["gap"] = None
        return out
    weights = reference.make_weights(model, seed, device)
    all_gaps, all_c = [], []
    for r in reqs:
        P = len(r.prompt)
        served = torch.as_tensor(r.tokens, device=device)
        toks = torch.cat([torch.as_tensor(r.prompt, device=device),
                          served[:-1].to(torch.int32)])
        groups = reference.step_groups(model, P, len(toks), r.chunks)
        at = torch.arange(P - 1, len(toks), device=device)
        logits = reference.forward(weights, model, toks, groups, at)
        all_gaps.append(reference.gaps(logits, served).cpu())
        if control:
            low = reference.forward(weights, model, toks, groups, at,
                                    quant="fp8")
            all_c.append(reference.gaps(logits, low.argmax(-1)).cpu())
        out["tokens"] += len(r.tokens)
    out.update(_spread("", torch.cat(all_gaps)))
    if control:
        out.update(_spread("control_", torch.cat(all_c)))
    out["seconds"] = time.perf_counter() - t0
    return out


def _spread(prefix: str, g: torch.Tensor) -> dict:
    """The widest gap, the mean gap, and beside them the 99th percentile
    and the share of tokens that were not the reference's first
    choice."""
    return {prefix + "gap": float(g.max()),
            prefix + "gap_mean": float(g.mean()),
            prefix + "gap_p99": float(torch.quantile(g, 0.99)),
            prefix + "off_best": float((g > 0).float().mean())}
