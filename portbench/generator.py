"""The benchmark's one traffic generator, driven by a mix's data file.

A mix (``portbench/traffic/<name>.json``) gives the loop, its load and
the length distributions:

* ``"loop": "closed"`` with ``"clients_per_slot"``: that many requests
  a slot of the deployment are outstanding at every moment; a client
  sends its next request when the last one completes.  The requests
  that fill the slots at the start stand for requests already under
  way: each gets a uniform share of its drawn output, so completions
  are spread from the start as in a steady state.
* ``"loop": "open"`` with ``"rate_per_s"``: Poisson arrivals (gaps
  drawn independently from the exponential), released at their due
  times whatever the system has finished; ``"warm_s"`` of schedule run
  before the measured window opens.

``"prompt"`` and ``"output"`` are lognormal lengths (``median``,
``sigma``, clipped to ``min`` and ``max``), drawn independently.

Every mix is a fixed trace: its lengths and its unit-rate gaps are
drawn once from the mix's ``"trace_seed"``, the same for every run, and
an open loop's rate scales the gaps.  A run's seed draws only the token
ids of the prompts (and the benchmark's weights, elsewhere).  So every
seed replays the same Poisson sample, bursts and long prompts where
they fell, and the spread between runs is the system's, not the draw's.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

_POOL = 4096              # requests a trace holds; a closed loop cycles


@dataclasses.dataclass
class Spec:
    """One request as generated: its id, prompt ids and output length,
    and for an open loop its due time in seconds from the window's
    opening (negative: due in the warm period)."""
    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    due_s: float = 0.0


def lengths(dist: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """n independent lognormal lengths, rounded and clipped."""
    if dist.get("dist", "lognormal") != "lognormal":
        raise ValueError(f"length distribution {dist!r}")
    raw = np.rint(dist["median"] * np.exp(dist["sigma"]
                                          * rng.standard_normal(n)))
    return np.clip(raw, dist["min"], dist["max"]).astype(np.int64)


@dataclasses.dataclass
class Trace:
    """A mix's requests as drawn from its ``trace_seed``: prompt and
    output lengths, the gap before each arrival at rate 1, and a uniform
    share for a closed loop's first wave."""
    prompts: np.ndarray
    outputs: np.ndarray
    gaps: np.ndarray
    shares: np.ndarray


def trace(mix: dict, n: int = _POOL) -> Trace:
    n = max(n, _POOL)
    seed = int(mix["trace_seed"])
    rng = [np.random.default_rng([seed, s]) for s in range(4)]
    return Trace(lengths(mix["prompt"], n, rng[0]),
                 lengths(mix["output"], n, rng[1]),
                 rng[2].standard_exponential(n),
                 rng[3].uniform(size=n))


def _tokens(seed: int) -> np.random.Generator:
    return np.random.default_rng([abs(int(seed)), 2])


def open_loop(mix: dict, seed: int, seconds: float, vocab: int
              ) -> list[Spec]:
    """Every request due from ``-warm_s`` to ``seconds`` after the
    window opens, and as many again past it (they keep the load on while
    the window's last requests finish)."""
    rate, warm = float(mix["rate_per_s"]), float(mix.get("warm_s", 0.0))
    n = max(int(math.ceil(rate * (warm + 2 * seconds))), 1)
    tr = trace(mix, n)
    due = np.concatenate([[0.0], np.cumsum(tr.gaps[1:n])]) / rate - warm
    tok = _tokens(seed)
    return [Spec(i, tok.integers(0, vocab, int(tr.prompts[i]),
                                 dtype=np.int32),
                 int(tr.outputs[i]), float(due[i])) for i in range(n)]


class ClosedLoop:
    """The closed loop's request stream over ``slots`` slots: ``next()``
    gives the request sent when a client's last one completes (or, for
    the first ``clients``, at the start).  The first ``slots`` requests
    stand for requests already under way."""

    def __init__(self, mix: dict, seed: int, vocab: int, slots: int):
        self.clients = max(int(round(float(mix["clients_per_slot"])
                                     * slots)), slots)
        tr = trace(mix)
        self.prompts, self.outputs = tr.prompts, tr.outputs
        self.wave = np.ceil(tr.shares[:slots] * tr.outputs[:slots])
        self.vocab = vocab
        self.tok = _tokens(seed)
        self.sent = 0

    def next(self) -> Spec:
        i = self.sent
        j = i % len(self.prompts)
        self.sent += 1
        out = self.wave[i] if i < len(self.wave) else self.outputs[j]
        return Spec(i, self.tok.integers(0, self.vocab, int(self.prompts[j]),
                                         dtype=np.int32), max(int(out), 1))
