"""Request scheduler: admission, in-flight batching, eviction, preemption
(port of ``repro/serving/scheduler.py`` for greedy requests).

Two policies over the same paged KV pool and steps:

* ``continuous`` — between decode steps, every freed slot is immediately
  re-filled from the queue (continuous / in-flight batching);
* ``static`` — gang scheduling: admit a full batch, drain it until the
  *last* request finishes, then admit the next batch.

Admission goes through ``pool.can_admit`` (free pages, with headroom for
in-flight requests about to cross a page boundary); paged slots grow
before each decode step via ``pool.prepare_decode``; when the page pool
is starved mid-decode the youngest in-flight request is **preempted** —
its slot and pages are freed and it is re-queued at the front, to be
resumed by re-prefilling its prompt plus everything it generated, which
reproduces its KV exactly.  The victim is the request with the youngest
admission step, ties broken by the highest request id.

Prompts are ingested by the ``PrefillManager``: blocking
(``prefill_chunk == 0``, one whole-prompt chunk at admission) or chunked
(at most ``prefill_chunk`` tokens interleaved before each decode tick).
TTFT is tracked on a deterministic **virtual step clock**: one unit per
model invocation (decode tick or prefill chunk), a blocking prefill
priced at its ``ceil(n / chunk_unit)`` chunk-equivalents.

This slice serves greedy requests: the next token is a plain argmax over
the logits (the reference's all-greedy fast path).  Sampled requests,
speculative decoding, the shared-prefix cache and tracing are later
slices and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np

from repro_torch.serving.pool import PoolExhausted, to_device
from repro_torch.serving.prefill import PrefillManager


def percentile_steps(values, q: float) -> float:
    """np.percentile over virtual-step samples; NaN when nothing
    completed."""
    if not values:
        return float("nan")
    return float(np.percentile(np.asarray(values, np.float64), q))


class VirtualClock:
    """Deterministic step-count clock for the TTFT proxy: one unit per
    model invocation."""

    def __init__(self):
        self._t = 0

    @property
    def t(self) -> int:
        return self._t

    def advance(self, n: int = 1) -> None:
        self._t += int(n)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (s,) int32 token ids
    max_new_tokens: int = 16
    temperature: float = 0.0      # 0 = greedy
    top_k: int = 0                # 0 = no top-k filter
    top_p: float = 1.0            # 1 = no nucleus filter
    arrival_vstep: int = 0        # open-loop arrival on the virtual clock


@dataclasses.dataclass
class RequestResult:
    rid: int
    prompt_len: int
    max_new_tokens: int
    slot: int = -1
    tokens: list = dataclasses.field(default_factory=list)
    preemptions: int = 0
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0
    # virtual-step stamps (deterministic TTFT proxy; -1 = never reached)
    v_submit: int = 0
    v_first: int = -1
    v_done: int = -1

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_submit

    @property
    def ttft_steps(self) -> int:
        return self.v_first - self.v_submit

    @property
    def e2e_steps(self) -> int:
        return self.v_done - self.v_submit

    def meets_slo(self, slo_ttft_steps: int = 0,
                  slo_e2e_steps: int = 0) -> bool:
        """Deadlines judged on virtual steps only; an unset deadline
        (<= 0) always passes."""
        if self.v_first < 0 or self.v_done < 0:
            return False
        if slo_ttft_steps > 0 and self.ttft_steps > slo_ttft_steps:
            return False
        if slo_e2e_steps > 0 and self.e2e_steps > slo_e2e_steps:
            return False
        return True


@dataclasses.dataclass
class ServeStats:
    results: list
    wall_s: float
    decode_steps: int
    generated_tokens: int
    occupancy: float              # mean active-slot fraction per decode step
    peak_active: int = 0          # max concurrent in-flight requests
    peak_resident_tokens: int = 0  # max KV tokens held across the pool
    preemptions: int = 0          # page-pressure evictions
    prefill_chunks: int = 0       # chunk-step invocations
    prefill_tokens: int = 0       # prompt tokens ingested through chunks
    prefill_buckets: int = 0      # distinct (chunk bucket, kv bound) shapes
    prefill_queue_peak: int = 0   # max requests mid-prefill at once
    overlap_steps: int = 0        # steps that both chunked AND decoded
    mean_ttft_steps: float = 0.0  # mean virtual-clock time to first token
    p50_ttft_steps: float = float("nan")
    p99_ttft_steps: float = float("nan")
    p50_e2e_steps: float = float("nan")
    p99_e2e_steps: float = float("nan")
    goodput_tokens: int = 0       # tokens of requests that met the SLO
    slo_ttft_steps: int = 0
    slo_e2e_steps: int = 0
    total_vsteps: int = 0         # virtual-clock span of the whole drain

    @property
    def tokens_per_s(self) -> float:
        return self.generated_tokens / max(self.wall_s, 1e-9)

    def summary(self) -> str:
        lat = [r.latency_s for r in self.results]
        pre = f", {self.preemptions} preemptions" if self.preemptions else ""
        return (f"{len(self.results)} requests, {self.generated_tokens} tokens "
                f"in {self.wall_s:.3f}s -> {self.tokens_per_s:.1f} tok/s | "
                f"{self.decode_steps} decode steps, "
                f"occupancy {self.occupancy:.0%}, "
                f"peak {self.peak_active} in flight{pre} | latency "
                f"mean {np.mean(lat):.3f}s p max {np.max(lat):.3f}s")


@dataclasses.dataclass
class _Entry:
    """A queued unit of work: a fresh request, or a preempted one carrying
    the result it must resume (tokens generated so far)."""
    req: Request
    st: RequestResult | None = None

    @property
    def pending_len(self) -> int:
        n = len(self.req.prompt)
        return n + len(self.st.tokens) if self.st is not None else n

    def pending_tokens(self) -> np.ndarray:
        """The prefix a (re-)admission must ingest: the prompt plus
        everything generated before a preemption."""
        prompt = np.asarray(self.req.prompt, np.int32)
        if self.st is not None and self.st.tokens:
            return np.concatenate(
                [prompt, np.asarray(self.st.tokens, np.int32)])
        return prompt

    def remaining_new(self) -> int:
        if self.st is None:
            return self.req.max_new_tokens
        return self.st.max_new_tokens - len(self.st.tokens)


@dataclasses.dataclass
class _Active:
    req: Request
    st: RequestResult
    admit_step: int               # decode step at admission; youngest is
    #                               the preemption victim, ties by req.rid


def _greedy(logits_last) -> np.ndarray:
    """Row-wise argmax (first maximum on ties, as ``jnp.argmax``)."""
    return logits_last.argmax(dim=-1).cpu().numpy()


class Scheduler:
    """Drains a request queue through repeated slot-wise decode calls."""

    def __init__(self, pool, decode_fn, chunk_step_fn,
                 eos_id: int | None = None, policy: str = "continuous",
                 # advisory wall_s only; gated metrics are vstep-clocked
                 clock=time.perf_counter,  # easeylint: allow[wall-clock]
                 prefill_chunk: int = 0, prefill_chunk_unit: int = 16,
                 slo_ttft_steps: int = 0, slo_e2e_steps: int = 0):
        if policy not in ("continuous", "static"):
            raise ValueError(policy)
        if prefill_chunk < 0 or prefill_chunk_unit < 1:
            raise ValueError((prefill_chunk, prefill_chunk_unit))
        self.pool = pool
        self.decode_fn = decode_fn          # (cache, tokens, active, *extras)
        self.chunk_step_fn = chunk_step_fn  # (cache, toks, slot, off, n, ...)
        self.prefill_chunk = prefill_chunk  # 0 = blocking full-prompt
        self.chunk_unit = prefill_chunk_unit
        self.eos_id = eos_id
        self.policy = policy
        self.clock = clock
        self.vclock = VirtualClock()
        self.slo_ttft_steps = int(slo_ttft_steps)
        self.slo_e2e_steps = int(slo_e2e_steps)
        self.reset()

    # -- state ---------------------------------------------------------------
    def reset(self) -> None:
        """Fresh drain state (queue, active set, counters, host mirrors)."""
        S = self.pool.num_slots
        self.queue: deque = deque()
        self.active: dict[int, _Active] = {}
        self.done: list[RequestResult] = []
        self._last_tokens = np.zeros((S, 1), np.int32)
        self._active_mask = np.zeros((S,), np.int32)
        self._steps = 0
        self._busy = 0
        self._peak = 0
        self._peak_resident = 0
        self._preemptions = 0
        self._overlap = 0
        self._t0 = self.clock()
        self._v0 = self.vclock.t
        self._mgr = PrefillManager(self.pool, self.chunk_step_fn,
                                   self.prefill_chunk)

    @property
    def has_work(self) -> bool:
        return bool(self.queue or self.active or self._mgr.has_jobs)

    @property
    def in_flight(self) -> int:
        """Requests holding pool resources: decoding plus mid-prefill."""
        return len(self.active) + len(self._mgr.jobs)

    def validate(self, requests) -> None:
        """Reject up front what this scheduler or pool could never serve,
        so a mid-run rejection never throws away a drain's stats."""
        for req in requests:
            if req.temperature > 0 and req.top_k != 1:
                raise NotImplementedError(
                    f"request {req.rid}: sampled decoding (temperature "
                    f"{req.temperature}) needs the keyed sampler "
                    f"(ROADMAP: keyed sampler); this slice serves greedy "
                    f"requests")
            if len(req.prompt) > self.pool.max_len:
                raise ValueError(
                    f"request {req.rid}: prompt ({len(req.prompt)}) does "
                    f"not fit pool max_len {self.pool.max_len}")
            if not 0.0 < req.top_p <= 1.0:
                raise ValueError(
                    f"request {req.rid}: top_p {req.top_p} not in (0, 1]")
            if req.arrival_vstep < 0:
                raise ValueError(
                    f"request {req.rid}: arrival_vstep "
                    f"{req.arrival_vstep} < 0")
            worst = self.worst_resident(_Entry(req))
            if not self.pool.can_ever_serve(worst):
                raise PoolExhausted(
                    f"request {req.rid} needs {worst} resident KV tokens "
                    f"but the pool can never hold that many")

    def worst_resident(self, entry: _Entry) -> int:
        """Max KV tokens `entry` will hold if admitted (eos: only the
        pending prefill is certain; otherwise full-length generation is)."""
        if self.eos_id is not None:
            return entry.pending_len
        return min(entry.pending_len + entry.remaining_new() - 1,
                   self.pool.max_len)

    # -- admission ---------------------------------------------------------
    def admit_from_queue(self) -> None:
        """Admit from the queue head while the pool has room."""
        while self.queue and self.pool.can_admit(self.queue[0].pending_len,
                                                 tuple(self.active)):
            self._admit(self.queue.popleft())

    def _admit(self, entry: _Entry) -> None:
        now = self.clock()
        req = entry.req
        if entry.st is None:
            s = len(req.prompt)
            budget = self.pool.max_len - s + 1   # writes stop at max_len - 1
            st = RequestResult(
                rid=req.rid, prompt_len=s,
                max_new_tokens=min(req.max_new_tokens, budget),
                t_submit=self._t0, t_admit=now,
                v_submit=self._v0 + req.arrival_vstep)
        else:                                    # resume after preemption
            st = entry.st
        # the slot and the prompt's pages are reserved NOW (the decision
        # point blocking admission reserves at, so order and streams match)
        job = self._mgr.submit(entry, st, entry.pending_tokens())
        job.admit_step = self._steps
        if self.prefill_chunk:
            return                               # chunks interleave in step()
        # blocking: the whole prompt as one chunk, inline — priced on the
        # virtual clock at its chunk-equivalent cost
        self.vclock.advance(-(-job.remaining // self.chunk_unit))
        self._finish_prefill(job, self._mgr.drain(job))

    def _finish_prefill(self, job, logits) -> None:
        """A job's final chunk landed: take the first token and either
        finish the request or activate its (already-populated) slot."""
        st, req = job.st, job.entry.req
        tok = int(_greedy(logits[:, -1])[0])
        if job.entry.st is None:
            st.t_first = self.clock()
            st.v_first = self.vclock.t
        st.tokens.append(tok)
        if len(st.tokens) >= st.max_new_tokens or tok == self.eos_id:
            st.t_done = self.clock()
            st.v_done = self.vclock.t
            self.done.append(st)
            self.pool.free(job.slot)
            return
        st.slot = job.slot
        self.active[job.slot] = _Active(req, st, job.admit_step)
        self._last_tokens[job.slot, 0] = tok
        self._active_mask[job.slot] = 1

    # -- preemption --------------------------------------------------------
    def _preempt(self, slot: int) -> None:
        """Free `slot` and re-queue its request at the front."""
        en = self.active.pop(slot)
        en.st.slot = -1
        en.st.preemptions += 1
        self._active_mask[slot] = 0
        self._last_tokens[slot, 0] = 0
        self.pool.free(slot)                 # returns its pages
        self.queue.appendleft(_Entry(en.req, en.st))
        self._preemptions += 1

    def _requeue_job(self, job) -> None:
        """Re-queue an evicted mid-prefill job at the queue front.  A
        fresh job restarts from scratch; a resume job keeps its result."""
        st = job.st if job.st.tokens else None
        if st is not None:
            st.slot = -1
            st.preemptions += 1
        self.queue.appendleft(_Entry(job.entry.req, st))
        self._preemptions += 1

    # -- one iteration -----------------------------------------------------
    def step(self) -> None:
        """One scheduler tick: ingest at most ``prefill_chunk`` queued
        prompt tokens, then one slot-wise decode over the active set.

        Starvation preempts mid-prefill jobs first (youngest), then the
        youngest in-flight request until the step fits; when the *sole*
        active request starves, the pool can never make progress and
        ``PoolExhausted`` is raised.
        """
        chunked = 0
        if self._mgr.has_jobs:
            self._peak = max(self._peak, self.in_flight)
            finished, chunked = self._mgr.tick(self.vclock)
            for job, logits in finished:
                self._finish_prefill(job, logits)
        if not self.active:
            return
        while True:
            starved = self.pool.prepare_decode(sorted(self.active))
            if not starved:
                break
            if self._mgr.has_jobs:
                self._requeue_job(self._mgr.evict_newest())
                continue
            if len(self.active) == 1:
                (slot,) = self.active
                raise PoolExhausted(
                    f"page starvation mid-decode: request "
                    f"{self.active[slot].req.rid} holds every page and "
                    f"still needs another — the page pool is too small "
                    f"for it")
            victim = max(self.active,
                         key=lambda sl: (self.active[sl].admit_step,
                                         self.active[sl].req.rid))
            self._preempt(victim)
        self._peak = max(self._peak, self.in_flight)
        self._peak_resident = max(self._peak_resident,
                                  int(self.pool.lengths.sum()))
        device = self.pool.device
        logits, new_cache = self.decode_fn(
            self.pool.cache, to_device(self._last_tokens, device),
            to_device(self._active_mask, device), *self.pool.decode_extras())
        self.pool.update(new_cache, tuple(self.active))
        self.vclock.advance(1)
        self._steps += 1
        self._busy += len(self.active)
        if chunked:
            self._overlap += 1       # ingested a chunk AND decoded a token
        toks = _greedy(logits[:, -1])
        now = self.clock()
        vnow = self.vclock.t
        for slot, en in list(self.active.items()):
            st = en.st
            tok = int(toks[slot])
            st.tokens.append(tok)
            self._last_tokens[slot, 0] = tok
            if len(st.tokens) >= st.max_new_tokens or tok == self.eos_id:
                st.t_done = now
                st.v_done = vnow
                self.done.append(st)
                del self.active[slot]
                self._active_mask[slot] = 0
                self._last_tokens[slot, 0] = 0
                self.pool.free(slot)

    # -- results -----------------------------------------------------------
    def stats(self) -> ServeStats:
        wall = self.clock() - self._t0
        done = sorted(self.done, key=lambda r: r.rid)
        ttfts = [r.ttft_steps for r in done if r.v_first >= 0]
        e2es = [r.e2e_steps for r in done if r.v_done >= 0]
        goodput = sum(
            len(r.tokens) for r in done
            if r.meets_slo(self.slo_ttft_steps, self.slo_e2e_steps))
        mgr = self._mgr
        return ServeStats(
            results=done, wall_s=wall, decode_steps=self._steps,
            generated_tokens=sum(len(r.tokens) for r in done),
            occupancy=self._busy / max(self._steps * self.pool.num_slots, 1),
            peak_active=self._peak, peak_resident_tokens=self._peak_resident,
            preemptions=self._preemptions,
            prefill_chunks=mgr.chunks_run,
            prefill_tokens=mgr.tokens_ingested,
            prefill_buckets=len(mgr.shape_buckets),
            prefill_queue_peak=mgr.queue_peak,
            overlap_steps=self._overlap,
            mean_ttft_steps=float(np.mean(ttfts)) if ttfts else 0.0,
            p50_ttft_steps=percentile_steps(ttfts, 50),
            p99_ttft_steps=percentile_steps(ttfts, 99),
            p50_e2e_steps=percentile_steps(e2es, 50),
            p99_e2e_steps=percentile_steps(e2es, 99),
            goodput_tokens=goodput,
            slo_ttft_steps=self.slo_ttft_steps,
            slo_e2e_steps=self.slo_e2e_steps,
            total_vsteps=self.vclock.t - self._v0)

    # -- main loop ---------------------------------------------------------
    def run(self, requests) -> ServeStats:
        """Drain a trace.  Closed-loop traces (every ``arrival_vstep`` 0)
        queue everything up front; open-loop traces release each request
        once the virtual clock reaches its arrival, fast-forwarding an
        idle pool to the next arrival."""
        requests = list(requests)
        self.validate(requests)
        self.reset()
        # stable sort: ties (and the all-zero closed loop) keep trace order
        pending = deque(sorted((_Entry(r) for r in requests),
                               key=lambda en: en.req.arrival_vstep))
        while pending or self.has_work:
            while pending and self._v0 + pending[0].req.arrival_vstep \
                    <= self.vclock.t:
                self.queue.append(pending.popleft())
            if self.policy == "continuous" or \
                    not (self.active or self._mgr.has_jobs):
                self.admit_from_queue()
            if not self.active and not self._mgr.has_jobs:
                if self.queue:
                    en = self.queue[0]
                    raise PoolExhausted(
                        f"request {en.req.rid} ({en.pending_len} tokens) "
                        f"cannot be admitted into an otherwise idle pool — "
                        f"the KV pool is too small for it")
                if pending:
                    nxt = self._v0 + pending[0].req.arrival_vstep
                    self.vclock.advance(nxt - self.vclock.t)
                continue
            self.step()
        return self.stats()
