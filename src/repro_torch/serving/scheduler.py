"""Request scheduler: admission, in-flight batching, eviction, preemption,
sampling and speculative decoding (port of ``repro/serving/scheduler.py``).

Two policies over the same KV pool (contiguous or paged) and steps:

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

Sampling is per request: ``temperature`` / ``top_k`` / ``top_p`` ride
in per-slot vectors into one sampler call per step
(``serving/sampling.py``), each draw keyed by the request id and its
generation step, so preemption and speculation never change a stream.
A trace of greedy requests skips the sampler for a plain argmax (the
sampler's own temperature-0 / top-k-1 case).

With ``spec_k > 0`` (plus a ``verify_fn``) each decode tick is a
draft-then-verify tick (``_spec_step``): a drafter proposes k tokens per
slot, one verify step scores all k+1 positions, and each slot accepts
the longest draft prefix that matches the sequential sampler's own
draws — speculative streams equal ``spec_k == 0`` streams.

Admission asks the pool for an entry's *cold* footprint: with a
shared-prefix cache attached (``serving/prefix_cache.py``) a probe hit
leaves only the un-cached suffix to reserve and ingest.  ``run()``
drains a whole trace, and every phase is also exposed step-wise
(``reset`` / ``try_admit`` / ``admit_from_queue`` / ``step`` /
``stats``) so a ``ReplicaRouter`` can drive N schedulers in lockstep on
one shared clock (``RoundClock``), routing at admission and taking back
a request that starves its replica alone
(``step(evict_on_starvation=True)``).

An optional ``tracer`` (``serving/telemetry.Tracer``) records each
request's spans (queued, decode, spec_verify, resume) and ring events
(preemptions) on the virtual clock; every site is guarded by ``if
tracer is not None``, so tracing cannot change a token or a count.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np

from repro_torch.serving.pool import PoolExhausted, to_device
from repro_torch.serving.prefill import PrefillManager
from repro_torch.serving.sampling import K_CAP, effective_top_k
from repro_torch.serving.spec import NGramDrafter
from repro_torch.serving.telemetry import SERVE_SCHEMA, MetricsRegistry


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

    # host-thread work that stalls everyone (a blocking prefill): on the
    # plain clock the same as advance; a router's RoundClock tells them
    # apart
    advance_serial = advance


class RoundClock:
    """A replica's view of a shared fleet clock during one lockstep round.

    Parallel work (``advance``: decode ticks, prefill chunks) accumulates
    a local offset; at the end of the round the router advances the
    shared clock by the largest offset of the fleet, since replicas work
    at once.  Serial work (``advance_serial``: a blocking prefill at
    dispatch) goes straight to the shared clock — the host runs those
    one after another, stalling every replica's round."""

    def __init__(self, shared: VirtualClock):
        self.shared = shared
        self.offset = 0

    @property
    def t(self) -> int:
        return self.shared.t + self.offset

    def advance(self, n: int = 1) -> None:
        self.offset += int(n)

    def advance_serial(self, n: int = 1) -> None:
        self.shared.advance(n)

    def take(self) -> int:
        off, self.offset = self.offset, 0
        return off


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
    def ttft_s(self) -> float:
        return self.t_first - self.t_submit

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
    # shared-prefix KV cache (zeros with the cache off)
    prefix_hits: int = 0          # admissions that reused a cached run
    prefix_misses: int = 0        # admissions with no cached prefix
    prefill_tokens_saved: int = 0  # prompt tokens skipped via cache hits
    prefix_evictions: int = 0     # cache cells reclaimed under pressure
    # speculative decoding (zeros with spec_k == 0): one verify event per
    # active slot per verify step, so accepted_per_verify is per request
    spec_verify_steps: int = 0    # slot-verify scoring events
    spec_drafted_tokens: int = 0  # draft tokens proposed (k per event)
    spec_accepted_tokens: int = 0  # draft tokens accepted
    total_vsteps: int = 0         # virtual-clock span of the whole drain
    # the top-k the sampler applied per request that asked for one
    effective_top_k: dict = dataclasses.field(default_factory=dict)

    @property
    def tokens_per_s(self) -> float:
        return self.generated_tokens / max(self.wall_s, 1e-9)

    def to_metrics(self) -> dict:
        """Flat ``{key: number}`` snapshot of the drain, a view over
        ``telemetry.SERVE_SCHEMA`` (the registry raises on a missing or
        undeclared key).  The wall-clock figures are advisory."""
        reg = MetricsRegistry(SERVE_SCHEMA)
        reg.set("serve_requests_completed", len(self.results))
        reg.set("serve_generated_tokens", self.generated_tokens)
        reg.set("serve_goodput_tokens", self.goodput_tokens)
        reg.set("serve_slo_ttft_steps", self.slo_ttft_steps)
        reg.set("serve_slo_e2e_steps", self.slo_e2e_steps)
        reg.set("serve_ttft_p50_steps", self.p50_ttft_steps)
        reg.set("serve_ttft_p99_steps", self.p99_ttft_steps)
        reg.set("serve_e2e_p50_steps", self.p50_e2e_steps)
        reg.set("serve_e2e_p99_steps", self.p99_e2e_steps)
        reg.set("serve_mean_ttft_steps", self.mean_ttft_steps)
        reg.set("serve_total_vsteps", self.total_vsteps)
        reg.set("serve_wall_s", self.wall_s)
        reg.set("serve_tokens_per_s", self.tokens_per_s)
        reg.set("serve_decode_steps", self.decode_steps)
        reg.set("serve_occupancy", self.occupancy)
        reg.set("serve_peak_active", self.peak_active)
        reg.set("serve_peak_resident_kv", self.peak_resident_tokens)
        reg.set("serve_preemptions", self.preemptions)
        reg.set("serve_prefill_chunks", self.prefill_chunks)
        reg.set("serve_prefill_tokens", self.prefill_tokens)
        reg.set("serve_prefix_hits", self.prefix_hits)
        reg.set("serve_prefix_misses", self.prefix_misses)
        reg.set("serve_prefill_tokens_saved", self.prefill_tokens_saved)
        reg.set("serve_prefix_evictions", self.prefix_evictions)
        reg.set("serve_spec_verify_steps", self.spec_verify_steps)
        reg.set("serve_spec_drafted_tokens", self.spec_drafted_tokens)
        reg.set("serve_spec_accepted_tokens", self.spec_accepted_tokens)
        return reg.snapshot()

    @property
    def accepted_per_verify(self) -> float:
        """Tokens emitted per slot-verify event (accepted drafts plus the
        token each verify always emits); 0 without speculation."""
        if not self.spec_verify_steps:
            return 0.0
        return (self.spec_verify_steps + self.spec_accepted_tokens) \
            / self.spec_verify_steps

    def summary(self) -> str:
        lat = [r.latency_s for r in self.results]
        pre = f", {self.preemptions} preemptions" if self.preemptions else ""
        if self.prefix_hits:
            pre += (f", {self.prefix_hits} prefix hits "
                    f"({self.prefill_tokens_saved}t prefill saved)")
        if self.spec_verify_steps:
            pre += (f", spec {self.accepted_per_verify:.2f} tok/verify "
                    f"({self.spec_accepted_tokens}/{self.spec_drafted_tokens}"
                    f" drafts accepted)")
        return (f"{len(self.results)} requests, {self.generated_tokens} tokens "
                f"in {self.wall_s:.3f}s -> {self.tokens_per_s:.1f} tok/s | "
                f"{self.decode_steps} decode steps, "
                f"occupancy {self.occupancy:.0%}, "
                f"peak {self.peak_active} in flight{pre} | latency "
                f"mean {np.mean(lat):.3f}s p max {np.max(lat):.3f}s")


@dataclasses.dataclass
class _Entry:
    """A queued unit of work: a fresh request, or a preempted one carrying
    the result it must resume (tokens generated so far).  ``rerouted``
    marks an entry a router took back after it starved its replica alone:
    it is placed by its full remaining generation, even under an eos."""
    req: Request
    st: RequestResult | None = None
    rerouted: bool = False
    probe_hit: object = None      # the prefix-cache probe of the can_admit
    #                               just before _admit, which attach reuses

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


def _greedy(logits) -> np.ndarray:
    """Argmax over the last axis (first maximum on ties, as
    ``jnp.argmax``)."""
    return logits.argmax(dim=-1).cpu().numpy()


class Scheduler:
    """Drains a request queue through repeated slot-wise decode calls."""

    def __init__(self, pool, decode_fn, chunk_step_fn,
                 eos_id: int | None = None, policy: str = "continuous",
                 sampler=None,
                 # advisory wall_s only; gated metrics are vstep-clocked
                 clock=time.perf_counter,  # easeylint: allow[wall-clock]
                 prefill_chunk: int = 0, prefill_chunk_unit: int = 16,
                 verify_fn=None, spec_k: int = 0, drafter=None,
                 vocab_size: int | None = None,
                 slo_ttft_steps: int = 0, slo_e2e_steps: int = 0,
                 vclock=None, replica_id: int = 0, tracer=None):
        if policy not in ("continuous", "static"):
            raise ValueError(policy)
        if prefill_chunk < 0 or prefill_chunk_unit < 1:
            raise ValueError((prefill_chunk, prefill_chunk_unit))
        if spec_k < 0:
            raise ValueError(f"spec_k {spec_k} < 0")
        if spec_k and verify_fn is None:
            raise ValueError("spec_k > 0 needs a verify_fn "
                             "(training/steps.build_verify_step_slots*)")
        self.pool = pool
        self.decode_fn = decode_fn          # (cache, tokens, active, *extras)
        self.chunk_step_fn = chunk_step_fn  # (cache, toks, slot, off, n, ...)
        self.prefill_chunk = prefill_chunk  # 0 = blocking full-prompt
        self.chunk_unit = prefill_chunk_unit
        self.eos_id = eos_id
        self.policy = policy
        self.sampler = sampler              # None -> greedy argmax
        self.clock = clock
        self.vclock = vclock or VirtualClock()
        self.replica_id = int(replica_id)
        self.verify_fn = verify_fn          # (cache, toks, active, *extras)
        self.spec_k = spec_k
        self.drafter = drafter if drafter is not None else \
            (NGramDrafter() if spec_k else None)
        self.vocab_size = vocab_size        # for effective-top-k reporting
        self.all_greedy = False
        self.slo_ttft_steps = int(slo_ttft_steps)
        self.slo_e2e_steps = int(slo_e2e_steps)
        # telemetry hook: host-side bookkeeping behind `is not None`
        # guards, never read by a step
        self.tracer = tracer
        self.reset()

    # -- state ---------------------------------------------------------------
    def reset(self, t0: float | None = None) -> None:
        """Fresh drain state (queue, active set, counters, host mirrors);
        ``t0`` is the wall-clock start a router shares across replicas."""
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
        self._spec_verifies = 0
        self._spec_drafted = 0
        self._spec_accepted = 0
        self._eff_topk: dict[int, int] = {}
        self._t0 = self.clock() if t0 is None else t0
        self._v0 = self.vclock.t
        self._mgr = PrefillManager(self.pool, self.chunk_step_fn,
                                   self.prefill_chunk, tracer=self.tracer,
                                   vclock=self.vclock,
                                   replica_id=self.replica_id)
        if self.pool.prefix_cache is not None:
            self.pool.prefix_cache.bind_tracer(self.tracer, self.vclock,
                                               self.replica_id)

    @property
    def has_work(self) -> bool:
        return bool(self.queue or self.active or self._mgr.has_jobs)

    @property
    def prefill_backlog(self) -> bool:
        """Whether requests are mid-prefill (chunks still queued)."""
        return self._mgr.has_jobs

    @property
    def in_flight(self) -> int:
        """Requests holding pool resources: decoding plus mid-prefill."""
        return len(self.active) + len(self._mgr.jobs)

    @property
    def prefill_backlog_tokens(self) -> int:
        """Prompt tokens queued for ingestion and not yet chunked through —
        the backlog the router's TTFT napkin charges new arrivals."""
        return self._mgr.pending_tokens

    @property
    def free_tokens(self) -> int:
        """Router load signal: the pool's admittable tokens less the
        prefill backlog still owed to it (a replica mid-ingest has the
        memory reserved but the compute pending)."""
        return max(self.pool.free_tokens - self._mgr.pending_tokens, 0)

    def validate(self, requests) -> None:
        """Reject up front what this scheduler or pool could never serve,
        so a mid-run rejection never throws away a drain's stats."""
        for req in requests:
            if len(req.prompt) > self.pool.max_len:
                raise ValueError(
                    f"request {req.rid}: prompt ({len(req.prompt)}) does "
                    f"not fit pool max_len {self.pool.max_len}")
            if not 0 <= req.top_k <= K_CAP:
                raise ValueError(
                    f"request {req.rid}: top_k {req.top_k} not in "
                    f"[0, {K_CAP}] — the sampler would silently clamp it")
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

    # -- sampling ----------------------------------------------------------
    def _draw(self, logits, styles) -> np.ndarray:
        """One sampler call over ``logits`` (rows, vocab); ``styles[i]`` is
        row i's (request, generation step) or None (greedy)."""
        n = len(styles)
        temps = np.zeros((n,), np.float32)
        topks = np.zeros((n,), np.int32)
        topps = np.ones((n,), np.float32)
        rids = np.zeros((n,), np.int32)
        steps = np.zeros((n,), np.int32)
        for i, style in enumerate(styles):
            if style is None:
                continue
            req, step = style
            temps[i], topks[i], topps[i] = req.temperature, req.top_k, \
                req.top_p
            rids[i], steps[i] = req.rid, step
        dev = logits.device
        return self.sampler(logits, *(to_device(a, dev) for a in (
            temps, topks, topps, rids, steps))).cpu().numpy()

    def _sample_rows(self, logits_last, entries) -> np.ndarray:
        """One draw per row; entries[i] styles row i (None rows greedy)."""
        if self.sampler is None or self.all_greedy:
            return _greedy(logits_last)
        return self._draw(logits_last, [
            None if en is None else (en.req, len(en.st.tokens))
            for en in entries])

    def _sample_rows_multi(self, logits, width) -> np.ndarray:
        """Draw ALL ``width`` speculated positions of every slot in one
        sampler call: row (slot, j) draws with the slot's request at
        generation step ``len(st.tokens) + j`` — the key the sequential
        sampler uses if the j-th draft is accepted, which makes accepted
        bursts equal one-at-a-time decoding.  (S, width, vocab) ->
        (S, width)."""
        if self.sampler is None or self.all_greedy:
            return _greedy(logits)
        S = logits.shape[0]
        styles = [None] * (S * width)
        for slot, en in self.active.items():
            for j in range(width):
                styles[slot * width + j] = (en.req, len(en.st.tokens) + j)
        return self._draw(logits.reshape(S * width, -1),
                          styles).reshape(S, width)

    # -- admission ---------------------------------------------------------
    def _probe_prefix(self, entry: _Entry):
        """Read-only shared-prefix cache probe for `entry` (None without a
        cache)."""
        cache = self.pool.prefix_cache
        if cache is None:
            return None
        return cache.probe(entry.pending_tokens())

    def can_admit(self, entry: _Entry) -> bool:
        """Whether the pool takes the entry's *cold* footprint now.  The
        probe rides on the entry, so the ``_admit`` right after a True
        answer attaches it without walking the keys again (a router's
        losing replicas overwrite it; the winner probes again in
        ``try_admit`` just before admitting, so it is never stale)."""
        entry.probe_hit = self._probe_prefix(entry)
        return self.pool.can_admit(entry.pending_len, tuple(self.active),
                                   hit=entry.probe_hit)

    def try_admit(self, entry: _Entry) -> bool:
        """Router-facing single-entry admission; False when full."""
        if not self.can_admit(entry):
            return False
        self._admit(entry)
        return True

    def admit_from_queue(self) -> None:
        """Admit from the queue head while the pool has room."""
        while self.queue and self.can_admit(self.queue[0]):
            self._admit(self.queue.popleft())

    def _admit(self, entry: _Entry) -> None:
        now = self.clock()
        req = entry.req
        if self.tracer is not None:
            # close the wait this request was in: "queued" (fresh) or
            # "resume" (after a preemption, perhaps on another replica)
            self.tracer.end_any(("resume", "queued"), req.rid, self.vclock.t,
                                pending_tokens=int(entry.pending_len))
        if req.top_k:
            # what the sampler will apply (a small vocabulary caps it)
            self._eff_topk[req.rid] = effective_top_k(
                req.top_k, self.vocab_size or req.top_k)
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
        # blocking: the un-cached remainder as one chunk, inline — priced
        # on the virtual clock at its chunk-equivalent cost, serially (it
        # stalls a router's whole lockstep round)
        self.vclock.advance_serial(-(-job.remaining // self.chunk_unit))
        self._finish_prefill(job, self._mgr.drain(job))

    def _finish_prefill(self, job, logits) -> None:
        """A job's final chunk landed: take the first token and either
        finish the request or activate its (already-populated) slot."""
        st, req = job.st, job.entry.req
        tok = int(self._sample_rows(logits[:, -1], [_Active(req, st, 0)])[0])
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
        if self.tracer is not None:
            self.tracer.begin("decode", req.rid, self.vclock.t,
                              replica=self.replica_id, slot=job.slot,
                              resident_tokens=int(
                                  self.pool.lengths[job.slot]))

    # -- preemption --------------------------------------------------------
    def _evict(self, slot: int) -> _Entry:
        """Free `slot` and return its request as a resumable entry."""
        en = self.active.pop(slot)
        en.st.slot = -1
        en.st.preemptions += 1
        if self.tracer is not None:
            v = self.vclock.t
            self.tracer.end("decode", en.st.rid, v, preempted=True,
                            tokens=len(en.st.tokens))
            self.tracer.instant("preempt", v, replica=self.replica_id,
                                rid=en.st.rid, slot=slot,
                                tokens=len(en.st.tokens))
            self.tracer.begin("resume", en.st.rid, v,
                              replica=self.replica_id)
        self._active_mask[slot] = 0
        self._last_tokens[slot, 0] = 0
        self.pool.free(slot)                 # returns its pages
        return _Entry(en.req, en.st)

    def _preempt(self, slot: int) -> None:
        """Evict `slot` and re-queue its request at the front."""
        self.queue.appendleft(self._evict(slot))
        self._preemptions += 1

    def _requeue_job(self, job) -> None:
        """Re-queue an evicted mid-prefill job at the queue front.  A
        fresh job restarts from scratch; a resume job keeps its result."""
        st = job.st if job.st.tokens else None
        if st is not None:
            st.slot = -1
            st.preemptions += 1
        if self.tracer is not None:
            rid = job.entry.req.rid
            v = self.vclock.t
            self.tracer.instant("preempt", v, replica=self.replica_id,
                                rid=rid, mid_prefill=True,
                                ingested=int(job.done))
            self.tracer.begin("resume", rid, v, replica=self.replica_id)
        self.queue.appendleft(_Entry(job.entry.req, st))
        self._preemptions += 1

    # -- one iteration -----------------------------------------------------
    def step(self, evict_on_starvation: bool = False) -> list:
        """One scheduler tick: ingest at most ``prefill_chunk`` queued
        prompt tokens, then one slot-wise decode over the active set.

        Starvation preempts mid-prefill jobs first (youngest), then the
        youngest in-flight request until the step fits.  When the *sole*
        active request starves, the pool can never make progress alone:
        raise ``PoolExhausted``, or — under a router
        (``evict_on_starvation``) — hand the evicted entry back for
        re-routing to a replica that can hold it.  Returns the evicted
        entries (empty on the single-engine path).
        """
        chunked = 0
        if self._mgr.has_jobs:
            self._peak = max(self._peak, self.in_flight)
            finished, chunked = self._mgr.tick(self.vclock)
            for job, logits in finished:
                self._finish_prefill(job, logits)
        if not self.active:
            return []
        evicted = []
        while True:
            starved = self.pool.prepare_decode(sorted(self.active))
            if not starved:
                break
            if self._mgr.has_jobs:
                self._requeue_job(self._mgr.evict_newest())
                continue
            if len(self.active) == 1:
                (slot,) = self.active
                if not evict_on_starvation:
                    raise PoolExhausted(
                        f"page starvation mid-decode: request "
                        f"{self.active[slot].req.rid} holds every page and "
                        f"still needs another — the page pool is too "
                        f"small for it")
                evicted.append(self._evict(slot))
                self._preemptions += 1
                return evicted               # nothing left to decode
            victim = max(self.active,
                         key=lambda sl: (self.active[sl].admit_step,
                                         self.active[sl].req.rid))
            self._preempt(victim)
        self._peak = max(self._peak, self.in_flight)
        self._peak_resident = max(self._peak_resident,
                                  int(self.pool.lengths.sum()))
        if self.spec_k:
            self._spec_step(chunked)
            return evicted
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
        rows = [self.active.get(i) for i in range(self.pool.num_slots)]
        toks = self._sample_rows(logits[:, -1], rows)
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
                if self.tracer is not None:
                    self.tracer.end("decode", st.rid, vnow,
                                    tokens=len(st.tokens))
        return evicted

    # -- speculative decode -------------------------------------------------
    def _spec_step(self, chunked: int) -> None:
        """One draft-then-verify tick over the active set.

        Per slot: the drafter proposes k tokens from the slot's history;
        the verify step scores all k+1 positions (pending token + drafts)
        in one call; every position is drawn with the sequential
        sampler's own ``(rid, step)`` key; the slot accepts the longest
        prefix of draws matching its drafts — exactly what one-at-a-time
        decoding would emit.  ``prepare_decode`` granted the next token's
        position; ``grow_for_burst`` backs as much of the burst as free
        pages allow, acceptance is capped at the backed count, and writes
        past it land in the junk page 0.  The verify step leaves the
        device index alone: ``pool.sync_index`` uploads the host lengths
        once per tick.
        """
        S = self.pool.num_slots
        k = self.spec_k
        tok_mat = np.zeros((S, k + 1), np.int32)
        caps = np.zeros((S,), np.int64)
        drafts: dict[int, list] = {}
        for slot, en in self.active.items():
            hist = np.asarray(en.req.prompt).tolist() + en.st.tokens
            d = self.drafter.draft(hist, k)
            drafts[slot] = d
            tok_mat[slot, 0] = self._last_tokens[slot, 0]
            tok_mat[slot, 1:] = d
            caps[slot] = self.pool.grow_for_burst(slot, k + 1)
        device = self.pool.device
        logits, new_cache = self.verify_fn(
            self.pool.cache, to_device(tok_mat, device),
            to_device(self._active_mask, device), *self.pool.decode_extras())
        self.pool.adopt(new_cache)
        self.vclock.advance(1)
        self._steps += 1
        self._busy += len(self.active)
        if chunked:
            self._overlap += 1
        toks = self._sample_rows_multi(logits, k + 1)
        now = self.clock()
        vnow = self.vclock.t
        for slot, en in list(self.active.items()):
            st = en.st
            d = drafts[slot]
            cap = int(caps[slot])        # >= 1: prepare_decode granted it
            emitted = 0
            j = 0
            finished = False
            while True:
                tok = int(toks[slot, j])
                st.tokens.append(tok)
                emitted += 1
                if len(st.tokens) >= st.max_new_tokens or \
                        tok == self.eos_id:
                    finished = True
                    break
                # no draft past position k to check; the next query
                # position is not backed; or the draft fed at j + 1 is not
                # what sequential decoding would have fed
                if j >= k or emitted >= cap or tok != d[j]:
                    break
                j += 1
            self._spec_verifies += 1
            self._spec_drafted += k
            self._spec_accepted += emitted - 1
            if self.tracer is not None:
                self.tracer.span("spec_verify", st.rid, vnow - 1, vnow,
                                 replica=self.replica_id, slot=slot,
                                 k=k, emitted=emitted,
                                 accepted=emitted - 1, backed=cap)
            self.pool.set_length(slot,
                                 int(self.pool.lengths[slot]) + emitted)
            if finished:
                st.t_done = now
                st.v_done = vnow
                self.done.append(st)
                del self.active[slot]
                self._active_mask[slot] = 0
                self._last_tokens[slot, 0] = 0
                self.pool.free(slot)
                if self.tracer is not None:
                    self.tracer.end("decode", st.rid, vnow,
                                    tokens=len(st.tokens))
            else:
                self._last_tokens[slot, 0] = int(toks[slot, emitted - 1])
        self.pool.sync_index()

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
        pc = self.pool.prefix_cache
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
            prefix_hits=pc.hits if pc else 0,
            prefix_misses=pc.misses if pc else 0,
            prefill_tokens_saved=pc.tokens_saved if pc else 0,
            prefix_evictions=pc.evictions if pc else 0,
            spec_verify_steps=self._spec_verifies,
            spec_drafted_tokens=self._spec_drafted,
            spec_accepted_tokens=self._spec_accepted,
            total_vsteps=self.vclock.t - self._v0,
            effective_top_k=dict(self._eff_topk))

    # -- main loop ---------------------------------------------------------
    def run(self, requests) -> ServeStats:
        """Drain a trace.  Closed-loop traces (every ``arrival_vstep`` 0)
        queue everything up front; open-loop traces release each request
        once the virtual clock reaches its arrival, fast-forwarding an
        idle pool to the next arrival."""
        requests = list(requests)
        self.validate(requests)
        # all-greedy traces skip the sampler (argmax is its temperature-0
        # / top_k-1 case)
        self.all_greedy = all(r.temperature <= 0 or r.top_k == 1
                              for r in requests)
        self.reset()
        # stable sort: ties (and the all-zero closed loop) keep trace order
        pending = deque(sorted((_Entry(r) for r in requests),
                               key=lambda en: en.req.arrival_vstep))
        while pending or self.has_work:
            while pending and self._v0 + pending[0].req.arrival_vstep \
                    <= self.vclock.t:
                en = pending.popleft()
                if self.tracer is not None:
                    # the wait starts at the arrival, not the release
                    self.tracer.begin(
                        "queued", en.req.rid,
                        self._v0 + en.req.arrival_vstep,
                        replica=self.replica_id,
                        prompt_len=len(en.req.prompt))
                self.queue.append(en)
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
        if self.tracer is not None:
            self.tracer.close(self.vclock.t)
        return self.stats()
