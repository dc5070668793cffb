"""ReplicaRouter — N serving engines behind one admission queue (port of
``repro/serving/router.py``).

The router fronts N ``ServeEngine`` replicas (mixed KV layouts allowed —
e.g. two paged and one contiguous) and owns admission:

* every request enters a router-level FIFO;
* a **routing policy** picks the replica for the queue head among the
  replicas that can admit it *right now* (``pool.can_admit``):

  - ``round_robin``      — ring order, skipping full replicas;
  - ``least_loaded``     — the replica with the most free KV *tokens*
                           (``Scheduler.free_tokens`` — worst-case slots
                           for contiguous pools, free pages for paged
                           ones, less the queued prefill backlog);
  - ``prefix_affinity``  — rendezvous (highest-random-weight) hash of the
                           prompt prefix, so likely-shared prefixes land
                           on the same replica and the mapping is *stable
                           under replica count*: adding a replica only
                           moves the keys that move to it.

* a replica that cannot take the head does not reject it — the request
  **waits in the router queue** (overflow queuing) until capacity frees;
* with chunked prefill (the engine default), dispatch only *reserves* a
  replica's slot/pages and queues the prompt's chunks there: the replica
  ingests at most one chunk budget per lockstep round while still taking
  its decode tick, so replica A's prompt ingestion overlaps B/C's decode;
* a replica's ``PoolExhausted``-grade starvation (the sole resident
  request needs a page the pool cannot supply) **re-routes** instead of
  rejecting: the scheduler evicts the request
  (``step(evict_on_starvation=True)``) and the router re-dispatches it,
  preferring a replica whose pool can actually hold its worst case.
  Re-prefill resume keeps the token stream exactly as an uninterrupted
  run would have produced it, so routing never changes output — an N=1
  router is token-identical to a bare ``ServeEngine``.

The run loop is lockstep and host-driven: each tick dispatches from the
router queue, then advances every busy replica by one slot-wise decode
step, one replica after another on the default stream.  Everything is
deterministic for a fixed trace, fleet, and policy.

Replica lists may repeat the *same* ``ServeEngine`` object: each run
builds a fresh pool + scheduler per replica slot, so duplicates share
steps and weights while keeping independent KV state — the cheap way to
spin up N homogeneous replicas on one card.  They also share the paged
kernel's scratch, which serves one stream at a time: replicas get no
streams or threads of their own.

**Open-loop traffic.**  Requests carry ``arrival_vstep`` (stamped by
``serving/trace.poisson_arrivals`` / ``bursty_arrivals``): the router
releases a request into its admission queue only once the fleet's shared
virtual step clock reaches the arrival, and an idle fleet with only
future arrivals fast-forwards the clock to the next one.  Because the
samplers key on (request id, generation step), admission *timing* never
changes token streams — an open-loop run is bit-identical to a
closed-loop replay of the same requests.

**SLO-aware admission** (``admission="reject"`` + ``slo_ttft_steps`` /
``slo_e2e_steps``): each round, queued fresh requests are held against
the tuner's TTFT napkin (``core/tuning.ttft_napkin_steps``: steps
already waited + the accepting replicas' prefill backlog share + the
request's own chunk cost); one predicted to blow its deadline is
rejected-with-reason (``RouterStats.rejected``) instead of queued
forever.  Preempted/rerouted entries already hold tokens and are never
rejected.  All deadlines are virtual steps — wall-clock never judges an
SLO.

**Autoscaling** (``autoscale=AutoscalePolicy(...)``): the fleet starts
at ``min_replicas`` serving replicas (the rest dormant) and, once per
``cooldown_rounds``, grows one replica when the queue is
``up_queue_depth`` deep or the queue head's predicted TTFT exceeds
``slo_headroom`` x the TTFT deadline; after ``drain_idle_rounds`` quiet
rounds it *drains* the highest-index serving replica — the replica
stops admitting but keeps stepping until its in-flight requests finish
(never dropped, never migrated mid-stream), then parks dormant.  Every
transition resizes the fleet's admission cap through
``runtime/elastic.rebalance_batch_size`` (the same resize scaffolding
training elasticity uses) and is recorded as an ``AutoscaleEvent``.

**Tracing** (``run(..., tracer=Tracer())``, ``serving/telemetry.py``):
each request's router wait (``queued``) and its spans on the replica
that serves it, one Chrome-trace process per replica, plus ring events
for reroutes, SLO rejections and autoscale transitions — host-side,
behind ``is not None`` guards, so a traced run's streams and counts
equal an untraced one's.

``RouterStats.to_metrics()`` flattens a drain into one flat dict of
gauge/counter snapshots a dashboard could scrape, a view over
``telemetry.ROUTER_SCHEMA`` (all values plain numbers, virtual-step
gauges NaN when nothing completed):

=============================  =======  ================================
key                            kind     meaning
=============================  =======  ================================
router_requests_completed      counter  requests fully served
router_requests_rejected       counter  SLO admission rejections
router_generated_tokens        counter  tokens emitted fleet-wide
router_goodput_tokens          counter  tokens from requests meeting SLO
router_slo_ttft_steps          gauge    TTFT deadline judged by (0=unset)
router_slo_e2e_steps           gauge    e2e deadline judged by (0=unset)
router_ttft_p50_steps          gauge    median TTFT, virtual steps
router_ttft_p99_steps          gauge    p99 TTFT, virtual steps
router_e2e_p50_steps           gauge    median e2e latency, virtual steps
router_e2e_p99_steps           gauge    p99 e2e latency, virtual steps
router_mean_ttft_steps         gauge    mean TTFT, virtual steps
router_total_vsteps            counter  shared clock at drain end
router_peak_in_flight          gauge    max concurrent requests
router_peak_replicas           gauge    max replicas serving/draining
router_reroutes                counter  starvation re-dispatches
router_autoscale_grows         counter  replicas activated
router_autoscale_drains        counter  drains initiated
router_load_imbalance          gauge    max/mean peak resident KV tokens
router_wall_s                  gauge    wall time (ADVISORY only)
router_tokens_per_s            gauge    wall throughput (ADVISORY only)
replica{i}_generated_tokens    counter  per-replica tokens
replica{i}_decode_steps        counter  per-replica scheduler ticks
replica{i}_peak_resident_kv    gauge    per-replica peak resident tokens
replica{i}_preemptions         counter  per-replica page-pressure evicts
replica{i}_occupancy           gauge    per-replica mean slot occupancy
=============================  =======  ================================
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import deque

import numpy as np

from repro_torch.core.tuning import ttft_napkin_steps
from repro_torch.runtime.elastic import rebalance_batch_size
from repro_torch.serving.pool import PoolExhausted
from repro_torch.serving.prefix_cache import prefix_key
from repro_torch.serving.sampling import K_CAP
from repro_torch.serving.scheduler import (RoundClock, Scheduler,
                                           VirtualClock, _Entry,
                                           percentile_steps)
from repro_torch.serving.telemetry import ROUTER_SCHEMA, MetricsRegistry

ROUTE_POLICIES = ("round_robin", "least_loaded", "prefix_affinity")
ADMISSION_MODES = ("queue", "reject")

@dataclasses.dataclass
class RejectedRequest:
    """An SLO admission rejection — returned instead of silent queueing."""
    rid: int
    reason: str
    v_reject: int                  # shared virtual clock at rejection
    predicted_ttft_steps: int      # the napkin figure that condemned it


@dataclasses.dataclass
class AutoscaleEvent:
    """One fleet-size transition, stamped on the shared virtual clock."""
    vstep: int
    action: str                    # "grow" | "drain" | "stop"
    replica: int
    serving: int                   # actively-admitting replicas after it
    per_replica_cap: int           # admission cap from rebalance_batch_size


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """Deterministic grow/drain policy for an elastic router fleet."""
    min_replicas: int = 1
    max_replicas: int = 0          # 0 = the whole fleet may activate
    up_queue_depth: int = 2        # queued requests that trigger a grow
    cooldown_rounds: int = 4       # min rounds between scaling decisions
    drain_idle_rounds: int = 8     # empty-queue rounds before a drain
    slo_headroom: float = 0.8      # grow when predicted TTFT > this x SLO


class _Autoscaler:
    """Replica lifecycle (active / draining / dormant) for one drain.

    Grow activates the lowest-index non-active replica (a draining one —
    still warm — beats a dormant one); drain marks the highest-index
    active replica: it leaves the accepting set but keeps stepping until
    its in-flight requests finish in place, then parks dormant.  Every
    transition re-derives the per-replica admission cap by pushing the
    fleet's slot budget through ``rebalance_batch_size`` — the same
    keep-the-global-batch resize semantics training elasticity uses.
    """

    def __init__(self, pol: AutoscalePolicy, scheds, shared, tracer=None):
        n = len(scheds)
        self.max_r = pol.max_replicas or n
        if not 1 <= pol.min_replicas <= self.max_r <= n:
            raise ValueError(
                f"autoscale needs 1 <= min_replicas {pol.min_replicas} <= "
                f"max_replicas {self.max_r} <= fleet size {n}")
        self.pol = pol
        self.scheds = scheds
        self.shared = shared
        self.state = ["active" if i < pol.min_replicas else "dormant"
                      for i in range(n)]
        self.fleet_slots = sum(s.pool.num_slots for s in scheds)
        self.events: list[AutoscaleEvent] = []
        self.tracer = tracer
        # a fresh fleet may scale immediately; cooldown gates *subsequent*
        # moves so one burst cannot slam the fleet to max in one round
        self.rounds_since_scale = pol.cooldown_rounds
        self.idle_rounds = 0
        self.per_cap, _ = rebalance_batch_size(
            self.fleet_slots, n, max(self.serving, 1), allow_shrink=True)

    @property
    def serving(self) -> int:
        return sum(1 for st in self.state if st == "active")

    @property
    def working(self) -> int:
        """Replicas doing work: admitting or draining (not dormant)."""
        return sum(1 for st in self.state if st != "dormant")

    def accepting(self) -> list[int]:
        return [i for i, st in enumerate(self.state) if st == "active"]

    def _scale(self, action: str, idx: int, new_state: str) -> None:
        old = max(self.serving, 1)
        self.state[idx] = new_state
        self.per_cap, _ = rebalance_batch_size(
            self.fleet_slots, old, max(self.serving, 1), allow_shrink=True)
        self.events.append(AutoscaleEvent(
            vstep=self.shared.t, action=action, replica=idx,
            serving=self.serving, per_replica_cap=self.per_cap))
        if self.tracer is not None:
            self.tracer.instant(f"autoscale_{action}", self.shared.t,
                                replica=idx, serving=self.serving,
                                per_replica_cap=self.per_cap)
        self.rounds_since_scale = 0

    def try_grow(self) -> bool:
        """Activate one more replica if the cap allows; False at max."""
        if self.serving >= self.max_r:
            return False
        for want in ("draining", "dormant"):
            for i, st in enumerate(self.state):
                if st == want:
                    self._scale("grow", i, "active")
                    return True
        return False

    def tick(self, queue_depth: int, predicted_ttft: int | None,
             slo_ttft_steps: int) -> None:
        """One per-round scaling decision (after dispatch, so the depth
        seen is what the current fleet genuinely could not place)."""
        self.rounds_since_scale += 1
        self.idle_rounds = 0 if queue_depth else self.idle_rounds + 1
        for i, st in enumerate(self.state):
            if st == "draining" and not self.scheds[i].has_work:
                # drained dry: park it (cooldown untouched — finishing a
                # drain is completion, not a new decision)
                self.state[i] = "dormant"
                self.events.append(AutoscaleEvent(
                    vstep=self.shared.t, action="stop", replica=i,
                    serving=self.serving, per_replica_cap=self.per_cap))
                if self.tracer is not None:
                    self.tracer.instant("autoscale_stop", self.shared.t,
                                        replica=i, serving=self.serving,
                                        per_replica_cap=self.per_cap)
        if self.rounds_since_scale < self.pol.cooldown_rounds:
            return
        if queue_depth:
            overloaded = queue_depth >= self.pol.up_queue_depth or (
                slo_ttft_steps > 0 and predicted_ttft is not None and
                predicted_ttft > self.pol.slo_headroom * slo_ttft_steps)
            if overloaded:
                self.try_grow()
            return
        if self.idle_rounds >= self.pol.drain_idle_rounds and \
                self.serving > self.pol.min_replicas:
            idx = max(i for i, st in enumerate(self.state)
                      if st == "active")
            self._scale("drain", idx, "draining")


def replay_peak_replicas(events, min_replicas: int) -> int:
    """Reconstruct ``RouterStats.peak_replicas`` from the AutoscaleEvent
    log alone — the audit that the event stream is complete: every fleet
    transition must appear, or the replayed peak diverges from the live
    counter.  Start state is ``min_replicas`` active (replicas 0..min-1,
    by construction); grow re-activates a draining replica or wakes a
    dormant one, drain moves active -> draining (still working), stop
    parks a drained-dry replica dormant."""
    active = set(range(min_replicas))
    draining: set = set()
    peak = len(active)
    for e in events:
        if e.action == "grow":
            draining.discard(e.replica)
            active.add(e.replica)
        elif e.action == "drain":
            active.discard(e.replica)
            draining.add(e.replica)
        elif e.action == "stop":
            draining.discard(e.replica)
        else:
            raise ValueError(f"unknown autoscale action {e.action!r}")
        if len(active) != e.serving:
            raise ValueError(
                f"event log inconsistent at vstep {e.vstep}: replay has "
                f"{len(active)} serving, event recorded {e.serving}")
        peak = max(peak, len(active) + len(draining))
    return peak


def prefix_replica(prompt, n_replicas: int, prefix_len: int = 8) -> int:
    """Rendezvous hash of the prompt prefix over ``n_replicas``.

    Every (prefix, replica) pair gets an independent deterministic score
    (SHA-256 — stable across processes, unlike ``hash()``); the replica
    with the highest score wins.  Growing the fleet from N to N+1 only
    ever moves a prefix *to the new replica*, never between survivors.
    The hashed bytes are ``prefix_key`` — the same key the per-replica
    prefix KV cache uses, so a prompt that routes by its prefix lands on
    the replica whose cache holds that prefix.
    """
    if n_replicas < 1:
        raise ValueError(n_replicas)
    key = prefix_key(prompt, prefix_len)
    return max(range(n_replicas), key=lambda i: _affinity_score(key, i))


def _affinity_score(key: bytes, replica: int) -> int:
    h = hashlib.sha256(key + replica.to_bytes(4, "little")).digest()
    return int.from_bytes(h[:8], "little")


@dataclasses.dataclass
class RouterStats:
    """Fleet-level drain statistics plus the per-replica breakdown.

    Latency percentiles, goodput, and every SLO judgement are derived
    from the shared **virtual step clock** only; ``wall_s`` and
    ``tokens_per_s`` are advisory wall-clock figures a regression gate
    must never enforce."""
    results: list                  # merged RequestResults, sorted by rid
    replica_stats: list            # per-replica ServeStats
    replica_of: dict               # rid -> index of the completing replica
    wall_s: float
    reroutes: int = 0              # starvation evictions re-dispatched
    peak_in_flight: int = 0        # max concurrent requests, fleet-wide
    rejected: list = dataclasses.field(default_factory=list)
    #                                SLO admission RejectedRequests
    autoscale_events: list = dataclasses.field(default_factory=list)
    peak_replicas: int = 0         # max replicas serving or draining
    total_vsteps: int = 0          # shared virtual clock at drain end
    slo_ttft_steps: int = 0        # deadlines goodput was judged by
    slo_e2e_steps: int = 0         #   (0 = unset: every completion counts)

    @property
    def generated_tokens(self) -> int:
        return sum(len(r.tokens) for r in self.results)

    @property
    def tokens_per_s(self) -> float:
        return self.generated_tokens / max(self.wall_s, 1e-9)

    @property
    def p50_ttft_steps(self) -> float:
        return percentile_steps(
            [r.ttft_steps for r in self.results if r.v_first >= 0], 50)

    @property
    def p99_ttft_steps(self) -> float:
        return percentile_steps(
            [r.ttft_steps for r in self.results if r.v_first >= 0], 99)

    @property
    def p50_e2e_steps(self) -> float:
        return percentile_steps(
            [r.e2e_steps for r in self.results if r.v_done >= 0], 50)

    @property
    def p99_e2e_steps(self) -> float:
        return percentile_steps(
            [r.e2e_steps for r in self.results if r.v_done >= 0], 99)

    @property
    def goodput_tokens(self) -> int:
        """Tokens from requests that met the virtual-step deadlines —
        the figure an SLO-bound deployment actually gets paid for."""
        return sum(len(r.tokens) for r in self.results
                   if r.meets_slo(self.slo_ttft_steps, self.slo_e2e_steps))

    @property
    def autoscale_grows(self) -> int:
        return sum(1 for e in self.autoscale_events if e.action == "grow")

    @property
    def autoscale_drains(self) -> int:
        return sum(1 for e in self.autoscale_events if e.action == "drain")

    def to_metrics(self) -> dict:
        """Flat gauge/counter snapshot (the module docstring's key table),
        a view over ``telemetry.ROUTER_SCHEMA``: a key the schema does not
        declare, or a declared key left unset, raises.  The wall-clock
        figures are advisory: never gate on them."""
        reg = MetricsRegistry(ROUTER_SCHEMA)
        reg.set("router_requests_completed", len(self.results))
        reg.set("router_requests_rejected", len(self.rejected))
        reg.set("router_generated_tokens", self.generated_tokens)
        reg.set("router_goodput_tokens", self.goodput_tokens)
        reg.set("router_slo_ttft_steps", self.slo_ttft_steps)
        reg.set("router_slo_e2e_steps", self.slo_e2e_steps)
        reg.set("router_ttft_p50_steps", self.p50_ttft_steps)
        reg.set("router_ttft_p99_steps", self.p99_ttft_steps)
        reg.set("router_e2e_p50_steps", self.p50_e2e_steps)
        reg.set("router_e2e_p99_steps", self.p99_e2e_steps)
        reg.set("router_mean_ttft_steps", self.mean_ttft_steps)
        reg.set("router_total_vsteps", self.total_vsteps)
        reg.set("router_peak_in_flight", self.peak_in_flight)
        reg.set("router_peak_replicas", self.peak_replicas)
        reg.set("router_reroutes", self.reroutes)
        reg.set("router_autoscale_grows", self.autoscale_grows)
        reg.set("router_autoscale_drains", self.autoscale_drains)
        reg.set("router_load_imbalance", self.imbalance)
        reg.set("router_wall_s", self.wall_s)
        reg.set("router_tokens_per_s", self.tokens_per_s)
        for i, s in enumerate(self.replica_stats):
            reg.set(f"replica{i}_generated_tokens", s.generated_tokens)
            reg.set(f"replica{i}_decode_steps", s.decode_steps)
            reg.set(f"replica{i}_peak_resident_kv", s.peak_resident_tokens)
            reg.set(f"replica{i}_preemptions", s.preemptions)
            reg.set(f"replica{i}_occupancy", s.occupancy)
        return reg.snapshot()

    @property
    def imbalance(self) -> float:
        """Load imbalance: max/mean of per-replica peak resident KV tokens
        (1.0 = perfectly balanced; only meaningful for N > 1).  A fleet
        that saw no traffic at all has no balance to speak of — that is
        ``nan``, not a fake-perfect 1.0 a dashboard would wave through."""
        peaks = [s.peak_resident_tokens for s in self.replica_stats]
        mean = sum(peaks) / max(len(peaks), 1)
        return max(peaks) / mean if mean > 0 else float("nan")

    @property
    def mean_ttft_steps(self) -> float:
        """Mean time-to-first-token on the fleet's shared virtual step
        clock — the deterministic proxy blocking-vs-chunked prefill is
        compared on."""
        ttfts = [r.ttft_steps for r in self.results if r.v_first >= 0]
        return float(np.mean(ttfts)) if ttfts else 0.0

    @property
    def prefill_chunks(self) -> int:
        return sum(s.prefill_chunks for s in self.replica_stats)

    @property
    def prefill_tokens(self) -> int:
        """Prompt tokens the fleet actually ran through chunk steps —
        cache hits shrink this without touching the token streams."""
        return sum(s.prefill_tokens for s in self.replica_stats)

    @property
    def prefix_hits(self) -> int:
        return sum(s.prefix_hits for s in self.replica_stats)

    @property
    def prefix_misses(self) -> int:
        return sum(s.prefix_misses for s in self.replica_stats)

    @property
    def prefill_tokens_saved(self) -> int:
        return sum(s.prefill_tokens_saved for s in self.replica_stats)

    @property
    def prefix_hit_rate(self) -> float:
        n = self.prefix_hits + self.prefix_misses
        return self.prefix_hits / n if n else 0.0

    @property
    def overlap_steps(self) -> int:
        """Scheduler ticks, fleet-wide, that ingested a prompt chunk AND
        decoded — the overlap chunked prefill exists to create."""
        return sum(s.overlap_steps for s in self.replica_stats)

    @property
    def spec_verify_steps(self) -> int:
        return sum(s.spec_verify_steps for s in self.replica_stats)

    @property
    def spec_drafted_tokens(self) -> int:
        return sum(s.spec_drafted_tokens for s in self.replica_stats)

    @property
    def spec_accepted_tokens(self) -> int:
        return sum(s.spec_accepted_tokens for s in self.replica_stats)

    @property
    def accepted_per_verify(self) -> float:
        """Fleet-wide tokens emitted per speculative verify event — the
        same >1-means-spec-pays figure as ``ServeStats``, summed over
        replicas before the ratio so busy and idle replicas weight by
        their actual verify traffic."""
        if not self.spec_verify_steps:
            return 0.0
        return ((self.spec_verify_steps + self.spec_accepted_tokens)
                / self.spec_verify_steps)

    @property
    def effective_top_k(self) -> dict:
        """rid -> effective top-k, merged across replicas (a rid completes
        on exactly one replica, so the union is disjoint)."""
        out: dict = {}
        for s in self.replica_stats:
            out.update(s.effective_top_k)
        return out

    def summary(self) -> str:
        per = ", ".join(f"r{i}:{s.generated_tokens}t"
                        for i, s in enumerate(self.replica_stats))
        re = f", {self.reroutes} reroutes" if self.reroutes else ""
        if self.rejected:
            re += f", {len(self.rejected)} SLO-rejected"
        if self.autoscale_events:
            re += (f", autoscale {self.autoscale_grows} grows/"
                   f"{self.autoscale_drains} drains "
                   f"(peak {self.peak_replicas} replicas)")
        if self.slo_ttft_steps or self.slo_e2e_steps:
            re += (f", goodput {self.goodput_tokens}t under SLO "
                   f"(p99 ttft {self.p99_ttft_steps:.0f} vsteps)")
        if self.prefix_hits:
            re += (f", {self.prefix_hits} prefix hits "
                   f"({self.prefill_tokens_saved}t prefill saved)")
        if self.spec_verify_steps:
            re += (f", spec {self.accepted_per_verify:.2f} tok/verify "
                   f"({self.spec_accepted_tokens}/"
                   f"{self.spec_drafted_tokens} drafts accepted)")
        return (f"{len(self.results)} requests over "
                f"{len(self.replica_stats)} replicas, "
                f"{self.generated_tokens} tokens in {self.wall_s:.3f}s -> "
                f"{self.tokens_per_s:.1f} tok/s fleet | peak "
                f"{self.peak_in_flight} in flight, imbalance "
                f"{self.imbalance:.2f}{re} | {per}")


class ReplicaRouter:
    """Route request traces across N ``ServeEngine`` replicas."""

    def __init__(self, engines, policy: str = "least_loaded",
                 prefix_len: int = 8, log=print,
                 # advisory wall_s only; gated metrics are vstep-clocked
                 clock=time.perf_counter):  # easeylint: allow[wall-clock]
        engines = list(engines)
        if not engines:
            raise ValueError("router needs at least one replica engine")
        if policy not in ROUTE_POLICIES:
            raise ValueError(f"policy {policy!r} not in {ROUTE_POLICIES}")
        names = {e.cfg.name for e in engines}
        if len(names) > 1:
            raise ValueError(
                f"replicas must share one architecture, got {sorted(names)}")
        lens = {e.max_len for e in engines}
        if len(lens) > 1:
            # max_len clamps a request's generation budget at admission
            # (sticky on the result), so a mixed-max_len fleet would make
            # output depend on which replica the policy picked
            raise ValueError(
                f"replicas must share one max_len, got {sorted(lens)}")
        # same failure class: eos decides when a stream stops, the seed
        # decides weights and sampler draws — either differing per replica
        # would make output depend on the routing decision
        eos = {e.eos_id for e in engines}
        if len(eos) > 1:
            raise ValueError(
                f"replicas must share one eos_id, got {sorted(map(str, eos))}")
        seeds = {e.seed for e in engines}
        if len(seeds) > 1:
            raise ValueError(
                f"replicas must share one seed, got {sorted(seeds)}")
        self.engines = engines
        self.policy = policy
        self.prefix_len = prefix_len
        self.log = log
        self.clock = clock

    @classmethod
    def build(cls, arch: str = "deepseek-7b-smoke",
              target: str | None = None, replicas: int = 2,
              kv_layout: str = "paged", num_slots: int = 8,
              max_len: int = 128, seed: int = 0, eos_id: int | None = None,
              policy: str = "least_loaded", page_size: int = 0,
              num_pages: int = 0, prefill_chunk: int | None = None,
              prefix_cache: bool = False, kv_kernel: str = "auto",
              spec_k: int | None = 0, drafter=None,
              repetitiveness: float = 0.0, log=print,
              device=None) -> "ReplicaRouter":
        """Build an N-replica fleet, splitting the tuner budget N ways.

        ``kv_layout`` may be comma-separated (``"paged,contiguous"``) and
        is cycled across replica slots — one engine is built per distinct
        layout and *shared* between its slots (steps and weights once;
        pools stay per-replica).  Like the engine, the fleet runs on the
        GPU unless ``device="cpu"``.
        """
        from repro_torch.serving.engine import ServeEngine
        if replicas < 1:
            raise ValueError(f"replicas {replicas} < 1")
        layouts = [l.strip() for l in kv_layout.split(",") if l.strip()]
        if not layouts:
            raise ValueError(f"no kv layout in {kv_layout!r}")
        built: dict[str, object] = {}
        fleet = []
        for i in range(replicas):
            lay = layouts[i % len(layouts)]
            if lay not in built:
                built[lay] = ServeEngine(
                    arch=arch, target=target, num_slots=num_slots,
                    max_len=max_len, seed=seed, eos_id=eos_id,
                    kv_layout=lay, page_size=page_size, num_pages=num_pages,
                    replicas=replicas, prefill_chunk=prefill_chunk,
                    # mixed fleets: the cache and the paged decode kernel
                    # only apply to paged slots
                    prefix_cache=prefix_cache and lay == "paged",
                    kv_kernel=kv_kernel if lay == "paged" else "auto",
                    spec_k=spec_k, drafter=drafter,
                    repetitiveness=repetitiveness, log=log, device=device)
            fleet.append(built[lay])
        return cls(fleet, policy=policy, log=log)

    # -- validation ---------------------------------------------------------
    def _validate(self, requests, scheds) -> None:
        """Router-level fail-fast: a request is serveable if *some* replica
        can ever hold it (the single-engine rules, any-replica quantified)."""
        for req in requests:
            if not 0 <= req.top_k <= K_CAP:
                raise ValueError(
                    f"request {req.rid}: top_k {req.top_k} not in "
                    f"[0, {K_CAP}]")
            if not 0.0 < req.top_p <= 1.0:
                raise ValueError(
                    f"request {req.rid}: top_p {req.top_p} not in (0, 1]")
            if all(len(req.prompt) > s.pool.max_len for s in scheds):
                raise ValueError(
                    f"request {req.rid}: prompt ({len(req.prompt)}) does "
                    f"not fit any replica's max_len")
            en = _Entry(req)
            if not any(s.pool.can_ever_serve(s.worst_resident(en))
                       for s in scheds):
                raise PoolExhausted(
                    f"request {req.rid} needs "
                    f"{min(s.worst_resident(en) for s in scheds)} resident "
                    f"KV tokens but no replica can ever hold that many")

    # -- policy -------------------------------------------------------------
    def _pick(self, entry: _Entry, ready: list[int], scheds) -> int:
        if self.policy == "round_robin":
            n = len(scheds)
            ready_set = set(ready)
            for off in range(n):
                i = (self._rr + off) % n
                if i in ready_set:
                    self._rr = (i + 1) % n
                    return i
        if self.policy == "least_loaded":
            # most free KV tokens wins; ties go to the lowest index.  The
            # scheduler-level figure charges a replica's queued prefill
            # chunks against its pool capacity, so a replica mid-ingest
            # does not masquerade as free
            return max(ready, key=lambda i: (scheds[i].free_tokens, -i))
        # prefix_affinity: highest rendezvous score among the admittable —
        # the preferred replica when it has room, its runner-up otherwise.
        # Keyed by prefix_key, the same bytes the per-replica prefix KV
        # cache hashes, so sharers colocate with their cached run.
        key = prefix_key(entry.req.prompt, self.prefix_len)
        return max(ready, key=lambda i: _affinity_score(key, i))

    # -- dispatch ------------------------------------------------------------
    def _worst_for(self, sched, entry) -> int:
        """Residency bound used to place `entry` on `sched`'s replica.

        A starvation-evicted (rerouted) entry just proved a pool holding
        nothing else cannot finish it, so it must land where its FULL
        remaining generation fits — the optimistic eos bound
        (``worst_resident`` = pending only) would keep the starved
        replica "feasible" and let the fleet grind one token per
        re-prefill bounce instead of re-routing or failing fast."""
        if entry.rerouted:
            return min(entry.pending_len + entry.remaining_new() - 1,
                       sched.pool.max_len)
        return sched.worst_resident(entry)

    def _dispatch(self, queue: deque, scheds, accepting,
                  cap: int | None = None) -> bool:
        """Admit from the queue head while some accepting replica has room
        (head-of-line, like the single-engine scheduler).  ``cap`` is the
        autoscaler's per-replica in-flight admission cap (from
        ``rebalance_batch_size``).  Returns whether anything was admitted."""
        progressed = False
        while queue:
            entry = queue[0]
            feasible = [i for i in accepting
                        if scheds[i].pool.can_ever_serve(
                            self._worst_for(scheds[i], entry))]
            if not any(
                    s.pool.can_ever_serve(self._worst_for(s, entry))
                    for s in scheds):
                raise PoolExhausted(
                    f"request {entry.req.rid} ({entry.pending_len} resident "
                    f"tokens) can no longer fit any replica's pool")
            ready = [i for i in feasible
                     if (cap is None or scheds[i].in_flight < cap)
                     and scheds[i].can_admit(entry)]
            if not ready:
                return progressed
            idx = self._pick(entry, ready, scheds)
            if not scheds[idx].try_admit(entry):
                return progressed   # unreachable: `ready` just re-checked
            queue.popleft()
            progressed = True
        return progressed

    # -- SLO admission --------------------------------------------------------
    def _napkin(self, entry, scheds, accepting, shared,
                ahead_chunks: int = 0) -> int:
        """Predicted TTFT (virtual steps) for a queued entry: waited so
        far + the accepting replicas' prefill-backlog share + its own
        chunk cost — the tuner's napkin, fed live fleet state."""
        unit = max(min(scheds[i].chunk_unit for i in accepting), 1)
        backlog = sum(-(-scheds[i].prefill_backlog_tokens // unit)
                      for i in accepting)
        waited = max(shared.t - entry.req.arrival_vstep, 0)
        share = -(-(backlog + ahead_chunks) // len(accepting))
        return ttft_napkin_steps(entry.pending_len, unit,
                                 backlog_chunks=share, waited_steps=waited)

    def _reject_slo(self, queue: deque, scheds, accepting, shared,
                    rejected: list, slo_ttft_steps: int,
                    slo_e2e_steps: int, tracer=None) -> None:
        """Reject-with-reason every queued FRESH request whose predicted
        TTFT/e2e blows its deadline (preempted or rerouted entries
        already emitted tokens — those are never rejected; they resume).
        The napkin charges each entry the queue ahead of it, so one
        hopeless deep queue rejects its tail, not just its head."""
        if not accepting:
            return
        unit = max(min(scheds[i].chunk_unit for i in accepting), 1)
        kept: list = []
        ahead = 0                     # chunk-equivalents queued ahead
        while queue:
            en = queue.popleft()
            if en.st is not None or en.rerouted:
                kept.append(en)
                ahead += -(-en.pending_len // unit)
                continue
            predicted = self._napkin(en, scheds, accepting, shared,
                                     ahead_chunks=ahead)
            reason = None
            if slo_ttft_steps > 0 and predicted > slo_ttft_steps:
                reason = (f"predicted TTFT {predicted} vsteps > slo_ttft "
                          f"{slo_ttft_steps}")
            elif slo_e2e_steps > 0 and \
                    predicted + en.remaining_new() > slo_e2e_steps:
                reason = (f"predicted e2e "
                          f"{predicted + en.remaining_new()} vsteps > "
                          f"slo_e2e {slo_e2e_steps}")
            if reason is None:
                kept.append(en)
                ahead += -(-en.pending_len // unit)
            else:
                rejected.append(RejectedRequest(
                    rid=en.req.rid, reason=reason, v_reject=shared.t,
                    predicted_ttft_steps=predicted))
                if tracer is not None:
                    tracer.end("queued", en.req.rid, shared.t,
                               rejected=True)
                    tracer.instant("reject", shared.t, rid=en.req.rid,
                                   predicted_ttft_steps=predicted)
        queue.extend(kept)

    # -- main loop -----------------------------------------------------------
    def run(self, requests, policy: str = "continuous",
            prefill_chunk: int | None = None,
            prefix_cache: bool | None = None,
            slo_ttft_steps: int = 0, slo_e2e_steps: int = 0,
            admission: str = "queue",
            autoscale: AutoscalePolicy | None = None,
            tracer=None) -> RouterStats:
        """Drain `requests` across the fleet under scheduling `policy`
        (``continuous`` refills replicas between steps; ``static`` gang-
        fills only idle replicas).  Fresh pools per run, like the engine.

        ``prefill_chunk`` overrides every replica's prompt-ingestion
        grain (None: each engine's own setting; 0: blocking full-prompt
        prefill at dispatch — the old fleet-stalling cadence, kept as
        the TTFT baseline).  ``prefix_cache`` likewise overrides the
        per-replica shared-prefix KV cache (None: each engine's own
        setting) — caches are per replica, which composes with
        ``prefix_affinity`` colocating sharers on one replica.  In a
        mixed-layout fleet the override applies to the paged replicas
        only; contiguous pools have no pages to share.

        The fleet shares one virtual step clock: blocking prefills at
        dispatch advance it serially (they run one after another on the
        host thread, stalling every replica), while each round's
        parallel work advances it by the busiest replica's invocation
        count — replicas are independent hosts, so a round costs the max,
        not the sum.

        Open loop: requests with ``arrival_vstep > 0`` join the router
        queue only once the shared clock reaches their arrival.
        ``slo_ttft_steps`` / ``slo_e2e_steps`` set the virtual-step
        deadlines goodput is judged by; with ``admission="reject"`` a
        queued request predicted (TTFT napkin) to blow them is rejected
        with a reason instead of waiting forever.  ``autoscale`` hands
        replica lifecycle to an ``AutoscalePolicy`` (grow on queue
        depth / SLO headroom, drain when quiet) — continuous policy
        only, since a draining replica must keep stepping while closed
        to admission.

        ``tracer`` (a ``serving.telemetry.Tracer``) records per-request
        spans (one Chrome-trace "process" per replica, one "thread" per
        slot) and fleet ring events — host-side only, behind None-guards,
        so tracing cannot perturb a single token."""
        requests = list(requests)
        if admission not in ADMISSION_MODES:
            raise ValueError(
                f"admission {admission!r} not in {ADMISSION_MODES}")
        if admission == "reject" and not (slo_ttft_steps or slo_e2e_steps):
            raise ValueError(
                "admission='reject' needs slo_ttft_steps or slo_e2e_steps "
                "— with no deadline there is nothing to reject against")
        if autoscale is not None and policy != "continuous":
            raise ValueError(
                "autoscale requires the continuous scheduling policy (a "
                "draining replica keeps stepping while closed to admission)")
        shared = VirtualClock()
        scheds = [Scheduler(e.make_pool(prefix_cache=(
                                prefix_cache if e.kv_layout == "paged"
                                else None)),
                            e.decode_fn, e.chunk_fn,
                            eos_id=e.eos_id, policy=policy,
                            sampler=e.sampler, clock=self.clock,
                            prefill_chunk=(e.prefill_chunk
                                           if prefill_chunk is None
                                           else prefill_chunk),
                            prefill_chunk_unit=e.chunk_unit,
                            verify_fn=e.verify_fn if e.spec_k else None,
                            spec_k=e.spec_k, drafter=e.drafter,
                            vocab_size=e.cfg.vocab_size,
                            slo_ttft_steps=slo_ttft_steps,
                            slo_e2e_steps=slo_e2e_steps,
                            vclock=RoundClock(shared), replica_id=i,
                            tracer=tracer)
                  for i, e in enumerate(self.engines)]
        self._validate(requests, scheds)
        all_greedy = all(r.temperature <= 0 or r.top_k == 1
                         for r in requests)
        t0 = self.clock()
        for s in scheds:
            s.all_greedy = all_greedy
            s.reset(t0)
        auto = None if autoscale is None else \
            _Autoscaler(autoscale, scheds, shared, tracer=tracer)
        # open loop: stable arrival sort — ties (and the all-zero closed
        # loop) keep trace order, so closed-loop behaviour is unchanged
        pending: deque = deque(sorted(
            (_Entry(r) for r in requests),
            key=lambda en: en.req.arrival_vstep))
        queue: deque = deque()
        rejected: list = []
        self._rr = 0
        reroutes = 0
        peak_in_flight = 0
        peak_replicas = auto.working if auto else len(scheds)
        while pending or queue or \
                any(s.active or s.prefill_backlog for s in scheds):
            # release every request whose arrival the clock has reached
            while pending and pending[0].req.arrival_vstep <= shared.t:
                en = pending.popleft()
                if tracer is not None:
                    # the router wait starts at the arrival and ends when a
                    # replica admits it (or SLO admission rejects it)
                    tracer.begin("queued", en.req.rid, en.req.arrival_vstep,
                                 prompt_len=len(en.req.prompt))
                queue.append(en)
            if auto is not None:
                accepting = auto.accepting()
                if policy == "static":      # unreachable (validated above)
                    accepting = [i for i in accepting
                                 if not (scheds[i].active or
                                         scheds[i].prefill_backlog)]
            elif policy == "continuous":
                accepting = list(range(len(scheds)))
            else:      # static: gang-fill only replicas idle at phase start
                # (mid-prefill counts as busy — its gang is still forming)
                accepting = [i for i, s in enumerate(scheds)
                             if not (s.active or s.prefill_backlog)]
            if admission == "reject" and queue:
                self._reject_slo(queue, scheds, accepting, shared,
                                 rejected, slo_ttft_steps, slo_e2e_steps,
                                 tracer=tracer)
            progressed = self._dispatch(
                queue, scheds, accepting,
                cap=auto.per_cap if auto is not None else None)
            if auto is not None:
                # scale on the leftover depth: what dispatch could not
                # place with the current fleet is the genuine pressure
                head_pred = self._napkin(queue[0], scheds, auto.accepting(),
                                         shared) \
                    if queue and auto.accepting() else None
                auto.tick(len(queue), head_pred, slo_ttft_steps)
                peak_replicas = max(peak_replicas, auto.working)
            in_flight = sum(s.in_flight for s in scheds)
            peak_in_flight = max(peak_in_flight, in_flight)
            stepped = False
            for s in scheds:
                # a replica mid-prefill still takes its tick: it ingests
                # the next chunk AND decodes its active slots — prompt
                # ingestion on one replica no longer stalls the others
                # (draining replicas keep stepping here too: closed to
                # admission, never to completion)
                if not (s.active or s.prefill_backlog):
                    continue
                stepped = True
                # solo page starvation: evict for re-route (front of the
                # router queue, like a local preemption resume); marked so
                # dispatch places it by the pessimistic residency bound
                for en in reversed(s.step(evict_on_starvation=True)):
                    en.rerouted = True
                    reroutes += 1
                    if tracer is not None:
                        tracer.instant("reroute", shared.t,
                                       replica=s.replica_id,
                                       rid=en.req.rid,
                                       tokens=len(en.st.tokens))
                    queue.appendleft(en)
                # ordinary preemptions also resume through the router, so
                # a request squeezed out of one replica may land on another
                while s.queue:
                    queue.appendleft(s.queue.pop())
            # the round costs what the busiest replica did this round
            shared.advance(max((s.vclock.take() for s in scheds), default=0))
            if not stepped and not progressed:
                if queue:
                    # an autoscaled fleet may just be scaled-in too far:
                    # wake a replica before declaring the fleet too small
                    if auto is not None and auto.try_grow():
                        continue
                    en = queue[0]
                    raise PoolExhausted(
                        f"request {en.req.rid} ({en.pending_len} tokens) "
                        f"cannot be admitted into an otherwise idle fleet "
                        f"— every replica's pool is too small for it")
                if pending:
                    # idle fleet, future arrivals only: fast-forward the
                    # shared clock to the next arrival (real time passes
                    # while nothing computes — deterministically)
                    nxt = pending[0].req.arrival_vstep
                    shared.advance(nxt - shared.t)

        wall = self.clock() - t0
        if tracer is not None:
            tracer.close(shared.t)
        stats = [s.stats() for s in scheds]
        replica_of = {r.rid: i for i, s in enumerate(stats)
                      for r in s.results}
        results = sorted((r for s in stats for r in s.results),
                         key=lambda r: r.rid)
        out = RouterStats(results=results, replica_stats=stats,
                          replica_of=replica_of, wall_s=wall,
                          reroutes=reroutes, peak_in_flight=peak_in_flight,
                          rejected=rejected,
                          autoscale_events=auto.events if auto else [],
                          peak_replicas=peak_replicas,
                          total_vsteps=shared.t,
                          slo_ttft_steps=slo_ttft_steps,
                          slo_e2e_steps=slo_e2e_steps)
        self.log(f"[route:{self.policy}:{policy}] {out.summary()}")
        return out
