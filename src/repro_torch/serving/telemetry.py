"""Vstep-clocked request tracing + the unified serving metrics registry
(port of ``repro/serving/telemetry.py``; pure host-side Python, so the
port keeps its own copy, key for key and byte for byte in what it
writes).

Three pieces:

* ``Tracer`` — per-request **spans** on the deterministic virtual-step
  clock (queued -> prefill_chunk[i] -> cache_attach -> decode ->
  spec_verify -> resume -> ...), plus a bounded structured **event
  ring** (preemptions, reroutes, SLO rejections, prefix-cache reclaims,
  autoscale transitions).  Every timestamp is a vstep — never wall
  clock — so two identical runs produce byte-identical traces.  The
  tracer is pure host-side bookkeeping: instrumentation sites are
  guarded by ``if tracer is not None`` and no trace state reaches a
  model step or a kernel, so telemetry-on streams are bit-identical to
  telemetry-off by construction.

* ``MetricsRegistry`` — counters / gauges / histograms behind a declared
  schema (``SERVE_SCHEMA`` / ``ROUTER_SCHEMA``).  ``ServeStats
  .to_metrics()`` and ``RouterStats.to_metrics()`` are *views over this
  registry*: they set exactly the schema's keys and ``snapshot()``
  refuses extras or omissions, so the exported key set can never drift
  from the declared one.

* Exporters — ``prometheus_text`` (Prometheus text exposition format,
  ``# HELP`` / ``# TYPE`` per family) and ``chrome_trace`` /
  ``write_chrome_trace`` (Chrome-trace / Perfetto JSON: one *process*
  per replica, one *thread* per slot plus a queue lane, complete-event
  spans with vstep timestamps, instant events for the ring).  Load a
  ``--trace-out`` file at https://ui.perfetto.dev to read one request's
  queued -> prefill -> decode life as a timeline.  The file's
  ``otherData.clock`` text is the reference's, so the two packages'
  files of one run are equal byte for byte.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
from collections import deque

# ---------------------------------------------------------------------------
# Metric schema: the single source every flat metrics export goes through


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """One declared metric: exact key, or a template containing ``{i}``
    (expanded per replica by the router view)."""
    key: str
    kind: str                     # "counter" | "gauge" | "histogram"
    help: str

    def __post_init__(self):
        if self.kind not in ("counter", "gauge", "histogram"):
            raise ValueError(f"metric kind {self.kind!r}")


def _c(key, help):
    return MetricSpec(key, "counter", help)


def _g(key, help):
    return MetricSpec(key, "gauge", help)


# Suffixes shared by the single-engine and router views: same meaning,
# same kind, one definition — prefixed "serve_" / "router_" below.
_COMMON = (
    _c("requests_completed", "requests fully served"),
    _c("generated_tokens", "tokens emitted"),
    _c("goodput_tokens", "tokens from requests meeting the SLO"),
    _g("slo_ttft_steps", "TTFT deadline judged by (0=unset)"),
    _g("slo_e2e_steps", "e2e deadline judged by (0=unset)"),
    _g("ttft_p50_steps", "median TTFT, virtual steps"),
    _g("ttft_p99_steps", "p99 TTFT, virtual steps"),
    _g("e2e_p50_steps", "median e2e latency, virtual steps"),
    _g("e2e_p99_steps", "p99 e2e latency, virtual steps"),
    _g("mean_ttft_steps", "mean TTFT, virtual steps"),
    _c("total_vsteps", "virtual step clock at drain end"),
    _g("wall_s", "wall time (ADVISORY only)"),
    _g("tokens_per_s", "wall throughput (ADVISORY only)"),
)


def _prefixed(prefix, specs):
    return tuple(dataclasses.replace(s, key=prefix + s.key) for s in specs)


#: Flat key schema behind ``ServeStats.to_metrics()`` (single engine).
SERVE_SCHEMA = _prefixed("serve_", _COMMON) + (
    _c("serve_decode_steps", "scheduler decode/verify ticks"),
    _g("serve_occupancy", "mean active-slot fraction per decode step"),
    _g("serve_peak_active", "max concurrent in-flight requests"),
    _g("serve_peak_resident_kv", "max KV tokens resident in the pool"),
    _c("serve_preemptions", "page-pressure evictions"),
    _c("serve_prefill_chunks", "prefill chunk-step invocations"),
    _c("serve_prefill_tokens", "prompt tokens ingested through chunks"),
    _c("serve_prefix_hits", "admissions that reused a cached prefix run"),
    _c("serve_prefix_misses", "admissions with no cached prefix"),
    _c("serve_prefill_tokens_saved", "prompt tokens skipped via cache hits"),
    _c("serve_prefix_evictions", "prefix-cache cells reclaimed"),
    _c("serve_spec_verify_steps", "speculative slot-verify scoring events"),
    _c("serve_spec_drafted_tokens", "draft tokens proposed"),
    _c("serve_spec_accepted_tokens", "draft tokens accepted"),
)

#: Flat key schema behind ``RouterStats.to_metrics()`` — the table in
#: ``router.py``'s module docstring renders exactly these.
ROUTER_SCHEMA = _prefixed("router_", _COMMON) + (
    _c("router_requests_rejected", "SLO admission rejections"),
    _g("router_peak_in_flight", "max concurrent requests, fleet-wide"),
    _g("router_peak_replicas", "max replicas serving or draining"),
    _c("router_reroutes", "starvation re-dispatches"),
    _c("router_autoscale_grows", "replicas activated"),
    _c("router_autoscale_drains", "drains initiated"),
    _g("router_load_imbalance", "max/mean peak resident KV tokens"),
    _c("replica{i}_generated_tokens", "per-replica tokens"),
    _c("replica{i}_decode_steps", "per-replica scheduler ticks"),
    _g("replica{i}_peak_resident_kv", "per-replica peak resident tokens"),
    _c("replica{i}_preemptions", "per-replica page-pressure evicts"),
    _g("replica{i}_occupancy", "per-replica mean slot occupancy"),
)


@dataclasses.dataclass
class Histogram:
    """Fixed-bucket histogram (Prometheus-style cumulative on export)."""
    bounds: tuple                  # ascending upper bounds; +inf implicit
    counts: list = None
    total: int = 0
    sum: float = 0.0

    def __post_init__(self):
        if list(self.bounds) != sorted(self.bounds):
            raise ValueError(f"histogram bounds not ascending {self.bounds}")
        if self.counts is None:
            self.counts = [0] * (len(self.bounds) + 1)

    def observe(self, value: float) -> None:
        for i, b in enumerate(self.bounds):
            if value <= b:
                self.counts[i] += 1
                break
        else:
            self.counts[-1] += 1
        self.total += 1
        self.sum += float(value)


class MetricsRegistry:
    """Schema-validated counters/gauges/histograms behind one flat
    namespace.

    Two modes of use, one instrument set:

    * **view building** — construct from a declared schema
      (``SERVE_SCHEMA`` / ``ROUTER_SCHEMA``), ``set`` every key, then
      ``snapshot()``; a key outside the schema, or a declared exact key
      never set, raises — the drift ``to_metrics()`` used to allow.
    * **live accumulation** — ``declare`` metrics on the fly (the
      ``Tracer`` does this for its span/event counters and duration
      histogram), ``inc`` / ``observe`` as events happen.
    """

    def __init__(self, schema=()):
        self._specs: dict[str, MetricSpec] = {}
        self._templates: list[MetricSpec] = []
        self._values: dict[str, float] = {}
        self._hists: dict[str, Histogram] = {}
        for spec in schema:
            self.declare(spec)

    def declare(self, spec: MetricSpec, buckets=None) -> MetricSpec:
        if "{i}" in spec.key:
            self._templates.append(spec)
            return spec
        if spec.key in self._specs:
            raise ValueError(f"metric {spec.key!r} already declared")
        if not re.fullmatch(r"[a-zA-Z_][a-zA-Z0-9_]*", spec.key):
            raise ValueError(f"metric key {spec.key!r} is not a valid "
                             f"Prometheus metric name")
        self._specs[spec.key] = spec
        if spec.kind == "histogram":
            self._hists[spec.key] = Histogram(tuple(buckets or (1, 10, 100)))
        return spec

    def spec_for(self, key: str) -> MetricSpec:
        """Resolve ``key`` to its spec — exact match first, then the
        ``{i}`` templates (``replica3_...`` matches ``replica{i}_...``)."""
        spec = self._specs.get(key)
        if spec is not None:
            return spec
        for t in self._templates:
            if re.fullmatch(re.escape(t.key).replace(r"\{i\}", r"\d+"), key):
                return t
        raise KeyError(f"metric {key!r} is not in the declared schema")

    def set(self, key: str, value) -> None:
        """Record a snapshot value for a declared (or template) key."""
        spec = self.spec_for(key)
        if spec.kind == "histogram":
            raise ValueError(f"{key!r} is a histogram — use observe()")
        self._values[key] = value

    def inc(self, key: str, n: float = 1) -> None:
        if self.spec_for(key).kind != "counter":
            raise ValueError(f"{key!r} is not a counter")
        self._values[key] = self._values.get(key, 0) + n

    def observe(self, key: str, value: float) -> None:
        if self.spec_for(key).kind != "histogram":
            raise ValueError(f"{key!r} is not a histogram")
        self._hists[key].observe(value)

    def snapshot(self, require_complete: bool = True) -> dict:
        """Flat ``{key: number}`` dict in schema declaration order
        (template instances in set order).  ``require_complete`` makes an
        unset exact scalar key an error — a view that forgot a schema key
        must fail loudly, not export a truncated scrape.  Histograms
        flatten to ``{key}_count`` / ``{key}_sum`` / ``{key}_le_{b}``."""
        if require_complete:
            missing = [k for k, s in self._specs.items()
                       if s.kind != "histogram" and k not in self._values]
            if missing:
                raise ValueError(
                    f"metrics view did not set declared keys: {missing}")
        out = {}
        for key, spec in self._specs.items():
            if spec.kind == "histogram":
                h = self._hists[key]
                out[f"{key}_count"] = h.total
                out[f"{key}_sum"] = h.sum
                for b, c in zip(h.bounds, h.counts):
                    out[f"{key}_le_{b}"] = c
            elif key in self._values:
                out[key] = self._values[key]
        for key in self._values:
            if key not in self._specs:
                out[key] = self._values[key]
        return out

    def to_prometheus(self) -> str:
        return prometheus_text(self.snapshot(require_complete=False), self)


def _prom_value(v) -> str:
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return "NaN"
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, int):
        return str(v)
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


def prometheus_text(metrics: dict, schema) -> str:
    """Render a flat metrics dict in the Prometheus text exposition
    format.  ``schema`` is a ``MetricsRegistry`` or a spec iterable —
    it supplies each family's ``# HELP`` / ``# TYPE`` lines; NaN (an
    idle fleet's percentile) renders as Prometheus's literal ``NaN``.
    Deterministic: the line order is the dict's insertion order."""
    reg = schema if isinstance(schema, MetricsRegistry) \
        else MetricsRegistry(schema)
    lines = []
    seen_families = set()
    for key, value in metrics.items():
        try:
            spec = reg.spec_for(key)
        except KeyError:
            spec = MetricSpec(key, "gauge", "")
        family = spec.key
        if family not in seen_families:
            seen_families.add(family)
            if spec.help:
                lines.append(f"# HELP {key} {spec.help}")
            lines.append(f"# TYPE {key} {spec.kind}")
        lines.append(f"{key} {_prom_value(value)}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Vstep-clocked request tracing


#: Request lifecycle phases a full serving run can emit spans for.
PHASES = ("queued", "prefill_chunk", "cache_attach", "decode",
          "spec_verify", "resume")

#: Structured event kinds the bounded ring can carry.
EVENT_KINDS = ("preempt", "reroute", "reject", "prefix_reclaim",
               "autoscale_grow", "autoscale_drain", "autoscale_stop")


@dataclasses.dataclass
class Span:
    """One request-lifecycle interval on the virtual step clock."""
    phase: str
    rid: int
    v_start: int
    v_end: int = -1               # -1 = still open
    replica: int = 0
    slot: int = -1                # -1 = not bound to a pool slot (queued)
    attrs: dict = dataclasses.field(default_factory=dict)

    @property
    def steps(self) -> int:
        return max(self.v_end - self.v_start, 0) if self.v_end >= 0 else 0


@dataclasses.dataclass
class TraceEvent:
    """One structured instant in the bounded event ring."""
    kind: str
    vstep: int
    replica: int = 0
    rid: int = -1
    attrs: dict = dataclasses.field(default_factory=dict)


class Tracer:
    """Deterministic span/event recorder for one serving drain.

    Everything is keyed to the virtual step clock the scheduler already
    runs on, so traces are bit-reproducible: two identical runs emit
    identical span lists, identical rings, and (through
    ``write_chrome_trace``) byte-identical files.  The tracer is
    host-side only and opt-in — every instrumentation site is guarded by
    ``if tracer is not None`` and none touches a model step, so enabling
    it cannot move a single token.

    Spans are ``begin``/``end`` bracketed and matched on ``(rid,
    phase)`` — deliberately not on replica, so a reroute's ``resume``
    span opened on the starved replica closes cleanly when another
    replica re-admits the request.  ``end`` on a phase that was never
    opened is counted (``unmatched_ends``) but ignored, so partially
    instrumented paths degrade to missing spans, never to crashes.
    """

    def __init__(self, ring_capacity: int = 1024):
        if ring_capacity < 1:
            raise ValueError(f"ring_capacity {ring_capacity} < 1")
        self.ring_capacity = ring_capacity
        self.spans: list[Span] = []
        self.events: deque[TraceEvent] = deque(maxlen=ring_capacity)
        self.total_events = 0
        self.unmatched_ends = 0
        self._open: dict[tuple, Span] = {}     # (rid, phase) -> span

    # -- spans ---------------------------------------------------------------
    def begin(self, phase: str, rid: int, vstep: int, replica: int = 0,
              slot: int = -1, **attrs) -> Span:
        """Open a span; appended to ``spans`` now so file order is the
        deterministic host-loop begin order.  Re-beginning an open
        ``(rid, phase)`` closes the old span at the new start first."""
        old = self._open.pop((rid, phase), None)
        if old is not None:
            old.v_end = int(vstep)
        span = Span(phase=phase, rid=int(rid), v_start=int(vstep),
                    replica=int(replica), slot=int(slot), attrs=dict(attrs))
        self.spans.append(span)
        self._open[(rid, phase)] = span
        return span

    def end(self, phase: str, rid: int, vstep: int, **attrs) -> bool:
        """Close the open ``(rid, phase)`` span; False when none open."""
        span = self._open.pop((rid, phase), None)
        if span is None:
            self.unmatched_ends += 1
            return False
        span.v_end = int(vstep)
        span.attrs.update(attrs)
        return True

    def end_any(self, phases, rid: int, vstep: int, **attrs) -> bool:
        """Close whichever of ``phases`` is open for ``rid`` (first
        match) — admission doesn't care whether the wait it terminates
        was a fresh ``queued`` or a preemption ``resume``."""
        for phase in phases:
            if (rid, phase) in self._open:
                return self.end(phase, rid, vstep, **attrs)
        self.unmatched_ends += 1
        return False

    def span(self, phase: str, rid: int, v_start: int, v_end: int,
             replica: int = 0, slot: int = -1, **attrs) -> Span:
        """Record an already-complete span (e.g. one spec-verify tick)."""
        s = Span(phase=phase, rid=int(rid), v_start=int(v_start),
                 v_end=int(v_end), replica=int(replica), slot=int(slot),
                 attrs=dict(attrs))
        self.spans.append(s)
        return s

    def close(self, vstep: int) -> int:
        """End-of-run flush: close every still-open span at ``vstep``
        (a request shed mid-wait, a drain cut short).  Returns the count."""
        n = 0
        for span in list(self._open.values()):
            span.v_end = int(vstep)
            n += 1
        self._open.clear()
        return n

    # -- events --------------------------------------------------------------
    def instant(self, kind: str, vstep: int, replica: int = 0,
                rid: int = -1, **attrs) -> TraceEvent:
        """Append a structured event to the bounded ring (oldest events
        fall off once ``ring_capacity`` is exceeded — ``dropped_events``
        says how many)."""
        ev = TraceEvent(kind=kind, vstep=int(vstep), replica=int(replica),
                        rid=int(rid), attrs=dict(attrs))
        self.events.append(ev)
        self.total_events += 1
        return ev

    @property
    def dropped_events(self) -> int:
        return self.total_events - len(self.events)

    def events_of(self, kind: str) -> list:
        return [e for e in self.events if e.kind == kind]

    def spans_of(self, phase: str) -> list:
        return [s for s in self.spans if s.phase == phase]

    # -- derived metrics ------------------------------------------------------
    def metrics(self) -> MetricsRegistry:
        """A live registry over the trace itself: span counts per phase,
        ring totals/drops, and a histogram of span durations (vsteps) —
        the histogram leg of the registry, fed from real trace data."""
        reg = MetricsRegistry()
        reg.declare(_c("trace_spans_total", "spans recorded"))
        reg.declare(_c("trace_events_total", "ring events recorded"))
        reg.declare(_c("trace_events_dropped",
                       "ring events lost to the capacity bound"))
        reg.declare(MetricSpec("trace_span_vsteps", "histogram",
                               "span durations, virtual steps"),
                    buckets=(1, 2, 4, 8, 16, 32, 64, 128))
        reg.inc("trace_spans_total", len(self.spans))
        reg.inc("trace_events_total", self.total_events)
        reg.inc("trace_events_dropped", self.dropped_events)
        for phase in PHASES:
            key = f"trace_{phase}_spans"
            reg.declare(_c(key, f"{phase} spans recorded"))
            reg.inc(key, len(self.spans_of(phase)))
        for span in self.spans:
            if span.v_end >= 0:
                reg.observe("trace_span_vsteps", span.steps)
        return reg


# ---------------------------------------------------------------------------
# Chrome-trace / Perfetto export


def _tid(span_slot: int) -> int:
    """Thread id inside a replica 'process': tid 0 is the queue/scheduler
    lane (spans not bound to a slot), pool slot s is tid s + 1."""
    return 0 if span_slot < 0 else span_slot + 1


def chrome_trace(tracer: Tracer) -> dict:
    """The tracer's spans + ring as a Chrome-trace (Perfetto-loadable)
    JSON object: one *process* per replica, one *thread* per pool slot
    (plus a tid-0 queue lane), complete events (``ph: "X"``) for spans
    and instant events (``ph: "i"``) for the ring.  All ``ts``/``dur``
    values are **virtual steps** — no wall clock anywhere, so identical
    runs serialize byte-identically."""
    events = []
    replicas = sorted({s.replica for s in tracer.spans} |
                      {e.replica for e in tracer.events})
    threads = sorted({(s.replica, _tid(s.slot)) for s in tracer.spans} |
                     {(r, 0) for r in replicas})
    for r in replicas:
        events.append({"name": "process_name", "ph": "M", "pid": r,
                       "args": {"name": f"replica {r}"}})
    for r, tid in threads:
        name = "queue" if tid == 0 else f"slot {tid - 1}"
        events.append({"name": "thread_name", "ph": "M", "pid": r,
                       "tid": tid, "args": {"name": name}})
    for s in tracer.spans:
        end = s.v_end if s.v_end >= 0 else s.v_start
        events.append({
            "name": s.phase, "cat": "request", "ph": "X",
            "pid": s.replica, "tid": _tid(s.slot),
            "ts": s.v_start, "dur": max(end - s.v_start, 0),
            "args": {"rid": s.rid, **s.attrs},
        })
    for e in tracer.events:
        args = {"rid": e.rid, **e.attrs} if e.rid >= 0 else dict(e.attrs)
        events.append({
            "name": e.kind, "cat": "fleet", "ph": "i", "s": "p",
            "pid": e.replica, "tid": 0, "ts": e.vstep, "args": args,
        })
    # stable sort by (ts, pid, tid): deterministic input stays
    # deterministic, and Perfetto gets monotone timestamps
    events.sort(key=lambda ev: (ev.get("ts", -1), ev["pid"],
                                ev.get("tid", 0)))
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"clock": "virtual steps (1 ts = 1 jitted invocation)",
                      "dropped_ring_events": tracer.dropped_events},
    }


def write_chrome_trace(tracer: Tracer, path) -> dict:
    """Serialize ``chrome_trace(tracer)`` to ``path``.  ``sort_keys`` +
    fixed indent make the bytes a pure function of the span/event data,
    which is itself a pure function of the (deterministic) run."""
    trace = chrome_trace(tracer)
    from pathlib import Path
    Path(path).write_text(json.dumps(trace, indent=1, sort_keys=True))
    return trace


def json_sanitize(obj):
    """Recursively map NaN/inf floats to None so ``json.dumps`` emits
    strict JSON (``null``), matching the bench's NaN->null convention."""
    if isinstance(obj, dict):
        return {k: json_sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_sanitize(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    return obj
