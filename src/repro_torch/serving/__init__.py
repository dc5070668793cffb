"""Continuous-batching serving (port of ``repro.serving``):
``KVCachePool`` (contiguous slots) or ``PagedKVCachePool`` (refcounted
pages behind a host page table) + ``PrefixCache`` (shared-prefix page-run
reuse over a paged pool) + ``Scheduler`` (admission, in-flight batching,
page-pressure preemption, keyed sampling, draft-then-verify speculation)
+ ``ServeEngine`` (tuner-sized pool, steps, kernel choice) +
``ReplicaRouter`` (N engines behind one admission queue: routing
policies, overflow re-routing, open-loop arrivals, SLO admission and
``AutoscalePolicy`` fleet autoscaling) + ``Tracer`` / ``MetricsRegistry``
(vstep-clocked request spans and ring events, the metric schemas and
their Prometheus and Chrome-trace exporters)."""

from repro_torch.serving.engine import (KV_KERNELS, KV_LAYOUTS,
                                        SERVABLE_FAMILIES, ServeEngine)
from repro_torch.serving.pool import (KVCachePool, PagedKVCachePool,
                                      PoolExhausted)
from repro_torch.serving.prefill import PrefillManager
from repro_torch.serving.prefix_cache import PrefixCache, prefix_key
from repro_torch.serving.router import (ADMISSION_MODES, ROUTE_POLICIES,
                                        AutoscaleEvent, AutoscalePolicy,
                                        RejectedRequest, ReplicaRouter,
                                        RouterStats, prefix_replica,
                                        replay_peak_replicas)
from repro_torch.serving.sampling import K_CAP, effective_top_k, make_sampler
from repro_torch.serving.scheduler import (Request, RequestResult, Scheduler,
                                           ServeStats, VirtualClock,
                                           percentile_steps)
from repro_torch.serving.spec import Drafter, NGramDrafter
from repro_torch.serving.telemetry import (EVENT_KINDS, PHASES, ROUTER_SCHEMA,
                                           SERVE_SCHEMA, MetricSpec,
                                           MetricsRegistry, Span, TraceEvent,
                                           Tracer, chrome_trace,
                                           json_sanitize, prometheus_text,
                                           write_chrome_trace)
from repro_torch.serving.trace import (ARRIVAL_MODES, bursty_arrivals,
                                       longprompt_trace, poisson_arrivals,
                                       repetitive_trace, sharedprefix_trace,
                                       trace_repetitiveness, uniform_trace,
                                       with_arrivals, zipf_trace)

__all__ = ["ServeEngine", "SERVABLE_FAMILIES", "KV_LAYOUTS", "KV_KERNELS",
           "KVCachePool", "PagedKVCachePool", "PoolExhausted",
           "PrefillManager", "PrefixCache", "prefix_key", "ReplicaRouter",
           "RouterStats", "ROUTE_POLICIES", "ADMISSION_MODES",
           "AutoscalePolicy", "AutoscaleEvent", "RejectedRequest",
           "prefix_replica", "replay_peak_replicas", "Request",
           "RequestResult", "Scheduler", "ServeStats", "VirtualClock",
           "percentile_steps", "make_sampler", "K_CAP", "effective_top_k",
           "Drafter", "NGramDrafter", "ARRIVAL_MODES", "poisson_arrivals",
           "bursty_arrivals", "with_arrivals", "longprompt_trace",
           "repetitive_trace", "sharedprefix_trace", "trace_repetitiveness",
           "uniform_trace", "zipf_trace", "Tracer", "Span", "TraceEvent",
           "MetricSpec", "MetricsRegistry", "SERVE_SCHEMA", "ROUTER_SCHEMA",
           "PHASES", "EVENT_KINDS", "prometheus_text", "chrome_trace",
           "write_chrome_trace", "json_sanitize"]
