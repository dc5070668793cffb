"""Continuous-batching serving (port of ``repro.serving``):
``KVCachePool`` (contiguous slots) or ``PagedKVCachePool`` (refcounted
pages behind a host page table) + ``Scheduler`` (admission, in-flight
batching, page-pressure preemption, keyed sampling, draft-then-verify
speculation) + ``ServeEngine`` (tuner-sized pool, steps, kernel
choice)."""

from repro_torch.serving.engine import (KV_KERNELS, KV_LAYOUTS,
                                        SERVABLE_FAMILIES, ServeEngine)
from repro_torch.serving.pool import (KVCachePool, PagedKVCachePool,
                                      PoolExhausted)
from repro_torch.serving.prefill import PrefillManager
from repro_torch.serving.sampling import make_sampler
from repro_torch.serving.scheduler import (Request, RequestResult, Scheduler,
                                           ServeStats, VirtualClock,
                                           percentile_steps)
from repro_torch.serving.spec import Drafter, NGramDrafter
from repro_torch.serving.trace import repetitive_trace, zipf_trace

__all__ = ["ServeEngine", "SERVABLE_FAMILIES", "KV_LAYOUTS", "KV_KERNELS",
           "KVCachePool", "PagedKVCachePool", "PoolExhausted",
           "PrefillManager", "Request", "RequestResult", "Scheduler",
           "ServeStats", "VirtualClock", "percentile_steps", "make_sampler",
           "Drafter", "NGramDrafter", "repetitive_trace", "zipf_trace"]
