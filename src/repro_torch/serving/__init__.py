"""Continuous-batching serving, paged layout (port of ``repro.serving``):
``PagedKVCachePool`` (refcounted pages behind a host page table) +
``Scheduler`` (admission, in-flight batching, page-pressure preemption,
greedy decoding) + ``ServeEngine`` (tuner-sized pool, steps, kernel
choice)."""

from repro_torch.serving.engine import (KV_KERNELS, KV_LAYOUTS,
                                        SERVABLE_FAMILIES, ServeEngine)
from repro_torch.serving.pool import PagedKVCachePool, PoolExhausted
from repro_torch.serving.prefill import PrefillManager
from repro_torch.serving.scheduler import (Request, RequestResult, Scheduler,
                                           ServeStats, VirtualClock,
                                           percentile_steps)
from repro_torch.serving.trace import zipf_trace

__all__ = ["ServeEngine", "SERVABLE_FAMILIES", "KV_LAYOUTS", "KV_KERNELS",
           "PagedKVCachePool", "PoolExhausted", "PrefillManager", "Request",
           "RequestResult", "Scheduler", "ServeStats", "VirtualClock",
           "percentile_steps", "zipf_trace"]
