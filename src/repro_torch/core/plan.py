"""DeploymentPlan — the record of every decision the tuner makes (port of
``repro/core/plan.py``; the fields are the reference's, field for
field, so plans from both packages compare directly)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class DeploymentPlan:
    arch: str
    shape: str
    target: str
    mesh_shape: tuple[int, ...]
    mesh_axes: tuple[str, ...]
    microbatches: int = 1
    remat_policy: str = "dots"            # none | dots | full
    grad_accum_dtype: str = "float32"     # float32 | bfloat16
    optimizer: str = "adamw"              # adamw | adamw8bit
    kernels: str = "reference"            # cuda | reference
    sequence_parallel: bool = False
    grad_compression: str = "none"        # none | ef_int8
    donate_state: bool = True
    serve_slots: int = 0                  # KV-pool slots (serve mode; 0 = n/a)
    serve_max_len: int = 0                # per-slot KV capacity (serve mode)
    serve_page_size: int = 0              # paged KV: tokens per page
    serve_num_pages: int = 0              # paged KV: pool pages (incl. junk 0)
    serve_replicas: int = 1               # engines the serve budget is split over
    serve_prefill_chunk: int = 0          # prompt tokens ingested per decode tick
    serve_prefix_cache_pages: int = 0     # paged KV: LRU pin cap (prefix cache)
    serve_kv_kernel: str = ""             # paged decode attn: gather | cuda
    serve_spec_k: int = 0                 # speculative draft tokens per slot
    serve_slo_ttft_steps: int = 0         # TTFT deadline (virtual steps)
    serve_slo_e2e_steps: int = 0          # end-to-end deadline (virtual steps)
    sharding_fallbacks: list = dataclasses.field(default_factory=list)
    napkin: dict = dataclasses.field(default_factory=dict)
    notes: list = dataclasses.field(default_factory=list)

