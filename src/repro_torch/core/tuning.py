"""AutoTuner, serve branch (port of ``repro/core/tuning.py`` from its
non-train branch on).

Given (ModelConfig, ShapeConfig, TargetSpec) it derives a DeploymentPlan
from the target's memory and compute budget: the KV pool in both
layouts, the chunked-prefill grain, SLO deadlines, the prefix-cache pin
quota, the speculative draft length and the paged decode kernel.  Every
``serve_*`` field is computed exactly as the reference computes it, so
the two packages' plans agree on a shared target.  The reference's
napkin strings and training shapes wait for later slices (ROADMAP).
"""

from __future__ import annotations

import math

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.plan import DeploymentPlan
from repro_torch.core.target import TargetSpec

# paged serve layout: tokens per KV page, and the expected fraction of
# max_len a request actually uses (heavy-tailed traces)
SERVE_PAGE_SIZE = 16
SERVE_EXPECTED_LEN_FRACTION = 0.25
# speculative decoding: below this trace repetitiveness the tuner keeps
# spec off (see the reference's spec_k_for)
SPEC_MIN_REPETITIVENESS = 0.35
SPEC_MAX_K = 8
# SLO deadlines the tuner suggests, on the virtual step clock
SERVE_SLO_TTFT_STALL_MULT = 4
SERVE_SLO_E2E_STEPS_PER_TOKEN = 2


def spec_k_for(repetitiveness: float) -> int:
    """Draft length the tuner picks for a trace's repetitiveness r: k
    grows while the marginal expected token r^(k+1) stays >= 0.1, capped
    at SPEC_MAX_K; r below SPEC_MIN_REPETITIVENESS turns spec off."""
    r = min(max(float(repetitiveness), 0.0), 0.99)
    if r < SPEC_MIN_REPETITIVENESS:
        return 0
    k = 1
    while k < SPEC_MAX_K and r ** (k + 1) >= 0.1:
        k += 1
    return k


def param_count_estimate(cfg: ModelConfig) -> int:
    """Exact parameter count, straight from the model's ParamDef table
    (metadata only — no allocation)."""
    from repro_torch.models.params import param_count
    from repro_torch.models.transformer import model_for
    return param_count(model_for(cfg).param_table())


def kv_bytes_per_token(cfg: ModelConfig) -> int:
    """Device bytes one KV-cache token costs (k+v, all layers) — the unit
    the serve-mode budget is denominated in."""
    per = 2 * cfg.num_layers * cfg.num_kv_heads * cfg.head_dim * \
        cfg.activation_dtype.itemsize
    if cfg.family == "encdec":
        per *= 2  # self- and cross-attention caches
    return per


def prefix_cache_quota(num_pages: int) -> int:
    """LRU pin cap for the shared-prefix KV cache: ~1/4 of the
    allocatable page pool."""
    return max((num_pages - 1) // 4, 1) if num_pages else 0


def tune(cfg: ModelConfig, shape: ShapeConfig, target: TargetSpec,
         overrides: dict | None = None) -> DeploymentPlan:
    if shape.kind == "train":
        raise NotImplementedError(
            "training plans are not ported yet (ROADMAP slice E)")
    plan = DeploymentPlan(
        arch=cfg.name, shape=shape.name, target=target.name,
        mesh_shape=target.mesh_shape, mesh_axes=target.mesh_axes,
        kernels=target.kernels, microbatches=1, remat_policy="none")
    if cfg.family in ("dense", "moe", "vlm", "encdec"):
        _plan_serve(plan, cfg, shape, target)
    # long-context sequence parallelism
    if shape.seq_len >= 131072 and shape.global_batch < \
            dict(zip(target.mesh_axes, target.mesh_shape)).get("data", 1):
        plan.sequence_parallel = True
        plan.notes.append("batch smaller than data axis at long context -> "
                          "sequence-parallel activations")
    for k, v in (overrides or {}).items():
        setattr(plan, k, v)
    return plan


def _plan_serve(plan: DeploymentPlan, cfg: ModelConfig, shape: ShapeConfig,
                target: TargetSpec) -> None:
    """Size the serving pools, chunk grain, deadlines and kernels."""
    chips = target.num_chips
    P = param_count_estimate(cfg)
    param_bytes = 2 * P                      # bf16
    kv_per_token = kv_bytes_per_token(cfg)
    # KV pool sizing: params + pool within 85% of device memory, split
    # across co-resident replicas; both layouts are sized
    replicas = max(int(shape.serve_replicas or 1), 1)
    plan.serve_replicas = replicas
    budget = (0.85 * target.hbm_bytes - param_bytes / chips) / replicas
    replica_batch = max(math.ceil(shape.global_batch / replicas), 1)
    per_slot = kv_per_token * shape.seq_len / chips
    cap = max(int(budget // per_slot), 1) if per_slot > 0 else replica_batch
    plan.serve_max_len = shape.seq_len
    plan.serve_slots = max(1, min(replica_batch, cap))
    if plan.serve_slots < replica_batch:
        plan.notes.append(
            f"serve: requested {replica_batch} slots exceed the memory "
            f"budget -> pool capped at {plan.serve_slots}")
    # paged layout: the same budget buys pages, capped at the requested
    # batch's worst case (+ the junk page 0)
    page_size = min(SERVE_PAGE_SIZE, shape.seq_len)
    page_bytes = kv_per_token * page_size / chips
    worst_pages = replica_batch * math.ceil(shape.seq_len / page_size) + 1
    budget_pages = max(int(budget // page_bytes), 2) \
        if page_bytes > 0 else worst_pages
    plan.serve_page_size = page_size
    plan.serve_num_pages = min(budget_pages, worst_pages)
    expected_len = max(int(shape.seq_len * SERVE_EXPECTED_LEN_FRACTION), 1)
    # chunked-prefill grain: one chunk's FLOPs fit in one decode tick
    # (bandwidth-bound on the weights), power-of-two bucketed
    flops_tok = 2 * P                        # dense: every param is active
    t_tick = max(param_bytes / chips / target.hbm_bw,
                 plan.serve_slots * flops_tok / target.peak_flops)
    c_raw = t_tick * target.peak_flops / max(flops_tok, 1)
    chunk = 8
    while chunk * 2 <= min(c_raw, 128, shape.seq_len):
        chunk *= 2
    plan.serve_prefill_chunk = chunk
    stall = -(-expected_len // chunk)        # chunk-equivalent ticks
    # SLO deadlines on the virtual step clock
    plan.serve_slo_ttft_steps = SERVE_SLO_TTFT_STALL_MULT * (stall + 1)
    plan.serve_slo_e2e_steps = plan.serve_slo_ttft_steps + \
        SERVE_SLO_E2E_STEPS_PER_TOKEN * expected_len
    # shared-prefix KV cache pin quota (out of the same page pool)
    plan.serve_prefix_cache_pages = prefix_cache_quota(plan.serve_num_pages)
    # paged decode attention: CUDA targets get the hand-written
    # paged-decode kernel, the others the gather-then-attend read
    plan.serve_kv_kernel = "cuda" if target.kernels == "cuda" else "gather"
    # speculative decoding: draft length from the repetitiveness hint
    plan.serve_spec_k = spec_k_for(shape.serve_repetitiveness)
