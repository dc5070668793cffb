"""AutoTuner (port of ``repro/core/tuning.py``).

Given (ModelConfig, ShapeConfig, TargetSpec) it derives a DeploymentPlan
from the target's memory and compute budget.  A train shape gets the
optimizer variant (f32 vs int8 moments), the gradient accumulation
dtype and the microbatch / remat / sequence-parallel escalation ladder,
with the reference's napkin figures and notes.  A serve shape gets the
KV pool in both layouts, the chunked-prefill grain, SLO deadlines, the
prefix-cache pin quota, the speculative draft length and the paged
decode kernel (every ``serve_*`` field as the reference computes it; its
napkin strings are not ported).  The two packages' plans agree on a
shared target.
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


def ttft_napkin_steps(prompt_len: int, chunk_unit: int,
                      backlog_chunks: int = 0,
                      waited_steps: int = 0) -> int:
    """Predicted time-to-first-token, in virtual steps — the napkin the
    router's SLO admission and autoscaler consult: the steps already
    waited, plus the pending prefill backlog in chunk-equivalents, plus
    the request's own prompt at ``ceil(prompt_len / chunk_unit)`` chunk
    steps (the unit the virtual clock prices blocking prefills in)."""
    own = -(-max(int(prompt_len), 1) // max(int(chunk_unit), 1))
    return int(waited_steps) + int(backlog_chunks) + own


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


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE: only the top-k experts)."""
    total = param_count_estimate(cfg)
    if cfg.family != "moe":
        return total
    gated = 3 if cfg.activation in ("silu", "geglu") else 2
    per_expert = gated * cfg.d_model * cfg.d_ff
    inactive = (cfg.num_experts - cfg.experts_per_token) * per_expert * \
        cfg.num_layers
    return total - inactive


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
    plan = DeploymentPlan(
        arch=cfg.name, shape=shape.name, target=target.name,
        mesh_shape=target.mesh_shape, mesh_axes=target.mesh_axes,
        kernels=target.kernels, microbatches=1, remat_policy="none")
    if shape.kind == "train":
        _plan_train(plan, cfg, shape, target)
    elif cfg.family in ("dense", "moe", "vlm", "encdec"):
        _plan_serve(plan, cfg, shape, target)
    # long-context sequence parallelism
    if shape.kind != "train" and shape.seq_len >= 131072 and \
            shape.global_batch < \
            dict(zip(target.mesh_axes, target.mesh_shape)).get("data", 1):
        plan.sequence_parallel = True
        plan.notes.append("batch smaller than data axis at long context -> "
                          "sequence-parallel activations")
    for k, v in (overrides or {}).items():
        setattr(plan, k, v)
    return plan


def _plan_train(plan: DeploymentPlan, cfg: ModelConfig, shape: ShapeConfig,
                target: TargetSpec) -> None:
    """Optimizer variant, gradient accumulation dtype, then the cheapest
    (remat, microbatches, sequence parallel, bf16 grads) that fits the
    activations in the headroom (the reference's ladder; its temp factor
    is ~6 x the stacked layer inputs under ``dots``, ~3.5 under full
    remat)."""
    chips = target.num_chips
    P = param_count_estimate(cfg)
    param_bytes = 2 * P  # bf16
    plan.napkin["params"] = f"{P/1e9:.2f}B"
    plan.napkin["param_bytes_per_chip"] = f"{param_bytes/chips/1e9:.3f} GB"
    budget = 0.85 * target.hbm_bytes
    fixed = param_bytes / chips
    grad_fp32 = 4 * P / chips
    opt_fp32 = 8 * P / chips
    plan.napkin["opt_fp32_per_chip"] = f"{opt_fp32/1e9:.2f} GB"
    axes = dict(zip(target.mesh_axes, target.mesh_shape))
    batch_shards = axes.get("pod", 1) * axes.get("data", 1)
    model_size = axes.get("model", 1)
    max_micro = max(int(shape.global_batch // batch_shards), 1)
    L_eff = cfg.num_layers + cfg.num_encoder_layers
    width = cfg.d_model if cfg.family not in ("ssm_xlstm", "hybrid_mamba") \
        else (cfg.ssm_expand + 1) * cfg.d_model
    tokens_local = shape.global_batch * shape.seq_len / batch_shards
    # minimum activation footprint (full remat, max microbatches) decides
    # the optimizer variant up front
    min_act = 3.5 * (tokens_local / max_micro) * L_eff * width * 2
    if fixed + opt_fp32 + grad_fp32 + min_act > budget:
        plan.optimizer = "adamw8bit"
        opt_bytes = (2 * P + 8 * max(P // 128, 1)) / chips
        plan.notes.append(
            "fp32 Adam moments + activations exceed HBM -> int8 moments")
    else:
        plan.optimizer = "adamw"
        opt_bytes = opt_fp32
    # grad accumulation dtype (the ladder may escalate it)
    if fixed + opt_bytes + grad_fp32 > budget:
        plan.grad_accum_dtype = "bfloat16"
        grad_bytes = 2 * P / chips
        plan.notes.append("fp32 grad accumulator exceeds budget -> bf16")
    else:
        grad_bytes = grad_fp32
    headroom = budget - fixed - opt_bytes - grad_bytes
    plan.napkin["headroom_for_activations"] = f"{headroom/1e9:.2f} GB"
    headroom_bf16_grads = budget - fixed - opt_bytes - 2 * P / chips

    def est_temp(micro, factor, seq_shards=1):
        saved = (tokens_local / micro) * L_eff * width * 2
        return factor * saved / seq_shards

    # cheapest knob first, microbatches the inner loop; no sequence
    # parallelism for MoE (expert dispatch reshards per chunk)
    ladder = [("dots", 6.0, False, False), ("full", 3.5, False, False),
              ("dots", 6.0, False, True), ("full", 3.5, False, True)]
    if cfg.family != "moe":
        ladder += [("dots", 6.0, True, False), ("full", 3.5, True, False),
                   ("dots", 6.0, True, True), ("full", 3.5, True, True)]
    chosen = None
    for remat, factor, sp, bf16g in ladder:
        room = headroom_bf16_grads if bf16g else headroom
        shards = model_size if sp else 1
        micro = 1
        while micro <= max_micro:
            if shape.global_batch % micro == 0 and \
                    est_temp(micro, factor, shards) <= room:
                chosen = (remat, micro, sp, bf16g)
                break
            micro *= 2
        if chosen:
            break
    if not chosen:
        chosen = ("full", max_micro, cfg.family != "moe", True)
        plan.notes.append("I2: memory estimate exceeds HBM even at the "
                          "top of the escalation ladder")
    plan.remat_policy, plan.microbatches, plan.sequence_parallel, bf16g = \
        chosen
    if bf16g and plan.grad_accum_dtype != "bfloat16":
        plan.grad_accum_dtype = "bfloat16"
        plan.notes.append("I2: bf16 grad accumulation (ladder escalation)")
    if chosen[2]:
        plan.notes.append("I2: sequence-parallel activations "
                          "(saved tensors shard over the model axis)")
    factor = 6.0 if plan.remat_policy == "dots" else 3.5
    shards = model_size if plan.sequence_parallel else 1
    plan.napkin["est_temp_per_chip"] = (
        f"{est_temp(plan.microbatches, factor, shards) / 1e9:.2f} GB")


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
    flops_tok = 2 * active_param_count(cfg)
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
