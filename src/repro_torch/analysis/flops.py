"""Analytic MODEL_FLOPS, the roofline's 'useful compute' reference (port
of ``repro/analysis/flops.py``; host arithmetic, equal to the
reference's for every cell).

Conventions:
  train   : 6 * N_active * tokens   (fwd 2x + bwd 4x)  + attention term
  prefill : 2 * N_active * tokens                      + attention term
  decode  : 2 * N_active * new_tokens                  + attention term
Attention (per layer, fwd): 4*b*s*ctx*H*dh (qk + av); causal halves the
train/prefill term; decode uses ctx = cache length.  Train multiplies the
fwd attention term by 3 (bwd is 2x fwd).  SSM terms are linear in s and
derived from the chunkwise algorithm's einsums.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.tuning import active_param_count


def _attn_flops(cfg: ModelConfig, b: int, s: int, ctx: int,
                causal: bool) -> float:
    layers = cfg.num_layers + cfg.num_encoder_layers
    if cfg.family == "ssm_xlstm":
        return 0.0  # handled by _ssm_flops
    if cfg.family == "hybrid_mamba":
        layers = max(cfg.num_layers // max(cfg.shared_attn_period, 1), 1)
        if cfg.window and s > cfg.window:
            ctx = cfg.window
    f = 4.0 * b * s * ctx * cfg.num_heads * cfg.head_dim * layers
    if causal and s == ctx:
        f *= 0.5
    if cfg.family == "encdec":  # + cross attention in the decoder
        f += 4.0 * b * s * ctx * cfg.num_heads * cfg.head_dim * cfg.num_layers
    return f


def _ssm_flops(cfg: ModelConfig, b: int, s: int) -> float:
    """Linear-scan terms (mLSTM / mamba2), fwd, per the chunkwise einsums."""
    if cfg.family == "ssm_xlstm":
        di = cfg.ssm_expand * cfg.d_model
        h = cfg.ssm_heads
        dk, dv = cfg.ssm_head_dim, di // h
        Q = cfg.ssm_chunk
        # intra-chunk: qk (Q*dk) + weighted-v (Q*dv); inter: state read/write dk*dv
        per_tok = 2 * h * (Q * dk + Q * dv + 2 * dk * dv)
        return b * s * per_tok * cfg.num_layers
    if cfg.family == "hybrid_mamba":
        di = cfg.ssm_expand * cfg.d_model
        h, n = cfg.ssm_heads, cfg.ssm_state
        p = di // h
        Q = cfg.ssm_chunk
        per_tok = 2 * (Q * n + Q * h * p + 2 * h * p * n)  # CB^T, L*x, state io
        return b * s * per_tok * cfg.num_layers
    return 0.0


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    n_active = active_param_count(cfg)
    if shape.kind == "train":
        tokens = b * s
        dense = 6.0 * n_active * tokens
        attn = 3.0 * _attn_flops(cfg, b, s, s, causal=True)
        ssm = 3.0 * _ssm_flops(cfg, b, s)
    elif shape.kind == "prefill":
        tokens = b * s
        dense = 2.0 * n_active * tokens
        attn = _attn_flops(cfg, b, s, s, causal=True)
        ssm = _ssm_flops(cfg, b, s)
    else:  # decode: one token against ctx = s
        dense = 2.0 * n_active * b
        attn = _attn_flops(cfg, b, 1, s, causal=False)
        ssm = _ssm_flops(cfg, b, 1)
    return {"dense": dense, "attention": attn, "ssm": ssm,
            "total": dense + attn + ssm, "n_active": n_active}
