"""Model / shape configuration schema and registry (port of
``repro/configs/base.py``).

A ``ModelConfig`` is the portable architecture description; deployment
decisions live in the tuner's ``DeploymentPlan``.  The fields are the
reference's, field for field, with ``torch`` dtypes in place of
``jnp`` ones.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense|moe|ssm_xlstm|hybrid_mamba|encdec|vlm|stencil
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    activation: str = "silu"         # silu|gelu|geglu|sq_relu
    norm: str = "rmsnorm"            # rmsnorm|layernorm
    pos: str = "rope"                # rope|learned|sinusoidal|none
    rope_fraction: float = 1.0
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    tie_embeddings: bool = False
    causal: bool = True
    max_position: int = 1 << 20
    activation_dtype: Any = torch.bfloat16
    param_dtype: Any = torch.bfloat16
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # --- encoder-decoder (whisper) ---
    num_encoder_layers: int = 0
    # --- VLM (llava) ---
    num_patches: int = 0
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 0
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_width: int = 4
    slstm_every: int = 0             # xlstm: every k-th block is sLSTM
    shared_attn_period: int = 0      # zamba2: shared attn block cadence
    window: int = 0                  # sliding-window attention (0 = full)
    # --- misc ---
    sub_quadratic: bool = False      # eligible for long_500k
    notes: str = ""

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode
    serve_replicas: int = 1          # serve: engines sharing the HBM budget
    serve_repetitiveness: float = 0.0  # serve: trace n-gram self-overlap


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

ARCHS: dict[str, dict] = {}


def register(cfg: ModelConfig, smoke: ModelConfig,
             skip_shapes: tuple[str, ...] = ()) -> ModelConfig:
    """Register a full config and its smoke config (smoke configs are
    addressable archs too); ``skip_shapes`` names the shapes the arch has
    no dry-run cell for."""
    ARCHS[cfg.name] = {"full": cfg, "skip_shapes": skip_shapes}
    ARCHS[smoke.name] = {"full": smoke, "skip_shapes": skip_shapes,
                         "is_smoke": True}
    return cfg


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"arch {arch!r} is not ported yet; ported: "
                       f"{sorted(ARCHS)} (ROADMAP: other arch configs)")
    return ARCHS[arch]["full"]


def list_archs(include_smoke: bool = False) -> list[str]:
    return sorted(a for a, m in ARCHS.items()
                  if include_smoke or not m.get("is_smoke"))


def cells(include_skipped: bool = False):
    """All (arch, shape, skipped) cells of the full configs, each shape
    of ``SHAPES`` once; ``skipped`` flags a shape the arch skips (listed
    only with ``include_skipped``).  LULESH has its own shape axis."""
    out = []
    for arch in list_archs():
        meta = ARCHS[arch]
        if meta["full"].family == "stencil":
            continue
        for shape in SHAPES.values():
            skipped = shape.name in meta["skip_shapes"]
            if skipped and not include_skipped:
                continue
            out.append((arch, shape.name, skipped))
    return out
