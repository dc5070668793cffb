"""dbrx-132b [moe] — hf:databricks/dbrx-base.
40L d_model=6144 48H (GQA kv=8) d_ff=10752/expert, MoE 16 experts top-4."""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="dbrx-132b", family="moe",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8,
    head_dim=128, d_ff=10752, vocab_size=100352,
    activation="silu", norm="layernorm", pos="rope", rope_theta=5e5,
    num_experts=16, experts_per_token=4,
)

SMOKE = FULL.replace(
    name="dbrx-132b-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=256,
    num_experts=4, experts_per_token=2,
)

register(FULL, SMOKE, skip_shapes=("long_500k",))
