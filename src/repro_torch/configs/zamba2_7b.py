"""zamba2-7b [hybrid] — arXiv:2411.15242.
81 Mamba2 layers d_model=3584, ssm_state=64, + ONE shared attention+MLP
block (32H, d_ff=14336) applied every 6 mamba layers.  Sub-quadratic:
runs long_500k with a 4k sliding window on the shared attention."""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="zamba2-7b", family="hybrid_mamba",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
    d_ff=14336, vocab_size=32000,
    activation="silu", norm="rmsnorm", pos="rope",
    ssm_state=64, ssm_heads=112, ssm_expand=2, ssm_head_dim=64,
    ssm_chunk=256, conv_width=4, shared_attn_period=6,
    window=4096, sub_quadratic=True,
)

SMOKE = FULL.replace(
    name="zamba2-7b-smoke", num_layers=5, d_model=64, num_heads=4,
    num_kv_heads=4, d_ff=128, vocab_size=256,
    ssm_state=8, ssm_heads=4, ssm_head_dim=32, ssm_chunk=16,
    shared_attn_period=2, window=0,
)

register(FULL, SMOKE)
