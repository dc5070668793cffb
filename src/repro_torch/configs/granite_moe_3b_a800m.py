"""granite-moe-3b-a800m [moe] — hf:ibm-granite (assignment numbers).
32L d_model=1536 24H (GQA kv=8) d_ff=512/expert, MoE 40 experts top-8."""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8,
    d_ff=512, vocab_size=49155,
    activation="silu", norm="rmsnorm", pos="rope",
    num_experts=40, experts_per_token=8,
    notes="40 experts do not divide the 16-way model axis: the sharding "
          "fallback keeps experts replicated and TP-shards d_ff (see tuning report)",
)

SMOKE = FULL.replace(
    name="granite-moe-3b-a800m-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, d_ff=64, vocab_size=256, num_experts=4, experts_per_token=2,
)

register(FULL, SMOKE, skip_shapes=("long_500k",))
