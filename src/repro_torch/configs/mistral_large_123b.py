"""mistral-large-123b [dense] — hf:mistralai/Mistral-Large-Instruct-2407.
88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768."""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="mistral-large-123b", family="dense",
    num_layers=88, d_model=12288, num_heads=96, num_kv_heads=8,
    head_dim=128, d_ff=28672, vocab_size=32768,
    activation="silu", norm="rmsnorm", pos="rope", rope_theta=1e6,
)

SMOKE = FULL.replace(
    name="mistral-large-123b-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
)

register(FULL, SMOKE, skip_shapes=("long_500k",))
