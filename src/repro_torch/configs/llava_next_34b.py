"""llava-next-34b [vlm] — hf:llava-hf (Yi-34B backbone).
60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000; anyres patch
frontend stubbed (576 base patches prepended to the token stream)."""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="llava-next-34b", family="vlm",
    num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8,
    head_dim=128, d_ff=20480, vocab_size=64000,
    activation="silu", norm="rmsnorm", pos="rope", rope_theta=5e6,
    num_patches=576,
)

SMOKE = FULL.replace(
    name="llava-next-34b-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256, num_patches=16,
)

register(FULL, SMOKE, skip_shapes=("long_500k",))
