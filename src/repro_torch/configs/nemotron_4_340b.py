"""nemotron-4-340b [dense] — arXiv:2402.16819.
96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000; squared-ReLU."""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="nemotron-4-340b", family="dense",
    num_layers=96, d_model=18432, num_heads=96, num_kv_heads=8,
    head_dim=192, d_ff=73728, vocab_size=256000,
    activation="sq_relu", norm="layernorm", pos="rope",
    rope_fraction=0.5,  # nemotron uses partial rotary
)

SMOKE = FULL.replace(
    name="nemotron-4-340b-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, head_dim=16, d_ff=256, vocab_size=512,
)

register(FULL, SMOKE, skip_shapes=("long_500k",))
