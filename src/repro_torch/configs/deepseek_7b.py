"""deepseek-7b [dense] — arXiv:2401.02954 (llama-arch).
30L d_model=4096 32H (MHA kv=32) d_ff=11008 vocab=102400."""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="deepseek-7b", family="dense",
    num_layers=30, d_model=4096, num_heads=32, num_kv_heads=32,
    d_ff=11008, vocab_size=102400,
    activation="silu", norm="rmsnorm", pos="rope",
)

SMOKE = FULL.replace(
    name="deepseek-7b-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=4, d_ff=128, vocab_size=256,
)

register(FULL, SMOKE)
