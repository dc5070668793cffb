"""whisper-tiny [audio enc-dec] — arXiv:2212.04356.
4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865; conv frontend stubbed."""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="whisper-tiny", family="encdec",
    num_layers=4, num_encoder_layers=4,
    d_model=384, num_heads=6, num_kv_heads=6, d_ff=1536, vocab_size=51865,
    activation="gelu", norm="layernorm", pos="learned", qkv_bias=True,
    tie_embeddings=True, max_position=1 << 20,
    notes="enc-dec; frame embeddings provided by the stub frontend",
)

SMOKE = FULL.replace(
    name="whisper-tiny-smoke", num_layers=2, num_encoder_layers=2,
    d_model=64, num_heads=2, num_kv_heads=2, d_ff=128, vocab_size=256,
    max_position=4096,
)

register(FULL, SMOKE, skip_shapes=("long_500k",))
