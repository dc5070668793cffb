"""xlstm-1.3b [ssm] — arXiv:2405.04517.
48 blocks d_model=2048, 4 heads; 7:1 mLSTM:sLSTM mix; sub-quadratic,
so it runs the long_500k cell."""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="xlstm-1.3b", family="ssm_xlstm",
    num_layers=48, d_model=2048, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
    norm="layernorm", pos="none",
    ssm_heads=4, ssm_expand=2, ssm_head_dim=512,  # qk head dim = d_inner/h/2
    ssm_chunk=256, conv_width=4, slstm_every=8,
    sub_quadratic=True,
)

SMOKE = FULL.replace(
    name="xlstm-1.3b-smoke", num_layers=4, d_model=64, num_heads=2,
    num_kv_heads=2, vocab_size=256, ssm_heads=2, ssm_head_dim=32,
    ssm_chunk=16, slstm_every=2,
)

register(FULL, SMOKE)
