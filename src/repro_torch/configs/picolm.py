"""picolm-4 — a 4-token-vocabulary probe model for speculative decoding
(port of ``repro/configs/picolm.py``).

Smoke-only: with random weights a 4-token vocabulary makes the greedy
continuation settle into short n-gram-predictable cycles, a stand-in for
repetitive text.  The serving benchmark's ``paged_spec_{off,on}`` cells
decode it over ``repetitive_trace``.  Everything else matches
``deepseek-7b-smoke`` (2 dense layers, d_model 64, 4 heads of 16).
"""

from repro_torch.configs.base import ModelConfig, register

SMOKE = ModelConfig(
    name="picolm-4-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=4,
    activation="silu",
    norm="rmsnorm",
    pos="rope",
    notes="4-token-vocab speculative-decoding probe (smoke-only)",
)

# the smoke under both roles: addressable as an arch, kept out of the
# full-size shapes
register(SMOKE, SMOKE, skip_shapes=("train_4k", "prefill_32k",
                                    "decode_32k", "long_500k"))
