"""lulesh-dash [stencil] — the paper's own evaluated application (§4).

Registered so the EASEY workflow can deploy it exactly like the LM archs;
its shape axis is the grid side and the iteration count (paper Listing
1.5: ``/built/lulesh.dash -i 1000 -s 13``), not (seq, batch)."""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="lulesh-dash", family="stencil",
    num_layers=0, d_model=0, num_heads=0, num_kv_heads=0, d_ff=0,
    vocab_size=0, pos="none",
    notes="grid/iters configured per-run (paper: -s 13 -i 1000)",
)

SMOKE = FULL.replace(name="lulesh-dash-smoke")

register(FULL, SMOKE,
         skip_shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"))
