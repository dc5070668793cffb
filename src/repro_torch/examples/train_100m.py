"""End to end: train a ~100M-parameter LM for a few hundred steps
(port of ``examples/train_100m.py``).

    PYTHONPATH=src python -m repro_torch.examples.train_100m --steps 300

Uses the full production stack — EASEY build (tuned plan), deterministic
data pipeline, AdamW, atomic async checkpointing, straggler monitor, and
restart-on-failure — on the card unless given ``--device cpu`` (without
a GPU it raises otherwise).  ~100M params (12L, d=768, like GPT-2-small
with a 32k vocab); pass --steps 20 for a quick look.  Add --fail-at 150
to watch the fault-tolerance path resume from the latest checkpoint.
The config has LayerNorms, so no RMSNorm kernel runs on its path.

``main`` registers ``gpt2s-100m`` and its smoke twin in the port's
config registry (importing the module changes no registry).  The
reference registers ``gpt2s-100m-smoke`` as the same 100M config under
another name; the port's is the same family cut to 2 layers of width
64, which the CPU tests train (``ARCH`` names the one ``main`` trains).
"""

import argparse
import tempfile

from repro_torch.configs.base import ModelConfig, register
from repro_torch.launch.train import train_main

CFG_100M = ModelConfig(
    name="gpt2s-100m", family="dense",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
    d_ff=3072, vocab_size=32768,
    activation="gelu", norm="layernorm", pos="rope",
)
CFG_SMOKE = CFG_100M.replace(
    name="gpt2s-100m-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=4, d_ff=128, vocab_size=256)
ARCH = "gpt2s-100m"


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--seq-len", type=int, default=256)
    p.add_argument("--global-batch", type=int, default=8)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--fail-at", type=int, nargs="*", default=[])
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' trains on "
                        "the CPU)")
    a = p.parse_args(argv)

    register(CFG_100M, CFG_SMOKE)
    out = train_main(
        arch=ARCH, steps=a.steps, seq_len=a.seq_len,
        global_batch=a.global_batch,
        ckpt_dir=a.ckpt_dir or tempfile.mkdtemp(prefix="ckpt_100m_"),
        ckpt_every=25, fail_at=tuple(a.fail_at), device=a.device)
    print(f"\ntrained {out['steps']} steps "
          f"({out['restarts']} restarts, {out['stragglers']} stragglers)")
    print(f"loss: {out['first_loss']:.4f} -> {out['final_loss']:.4f}")
    return out


if __name__ == "__main__":
    main()
