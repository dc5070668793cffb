"""Batched serving example (port of ``examples/serve_batch.py``): prefill
a request batch, decode with a donated KV cache; works for every family
(dense GQA, MoE, xLSTM O(1)-state, ...).

    PYTHONPATH=src python -m repro_torch.examples.serve_batch \\
        --device cpu --arch xlstm-1.3b-smoke

On the card (the default device) the paged layout decodes through the
paged-attention kernel and every norm goes through the RMSNorm kernel:

    PYTHONPATH=src python -m repro_torch.examples.serve_batch \\
        --arch deepseek-7b --kv-layout paged --decode 8

Speculative decoding rides the same entry point: ``--spec-k 4`` drafts 4
tokens per slot from each request's own history and verifies them in one
step (``--spec-k auto`` lets the tuner pick from the trace's measured
repetitiveness).  Streams are bit-identical to ``--spec-k 0``; on a
repetitive trace the accepted-tokens/verify-step figure printed below
clears 1 and decode finishes in fewer steps:

    PYTHONPATH=src python -m repro_torch.examples.serve_batch \\
        --device cpu --arch picolm-4-smoke --kv-layout paged \\
        --trace repetitive --decode 48 --spec-k 4

Without a GPU it raises unless given ``--device cpu``.
"""

import argparse

from repro_torch.launch.serve import TRACES, serve_main


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="deepseek-7b-smoke")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prefill", type=int, default=64)
    p.add_argument("--decode", type=int, default=16)
    p.add_argument("--kv-layout", default="contiguous")
    p.add_argument("--trace", choices=TRACES, default="uniform")
    p.add_argument("--spec-k", default="0",
                   help="draft tokens per verify step (0=off, 'auto'=tuner)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs the "
                        "plain versions of the kernels on the CPU)")
    a = p.parse_args(argv)
    spec_k = None if a.spec_k == "auto" else int(a.spec_k)
    out = serve_main(arch=a.arch, batch=a.batch, prefill_len=a.prefill,
                     decode_tokens=a.decode, kv_layout=a.kv_layout,
                     trace=a.trace, spec_k=spec_k, device=a.device)
    msg = (f"\n{a.arch}: {out['decode_tok_per_s']:.1f} decode tok/s "
           f"(batch={a.batch}); first tokens of request 0: {out['sample']}")
    if out.get("spec_verify_steps"):
        msg += (f"\nspeculative: k={out['spec_k']}, "
                f"{out['accepted_per_verify']:.2f} tokens/verify-step "
                f"({out['spec_accepted_tokens']}/{out['spec_drafted_tokens']}"
                f" drafts accepted over {out['spec_verify_steps']} verifies)")
    print(msg)
    return out


if __name__ == "__main__":
    main()
