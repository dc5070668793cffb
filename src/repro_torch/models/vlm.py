"""LLaVA-NeXT-style VLM, arch ``llava-next-34b`` (port of
``repro/models/vlm.py``).

The transformer backbone only: the vision tower and anyres tiling are a
stub, as in the reference.  A batch carries precomputed patch embeddings
(b, num_patches, d_model), prepended to the token embeddings; the
backbone's sequence is the patches, then the text, and positions run
over both.  The prefill's logits are the last position's; the loss reads
the text positions only.  Decode is the dense model's: one token per row
after the prompt.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.models.params import ParamDef
from repro_torch.models.transformer import DenseLM


class VLM(DenseLM):
    """``DenseLM`` whose stream opens with the image's patch embeddings."""

    @property
    def loss_from(self) -> int:
        return self.cfg.num_patches

    def batch_table(self, shape: ShapeConfig) -> dict:
        """The reference's inputs, in its order (the synthetic source
        draws the leaves in this order): the patches, then the text
        tokens (and labels to train on); a decode step's token."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        P = cfg.num_patches
        if shape.kind == "decode":
            return {"tokens": ParamDef((b, 1), ("act_batch", None),
                                       torch.int32, "zeros")}
        text = s - P
        if text <= 0:
            raise ValueError(f"seq_len {s} leaves no text after {P} patches")
        base = {
            "patch_embeds": ParamDef((b, P, cfg.d_model),
                                     ("act_batch", None, "act_embed"),
                                     cfg.activation_dtype, "zeros"),
            "tokens": ParamDef((b, text), ("act_batch", "act_seq"),
                               torch.int32, "zeros"),
        }
        if shape.kind == "train":
            base["labels"] = ParamDef((b, text), ("act_batch", "act_seq"),
                                      torch.int32, "zeros")
        return base

    def embed_inputs(self, params, batch):
        tok = self.embed_tokens(params, batch["tokens"])
        return torch.cat([batch["patch_embeds"].to(tok.dtype), tok], dim=1)
