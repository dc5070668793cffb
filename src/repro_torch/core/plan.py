"""DeploymentPlan — the record of every decision the tuner makes (port of
``repro/core/plan.py``; the fields are the reference's, field for
field, so plans from both packages compare directly).  The plan is
shipped inside the package manifest so a deployment is reproducible and
auditable (the paper's tuning report)."""

from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass
class DeploymentPlan:
    arch: str
    shape: str
    target: str
    mesh_shape: tuple[int, ...]
    mesh_axes: tuple[str, ...]
    microbatches: int = 1
    remat_policy: str = "dots"            # none | dots | full
    grad_accum_dtype: str = "float32"     # float32 | bfloat16
    optimizer: str = "adamw"              # adamw | adamw8bit
    kernels: str = "reference"            # cuda | reference
    sequence_parallel: bool = False
    grad_compression: str = "none"        # none | ef_int8
    donate_state: bool = True
    serve_slots: int = 0                  # KV-pool slots (serve mode; 0 = n/a)
    serve_max_len: int = 0                # per-slot KV capacity (serve mode)
    serve_page_size: int = 0              # paged KV: tokens per page
    serve_num_pages: int = 0              # paged KV: pool pages (incl. junk 0)
    serve_replicas: int = 1               # engines the serve budget is split over
    serve_prefill_chunk: int = 0          # prompt tokens ingested per decode tick
    serve_prefix_cache_pages: int = 0     # paged KV: LRU pin cap (prefix cache)
    serve_kv_kernel: str = ""             # paged decode attn: gather | cuda
    serve_spec_k: int = 0                 # speculative draft tokens per slot
    serve_slo_ttft_steps: int = 0         # TTFT deadline (virtual steps)
    serve_slo_e2e_steps: int = 0          # end-to-end deadline (virtual steps)
    sharding_fallbacks: list = dataclasses.field(default_factory=list)
    napkin: dict = dataclasses.field(default_factory=dict)
    notes: list = dataclasses.field(default_factory=list)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["mesh_shape"] = list(self.mesh_shape)
        d["mesh_axes"] = list(self.mesh_axes)
        return json.dumps(d, indent=2)

    @classmethod
    def from_json(cls, s: str) -> "DeploymentPlan":
        d = json.loads(s)
        d["mesh_shape"] = tuple(d["mesh_shape"])
        d["mesh_axes"] = tuple(d["mesh_axes"])
        return cls(**d)

    def report(self) -> str:
        lines = [f"EASEY tuning report — {self.arch} × {self.shape} on {self.target}",
                 f"  mesh            : {dict(zip(self.mesh_axes, self.mesh_shape))}",
                 f"  microbatches    : {self.microbatches}",
                 f"  remat           : {self.remat_policy}",
                 f"  grad accum dtype: {self.grad_accum_dtype}",
                 f"  optimizer       : {self.optimizer}",
                 f"  kernels         : {self.kernels}",
                 f"  seq parallel    : {self.sequence_parallel}",
                 f"  grad compression: {self.grad_compression}"]
        if self.serve_slots:
            per = " per replica" if self.serve_replicas > 1 else ""
            lines.append(f"  serve kv pool   : {self.serve_slots} slots "
                         f"x {self.serve_max_len}{per}")
        if self.serve_num_pages:
            per = " per replica" if self.serve_replicas > 1 else ""
            lines.append(f"  serve kv pages  : {self.serve_num_pages} pages "
                         f"x {self.serve_page_size} tokens (paged layout{per})")
        if self.serve_replicas > 1:
            lines.append(f"  serve replicas  : {self.serve_replicas} "
                         f"(HBM budget split per replica)")
        if self.serve_prefill_chunk:
            lines.append(f"  serve prefill   : {self.serve_prefill_chunk} "
                         f"tokens/chunk interleaved with decode ticks")
        if self.serve_prefix_cache_pages:
            lines.append(f"  serve prefix $  : up to "
                         f"{self.serve_prefix_cache_pages} pages LRU-pinned "
                         f"for shared-prefix reuse (paged layout)")
        if self.serve_kv_kernel:
            lines.append(f"  serve kv kernel : {self.serve_kv_kernel} "
                         f"(paged decode attention)")
        if self.serve_spec_k:
            lines.append(f"  serve spec k    : {self.serve_spec_k} draft "
                         f"tokens per verify step (draft-then-verify)")
        if self.serve_slo_ttft_steps or self.serve_slo_e2e_steps:
            lines.append(f"  serve SLO       : ttft <= "
                         f"{self.serve_slo_ttft_steps} vsteps, e2e <= "
                         f"{self.serve_slo_e2e_steps} vsteps "
                         f"(goodput deadlines, virtual step clock)")
        if self.napkin:
            lines.append("  napkin math:")
            for k, v in self.napkin.items():
                lines.append(f"    {k}: {v}")
        for n in self.notes:
            lines.append(f"  note: {n}")
        for f in self.sharding_fallbacks:
            lines.append(f"  sharding fallback: {f}")
        return "\n".join(lines)
