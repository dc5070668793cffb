"""ServeEngine — the serving facade, paged layout (port of
``repro/serving/engine.py``).

    AppSpec(arch, decode shape) + TargetSpec --tune--> DeploymentPlan
        (pool sizes, prefill chunk grain, kv-kernel choice)
    model_for(cfg) + build_prefill_chunk_step_paged +
        build_decode_step_slots_paged --> steps
    PagedKVCachePool + Scheduler --> continuous or gang-scheduled batching

The engine runs on the GPU: ``device=None`` means CUDA, and raises where
there is none; pass ``device="cpu"`` to run on the CPU, where every
kernel is replaced by its plain PyTorch version.  With no ``target``
the device picks it (``nvidia:h100`` on CUDA, ``local:cpu`` on the CPU).

``kv_kernel`` selects the paged decode attention:

* ``"gather"`` — read K/V back through the page table into a
  materialized ``(slots, max_pages*page_size, K, dh)`` tensor, then
  attend (``kernels/ref.paged_attention_ref``, plain PyTorch);
* ``"cuda"`` — the hand-written paged-decode kernel
  (``kernels/csrc/paged_attention.cu``): the page table is walked on the
  card and only held pages are read;
* ``"auto"`` (default) — follow the tuner (``plan.serve_kv_kernel``:
  CUDA targets get the kernel, the others the gather).  On a CUDA device
  a target that would give the gather raises: there the gather path is
  taken only when named.

Both are held token-identical.  The RMSNorm of every layer goes through
the hand-written RMSNorm kernel whenever the tensors are on the card.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): the contiguous layout, the shared-prefix cache, speculative
decoding, tracing, and sampled (non-greedy) requests.
"""

from __future__ import annotations

import torch

from repro_torch.core.appspec import AppSpec
from repro_torch.core.target import default_target, get_target, resolve_device
from repro_torch.core.tuning import tune
from repro_torch.models.params import init_params
from repro_torch.models.transformer import model_for
from repro_torch.serving.pool import PagedKVCachePool
from repro_torch.serving.scheduler import Scheduler, ServeStats
from repro_torch.training.steps import (build_decode_step_slots_paged,
                                        build_prefill_chunk_step_paged,
                                        build_prefill_step)

SERVABLE_FAMILIES = ("dense",)
KV_LAYOUTS = ("paged",)
KV_KERNELS = ("auto", "gather", "cuda")


class ServeEngine:
    """One model + one paged KV pool + its steps; runs request traces.

    ``target=None`` takes the device's own target (``nvidia:h100`` on
    CUDA, ``local:cpu`` on the CPU)."""

    def __init__(self, arch: str = "deepseek-7b-smoke",
                 target: str | None = None, num_slots: int = 8,
                 max_len: int = 128, seed: int = 0,
                 eos_id: int | None = None, kv_layout: str = "paged",
                 page_size: int = 0, num_pages: int = 0,
                 replicas: int = 1, prefill_chunk: int | None = None,
                 prefix_cache: bool = False, kv_kernel: str = "auto",
                 spec_k: int | None = 0, drafter=None,
                 repetitiveness: float = 0.0, log=print, device=None):
        self.device = resolve_device(device)
        target = target or default_target(self.device)
        if kv_layout != "paged":
            raise NotImplementedError(
                f"kv_layout {kv_layout!r} is not ported yet (ROADMAP: "
                f"contiguous layout); the port serves kv_layout='paged'")
        if kv_kernel not in KV_KERNELS:
            raise ValueError(f"kv_kernel {kv_kernel!r} not in {KV_KERNELS}")
        if prefix_cache:
            raise NotImplementedError(
                "the shared-prefix cache is not ported yet (ROADMAP: "
                "prefix cache)")
        if drafter is not None:
            raise NotImplementedError(
                "drafters come with speculative decoding (ROADMAP: "
                "spec/verify)")
        if replicas < 1:
            raise ValueError(f"replicas {replicas} < 1")
        if spec_k is not None and spec_k < 0:
            raise ValueError(f"spec_k {spec_k} < 0")
        if not 0.0 <= repetitiveness <= 1.0:
            raise ValueError(f"repetitiveness {repetitiveness} not in [0, 1]")
        app = AppSpec(arch=arch, shape="decode_32k",
                      shape_overrides={"seq_len": max_len,
                                       "global_batch": num_slots * replicas,
                                       "serve_replicas": replicas,
                                       "serve_repetitiveness": repetitiveness})
        cfg = app.model_config
        if cfg.family not in SERVABLE_FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r} is not served by the port yet "
                f"(ROADMAP slices D, F)")
        if cfg.window:
            raise NotImplementedError(
                "slot-wise decode does not support sliding-window attention")
        self.plan = tune(cfg, app.shape_config, get_target(target))
        self.spec_k = self.plan.serve_spec_k if spec_k is None else spec_k
        if self.spec_k:
            raise NotImplementedError(
                f"spec_k={self.spec_k}: speculative decoding is not ported "
                f"yet (ROADMAP: spec/verify)")
        self.kv_layout = kv_layout
        self.max_len = self.plan.serve_max_len or max_len
        # the page pool, not the slot count, is the memory reservation:
        # slots are page-table rows, capped only by one page per request
        self.page_size = page_size or self.plan.serve_page_size or 16
        if num_pages:
            self.num_pages = num_pages
        elif self.plan.serve_num_pages and \
                self.page_size == self.plan.serve_page_size:
            self.num_pages = self.plan.serve_num_pages
        elif self.plan.serve_num_pages:
            # the tuner sized the pool for its own page size — carry the
            # *token* budget over to the requested page size
            tokens = (self.plan.serve_num_pages - 1) * self.plan.serve_page_size
            self.num_pages = max(tokens // self.page_size, 1) + 1
        else:
            self.num_pages = 0
        usable = (self.num_pages - 1) if self.num_pages else num_slots
        self.num_slots = max(1, min(num_slots, usable))
        if self.num_slots < num_slots:
            log(f"[serve] pool capped by page budget: {num_slots} -> "
                f"{self.num_slots} slots (1 page per active request)")
        self.cfg = cfg
        self.model = model_for(cfg)
        self.eos_id = eos_id
        self.log = log
        # prompt-ingestion grain: None -> the tuner's chunk size; 0 ->
        # blocking full-prompt prefill; >0 -> explicit chunk tokens.
        # chunk_unit prices blocking prefills on the virtual TTFT clock.
        self.chunk_unit = self.plan.serve_prefill_chunk or 16
        self.prefill_chunk = self.chunk_unit if prefill_chunk is None \
            else prefill_chunk
        # "auto" follows the tuner's call for this target; on the card it
        # must be the kernel — the gather path there is an explicit choice
        self.kv_kernel = kv_kernel if kv_kernel != "auto" \
            else (self.plan.serve_kv_kernel or "gather")
        if kv_kernel == "auto" and self.device.type == "cuda" and \
                self.kv_kernel != "cuda":
            raise ValueError(
                f"target {target!r} runs kernels="
                f"{get_target(target).kernels!r}: on a CUDA device that "
                f"would decode through the plain gather path; name a CUDA "
                f"target, or pass kv_kernel='gather' explicitly")
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = init_params(self.model.param_table(), gen, self.device)
        self._prefill = build_prefill_step(self.model)
        self._decode = build_decode_step_slots_paged(
            self.model, use_kernel=(self.kv_kernel == "cuda"))
        self._chunk = build_prefill_chunk_step_paged(self.model)

    # -- step wrappers bound to the params ---------------------------------
    def prefill_fn(self, tokens: torch.Tensor, last: int | None = None):
        batch = {"tokens": tokens}
        if last is not None:
            batch["last"] = last
        return self._prefill(self.params, batch)

    def decode_fn(self, cache, tokens, active, *extras):
        return self._decode(self.params, cache, tokens, active, *extras)

    def chunk_fn(self, cache, tokens, slot, offset, n_valid, kv_bound,
                 *extras):
        """Prefill one prompt chunk straight into the pool (in place)."""
        return self._chunk(self.params, cache, tokens, slot, offset,
                           n_valid, kv_bound, *extras)

    # -- driving -----------------------------------------------------------
    def make_pool(self) -> PagedKVCachePool:
        return PagedKVCachePool(self.model, self.num_slots, self.max_len,
                                page_size=self.page_size,
                                num_pages=self.num_pages, device=self.device)

    def run(self, requests, policy: str = "continuous",
            prefill_chunk: int | None = None,
            prefix_cache: bool | None = None,
            spec_k: int | None = None,
            slo_ttft_steps: int = 0,
            slo_e2e_steps: int = 0,
            tracer=None) -> ServeStats:
        """Drain `requests` under `policy` ('continuous' | 'static') on a
        fresh pool.  ``prefill_chunk`` overrides the ingestion grain for
        this run (0 = blocking full-prompt prefill); ``slo_*_steps`` set
        the virtual-step deadlines goodput is judged by."""
        if prefix_cache:
            raise NotImplementedError("prefix cache (ROADMAP: prefix cache)")
        if spec_k:
            raise NotImplementedError("spec_k > 0 (ROADMAP: spec/verify)")
        if tracer is not None:
            raise NotImplementedError("tracing (ROADMAP: telemetry)")
        chunk = self.prefill_chunk if prefill_chunk is None else prefill_chunk
        sched = Scheduler(self.make_pool(), self.decode_fn, self.chunk_fn,
                          eos_id=self.eos_id, policy=policy,
                          prefill_chunk=chunk,
                          prefill_chunk_unit=self.chunk_unit,
                          slo_ttft_steps=slo_ttft_steps,
                          slo_e2e_steps=slo_e2e_steps)
        stats = sched.run(list(requests))
        self.log(f"[serve:{self.kv_layout}:{policy}] {stats.summary()}")
        return stats
