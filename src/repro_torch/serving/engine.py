"""ServeEngine — the serving facade (port of ``repro/serving/engine.py``).

    AppSpec(arch, decode shape) + TargetSpec --tune--> DeploymentPlan
        (pool sizes, prefill chunk grain, kv-kernel choice, spec k)
    model_for(cfg) + build_prefill_chunk_step[_paged] +
        build_decode_step_slots[_paged] +
        build_verify_step_slots[_paged] --> steps
    KVCachePool | PagedKVCachePool (+ PrefixCache) + Scheduler +
    make_sampler(seed)
        --> continuous or gang-scheduled batching, sampled or greedy,
            with or without draft-then-verify speculation and the
            shared-prefix cache

The engine runs on the GPU: ``device=None`` means CUDA, and raises where
there is none; pass ``device="cpu"`` to run on the CPU, where every
kernel is replaced by its plain PyTorch version.  With no ``target``
the device picks it (``nvidia:h100`` on CUDA, ``local:cpu`` on the CPU).

``kv_layout`` is ``"paged"`` (pages behind a host page table) or
``"contiguous"`` (one max_len row per slot, sized by the tuner's
``plan.serve_slots``).  ``kv_kernel`` selects the paged decode attention:

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

Both are held token-identical.  The contiguous layout has no kernel in
the reference: it always attends through the gather path, on the card
too.  Speculative verify bursts read through the gather path in both
layouts, as in the reference.  The RMSNorm of every layer goes through
the hand-written RMSNorm kernel whenever the tensors are on the card.

``prefix_cache=True`` (paged layout only) attaches a shared-prefix KV
cache (``serving/prefix_cache.PrefixCache``) to every pool the engine
builds, so one per replica under a ``ReplicaRouter``: an admission whose
prompt prefix is resident reuses the cached page run and prefills only
the cold suffix.  Cached and cold streams are equal: the cache changes
where prefix KV comes from, not what it holds.

``run(..., tracer=Tracer())`` records the drain's request spans and ring
events on the virtual step clock (``serving/telemetry.py``); tracing on
and off give the same streams and counts.

A target of several chips (``local:cpu-mesh8``: 8 CPU ranks over gloo)
serves on its mesh, built through ``BuildService`` as the reference's
engine takes it: the engine runs in each rank's process, after the
caller initialized the process group, and raises where this process
holds no rank of the mesh.  The engine hands every step builder the
mesh (``training/steps.py``: each rank computes its rows, split along
``model`` by heads, MLP columns or experts and vocabulary, and every
rank gets the whole logits), puts the weights at rest as DTensors under
their specs and a pool's K/V under its specs (a contiguous pool's the
cache's, a paged pool's ``serving.pool.paged_specs``: split by KV heads
along ``model`` where they divide it, whole along ``data``).  The
scheduler, the pool's page bookkeeping, the prefix
cache and the keyed sampler run replicated on every rank: host code
that reads only the whole logits, so every rank draws the same tokens
and admits, pages and preempts alike.
"""

from __future__ import annotations

import torch

from repro_torch.core.appspec import AppSpec
from repro_torch.core.target import default_target, get_target, resolve_device
from repro_torch.core.tuning import prefix_cache_quota, tune
from repro_torch.models.params import init_params, partition_specs
from repro_torch.models.transformer import model_for
from repro_torch.serving.pool import (KVCachePool, PagedKVCachePool,
                                     paged_specs)
from repro_torch.sharding.rules import DEFAULT_RULES
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.sampling import make_sampler
from repro_torch.serving.scheduler import Scheduler, ServeStats
from repro_torch.training.steps import (build_decode_step_slots,
                                        build_decode_step_slots_paged,
                                        build_prefill_chunk_step,
                                        build_prefill_chunk_step_paged,
                                        build_prefill_step,
                                        build_verify_step_slots,
                                        build_verify_step_slots_paged,
                                        no_ranks)

SERVABLE_FAMILIES = ("dense", "moe")
KV_LAYOUTS = ("contiguous", "paged")
KV_KERNELS = ("auto", "gather", "cuda")


class ServeEngine:
    """One model + one KV pool layout + its steps; runs request traces.

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
        if kv_layout not in KV_LAYOUTS:
            raise ValueError(f"kv_layout {kv_layout!r} not in {KV_LAYOUTS}")
        if kv_kernel not in KV_KERNELS:
            raise ValueError(f"kv_kernel {kv_kernel!r} not in {KV_KERNELS}")
        if kv_kernel == "cuda" and kv_layout != "paged":
            raise ValueError(
                "kv_kernel='cuda' is the paged decode kernel: it needs "
                f"kv_layout='paged', not {kv_layout!r}")
        if prefix_cache and kv_layout != "paged":
            raise ValueError(
                "prefix_cache reuses page runs by pointer copy — it needs "
                f"kv_layout='paged', not {kv_layout!r}")
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
                f"ServeEngine needs a slot-indexable attention KV cache; "
                f"family {cfg.family!r} is served by the legacy static path")
        if cfg.window:
            raise NotImplementedError(
                "slot-wise decode does not support sliding-window attention")
        tgt = get_target(target)
        self.plan = tune(cfg, app.shape_config, tgt)
        mesh = None
        if tgt.num_chips > 1:
            from repro_torch.core.build import BuildService
            mesh = BuildService().build(app, tgt, lower=False).mesh
            if not mesh.live:
                raise no_ranks(mesh)
        # spec_k=None defers to the tuner's pick (serve_repetitiveness)
        self.spec_k = self.plan.serve_spec_k if spec_k is None else spec_k
        self.drafter = drafter
        self.kv_layout = kv_layout
        self.max_len = self.plan.serve_max_len or max_len
        if kv_layout == "paged":
            # the page pool, not the slot count, is the memory
            # reservation: slots are page-table rows, capped only by one
            # page per request
            self.page_size = page_size or self.plan.serve_page_size or 16
            if num_pages:
                self.num_pages = num_pages
            elif self.plan.serve_num_pages and \
                    self.page_size == self.plan.serve_page_size:
                self.num_pages = self.plan.serve_num_pages
            elif self.plan.serve_num_pages:
                # the tuner sized the pool for its own page size — carry
                # the *token* budget over to the requested page size
                tokens = (self.plan.serve_num_pages - 1) * \
                    self.plan.serve_page_size
                self.num_pages = max(tokens // self.page_size, 1) + 1
            else:
                self.num_pages = 0
            usable = (self.num_pages - 1) if self.num_pages else num_slots
            self.num_slots = max(1, min(num_slots, usable))
            if self.num_slots < num_slots:
                log(f"[serve] pool capped by page budget: {num_slots} -> "
                    f"{self.num_slots} slots (1 page per active request)")
        else:
            self.page_size = 0
            self.num_pages = 0
            # a contiguous slot is a worst-case reservation: the tuner may
            # cap the pool below the requested batch
            self.num_slots = self.plan.serve_slots or num_slots
            if self.num_slots < num_slots:
                log(f"[serve] pool capped by HBM budget: {num_slots} -> "
                    f"{self.num_slots} slots")
        self.cfg = cfg
        self.model = model_for(cfg)
        self.eos_id = eos_id
        self.seed = seed
        self.log = log
        # shared-prefix KV cache (paged only): an LRU pin budget out of
        # the same page pool, re-capped in make_pool against the pool
        # actually built
        self.prefix_cache = prefix_cache
        self.prefix_cache_pages = self.plan.serve_prefix_cache_pages
        # prompt-ingestion grain: None -> the tuner's chunk size; 0 ->
        # blocking full-prompt prefill; >0 -> explicit chunk tokens.
        # chunk_unit prices blocking prefills on the virtual TTFT clock.
        self.chunk_unit = self.plan.serve_prefill_chunk or 16
        self.prefill_chunk = self.chunk_unit if prefill_chunk is None \
            else prefill_chunk
        # "auto" follows the tuner's call for this target; on the card the
        # paged layout must take the kernel — the gather path there is an
        # explicit choice.  The contiguous layout has no kernel.
        if kv_layout == "contiguous":
            self.kv_kernel = "gather"
        else:
            self.kv_kernel = kv_kernel if kv_kernel != "auto" \
                else (self.plan.serve_kv_kernel or "gather")
        if kv_layout == "paged" and kv_kernel == "auto" and \
                self.device.type == "cuda" and self.kv_kernel != "cuda":
            raise ValueError(
                f"target {target!r} runs kernels="
                f"{get_target(target).kernels!r}: on a CUDA device that "
                f"would decode through the plain gather path; name a CUDA "
                f"target, or pass kv_kernel='gather' explicitly")
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = init_params(self.model.param_table(), gen, self.device)
        self.sampler = make_sampler(seed)
        self._bind(mesh)

    def _bind(self, mesh) -> None:
        """Build the steps on ``mesh`` (a ``launch.mesh.Mesh``; None: one
        device) and put the weights, whole on every rank, at rest on it:
        on a mesh of ranks each leaf a DTensor holding this rank's shard
        under its spec (sliced, nothing is sent).  On a mesh of ranks the
        pools ``make_pool`` builds rest under their specs: a contiguous
        pool's the cache's, sequence-sharded where the KV heads do not
        divide the mesh's model axis, as the build's decode cache
        (``core/build.cache_rules``); a paged pool's by KV heads where
        they divide it (``serving.pool.paged_specs``)."""
        from repro_torch.core.build import cache_rules
        self.mesh = mesh
        if mesh is not None and mesh.device_mesh is not None:
            from repro_torch.runtime.elastic import reshard_state
            self.params = reshard_state(self.params,
                                        self.model.param_table(), mesh)
        self.cache_rules = cache_rules(
            self.cfg, mesh.axis_names, mesh.shape, "decode",
            DEFAULT_RULES) if mesh is not None else None
        self._prefill = build_prefill_step(self.model, mesh)
        if self.kv_layout == "paged":
            self._decode = build_decode_step_slots_paged(
                self.model, mesh, use_kernel=(self.kv_kernel == "cuda"))
            self._chunk = build_prefill_chunk_step_paged(self.model, mesh)
            self._verify = build_verify_step_slots_paged(self.model, mesh)
        else:
            self._decode = build_decode_step_slots(self.model, mesh)
            self._chunk = build_prefill_chunk_step(self.model, mesh)
            self._verify = build_verify_step_slots(self.model, mesh)

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

    def verify_fn(self, cache, tokens, active, *extras):
        """Score a (num_slots, k+1) speculative batch: logits at every
        position (the index stays the host's)."""
        return self._verify(self.params, cache, tokens, active, *extras)

    # -- driving -----------------------------------------------------------
    def make_pool(self, prefix_cache: bool | None = None
                  ) -> KVCachePool | PagedKVCachePool:
        """A fresh pool and, when the cache is on, a fresh shared-prefix
        cache attached to it (per pool, so per replica under a router).
        ``prefix_cache`` overrides the engine's default for this pool."""
        use_cache = self.prefix_cache if prefix_cache is None \
            else prefix_cache
        on_mesh = self.mesh is not None and \
            self.mesh.device_mesh is not None
        if self.kv_layout == "paged":
            specs = paged_specs(self.model, self.num_pages, self.page_size,
                                self.mesh, DEFAULT_RULES) if on_mesh else None
            pool = PagedKVCachePool(self.model, self.num_slots, self.max_len,
                                    page_size=self.page_size,
                                    num_pages=self.num_pages,
                                    device=self.device,
                                    mesh=self.mesh if on_mesh else None,
                                    specs=specs)
            if use_cache:
                # the tuner's quota, never more than ~1/4 of the pool
                # actually built (explicit page counts may shrink it)
                cap = prefix_cache_quota(pool.num_pages)
                budget = min(self.prefix_cache_pages or cap, cap)
                PrefixCache(pool, max_pages=max(budget, 1))
            return pool
        if use_cache:
            raise ValueError("prefix_cache needs the paged KV layout")
        if not on_mesh:
            return KVCachePool(self.model, self.num_slots, self.max_len,
                               device=self.device)
        specs = partition_specs(
            self.model.cache_table(self.num_slots, self.max_len), self.mesh,
            self.cache_rules)
        return KVCachePool(self.model, self.num_slots, self.max_len,
                           device=self.device, mesh=self.mesh, specs=specs)

    def run(self, requests, policy: str = "continuous",
            prefill_chunk: int | None = None,
            prefix_cache: bool | None = None,
            spec_k: int | None = None,
            slo_ttft_steps: int = 0,
            slo_e2e_steps: int = 0,
            tracer=None) -> ServeStats:
        """Drain `requests` under `policy` ('continuous' | 'static') on a
        fresh pool.  ``prefill_chunk`` overrides the ingestion grain for
        this run (0 = blocking full-prompt prefill); ``spec_k`` the draft
        length (0 = one token per tick; spec-on and spec-off streams are
        equal by construction); ``prefix_cache`` turns the shared-prefix
        cache on or off for this run (None: the engine's setting);
        ``slo_*_steps`` set the virtual-step deadlines goodput is judged
        by.  Requests with an ``arrival_vstep`` are admitted open-loop,
        once the virtual clock reaches it.  ``tracer`` (a
        ``serving.telemetry.Tracer``) records per-request spans and ring
        events on the virtual clock — host-side only, behind None-guards,
        so tracing cannot change a single token."""
        chunk = self.prefill_chunk if prefill_chunk is None else prefill_chunk
        k = self.spec_k if spec_k is None else spec_k
        sched = Scheduler(self.make_pool(prefix_cache=prefix_cache),
                          self.decode_fn, self.chunk_fn,
                          eos_id=self.eos_id, policy=policy,
                          sampler=self.sampler, prefill_chunk=chunk,
                          prefill_chunk_unit=self.chunk_unit,
                          verify_fn=self.verify_fn if k else None,
                          spec_k=k, drafter=self.drafter,
                          vocab_size=self.cfg.vocab_size,
                          slo_ttft_steps=slo_ttft_steps,
                          slo_e2e_steps=slo_e2e_steps, tracer=tracer)
        stats = sched.run(list(requests))
        self.log(f"[serve:{self.kv_layout}:{policy}] {stats.summary()}")
        return stats
