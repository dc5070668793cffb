"""Serving entry point (EASEY RUN command `serve ...`), port of
``repro/launch/serve.py`` — a thin CLI over the continuous-batching
``ServeEngine`` and the ``ReplicaRouter`` (``repro_torch/serving/``).

Dense and MoE families go through the engine: a KV-cache pool sized by the
tuner's serve-mode branch (``--kv-layout contiguous`` reserves
slots x max_len worst cases; ``--kv-layout paged`` buys a page pool with
the same budget and admits by actual tokens), slot-wise decode with
per-request sampling (``--temperature`` / ``--top-k``), and a scheduler
that refills freed slots between steps.  ``--replicas N`` serves through
a router fleet.

It runs on the card unless ``--device cpu`` (``device="cpu"``) is asked
for, and raises where there is no card; the target defaults to the
device's own (``nvidia:h100``: the paged layout decodes through the
hand-written paged-decode kernel; ``local:cpu``: the plain versions).

    python -m repro_torch.launch.serve --device cpu \\
        --arch deepseek-7b-smoke --kv-layout paged --trace-out t.json

A target of several chips serves on its mesh, one process per rank of
an initialized process group (``local:cpu-mesh8``: 8 CPU ranks over
gloo), each rank computing its rows of every step.

Families the engine cannot serve take the reference's legacy
fixed-batch path (``_legacy_serve_main``): one batch prefilled at once,
then greedy whole-batch decode steps: the VLM, xLSTM, Zamba2 hybrid
and enc-dec (Whisper) families.

    python -m repro_torch.launch.serve --device cpu \\
        --arch zamba2-7b-smoke --batch 2 --prefill 32 --decode 8
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.core.target import (default_target, device_for, get_target,
                                     resolve_device)
from repro_torch.models.params import init_params

# synthetic request mixes the engine/router paths can serve
TRACES = ("uniform", "zipf", "longprompt", "sharedprefix", "repetitive")


def _make_trace(name: str, n: int, vocab: int, prefill_len: int,
                decode_tokens: int, seed: int, temperature: float,
                top_k: int, top_p: float = 1.0, page_size: int = 0):
    from repro_torch.serving import (longprompt_trace, repetitive_trace,
                                     sharedprefix_trace, uniform_trace,
                                     zipf_trace)
    kw = dict(max_new=decode_tokens, seed=seed, temperature=temperature,
              top_k=top_k, top_p=top_p)
    if name == "zipf":
        return zipf_trace(n, vocab, max_prompt=prefill_len, **kw)
    if name == "longprompt":
        return longprompt_trace(n, vocab, max_prompt=prefill_len, **kw)
    if name == "repetitive":
        return repetitive_trace(n, vocab, prompt_len=prefill_len, **kw)
    if name == "sharedprefix":
        # head = half the prompt budget, aligned to the pool's real page
        # size so the prefix cache has whole pages to reuse; a budget too
        # small for an aligned head falls back to an unaligned one
        ps = page_size or 16
        head = prefill_len // 2 // ps * ps
        if head < 1:
            head = max(min(ps, prefill_len - 1), 1)
        return sharedprefix_trace(n, vocab, head_len=head,
                                  max_suffix=max(prefill_len - head, 1),
                                  **kw)
    return uniform_trace(n, vocab, prompt_len=prefill_len, **kw)


def _auto_repetitiveness(spec_k, trace, n, vocab, prefill_len,
                         decode_tokens, seed, temperature, top_k, top_p,
                         page_size) -> float:
    """The tuner hint behind ``--spec-k auto`` (``spec_k=None``): the
    ``trace_repetitiveness`` of a preview build of the trace (the preview
    cannot see a tuner-sized pool, so ``sharedprefix`` aligns its head
    to ``page_size or 16``; the hint never changes a stream)."""
    if spec_k is not None:      # explicit k (or 0/off): no hint needed
        return 0.0
    from repro_torch.serving import trace_repetitiveness
    preview = _make_trace(trace, n, vocab, prefill_len, decode_tokens,
                          seed, temperature, top_k, top_p,
                          page_size=page_size or 16)
    return trace_repetitiveness(preview)


def _resolve_slo(slo_ttft: int, slo_e2e: int, plan) -> tuple[int, int]:
    """-1 = adopt the tuner's napkin deadlines (``plan.serve_slo_*``)."""
    if slo_ttft < 0:
        slo_ttft = int(plan.serve_slo_ttft_steps)
    if slo_e2e < 0:
        slo_e2e = int(plan.serve_slo_e2e_steps)
    return slo_ttft, slo_e2e


def serve_main(arch: str = "deepseek-7b-smoke", batch: int = 4,
               prefill_len: int = 64, decode_tokens: int = 16,
               target: str | None = None, seed: int = 0,
               mode: str = "continuous", requests: int = 0,
               max_len: int = 0, kv_layout: str = "contiguous",
               page_size: int = 0, temperature: float = 0.0,
               top_k: int = 0, top_p: float = 1.0, replicas: int = 1,
               route_policy: str = "least_loaded",
               prefill_chunk: int | None = None,
               prefix_cache: bool = False, kv_kernel: str = "auto",
               spec_k: int | None = 0,
               trace: str = "uniform", arrivals: str = "closed",
               arrival_gap: float = 4.0, slo_ttft: int = 0,
               slo_e2e: int = 0, admission: str = "queue",
               autoscale: int = 0, trace_out: str | None = None,
               metrics_out: str | None = None,
               prom_out: str | None = None, log=print,
               device=None) -> dict:
    """Serve `requests` requests (default: one per slot) of `prefill_len`
    prompts, `decode_tokens` generations each, and report per-request
    latency and aggregate tokens/s.  The options are the reference's:
    ``replicas`` > 1 routes through a ``ReplicaRouter`` (``kv_layout``
    comma-separated mixes layouts, ``route_policy`` balances);
    ``prefill_chunk`` is the prompt-ingestion grain (None: the tuner's;
    0: blocking); ``prefix_cache`` (paged only) reuses shared-prefix page
    runs; ``kv_kernel`` picks the paged decode attention (auto | gather |
    cuda); ``spec_k`` turns on draft-then-verify (None: the tuner picks
    from the trace's repetitiveness).  ``arrivals`` / ``arrival_gap``
    stamp an open-loop arrival process; ``slo_ttft`` / ``slo_e2e`` are
    goodput deadlines in virtual steps (-1: the tuner's);
    ``admission='reject'`` and ``autoscale=N`` need the router path.
    Token streams are the same under every one of these switches.

    ``trace_out`` writes a Chrome-trace/Perfetto JSON timeline of the run
    (virtual-step timestamps, byte-identical across identical runs),
    ``metrics_out`` the flat ``to_metrics()`` snapshot as JSON (NaN ->
    null), ``prom_out`` the same snapshot in Prometheus text format.

    A family the engine cannot serve takes the legacy fixed-batch path
    (``_legacy_serve_main``), with the reference's refusals of the flags
    it has no use for.

    ``device``: the card unless ``"cpu"``; ``target`` defaults to the
    device's own.  A target of several chips (``local:cpu-mesh8``) serves
    on its mesh: call this in each rank's process after initializing the
    process group, as ``train_main``; without the ranks it raises."""
    cfg = get_config(arch)
    if trace not in TRACES:
        raise ValueError(f"trace {trace!r} not in {tuple(TRACES)}")
    from repro_torch.serving import ADMISSION_MODES, ARRIVAL_MODES
    if arrivals not in ARRIVAL_MODES:
        raise ValueError(f"arrivals {arrivals!r} not in {ARRIVAL_MODES}")
    if admission not in ADMISSION_MODES:
        raise ValueError(f"admission {admission!r} not in {ADMISSION_MODES}")
    if replicas == 1 and (admission != "queue" or autoscale):
        raise NotImplementedError(
            "--admission reject and --autoscale need the router path "
            "(--replicas > 1); the single engine always queues")
    if autoscale and not (1 <= autoscale <= replicas):
        raise ValueError(
            f"--autoscale {autoscale} must be in [1, --replicas={replicas}]")
    from repro_torch.serving.engine import SERVABLE_FAMILIES
    if cfg.family not in SERVABLE_FAMILIES:
        if trace_out or metrics_out or prom_out:
            raise NotImplementedError(
                f"--trace-out/--metrics-out/--prom-out need an engine-"
                f"servable family {SERVABLE_FAMILIES}; {arch} "
                f"({cfg.family}) is served by the legacy static path, "
                f"which has no scheduler to trace")
        if replicas > 1:
            raise NotImplementedError(
                f"--replicas needs an engine-servable family "
                f"{SERVABLE_FAMILIES}; {arch} ({cfg.family}) is served by "
                f"the legacy static path")
        dev = resolve_device(device)
        return _legacy_serve_main(arch, batch, prefill_len, decode_tokens,
                                  target or default_target(dev), seed, log,
                                  device=dev)

    dev = resolve_device(device)
    target = target or default_target(dev)
    from repro_torch.serving import ServeEngine, Tracer, with_arrivals
    pool_len = max_len or (prefill_len + decode_tokens)
    repetitiveness = _auto_repetitiveness(
        spec_k, trace, requests or batch * replicas, cfg.vocab_size,
        prefill_len, decode_tokens, seed, temperature, top_k, top_p,
        page_size)
    tracer = Tracer() if trace_out else None
    if replicas > 1:
        return _router_serve_main(
            arch=arch, batch=batch, prefill_len=prefill_len,
            decode_tokens=decode_tokens, target=target, seed=seed,
            mode=mode, requests=requests, pool_len=pool_len,
            kv_layout=kv_layout, page_size=page_size,
            temperature=temperature, top_k=top_k, top_p=top_p,
            replicas=replicas, route_policy=route_policy,
            prefill_chunk=prefill_chunk, prefix_cache=prefix_cache,
            kv_kernel=kv_kernel, spec_k=spec_k,
            repetitiveness=repetitiveness, trace=trace, arrivals=arrivals,
            arrival_gap=arrival_gap, slo_ttft=slo_ttft, slo_e2e=slo_e2e,
            admission=admission, autoscale=autoscale, tracer=tracer,
            trace_out=trace_out, metrics_out=metrics_out,
            prom_out=prom_out, log=log, device=dev)
    engine = ServeEngine(arch=arch, target=target, num_slots=batch,
                         max_len=pool_len, seed=seed, kv_layout=kv_layout,
                         page_size=page_size, prefill_chunk=prefill_chunk,
                         prefix_cache=prefix_cache, kv_kernel=kv_kernel,
                         spec_k=spec_k, repetitiveness=repetitiveness,
                         log=log, device=dev)
    n = requests or engine.num_slots
    reqs = _make_trace(trace, n, cfg.vocab_size, prefill_len,
                       decode_tokens, seed, temperature, top_k, top_p,
                       page_size=engine.page_size)
    reqs = with_arrivals(reqs, arrivals, mean_gap=arrival_gap, seed=seed)
    slo_ttft, slo_e2e = _resolve_slo(slo_ttft, slo_e2e, engine.plan)
    stats = engine.run(reqs, policy=mode, slo_ttft_steps=slo_ttft,
                       slo_e2e_steps=slo_e2e, tracer=tracer)
    for r in stats.results:
        log(f"[serve]   req {r.rid}: {r.prompt_len}+{len(r.tokens)} tokens, "
            f"ttft {r.ttft_s*1e3:.1f}ms, latency {r.latency_s*1e3:.1f}ms")
    out = {
        "arch": arch, "batch": engine.num_slots, "prefill_len": prefill_len,
        "decode_tokens": decode_tokens, "mode": mode,
        "kv_layout": kv_layout,
        "kv_kernel": engine.kv_kernel,
        "requests": len(stats.results),
        "decode_steps": stats.decode_steps,
        "occupancy": stats.occupancy,
        "peak_active": stats.peak_active,
        "preemptions": stats.preemptions,
        "prefill_chunks": stats.prefill_chunks,
        "prefill_compiles": stats.prefill_buckets,
        "prefill_queue_peak": stats.prefill_queue_peak,
        "overlap_steps": stats.overlap_steps,
        "mean_ttft_steps": stats.mean_ttft_steps,
        "prefix_hits": stats.prefix_hits,
        "prefix_misses": stats.prefix_misses,
        "prefill_tokens_saved": stats.prefill_tokens_saved,
        "spec_k": engine.spec_k,
        "spec_verify_steps": stats.spec_verify_steps,
        "spec_drafted_tokens": stats.spec_drafted_tokens,
        "spec_accepted_tokens": stats.spec_accepted_tokens,
        "accepted_per_verify": stats.accepted_per_verify,
        "effective_top_k": stats.effective_top_k,
        "arrivals": arrivals,
        "p50_ttft_steps": stats.p50_ttft_steps,
        "p99_ttft_steps": stats.p99_ttft_steps,
        "p50_e2e_steps": stats.p50_e2e_steps,
        "p99_e2e_steps": stats.p99_e2e_steps,
        "goodput_tokens": stats.goodput_tokens,
        "slo_ttft_steps": stats.slo_ttft_steps,
        "slo_e2e_steps": stats.slo_e2e_steps,
        "metrics": stats.to_metrics(),
        "decode_s": stats.wall_s,
        "decode_tok_per_s": stats.tokens_per_s,
        "latency_mean_s": float(np.mean([r.latency_s
                                         for r in stats.results])),
        "sample": stats.results[0].tokens[:8],
        "plan": engine.plan,
        "device": str(dev),
        "stats": stats,
    }
    log(f"[serve] {kv_layout}:{mode}: {out['decode_tok_per_s']:.1f} tok/s "
        f"aggregate, occupancy {stats.occupancy:.0%}, "
        f"peak {stats.peak_active} in flight")
    _write_telemetry(out["metrics"], tracer, trace_out, metrics_out,
                     prom_out, log)
    return out


def _router_serve_main(arch, batch, prefill_len, decode_tokens, target,
                       seed, mode, requests, pool_len, kv_layout, page_size,
                       temperature, top_k, top_p, replicas, route_policy,
                       prefill_chunk=None, prefix_cache=False,
                       kv_kernel="auto", spec_k=0, repetitiveness=0.0,
                       trace="uniform", arrivals="closed", arrival_gap=4.0,
                       slo_ttft=0, slo_e2e=0, admission="queue",
                       autoscale=0, tracer=None, trace_out=None,
                       metrics_out=None, prom_out=None, log=print,
                       device=None) -> dict:
    """Multi-replica path: ReplicaRouter over N tuner-split engines."""
    from repro_torch.serving import (AutoscalePolicy, ReplicaRouter,
                                     with_arrivals)
    cfg = get_config(arch)
    router = ReplicaRouter.build(
        arch=arch, target=target, replicas=replicas, kv_layout=kv_layout,
        num_slots=batch, max_len=pool_len, seed=seed, policy=route_policy,
        page_size=page_size, prefill_chunk=prefill_chunk,
        prefix_cache=prefix_cache, kv_kernel=kv_kernel,
        spec_k=spec_k, repetitiveness=repetitiveness, log=log, device=device)
    n = requests or batch * replicas
    reqs = _make_trace(trace, n, cfg.vocab_size, prefill_len,
                       decode_tokens, seed, temperature, top_k, top_p,
                       page_size=max(e.page_size for e in router.engines))
    reqs = with_arrivals(reqs, arrivals, mean_gap=arrival_gap, seed=seed)
    slo_ttft, slo_e2e = _resolve_slo(slo_ttft, slo_e2e,
                                     router.engines[0].plan)
    policy_obj = (AutoscalePolicy(min_replicas=autoscale,
                                  max_replicas=replicas)
                  if autoscale else None)
    stats = router.run(reqs, policy=mode, slo_ttft_steps=slo_ttft,
                       slo_e2e_steps=slo_e2e, admission=admission,
                       autoscale=policy_obj, tracer=tracer)
    for rej in stats.rejected:
        log(f"[serve]   req {rej.rid} REJECTED at v{rej.v_reject}: "
            f"{rej.reason}")
    for r in stats.results:
        log(f"[serve]   req {r.rid} -> replica "
            f"{stats.replica_of[r.rid]}: {r.prompt_len}+{len(r.tokens)} "
            f"tokens, latency {r.latency_s*1e3:.1f}ms")
    out = {
        "arch": arch, "batch": batch, "prefill_len": prefill_len,
        "decode_tokens": decode_tokens, "mode": mode,
        "kv_layout": kv_layout, "replicas": replicas,
        "route_policy": route_policy,
        "requests": len(stats.results),
        "reroutes": stats.reroutes,
        "peak_in_flight": stats.peak_in_flight,
        "imbalance": stats.imbalance,
        "prefill_chunks": stats.prefill_chunks,
        "overlap_steps": stats.overlap_steps,
        "mean_ttft_steps": stats.mean_ttft_steps,
        "prefix_hits": stats.prefix_hits,
        "prefix_misses": stats.prefix_misses,
        "prefill_tokens_saved": stats.prefill_tokens_saved,
        "spec_k": router.engines[0].spec_k,
        "spec_verify_steps": stats.spec_verify_steps,
        "spec_drafted_tokens": stats.spec_drafted_tokens,
        "spec_accepted_tokens": stats.spec_accepted_tokens,
        "accepted_per_verify": stats.accepted_per_verify,
        "effective_top_k": stats.effective_top_k,
        "arrivals": arrivals,
        "admission": admission,
        "autoscale": autoscale,
        "rejected": len(stats.rejected),
        "metrics": stats.to_metrics(),
        "decode_s": stats.wall_s,
        "decode_tok_per_s": stats.tokens_per_s,
        "latency_mean_s": (float(np.mean([r.latency_s
                                          for r in stats.results]))
                           if stats.results else float("nan")),
        "sample": stats.results[0].tokens[:8] if stats.results else [],
        "plan": router.engines[0].plan,
        "device": str(device),
        "stats": stats,
    }
    log(f"[serve] {replicas}x{kv_layout}:{route_policy}:{mode}: "
        f"{out['decode_tok_per_s']:.1f} tok/s fleet, peak "
        f"{stats.peak_in_flight} in flight, imbalance "
        f"{stats.imbalance:.2f}")
    log("[serve] " + stats.summary())
    _write_telemetry(out["metrics"], tracer, trace_out, metrics_out,
                     prom_out, log)
    return out


def _write_telemetry(metrics, tracer, trace_out, metrics_out, prom_out,
                     log=print) -> None:
    """Write the post-run telemetry exports a flag asked for.

    ``metrics`` is a flat ``to_metrics()`` snapshot (its key prefix
    picks the schema); the trace file is pure virtual-step data, so two
    identical runs produce byte-identical files."""
    if not (trace_out or metrics_out or prom_out):
        return
    from repro_torch.serving.telemetry import (ROUTER_SCHEMA, SERVE_SCHEMA,
                                               json_sanitize,
                                               prometheus_text,
                                               write_chrome_trace)
    if metrics_out:
        Path(metrics_out).write_text(
            json.dumps(json_sanitize(metrics), indent=2, sort_keys=False)
            + "\n")
        log(f"[serve] wrote metrics snapshot ({len(metrics)} keys) -> "
            f"{metrics_out}")
    if prom_out:
        schema = SERVE_SCHEMA if any(k.startswith("serve_") for k in metrics) \
            else ROUTER_SCHEMA
        Path(prom_out).write_text(prometheus_text(metrics, schema))
        log(f"[serve] wrote Prometheus exposition -> {prom_out}")
    if trace_out and tracer is not None:
        trace = write_chrome_trace(tracer, trace_out)
        log(f"[serve] wrote Chrome trace ({len(trace['traceEvents'])} "
            f"events; load in Perfetto / chrome://tracing) -> {trace_out}")


def _grow(v: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    shape = list(v.shape)
    shape[axis] = n
    return torch.cat([v, v.new_zeros(shape)], dim=axis)


def grow_kv(cache: dict, n: int) -> dict:
    """A prefill's cache with every attention K/V grown by ``n`` zero
    positions along its sequence axis (axis 2 of a stacked (layers, b, s,
    K, dh) cache, else axis 1), nested caches included: the hybrid
    family's shared-block K/V lives in ``cache["shared_kv"]``.  The
    reference's legacy path grows only a top-level ``"k"``, so its decode
    writes into a hybrid's ungrown K/V clamp onto the last prompt position
    (or, under a window, evict the ring's oldest); its own decode test
    grows them all, as here.  A recurrent state has no K/V and stays as
    it is, and so do an enc-dec's cross K/V (``"xk"``, ``"xv"``), which
    keep the encoder's length: its decode steps read them whole.  A K/V
    at rest on a mesh (a DTensor, its rows along ``data``, its KV heads
    along ``model`` or whole) grows its local shard, which holds the
    whole sequence axis; a K/V split along its sequence
    (``DECODE_SEQ_CACHE_RULES``) gathers its sequence shards, grows, and
    rests again under the same placements over the new length
    (``_grow_dtensor``)."""
    out = {}
    for key, v in cache.items():
        if isinstance(v, dict):
            out[key] = grow_kv(v, n)
        elif key in ("k", "v") and isinstance(v, torch.Tensor) and \
                v.dim() >= 3:
            axis = 2 if v.dim() == 5 else 1
            out[key] = _grow_dtensor(v, axis, n) \
                if hasattr(v, "placements") else _grow(v, axis, n)
        else:
            out[key] = v
    return out


def _grow_dtensor(v, axis: int, n: int):
    """A K/V at rest grown by ``n`` zero positions along ``axis``: the
    local shard grown where the sequence rests whole on the rank; where
    mesh dimensions split the sequence, its shards all-gathered over
    them (minor first), grown, and the rank's block of the new length
    kept under the same placements (a split that does not divide the new
    length falls back to whole, as the sharding rules fall back)."""
    import math
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.sharding.rules import contiguous_stride, shard_index
    from repro_torch.sharding.split import Collectives
    dm, pls = v.device_mesh, list(v.placements)
    seq = [m for m, pl in enumerate(pls)
           if pl.is_shard() and pl.dim == axis and dm.size(m) > 1]
    local = v.to_local()
    comm = Collectives()
    for m in reversed(seq):
        local = comm.all_gather(local, axis, dm.get_group(m), dm.size(m))
    local = _grow(local, axis, n)
    shape = list(v.shape)
    shape[axis] += n
    if seq and shape[axis] % math.prod(dm.size(m) for m in seq):
        pls = [Replicate() if m in seq else pl for m, pl in enumerate(pls)]
        seq = []
    if seq:
        idx = shard_index(local.shape, [pl if m in seq else Replicate()
                                        for m, pl in enumerate(pls)],
                          tuple(dm.shape), dm.get_coordinate())
        local = local[idx].contiguous()
    return DTensor.from_local(local, dm, pls, run_check=False,
                              shape=tuple(shape),
                              stride=contiguous_stride(shape))


def legacy_generate(prefill, decode, params, req: dict,
                    decode_tokens: int, device: torch.device):
    """The legacy path's generation: ``req`` prefilled at once, every K/V
    of the cache grown by ``decode_tokens`` (``grow_kv``), then
    ``decode_tokens - 1`` greedy whole-batch steps.  Returns (the (b,
    decode_tokens) tokens as a numpy array, prefill s, decode s)."""
    from repro_torch.launch.run import _timed
    (logits, cache), t_prefill = _timed(lambda: prefill(params, req), device)
    cache = grow_kv(cache, decode_tokens)

    def greedy(logits):
        return logits[:, -1].argmax(-1).to(torch.int32)[:, None]

    generated = [greedy(logits)]

    def steps(cache):
        for _ in range(decode_tokens - 1):
            logits, cache = decode(params, cache, generated[-1])
            generated.append(greedy(logits))

    _, t_decode = _timed(lambda: steps(cache), device)
    return torch.cat(generated, dim=1).cpu().numpy(), t_prefill, t_decode


def _legacy_serve_main(arch: str, batch: int, prefill_len: int,
                       decode_tokens: int, target: str, seed: int,
                       log, device: torch.device) -> dict:
    """Fixed-batch prefill-all/decode-all (the pre-engine behaviour):
    ``batch`` synthetic requests of ``prefill_len`` positions (a VLM's
    patches included), prefilled at once; then every K/V of the cache
    grown by ``decode_tokens`` (``grow_kv``; a recurrent state decodes as
    it is) and ``decode_tokens - 1`` greedy whole-batch steps
    (``legacy_generate``).  Weights drawn from ``seed``
    (``init_params``), the request from ``SyntheticSource(vocab, seed)``;
    on ``device`` (the card: the RMSNorm kernel on every norm), which
    must be ``target``'s.  A target of several chips serves on its mesh,
    as the reference's path does: this runs in each rank's process of an
    initialized process group (and raises where the process holds no
    rank), the weights and the cache at rest under their specs, each
    rank prefilling and decoding its rows of the batch (split along
    ``model``: its heads, MLP columns or experts and vocabulary, its
    shard of the cache) and every rank holding the whole batch's logits
    and tokens.  Returns the reference's keys."""
    from repro_torch.core.appspec import AppSpec
    from repro_torch.core.build import BuildService
    from repro_torch.data.pipeline import SyntheticSource, to_device
    from repro_torch.models.transformer import model_for
    from repro_torch.runtime.elastic import reshard_state
    from repro_torch.training.steps import (build_decode_step,
                                            build_prefill_step, no_ranks)

    dev = device
    tgt = get_target(target)
    if device_for(tgt) != dev:
        raise ValueError(f"target {tgt.name} runs on {device_for(tgt)}, "
                         f"not {dev}")
    app = AppSpec(arch=arch, shape="prefill_32k",
                  shape_overrides={"seq_len": prefill_len,
                                   "global_batch": batch},
                  run=f"serve --decode {decode_tokens}")
    result = BuildService().build(app, tgt, lower=False)
    mesh = None if tgt.num_chips == 1 else result.mesh
    if mesh is not None and not mesh.live:
        raise no_ranks(mesh)
    cfg = app.model_config
    model = model_for(cfg, remat="none")
    if mesh is None:
        prefill, decode = build_prefill_step(model), build_decode_step(model)
    else:
        prefill = build_prefill_step(model, mesh, result.rules)
        decode = build_decode_step(model, mesh)
    params = init_params(model.param_table(),
                         torch.Generator(device=dev).manual_seed(seed), dev)
    if mesh is not None:
        params = reshard_state(params, model.param_table(), mesh)
    req = to_device(SyntheticSource(cfg.vocab_size, seed).batch(
        model.batch_table(app.shape_config), 0), dev)

    toks, t_prefill, t_decode = legacy_generate(prefill, decode, params,
                                                req, decode_tokens, dev)
    out = {
        "arch": arch, "batch": batch, "prefill_len": prefill_len,
        "decode_tokens": decode_tokens, "mode": "legacy-static",
        "prefill_s": t_prefill, "decode_s": t_decode,
        "decode_tok_per_s": batch * (decode_tokens - 1) / max(t_decode, 1e-9),
        "sample": toks[0][:8].tolist(),
    }
    log(f"[serve] prefill {prefill_len}x{batch} in {t_prefill:.3f}s; "
        f"decode {decode_tokens} tokens: "
        f"{out['decode_tok_per_s']:.1f} tok/s")
    return out


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    p.add_argument("--arch", default="deepseek-7b-smoke")
    p.add_argument("--device", default=None,
                   help="torch device to serve on (default: the card; "
                        "'cpu' runs the plain versions of the kernels)")
    p.add_argument("--target", default=None,
                   help="deployment target the tuner sizes for (default: "
                        "the device's own, nvidia:h100 or local:cpu)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch", type=int, default=4,
                   help="KV pool slots (engine) / batch size (legacy)")
    p.add_argument("--prefill", type=int, default=64)
    p.add_argument("--decode", type=int, default=16)
    p.add_argument("--mode", choices=("continuous", "static"),
                   default="continuous")
    p.add_argument("--requests", type=int, default=0,
                   help="number of requests (default: one per slot)")
    p.add_argument("--max-len", type=int, default=0,
                   help="per-slot KV capacity (default: prefill+decode)")
    p.add_argument("--kv-layout", default="contiguous",
                   help="KV memory layout: contiguous | paged; with "
                        "--replicas a comma-separated mix cycles over "
                        "replicas (e.g. paged,contiguous)")
    p.add_argument("--page-size", type=int, default=0,
                   help="tokens per KV page (paged; default: tuner's)")
    p.add_argument("--kv-kernel", choices=("auto", "gather", "cuda"),
                   default="auto",
                   help="paged decode attention: 'gather' reads K/V back "
                        "through the page table into a materialized "
                        "tensor, then attends; 'cuda' runs the hand-"
                        "written paged-decode kernel, which walks the "
                        "page table on the card; 'auto' follows the tuner "
                        "(plan.serve_kv_kernel: the CUDA target gets the "
                        "kernel).  Token streams are identical either "
                        "way; requires --kv-layout paged")
    p.add_argument("--replicas", type=int, default=1,
                   help="serve through a ReplicaRouter over N tuner-split "
                        "engines (1 = single engine)")
    p.add_argument("--route-policy",
                   choices=("round_robin", "least_loaded", "prefix_affinity"),
                   default="least_loaded",
                   help="replica routing policy (with --replicas > 1)")
    p.add_argument("--prefill-chunk", type=int, default=-1,
                   help="prompt tokens ingested per decode tick; -1 = the "
                        "tuner's plan.serve_prefill_chunk, 0 = blocking "
                        "full-prompt prefill")
    p.add_argument("--trace", choices=TRACES, default="uniform",
                   help="synthetic request mix: uniform, zipf, longprompt, "
                        "sharedprefix (the mix --prefix-cache hits on), "
                        "repetitive (the mix --spec-k pays off on)")
    p.add_argument("--spec-k", default="0",
                   help="speculative decoding: draft tokens per slot per "
                        "verify step (0 = off, 'auto' = the tuner's pick "
                        "from the trace's n-gram repetitiveness); streams "
                        "are identical to --spec-k 0")
    p.add_argument("--prefix-cache", action="store_true",
                   help="reuse shared-prefix KV across requests (paged "
                        "layout only); streams are identical with the "
                        "cache on or off")
    p.add_argument("--arrivals", choices=("closed", "poisson", "bursty"),
                   default="closed",
                   help="open-loop arrival process in virtual steps "
                        "('closed' submits everything at t=0)")
    p.add_argument("--arrival-gap", type=float, default=4.0,
                   help="mean inter-arrival gap in virtual steps")
    p.add_argument("--slo-ttft", type=int, default=0,
                   help="TTFT goodput deadline in virtual steps (0 = off, "
                        "-1 = the tuner's plan.serve_slo_ttft_steps)")
    p.add_argument("--slo-e2e", type=int, default=0,
                   help="end-to-end goodput deadline in virtual steps "
                        "(0 = off, -1 = the tuner's)")
    p.add_argument("--admission", choices=("queue", "reject"),
                   default="queue",
                   help="router admission (--replicas > 1): 'reject' "
                        "sheds a request whose predicted TTFT busts "
                        "--slo-ttft")
    p.add_argument("--autoscale", type=int, default=0,
                   help="fleet autoscaling (--replicas > 1): N = minimum "
                        "serving replicas; 0 = off")
    p.add_argument("--trace-out", default=None,
                   help="write a Chrome-trace/Perfetto JSON timeline of "
                        "the run to PATH (virtual-step timestamps; "
                        "identical runs give byte-identical files)")
    p.add_argument("--metrics-out", default=None,
                   help="write the flat to_metrics() snapshot as JSON to "
                        "PATH (NaN as null)")
    p.add_argument("--prom-out", default=None,
                   help="write the metrics snapshot in Prometheus text "
                        "exposition format to PATH")
    p.add_argument("--temperature", type=float, default=0.0,
                   help="sampling temperature (0 = greedy)")
    p.add_argument("--top-k", type=int, default=0,
                   help="top-k sampling filter (0 = off)")
    p.add_argument("--top-p", type=float, default=1.0,
                   help="nucleus sampling mass (1.0 = off)")
    a = p.parse_args(argv)
    spec_k = None if a.spec_k == "auto" else int(a.spec_k)
    return serve_main(
        arch=a.arch, batch=a.batch, prefill_len=a.prefill,
        decode_tokens=a.decode, target=a.target, seed=a.seed, mode=a.mode,
        requests=a.requests, max_len=a.max_len, kv_layout=a.kv_layout,
        page_size=a.page_size, temperature=a.temperature, top_k=a.top_k,
        top_p=a.top_p, replicas=a.replicas, route_policy=a.route_policy,
        prefill_chunk=None if a.prefill_chunk < 0 else a.prefill_chunk,
        prefix_cache=a.prefix_cache, kv_kernel=a.kv_kernel, spec_k=spec_k,
        trace=a.trace, arrivals=a.arrivals, arrival_gap=a.arrival_gap,
        slo_ttft=a.slo_ttft, slo_e2e=a.slo_e2e, admission=a.admission,
        autoscale=a.autoscale, trace_out=a.trace_out,
        metrics_out=a.metrics_out, prom_out=a.prom_out, device=a.device)


if __name__ == "__main__":
    main()
