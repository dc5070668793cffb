#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA Hopper GPU:

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. device and build — the card's name and power limit, the torch/CUDA
   versions, and an ``nvcc`` build of every kernel in
   ``src/repro_torch/kernels/csrc`` for sm_90a;
2. every kernel against its plain PyTorch version on the card: a sweep
   of the paged-decode attention kernel (G in {1, 4}, shuffled page
   tables, lengths 0 / 1 / page boundary / full, a poisoned junk page 0)
   and of the RMSNorm kernel, plus both at the full-width main-path
   shapes; then K1 held, element by element, within what two bf16
   roundings allow (``_rounding_diff``, ratio <= 1) and bitwise equal
   across two calls, at the main-path shape, 1 and 2 slots, lengths
   that fill whole splits, one token past them and inside the first
   page, one slot long enough that split 0 holds pages, one slot of 4,096
   tokens, four slots whose page-table rows share a 16-page run (two of
   them over the same pages with the same query, whose outputs must be
   equal bit for bit), G = 4, 8, 11 and 12 (``_k1_cases``;
   G = 12 is ``mistral-large-123b``'s 96 heads over 8 kv heads, three
   chunks of 4 heads a block, and G = 11 ends in a short chunk of 3), and
   the attention shapes of ``stablelm-1.6b`` (32 heads over 32 kv heads
   of 64, G = 1), ``nemotron-4-340b`` (96 over 8 of 192, G = 12),
   ``granite-moe-3b-a800m`` (24 over 8 of 64, G = 3) and ``dbrx-132b``
   (48 over 8 of 128, G = 6); then the fused residual add + RMSNorm
   (``add_rmsnorm_cuda``) at rows 1, 8, 40, 128 and 1000 by widths 64,
   1536, 4096, 6144, 7168, 12288 and 18432 (6,144 and 7,168 give each
   thread two 8-element vectors), and at ``llava-next-34b``'s decode and
   prefill rows, (4, 7168) and (4352, 7168), and ``zamba2-7b``'s, (4,
   3584) and (4096, 3584), both forms: the residual
   bitwise equal to the plain version's, the norm within one bf16 step of
   it, two calls bitwise equal (``_k2_hold``; at llava's and zamba's
   shapes the ``rmsnorm`` entry too, ``_k2_norm_hold``); then the MoE
   router's
   ``route_tokens`` on the card (``_route_checks``: rows of exact ties
   and saturated rows with denormal probabilities, bit for bit equal to
   the CPU's result and to ``lax.top_k``'s choice); then K2's gradient
   (``_k2_grad_hold``) at (8, 4096), (4096, 4096) and (4352, 7168) bf16,
   both entries
   and both forms of the fused one: the ``torch.autograd.Function``'s
   forward bit-equal to the direct kernel call, its dx/da/dw bitwise
   equal to the plain backward on the same inputs, and within one bf16
   step of each value plus 2^-8 of the largest of autograd through the
   plain version, the backward's time printed beside the forward's;
3. stream identity at smoke size: ``deepseek-7b-smoke`` served through
   ``ServeEngine`` on the serving benchmark's trace (continuous and
   static batching, blocking and chunked prefill) and on a scarce-page
   trace that preempts, with the paged kernel and with the gather path —
   identical greedy streams, and the benchmark's scheduling counts; then
   all 15 cells of ``BENCH_serving.json`` at smoke size, every
   deterministic key equal to the file's: the seven single-engine cells
   (``_engine_cells``; ``paged_spec_on`` on its weight-independent keys,
   since its acceptance counts depend on weights the card draws with
   torch, and with spec-on streams equal to spec-off), the seven router
   cells (``router_least_loaded_x3``, the long-prompt, shared-prefix and
   open-loop cells) through ``ReplicaRouter`` fleets, with the 3-replica
   streams equal to one engine's and shared-prefix streams equal with the
   prefix cache on and off, and ``telemetry_overhead``: the
   ``paged_continuous`` drain re-run with a ``Tracer`` (31 decode steps,
   6.2581 tokens per step, 32 spans, 0 ring events, mean TTFT 18.9167
   steps), its streams equal to the untraced run's; then the MoE family,
   ``granite-moe-3b-a800m-smoke`` and ``dbrx-132b-smoke``, on the trace
   of the reference's MoE serving tests (6 requests, 3 slots x 48):
   identical streams paged (page 8) on the kernel and on the gather
   path, contiguous, and chunked (chunk 4) against blocking; then
   training at smoke size through the BuildService's train step, as
   ``train_main`` builds it (``_train_smoke``): ``deepseek-7b-smoke``
   and ``granite-moe-3b-a800m-smoke``, 6 steps, ``adamw`` and
   ``adamw8bit``, 1 and 2 microbatches, ``ef_int8`` on and off, each
   under remat ``none``, ``dots`` and ``full`` with bitwise equal losses
   and states and K2 on every norm of every forward and recompute
   (counted); ``deepseek-7b-smoke``'s step-0 gradients per leaf
   (``_smoke_grads``): the kernel path against the plain path, and the
   card against the CPU's plain path, each within LOGITS_VS_CONTROL x
   its control, the control at most GRAD_CONTROL_MAX; through
   ``train_main``, a run failing at step 3 restarts from its
   checkpoint to the uninterrupted run's state bit for bit, a second run
   from the seed repeats the loss bits, and ``run_easey`` of a smoke
   training Appfile to ``nvidia:h100`` ends ``finished`` with K2 built;
   the same under remat none, dots and full (bitwise equal losses and
   states) for ``xlstm-1.3b-smoke`` (no K2: LayerNorm) and
   ``zamba2-7b-smoke`` (K2 counted on every norm: two a Mamba2 block, the
   shared block's two, ``ln_f``, and the Mamba2 blocks' again in a remat
   recompute), ``adamw`` with one microbatch; then the legacy
   fixed-batch path at smoke size (``_legacy_smoke``:
   ``llava-next-34b-smoke``, ``xlstm-1.3b-smoke`` and
   ``zamba2-7b-smoke``, 4 requests of 48 positions, 12 tokens):
   ``serve_main`` with K2 on every norm (counted), with the plain norm in
   its place, and ``run_command``, every row's greedy tokens equal;
4. the slice at full width: ``deepseek-7b`` (random weights from a seed)
   on one card, 8 greedy requests through the paged engine built with
   its defaults, with the kernels on every step, counted (the fused
   add + norm on every norm but layer 0's first); then the same run
   teacher-forced, each tick's logits held against the gather path's on
   the same pool and every fused add + norm call held as phase 2 holds
   it, and a free-running gather run whose streams are compared;
5. numbers (printed, nothing gated on them): kernel, plain-version and
   library-call times at the main-path shapes (device time per call from
   CUDA graphs: K1 and SDPA of flush + call pairs less the flushes alone,
   RMSNorm of back-to-back calls; K1 also at 1 slot x 4,096 tokens, at 2
   slots and at G = 12; both RMSNorm entries at 8, 40 and 128 rows beside
   an empty kernel's launch in the same harness (built here from
   ``EMPTY_KERNEL_CU``: a yardstick, no kernel of the port),
   ``F.rms_norm`` and the eager composition the fused entry replaces, and
   at ``llava-next-34b``'s (4, 7168) and (4352, 7168),
   and the host's time per call), the full-width decode tick, the chunked-prefill step (each with
   its device launches and busy time from the profiler) and end-to-end
   tokens/s;
6. the Sedov stencil kernel against its plain version on the card: grids
   1, 2, 3, 5 (fewer planes than the kernel's pipeline is deep), 8, 13,
   16, 24, 32, 33, 64, 70, 100 and 256 (chunk seams along axis 0 and
   tile seams along axes 1 and 2, on full and partial tiles), each on a
   developed blast state and on a rough state (every zone different, so
   that every seam sees varied data), one step, and ten at 16, 70 and
   256, every zone of every field held to rtol 1e-6 (the kernel rounds
   as the plain version does); ten kernel steps also against ten oracle
   steps;
7. the LULESH path at full size: ``run_easey`` deploys ``lulesh-dash``
   (``lulesh -i 1000 -s 256``) with the paper's Listing 1.5 job to
   ``nvidia:h100`` twice (the first run is warm-up); each run must end
   ``finished`` with exactly 1000 stencil launches, a batch file and a
   package that passes its integrity check, and a final state that
   passes the reference's blast-wave checks and equals 1000 plain fused
   steps zone by zone; one more kernel step on that state, where the
   wave has crossed many tiles on every axis, is held against the plain
   version;
8. LULESH numbers (printed, nothing gated on them): stencil, plain-step
   and CFL-reduction times at n = 256 against their bounds, the time per
   step of ``run``, the FOM of ``lulesh.run`` called directly and through
   ``run_easey`` (the same window: the state built before the clock
   starts), and how far the 1000-step kernel state is from 1000 oracle
   steps;
9. the flash-attention kernel against its plain version on the card: the
   shapes of tests/test_kernels_flash.py, a causal s != t case, a
   ragged case, the kernel bench's shape, and a bf16 twin of every f32
   shape (the tensor-core body, each element within one bf16 step),
   each with kv_len t, t/4 and 0, and kv_len 32 (garbage past it
   invisible bit for bit) and 0 (exact zeros); then the full-width
   shapes of ``deepseek-7b`` (32 heads) and of
   ``mistral-large-123b``'s attention (96 heads over 8 kv heads), both
   s = t = 4096 in bf16, causal, each element within one bf16 step of
   the plain version's value, and ``nemotron-4-340b``'s (96 heads over 8
   kv heads of 192), through the tensor-core body (its
   launches counted) — with the kernel's, the plain version's and
   ``scaled_dot_product_attention``'s device times from CUDA graphs
   beside the bound;
10. the kernel bench (``repro_torch.kernels.bench``, the flash kernel's
   own path), its rows printed and its launches counted;
11. serving beyond greedy paged decoding: at smoke size, speculative
   decoding on ``picolm-4-smoke`` (spec-on streams equal spec-off, the
   paged kernel on every spec-off tick), the contiguous layout on
   ``deepseek-7b-smoke`` (streams equal the paged layout's, the serving
   benchmark's contiguous step counts) and a sampled trace with and
   without preemption (equal streams); at full width, ``deepseek-7b``
   serving 8 sampled requests with ``spec_k=4`` (decode and verify
   ticks, accepted tokens per verify and tokens/s printed, not gated);
12. the router and the shared-prefix cache at full width: one
   ``deepseek-7b`` engine built for 3 replicas (random weights from the
   seed of phase 4, checked equal), ``ReplicaRouter([eng] * 3,
   policy="prefix_affinity")`` over 48 shared-prefix requests (4 heads of
   256 tokens: 16 pages, 2 chunks), once to warm up, then with the cache
   off and on: every request complete in both, identical greedy streams,
   hits, saved prefill tokens and fewer chunk steps with the cache, the
   paged kernel on every decode tick of every replica and the RMSNorm
   kernel on every norm (counted); the cached run carries a ``Tracer``
   and keeps its schedule (124 decode ticks, 108 chunk steps, 45 rounds),
   and its Chrome trace, serialized twice, must be byte-identical, with
   one process per replica that served, integer monotone timestamps and
   metrics keys exactly ``ROUTER_SCHEMA``'s (``_trace_checks``); then
   ``least_loaded`` x3 over phase 4's 8 requests, whose streams must
   equal phase 4's single engine's (pool bytes, tokens/s, TTFT, chunk
   steps and the phase's seconds printed);
13. the serving app through EASEY at full width: ``run_easey`` deploys a
   ``deepseek-7b`` serving Appfile (``RUN serve --kv-layout paged
   --batch 8 --max-len 512 --requests 8 --prefill 256 --decode 32
   --trace-out ... --metrics-out ... --prom-out ...``) to
   ``nvidia:h100``: the build compiles K1 and K2, the job ends
   ``finished``, K1 runs on every decode tick and K2 on every norm
   (counted), the three files are written, the trace has one ``queued``
   and one ``decode`` span per request and one ``prefill_chunk`` span
   per chunk step, and the streams equal the same ``serve_main`` call
   untraced; then ``serve_main`` serves ``stablelm-1.6b`` at full width
   (24 layers, 32 heads of 64, LayerNorm: no K2) the same way, K1
   counted on every tick, its streams equal to an engine's on the same
   trace, and that engine's run teacher-forced as phase 4's is
   (``_teacher_forced_run``: every K1 call within the two-rounding
   bound, logits against the gather path within LOGITS_VS_CONTROL x the
   one-step-noise control); tokens/s traced and untraced, in turns, and
   the peak memory printed, not gated;
14. the MoE family at full width through EASEY: ``run_easey`` deploys a
   ``granite-moe-3b-a800m`` serving Appfile (``RUN serve --kv-layout
   paged --batch 8 --max-len 512 --requests 8 --prefill 256 --decode
   16``: MOE_DECODE, cut from 32 for the script's time limit; 32 layers,
   40 experts top-8, d 1536, random weights from the seed) to
   ``nvidia:h100``: the build compiles K1 and K2, the job ends
   ``finished``, K1 runs on every decode tick and K2 on every norm
   (counted); an engine on the same trace repeats the job's streams,
   and its run teacher-forced as phase 4's is (``_teacher_forced_run``:
   every K1 call within the two-rounding bound, logits against the
   gather path within LOGITS_VS_CONTROL x the one-step-noise control),
   printing per tick the first layer whose routing parts from the gather
   path's; the assignments dropped past capacity per chunk step, the
   decode tick and the chunk step (CUDA events and the profiler),
   tokens/s and the memory printed, not gated;
15. training at full width (``_train_full``): ``deepseek-7b`` (30
   layers, d 4096, 6.91 B parameters, random weights from the seed),
   ``seq_len`` 1024 x batch 4 under the tuner's plan (``adamw8bit``, f32
   accumulation, ``dots`` remat, 1 microbatch): step 0's per-token
   losses and per-leaf gradients on the kernel path within
   LOGITS_VS_CONTROL x the control's distance from the plain path (the
   control: every norm of the rounded sum; the block weights drawn at
   their layers' fan-in, the control at most GRAD_CONTROL_MAX), K2 counted in the forward (61) and in the remat
   recompute (60), the kernel path's step 0 repeated bit for bit; the
   optimizer's update timed and one step profiled;
   the mean of the per-token loss differences (kernel and control, each
   from the plain path) within BIAS_SE_MAX standard errors of zero
   (``_hold_bias``);
   then TRAIN_FULL's steps of ``train_main`` with K2 on every norm (counted per
   step), every loss and grad norm finite, the loss curve printed beside
   the plain path's, ms per step, tokens/s and the peak memory printed,
   not gated; then the restart at full width (``_restart_full``): that
   run's state copied to host numpy arrays, RESTART_STEPS more steps
   taken unbroken, the device state freed, the host copy restored
   through ``runtime.elastic.reshard_state`` onto
   ``mesh_for_target("nvidia:h100")`` and the same steps taken on the
   same step-keyed batches: every leaf bit for bit the unbroken run's, K2
   counted on every norm of both runs (the copy and restore times and the
   peak memory printed);
16. the VLM family at full width through the legacy fixed-batch path
   (``_vlm_full``): with the memory the earlier phases left at most
   VLM_BASELINE_GB, ``run_easey`` deploys a ``llava-next-34b`` serving
   Appfile (``RUN serve --arch llava-next-34b --batch 4 --prefill 1088
   --decode 16``: 60 layers of 7,168, 34.39 B parameters, random
   weights from the seed, 576 patches + 512 text tokens a request) to
   ``nvidia:h100``: the build compiles K2 (and no paged-decode kernel),
   the job ends ``finished``, K2 runs on every norm of the prefill and of
   the 15 decode steps (16 + 1,920 launches, counted); a direct
   ``serve_main`` repeats the job's tokens; a free-running run with the
   plain norm in K2's place is printed beside them, with where each row
   parts (not gated); then the model step by step, teacher-forced on the
   kernel path's tokens: every norm call held as phase 2 holds it, and
   each forward's logits within LOGITS_VS_CONTROL x the control's
   distance from the plain-norm path's (the control: the plain norm with
   one bf16 step of noise at as many norm outputs as K2 changed, on
   copies of the same cache); the prefill and the decode step (CUDA
   events and the profiler: busy ms, launches, idle share), tokens/s,
   peak memory and the data-sheet bounds printed, not gated;
17. the xLSTM family at full width (``_ssm_full``): ``run_easey`` deploys
   ``RUN serve --arch xlstm-1.3b --batch 4 --prefill 1024 --decode 16``
   (48 blocks of 2,048, 1.85 B parameters, random weights from the seed)
   to ``nvidia:h100``: the build compiles no kernel (LayerNorm), the job
   ends ``finished`` with no kernel launched, a direct ``serve_main``
   repeats its tokens; ``mlstm_chunkwise`` against ``mlstm_recurrent``
   at full-width shapes (dk 512, dv 1,024, 1,024 positions, chunk 256,
   f32) within MLSTM_TOL; the prefill of 1,025 tokens against the
   prefill of 1,024 and one decode step within the reference's decode
   test's bound; SSM_TRAIN's steps (4 x 64 tokens) of ``train_main``,
   every loss and
   grad norm finite and a second run's step 0 bit for bit the first's;
   the decode step and the sLSTM time loop alone profiled, ms per
   training step, tokens/s and peak memory printed, not gated;
18. the Zamba2 hybrid at full width (``_hybrid_full``): ``run_easey``
   deploys ``RUN serve --arch zamba2-7b --batch 4 --prefill 1024
   --decode 16`` (81 Mamba2 layers of 3,584 and one shared attention +
   MLP block applied 13 times, 6.75 B parameters) to ``nvidia:h100``:
   the build compiles K2 alone, the job ends ``finished``, K2 runs on
   every norm of the prefill and the 15 decode steps (2,816 + 208
   launches, counted), a direct ``serve_main`` repeats its tokens; the
   model teacher-forced on the job's tokens as phase 16 does it (every
   norm call held, logits within LOGITS_VS_CONTROL x the control); one
   request of 8,192 tokens (twice the window) through prefill, the first
   and last windowed shared attentions within WINDOW_TOL of dense
   attention under the same band; the prefill, the decode step and the
   SSD chunkwise scan alone profiled, tokens/s and peak memory printed,
   not gated;
19. the enc-dec family at full width (``_whisper_full``): ``run_easey``
   deploys ``RUN serve --arch whisper-tiny --batch 32 --prefill 1024
   --decode 64`` (4 encoder and 4 decoder layers of 384, 439.1 M
   parameters, 402.7 M of them the learned position table; 1,024 frames
   and 1,024 prompt tokens a request) to ``nvidia:h100``: the build
   compiles no kernel (LayerNorm, the legacy path), the job ends
   ``finished`` with no kernel launched, a direct ``serve_main`` repeats
   its tokens; 8 rows' prefill of 1,024 and 16 teacher-forced decode
   steps against one prefill of 1,040 tokens over the same frames, within
   two bf16 steps of the largest logit, at zero attention biases and
   again with every bias drawn nonzero (the cross-attention the port
   keeps the same on every path), where the reference's cross-attention
   gap, rebuilt on the same data, must depart beyond that limit; the
   one-step-noise control printed beside them; the serving shape's prefill
   and one decode step through ``analysis.cost`` (dot FLOPs, least
   bytes) beside ``analysis.flops.model_flops``, with the roofline's
   three terms on the H100's data-sheet peaks, the measured time, the
   share of the bound and the idle share printed, not gated; 4 steps of
   ``train_main`` at 8 x 1,024, every loss and grad norm finite and a
   second run's step 0 bit for bit the first's;
20. LULESH over a one-rank NCCL mesh (``_lulesh_nccl``): a world-size-1
   NCCL process group and a (1, 1) ``("data", "model")`` DeviceMesh on
   the card; LULESH_NCCL's 20 plain steps at grid 256 through
   ``lulesh.step(state, cfg, mesh)`` equal to the plain step's bit for
   bit.  On one rank the mesh path has no neighbour, so no halo is
   exchanged on the card: what runs there is the blocks' bookkeeping,
   dt's MAX all-reduce through NCCL (over one rank) and the DTensor
   wrapping.  The stencil build's ``step_fn`` for ``nvidia:h100`` (on
   one chip the plain step) is held against K4's step on the same state
   within STENCIL_TOL_1; then the fused kernel's run on the mesh
   (``lulesh.run(..., mesh, use_kernel=True)``: the fields gathered
   whole, K4 stepping the global grid as the reference's kernel does
   whatever the mesh, the rank's block kept at rest), 20 steps at grid
   256 bit for bit the same run off the mesh, K4 counted once a step on
   both (the kernels line's ``mesh_launches``); the group is destroyed
   before the phase ends.
   The multi-rank path itself (8 ranks, the halo exchanges, the sharded
   train step) runs only on the CPU over gloo
   (``tests/test_torch_spmd.py``): NCCL puts one rank on one card.
21. serving over a one-rank NCCL mesh (``_serve_nccl``): the same
   world-size-1 group and (1, 1) DeviceMesh; full-width ``deepseek-7b``
   through the paged engine with phase 4's arguments, so phase 4's
   weights (their fingerprint checked), bound to the mesh (the engine's
   private ``_bind``, as its constructor binds a target's mesh: the
   weights and the paged pool at rest as DTensors, every step built on
   the mesh, ``training/steps.py``: the dense family's split steps, each
   rank computing its rows, its heads and vocabulary columns, the logits
   gathered), serves phase 4's 8 requests: the greedy streams, the
   ``ServeStats`` counts and the K1 and K2 launches equal phase 4's
   off-mesh run's; then the legacy path's ``zamba2-7b`` job
   (SERVE_NCCL_LEGACY, shorter than phase 18's) through
   ``legacy_generate``, off the mesh and with the prefill and decode
   steps built on it (the hybrid's split steps, checked by name): its
   tokens and K2 launches equal.  The wall times
   are printed; the group is destroyed before the phase ends.
   The 8-rank serving path itself runs on the CPU over gloo
   (``tests/test_torch_spmd_serve.py``).
22. the dry run against the card (``_dryrun_card``): ``launch.dryrun``
   traces ``deepseek-7b``'s prefill and decode cells cut to a batch the
   card holds (DRYRUN_CELLS) on ``nvidia:h100`` on the ``meta`` device;
   then the build's same steps run on the card: the dry run's argument
   bytes within DRYRUN_ARGS_RTOL of the inputs' ``memory_allocated``,
   its traced peak within DRYRUN_PEAK_RATIO of ``max_memory_allocated``
   above the inputs, its dot FLOPs equal to ``analysis.cost.measure``'s
   on the card (the legacy steps launch no K1, and K2 computes no
   product); the roofline bound, the measured time and the share are
   printed; then ``dryrun.main(["--arch", "deepseek-7b", "--mesh",
   "both"])`` on the cluster targets, every record ``ok``, its wall time
   printed.  That run needs no device: ``python -m
   repro_torch.launch.dryrun`` runs it in a process of its own, started
   before phase 1 (``_DryRun``) so that it overlaps the card's phases;
   phase 22 waits for it, reads its records and prints the phases it
   ran beside (their host-clock timings shared the host's cores with
   its one thread), and the script stops it on any exit;
23. the lint and the examples on the card: (a) the ``smem-budget``
   rule's figure of every kernel instantiation the launchers can pick
   (``flash_fwd_kernel`` and ``flash_fwd_tc`` at each padded head dim,
   K1's two kernels at each head chunk 1-8 and dh 128 and 256, K2 at
   both input types and vector counts, K4's four variants), reckoned
   from the sources with those values as bounds, held against the
   compiled kernel's ``sharedSizeBytes`` and the dynamic bytes its
   launcher asks for (each ``.cu``'s ``*_smem`` query, which launches
   nothing): the rule's figure is never below the card's, every pair is
   printed and the budget is the card's opt-in limit; then ``python -m
   repro_torch.analysis.lint src/repro_torch`` in a process of its own,
   which must exit 0; (b) the four example twins on the card
   (``_examples_card``): ``quickstart`` at its own size through
   ``run_easey`` (K2 in training), ``serve_batch`` at full width
   (``--arch deepseek-7b --kv-layout paged``, EXAMPLE_DECODE tokens: K1
   and K2), ``train_100m`` at its 100M width through a restart
   (EXAMPLE_TRAIN: it fails past the step-25 checkpoint and restores
   from it; its LayerNorms run no K2) and ``lulesh_easey``'s three grids with K4
   through ``plan.kernels``, each example's launches counted and gated
   and listed in the kernels line; the phase's seconds are printed;
24. training on a one-rank NCCL mesh (``_train_nccl``), the split train
   step (``sharding.split``) as a card runs it: (a) ``deepseek-7b`` at
   full width, TRAIN_NCCL_DENSE's depth, 2 steps under phase 15's plan
   through the mesh step beside the off-mesh step from the same state:
   every loss, every leaf and K2's launches bit for bit equal; (b)
   ``granite-moe-3b-a800m`` at full width (40 experts top-8) and
   TRAIN_NCCL_MOE's depth (16 of 32 layers) at its 4 x 512: step 0 under the mesh step's split on
   the kernel path held to phase 15's gates against the plain path and
   the control (``_hold_grads``, ``_hold_bias``; the block weights drawn
   at their layers' fan-in, an expert's at its own), K2 counted, then 2
   steps of the mesh step (losses finite, K2 per step as predicted);
   (c) the restart from disk at granite's size: the state saved through
   ``Checkpointer(mesh=)`` into ``.ckpt_smoke/`` (git-ignored, removed
   after), an injected failure, the archive restored onto the mesh into
   a fresh state, and one more step taken by the unbroken and the
   restored state: every leaf bit for bit equal; the save, restore and
   phase seconds are printed; (d) ``zamba2-7b`` at full width and depth
   (81 Mamba2 layers, 13 applications of the shared block) at
   TRAIN_NCCL_HYBRID's 4 x 256: step 0 under the mesh step's split held
   to phase 15's gates against the plain path and the control, its
   stacked matrices drawn at their layers' fan-in
   (``_fan_in_recurrent``), K2 counted against the prediction
   (``_k2_per_step_hybrid``); then 2 steps off the mesh and 2 through
   the split step on the mesh from the same state, one state on the
   card at a time: the losses, K2 per step and every leaf's bits
   (``_fingerprint``) equal; (e) ``whisper-tiny`` at full width
   (WHISPER_NCCL) through the split train step, 2 steps of 8 x 1,024
   off the mesh and on it from the same state (losses and every leaf's
   bits equal), then the legacy path's split prefill and decode steps,
   8 x 512 + 16 tokens, off and on (every row's tokens equal); no kernel
   launches on this LayerNorm model.
25. one rank of a (16, 16) mesh serving, split (``_serve_rank``): (i)
   rank 0 of ``nvidia:h100x256`` at ``decode_32k`` through the split
   decode step (``steps.described_serve_step``: its collectives send
   nothing) for real on the card, at full width and depth, its weight
   and cache shards drawn on the card from seed 0: ``deepseek-7b`` (8
   rows, 2 of 32 heads, an 8.05 GB cache shard) and ``nemotron-4-340b``
   (8 rows, 6 of 96 heads, its cache split along the sequence, the one
   kv head its heads read gathered a layer at a time), then (iii)
   ``xlstm-1.3b`` (its 4 heads whole, its ``mlp`` split) and
   ``zamba2-7b`` (7 of 112 SSM heads, 2 of 32 attention heads, the
   recurrent states' and the shared K/V's shards) and ``whisper-tiny``
   (its 6 heads whole, its self and cross K/V split along the sequence,
   each layer's cross K/V gathered): the logits finite
   and whole, the arguments within DRYRUN_ARGS_RTOL of the dry run's,
   the peak within DRYRUN_PEAK_RATIO of its GB a card, K2 counted (the
   hybrid's every norm), the step's time beside its one-card bound; (ii) K1 at each
   split arch's per-rank shape (``RANK_K1``: deepseek-7b's 2 kv heads,
   nemotron-4-340b's and mistral-large-123b's 6 heads and dbrx-132b's 3
   on one kv head of a pool that keeps all 8, read from its offset) and
   at the whole-head archs' (SERVE_WHOLE_HEADS: 24 and 56 heads do not
   divide 16), 8 rows up to 32,768 tokens, held as phase 2 holds it and
   timed beside its bound, the plain version and SDPA; then one
   attention layer of each through ``layers.attention`` under a rank's
   ``ServeSplit``, K1 launched once a call, within the kernel tolerance
   of the gather path; (iv) rank 0 of the same mesh through
   ``whisper-tiny``'s split train step at ``train_4k``
   (``steps.described_rank_step``, 16 rows of 4,096 frames and tokens,
   its state shards drawn on the card): the arguments within
   DRYRUN_ARGS_RTOL of the dry run's, the peak within DRYRUN_PEAK_RATIO
   of its GB a card, the loss finite; the phase's seconds printed.

The second-to-last line of output is the card's ``name, power.limit``;
before it a JSON line lists every kernel with its launches on its path's
full-size run, error, times and bound; the last line is the ok JSON.
Without a CUDA device, or outside a checkout of the repository, the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

REPO = Path(__file__).resolve().parent
# after the paths a caller put first: tools/kernel_mutants.py imports this
# module beside a mutated copy of the port, which must be the one imported
sys.path.append(str(REPO / "src"))
# H100 SXM data sheet: device memory rate and the dense bf16 tensor-core
# rate (the least time of the attention products), as the port's
# roofline holds them
from repro_torch.analysis.roofline import HBM_BW as HBM_BYTES_PER_S  # noqa: E402
from repro_torch.analysis.roofline import PEAK_FLOPS as BF16_TENSOR_FLOPS  # noqa: E402

# bf16 tolerance of a kernel against its plain version (the reference's
# own paged-kernel tolerance, tests/test_kernels_paged.py): both round
# once to bf16 after f32 math summed in another order
KERNEL_ATOL = KERNEL_RTOL = 2e-2
# every decode tick's logits of the live slots, kernel vs gather at full
# width on the same pool.  Each K1 call must stay within what two bf16
# roundings of its probabilities and output allow; 30 random-weight
# layers then carry such differences to several percent of the largest
# logit.  The control measures that: the gather path with one bf16 step
# of noise at as many attention outputs as the kernel changed.  The
# kernel's worst tick may exceed the control's worst by at most this
# factor.
LOGITS_VS_CONTROL = 2.0
# H100 SXM data sheet: the f32 rate outside the tensor cores (K1, K2 and
# K4 run on CUDA cores in f32)
F32_FLOPS = 67e12
# the flash kernel against its plain version (tests/test_kernels_flash.py)
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# At full width (s = t = 4096, unit-normal q/k/v) a causal row averages
# thousands of keys and its outputs are ~0.03, so 2e-2 is the size of a
# typical output and would pass a kernel that dropped a key tile.  There
# both versions compute in f32 (they differ by ~1e-6) and round once to
# bf16, so they differ by at most one bf16 step of the value, which is at
# most 2**-7 of it: the limit is atol + rtol * |plain| with these.
FLASH_FULL_ATOL, FLASH_FULL_RTOL = 1e-4, 2.0 ** -7
# (b, s, t, H, K, dh, causal, dtype): tests/test_kernels_flash.py's
# shapes, a causal s != t case (the kernel's top-left mask), a ragged one
# (s, t not multiples of any tile) and the shape the kernel bench gives
# the kernel (phase 10)
FLASH_CASES = [
    (1, 128, 128, 4, 4, 64, True, "float32"),
    (2, 256, 256, 4, 2, 64, True, "float32"),
    (1, 128, 128, 8, 1, 32, True, "float32"),
    (2, 128, 128, 4, 4, 64, False, "float32"),
    (1, 256, 256, 6, 2, 64, True, "bfloat16"),
    (1, 64, 64, 2, 2, 128, True, "bfloat16"),
    (2, 512, 512, 2, 2, 64, True, "float32"),
    (1, 128, 256, 4, 2, 64, True, "float32"),
    (1, 100, 77, 4, 2, 32, False, "float32"),
    (1, 512, 512, 4, 2, 64, True, "float32"),
    # head dims 16 (the smoke configs), 112 (zamba2-7b) and 192
    # (nemotron-4-340b): padded widths, 32-byte swizzle, 64-key tiles
    (1, 128, 128, 4, 2, 16, True, "float32"),
    (1, 200, 200, 4, 2, 112, True, "float32"),
    (1, 128, 256, 2, 1, 192, True, "float32"),
]
# bf16 twins of the f32 shapes, which run the tensor-core body; held to
# one bf16 step of each value (FLASH_FULL_ATOL, FLASH_FULL_RTOL), the
# same reasoning as at full width
FLASH_TWINS = [case[:7] + ("bfloat16",) for case in FLASH_CASES
               if case[7] == "float32"]
# full width, causal, bf16: deepseek-7b's attention and the GQA widths of
# mistral-large-123b (96 heads over 8 kv heads of 128) and nemotron-4-340b
# (96 over 8 of 192), s = t = 4096
FLASH_FULL = {"deepseek-7b": (1, 4096, 4096, 32, 32, 128),
              "mistral-large-123b": (1, 4096, 4096, 96, 8, 128),
              "nemotron-4-340b": (1, 4096, 4096, 96, 8, 192)}
# the fused residual add + RMSNorm's gate: decode (1, 8 rows), a verify
# burst (8 x 5), a prefill chunk, a long prefill; the smoke configs'
# width and granite-moe-3b-a800m's, deepseek-7b's, dbrx-132b's,
# llava-next-34b's (6,144 and 7,168: two 8-element vectors a thread),
# mistral-large's and nemotron-4's; and llava-next-34b's own rows, its
# decode batch and its prefill (4 x 1,088)
K2_ROWS = (1, 8, 40, 128, 1000)
K2_WIDTHS = (64, 1536, 4096, 6144, 7168, 12288, 18432)
K2_VLM_SHAPES = ((4, 7168), (4352, 7168))
# zamba2-7b's decode and prefill rows at its width (its gated norm's
# 7,168 is in K2_WIDTHS)
K2_ZAMBA_SHAPES = ((4, 3584), (4096, 3584))
SAMPLED = dict(temperature=0.7, top_k=16, top_p=0.9)
# the stencil kernel (f32, built with -fmad=false) against its plain
# version: each zone of every field within this rtol, with no absolute
# slack, after any number of steps (each operation rounds once in both,
# in the same order).  Against the oracle step, whose order differs:
# scale-relative error per field after one step and after ten
# (tests/test_kernels_stencil.py)
STENCIL_ELEM_RTOL = 1e-6
STENCIL_TOL_1, STENCIL_TOL_10 = 1e-5, 1e-4
STENCIL_FIELDS = ("rho", "e", "v", "t")
# the LULESH run: the paper's Listing 1.5 at a single-GPU grid
LULESH_ITERS, LULESH_GRID = 1000, 256
# K2's gradient (phase 2): the Function's against autograd through the
# plain version, each element within K2_GRAD_RTOL of its value plus
# K2_GRAD_ATOL of the largest: the Function rounds the norm's input
# cotangent to bf16 before it meets the stream's (the reference's VJP),
# autograd adds the two in f32 and rounds once
K2_GRAD_SHAPES = ((8, 4096), (4096, 4096), (4352, 7168))
K2_GRAD_RTOL, K2_GRAD_ATOL = 2.0 ** -7, 2.0 ** -8
# the training phases: smoke-size runs (phase 3) and the full-width
# deepseek-7b run (phase 15, the tuner's plan at seq 1024 x batch 4)
TRAIN_SMOKE_ARCHS = ("deepseek-7b-smoke", "granite-moe-3b-a800m-smoke")
TRAIN_SMOKE_STEPS = 6
TRAIN_GRAD_SMOKE = "deepseek-7b-smoke"
TRAIN_FULL = dict(arch="deepseek-7b", seq_len=1024, global_batch=4, steps=2)
# the step-0 gradient gates (phases 3 and 15) draw each stacked block
# weight at its layer's own fan-in (``_fan_in_draw``), and each holds the
# control's per-leaf reading (relative L2 from the plain path) at or
# under GRAD_CONTROL_MAX: then LOGITS_VS_CONTROL x the control stays
# under 1.0, the reading of a zero gradient (2.0 for one of flipped
# sign), so the gate fails either
GRAD_CONTROL_MAX = 0.25
# phase 15's restart: steps past train_main's, taken unbroken and again
# from the host copy restored through reshard_state
RESTART_STEPS = 1
# phase 20: LULESH's mesh step over a one-rank NCCL mesh, then the fused
# kernel's run on it (``lulesh.run(..., mesh, use_kernel=True)``)
LULESH_NCCL = dict(grid=256, steps=20, kernel_steps=20)
# phase 21: after phase 4's requests through the engine on a one-rank
# NCCL mesh, the legacy path's zamba2-7b job on it, shorter than phase 18's
SERVE_NCCL_LEGACY = dict(arch="zamba2-7b", batch=2, prefill_len=512,
                         decode_tokens=16)
# phase 24: training on a one-rank NCCL mesh: deepseek-7b at full width
# cut to 8 layers (two copies of its state side by side: the off-mesh
# step's and the mesh step's) at the tuner's plan for the full config,
# and full-width granite-moe-3b-a800m at its plan with 8-bit moments
TRAIN_NCCL_DENSE = dict(arch="deepseek-7b", layers=8, seq_len=1024,
                        global_batch=4, steps=2)
TRAIN_NCCL_MOE = dict(arch="granite-moe-3b-a800m", layers=16, seq_len=512,
                      global_batch=4, steps=2, optimizer="adamw8bit")
# phase 24 (d): full-width, full-depth zamba2-7b (81 Mamba2 layers, 13
# applications of the shared block) through the split train step, at the
# tuner's plan for 4 x 256 (8-bit moments, remat dots, one microbatch:
# at 4 x 512 it takes two, and their f32 accumulator would not fit
# beside the state)
TRAIN_NCCL_HYBRID = dict(arch="zamba2-7b", seq_len=256, global_batch=4,
                         steps=2)
# phase 24 (e): full-width whisper-tiny through the split train step (2
# steps at phase 19's 8 x 1,024) and the legacy path's split prefill and
# decode steps (8 x 512 frames and tokens, 16 tokens) on a one-rank NCCL
# mesh, each against the same work off the mesh
WHISPER_NCCL = dict(arch="whisper-tiny", seq_len=1024, global_batch=8,
                    steps=2, batch=8, prefill_len=512, decode_tokens=16)
CKPT_SMOKE = Path(__file__).resolve().parent / ".ckpt_smoke"
# phase 22: deepseek-7b's two serve cells cut to a batch one card holds
DRYRUN_CELLS = (("prefill_32k", {"global_batch": 1, "seq_len": 8192}),
                ("decode_32k", {"global_batch": 8, "seq_len": 4096}))
# the dry run's argument bytes against the inputs' memory_allocated: the
# same tensors, each allocation rounded up to 512 B
DRYRUN_ARGS_RTOL = 0.01
# its traced peak of the step's own allocations against the card's
# max_memory_allocated above the inputs: the same operations make the
# same tensors, except where a kernel runs on the card (K2 allocates its
# output alone; the trace's plain norm makes f32 temporaries of the
# rows) and for the allocator's rounding to 512 B blocks
DRYRUN_PEAK_RATIO = (0.8, 1.25)
# phase 15's bias gate: the mean of the per-token loss differences (kernel
# vs plain, control vs plain) within this many standard errors of zero.
# The relative L2 cannot see a small shift shared by every token; a mean
# over 4,096 tokens can.  Set from phase 15's first readings on
# deepseek-7b: the kernel's mean 1.5 standard errors from the plain
# path's, the control's 0.35 (mean differences 3.40e-4 and 7.9e-5)
BIAS_SE_MAX = 4.0
# phase 16: full-width llava-next-34b through the legacy fixed-batch
# path, 576 patches + 512 text tokens a request, 1 prefill + 15 decode
# steps (cut from 31, with phases 17-18's decodes and phase 24's granite
# depth, to keep the script inside its limit on a slow host); it holds
# ~70 GiB, so the memory left allocated by the phases before it must be
# at most VLM_BASELINE_GB
VLM_FULL = dict(arch="llava-next-34b", batch=4, prefill_len=1088,
                decode_tokens=16)
VLM_SMOKE = dict(arch="llava-next-34b-smoke", batch=4, prefill_len=48,
                 decode_tokens=12)
VLM_BASELINE_GB = 4.0
# slices F-2 and F-3: xLSTM and the Zamba2 hybrid through the legacy path
SSM_SMOKE = dict(arch="xlstm-1.3b-smoke", batch=4, prefill_len=48,
                 decode_tokens=12)
HYBRID_SMOKE = dict(arch="zamba2-7b-smoke", batch=4, prefill_len=48,
                    decode_tokens=12)
# the new families' smoke training: the default optimizer and one
# microbatch, under the three remat policies
TRAIN_SMOKE_NEW = ("xlstm-1.3b-smoke", "zamba2-7b-smoke")
SSM_FULL = dict(arch="xlstm-1.3b", batch=4, prefill_len=1024,
                decode_tokens=16)
# 4 x 64 tokens a step (cut from 4 x 128): the sLSTM time loop runs
# through autograd a launch at a time (34-44 s a step at 4 x 1,024 on an
# NVIDIA H100 80GB HBM3, 9.5-11 s at 4 x 256, ~10 s at 4 x 128 on a slow
# host)
SSM_TRAIN = dict(arch="xlstm-1.3b", seq_len=64, global_batch=4, steps=2)
HYBRID_FULL = dict(arch="zamba2-7b", batch=4, prefill_len=1024,
                   decode_tokens=16)
# one request twice the shared attention's window, through prefill
HYBRID_LONG = 8192
# the windowed shared attention against dense attention under the same
# band: each element within two bf16 steps of the largest entry (the two
# sum their probabilities over different spans, then round to bf16)
WINDOW_TOL = 2.0 ** -7
# mlstm_chunkwise against mlstm_recurrent at full-width shapes: the
# reference's own tolerance (tests/test_ssm_equivalence.py)
MLSTM_TOL = 2e-4
# slice F-4: full-width whisper-tiny through the legacy path, 32 requests
# (the batch of the prefill_32k shape) of 1,024 frames and 1,024 prompt
# tokens (the longest length below 2,048 that the reference's attention
# takes: past 1,024 queries it needs whole chunks of 1,024), 64 tokens
# each
WHISPER_FULL = dict(arch="whisper-tiny", batch=32, prefill_len=1024,
                    decode_tokens=64)
# decode against the longer prefill: 8 rows, 1,024 frames and prompt
# tokens, 16 teacher-forced steps; then again with every attention bias
# drawn nonzero at this std (as training leaves them)
WHISPER_FORCED = (8, 1024, 16)
WHISPER_BIAS_STD = 0.5
# the last decode step's logits may depart from the longer prefill's by
# two bf16 steps of the largest logit (the CPU tests' limit,
# tests/test_torch_encdec.py); at nonzero biases the reference's
# cross-attention gap must depart by more, or the limit could not tell
# it.  No control sets this limit: one bf16 step of noise at under 1% of
# the decoder's norm outputs at the decoded positions moves the random
# 4-layer decoder's logits by ~30% of the largest, more than the gap
WHISPER_FORCED_TOL = 2.0 ** -7
WHISPER_TRAIN = dict(arch="whisper-tiny", seq_len=1024, global_batch=8,
                     steps=4)
# f32 operations of one fused step per zone (sedov_stencil.cu, counted
# once per zone: EOS 2, div 8, q 4, pq 1, 1/rho 2, momentum 15, div 8,
# energy 5, mass 4)
STENCIL_FLOPS_PER_ZONE = 49
# the floor under any launch's device time: a kernel that does nothing,
# timed in the harness that times the RMSNorm kernel
EMPTY_KERNEL_CU = r'''
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
'''


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _empty_kernel_build(torch, _build):
    """Start ``nvcc`` on ``EMPTY_KERNEL_CU`` (beside the port's kernels,
    with their flags); returns a function that waits for the build and
    returns a launcher of the empty kernel on the current stream."""
    import ctypes
    import hashlib
    flags = _build.flags("empty")
    digest = hashlib.sha256((EMPTY_KERNEL_CU + " ".join(flags)).encode())
    lib_path = _build.BUILD_DIR / f"libempty-{digest.hexdigest()[:16]}.so"
    proc = None
    if not lib_path.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cu = lib_path.with_suffix(".cu")
        cu.write_text(EMPTY_KERNEL_CU)
        proc = subprocess.Popen(
            [_build.nvcc(), *flags, "-o", str(lib_path), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def launcher():
        if proc is not None and proc.wait() != 0:
            raise RuntimeError("nvcc failed for the empty kernel:\n" +
                               proc.stdout.read())
        lib = ctypes.CDLL(str(lib_path))
        lib.empty_launch.argtypes = [ctypes.c_void_p]
        lib.empty_launch.restype = ctypes.c_int

        def launch():
            rc = lib.empty_launch(torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"empty kernel launch failed: CUDA error "
                                   f"{rc}")
        return launch
    return launcher


def _timed(fn, *args, **kw):
    """(fn's result, host seconds it took) — advisory set-up timings."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, time.perf_counter() - t0


def _events_ms(torch, fn, n: int, flush=None) -> float:
    """Mean device ms of ``fn`` over ``n`` runs after warm-up.  With
    ``flush``, each run is timed alone after evicting the L2 cache."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if flush is None:
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n
    total = 0.0
    for _ in range(n):
        flush()
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / n


def _graph_ms(torch, fn, n: int) -> float:
    """Device ms per call of ``fn``: ``n`` calls captured in one CUDA graph
    and replayed, so the host's cost per call is not in the time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return _events_ms(torch, graph.replay, 10) / n


def _graph_pairs_ms(torch, fn, flush, n: int) -> float:
    """Device ms per call of ``fn`` run on a cold L2: ``n`` (flush, fn)
    pairs in one CUDA graph, less ``n`` flushes alone in another, so
    neither the host's launch delay nor the flush is in the time."""
    return _graph_ms(torch, lambda: (flush(), fn()), n) - \
        _graph_ms(torch, flush, n)


def _host_us(torch, fn, n: int = 2000) -> float:
    """Host microseconds per call of ``fn`` (the device drained before and
    after, so the launches are what is timed)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * dt / n


def _host_us_per_call(torch, layers, cfg) -> dict:
    """The host cost, under no_grad at a decode tick's shapes, of the
    model's one-path SiLU (its autograd Function) and embedding gather
    (indexing), each against the plain expression it replaced
    (``x * (1 / (1 + exp(-x)))``, ``index_select``), timed in turns
    (A, B, B, A): name -> (one path, replaced)."""
    x = torch.randn(8, 1, cfg.d_ff, device="cuda", dtype=torch.bfloat16)
    table = torch.randn(cfg.vocab_size, cfg.d_model, device="cuda",
                        dtype=torch.bfloat16)
    ids = torch.randint(0, cfg.vocab_size, (8,), device="cuda")
    pairs = {"silu": (lambda: layers.silu(x),
                      lambda: x * (1 / (1 + torch.exp(-x)))),
             "embed": (lambda: table[ids],
                       lambda: table.index_select(0, ids))}
    out = {}
    with torch.no_grad():
        for name, (a, b) in pairs.items():
            ta = _host_us(torch, a)
            tb = _host_us(torch, b) + _host_us(torch, b)
            ta += _host_us(torch, a)
            out[name] = (ta / 2, tb / 2)
    return out


def _profile_ticks(torch, card: str, what: str, tick, n: int) -> dict:
    """Where a step's time goes: host wall time of ``n`` steps against the
    device time the profiler attributes to kernels, the device operations
    launched per step (kernels, and copies and fills apart; the count is
    deterministic), the RMSNorm kernel's share of the busy time, and the
    kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    def ticks():
        for _ in range(n):
            tick()
        torch.cuda.synchronize()
    ticks()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall_s = _timed(ticks)
    # the kernels themselves (device-side events): host-side ops also
    # carry the device time of what they launched, which would count twice
    events = [e for e in prof.key_averages()
              if e.device_type != torch.autograd.DeviceType.CPU]

    def device_us(e):
        return e.self_device_time_total
    copies = sum(e.count for e in events
                 if e.key.startswith(("Memcpy", "Memset")))
    out = {"host_ms": wall_s * 1e3 / n,
           "kernels": (sum(e.count for e in events) - copies) / n,
           "copies": copies / n}
    busy_us = sum(device_us(e) for e in events)
    wall_us = wall_s * 1e6
    if busy_us <= 0:
        print(f"[profile] {card} {what}: host {out['host_ms']:.3f} ms, "
              f"{out['kernels']:g} kernels and {out['copies']:g} copies "
              f"launched; device time not measured (the profiler saw no "
              f"device time)")
        return out
    norm_us = sum(device_us(e) for e in events if "norm_kernel" in e.key)
    out.update(busy_ms=busy_us / n / 1e3, idle=1 - busy_us / wall_us,
               norm_ms=norm_us / n / 1e3)
    print(f"[profile] {card} {what}: host {out['host_ms']:.3f} ms, device "
          f"busy {out['busy_ms']:.3f} ms, idle share {out['idle']:.3f} "
          f"(profiler on); {out['kernels']:g} kernels and {out['copies']:g} "
          f"copies launched per step; RMSNorm kernel {out['norm_ms']:.4f} ms "
          f"({norm_us / busy_us:.4f} of busy)")
    for e in sorted(events, key=device_us, reverse=True)[:8]:
        print(f"[profile]   {device_us(e) / n / 1e3:8.3f} ms/step "
              f"{e.count // n:5d} calls/step  {e.key[:70]}")
    return out


def _paged_case(torch, rng, lens, page_size, max_pages, K, G, dh,
                num_pages=None, poison=1e4):
    """Pool, shuffled page table and lengths holding ``lens`` tokens per
    slot (0 = freed slot: zeroed row); junk page 0 filled with
    ``poison``."""
    slots = len(lens)
    held = [min(-(-n // page_size), max_pages) if n else 0 for n in lens]
    num_pages = num_pages or sum(held) + 1
    order = rng.permutation(range(1, num_pages))
    table = torch.zeros((slots, max_pages), dtype=torch.int32)
    i = 0
    for s, h in enumerate(held):
        table[s, :h] = torch.as_tensor(order[i:i + h], dtype=torch.int32)
        i += h
    dev = "cuda"
    q = torch.randn((slots, K * G, dh), device=dev).to(torch.bfloat16)
    kp = torch.randn((num_pages, page_size, K, dh), device=dev).to(torch.bfloat16)
    vp = torch.randn((num_pages, page_size, K, dh), device=dev).to(torch.bfloat16)
    kp[0] = poison
    vp[0] = poison
    return (q, kp, vp, table.to(dev),
            torch.as_tensor(lens, dtype=torch.int32, device=dev))


def _rounding_diff(torch, ref, args, got) -> dict:
    """How far the paged kernel's output ``got`` is from the plain
    version's on the same ``args``, against the most two bf16 roundings
    of every probability and of the output can make them differ:
    |got - want| <= 2^-7 (sum_t p_t |v_t| + |want|) elementwise (one bf16
    step is at most 2^-7 of the value it rounds).  Returns the largest
    ratio of the difference to that bound, the largest difference in bf16
    steps of the output, the largest absolute difference and the
    fraction of outputs that differ."""
    q, kp, vp, table, kv_len, *heads = args
    want = ref.paged_attention_ref(*args).float()
    # the same probabilities over |v|: sum_t p_t |v_t| per output column
    spread = ref.paged_attention_ref(q, kp, vp.abs(), table, kv_len,
                                     *heads).float()
    g = got.float()
    diff = (g - want).abs()
    bound = 2.0 ** -7 * (spread * (1 + 2.0 ** -7) + want.abs()) + 1e-6
    exp = torch.frexp(torch.maximum(g.abs(), want.abs())).exponent
    steps = diff / torch.ldexp(torch.ones_like(diff), exp - 8)
    return {"ratio": float((diff / bound).max()), "ulps": float(steps.max()),
            "abs": float(diff.max()),
            "frac": float((diff > 0).float().mean())}


def _shared_run_case(torch, rng, page_size, max_pages, K, G, dh,
                     head_pages=16):
    """Four slots whose page-table rows share one run of ``head_pages``
    pages, as the prefix cache leaves them: slots 0 and 1 name the same
    pages with the same length and query (so their outputs must be equal
    bit for bit), slot 2 extends the run with pages of its own, slot 3
    holds none of it; junk page 0 poisoned as in ``_paged_case``."""
    head = head_pages * page_size
    lens = [head + 40, head + 40, head + 90, 70]
    own = [-(-(n - head) // page_size) for n in lens[:3]] + \
        [-(-lens[3] // page_size)]
    num_pages = 1 + head_pages + own[0] + own[2] + own[3]
    order = [int(x) for x in rng.permutation(range(1, num_pages))]
    run, order = order[:head_pages], order[head_pages:]
    tail0, order = order[:own[0]], order[own[0]:]
    tail2, tail3 = order[:own[2]], order[own[2]:]
    table = torch.zeros((4, max_pages), dtype=torch.int32)
    for s, row in enumerate((run + tail0, run + tail0, run + tail2, tail3)):
        table[s, :len(row)] = torch.as_tensor(row, dtype=torch.int32)
    q, kp, vp, _, _ = _paged_case(torch, rng, [1], page_size, max_pages,
                                  K, G, dh, num_pages=num_pages)
    q = q.expand(4, -1, -1).clone()
    q[1:] = torch.randn_like(q[1:], dtype=torch.float32).to(q.dtype)
    q[1] = q[0]
    return (q, kp, vp, table.to("cuda"),
            torch.as_tensor(lens, dtype=torch.int32, device="cuda"))


def _rank_case(torch, rng, lens, page_size, max_pages, Kp, kv0, K, G, dh,
               num_pages=None):
    """``_paged_case`` of a pool of ``Kp`` kv heads of which a rank's K*G
    query heads read the K from ``kv0`` (a pool kept whole on every rank
    of a model axis the kv heads do not divide): (q, pages, table,
    lengths, kv0, K)."""
    q, kp, vp, table, kv_len = _paged_case(torch, rng, lens, page_size,
                                           max_pages, Kp, G, dh, num_pages)
    return (q[:, :K * G].contiguous(), kp, vp, table, kv_len, kv0, K)


def _case_heads(case) -> tuple[int, int]:
    """(the kv heads a K1 case reads, its query heads per kv head)."""
    H = case[0].shape[1]
    K = case[6] if len(case) > 5 else case[1].shape[2]
    return K, H // K


# K1 at one rank's heads of nvidia:h100x256's (16, 16) mesh at decode_32k:
# (name, pool kv heads, first read, kv heads read, query heads a kv head,
# dh).  deepseek-7b's 32 kv heads split 2 a rank; the other three keep
# their 8 kv heads whole on every rank (8 does not divide 16) and a rank's
# 6 (nemotron-4-340b, mistral-large-123b) or 3 (dbrx-132b) query heads read
# one of them in place, here the last rank's that reads kv head kv0
RANK_K1 = (("deepseek-7b", 2, 0, 2, 1, 128),
           ("nemotron-4-340b", 8, 5, 1, 6, 192),
           ("mistral-large-123b", 8, 3, 1, 6, 128),
           ("dbrx-132b", 8, 7, 1, 3, 128))


def _k1_cases(torch, rng, K, dh, page_size, sms, num_splits):
    """(name, case) pairs for K1's rounding and determinism gates at full
    width (K kv heads of dh): 1 and 2 slots; lengths that fill whole
    splits, one token past them and inside the first page (one slot,
    whose pair count gives ``num_splits`` splits); one slot over 32 pages
    long enough that split 0 holds pages (at 200 tokens it holds none);
    one slot of 4,096 tokens over 256 pages; four slots whose rows share
    a 16-page run (``_shared_run_case``: the prefix cache's page sharing);
    G = 4 and 8 on 8 slots; G = 12 on 8 slots at mistral-large-123b's
    widths (96 heads over 8 kv heads of 128), three chunks of 4 heads a
    block; G = 11 (88 heads over 8), whose last chunk holds 3; and on 8
    slots the attention shapes of ``stablelm-1.6b`` (32 heads over 32 kv
    heads of 64, G = 1) and of ``nemotron-4-340b`` (96 heads over 8 kv
    heads of 192, G = 12), ``granite-moe-3b-a800m`` (24 heads over 8 kv
    heads of 64, G = 3) and ``dbrx-132b`` (48 over 8 of 128, G = 6); and
    at one rank's heads on nvidia:h100x256 (``RANK_K1``: a pool of kv
    heads split along ``model``, or kept whole and read from an
    offset)."""
    one = num_splits(K, 64, sms)
    whole = 2 * one * page_size              # 2 pages per split
    # split i of a run of P live pages takes pages [i P / n, (i + 1) P / n)
    split0 = num_splits(K, 32, sms) * page_size + 24
    lens8 = [300, 5, 0, 17, 129, 64, 512, 200]
    return [
        ("1 slot", _paged_case(torch, rng, [200], page_size, 32, K, 1, dh)),
        ("1 slot, split 0 holds pages",
         _paged_case(torch, rng, [split0], page_size, 32, K, 1, dh)),
        ("shared page run", _shared_run_case(torch, rng, page_size, 32, K,
                                             1, dh)),
        ("2 slots", _paged_case(torch, rng, [130, 77], page_size, 32, K, 1,
                                dh)),
        (f"whole splits ({one} x 2 pages)",
         _paged_case(torch, rng, [whole], page_size, 64, K, 1, dh)),
        ("one past whole splits",
         _paged_case(torch, rng, [whole + 1], page_size, 64, K, 1, dh)),
        ("inside the first page",
         _paged_case(torch, rng, [5], page_size, 64, K, 1, dh)),
        ("1 slot x 4096", _paged_case(torch, rng, [4096], 16, 256, K, 1, dh)),
        ("G=4", _paged_case(torch, rng, lens8, page_size, 32, K // 4, 4, dh)),
        ("G=8", _paged_case(torch, rng, lens8, page_size, 32, K // 8, 8, dh)),
        ("G=12", _paged_case(torch, rng, lens8, page_size, 32, 8, 12, 128)),
        ("G=11", _paged_case(torch, rng, lens8, page_size, 32, 8, 11, 128)),
        ("stablelm-1.6b (G=1, dh 64)",
         _paged_case(torch, rng, lens8, page_size, 32, 32, 1, 64)),
        ("nemotron-4-340b (G=12, dh 192)",
         _paged_case(torch, rng, lens8, page_size, 32, 8, 12, 192)),
        ("granite-moe-3b-a800m (G=3, dh 64)",
         _paged_case(torch, rng, lens8, page_size, 32, 8, 3, 64)),
        ("dbrx-132b (G=6, dh 128)",
         _paged_case(torch, rng, lens8, page_size, 32, 8, 6, 128)),
    ] + [(f"{name} rank ({Kr * G} heads on kv {kv0}-{kv0 + Kr - 1} of "
          f"{Kp}, dh {d})", _rank_case(torch, rng, lens8, page_size, 32, Kp,
                                       kv0, Kr, G, d))
         for name, Kp, kv0, Kr, G, d in RANK_K1]


def _k1_hold(torch, ref, attend, name, case) -> dict:
    """K1 on ``case`` within the two-rounding bound of its plain version
    (ratio <= 1 for every element), the same bits on a second call, and
    exact zeros at freed slots; returns ``_rounding_diff``'s record."""
    got = attend(*case)
    d = _rounding_diff(torch, ref, case, got)
    if d["ratio"] > 1:
        raise AssertionError(f"paged_attention {name}: {d['ratio']:.4g} of "
                             f"the two-rounding bound ({d})")
    if not torch.equal(got, attend(*case)):
        raise AssertionError(f"paged_attention {name}: two calls differ")
    freed = (case[4] == 0).nonzero()[:, 0]
    if bool(got[freed].ne(0).any()):
        raise AssertionError(f"paged_attention {name}: freed slot not zero")
    return d


def _streams(stats) -> list:
    return [r.tokens for r in sorted(stats.results, key=lambda r: r.rid)]


def _route_checks(torch, moe) -> dict:
    """``route_tokens`` on the card against its CPU result on the same
    logits, ``slot``, ``keep`` and ``gates`` bit for bit, and against the
    choice ``lax.top_k`` makes: rows of exact ties (every expert equal:
    token t takes experts 0..k-1 in order, at position t of each) and
    saturated rows (one logit of 87.8 over the rest in -52..-3.7, whose
    other probabilities are denormal in an unflushed f32 softmax and
    flushed to zero: the hot expert first, then the others by index).
    Returns the number of denormal probabilities the unflushed softmax
    kept, on the CPU and on the card."""
    gen = torch.Generator().manual_seed(0)
    denormal = {"cpu": 0, "cuda": 0}
    cases = []
    for E, k in ((40, 8), (16, 4)):
        ties = torch.zeros((2, 6, E))
        want = (torch.arange(k) * 8)[None, :] + torch.arange(6)[:, None]
        cases.append((f"ties E={E} k={k}", ties, k, 8,
                      want.reshape(1, -1).expand(2, -1)))
        hot = torch.randint(0, E, (2, 64), generator=gen)
        sat = -(3.7 + 48.3 * torch.rand((2, 64, E), generator=gen))
        sat.scatter_(-1, hot[..., None], 87.8)
        rest = torch.arange(E).expand(2, 64, E)
        rest = rest[rest != hot[..., None]].reshape(2, 64, E - 1)
        order = torch.cat([hot[..., None], rest], -1)[..., :k]
        want = torch.zeros((2, 64 * k), dtype=torch.int64)
        for b in range(2):               # slots in token order per row
            taken = [0] * E
            for i, e in enumerate(order[b].reshape(-1).tolist()):
                want[b, i] = e * 64 + taken[e]
                taken[e] += 1
        cases.append((f"saturated E={E} k={k}", sat, k, 64, want))
        for dev in denormal:
            p = torch.softmax(sat.to(dev), -1)
            denormal[dev] += int(((p > 0) & (p < torch.finfo(p.dtype).tiny)
                                  ).sum())
    if denormal["cpu"] == 0:
        raise AssertionError("route_tokens: the saturated rows hold no "
                             "denormal probability")
    for name, logits, k, C, want_slot in cases:
        cpu = moe.route_tokens(logits, k, C)
        dev = moe.route_tokens(logits.cuda(), k, C)
        for what, a, b in zip(("slot", "gates", "keep"), cpu[:3], dev[:3]):
            if not torch.equal(a, b.cpu()):
                raise AssertionError(f"route_tokens {name}: {what} on the "
                                     f"card differs from the CPU's")
        if not (torch.equal(cpu[0], want_slot.to(torch.int32)) and
                bool(cpu[2].all())):
            raise AssertionError(f"route_tokens {name}: not lax.top_k's "
                                 f"choice")
    return denormal


class _RouteLog:
    """Stands in for ``moe.route_tokens`` inside a ``with`` block and
    keeps each call's logits shape, ``slot`` and ``keep``."""

    def __init__(self, moe):
        self.moe, self.route = moe, moe.route_tokens
        self.calls = []

    def __call__(self, logits, k, capacity, tp=None, **kw):
        out = self.route(logits, k, capacity, tp, **kw)
        self.calls.append((tuple(logits.shape), out[0], out[2]))
        return out

    def __enter__(self):
        self.moe.route_tokens = self
        return self

    def __exit__(self, *exc):
        self.moe.route_tokens = self.route

    def chunk_drops(self, layers: int) -> list:
        """Assignments dropped past capacity per chunk step (a (1, s > 1)
        call a layer), summed over its ``layers`` calls."""
        d = [int((~keep).sum()) for shape, _, keep in self.calls
             if shape[0] == 1 and shape[1] > 1]
        return [sum(d[i:i + layers]) for i in range(0, len(d), layers)]

    def decode_slots(self) -> list:
        """``slot`` of each single-token (decode) call, in call order."""
        return [slot for shape, slot, _ in self.calls if shape[1] == 1]


def _router_cells(serving, cont, paged) -> dict:
    """The router, long-prompt, shared-prefix and open-loop cells of
    ``BENCH_serving.json`` (``benchmarks/serving_throughput.py``'s
    ``run_smoke``), every key but the wall-clock ``tokens_per_s``, from
    fleets of ``cont`` (the tight target's 3 contiguous slots x 128) and
    ``paged`` (its paged twin on the paged kernel).  Also holds the
    3-replica fleet's streams to the single engine's, and the cached
    shared-prefix run's to the cold run's."""
    quiet = lambda *a, **k: None  # noqa: E731
    vocab = cont.cfg.vocab_size

    def num(x):
        return None if x != x else round(x, 4)

    def rounds(s):
        return max(max(r.decode_steps for r in s.replica_stats), 1)

    def fleet(e, n=3, policy="least_loaded"):
        return serving.ReplicaRouter([e] * n, policy=policy, log=quiet)

    def zipf():
        return serving.zipf_trace(12, vocab, max_prompt=48, max_new=32,
                                  alpha=1.3, seed=0)
    cells = {}
    s = fleet(cont).run(zipf(), prefill_chunk=0)
    single = cont.run(zipf(), prefill_chunk=0)
    if _streams(s) != _streams(single):
        raise AssertionError("router x3 streams differ from one engine's")
    cells["router_least_loaded_x3"] = {
        "tokens_per_step": round(s.generated_tokens / rounds(s), 4),
        "replicas": 3, "route_policy": "least_loaded",
        "generated_tokens": s.generated_tokens, "decode_steps": rounds(s),
        "peak_in_flight": s.peak_in_flight,
        "in_flight_vs_single": round(
            s.peak_in_flight / max(single.peak_active, 1), 2),
        "load_imbalance": num(s.imbalance), "reroutes": s.reroutes}
    for name, chunk in (("longprompt_router_blocking", 0),
                        ("longprompt_router_chunked", None)):
        s = fleet(cont).run(serving.longprompt_trace(
            12, vocab, max_prompt=128, max_new=8, seed=0),
            prefill_chunk=chunk)
        cells[name] = {
            "tokens_per_step": round(s.generated_tokens / rounds(s), 4),
            "mean_ttft_steps": round(s.mean_ttft_steps, 4),
            "prefill_chunk": 0 if chunk == 0 else cont.prefill_chunk,
            "prefill_chunks": s.prefill_chunks,
            "prefill_compiles": max(r.prefill_buckets
                                    for r in s.replica_stats),
            "prefill_queue_peak": max(r.prefill_queue_peak
                                      for r in s.replica_stats),
            "overlap_steps": s.overlap_steps,
            "generated_tokens": s.generated_tokens,
            "decode_steps": rounds(s), "replicas": 3,
            "reroutes": s.reroutes}
    shared = {}
    for name, cached in (("sharedprefix_router_cold", False),
                         ("sharedprefix_router_cached", True)):
        s = fleet(paged, policy="prefix_affinity").run(
            serving.sharedprefix_trace(36, vocab, seed=0),
            prefix_cache=cached)
        shared[cached] = _streams(s)
        cells[name] = {
            "tokens_per_step": round(s.generated_tokens / rounds(s), 4),
            "mean_ttft_steps": num(s.mean_ttft_steps),
            "prefill_tokens": s.prefill_tokens,
            "prefill_tokens_saved": s.prefill_tokens_saved,
            "prefix_hits": s.prefix_hits, "prefix_misses": s.prefix_misses,
            "prefix_hit_rate": num(s.prefix_hit_rate),
            "generated_tokens": s.generated_tokens,
            "decode_steps": rounds(s), "replicas": 3,
            "route_policy": "prefix_affinity",
            "load_imbalance": num(s.imbalance)}
    if shared[True] != shared[False]:
        raise AssertionError("smoke shared-prefix streams differ with the "
                             "prefix cache on and off")
    for name, n, auto in (("openloop_poisson_fixed", 1, None),
                          ("openloop_poisson_autoscale", 3,
                           serving.AutoscalePolicy(min_replicas=1,
                                                   max_replicas=3))):
        s = fleet(cont, n).run(
            serving.with_arrivals(zipf(), "poisson", mean_gap=6.0, seed=3),
            prefill_chunk=0, slo_ttft_steps=20, slo_e2e_steps=120,
            autoscale=auto)
        m = s.to_metrics()
        cells[name] = {
            "arrivals": "poisson", "arrival_gap": 6.0, "arrival_seed": 3,
            "slo_ttft_steps": 20, "slo_e2e_steps": 120,
            "p50_ttft_steps": num(s.p50_ttft_steps),
            "p99_ttft_steps": num(s.p99_ttft_steps),
            "p50_e2e_steps": num(s.p50_e2e_steps),
            "p99_e2e_steps": num(s.p99_e2e_steps),
            "goodput_tokens": s.goodput_tokens,
            "generated_tokens": s.generated_tokens,
            "total_vsteps": s.total_vsteps,
            "peak_replicas": m["router_peak_replicas"],
            "autoscale_grows": m["router_autoscale_grows"],
            "autoscale_drains": m["router_autoscale_drains"],
            "replicas": n}
    return cells


def _engine_cells(serving, kv_bytes, tight_kw, trace) -> dict:
    """The single-engine cells of ``BENCH_serving.json`` (``run_smoke``'s
    first seven) on the card: the contiguous and paged layouts under the
    tight target, static and continuous, blocking prefill; the paged
    continuous drain through the paged kernel (the reference's Pallas
    kernel, named ``"cuda"`` here); and ``picolm-4-smoke``'s repetitive
    trace with spec off and with ``spec_k=4``, whose streams must be
    equal.  ``paged_spec_on``'s acceptance counts depend on the weights,
    which the card draws with torch where the file's come from JAX: its
    weight-independent keys only (the rest is the CPU tests' work, on
    crossed weights)."""
    quiet = lambda *a, **k: None  # noqa: E731

    def pool_bytes(e):
        tok = kv_bytes(e.cfg)
        if e.kv_layout == "paged":
            return e.num_pages * e.page_size * tok
        return e.num_slots * e.max_len * tok

    def cell(e, s):
        return {"tokens_per_step": round(s.generated_tokens / s.decode_steps,
                                         4),
                "hbm_bytes_per_admitted_token": round(
                    pool_bytes(e) / max(s.peak_resident_tokens, 1), 1),
                "pool_bytes": pool_bytes(e), "slots": e.num_slots,
                "decode_steps": s.decode_steps,
                "generated_tokens": s.generated_tokens,
                "occupancy": round(s.occupancy, 4),
                "peak_active": s.peak_active, "preemptions": s.preemptions,
                "mean_ttft_steps": round(s.mean_ttft_steps, 4)}
    cells = {}
    for layout, kv in (("contiguous", "auto"), ("paged", "gather")):
        e = serving.ServeEngine(arch="deepseek-7b-smoke", kv_layout=layout,
                                kv_kernel=kv, **tight_kw)
        for policy in ("static", "continuous"):
            cells[f"{layout}_{policy}"] = cell(
                e, e.run(trace, policy=policy, prefill_chunk=0))
    e = serving.ServeEngine(arch="deepseek-7b-smoke", kv_kernel="cuda",
                            **tight_kw)
    s = e.run(trace, policy="continuous", prefill_chunk=0)
    cells["paged_continuous_kernel"] = dict(cell(e, s), kv_kernel="cuda")
    pico = serving.ServeEngine(arch="picolm-4-smoke", target="local:cpu",
                               num_slots=4, max_len=128, seed=0,
                               kv_layout="paged", kv_kernel="cuda", log=quiet)
    rtrace = serving.repetitive_trace(12, pico.cfg.vocab_size, max_new=48,
                                      seed=0)
    spec = {k: pico.run(rtrace, spec_k=k, prefill_chunk=0) for k in (0, 4)}
    if _streams(spec[0]) != _streams(spec[4]):
        raise AssertionError("picolm-4-smoke: spec-on streams differ from "
                             "spec-off")
    for name, k in (("paged_spec_off", 0), ("paged_spec_on", 4)):
        s = spec[k]
        cells[name] = {
            "tokens_per_step": round(s.generated_tokens / s.decode_steps, 4),
            "arch": "picolm-4-smoke", "spec_k": k,
            "decode_steps": s.decode_steps,
            "generated_tokens": s.generated_tokens,
            "spec_verify_steps": s.spec_verify_steps,
            "spec_drafted_tokens": s.spec_drafted_tokens,
            "spec_accepted_tokens": s.spec_accepted_tokens,
            "accepted_per_verify": round(s.accepted_per_verify, 4)}
    return cells


# the keys of paged_spec_on that do not depend on the drawn weights
SPEC_ON_KEYS = ("arch", "spec_k", "generated_tokens")


def _trace_checks(serving, tracer, stats, out_dir: Path) -> dict:
    """A traced router run's exports: the Chrome trace serialized twice,
    byte for byte the same; one process per replica that served; integer
    and monotone ``ts``; every span closed; the metrics snapshot's keys
    exactly ``ROUTER_SCHEMA``'s for the fleet's replicas."""
    a, b = out_dir / "trace_a.json", out_dir / "trace_b.json"
    trace = serving.write_chrome_trace(tracer, a)
    serving.write_chrome_trace(tracer, b)
    if a.read_bytes() != b.read_bytes():
        raise AssertionError("the Chrome trace serialized twice differs")
    evs = trace["traceEvents"]
    pids = {ev["pid"] for ev in evs
            if ev["ph"] == "M" and ev["name"] == "process_name"}
    served = set(stats.replica_of.values())
    if pids != served:
        raise AssertionError(f"trace processes {sorted(pids)} != replicas "
                             f"that served {sorted(served)}")
    if not all(isinstance(ev["ts"], int) for ev in evs if "ts" in ev):
        raise AssertionError("non-integer trace timestamps")
    ts = [ev["ts"] for ev in evs if ev["ph"] == "X"]
    if ts != sorted(ts):
        raise AssertionError("trace timestamps not monotone")
    if tracer._open:
        raise AssertionError(f"{len(tracer._open)} spans left open")
    keys = list(stats.to_metrics())
    schema = serving.ROUTER_SCHEMA
    want = [s.key for s in schema if "{i}" not in s.key] + [
        s.key.replace("{i}", str(i)) for i in range(len(stats.replica_stats))
        for s in schema if "{i}" in s.key]
    if keys != want:
        raise AssertionError(f"router metrics keys {keys} != the schema's "
                             f"{want}")
    return {"bytes": len(a.read_bytes()), "events": len(evs),
            "spans": len(tracer.spans), "ring": tracer.total_events,
            "phases": sorted({s.phase for s in tracer.spans}),
            "pids": sorted(pids)}


def _weights_sig(eng) -> tuple:
    """A fingerprint of an engine's weights: f64 sums of the embedding,
    layer 0's query projection and the final norm's scale."""
    p = eng.params
    return tuple(float(w.double().sum()) for w in (
        p["embed"]["embedding"], p["blocks"]["attn"]["wq"][0],
        p["ln_f"]["scale"]))


def _k2_hold(torch, ref, fused, name, x, a, w, rounded, repeat=True) -> dict:
    """The fused residual add + RMSNorm ``fused`` on (x, a, w) against its
    plain version: the residual bitwise equal, the norm within one bf16
    step of the plain value (FLASH_FULL_ATOL + FLASH_FULL_RTOL * |plain|:
    both compute in f32, only the order of the sum of squares differs,
    and each rounds once), and with ``repeat`` a second call bitwise
    equal.  Returns the norm's max abs error and its largest share of the
    limit."""
    r, y = fused(x, a, w, norm_of_rounded=rounded)
    r_want, y_want = ref.add_rmsnorm_ref(x, a, w, norm_of_rounded=rounded)
    if not torch.equal(r.view(torch.int16), r_want.view(torch.int16)):
        raise AssertionError(f"add_rmsnorm {name}: residual differs from "
                             f"the plain version's")
    err = (y.float() - y_want.float()).abs()
    share = float((err / (FLASH_FULL_ATOL + FLASH_FULL_RTOL *
                          y_want.float().abs())).max())
    if share > 1:
        raise AssertionError(f"add_rmsnorm {name}: norm {share:.4g} of one "
                             f"bf16 step from the plain version's")
    if repeat:
        r2, y2 = fused(x, a, w, norm_of_rounded=rounded)
        if not (torch.equal(r2, r) and torch.equal(y2, y)):
            raise AssertionError(f"add_rmsnorm {name}: two calls differ")
    return {"abs": float(err.max()), "share": share,
            "frac": float((y != y_want).float().mean())}


def _k2_norm_hold(torch, ref, norm, name, x, w) -> dict:
    """The RMSNorm entry ``norm`` on (x, w) against its plain version: each
    element within one bf16 step of the plain value (as ``_k2_hold``
    holds the fused entry's norm), a second call bitwise equal."""
    y, want = norm(x, w), ref.rmsnorm_ref(x, w)
    err = (y.float() - want.float()).abs()
    share = float((err / (FLASH_FULL_ATOL + FLASH_FULL_RTOL *
                          want.float().abs())).max())
    if share > 1:
        raise AssertionError(f"rmsnorm {name}: {share:.4g} of one bf16 step "
                             f"from the plain version's")
    if not torch.equal(norm(x, w), y):
        raise AssertionError(f"rmsnorm {name}: two calls differ")
    return {"abs": float(err.max()), "share": share,
            "frac": float((y != want).float().mean())}


def _k1_numbers(torch, ref, attend, card, what, case, flush) -> dict:
    """K1 on ``case``: kernel and SDPA over pre-gathered KV (CUDA graphs of
    L2 flush + call pairs less the flushes), the kernel's calls back to
    back from the host (CUDA events), the plain version (the gather
    path, CUDA events after a flush), and the bound: the bytes of
    q, out, the table, the lengths and each held K/V row once over the
    memory rate, or 4 H dh operations per token over the f32 rate."""
    q, kp, vp, table, kv_len, *heads = case
    slots, H, dh = q.shape
    Kh, _ = _case_heads(case)
    kv0 = heads[0] if heads else 0
    toks = int(kv_len.sum())
    byts = 2 * q.numel() * 2 + table.numel() * 4 + kv_len.numel() * 4 + \
        2 * toks * Kh * dh * 2
    flops = 4 * H * dh * toks
    bound = max(byts / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
    ms = _graph_pairs_ms(torch, lambda: attend(*case), flush, 50)
    # calls back to back from the host, L2 warm: the host's cost per call
    # (two launches and the wrapper) where it exceeds the device's
    host = _events_ms(torch, lambda: attend(*case), 200)
    plain = _events_ms(torch, lambda: ref.paged_attention_ref(*case), 20,
                       flush)
    T = table.shape[1] * kp.shape[1]
    kg = kp[table.long()][..., kv0:kv0 + Kh, :].reshape(
        slots, T, Kh, dh).transpose(1, 2)
    vg = vp[table.long()][..., kv0:kv0 + Kh, :].reshape(
        slots, T, Kh, dh).transpose(1, 2)
    mask = (torch.arange(T, device="cuda")[None] <
            kv_len[:, None])[:, None, None]
    lib = _graph_pairs_ms(
        torch, lambda: torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], kg, vg, attn_mask=mask, enable_gqa=H != Kh),
        flush, 50)
    print(f"[numbers] {card} paged_attention {what}: {slots} slots x {H} "
          f"heads x {dh}, {toks} held tokens, L2 flushed: kernel {ms:.4f} ms"
          f" and SDPA over pre-gathered KV {lib:.4f} ms (device, CUDA graph "
          f"of flush + call pairs less the flushes), plain (the gather "
          f"path, CUDA events) {plain:.4f} ms, bound {bound:.4f} ms "
          f"({byts / 1e6:.2f} MB); kernel at {bound / ms:.4f} of the bound, "
          f"{ms / lib:.4f}x SDPA; kernel called back to back from the host "
          f"{host:.4f} ms per call")
    return {"ms": ms, "plain": plain, "lib": lib, "bound": bound,
            "bound_by": "bytes" if byts / HBM_BYTES_PER_S >=
            flops / F32_FLOPS else "operations"}


def _teacher_forced_run(torch, ref, ops, eng, reqs, gather_step,
                        noisy_step, noise, held_norm=None):
    """``eng.run(reqs)`` with every decode tick teacher-forced: each K1
    call held against the plain version on its own inputs, and each tick
    also run on copies of the same pool, tokens and page table (a)
    through the gather path and (b) through the gather path with one
    bf16 step of noise at as many attention outputs as the kernel changed
    (the control: how far the model carries rounding-sized differences).
    Logit differences cannot compound across ticks.  ``held_norm`` stands
    in for ``ops.add_rmsnorm`` during the run.  Returns (stats, one record
    per tick, one ``_rounding_diff`` record per K1 call)."""
    kernel_step = eng._decode
    attend = ops.paged_attention
    fused = ops.add_rmsnorm
    tf, calls = [], []

    def held(*args):
        got = attend(*args)
        calls.append(_rounding_diff(torch, ref, args, got))
        return got

    def teacher_forced(params, cache, tokens, active, pages):
        copies = [{n: t.clone() if torch.is_tensor(t) else t
                   for n, t in cache.items()} for _ in range(2)]
        n0 = len(calls)
        ops.paged_attention = held
        try:
            out = kernel_step(params, cache, tokens, active, pages)
        finally:
            ops.paged_attention = attend
        frac = sum(c["frac"] for c in calls[n0:]) / (len(calls) - n0)
        want = gather_step(params, copies[0], tokens, active, pages)[0]
        ops.paged_attention = lambda *a: _one_step_noise(
            torch, ref.paged_attention_ref(*a), frac, noise)
        try:
            ctrl = noisy_step(params, copies[1], tokens, active, pages)[0]
        finally:
            ops.paged_attention = attend
        # live rows only: a dead row's logits are discarded
        live = active.bool()
        got, want, ctrl = (t[live].float() for t in (out[0], want, ctrl))
        flips = got.argmax(-1) != want.argmax(-1)
        # how far the gather path's own pick stands above the kernel's
        # pick where the two differ: a near tie if within the diff
        gap = (want.amax(-1) - want.gather(
            -1, got.argmax(-1, keepdim=True))[..., 0])[flips]
        scale = float(want.abs().max())
        tf.append(dict(live=int(live.sum()), frac=frac,
                       rel=float((got - want).abs().max()) / scale,
                       ctrl=float((ctrl - want).abs().max()) / scale,
                       flips=int(flips.sum()),
                       gap=float(gap.max()) if gap.numel() else 0.0,
                       finite=bool(torch.isfinite(got).all())))
        return out
    eng._decode = teacher_forced
    if held_norm is not None:
        ops.add_rmsnorm = held_norm
    try:
        stats = eng.run(reqs)
    finally:
        ops.add_rmsnorm = fused
        eng._decode = kernel_step
    return stats, tf, calls


def _teacher_forced_gates(what, tf, calls, n_reqs) -> None:
    """Phase 4's gates on a teacher-forced run: finite logits, a tick with
    every slot live, every K1 call within the two-rounding bound, and the
    worst tick's logits within LOGITS_VS_CONTROL x the control's worst."""
    if not all(t["finite"] for t in tf):
        raise AssertionError(f"{what}: non-finite logits")
    if not any(t["live"] == n_reqs for t in tf):
        raise AssertionError(f"{what}: no tick had all {n_reqs} slots live")
    if max(c["ratio"] for c in calls) > 1:
        raise AssertionError(f"{what}: paged_attention differs from its "
                             f"plain version by more than two bf16 "
                             f"roundings allow")
    worst = max(tf, key=lambda t: t["rel"])
    ctrl = max(t["ctrl"] for t in tf)
    if worst["rel"] > LOGITS_VS_CONTROL * ctrl:
        raise AssertionError(f"{what}: teacher-forced logits differ by "
                             f"{worst['rel']:.4g} of max |logit| on a tick "
                             f"with {worst['live']} live rows > "
                             f"{LOGITS_VS_CONTROL} x the control's {ctrl:.4g}")


def _one_step_noise(torch, out, frac, gen):
    """bf16 ``out`` with one bf16 step up or down at a random ``frac`` of
    its nonzero elements."""
    pick = (torch.rand(out.shape, generator=gen, device=out.device) < frac) \
        & (out != 0)
    up = torch.rand(out.shape, generator=gen, device=out.device) < 0.5
    step = torch.where(up, 1, -1).to(torch.int16) * pick
    return (out.view(torch.int16) + step).view(torch.bfloat16)


def _check_close(name, got, want, atol, rtol) -> float:
    err = (got.float() - want.float()).abs()
    lim = atol + rtol * want.float().abs()
    over = err > lim
    if bool(over.any()):
        raise AssertionError(f"{name}: max abs err {err.max().item():.4g}; "
                             f"{int(over.sum())} of {err.numel()} elements "
                             f"over atol {atol} + rtol {rtol}")
    return float(err.max().item())


def _rel_err(got, want) -> dict:
    """Scale-relative error per field: max |got - want| / max |want|."""
    return {f: float((got[f] - want[f]).abs().max()
                     / (want[f].abs().max() + 1e-12)) for f in STENCIL_FIELDS}


def _hold_zones(name, got, want) -> float:
    """Every zone of every field of a stencil state within
    STENCIL_ELEM_RTOL of the plain version's; the max abs error."""
    return max(_check_close(f"{name}: {f}", got[f], want[f], 0.0,
                            STENCIL_ELEM_RTOL) for f in STENCIL_FIELDS)


def _fused_run(ref, st, iters):
    """``iters`` plain fused steps: the CFL reduction, then the plain
    version of the stencil kernel (what ``ops.sedov_step_kernel`` does
    with the kernel)."""
    for _ in range(iters):
        st = ref.sedov_step_ref(st, ref.cfl_dt(st))
    return st


def _rough_state(np, lulesh, n, seed, device):
    """A state with every zone different (rho, e and v drawn from a seed),
    so that each tile seam sees varied data: a wrong neighbour there gives
    wrong numbers, where on the early blast's uniform gas it would give
    the same ones."""
    rng = np.random.default_rng(seed)
    return lulesh.state_from_numpy({
        "rho": rng.uniform(0.5, 2.0, (n, n, n)).astype(np.float32),
        "e": rng.uniform(5e3, 2e4, (n, n, n)).astype(np.float32),
        "v": rng.normal(0.0, 10.0, (3, n, n, n)).astype(np.float32),
        "t": np.float32(0.0)}, device)


def _stencil_checks(np, lulesh, ref, step_fn, grids, ten_grids,
                    device="cuda"):
    """The stencil kernel ``step_fn(state, dt)`` against its plain version
    on developed blast states and rough states: one step at each of
    ``grids``, ten at each of ``ten_grids``.  Raises on a difference;
    returns (max abs error, max scale-relative error, ten-step
    scale-relative error against the oracle per grid)."""
    def developed(n, warm):
        """A state after ``warm`` plain steps, taken through numpy as the
        tests take the reference's."""
        cfg = lulesh.LuleshConfig(grid=n)
        st = lulesh.run(lulesh.init_state(cfg, device), cfg, warm)
        return lulesh.state_from_numpy(lulesh.state_to_numpy(st), device)

    def kernel_run(st, iters):
        for _ in range(iters):
            st = step_fn(st, ref.cfl_dt(st))
        return st

    err, rel, ten = 0.0, 0.0, {}
    for i, n in enumerate(grids):
        for kind, st in (("developed", developed(n, i % 5)),
                         ("rough", _rough_state(np, lulesh, n, n, device))):
            dt = ref.cfl_dt(st)
            got, want = step_fn(st, dt), ref.sedov_step_ref(st, dt)
            err = max(err, _hold_zones(f"sedov_stencil n={n} {kind}, one "
                                       f"step", got, want))
            e1 = _rel_err(got, want)
            if max(e1.values()) > STENCIL_TOL_1:
                raise AssertionError(f"sedov_stencil n={n} {kind}, one step:"
                                     f" scale-relative error {e1} > "
                                     f"{STENCIL_TOL_1}")
            rel = max(rel, *e1.values())
    for n in ten_grids:
        cfg = lulesh.LuleshConfig(grid=n)
        for kind, st in (("developed", developed(n, 0)),
                         ("rough", _rough_state(np, lulesh, n, n, device))):
            got = kernel_run(st, 10)
            err = max(err, _hold_zones(f"sedov_stencil n={n} {kind}, ten "
                                       f"steps", got, _fused_run(ref, st, 10)))
            if kind == "developed":
                ten[n] = _rel_err(got, lulesh.run(st, cfg, 10))
                if max(ten[n].values()) > STENCIL_TOL_10:
                    raise AssertionError(f"sedov_stencil n={n}, ten steps "
                                         f"vs the oracle step: {ten[n]} > "
                                         f"{STENCIL_TOL_10}")
    return err, rel, ten


def _flash_checks(torch, ref, flash_cuda) -> float:
    """The flash kernel against its plain version at FLASH_CASES (their
    dtype's FLASH_TOL) and FLASH_TWINS (one bf16 step), each also with
    kv_len = t / 4 and 0; at the (b, 128, 128) cases kv_len 32 with K/V
    past it set to 1e4 must give the same output bit for bit, and kv_len 0
    exact zeros.  Returns the max abs error."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    err = 0.0
    cases = [(c, FLASH_TOL[c[7]], FLASH_TOL[c[7]]) for c in FLASH_CASES] + \
        [(c, FLASH_FULL_ATOL, FLASH_FULL_RTOL) for c in FLASH_TWINS]
    for (b, s, t, H, K, dh, causal, dt), atol, rtol in cases:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                   for shape in ((b, s, H, dh), (b, t, K, dh), (b, t, K, dh)))
        for kv_len in (None, t // 4, 0):
            got = flash_cuda(q, k, v, causal=causal, kv_len=kv_len)
            want = ref.flash_attention_ref(q, k, v, causal=causal,
                                           kv_len=kv_len)
            err = max(err, _check_close(
                f"flash_attention {(b, s, t, H, K, dh, causal, dt)} "
                f"kv_len={kv_len}", got, want, atol, rtol))
            if kv_len == 0 and bool(got.ne(0).any()):
                raise AssertionError("flash_attention kv_len=0: not zeros")
        if s == t == 128:
            clean = flash_cuda(q, k, v, causal=causal, kv_len=32)
            k2, v2 = k.clone(), v.clone()
            k2[:, 32:], v2[:, 32:] = 1e4, 1e4
            if not torch.equal(clean, flash_cuda(q, k2, v2, causal=causal,
                                                 kv_len=32)):
                raise AssertionError("flash_attention reads keys past "
                                     "kv_len")
    return err


def _flash_full(torch, ref, flash_cuda, card, b, s, t, H, K, dh) -> dict:
    """The flash kernel at one full-width causal bf16 shape: held against
    its plain version, then the kernel, the plain version and
    ``scaled_dot_product_attention`` (q, k, v in its (b, heads, s, dh)
    layout, ``is_causal``, ``enable_gqa``) timed from CUDA graphs, and the
    bound: the larger of q/k/v/out bytes over the memory rate and the
    causal products' operations over the bf16 tensor-core rate."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               .to(torch.bfloat16)
               for shape in ((b, s, H, dh), (b, t, K, dh), (b, t, K, dh)))
    got = flash_cuda(q, k, v, causal=True)
    err = _check_close(f"flash_attention full width {(b, s, t, H, K, dh)}",
                       got, ref.flash_attention_ref(q, k, v, causal=True),
                       FLASH_FULL_ATOL, FLASH_FULL_RTOL)
    ms = _graph_ms(torch, lambda: flash_cuda(q, k, v, causal=True), 20)
    plain = _graph_ms(torch, lambda: ref.flash_attention_ref(
        q, k, v, causal=True), 2)
    torch.cuda.empty_cache()
    qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = _graph_ms(torch, lambda: sdpa(qs, ks, vs, is_causal=True,
                                        enable_gqa=True), 20)
    # key j <= query i < s (s == t here): s (s + 1) / 2 pairs per head,
    # 2 dh operations each for q.k and for p.v
    flops = 4 * b * H * dh * s * (s + 1) // 2
    byts = (2 * b * s * H * dh + 2 * b * t * K * dh) * 2
    bound = max(byts / HBM_BYTES_PER_S, flops / BF16_TENSOR_FLOPS) * 1e3
    # the kernel's own work: P.V twice (p = p_hi + p_lo), so 1.5x the
    # operations at the same rate
    split = 1.5 * flops / BF16_TENSOR_FLOPS * 1e3
    print(f"[numbers] {card} flash_attention b={b} s=t={s} H={H} K={K} "
          f"dh={dh} bf16 causal (device ms per call, CUDA graphs): kernel "
          f"{ms:.4f} ms, plain {plain:.4f} ms, SDPA {lib:.4f} ms; bound "
          f"{bound:.4f} ms ({flops:.4g} operations on the bf16 tensor "
          f"cores; {byts / 1e6:.1f} MB take {byts / HBM_BYTES_PER_S * 1e3:.4f}"
          f" ms), {split:.4f} ms for the split's 1.5x operations; max abs "
          f"err {err:.4g} (limit {FLASH_FULL_ATOL} + {FLASH_FULL_RTOL} * "
          f"|plain|); kernel at {bound / ms:.4f} of the bound, "
          f"{split / ms:.4f} of the split's figure, {ms / lib:.4f}x SDPA")
    del q, k, v, qs, ks, vs, got
    torch.cuda.empty_cache()
    return {"ms": ms, "plain": plain, "lib": lib, "bound": bound,
            "bound_by": "bytes" if byts / HBM_BYTES_PER_S >=
            flops / BF16_TENSOR_FLOPS else "operations", "err": err}


def _k2_grad_hold(torch, ref, ops, rmsnorm_cuda, add_rmsnorm_cuda, rows,
                  d, gen) -> dict:
    """K2's ``torch.autograd.Function`` (``ops.rmsnorm``, ``ops.add_rmsnorm``
    under grad) at (rows, d) bf16, each entry and both forms of the fused
    one: its forward bit-equal to the direct kernel call, its gradients
    (dx, da, dw) bitwise equal to the plain backward fed the same saved
    inputs and cotangents (the backward is that function), and within
    K2_GRAD_RTOL of each value plus K2_GRAD_ATOL of the largest of
    autograd through the plain version.  Returns the largest share of
    that tolerance and the forward's and backward's device ms."""
    def rnd(scale=1.0, shape=(rows, d)):
        return (scale * torch.randn(shape, device=gen.device, generator=gen)
                ).to(torch.bfloat16)
    x, a, gr, gy = rnd(3.0), rnd(), rnd(), rnd()
    w = (1 + 0.1 * torch.randn(d, device=gen.device, generator=gen)
         ).to(torch.bfloat16)
    share, times = 0.0, {}
    for form in ("rmsnorm", False, True):
        leaves = [t.clone().requires_grad_() for t in (x, a, w)]
        plain = [t.clone().requires_grad_() for t in (x, a, w)]
        if form == "rmsnorm":
            xs, _, ws = leaves
            y = ops.rmsnorm(xs, ws)
            direct = rmsnorm_cuda(x, w)
            outs, cots, want_direct = [y], [gy], [direct]
            ref.rmsnorm_ref(plain[0], plain[2]).backward(gy)
            want = ref.rmsnorm_bwd_ref(x, w, gy)
            got = (xs, ws)
            plain_g = (plain[0].grad, plain[2].grad)
            fwd = lambda: rmsnorm_cuda(x, w)  # noqa: E731
            bwd = lambda: ref.rmsnorm_bwd_ref(x, w, gy)  # noqa: E731
        else:
            xs, as_, ws = leaves
            outs = list(ops.add_rmsnorm(xs, as_, ws, norm_of_rounded=form))
            cots = [gr, gy]
            want_direct = list(add_rmsnorm_cuda(x, a, w,
                                                norm_of_rounded=form))
            torch.autograd.backward(list(ref.add_rmsnorm_ref(
                *plain, norm_of_rounded=form)), cots)
            d_, dw = ref.add_rmsnorm_bwd_ref(x, a, w, gr, gy,
                                             norm_of_rounded=form)
            want = (d_, d_, dw)
            got = (xs, as_, ws)
            plain_g = tuple(t.grad for t in plain)
            fwd = lambda: add_rmsnorm_cuda(  # noqa: E731
                x, a, w, norm_of_rounded=form)
            bwd = lambda: ref.add_rmsnorm_bwd_ref(  # noqa: E731
                x, a, w, gr, gy, norm_of_rounded=form)
        name = f"K2 Function ({rows}, {d}) {form}"
        if not all(torch.equal(o, dd) for o, dd in zip(outs, want_direct)):
            raise AssertionError(f"{name}: forward differs from the direct "
                                 f"kernel call")
        if type(outs[-1].grad_fn).__name__ not in ("_RMSNormBackward",
                                                   "_AddRMSNormBackward"):
            raise AssertionError(f"{name}: not through the Function")
        torch.autograd.backward(outs, cots)
        for t, wnt, pg in zip(got, want, plain_g):
            if not torch.equal(t.grad, wnt):
                raise AssertionError(f"{name}: gradient differs from the "
                                     f"plain backward on the same inputs")
            pf = pg.float()
            lim = K2_GRAD_RTOL * pf.abs() + K2_GRAD_ATOL * pf.abs().max()
            share = max(share, float(((t.grad.float() - pf).abs() /
                                      lim.clamp_min(1e-30)).max()))
        times[form] = (_graph_ms(torch, fwd, 20), _graph_ms(torch, bwd, 20))
    if share > 1:
        raise AssertionError(f"K2 Function ({rows}, {d}): gradients "
                             f"{share:.4g} of the tolerance from autograd "
                             f"through the plain version")
    return {"share": share, "ms": times}


class _PlainNorms:
    """Within the block, K2's forward on CUDA tensors is its plain version
    (``ref``), the Function and its backward unchanged: the plain path of
    the training gates.  ``rounded`` also makes every fused norm read the
    rounded sum (``layers.add_norm``): the control."""

    def __init__(self, ops, ref, layers, rounded=False):
        self.ops, self.ref, self.layers, self.rounded = ops, ref, layers, \
            rounded

    def __enter__(self):
        ops, ref, layers = self.ops, self.ref, self.layers
        self.saved = (ops.rmsnorm_cuda, ops.add_rmsnorm_cuda,
                      layers.add_norm)
        ops.rmsnorm_cuda = lambda x, w, *, eps=1e-6, out_dtype=None: \
            ref.rmsnorm_ref(x, w, eps=eps, out_dtype=out_dtype)
        ops.add_rmsnorm_cuda = lambda x, a, w, *, eps=1e-6, \
            norm_of_rounded: ref.add_rmsnorm_ref(
                x, a, w, eps=eps, norm_of_rounded=norm_of_rounded)
        if self.rounded:
            plain = layers.add_norm
            layers.add_norm = lambda p, x, a, kind, norm_of_rounded=True: \
                plain(p, x, a, kind, norm_of_rounded=True)
        return self

    def __exit__(self, *exc):
        (self.ops.rmsnorm_cuda, self.ops.add_rmsnorm_cuda,
         self.layers.add_norm) = self.saved
        return False


def _leaf_grads(torch, leaves) -> dict:
    """path -> list of gradients (one per layer of a stacked leaf)."""
    out = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            for k in sorted(tree):
                walk(tree[k], path + (k,))
        else:
            out.setdefault("/".join(path), []).append(tree.grad)
    for k, v in leaves.items():
        for layer in (v if isinstance(v, list) else [v]):
            walk(layer, (k,))
    return out


def _grad_errs(torch, got: dict, want: dict) -> dict:
    """Relative L2 distance of each leaf's gradient (over all its layers)."""
    errs = {}
    for path, ws in want.items():
        num = sum(float((g.float() - w.float()).square().sum())
                  for g, w in zip(got[path], ws))
        den = sum(float(w.float().square().sum()) for w in ws)
        errs[path] = (num / max(den, 1e-30)) ** 0.5
    return errs


def _same_state(torch, a, b, what: str, path="") -> None:
    """Two train states bitwise equal, leaf by leaf."""
    if isinstance(a, dict):
        if set(a) != set(b):
            raise AssertionError(f"{what}: state keys {sorted(a)} != "
                                 f"{sorted(b)} at {path or '/'}")
        for k in a:
            _same_state(torch, a[k], b[k], what, f"{path}/{k}")
    elif not torch.equal(a, b):
        raise AssertionError(f"{what}: {path} differs")


def _fan_in_draw(m, params) -> None:
    """Redraw, in place, every stacked block matrix at its own layer's
    fan-in.  The init law (the reference's) takes a stacked weight's
    fan-in from its layer axis: at 30 layers every block weight is drawn
    at 1/sqrt(30), attention saturates, and one bf16 step of the forward
    decorrelates the block gradients (relative L2 ~1.3 from the plain
    path for the kernel path and the control alike), so no gate could
    tell a right gradient from a wrong one.  The contracted axes are the
    embedding for wq, wk and wv, an expert's own input axis for the MoE
    experts' (layers, experts, in, out) weights, and all but the layer
    and output axes for the others."""
    for path, w in m.leaf_items(params["blocks"]):
        if w.dim() < 3:
            continue                    # the norms' per-layer scales
        if path[-1] in ("wq", "wk", "wv"):
            fan_in = w.shape[1]
        elif path[0] == "mlp" and w.dim() == 4:
            fan_in = w.shape[2]         # one expert's products
        else:
            fan_in = math.prod(w.shape[1:-1])
        w.mul_(math.sqrt(w.shape[0] / fan_in))


def _step0(torch, m, model, params, batch, plain=False, rounded=False,
           counted=None):
    """Step 0 on the kernel path: (the loss, each token's loss, the
    per-leaf gradients, launches); with ``plain`` K2's plain forward (the
    Function and its backward as they are), with ``rounded`` also every
    norm of the rounded sum (the control).  With ``counted`` (a function
    that reads and resets the launch counts) the launches are (the
    forward's, the backward's), else None."""
    leaves = model.train_leaves(params)
    with _PlainNorms(m.ops, m.ref, m.layers, rounded) if plain \
            else contextlib.nullcontext():
        if counted:
            counted()
        logits, _ = model.full_forward(leaves, batch)
        # the model's loss: the mean of the per-token losses below
        loss = m.layers.softmax_xent(logits, batch["labels"],
                                     batch.get("loss_mask"))
        with torch.no_grad():
            f = logits.float()
            per_token = torch.logsumexp(f, dim=-1) - f.gather(
                -1, batch["labels"][..., None].long())[..., 0]
        del logits, f
        fwd = counted() if counted else None
        loss.backward()
        launches = (fwd, counted()) if counted else None
    return float(loss.detach()), per_token, _leaf_grads(torch, leaves), \
        launches


def _bias_se(torch, got, want) -> dict:
    """The mean of the per-token differences ``got - want`` and its
    distance from zero in standard errors (the differences' standard
    deviation over the square root of their number; 0 when all are 0)."""
    diff = (got.double() - want.double()).flatten()
    se = float(diff.std()) / math.sqrt(diff.numel())
    mean = float(diff.mean())
    return {"mean": mean, "se": se, "z": mean / se if se > 0 else 0.0}


def _hold_bias(what: str, bias_k: dict, bias_c: dict) -> None:
    """Phase 15's bias gate: the kernel path's and the control's mean
    per-token loss difference from the plain path, each within
    BIAS_SE_MAX standard errors of zero (a shift shared by every token,
    which the relative L2 of ``_hold_grads`` cannot see)."""
    over = {name: b for name, b in (("kernel", bias_k), ("control", bias_c))
            if not abs(b["z"]) <= BIAS_SE_MAX}
    if over:
        raise AssertionError(f"{what} per-token losses: mean difference "
                             f"from the plain path beyond {BIAS_SE_MAX} "
                             f"standard errors: {over}")


def _rel_l2(torch, got, want) -> float:
    return float((got.float() - want.float()).norm() /
                 want.float().norm().clamp_min(1e-30))


def _hold_grads(what: str, tok_k, tok_c, err_k, err_c) -> None:
    """The step-0 gate: every reading finite; the kernel path's per-token
    losses (``tok_k``, and ``tok_c`` the control's: relative L2 from the
    plain path's)
    and each leaf's gradient within LOGITS_VS_CONTROL x the control's
    distance from the plain path, and each of the control's gradient
    readings at most GRAD_CONTROL_MAX.  Per-token losses, not their
    mean: the mean's difference is one draw of a sum of rounding noise,
    and one such draw exceeds twice another of the same size about 3
    times in 10 (2/pi x atan(1/2)); the relative L2 over every token
    does not swing so."""
    if not all(map(math.isfinite, (tok_k, tok_c, *err_k.values(),
                                   *err_c.values()))):
        raise AssertionError(f"{what}: a loss or gradient is not finite")
    if tok_k > LOGITS_VS_CONTROL * tok_c:
        raise AssertionError(f"{what} per-token losses: kernel {tok_k} "
                             f"from the plain path's, beyond "
                             f"{LOGITS_VS_CONTROL} x the control's {tok_c}")
    loose = {k: v for k, v in err_c.items() if v > GRAD_CONTROL_MAX}
    if loose:
        raise AssertionError(f"{what}: the control reads {loose}, over "
                             f"{GRAD_CONTROL_MAX}: the gate would not "
                             f"discriminate")
    over = {k: (err_k[k], err_c[k]) for k in err_k
            if err_k[k] > LOGITS_VS_CONTROL * err_c[k]}
    if over:
        raise AssertionError(f"{what} gradients beyond {LOGITS_VS_CONTROL}"
                             f" x the control's: {over}")


def _smoke_grads(torch, m, card) -> dict:
    """Phase 3's step-0 gradient gate at TRAIN_GRAD_SMOKE's width on the
    card, under ``dots`` (phase 15's policy), its block weights drawn at
    their layers' fan-in: the kernel path against the plain path with the
    control of ``_hold_grads``; then the card's kernel path against the
    CPU's plain path (remat ``none``) from the same weights and batch,
    which holds what is not K2 (the remat policy, the SiLU's and the
    embedding's backward, the per-layer leaves) within LOGITS_VS_CONTROL
    x the CPU's own control.  Returns the readings."""
    cfg = m.get_config(TRAIN_GRAD_SMOKE)
    shape = dataclasses.replace(m.SHAPES["train_4k"], seq_len=64,
                                global_batch=4)
    model = m.model_for(cfg, remat="dots")
    params = m.init_params(model.param_table(),
                           torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
    _fan_in_draw(m, params)
    batch = m.DataPipeline(model, shape, seed=0, device="cuda").batch_at(0)
    loss_k, tok_k, g_k, _ = _step0(torch, m, model, params, batch)
    loss_p, tok_p, g_p, _ = _step0(torch, m, model, params, batch,
                                   plain=True)
    loss_c, tok_c, g_c, _ = _step0(torch, m, model, params, batch,
                                   plain=True, rounded=True)
    err_k, err_c = _grad_errs(torch, g_k, g_p), _grad_errs(torch, g_c, g_p)
    tok = (_rel_l2(torch, tok_k, tok_p), _rel_l2(torch, tok_c, tok_p))
    _hold_grads(f"{TRAIN_GRAD_SMOKE} step 0 on the card", *tok, err_k,
                err_c)
    # the same step on the CPU's plain path, and its control
    cpu_model = m.model_for(cfg, remat="none")
    cpu_params = m.tree_map(lambda t: t.cpu(), params)
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    loss_h, tok_h, g_h, _ = _step0(torch, m, cpu_model, cpu_params,
                                   cpu_batch)
    loss_hc, tok_hc, g_hc, _ = _step0(torch, m, cpu_model, cpu_params,
                                      cpu_batch, plain=True, rounded=True)
    err_kh = _grad_errs(torch, {k: [g.cpu() for g in v]
                                for k, v in g_k.items()}, g_h)
    err_hc = _grad_errs(torch, g_hc, g_h)
    tok_h = (_rel_l2(torch, tok_k.cpu(), tok_h), _rel_l2(torch, tok_hc,
                                                         tok_h))
    _hold_grads(f"{TRAIN_GRAD_SMOKE} step 0, card vs CPU", *tok_h, err_kh,
                err_hc)
    r6 = lambda d: {k: round(v, 6) for k, v in d.items()}  # noqa: E731
    print(f"[smoke] {card} {TRAIN_GRAD_SMOKE} step 0 (4 x 64 tokens, remat "
          f"dots, block weights at their layers' fan-in): loss kernel "
          f"{loss_k:.6f}, plain {loss_p:.6f}, control {loss_c:.6f}, CPU "
          f"{loss_h:.6f}, CPU control {loss_hc:.6f}; per-token losses rel "
          f"L2, kernel vs plain {tok[0]:.4g}, control vs plain {tok[1]:.4g},"
          f" card kernel vs CPU plain {tok_h[0]:.4g}, CPU control vs CPU "
          f"{tok_h[1]:.4g}; per-leaf gradient rel L2, kernel vs plain "
          f"{r6(err_k)}, control vs plain {r6(err_c)}; card kernel vs CPU "
          f"plain {r6(err_kh)}, CPU control vs CPU {r6(err_hc)} (each <= "
          f"{LOGITS_VS_CONTROL} x its control, each gradient control <= "
          f"{GRAD_CONTROL_MAX})")
    return {"kernel": err_k, "control": err_c, "card_vs_cpu": err_kh,
            "cpu_control": err_hc}


def _smoke_run(torch, m, arch: str, over: dict):
    """TRAIN_SMOKE_STEPS steps of ``arch`` (4 x 64 tokens, weights and
    batches from seed 0) on the card, under the tuner's ``nvidia:h100``
    plan with the plan fields ``over``: built by the BuildService and
    stepped by its train step, as ``train_main`` builds and steps it.
    Returns (plan, per-step losses, final state)."""
    app = m.AppSpec(arch=arch, shape="train_4k",
                    shape_overrides={"seq_len": 64, "global_batch": 4},
                    run=f"train --steps {TRAIN_SMOKE_STEPS}")
    res = m.BuildService().build(app, "nvidia:h100", overrides=over,
                                 lower=False)
    plan = res.plan
    model = m.model_for(app.model_config, remat=plan.remat_policy)
    params = m.init_params(res.tables["params"],
                           torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
    state = m.init_train_state(model, m.make_optimizer(plan.optimizer),
                               params, plan)
    pipeline = m.DataPipeline(model, app.shape_config, seed=0,
                              device="cuda")
    losses = []
    for step in range(TRAIN_SMOKE_STEPS):
        state, metrics = res.step_fn(state, pipeline.batch_at(step))
        losses.append(float(metrics["loss"]))
    return plan, losses, state


def _train_norms(m, cfg, r: int) -> dict:
    """K2's launches a microbatch of a training step, by entry: the
    forward's (``_norms_per_forward``) and, under remat (``r``), those of
    the recomputed blocks: a dense or MoE model's all but ``ln_f``, a
    Zamba2 hybrid's Mamba2 blocks (the shared block is not rematted, as
    in the reference)."""
    fwd = _norms_per_forward(m, cfg)
    if cfg.norm != "rmsnorm":
        return fwd
    if cfg.family == "hybrid_mamba":
        return dict(fwd, rmsnorm=fwd["rmsnorm"] + r * 2 * cfg.num_layers)
    return {"rmsnorm": fwd["rmsnorm"] * (1 + r),
            "add_rmsnorm": fwd["add_rmsnorm"] + r * (fwd["add_rmsnorm"] - 1)}


def _train_smoke(torch, m, counts, reset_counts) -> dict:
    """Phase 3's training at smoke size: every (optimizer, microbatches,
    ef_int8) of TRAIN_SMOKE_ARCHS, and the default optimizer with one
    microbatch of TRAIN_SMOKE_NEW, each under remat none, dots and
    full, whose losses and final states must be bitwise equal, with K2 on
    every norm of every forward and of every recompute (``_train_norms``:
    per microbatch of a dense model, layer 0's first norm (``rmsnorm``)
    and 2 L fused add + norms (``add_rmsnorm``: the blocks' norms and
    ``ln_f``) in the forward, and all but ``ln_f`` again in a remat
    recompute; none on xLSTM, a LayerNorm model)."""
    per_step, final = {}, {}
    grid = [(a, o, mi, e) for a in TRAIN_SMOKE_ARCHS
            for o in ("adamw", "adamw8bit") for mi in (1, 2)
            for e in ("none", "ef_int8")] + \
        [(a, "adamw", 1, "none") for a in TRAIN_SMOKE_NEW]
    for arch, opt, micro, ef in grid:
        cfg = m.get_config(arch)
        runs = {}
        for remat in ("none", "dots", "full"):
            over = dict(optimizer=opt, microbatches=micro,
                        grad_compression=ef, remat_policy=remat)
            reset_counts()
            plan, losses, state = _smoke_run(torch, m, arch,
                                             over)
            got = counts()
            r = int(remat != "none")
            want = dict(got, **{
                k: v * micro * TRAIN_SMOKE_STEPS for k, v in
                _train_norms(m, cfg, r).items()})
            name = f"{arch} {over}"
            if got != want or got["paged_attention"]:
                raise AssertionError(f"{name}: launches {got} "
                                     f"!= {want}")
            if (plan.optimizer, plan.microbatches,
                    plan.grad_compression, plan.remat_policy) != \
                    (opt, micro, ef, remat) or \
                    not all(map(math.isfinite, losses)):
                raise AssertionError(f"{name}: plan {plan}, "
                                     f"losses {losses}")
            runs[remat] = (losses, state)
            per_step[(arch, micro, remat)] = {
                k: v // TRAIN_SMOKE_STEPS for k, v in got.items()
                if v}
        for remat in ("dots", "full"):
            if runs[remat][0] != runs["none"][0]:
                raise AssertionError(
                    f"{arch} {opt} x{micro} {ef}: remat {remat} "
                    f"losses {runs[remat][0]} != none's "
                    f"{runs['none'][0]}")
            _same_state(torch, runs["none"][1], runs[remat][1],
                        f"{arch} {opt} x{micro} {ef} remat "
                        f"{remat} vs none")
        final[(arch, opt, micro, ef)] = round(
            runs["none"][0][-1], 4)
    return {"k2_per_step": per_step, "final": final}


def _train_full(torch, m, card, counts, reset_counts, quiet) -> dict:
    """Phase 15: TRAIN_FULL's model trained on one card, as ``train_main``
    runs it under the tuner's plan (``adamw8bit``, f32 accumulation,
    ``dots``, 1 microbatch).  Step 0's per-token losses and per-leaf
    gradients on the kernel path against the plain path's (K2's plain forward, the same
    Function and backward), each within LOGITS_VS_CONTROL x the control's
    (the plain path with every norm of the rounded sum), the block weights
    drawn at their layers' fan-in (``_fan_in_draw``) so that the control
    reads at most GRAD_CONTROL_MAX (``_hold_grads``), K2's launches in
    the forward and in the recompute counted, the kernel path's repeated
    bit for bit; the optimizer's update timed; one step profiled; then
    ``TRAIN_FULL["steps"]`` steps of ``train_main`` on the kernel path
    (K2 counted per step, every loss and grad norm finite) beside the
    plain path's.  Returns K2's launches per step."""
    t15 = time.perf_counter()
    mem15, mark15 = _mem_marks(torch)
    mark15("before phase 15")
    ds = m.get_config(TRAIN_FULL["arch"])
    shape15 = dataclasses.replace(m.SHAPES["train_4k"],
                                  seq_len=TRAIN_FULL["seq_len"],
                                  global_batch=TRAIN_FULL["global_batch"])
    plan15 = m.tune(ds, shape15, m.get_target("nvidia:h100"))
    if (plan15.optimizer, plan15.grad_accum_dtype, plan15.remat_policy,
            plan15.microbatches) != ("adamw8bit", "float32", "dots", 1):
        raise AssertionError(f"deepseek-7b train plan: {plan15.report()}")
    tokens15 = TRAIN_FULL["seq_len"] * TRAIN_FULL["global_batch"]
    model15 = m.model_for(ds, remat=plan15.remat_policy)
    params15 = m.init_params(model15.param_table(),
                             torch.Generator(device="cuda").manual_seed(0),
                             "cuda")
    # the gradient gate's weights: each block matrix at its layer's fan-in
    _fan_in_draw(m, params15)
    batch15 = m.DataPipeline(model15, shape15, seed=0,
                             device="cuda").batch_at(0)

    def counted():
        got = counts()
        reset_counts()
        return got
    loss_k, tok_k, g_k, (fwd15, rec15) = _step0(
        torch, m, model15, params15, batch15, counted=counted)
    mark15("step 0 on the kernel path")
    # repeated, bit for bit (the embedding's backward sums a repeated
    # token's rows in a fixed order)
    loss_k2, _, g_k2, _ = _step0(torch, m, model15, params15, batch15)
    for path, gs in g_k.items():
        if loss_k2 != loss_k or not all(map(torch.equal, gs, g_k2[path])):
            raise AssertionError(f"deepseek-7b step 0 repeated: {path} "
                                 f"differs (loss {loss_k} then {loss_k2})")
    del g_k2
    mark15("step 0 on the kernel path, repeated")
    loss_p, tok_p, g_p, _ = _step0(torch, m, model15, params15, batch15,
                                   plain=True)
    err_k = _grad_errs(torch, g_k, g_p)
    del g_k
    mark15("step 0 on the plain path")
    loss_c, tok_c, g_c, _ = _step0(torch, m, model15, params15, batch15,
                                   plain=True, rounded=True)
    err_c = _grad_errs(torch, g_c, g_p)
    del g_c
    tok15 = (_rel_l2(torch, tok_k, tok_p), _rel_l2(torch, tok_c, tok_p))
    bias15 = (_bias_se(torch, tok_k, tok_p), _bias_se(torch, tok_c, tok_p))
    mark15("step 0 on the control")
    # per microbatch: layer 0's first norm, then the fused add + norms of
    # the blocks and ln_f; the remat recompute runs all but ln_f again
    nl15 = ds.num_layers
    r15 = int(plan15.remat_policy != "none")
    want_fwd = {"rmsnorm": 1, "add_rmsnorm": 2 * nl15}
    want_rec = {"rmsnorm": 1, "add_rmsnorm": 2 * nl15 - 1} if r15 else {}
    got_fwd = {k: v for k, v in fwd15.items() if v}
    got_rec = {k: v for k, v in rec15.items() if v}
    print(f"[train] {card} deepseek-7b step 0 (seq {TRAIN_FULL['seq_len']} "
          f"x batch {TRAIN_FULL['global_batch']}, remat "
          f"{plan15.remat_policy}, block weights at their layers' fan-in): "
          f"K2 launches in the forward {got_fwd} (predicted {1 + 2 * nl15}),"
          f" in the backward's recompute {got_rec} (predicted {2 * nl15}); "
          f"loss kernel {loss_k:.6f}, plain {loss_p:.6f}, control "
          f"{loss_c:.6f}; per-token losses rel L2 vs plain, kernel "
          f"{tok15[0]:.4g}, control {tok15[1]:.4g}; their mean difference "
          f"from the plain path's, kernel {bias15[0]['mean']:.4g} ("
          f"{bias15[0]['z']:.3f} standard errors of {bias15[0]['se']:.4g}), "
          f"control {bias15[1]['mean']:.4g} ({bias15[1]['z']:.3f} of "
          f"{bias15[1]['se']:.4g}; each within {BIAS_SE_MAX}); per-leaf "
          f"gradient rel "
          f"L2 vs plain, kernel "
          f"{({k: round(v, 6) for k, v in err_k.items()})}, control "
          f"{({k: round(v, 6) for k, v in err_c.items()})} (kernel <= "
          f"{LOGITS_VS_CONTROL} x control, control <= {GRAD_CONTROL_MAX})")
    if (got_fwd, got_rec) != (want_fwd, want_rec):
        raise AssertionError(f"deepseek-7b step 0: K2 launches forward "
                             f"{got_fwd} != {want_fwd} or recompute "
                             f"{got_rec} != {want_rec}")
    _hold_grads("deepseek-7b step 0", *tok15, err_k, err_c)
    _hold_bias("deepseek-7b step 0", *bias15)
    # the optimizer's update alone (plain gradients, 8-bit moments), and
    # one whole step under the profiler
    opt15 = m.make_optimizer(plan15.optimizer)
    state15 = m.init_train_state(model15, opt15, params15, plan15)
    grads_tree = {}
    for path, gs in g_p.items():
        node = grads_tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = gs if path.startswith("blocks/") else gs[0]
    lr15 = torch.tensor(3e-4, device="cuda")
    update_ms = _events_ms(torch, lambda: opt15.update(
        grads_tree, state15["opt"], params15, lr15), 2)
    del grads_tree, g_p
    mark15("optimizer update timed")
    step15 = m.build_train_step(model15, opt15, plan15)
    prof15 = _profile_ticks(torch, card, "deepseek-7b train step",
                            lambda: step15(state15, batch15), n=1)
    del state15, params15, step15, model15
    mark15("one step profiled")

    # train_main at full width: the kernel path, then the plain path
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    run15 = m.train_main(**TRAIN_FULL, log=quiet)
    train_counts = counts()
    peak15 = torch.cuda.max_memory_allocated() / 1e9
    if run15["plan"].remat_policy != plan15.remat_policy or \
            run15["plan"].optimizer != plan15.optimizer or \
            run15["device"] != "cuda":
        raise AssertionError(f"train_main: {run15['plan'].report()}")
    per_step15 = {k: want_fwd[k] + want_rec.get(k, 0) for k in want_fwd}
    got15 = {k: v for k, v in train_counts.items() if v}
    if got15 != {k: v * TRAIN_FULL["steps"] for k, v in per_step15.items()}:
        raise AssertionError(f"train_main: K2 launches {got15} in "
                             f"{TRAIN_FULL['steps']} steps, not "
                             f"{per_step15} each")
    if not all(map(math.isfinite, run15["losses"] + run15["grad_norms"])):
        raise AssertionError(f"train_main: losses {run15['losses']}, grad "
                             f"norms {run15['grad_norms']}")
    mark15("train_main, kernel path")
    _restart_full(torch, m, card, counts, reset_counts, run15.pop("state"),
                  plan15, ds, shape15, per_step15)
    mark15("restart through reshard_state")
    with _PlainNorms(m.ops, m.ref, m.layers):
        run15p = m.train_main(**TRAIN_FULL, log=quiet)
    del run15p["state"]
    mark15("train_main, plain path")
    step_ms = [round(1e3 * v, 3) for v in run15["step_s"]]
    steady = run15["step_s"][1:] or run15["step_s"]
    tps15 = tokens15 * len(steady) / sum(steady)
    t15 = time.perf_counter() - t15
    print(f"[train] {card} train_main(deepseek-7b, {ds.num_layers} layers, "
          f"d {ds.d_model}, {ds.num_heads} heads of {ds.head_dim}, vocab "
          f"{ds.vocab_size}, {m.param_count_estimate(ds) / 1e9:.3f} B "
          f"parameters, random weights from seed 0; plan "
          f"{plan15.optimizer}, {plan15.grad_accum_dtype} accumulation, "
          f"remat {plan15.remat_policy}, {plan15.microbatches} microbatch), "
          f"{TRAIN_FULL['steps']} steps of {tokens15} tokens: losses "
          f"kernel path {[round(v, 5) for v in run15['losses']]}, plain "
          f"path {[round(v, 5) for v in run15p['losses']]}; grad norms "
          f"{[round(v, 4) for v in run15['grad_norms']]}; K2 launches per "
          f"step {per_step15}; ms per step {step_ms} (host clock, device "
          f"drained), steps 1.. {tokens15 * len(steady)} tokens in "
          f"{sum(steady):.3f} s = {tps15:.1f} tokens/s; the optimizer's "
          f"update {update_ms:.3f} ms (CUDA events); profiler {prof15}; "
          f"peak memory {peak15:.1f} GB (predicted 55-60); phase 15 took "
          f"{t15:.1f} s; memory (GB allocated after, peak during) {mem15}")
    return per_step15


def _host_copy(torch, state) -> dict:
    """The state as host numpy arrays (bf16 as its raw 16-bit integers),
    as ``Checkpointer`` restores them."""
    def host(t):
        t = t.detach().cpu()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16
                else t).numpy()
    return {k: (host(v) if isinstance(v, torch.Tensor) else
                _host_copy(torch, v)) for k, v in state.items()}


def _restart_full(torch, m, card, counts, reset_counts, state, plan, cfg,
                  shape, per_step) -> None:
    """Phase 15's restart at full width: ``state`` (train_main's, after
    TRAIN_FULL's steps) copied to host numpy arrays, RESTART_STEPS more
    steps taken (the unbroken run) and their state copied to the host;
    the device state freed, the first host copy restored through
    ``reshard_state`` onto ``mesh_for_target("nvidia:h100")`` and the same
    steps taken on the same step-keyed batches: every leaf must equal the
    unbroken run's bit for bit, K2 counted on every norm of both runs."""
    model = m.model_for(cfg, remat=plan.remat_policy)
    opt = m.make_optimizer(plan.optimizer)
    step = m.build_train_step(model, opt, plan)
    pipe = m.DataPipeline(model, shape, seed=0, device="cuda")
    first = TRAIN_FULL["steps"]
    want_k2 = {k: v * RESTART_STEPS for k, v in per_step.items()}

    def steps(st, what):
        reset_counts()
        for i in range(RESTART_STEPS):
            st, _ = step(st, pipe.batch_at(first + i))
        torch.cuda.synchronize()
        got = {k: v for k, v in counts().items() if v}
        if got != want_k2:
            raise AssertionError(f"restart ({what}): K2 launches {got}, not "
                                 f"{want_k2}")
        return st
    torch.cuda.synchronize()
    host, copy_s = _timed(_host_copy, torch, state)
    state = steps(state, "unbroken")
    unbroken = m.tree_map(lambda t: t.detach().cpu(), state)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    table = m.train_state_table(model, opt, plan)
    mesh = m.mesh_for_target(m.get_target("nvidia:h100"))
    t0 = time.perf_counter()
    restored = m.reshard_state(host, table, mesh)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    del host
    gc.collect()
    restored = steps(restored, "restored")
    peak = torch.cuda.max_memory_allocated() / 1e9
    leaves = 0
    want = dict(m.leaf_items(unbroken))
    for path, got in m.leaf_items(restored):
        if got.device.type != "cuda" or not torch.equal(
                got, want[path].to("cuda")):
            raise AssertionError(f"restart: {'/'.join(path)} differs from "
                                 f"the unbroken run's")
        leaves += 1
    del restored, unbroken, want
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[train] {card} restart of full-width deepseek-7b through "
          f"reshard_state: the state after {first} steps of train_main "
          f"copied to host numpy arrays in {copy_s:.2f} s, {RESTART_STEPS} "
          f"steps unbroken, the host copy restored onto "
          f"mesh_for_target('nvidia:h100') {mesh.shape} in {restore_s:.2f} s "
          f"and the same {RESTART_STEPS} steps taken: all {leaves} leaves "
          f"equal the unbroken run's bit for bit; K2 launches {want_k2} in "
          f"each run; peak memory of the restored run {peak:.1f} GB")


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _nccl_mesh(torch, m):
    """A world-size-1 NCCL process group and a (1, 1) ("data", "model")
    DeviceMesh on the card; the caller destroys the group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", rank=0, world_size=1)
    dm = DeviceMesh("cuda", torch.arange(1).reshape(1, 1),
                    mesh_dim_names=("data", "model"))
    return m.Mesh(("data", "model"), (1, 1), "cuda", dm)


def _serve_nccl(torch, m, card, counts, reset_counts, quiet, reqs,
                p4) -> dict:
    """Phase 21: full-width deepseek-7b's paged engine, built as phase 4's
    (the same weights), serves ``reqs`` on a one-rank NCCL mesh (bound
    through the engine's ``_bind``: the weights at rest as DTensors,
    every step the mesh step); its streams, counts and K1/K2 launches
    equal phase 4's off-mesh run's (``p4``); then the legacy path's
    SERVE_NCCL_LEGACY job off and on the mesh (the split prefill and
    decode steps), tokens and launches equal.  Returns the mesh runs'
    launches."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    t21 = time.perf_counter()
    mesh = _nccl_mesh(torch, m)
    try:
        eng = m.ServeEngine(arch="deepseek-7b", kv_layout="paged",
                            num_slots=8, max_len=512, seed=0, log=quiet)
        if _weights_sig(eng) != p4["sig"]:
            raise AssertionError("phase 21's engine drew other weights than "
                                 "phase 4's")
        eng._bind(mesh)
        if not all(isinstance(t, DTensor)
                   for _, t in m.leaf_items(eng.params)):
            raise AssertionError("the engine's weights are not at rest on "
                                 "the mesh")
        reset_counts()
        st_on, on_s = _timed(eng.run, reqs)
        on = counts()
        comm = eng._decode.collectives
        if _streams(st_on) != p4["streams"]:
            raise AssertionError(f"the engine on the one-rank mesh: streams "
                                 f"{_streams(st_on)} != off the mesh "
                                 f"{p4['streams']}")
        same = (st_on.decode_steps, st_on.prefill_chunks, st_on.preemptions,
                st_on.generated_tokens)
        if same != p4["counts"] or on != p4["launches"] or \
                not on["paged_attention"] or not on["add_rmsnorm"]:
            raise AssertionError(f"the engine on the one-rank mesh: counts "
                                 f"{same} vs {p4['counts']}, launches {on} "
                                 f"vs {p4['launches']}")
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        kw = SERVE_NCCL_LEGACY
        cfg = m.get_config(kw["arch"])
        model = m.model_for(cfg, remat="none")
        params = m.init_params(model.param_table(), torch.Generator(
            device="cuda").manual_seed(0), "cuda")
        shape = dataclasses.replace(m.SHAPES["prefill_32k"],
                                    seq_len=kw["prefill_len"],
                                    global_batch=kw["batch"])
        req = m.to_device(m.SyntheticSource(cfg.vocab_size, 0).batch(
            model.batch_table(shape), 0), "cuda")
        dev = torch.device("cuda")
        on_params = m.reshard_state(params, model.param_table(), mesh)
        legacy = []
        for mesh_ in (None, mesh):
            steps = (m.build_prefill_step(model), m.build_decode_step(
                model)) if mesh_ is None else (m.build_prefill_step(
                    model, mesh_), m.build_decode_step(model, mesh_))
            if mesh_ is not None and not all(
                    "_split_" in f.__qualname__ for f in steps):
                raise AssertionError(f"{kw['arch']} on the mesh: not the "
                                     f"split steps ({steps})")
            reset_counts()
            legacy.append(m.legacy_generate(
                *steps, params if mesh_ is None else on_params, req,
                kw["decode_tokens"], dev) + (counts(),))
        (toks_off, pre_off, dec_off, l_off), (toks_on, pre_on, dec_on,
                                              l_on) = legacy
        if not toks_on.tolist() == toks_off.tolist() or not l_on == l_off \
                or not l_on["rmsnorm"]:
            raise AssertionError(f"{kw['arch']} on the one-rank mesh: "
                                 f"tokens {toks_on.tolist()} vs "
                                 f"{toks_off.tolist()}, launches {l_on} vs "
                                 f"{l_off}")
        del params, on_params, req, model
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    t21 = time.perf_counter() - t21
    print(f"[mesh] {card} deepseek-7b, {len(reqs)} requests through the "
          f"paged engine on a one-rank NCCL mesh (1, 1) ('data', 'model'), "
          f"phase 4's weights: greedy streams and counts (decode ticks, "
          f"chunks, preemptions, tokens) {same} bit for bit phase 4's off "
          f"the mesh, K1 and K2 launched as often ({on}); wall {on_s:.2f} s "
          f"on the mesh (host clock; phase 4's first run paid the "
          f"warm-ups); the last decode tick's collectives {comm} (one rank "
          f"sends nothing)")
    print(f"[mesh] {card} {kw['arch']} legacy path {kw['batch']} x "
          f"{kw['prefill_len']} + {kw['decode_tokens']} off the mesh and "
          f"through the split steps on it: every row's tokens equal, K2 "
          f"launches {l_on}; prefill "
          f"{pre_off:.3f} / {pre_on:.3f} s, decode {dec_off:.3f} / "
          f"{dec_on:.3f} s (off, the first run / on); phase 21 took "
          f"{t21:.1f} s")
    return {"engine": on, "legacy": l_on}


class _DryRun:
    """``dryrun.main(["--arch", "deepseek-7b", "--mesh", "both"])`` as a
    process of its own (``python -m repro_torch.launch.dryrun``, one CPU
    thread, no device), its records in a temporary directory: started
    before the card's phases, waited for in phase 22, killed on exit."""

    ARGV = ["--arch", "deepseek-7b", "--mesh", "both"]

    def __init__(self):
        self.after = None
        self.dir = tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_")
        env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
                   OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
        self.log = open(Path(self.dir.name) / "log.txt", "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", "import sys; from pathlib import Path; "
             "from repro_torch.launch import dryrun; sys.exit(dryrun.main("
             f"{self.ARGV!r}, out_dir=Path({self.dir.name!r}) / 'all'))"],
            env=env, stdout=self.log, stderr=subprocess.STDOUT)

    def mark(self, phase: int) -> None:
        """At the start of ``phase``: the first phase that began after the
        process ended (the printed timings of the phases before it ran
        beside it)."""
        if self.after is None and self.proc.poll() is not None:
            self.after = phase

    def wait(self, timeout: float) -> tuple:
        """(exit code, the records, seconds waited)."""
        t0 = time.perf_counter()
        code = self.proc.wait(timeout=timeout)
        recs = [json.loads(p.read_text()) for p in
                sorted((Path(self.dir.name) / "all").glob("*.json"))]
        return code, recs, time.perf_counter() - t0

    def tail(self) -> str:
        self.log.flush()
        return (Path(self.dir.name) / "log.txt").read_text()[-3000:]

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.log.close()
        self.dir.cleanup()


def _dryrun_card(torch, m, card, quiet, dry: _DryRun) -> dict:
    """Phase 22: DRYRUN_CELLS dry-run on ``nvidia:h100`` (meta), then the
    build's same steps on the card: arguments, peak and FLOPs held; the
    bound, time and share printed; then every deepseek-7b cell on both
    cluster meshes.  Returns per cell (measured ms, bound ms, peak GB
    traced and measured)."""
    from repro_torch.launch import dryrun
    t22 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as tdir:
        for shape_name, over in DRYRUN_CELLS:
            rec = dryrun.run_cell("deepseek-7b", shape_name, "nvidia:h100",
                                  overrides=over, out_dir=Path(tdir),
                                  target="nvidia:h100", log=quiet)
            if rec["status"] != "ok":
                raise AssertionError(f"dry run of {shape_name}: "
                                     f"{rec['error']}\n{rec['traceback']}")
            app = m.AppSpec(arch="deepseek-7b", shape=shape_name,
                            shape_overrides=over)
            res = m.BuildService().build(app, "nvidia:h100", lower=False)
            cfg = app.model_config
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            base0 = torch.cuda.memory_allocated()
            params = m.init_params(res.tables["params"], torch.Generator(
                device="cuda").manual_seed(0), "cuda")
            b, s = over["global_batch"], over["seq_len"]
            if shape_name.startswith("decode"):
                cache = {k: torch.zeros(d.shape, dtype=d.dtype,
                                        device="cuda")
                         for (k,), d in m.leaf_items(res.tables["cache"])
                         if k != "index"}
                cache["index"] = torch.tensor(s - 1, dtype=torch.int32)
                tokens = torch.randint(0, cfg.vocab_size, (b, 1),
                                       dtype=torch.int32, device="cuda")
                args = (params, cache, tokens)
            else:
                args = (params, {"tokens": torch.randint(
                    0, cfg.vocab_size, (b, s), dtype=torch.int32,
                    device="cuda")})
            torch.cuda.synchronize()
            inputs = torch.cuda.memory_allocated() - base0
            mem = rec["memory_analysis"]
            if abs(inputs - mem["argument_size_in_bytes"]) > \
                    DRYRUN_ARGS_RTOL * mem["argument_size_in_bytes"]:
                raise AssertionError(
                    f"dry run of {shape_name}: argument bytes "
                    f"{mem['argument_size_in_bytes']:.6g}, the inputs "
                    f"allocate {inputs:.6g}")
            step = res.step_fn
            # the counted run warms the step up for the peak's
            o, c = m.cost.measure(step, *args)
            del o
            if c.flops != rec["hlo_cost"]["flops_per_chip"]:
                raise AssertionError(
                    f"dry run of {shape_name}: {rec['hlo_cost']['flops_per_chip']}"
                    f" dot FLOPs, {c.flops} on the card")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            o = step(*args)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
            peak = torch.cuda.max_memory_allocated() - base
            del o
            traced = rec["hlo_cost"]["peak_bytes"]
            ratio = traced / peak
            if not DRYRUN_PEAK_RATIO[0] <= ratio <= DRYRUN_PEAK_RATIO[1]:
                raise AssertionError(
                    f"dry run of {shape_name}: traced peak {traced:.6g} B, "
                    f"the card's {peak:.6g} B above its inputs (ratio "
                    f"{ratio:.4f} outside {DRYRUN_PEAK_RATIO})")
            r = rec["roofline"]
            bound = max(r["t_compute_s"], r["t_memory_s"],
                        r["t_collective_s"]) * 1e3
            out[shape_name] = {"ms": ms, "bound_ms": bound,
                               "traced_gb": traced / 1e9,
                               "card_gb": peak / 1e9,
                               "args_gb": mem["argument_size_in_bytes"] / 1e9,
                               "trace_s": rec["trace_s"]}
            print(f"[dryrun] {card} deepseek-7b {shape_name} at {b} x {s} "
                  f"on nvidia:h100: traced on meta in {rec['trace_s']:.1f} "
                  f"s; arguments {mem['argument_size_in_bytes'] / 1e9:.4f} "
                  f"GB, the inputs allocate {inputs / 1e9:.4f} GB; peak "
                  f"above them traced {traced / 1e9:.4f} GB, the card's "
                  f"{peak / 1e9:.4f} GB (ratio {ratio:.4f}); dot FLOPs "
                  f"{c.flops:.6g} equal on the card; bound {bound:.3f} ms "
                  f"({r['bottleneck']}), measured {ms:.3f} ms (CUDA events),"
                  f" share {bound / ms:.3f}")
            del params, args, step, res
            gc.collect()
            torch.cuda.empty_cache()
    code, recs, waited = dry.wait(timeout=600)
    if code != 0 or len(recs) != 6 or any(r["status"] != "ok" for r in recs):
        raise AssertionError(
            f"dryrun.main {dry.ARGV}: exit {code}, "
            f"{[(r['shape'], r['mesh'], r['status']) for r in recs]}\n"
            f"{dry.tail()}")
    gb = {f"{r['shape']}/{r['mesh']}":
          round(r["memory_analysis"]["per_chip_total_gb"], 2) for r in recs}
    t22 = time.perf_counter() - t22
    main_s = sum(r["total_s"] for r in recs)
    print(f"[dryrun] {card} dryrun.main({dry.ARGV}) on nvidia:h100x256 and "
          f"nvidia:h100x512 (a process of its own, started before phase 1): "
          f"{len(recs)} records ok, their cells {main_s:.1f} s (the "
          f"records' total_s; the traces "
          f"{[round(r['trace_s'], 1) for r in recs]} s), {waited:.1f} s "
          f"waited for in phase 22, beside phases 1-"
          f"{(dry.after or 23) - 1} (GB a card {gb}); phase 22 took "
          f"{t22:.1f} s")
    out["main_s"] = main_s
    return out


def _lulesh_nccl(torch, m, card, counts, reset_counts) -> int:
    """Phase 20: LULESH's mesh step over a one-rank NCCL process group, a
    (1, 1) ("data", "model") DeviceMesh on the card: LULESH_NCCL's steps
    at its grid through ``lulesh.step(state, cfg, mesh)`` equal to the
    plain step's bit for bit.  One rank has no neighbour, so no halo is
    exchanged: NCCL carries dt's MAX all-reduce alone.  The stencil
    build's ``step_fn`` for ``nvidia:h100``, the plain step on one chip,
    is held against K4's step (another code) within STENCIL_TOL_1.  Then
    the fused kernel's run on the mesh (``lulesh.run(..., mesh,
    use_kernel=True)``: the fields gathered whole, K4 stepping the global
    grid, the rank's block kept at rest): LULESH_NCCL's kernel steps
    equal to the same run off the mesh bit for bit, K4 launched once a
    step on both.  The group is destroyed before the phase returns.
    Returns K4's launches on the mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    lulesh = m.lulesh
    t20 = time.perf_counter()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        dm = DeviceMesh("cuda", torch.arange(1).reshape(1, 1),
                        mesh_dim_names=("data", "model"))
        mesh = m.Mesh(("data", "model"), (1, 1), "cuda", dm)
        init_s = time.perf_counter() - t20
        cfg = lulesh.LuleshConfig(grid=LULESH_NCCL["grid"])
        n = LULESH_NCCL["steps"]

        def run(mesh_):
            # one step to warm up: NCCL makes a group's communicator on
            # the group's first collective
            t0 = time.perf_counter()
            lulesh.step(lulesh.init_state(cfg, "cuda"), cfg, mesh_)
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            st = lulesh.init_state(cfg, "cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                st = lulesh.step(st, cfg, mesh_)
            torch.cuda.synchronize()
            return st, (time.perf_counter() - t0) * 1e3 / n, warm_s
        plain, plain_ms, _ = run(None)
        meshed, mesh_ms, warm_s = run(mesh)
        for k in ("rho", "e", "v", "t"):
            got = meshed[k]
            if got.device_mesh is not dm or \
                    not torch.equal(got.to_local(), plain[k]):
                raise AssertionError(f"LULESH on the NCCL mesh: {k} differs "
                                     f"from the plain step's")
        app = m.AppSpec(arch="lulesh-dash", shape="train_4k",
                        run=f"lulesh -i 1 -s {cfg.grid}")
        built = m.BuildService().build(app, "nvidia:h100", lower=False)
        once = built.step_fn(plain)
        k4 = _rel_err(once, m.sedov_step_cuda(plain, m.ref.cfl_dt(plain)))
        if max(k4.values()) > STENCIL_TOL_1:
            raise AssertionError(f"the stencil build's step_fn against K4's "
                                 f"step: scale-relative error {k4} > "
                                 f"{STENCIL_TOL_1}")
        del plain, meshed, once
        # the fused kernel's run on the mesh against the run off it
        t_k = time.perf_counter()
        nk = LULESH_NCCL["kernel_steps"]
        k4_runs = []
        for mesh_ in (None, mesh):
            reset_counts()
            t0 = time.perf_counter()
            got = lulesh.run(lulesh.init_state(cfg, "cuda"), cfg, nk,
                             mesh=mesh_, use_kernel=True)
            torch.cuda.synchronize()
            k4_runs.append((got, counts()["sedov_stencil"],
                            time.perf_counter() - t0))
        (off, k4_off, off_s), (on, k4_on, on_s) = k4_runs
        for k in ("rho", "e", "v", "t"):
            if on[k].device_mesh is not dm or \
                    not torch.equal(on[k].to_local(), off[k]):
                raise AssertionError(f"K4's run on the NCCL mesh: {k} "
                                     f"differs from the run off it")
        if k4_on != nk or k4_off != nk:
            raise AssertionError(f"K4's run on the NCCL mesh launched "
                                 f"{k4_on} times, {k4_off} off it, not "
                                 f"{nk}")
        del off, on, k4_runs
        kernel_s = time.perf_counter() - t_k
    finally:
        dist.destroy_process_group()
    t20 = time.perf_counter() - t20
    print(f"[lulesh] {card} {n} plain steps at grid {cfg.grid} over a "
          f"one-rank NCCL mesh (1, 1) ('data', 'model'): bit for bit the "
          f"plain step's ({mesh_ms:.3f} ms a step on the mesh, "
          f"{plain_ms:.3f} off it, host clock, device drained; the group "
          f"and mesh up in {init_s:.2f} s, the first mesh step, with NCCL's "
          f"communicators, {warm_s:.2f} s; one rank exchanges no halo); "
          f"the stencil build's step_fn for nvidia:h100 within "
          f"{max(k4.values()):.3g} of K4's step (scale-relative, limit "
          f"{STENCIL_TOL_1}); {nk} fused kernel steps through "
          f"lulesh.run(..., mesh, use_kernel=True) (the fields gathered "
          f"whole, K4 on the global grid, the rank's block kept): bit for "
          f"bit the run off the mesh, K4 launched {k4_on} times on it and "
          f"{k4_off} off it ({on_s:.3f} / {off_s:.3f} s on / off, host "
          f"clock, device drained; {kernel_s:.1f} s for both); phase 20 "
          f"took {t20:.1f} s")
    return k4_on


class _StreamLog:
    """Every token the legacy fixed-batch path generates, row by row: its
    whole-batch step (``training.steps.build_decode_step``, which the path
    builds when it runs) wrapped to record the greedy tokens each step is
    fed and the pick of the last step's logits."""

    def __init__(self, steps):
        self.steps, self.runs = steps, []

    def __enter__(self):
        make_step = self.make_step = self.steps.build_decode_step
        runs = self.runs

        def recording(model):
            step = make_step(model)
            fed = []
            runs.append(fed)

            def decode(params, cache, tokens):
                logits, cache = step(params, cache, tokens)
                fed.append((tokens, logits[:, -1].argmax(-1)))
                return logits, cache
            return decode
        self.steps.build_decode_step = recording
        return self

    def __exit__(self, *exc):
        self.steps.build_decode_step = self.make_step
        return False

    def streams(self, i: int = -1) -> list:
        """Run ``i``'s tokens, one list per row."""
        fed = self.runs[i]
        cols = [t[:, 0].tolist() for t, _ in fed] + [fed[-1][1].tolist()]
        return [list(row) for row in zip(*cols)]


def _norms_per_forward(m, cfg) -> dict:
    """K2's launches in one forward of the legacy path's model, by entry:
    a dense or VLM model's first norm alone, then two fused add + norms a
    layer (``ln_f`` the last); a Zamba2 hybrid's two norms a Mamba2 block
    (its input norm and the gated norm), the shared block's first and
    ``ln_f`` on the ``rmsnorm`` entry and the shared block's second
    fused; none for a LayerNorm model (xLSTM)."""
    if cfg.norm != "rmsnorm":
        return {"rmsnorm": 0, "add_rmsnorm": 0}
    if cfg.family == "hybrid_mamba":
        _, segs, _ = m.model_for(cfg)._layout()
        return {"rmsnorm": 2 * cfg.num_layers + segs + 1, "add_rmsnorm": segs}
    return {"rmsnorm": 1, "add_rmsnorm": 2 * cfg.num_layers}


def _legacy_smoke(torch, m, counts, reset_counts, quiet, kw) -> dict:
    """Phase 3's legacy fixed-batch path at smoke size on the card (``kw``:
    VLM_SMOKE, SSM_SMOKE, HYBRID_SMOKE): ``serve_main`` with K2 on every
    norm (counted per forward, ``_norms_per_forward``: the prefill and
    each decode step), the same call with the plain norm in K2's place,
    and ``run_command``: every row's greedy tokens equal in all three."""
    cfg = m.get_config(kw["arch"])
    n_fwd = kw["decode_tokens"]
    cmd = (f"serve --arch {kw['arch']} --batch {kw['batch']} "
           f"--prefill {kw['prefill_len']} --decode {n_fwd}")
    with _StreamLog(m.steps) as log:
        reset_counts()
        out = m.serve_main(**kw, log=quiet)
        got = counts()
        with _PlainNorms(m.ops, m.ref, m.layers):
            plain = m.serve_main(**kw, log=quiet)
        via = m.run_command(cmd)
    want = dict(got, paged_attention=0, **{
        k: v * n_fwd for k, v in _norms_per_forward(m, cfg).items()})
    if got != want:
        raise AssertionError(f"{cmd}: launches {got} != {want}")
    streams = [log.streams(i) for i in range(3)]
    if streams[1] != streams[0] or streams[2] != streams[0] or \
            plain["sample"] != out["sample"] or via["sample"] != out["sample"]:
        raise AssertionError(f"{cmd}: streams differ, K2 {streams[0]}, "
                             f"plain {streams[1]}, run_command {streams[2]}")
    if (out["mode"], len(streams[0]), len(streams[0][0])) != (
            "legacy-static", kw["batch"], n_fwd):
        raise AssertionError(f"{cmd}: {out}")
    return {"launches": {k: v for k, v in got.items() if v},
            "sample": out["sample"]}


def _vlm_full(torch, m, card, counts, reset_counts, quiet) -> dict:
    """Phase 16: VLM_FULL (full-width, full-depth ``llava-next-34b``, random
    weights from seed 0) through the legacy fixed-batch path on one card.
    (a) ``run_easey`` of its serving Appfile to ``nvidia:h100``: K2 built,
    the job ``finished``, K2 counted on every norm of the prefill and of
    every decode step.  (b) A direct ``serve_main`` repeats the job's
    tokens; a free-running run with the plain norm in K2's place is
    printed beside them (not gated); then the model driven step by step,
    teacher-forced on the kernel path's tokens: each forward (the prefill,
    then each decode step) on the kernel path with every norm call held as
    phase 2 holds it, on the plain-norm path and on the control (the plain
    norm with one bf16 step of noise at as many norm outputs as K2
    changed), each decode step on copies of the same cache, the kernel
    path's logits within LOGITS_VS_CONTROL x the control's distance from
    the plain path's.  (c) Printed, not gated: the prefill and the decode
    step (CUDA events, the profiler), tokens/s, peak memory, and the
    data-sheet bounds.  Returns the launches of (a)."""
    t16 = time.perf_counter()
    mem16, mark16 = _mem_marks(torch)
    mark16("before phase 16")
    if mem16[0][1] > VLM_BASELINE_GB:
        raise AssertionError(f"phase 16 needs ~70 GiB, but "
                             f"{mem16[0][1]} GB is still allocated by the "
                             f"phases before it (at most {VLM_BASELINE_GB})")
    cfg = m.get_config(VLM_FULL["arch"])
    nl, b = cfg.num_layers, VLM_FULL["batch"]
    n_dec = VLM_FULL["decode_tokens"]
    params_n = m.param_count_estimate(cfg)
    cmd = (f"serve --arch {VLM_FULL['arch']} --batch {b} --prefill "
           f"{VLM_FULL['prefill_len']} --decode {n_dec}")
    app = m.parse_appfile(f"FROM arch:{VLM_FULL['arch']}\nSHAPE "
                          f"prefill_32k\n###include_local_kernels###\nRUN "
                          f"{cmd}\n")
    spec = m.parse_jobspec({"job": {"name": "serve-llava"},
                            "execution": [{"serial": {"command": cmd}}]})
    # (a) the EASEY deployment
    with tempfile.TemporaryDirectory(prefix="chip_smoke_vlm_") as tdir, \
            _StreamLog(m.steps) as log_a:
        reset_counts()
        (mw, jid, res), easey_s = _timed(m.run_easey, app, "nvidia:h100",
                                         spec, storage=tdir)
        launches = counts()
        if mw.status(jid) is not m.JobState.FINISHED:
            raise AssertionError(f"llava serving job "
                                 f"{mw.status(jid).value}: "
                                 f"{mw.logs(jid)[1][-3000:]}")
        out_a = mw.scheduler.result(jid)[0]
        built = dict(res.built)
        if (res.step_name, res.program["arch"], sorted(built),
                list(res.program["kernels"])) != (
                "prefill_step", "sm_90a", ["rmsnorm"], ["rmsnorm"]):
            raise AssertionError(f"llava serving build: {res.step_name}, "
                                 f"{res.program['arch']}, built {built}, "
                                 f"program {res.program['kernels']}")
        del mw, res
    # per forward (1 prefill + n_dec - 1 decode steps): layer 0's first
    # norm alone, then two fused add + norms a layer
    want = dict(launches, rmsnorm=n_dec, add_rmsnorm=2 * nl * n_dec,
                paged_attention=0)
    if launches != want:
        raise AssertionError(f"llava serve: launches {launches} != {want}")
    streams_a = log_a.streams()
    if len(streams_a) != b or any(
            len(r) != n_dec or not all(0 <= t < cfg.vocab_size for t in r)
            for r in streams_a) or out_a["mode"] != "legacy-static":
        raise AssertionError(f"llava serve: {out_a}, streams {streams_a}")
    mark16("EASEY job")
    print(f"[vlm] {card} run_easey(llava-next-34b serving Appfile, "
          f"nvidia:h100): build {built} for {m.build_arch}, job finished in "
          f"{easey_s:.1f} s; {nl} layers of {cfg.d_model}, "
          f"{cfg.num_heads} heads over {cfg.num_kv_heads} of "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{params_n / 1e9:.3f} B parameters, {cfg.num_patches} patches + "
          f"{VLM_FULL['prefill_len'] - cfg.num_patches} text tokens x {b}; "
          f"launches {({k: v for k, v in launches.items() if v})} (K2 on "
          f"all {n_dec + 2 * nl * n_dec} norms of 1 prefill + {n_dec - 1} "
          f"decode steps); prefill {out_a['prefill_s']:.3f} s, decode "
          f"{out_a['decode_tok_per_s']:.2f} tokens/s; memory (GB "
          f"allocated after, peak during) {mem16}")

    # (b) the direct call, and the plain norm free-running
    with _StreamLog(m.steps) as log_b:
        out_b = m.serve_main(**VLM_FULL, log=quiet)
        mark16("direct serve_main")
        with _PlainNorms(m.ops, m.ref, m.layers):
            m.serve_main(**VLM_FULL, log=quiet)
        mark16("plain-norm serve_main")
    if log_b.streams(0) != streams_a or out_b["sample"] != out_a["sample"]:
        raise AssertionError(f"llava: the direct serve_main's streams "
                             f"{log_b.streams(0)} differ from the job's "
                             f"{streams_a}")
    streams_p = log_b.streams(1)
    parts = [next((i for i, (x, y) in enumerate(zip(rk, rp)) if x != y),
                  None) for rk, rp in zip(streams_a, streams_p)]
    print(f"[vlm] {card} the direct serve_main repeats the job's {b} x "
          f"{n_dec} tokens ({out_b['decode_tok_per_s']:.2f} tokens/s); "
          f"free-running with the plain norm in K2's place (not gated): "
          f"the streams part at token {parts} per row; K2 path "
          f"{streams_a}, plain path {streams_p}")

    # (b) teacher-forced, step by step
    model = m.model_for(cfg, remat="none")
    params = m.init_params(model.param_table(),
                           torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
    shape = dataclasses.replace(m.SHAPES["prefill_32k"],
                                seq_len=VLM_FULL["prefill_len"],
                                global_batch=b)
    req = m.to_device(m.SyntheticSource(cfg.vocab_size, 0).batch(
        model.batch_table(shape), 0), "cuda")
    prefill = m.build_prefill_step(model)
    decode = m.build_decode_step(model)
    ops, ref = m.ops, m.ref
    kernel_norm, kernel_fused = ops.rmsnorm_cuda, ops.add_rmsnorm_cuda
    held, fracs = [], []
    noise = torch.Generator(device="cuda").manual_seed(0)

    def held_norm(x, w, *, eps=1e-6, out_dtype=None):
        h = _k2_norm_hold(torch, ref, kernel_norm, f"llava call "
                          f"{len(held)}", x, w)
        held.append(h)
        fracs.append(h["frac"])
        return kernel_norm(x, w, eps=eps, out_dtype=out_dtype)

    def held_fused(x, a, w, *, eps=1e-6, norm_of_rounded):
        h = _k2_hold(torch, ref, kernel_fused, f"llava call {len(held)}",
                     x, a, w, norm_of_rounded)
        held.append(h)
        fracs.append(h["frac"])
        return kernel_fused(x, a, w, eps=eps,
                            norm_of_rounded=norm_of_rounded)

    def noisy(frac):
        def norm(x, w, *, eps=1e-6, out_dtype=None):
            return _one_step_noise(torch, ref.rmsnorm_ref(
                x, w, eps=eps, out_dtype=out_dtype), frac, noise)

        def fused(x, a, w, *, eps=1e-6, norm_of_rounded):
            r, y = ref.add_rmsnorm_ref(x, a, w, eps=eps,
                                       norm_of_rounded=norm_of_rounded)
            return r, _one_step_noise(torch, y, frac, noise)
        return norm, fused

    def with_norms(norm, fused, fn, *args):
        ops.rmsnorm_cuda, ops.add_rmsnorm_cuda = norm, fused
        try:
            return fn(*args)
        finally:
            ops.rmsnorm_cuda, ops.add_rmsnorm_cuda = kernel_norm, \
                kernel_fused

    def plain_norm(x, w, *, eps=1e-6, out_dtype=None):
        return ref.rmsnorm_ref(x, w, eps=eps, out_dtype=out_dtype)

    def plain_fused(x, a, w, *, eps=1e-6, norm_of_rounded):
        return ref.add_rmsnorm_ref(x, a, w, eps=eps,
                                   norm_of_rounded=norm_of_rounded)

    def copy(cache):
        return dict(cache, k=cache["k"].clone(), v=cache["v"].clone())

    tf = []

    def forced(fn, *args, cache=None):
        """One forward on the three paths; the kernel path's result."""
        del fracs[:]
        out = with_norms(held_norm, held_fused, fn, *args)
        frac = sum(fracs) / len(fracs)
        rest = args if cache is None else (args[0], copy(cache), args[2])
        want = with_norms(plain_norm, plain_fused, fn, *rest)[0]
        rest = args if cache is None else (args[0], copy(cache), args[2])
        ctrl = with_norms(*noisy(frac), fn, *rest)[0]
        got, want, ctrl = (t[:, -1].float() for t in (out[0], want, ctrl))
        scale = float(want.abs().max())
        tf.append(dict(frac=frac,
                       rel=float((got - want).abs().max()) / scale,
                       ctrl=float((ctrl - want).abs().max()) / scale,
                       flips=int((got.argmax(-1) != want.argmax(-1)).sum()),
                       finite=bool(torch.isfinite(got).all())))
        return out

    logits, cache = forced(prefill, params, req)
    cache = dict(cache, **{
        key: torch.cat([cache[key], cache[key].new_zeros(
            cache[key].shape[:2] + (n_dec,) + cache[key].shape[3:])], dim=2)
        for key in ("k", "v")})
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    tf_tokens = [tok[:, 0].tolist()]
    for _ in range(n_dec - 1):
        logits, cache = forced(decode, params, cache, tok, cache=cache)
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        tf_tokens.append(tok[:, 0].tolist())
    tf_streams = [list(r) for r in zip(*tf_tokens)]
    mark16("teacher-forced run")
    if not all(t["finite"] for t in tf):
        raise AssertionError("llava teacher-forced: non-finite logits")
    if len(held) != n_dec * (1 + 2 * nl):
        raise AssertionError(f"llava teacher-forced: {len(held)} norm calls "
                             f"held, not {n_dec * (1 + 2 * nl)}")
    worst = max(tf, key=lambda t: t["rel"])
    ctrl = max(t["ctrl"] for t in tf)
    print(f"[vlm] {card} teacher-forced, 1 prefill + {n_dec - 1} decode "
          f"steps: every norm call held as phase 2 holds it ({len(held)} "
          f"calls: residual bitwise equal, norm within "
          f"{max(h['share'] for h in held):.4f} of one bf16 step, max abs "
          f"{max(h['abs'] for h in held):.4g}, two calls bitwise equal; "
          f"norm outputs K2 changed {min(t['frac'] for t in tf):.3g}.."
          f"{max(t['frac'] for t in tf):.3g} a forward); logits max |diff| / "
          f"max |logit| per forward, K2 vs plain norm "
          f"{[round(t['rel'], 4) for t in tf]}, control (plain with one-step "
          f"noise) vs plain {[round(t['ctrl'], 4) for t in tf]}; "
          f"{sum(t['flips'] for t in tf)} of {b * n_dec} greedy picks "
          f"differ; the teacher-forced run repeats the job's streams: "
          f"{tf_streams == streams_a}")
    if worst["rel"] > LOGITS_VS_CONTROL * ctrl:
        raise AssertionError(f"llava teacher-forced logits differ by "
                             f"{worst['rel']:.4g} of max |logit| > "
                             f"{LOGITS_VS_CONTROL} x the control's "
                             f"{ctrl:.4g}")

    # (c) numbers: the prefill and the decode step
    def one_prefill():
        return prefill(params, req)

    def one_step():
        return decode(params, cache, tok)
    prefill_ms = _events_ms(torch, one_prefill, 2)
    step_ms = _events_ms(torch, one_step, 10)
    prof_p = _profile_ticks(torch, card, f"llava-next-34b prefill ({b} x "
                            f"{VLM_FULL['prefill_len']})", one_prefill, n=1)
    prof_d = _profile_ticks(torch, card, f"llava-next-34b whole-batch "
                            f"decode step ({b} rows)", one_step, n=5)
    held_tokens = b * (VLM_FULL["prefill_len"] + n_dec // 2)
    step_bound = (2 * params_n + held_tokens * 2 * nl * cfg.num_kv_heads *
                  cfg.head_dim * 2) / HBM_BYTES_PER_S * 1e3
    prefill_bound = 2 * params_n * b * VLM_FULL["prefill_len"] / \
        BF16_TENSOR_FLOPS * 1e3
    del params, cache, req, logits, model
    mark16("timed")
    peak = max(p for _, _, p in mem16)
    t16 = time.perf_counter() - t16
    print(f"[vlm] {card} llava-next-34b full width: prefill "
          f"{prefill_ms:.3f} ms (CUDA events; bound {prefill_bound:.3f} ms "
          f"from {2 * params_n * b * VLM_FULL['prefill_len']:.4g} FLOP at "
          f"the dense bf16 rate), decode step {step_ms:.3f} ms (bound "
          f"{step_bound:.3f} ms: the weights and ~{held_tokens} tokens of "
          f"KV read once at the memory rate); profiler: prefill {prof_p}, "
          f"decode step {prof_d}; tokens/s EASEY "
          f"{out_a['decode_tok_per_s']:.2f}, direct "
          f"{out_b['decode_tok_per_s']:.2f}; peak memory {peak:.1f} GB; "
          f"phase 16 took {t16:.1f} s; memory (GB allocated after, peak "
          f"during) {mem16}")
    return {k: v for k, v in launches.items() if v}


def _mem_marks(torch):
    """(marks, mark): ``mark(what)`` frees what is unreferenced and
    appends (what, GB allocated after it, the peak GB since the last
    mark)."""
    marks = []

    def mark(what):
        gc.collect()
        torch.cuda.empty_cache()
        marks.append((what, round(torch.cuda.memory_allocated() / 1e9, 1),
                      round(torch.cuda.max_memory_allocated() / 1e9, 1)))
        torch.cuda.reset_peak_memory_stats()
    return marks, mark


def _clone_tree(torch, tree):
    """A copy of a cache: every tensor cloned, other leaves as they are."""
    if isinstance(tree, dict):
        return {k: _clone_tree(torch, v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _legacy_job(torch, m, card, counts, reset_counts, quiet, kw, name):
    """``run_easey`` of a serving Appfile ``RUN serve --arch ...`` of
    ``kw`` to ``nvidia:h100`` (the job must end ``finished``), then a
    direct ``serve_main`` that must repeat the job's greedy tokens.
    Returns (job result, its build, K2 launches, streams, direct result,
    the job's seconds)."""
    cmd = (f"serve --arch {kw['arch']} --batch {kw['batch']} --prefill "
           f"{kw['prefill_len']} --decode {kw['decode_tokens']}")
    app = m.parse_appfile(f"FROM arch:{kw['arch']}\nSHAPE prefill_32k\n"
                          f"###include_local_kernels###\nRUN {cmd}\n")
    spec = m.parse_jobspec({"job": {"name": name},
                            "execution": [{"serial": {"command": cmd}}]})
    with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{name}_") as tdir, \
            _StreamLog(m.steps) as log_a:
        reset_counts()
        (mw, jid, res), easey_s = _timed(m.run_easey, app, "nvidia:h100",
                                         spec, storage=tdir)
        launches = counts()
        if mw.status(jid) is not m.JobState.FINISHED:
            raise AssertionError(f"{name} job {mw.status(jid).value}: "
                                 f"{mw.logs(jid)[1][-3000:]}")
        out_a = mw.scheduler.result(jid)[0]
        build = (res.step_name, res.program["arch"], sorted(res.built),
                 list(res.program["kernels"]))
        del mw, res
    streams = log_a.streams()
    n_dec = kw["decode_tokens"]
    vocab = m.get_config(kw["arch"]).vocab_size
    if len(streams) != kw["batch"] or out_a["mode"] != "legacy-static" or \
            any(len(r) != n_dec or not all(0 <= t < vocab for t in r)
                for r in streams):
        raise AssertionError(f"{name}: {out_a}, streams {streams}")
    with _StreamLog(m.steps) as log_b:
        out_b = m.serve_main(**kw, log=quiet)
    if log_b.streams() != streams or out_b["sample"] != out_a["sample"]:
        raise AssertionError(f"{name}: the direct serve_main's streams "
                             f"{log_b.streams()} differ from the job's "
                             f"{streams}")
    return out_a, build, launches, streams, out_b, easey_s


def _ssm_full(torch, m, card, counts, reset_counts, quiet) -> None:
    """Phase 17: full-width, full-depth ``xlstm-1.3b`` (48 blocks of 2,048,
    random weights from seed 0) on one card.  (a) ``run_easey`` of SSM_FULL's
    serving Appfile to ``nvidia:h100``: the build compiles no kernel (a
    LayerNorm model), the job ends ``finished`` with no kernel launched,
    and a direct ``serve_main`` repeats its tokens.  (b) At full-width
    shapes (dk 512, dv 1,024, 1,024 positions, chunk 256, f32 inputs)
    ``mlstm_chunkwise`` against ``mlstm_recurrent`` within MLSTM_TOL.
    (c) The prefill of s + 1 tokens against the prefill of s and one
    decode step, within tests/test_models_decode.py's bound (5% of max
    |logit| + 0.05, the top token on half the rows).  (d) Printed, not
    gated: the decode step (CUDA events, the profiler) and the sLSTM time
    loop alone (host and device).  (e) SSM_TRAIN's steps of
    ``train_main``: every loss and grad norm finite, a second run's step 0
    bit for bit the first's; ms per step, tokens/s and peak memory
    printed."""
    t17 = time.perf_counter()
    mem, mark = _mem_marks(torch)
    mark("before phase 17")
    cfg = m.get_config(SSM_FULL["arch"])
    b, n_dec, P = (SSM_FULL[k] for k in ("batch", "decode_tokens",
                                         "prefill_len"))
    out_a, build, launches, streams, out_b, easey_s = _legacy_job(
        torch, m, card, counts, reset_counts, quiet, SSM_FULL, "serve-xlstm")
    if build != ("prefill_step", m.build_arch, [], []) or any(
            launches.values()):
        raise AssertionError(f"xlstm serving build {build}, launches "
                             f"{launches}: a LayerNorm model builds and "
                             f"launches no kernel")
    mark("EASEY job and direct serve_main")
    print(f"[ssm] {card} run_easey(xlstm-1.3b serving Appfile, "
          f"nvidia:h100): build {build[2]} (no kernel: LayerNorm), job "
          f"finished in {easey_s:.1f} s; {cfg.num_layers} blocks of "
          f"{cfg.d_model} ({cfg.num_layers // cfg.slstm_every} sLSTM), "
          f"{m.param_count_estimate(cfg) / 1e9:.3f} B parameters; {b} x "
          f"{P} prompt tokens, {n_dec} tokens each; prefill "
          f"{out_a['prefill_s']:.3f} s, decode {out_a['decode_tok_per_s']:.2f}"
          f" tokens/s EASEY, {out_b['decode_tok_per_s']:.2f} direct (the "
          f"direct serve_main repeats the job's {b} x {n_dec} tokens)")

    # (b) the chunkwise form against the recurrence at full width
    ssm = m.ssm
    H = cfg.ssm_heads
    dk, dv = cfg.ssm_head_dim, cfg.ssm_expand * cfg.d_model // H
    g = torch.Generator(device="cuda").manual_seed(17)

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    q, k, v = rn(1, H, P, dk), rn(1, H, P, dk), rn(1, H, P, dv)
    li, lf = 2 * rn(1, H, P), -rn(1, H, P).abs()
    yc, sc = ssm.mlstm_chunkwise(q, k, v, li, lf,
                                 ssm.mlstm_zero_state(1, H, dk, dv, "cuda"),
                                 cfg.ssm_chunk)
    yr, sr = ssm.mlstm_recurrent(q, k, v, li, lf,
                                 ssm.mlstm_zero_state(1, H, dk, dv, "cuda"))
    worst = 0.0
    for name, got, want in (("hidden", yc, yr), ("C", sc[0], sr[0]),
                            ("n", sc[1], sr[1]), ("m", sc[2], sr[2])):
        share = float(((got - want).abs() / (MLSTM_TOL + MLSTM_TOL *
                                              want.abs())).max())
        worst = max(worst, share)
        if share > 1:
            raise AssertionError(f"mlstm_chunkwise {name} at full width: "
                                 f"{share:.4g} of rtol = atol = {MLSTM_TOL} "
                                 f"from mlstm_recurrent")
    print(f"[ssm] {card} mlstm_chunkwise vs mlstm_recurrent at (1, {H}, {P}"
          f", dk {dk}, dv {dv}), chunk {cfg.ssm_chunk}, f32: within "
          f"{worst:.4f} of rtol = atol = {MLSTM_TOL}")
    del q, k, v, li, lf, yc, sc, yr, sr

    # (c) prefill(s + 1) against prefill(s) + one decode step
    model = m.model_for(cfg, remat="none")
    params = m.init_params(model.param_table(),
                           torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
    prefill, decode = m.build_prefill_step(model), m.build_decode_step(model)
    shape = dataclasses.replace(m.SHAPES["prefill_32k"], seq_len=P + 1,
                                global_batch=b)
    req = m.to_device(m.SyntheticSource(cfg.vocab_size, 0).batch(
        model.batch_table(shape), 0), "cuda")
    want, _ = prefill(params, req)
    _, cache = prefill(params, {"tokens": req["tokens"][:, :-1]})
    got, cache = decode(params, cache, req["tokens"][:, -1:])
    a, c_ = want[:, -1].float(), got[:, -1].float()
    gap = float((a - c_).abs().max())
    top = float((a.argmax(-1) == c_.argmax(-1)).float().mean())
    if not (gap < 0.05 * (float(a.abs().max()) + 1) and top >= 0.5):
        raise AssertionError(f"xlstm prefill({P + 1}) vs prefill({P}) + "
                             f"decode: max |diff| {gap:.4g}, top-1 {top}")
    print(f"[ssm] {card} prefill of {P + 1} tokens vs prefill of {P} + one "
          f"decode step: max |diff| {gap:.4g} ({gap / float(a.abs().max()):.4g}"
          f" of max |logit|; bound 5% + 0.05), top-1 equal on {top:.2f} of "
          f"the rows")

    # (d) numbers: the prefill, the decode step, the sLSTM loop
    tok = got[:, -1].argmax(-1).to(torch.int32)[:, None]
    step_ms = _events_ms(torch, lambda: decode(params, cache, tok), 5)
    prof_d = _profile_ticks(torch, card, f"xlstm-1.3b whole-batch decode "
                            f"step ({b} rows)",
                            lambda: decode(params, cache, tok), n=3)
    dh = cfg.d_model // H
    gx = rn(b, P, 4, H, dh).to(torch.bfloat16)
    R = (0.05 * rn(4, H, dh, dh)).to(torch.bfloat16)
    zero = ssm.slstm_zero_state(b, H, dh, "cuda")
    prof_s = _profile_ticks(torch, card, f"sLSTM time loop ({b} x {P} "
                            f"steps, {H} heads of {dh})",
                            lambda: ssm.slstm_scan(gx, R, zero), n=1)
    del params, cache, model, want, got, req, gx, prefill, decode
    mark("prefill, decode and numbers")
    print(f"[ssm] {card} xlstm-1.3b full width: decode step {step_ms:.3f} ms "
          f"(CUDA events); profiler: decode step {prof_d}, sLSTM loop "
          f"{prof_s} (the prefill, ~190,000 launches, is timed by the "
          f"job's host clock: prefill {out_a['prefill_s']:.3f} s)")

    # (e) training
    res = m.train_main(**SSM_TRAIN, log=quiet)
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses, norms = res["losses"], res["grad_norms"]
    plan, step_s = res["plan"], res["step_s"]
    del res
    mark("train_main")
    again = m.train_main(**dict(SSM_TRAIN, steps=1), log=quiet)
    if not (all(map(math.isfinite, losses + norms)) and
            len(losses) == SSM_TRAIN["steps"]):
        raise AssertionError(f"xlstm training: losses {losses}, grad norms "
                             f"{norms}")
    if (again["losses"][0], again["grad_norms"][0]) != (losses[0], norms[0]):
        raise AssertionError(f"xlstm training: a second run's step 0 "
                             f"({again['losses'][0]}, "
                             f"{again['grad_norms'][0]}) != the first's "
                             f"({losses[0]}, {norms[0]})")
    del again
    mark("a second run's step 0")
    tokens = SSM_TRAIN["seq_len"] * SSM_TRAIN["global_batch"]
    print(f"[ssm] {card} train_main(xlstm-1.3b, {SSM_TRAIN['global_batch']}"
          f" x {SSM_TRAIN['seq_len']}, {SSM_TRAIN['steps']} steps; plan "
          f"{plan.optimizer}, remat {plan.remat_policy}, "
          f"{plan.microbatches} microbatch(es)): losses {losses}, grad norms "
          f"{norms}, all finite; a second run repeats step 0 bit for bit; "
          f"ms per step {[round(t * 1e3, 1) for t in step_s]} (host clock, "
          f"device drained), {tokens / (sum(step_s[1:]) / max(len(step_s) - 1, 1)):.1f}"
          f" tokens/s after step 0; peak memory {peak:.1f} GB")
    t17 = time.perf_counter() - t17
    print(f"[ssm] {card} phase 17 took {t17:.1f} s; memory (GB allocated "
          f"after, peak during) {mem}")


def _band_dense(torch, layers, q, k, v, window):
    """Dense attention under the sliding window's band: every key of the
    sequence, masked to i - window < j <= i (q-chunks of 1,024 against
    all t keys)."""
    b, s, H, dh = q.shape
    K = k.shape[2]
    qg = q.reshape(b, s, K, H // K, dh).permute(0, 2, 3, 1, 4)
    kv_pos = torch.arange(s, device=q.device)[None, :]
    outs = []
    for start in range(0, s, 1024):
        q_pos = torch.arange(start, min(start + 1024, s),
                             device=q.device)[:, None]
        band = (kv_pos <= q_pos) & (kv_pos > q_pos - window)
        outs.append(layers._attn_one_chunk(
            qg[:, :, :, start:start + 1024], k, v, band[None],
            1.0 / math.sqrt(dh)))
    return torch.cat(outs, dim=3).permute(0, 3, 1, 2, 4).reshape(b, s, H,
                                                                 dh)


def _hybrid_full(torch, m, card, counts, reset_counts, quiet) -> dict:
    """Phase 18: full-width, full-depth ``zamba2-7b`` (81 Mamba2 layers of
    3,584 and one shared attention + MLP block applied 13 times, 6.75 B
    parameters, random weights from seed 0) on one card.  (a)
    ``run_easey`` of HYBRID_FULL's serving Appfile to ``nvidia:h100``:
    the build compiles K2 alone, the job ends ``finished``, K2 counted on
    every norm of the prefill and of every decode step
    (``_norms_per_forward``), and a direct ``serve_main`` repeats its
    tokens.  (b) The model step by step, teacher-forced on the job's
    tokens as phase 16 does it: every norm call held as phase 2 holds it,
    each forward's logits within LOGITS_VS_CONTROL x the control's
    distance from the plain-norm path's.  (c) One request of HYBRID_LONG
    tokens (twice the window) through prefill: each application of the
    shared block's windowed attention held against dense attention under
    the same band (``_band_dense``) within WINDOW_TOL of the largest
    entry, and shown to differ from unbanded causal attention.  (d)
    Printed, not gated: the prefill and the decode step (CUDA events, the
    profiler: busy ms, launches, idle share), the SSD chunkwise scan
    alone, tokens/s and peak memory.  Returns the job's launches."""
    t18 = time.perf_counter()
    mem, mark = _mem_marks(torch)
    mark("before phase 18")
    cfg = m.get_config(HYBRID_FULL["arch"])
    b, n_dec, P = (HYBRID_FULL[k] for k in ("batch", "decode_tokens",
                                            "prefill_len"))
    params_n = m.param_count_estimate(cfg)
    out_a, build, launches, streams_a, out_b, easey_s = _legacy_job(
        torch, m, card, counts, reset_counts, quiet, HYBRID_FULL,
        "serve-zamba")
    per_fwd = _norms_per_forward(m, cfg)
    want = dict(launches, paged_attention=0,
                **{k: v * n_dec for k, v in per_fwd.items()})
    if build != ("prefill_step", m.build_arch, ["rmsnorm"], ["rmsnorm"]) \
            or launches != want:
        raise AssertionError(f"zamba serving build {build}, launches "
                             f"{launches} != {want}")
    mark("EASEY job and direct serve_main")
    print(f"[hybrid] {card} run_easey(zamba2-7b serving Appfile, "
          f"nvidia:h100): build {build[2]}, job finished in {easey_s:.1f} s; "
          f"{cfg.num_layers} Mamba2 layers of {cfg.d_model} (d_inner "
          f"{cfg.ssm_expand * cfg.d_model}, {cfg.ssm_heads} heads, state "
          f"{cfg.ssm_state}), the shared block ({cfg.num_heads} heads, d_ff "
          f"{cfg.d_ff}, window {cfg.window}) applied "
          f"{m.model_for(cfg)._layout()[1]} times, {params_n / 1e9:.3f} B "
          f"parameters; {b} x {P} prompt tokens, {n_dec} tokens each; "
          f"launches {({k: v for k, v in launches.items() if v})} (K2 on all "
          f"{sum(per_fwd.values())} norms of each of 1 prefill + {n_dec - 1} "
          f"decode steps); prefill {out_a['prefill_s']:.3f} s, decode "
          f"{out_a['decode_tok_per_s']:.2f} tokens/s EASEY, "
          f"{out_b['decode_tok_per_s']:.2f} direct (the direct serve_main "
          f"repeats the job's tokens)")

    # (b) teacher-forced on the job's tokens
    model = m.model_for(cfg, remat="none")
    params = m.init_params(model.param_table(),
                           torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
    shape = dataclasses.replace(m.SHAPES["prefill_32k"], seq_len=P,
                                global_batch=b)
    req = m.to_device(m.SyntheticSource(cfg.vocab_size, 0).batch(
        model.batch_table(shape), 0), "cuda")
    prefill, decode = m.build_prefill_step(model), m.build_decode_step(model)
    ops, ref = m.ops, m.ref
    kernel_norm, kernel_fused = ops.rmsnorm_cuda, ops.add_rmsnorm_cuda
    held, fracs = [], []
    noise = torch.Generator(device="cuda").manual_seed(0)

    def held_norm(x, w, *, eps=1e-6, out_dtype=None):
        h = _k2_norm_hold(torch, ref, kernel_norm, f"zamba call "
                          f"{len(held)}", x, w)
        held.append(h)
        fracs.append(h["frac"])
        return kernel_norm(x, w, eps=eps, out_dtype=out_dtype)

    def held_fused(x, a, w, *, eps=1e-6, norm_of_rounded):
        h = _k2_hold(torch, ref, kernel_fused, f"zamba call {len(held)}",
                     x, a, w, norm_of_rounded)
        held.append(h)
        fracs.append(h["frac"])
        return kernel_fused(x, a, w, eps=eps,
                            norm_of_rounded=norm_of_rounded)

    def noisy(frac):
        def norm(x, w, *, eps=1e-6, out_dtype=None):
            return _one_step_noise(torch, ref.rmsnorm_ref(
                x, w, eps=eps, out_dtype=out_dtype), frac, noise)

        def fused(x, a, w, *, eps=1e-6, norm_of_rounded):
            r, y = ref.add_rmsnorm_ref(x, a, w, eps=eps,
                                       norm_of_rounded=norm_of_rounded)
            return r, _one_step_noise(torch, y, frac, noise)
        return norm, fused

    def plain_norm(x, w, *, eps=1e-6, out_dtype=None):
        return ref.rmsnorm_ref(x, w, eps=eps, out_dtype=out_dtype)

    def plain_fused(x, a, w, *, eps=1e-6, norm_of_rounded):
        return ref.add_rmsnorm_ref(x, a, w, eps=eps,
                                   norm_of_rounded=norm_of_rounded)

    def with_norms(norm, fused, fn, *args):
        ops.rmsnorm_cuda, ops.add_rmsnorm_cuda = norm, fused
        try:
            return fn(*args)
        finally:
            ops.rmsnorm_cuda, ops.add_rmsnorm_cuda = kernel_norm, \
                kernel_fused

    tf = []

    def forced(fn, *args, cache=None):
        """One forward on the three paths (each decode step on copies of
        the same cache); the kernel path's result."""
        rest = [args if cache is None else
                (args[0], _clone_tree(torch, cache), args[2])
                for _ in range(2)]
        del fracs[:]
        out = with_norms(held_norm, held_fused, fn, *args)
        frac = sum(fracs) / len(fracs)
        want = with_norms(plain_norm, plain_fused, fn, *rest[0])[0]
        ctrl = with_norms(*noisy(frac), fn, *rest[1])[0]
        got, want, ctrl = (t[:, -1].float() for t in (out[0], want, ctrl))
        scale = float(want.abs().max())
        tf.append(dict(frac=frac,
                       rel=float((got - want).abs().max()) / scale,
                       ctrl=float((ctrl - want).abs().max()) / scale,
                       flips=int((got.argmax(-1) != want.argmax(-1)).sum()),
                       finite=bool(torch.isfinite(got).all())))
        return out

    logits, cache = forced(prefill, params, req)
    cache = m.grow_kv(cache, n_dec)
    tf_tokens = [logits[:, -1].argmax(-1).tolist()]
    for i in range(n_dec - 1):
        # teacher-forced: each step is fed the job's token
        tok = torch.tensor([r[i] for r in streams_a], dtype=torch.int32,
                           device="cuda")[:, None]
        logits, cache = forced(decode, params, cache, tok, cache=cache)
        tf_tokens.append(logits[:, -1].argmax(-1).tolist())
    mark("teacher-forced run")
    n_norms = sum(per_fwd.values())
    if not all(t["finite"] for t in tf) or len(held) != n_dec * n_norms:
        raise AssertionError(f"zamba teacher-forced: finite "
                             f"{[t['finite'] for t in tf]}, {len(held)} norm "
                             f"calls held, not {n_dec * n_norms}")
    worst = max(tf, key=lambda t: t["rel"])
    ctrl = max(t["ctrl"] for t in tf)
    print(f"[hybrid] {card} teacher-forced on the job's tokens, 1 prefill + "
          f"{n_dec - 1} decode steps: every norm call held as phase 2 holds "
          f"it ({len(held)} calls: residual bitwise equal, norm within "
          f"{max(h['share'] for h in held):.4f} of one bf16 step, max abs "
          f"{max(h['abs'] for h in held):.4g}, two calls bitwise equal; norm "
          f"outputs K2 changed {min(t['frac'] for t in tf):.3g}.."
          f"{max(t['frac'] for t in tf):.3g} a forward); logits max |diff| / "
          f"max |logit| per forward, K2 vs plain norm "
          f"{[round(t['rel'], 4) for t in tf]}, control (plain with one-step "
          f"noise) vs plain {[round(t['ctrl'], 4) for t in tf]}; "
          f"{sum(t['flips'] for t in tf)} of {b * n_dec} greedy picks differ; "
          f"the kernel path's picks repeat the job's: "
          f"{[list(r) for r in zip(*tf_tokens)] == streams_a}")
    if worst["rel"] > LOGITS_VS_CONTROL * ctrl:
        raise AssertionError(f"zamba teacher-forced logits differ by "
                             f"{worst['rel']:.4g} of max |logit| > "
                             f"{LOGITS_VS_CONTROL} x the control's "
                             f"{ctrl:.4g}")

    # (d) numbers: the prefill, the decode step, the SSD scan
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    prefill_ms = _events_ms(torch, lambda: prefill(params, req), 2)
    step_ms = _events_ms(torch, lambda: decode(params, cache, tok), 5)
    prof_p = _profile_ticks(torch, card, f"zamba2-7b prefill ({b} x {P})",
                            lambda: prefill(params, req), n=1)
    prof_d = _profile_ticks(torch, card, f"zamba2-7b whole-batch decode "
                            f"step ({b} rows)",
                            lambda: decode(params, cache, tok), n=3)
    del cache, logits
    di = cfg.ssm_expand * cfg.d_model
    H, n = cfg.ssm_heads, cfg.ssm_state
    g = torch.Generator(device="cuda").manual_seed(18)

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    ssd_args = (rn(b, P, H, di // H), 0.5 * rn(b, P, H).abs() + 0.01,
                -rn(H).abs() - 0.1, 0.5 * rn(b, P, n), 0.5 * rn(b, P, n),
                rn(H), None, cfg.ssm_chunk)
    ssd_ms = _events_ms(torch, lambda: m.mamba.ssd_chunkwise(*ssd_args), 3)
    prof_s = _profile_ticks(torch, card, f"SSD chunkwise scan ({b} x {P}, "
                            f"{H} heads of {di // H}, state {n}, chunk "
                            f"{cfg.ssm_chunk})",
                            lambda: m.mamba.ssd_chunkwise(*ssd_args), n=3)
    del ssd_args
    mark("timed")

    # (c) one request of twice the window through prefill
    seen = []
    windowed = m.layers._windowed_attention

    _, segs, _ = model._layout()

    def recording(q, k, v, window, *rest):
        out = windowed(q, k, v, window, *rest)
        seen.append((q, k, v, out) if len(seen) in (0, segs - 1) else None)
        return out
    m.layers._windowed_attention = recording
    try:
        long_req = {"tokens": m.to_device(m.SyntheticSource(
            cfg.vocab_size, 1).batch(model.batch_table(dataclasses.replace(
                shape, seq_len=HYBRID_LONG, global_batch=1)), 0),
            "cuda")["tokens"]}
        (long_logits, long_cache), long_s = _timed(
            lambda: (prefill(params, long_req), torch.cuda.synchronize())[0])
    finally:
        m.layers._windowed_attention = windowed
    if len(seen) != segs or not bool(torch.isfinite(long_logits).all()):
        raise AssertionError(f"zamba long prefill: {len(seen)} windowed "
                             f"attentions, not {segs}")
    long_kv = tuple(long_cache["shared_kv"]["k"].shape)
    del long_cache, long_logits
    band = []
    for q, k, v, out in (x for x in seen if x is not None):
        dense = _band_dense(torch, m.layers, q, k, v, cfg.window)
        share = float((out.float() - dense.float()).abs().max()) / (
            WINDOW_TOL * float(dense.float().abs().max()))
        causal = m.layers.dot_attention(q[:, -1024:], k, v, causal=True,
                                        q_offset=HYBRID_LONG - 1024)
        moved = float((causal.float() - out[:, -1024:].float()).abs().max())
        band.append((round(share, 4), round(moved, 4)))
        if share > 1 or moved == 0.0:
            raise AssertionError(f"zamba windowed attention at "
                                 f"{HYBRID_LONG} tokens: {share:.4g} of "
                                 f"the tolerance from dense attention "
                                 f"under its band; unbanded causal moves "
                                 f"the last 1,024 queries by {moved}")
        del dense, causal
    del seen
    mark(f"prefill of {HYBRID_LONG} tokens")
    del params, model, req, prefill, decode
    mark("freed")
    peak = max(p for _, _, p in mem)
    t18 = time.perf_counter() - t18
    print(f"[hybrid] {card} one request of {HYBRID_LONG} tokens (window "
          f"{cfg.window}) through prefill in {long_s:.3f} s (host clock), "
          f"shared K/V {long_kv}: the first and last of the {segs} windowed "
          f"attentions against dense attention under the same band, "
          f"(share of {WINDOW_TOL} x max |dense|, max |diff| of unbanded "
          f"causal attention on the last 1,024 queries) {band}")
    print(f"[hybrid] {card} zamba2-7b full width: prefill ({b} x {P}) "
          f"{prefill_ms:.3f} ms, decode step {step_ms:.3f} ms (CUDA events); "
          f"profiler: prefill {prof_p}, decode step {prof_d}; SSD chunkwise "
          f"scan alone {ssd_ms:.3f} ms (events), {prof_s}; tokens/s EASEY "
          f"{out_a['decode_tok_per_s']:.2f}, direct "
          f"{out_b['decode_tok_per_s']:.2f}; peak memory {peak:.1f} GB; "
          f"phase 18 took {t18:.1f} s; memory (GB allocated after, peak "
          f"during) {mem}")
    return {k: v for k, v in launches.items() if v}


def _decode_vs_prefill(torch, m, prefill, decode, params, frames, tokens,
                       s: int, n: int) -> dict:
    """The prefill of ``s`` tokens and ``n`` teacher-forced whole-batch
    decode steps against one prefill of all ``s + n`` (the same frames):
    the last step's logits against the longer prefill's (``rel``, max
    |diff| / max |logit|), beside the control (``ctrl``: the longer
    prefill with one bf16 step of noise at the decoder's LayerNorm
    outputs at the decoded positions, at the fraction of decoded self K/V
    entries, or of the last step's logits, that differ from the longer
    prefill's, whichever is larger; the encoder is left alone, since both
    sides share it bit for bit) and the reference's cross-attention gap
    (``gap``: the same decode with ``bk`` and ``bv`` taken out of the
    cached cross K/V and ``bq`` out of the decode step's cross query, as
    the reference computes them)."""
    if frames.shape[1] in (1, s + n):
        raise ValueError("the control tells the decoder's norms by length")
    want, full = prefill(params, {"frames": frames, "tokens": tokens})

    def run(gap: bool):
        _, cache = prefill(params, {"frames": frames,
                                    "tokens": tokens[:, :s]})
        cache = m.grow_kv(cache, n)
        xattn = params["dec_blocks"]["xattn"]
        bq = xattn["bq"].clone()
        if gap:
            for k, b in (("xk", "bk"), ("xv", "bv")):
                cache[k].sub_(xattn[b][:, None, None].to(cache[k].dtype))
            xattn["bq"].zero_()
        finite = True
        try:
            for i in range(n):
                got, cache = decode(params, cache, tokens[:, s + i:s + i + 1])
                finite = finite and bool(torch.isfinite(got).all())
        finally:
            xattn["bq"].copy_(bq)
        return got, cache, finite
    got, cache, finite = run(False)
    kv_differ = {k: float((cache[k][:, :, s:] != full[k][:, :, s:])
                          .float().mean()) for k in ("k", "v")}
    frac = max(sum(kv_differ.values()) / 2,
               float((got[:, -1] != want[:, -1]).float().mean()))
    del cache
    gapped = run(True)[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    plain = m.layers.layernorm

    def noisy(x, scale, bias, eps=1e-5, out_dtype=None):
        out = plain(x, scale, bias, eps, out_dtype)
        if out.shape[1] == 1:        # ln_f of the last position
            return _one_step_noise(torch, out, frac, gen)
        if out.shape[1] == s + n:    # a decoder norm: its decoded positions
            return torch.cat([out[:, :s], _one_step_noise(
                torch, out[:, s:].contiguous(), frac, gen)], 1)
        return out                   # an encoder norm
    m.layers.layernorm = noisy
    try:
        ctrl, _ = prefill(params, {"frames": frames, "tokens": tokens})
    finally:
        m.layers.layernorm = plain
    got, want, ctrl, gapped = (t[:, -1].float()
                               for t in (got, want, ctrl, gapped))
    scale = float(want.abs().max())
    return dict(rel=float((got - want).abs().max()) / scale,
                ctrl=float((ctrl - want).abs().max()) / scale,
                gap=float((gapped - want).abs().max()) / scale, frac=frac,
                kv_differ=kv_differ,
                top1=float((got.argmax(-1) == want.argmax(-1)).float()
                           .mean()), finite=finite)


def _step_roofline(torch, m, card, what, cfg, shape, fn, *args) -> dict:
    """One call of a step through ``analysis.cost`` (dot FLOPs, least
    bytes) beside ``analysis.flops.model_flops`` of its shape, the
    roofline's three terms on the H100's data-sheet peaks, the step's
    device time (CUDA events, warmed up), the share of the bound it
    reaches and the profiler's idle share; printed, not gated."""
    _, c = m.cost.measure(fn, *args)
    mf = m.flops.model_flops(cfg, shape)
    r = m.roofline.from_cost(c)
    ms = _events_ms(torch, lambda: fn(*args), 5)
    prof = _profile_ticks(torch, card, what, lambda: fn(*args), n=3)
    out = dict(dot_flops=c.flops, dots=c.dot_count, model_flops=mf,
               read_bytes=c.read_bytes, write_bytes=c.write_bytes,
               t_compute_ms=r.t_compute * 1e3, t_memory_ms=r.t_memory * 1e3,
               t_collective_ms=r.t_collective * 1e3,
               bound_ms=r.t_bound * 1e3, bottleneck=r.bottleneck, ms=ms,
               share=r.t_bound * 1e3 / ms, idle=prof.get("idle"),
               busy_ms=prof.get("busy_ms"), kernels=prof["kernels"])
    print(f"[roofline] {card} {what}: dot FLOPs {c.flops:.6g} in "
          f"{c.dot_count} products (analysis.cost) vs model_flops "
          f"{mf['total']:.6g} (dense {mf['dense']:.6g} of "
          f"{mf['n_active']:,} parameters, attention "
          f"{mf['attention']:.6g}); least bytes {c.hbm_bytes:.6g} (read "
          f"{c.read_bytes:.6g}, written {c.write_bytes:.6g}); terms "
          f"compute {out['t_compute_ms']:.6f} ms, memory "
          f"{out['t_memory_ms']:.6f} ms, collective "
          f"{out['t_collective_ms']:.6f} ms: bound {out['bound_ms']:.6f} "
          f"ms ({r.bottleneck}; {m.roofline.PEAK_FLOPS / 1e12:g} TFLOP/s "
          f"bf16, {m.roofline.HBM_BW / 1e12:g} TB/s); measured "
          f"{ms:.6f} ms (CUDA events, warmed up): {out['share']:.6f} of the "
          f"bound; profiler busy {out['busy_ms']} ms, idle share "
          f"{out['idle']}, {out['kernels']:g} kernels a call")
    return out


def _whisper_full(torch, m, card, counts, reset_counts, quiet) -> dict:
    """Phase 19: full-width ``whisper-tiny`` (4 encoder and 4 decoder
    layers of 384, 439.1 M parameters, 402.7 M of them the learned
    position table; random weights from seed 0) on one card.  (a)
    ``run_easey`` of WHISPER_FULL's serving Appfile to ``nvidia:h100``:
    the build compiles no kernel (a LayerNorm model on the legacy path),
    the job ends ``finished`` with no kernel launched, and a direct
    ``serve_main`` repeats its tokens.  (b) WHISPER_FORCED's prefill and
    teacher-forced decode steps against one longer prefill, within
    WHISPER_FORCED_TOL of max |logit| (``_decode_vs_prefill``; its
    one-step-noise control printed beside it), at the init's zero biases
    and again with every attention bias drawn at WHISPER_BIAS_STD, where
    the reference's cross-attention gap (which the port closes) must
    depart beyond that limit.  (c) WHISPER_TRAIN's steps of ``train_main``:
    every loss and grad norm finite, a second run's step 0 bit for bit
    the first's.  (d) The serving shape's prefill and one decode step on
    the roofline (``_step_roofline``).  Returns the roofline readings."""
    t19 = time.perf_counter()
    mem, mark = _mem_marks(torch)
    mark("before phase 19")
    cfg = m.get_config(WHISPER_FULL["arch"])
    b, n_dec, P = (WHISPER_FULL[k] for k in ("batch", "decode_tokens",
                                             "prefill_len"))
    out_a, build, launches, streams, out_b, easey_s = _legacy_job(
        torch, m, card, counts, reset_counts, quiet, WHISPER_FULL,
        "serve-whisper")
    if build != ("prefill_step", m.build_arch, [], []) or any(
            launches.values()):
        raise AssertionError(f"whisper serving build {build}, launches "
                             f"{launches}: a LayerNorm model on the legacy "
                             f"path builds and launches no kernel")
    mark("EASEY job and direct serve_main")
    print(f"[whisper] {card} run_easey(whisper-tiny serving Appfile, "
          f"nvidia:h100): build {build[2]} (no kernel: LayerNorm, legacy "
          f"path), job finished in {easey_s:.1f} s; "
          f"{cfg.num_encoder_layers} + {cfg.num_layers} layers of "
          f"{cfg.d_model}, {m.param_count_estimate(cfg) / 1e6:.3f} M "
          f"parameters; {b} requests of {P} frames + {P} prompt tokens, "
          f"{n_dec} tokens each; prefill {out_a['prefill_s']:.3f} s, decode "
          f"{out_a['decode_tok_per_s']:.2f} tokens/s EASEY, "
          f"{out_b['decode_tok_per_s']:.2f} direct (the direct serve_main "
          f"repeats the job's {b} x {n_dec} tokens)")

    # (b) decode against the longer prefill, zero and nonzero biases
    model = m.model_for(cfg, remat="none")
    params = m.init_params(model.param_table(),
                           torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
    prefill, decode = m.build_prefill_step(model), m.build_decode_step(model)
    rows, Pf, nf = WHISPER_FORCED
    shape = dataclasses.replace(m.SHAPES["prefill_32k"], seq_len=Pf + nf,
                                global_batch=rows)
    long_req = m.to_device(m.SyntheticSource(cfg.vocab_size, 19).batch(
        model.batch_table(shape), 0), "cuda")
    frames = long_req["frames"][:, :Pf].contiguous()
    forced = {"zero biases": _decode_vs_prefill(
        torch, m, prefill, decode, params, frames, long_req["tokens"], Pf,
        nf)}
    g = torch.Generator(device="cuda").manual_seed(19)
    for stack in ("enc_blocks", "dec_blocks"):
        for attn in ("attn", "xattn"):
            p = params[stack].get(attn)
            for k in ("bq", "bk", "bv") if p else ():
                p[k].copy_(WHISPER_BIAS_STD * torch.randn(
                    p[k].shape, generator=g, device="cuda"))
    forced["nonzero biases"] = _decode_vs_prefill(
        torch, m, prefill, decode, params, frames, long_req["tokens"], Pf,
        nf)
    del long_req, frames
    mark("decode against the longer prefill")
    print(f"[whisper] {card} {rows} rows, prefill of {Pf} frames and tokens "
          f"+ {nf} teacher-forced decode steps against one prefill of "
          f"{Pf + nf} tokens (max |diff| / max |logit| of the last step; "
          f"ctrl: the longer prefill with one bf16 step of noise at the "
          f"decoder's LayerNorm outputs at the decoded positions, at the "
          f"fraction frac of decoded self K/V entries, or of the last "
          f"logits, that differ; gap: the reference's cross-attention, "
          f"without bk and bv in the cached cross K/V and bq in the decode "
          f"query; limit {WHISPER_FORCED_TOL:g}): "
          f"{({k: {kk: round(vv, 6) if isinstance(vv, float) else vv for kk, vv in v.items()} for k, v in forced.items()})}")
    for label, f in forced.items():
        if not f["finite"] or f["rel"] > WHISPER_FORCED_TOL:
            raise AssertionError(f"whisper decode vs the longer prefill "
                                 f"({label}): {f['rel']:.4g} of max |logit| "
                                 f"> {WHISPER_FORCED_TOL:g} (finite "
                                 f"{f['finite']})")
    if forced["nonzero biases"]["gap"] <= WHISPER_FORCED_TOL:
        raise AssertionError(f"whisper: the reference's cross-attention gap "
                             f"departs {forced['nonzero biases']['gap']:.4g}"
                             f" of max |logit|, within the limit "
                             f"{WHISPER_FORCED_TOL:g}: the check could not "
                             f"tell it")

    # (d) the serving shape's steps on the roofline
    pshape = dataclasses.replace(m.SHAPES["prefill_32k"], seq_len=P,
                                 global_batch=b)
    req = m.to_device(m.SyntheticSource(cfg.vocab_size, 0).batch(
        model.batch_table(pshape), 0), "cuda")
    roof = {"prefill": _step_roofline(
        torch, m, card, f"whisper-tiny prefill ({b} x {P} frames + tokens)",
        cfg, pshape, prefill, params, req)}
    logits, cache = prefill(params, req)
    cache = m.grow_kv(cache, 1)
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    dshape = dataclasses.replace(m.SHAPES["decode_32k"], seq_len=P + 1,
                                 global_batch=b)
    roof["decode"] = _step_roofline(
        torch, m, card, f"whisper-tiny whole-batch decode step ({b} rows "
        f"at {P} of {P + 1} positions)", cfg, dshape, decode, params,
        cache, tok)
    del params, model, req, logits, cache, prefill, decode
    mark("roofline")

    # (c) training
    res = m.train_main(**WHISPER_TRAIN, log=quiet)
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses, norms = res["losses"], res["grad_norms"]
    plan, step_s = res["plan"], res["step_s"]
    del res
    mark("train_main")
    again = m.train_main(**dict(WHISPER_TRAIN, steps=1), log=quiet)
    if not (all(map(math.isfinite, losses + norms)) and
            len(losses) == WHISPER_TRAIN["steps"]):
        raise AssertionError(f"whisper training: losses {losses}, grad "
                             f"norms {norms}")
    if (again["losses"][0], again["grad_norms"][0]) != (losses[0], norms[0]):
        raise AssertionError(f"whisper training: a second run's step 0 "
                             f"({again['losses'][0]}, "
                             f"{again['grad_norms'][0]}) != the first's "
                             f"({losses[0]}, {norms[0]})")
    del again
    mark("a second run's step 0")
    tokens = WHISPER_TRAIN["seq_len"] * WHISPER_TRAIN["global_batch"]
    t19 = time.perf_counter() - t19
    print(f"[whisper] {card} train_main(whisper-tiny, "
          f"{WHISPER_TRAIN['global_batch']} x {WHISPER_TRAIN['seq_len']} "
          f"frames + tokens, {WHISPER_TRAIN['steps']} steps; plan "
          f"{plan.optimizer}, remat {plan.remat_policy}, "
          f"{plan.microbatches} microbatch(es)): losses {losses}, grad norms "
          f"{norms}, all finite; a second run repeats step 0 bit for bit; "
          f"ms per step {[round(t * 1e3, 1) for t in step_s]} (host clock, "
          f"device drained), {tokens / (sum(step_s[1:]) / max(len(step_s) - 1, 1)):.1f}"
          f" tokens/s after step 0; peak memory {peak:.1f} GB; phase 19 "
          f"took {t19:.1f} s; memory (GB allocated after, peak during) "
          f"{mem}")
    return roof


# phase 23: the instantiations each launcher can pick, as (kernel,
# bounds of the lint's [smem.bounds] they take, the query's arguments)
SMEM_CASES = {
    "flash_attention": [
        (kernel, {"DP": dp}, (bf16, dp))
        for dp in (16, 32, 64, 128, 192, 256)
        for bf16, kernel in ((0, "flash_fwd_kernel"), (1, "flash_fwd_tc"))],
    "paged_attention": [
        (kernel, {"G": g, "dh": dh}, (pv, g, dh))
        for g in range(1, 9) for dh in (128, 256)
        for pv, kernel in ((0, "paged_scores_kernel"),
                           (1, "paged_pv_kernel"))],
    "rmsnorm": [("norm_kernel", {}, (f32, nv))
                for f32 in (0, 1) for nv in (1, 2, 4, 8)],
    "sedov_stencil": [("sedov_step_kernel", {}, (vec, pow2))
                      for vec in (0, 1) for pow2 in (0, 1)],
}
# phase 23: decode tokens of the full-width serve_batch example, and
# train_100m's steps and injected failure: it checkpoints every 25 steps,
# so it fails right after the step-25 checkpoint and must restore it
# (steps cut from 30 / 27 to keep the phase near 40 s: a step of the 100M
# model takes ~0.5 s on the card)
EXAMPLE_DECODE = 8
EXAMPLE_TRAIN = dict(steps=26, fail_at=25)


def _smem_card(torch, _build, card) -> None:
    """Phase 23 (a): the lint's ``smem-budget`` figure of every
    instantiation in SMEM_CASES against the card's (the compiled static
    bytes and the dynamic bytes the launcher asks for, through each
    source's ``<name>_smem`` query), every pair printed; raises where
    the rule's figure is below the card's, or the budget is not the
    card's opt-in limit."""
    import ctypes
    from repro_torch.analysis.lint import default_config
    from repro_torch.analysis.lint.rules import smem_budget
    from repro_torch.core.target import get_target
    cfg = default_config()
    budget = get_target(cfg.smem_target).smem_bytes
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    if budget != optin:
        raise AssertionError(f"the lint's budget {budget} B is not the "
                             f"card's opt-in limit {optin} B a block")
    out: dict = {}
    for name, cases in SMEM_CASES.items():
        text = (_build.CSRC / f"{name}.cu").read_text()
        query = getattr(_build.load(name), f"{name}_smem")
        nargs = len(cases[0][2])
        query.argtypes = [ctypes.c_int] * nargs + \
            [ctypes.POINTER(ctypes.c_int)] * 2
        query.restype = ctypes.c_int
        for kernel, bounds, args in cases:
            rule = {k.name: k for k in smem_budget.reckon(
                text, {**cfg.smem_bounds, **bounds})}[kernel]
            if rule.total is None:
                raise AssertionError(f"smem-budget cannot size {kernel} "
                                     f"at {bounds}: {rule.problems}")
            st, dyn = ctypes.c_int(-1), ctypes.c_int(-1)
            rc = query(*args, ctypes.byref(st), ctypes.byref(dyn))
            if rc != 0:
                raise RuntimeError(f"{name}_smem{args}: CUDA error {rc}")
            if rule.static < st.value or rule.dynamic < dyn.value:
                raise AssertionError(
                    f"smem-budget under the card: {kernel} at {bounds} "
                    f"reckons {rule.static} + {rule.dynamic} B, the card "
                    f"{st.value} static + {dyn.value} dynamic")
            if st.value + dyn.value > optin:
                raise AssertionError(f"{kernel} at {bounds} asks for "
                                     f"more than {optin} B a block")
            out.setdefault(kernel, []).append(
                (bounds, rule.static, rule.dynamic, st.value, dyn.value))
    for kernel, rows in out.items():
        pairs = "; ".join(
            f"{','.join(f'{k}={v}' for k, v in b.items()) or '-'}: "
            f"{rs}/{cs} + {rd}/{cd}"
            + ("" if (rs, rd) == (cs, cd) else " (differ)")
            for b, rs, rd, cs, cd in rows)
        print(f"[smem] {card} {kernel}, rule/card static + rule/launcher "
              f"dynamic B: {pairs}")
    equal = sum((rs, rd) == (cs, cd) for rows in out.values()
                for _, rs, rd, cs, cd in rows)
    total = sum(len(rows) for rows in out.values())
    print(f"[smem] {card} {total} instantiations: the rule's figure at or "
          f"above the card's in all, equal in {equal}; budget {budget} B = "
          f"the card's opt-in limit")


def _lint_port():
    """Start ``python -m repro_torch.analysis.lint src/repro_torch`` in a
    process of its own (host only; it runs beside phase 23's card work);
    returns a function that waits for it, raises unless it exited 0, and
    returns its report."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.analysis.lint", "src/repro_torch"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)

    def wait() -> str:
        try:
            out = proc.communicate(timeout=300)[0]
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if proc.returncode != 0:
            raise AssertionError(f"the port's lint failed (rc "
                                 f"{proc.returncode}):\n{out[-4000:]}")
        return out
    return wait


def _examples_card(torch, card, counts, reset_counts) -> dict:
    """Phase 23 (b): the four example twins on the card, each through its
    ``main`` with the arguments a user would give, its stdout captured
    and its last lines printed; returns each one's kernel launches."""
    import io
    from repro_torch.examples import (lulesh_easey, quickstart, serve_batch,
                                      train_100m)
    runs = {
        "quickstart": (quickstart, []),
        "serve_batch": (serve_batch, ["--arch", "deepseek-7b",
                                      "--kv-layout", "paged", "--decode",
                                      str(EXAMPLE_DECODE)]),
        "train_100m": (train_100m, [
            "--steps", str(EXAMPLE_TRAIN["steps"]),
            "--fail-at", str(EXAMPLE_TRAIN["fail_at"])]),
        "lulesh_easey": (lulesh_easey, []),
    }
    launches, outs, logs = {}, {}, {}
    for name, (mod, argv) in runs.items():
        gc.collect()
        torch.cuda.empty_cache()
        reset_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            outs[name], secs = _timed(mod.main, argv)
        torch.cuda.synchronize()
        launches[name] = counts()
        logs[name] = buf.getvalue()
        tail = [ln for ln in logs[name].splitlines() if ln.strip()]
        keep = {"quickstart": tail[:1], "serve_batch": tail[-1:],
                "train_100m": tail[-2:], "lulesh_easey": tail[:4]}[name]
        for ln in keep:
            print(f"[example] {card} {name}: {ln}")
        if name == "train_100m":
            print(f"[example] {card} train_100m: its {len(outs[name]['step_s'])}"
                  f" steps {sum(outs[name]['step_s']):.1f} s (the first "
                  f"{outs[name]['step_s'][0]:.2f} s)")
        k = launches[name]
        print(f"[example] {card} {name} {' '.join(argv) or '(no arguments)'}"
              f": {secs:.1f} s; launches K1 {k['paged_attention']}, K2 "
              f"{k['rmsnorm']} + {k['add_rmsnorm']} fused, K4 "
              f"{k['sedov_stencil']}")
    mw, jid, build = outs["quickstart"]
    res = mw.scheduler.result(jid)[0]
    if mw.status(jid).value != "finished" or build.plan.kernels != "cuda" \
            or not math.isfinite(res["final_loss"]) or \
            launches["quickstart"]["add_rmsnorm"] == 0:
        raise AssertionError(f"quickstart: job {mw.status(jid).value}, "
                             f"kernels {build.plan.kernels}, loss "
                             f"{res['final_loss']}, {launches['quickstart']}")
    sv, k = outs["serve_batch"], launches["serve_batch"]
    if not (k["paged_attention"] and k["rmsnorm"] and k["add_rmsnorm"]) or \
            len(sv["sample"]) != min(8, EXAMPLE_DECODE) or \
            not sv["decode_tok_per_s"] > 0:
        raise AssertionError(f"serve_batch at full width: {k}, sample "
                             f"{sv['sample']}")
    tr, k = outs["train_100m"], launches["train_100m"]
    restored = "[train] restored checkpoint step 24" in logs["train_100m"]
    if (tr["steps"], tr["restarts"]) != (EXAMPLE_TRAIN["steps"], 1) or \
            not restored or k["rmsnorm"] or k["add_rmsnorm"] or \
            not all(map(math.isfinite, tr["losses"])):
        raise AssertionError(f"train_100m: {tr['steps']} steps, "
                             f"{tr['restarts']} restarts, restored from "
                             f"the step-25 checkpoint: {restored}, {k}")
    rows, _ = outs["lulesh_easey"]
    # per grid: 2 warm-up + iters native, iters in each of 2 EASEY jobs
    want = sum(2 + 3 * iters for _, iters in lulesh_easey.GRIDS)
    if launches["lulesh_easey"]["sedov_stencil"] != want or not all(
            nat > 0 and eas > 0 for _, nat, eas in rows):
        raise AssertionError(f"lulesh_easey: {launches['lulesh_easey']}, "
                             f"want {want} K4 launches; FOMs {rows}")
    print(f"[example] {card} train_100m (gpt2s-100m, LayerNorm): no K2 on "
          f"its path; quickstart's deepseek-7b-smoke and serve_batch's "
          f"deepseek-7b have RMSNorms: K2 on every norm")
    return launches


def _k2_per_step(plan, layers: int) -> dict:
    """K2's launches in one microbatch's training step of a dense or MoE
    model: layer 0's first norm and the fused add + norms in the forward,
    all but ``ln_f`` again in the remat recompute."""
    rec = int(plan.remat_policy != "none")
    return {"rmsnorm": 1 + rec, "add_rmsnorm": 2 * layers + rec *
            (2 * layers - 1)}


def _dense_nccl(torch, m, mesh, card, counts, reset_counts) -> dict:
    """Phase 24 (a): TRAIN_NCCL_DENSE's model through the mesh step and
    the off-mesh step, side by side from the same state: bit for bit."""
    full = m.get_config(TRAIN_NCCL_DENSE["arch"])
    cfg = full.replace(num_layers=TRAIN_NCCL_DENSE["layers"])
    shape = dataclasses.replace(
        m.SHAPES["train_4k"], seq_len=TRAIN_NCCL_DENSE["seq_len"],
        global_batch=TRAIN_NCCL_DENSE["global_batch"])
    plan = m.tune(full, shape, m.get_target("nvidia:h100"))
    model = m.model_for(cfg, remat=plan.remat_policy)
    opt = m.make_optimizer(plan.optimizer)
    params = m.init_params(model.param_table(),
                           torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
    state = m.init_train_state(model, opt, params, plan)
    off = m.tree_map(lambda t: t.clone(), state)
    # the DTensors hold the state's own tensors on the one rank
    on = m.reshard_state(state, m.train_state_table(model, opt, plan), mesh)
    del state, params
    off_step = m.build_train_step(model, opt, plan)
    on_step = m.build_train_step(model, opt, plan, mesh)
    pipe = m.DataPipeline(model, shape, seed=0, device="cuda")
    want = _k2_per_step(plan, cfg.num_layers)
    losses = []
    for i in range(TRAIN_NCCL_DENSE["steps"]):
        batch = pipe.batch_at(i)
        reset_counts()
        off, mo = off_step(off, batch)
        torch.cuda.synchronize()
        got_off = {k: v for k, v in counts().items() if v}
        reset_counts()
        on, mn = on_step(on, batch)
        torch.cuda.synchronize()
        got_on = {k: v for k, v in counts().items() if v}
        lo, ln = float(mo["loss"]), float(mn["loss"])
        if lo != ln or got_off != got_on or got_on != want:
            raise AssertionError(f"phase 24 deepseek-7b step {i}: loss off "
                                 f"the mesh {lo}, on it {ln}; K2 {got_off} "
                                 f"/ {got_on}, predicted {want}")
        if any(c["calls"] for c in mn["collectives"].values()):
            raise AssertionError(f"phase 24: one rank sent collectives "
                                 f"{mn['collectives']}")
        losses.append(ln)
    leaves = 0
    for (path, a), (_, b) in zip(m.leaf_items(off), m.leaf_items(on)):
        if not torch.equal(a, b.to_local()):
            raise AssertionError(f"phase 24 deepseek-7b: {'/'.join(path)} "
                                 f"differs on the mesh from off it")
        leaves += 1
    del off, on
    print(f"[train-mesh] {card} deepseek-7b ({cfg.num_layers} of "
          f"{full.num_layers} layers, d {cfg.d_model}, vocab "
          f"{cfg.vocab_size}), {TRAIN_NCCL_DENSE['steps']} steps of "
          f"{shape.global_batch} x {shape.seq_len} (plan {plan.optimizer}, "
          f"remat {plan.remat_policy}, {plan.microbatches} microbatch) "
          f"through the split mesh step on a one-rank NCCL mesh and off "
          f"the mesh: losses {losses} equal, all {leaves} leaves equal bit "
          f"for bit, K2 per step {want} on both, no collective sent")
    return want


def _moe_nccl(torch, m, mesh, card, counts, reset_counts) -> dict:
    """Phase 24 (b) and (c): full-width granite-moe-3b-a800m through the
    mesh step's split, held to phase 15's gates; then its steps and the
    restart from disk."""
    import shutil
    full = m.get_config(TRAIN_NCCL_MOE["arch"])
    # full width, TRAIN_NCCL_MOE's depth (cut from its 32 layers: the
    # restart's archive and step halved to keep the script inside its
    # limit on a slow host)
    cfg = full.replace(num_layers=TRAIN_NCCL_MOE["layers"])
    shape = dataclasses.replace(
        m.SHAPES["train_4k"], seq_len=TRAIN_NCCL_MOE["seq_len"],
        global_batch=TRAIN_NCCL_MOE["global_batch"])
    # the tuner's plan for the full config with 8-bit moments: its f32
    # moments would make the restart's archive 33.7 GB at full depth
    plan = dataclasses.replace(m.tune(full, shape, m.get_target(
        "nvidia:h100")), optimizer=TRAIN_NCCL_MOE["optimizer"])
    model = m.model_for(cfg, remat=plan.remat_policy)
    opt = m.make_optimizer(plan.optimizer)
    params = m.init_params(model.param_table(),
                           torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
    _fan_in_draw(m, params)
    pipe = m.DataPipeline(model, shape, seed=0, device="cuda")
    batch = pipe.batch_at(0)

    def counted():
        got = counts()
        reset_counts()
        return got
    # step 0 on the kernel path under the mesh step's split
    model.tp = m.steps.split_for(mesh, params)
    try:
        loss_k, tok_k, g_k, (fwd, rec) = _step0(torch, m, model, params,
                                                batch, counted=counted)
    finally:
        model.tp = None
    loss_p, tok_p, g_p, _ = _step0(torch, m, model, params, batch,
                                   plain=True)
    err_k = _grad_errs(torch, g_k, g_p)
    del g_k
    loss_c, tok_c, g_c, _ = _step0(torch, m, model, params, batch,
                                   plain=True, rounded=True)
    err_c = _grad_errs(torch, g_c, g_p)
    del g_c, g_p
    tok = (_rel_l2(torch, tok_k, tok_p), _rel_l2(torch, tok_c, tok_p))
    bias = (_bias_se(torch, tok_k, tok_p), _bias_se(torch, tok_c, tok_p))
    per_step = _k2_per_step(plan, cfg.num_layers)
    got0 = {k: fwd.get(k, 0) + rec.get(k, 0) for k in per_step}
    print(f"[train-mesh] {card} granite-moe-3b-a800m ({cfg.num_layers} of "
          f"{full.num_layers} layers, {cfg.num_experts} experts top-{cfg.experts_per_token}, "
          f"d {cfg.d_model}, {m.param_count_estimate(cfg) / 1e9:.3f} B "
          f"parameters, block weights at their layers' fan-in) step 0 at "
          f"{shape.global_batch} x {shape.seq_len} under the mesh step's "
          f"split: K2 {got0} (predicted {per_step}); loss kernel "
          f"{loss_k:.6f}, plain {loss_p:.6f}, control {loss_c:.6f}; "
          f"per-token losses rel L2 vs plain, kernel {tok[0]:.4g}, control "
          f"{tok[1]:.4g}; mean difference kernel {bias[0]['mean']:.4g} "
          f"({bias[0]['z']:.3f} standard errors), control "
          f"{bias[1]['mean']:.4g} ({bias[1]['z']:.3f}); per-leaf gradient "
          f"rel L2 vs plain, kernel "
          f"{({k: round(v, 6) for k, v in err_k.items()})}, control "
          f"{({k: round(v, 6) for k, v in err_c.items()})}")
    if got0 != per_step:
        raise AssertionError(f"phase 24 granite step 0: K2 {got0}, not "
                             f"{per_step}")
    _hold_grads("granite-moe-3b-a800m step 0", *tok, err_k, err_c)
    _hold_bias("granite-moe-3b-a800m step 0", *bias)

    # the mesh step's steps, then a save, a failure and the restore
    table = m.train_state_table(model, opt, plan)
    state = m.reshard_state(m.init_train_state(model, opt, params, plan),
                            table, mesh)
    del params
    step = m.build_train_step(model, opt, plan, mesh)
    losses = []
    for i in range(TRAIN_NCCL_MOE["steps"]):
        reset_counts()
        state, metrics = step(state, pipe.batch_at(i))
        torch.cuda.synchronize()
        got = {k: v for k, v in counts().items() if v}
        if got != per_step or not math.isfinite(float(metrics["loss"])):
            raise AssertionError(f"phase 24 granite step {i}: K2 {got} "
                                 f"(predicted {per_step}), loss "
                                 f"{float(metrics['loss'])}")
        losses.append(float(metrics["loss"]))
    at = TRAIN_NCCL_MOE["steps"] - 1
    shutil.rmtree(CKPT_SMOKE, ignore_errors=True)
    try:
        ckpt = m.Checkpointer(CKPT_SMOKE, keep=1, async_writes=True,
                              mesh=mesh)
        t0 = time.perf_counter()
        ckpt.save(at, state)
        snap_s = time.perf_counter() - t0
        latest = ckpt.latest_step()
        save_s = time.perf_counter() - t0
        size = sum(f.stat().st_size for f in CKPT_SMOKE.rglob("*")
                   if f.is_file())
        try:
            m.FailureInjector(fail_at_steps=(at + 1,)).check(at + 1)
            raise AssertionError("phase 24: the injected failure did not "
                                 "fire")
        except m.SimulatedFailure:
            pass
        fresh = m.init_params(model.param_table(),
                              torch.Generator(device="cuda").manual_seed(1),
                              "cuda")
        template = m.reshard_state(m.init_train_state(model, opt, fresh,
                                                      plan), table, mesh)
        del fresh
        t0 = time.perf_counter()
        restored, got_at = ckpt.restore(template)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        del template
    finally:
        shutil.rmtree(CKPT_SMOKE, ignore_errors=True)
    if latest != at or got_at != at:
        raise AssertionError(f"phase 24: latest step {latest}, restored "
                             f"{got_at}, saved {at}")
    nxt = pipe.batch_at(at + 1)
    reset_counts()
    state, m_u = step(state, nxt)
    restored, m_r = step(restored, nxt)
    torch.cuda.synchronize()
    leaves = 0
    for (path, a), (_, b) in zip(m.leaf_items(state),
                                 m.leaf_items(restored)):
        if not torch.equal(a.to_local(), b.to_local()):
            raise AssertionError(f"phase 24 restart: {'/'.join(path)} "
                                 f"differs from the unbroken run's")
        leaves += 1
    if float(m_u["loss"]) != float(m_r["loss"]):
        raise AssertionError("phase 24 restart: the losses differ")
    del state, restored
    print(f"[train-mesh] {card} granite-moe-3b-a800m: "
          f"{TRAIN_NCCL_MOE['steps']} steps of the mesh step (plan "
          f"{plan.optimizer}, remat {plan.remat_policy}, "
          f"{plan.microbatches} microbatch), losses {losses}, K2 per step "
          f"{per_step}; restart from disk: the state after step {at} saved "
          f"through Checkpointer(mesh=) ({size / 1e9:.2f} GB; host snapshot "
          f"{snap_s:.2f} s, written by {save_s:.2f} s), an injected failure, "
          f"restored onto the mesh in {restore_s:.2f} s, one more step each: "
          f"all {leaves} leaves and the loss {float(m_u['loss'])} equal the "
          f"unbroken run's bit for bit")
    return per_step


def _fan_in_recurrent(m, model, params) -> None:
    """``_fan_in_draw`` for a recurrent model's stacks (their one or two
    layer axes: ``sharding.split.layer_axes``): every stacked matrix drawn
    by ``init_params``' law at its own layer's fan-in, the axis its
    product contracts (an mLSTM's per-head projections contract their
    second axis, the rest their first)."""
    from repro_torch.sharding.split import layer_axes
    for (path, d), (_, w) in zip(m.leaf_items(model.param_table()),
                                 m.leaf_items(params)):
        lead = layer_axes(path)
        if not lead or d.init != "normal" or d.scale is not None or \
                w.dim() - lead < 2:
            continue
        fan_in = w.shape[lead + (1 if path[0] == "mlstm" and path[-1] in
                                 ("wq", "wk", "wv") else 0)]
        w.mul_(math.sqrt(w.shape[0] / fan_in))


def _k2_per_step_hybrid(plan, cfg) -> dict:
    """K2's launches in one training step of a Zamba2 hybrid: each Mamba2
    layer's input norm and gated norm, each shared application's first
    norm, ``ln_f`` and each shared application's fused add + norm in the
    forward; the Mamba2 layers' again in the remat recompute (the shared
    block runs outside it)."""
    apps = cfg.num_layers // cfg.shared_attn_period
    rec = int(plan.remat_policy != "none")
    return {"rmsnorm": plan.microbatches * (
        2 * cfg.num_layers * (1 + rec) + apps + 1),
            "add_rmsnorm": plan.microbatches * apps}


def _fingerprint(torch, state) -> list:
    """Each leaf's bits summed as integers, plain and weighted by position
    (two exact integer sums: equal bits give equal sums; the state's
    other copy need not stay on the card)."""
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32}
    out = []
    for t in (state if isinstance(state, list) else [state]):
        v = t.contiguous().view(-1).view(ints[t.element_size()])
        plain = weighted = 0
        for a in range(0, v.numel(), 1 << 26):     # 512 MB of int64 a piece
            piece = v[a:a + (1 << 26)].long()
            w = torch.arange(a, a + piece.numel(), device=v.device) \
                % 65521 + 1
            plain += int(piece.sum())
            weighted += int((piece * w).sum())
        out.append((plain, weighted))
    return out


def _hybrid_nccl(torch, m, mesh, card, counts, reset_counts) -> dict:
    """Phase 24 (d): full-width zamba2-7b through the split train step on
    a one-rank NCCL mesh: step 0 under the mesh step's split held to
    phase 15's gates against the plain path and the control (block
    weights at their layers' fan-in); then TRAIN_NCCL_HYBRID's steps off
    the mesh and on it from the same state, bit for bit (losses, K2
    launches, every leaf's bits), K2 counted per step.  Returns K2's
    launches per step."""
    t24d = time.perf_counter()
    kw = TRAIN_NCCL_HYBRID
    cfg = m.get_config(kw["arch"])
    shape = dataclasses.replace(m.SHAPES["train_4k"], seq_len=kw["seq_len"],
                                global_batch=kw["global_batch"])
    plan = m.tune(cfg, shape, m.get_target("nvidia:h100"))
    model = m.model_for(cfg, remat=plan.remat_policy)
    opt = m.make_optimizer(plan.optimizer)

    def draw():
        params = m.init_params(model.param_table(), torch.Generator(
            device="cuda").manual_seed(0), "cuda")
        _fan_in_recurrent(m, model, params)
        return params
    params = draw()
    pipe = m.DataPipeline(model, shape, seed=0, device="cuda")
    batch = pipe.batch_at(0)

    def counted():
        got = counts()
        reset_counts()
        return got
    t0 = time.perf_counter()
    model.tp = m.steps.split_for(mesh, params)
    try:
        loss_k, tok_k, g_k, (fwd, rec) = _step0(torch, m, model, params,
                                                batch, counted=counted)
    finally:
        model.tp = None
    loss_p, tok_p, g_p, _ = _step0(torch, m, model, params, batch,
                                   plain=True)
    err_k = _grad_errs(torch, g_k, g_p)
    del g_k
    loss_c, tok_c, g_c, _ = _step0(torch, m, model, params, batch,
                                   plain=True, rounded=True)
    err_c = _grad_errs(torch, g_c, g_p)
    del g_c, g_p
    gates_s = time.perf_counter() - t0
    tok = (_rel_l2(torch, tok_k, tok_p), _rel_l2(torch, tok_c, tok_p))
    bias = (_bias_se(torch, tok_k, tok_p), _bias_se(torch, tok_c, tok_p))
    per_step = _k2_per_step_hybrid(plan, cfg)
    got0 = {k: fwd.get(k, 0) + rec.get(k, 0) for k in per_step}
    worst_k = max(err_k, key=err_k.get)
    worst_c = max(err_c, key=err_c.get)
    print(f"[train-mesh] {card} zamba2-7b ({cfg.num_layers} Mamba2 layers, "
          f"{cfg.num_layers // cfg.shared_attn_period} shared applications, "
          f"d {cfg.d_model}, {m.param_count_estimate(cfg) / 1e9:.3f} B "
          f"parameters, stacked weights at their layers' fan-in) step 0 "
          f"at {shape.global_batch} x {shape.seq_len} under the mesh step's "
          f"split: K2 {got0} (predicted {per_step}); loss kernel "
          f"{loss_k:.6f}, plain {loss_p:.6f}, control {loss_c:.6f}; "
          f"per-token losses rel L2 vs plain, kernel {tok[0]:.4g}, control "
          f"{tok[1]:.4g}; mean difference kernel {bias[0]['mean']:.4g} "
          f"({bias[0]['z']:.3f} standard errors), control "
          f"{bias[1]['mean']:.4g} ({bias[1]['z']:.3f}); per-leaf gradient "
          f"rel L2 vs plain, kernel worst {worst_k} {err_k[worst_k]:.4g}, "
          f"control worst {worst_c} {err_c[worst_c]:.4g} (all "
          f"{ {k: (round(err_k[k], 5), round(err_c[k], 5)) for k in err_k} }"
          f"); the three step-0 passes {gates_s:.1f} s")
    if got0 != per_step:
        raise AssertionError(f"phase 24 zamba2-7b step 0: K2 {got0}, not "
                             f"{per_step}")
    _hold_grads("zamba2-7b step 0", *tok, err_k, err_c)
    _hold_bias("zamba2-7b step 0", *bias)

    # the steps off the mesh, then on it from the same state: one state on
    # the card at a time, each run's losses, launches and bits kept
    table = m.train_state_table(model, opt, plan)
    runs = []
    for on in (False, True):
        if params is None:
            params = draw()
        state = m.init_train_state(model, opt, params, plan)
        params = None
        if on:
            state = m.reshard_state(state, table, mesh)
        step = m.build_train_step(model, opt, plan, mesh if on else None)
        losses, k2, comm = [], [], []
        t0 = time.perf_counter()
        for i in range(kw["steps"]):
            reset_counts()
            state, metrics = step(state, pipe.batch_at(i))
            torch.cuda.synchronize()
            k2.append({k: v for k, v in counts().items() if v})
            losses.append(float(metrics["loss"]))
            comm.append(sum(c["calls"] for c in
                            metrics["collectives"].values()))
        secs = time.perf_counter() - t0
        local = m.tree_map(lambda t: t.to_local() if on else t, state)
        bits = [(p, _fingerprint(torch, t)) for p, t in m.leaf_items(local)]
        runs.append({"losses": losses, "k2": k2, "bits": bits, "s": secs,
                     "comm": comm})
        del state, local, step
        gc.collect()
        torch.cuda.empty_cache()
    off, on = runs
    want = {k: v for k, v in per_step.items() if v}
    if off["losses"] != on["losses"] or off["k2"] != on["k2"] or \
            any(k != want for k in on["k2"]) or off["bits"] != on["bits"] \
            or any(on["comm"]) or not all(map(math.isfinite,
                                              on["losses"])):
        raise AssertionError(f"phase 24 zamba2-7b: off the mesh losses "
                             f"{off['losses']}, K2 {off['k2']}; on it "
                             f"{on['losses']}, K2 {on['k2']} (predicted "
                             f"{want}), collectives {on['comm']}, every "
                             f"leaf's bits equal: {off['bits'] == on['bits']}")
    print(f"[train-mesh] {card} zamba2-7b: {kw['steps']} steps of "
          f"{shape.global_batch} x {shape.seq_len} (plan {plan.optimizer}, "
          f"remat {plan.remat_policy}, {plan.microbatches} microbatch) off "
          f"the mesh and through the split step on a one-rank NCCL mesh "
          f"from the same state: losses {on['losses']} equal, all "
          f"{len(on['bits'])} leaves equal bit for bit, K2 per step {want} "
          f"on both, no collective sent; {off['s']:.2f} / {on['s']:.2f} s "
          f"for the steps (off / on, host clock); phase 24 (d) took "
          f"{time.perf_counter() - t24d:.1f} s")
    return per_step


def _whisper_nccl(torch, m, mesh, card, counts, reset_counts) -> None:
    """Phase 24 (e): full-width whisper-tiny through the split steps on a
    one-rank NCCL mesh (``training/steps.py``, checked by name), each
    against the same work off the mesh: WHISPER_NCCL's train steps from
    the same state (the losses and every leaf's bits equal), then the
    legacy path's prefill and decode steps through ``legacy_generate``
    (every row's tokens equal).  No kernel runs: a LayerNorm model."""
    t24e = time.perf_counter()
    kw = WHISPER_NCCL
    cfg = m.get_config(kw["arch"])
    shape = dataclasses.replace(m.SHAPES["train_4k"], seq_len=kw["seq_len"],
                                global_batch=kw["global_batch"])
    plan = m.tune(cfg, shape, m.get_target("nvidia:h100"))
    model = m.model_for(cfg, remat=plan.remat_policy)
    opt = m.make_optimizer(plan.optimizer)
    pipe = m.DataPipeline(model, shape, seed=0, device="cuda")
    table = m.train_state_table(model, opt, plan)

    def draw():
        return m.init_params(model.param_table(), torch.Generator(
            device="cuda").manual_seed(0), "cuda")
    runs = []
    for on in (False, True):
        state = m.init_train_state(model, opt, draw(), plan)
        if on:
            state = m.reshard_state(state, table, mesh)
        step = m.build_train_step(model, opt, plan, mesh if on else None)
        if on and "_split_step" not in step.__qualname__:
            raise AssertionError(f"whisper-tiny's train step on the mesh is "
                                 f"not the split step ({step.__qualname__})")
        losses = []
        reset_counts()
        t0 = time.perf_counter()
        for i in range(kw["steps"]):
            state, metrics = step(state, pipe.batch_at(i))
            losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        local = m.tree_map(lambda t: t.to_local() if on else t, state)
        bits = [(p, _fingerprint(torch, t)) for p, t in m.leaf_items(local)]
        runs.append({"losses": losses, "bits": bits, "s": secs,
                     "launches": {k: v for k, v in counts().items() if v}})
        del state, local, step
        gc.collect()
        torch.cuda.empty_cache()
    off, on = runs
    if off["losses"] != on["losses"] or off["bits"] != on["bits"] or \
            on["launches"] or not all(map(math.isfinite, on["losses"])):
        raise AssertionError(f"phase 24 whisper-tiny: off the mesh losses "
                             f"{off['losses']}, on it {on['losses']}, every "
                             f"leaf's bits equal: {off['bits'] == on['bits']}"
                             f", launches {on['launches']}")
    train_s = time.perf_counter() - t24e

    # the legacy path's split prefill and decode steps
    model = m.model_for(cfg, remat="none")
    params = draw()
    pshape = dataclasses.replace(m.SHAPES["prefill_32k"],
                                 seq_len=kw["prefill_len"],
                                 global_batch=kw["batch"])
    req = m.to_device(m.SyntheticSource(cfg.vocab_size, 0).batch(
        model.batch_table(pshape), 0), "cuda")
    on_params = m.reshard_state(params, model.param_table(), mesh)
    dev = torch.device("cuda")
    legacy = []
    for mesh_ in (None, mesh):
        steps = (m.build_prefill_step(model, mesh_),
                 m.build_decode_step(model, mesh_))
        if mesh_ is not None and not all(
                "_split_" in f.__qualname__ for f in steps):
            raise AssertionError(f"whisper-tiny on the mesh: not the split "
                                 f"steps ({steps})")
        legacy.append(m.legacy_generate(
            *steps, params if mesh_ is None else on_params, req,
            kw["decode_tokens"], dev))
    (toks_off, pre_off, dec_off), (toks_on, pre_on, dec_on) = legacy
    if toks_on.tolist() != toks_off.tolist():
        raise AssertionError(f"whisper-tiny's legacy path on the one-rank "
                             f"mesh: tokens {toks_on.tolist()} vs "
                             f"{toks_off.tolist()}")
    del params, on_params, req, model, legacy
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[train-mesh] {card} whisper-tiny ({cfg.num_encoder_layers} + "
          f"{cfg.num_layers} layers of {cfg.d_model}, "
          f"{m.param_count_estimate(cfg) / 1e6:.1f} M parameters): "
          f"{kw['steps']} steps of {shape.global_batch} x {shape.seq_len} "
          f"frames + tokens (plan {plan.optimizer}, remat "
          f"{plan.remat_policy}, {plan.microbatches} microbatch) off the "
          f"mesh and through the split step on a one-rank NCCL mesh from "
          f"the same state: losses {on['losses']} equal, all "
          f"{len(on['bits'])} leaves equal bit for bit, no kernel launched; "
          f"{off['s']:.2f} / {on['s']:.2f} s for the steps (off / on, host "
          f"clock); the legacy path {kw['batch']} x {kw['prefill_len']} + "
          f"{kw['decode_tokens']} off the mesh and through the split "
          f"prefill and decode steps on it: every row's tokens equal; "
          f"prefill {pre_off:.3f} / {pre_on:.3f} s, decode {dec_off:.3f} / "
          f"{dec_on:.3f} s (off / on); training {train_s:.1f} s, phase 24 "
          f"(e) took {time.perf_counter() - t24e:.1f} s")


def _train_nccl(torch, m, card, counts, reset_counts) -> dict:
    """Phase 24: the split train step on a one-rank NCCL mesh (see the
    module's docstring); returns K2's launches per step of each run."""
    import torch.distributed as dist
    t24 = time.perf_counter()
    mem24, mark24 = _mem_marks(torch)
    mark24("before phase 24")
    mesh = _nccl_mesh(torch, m)
    try:
        dense = _dense_nccl(torch, m, mesh, card, counts, reset_counts)
        mark24("deepseek-7b on and off the mesh")
        moe_k2 = _moe_nccl(torch, m, mesh, card, counts, reset_counts)
        mark24("granite-moe-3b-a800m, its steps and its restart")
        gc.collect()
        torch.cuda.empty_cache()
        hybrid_k2 = _hybrid_nccl(torch, m, mesh, card, counts, reset_counts)
        mark24("zamba2-7b, step 0's gates and its steps off and on")
        _whisper_nccl(torch, m, mesh, card, counts, reset_counts)
        mark24("whisper-tiny, its steps and its legacy path off and on")
    finally:
        dist.destroy_process_group()
    print(f"[train-mesh] {card} phase 24 took "
          f"{time.perf_counter() - t24:.1f} s; memory (GB allocated after, "
          f"peak during) {mem24}")
    return {"dense": dense, "moe": moe_k2, "hybrid": hybrid_k2}


# phase 14: tokens each granite-moe-3b-a800m request generates (cut from
# 32 to keep the script inside its time limit on a slow host: the MoE
# tick is host-bound, ~180-195 ms on a slow one)
MOE_DECODE = 16
# phase 25: one rank of nvidia:h100x256's (16, 16) mesh at decode_32k
# through the split serve step, at full width and depth on the card: the
# dense archs (i) and the recurrent ones (iii)
SERVE_RANK_ARCHS = ("deepseek-7b", "nemotron-4-340b", "xlstm-1.3b",
                    "zamba2-7b", "whisper-tiny")
# phase 25 (iv): the split train step of rank 0 of the same mesh at
# train_4k
TRAIN_RANK_ARCH = "whisper-tiny"
SERVE_RANK_TARGET = "nvidia:h100x256"
# K1 at a rank's shapes: 8 rows (128 over 16 data ranks) at lengths up to
# decode_32k's 32,768 positions, 16-token pages
SERVE_RANK_LENS = (32768, 30001, 24576, 16385, 8192, 4097, 1024, 17)
# the archs whose heads (24, 56) do not divide the model axis: a rank
# computes every head, and K1 reads every kv head, at the model's shape
SERVE_WHOLE_HEADS = ("granite-moe-3b-a800m", "llava-next-34b")


def _rank_shards(torch, m, table, specs, mesh, gen):
    """One rank's shards of ``table`` at rest under ``specs`` on a
    described ``mesh``, drawn on the card from ``gen`` (a K/V cache
    leaf: standard normal; a weight as ``init_params`` draws it)."""
    shards = m.cost.shard_table(table, specs, mesh)
    return m.init_params(shards, gen, "cuda")


def _serve_rank(torch, m, card, counts, reset_counts, quiet, flush) -> dict:
    """Phase 25: (i, iii) one rank of SERVE_RANK_TARGET's mesh runs its
    split decode step (``steps.described_serve_step``, collectives sent
    nowhere) at decode_32k for each of SERVE_RANK_ARCHS at full width and
    depth (the dense archs, then xLSTM and the Zamba2 hybrid, its cache
    the recurrent states' shards), its shards drawn on the card from seed
    0: the logits finite and whole, the peak within DRYRUN_PEAK_RATIO of
    the dry run's GB a card, the arguments within DRYRUN_ARGS_RTOL, the
    step's time beside its bound, K2 counted (the hybrid's norms); (ii) K1 at each split arch's per-rank shape (``RANK_K1``) and
    at the whole-head archs' (SERVE_WHOLE_HEADS) at SERVE_RANK_LENS, held
    as phase 2 holds it and timed; then one attention layer of each
    through ``layers.attention`` in the paged decode mode under a rank's
    ``ServeSplit`` of the mesh, K1 launched once a call (its kv head
    offset where the pool keeps every kv head), the output within the
    kernel tolerance of the gather path's.  Returns the launches and the
    numbers."""
    import numpy as np
    from repro_torch.launch import dryrun
    from repro_torch.sharding.rules import data_parallel_dims
    t25 = time.perf_counter()
    out = {"steps": {}, "k1": {}}
    reset_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rank_") as tdir:
        for arch in SERVE_RANK_ARCHS:
            rec = dryrun.run_cell(arch, "decode_32k", "single",
                                  out_dir=Path(tdir), log=quiet)
            if rec["status"] != "ok":
                raise AssertionError(f"dry run of {arch}: {rec['error']}\n"
                                     f"{rec['traceback']}")
            res = m.BuildService().build(m.AppSpec(arch=arch,
                                                   shape="decode_32k"),
                                         SERVE_RANK_TARGET, lower=False)
            mesh, tables, specs = res.mesh, res.tables, res.specs
            shape = res.appspec.shape_config
            cfg = res.appspec.model_config
            model = m.model_for(cfg, remat="none")
            step = m.steps.described_serve_step(
                model, mesh, specs["params"], "decode", shape.global_batch,
                specs["cache"])
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            base0 = torch.cuda.memory_allocated()
            gen = torch.Generator(device="cuda").manual_seed(0)
            params = _rank_shards(torch, m, tables["params"],
                                  specs["params"], mesh, gen)
            shards = m.cost.shard_table(tables["cache"], specs["cache"],
                                        mesh)
            cache = {}
            for path, d in m.leaf_items(shards):
                if path == ("index",):
                    continue
                at = cache
                for k in path[:-1]:
                    at = at.setdefault(k, {})
                at[path[-1]] = torch.randn(d.shape, generator=gen,
                                           device="cuda", dtype=d.dtype)
            cache["index"] = torch.tensor(shape.seq_len - 1,
                                          dtype=torch.int32)
            rows = shape.global_batch // math.prod(
                mesh.shape[d] for d in data_parallel_dims(
                    shape.global_batch, mesh))
            cache_gb = sum(t.numel() * t.element_size() for _, t in
                           m.leaf_items(cache) if t.dim()) / 1e9
            tokens = torch.randint(0, cfg.vocab_size, (rows, 1),
                                   dtype=torch.int32, device="cuda",
                                   generator=gen)
            torch.cuda.synchronize()
            inputs = torch.cuda.memory_allocated() - base0
            mem = rec["memory_analysis"]
            if abs(inputs - mem["argument_size_in_bytes"]) > \
                    DRYRUN_ARGS_RTOL * mem["argument_size_in_bytes"]:
                raise AssertionError(
                    f"{arch}'s rank step: argument bytes "
                    f"{mem['argument_size_in_bytes']:.6g}, the inputs "
                    f"allocate {inputs:.6g}")
            torch.cuda.reset_peak_memory_stats()
            before = counts()
            logits, _ = step(params, cache, tokens)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base0
            k2 = {k: counts()[k] - before[k] for k in ("rmsnorm",
                                                       "add_rmsnorm")}
            if cfg.norm == "rmsnorm" and not k2["rmsnorm"]:
                raise AssertionError(f"{arch}'s rank step launched no K2")
            if tuple(logits.shape) != (shape.global_batch, 1,
                                       cfg.vocab_size) or \
                    not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"{arch}'s rank step: logits "
                                     f"{tuple(logits.shape)}, finite "
                                     f"{bool(torch.isfinite(logits).all())}")
            del logits
            ratio = mem["per_chip_total_gb"] * 1e9 / peak
            if not DRYRUN_PEAK_RATIO[0] <= ratio <= DRYRUN_PEAK_RATIO[1]:
                raise AssertionError(
                    f"{arch}'s rank step: the dry run's "
                    f"{mem['per_chip_total_gb']:.4f} GB a card, the card's "
                    f"peak {peak / 1e9:.4f} GB (ratio {ratio:.4f} outside "
                    f"{DRYRUN_PEAK_RATIO})")
            # the index stays at the last position: the step rewrites it
            ms = _events_ms(torch, lambda: step(params, cache, tokens), 3)
            r = rec["roofline"]
            bound = max(r["t_compute_s"], r["t_memory_s"]) * 1e3
            calls = {k: v["calls"] for k, v in step.collectives.items()}
            out["steps"][arch] = {"ms": ms, "bound_ms": bound,
                                  "card_gb": peak / 1e9,
                                  "dryrun_gb": mem["per_chip_total_gb"],
                                  "k2": k2}
            print(f"[rank] {card} {arch} x decode_32k, rank 0 of "
                  f"{SERVE_RANK_TARGET}'s {tuple(mesh.shape)} mesh on the "
                  f"card through the split decode step ({rows} rows, "
                  f"{model.cfg.num_heads // mesh.shape[-1] if model.cfg.num_heads % mesh.shape[-1] == 0 else model.cfg.num_heads} "
                  f"of {model.cfg.num_heads} heads, cache shard "
                  f"{cache_gb:.2f} GB"
                  f"{', split along its sequence' if 'I1' in ' '.join(res.plan.notes) and 'k' in cache else ''}"
                  f"; K2 {k2} a step): "
                  f"arguments {mem['argument_size_in_bytes'] / 1e9:.4f} GB, "
                  f"the inputs allocate {inputs / 1e9:.4f} GB; peak "
                  f"{peak / 1e9:.4f} GB on the card, {mem['per_chip_total_gb']:.4f} "
                  f"GB the dry run (ratio {ratio:.4f}); logits finite; "
                  f"{ms:.3f} ms a step (CUDA events) beside a one-card "
                  f"bound of {bound:.3f} ms (the collectives, "
                  f"{calls} calls sent nowhere, not timed: "
                  f"{r['t_collective_s'] * 1e3:.3f} ms on the dry run's "
                  f"link)")
            del params, cache, tokens, step, res, model
            gc.collect()
            torch.cuda.empty_cache()
    step_counts = counts()
    if not step_counts["rmsnorm"] or not step_counts["add_rmsnorm"]:
        raise AssertionError(f"the rank steps launched no K2: {step_counts}")
    out["step_launches"] = step_counts

    # (ii) K1 at a rank's shapes, then one attention layer a rank
    rng = np.random.default_rng(25)
    lens = list(SERVE_RANK_LENS)
    cases = [(name, _rank_case(torch, rng, lens, 16, 2048, Kp, kv0, K, G,
                               d)) for name, Kp, kv0, K, G, d in RANK_K1]
    for name in SERVE_WHOLE_HEADS:
        c = m.get_config(name)
        cases.append((name, _paged_case(
            torch, rng, lens, 16, 2048, c.num_kv_heads,
            c.num_heads // c.num_kv_heads, c.head_dim)))
    attend = m.paged_attention_cuda
    for name, case in cases:
        d = _k1_hold(torch, m.ref, attend, f"{name} rank", case)
        num = _k1_numbers(torch, m.ref, attend, card, f"{name} at a rank's "
                          f"heads on {SERVE_RANK_TARGET}", case, flush)
        out["k1"][name] = dict(num, ratio=d["ratio"], abs=d["abs"])
        del case
    del cases
    gc.collect()
    torch.cuda.empty_cache()
    reset_counts()
    layer = {}
    for name in tuple(n for n, *_ in RANK_K1) + SERVE_WHOLE_HEADS:
        layer[name] = _rank_attention(torch, m, name, rng, counts)
    out["layer_launches"] = counts()
    print(f"[rank] {card} one attention layer a rank on "
          f"{SERVE_RANK_TARGET} through layers.attention (paged decode, K1 "
          f"on the rank's heads, the pool's kv heads read in place): "
          f"{layer}; K1 launched {out['layer_launches']['paged_attention']}"
          f" times; phase 25 took {time.perf_counter() - t25:.1f} s")
    return out


def _train_rank(torch, m, card, quiet) -> dict:
    """Phase 25 (iv): rank 0 of SERVE_RANK_TARGET's mesh runs
    TRAIN_RANK_ARCH's split train step at train_4k
    (``steps.described_rank_step``, collectives sent nowhere) for real on
    the card, its state shards drawn on the card from seed 0 and its
    rows of the batch from the synthetic source: the arguments within
    DRYRUN_ARGS_RTOL of the dry run's, the peak within DRYRUN_PEAK_RATIO
    of its GB a card, the loss finite.  Returns the numbers."""
    from repro_torch.launch import dryrun
    from repro_torch.sharding.rules import data_parallel_dims
    t = time.perf_counter()
    arch = TRAIN_RANK_ARCH
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rank_") as tdir:
        rec = dryrun.run_cell(arch, "train_4k", "single", out_dir=Path(tdir),
                              log=quiet)
    if rec["status"] != "ok":
        raise AssertionError(f"dry run of {arch} x train_4k: {rec['error']}"
                             f"\n{rec['traceback']}")
    res = m.BuildService().build(m.AppSpec(arch=arch, shape="train_4k"),
                                 SERVE_RANK_TARGET, lower=False)
    mesh, tables, specs, plan = res.mesh, res.tables, res.specs, res.plan
    shape, cfg = res.appspec.shape_config, res.appspec.model_config
    model = m.model_for(cfg, remat=plan.remat_policy)
    opt = m.make_optimizer(plan.optimizer)
    step = m.steps.described_rank_step(model, opt, plan, mesh,
                                       specs["state"]["params"],
                                       shape.global_batch)
    rows = shape.global_batch // math.prod(
        mesh.shape[d] for d in data_parallel_dims(shape.global_batch, mesh))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base0 = torch.cuda.memory_allocated()
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = _rank_shards(torch, m, tables["state"], specs["state"], mesh,
                         gen)
    batch = m.to_device(m.SyntheticSource(cfg.vocab_size, 0).batch(
        model.batch_table(dataclasses.replace(shape, global_batch=rows)),
        0), "cuda")
    torch.cuda.synchronize()
    inputs = torch.cuda.memory_allocated() - base0
    mem = rec["memory_analysis"]
    if abs(inputs - mem["argument_size_in_bytes"]) > \
            DRYRUN_ARGS_RTOL * mem["argument_size_in_bytes"]:
        raise AssertionError(f"{arch}'s rank train step: argument bytes "
                             f"{mem['argument_size_in_bytes']:.6g}, the "
                             f"inputs allocate {inputs:.6g}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base0
    loss = float(metrics["loss"])
    calls = {k: v["calls"] for k, v in metrics["collectives"].items()}
    del state, batch, metrics, step, model
    gc.collect()
    torch.cuda.empty_cache()
    if not math.isfinite(loss):
        raise AssertionError(f"{arch}'s rank train step: loss {loss}")
    ratio = mem["per_chip_total_gb"] * 1e9 / peak
    if not DRYRUN_PEAK_RATIO[0] <= ratio <= DRYRUN_PEAK_RATIO[1]:
        raise AssertionError(
            f"{arch}'s rank train step: the dry run's "
            f"{mem['per_chip_total_gb']:.4f} GB a card, the card's peak "
            f"{peak / 1e9:.4f} GB (ratio {ratio:.4f} outside "
            f"{DRYRUN_PEAK_RATIO})")
    print(f"[rank] {card} {arch} x train_4k, rank 0 of {SERVE_RANK_TARGET}'s "
          f"{tuple(mesh.shape)} mesh on the card through the split train "
          f"step ({rows} rows of {shape.seq_len} frames + tokens; plan "
          f"{plan.optimizer}, remat {plan.remat_policy}, "
          f"{plan.microbatches} microbatch): arguments "
          f"{mem['argument_size_in_bytes'] / 1e9:.4f} GB, the inputs "
          f"allocate {inputs / 1e9:.4f} GB; peak {peak / 1e9:.4f} GB on the "
          f"card, {mem['per_chip_total_gb']:.4f} GB the dry run (ratio "
          f"{ratio:.4f}); loss {loss:.6f} finite; the step {step_s:.3f} s "
          f"(host clock, device drained; the first, with its warm-ups), "
          f"collectives {calls} calls sent nowhere; phase 25 (iv) took "
          f"{time.perf_counter() - t:.1f} s")
    return {"card_gb": peak / 1e9, "dryrun_gb": mem["per_chip_total_gb"],
            "step_s": step_s}


def _rank_attention(torch, m, arch, rng, counts) -> str:
    """One attention layer of ``arch`` as the last model rank of
    SERVE_RANK_TARGET's mesh runs it in the paged decode mode: its weight
    shards gathered along ``data`` by a ``ServeSplit`` of the described
    mesh, 8 rows over a pool of every kv head or of the rank's; K1 on the
    card (one launch) against the gather path on a copy of the pool,
    within the kernel tolerance.  Returns how the rank split it."""
    from repro_torch.sharding.split import (Collectives, ServeSplit,
                                            params_placements)
    res = m.BuildService().build(m.AppSpec(arch=arch, shape="decode_32k"),
                                 SERVE_RANK_TARGET, lower=False)
    mesh, cfg = res.mesh, res.appspec.model_config
    coord = (0,) * (len(mesh.shape) - 1) + (mesh.shape[-1] - 1,)
    split = ServeSplit(mesh.shape, coord, [None] * len(mesh.shape),
                       Collectives(), params_placements(
                           res.specs["params"], mesh.axis_names, mesh.shape),
                       mesh.axis_names)
    table = {"blocks": {"attn": res.tables["params"]["blocks"]["attn"]}}
    spec = {"blocks": {"attn": res.specs["params"]["blocks"]["attn"]}}
    gen = torch.Generator(device="cuda").manual_seed(0)
    shards = _rank_shards(torch, m, table, spec, mesh, gen)
    p = split.use(m.tree_map(lambda t: t[0], shards["blocks"]),
                  ("blocks",))["attn"]
    heads = p["wq"].shape[1]
    kv = p["wk"].shape[1]
    slots, psize, max_pages = 8, 16, 64
    lens = [int(n) for n in rng.integers(1, max_pages * psize, slots)]
    held = [-(-n // psize) for n in lens]
    table_ = torch.zeros((slots, max_pages), dtype=torch.int32)
    order = torch.randperm(sum(held), generator=torch.Generator().manual_seed(
        0)) + 1
    i = 0
    for r_, h in enumerate(held):
        table_[r_, :h] = order[i:i + h].to(torch.int32)
        i += h
    pool = torch.randn((sum(held) + 1, psize, kv, cfg.head_dim),
                       device="cuda", generator=gen).to(torch.bfloat16)
    x = torch.randn((slots, 1, cfg.d_model), device="cuda",
                    generator=gen).to(torch.bfloat16)
    idx = torch.as_tensor(lens, dtype=torch.int32, device="cuda") - 1
    positions = idx[:, None]
    outs = []
    for kernel in (True, False):
        cache = {"k": pool.clone(), "v": pool.clone(), "index": idx,
                 "layout": "paged", "pages": table_.to("cuda"),
                 "use_kernel": kernel}
        before = counts()["paged_attention"]
        y, _ = m.layers.attention(p, x, cfg, positions=positions,
                                  mode="decode", cache=cache, tp=split)
        launched = counts()["paged_attention"] - before
        if launched != (1 if kernel else 0):
            raise AssertionError(f"{arch}: K1 launched {launched} times in "
                                 f"one layer (kernel {kernel})")
        outs.append(y.float())
    _check_close(f"{arch} rank attention layer", outs[0], outs[1],
                 KERNEL_ATOL, KERNEL_RTOL)
    how = f"{heads} of {cfg.num_heads} heads over " + (
        f"kv heads {split.kv_range(cfg, heads)} of a pool of {kv}"
        if kv == cfg.num_kv_heads and heads < cfg.num_heads else
        f"the rank's {kv} kv heads" if heads < cfg.num_heads else
        f"all {kv} kv heads (heads whole)")
    return how


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dry = _DryRun()
    try:
        return _main(dry)
    finally:
        dry.close()


def _main(dry: _DryRun) -> int:
    t_main = time.perf_counter()
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.appspec import AppSpec, parse_appfile
    from repro_torch.core.jobs import JobState
    from repro_torch.core.jobspec import lulesh_example, parse_jobspec
    from repro_torch.core.package import extract_package
    from repro_torch.core.target import TargetSpec, get_target, register
    from repro_torch.core.tuning import (kv_bytes_per_token,
                                         param_count_estimate, tune)
    from repro_torch.configs.base import SHAPES
    from repro_torch.kernels import _build, bench, ops, ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.paged_attention import (head_chunk, head_chunks,
                                                      num_splits,
                                                      paged_attention_cuda)
    from repro_torch.core.workflow import run_easey
    from repro_torch.kernels.rmsnorm import add_rmsnorm_cuda, rmsnorm_cuda
    from repro_torch.kernels.rmsnorm import plan as _rmsnorm_plan
    from repro_torch.kernels.sedov_stencil import sedov_step_cuda
    from repro_torch.launch.serve import grow_kv, legacy_generate, serve_main
    from repro_torch.models import mamba, ssm
    from repro_torch.analysis import cost, flops, roofline
    from repro_torch.models import lulesh, moe
    from repro_torch import serving
    from repro_torch.serving import (ReplicaRouter, Request, ServeEngine,
                                     repetitive_trace, sharedprefix_trace,
                                     zipf_trace)
    from repro_torch.training.steps import (build_decode_step_slots_paged,
                                            build_train_step,
                                            init_train_state,
                                            train_state_table)
    from repro_torch.runtime.elastic import reshard_state
    from repro_torch.launch.mesh import Mesh, mesh_for_target
    from repro_torch.launch.train import train_main
    from repro_torch.launch.run import run_command
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.runtime.fault_tolerance import (FailureInjector,
                                                     SimulatedFailure)
    from repro_torch.training import steps as port_steps
    from repro_torch.data.pipeline import (DataPipeline, SyntheticSource,
                                           to_device)
    from repro_torch.models import layers
    from repro_torch.models.params import init_params, leaf_items, tree_map
    from repro_torch.core.build import BuildService
    from repro_torch.models.transformer import model_for
    from repro_torch.optim import make_optimizer

    wrappers = {"paged_attention": paged_attention_cuda,
                "rmsnorm": rmsnorm_cuda, "add_rmsnorm": add_rmsnorm_cuda,
                "sedov_stencil": sedov_step_cuda,
                "flash_attention": flash_attention_cuda}

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0

    def counts():
        return {k: w.launches for k, w in wrappers.items()}

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = _smi()
    card = f"[{smi}]"

    # ---- 1. device and build -------------------------------------------
    dry.mark(1)
    props = torch.cuda.get_device_properties(0)
    print(f"[device] {smi} | {props.name}, {props.multi_processor_count} SMs,"
          f" {props.total_memory / 1e9:.1f} GB | torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    empty_kernel = _empty_kernel_build(torch, _build)
    logs, build_s = _timed(_build.build)
    empty_cuda = empty_kernel()
    print(f"[build] nvcc {', '.join(sorted(logs)) or '(already built)'} for "
          f"sm_90a in {build_s:.2f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "Compiling entry" in line:
                print(f"[build] {name}: {line.strip()}")

    # ---- 2. kernels against their plain versions -----------------------
    dry.mark(2)
    rng = np.random.default_rng(0)
    torch.manual_seed(0)
    k1_err = 0.0
    for G in (1, 4):
        for lens in ([0, 1, 16, 37, 64], [64, 2, 32, 0]):
            case = _paged_case(torch, rng, lens, 16, 4, 2, G, 128)
            got = paged_attention_cuda(*case)
            want = ref.paged_attention_ref(*case)
            k1_err = max(k1_err, _check_close(
                f"paged_attention G={G} lens={lens}", got, want,
                KERNEL_ATOL, KERNEL_RTOL))
            freed = [i for i, n in enumerate(lens) if n == 0]
            if bool(got[freed].ne(0).any()):
                raise AssertionError("freed slot did not write exact zeros")
            q, kp, vp, table, kv_len = case
            kp[0], vp[0] = -3e4, 5e3          # re-poison the junk page
            again = paged_attention_cuda(q, kp, vp, table, kv_len)
            if not torch.equal(got, again):
                raise AssertionError("output depends on the junk page 0")
    # a freed row with a stale nonzero length: still exact zeros
    q, kp, vp, table, kv_len = _paged_case(torch, rng, [24, 13, 7], 16, 2, 2,
                                           2, 128)
    table[1] = 0
    if bool(paged_attention_cuda(q, kp, vp, table, kv_len)[1].ne(0).any()):
        raise AssertionError("stale-length freed slot read the junk page")

    # the full-width main-path shapes: the tuner's pool for deepseek-7b on
    # one H100 with 8 slots x 512, slots mid-generation
    full = get_config("deepseek-7b")
    plan = tune(full, dataclasses.replace(SHAPES["decode_32k"], seq_len=512,
                                          global_batch=8),
                get_target("nvidia:h100"))
    prng = np.random.RandomState(0)
    plens = prng.randint(64, 385, size=8)
    main_lens = [int(n) + 16 for n in plens]
    k1_main = _paged_case(torch, rng, main_lens, plan.serve_page_size,
                          512 // plan.serve_page_size, full.num_kv_heads,
                          full.num_heads // full.num_kv_heads, full.head_dim,
                          num_pages=plan.serve_num_pages)
    k1_err = max(k1_err, _check_close(
        "paged_attention main path", paged_attention_cuda(*k1_main),
        ref.paged_attention_ref(*k1_main), KERNEL_ATOL, KERNEL_RTOL))
    print(f"[kernels] paged_attention vs plain: max abs err {k1_err:.4g} "
          f"(atol {KERNEL_ATOL}, rtol {KERNEL_RTOL}), junk page ignored, "
          f"freed slots exact zeros")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    k1_cases = [("main path", k1_main)] + _k1_cases(
        torch, rng, full.num_kv_heads, full.head_dim, plan.serve_page_size,
        sms, num_splits)
    for name, case in k1_cases:
        d = _k1_hold(torch, ref, paged_attention_cuda, name, case)
        if name == "shared page run" and not torch.equal(
                *paged_attention_cuda(*case)[:2]):
            raise AssertionError("paged_attention: two slots over the same "
                                 "pages and query differ")
        k1_err = max(k1_err, d["abs"])
        slots = case[0].shape[0]
        Kh, G = _case_heads(case)
        hc = head_chunk(G)
        pairs = slots * Kh * head_chunks(G)
        print(f"[kernels] paged_attention {name} (lengths "
              f"{case[4].tolist()[:8]}, G={G} in chunks of {hc}, "
              f"{num_splits(pairs, case[3].shape[1], sms)} splits): "
              f"{d['ratio']:.4f} of the two-rounding bound, "
              f"{d['ulps']:.3g} bf16 steps, max abs {d['abs']:.4g}; two calls "
              f"bitwise equal")
    k1_long, k1_two, k1_g12, k1_stablelm, k1_nemotron, k1_granite, \
        k1_dbrx = (dict(k1_cases)[c] for c in (
            "1 slot x 4096", "2 slots", "G=12", "stablelm-1.6b (G=1, dh 64)",
            "nemotron-4-340b (G=12, dh 192)",
            "granite-moe-3b-a800m (G=3, dh 64)", "dbrx-132b (G=6, dh 128)"))

    k2_err = 0.0
    d = full.d_model
    w = (1 + 0.1 * torch.randn(d, device="cuda")).to(torch.bfloat16)
    for rows in (1, 8, 128, 1000):
        x = (3 * torch.randn((rows, d), device="cuda")).to(torch.bfloat16)
        k2_err = max(k2_err, _check_close(
            f"rmsnorm rows={rows}", rmsnorm_cuda(x, w), ref.rmsnorm_ref(x, w),
            KERNEL_ATOL, KERNEL_RTOL))
    x32 = 300 * torch.randn((8, d), device="cuda")
    k2_err = max(k2_err, _check_close(
        "rmsnorm f32 input", rmsnorm_cuda(x32, w, out_dtype=torch.bfloat16),
        ref.rmsnorm_ref(x32, w, out_dtype=torch.bfloat16),
        KERNEL_ATOL, KERNEL_RTOL))
    print(f"[kernels] rmsnorm vs plain (rows 1/8/128/1000 x {d}, bf16 and "
          f"f32 input): max abs err {k2_err:.4g}")
    k2f_err, k2f_share = 0.0, 0.0
    k2_vlm = {}
    for dk in K2_WIDTHS:
        wk = (1 + 0.1 * torch.randn(dk, device="cuda")).to(torch.bfloat16)
        for rows in K2_ROWS + tuple(r for r, c in K2_VLM_SHAPES if c == dk):
            xk = (3 * torch.randn((rows, dk), device="cuda")).to(torch.bfloat16)
            ak = torch.randn((rows, dk), device="cuda").to(torch.bfloat16)
            for rounded in (False, True):
                h = _k2_hold(torch, ref, add_rmsnorm_cuda,
                             f"rows={rows} d={dk} norm_of_rounded={rounded}",
                             xk, ak, wk, rounded)
                k2f_err = max(k2f_err, h["abs"])
                k2f_share = max(k2f_share, h["share"])
                if (rows, dk) in K2_VLM_SHAPES:
                    k2_vlm[rows, dk, rounded] = h["share"]
            if (rows, dk) in K2_VLM_SHAPES:
                h = _k2_norm_hold(torch, ref, rmsnorm_cuda,
                                  f"rows={rows} d={dk}", xk, wk)
                k2_err = max(k2_err, _check_close(
                    f"rmsnorm rows={rows} d={dk}", rmsnorm_cuda(xk, wk),
                    ref.rmsnorm_ref(xk, wk), KERNEL_ATOL, KERNEL_RTOL))
                k2_vlm[rows, dk, "rmsnorm"] = h["share"]
    print(f"[kernels] add_rmsnorm vs plain (rows {K2_ROWS} x d {K2_WIDTHS}, "
          f"and rows x d {K2_VLM_SHAPES}, the norm of the f32 sum and of "
          f"the rounded one): residual bitwise equal, norm within "
          f"{k2f_share:.4f} of one bf16 step (max abs {k2f_err:.4g}), two "
          f"calls bitwise equal; at llava-next-34b's shapes (threads, "
          f"vectors a thread {_rmsnorm_plan(7168)}), share of one bf16 step "
          f"per (rows, d, form) {({k: round(v, 4) for k, v in k2_vlm.items()})}"
          f", the rmsnorm entry too")
    k2_zamba = {}
    for rows, dk in K2_ZAMBA_SHAPES:
        wk = (1 + 0.1 * torch.randn(dk, device="cuda")).to(torch.bfloat16)
        xk = (3 * torch.randn((rows, dk), device="cuda")).to(torch.bfloat16)
        ak = torch.randn((rows, dk), device="cuda").to(torch.bfloat16)
        for rounded in (False, True):
            h = _k2_hold(torch, ref, add_rmsnorm_cuda,
                         f"rows={rows} d={dk} norm_of_rounded={rounded}",
                         xk, ak, wk, rounded)
            k2f_err = max(k2f_err, h["abs"])
            k2_zamba[rows, dk, rounded] = h["share"]
        h = _k2_norm_hold(torch, ref, rmsnorm_cuda, f"rows={rows} d={dk}",
                          xk, wk)
        k2_err = max(k2_err, _check_close(
            f"rmsnorm rows={rows} d={dk}", rmsnorm_cuda(xk, wk),
            ref.rmsnorm_ref(xk, wk), KERNEL_ATOL, KERNEL_RTOL))
        k2_zamba[rows, dk, "rmsnorm"] = h["share"]
    print(f"[kernels] rmsnorm and add_rmsnorm at zamba2-7b's decode and "
          f"prefill rows x its width {K2_ZAMBA_SHAPES} (threads, vectors a "
          f"thread {_rmsnorm_plan(3584)}), held as above: share of one bf16 "
          f"step per (rows, d, form) "
          f"{({k: round(v, 4) for k, v in k2_zamba.items()})}")
    denormal = _route_checks(torch, moe)
    print(f"[kernels] route_tokens on the card (no kernel of its own): on "
          f"rows of exact ties (E 40, k 8; E 16, k 4) and saturated rows "
          f"({denormal['cpu']} denormal probabilities in an unflushed "
          f"softmax on the CPU, {denormal['cuda']} on the card, flushed), "
          f"slot, keep and gates equal the CPU's bit for bit and lax.top_k's "
          f"choice")
    k2g = {shape: _k2_grad_hold(torch, ref, ops, rmsnorm_cuda,
                                add_rmsnorm_cuda, *shape,
                                torch.Generator(device="cuda").manual_seed(2))
           for shape in K2_GRAD_SHAPES}
    for shape, h in k2g.items():
        print(f"[kernels] K2's gradient at {shape} bf16 (ops.rmsnorm and "
              f"ops.add_rmsnorm under grad, both forms): forward bit-equal "
              f"to the direct kernel call, dx/da/dw bitwise equal to the "
              f"plain backward on the same inputs, within "
              f"{h['share']:.4f} of the tolerance (rtol {K2_GRAD_RTOL:.4g}, "
              f"atol {K2_GRAD_ATOL:.4g} of the largest) from autograd "
              f"through the plain version; device ms (forward kernel, "
              f"backward) rmsnorm {h['ms']['rmsnorm']}, fused of the f32 sum "
              f"{h['ms'][False]}, of the rounded sum {h['ms'][True]} "
              f"(CUDA graphs)")

    # ---- 3. stream identity at smoke size ------------------------------
    dry.mark(3)
    smoke = get_config("deepseek-7b-smoke")
    param_bytes = 2 * param_count_estimate(smoke)
    kv_budget = 3.5 * kv_bytes_per_token(smoke) * 128
    register(TargetSpec(
        name="bench:serve-tight", chip="cuda", mesh_shape=(1,),
        mesh_axes=("data",), peak_flops=5e10, hbm_bw=2e10,
        hbm_bytes=(param_bytes + kv_budget) / 0.85, ici_bw=1e9,
        scheduler="local", kernels="reference",
        description="the serving benchmark's tight budget (3 contiguous "
                    "slots x 128)"))
    quiet = lambda *a, **k: None  # noqa: E731

    def smoke_pair(**kw):
        return {kk: ServeEngine(arch="deepseek-7b-smoke", seed=0, kv_kernel=kk,
                                log=quiet, **kw) for kk in ("cuda", "gather")}

    def same_streams(eng, trace, what, **run):
        st = {kk: e.run(trace, **run) for kk, e in eng.items()}
        streams = {kk: [r.tokens for r in s.results] for kk, s in st.items()}
        if streams["cuda"] != streams["gather"]:
            raise AssertionError(f"smoke streams differ ({what}): kernel vs "
                                 f"gather")
        return st["cuda"]

    eng = smoke_pair(target="bench:serve-tight", num_slots=8, max_len=128)
    trace = zipf_trace(12, smoke.vocab_size, max_prompt=48, max_new=32,
                       alpha=1.3, seed=0)
    for policy, chunk in (("continuous", 0), ("static", 0),
                          ("continuous", None)):
        s = same_streams(eng, trace, f"{policy}, prefill_chunk={chunk}",
                         policy=policy, prefill_chunk=chunk)
        tps = round(s.generated_tokens / s.decode_steps, 4)
        if chunk == 0 and (s.decode_steps, tps) != (31, 6.2581):
            raise AssertionError(f"smoke schedule {s.decode_steps} steps, "
                                 f"{tps} tokens/step != 31, 6.2581")
    # scarce pages: the preemption trace of tests/test_serving_paged.py
    # (under the CPU target's plan, as the CPU tests run this trace)
    eng = smoke_pair(target="local:cpu", num_slots=4, max_len=64,
                     page_size=8, num_pages=13)
    s = same_streams(eng, zipf_trace(12, smoke.vocab_size, max_prompt=24,
                                     max_new=32, seed=3), "preemption")
    if s.preemptions == 0:
        raise AssertionError("the scarce-page trace did not preempt")
    print(f"[smoke] deepseek-7b-smoke: kernel == gather streams on the "
          f"benchmark trace (continuous and static, blocking and chunked "
          f"prefill; 31 decode steps, 6.2581 tokens/step) and under "
          f"{s.preemptions} preemptions")
    del eng
    bench_cells = json.loads((REPO / "BENCH_serving.json").read_text())[
        "cells"]
    tight_kw = dict(target="bench:serve-tight", num_slots=8, max_len=128,
                    seed=0, log=quiet)
    paged_tight = ServeEngine(arch="deepseek-7b-smoke", kv_kernel="cuda",
                              **tight_kw)
    cells, cells_s = _timed(
        _router_cells, serving,
        ServeEngine(arch="deepseek-7b-smoke", kv_layout="contiguous",
                    **tight_kw), paged_tight)
    # telemetry_overhead: the paged_continuous drain re-run with a Tracer
    # (benchmarks/serving_throughput.py), on the paged kernel
    plain_pc = paged_tight.run(trace, policy="continuous", prefill_chunk=0)
    tel_tracer = serving.Tracer()
    tel = paged_tight.run(trace, policy="continuous", prefill_chunk=0,
                          tracer=tel_tracer)
    if _streams(tel) != _streams(plain_pc):
        raise AssertionError("telemetry-on streams differ from the "
                             "tracing-off paged_continuous run")
    cells["telemetry_overhead"] = {
        "tokens_per_step": round(tel.generated_tokens / tel.decode_steps, 4),
        "decode_steps": tel.decode_steps,
        "generated_tokens": tel.generated_tokens,
        "trace_spans": len(tel_tracer.spans),
        "ring_events": tel_tracer.total_events,
        "mean_ttft_steps": round(tel.mean_ttft_steps, 4)}
    engine_cells = _engine_cells(serving, kv_bytes_per_token, tight_kw,
                                 trace)
    spec_on = engine_cells.pop("paged_spec_on")
    cells.update(engine_cells)
    cells["paged_spec_on"] = {k: spec_on[k] for k in SPEC_ON_KEYS}
    if set(cells) != set(bench_cells):
        raise AssertionError(f"cells checked {sorted(cells)} != "
                             f"BENCH_serving.json's {sorted(bench_cells)}")
    for name, got in cells.items():
        want = {k: v for k, v in bench_cells[name].items()
                if k != "tokens_per_s"}
        if name == "paged_continuous_kernel":
            want["kv_kernel"] = "cuda"     # the port's name of the kernel
        if name == "paged_spec_on":
            want = {k: want[k] for k in SPEC_ON_KEYS}
        if got != want:
            raise AssertionError(f"smoke cell {name}: {got} != {want}")
    print(f"[smoke] BENCH_serving.json's {len(cells)} cells at smoke size "
          f"({', '.join(cells)}): every deterministic key equals the "
          f"file's (paged_spec_on: {', '.join(SPEC_ON_KEYS)}; on the card's "
          f"own weights it takes {spec_on['decode_steps']} decode steps, "
          f"{spec_on['accepted_per_verify']} tokens per verify, spec-on "
          f"streams equal spec-off); router x3 streams equal one engine's, "
          f"shared-prefix streams equal with the prefix cache on and off, "
          f"traced streams equal untraced ({cells_s:.1f} s; telemetry_"
          f"overhead {tel.tokens_per_s:.1f} tokens/s traced, "
          f"{plain_pc.tokens_per_s:.1f} untraced, not gated)")
    del paged_tight
    # the MoE family at smoke size, on the trace of the reference's MoE
    # serving tests (3 slots x 48): paged (page 8) on the kernel and on the
    # gather path, contiguous, and chunked (chunk 4) against blocking
    moe_counts = {}
    for arch in ("granite-moe-3b-a800m-smoke", "dbrx-132b-smoke"):
        mreqs = zipf_trace(6, get_config(arch).vocab_size, max_prompt=16,
                           max_new=10, seed=1)
        kw = dict(arch=arch, num_slots=3, max_len=48, seed=0, log=quiet)
        paged = {kk: ServeEngine(kv_layout="paged", page_size=8,
                                 kv_kernel=kk, **kw)
                 for kk in ("cuda", "gather")}
        contiguous = ServeEngine(kv_layout="contiguous", **kw)
        runs = {"paged, kernel": paged["cuda"].run(mreqs),
                "paged, gather": paged["gather"].run(mreqs),
                "contiguous": contiguous.run(mreqs),
                "paged, kernel, chunk 4": paged["cuda"].run(
                    mreqs, prefill_chunk=4),
                "paged, kernel, blocking": paged["cuda"].run(
                    mreqs, prefill_chunk=0)}
        want = _streams(runs["paged, kernel"])
        for what, st in runs.items():
            if _streams(st) != want:
                raise AssertionError(f"{arch}: {what} streams differ from "
                                     f"the paged kernel's")
            asked = {r.rid: r.max_new_tokens for r in mreqs}
            if len(st.results) != 6 or any(len(r.tokens) != asked[r.rid]
                                           for r in st.results):
                raise AssertionError(f"{arch} ({what}): not every request "
                                     f"complete")
        moe_counts[arch] = {w: (st.decode_steps, st.prefill_chunks)
                            for w, st in runs.items()}
    print(f"[smoke] MoE family, 6 zipf requests of up to 16 + 10 tokens, "
          f"3 slots x 48: identical greedy streams paged (kernel and "
          f"gather) and contiguous, chunked (chunk 4) and blocking; (decode "
          f"steps, chunk steps) {moe_counts}")
    mt = types.SimpleNamespace(
        get_config=get_config, tune=tune, get_target=get_target,
        SHAPES=SHAPES, model_for=model_for, init_params=init_params,
        DataPipeline=DataPipeline, ops=ops, ref=ref, layers=layers,
        make_optimizer=make_optimizer, init_train_state=init_train_state,
        build_train_step=build_train_step, train_main=train_main,
        param_count_estimate=param_count_estimate, AppSpec=AppSpec,
        BuildService=BuildService, tree_map=tree_map, leaf_items=leaf_items,
        steps=port_steps, serve_main=serve_main, run_command=run_command,
        run_easey=run_easey, parse_appfile=parse_appfile,
        parse_jobspec=parse_jobspec, JobState=JobState,
        SyntheticSource=SyntheticSource, to_device=to_device,
        build_prefill_step=port_steps.build_prefill_step,
        build_decode_step=port_steps.build_decode_step,
        build_arch=_build.ARCH, ssm=ssm, mamba=mamba, grow_kv=grow_kv,
        cost=cost, flops=flops, roofline=roofline,
        reshard_state=reshard_state, train_state_table=train_state_table,
        sedov_step_cuda=sedov_step_cuda,
        mesh_for_target=mesh_for_target, Mesh=Mesh, lulesh=lulesh,
        ServeEngine=ServeEngine, legacy_generate=legacy_generate,
        Checkpointer=Checkpointer, FailureInjector=FailureInjector,
        SimulatedFailure=SimulatedFailure,
        paged_attention_cuda=paged_attention_cuda)
    train_smoke, train_s = _timed(_train_smoke, torch, mt, counts,
                                  reset_counts)
    print(f"[smoke] training {TRAIN_SMOKE_ARCHS}, {TRAIN_SMOKE_STEPS} steps "
          f"of 4 x 64 tokens through the BuildService's train step on the "
          f"card ({train_s:.1f} "
          f"s): adamw and adamw8bit, 1 and 2 microbatches, ef_int8 on and "
          f"off, each under remat none, dots and full with bitwise equal "
          f"losses and states, K2 on every norm of every forward and "
          f"recompute (per step {train_smoke['k2_per_step']}); final losses "
          f"{train_smoke['final']}")
    _smoke_grads(torch, mt, card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tdir:
        kw = dict(arch="deepseek-7b-smoke", steps=TRAIN_SMOKE_STEPS,
                  seq_len=64, global_batch=4, ckpt_every=2,
                  async_ckpt=False, log=quiet)
        clean = train_main(ckpt_dir=f"{tdir}/a", **kw)
        faulty = train_main(ckpt_dir=f"{tdir}/b", fail_at=(3,), **kw)
        again = train_main(**kw)
        if (clean["restarts"], faulty["restarts"]) != (0, 1):
            raise AssertionError(f"restarts {clean['restarts']}, "
                                 f"{faulty['restarts']} != 0, 1")
        _same_state(torch, clean["state"], faulty["state"],
                    "a run restarted from its checkpoint")
        if again["losses"] != clean["losses"]:
            raise AssertionError(f"two runs from one seed: losses "
                                 f"{again['losses']} != {clean['losses']}")
        _same_state(torch, clean["state"], again["state"],
                    "a second run from the same seed")
        del clean, faulty, again
        cmd = "train --steps 4 --seq-len 64 --global-batch 4"
        app = parse_appfile(f"FROM arch:deepseek-7b-smoke\nSHAPE train_4k\n"
                            f"###include_local_kernels###\nRUN {cmd}\n")
        spec = parse_jobspec({"job": {"name": "train-smoke"}, "execution": [
            {"serial": {"command": cmd}}]})
        reset_counts()
        mw3, jid3, res3 = run_easey(app, "nvidia:h100", spec,
                                    storage=f"{tdir}/easey")
        easey_train = counts()
        if mw3.status(jid3) is not JobState.FINISHED:
            raise AssertionError(f"training job {mw3.status(jid3).value}: "
                                 f"{mw3.logs(jid3)[1][-3000:]}")
        out3 = mw3.scheduler.result(jid3)[0]
        if (res3.step_name, sorted(res3.built), list(
                res3.program["kernels"])) != ("train_step", ["rmsnorm"],
                                              ["rmsnorm"]):
            raise AssertionError(f"training build: {res3.step_name}, "
                                 f"built {res3.built}, program "
                                 f"{res3.program['kernels']}")
        if easey_train["add_rmsnorm"] == 0 or out3["steps"] != 4 or \
                out3["device"] != "cuda" or \
                not np.isfinite(out3["losses"]).all():
            raise AssertionError(f"training job: launches {easey_train}, "
                                 f"{out3['steps']} steps on "
                                 f"{out3['device']}, losses "
                                 f"{out3['losses']}")
        del mw3, out3
    print(f"[smoke] deepseek-7b-smoke, {TRAIN_SMOKE_STEPS} steps with "
          f"checkpoints every 2: a run failing at step 3 restarts once "
          f"from its checkpoint and ends in the uninterrupted run's state "
          f"bit for bit; a second run from the same seed repeats its loss "
          f"bits and state; run_easey(smoke training Appfile, nvidia:h100) "
          f"finished, build {sorted(res3.built)}, K2 launches {easey_train}")
    for kw3 in (VLM_SMOKE, SSM_SMOKE, HYBRID_SMOKE):
        leg3 = _legacy_smoke(torch, mt, counts, reset_counts, quiet, kw3)
        print(f"[smoke] the legacy fixed-batch path, {kw3}: serve_main "
              f"with K2 on every norm (launches {leg3['launches']}), with "
              f"the plain norm in its place, and run_command: every row's "
              f"greedy tokens equal (sample {leg3['sample']})")

    # ---- 4. the slice at full width ------------------------------------
    dry.mark(4)
    reqs = [Request(rid=i, prompt=prng.randint(1, full.vocab_size - 1,
                                               size=(int(n),)).astype(np.int32),
                    max_new_tokens=32)
            for i, n in enumerate(plens)]

    def make_engine(**kw):
        return ServeEngine(arch="deepseek-7b", kv_layout="paged", num_slots=8,
                           max_len=512, seed=0, log=quiet, **kw)

    # every argument but the model's at its default: the card's own target
    eng_k, init_s = _timed(make_engine)
    if (eng_k.plan.target, eng_k.kv_kernel) != ("nvidia:h100", "cuda"):
        raise AssertionError(f"the default engine on the card took target "
                             f"{eng_k.plan.target!r}, kv_kernel "
                             f"{eng_k.kv_kernel!r}")
    print(f"[full] deepseek-7b on {card}: {eng_k.num_slots} slots, "
          f"{eng_k.num_pages} pages x {eng_k.page_size}, chunk "
          f"{eng_k.prefill_chunk}, engine built in {init_s:.1f} s")
    reset_counts()
    st_k = eng_k.run(reqs)
    launches = counts()
    p4_streams, p4_sig = _streams(st_k), _weights_sig(eng_k)
    p4_launches = dict(launches)     # phase 7 fills in K4's launches
    ticks, chunks = st_k.decode_steps, st_k.prefill_chunks
    # per step: layer 0's first norm alone, then 2 fused add + norms a
    # layer (the second norm; the next first norm or ln_f)
    want = {"paged_attention": full.num_layers * ticks,
            "rmsnorm": ticks + chunks,
            "add_rmsnorm": 2 * full.num_layers * (ticks + chunks),
            "sedov_stencil": 0, "flash_attention": 0}
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != {want}")
    for r, q_ in zip(st_k.results, reqs):
        if len(r.tokens) != q_.max_new_tokens or \
                not all(0 <= t < full.vocab_size for t in r.tokens):
            raise AssertionError(f"request {r.rid}: {len(r.tokens)} tokens, "
                                 f"range {min(r.tokens)}..{max(r.tokens)}")
    # teacher forcing: the kernel run again (``_teacher_forced_run``), and
    # every fused add + norm call held as phase 2 holds it
    gather_step = build_decode_step_slots_paged(eng_k.model, use_kernel=False)
    noisy_step = build_decode_step_slots_paged(eng_k.model, use_kernel=True)
    kernel_step = eng_k._decode
    fused = ops.add_rmsnorm
    noise = torch.Generator(device="cuda").manual_seed(0)
    k2_held = []                 # one record per fused add + norm call

    def held_norm(x, a, w, eps=1e-6, *, norm_of_rounded):
        k2_held.append(_k2_hold(torch, ref, add_rmsnorm_cuda,
                                f"main path call {len(k2_held)}", x, a, w,
                                norm_of_rounded))
        return fused(x, a, w, eps, norm_of_rounded=norm_of_rounded)
    st_tf, tf, calls = _teacher_forced_run(
        torch, ref, ops, eng_k, reqs, gather_step, noisy_step, noise,
        held_norm)
    full_ticks = sum(t["live"] == len(reqs) for t in tf)
    same = [r.tokens for r in st_tf.results] == \
        [r.tokens for r in st_k.results]
    nl = full.num_layers
    print(f"[full] {card} teacher-forced, {len(tf)} ticks ({full_ticks} "
          f"with all {len(reqs)} slots live): K1 vs plain on the main "
          f"path's own inputs, {len(calls)} calls: max "
          f"{max(c['ratio'] for c in calls):.4g} of the two-rounding bound, "
          f"{max(c['ulps'] for c in calls):.3g} bf16 steps, "
          f"{max(c['abs'] for c in calls):.4g} abs, outputs changed "
          f"{min(t['frac'] for t in tf):.3g}..{max(t['frac'] for t in tf):.3g}"
          f" per tick; per layer, max share of the bound "
          f"{[round(max(c['ratio'] for c in calls[i::nl]), 3) for i in range(nl)]}"
          f" and max abs "
          f"{[round(max(c['abs'] for c in calls[i::nl]), 4) for i in range(nl)]}")
    print(f"[full] {card} teacher-forced logits, max |diff| / max |logit| "
          f"per tick: kernel vs gather "
          f"{[round(t['rel'], 4) for t in tf]}; control (gather with "
          f"one-step noise) vs gather {[round(t['ctrl'], 4) for t in tf]}; "
          f"{sum(t['flips'] for t in tf)} of {sum(t['live'] for t in tf)} "
          f"greedy picks differ, the gather path's own pick above the "
          f"kernel's by at most {max(t['gap'] for t in tf):.4g}; the rerun "
          f"repeats the counted run's streams: {same}")
    print(f"[full] {card} teacher-forced: every fused add + norm call held "
          f"as phase 2 holds it, {len(k2_held)} calls (decode ticks, "
          f"prefill chunks and the gather and control ticks beside them): "
          f"residual bitwise equal, norm within "
          f"{max(h['share'] for h in k2_held):.4f} of one bf16 step (max abs "
          f"{max(h['abs'] for h in k2_held):.4g}), two calls bitwise equal")
    k2f_err = max(k2f_err, *(h["abs"] for h in k2_held))
    _teacher_forced_gates("deepseek-7b main path", tf, calls, len(reqs))

    eng_g = make_engine(kv_kernel="gather")
    st_g = eng_g.run(reqs)
    mism = sum(a != b for rk, rg in zip(st_k.results, st_g.results)
               for a, b in zip(rk.tokens, rg.tokens))
    # where each request's two free-running streams part
    first_diff = [next((i for i, (a, b) in enumerate(zip(rk.tokens,
                                                         rg.tokens))
                        if a != b), None)
                  for rk, rg in zip(st_k.results, st_g.results)]
    print(f"[full] {card} 8 requests x 32 tokens (prompts "
          f"{sorted(int(n) for n in plens)}): {ticks} decode ticks, {chunks} "
          f"prefill chunks, launches {launches}; free-running kernel vs "
          f"gather: {mism} of {8 * 32} stream tokens differ, first at token "
          f"{first_diff} per request")
    del eng_g
    torch.cuda.empty_cache()

    # ---- 5. numbers ------------------------------------------------------
    dry.mark(5)
    flush_buf = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    k1 = _k1_numbers(torch, ref, paged_attention_cuda, card, "main path",
                     k1_main, flush)
    for what, case in (("1 slot x 4096", k1_long), ("2 slots", k1_two)):
        _k1_numbers(torch, ref, paged_attention_cuda, card, what, case, flush)

    k1_g12n = _k1_numbers(torch, ref, paged_attention_cuda, card,
                          "G=12 (mistral-large-123b widths)", k1_g12, flush)
    k1_new = {name: _k1_numbers(torch, ref, paged_attention_cuda, card,
                                what, case, flush)
              for name, what, case in (
                  ("stablelm-1.6b", "stablelm-1.6b widths (G=1, dh 64)",
                   k1_stablelm),
                  ("nemotron-4-340b", "nemotron-4-340b widths (G=12, dh "
                   "192)", k1_nemotron),
                  ("granite-moe-3b-a800m", "granite-moe-3b-a800m widths "
                   "(G=3, dh 64)", k1_granite),
                  ("dbrx-132b", "dbrx-132b widths (G=6, dh 128)", k1_dbrx))}

    def unfused(x, a, w, eps=1e-6, *, norm_of_rounded):
        """The residual add and the norm as the model launched them before
        the fused entry: the add (in f32, or in bf16), the norm kernel on
        the sum and, for the f32 sum, its rounding."""
        if norm_of_rounded:
            r = x + a
            return r, rmsnorm_cuda(r, w, eps=eps)
        s_ = x.float() + a.float()
        return s_.to(x.dtype), rmsnorm_cuda(s_, w, eps=eps, out_dtype=x.dtype)

    # K2 is far shorter than its host call: device time per call from a
    # CUDA graph of back-to-back calls (an empty kernel's launch in the
    # same harness is the floor), host time per call beside it
    k2, k2f = {}, {}
    rms_norm = getattr(torch.nn.functional, "rms_norm", None)
    floor = _graph_ms(torch, empty_cuda, 100)
    # deepseek-7b's width, granite-moe-3b-a800m's as its tick calls it, and
    # llava-next-34b's decode step and prefill (phase 16)
    d_gr = get_config("granite-moe-3b-a800m").d_model
    for rows, dk in ((8, d), (40, d), (128, d), (8, d_gr)) + \
            K2_VLM_SHAPES + K2_ZAMBA_SHAPES:
        x = torch.randn((rows, dk), device="cuda").to(torch.bfloat16)
        a = torch.randn((rows, dk), device="cuda").to(torch.bfloat16)
        wk = w if dk == d else \
            (1 + 0.1 * torch.randn(dk, device="cuda")).to(torch.bfloat16)
        fns = {"ms": lambda: rmsnorm_cuda(x, wk),
               "plain": lambda: ref.rmsnorm_ref(x, wk)}
        if rms_norm:
            fns["lib"] = lambda: rms_norm(x, (dk,), wk, 1e-6)
        shape = (rows, dk)
        k2[shape] = {k: _graph_ms(torch, fn, 100) for k, fn in fns.items()}
        k2[shape].setdefault("lib", None)
        k2[shape]["host"] = _events_ms(torch, fns["ms"], 200)
        k2[shape]["bound"] = max(
            (2 * rows * dk * 2 + dk * 2) / HBM_BYTES_PER_S,
            4 * rows * dk / F32_FLOPS) * 1e3
        # the fused entry: x and a read, r and y written, w read
        f = {}
        for rounded in (False, True):
            ffns = {"ms": lambda: add_rmsnorm_cuda(
                        x, a, wk, norm_of_rounded=rounded),
                    "plain": lambda: ref.add_rmsnorm_ref(
                        x, a, wk, norm_of_rounded=rounded),
                    "chain": lambda: unfused(x, a, wk,
                                             norm_of_rounded=rounded)}
            f[rounded] = {k: _graph_ms(torch, fn, 100)
                          for k, fn in ffns.items()}
            f[rounded]["host"] = _events_ms(torch, ffns["ms"], 200)
        k2f[shape] = dict(f[True], bound=max(
            (4 * rows * dk * 2 + dk * 2) / HBM_BYTES_PER_S,
            5 * rows * dk / F32_FLOPS) * 1e3)
        print(f"[numbers] {card} rmsnorm ({rows}, {dk}) bf16, device ms per "
              f"call in a CUDA graph: kernel {k2[shape]['ms']:.5f} ms, plain "
              f"{k2[shape]['plain']:.5f} ms, F.rms_norm {k2[shape]['lib']} ms, "
              f"bound {k2[shape]['bound']:.5f} ms, empty kernel {floor:.5f} "
              f"ms; kernel call back to back from the host "
              f"{k2[shape]['host']:.5f} ms")
        for rounded in (False, True):
            g = f[rounded]
            print(f"[numbers] {card} add_rmsnorm ({rows}, {dk}) bf16, "
                  f"norm_of_rounded={rounded}, device ms per call in a CUDA "
                  f"graph: kernel {g['ms']:.5f} ms ({g['ms'] / floor:.3f}x "
                  f"the empty kernel's {floor:.5f}), bound "
                  f"{k2f[shape]['bound']:.5f} ms ({k2f[shape]['bound'] / g['ms']:.4f}"
                  f" of it), plain {g['plain']:.5f} ms, the unfused chain it "
                  f"replaces (add, norm kernel{'' if rounded else ', cast'}) "
                  f"{g['chain']:.5f} ms; kernel call back to back from the "
                  f"host {g['host']:.5f} ms")

    # decode tick / chunk step at full width on a pool mid-generation
    pool = eng_k.make_pool()
    for i, n in enumerate(main_lens):
        slot = pool.alloc()
        pool.reserve_prefix(slot, n)
        pool.set_length(slot, n - 1)
    pool.cache["index"].copy_(torch.as_tensor(pool.lengths, dtype=torch.int32))
    tok = torch.ones((8, 1), dtype=torch.int32, device="cuda")
    act = torch.ones((8,), dtype=torch.int32, device="cuda")
    pages = torch.as_tensor(pool.page_table, device="cuda")
    ctoks = torch.ones((1, eng_k.prefill_chunk), dtype=torch.int32,
                       device="cuda")
    row = pages[0].contiguous()

    def tick():
        return eng_k.decode_fn(pool.cache, tok, act, pages)

    def chunk():
        return eng_k.chunk_fn(pool.cache, ctoks, 0, 0, eng_k.prefill_chunk,
                              eng_k.prefill_chunk, row)
    tick_k = _events_ms(torch, tick, 20)
    tick_g = _events_ms(torch, lambda: gather_step(
        eng_k.params, pool.cache, tok, act, pages), 20)
    chunk_ms = _events_ms(torch, chunk, 20)
    prof = {}
    for label in ("fused", "unfused"):
        ops.add_rmsnorm = fused if label == "fused" else unfused
        try:
            prof[label] = (
                _profile_ticks(torch, card, f"decode tick, {label} add + norm",
                               tick, n=5),
                _profile_ticks(torch, card, f"chunk step, {label} add + norm",
                               chunk, n=3))
        finally:
            ops.add_rmsnorm = fused
    (pt, pc), (ut, uc) = prof["fused"], prof["unfused"]
    print(f"[numbers] {card} launches per decode tick {pt['kernels']:g} "
          f"kernels + {pt['copies']:g} copies (unfused add + norm: "
          f"{ut['kernels']:g} + {ut['copies']:g}); per chunk step "
          f"{pc['kernels']:g} + {pc['copies']:g} (unfused: {uc['kernels']:g} "
          f"+ {uc['copies']:g}); device busy per tick "
          f"{pt.get('busy_ms', float('nan')):.3f} ms (unfused "
          f"{ut.get('busy_ms', float('nan')):.3f})")
    # end to end, the fused and the unfused add + norm in turns
    e2e = {"fused": [], "unfused": []}
    for label in ("fused", "unfused", "unfused", "fused"):
        ops.add_rmsnorm = fused if label == "fused" else unfused
        try:
            st_warm = eng_k.run(reqs)
        finally:
            ops.add_rmsnorm = fused
        e2e[label].append(st_warm.tokens_per_s)
    print(f"[numbers] {card} deepseek-7b decode tick (8 slots, "
          f"{sum(main_lens)} held tokens): {tick_k:.3f} ms with the kernel, "
          f"{tick_g:.3f} ms gather; chunked-prefill step "
          f"({eng_k.prefill_chunk} tokens): {chunk_ms:.3f} ms; end to end "
          f"{st_warm.generated_tokens} tokens in {st_warm.wall_s:.3f} s = "
          f"{st_warm.tokens_per_s:.1f} tokens/s ({st_warm.decode_steps} ticks, "
          f"{st_warm.prefill_chunks} chunks); in turns (fused, unfused, "
          f"unfused, fused): fused {[round(v, 2) for v in e2e['fused']]}, "
          f"unfused {[round(v, 2) for v in e2e['unfused']]} tokens/s; peak "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    host = _host_us_per_call(torch, layers, full)
    print(f"[numbers] {card} host us per call under no_grad, in turns "
          f"(one path, the expression it replaced): SiLU Function "
          f"{host['silu'][0]:.2f} vs {host['silu'][1]:.2f} at (8, 1, "
          f"{full.d_ff}), {full.num_layers} calls a tick = "
          f"{full.num_layers * (host['silu'][0] - host['silu'][1]) / 1e3:.4f}"
          f" ms more; the embedding by indexing {host['embed'][0]:.2f} vs "
          f"index_select {host['embed'][1]:.2f}, 1 call a tick")

    # ---- 6. the stencil against its plain version ------------------------
    dry.mark(6)
    grids = (1, 2, 3, 5, 8, 13, 16, 24, 32, 33, 64, 70, 100, LULESH_GRID)
    k4_err, k4_rel, ten = _stencil_checks(np, lulesh, ref, sedov_step_cuda,
                                          grids, (16, 70, LULESH_GRID))
    print(f"[kernels] sedov_stencil vs plain, developed and rough states, one "
          f"step at n = {grids} and ten at n = {tuple(ten)}: every zone of "
          f"every field within rtol {STENCIL_ELEM_RTOL} (max abs "
          f"{k4_err:.4g}); one step max scale-relative error {k4_rel:.4g} "
          f"(limit {STENCIL_TOL_1}); ten kernel steps vs ten oracle steps: "
          f"{ {n: round(max(e.values()), 10) for n, e in ten.items()} } "
          f"(limit {STENCIL_TOL_10})")

    # ---- 7. the LULESH path at full size ---------------------------------
    dry.mark(7)
    iters, n = LULESH_ITERS, LULESH_GRID
    cmd = (f"ch-run -b ./data:/data lulesh.dash -- /built/lulesh.dash "
           f"-i {iters} -s {n}")
    app = AppSpec(arch="lulesh-dash", shape="train_4k",
                  run=f"lulesh -i {iters} -s {n}")
    easey = []
    with tempfile.TemporaryDirectory(prefix="easey_") as storage:
        for run_i in range(2):                 # the first run is warm-up
            job = lulesh_example()
            job["execution"][0]["mpi"]["command"] = cmd
            spec = parse_jobspec(job)
            root = Path(storage) / f"run{run_i}"
            reset_counts()
            (mw, jid, res), wall_s = _timed(run_easey, app, "nvidia:h100",
                                            spec, storage=root)
            got_counts = counts()
            state = mw.status(jid)
            if state is not JobState.FINISHED:
                raise AssertionError(f"EASEY run {run_i}: job {state.value}"
                                     f":\n{mw.logs(jid)[1]}")
            want = {"paged_attention": 0, "rmsnorm": 0, "add_rmsnorm": 0,
                    "sedov_stencil": iters, "flash_attention": 0}
            if got_counts != want:
                raise AssertionError(f"EASEY run {run_i}: kernel launches "
                                     f"{got_counts} != {want}")
            workdir = root / "cluster" / spec.job_id
            if f"srun --ntasks=2197 {cmd}" not in \
                    (workdir / "batch.sh").read_text():
                raise AssertionError("batch.sh lacks the job's command")
            pkgs = list((root / "packages").glob("*.easey.tar"))
            if len(pkgs) != 1:
                raise AssertionError(f"packages written: {pkgs}")
            manifest = extract_package(pkgs[0], workdir / "check")
            if (res.plan.kernels, set(res.built), manifest["step"]) != \
                    ("cuda", {"sedov_stencil"}, "sedov_step"):
                raise AssertionError(f"build: kernels {res.plan.kernels}, "
                                     f"built {res.built}, step "
                                     f"{manifest['step']}")
            out = mw.scheduler.result(jid)[0]
            if (out["device"], out["kernels"]) != ("cuda", "cuda"):
                raise AssertionError(f"ran on {out['device']} with "
                                     f"{out['kernels']}")
            easey.append(out)
            print(f"[lulesh] {card} run_easey {run_i} "
                  f"({'warm-up' if run_i == 0 else 'measured'}): "
                  f"{state.value}, {got_counts['sedov_stencil']} stencil "
                  f"launches, build {res.timings.get('build_s', 0.0):.2f} s, "
                  f"run {out['seconds']:.4f} s, FOM {out['fom']:.1f} "
                  f"zone-iterations/s, whole deployment {wall_s:.2f} s")
    launches["sedov_stencil"] = got_counts["sedov_stencil"]
    fin = easey[-1]["state"]
    del easey[0]["state"]
    # the reference's blast-wave checks (tests/test_models_smoke.py)
    if not all(bool(torch.isfinite(fin[f]).all()) for f in ("rho", "e", "v")):
        raise AssertionError("non-finite LULESH state")
    if not (float(fin["e"][1, 0, 0]) > 1e3 and
            float((fin["rho"] - 1.0).abs().max()) > 1e-3 and
            float(fin["t"]) > 0):
        raise AssertionError(f"blast wave: e[1,0,0] {float(fin['e'][1, 0, 0])}"
                             f", max |rho - 1| "
                             f"{float((fin['rho'] - 1.0).abs().max())}, t "
                             f"{float(fin['t'])}")
    # how far the wave has gone along each axis: the last plane with v != 0
    moving = (fin["v"] != 0).any(0)
    reach = [int(m.nonzero().max()) for m in (
        moving.any(2).any(1), moving.any(2).any(0), moving.any(1).any(0))]
    # the kernel on the developed full-size state, and the whole run
    # against as many plain fused steps, zone by zone
    dt = ref.cfl_dt(fin)
    k4_err = max(k4_err, _hold_zones(
        f"sedov_stencil n={n} after {iters} steps, one step",
        sedov_step_cuda(fin, dt), ref.sedov_step_ref(fin, dt)))
    fused_fin = _fused_run(ref, lulesh.init_state(lulesh.LuleshConfig(
        grid=n), "cuda"), iters)
    k4_err = max(k4_err, _hold_zones(
        f"{iters} kernel steps vs {iters} plain fused steps", fin, fused_fin))
    del fused_fin
    print(f"[lulesh] {card} final state after {iters} steps on {n}^3: "
          f"finite, e[1,0,0] {float(fin['e'][1, 0, 0]):.6g}, max |rho - 1| "
          f"{float((fin['rho'] - 1.0).abs().max()):.6g}, t "
          f"{float(fin['t']):.6g}, v != 0 up to index {reach} along axes "
          f"0/1/2 (tiles 16 x 32 over axes 1/2, chunks of 64 planes); equal to {iters} plain fused steps "
          f"and one more kernel step equal to the plain one, every zone "
          f"within rtol {STENCIL_ELEM_RTOL}")

    # ---- 8. LULESH numbers -----------------------------------------------
    dry.mark(8)
    cfg = lulesh.LuleshConfig(grid=n)
    zones = n ** 3
    dt = ref.cfl_dt(fin)
    k4_ms = _events_ms(torch, lambda: sedov_step_cuda(fin, dt), 50)
    k4_plain = _events_ms(torch, lambda: ref.sedov_step_ref(fin, dt), 10)
    cfl_ms = _events_ms(torch, lambda: ref.cfl_dt(fin), 50)
    # five fields read and five written (dt, t in and t out beside them)
    k4_bytes = 10 * 4 * zones + 3 * 4
    k4_flops = STENCIL_FLOPS_PER_ZONE * zones
    k4_bound = max(k4_bytes / HBM_BYTES_PER_S, k4_flops / F32_FLOPS) * 1e3
    # rho, e and v read once; p 2, 1/rho-clamp 2, GAMMA p 1, sqrt 1,
    # |v|^2 5, sqrt 1, sums 2, max 1 operations per zone
    cfl_bytes = 5 * 4 * zones + 4
    cfl_bound = max(cfl_bytes / HBM_BYTES_PER_S,
                    15 * zones / F32_FLOPS) * 1e3
    print(f"[numbers] {card} sedov_stencil at {n}^3 (CUDA events, back to "
          f"back): kernel {k4_ms:.4f} ms, bound {k4_bound:.4f} ms "
          f"({k4_bytes / 1e6:.1f} MB), {k4_bound / k4_ms:.3f} of the bound; "
          f"plain fused step {k4_plain:.4f} ms; cfl_dt {cfl_ms:.4f} ms, "
          f"bound {cfl_bound:.4f} ms")

    def direct(state):
        out = lulesh.run(state, cfg, iters, use_kernel=True)
        torch.cuda.synchronize()
        return out
    fom_direct = []
    for _ in range(2):
        # the state is built before the clock starts, as run_command does
        state = lulesh.init_state(cfg, "cuda")
        torch.cuda.synchronize()
        _, secs = _timed(direct, state)
        fom_direct.append(lulesh.fom(zones, iters, secs))
    del state
    fom_easey = easey[-1]["fom"]
    step_ms = zones / fom_direct[0] * 1e3
    delta = fom_easey / fom_direct[0] - 1.0
    print(f"[numbers] {card} LULESH {n}^3 x {iters} steps: run "
          f"{step_ms:.4f} ms per step; FOM direct (lulesh.run) "
          f"{fom_direct[0]:.1f}, again {fom_direct[1]:.1f}; through "
          f"run_easey {fom_easey:.1f}; EASEY vs direct {delta:+.4%}")
    plain_fin = lulesh.run(lulesh.init_state(cfg, "cuda"), cfg, iters)
    drift = _rel_err(fin, plain_fin)
    print(f"[numbers] {card} {iters}-step kernel state vs {iters}-step plain "
          f"state, scale-relative: "
          f"{ {f: float(f'{e:.4g}') for f, e in drift.items()} }")
    del fin, plain_fin

    # ---- 9. flash attention against its plain version -------------------
    dry.mark(9)
    # the steps hold phase 4's model, whose per-layer views hold its weights
    del eng_k, pool, kernel_step, gather_step, noisy_step
    torch.cuda.empty_cache()
    k3_err = _flash_checks(torch, ref, flash_attention_cuda)
    print(f"[kernels] flash_attention vs plain at {len(FLASH_CASES)} shapes "
          f"(f32 and bf16, causal and not, GQA/MQA, s != t, ragged) and "
          f"{len(FLASH_TWINS)} bf16 twins of the f32 ones, kv_len t/4 and "
          f"0: max abs err {k3_err:.4g} (tol {FLASH_TOL}; twins one bf16 "
          f"step); kv_len 0 exact zeros; keys past kv_len invisible bit for "
          f"bit")
    flash_attention_cuda.tensor_core_launches = 0
    k3 = {name: _flash_full(torch, ref, flash_attention_cuda, card, *shape)
          for name, shape in FLASH_FULL.items()}
    k3_tc = flash_attention_cuda.tensor_core_launches
    if k3_tc == 0:
        raise AssertionError("the full-width calls ran no tensor-core launch")
    k3_err = max(k3_err, *(r["err"] for r in k3.values()))

    # ---- 10. the kernel bench: the flash kernel's own path ---------------
    dry.mark(10)
    bench_rows = []
    reset_counts()
    bench.run(lambda name, us, note: bench_rows.append((name, us, note)))
    bench_counts = counts()
    for name, us, note in bench_rows:
        print(f"[bench] {card} {name} {us:.2f} us ({note})")
    if bench_counts["flash_attention"] == 0:
        raise AssertionError("the kernel bench launched no flash kernel")
    print(f"[bench] launches during the bench: {bench_counts}")

    # ---- 11. sampling, speculation and the contiguous layout -------------
    dry.mark(11)
    pico = ServeEngine(arch="picolm-4-smoke", num_slots=4, max_len=128,
                       seed=0, log=quiet)
    rtrace = repetitive_trace(12, 4, seed=0)
    reset_counts()
    spec_off = pico.run(rtrace, spec_k=0, prefill_chunk=0)
    off_k1 = counts()["paged_attention"]
    spec_on = pico.run(rtrace, spec_k=4, prefill_chunk=0)
    if [r.tokens for r in spec_on.results] != \
            [r.tokens for r in spec_off.results]:
        raise AssertionError("picolm-4-smoke: spec-on streams differ from "
                             "spec-off")
    if pico.kv_kernel != "cuda" or \
            off_k1 != pico.cfg.num_layers * spec_off.decode_steps:
        raise AssertionError(f"spec-off decode ticks: {off_k1} paged "
                             f"kernel launches for {spec_off.decode_steps} "
                             f"ticks ({pico.kv_kernel})")
    print(f"[smoke] picolm-4-smoke, 12 repetitive requests x 48: spec off "
          f"{spec_off.decode_steps} decode ticks ({off_k1} paged-kernel "
          f"launches), spec_k=4 {spec_on.decode_steps} ticks, "
          f"{spec_on.accepted_per_verify:.4f} tokens per verify; streams "
          f"equal")
    tight = dict(target="bench:serve-tight", num_slots=8, max_len=128,
                 seed=0, log=quiet)
    eng_c = ServeEngine(arch="deepseek-7b-smoke", kv_layout="contiguous",
                        **tight)
    eng_p = ServeEngine(arch="deepseek-7b-smoke", kv_kernel="cuda", **tight)
    for policy, steps in (("static", 93), ("continuous", 63)):
        sc = eng_c.run(trace, policy=policy, prefill_chunk=0)
        sp = eng_p.run(trace, policy=policy, prefill_chunk=0)
        if [r.tokens for r in sc.results] != [r.tokens for r in sp.results]:
            raise AssertionError(f"contiguous streams differ from paged "
                                 f"({policy})")
        if sc.decode_steps != steps:
            raise AssertionError(f"contiguous {policy}: {sc.decode_steps} "
                                 f"decode steps != {steps}")
    print(f"[smoke] deepseek-7b-smoke contiguous ({eng_c.num_slots} slots, "
          f"gather) == paged (kernel) streams, static and continuous; 93 and "
          f"63 decode steps")
    scarce = ServeEngine(arch="deepseek-7b-smoke", target="local:cpu",
                         kv_kernel="cuda", num_slots=4, max_len=64,
                         page_size=8, num_pages=13, seed=0, log=quiet)
    roomy = ServeEngine(arch="deepseek-7b-smoke", target="local:cpu",
                        kv_kernel="cuda", num_slots=4, max_len=64, seed=0,
                        log=quiet)
    strace = zipf_trace(12, smoke.vocab_size, max_prompt=24, max_new=32,
                        seed=3, **SAMPLED)
    s_scarce, s_roomy = scarce.run(strace), roomy.run(strace)
    if s_scarce.preemptions == 0 or s_roomy.preemptions:
        raise AssertionError(f"preemptions {s_scarce.preemptions} (scarce) "
                             f"and {s_roomy.preemptions} (roomy)")
    if [r.tokens for r in s_scarce.results] != \
            [r.tokens for r in s_roomy.results]:
        raise AssertionError("sampled streams change under preemption")
    greedy = roomy.run(zipf_trace(12, smoke.vocab_size, max_prompt=24,
                                  max_new=32, seed=3))
    if [r.tokens for r in greedy.results] == \
            [r.tokens for r in s_roomy.results]:
        raise AssertionError("the sampled trace drew the greedy streams")
    print(f"[smoke] sampled trace ({SAMPLED}): equal streams with "
          f"{s_scarce.preemptions} preemptions and without")
    del pico, eng_c, eng_p, scarce, roomy
    torch.cuda.empty_cache()

    eng_s = make_engine(spec_k=4)
    sreqs = [dataclasses.replace(r, **SAMPLED) for r in reqs]
    reset_counts()
    st_s = eng_s.run(sreqs)
    s_counts = counts()
    for r in st_s.results:
        if len(r.tokens) != 32 or \
                not all(0 <= t < full.vocab_size for t in r.tokens):
            raise AssertionError(f"sampled spec request {r.rid}: "
                                 f"{len(r.tokens)} tokens")
    steps = st_s.decode_steps + st_s.prefill_chunks
    want = {"paged_attention": 0, "sedov_stencil": 0, "flash_attention": 0,
            "rmsnorm": steps, "add_rmsnorm": 2 * full.num_layers * steps}
    if s_counts != want:
        raise AssertionError(f"sampled spec run launches {s_counts} != {want}")
    print(f"[full] {card} deepseek-7b, 8 sampled requests x 32 "
          f"({SAMPLED}), spec_k=4: {st_s.decode_steps} decode ticks, all "
          f"verify ticks ({st_s.spec_verify_steps} slot verifies), "
          f"{st_s.accepted_per_verify:.4f} tokens per verify "
          f"({st_s.spec_accepted_tokens}/{st_s.spec_drafted_tokens} drafts "
          f"accepted), {st_s.prefill_chunks} prefill chunks, "
          f"{st_s.generated_tokens} tokens in {st_s.wall_s:.3f} s = "
          f"{st_s.tokens_per_s:.1f} tokens/s (first run, not warmed); "
          f"launches {s_counts}")
    del eng_s
    torch.cuda.empty_cache()

    # ---- 12. the router and the prefix cache at full width --------------
    dry.mark(12)
    t12 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    eng_r = ServeEngine(arch="deepseek-7b", replicas=3, num_slots=8,
                        max_len=512, seed=0, log=quiet)
    if (eng_r.num_pages, eng_r.page_size, eng_r.prefill_chunk,
            eng_r.kv_kernel) != (257, 16, 128, "cuda"):
        raise AssertionError(f"3-replica engine: {eng_r.num_pages} pages x "
                             f"{eng_r.page_size}, chunk "
                             f"{eng_r.prefill_chunk}, {eng_r.kv_kernel}")
    if _weights_sig(eng_r) != p4_sig:
        raise AssertionError("the 3-replica engine's weights differ from "
                             "phase 4's")
    # the engine's own memory (its construction peaks on f32 draws); the
    # serving runs' peak is read from here on
    mem_built = torch.cuda.memory_allocated()
    peak_built = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    pool_bytes = eng_r.num_pages * eng_r.page_size * kv_bytes_per_token(full)
    n12 = 48        # two fleet-fulls of 24 slots: later waves find heads

    def trace12():
        return sharedprefix_trace(n12, full.vocab_size, n_heads=4,
                                  head_len=256, max_suffix=64, max_new=16,
                                  seed=0)
    fleet = ReplicaRouter([eng_r] * 3, policy="prefix_affinity", log=quiet)
    fleet.run(trace12(), prefix_cache=True)                  # warm-up
    # where a run's host time goes: inside the decode and chunk steps
    # (launching their kernels; the device runs behind), and the rest
    # (router, scheduler, the sampler's wait for each tick's logits)
    inside = {}

    def host_timed(name, step):
        def timed(*args):
            t0 = time.perf_counter()
            out = step(*args)
            inside[name] = inside.get(name, 0.0) + time.perf_counter() - t0
            return out
        return timed
    steps_r = eng_r._decode, eng_r._chunk
    eng_r._decode = host_timed("decode", steps_r[0])
    eng_r._chunk = host_timed("chunk", steps_r[1])
    runs, r_counts, r_inside = {}, {}, {}
    tr12 = serving.Tracer()          # the cached run is traced
    try:
        for cached in (False, True):
            inside.clear()
            reset_counts()
            runs[cached] = fleet.run(trace12(), prefix_cache=cached,
                                     tracer=tr12 if cached else None)
            r_counts[cached] = counts()
            r_inside[cached] = dict(inside)
    finally:
        eng_r._decode, eng_r._chunk = steps_r
    nl = full.num_layers
    asks = {r.rid: r.max_new_tokens for r in trace12()}
    for cached, s in runs.items():
        if len(s.results) != n12 or any(
                len(r.tokens) != asks[r.rid] or
                not all(0 <= x < full.vocab_size for x in r.tokens)
                for r in s.results):
            raise AssertionError(f"phase 12 (cache {cached}): "
                                 f"{len(s.results)} of {n12} requests done")
        ticks = sum(x.decode_steps for x in s.replica_stats)
        steps = ticks + s.prefill_chunks
        want = {"paged_attention": nl * ticks, "rmsnorm": steps,
                "add_rmsnorm": 2 * nl * steps, "sedov_stencil": 0,
                "flash_attention": 0}
        if r_counts[cached] != want:
            raise AssertionError(f"phase 12 (cache {cached}) launches "
                                 f"{r_counts[cached]} != {want}")
    cold, hot = runs[False], runs[True]
    parted = [(r.rid, next(i for i, (a, b) in enumerate(zip(r.tokens,
                                                            c.tokens))
                           if a != b))
              for r, c in zip(hot.results, cold.results)
              if r.tokens != c.tokens]
    if parted:
        raise AssertionError(f"full-width streams with the prefix cache on "
                             f"and off part (rid, token): {parted}")
    if not (hot.prefix_hits > 0 and hot.prefill_tokens_saved > 0 and
            hot.prefill_chunks < cold.prefill_chunks):
        raise AssertionError(f"prefix cache: {hot.prefix_hits} hits, "
                             f"{hot.prefill_tokens_saved} tokens saved, "
                             f"{hot.prefill_chunks} chunk steps against "
                             f"{cold.prefill_chunks} cold")
    # the traced cached run keeps the untraced cached run's schedule:
    # 124 decode ticks, 108 chunk steps, 45 rounds
    hot_counts = (sum(x.decode_steps for x in hot.replica_stats),
                  hot.prefill_chunks,
                  max(x.decode_steps for x in hot.replica_stats))
    if hot_counts != (124, 108, 45):
        raise AssertionError(f"traced cached run: (ticks, chunk steps, "
                             f"rounds) {hot_counts} != (124, 108, 45)")
    tel12 = _trace_checks(serving, tr12, hot, Path(tempfile.mkdtemp(
        prefix="chip_smoke_trace_")))
    ll = ReplicaRouter([eng_r] * 3, policy="least_loaded", log=quiet).run(
        reqs)
    if _streams(ll) != p4_streams:
        raise AssertionError("least_loaded x3 streams differ from phase 4's "
                             "single engine")
    t12 = time.perf_counter() - t12
    for label, s in (("cold", cold), ("cached", hot)):
        ins = r_inside[label == "cached"]
        print(f"[router] {card} deepseek-7b x3 replicas (one card, "
              f"{pool_bytes / 1e9:.3f} GB of KV pool per replica), "
              f"prefix_affinity, {n12} shared-prefix requests (4 heads of "
              f"256 tokens), cache {label}: {s.generated_tokens} tokens in "
              f"{s.wall_s:.3f} s = {s.tokens_per_s:.2f} tokens/s, "
              f"{max(x.decode_steps for x in s.replica_stats)} rounds, "
              f"{sum(x.decode_steps for x in s.replica_stats)} decode ticks, "
              f"{s.prefill_chunks} chunk steps, mean TTFT "
              f"{s.mean_ttft_steps:.4f} vsteps, {s.prefix_hits} hits / "
              f"{s.prefix_misses} misses, {s.prefill_tokens_saved} prefill "
              f"tokens saved, replicas {sorted(set(s.replica_of.values()))};"
              f" launches {r_counts[label == 'cached']}; host inside decode "
              f"steps {ins['decode']:.3f} s, inside chunk steps "
              f"{ins['chunk']:.3f} s, the rest "
              f"{s.wall_s - sum(ins.values()):.3f} s")
    print(f"[router] {card} cached == cold streams ({n12} requests, "
          f"{sum(asks.values())} tokens); "
          f"least_loaded x3 over phase 4's 8 requests: streams equal the "
          f"single engine's ({ll.tokens_per_s:.2f} tokens/s, "
          f"{max(x.decode_steps for x in ll.replica_stats)} rounds); phase "
          f"12 took {t12:.1f} s; memory allocated before it "
          f"{mem0 / 1e9:.1f} GB, with the engine built {mem_built / 1e9:.1f}"
          f" GB (construction's peak {peak_built / 1e9:.1f} GB), the "
          f"serving runs' peak {torch.cuda.max_memory_allocated() / 1e9:.1f}"
          f" GB")
    print(f"[router] {card} the cached run traced: {tel12['spans']} spans "
          f"({', '.join(tel12['phases'])}), {tel12['ring']} ring events, "
          f"Chrome trace {tel12['bytes']} bytes / {tel12['events']} events, "
          f"byte-identical serialized twice, processes {tel12['pids']}; "
          f"ticks, chunk steps, rounds {hot_counts} as untraced; "
          f"metrics keys = ROUTER_SCHEMA's")
    router_k1 = r_counts[True]["paged_attention"]
    # the steps' model holds per-layer views of the engine's weights
    del eng_r, fleet, runs, cold, hot, ll, steps_r
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 13. the serving app through EASEY at full width ----------------
    dry.mark(13)
    t13 = time.perf_counter()
    mem13 = []              # (what, GB allocated after it, its peak GB)

    def mark13(what):
        gc.collect()
        torch.cuda.empty_cache()
        mem13.append((what, round(torch.cuda.memory_allocated() / 1e9, 1),
                      round(torch.cuda.max_memory_allocated() / 1e9, 1)))
        torch.cuda.reset_peak_memory_stats()
    mark13("before phase 13")
    work13 = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_"))
    serve_kw = dict(kv_layout="paged", batch=8, max_len=512, requests=8,
                    prefill_len=256, decode_tokens=32, log=quiet)
    cmd13 = ("serve --arch deepseek-7b --kv-layout paged --batch 8 "
             "--max-len 512 --requests 8 --prefill 256 --decode 32 "
             "--trace-out trace.json --metrics-out metrics.json "
             "--prom-out metrics.prom")
    app13 = parse_appfile(f"FROM arch:deepseek-7b\nSHAPE decode_32k\n"
                          f"###include_local_kernels###\nRUN {cmd13}\n")
    spec13 = parse_jobspec({"job": {"name": "serve-deepseek-7b"},
                            "execution": [{"serial": {"command": cmd13}}]})
    reset_counts()
    (mw13, jid13, res13), easey_s = _timed(run_easey, app13, "nvidia:h100",
                                           spec13, storage=work13)
    easey_counts = counts()
    if mw13.status(jid13) is not JobState.FINISHED:
        raise AssertionError(f"serving job {mw13.status(jid13).value}: "
                             f"{mw13.logs(jid13)[1][-3000:]}")
    if (res13.step_name, res13.program["arch"], sorted(res13.built)) != \
            ("decode_step", "sm_90a", ["paged_attention", "rmsnorm"]) or \
            not all(_build.library_path(n).exists() for n in res13.built):
        raise AssertionError(f"serving build: {res13.step_name}, "
                             f"{res13.program['arch']}, built {res13.built}")
    out13 = mw13.scheduler.result(jid13)[0]
    st13 = out13["stats"]
    ticks13, chunks13 = st13.decode_steps, st13.prefill_chunks
    want = {"paged_attention": nl * ticks13, "rmsnorm": ticks13 + chunks13,
            "add_rmsnorm": 2 * nl * (ticks13 + chunks13),
            "sedov_stencil": 0, "flash_attention": 0}
    if (out13["kv_kernel"], easey_counts) != ("cuda", want):
        raise AssertionError(f"EASEY serve ({out13['kv_kernel']}): launches "
                             f"{easey_counts} != {want}")
    if len(st13.results) != 8 or any(
            len(r.tokens) != 32 or
            not all(0 <= x < full.vocab_size for x in r.tokens)
            for r in st13.results):
        raise AssertionError("EASEY serve: not every request complete")
    job13 = work13 / "cluster" / spec13.job_id
    trace13 = json.loads((job13 / "trace.json").read_text())
    metrics13 = json.loads((job13 / "metrics.json").read_text())
    prom13 = (job13 / "metrics.prom").read_text()
    spans13 = [ev for ev in trace13["traceEvents"] if ev["ph"] == "X"]
    per_phase = {}
    for ev in spans13:
        per_phase.setdefault(ev["name"], []).append(ev["args"]["rid"])
    rids = sorted(r.rid for r in st13.results)
    # the phases this run goes through: each request queued once, its
    # prompt in chunks, one decode span; no preemption, cache or spec
    if set(per_phase) != {"queued", "prefill_chunk", "decode"} or \
            sorted(per_phase["queued"]) != rids or \
            sorted(per_phase["decode"]) != rids or \
            sorted(set(per_phase["prefill_chunk"])) != rids or \
            len(per_phase["prefill_chunk"]) != chunks13:
        raise AssertionError(f"EASEY serve trace spans: "
                             f"{ {k: len(v) for k, v in per_phase.items()} }")
    if metrics13["serve_decode_steps"] != ticks13 or \
            metrics13["serve_requests_completed"] != 8 or \
            "# TYPE serve_generated_tokens counter" not in prom13:
        raise AssertionError("EASEY serve metrics files")
    easey_streams = _streams(st13)
    easey_tps = st13.tokens_per_s
    built13 = dict(res13.built)
    del mw13, res13, out13, st13
    mark13("deepseek-7b EASEY job")
    plain13 = serve_main(arch="deepseek-7b", **serve_kw)
    if _streams(plain13["stats"]) != easey_streams:
        raise AssertionError("the EASEY-deployed serve streams differ from "
                             "the same serve_main call untraced")
    print(f"[easey-serve] {card} run_easey(deepseek-7b serving Appfile, "
          f"nvidia:h100): build {built13} for {_build.ARCH}, job "
          f"finished in {easey_s:.1f} s with the build and the engine; "
          f"{ticks13} decode ticks, {chunks13} prefill chunks, launches "
          f"{easey_counts}; trace {len(spans13)} spans "
          f"({ {k: len(v) for k, v in per_phase.items()} }), "
          f"{len(metrics13)} metrics, Prometheus {len(prom13)} bytes; "
          f"streams equal the untraced serve_main call; tokens/s traced "
          f"{easey_tps:.2f}, untraced {plain13['decode_tok_per_s']:.2f} (not "
          f"gated)")
    del plain13
    mark13("deepseek-7b serve_main")

    st_cfg = get_config("stablelm-1.6b")
    reset_counts()
    out_st = serve_main(arch="stablelm-1.6b",
                        trace_out=str(work13 / "stablelm_trace.json"),
                        **serve_kw)
    st_counts = counts()
    st_stats = out_st["stats"]
    want = {"paged_attention": st_cfg.num_layers * st_stats.decode_steps,
            "rmsnorm": 0, "add_rmsnorm": 0, "sedov_stencil": 0,
            "flash_attention": 0}
    if (out_st["kv_kernel"], st_counts) != ("cuda", want):
        raise AssertionError(f"stablelm-1.6b serve ({out_st['kv_kernel']}): "
                             f"launches {st_counts} != {want}")
    st_streams = _streams(st_stats)
    del out_st, st_stats
    mark13("stablelm-1.6b serve_main")
    eng_st = ServeEngine(arch="stablelm-1.6b", kv_layout="paged",
                         kv_kernel="cuda", num_slots=8, max_len=512, seed=0,
                         log=quiet)
    reqs13 = serving.uniform_trace(8, st_cfg.vocab_size, prompt_len=256,
                                   max_new=32, seed=0)
    if _streams(eng_st.run(reqs13)) != st_streams:
        raise AssertionError("stablelm-1.6b: the engine's streams differ "
                             "from serve_main's on the same trace")
    st_tf, tf13, calls13 = _teacher_forced_run(
        torch, ref, ops, eng_st, reqs13,
        build_decode_step_slots_paged(eng_st.model, use_kernel=False),
        build_decode_step_slots_paged(eng_st.model, use_kernel=True),
        torch.Generator(device="cuda").manual_seed(0))
    _teacher_forced_gates("stablelm-1.6b", tf13, calls13, len(reqs13))
    tps13 = {"on": [], "off": []}
    for label in ("on", "off", "off", "on"):
        s = eng_st.run(reqs13, tracer=serving.Tracer() if label == "on"
                       else None)
        tps13[label].append(s.tokens_per_s)
    t13 = time.perf_counter() - t13
    del eng_st, st_tf
    mark13("stablelm-1.6b engine, teacher-forced and timed runs")
    print(f"[easey-serve] {card} stablelm-1.6b at full width "
          f"({st_cfg.num_layers} "
          f"layers, d {st_cfg.d_model}, {st_cfg.num_heads} heads of "
          f"{st_cfg.head_dim}, layernorm), serve_main paged 8 slots x 512, "
          f"8 requests of 256 + 32: {st_counts['paged_attention']} K1 "
          f"launches = {st_cfg.num_layers} x every decode tick, no K2 (a "
          f"layernorm config); teacher-forced {len(tf13)} ticks: K1 vs "
          f"plain max {max(c['ratio'] for c in calls13):.4g} of the "
          f"two-rounding bound over {len(calls13)} calls; logits vs gather "
          f"max {max(t['rel'] for t in tf13):.4g} of max |logit|, control "
          f"{max(t['ctrl'] for t in tf13):.4g}; tokens/s traced "
          f"{[round(v, 2) for v in tps13['on']]}, untraced "
          f"{[round(v, 2) for v in tps13['off']]} (in turns, not gated); "
          f"phase 13 took {t13:.1f} s; memory (GB allocated after, peak "
          f"during) {mem13}")

    # ---- 14. the MoE family at full width through EASEY ------------------
    dry.mark(14)
    t14 = time.perf_counter()
    mem14 = []              # (what, GB allocated after it, its peak GB)

    def mark14(what):
        gc.collect()
        torch.cuda.empty_cache()
        mem14.append((what, round(torch.cuda.memory_allocated() / 1e9, 1),
                      round(torch.cuda.max_memory_allocated() / 1e9, 1)))
        torch.cuda.reset_peak_memory_stats()
    mark14("before phase 14")
    gr = get_config("granite-moe-3b-a800m")
    gl = gr.num_layers
    cmd14 = ("serve --arch granite-moe-3b-a800m --kv-layout paged --batch 8 "
             f"--max-len 512 --requests 8 --prefill 256 --decode {MOE_DECODE}")
    app14 = parse_appfile(f"FROM arch:granite-moe-3b-a800m\nSHAPE "
                          f"decode_32k\n###include_local_kernels###\nRUN "
                          f"{cmd14}\n")
    spec14 = parse_jobspec({"job": {"name": "serve-granite-moe"},
                            "execution": [{"serial": {"command": cmd14}}]})
    reset_counts()
    (mw14, jid14, res14), easey14_s = _timed(run_easey, app14, "nvidia:h100",
                                             spec14, storage=work13)
    moe_launches = counts()
    if mw14.status(jid14) is not JobState.FINISHED:
        raise AssertionError(f"MoE serving job {mw14.status(jid14).value}: "
                             f"{mw14.logs(jid14)[1][-3000:]}")
    if (res14.step_name, res14.program["arch"], sorted(res14.built)) != \
            ("decode_step", "sm_90a", ["paged_attention", "rmsnorm"]):
        raise AssertionError(f"MoE serving build: {res14.step_name}, "
                             f"{res14.program['arch']}, built {res14.built}")
    out14 = mw14.scheduler.result(jid14)[0]
    st14 = out14["stats"]
    ticks14, chunks14 = st14.decode_steps, st14.prefill_chunks
    # per step: layer 0's first norm alone, then 2 fused add + norms a layer
    want = {"paged_attention": gl * ticks14, "rmsnorm": ticks14 + chunks14,
            "add_rmsnorm": 2 * gl * (ticks14 + chunks14),
            "sedov_stencil": 0, "flash_attention": 0}
    if (out14["kv_kernel"], moe_launches) != ("cuda", want):
        raise AssertionError(f"MoE serve ({out14['kv_kernel']}): launches "
                             f"{moe_launches} != {want}")
    if len(st14.results) != 8 or any(
            len(r.tokens) != MOE_DECODE or
            not all(0 <= x < gr.vocab_size for x in r.tokens)
            for r in st14.results):
        raise AssertionError("MoE serve: not every request complete")
    easey14 = (_streams(st14), st14.tokens_per_s, dict(res14.built))
    del mw14, res14, out14, st14
    mark14("granite-moe-3b-a800m EASEY job")

    eng14 = ServeEngine(arch="granite-moe-3b-a800m", kv_layout="paged",
                        kv_kernel="cuda", num_slots=8, max_len=512, seed=0,
                        log=quiet)
    eng14_chunk = eng14.prefill_chunk
    reqs14 = serving.uniform_trace(8, gr.vocab_size, prompt_len=256,
                                   max_new=MOE_DECODE, seed=0)
    with _RouteLog(moe) as log14:
        if _streams(eng14.run(reqs14)) != easey14[0]:
            raise AssertionError("granite-moe-3b-a800m: the engine's streams "
                                 "differ from the EASEY job's on the same "
                                 "trace")
    drops_per_step = log14.chunk_drops(gl)
    # teacher forcing, with each decode call's routing recorded: the kernel
    # step, then the gather and the control steps, gl calls each a tick
    with _RouteLog(moe) as log14:
        st_tf, tf14, calls14 = _teacher_forced_run(
            torch, ref, ops, eng14, reqs14,
            build_decode_step_slots_paged(eng14.model, use_kernel=False),
            build_decode_step_slots_paged(eng14.model, use_kernel=True),
            torch.Generator(device="cuda").manual_seed(0))
    routed = log14.decode_slots()
    # per tick, the first layer whose routing (of all 8 rows) parts from
    # the gather path's
    parts = []
    for t, rec in enumerate(tf14):
        k_, g_ = routed[3 * gl * t:3 * gl * t + gl], \
            routed[3 * gl * t + gl:3 * gl * t + 2 * gl]
        parts.append(next((i for i in range(gl)
                           if not torch.equal(k_[i], g_[i])), None))
    per_layer = [round(max(c["ratio"] for c in calls14[i::gl]), 3)
                 for i in range(gl)]
    print(f"[moe] {card} granite-moe-3b-a800m teacher-forced, {len(tf14)} "
          f"ticks: K1 vs plain max {max(c['ratio'] for c in calls14):.4g} of "
          f"the two-rounding bound over {len(calls14)} calls (per layer "
          f"{per_layer}); logits vs gather per tick "
          f"{[round(t['rel'], 4) for t in tf14]}, control "
          f"{[round(t['ctrl'], 4) for t in tf14]}; "
          f"{sum(t['flips'] for t in tf14)} of "
          f"{sum(t['live'] for t in tf14)} greedy picks differ; first layer "
          f"whose routing parts from the gather path's, per tick: {parts}")
    _teacher_forced_gates("granite-moe-3b-a800m", tf14, calls14, len(reqs14))
    del st_tf, routed, log14

    # the decode tick and the chunk step at full width, on a pool
    # mid-generation (phase 5's lengths)
    pool14 = eng14.make_pool()
    for n in main_lens:
        slot = pool14.alloc()
        pool14.reserve_prefix(slot, n)
        pool14.set_length(slot, n - 1)
    pool14.cache["index"].copy_(torch.as_tensor(pool14.lengths,
                                                dtype=torch.int32))
    pages14 = torch.as_tensor(pool14.page_table, device="cuda")
    ctoks14 = torch.ones((1, eng14.prefill_chunk), dtype=torch.int32,
                         device="cuda")
    row14 = pages14[0].contiguous()

    def tick14():
        return eng14.decode_fn(pool14.cache, tok, act, pages14)

    def chunk14():
        return eng14.chunk_fn(pool14.cache, ctoks14, 0, 0,
                              eng14.prefill_chunk, eng14.prefill_chunk,
                              row14)
    tick14_ms = _events_ms(torch, tick14, 10)
    chunk14_ms = _events_ms(torch, chunk14, 10)
    prof14 = (_profile_ticks(torch, card, "granite-moe-3b-a800m decode tick",
                             tick14, n=5),
              _profile_ticks(torch, card, "granite-moe-3b-a800m chunk step",
                             chunk14, n=3))
    del pool14
    tps14 = [eng14.run(reqs14).tokens_per_s for _ in range(2)]
    t14 = time.perf_counter() - t14
    peak14 = torch.cuda.max_memory_allocated() / 1e9
    del eng14
    mark14("granite-moe-3b-a800m engine, teacher-forced and timed runs")
    print(f"[moe] {card} run_easey(granite-moe-3b-a800m serving Appfile, "
          f"nvidia:h100): build {easey14[2]} for {_build.ARCH}, job finished "
          f"in {easey14_s:.1f} s; {gl} layers, {gr.num_experts} experts "
          f"top-{gr.experts_per_token}, d {gr.d_model}, "
          f"{param_count_estimate(gr) / 1e9:.3f} B parameters; {ticks14} "
          f"decode ticks, {chunks14} chunk steps, launches {moe_launches} "
          f"(K1 = {gl} x every tick, K2 on every norm); the engine's streams "
          f"equal the job's; assignments dropped past capacity per chunk "
          f"step ({eng14_chunk} tokens, capacity "
          f"{moe.expert_capacity(gr, eng14_chunk)} per expert): "
          f"{drops_per_step}; decode tick (8 slots, {sum(main_lens)} held "
          f"tokens) {tick14_ms:.3f} ms, chunk step {chunk14_ms:.3f} ms (CUDA "
          f"events), profiler: tick {prof14[0]}, chunk step {prof14[1]}; "
          f"tokens/s EASEY {easey14[1]:.2f}, engine {[round(v, 2) for v in tps14]}"
          f" (not gated); phase 14 took {t14:.1f} s; peak memory "
          f"{peak14:.1f} GB; memory (GB allocated after, peak during) {mem14}")

    # ---- 15. training at full width ----------------------------------
    dry.mark(15)
    per_step15 = _train_full(torch, mt, card, counts, reset_counts, quiet)

    # ---- 16. the VLM family at full width, the legacy path ------------
    dry.mark(16)
    vlm_launches = _vlm_full(torch, mt, card, counts, reset_counts, quiet)

    # ---- 17. xLSTM at full width: serving, its cells, training ---------
    dry.mark(17)
    _ssm_full(torch, mt, card, counts, reset_counts, quiet)

    # ---- 18. the Zamba2 hybrid at full width, K2 on every norm --------
    dry.mark(18)
    zamba_launches = _hybrid_full(torch, mt, card, counts, reset_counts,
                                  quiet)

    # ---- 19. Whisper at full width: serving, training, the roofline ---
    dry.mark(19)
    _whisper_full(torch, mt, card, counts, reset_counts, quiet)

    # ---- 20. LULESH over a one-rank NCCL mesh -------------------------
    dry.mark(20)
    k4_mesh = _lulesh_nccl(torch, mt, card, counts, reset_counts)
    print(f"[smoke] {card} phases 1-20 took "
          f"{time.perf_counter() - t_main:.1f} s")

    # ---- 21. serving over a one-rank NCCL mesh -------------------------
    dry.mark(21)
    mesh_launches = _serve_nccl(
        torch, mt, card, counts, reset_counts, quiet, reqs,
        {"streams": p4_streams, "sig": p4_sig, "launches": p4_launches,
         "counts": (st_k.decode_steps, st_k.prefill_chunks,
                    st_k.preemptions, st_k.generated_tokens)})

    # ---- 22. the dry run against the card -----------------------------
    dry.mark(22)
    _dryrun_card(torch, mt, card, quiet, dry)
    print(f"[smoke] {card} phases 1-22 took "
          f"{time.perf_counter() - t_main:.1f} s")

    # ---- 23. the lint's shared-memory figures, the examples -----------
    dry.mark(23)
    t23 = time.perf_counter()
    lint_wait = _lint_port()
    _smem_card(torch, _build, card)
    ex = _examples_card(torch, card, counts, reset_counts)
    lint = lint_wait().strip().splitlines()
    print(f"[smem] {card} `python -m repro_torch.analysis.lint "
          f"src/repro_torch` (beside the examples) exit 0, "
          f"{sum('[info] smem-budget' in ln for ln in lint)} kernels "
          f"reckoned: {lint[-1]}")
    print(f"[smoke] {card} phase 23 took {time.perf_counter() - t23:.1f} s; "
          f"phases 1-23 took {time.perf_counter() - t_main:.1f} s")

    # ---- 24. training on a one-rank NCCL mesh ---------------------------
    dry.mark(24)
    mesh_train = _train_nccl(torch, mt, card, counts, reset_counts)
    print(f"[smoke] {card} phases 1-24 took "
          f"{time.perf_counter() - t_main:.1f} s")

    # ---- 25. one rank of a (16, 16) mesh serving, split ----------------
    dry.mark(25)
    rank = _serve_rank(torch, mt, card, counts, reset_counts, quiet, flush)
    _train_rank(torch, mt, card, quiet)
    print(f"[smoke] {card} phases 1-25 took "
          f"{time.perf_counter() - t_main:.1f} s")

    kernels = [
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:197",
         "launches": launches["paged_attention"],
         "router_launches": router_k1,
         "easey_serve_launches": easey_counts["paged_attention"],
         "stablelm_launches": st_counts["paged_attention"],
         "granite_moe_launches": moe_launches["paged_attention"],
         # phase 21: the engine's mesh steps on a one-rank NCCL mesh
         "mesh_launches": mesh_launches["engine"]["paged_attention"],
         # phase 23: the example twins on the card
         "examples_launches": {n: c["paged_attention"]
                               for n, c in ex.items()},
         # phase 25: one attention layer a rank of nvidia:h100x256, K1 on
         # the rank's heads (a kv head offset where the pool keeps all)
         "rank_layer_launches": rank["layer_launches"]["paged_attention"],
         "max_abs_err": max(k1_err, max(r["abs"]
                                        for r in rank["k1"].values())),
         "ms": k1["ms"], "plain_ms": k1["plain"], "bound_ms": k1["bound"],
         "bound_by": k1["bound_by"], "library_ms": k1["lib"],
         # the attention shapes of the configs ported since (phase 2)
         "shapes": {n: {"ms": r["ms"], "plain_ms": r["plain"],
                        "bound_ms": r["bound"], "library_ms": r["lib"]}
                    for n, r in k1_new.items()},
         # phase 25: at a rank's heads of nvidia:h100x256 at decode_32k
         "rank_shapes": {n: {"ms": r["ms"], "plain_ms": r["plain"],
                             "bound_ms": r["bound"], "library_ms": r["lib"]}
                         for n, r in rank["k1"].items()}},
        {"name": "rmsnorm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
         "replaces": "src/repro/kernels/rmsnorm.py:38",
         "launches": launches["rmsnorm"],
         "easey_serve_launches": easey_counts["rmsnorm"],
         "granite_moe_launches": moe_launches["rmsnorm"],
         # deepseek-7b training (phase 15): per step, forward + recompute
         "train_launches_per_step": per_step15["rmsnorm"],
         # llava-next-34b served by the legacy path (phase 16)
         "llava_launches": vlm_launches["rmsnorm"],
         # zamba2-7b served by the legacy path (phase 18)
         "zamba_launches": zamba_launches["rmsnorm"],
         # phase 21: the engine's and the legacy path's mesh steps
         "mesh_launches": mesh_launches["engine"]["rmsnorm"],
         "mesh_legacy_launches": mesh_launches["legacy"]["rmsnorm"],
         "examples_launches": {n: c["rmsnorm"] for n, c in ex.items()},
         # phase 24: the split train step on a one-rank NCCL mesh, per
         # step (deepseek-7b cut to 8 layers; granite-moe-3b-a800m)
         "mesh_train_launches_per_step": {
             n: k["rmsnorm"] for n, k in mesh_train.items()},
         # phase 25: both rank steps at decode_32k
         "rank_step_launches": rank["step_launches"]["rmsnorm"],
         "backward_ms": {f"{r}x{c}": k2g[(r, c)]["ms"]["rmsnorm"][1]
                         for r, c in K2_GRAD_SHAPES},
         "max_abs_err": k2_err,
         "ms": k2[8, d]["ms"], "plain_ms": k2[8, d]["plain"],
         "bound_ms": k2[8, d]["bound"], "bound_by": "bytes",
         "library_ms": k2[8, d]["lib"],
         "shapes": {f"{n} {shape}": {
             "ms": k2[shape]["ms"], "plain_ms": k2[shape]["plain"],
             "bound_ms": k2[shape]["bound"], "library_ms": k2[shape]["lib"]}
             for n, shape in (("granite-moe-3b-a800m", (8, d_gr)),
                              *(("llava-next-34b", sh)
                                for sh in K2_VLM_SHAPES),
                              *(("zamba2-7b", sh)
                                for sh in K2_ZAMBA_SHAPES))}},
        # the fused entry of the same kernel (norm_of_rounded=True) at
        # (8, 4096); its plain version is the eager add and norm, and no
        # one PyTorch call computes it: library_ms is null
        {"name": "add_rmsnorm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
         "replaces": "src/repro/kernels/rmsnorm.py:38",
         "launches": launches["add_rmsnorm"],
         "easey_serve_launches": easey_counts["add_rmsnorm"],
         "granite_moe_launches": moe_launches["add_rmsnorm"],
         "train_launches_per_step": per_step15["add_rmsnorm"],
         "llava_launches": vlm_launches["add_rmsnorm"],
         "zamba_launches": zamba_launches["add_rmsnorm"],
         "mesh_launches": mesh_launches["engine"]["add_rmsnorm"],
         "mesh_legacy_launches": mesh_launches["legacy"]["add_rmsnorm"],
         "examples_launches": {n: c["add_rmsnorm"] for n, c in ex.items()},
         "mesh_train_launches_per_step": {
             n: k["add_rmsnorm"] for n, k in mesh_train.items()},
         "rank_step_launches": rank["step_launches"]["add_rmsnorm"],
         "backward_ms": {f"{r}x{c}": k2g[(r, c)]["ms"][True][1]
                         for r, c in K2_GRAD_SHAPES},
         "max_abs_err": k2f_err,
         "ms": k2f[8, d]["ms"], "plain_ms": k2f[8, d]["plain"],
         "bound_ms": k2f[8, d]["bound"], "bound_by": "bytes",
         "library_ms": None,
         "shapes": {f"{n} {shape}": {
             "ms": k2f[shape]["ms"], "plain_ms": k2f[shape]["plain"],
             "bound_ms": k2f[shape]["bound"], "library_ms": None}
             for n, shape in (("granite-moe-3b-a800m", (8, d_gr)),
                              *(("llava-next-34b", sh)
                                for sh in K2_VLM_SHAPES),
                              *(("zamba2-7b", sh)
                                for sh in K2_ZAMBA_SHAPES))}},
        # no one PyTorch call computes the fused step: library_ms is null
        {"name": "sedov_stencil", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/sedov_stencil.cu",
         "replaces": "src/repro/kernels/sedov_stencil.py:143",
         "launches": launches["sedov_stencil"],
         "examples_launches": {n: c["sedov_stencil"] for n, c in ex.items()},
         # phase 20: lulesh.run(..., mesh, use_kernel=True) on a one-rank
         # NCCL mesh, one launch a step
         "mesh_launches": k4_mesh,
         "max_abs_err": k4_err,
         "ms": k4_ms, "plain_ms": k4_plain, "bound_ms": k4_bound,
         "bound_by": "bytes" if k4_bytes / HBM_BYTES_PER_S >=
         k4_flops / F32_FLOPS else "operations",
         "library_ms": None},
        # times at deepseek-7b's full-width shape; launches from the bench
        # (f32: the CUDA-core body), tensor_core_launches from the
        # full-width bf16 calls of phase 9
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:108",
         "launches": bench_counts["flash_attention"],
         "tensor_core_launches": k3_tc,
         "examples_launches": {n: c["flash_attention"]
                               for n, c in ex.items()},
         "max_abs_err": k3_err,
         "ms": k3["deepseek-7b"]["ms"], "plain_ms": k3["deepseek-7b"]["plain"],
         "bound_ms": k3["deepseek-7b"]["bound"],
         "bound_by": k3["deepseek-7b"]["bound_by"],
         "library_ms": k3["deepseek-7b"]["lib"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
