#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one
NVIDIA GPU: decoder LMs, Mixtral's mixture of experts, ViT and the T5
encoder-decoder, the keyed, sharded materializer, the sharded train
step (one-rank meshes), sequence and pipeline parallelism and a
mixture of experts over the sequence ring (ranks spawned on the one card
over gloo), checkpoints, the elastic loop and resharding, and the serve
fleet with its chaos, autoscaler and blue-green rollover.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (one
nvcc per source, all started together, and the native graph engine
beside them with the host compiler: this process and every child and
spawned rank that records loads it, or the script fails), holds each
against its plain
PyTorch version on the card, then drives the serving path — deferred-init
replica bring-up straight onto the GPU, continuous batching with paged
decode — the training path — deferred init, materialization on the
card and ``make_train_step`` with the flash attention kernels — and T5's
forward and backward from deferred init on the flash kernels with their
additive-bias operand and the d(bias) kernel, through the entry points a
user calls, and checks what comes out.  One JSON object per line:

1. the device: name and power limit as nvidia-smi gives them, torch,
   CUDA and nvcc versions;
2. the paged-decode kernel against ``paged_attention_reference`` on the card: the 14
   cases of ``tests/test_paged_attention.py`` (float32 within 1e-5,
   bfloat16 within 3e-2, idle rows exactly zero), lengths either side of
   a split boundary (idle, 1, one page, boundary - 1, boundary, boundary
   + 1, the table's full width) in both dtypes, the split launch replayed
   from a CUDA graph equal to the eager one, and full-width decode
   shapes (float32 within 1e-5, bfloat16 within two bf16 ulps) with
   their split plan, CUDA launches per call (counted) and times: kernel
   (eager, and from CUDA-graph replay), plain version, a library
   yardstick (``scaled_dot_product_attention`` over contiguous K/V
   gathered up to the longest lane, which the port never calls) and the
   bandwidth bound;
3. token-exact float32 serving of gpt2-125m (full size) and a 2-layer
   llama3-8b (full width), each replica's parameters bitwise the keyed
   materializer's values of its recording and seed (and its keyed-draw
   launches), against the port's unbatched no-cache oracle,
   through a pool small enough to force preemption, every serving
   program a captured CUDA graph, prefix caching and speculation on;
   then the same two models through a request mix that forces every
   serving feature (``serve_features_f32``: 6 requests sharing a
   32-token preamble, a 48-token prompt twice, a 150-token prompt past
   the largest bucket): tokens equal to the oracle and final logits
   within 1e-4, each follower a prefix hit, a copy-on-write copy, two
   or more chunks, a verify tick, no page in use after ``drain``, the
   same run on the replica's eager programs (``cuda_graphs=False``)
   with equal tokens and final logits within 1e-6; in both phases the
   paged-decode kernel's launches equal the layers times the PLAIN
   decode ticks (a verify tick attends through the plain
   ``paged_prefill_attention``; a graph replay adds the calls its
   capture recorded);
4. full-depth llama3-8b bf16 serving: bring-up seconds, keyed-draw
   launches and host RSS growth while the keyed materializer draws the
   16 GB of parameters on the card, both in a fresh process (cold) and
   in this one (warm, where every entry is then held bitwise against
   the materializer's values of the same recording and seed), the seconds
   to capture its 20 programs and the graph pool's bytes; with
   speculation off, decode tokens/s and tick ms on the captured
   programs and on the same replica's eager ones, and the kernel's
   launch count (32 per decode step, each with one merge launch where
   the engine's table takes several splits); with speculation on, a
   repeated prompt's drafted / accepted tokens and verify ticks, first
   tokens equal to the oracle; a few decode ticks of each mode under
   ``torch.profiler``: tick wall ms, device ms, the host's launch calls
   (``cudaGraphLaunch`` counted) and the paged-decode and merge
   kernels' device time and launches per tick, named apart;
5. the serving engine's fault handling on the captured programs
   (``serve_chaos``): the feature mix of 3 again on each f32 replica,
   under one fault plan that fires a fault deferred to a chunk boundary
   of the 150-token prompt, one deferred to a verify tick, one on a
   plain tick, a slow tick, and a flapping entry (duty 0.5, firing on
   the second replica): every entry fired, requests requeued, tokens
   equal to the oracle and final logits within 1e-4, each position
   streamed once, no program rebuilt or recaptured, the paged-decode
   launches equal to layers x plain ticks, every request's ledger
   stages summing to its end-to-end latency within 1e-6 s, the flight
   bundles valid (``chaos_injected``, ``serve_fault``), no page in use
   after ``drain``; ``compile@1=raise`` on an engine with nothing
   captured, at its first lazy build, and a forward raising inside its
   capture leaving no graph and no stream capturing; then full-depth
   llama3-8b bf16 on 4 lanes with speculation and the prefix cache off:
   two faults mid-decode and tokens bitwise equal to the fault-free
   run, the
   health states ``spin_up_replica`` walked, the decode tick ms and
   tokens/s with telemetry off and on (ledger and SLO windows), and one
   ``flight_dump``'s ms and bytes;
6. the flash kernels (forward, dq, dk/dv) against
   ``flash_forward_reference`` / ``flash_backward_reference`` on the
   card: every bias-free case of ``tests/test_ops.py`` and ragged cases
   at head dims 32, 64 and 128, ViT's non-causal S 197 (float32 within
   1e-5, bfloat16 within 3e-2, relative above magnitude 1; rows that see
   no key exactly zero); the bf16 forward, dq, dk/dv and d(bias)
   kernels' registers, spills (it fails on any), CTAs per SM and shared
   memory;
   the hi/lo split of dS in dk/dv (||sum_j dK_j|| / ||dK|| within 2x of
   the exact dK rounded once to bf16, on a case where dS rounded once
   misses by 30x) and in dq (dq within 2x of the exact dq rounded once,
   on keys sharing a large component, where dS rounded once misses by
   60x); the forward's normalizer (its f32 O within 2x of the error of P
   rounded once, on values sharing a large component, where dividing by
   the exact sum of P misses by 60x); and the
   llama3-8b, gpt2-125m and vit-l16 (non-causal) training shapes in
   both dtypes (float32
   within 1e-5, bfloat16 within 1e-2 normwise) with their
   times: kernel, plain version, a library yardstick
   (``scaled_dot_product_attention`` forward and its autograd backward,
   which the port never calls) and the bound; lse within 1e-5 relative
   everywhere; then ``flash_tune``: ``tune_flash_blocks`` at the llama
   shape for the ``fwd`` and ``bwd`` workloads (ms per step of its chain
   for each launch shape, the winner, a second call served from its
   cache with 0 measurements), every built launch shape held against
   the plain versions (bfloat16 within 1e-2 normwise) with the
   forward's and dq's kernel ms beside the default rule's, and a shape
   the library does not build refused (``BlockConfigError``);
7. float32 training of gpt2-125m (full size), flash attention against
   ``default_attention`` on the same weights and batches: each step-0
   gradient leaf within 1e-4 normwise, the key biases' gradient (0 in
   exact arithmetic) below 1e-5 of the key weights', every step's loss
   within 1e-3, 12 x 3 launches of each flash kernel;
8. the training main path at llama3-8b width, 2 layers, bf16 compute:
   first-step latency (deferred_init -> materialize on the card ->
   train step -> first loss on the host) in a fresh process, host RSS
   growth, 5 losses below the first, step ms, tokens/s, MFU, peak device
   memory, 2 launches of each flash kernel per step, one step against
   the same model on ``default_attention`` (loss, gradient norm and each
   gradient leaf), and one step's device time by kernel under the
   port's ``utils.profiling.trace`` with ``annotate("tdx.step")``, whose
   Chrome trace must name the three flash kernels and the annotation;
   the recording's call-stack walks on this path counted, natively
   (more than 0 required);
9. the flash kernels with a bias, and the d(bias) kernel, against the
   plain versions on the card: the bias cases of ``tests/test_ops.py``
   and cases for d(bias)'s ring of rows (one plane for 16 rows with GQA,
   ragged S and T with T % 4 != 0 at D = 128, segments, causal with T >
   S) in both dtypes (float32 against an f64 evaluation within 1e-5 x
   max(1, |plain|), d(bias) included; bfloat16 within 3e-2), a TINY T5 on the
   kernels against ``default_attention``, the relative-position bucket
   map on the card equal to the CPU's, and T5-11B's attention shapes
   (encoder self-attention with the bias, decoder self-attention with
   the bias, cross-attention without) in both dtypes (bfloat16 within
   1e-2 normwise), the encoder's in bfloat16 with its times (the
   kernels line's): kernel, plain version, a library
   yardstick (``scaled_dot_product_attention(attn_mask=bias)`` forward
   and its autograd backward with the bias's gradient, backend named)
   and the bound;
9b. the keyed draws' kernel (``keyed_rng_kernel``) against its plain
   version on the card: the 12 instantiations' ptxas lines (registers,
   stack frame; 0 spill bytes or the phase fails) and CTAs per SM;
   sincosf bit for bit sinf and cosf at all 2**24 arguments the normal
   draws form; in f32, bf16 and f16, uniform bit for bit and normal
   within 2 ulp over a full [4, 1000, 1037] tensor (the normal draws'
   ulps printed), eight regions of it (unaligned starts, the whole, a
   contiguous slab, one element, whole rows, and three whose global base
   is not a multiple of 4, one of them a single run) bit for bit their
   slices of the kernel's full draw, those three and a [1, 2**20] region
   of a [2, 2**34] tensor (block indices past 2**32: the 64-bit path)
   bit for bit the plain version's draw of the region; at
   Mixtral 8x7B's expert stack ([8, 4096, 14336] f32) both kinds checked
   the same way and timed: kernel, plain version, ``Tensor.normal_`` /
   ``uniform_`` with torch's CUDA generator (a yardstick the port never
   calls) and the bound;
10. a warm bring-up from the artifact registry (``registry_warm``): the
   port's ``warm_cache`` tool publishes the build phase's three kernel
   libraries and the native graph engine from its cache into a fresh
   registry (the env fingerprint printed); a
   fresh child with an empty ``TDX_CACHE_DIR`` and that registry takes
   gpt2-125m f32's first train step on B1-B3 against
   ``default_attention`` (each gradient leaf within 1e-4 normwise) and
   serves a ``ServeFleet`` of gpt2-125m f32 replicas (``start(1)``, then
   ``scale_up``: every bring-up warm, 8 requests equal to the oracle,
   paged decode launched layers x plain ticks) with 0 nvcc builds and
   the fetched log's ptxas lines spill-free; a second child under
   ``cache@1=corrupt`` quarantines the three damaged kernel libraries
   before any ``dlopen``, fetches them again and computes the first
   child's flash, paged-decode and keyed-draw results bit for bit; each library's fetch s beside
   its cold ``build_s`` and the first child's s from launch to its
   first loss;
11. float32 T5 at T5-11B width, 2 + 2 layers, B = 2, enc 512, dec 114:
   flash kernels against ``default_attention`` on the same weights and
   batch, logits within 1e-4 and each gradient leaf within 1e-4
   normwise, the relative-position tables (whose only gradient is
   d(bias)) named;
12. the T5 main path: T5-11B width with 2 + 2 layers, bf16 compute, B = 8,
    enc 512, dec 114, deferred_init -> materialize on the card -> 4
    steps of ``lm_cross_entropy`` and ``default_optimizer``: first-step
    latency in a fresh process, host RSS growth, step ms, tokens/s, MFU,
    peak device memory, the launches per step (forward 6, of them 4 with
    the bias; dq and dk/dv 6; d(bias) 4), one step against
    ``default_attention`` and one profiled step;
13. full-depth T5-11B (22.6 GB of bf16 parameters) brought up in a fresh
    process — seconds and host RSS growth — and one forward at B = 1 on
    the flash kernels with finite logits;
14. the keyed, sharded materializer (``cuda_bridge``) on gpt2-125m, f32:
    the same seed twice bitwise equal, seed 1 moving every random entry;
    against eager construction on the card equal names, shapes and
    dtypes, the entries that draw nothing bitwise equal, the random
    ones' std within 2 %; on virtual ``{fsdp: 2, tp: 4}`` meshes under
    ``decoder_lm_plan`` and ``gspmd_2d_plan`` and ``{fsdp: 8}`` under
    ``fsdp_plan``, each of the 8 coordinates' shards, materialized on
    their own (every entry replayed on its shard's shape: the count
    printed), equal to their slices of the unsharded values bit for
    bit and covering them, each coordinate's ``max_memory_allocated``
    growth at most its local bytes plus twice its largest local shard
    at the recorded dtype; the fault and resume leg: under
    ``execute@3=raise`` with no retries a ``MaterializationError`` with
    groups 1 and 2 committed under ``TDX_MATERIALIZE_RESUME_DIR``, a
    flipped payload recomputed and the rest resumed bitwise equal to the
    clean run, the directory swept, ``execute@2=raise x2`` with 2
    retries survived bitwise; a real one-rank ``DeviceMesh`` (NCCL, world
    size 1, an in-memory store) equal to ``mesh=None``; the recording
    still fake afterwards; recorded again under
    ``config.override(native=False)`` (its walks in Python) and
    materialized bitwise equal, the host seconds of both recordings'
    walks printed; then the login host (``login_host``): a child that
    sees no CUDA device (``CUDA_VISIBLE_DEVICES=""``) records full-depth
    llama3-8b and the 2-layer model of 16 claiming ``cuda`` through the
    native walks and saves both with ``save_recording``, making no CUDA
    context: the files' bytes, record and save s;
15. full-depth llama3-8b recorded in f32, materialized as bf16 under
    ``decoder_lm_plan`` on a one-rank mesh in a fresh process: seconds
    from ``deferred_init`` to every value resident, bytes, GB/s, host
    RSS growth (below a quarter of the bytes) and device-memory growth
    (at most the bytes plus twice the largest entry at its recorded
    dtype), the keyed draws' launches (at least one per drawing entry)
    and the entries by path, beside the eager route's cold bring-up from
    phase 4; after
    the timed region, the login host's full-depth recording loaded: its
    names, shapes, dtypes and key_nrs those of this recording, the
    embedding, a q projection and the final norm materialized from it
    bitwise equal to this run's; the host-to-device link probe's GB/s
    and probe size, and the materializer's rate as a share of it;
16. the training main path through the keyed materializer in a fresh
    process: 2-layer llama3-8b width, [2, 2048], deferred_init ->
    ``materialize_module_cuda`` -> ``bind_values`` -> ``make_train_step``
    -> the first loss on the host: seconds, host RSS growth (below a
    quarter of the parameter bytes), one launch of each flash kernel per
    layer, the loss within 1e-3 relative of the same step on
    ``default_attention`` from the same recording's values; then the
    login host's 2-layer recording loaded: its keyed values bitwise
    equal to this recording's, every entry, and one step from them in a
    fresh module on B1-B3 within 1e-3 of the first loss;
17. the sharded train step on a one-rank ``{fsdp: 1, tp: 1}`` NCCL mesh
    (tensor parallelism and FSDP2 over the keyed values), gpt2-125m in
    f32, 3 steps against ``mesh=None`` from the same values: losses and
    gradient norms within 1e-6 relative, each parameter within 1e-6
    normwise after the 3 steps (the key biases, whose gradient is zero
    in exact arithmetic, within AdamW's step bound), and whether they
    came out bitwise;
18. the sharded training main path in a fresh process: 2-layer
    llama3-8b width, bf16 parameters, [2, 2048], deferred_init ->
    ``materialize_module_cuda(mesh={fsdp: 1, tp: 1}, plan=
    decoder_lm_plan)`` -> ``bind_values`` -> ``make_train_step(mesh=)``
    -> the first loss, then 4 more steps, the last two with telemetry
    on: seconds to the first loss, host RSS growth (below a quarter of
    the bytes), device-memory growth over bring-up (at most the bytes
    plus twice the largest entry at its recorded dtype), step ms,
    tokens/s, MFU and peak device memory beside the ``mesh=None`` step's
    from the same values, one launch of each flash kernel per layer and
    step, the loss within 1e-3 relative of ``mesh=None``'s, one
    ``train.step`` span per instrumented step, the ``tdx.train.mfu``
    gauge and the counted FLOPs within 1 % of ``train_step_flops``;
    ``initialize_multihost`` on the one process (a no-op, then
    idempotent with the group up) and a one-rank hybrid mesh ``{dp: 1}
    x {fsdp: 1, tp: 1}`` (``make_hybrid_mesh``): its keyed values and
    first loss bit for bit the flat mesh's;
19. Mixtral 8x7B width, 2 layers, bf16 compute on f32 parameters, [2,
    2048], on the flash kernels: deferred_init -> materialize on the
    card -> ``make_train_step``, 5 steps on one batch (losses finite and
    falling, 1 launch of each flash kernel per layer and step), step ms,
    tokens/s, MFU by ``train_step_flops`` (MoE FLOPs counted), peak
    device memory, the router loss and the share of (token, choice)
    pairs dropped at capacity; one step on a fresh batch against the
    same module on ``default_attention`` (loss and gradient norm within
    1e-3, each gradient leaf within 5e-2 normwise); one profiled step with the
    dispatch and combine einsums, the expert GEMMs and the one-hot
    products apart;
20. its keyed values (f32): each of the 8 coordinates of a virtual
    ``{ep: 2, fsdp: 2, tp: 2}`` under ``decoder_lm_plan`` equal to its
    slice of the unsharded values bit for bit, and a one-rank NCCL
    ``{ep: 1, fsdp: 1, tp: 1}`` mesh equal to ``mesh=None``;
21. full-depth Mixtral 8x7B (46.70 B parameters, more than the card
    holds in bf16) recorded as fakes and coordinate ep = 0 of a virtual
    ``{ep: 8}`` materialized in bf16 in a fresh process, every entry on
    its shard's shape: seconds, GB/s, host RSS growth (below a quarter
    of the local bytes) and device-memory growth (at most the local
    bytes plus twice the largest entry at its recorded dtype, and at
    most the local bytes plus twice the largest LOCAL shard at its
    recorded dtype);
22. the sharded flow for 2-layer Mixtral width on a one-rank ``{ep: 1,
    fsdp: 1, tp: 1}`` mesh in a fresh process: the first loss within
    1e-3 of ``mesh=None``'s, counted FLOPs within 1 % of
    ``train_step_flops``, RSS and device growth as in 17;
23. 2-layer llama3-70b width (``remat="full"`` from the preset), bf16
    parameters, [1, 8192]: one step with ``remat="none"`` and one with
    ``"full"`` from the same keyed values, losses and gradient norms
    within 1e-6 (leaves bitwise equal counted), the flash forward twice
    per layer and step under ``"full"``, the peak device memory of a
    later step lower under ``"full"``, both step times;
24. ViT on the flash kernels (non-causal, D 64, S 197): vit-b16 in f32,
    one step against ``default_attention`` (logits within 1e-4, each
    gradient leaf within 1e-4 normwise); full-depth vit-l16, bf16
    compute, B 32 at 224 x 224: the gradients on a fresh batch against
    ``default_attention``'s under the limits of 8 before training (the
    key biases, zero in exact arithmetic, held against the key weights'
    gradient), each path's error against the same step in f32 compute,
    then 5 label cross-entropy steps, step ms, images/s, MFU and peak
    device memory;
25. sequence parallelism, as spawned gloo ranks sharing the card (NCCL
    takes one rank a card; their times are not step times; the
    attention phases' ranks run first in ``train_pp_mesh``'s spawn, the
    train step's beside ``train_pp``'s, their lines printed where those
    phases end): ring-flash
    attention over sp 4 at llama3-8b's attention geometry (B 1, S 16384,
    H 32, KV 8, D 128, causal, bf16), each rank's output and dq, dk, dv
    against its chunk of single-device ``flash_attention`` on the whole
    sequence (normwise within 1e-2), f32 at S 2048 against an f64
    evaluation of the plain version (1e-5 x max(1, |plain|)), the port's
    roundings and the JAX package's against f64 in bf16 at S 2048, the
    forward, dq and dk/dv launched r + 1 times on rank r (the future
    blocks skipped), and the same call on a one-rank NCCL ``{sp: 1}``
    mesh; with T5-11B's encoder bias (H 128, S 2048, f32 bias rows [128,
    512, 2048] a rank, non-causal), d(bias) included, 4 launches of each
    kernel a rank; Ulysses with the flash kernels inside at the llama
    geometry; the train step at 2-layer llama3-8b width, bf16 parameters,
    [1, 8192] over sp 2: 2 losses falling, each within 1e-3 of the same
    model and sequence whole in one process, the launches per rank and
    step, the C3 check against plain attention on a fresh sequence
    (loss and grad norm 1e-3, each leaf 5e-2), and the step on a
    one-rank NCCL ``{fsdp: 1, sp: 1}`` mesh with its ms;
26. pipeline parallelism (``train_pp``), the stages as spawned gloo
    ranks sharing the card: 4-layer llama3-8b width, bf16 parameters, [8,
    2048] in 4 microbatches over pp 2, each rank materializing only its
    own layers (device growth at most their bytes, the replicated ones'
    and twice the largest entry); GPipe, 1F1B and interleaved 1F1B (2
    chunks of one layer a rank), 2 steps each: losses equal on both
    ranks, falling, within 1e-3 of the same model whole in one process
    with the same 4-microbatch accumulation, 2 layers x 4 microbatches of
    each flash kernel per rank and step (none of d(bias) or paged
    decode), 1F1B's peak device memory below GPipe's on stage 0; the C3
    check on a fresh batch (1F1B against plain attention: loss and grad
    norm 1e-3, each leaf 5e-2); gpt2-125m f32 (tied head) under 1F1B
    against ``mesh=None`` (losses 1e-5, each leaf 1e-4 normwise), each
    stage's state saved after step 1 (``save_checkpoint``) and step 2
    (``AsyncCheckpointSaver``), the step-1 checkpoint restored in place
    and step 2 replayed bitwise, and loaded whole into a ``mesh=None``
    state in this process (every leaf's CRC the stage's); then
    each schedule on a one-rank NCCL ``{pp: 1}`` mesh (2 layers) with its
    step ms beside ``train_bf16_full``'s;
27. checkpoints and the elastic loop (``train_elastic``) on the sharded
    main path at 1 layer (llama3-8b width, bf16 parameters, a one-rank NCCL
    ``{fsdp: 1}`` mesh) under one temporary directory (its disk usage
    printed first, removed at the end), in fresh processes: a checkpoint
    every 2 steps, 2 kept; the step-2 save damaged after it committed,
    step 3 raising, a preemption notice at step 4: ``step_2``
    quarantined, one restart, a clean exit at step 4, a fresh process
    resuming to step 6, every step's loss bitwise an uninterrupted run's
    from the same keyed values, B1-B3 at 1 launch a step; the
    checkpoint's bytes, a sync save's s and GB/s, its verify and an
    in-place restore, the step ms while an async save is in flight and
    without; then ``reshard``: the step-6 checkpoint offline to a
    device-free ``{fsdp: 2, tp: 2}`` under ``gspmd_2d_plan`` through
    ``python -m torchdistx_tpu_torch.tools.reshard_ctl apply`` and
    ``verify`` (exit 0) and back to
    ``{fsdp: 1}`` under ``decoder_lm_plan`` with a 256 MiB chunk budget
    (below the embedding), bitwise both ways, staging within the budget,
    the round trip restored onto the card and its next 2 steps bitwise; a
    checkpoint written by 2 spawned gloo ranks on the card (``{fsdp: 2}``)
    with ``AsyncCheckpointSaver``
    resumed by one rank through ``needs_reshard`` -> ``restore_resharded``, its
    steps bitwise an uninterrupted one-rank run's from the same
    resharded state, reshard s, GB/s and the staging peak;
28. the serve fleet (``fleet``, printed after ``serve_chaos``): replicas
    of 4-layer llama3-8b width in float32 on threads of this process,
    2 started, a storm of 32 requests scaling the fleet to 3, then
    ``fleet@2=raise`` killing replica 2 mid-batch (its lanes requeued
    onto the survivors), idle scale-down to 2, a blue-green rollover to
    a checkpoint of the same config at another seed (saved under a
    temporary directory) under 8 more requests: every request equal to
    the unbatched oracle of the weights that served it (tokens exact,
    final logits within 1e-4), both versions serving, the canary's
    gate passed, no page leaked, no program recaptured, the paged-decode
    kernel launched layers x (plain decode ticks + captures after its
    count's reset) times; spin-up and capture s per replica, the roll's
    s per stage, the checkpoint's save s, the peak device memory; run
    with ``TDX_OBS_PORT=0``: while the replicas serve,
    the daemon's ``/readyz`` (200, the serving count of the replicas),
    ``/metrics`` (the fleet counters), ``/slo`` and ``/requests``;
29. a mixture of experts over the sp ring (``train_moe_sp``, printed
    after ``train_pp_mesh``): Mixtral 8x7B width, 2 layers, bf16
    parameters, [2, 2048] over 4 spawned gloo ranks ``{sp 2, ep 2}``
    with ring flash attention, 2 steps, against the same keyed values
    whole on one rank: losses equal on every rank and within 1e-3 of
    the whole sequence's, the pairs dropped at capacity the whole
    sequence's at every step, B1-B3 launched layers x (s + 1) times a
    step on sp rank s, each rank's peak;
30. the kernels line: per kernel its launches on the main path, its error
    against the plain version and its times at the main path's shapes
    (the forward, dq and dk/dv also at the T5 encoder's shape with the
    bias and at ViT-L/16's, non-causal, with their launches on the
    Mixtral, 70B-remat, ViT, sp, pp, MoE-over-sp, registry-warm and elastic paths; paged
    decode (with its launches on the fleet and registry-warm paths) at the serving
    engine's batch, lengths and page table width, with its merge
    launches and CUDA launches per call counted on the serving main
    path, its time from CUDA-graph replay too, and its times at a table
    cut to the lanes' own pages; the keyed draws with their launches on
    the full-depth llama3-8b materialization and on Mixtral's ep = 0
    shard, timed at the expert stack);
31. last: ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when CUDA is unavailable, when run
from a directory without the port, or when any phase fails.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import itertools
import traceback
import warnings
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from torchdistx_tpu_torch import _graph, _native, chaos, deferred_init, is_fake, materialize_module
from torchdistx_tpu_torch import config as tdx_config
from torchdistx_tpu_torch import observe
from torchdistx_tpu_torch.observe import costmodel, httpd
from torchdistx_tpu_torch.ops import autotune, keyed_rng
from torchdistx_tpu_torch.serialize import load_recording, save_recording
from torchdistx_tpu_torch.utils import profiling
from torchdistx_tpu_torch.cuda_bridge import (
    bind_values,
    materialize_module_cuda,
    materialize_params_cuda,
    named_fake_tensors,
)
from torchdistx_tpu_torch.fake import get_fake_context, is_param_like
from torchdistx_tpu_torch.models import (
    LLAMA3_8B,
    PRESETS,
    T5_11B,
    make_gpt2,
    make_llama,
    make_mixtral,
    make_t5,
    make_vit,
)
from torchdistx_tpu_torch.models.layers import (
    Attention,
    Linear,
    MoEMLP,
    default_attention,
    moe_capacity,
    router_aux_loss,
)
from torchdistx_tpu_torch.models.plans import decoder_lm_plan
from torchdistx_tpu_torch.observe import flightrec, health, reqledger
from torchdistx_tpu_torch.models.t5 import _relative_buckets
from torchdistx_tpu_torch.ops import _build
from torchdistx_tpu_torch.ops.ptxas import ptxas_table
from torchdistx_tpu_torch.ops import make_flash_attention
from torchdistx_tpu_torch.ops import paged_attention, paged_attention_reference
from torchdistx_tpu_torch.ops.paged_attention import kernel_plan, split_plan
from torchdistx_tpu_torch.ops.flash_attention import (
    BlockConfigError,
    _dense_probs,
    built_blocks,
    _flash_forward,
    bias_launches as flash_bias_launches,
    flash_backward,
    flash_backward_dbias,
    flash_backward_dkv,
    flash_backward_dq,
    flash_backward_reference,
    flash_forward,
    flash_forward_reference,
    launches as flash_launches,
    reset_launches as reset_flash_launches,
)
from torchdistx_tpu_torch.parallel import (
    PartitionSpec,
    VirtualMesh,
    fsdp_plan,
    gspmd_2d_plan,
    make_mesh,
    make_ring_flash_attention,
    make_train_step,
    make_ulysses_attention,
    pipeline_plan_overrides,
    placements_for,
    stage_layers,
    train_elastic,
)
from torchdistx_tpu_torch.parallel.mesh import (
    initialize_multihost,
    make_hybrid_mesh,
)
from torchdistx_tpu_torch.parallel.sharding import spec_str
from torchdistx_tpu_torch.cuda_bridge import materialize as cuda_mat
from torchdistx_tpu_torch.parallel.train import (
    H100_PEAK_FLOPS,
    default_optimizer,
    lm_cross_entropy,
    train_step_flops,
)
from torchdistx_tpu_torch.serve import (
    FleetConfig,
    Request,
    ServeConfig,
    ServeEngine,
    oracle_generate,
    spin_up_replica,
)
from torchdistx_tpu_torch.serve import engine as serve_engine
from torchdistx_tpu_torch.reshard import (
    MeshSpec,
    last_transfer_peak_bytes,
    needs_reshard,
    plan_reshard,
    reshard_checkpoint,
    restore_resharded,
)
from torchdistx_tpu_torch.serve.programs import ServeProgram
from torchdistx_tpu_torch.utils.checkpoint import (
    AsyncCheckpointSaver,
    checkpoint_tree,
    iter_payload_files,
    read_manifest,
    restore_checkpoint,
    save_checkpoint,
    verify_checkpoint,
)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_FLOPS = H100_PEAK_FLOPS  # dense, no TF32
ATOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
# The flash kernels' lse is float32 in both dtypes: the kernel and the
# plain version sum the same exact products of the same inputs in another
# order (measured about 1e-6).
LSE_RTOL = 1e-5
# bfloat16 flash outputs at the training shapes, normwise: the kernel
# rounds P and dS to bf16 for the tensor cores and every output once,
# the plain version rounds the output once (each rounding is 2**-9
# relative at most); a wrong tile, mask or fragment gives errors of
# order 1.
BF16_NORM_RTOL = 1e-2
SOURCES = ("paged_decode.cu", "flash_attention.cu", "keyed_rng.cu")
# The native graph engine: host-compiled, built beside the kernels.
NATIVE_SOURCE = _native.SOURCE
KERNEL_SOURCE = "torchdistx_tpu_torch/ops/csrc/paged_decode.cu"
KERNEL_REPLACES = "torchdistx_tpu/ops/paged_attention.py:134 (_decode_kernel)"
FLASH_SOURCE = "torchdistx_tpu_torch/ops/csrc/flash_attention.cu"
FLASH_REPLACES = {
    "flash_fwd": "torchdistx_tpu/ops/flash_attention.py:91 (_fwd_kernel)",
    "flash_bwd_dq": "torchdistx_tpu/ops/flash_attention.py:206 (_bwd_dq_kernel)",
    "flash_bwd_dkv": "torchdistx_tpu/ops/flash_attention.py:257 (_bwd_dkv_kernel)",
}
DBIAS_REPLACES = "torchdistx_tpu/ops/flash_attention.py:318 (_dbias_kernel)"
# The training main path: llama3-8b width, depth cut to 2 layers, bf16
# compute on f32 parameters, a [2, 2048] batch.
TRAIN_CFG = LLAMA3_8B.replace(n_layers=2)
TRAIN_BATCH, TRAIN_SEQ = 2, 2048
# The T5 main path: T5-11B width (d_model 1024, 128 heads of 128, d_ff
# 65536, vocab 32128), depth cut to 2 encoder and 2 decoder layers, bf16
# compute on f32 parameters; B = 8, 512 encoder and 114 decoder tokens
# (T5 pre-training's input and target lengths).
T5_CFG = T5_11B.replace(encoder=T5_11B.encoder.replace(n_layers=2),
                        decoder=T5_11B.decoder.replace(n_layers=2))
T5_BATCH, T5_ENC, T5_DEC = 8, 512, 114


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else ""


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


class L2Flush:
    """Overwrites a buffer larger than the 50 MB L2 between timed
    launches, so every launch reads its operands from device memory."""

    def __init__(self, device):
        self.buf = torch.empty(64 * 2**20, dtype=torch.float32, device=device)

    def __call__(self):
        self.buf.zero_()


def time_ms(fn, flush: L2Flush, iters: int = 20, warm: int = 3) -> float:
    """Median device time of ``fn`` over ``iters`` launches (CUDA events,
    cold L2) after ``warm`` untimed ones."""
    for _ in range(warm):
        fn()
    pairs = []
    for _ in range(iters):
        flush()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def graph_ms(fn, n: int = 20, reps: int = 5) -> float:
    """Device time of one call of ``fn`` with no host work around it:
    ``n`` calls captured into one CUDA graph, the median of ``reps``
    replays divided by ``n`` (L2 warm: the calls follow one another)."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        fn()  # warm-up on the capture stream
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(n):
                fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph.replay()
    pairs = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs])) / n


# ---------------------------------------------------------------------------
# phase 2: the kernel against its plain version
# ---------------------------------------------------------------------------


def rand_case(seed, *, B, H, KV, D, page, n_pages, maxp, lengths, dtype,
              device):
    """Inputs as tests/test_paged_attention.py builds them: a shuffled,
    non-overlapping page assignment that never maps the null page."""
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.randn(B, H, D).astype(np.float32))
    kp = torch.from_numpy(rng.randn(n_pages, page, KV, D).astype(np.float32))
    vp = torch.from_numpy(rng.randn(n_pages, page, KV, D).astype(np.float32))
    perm = rng.permutation(n_pages - 1) + 1
    table = perm[: B * maxp].reshape(B, maxp).astype(np.int32)
    return (q.to(device, dtype), kp.to(device, dtype), vp.to(device, dtype),
            torch.tensor(lengths, dtype=torch.int32, device=device),
            torch.from_numpy(table).to(device))


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """Spacing of bfloat16 numbers at |x| (8 significand bits)."""
    e = torch.floor(torch.log2(x.abs().float().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def check_kernel(args, name: str, atol: float | None = None) -> float:
    """Kernel vs plain version on the same card inputs; idle rows must be
    exactly zero in the kernel and are excluded from the error.

    With ``atol`` None (the full-width and main-path shapes) a bfloat16
    output is held to two bf16 ulps of the plain value, floor 1e-5: both
    round an f32 result once, so they differ by at most one ulp.  A
    float32 output is held to 1e-5."""
    q, kp, vp, lens, table = args
    out = paged_attention(q, kp, vp, lens, table)
    ref = paged_attention_reference(q, kp, vp, lens, table)
    torch.cuda.synchronize()
    if out.dtype != q.dtype or out.shape != q.shape:
        raise AssertionError(f"{name}: output {out.dtype} {tuple(out.shape)}")
    live = lens > 0
    if not torch.all(out[~live] == 0):
        raise AssertionError(f"{name}: idle rows are not zero")
    diff = (out[live].float() - ref[live].float()).abs()
    if atol is not None:
        limit = torch.full_like(diff, atol)
    elif q.dtype == torch.bfloat16:
        limit = (2 * bf16_ulp(ref[live])).clamp_min(1e-5)
    else:
        limit = torch.full_like(diff, 1e-5)
    over = diff - limit
    if bool((over > 0).any()):
        i = int(over.argmax())
        raise AssertionError(
            f"{name}: |kernel - plain| {diff.flatten()[i].item()} > limit "
            f"{limit.flatten()[i].item()}")
    return diff.max().item()


def kernel_cases(dev) -> dict:
    """The 14 cases of tests/test_paged_attention.py, on the card."""
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for H, KV in ((4, 4), (4, 2), (8, 1)):
            B, D, page, maxp = 4, 16, 8, 3
            args = rand_case(0, B=B, H=H, KV=KV, D=D, page=page, n_pages=16,
                             maxp=maxp, lengths=[1, page * maxp, 7, 13],
                             dtype=dtype, device=dev)
            name = f"ragged-{str(dtype)[6:]}-H{H}KV{KV}"
            errs[name] = check_kernel(args, name, ATOL[dtype])
    for page in (4, 16):
        maxp = 4
        args = rand_case(1, B=3, H=4, KV=2, D=8, page=page, n_pages=32,
                         maxp=maxp, lengths=[page * maxp - 1, 2, page],
                         dtype=torch.float32, device=dev)
        errs[f"page-{page}"] = check_kernel(args, f"page-{page}", 1e-5)
    args = rand_case(2, B=2, H=4, KV=2, D=8, page=8, n_pages=8, maxp=2,
                     lengths=[0, 5], dtype=torch.float32, device=dev)
    errs["idle-lane"] = check_kernel(args, "idle-lane", 1e-5)
    for dtype in (torch.float32, torch.bfloat16):
        # Contiguous single-page layout: page b holds sequence b, full.
        B, S, H, KV, D = 3, 16, 4, 2, 16
        rng = np.random.RandomState(3)
        q = torch.from_numpy(rng.randn(B, H, D).astype(np.float32))
        k = torch.from_numpy(rng.randn(B, S, KV, D).astype(np.float32))
        v = torch.from_numpy(rng.randn(B, S, KV, D).astype(np.float32))
        args = (q.to(dev, dtype), k.to(dev, dtype), v.to(dev, dtype),
                torch.full((B,), S, dtype=torch.int32, device=dev),
                torch.arange(B, dtype=torch.int32, device=dev)[:, None])
        name = f"contiguous-{str(dtype)[6:]}"
        errs[name] = check_kernel(args, name, ATOL[dtype])
    # Ragged lengths against dense causal attention at the last position.
    from torchdistx_tpu_torch.models.layers import default_attention

    B, S, H, KV, D, page, maxp = 3, 24, 4, 2, 8, 8, 3
    lengths = [5, 24, 17]
    rng = np.random.RandomState(4)
    qf = torch.from_numpy(rng.randn(B, S, H, D).astype(np.float32)).to(dev)
    k = torch.from_numpy(rng.randn(B, S, KV, D).astype(np.float32)).to(dev)
    v = torch.from_numpy(rng.randn(B, S, KV, D).astype(np.float32)).to(dev)
    kp = torch.zeros(1 + B * maxp, page, KV, D, device=dev)
    vp = torch.zeros_like(kp)
    table = torch.zeros(B, maxp, dtype=torch.int32, device=dev)
    for b in range(B):
        for j in range(maxp):
            pid = 1 + b * maxp + j
            table[b, j] = pid
            kp[pid] = k[b, j * page:(j + 1) * page]
            vp[pid] = v[b, j * page:(j + 1) * page]
    q_last = torch.stack([qf[b, L - 1] for b, L in enumerate(lengths)])
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    errs["dense-ragged"] = check_kernel((q_last, kp, vp, lens, table),
                                        "dense-ragged", 1e-5)
    out = paged_attention(q_last, kp, vp, lens, table)
    for b, L in enumerate(lengths):
        dense = default_attention(qf[b:b + 1, :L], k[b:b + 1, :L],
                                  v[b:b + 1, :L], causal=True)[0, -1]
        err = (out[b] - dense).abs().max().item()
        if not err <= 1e-5:
            raise AssertionError(f"dense-ragged lane {b}: {err}")
    args = rand_case(5, B=2, H=4, KV=2, D=8, page=4, n_pages=8, maxp=2,
                     lengths=[6, 8], dtype=torch.float32, device=dev)
    errs["gqa-grouping"] = check_kernel(args, "gqa-grouping", 1e-5)
    errs.update(split_boundary_cases(dev))
    # Shape validation raises before anything launches.
    z = dict(device=dev)
    kp = torch.zeros(4, 8, 2, 8, **z)
    lens = torch.zeros(2, dtype=torch.int32, **z)
    table = torch.zeros(2, 2, dtype=torch.int32, **z)
    for bad_q, bad_table, what in (
        (torch.zeros(2, 3, 8, **z), table, "multiple of KV heads"),
        (torch.zeros(2, 4, 4, **z), table, "head_dim mismatch"),
        (torch.zeros(2, 4, 8, **z), torch.zeros(3, 2, dtype=torch.int32, **z),
         "batch mismatch"),
    ):
        try:
            paged_attention(bad_q, kp, kp, lens, bad_table)
        except ValueError as e:
            if what not in str(e):
                raise AssertionError(f"validation: {e!r} lacks {what!r}")
        else:
            raise AssertionError(f"validation: no error for {what!r}")
    errs["shape-validation"] = 0.0
    return errs


# Lanes of the split-boundary cases: llama3-8b's heads (32 of 128 over 8
# kv heads), 7 lanes, a table of 96 pages of 16, which the split plan
# cuts into several splits on an H100.
SPLIT_SHAPE = dict(H=32, KV=8, D=128, page=16, maxp=96)


def split_boundary_cases(dev) -> dict:
    """The kernel on lengths either side of its first split boundary
    (idle, 1, one page, boundary - 1, boundary, boundary + 1, the table's
    full width), in both dtypes: float32 within 1e-5, bfloat16 within two
    bf16 ulps of the plain value; the idle lane an exact zero row."""
    errs = {}
    H, KV, D, page, maxp = (SPLIT_SHAPE[k] for k in
                            ("H", "KV", "D", "page", "maxp"))
    B = 7
    splits, span = split_plan(
        B, H, KV, maxp * page,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    if splits < 2:
        raise AssertionError(f"split cases: the plan took {splits} split")
    lengths = [0, 1, page, span - 1, span, span + 1, maxp * page]
    for dtype in (torch.float32, torch.bfloat16):
        args = rand_case(9, B=B, H=H, KV=KV, D=D, page=page,
                         n_pages=1 + B * maxp, maxp=maxp, lengths=lengths,
                         dtype=dtype, device=dev)
        name = f"split-boundaries-{str(dtype)[6:]}"
        errs[name] = check_kernel(args, name)
    # The split launch (workspace, split kernel, merge) captured into a
    # CUDA graph and replayed gives the eager output bit for bit.
    eager = paged_attention(*args)
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        paged_attention(*args)  # warm-up on the capture stream
        with torch.cuda.graph(graph, stream=stream):
            captured = paged_attention(*args)
    torch.cuda.current_stream().wait_stream(stream)
    captured.zero_()
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(captured, eager):
        raise AssertionError("split decode replayed from a CUDA graph differs "
                             "from the eager launch")
    errs["split-boundaries-plan"] = {"splits": splits, "span": span,
                                     "lengths": lengths,
                                     "cuda_graph_replay_equal": True}
    return errs


def decode_shape(dev, *, H, KV, D, page, lengths, dtype, seed=0, n_pages=None,
                 maxp=None):
    """Random decode inputs at a given width with ragged ``lengths``; with
    ``maxp`` the table is that wide, null pages past each lane's own (as
    the engine's table rows are)."""
    B = len(lengths)
    used = max(-(-L // page) for L in lengths)
    if n_pages is None:
        n_pages = 1 + B * used
    q, kp, vp, lens, table = rand_case(
        seed, B=B, H=H, KV=KV, D=D, page=page, n_pages=n_pages, maxp=used,
        lengths=lengths, dtype=dtype, device=dev)
    if maxp is not None and maxp > used:
        table = F.pad(table, (0, maxp - used))
    return q, kp, vp, lens, table


def cuda_launches(fn) -> int:
    """CUDA kernels one call of ``fn`` launched, by the paged-decode
    wrapper's counts: the split kernel and, where it ran, the merge."""
    before = paged_attention.launches + paged_attention.merge_launches
    fn()
    return paged_attention.launches + paged_attention.merge_launches - before


def measure(args, flush: L2Flush) -> dict:
    """Kernel, plain and library times and the bound for one input set;
    the kernel also from CUDA-graph replay (no host work), and, where the
    table is wider than its lanes need, at a table cut to their pages."""
    q, kp, vp, lens, table = args
    B, H, D = q.shape
    KV = kp.shape[2]
    page = kp.shape[1]
    err = check_kernel(args, "timed")
    kernel_ms = time_ms(lambda: paged_attention(*args), flush)
    plain_ms = time_ms(lambda: paged_attention_reference(*args), flush)
    # Library yardstick: SDPA over K/V already gathered into contiguous
    # [B, H, T, D] (GQA heads expanded), lengths as a boolean mask, over
    # the pages the longest lane uses (as a caller of SDPA would gather).
    g = H // KV
    used = -(-int(lens.max().item()) // page)
    T = used * page
    kc = kp[table[:, :used].long()].reshape(B, T, KV, D).transpose(1, 2)
    vc = vp[table[:, :used].long()].reshape(B, T, KV, D).transpose(1, 2)
    kc = kc.repeat_interleave(g, dim=1).contiguous()
    vc = vc.repeat_interleave(g, dim=1).contiguous()
    mask = (torch.arange(T, device=q.device)[None, :]
            < lens[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    library_ms = time_ms(
        lambda: F.scaled_dot_product_attention(q4, kc, vc, attn_mask=mask),
        flush)
    esz = q.element_size()
    live = int(lens.sum().item())
    nbytes = (2 * q.numel() * esz + 2 * live * KV * D * esz
              + lens.numel() * 4
              + sum(-(-int(L) // page) for L in lens.tolist()) * 4)
    flops = 4 * live * H * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    splits, span = kernel_plan(q, kp, table)
    row = {
        "B": B, "H": H, "KV": KV, "D": D, "page": page,
        "table_width": table.shape[1], "plan": {"splits": splits,
                                                "span": span},
        "cuda_launches_per_call": cuda_launches(lambda: paged_attention(*args)),
        "dtype": str(q.dtype)[6:], "live_tokens": live,
        "max_abs_err": err, "kernel_ms": kernel_ms,
        "kernel_graph_ms": graph_ms(lambda: paged_attention(*args)),
        "plain_ms": plain_ms,
        "limit": ("2 bf16 ulps of |plain|, floor 1e-5"
                  if q.dtype == torch.bfloat16 else "1e-5"),
        "library_ms": library_ms,
        "library": "F.scaled_dot_product_attention over pre-gathered "
                   "contiguous K/V (a yardstick the port never calls)",
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "flops": flops,
    }
    if used < table.shape[1]:
        narrow = (q, kp, vp, lens, table[:, :used].contiguous())
        row["lane_width_table"] = {
            "table_width": used,
            "plan": dict(zip(("splits", "span"), kernel_plan(q, kp, narrow[4]))),
            "cuda_launches_per_call": cuda_launches(
                lambda: paged_attention(*narrow)),
            "max_abs_err": check_kernel(narrow, "timed-lane-width"),
            "kernel_ms": time_ms(lambda: paged_attention(*narrow), flush),
            "kernel_graph_ms": graph_ms(lambda: paged_attention(*narrow)),
        }
    return row


def build_all() -> dict:
    """Every kernel source built at once, one nvcc each, and the native
    graph engine beside them (the host compiler): seconds and the ptxas
    lines (registers, shared memory, spills) per source.  Then the
    native engine is loaded in this process: it fails if its walks are
    not on."""

    def one(source):
        t0 = time.perf_counter()
        so = _build.build(source)
        log = so.with_suffix(".log").read_text().splitlines()
        return {"build_s": time.perf_counter() - t0,
                "ptxas": [ln.strip() for ln in log
                          if "ptxas info" in ln or "spill" in ln]}

    every = SOURCES + (NATIVE_SOURCE,)
    with ThreadPoolExecutor(len(every)) as ex:
        futures = {src: ex.submit(one, src) for src in every}
    out = {src: f.result() for src, f in futures.items()}
    outcome = _build.outcomes[NATIVE_SOURCE]
    require_native()
    emit({"phase": "native_build", "source": NATIVE_SOURCE,
          "compiler": _build.cxx_version(),
          "build_s": out[NATIVE_SOURCE]["build_s"], "outcome": outcome,
          "available": _native.available()})
    return out


def require_native() -> None:
    """Load the native graph engine in this process (building or
    fetching it where the cache lacks it); raise unless its walks are
    on.  Every process and child of this script that records runs it."""
    _native.ensure()
    if not _native.available():
        raise AssertionError("the native graph engine is not available")


def phase_kernel(dev, flush, build: dict) -> None:
    emit({"phase": "kernel_cases", "kernel": "paged_decode", **build,
          "max_abs_err": kernel_cases(dev)})
    rng = np.random.RandomState(7)
    widths = {
        "llama3-8b": dict(H=32, KV=8, D=128, page=16,
                          lengths=[1] + rng.randint(2, 4097, 6).tolist()
                          + [4096]),
        "gpt2-125m": dict(H=12, KV=12, D=64, page=16,
                          lengths=[1] + rng.randint(2, 1025, 6).tolist()
                          + [1024]),
    }
    for model, shape in widths.items():
        for dtype in (torch.bfloat16, torch.float32):
            args = decode_shape(dev, dtype=dtype, **shape)
            emit({"phase": "kernel_full_width", "kernel": "paged_decode",
                  "model": model, **measure(args, flush)})
            del args


# ---------------------------------------------------------------------------
# phase 6: the flash kernels against their plain versions
# ---------------------------------------------------------------------------


def flash_case(seed, *, B, S, H, D, dtype, dev, T=None, KV=None):
    """q, k, v, do at the kernels' raw layout ([B*H, S, D], [B*KV, T, D]),
    from a numpy seed."""
    T = S if T is None else T
    KV = H if KV is None else KV
    rng = np.random.RandomState(seed)
    shapes = ((B * H, S, D), (B * KV, T, D), (B * KV, T, D), (B * H, S, D))
    return tuple(torch.from_numpy(rng.randn(*sh).astype(np.float32))
                 .to(dev, dtype) for sh in shapes)


def dbias_magnitude(q, k, v, do, lse, delta, causal, seg, bias, heads):
    """[Hb, S, T] in q's dtype (float64 here): the sum over each bias
    plane's rows of p * (|dp| + |delta|), dp = do . v, the size of the
    terms whose float32 sum the d(bias) kernel forms."""
    s, mask, _ = _dense_probs(q, k, causal, seg, bias, heads)
    p = torch.where(mask, torch.exp(s - lse[:, :, None]), 0.0)
    del s, mask
    G = q.shape[0] // k.shape[0]
    dp = torch.bmm(do, v.repeat_interleave(G, dim=0).transpose(1, 2))
    size = p * (dp.abs() + delta.abs()[:, :, None])
    del p, dp
    return size.view(-1, bias.shape[0], *size.shape[1:]).sum(0)


def check_flash(args, name: str, *, causal: bool, atol: float,
                seg=None, normwise: bool = False, bias=None,
                heads=None, blocks=(None, None)) -> dict:
    """The three kernels against the plain versions on the same card
    inputs; the backward kernels get the plain forward's lse and delta, so
    each kernel is held on its own (the kernel's own lse is held to the
    plain one within LSE_RTOL, so the training backward, which reads it,
    sees the same input).  A float32 kernel is held against the plain
    versions evaluated in float64, the exact answer (two float32
    evaluations of sums of up to G * S = 8192 products, the dk/dv of
    llama3-8b width, differ from each other by more than 1e-5).

    lse, float32 in both dtypes, is held to |kernel - plain| <= LSE_RTOL *
    max(1, |plain|).  With ``normwise`` (bfloat16 at the training shapes)
    each other output is held to ||kernel - plain||_2 / ||plain||_2 <=
    BF16_NORM_RTOL; otherwise to |kernel - plain| <= atol * max(1,
    |plain|), absolute up to magnitude 1 and relative above it (the
    tests/test_ops.py band).  Rows that see no key must be exactly zero
    in the kernels (output and dq) with lse <= -1e29; they are left out
    of the error.  With a ``bias`` (f32 [H or 1, S, T]) the d(bias)
    kernel is held too; in float32 its relative part is taken against
    the size of the terms it sums, not against their sum: |kernel -
    plain| <= atol * max(1, m), m = dbias_magnitude(...) >= |plain|.
    The kernel forms p * (dp - delta) with dp = do . v a D-term float32
    sum, so its rounding scales with |dp| + |delta|, and where dp
    cancels delta (a causal row's first key, where p = 1 and dp =
    delta) it does not shrink with the result.  ``dbias_vs_plain`` keeps
    the reading against max(1, |plain|) beside it.  Returns max |kernel
    - plain| per output, the largest scaled error and the normwise error
    per output.  ``blocks`` is the forward's and dq's launch shape
    ``(block_q, block_k)``, the default rule's by default."""
    q, k, v, do = args
    bq, bk = blocks
    f32 = q.dtype == torch.float32
    ref = [t.double() for t in args] if f32 else args
    r_bias = bias.double() if f32 and bias is not None else bias
    out, lse = flash_forward(q, k, v, causal=causal, segment_ids=seg,
                             bias=bias, heads=heads, block_q=bq, block_k=bk)
    r_out, r_lse = flash_forward_reference(*ref[:3], causal, seg, r_bias,
                                           heads)
    delta = (ref[3].to(r_lse.dtype) * r_out.to(r_lse.dtype)).sum(-1)
    grads = flash_backward(q, k, v, do, r_lse.float(), delta.float(),
                           causal=causal, segment_ids=seg, bias=bias,
                           heads=heads, want_dbias=bias is not None,
                           block_q=bq, block_k=bk)
    r_grads = flash_backward_reference(*ref, r_lse, delta, causal, seg, r_bias,
                                       heads)
    dq, dk, dv = grads[:3]
    r_dq, r_dk, r_dv = r_grads[:3]
    torch.cuda.synchronize()
    if out.dtype != q.dtype or out.shape != q.shape or lse.shape != q.shape[:2]:
        raise AssertionError(f"{name}: output {out.dtype} {tuple(out.shape)}")
    live = r_lse > -1e29
    if not (bool(torch.all(out[~live] == 0)) and bool(torch.all(dq[~live] == 0))
            and bool(torch.all(lse[~live] <= -1e29))):
        raise AssertionError(f"{name}: rows that see no key are not zero")
    errs, scaled, norm = {}, 0.0, {}
    outputs = [("out", out[live], r_out[live]), ("lse", lse[live], r_lse[live]),
               ("dq", dq[live], r_dq[live]), ("dk", dk, r_dk), ("dv", dv, r_dv)]
    if bias is not None:
        outputs.append(("dbias", grads[3], r_grads[3]))
    for what, a, b in outputs:
        if not a.numel():
            errs[what] = 0.0
            continue
        diff = (a.double() - b.double()).abs()
        size = b.double().abs()
        if what == "dbias" and f32:
            errs["dbias_vs_plain"] = (diff / size.clamp_min(1.0)).max().item()
            size = dbias_magnitude(*ref, r_lse, delta, causal, seg, r_bias,
                                   heads)
        rel = (diff / size.clamp_min(1.0)).max().item()
        del size
        b_norm = b.double().norm().item()
        nrm = (diff.norm().item() / b_norm if b_norm
               else (0.0 if not diff.any() else math.inf))
        if what != "lse":
            norm[what] = nrm
        if what == "lse" and not rel <= LSE_RTOL:
            raise AssertionError(
                f"{name}: |kernel - plain| of lse is {rel} x max(1, |plain|)"
                f" > {LSE_RTOL}")
        if what != "lse" and normwise and not nrm <= BF16_NORM_RTOL:
            raise AssertionError(
                f"{name}: ||kernel - plain|| / ||plain|| of {what} is {nrm} "
                f"> {BF16_NORM_RTOL}")
        if what != "lse" and not normwise and not rel <= atol:
            raise AssertionError(
                f"{name}: |kernel - plain| of {what} is {rel} x max(1, "
                f"{'m' if what == 'dbias' else '|plain|'}) > {atol}")
        errs[what] = diff.max().item()
        if what != "lse":
            scaled = max(scaled, rel)
    errs["scaled"] = scaled
    errs["normwise"] = norm
    return errs


def _segments(kind: str, B: int, dev):
    """The segment layouts of tests/test_ops.py."""
    def ids(*runs):
        row = np.concatenate([np.full(n, i, np.int32) for i, n in
                              enumerate(runs)])
        return torch.from_numpy(np.tile(row, (B, 1))).to(dev)

    if kind == "three":  # 3 documents packed into 50
        seg = ids(20, 18, 12)
        return seg, seg
    if kind == "halves":
        seg = ids(16, 16)
        return seg, seg
    return ids(12, 12), ids(25, 15)  # a cross-attention pair, S=24, T=40


FLASH_CASES = (  # name, shape, causal, segments
    ("matches-xla-causal", dict(B=2, S=64, H=4, D=16), True, None),
    ("matches-xla-full", dict(B=2, S=64, H=4, D=16), False, None),
    ("gqa-grouping", dict(B=1, S=32, H=8, KV=2, D=16), True, None),
    ("mqa", dict(B=1, S=32, H=8, KV=1, D=16), True, None),
    ("ragged-50-causal", dict(B=1, S=50, H=2, D=16), True, None),
    ("ragged-50-full", dict(B=1, S=50, H=2, D=16), False, None),
    ("cross-24x64-causal", dict(B=1, S=24, T=64, H=2, D=16), True, None),
    ("cross-24x64-full", dict(B=1, S=24, T=64, H=2, D=16), False, None),
    ("cross-64x24-causal-empty-rows", dict(B=1, S=64, T=24, H=2, D=16), True,
     None),
    ("bfloat16-32", dict(B=1, S=32, H=2, D=16), True, None),
    ("grads-48-causal", dict(B=1, S=48, H=2, D=16), True, None),
    ("grads-48-full", dict(B=1, S=48, H=2, D=16), False, None),
    ("grads-gqa", dict(B=1, S=32, H=4, KV=2, D=16), True, None),
    ("segments-causal", dict(B=2, S=50, H=4, D=16), True, "three"),
    ("segments-full", dict(B=2, S=50, H=4, D=16), False, "three"),
    ("segments-gqa", dict(B=2, S=32, H=4, KV=2, D=16), True, "halves"),
    ("segments-cross-pair", dict(B=1, S=24, T=40, H=2, D=16), False, "pair"),
    ("head-dim-32", dict(B=1, S=80, H=2, KV=1, D=32), True, None),
    ("head-dim-64", dict(B=1, S=80, H=2, KV=1, D=64), True, None),
    ("head-dim-128", dict(B=1, S=80, H=2, KV=1, D=128), True, None),
    # The bf16 dk/dv kernel's tiles (64 keys; 64 queries, 32 at D = 128)
    # at every head dim it is built for beyond 16, S and T multiples of
    # neither: ragged q tiles, ragged k tiles and warps past T.
    ("dkv-ragged-d32-causal-gqa", dict(B=2, S=100, T=150, H=4, KV=2, D=32),
     True, None),
    ("dkv-ragged-d64-full-mqa", dict(B=2, S=150, T=100, H=4, KV=1, D=64),
     False, None),
    ("dkv-ragged-d128-causal-gqa", dict(B=1, S=114, T=178, H=4, KV=2, D=128),
     True, None),
    ("dkv-ragged-d128-full", dict(B=1, S=114, T=114, H=2, D=128), False, None),
    ("dkv-d128-segments-causal", dict(B=2, S=50, H=4, D=128), True, "three"),
    # The bf16 forward and dq kernels' tiles (64 rows, 64 keys) at D = 128:
    # causal with S > T, so the first 50 rows see no key, a ragged last q
    # tile and GQA.
    ("fq-ragged-d128-causal-empty-rows", dict(B=1, S=150, T=100, H=4, KV=2,
                                              D=128), True, None),
    # ViT's attention: non-causal, D = 64, S = 197 (196 patches and the
    # class token), ragged against every tile.
    ("vit-ragged-197-d64-full", dict(B=2, S=197, H=16, D=64), False, None),
)


def flash_cases(dev) -> dict:
    """Every bias-free case of tests/test_ops.py in both dtypes (plus MQA,
    causal S > T, whose first rows see no key, and the other head dims),
    a TINY llama on the flash kernels against default_attention, and the
    wrapper's validation."""
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, shape, causal, segs in FLASH_CASES:
            args = flash_case(0, dtype=dtype, dev=dev, **shape)
            seg = None if segs is None else _segments(segs, shape["B"], dev)
            tag = f"{name}-{str(dtype)[6:]}"
            errs[tag] = check_flash(args, tag, causal=causal, seg=seg,
                                    atol=ATOL[dtype])
    # A whole model on the kernels by constructor argument (f32 logits
    # within the 1e-4 the port's model tests use against flax).
    cfg = PRESETS["tiny"]
    torch.manual_seed(0)
    flash_model = make_llama(cfg, attn_fn=make_flash_attention(), device=dev)
    plain_model = make_llama(cfg, device=dev)
    plain_model.load_state_dict(flash_model.state_dict())
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (2, 40))).to(dev)
    with torch.no_grad():
        err = (flash_model(toks) - plain_model(toks)).abs().max().item()
    if not err <= 1e-4:
        raise AssertionError(f"TINY llama on the flash kernels: logits {err}")
    errs["tiny-llama-logits"] = err
    # Validation raises before anything launches.
    z = dict(device=dev)
    q, kv = torch.zeros(1, 16, 8, 16, **z), torch.zeros(1, 16, 3, 16, **z)
    attn = make_flash_attention()
    for call, exc, what in (
        (lambda: attn(q, kv, kv), ValueError, "multiple of KV heads"),
        (lambda: attn(q, q, q, segment_ids=torch.zeros(1, 17, **z)),
         ValueError, "segment_ids must be"),
        (lambda: attn(q, q, q, bias=torch.zeros(3, 16, 16, **z)),
         ValueError, "bias must be"),
        (lambda: flash_forward(q[0], q[0], q[0], bias=torch.zeros(
            1, 8, 8, dtype=torch.bfloat16, **z)), TypeError, "float32"),
        (lambda: attn(q[..., :8], q[..., :8], q[..., :8]), ValueError,
         "head_dim"),
    ):
        try:
            call()
        except exc as e:
            if what not in str(e):
                raise AssertionError(f"validation: {e!r} lacks {what!r}")
        else:
            raise AssertionError(f"validation: no error for {what!r}")
    errs["validation"] = 0.0
    return errs


FLASH_WIDTHS = {  # the training shapes: batch, sequence, heads, head dim
    "llama3-8b": dict(B=TRAIN_BATCH, S=TRAIN_SEQ, H=32, KV=8, D=128),
    "gpt2-125m": dict(B=4, S=1024, H=12, KV=12, D=64),
    "vit-l16": dict(B=32, S=197, H=16, KV=16, D=64),
}
FLASH_NON_CAUSAL = {"vit-l16"}  # encoders: every query sees every key


def visible_pairs(S: int, T: int, causal: bool) -> int:
    """(query, key) pairs that attend: all, or up to the causal diagonal
    (query i sees keys j <= i + T - S)."""
    if not causal:
        return S * T
    return sum(min(T, max(0, i + T - S + 1)) for i in range(S))


def flash_bound(name: str, *, B, S, H, KV, D, dtype, T=None, causal=True,
                Hb=0) -> dict:
    """The least time of kernel ``name``: its own matrix-product flops over
    the visible (query, key) pairs over the dtype's peak, or the bytes it
    must move (each input read once, each output written once; an f32
    [Hb, S, T] bias once, and d(bias) once) over 3.35 TB/s, whichever is
    larger."""
    T = S if T is None else T
    pairs = visible_pairs(S, T, causal)
    esz = torch.empty((), dtype=dtype).element_size()
    qb, kb, rb = B * H * S * D * esz, B * KV * T * D * esz, B * H * S * 4
    bb = Hb * S * T * 4
    products = {"flash_fwd": 2, "flash_bwd_dq": 3, "flash_bwd_dkv": 4,
                "flash_dbias": 2}[name]
    flops = 2 * products * B * H * D * pairs
    nbytes = {"flash_fwd": 2 * qb + 2 * kb + rb + bb,  # q, k, v -> o, lse
              "flash_bwd_dq": 3 * qb + 2 * kb + 2 * rb + bb,  # +do, delta
              "flash_bwd_dkv": 2 * qb + 4 * kb + 2 * rb + bb,  # -> dk, dv
              "flash_dbias": 2 * qb + 2 * kb + 2 * rb + 2 * bb}[name]
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def measure_flash(dev, flush, model: str, dtype) -> dict:
    """Kernel, plain and library times and the bound of each flash kernel
    at a training shape (causal but for the encoders'), after holding the
    kernels against the plain versions there."""
    shape = FLASH_WIDTHS[model]
    causal = model not in FLASH_NON_CAUSAL
    B, S, H, KV, D = (shape[k] for k in ("B", "S", "H", "KV", "D"))
    args = flash_case(11, dtype=dtype, dev=dev, **shape)
    bf16 = dtype == torch.bfloat16
    errs = check_flash(args, f"{model}-{str(dtype)[6:]}", causal=causal,
                       atol=ATOL[dtype], normwise=bf16)
    q, k, v, do = args
    out, lse = flash_forward(q, k, v, causal=causal)
    delta = (do.float() * out.float()).sum(-1)
    kernel_ms = {
        "flash_fwd": time_ms(lambda: flash_forward(q, k, v, causal=causal),
                             flush),
        "flash_bwd_dq": time_ms(lambda: flash_backward_dq(
            q, k, v, do, lse, delta, causal=causal), flush),
        "flash_bwd_dkv": time_ms(lambda: flash_backward_dkv(
            q, k, v, do, lse, delta, causal=causal), flush),
    }
    plain_fwd = time_ms(lambda: flash_forward_reference(q, k, v, causal),
                        flush, 5)
    plain_bwd = time_ms(lambda: flash_backward_reference(
        q, k, v, do, lse, delta, causal), flush, 5)
    lib = sdpa_yardstick(q.view(B, H, S, D), k.view(B, KV, S, D),
                         v.view(B, KV, S, D), do.view(B, H, S, D), None,
                         causal, flush)
    lib_fwd, lib_bwd = lib["fwd_ms"], lib["bwd_ms"]
    err = {"flash_fwd": max(errs["out"], errs["lse"]),  # absolute
           "flash_bwd_dq": errs["dq"],
           "flash_bwd_dkv": max(errs["dk"], errs["dv"])}
    kernels = {}
    for name in FLASH_REPLACES:
        kernels[name] = {
            "max_abs_err": err[name], "kernel_ms": kernel_ms[name],
            "plain_ms": plain_fwd if name == "flash_fwd" else plain_bwd,
            "library_ms": lib_fwd if name == "flash_fwd" else lib_bwd,
            **flash_bound(name, B=B, S=S, H=H, KV=KV, D=D, dtype=dtype,
                          causal=causal)}
    return {"phase": "flash_full_width", "model": model,
            "dtype": str(dtype)[6:], "shape": shape, "causal": causal,
            "limit": (f"||kernel - plain|| / ||plain|| <= {BF16_NORM_RTOL}"
                      if bf16 else f"{ATOL[dtype]} x max(1, |plain|)")
            + f"; lse {LSE_RTOL} x max(1, |plain|)",
            "max_abs_err": errs,
            "plain": "flash_forward_reference / flash_backward_reference "
                     "(the backward's plain version computes dq, dk and dv "
                     "in one call; its time stands for both kernels)",
            "library": f"F.scaled_dot_product_attention(is_causal={causal}, "
                       "enable_gqa=True) forward / its autograd backward "
                       "(a yardstick the port never calls)",
            "library_backend": lib["backend"],
            "kernels": kernels}


def launch_shape(which: int, D: int, dtype, bias: bool = False) -> dict:
    """CTAs per SM, threads and dynamic shared memory of flash kernel
    ``which`` (0 forward, 1 dq, 2 dk/dv, 3 d(bias)), as the CUDA runtime's
    occupancy calculator gives them for the launch the wrappers make, with
    or without a bias."""
    fn = _build.load("flash_attention.cu").tdx_flash_launch_shape
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    shape = (ctypes.c_int * 3)()
    err = fn(which, D, {torch.float32: 0, torch.bfloat16: 1}[dtype], int(bias),
             shape)
    if err:
        raise RuntimeError(f"tdx_flash_launch_shape({which}, {D}): error {err}")
    return {"ctas_per_sm": shape[0], "threads": shape[1],
            "smem_bytes": shape[2]}


# The bf16 register kernels: which (for launch_shape), the template
# arguments ptxas must report (head dim, and warps a CTA for the forward
# and dq: 8 only at D = 128 with a bias).
BF16_KERNELS = {
    "flash_fwd_bf16_kernel": (0, ["16-4", "32-4", "64-4", "128-4", "128-8"]),
    "flash_dq_bf16_kernel": (1, ["16-4", "32-4", "64-4", "128-4", "128-8"]),
    "flash_dkv_bf16_kernel": (2, ["16", "32", "64", "128"]),
    "flash_dbias_bf16_kernel": (3, ["16", "32", "64", "128"]),
}


def bf16_build(build: dict) -> dict:
    """Registers and spills (ptxas's lines of the build) of each
    instantiation of the bf16 forward, dq, dk/dv and d(bias) kernels, and
    the launch shape of each at every head dim, without and with a bias
    (the same for d(bias), which always has one).  Fails on any spill: the design keeps the
    accumulators and the score fragments in registers, and a spill moves
    them to local memory."""
    rows = {}
    for fn, row in ptxas_table(build.get("ptxas", [])).items():
        m = re.search(r"(flash_(?:fwd|dq|dkv|dbias)_bf16_kernel)((?:ILi\d+E)"
                      r"(?:Li\d+E)?)", fn)
        if m:
            inst = "-".join(re.findall(r"\d+", m.group(2)))
            rows.setdefault(m.group(1), {})[inst] = row
    out = {}
    for name, (which, insts) in BF16_KERNELS.items():
        got = rows.get(name, {})
        if sorted(got) != sorted(insts):
            raise AssertionError(f"ptxas lines for {name} at {sorted(got)}, "
                                 f"not {insts}")
        for inst, row in got.items():
            if row.get("spill_stores", 1) or row.get("spill_loads", 1):
                raise AssertionError(f"{name}<{inst}> spills: {row}")
        launch = {str(D): {"no_bias": launch_shape(which, D, torch.bfloat16),
                           "bias": launch_shape(which, D, torch.bfloat16,
                                                True)}
                  for D in (16, 32, 64, 128)}
        out[name] = {"instances": {i: got[i] for i in insts},
                     "launch": launch}
    return out


# The hi/lo split of dS in the bf16 dk/dv kernel, held on the card.  Each
# row of dS sums to zero, so sum_j dK_j = sum_i (sum_j dS_ij) q_i = 0
# exactly.  A query component c shared by every row (in head dims that
# every key leaves at zero, so the scores do not see it) turns an error
# e_i in row i's sum into e_i * c, while the true dK stays small:
# near-uniform attention and dO rows in +/- pairs leave the columns of dS
# summing to ~0 too.  dS rounded once to bf16 (2**-9 relative) then
# leaves ||sum_j dK_j|| / ||dK|| at 0.054 and dK 2.2e-2 off normwise,
# where the exact dK rounded once to bf16 gives 1.8e-3 (both computed on
# the CPU by tests/test_torch_flash_attention.py).  The kernel is held to
# twice the latter, and normwise to BF16_NORM_RTOL.
DK_SUM_SHAPE = dict(BH=2, S=256, D=128, shared=64.0)


def dk_sum_case(seed, *, BH, S, D, shared):
    """q, k, v, do as float64 numpy arrays [BH, S, D] (S = T)."""
    rng = np.random.RandomState(seed)
    h = D // 2
    q = rng.randn(BH, S, D) * 0.1
    q[:, :, :h] = shared * rng.randn(BH, 1, h) + rng.randn(BH, S, h)
    k = rng.randn(BH, S, D)
    k[:, :, :h] = 0.0
    v = rng.randn(BH, S, D)
    do = rng.randn(BH, S // 2, D)
    return q, k, v, np.concatenate([do, -do], 1)


def check_dk_sum(dev) -> dict:
    """||sum_j dK_j|| / ||dK|| of the bf16 kernel against that of the exact
    dK rounded once to bf16 (see DK_SUM_SHAPE)."""
    q, k, v, do = (torch.from_numpy(a).to(dev, torch.bfloat16)
                   for a in dk_sum_case(0, **DK_SUM_SHAPE))
    ref = [t.double() for t in (q, k, v, do)]
    r_out, r_lse = flash_forward_reference(*ref[:3], False)
    delta = (ref[3] * r_out).sum(-1)
    dk = flash_backward_dkv(q, k, v, do, r_lse.float(), delta.float(),
                            causal=False)[0]
    r_dk = flash_backward_reference(*ref, r_lse, delta, False)[1]
    torch.cuda.synchronize()

    def sum_ratio(x):
        x = x.double()
        return (x.sum(1).norm() / x.norm()).item()

    got, exact = sum_ratio(dk), sum_ratio(r_dk.to(torch.bfloat16))
    normwise = ((dk.double() - r_dk).norm() / r_dk.norm()).item()
    if not got <= 2 * exact:
        raise AssertionError(
            f"bf16 dk/dv: ||sum_j dK_j|| / ||dK|| = {got} > 2 x {exact}, the "
            f"exact dK rounded to bf16 once: the hi/lo split of dS is lost")
    if not normwise <= BF16_NORM_RTOL:
        raise AssertionError(f"bf16 dk/dv on the dK-sum case: dK {normwise} "
                             f"off normwise > {BF16_NORM_RTOL}")
    return {"dk_sum_ratio": got, "exact_rounded_sum_ratio": exact,
            "limit": f"<= 2 x exact_rounded_sum_ratio; dK normwise <= "
                     f"{BF16_NORM_RTOL}", "dk_normwise": normwise}


# dq's hi/lo split of dS, held on the card.  Keys sharing a large
# component c (k_j = c + n_j) shift each query's scores by q_i . c, which
# cancels in the softmax, and sum_j dS_ij = 0 cancels c from the true dq =
# sum_j dS_ij k_j too.  dS rounded once to bf16 leaves about 2**-9 of each
# row's sum_j |dS_ij| in that sum, times c: with near-uniform attention dq
# is then 0.10 off normwise, where the exact dq rounded once to bf16 is
# 1.7e-3 off and dS split into hi + lo gives the same 1.7e-3 (both
# computed on the CPU by tests/test_torch_flash_attention.py).  The kernel
# is held to twice the exact dq's rounding.
DQ_SHARED_SHAPE = dict(BH=2, S=256, D=128, shared=64.0)


def dq_shared_case(seed, *, BH, S, D, shared):
    """q, k, v, do as float64 numpy arrays [BH, S, D] (S = T)."""
    rng = np.random.RandomState(seed)
    q = rng.randn(BH, S, D) * 0.1
    k = shared * rng.randn(BH, 1, D) + rng.randn(BH, S, D)
    v = rng.randn(BH, S, D)
    return q, k, v, rng.randn(BH, S, D)


def check_dq_shared(dev) -> dict:
    """The bf16 dq kernel's error against f64 on the case above, against
    that of the exact dq rounded once to bf16."""
    q, k, v, do = (torch.from_numpy(a).to(dev, torch.bfloat16)
                   for a in dq_shared_case(0, **DQ_SHARED_SHAPE))
    ref = [t.double() for t in (q, k, v, do)]
    r_out, r_lse = flash_forward_reference(*ref[:3], False)
    delta = (ref[3] * r_out).sum(-1)
    dq = flash_backward_dq(q, k, v, do, r_lse.float(), delta.float(),
                           causal=False)
    r_dq = flash_backward_reference(*ref, r_lse, delta, False)[0]
    torch.cuda.synchronize()

    def off(x):
        return ((x.double() - r_dq).norm() / r_dq.norm()).item()

    got, exact = off(dq), off(r_dq.to(torch.bfloat16))
    if not got <= 2 * exact:
        raise AssertionError(
            f"bf16 dq: {got} off normwise > 2 x {exact}, the exact dq rounded "
            f"to bf16 once: the hi/lo split of dS is lost")
    return {"dq_normwise": got, "exact_rounded_normwise": exact,
            "limit": "dq_normwise <= 2 x exact_rounded_normwise"}


# The forward's normalizer, held on the card.  Values sharing a large
# component c (v_j = c + n_j) give O = c + a convex combination of the
# n_j, so O - c is all that the keys decide.  Dividing P V by the sum of
# the same bf16(p) it multiplied keeps c exact; dividing by the exact sum
# of p leaks (sum bf16(p) - sum p) / sum p times c.  With near-uniform
# attention the kept rounding (evaluated in f64) leaves O 1.7e-3 off
# normwise relative to ||O - c||, the exact normalizer 0.115 (both
# computed on the CPU by tests/test_torch_flash_attention.py).  The
# forward's f32 copy of O is held to twice the former.
O_SHARED_SHAPE = dict(BH=2, S=256, D=128, shared=64.0)


def o_shared_case(seed, *, BH, S, D, shared):
    """q, k, v as float64 numpy arrays [BH, S, D] (S = T), and the shared
    value c [BH, 1, D]."""
    rng = np.random.RandomState(seed)
    q = rng.randn(BH, S, D) * 0.3
    k = rng.randn(BH, S, D)
    c = shared * rng.randn(BH, 1, D)
    return q, k, c + rng.randn(BH, S, D), c


def kept_rounding_output(q, k, v):
    """The forward's kept rounding, evaluated in q's dtype (f64): P rounded
    once to bf16, O = sum bf16(p) v / sum bf16(p), no mask."""
    s = torch.bmm(q, k.transpose(1, 2)) / math.sqrt(q.shape[-1])
    p = torch.exp(s - s.amax(-1, keepdim=True)).to(torch.bfloat16).to(q.dtype)
    return torch.bmm(p, v) / p.sum(-1, keepdim=True)


def check_o_shared(dev) -> dict:
    """The bf16 forward's f32 O against f64 on the case above, normwise
    relative to ||O - c||, against the kept rounding's error."""
    *qkv, c = o_shared_case(0, **O_SHARED_SHAPE)
    q, k, v = (torch.from_numpy(a).to(dev, torch.bfloat16) for a in qkv)
    ref = [t.double() for t in (q, k, v)]
    r_out = flash_forward_reference(*ref, False)[0]
    o32 = _flash_forward(q, k, v, False, None, None, None, True)[2]
    kept = kept_rounding_output(*ref)
    torch.cuda.synchronize()
    size = (r_out - torch.from_numpy(c).to(dev)).norm()

    def off(x):
        return ((x.double() - r_out).norm() / size).item()

    got, yardstick = off(o32), off(kept)
    if not got <= 2 * yardstick:
        raise AssertionError(
            f"bf16 forward: O - c {got} off normwise > 2 x {yardstick}, the "
            f"kept rounding's: O is not normalized by the sum of the bf16 P "
            f"it multiplied")
    return {"o_minus_c_normwise": got, "kept_rounding_normwise": yardstick,
            "limit": "o_minus_c_normwise <= 2 x kept_rounding_normwise"}


def phase_flash_kernel(dev, flush, build: dict) -> dict:
    emit({"phase": "flash_kernel_cases", "kernel": "flash_attention", **build,
          "bf16_build": bf16_build(build),
          "max_abs_err": flash_cases(dev)})
    emit({"phase": "flash_dkv_bf16_dk_sum", "shape": DK_SUM_SHAPE,
          **check_dk_sum(dev)})
    emit({"phase": "flash_dq_bf16_shared_key", "shape": DQ_SHARED_SHAPE,
          **check_dq_shared(dev)})
    emit({"phase": "flash_fwd_bf16_shared_value", "shape": O_SHARED_SHAPE,
          **check_o_shared(dev)})
    rows = {}
    for model in FLASH_WIDTHS:
        for dtype in (torch.bfloat16, torch.float32):
            row = measure_flash(dev, flush, model, dtype)
            emit(row)
            rows[(model, row["dtype"])] = row
            torch.cuda.empty_cache()
    return rows


# The launch-shape tuner at the training main path's attention shape.
TUNE_SHAPE = dict(batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, heads=32, kv_heads=8,
                  head_dim=128)


def phase_flash_tune(dev, flush) -> dict:
    """``tune_flash_blocks`` at the llama shape (B 2, S = T = 2048, H 32,
    KV 8, D 128, causal, bf16) for the ``fwd`` and ``bwd`` workloads into
    a fresh cache: ms per step of its chain for each launch shape, the
    winner, and a second call served from the cache with 0 measurements.
    Then every built shape (the winners among them) held against the
    plain versions in the bf16 band (normwise BF16_NORM_RTOL), with the
    forward's and dq's kernel ms at it beside the default rule's."""
    dtype = torch.bfloat16
    D = TUNE_SHAPE["head_dim"]
    tmp = tempfile.mkdtemp(prefix="tdx_tune_")
    workloads = {}
    try:
        with tdx_config.override(cache_dir=tmp):
            for wl in ("fwd", "bwd"):
                autotune.reset_counts()
                t = time.perf_counter()
                win = autotune.tune_flash_blocks(**TUNE_SHAPE, causal=True,
                                                 dtype=dtype, workload=wl)
                tune_s = time.perf_counter() - t
                timings = dict(autotune.last_timings)
                measured = autotune.measurements
                again = autotune.tune_flash_blocks(**TUNE_SHAPE, causal=True,
                                                   dtype=dtype, workload=wl)
                if again != win or autotune.measurements != measured:
                    raise AssertionError(f"{wl}: the second call measured "
                                         f"{autotune.measurements - measured}"
                                         f" candidates, returned {again}")
                workloads[wl] = {
                    "winner": list(win), "tune_s": tune_s,
                    "measured": measured, "second_call_measurements": 0,
                    "chain_ms_per_step": {f"{bq}x{bk}": t * 1e3
                                          for (bq, bk), t in timings.items()}}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    B, S, H, KV = (TUNE_SHAPE[k] for k in ("batch", "seq_len", "heads",
                                           "kv_heads"))
    args = flash_case(11, B=B, S=S, H=H, KV=KV, D=D, dtype=dtype, dev=dev)
    q, k, v, do = args
    shapes = {}
    for bq, bk in built_blocks(dtype, D):
        errs = check_flash(args, f"llama3-8b-{bq}x{bk}", causal=True,
                           atol=ATOL[dtype], normwise=True, blocks=(bq, bk))
        out, lse = flash_forward(q, k, v, causal=True, block_q=bq, block_k=bk)
        delta = (do.float() * out.float()).sum(-1)
        shapes[f"{bq}x{bk}"] = {
            "warps": bq // 16, "normwise": errs["normwise"],
            "flash_fwd_ms": time_ms(lambda: flash_forward(
                q, k, v, causal=True, block_q=bq, block_k=bk), flush),
            "flash_bwd_dq_ms": time_ms(lambda: flash_backward_dq(
                q, k, v, do, lse, delta, causal=True, block_q=bq,
                block_k=bk), flush)}
    out, lse = flash_forward(q, k, v, causal=True)
    delta = (do.float() * out.float()).sum(-1)
    default = {"warps": 4,
               "flash_fwd_ms": time_ms(lambda: flash_forward(
                   q, k, v, causal=True), flush),
               "flash_bwd_dq_ms": time_ms(lambda: flash_backward_dq(
                   q, k, v, do, lse, delta, causal=True), flush)}
    try:
        flash_forward(q[:, :64, :64].contiguous(), k[:, :64, :64].contiguous(),
                      v[:, :64, :64].contiguous(), causal=True, block_q=128,
                      block_k=64)
        raise AssertionError("a block the library does not build launched")
    except BlockConfigError as e:
        refused = str(e)[:200]
    row = {"phase": "flash_tune", "card": nvidia_smi(),
           "shape": {**TUNE_SHAPE, "causal": True, "dtype": "bfloat16"},
           "workloads": workloads, "built_blocks": shapes,
           "default_rule": default,
           "limit": f"||kernel - plain|| / ||plain|| <= {BF16_NORM_RTOL}",
           "unbuilt_block_refused": refused}
    emit(row)
    del args, q, k, v, do, out, lse, delta
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# phase 9: the flash kernels with a bias, and the d(bias) kernel
# ---------------------------------------------------------------------------

BIAS_CASES = (  # name, shape, causal, bias planes (H or 1), segments
    # test_bias_kernel_matches_xla and test_bias_gradients_match_xla (S=50)
    ("bias-50-causal-full", dict(B=2, S=50, H=4, D=16), True, "H", None),
    ("bias-50-causal-broadcast", dict(B=2, S=50, H=4, D=16), True, "1", None),
    ("bias-50-noncausal-full", dict(B=2, S=50, H=4, D=16), False, "H", None),
    ("bias-50-noncausal-broadcast", dict(B=2, S=50, H=4, D=16), False, "1",
     None),
    # test_bias_gradients_match_xla (S=48)
    ("bias-48-causal-full", dict(B=2, S=48, H=4, D=16), True, "H", None),
    ("bias-48-causal-broadcast", dict(B=2, S=48, H=4, D=16), True, "1", None),
    ("bias-gqa-cross-24x64", dict(B=1, S=24, T=64, H=8, KV=2, D=16), True, "H",
     None),
    ("bias-segments-gqa", dict(B=2, S=32, H=4, KV=2, D=16), True, "H",
     "halves"),
    # The bf16 dk/dv kernel's bias tile: 16-byte copies (T a multiple of
    # 4) with ragged q and k tiles, and 4-byte copies (T = 114) at D = 128.
    ("bias-dkv-ragged-d64-broadcast", dict(B=2, S=70, T=100, H=4, D=64),
     False, "1", None),
    ("bias-dkv-ragged-d128-causal", dict(B=1, S=114, T=114, H=2, D=128), True,
     "H", None),
    # The bf16 forward and dq kernels' bias tile by 4-byte copies (T = 114)
    # at D = 64, one plane for every head, causal with T > S.
    ("bias-fq-d64-broadcast-t114", dict(B=2, S=70, T=114, H=4, D=64), True,
     "1", None),
    # The bf16 d(bias) kernel's ring of rows (BQ 64, BK 128, every row of a
    # plane walked by one CTA): one plane for all B*H = 16 rows with GQA;
    # ragged S and T, T % 4 != 0, at D = 128; segments at D = 32; causal
    # with T > S and GQA at D = 128.
    ("bias-ring-rows-broadcast-gqa", dict(B=4, S=70, T=90, H=4, KV=2, D=64),
     False, "1", None),
    ("bias-ring-ragged-d128-t130", dict(B=3, S=100, T=130, H=2, D=128), False,
     "H", None),
    ("bias-ring-segments-d32", dict(B=2, S=50, H=4, KV=2, D=32), True, "1",
     "three"),
    ("bias-ring-causal-t-gt-s-d128", dict(B=2, S=60, T=150, H=4, KV=2,
                                          D=128), True, "H", None),
)
# T5-11B's attention at the T5 main path's batch: 128 heads of 128 (MHA).
T5_SHAPES = {
    "t5-encoder-self": dict(B=T5_BATCH, S=T5_ENC, T=T5_ENC, causal=False,
                            bias=True),
    "t5-decoder-self": dict(B=T5_BATCH, S=T5_DEC, T=T5_DEC, causal=True,
                            bias=True),
    "t5-cross": dict(B=T5_BATCH, S=T5_DEC, T=T5_ENC, causal=False, bias=False),
}


def bias_plane(seed, Hb, S, T, dev) -> torch.Tensor:
    """An f32 [Hb, S, T] bias from a numpy seed."""
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randn(Hb, S, T).astype(np.float32)).to(dev)


def flash_bias_cases(dev) -> dict:
    """The bias cases of tests/test_ops.py in both dtypes (every case runs
    the forward, dq, dk/dv and d(bias) kernels), a TINY T5 on the flash
    kernels against default_attention, and the relative-position bucket
    maps on the card against the CPU's."""
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, shape, causal, planes, segs in BIAS_CASES:
            args = flash_case(0, dtype=dtype, dev=dev, **shape)
            H, S = shape["H"], shape["S"]
            bias = bias_plane(3, H if planes == "H" else 1, S,
                              shape.get("T", S), dev)
            seg = None if segs is None else _segments(segs, shape["B"], dev)
            tag = f"{name}-{str(dtype)[6:]}"
            errs[tag] = check_flash(args, tag, causal=causal, seg=seg,
                                    atol=ATOL[dtype], bias=bias, heads=H)
    # A whole T5 on the kernels by constructor argument, f32, also packed.
    cfg = PRESETS["tiny-t5"]
    torch.manual_seed(0)
    flash_model = make_t5(cfg, attn_fn=make_flash_attention(), device=dev)
    plain_model = make_t5(cfg, device=dev)
    plain_model.load_state_dict(flash_model.state_dict())
    rng = np.random.RandomState(1)
    enc = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 40))).to(dev)
    dec = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 23))).to(dev)
    segs = ((torch.arange(40, device=dev) >= 25).int().expand(2, 40),
            (torch.arange(23, device=dev) >= 9).int().expand(2, 23))
    with torch.no_grad():
        for packed in (None, segs):
            err = (flash_model(enc, dec, packed)
                   - plain_model(enc, dec, packed)).abs().max().item()
            if not err <= 1e-4:
                raise AssertionError(f"TINY T5 on the flash kernels: {err}")
            errs["tiny-t5-logits" + ("-packed" if packed else "")] = err
    # The bucket map on the card equals the CPU's, integer for integer.
    t5 = T5_CFG.encoder
    for L in (T5_ENC, T5_DEC):
        rel = torch.arange(L)[None, :] - torch.arange(L)[:, None]
        for bidirectional in (True, False):
            kw = dict(bidirectional=bidirectional,
                      num_buckets=t5.relative_pos_buckets,
                      max_distance=t5.relative_pos_max_distance)
            if not torch.equal(_relative_buckets(rel.to(dev), **kw).cpu(),
                               _relative_buckets(rel, **kw)):
                raise AssertionError(
                    f"relative buckets at {L} (bidirectional="
                    f"{bidirectional}) differ between the card and the CPU")
    errs["relative-buckets-512-114"] = 0
    return errs


def sdpa_yardstick(q4, k4, v4, do4, bias, causal, flush) -> dict:
    """Forward and backward times of ``F.scaled_dot_product_attention`` on
    [B, H, S, D] views (k and v [B, KV, T, D], GQA by ``enable_gqa``), a
    bias as a float ``attn_mask`` (in q's dtype, expanded to [B, H, S, T],
    the causal mask folded in as -inf) whose gradient the backward
    computes too: the fastest (forward + backward) of the fused backends
    that take it, by name, or the math backend if none does.  A
    yardstick the port never calls."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    B, H, S, _ = q4.shape
    T = k4.shape[2]
    gqa = k4.shape[1] != H
    mask, is_causal = None, causal
    if bias is not None:
        m = bias.float()
        if causal:
            keep = torch.ones(S, T, dtype=torch.bool, device=m.device).tril(T - S)
            m = m.masked_fill(~keep, float("-inf"))
        mask = m.to(q4.dtype)[None].expand(B, H, S, T).contiguous()
        is_causal = False
    backends = [SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH]
    ins = (q4, k4, v4) + (() if mask is None else (mask,))

    def fwd(*t):
        return F.scaled_dot_product_attention(
            *t[:3], attn_mask=t[3] if len(t) > 3 else None, is_causal=is_causal,
            enable_gqa=gqa)

    refused, ran = {}, {}
    for backend in backends:
        if backend == SDPBackend.MATH and ran:
            break
        try:
            with sdpa_kernel([backend]):
                fwd_ms = time_ms(lambda: fwd(*ins), flush, 10)
                leaves = [t.detach().clone().requires_grad_() for t in ins]
                o4 = fwd(*leaves)
                bwd_ms = time_ms(lambda: torch.autograd.grad(
                    o4, leaves, do4, retain_graph=True), flush, 10)
            ran[backend.name] = (fwd_ms, bwd_ms)
            del leaves, o4
        except RuntimeError as e:
            refused[backend.name] = str(e).splitlines()[0][:160]
    if not ran:
        raise AssertionError(f"no SDPA backend ran: {refused}")
    best = min(ran, key=lambda name: sum(ran[name]))
    return {"backend": best, "fwd_ms": ran[best][0], "bwd_ms": ran[best][1],
            "ran": ran, "refused": refused}


def measure_flash_t5(dev, flush, shape_name: str, dtype,
                     timed: bool = True) -> dict:
    """Kernel, plain and library times and the bound of each flash kernel
    at one of T5-11B's attention shapes, after holding the kernels against
    the plain versions there (bfloat16 normwise); with ``timed=False``
    the check alone."""
    t0 = time.perf_counter()
    shape = T5_SHAPES[shape_name]
    cfg = T5_CFG.encoder
    H, D = cfg.n_heads, cfg.head_size
    B, S, T, causal = shape["B"], shape["S"], shape["T"], shape["causal"]
    args = flash_case(17, B=B, S=S, T=T, H=H, D=D, dtype=dtype, dev=dev)
    bias = bias_plane(19, H, S, T, dev) if shape["bias"] else None
    bf16 = dtype == torch.bfloat16
    errs = check_flash(args, f"{shape_name}-{str(dtype)[6:]}", causal=causal,
                       atol=ATOL[dtype], normwise=bf16, bias=bias, heads=H)
    torch.cuda.empty_cache()
    if not timed:
        return {"phase": "flash_bias_full_width", "shape_name": shape_name,
                "dtype": str(dtype)[6:], "max_abs_err": errs,
                "seconds": time.perf_counter() - t0}
    q, k, v, do = args
    kw = dict(causal=causal, bias=bias, heads=H)
    out, lse = flash_forward(q, k, v, **kw)
    delta = (do.float() * out.float()).sum(-1)
    timed = {
        "flash_fwd": lambda: flash_forward(q, k, v, **kw),
        "flash_bwd_dq": lambda: flash_backward_dq(q, k, v, do, lse, delta, **kw),
        "flash_bwd_dkv": lambda: flash_backward_dkv(q, k, v, do, lse, delta,
                                                    **kw),
    }
    if bias is not None:
        timed["flash_dbias"] = lambda: flash_backward_dbias(
            q, k, v, do, lse, delta, bias, causal=causal, heads=H)
    kernel_ms = {name: time_ms(fn, flush) for name, fn in timed.items()}
    # The same kernels without the bias operand, for what reading it costs.
    no_bias = {}
    if bias is not None:
        nb = dict(causal=causal)
        no_bias = {
            "flash_fwd": time_ms(lambda: flash_forward(q, k, v, **nb), flush),
            "flash_bwd_dq": time_ms(lambda: flash_backward_dq(
                q, k, v, do, lse, delta, **nb), flush),
            "flash_bwd_dkv": time_ms(lambda: flash_backward_dkv(
                q, k, v, do, lse, delta, **nb), flush)}
    plain_fwd = time_ms(lambda: flash_forward_reference(
        q, k, v, causal, None, bias, H), flush, 5)
    plain_bwd = time_ms(lambda: flash_backward_reference(
        q, k, v, do, lse, delta, causal, None, bias, H), flush, 5)
    lib = sdpa_yardstick(q.view(B, H, S, D), k.view(B, H, T, D),
                         v.view(B, H, T, D), do.view(B, H, S, D), bias, causal,
                         flush)
    err = {"flash_fwd": max(errs["out"], errs["lse"]),
           "flash_bwd_dq": errs["dq"],
           "flash_bwd_dkv": max(errs["dk"], errs["dv"]),
           "flash_dbias": errs.get("dbias")}
    Hb = 0 if bias is None else H
    kernels = {}
    for name in timed:
        row = {"max_abs_err": err[name], "kernel_ms": kernel_ms[name],
               "plain_ms": plain_fwd if name == "flash_fwd" else plain_bwd,
               "library_ms": lib["fwd_ms"] if name == "flash_fwd"
               else lib["bwd_ms"],
               **flash_bound(name, B=B, S=S, T=T, H=H, KV=H, D=D, dtype=dtype,
                             causal=causal, Hb=Hb)}
        if bias is not None and name != "flash_dbias":
            # Computed, not measured: this design reads the plane once per
            # (batch, head) row, B * H * S * T * 4 bytes at the HBM rate.
            row["bias_stream_ms"] = B * H * S * T * 4 / HBM_BYTES_PER_S * 1e3
            row["kernel_ms_without_bias"] = no_bias[name]
        kernels[name] = row
    return {"phase": "flash_bias_full_width", "shape_name": shape_name,
            "dtype": str(dtype)[6:],
            "shape": {"B": B, "S": S, "T": T, "H": H, "KV": H, "D": D,
                      "causal": causal,
                      "bias": None if bias is None else list(bias.shape)},
            "limit": (f"||kernel - plain|| / ||plain|| <= {BF16_NORM_RTOL}"
                      if bf16 else f"{ATOL[dtype]} x max(1, |plain|), d(bias) "
                      f"{ATOL[dtype]} x max(1, sum of p (|dp| + |delta|))")
            + f"; lse {LSE_RTOL} x max(1, |plain|)",
            "max_abs_err": errs,
            "plain": "flash_forward_reference / flash_backward_reference "
                     "(the backward's plain version computes dq, dk, dv and "
                     "d(bias) in one call; its time stands for each of them)",
            "library": "F.scaled_dot_product_attention(attn_mask=bias) "
                       "forward / its autograd backward with the mask's "
                       "gradient (a yardstick the port never calls)",
            "library_backend": lib["backend"],
            "library_backends_ms": lib["ran"],
            "library_refused": lib["refused"],
            "kernels": kernels, "seconds": time.perf_counter() - t0}


# The T5 shape and dtype the kernels line reports, timed; the others are
# held against the plain versions untimed, for the script's clock.
T5_TIMED = ("t5-encoder-self", torch.bfloat16)


def phase_flash_bias_kernel(dev, flush) -> dict:
    emit({"phase": "flash_bias_kernel_cases", "kernel": "flash_attention",
          "max_abs_err": flash_bias_cases(dev)})
    rows = {}
    for shape_name in T5_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            row = measure_flash_t5(dev, flush, shape_name, dtype,
                                   timed=(shape_name, dtype) == T5_TIMED)
            emit(row)
            rows[(shape_name, row["dtype"])] = row
            torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# registry_warm: a bring-up from the artifact registry, with no nvcc
# ---------------------------------------------------------------------------

# The warm child's fleet: gpt2-125m replicas in float32 (token-exact with
# the oracle), one started, one scaled up.
REGISTRY_SERVE_CFG = PRESETS["gpt2-125m"].replace(dtype=torch.float32)
REGISTRY_SERVE = ServeConfig(max_batch=4, page_size=16, n_pages=48,
                             max_pages_per_seq=8, prefill_buckets=(16, 32))
REGISTRY_HEAL_PLAN = "cache@1=corrupt:flip"


# ---------------------------------------------------------------------------
# the keyed, counter-based draws against their plain version
# ---------------------------------------------------------------------------

KEYED_SOURCE = "torchdistx_tpu_torch/ops/csrc/keyed_rng.cu"
KEYED_REPLACES = ("torchdistx_tpu/__init__.py:38 (no Pallas kernel: the "
                  "partitionable threefry XLA generates for the JAX bridge)")
# Mixtral 8x7B's expert stack (w_gate, w_up), f32: what mesh=None draws
# whole (1.88 GB).
KEYED_SHAPE = (8, 4096, 14336)
# Regions of one full shape: unaligned starts and partial rows, the whole,
# a slab contiguous in the full tensor, one element, whole rows; then
# global bases that are not a multiple of 4: rows of stride 1037 from
# lane 1 (every run starts at another lane), one run of whole rows from
# lane 1, one partial row from lane 3.
KEYED_FULL = (4, 1000, 1037)
KEYED_UNALIGNED = (((0, 0, 1), (4, 1000, 1036)), ((2, 5, 0), (1, 995, 1037)),
                   ((3, 0, 7), (1, 1, 1000)))
KEYED_REGIONS = (((1, 3, 5), (2, 500, 1000)), ((0, 0, 0), KEYED_FULL),
                 ((2, 0, 0), (1, 1000, 1037)), ((3, 999, 1036), (1, 1, 1)),
                 ((0, 7, 0), (4, 13, 1037))) + KEYED_UNALIGNED
# A region of a full tensor of 2**35 elements, of which only the region
# is allocated: block indices past 2**32, the kernel's 64-bit path.
KEYED_WIDE = ((2, 2 ** 34), (1, 2 ** 33 - 3), (1, 2 ** 20))
KEYED_KEY = 0x5DEECE66D
# normal: within 2 ulp of the plain version in its dtype (both take
# logf, sinf, cosf in f32; nvcc's and torch's may differ in the last
# bit); uniform: bit for bit.
KEYED_ULPS = 2
# f32 operations per element outside the tensor cores (uniform: a product
# and a sum; normal: its share of a pair's log, sqrt, two products and
# its sine or cosine, then a product and a sum), over the f32 rate.
KEYED_OPS_PER_ELEMENT = {"uniform": 2, "normal": 8}
F32_PEAK_FLOPS = 67e12


def ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| in units in the last place of ``want`` in
    its dtype (2**(e - 1) * eps for |want| in [2**(e - 1), 2**e))."""
    _, e = torch.frexp(want.float())
    ulp = torch.ldexp(torch.full_like(want, torch.finfo(want.dtype).eps,
                                      dtype=torch.float32), e - 1)
    return float(((got.float() - want.float()).abs() / ulp).max())


def keyed_bound(shape, dtype, kind: str) -> tuple:
    n = math.prod(shape)
    t_bytes = n * dtype.itemsize / HBM_BYTES_PER_S * 1e3
    t_ops = n * KEYED_OPS_PER_ELEMENT[kind] / F32_PEAK_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def keyed_check(got, plain, kind: str, what: str) -> dict:
    if kind == "uniform":
        if not torch.equal(got, plain):
            raise AssertionError(f"{what}: uniform draws differ from plain")
        err = 0.0
    else:
        err = ulps(got, plain)
        if not err <= KEYED_ULPS:
            raise AssertionError(f"{what}: {err} ulp from plain")
    return {"max_ulps": err,
            "max_abs_err": float((got.float() - plain.float()).abs().max())}


# The kernel's instantiations, keyed_rng_kernel<DT, KIND, WIDE>: ptxas
# must report each.
KEYED_DTYPES = {0: "float32", 1: "bfloat16", 2: "float16"}
KEYED_KINDS = {0: "uniform", 1: "normal"}


def keyed_build(build: dict) -> dict:
    """Registers, stack frame and spills (ptxas's lines of the build) of
    each of the 12 instantiations of ``keyed_rng_kernel`` (3 dtypes x 2
    kinds x the 32- and 64-bit paths), and the CTAs per SM the launch
    takes (the occupancy calculator's).  Fails on any spill.  The stack
    frame is printed, not held: the 64-bit normal instantiations keep one,
    the local array of the precise sincosf's reduction of huge arguments,
    which no t in [0, 2pi) reaches."""
    rows = {}
    for fn, row in ptxas_table(build.get("ptxas", [])).items():
        m = re.search(r"keyed_rng_kernelILi(\d)ELi(\d)ELi(\d)E", fn)
        if m:
            rows[f"{KEYED_DTYPES[int(m[1])]}-{KEYED_KINDS[int(m[2])]}-"
                 f"{'64' if int(m[3]) else '32'}bit"] = dict(row)
    want = sorted(f"{d}-{k}-{w}" for d in KEYED_DTYPES.values()
                  for k in KEYED_KINDS.values() for w in ("32bit", "64bit"))
    if sorted(rows) != want:
        raise AssertionError(f"ptxas lines for keyed_rng_kernel at "
                             f"{sorted(rows)}, not {want}")
    for name, row in rows.items():
        if row.get("spill_stores", 1) or row.get("spill_loads", 1):
            raise AssertionError(f"keyed_rng_kernel<{name}> spills: {row}")
    lib = _build.load("keyed_rng.cu")
    fn = lib.tdx_keyed_launch_shape
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    for name, row in rows.items():
        dt, kind, wide = name.split("-")
        shape = (ctypes.c_int * 3)()
        err = fn({v: k for k, v in KEYED_DTYPES.items()}[dt],
                 {v: k for k, v in KEYED_KINDS.items()}[kind],
                 int(wide == "64bit"), shape)
        if err:
            raise RuntimeError(f"tdx_keyed_launch_shape({name}): error {err}")
        row.update(ctas_per_sm=shape[0], threads=shape[1],
                   blocks_per_thread=shape[2])
    return {"instances": {k: rows[k] for k in want}}


def sincos_mismatches(dev) -> int:
    """Of the 2**24 arguments t = f32(2pi) * u2 the normal draws can form,
    the number where the kernel library's sincosf differs in any bit from
    its sinf and cosf (``tdx_keyed_sincos_mismatches``)."""
    fn = _build.load("keyed_rng.cu").tdx_keyed_sincos_mismatches
    fn.argtypes = [ctypes.c_void_p, ctypes.c_uint, ctypes.c_uint,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    count = torch.zeros(1, dtype=torch.int32, device=dev)
    err = fn(count.data_ptr(), 0, 0,
             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"tdx_keyed_sincos_mismatches: error {err}")
    return int(count.item())


def phase_keyed_rng_kernel(dev, flush, build: dict) -> dict:
    """The keyed draws' kernel against its plain version on the card: its
    build (``keyed_build``: 0 spills) and sincosf against sinf and cosf
    at every t the normal draws form; in f32, bf16 and f16, uniform bit
    for bit and normal within 2 ulp over a full tensor, every region of
    ``KEYED_REGIONS`` bit for bit its slice of the kernel's full draw,
    and the unaligned regions and ``KEYED_WIDE`` (the 64-bit path) bit
    for bit the plain version's draw of the region; then at Mixtral's
    expert stack (f32) both kinds checked the same way and timed: kernel,
    plain version, ``Tensor.normal_`` / ``uniform_`` on the same shape
    with torch's CUDA generator (a yardstick the port never calls), and
    the bound."""
    ptxas = keyed_build(build)
    trig = sincos_mismatches(dev)
    if trig:
        raise AssertionError(f"sincosf differs from sinf/cosf at {trig} of "
                             f"the 2**24 arguments")
    cases = {}
    for dtype in keyed_rng.DTYPES:
        for kind, a, b in (("uniform", -0.95, 0.95), ("normal", 0.0, 0.02)):
            what = f"{kind} {str(dtype)[6:]}"
            full = keyed_rng.keyed_fill_(torch.empty(KEYED_FULL, dtype=dtype,
                                                     device=dev),
                                         kind, a, b, KEYED_KEY)
            plain = keyed_rng.keyed_draw_reference(
                KEYED_FULL, dtype, kind, a, b, KEYED_KEY, device=dev)
            row = keyed_check(full, plain, kind, what)
            for start, shape in KEYED_REGIONS:
                part = keyed_rng.keyed_fill_(
                    torch.empty(shape, dtype=dtype, device=dev), kind, a, b,
                    KEYED_KEY, KEYED_FULL, start)
                sl = tuple(slice(s0, s0 + n) for s0, n in zip(start, shape))
                if not torch.equal(part, full[sl]):
                    raise AssertionError(f"{what}: region {start} + {shape} "
                                         f"is not its slice of the full draw")
            for full_shape, (start, shape) in (
                    [(KEYED_FULL, r) for r in KEYED_UNALIGNED]
                    + [(KEYED_WIDE[0], KEYED_WIDE[1:])]):
                part = keyed_rng.keyed_fill_(
                    torch.empty(shape, dtype=dtype, device=dev), kind, a, b,
                    KEYED_KEY, full_shape, start)
                want = keyed_rng.keyed_draw_reference(
                    shape, dtype, kind, a, b, KEYED_KEY, full_shape, start,
                    device=dev)
                if not torch.equal(part, want):
                    raise AssertionError(
                        f"{what}: region {start} + {shape} of {full_shape} "
                        f"differs from the plain version by "
                        f"{ulps(part, want)} ulp")
            cases[what] = {**row, "regions_bitwise": len(KEYED_REGIONS),
                           "regions_bitwise_plain": len(KEYED_UNALIGNED) + 1}
            del full, plain
    out = torch.empty(KEYED_SHAPE, dtype=torch.float32, device=dev)
    timing = {}
    for kind, a, b in (("normal", 0.0, 0.02), ("uniform", -0.95, 0.95)):
        def kernel():
            keyed_rng.keyed_fill_(out, kind, a, b, KEYED_KEY)

        def plain():
            return keyed_rng.keyed_draw_reference(
                KEYED_SHAPE, torch.float32, kind, a, b, KEYED_KEY, device=dev)

        kernel()
        row = keyed_check(out, plain(), kind, f"{kind} {KEYED_SHAPE}")
        torch.cuda.empty_cache()
        bound, by = keyed_bound(KEYED_SHAPE, torch.float32, kind)
        library = ((lambda: out.normal_(a, b)) if kind == "normal"
                   else (lambda: out.uniform_(a, b)))
        timing[kind] = {
            **row, "ms": time_ms(kernel, flush),
            "plain_ms": time_ms(plain, flush, iters=1, warm=0),
            "library_ms": time_ms(library, flush),
            "library": f"Tensor.{kind}_ with torch's CUDA generator (a "
                       f"yardstick the port never calls)",
            "bound_ms": bound, "bound_by": by,
            "bytes": math.prod(KEYED_SHAPE) * 4}
        torch.cuda.empty_cache()
    del out
    torch.cuda.empty_cache()
    row = {"phase": "keyed_rng_kernel", "kernel": "keyed_rng",
           "card": nvidia_smi(), "build": ptxas,
           "build_s": build.get("build_s"),
           "sincos_mismatches_of_2_24": trig, "cases": cases,
           "max_ulps_normal": max(c["max_ulps"] for w, c in cases.items()
                                  if w.startswith("normal")),
           "limits": {"uniform": "bitwise", "normal": f"{KEYED_ULPS} ulp",
                      "regions": "bitwise their slice of the full draw",
                      "unaligned and wide regions":
                          "bitwise the plain version's draw"},
           "full_shape": KEYED_FULL, "regions": KEYED_REGIONS,
           "wide_region": KEYED_WIDE,
           "shape": {"shape": KEYED_SHAPE, "dtype": "float32"},
           "timing": timing}
    emit(row)
    return row


def warm_tool(*args: str) -> dict:
    """``python -m torchdistx_tpu_torch.tools.warm_cache`` with ``args``:
    its JSON summary, after checking it exited 0."""
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, "-m", "torchdistx_tpu_torch.tools.warm_cache", *args],
        cwd=here, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"warm_cache exited {proc.returncode}: "
                           f"{proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def heal_cases(dev) -> dict:
    """A flash forward and backward, a paged-decode call and a keyed draw
    at small shapes: what the damaged-and-refetched libraries must
    reproduce."""
    q, k, v, do = flash_case(5, B=1, S=256, H=4, D=64, dtype=torch.bfloat16,
                             dev=dev)
    out, lse = flash_forward(q, k, v, causal=True)
    delta = (do.float() * out.float()).sum(-1)
    dq = flash_backward_dq(q, k, v, do, lse, delta, causal=True)
    dk, dv = flash_backward_dkv(q, k, v, do, lse, delta, causal=True)
    paged = paged_attention(*decode_shape(
        dev, H=12, KV=12, D=64, page=16, lengths=[1, 100, 257, 1024],
        dtype=torch.float32))
    keyed = keyed_rng.keyed_fill_(torch.empty(3, 1000, dtype=torch.bfloat16,
                                              device=dev), "normal", 0.0, 1.0, 9)
    return {name: t.cpu() for name, t in (("out", out), ("lse", lse),
                                          ("dq", dq), ("dk", dk), ("dv", dv),
                                          ("paged", paged), ("keyed", keyed))}


def registry_fleet(dev) -> dict:
    """A ``ServeFleet`` of gpt2-125m float32 replicas: ``start(1)``, then
    ``scale_up``; every bring-up warm, 8 requests token-exact against the
    oracle, the paged-decode launches = layers x plain decode ticks."""
    from torchdistx_tpu_torch.serve import ServeFleet

    cfg = REGISTRY_SERVE_CFG
    fl = ServeFleet(cfg, family="gpt2", serve_cfg=REGISTRY_SERVE,
                    fleet_cfg=FleetConfig(min_replicas=1, max_replicas=2,
                                          autoscale=False),
                    seed=0, param_dtype=torch.float32, device=dev)
    try:
        fl.start(1, timeout=FLEET_TIMEOUT_S)
        fl.scale_up(wait=True, timeout=FLEET_TIMEOUT_S)
        warm = {f"r{h.idx}": h.bring_up_warm for h in fl.handles}
        if len(warm) != 2 or not all(warm.values()):
            raise AssertionError(f"registry fleet bring-ups warm: {warm}")
        paged_attention.launches = paged_attention.merge_launches = 0
        rng = np.random.RandomState(93)
        reqs = [Request(f"w{i}", rng.randint(0, cfg.vocab_size, int(
            rng.randint(3, 30))).tolist(), max_new_tokens=8, arrival_step=i // 4)
            for i in range(8)]
        fl.run(reqs, max_seconds=FLEET_TIMEOUT_S)
        torch.cuda.synchronize()
        launches = paged_attention.launches
        worst = fleet_check_oracle(fl, reqs)
        plain = sum(h.engine.decode_steps - h.engine.spec_verify_ticks
                    for h in fl.handles)
        if launches != cfg.n_layers * plain:
            raise AssertionError(f"registry fleet: {launches} paged-decode "
                                 f"launches != {cfg.n_layers} x {plain}")
        return {"bring_up_warm": warm,
                "bring_up_outcomes": {f"r{h.idx}": h.engine.bring_up_outcomes
                                      for h in fl.handles},
                "spin_up_s": {f"r{h.idx}": h.bring_up_seconds
                              for h in fl.handles},
                "requests": len(reqs), "token_exact": True,
                "max_final_logit_err": worst, "plain_decode_ticks": plain,
                "paged_decode_launches": launches}
    finally:
        fl.shutdown()


def registry_child(tmp: str) -> None:
    """A fresh process with an empty ``TDX_CACHE_DIR`` and the warmed
    registry (both set by the parent): gpt2-125m f32's first train step
    on the flash kernels against ``default_attention``, then the fleet;
    the kernels of the heal check saved for the next child.  Prints one
    JSON line: no nvcc build, the libraries fetched, each lookup's
    seconds, the first loss's host clock."""
    dev = torch.device("cuda", 0)
    reset_flash_launches()
    train = gpt2_f32_vs_plain(dev, 1)
    torch.cuda.empty_cache()
    fleet = registry_fleet(dev)
    torch.save(heal_cases(dev), f"{tmp}/heal_cases.pt")
    # nvcc's log came with the library: its ptxas lines still pass.
    log = _build.library_path("flash_attention.cu").with_suffix(".log")
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "ptxas info" in ln or "spill" in ln]
    bf16_build({"ptxas": ptxas})
    emit({"train": train, "fleet": fleet, "fetched_log_ptxas_lines": len(ptxas),
          "build_counts": dict(_build.counts),
          "outcomes": dict(_build.outcomes), "lookup_s": dict(_build.seconds),
          "cache_dir": str(_build.cache_dir())})


def registry_heal_child(tmp: str) -> None:
    """A fresh process over the first child's cache under
    ``REGISTRY_HEAL_PLAN`` (set by the parent): the fault damages the
    installed libraries before the first lookup; each is quarantined
    before any ``dlopen``, fetched again, and computes the first child's
    results bit for bit.  Prints one JSON line."""
    dev = torch.device("cuda", 0)
    got = heal_cases(dev)
    want = torch.load(f"{tmp}/heal_cases.pt")
    unequal = [k for k in want if not torch.equal(got[k], want[k])]
    if unequal:
        raise AssertionError(f"refetched libraries differ on {unequal}")
    emit({"build_counts": dict(_build.counts),
          "lookup_s": dict(_build.seconds), "bitwise": sorted(want),
          "quarantined": sorted(n for n in os.listdir(_build.cache_dir())
                                if n.endswith(".so.corrupt"))})


def phase_registry_warm(dev, build: dict) -> dict:
    """The warm bring-up: the ``warm_cache`` tool publishes the build
    phase's two kernel libraries and the native graph engine from its
    cache into a fresh registry; a fresh child with an empty cache
    fetches all three and trains and serves from them (gpt2-125m f32:
    one step of B1-B3 against ``default_attention`` at the f32 limits, a
    2-replica fleet token-exact and warm) with 0 nvcc builds; a second
    child under ``cache@1=corrupt`` heals from the registry, bitwise.
    Each library's fetch s beside the build phase's cold ``build_s``, and
    the first child's seconds from launch to its first loss."""
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="tdx_registry_")
    try:
        reg = f"{root}/registry"
        warm = warm_tool("--model", "gpt2-125m",
                         "--cache-dir", str(_build.cache_dir()),
                         "--registry-dir", reg)
        # The kernel libraries and the native graph engine.
        n_libs = len(SOURCES) + 1
        if warm["unwarmed"] or len(warm["program_reports"]) != n_libs:
            raise AssertionError(f"warm_cache: {warm['program_reports']}")
        keys = sorted(os.listdir(reg))
        if len(keys) != n_libs:
            raise AssertionError(f"registry holds {keys}")
        env = {**os.environ, "TDX_CACHE_DIR": f"{root}/cache",
               "TDX_REGISTRY_DIR": reg}
        launched = time.time()
        child = run_child("registry_child", root, timeout=CHILD_TIMEOUT_S,
                          env=env)
        first_loss_s = child["train"]["first_loss_at"] - launched
        if child["build_counts"]["builds"] != 0 or \
                child["build_counts"]["fetches"] != n_libs or \
                set(child["outcomes"].values()) != {"hit"}:
            raise AssertionError(f"warm child: {child['build_counts']}, "
                                 f"{child['outcomes']}")
        healed = run_child("registry_heal_child", root,
                           timeout=CHILD_TIMEOUT_S,
                           env={**env, "TDX_FAULT_PLAN": REGISTRY_HEAL_PLAN})
        counts = healed["build_counts"]
        if counts["builds"] != 0 or counts["quarantined"] != len(SOURCES) \
                or counts["fetches"] != len(SOURCES) \
                or len(healed["quarantined"]) != len(SOURCES):
            raise AssertionError(f"heal child: {healed}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    train = child.pop("train")
    row = {"phase": "registry_warm", "card": nvidia_smi(),
           "env": warm["env"], "registry_entries": len(keys),
           "warm_outcomes": {r["program"]: r["outcome"]
                             for r in warm["program_reports"]},
           "warm_tool_s": warm["seconds"],
           "libraries": {src: {"cold_build_s": build.get(src, {}).get(
               "build_s"), "warm_fetch_s": child["lookup_s"][src],
               "heal_refetch_s": healed["lookup_s"][src]} for src in SOURCES},
           "first_loss_s_from_launch": first_loss_s,
           "train": {k: train[k] for k in (
               "losses_flash", "losses_plain", "max_loss_diff",
               "grad_step0_worst_leaf", "grad_limit",
               "key_bias_grad_over_key_weight_grad", "flash_launches")},
           **child, "heal": {"plan": REGISTRY_HEAL_PLAN, **healed},
           "seconds": time.perf_counter() - t0}
    emit(row)
    return row


# ---------------------------------------------------------------------------
# phases 3 and 4: the serving path
# ---------------------------------------------------------------------------


def staggered_requests(vocab: int, seed: int):
    rng = np.random.RandomState(seed)
    return [
        Request(f"r{i}", rng.randint(0, vocab, n).tolist(), max_new_tokens=m,
                arrival_step=i)
        for i, (n, m) in enumerate(((12, 10), (9, 12), (14, 8), (5, 11)))
    ]


def captured(eng) -> int:
    """How many of the engine's programs are CUDA graphs."""
    return sum(p.graph is not None for p in eng._programs.values())


def check_plain_launches(name, launches, cfg, eng) -> None:
    """The paged-decode kernel runs once per layer in each PLAIN decode
    tick (a verify tick attends through ``paged_prefill_attention``);
    under CUDA-graph replay each replay adds the calls it recorded."""
    plain = eng.decode_steps - eng.spec_verify_ticks
    if launches != cfg.n_layers * plain:
        raise AssertionError(
            f"{name}: {launches} kernel launches != {cfg.n_layers} layers "
            f"x {plain} plain decode ticks ({eng.spec_verify_ticks} verify "
            f"ticks)")


def keyed_spin_up(**kw):
    """``spin_up_replica(**kw)``, keeping the recording it hands the keyed
    materializer (its fakes, taken before ``bind_values`` swaps them for
    the values) and the materializer's arguments: the engine and
    ``(fakes, kwargs)``."""
    kept = {}
    real = serve_engine.materialize_module_cuda

    def keep(module, **kwargs):
        kept["fakes"] = (named_fake_tensors(module), kwargs)
        return real(module, **kwargs)

    serve_engine.materialize_module_cuda = keep
    try:
        eng = spin_up_replica(**kw)
    finally:
        serve_engine.materialize_module_cuda = real
    return eng, kept["fakes"]


def replica_is_keyed(name: str, eng, kept, seed: int, dev) -> dict:
    """The replica's parameters and buffers against
    ``materialize_params_cuda`` of the recording it was brought up from
    (``kept``, as ``keyed_spin_up`` returns it), the same seed and the
    same ``param_dtype``, on the card: every entry bitwise, in its dtype.
    Fails otherwise."""
    t0 = time.perf_counter()
    fakes, kwargs = kept
    want = materialize_params_cuda(fakes, seed=seed,
                                   param_dtype=kwargs.get("param_dtype"),
                                   device=dev)
    got = dict(eng.model.named_parameters())
    got.update(eng.model.named_buffers())
    for key, value in want.items():
        have = got.get(key)
        if have is None or have.dtype != value.dtype or not torch.equal(
                have.detach(), value):
            raise AssertionError(f"{name}: replica entry {key} is not the "
                                 f"keyed value of its recording and seed")
    entries = len(want)
    del want
    torch.cuda.empty_cache()
    return {"entries_bitwise_keyed": entries,
            "keyed_check_s": time.perf_counter() - t0}


def phase_exact_f32(dev) -> list:
    """Token-exact float32 serving against the unbatched no-cache oracle,
    with a pool too small for all lanes at once, on the captured
    programs with prefix caching and speculation on (the defaults)."""
    rows = []
    runs = (
        ("gpt2-125m", "gpt2", PRESETS["gpt2-125m"].replace(dtype=torch.float32)),
        ("llama3-8b@2-layers", "llama",
         LLAMA3_8B.replace(n_layers=2, dtype=torch.float32)),
    )
    scfg = ServeConfig(max_batch=4, page_size=16, n_pages=5)
    for name, family, cfg in runs:
        keyed_rng.launches = 0
        eng, kept = keyed_spin_up(model=cfg, family=family, serve_cfg=scfg,
                                  seed=0, param_dtype=torch.float32,
                                  device=dev)
        keyed = {"keyed_rng_launches": keyed_rng.launches,
                 **replica_is_keyed(name, eng, kept, 0, dev)}
        del kept
        reqs = staggered_requests(cfg.vocab_size, seed=11)
        paged_attention.launches = 0
        out = eng.run(reqs)
        torch.cuda.synchronize()
        launches = paged_attention.launches
        worst = 0.0
        for r in reqs:
            want, want_logits = oracle_generate(eng.model, r.tokens,
                                                r.max_new_tokens, r.eos_id)
            if out.get(r.rid) != want:
                raise AssertionError(
                    f"{name} {r.rid}: engine {out.get(r.rid)} != oracle {want}")
            err = float(np.abs(eng.final_logits[r.rid] - want_logits).max())
            worst = max(worst, err)
            if not err <= 1e-4:
                raise AssertionError(f"{name} {r.rid}: final logits off by {err}")
        if eng.preemptions < 1:
            raise AssertionError(f"{name}: the pool forced no preemption")
        check_plain_launches(name, launches, cfg, eng)
        row = {"phase": "serve_f32_exact", "model": name,
               "requests": len(reqs), "token_exact": True,
               "max_final_logit_err": worst, "preemptions": eng.preemptions,
               "prefills": eng.prefills, "decode_steps": eng.decode_steps,
               "spec_verify_ticks": eng.spec_verify_ticks,
               "paged_decode_launches": launches,
               "graphs": captured(eng),
               "bring_up_s": eng.bring_up_seconds,
               "capture_s": eng.capture_seconds, **keyed}
        emit(row)
        rows.append(row)
        del eng
        torch.cuda.empty_cache()
    return rows


# Pages, buckets and a chunk cap that force every feature: a 32-token
# preamble shared by 6 requests (2 full pages: prefix hits), a 48-token
# prompt sent twice (3 full pages: the repeat is fully cached and
# recomputes its last position, a copy-on-write), a 150-token prompt
# (past the largest bucket: 3 chunks of at most 64).
FEATURES_SERVE = ServeConfig(max_batch=4, page_size=16, n_pages=40,
                             prefill_buckets=(16, 32, 64), prefill_chunk=64)


def feature_requests(vocab: int, seed: int) -> list:
    """The request mix of ``serve_features_f32``, in arrival order (the
    queue is FIFO: a request behind one not yet arrived waits)."""
    rng = np.random.RandomState(seed)
    preamble = rng.randint(0, vocab, 32).tolist()
    repeat = rng.randint(0, vocab, 48).tolist()
    reqs = [Request(f"s{i}", preamble + rng.randint(0, vocab, 5).tolist(),
                    max_new_tokens=8, arrival_step=2 * i) for i in range(6)]
    reqs += [Request("c0", repeat, max_new_tokens=10, arrival_step=1),
             Request("c1", list(repeat), max_new_tokens=10, arrival_step=5),
             Request("long", rng.randint(0, vocab, 150).tolist(),
                     max_new_tokens=8, arrival_step=3)]
    return sorted(reqs, key=lambda r: r.arrival_step)


def serve_counted(name, eng, cfg, reqs) -> dict:
    """Serve ``reqs`` to the end with the paged-decode count reset just
    before; checks the count per plain tick and returns it."""
    paged_attention.launches = 0
    out = eng.run(reqs)
    torch.cuda.synchronize()
    launches = paged_attention.launches
    check_plain_launches(name, launches, cfg, eng)
    return {"out": out, "launches": launches}


def phase_features_f32(dev) -> list:
    """The prefix cache, copy-on-write, chunked prefill and speculative
    decoding at full width in float32, on the captured programs and on
    the same replica's eager ones."""
    rows = []
    runs = (
        ("gpt2-125m", "gpt2", PRESETS["gpt2-125m"].replace(dtype=torch.float32)),
        ("llama3-8b@2-layers", "llama",
         LLAMA3_8B.replace(n_layers=2, dtype=torch.float32)),
    )
    for name, family, cfg in runs:
        eng = spin_up_replica(cfg, family=family, serve_cfg=FEATURES_SERVE,
                              seed=0, param_dtype=torch.float32, device=dev)
        reqs = feature_requests(cfg.vocab_size, seed=17)
        graph = serve_counted(name, eng, cfg, reqs)
        out = graph["out"]
        worst = 0.0
        wants = {}
        for r in reqs:
            want, want_logits = oracle_generate(eng.model, r.tokens,
                                                r.max_new_tokens, r.eos_id)
            wants[r.rid] = (want, want_logits)
            if out.get(r.rid) != want:
                raise AssertionError(
                    f"{name} {r.rid}: engine {out.get(r.rid)} != oracle {want}")
            err = float(np.abs(eng.final_logits[r.rid] - want_logits).max())
            worst = max(worst, err)
            if not err <= 1e-4:
                raise AssertionError(f"{name} {r.rid}: final logits off by {err}")
        followers = sum(r.rid.startswith("s") for r in reqs) - 1
        checks = {
            "prefix hits (each follower, and c1)":
                eng.prefix_hits >= followers + 1,
            "reused tokens": eng.prefix_tokens_reused >= 32 * followers + 47,
            "a copy-on-write copy": eng.cow_copies >= 1,
            "two chunks": eng.prefill_chunks >= 2,
            "a verify tick": eng.spec_verify_ticks >= 1,
        }
        missing = [k for k, ok in checks.items() if not ok]
        if missing:
            raise AssertionError(f"{name}: no {missing}")
        eager_eng = ServeEngine(family, cfg, eng.model,
                                serve_cfg=FEATURES_SERVE, device=dev,
                                cuda_graphs=False)
        eager = serve_counted(name + " eager", eager_eng, cfg,
                              feature_requests(cfg.vocab_size, seed=17))
        if eager["out"] != out:
            raise AssertionError(f"{name}: eager tokens != captured tokens")
        graph_vs_eager = max(
            float(np.abs(eng.final_logits[r.rid]
                         - eager_eng.final_logits[r.rid]).max())
            for r in reqs)
        if not graph_vs_eager <= 1e-6:
            raise AssertionError(
                f"{name}: captured vs eager final logits {graph_vs_eager}")
        eng.drain()
        if eng.kv.pages_in_use != 0:
            raise AssertionError(
                f"{name}: {eng.kv.pages_in_use} pages in use after drain")
        row = {"phase": "serve_features_f32", "model": name,
               "requests": len(reqs), "token_exact": True,
               "max_final_logit_err": worst,
               "graph_vs_eager_max_logit_diff": graph_vs_eager,
               "prefix_hits": eng.prefix_hits,
               "prefix_tokens_reused": eng.prefix_tokens_reused,
               "cow_copies": eng.cow_copies,
               "prefill_chunks": eng.prefill_chunks,
               "spec_drafted": eng.spec_drafted,
               "spec_accepted": eng.spec_accepted,
               "spec_verify_ticks": eng.spec_verify_ticks,
               "decode_steps": eng.decode_steps,
               "preemptions": eng.preemptions,
               "paged_decode_launches": graph["launches"],
               "paged_decode_launches_eager": eager["launches"],
               "launches_per_plain_tick": cfg.n_layers,
               "pages_in_use_after_drain": 0,
               "graphs": captured(eng), "capture_s": eng.capture_seconds,
               "graph_pool_bytes": eng.graph_pool_bytes()}
        emit(row)
        rows.append(row)
        # serve_chaos serves the mix again on this replica.
        KEPT_REPLICAS[name] = (eng, cfg, wants)
        del eng, eager_eng
        torch.cuda.empty_cache()
    return rows


def _rss_bytes() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")



class RssSampler:
    """Samples this process's resident set every few milliseconds."""

    def __init__(self, period_s: float = 0.005):
        self.period_s = period_s
        self.peak = _rss_bytes()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            self.peak = max(self.peak, _rss_bytes())
            time.sleep(self.period_s)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, _rss_bytes())


# CUDA runtime and driver calls that start work on the device: a kernel
# launch (the merge kernel's programmatic-dependent launch is an Ex
# call) or a whole graph.
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                     "cudaLaunchKernelEx", "cuLaunchKernel", "cuLaunchKernelEx",
                     "cudaGraphLaunch", "cuGraphLaunch")


def profile_decode_ticks(eng, reqs, mode: str, tick_ms: float,
                         n_ticks: int = 3) -> dict:
    """Where a decode tick's time goes: ``torch.profiler`` over a few
    decode-only ticks of the same replica (after the measured run), the
    device kernels summed by name, the host's launch calls counted.
    ``tick_ms`` is the measured run's decode tick: the profiler's own
    tracing slows the ticks it watches (``tick_wall_ms_profiled``)."""
    from torch.profiler import ProfilerActivity, profile

    for r in reqs:
        eng.submit(Request(r.rid + "-p", r.tokens, max_new_tokens=n_ticks + 2))
    eng.step()  # admission + prefill, not profiled
    torch.cuda.synchronize()
    calls = paged_attention.launches
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_ticks):
            eng.step()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3 / n_ticks
    calls = (paged_attention.launches - calls) / n_ticks
    kernels, host = [], {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            if evt.key in HOST_LAUNCH_CALLS:
                host[evt.key] = evt.count / n_ticks
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        kernels.append((us / 1e3 / n_ticks, evt.count / n_ticks, evt.key))
    kernels.sort(reverse=True)
    eng.run()  # finish the profiling requests
    # The paged-decode kernels apart: their device time, and the CUDA
    # launches of each per paged_attention call, as the profiler saw them.
    paged = {name: [(ms, n) for ms, n, key in kernels if name in key]
             for name in ("paged_decode_kernel", "paged_merge_kernel")}
    return {"phase": "decode_tick_profile", "mode": mode, "ticks": n_ticks,
            "tick_wall_ms": tick_ms, "tick_wall_ms_profiled": wall_ms,
            "device_kernel_ms_per_tick": sum(k[0] for k in kernels),
            "kernel_launches_per_tick": sum(k[1] for k in kernels),
            "host_launch_calls_per_tick": sum(host.values()),
            "host_launch_calls": host,
            "paged_attention_calls_per_tick": calls,
            "paged_kernels": {
                name: {"ms_per_tick": sum(ms for ms, _ in rows),
                       "launches_per_tick": sum(n for _, n in rows),
                       "launches_per_call": (sum(n for _, n in rows) / calls
                                             if calls else None)}
                for name, rows in paged.items()},
            "top_kernels": [{"name": k[2][:90], "ms_per_tick": k[0],
                             "launches_per_tick": k[1]} for k in kernels[:8]]}


# Speculation off: the decode tokens/s of earlier runs stay comparable
# (a verify tick runs the plain attention, not the paged-decode kernel).
BF16_SERVE = ServeConfig(max_batch=4, page_size=16, n_pages=64,
                         spec_decode=False)


def bring_up_bf16(dev, check_keyed: bool = False):
    """Full-depth llama3-8b in bf16: fakes → the keyed materializer on the
    card.  Returns the engine and its bring-up seconds, host RSS figures
    and keyed-draw launches; fails if the RSS grew by a quarter of the
    parameter bytes or more.  ``check_keyed`` also holds every entry
    bitwise against ``materialize_params_cuda`` of the same recording,
    seed and ``param_dtype`` (``replica_is_keyed``), after the timed
    bring-up."""
    rss0 = _rss_bytes()
    keyed_rng.launches = 0
    with RssSampler() as rss:
        eng, kept = keyed_spin_up(model="llama3-8b",
                                  param_dtype=torch.bfloat16,
                                  serve_cfg=BF16_SERVE, seed=0, device=dev)
    launches = keyed_rng.launches
    if launches < 1:
        raise AssertionError("the bring-up launched no keyed draw")
    param_bytes = sum(p.numel() * p.element_size()
                      for p in eng.model.parameters())
    growth = rss.peak - rss0
    if not growth < param_bytes / 4:
        raise AssertionError(
            f"host RSS grew {growth} bytes while materializing "
            f"{param_bytes} bytes of parameters")
    keyed = (replica_is_keyed("llama3-8b bf16", eng, kept, 0, dev)
             if check_keyed else {})
    del kept
    return eng, {"param_bytes": param_bytes,
                 "bring_up_s": eng.bring_up_seconds,
                 "capture_s": eng.capture_seconds,
                 "host_rss_peak_bytes": rss.peak,
                 "host_rss_growth_bytes": growth,
                 "keyed_rng_launches": launches, **keyed}


def cold_bring_up() -> None:
    """``bring_up_bf16`` as the first CUDA work of a fresh process; prints
    its figures as one JSON line."""
    _, stats = bring_up_bf16(torch.device("cuda", 0))
    emit(stats)


def run_child(func: str, *args, timeout: float = 600, env=None) -> dict:
    """``chip_smoke.<func>(*args)`` in a child process (environment
    ``env``, default this one's), which prints its figures as its last
    JSON line: work there pays the CUDA context and library loads that a
    new replica or trainer pays.  The kernel libraries are already built
    on disk by then; the child loads the native graph engine first
    (:func:`require_native`)."""
    return join_child(start_child(func, *args, env=env), timeout)


def start_child(func: str, *args, env=None) -> tuple:
    """:func:`run_child` started, for :func:`join_child` (which this
    process must call: it stops a child that outlives its timeout)."""
    here = os.path.dirname(os.path.abspath(__file__))
    code = (f"import chip_smoke; chip_smoke.require_native(); "
            f"chip_smoke.{func}(*{args!r})")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=here, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return func, proc


def join_child(handle: tuple, timeout: float = 600) -> dict:
    func, proc = handle
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    if proc.returncode != 0:
        raise RuntimeError(f"{func} exited {proc.returncode}: {err[-2000:]}")
    return json.loads(out.strip().splitlines()[-1])


def decode_tokens_per_s(eng, reqs) -> dict:
    """Serve ``reqs`` to the end, one synchronized tick at a time, with
    the paged-decode counts reset just before: tokens/s over the
    decode-only ticks (no admission in them), and the launches."""
    for r in reqs:
        eng.submit(r)

    def emitted():
        return (sum(len(v) for v in eng.results.values())
                + sum(len(lane.generated) for lane in eng.active.values()))

    paged_attention.launches = 0
    paged_attention.merge_launches = 0
    decode_tokens, decode_s, ticks = 0, 0.0, 0
    while eng.waiting or eng.active:
        prefills, before = eng.prefills, emitted()
        t = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        if eng.prefills == prefills:  # a decode-only tick
            decode_tokens += emitted() - before
            decode_s += dt
            ticks += 1
    if set(eng.results) != {r.rid for r in reqs}:
        raise AssertionError(f"incomplete: {sorted(eng.results)}")
    if any(len(eng.results[r.rid]) != r.max_new_tokens for r in reqs):
        raise AssertionError("a request stopped short of its budget")
    return {"tokens_per_s": decode_tokens / decode_s,
            "tick_ms": decode_s * 1e3 / ticks,
            "decode_steps": eng.decode_steps,
            "launches": paged_attention.launches,
            "merges": paged_attention.merge_launches}


def bf16_requests(vocab: int) -> list:
    rng = np.random.RandomState(13)
    # Prompt lengths equal to prefill buckets: the prefill then runs the
    # same shapes as the oracle's forward.
    return [Request(f"b{i}", rng.randint(0, vocab, n).tolist(),
                    max_new_tokens=16)
            for i, n in enumerate((16, 32, 8, 16))]


def check_first_tokens(eng, reqs) -> None:
    # bf16: batched decode and the unbatched oracle round differently, so
    # later tokens may drift apart; the first token (prefill vs the
    # oracle's forward at the same shape) must agree.
    for r in reqs:
        want, _ = oracle_generate(eng.model, r.tokens, 1)
        if eng.results[r.rid][0] != want[0]:
            raise AssertionError(
                f"{r.rid}: first token {eng.results[r.rid][0]} != oracle "
                f"{want[0]}")


def phase_bf16_full(dev):
    """Full-depth llama3-8b in bf16: bring-up in a fresh process (cold)
    and in this one (warm: CUDA context, cuBLAS and the kernel library
    already loaded by the earlier phases), every program captured as a
    CUDA graph; then 4 requests of 16 new tokens each through the warm
    replica's graphs, the same through the same replica's eager programs,
    and, with speculation on, a repeated prompt through graphs."""
    cold = run_child("cold_bring_up")
    eng, warm = bring_up_bf16(dev, check_keyed=True)
    scfg = BF16_SERVE
    cfg = eng.cfg
    reqs = bf16_requests(cfg.vocab_size)
    graph = decode_tokens_per_s(eng, reqs)
    launches, merges = graph["launches"], graph["merges"]
    check_plain_launches("llama3-8b bf16", launches, cfg, eng)
    # The engine's table takes several splits on an H100, so every call
    # must also have launched the merge kernel.
    splits, _ = split_plan(eng.scfg.max_batch, cfg.n_heads, cfg.kv_heads,
                           eng.scfg.max_pages_per_seq * scfg.page_size,
                           torch.cuda.get_device_properties(dev)
                           .multi_processor_count)
    if merges != (launches if splits > 1 else 0):
        raise AssertionError(
            f"{merges} merge launches for {launches} calls at {splits} "
            f"splits")
    check_first_tokens(eng, reqs)
    profiles = [profile_decode_ticks(eng, reqs, "graph", graph["tick_ms"])]
    # The same replica's programs run eagerly (its weights, a pool of its
    # own), in the same process.
    eager_eng = ServeEngine("llama", cfg, eng.model, serve_cfg=scfg,
                            device=dev, cuda_graphs=False)
    eager = decode_tokens_per_s(eager_eng, bf16_requests(cfg.vocab_size))
    check_plain_launches("llama3-8b bf16 eager", eager["launches"], cfg,
                         eager_eng)
    check_first_tokens(eager_eng, reqs)
    profiles.append(profile_decode_ticks(eager_eng, reqs, "eager",
                                         eager["tick_ms"]))
    graph_tokens_equal_eager = all(
        eng.results[r.rid] == eager_eng.results[r.rid] for r in reqs)
    del eager_eng
    torch.cuda.empty_cache()
    # Speculation on: a prompt, then the same prompt again once the first
    # has streamed a few tokens (its chain feeds the drafter).
    spec_eng = ServeEngine("llama", cfg, eng.model,
                           serve_cfg=dataclasses.replace(scfg,
                                                         spec_decode=True),
                           device=dev)
    spec_eng.warmup()
    spec_reqs = [Request("q0", reqs[0].tokens, max_new_tokens=16),
                 Request("q1", list(reqs[0].tokens), max_new_tokens=16,
                         arrival_step=6),
                 Request("q2", reqs[1].tokens, max_new_tokens=16)]
    spec = serve_counted("llama3-8b bf16 speculative", spec_eng, cfg,
                         spec_reqs)
    if spec_eng.spec_verify_ticks < 1:
        raise AssertionError("speculation on: no verify tick")
    check_first_tokens(spec_eng, spec_reqs)
    row = {"phase": "serve_bf16_full", "model": "llama3-8b",
           "n_layers": cfg.n_layers, "param_bytes": warm["param_bytes"],
           "bring_up_s_cold": cold["bring_up_s"],
           "capture_s_cold": cold["capture_s"],
           "host_rss_peak_bytes_cold": cold["host_rss_peak_bytes"],
           "host_rss_growth_bytes_cold": cold["host_rss_growth_bytes"],
           "bring_up_s_warm": warm["bring_up_s"],
           "capture_s_warm": warm["capture_s"],
           "keyed_rng_launches_cold": cold["keyed_rng_launches"],
           "keyed_rng_launches_warm": warm["keyed_rng_launches"],
           "entries_bitwise_keyed": warm["entries_bitwise_keyed"],
           "keyed_check_s": warm["keyed_check_s"],
           "graphs": captured(eng),
           "graph_pool_bytes": eng.graph_pool_bytes(),
           "host_rss_peak_bytes_warm": warm["host_rss_peak_bytes"],
           "host_rss_growth_bytes_warm": warm["host_rss_growth_bytes"],
           "requests_completed": len(reqs),
           "decode_steps": graph["decode_steps"],
           "decode_tokens_per_s": graph["tokens_per_s"],
           "decode_tick_ms": graph["tick_ms"],
           "decode_tokens_per_s_eager": eager["tokens_per_s"],
           "decode_tick_ms_eager": eager["tick_ms"],
           "graph_tokens_equal_eager": graph_tokens_equal_eager,
           "paged_decode_launches": launches,
           "paged_merge_launches": merges,
           "paged_decode_launches_eager": eager["launches"],
           "first_token_matches_oracle": True,
           "speculative": {
               "requests": len(spec_reqs),
               "spec_drafted": spec_eng.spec_drafted,
               "spec_accepted": spec_eng.spec_accepted,
               "spec_verify_ticks": spec_eng.spec_verify_ticks,
               "decode_steps": spec_eng.decode_steps,
               "prefix_hits": spec_eng.prefix_hits,
               "cow_copies": spec_eng.cow_copies,
               "paged_decode_launches": spec["launches"],
               "capture_s": spec_eng.capture_seconds,
               "first_tokens_match_oracle": True}}
    emit(row)
    for prof in profiles:
        emit(prof)
    # The kernel's inputs at this path's decode shape: the engine's batch
    # and pool, each lane at its final context length.
    lengths = [len(r.tokens) + r.max_new_tokens - 1 for r in reqs]
    main_args = decode_shape(dev, H=cfg.n_heads, KV=cfg.kv_heads,
                             D=cfg.head_size, page=scfg.page_size,
                             lengths=lengths, dtype=torch.bfloat16,
                             n_pages=scfg.n_pages,
                             maxp=eng.scfg.max_pages_per_seq)
    KEPT_REPLICAS["bf16"] = eng  # serve_chaos serves on its weights
    del eng, spec_eng
    torch.cuda.empty_cache()
    return row, main_args


# ---------------------------------------------------------------------------
# phase 5: the serving engine's fault handling on the captured programs
# ---------------------------------------------------------------------------

# Replicas the serving phases leave for ``serve_chaos`` (popped there):
# the f32 feature replicas with their oracle results, the bf16 replica.
KEPT_REPLICAS: dict = {}
# Every (component, state) ``spin_up_replica`` reported in this process.
HEALTH_WALK: list = []
# The serve-side fault kinds ``serve_chaos`` fires on each f32 replica,
# each at the first step whose state gives it something to hit.
SERVE_FAULTS = ("raise", "raise:chunk", "raise:verify", "slow:0.01")
# A flapping entry at one step of the shared plan, 3 steps past the
# later replica's count at the start: its duty cycle 0.5 fires on every
# second match, so the first replica passes it and the second fires it.
FLAP_AHEAD = 3


def record_health_walk() -> None:
    """Record every state report (the engine reports through
    ``observe.health.set_state``, looked up at each call)."""
    original = health.set_state

    def recording(component, state):
        HEALTH_WALK.append((component, state))
        original(component, state)

    health.set_state = recording


def chaos_drive(eng, reqs, plan, flap_step: int) -> dict:
    """Serve ``reqs`` to the end one step at a time.  After each step,
    the first kind of ``SERVE_FAULTS`` whose moment has come is added to
    ``plan`` for the next step: ``raise`` after a decode tick with lanes
    still decoding (a replica whose drafter is warm may verify at every
    tick), ``raise:chunk`` while a lane is between two chunks of its
    prompt, ``raise:verify`` after a verify tick, then ``slow``.
    Records the step at which a deferred verify fault entered the verify
    path (after drafting and page growth), and the kind of tick before
    the plain ``raise``."""
    streamed, verify_hit, raise_after = {}, [], []
    eng.on_token = lambda rid, tok: streamed.setdefault(rid, []).append(tok)
    spec_step = eng._spec_decode_step

    def watched_spec_step():
        if eng._pending_verify_faults:
            verify_hit.append(eng._step_no)
        return spec_step()

    eng._spec_decode_step = watched_spec_step
    todo = list(SERVE_FAULTS)
    try:
        for r in reqs:
            eng.submit(r)
        while eng.waiting or eng.active:
            verify = eng.spec_verify_ticks
            plain = eng.decode_steps - verify
            eng.step()
            nxt = eng._step_no + 1
            if not todo or nxt == flap_step:
                continue
            did_verify = eng.spec_verify_ticks > verify
            did_plain = eng.decode_steps - eng.spec_verify_ticks > plain
            moment = {
                "raise": (did_plain or did_verify) and bool(eng.active),
                "raise:chunk": any(lane.prefilling and lane.length > 0
                                   for lane in eng.active.values()),
                "raise:verify": did_verify,
                "slow:0.01": True,
            }
            for kind in todo:
                if moment[kind]:
                    k, _, arg = kind.partition(":")
                    plan.add(chaos.Fault("serve", nxt, k, arg or None))
                    todo.remove(kind)
                    if kind == "raise":
                        raise_after.append("plain" if did_plain else "verify")
                    break
    finally:
        del eng._spec_decode_step
        eng.on_token = None
    if todo:
        raise AssertionError(f"no moment came for {todo}")
    return {"streamed": streamed, "verify_hit": verify_hit,
            "raise_after": raise_after[0]}


def ledger_gaps(rids) -> dict:
    """Per rid: |sum of its four ledger stages - its end-to-end latency|,
    from the unrounded accumulators."""
    done = {rec.rid: rec for rec in reqledger._RECENT_DONE}
    return {rid: abs(sum(done[rid].acc.values()) - done[rid].e2e_s)
            for rid in rids}


def flight_bundles(flight_dir) -> list:
    docs = []
    for name in sorted(os.listdir(flight_dir),
                       key=lambda n: int(n.split("-")[2])):
        with open(os.path.join(flight_dir, name)) as f:
            docs.append(json.load(f))
    bad = {d["reason"]: flightrec.validate(d) for d in docs
           if flightrec.validate(d)}
    if bad:
        raise AssertionError(f"flight bundles fail validate: {bad}")
    return docs


def phase_serve_chaos_f32(dev) -> list:
    """The feature mix again on each f32 replica of ``serve_features_f32``
    (its captured programs, drained), under one shared plan that fires
    each serve-side fault kind on each replica and the flapping entry on
    the second; then ``compile@1=raise`` on an engine with no program
    captured yet (no ``warmup()``), which fires at its first lazy build,
    before the capture opens.  Telemetry, the ledger and the flight
    recorder are on."""
    t0 = time.perf_counter()
    rows = []
    names = ("gpt2-125m", "llama3-8b@2-layers")
    flap_step = max(KEPT_REPLICAS[n][0]._step_no for n in names) + FLAP_AHEAD
    plan = chaos.install(f"serve@{flap_step}=flap:0.5")
    flight_dir = tempfile.mkdtemp(prefix="tdx-flight-")
    observe.enable(True)
    try:
        with tdx_config.override(flight_dir=flight_dir):
            for name in names:
                eng, cfg, wants = KEPT_REPLICAS.pop(name)
                rows.append(chaos_on_replica(name, eng, cfg, wants, plan,
                                             flap_step))
                if name == "gpt2-125m":
                    rows.append(chaos_on_first_capture(name, eng, cfg, wants,
                                                       dev))
                    chaos.install(plan)  # the shared plan, for the next
                del eng
                torch.cuda.empty_cache()
        left = [f.spec() for f in plan.pending() if f.kind != "flap"]
        flap = plan.faults[0]
        if left or flap.hits != 2 or plan.fired.count(flap.spec()) != 1:
            raise AssertionError(f"plan: pending {left}, flap matched "
                                 f"{flap.hits}, fired {plan.fired}")
        docs = flight_bundles(flight_dir)
        reasons = [d["reason"] for d in docs]
        if not {"chaos_injected", "serve_fault"} <= set(reasons):
            raise AssertionError(f"flight dump reasons {reasons}")
        row = {"phase": "serve_chaos", "part": "plan", "fired": plan.fired,
               "flight_dumps": len(docs),
               "flight_reasons": sorted(set(reasons)),
               "flight_bundles_valid": True,
               "seconds": time.perf_counter() - t0}
        emit(row)
        rows.append(row)
    finally:
        observe.enable(None)
        observe.reset()
        chaos.clear()
        KEPT_REPLICAS.clear()
        shutil.rmtree(flight_dir, ignore_errors=True)
    return rows


def chaos_on_replica(name, eng, cfg, wants, plan, flap_step) -> dict:
    programs = {k: (p, p.graph) for k, p in eng._programs.items()}
    graphs = captured(eng)
    # The mix as serve_features_f32 served it: a cold drafter (a warm one
    # verifies at every tick, and no plain tick would run the kernel),
    # the arrivals counted from this replica's present step.
    eng._drafter = type(eng._drafter)()
    reqs = [dataclasses.replace(r, arrival_step=r.arrival_step + eng._step_no)
            for r in feature_requests(cfg.vocab_size, seed=17)]
    before = observe.counter("tdx.serve.preempted_requests").value
    plain0 = eng.decode_steps - eng.spec_verify_ticks
    fired0 = len(plan.fired)
    paged_attention.launches = 0
    drive = chaos_drive(eng, reqs, plan, flap_step)
    torch.cuda.synchronize()
    launches = paged_attention.launches
    plain = eng.decode_steps - eng.spec_verify_ticks - plain0
    preempted = observe.counter("tdx.serve.preempted_requests").value - before
    out = {r.rid: eng.results[r.rid] for r in reqs}
    worst = 0.0
    for r in reqs:
        want, want_logits = wants[r.rid]
        if out[r.rid] != want:
            raise AssertionError(
                f"{name} {r.rid}: engine {out[r.rid]} != oracle {want}")
        err = float(np.abs(eng.final_logits[r.rid] - want_logits).max())
        worst = max(worst, err)
        if not err <= 1e-4:
            raise AssertionError(f"{name} {r.rid}: final logits off by {err}")
    if drive["streamed"] != out:
        raise AssertionError(f"{name}: a position streamed twice or never")
    if not preempted > 0:
        raise AssertionError(f"{name}: no request was requeued")
    if launches != cfg.n_layers * plain:
        raise AssertionError(
            f"{name}: {launches} kernel launches != {cfg.n_layers} layers x "
            f"{plain} plain decode ticks")
    now = {k: (p, p.graph) for k, p in eng._programs.items()}
    if now != programs or captured(eng) != graphs:
        raise AssertionError(f"{name}: a program was rebuilt or recaptured")
    if not drive["verify_hit"]:
        raise AssertionError(f"{name}: the verify fault missed the verify path")
    gaps = ledger_gaps([r.rid for r in reqs])
    if not max(gaps.values()) <= 1e-6:
        raise AssertionError(f"{name}: ledger stages off e2e by {gaps}")
    chunk_aborts = [rid for rid in out
                    if _chunk_then_abort(reqledger.summary(rid)["events"])]
    if not chunk_aborts:
        raise AssertionError(f"{name}: the chunk fault hit no chunk boundary")
    eng.drain()
    if eng.kv.pages_in_use != 0:
        raise AssertionError(
            f"{name}: {eng.kv.pages_in_use} pages in use after drain")
    row = {"phase": "serve_chaos", "part": "f32", "model": name,
           "requests": len(reqs), "token_exact": True,
           "max_final_logit_err": worst,
           "faults_fired": plan.fired[fired0:],
           "preempted_requests": preempted,
           "verify_fault_step": drive["verify_hit"][0],
           "raise_after_tick": drive["raise_after"],
           "chunk_fault_requeued": chunk_aborts,
           "plain_ticks": plain, "paged_decode_launches": launches,
           "graphs": graphs, "programs_rebuilt": 0,
           "ledger_max_stage_gap_s": max(gaps.values()),
           "slo_counts": {m: w.total_count
                          for m, w in eng.slo.windows.items()},
           "pages_in_use_after_drain": 0}
    emit(row)
    return row


def _chunk_then_abort(events) -> bool:
    kinds = [e["k"] for e in events]
    return any(a == "chunk" and b == "abort" for a, b in zip(kinds, kinds[1:]))


def chaos_on_first_capture(name, eng, cfg, wants, dev) -> dict:
    """``compile@1=raise`` on an engine over the same weights with no
    program built: the fault fires at the first lazy build, in the first
    prefill, before its capture opens; the request is requeued with its
    pages freed, and the next tick captures and serves."""
    ceng = ServeEngine(eng.family, cfg, eng.model, serve_cfg=FEATURES_SERVE,
                       device=dev, slo_name="serve-first-capture")
    reqs = feature_requests(cfg.vocab_size, seed=17)[:3]
    plan = chaos.install("compile@1=raise")
    try:
        before = ceng.preemptions
        out = ceng.run(reqs)
    finally:
        chaos.clear()
    if plan.fired != ["compile@1=raise"] or not ceng.preemptions > before:
        raise AssertionError(f"{name}: compile fault {plan.fired}, "
                             f"{ceng.preemptions} preemptions")
    for r in reqs:
        if out[r.rid] != wants[r.rid][0]:
            raise AssertionError(f"{name} {r.rid}: {out[r.rid]} != oracle")
    graphs = captured(ceng)
    if graphs != len(ceng._programs) or not graphs:
        raise AssertionError(f"{name}: {graphs} of {len(ceng._programs)} "
                             f"lazily built programs captured")
    failed_capture_ends(ceng)
    ceng.drain()
    if ceng.kv.pages_in_use != 0:
        raise AssertionError(f"{name}: pages left after the compile fault")
    row = {"phase": "serve_chaos", "part": "first_capture", "model": name,
           "fired": plan.fired, "preemptions": ceng.preemptions,
           "token_exact": True, "graphs_captured_lazily": graphs,
           "failed_capture_ends": True, "pages_in_use_after_drain": 0}
    emit(row)
    del ceng
    return row


def failed_capture_ends(eng) -> None:
    """A forward that raises inside its capture leaves no graph, no
    stream capturing and the engine's current stream as it was; the next
    capture on the same side stream and pool works and replays."""
    spec = eng._specs["cow"]
    cow = eng._fns["cow"]
    calls = []

    def raising(*args):
        calls.append(len(calls))
        if len(calls) == 2:  # after the warm-up run: inside the capture
            raise RuntimeError("raised inside the capture")
        return cow(*args)

    stream = torch.cuda.current_stream(eng.device)
    prog = ServeProgram(spec, raising, (eng.k_pages, eng.v_pages))
    try:
        prog.capture(eng._graph_pool, eng._capture_stream)
    except RuntimeError as e:
        if "inside the capture" not in str(e):
            raise
    else:
        raise AssertionError("the capture swallowed the forward's error")
    if (prog.graph is not None or torch.cuda.is_current_stream_capturing()
            or torch.cuda.current_stream(eng.device) != stream):
        raise AssertionError("a failed capture left a graph or a stream "
                             "capturing")
    again = ServeProgram(spec, cow, (eng.k_pages, eng.v_pages))
    again.capture(eng._graph_pool, eng._capture_stream)
    again(np.asarray([0], np.int32), np.asarray([0], np.int32))
    torch.cuda.synchronize(eng.device)


def phase_serve_chaos_bf16(dev, main_row) -> dict:
    """Full-depth llama3-8b bf16 on the replica ``serve_bf16_full``
    brought up, 4 lanes on captured graphs, speculation and the prefix
    cache off (a requeued request re-prefills its prompt through the same
    program as before: with either on, the rerun may take a chunk or
    verify path that rounds otherwise in bf16): two ``serve@N=raise``
    faults mid-decode give tokens bitwise equal to the same engine's
    fault-free run.  Then what the hooks cost: decode tick ms and
    tokens/s with telemetry off and with telemetry, ledger and SLO on,
    and one ``flight_dump``'s ms and bytes (medians of three interleaved
    runs of each mode)."""
    t0 = time.perf_counter()
    eng = KEPT_REPLICAS.pop("bf16")
    try:
        walk = [s for c, s in HEALTH_WALK if c == "serve"]
        if walk[-3:] != ["spin_up", "warming", "serving"] or \
                health.snapshot()["states"]["serve"]["state"] != "serving":
            raise AssertionError(f"health walk {walk}")
        scfg = dataclasses.replace(BF16_SERVE, prefix_cache=False)
        cfg = eng.cfg
        e2 = ServeEngine("llama", cfg, eng.model, serve_cfg=scfg, device=dev,
                         slo_name="serve-chaos-bf16")
        e2.warmup()

        def reqs(tag):
            return [Request(f"{r.rid}-{tag}", r.tokens,
                            max_new_tokens=r.max_new_tokens)
                    for r in bf16_requests(cfg.vocab_size)]

        def served(tag):
            """decode_tokens_per_s on a fresh response log; the tokens."""
            e2.results.clear()
            figures = decode_tokens_per_s(e2, reqs(tag))
            return figures, {rid[:-len(tag) - 1]: toks
                             for rid, toks in e2.results.items()}

        observe.enable(False)
        clean, clean_tokens = served("clean")
        step0 = e2._step_no
        plan = chaos.install(f"serve@{step0 + 4}=raise;serve@{step0 + 11}=raise")
        try:
            preempted = e2.preemptions
            _, fault_tokens = served("fault")
        finally:
            chaos.clear()
        if plan.pending() or not e2.preemptions - preempted >= 8:
            raise AssertionError(f"bf16 faults {plan.fired}, "
                                 f"{e2.preemptions - preempted} requeued")
        if fault_tokens != clean_tokens:
            raise AssertionError(
                f"bf16 tokens after faults differ: {fault_tokens} != "
                f"{clean_tokens}")
        # What the hooks cost, the two modes interleaved three times (the
        # host's load moves a tick by more than the hooks do).
        runs = {"off": [], "on": []}
        for i in range(3):
            for mode in runs:
                observe.enable(mode == "on")
                runs[mode].append(served(f"{mode}{i}")[0])
        off, on = ({k: float(np.median([r[k] for r in runs[mode]]))
                    for k in ("tick_ms", "tokens_per_s")}
                   for mode in ("off", "on"))
        flight_dir = tempfile.mkdtemp(prefix="tdx-flight-")
        try:
            with tdx_config.override(flight_dir=flight_dir):
                t = time.perf_counter()
                path = observe.flight_dump("hook_cost", replica="bf16")
                dump_ms = (time.perf_counter() - t) * 1e3
                dump_bytes = os.path.getsize(path)
                with open(path) as f:
                    doc = json.load(f)
        finally:
            shutil.rmtree(flight_dir, ignore_errors=True)
        if flightrec.validate(doc):
            raise AssertionError(f"flight dump {flightrec.validate(doc)}")
        row = {"phase": "serve_chaos", "part": "bf16", "model": "llama3-8b",
               "n_layers": cfg.n_layers, "lanes": scfg.max_batch,
               "prefix_cache": False, "spec_decode": False,
               "faults_fired": plan.fired,
               "requeued": e2.preemptions - preempted,
               "tokens_bitwise_equal_fault_free": True,
               "health_walk": walk[-3:],
               "decode_tick_ms_serve_bf16_full": main_row["decode_tick_ms"],
               "decode_tick_ms_clean": clean["tick_ms"],
               "decode_tick_ms_telemetry_off": off["tick_ms"],
               "decode_tokens_per_s_telemetry_off": off["tokens_per_s"],
               "decode_tick_ms_telemetry_on": on["tick_ms"],
               "decode_tokens_per_s_telemetry_on": on["tokens_per_s"],
               "decode_tick_ms_runs": {m: [r["tick_ms"] for r in v]
                                       for m, v in runs.items()},
               "ledger_requests": reqledger.requests_report()["finished"],
               "slo": e2.slo.snapshot(),
               "flight_dump_ms": dump_ms, "flight_dump_bytes": dump_bytes,
               "flight_dump_events": len(doc["events"]),
               "device": doc["env"].get("device"),
               "driver": doc["env"].get("driver"),
               "seconds": time.perf_counter() - t0}
        emit(row)
        del e2
        return row
    finally:
        observe.enable(None)
        observe.reset()
        KEPT_REPLICAS.clear()
        del eng
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 7 and 8: the training path
# ---------------------------------------------------------------------------

# Step-0 gradients, flash against plain attention, per leaf:
# ||flash - plain|| / ||plain||.  Both are f32 (no TF32) summed in another
# order through 12 layers' backward; a wrong dq, dk or dv moves its
# attention leaves by order 1.
F32_GRAD_RTOL = 1e-4
# The key biases' true gradient is 0 (softmax ignores a shift of a row's
# scores, so each row of dS sums to 0): what is left is rounding (measured
# 7e-8 on an H100), held to this fraction of the same layer's key-weight
# gradient.
F32_ZERO_GRAD_RTOL = 1e-5
F32_LOSS_ATOL = 1e-3  # the same sums, plus two AdamW updates (loss ~10.9)


def leaf_errors(names, got, want, dtype=torch.float64) -> dict:
    """||got - want|| / ||want|| per named gradient leaf (0 where both
    are exactly 0), computed in ``dtype``."""
    errs = {}
    for name, a, b in zip(names, got, want):
        b = b.to(a.device)
        d = (a.to(dtype) - b.to(dtype)).norm().item()
        n = b.to(dtype).norm().item()
        errs[name] = d / n if n else (0.0 if d == 0 else math.inf)
    return errs


def phase_train_f32_exact(dev) -> dict:
    """gpt2-125m at full size, f32 compute: 3 steps of ``make_train_step``
    with the flash kernels and 3 with ``default_attention``, from the same
    materialized weights and the same numpy-seeded batches."""
    row = gpt2_f32_vs_plain(dev, 3)
    emit(row)
    torch.cuda.empty_cache()
    return row


def gpt2_f32_vs_plain(dev, steps: int) -> dict:
    """:func:`phase_train_f32_exact`'s comparison over ``steps`` steps: its
    row, with the host clock (``time.time()``) when the flash run's first
    loss reached the host."""
    cfg = PRESETS["gpt2-125m"].replace(dtype=torch.float32)
    B, S = 4, cfg.max_seq_len  # S = 1024, the full context
    torch.manual_seed(0)
    flash_model = materialize_module(
        deferred_init(make_gpt2, cfg, attn_fn=make_flash_attention(),
                      device=dev), device=dev)
    plain_model = make_gpt2(cfg, device=dev)
    plain_model.load_state_dict(flash_model.state_dict())
    rng = np.random.RandomState(21)
    batches = [rng.randint(0, cfg.vocab_size, (B, S)) for _ in range(steps)]
    runs, first_loss_at = {}, None
    for name, model in (("flash", flash_model), ("plain", plain_model)):
        init_state, train_step, shard_batch = make_train_step(model, cfg,
                                                              device=dev)
        state = init_state(model)
        reset_flash_launches()
        losses, grads0 = [], None
        t = time.perf_counter()
        for i, b in enumerate(batches):
            state, metrics = train_step(state, shard_batch(b))
            losses.append(float(metrics["loss"]))
            if i == 0:
                first_loss_at = first_loss_at or time.time()
                grads0 = [p.grad.clone() for p in state["params"]]
        torch.cuda.synchronize()
        runs[name] = {"losses": losses, "grads0": grads0,
                      "launches": dict(flash_launches),
                      "s_per_step": (time.perf_counter() - t) / steps}
        del state
    flash, plain = runs["flash"], runs["plain"]
    names = [n for n, _ in flash_model.named_parameters()]
    key_bias = {n for n in names if n.endswith("attn.wk.bias")}
    errs = leaf_errors(names, flash["grads0"], plain["grads0"])
    checked = {n: e for n, e in errs.items() if n not in key_bias}
    worst = max(checked, key=checked.get)
    worst_attn = max((n for n in checked if ".attn." in n), key=checked.get)
    grads = {run: dict(zip(names, runs[run]["grads0"])) for run in runs}
    zero_rel = max(
        grads[run][n].norm().item()
        / grads[run][n.replace("wk.bias", "wk.weight")].norm().item()
        for run in runs for n in key_bias)
    loss_diff = max(abs(a - b) for a, b in zip(flash["losses"],
                                               plain["losses"]))
    want = {k: cfg.n_layers * steps for k in FLASH_REPLACES}
    want["flash_dbias"] = 0
    if not all(math.isfinite(x) for x in flash["losses"] + plain["losses"]):
        raise AssertionError(f"non-finite loss: {flash['losses']} "
                             f"{plain['losses']}")
    if not checked[worst] <= F32_GRAD_RTOL:
        raise AssertionError(
            f"step-0 gradient of {worst} differs by {checked[worst]} "
            f"(normwise) > {F32_GRAD_RTOL}")
    if not (len(key_bias) == cfg.n_layers and zero_rel <= F32_ZERO_GRAD_RTOL):
        raise AssertionError(
            f"key-bias gradients {zero_rel} of the key weights' "
            f"> {F32_ZERO_GRAD_RTOL} ({len(key_bias)} leaves)")
    if not loss_diff <= F32_LOSS_ATOL:
        raise AssertionError(f"losses differ by {loss_diff}")
    if flash["launches"] != want or any(plain["launches"].values()):
        raise AssertionError(f"launches flash {flash['launches']} != {want}, "
                             f"plain {plain['launches']}")
    row = {"phase": "train_f32_exact", "model": "gpt2-125m", "dtype": "float32",
           "batch": [B, S], "steps": steps,
           "losses_flash": flash["losses"], "losses_plain": plain["losses"],
           "max_loss_diff": loss_diff, "loss_limit": F32_LOSS_ATOL,
           "grad_step0_worst_leaf": [worst, checked[worst]],
           "grad_step0_worst_attention_leaf": [worst_attn,
                                               checked[worst_attn]],
           "grad_step0_by_leaf": {
               n: errs[n] for n in names
               if not n.startswith("blocks.") or n.startswith("blocks.0.")},
           "grad_limit": f"||flash - plain|| / ||plain|| <= {F32_GRAD_RTOL} "
                         f"per leaf",
           "key_bias_grad_over_key_weight_grad": zero_rel,
           "key_bias_limit": F32_ZERO_GRAD_RTOL,
           "flash_launches": flash["launches"],
           "step_s_flash": flash["s_per_step"],
           "step_s_plain": plain["s_per_step"],
           "first_loss_at": first_loss_at}
    return row


def train_batch() -> np.ndarray:
    return np.random.RandomState(31).randint(
        0, TRAIN_CFG.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))


def first_step(dev):
    """The training main path from nothing: deferred_init of 2-layer
    llama3-8b width with the flash kernels, materialize on the card,
    ``make_train_step``, one step; the clock runs from before
    ``deferred_init`` to the first loss on the host, and the host RSS is
    sampled throughout."""
    batch = train_batch()
    rss0 = _rss_bytes()
    with RssSampler() as rss:
        t0 = time.perf_counter()
        model = deferred_init(make_llama, TRAIN_CFG,
                              attn_fn=make_flash_attention(), device=dev)
        torch.manual_seed(0)
        materialize_module(model, device=dev)
        init_state, train_step, shard_batch = make_train_step(
            model, TRAIN_CFG, device=dev)
        state = init_state(model)
        torch.cuda.synchronize()
        bring_up = time.perf_counter() - t0
        state, metrics = train_step(state, shard_batch(batch))
        loss = float(metrics["loss"])
        seconds = time.perf_counter() - t0
    n_params = sum(p.numel() for p in state["params"])
    param_bytes = sum(p.numel() * p.element_size() for p in state["params"])
    growth = rss.peak - rss0
    if not growth < param_bytes / 4:
        raise AssertionError(
            f"host RSS grew {growth} bytes bringing up {param_bytes} bytes "
            f"of parameters")
    stats = {"first_step_s": seconds, "bring_up_s": bring_up,
             "first_loss": loss,
             "n_params": n_params, "param_bytes": param_bytes,
             "host_rss_peak_bytes": rss.peak, "host_rss_growth_bytes": growth}
    return state, train_step, shard_batch, stats


def cold_first_step() -> None:
    """``first_step`` as the first CUDA work of a fresh process; prints
    its figures as one JSON line."""
    *_, stats = first_step(torch.device("cuda", 0))
    emit(stats)


def profile_step(model: str, step, classify=None, trace_names=()) -> dict:
    """One more training step (``step()``) under ``torch.profiler``:
    device time by kernel, and the flash kernels' share of it; with
    ``classify``, the profile is taken with the ops' input shapes and
    ``classify(prof)`` is added as ``split``.  With ``trace_names`` the
    step runs under the port's ``utils.profiling.trace`` and
    ``annotate("tdx.step")`` instead, and its Chrome trace must name
    each of them and the annotation."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="tdx_trace_") if trace_names else None
    if trace_names:
        ctx = profiling.trace(tmp)
    else:
        ctx = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                      record_shapes=classify is not None)
    with ctx as prof:
        with (profiling.annotate("tdx.step") if trace_names
              else contextlib.nullcontext()):
            step()
        torch.cuda.synchronize()
    traced = None
    if trace_names:
        path = profiling.last_trace_path()
        names = {e.get("name", "") for e in json.load(open(path))["traceEvents"]}
        missing = [n for n in (*trace_names, "tdx.step")
                   if not any(n in x for x in names)]
        traced = {"trace_bytes": os.path.getsize(path), "named": not missing,
                  "names": list(trace_names) + ["tdx.step"],
                  "step_traced_and_read_s": time.perf_counter() - t0}
        shutil.rmtree(tmp, ignore_errors=True)
        if missing:
            raise AssertionError(f"the profiler's trace lacks {missing}")
    kernels = []
    for evt in prof.key_averages():
        # Device kernels only: a user annotation such as
        # "Optimizer.step#AdamW.step" spans kernels counted on their own.
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False) or "#" in evt.key):
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        kernels.append((us / 1e3, evt.count, evt.key))
    kernels.sort(reverse=True)
    total = sum(k[0] for k in kernels)
    by_kind: dict = {}
    for ms, _, name in kernels:
        kind = _kernel_kind(name)
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
    flash = by_kind.get("flash", 0.0)
    flash_by_kernel: dict = {}
    for ms, _, name in kernels:
        if _kernel_kind(name) == "flash":
            key = re.search(r"flash_\w+", name).group(0)
            flash_by_kernel[key] = flash_by_kernel.get(key, 0.0) + ms
    row = {"phase": "train_step_profile", "model": model, "device_ms": total,
           "kernel_launches": sum(k[1] for k in kernels),
           "flash_ms": flash, "flash_share": flash / total if total else None,
           "flash_ms_by_kernel": flash_by_kernel,
           "device_ms_by_kind": by_kind,
           "top_kernels": [{"name": k[2][:90], "ms": k[0], "launches": k[1]}
                           for k in kernels[:12]]}
    if traced is not None:
        row["utils_profiling_trace"] = traced
    if classify is not None:
        row["split"] = classify(prof)
    return row


def _kernel_kind(name: str) -> str:
    """A device kernel's kind, by its name."""
    low = name.lower()
    for kind, marks in (("flash", ("flash_",)),
                        ("collective", ("nccl",)),
                        ("gemm", ("nvjet", "gemm", "cutlass", "cublas")),
                        ("optimizer_and_grad_norm", ("adam", "multi_tensor_apply")),
                        ("copy_or_cast", ("copy",)),
                        ("reduction", ("reduce",)),
                        ("elementwise", ("elementwise",))):
        if any(m in low for m in marks):
            return kind
    return "other"


# The bf16 main path against the same step with default_attention (f32
# softmax, no rounding of P or dS) on the same weights and batch: the
# loss relative, the global gradient norm and each gradient leaf
# normwise.  Everything else in the step is the same bf16 math, so the
# difference is the kernels' bf16 rounding carried through 2 layers
# (measured on an H100: loss and norm 2e-5, the worst leaf 1.8e-2); a
# wrong dq, dk or dv moves its attention leaves by order 1.
BF16_LOSS_RTOL = 1e-3
BF16_GNORM_RTOL = 1e-3
BF16_GRAD_RTOL = 5e-2


def compare_plain_bf16(state, train_step, shard_batch, dev) -> dict:
    """One step of the main path (flash kernels) and one of the same
    model built with ``default_attention``, from the same weights on a
    fresh batch.  The plain model's update is SGD at rate 0: only the
    loss and the gradients are compared."""
    flash_model = state["model"]
    names = [n for n, _ in flash_model.named_parameters()]
    state["opt"].zero_grad(set_to_none=True)  # room for the plain model
    plain = make_llama(TRAIN_CFG, device=dev)
    plain.load_state_dict(flash_model.state_dict())
    p_init, p_step, _ = make_train_step(
        plain, TRAIN_CFG, device=dev,
        optimizer=lambda ps: torch.optim.SGD(ps, lr=0.0))
    batch = shard_batch(np.random.RandomState(32).randint(
        0, TRAIN_CFG.vocab_size, (TRAIN_BATCH, TRAIN_SEQ)))
    p_state, p_metrics = p_step(p_init(plain), batch)
    p_grads = [p.grad for p in p_state["params"]]
    del p_state
    state, metrics = train_step(state, batch)
    grads = [p.grad for p in state["params"]]
    row = vs_plain(names, (float(metrics["loss"]), float(p_metrics["loss"])),
                   (float(metrics["grad_norm"]), float(p_metrics["grad_norm"])),
                   grads, p_grads)
    del plain, p_grads, grads
    torch.cuda.empty_cache()
    return row


def vs_plain(names, losses, grad_norms, grads, p_grads,
             dtype=torch.float64) -> dict:
    """The bf16 comparison with ``default_attention``'s step: (flash,
    plain) loss and gradient norm relative, each gradient leaf normwise
    (in ``dtype``); raises past the limits."""
    (loss, p_loss), (gn, p_gn) = losses, grad_norms
    errs = leaf_errors(names, grads, p_grads, dtype)
    worst = max(errs, key=errs.get)
    worst_attn = max((n for n in errs if ".attn." in n), key=errs.get)
    loss_rel, gn_rel = abs(loss - p_loss) / abs(p_loss), abs(gn - p_gn) / p_gn
    if not loss_rel <= BF16_LOSS_RTOL:
        raise AssertionError(f"loss {loss} vs plain attention {p_loss}")
    if not gn_rel <= BF16_GNORM_RTOL:
        raise AssertionError(f"grad norm {gn} vs plain attention {p_gn}")
    if not errs[worst] <= BF16_GRAD_RTOL:
        raise AssertionError(
            f"gradient of {worst} differs from plain attention's by "
            f"{errs[worst]} (normwise) > {BF16_GRAD_RTOL}")
    return {"loss_flash": loss, "loss_plain": p_loss, "loss_rel_diff": loss_rel,
            "loss_limit": BF16_LOSS_RTOL,
            "grad_norm_flash": gn, "grad_norm_plain": p_gn,
            "grad_norm_rel_diff": gn_rel, "grad_norm_limit": BF16_GNORM_RTOL,
            "grad_worst_leaf": [worst, errs[worst]],
            "grad_worst_attention_leaf": [worst_attn, errs[worst_attn]],
            "grad_by_leaf": errs,
            "grad_limit": f"||flash - plain|| / ||plain|| <= {BF16_GRAD_RTOL} "
                          f"per leaf"}


def phase_train_bf16_full(dev) -> dict:
    """The training main path at llama3-8b width with 2 layers, bf16
    compute: the first step cold (a fresh process) and warm (this one),
    then 4 more steps on the same batch — losses finite and falling — with
    the step time, throughput, MFU, peak device memory and the flash
    kernels' launches (2 layers x 1 per step each), then one step against
    ``default_attention`` on the same weights and one profiled step."""
    torch.cuda.empty_cache()
    cold = run_child("cold_first_step")
    torch.cuda.reset_peak_memory_stats()
    reset_flash_launches()
    _native.reset_walks()
    state, train_step, shard_batch, warm = first_step(dev)
    walks = dict(_native.walks)
    if not walks["native"]:
        raise AssertionError(f"the main path's walks: {walks}")
    batch = shard_batch(train_batch())
    losses, step_s = [warm["first_loss"]], []
    for _ in range(4):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, metrics = train_step(state, batch)
        losses.append(float(metrics["loss"]))
        step_s.append(time.perf_counter() - t)
    launches = dict(flash_launches)
    peak = torch.cuda.max_memory_allocated()
    grad_norm = float(metrics["grad_norm"])
    want = {k: TRAIN_CFG.n_layers * len(losses) for k in FLASH_REPLACES}
    want["flash_dbias"] = 0
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite losses {losses}")
    # Falling: every later step ends below the first.  The repeated batch
    # is memorised within a few steps, after which AdamW at 3e-4 may
    # overshoot a little, so step-to-step order is not required.
    if not all(x < losses[0] for x in losses[1:]):
        raise AssertionError(f"losses do not fall: {losses}")
    if launches != want:
        raise AssertionError(f"flash launches {launches} != {want}")
    vs_plain = compare_plain_bf16(state, train_step, shard_batch, dev)
    step = float(np.median(step_s))
    flops = train_step_flops(state["model"], TRAIN_CFG, TRAIN_BATCH, TRAIN_SEQ)
    row = {"phase": "train_bf16_full", "model": "llama3-8b",
           "n_layers": TRAIN_CFG.n_layers, "dtype": "bfloat16 compute, "
           "float32 parameters", "batch": [TRAIN_BATCH, TRAIN_SEQ],
           "n_params": warm["n_params"], "param_bytes": warm["param_bytes"],
           "first_step_s_cold": cold["first_step_s"],
           "bring_up_s_cold": cold["bring_up_s"],
           "host_rss_growth_bytes_cold": cold["host_rss_growth_bytes"],
           "host_rss_peak_bytes_cold": cold["host_rss_peak_bytes"],
           "first_step_s_warm": warm["first_step_s"],
           "bring_up_s_warm": warm["bring_up_s"],
           "host_rss_growth_bytes_warm": warm["host_rss_growth_bytes"],
           "losses": losses, "last_grad_norm": grad_norm,
           "step_ms": step * 1e3, "step_ms_samples": [x * 1e3 for x in step_s],
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step,
           "flops_per_step": flops,
           "flops_formula": "6 x matmul weights x tokens + 6 x L x B x H x "
                            "S^2 x D (causal attention, fwd + bwd)",
           "mfu": flops / step / PEAK_FLOPS[torch.bfloat16],
           "max_memory_allocated_bytes": peak, "flash_launches": launches,
           "graph_walks": walks, "vs_default_attention": vs_plain}
    emit(row)
    emit(profile_step("llama3-8b", lambda: train_step(state, batch),
                      trace_names=("flash_fwd_bf16_kernel",
                                   "flash_dq_bf16_kernel",
                                   "flash_dkv_bf16_kernel")))
    del state
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# phases 10 to 12: T5 forward and backward from deferred init
# ---------------------------------------------------------------------------


def t5_batch(seed: int, B: int, cfg=None, dev=None):
    """(enc [B, 512], dec [B, 114]) token batches from a numpy seed, below
    ``cfg``'s vocabulary (default: the main path's)."""
    cfg = cfg or T5_CFG
    rng = np.random.RandomState(seed)
    enc = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, T5_ENC)))
    dec = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, T5_DEC)))
    return enc.to(dev), dec.to(dev)


def t5_loss(model, enc, dec) -> torch.Tensor:
    """The decoder's next-token cross-entropy (the JAX package has no T5
    trainer; this is its ``lm_cross_entropy`` on the decoder tokens)."""
    return lm_cross_entropy(model(enc, dec), dec)


def t5_train_step(model, opt, enc, dec):
    """One step: forward, loss, backward, the global gradient norm and
    the optimizer's update; (loss, grad norm) as device scalars."""
    opt.zero_grad(set_to_none=True)
    loss = t5_loss(model, enc, dec)
    loss.backward()
    grad_norm = torch.nn.utils.get_total_norm(
        [p.grad for p in model.parameters() if p.grad is not None])
    opt.step()
    return loss.detach(), grad_norm


def t5_launches_per_step(cfg) -> tuple:
    """(launches, launches with the bias) of one forward and backward:
    each encoder layer's self-attention and each decoder layer's self- and
    cross-attention run the forward, dq and dk/dv kernels; every
    self-attention carries the bias, so runs d(bias) too."""
    L_e, L_d = cfg.encoder.n_layers, cfg.decoder.n_layers
    fwd, biased = L_e + 2 * L_d, L_e + L_d
    return ({"flash_fwd": fwd, "flash_bwd_dq": fwd, "flash_bwd_dkv": fwd,
             "flash_dbias": biased}, {k: biased for k in flash_launches})


def t5_step_flops(model, cfg, B: int) -> float:
    """Model FLOPs of one step: 6 per weight of every matrix product per
    token of its stack (the tied head per decoder token), plus attention's
    QKᵀ and PV, forward and backward: 12·B·H·D per visible (query, key)
    pair of the encoder's and the cross-attention's full squares and of
    the decoder's causal half (6·S² per head, as ``train_step_flops``)."""
    def weights(blocks):
        return sum(m.weight.numel() for m in blocks.modules()
                   if isinstance(m, Linear))

    e, d = cfg.encoder, cfg.decoder
    head = cfg.vocab_size * d.d_model if cfg.tie_embeddings else 0
    matmul = 6.0 * (weights(model.enc_blocks) * B * T5_ENC
                    + (weights(model.dec_blocks) + head) * B * T5_DEC)
    attn = 6.0 * B * e.n_heads * e.head_size * (
        2 * e.n_layers * T5_ENC ** 2 + d.n_layers * T5_DEC ** 2
        + 2 * d.n_layers * T5_DEC * T5_ENC)
    return matmul + attn


# T5 at full width in f32, flash against plain attention: the same sums
# as the gpt2 check, in another order; a wrong d(bias) moves the relative
# tables' gradient by order 1.
T5_F32_LOGIT_ATOL = 1e-4


def phase_t5_f32_exact(dev) -> dict:
    """T5-11B width with 2 + 2 layers at f32 compute: one forward and
    backward of the decoder loss with the flash kernels and one with
    ``default_attention``, from the same materialized weights and batch."""
    cfg = T5_CFG.replace(encoder=T5_CFG.encoder.replace(dtype=torch.float32),
                         decoder=T5_CFG.decoder.replace(dtype=torch.float32))
    B = 2
    torch.manual_seed(0)
    flash_model = materialize_module(
        deferred_init(make_t5, cfg, attn_fn=make_flash_attention(),
                      device=dev), device=dev)
    plain_model = make_t5(cfg, device=dev)
    plain_model.load_state_dict(flash_model.state_dict())
    enc, dec = t5_batch(41, B, cfg, dev)
    runs = {}
    for name, model in (("flash", flash_model), ("plain", plain_model)):
        reset_flash_launches()
        logits = model(enc, dec)
        loss = lm_cross_entropy(logits, dec)
        loss.backward()
        torch.cuda.synchronize()
        runs[name] = {"logits": logits.detach(), "loss": loss.item(),
                      "grads": [p.grad for p in model.parameters()],
                      "launches": dict(flash_launches),
                      "bias_launches": dict(flash_bias_launches)}
    flash, plain = runs["flash"], runs["plain"]
    names = [n for n, _ in flash_model.named_parameters()]
    errs = leaf_errors(names, flash["grads"], plain["grads"])
    worst = max(errs, key=errs.get)
    logit_err = (flash["logits"] - plain["logits"]).abs().max().item()
    want, want_bias = t5_launches_per_step(cfg)
    tables = ("enc_relpos.embedding", "dec_relpos.embedding")
    if not all(math.isfinite(r["loss"]) for r in runs.values()):
        raise AssertionError(f"non-finite loss: {flash['loss']} {plain['loss']}")
    if not logit_err <= T5_F32_LOGIT_ATOL:
        raise AssertionError(f"logits differ by {logit_err}")
    if not errs[worst] <= F32_GRAD_RTOL:
        raise AssertionError(
            f"gradient of {worst} differs by {errs[worst]} (normwise) > "
            f"{F32_GRAD_RTOL}")
    if flash["launches"] != want or flash["bias_launches"] != want_bias \
            or any(plain["launches"].values()):
        raise AssertionError(
            f"launches flash {flash['launches']} (with the bias "
            f"{flash['bias_launches']}) != {want} ({want_bias}), plain "
            f"{plain['launches']}")
    row = {"phase": "t5_f32_exact", "model": "t5-11b@2+2-layers",
           "dtype": "float32", "batch": [B, T5_ENC, T5_DEC],
           "loss_flash": flash["loss"], "loss_plain": plain["loss"],
           "max_logit_err": logit_err, "logit_limit": T5_F32_LOGIT_ATOL,
           "grad_worst_leaf": [worst, errs[worst]],
           "grad_relative_tables": {t: errs[t] for t in tables},
           "grad_by_leaf": {n: errs[n] for n in names if ".1." not in n},
           "grad_limit": f"||flash - plain|| / ||plain|| <= {F32_GRAD_RTOL} "
                         f"per leaf",
           "flash_launches": flash["launches"],
           "flash_launches_with_bias": flash["bias_launches"]}
    emit(row)
    del flash_model, plain_model, runs, flash, plain
    torch.cuda.empty_cache()
    return row


def t5_first_step(dev):
    """The T5 main path from nothing: deferred_init of T5_CFG with the
    flash kernels, materialize on the card, ``default_optimizer``, one
    step; the clock runs from before ``deferred_init`` to the first loss
    on the host, and the host RSS is sampled throughout."""
    enc, dec = t5_batch(51, T5_BATCH)
    rss0 = _rss_bytes()
    with RssSampler() as rss:
        t0 = time.perf_counter()
        model = deferred_init(make_t5, T5_CFG, attn_fn=make_flash_attention(),
                              device=dev)
        torch.manual_seed(0)
        materialize_module(model, device=dev)
        opt = default_optimizer(model.parameters())
        torch.cuda.synchronize()
        bring_up = time.perf_counter() - t0
        loss, _ = t5_train_step(model, opt, enc.to(dev), dec.to(dev))
        loss = float(loss)
        seconds = time.perf_counter() - t0
    params = list(model.parameters())
    param_bytes = sum(p.numel() * p.element_size() for p in params)
    growth = rss.peak - rss0
    if not growth < param_bytes / 4:
        raise AssertionError(
            f"host RSS grew {growth} bytes bringing up {param_bytes} bytes "
            f"of parameters")
    stats = {"first_step_s": seconds, "bring_up_s": bring_up,
             "first_loss": loss, "n_params": sum(p.numel() for p in params),
             "param_bytes": param_bytes, "host_rss_peak_bytes": rss.peak,
             "host_rss_growth_bytes": growth}
    return model, opt, stats


def cuda_context(dev) -> dict:
    """Create the CUDA context and load cuBLAS with one small product: the
    seconds and host RSS that any process pays before its first model
    byte (a fixed cost, about 1 GB of RSS, whatever the model's size)."""
    rss0, t0 = _rss_bytes(), time.perf_counter()
    x = torch.ones(64, 64, dtype=torch.bfloat16, device=dev)
    (x @ x).float().sum().item()
    return {"cuda_context_s": time.perf_counter() - t0,
            "cuda_context_rss_bytes": _rss_bytes() - rss0}


def cold_t5_first_step() -> None:
    """``t5_first_step`` in a fresh process, after its CUDA context.  The
    RSS limit holds what bring-up and the step add: at 3.89 GB of
    parameters a quarter is 0.97 GB, and the context alone takes 0.38 GB
    of it on an H100 (the rest of a cold step's growth, 0.7–0.9 GB, is a
    once-per-process cost: the same step adds ~1 MB when warm)."""
    dev = torch.device("cuda", 0)
    ctx = cuda_context(dev)
    *_, stats = t5_first_step(dev)
    emit({**ctx, **stats})


def compare_plain_t5(model, opt, dev) -> dict:
    """One forward and backward of the main path's model (flash kernels)
    and of the same model built with ``default_attention``, from the same
    weights on a fresh batch: the loss relative, the global gradient norm
    and each gradient leaf normwise (the limits of the llama check)."""
    names = [n for n, _ in model.named_parameters()]
    opt.zero_grad(set_to_none=True)  # room for the plain model
    enc, dec = t5_batch(52, T5_BATCH, dev=dev)
    plain = make_t5(T5_CFG, device=dev)
    plain.load_state_dict(model.state_dict())
    p_loss = t5_loss(plain, enc, dec)
    p_loss.backward()
    p_grads = [p.grad for p in plain.parameters()]
    del plain
    torch.cuda.empty_cache()
    loss = t5_loss(model, enc, dec)
    loss.backward()
    grads = [p.grad for p in model.parameters()]
    norm = torch.nn.utils.get_total_norm
    row = vs_plain(names, (loss.item(), p_loss.item()),
                   (norm(grads).item(), norm(p_grads).item()), grads, p_grads)
    del p_grads, grads
    opt.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    tables = ("enc_relpos.embedding", "dec_relpos.embedding")
    return {**row,
            "grad_relative_tables": {t: row["grad_by_leaf"][t] for t in tables}}


def phase_t5_train_bf16(dev) -> dict:
    """The T5 main path: the first step cold (a fresh process) and warm
    (this one), 3 more steps on the same batch — losses finite, the last
    below the first — with the step time, throughput, MFU, peak device
    memory and the flash kernels' launches per step, then one step
    against ``default_attention`` on the same weights and one profiled
    step."""
    torch.cuda.empty_cache()
    cold = run_child("cold_t5_first_step")
    torch.cuda.reset_peak_memory_stats()
    reset_flash_launches()
    model, opt, warm = t5_first_step(dev)
    enc, dec = t5_batch(51, T5_BATCH, dev=dev)
    losses, step_s = [warm["first_loss"]], []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss, grad_norm = t5_train_step(model, opt, enc, dec)
        losses.append(float(loss))
        step_s.append(time.perf_counter() - t)
    launches, with_bias = dict(flash_launches), dict(flash_bias_launches)
    peak = torch.cuda.max_memory_allocated()
    per_step, per_step_bias = t5_launches_per_step(T5_CFG)
    want = {k: n * len(losses) for k, n in per_step.items()}
    want_bias = {k: n * len(losses) for k, n in per_step_bias.items()}
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"losses do not fall: {losses}")
    if launches != want or with_bias != want_bias:
        raise AssertionError(f"flash launches {launches} (with the bias "
                             f"{with_bias}) != {want} ({want_bias})")
    vs_plain = compare_plain_t5(model, opt, dev)
    step = float(np.median(step_s))
    flops = t5_step_flops(model, T5_CFG, T5_BATCH)
    tokens = T5_BATCH * (T5_ENC + T5_DEC)
    row = {"phase": "t5_train_bf16", "model": "t5-11b",
           "n_layers": [T5_CFG.encoder.n_layers, T5_CFG.decoder.n_layers],
           "dtype": "bfloat16 compute, float32 parameters",
           "batch": [T5_BATCH, T5_ENC, T5_DEC],
           "n_params": warm["n_params"], "param_bytes": warm["param_bytes"],
           "cuda_context_s_cold": cold["cuda_context_s"],
           "cuda_context_rss_bytes_cold": cold["cuda_context_rss_bytes"],
           "first_step_s_cold": cold["first_step_s"],
           "bring_up_s_cold": cold["bring_up_s"],
           "host_rss_growth_bytes_cold": cold["host_rss_growth_bytes"],
           "host_rss_peak_bytes_cold": cold["host_rss_peak_bytes"],
           "host_rss_limit_bytes": cold["param_bytes"] / 4,
           "first_step_s_warm": warm["first_step_s"],
           "bring_up_s_warm": warm["bring_up_s"],
           "host_rss_growth_bytes_warm": warm["host_rss_growth_bytes"],
           "losses": losses, "last_grad_norm": float(grad_norm),
           "step_ms": step * 1e3, "step_ms_samples": [x * 1e3 for x in step_s],
           "tokens_per_s": tokens / step,
           "decoder_tokens_per_s": T5_BATCH * T5_DEC / step,
           "flops_per_step": flops,
           "flops_formula": "6 x matmul weights x their stack's tokens + "
                            "12 x B x H x D x attended pairs (encoder and "
                            "cross full, decoder causal half)",
           "mfu": flops / step / PEAK_FLOPS[torch.bfloat16],
           "max_memory_allocated_bytes": peak, "flash_launches": launches,
           "flash_launches_with_bias": with_bias,
           "flash_launches_per_step": per_step,
           "vs_default_attention": vs_plain}
    emit(row)
    emit(profile_step("t5-11b@2+2-layers",
                      lambda: t5_train_step(model, opt, enc, dec)))
    del model, opt
    torch.cuda.empty_cache()
    return row


def t5_11b_full_depth() -> None:
    """Full-depth T5-11B with bf16 parameters in a fresh process, after its
    CUDA context: deferred_init -> materialize on the card (seconds, host
    RSS growth below a quarter of the parameter bytes), then one forward
    at B = 1 on the flash kernels with finite logits; prints its figures
    as one JSON line."""
    dev = torch.device("cuda", 0)
    cfg = T5_11B.replace(
        encoder=T5_11B.encoder.replace(param_dtype=torch.bfloat16),
        decoder=T5_11B.decoder.replace(param_dtype=torch.bfloat16))
    enc, dec = t5_batch(61, 1, cfg)
    ctx = cuda_context(dev)
    rss0 = _rss_bytes()
    with RssSampler() as rss:
        t0 = time.perf_counter()
        model = deferred_init(make_t5, cfg, attn_fn=make_flash_attention(),
                              device=dev)
        torch.manual_seed(0)
        materialize_module(model, device=dev)
        torch.cuda.synchronize()
        bring_up = time.perf_counter() - t0
    params = list(model.parameters())
    param_bytes = sum(p.numel() * p.element_size() for p in params)
    growth = rss.peak - rss0
    if not growth < param_bytes / 4:
        raise AssertionError(
            f"host RSS grew {growth} bytes materializing {param_bytes} bytes")
    reset_flash_launches()
    t = time.perf_counter()
    with torch.no_grad():
        logits = model(enc.to(dev), dec.to(dev))
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t
    want = {k: n for k, n in t5_launches_per_step(cfg)[0].items()
            if k != "flash_dbias"}
    launches = {k: flash_launches[k] for k in want}
    if tuple(logits.shape) != (1, T5_DEC, cfg.vocab_size) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"logits {tuple(logits.shape)} not finite")
    if launches["flash_fwd"] != want["flash_fwd"] \
            or flash_bias_launches["flash_fwd"] != cfg.encoder.n_layers \
            + cfg.decoder.n_layers:
        raise AssertionError(f"forward launches {launches}")
    emit({"phase": "t5_11b_full_depth", "model": "t5-11b",
          "n_layers": [cfg.encoder.n_layers, cfg.decoder.n_layers],
          "dtype": "bfloat16 parameters and compute", **ctx,
          "n_params": sum(p.numel() for p in params),
          "param_bytes": param_bytes, "bring_up_s": bring_up,
          "host_rss_peak_bytes": rss.peak, "host_rss_growth_bytes": growth,
          "forward_batch": [1, T5_ENC, T5_DEC], "forward_s": forward_s,
          "logits_finite": True,
          "flash_fwd_launches": launches["flash_fwd"],
          "flash_fwd_launches_with_bias": flash_bias_launches["flash_fwd"],
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})


def phase_t5_11b_full_depth() -> dict:
    torch.cuda.empty_cache()
    row = run_child("t5_11b_full_depth")
    emit(row)
    return row


# ---------------------------------------------------------------------------
# phases 13 to 15: the keyed, sharded materializer (cuda_bridge)
# ---------------------------------------------------------------------------

# Keyed draws against eager construction's on the card: the std of a
# random entry of n >= 65,536 draws has a sampling spread of about
# 1/sqrt(2n) <= 0.28 %, so 2 % allows for the truncation's tails and
# still fails a wrong init (a missing scale, a wrong fan).
STD_RTOL = 0.02
STD_MIN_NUMEL = 1 << 16
MATERIALIZE_CFG = PRESETS["gpt2-125m"].replace(dtype=torch.float32)
VIRTUAL_MESHES = (("decoder_lm_plan", {"fsdp": 2, "tp": 4}),
                  ("gspmd_2d_plan", {"fsdp": 2, "tp": 4}),
                  ("fsdp_plan", {"fsdp": 8}))
FIRST_STEP_LOSS_RTOL = 1e-3


def draws(fake) -> bool:
    """Whether the recording behind ``fake`` draws random numbers."""
    ctx = get_fake_context(fake, _graph.CONTEXT_KEY)
    return any(_graph._is_rng_op(n.op.func) for n in ctx.node.build_call_stack())


def draws_keyed(fake) -> bool:
    """Whether the recording behind ``fake`` draws through the keyed
    kernel (a ``uniform_`` / ``normal_``)."""
    ctx = get_fake_context(fake, _graph.CONTEXT_KEY)
    return any(cuda_mat._keyed_draw(n) is not None
               for n in ctx.node.build_call_stack())


def shard_region(shape, spec, axes: dict, coord: dict) -> tuple:
    """The slices of the full tensor that the device at ``coord`` holds
    under ``spec`` (a dim over several axes: the first named is the major
    one) — written apart from the port's ``local_shard``."""
    region = []
    for d, size in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        names = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        n, i = 1, 0
        for a in names:
            n, i = n * axes[a], i * axes[a] + coord[a]
        region.append(slice(i * (size // n), (i + 1) * (size // n)))
    return tuple(region)


def one_rank_group() -> None:
    """A process group of world size 1 over an in-memory store: NCCL,
    no network."""
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)


def phase_materialize_invariance(dev) -> dict:
    """gpt2-125m (f32) through ``materialize_module_cuda``: same seed
    twice bitwise equal, seed 1 moves every random entry; against eager
    construction on the card, equal names, shapes and dtypes, the
    entries that draw nothing bitwise equal, the random ones' std within
    2 %; each of the 8 coordinates of three plans' virtual meshes,
    materialized on its own, equal to its slice of the unsharded values
    bit for bit, the slices covering every element; a real one-rank
    ``DeviceMesh`` (NCCL, world size 1) equal to ``mesh=None``; the module
    still fake at the end."""
    cfg = MATERIALIZE_CFG
    model = deferred_init(make_gpt2, cfg, device=dev)
    fakes = named_fake_tensors(model)
    random = {n for n, f in fakes.items() if draws(f)}
    t = time.perf_counter()
    a = materialize_module_cuda(model, seed=0, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    whole_stats = cuda_mat.last_run_stats()
    b = materialize_module_cuda(model, seed=0, device=dev)
    c = materialize_module_cuda(model, seed=1, device=dev)
    for n in a:
        if not torch.equal(a[n], b[n]):
            raise AssertionError(f"{n}: seed 0 twice differs")
        if torch.equal(a[n], c[n]) == (n in random):
            raise AssertionError(f"{n}: seed 1 {'equals' if n in random else 'moves'} it")
    del b, c
    torch.manual_seed(0)
    eager_model = make_gpt2(cfg, device=dev)
    eager = dict(eager_model.named_parameters())
    eager.update(eager_model.named_buffers())
    del eager_model
    if list(eager) != list(a):
        raise AssertionError(f"names {list(a)} != eager {list(eager)}")
    std_worst = 0.0
    for n, v in a.items():
        e = eager[n].detach()
        if v.shape != e.shape or v.dtype != e.dtype or v.device != e.device:
            raise AssertionError(f"{n}: {v.shape} {v.dtype} {v.device} != "
                                 f"eager {e.shape} {e.dtype} {e.device}")
        if n not in random and not torch.equal(v, e):
            raise AssertionError(f"{n} draws nothing and differs from eager")
        if n in random and v.numel() >= STD_MIN_NUMEL:
            rel = abs(v.std().item() / e.std().item() - 1)
            std_worst = max(std_worst, rel)
            if rel > STD_RTOL:
                raise AssertionError(f"{n}: std {v.std().item()} vs eager "
                                     f"{e.std().item()}")
    del eager
    plans = {"decoder_lm_plan": decoder_lm_plan(cfg),
             "gspmd_2d_plan": gspmd_2d_plan(), "fsdp_plan": fsdp_plan()}
    meshes = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # heads tp does not divide
        for plan_name, axes in VIRTUAL_MESHES:
            plan = plans[plan_name]
            shape = VirtualMesh(axes, {x: 0 for x in axes}).shape
            specs = {n: plan.spec_for(n, tuple(v.shape), shape)
                     for n, v in a.items()}
            covered = {n: torch.zeros(v.shape, dtype=torch.int32, device=dev)
                       for n, v in a.items()}
            coords = list(itertools.product(*(range(k) for k in shape.values())))
            local_bytes, growths, shard_local = [], [], []
            for coord in coords:
                where = dict(zip(shape, coord))
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                local = materialize_module_cuda(
                    model, mesh=VirtualMesh(axes, where), plan=plan,
                    seed=0, device=dev)
                torch.cuda.synchronize()
                growth = torch.cuda.max_memory_allocated() - base
                shard_local.append(cuda_mat.last_run_stats()["local_entries"])
                nbytes = sum(v.numel() * v.element_size()
                             for v in local.values())
                largest = max(v.numel() * fakes[n].element_size()
                              for n, v in local.items())
                if not growth <= nbytes + 2 * largest:
                    raise AssertionError(
                        f"{plan_name} {where}: device memory grew {growth} "
                        f"bytes for {nbytes} local bytes, largest local "
                        f"shard {largest}")
                local_bytes.append(nbytes)
                growths.append({"growth_bytes": growth,
                                "limit_bytes": nbytes + 2 * largest})
                for n, v in local.items():
                    region = shard_region(a[n].shape, specs[n], shape, where)
                    if not torch.equal(v, a[n][region]):
                        raise AssertionError(f"{plan_name} {where} {n}: the "
                                             f"shard is not its slice")
                    covered[n][region] += 1
                del local
            if any(not bool((k > 0).all()) for k in covered.values()):
                raise AssertionError(f"{plan_name}: the shards miss elements")
            meshes[plan_name] = {
                "axes": axes, "coordinates": len(coords),
                "sharded_entries": sum(1 for s in specs.values() if any(s)),
                "entries": len(specs),
                "shard_local_entries_per_coordinate": shard_local,
                "local_bytes_max": max(local_bytes),
                "max_memory_allocated_growth": growths,
                "gathered_equals_unsharded": True}
            del covered
    one_rank_group()
    try:
        mesh = make_mesh({"fsdp": 1, "tp": 1}, device_type="cuda")
        plan = decoder_lm_plan(cfg)
        on_mesh = materialize_module_cuda(model, mesh=mesh, plan=plan, seed=0)
        for n, v in on_mesh.items():
            spec = plan.spec_for(n, tuple(a[n].shape), mesh)
            if tuple(v.placements) != placements_for(spec, mesh):
                raise AssertionError(f"{n}: placements {v.placements}")
            if not torch.equal(v.to_local(), a[n]):
                raise AssertionError(f"{n}: the one-rank mesh differs")
        del on_mesh
    finally:
        dist.destroy_process_group()
    if not all(is_fake(f) for f in named_fake_tensors(model).values()):
        raise AssertionError("the recording was consumed")
    native_vs_python = walk_engines(model, a, cfg, dev)
    resume = materialize_resume(model, a, dev)
    param_bytes = sum(v.numel() * v.element_size() for v in a.values())
    row = {"phase": "materialize_invariance", "model": "gpt2-125m",
           "dtype": "float32", "entries": len(a), "random_entries": len(random),
           "param_bytes": param_bytes, "materialize_s_warm": seconds,
           "engine": whole_stats, "materialize_resume": resume,
           "same_seed_bitwise": True, "seed_1_moves_every_random_entry": True,
           "eager_names_shapes_dtypes": True,
           "eager_rng_free_bitwise": len(a) - len(random),
           "eager_std_worst_rel": std_worst,
           "eager_std_limit": f"<= {STD_RTOL} for n >= {STD_MIN_NUMEL}",
           "virtual_meshes": meshes,
           "one_rank_nccl_mesh_equals_unsharded": True,
           "still_fake": True, "native_vs_python": native_vs_python}
    emit(row)
    del a
    torch.cuda.empty_cache()
    return row


RESUME_FAULT = "execute@3=raise"
RETRIED_FAULT = "execute@2=raise x2"


def materialize_resume(model, clean: dict, dev) -> dict:
    """The materializer's fault and resume leg on gpt2-125m (f32, the
    module of ``materialize_invariance``, ``clean`` its fault-free
    values): under ``execute@3=raise`` with no retries a
    ``MaterializationError`` with groups 1 and 2 committed under
    ``TDX_MATERIALIZE_RESUME_DIR``; one byte of the first committed
    payload flipped; the rerun recomputes that group, loads the others
    and is bitwise the clean run, and sweeps the directory; then
    ``execute@2=raise x2`` with 2 retries survived, bitwise."""
    root = tempfile.mkdtemp(prefix="tdx_resume_")
    out = {"fault": RESUME_FAULT, "retries": 0}
    try:
        chaos.install(RESUME_FAULT)
        t = time.perf_counter()
        try:
            with tdx_config.override(materialize_resume_dir=root,
                                     materialize_retries=0):
                materialize_module_cuda(model, seed=0, device=dev)
            raise AssertionError(f"{RESUME_FAULT} raised nothing")
        except cuda_mat.MaterializationError as e:
            err = e
        finally:
            chaos.clear()
        out["interrupted_s"] = time.perf_counter() - t
        if not ({0, 1} <= set(err.completed_groups)
                and err.failed_groups == [2] and err.resumable):
            raise AssertionError(f"interrupted run: completed "
                                 f"{err.completed_groups}, failed "
                                 f"{err.failed_groups}")
        cdir = os.path.join(root, "whole")
        with open(os.path.join(cdir, "MATERIALIZE_PROGRESS.json")) as f:
            manifest = json.load(f)
        fp, rec = next(iter(manifest["groups"].items()))
        victim = os.path.join(cdir, fp, rec["outputs"][0]["file"])
        data = bytearray(open(victim, "rb").read())
        data[len(data) // 2] ^= 0xFF
        open(victim, "wb").write(bytes(data))
        payload = sum(os.path.getsize(os.path.join(d, f))
                      for d, _, fs in os.walk(cdir) for f in fs)
        t = time.perf_counter()
        with tdx_config.override(materialize_resume_dir=root):
            got = materialize_module_cuda(model, seed=0, device=dev)
        torch.cuda.synchronize()
        out["resumed_s"] = time.perf_counter() - t
        stats = cuda_mat.last_run_stats()
        if stats["resumed"] != len(err.completed_groups) - 1:
            raise AssertionError(f"resumed {stats['resumed']} groups of "
                                 f"{len(err.completed_groups)} committed, "
                                 f"one flipped")
        unequal = [n for n in clean if not torch.equal(got[n], clean[n])]
        if unequal or os.path.exists(cdir):
            raise AssertionError(f"resumed run: unequal {unequal[:4]}, "
                                 f"swept {not os.path.exists(cdir)}")
        del got
        chaos.install(RETRIED_FAULT)
        try:
            with tdx_config.override(materialize_retries=2):
                got = materialize_module_cuda(model, seed=0, device=dev)
        finally:
            chaos.clear()
        retried = cuda_mat.last_run_stats()
        unequal = [n for n in clean if not torch.equal(got[n], clean[n])]
        if unequal or retried["retries"] != 2 or retried["fallback"]:
            raise AssertionError(f"{RETRIED_FAULT}: unequal {unequal[:4]}, "
                                 f"{retried}")
        del got
    finally:
        chaos.clear()
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return {**out, "groups": stats["n_groups"],
            "completed_groups": err.completed_groups,
            "failed_groups": err.failed_groups, "payload_bytes": payload,
            "flipped_group_recomputed": True, "resumed_groups":
            stats["resumed"], "resumed_bitwise": True, "swept": True,
            "retried_fault": RETRIED_FAULT, "retried": retried["retries"],
            "retried_bitwise": True}


def walk_seconds(fakes: dict) -> float:
    """Host seconds of the call-stack walks of every entry."""
    t = time.perf_counter()
    for f in fakes.values():
        get_fake_context(f, _graph.CONTEXT_KEY).node.build_call_stack()
    return time.perf_counter() - t


def walk_engines(model, values: dict, cfg, dev) -> dict:
    """gpt2-125m recorded again under ``config.override(native=False)``
    (its walks in Python) and materialized: bitwise equal to the native
    recording's ``values``; the host seconds of both recordings' walks."""
    start = time.perf_counter()
    native_s = walk_seconds(named_fake_tensors(model))
    if get_fake_context(next(iter(named_fake_tensors(model).values())),
                        _graph.CONTEXT_KEY).node._ng is None:
        raise AssertionError("the native recording has no native graph")
    with tdx_config.override(native=False):
        py_model = deferred_init(make_gpt2, cfg, device=dev)
        before = _native.walks["python"]
        py_values = materialize_module_cuda(py_model, seed=0, device=dev)
        python_walks = _native.walks["python"] - before
        python_s = walk_seconds(named_fake_tensors(py_model))
    if not python_walks:
        raise AssertionError("the native=False recording walked natively")
    unequal = [n for n in values if not torch.equal(values[n], py_values[n])]
    if unequal or list(py_values) != list(values):
        raise AssertionError(f"native and Python walks differ: {unequal[:4]}")
    return {"bitwise": True, "entries": len(values),
            "walk_s_native": native_s, "walk_s_python": python_s,
            "python_walks": python_walks,
            "check_s": time.perf_counter() - start}


def materialize_llama3_8b(rec_dir=None) -> None:
    """Full-depth llama3-8b recorded in f32, materialized as bf16 by
    ``materialize_module_cuda`` under ``decoder_lm_plan`` on a one-rank
    NCCL mesh, as the first CUDA work of a fresh process after its CUDA
    context: seconds from ``deferred_init`` to every value resident on
    the card, bytes, GB/s, host RSS growth (below a quarter of the bytes)
    and the growth of ``max_memory_allocated`` (at most the bytes plus
    twice the largest entry at its recorded dtype); prints one JSON
    line."""
    dev = torch.device("cuda", 0)
    ctx = cuda_context(dev)
    one_rank_group()
    try:
        mesh = make_mesh({"fsdp": 1, "tp": 1}, device_type="cuda")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        rss0 = _rss_bytes()
        with RssSampler() as rss:
            t0 = time.perf_counter()
            model = deferred_init(make_llama, LLAMA3_8B, device=dev)
            recorded = time.perf_counter() - t0
            keyed_rng.launches = 0
            values = materialize_module_cuda(
                model, mesh=mesh, plan=decoder_lm_plan(LLAMA3_8B), seed=0,
                param_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        keyed_launches = keyed_rng.launches
        engine = cuda_mat.last_run_stats()
        peak = torch.cuda.max_memory_allocated() - base
        fakes = named_fake_tensors(model)
        largest = max(f.numel() * f.element_size() for f in fakes.values())
        local = {n: v.to_local() for n, v in values.items()}
        nbytes = sum(v.numel() * v.element_size() for v in local.values())
        growth = rss.peak - rss0
        if not growth < nbytes / 4:
            raise AssertionError(f"host RSS grew {growth} bytes materializing "
                                 f"{nbytes} bytes")
        if not peak <= nbytes + 2 * largest:
            raise AssertionError(f"device memory grew {peak} bytes for {nbytes} "
                                 f"bytes, largest entry {largest}")
        draws = sum(1 for f in fakes.values() if draws_keyed(f))
        if keyed_launches < draws or not engine["local_entries"]:
            raise AssertionError(f"{keyed_launches} keyed-draw launches for "
                                 f"{draws} drawing entries; {engine}")
        for n, v in local.items():
            want = torch.bfloat16 if isinstance(fakes[n], nn.Parameter) \
                else fakes[n].dtype
            if v.dtype != want or v.shape != fakes[n].shape:
                raise AssertionError(f"{n}: {v.dtype} {tuple(v.shape)}")
            if v.is_floating_point() and not bool(torch.isfinite(v).all()):
                raise AssertionError(f"{n} is not finite")
        # After the timed region: the login host's recording, and the
        # link probe.
        travel = (travel_full_depth(rec_dir, fakes, local,
                                    nbytes / seconds / 1e9)
                  if rec_dir else None)
    finally:
        dist.destroy_process_group()
    emit({"phase": "materialize_llama3_8b", "model": "llama3-8b",
          "n_layers": LLAMA3_8B.n_layers, "dtype": "recorded float32, "
          "bfloat16 parameters", "mesh": {"fsdp": 1, "tp": 1},
          "plan": "decoder_lm_plan", **ctx, "entries": len(local),
          "bytes": nbytes, "record_s": recorded, "materialize_s": seconds,
          "replay_s": seconds - recorded,
          "gb_per_s": nbytes / seconds / 1e9,
          "host_rss_peak_bytes": rss.peak, "host_rss_growth_bytes": growth,
          "host_rss_limit_bytes": nbytes / 4,
          "max_memory_allocated_growth_bytes": peak,
          "device_limit_bytes": nbytes + 2 * largest,
          "largest_entry_bytes": largest, "walks": dict(_native.walks),
          "keyed_rng_launches": keyed_launches, "engine": engine,
          "login_host_recording": travel, "card": nvidia_smi()})


def phase_materialize_llama3_8b(serve_row, rec_dir) -> dict:
    torch.cuda.empty_cache()
    row = run_child("materialize_llama3_8b", rec_dir)
    if rec_dir and not row["login_host_recording"]:
        raise AssertionError("the login host's recording was not checked")
    row["serve_bring_up_s_cold"] = (serve_row or {}).get("bring_up_s_cold")
    emit(row)
    return row


# The login host: no CUDA device visible to the child that records.
LOGIN_ENV = {"CUDA_VISIBLE_DEVICES": ""}
# What the full-depth loaded recording materializes on the card: the
# embedding, one layer's q projection and the final norm.
TRAVEL_SAMPLE = ("embed.weight", "blocks.0.attn.wq.weight", "final_norm.scale")


def login_host_record(tmp: str) -> None:
    """The login host (a child that sees no CUDA device): full-depth
    llama3-8b and the 2-layer ``TRAIN_CFG`` model (with the flash
    attention function) recorded claiming ``cuda`` through the native
    walks and saved with ``save_recording`` into ``tmp``; no CUDA
    context is made.  Prints the files' bytes and the record and save
    seconds as one JSON line."""
    if torch.cuda.is_available():
        raise AssertionError("the login host sees a CUDA device")
    _native.reset_walks()
    row = {"phase": "login_host", "cuda_visible_devices":
           os.environ.get("CUDA_VISIBLE_DEVICES"), "files": {}}
    for name, cfg, kw in (("llama3-8b", LLAMA3_8B, {}),
                          ("train_cfg", TRAIN_CFG,
                           {"attn_fn": make_flash_attention()})):
        t0 = time.perf_counter()
        model = deferred_init(make_llama, cfg, device="cuda", **kw)
        recorded = time.perf_counter() - t0
        fakes = named_fake_tensors(model)
        if {f.device.type for f in fakes.values()} != {"cuda"}:
            raise AssertionError(f"{name}: fakes claim "
                                 f"{ {f.device.type for f in fakes.values()} }")
        path = f"{tmp}/{name}.tdx"
        t0 = time.perf_counter()
        save_recording(model, path)
        saved = time.perf_counter() - t0
        row["files"][name] = {"n_layers": cfg.n_layers, "entries": len(fakes),
                              "bytes": os.path.getsize(path),
                              "record_s": recorded, "save_s": saved}
        del model, fakes
    if torch.cuda.is_initialized():
        raise AssertionError("the login host made a CUDA context")
    if not _native.walks["native"]:
        raise AssertionError(f"the login host's walks: {_native.walks}")
    row.update(cuda_initialized=False, walks=dict(_native.walks))
    emit(row)


def start_login_host() -> tuple:
    """:func:`login_host_record` started in a child that sees no CUDA
    device, into a fresh directory: it uses the host only, so it runs
    beside the flash phases before ``login_host``."""
    tmp = tempfile.mkdtemp(prefix="tdx_login_")
    return tmp, start_child("login_host_record", tmp,
                            env={**os.environ, **LOGIN_ENV})


def phase_login_host(started) -> str:
    """The login-host child's line; the directory of its two recordings
    (removed by the caller)."""
    tmp, handle = started
    t0 = time.perf_counter()
    row = join_child(handle, CHILD_TIMEOUT_S)
    row["waited_s"] = time.perf_counter() - t0
    emit(row)
    return tmp


def entry_key_nrs(fakes: dict) -> dict:
    """Each entry's producing op's ``key_nr``."""
    return {n: get_fake_context(f, _graph.CONTEXT_KEY).node.key_nr
            for n, f in fakes.items()}


def travel_full_depth(rec_dir: str, fakes: dict, values: dict,
                      gb_per_s: float) -> dict:
    """The login host's full-depth recording against this process's: the
    same names, shapes, dtypes and key_nrs; the sampled entries
    materialized from the loaded fakes (telemetry on, after the link
    probe: the span's link utilization) bitwise equal to this process's
    values.  Then the link probe's GB/s and the timed run's utilization."""
    start = t0 = time.perf_counter()
    loaded = load_recording(f"{rec_dir}/llama3-8b.tdx")
    load_s = time.perf_counter() - t0
    if list(loaded) != list(fakes):
        raise AssertionError("the loaded recording's names differ")
    for n, f in loaded.items():
        g = fakes[n]
        if (f.shape, f.dtype, is_param_like(f)) != (g.shape, g.dtype,
                                                     is_param_like(g)):
            raise AssertionError(f"{n}: loaded {f.shape} {f.dtype}")
    if entry_key_nrs(loaded) != entry_key_nrs(fakes):
        raise AssertionError("the loaded recording's key_nrs differ")
    t0 = time.perf_counter()
    link = costmodel.link_bandwidth_gbps()
    probe_s = time.perf_counter() - t0
    if not link:
        raise AssertionError("the link probe failed")
    observe.enable(True)
    try:
        sample = materialize_params_cuda(
            {n: loaded[n] for n in TRAVEL_SAMPLE}, seed=0,
            param_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        (span,) = [e for e in observe.tracer().events
                   if e.get("ph") == "X" and e["name"] == "materialize"]
    finally:
        observe.enable(None)
        observe.reset()
    for n in TRAVEL_SAMPLE:
        if not torch.equal(sample[n], values[n]):
            raise AssertionError(f"{n}: the loaded recording's value differs")
    if not span["args"].get("link_utilization"):
        raise AssertionError(f"materialize span: {span['args']}")
    return {"names_shapes_dtypes_key_nrs_equal": True,
            "bitwise_entries": list(TRAVEL_SAMPLE), "load_s": load_s,
            "link_gbps": link, "link_probe_mb": costmodel.link_probe_size_mb(),
            "link_probe_s": probe_s,
            "materialize_link_utilization": gb_per_s / link,
            "sample_span": {k: span["args"][k] for k in (
                "bytes", "gbps", "link_utilization")},
            "check_s": time.perf_counter() - start}


def travel_first_step(rec_dir: str, fakes: dict, batch, loss: float,
                      dev) -> dict:
    """The login host's 2-layer recording, loaded: its keyed values under
    seed 0 bitwise equal to this process's own recording's, every entry
    and name; bound into a fresh module on the flash kernels, one step's
    loss within ``FIRST_STEP_LOSS_RTOL`` of the measured first loss."""
    start = t0 = time.perf_counter()
    loaded = load_recording(f"{rec_dir}/train_cfg.tdx")
    load_s = time.perf_counter() - t0
    got = materialize_params_cuda(loaded, seed=0)
    want = materialize_params_cuda(fakes, seed=0, device=dev)
    if list(got) != list(want):
        raise AssertionError("the loaded recording's names differ")
    unequal = [n for n in want if not torch.equal(got[n], want[n])]
    if unequal:
        raise AssertionError(f"loaded values differ: {unequal[:4]}")
    del want
    fresh = deferred_init(make_llama, TRAIN_CFG,
                          attn_fn=make_flash_attention(), device=dev)
    bind_values(fresh, got)
    del got
    init_state, train_step, shard_batch = make_train_step(
        fresh, TRAIN_CFG, device=dev)
    reset_flash_launches()
    _, metrics = train_step(init_state(fresh), shard_batch(batch))
    travel_loss = float(metrics["loss"])
    rel = abs(travel_loss - loss) / abs(loss)
    if not (math.isfinite(travel_loss) and rel <= FIRST_STEP_LOSS_RTOL):
        raise AssertionError(f"the loaded recording's loss {travel_loss} vs "
                             f"{loss}")
    if any(flash_launches[k] != TRAIN_CFG.n_layers for k in FLASH_REPLACES):
        raise AssertionError(f"flash launches {dict(flash_launches)}")
    return {"entries_bitwise": len(loaded), "load_s": load_s,
            "loss": travel_loss, "first_loss": loss, "loss_rel": rel,
            "loss_limit": FIRST_STEP_LOSS_RTOL,
            "check_s": time.perf_counter() - start}


def first_step_materialized(rec_dir=None) -> None:
    """The training main path through the keyed materializer, as the
    first CUDA work of a fresh process: deferred_init of 2-layer
    llama3-8b width with the flash kernels -> ``materialize_module_cuda``
    -> the values bound into the module (``bind_values``) -> ``make_train_step`` -> the
    first loss on the host; then the same step on ``default_attention``
    from the same recording's values (materialized again, the same
    seed).  Prints one JSON line."""
    dev = torch.device("cuda", 0)
    batch = train_batch()
    reset_flash_launches()
    rss0 = _rss_bytes()
    with RssSampler() as rss:
        t0 = time.perf_counter()
        model = deferred_init(make_llama, TRAIN_CFG,
                              attn_fn=make_flash_attention(), device=dev)
        fakes = named_fake_tensors(model)
        bind_values(model, materialize_module_cuda(model, seed=0, device=dev))
        init_state, train_step, shard_batch = make_train_step(
            model, TRAIN_CFG, device=dev)
        state = init_state(model)
        torch.cuda.synchronize()
        bring_up = time.perf_counter() - t0
        state, metrics = train_step(state, shard_batch(batch))
        loss = float(metrics["loss"])
        seconds = time.perf_counter() - t0
    launches = {k: flash_launches[k] for k in FLASH_REPLACES}
    param_bytes = sum(p.numel() * p.element_size() for p in state["params"])
    growth = rss.peak - rss0
    if not growth < param_bytes / 4:
        raise AssertionError(f"host RSS grew {growth} bytes bringing up "
                             f"{param_bytes} bytes of parameters")
    if launches != {k: TRAIN_CFG.n_layers for k in FLASH_REPLACES}:
        raise AssertionError(f"flash launches {launches}")
    state["opt"].zero_grad(set_to_none=True)
    plain = deferred_init(make_llama, TRAIN_CFG, device=dev)
    bind_values(plain, materialize_params_cuda(fakes, seed=0, device=dev))
    p_init, p_step, p_shard = make_train_step(
        plain, TRAIN_CFG, device=dev,
        optimizer=lambda ps: torch.optim.SGD(ps, lr=0.0))
    _, p_metrics = p_step(p_init(plain), p_shard(batch))
    p_loss = float(p_metrics["loss"])
    rel = abs(loss - p_loss) / abs(p_loss)
    if not (math.isfinite(loss) and rel <= FIRST_STEP_LOSS_RTOL):
        raise AssertionError(f"first loss {loss} vs default_attention "
                             f"{p_loss}")
    travel = None
    if rec_dir:
        del state, init_state, train_step, plain, p_init, p_step, _, model
        gc.collect()
        torch.cuda.empty_cache()
        travel = travel_first_step(rec_dir, fakes, batch, loss, dev)
    emit({"phase": "first_step_materialized", "model": "llama3-8b",
          "n_layers": TRAIN_CFG.n_layers, "batch": [TRAIN_BATCH, TRAIN_SEQ],
          "dtype": "bfloat16 compute, float32 parameters",
          "materializer": "materialize_module_cuda, seed 0",
          "first_step_s": seconds, "bring_up_s": bring_up,
          "first_loss": loss, "default_attention_loss": p_loss,
          "loss_rel": rel, "loss_limit": FIRST_STEP_LOSS_RTOL,
          "flash_launches": launches, "param_bytes": param_bytes,
          "host_rss_peak_bytes": rss.peak, "host_rss_growth_bytes": growth,
          "login_host_recording": travel})


def phase_first_step_materialized(rec_dir) -> dict:
    torch.cuda.empty_cache()
    row = run_child("first_step_materialized", rec_dir)
    if rec_dir and not row["login_host_recording"]:
        raise AssertionError("the login host's recording did not travel")
    emit(row)
    return row

# ---------------------------------------------------------------------------
# phases 16 and 17: the sharded train step (tensor parallelism and FSDP2)
# ---------------------------------------------------------------------------

# One-rank meshes run the sharded path's code (TP styles, fully_shard,
# the collectives over one rank) with no other rank's arithmetic in it:
# f32 gpt2-125m there against mesh=None, the same math summed in another
# order at most (a one-rank all-gather and reduce-scatter copy).
MESH_EXACT_RTOL = 1e-6
MESH_AXES = {"fsdp": 1, "tp": 1}
SHARDED_STEPS = 5


def mesh_group_up(dev, axes=MESH_AXES):
    """A one-rank NCCL group and the ``axes`` mesh over it (``{fsdp: 1,
    tp: 1}`` by default), its communicator started with one all-reduce (a
    trainer's group is up before its model comes up)."""
    torch.cuda.set_device(dev)
    one_rank_group()
    mesh = make_mesh(axes, device_type="cuda")
    for axis in axes:
        dist.all_reduce(torch.ones(1, device=dev), group=mesh.get_group(axis))
    dist.all_reduce(torch.ones(1, device=dev))
    torch.cuda.synchronize()
    return mesh


def local_of(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor, or the tensor itself."""
    return t.to_local() if hasattr(t, "to_local") else t


def run_steps(state, train_step, batches) -> tuple:
    losses, norms = [], []
    for b in batches:
        state, metrics = train_step(state, b)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    return state, losses, norms


def phase_train_mesh_exact(dev) -> dict:
    """gpt2-125m (f32) from keyed values: 3 steps of the sharded step on
    a one-rank ``{fsdp: 1, tp: 1}`` mesh against ``mesh=None`` from the
    same values and batches."""
    cfg = MATERIALIZE_CFG
    B, S, steps = 4, cfg.max_seq_len, 3
    rng = np.random.RandomState(41)
    batches = [rng.randint(0, cfg.vocab_size, (B, S)) for _ in range(steps)]
    mesh = mesh_group_up(dev)
    try:
        runs = {}
        for name, m in (("mesh", mesh), ("unsharded", None)):
            model = deferred_init(make_gpt2, cfg, attn_fn=make_flash_attention(),
                                  device=dev)
            values = materialize_module_cuda(
                model, mesh=m, plan=decoder_lm_plan(cfg) if m else None,
                seed=0, device=dev)
            bind_values(model, values)
            del values
            init_state, train_step, shard_batch = make_train_step(
                model, cfg, device=dev, mesh=m)
            state = init_state(model)
            reset_flash_launches()
            state, losses, norms = run_steps(
                state, train_step, [shard_batch(b) for b in batches])
            launches = dict(flash_launches)
            params = {n: (p.full_tensor() if hasattr(p, "full_tensor")
                          else p).detach().clone()
                      for n, p in model.named_parameters()}
            runs[name] = {"losses": losses, "norms": norms,
                          "launches": launches, "params": params}
            del state, model
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    got, want = runs["mesh"], runs["unsharded"]
    rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731
    loss_rel = max(map(rel, got["losses"], want["losses"]))
    norm_rel = max(map(rel, got["norms"], want["norms"]))
    errs, key_bias, bitwise = {}, {}, 0
    for n, w in want["params"].items():
        g = got["params"][n]
        bitwise += torch.equal(g, w)
        if n.endswith("attn.wk.bias"):
            key_bias[n] = float((g - w).abs().max())
        else:
            errs[n] = float((g - w).norm() / w.norm())
    worst = max(errs, key=errs.get)
    step_bound = steps * 3e-4 * 1.01  # AdamW moves a weight <= lr a step
    want_launches = {k: cfg.n_layers * steps for k in FLASH_REPLACES}
    want_launches["flash_dbias"] = 0
    if not (loss_rel <= MESH_EXACT_RTOL and norm_rel <= MESH_EXACT_RTOL):
        raise AssertionError(f"losses {got['losses']} vs {want['losses']}, "
                             f"norms {got['norms']} vs {want['norms']}")
    if not errs[worst] <= MESH_EXACT_RTOL:
        raise AssertionError(f"{worst} differs by {errs[worst]} normwise")
    if not max(key_bias.values()) <= step_bound:
        raise AssertionError(f"key biases {key_bias}")
    if got["launches"] != want_launches or want["launches"] != want_launches:
        raise AssertionError(f"launches {got['launches']} {want['launches']}")
    row = {"phase": "train_mesh_exact", "model": "gpt2-125m",
           "dtype": "float32", "mesh": MESH_AXES, "plan": "decoder_lm_plan",
           "batch": [B, S], "steps": steps,
           "losses_mesh": got["losses"], "losses_unsharded": want["losses"],
           "grad_norms_mesh": got["norms"],
           "grad_norms_unsharded": want["norms"],
           "loss_rel": loss_rel, "grad_norm_rel": norm_rel,
           "param_worst": [worst, errs[worst]],
           "limit": MESH_EXACT_RTOL,
           "key_bias_max_abs": max(key_bias.values()),
           "key_bias_limit": step_bound,
           "params_bitwise": f"{bitwise} of {len(want['params'])}",
           "losses_bitwise": got["losses"] == want["losses"],
           "grad_norms_bitwise": got["norms"] == want["norms"],
           "flash_launches": got["launches"]}
    emit(row)
    return row


def timed_steps(state, train_step, batch, n: int) -> tuple:
    """``n`` steps, each timed to its end on the card."""
    step_s, losses = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, metrics = train_step(state, batch)
        losses.append(float(metrics["loss"]))
        step_s.append(time.perf_counter() - t)
    return state, losses, step_s


def step_figures(step_s, flops, peak_bytes) -> dict:
    step = float(np.median(step_s))
    return {"step_ms": step * 1e3, "step_ms_samples": [x * 1e3 for x in step_s],
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step,
            "mfu": flops / step / PEAK_FLOPS[torch.bfloat16],
            "max_memory_allocated_bytes": peak_bytes}


HYBRID_DCN, HYBRID_ICI = {"dp": 1}, {"fsdp": 1, "tp": 1}


def hybrid_leg(cfg, mesh, batch_np, first_loss: float, dev) -> dict:
    """The one-rank hybrid mesh ``{dp 1} x {fsdp 1, tp 1}``
    (``make_hybrid_mesh``, after ``initialize_multihost`` returned this
    rank with the group up): the keyed values bitwise those of the flat
    ``mesh``, and the first step's loss bitwise ``first_loss``."""
    t = time.perf_counter()
    if initialize_multihost() != dist.get_rank():
        raise AssertionError("initialize_multihost is not idempotent")
    hybrid = make_hybrid_mesh(HYBRID_DCN, HYBRID_ICI)
    model = deferred_init(make_llama, cfg, attn_fn=make_flash_attention(),
                          device=dev)
    values = materialize_module_cuda(model, mesh=hybrid,
                                     plan=decoder_lm_plan(cfg), seed=0,
                                     param_dtype=torch.bfloat16)
    flat = materialize_module_cuda(model, mesh=mesh, plan=decoder_lm_plan(cfg),
                                   seed=0, param_dtype=torch.bfloat16)
    unequal = [n for n in flat
               if not torch.equal(local_of(values[n]), local_of(flat[n]))]
    del flat
    if unequal:
        raise AssertionError(f"hybrid mesh values differ: {unequal[:4]}")
    bind_values(model, values)
    del values
    init_state, train_step, shard_batch = make_train_step(
        model, cfg, device=dev, mesh=hybrid)
    state = init_state(model)
    state, metrics = train_step(state, shard_batch(batch_np))
    loss = float(metrics["loss"])
    del state, model, metrics
    torch.cuda.empty_cache()
    if loss != first_loss:
        raise AssertionError(f"hybrid mesh first loss {loss} != {first_loss}")
    return {"dcn": HYBRID_DCN, "ici": HYBRID_ICI,
            "mesh_dims": list(hybrid.mesh_dim_names),
            "values_bitwise_flat_mesh": True, "first_loss": loss,
            "first_loss_bitwise_flat_mesh": True,
            "seconds": time.perf_counter() - t}


def first_step_sharded() -> None:
    """The sharded training main path as the first model work of a fresh
    process (after its CUDA context and its one-rank NCCL group):
    deferred_init of 2-layer llama3-8b width with the flash kernels ->
    ``materialize_module_cuda`` on the ``{fsdp: 1, tp: 1}`` mesh under
    ``decoder_lm_plan``, bf16 parameters -> ``bind_values`` ->
    ``make_train_step(mesh=)`` -> the first loss on the host, then 4
    more steps on the same batch, the last two with telemetry on (the
    first of them counts the step's FLOPs), and one profiled step; then
    ``mesh=None`` from the same values, 5 steps and one profiled.  Prints
    one JSON line."""
    from torchdistx_tpu_torch import observe

    dev = torch.device("cuda", 0)
    ctx = cuda_context(dev)
    # One process: the multi-host bootstrap starts nothing (the launcher's
    # WORLD_SIZE is unset), and returns this rank.
    if initialize_multihost() != 0:
        raise AssertionError("initialize_multihost on one process")
    mesh = mesh_group_up(dev)
    cfg = TRAIN_CFG
    batch_np = train_batch()
    try:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        rss0 = _rss_bytes()
        reset_flash_launches()
        with RssSampler() as rss:
            t0 = time.perf_counter()
            model = deferred_init(make_llama, cfg,
                                  attn_fn=make_flash_attention(), device=dev)
            fakes = named_fake_tensors(model)
            values = materialize_module_cuda(
                model, mesh=mesh, plan=decoder_lm_plan(cfg), seed=0,
                param_dtype=torch.bfloat16)
            bind_values(model, values)
            del values
            # Telemetry on while the step is built wraps it; off, each
            # call runs the raw step until it is turned on again.
            observe.enable(True)
            init_state, train_step, shard_batch = make_train_step(
                model, cfg, device=dev, mesh=mesh)
            observe.enable(False)
            state = init_state(model)
            torch.cuda.synchronize()
            bring_up = time.perf_counter() - t0
            bring_up_peak = torch.cuda.max_memory_allocated() - base
            bring_up_rss = max(rss.peak, _rss_bytes()) - rss0
            batch = shard_batch(batch_np)
            state, metrics = train_step(state, batch)
            first_loss = float(metrics["loss"])
            seconds = time.perf_counter() - t0
        growth = rss.peak - rss0
        params = state["params"]
        nbytes = sum(local_of(p).numel() * p.element_size() for p in params)
        largest = max(f.numel() * f.element_size() for f in fakes.values())
        torch.cuda.reset_peak_memory_stats()
        state, losses, step_s = timed_steps(state, train_step, batch, 2)
        peak = torch.cuda.max_memory_allocated()
        observe.reset()
        observe.enable(True)
        state, tele_losses, tele_s = timed_steps(state, train_step, batch, 2)
        observe.enable(False)
        spans = [e for e in observe.tracer().drain()
                 if e["ph"] == "X" and e["name"] == "train.step"]
        gauges = {r["name"]: r["value"] for r in observe.counters().snapshot()}
        launches = dict(flash_launches)
        profile = profile_step("llama3-8b sharded",
                               lambda: train_step(state, batch))
        flops = train_step_flops(model, cfg, TRAIN_BATCH, TRAIN_SEQ)
        counted = spans[0]["args"].get("flops_counted") if spans else None
        del state, model, params, metrics
        torch.cuda.empty_cache()
        # mesh=None from the same values (materialized again, same seed).
        torch.cuda.reset_peak_memory_stats()
        plain = deferred_init(make_llama, cfg, attn_fn=make_flash_attention(),
                              device=dev)
        bind_values(plain, materialize_params_cuda(
            named_fake_tensors(plain), seed=0, param_dtype=torch.bfloat16,
            device=dev))
        p_init, p_step, p_shard = make_train_step(plain, cfg, device=dev)
        p_state = p_init(plain)
        p_batch = p_shard(batch_np)
        p_state, p_losses, p_step_s = timed_steps(p_state, p_step, p_batch,
                                                  SHARDED_STEPS)
        p_peak = torch.cuda.max_memory_allocated()
        p_profile = profile_step("llama3-8b unsharded",
                                 lambda: p_step(p_state, p_batch))
        del p_state, plain
        torch.cuda.empty_cache()
        hybrid = hybrid_leg(cfg, mesh, batch_np, first_loss, dev)
    finally:
        dist.destroy_process_group()
    all_losses = [first_loss] + losses + tele_losses
    loss_rel = abs(first_loss - p_losses[0]) / abs(p_losses[0])
    want = {k: cfg.n_layers * SHARDED_STEPS for k in FLASH_REPLACES}
    want["flash_dbias"] = 0
    bound = nbytes + 2 * largest
    failed = []  # checked after the row is out, so one run shows every figure
    if not all(math.isfinite(x) for x in all_losses + p_losses):
        failed.append(f"non-finite losses {all_losses} {p_losses}")
    if not loss_rel <= FIRST_STEP_LOSS_RTOL:
        failed.append(f"first loss {first_loss} vs mesh=None {p_losses[0]}")
    if not growth < nbytes / 4:
        failed.append(f"host RSS grew {growth} bytes for {nbytes}")
    if not bring_up_peak <= bound:
        failed.append(f"device memory grew {bring_up_peak} bytes over "
                      f"bring-up, bound {bound}")
    if launches != want:
        failed.append(f"flash launches {launches} != {want}")
    if len(spans) != 2 or "tdx.train.mfu" not in gauges or not counted:
        failed.append(f"telemetry: {len(spans)} spans, gauges {sorted(gauges)}")
    elif not abs(counted - flops) <= 0.01 * flops:
        failed.append(f"counted FLOPs {counted} vs {flops}")
    emit({"phase": "first_step_sharded", "model": "llama3-8b",
          "n_layers": cfg.n_layers, "batch": [TRAIN_BATCH, TRAIN_SEQ],
          "dtype": "bfloat16 compute, bfloat16 parameters (recorded f32)",
          "mesh": MESH_AXES, "plan": "decoder_lm_plan", **ctx,
          "first_step_s": seconds, "bring_up_s": bring_up,
          "first_loss": first_loss, "losses": all_losses,
          "unsharded_losses": p_losses, "loss_rel": loss_rel,
          "loss_limit": FIRST_STEP_LOSS_RTOL, "param_bytes": nbytes,
          "host_rss_peak_bytes": rss.peak, "host_rss_growth_bytes": growth,
          "host_rss_limit_bytes": nbytes / 4,
          "host_rss_growth_bytes_bring_up": bring_up_rss,
          "bring_up_device_growth_bytes": bring_up_peak,
          "device_limit_bytes": bound, "largest_entry_bytes": largest,
          "flash_launches": launches, "flops_per_step": flops,
          "sharded": step_figures(step_s, flops, peak),
          "unsharded": step_figures(p_step_s[1:], flops, p_peak),
          "profile_sharded": profile, "profile_unsharded": p_profile,
          "hybrid_mesh": hybrid,
          "telemetry": {
              "train_step_spans": [
                  {k: v for k, v in sp["args"].items()
                   if k in ("step", "tokens_per_s", "tflops", "mfu",
                            "mfu_est", "flops_counted")}
                  | {"dur_ms": sp["dur"] / 1e3} for sp in spans],
              "tdx.train.mfu": gauges.get("tdx.train.mfu"),
              "tdx.train.tokens_per_s": gauges.get("tdx.train.tokens_per_s"),
              "tdx.cuda.hbm_high_water_bytes":
                  gauges.get("tdx.cuda.hbm_high_water_bytes"),
              "counted_flops": counted,
              "counted_over_train_step_flops": counted / flops if counted
              else None,
              "step_ms": [x * 1e3 for x in tele_s]},
          "failed": failed})
    if failed:
        raise AssertionError("; ".join(failed))


def phase_first_step_sharded() -> dict:
    torch.cuda.empty_cache()
    row = run_child("first_step_sharded")
    emit(row)
    return row


# ---------------------------------------------------------------------------
# phases 18 to 23: Mixtral's mixture of experts, full rematerialization and
# ViT
# ---------------------------------------------------------------------------

# Mixtral 8x7B width (d 4096, 32 heads over 8 kv heads of 128, d_ff 14336,
# 8 experts, top 2, rope theta 1e6, vocab 32000), depth cut to 2 layers,
# bf16 compute on f32 parameters (3.165 B: 50.6 GB with gradients and
# AdamW's moments, which fits beside the activations), a [2, 2048] batch.
MIXTRAL_CFG = PRESETS["mixtral-8x7b"].replace(n_layers=2)
MIXTRAL_BATCH, MIXTRAL_SEQ = 2, 2048
MIXTRAL_STEPS = 5
MIXTRAL_MESH = {"ep": 1, "fsdp": 1, "tp": 1}


def mixtral_batch() -> np.ndarray:
    return np.random.RandomState(51).randint(
        0, MIXTRAL_CFG.vocab_size, (MIXTRAL_BATCH, MIXTRAL_SEQ))


def dropped_share(model) -> float:
    """The share of the last forward's (token, choice) pairs that found no
    slot in their expert's buffer, over every MoE layer."""
    kept = [m.kept for m in model.modules() if isinstance(m, MoEMLP)]
    return float(sum((~k).sum() for k in kept)) / sum(k.numel() for k in kept)


def moe_matmuls(cfg, n_tokens: int):
    """A profile classifier: the device ms of the MoE layers' matrix
    products, by the shapes of the aten matmul that launched each kernel
    (T tokens, E experts, C rows each, top k): the dispatch and combine
    einsums (an operand with an E·C dim and a T dim), the expert GEMMs
    (E-batched products) and the products that build the one-hot
    dispatch and combine tensors (T-batched over k)."""
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    T, C = n_tokens, moe_capacity(cfg.moe, n_tokens)

    def kind(shapes):
        dims = {d for s in shapes for d in s}
        if E * C in dims and T in dims:
            return "dispatch_combine"
        if any(len(s) == 3 and s[0] == E for s in shapes):
            return "expert_gemm"
        if any(len(s) == 3 and s[0] == T and k in s[1:] for s in shapes):
            return "onehot"
        return None

    def classify(prof) -> dict:
        ms, launches = {}, {}
        for evt in prof.events():
            if evt.name not in ("aten::mm", "aten::bmm", "aten::addmm",
                                "aten::baddbmm") or not evt.kernels:
                continue
            what = kind([tuple(s) for s in evt.input_shapes or () if s])
            if what:
                ms[what] = ms.get(what, 0.0) + sum(
                    kn.duration for kn in evt.kernels) / 1e3
                launches[what] = launches.get(what, 0) + len(evt.kernels)
        return {"device_ms": ms, "kernel_launches": launches,
                "T": T, "E": E, "C": C, "k": k}

    return classify


def attention_modules(model) -> list:
    return [m for m in model.modules() if isinstance(m, Attention)]


def same_model_vs_plain(model, params, loss_fn, flash_step) -> dict:
    """One step of a main path (``flash_step()``: the flash kernels, an
    update, ``(loss, grad_norm)``) against the loss and gradients of the
    same module with ``default_attention`` in its attention modules, on
    the same weights and batch (``loss_fn(model)``; a batch the main path
    has not trained on, as ``compare_plain_bf16`` takes: on a memorized
    batch the gradients shrink and bf16's relative error grows).  The
    plain gradients wait on the host, so the card never holds two sets."""
    names = [n for n, _ in model.named_parameters()]
    attns = attention_modules(model)
    flash_fn = attns[0].attn_fn
    for p in params:
        p.grad = None
    for a in attns:
        a.attn_fn = default_attention
    try:
        loss = loss_fn(model)
        loss.backward()
    finally:
        for a in attns:
            a.attn_fn = flash_fn
    p_loss = loss.item()
    p_gn = float(torch.nn.utils.get_total_norm([p.grad for p in params]))
    p_grads = [p.grad.to("cpu") for p in params]
    del loss
    for p in params:
        p.grad = None
    f_loss, f_gn = flash_step()
    return vs_plain(names, (f_loss, p_loss), (f_gn, p_gn),
                    [p.grad for p in params], p_grads)


def phase_mixtral_train_bf16(dev) -> dict:
    """2-layer Mixtral 8x7B width on the flash kernels, bf16 compute:
    deferred_init -> materialize on the card -> ``make_train_step``, 5
    steps on one batch (losses finite and falling, 1 launch of each flash
    kernel per layer and step), step ms, tokens/s, MFU by
    ``train_step_flops``, peak device memory, the router loss and the
    share of (token, choice) pairs dropped at capacity; one step against
    the same module on ``default_attention`` on a fresh batch; one
    profiled step with the MoE matmuls apart."""
    cfg = MIXTRAL_CFG
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = deferred_init(make_mixtral, cfg, attn_fn=make_flash_attention(),
                          device=dev)
    torch.manual_seed(0)
    materialize_module(model, device=dev)
    init_state, train_step, shard_batch = make_train_step(model, cfg,
                                                          device=dev)
    state = init_state(model)
    torch.cuda.synchronize()
    bring_up = time.perf_counter() - t0
    batch = shard_batch(mixtral_batch())
    reset_flash_launches()
    losses, step_s, auxes, drops = [], [], [], []
    for _ in range(MIXTRAL_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, metrics = train_step(state, batch)
        losses.append(float(metrics["loss"]))
        step_s.append(time.perf_counter() - t)
        auxes.append(float(metrics["aux"]))
        drops.append(dropped_share(model))
    launches = dict(flash_launches)
    peak = torch.cuda.max_memory_allocated()
    want = {k: cfg.n_layers * MIXTRAL_STEPS for k in FLASH_REPLACES}
    want["flash_dbias"] = 0
    if not all(math.isfinite(x) for x in losses + auxes):
        raise AssertionError(f"non-finite losses {losses} or aux {auxes}")
    if not all(x < losses[0] for x in losses[1:]):
        raise AssertionError(f"losses do not fall: {losses}")
    if launches != want:
        raise AssertionError(f"flash launches {launches} != {want}")
    params = state["params"]
    fresh = shard_batch(np.random.RandomState(52).randint(
        0, cfg.vocab_size, (MIXTRAL_BATCH, MIXTRAL_SEQ)))

    def flash_step():
        _, metrics = train_step(state, fresh)
        return float(metrics["loss"]), float(metrics["grad_norm"])

    vs = same_model_vs_plain(
        model, params,
        lambda m: lm_cross_entropy(m(fresh), fresh) + router_aux_loss(m),
        flash_step)
    step = float(np.median(step_s[1:]))
    ntok = MIXTRAL_BATCH * MIXTRAL_SEQ
    flops = train_step_flops(model, cfg, MIXTRAL_BATCH, MIXTRAL_SEQ)
    profile = profile_step("mixtral-8x7b", lambda: train_step(state, batch),
                           classify=moe_matmuls(cfg, ntok))
    row = {"phase": "mixtral_train_bf16", "model": "mixtral-8x7b",
           "n_layers": cfg.n_layers, "dtype": "bfloat16 compute, float32 "
           "parameters", "batch": [MIXTRAL_BATCH, MIXTRAL_SEQ],
           "n_params": sum(p.numel() for p in params),
           "param_bytes": sum(p.numel() * p.element_size() for p in params),
           "bring_up_s": bring_up, "losses": losses, "aux": auxes,
           "dropped_share": drops,
           "capacity": moe_capacity(cfg.moe, ntok),
           "step_ms": step * 1e3, "step_ms_samples": [x * 1e3 for x in step_s],
           "tokens_per_s": ntok / step, "flops_per_step": flops,
           "flops_formula": "train_step_flops: 6 x matmul weights x tokens + "
                            "causal attention + per MoE layer 18 E d ff C + "
                            "10 T E C d + 6 T E C k",
           "mfu": flops / step / PEAK_FLOPS[torch.bfloat16],
           "max_memory_allocated_bytes": peak, "flash_launches": launches,
           "vs_default_attention": vs}
    emit(row)
    emit(profile)
    row["profile"] = profile
    del state, model, params
    torch.cuda.empty_cache()
    return row


def phase_mixtral_materialize_invariance(dev) -> dict:
    """2-layer Mixtral width recorded in f32 through
    ``materialize_module_cuda``: each of the 8 coordinates of
    ``VirtualMesh({ep: 2, fsdp: 2, tp: 2})`` under ``decoder_lm_plan``,
    materialized on its own, equal to its slice of the unsharded values
    bit for bit, the slices covering every element; a one-rank NCCL
    ``{ep: 1, fsdp: 1, tp: 1}`` mesh equal to ``mesh=None``."""
    cfg = MIXTRAL_CFG
    model = deferred_init(make_mixtral, cfg, device=dev)
    t = time.perf_counter()
    full = materialize_module_cuda(model, seed=0, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    axes = {"ep": 2, "fsdp": 2, "tp": 2}
    plan = decoder_lm_plan(cfg)
    shape = VirtualMesh(axes, {a: 0 for a in axes}).shape
    specs = {n: plan.spec_for(n, tuple(v.shape), shape) for n, v in full.items()}
    covered = {n: torch.zeros(v.shape, dtype=torch.uint8, device=dev)
               for n, v in full.items()}
    local_bytes, coord_s = [], []
    for coord in itertools.product(*(range(k) for k in shape.values())):
        where = dict(zip(shape, coord))
        t = time.perf_counter()
        local = materialize_module_cuda(model, mesh=VirtualMesh(axes, where),
                                        plan=plan, seed=0, device=dev)
        torch.cuda.synchronize()
        coord_s.append(time.perf_counter() - t)
        local_bytes.append(sum(v.numel() * v.element_size()
                               for v in local.values()))
        for n, v in local.items():
            region = shard_region(full[n].shape, specs[n], shape, where)
            if not torch.equal(v, full[n][region]):
                raise AssertionError(f"{where} {n}: the shard is not its slice")
            covered[n][region] += 1
        del local
    if any(not bool((k > 0).all()) for k in covered.values()):
        raise AssertionError("the shards miss elements")
    del covered
    expert_specs = {n: spec_str(s) for n, s in specs.items()
                    if n.startswith("blocks.0.moe.")}
    one_rank_group()
    try:
        mesh = make_mesh(MIXTRAL_MESH, device_type="cuda")
        on_mesh = materialize_module_cuda(model, mesh=mesh, plan=plan, seed=0)
        for n, v in on_mesh.items():
            spec = plan.spec_for(n, tuple(full[n].shape), mesh)
            if tuple(v.placements) != placements_for(spec, mesh):
                raise AssertionError(f"{n}: placements {v.placements}")
            if not torch.equal(v.to_local(), full[n]):
                raise AssertionError(f"{n}: the one-rank mesh differs")
        del on_mesh
    finally:
        dist.destroy_process_group()
    nbytes = sum(v.numel() * v.element_size() for v in full.values())
    row = {"phase": "mixtral_materialize_invariance", "model": "mixtral-8x7b",
           "n_layers": cfg.n_layers, "dtype": "float32",
           "entries": len(full), "param_bytes": nbytes,
           "materialize_s_unsharded": seconds,
           "materialize_s_per_coordinate": coord_s,
           "virtual_mesh": axes, "plan": "decoder_lm_plan",
           "coordinates": len(coord_s), "local_bytes_max": max(local_bytes),
           "expert_specs_layer_0": expert_specs,
           "shards_bitwise_equal_slices": True, "shards_cover": True,
           "one_rank_nccl_mesh": MIXTRAL_MESH,
           "one_rank_nccl_mesh_equals_unsharded": True}
    emit(row)
    del full
    torch.cuda.empty_cache()
    return row


def mixtral_8x7b_expert_shard() -> None:
    """Full-depth Mixtral 8x7B (46.70 B parameters, 93.4 GB in bf16: more
    than the card holds) recorded as fakes, and coordinate ep = 0 of
    ``VirtualMesh({ep: 8})`` materialized on the card under
    ``decoder_lm_plan`` in bf16, as the first model work of a fresh
    process after its CUDA context: one expert of 8 per layer, the rest
    replicated.  Seconds for recording and replay, bytes, GB/s, host RSS
    growth (below a quarter of the local bytes) and the growth of
    ``max_memory_allocated`` (at most the local bytes plus twice the
    largest entry at its recorded dtype); prints one JSON line."""
    dev = torch.device("cuda", 0)
    ctx = cuda_context(dev)
    cfg = PRESETS["mixtral-8x7b"]
    axes, where = {"ep": 8}, {"ep": 0}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rss0 = _rss_bytes()
    with RssSampler() as rss:
        t0 = time.perf_counter()
        model = deferred_init(make_mixtral, cfg, device=dev)
        recorded = time.perf_counter() - t0
        keyed_rng.launches = 0
        values = materialize_module_cuda(
            model, mesh=VirtualMesh(axes, where), plan=decoder_lm_plan(cfg),
            seed=0, param_dtype=torch.bfloat16, device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    keyed_launches = keyed_rng.launches
    engine = cuda_mat.last_run_stats()
    peak = torch.cuda.max_memory_allocated() - base
    fakes = named_fake_tensors(model)
    n_full = sum(f.numel() for f in fakes.values())
    largest = max(f.numel() * f.element_size() for f in fakes.values())
    largest_local = max(v.numel() * fakes[n].element_size()
                        for n, v in values.items())
    nbytes = sum(v.numel() * v.element_size() for v in values.values())
    growth = rss.peak - rss0
    if not growth < nbytes / 4:
        raise AssertionError(f"host RSS grew {growth} bytes materializing "
                             f"{nbytes} bytes")
    if not peak <= nbytes + 2 * largest:
        raise AssertionError(f"device memory grew {peak} bytes for {nbytes} "
                             f"bytes, largest entry {largest}")
    # Shard-local replay: nothing beyond the local bytes and two of the
    # largest local shard at its recorded dtype.
    if not peak <= nbytes + 2 * largest_local:
        raise AssertionError(f"device memory grew {peak} bytes for {nbytes} "
                             f"bytes, largest local shard {largest_local}")
    if engine["local_entries"] != len(values):
        raise AssertionError(f"shard-local entries: {engine}")
    for n, v in values.items():
        f = fakes[n]
        want = list(f.shape)
        if ".moe.w_" in n:
            want[0] //= axes["ep"]
        if v.dtype != torch.bfloat16 or list(v.shape) != want:
            raise AssertionError(f"{n}: {v.dtype} {tuple(v.shape)}")
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{n} is not finite")
    emit({"phase": "mixtral_8x7b_expert_shard", "model": "mixtral-8x7b",
          "n_layers": cfg.n_layers, "dtype": "recorded float32, bfloat16 "
          "parameters", "virtual_mesh": axes, "coordinate": where,
          "plan": "decoder_lm_plan", **ctx, "n_params_full": n_full,
          "bytes_full_bf16": 2 * n_full, "entries": len(values),
          "n_params_local": sum(v.numel() for v in values.values()),
          "bytes": nbytes, "record_s": recorded, "materialize_s": seconds,
          "replay_s": seconds - recorded,
          "gb_per_s": nbytes / seconds / 1e9,
          "gb_per_s_replay": nbytes / (seconds - recorded) / 1e9,
          "host_rss_peak_bytes": rss.peak, "host_rss_growth_bytes": growth,
          "host_rss_limit_bytes": nbytes / 4,
          "max_memory_allocated_growth_bytes": peak,
          "device_limit_bytes": nbytes + 2 * largest,
          "largest_entry_bytes": largest,
          "device_limit_bytes_shard_local": nbytes + 2 * largest_local,
          "largest_local_shard_bytes": largest_local,
          "keyed_rng_launches": keyed_launches, "engine": engine})


def phase_mixtral_8x7b_expert_shard() -> dict:
    torch.cuda.empty_cache()
    row = run_child("mixtral_8x7b_expert_shard")
    emit(row)
    return row


def mixtral_first_step_sharded() -> None:
    """The sharded flow for Mixtral in a fresh process (after its CUDA
    context and its one-rank NCCL group): deferred_init of 2-layer
    Mixtral width with the flash kernels -> ``materialize_module_cuda``
    on the ``{ep: 1, fsdp: 1, tp: 1}`` mesh under ``decoder_lm_plan``,
    bf16 parameters -> ``bind_values`` -> ``make_train_step(mesh=)`` ->
    the first loss, then 2 steps with telemetry on (the first counts the
    step's FLOPs); then ``mesh=None`` from the same values, its first
    loss.  Prints one JSON line."""
    from torchdistx_tpu_torch import observe

    dev = torch.device("cuda", 0)
    ctx = cuda_context(dev)
    mesh = mesh_group_up(dev, MIXTRAL_MESH)
    cfg = MIXTRAL_CFG
    batch_np = mixtral_batch()
    try:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        rss0 = _rss_bytes()
        reset_flash_launches()
        with RssSampler() as rss:
            t0 = time.perf_counter()
            model = deferred_init(make_mixtral, cfg,
                                  attn_fn=make_flash_attention(), device=dev)
            fakes = named_fake_tensors(model)
            values = materialize_module_cuda(
                model, mesh=mesh, plan=decoder_lm_plan(cfg), seed=0,
                param_dtype=torch.bfloat16)
            bind_values(model, values)
            del values
            observe.enable(True)
            init_state, train_step, shard_batch = make_train_step(
                model, cfg, device=dev, mesh=mesh)
            observe.enable(False)
            state = init_state(model)
            torch.cuda.synchronize()
            bring_up = time.perf_counter() - t0
            bring_up_peak = torch.cuda.max_memory_allocated() - base
            batch = shard_batch(batch_np)
            state, metrics = train_step(state, batch)
            first_loss = float(metrics["loss"])
            first_aux = float(metrics["aux"])
            seconds = time.perf_counter() - t0
        growth = rss.peak - rss0
        nbytes = sum(local_of(p).numel() * p.element_size()
                     for p in state["params"])
        largest = max(f.numel() * f.element_size() for f in fakes.values())
        observe.reset()
        observe.enable(True)
        state, tele_losses, tele_s = timed_steps(state, train_step, batch, 2)
        observe.enable(False)
        spans = [e for e in observe.tracer().drain()
                 if e["ph"] == "X" and e["name"] == "train.step"]
        launches = dict(flash_launches)
        flops = train_step_flops(model, cfg, MIXTRAL_BATCH, MIXTRAL_SEQ)
        counted = spans[0]["args"].get("flops_counted") if spans else None
        del state, model, metrics
        torch.cuda.empty_cache()
        plain = deferred_init(make_mixtral, cfg, attn_fn=make_flash_attention(),
                              device=dev)
        bind_values(plain, materialize_params_cuda(
            named_fake_tensors(plain), seed=0, param_dtype=torch.bfloat16,
            device=dev))
        p_init, p_step, p_shard = make_train_step(plain, cfg, device=dev)
        p_state, p_metrics = p_step(p_init(plain), p_shard(batch_np))
        p_loss, p_aux = float(p_metrics["loss"]), float(p_metrics["aux"])
        del p_state, plain
    finally:
        dist.destroy_process_group()
    loss_rel = abs(first_loss - p_loss) / abs(p_loss)
    want = {k: cfg.n_layers * 3 for k in FLASH_REPLACES}
    want["flash_dbias"] = 0
    bound = nbytes + 2 * largest
    failed = []
    if not all(math.isfinite(x) for x in [first_loss, p_loss] + tele_losses):
        failed.append(f"non-finite losses {first_loss} {tele_losses} {p_loss}")
    if not loss_rel <= FIRST_STEP_LOSS_RTOL:
        failed.append(f"first loss {first_loss} vs mesh=None {p_loss}")
    if not growth < nbytes / 4:
        failed.append(f"host RSS grew {growth} bytes for {nbytes}")
    if not bring_up_peak <= bound:
        failed.append(f"device memory grew {bring_up_peak} bytes over "
                      f"bring-up, bound {bound}")
    if launches != want:
        failed.append(f"flash launches {launches} != {want}")
    if len(spans) != 2 or not counted:
        failed.append(f"telemetry: {len(spans)} spans, counted {counted}")
    elif not abs(counted - flops) <= 0.01 * flops:
        failed.append(f"counted FLOPs {counted} vs {flops}")
    emit({"phase": "mixtral_first_step_sharded", "model": "mixtral-8x7b",
          "n_layers": cfg.n_layers, "batch": [MIXTRAL_BATCH, MIXTRAL_SEQ],
          "dtype": "bfloat16 compute, bfloat16 parameters (recorded f32)",
          "mesh": MIXTRAL_MESH, "plan": "decoder_lm_plan", **ctx,
          "first_step_s": seconds, "bring_up_s": bring_up,
          "first_loss": first_loss, "first_aux": first_aux,
          "losses": [first_loss] + tele_losses,
          "unsharded_first_loss": p_loss, "unsharded_first_aux": p_aux,
          "loss_rel": loss_rel, "loss_limit": FIRST_STEP_LOSS_RTOL,
          "param_bytes": nbytes, "host_rss_growth_bytes": growth,
          "host_rss_limit_bytes": nbytes / 4,
          "bring_up_device_growth_bytes": bring_up_peak,
          "device_limit_bytes": bound, "largest_entry_bytes": largest,
          "flash_launches": launches, "flops_per_step": flops,
          "counted_flops": counted,
          "counted_over_train_step_flops": counted / flops if counted
          else None,
          "step_ms_telemetry": [x * 1e3 for x in tele_s],
          "failed": failed})
    if failed:
        raise AssertionError("; ".join(failed))


def phase_mixtral_first_step_sharded() -> dict:
    torch.cuda.empty_cache()
    row = run_child("mixtral_first_step_sharded")
    emit(row)
    return row


# 2-layer llama3-70b width (d 8192, 64 heads over 8 kv heads of 128, d_ff
# 28672, vocab 128256), remat "full" from the preset, bf16 parameters,
# one 8192-token sequence.
REMAT_CFG = PRESETS["llama3-70b"].replace(n_layers=2)
REMAT_BATCH, REMAT_SEQ = 1, 8192
# The same step with and without rematerialization: the recompute runs
# the same kernels on the same inputs, so the two agree to rounding at
# most (in practice bit for bit).
REMAT_RTOL = 1e-6
REMAT_STEPS = 3


def phase_remat_70b(dev) -> dict:
    """One step of 2-layer llama3-70b width with ``remat="none"`` and one
    with ``"full"`` from the same keyed values (bf16 parameters, [1,
    8192], flash kernels): losses and gradient norms within 1e-6
    relative, leaves bitwise equal counted, the flash forward launched
    twice per layer and step under ``"full"``; then 2 more steps each,
    timed, with the peak device memory of a step that holds AdamW's
    moments — lower under ``"full"`` — and one profiled step each."""
    if REMAT_CFG.remat != "full":
        raise AssertionError(f"llama3-70b's preset has remat "
                             f"{REMAT_CFG.remat!r}, not 'full'")
    batch_np = np.random.RandomState(61).randint(
        0, REMAT_CFG.vocab_size, (REMAT_BATCH, REMAT_SEQ))
    runs, grads_none = {}, None
    bitwise = worst = n_leaves = None
    for remat in ("none", "full"):
        cfg = REMAT_CFG.replace(remat=remat)
        torch.cuda.empty_cache()
        model = deferred_init(make_llama, cfg, attn_fn=make_flash_attention(),
                              device=dev)
        bind_values(model, materialize_module_cuda(
            model, seed=0, param_dtype=torch.bfloat16, device=dev))
        init_state, train_step, shard_batch = make_train_step(model, cfg,
                                                              device=dev)
        state = init_state(model)
        batch = shard_batch(batch_np)
        reset_flash_launches()
        torch.cuda.reset_peak_memory_stats()
        state, losses, step_s = timed_steps(state, train_step, batch, 1)
        first_peak = torch.cuda.max_memory_allocated()
        launches = dict(flash_launches)
        grads = [p.grad for p in state["params"]]
        grad_norm = float(torch.nn.utils.get_total_norm(grads))
        if remat == "none":
            grads_none = [g.to("cpu") for g in grads]
        else:
            bitwise = sum(torch.equal(a, b.to(dev))
                          for a, b in zip(grads, grads_none))
            worst = max(leaf_errors(range(len(grads)), grads,
                                    grads_none).values())
        n_leaves = len(grads)
        del grads
        torch.cuda.reset_peak_memory_stats()
        state, more, more_s = timed_steps(state, train_step, batch,
                                          REMAT_STEPS - 1)
        runs[remat] = {"losses": losses + more, "grad_norm": grad_norm,
                       "step_ms": [x * 1e3 for x in step_s + more_s],
                       "first_step_peak_bytes": first_peak,
                       "peak_bytes": torch.cuda.max_memory_allocated(),
                       "flash_launches_first_step": launches}
        emit(profile_step(f"llama3-70b remat {remat}",
                          lambda: train_step(state, batch)))
        del state, model
    torch.cuda.empty_cache()
    none, full = runs["none"], runs["full"]
    L = REMAT_CFG.n_layers
    rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731
    loss_rel = rel(full["losses"][0], none["losses"][0])
    gn_rel = rel(full["grad_norm"], none["grad_norm"])
    want = {"none": {"flash_fwd": L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
                     "flash_dbias": 0},
            "full": {"flash_fwd": 2 * L, "flash_bwd_dq": L,
                     "flash_bwd_dkv": L, "flash_dbias": 0}}
    failed = []
    if not all(math.isfinite(x) for r in runs.values() for x in r["losses"]):
        failed.append("non-finite losses")
    if not (loss_rel <= REMAT_RTOL and gn_rel <= REMAT_RTOL):
        failed.append(f"loss {loss_rel} / grad norm {gn_rel} apart")
    for r in runs:
        if runs[r]["flash_launches_first_step"] != want[r]:
            failed.append(f"{r}: launches {runs[r]['flash_launches_first_step']}"
                          f" != {want[r]}")
    if not full["peak_bytes"] < none["peak_bytes"]:
        failed.append(f"peak {full['peak_bytes']} not below "
                      f"{none['peak_bytes']}")
    row = {"phase": "remat_70b", "model": "llama3-70b", "n_layers": L,
           "batch": [REMAT_BATCH, REMAT_SEQ],
           "dtype": "bfloat16 compute, bfloat16 parameters (recorded f32)",
           "preset_remat": REMAT_CFG.remat, "none": none, "full": full,
           "loss_rel": loss_rel, "grad_norm_rel": gn_rel, "limit": REMAT_RTOL,
           "grad_leaves_bitwise": f"{bitwise} of {n_leaves}",
           "grad_worst_leaf_rel": worst,
           "peak_saved_bytes": none["peak_bytes"] - full["peak_bytes"],
           "step_ms_ratio_full_over_none":
               float(np.median(full["step_ms"][1:]))
               / float(np.median(none["step_ms"][1:])),
           "flops_per_step": train_step_flops(
               make_llama(REMAT_CFG, device="meta"), REMAT_CFG, REMAT_BATCH,
               REMAT_SEQ),
           "failed": failed}
    emit(row)
    if failed:
        raise AssertionError("; ".join(failed))
    return row


VIT_B16_F32 = PRESETS["vit-b16"].replace(
    encoder=PRESETS["vit-b16"].encoder.replace(dtype=torch.float32))
VIT_L16 = PRESETS["vit-l16"]
VIT_B16_BATCH, VIT_L16_BATCH, VIT_STEPS = 8, 32, 5


def vit_data(cfg, B: int, seed: int, dev):
    rng = np.random.RandomState(seed)
    images = torch.from_numpy(rng.randn(B, cfg.image_size, cfg.image_size,
                                        cfg.channels).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, cfg.n_classes, B))
    return images.to(dev), labels.to(dev)


def vit_step_fn(model, opt, images, labels):
    """A label cross-entropy step (the JAX package has no ViT trainer; its
    test writes its own step): ``step() -> (loss, grad_norm)`` as device
    tensors."""
    params = list(model.parameters())

    def step():
        opt.zero_grad(set_to_none=True)
        loss = F.cross_entropy(model(images), labels)
        loss.backward()
        grad_norm = torch.nn.utils.get_total_norm([p.grad for p in params])
        opt.step()
        return loss.detach(), grad_norm

    return step


def vit_step_flops(cfg, B: int) -> float:
    """Model FLOPs of one label cross-entropy step of ``cfg`` on B images:
    6 per block weight per token, the patch conv's 4 per weight per patch
    (no input gradient), the head's 6 per weight per image, and
    non-causal attention's 12·L·B·H·S²·D."""
    enc = cfg.encoder
    S, d = cfg.seq_len, enc.d_model
    blocks = enc.n_layers * (4 * d * enc.n_heads * enc.head_size
                             + 2 * d * enc.d_ff)
    conv = cfg.patch_size ** 2 * cfg.channels * d
    return (6.0 * blocks * B * S + 4.0 * conv * B * cfg.n_patches
            + 6.0 * d * cfg.n_classes * B
            + 12.0 * enc.n_layers * B * enc.n_heads * S * S * enc.head_size)


def key_bias(name: str) -> bool:
    return name.endswith("attn.wk.bias")


def phase_vit_train(dev) -> dict:
    """ViT on the flash kernels (non-causal, D 64, S 197): vit-b16 in f32,
    one label cross-entropy step against the same module on
    ``default_attention`` — logits within 1e-4, each gradient leaf within
    1e-4 normwise (the key biases, zero in exact arithmetic, below 1e-5
    of the key weights' gradient); then vit-l16 at full depth, bf16
    compute, B 32 at 224 x 224: at the materialized weights, the
    gradients on a fresh batch against ``default_attention``'s under the
    bf16 limits of ``train_bf16_full`` (the key biases below 5e-2 of the
    key weights'), both beside the same step in f32 compute; then 5
    steps on one batch (losses falling, 1 launch of each flash kernel
    per layer and step), step ms, images/s, MFU, peak device memory; the
    three gradients again after the steps, read only (24 bf16 layers
    trained on one repeated batch put both bf16 paths as far from the
    f32 answer as from each other); one profiled step."""
    # vit-b16, f32
    cfg = VIT_B16_F32
    torch.manual_seed(0)
    model = make_vit(cfg, attn_fn=make_flash_attention(), device=dev)
    images, labels = vit_data(cfg, VIT_B16_BATCH, 71, dev)
    attns = attention_modules(model)
    with torch.no_grad():
        flash_logits = model(images)
        for a in attns:
            a.attn_fn = default_attention
        plain_logits = model(images)
    grads = {}
    for name, fn in (("plain", default_attention),
                     ("flash", make_flash_attention())):
        for a in attns:
            a.attn_fn = fn
        model.zero_grad(set_to_none=True)
        F.cross_entropy(model(images), labels).backward()
        grads[name] = {n: p.grad.clone() for n, p in model.named_parameters()}
    names = list(grads["flash"])
    errs = leaf_errors(names, [grads["flash"][n] for n in names],
                       [grads["plain"][n] for n in names])
    checked = {n: e for n, e in errs.items() if not key_bias(n)}
    worst = max(checked, key=checked.get)
    zero_rel = max(grads[r][n].norm().item()
                   / grads[r][n.replace("bias", "weight")].norm().item()
                   for r in grads for n in names if key_bias(n))
    logit_err = (flash_logits - plain_logits).abs().max().item()
    if not logit_err <= 1e-4:
        raise AssertionError(f"vit-b16 f32 logits differ by {logit_err}")
    if not checked[worst] <= F32_GRAD_RTOL:
        raise AssertionError(f"vit-b16 f32 gradient of {worst}: "
                             f"{checked[worst]}")
    if not zero_rel <= F32_ZERO_GRAD_RTOL:
        raise AssertionError(f"vit-b16 key-bias gradients {zero_rel}")
    b16 = {"model": "vit-b16", "dtype": "float32",
           "batch": [VIT_B16_BATCH, cfg.image_size, cfg.image_size],
           "seq": cfg.seq_len, "logits_max_abs_diff": logit_err,
           "logits_limit": 1e-4, "grad_worst_leaf": [worst, checked[worst]],
           "grad_limit": F32_GRAD_RTOL,
           "key_bias_grad_over_key_weight_grad": zero_rel,
           "key_bias_limit": F32_ZERO_GRAD_RTOL}
    del model, grads, flash_logits, plain_logits
    torch.cuda.empty_cache()
    # vit-l16, bf16 compute, full depth
    cfg = VIT_L16
    torch.cuda.reset_peak_memory_stats()
    model = deferred_init(make_vit, cfg, attn_fn=make_flash_attention(),
                          device=dev)
    torch.manual_seed(0)
    materialize_module(model, device=dev)
    opt = default_optimizer(model.parameters())
    images, labels = vit_data(cfg, VIT_L16_BATCH, 72, dev)
    fresh_images, fresh_labels = vit_data(cfg, VIT_L16_BATCH, 73, dev)
    ref = make_vit(cfg.replace(encoder=cfg.encoder.replace(
        dtype=torch.float32)), device=dev)

    def three_ways() -> tuple:
        """Gradients on the fresh batch at the current weights: the flash
        kernels, ``default_attention``, and ``default_attention`` in f32
        compute (the same weights in ``ref``)."""
        ce = lambda m: F.cross_entropy(m(fresh_images), fresh_labels)  # noqa: E731
        flash_fn = attention_modules(model)[0].attn_fn
        flash = attention_grads(model, flash_fn, ce)
        plain = attention_grads(model, default_attention, ce)
        for a in attention_modules(model):
            a.attn_fn = flash_fn
        ref.load_state_dict(model.state_dict())
        return flash, plain, attention_grads(ref, default_attention, ce)

    (f_loss, f_g), (p_loss, p_g), (_, r_g) = three_ways()
    names = [n for n in f_g if not key_bias(n)]
    vs = vs_plain(names, (f_loss, p_loss),
                  (total_norm(f_g.values()), total_norm(p_g.values())),
                  [f_g[n] for n in names], [p_g[n] for n in names])
    vs["vs_float32_compute"] = vs_reference(names, f_g, p_g, r_g)
    kb = max(f_g[n].norm().item() / f_g[n.replace("bias", "weight")].norm().item()
             for n in f_g if key_bias(n))
    if not kb <= BF16_GRAD_RTOL:
        raise AssertionError(f"vit-l16 key-bias gradients {kb} of the key "
                             f"weights'")
    del f_g, p_g, r_g
    step = vit_step_fn(model, opt, images, labels)
    reset_flash_launches()
    losses, step_s = [], []
    for _ in range(VIT_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss, _ = step()
        losses.append(float(loss))
        step_s.append(time.perf_counter() - t)
    launches = dict(flash_launches)
    peak = torch.cuda.max_memory_allocated()
    L = cfg.encoder.n_layers
    want = {k: L * VIT_STEPS for k in FLASH_REPLACES}
    want["flash_dbias"] = 0
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite losses {losses}")
    if not all(x < losses[0] for x in losses[1:]):
        raise AssertionError(f"losses do not fall: {losses}")
    if launches != want:
        raise AssertionError(f"flash launches {launches} != {want}")
    # After the steps, read only: the same three gradients again.
    (_, f_g), (_, p_g), (_, r_g) = three_ways()
    errs = leaf_errors(names, [f_g[n] for n in names], [p_g[n] for n in names])
    worst = max(errs, key=errs.get)
    after = {"grad_worst_leaf": [worst, errs[worst]],
             "vs_float32_compute": vs_reference([worst], f_g, p_g, r_g)}
    del f_g, p_g, r_g, ref
    profile = profile_step("vit-l16", step)
    t = float(np.median(step_s[1:]))
    flops = vit_step_flops(cfg, VIT_L16_BATCH)
    n_params = sum(p.numel() for p in model.parameters())
    row = {"phase": "vit_train", "vit_b16_f32": b16,
           "model": "vit-l16", "n_layers": L, "dtype": "bfloat16 compute, "
           "float32 parameters", "batch": [VIT_L16_BATCH, cfg.image_size,
                                          cfg.image_size],
           "seq": cfg.seq_len, "heads": cfg.encoder.n_heads,
           "head_dim": cfg.encoder.head_size,
           "n_params": n_params, "losses": losses,
           "step_ms": t * 1e3, "step_ms_samples": [x * 1e3 for x in step_s],
           "images_per_s": VIT_L16_BATCH / t, "flops_per_step": flops,
           "flops_formula": "6 x block weights x B x S + 4 x conv weights x "
                            "patches + 6 x head weights x B + 12 x L x B x H "
                            "x S^2 x D (non-causal attention)",
           "mfu": flops / t / PEAK_FLOPS[torch.bfloat16],
           "max_memory_allocated_bytes": peak, "flash_launches": launches,
           "key_bias_grad_over_key_weight_grad": kb,
           "key_bias_limit": BF16_GRAD_RTOL,
           "vs_default_attention": vs,
           "vs_default_attention_after_steps_read_only": after}
    emit(row)
    emit(profile)
    del model, opt
    torch.cuda.empty_cache()
    return row


def attention_grads(model, fn, loss_fn) -> tuple:
    """``(loss, {name: gradient})`` of ``loss_fn(model)`` with ``fn`` in
    every attention module, the gradients as f32 copies on the card."""
    for a in attention_modules(model):
        a.attn_fn = fn
    model.zero_grad(set_to_none=True)
    loss = loss_fn(model)
    loss.backward()
    grads = {n: p.grad.float().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def total_norm(grads) -> float:
    return float(torch.nn.utils.get_total_norm(list(grads)))


def vs_reference(names, flash, plain, ref) -> dict:
    """Each path's normwise error against the f32-compute gradients
    ``ref`` at its worst leaf, and the worst ratio of the flash path's
    error to the plain path's: where the bf16 step itself is far from
    the f32 answer, both are, by the same amount."""
    f = leaf_errors(names, [flash[n] for n in names], [ref[n] for n in names])
    p = leaf_errors(names, [plain[n] for n in names], [ref[n] for n in names])
    worst = max(f, key=f.get)
    ratio = max(names, key=lambda n: f[n] / p[n] if p[n] else 0.0)
    return {"flash_worst_leaf": [worst, f[worst]],
            "plain_at_that_leaf": p[worst],
            "plain_worst": max(p.values()),
            "flash_over_plain_worst": [ratio, f[ratio] / p[ratio]]}


# ---------------------------------------------------------------------------
# phases 24 to 28: sequence parallelism (ROADMAP A10)
# ---------------------------------------------------------------------------

# Several ranks on one card: NCCL refuses two ranks on one device, so the
# sp rings run as spawned processes over gloo (the port's collectives
# stage a gloo group's device tensors through host memory where gloo
# does not take them).  Their times are not step times: none is kept.
SP_RANKS = 4
SP_TIMEOUT_S = 420
# llama3-8b's attention geometry, 16384 tokens over sp 4 (4096 a rank).
SP_ATTN = dict(B=1, S=16384, H=32, KV=8, D=128)
# The same heads at 2048 tokens: f32 against an f64 evaluation, and bf16
# with the JAX package's roundings against the port's.
SP_SMALL = dict(B=1, S=2048, H=32, KV=8, D=128)
# T5-11B's encoder self-attention: 128 heads of 128, an f32 bias, 2048
# tokens over sp 4 (the bias is [128, 512, 2048] a rank).
SP_BIAS = dict(B=1, S=2048, H=128, KV=128, D=128)
# The sp train step: llama3-8b width, 2 layers, bf16 parameters, one
# [1, 8192] sequence over sp 2.
TRAIN_SP_CFG = TRAIN_CFG
TRAIN_SP_RANKS, TRAIN_SP_SEQ, TRAIN_SP_STEPS = 2, 8192, 2
TRAIN_SP_MESH = {"fsdp": 1, "sp": 1}
C3_LLAMA_LEAF = 1.739e-2  # llama's worst leaf in train_bf16_full, PERF.md §6


def _sp_rank(rank: int, world: int, tmp: str, func: str, args) -> None:
    """Rank ``rank`` of a gloo group of ``world`` processes on the one
    card: ``chip_smoke.<func>(rank, world, dev, *args)``, its JSON result
    written to ``tmp``."""
    import faulthandler

    faulthandler.enable()  # a rank that dies on a signal shows where
    require_native()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv",
                            rank=rank, world_size=world)
    try:
        out = globals()[func](rank, world, dev, *args)
    finally:
        dist.destroy_process_group()
    with open(f"{tmp}/rank{rank}.json", "w") as f:
        json.dump(out, f)


def sp_spawn(func: str, world: int, *args) -> list:
    """``func`` in ``world`` spawned ranks on the one card (the kernels are
    built already, so no rank builds); each rank's result, in rank order.
    Raises with a rank's traceback, or past ``SP_TIMEOUT_S``."""
    return sp_join(sp_start(func, world, *args))


def sp_start(func: str, world: int, *args) -> tuple:
    """:func:`sp_spawn` started: a handle for :func:`sp_join`, which this
    process must call (it stops the ranks if they outlive it)."""
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="tdx_ranks_")
    ctx = mp.start_processes(_sp_rank, args=(world, tmp, func, args),
                             nprocs=world, join=False, start_method="spawn")
    return func, world, tmp, ctx, time.monotonic() + SP_TIMEOUT_S


def sp_join(handle: tuple) -> list:
    func, world, tmp, ctx, deadline = handle
    try:
        try:
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{func}: ranks still running after "
                                       f"{SP_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        out = []
        for r in range(world):
            with open(f"{tmp}/rank{r}.json") as f:
                out.append(json.load(f))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def sp_inputs(seed: int, *, B, S, H, KV, D, dtype, dev):
    """q, do [B, S, H, D] and k, v [B, S, KV, D] on the card from a torch
    seed: the same values in every rank."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(B, S, h, D, generator=g, device=dev).to(dtype)
                   for h in (H, KV, KV, H))
    return q, k, v, do


def seq_chunk(x: torch.Tensor, rank: int, world: int, dim: int = 1):
    s = x.shape[dim] // world
    return x.narrow(dim, rank * s, s)


def rel_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def sp_grads(attn, q, k, v, do, rank, world, causal, bias=None) -> dict:
    """This rank's output and gradients through ``attn`` on its chunks
    (the bias: its rows), with the flash launches of that call alone."""
    xs = [seq_chunk(x, rank, world).detach().clone().requires_grad_()
          for x in (q, k, v)]
    kw = {}
    if bias is not None:
        kw["bias"] = seq_chunk(bias, rank, world).detach().clone() \
            .requires_grad_()
    torch.cuda.synchronize()
    reset_flash_launches()
    out = attn(*xs, causal=causal, **kw)
    out.backward(seq_chunk(do, rank, world))
    torch.cuda.synchronize()
    res = {"out": out.detach(), "dq": xs[0].grad, "dk": xs[1].grad,
           "dv": xs[2].grad, "launches": dict(flash_launches)}
    if bias is not None:
        res["dbias"] = kw["bias"].grad
    return res


def whole_grads(q, k, v, do, causal, bias=None) -> dict:
    """Single-device ``flash_attention`` on the whole sequence."""
    from torchdistx_tpu_torch.ops import flash_attention

    xs = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    kw = {}
    if bias is not None:
        kw["bias"] = bias.detach().clone().requires_grad_()
    out = flash_attention(*xs, causal=causal, **kw)
    out.backward(do)
    res = {"out": out.detach(), "dq": xs[0].grad, "dk": xs[1].grad,
           "dv": xs[2].grad}
    if bias is not None:
        res["dbias"] = kw["bias"].grad
    return res


def vs_whole(got: dict, want: dict, rank: int, world: int, limit: float,
             what: str) -> dict:
    """Normwise error of each of this rank's results against its chunk of
    the whole-sequence ones (the bias gradient: its rows); raises past
    ``limit``."""
    errs = {}
    for key in ("out", "dq", "dk", "dv", "dbias"):
        if key in got:
            errs[key] = rel_norm(got[key], seq_chunk(want[key], rank, world))
    bad = {k: e for k, e in errs.items() if not e <= limit}
    if bad:
        raise AssertionError(f"{what}, rank {rank}: {bad} > {limit} "
                             f"(normwise)")
    return errs


def want_launches(rank: int, world: int, causal: bool, dbias: bool) -> dict:
    """Each kernel's launches in one forward and backward on this rank:
    the blocks at or before the diagonal under causal masking (the future
    ones are skipped), all of them otherwise."""
    n = rank + 1 if causal else world
    return {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n,
            "flash_dbias": n if dbias else 0}


def check_launches(got: dict, want: dict, what: str) -> None:
    if got != want:
        raise AssertionError(f"{what}: flash launches {got} != {want}")


def ring_reference_rounding(qh, kh, vh, do, ring, causal: bool):
    """The ring with the JAX package's roundings (``ring_flash.py:91``,
    ``:181``): each block's output rounded to q's dtype before the merge,
    delta taken from the rounded output.  ``(out, dq, dk, dv)``."""
    from torchdistx_tpu_torch.parallel.ring_flash import (
        _merge,
        ring_flash_backward,
    )

    o = torch.zeros(qh.shape, dtype=torch.float32, device=qh.device)
    lse = torch.full(qh.shape[:2], -1e30, device=qh.device)
    k_cur, v_cur = kh, vh
    for i in range(ring.n):
        src = (ring.idx - i) % ring.n
        kind = ring.kind(src, causal)
        if kind is not None:
            out_i, lse_i = flash_forward(qh, k_cur, v_cur, causal=kind)
            o, lse = _merge(o, lse, out_i.float(), lse_i)
        if i < ring.n - 1:
            k_cur, v_cur = ring.rotate(k_cur, v_cur)
    out = o.to(qh.dtype)
    delta = (do.float() * out.float()).sum(-1)
    dq, dk, dv, _ = ring_flash_backward(qh, kh, vh, do, lse, delta, ring,
                                        causal)
    return out, dq, dk, dv


def raw(x: torch.Tensor) -> torch.Tensor:
    """[B, S, H, D] -> the kernels' [B*H, S, D]."""
    B, S, H, D = x.shape
    return x.transpose(1, 2).reshape(B * H, S, D).contiguous()


def plain64(q, k, v, do, causal) -> dict:
    """The plain versions in float64 on the whole sequence, at the raw
    layout: out, dq, dk, dv."""
    q, k, v, do = (raw(x).double() for x in (q, k, v, do))
    out, lse = flash_forward_reference(q, k, v, causal)
    delta = (do * out).sum(-1)
    dq, dk, dv = flash_backward_reference(q, k, v, do, lse, delta, causal)
    return {"out": out, "dq": dq, "dk": dk, "dv": dv}


def f32_vs_f64(got: dict, want: dict, rank: int, world: int) -> dict:
    """|ring - plain64| <= 1e-5 x max(1, |plain64|) on this rank's rows of
    the raw layout; raises past it."""
    errs = {}
    for key in ("out", "dq", "dk", "dv"):
        g = raw(got[key]).double()
        w = seq_chunk(want[key], rank, world)
        err = ((g - w).abs() / w.abs().clamp_min(1.0)).max().item()
        errs[key] = err
    bad = {k: e for k, e in errs.items() if not e <= ATOL[torch.float32]}
    if bad:
        raise AssertionError(f"f32 ring vs f64 plain, rank {rank}: {bad}")
    return errs


def sp_attention_rank(rank: int, world: int, dev) -> dict:
    """The three sp attention phases on this rank (see
    ``phase_ring_flash_sp``, ``phase_ring_flash_bias_sp`` and
    ``phase_ulysses_sp``)."""
    from torchdistx_tpu_torch.parallel.ring_flash import Ring

    mesh = make_mesh({"sp": world}, device_type="cuda")
    ring_fn = make_ring_flash_attention(mesh)
    out = {}
    t0 = time.perf_counter()
    # ring_flash_sp: llama3-8b geometry, bf16, causal.
    q, k, v, do = sp_inputs(70, dtype=torch.bfloat16, dev=dev, **SP_ATTN)
    got = sp_grads(ring_fn, q, k, v, do, rank, world, True)
    check_launches(got["launches"], want_launches(rank, world, True, False),
                   "ring_flash_sp")
    whole = whole_grads(q, k, v, do, True)
    row = {"launches": got["launches"],
           "err_vs_whole": vs_whole(got, whole, rank, world, BF16_NORM_RTOL,
                                    "ring_flash_sp")}
    # ulysses_sp: the same call through Ulysses with the flash kernels.
    uly = make_ulysses_attention(mesh, inner_attn=make_flash_attention())
    u_got = sp_grads(uly, q, k, v, do, rank, world, True)
    check_launches(u_got["launches"], want_launches(0, world, True, False),
                   "ulysses_sp")
    out["ulysses_sp"] = {"launches": u_got["launches"],
                         "err_vs_whole": vs_whole(u_got, whole, rank, world,
                                                  BF16_NORM_RTOL,
                                                  "ulysses_sp")}
    del q, k, v, do, got, whole, u_got
    # f32 at 2048 tokens against an f64 evaluation of the plain version.
    q, k, v, do = sp_inputs(71, dtype=torch.float32, dev=dev, **SP_SMALL)
    got = sp_grads(ring_fn, q, k, v, do, rank, world, True)
    check_launches(got["launches"], want_launches(rank, world, True, False),
                   "ring_flash_sp f32")
    want = plain64(q, k, v, do, True)
    row["f32_err_vs_f64"] = f32_vs_f64(got, want, rank, world)
    # bf16 at 2048 tokens: the port's roundings (block outputs merged in
    # f32, delta from the merged f32 output) and the JAX package's
    # (each block's output rounded, delta from the rounded output),
    # both against an f64 evaluation on the same bf16 inputs.
    q, k, v, do = (x.to(torch.bfloat16) for x in (q, k, v, do))
    got = sp_grads(ring_fn, q, k, v, do, rank, world, True)
    want = plain64(q, k, v, do, True)
    chunks = [raw(seq_chunk(x, rank, world)) for x in (q, k, v, do)]
    ref_out, ref_dq, ref_dk, ref_dv = ring_reference_rounding(
        *chunks, Ring(mesh, "sp"), True)

    def errs(out_, dq, dk, dv):
        return {key: rel_norm(val.double(), seq_chunk(want[key], rank, world))
                for key, val in (("out", out_), ("dq", dq), ("dk", dk),
                                 ("dv", dv))}

    # both returned in the inputs' dtype, as each package returns them
    row["c2_bf16_vs_f64"] = {
        "port": errs(*(raw(got[x]) for x in ("out", "dq", "dk", "dv"))),
        "jax_rounding": errs(ref_out, *(g.to(torch.bfloat16)
                                        for g in (ref_dq, ref_dk, ref_dv)))}
    del q, k, v, do, got, want
    row["seconds"] = time.perf_counter() - t0
    out["ring_flash_sp"] = row
    # ring_flash_bias_sp: T5-11B's encoder geometry with the f32 bias.
    t0 = time.perf_counter()
    q, k, v, do = sp_inputs(72, dtype=torch.bfloat16, dev=dev, **SP_BIAS)
    S, H = SP_BIAS["S"], SP_BIAS["H"]
    bias = torch.randn(H, S, S, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(73))
    got = sp_grads(ring_fn, q, k, v, do, rank, world, False, bias=bias)
    check_launches(got["launches"], want_launches(rank, world, False, True),
                   "ring_flash_bias_sp")
    whole = whole_grads(q, k, v, do, False, bias=bias)
    out["ring_flash_bias_sp"] = {
        "launches": got["launches"],
        "bias_rows_bytes": seq_chunk(bias, rank, world).numel() * 4,
        "err_vs_whole": vs_whole(got, whole, rank, world, BF16_NORM_RTOL,
                                 "ring_flash_bias_sp"),
        "seconds": time.perf_counter() - t0}
    return out


def one_rank_ring(dev) -> dict:
    """``make_ring_flash_attention`` on a one-rank NCCL ``{sp: 1}`` mesh at
    the llama3-8b geometry against ``flash_attention`` on the same
    inputs: one block, no P2P."""
    one_rank_group()
    try:
        mesh = make_mesh({"sp": 1}, device_type="cuda")
        q, k, v, do = sp_inputs(70, dtype=torch.bfloat16, dev=dev, **SP_ATTN)
        got = sp_grads(make_ring_flash_attention(mesh), q, k, v, do, 0, 1,
                       True)
        check_launches(got["launches"], want_launches(0, 1, True, False),
                       "ring_flash_sp on {sp: 1}")
        whole = whole_grads(q, k, v, do, True)
        errs = vs_whole(got, whole, 0, 1, BF16_NORM_RTOL, "{sp: 1}")
        bitwise = all(torch.equal(got[x], whole[x])
                      for x in ("out", "dq", "dk", "dv"))
    finally:
        dist.destroy_process_group()
    return {"mesh": {"sp": 1}, "backend": "nccl", "err_vs_whole": errs,
            "bitwise": bitwise, "launches": got["launches"]}


def phase_ring_flash_sp(ranks: list, dev) -> dict:
    """Ring-flash attention over sp 4 spawned ranks at llama3-8b's
    attention geometry (B 1, S 16384, H 32, KV 8, D 128, causal, bf16):
    each rank's output and dq, dk, dv against its chunk of single-device
    ``flash_attention`` on the whole sequence (normwise within
    BF16_NORM_RTOL); f32 at S 2048 against an f64 evaluation of the plain
    version (1e-5 x max(1, |plain|)); the port's roundings and the JAX
    package's against f64 in bf16 at S 2048; the forward, dq and dk/dv
    kernels launched r + 1 times on rank r (the future blocks skipped);
    and the same call on a one-rank NCCL ``{sp: 1}`` mesh."""
    rows = [r["ring_flash_sp"] for r in ranks]
    row = {"phase": "ring_flash_sp", **SP_ATTN, "dtype": "bfloat16",
           "causal": True, "sp": SP_RANKS,
           "backend": "gloo (spawned ranks on one card)",
           "limit": f"||ring - whole|| / ||whole|| <= {BF16_NORM_RTOL}; f32 "
                    f"{ATOL[torch.float32]} x max(1, |f64 plain|)",
           "launches_by_rank": [r["launches"] for r in rows],
           "err_vs_whole_by_rank": [r["err_vs_whole"] for r in rows],
           "f32_S2048_err_vs_f64_by_rank": [r["f32_err_vs_f64"]
                                            for r in rows],
           "bf16_S2048_vs_f64_by_rank": [r["c2_bf16_vs_f64"] for r in rows],
           "seconds": max(r["seconds"] for r in rows),
           "spawn_seconds": ranks[0]["spawn_seconds"],  # train_pp_mesh's
           "one_rank_nccl": one_rank_ring(dev)}
    emit(row)
    return row


def phase_ring_flash_bias_sp(ranks: list) -> dict:
    """Ring-flash attention with T5-11B's encoder bias over sp 4 spawned
    ranks (H 128, D 128, S 2048, non-causal, bf16, f32 bias rows [128,
    512, 2048] a rank): output, dq, dk, dv and d(bias) against single-
    device flash with the bias on the whole sequence (normwise within
    BF16_NORM_RTOL), every kernel launched 4 times a rank."""
    rows = [r["ring_flash_bias_sp"] for r in ranks]
    row = {"phase": "ring_flash_bias_sp", **SP_BIAS, "dtype": "bfloat16",
           "bias": [SP_BIAS["H"], SP_BIAS["S"] // SP_RANKS, SP_BIAS["S"]],
           "causal": False, "sp": SP_RANKS,
           "limit": f"||ring - whole|| / ||whole|| <= {BF16_NORM_RTOL}",
           "launches_by_rank": [r["launches"] for r in rows],
           "err_vs_whole_by_rank": [r["err_vs_whole"] for r in rows],
           "bias_rows_bytes": rows[0]["bias_rows_bytes"],
           "seconds": max(r["seconds"] for r in rows)}
    emit(row)
    return row


def phase_ulysses_sp(ranks: list) -> dict:
    """Ulysses over sp 4 spawned ranks with the flash kernels inside, at
    the ring_flash_sp geometry, against single-device flash (normwise
    within BF16_NORM_RTOL): one launch of each kernel a rank."""
    rows = [r["ulysses_sp"] for r in ranks]
    row = {"phase": "ulysses_sp", **SP_ATTN, "dtype": "bfloat16",
           "causal": True, "sp": SP_RANKS,
           "inner_attn": "make_flash_attention()",
           "limit": f"||ulysses - whole|| / ||whole|| <= {BF16_NORM_RTOL}",
           "launches_by_rank": [r["launches"] for r in rows],
           "err_vs_whole_by_rank": [r["err_vs_whole"] for r in rows]}
    emit(row)
    return row


def train_sp_batches():
    """The [1, 8192] training sequence and a fresh one for the C3 check."""
    rng = np.random.RandomState(41)
    return (rng.randint(0, TRAIN_SP_CFG.vocab_size, (1, TRAIN_SP_SEQ)),
            rng.randint(0, TRAIN_SP_CFG.vocab_size, (1, TRAIN_SP_SEQ)))


def grouped_plain_attention(q, k, v, *, causal=True, bias=None,
                            segment_ids=None):
    """``default_attention`` one kv head's group at a time: the same
    function, with an [S, S] f32 logit plane per query head of one group
    alive at once rather than of all 32."""
    G = q.shape[2] // k.shape[2]
    return torch.cat([default_attention(q[:, :, j * G:(j + 1) * G],
                                        k[:, :, j:j + 1], v[:, :, j:j + 1],
                                        causal=causal)
                      for j in range(k.shape[2])], 2)


def sp_model(mesh, dev):
    """2-layer llama3-8b width on the ring-flash attention over ``mesh``,
    bound to its keyed bf16 values, and its train step."""
    cfg = TRAIN_SP_CFG
    model = deferred_init(make_llama, cfg,
                          attn_fn=make_ring_flash_attention(mesh), device=dev)
    bind_values(model, materialize_module_cuda(
        model, mesh=mesh, plan=decoder_lm_plan(cfg), seed=0,
        param_dtype=torch.bfloat16))
    init_state, train_step, shard_batch = make_train_step(
        model, cfg, device=dev, mesh=mesh)
    return model, init_state(model), train_step, shard_batch


def train_sp_rank(rank: int, world: int, dev) -> dict:
    """The sp train step on this rank: 2 steps on the [1, 8192] sequence
    (each step's flash launches), then the C3 check: the gradients (summed
    over sp) on a fresh sequence, and, on rank 0 once the other ranks
    have freed the card, the same model's plain-attention gradients on
    the whole fresh sequence."""
    mesh = make_mesh({"sp": world}, device_type="cuda")
    t0 = time.perf_counter()
    model, state, train_step, shard_batch = sp_model(mesh, dev)
    batch_np, fresh_np = train_sp_batches()
    batch = shard_batch(batch_np)
    losses, launches = [], []
    for _ in range(TRAIN_SP_STEPS):
        torch.cuda.synchronize()
        reset_flash_launches()
        state, metrics = train_step(state, batch)
        losses.append(float(metrics["loss"]))
        launches.append(dict(flash_launches))
    peak = torch.cuda.max_memory_allocated()
    # The C3 check: an update at rate 0 leaves the gradients, summed over
    # sp, at the trained weights.
    state["opt"] = torch.optim.SGD(state["params"], lr=0.0)
    torch.cuda.empty_cache()
    state, metrics = train_step(state, shard_batch(fresh_np))
    out = {"losses": losses, "launches": launches,
           "max_memory_allocated_bytes": peak,
           "fresh_loss": float(metrics["loss"]),
           "fresh_grad_norm": float(metrics["grad_norm"])}
    names = [n for n, _ in model.named_parameters()]
    grads = ([p.grad.to("cpu") for p in state["params"]] if rank == 0
             else None)
    dist.barrier()
    for p in state["params"]:
        p.grad = None
    if rank != 0:
        del model, state
        torch.cuda.empty_cache()
    dist.barrier()  # the other ranks' memory is free
    if rank == 0:
        for a in attention_modules(model):
            a.attn_fn = grouped_plain_attention
        fresh = torch.as_tensor(fresh_np, device=dev)
        loss = lm_cross_entropy(model(fresh), fresh)
        loss.backward()
        p_grads = [p.grad for p in state["params"]]
        # in f32, as the step's global_grad_norm (bf16 gradients)
        p_gn = math.sqrt(sum(float(g.float().square().sum())
                             for g in p_grads))
        out["vs_plain"] = vs_plain(
            names, (out["fresh_loss"], loss.item()),
            (out["fresh_grad_norm"], p_gn), grads, p_grads)
        out["vs_plain"].pop("grad_by_leaf")
    out["seconds"] = time.perf_counter() - t0
    return out


def whole_sequence_losses(dev) -> list:
    """The same model and [1, 8192] sequence in this process, whole, on
    the flash kernels (``mesh=None``, the same keyed values)."""
    cfg = TRAIN_SP_CFG
    model = deferred_init(make_llama, cfg, attn_fn=make_flash_attention(),
                          device=dev)
    bind_values(model, materialize_module_cuda(
        model, seed=0, param_dtype=torch.bfloat16))
    init_state, train_step, shard_batch = make_train_step(model, cfg,
                                                          device=dev)
    state = init_state(model)
    batch = shard_batch(train_sp_batches()[0])
    losses = []
    for _ in range(TRAIN_SP_STEPS):
        state, metrics = train_step(state, batch)
        losses.append(float(metrics["loss"]))
    del model, state
    torch.cuda.empty_cache()
    return losses


def one_rank_train_sp(dev) -> dict:
    """The sp step on a one-rank NCCL ``{fsdp: 1, sp: 1}`` mesh: its
    losses and step ms on this card."""
    mesh = mesh_group_up(dev, TRAIN_SP_MESH)
    try:
        model, state, train_step, shard_batch = sp_model(mesh, dev)
        batch = shard_batch(train_sp_batches()[0])
        losses, step_s = [], []
        reset_flash_launches()
        for _ in range(TRAIN_SP_STEPS + 2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, metrics = train_step(state, batch)
            losses.append(float(metrics["loss"]))
            step_s.append(time.perf_counter() - t)
        launches = dict(flash_launches)
        del model, state
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    step = float(np.median(step_s[1:]))
    return {"mesh": TRAIN_SP_MESH, "backend": "nccl", "losses": losses,
            "step_ms": step * 1e3, "step_ms_samples": [x * 1e3 for x in step_s],
            "tokens_per_s": TRAIN_SP_SEQ / step, "flash_launches": launches}


def phase_train_sp(dev, sp_pp) -> dict:
    """The sp train step at llama3-8b width (2 layers, bf16 parameters,
    one [1, 8192] sequence) over sp 2 spawned ranks (``spawn_sp_pp``'s):
    2 losses, equal on
    both ranks, falling, each within BF16_LOSS_RTOL of the same model and
    sequence whole in one process on the flash kernels; the launches per
    rank and step (2 layers x (r + 1) of each kernel); the C3 check (the
    sp gradients on a fresh sequence against plain attention's on the
    same weights: loss, gradient norm, worst leaf within
    BF16_GRAD_RTOL), printed beside llama's 1.739e-2; then the step on a
    one-rank NCCL ``{fsdp: 1, sp: 1}`` mesh with its step ms."""
    if sp_pp is None:
        raise RuntimeError("needs the sp_pp_ranks spawn")
    t0 = time.perf_counter()
    whole, ranks = sp_pp["sp_whole"], sp_pp["sp_ranks"]
    losses = ranks[0]["losses"]
    for r, out in enumerate(ranks):
        if out["losses"] != losses:
            raise AssertionError(f"rank {r} losses {out['losses']} != "
                                 f"rank 0's {losses}")
        want = {k: TRAIN_SP_CFG.n_layers * (r + 1) for k in FLASH_REPLACES}
        want["flash_dbias"] = 0
        for step in out["launches"]:
            check_launches(step, want, f"train_sp rank {r}")
    if not all(math.isfinite(x) for x in losses) \
            or not all(x < losses[0] for x in losses[1:]):
        raise AssertionError(f"train_sp losses do not fall: {losses}")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, whole)]
    if not max(rel) <= BF16_LOSS_RTOL:
        raise AssertionError(f"train_sp losses {losses} vs whole sequence "
                             f"{whole}: {rel} > {BF16_LOSS_RTOL}")
    c3 = ranks[0]["vs_plain"]
    one_rank = one_rank_train_sp(dev)
    row = {"phase": "train_sp", "model": "llama3-8b",
           "n_layers": TRAIN_SP_CFG.n_layers,
           "dtype": "bfloat16 compute, bfloat16 parameters",
           "batch": [1, TRAIN_SP_SEQ], "sp": TRAIN_SP_RANKS,
           "backend": "gloo (spawned ranks on one card; no step times)",
           "losses": losses, "whole_sequence_losses": whole,
           "loss_rel_diff": rel, "loss_limit": BF16_LOSS_RTOL,
           "launches_by_rank": [out["launches"][0] for out in ranks],
           "max_memory_allocated_bytes_by_rank":
               [out["max_memory_allocated_bytes"] for out in ranks],
           "c3_vs_plain": c3,
           "c3_worst_leaf": c3["grad_worst_leaf"],
           "c3_llama_leaf_train_bf16_full": C3_LLAMA_LEAF,
           "one_rank_nccl": one_rank, "seconds": time.perf_counter() - t0,
           "spawn_seconds": sp_pp["spawn_s"]}
    emit(row)
    return row


def sp_pp_rank(rank: int, world: int, dev, tmp: str) -> dict:
    """``train_sp``'s rank, then ``train_pp``'s, in one spawn (a spawn
    costs ~16 s before its first step), the card freed between."""
    out = {"sp": train_sp_rank(rank, world, dev)}
    gc.collect()  # the recording's cycles hold the module's values
    torch.cuda.empty_cache()
    out["pp"] = train_pp_rank(rank, world, dev, tmp)
    return out


def spawn_sp_pp(dev) -> dict:
    """One spawn of 2 gloo ranks for ``train_sp`` and ``train_pp``, after
    the references both hold their ranks against, computed here: the
    whole sequence's losses, the whole pipelined model's, and gpt2-125m
    f32 on ``mesh=None`` (its gradients saved under ``tmp`` for the
    ranks; ``train_pp`` removes ``tmp``)."""
    assert TRAIN_SP_RANKS == TRAIN_PP_RANKS
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    out = {"sp_whole": whole_sequence_losses(dev),
           "pp_whole": pp_whole_losses(dev),
           "tmp": tempfile.mkdtemp(prefix="tdx_sp_pp_")}
    try:
        out["pp_f32"] = pp_f32_reference(dev, out["tmp"])
        t = time.perf_counter()
        ranks = sp_spawn("sp_pp_rank", TRAIN_SP_RANKS, out["tmp"])
    except BaseException:
        shutil.rmtree(out["tmp"], ignore_errors=True)
        raise
    out.update(sp_ranks=[r["sp"] for r in ranks],
               pp_ranks=[r["pp"] for r in ranks],
               spawn_s=time.perf_counter() - t,
               seconds=time.perf_counter() - t0)
    emit({"phase": "sp_pp_ranks", "seconds": out["seconds"],
          "spawn_seconds": out["spawn_s"]})
    return out


# ---------------------------------------------------------------------------
# pipeline parallelism: stages as spawned ranks on the one card
# ---------------------------------------------------------------------------

# The pipelined train step: llama3-8b width, depth cut to 4 layers, bf16
# parameters, a [8, 2048] batch in 4 microbatches over pp 2 (two layers,
# or two chunks of one layer, a stage).
TRAIN_PP_CFG = LLAMA3_8B.replace(n_layers=4)
TRAIN_PP_RANKS, TRAIN_PP_STEPS = 2, 2
TRAIN_PP_BATCH, TRAIN_PP_SEQ, TRAIN_PP_MB, TRAIN_PP_CHUNKS = 8, 2048, 4, 2
PP_SCHEDULES = ("gpipe", "1f1b", "interleaved")
# The f32 case: gpt2-125m (tied head) under 1F1B against mesh=None.
PP_F32_CFG = PRESETS["gpt2-125m"].replace(dtype=torch.float32)
PP_F32_BATCH, PP_F32_SEQ = 8, 512
PP_F32_LOSS_RTOL = 1e-5
# The one-rank NCCL {pp: 1} mesh: 2 layers, timed.
PP_ONE_RANK_STEPS = 5


def train_pp_batches():
    """The [8, 2048] training batch and a fresh one for the C3 check."""
    rng = np.random.RandomState(61)
    shape = (TRAIN_PP_BATCH, TRAIN_PP_SEQ)
    return (rng.randint(0, TRAIN_PP_CFG.vocab_size, shape),
            rng.randint(0, TRAIN_PP_CFG.vocab_size, shape))


def pp_f32_batches() -> list:
    rng = np.random.RandomState(62)
    return [rng.randint(0, PP_F32_CFG.vocab_size, (PP_F32_BATCH, PP_F32_SEQ))
            for _ in range(TRAIN_PP_STEPS)]


def pp_stage_model(make, cfg, mesh, dev, sched, param_dtype):
    """This stage's keyed values of ``make(cfg)`` (the other stages' layers
    stay fake) and what materializing them cost the card: the bytes kept,
    the resident and peak growth, and the largest entry at its recorded
    dtype."""
    model = deferred_init(make, cfg, device=dev)
    fakes = named_fake_tensors(model)
    plan = pipeline_plan_overrides(
        decoder_lm_plan(cfg), cfg.n_layers,
        n_chunks=TRAIN_PP_CHUNKS if sched == "interleaved" else 1)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    values = materialize_module_cuda(model, mesh=mesh, plan=plan, seed=0,
                                     param_dtype=param_dtype)
    torch.cuda.synchronize()
    stage = mesh.get_local_rank("pp")
    own = {i for ls in stage_layers(cfg.n_layers, mesh.size(), stage,
                                    plan.n_chunks) for i in ls}
    want = {n for n in fakes if plan.stage_of(n, mesh) in (None, stage)}
    if set(values) != want or not all(
            int(n.split(".")[1]) in own for n in values
            if n.startswith("blocks.")):
        raise AssertionError(f"stage {stage} materialized "
                             f"{sorted(set(values) ^ want)[:4]} wrongly")
    kept = sum(v.numel() * v.element_size() for v in values.values())
    largest = max(f.numel() * f.element_size() for f in fakes.values())
    growth = torch.cuda.memory_allocated() - before
    peak = torch.cuda.max_memory_allocated() - before
    limit = kept + 2 * largest
    if not (growth <= limit and peak <= limit):
        raise AssertionError(f"stage {stage}: device growth {growth} (peak "
                             f"{peak}) > {limit}")
    bind_values(model, values, strict=False)
    return model, {"kept_bytes": kept, "device_growth_bytes": growth,
                   "device_peak_growth_bytes": peak,
                   "largest_entry_bytes": largest, "limit_bytes": limit,
                   "layers": sorted(own)}


def pp_step(model, cfg, mesh, dev, sched, attn_fn, optimizer=None):
    init_state, train_step, shard_batch = make_train_step(
        model, cfg, device=dev, mesh=mesh, pipeline=True,
        pipeline_schedule=sched, n_microbatches=TRAIN_PP_MB,
        n_chunks=TRAIN_PP_CHUNKS, attn_fn=attn_fn, optimizer=optimizer)
    return init_state(model), train_step, shard_batch


def pp_vs_plain(model, mesh, dev, fresh_np) -> dict:
    """The C3 check on a stage: the pipelined 1F1B gradients on a fresh
    batch with the flash kernels and with plain attention, on the same
    trained weights (SGD at rate 0 leaves them).  Each rank holds its own
    layers' and the replicated leaves; the loss and norm are global."""
    names = {id(p): n for n, p in model.named_parameters()}
    runs = {}
    for name, attn in (("flash", make_flash_attention()),
                       ("plain", grouped_plain_attention)):
        state, train_step, shard_batch = pp_step(
            model, TRAIN_PP_CFG, mesh, dev, "1f1b", attn,
            optimizer=lambda ps: torch.optim.SGD(ps, lr=0.0))
        state, metrics = train_step(state, shard_batch(fresh_np))
        runs[name] = (float(metrics["loss"]), float(metrics["grad_norm"]),
                      [p.grad.to("cpu") for p in state["params"]])
        leaves = [names[id(p)] for p in state["params"]]
        for p in state["params"]:
            p.grad = None
        del state
        torch.cuda.empty_cache()
    (lf, gf, flash), (lp, gp, plain) = runs["flash"], runs["plain"]
    row = vs_plain(leaves, (lf, lp), (gf, gp), flash, plain)
    row.pop("grad_by_leaf")
    return row


def state_digests(state) -> dict:
    """CRC32 of each tensor leaf a checkpoint of the train state
    ``state`` holds, by storage name."""
    tree = checkpoint_tree(state)
    flat = {f"params.{n}": t for n, t in tree["params"].items()}
    flat.update({f"opt.{k}.{n}": t for k, d in tree.get("opt", {}).items()
                 for n, t in d.items()})
    return {k: zlib.crc32(t.detach().reshape(-1).contiguous().view(
        torch.uint8).cpu().numpy()) for k, t in flat.items()}


def pp_f32_rank(mesh, dev, tmp) -> dict:
    """gpt2-125m (f32, tied head) under 1F1B over pp from this stage's
    keyed values: each step's loss against ``mesh=None``'s and each of
    this stage's gradient leaves (the replicated ones summed over the
    stages) normwise; the key biases (zero gradient in exact arithmetic)
    held against their key weights' gradients instead.  The stage's
    state is checkpointed after step 1 (``save_checkpoint``, its leaves'
    CRCs kept) and after step 2 (``AsyncCheckpointSaver``), then the
    step-1 checkpoint is restored in place and step 2 replayed: its loss
    bitwise the first run's."""
    ref = torch.load(f"{tmp}/gpt2_ref.pt")
    model, mat = pp_stage_model(make_gpt2, PP_F32_CFG, mesh, dev, "1f1b",
                                None)
    state, train_step, shard_batch = pp_step(
        model, PP_F32_CFG, mesh, dev, "1f1b", make_flash_attention())
    names = {id(p): n for n, p in model.named_parameters()}
    losses, worst, zero_rel, ck = [], [], 0.0, {}
    batches = pp_f32_batches()
    for i, b in enumerate(batches):
        if i == 1:
            saver = AsyncCheckpointSaver()  # every stage, in step
        state, metrics = train_step(state, shard_batch(b))
        losses.append(float(metrics["loss"]))
        leaves = [names[id(p)] for p in state["params"]]
        got = {n: p.grad for n, p in zip(leaves, state["params"])}
        key_bias = {n for n in leaves if n.endswith("attn.wk.bias")}
        errs = leaf_errors([n for n in leaves if n not in key_bias],
                           [got[n] for n in leaves if n not in key_bias],
                           [ref["grads"][i][n] for n in leaves
                            if n not in key_bias])
        w = max(errs, key=errs.get)
        worst.append([w, errs[w]])
        for n in key_bias:
            wk = n.replace("wk.bias", "wk.weight")
            zero_rel = max(zero_rel, got[n].norm().item()
                           / got[wk].norm().item(),
                           ref["grads"][i][n].norm().item()
                           / ref["grads"][i][wk].norm().item())
        t = time.perf_counter()
        if i == 0:
            save_checkpoint(f"{tmp}/pp_sync", state)
            ck["sync_save_s"] = time.perf_counter() - t
            ck["digests"] = state_digests(state)
        else:
            saver.save(f"{tmp}/pp_async", state)
            ck["async_stage_s"] = time.perf_counter() - t
    t = time.perf_counter()
    saver.wait_until_finished()
    saver.close()
    ck["async_wait_and_commit_s"] = time.perf_counter() - t
    ok, reason = verify_checkpoint(f"{tmp}/pp_async")
    if not ok:
        raise AssertionError(f"the stages' async checkpoint: {reason}")
    t = time.perf_counter()
    restore_checkpoint(f"{tmp}/pp_sync", target=state, verify=True)
    ck["restore_s"] = time.perf_counter() - t
    state, metrics = train_step(state, shard_batch(batches[1]))
    ck["replayed_loss"] = float(metrics["loss"])
    if ck["replayed_loss"] != losses[1] or state["step"] != 2:
        raise AssertionError(f"step 2 replayed from the stage checkpoint: "
                             f"{ck['replayed_loss']} != {losses[1]}")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])]
    if not max(rel) <= PP_F32_LOSS_RTOL:
        raise AssertionError(f"gpt2 f32 1f1b losses {losses} vs mesh=None "
                             f"{ref['losses']}: {rel}")
    if not max(e for _, e in worst) <= F32_GRAD_RTOL:
        raise AssertionError(f"gpt2 f32 1f1b gradient leaves {worst} > "
                             f"{F32_GRAD_RTOL} (normwise)")
    if not zero_rel <= F32_ZERO_GRAD_RTOL:
        raise AssertionError(f"key-bias gradients {zero_rel} of the key "
                             f"weights' > {F32_ZERO_GRAD_RTOL}")
    del model, state
    torch.cuda.empty_cache()
    return {"losses": losses, "mesh_none_losses": ref["losses"],
            "loss_rel_diff": rel, "loss_limit": PP_F32_LOSS_RTOL,
            "grad_worst_leaf_by_step": worst, "grad_limit": F32_GRAD_RTOL,
            "key_bias_grad_over_key_weight_grad": zero_rel,
            "key_bias_limit": F32_ZERO_GRAD_RTOL, "materialize": mat,
            "checkpoint": ck}


def train_pp_rank(rank: int, world: int, dev, tmp: str) -> dict:
    """One pipeline stage: for each schedule, this stage's keyed bf16
    values (its layers only), 2 steps on the [8, 2048] batch (each step's
    flash launches and peak device memory), then, after 1F1B's, the C3
    check on a fresh batch; then the gpt2-125m f32 1F1B case."""
    mesh = make_mesh({"pp": world}, device_type="cuda")
    batch_np, fresh_np = train_pp_batches()
    t0 = time.perf_counter()
    out = {"schedules": {}}
    for sched in PP_SCHEDULES:
        model, mat = pp_stage_model(make_llama, TRAIN_PP_CFG, mesh, dev, sched,
                                    torch.bfloat16)
        state, train_step, shard_batch = pp_step(
            model, TRAIN_PP_CFG, mesh, dev, sched, make_flash_attention())
        batch = shard_batch(batch_np)
        losses, launches, peaks, step_s = [], [], [], []
        for _ in range(TRAIN_PP_STEPS):
            torch.cuda.synchronize()
            reset_flash_launches()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            state, metrics = train_step(state, batch)
            losses.append(float(metrics["loss"]))
            step_s.append(time.perf_counter() - t)
            launches.append(dict(flash_launches))
            peaks.append(torch.cuda.max_memory_allocated())
        row = {"losses": losses, "launches": launches,
               "max_memory_allocated_bytes_by_step": peaks,
               "step_s_gloo": step_s, "materialize": mat,
               "grad_norm": float(metrics["grad_norm"])}
        state = None  # the optimizer's moments
        torch.cuda.empty_cache()
        if sched == "1f1b":
            row["vs_plain"] = pp_vs_plain(model, mesh, dev, fresh_np)
        del model
        torch.cuda.empty_cache()
        out["schedules"][sched] = row
    out["gpt2_f32_1f1b"] = pp_f32_rank(mesh, dev, tmp)
    out["paged_decode_launches"] = paged_attention.launches
    out["seconds"] = time.perf_counter() - t0
    return out


def pp_whole_losses(dev) -> list:
    """The same model, batch and values in this process, whole, on the
    flash kernels: each step the 4 microbatches' summed next-token NLLs
    over the batch's count of targets, accumulated, then AdamW."""
    cfg = TRAIN_PP_CFG
    model = deferred_init(make_llama, cfg, attn_fn=make_flash_attention(),
                          device=dev)
    bind_values(model, materialize_module_cuda(
        model, seed=0, param_dtype=torch.bfloat16, device=dev))
    opt = default_optimizer(list(model.parameters()))
    batch = torch.as_tensor(train_pp_batches()[0], device=dev)
    denom = TRAIN_PP_BATCH * (TRAIN_PP_SEQ - 1)
    losses = []
    for _ in range(TRAIN_PP_STEPS):
        opt.zero_grad(set_to_none=True)
        ce = 0.0
        for mb in batch.chunk(TRAIN_PP_MB):
            logits = model(mb)
            nll = F.cross_entropy(
                logits[:, :-1].reshape(-1, cfg.vocab_size),
                mb[:, 1:].reshape(-1), reduction="sum") / denom
            nll.backward()
            ce += float(nll)
            del logits, nll
        opt.step()
        losses.append(ce)
    del model, opt
    torch.cuda.empty_cache()
    return losses


def pp_f32_reference(dev, tmp: str) -> list:
    """gpt2-125m (f32) on ``mesh=None`` from the same keyed values: each
    step's loss and gradients, saved for the stages."""
    model = deferred_init(make_gpt2, PP_F32_CFG,
                          attn_fn=make_flash_attention(), device=dev)
    bind_values(model, materialize_module_cuda(model, seed=0, device=dev))
    init_state, train_step, shard_batch = make_train_step(
        model, PP_F32_CFG, device=dev)
    state = init_state(model)
    names = [n for n, _ in model.named_parameters()]
    ref = {"losses": [], "grads": []}
    for b in pp_f32_batches():
        state, metrics = train_step(state, shard_batch(b))
        ref["losses"].append(float(metrics["loss"]))
        ref["grads"].append({n: p.grad.to("cpu")
                             for n, p in zip(names, state["params"])})
    torch.save(ref, f"{tmp}/gpt2_ref.pt")
    del model, state
    torch.cuda.empty_cache()
    return ref["losses"]


def pp_whole_load(dev, tmp: str, ranks: list) -> dict:
    """The stages' step-1 checkpoint loaded whole in this process into a
    ``mesh=None`` train state of gpt2-125m (other keyed values first):
    every leaf's CRC equal to the stage that wrote it (the replicated
    ones equal on both), the manifest listing every key once."""
    want: dict = {}
    for out in ranks:
        for k, crc in out["gpt2_f32_1f1b"]["checkpoint"]["digests"].items():
            if want.setdefault(k, crc) != crc:
                raise AssertionError(f"stages disagree on {k}")
    paths = [e["path"] for e in read_manifest(f"{tmp}/pp_sync")["tree"]]
    if len(paths) != len(set(paths)) or len(paths) != len(want) + 1:
        raise AssertionError(f"stage checkpoint's manifest lists "
                             f"{len(paths)} paths ({len(set(paths))} "
                             f"distinct) for {len(want)} leaves and the step")
    model = deferred_init(make_gpt2, PP_F32_CFG,
                          attn_fn=make_flash_attention(), device=dev)
    bind_values(model, materialize_module_cuda(model, seed=1, device=dev))
    init_state, _, _ = make_train_step(model, PP_F32_CFG, device=dev)
    t = time.perf_counter()
    state = restore_checkpoint(f"{tmp}/pp_sync", target=init_state(model),
                               verify=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    got = state_digests(state)
    if got != want or state["step"] != 1:
        bad = sorted(k for k in set(got) | set(want)
                     if got.get(k) != want.get(k))
        raise AssertionError(f"whole load of the stage checkpoint: "
                             f"{len(bad)} leaves differ, e.g. {bad[:4]}")
    del model, state
    torch.cuda.empty_cache()
    return {"leaves": len(want), "bitwise": True, "restore_s": seconds,
            "bytes": payload_bytes(f"{tmp}/pp_sync")}


def one_rank_train_pp(dev, train_row) -> dict:
    """Each schedule on a one-rank NCCL ``{pp: 1}`` mesh (one stage, every
    layer; the interleaved ring sends to itself): 2-layer llama3-8b
    width, bf16 parameters, the [8, 2048] batch in 4 microbatches, step
    ms beside ``train_bf16_full``'s unpipelined step."""
    cfg = TRAIN_CFG
    mesh = mesh_group_up(dev, {"pp": 1})
    out = {}
    try:
        batch_np = train_pp_batches()[0]
        for sched in PP_SCHEDULES:
            model, _ = pp_stage_model(make_llama, cfg, mesh, dev, sched,
                                      torch.bfloat16)
            state, train_step, shard_batch = pp_step(
                model, cfg, mesh, dev, sched, make_flash_attention())
            batch = shard_batch(batch_np)
            losses, step_s = [], []
            reset_flash_launches()
            for _ in range(PP_ONE_RANK_STEPS):
                torch.cuda.synchronize()
                t = time.perf_counter()
                state, metrics = train_step(state, batch)
                losses.append(float(metrics["loss"]))
                step_s.append(time.perf_counter() - t)
            launches = dict(flash_launches)
            want = {k: cfg.n_layers * TRAIN_PP_MB * PP_ONE_RANK_STEPS
                    for k in FLASH_REPLACES}
            want["flash_dbias"] = 0
            check_launches(launches, want, f"train_pp {{pp: 1}} {sched}")
            step = float(np.median(step_s[1:]))
            out[sched] = {"losses": losses, "step_ms": step * 1e3,
                          "step_ms_samples": [x * 1e3 for x in step_s],
                          "tokens_per_s": TRAIN_PP_BATCH * TRAIN_PP_SEQ / step,
                          "flash_launches": launches}
            del model, state
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    out["train_bf16_full_unpipelined"] = None if train_row is None else {
        k: train_row[k] for k in ("step_ms", "tokens_per_s", "batch", "dtype")}
    return {"mesh": {"pp": 1}, "backend": "nccl", "n_layers": cfg.n_layers,
            "batch": [TRAIN_PP_BATCH, TRAIN_PP_SEQ],
            "n_microbatches": TRAIN_PP_MB, "schedules": out}


def phase_train_pp(dev, train_row, sp_pp) -> dict:
    """The pipelined train step at llama3-8b width (4 layers, bf16
    parameters, [8, 2048] in 4 microbatches) over pp 2 spawned ranks,
    under GPipe, 1F1B and interleaved 1F1B (2 chunks of one layer a
    rank): 2 losses a schedule, equal on both ranks, falling, each within
    BF16_LOSS_RTOL of the same model whole in one process with the same
    accumulation; 2 layers x 4 microbatches of each flash kernel per rank
    and step (no recompute), none of d(bias) or paged decode; 1F1B's peak
    below GPipe's on stage 0; each rank's device growth from its keyed
    values within its layers' and the replicated bytes plus twice the
    largest entry; the C3 check (1F1B gradients on a fresh batch against
    plain attention's); gpt2-125m f32 under 1F1B against ``mesh=None``
    (losses 1e-5, leaves 1e-4); then each schedule's step ms on a
    one-rank NCCL ``{pp: 1}`` mesh.  The ranks ran in ``spawn_sp_pp``'s
    spawn."""
    if sp_pp is None:
        raise RuntimeError("needs the sp_pp_ranks spawn")
    t0 = time.perf_counter()
    whole, f32_ref, ranks = sp_pp["pp_whole"], sp_pp["pp_f32"], sp_pp["pp_ranks"]
    try:
        whole_load = pp_whole_load(dev, sp_pp["tmp"], ranks)
    finally:
        shutil.rmtree(sp_pp["tmp"], ignore_errors=True)
    per_rank = TRAIN_PP_CFG.n_layers // TRAIN_PP_RANKS * TRAIN_PP_MB
    want = {k: per_rank for k in FLASH_REPLACES}
    want["flash_dbias"] = 0
    rows = {}
    for sched in PP_SCHEDULES:
        by_rank = [out["schedules"][sched] for out in ranks]
        losses = by_rank[0]["losses"]
        for r, row in enumerate(by_rank):
            if row["losses"] != losses:
                raise AssertionError(f"{sched}: rank {r} losses "
                                     f"{row['losses']} != rank 0's {losses}")
            for step in row["launches"]:
                check_launches(step, want, f"train_pp {sched} rank {r}")
        if not all(math.isfinite(x) for x in losses) \
                or not all(x < losses[0] for x in losses[1:]):
            raise AssertionError(f"train_pp {sched} losses do not fall: "
                                 f"{losses}")
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, whole)]
        if not max(rel) <= BF16_LOSS_RTOL:
            raise AssertionError(f"train_pp {sched} losses {losses} vs "
                                 f"whole {whole}: {rel} > {BF16_LOSS_RTOL}")
        rows[sched] = {
            "losses": losses, "loss_rel_diff": rel,
            "launches_by_rank": [row["launches"][0] for row in by_rank],
            "peak_bytes_by_rank": [max(row["max_memory_allocated_bytes_by_step"]
                                       [1:]) for row in by_rank],
            "materialize_by_rank": [row["materialize"] for row in by_rank],
            "step_s_gloo_by_rank": [row["step_s_gloo"] for row in by_rank]}
    if any(out["paged_decode_launches"] for out in ranks):
        raise AssertionError("paged decode launched on the pipeline path")
    gpipe0 = rows["gpipe"]["peak_bytes_by_rank"][0]
    f1b0 = rows["1f1b"]["peak_bytes_by_rank"][0]
    if not f1b0 < gpipe0:
        raise AssertionError(f"stage 0 peak under 1f1b {f1b0} not below "
                             f"gpipe's {gpipe0}")
    c3 = [out["schedules"]["1f1b"]["vs_plain"] for out in ranks]
    worst = max((c["grad_worst_leaf"] for c in c3), key=lambda w: w[1])
    one_rank = one_rank_train_pp(dev, train_row)
    row = {"phase": "train_pp", "model": "llama3-8b",
           "n_layers": TRAIN_PP_CFG.n_layers,
           "dtype": "bfloat16 compute, bfloat16 parameters",
           "batch": [TRAIN_PP_BATCH, TRAIN_PP_SEQ],
           "n_microbatches": TRAIN_PP_MB, "pp": TRAIN_PP_RANKS,
           "n_chunks_interleaved": TRAIN_PP_CHUNKS,
           "backend": "gloo (spawned ranks on one card; no step times)",
           "whole_model_losses": whole, "loss_limit": BF16_LOSS_RTOL,
           "schedules": rows,
           "stage0_peak_bytes": {"gpipe": gpipe0, "1f1b": f1b0},
           "c3_vs_plain_by_rank": c3, "c3_worst_leaf": worst,
           "c3_llama_leaf_train_bf16_full": C3_LLAMA_LEAF,
           "gpt2_f32_1f1b_by_rank": [
               {**out["gpt2_f32_1f1b"], "checkpoint": {
                   k: v for k, v in out["gpt2_f32_1f1b"]["checkpoint"].items()
                   if k != "digests"}} for out in ranks],
           "gpt2_f32_mesh_none_losses": f32_ref,
           "stage_checkpoint_whole_load": whole_load,
           "one_rank_nccl": one_rank,
           "rank_seconds": [out["seconds"] for out in ranks],
           "seconds": time.perf_counter() - t0,
           "spawn_seconds": sp_pp["spawn_s"]}
    emit(row)
    return row


# ---------------------------------------------------------------------------
# train_pp_mesh: pipeline stages laid out over the other mesh axes
# ---------------------------------------------------------------------------

# Each leg runs on 4 gloo ranks on the card, 1F1B: the llama legs
# at train_pp's configuration (4-layer llama3-8b width, bf16 parameters,
# [8, 2048] in 4 microbatches), the MoE leg at Mixtral 8x7B width, 2
# layers, bf16 parameters, [4, 2048] in 2 microbatches.  Steps: 3, but 2
# where gloo's collectives through the host take ~10 s a step on one
# card (the stage's gradients summed over sp, FSDP2's gathers, and the
# C3 check's 2 more), for the script's time limit.
PP_MESH_LEGS = {"pp2-tp2": {"pp": 2, "tp": 2},
                "pp2-fsdp2": {"pp": 2, "fsdp": 2},
                "pp2-sp2": {"pp": 2, "sp": 2},
                "pp2-ep2": {"pp": 2, "ep": 2}}
PP_MESH_RANKS = 4
PP_MESH_STEPS = {"pp2-tp2": 2, "pp2-fsdp2": 2, "pp2-sp2": 2, "pp2-ep2": 2}
PP_MOE_CFG = PRESETS["mixtral-8x7b"].replace(n_layers=2)
PP_MOE_BATCH, PP_MOE_MB = 4, 2
PP_MESH_C3_LEG = "pp2-tp2"
PP_MESH_ONE_RANK = {"pp": 1, "fsdp": 1, "tp": 1}
CARD_BYTES = 80e9
CUDA_CONTEXT_BYTES = 1e9  # a rank's context and allocator slack, reckoned


def pp_moe_batch() -> np.ndarray:
    return np.random.RandomState(63).randint(
        0, PP_MOE_CFG.vocab_size, (PP_MOE_BATCH, TRAIN_PP_SEQ))


def pp_mesh_plan(cfg, leg: str):
    """The leg's plan: ``decoder_lm_plan``, but on ``{pp 2, tp 2}`` the
    head whole over tp.  Its column-parallel gather is a DTensor
    redistribute, i.e. a functional all-gather, which segfaults on CUDA
    tensors over gloo with torch 2.11 on the H100 (c10d's own all-gathers
    work); the ranks here share one card, so they talk over gloo.  The CPU tests run the tensor-parallel head over gloo, the
    one-rank NCCL step on the card."""
    plan = decoder_lm_plan(cfg)
    if leg == PP_MESH_C3_LEG:
        plan.rules.insert(0, (re.compile(r".*lm_head\.weight"),
                              PartitionSpec(None, "fsdp")))
    return plan


def pp_mesh_leg(leg: str):
    """(config, model factory, batch, microbatches) of a leg."""
    if "ep" in PP_MESH_LEGS[leg]:
        return PP_MOE_CFG, make_mixtral, pp_moe_batch(), PP_MOE_MB
    return TRAIN_PP_CFG, make_llama, train_pp_batches()[0], TRAIN_PP_MB


def pp_mesh_bytes(leg: str, free: int) -> dict:
    """The leg's device bytes per rank, reckoned before it runs: each
    stage's parameters, gradients and AdamW's two moments (bf16) split as
    the axes split them, FSDP2's unsharded gradients held over the
    microbatches, the activations 1F1B keeps (at most 3 microbatches'
    graphs on stage 0; ~16 d bf16 values a token and layer, as train_pp's
    stage 0 peak reads) and the last stage's f32 logits (3 copies: the
    logits, the softmax and their gradient); then 4 ranks and their CUDA
    contexts against the card's 80 GB and against ``free``, what this
    process has left free on the card."""
    axes = PP_MESH_LEGS[leg]
    cfg, _, batch, n_mb = pp_mesh_leg(leg)
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.moe.n_experts if cfg.moe else 0
    hd = cfg.head_size
    attn = d * hd * (2 * cfg.n_heads + 2 * cfg.kv_heads)
    ffn = 3 * d * ff * (E or 1)
    split = axes.get("tp", 1) * axes.get("fsdp", 1)
    layer = attn / split + ffn / (split * axes.get("ep", 1))
    light = cfg.vocab_size * d / split + cfg.vocab_size * d / (
        axes.get("fsdp", 1) if leg == PP_MESH_C3_LEG else split)
    per_stage = cfg.n_layers // axes["pp"]
    params = per_stage * layer + light
    state = 4 * 2 * params
    unsharded_grads = 2 * (per_stage * (attn + ffn / axes.get("ep", 1))
                           / axes.get("tp", 1) + light * split) \
        if "fsdp" in axes else 0
    rows, seq = batch.shape[0] // n_mb, TRAIN_PP_SEQ // axes.get("sp", 1)
    acts = min(3, n_mb) * per_stage * rows * seq * 16 * d * 2
    logits = 3 * rows * seq * cfg.vocab_size * 4
    per_rank = state + unsharded_grads + max(acts, logits + acts / 3)
    total = PP_MESH_RANKS * (per_rank + CUDA_CONTEXT_BYTES)
    if total > min(CARD_BYTES, free):
        raise AssertionError(f"{leg}: {total / 1e9:.1f} GB reckoned for "
                             f"{PP_MESH_RANKS} ranks > the card's 80 GB or "
                             f"the {free / 1e9:.1f} GB free")
    return {"per_rank_bytes": per_rank, "state_bytes": state,
            "free_bytes": free,
            "unsharded_grad_bytes": unsharded_grads,
            "activation_bytes": acts, "logits_bytes": logits,
            "total_bytes_4_ranks_and_contexts": total}


def train_pp_mesh_rank(rank: int, world: int, dev) -> dict:
    """One rank of the sp attention phases, of every leg, then of
    ``train_moe_sp``, one after another on the same gloo group (a spawn
    of 4 ranks costs ~16 s before its first step), each one's memory
    freed before the next: ``{leg: its row}``, ``{"sp_attention": ...}``
    and ``{"moe_sp": ...}``."""
    run = {"sp_attention": sp_attention_rank, "moe_sp": train_moe_sp_rank}
    out = {}
    for leg in ("sp_attention", *PP_MESH_LEGS, "moe_sp"):
        out[leg] = (run[leg](rank, world, dev) if leg in run
                    else pp_mesh_leg_rank(leg, dev))
        gc.collect()  # the recording's cycles hold the module's values
        torch.cuda.empty_cache()
    return out


def pp_mesh_leg_rank(leg: str, dev) -> dict:
    """One rank of a leg: this stage's keyed values laid out over the
    leg's other axis, its 1F1B steps (each step's losses, flash launches,
    wall time; the peak device memory); on the C3 leg, the C3 check."""
    axes = PP_MESH_LEGS[leg]
    mesh = make_mesh(axes, device_type="cuda")
    cfg, make, batch_np, n_mb = pp_mesh_leg(leg)
    t0 = time.perf_counter()
    attn = (make_ring_flash_attention(mesh) if "sp" in axes
            else make_flash_attention())
    model = deferred_init(make, cfg, attn_fn=attn, device=dev)
    plan = pipeline_plan_overrides(pp_mesh_plan(cfg, leg), cfg.n_layers)
    bind_values(model, materialize_module_cuda(
        model, mesh=mesh, plan=plan, seed=0, param_dtype=torch.bfloat16),
        strict=False)
    init_state, train_step, shard_batch = make_train_step(
        model, cfg, device=dev, mesh=mesh, pipeline=True,
        pipeline_schedule="1f1b", n_microbatches=n_mb)
    state = init_state(model)
    batch = shard_batch(batch_np)
    losses, aux, launches, step_s = [], [], [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(PP_MESH_STEPS[leg]):
        torch.cuda.synchronize()
        reset_flash_launches()
        t = time.perf_counter()
        state, metrics = train_step(state, batch)
        losses.append(float(metrics["loss"]))
        aux.append(float(metrics["aux"]))
        step_s.append(time.perf_counter() - t)
        launches.append(dict(flash_launches))
    out = {"losses": losses, "aux": aux, "launches": launches,
           "step_s_gloo": step_s, "grad_norm": float(metrics["grad_norm"]),
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "stage": mesh.get_local_rank("pp"),
           "sp_index": mesh.get_local_rank("sp") if "sp" in axes else 0,
           "paged_decode_launches": paged_attention.launches}
    if leg == PP_MESH_C3_LEG:
        # The C3 check: this rank's gradient shards on a fresh half batch
        # (a row a microbatch) with the flash kernels and with plain
        # attention, at the trained weights (SGD at rate 0 leaves them);
        # loss and norm are global.  The leaves are compared on the card
        # in f32: 4 ranks' f64 copies of them would not fit beside them.
        state["opt"] = torch.optim.SGD(state["params"], lr=0.0,
                                       foreach=False)  # DTensors and plain
        fresh = shard_batch(train_pp_batches()[1][:TRAIN_PP_BATCH // 2])
        names = {id(p): n for n, p in model.named_parameters()}
        leaves = [names[id(p)] for p in state["params"]]
        runs = {}
        for kind in ("flash", "plain"):
            if kind == "plain":
                for a in attention_modules(model):
                    a.attn_fn = grouped_plain_attention
            torch.cuda.empty_cache()
            state, m = train_step(state, fresh)
            runs[kind] = (float(m["loss"]), float(m["grad_norm"]),
                          [local_of(p.grad).clone() for p in state["params"]])
        (lf, gf, flash), (lp, gp, plain) = runs["flash"], runs["plain"]
        out["vs_plain"] = vs_plain(leaves, (lf, lp), (gf, gp), flash, plain,
                                   torch.float32)
        out["vs_plain"].pop("grad_by_leaf")
        del flash, plain, runs
    del model, state
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


def pp_moe_whole_losses(dev) -> list:
    """The MoE leg's model, batch and values in this process, whole, on
    the flash kernels: each step the 2 microbatches' summed next-token
    NLLs over the batch's count of targets plus their router losses
    averaged, accumulated, then AdamW."""
    cfg = PP_MOE_CFG
    model = deferred_init(make_mixtral, cfg, attn_fn=make_flash_attention(),
                          device=dev)
    bind_values(model, materialize_module_cuda(
        model, seed=0, param_dtype=torch.bfloat16, device=dev))
    opt = default_optimizer(list(model.parameters()))
    batch = torch.as_tensor(pp_moe_batch(), device=dev)
    denom = PP_MOE_BATCH * (TRAIN_PP_SEQ - 1)
    losses = []
    for _ in range(PP_MESH_STEPS["pp2-ep2"]):
        opt.zero_grad(set_to_none=True)
        total = 0.0
        for mb in batch.chunk(PP_MOE_MB):
            logits = model(mb)
            nll = F.cross_entropy(
                logits[:, :-1].reshape(-1, cfg.vocab_size),
                mb[:, 1:].reshape(-1), reduction="sum") / denom
            aux = router_aux_loss(model) / PP_MOE_MB
            (nll + aux).backward()
            total += float(nll) + float(aux)
            del logits, nll, aux
        opt.step()
        losses.append(total)
    del model, opt
    gc.collect()  # the recording's cycles hold the module's values
    torch.cuda.empty_cache()
    return losses


def one_rank_pp_mesh(dev, pp_one_rank) -> dict:
    """The 1F1B pipelined step on a one-rank NCCL ``{pp: 1, fsdp: 1, tp:
    1}`` mesh (FSDP2 units and tensor-parallel styles around every stage
    module): 2-layer llama3-8b width, bf16 parameters, the [8, 2048]
    batch in 4 microbatches, step ms beside ``{pp: 1}``'s (train_pp)."""
    cfg = TRAIN_CFG
    mesh = mesh_group_up(dev, PP_MESH_ONE_RANK)
    try:
        model = deferred_init(make_llama, cfg, attn_fn=make_flash_attention(),
                              device=dev)
        plan = pipeline_plan_overrides(decoder_lm_plan(cfg), cfg.n_layers)
        bind_values(model, materialize_module_cuda(
            model, mesh=mesh, plan=plan, seed=0,
            param_dtype=torch.bfloat16), strict=False)
        init_state, train_step, shard_batch = make_train_step(
            model, cfg, device=dev, mesh=mesh, pipeline=True,
            pipeline_schedule="1f1b", n_microbatches=TRAIN_PP_MB)
        state = init_state(model)
        batch = shard_batch(train_pp_batches()[0])
        losses, step_s = [], []
        reset_flash_launches()
        for _ in range(PP_ONE_RANK_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, metrics = train_step(state, batch)
            losses.append(float(metrics["loss"]))
            step_s.append(time.perf_counter() - t)
        launches = dict(flash_launches)
        want = {k: cfg.n_layers * TRAIN_PP_MB * PP_ONE_RANK_STEPS
                for k in FLASH_REPLACES}
        want["flash_dbias"] = 0
        check_launches(launches, want, "train_pp_mesh {pp 1, fsdp 1, tp 1}")
        del model, state
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    step = float(np.median(step_s[1:]))
    return {"mesh": PP_MESH_ONE_RANK, "backend": "nccl", "schedule": "1f1b",
            "n_layers": cfg.n_layers, "losses": losses, "step_ms": step * 1e3,
            "step_ms_samples": [x * 1e3 for x in step_s],
            "tokens_per_s": TRAIN_PP_BATCH * TRAIN_PP_SEQ / step,
            "flash_launches": launches,
            "pp1_1f1b_step_ms": None if pp_one_rank is None
            else pp_one_rank["schedules"]["1f1b"]["step_ms"]}


def phase_train_pp_mesh(dev, train_pp_row) -> dict:
    """Pipeline stages laid out over a second mesh axis, the legs one after
    another in one spawn of 4 gloo ranks on the card, 1F1B
    (PP_MESH_STEPS): ``{pp 2, tp 2}``,
    ``{pp 2, fsdp 2}`` and ``{pp 2, sp 2}`` (ring flash) at train_pp's
    llama configuration, each within BF16_LOSS_RTOL of train_pp's whole
    model (``pp_whole_losses``), and ``{pp 2, ep 2}`` at Mixtral 8x7B
    width (2 layers, [4, 2048] in 2 microbatches) within it of the same
    model whole in this process with the same microbatches.  Each leg's
    bytes are reckoned against the card first.  Losses equal on every
    rank and falling; B1-B3 launched stage layers x microbatches times a
    rank and step (x (r + 1) on sp rank r), B4 and B5 never; the C3 leaf
    on the ``{pp 2, tp 2}`` leg; then the one-rank NCCL ``{pp 1, fsdp 1,
    tp 1}`` step's ms beside ``{pp 1}``'s."""
    assert SP_RANKS == PP_MESH_RANKS  # the sp attention ranks ride along
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    whole = {"llama": None if train_pp_row is None
             else train_pp_row["whole_model_losses"]}
    if whole["llama"] is None:
        whole["llama"] = pp_whole_losses(dev)
    whole["moe"] = pp_moe_whole_losses(dev)
    gc.collect()
    torch.cuda.empty_cache()
    parent = torch.cuda.memory_allocated()
    free = torch.cuda.mem_get_info()[0]
    reckoned = {leg: {**pp_mesh_bytes(leg, free),
                      "this_process_allocated_bytes": parent}
                for leg in PP_MESH_LEGS}
    t = time.perf_counter()
    by_rank = sp_spawn("train_pp_mesh_rank", PP_MESH_RANKS)
    spawn_s = time.perf_counter() - t
    legs = {}
    for leg, axes in PP_MESH_LEGS.items():
        cfg, _, batch_np, n_mb = pp_mesh_leg(leg)
        ranks = [out[leg] for out in by_rank]
        losses = ranks[0]["losses"]
        for r, out in enumerate(ranks):
            if out["losses"] != losses:
                raise AssertionError(f"{leg}: rank {r} losses {out['losses']}"
                                     f" != rank 0's {losses}")
            per = (cfg.n_layers // axes["pp"]) * n_mb * (out["sp_index"] + 1)
            want = {k: per for k in FLASH_REPLACES}
            want["flash_dbias"] = 0
            for step in out["launches"]:
                check_launches(step, want, f"train_pp_mesh {leg} rank {r}")
            if out["paged_decode_launches"]:
                raise AssertionError(f"{leg} rank {r}: paged decode "
                                     f"launched on the pipeline path")
        if not all(math.isfinite(x) for x in losses) \
                or not all(x < losses[0] for x in losses[1:]):
            raise AssertionError(f"train_pp_mesh {leg} losses do not fall: "
                                 f"{losses}")
        ref = whole["moe" if "ep" in axes else "llama"]
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
        if not max(rel) <= BF16_LOSS_RTOL:
            raise AssertionError(f"train_pp_mesh {leg} losses {losses} vs "
                                 f"whole {ref}: {rel} > {BF16_LOSS_RTOL}")
        legs[leg] = {
            "mesh": axes, "model": "mixtral-8x7b" if "ep" in axes
            else "llama3-8b", "n_layers": cfg.n_layers,
            "batch": list(batch_np.shape), "n_microbatches": n_mb,
            "losses": losses, "aux": ranks[0]["aux"], "whole_losses": ref,
            "loss_rel_diff": rel,
            "launches_by_rank_per_step": [out["launches"][0] for out in ranks],
            "peak_bytes_by_rank": [out["max_memory_allocated_bytes"]
                                   for out in ranks],
            "reckoned": reckoned[leg],
            "step_s_gloo_by_rank": [out["step_s_gloo"] for out in ranks],
            "rank_seconds": [out["seconds"] for out in ranks]}
        if leg == PP_MESH_C3_LEG:
            c3 = [out["vs_plain"] for out in ranks]
            legs[leg]["c3_vs_plain_by_rank"] = c3
            legs[leg]["c3_worst_leaf"] = max(
                (c["grad_worst_leaf"] for c in c3), key=lambda w: w[1])
    one_rank = one_rank_pp_mesh(
        dev, None if train_pp_row is None else train_pp_row["one_rank_nccl"])
    row = {"phase": "train_pp_mesh", "dtype": "bfloat16 compute, bfloat16 "
           "parameters", "schedule": "1f1b", "steps": PP_MESH_STEPS,
           "backend": "gloo (spawned ranks on one card; no step times)",
           "loss_limit": BF16_LOSS_RTOL, "legs": legs,
           "spawn_seconds": spawn_s, "one_rank_nccl": one_rank,
           "seconds": time.perf_counter() - t0}
    emit(row)
    # The same spawn ran train_moe_sp's and the sp attention phases'
    # ranks: checked by those phases.
    row["moe_sp_ranks"] = [out["moe_sp"] for out in by_rank]
    row["sp_attention_ranks"] = [{**out["sp_attention"],
                                  "spawn_seconds": spawn_s}
                                 for out in by_rank]
    return row


# ---------------------------------------------------------------------------
# train_moe_sp: a mixture of experts routed over the sp ring
# ---------------------------------------------------------------------------

# Mixtral 8x7B width, depth cut to 2 layers (as mixtral_train_bf16 and
# train_pp_mesh's ep leg), bf16 parameters, the [2, 2048] batch on
# {sp 2, ep 2}: every rank holds chunk s of both rows and the experts of
# its ep index; the routing (capacity, slots, router loss) is the whole
# sequence's.
MOE_SP_CFG = PRESETS["mixtral-8x7b"].replace(n_layers=2)
MOE_SP_MESH = {"sp": 2, "ep": 2}
MOE_SP_BATCH, MOE_SP_SEQ, MOE_SP_STEPS = 2, 2048, 2


def moe_sp_batch() -> np.ndarray:
    return np.random.RandomState(81).randint(
        0, MOE_SP_CFG.vocab_size, (MOE_SP_BATCH, MOE_SP_SEQ))


def dropped_pairs(model) -> int:
    """The (token, choice) pairs the last forward dropped at capacity."""
    return int(sum(int((~m.kept).sum()) for m in model.modules()
                   if isinstance(m, MoEMLP)))


def record_routing(model) -> list:
    """Each ``MoEMLP``'s routing in its next forward, appended to the
    returned list as one dict a layer: the router probabilities it was
    given (this rank's rows and chunk), its slots, kept pairs, capacity
    and router loss."""
    seen: list = []
    for m in model.modules():
        if isinstance(m, MoEMLP):
            def route(probs, dtype, _m=m, _route=m.route):
                gates, onehot, pos, capacity = _route(probs, dtype)
                if len(seen) < MOE_SP_CFG.n_layers:
                    seen.append({"probs": probs.detach().cpu().tolist(),
                                 "pos": pos.cpu().tolist(),
                                 "kept": _m.kept.cpu().tolist(),
                                 "capacity": capacity,
                                 "aux": float(_m.aux.detach())})
                return gates, onehot, pos, capacity
            m.route = route
    return seen


def whole_routing(ranks, dev) -> dict:
    """The first step's router probabilities of the sp ranks (ep index 0),
    joined in chunk order into the whole sequence's and routed on the
    card by ``MoEMLP.route`` with no mesh: its slots, kept pairs and
    capacity cut to each rank's chunk, and its router loss, against the
    ranks' own, bitwise, layer by layer.  Returns the dropped pairs."""
    by_sp = sorted((out for out in ranks if out["ep_index"] == 0),
                   key=lambda out: out["sp_index"])
    k, n_sp = MOE_SP_CFG.moe.top_k, len(by_sp)
    s = MOE_SP_SEQ // n_sp
    mod = MoEMLP(MOE_SP_CFG, device="meta")
    dropped = []
    for layer in range(MOE_SP_CFG.n_layers):
        probs = torch.cat([torch.tensor(out["routing"][layer]["probs"],
                                        device=dev) for out in by_sp], 1)
        _, _, pos, capacity = mod.route(probs, MOE_SP_CFG.dtype)
        pos = pos.view(MOE_SP_BATCH, MOE_SP_SEQ, k).cpu()
        kept = mod.kept.view(MOE_SP_BATCH, MOE_SP_SEQ, k).cpu()
        for out in ranks:
            got = out["routing"][layer]
            cut = slice(out["sp_index"] * s, (out["sp_index"] + 1) * s)
            same = (got["pos"] == pos[:, cut].reshape(-1, k).tolist()
                    and got["kept"] == kept[:, cut].reshape(-1, k).tolist()
                    and got["capacity"] == capacity
                    and got["aux"] == float(mod.aux))
            if not same:
                raise AssertionError(
                    f"train_moe_sp layer {layer}, sp rank "
                    f"{out['sp_index']}: routing differs from the whole "
                    f"sequence's (capacity {got['capacity']} / {capacity}, "
                    f"aux {got['aux']} / {float(mod.aux)})")
        dropped.append(int((~kept).sum()))
    return {"dropped_pairs_by_layer": dropped, "capacity": capacity}


def moe_sp_steps(model, mesh, dev) -> dict:
    """``MOE_SP_STEPS`` AdamW steps of ``make_train_step`` on ``mesh``
    (None: one rank, the whole sequence): losses, router losses, dropped
    pairs and flash launches of each step, the peak device memory, and
    the first step's routing (:func:`record_routing`)."""
    init_state, train_step, shard_batch = make_train_step(
        model, MOE_SP_CFG, device=dev, mesh=mesh)
    state = init_state(model)
    batch = shard_batch(moe_sp_batch())
    out = {"losses": [], "aux": [], "dropped": [], "launches": [],
           "step_s": [], "routing": record_routing(model)}
    torch.cuda.reset_peak_memory_stats()
    for _ in range(MOE_SP_STEPS):
        torch.cuda.synchronize()
        reset_flash_launches()
        t = time.perf_counter()
        state, metrics = train_step(state, batch)
        out["losses"].append(float(metrics["loss"]))
        out["step_s"].append(time.perf_counter() - t)
        out["aux"].append(float(metrics["aux"]))
        out["dropped"].append(dropped_pairs(model))
        out["launches"].append(dict(flash_launches))
    out["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    del state, init_state, train_step
    return out


def train_moe_sp_rank(rank: int, world: int, dev) -> dict:
    """One rank of ``{sp 2, ep 2}``: the keyed bf16 values on the mesh,
    ring-flash attention, the steps."""
    t0 = time.perf_counter()
    mesh = make_mesh(MOE_SP_MESH, device_type="cuda")
    model = deferred_init(make_mixtral, MOE_SP_CFG,
                          attn_fn=make_ring_flash_attention(mesh), device=dev)
    bind_values(model, materialize_module_cuda(
        model, mesh=mesh, plan=decoder_lm_plan(MOE_SP_CFG), seed=0,
        param_dtype=torch.bfloat16))
    warnings.simplefilter("ignore")  # the batch replicated over ep, by design
    out = moe_sp_steps(model, mesh, dev)
    out["routing"] = out["routing"][:MOE_SP_CFG.n_layers]
    out.update({"sp_index": mesh.get_local_rank("sp"),
                "ep_index": mesh.get_local_rank("ep"),
                "paged_decode_launches": paged_attention.launches,
                "seconds": time.perf_counter() - t0})
    return out


def phase_train_moe_sp(dev, pp_mesh_row) -> dict:
    """A mixture of experts over the sp ring: Mixtral 8x7B width (2
    layers, bf16) on 4 spawned gloo ranks ``{sp 2, ep 2}`` with ring
    flash attention (run in ``train_pp_mesh``'s spawn, after its legs),
    against the same keyed values whole on one rank
    (``mesh=None``, the whole sequence) in this process: losses
    equal on every rank and within BF16_LOSS_RTOL of the whole
    sequence's; the first step's routing (each layer's slots, kept pairs,
    capacity and router loss on every rank) bitwise the whole sequence's
    routing of the ranks' router probabilities joined (the whole model's
    own probabilities differ by the ring's bf16 rounding, which flips a
    few near-tied top-2 choices: its dropped pairs are printed beside);
    B1-B3 launched layers x (s + 1) times a step on sp rank s, B4 and B5
    never."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    model = deferred_init(make_mixtral, MOE_SP_CFG,
                          attn_fn=make_flash_attention(), device=dev)
    bind_values(model, materialize_module_cuda(
        model, seed=0, param_dtype=torch.bfloat16, device=dev))
    whole = moe_sp_steps(model, None, dev)
    whole.pop("routing")
    del model
    gc.collect()  # the recording's cycles hold the module's values
    torch.cuda.empty_cache()
    if pp_mesh_row is None:
        raise RuntimeError("needs train_pp_mesh's spawn")
    ranks = pp_mesh_row.pop("moe_sp_ranks")
    losses = ranks[0]["losses"]
    for r, out in enumerate(ranks):
        if out["losses"] != losses:
            raise AssertionError(f"train_moe_sp rank {r} losses "
                                 f"{out['losses']} != rank 0's {losses}")
        per = MOE_SP_CFG.n_layers * (out["sp_index"] + 1)
        want = {k: per for k in FLASH_REPLACES}
        want["flash_dbias"] = 0
        for step in out["launches"]:
            check_launches(step, want, f"train_moe_sp rank {r}")
        if out["paged_decode_launches"]:
            raise AssertionError(f"train_moe_sp rank {r}: paged decode "
                                 f"launched on the training path")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, whole["losses"])]
    if not all(math.isfinite(x) for x in losses) \
            or not max(rel) <= BF16_LOSS_RTOL:
        raise AssertionError(f"train_moe_sp losses {losses} vs the whole "
                             f"sequence's {whole['losses']}: {rel} > "
                             f"{BF16_LOSS_RTOL}")
    routed = whole_routing(ranks, dev)
    dropped = [sum(out["dropped"][i] for out in ranks
                   if out["ep_index"] == 0) for i in range(MOE_SP_STEPS)]
    if dropped[0] != sum(routed["dropped_pairs_by_layer"]):
        raise AssertionError(f"train_moe_sp dropped pairs {dropped[0]} != "
                             f"the whole sequence's routing's "
                             f"{routed['dropped_pairs_by_layer']}")
    row = {"phase": "train_moe_sp", "card": nvidia_smi(),
           "model": "mixtral-8x7b", "n_layers": MOE_SP_CFG.n_layers,
           "dtype": "bfloat16 compute, bfloat16 parameters",
           "mesh": MOE_SP_MESH, "attention": "ring flash",
           "backend": "gloo (spawned ranks on one card; no step times)",
           "batch": [MOE_SP_BATCH, MOE_SP_SEQ], "steps": MOE_SP_STEPS,
           "capacity": moe_capacity(MOE_SP_CFG.moe, MOE_SP_BATCH * MOE_SP_SEQ),
           "losses": losses, "whole_losses": whole["losses"],
           "loss_rel_diff": rel, "loss_limit": BF16_LOSS_RTOL,
           "aux": ranks[0]["aux"], "whole_aux": whole["aux"],
           "dropped_pairs": dropped,
           "whole_routing_of_the_ranks_probs": {**routed, "bitwise": True},
           "whole_model_dropped_pairs": whole["dropped"],
           "launches_by_rank_per_step": [out["launches"][0] for out in ranks],
           "sp_index_by_rank": [out["sp_index"] for out in ranks],
           "peak_bytes_by_rank": [out["max_memory_allocated_bytes"]
                                  for out in ranks],
           "whole_peak_bytes": whole["max_memory_allocated_bytes"],
           "step_s_gloo_by_rank": [out["step_s"] for out in ranks],
           "rank_seconds": [out["seconds"] for out in ranks],
           "seconds": time.perf_counter() - t0}
    emit(row)
    return row


# ---------------------------------------------------------------------------
# fleet: replicas behind the router and autoscaler, chaos, a rollover
# ---------------------------------------------------------------------------

# Replicas at llama3-8b width, depth cut to 4 layers, float32 (7.7 GB of
# parameters each): the oracle's tokens and the canary's 1e-4 on final
# logits hold in float32 with IEEE matmuls, as serve_f32_exact's do.
FLEET_CFG = LLAMA3_8B.replace(n_layers=4, dtype=torch.float32,
                              param_dtype=torch.float32)
FLEET_SERVE = ServeConfig(max_batch=4, page_size=16, n_pages=48,
                          max_pages_per_seq=8, prefill_buckets=(16, 32, 64))
# 2 replicas; queue pressure scales to 3, idle drains back to 2.
FLEET_FC = FleetConfig(min_replicas=2, max_replicas=3,
                       up_queue_per_replica=2.0, up_consecutive=2,
                       down_consecutive=40, cooldown_s=0.5, stall_s=60.0)
FLEET_STORM, FLEET_ROLL_STORM = 32, 8
FLEET_PLAN = "fleet@2=raise"
FLEET_TIMEOUT_S = 300.0


def fleet_requests(tag: str, n: int, seed: int) -> list:
    """``n`` requests of mixed prompt lengths (3 to 60 tokens) and
    budgets (8 to 16 tokens), four arriving per controller tick."""
    rng = np.random.RandomState(seed)
    return [Request(f"{tag}{i}",
                    rng.randint(0, FLEET_CFG.vocab_size,
                                int(rng.randint(3, 61))).tolist(),
                    max_new_tokens=int(rng.randint(8, 17)),
                    arrival_step=i // 4) for i in range(n)]


def fleet_watch(fl, seen: dict) -> None:
    """Keep in ``seen`` a record of every replica the fleet ran: its
    state, version, spin-up and capture seconds (at spin-up and now),
    plain decode ticks and page check, refreshed while the fleet holds it;
    once it is gone only the record stays (a removed replica's
    parameters are freed with its engine)."""
    live = {h.idx: h for h in fl.handles}
    for idx, h in live.items():
        seen[idx] = {"h": h}
    for idx, rec in seen.items():
        h = rec.get("h")
        if h is None:
            continue
        eng = h.engine
        rec.update(state=h.state, version=h.weight_version,
                   spin_up_s=h.bring_up_seconds, capture_s=h.capture_seconds)
        if eng is not None:
            rec.update(engine_capture_s=eng.capture_seconds,
                       cuda_graphs=eng.cuda_graphs,
                       plain_ticks=eng.decode_steps - eng.spec_verify_ticks,
                       pages=(eng.kv.pages_in_use, eng.prefix.page_count()))
        rec["thread"] = h.thread
        if idx not in live:
            rec["h"] = None


def fleet_drive(fl, reqs, seen: dict, until=None, plan=None,
                probe=None) -> int:
    """Submit ``reqs`` at their ticks and tick until every one is done
    and ``until()`` holds; every replica the fleet ran is kept in
    ``seen``.  ``plan`` is installed once 3 replicas serve, so its kill
    lands after the scale-up; ``probe()`` runs once, at the first tick
    with 2 replicas serving and requests in flight.  Returns the most
    replicas serving at once."""
    base, most, i = fl._tick_no, 0, 0
    deadline = time.monotonic() + FLEET_TIMEOUT_S
    while i < len(reqs) or fl._pending or (until and not until()):
        while i < len(reqs) and reqs[i].arrival_step + base <= fl._tick_no:
            fl.submit(reqs[i])
            i += 1
        fl.tick()
        fleet_watch(fl, seen)
        serving = sum(1 for h in fl.handles if h.state == "serving")
        most = max(most, serving)
        if probe is not None and serving >= 2 and fl._pending:
            probe()
            probe = None
        if plan is not None and most >= 3:
            chaos.install(plan)
            plan = None
        if time.monotonic() > deadline:
            raise TimeoutError(f"fleet: {len(fl._pending)} pending after "
                               f"{FLEET_TIMEOUT_S} s")
        time.sleep(0.001)
    return most


def http_get(url: str):
    """(status, body bytes) of a GET; an HTTP error is an answer."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def scrape_live(fl) -> dict:
    """The telemetry daemon's endpoints while the fleet serves: /readyz
    200 with the serving count of the fleet's replicas, /metrics with
    the fleet counters, /slo and /requests as JSON."""
    srv = httpd.get_server()
    if srv is None or not srv.is_alive():
        raise AssertionError("no telemetry daemon with TDX_OBS_PORT=0")
    t0 = time.perf_counter()
    for _ in range(5):  # a replica may change state during the scrape
        before = sum(1 for h in fl.handles if h.state == "serving")
        status, body = http_get(srv.url("/readyz"))
        after = sum(1 for h in fl.handles if h.state == "serving")
        if before == after:
            break
    ready = json.loads(body)
    if status != 200 or ready["fleet"]["serving"] != before:
        raise AssertionError(f"/readyz {status}: {ready.get('fleet')} with "
                             f"{before} replicas serving")
    status, metrics = http_get(srv.url("/metrics"))
    fleet_lines = [ln for ln in metrics.decode().splitlines()
                   if ln.startswith("tdx_fleet_")]
    if status != 200 or not fleet_lines:
        raise AssertionError(f"/metrics {status}: no fleet counters")
    out = {"port": srv.port, "readyz": status, "serving": before,
           "replicas_listed": sorted(ready["fleet"]["replicas"]),
           "metrics_fleet_lines": len(fleet_lines)}
    for path in ("/slo", "/requests"):
        status, body = http_get(srv.url(path))
        doc = json.loads(body)
        if status != 200 or not isinstance(doc, dict):
            raise AssertionError(f"{path} {status}")
        out[path[1:]] = {"status": status, "keys": sorted(doc)}
    out["scrape_s"] = time.perf_counter() - t0
    return out


def fleet_check_oracle(fl, reqs) -> float:
    """Every request completed, tokens equal to the oracle under the
    weights of its version, final logits within 1e-4; the worst."""
    worst = 0.0
    for r in reqs:
        if r.rid not in fl.results:
            raise AssertionError(f"fleet {r.rid}: not completed "
                                 f"({fl.rejected.get(r.rid)})")
        v = fl.served_version[r.rid]
        want, logits = fl.oracle_generate(fl.version_params[v], r.tokens,
                                          r.max_new_tokens, r.eos_id)
        if fl.results[r.rid] != want:
            raise AssertionError(f"fleet {r.rid} ({v}): {fl.results[r.rid]} "
                                 f"!= oracle {want}")
        err = float(np.abs(fl.final_logits[r.rid] - logits).max())
        worst = max(worst, err)
        if not err <= 1e-4:
            raise AssertionError(f"fleet {r.rid}: final logits off by {err}")
    return worst


def fleet_checkpoint(fl, path: str, dev) -> dict:
    """The same config's weights at another seed, saved where a roll
    fetches them: bytes and seconds.  Recorded and materialized on a
    thread of its own: a thread's last recording session keeps its
    random values reachable until its next session starts, and this
    thread's ends with it."""
    out: dict = {}

    def write():
        try:
            with fl.device_lock:
                torch.manual_seed(1)
                net = materialize_module(deferred_init(
                    make_llama, FLEET_CFG, device=dev), device=dev)
                t = time.perf_counter()
                save_checkpoint(path, net.state_dict())
                out["save_s"] = time.perf_counter() - t
        except BaseException as e:  # noqa: BLE001 — raised below
            out["error"] = e

    th = threading.Thread(target=write, name="fleet-checkpoint")
    th.start()
    th.join()
    if "error" in out:
        raise out["error"]
    gc.collect()
    torch.cuda.empty_cache()
    nbytes = payload_bytes(path)
    return {"bytes": nbytes, "save_s": out["save_s"],
            "save_gb_per_s": nbytes / out["save_s"] / 1e9}


def phase_fleet(dev) -> dict:
    """The serve fleet on the card's float32 path: 2 replicas of 4-layer
    llama3-8b width, a storm of 32 requests that scales the fleet to 3,
    then ``fleet@2=raise`` kills replica 2 mid-batch (its lanes requeue
    onto the survivors), idle scale-down to 2, then a blue-green
    rollover to the same config at another seed under 8 more requests.
    Every request equals the unbatched oracle of the weights that served
    it (tokens exact, final logits within 1e-4), the canary's gate
    passes, no KV page is leaked, no program is recaptured, and the
    paged-decode kernel launched layers x (plain decode ticks + decode
    captures after the count's reset) times.  Then every replica thread
    has ended and the fleet's device memory is free again: a thread or a
    reference left behind would hold a replica's weights."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    threads: list = []
    # TDX_OBS_PORT=0 for the fleet: the telemetry daemon on an ephemeral
    # port, armed by the fleet's first counter (the earlier phases'
    # arming is undone first) and scraped while the replicas serve.
    observe.stop_background()
    tdx_config.set_flags(obs_port=0)
    try:
        row = fleet_run(dev, threads)
    finally:
        observe.stop_background()
        tdx_config.set_flags(obs_port=None)
    for th in threads:
        th.join(timeout=60.0)
        if th.is_alive():
            raise AssertionError(f"fleet: replica thread {th.name} alive "
                                 f"after shutdown")
    del threads
    gc.collect()  # the fleet, its handles and engines refer to each other
    torch.cuda.synchronize()
    # torch keeps a cuBLAS workspace for each thread that ran a GEMM (32
    # MiB on this card) after the thread ends; drop those first.
    row["cublas_workspace_bytes"] = torch.cuda.memory_allocated() - base
    torch._C._cuda_clearCublasWorkspaces()
    row["device_bytes_left"] = torch.cuda.memory_allocated() - base
    row["cublas_workspace_bytes"] -= row["device_bytes_left"]
    if row["device_bytes_left"] > 64 << 20:
        blocks = sorted((b["size"] for seg in torch.cuda.memory_snapshot()
                         for b in seg["blocks"]
                         if b["state"] == "active_allocated"), reverse=True)
        raise AssertionError(f"fleet: {row['device_bytes_left']} bytes still "
                             f"allocated after shutdown (largest active "
                             f"blocks {blocks[:8]})")
    torch.cuda.empty_cache()
    row["seconds"] = time.perf_counter() - t0
    emit(row)
    return row


def fleet_run(dev, threads: list) -> dict:
    """:func:`phase_fleet`'s fleet, from start to shutdown: its row;
    every replica thread it ran is appended to ``threads``."""
    from torchdistx_tpu_torch.serve import ServeFleet

    tmp = tempfile.mkdtemp(prefix="tdx_fleet_")
    fl = ServeFleet(FLEET_CFG, family="llama", serve_cfg=FLEET_SERVE,
                    fleet_cfg=FLEET_FC, seed=0, param_dtype=torch.float32,
                    device=dev)
    seen: dict = {}
    try:
        fl.start(2, timeout=FLEET_TIMEOUT_S)
        fleet_watch(fl, seen)
        paged_attention.launches = paged_attention.merge_launches = 0
        reset_flash_launches()
        storm = fleet_requests("s", FLEET_STORM, seed=91)
        live: dict = {}
        try:
            t = time.perf_counter()
            most = fleet_drive(fl, storm, seen, plan=FLEET_PLAN,
                               probe=lambda: live.update(scrape_live(fl)))
            storm_s = time.perf_counter() - t
        finally:
            chaos.clear()
        if not live:
            raise AssertionError("fleet: the telemetry daemon was not "
                                 "scraped while the replicas served")
        if 2 in {h.idx for h in fl.handles} or seen[2]["state"] != "failed":
            raise AssertionError(f"fleet: replica 2 not killed "
                                 f"({seen[2]['state']})")
        if most < 3:
            raise AssertionError(f"fleet: the storm scaled to {most} "
                                 f"replicas, not 3")
        deadline = time.monotonic() + FLEET_TIMEOUT_S
        while len(fl.handles) > FLEET_FC.min_replicas:  # idle scale-down
            fl.tick()
            fleet_watch(fl, seen)
            if time.monotonic() > deadline:
                raise TimeoutError("fleet: no idle scale-down")
            time.sleep(0.002)
        ckpt = fleet_checkpoint(fl, f"{tmp}/step_1", dev)
        ctl = fl.start_rollover(f"{tmp}/step_1")
        # Half the requests while the canary runs, half after the shift.
        rolled = fleet_requests("v", FLEET_ROLL_STORM, seed=92)
        half = FLEET_ROLL_STORM // 2
        fleet_drive(fl, rolled[:half], seen, until=lambda: (
            ctl.outcome is not None or fl.active_version == ctl.version))
        fleet_drive(fl, rolled[half:], seen,
                    until=lambda: ctl.outcome is not None)
        if ctl.outcome != "completed":
            raise AssertionError(f"fleet rollover: {ctl.digest()}")
        reqs = storm + rolled
        worst = fleet_check_oracle(fl, reqs)
        versions = sorted({str(fl.served_version[r.rid]) for r in reqs})
        if versions != sorted({"None", ctl.version}):
            raise AssertionError(f"fleet: versions served {versions}")
        torch.cuda.synchronize()
        launches = paged_attention.launches
        fleet_watch(fl, seen)
        for i, rec in seen.items():
            if rec.get("engine_capture_s") != rec["capture_s"]:
                raise AssertionError(f"fleet r{i}: a program was recaptured")
            if rec["h"] is not None and rec["pages"][0] != rec["pages"][1]:
                raise AssertionError(f"fleet r{i}: {rec['pages'][0]} pages "
                                     f"in use, {rec['pages'][1]} cached")
        # Replicas captured after the count's reset: each decode capture's
        # warm-up run launches the kernel once a layer.
        late = [i for i, rec in seen.items()
                if i > 2 and rec.get("cuda_graphs")]
        plain = sum(rec.get("plain_ticks", 0) for rec in seen.values())
        want = FLEET_CFG.n_layers * (plain + len(late))
        if launches != want:
            raise AssertionError(f"fleet: {launches} paged-decode launches "
                                 f"!= {FLEET_CFG.n_layers} layers x ({plain}"
                                 f" plain ticks + {len(late)} captures)")
        if any(flash_launches.values()):
            raise AssertionError(f"fleet: flash launched {flash_launches}")
        row = {"phase": "fleet", "card": nvidia_smi(), "model": "llama3-8b",
               "n_layers": FLEET_CFG.n_layers, "dtype": "float32",
               "fleet": dataclasses.asdict(FLEET_FC),
               "serve": dataclasses.asdict(FLEET_SERVE), "plan": FLEET_PLAN,
               "requests": len(reqs), "token_exact": True,
               "max_final_logit_err": worst, "most_serving": most,
               "versions_served": versions,
               "replicas": {f"r{i}": {k: rec[k] for k in (
                   "state", "version", "spin_up_s", "capture_s")}
                   for i, rec in sorted(seen.items())},
               "storm_s": storm_s, "live_telemetry": live,
               "checkpoint": ckpt,
               "rollover": ctl.digest(), "canary_gate": "passed",
               "paged_decode_launches": launches,
               "paged_merge_launches": paged_attention.merge_launches,
               "plain_decode_ticks": plain, "decode_captures_after_reset":
               len(late), "recaptures": 0,
               "max_memory_allocated_bytes":
                   torch.cuda.max_memory_allocated()}
    finally:
        fl.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
        threads.extend(rec["thread"] for rec in seen.values())
    return row


# ---------------------------------------------------------------------------
# train_elastic and reshard: checkpoints, the elastic loop, resharding
# ---------------------------------------------------------------------------

# The sharded main path (first_step_sharded's) at llama3-8b width, depth
# cut to 1 layer to fit the script's clock, bf16 parameters, [2, 2048]
# batches, the one-rank NCCL {fsdp: 1} mesh.  Its checkpoint holds the
# parameters and both AdamW moments in bf16 (about 7.6 GB, most of it
# the embedding and the head; each write takes ~12 s of the card's
# machine, so the runs are as short as the checks allow).  The elastic run: 4 steps,
# drained by the plan's preemption, then 2 more in a fresh process,
# which saves step 6; the reference runs 8 uninterrupted (the last 2 for
# the resharded checkpoint).
ELASTIC_CFG = LLAMA3_8B.replace(n_layers=1)
ELASTIC_MESH = {"fsdp": 1}
ELASTIC_STEPS, ELASTIC_DRAIN_STEP, ELASTIC_REF_STEPS = 6, 4, 8
# The step-2 save is damaged after it commits; step 3 raises, and the
# restore finds step 2 corrupt, quarantines it and restores step 0; the
# notice at step 4 drains the run.
ELASTIC_PLAN = "save@2=corrupt:truncate;step@3=raise;step@4=preempt"
ELASTIC_QUARANTINED = "step_2.corrupt"
ELASTIC_OPTS = {"checkpoint_every": 2, "max_to_keep": 2}
ASYNC_STEPS = 3
# The reshard engine's chunk budget: below the 1.05 GB bf16 embedding,
# so the largest leaves move in slabs.
RESHARD_CHUNK_MB = 256
RESHARD_MESH = {"fsdp": 2, "tp": 2}
# The data axis the 2 spawned gloo ranks train under (FSDP2 over gloo on
# the card's tensors) before the 1-rank resume.
TWO_RANK_AXIS, TWO_RANKS, TWO_RANK_STEPS, TWO_RANK_RESUMED = "fsdp", 2, 1, 2
CHILD_TIMEOUT_S = 900


def elastic_batches() -> list:
    rng = np.random.RandomState(71)
    return [rng.randint(0, ELASTIC_CFG.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))
            for _ in range(ELASTIC_REF_STEPS)]


def elastic_model(mesh, dev, seed: int = 0):
    """1-layer llama3-8b width on the flash kernels, bound to its keyed
    bf16 values on ``mesh`` (seed 0 is the run's; others are values a
    restore must overwrite)."""
    model = deferred_init(make_llama, ELASTIC_CFG,
                          attn_fn=make_flash_attention(), device=dev)
    bind_values(model, materialize_module_cuda(
        model, mesh=mesh, plan=decoder_lm_plan(ELASTIC_CFG), seed=seed,
        param_dtype=torch.bfloat16))
    return model


def payload_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(path, rel))
               for rel in iter_payload_files(path))


def launches_per_step(launches: dict, steps: int) -> None:
    want = {k: ELASTIC_CFG.n_layers * steps for k in FLASH_REPLACES}
    want["flash_dbias"] = 0
    check_launches(launches, want, f"{steps} elastic steps")


def elastic_first(tmp: str) -> None:
    """The uninterrupted reference (``ELASTIC_REF_STEPS`` steps), then ``train_elastic``
    from the same keyed values under ``ELASTIC_PLAN`` until the plan's
    preemption drains it; prints one JSON line."""
    dev = torch.device("cuda", 0)
    mesh = mesh_group_up(dev, ELASTIC_MESH)
    batches = elastic_batches()
    try:
        model = elastic_model(mesh, dev)
        init_state, train_step, shard_batch = make_train_step(
            model, ELASTIC_CFG, device=dev, mesh=mesh)
        state = init_state(model)
        ref = []
        for b in batches:
            state, metrics = train_step(state, shard_batch(b))
            ref.append(float(metrics["loss"]))
        del model, state, init_state, train_step
        torch.cuda.empty_cache()
        model = elastic_model(mesh, dev)
        losses, executed = {}, []

        def on_metrics(step, metrics):
            losses[step] = float(metrics["loss"])
            executed.append(step)

        reset_flash_launches()
        chaos.install(ELASTIC_PLAN)
        t0 = time.perf_counter()
        try:
            state, steps, restarts = train_elastic(
                model, ELASTIC_CFG, batches[:ELASTIC_STEPS], mesh=mesh,
                device=dev, checkpoint_dir=f"{tmp}/elastic",
                on_metrics=on_metrics, **ELASTIC_OPTS)
        finally:
            chaos.clear()
        seconds = time.perf_counter() - t0
        launches = dict(flash_launches)
    finally:
        dist.destroy_process_group()
    emit({"reference_losses": ref, "losses": losses, "steps": steps,
          "restarts": restarts, "executed_steps": executed,
          "flash_launches": launches, "seconds": seconds,
          "dirs": sorted(os.listdir(f"{tmp}/elastic"))})


def elastic_resume(tmp: str) -> None:
    """A fresh process resumes the drained run (``resume=True``) on other
    values and runs its last 2 steps; then saves step 6 (the checkpoint
    ``reshard`` takes), timed, and on it a verify and an in-place
    restore; the step ms without and while an async save is in flight.
    Prints one JSON line."""
    dev = torch.device("cuda", 0)
    mesh = mesh_group_up(dev, ELASTIC_MESH)
    batches = elastic_batches()
    try:
        model = elastic_model(mesh, dev, seed=1)
        losses = {}
        reset_flash_launches()
        t0 = time.perf_counter()
        state, steps, restarts = train_elastic(
            model, ELASTIC_CFG, batches[:ELASTIC_STEPS], mesh=mesh, device=dev,
            checkpoint_dir=f"{tmp}/elastic", resume=True,
            checkpoint_every=ELASTIC_STEPS + 1,
            on_metrics=lambda s, m: losses.__setitem__(s, float(m["loss"])))
        seconds = time.perf_counter() - t0
        launches = dict(flash_launches)
        out = {"losses": losses, "steps": steps, "restarts": restarts,
               "flash_launches": launches, "seconds": seconds}
        ck = f"{tmp}/elastic/step_{steps}"
        torch.cuda.synchronize()
        t = time.perf_counter()
        save_checkpoint(ck, state)
        save_s = time.perf_counter() - t
        nbytes = payload_bytes(ck)
        t = time.perf_counter()
        ok, reason = verify_checkpoint(ck)
        verify_s = time.perf_counter() - t
        if not ok:
            raise AssertionError(f"a fresh save failed verification: {reason}")
        t = time.perf_counter()
        restore_checkpoint(ck, target=state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        _, train_step, shard_batch = make_train_step(
            model, ELASTIC_CFG, device=dev, mesh=mesh)
        batch = shard_batch(batches[-1])
        state, plain_ms = timed_ms(state, train_step, batch, ASYNC_STEPS)
        saver = AsyncCheckpointSaver()
        t = time.perf_counter()
        saver.save(f"{tmp}/timing_async", state)
        stage_s = time.perf_counter() - t
        in_flight = []
        async_ms = []
        for _ in range(ASYNC_STEPS):
            state, ms = timed_ms(state, train_step, batch, 1)
            async_ms += ms
            in_flight.append(saver._thread is not None
                             and saver._thread.is_alive())
        t = time.perf_counter()
        saver.wait_until_finished()
        saver.close()
        commit_s = time.perf_counter() - t
        ok, reason = verify_checkpoint(f"{tmp}/timing_async")
        if not ok:
            raise AssertionError(f"the async save failed verification: "
                                 f"{reason}")
        shutil.rmtree(f"{tmp}/timing_async")
        out.update({
            "checkpoint_bytes": nbytes, "save_s": save_s,
            "save_gb_per_s": nbytes / save_s / 1e9, "verify_s": verify_s,
            "verify_gb_per_s": nbytes / verify_s / 1e9, "restore_s": restore_s,
            "restore_gb_per_s": nbytes / restore_s / 1e9,
            "step_ms_no_save": plain_ms, "step_ms_async_save_in_flight":
            async_ms, "async_save_in_flight_after_step": in_flight,
            "async_stage_s": stage_s, "async_wait_and_commit_s": commit_s})
    finally:
        dist.destroy_process_group()
    emit(out)


def timed_ms(state, train_step, batch, n: int) -> tuple:
    """``n`` steps, each timed to its end on the card, in ms."""
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, metrics = train_step(state, batch)
        float(metrics["loss"])
        out.append((time.perf_counter() - t) * 1e3)
    return state, out


def phase_train_elastic(dev, tmp: str) -> dict:
    """``train_elastic`` on the sharded main path (1-layer llama3-8b
    width, bf16 parameters, one-rank NCCL ``{fsdp: 1}``): every 2 steps a
    checkpoint (max 2 kept); the step-2 save damaged after it committed,
    step 3 raising, the preemption notice at step 4 (``ELASTIC_PLAN``);
    a fresh process resumes to step 6.  Quarantined ``step_2.corrupt``,
    one restart, a clean exit at step 4, every step's loss bitwise the
    uninterrupted run's from the same keyed values, B1-B3 at 1 launch
    a step; the checkpoint's bytes, save / verify / restore s and GB/s,
    and the step ms with and without an async save in flight."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    first = run_child("elastic_first", tmp, timeout=CHILD_TIMEOUT_S)
    with open(f"{tmp}/elastic/CLEAN_EXIT.json") as f:
        clean = json.load(f)["step"]
    second = run_child("elastic_resume", tmp, timeout=CHILD_TIMEOUT_S)
    ref = first["reference_losses"]
    losses = {int(k): v for k, v in first["losses"].items()}
    losses.update({int(k): v for k, v in second["losses"].items()})
    if (first["steps"], first["restarts"], clean) != (ELASTIC_DRAIN_STEP, 1,
                                                      ELASTIC_DRAIN_STEP):
        raise AssertionError(f"elastic run: steps {first['steps']}, "
                             f"restarts {first['restarts']}, clean exit at "
                             f"{clean}")
    if ELASTIC_QUARANTINED not in first["dirs"]:
        raise AssertionError(f"no {ELASTIC_QUARANTINED}: {first['dirs']}")
    if second["steps"] != ELASTIC_STEPS:
        raise AssertionError(f"resumed run ended at {second['steps']}")
    got = [losses[s] for s in range(1, ELASTIC_STEPS + 1)]
    if got != ref[:ELASTIC_STEPS]:
        raise AssertionError(f"elastic losses {got} != uninterrupted "
                             f"{ref[:ELASTIC_STEPS]}")
    launches_per_step(first["flash_launches"], len(first["executed_steps"]))
    launches_per_step(second["flash_launches"],
                      ELASTIC_STEPS - ELASTIC_DRAIN_STEP)
    row = {"phase": "train_elastic", "card": nvidia_smi(),
           "model": "llama3-8b", "n_layers": ELASTIC_CFG.n_layers,
           "dtype": "bfloat16 compute, bfloat16 parameters",
           "mesh": ELASTIC_MESH, "backend": "nccl",
           "batch": [TRAIN_BATCH, TRAIN_SEQ], "plan": ELASTIC_PLAN,
           **ELASTIC_OPTS, "losses": got, "losses_bitwise": True,
           "restarts": first["restarts"], "clean_exit_step": clean,
           "dirs_after_drain": first["dirs"],
           "executed_steps": first["executed_steps"],
           "flash_launches_first": first["flash_launches"],
           "flash_launches_resumed": second["flash_launches"],
           "elastic_s": first["seconds"], "resumed_s": second["seconds"],
           **{k: second[k] for k in (
               "checkpoint_bytes", "save_s", "save_gb_per_s", "verify_s",
               "verify_gb_per_s", "restore_s", "restore_gb_per_s",
               "step_ms_no_save", "step_ms_async_save_in_flight",
               "async_save_in_flight_after_step", "async_stage_s",
               "async_wait_and_commit_s")},
           "reference_losses": ref, "seconds": time.perf_counter() - t0}
    emit(row)
    return row


def elastic_writer_rank(rank: int, world: int, dev, tmp: str) -> dict:
    """A spawned gloo rank: the main path's model on ``{TWO_RANK_AXIS:
    world}`` from its keyed values, ``TWO_RANK_STEPS`` steps, then a
    checkpoint by ``AsyncCheckpointSaver`` (each rank writes its own
    shards; the commit waits for both)."""
    mesh = make_mesh({TWO_RANK_AXIS: world}, device_type="cuda")
    model = elastic_model(mesh, dev)
    init_state, train_step, shard_batch = make_train_step(
        model, ELASTIC_CFG, device=dev, mesh=mesh)
    state = init_state(model)
    losses = {}
    t0 = time.perf_counter()
    for b in elastic_batches()[:TWO_RANK_STEPS]:
        state, metrics = train_step(state, shard_batch(b))
        losses[state["step"]] = float(metrics["loss"])
    train_s = time.perf_counter() - t0
    with AsyncCheckpointSaver() as saver:
        saver.save(f"{tmp}/two_rank/step_{TWO_RANK_STEPS}", state)
    return {"losses": losses, "seconds": time.perf_counter() - t0,
            "async_save_s": time.perf_counter() - t0 - train_s}


def reshard_resume(tmp: str) -> None:
    """In a fresh process on the one-rank ``{fsdp: 1}`` mesh, from other
    keyed values each time: the round-tripped checkpoint restored (the
    route ``needs_reshard`` picks) and its next 2 steps; the 2-rank
    checkpoint resumed by ``train_elastic(resume=True)``, which routes
    it through ``needs_reshard`` -> ``restore_resharded``; then the same
    resharded state's next steps, uninterrupted (``restore_resharded``
    timed).  Prints one JSON line."""
    dev = torch.device("cuda", 0)
    mesh = mesh_group_up(dev, ELASTIC_MESH)
    batches = elastic_batches()
    src = f"{tmp}/two_rank/step_{TWO_RANK_STEPS}"
    counter = observe.counters().counter("tdx.reshard.elastic_reshards")
    out = {}
    try:
        with tdx_config.override(reshard_chunk_mb=RESHARD_CHUNK_MB):
            model = elastic_model(mesh, dev, seed=1)
            init_state, train_step, shard_batch = make_train_step(
                model, ELASTIC_CFG, device=dev, mesh=mesh)
            state = init_state(model)
            back = f"{tmp}/reshard_back"
            resharded = needs_reshard(back, state)
            t = time.perf_counter()
            if resharded:
                restore_resharded(back, state)
            else:
                restore_checkpoint(back, target=state, verify=True)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t
            step = state["step"]
            losses = []
            for b in batches[ELASTIC_STEPS:]:
                state, metrics = train_step(state, shard_batch(b))
                losses.append(float(metrics["loss"]))
            out["round_trip"] = {
                "losses": losses, "restored_step": step,
                "route": "restore_resharded" if resharded
                else "restore_checkpoint", "restore_s": restore_s}
            del model, state, init_state, train_step
            torch.cuda.empty_cache()
            model = elastic_model(mesh, dev, seed=1)
            losses = {}
            before = counter.value
            _, steps, _ = train_elastic(
                model, ELASTIC_CFG, batches[:TWO_RANK_STEPS + TWO_RANK_RESUMED],
                mesh=mesh,
                device=dev, checkpoint_dir=f"{tmp}/two_rank", resume=True,
                checkpoint_every=100, probe_on_restart=False,
                on_metrics=lambda s, m: losses.__setitem__(
                    s, float(m["loss"])))
            elastic_peak = last_transfer_peak_bytes()
            resharded = counter.value - before
            del model
            torch.cuda.empty_cache()
            model = elastic_model(mesh, dev, seed=2)
            init_state, train_step, shard_batch = make_train_step(
                model, ELASTIC_CFG, device=dev, mesh=mesh)
            state = init_state(model)
            torch.cuda.synchronize()
            t = time.perf_counter()
            restore_resharded(src, state)
            torch.cuda.synchronize()
            reshard_s = time.perf_counter() - t
            peak = last_transfer_peak_bytes()
            ref = []
            for b in batches[TWO_RANK_STEPS:TWO_RANK_STEPS + TWO_RANK_RESUMED]:
                state, metrics = train_step(state, shard_batch(b))
                ref.append(float(metrics["loss"]))
        out["two_rank"] = {
            "losses": losses, "steps": steps, "elastic_reshards": resharded,
            "reference_losses": ref, "reshard_s": reshard_s,
            "peak_staging_bytes": peak,
            "elastic_peak_staging_bytes": elastic_peak,
            "mesh_axes": read_manifest(src)["topology"]["mesh_axes"]}
    finally:
        dist.destroy_process_group()
    emit(out)


def reshard_ctl(cmd: str, *args: str) -> subprocess.Popen:
    """``python -m torchdistx_tpu_torch.tools.reshard_ctl <cmd> <args>``
    with the phase's chunk budget, started."""
    here = os.path.dirname(os.path.abspath(__file__))
    return subprocess.Popen(
        [sys.executable, "-m", "torchdistx_tpu_torch.tools.reshard_ctl", cmd,
         *args, "--chunk-mb", str(RESHARD_CHUNK_MB)],
        cwd=here, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def reshard_ctl_result(proc: subprocess.Popen, what: str, t0: float) -> dict:
    """The tool's JSON line and wall seconds, after checking it exited
    0."""
    out, err = proc.communicate(timeout=CHILD_TIMEOUT_S)
    doc = {"exit": proc.returncode, "wall_s": time.perf_counter() - t0,
           **json.loads(out.strip().splitlines()[-1])}
    if proc.returncode != 0:
        raise AssertionError(f"reshard_ctl {what}: {doc} {err[-2000:]}")
    return doc


def reshard_hops(src: str, nbytes: int, tmp: str, budget: int) -> tuple:
    """``src`` offline to ``RESHARD_MESH`` under ``gspmd_2d_plan`` through
    the operator's tool and back to ``ELASTIC_MESH`` under
    ``decoder_lm_plan`` in this process, each hop bitwise and staged
    within ``budget``: ``(hops, the 2-D plan, its largest leaf's
    bytes)``; ``{tmp}/reshard_back`` stays for the resume."""
    plan_2d = plan_reshard(src, gspmd_2d_plan(), MeshSpec(RESHARD_MESH),
                           chunk_mb=RESHARD_CHUNK_MB)
    largest = max(lt.nbytes for lt in plan_2d.leaves)
    if not largest > budget:
        raise AssertionError(f"budget {budget} not below the largest leaf "
                             f"{largest}")
    # The hop to the 2-D mesh through the operator's tool: ``apply``
    # writes it, then ``verify`` (exit 0) compares it with the source bit
    # for bit while the hop back reads it in this process — one
    # verification, as the in-process call makes before it commits.
    to_2d = f"{tmp}/reshard_to_2d"
    t = time.perf_counter()
    applied = reshard_ctl_result(reshard_ctl(
        "apply", src, to_2d, "--mesh",
        ",".join(f"{a}={n}" for a, n in RESHARD_MESH.items()), "--plan",
        "gspmd2d", "--min-size", str(2**16), "--no-verify"), "apply", t)
    if not 0 < applied["peak_host_bytes"] <= budget:
        raise AssertionError(f"reshard_ctl apply staged "
                             f"{applied['peak_host_bytes']} bytes, budget "
                             f"{budget}")
    t_verify = time.perf_counter()
    verifying = reshard_ctl("verify", src, to_2d)
    try:
        observe.enable(True)
        observe.reset()
        t = time.perf_counter()
        try:
            reshard_checkpoint(to_2d, decoder_lm_plan(ELASTIC_CFG),
                               MeshSpec(ELASTIC_MESH), f"{tmp}/reshard_back",
                               chunk_mb=RESHARD_CHUNK_MB)
        finally:
            seconds = time.perf_counter() - t
            spans = {e["name"]: e["dur"] / 1e6 for e in observe.tracer().drain()
                     if e["ph"] == "X" and e["name"].startswith("reshard.")}
            observe.enable(None)
        verified = reshard_ctl_result(verifying, "verify", t_verify)
    finally:
        if verifying.poll() is None:
            verifying.kill()
            verifying.wait()
    peak = last_transfer_peak_bytes()
    if not 0 < peak <= budget:
        raise AssertionError(f"reshard back staged {peak} bytes, "
                             f"budget {budget}")
    hops = {"to_2d": {"mesh": RESHARD_MESH,
                      "route": "reshard_ctl apply, then reshard_ctl verify",
                      "apply_wall_s": applied["wall_s"],
                      "apply_s": applied["seconds"],
                      "gb_per_s": nbytes / applied["wall_s"] / 1e9,
                      "verify_wall_s": verified["wall_s"],
                      "peak_staging_bytes": applied["peak_host_bytes"],
                      "bitwise": verified["ok"]},
            "back": {"mesh": ELASTIC_MESH, "seconds": seconds,
                     "gb_per_s": nbytes / seconds / 1e9,
                     "transfer_s": spans.get("reshard.transfer"),
                     "verify_reshard_s": spans.get("reshard.verify"),
                     "peak_staging_bytes": peak, "bitwise": True}}
    shutil.rmtree(f"{tmp}/reshard_to_2d")
    return hops, plan_2d, largest


def phase_reshard(dev, tmp: str, elastic_row) -> dict:
    """The train_elastic checkpoint (step 6) offline to the device-free
    ``{fsdp 2, tp 2}`` under ``gspmd_2d_plan`` through ``python -m
    torchdistx_tpu_torch.tools.reshard_ctl apply`` and ``verify`` (exit
    0), and back to ``{fsdp 1}`` under ``decoder_lm_plan`` in this
    process (the layout it trains in, so it restores without a reshard),
    a chunk budget below the largest leaf: each hop bitwise
    (``reshard_checkpoint`` runs ``verify_reshard`` before it commits the
    destination), staging within the budget; meanwhile a checkpoint
    written by 2 spawned gloo ranks on the card with
    ``AsyncCheckpointSaver``; then in one fresh
    process the round trip restored onto the card, its next 2 steps
    bitwise the uninterrupted run's, and the 2-rank checkpoint resumed by
    one rank through ``needs_reshard`` -> ``restore_resharded``, its
    steps bitwise an uninterrupted one-rank run's from the same
    resharded state."""
    if elastic_row is None:
        raise RuntimeError("needs train_elastic's checkpoint")
    t0 = time.perf_counter()
    budget = RESHARD_CHUNK_MB << 20
    ck = f"{tmp}/elastic"
    src = f"{ck}/step_{ELASTIC_STEPS}"
    for name in os.listdir(ck):  # free the disk: only the last step is needed
        if name != f"step_{ELASTIC_STEPS}" and os.path.isdir(f"{ck}/{name}"):
            shutil.rmtree(f"{ck}/{name}")
    nbytes = payload_bytes(src)
    # The 2 ranks train and write their checkpoint on the card while the
    # offline hops below move bytes on the host.
    writers = sp_start("elastic_writer_rank", TWO_RANKS, tmp)
    try:
        hops, plan_2d, largest = reshard_hops(src, nbytes, tmp, budget)
    finally:
        ranks = sp_join(writers)
    shutil.rmtree(ck)
    if any(r["losses"] != ranks[0]["losses"] for r in ranks):
        raise AssertionError(f"ranks disagree: {[r['losses'] for r in ranks]}")
    two_bytes = payload_bytes(f"{tmp}/two_rank/step_{TWO_RANK_STEPS}")
    resumed = run_child("reshard_resume", tmp, timeout=CHILD_TIMEOUT_S)
    trip, two = resumed["round_trip"], resumed["two_rank"]
    want = elastic_row["reference_losses"][ELASTIC_STEPS:]
    if trip["losses"] != want or trip["restored_step"] != ELASTIC_STEPS:
        raise AssertionError(f"round-tripped checkpoint (step "
                             f"{trip['restored_step']}) trained to "
                             f"{trip['losses']}, uninterrupted {want}")
    got = [two["losses"][str(s)] for s in
           range(TWO_RANK_STEPS + 1, TWO_RANK_STEPS + TWO_RANK_RESUMED + 1)]
    if two["elastic_reshards"] != 1 or got != two["reference_losses"]:
        raise AssertionError(f"2 -> 1 rank resume: {two['elastic_reshards']}"
                             f" reshards, losses {got} vs "
                             f"{two['reference_losses']}")
    for peak in (two["peak_staging_bytes"], two["elastic_peak_staging_bytes"]):
        if not 0 < peak <= 2 * budget:  # the online verify double-buffers
            raise AssertionError(f"online reshard staged {peak} bytes, "
                                 f"budget {budget}")
    shutil.rmtree(f"{tmp}/reshard_back")
    shutil.rmtree(f"{tmp}/two_rank")
    row = {"phase": "reshard", "card": nvidia_smi(), "model": "llama3-8b",
           "n_layers": ELASTIC_CFG.n_layers, "checkpoint_bytes": nbytes,
           "chunk_budget_bytes": budget, "largest_leaf_bytes": largest,
           "leaves": len(plan_2d.leaves), "chunks_to_2d": plan_2d.total_chunks,
           "hops": hops, "round_trip": trip,
           "two_rank": {"axis": TWO_RANK_AXIS, "ranks": TWO_RANKS,
                        "backend": "gloo (spawned ranks on one card)",
                        "checkpoint_bytes": two_bytes,
                        "losses": ranks[0]["losses"],
                        "rank_seconds": [r["seconds"] for r in ranks],
                        "async_save_s_by_rank":
                            [r["async_save_s"] for r in ranks],
                        **two, "resumed_losses": got,
                        "reshard_gb_per_s": two_bytes / two["reshard_s"]
                        / 1e9},
           "seconds": time.perf_counter() - t0}
    emit(row)
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    nvcc_version = subprocess.run(
        [_build.nvcc_path(), "--version"], capture_output=True, text=True,
    ).stdout.strip().splitlines()
    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "nvcc": nvcc_version[-1] if nvcc_version else None})
    flush = L2Flush(dev)
    failures = []
    main_row, main_args = None, None
    record_health_walk()
    start = time.perf_counter()

    def run(name, fn, *a):
        t = time.perf_counter()
        try:
            return fn(*a)
        except Exception as e:  # noqa: BLE001 — report, run the rest, exit 1
            traceback.print_exc()
            emit({"phase": name, "ok": False,
                  "error": f"{type(e).__name__}: {e}"[:500]})
            failures.append(name)
            return None
        finally:
            # Each phase's wall seconds, for the script's clock budget.
            now = time.perf_counter()
            emit({"phase_clock": name, "seconds": now - t,
                  "since_start_s": now - start})

    builds = run("build", build_all) or {}
    run("kernel", phase_kernel, dev, flush, builds.get("paged_decode.cu", {}))
    # The login host records beside the phases that follow, on the host
    # only, after the paged-decode timings its host work could perturb.
    login = start_login_host()
    flash_rows = run("flash_kernel", phase_flash_kernel, dev, flush,
                     builds.get("flash_attention.cu", {}))
    run("flash_tune", phase_flash_tune, dev, flush)
    bias_rows = run("flash_bias_kernel", phase_flash_bias_kernel, dev, flush)
    keyed_row = run("keyed_rng_kernel", phase_keyed_rng_kernel, dev, flush,
                    builds.get("keyed_rng.cu", {}))
    registry_row = run("registry_warm", phase_registry_warm, dev, builds)
    run("serve_f32_exact", phase_exact_f32, dev)
    run("serve_features_f32", phase_features_f32, dev)
    run("serve_chaos_f32", phase_serve_chaos_f32, dev)
    res = run("serve_bf16_full", phase_bf16_full, dev)
    if res is not None:
        main_row, main_args = res
        run("serve_chaos_bf16", phase_serve_chaos_bf16, dev, main_row)
    fleet_row = run("fleet", phase_fleet, dev)
    run("train_f32_exact", phase_train_f32_exact, dev)
    train_row = run("train_bf16_full", phase_train_bf16_full, dev)
    run("t5_f32_exact", phase_t5_f32_exact, dev)
    t5_row = run("t5_train_bf16", phase_t5_train_bf16, dev)
    run("t5_11b_full_depth", phase_t5_11b_full_depth)
    run("materialize_invariance", phase_materialize_invariance, dev)
    rec_dir = run("login_host", phase_login_host, login)
    try:
        mat_row = run("materialize_llama3_8b", phase_materialize_llama3_8b,
                      main_row, rec_dir)
        run("first_step_materialized", phase_first_step_materialized,
            rec_dir)
    finally:
        shutil.rmtree(login[0], ignore_errors=True)
    run("train_mesh_exact", phase_train_mesh_exact, dev)
    sharded_row = run("first_step_sharded", phase_first_step_sharded)
    mixtral_row = run("mixtral_train_bf16", phase_mixtral_train_bf16, dev)
    run("mixtral_materialize_invariance", phase_mixtral_materialize_invariance,
        dev)
    expert_row = run("mixtral_8x7b_expert_shard",
                     phase_mixtral_8x7b_expert_shard)
    run("mixtral_first_step_sharded", phase_mixtral_first_step_sharded)
    remat_row = run("remat_70b", phase_remat_70b, dev)
    vit_row = run("vit_train", phase_vit_train, dev)
    sp_pp = run("sp_pp_ranks", spawn_sp_pp, dev)
    train_sp_row = run("train_sp", phase_train_sp, dev, sp_pp)
    train_pp_row = run("train_pp", phase_train_pp, dev, train_row, sp_pp)
    train_pp_mesh_row = run("train_pp_mesh", phase_train_pp_mesh, dev,
                            train_pp_row)
    moe_sp_row = run("train_moe_sp", phase_train_moe_sp, dev,
                     train_pp_mesh_row)
    sp_ranks = (train_pp_mesh_row or {}).pop("sp_attention_ranks", None)
    if sp_ranks is not None:
        ring_row = run("ring_flash_sp", phase_ring_flash_sp, sp_ranks, dev)
        bias_sp_row = run("ring_flash_bias_sp", phase_ring_flash_bias_sp,
                          sp_ranks)
        run("ulysses_sp", phase_ulysses_sp, sp_ranks)
    ckpt_root = tempfile.mkdtemp(prefix="tdx_ckpt_")
    try:
        usage = shutil.disk_usage(ckpt_root)
        emit({"phase": "checkpoint_disk", "card": smi, "dir": ckpt_root,
              "total_bytes": usage.total, "used_bytes": usage.used,
              "free_bytes": usage.free})
        elastic_row = run("train_elastic", phase_train_elastic, dev, ckpt_root)
        run("reshard", phase_reshard, dev, ckpt_root, elastic_row)
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    if failures:
        return 1
    timing = run("kernels_line", measure, main_args, flush)
    if timing is None:
        return 1
    print(f"device: {smi}", flush=True)
    kernels = [{
        "name": "paged_decode", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": main_row["paged_decode_launches"],
        "max_abs_err": timing["max_abs_err"],
        "ms": timing["kernel_ms"], "kernel_ms": timing["kernel_ms"],
        "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"], "library_ms": timing["library_ms"],
        "shape": {k: timing[k] for k in ("B", "H", "KV", "D", "page", "dtype",
                                         "live_tokens", "table_width")},
        "merge_launches": main_row["paged_merge_launches"],
        "launches_fleet_path": fleet_row["paged_decode_launches"],
        "launches_registry_warm_path":
            registry_row["fleet"]["paged_decode_launches"],
        "cuda_launches_per_call": (main_row["paged_decode_launches"]
                                   + main_row["paged_merge_launches"])
        / main_row["paged_decode_launches"],
        "kernel_graph_ms": timing["kernel_graph_ms"],
        "lane_width_table": timing.get("lane_width_table"),
    }]
    # The flash kernels at the training main path's shape (llama3-8b
    # width, [2, 2048], bf16), launches from its 5-step run; beside them
    # the same kernels with the bias at the T5 main path's encoder shape
    # ([8, 512], 128 heads, bf16), launches from its 4-step run, where
    # d(bias) runs.
    main_flash = flash_rows[("llama3-8b", "bfloat16")]
    vit_flash = flash_rows[("vit-l16", "bfloat16")]
    t5_flash = bias_rows[("t5-encoder-self", "bfloat16")]
    t5_shape = {**t5_flash["shape"], "dtype": t5_flash["dtype"]}

    def numbers(k: dict) -> dict:
        return {"max_abs_err": k["max_abs_err"], "ms": k["kernel_ms"],
                "kernel_ms": k["kernel_ms"], "plain_ms": k["plain_ms"],
                "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
                "library_ms": k["library_ms"]}

    for name, replaces in FLASH_REPLACES.items():
        kernels.append({
            "name": name, "route": "cuda", "source": FLASH_SOURCE,
            "replaces": replaces, "launches": train_row["flash_launches"][name],
            "launches_sharded_path": sharded_row["flash_launches"][name],
            "launches_mixtral_path": mixtral_row["flash_launches"][name],
            "launches_remat_70b_path":
                remat_row["full"]["flash_launches_first_step"][name],
            "launches_vit_l16_path": vit_row["flash_launches"][name],
            "launches_ring_sp_path": {
                "ring_flash_sp_by_rank":
                    [r[name] for r in ring_row["launches_by_rank"]],
                "train_sp_by_rank_per_step":
                    [r[name] for r in train_sp_row["launches_by_rank"]]},
            "launches_pp_path": {
                f"train_pp_{sched}_by_rank_per_step":
                    [r[name] for r in row["launches_by_rank"]]
                for sched, row in train_pp_row["schedules"].items()},
            "launches_pp_mesh_path": {
                **{f"train_pp_mesh_{leg}_by_rank_per_step":
                   [r[name] for r in row["launches_by_rank_per_step"]]
                   for leg, row in train_pp_mesh_row["legs"].items()},
                "one_rank_pp1_fsdp1_tp1_in_5_steps":
                    train_pp_mesh_row["one_rank_nccl"]["flash_launches"][
                        name]},
            "launches_moe_sp_path": {
                "train_moe_sp_by_rank_per_step":
                    [r[name] for r in moe_sp_row["launches_by_rank_per_step"]]},
            "launches_registry_warm_path":
                registry_row["train"]["flash_launches"][name],
            "launches_elastic_path": {
                "drained_run": elastic_row["flash_launches_first"][name],
                "steps_run": len(elastic_row["executed_steps"]),
                "resumed_run": elastic_row["flash_launches_resumed"][name]},
            **numbers(main_flash["kernels"][name]),
            "shape": {**main_flash["shape"], "dtype": main_flash["dtype"],
                      "causal": True},
            "with_bias": {
                "launches": t5_row["flash_launches_with_bias"][name],
                "launches_t5_path": t5_row["flash_launches"][name],
                **numbers(t5_flash["kernels"][name]),
                "library_backend": t5_flash["library_backend"],
                "shape": t5_shape},
            "vit_l16": {
                **numbers(vit_flash["kernels"][name]),
                "library_backend": vit_flash["library_backend"],
                "shape": {**vit_flash["shape"], "dtype": vit_flash["dtype"],
                          "causal": False}},
        })
    kernels.append({
        "name": "flash_dbias", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": DBIAS_REPLACES,
        "launches": t5_row["flash_launches"]["flash_dbias"],
        "launches_ring_sp_path": {
            "ring_flash_bias_sp_by_rank":
                [r["flash_dbias"] for r in bias_sp_row["launches_by_rank"]]},
        "launches_pp_mesh_path": {
            f"train_pp_mesh_{leg}_by_rank_per_step":
                [r["flash_dbias"] for r in row["launches_by_rank_per_step"]]
            for leg, row in train_pp_mesh_row["legs"].items()},
        **numbers(t5_flash["kernels"]["flash_dbias"]),
        "library_backend": t5_flash["library_backend"], "shape": t5_shape,
    })
    # The keyed draws: launches on the materializer's main path (full-depth
    # llama3-8b), times at Mixtral's expert stack.
    keyed = keyed_row["timing"]["normal"]
    kernels.append({
        "name": "keyed_rng", "route": "cuda", "source": KEYED_SOURCE,
        "replaces": KEYED_REPLACES,
        "launches": mat_row["keyed_rng_launches"],
        "launches_mixtral_expert_shard_path": expert_row["keyed_rng_launches"],
        "launches_serve_bf16_path": main_row["keyed_rng_launches_warm"],
        "max_abs_err": keyed["max_abs_err"], "max_ulps": keyed["max_ulps"],
        "ms": keyed["ms"], "kernel_ms": keyed["ms"],
        "plain_ms": keyed["plain_ms"], "bound_ms": keyed["bound_ms"],
        "bound_by": keyed["bound_by"], "library_ms": keyed["library_ms"],
        "library": keyed["library"], "shape": keyed_row["shape"],
        "kind": "normal", "uniform": keyed_row["timing"]["uniform"],
    })
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
