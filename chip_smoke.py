"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--parent DIR]

``--parent DIR`` (an unpacked older checkout, e.g. ``git archive`` of the
parent commit) also times that checkout's depthwise and dense CE kernels
and its f32 and bf16 attention kernels on the same inputs, before and
after this checkout's (rows 11-12 in bf16 and in f32 at all 20 shapes,
9d, 10d, 1, 6, 7 and 8 in f32, 6, 7 and 8 at D 32 and 64, kernel 1 at D
32 at every shape a path gives it and at D 64 at the training shape,
``was_ms``; the f32 depthwise rows also ``now_ms``, this checkout's by
the same function between the two), its decode kernels (rows 2 and 3 at
D 32 at their shapes, the speculative 1k leg's and the CLI's ``--serve``,
and rows 2-5 at D 64 and on f32 caches beside them: ``decode_times:``,
and rows 2-3 at D 32's ``was_ms``), and path (b)'s and path (c)'s steps,
the f32 MobileNet step and one speculative round at 16k with a profile
(``path_b_step:``, ``path_c_step:``, ``mobilenet_f32_step:``,
``spec_16k_round:``, this checkout's between the two).

1. Prints the card's name and power limit, builds the port's CUDA kernels
   from ``distriflow_tpu_torch/csrc`` (one ``nvcc`` per source, all six
   in parallel) and prints the build time, ptxas' registers and spills,
   and (``dwgn_f32_bwd:``, ``dwgn_f32_fwd:``) the f32 depthwise backward's
   and forward's registers and the CTAs an SM holds under each of their
   20 plans.
2. Builds the flagship LM (vocab 32000, d_model 512, 8 heads x 64, 8
   layers, d_ff 2048, max_seq 2048, bf16) from a seeded numpy init carried
   over with ``lm_from_jax``, starts the port's ``InferenceServer`` with the
   default ``ServingConfig`` (paged KV, page 128, 8 slots, decode chunk 8,
   prefix sharing) and sends 8 concurrent requests through the port's
   ``InferenceClient``: prompts of 128, 300, 512 and 1000 tokens, two of
   each, 64 new tokens, six greedy and two sampled; the last one shares a
   256-token prefix (two pages) with an earlier one and joins the running
   batch, so the prefix-sharing path runs.
3. Runs the port's solo ``generate()`` on the card for every request and
   holds every greedy server result against it; a mismatch passes only
   where the top-2 logit margin at the first differing position is below
   0.05 (a near-tie under bf16 rounding).
4. Reads the kernels' launch counts for each path on its own: they are set
   to 0 just before the serving run and read just after it, then set to 0
   again around the solo ``generate()`` calls (the near-tie margins are
   computed outside both windows). Each path must launch exactly its own
   kernels and no other: serving the prefill and the paged decode kernel,
   solo ``generate()`` the prefill and the slab decode kernel.
5. Long context with the int8 KV cache: the same tree at ``max_seq``
   16384 with ``kv_cache_dtype="int8"``. A new server answers 8 concurrent
   ``generate`` requests (prompts 4 x 1024, 8192, 12000 and 16000, 64 new
   tokens, six greedy and two sampled, plus one sharing the first 4096
   tokens of the 8192-token prompt), then one ``beam`` (prompt 8192, 32
   tokens, beam 4) and one ``score`` (16384 tokens from position 8192),
   each in its own launch window: serving must launch the prefill and the
   paged int8 kernel, ``beam`` the prefill and the slab int8 kernel,
   ``score`` only the prefill. Greedy results are held against solo
   ``generate()`` with ``"int8_force"`` (int8 caches on both sides, which
   launches the prefill and slab int8 kernels), under the near-tie rule;
   the beam's tokens and score must be finite and in range; the served
   score must lie within ``SCORE_RTOL`` of ``sequence_logprob`` through
   the plain attention path. One long-context decode iteration is
   profiled as in step 7 (``long_context:`` line).
6. Holds each kernel against its plain PyTorch version at the main path's
   shapes, elementwise within ``atol + rtol * |plain|`` (limits in
   ``TOL``), and times kernel, plain version and a PyTorch library call
   computing the same function (a yardstick only: the port never calls
   it), with CUDA events and the L2 cache flushed before every launch:
   each time is the median of its launches, each behind a device-side
   spin that keeps the host's launch work out of the bracket, with the
   fastest and slowest launch beside it (``<key>_min_max``). The paged
   int8 row also times the paged bf16 and int8 kernels on the same 8 rows
   at contexts 1024, 4096 and 16000 (``by_context``); the slab int8 row
   the B1 shape of long solo ``generate()`` (``long_solo``). Each decode
   row (2-5) also gives the same bits on a second launch, holds the
   contexts where splits begin and end and a row of length 0 beside live
   rows (``edges_max_abs_err``), rejects a combine without the exp(m_i -
   M) rescale and one without the split holding the max
   (``rejected_share``), and is held and timed at 1, 2 and 4 tiles a split
   (``by_split_tiles``).
7. Profiles one engine decode iteration (8 slots, chunk 8) with
   ``torch.profiler``: host wall time, device busy time, the device's idle
   share and the kernels that took the most device time.
8. Trains the flagship LM (the same seeded flax-shaped tree, carried over
   as f32 masters) with the port's ``SyncTrainer`` (adam, lr 1e-3, the
   fused sparse CE) on one fixed seeded batch of B=8 x S=1024 tokens for
   20 steps, with the launch counts read in a window of their own: each
   step must launch the flash forward and backward kernels 8 times each
   and the CE forward and backward once each, and no decode kernel; no
   other window may show a backward or CE launch. Prints a
   ``training:`` line (step ms p50/max, tokens/s, first and last loss);
   every loss must be finite and the last at least ``LOSS_FALL`` below
   the first.
9. Takes one step's loss and every parameter's gradient twice from the
   same masters and batch, once through the kernels and once through the
   plain path (``use_flash_attention=False``, plain sparse CE), and holds
   them within ``STEP_TOL`` (``step_vs_plain:`` line).
10. Profiles one training step with ``torch.profiler``
    (``training_step_profile:`` line), the counterpart of step 7.
11. MobileNetV2 at the fused configuration of the JAX repo's
    ``bench_mobilenet`` through its CLI's defaults (96 px, 100 classes,
    width 1.0, GroupNorm, bf16, ``depthwise_impl="fused"``,
    ``with_uint8_inputs`` + sparse CE, momentum 0.05, B 256), from a
    seeded flax-shaped tree carried over by ``mobilenet_params_from_jax``:
    20 steps through ``run_chunked`` over ``sampling_iterator`` +
    ``prefetch_to_device`` on data made by the JAX repo's
    ``synthetic_imagenet`` recipe, then ``evaluate_dataset`` on 512
    validation images, each in a launch window of its own: exactly 17
    depthwise forward and 17 backward launches per step and 17 forward
    launches per evaluation chunk, and no other kernel (``mobilenet:``
    line: step ms, samples/s, losses, validation loss and accuracy; the
    mean of the last 5 losses must lie below that of the first 5). One
    step through the kernels is held against one through their plain
    versions within ``MN_STEP_TOL`` (``mobilenet_step_vs_plain:``), and one
    step is profiled (``mobilenet_step_profile:``).
12. Rows 11 and 12 (the depthwise kernels) hold every one of the step's
    10 depthwise shapes at B 256 against the plain versions (the forward
    bit for bit, asserted) and time the largest-bytes (48x48x96 stride 2)
    and the smallest (3x3x960) shape against the plain versions, the
    bound and the three-call library composition; ``step_ms_all_blocks``
    sums the kernel over the 17 blocks of a step. Each shape gives the
    same bits on a second launch (y; dx, dw, dscale, dbias) and prints
    its plan (``by_shape``: channel chunk, cluster, tile, images a CTA,
    CTAs, shared memory). Row 11 shows that a forward whose statistics
    come from the cluster's rank-0 tile alone fails its limit, row 12
    that a backward without the GroupNorm statistics' gradient terms
    does. Then MobileNetV2 at its default f32 (``mobilenet_f32:`` line),
    the model JAX builds as written: (a) step 11's recipe with the dtype
    left alone, in windows ``mobilenet_f32_train`` and
    ``mobilenet_f32_eval`` (exactly 17 f32 depthwise forward and 17 f32
    backward launches a step, 17 f32 forward launches a chunk, no bf16
    depthwise launch; step 11's windows show no f32 launch), the losses
    falling, the step p50, samples/s, peak memory, the value of
    ``torch.backends.cudnn.allow_tf32`` the convolutions ran under, and
    one profiled step; (b) one step against the plain depthwise versions
    within ``MN_F32_STEP_TOL``; (c) 224 px (1000 classes, B 64, 3 steps,
    ``mobilenet_f32_224``: 17 + 17 f32 launches a step, every loss
    finite). Rows ``depthwise_gn_fwd_f32`` and ``depthwise_gn_bwd_f32``
    hold all 10 shapes at 96 px (B 256) and all 10 at 224 px (B 64)
    against the plain versions and the banded mirror of the f32 plan
    (``differ_share``: the share of elements not bit for bit), time each,
    and time the plain versions and the library composition (TF32 off) at
    each resolution's largest-bytes and smallest shape; the planted
    faults of the f32 kernels' own designs are rejected: a forward whose
    statistics come from one position slice of each channel alone
    (``stats_from_slice0_only``), a backward without the statistics'
    gradient terms, dw from one position slice alone
    (``dw_from_slice0_only``); and the f32 forward holds a shape no
    resident cut fits (``DWGN_F32_STREAMED``, a streamed plan) bit for bit.
13. Long-context training: the flagship at max_seq 16384 with
    ``remat=True`` (the JAX CLI ``experiments/lm/train.py --seq 16384
    --remat`` at the flagship's dims; B 1 where the CLI defaults to 8),
    adam 1e-3, the fused sparse CE, 10 steps on random windows of the
    CLI's order-1 Markov corpus, in a launch window of its own
    (``long_training``): per step 16 flash forward launches (8 layers and
    their 8 recomputations under remat), 8 dQ and 8 dK/dV launches (the
    two-kernel backward: at S 16384 JAX's tiles give 16 KV blocks), one
    CE forward and one backward, and no fused backward; the S 1024
    ``training`` window must launch no dQ or dK/dV kernel. Prints
    ``long_training:`` (step ms p50/max, tokens/s, losses, peak memory);
    losses finite, the mean of the last 3 below that of the first 3.
    ``long_step_vs_plain:`` holds one 16k step through the kernels against
    the plain path within ``STEP_TOL``; ``long_training_step_profile:``
    profiles one step. ``obs/cuda_hooks.py`` is installed on the
    training's telemetry: a snapshot's ``device_peak_bytes{device=cuda:0}``
    must equal ``torch.cuda.max_memory_allocated(0)`` (``memory_gauge``).
14. The CIFAR-10 ConvNet (BASELINE config #2 as the JAX repo's
    ``bench.py::bench_cifar_sync`` runs it: ``cifar_convnet`` in bf16, B
    2048, sgd 0.01) with ``loss="fused_softmax_cross_entropy"`` on one-hot
    f32 targets, from a seeded flax-shaped tree carried over by
    ``zoo_params_from_jax``: 30 steps through ``run_chunked`` over
    ``sampling_iterator`` + ``prefetch_to_device`` on the JAX repo's
    ``synthetic_cifar10`` recipe (4096 train), then ``evaluate_dataset`` on
    its 512 validation images, in windows ``convnet_train`` (exactly one
    dense CE forward and one backward launch per step, no other kernel)
    and ``convnet_eval`` (one dense forward per chunk: ``evaluate``
    computes the loss). Prints ``convnet:`` (step ms, samples/s, losses,
    validation loss and accuracy; the mean of the last 5 losses below the
    first 5), ``convnet_step_vs_plain:`` (against the plain
    ``softmax_cross_entropy``, within ``STEP_TOL``) and
    ``convnet_step_profile:``.
15. Rows 7 and 8 (the dQ and dK/dV kernels) at B1 H8 S16384 D64 causal,
    from one forward's lse and delta shared by kernel and plain version;
    each must give the same bits on a second launch, and the limit must
    reject a dQ without the delta term and a dK without the scale; both
    are also held at S 37 and 1000 (lengths that end inside a tile),
    causal and not (``ragged_max_abs_err``). Row 6 (the fused backward)
    gets the same checks at the training shape (B8 H8 S1024) and, beyond
    them, is held and timed at B1 H8 S8192 (``longest_fused``: the fused
    layout's longest S and its largest dQ partial buffer). Rows 9d and 10d (the
    dense CE) at the ConvNet's N 2048 x V 10 one-hot, at the wire's and
    FedAvg's N 256 and 128, under ``large`` at N 8192 x V 32000 with soft
    targets (one block a row), and on the narrow layout's edges: a
    partial last tile (N 2047), a base 20 bytes in (a [1:] view, N 2049)
    and G 16 and 32 (V 100 and 256). Each shape is held against the plain
    versions and gives the same bits twice; at G > 1 the limits must
    reject a forward whose lse takes only lane 0's columns and a backward
    whose lse misses the row max. Rows 9 and 10 are also held at N 2048 x
    V 10 (``narrow``). Every row carries ``floor_ms``, an empty kernel
    (``torch.cuda._sleep(0)``) timed in the same bracket.

16. The wire-training planes (``wire_training:`` line): the ConvNet of
    step 14 (bf16, the fused dense CE, f32 masters from the same seeded
    tree) trained by the port's servers and in-process port workers over
    loopback TCP, each leg in a launch window of its own in which every
    worker ``fit`` must launch kernels 9d and 10d exactly once and nothing
    else runs. (a) ``AsynchronousSGDServer`` with two
    ``AsynchronousSGDClient`` threads at BASELINE #3's CLI defaults (B 256,
    momentum 0.05, ``maximum_staleness`` 4) over 4096 synthetic images for
    2 epochs: every one of the 32 batches applied, rejected or suppressed,
    the dataset exhausted, the fit losses falling, validation accuracy in
    [0, 1]; the lowest validation loss of the server's versions 9-16 (the
    first epoch's second half) below the initial weights' by more than
    their spread over four slices, as leg (b) of step 17 holds it (a
    server that applies nothing fails this); updates/s, samples/s, each
    phase's p50 and max and the staleness histogram. (b) One worker, 16 batches, full broadcasts
    (``delta_broadcast`` off, cuDNN deterministic): the server's final
    weights equal, bit for bit, one model that fits and updates on the same
    batches in the server's dispatch order, and differ from the reversed
    order. (c) ``FederatedServer`` (``min_updates_per_version`` 2) with two
    ``FederatedClient``s of 1024 local images (one uploading int8 with
    error feedback), 4 rounds, each waiting for both workers to install
    the new version: 4 versions, nothing dropped, the loss falling, the
    native host kernels built.

17. The in-process trainers on the same ConvNet (``inprocess_training:``
    line), each leg in a launch window of its own in which every batch
    (every FedAvg local step) launches kernels 9d and 10d exactly once and
    nothing else runs. (a) ``AsyncSGDTrainer`` at the JAX repo's
    ``bench.py::bench_cifar_async`` configuration (B 256, K 8 batches an
    upload, 96 batches, 4 workers, ``maximum_staleness`` 2,
    ``staleness_decay`` 0.7, sgd 0.01, ``stage_dataset``,
    ``inflight_window`` 2; two warm K-groups through ``worker_loop(0)``,
    the second profiled, before the timed ``train(4)``): every batch
    applied or rejected, none rejected, the dataset exhausted, the
    validation loss below the initial weights' by more than their spread
    over four slices; samples/s, updates/s, ``phase_ms`` against the wall,
    the staleness histogram, MFU per batch. (b) The CLI's defaults (B 256,
    K 1, 2 workers, momentum 0.05, ``maximum_staleness`` 4), one epoch:
    the final params equal a replay of the recorded apply schedule (each
    batch's gradient at its recorded version) bit for bit; the lowest
    validation loss of the epoch's second half, for the run and for a
    staleness-0 replay of its order, below the initial weights' by more
    than their spread; every version's validation loss reported for both
    (and for the replay on a second dataset). (c) One worker, K 1,
    16 batches: bit for bit against a ``SpecModel`` replay in the dispatch
    order, the reversed order told apart, a snapshot taken mid-run
    unchanged by later applies. (d) ``FederatedAveragingTrainer`` at
    ``bench.py::bench_fedavg``'s configuration (K 8, B 128, sgd 0.01) at 1
    and 4 workers, 3 rounds each: round losses falling, the 4-worker
    first round equal bit for bit to the fixed-order mean of 4 solo runs,
    round ms and samples/s, one more round profiled. (b)-(d) run with
    cuDNN deterministic. (e) ``cost_analysis`` and ``mfu`` of the
    ConvNet's B 2048 step and of the 16k remat LM step at their measured
    p50: the kernel tally added once and equal to the analytic cost of the
    path's kernels, the MFU finite and positive.

18. Speculative decoding (``speculative:`` line) at the JAX repo's
    ``bench.py::bench_serving_speculative`` recipe: the target (vocab
    32000, d_model 256, 4 heads x 64, 4 layers, d_ff 1024, max_seq 16384,
    bf16) and ``draft_config_for("lm_draft", target)`` (2 layers, d_model
    128, 4 heads x 32, d_ff 512, bf16, on the kernels' head-dim-32
    builds), both from seeded flax-shaped trees. The draft is first
    distilled on the card (``spec_distill:`` line): 50 Adam steps at 4e-3,
    f32 through the plain path, on the target's greedy trajectory of the
    1k prompt. Then a speculative server (k 4) and a plain paged server,
    each with 4 slots, pages of 128, a pool of 4 x pages_per_slot and
    prefix sharing off, answer greedy B 1 requests of 96 new tokens at
    contexts 1024 and 16384 (prompts 928 and 16288), each in a launch
    window of its own: the speculative window must launch the prefill at
    D 64 (the target) and at D 32 (the draft), the paged decode kernel at
    D 32 exactly rounds x (k + 1) x 2 times and never at D 64; the plain
    window the prefill and paged decode at D 64 only. ms/token is the
    96-token request's time less a 1-token request's, over 95 tokens. The
    speculative output must equal the plain output under the near-tie
    rule of step 3; sampled speculative requests with one seed must agree
    and with another differ; both pools must end all free with zero
    refcounts. The draft's own solo ``generate()`` (kernels 1 and 3 at D
    32 only) is held against its plain path, and a ``draft_model="self"``
    leg on the flagship 2k config against solo ``generate()``, with
    acceptance at least ``SPEC_SELF_ACCEPT``. One round at each context is
    profiled (``round_profile``, with the decode kernels' device ms).
    Rows 2 and 3 at D 32 (one cluster launch, ``d32::decode_kernel``) also
    give the same bits at every cluster size from 1 to
    ``D32_CLUSTER_MAX`` (``by_cluster``, each timed), and on row 2 a
    combine that skips the last rank's partials falls outside the limit
    (``last_rank_fault_share``), paged decode at pages of 128 equals slab
    decode bit for bit at the edges' contexts, and the card's clusters at
    once are read (``clusters_at_once``).
19. The roofline (``roofline:`` line): ``ops/roofline.py``'s projection
    of the ConvNet's B 2048 step and the 16k remat LM step from their
    ``cost_analysis`` (step 17 (e)), ``bound_by``, the projected step and
    ``model_error`` against the measured p50, and this run's calibration
    of each efficiency (bound over time of the kernel-table rows it is
    taken from, and of one cuBLAS matmul at [16384, 512] x [512, 512]).
20. The serving fleet (``fleet:`` line), on step 18's target (vocab
    32000, d_model 256, 4 heads x 64, 4 layers, d_ff 1024, bf16, from a
    seeded flax-shaped tree; max_seq each leg's context plus its new
    tokens): port ``InferenceServer`` replicas in this process, each with
    its own page pool and scheduler thread, behind the port's
    ``FleetRouter``, each leg in launch windows of its own in which
    kernel 1 must launch 4 times a fresh prefill and kernel 2 4 times a
    decode step, as the replicas' own counters give them, at D 64 only.
    (a) ``bench.py::bench_serving_fleet``'s defaults: 2 replicas (page
    128, 6 slots, a pool of 3 x 7 + 2 x 9 pages, window 0.05 s), 6 users
    re-sending their own 1024-token prompt for 64 greedy tokens, a cold
    wave and 2 warm waves, under ``round_robin`` then ``affinity``: warm
    tok/s per user, their ratio, prefix hit rates,
    ``router_affinity_hits_total``; every routed output equal, bit for bit,
    to its replica's answer to the same ``request_id`` asked directly, and
    held against solo ``generate()`` under the near-tie rule (window
    ``fleet_solo``: kernels 1 and 3). (b) ``bench_serving_elastic``'s
    defaults: 3 replicas A/B/C on the ring (page 64, 2 slots, a pool of 36
    pages, window 0.02 s, chunk 8), 512-token prompts and 16 new tokens;
    8 tier-0 requests on A's arc with A's window stretched to 1 s,
    unhedged, then hedged at 25 ms (hedged p50 below unhedged, every
    hedge's loser cancelled on its replica); B drained and undrained under
    traffic (goodput 1.0); the remap fractions of ``HashRing(256)``
    (``ELASTIC_REMAP``). (c) 2 replicas and the router on one telemetry
    with the timeline sampling every 0.1 s, B drained as the warm standby:
    6 sequential idle tier-0 requests (1024 tokens, 64 new) give the TTFT
    p99; a sustained band at twice that (3 samples) feeds a
    ``HealthSentinel``, and ``FleetAutoscaler`` (cooldown 2 polls,
    scale-in after 4 clean ones) polls every 0.25 s while 12 tier-0
    requests arrive at once: it must undrain B during the burst, drain
    the coldest arc after it, and act never inside a cooldown. Every
    replica's pool ends all free. Row ``flash_decode_paged_p64`` holds
    kernel 2 at the elastic leg's page 64 (B 2, H 4, contexts 1-528).
21. The port's doctor (``doctor:`` line): ``distriflow_tpu_torch.doctor.
    main(["--device", "cuda"])`` in this process, in a launch window of its
    own (``doctor``): it must exit 0 with "all checks passed" and every one
    of its 22 checks ``ok``; the line holds each check's wall seconds and
    the window's kernel 2 and 3 launches. Its LM drills (head dim 64,
    bf16, pages of 16) must launch the paged decode kernel and solo
    ``generate()``'s slab decode kernel, and no other kernel (kernel 1 not
    at all: the drills use the plain prefill attention). Row
    ``flash_decode_paged_p16`` holds kernel 2 at the drills' page 16 (B 2,
    H 4, contexts 1-48; a split spans 16 pages), with the split edges at
    page 16 and, on rows of 700 and 300, the wrong combines rejected and
    the split sweep.
22. The port's static analysis (``analysis:`` line, right after the
    build): ``distriflow_tpu_torch.analysis.run_checks`` over the port's
    package with its four families (lock, obs, wire, resource) and the
    port's ``analysis/baseline.json``. Any finding the baseline does not
    hold, any stale baseline entry, or a source file that does not parse
    fails the run; the line holds the findings, baselined and stale
    counts, the families, the files parsed and the wall seconds.
23. Live wire payloads held to the port's ``comm/schema.py::
    check_payload`` (``payloads:`` line): every ``generate``/``beam``/
    ``score`` request and ack of the serving phases' clients (step 2 and
    step 5), with each ack's ``serving_meta``; in the wire phase (step
    16) every telemetry report a client's ``ReportBuilder`` builds and
    every ``dftp_leaf`` of every dftp-flat blob serialized (the dense and
    the int8 uploads of CUDA gradients, the CUDA weight downloads), then
    one top-k blob of the ConvNet's CUDA parameters (f32 and int8 values,
    the sparse ``since=2`` fields). A payload that fails its schema fails
    the run; every payload name must be seen at least once.
24. The training layouts on ``torch.distributed`` (``mesh:`` line): a
    world of 4 ranks on this card (spawn, ``gloo``: NCCL refuses two
    ranks on one device; ``parallel/collectives.py`` stages each
    collective of a CUDA tensor through the host and counts the bytes),
    started by ``parallel.initialize``, at the flagship's widths cut to 2
    layers, adam 1e-3, 3 steps a leg on the LM corpus's windows, from one
    seeded flax-shaped tree: (a) ``dp4`` ``{data 4}``, B 8 S 1024,
    ZeRO-2; (b) ``dp2_tp2`` ``{data 2, model 2}``, Megatron TP
    (``TRANSFORMER_TP_RULES``), ZeRO-1; (c) ``ring`` ``{seq 4}``, B 1 S
    16384 with remat, ring attention (kernel 1 at chunk 4096); (d)
    ``ulysses``, the same, Ulysses attention (kernel 1 at S 16384 on 2
    local heads); (e) ``ep``, bench_moe's top-2 shape (8 experts) on
    ``{data 2, expert 2}``; (f) ``fedavg_mesh``, the ConvNet's FedAvg, one
    worker a rank (K 4, B 128, 2 rounds). Every rank's window must launch
    exactly the kernels ``_mesh_windows`` works out from layers x ring
    steps x remat (windows ``mesh_<leg>``); every leg is held against one
    rank on the card from the same tree and batches (``MESH_TOL``: the
    loss, and each parameter's update relative to the reference's, a
    limit a planted dropped data rank must exceed; FedAvg bit for bit;
    the EP reference routed as the mesh routed), a ZeRO
    rank's optimizer state for each leaf it slices must be the replicated
    bytes / ``data``, and a rank that fails fails the run. The line holds
    each leg's backend, host-staged bytes, step p50 of every rank (4
    ranks sharing one H100 over gloo: not a multi-card figure), errors
    against the reference, and each collective's latency at 4 MB. Row 1
    holds kernel 1 at the legs' new shapes: the ring's off-diagonal
    chunk pair (``ring_chunk``, B1 H8 S4096 non-causal, O and lse) and
    Ulysses' local heads (``ulysses_local_heads``, B1 H2 S16384).
25. The Keras import (``keras:`` line): step 14's ConvNet written as a
    tfjs-layers Sequential ``model.json`` (conv 3x3 same 64/128/256 with
    ReLU and 2x2 max pools, dense 256 ReLU, dense 10 softmax) with step
    14's tree exported by ``export_keras_weights``: (a) ``fetch_model``
    of the path in bf16 with the fused dense CE, trained at step 14's
    recipe (the trailing softmax stripped, every loss within
    ``KERAS_LOSS_TOL`` of the zoo ConvNet's, windows ``keras_train`` 30
    + 30 launches of 9d/10d and ``keras_eval`` 1); (b) the same file
    from a loopback ``http.server``, its parameters and logits equal to
    the path's bit for bit; (c) an async-SGD server from the path and
    two workers, one on the URL's model (bf16) and one handed the bare
    URL (its own ``fetch_model``: f32, the plain CE), one epoch of the
    wire phase's images: every batch applied exactly once, the server's
    validation loss lower by more than its spread, every payload checked
    (``payloads:`` phase ``keras``) and the blobs' leaves named by the
    Keras tree, window ``keras_wire`` one launch each a bf16 fit; (d) the
    trained parameters exported and reloaded bit for bit.
26. The streaming token dataset (``streaming:`` line): 1,048,576 tokens
    of the LM CLI's Markov corpus at vocab 32000 written by
    ``write_token_file`` (uint16), the flagship at B 8 S 1024 (sgd)
    trained from ``StreamingTokenDataset`` 10 steps, a ``save_model``
    checkpoint and the cursor ``state()``, 10 more steps (window
    ``streaming_train``); a fresh trainer from ``load_model`` and a fresh
    dataset from ``restore`` replay the last 10 (``streaming_resume``):
    the batches bit for bit, and the losses, or the parameters whose
    gradients differ between two identical steps are named; two
    processes' shards disjoint and covering the epoch but their last
    partial batches. Each window launches kernels 1 and 6 8 times a step
    and 9 and 10 once.
27. Speculative serving over a TP mesh and the mesh's cost (in the
    ``mesh:`` line): the same world serves step 18's target on ``{data
    2, model 2}`` (2 local heads a rank) from its seeded tree, with step
    18's distilled ``lm_draft`` (whole on every rank) at k 4 on the 1k
    prompt (``tp_spec``: a greedy B 1 request of 96 tokens, ms/token,
    acceptance, two sampled requests of one seed and one of another), a
    plain TP server on the same request (``tp_plain``) and the self-draft
    (``tp_spec_self``, acceptance at least ``SPEC_SELF_ACCEPT``); the
    speculative outputs held to the plain server's under the near-tie
    rule, the caches' head widths, the pools reconciled, every window
    exact on every rank (kernel 1 at D 64 and D 32 once a layer a fresh
    prefill, kernel 2 at D 32 rounds x (k + 1) x 2, never at D 64 with
    ``lm_draft``), and a planted fault (one follower's drafts altered
    before the verify) that must stop every rank with rank 0 naming it.
    Each ``dp4`` and ``dp2_tp2`` rank reports ``cost_analysis`` (its own
    shard's micro-batch) and ``mfu`` at its step p50 (4 ranks sharing
    one card over gloo, over one card's peak: not a multi-card figure),
    its kernel tally equal to the analytic cost of its launches.
28. The JAX LM CLI's own model (``lm_cli:`` line): ``experiments/lm/
    train.py`` at its defaults (vocab 256, d_model 256 over 8 heads of 32,
    4 layers, d_ff 1024, bf16, adam 3e-3, the fused sparse CE) from a
    seeded flax-shaped tree, on B 8 windows of its Markov corpus, each
    path in launch windows of its own with exact counts: (a) the defaults
    at S 512, 20 steps (``lm_cli_train``: kernels 1 and 6 at D 32 4 times
    a step, 9 and 10 once), then its ``--generate 64`` from a 32-token
    prompt of the held-out tail (``lm_cli_generate``: kernel 1 at D 32
    once a layer, kernel 3 at D 32 63 times a layer) and ``--serve``, 4
    greedy requests through ``InferenceServer`` (``lm_cli_serve``: kernel
    1 once a layer a prefill, kernel 2 once a layer a decode step, both
    at D 32), the served streams held against solo ``generate()`` under
    the near-tie rule; (b) ``--seq 16384 --remat`` at B 8, 4 steps
    (``lm_cli_long``: kernel 1 twice a layer a step, kernels 7 and 8 at D
    32 once); (c) ``--dtype float32`` at S 512, 20 steps
    (``lm_cli_f32``: kernels 1 and 6 in f32 at D 32, 9 and 10 on f32
    logits, the counts of (a)), then its ``--generate 64``
    (``lm_cli_f32_generate``: kernel 1 in f32 once a layer, kernel 3 on
    the f32 slab 63 times a layer, no bf16 decode) and ``--serve`` at
    page 128 (``lm_cli_f32_serve``: the 4 greedy requests, a beam of 16
    tokens and a score of a 512-token window; kernel 1 in f32 once a
    layer a prefill, kernel 2 on the f32 pool once a layer a decode step,
    kernel 3 once a layer a beam step after the first), every served
    greedy stream equal to solo f32 ``generate()`` bit for bit (pages of
    128 split as slab tiles), the beam under the near-tie rule, the score
    within ``SCORE_RTOL`` of the plain attention path; an f32 paged cache
    at page 16 (where JAX decodes in true f32 through XLA) refused by
    name; (d) ``--dtype float32 --seq 16384 --remat`` at B 8, 3 steps
    (``lm_cli_f32_long``: kernel 1 in f32 twice a layer a step, kernels 7
    and 8 in f32 once, 9 and 10 on f32 logits once a step; losses, step
    p50 and peak memory reported, and one more step under
    ``torch.profiler``: device time by kernel, idle share). Each path's
    losses fall, and one step
    through the kernels is held against the plain path within
    ``STEP_TOL`` (paths (b) and (d) on the batch's first row: the plain
    path's [S, S] scores). Rows ``flash_attention_bwd_d32``,
    ``flash_attention_dq_d32``, ``flash_attention_dkv_d32``,
    ``flash_attention_fwd_f32``, ``flash_attention_bwd_f32`` (and D 64
    beside them; kernel 6 in f32 holds dK and dV against the plain
    version and dQ against its recipe in f64, ``exact``, at both head dims
    and on ragged lengths, with SDPA's f32 backward on its math and
    memory-efficient backends beside it), ``fused_ce_fwd_f32``,
    ``fused_ce_bwd_f32`` (N 4096 x V 256, and V 32000 beside them),
    ``fused_ce_dense_fwd_f32``,
    ``fused_ce_dense_bwd_f32`` (no path runs them),
    ``flash_decode_f32`` (B1, the CLI's f32 slab of 512; D 64 at B1
    S2048, 1064 valid), ``flash_decode_paged_f32`` (the serve leg's slots
    at page 128; D 64 at row 2's B8 H8 shape), ``flash_attention_dq_f32``
    and ``flash_attention_dkv_f32`` (B8 H8 S16384 D32; D 64 at B1 H8
    S16384; dQ also held against its recipe in f64, ``exact``), and
    ``flash_attention_fwd_f32_long`` (kernel 1 in f32 at path (d)'s B8 H8
    S16384 D32, held head by head) hold each new variant at its path's
    shape: the limit, the same bits twice, planted faults rejected, ragged
    lengths (the attention rows; the f32 forward's at D 64 too), and its
    time beside its bound, its plain version (f32 with TF32 off) and a
    library call. The ``nan_checks:`` line holds that a NaN in q, k or v
    reaches the same outputs of the attention kernels as of their plain
    versions: the forward and the two-kernel backward in bf16 and f32 at
    D 32 and 64, and the f32 fused backward; and of the fused CE forward
    on a NaN logit (sparse and dense, bf16 and f32, V 256 and 32000, the
    label's column and another) and decode on bf16, f32
    and int8 caches (a NaN in q or in one live K position, paged and
    slab); each row it covers carries its result (``nan_reaches``). Row
    ``flash_attention_fwd_d32`` also holds and times kernel 1 at path
    (b)'s shape (``path_b``: B8 H8 S16384 D32, head by head against the
    plain version, SDPA beside it, the atol O and lse need, two planted
    faults rejected: the correction held at 1 and lse without log(l)),
    at path (a)'s (``path_a``: B8 H8 S512) and at ragged lengths that end
    inside its 128-row Q tile (``ragged``). The rows of kernels 7 and 8
    (bf16, D 32 and 64) hold each gradient under an atol by element that
    adds two flips of a bf16 P or dS (``flip_limit``; ``atol_needed`` is
    the scalar atol it needs).

The kernel table holds every kernel at its path's shapes (the three
training kernels at B8 H8 S1024 D64 and N 8192 x V 32000, the int8 ones
at the long phase's rows); the flash forward, which runs on every path,
is also held and timed at the training shape (its row's
``training_shape``) and at B1 H8 S16000 (``long_context``), and held at
S 1, 37, 512 and 1000, causal and not (``checks``), each giving the same
bits on a second launch. Rows 1-3 are also held at head dim 32, the
draft's (``*_d32``): kernel 1 at B1 H4 S1024 and S16288, kernel 2 at the
draft's contexts over the 4 slots, kernel 3 at the draft's solo shape,
each with its D 64 row's checks. Each row's
``launches_by_path`` gives its count in every window. The line
before the last is the kernel table as JSON (35 rows); the last line is
``{"ok": true, "device": {...}}``. Any failure exits non-zero. Without a
CUDA device the script exits 1 before doing anything.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

SEED = 0
N_TOKENS = 64
TRAIN_STEPS, TRAIN_B, TRAIN_S = 20, 8, 1024
# Kernel vs plain version, elementwise: |kernel - plain| <= atol + rtol * |plain|.
# rtol 2**-7 is one bf16 rounding step of the output (8 significant bits).
# The split-KV decode kernels and their plain versions cut a row into the
# same splits, round p to bf16 against the same split max, and combine the
# live splits in the same ascending order with each product and sum rounded
# on its own; what differs is the order of the f32 sums inside a split (per
# lane group in the kernel, one einsum in the plain version) and expf
# against torch.exp, a few f32 ulps of acc and l, so only a rounding flip
# of the bf16 output separates them (measured 0.0 to 9.8e-4, one bf16
# step at |o| ~ 0.2, on the H100). The prefill plain version rounds p against the row's final max,
# the kernel against its running tile max, which adds up to ~2**-9 of |o|
# before the output rounding: atol 2e-3 covers it. lse is f32 and sums the
# same f32 p in both.
# The flash backward rounds P and dS to bf16 like its plain version, but
# from scores summed in another order, so a rounding flip of P or dS can
# move dQ/dK/dV by more than one output step: see the dQ and dK/dV
# kernels' limit below, which the fused kernel shares. The CE forward sums f32 exps in another
# order (measured 9.5e-7 on lse ~ 11); the CE gradient differs only by a
# rounding flip of the bf16 output, which rtol 2**-7 covers. Its row draws
# the upstream gradient g of order 1, so that the softmax term p * g
# (~1e-5 for V=32000) of every column lies far above atol 1e-8 and is
# held to rtol, not only the label column; the row also checks that
# gradients missing the softmax term, with it doubled, or from an lse off
# by 0.05 fail this limit.
# The int8 decode kernels take the exact int dot (dp4a) and the f32
# products in the plain version's order, and round p * v_scale to bf16
# where it does, against the same split max, so the same f32 sums and exps
# differ: the limit of the bf16 decode kernels. Both limits must reject a
# combine without the exp(m_i - M) rescale and one without a row's last
# live split (each decode row's ``rejected_share``).
TOL = {"flash_attention_fwd": (2e-3, 2 ** -7),
       "flash_decode_paged": (1e-5, 2 ** -7),
       "flash_decode": (1e-5, 2 ** -7),
       "flash_decode_paged_int8": (1e-5, 2 ** -7),
       "flash_decode_int8": (1e-5, 2 ** -7),
       "flash_attention_bwd": (5e-3, 2 ** -7),
       "fused_ce_fwd": (1e-5, 1e-6),
       "fused_ce_bwd": (1e-8, 2 ** -7),
       "depthwise_gn_fwd": (1e-5, 2 ** -7),
       "depthwise_gn_bwd": (1e-5, 2 ** -7),
       # the two-kernel backward (D 64 and D 32) adds BWD_FLIPS flips by element, see below
       "flash_attention_dq": (1e-3, 2 ** -7),
       "flash_attention_dkv": (1e-3, 2 ** -7),
       "fused_ce_dense_fwd": (1e-5, 1e-6),
       "fused_ce_dense_bwd": (1e-8, 2 ** -7),
       # the D 32 builds keep their D 64 rows' limits
       "flash_attention_bwd_d32": (5e-3, 2 ** -7),
       "flash_attention_dq_d32": (1e-3, 2 ** -7),
       "flash_attention_dkv_d32": (1e-3, 2 ** -7),
       # f32 end to end: 1e-5 relative, beside an atol for elements near 0
       "flash_attention_fwd_f32": (1e-6, 1e-5),
       # kernel 6 in f32: dK and dV; its dQ is held to
       # flash_attention_dq_f32_exact, see below
       "flash_attention_bwd_f32": (8e-6, 1e-5),
       "fused_ce_fwd_f32": (1e-6, 1e-5),
       "fused_ce_bwd_f32": (1e-8, 1e-5),
       "fused_ce_dense_fwd_f32": (1e-6, 1e-5),
       "fused_ce_dense_bwd_f32": (1e-8, 1e-5),
       # the f32 decode kernels: this f32 order term plus two flips of p
       # per (row, head), see F32_DECODE_FLIPS below
       "flash_decode_f32": (1e-6, 1e-5),
       "flash_decode_paged_f32": (1e-6, 1e-5),
       # the f32 two-kernel backward, see below
       "flash_attention_dq_f32": (1e-6, 1e-5),
       # f32 dQ against its recipe in f64, see below
       "flash_attention_dq_f32_exact": (7e-6, 1e-5),
       "flash_attention_dkv_f32": (2e-5, 1e-5),
       # the f32 depthwise kernels, see DWGN_F32_SUM_RTOL below
       "depthwise_gn_fwd_f32": (1e-6, 1e-5),
       "depthwise_gn_bwd_f32": (1e-6, 1e-5)}
# The f32 kernels (attention forward and fused backward, the CE on f32
# logits) add f32 terms in another order than their plain versions, with
# no rounding to a narrower type anywhere: an element differs by a few f32
# ulps of the sums that made it (measured at most 9.6e-7 on values of
# order 1 on the H100, under atol 1e-6 + rtol 1e-5). Their plain versions
# run with TF32 off (torch.backends.cuda.matmul.allow_tf32 and
# torch.backends.cudnn.allow_tf32 False), else the yardstick would keep 10
# mantissa bits; each f32 row reports the share of elements a TF32 plain
# version puts outside the limit.
# The backward kernels (fused, dQ, dK/dV) round P and dS to bf16 as their
# plain versions do and add in another order. The dQ and dK/dV kernels
# started from the fused kernel's old limit (atol 5e-3, when its dQ was
# summed with atomics) and were tightened to atol 1e-3: at B1 H8 S16384 the
# largest atol any element needed above rtol 2**-7 was 3.2e-4 (dQ), 1.9e-4
# (dK) and 1.1e-4 (dV) on the H100, against gradients of median 0.008-0.013
# that atol 5e-3 would hold to less than 40%. The fused kernel, rebuilt
# with write-once dQ partials summed in a fixed order, keeps atol 5e-3:
# its elements needed up to 1.7e-3 above rtol 2**-7 at the training shape
# B8 H8 S1024 (a dV two bf16 steps off, where a rounding flip of P and the
# output's own rounding add up), more than atol 1e-3 allows, and 4.0e-4 at
# B1 H8 S8192; 5e-3 keeps about the 3x margin that 1e-3 has over rows
# 7-8's need (row 6's ``atol_needed_by_check`` gives each run's). No
# backward kernel uses atomics, so each gives the same bits every launch.
# The bf16 two-kernel backward (kernels 7 and 8, at D 64 and at D 32) is
# held around its plain versions with an atol by element (C16). A
# kernel's P is its own exponential (ex2 at D 32, expf at D 64) of the
# plain version's argument, a few f32 ulps from torch's exp, from S summed
# in another order; where P or dS = P (dP - delta) lies near the midpoint
# of two bf16 values, the kernel's bf16 value can land on the other
# neighbour (a flip). A flip moves one term of a gradient's sum by one
# bf16 step of its rounded factor, at most 2**-7 of it: term j of dQ_id =
# scale sum_j dS_ij K_jd by at most 2**-7 scale |dS_ij K_jd|, term i of
# dK_jd = scale sum_i dS_ij Q_id by 2**-7 scale |dS_ij Q_id|, of dV_jd =
# sum_i P_ij dO_id by 2**-7 |P_ij dO_id|. The limit adds BWD_FLIPS such
# flips to atol 1e-3 + rtol 2**-7, each charged at the element's heaviest
# term (atol_id = 1e-3 + BWD_FLIPS 2**-7 scale max_j |dS_ij K_jd| for dQ,
# and so on), P and dS from the recipe in f64 (:func:`_flip_atols`, one
# (b, h) slice at a time). A flip needs the value within a few f32 ulps of
# a midpoint, so more than one at an element's heaviest terms is rare: one
# flip so charged covers any one flip, and the second is a margin of one,
# as F32_DECODE_FLIPS is for the f32 decode. Where the terms are small the
# limit stays 1e-3, so a dQ with delta taken as 0 and a dK without its
# scale stay outside it (``no_delta``, ``dk_unscaled``). The scalar atol
# 1e-3 alone passed or failed by the draw. Readings (tools/d32_bwd_probe.py
# --limit on the H100, the smoke's draw and 8 fresh draws, generators
# SEED + 41 to SEED + 48, lse and delta from the D 32 forward of
# namespace d32): at path (b)'s shape (B8 H8 S16384 D32) dQ needs a scalar
# atol of 4.0e-4 to 2.0e-3 (past 1e-3 on 3 of 9 draws; the earlier
# template dQ kernel, dq_kernel<32> of commit cf968b0, 4.0e-4 to 1.13e-3,
# 1 of 9) and dK/dV 2.6e-4 to 1.38e-3 (1 of 9, the smoke's own draw); at
# B1 H8 S16384 D64 dQ 1.8e-4 to 1.5e-3 (1 of 8) and dK/dV 1.2e-4 to
# 1.18e-3 (2 of 8). Under the flip limits every kernel
# needs at most 0.37 flips, with no element outside; their atol has median
# 1.05e-3 to 1.12e-3 and at most 0.070; delta taken as 0 puts at least
# 99.88% of dQ outside (99.89% outside 1e-3), an unscaled dK 97.6% (97.7%).
# The f32 two-kernel backward (kernels 7 and 8 on f32 inputs) computes in
# f32 throughout, as the fused f32 row, and dQ keeps its limit (the largest
# atol any element needed above rtol 1e-5 was 4.9e-7 at the path's shape,
# B8 H8 S16384 D32, on the H100: the row's ``atol_needed``). dK and dV need
# more: the dK/dV kernel sums each key's terms over all its queries, up to
# 16384 at S 16384, against 512 in the fused row, one f32 add a term in its
# order where the plain version's cuBLAS product takes another; two orders
# of a sum of n terms drift apart as about sqrt(n) rounding steps of the
# partial sums, sqrt(32) = 5.7 times the fused row's, and where dK or dV
# cancels to near 0 that drift is all the error. Measured need (the row's
# ``atol_needed``): 4.1e-6 at D 32, 6.4e-6 at D 64 (B1 H8 S16384); atol
# 2e-5 keeps a margin of 3.
# f32 dQ against the plain version holds atol 1e-6 only because the dQ
# kernel sums S and dP in the plain version's order: exact arithmetic
# needs more against it. So f32 dQ is held against the dQ recipe in f64
# from the same f32 inputs (:func:`_dq_f64_recipe`), which shares no f32
# rounding with the kernel, under ``flash_attention_dq_f32_exact``. Its
# atol by rule: the f32 plain version must itself pass it at every shape
# where dQ is held; the largest atol the plain version needs there,
# doubled and rounded up to one significant digit; below 1/100 of what
# one TF32 pass needs at the path's shape; and the planted faults (delta
# taken as 0, one TF32 pass of the plain recipe) outside it for more than
# half of dQ's elements at the path's shape and at D 64. Readings
# (tools/f32_dq_limit_probe.py on the H100, these inputs): the plain
# version needs 2.66e-6 at B8 H8 S16384 D32, 7.1e-7 at B1 H8 S16384 D64
# and at most 3.35e-6 on RAGGED_F32_D64 (S 1 causal), so 2 x 3.35e-6 ->
# 7e-6, under 3.1e-5 (one TF32 pass needs 3.1e-3); the kernel needs at
# most 3.35e-6; delta 0 puts 99.999% and 100% of dQ outside it, one TF32
# pass 97.1% and 97.2%.
# Kernel 6 in f32 (the fused backward) runs all five products in split
# precision, S and dP too, so none of its sums follows the plain
# version's f32 rounding, and atol 1e-6 against the plain version, which
# its FFMA predecessor held by summing S and dP in d order, is out of
# reach of any recipe: at B8 H8 S512 causal (path (c)'s shape at D 32, and
# D 64), over 3 draws, the recipe in f64 itself needs 3.3e-6 and 3.6e-6
# on dQ, 1.0e-6 and 1.7e-6 on dK, 7.7e-7 and 2.3e-6 on dV against it
# (tools/f32_fused_bwd_probe.py on the H100). So its dQ is held against
# the f64 recipe under flash_attention_dq_f32_exact, by that entry's rule:
# the f32 plain version needs at most 3.6e-6 there and 1.8e-6 on the
# ragged lengths (RAGGED_F32_D64), under 7e-6; the kernel 2.1e-6 and 1.9e-6
# (ragged 1.4e-6 and 1.3e-6); delta 0 puts over 99.99% of dQ outside it,
# one TF32 pass over 97%. Its dK and dV keep the plain version as
# reference, the limit moved by the rule of flash_attention_dkv_f32: the
# kernel needs at most 2.6e-6 (D 64; 1.5e-6 at D 32, 1.4e-6 ragged), so
# atol 8e-6 keeps a margin of 3; an unscaled dK puts over 99.99% of dK
# outside it. Measured on the same draws against the f64 recipe, the
# kernel lies nearer it than the plain version does (dQ 2.1e-6 against
# 3.6e-6, dK 1.4e-6 against 1.7e-6, dV 0.9e-6 against 2.3e-6), with each
# 8-wide k-step of every product in a fresh accumulator; with S and dP
# in one accumulator of D / 8 k-steps (24 mma at D 64), dQ needed 9.9e-6
# against the f64 recipe and dK/dV 4.7e-6 against the plain version.
# The f32 decode kernels (kernels 2 and 3 on f32 caches) follow the bf16
# decode rows' derivation without the output's bf16 rounding: they round q,
# K, V and p to bf16 as their plain versions do, against the same running
# max, and combine the same live splits in the same order, so what stays
# is the order of the f32 sums (atol 1e-6 + rtol 1e-5 of |plain|, the
# other f32 rows' term) and a flip of p: where the scores' f32 sums differ
# in their last bits, a p can round to the neighbouring bf16 value, which
# moves output element d by at most 2**-7 w_j |v_jd|, w_j the position's
# softmax weight. The top position of a (row, head) cannot flip: its p is
# exp(0) = 1 on both sides. The limit adds F32_DECODE_FLIPS such flips,
# each at the heaviest other position of the (row, head):
# 2 * 2**-7 * max_j w_j |v_jd| (:func:`_f32_decode_atol`). A limit as wide
# as one bf16 rounding of q, K and V would pass a true-f32 decode, the
# computation JAX runs where its f32 gate says no and the reason the port
# refuses those shapes; so each f32 decode case also holds the unrounded
# decode (:func:`_unrounded_decode`) against the plain version, and the
# row fails unless some element of every case, and at least
# TRUE_F32_MIN_SHARE of all its cases' elements, lie outside the limit
# (on CPU draws of the rows' shapes: 1 to 16% a case, the short rows of
# 33 and 95 positions the least, 5% or more pooled; a share of 0 at every
# shape at the earlier limit, 2 * 2**-7 * max|v| / L over the whole cache).
# The dense CE forward adds sum(x * t) over the row in f32 in another
# order than its plain version, as the sparse one adds its exps (measured
# 9.5e-7 at V 10 and at V 32000): the sparse limit. The dense CE gradient
# differs only by a rounding flip of the bf16 output (measured 0.0), as
# the sparse one.
LSE_ATOL = 1e-4
F32_DECODE_FLIPS = 2
BWD_FLIPS = 2
TRUE_F32_MIN_SHARE = 0.01
# A training step through the kernels against the plain path, from the
# same f32 masters and batch: |loss difference| and, for every parameter,
# ||grad_kernels - grad_plain|| / ||grad_plain||. The kernel path feeds
# bf16 logits to the CE and rounds P and dS to bf16, the plain path keeps
# f32 logits and f32 softmax: measured on the H100 8.5e-5 on the loss and
# 0.0188 at worst (median 0.0093) on the gradients. The limits leave a
# margin of about 10x on the loss and 2x on the gradients.
STEP_TOL = {"loss": 1e-3, "grad_rel": 0.04}
# MobileNetV2's step through the depthwise kernels against the plain
# depthwise version on the card: |loss difference| / |loss| and the same
# gradient limit as the LM's (the two differ only by the statistics'
# summation order and the ReLU6 flips it causes)
MN_STEP_TOL = {"loss_rel": 1e-3, "grad_rel": 0.04}
# nats the loss must fall over the 20 steps on its fixed batch (measured
# 10.87 -> 4.21 on the H100)
LOSS_FALL = 2.0
NEAR_TIE = 0.05
# the long-context int8 phase: the flagship at max_seq 16384 with the
# int8 KV cache; prompt lengths of the eight generate requests, the last
# sharing the first SHARED tokens (32 pages) of the 8192-token prompt
LONG_MAX_SEQ = 16384
LONG_LENS = (1024, 1024, 1024, 1024, 8192, 12000, 16000)
SHARED, SHARER_OWN = 4096, 904
BEAM_PROMPT, BEAM_TOKENS, BEAM_SIZE = 8192, 32, 4
SCORE_LEN, SCORE_FROM = 16384, 8192
# served score (prefill kernel, bf16 P) against the plain attention path
# (f32 softmax) on the same tokens, relative
SCORE_RTOL = 1e-3
CROSSOVER_CONTEXTS = (1024, 4096, 16000)
# the tiles per split the decode rows time (``by_split_tiles``), the
# choices for ops/flash_decode.py's SPLIT_TILES
SPLIT_CHOICES = (1, 2, 4)
# MobileNetV2 (BASELINE config #5): the fused candidate of the JAX repo's
# bench.py::bench_mobilenet run through the defaults of its CLI
# experiments/imagenet_subset/train.py (u8 wire format, sparse CE,
# momentum 0.05, B 256, 96 px, 100 classes, width 1.0, bf16)
MN = dict(image_size=96, classes=100, width=1.0)
MN_B, MN_STEPS, MN_LR = 256, 20, 0.05
MN_TRAIN, MN_VAL = 2048, 512
# The same recipe at the model's default f32 (JAX's mobilenet_v2 builds
# f32, and its fused branch runs the Pallas kernel in f32), then
# MobileNetV2's published ImageNet shapes: 224 px, 1000 classes, width
# 1.0, B MN224_B for MN224_STEPS steps
MN224 = dict(image_size=224, classes=1000, width=1.0)
MN224_B, MN224_STEPS = 64, 3
# The f32 step through the depthwise kernels against the plain depthwise
# versions: the kernels compute the plain versions' f32 arithmetic (the
# same roundings, every sum over positions the f32 of an f64 sum), so the
# two steps differ only where an f64 sum of the same terms in another
# order rounds to the neighbouring f32 (dw), one f32 step of 2**-24 of an
# element, and by whatever the library's convolutions add between two
# launches; the limits are the CPU parity test's against JAX (1e-5 on the
# loss, 1e-4 on the gradients), 100 and 400 times tighter than bf16's
MN_F32_STEP_TOL = {"loss_rel": 1e-5, "grad_rel": 1e-4}
# Long-context training: experiments/lm/train.py --seq 16384 --remat at the
# flagship's dims (adam 1e-3, the fused sparse CE), B 1 where the CLI
# defaults to 8, on random windows of its synthetic corpus
# (experiments/lm/data.py::generate_corpus at the CLI's defaults: order 1,
# ids < 256, branching 8, 200,000 tokens, the tail held out)
LONG_TRAIN_STEPS, LONG_TRAIN_B, LONG_TRAIN_S = 10, 1, 16384
CORPUS_TOKENS, CORPUS_VOCAB, CORPUS_BRANCHING = 200_000, 256, 8
# The CIFAR-10 ConvNet (BASELINE config #2): bench.py::bench_cifar_sync's
# cifar_convnet(bf16), B 2048, sgd 0.01, with the fused dense CE on the
# synthetic_cifar10 recipe of experiments/cifar10/cifar_data.py
CN_B, CN_STEPS, CN_LR = 2048, 30, 0.01
CN_TRAIN, CN_VAL = 4096, 512
# The wire-training planes (BASELINE config #3 at experiments/cifar10/
# train.py's defaults: B 256, momentum 0.05, 2 workers, maximum_staleness
# 4) over loopback TCP with in-process workers: the async leg's dataset of
# WIRE_TRAIN synthetic images for WIRE_EPOCHS epochs (32 batches), a
# single-worker leg of WIRE_SINGLE_BATCHES batches held bit for bit against
# an in-process replay, and gradient averaging with min_updates_per_version
# 2 over FED_ROUNDS rounds of two workers with FED_LOCAL local images each
WIRE_B, WIRE_LR, WIRE_WORKERS, WIRE_STALENESS = 256, 0.05, 2, 4
WIRE_TRAIN, WIRE_EPOCHS, WIRE_SINGLE_BATCHES = 4096, 2, 16
FED_LOCAL, FED_ROUNDS = 1024, 4
WIRE_TIMEOUT_S = 300
# The in-process trainers on the ConvNet of step 14: (a) the JAX repo's
# bench.py::bench_cifar_async (AsyncSGDTrainer, B 256, K 8 batches an
# upload, 96 batches, 4 workers, maximum_staleness 2, staleness_decay 0.7,
# sgd 0.01, stage_dataset, inflight_window 2, 2K warm batches through
# worker_loop(0) before the timed train); (b) experiments/cifar10/train.py
# --mode async at its defaults (B 256, K 1, 2 workers, momentum 0.05,
# maximum_staleness 4) for one epoch of WIRE_TRAIN images; (c) one worker,
# K 1, WIRE_SINGLE_BATCHES batches; (d) bench.py::bench_fedavg
# (FederatedAveragingTrainer, K 8 local steps, B 128, sgd 0.01) at 1 and 4
# workers, FA_ROUNDS rounds each. Leg (b) also replays, without the
# trainer, one epoch of a second synthetic dataset (seed SEED +
# IP_SECOND_DATA) and reports its validation loss at every version
IP_B, IP_K, IP_BATCHES, IP_WORKERS = 256, 8, 96, 4
IP_SECOND_DATA = 21
IP_STALENESS, IP_DECAY, IP_LR, IP_WINDOW = 2, 0.7, 0.01, 2
FA_K, FA_B, FA_LR, FA_ROUNDS, FA_WORKERS = 8, 128, 0.01, 3, (1, 4)
# The depthwise kernels against their plain versions. The products and
# sums of the conv round to bf16 at the same places in both, every
# elementwise step is the same f32 operation, and every sum over positions
# is the f32 of an f64 sum in both, so the forward agrees bit for bit
# (measured 0.0 on the H100 at all 10 shapes). What is left are the last
# bits of a division or an rsqrt, which can flip a bf16 rounding of the
# conv-output cotangent or move an output across a ReLU6 bound and so
# switch its gradient: measured at 6e-6 of dx's elements at most. dx is
# held elementwise except for a share of at most DWGN_FLIP_SHARE; dw
# (summed over the threads in f32 before the f64 sum), dscale and dbias
# within DWGN_SUM_RTOL of their largest element (measured 2.8e-4).
DWGN_FLIP_SHARE = 1e-3
DWGN_SUM_RTOL = 2 ** -7
# The f32 depthwise kernels (kernels 11-12 on f32 activations) round every
# product, sum, division and affine step to f32 where their plain versions
# do (which divide truly, ops/depthwise_gn.py::_div), and take every sum
# over positions as the f32 of an f64 sum, as the plain versions do: the
# forward is held bit for bit (measured so at all 20 shapes on the H100);
# dx, dscale and dbias elementwise at the f32 rows' limit (atol 1e-6 +
# rtol 1e-5, TOL), where each was measured bit for bit too (the rows
# report the share of elements that differ). dw's f64 sums
# add the same f32 products in another order (the threads, the warps, the
# cluster's ranks) than the plain version's, which can round the f32 result
# to its neighbour: one f32 step, 2**-24 relative; dw is held within
# DWGN_F32_SUM_RTOL of its largest element, sixteen such steps.
DWGN_F32_SUM_RTOL = 1e-6
# The timer's device spin before each bracket (_timed): between SPIN_MIN_S
# and SPIN_MAX_S, counted in cycles of the H100 SXM's highest SM clock
# (1.98 GHz), so that a card at a lower clock spins longer, never shorter
SPIN_MIN_S, SPIN_MAX_S, SPIN_CLOCK_HZ = 1e-4, 0.1, 1.98e9
# MoE on one card: the JAX repo's bench.py::bench_moe row
# transformer_moe_flagship (vocab 32000, d_model 512, 8 x 64 heads, d_ff
# 2048, 8 experts, MOE_LAYERS 2, bf16, adam 1e-3, B 8, S 1024), Switch
# top-1 and GShard top-2 from one tree; MOE_WARM + MOE_STEPS steps each on
# windows of the LM CLI's corpus; the capacity sweep of bench_moe (top-2,
# depth 1, f32, one forward); the top-1 model served at MOE_SERVE_SEQ
MOE = dict(vocab_size=32000, d_model=512, n_heads=8, n_layers=2, d_ff=2048, max_seq=1024,
           n_experts=8)
MOE_B, MOE_S, MOE_WARM, MOE_STEPS, MOE_SERVE_SEQ = 8, 1024, 3, 10, 2048
MOE_CAPACITY_SWEEP = (1.0, 1.25, 2.0)
MOE_BEAM_PROMPT, MOE_BEAM_TOKENS, MOE_SCORE_LEN, MOE_SCORE_FROM = 512, 16, 1024, 512
# a decode position whose top-2 router probabilities lie this close is
# counted: batched and solo matmuls may route it to different experts
ROUTER_NEAR_TIE = 1e-3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12          # H100 SXM f32 outside the tensor cores
TF32_FLOPS = 495e12        # H100 SXM dense TF32 tensor-core peak
# exponentials at the special-function units' rate: 16 results a clock an
# SM (CUDA's throughput table for compute capability 9.0) on 132 SMs at
# 1.83 GHz, the clock behind BF16_FLOPS (989e12 = 132 x 4096 x 1.83e9)
SFU_EXP_PER_S = 132 * 16 * 1.83e9
INT8_OPS = 1979e12         # H100 SXM dense int8 tensor-core peak


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _flagship_tree(cfg, rng: np.random.Generator):
    """A flax-shaped params tree with lecun-normal-scaled random weights."""
    from distriflow_tpu_torch.models.convert import random_lm_tree

    return random_lm_tree(cfg, rng)


def _requests(rng: np.random.Generator, vocab: int):
    """(name, prompt [1, P], kwargs) x 8; the last shares 256 tokens with
    the first 512-token prompt."""
    lens = [128, 300, 512, 1000, 128, 512, 1000]
    prompts = [rng.integers(0, vocab, (1, n), dtype=np.int64).astype(np.int32) for n in lens]
    sharer = np.concatenate([prompts[2][:, :256], rng.integers(0, vocab, (1, 44)).astype(np.int32)], 1)
    sampled = {4: dict(temperature=0.8, top_k=50, top_p=0.95, seed=1234),
               6: dict(temperature=0.8, top_k=50, top_p=0.95, seed=99)}
    reqs = [(f"p{n}_{i}", p, sampled.get(i, {})) for i, (n, p) in enumerate(zip(lens, prompts))]
    reqs.append(("p300_shared", sharer, {}))
    return reqs


class _LivePayloads:
    """Live wire payloads held to the port's ``comm/schema.py::
    check_payload``: a count per payload name and phase. A payload that
    fails its schema raises on the thread that carried it and is kept in
    ``failures``, which :meth:`report` requires empty (a thread may
    swallow the error)."""

    #: request event -> (request schema, ack schema)
    SERVING = {"generate": ("generate_request", "generate_ack"),
               "beam": ("beam_request", "direct_ack"),
               "score": ("score_request", "direct_ack")}
    WIRE = ("report", "dftp_leaf")

    def __init__(self):
        self.counts = collections.defaultdict(collections.Counter)
        self.leaf_kinds = collections.Counter()
        self.leaf_names = collections.defaultdict(set)
        self.failures = []
        self._lock = threading.Lock()

    def check(self, phase, name, payload):
        from distriflow_tpu_torch.comm.schema import PAYLOADS, check_payload

        try:
            check_payload(name, payload)
        except (KeyError, ValueError) as e:
            with self._lock:
                self.failures.append(f"{phase}/{name}: {e}")
            raise
        with self._lock:
            self.counts[phase][name] += 1
        for field in PAYLOADS[name].fields:  # nested payloads: an ack's serving_meta
            if field.payload is not None and payload.get(field.name) is not None:
                self.check(phase, field.payload, payload[field.name])

    def tap(self, client):
        """Hold every generate/beam/score request an ``InferenceClient``
        sends and every ack it gets back."""
        send = client._request

        def request(event, payload):
            names = self.SERVING.get(event)
            if names:
                self.check("serving", names[0], payload)
            ack = send(event, payload)
            if names:
                self.check("serving", names[1], ack)
            return ack

        client._request = request
        return client

    @contextlib.contextmanager
    def wire(self, phase="wire"):
        """Inside the block, hold every report a ``ReportBuilder`` builds
        and every leaf of every dftp-flat blob serialized, counted under
        ``phase``; ``leaf_names[phase]`` gathers the leaves' paths."""
        from unittest import mock

        from distriflow_tpu_torch.obs import collector
        from distriflow_tpu_torch.utils import serialization

        build, flat = collector.ReportBuilder.build, serialization.flat_serialize

        def checked_build(rb, *args, **kw):
            report = build(rb, *args, **kw)
            self.check(phase, "report", report)
            return report

        def checked_flat(serialized):
            blob, meta = flat(serialized)
            for leaf in meta["leaves"]:
                self.check(phase, "dftp_leaf", leaf)
                with self._lock:
                    self.leaf_names[phase].add(leaf["name"])
                kind = ("sparse" if leaf.get("encoding") == "sparse"
                        else "int8" if "scale" in leaf else "dense")
                with self._lock:
                    self.leaf_kinds[kind] += 1
            return blob, meta

        with mock.patch.object(collector.ReportBuilder, "build", checked_build), \
                mock.patch.object(serialization, "flat_serialize", checked_flat):
            yield

    def report(self):
        """The ``payloads:`` line; every payload name seen at least once."""
        want = {"serving": sorted({n for pair in self.SERVING.values() for n in pair}
                                  | {"serving_meta"}),
                "wire": list(self.WIRE), "keras": list(self.WIRE)}
        assert not self.failures, f"payloads that failed their schema: {self.failures}"
        missing = {phase: [n for n in names if not self.counts[phase][n]]
                   for phase, names in want.items()}
        assert not any(missing.values()), f"payloads never seen: {missing}"
        assert all(self.leaf_kinds[k] for k in ("dense", "int8", "sparse")), self.leaf_kinds
        return {**{phase: dict(sorted(self.counts[phase].items())) for phase in want},
                "dftp_leaf_kinds": dict(sorted(self.leaf_kinds.items()))}


def _topk_probe(tree, device="cuda"):
    """One top-k upload's encoding of CUDA tensors: each ConvNet parameter
    of ``tree`` on ``device`` through ``topk_array`` at 0.25 (f32 values)
    and again with int8 values, packed as one dftp-flat blob each. Returns
    the leaves encoded."""
    from distriflow_tpu_torch.utils.serialization import pack_bytes, topk_array

    params = _wire_model(tree, device).get_params()
    for quantize in (False, True):
        pack_bytes({k: topk_array(v, 0.25, quantize=quantize) for k, v in params.items()})
    return 2 * len(params)


def _analysis_phase():
    """The port's static analysis over its own package with its baseline
    (all four families). Fails on a finding the baseline does not hold, a
    stale baseline entry or a file that does not parse."""
    from distriflow_tpu_torch.analysis import ALL_FAMILIES, run_checks
    from distriflow_tpu_torch.analysis.core import (PACKAGE_ROOT, load_baseline,
                                                    load_modules, match_baseline)

    t0 = time.perf_counter()
    findings = run_checks([PACKAGE_ROOT])
    wall = time.perf_counter() - t0
    fresh, stale = match_baseline(findings, load_baseline())
    parsed, files = len(load_modules([PACKAGE_ROOT])), len(list(PACKAGE_ROOT.rglob("*.py")))
    assert not fresh, "\n".join(f.render() for f in fresh)
    assert not stale, f"stale baseline entries: {stale}"
    assert parsed == files, f"{files - parsed} source files did not parse"
    return {"findings": len(fresh), "baselined": len(findings) - len(fresh),
            "stale": len(stale), "families": list(ALL_FAMILIES), "files_parsed": parsed,
            "wall_s": wall}


def _serve(model, reqs, counted, direct=(), payloads=None):
    """Drive the port's server with the port's client: the ``generate``
    requests in one counted window (:func:`_generate_wave`), then each
    ``(name, fn(client))`` of ``direct`` in a window of its own; with
    ``payloads`` (a :class:`_LivePayloads`) every client is tapped. Returns
    ``(outputs by name, engine stats, the generate window's launch counts,
    {name: (result, launch counts)})`` after stopping the server."""
    from distriflow_tpu_torch.client.inference_client import InferenceClient
    from distriflow_tpu_torch.obs.telemetry import Telemetry
    from distriflow_tpu_torch.server.inference_server import InferenceServer

    server = InferenceServer(model, telemetry=Telemetry()).setup()
    clients = [InferenceClient(server.address, timeout=600).setup() for _ in reqs]
    if payloads is not None:
        clients = [payloads.tap(c) for c in clients]
    try:
        (outs, stats), counts = counted(lambda: _generate_wave(server, clients, reqs))
        done = {name: counted(lambda fn=fn: fn(clients[0])) for name, fn in direct}
        return outs, stats, counts, done
    finally:
        for c in clients:
            c.close()
        server.stop()


def _generate_wave(server, clients, reqs):
    """Every request of ``reqs`` at once, one client each; the last starts
    once the others are admitted, so that the prompt pages it shares are
    registered. Returns ``(outputs by name, engine stats)``."""
    outs, errs = {}, []

    def run(client, name, prompt, kw):
        try:
            outs[name] = client.generate(prompt, N_TOKENS, **kw)
        except Exception as e:  # re-raised on the main thread below
            errs.append((name, e))

    threads = [threading.Thread(target=run, args=(c, *r)) for c, r in zip(clients, reqs)]
    for t in threads[:-1]:
        t.start()
    deadline = time.monotonic() + 300
    while server.batched_requests < len(reqs) - 1:  # donor pages registered
        if errs or time.monotonic() > deadline:
            raise RuntimeError(f"first wave not admitted: {errs}")
        time.sleep(0.001)
    threads[-1].start()
    for t in threads:
        t.join(timeout=600)
    if errs or any(t.is_alive() for t in threads):
        raise RuntimeError(f"requests failed: {errs}")
    metas = [c.last_serving_meta for c in clients]
    return outs, {
        "decode_batches": server.decode_batches,
        # one kernel 1 launch a layer a fresh prefill, one kernel 2 launch
        # a layer a decode step
        "prefills": server.prefills,
        "decode_steps": server.decode_batches * server.serving.decode_chunk,
        "prefix_hits": server.prefix_hits,
        "ttft_ms_p50": float(np.median([m["ttft_ms"] for m in metas])),
        "tpot_ms_p50": float(np.median([m["tpot_ms"] for m in metas])),
        "phases_ms": {k: {q: v[q] for q in ("count", "p50", "max", "sum")}
                      for k, v in server._prof.digests().items()},
    }


def _margin(model, prompt, gen, t):
    """Top-2 logit margin of the solo path before generated token ``t``."""
    toks = torch.cat([prompt, gen[:, :t]], dim=1)
    logits, _ = model.decode(toks)
    top = torch.topk(logits[0, -1], 2).values
    return float(top[0] - top[1])


def _solo(model, reqs):
    """The port's solo ``generate()`` for every request, by name."""
    from distriflow_tpu_torch.models.generate import generate

    return {name: generate(model, prompt, N_TOKENS, **kw).cpu() for name, prompt, kw in reqs}


def _check_greedy(model, reqs, outs, solos, n_tokens=N_TOKENS):
    report = {}
    for name, prompt, kw in reqs:
        got, solo = torch.as_tensor(outs[name]), solos[name]
        assert got.shape == (1, prompt.shape[1] + n_tokens), (name, got.shape)
        assert torch.equal(got[:, :prompt.shape[1]], solo[:, :prompt.shape[1]]), name
        assert int(got.min()) >= 0 and int(got.max()) < model.config.vocab_size, name
        diff = (got != solo).nonzero()
        if kw:  # sampled: the same (seed, position) streams, reported only
            report[name] = {"sampled": True, "equal_to_solo": not len(diff)}
            continue
        if not len(diff):
            report[name] = {"equal_to_solo": True}
            continue
        pos = int(diff[0, 1])
        t = pos - prompt.shape[1]
        m = _margin(model, torch.as_tensor(prompt, device=model.device),
                    solo[:, prompt.shape[1]:].to(model.device), t)
        print(f"{name}: first mismatch at position {pos}, top-2 margin {m:.4f}")
        report[name] = {"equal_to_solo": False, "first_mismatch": pos, "margin": m}
        if m >= NEAR_TIE:
            raise AssertionError(f"{name}: engine and solo differ at {pos} with margin {m}")
    return report


def _profile_decode_iteration(model, rng, contexts):
    """One engine decode iteration (8 slots at ``contexts``, chunk 8,
    greedy) under ``torch.profiler`` (:func:`_profiled`)."""
    from distriflow_tpu_torch.models.generate import decode_chunk, paged_cache, paged_insert, prefill
    from distriflow_tpu_torch.utils.config import ServingConfig

    srv, cfg = ServingConfig(), model.config
    n_pages = srv.pool_pages(cfg.max_seq)
    cache = paged_cache(cfg, srv.max_slots, srv.page_size, n_pages, model.device)
    table = np.full((srv.max_slots, cache.page_table.shape[1]), n_pages, np.int32)
    first = np.zeros(srv.max_slots, np.int32)
    used = 0
    for r, n in enumerate(contexts):
        k = -(-(n + N_TOKENS) // srv.page_size)
        table[r, :k] = np.arange(used, used + k)
        used += k
        logits, row = prefill(model, rng.integers(0, cfg.vocab_size, (1, n)).astype(np.int32))
        paged_insert(cache, row, [r], n, 0, table)
        first[r] = int(logits.argmax())
        del row
    off = dict(temps=np.zeros(8, np.float32), top_ks=np.zeros(8, np.int32),
               top_ps=np.ones(8, np.float32), seeds=np.zeros(8, np.int64), eos=np.full(8, -1, np.int32))
    state = [first, np.zeros(8, bool)]

    def step():
        _, state[0], state[1], _ = decode_chunk(model, cache, state[0], state[1], chunk=srv.decode_chunk, **off)

    step()  # warm
    return _profiled(step)


def _profiled(step, kernel_ms=None):
    """One call of ``step`` under ``torch.profiler``: host wall time against
    the device time of the kernels it launched, and the kernels that took
    the most; with ``kernel_ms`` ({label: names}), the device ms of the
    kernels whose name holds one of each label's names, as ``kernel_ms``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if str(getattr(e, "device_type", "")).endswith("CUDA")]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    out = {"wall_ms": wall_ms, "device_ms": dev_ms if kernels else "not measured",
           "idle_share": (1 - dev_ms / wall_ms) if kernels else "not measured",
           "device_launches": sum(e.count for e in kernels),
           "top_kernels": [[e.key[:70], e.count, e.self_device_time_total / 1e3] for e in top]}
    if kernel_ms:
        out["kernel_ms"] = {
            label: sum(e.self_device_time_total for e in kernels if any(n in e.key for n in names))
            / 1e3 if kernels else "not measured" for label, names in kernel_ms.items()}
    return out


class _Ms(float):
    """A median device time in ms that carries the fastest and the slowest
    launch of its run (printed beside it as ``<key>_min_max``)."""
    spread = (0.0, 0.0)


def _with_spread(obj):
    """``obj`` with ``<key>_min_max: [min, max]`` beside every timed value."""
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            out[k] = _with_spread(v)
            if isinstance(v, _Ms):
                out[f"{k}_min_max"] = list(v.spread)
        return out
    if isinstance(obj, list):
        return [_with_spread(v) for v in obj]
    return obj


def _timed(fn, iters, flush):
    """Median device ms of ``fn`` over ``iters`` launches (an :class:`_Ms`),
    each with L2 cold. A device-side spin precedes every bracket, at least
    twice the host time of one call of ``fn``, so the device reaches the
    first event only after the host has queued the whole call: the
    wrapper's host work never sits inside the bracket."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin = int(max(SPIN_MIN_S, min(2 * host_s, SPIN_MAX_S)) * SPIN_CLOCK_HZ)
    evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
           for _ in range(iters)]
    for a, b in evs:
        flush.zero_()
        torch.cuda._sleep(spin)
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    times = sorted(a.elapsed_time(b) for a, b in evs)
    ms = _Ms(float(np.median(times)))
    ms.spread = (times[0], times[-1])
    return ms


def _tol(name):
    atol, rtol = TOL[name]
    flips = {"flash_decode_f32": f" + {F32_DECODE_FLIPS} x 2**-7 x max_j w_j |v_jd| (j not the top "
                                 f"position)",
             "flash_attention_dq": f" + {BWD_FLIPS} x 2**-7 x scale x max_j |dS_ij K_jd| (dS in f64)",
             "flash_attention_dkv_d32": f" + {BWD_FLIPS} x 2**-7 x (dK: scale x max_i |dS_ij Q_id|, "
                                        f"dV: max_i |P_ij dO_id|) (P, dS in f64)"}
    flips["flash_decode_paged_f32"] = flips["flash_decode_f32"]
    flips["flash_attention_dq_d32"] = flips["flash_attention_dq"]
    flips["flash_attention_dkv"] = flips["flash_attention_dkv_d32"]
    return f"atol {atol} + rtol {rtol} x |plain|{flips.get(name, '')}"


def _f32_decode_rows(q, k, v, lens, table=None):
    """Each row's K and V ``[B, P, H, D]`` (a slab's rows, or the pages of
    each row's table in order) and its valid positions ``[B, P]``."""
    b, h, d = q.shape
    if table is None:
        kr, vr = (t.view(t.shape[0], t.shape[1], h, d) for t in (k, v))
    else:
        tab = table.long().clamp(0, k.shape[0] - 1)
        kr, vr = (t[tab].reshape(b, -1, h, d) for t in (k, v))
    return kr, vr, torch.arange(kr.shape[1], device=q.device) < lens[:, None].long()


def _f32_decode_atol(name, q, kr, vr, valid):
    """The f32 decode limit's atol, elementwise ``[B, H, D]``: ``name``'s
    f32 order term plus :data:`F32_DECODE_FLIPS` flips of p, each charged
    at the (row, head)'s heaviest ``w_j |v_jd|`` but for its top position
    (``w`` the softmax of the bf16-rounded scores; see the note above
    :data:`TOL`'s f32 decode entries). ``kr, vr, valid`` from
    :func:`_f32_decode_rows`."""
    bf = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    s = torch.einsum("bhd,bphd->bhp", bf(q), bf(kr)) / math.sqrt(q.shape[-1])
    s = torch.where(valid[:, None], s, -1e30)
    w = torch.softmax(s, -1) * valid[:, None]
    w = w.scatter(-1, s.argmax(-1, keepdim=True), 0.0)  # p = exp(0) = 1 there on both sides
    heaviest = (w[..., None] * bf(vr).abs().permute(0, 2, 1, 3)).amax(2)
    return TOL[name][0] + F32_DECODE_FLIPS * 2 ** -7 * heaviest


def _unrounded_decode(q, kr, vr, valid):
    """Decode with no bf16 rounding of q, K, V or p, in f64: what XLA's
    true-f32 decode computes, to within f32. The f32 rows' control: their
    limit must put a share of its elements outside (``true_f32_share``),
    else it could not tell the bf16-compute contract from true f32."""
    s = torch.einsum("bhd,bphd->bhp", q.double(), kr.double()) / math.sqrt(q.shape[-1])
    w = torch.softmax(torch.where(valid[:, None], s, -1e30), -1)
    return torch.einsum("bhp,bphd->bhd", w, vr.double()).float()


def _over(name, got, want, atol, rtol):
    """Max abs error of ``got`` against ``want``; raises where an element
    lies outside ``atol + rtol * |want|`` (``atol`` a number or a tensor)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bad = int((err > atol + rtol * want.abs()).sum())
    if bad:
        shown = atol if isinstance(atol, float) else f"by element (at most {float(atol.max())})"
        raise AssertionError(f"{name}: {bad} elements outside atol {shown} + rtol {rtol}, "
                             f"max abs err {float(err.max())}")
    return float(err.max())


def _bound(nbytes, flops, peak=BF16_FLOPS, exps=0):
    """(least ms, what bounds it): the largest of the bytes over the HBM
    rate, the operations over the card's peak for their type and the
    exponentials over :data:`SFU_EXP_PER_S` (an attention kernel's: one a
    live pair)."""
    return max(((nbytes / HBM_BYTES_PER_S * 1e3, "bytes"), (flops / peak * 1e3, "operations"),
                (exps / SFU_EXP_PER_S * 1e3, "exponentials")), key=lambda t: t[0])


def _flush_buffer():
    return torch.empty(32 << 20, dtype=torch.float32, device="cuda")  # 128 MB > 50 MB L2


def _wrong_combines(name, parts, want, atol=None):
    """The share of elements outside ``name``'s limit around the plain
    output ``want`` for three wrong combines of the plain split partials
    ``parts``: without the exp(m_i - M) rescale (over the rows with two or
    more live splits, the only ones it changes), without the split holding
    each (row, head)'s max, and without each row's last live split (which
    may hold too little of a peaked softmax to show: reported only).
    ``atol``: a ``[B, H, 1]`` tensor in place of the limit's atol (the f32
    rows')."""
    from distriflow_tpu_torch.ops import flash_decode as fd

    live = [lv for *_, lv in parts]
    acc = sum(torch.where(lv[:, None, None], a, 0.0) for (_, _, a, _), lv in zip(parts, live))
    l = sum(torch.where(lv[:, None], li, 0.0) for (_, li, _, _), lv in zip(parts, live))
    no_rescale = (acc * (1.0 / l.clamp_min(1e-30))[..., None]).to(want.dtype)
    n_live = torch.stack(live).sum(0)
    multi = n_live >= 2
    assert multi.any(), f"{name}: no row spans two splits"
    top = torch.stack([torch.where(lv[:, None], m, -math.inf) for m, _, _, lv in parts]).argmax(0)
    no_max = [(m, torch.where(top == i, 0.0, li), torch.where((top == i)[..., None], 0.0, a), lv)
              for i, (m, li, a, lv) in enumerate(parts)]
    no_last = [(m, li, a, lv & (i < n_live - 1)) for i, (m, li, a, lv) in enumerate(parts)]
    return {"no_rescale": _rejected(name, no_rescale[multi], want[multi],
                                    None if atol is None else atol[multi]),
            "drop_max_split": _rejected(name, fd.combine_partials(no_max).to(want.dtype), want,
                                        atol),
            "drop_last_split": _rejected(name, fd.combine_partials(no_last).to(want.dtype), want,
                                         atol)}


def _decode_checks(name, fn, plain, parts, flush, iters):
    """A decode row's checks at its own inputs: the same bits on a second
    launch; the limit rejecting the first two wrong combines of
    :func:`_wrong_combines`; and, at each of :data:`SPLIT_CHOICES` tiles
    per split, the kernel within the limit of the plain version and its
    median time (``by_split_tiles``)."""
    from distriflow_tpu_torch.ops import flash_decode as fd

    out = fn()
    assert torch.equal(fn(), out), f"{name}: a second launch gave other bits"
    rejected = _wrong_combines(name, parts(), plain())
    assert rejected["no_rescale"] > 0.5 and rejected["drop_max_split"] > 0.5, \
        f"{name}: the limit passes a wrong combine: {rejected}"
    chosen, sweep = fd.SPLIT_TILES, {}
    try:
        for st in SPLIT_CHOICES:
            fd.SPLIT_TILES = st
            sweep[str(st)] = {"max_abs_err": _over(f"{name} split_tiles={st}", fn(), plain(),
                                                   *TOL[name]),
                              "ms": _timed(fn, iters, flush)}
    finally:
        fd.SPLIT_TILES = chosen
    return {"deterministic": True, "rejected_share": rejected, "split_tiles": chosen,
            "by_split_tiles": sweep}


def _decode_edges(name, g, int8, h=8, d=64, ps=None):
    """``name``'s kernel (paged or slab, bf16 or int8) against its plain
    version at the contexts where splits begin and end: 1, exactly one
    split, one split plus 1, 0 beside live rows (its output must be exactly
    0) and three splits plus 5, on a scattered page table with sentinel
    tails (pages of ``ps``, the slab tile by default) or a slab, at ``h``
    heads of head dim ``d``; each launched twice (the same bits). Returns
    the max abs error."""
    from distriflow_tpu_torch.ops import flash_decode as fd

    dev = torch.device("cuda")
    ps = ps or fd.SLAB_TILE
    split = fd.split_tiles(ps) * ps
    lens_l = [1, split, split + 1, 0, 3 * split + 5, 700]
    b, pp = len(lens_l), -(-max(lens_l) // ps) + 2
    q = torch.randn(b, h, d, generator=g, device=dev).to(torch.bfloat16)
    if "paged" in name:
        n_pages = sum(-(-n // ps) for n in lens_l) + 2
        table, lens = _paged_rows(g, lens_l, ps, n_pages, pp)
        lead = (n_pages, ps)
    else:
        table, lens, lead = None, torch.tensor(lens_l, dtype=torch.int32, device=dev), (b, pp * ps)
    if int8:
        k, v, ks, vs = _int8_cache(g, lead, h, d)
    else:
        k, v = (torch.randn(*lead, h * d, generator=g, device=dev).to(torch.bfloat16)
                for _ in range(2))
        ks = vs = None
    args = (q, k, v) + ((ks, vs) if int8 else ()) + ((table,) if table is not None else ()) + (lens,)
    fn = getattr(fd, name)
    out = fn(*args)
    assert torch.equal(fn(*args), out), f"{name} edges: a second launch gave other bits"
    assert not out[lens_l.index(0)].any(), f"{name}: a row of length 0 did not give 0"
    return _over(f"{name} edges", out, getattr(fd, f"{name}_reference")(*args), *TOL[name])


def _kernel_rows(launches):
    """Each kernel at the main path's shapes: error against its plain
    version, and the times of kernel, plain version and library call."""
    import torch.nn.functional as F

    from distriflow_tpu_torch.ops import flash_attention as fa
    from distriflow_tpu_torch.ops import flash_decode as fd

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    flush = _flush_buffer()
    rows = []

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev, dtype=torch.float32).to(torch.bfloat16)

    # prefill attention: the engine prefills the two same-length prompts
    # together; also the non-causal branch (TransformerConfig.causal=False)
    # and ragged lengths that end inside a tile. The timed case comes last.
    errs, lse_errs, b, h, d = [], [], 2, 8, 64
    checks = {}
    for s, causal in ((1, True), (1, False), (37, True), (37, False), (512, True),
                      (1000, False), (1000, True)):
        q, k, v = randn(b, h, s, d), randn(b, h, s, d), randn(b, h, s, d)
        o, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
        ro, rl = fa.flash_attention_reference(q, k, v, causal)
        tag = f"S={s} {'causal' if causal else 'non-causal'}"
        errs.append(_over(f"flash_attention_fwd O {tag}", o, ro, *TOL["flash_attention_fwd"]))
        lse_errs.append(_over(f"flash_attention_fwd lse {tag}", lse, rl, LSE_ATOL, 0.0))
        checks[tag] = [errs[-1], lse_errs[-1]]
        again = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
        assert torch.equal(again[0], o) and torch.equal(again[1], lse), \
            f"flash_attention_fwd {tag}: a second launch gave other bits"
    pairs = s * (s + 1) // 2
    tb, by = _bound(4 * b * h * s * d * 2 + b * h * s * 4, 4 * b * h * pairs * d, exps=b * h * pairs)
    rows.append({
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "distriflow_tpu_torch/csrc/flash_attention.cu",
        "replaces": "distriflow_tpu/ops/flash_attention.py:92",
        "launches": launches["flash_attention_fwd"], "max_abs_err": max(errs),
        "lse_max_abs_err": max(lse_errs), "tol": _tol("flash_attention_fwd") + f"; lse atol {LSE_ATOL}",
        "ms": _timed(lambda: fa.flash_attention(q, k, v, causal=True, return_lse=True), 50, flush),
        "plain_ms": _timed(lambda: fa.flash_attention_reference(q, k, v, True), 5, flush),
        "bound_ms": tb, "bound_by": by,
        "library_ms": _timed(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), 50, flush),
        "shape": f"B={b} H={h} S={s} D={d} causal",
        "checks": checks, "deterministic": True,
    })

    # paged decode: 8 slots, contexts 128-1064, scattered pages of 128
    n_pages, ps, bsz = 128, 128, 8
    kp, vp = randn(n_pages, ps, h * d), randn(n_pages, ps, h * d)
    lens_l = [129, 300, 513, 1001, 193, 577, 1064, 128]
    perm = torch.randperm(n_pages, generator=g, device=dev).to(torch.int32)
    table = torch.full((bsz, 16), n_pages, dtype=torch.int32, device=dev)
    used = 0
    for r, n in enumerate(lens_l):
        np_ = -(-n // ps)
        table[r, :np_] = perm[used:used + np_]
        used += np_
    lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
    q1 = randn(bsz, h, d)
    err = _over("flash_decode_paged", fd.flash_decode_paged(q1, kp, vp, table, lens),
                fd.flash_decode_paged_reference(q1, kp, vp, table, lens), *TOL["flash_decode_paged"])
    live = sum(lens_l)
    tb, by = _bound(2 * live * h * d * 2 + 2 * bsz * h * d * 2 + table.numel() * 4 + bsz * 4,
                   4 * live * h * d, exps=live * h)
    rows.append({
        "name": "flash_decode_paged", "route": "cuda",
        "source": "distriflow_tpu_torch/csrc/flash_decode.cu",
        "replaces": "distriflow_tpu/ops/flash_decode.py:474",
        "launches": launches["flash_decode_paged"], "max_abs_err": err,
        "tol": _tol("flash_decode_paged"),
        "ms": _timed(lambda: fd.flash_decode_paged(q1, kp, vp, table, lens), 200, flush),
        "plain_ms": _timed(lambda: fd.flash_decode_paged_reference(q1, kp, vp, table, lens), 5, flush),
        "bound_ms": tb, "bound_by": by, "library_ms": None,
        "shape": f"B={bsz} H={h} D={d} page={ps} contexts={lens_l}",
        "edges_max_abs_err": _decode_edges("flash_decode_paged", g, False),
        **_decode_checks("flash_decode_paged", lambda: fd.flash_decode_paged(q1, kp, vp, table, lens),
                         lambda: fd.flash_decode_paged_reference(q1, kp, vp, table, lens),
                         lambda: fd.split_partials(q1, kp, vp, lens, table), flush, 200),
    })

    # slab decode: solo generate() at max_seq 2048
    s_max, n = 2048, 1064
    ks, vs, qs = randn(1, s_max, h * d), randn(1, s_max, h * d), randn(1, h, d)
    err = _over("flash_decode", fd.flash_decode(qs, ks, vs, n),
                fd.flash_decode_reference(qs, ks, vs, n), *TOL["flash_decode"])
    # SDPA's yardstick on contiguous [1, H, n, D] copies made outside the
    # timed call
    kh = ks.view(1, s_max, h, d).transpose(1, 2)[:, :, :n].contiguous()
    vh = vs.view(1, s_max, h, d).transpose(1, 2)[:, :, :n].contiguous()
    tb, by = _bound(2 * n * h * d * 2 + 2 * h * d * 2, 4 * n * h * d, exps=n * h)
    rows.append({
        "name": "flash_decode", "route": "cuda",
        "source": "distriflow_tpu_torch/csrc/flash_decode.cu",
        "replaces": "distriflow_tpu/ops/flash_decode.py:235",
        "launches": launches["flash_decode"], "max_abs_err": err,
        "tol": _tol("flash_decode"),
        "ms": _timed(lambda: fd.flash_decode(qs, ks, vs, n), 200, flush),
        "plain_ms": _timed(lambda: fd.flash_decode_reference(qs, ks, vs, n), 5, flush),
        "bound_ms": tb, "bound_by": by,
        "library_ms": _timed(lambda: F.scaled_dot_product_attention(qs[:, :, None], kh, vh), 200, flush),
        "shape": f"B=1 S={s_max} valid={n} H={h} D={d}",
        "edges_max_abs_err": _decode_edges("flash_decode", g, False),
        **_decode_checks("flash_decode", lambda: fd.flash_decode(qs, ks, vs, n),
                         lambda: fd.flash_decode_reference(qs, ks, vs, n),
                         lambda: fd.split_partials(qs, ks, vs, n), flush, 200),
    })
    return rows


def _train(cfg, tree, batches, device="cuda", lr=1e-3):
    """The port's ``SyncTrainer`` (adam at ``lr``) on the LM ``cfg`` from
    the carried-over f32 masters, one step per ``(x, y)`` of ``batches``;
    returns ``(trainer, losses, step ms)``."""
    from distriflow_tpu_torch.models.convert import params_from_jax
    from distriflow_tpu_torch.models.transformer import transformer_lm
    from distriflow_tpu_torch.train.sync import SyncTrainer

    trainer = SyncTrainer(transformer_lm(cfg, device=device), optimizer="adam", learning_rate=lr)
    trainer.init()
    trainer.set_params(params_from_jax(tree, cfg, masters=True))
    losses, ms = [], []
    for x, y in batches:
        losses.append(trainer.step((x, y)))
        ms.append(trainer.last_step_ms)
    return trainer, losses, ms


def _grads_vs_plain(out, limits, loss_key="loss"):
    """The report of a kernel step against a plain step, ``out`` holding
    ``{"kernels": (loss, grads), "plain": (loss, grads)}``: the loss
    difference (absolute, or relative for ``loss_rel``) and every
    parameter's relative Frobenius error, each held to ``limits``."""
    (lk, gk), (lp, gp) = out["kernels"], out["plain"]
    rel = {n: float((gk[n] - gp[n]).norm() / gp[n].norm().clamp_min(1e-30)) for n in gp}
    worst = max(rel, key=rel.get)
    diff = abs(lk - lp) / (abs(lp) if loss_key == "loss_rel" else 1.0)
    report = {"loss_kernels": lk, "loss_plain": lp,
              "loss_rel_diff" if loss_key == "loss_rel" else "loss_abs_diff": diff,
              "grad_rel_frobenius_max": rel[worst], "worst_param": worst,
              "grad_rel_frobenius_median": float(np.median(list(rel.values()))),
              "limits": limits}
    assert diff <= limits[loss_key], report
    assert rel[worst] <= limits["grad_rel"], report
    return report


def _step_vs_plain(cfg, tree, x, y, device="cuda"):
    """One step's loss and gradients through the kernels and through the
    plain path (``use_flash_attention=False``, the plain sparse CE), from
    the same f32 masters and batch ``x``, ``y`` [B, S]."""
    from distriflow_tpu_torch.models.convert import lm_from_jax
    from distriflow_tpu_torch.models.transformer import transformer_lm

    x, y = torch.as_tensor(x, device=device), torch.as_tensor(y, device=device)
    out = {}
    plain = dataclasses.replace(cfg, use_flash_attention=False, loss="sparse_softmax_cross_entropy")
    for name, c in (("kernels", cfg), ("plain", plain)):
        spec = transformer_lm(c, device=device)
        model = lm_from_jax(c, tree, device=device, trainable=True)
        loss, grads = spec.grad_fn()(model, x, y)
        out[name] = (float(loss), grads)
        del model
    return {"batch": x.shape[0], "seq": x.shape[1], **_grads_vs_plain(out, STEP_TOL)}


def _training_kernel_rows(launches, steps):
    """The training kernels at the training step's shapes: error against
    the plain version, and the times of kernel, plain version and library
    call (whose backward is timed from a retained graph). Returns the rows
    of the three training kernels and the flash forward's entry at the
    training shape, which goes into that kernel's row."""
    import torch.nn.functional as F

    from distriflow_tpu_torch.ops import flash_attention as fa
    from distriflow_tpu_torch.ops import fused_ce as ce

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    flush = _flush_buffer()
    rows = []

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev, dtype=torch.float32).to(torch.bfloat16)

    def row(name, source, replaces, err, shape, **times):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[name], "launches_per_step": launches[name] / steps,
                "max_abs_err": err, "tol": _tol(name), "shape": shape, **times}

    # flash forward and backward: B8 H8 S1024 D64 causal, the training
    # step's attention
    b, h, s, d = TRAIN_B, 8, TRAIN_S, 64
    q, k, v, do = (randn(b, h, s, d) for _ in range(4))
    o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    ro, rl = fa.flash_attention_reference(q, k, v, True)
    pairs = s * (s + 1) // 2
    tb, by = _bound(4 * b * h * s * d * 2 + b * h * s * 4, 4 * b * h * pairs * d, exps=b * h * pairs)
    fwd = {
        "shape": f"B={b} H={h} S={s} D={d} causal",
        "launches": launches["flash_attention_fwd"],
        "launches_per_step": launches["flash_attention_fwd"] / steps,
        "max_abs_err": _over("flash_attention_fwd O training", o, ro, *TOL["flash_attention_fwd"]),
        "lse_max_abs_err": _over("flash_attention_fwd lse training", lse, rl, LSE_ATOL, 0.0),
        "ms": _timed(lambda: fa.flash_attention(q, k, v, causal=True, return_lse=True), 20, flush),
        "plain_ms": _timed(lambda: fa.flash_attention_reference(q, k, v, True), 3, flush),
        "bound_ms": tb, "bound_by": by,
        "library_ms": _timed(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
                             20, flush)}
    del ro, rl
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, True)
    got = fa.flash_attention_backward(*args)
    want = fa.flash_attention_backward_reference(*args)
    err = max(_over(f"flash_attention_bwd d{n}", a, r, *TOL["flash_attention_bwd"])
              for n, a, r in zip("qkv", got, want))
    # no atomics: a second launch gives the same bits
    assert all(torch.equal(a, r) for a, r in zip(fa.flash_attention_backward(*args), got)), \
        "flash_attention_bwd is not deterministic"
    bwd = _fused_bwd_checks(list(zip(got, want)), flush)
    del got, want
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    sdpa = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    tb, by = _bound(7 * b * h * s * d * 2 + 2 * b * h * s * 4, 5 * 2 * b * h * pairs * d,
                    exps=b * h * pairs)
    rows.append(row(
        "flash_attention_bwd", "distriflow_tpu_torch/csrc/flash_attention_bwd.cu",
        "distriflow_tpu/ops/flash_attention.py:272", err, f"B={b} H={h} S={s} D={d} causal",
        ms=_timed(lambda: fa.flash_attention_backward(*args), 20, flush),
        plain_ms=_timed(lambda: fa.flash_attention_backward_reference(*args), 3, flush),
        bound_ms=tb, bound_by=by,
        library_ms=_timed(lambda: torch.autograd.grad(sdpa, (qs, ks, vs), do, retain_graph=True),
                          20, flush),
        deterministic=True, **bwd))
    del q, k, v, do, o, args, qs, ks, vs, sdpa

    # fused CE: the flagship's [B*S, V] bf16 logits
    n, vocab = TRAIN_B * TRAIN_S, 32000
    logits = randn(n, vocab)
    labels = torch.randint(0, vocab, (n,), generator=g, device=dev, dtype=torch.int32)
    loss, lse = ce.fused_ce_forward(logits, labels)
    rl, rs = ce.fused_ce_forward_reference(logits, labels)
    err = max(_over("fused_ce_fwd loss", loss, rl, *TOL["fused_ce_fwd"]),
              _over("fused_ce_fwd lse", lse, rs, *TOL["fused_ce_fwd"]))
    tb, by = _bound(n * vocab * 2 + n * 4 + 2 * n * 4, 4 * n * vocab, F32_FLOPS)
    lab64 = labels.long()
    rows.append(row(
        "fused_ce_fwd", "distriflow_tpu_torch/csrc/fused_ce.cu",
        "distriflow_tpu/ops/fused_ce.py:77", err, f"N={n} V={vocab} bf16 sparse labels",
        ms=_timed(lambda: ce.fused_ce_forward(logits, labels), 20, flush),
        plain_ms=_timed(lambda: ce.fused_ce_forward_reference(logits, labels), 3, flush),
        bound_ms=tb, bound_by=by,
        library_ms=_timed(lambda: F.cross_entropy(logits, lab64, reduction="none"), 20, flush)))

    # g of order 1, so that every column's softmax term is held to rtol
    gr = torch.rand(n, generator=g, device=dev)
    want = ce.fused_ce_backward_reference(logits, labels, lse, gr)
    err = _over("fused_ce_bwd", ce.fused_ce_backward(logits, labels, lse, gr), want,
                *TOL["fused_ce_bwd"])
    # the limit must reject wrong gradients: the share of elements each
    # falls outside it for (lse + inf drops the softmax term, lse - ln 2
    # doubles it)
    controls = {}
    for name, shift in (("no_softmax", math.inf), ("twice_softmax", -math.log(2)),
                        ("lse_plus_0.05", 0.05)):
        wrong = ce.fused_ce_backward_reference(logits, labels, lse + shift, gr)
        atol, rtol = TOL["fused_ce_bwd"]
        controls[name] = float(((wrong.float() - want.float()).abs()
                                > atol + rtol * want.float().abs()).float().mean())
        assert controls[name] > 0.5, f"fused_ce_bwd limit passes a gradient with {name}: {controls}"
        del wrong
    del want
    tb, by = _bound(2 * n * vocab * 2 + 3 * n * 4, 4 * n * vocab, F32_FLOPS)
    lg = logits.detach().clone().requires_grad_()
    lib_loss = F.cross_entropy(lg, lab64, reduction="none")
    rows.append(row(
        "fused_ce_bwd", "distriflow_tpu_torch/csrc/fused_ce.cu",
        "distriflow_tpu/ops/fused_ce.py:107", err, f"N={n} V={vocab} bf16 sparse labels",
        ms=_timed(lambda: ce.fused_ce_backward(logits, labels, lse, gr), 20, flush),
        plain_ms=_timed(lambda: ce.fused_ce_backward_reference(logits, labels, lse, gr), 3, flush),
        bound_ms=tb, bound_by=by,
        library_ms=_timed(lambda: torch.autograd.grad(lib_loss, lg, gr.to(lg.dtype),
                                                      retain_graph=True), 20, flush),
        rejected_share=controls))
    rows[-2]["narrow"], rows[-1]["narrow"] = _sparse_narrow(flush)
    return rows, fwd


def _sparse_narrow(flush):
    """Kernels 9 and 10 on the narrow layout, which no path of the port
    runs sparse (its sparse CE is the LMs' V 32000): N 2048 x V 10 with
    labels -1 and V (out of range: loss = lse) in some rows, each held
    against its plain version, launched twice (the same bits) and timed."""
    from distriflow_tpu_torch.ops import fused_ce as ce

    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    n, vocab = CN_B, 10
    logits = torch.randn(n, vocab, generator=g, device="cuda").to(torch.bfloat16)
    labels = torch.randint(0, vocab, (n,), generator=g, device="cuda", dtype=torch.int32)
    labels[::97], labels[1::97] = -1, vocab
    gr = torch.rand(n, generator=g, device="cuda")
    loss, lse = ce.fused_ce_forward(logits, labels)
    again = ce.fused_ce_forward(logits, labels)
    assert torch.equal(again[0], loss) and torch.equal(again[1], lse), \
        "fused_ce_fwd narrow: a second launch gave other bits"
    rl, rs = ce.fused_ce_forward_reference(logits, labels)
    ferr = max(_over("fused_ce_fwd loss narrow", loss, rl, *TOL["fused_ce_fwd"]),
               _over("fused_ce_fwd lse narrow", lse, rs, *TOL["fused_ce_fwd"]))
    grad = ce.fused_ce_backward(logits, labels, lse, gr)
    assert torch.equal(ce.fused_ce_backward(logits, labels, lse, gr), grad), \
        "fused_ce_bwd narrow: a second launch gave other bits"
    berr = _over("fused_ce_bwd narrow", grad, ce.fused_ce_backward_reference(logits, labels, lse, gr),
                 *TOL["fused_ce_bwd"])
    shape = f"N={n} V={vocab} bf16 sparse labels, -1 and {vocab} in every 97th row"
    lanes, rows = ce._row_tile(vocab)
    common = {"shape": shape, "lanes": lanes, "rows_a_block": rows, "deterministic": True}
    return ({**common, "max_abs_err": ferr,
             "ms": _timed(lambda: ce.fused_ce_forward(logits, labels), 20, flush),
             "bound_ms": _bound(n * vocab * 2 + 3 * n * 4, 4 * n * vocab, F32_FLOPS)[0]},
            {**common, "max_abs_err": berr,
             "ms": _timed(lambda: ce.fused_ce_backward(logits, labels, lse, gr), 20, flush),
             "bound_ms": _bound(2 * n * vocab * 2 + 3 * n * 4, 4 * n * vocab, F32_FLOPS)[0]})


def _launch_floor():
    """The launch floor: the median device ms of an empty kernel
    (``torch.cuda._sleep(0)``) in :func:`_timed`'s bracket, behind the
    same spin and L2 flush as every kernel's time."""
    return _timed(lambda: torch.cuda._sleep(0), 50, _flush_buffer())


def _fused_bwd_checks(pairs, flush):
    """Row 6's checks beyond the path's shape, whose (kernel, plain) pairs
    are ``pairs``: the limit must reject a dQ without the delta term and a
    dK without the scale (K and V drawn around 1, as for rows 7-8: with
    zero-mean inputs the delta term nearly cancels); the ragged and
    non-causal lengths; B1 H8 S8192, the longest S of the fused layout
    (bf16 D 64) and its largest partial buffer, timed; and the least atol
    any element needed above the limit's rtol."""
    import torch.nn.functional as F

    from distriflow_tpu_torch.ops import flash_attention as fa

    name = "flash_attention_bwd"
    g = torch.Generator(device="cuda").manual_seed(SEED + 10)
    b, h, s, d = TRAIN_B, 8, TRAIN_S, 64
    args = _bwd_inputs(g, b, h, s, True)
    q, k, v, do, lse, delta, _ = args
    got, want = fa.flash_attention_backward(*args), fa.flash_attention_backward_reference(*args)
    for n, a, w in zip("qkv", got, want):
        _over(f"{name} d{n} (K, V around 1)", a, w, *TOL[name])
    needed = {"path_shape": _atol_needed(name, pairs),
              "kv_around_1": _atol_needed(name, list(zip(got, want)))}
    no_delta = fa.flash_attention_backward_reference(q, k, v, do, lse, torch.zeros_like(delta), True)
    controls = {"no_delta": _rejected(name, no_delta[0], want[0]),
                "dk_unscaled": _rejected(name, want[1].float() * math.sqrt(d), want[1])}
    assert all(c > 0.5 for c in controls.values()), f"the fused limit passes a wrong gradient: {controls}"
    del args, q, k, v, do, lse, delta, got, want, no_delta
    ragged = _ragged_bwd(name, fa.flash_attention_backward, fa.flash_attention_backward_reference,
                         g, 1, 8)

    b, s = 1, 8192
    assert fa.bwd_layout(s, d, torch.bfloat16) == "fused"
    args = _bwd_inputs(g, b, h, s, True)
    got, want = fa.flash_attention_backward(*args), fa.flash_attention_backward_reference(*args)
    err = max(_over(f"{name} d{n} S={s}", a, w, *TOL[name]) for n, a, w in zip("qkv", got, want))
    needed[f"S={s}"] = _atol_needed(name, list(zip(got, want)))
    del got, want
    q, k, v, do = args[:4]
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    sdpa = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    tb, by = _bound(7 * b * h * s * d * 2 + 2 * b * h * s * 4, 5 * 2 * b * h * s * (s + 1) // 2 * d,
                    exps=b * h * s * (s + 1) // 2)
    longest = {"shape": f"B={b} H={h} S={s} D={d} causal", "max_abs_err": err,
               "ms": _timed(lambda: fa.flash_attention_backward(*args), 10, flush),
               "bound_ms": tb, "bound_by": by,
               "library_ms": _timed(lambda: torch.autograd.grad(sdpa, (qs, ks, vs), do,
                                                                retain_graph=True), 10, flush)}
    return {"rejected_share": controls, "ragged_max_abs_err": ragged, "longest_fused": longest,
            "atol_needed": max(needed.values()), "atol_needed_by_check": needed}


def _long_requests(rng: np.random.Generator, vocab: int):
    """(name, prompt [1, P], kwargs) x 8 at long context: prompts of
    :data:`LONG_LENS`, two of them sampled, and one that shares the first
    :data:`SHARED` tokens of the 8192-token prompt."""
    prompts = [rng.integers(0, vocab, (1, n), dtype=np.int64).astype(np.int32) for n in LONG_LENS]
    sharer = np.concatenate(
        [prompts[4][:, :SHARED], rng.integers(0, vocab, (1, SHARER_OWN)).astype(np.int32)], 1)
    sampled = {1: dict(temperature=0.8, top_k=50, top_p=0.95, seed=4321),
               5: dict(temperature=0.8, top_k=50, top_p=0.95, seed=77)}
    reqs = [(f"p{n}_{i}", p, sampled.get(i, {})) for i, (n, p) in enumerate(zip(LONG_LENS, prompts))]
    reqs.append((f"p{SHARED + SHARER_OWN}_shared", sharer, {}))
    return reqs


def _long_phase(cfg, tree, rng, counted, device="cuda", payloads=None):
    """The flagship at max_seq 16384 with ``kv_cache_dtype="int8"``: eight
    generate requests, one beam and one score through the port's server
    and client, each in its own launch-count window, then solo
    ``generate()`` with ``"int8_force"`` (the same int8 caches) for the
    greedy parity and the plain attention path for the score. Returns
    ``(report, launch counts by path)``."""
    from distriflow_tpu_torch.models.convert import lm_from_jax
    from distriflow_tpu_torch.models.generate import sequence_logprob

    model = lm_from_jax(cfg, tree, device=device)
    reqs = _long_requests(rng, cfg.vocab_size)
    beam_prompt = rng.integers(0, cfg.vocab_size, (1, BEAM_PROMPT)).astype(np.int32)
    score_tokens = rng.integers(0, cfg.vocab_size, (1, SCORE_LEN)).astype(np.int32)
    direct = (("beam", lambda c: c.beam_search(beam_prompt, BEAM_TOKENS, beam_size=BEAM_SIZE)),
              ("score", lambda c: c.score(score_tokens, from_pos=SCORE_FROM)))
    t0 = time.perf_counter()
    outs, stats, serving, done = _serve(model, reqs, counted, direct, payloads)
    wall = time.perf_counter() - t0
    assert stats["prefix_hits"] >= 1, "the prefix-sharing path did not run at long context"
    (beam_toks, beam_scores), beam = done["beam"]
    served_score, score = done["score"]
    profile = _profile_decode_iteration(model, rng, list(LONG_LENS) + [SHARED + SHARER_OWN])
    del model

    force = lm_from_jax(dataclasses.replace(cfg, kv_cache_dtype="int8_force"), tree, device=device)
    solos, solo = counted(lambda: _solo(force, reqs))
    parity = _check_greedy(force, reqs, outs, solos)
    del force, solos

    beam_toks, beam_scores = np.asarray(beam_toks), np.asarray(beam_scores, np.float64)
    assert beam_toks.shape == (1, BEAM_PROMPT + BEAM_TOKENS), beam_toks.shape
    assert (beam_toks[:, :BEAM_PROMPT] == beam_prompt).all()
    assert 0 <= beam_toks.min() and beam_toks.max() < cfg.vocab_size
    assert np.isfinite(beam_scores).all(), beam_scores

    plain = lm_from_jax(dataclasses.replace(cfg, use_flash_attention=False), tree, device=device)
    want = float(sequence_logprob(plain, score_tokens, SCORE_FROM)[0])
    del plain
    got = float(np.asarray(served_score)[0])
    rel = abs(got - want) / abs(want)
    assert math.isfinite(got) and rel <= SCORE_RTOL, (got, want, rel)
    report = {
        "serving": {"wall_s": wall, **stats}, "parity": parity,
        "beam": {"prompt": BEAM_PROMPT, "n_tokens": BEAM_TOKENS, "beam_size": BEAM_SIZE,
                 "score": float(beam_scores[0]),
                 "tokens_head": beam_toks[0, BEAM_PROMPT:BEAM_PROMPT + 8].tolist()},
        "score": {"len": SCORE_LEN, "from_pos": SCORE_FROM, "served": got,
                  "plain_attention": want, "rel_diff": rel, "limit": SCORE_RTOL},
        "decode_iteration_profile": profile,
    }
    return report, {"long_serving": serving, "long_solo_generate": solo, "beam": beam,
                    "score": score}


def _int8_cache(g, lead, h, d):
    """Random int8 K/V ``lead + (H*D,)`` and U(0.005, 0.05) f32 scales
    ``lead + (H,)`` on the card."""
    dev = torch.device("cuda")
    k8, v8 = (torch.randint(-127, 128, lead + (h * d,), generator=g, device=dev,
                            dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(lead + (h,), generator=g, device=dev) * 0.045 + 0.005 for _ in range(2))
    return k8, v8, ks, vs


def _paged_rows(g, lens_l, ps, n_pages, pp):
    """A page table giving row r ``ceil(lens_l[r] / ps)`` scattered pages
    of an ``n_pages`` pool, sentinel after them."""
    dev = torch.device("cuda")
    perm = torch.randperm(n_pages, generator=g, device=dev).to(torch.int32)
    table = torch.full((len(lens_l), pp), n_pages, dtype=torch.int32, device=dev)
    used = 0
    for r, n in enumerate(lens_l):
        k = -(-n // ps)
        table[r, :k] = perm[used:used + k]
        used += k
    return table, torch.tensor(lens_l, dtype=torch.int32, device=dev)


def _int8_bound(live, b, h, d, table_entries=0):
    """Bound of an int8 decode launch: every live position's K/V int8 and
    its two f32 scales, q and the output in bf16, the table entries."""
    return _bound(live * h * (2 * d + 2 * 4) + 2 * b * h * d * 2 + table_entries * 4,
                  4 * live * h * d, INT8_OPS, exps=live * h)


def _long_kernel_rows(launches):
    """Rows 4 and 5 (the int8 decode kernels) at the long phase's shapes,
    with the paged bf16 and int8 kernels timed on the same 8 rows at each
    of :data:`CROSSOVER_CONTEXTS` (row 4's ``by_context``), and the flash
    forward's ``long_context`` entry at B1 H8 S16000."""
    import torch.nn.functional as F

    from distriflow_tpu_torch.ops import flash_attention as fa
    from distriflow_tpu_torch.ops import flash_decode as fd

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    flush = _flush_buffer()
    h, d, ps = 8, 64, 128
    pp = LONG_MAX_SEQ // ps
    no_library = ("no single PyTorch call computes attention over int8 K/V with per-(position, "
                  "head) scales folded into the scores and probabilities")
    rows = []

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev, dtype=torch.float32).to(torch.bfloat16)

    # paged int8: the engine's 8 rows at the end of their 64 new tokens
    lens_l = [n + N_TOKENS for n in LONG_LENS] + [SHARED + SHARER_OWN + N_TOKENS]
    n_pages = sum(-(-n // ps) for n in lens_l) + 8
    k8, v8, ks, vs = _int8_cache(g, (n_pages, ps), h, d)
    table, lens = _paged_rows(g, lens_l, ps, n_pages, pp)
    q = randn(len(lens_l), h, d)
    args = (q, k8, v8, ks, vs, table, lens)
    err = _over("flash_decode_paged_int8", fd.flash_decode_paged_int8(*args),
                fd.flash_decode_paged_int8_reference(*args), *TOL["flash_decode_paged_int8"])
    tb, by = _int8_bound(sum(lens_l), len(lens_l), h, d, int((table < n_pages).sum()))
    by_context = {}
    for ctx in CROSSOVER_CONTEXTS:
        n_pg = 8 * -(-ctx // ps)
        ck8, cv8, cks, cvs = _int8_cache(g, (n_pg, ps), h, d)
        kb, vb = randn(n_pg, ps, h * d), randn(n_pg, ps, h * d)
        ctab, clens = _paged_rows(g, [ctx] * 8, ps, n_pg, pp)
        qc = randn(8, h, d)
        by_context[str(ctx)] = {
            "bf16_ms": _timed(lambda: fd.flash_decode_paged(qc, kb, vb, ctab, clens), 100, flush),
            "int8_ms": _timed(lambda: fd.flash_decode_paged_int8(qc, ck8, cv8, cks, cvs, ctab, clens),
                              100, flush),
            "bf16_bound_ms": _bound(2 * 8 * ctx * h * d * 2, 4 * 8 * ctx * h * d,
                                    exps=8 * ctx * h)[0],
            "int8_bound_ms": _int8_bound(8 * ctx, 8, h, d)[0]}
        del ck8, cv8, cks, cvs, kb, vb
    rows.append({
        "name": "flash_decode_paged_int8", "route": "cuda",
        "source": "distriflow_tpu_torch/csrc/flash_decode.cu",
        "replaces": "distriflow_tpu/ops/flash_decode.py:484",
        "launches": launches["flash_decode_paged_int8"], "max_abs_err": err,
        "tol": _tol("flash_decode_paged_int8"),
        "ms": _timed(lambda: fd.flash_decode_paged_int8(*args), 100, flush),
        "plain_ms": _timed(lambda: fd.flash_decode_paged_int8_reference(*args), 3, flush),
        "bound_ms": tb, "bound_by": by, "library_ms": None, "library_note": no_library,
        "shape": f"B={len(lens_l)} H={h} D={d} page={ps} contexts={lens_l} int8",
        "by_context": by_context,
        "edges_max_abs_err": _decode_edges("flash_decode_paged_int8", g, True),
        **_decode_checks("flash_decode_paged_int8", lambda: fd.flash_decode_paged_int8(*args),
                         lambda: fd.flash_decode_paged_int8_reference(*args),
                         lambda: fd.split_partials(q, k8, v8, lens, table, ks, vs), flush, 100),
    })
    del k8, v8, ks, vs, args

    # slab int8: the beam's 4 rows at its last step
    b, n = BEAM_SIZE, BEAM_PROMPT + BEAM_TOKENS - 1
    k8, v8, ks, vs = _int8_cache(g, (b, LONG_MAX_SEQ), h, d)
    q = randn(b, h, d)
    args = (q, k8, v8, ks, vs, n)
    err = _over("flash_decode_int8", fd.flash_decode_int8(*args),
                fd.flash_decode_int8_reference(*args), *TOL["flash_decode_int8"])
    tb, by = _int8_bound(b * n, b, h, d)
    rows.append({
        "name": "flash_decode_int8", "route": "cuda",
        "source": "distriflow_tpu_torch/csrc/flash_decode.cu",
        "replaces": "distriflow_tpu/ops/flash_decode.py:245",
        "launches": launches["flash_decode_int8"], "max_abs_err": err,
        "tol": _tol("flash_decode_int8"),
        "ms": _timed(lambda: fd.flash_decode_int8(*args), 100, flush),
        "plain_ms": _timed(lambda: fd.flash_decode_int8_reference(*args), 3, flush),
        "bound_ms": tb, "bound_by": by, "library_ms": None, "library_note": no_library,
        "shape": f"B={b} S={LONG_MAX_SEQ} valid={n} H={h} D={d} int8",
        "edges_max_abs_err": _decode_edges("flash_decode_int8", g, True),
        **_decode_checks("flash_decode_int8", lambda: fd.flash_decode_int8(*args),
                         lambda: fd.flash_decode_int8_reference(*args),
                         lambda: fd.split_partials(q, k8, v8, n, None, ks, vs), flush, 100),
    })
    del k8, v8, ks, vs, args

    # slab int8 at the long solo generate()'s shape: B1, the longest prompt
    # at its last new token
    n = LONG_LENS[-1] + N_TOKENS - 1
    k8, v8, ks, vs = _int8_cache(g, (1, LONG_MAX_SEQ), h, d)
    args = (randn(1, h, d), k8, v8, ks, vs, n)
    tb, by = _int8_bound(n, 1, h, d)
    rows[-1]["long_solo"] = {
        "shape": f"B=1 S={LONG_MAX_SEQ} valid={n} H={h} D={d} int8",
        "max_abs_err": _over("flash_decode_int8 long solo", fd.flash_decode_int8(*args),
                             fd.flash_decode_int8_reference(*args), *TOL["flash_decode_int8"]),
        "ms": _timed(lambda: fd.flash_decode_int8(*args), 100, flush),
        "plain_ms": _timed(lambda: fd.flash_decode_int8_reference(*args), 3, flush),
        "bound_ms": tb, "bound_by": by,
        "by_split_tiles": _decode_checks(
            "flash_decode_int8", lambda: fd.flash_decode_int8(*args),
            lambda: fd.flash_decode_int8_reference(*args),
            lambda: fd.split_partials(*args[:3], n, None, *args[3:5]), flush, 100)["by_split_tiles"]}
    del k8, v8, ks, vs, args

    # the flash forward at the longest prompt; its plain version one head
    # at a time (the [S, S] f32 scores of all heads at once would take 8 GB)
    s = LONG_LENS[-1]
    q, k, v = (randn(1, h, s, d) for _ in range(3))
    o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)

    def plain():
        return [fa.flash_attention_reference(q[:, i:i + 1], k[:, i:i + 1], v[:, i:i + 1], True)
                for i in range(h)]

    ref = plain()
    ro, rl = torch.cat([r[0] for r in ref], 1), torch.cat([r[1] for r in ref], 1)
    del ref
    pairs = s * (s + 1) // 2
    tb, by = _bound(4 * h * s * d * 2 + h * s * 4, 4 * h * pairs * d, exps=h * pairs)
    long_context = {
        "shape": f"B=1 H={h} S={s} D={d} causal",
        "max_abs_err": _over("flash_attention_fwd O long", o, ro, *TOL["flash_attention_fwd"]),
        "lse_max_abs_err": _over("flash_attention_fwd lse long", lse, rl, LSE_ATOL, 0.0),
        "ms": _timed(lambda: fa.flash_attention(q, k, v, causal=True, return_lse=True), 10, flush),
        "plain_ms": _timed(plain, 1, flush),
        "bound_ms": tb, "bound_by": by,
        "library_ms": _timed(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
                             10, flush)}
    return rows, long_context


def _mobilenet_tree(rng: np.random.Generator, classes: int, width: float):
    """A flax-shaped MobileNetV2 params tree (GroupNorm, the fused
    depthwise branch) with lecun-normal-scaled random kernels, GroupNorm
    scale 1 and bias 0, as flax initialises them."""
    from distriflow_tpu_torch.models.mobilenet import V2_SCHEDULE, _make_divisible

    def w(*shape, fan_in):
        return rng.standard_normal(shape, dtype=np.float32) / np.float32(math.sqrt(fan_in))

    def affine(c):
        return {"scale": np.ones(c, np.float32), "bias": np.zeros(c, np.float32)}

    def conv_norm(cin, cout, k=1):
        return {"Conv_0": {"kernel": w(k, k, cin, cout, fan_in=k * k * cin)},
                "GroupNorm_0": affine(cout)}

    ch = _make_divisible(32 * width)
    p = {"_ConvNorm_0": conv_norm(3, ch, 3)}
    i = 0
    for t, c, n, _ in V2_SCHEDULE:
        out = _make_divisible(c * width)
        for _ in range(n):
            layers = [conv_norm(ch, ch * t)] if t != 1 else []
            layers += [{"kernel": w(3, 3, 1, ch * t, fan_in=9), **affine(ch * t)},
                       conv_norm(ch * t, out)]
            p[f"InvertedResidual_{i}"] = {f"_ConvNorm_{j}": layer for j, layer in enumerate(layers)}
            ch, i = out, i + 1
    head = _make_divisible(1280 * max(1.0, width))
    p["_ConvNorm_1"] = conv_norm(ch, head)
    p["Dense_0"] = {"kernel": w(head, classes, fan_in=head), "bias": np.zeros(classes, np.float32)}
    return {"params": p}


def _depthwise_shapes(image_size: int, width: float):
    """{(H, W, C, stride): blocks} of MobileNetV2's depthwise convs."""
    from distriflow_tpu_torch.models.mobilenet import V2_SCHEDULE, _make_divisible

    s, ch, shapes = -(-image_size // 2), _make_divisible(32 * width), {}
    for t, c, n, first in V2_SCHEDULE:
        for j in range(n):
            stride = first if j == 0 else 1
            key = (s, s, ch * t, stride)
            shapes[key] = shapes.get(key, 0) + 1
            s, ch = -(-s // stride), _make_divisible(c * width)
    return shapes


def _synthetic_imagenet(n_train, n_val, num_classes, image_size, seed):
    """The JAX repo's experiments/imagenet_subset/data.py::synthetic_imagenet
    recipe: a 6x6x3 pattern per class, upsampled, plus noise, as uint8."""
    rng = np.random.RandomState(seed)
    patterns = rng.rand(num_classes, 6, 6, 3)
    rep = image_size // 6 + 1

    def make(n):
        labels = rng.randint(0, num_classes, n).astype(np.int32)
        base = np.repeat(np.repeat(patterns[labels], rep, axis=1), rep, axis=2)
        base = base[:, :image_size, :image_size]
        noise = rng.rand(n, image_size, image_size, 3) * 0.25
        return ((base * 0.75 + noise) * 255).astype(np.uint8), labels

    return make(n_train), make(n_val)


def _mobilenet_spec(device="cuda", f32=False, size=None):
    """The slice's MobileNetV2 spec (``MN`` unless ``size``): fused
    depthwise kernels, uint8 input, sparse CE (the CLI's ``--wire-format
    u8``), in bf16, or with ``f32`` at the model's default dtype (f32)."""
    from distriflow_tpu_torch.models.base import with_uint8_inputs
    from distriflow_tpu_torch.models.mobilenet import mobilenet_v2

    dtype = {} if f32 else {"dtype": torch.bfloat16}
    spec = mobilenet_v2(**(size or MN), norm="group", depthwise_impl="fused", gn_impl="flax",
                        device=device, **dtype)
    return dataclasses.replace(with_uint8_inputs(spec), loss="sparse_softmax_cross_entropy")


def _mobilenet_phase(tree, counted, device="cuda", f32=False):
    """MobileNetV2 trained ``MN_STEPS`` steps by the port's ``run_chunked``
    over ``sampling_iterator`` + ``prefetch_to_device``, then evaluated by
    ``evaluate_dataset`` on the validation split, each in its own launch
    window, in bf16 or (``f32``) at the model's default f32. Returns
    ``(report, trainer, a batch, launch counts by window)``."""
    from distriflow_tpu_torch.data.prefetch import prefetch_to_device, sampling_iterator, to_uint8_wire
    from distriflow_tpu_torch.models.convert import mobilenet_params_from_jax
    from distriflow_tpu_torch.train.loop import evaluate_dataset, run_chunked
    from distriflow_tpu_torch.train.sync import SyncTrainer

    if f32 and device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    train, val = _synthetic_imagenet(MN_TRAIN, MN_VAL, MN["classes"], MN["image_size"], SEED)
    x, y = to_uint8_wire(*train)
    vx, vy = to_uint8_wire(*val)
    data_s = time.perf_counter() - t0
    trainer = SyncTrainer(_mobilenet_spec(device, f32), optimizer="momentum", learning_rate=MN_LR)
    trainer.init(SEED)
    trainer.set_params(mobilenet_params_from_jax(tree))
    losses, step_ms = [], []
    trainer.callbacks.register("step", lambda t: step_ms.append(t.last_step_ms))
    stream = prefetch_to_device(sampling_iterator(x, y, MN_B, steps=MN_STEPS, seed=SEED), device)
    res, train_counts = counted(lambda: run_chunked(
        trainer, stream, steps=MN_STEPS, log=lambda s, l: losses.append(l), log_every=1))
    (val_loss, val_acc), eval_counts = counted(
        lambda: evaluate_dataset(trainer.evaluate, vx, vy, batch_size=MN_B))
    assert res.steps_run == MN_STEPS and len(losses) == MN_STEPS, res
    assert all(math.isfinite(v) for v in losses), losses
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    assert last < first, f"MobileNet loss did not fall: first 5 mean {first}, last 5 mean {last}"
    assert math.isfinite(val_loss) and 0.0 <= val_acc <= 1.0, (val_loss, val_acc)
    p50 = float(np.median(step_ms))
    report = {
        "config": {**MN, "batch": MN_B, "dtype": "float32" if f32 else "bfloat16",
                   "depthwise_impl": "fused", "gn_impl": "flax", "norm": "group",
                   "wire": "uint8", "loss": trainer.spec.loss, "optimizer": "momentum",
                   "lr": MN_LR},
        "steps": MN_STEPS, "train_images": MN_TRAIN, "val_images": MN_VAL, "data_s": data_s,
        "step_ms_p50": p50, "step_ms_max": max(step_ms), "step_ms_first": step_ms[0],
        "samples_per_s": MN_B / (p50 / 1e3),
        "steady_samples_per_s": res.steps_per_sec * MN_B,
        "first_loss": losses[0], "last_loss": losses[-1], "first5_mean": first,
        "last5_mean": last, "losses": losses, "val_loss": val_loss, "val_accuracy": val_acc,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9 if device == "cuda" else None}
    batch = next(sampling_iterator(x, y, MN_B, steps=1, seed=SEED + 1))
    tag = "mobilenet_f32" if f32 else "mobilenet"
    return report, trainer, batch, {f"{tag}_train": train_counts, f"{tag}_eval": eval_counts}


def _mobilenet_224(counted, device="cuda"):
    """MobileNetV2 at 224 px (1000 classes, width 1.0, the model's default
    f32, the fused depthwise at all 17 blocks): ``MN224_STEPS`` steps of
    B ``MN224_B`` through ``SyncTrainer`` in one launch window, from a
    seeded tree on the synthetic ImageNet recipe. Returns ``(report,
    counts)``."""
    from distriflow_tpu_torch.data.prefetch import prefetch_to_device, sampling_iterator, to_uint8_wire
    from distriflow_tpu_torch.models.convert import mobilenet_params_from_jax
    from distriflow_tpu_torch.train.loop import run_chunked
    from distriflow_tpu_torch.train.sync import SyncTrainer

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    n = MN224_B * MN224_STEPS
    (x, y), _ = _synthetic_imagenet(n, 0, MN224["classes"], MN224["image_size"], SEED + 7)
    x, y = to_uint8_wire(x, y)
    tree = _mobilenet_tree(np.random.default_rng(SEED + 7), MN224["classes"], MN224["width"])
    trainer = SyncTrainer(_mobilenet_spec(device, f32=True, size=MN224), optimizer="momentum",
                          learning_rate=MN_LR)
    trainer.init(SEED)
    trainer.set_params(mobilenet_params_from_jax(tree))
    del tree
    losses, step_ms = [], []
    trainer.callbacks.register("step", lambda t: step_ms.append(t.last_step_ms))
    stream = prefetch_to_device(sampling_iterator(x, y, MN224_B, steps=MN224_STEPS, seed=SEED),
                                device)
    res, counts = counted(lambda: run_chunked(
        trainer, stream, steps=MN224_STEPS, log=lambda s, l: losses.append(l), log_every=1))
    assert res.steps_run == MN224_STEPS and len(losses) == MN224_STEPS, res
    assert all(math.isfinite(v) for v in losses), losses
    report = {"config": {**MN224, "batch": MN224_B, "dtype": "float32", "depthwise_impl": "fused",
                         "wire": "uint8", "loss": trainer.spec.loss, "optimizer": "momentum",
                         "lr": MN_LR},
              "steps": MN224_STEPS, "losses": losses, "step_ms": step_ms,
              "samples_per_s": MN224_B / (float(np.median(step_ms)) / 1e3),
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9 if device == "cuda" else None}
    return report, counts


def _mobilenet_f32_phase(tree, counted, device="cuda"):
    """MobileNetV2 at its default f32 with the fused depthwise: (a) the
    bf16 phase's recipe (:func:`_mobilenet_phase`), with one profiled step
    after its windows; (b) one step against the plain depthwise versions;
    (c) 224 px (:func:`_mobilenet_224`). Returns ``(report, counts by
    window)``."""
    report, trainer, batch, counts = _mobilenet_phase(tree, counted, device, f32=True)
    # the pointwise and stem convolutions run through cuDNN under torch's
    # default, which the package leaves alone
    report["cudnn_allow_tf32"] = torch.backends.cudnn.allow_tf32
    report["step_profile"] = (_profiled(lambda: trainer.step(batch), DWGN_F32_KERNELS)
                              if device == "cuda" else None)
    del trainer
    report["step_vs_plain"] = _mobilenet_step_vs_plain(tree, batch, device, f32=True)
    report["px224"], counts["mobilenet_f32_224"] = _mobilenet_224(counted, device)
    return report, counts


#: the f32 depthwise kernels by name in a profile: these designs' and the
#: bf16 templates' f32 instances before them
DWGN_F32_KERNELS = {"dwgn_bwd_f32": ("f32bwd::bwd_kernel",
                                     "dwgn_bwd_kernel<(anonymous namespace)::F32>"),
                    "dwgn_fwd_f32": ("f32fwd::fwd_kernel",
                                     "dwgn_fwd_kernel<(anonymous namespace)::F32>")}
#: steps of the f32 MobileNet step before its profiled one
MN_F32_STEP_WARM = 4


def _mobilenet_f32_step():
    """The f32 MobileNetV2 step (96 px, :data:`MN`) of the
    ``distriflow_tpu_torch`` first on ``sys.path``: from the seeded tree
    the smoke trains, ``MN_F32_STEP_WARM`` steps of B ``MN_B`` on the
    synthetic ImageNet recipe, then one more under the profiler; ``{
    "step_ms_p50", "profile"}`` (the profile's ``kernel_ms`` holds the f32
    depthwise kernels' device ms), what ``--parent`` runs on an older
    checkout before and after this one's."""
    from distriflow_tpu_torch.data.prefetch import sampling_iterator, to_uint8_wire
    from distriflow_tpu_torch.models.convert import mobilenet_params_from_jax
    from distriflow_tpu_torch.train.sync import SyncTrainer

    steps = MN_F32_STEP_WARM + 1
    (x, y), _ = _synthetic_imagenet(MN_B * steps, 0, MN["classes"], MN["image_size"], SEED)
    x, y = to_uint8_wire(x, y)
    tree = _mobilenet_tree(np.random.default_rng(SEED + 6), MN["classes"], MN["width"])
    trainer = SyncTrainer(_mobilenet_spec("cuda", f32=True), optimizer="momentum",
                          learning_rate=MN_LR)
    trainer.init(SEED)
    trainer.set_params(mobilenet_params_from_jax(tree))
    del tree
    step_ms = []
    trainer.callbacks.register("step", lambda t: step_ms.append(t.last_step_ms))
    batches = list(sampling_iterator(x, y, MN_B, steps=steps, seed=SEED))
    for batch in batches[:-1]:
        trainer.step(batch)
    profile = _profiled(lambda: trainer.step(batches[-1]), DWGN_F32_KERNELS)
    del trainer
    return {"step_ms_p50": float(np.median(step_ms[:MN_F32_STEP_WARM])), "profile": profile}


def _mobilenet_step_vs_plain(tree, batch, device="cuda", f32=False):
    """One step's loss and gradients through the depthwise kernels and
    through their plain versions (patched in for the wrappers, forward and
    backward), from the same f32 masters and batch, in bf16 or (``f32``)
    at the model's default f32."""
    from unittest import mock

    from distriflow_tpu_torch.models.convert import mobilenet_params_from_jax
    from distriflow_tpu_torch.ops import depthwise_gn as dg

    def plain():
        stack = contextlib.ExitStack()
        stack.enter_context(mock.patch.object(dg, "depthwise_gn_forward",
                                              dg.depthwise3x3_groupnorm_reference))
        stack.enter_context(mock.patch.object(dg, "depthwise_gn_backward",
                                              dg.depthwise3x3_groupnorm_backward_reference))
        return stack

    x, y = (torch.as_tensor(a, device=device) for a in batch)
    spec, out = _mobilenet_spec(device, f32), {}
    for name in ("kernels", "plain"):
        model = spec.init(SEED)
        model.load_state_dict(mobilenet_params_from_jax(tree), strict=True)
        with plain() if name == "plain" else contextlib.nullcontext():
            loss, grads = spec.grad_fn()(model, x, y)
        out[name] = (float(loss), grads)
        del model
    return _grads_vs_plain(out, MN_F32_STEP_TOL if f32 else MN_STEP_TOL, "loss_rel")


def _dwgn_inputs(g, b, h, w, c, dtype=torch.bfloat16):
    """NHWC x ~ N(0, 1), a lecun-scaled [3, 3, C] kernel (both in
    ``dtype``), affine near flax's init, and an upstream gradient ~ U(0,
    1): of nonzero mean, so the GroupNorm statistics' terms carry real
    weight in dx."""
    dev = torch.device("cuda")
    x = torch.randn(b, h, w, c, generator=g, device=dev).to(dtype)
    k = (torch.randn(3, 3, c, generator=g, device=dev) / 3).to(dtype)
    scale = 1 + 0.1 * torch.randn(c, generator=g, device=dev)
    bias = 0.1 * torch.randn(c, generator=g, device=dev)
    return x, k, scale, bias


def _dwgn_bwd_check(name, got, want):
    """Max abs error of dx and the share of its elements outside the
    elementwise limit (at most ``DWGN_FLIP_SHARE``); dw, dscale and dbias
    within ``DWGN_SUM_RTOL`` of their largest plain element."""
    atol, rtol = TOL["depthwise_gn_bwd"]
    dx, dxr = got[0].float(), want[0].float()
    err = (dx - dxr).abs()
    share = float((err > atol + rtol * dxr.abs()).float().mean())
    if share > DWGN_FLIP_SHARE:
        raise AssertionError(f"{name}: {share} of dx outside atol {atol} + rtol {rtol} "
                             f"(limit {DWGN_FLIP_SHARE}), max abs err {float(err.max())}")
    sums = {}
    for n, a, r in zip(("dw", "dscale", "dbias"), got[1:], want[1:]):
        e, big = float((a.float() - r.float()).abs().max()), float(r.float().abs().max())
        if e > DWGN_SUM_RTOL * big:
            raise AssertionError(f"{name}: {n} off by {e} > {DWGN_SUM_RTOL} x {big}")
        sums[n] = e / big
    return float(err.max()), share, sums


def _dwgn_library(x, k, scale, bias, stride):
    """The three-call composition cuDNN depthwise conv + F.group_norm +
    F.hardtanh(0, 6) on NHWC x (a yardstick only)."""
    import torch.nn.functional as F

    from distriflow_tpu_torch.ops.depthwise_gn import _same_pads

    ph, pw = _same_pads(x.shape[1], stride), _same_pads(x.shape[2], stride)
    xp = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1])).permute(0, 3, 1, 2)
    y = F.conv2d(xp, k, stride=stride, groups=x.shape[3])
    y = F.group_norm(y, x.shape[3] // 8, scale, bias, eps=1e-6)
    return F.hardtanh(y, 0.0, 6.0)


DWGN_BIG, DWGN_SMALL = (48, 48, 96, 2), (3, 3, 960, 1)


def _dwgn_cases(shapes, batch=MN_B, dtype=torch.bfloat16, seed=SEED + 5):
    """``(shape, x, k, scale, bias, g)`` of every depthwise shape at B
    ``batch`` in ``dtype``, drawn in order from one seeded generator: the
    same tensors in every run and every checkout."""
    from distriflow_tpu_torch.ops import depthwise_gn as dg

    g = torch.Generator(device="cuda").manual_seed(seed)
    for key in shapes:
        h, w, c, s = key
        x, k, sc, bi = _dwgn_inputs(g, batch, h, w, c, dtype)
        _, _, oh, ow = dg._geometry(h, w, s)
        gout = torch.rand(batch, oh, ow, c, generator=g, device="cuda").to(dtype)
        yield key, x, k, sc, bi, gout


def _dwgn_times(shapes):
    """``{shape: [forward ms, backward ms]}`` of the depthwise kernels of
    the ``distriflow_tpu_torch`` first on ``sys.path``, timed as rows 11-12
    time them."""
    from distriflow_tpu_torch.ops import depthwise_gn as dg

    flush, out = _flush_buffer(), {}
    for (h, w, c, s), x, k, sc, bi, gout in _dwgn_cases(shapes):
        iters = 20 if (h, w, c, s) in (DWGN_BIG, DWGN_SMALL) else 5
        out[f"{h}x{w}x{c} s{s}"] = [
            _timed(lambda: dg.depthwise_gn_forward(x, k, sc, bi, s), iters, flush),
            _timed(lambda: dg.depthwise_gn_backward(x, k, sc, bi, gout, s), iters, flush)]
    return out


def _plan_of(plan, batch):
    f32_fwd = {"strip": plan.strip, "keep": plan.keep} if plan.strip else {}
    return {"cc": plan.cc, "cluster": plan.cluster, "tile": [plan.rows, plan.cols],
            "tiles_per_cta": plan.tiles_per_cta, "images_per_cta": plan.images,
            "ctas": plan.ctas(batch), "smem_bytes": plan.smem, **f32_fwd}


def _with_was(rows, shapes, was):
    """Rows 11-12 with ``was_ms`` beside each shape and the step's sum:
    the :func:`_dwgn_times` runs of an older checkout in ``was``."""
    for i, row in enumerate(rows):
        for (h, w, c, s), count in shapes.items():
            tag = f"{h}x{w}x{c} s{s}"
            row["by_shape"][tag]["was_ms"] = [run[tag][i] for run in was] or "not measured"
        row["step_was_ms_all_blocks"] = [
            sum(count * run[f"{h}x{w}x{c} s{s}"][i] for (h, w, c, s), count in shapes.items())
            for run in was] or "not measured"
    return rows


def _mobilenet_kernel_rows(launches, shapes):
    """Rows 11 and 12: each depthwise shape of one step at B ``MN_B`` held
    against the plain versions; times (kernel, plain, the library
    composition, bound) at the largest-bytes shape (48x48x96 stride 2) and
    the smallest (3x3x960), and the kernel and bound summed over all 17
    blocks of a step."""
    from distriflow_tpu_torch.ops import depthwise_gn as dg

    flush = _flush_buffer()
    big, small = DWGN_BIG, DWGN_SMALL
    lib_note = ("composition of three calls (cuDNN depthwise F.conv2d(groups=C) + F.group_norm + "
                "F.hardtanh(0, 6); autograd through it for the backward): no single PyTorch "
                "call computes this function")
    fwd = {"errs": [], "by_shape": {}, "ms": 0.0, "bound": 0.0}
    bwd = {"errs": [], "shares": [], "sums": {}, "by_shape": {}, "ms": 0.0, "bound": 0.0}
    controls, fwd_controls, same_bits = {}, {}, True
    for (h, w, c, s), x, k, sc, bi, gout in _dwgn_cases(shapes):
        key, count = (h, w, c, s), shapes[(h, w, c, s)]
        _, _, oh, ow = dg._geometry(h, w, s)
        tag = f"{h}x{w}x{c} s{s}"
        y = dg.depthwise_gn_forward(x, k, sc, bi, s)
        y_want = dg.depthwise3x3_groupnorm_reference(x, k, sc, bi, s)
        fwd["errs"].append(_over(f"depthwise_gn_fwd {tag}", y, y_want, *TOL["depthwise_gn_fwd"]))
        assert fwd["errs"][-1] == 0.0, f"depthwise_gn_fwd {tag}: not bit for bit ({fwd['errs'][-1]})"
        want = dg.depthwise3x3_groupnorm_backward_reference(x, k, sc, bi, gout, s)
        got = dg.depthwise_gn_backward(x, k, sc, bi, gout, s)
        err, share, sums = _dwgn_bwd_check(f"depthwise_gn_bwd {tag}", got, want)
        again = dg.depthwise_gn_backward(x, k, sc, bi, gout, s)
        same_bits &= torch.equal(y, dg.depthwise_gn_forward(x, k, sc, bi, s)) and all(
            torch.equal(a, b) for a, b in zip(got, again))
        assert same_bits, f"depthwise {tag}: a second launch gave other bits"
        plans = {"fwd": _plan_of(dg.dwgn_plan(h, w, c, s, False), MN_B),
                 "bwd": _plan_of(dg.dwgn_plan(h, w, c, s, True), MN_B)}
        fwd["by_shape"][tag] = {"blocks_per_step": count, "plan": plans["fwd"]}
        bwd["by_shape"][tag] = {"blocks_per_step": count, "plan": plans["bwd"]}
        bwd["errs"].append(err)
        bwd["shares"].append(share)
        for n, v in sums.items():
            bwd["sums"][n] = max(bwd["sums"].get(n, 0.0), v)
        n_out = MN_B * oh * ow * c
        io = MN_B * h * w * c * 2 + 9 * c * 2 + 2 * c * 4
        fb = _bound(io + n_out * 2, 28 * n_out, F32_FLOPS)
        bb = _bound(io + n_out * 2 + MN_B * h * w * c * 2 + 9 * c * 2 + 2 * c * 4, 56 * n_out,
                    F32_FLOPS)
        iters = 20 if key in (big, small) else 5
        tf = _timed(lambda: dg.depthwise_gn_forward(x, k, sc, bi, s), iters, flush)
        tb = _timed(lambda: dg.depthwise_gn_backward(x, k, sc, bi, gout, s), iters, flush)
        fwd["ms"] += count * tf
        bwd["ms"] += count * tb
        fwd["bound"] += count * fb[0]
        bwd["bound"] += count * bb[0]
        fwd["by_shape"][tag].update(ms=tf, max_abs_err=fwd["errs"][-1])
        bwd["by_shape"][tag].update(ms=tb, max_abs_err=err, dx_outside_share=share)
        if key not in (big, small):
            continue
        kl = k.permute(2, 0, 1).unsqueeze(1).contiguous()
        scb, bib = sc.to(torch.bfloat16), bi.to(torch.bfloat16)
        leaves = [t.detach().clone().requires_grad_() for t in (x, kl, scb, bib)]
        lib_out = _dwgn_library(*leaves, s)
        gout_nchw = gout.permute(0, 3, 1, 2)
        fwd["by_shape"][tag].update(
            plain_ms=_timed(lambda: dg.depthwise3x3_groupnorm_reference(x, k, sc, bi, s), 3, flush),
            bound_ms=fb[0], bound_by=fb[1],
            library_ms=_timed(lambda: _dwgn_library(x, kl, scb, bib, s), 20, flush))
        bwd["by_shape"][tag].update(
            sum_rel_err=sums,
            plain_ms=_timed(lambda: dg.depthwise3x3_groupnorm_backward_reference(
                x, k, sc, bi, gout, s), 3, flush),
            bound_ms=bb[0], bound_by=bb[1],
            library_ms=_timed(lambda: torch.autograd.grad(lib_out, leaves, gout_nchw,
                                                          retain_graph=True), 20, flush))
        if key == big:
            # the forward's limit must reject statistics taken from the
            # cluster's rank-0 tile alone (the plan's decomposition, a plain
            # mirror): on N(0, 1) inputs a third of the image's positions
            # move the mean and inv a little, and 0.41 of the outputs leave
            # the limit (measured on the H100); 0.1 keeps a margin
            wrong_y = dg.banded_forward_reference(x, k, sc, bi, s, stats_ranks=[0])
            atol, rtol = TOL["depthwise_gn_fwd"]
            fwd_controls["stats_from_rank0_only"] = float(
                ((wrong_y.float() - y_want.float()).abs()
                 > atol + rtol * y_want.float().abs()).float().mean())
            assert fwd_controls["stats_from_rank0_only"] > 0.1, \
                f"depthwise_gn_fwd limit passes rank-0-only statistics: {fwd_controls}"
            del wrong_y
            # the limit must reject a backward that treats the statistics as
            # constants (drops the mean and inv gradient terms)
            wrong = dg.depthwise3x3_groupnorm_backward_reference(x, k, sc, bi, gout, s,
                                                                 drop_stats=True)
            atol, rtol = TOL["depthwise_gn_bwd"]
            controls["stats_terms_dropped"] = float(
                ((wrong[0].float() - want[0].float()).abs()
                 > atol + rtol * want[0].float().abs()).float().mean())
            assert controls["stats_terms_dropped"] > 0.5, \
                f"depthwise_gn_bwd limit passes a gradient without the statistics terms: {controls}"
        del x, k, gout, want, got, again, y, y_want, leaves, lib_out
    shape_note = f"B={MN_B} NHWC bf16; 17 blocks of {len(shapes)} shapes; ms/plain/library at {{}}"
    rows = []
    for name, d, line, extra in (
            ("depthwise_gn_fwd", fwd, "distriflow_tpu/ops/depthwise_gn.py:180",
             {"rejected_share": fwd_controls}),
            ("depthwise_gn_bwd", bwd, "distriflow_tpu/ops/depthwise_gn.py:184",
             {"dx_outside_share_max": max(bwd["shares"]), "dx_outside_limit": DWGN_FLIP_SHARE,
              "sum_rel_err_max": bwd["sums"], "rejected_share": controls})):
        at = d["by_shape"][f"{big[0]}x{big[1]}x{big[2]} s{big[3]}"]
        rows.append({
            "name": name, "route": "cuda", "source": "distriflow_tpu_torch/csrc/depthwise_gn.cu",
            "replaces": line, "launches": launches[name],
            "launches_per_step": launches[name] / MN_STEPS, "max_abs_err": max(d["errs"]),
            "tol": _tol(name), "ms": at["ms"], "plain_ms": at["plain_ms"],
            "bound_ms": at["bound_ms"], "bound_by": at["bound_by"], "library_ms": at["library_ms"],
            "library_note": lib_note, "shape": shape_note.format("48x48x96 s2"),
            "by_shape": d["by_shape"], "step_ms_all_blocks": d["ms"],
            "step_bound_ms_all_blocks": d["bound"], "deterministic": same_bits, **extra})
    return rows


# the f32 rows' timed shapes: the largest-bytes and the smallest shape at
# 96 px (as the bf16 rows) and at 224 px
DWGN224_BIG, DWGN224_SMALL = (112, 112, 96, 2), (7, 7, 960, 1)
# (B, H, W, C, stride): a shape the JAX gate admits in f32 that no resident
# cut of the f32 forward fits, so its plan streams
DWGN_F32_STREAMED = (2, 280, 280, 8, 1)


def _dwgn_f32_check(name, got, want):
    """``(max abs err of dx, {sum: err / its largest element}, share of
    elements that differ by tensor)`` of an f32 backward against ``want``:
    dx, dscale and dbias within ``name``'s limit elementwise, dw within
    ``DWGN_F32_SUM_RTOL`` of its largest element (see the note above it)."""
    atol, rtol = TOL[name]
    names = ("dx", "dw", "dscale", "dbias")
    differ = {n: float((a != r).float().mean()) for n, a, r in zip(names, got, want)}
    err, sums = 0.0, {}
    for n, a, r in zip(names, got, want):
        if n == "dw":
            e, big = float((a - r).abs().max()), float(r.abs().max())
            if e > DWGN_F32_SUM_RTOL * big:
                raise AssertionError(f"{name}: dw off by {e} > {DWGN_F32_SUM_RTOL} x {big}")
            sums[n] = e / big
        else:
            e = _over(f"{name} {n}", a, r, atol, rtol)
            if n == "dx":
                err = e
            else:
                sums[n] = e / float(r.abs().max())
    return err, sums, differ


def _mobilenet_f32_kernel_rows(launches):
    """Rows 11 and 12 in f32: every depthwise shape of MobileNetV2 at 96 px
    (B ``MN_B``) and at 224 px (B ``MN224_B``) held against the plain
    versions and the banded mirror of the f32 plan; kernel times at every
    shape, bounds at 4 bytes an element, and the plain versions' and the
    library composition's times (cuDNN depthwise in f32 + F.group_norm +
    F.hardtanh, TF32 off) at the largest-bytes and the smallest shape of
    each resolution; the planted faults at 48x48x96 s2."""
    from distriflow_tpu_torch.ops import depthwise_gn as dg

    flush = _flush_buffer()
    timed_at = (DWGN_BIG, DWGN_SMALL, DWGN224_BIG, DWGN224_SMALL)
    lib_note = ("composition of three calls (cuDNN depthwise F.conv2d(groups=C) in f32 with "
                "cudnn.allow_tf32 off + F.group_norm + F.hardtanh(0, 6); autograd through it for "
                "the backward): no single PyTorch call computes this function")
    fwd, bwd = ({"errs": [], "by_shape": {}, "ms": {}, "bound": {}, "differ": {}, "sums": {}}
                for _ in range(2))
    controls, fwd_controls, same_bits = {}, {}, True
    for px, batch, size in ((96, MN_B, MN), (224, MN224_B, MN224)):
        shapes = _depthwise_shapes(size["image_size"], size["width"])
        for d in (fwd, bwd):
            d["ms"][px] = d["bound"][px] = 0.0
        for key, x, k, sc, bi, gout in _dwgn_cases(shapes, batch, torch.float32, SEED + 8):
            (h, w, c, s), count = key, shapes[key]
            _, _, oh, ow = dg._geometry(h, w, s)
            tag = f"{px}px {h}x{w}x{c} s{s}"
            y = dg.depthwise_gn_forward(x, k, sc, bi, s)
            y_want = dg.depthwise3x3_groupnorm_reference(x, k, sc, bi, s)
            y_band = dg.banded_forward_reference(x, k, sc, bi, s)
            fwd["errs"].append(_over(f"depthwise_gn_fwd_f32 {tag}", y, y_want,
                                     *TOL["depthwise_gn_fwd_f32"]))
            _over(f"depthwise_gn_fwd_f32 {tag} (banded)", y, y_band, *TOL["depthwise_gn_fwd_f32"])
            fwd["differ"][tag] = {"y": float((y != y_want).float().mean()),
                                  "y_vs_banded": float((y != y_band).float().mean())}
            assert not any(fwd["differ"][tag].values()), \
                f"depthwise_gn_fwd_f32 {tag}: not bit for bit ({fwd['differ'][tag]})"
            want = dg.depthwise3x3_groupnorm_backward_reference(x, k, sc, bi, gout, s)
            band = dg.banded_backward_reference(x, k, sc, bi, gout, s)
            got = dg.depthwise_gn_backward(x, k, sc, bi, gout, s)
            err, sums, differ = _dwgn_f32_check("depthwise_gn_bwd_f32", got, want)
            _dwgn_f32_check("depthwise_gn_bwd_f32", got, band)
            bwd["errs"].append(err)
            bwd["differ"][tag] = differ
            for n, v in sums.items():
                bwd["sums"][n] = max(bwd["sums"].get(n, 0.0), v)
            again = dg.depthwise_gn_backward(x, k, sc, bi, gout, s)
            same_bits &= torch.equal(y, dg.depthwise_gn_forward(x, k, sc, bi, s)) and all(
                torch.equal(a, b) for a, b in zip(got, again))
            assert same_bits, f"depthwise f32 {tag}: a second launch gave other bits"
            n_out, n_in = batch * oh * ow * c, batch * h * w * c
            io = n_in * 4 + 9 * c * 4 + 2 * c * 4
            fb = _bound(io + n_out * 4, 28 * n_out, F32_FLOPS)
            bb = _bound(io + n_out * 4 + n_in * 4 + 9 * c * 4 + 2 * c * 4, 56 * n_out, F32_FLOPS)
            iters = 20 if key in timed_at else 5
            tf = _timed(lambda: dg.depthwise_gn_forward(x, k, sc, bi, s), iters, flush)
            tb = _timed(lambda: dg.depthwise_gn_backward(x, k, sc, bi, gout, s), iters, flush)
            for d, t, bnd, plan_bwd in ((fwd, tf, fb, False), (bwd, tb, bb, True)):
                d["ms"][px] += count * t
                d["bound"][px] += count * bnd[0]
                d["by_shape"][tag] = {
                    "blocks_per_step": count, "batch": batch, "ms": t, "bound_ms": bnd[0],
                    "bound_by": bnd[1],
                    "plan": _plan_of(dg.dwgn_plan(h, w, c, s, plan_bwd, 4), batch)}
            for d, plan_bwd in ((fwd, False), (bwd, True)):
                d["by_shape"][tag]["plan"]["ctas_per_sm"] = dg.f32_ctas_per_sm(
                    dg.dwgn_plan(h, w, c, s, plan_bwd, 4))
            fwd["by_shape"][tag]["max_abs_err"] = fwd["errs"][-1]
            bwd["by_shape"][tag].update(max_abs_err=err, sum_rel_err=sums)
            if key in timed_at:
                kl = k.permute(2, 0, 1).unsqueeze(1).contiguous()
                tf32 = torch.backends.cudnn.allow_tf32
                torch.backends.cudnn.allow_tf32 = False
                try:
                    leaves = [t.detach().clone().requires_grad_() for t in (x, kl, sc, bi)]
                    lib_out = _dwgn_library(*leaves, s)
                    gout_nchw = gout.permute(0, 3, 1, 2)
                    fwd["by_shape"][tag].update(
                        plain_ms=_timed(lambda: dg.depthwise3x3_groupnorm_reference(
                            x, k, sc, bi, s), 3, flush),
                        library_ms=_timed(lambda: _dwgn_library(x, kl, sc, bi, s), 20, flush))
                    bwd["by_shape"][tag].update(
                        plain_ms=_timed(lambda: dg.depthwise3x3_groupnorm_backward_reference(
                            x, k, sc, bi, gout, s), 3, flush),
                        library_ms=_timed(lambda: torch.autograd.grad(
                            lib_out, leaves, gout_nchw, retain_graph=True), 20, flush))
                finally:
                    torch.backends.cudnn.allow_tf32 = tf32
                del leaves, lib_out
            if key == DWGN_BIG:
                # the limits must reject statistics from one position
                # slice of each channel alone (the forward's threads take
                # every slices-th unit; a lost slice or slot of its slice
                # sum) and a backward without the statistics' gradient
                atol, rtol = TOL["depthwise_gn_fwd_f32"]
                assert dg.dwgn_plan(h, w, c, s, False, 4).slices > 1
                wrong_y = dg.banded_forward_reference(x, k, sc, bi, s, stats_slices=[0])
                fwd_controls["stats_from_slice0_only"] = float(
                    ((wrong_y - y_want).abs() > atol + rtol * y_want.abs()).float().mean())
                assert fwd_controls["stats_from_slice0_only"] > 0.1, fwd_controls
                wrong = dg.depthwise3x3_groupnorm_backward_reference(x, k, sc, bi, gout, s,
                                                                     drop_stats=True)
                atol, rtol = TOL["depthwise_gn_bwd_f32"]
                controls["stats_terms_dropped"] = float(
                    ((wrong[0] - want[0]).abs() > atol + rtol * want[0].abs()).float().mean())
                assert controls["stats_terms_dropped"] > 0.5, controls
                # and dw from one position slice of each channel alone (the
                # kernel's threads take every slices-th position; a lost
                # slice or slot of its slice sum)
                nsl = dg.dwgn_plan(h, w, c, s, True, 4).slices
                assert nsl > 1, nsl
                wrong_dw = dg.banded_backward_reference(x, k, sc, bi, gout, s, dw_slices=[0])[1]
                controls["dw_from_slice0_only"] = float(
                    ((wrong_dw - want[1]).abs() > DWGN_F32_SUM_RTOL * want[1].abs().max())
                    .float().mean())
                assert controls["dw_from_slice0_only"] > 0.5, controls
                del wrong_y, wrong, wrong_dw
            del x, k, gout, want, band, got, again, y, y_want, y_band
    out = []
    for name, d, line, extra in (
            ("depthwise_gn_fwd_f32", fwd, "distriflow_tpu/ops/depthwise_gn.py:180",
             {"rejected_share": fwd_controls, "streamed": _dwgn_f32_streamed()}),
            ("depthwise_gn_bwd_f32", bwd, "distriflow_tpu/ops/depthwise_gn.py:184",
             {"sum_rel_err_max": bwd["sums"], "sum_limit": f"dw within {DWGN_F32_SUM_RTOL} of "
              "its largest element; dscale and dbias at the row's tol",
              "rejected_share": controls})):
        at = d["by_shape"][f"96px {DWGN_BIG[0]}x{DWGN_BIG[1]}x{DWGN_BIG[2]} s{DWGN_BIG[3]}"]
        out.append({
            "name": name, "route": "cuda", "source": "distriflow_tpu_torch/csrc/depthwise_gn.cu",
            "replaces": line, "launches": launches[name],
            "launches_per_step": launches[name] / MN_STEPS, "max_abs_err": max(d["errs"]),
            "tol": _tol(name), "ms": at["ms"], "plain_ms": at["plain_ms"],
            "bound_ms": at["bound_ms"], "bound_by": at["bound_by"], "library_ms": at["library_ms"],
            "library_note": lib_note,
            "shape": f"f32 NHWC; 17 blocks of 10 shapes at 96 px (B={MN_B}) and at 224 px "
                     f"(B={MN224_B}); ms/plain/library at 96px 48x48x96 s2",
            "by_shape": d["by_shape"], "differ_share": d["differ"],
            "step_ms_all_blocks": d["ms"][96], "step_bound_ms_all_blocks": d["bound"][96],
            "step224_ms_all_blocks": d["ms"][224], "step224_bound_ms_all_blocks": d["bound"][224],
            "deterministic": same_bits, **extra})
    return out


def _dwgn_f32_streamed():
    """The f32 forward at :data:`DWGN_F32_STREAMED`, whose plan streams
    (each pass loads each tile again): y bit for bit against the plain
    version and the banded mirror, the same bits on a second launch."""
    from distriflow_tpu_torch.ops import depthwise_gn as dg

    b, h, w, c, s = DWGN_F32_STREAMED
    assert dg.depthwise_gn_supported(h, w, c, s, itemsize=4)
    plan = dg.dwgn_plan(h, w, c, s, False, 4)
    assert plan.tiles_per_cta > 1, plan
    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    x, k, sc, bi = _dwgn_inputs(g, b, h, w, c, torch.float32)
    y = dg.depthwise_gn_forward(x, k, sc, bi, s)
    y_want = dg.depthwise3x3_groupnorm_reference(x, k, sc, bi, s)
    y_band = dg.banded_forward_reference(x, k, sc, bi, s)
    differ = {"y": float((y != y_want).float().mean()),
              "y_vs_banded": float((y != y_band).float().mean())}
    same_bits = bool(torch.equal(y, dg.depthwise_gn_forward(x, k, sc, bi, s)))
    assert not any(differ.values()) and same_bits, (differ, same_bits)
    return {"shape": list(DWGN_F32_STREAMED), "plan": _plan_of(plan, b), "differ_share": differ,
            "same_bits": same_bits}


def _dwgn_f32_build(backward):
    """The f32 depthwise backward's (``backward``) or forward's build:
    ptxas' registers and spills of its kernel (an instance a channel
    chunk), and the CTAs an SM holds under each of its 20 plans (the
    runtime's occupancy calculator)."""
    from distriflow_tpu_torch.ops import build
    from distriflow_tpu_torch.ops import depthwise_gn as dg

    lines, keep = [], False
    for line in build.ptxas_reports.get("depthwise_gn", "").splitlines():
        if "Compiling entry" in line:
            keep = ("f32bwd" if backward else "f32fwd") in line
        elif keep and ("registers" in line or "spill" in line):
            lines.append(line.strip())
    ctas = {}
    for px, size in ((96, MN), (224, MN224)):
        for h, w, c, s in _depthwise_shapes(size["image_size"], size["width"]):
            plan = dg.dwgn_plan(h, w, c, s, backward, 4)
            ctas[f"{px}px {h}x{w}x{c} s{s}"] = [dg.f32_ctas_per_sm(plan), plan.smem]
    return {"ptxas": lines, "ctas_per_sm_and_smem": ctas}


def _dwgn_f32_times():
    """``{"<px>px <h>x<w>x<c> s<s>": [forward ms, backward ms]}`` of the f32
    depthwise kernels of the ``distriflow_tpu_torch`` first on ``sys.path``
    at every shape of rows 11-12 in f32 (96 px at B ``MN_B``, 224 px at B
    ``MN224_B``), on the rows' inputs, timed as the rows time them."""
    from distriflow_tpu_torch.ops import depthwise_gn as dg

    flush, out = _flush_buffer(), {}
    timed_at = (DWGN_BIG, DWGN_SMALL, DWGN224_BIG, DWGN224_SMALL)
    for px, batch, size in ((96, MN_B, MN), (224, MN224_B, MN224)):
        shapes = _depthwise_shapes(size["image_size"], size["width"])
        for key, x, k, sc, bi, gout in _dwgn_cases(shapes, batch, torch.float32, SEED + 8):
            h, w, c, s = key
            iters = 20 if key in timed_at else 5
            out[f"{px}px {h}x{w}x{c} s{s}"] = [
                _timed(lambda: dg.depthwise_gn_forward(x, k, sc, bi, s), iters, flush),
                _timed(lambda: dg.depthwise_gn_backward(x, k, sc, bi, gout, s), iters, flush)]
            del x, k, gout
    return out


def _with_f32_dwgn_was(rows, was, now):
    """Rows 11-12 in f32 with ``was_ms`` (the :func:`_dwgn_f32_times` runs
    of an older checkout in ``was``) and ``now_ms`` (this checkout's run of
    the same function between them) beside each shape, and their sums over
    a step's blocks at 96 and 224 px (``step_was_ms_all_blocks``,
    ``step224_was_ms_all_blocks``, ``step_now_ms_all_blocks``, ...)."""
    for i, row in enumerate(rows):
        for tag, entry in row["by_shape"].items():
            entry["was_ms"] = [run[tag][i] for run in was] or "not measured"
            entry["now_ms"] = now[tag][i] if now else "not measured"
        for px, key in ((96, "step"), (224, "step224")):
            counts = {tag: e["blocks_per_step"] for tag, e in row["by_shape"].items()
                      if tag.startswith(f"{px}px ")}
            row[f"{key}_was_ms_all_blocks"] = [sum(n * run[tag][i] for tag, n in counts.items())
                                               for run in was] or "not measured"
            row[f"{key}_now_ms_all_blocks"] = (sum(n * now[tag][i] for tag, n in counts.items())
                                               if now else "not measured")
    return rows


def _markov_corpus(n_tokens: int, seed: int, vocab: int = CORPUS_VOCAB) -> np.ndarray:
    """The JAX repo's ``experiments/lm/data.py::generate_corpus`` recipe at
    order 1: a seeded table of ``CORPUS_BRANCHING`` successors for each of
    the ``vocab`` ids (the CLI's ``CORPUS_VOCAB`` by default), walked by
    seeded choices; ``[n_tokens]`` int32."""
    rng = np.random.RandomState(seed)
    table = rng.randint(0, vocab, size=(vocab, CORPUS_BRANCHING))
    rng = np.random.RandomState(seed + 1)
    out = np.empty(n_tokens, np.int32)
    ctx = rng.randint(0, vocab)
    choices = rng.randint(0, CORPUS_BRANCHING, size=n_tokens)
    for i in range(n_tokens):
        ctx = out[i] = table[ctx, choices[i]]
    return out


def _corpus_windows(corpus: np.ndarray, batch: int, seq: int, steps: int, seed: int):
    """``experiments/lm/data.py::batches``: ``steps`` random-offset ``(x,
    y)`` next-token windows ``[batch, seq]`` from the corpus's training
    head (the CLI holds out the last ``max(4 (seq + 1), n / 10)``
    tokens)."""
    split = max(len(corpus) - max(4 * (seq + 1), len(corpus) // 10), seq + 2)
    corpus = corpus[:split]
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        starts = rng.randint(0, len(corpus) - seq - 1, size=batch)
        w = np.stack([corpus[s:s + seq + 1] for s in starts])
        out.append((w[:, :-1], w[:, 1:]))
    return out


def _long_training(tree, counted, device="cuda", steps=LONG_TRAIN_STEPS, seq=LONG_TRAIN_S):
    """The flagship at max_seq ``seq`` with ``remat=True`` trained ``steps``
    steps on corpus windows in a launch window of its own. Returns
    ``(report, trainer, config, a spare batch, launch counts)``."""
    from distriflow_tpu_torch.models.zoo import flagship_lm_config
    from distriflow_tpu_torch.ops.flash_attention import bwd_layout

    cfg = dataclasses.replace(flagship_lm_config(max_seq=seq), remat=True)
    t0 = time.perf_counter()
    batches = _corpus_windows(_markov_corpus(CORPUS_TOKENS, SEED), LONG_TRAIN_B, seq, steps + 1,
                              SEED)
    data_s = time.perf_counter() - t0
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    (trainer, losses, ms), counts = counted(lambda: _train(cfg, tree, batches[:-1], device))
    memory = _peak_gauge() if device == "cuda" else None
    first, last = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
    p50 = float(np.median(ms))
    report = {
        "config": {"max_seq": seq, "remat": True, "batch": LONG_TRAIN_B, "seq": seq,
                   "optimizer": "adam", "lr": 1e-3, "loss": trainer.spec.loss,
                   "bwd_layout": bwd_layout(seq, cfg.head_dim, cfg.dtype),
                   "corpus": f"order-1 Markov, ids < {CORPUS_VOCAB}, {CORPUS_TOKENS} tokens"},
        "steps": steps, "data_s": data_s, "step_ms_p50": p50, "step_ms_max": max(ms),
        "step_ms_first": ms[0], "tokens_per_s": LONG_TRAIN_B * seq / (p50 / 1e3),
        "first3_mean": first, "last3_mean": last, "losses": losses,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9 if device == "cuda" else None,
        "memory_gauge": memory}
    assert all(math.isfinite(v) for v in losses), losses
    assert last < first, f"long-context loss did not fall: first 3 mean {first}, last 3 mean {last}"
    return report, trainer, cfg, batches[-1], counts


# The JAX LM CLI's own model: experiments/lm/train.py at its defaults
# (vocab 256 from experiments/lm/data.py, d_model 256 over 8 heads of 32, 4
# layers, d_ff 1024, seq 512, B 8, bf16, adam at 3e-3, --attention auto and
# the loss auto: the fused sparse CE on the accelerator), on windows of its
# order-1 Markov corpus, from a seeded flax-shaped tree. Four paths, each
# in launch windows of its own: (a) the defaults, LM_CLI_STEPS steps, then
# --generate 64 from a 32-token prompt of the held-out tail (slab decode)
# and --serve (LM_CLI_SERVE greedy requests through InferenceServer, paged
# decode); (b) --seq 16384 --remat at B 8, LM_CLI_LONG_STEPS steps (the
# two-kernel backward); (c) --dtype float32 at S 512, LM_CLI_STEPS steps
# (the f32 kernels), then --generate 64 and --serve in f32 (the f32 decode
# kernels; the served requests also a beam of LM_CLI_BEAM_TOKENS tokens and
# a score of a whole window); (d) --dtype float32 --seq 16384 --remat at B
# 8, LM_CLI_F32_LONG_STEPS steps (the f32 two-kernel backward; fewer steps
# than (b)'s, its f32 kernels run on the CUDA cores, but 3: from this init
# the loss of the second step's batch lies above the first's in both
# dtypes, 6.0587 -> 6.0620 -> 5.8834 in bf16, so 2 steps show no fall).
LM_CLI = dict(vocab_size=CORPUS_VOCAB, d_model=256, n_heads=8, n_layers=4, d_ff=1024,
              max_seq=512)
LM_CLI_B, LM_CLI_LR, LM_CLI_STEPS = 8, 3e-3, 20
LM_CLI_LONG_S, LM_CLI_LONG_STEPS, LM_CLI_F32_LONG_STEPS = 16384, 4, 3
LM_CLI_PROMPT, LM_CLI_SERVE, LM_CLI_BEAM_TOKENS = 32, 4, 16


def _lm_cli_config(**kw):
    from distriflow_tpu_torch.models.transformer import TransformerConfig

    return dataclasses.replace(TransformerConfig(**LM_CLI), **kw)


def _cli_train_report(cfg, trainer, losses, ms, seq):
    """A training leg's report; its losses must fall (the last below the
    first, and the mean of the second half below that of the first)."""
    half = len(losses) // 2
    first, last = float(np.mean(losses[:half])), float(np.mean(losses[-half:]))
    p50 = float(np.median(ms))
    report = {"config": {"dtype": str(cfg.dtype).replace("torch.", ""), "seq": seq,
                         "batch": LM_CLI_B, "remat": cfg.remat, "head_dim": cfg.head_dim,
                         "optimizer": "adam", "lr": LM_CLI_LR, "loss": trainer.spec.loss},
              "steps": len(losses), "step_ms_p50": p50, "step_ms_max": max(ms),
              "step_ms_first": ms[0], "tokens_per_s": LM_CLI_B * seq / (p50 / 1e3),
              "losses": losses, "first_half_mean": first, "last_half_mean": last}
    assert all(math.isfinite(v) for v in losses), losses
    assert losses[-1] < losses[0] and last < first, f"the CLI model's loss did not fall: {losses}"
    return report


def _exact(window, counts, want):
    """Every count of ``want`` exactly (the window's other kernels are
    held to 0 by main's ``ran`` table)."""
    got = {k: counts[k] for k in want}
    assert got == want, f"{window}: launched {got}, want {want}"


def _follow_share(corpus, toks, prompt):
    """The share of a generated stream's transitions that the corpus has."""
    seen = set(zip(corpus[:-1].tolist(), corpus[1:].tolist()))
    toks = toks.tolist()
    follows = [(a, b) in seen for a, b in zip(toks[prompt - 1:-1], toks[prompt:])]
    return sum(follows) / len(follows)


def _lm_cli_f32_decode(model, corpus, held, prompts, counted, device):
    """Path (c)'s decode legs on the trained f32 model: ``--generate 64``
    (slab), then ``--serve`` (the greedy requests, a beam and a score
    through the port's server at its default page size 128, one window),
    then pages of 16 refused by name. Returns ``(report, windows)``."""
    from distriflow_tpu_torch.models.generate import beam_search, generate, paged_cache
    from distriflow_tpu_torch.models.generate import sequence_logprob
    from distriflow_tpu_torch.models.transformer import TransformerLM

    cfg, n = model.config, model.config.n_layers
    f32 = ("", "_d32", "_f32")
    gen, w = counted(lambda: generate(model, prompts[0], N_TOKENS).cpu())
    windows = {"lm_cli_f32_generate": w}
    _exact("lm_cli_f32_generate", w, {**{f"flash_attention_fwd{t}": n for t in f32},
                                      **{f"flash_decode{t}": n * (N_TOKENS - 1) for t in f32}})
    report = {"generate": {"prompt": LM_CLI_PROMPT, "tokens": N_TOKENS,
                           "follow_corpus_share": _follow_share(corpus, gen[0], LM_CLI_PROMPT)}}
    reqs = [(f"cli{i}", p, {}) for i, p in enumerate(prompts)]
    solos = {"cli0": gen, **_solo(model, reqs[1:])}
    score_tokens = held[-cfg.max_seq:][None].astype(np.int32)
    direct = (("beam", lambda c: c.beam_search(prompts[1], LM_CLI_BEAM_TOKENS, beam_size=BEAM_SIZE)),
              ("score", lambda c: c.score(score_tokens, from_pos=LM_CLI_PROMPT)))
    outs, stats, w, done = _serve(model, reqs, counted, direct)
    (beam_got, beam_w), (served_score, score_w) = done["beam"], done["score"]
    w = {k: w[k] + beam_w[k] + score_w[k] for k in w}
    windows["lm_cli_f32_serve"] = w
    # one kernel 1 launch a layer a prefill (the engine's, the beam's, the
    # score's), one paged launch a layer a decode step, one slab launch a
    # layer a beam step after the first
    _exact("lm_cli_f32_serve", w, {
        **{f"flash_attention_fwd{t}": n * (stats["prefills"] + 2) for t in f32},
        **{f"flash_decode_paged{t}": n * stats["decode_steps"] for t in f32},
        **{f"flash_decode{t}": n * (LM_CLI_BEAM_TOKENS - 1) for t in f32}})
    # pages of 128 and slab tiles split alike: every served greedy stream is
    # solo generate()'s, bit for bit
    parity = {name: torch.equal(torch.as_tensor(outs[name]), solos[name]) for name, *_ in reqs}
    assert all(parity.values()), f"served f32 streams differ from solo generate(): {parity}"
    beam = _beam_verdict(model, torch.as_tensor(prompts[1], device=model.device),
                         (torch.as_tensor(np.asarray(beam_got[0]), dtype=torch.int32),
                          torch.as_tensor(np.asarray(beam_got[1]), dtype=torch.float32)),
                         beam_search(model, prompts[1], LM_CLI_BEAM_TOKENS, beam_size=BEAM_SIZE))
    assert beam["ok"], beam
    plain = TransformerLM(dataclasses.replace(cfg, use_flash_attention=False), device=device)
    plain.load_state_dict(model.state_dict())
    want = float(sequence_logprob(plain, score_tokens, LM_CLI_PROMPT)[0])
    del plain
    got = float(np.asarray(served_score)[0])
    rel = abs(got - want) / abs(want)
    assert math.isfinite(got) and rel <= SCORE_RTOL, (got, want, rel)
    report["serve"] = {
        **stats, "greedy_equal_to_solo": parity, "page_size": 128,
        "follow_corpus_share": {name: _follow_share(corpus, torch.as_tensor(outs[name])[0],
                                                    LM_CLI_PROMPT) for name, *_ in reqs},
        "beam": {"n_tokens": LM_CLI_BEAM_TOKENS, "beam_size": BEAM_SIZE, **beam},
        "score": {"len": cfg.max_seq, "from_pos": LM_CLI_PROMPT, "served": got,
                  "plain_attention": want, "rel_diff": rel, "limit": SCORE_RTOL}}
    # pages of 16: JAX decodes an f32 cache there through XLA in true f32,
    # which no kernel here computes, so the card refuses the cache by name
    # (the CPU runs the plain path)
    if device == "cuda":
        try:
            paged_cache(cfg, 8, 16, 16, device)
            raise AssertionError("an f32 paged cache at page_size 16 was not refused")
        except NotImplementedError as e:
            assert "paged decode at page_size 16" in str(e), e
            report["page16_refused"] = str(e)
    return report, windows


def _lm_cli_phase(counted, device="cuda"):
    """The four paths of the JAX LM CLI's model (see :data:`LM_CLI`),
    each through the port's entry points: ``transformer_lm`` ->
    ``SyncTrainer``, then ``generate`` and ``InferenceServer``. Returns
    ``(report, launch windows)``."""
    from distriflow_tpu_torch.models.generate import generate
    from distriflow_tpu_torch.models.transformer import TransformerLM
    from distriflow_tpu_torch.ops.flash_attention import bwd_layout

    cfg = _lm_cli_config()
    tree = _flagship_tree(cfg, np.random.default_rng(SEED + 40))
    corpus = _markov_corpus(CORPUS_TOKENS, SEED)
    split = max(len(corpus) - max(4 * (cfg.max_seq + 1), len(corpus) // 10), cfg.max_seq + 2)
    batches = _corpus_windows(corpus, LM_CLI_B, cfg.max_seq, LM_CLI_STEPS + 1, SEED)
    n, steps = cfg.n_layers, LM_CLI_STEPS
    report, windows = {}, {}

    # (a) the defaults: bf16, S 512, kernels 1 and 6 at D 32, 9 and 10 at V 256
    assert bwd_layout(cfg.max_seq, cfg.head_dim, cfg.dtype) == "fused"
    (trainer, losses, ms), w = counted(lambda: _train(cfg, tree, batches[:-1], device, LM_CLI_LR))
    windows["lm_cli_train"] = w
    _exact("lm_cli_train", w, {"flash_attention_fwd": n * steps, "flash_attention_fwd_d32": n * steps,
                               "flash_attention_bwd": n * steps, "flash_attention_bwd_d32": n * steps,
                               "fused_ce_fwd": steps, "fused_ce_bwd": steps})
    report["defaults"] = _cli_train_report(cfg, trainer, losses, ms, cfg.max_seq)
    report["defaults"]["step_vs_plain"] = _step_vs_plain(cfg, tree, *batches[-1], device)
    # --generate 64: the trained weights in a serving model, a prompt from
    # the held-out tail, slab decode
    model = TransformerLM(cfg, device=device)
    model.load_state_dict(trainer.get_params())
    del trainer
    held = corpus[split:]
    prompts = [held[i * 100:i * 100 + LM_CLI_PROMPT][None].astype(np.int32)
               for i in range(LM_CLI_SERVE)]
    gen, w = counted(lambda: generate(model, prompts[0], N_TOKENS).cpu())
    windows["lm_cli_generate"] = w
    _exact("lm_cli_generate", w, {"flash_attention_fwd": n, "flash_attention_fwd_d32": n,
                                  "flash_decode": n * (N_TOKENS - 1),
                                  "flash_decode_d32": n * (N_TOKENS - 1)})
    report["generate"] = {"prompt": LM_CLI_PROMPT, "tokens": N_TOKENS,
                          "follow_corpus_share": _follow_share(corpus, gen[0], LM_CLI_PROMPT)}
    # --serve: greedy requests through the port's server and client, held
    # against solo generate (the first is the --generate stream itself)
    reqs = [(f"cli{i}", p, {}) for i, p in enumerate(prompts)]
    solos = {"cli0": gen, **_solo(model, reqs[1:])}
    outs, stats, w, _ = _serve(model, reqs, counted)
    windows["lm_cli_serve"] = w
    _exact("lm_cli_serve", w, {"flash_attention_fwd": n * stats["prefills"],
                               "flash_attention_fwd_d32": n * stats["prefills"],
                               "flash_decode_paged": n * stats["decode_steps"],
                               "flash_decode_paged_d32": n * stats["decode_steps"]})
    report["serve"] = {**stats, "parity": _check_greedy(model, reqs, outs, solos, N_TOKENS)}
    del model

    # (b) --seq 16384 --remat at B 8: kernel 1 twice a layer a step, the
    # two-kernel backward (kernels 7 and 8) once
    long_cfg = _lm_cli_config(max_seq=LM_CLI_LONG_S, remat=True)
    assert bwd_layout(LM_CLI_LONG_S, long_cfg.head_dim, long_cfg.dtype) == "split"
    long_batches = _corpus_windows(corpus, LM_CLI_B, LM_CLI_LONG_S, LM_CLI_LONG_STEPS + 1, SEED)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    (trainer, losses, ms), w = counted(
        lambda: _train(long_cfg, tree, long_batches[:-1], device, LM_CLI_LR))
    windows["lm_cli_long"] = w
    ls = LM_CLI_LONG_STEPS
    _exact("lm_cli_long", w, {"flash_attention_fwd": 2 * n * ls, "flash_attention_fwd_d32": 2 * n * ls,
                              "flash_attention_dq": n * ls, "flash_attention_dq_d32": n * ls,
                              "flash_attention_dkv": n * ls, "flash_attention_dkv_d32": n * ls,
                              "flash_attention_bwd": 0, "fused_ce_fwd": ls, "fused_ce_bwd": ls})
    report["long"] = _cli_train_report(long_cfg, trainer, losses, ms, LM_CLI_LONG_S)
    if device == "cuda":
        report["long"]["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        # one more step under the profiler, outside the window: device time
        # by kernel and the idle share
        report["long"]["step_profile"] = _profiled(
            lambda: trainer.step(long_batches[LM_CLI_LONG_STEPS]))
    del trainer
    # the plain step's [S, S] f32 scores take B 1: the batch's first row
    x, y = long_batches[-1]
    report["long"]["step_vs_plain"] = _step_vs_plain(long_cfg, tree, x[:1], y[:1], device)

    # (c) --dtype float32: kernels 1, 6, 9 and 10 on f32, at D 32, then its
    # --generate and --serve: kernels 3 and 2 on f32 caches
    f32_cfg = _lm_cli_config(dtype=torch.float32)
    assert bwd_layout(f32_cfg.max_seq, f32_cfg.head_dim, f32_cfg.dtype) == "fused"
    (trainer, losses, ms), w = counted(
        lambda: _train(f32_cfg, tree, batches[:-1], device, LM_CLI_LR))
    windows["lm_cli_f32"] = w
    _exact("lm_cli_f32", w, {**{f"flash_attention_{k}{t}": n * steps
                                for k in ("fwd", "bwd") for t in ("", "_d32", "_f32")},
                             **{f"fused_ce_{k}{t}": steps for k in ("fwd", "bwd") for t in ("", "_f32")}})
    report["float32"] = _cli_train_report(f32_cfg, trainer, losses, ms, f32_cfg.max_seq)
    report["float32"]["step_vs_plain"] = _step_vs_plain(f32_cfg, tree, *batches[-1], device)
    f32_model = TransformerLM(f32_cfg, device=device)
    f32_model.load_state_dict(trainer.get_params())
    del trainer
    decode_report, decode_windows = _lm_cli_f32_decode(f32_model, corpus, held, prompts, counted,
                                                       device)
    report["float32"].update(decode_report)
    windows.update(decode_windows)
    del f32_model

    # (d) --dtype float32 --seq 16384 --remat at B 8: kernel 1 in f32 twice
    # a layer a step, the f32 two-kernel backward (kernels 7 and 8) once
    f32_long = _lm_cli_config(dtype=torch.float32, max_seq=LM_CLI_LONG_S, remat=True)
    assert bwd_layout(LM_CLI_LONG_S, f32_long.head_dim, f32_long.dtype) == "split"
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ls = LM_CLI_F32_LONG_STEPS
    (trainer, losses, ms), w = counted(
        lambda: _train(f32_long, tree, long_batches[:ls], device, LM_CLI_LR))
    windows["lm_cli_f32_long"] = w
    _exact("lm_cli_f32_long", w, {
        **{f"flash_attention_fwd{t}": 2 * n * ls for t in ("", "_d32", "_f32")},
        **{f"flash_attention_{k}{t}": n * ls for k in ("dq", "dkv") for t in ("", "_d32", "_f32")},
        "flash_attention_bwd": 0, **{f"fused_ce_{k}{t}": ls for k in ("fwd", "bwd") for t in ("", "_f32")}})
    report["float32_long"] = _cli_train_report(f32_long, trainer, losses, ms, LM_CLI_LONG_S)
    # (b)'s bf16 steps on the same batches from the same init, beside it
    report["float32_long"]["loss_vs_bf16_long"] = max(
        abs(a - b) for a, b in zip(losses, report["long"]["losses"]))
    if device == "cuda":
        report["float32_long"]["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        # one more step under the profiler, outside the window: device time
        # by kernel and the idle share
        report["float32_long"]["step_profile"] = _profiled(
            lambda: trainer.step(long_batches[ls]))
    del trainer
    report["float32_long"]["step_vs_plain"] = _step_vs_plain(f32_long, tree, x[:1], y[:1], device)
    return report, windows


def _row(name, source, replaces, launches, err, shape, tol_of=None, **rest):
    """A kernel-table row; its limit is ``TOL[tol_of or name]``."""
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err, "tol": _tol(tol_of or name),
            "shape": shape, **rest}


def _tf32_run(plain):
    """``plain()`` with TF32 products (one TF32 pass each)."""
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return plain()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def _tf32_share(name, plain, want):
    """The share of elements of ``plain()`` run with TF32 products outside
    ``name``'s limit around the true-f32 ``want`` (reported: the f32 rows'
    yardstick must run with TF32 off)."""
    got = _tf32_run(plain)
    got = got if isinstance(got, torch.Tensor) else got[0]
    return _rejected(name, got, want)


def _beside_tf32(name, got, want, tf32):
    """A kernel's error beside one TF32 pass's on the same plain recipe:
    each one's largest error and share of elements outside ``name``'s
    limit around ``want``."""
    err = lambda x: float((x.float() - want.float()).abs().max())  # noqa: E731
    return {"kernel_max_abs_err": err(got), "kernel_outside_share": _rejected(name, got, want),
            "tf32_plain_max_abs_err": err(tf32),
            "tf32_plain_outside_share": _rejected(name, tf32, want)}


def _sdpa_math(q, k, v):
    """``F.scaled_dot_product_attention`` on its math backend (the f32
    library yardstick, with TF32 off)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel(SDPBackend.MATH):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)


def _lm_cli_attention_rows(launches):
    """The attention rows the CLI's paths add: kernel 6 at D 32 (B8 H8 S512,
    path (a)), kernels 7 and 8 at D 32 (B8 H8 S16384, path (b)), kernels 1
    and 6 in f32 (B8 H8 S512 D32, path (c), and D 64 beside it). Each: the
    limit, the same bits on a second launch, planted faults rejected,
    ragged lengths, its time beside the bound, the plain version and a
    library call (kernel 6 in f32: SDPA's f32 backward on its math and
    memory-efficient backends, the faster as ``library_ms``)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from distriflow_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 41)
    flush = _flush_buffer()
    b, h, d = LM_CLI_B, LM_CLI["n_heads"], LM_CLI["d_model"] // LM_CLI["n_heads"]
    src_bwd = "distriflow_tpu_torch/csrc/flash_attention_bwd.cu"
    src_f32 = "distriflow_tpu_torch/csrc/flash_attention_f32.cu"
    rows = []

    def sdpa_bwd(q, k, v, do, math_backend=False):
        qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
        out = (_sdpa_math(qs, ks, vs) if math_backend
               else F.scaled_dot_product_attention(qs, ks, vs, is_causal=True))
        return lambda: torch.autograd.grad(out, (qs, ks, vs), do, retain_graph=True)

    # kernel 6 at D 32, bf16: the CLI's defaults
    name, s = "flash_attention_bwd_d32", LM_CLI["max_seq"]
    args = _bwd_inputs(g, b, h, s, True, d)
    q, k, v, do, lse, delta, _ = args
    got, want = fa.flash_attention_backward(*args), fa.flash_attention_backward_reference(*args)
    err = max(_over(f"{name} d{x}", a, r, *TOL[name]) for x, a, r in zip("qkv", got, want))
    assert all(torch.equal(a, r) for a, r in zip(fa.flash_attention_backward(*args), got)), \
        f"{name}: a second launch gave other bits"
    no_delta = fa.flash_attention_backward_reference(q, k, v, do, lse, torch.zeros_like(delta), True)
    controls = {"no_delta": _rejected(name, no_delta[0], want[0]),
                "dk_unscaled": _rejected(name, want[1].float() * math.sqrt(d), want[1])}
    assert all(c > 0.5 for c in controls.values()), f"{name}: the limit passes a wrong gradient: {controls}"
    needed = _atol_needed(name, list(zip(got, want)))
    del got, want, no_delta
    ragged = _ragged_bwd(name, fa.flash_attention_backward, fa.flash_attention_backward_reference,
                         g, 1, h, d)
    pairs = s * (s + 1) // 2
    tb, by = _bound(7 * b * h * s * d * 2 + 2 * b * h * s * 4, 5 * 2 * b * h * pairs * d,
                    exps=b * h * pairs)
    rows.append(_row(name, src_bwd, "distriflow_tpu/ops/flash_attention.py:272", launches, err,
                     f"B={b} H={h} S={s} D={d} causal bf16",
                     ms=_timed(lambda: fa.flash_attention_backward(*args), 20, flush),
                     plain_ms=_timed(lambda: fa.flash_attention_backward_reference(*args), 3, flush),
                     bound_ms=tb, bound_by=by, library_ms=_timed(sdpa_bwd(q, k, v, do), 20, flush),
                     library_note="F.scaled_dot_product_attention backward at D 32",
                     rejected_share=controls, deterministic=True, atol_needed=needed,
                     ragged_max_abs_err=ragged))
    del args, q, k, v, do, lse, delta

    # kernels 7 and 8 at D 32, bf16: --seq 16384 --remat at B 8
    s = LM_CLI_LONG_S
    args = _bwd_inputs(g, b, h, s, True, d)
    q, k, v, do, lse, delta, _ = args
    nq, nkv = "flash_attention_dq_d32", "flash_attention_dkv_d32"
    dq, want_q = fa.flash_attention_dq(*args), fa.flash_attention_dq_reference(*args)
    (dk, dv), (want_k, want_v) = fa.flash_attention_dkv(*args), fa.flash_attention_dkv_reference(*args)
    # each gradient's limit adds BWD_FLIPS flips of a bf16 term by element (C16; the note above TOL)
    (atol_q,) = _flip_atols(nq, ("dq",), *args)
    atol_k, atol_v = _flip_atols(nkv, ("dk", "dv"), *args)
    errs = {nq: _over(nq, dq, want_q, atol_q, TOL[nq][1]),
            nkv: max(_over(f"{nkv} dk", dk, want_k, atol_k, TOL[nkv][1]),
                     _over(f"{nkv} dv", dv, want_v, atol_v, TOL[nkv][1]))}
    needed = {nq: _atol_needed(nq, [(dq, want_q)]),
              nkv: _atol_needed(nkv, [(dk, want_k), (dv, want_v)])}
    flip_limit = {nq: _flip_report(nq, [(dq, want_q, atol_q)]),
                  nkv: _flip_report(nkv, [(dk, want_k, atol_k), (dv, want_v, atol_v)])}
    again_k, again_v = fa.flash_attention_dkv(*args)
    assert torch.equal(fa.flash_attention_dq(*args), dq), "flash_attention_dq_d32 is not deterministic"
    assert torch.equal(again_k, dk) and torch.equal(again_v, dv), \
        "flash_attention_dkv_d32 is not deterministic"
    no_delta = fa.flash_attention_dq_reference(q, k, v, do, lse, torch.zeros_like(delta), True)
    unscaled = want_k.float() * math.sqrt(d)
    controls = {nq: {"no_delta": _rejected(nq, no_delta, want_q, atol=atol_q)},
                nkv: {"dk_unscaled": _rejected(nkv, unscaled, want_k, atol=atol_k)}}
    flip_limit[nq]["no_delta_under_scalar_atol"] = _rejected(nq, no_delta, want_q)
    flip_limit[nkv]["dk_unscaled_under_scalar_atol"] = _rejected(nkv, unscaled, want_k)
    for c in controls.values():
        assert all(x > 0.5 for x in c.values()), f"a D 32 two-kernel limit passes a wrong gradient: {c}"
    del dq, want_q, dk, dv, want_k, want_v, again_k, again_v, no_delta, unscaled, atol_q, atol_k, atol_v
    # the short lengths at the fused row's limit: there one rounding flip
    # of a large dS moves an element by up to 2.0e-3 (see RAGGED_TOL)
    ragged = {"flash_attention_dq_d32": _ragged_bwd(
                  "flash_attention_dq_d32", lambda *a: (fa.flash_attention_dq(*a),),
                  lambda *a: (fa.flash_attention_dq_reference(*a),), g, 1, h, d, limit=RAGGED_TOL),
              "flash_attention_dkv_d32": _ragged_bwd(
                  "flash_attention_dkv_d32", fa.flash_attention_dkv, fa.flash_attention_dkv_reference,
                  g, 1, h, d, limit=RAGGED_TOL)}
    pairs = s * (s + 1) // 2
    io = 4 * b * h * s * d * 2 + 2 * b * h * s * 4
    library = _timed(sdpa_bwd(q, k, v, do), 5, flush)
    for name, line, products, outs, fn, plain in (
            ("flash_attention_dq_d32", "distriflow_tpu/ops/flash_attention.py:162", 3, 1,
             fa.flash_attention_dq, fa.flash_attention_dq_reference),
            ("flash_attention_dkv_d32", "distriflow_tpu/ops/flash_attention.py:212", 4, 2,
             fa.flash_attention_dkv, fa.flash_attention_dkv_reference)):
        tb, by = _bound(io + outs * b * h * s * d * 2, products * 2 * b * h * pairs * d,
                        exps=b * h * pairs)
        rows.append(_row(name, src_bwd, line, launches, errs[name], f"B={b} H={h} S={s} D={d} causal bf16",
                         ms=_timed(lambda fn=fn: fn(*args), 10, flush),
                         plain_ms=_timed(lambda plain=plain: plain(*args), 1, flush),
                         bound_ms=tb, bound_by=by, library_ms=library,
                         library_note="F.scaled_dot_product_attention backward at D 32: dQ, dK "
                                      "and dV together",
                         rejected_share=controls[name], deterministic=True,
                         atol_needed=needed[name], ragged_max_abs_err=ragged[name],
                         flip_limit=flip_limit[name]))
    del args, q, k, v, do, lse, delta

    # kernel 1 in f32: --dtype float32, and D 64 beside it
    s = LM_CLI["max_seq"]
    name = "flash_attention_fwd_f32"
    by_d, controls = {}, {}
    for dd in (d, 64):
        q, k, v = (torch.randn(b, h, s, dd, generator=g, device=dev) for _ in range(3))
        o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
        again = fa.flash_attention(q, k, v, causal=True, return_lse=True)
        assert torch.equal(again[0], o) and torch.equal(again[1], lse), \
            f"{name} D{dd}: a second launch gave other bits"
        ro, rl = fa.flash_attention_reference(q, k, v, True)
        err = max(_over(f"{name} D{dd} O", o, ro, *TOL[name]),
                  _over(f"{name} D{dd} lse", lse, rl, *TOL[name]))
        # planted: P and V through bf16 (the bf16 kernel's contract) must
        # fail the f32 limit; a TF32 yardstick is reported
        bf16_o = fa.flash_attention_reference(q.bfloat16(), k.bfloat16(), v.bfloat16(), True)[0]
        c = {"bf16_operands": _rejected(name, bf16_o, ro),
             "tf32_plain": _tf32_share(name, lambda: fa.flash_attention_reference(q, k, v, True), ro)}
        assert c["bf16_operands"] > 0.5, f"{name}: the limit passes a bf16 forward: {c}"
        controls[f"D={dd}"] = c
        pairs = s * (s + 1) // 2
        # both products in split-precision TF32: 3 TF32 products each
        nbytes, flops = 4 * b * h * s * dd * 4 + b * h * s * 4, 4 * b * h * pairs * dd
        tb, by = _bound(nbytes, 3 * flops, TF32_FLOPS, exps=b * h * pairs)
        by_d[dd] = {"shape": f"B={b} H={h} S={s} D={dd} causal f32", "max_abs_err": err,
                    "bound_ffma_ms": _bound(nbytes, flops, F32_FLOPS, exps=b * h * pairs)[0],
                    "ms": _timed(lambda: fa.flash_attention(q, k, v, causal=True, return_lse=True),
                                 20, flush),
                    "plain_ms": _timed(lambda: fa.flash_attention_reference(q, k, v, True), 3, flush),
                    "bound_ms": tb, "bound_by": by,
                    "library_ms": _timed(lambda: _sdpa_math(q, k, v), 20, flush)}
    # ragged lengths: D 32 on RAGGED_BWD, D 64 (its own build) on
    # RAGGED_F32_D64 from a generator of its own, so no earlier draw moved
    ragged = {}
    g64 = torch.Generator(device=dev).manual_seed(SEED + 50)
    for dd, gg, lengths in ((d, g, RAGGED_BWD), (64, g64, RAGGED_F32_D64)):
        by_len = ragged[dd] = {}
        for ss, causal in lengths:
            q, k, v = (torch.randn(1, h, ss, dd, generator=gg, device=dev) for _ in range(3))
            o, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
            ro, rl = fa.flash_attention_reference(q, k, v, causal)
            by_len[f"S={ss} {'causal' if causal else 'non-causal'}"] = max(
                _over(f"{name} D{dd} S={ss}", o, ro, *TOL[name]),
                _over(f"{name} D{dd} lse S={ss}", lse, rl, *TOL[name]))
    # views that start 4 bytes past a 16-byte boundary: the wrapper copies them
    gu = torch.Generator(device=dev).manual_seed(SEED + 48)
    for dd in (d, 64):
        n = h * 300 * dd
        buf = torch.randn(3 * n + 1, generator=gu, device=dev)
        q, k, v = (buf[1 + i * n:1 + (i + 1) * n].view(1, h, 300, dd) for i in range(3))
        o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
        ro, rl = fa.flash_attention_reference(q, k, v, True)
        ragged[dd]["S=300 causal, unaligned"] = max(
            _over(f"{name} D{dd} unaligned", o, ro, *TOL[name]),
            _over(f"{name} D{dd} lse unaligned", lse, rl, *TOL[name]))
    by_d[64]["ragged"] = ragged[64]
    main = by_d[d]
    rows.append(_row(name, src_f32, "distriflow_tpu/ops/flash_attention.py:92", launches,
                     main["max_abs_err"], main["shape"], ms=main["ms"], plain_ms=main["plain_ms"],
                     bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                     bound_ffma_ms=main["bound_ffma_ms"], library_ms=main["library_ms"],
                     library_note="F.scaled_dot_product_attention, math backend, f32 (TF32 off)",
                     d64=by_d[64], rejected_share=controls, deterministic=True,
                     ragged_max_abs_err=ragged[d]))

    # kernel 6 in f32: the fused backward, D 32 and D 64 beside it. dK and
    # dV are held against the plain version, dQ against its recipe in f64
    # (TOL["flash_attention_dq_f32_exact"], as row 7 in f32) and reported
    # against the plain version (see the note above TOL)
    name = "flash_attention_bwd_f32"
    by_d, controls, needed, ragged = {}, {}, {}, {}
    for dd in (d, 64):
        args = _bwd_inputs(g, b, h, s, True, dd, torch.float32)
        q, k, v, do, lse, delta, _ = args
        got, want = fa.flash_attention_backward(*args), fa.flash_attention_backward_reference(*args)
        err = max(_over(f"{name} D{dd} d{x}", a, r, *TOL[name])
                  for x, a, r in zip("kv", got[1:], want[1:]))
        assert all(torch.equal(a, r) for a, r in zip(fa.flash_attention_backward(*args), got)), \
            f"{name} D{dd}: a second launch gave other bits"
        no_delta = fa.flash_attention_backward_reference(q, k, v, do, lse, torch.zeros_like(delta), True)
        tf32 = _tf32_run(lambda: fa.flash_attention_backward_reference(*args))
        exact = _dq_exact_check(f"D={dd}", got[0], want[0], args,
                                {"no_delta": no_delta[0], "tf32_plain_dq": tf32[0]})
        c = {"dk_unscaled": _rejected(name, want[1] * math.sqrt(dd), want[1]),
             "tf32_plain_dk": _rejected(name, tf32[1], want[1]),
             "tf32_plain_dv": _rejected(name, tf32[2], want[2])}
        assert all(x > 0.5 for x in c.values()), f"{name}: the limit passes a wrong gradient: {c}"
        controls[f"D={dd}"] = {**exact.pop("rejected_share"), **c}
        needed[f"D={dd}"] = {"dk_dv": _atol_needed(name, list(zip(got[1:], want[1:]))),
                             "dq_vs_plain": _atol_needed(name, [(got[0], want[0])]),
                             "dq_vs_f64": exact["kernel_atol_needed"],
                             "plain_dq_vs_f64": exact["plain_atol_needed"]}
        err = max(err, float((got[0] - want[0]).abs().max()))
        del got, want, no_delta, tf32
        pairs = s * (s + 1) // 2
        # the five f32 products in split-precision TF32 (3 TF32 products
        # each), with the FFMA peak's bound beside
        nbytes, flops = 7 * b * h * s * dd * 4 + 2 * b * h * s * 4, 5 * 2 * b * h * pairs * dd
        tb, by = _bound(nbytes, 3 * flops, TF32_FLOPS, exps=b * h * pairs)
        library = {"math": _timed(sdpa_bwd(q, k, v, do, math_backend=True), 20, flush)}
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            library["efficient"] = _timed(sdpa_bwd(q, k, v, do), 20, flush)
        best = min(library, key=library.get)
        by_d[dd] = {"shape": f"B={b} H={h} S={s} D={dd} causal f32", "max_abs_err": err,
                    "ms": _timed(lambda: fa.flash_attention_backward(*args), 20, flush),
                    "plain_ms": _timed(lambda: fa.flash_attention_backward_reference(*args), 3,
                                       flush),
                    "bound_ms": tb, "bound_by": by,
                    "bound_ffma_ms": _bound(nbytes, flops, F32_FLOPS, exps=b * h * pairs)[0],
                    "library_ms": library[best], "library_by_backend": library,
                    "library_note": f"F.scaled_dot_product_attention backward, f32 (TF32 off), "
                                    f"the faster backend: {best}",
                    "exact": exact}
        ragged[dd] = _ragged_fused_f32(g, h, dd)
    by_d[64]["ragged"] = ragged[64]
    main = by_d[d]
    row = _row(name, src_f32, "distriflow_tpu/ops/flash_attention.py:272", launches,
               main["max_abs_err"], main["shape"],
               **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "bound_ffma_ms",
                                       "library_ms", "library_by_backend", "library_note", "exact")},
               d64=by_d[64], rejected_share=controls, deterministic=True, atol_needed=needed,
               ragged_max_abs_err=ragged[d])
    row["tol"] = (f"dK, dV: {row['tol']}; dQ: "
                  + _tol("flash_attention_dq_f32_exact").replace("|plain|", "|f64 recipe|"))
    rows.append(row)
    return rows


def _ragged_fused_f32(g, h, d):
    """Kernel 6 in f32 (B1, ``h`` heads, head dim ``d``) on
    :data:`RAGGED_F32_D64`'s lengths, inputs from ``g``: dK and dV held
    against the plain version, dQ against its recipe in f64
    (:func:`_dq_exact_check`); by length, the max abs error of each
    gradient against the plain version and dQ's atol needed against the
    f64 recipe."""
    from distriflow_tpu_torch.ops import flash_attention as fa

    name = "flash_attention_bwd_f32"
    out = {}
    for s, causal in RAGGED_F32_D64:
        args = _bwd_inputs(g, 1, h, s, causal, d, torch.float32)
        tag = f"S={s} {'causal' if causal else 'non-causal'}"
        got, want = fa.flash_attention_backward(*args), fa.flash_attention_backward_reference(*args)
        out[tag] = {"dk_dv": max(_over(f"{name} D{d} {tag} d{x}", a, w, *TOL[name])
                                 for x, a, w in zip("kv", got[1:], want[1:])),
                    "dq": float((got[0] - want[0]).abs().max()),
                    "dq_vs_f64": _dq_exact_check(f"D={d} {tag}", got[0], want[0], args,
                                                 {})["kernel_atol_needed"]}
    return out


def _lm_cli_ce_rows(launches):
    """Kernels 9 and 10 on f32 logits at path (c)'s shape, N 4096 (B 8 x S
    512) x V 256 (the narrow layout), with the block-a-row layout at N 1024
    x V 32000 beside it; kernels 9d and 10d on f32 logits (no path of the
    port runs them) at the same shapes with soft targets. Each: the limit,
    the same bits twice, planted faults rejected, times beside the bound,
    the plain version and ``F.cross_entropy``."""
    import torch.nn.functional as F

    from distriflow_tpu_torch.ops import fused_ce as ce

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 42)
    flush = _flush_buffer()
    src = "distriflow_tpu_torch/csrc/fused_ce.cu"
    shapes = {"path": (LM_CLI_B * LM_CLI["max_seq"], LM_CLI["vocab_size"]), "wide": (1024, 32000)}
    rows = []
    for dense in (False, True):
        tag = "fused_ce_dense" if dense else "fused_ce"
        fwd_name, bwd_name = f"{tag}_fwd_f32", f"{tag}_bwd_f32"
        fwd_fn = ce.fused_ce_dense_forward if dense else ce.fused_ce_forward
        bwd_fn = ce.fused_ce_dense_backward if dense else ce.fused_ce_backward
        fwd_ref = ce.fused_ce_dense_forward_reference if dense else ce.fused_ce_forward_reference
        bwd_ref = ce.fused_ce_dense_backward_reference if dense else ce.fused_ce_backward_reference
        fwd_at, bwd_at = {}, {}
        for key, (n, vocab) in shapes.items():
            # logits of scale 1, as row 9's: every column's softmax term
            # p * g lies far above the gradient limit's atol
            logits = torch.randn(n, vocab, generator=g, device=dev)
            if dense:
                t = torch.softmax(torch.randn(n, vocab, generator=g, device=dev), -1)
                lib_t = t
            else:
                t = torch.randint(0, vocab, (n,), generator=g, device=dev, dtype=torch.int32)
                lib_t = t.long()
            loss, lse = fwd_fn(logits, t)
            again = fwd_fn(logits, t)
            assert torch.equal(again[0], loss) and torch.equal(again[1], lse), \
                f"{fwd_name} {key}: a second launch gave other bits"
            rl, rs = fwd_ref(logits, t)
            ferr = max(_over(f"{fwd_name} {key} loss", loss, rl, *TOL[fwd_name]),
                       _over(f"{fwd_name} {key} lse", lse, rs, *TOL[fwd_name]))
            # planted: the label hit from the next column (a target shifted
            # by one) must fail the loss limit
            wrong_t = torch.roll(t, 1, dims=-1) if dense else (t + 1) % vocab
            fctl = {"shifted_target": _rejected(fwd_name, fwd_ref(logits, wrong_t)[0], rl)}
            assert fctl["shifted_target"] > 0.5, f"{fwd_name}: the limit passes a wrong loss: {fctl}"
            gr = torch.rand(n, generator=g, device=dev)
            grad = bwd_fn(logits, t, lse, gr)
            assert grad.dtype == torch.float32
            assert torch.equal(bwd_fn(logits, t, lse, gr), grad), \
                f"{bwd_name} {key}: a second launch gave other bits"
            want = bwd_ref(logits, t, lse, gr)
            berr = _over(f"{bwd_name} {key}", grad, want, *TOL[bwd_name])
            bctl = {}
            for cname, shift in (("no_softmax", math.inf), ("twice_softmax", -math.log(2)),
                                 ("lse_plus_0.05", 0.05)):
                bctl[cname] = _rejected(bwd_name, bwd_ref(logits, t, lse + shift, gr), want)
            assert all(x > 0.5 for x in bctl.values()), \
                f"{bwd_name}: the limit passes a wrong gradient: {bctl}"
            lanes, rows_a_block = ce._row_tile(vocab) or (0, 0)
            common = {"shape": f"N={n} V={vocab} f32 " + ("soft targets" if dense else "sparse labels"),
                      "lanes": lanes, "rows_a_block": rows_a_block}
            tbytes = n * vocab * 4 if dense else n * 4
            tb, by = _bound(n * vocab * 4 + tbytes + 2 * n * 4, 4 * n * vocab, F32_FLOPS)
            fwd_at[key] = {**common, "max_abs_err": ferr, "rejected_share": fctl,
                           "ms": _timed(lambda: fwd_fn(logits, t), 20, flush),
                           "plain_ms": _timed(lambda: fwd_ref(logits, t), 3, flush),
                           "bound_ms": tb, "bound_by": by,
                           "library_ms": _timed(lambda: F.cross_entropy(logits, lib_t, reduction="none"),
                                                20, flush)}
            lg = logits.detach().clone().requires_grad_()
            lib_loss = F.cross_entropy(lg, lib_t, reduction="none")
            tb, by = _bound(2 * n * vocab * 4 + tbytes + 2 * n * 4, 4 * n * vocab, F32_FLOPS)
            bwd_at[key] = {**common, "max_abs_err": berr, "rejected_share": bctl,
                           "ms": _timed(lambda: bwd_fn(logits, t, lse, gr), 20, flush),
                           "plain_ms": _timed(lambda: bwd_ref(logits, t, lse, gr), 3, flush),
                           "bound_ms": tb, "bound_by": by,
                           "library_ms": _timed(lambda: torch.autograd.grad(
                               lib_loss, lg, gr, retain_graph=True), 20, flush)}
            del logits, t, lib_t, lg, lib_loss, grad, want
        for name, at, line in ((fwd_name, fwd_at, "distriflow_tpu/ops/fused_ce.py:77"),
                               (bwd_name, bwd_at, "distriflow_tpu/ops/fused_ce.py:107")):
            main = at["path"]
            rows.append(_row(name, src, line, launches, max(a["max_abs_err"] for a in at.values()),
                             main["shape"], ms=main["ms"], plain_ms=main["plain_ms"],
                             bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                             library_ms=main["library_ms"],
                             library_note="F.cross_entropy (reduction none) on f32 logits",
                             rejected_share=main["rejected_share"], deterministic=True,
                             wide=at["wide"], lanes=main["lanes"], rows_a_block=main["rows_a_block"]))
    return rows


def _f32_decode_case(g, b, h, d, lens_l, ps=None, s_max=None):
    """f32 decode inputs at ``b`` rows of ``h`` heads of ``d``: a slab
    ``[b, s_max, H*D]`` (``ps`` None) or a pool of pages of ``ps`` behind a
    scattered table, rows of ``lens_l`` valid positions. Returns ``(run,
    plain, parts, (q, k, v), live positions, table entries, rows)``, rows
    from :func:`_f32_decode_rows`."""
    from distriflow_tpu_torch.ops import flash_decode as fd

    dev = torch.device("cuda")
    q = torch.randn(b, h, d, generator=g, device=dev)
    lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
    if ps is None:
        k, v = (torch.randn(b, s_max, h * d, generator=g, device=dev) for _ in range(2))
        args, entries, table = (q, k, v, lens), 0, None
        run, plain = fd.flash_decode, fd.flash_decode_reference
        parts = lambda: fd.split_partials(q, k, v, lens)  # noqa: E731
    else:
        pp = -(-max(lens_l) // ps)
        n_pages = sum(-(-n // ps) for n in lens_l) + 2
        table, lens = _paged_rows(g, lens_l, ps, n_pages, pp)
        k, v = (torch.randn(n_pages, ps, h * d, generator=g, device=dev) for _ in range(2))
        args, entries = (q, k, v, table, lens), table.numel()
        run, plain = fd.flash_decode_paged, fd.flash_decode_paged_reference
        parts = lambda: fd.split_partials(q, k, v, lens, table)  # noqa: E731
    return ((lambda: run(*args)), (lambda: plain(*args)), parts, (q, k, v), sum(lens_l), entries,
            _f32_decode_rows(q, k, v, lens, table))


def _f32_decode_row(name, launches, line, cases, flush, library):
    """One f32 decode row from ``cases`` (label -> :func:`_f32_decode_case`
    arguments; the first is the path's shape, ``"d64"`` the D 64 one
    beside it): at each, the error within the f32 decode limit, the
    unrounded decode outside it (for some element at each case, and for at
    least :data:`TRUE_F32_MIN_SHARE` of all the cases' elements), the same
    bits on a second launch, the wrong combines rejected, the times of
    kernel and plain version beside the bytes bound, and ``library(case)``
    where it gives one."""
    from distriflow_tpu_torch.ops import flash_decode as fd

    g = torch.Generator(device="cuda").manual_seed(SEED + 43)
    at, outside, elements = {}, 0.0, 0
    for label, (b, h, d, lens_l, ps, s_max) in cases.items():
        run, plain, parts, qkv, live, entries, rows = _f32_decode_case(g, b, h, d, lens_l, ps,
                                                                       s_max)
        out, want = run(), plain()
        assert out.dtype == torch.float32 and torch.equal(run(), out), \
            f"{name} {label}: a second launch gave other bits"
        atol = _f32_decode_atol(name, qkv[0], *rows)
        err = _over(f"{name} {label}", out, want, atol, TOL[name][1])
        unrounded = _unrounded_decode(qkv[0], *rows)
        true_f32_share = _rejected(name, unrounded, want, atol)
        assert true_f32_share > 0, f"{name} {label}: the limit passes true f32"
        outside += true_f32_share * want.numel()
        elements += want.numel()
        rejected = None  # a case whose rows hold one split each has no combine to get wrong
        if max(lens_l) > fd.split_tiles(ps or fd.SLAB_TILE) * (ps or fd.SLAB_TILE):
            rejected = _wrong_combines(name, parts(), want, atol)
            assert rejected["no_rescale"] > 0.5 and rejected["drop_max_split"] > 0.5, \
                f"{name} {label}: the limit passes a wrong combine: {rejected}"
        tb, by = _bound(2 * live * h * d * 4 + 2 * b * h * d * 4 + entries * 4 + b * 4,
                        4 * live * h * d, F32_FLOPS, exps=live * h)
        shape = (f"B={b} H={h} D={d} f32 " + (f"S={s_max} valid={lens_l}" if ps is None
                                              else f"page={ps} contexts={lens_l}"))
        lib = library(lens_l[0], s_max, *qkv) if ps is None else None
        at[label] = {"shape": shape, "max_abs_err": err,
                     "atol_max": float(atol.max()), "atol_median": float(atol.median()),
                     "true_f32_share": true_f32_share,
                     "true_f32_max_err": float((unrounded - want).abs().max()),
                     "rejected_share": rejected,
                     "ms": _timed(run, 200, flush), "plain_ms": _timed(plain, 5, flush),
                     "bound_ms": tb, "bound_by": by,
                     "library_ms": None if lib is None else _timed(lib, 200, flush)}
    assert outside >= TRUE_F32_MIN_SHARE * elements, \
        f"{name}: the limit passes true f32 ({outside} of {elements} elements outside)"
    main, rest = next(iter(at.values())), dict(list(at.items())[1:])
    return _row(name, "distriflow_tpu_torch/csrc/flash_decode.cu", line, launches,
                max(a["max_abs_err"] for a in at.values()), main["shape"],
                **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                        "rejected_share", "atol_max", "atol_median",
                                        "true_f32_share", "true_f32_max_err")},
                deterministic=True, **rest)


def _f32_attention_times():
    """The f32 attention kernels on this process's package, what
    ``--parent`` times on an older checkout before and after this one's
    rows: kernels 7 and 8 at the path's shape and the D 64 shape of
    :func:`_lm_cli_f32_rows` (``"path"``, ``"d64"``: [dQ ms, dK/dV ms]),
    kernels 1 and 6 at their rows' B8 H8 S512 D32 and D64 (``"fwd_bwd"``,
    ``"fwd_bwd_d64"``: [forward ms, fused backward ms]) and kernel 1 at
    path (d)'s shape (``"fwd_long"``: [forward ms])."""
    from distriflow_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(SEED + 44)
    flush = _flush_buffer()
    h, d = LM_CLI["n_heads"], LM_CLI["d_model"] // LM_CLI["n_heads"]
    out = {}
    for label, b, dd in (("path", LM_CLI_B, d), ("d64", 1, 64)):
        args = _bwd_inputs(g, b, h, LM_CLI_LONG_S, True, dd, torch.float32)
        out[label] = [_timed(lambda: fa.flash_attention_dq(*args), 5, flush),
                      _timed(lambda: fa.flash_attention_dkv(*args), 5, flush)]
        del args
    for label, dd in (("fwd_bwd", d), ("fwd_bwd_d64", 64)):
        args = _bwd_inputs(g, LM_CLI_B, h, LM_CLI["max_seq"], True, dd, torch.float32)
        out[label] = [_timed(lambda: fa.flash_attention(*args[:3], causal=True), 20, flush),
                      _timed(lambda: fa.flash_attention_backward(*args), 20, flush)]
        del args
    q, k, v = _f32_fwd_long_inputs(torch.Generator(device="cuda").manual_seed(F32_FWD_LONG_SEED))
    out["fwd_long"] = [_timed(lambda: fa.flash_attention(q, k, v, causal=True, return_lse=True), 5,
                              flush)]
    return out


#: the generator seed of kernel 1's f32 inputs at path (d)'s shape
F32_FWD_LONG_SEED = SEED + 46


def _bf16_attention_times():
    """The bf16 attention kernels on this process's package, what
    ``--parent`` times on an older checkout before and after this one's
    rows (``[ms, ...]`` by shape): kernels 7 and 8 at path (b)'s shape
    (``"path"``, B8 H8 S16384 D32: [dQ, dK/dV]) and at rows 7-8's D 64
    shape (``"d64"``, B1 H8 S16384), kernel 6 at its D 32 row's shape
    (``"fused_d32"``, B8 H8 S512) and at row 6's (``"fused_d64"``, B8 H8
    S1024 D64), kernel 1 at D 32 at every shape a path gives it: path
    (b)'s (``"fwd_path_b"``), path (a)'s (``"fwd_path_a"``, B8 H8 S512)
    and the speculative draft's prefills (``"fwd_spec_1k"``,
    ``"fwd_spec_16k"``: B1 H4 S1024 and S16288), and kernel 1 at D 64 at
    row 1's training shape (``"fwd_d64"``, B8 H8 S1024)."""
    from distriflow_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(SEED + 54)
    flush = _flush_buffer()
    h, d = LM_CLI["n_heads"], LM_CLI["d_model"] // LM_CLI["n_heads"]
    out = {}
    for label, b, dd in (("path", LM_CLI_B, d), ("d64", LONG_TRAIN_B, 64)):
        args = _bwd_inputs(g, b, h, LM_CLI_LONG_S, True, dd)
        out[label] = [_timed(lambda: fa.flash_attention_dq(*args), 10, flush),
                      _timed(lambda: fa.flash_attention_dkv(*args), 10, flush)]
        if label == "path":
            out["fwd_path_b"] = [_timed(lambda: fa.flash_attention(*args[:3], causal=True,
                                                                   return_lse=True), 10, flush)]
        del args
    for label, s, dd in (("fused_d32", LM_CLI["max_seq"], d), ("fused_d64", TRAIN_S, 64)):
        args = _bwd_inputs(g, LM_CLI_B, h, s, True, dd)
        out[label] = [_timed(lambda: fa.flash_attention_backward(*args), 20, flush)]
        del args
    for label, b, hh, s, dd in (("fwd_path_a", LM_CLI_B, h, LM_CLI["max_seq"], d),
                                ("fwd_spec_1k", 1, 4, SPEC_CONTEXTS[0], d),
                                ("fwd_spec_16k", 1, 4, SPEC_CONTEXTS[1] - SPEC_NEW, d),
                                ("fwd_d64", LM_CLI_B, h, TRAIN_S, 64)):
        q, k, v = (torch.randn(b, hh, s, dd, generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        out[label] = [_timed(lambda: fa.flash_attention(q, k, v, causal=True, return_lse=True), 20,
                             flush)]
        del q, k, v
    return out


def _path_steps(path):
    """Path (b)'s or path (c)'s step on this process's package (``path``
    "b": ``--seq 16384 --remat``, ``LM_CLI_LONG_STEPS`` steps; "c":
    ``--dtype float32``, ``LM_CLI_STEPS`` steps), at B 8 from the CLI's
    seeded tree on the corpus windows :func:`_lm_cli_phase` trains on,
    then one more under the profiler; ``{"step_ms_p50": ms, "profile":
    ...}``, what ``--parent`` runs on an older checkout before and after
    this one's."""
    cfg = _lm_cli_config()
    tree = _flagship_tree(cfg, np.random.default_rng(SEED + 40))
    corpus = _markov_corpus(CORPUS_TOKENS, SEED)
    if path == "b":
        run_cfg, steps = _lm_cli_config(max_seq=LM_CLI_LONG_S, remat=True), LM_CLI_LONG_STEPS
    else:
        run_cfg, steps = _lm_cli_config(dtype=torch.float32), LM_CLI_STEPS
    batches = _corpus_windows(corpus, LM_CLI_B, run_cfg.max_seq, steps + 1, SEED)
    trainer, _, ms = _train(run_cfg, tree, batches[:-1], "cuda", LM_CLI_LR)
    profile = _profiled(lambda: trainer.step(batches[-1]))
    del trainer
    return {"step_ms_p50": float(np.median(ms)), "profile": profile}


def _with_bf16_was(rows, was):
    """Rows 1 (D 32 at each of its shapes; D 64 at its ``training_shape``),
    6 (D 32 and D 64), 7 and 8 (D 32 and D 64) with ``was_ms``: the
    :func:`_bf16_attention_times` runs of an older checkout in ``was``
    (entry None: the row itself)."""
    at = {"flash_attention_dq_d32": [(None, "path", 0)], "flash_attention_dkv_d32": [(None, "path", 1)],
          "flash_attention_dq": [(None, "d64", 0)], "flash_attention_dkv": [(None, "d64", 1)],
          "flash_attention_bwd_d32": [(None, "fused_d32", 0)],
          "flash_attention_bwd": [(None, "fused_d64", 0)],
          "flash_attention_fwd": [("training_shape", "fwd_d64", 0)],
          "flash_attention_fwd_d32": [("path_b", "fwd_path_b", 0), ("path_a", "fwd_path_a", 0),
                                      (None, "fwd_spec_1k", 0), ("long_context", "fwd_spec_16k", 0)]}
    for row in rows:
        for entry, key, i in at.get(row["name"], ()):
            dst = row if entry is None else row[entry]
            dst["was_ms"] = [run[key][i] for run in was if key in run] or "not measured"
    return rows


#: (S, causal) of kernel 1's ragged checks at D 32: lengths that end
#: inside a 128-row Q tile and a 64-key K/V tile of its D 32 kernel
RAGGED_FWD_D32 = ((37, True), (37, False), (191, True), (191, False), (193, True), (193, False),
                  (1000, True), (1000, False))


def _fwd_no_correction(q, k, v, causal=True, block=64):
    """Kernel 1's recipe with a planted fault, one (b, h) slice at a time:
    each ``block``-key tile's p (the D 32 kernel's 64 keys) taken against
    the running max after that tile and never rescaled (the correction
    held at 1), in l and in the accumulator alike; ``(O, lse)`` as the
    plain version returns them."""
    from distriflow_tpu_torch.ops import flash_attention as fa

    scale = 1.0 / math.sqrt(q.shape[-1])

    def one(q, k, v):
        n = q.shape[2]
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        if causal:
            s = s.masked_fill(~fa._causal_keep(n, q.device), -math.inf)
        pad = -n % block
        tiles = torch.nn.functional.pad(s, (0, pad), value=-math.inf).unflatten(-1, (-1, block))
        m = tiles.amax(-1).cummax(-1).values
        m = torch.where(m == -math.inf, torch.zeros_like(m), m)
        p = torch.exp(s - m.repeat_interleave(block, -1)[..., :n])
        l = p.sum(-1, keepdim=True).clamp_min(1e-30)
        o = torch.matmul(p.to(v.dtype).float(), v.float()) / l
        return o.to(q.dtype), (m[..., -1:] + torch.log(l)).squeeze(-1)

    return fa._per_head(one, q, k, v)


def _fwd_d32_entry(g, b, h, s, flush, faults=False):
    """Kernel 1 at D 32 at (b, h, s) causal bf16, inputs standard normal
    from ``g``: held against its plain version one (b, h) slice at a time
    (one [S, S] score tensor live), the same bits on a second launch, the
    atol O and lse need, its time beside its bound (exponentials
    included), the plain version's and SDPA's. With ``faults``, the share
    of O and of lse that two planted faults put outside their limits: the
    correction held at 1 (:func:`_fwd_no_correction`) and lse without
    log(l); each must put more than half of O or of lse outside."""
    import torch.nn.functional as F

    from distriflow_tpu_torch.ops import flash_attention as fa

    d = 32
    q, k, v = (torch.randn(b, h, s, d, generator=g, device="cuda").to(torch.bfloat16)
               for _ in range(3))

    def plain(*t):
        return fa._per_head(lambda *x: fa.flash_attention_reference(*x, True), *t)

    nf = "flash_attention_fwd"
    o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    again = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    assert torch.equal(again[0], o) and torch.equal(again[1], lse), \
        f"kernel 1 D32 B{b} H{h} S{s}: other bits on a second launch"
    del again
    ro, rl = plain(q, k, v)
    out = {"shape": f"B={b} H={h} S={s} D={d} causal bf16",
           "max_abs_err": _over(f"{nf} D32 B{b} H{h} S{s}", o, ro, *TOL[nf]),
           "lse_max_abs_err": _over(f"{nf} D32 lse B{b} H{h} S{s}", lse, rl, LSE_ATOL, 0.0),
           "atol_needed": {"o": _atol_needed(nf, [(o, ro)]), "lse": float((lse - rl).abs().max())}}
    del o, lse
    if faults:
        no_corr = _fwd_no_correction(q, k, v)
        shares = {"no_correction": {"o": _rejected(nf, no_corr[0], ro),
                                    "lse": _rejected(nf, no_corr[1], rl, atol=LSE_ATOL)}}
        del no_corr
        no_log = fa._per_head(lambda *x: (_row_max(*x),), q, k, v)[0]
        shares["lse_without_log_l"] = {"lse": _rejected(nf, no_log, rl, atol=LSE_ATOL)}
        for fault, share in shares.items():
            assert max(share.values()) > 0.5, f"kernel 1 D32: the limits pass a wrong forward: {fault} {share}"
        out["rejected_share"] = shares
    del ro, rl
    pairs = s * (s + 1) // 2
    tb, by = _bound(4 * b * h * s * d * 2 + b * h * s * 4, 4 * b * h * pairs * d, exps=b * h * pairs)
    out.update({
        "ms": _timed(lambda: fa.flash_attention(q, k, v, causal=True, return_lse=True), 10, flush),
        "plain_ms": _timed(lambda: plain(q, k, v), 1, flush), "bound_ms": tb, "bound_by": by,
        "library_ms": _timed(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), 10,
                             flush),
        "library_note": "F.scaled_dot_product_attention, bf16, causal", "deterministic": True})
    return out


def _row_max(q, k, v):
    """lse without log(l), a planted fault of kernel 1: the plain forward's
    row max m of one causal slice, ``[1, 1, S]``."""
    from distriflow_tpu_torch.ops import flash_attention as fa

    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    return s.masked_fill(~fa._causal_keep(q.shape[2], q.device), fa.NEG_INF).amax(-1)


def _fwd_d32_entries(flush):
    """Kernel 1 at D 32 at path (b)'s shape (``path_b``: B8 H8 S16384, 8
    launches a step, with the planted faults) and path (a)'s (``path_a``:
    B8 H8 S512, 4 a step), each by :func:`_fwd_d32_entry`, and at the
    ragged lengths of :data:`RAGGED_FWD_D32` at B1 H8 (``ragged``: the
    atol O and lse need, each held)."""
    from distriflow_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(SEED + 55)
    h = LM_CLI["n_heads"]
    out = {"path_b": _fwd_d32_entry(g, LM_CLI_B, h, LM_CLI_LONG_S, flush, faults=True),
           "path_a": _fwd_d32_entry(g, LM_CLI_B, h, LM_CLI["max_seq"], flush)}
    ragged = out["ragged"] = {}
    nf = "flash_attention_fwd"
    for s, causal in RAGGED_FWD_D32:
        q, k, v = (torch.randn(1, h, s, 32, generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        o, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
        ro, rl = fa.flash_attention_reference(q, k, v, causal)
        tag = f"S={s} {'causal' if causal else 'non-causal'}"
        _over(f"{nf} D32 {tag}", o, ro, *TOL[nf])
        _over(f"{nf} D32 lse {tag}", lse, rl, LSE_ATOL, 0.0)
        ragged[tag] = {"o": _atol_needed(nf, [(o, ro)]), "lse": float((lse - rl).abs().max())}
    return out


def _f32_fwd_long_inputs(g):
    """q, k, v of kernel 1 in f32 at path (d)'s shape (B8 H8 S16384 D32),
    standard normal from ``g``."""
    h, d = LM_CLI["n_heads"], LM_CLI["d_model"] // LM_CLI["n_heads"]
    return tuple(torch.randn(LM_CLI_B, h, LM_CLI_LONG_S, d, generator=g, device="cuda")
                 for _ in range(3))


def _with_f32_was(rows, was):
    """Rows 1, 6, 7 and 8 in f32 with ``was_ms``: the older checkout's
    kernels before and after this one's, at each row's shape and at the
    D 64 shape beside it."""
    at = {"flash_attention_fwd_f32": ("fwd_bwd", "fwd_bwd_d64", 0),
          "flash_attention_bwd_f32": ("fwd_bwd", "fwd_bwd_d64", 1),
          "flash_attention_fwd_f32_long": ("fwd_long", None, 0),
          "flash_attention_dq_f32": ("path", "d64", 0), "flash_attention_dkv_f32": ("path", "d64", 1)}
    for row in rows:
        if row["name"] not in at:
            continue
        key, key64, i = at[row["name"]]
        row["was_ms"] = [run[key][i] for run in was] or "not measured"
        if key64:
            row["d64"]["was_ms"] = [run[key64][i] for run in was] or "not measured"
    return rows


def _p_ds_f64(q, k, v, do, lse, delta, causal):
    """P = exp(s * scale - lse) (masked pairs 0) and dS = P (dP - delta) of
    one (b, h) slice in f64 from its inputs, with no rounding to bf16 or
    f32 on the way: two ``[1, 1, S, S]`` tensors."""
    from distriflow_tpu_torch.ops import flash_attention as fa

    scale = 1.0 / math.sqrt(q.shape[-1])
    q, k, v, do, lse, delta = (t.double() for t in (q, k, v, do, lse, delta))
    p = torch.exp(q @ k.transpose(-1, -2) * scale - lse[..., None])
    if causal:
        p = torch.where(fa._causal_keep(q.shape[2], q.device), p, torch.zeros_like(p))
    return p, p * (do @ v.transpose(-1, -2) - delta[..., None])


def _dq_f64_recipe(q, k, v, do, lse, delta, causal):
    """dQ's recipe in f64 from the f32 inputs (dQ = scale dS K, dS from
    :func:`_p_ds_f64`), one (b, h) slice at a time: the reference f32 dQ
    is held to (``TOL["flash_attention_dq_f32_exact"]``)."""
    from distriflow_tpu_torch.ops import flash_attention as fa

    scale = 1.0 / math.sqrt(q.shape[-1])

    def one(q, k, v, do, lse, delta):
        return (_p_ds_f64(q, k, v, do, lse, delta, causal)[1] @ k.double() * scale,)

    return fa._per_head(one, q, k, v, do, lse, delta)[0]


def _flip_atols(name, grads, q, k, v, do, lse, delta, causal):
    """The bf16 backward limits' atols by element, one ``[B, H, S, D]`` f32
    tensor for each of ``grads`` ("dq", "dk", "dv"): ``name``'s atol plus
    :data:`BWD_FLIPS` flips of the bf16 value each term of the element's
    sum was rounded from, each charged at the element's heaviest term,
    ``2**-7`` times: ``scale max_j |dS_ij K_jd|`` (dQ), ``scale max_i |dS_ij
    Q_id|`` (dK), ``max_i |P_ij dO_id|`` (dV), P and dS from
    :func:`_p_ds_f64` (see the note above :data:`TOL`), each product in
    f32; one (b, h) slice, and one column d, at a time."""
    from distriflow_tpu_torch.ops import flash_attention as fa

    scale = 1.0 / math.sqrt(q.shape[-1])

    def one(q, k, v, do, lse, delta):
        p, ds = (t[0, 0] for t in _p_ds_f64(q, k, v, do, lse, delta, causal))
        terms = {"dq": (ds, k, scale), "dk": (ds.T, q, scale), "dv": (p.T, do, 1.0)}
        out = []
        for g in grads:  # the largest term in f32: a limit, not a sum
            w, x, c = terms[g]
            w, x = w.abs().float().contiguous(), x[0, 0].float().abs()
            heavy = torch.stack([(w * x[:, col]).amax(-1) for col in range(x.shape[1])], -1)
            out.append((TOL[name][0] + BWD_FLIPS * 2 ** -7 * c * heavy).float()[None, None])
        return tuple(out)

    return fa._per_head(one, q, k, v, do, lse, delta)


def _flips_needed(name, got, want, atol):
    """The flips of a :func:`_flip_atols` limit (``atol``) that the
    elements of ``got`` need around ``want``: the most, over elements,
    of their error beyond ``name``'s atol and rtol, in units of one flip
    at the element's heaviest term (at most :data:`BWD_FLIPS` inside the
    limit)."""
    base, rtol = TOL[name]
    got, want = got.float(), want.float()
    unit = (atol - base) / BWD_FLIPS
    over = (got - want).abs() - base - rtol * want.abs()
    return float(torch.where(over > 0, over / unit, torch.zeros_like(over)).max())


def _flip_report(name, triples):
    """A flip limit's reading over (kernel, plain, atol) triples: the flips
    the kernel needs at most (:func:`_flips_needed`), the atol's median
    and largest value."""
    return {"flips": BWD_FLIPS,
            "flips_needed": max(_flips_needed(name, g, w, a) for g, w, a in triples),
            "atol_median": float(torch.cat([a.flatten() for _, _, a in triples]).median()),
            "atol_max": max(float(a.max()) for _, _, a in triples)}


def _dq_exact_check(label, dq, plain, args, wrong):
    """f32 dQ (``dq``) and its f32 plain version (``plain``) held against
    the f64 recipe under ``TOL["flash_attention_dq_f32_exact"]``: each
    one's largest error and the atol it needs, and the share of elements
    each of ``wrong`` (planted faults, by name) puts outside the limit."""
    ne = "flash_attention_dq_f32_exact"
    exact = _dq_f64_recipe(*args)
    out = {"tol": _tol(ne).replace("|plain|", "|f64 recipe|"),
           "max_abs_err": _over(f"{ne} {label}", dq, exact, *TOL[ne]),
           "kernel_atol_needed": _atol_needed(ne, [(dq, exact)]),
           "plain_max_abs_err": _over(f"{ne} plain {label}", plain, exact, *TOL[ne]),
           "plain_atol_needed": _atol_needed(ne, [(plain, exact)])}
    if wrong:
        out["rejected_share"] = {n: _rejected(ne, w, exact) for n, w in wrong.items()}
        assert all(x > 0.5 for x in out["rejected_share"].values()), \
            f"{ne} {label}: the limit passes a wrong dQ: {out['rejected_share']}"
    return out


NAN_BITS = 0x7FFFFFFF  # the NaN that device arithmetic produces
NAN_OUTPUTS = ("o", "lse", "dq", "dk", "dv")


def _plant_nan(t, idx):
    """Element ``idx`` of ``t`` becomes :data:`NAN_BITS` (f32) or its top
    half (bf16, 0x7FFF)."""
    if t.dtype == torch.float32:
        t.view(torch.int32)[idx] = NAN_BITS
    else:
        t.view(torch.int16)[idx] = NAN_BITS >> 16


def _nan_outputs(fwd, bwd, q, k, v, do):
    """Which outputs of one forward and backward carry a NaN when one
    element of q, of k or of v is the NaN :data:`NAN_BITS` (causal; q's
    at row S/2, k's and v's at row S/3): ``{"q": {"o": bool, ...}, ...}``.
    ``fwd(q, k, v)`` gives (O, lse), ``bwd(q, k, v, dO, lse, delta)``
    (dQ, dK, dV), delta = rowsum(dO O) of that forward."""
    s = q.shape[2]
    out = {}
    for which, row, col in (("q", s // 2, 0), ("k", s // 3, 1), ("v", s // 3, 2)):
        t = {"q": q.clone(), "k": k.clone(), "v": v.clone()}
        _plant_nan(t[which], (..., row, col))
        o, lse = fwd(t["q"], t["k"], t["v"])
        grads = bwd(t["q"], t["k"], t["v"], do, lse, (do.float() * o.float()).sum(-1))
        out[which] = {n: bool(x.isnan().any()) for n, x in zip(NAN_OUTPUTS, (o, lse, *grads))}
    return out


def _nan_check(label, fwd, bwd, plain_fwd, plain_bwd, q, k, v, do):
    """A NaN in q, k or v reaches the same outputs through ``fwd`` and
    ``bwd`` as through the plain versions, and always O, dQ and dK (dV =
    P^T dO and lse do not read V); raises otherwise. Returns the outputs
    that carried it."""
    got = _nan_outputs(fwd, bwd, q, k, v, do)
    want = _nan_outputs(plain_fwd, plain_bwd, q, k, v, do)
    assert got == want, f"{label}: a NaN input reaches {got}, its plain version {want}"
    assert all(got[w][n] for w in got for n in ("o", "dq", "dk")), \
        f"{label}: a NaN input gave a finite O, dQ or dK: {got}"
    return {w: [n for n in NAN_OUTPUTS if got[w][n]] for w in got}


def _lm_cli_f32_rows(launches):
    """The rows path (c)'s decode and path (d)'s backward add, each held
    against its plain version at its path's shape with the D 64 shape
    beside it: kernels 3 and 2 on f32 caches (``flash_decode_f32``: B1,
    the CLI's slab of 512 all valid, and at 95, ``--generate 64``'s last
    step; D 64 at row 3's B1 S2048 with 1064 valid;
    ``flash_decode_paged_f32``: the serve leg's slots at page 128, contexts
    33, 64 and 95 and one of 300 past a split; D 64 at row 2's B8 H8
    shape), and kernels 7 and 8 in f32 (B8 H8 S16384 D32; D 64 at B1 H8
    S16384). Each: its limit, the same bits on a second launch, planted
    faults rejected, its time beside its bound, its plain version (TF32
    off) and a library call; for 7 and 8 also ragged lengths (at D 64 too:
    :func:`_ragged_f32_d64`), the largest error and the share of elements
    outside the limit of one TF32 pass of the plain recipe beside the
    kernel's own (``tf32_vs_kernel``), and the bound of the function's f32
    products at the split-precision rate beside their bound at the FFMA
    peak (``bound_ffma_ms``)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from distriflow_tpu_torch.ops import flash_attention as fa

    flush = _flush_buffer()
    h, d = LM_CLI["n_heads"], LM_CLI["d_model"] // LM_CLI["n_heads"]
    s = LM_CLI["max_seq"]

    def slab_sdpa(n, s_max, q, k, v):
        # SDPA on [B, H, n, D] f32 copies of the n valid positions (every
        # row's), made outside the timed call
        b, hh, dd = q.shape
        kh, vh = (t.view(b, s_max, hh, dd).transpose(1, 2)[:, :, :n].contiguous() for t in (k, v))
        return lambda: F.scaled_dot_product_attention(q[:, :, None], kh, vh)

    rows = [
        _f32_decode_row("flash_decode_f32", launches, "distriflow_tpu/ops/flash_decode.py:235", {
            "path": (1, h, d, [s], None, s), "generate_last_step": (1, h, d, [95], None, s),
            "d64": (1, 8, 64, [1064], None, 2048)}, flush, slab_sdpa),
        _f32_decode_row("flash_decode_paged_f32", launches,
                        "distriflow_tpu/ops/flash_decode.py:474", {
                            "path": (4, h, d, [33, 64, 95, 300], 128, None),
                            "d64": (8, 8, 64, [129, 300, 513, 1001, 193, 577, 1064, 128], 128,
                                    None),
                            # the largest page the f32 gate takes: one 128 KB
                            # ring stage a block at D 64
                            "d64_page256": (8, 8, 64, [129, 300, 513, 1001, 193, 577, 1064, 128],
                                            256, None)}, flush, slab_sdpa)]
    rows[1]["library_note"] = "null: no single PyTorch call attends over a paged cache"
    rows[0]["library_note"] = ("F.scaled_dot_product_attention on contiguous f32 copies of the "
                               "valid positions (TF32 off)")

    # kernels 7 and 8 in f32: --dtype float32 --seq 16384 --remat, B 8
    g = torch.Generator(device="cuda").manual_seed(SEED + 44)
    src = "distriflow_tpu_torch/csrc/flash_attention_f32.cu"
    ls = LM_CLI_LONG_S
    by = {"flash_attention_dq_f32": {}, "flash_attention_dkv_f32": {}}
    for label, b, dd in (("path", LM_CLI_B, d), ("d64", 1, 64)):
        args = _bwd_inputs(g, b, h, ls, True, dd, torch.float32)
        q, k, v, do, lse, delta, _ = args
        dq, want_q = fa.flash_attention_dq(*args), fa.flash_attention_dq_reference(*args)
        assert torch.equal(fa.flash_attention_dq(*args), dq), f"dq f32 {label}: other bits"
        nq = "flash_attention_dq_f32"
        err_q = _over(f"{nq} {label}", dq, want_q, *TOL[nq])
        no_delta = fa.flash_attention_dq_reference(q, k, v, do, lse, torch.zeros_like(delta), True)
        tf32_q = _tf32_run(lambda: fa.flash_attention_dq_reference(*args))
        ctl_q = {"no_delta": _rejected(nq, no_delta, want_q),
                 "tf32_plain": _rejected(nq, tf32_q, want_q)}
        beside_q = {"dq": _beside_tf32(nq, dq, want_q, tf32_q)}
        need_q = _atol_needed(nq, [(dq, want_q)])
        exact_q = _dq_exact_check(label, dq, want_q, args,
                                  {"no_delta": no_delta, "tf32_plain": tf32_q})
        del dq, want_q, no_delta, tf32_q
        (dk, dv), (want_k, want_v) = fa.flash_attention_dkv(*args), fa.flash_attention_dkv_reference(*args)
        again = fa.flash_attention_dkv(*args)
        assert torch.equal(again[0], dk) and torch.equal(again[1], dv), f"dkv f32 {label}: other bits"
        nk = "flash_attention_dkv_f32"
        err_k = max(_over(f"{nk} {label} dk", dk, want_k, *TOL[nk]),
                    _over(f"{nk} {label} dv", dv, want_v, *TOL[nk]))
        tf32_k, tf32_v = _tf32_run(lambda: fa.flash_attention_dkv_reference(*args))
        ctl_k = {"dk_unscaled": _rejected(nk, want_k * math.sqrt(dd), want_k),
                 "tf32_plain_dk": _rejected(nk, tf32_k, want_k)}
        beside_k = {"dk": _beside_tf32(nk, dk, want_k, tf32_k),
                    "dv": _beside_tf32(nk, dv, want_v, tf32_v)}
        need_k = _atol_needed(nk, [(dk, want_k), (dv, want_v)])
        del dk, dv, want_k, want_v, again, tf32_k, tf32_v
        assert ctl_q["no_delta"] > 0.5 and ctl_k["dk_unscaled"] > 0.5, \
            f"an f32 two-kernel limit passes a wrong gradient: {ctl_q} {ctl_k}"
        qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
        # the math backend's [B, H, S, S] f32 scores would take 68.7 GB at
        # the path's shape: SDPA's f32 backward on its memory-efficient one
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        library = _timed(lambda: torch.autograd.grad(out, (qs, ks, vs), do, retain_graph=True), 3,
                         flush)
        pairs = ls * (ls + 1) // 2
        io = 4 * b * h * ls * dd * 4 + 2 * b * h * ls * 4
        unit = 2 * b * h * pairs * dd  # the FLOPs of one product
        shape = f"B={b} H={h} S={ls} D={dd} causal f32"
        # the function's f32 products (dQ: S, dP, dS K; dK/dV: S^T, dP^T,
        # P^T dO, dS^T Q), bounded at the split-precision rate (3 TF32
        # products each) with the FFMA peak's bound beside
        for name, products, outs, fn, plain, err, ctl, need, beside in (
                (nq, 3, 1, fa.flash_attention_dq, fa.flash_attention_dq_reference, err_q, ctl_q,
                 need_q, beside_q),
                (nk, 4, 2, fa.flash_attention_dkv, fa.flash_attention_dkv_reference, err_k,
                 ctl_k, need_k, beside_k)):
            nbytes = io + outs * b * h * ls * dd * 4
            tb, bb = _bound(nbytes, 3 * products * unit, TF32_FLOPS, exps=b * h * pairs)
            by[name][label] = {"shape": shape, "max_abs_err": err, "rejected_share": ctl,
                               "atol_needed": need, "tf32_vs_kernel": beside,
                               "ms": _timed(lambda fn=fn: fn(*args), 5, flush),
                               "plain_ms": _timed(lambda plain=plain: plain(*args), 1, flush),
                               "bound_ms": tb, "bound_by": bb,
                               "bound_ffma_ms": _bound(nbytes, products * unit, F32_FLOPS,
                                                        exps=b * h * pairs)[0],
                               "library_ms": library}
        by[nq][label]["exact"] = exact_q
        del args, q, k, v, do, lse, delta, qs, ks, vs, out
    for name, line, fn, plain in (
            ("flash_attention_dq_f32", "distriflow_tpu/ops/flash_attention.py:162",
             lambda *a: (fa.flash_attention_dq(*a),), lambda *a: (fa.flash_attention_dq_reference(*a),)),
            ("flash_attention_dkv_f32", "distriflow_tpu/ops/flash_attention.py:212",
             fa.flash_attention_dkv, fa.flash_attention_dkv_reference)):
        main = by[name]["path"]
        rows.append(_row(name, src, line, launches, max(a["max_abs_err"] for a in by[name].values()),
                         main["shape"], **{k: main[k] for k in (
                             "ms", "plain_ms", "bound_ms", "bound_by", "bound_ffma_ms",
                             "library_ms", "rejected_share", "atol_needed", "tf32_vs_kernel")},
                         **({"exact": main["exact"]} if "exact" in main else {}),
                         library_note="F.scaled_dot_product_attention backward, f32, the "
                                      "memory-efficient backend: dQ, dK and dV together",
                         d64=by[name]["d64"], deterministic=True,
                         ragged_max_abs_err=_ragged_bwd(name, fn, plain, g, 1, h, d, torch.float32)))
    for row, ragged in zip(rows[-2:], _ragged_f32_d64(h)):
        row["d64"]["ragged"] = ragged
    rows.append(_f32_fwd_long_row(launches, flush))
    return rows


def _attention_nan_checks(h, dtype):
    """:func:`_nan_check` on the forward (kernel 1) and the two-kernel
    backward (kernels 7 and 8) in ``dtype`` at D 32 and D 64 (B1, ``h``
    heads, S 300 causal, inputs of their own generator) against their
    plain versions (f32: TF32 off): the split-precision kernels in f32,
    and in bf16 the TMA/wgmma kernels (at D 32 the d32 pair); in f32 also
    the forward with the fused backward (kernel 6) on the same inputs
    (``fused D=...``)."""
    from distriflow_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(SEED + (49 if dtype == torch.float32 else 51))

    def fwd(q, k, v):
        return fa.flash_attention(q, k, v, causal=True, return_lse=True)

    def bwd(*a):
        return (fa.flash_attention_dq(*a, True), *fa.flash_attention_dkv(*a, True))

    def plain_bwd(*a):
        return (fa.flash_attention_dq_reference(*a, True), *fa.flash_attention_dkv_reference(*a, True))

    out = {}
    for d in (LM_CLI["d_model"] // LM_CLI["n_heads"], 64):
        q, k, v, do = (torch.randn(1, h, 300, d, generator=g, device="cuda").to(dtype)
                       for _ in range(4))
        label = "f32 split kernels" if dtype == torch.float32 else "bf16 kernels 1, 7, 8"
        out[f"D={d}"] = _nan_check(f"{label} D={d}", fwd, bwd,
                                   lambda *a: fa.flash_attention_reference(*a, True), plain_bwd,
                                   q, k, v, do)
        if dtype == torch.float32:
            out[f"fused D={d}"] = _nan_check(
                f"f32 kernels 1 and 6 D={d}", fwd, lambda *a: fa.flash_attention_backward(*a, True),
                lambda *a: fa.flash_attention_reference(*a, True),
                lambda *a: fa.flash_attention_backward_reference(*a, True), q, k, v, do)
    return out


def _ce_nan_checks():
    """The fused CE forward (kernels 9 and 9d) on logits with one NaN: in
    a column other than the row's label (one-hot target), then in the
    label's own, for bf16 and f32 logits, sparse and dense, at V 256 (row
    tiles) and V 32000 (one block a row). The kernel's loss and lse carry
    NaN in exactly the rows its plain version's do, and in the planted row
    alone; raises otherwise."""
    from distriflow_tpu_torch.ops import fused_ce as ce

    g = torch.Generator(device="cuda").manual_seed(SEED + 52)
    out = {}
    n, row = 300, 37
    for vocab in (CORPUS_VOCAB, 32000):
        for dtype in (torch.bfloat16, torch.float32):
            logits = (torch.randn(n, vocab, generator=g, device="cuda") * 3).to(dtype)
            labels = torch.randint(0, vocab, (n,), generator=g, device="cuda", dtype=torch.int32)
            onehot = torch.nn.functional.one_hot(labels.long(), vocab).float()
            for at in ("other", "label"):
                x = logits.clone()
                col = int(labels[row]) if at == "label" else (int(labels[row]) + 5) % vocab
                _plant_nan(x, (row, col))
                for kind, fn, plain, t in (
                        ("sparse", ce.fused_ce_forward, ce.fused_ce_forward_reference, labels),
                        ("dense", ce.fused_ce_dense_forward, ce.fused_ce_dense_forward_reference,
                         onehot)):
                    got, want = fn(x, t), plain(x, t)
                    tag = f"{kind} V={vocab} {str(dtype).replace('torch.', '')} {at}"
                    rows = {}
                    for name, a, w in zip(("loss", "lse"), got, want):
                        ga, wa = a.isnan(), w.isnan()
                        assert torch.equal(ga, wa), f"fused CE {tag} {name}: NaN rows " \
                            f"{ga.nonzero().flatten().tolist()}, plain {wa.nonzero().flatten().tolist()}"
                        rows[name] = ga.nonzero().flatten().tolist()
                    assert rows == {"loss": [row], "lse": [row]}, f"fused CE {tag}: {rows}"
                    out[tag] = rows
    return out


def _decode_nan_checks(h):
    """The decode kernels (2 and 3 on bf16 and f32 caches, 4 and 5 on int8,
    each through the combine kernel) with one NaN in q, then in one live K
    position (of an int8 cache: its scale, as quantizing a NaN row gives):
    the output carries NaN at exactly the (row, head)s of its plain
    version's, and at the planted one; raises otherwise. Pages of 128,
    rows of 33, 300 and 1000 positions (the last over several splits), ``h``
    heads of 32 (int8: of 64)."""
    from distriflow_tpu_torch.ops import flash_decode as fd

    g = torch.Generator(device="cuda").manual_seed(SEED + 53)
    ps, lens_l = 128, [33, 300, 1000]
    bsz, pp, s_max = len(lens_l), 8, 1024
    n_pages = sum(-(-n // ps) for n in lens_l) + 2
    out = {}
    for cache in ("bf16", "f32", "int8"):
        dt = torch.float32 if cache == "f32" else torch.bfloat16
        # the CLI's head dim; the int8 kernels are built at D 64 alone
        d = 64 if cache == "int8" else LM_CLI["d_model"] // LM_CLI["n_heads"]
        table, lens = _paged_rows(g, lens_l, ps, n_pages, pp)
        q = torch.randn(bsz, h, d, generator=g, device="cuda").to(dt)
        if cache == "int8":
            pool = _int8_cache(g, (n_pages, ps), h, d)
            slab = _int8_cache(g, (bsz, s_max), h, d)
            paged = (fd.flash_decode_paged_int8, fd.flash_decode_paged_int8_reference)
            flat = (fd.flash_decode_int8, fd.flash_decode_int8_reference)
        else:
            pool = tuple(torch.randn(n_pages, ps, h * d, generator=g, device="cuda").to(dt)
                         for _ in range(2))
            slab = tuple(torch.randn(bsz, s_max, h * d, generator=g, device="cuda").to(dt)
                         for _ in range(2))
            paged = (fd.flash_decode_paged, fd.flash_decode_paged_reference)
            flat = (fd.flash_decode, fd.flash_decode_reference)
        for layout, (fn, plain), kv, extra in (("paged", paged, pool, (table, lens)),
                                               ("slab", flat, slab, (lens,))):
            for which in ("q", "k"):
                qq, kv2 = q.clone(), [t.clone() for t in kv]
                r, head, pos = 1, 2, 257  # row 1's position 257 of 300: its third page
                if which == "q":
                    _plant_nan(qq, (r, head, 5))
                else:
                    page = int(table[r, pos // ps]) if layout == "paged" else r
                    at = pos % ps if layout == "paged" else pos
                    if cache == "int8":
                        _plant_nan(kv2[2], (page, at, head))  # the K scale
                    else:
                        _plant_nan(kv2[0], (page, at, head * d + 3))
                got = fn(qq, *kv2, *extra).isnan().any(-1)
                want = plain(qq, *kv2, *extra).isnan().any(-1)
                tag = f"{cache} {layout} {which}"
                assert torch.equal(got, want), f"decode {tag}: NaN at (row, head) " \
                    f"{got.nonzero().tolist()}, plain {want.nonzero().tolist()}"
                assert bool(got[r, head]), f"decode {tag}: the NaN did not reach the output"
                out[tag] = got.nonzero().tolist()
    return out


def _nan_phase(h):
    """The NaN checks (:func:`_attention_nan_checks` in bf16 and f32,
    :func:`_ce_nan_checks`, :func:`_decode_nan_checks`), each kernel's
    outputs against its plain version's."""
    return {"attention_bf16": _attention_nan_checks(h, torch.bfloat16),
            "attention_f32": _attention_nan_checks(h, torch.float32), "fused_ce_fwd": _ce_nan_checks(),
            "decode": _decode_nan_checks(h)}


#: the NaN check each kernel row carries (``nan_reaches``), by row name
NAN_ROWS = {**{k: "attention_bf16" for k in (
    "flash_attention_fwd", "flash_attention_fwd_d32", "flash_attention_dq", "flash_attention_dkv",
    "flash_attention_dq_d32", "flash_attention_dkv_d32")},
    **{k: "attention_f32" for k in (
        "flash_attention_fwd_f32", "flash_attention_bwd_f32", "flash_attention_dq_f32",
        "flash_attention_dkv_f32", "flash_attention_fwd_f32_long")},
    **{k: "fused_ce_fwd" for k in ("fused_ce_fwd", "fused_ce_dense_fwd", "fused_ce_fwd_f32",
                                   "fused_ce_dense_fwd_f32")},
    **{k: "decode" for k in ("flash_decode_paged", "flash_decode", "flash_decode_paged_int8",
                             "flash_decode_int8", "flash_decode_paged_d32", "flash_decode_d32",
                             "flash_decode_f32", "flash_decode_paged_f32")}}


def _f32_fwd_long_row(launches, flush):
    """Kernel 1 in f32 at path (d)'s shape (``--dtype float32 --seq 16384
    --remat``: B8 H8 S16384 D32 causal): held against its plain version
    one (b, h) slice at a time (one [S, S] f32 score tensor live), the same
    bits on a second launch, a bf16 forward rejected and one TF32 pass's
    share outside reported; its time beside its bound at the split-precision
    TF32 rate (both products, 3 TF32 products each) and at the FFMA peak,
    the plain version's and SDPA's f32 forward on its memory-efficient
    backend (TF32 off: the math backend's [8, 8, 16384, 16384] f32 scores
    would take 68.7 GB)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from distriflow_tpu_torch.ops import flash_attention as fa

    name, nf = "flash_attention_fwd_f32_long", "flash_attention_fwd_f32"
    q, k, v = _f32_fwd_long_inputs(torch.Generator(device="cuda").manual_seed(F32_FWD_LONG_SEED))
    b, h, s, d = q.shape

    def plain(*t):
        return fa._per_head(lambda *x: fa.flash_attention_reference(*x, True), *t)

    o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    again = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    assert torch.equal(again[0], o) and torch.equal(again[1], lse), f"{name}: other bits"
    del again
    ro, rl = plain(q, k, v)
    err = max(_over(f"{name} O", o, ro, *TOL[nf]), _over(f"{name} lse", lse, rl, *TOL[nf]))
    needed = {"o": _atol_needed(nf, [(o, ro)]), "lse": _atol_needed(nf, [(lse, rl)])}
    del o, lse
    # planted: P and V through bf16 (the bf16 kernel's contract) must fail
    # the f32 limit; one TF32 pass of the plain version is reported
    controls = {"bf16_operands": _rejected(nf, plain(*(t.bfloat16() for t in (q, k, v)))[0], ro),
                "tf32_plain": _tf32_share(nf, lambda: plain(q, k, v), ro)}
    assert controls["bf16_operands"] > 0.5, f"{name}: the limit passes a bf16 forward: {controls}"
    del ro, rl
    pairs = s * (s + 1) // 2
    nbytes, flops = 4 * b * h * s * d * 4 + b * h * s * 4, 4 * b * h * pairs * d
    tb, by = _bound(nbytes, 3 * flops, TF32_FLOPS, exps=b * h * pairs)
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        library = _timed(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), 5, flush)
    return _row(name, "distriflow_tpu_torch/csrc/flash_attention_f32.cu",
                "distriflow_tpu/ops/flash_attention.py:92", launches, err,
                f"B={b} H={h} S={s} D={d} causal f32", tol_of=nf,
                ms=_timed(lambda: fa.flash_attention(q, k, v, causal=True, return_lse=True), 5,
                          flush),
                plain_ms=_timed(lambda: plain(q, k, v), 1, flush), bound_ms=tb, bound_by=by,
                bound_ffma_ms=_bound(nbytes, flops, F32_FLOPS, exps=b * h * pairs)[0], library_ms=library,
                library_note="F.scaled_dot_product_attention, f32 (TF32 off), the "
                             "memory-efficient backend", rejected_share=controls,
                atol_needed=needed, deterministic=True)


# (S, causal) of the f32 two-kernel rows and the f32 forward at D 64:
# RAGGED_BWD's lengths and the short causal ones where dQ leaves elements
# outside its limit (S 1: one row of one warp; S 128: one full block)
RAGGED_F32_D64 = ((1, True), (37, True), (37, False), (128, True), (1000, True), (1000, False))


def _ragged_f32_d64(h):
    """Kernels 7 and 8 in f32 at D 64 (B1, ``h`` heads) on
    :data:`RAGGED_F32_D64`, with inputs of their own generator: dK and dV
    held to their limit (max abs error by length); dQ held to the f64
    recipe (:func:`_dq_exact_check`), with its plain version, and reported
    against the plain version (at some short causal lengths the plain
    version's dP is not a sum in d order, and atol 1e-6 follows its
    rounding): by length, its max abs error, the atol it needs and the
    elements outside that limit."""
    from distriflow_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(SEED + 45)
    nq, nk = "flash_attention_dq_f32", "flash_attention_dkv_f32"
    dq, dkv = {}, {}
    for s, causal in RAGGED_F32_D64:
        args = _bwd_inputs(g, 1, h, s, causal, 64, torch.float32)
        tag = f"S={s} {'causal' if causal else 'non-causal'}"
        got, want = fa.flash_attention_dq(*args), fa.flash_attention_dq_reference(*args)
        atol, rtol = TOL[nq]
        dq[tag] = {"max_abs_err": float((got - want).abs().max()),
                   "atol_needed": _atol_needed(nq, [(got, want)]),
                   "outside": int(((got - want).abs() > atol + rtol * want.abs()).sum()),
                   "elements": want.numel(),
                   "exact": _dq_exact_check(f"D=64 {tag}", got, want, args, {})}
        dkv[tag] = max(_over(f"{nk} D=64 {tag}", a, w, *TOL[nk])
                       for a, w in zip(fa.flash_attention_dkv(*args),
                                       fa.flash_attention_dkv_reference(*args)))
    return dq, dkv


def _peak_gauge():
    """``obs/cuda_hooks.py`` on the training's telemetry (the process-global
    one ``SyncTrainer`` records to): a snapshot's
    ``device_peak_bytes{device=cuda:0}`` must equal
    ``torch.cuda.max_memory_allocated(0)``, read right after it."""
    from distriflow_tpu_torch.obs.cuda_hooks import install_cuda_hooks
    from distriflow_tpu_torch.obs.registry import metric_ident
    from distriflow_tpu_torch.obs.telemetry import get_telemetry

    tel = get_telemetry()
    assert install_cuda_hooks(tel) and install_cuda_hooks(tel), "install_cuda_hooks refused"
    gauge = tel.snapshot()["gauges"].get(metric_ident("device_peak_bytes", {"device": "cuda:0"}))
    peak = torch.cuda.max_memory_allocated(0)
    assert gauge == peak, f"device_peak_bytes {gauge} != max_memory_allocated {peak}"
    return {"device_peak_bytes": gauge, "max_memory_allocated": peak}


def _convnet_tree(rng: np.random.Generator):
    """A flax-shaped ``cifar_convnet`` params tree: lecun-normal-scaled
    random kernels (conv HWIO, dense ``[in, out]``) and zero biases, as
    flax initialises them."""
    def w(*shape, fan_in):
        return rng.standard_normal(shape, dtype=np.float32) / np.float32(math.sqrt(fan_in))

    p, cin = {}, 3
    for i, f in enumerate((64, 128, 256)):
        p[f"Conv_{i}"] = {"kernel": w(3, 3, cin, f, fan_in=9 * cin), "bias": np.zeros(f, np.float32)}
        cin = f
    p["Dense_0"] = {"kernel": w(4 * 4 * 256, 256, fan_in=4 * 4 * 256),
                    "bias": np.zeros(256, np.float32)}
    p["Dense_1"] = {"kernel": w(256, 10, fan_in=256), "bias": np.zeros(10, np.float32)}
    return {"params": p}


def _synthetic_cifar10(n_train: int, n_val: int, seed: int):
    """The JAX repo's ``experiments/cifar10/cifar_data.py::synthetic_cifar10``
    recipe: a 4x4x3 colour pattern per class, upsampled to 32x32, plus
    noise, as uint8 with uint8 labels."""
    rng = np.random.RandomState(seed)
    patterns = rng.rand(10, 4, 4, 3)

    def make(n):
        labels = rng.randint(0, 10, n).astype(np.uint8)
        imgs = np.repeat(np.repeat(patterns[labels], 8, axis=1), 8, axis=2)
        imgs = imgs * 200 + rng.rand(n, 32, 32, 3) * 55
        return imgs.astype(np.uint8), labels

    return make(n_train), make(n_val)


def _to_xy(split, classes: int = 10):
    """``cifar_data.py::to_xy``: f32 images in [0, 1], one-hot f32 targets."""
    imgs, labels = split
    return imgs.astype(np.float32) / 255.0, np.eye(classes, dtype=np.float32)[labels]


def _convnet_spec(device="cuda", loss="fused_softmax_cross_entropy"):
    """``cifar_convnet`` in bf16 with the fused dense CE (or ``loss``)."""
    from distriflow_tpu_torch.models.zoo import cifar_convnet

    return dataclasses.replace(cifar_convnet(dtype=torch.bfloat16, device=device), loss=loss)


def _convnet_phase(tree, counted, device="cuda", steps=CN_STEPS, batch=CN_B):
    """The ConvNet trained ``steps`` steps by ``run_chunked`` over
    ``sampling_iterator`` + ``prefetch_to_device``, then evaluated by
    ``evaluate_dataset`` on the validation split, each in its own launch
    window. Returns ``(report, trainer, a batch, launch counts by window)``."""
    from distriflow_tpu_torch.models.convert import zoo_params_from_jax
    from distriflow_tpu_torch.train.sync import SyncTrainer

    trainer = SyncTrainer(_convnet_spec(device), optimizer="sgd", learning_rate=CN_LR)
    trainer.init(SEED)
    trainer.set_params(zoo_params_from_jax(tree))
    report, step_batch, train_counts, eval_counts = _run_convnet(trainer, counted, device, steps,
                                                                 batch, "cifar_convnet")
    return report, trainer, step_batch, {"convnet_train": train_counts, "convnet_eval": eval_counts}


def _run_convnet(trainer, counted, device, steps, batch, model):
    """``trainer`` (a ConvNet at BASELINE #2's recipe) trained ``steps``
    steps on the synthetic CIFAR-10 batches and evaluated, each in its own
    launch window: ``(report, a spare batch, train counts, eval counts)``."""
    from distriflow_tpu_torch.data.prefetch import prefetch_to_device, sampling_iterator
    from distriflow_tpu_torch.train.loop import evaluate_dataset, run_chunked

    t0 = time.perf_counter()
    train, val = _synthetic_cifar10(CN_TRAIN, CN_VAL, SEED)
    (x, y), (vx, vy) = _to_xy(train), _to_xy(val)
    data_s = time.perf_counter() - t0
    losses, step_ms = [], []
    trainer.callbacks.register("step", lambda t: step_ms.append(t.last_step_ms))
    stream = prefetch_to_device(sampling_iterator(x, y, batch, steps=steps, seed=SEED), device)
    res, train_counts = counted(lambda: run_chunked(
        trainer, stream, steps=steps, log=lambda s, l: losses.append(l), log_every=1))
    (val_loss, val_acc), eval_counts = counted(
        lambda: evaluate_dataset(trainer.evaluate, vx, vy, batch_size=batch))
    assert res.steps_run == steps and len(losses) == steps, res
    assert all(math.isfinite(v) for v in losses), losses
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    assert last < first, f"{model} loss did not fall: first 5 mean {first}, last 5 mean {last}"
    assert math.isfinite(val_loss) and 0.0 <= val_acc <= 1.0, (val_loss, val_acc)
    p50 = float(np.median(step_ms))
    report = {
        "config": {"model": model, "batch": batch, "dtype": "bfloat16",
                   "loss": trainer.spec.loss, "targets": "one-hot f32", "optimizer": "sgd",
                   "lr": CN_LR},
        "steps": steps, "train_images": CN_TRAIN, "val_images": CN_VAL, "data_s": data_s,
        "step_ms_p50": p50, "step_ms_max": max(step_ms), "step_ms_first": step_ms[0],
        "samples_per_s": batch / (p50 / 1e3), "steady_samples_per_s": res.steps_per_sec * batch,
        "first_loss": losses[0], "last_loss": losses[-1], "first5_mean": first,
        "last5_mean": last, "losses": losses, "val_loss": val_loss, "val_accuracy": val_acc}
    step_batch = next(sampling_iterator(x, y, batch, steps=1, seed=SEED + 1))
    return report, step_batch, train_counts, eval_counts


def _convnet_step_vs_plain(tree, batch, device="cuda"):
    """One ConvNet step's loss and gradients through the dense CE kernels
    and through the plain ``softmax_cross_entropy``, from the same f32
    masters and batch."""
    from distriflow_tpu_torch.models.convert import zoo_params_from_jax

    x, y = (torch.as_tensor(a, device=device) for a in batch)
    out = {}
    for name, loss in (("kernels", "fused_softmax_cross_entropy"),
                       ("plain", "softmax_cross_entropy")):
        spec = _convnet_spec(device, loss)
        model = spec.init(SEED)
        model.load_state_dict(zoo_params_from_jax(tree), strict=True)
        l, grads = spec.grad_fn()(model, x, y)
        out[name] = (float(l), grads)
        del model
    return _grads_vs_plain(out, STEP_TOL)


class _Fits:
    """Thread-safe log of every worker fit's loss, in completion order."""

    def __init__(self):
        self.losses, self._lock = [], threading.Lock()

    def model(self, spec, **kw):
        """A port ``SpecModel`` whose ``fit`` records its loss here."""
        from distriflow_tpu_torch.models.base import SpecModel
        from distriflow_tpu_torch.utils.config import CompileConfig

        log = self

        class Logged(SpecModel):
            def fit(self, x, y):
                grads = super().fit(x, y)
                with log._lock:
                    log.losses.append(self.last_loss)
                return grads

        return Logged(spec, CompileConfig(optimizer="momentum"), learning_rate=WIRE_LR, **kw)


def _wire_model(tree, device, loss="fused_softmax_cross_entropy"):
    """The server's (or the replay's) model: ``cifar_convnet`` in bf16 with
    the fused dense CE (or ``loss``) and f32 masters from the seeded flax
    tree, momentum at ``WIRE_LR``."""
    from distriflow_tpu_torch.models.base import SpecModel
    from distriflow_tpu_torch.models.convert import zoo_params_from_jax
    from distriflow_tpu_torch.utils.config import CompileConfig

    return SpecModel(_convnet_spec(device, loss), CompileConfig(optimizer="momentum"),
                     learning_rate=WIRE_LR, params=zoo_params_from_jax(tree))


def _phase_stats(telemetry):
    """p50, max and sum (ms) of every phase the server's and the clients'
    profilers timed."""
    out = {}
    for role in ("client", "server"):
        for phase, d in telemetry.profiler(role).digests().items():
            out[f"{role}_{phase}"] = {"p50_ms": d.get("p50"), "max_ms": d.get("max"),
                                      "sum_ms": d.get("sum"), "n": d.get("count")}
    return out


def _wait_for(cond, what, timeout=WIRE_TIMEOUT_S):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise TimeoutError(f"wire_training: {what} did not happen in {timeout} s")
        time.sleep(0.005)


def _async_leg(tree, x, y, device, workers, epochs, delta_broadcast, save_dir, snapshot_at=()):
    """Port ``AsynchronousSGDServer`` over ``epochs`` epochs of ``x, y`` in
    batches of ``WIRE_B``, with ``workers`` port ``AsynchronousSGDClient``
    threads on ``device``. Returns ``(report, server model, dispatch order,
    fits, {n: a copy of the server's params after n applied updates} for
    each n of ``snapshot_at``)``."""
    from distriflow_tpu_torch.utils.serialization import copy_tree
    from distriflow_tpu_torch.client import AsynchronousSGDClient, DistributedClientConfig
    from distriflow_tpu_torch.data.dataset import DistributedDataset
    from distriflow_tpu_torch.obs.telemetry import Telemetry
    from distriflow_tpu_torch.server import (AsynchronousSGDServer, DistributedServerConfig,
                                             DistributedServerInMemoryModel)

    tel, fits = Telemetry(), _Fits()
    server_model = _wire_model(tree, device)
    dataset = DistributedDataset(x, y, {"batch_size": WIRE_B, "epochs": epochs})
    batches = dataset.num_batches * epochs
    server = AsynchronousSGDServer(
        DistributedServerInMemoryModel(server_model), dataset,
        DistributedServerConfig(
            server_hyperparams={"maximum_staleness": WIRE_STALENESS,
                                "delta_broadcast": delta_broadcast},
            client_hyperparams={"batch_size": WIRE_B, "learning_rate": WIRE_LR},
            save_dir=save_dir, telemetry=tel))
    order, snaps = [], {}
    server.on_upload(lambda msg: order.append(msg.batch))
    # fired on the apply thread after each apply, before the next one
    server.on_new_version(
        lambda _: snaps.__setitem__(server.applied_updates, copy_tree(server.model.get_params()))
        if server.applied_updates in snapshot_at else None)
    server.setup()
    clients = [AsynchronousSGDClient(server.address, fits.model(_convnet_spec(device)),
                                     DistributedClientConfig(telemetry=tel, upload_timeout_s=120))
               for _ in range(workers)]
    done, errors = [0] * workers, []

    def work(i):
        try:
            clients[i].setup(timeout=60)
            done[i] = clients[i].train_until_complete(timeout=WIRE_TIMEOUT_S)
        except BaseException as e:  # noqa: BLE001 - relayed to the main thread
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=work, args=(i,), name=f"wire-worker-{i}")
               for i in range(workers)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(WIRE_TIMEOUT_S + 60)
        assert not errors, errors
        assert not any(t.is_alive() for t in threads), "a wire worker did not finish"
        _wait_for(lambda: server.applied_updates + server.rejected_updates
                  + server.suppressed_uploads >= batches, "the server's last apply")
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for c in clients:
            c.dispose()
        server.stop()
    window = server._h_staleness.export_state().get("window") or []
    report = {
        "workers": workers, "batches": batches, "batch": WIRE_B, "epochs": epochs,
        "delta_broadcast": delta_broadcast, "wall_s": wall,
        "fits_by_worker": done, "applied": server.applied_updates,
        "rejected": server.rejected_updates, "suppressed": server.suppressed_uploads,
        "staleness_histogram": {str(int(k)): int(v) for k, v in
                                sorted(collections.Counter(window).items())},
        "updates_per_s": server.applied_updates / wall,
        "samples_per_s": server.applied_updates * WIRE_B / wall,
        "phases": _phase_stats(tel),
        "wire_bytes": {"up": tel.counter_value("comm_up_bytes_total", role="server"),
                       "down": tel.counter_value("comm_down_bytes_total", role="server")}}
    assert server.applied_updates + server.rejected_updates + server.suppressed_uploads \
        == batches, report
    assert dataset.exhausted, report
    return report, server_model, order, fits, snaps


def _federated_leg(tree, x, y, device, save_dir):
    """Port ``FederatedServer`` (``min_updates_per_version`` 2) and two port
    ``FederatedClient``s with ``FED_LOCAL`` local images each, one uploading
    int8 with error feedback; ``FED_ROUNDS`` rounds, each waiting until both
    workers installed the new version. Returns ``(report, server model,
    fits)``."""
    from distriflow_tpu_torch.client import DistributedClientConfig, FederatedClient
    from distriflow_tpu_torch.obs.telemetry import Telemetry
    from distriflow_tpu_torch.server import (DistributedServerConfig,
                                             DistributedServerInMemoryModel, FederatedServer)

    tel, fits = Telemetry(), _Fits()
    server_model = _wire_model(tree, device)
    server = FederatedServer(
        DistributedServerInMemoryModel(server_model),
        DistributedServerConfig(
            server_hyperparams={"min_updates_per_version": 2},
            client_hyperparams={"examples_per_update": WIRE_B, "batch_size": WIRE_B,
                                "learning_rate": WIRE_LR},
            save_dir=save_dir, telemetry=tel))
    versions = []
    server.on_new_version(versions.append)
    server.setup()
    comp = ("none", "int8")
    clients = [FederatedClient(server.address, fits.model(_convnet_spec(device)),
                               DistributedClientConfig(
                                   hyperparams={"gradient_compression": c}, telemetry=tel,
                                   upload_timeout_s=120))
               for c in comp]
    local = [(x[i * FED_LOCAL:(i + 1) * FED_LOCAL], y[i * FED_LOCAL:(i + 1) * FED_LOCAL])
             for i in range(len(clients))]
    t0 = time.perf_counter()
    round_ms = []
    try:
        for c in clients:
            c.setup(timeout=60)
        for r in range(FED_ROUNDS):
            tr = time.perf_counter()
            errors = []

            def upload(i):
                try:
                    lx, ly = local[i]
                    sl = slice(r * WIRE_B, (r + 1) * WIRE_B)
                    assert clients[i].distributed_update(lx[sl], ly[sl]) == 1
                except BaseException as e:  # noqa: BLE001 - relayed to the main thread
                    errors.append(e)

            threads = [threading.Thread(target=upload, args=(i,)) for i in range(len(clients))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(WIRE_TIMEOUT_S)
            assert not errors, errors
            _wait_for(lambda: len(versions) == r + 1 and all(
                c.msg.model.version == server.model.version for c in clients),
                f"round {r}'s install on both workers")
            round_ms.append((time.perf_counter() - tr) * 1e3)
        wall = time.perf_counter() - t0
    finally:
        for c in clients:
            c.dispose()
        server.stop()
    report = {
        "workers": len(clients), "compression": list(comp), "rounds": FED_ROUNDS,
        "examples_per_update": WIRE_B, "min_updates_per_version": 2,
        "versions": len(versions), "dropped": server.dropped_uploads,
        "uploads": server.num_updates, "wall_s": wall, "round_ms": round_ms,
        "phases": _phase_stats(tel),
        "wire_bytes": {"up": tel.counter_value("comm_up_bytes_total", role="server"),
                       "down": tel.counter_value("comm_down_bytes_total", role="server")}}
    assert len(versions) == FED_ROUNDS and server.dropped_uploads == 0, report
    assert server.num_updates == 2 * FED_ROUNDS, report
    return report, server_model, fits


def _replay(tree, x, y, order, device, stale=0, loss="fused_softmax_cross_entropy",
            each=None):
    """One port model on ``device`` taking an ``update`` on each batch of
    ``order`` without the wire, each gradient taken at its weights of
    ``stale`` updates before (at 0 by a ``fit`` of the model itself); the
    model and each fit's loss. ``each(model)`` runs after every update."""
    from distriflow_tpu_torch.utils.serialization import copy_tree

    model, losses = _wire_model(tree, device, loss), []
    worker = _wire_model(tree, device, loss) if stale else model
    history = [copy_tree(model.get_params())]
    for b in order:
        if stale:
            worker.set_params(history[0])
        grads = worker.fit(x[b * WIRE_B:(b + 1) * WIRE_B], y[b * WIRE_B:(b + 1) * WIRE_B])
        losses.append(worker.last_loss)
        model.update(grads)
        if each is not None:
            each(model)
        if stale:
            history = (history + [copy_tree(model.get_params())])[-(stale + 1):]
    return model, losses


def _val_spread(model, vx, vy, parts=4):
    """``model``'s validation loss on the whole set and the spread (max -
    min) of its losses on ``parts`` disjoint slices of it."""
    n = len(vx) // parts
    losses = [model.evaluate(vx[i * n:(i + 1) * n], vy[i * n:(i + 1) * n])[0]
              for i in range(parts)]
    return model.evaluate(vx, vy)[0], max(losses) - min(losses)


def _same_bits(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


def _wire_phase(tree, counted, device="cuda"):
    """The wire-training planes on the card, each leg in its own launch
    window: async SGD with 2 workers, async SGD with 1 worker and full
    broadcasts held bit for bit against an in-process replay (and the
    replay in reversed order, which must differ), and gradient averaging
    with one int8 worker. Returns ``(report, counts by window)``."""
    import tempfile

    from distriflow_tpu_torch import native

    assert native.ensure_built() and native.AVAILABLE, "the native host kernels did not build"
    train, val = _synthetic_cifar10(WIRE_TRAIN, CN_VAL, SEED + 11)
    (x, y), (vx, vy) = _to_xy(train), _to_xy(val)
    with tempfile.TemporaryDirectory(prefix="wire-") as save_dir:
        return _wire_legs(tree, counted, device, x, y, vx, vy, save_dir)


def _epoch1_held(init_val, spread, vals):
    """The async wire leg's loss check: the lowest validation loss of the
    server's versions over the first epoch's second half (``vals``, by
    version), which must lie below the initial weights' by more than the
    spread of their loss over four slices, as the in-process leg (b) holds
    its own. No single version is held: two workers' gradients arrive in
    an order the host's timing picks, and the validation loss jumps within
    the epoch on some orders (one H100 run read 2.9086 at version 16
    against 2.3362 at the start). A server that applies nothing keeps the
    initial weights at every version and fails. Returns the lowest loss."""
    held = min(vals.values())
    assert init_val - held > spread, \
        f"async wire training did not lower the validation loss in versions {min(vals)}-" \
        f"{max(vals)}: {init_val} -> {vals}, spread {spread}"
    return held


def _wire_legs(tree, counted, device, x, y, vx, vy, save_dir):
    from distriflow_tpu_torch import native

    batches = WIRE_TRAIN // WIRE_B * WIRE_EPOCHS
    epoch = WIRE_TRAIN // WIRE_B
    late = range(epoch // 2 + 1, epoch + 1)  # versions 9 ... 16 of the first epoch
    (a_report, a_model, a_order, a_fits, a_snaps), a_counts = counted(lambda: _async_leg(
        tree, x, y, device, WIRE_WORKERS, WIRE_EPOCHS, True, save_dir, snapshot_at=late))
    val_loss, val_acc = a_model.evaluate(vx, vy)[:2]
    del a_model
    # the no-update control: the initial weights, which a server that
    # applied nothing would end with; the spread of their validation loss
    # over four slices of the set is the margin training must clear
    probe = _wire_model(tree, device)
    init_val, spread = _val_spread(probe, vx, vy)
    epoch_vals = {}
    for version, params in sorted(a_snaps.items()):
        probe.set_params(params)
        epoch_vals[version] = probe.evaluate(vx, vy)[0]
    del probe, a_snaps
    assert sorted(epoch_vals) == list(late), sorted(epoch_vals)
    # the same batches in the same order without the wire, at staleness 0
    # and at the leg's staleness 1: does the second epoch's climb need the
    # wire, or staleness? (reported, not asserted)
    replays = {}
    for stale in (0, 1):
        r_model, r_losses = _replay(tree, x, y, a_order, device, stale)
        replays[f"staleness{stale}"] = {"losses": r_losses,
                                        "val_loss": r_model.evaluate(vx, vy)[0]}
        del r_model
    losses = a_fits.losses
    a_report.update(order=a_order, losses=losses, fits=len(losses), val_loss=val_loss,
                    val_accuracy=val_acc,
                    init_val_loss=init_val, init_val_spread=spread,
                    epoch1_val_loss=epoch_vals[epoch], val_by_version=epoch_vals,
                    held_from_version=late[0], replays=replays)
    assert all(math.isfinite(v) for v in losses), losses
    a_report["held_lowest_val_loss"] = _epoch1_held(init_val, spread, epoch_vals)
    assert math.isfinite(val_loss) and 0.0 <= val_acc <= 1.0, (val_loss, val_acc)
    # bitwise replay: needs a deterministic ConvNet backward (cuDNN's
    # default weight-gradient algorithms may add with atomics)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        n = WIRE_SINGLE_BATCHES * WIRE_B
        (s_report, s_model, order, s_fits, _), s_counts = counted(lambda: _async_leg(
            tree, x[:n], y[:n], device, 1, 1, False, save_dir))
        got = s_model.get_params()
        replay = _replay(tree, x, y, order, device)[0].get_params()
        reversed_replay = _replay(tree, x, y, order[::-1], device)[0].get_params()
    finally:
        torch.backends.cudnn.deterministic = det
    assert sorted(order) == list(range(WIRE_SINGLE_BATCHES)), order
    s_report.update(order=order, bitwise_vs_replay=_same_bits(got, replay),
                    reversed_control_rejected=not _same_bits(got, reversed_replay),
                    max_abs_diff_vs_reversed=max(float((got[k] - reversed_replay[k]).abs().max())
                                                 for k in got),
                    fits=len(s_fits.losses), cudnn_deterministic=True)
    assert s_report["bitwise_vs_replay"], "the single-worker wire run differs from its replay"
    assert s_report["reversed_control_rejected"], "the reversed replay was not told apart"
    del s_model, replay, reversed_replay
    (f_report, f_model, f_fits), f_counts = counted(lambda: _federated_leg(
        tree, x, y, device, save_dir))
    f_first, f_last = float(np.mean(f_fits.losses[:2])), float(np.mean(f_fits.losses[-2:]))
    f_report.update(first_round_loss=f_first, last_round_loss=f_last, fits=len(f_fits.losses),
                    native_available=native.AVAILABLE)
    assert all(math.isfinite(v) for v in f_fits.losses), f_fits.losses
    assert f_last < f_first, f"averaging loss did not fall: round 1 {f_first}, round 4 {f_last}"
    counts = {"wire_async": a_counts, "wire_single": s_counts, "wire_federated": f_counts}
    for window, fit_count in (("wire_async", len(a_fits.losses)),
                              ("wire_single", len(s_fits.losses)),
                              ("wire_federated", len(f_fits.losses))):
        for k in ("fused_ce_dense_fwd", "fused_ce_dense_bwd"):
            if device == "cuda":
                assert counts[window][k] == fit_count, \
                    f"{window} launched {k} {counts[window][k]} times for {fit_count} fits"
    assert len(a_fits.losses) == batches and len(s_fits.losses) == WIRE_SINGLE_BATCHES
    assert len(f_fits.losses) == 2 * FED_ROUNDS
    report = {"config": {"model": "cifar_convnet", "dtype": "bfloat16", "masters": "f32",
                         "loss": "fused_softmax_cross_entropy", "targets": "one-hot f32",
                         "optimizer": "momentum", "lr": WIRE_LR, "batch": WIRE_B,
                         "maximum_staleness": WIRE_STALENESS, "transport": "loopback TCP"},
              "async": a_report, "single": s_report, "federated": f_report}
    return report, counts


@contextlib.contextmanager
def _fresh_telemetry():
    """A new process telemetry for one leg (its profiler digests and
    histograms hold that leg alone); the old one is put back after."""
    from distriflow_tpu_torch.obs.telemetry import Telemetry, set_telemetry

    tel = Telemetry()
    prev = set_telemetry(tel)
    try:
        yield tel
    finally:
        set_telemetry(prev)


def _staleness_histogram(tel):
    h = tel.registry.histogram("train_gradient_staleness", mode="async")
    window = h.export_state().get("window") or []
    return {str(int(k)): int(v) for k, v in sorted(collections.Counter(window).items())}


def _async_trainer(tree, x, y, device, **kw):
    """A port ``AsyncSGDTrainer`` on ``x, y`` (one epoch, batches of
    ``IP_B``) for the ConvNet from the seeded flax tree."""
    from distriflow_tpu_torch.data.dataset import DistributedDataset
    from distriflow_tpu_torch.models.convert import zoo_params_from_jax
    from distriflow_tpu_torch.train.async_sgd import AsyncSGDTrainer

    dataset = kw.pop("dataset", None) or DistributedDataset(x, y, {"batch_size": IP_B, "epochs": 1})
    trainer = AsyncSGDTrainer(_convnet_spec(device), dataset, **kw)
    trainer.init(SEED)
    trainer.set_params(zoo_params_from_jax(tree))
    return trainer


def _async_report(trainer, tel, wall, batches, uploads, counters):
    """Rates, phases (with their sum beside the wall), the staleness
    histogram and the per-batch MFU of a timed ``train``."""
    phase_sum = sum(trainer.phase_ms.values())
    report = {
        "counters": counters, "wall_s": wall, "batches": batches, "uploads": uploads,
        "samples_per_s": batches * IP_B / wall, "updates_per_s": uploads / wall,
        "phase_ms": dict(trainer.phase_ms), "phase_sum_ms": phase_sum,
        "phase_sum_over_wall": phase_sum / (wall * 1e3),
        "staleness_histogram": _staleness_histogram(tel),
        "profiler": {k: {"p50_ms": d.get("p50"), "sum_ms": d.get("sum"), "n": d.get("count")}
                     for k, d in tel.profiler("trainer").digests().items()}}
    if trainer.devices[0].type == "cuda":
        report["mfu_per_batch"] = trainer.mfu(IP_B, wall / batches)
        report["cost_per_batch"] = _cost_fields(trainer.cost_analysis(IP_B))
    return report


def _cost_fields(cost):
    return {k: cost[k] for k in ("flops", "aten_flops", "kernel_flops", "kernel_hw_flops",
                                 "kernel_tally_added")}


def _val_gain(trainer, init_val, spread, vx, vy, what):
    """The validation loss of ``trainer``'s weights, held below the initial
    weights' by more than the spread of their loss over four slices."""
    val = trainer.evaluate(vx, vy)
    assert init_val - val[0] > spread, \
        f"{what}: the validation loss did not fall: {init_val} -> {val[0]}, spread {spread}"
    return {"init_val_loss": init_val, "init_val_spread": spread, "val_loss": val[0],
            "val_accuracy": val[1]}


def _init_val(tree, device, vx, vy):
    probe = _wire_model(tree, device)
    out = _val_spread(probe, vx, vy)
    del probe
    return out


def _async_bench_leg(tree, counted, device):
    """(a) ``bench_cifar_async``'s configuration: 2K warm batches through
    ``worker_loop(0)`` (the second group profiled), then the timed
    ``train(4)``; the launch window holds all 96 batches."""
    train, val = _synthetic_cifar10(IP_BATCHES * IP_B, CN_VAL, SEED + 12)
    (x, y), (vx, vy) = _to_xy(train), _to_xy(val)
    init_val, spread = _init_val(tree, device, vx, vy)
    with _fresh_telemetry() as tel:
        trainer = _async_trainer(
            tree, x, y, device, learning_rate=IP_LR, steps_per_upload=IP_K,
            hyperparams={"maximum_staleness": IP_STALENESS, "staleness_decay": IP_DECAY},
            stage_dataset=True, inflight_window=IP_WINDOW)
        trainer.pre_stage(trainer.devices[0])

        def run():
            trainer.worker_loop(0, max_steps=IP_K)
            second = lambda: trainer.worker_loop(0, max_steps=IP_K)  # noqa: E731
            profile = _profiled(second) if device == "cuda" else second() and None
            warm = trainer.applied_updates + trainer.rejected_updates
            for k in trainer.phase_ms:
                trainer.phase_ms[k] = 0.0
            t0 = time.perf_counter()
            counters = trainer.train(num_workers=IP_WORKERS)
            return profile, warm, counters, time.perf_counter() - t0

        (profile, warm, counters, wall), counts = counted(run)
        report = _async_report(trainer, tel, wall, IP_BATCHES - 2 * IP_K,
                               counters["applied"] + counters["rejected"] - warm, counters)
    assert trainer.dataset.exhausted and not trainer.dataset.incomplete_batches, report
    assert counters["rejected"] == 0, report
    report.update(_val_gain(trainer, init_val, spread, vx, vy, "bench_cifar_async"),
                  warm_uploads=warm, one_upload_profile=profile,
                  config={"batch": IP_B, "steps_per_upload": IP_K, "batches": IP_BATCHES,
                          "workers": IP_WORKERS, "maximum_staleness": IP_STALENESS,
                          "staleness_decay": IP_DECAY, "optimizer": "sgd", "lr": IP_LR,
                          "stage_dataset": True, "inflight_window": IP_WINDOW})
    return report, counts, IP_BATCHES


def _schedule_replay(tree, x, y, schedule, device):
    """The apply sequence of an async run replayed without the trainer: for
    each apply, in order, one model's ``fit`` of its batch at the weights
    of the version its gradient was taken at, then ``update`` (decay 1.0).
    Returns the final params."""
    from distriflow_tpu_torch.utils.serialization import copy_tree

    model, worker = _wire_model(tree, device), _wire_model(tree, device)
    history = [copy_tree(model.get_params())]
    for batch, version in schedule:
        worker.set_params(history[version])
        model.update(worker.fit(x[batch * IP_B:(batch + 1) * IP_B],
                                y[batch * IP_B:(batch + 1) * IP_B]))
        history.append(copy_tree(model.get_params()))
    return model.get_params()


def _async_cli_leg(tree, counted, device, x, y, vx, vy):
    """(b) ``train.py --mode async``'s defaults, one epoch. Each apply's
    batch and gradient version are recorded, and the final params must
    equal a replay of that schedule bit for bit (cuDNN deterministic).

    The loss is held in the form of the wire leg's epoch-1 check, over the
    epoch's second half: the lowest validation loss of the snapshots after
    more than half the applies must lie below the initial weights' by more
    than the spread of their loss over four slices, and so must that of a
    staleness-0 replay of the same order (the sequential reference, which
    must pass the check it sets). No single version is held: at this
    learning rate and momentum the validation loss of the sequential
    reference itself jumps within the epoch (on the second dataset, on an
    H100 80GB HBM3 at 700 W: 0.925 at 7 applies, 3.008 at 9, against 2.289
    at the start, and 0.005 at 16), and the run's at the epoch's end
    (3.879 against 2.336 on the same card). Every version's loss is
    reported for both, beside the same replay through the plain CE and
    one on the second dataset."""
    init_val, spread = _init_val(tree, device, vx, vy)
    schedule, local, versions = [], threading.local(), []
    with _fresh_telemetry() as tel:
        trainer = _async_trainer(tree, x, y, device, learning_rate=WIRE_LR,
                                 optimizer="momentum",
                                 hyperparams={"maximum_staleness": WIRE_STALENESS})
        # every version's params dict: never written after its apply
        trainer.callbacks.register("new_version", lambda v: versions.append(
            trainer.snapshot()[0]))
        fit, submit = trainer._host_fit, trainer.submit

        def logged_fit(model, group):  # the worker thread's group, for its submit
            local.batches = [b.batch for b, _, _ in group]
            return fit(model, group)

        def logged_submit(grads, version, client_id="?"):
            # FIFO tickets serialize submits: this list is the apply order
            schedule.extend((b, version) for b in local.batches)
            return submit(grads, version, client_id=client_id)

        trainer._host_fit, trainer.submit = logged_fit, logged_submit

        def run():
            t0 = time.perf_counter()
            counters = trainer.train(num_workers=WIRE_WORKERS)
            return counters, time.perf_counter() - t0

        (counters, wall), counts = counted(run)
        batches = len(x) // IP_B
        report = _async_report(trainer, tel, wall, batches, batches, counters)
    assert trainer.dataset.exhausted and not trainer.dataset.incomplete_batches, report
    assert counters["applied"] == batches and counters["rejected"] == 0, report
    got = trainer.snapshot()[0]
    replay = _schedule_replay(tree, x, y, schedule, device)
    order = [b for b, _ in schedule]
    sequential = {}
    for loss in ("fused_softmax_cross_entropy", "softmax_cross_entropy"):
        path = []
        _, fits = _replay(tree, x, y, order, device, loss=loss,
                          each=lambda m: path.append(m.evaluate(vx, vy)[0]))
        sequential[loss] = {"val_by_version": path, "fit_losses": fits}
    train2, val2 = _synthetic_cifar10(WIRE_TRAIN, CN_VAL, SEED + IP_SECOND_DATA)
    (x2, y2), (vx2, vy2) = _to_xy(train2), _to_xy(val2)
    init2, spread2 = _init_val(tree, device, vx2, vy2)
    path2 = []
    _, fits2 = _replay(tree, x2, y2, list(range(batches)), device,
                       each=lambda m: path2.append(m.evaluate(vx2, vy2)[0]))
    val = trainer.evaluate(vx, vy)
    probe, async_path = _wire_model(tree, device), []
    for params in versions:
        probe.set_params(params)
        async_path.append(probe.evaluate(vx, vy)[0])
    del probe
    late = batches // 2  # versions late + 1 ... batches
    held = {"async": min(async_path[late:]),
            "staleness0_replay": min(sequential["fused_softmax_cross_entropy"][
                "val_by_version"][late:])}
    report.update(schedule=schedule, bitwise_vs_schedule_replay=_same_bits(got, replay),
                  init_val_loss=init_val, init_val_spread=spread, val_loss=val[0],
                  val_accuracy=val[1], val_by_version=async_path,
                  held_from_version=late + 1, held_lowest_val_loss=held,
                  staleness0_replay=sequential,
                  second_dataset_staleness0_replay={
                      "seed": SEED + IP_SECOND_DATA, "init_val_loss": init2,
                      "init_val_spread": spread2, "val_by_version": path2, "fit_losses": fits2},
                  config={"batch": IP_B, "steps_per_upload": 1, "workers": WIRE_WORKERS,
                          "maximum_staleness": WIRE_STALENESS, "optimizer": "momentum",
                          "lr": WIRE_LR, "epochs": 1, "cudnn_deterministic": True})
    assert sorted(b for b, _ in schedule) == list(range(batches)), schedule
    assert report["bitwise_vs_schedule_replay"], "the async run differs from its schedule replay"
    assert len(versions) == batches, len(versions)
    for what, v in held.items():
        assert init_val - v > spread, (
            f"CLI defaults: {what}'s lowest validation loss after {late} applies did not "
            f"fall: {init_val} -> {v}, spread {spread}")
    return report, counts, batches


def _async_single_leg(tree, counted, device, x, y):
    """(c) One worker, K 1: the final params against a ``SpecModel`` replay
    in the dataset's dispatch order, bit for bit (and the reversed order,
    which must differ); a snapshot taken mid-run keeps its values."""
    from distriflow_tpu_torch.data.dataset import DistributedDataset

    order = []

    class Logged(DistributedDataset):
        def complete_batch(self, index):
            order.append(index)
            return super().complete_batch(index)

    n = WIRE_SINGLE_BATCHES * IP_B
    trainer = _async_trainer(tree, None, None, device, learning_rate=WIRE_LR,
                             optimizer="momentum",
                             hyperparams={"maximum_staleness": WIRE_STALENESS},
                             dataset=Logged(x[:n], y[:n], {"batch_size": IP_B, "epochs": 1}))
    mid = []
    trainer.callbacks.register("new_version", lambda v: mid.append(
        (trainer.params, {k: t.clone() for k, t in trainer.params.items()}))
        if int(v) == WIRE_SINGLE_BATCHES // 2 else None)
    counters, counts = counted(lambda: trainer.train(num_workers=1))
    got = trainer.snapshot()[0]
    replay = _replay(tree, x, y, order, device)[0].get_params()
    reversed_replay = _replay(tree, x, y, order[::-1], device)[0].get_params()
    (held, copy), = mid
    report = {"counters": counters, "order": order,
              "bitwise_vs_replay": _same_bits(got, replay),
              "reversed_control_rejected": not _same_bits(got, reversed_replay),
              "max_abs_diff_vs_reversed": max(float((got[k] - reversed_replay[k]).abs().max())
                                              for k in got),
              "mid_run_snapshot_kept": _same_bits(held, copy),
              "mid_run_snapshot_differs_from_final": not _same_bits(held, got)}
    assert sorted(order) == list(range(WIRE_SINGLE_BATCHES)), order
    assert report["bitwise_vs_replay"], "the one-worker trainer differs from its replay"
    assert report["reversed_control_rejected"], "the reversed replay was not told apart"
    assert report["mid_run_snapshot_kept"], "a snapshot changed after later applies"
    assert report["mid_run_snapshot_differs_from_final"], report
    return report, counts, WIRE_SINGLE_BATCHES


def _fedavg_leg(tree, counted, device, x, y, workers):
    """(d) ``bench_fedavg``'s configuration at ``workers`` workers,
    ``FA_ROUNDS`` rounds; with more than one worker the first round is held
    bit for bit against the fixed-order mean of solo ``SpecModel`` runs
    from the same weights. One more round is profiled outside the window."""
    from distriflow_tpu_torch.models.base import SpecModel
    from distriflow_tpu_torch.models.convert import zoo_params_from_jax
    from distriflow_tpu_torch.train.federated import FederatedAveragingTrainer

    with _fresh_telemetry():
        trainer = FederatedAveragingTrainer(_convnet_spec(device), local_steps=FA_K,
                                            local_batch_size=FA_B, learning_rate=FA_LR,
                                            num_workers=workers)
        trainer.init(SEED)
        trainer.set_params(zoo_params_from_jax(tree))
        start = {k: t.detach().clone() for k, t in trainer.params.items()}
        rng = np.random.RandomState(SEED + 13)
        rounds = [trainer.pack_round_data(x, y, rng) for _ in range(FA_ROUNDS + 1)]

        def run():
            out = []
            for xs, ys in rounds[:FA_ROUNDS]:
                t0 = time.perf_counter()
                loss = trainer.round(xs, ys)
                out.append((loss, (time.perf_counter() - t0) * 1e3))
                if len(out) == 1:
                    first = {k: t.detach().clone() for k, t in trainer.params.items()}
            return out, first

        (out, first), counts = counted(run)
        profile = _profiled(lambda: trainer.round(*rounds[-1])) if device == "cuda" else None
    losses, round_ms = [o[0] for o in out], [o[1] for o in out]
    report = {"workers": workers, "local_steps": FA_K, "batch": FA_B, "rounds": FA_ROUNDS,
              "round_losses": losses, "round_ms": round_ms,
              "samples_per_s": workers * FA_K * FA_B / (float(np.median(round_ms)) / 1e3),
              "one_round_profile": profile}
    assert all(math.isfinite(v) for v in losses), losses
    assert losses[-1] < losses[0], f"FedAvg W{workers}: the round loss did not fall: {losses}"
    if workers > 1:
        xs, ys = rounds[0]
        acc = None
        for w in range(workers):
            solo = SpecModel(_convnet_spec(device), learning_rate=FA_LR, params=start)
            for k in range(FA_K):
                solo.update(solo.fit(xs[w, k], ys[w, k]))
            p = solo.get_params()
            acc = p if acc is None else {k: acc[k] + p[k] for k in acc}
            del solo
        report["round1_bitwise_vs_solo_mean"] = _same_bits(
            first, {k: v / workers for k, v in acc.items()})
        assert report["round1_bitwise_vs_solo_mean"], \
            f"FedAvg W{workers}'s round differs from the fixed-order mean of its solo runs"
    return report, counts, workers * FA_K * FA_ROUNDS


def _inprocess_phase(tree, counted, device="cuda"):
    """The in-process trainers, each leg in its own launch window in which
    every batch (every local step) launches kernels 9d and 10d exactly once
    and nothing else runs. Returns ``(report, counts by window)``."""
    train, val = _synthetic_cifar10(WIRE_TRAIN, CN_VAL, SEED + 11)
    (x, y), (vx, vy) = _to_xy(train), _to_xy(val)
    report, counts = {}, {}
    report["ip_async_bench"], counts["ip_async_bench"], fits = _async_bench_leg(
        tree, counted, device)
    report["ip_async_bench"]["fits"] = fits
    # bitwise legs: a deterministic ConvNet backward (cuDNN's default
    # weight-gradient algorithms may add with atomics)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for window, leg in (("ip_async_cli", lambda: _async_cli_leg(
                                tree, counted, device, x, y, vx, vy)),
                            ("ip_single", lambda: _async_single_leg(
                                tree, counted, device, x, y))):
            report[window], counts[window], fits = leg()
            report[window]["fits"] = fits
        for w in FA_WORKERS:
            window = f"ip_fedavg_w{w}"
            report[window], counts[window], fits = _fedavg_leg(tree, counted, device, x, y, w)
            report[window]["fits"] = fits
    finally:
        torch.backends.cudnn.deterministic = det
    if device == "cuda":
        for window, r in report.items():
            for k in ("fused_ce_dense_fwd", "fused_ce_dense_bwd"):
                assert counts[window][k] == r["fits"], \
                    f"{window} launched {k} {counts[window][k]} times for {r['fits']} fits"
    report["config"] = {"model": "cifar_convnet", "dtype": "bfloat16", "masters": "f32",
                        "loss": "fused_softmax_cross_entropy", "targets": "one-hot f32"}
    return report, counts


def _cost_check(trainer, batch, step_ms, kernel_flops, kernel_hw_flops):
    """``cost_analysis`` and ``mfu`` of one sync step at its measured p50:
    the tally added once, and equal to the path's analytic kernel cost."""
    cost = trainer.cost_analysis(batch)
    out = {**_cost_fields(cost), "kernel_by_category": cost["kernel_by_category"],
           "step_ms_p50": step_ms, "mfu": trainer.mfu(batch, step_ms / 1e3),
           "expected_kernel_flops": kernel_flops, "expected_kernel_hw_flops": kernel_hw_flops}
    assert cost["kernel_tally_added"] and cost["flops"] == cost["aten_flops"] + cost["kernel_flops"]
    assert cost["kernel_flops"] == kernel_flops and cost["kernel_hw_flops"] == kernel_hw_flops, out
    assert math.isfinite(out["mfu"]) and out["mfu"] > 0, out
    return out


def _cost_phase(cn_trainer, cn_batch, cn_report, lt_trainer, lt_cfg, lt_batch, lt_report):
    """(e) ``cost_analysis`` and ``mfu`` of the ConvNet's B 2048 step (the
    dense CE, forward and backward once) and of the 16k remat LM's step
    (per layer one flash forward, its recompute in ``hw_flops`` only, one
    two-kernel backward; the sparse CE once), at their measured p50."""
    n, v = CN_B, 10
    ce_dense = 8 * n * v  # 5 NV forward + 3 NV backward
    b, s = lt_batch[0].shape
    h, d, vocab = lt_cfg.n_heads, lt_cfg.head_dim, lt_cfg.vocab_size
    unit = 2 * b * h * s * s * d // 2  # one causal matmul of attention
    ce_sparse = 8 * b * s * vocab
    layers = lt_cfg.n_layers
    return {
        "convnet": _cost_check(cn_trainer, cn_batch, cn_report["step_ms_p50"], ce_dense, ce_dense),
        "long_lm": _cost_check(lt_trainer, lt_batch, lt_report["step_ms_p50"],
                               layers * (2 * unit + 4 * unit) + ce_sparse,
                               layers * (2 * 2 * unit + 7 * unit) + ce_sparse)}


def _rejected(name, wrong, want, atol=None):
    """The share of ``wrong``'s elements outside ``name``'s limit around
    ``want`` (its atol replaced by ``atol``, a number or a tensor, where
    given)."""
    atol, rtol = (TOL[name][0] if atol is None else atol), TOL[name][1]
    wrong, want = wrong.float(), want.float()
    return float(((wrong - want).abs() > atol + rtol * want.abs()).float().mean())


# (S, causal) of the backward kernels' ragged checks: lengths that end
# inside a tile, on both causal branches
RAGGED_BWD = ((37, True), (37, False), (1000, True), (1000, False))
# The D 32 two-kernel rows hold those lengths at the fused row's limit.
# At S 37 non-causal, with K and V drawn around 1, a rounding flip of P or
# of a large dS (dP - delta reaches ~10 there) moves one dK or dV element
# by up to 2 bf16 steps: over 60 seeds of B1 H8 on the H100 the largest
# atol any element needed above rtol 2**-7 was 1.5e-3 at D 32 and 2.0e-3
# at D 64 (one seed in 60 each past 1e-3; the kernel's value the nearer
# to the unrounded f64 recipe), against at most 4.7e-4 causal and at S
# 1000. The path's shape keeps atol 1e-3.
RAGGED_TOL = (5e-3, 2 ** -7)


def _atol_needed(name, pairs):
    """The least atol that the elements of every (kernel, plain) pair need
    above ``name``'s rtol."""
    rtol = TOL[name][1]
    return max(float(((a.float() - w.float()).abs() - rtol * w.float().abs()).max())
               for a, w in pairs)


def _bwd_inputs(g, b, h, s, causal, d=64, dtype=torch.bfloat16):
    """The backward kernels' arguments ``(q, k, v, dO, lse, delta, causal)``
    at [b, h, s, d] in ``dtype`` from one forward, K and V drawn around 1
    (see :func:`_split_bwd_rows`)."""
    from distriflow_tpu_torch.ops import flash_attention as fa

    q, k, v, do = ((torch.randn(b, h, s, d, generator=g, device="cuda") + mean)
                   .to(dtype) for mean in (0.0, 1.0, 1.0, 0.0))
    o, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    return q, k, v, do, lse, (do.float() * o.float()).sum(-1), causal


def _ragged_bwd(name, fn, plain, g, b, h, d=64, dtype=torch.bfloat16, limit=None):
    """The max abs error of ``fn`` (a tuple of gradients) against ``plain``
    at each (S, causal) of :data:`RAGGED_BWD` (head dim ``d``, ``dtype``);
    raises outside ``name``'s limit (or ``limit``, an (atol, rtol))."""
    out = {}
    for s, causal in RAGGED_BWD:
        args = _bwd_inputs(g, b, h, s, causal, d, dtype)
        tag = f"S={s} {'causal' if causal else 'non-causal'}"
        out[tag] = max(_over(f"{name} {tag}", a, w, *(limit or TOL[name]))
                       for a, w in zip(fn(*args), plain(*args)))
    return out


def _split_bwd_rows(launches, steps):
    """Rows 7 and 8, the two-kernel backward, at the long step's attention
    (B1 H8 S16384 D64 causal, bf16): one forward's lse and delta shared by
    kernel and plain version. K and V are drawn around 1, not 0, as a
    trained layer's keys and values have a mean: with zero-mean inputs the
    delta term of dS nearly cancels at long range and a dQ without it
    would pass for most elements. The library yardstick is
    ``F.scaled_dot_product_attention``'s backward (dQ, dK and dV
    together), the same number in both rows."""
    import torch.nn.functional as F

    from distriflow_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    flush = _flush_buffer()
    b, h, s, d = LONG_TRAIN_B, 8, LONG_TRAIN_S, 64
    assert fa.bwd_layout(s, d, torch.bfloat16) == "split"

    args = _bwd_inputs(g, b, h, s, True)
    q, k, v, do, lse, delta, _ = args
    dq, want_q = fa.flash_attention_dq(*args), fa.flash_attention_dq_reference(*args)
    (dk, dv), (want_k, want_v) = fa.flash_attention_dkv(*args), fa.flash_attention_dkv_reference(*args)
    # each gradient's limit adds BWD_FLIPS flips of a bf16 term by element, as at D 32 (C16)
    (atol_q,) = _flip_atols("flash_attention_dq", ("dq",), *args)
    atol_k, atol_v = _flip_atols("flash_attention_dkv", ("dk", "dv"), *args)
    err_q = _over("flash_attention_dq", dq, want_q, atol_q, TOL["flash_attention_dq"][1])
    flip_limit = {"flash_attention_dq": _flip_report("flash_attention_dq", [(dq, want_q, atol_q)]),
                  "flash_attention_dkv": _flip_report("flash_attention_dkv", [(dk, want_k, atol_k),
                                                                              (dv, want_v, atol_v)])}
    # the least scalar atol each kernel's elements need above the limit's rtol
    needed = {"flash_attention_dq": _atol_needed("flash_attention_dq", [(dq, want_q)]),
              "flash_attention_dkv": _atol_needed("flash_attention_dkv",
                                                  [(dk, want_k), (dv, want_v)])}
    rtol = TOL["flash_attention_dkv"][1]
    err_kv = max(_over("flash_attention_dkv dk", dk, want_k, atol_k, rtol),
                 _over("flash_attention_dkv dv", dv, want_v, atol_v, rtol))
    # no atomics: a second launch gives the same bits
    again_k, again_v = fa.flash_attention_dkv(*args)
    assert torch.equal(fa.flash_attention_dq(*args), dq), "flash_attention_dq is not deterministic"
    assert torch.equal(again_k, dk) and torch.equal(again_v, dv), \
        "flash_attention_dkv is not deterministic"
    # the limits must reject wrong gradients: dS without the delta term,
    # and dK without the 1/sqrt(D) scale
    no_delta = fa.flash_attention_dq_reference(q, k, v, do, lse, torch.zeros_like(delta), True)
    unscaled = want_k.float() * math.sqrt(d)
    controls_q = {"no_delta": _rejected("flash_attention_dq", no_delta, want_q, atol=atol_q)}
    controls_kv = {"dk_unscaled": _rejected("flash_attention_dkv", unscaled, want_k, atol=atol_k)}
    flip_limit["flash_attention_dq"]["no_delta_under_scalar_atol"] = _rejected(
        "flash_attention_dq", no_delta, want_q)
    flip_limit["flash_attention_dkv"]["dk_unscaled_under_scalar_atol"] = _rejected(
        "flash_attention_dkv", unscaled, want_k)
    del no_delta, unscaled, again_k, again_v, atol_q, atol_k, atol_v
    for c in (controls_q, controls_kv):
        assert all(v > 0.5 for v in c.values()), f"a two-kernel limit passes a wrong gradient: {c}"
    # both kernels at lengths that end inside a tile (the lse and delta
    # reads stop at S, keys past S are masked) and on the non-causal branch
    ragged = [_ragged_bwd("flash_attention_dq", lambda *a: (fa.flash_attention_dq(*a),),
                          lambda *a: (fa.flash_attention_dq_reference(*a),), g, b, h),
              _ragged_bwd("flash_attention_dkv", fa.flash_attention_dkv,
                          fa.flash_attention_dkv_reference, g, b, h)]
    pairs = b * h * s * (s + 1) // 2
    io = 4 * b * h * s * d * 2 + 2 * b * h * s * 4
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    sdpa = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    library = _timed(lambda: torch.autograd.grad(sdpa, (qs, ks, vs), do, retain_graph=True), 10, flush)
    rows = []
    for name, line, err, products, outs, fn, plain, controls in (
            ("flash_attention_dq", "distriflow_tpu/ops/flash_attention.py:162", err_q, 3, 1,
             fa.flash_attention_dq, fa.flash_attention_dq_reference, controls_q),
            ("flash_attention_dkv", "distriflow_tpu/ops/flash_attention.py:212", err_kv, 4, 2,
             fa.flash_attention_dkv, fa.flash_attention_dkv_reference, controls_kv)):
        tb, by = _bound(io + outs * b * h * s * d * 2, products * 2 * pairs * d, exps=pairs)
        rows.append({
            "name": name, "route": "cuda", "source": "distriflow_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": line, "launches": launches[name], "launches_per_step": launches[name] / steps,
            "max_abs_err": err, "tol": _tol(name), "shape": f"B={b} H={h} S={s} D={d} causal",
            "ms": _timed(lambda: fn(*args), 10, flush), "plain_ms": _timed(lambda: plain(*args), 1, flush),
            "bound_ms": tb, "bound_by": by, "library_ms": library,
            "library_note": "F.scaled_dot_product_attention backward: dQ, dK and dV together",
            "rejected_share": controls, "deterministic": True,
            "atol_needed": needed[name], "flip_limit": flip_limit[name]})
    for r, errs in zip(rows, ragged):
        r["ragged_max_abs_err"] = errs
    return rows


# Rows 9d and 10d's shapes: (tag, N, V, target kind, a [1:] view). The
# path's N 2048 and the wire's and FedAvg's batches at V 10; N 8192 x V
# 32000 (soft targets) on the block-per-row layout; and, on the narrow
# layout, a partial last tile, a base 20 bytes into a tensor (a [1:] view,
# also a partial tile), and G 16 and 32 (V 100, and 256, the widest).
DENSE_CE_SHAPES = (("path", CN_B, 10, "one-hot", False), ("wire", WIRE_B, 10, "one-hot", False),
                   ("fedavg", FA_B, 10, "one-hot", False), ("large", 8192, 32000, "soft", False),
                   ("partial", 2047, 10, "one-hot", False), ("unaligned", 2049, 10, "one-hot", True),
                   ("v100", 1024, 100, "soft", False), ("v256", 512, 256, "soft", False))


def _dense_ce_inputs(i, n, vocab, kind, sliced):
    """Shape ``i`` of :data:`DENSE_CE_SHAPES`: bf16 logits, f32 targets and
    an upstream gradient g of order 1, from a generator of its own (the
    same inputs in this checkout and an older one); ``sliced`` takes rows
    [1:] of tensors one row longer."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(SEED + 8 + i)
    m = n + sliced
    logits = torch.randn(m, vocab, generator=g, device="cuda").to(torch.bfloat16)
    if kind == "one-hot":
        t = F.one_hot(torch.randint(0, vocab, (m,), generator=g, device="cuda"), vocab).float()
    else:
        t = torch.softmax(2 * torch.randn(m, vocab, generator=g, device="cuda"), -1)
    gr = torch.rand(m, generator=g, device="cuda")
    return (logits[1:], t[1:], gr[1:]) if sliced else (logits, t, gr)


def _dense_ce_times():
    """``{tag: [forward ms, backward ms]}`` of the dense CE kernels of the
    ``distriflow_tpu_torch`` first on ``sys.path`` at every shape of
    :data:`DENSE_CE_SHAPES`, timed as rows 9d and 10d time them."""
    from distriflow_tpu_torch.ops import fused_ce as ce

    flush, out = _flush_buffer(), {}
    for i, (tag, n, vocab, kind, sliced) in enumerate(DENSE_CE_SHAPES):
        logits, t, gr = _dense_ce_inputs(i, n, vocab, kind, sliced)
        _, lse = ce.fused_ce_dense_forward(logits, t)
        out[tag] = [_timed(lambda: ce.fused_ce_dense_forward(logits, t), 20, flush),
                    _timed(lambda: ce.fused_ce_dense_backward(logits, t, lse, gr), 20, flush)]
    return out


def _parent_times(parent, fn, *args):
    """``fn(*args)`` (a timing function of this file, by name, returning
    lists of ms by key) on the checkout at ``parent``: :func:`_parent_report`."""
    return {k: [float(v) for v in t] for k, t in _parent_report(parent, fn, *args).items()}


def _parent_report(parent, fn, *args):
    """``fn(*args)`` (a function of this file, by name, returning JSON) on
    the checkout at ``parent``, in a process of its own (the parent's
    package and kernels, this file's timer)."""
    torch.cuda.empty_cache()
    code = ("import importlib.util, json, sys\n"
            f"spec = importlib.util.spec_from_file_location('smoke', {os.path.abspath(__file__)!r})\n"
            "m = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(m)\n"
            f"print(json.dumps(m.{fn}(*{list(args)!r})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=parent, capture_output=True, text=True,
                         timeout=600, check=True)
    return json.loads(out.stdout.splitlines()[-1])


def _narrow_controls(logits, t, loss, lse, gr, lanes):
    """The share of elements outside rows 9d/10d's limits for two wrong
    results of the narrow layout at G ``lanes``: a forward whose lse sums
    only lane 0's columns (0, G, 2G, ...) and a backward whose lse misses
    the row max shift (lse - max)."""
    from distriflow_tpu_torch.ops import fused_ce as ce

    x = logits.float()
    lse0 = torch.logsumexp(x[:, ::lanes], -1)
    fwd = _rejected("fused_ce_dense_fwd", torch.cat([lse0 - (lse - loss), lse0]),
                    torch.cat([loss, lse]))
    shifted = ce.fused_ce_dense_backward_reference(logits, t, lse - x.amax(-1), gr)
    bwd = _rejected("fused_ce_dense_bwd", shifted,
                    ce.fused_ce_dense_backward_reference(logits, t, lse, gr))
    return {"lse_lane0_columns": fwd}, {"lse_without_max": bwd}


def _with_ce_was(rows, was):
    """Rows 9d and 10d with ``was_ms`` beside each shape: the
    :func:`_dense_ce_times` runs of an older checkout in ``was``."""
    for j, row in enumerate(rows):
        for tag, *_ in DENSE_CE_SHAPES:
            (row if tag == "path" else row[tag])["was_ms"] = \
                [run[tag][j] for run in was] or "not measured"
    return rows


def _dense_ce_rows(launches, steps, wire, inprocess):
    """Rows 9d and 10d, the dense CE, at every shape of
    :data:`DENSE_CE_SHAPES`: the ConvNet's (``path``, N 2048 x V 10, one-hot
    f32 targets), a wire worker's ``fit`` (``wire``, N 256), a FedAvg local
    step (``fedavg``, N 128), N 8192 x V 32000 with soft targets
    (``large``, where the kernels stream real bytes) and the narrow
    layout's edges. Each shape is held against the plain versions, gives
    the same bits on a second launch and is timed; at G > 1 the limits must
    reject the two wrong results of :func:`_narrow_controls`. ``launches``
    are the ConvNet's ``steps`` training steps', ``wire`` the wire legs'
    (one a worker's ``fit``), ``inprocess`` the in-process trainers' (one a
    batch or a local step); a row's ``launches`` is their sum."""
    import torch.nn.functional as F

    from distriflow_tpu_torch.ops import fused_ce as ce

    flush = _flush_buffer()
    fwd, bwd = {}, {}
    for i, (tag, n, vocab, kind, sliced) in enumerate(DENSE_CE_SHAPES):
        logits, t, gr = _dense_ce_inputs(i, n, vocab, kind, sliced)
        tile = ce._row_tile(vocab)
        assert (tile is None) == (vocab > ce.NARROW_MAX_V), (tag, tile)
        assert ce._aligned(logits, t) != sliced, f"{tag}: the base is not where it should be"
        loss, lse = ce.fused_ce_dense_forward(logits, t)
        again = ce.fused_ce_dense_forward(logits, t)
        assert torch.equal(again[0], loss) and torch.equal(again[1], lse), \
            f"fused_ce_dense_fwd {tag}: a second launch gave other bits"
        rl, rs = ce.fused_ce_dense_forward_reference(logits, t)
        err = max(_over(f"fused_ce_dense_fwd loss {tag}", loss, rl, *TOL["fused_ce_dense_fwd"]),
                  _over(f"fused_ce_dense_fwd lse {tag}", lse, rs, *TOL["fused_ce_dense_fwd"]))
        grad = ce.fused_ce_dense_backward(logits, t, lse, gr)
        assert torch.equal(ce.fused_ce_dense_backward(logits, t, lse, gr), grad), \
            f"fused_ce_dense_bwd {tag}: a second launch gave other bits"
        want = ce.fused_ce_dense_backward_reference(logits, t, lse, gr)
        berr = _over(f"fused_ce_dense_bwd {tag}", grad, want, *TOL["fused_ce_dense_bwd"])
        lg = logits.detach().clone().requires_grad_()
        lib_loss = F.cross_entropy(lg, t, reduction="none")
        lanes, rows = tile or (0, 0)
        common = {"shape": f"N={n} V={vocab} bf16 logits, {kind} f32 targets"
                           + (", a [1:] view (base 20 bytes in)" if sliced else ""),
                  "lanes": lanes, "rows_a_block": rows, "deterministic": True}
        io = n * vocab * (2 + 4)
        tb, by = _bound(io + 2 * n * 4, 4 * n * vocab, F32_FLOPS)
        fwd[tag] = {
            **common, "max_abs_err": err,
            "ms": _timed(lambda: ce.fused_ce_dense_forward(logits, t), 20, flush),
            "plain_ms": _timed(lambda: ce.fused_ce_dense_forward_reference(logits, t), 3, flush),
            "bound_ms": tb, "bound_by": by,
            "library_ms": _timed(lambda: F.cross_entropy(logits, t, reduction="none"), 20, flush)}
        tb, by = _bound(io + 2 * n * 4 + n * vocab * 2, 4 * n * vocab, F32_FLOPS)
        bwd[tag] = {
            **common, "max_abs_err": berr,
            "ms": _timed(lambda: ce.fused_ce_dense_backward(logits, t, lse, gr), 20, flush),
            "plain_ms": _timed(lambda: ce.fused_ce_dense_backward_reference(logits, t, lse, gr),
                               3, flush),
            "bound_ms": tb, "bound_by": by,
            "library_ms": _timed(lambda: torch.autograd.grad(
                lib_loss, lg, gr.to(lib_loss.dtype), retain_graph=True), 20, flush)}
        if lanes > 1:
            fwd[tag]["rejected_share"], bwd[tag]["rejected_share"] = _narrow_controls(
                logits, t, loss, lse, gr, lanes)
            for d in (fwd, bwd):
                assert all(v > 0.5 for v in d[tag]["rejected_share"].values()), \
                    f"a dense CE limit passes a wrong result at {tag}: {d[tag]['rejected_share']}"
        del logits, t, want, grad, lg, lib_loss
    rows = []
    for name, line, d in (("fused_ce_dense_fwd", "distriflow_tpu/ops/fused_ce.py:77", fwd),
                          ("fused_ce_dense_bwd", "distriflow_tpu/ops/fused_ce.py:107", bwd)):
        rows.append({
            **d["path"], "name": name, "route": "cuda",
            "source": "distriflow_tpu_torch/csrc/fused_ce.cu", "replaces": line,
            "variant": "sparse=False (dense targets)",
            "launches": launches[name] + sum(c[name] for c in wire.values())
            + sum(c[name] for c in inprocess.values()),
            "launches_per_step": launches[name] / steps,
            "launches_wire": {w: c[name] for w, c in wire.items()},
            "launches_inprocess": {w: c[name] for w, c in inprocess.items()},
            "max_abs_err": max(v["max_abs_err"] for v in d.values()),
            "tol": _tol(name), **{tag: d[tag] for tag, *_ in DENSE_CE_SHAPES[1:]},
            "library_note": "F.cross_entropy with probability targets (its backward for the "
                            "gradient)"})
    return rows


# ---------------------------------------------------------------- speculative

SPEC_K = 4                    # drafts a round
SPEC_NEW = 96                 # new tokens a request
SPEC_CONTEXTS = (1024, 16384)  # prompt + new tokens
SPEC_PS, SPEC_SLOTS = 128, 4
SPEC_DISTILL_STEPS, SPEC_DISTILL_LR = 50, 4e-3
SPEC_SAMPLED = dict(temperature=0.8, top_k=50, seed=7)
# the self-draft leg: accepted / proposed at least this (a draft equal to
# the target is accepted unless the bf16 decode kernel and the verify's
# einsum round a near-tie apart)
SPEC_SELF_ACCEPT = 0.8
SPEC_DRAFT_SOLO_NEW = 16


#: ``bench.py::bench_serving_speculative``'s target (max_seq the longer
#: context); the draft is ``draft_config_for("lm_draft", target)``
SPEC_TARGET = dict(vocab_size=32000, d_model=256, n_heads=4, n_layers=4, d_ff=1024,
                   dtype=torch.bfloat16)


def _ctx_label(ctx):
    return f"{ctx // 1024}k" if ctx % 1024 == 0 else str(ctx)


def _spec_config():
    from distriflow_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(max_seq=SPEC_CONTEXTS[-1], **SPEC_TARGET)


def _distill_draft(target, dcfg, tree, prompt, device="cuda"):
    """The bench's in-leg distillation: the draft (from ``tree``, f32, the
    plain path) fitted by ``SPEC_DISTILL_STEPS`` Adam steps to the target's
    greedy trajectory of ``prompt`` (the served target's argmax after each
    prefix, on the generated positions), then carried into a serving draft
    of ``dcfg`` (bf16, the kernels). Returns ``(draft, report)``."""
    import torch.nn.functional as F

    from distriflow_tpu_torch.models.convert import params_from_jax
    from distriflow_tpu_torch.models.generate import generate
    from distriflow_tpu_torch.models.transformer import TransformerLM

    t0 = time.perf_counter()
    prompt_t = torch.as_tensor(prompt, device=device)
    corpus = generate(target, prompt_t, SPEC_NEW)
    with torch.no_grad():
        teach = torch.argmax(target(corpus), dim=-1)
    f32 = dataclasses.replace(dcfg, dtype=torch.float32, use_flash_attention=False,
                              use_flash_decode=False)
    student = TransformerLM(f32, device=device, trainable=True)
    student.load_state_dict(params_from_jax(tree, f32, masters=True))
    x, y = corpus[:, :-1], teach[:, :-1].long()
    mask = torch.zeros(x.shape, device=device)
    mask[:, prompt.shape[1] - 1:] = 1.0
    opt = torch.optim.Adam(student.parameters(), lr=SPEC_DISTILL_LR)
    losses = []
    for _ in range(SPEC_DISTILL_STEPS):
        opt.zero_grad()
        logits = student(x).float()
        ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), y.reshape(-1),
                             reduction="none").reshape(y.shape)
        loss = (ce * mask).sum() / mask.sum()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    draft = TransformerLM(dcfg, device=device)
    draft.load_state_dict(student.state_dict())
    if draft.device.type == "cuda":
        torch.cuda.synchronize()
    assert all(math.isfinite(v) for v in losses) and losses[-1] < losses[0], losses
    return draft, {"steps": SPEC_DISTILL_STEPS, "lr": SPEC_DISTILL_LR, "first_ce": losses[0],
                   "final_ce": losses[-1], "seconds": time.perf_counter() - t0}


def _spec_serve(target, draft, prompts, counted, spec):
    """Serve ``prompts`` ({context: [1, P]}) greedy, B 1, on a paged
    server of ``SPEC_SLOTS`` slots over a pool of ``SPEC_SLOTS`` x
    pages_per_slot pages, speculative (k ``SPEC_K``, ``draft``) or plain.
    Per context: a 3-token priming request, a 1-token and a
    ``SPEC_NEW``-token request, the latter in a launch window of its own;
    ms/token is their difference over ``SPEC_NEW - 1`` tokens. Prefix
    sharing is off, so every request prefills its whole prompt. The
    speculative server also answers a sampled request twice with one seed
    and once with another. The pool must end all free with zero
    refcounts. Returns ``(by context, windows, sampled)``."""
    from distriflow_tpu_torch.client.inference_client import InferenceClient
    from distriflow_tpu_torch.models.generate import pages_per_slot
    from distriflow_tpu_torch.obs.telemetry import Telemetry
    from distriflow_tpu_torch.server.inference_server import InferenceServer
    from distriflow_tpu_torch.utils.config import ServingConfig

    cfg = target.config
    extra = {"speculate_k": SPEC_K, "draft_model": "lm_draft"} if spec else {}
    tel = Telemetry()
    server = InferenceServer(target, telemetry=tel, draft=draft if spec else None, serving=ServingConfig(
        kv_layout="paged", max_slots=SPEC_SLOTS, page_size=SPEC_PS, prefix_sharing=False,
        page_pool_pages=SPEC_SLOTS * pages_per_slot(cfg.max_seq, SPEC_PS), batch_window_s=0.02,
        **extra)).setup()
    client = InferenceClient(server.address, timeout=600).setup()
    out, windows, sampled = {}, {}, None
    try:
        for ctx, prompt in prompts.items():
            client.generate(prompt, n_tokens=3)
            p0 = tel.counter_value("serving_spec_proposed_total")
            a0 = tel.counter_value("serving_spec_accepted_total")
            t = time.perf_counter()
            client.generate(prompt, n_tokens=1)
            t1 = time.perf_counter() - t
            r0 = server.decode_batches
            t = time.perf_counter()
            full, counts = counted(lambda: client.generate(prompt, n_tokens=SPEC_NEW))
            tn = time.perf_counter() - t
            rounds = server.decode_batches - r0
            prop = tel.counter_value("serving_spec_proposed_total") - p0
            acc = tel.counter_value("serving_spec_accepted_total") - a0
            out[ctx] = {"out": full, "ms_per_token": (tn - t1) * 1e3 / (SPEC_NEW - 1),
                        "request_ms": tn * 1e3, "one_token_ms": t1 * 1e3, "rounds": rounds,
                        "proposed": prop, "accepted": acc,
                        "accept_rate": acc / prop if prop else None,
                        "accepted_per_round": acc / rounds if spec and rounds else None}
            windows[f"{'spec' if spec else 'plain'}_{_ctx_label(ctx)}"] = counts
        if spec:
            prompt = prompts[SPEC_CONTEXTS[0]]
            a, b = (client.generate(prompt, n_tokens=32, **SPEC_SAMPLED) for _ in range(2))
            c = client.generate(prompt, n_tokens=32, **{**SPEC_SAMPLED, "seed": SPEC_SAMPLED["seed"] + 1})
            assert np.array_equal(a, b), "sampled speculation: one seed gave two streams"
            assert not np.array_equal(a, c), "sampled speculation: two seeds gave one stream"
            assert (a[:, :prompt.shape[1]] == prompt).all() and (a >= 0).all() \
                and (a < cfg.vocab_size).all()
            sampled = {"same_seed_equal": True, "other_seed_differs": True,
                       "differing_tokens": int((a != c).sum())}
        phases = {k: {q: v[q] for q in ("count", "p50", "max", "sum")}
                  for k, v in server._prof.digests().items()}
    finally:
        client.close()
        server.stop()
    server.release_prefix_cache()
    pool = server._pool
    assert pool.free_pages == pool.n_pages and not pool._refs.any(), \
        f"the pool did not reconcile: {pool.free_pages} of {pool.n_pages} free"
    assert all(r is None for r in server._slot_req)
    assert not any(server._slot_pages) and not any(server._draft_pages)
    for v in out.values():
        v["phases_ms"] = phases
    return out, windows, sampled


#: the decode kernels' names in a profile (``kernel_ms`` of a speculative
#: round): the D 32 cluster kernel, or the split kernel and its combine
DECODE_KERNEL_NAMES = {"decode": ("decode_kernel", "split_kernel", "combine_kernel")}


def _profile_spec_round(target, draft, prompt, device="cuda"):
    """One speculative round (draft k, verify, commit) of the engine's
    ``SPEC_SLOTS`` slots with one live row at ``prompt``'s context, under
    ``torch.profiler`` after a warm round (:func:`_profiled`), with the
    decode kernels' device ms (:data:`DECODE_KERNEL_NAMES`)."""
    from distriflow_tpu_torch.models.generate import (
        commit,
        draft_k,
        paged_cache,
        paged_insert,
        pages_per_slot,
        prefill,
        verify,
    )

    pp = pages_per_slot(target.config.max_seq, SPEC_PS)
    n_pages = SPEC_SLOTS * pp
    plen = prompt.shape[1]
    caches, first = [], 0
    for i, m in enumerate((target, draft)):
        table = np.full((SPEC_SLOTS, pp + 1), n_pages, np.int32)
        table[0, :pp] = np.arange(i * pp, (i + 1) * pp)
        logits, row = prefill(m, prompt)
        caches.append(paged_insert(paged_cache(m.config, SPEC_SLOTS, SPEC_PS, n_pages, device),
                                   row, [0], plen, 0, table))
        first = first if i else int(logits.argmax())
        del row
    tok = np.zeros(SPEC_SLOTS, np.int32)
    tok[0] = first
    done = np.ones(SPEC_SLOTS, bool)
    done[0] = False
    off = (np.zeros(SPEC_SLOTS, np.float32), np.zeros(SPEC_SLOTS, np.int32),
           np.ones(SPEC_SLOTS, np.float32), np.zeros(SPEC_SLOTS, np.int64))
    eos = np.full(SPEC_SLOTS, -1, np.int32)
    state = {"tok": tok}

    def round_():
        dcache, drafts, q = draft_k(draft, caches[1], state["tok"], *off, SPEC_K)
        out = verify(target, caches[0], state["tok"], drafts, q, *off, done, eos, SPEC_K)
        commit(draft, dcache, drafts[:, -1], out[6], out[7])
        state["tok"] = out[4].cpu().numpy()

    round_()  # warm
    return _profiled(round_, DECODE_KERNEL_NAMES)


def _spec_self_leg(model, reqs, solos, counted):
    """``draft_model="self"`` on the flagship 2k config: the greedy
    requests of the serving wave one at a time, each held against solo
    ``generate()`` under the near-tie rule; the acceptance must be near k."""
    from distriflow_tpu_torch.client.inference_client import InferenceClient
    from distriflow_tpu_torch.obs.telemetry import Telemetry
    from distriflow_tpu_torch.server.inference_server import InferenceServer
    from distriflow_tpu_torch.utils.config import ServingConfig

    greedy = [r for r in reqs if not r[2]][:3]
    tel = Telemetry()
    server = InferenceServer(model, telemetry=tel, serving=ServingConfig(
        kv_layout="paged", speculate_k=SPEC_K, draft_model="self")).setup()
    client = InferenceClient(server.address, timeout=600).setup()
    try:
        outs, counts = counted(lambda: {name: client.generate(p, N_TOKENS) for name, p, _ in greedy})
        rounds = server.decode_batches
    finally:
        client.close()
        server.stop()
    prop = tel.counter_value("serving_spec_proposed_total")
    acc = tel.counter_value("serving_spec_accepted_total")
    report = {"parity": _check_greedy(model, greedy, outs, solos, N_TOKENS), "rounds": rounds,
              "proposed": prop, "accepted": acc, "accept_rate": acc / prop,
              "accepted_per_round": acc / rounds}
    assert acc / prop >= SPEC_SELF_ACCEPT, f"self-draft acceptance {acc / prop} < {SPEC_SELF_ACCEPT}"
    return report, counts


def _spec_phase(model, reqs, solos, counted, device="cuda"):
    """Speculative decoding at ``bench.py::bench_serving_speculative``'s
    recipe (see the module docstring, step 18). Returns ``(report,
    windows, the distilled draft)``."""
    from distriflow_tpu_torch.models.convert import lm_from_jax
    from distriflow_tpu_torch.models.generate import generate
    from distriflow_tpu_torch.models.transformer import TransformerLM
    from distriflow_tpu_torch.models.zoo import draft_config_for

    rng = np.random.default_rng(SEED + 12)
    cfg = _spec_config()
    target = lm_from_jax(cfg, _flagship_tree(cfg, rng), device=device)
    dcfg = draft_config_for("lm_draft", cfg)
    assert dcfg.head_dim == 32 and dcfg.use_flash_attention is None and dcfg.use_flash_decode is None
    prompts = {c: rng.integers(0, cfg.vocab_size, (1, c - SPEC_NEW)).astype(np.int32)
               for c in SPEC_CONTEXTS}
    draft, distill = _distill_draft(target, dcfg, _flagship_tree(dcfg, rng),
                                    prompts[SPEC_CONTEXTS[0]], device)
    print("spec_distill:", json.dumps(distill), flush=True)
    spec, spec_windows, sampled = _spec_serve(target, draft, prompts, counted, True)
    plain, plain_windows = _spec_serve(target, None, prompts, counted, False)[:2]
    windows = {**spec_windows, **plain_windows}
    # the greedy contract: speculative output equals plain output, but
    # where the verify's einsum and the decode kernel round a near-tie apart
    reqs_spec = [(_ctx_label(c), prompts[c], {}) for c in SPEC_CONTEXTS]
    parity = _check_greedy(target, reqs_spec, {n: spec[c]["out"] for (n, _, _), c in
                                               zip(reqs_spec, SPEC_CONTEXTS)},
                           {n: torch.as_tensor(plain[c]["out"]) for (n, _, _), c in
                            zip(reqs_spec, SPEC_CONTEXTS)}, n_tokens=SPEC_NEW)
    # kernel 3 at D 32: the draft's own solo generate() against its plain path
    prompt = prompts[SPEC_CONTEXTS[0]]
    got, windows["draft_solo"] = counted(
        lambda: generate(draft, prompt, SPEC_DRAFT_SOLO_NEW).cpu())
    plain_draft = TransformerLM(dataclasses.replace(dcfg, use_flash_attention=False,
                                                    use_flash_decode=False), device=device)
    plain_draft.load_state_dict(draft.state_dict())
    want = generate(plain_draft, prompt, SPEC_DRAFT_SOLO_NEW).cpu()
    draft_parity = _check_greedy(plain_draft, [("draft", prompt, {})], {"draft": got},
                                 {"draft": want}, n_tokens=SPEC_DRAFT_SOLO_NEW)
    self_report, windows["spec_self"] = _spec_self_leg(model, reqs, solos, counted)
    round_profile = {_ctx_label(c): _profile_spec_round(target, draft, prompts[c], device)
                     for c in SPEC_CONTEXTS}
    report = {
        "target": {k: getattr(cfg, k) for k in ("vocab_size", "d_model", "n_heads", "n_layers",
                                                "d_ff", "max_seq")},
        "draft": {k: getattr(dcfg, k) for k in ("d_model", "n_heads", "n_layers", "d_ff")},
        "k": SPEC_K, "new_tokens": SPEC_NEW, "distill": distill, "parity": parity,
        "draft_solo_parity": draft_parity, "sampled": sampled, "self_draft_2k": self_report,
        "rates": {_ctx_label(c): {
            "spec_ms_per_token": spec[c]["ms_per_token"],
            "plain_ms_per_token": plain[c]["ms_per_token"],
            "speedup": plain[c]["ms_per_token"] / spec[c]["ms_per_token"],
            "accept_rate": spec[c]["accept_rate"],
            "accepted_per_round": spec[c]["accepted_per_round"], "rounds": spec[c]["rounds"],
            "spec_request_ms": spec[c]["request_ms"], "plain_request_ms": plain[c]["request_ms"]}
            for c in SPEC_CONTEXTS},
        "spec_phases_ms": spec[SPEC_CONTEXTS[0]]["phases_ms"],
        "round_profile": round_profile,
        "pool_reconciled": True,
    }
    _check_spec_windows(report, windows, spec, dcfg)
    return report, windows, draft


def _check_spec_windows(report, windows, spec, dcfg):
    """The speculative windows' exact launches: the target's prefill at D
    64 and the draft's at D 32; the draft's k steps and the commit on
    kernel 2 at D 32, once a step per draft layer; kernel 2 never at D 64
    (the target's verify is one s = k + 1 pass); the draft's solo
    ``generate()`` on kernels 1 and 3 at D 32 only."""
    for c in SPEC_CONTEXTS:
        w = windows[f"spec_{_ctx_label(c)}"]
        want_d32 = spec[c]["rounds"] * (SPEC_K + 1) * dcfg.n_layers
        assert w["flash_decode_paged_d32"] == want_d32 == w["flash_decode_paged"], \
            (c, w, spec[c]["rounds"])
        assert w["flash_attention_fwd_d32"] > 0 and w["flash_attention_fwd"] > \
            w["flash_attention_fwd_d32"], (c, w)
        report["rates"][_ctx_label(c)]["launches"] = {
            "flash_attention_fwd_d64": w["flash_attention_fwd"] - w["flash_attention_fwd_d32"],
            "flash_attention_fwd_d32": w["flash_attention_fwd_d32"],
            "flash_decode_paged_d32": w["flash_decode_paged_d32"], "flash_decode_paged_d64": 0}
    solo = windows["draft_solo"]
    assert solo["flash_decode"] == solo["flash_decode_d32"] > 0, solo
    assert solo["flash_attention_fwd"] == solo["flash_attention_fwd_d32"] > 0, solo


def _spec_kernel_rows(launches):
    """Rows 1-3 at head dim 32, the draft's: kernel 1 at B1 H4 S1024 and
    S16288 (the draft's prefills), kernel 2 paged at the draft's contexts
    over the engine's 4 slots, kernel 3 (slab) at the draft's solo shape.
    Each row: the limit of its D 64 row, the same bits on a second launch,
    decode rows' wrong-combine rejections, split sweep and edges; the
    decode rows (one cluster kernel, ``d32::decode_kernel``) also the same
    bits at every cluster size (``by_cluster``), and row 2 a combine that
    skips the last rank's partials rejected (``last_rank_fault_share``),
    paged equal to slab bit for bit at pages of 128 over the edges'
    contexts and the clusters the card holds at once (C 8 and 16)."""
    import torch.nn.functional as F

    from distriflow_tpu_torch.ops import flash_attention as fa
    from distriflow_tpu_torch.ops import flash_decode as fd

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    flush = _flush_buffer()
    h, d = 4, 32
    rows = []

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev, dtype=torch.float32).to(torch.bfloat16)

    checks, errs = {}, []
    for s, causal in ((1, True), (37, False), (37, True), (300, True), (1000, False)):
        q, k, v = randn(1, h, s, d), randn(1, h, s, d), randn(1, h, s, d)
        o, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
        ro, rl = fa.flash_attention_reference(q, k, v, causal)
        tag = f"S={s} {'causal' if causal else 'non-causal'}"
        errs.append(_over(f"flash_attention_fwd D32 {tag}", o, ro, *TOL["flash_attention_fwd"]))
        checks[tag] = [errs[-1], _over(f"flash_attention_fwd D32 lse {tag}", lse, rl, LSE_ATOL, 0.0)]
    timed = {}
    for s in (SPEC_CONTEXTS[0], SPEC_CONTEXTS[1] - SPEC_NEW):
        q, k, v = randn(1, h, s, d), randn(1, h, s, d), randn(1, h, s, d)
        o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
        again = fa.flash_attention(q, k, v, causal=True, return_lse=True)
        assert torch.equal(again[0], o) and torch.equal(again[1], lse), \
            f"flash_attention_fwd D32 S={s}: a second launch gave other bits"

        def plain(q=q, k=k, v=v):  # one head at a time: the [S, S] scores
            return [fa.flash_attention_reference(q[:, i:i + 1], k[:, i:i + 1], v[:, i:i + 1], True)
                    for i in range(h)]

        ref = plain()
        ro, rl = torch.cat([r[0] for r in ref], 1), torch.cat([r[1] for r in ref], 1)
        del ref
        errs.append(_over(f"flash_attention_fwd D32 S={s}", o, ro, *TOL["flash_attention_fwd"]))
        lse_err = _over(f"flash_attention_fwd D32 lse S={s}", lse, rl, LSE_ATOL, 0.0)
        pairs = s * (s + 1) // 2
        tb, by = _bound(4 * h * s * d * 2 + h * s * 4, 4 * h * pairs * d, exps=h * pairs)
        timed[s] = {"shape": f"B=1 H={h} S={s} D={d} causal", "max_abs_err": errs[-1],
                    "lse_max_abs_err": lse_err,
                    "ms": _timed(lambda: fa.flash_attention(q, k, v, causal=True, return_lse=True),
                                 20, flush),
                    "plain_ms": _timed(plain, 1, flush), "bound_ms": tb, "bound_by": by,
                    "library_ms": _timed(
                        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), 20, flush)}
    main_s = SPEC_CONTEXTS[0]
    rows.append({
        "name": "flash_attention_fwd_d32", "route": "cuda",
        "source": "distriflow_tpu_torch/csrc/flash_attention.cu",
        "replaces": "distriflow_tpu/ops/flash_attention.py:92",
        "launches": launches["flash_attention_fwd_d32"], "max_abs_err": max(errs),
        "tol": _tol("flash_attention_fwd") + f"; lse atol {LSE_ATOL}",
        **{k: timed[main_s][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                          "shape", "lse_max_abs_err")},
        "long_context": timed[SPEC_CONTEXTS[1] - SPEC_NEW], "checks": checks,
        "deterministic": True})

    # paged: the engine's 4 slots at the draft's contexts, scattered pages
    ps = SPEC_PS
    lens_l = [SPEC_CONTEXTS[0] - SPEC_NEW + 40, SPEC_CONTEXTS[1] - 3, 700, 1]
    bsz, pp = len(lens_l), SPEC_CONTEXTS[1] // ps
    n_pages = sum(-(-n // ps) for n in lens_l) + 4
    table, lens = _paged_rows(g, lens_l, ps, n_pages, pp)
    kp, vp, q1 = randn(n_pages, ps, h * d), randn(n_pages, ps, h * d), randn(bsz, h, d)

    def paged():
        return fd.flash_decode_paged(q1, kp, vp, table, lens)

    def paged_plain():
        return fd.flash_decode_paged_reference(q1, kp, vp, table, lens)

    live = sum(lens_l)
    n_splits = -(-pp // fd.split_tiles(ps))
    tb, by = _bound(2 * live * h * d * 2 + 2 * bsz * h * d * 2 + table.numel() * 4 + bsz * 4,
                    4 * live * h * d, exps=live * h)
    rows.append({
        "name": "flash_decode_paged_d32", "route": "cuda",
        "source": "distriflow_tpu_torch/csrc/flash_decode.cu",
        "replaces": "distriflow_tpu/ops/flash_decode.py:474",
        "launches": launches["flash_decode_paged_d32"],
        "max_abs_err": _over("flash_decode_paged D32", paged(), paged_plain(),
                             *TOL["flash_decode_paged"]),
        "tol": _tol("flash_decode_paged"),
        "ms": _timed(paged, 200, flush), "plain_ms": _timed(paged_plain, 5, flush),
        "bound_ms": tb, "bound_by": by, "library_ms": None,
        "shape": f"B={bsz} H={h} D={d} page={ps} contexts={lens_l}",
        "edges_max_abs_err": _decode_edges("flash_decode_paged", g, False, h=h, d=d),
        **_decode_checks("flash_decode_paged", paged, paged_plain,
                         lambda: fd.split_partials(q1, kp, vp, lens, table), flush, 200),
        "by_cluster": _d32_clusters("flash_decode_paged D32", paged, flush),
        "last_rank_fault_share": _last_rank_fault(
            "flash_decode_paged", fd.split_partials(q1, kp, vp, lens, table), paged_plain(), n_splits),
        "paged_equals_slab_contexts": _paged_equals_slab(g, h, d),
        "clusters_at_once": {str(c): fd.build.load("flash_decode", fd._SIGNATURES)
                             .dftt_flash_decode_d32_clusters(n_splits, c) for c in (8, 16)}})

    # slab: the draft's solo generate() (max_seq 16384) at its last step
    s_max, n = SPEC_CONTEXTS[1], SPEC_CONTEXTS[0] - SPEC_NEW + SPEC_DRAFT_SOLO_NEW
    ks, vs, qs = randn(1, s_max, h * d), randn(1, s_max, h * d), randn(1, h, d)
    kh = ks.view(1, s_max, h, d).transpose(1, 2)[:, :, :n].contiguous()
    vh = vs.view(1, s_max, h, d).transpose(1, 2)[:, :, :n].contiguous()
    tb, by = _bound(2 * n * h * d * 2 + 2 * h * d * 2, 4 * n * h * d, exps=n * h)
    rows.append({
        "name": "flash_decode_d32", "route": "cuda",
        "source": "distriflow_tpu_torch/csrc/flash_decode.cu",
        "replaces": "distriflow_tpu/ops/flash_decode.py:235",
        "launches": launches["flash_decode_d32"],
        "max_abs_err": _over("flash_decode D32", fd.flash_decode(qs, ks, vs, n),
                             fd.flash_decode_reference(qs, ks, vs, n), *TOL["flash_decode"]),
        "tol": _tol("flash_decode"),
        "ms": _timed(lambda: fd.flash_decode(qs, ks, vs, n), 200, flush),
        "plain_ms": _timed(lambda: fd.flash_decode_reference(qs, ks, vs, n), 5, flush),
        "bound_ms": tb, "bound_by": by,
        "library_ms": _timed(lambda: F.scaled_dot_product_attention(qs[:, :, None], kh, vh), 200,
                             flush),
        "shape": f"B=1 S={s_max} valid={n} H={h} D={d}",
        "edges_max_abs_err": _decode_edges("flash_decode", g, False, h=h, d=d),
        **_decode_checks("flash_decode", lambda: fd.flash_decode(qs, ks, vs, n),
                         lambda: fd.flash_decode_reference(qs, ks, vs, n),
                         lambda: fd.split_partials(qs, ks, vs, n), flush, 200),
        "by_cluster": _d32_clusters("flash_decode D32", lambda: fd.flash_decode(qs, ks, vs, n), flush)})
    return rows


def _d32_clusters(name, fn, flush):
    """Kernel 2 or 3 at D 32 (row ``name``) at every cluster size from 1 to
    ``fd.D32_CLUSTER_MAX``, forced through that constant as
    :func:`_decode_checks` sweeps ``fd.SPLIT_TILES``: the same bits as at
    the chosen size (asserted) and the median ms (``by_cluster``)."""
    from distriflow_tpu_torch.ops import flash_decode as fd

    want = fn()
    chosen, sweep = fd.D32_CLUSTER_MAX, {}
    try:
        c = 1
        while c <= chosen:
            fd.D32_CLUSTER_MAX = c
            assert torch.equal(fn(), want), f"{name}: a cluster of {c} gave other bits"
            sweep[str(c)] = {"same_bits": True, "ms": _timed(fn, 50, flush)}
            c *= 2
    finally:
        fd.D32_CLUSTER_MAX = chosen
    return sweep


def _last_rank_fault(name, parts, want, n_splits):
    """The share of elements outside ``name``'s limit around the plain
    output ``want`` when the combine skips the last rank's partials
    (splits i with i % C == C - 1, C = ``d32_cluster(n_splits)``), over
    the rows with a live split there (the only ones it changes); raises if
    no row has one."""
    from distriflow_tpu_torch.ops import flash_decode as fd

    c = fd.d32_cluster(n_splits)
    hit = torch.stack([lv for i, (*_, lv) in enumerate(parts) if i % c == c - 1]).any(0)
    assert hit.any(), f"{name}: no row has a live split on rank {c - 1}"
    skipped = [(m, li, a, lv & (i % c != c - 1)) for i, (m, li, a, lv) in enumerate(parts)]
    share = _rejected(name, fd.combine_partials(skipped).to(want.dtype)[hit], want[hit])
    assert share > 0.5, f"{name}: the limit passes a combine without rank {c - 1}: {share}"
    return share


def _paged_equals_slab(g, h, d):
    """Kernel 2 on scattered pages of ``SLAB_TILE`` and kernel 3 on a slab
    holding the same K and V give the same bits (asserted), at the edges'
    contexts (:func:`_decode_edges`: 1, a split, a split + 1, 0, three
    splits + 5, 700); returns the rows' contexts."""
    from distriflow_tpu_torch.ops import flash_decode as fd

    dev = torch.device("cuda")
    ps = fd.SLAB_TILE
    split = fd.split_tiles(ps) * ps
    lens_l = [1, split, split + 1, 0, 3 * split + 5, 700]
    b, pp = len(lens_l), -(-max(lens_l) // ps) + 2
    k, v = (torch.randn(b, pp * ps, h * d, generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    perm = torch.randperm(b * pp, generator=g, device=dev)
    pool_k, pool_v = (torch.empty(b * pp, ps, h * d, dtype=torch.bfloat16, device=dev) for _ in range(2))
    pool_k[perm], pool_v[perm] = k.view(b * pp, ps, h * d), v.view(b * pp, ps, h * d)
    table = perm.to(torch.int32).view(b, pp).contiguous()
    q = torch.randn(b, h, d, generator=g, device=dev).to(torch.bfloat16)
    lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
    assert torch.equal(fd.flash_decode_paged(q, pool_k, pool_v, table, lens),
                       fd.flash_decode(q, k, v, lens)), "paged decode at pages of 128 != slab decode"
    return lens_l


#: :func:`_decode_d32_times`' shapes: label -> (B, H, D, page or None for a
#: slab, contexts, table width or slab positions, cache). Rows 2 and 3 at
#: D 32; the speculative 1k leg's engine (4 slots near 1k, a 16k table);
#: the CLI's ``--serve`` (B4 H8, a 512-position table, one live split a
#: row); and, untouched by the D 32 kernel, rows 2-5 at D 64 and 2-3 on
#: f32 caches at D 32.
DECODE_TIMES = {
    "row2_d32": (4, 4, 32, 128, [968, 16381, 700, 1], 128, "bf16"),
    "row3_d32": (1, 4, 32, None, [944], 16384, "bf16"),
    "spec_1k": (4, 4, 32, 128, [968, 990, 1010, 1024], 128, "bf16"),
    "cli_serve": (4, 8, 32, 128, [40, 64, 80, 96], 4, "bf16"),
    "row2_d64": (8, 8, 64, 128, [129, 300, 513, 1001, 193, 577, 1064, 128], 16, "bf16"),
    "row3_d64": (1, 8, 64, None, [1064], 2048, "bf16"),
    "row4_int8": (8, 8, 64, 128, [1088, 1088, 1088, 1088, 8256, 12064, 16064, 4224], 128, "int8"),
    "row5_int8": (4, 8, 64, None, [8223] * 4, 16384, "int8"),
    "row2_f32": (4, 8, 32, 128, [33, 64, 95, 300], 3, "f32"),
    "row3_f32": (1, 8, 32, None, [512], 512, "f32"),
}


def _decode_d32_times():
    """The decode kernels through this process's package (``[ms]`` by
    :data:`DECODE_TIMES` label), what ``--parent`` runs on an older checkout
    before and after this one's: the D 32 kernel at its four shapes and
    the untouched instances beside it."""
    from distriflow_tpu_torch.ops import flash_decode as fd

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 64)
    flush = _flush_buffer()
    out = {}
    for label, (b, h, d, ps, lens_l, width, cache) in DECODE_TIMES.items():
        dt = torch.float32 if cache == "f32" else torch.bfloat16
        q = torch.randn(b, h, d, generator=g, device=dev).to(dt)
        if ps is None:
            lead, table, lens = (b, width), None, torch.tensor(lens_l, dtype=torch.int32, device=dev)
        else:
            n_pages = sum(-(-n // ps) for n in lens_l) + 4
            table, lens = _paged_rows(g, lens_l, ps, n_pages, width)
            lead = (n_pages, ps)
        if cache == "int8":
            kv = _int8_cache(g, lead, h, d)
        else:
            kv = tuple(torch.randn(*lead, h * d, generator=g, device=dev).to(dt) for _ in range(2))
        fn = fd.flash_decode if ps is None else fd.flash_decode_paged
        extra = (lens,) if ps is None else (table, lens)
        if cache == "int8":
            fn = fd.flash_decode_int8 if ps is None else fd.flash_decode_paged_int8
        out[label] = [_timed(lambda: fn(q, *kv, *extra), 200, flush)]
    return out


def _with_decode_was(rows, was):
    """Rows 2 and 3 at D 32 with ``was_ms``: the :func:`_decode_d32_times`
    runs of an older checkout in ``was`` at the rows' shapes."""
    at = {"flash_decode_paged_d32": "row2_d32", "flash_decode_d32": "row3_d32"}
    for row in rows:
        if row["name"] in at:
            row["was_ms"] = [run[at[row["name"]]][0] for run in was] or "not measured"
    return rows


def _spec_round_16k():
    """One speculative round at 16k context on this process's package
    (:func:`_profile_spec_round`: the engine's 4 slots, one live), the
    target and a draft of ``draft_config_for("lm_draft")`` from seeded
    random weights: what ``--parent`` profiles on an older checkout before
    and after this one's (``spec_16k_round:``)."""
    from distriflow_tpu_torch.models.convert import lm_from_jax
    from distriflow_tpu_torch.models.zoo import draft_config_for

    rng = np.random.default_rng(SEED + 65)
    cfg = _spec_config()
    target = lm_from_jax(cfg, _flagship_tree(cfg, rng), device="cuda")
    dcfg = draft_config_for("lm_draft", cfg)
    draft = lm_from_jax(dcfg, _flagship_tree(dcfg, rng), device="cuda")
    prompt = rng.integers(0, cfg.vocab_size, (1, SPEC_CONTEXTS[1] - SPEC_NEW)).astype(np.int32)
    return _profile_spec_round(target, draft, prompt)


# -- the serving fleet (step 20) ---------------------------------------------

#: leg (a): ``bench.py::bench_serving_fleet``'s defaults (users re-sending
#: their own prompt; one cold wave, then the warm waves)
FLEET_CTX, FLEET_NEW, FLEET_USERS, FLEET_WARM_WAVES, FLEET_PS = 1024, 64, 6, 2, 128
FLEET_WINDOW_S = 0.05
#: leg (b): ``bench.py::bench_serving_elastic``'s defaults
ELASTIC_CTX, ELASTIC_NEW, ELASTIC_REQUESTS, ELASTIC_PS = 512, 16, 8, 64
ELASTIC_WINDOW_S, ELASTIC_CHUNK, STRAGGLE_S, HEDGE_MS = 0.02, 8, 1.0, 25.0
#: ``HashRing(256)`` remap fractions over ``warmset-0..1999``: a join of D
#: to A/B/C, a leave of A (tests/test_torch_fleet_ring.py pins the same
#: two from the JAX package's ring)
ELASTIC_REMAP = (0.2515, 0.3475)
#: leg (c): idle requests before and after, the burst, the autoscaler's
#: poll period and the timeline's; 2 slots a replica, so the burst queues
#: in waves and its TTFT grows wave by wave
AUTOSCALE_IDLE, AUTOSCALE_BURST, AUTOSCALE_SLOTS = 6, 12, 2
AUTOSCALE_POLL_S, AUTOSCALE_TIMELINE_S, AUTOSCALE_TIMEOUT_S = 0.25, 0.1, 30.0


def _fleet_model(tree, ctx, new, device="cuda"):
    """``SPEC_TARGET`` at max_seq ``ctx + new`` from the seeded tree."""
    from distriflow_tpu_torch.models.convert import lm_from_jax
    from distriflow_tpu_torch.models.transformer import TransformerConfig

    return lm_from_jax(TransformerConfig(max_seq=ctx + new, **SPEC_TARGET), tree, device=device)


def _fleet_replicas(model, names, telemetry, **serving):
    """Port ``InferenceServer``s in this process, one per name, each with
    its own page pool and scheduler thread; ``telemetry(name)`` gives each
    its telemetry."""
    from distriflow_tpu_torch.server.inference_server import InferenceServer
    from distriflow_tpu_torch.utils.config import ServingConfig

    return {n: InferenceServer(model, telemetry=telemetry(n), serving=ServingConfig(
        kv_layout="paged", **serving)).setup() for n in names}


def _stop_fleet(router, replicas):
    """Stop the router and the replicas; then every pool must hold all its
    pages free, with zero refcounts, once the prefix map lets go."""
    router.stop()
    for name, s in replicas.items():
        s.stop()
        s.release_prefix_cache()
        pool = s._pool
        assert pool.free_pages == pool.n_pages and not pool._refs.any(), \
            f"replica {name}: {pool.free_pages} of {pool.n_pages} pages free"
        assert all(r is None for r in s._slot_req) and not any(s._slot_pages), name


def _engine_counts(replicas):
    """What the replicas' own counters say ran: fresh prefills (one kernel 1
    launch a layer each) and decode steps (chunk x iterations: one kernel 2
    launch a layer each), summed."""
    return {"prefills": sum(s.prefills for s in replicas.values()),
            "decode_steps": sum(s.decode_batches * s.serving.decode_chunk
                                for s in replicas.values()),
            "prefix_hits": sum(s.prefix_hits for s in replicas.values())}


def _check_fleet_launches(window, counts, engine, n_layers):
    """A fleet window launched kernel 1 once a layer a fresh prefill and
    kernel 2 once a layer a decode step (at D 64: ``main`` holds the D 32
    counts and every other kernel at 0)."""
    want = (n_layers * engine["prefills"], n_layers * engine["decode_steps"])
    got = (counts["flash_attention_fwd"], counts["flash_decode_paged"])
    assert got == want and min(got) > 0, (window, counts, engine)


def _wave(clients, prompts, n_tokens, request_ids=None):
    """Every client sends its prompt at once (client i with
    ``request_ids[i]``); returns ``(wall s, [(output, last_route)])``."""
    out, errs = [None] * len(clients), []
    barrier = threading.Barrier(len(clients))

    def call(i):
        try:
            barrier.wait()
            rid = request_ids[i] if request_ids else None
            got = clients[i].generate(prompts[i], n_tokens, request_id=rid)
            out[i] = (got, dict(clients[i].last_route))
        except Exception as e:  # re-raised on the main thread below
            errs.append((i, e))

    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(clients))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errs or any(t.is_alive() for t in threads):
        raise RuntimeError(f"fleet wave failed: {errs}")
    return wall, out


def _affinity_leg(model, prompts, pool, policy):
    """``bench_serving_fleet``'s leg for one policy: 2 fresh replicas behind
    a router, the cold wave, then the warm waves (timed). Every routed
    output is held, bit for bit, against its replica's answer to the same
    ``request_id`` asked directly (the router passes the bits through)."""
    from distriflow_tpu_torch.client.inference_client import InferenceClient
    from distriflow_tpu_torch.fleet import FleetRouter, RouterClient
    from distriflow_tpu_torch.obs.telemetry import Telemetry

    replicas = _fleet_replicas(model, ("replica-0", "replica-1"), lambda _: Telemetry(),
                               max_slots=len(prompts), page_size=FLEET_PS, page_pool_pages=pool,
                               batch_window_s=FLEET_WINDOW_S)
    router = FleetRouter(port=0, policy=policy, telemetry=Telemetry())
    for name, s in replicas.items():
        router.add_replica(s.address, name=name)
    router.setup()
    clients = [RouterClient(router.address, timeout=600).setup() for _ in prompts]
    try:
        routed, warm_wall = {}, 0.0
        for wave in range(1 + FLEET_WARM_WAVES):
            rids = [f"{policy}-w{wave}-u{i}" for i in range(len(prompts))]
            wall, outs = _wave(clients, prompts, FLEET_NEW, rids)
            warm_wall += wall if wave else 0.0
            routed.update({rid: (i, *o) for i, (rid, o) in enumerate(zip(rids, outs))})
        for rid, (i, out, route) in routed.items():
            with InferenceClient(replicas[route["replica"]].address, timeout=600) as direct:
                assert np.array_equal(direct.generate(prompts[i], FLEET_NEW, request_id=rid), out), \
                    f"{rid}: the routed output is not the replica's answer"
        affinity_hits = router._tel.counter_value("router_affinity_hits_total")
        by_replica = {n: sum(1 for *_, r in routed.values() if r["replica"] == n) for n in replicas}
    finally:
        for c in clients:
            c.close()
        engine = _engine_counts(replicas)
        _stop_fleet(router, replicas)
    return {"tok_s_user": FLEET_WARM_WAVES * FLEET_NEW / warm_wall,
            "hit_rate": engine["prefix_hits"] / float(FLEET_WARM_WAVES * len(prompts)),
            "router_affinity_hits_total": affinity_hits, "warm_wall_s": warm_wall,
            "requests_by_replica": by_replica, "engine": engine, "pools_reconciled": True}, routed


def _fleet_affinity(tree, rng, counted, windows, device="cuda"):
    """Leg (a): prefix affinity against round-robin (``bench_serving_fleet``),
    each policy in a launch window of its own; every routed output held
    against solo ``generate()`` under the near-tie rule (a window of its
    own: kernels 1 and 3)."""
    from distriflow_tpu_torch.models.generate import generate, pages_per_slot

    model = _fleet_model(tree, FLEET_CTX, FLEET_NEW, device)
    cfg = model.config
    prompts = [rng.integers(0, cfg.vocab_size, (1, FLEET_CTX)).astype(np.int32)
               for _ in range(FLEET_USERS)]
    # affinity's partition (half the users' prefixes a replica) fits warm,
    # round-robin's duplication does not
    pool = (FLEET_USERS // 2) * ((FLEET_CTX - 1) // FLEET_PS) \
        + 2 * pages_per_slot(FLEET_CTX + FLEET_NEW, FLEET_PS)
    report, reqs, outs = {"pool_pages": pool}, [], {}
    for policy in ("round_robin", "affinity"):
        (leg, routed), counts = counted(lambda p=policy: _affinity_leg(model, prompts, pool, p))
        windows[f"fleet_{policy}"] = counts
        _check_fleet_launches(f"fleet_{policy}", counts, leg["engine"], cfg.n_layers)
        report[policy] = leg
        for rid, (i, out, _) in routed.items():
            reqs.append((rid, prompts[i], {}))
            outs[rid] = out
    solo, windows["fleet_solo"] = counted(
        lambda: [generate(model, p, FLEET_NEW).cpu() for p in prompts])
    parity = _check_greedy(model, reqs, outs, {rid: solo[int(rid.rsplit("u", 1)[1])]
                                               for rid, _, _ in reqs}, n_tokens=FLEET_NEW)
    report["ratio"] = report["affinity"]["tok_s_user"] / report["round_robin"]["tok_s_user"]
    report["parity"] = {"requests": len(parity),
                        "equal_to_solo": sum(1 for v in parity.values() if v["equal_to_solo"]),
                        "near_ties": {k: v for k, v in parity.items() if not v["equal_to_solo"]},
                        "equal_to_direct": len(parity)}
    return report


def _owned(ring, owner, ctx, vocab):
    """The first seeded prompt whose first chain hash ``ring`` places on
    ``owner`` (``bench_serving_elastic``'s search)."""
    from distriflow_tpu_torch.fleet import page_hashes

    for seed in range(4096):
        p = np.random.default_rng(seed).integers(1, vocab, size=(1, ctx)).astype(np.int32)
        if ring.primary(page_hashes(p[0], ELASTIC_PS)[0]) == owner:
            return p
    raise AssertionError(f"no prompt owned by {owner}")


def _elastic_run(model):
    """Leg (b)'s fleet: 3 replicas on the ring, the straggler unhedged and
    hedged, then the churn wave (``bench_serving_elastic``)."""
    from distriflow_tpu_torch.client.inference_client import InferenceClient
    from distriflow_tpu_torch.fleet import FleetRouter, RouterClient
    from distriflow_tpu_torch.obs.telemetry import Telemetry

    ctx, new = ELASTIC_CTX, ELASTIC_NEW
    tels = {n: Telemetry() for n in "ABC"}
    replicas = _fleet_replicas(
        model, "ABC", tels.get, max_slots=2, page_size=ELASTIC_PS,
        page_pool_pages=4 * ((ctx + new) // ELASTIC_PS + 1), batch_window_s=ELASTIC_WINDOW_S,
        decode_chunk=ELASTIC_CHUNK)
    tel = Telemetry()
    router = FleetRouter(port=0, policy="ring", stats_interval_s=0.0, redial=False, telemetry=tel)
    for name, s in replicas.items():
        router.add_replica(s.address, name=name)
    router.setup()
    try:
        prompts = {n: _owned(router.ring, n, ctx, model.config.vocab_size) for n in replicas}
        for name, s in replicas.items():  # each replica's paths once, unrouted
            with InferenceClient(s.address, timeout=600) as w:
                w.generate(prompts[name], new)
        sa = replicas["A"]

        def straggler(hedged):
            walls, ttfts, winners = [], [], []
            with RouterClient(router.address, timeout=600) as c:
                for _ in range(ELASTIC_REQUESTS):
                    t0 = time.perf_counter()
                    c.generate(prompts["A"], new, tier=0)
                    walls.append((time.perf_counter() - t0) * 1e3)
                    ttfts.append(c.last_serving_meta["ttft_ms"])
                    winners.append(c.last_replica)
                    if hedged:  # let A's stretched window close on the cancelled copy
                        time.sleep(STRAGGLE_S)
            return {"wall_p50_ms": float(np.percentile(walls, 50)),
                    "wall_p99_ms": float(np.percentile(walls, 99)),
                    "replica_ttft_p50_ms": float(np.percentile(ttfts, 50)),
                    "replica_ttft_p99_ms": float(np.percentile(ttfts, 99)),
                    "walls_ms": walls, "answered_by": winners}

        sa.serving.batch_window_s = STRAGGLE_S  # read at use time
        try:
            unhedged = straggler(False)
            router.hedge_ms[0] = HEDGE_MS
            hedged = straggler(True)
        finally:
            router.hedge_ms.clear()
            sa.serving.batch_window_s = ELASTIC_WINDOW_S
        hedges = tel.counter_value("router_hedges_total")
        wins = tel.counter_value("router_hedge_wins_total")
        cancelled = sum(t.counter_value("serving_hedge_cancelled_total") for t in tels.values())
        with RouterClient(router.address, timeout=600) as c:  # the churn wave
            def route_all():
                served = []
                for p in prompts.values():
                    c.generate(p, 4, tier=1)
                    served.append(c.last_replica)
                return served

            router.drain_replica("B")
            left = route_all()
            router.undrain_replica("B")
            back = route_all()
        accepted = sum(tel.counter_value("router_requests_total", tier=str(t)) for t in (0, 1, 2))
        answered = sum(tel.counter_value("router_goodput_total", tier=str(t)) for t in (0, 1, 2))
        membership = [(e["epoch"], e["event"], e["replica"]) for e in router.ring_membership()]
    finally:
        engine = _engine_counts(replicas)
        _stop_fleet(router, replicas)
    return {"unhedged": unhedged, "hedged": hedged, "router_hedges_total": hedges,
            "router_hedge_wins_total": wins, "serving_hedge_cancelled_total": cancelled,
            "churn": {"drained_B": left, "undrained_B": back, "accepted": accepted,
                      "answered": answered, "goodput": answered / accepted if accepted else 0.0},
            "ring_membership": membership, "engine": engine, "pools_reconciled": True}


def _remap_fractions():
    """``bench_serving_elastic``'s structural remap cost, on the port's ring."""
    from distriflow_tpu_torch.fleet import HashRing

    ring = HashRing(256)
    ring.sync(["A", "B", "C"])
    keys = [f"warmset-{i}".encode() for i in range(2000)]
    base = ring.assignment(keys)
    ring.add("D")
    join = sum(1 for k, v in ring.assignment(keys).items() if v != base[k]) / len(keys)
    ring.remove("D")
    assert ring.assignment(keys) == base, "join + leave did not round-trip"
    ring.remove("A")
    leave = sum(1 for k, v in ring.assignment(keys).items() if v != base[k]) / len(keys)
    return join, leave


def _fleet_elastic(tree, counted, windows, device="cuda"):
    """Leg (b): the elastic ring in a launch window of its own (page 64)."""
    model = _fleet_model(tree, ELASTIC_CTX, ELASTIC_NEW, device)
    report, windows["fleet_elastic"] = counted(lambda: _elastic_run(model))
    _check_fleet_launches("fleet_elastic", windows["fleet_elastic"], report["engine"],
                          model.config.n_layers)
    un, he = report["unhedged"], report["hedged"]
    assert he["wall_p50_ms"] < un["wall_p50_ms"], (he["wall_p50_ms"], un["wall_p50_ms"])
    hedges = report["router_hedges_total"]
    assert hedges >= 1 and report["serving_hedge_cancelled_total"] == hedges, \
        f"hedge losers not cancelled: {report['serving_hedge_cancelled_total']} of {hedges}"
    assert report["churn"]["goodput"] == 1.0, report["churn"]
    join, leave = _remap_fractions()
    assert (join, leave) == ELASTIC_REMAP, (join, leave)
    report["remap"] = {"join_frac": join, "leave_frac": leave}
    return report


def _autoscale_run(model, prompts):
    """Leg (c)'s episode: idle TTFT, a sustained band at twice its p99, the
    burst under a polling autoscaler, the scale-in after it, idle again."""
    from distriflow_tpu_torch.fleet import FleetAutoscaler, FleetRouter, RouterClient
    from distriflow_tpu_torch.obs.health import HealthSentinel, SLOBand
    from distriflow_tpu_torch.obs.registry import metric_ident
    from distriflow_tpu_torch.obs.telemetry import Telemetry

    tel = Telemetry()
    store = tel.start_timeline(interval_s=AUTOSCALE_TIMELINE_S)
    replicas = _fleet_replicas(model, "AB", lambda _: tel, max_slots=AUTOSCALE_SLOTS,
                               page_size=FLEET_PS, batch_window_s=FLEET_WINDOW_S)
    router = FleetRouter(port=0, policy="ring", stats_interval_s=0.0, redial=False, telemetry=tel)
    for name, s in replicas.items():
        router.add_replica(s.address, name=name)
    router.setup()
    stop, polls, errs = threading.Event(), [], []
    try:
        assert router.drain_replica("B")  # the warm standby

        def sequential(ps):
            ttfts = []
            with RouterClient(router.address, tier=0, timeout=600) as c:
                for p in ps:
                    c.generate(p, FLEET_NEW)
                    ttfts.append(c.last_serving_meta["ttft_ms"])
            return ttfts

        idle = sequential(prompts[:AUTOSCALE_IDLE])
        idle_p99 = float(np.percentile(idle, 99))
        band = SLOBand("ttft_p99_tier0", "serving_ttft_ms", "p99", {"tier": "0"},
                       upper=2 * idle_p99, kind="sustained", sustained_samples=3)
        scaler = FleetAutoscaler(router, HealthSentinel(tel, bands=[band]), min_replicas=1,
                                 cooldown_checks=2, scale_in_clean_checks=4)

        def poll():
            try:
                while not stop.is_set():
                    router.refresh_stats()
                    polls.append((time.time(), scaler.step()))
                    stop.wait(AUTOSCALE_POLL_S)
            except Exception as e:  # re-raised on the main thread below
                errs.append(e)

        poller = threading.Thread(target=poll, name="autoscaler-poll")
        poller.start()
        burst_p = prompts[AUTOSCALE_IDLE:AUTOSCALE_IDLE + AUTOSCALE_BURST]
        clients = [RouterClient(router.address, tier=0, timeout=600).setup() for _ in burst_p]
        try:
            t_burst = time.time()
            _, outs = _wave(clients, burst_p, FLEET_NEW)
            t_end = time.time()
        finally:
            for c in clients:
                c.close()
        burst = [c.last_serving_meta["ttft_ms"] for c in clients]
        deadline = time.monotonic() + AUTOSCALE_TIMEOUT_S
        while time.monotonic() < deadline and not errs and \
                not any(a["action"] == "scale_in" for _, acts in polls for a in acts):
            time.sleep(AUTOSCALE_POLL_S)
        stop.set()
        poller.join(timeout=30)
        if errs:
            raise errs[0]
        after = sequential(prompts[AUTOSCALE_IDLE + AUTOSCALE_BURST:])
        live_after = [r.name for r in router.registry.live()]
    finally:
        stop.set()
        tel.stop_timeline()
        engine = _engine_counts(replicas)
        _stop_fleet(router, replicas)
    series = store.series(metric_ident("serving_ttft_ms", {"tier": "0"}), "p99")
    breaching = [t for t, v in series if v is not None and v > band.upper]
    actions = [(i, t, a) for i, (t, acts) in enumerate(polls) for a in acts]
    return {"idle": idle, "burst": burst, "after": after, "upper_ms": band.upper,
            "burst_window_s": [t_burst, t_end], "first_breach_t": breaching[0] if breaching else None,
            "actions": actions, "polls": len(polls), "live_after": live_after,
            "served_by": [o[1]["replica"] for o in outs], "engine": engine,
            "events": [e["kind"] for e in store.events()]}


def _fleet_autoscale(tree, rng, counted, windows, device="cuda"):
    """Leg (c): the autoscaler on a real sentinel over the timeline, in a
    launch window of its own."""
    model = _fleet_model(tree, FLEET_CTX, FLEET_NEW, device)
    n = 2 * AUTOSCALE_IDLE + AUTOSCALE_BURST
    prompts = [rng.integers(0, model.config.vocab_size, (1, FLEET_CTX)).astype(np.int32)
               for _ in range(n)]
    run, windows["fleet_autoscale"] = counted(lambda: _autoscale_run(model, prompts))
    _check_fleet_launches("fleet_autoscale", windows["fleet_autoscale"], run["engine"],
                          model.config.n_layers)
    acts = run["actions"]
    kinds = [a["action"] for _, _, a in acts]
    assert kinds[:1] == ["scale_out"] and acts[0][2]["via"] == "undrain" \
        and acts[0][2]["replica"] == "B", acts
    t_burst, t_end = run["burst_window_s"]
    assert t_burst <= acts[0][1] <= t_end, f"no scale-out during the burst: {acts}"
    assert "scale_in" in kinds[1:], f"no scale-in after the burst: {acts}"
    assert len(run["live_after"]) == 1, run["live_after"]
    for (i, _, _), (j, _, _) in zip(acts, acts[1:]):
        assert j - i > 2, f"an action inside the cooldown: polls {i} and {j}"
    assert run["first_breach_t"] is not None and run["first_breach_t"] <= acts[0][1]
    return {"idle_ttft_p99_ms": float(np.percentile(run["idle"], 99)),
            "burst_ttft_p99_ms": float(np.percentile(run["burst"], 99)),
            "after_ttft_p99_ms": float(np.percentile(run["after"], 99)),
            "band_upper_ms": run["upper_ms"],
            "burst_s": t_end - t_burst,
            "breach_to_scale_out_s": acts[0][1] - run["first_breach_t"],
            "actions": [{"poll": i, "t_from_burst_s": t - t_burst, **a} for i, t, a in acts],
            "polls": run["polls"], "burst_served_by": run["served_by"],
            "live_after": run["live_after"], "timeline_events": run["events"],
            "engine": run["engine"], "pools_reconciled": True}


def _fleet_phase(counted, device="cuda"):
    """The serving fleet (module docstring, step 20): legs (a)-(c), each
    in launch windows of its own. Returns ``(report, windows)``."""
    from distriflow_tpu_torch.models.transformer import TransformerConfig

    rng = np.random.default_rng(SEED + 15)
    tree = _flagship_tree(TransformerConfig(max_seq=FLEET_CTX + FLEET_NEW, **SPEC_TARGET), rng)
    windows = {}
    report = {"affinity": _fleet_affinity(tree, rng, counted, windows, device),
              "elastic": _fleet_elastic(tree, counted, windows, device),
              "autoscale": _fleet_autoscale(tree, rng, counted, windows, device)}
    return report, windows


def _page_row(name, launches, seed, ps, n_pages, pp, pairs, timed, control=None):
    """Kernel 2 (B 2, H 4, D 64) at page ``ps`` over a pool of ``n_pages``
    and tables ``pp`` wide: held against its plain version at each context
    pair of ``pairs``, each launched twice for the same bits; timed at the
    pair ``timed`` against its plain version and its bound; the split
    edges at page ``ps``; and, on the timed rows or on the rows ``control``
    (which must span several splits), the same bits twice, the wrong
    combines rejected and the split sweep."""
    from distriflow_tpu_torch.ops import flash_decode as fd

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    flush = _flush_buffer()
    h, d = 4, 64

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev, dtype=torch.float32).to(torch.bfloat16)

    kp, vp = randn(n_pages, ps, h * d), randn(n_pages, ps, h * d)
    checks, errs = {}, []
    for lens_l in pairs:
        table, lens = _paged_rows(g, lens_l, ps, n_pages, pp)
        q = randn(2, h, d)
        out = fd.flash_decode_paged(q, kp, vp, table, lens)
        assert torch.equal(fd.flash_decode_paged(q, kp, vp, table, lens), out), \
            f"flash_decode_paged page {ps} {lens_l}: a second launch gave other bits"
        errs.append(_over(f"flash_decode_paged page {ps} {lens_l}", out,
                          fd.flash_decode_paged_reference(q, kp, vp, table, lens),
                          *TOL["flash_decode_paged"]))
        checks[str(lens_l)] = errs[-1]
    table, lens = _paged_rows(g, timed, ps, n_pages, pp)
    q1 = randn(2, h, d)

    def paged():
        return fd.flash_decode_paged(q1, kp, vp, table, lens)

    def paged_plain():
        return fd.flash_decode_paged_reference(q1, kp, vp, table, lens)

    errs.append(_over(f"flash_decode_paged page {ps}", paged(), paged_plain(),
                      *TOL["flash_decode_paged"]))
    ctl = (q1, kp, vp, table, lens)
    extra = {}
    if control is not None:  # the timed rows fit one split: others for the controls
        n_long = sum(-(-n // ps) for n in control) + 2
        kl, vl = randn(n_long, ps, h * d), randn(n_long, ps, h * d)
        table_l, lens_l = _paged_rows(g, control, ps, n_long, -(-max(control) // ps) + 1)
        ctl = (randn(2, h, d), kl, vl, table_l, lens_l)
        extra["control_shape"] = f"B=2 H={h} D={d} page={ps} contexts={control}"
    live = sum(timed)
    tb, by = _bound(2 * live * h * d * 2 + 2 * 2 * h * d * 2 + table.numel() * 4 + 2 * 4,
                    4 * live * h * d, exps=live * h)
    return {
        "name": name, "route": "cuda",
        "source": "distriflow_tpu_torch/csrc/flash_decode.cu",
        "replaces": "distriflow_tpu/ops/flash_decode.py:474",
        "launches": launches, "max_abs_err": max(errs), "tol": _tol("flash_decode_paged"),
        "ms": _timed(paged, 200, flush), "plain_ms": _timed(paged_plain, 5, flush),
        "bound_ms": tb, "bound_by": by, "library_ms": None,
        "shape": f"B=2 H={h} D={d} page={ps} contexts={timed} pool={n_pages}",
        "checks": checks, **extra,
        "edges_max_abs_err": _decode_edges("flash_decode_paged", g, False, h=h, d=d, ps=ps),
        **_decode_checks("flash_decode_paged", lambda: fd.flash_decode_paged(*ctl),
                         lambda: fd.flash_decode_paged_reference(*ctl),
                         lambda: fd.split_partials(ctl[0], ctl[1], ctl[2], ctl[4], ctl[3]),
                         flush, 200)}


def _p64_kernel_row(launches):
    """Kernel 2 at page 64, the elastic leg's shape (contexts up to 528,
    its pool): :func:`_page_row` at context pairs from 1 to 528, timed at
    rows of 528 and 520 as row 2 is timed."""
    pp = -(-(ELASTIC_CTX + ELASTIC_NEW) // ELASTIC_PS) + 1
    n_pages = 4 * ((ELASTIC_CTX + ELASTIC_NEW) // ELASTIC_PS + 1)  # the leg's pool
    return _page_row("flash_decode_paged_p64", launches, SEED + 16, ELASTIC_PS, n_pages, pp,
                     ([1, 528], [64, 65], [255, 257], [300, 512], [527, 1]),
                     [ELASTIC_CTX + ELASTIC_NEW, ELASTIC_CTX + 8])


# -- the port's doctor (step 21) -------------------------------------------

#: the doctor's LM drills (``doctor.py::_drill_config``): B 2 slots, 4 heads
#: x 64, pages of 16 in a pool of 24, contexts up to max_seq 48
DOCTOR_PS, DOCTOR_POOL, DOCTOR_MAX_SEQ = 16, 24, 48


def _doctor_phase(counted):
    """``distriflow_tpu_torch.doctor.main()`` on ``cuda`` in this process,
    in a launch window of its own: exit 0, "all checks passed", every
    check ``ok`` (its line and its report row). Returns ``(report, launch
    counts)``; ``report["checks"]`` has each check's wall seconds."""
    import contextlib
    import io

    from distriflow_tpu_torch import doctor

    rows, out = [], io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc, counts = counted(lambda: doctor.main(["--device", "cuda"], rows))
    wall = time.perf_counter() - t0
    text = out.getvalue()
    print(text, end="", flush=True)
    assert rc == 0 and "all checks passed" in text, f"the doctor exited {rc}"
    assert len(rows) == 22 and all(r["status"] == "ok" for r in rows), rows
    for r in rows:
        assert f"  ok   {r['name']}" in text, r["name"]
    assert counts["flash_decode_paged"] > 0, counts
    assert counts["flash_attention_fwd"] == 0, counts
    return {"wall_s": wall, "checks": {r["name"]: r["s"] for r in rows},
            "launches": {k: counts[k] for k in ("flash_decode_paged", "flash_decode")}}, counts


def _p16_kernel_row(launches):
    """Kernel 2 at page 16, the doctor's drills' shape (a pool of 24 pages,
    contexts up to 48), where a split spans 16 pages: :func:`_page_row` at
    the context pairs 1/15/16/17/33/48 (rows of unequal length), timed at
    rows of 48 and 33; the wrong combines and the split sweep on rows of
    700 and 300, which span several splits."""
    from distriflow_tpu_torch.models.generate import pages_per_slot

    pp = pages_per_slot(DOCTOR_MAX_SEQ, DOCTOR_PS) + 1  # the engine's table width
    return _page_row("flash_decode_paged_p16", launches, SEED + 17, DOCTOR_PS, DOCTOR_POOL, pp,
                     ([1, 48], [15, 33], [16, 17], [17, 16], [33, 1], [48, 15]),
                     [DOCTOR_MAX_SEQ, 33], control=[700, 300])


def _roofline_phase(cost, rows):
    """The roofline (``ops/roofline.py``) of the ConvNet's B 2048 step and
    the 16k remat LM step from their ``cost_analysis`` (the kernel tally's
    categories and the aten remainder), against their measured p50; and
    this run's calibration of each efficiency (bound over time of the
    kernel-table rows it names, and of one cuBLAS matmul at the 16k LM
    step's projection shape)."""
    from distriflow_tpu_torch.ops import roofline as rl

    by = {r["name"]: r for r in rows}
    flush = _flush_buffer()
    g = torch.Generator(device="cuda").manual_seed(SEED + 14)
    a = torch.randn(16384, 512, generator=g, device="cuda").to(torch.bfloat16)
    w = torch.randn(512, 512, generator=g, device="cuda").to(torch.bfloat16)
    mm_ms = _timed(lambda: a @ w, 50, flush)
    mm_bound = _bound((a.numel() + w.numel() + a.numel()) * 2, 2 * 16384 * 512 * 512)[0]

    def ratio(pairs):
        return sum(b for b, _ in pairs) / sum(t for _, t in pairs)

    lc = by["flash_attention_fwd"]["long_context"]
    calibration = {
        "attention_fwd": ratio([(lc["bound_ms"], lc["ms"])]),
        "attention_bwd": ratio([(by[n]["bound_ms"], by[n]["ms"]) for n in
                                ("flash_attention_bwd", "flash_attention_dq", "flash_attention_dkv")]),
        "fused_ce": ratio([(by[n]["bound_ms"], by[n]["ms"]) for n in ("fused_ce_fwd", "fused_ce_bwd")]),
        "depthwise_gn": ratio([(by[n]["step_bound_ms_all_blocks"], by[n]["step_ms_all_blocks"])
                               for n in ("depthwise_gn_fwd", "depthwise_gn_bwd")]),
        rl.REMAINDER: mm_bound / mm_ms,
        "aten_matmul": {"shape": "[16384, 512] x [512, 512] bf16", "ms": mm_ms,
                        "bound_ms": mm_bound}}
    out = {"calibration": calibration, "efficiency_used": dict(rl.PHASE_EFFICIENCY)}
    for name in ("convnet", "long_lm"):
        c = cost[name]
        rep = rl.roofline_report(c["kernel_by_category"], c["flops"], xla_flops=c["aten_flops"],
                                 measured_step_s=c["step_ms_p50"] / 1e3)
        assert math.isfinite(rep["model_error"]) and rep["step_time_s"] > 0, rep
        out[name] = {"bound_by": rep["bound_by"], "projected_step_ms": rep["step_time_s"] * 1e3,
                     "measured_step_ms_p50": c["step_ms_p50"], "model_error": rep["model_error"],
                     "mfu_roofline": rep["mfu_roofline"],
                     "phases_ms": {k: {"time": v["time_s"] * 1e3, "bound": v["bound"]}
                                   for k, v in rep["phases"].items()}}
    return out


def _moe_config(k, **kw):
    """:data:`MOE` at top-``k``, bf16."""
    from distriflow_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(**MOE, moe_top_k=k, dtype=torch.bfloat16, **kw)


def _route_choices(model, record):
    """Forward hooks on every MoE router of ``model`` setting
    ``record[layer]`` to the call's top-k expert indices ``[B, S, k]``;
    returns the hook handles."""
    def hook(layer, moe):
        def keep(mod, args, gates):
            record[layer] = moe._top_k(torch.softmax(gates.detach(), dim=-1))[1]
        return keep
    return [blk.moe.router.register_forward_hook(hook(i, blk.moe))
            for i, blk in enumerate(model.layers)]


def _pin_routes(model, record):
    """Route every MoE layer of ``model`` to the experts of ``record``
    (:func:`_route_choices` of another model on the same tokens), with
    gate weights from ``model``'s own router probabilities."""
    for i, blk in enumerate(model.layers):
        def top_k(probs, idx=record[i]):
            idx = idx.reshape(*probs.shape[:-1], idx.shape[-1])
            return torch.gather(probs, -1, idx), idx
        blk.moe._top_k = top_k


def _moe_step_vs_plain(cfg, tree, x, y, device="cuda"):
    """An MoE step's loss and gradients through the kernels against the
    plain path (:func:`_step_vs_plain`'s), routed as the kernel step
    routed, held to :data:`STEP_TOL`. Routing is a discontinuous choice:
    where the plain path's own bf16/f32 differences upstream flip a
    token's expert, that token's whole contribution (and, at capacity,
    its neighbours' slots) moves to another expert's gradient, whatever
    the kernels compute. So the plain step that routes on its own is
    reported beside it with the tokens routed apart per layer, not held."""
    from distriflow_tpu_torch.models.convert import lm_from_jax
    from distriflow_tpu_torch.models.transformer import transformer_lm

    x, y = torch.as_tensor(x, device=device), torch.as_tensor(y, device=device)
    plain = dataclasses.replace(cfg, use_flash_attention=False, loss="sparse_softmax_cross_entropy")

    def step(c, record=None, pinned=None):
        model = lm_from_jax(c, tree, device=device, trainable=True)
        hooks = [] if record is None else _route_choices(model, record)
        if pinned is not None:
            _pin_routes(model, pinned)
        loss, grads = transformer_lm(c, device=device).grad_fn()(model, x, y)
        for h in hooks:
            h.remove()
        return float(loss), grads

    routes_k, routes_p = {}, {}
    kernels = step(cfg, routes_k)
    own = step(plain, routes_p)
    apart = {i: int((routes_k[i].sort(-1).values != routes_p[i].sort(-1).values).any(-1).sum())
             for i in routes_k}
    (lk, gk), (lp, gp) = kernels, own
    rel = {n: float((gk[n] - gp[n]).norm() / gp[n].norm().clamp_min(1e-30)) for n in gp}
    worst = max(rel, key=rel.get)
    own_report = {"loss_plain": lp, "loss_abs_diff": abs(lk - lp),
                  "grad_rel_frobenius_max": rel[worst], "worst_param": worst,
                  "grad_rel_frobenius_median": float(np.median(list(rel.values()))),
                  "tokens_routed_apart": apart, "tokens": x.numel()}
    del own, gp
    out = {"kernels": kernels, "plain": step(plain, pinned=routes_k)}
    report = {"batch": x.shape[0], "seq": x.shape[1], "routed_as_kernel_step": True}
    try:
        report.update(_grads_vs_plain(out, STEP_TOL))
    except AssertionError:
        print("moe step against the plain step routing on its own:", json.dumps(own_report),
              flush=True)
        raise
    report["plain_routing_on_its_own"] = own_report
    return report


def _expert_times(cfg, flush, device="cuda"):
    """The experts' two products at the top-2 training shape (``[G, E, C,
    d] x [E, d, f]``, gelu, ``x [E, f, d]``) in f32, as the MoE layer runs
    them (JAX's promotion), and in bf16 for comparison."""
    from distriflow_tpu_torch.models.transformer import _auto_block

    n = MOE_B * MOE_S
    g = _auto_block(n, cfg.moe_group_size)
    c = max(1, int(cfg.capacity_factor * 2 * g / cfg.n_experts))
    gen = torch.Generator(device=device).manual_seed(SEED)
    shape = (n // g, cfg.n_experts, c, cfg.d_model)
    x = torch.randn(shape, generator=gen, device=device)
    wi = torch.randn(cfg.n_experts, cfg.d_model, cfg.d_ff, generator=gen, device=device) / 32
    wo = torch.randn(cfg.n_experts, cfg.d_ff, cfg.d_model, generator=gen, device=device) / 64

    def run(x, wi, wo):
        h = torch.nn.functional.gelu(torch.einsum("xecd,edf->xecf", x, wi), approximate="tanh")
        return torch.einsum("xecf,efd->xecd", h, wo)

    bf = [t.to(torch.bfloat16) for t in (x, wi, wo)]
    flops = 4.0 * shape[0] * cfg.n_experts * c * cfg.d_model * cfg.d_ff
    f32_ms, bf16_ms = _timed(lambda: run(x, wi, wo), 10, flush), _timed(lambda: run(*bf), 10, flush)
    return {"shape_xecd": list(shape), "d_ff": cfg.d_ff, "flops": flops, "f32_ms": f32_ms,
            "f32_tflops": flops / f32_ms / 1e9, "bf16_ms": bf16_ms,
            "bf16_tflops": flops / bf16_ms / 1e9}


def _moe_train_leg(k, tree, batches, counted, device="cuda"):
    """Top-``k`` trained on ``batches`` in a launch window of its own (per
    step exactly: kernel 1 and the fused backward once a layer, the CE
    forward and backward once); then its cost, MFU and phase split at the
    timed steps' p50, one profiled step and the kernel step against the
    plain step. Returns ``(report, launch counts)``."""
    from distriflow_tpu_torch.models.transformer import moe_phase_fwd_flops

    cfg = _moe_config(k)
    (trainer, losses, ms), counts = counted(lambda: _train(cfg, tree, batches, device))
    per_step = {"flash_attention_fwd": cfg.n_layers, "flash_attention_bwd": cfg.n_layers,
                "fused_ce_fwd": 1, "fused_ce_bwd": 1}
    for name, n in counts.items():
        assert n == per_step.get(name, 0) * len(batches), (f"moe_train_top{k}", name, n, counts)
    drops = [float(b.moe.dropped_fraction) for b in trainer.model.layers]
    x, y = batches[-1]
    with torch.no_grad():
        _, aux = trainer.model(torch.as_tensor(x, device=device), with_aux=True)
    timed = ms[MOE_WARM:]
    p50 = float(np.median(timed))
    cost = trainer.cost_analysis((x, y))
    report = {
        "top_k": k, "steps": len(batches), "warm_steps": MOE_WARM, "batch": MOE_B, "seq": MOE_S,
        "loss": trainer.spec.loss, "step_ms_p50": p50, "step_ms_max": max(timed),
        "tokens_per_s": MOE_B * MOE_S / (p50 / 1e3),
        "mfu": trainer.mfu((x, y), step_seconds=p50 / 1e3), "flops": cost["flops"],
        "first_loss": losses[0], "last_loss": losses[-1], "losses": losses,
        "aux_weighted": float(aux), "dropped_fraction": drops}
    # bench.py's exact-FLOP split: each phase's share of the step's FLOPs
    # (forward x 3 for forward and backward) of the p50 step
    fwd = moe_phase_fwd_flops(cfg, MOE_B * MOE_S)
    split = {f"top{k}_{p}_ms": p50 * v * cfg.n_layers * 3 / cost["flops"] for p, v in fwd.items()}
    split[f"top{k}_other_ms"] = p50 - sum(split.values())
    report["phase_split"] = split
    prof = _profiled(lambda: trainer.step((x, y)))
    prof["top_kernels"] = prof["top_kernels"][:5]
    report["step_profile"] = prof
    assert all(math.isfinite(v) for v in losses), losses
    assert losses[-1] < losses[0], f"top-{k} loss did not fall: {losses}"
    del trainer
    report["step_vs_plain"] = _moe_step_vs_plain(cfg, tree, x, y, device)
    return report, counts


def _router_near_ties(model, record):
    """Forward hooks counting, at every single-token decode call of every
    MoE layer, the positions whose top-2 router probabilities lie within
    :data:`ROUTER_NEAR_TIE` (device tensors appended to ``record``)."""
    def hook(mod, args, gates):
        if gates.shape[1] == 1:
            top = torch.topk(torch.softmax(gates, dim=-1), 2, dim=-1).values
            record.append(((top[..., 0] - top[..., 1]) < ROUTER_NEAR_TIE).sum())
            record.append(torch.tensor(-gates.shape[0], device=gates.device))
    return [blk.moe.router.register_forward_hook(hook) for blk in model.layers]


def _moe_serving_leg(tree, rng, counted, device="cuda"):
    """The top-1 model at max_seq :data:`MOE_SERVE_SEQ` behind the port's
    server (default ``ServingConfig``): the 2k recipe's eight requests,
    then one beam and one score, each in its own window; solo
    ``generate()`` in a window of its own for the greedy parity. Returns
    ``(report, launch counts by window)``."""
    from distriflow_tpu_torch.models.convert import lm_from_jax
    from distriflow_tpu_torch.models.generate import beam_search, sequence_logprob

    cfg = dataclasses.replace(_moe_config(1), max_seq=MOE_SERVE_SEQ)
    n = cfg.n_layers
    model = lm_from_jax(cfg, tree, device=device)
    reqs = _requests(rng, cfg.vocab_size)
    beam_prompt = rng.integers(0, cfg.vocab_size, (1, MOE_BEAM_PROMPT)).astype(np.int32)
    score_tokens = rng.integers(0, cfg.vocab_size, (1, MOE_SCORE_LEN)).astype(np.int32)
    direct = (("beam", lambda c: c.beam_search(beam_prompt, MOE_BEAM_TOKENS, beam_size=4)),
              ("score", lambda c: c.score(score_tokens, from_pos=MOE_SCORE_FROM)))
    t0 = time.perf_counter()
    outs, stats, serving, done = _serve(model, reqs, counted, direct)
    wall = time.perf_counter() - t0
    (beam_toks, beam_scores), beam = done["beam"]
    served_score, score = done["score"]
    ties = []
    hooks = _router_near_ties(model, ties)
    solos, solo = counted(lambda: _solo(model, reqs))
    for h in hooks:
        h.remove()
    near = torch.stack(ties).reshape(-1, 2).sum(0).tolist() if ties else [0, 0]
    parity = _check_greedy(model, reqs, outs, solos, N_TOKENS)
    windows = {"moe_serving": serving, "moe_solo_generate": solo, "moe_beam": beam,
               "moe_score": score}
    want = {"moe_serving": {"flash_attention_fwd": n * stats["prefills"],
                            "flash_decode_paged": n * stats["decode_steps"]},
            "moe_solo_generate": {"flash_attention_fwd": n * len(reqs),
                                  "flash_decode": n * len(reqs) * (N_TOKENS - 1)},
            "moe_beam": {"flash_attention_fwd": n, "flash_decode": n * (MOE_BEAM_TOKENS - 1)},
            "moe_score": {"flash_attention_fwd": n}}
    assert stats["prefills"] > 0 and stats["decode_steps"] > 0, stats
    for w, counts in windows.items():
        for name, c in counts.items():
            assert c == want[w].get(name, 0), (w, name, c, counts, stats)
    ref_toks, ref_scores = beam_search(model, beam_prompt, MOE_BEAM_TOKENS, beam_size=4)
    assert np.array_equal(np.asarray(beam_toks), ref_toks.cpu().numpy()), "served beam != solo"
    want_score = float(sequence_logprob(model, score_tokens, MOE_SCORE_FROM)[0])
    got_score = float(np.asarray(served_score)[0])
    rel = abs(got_score - want_score) / abs(want_score)
    assert math.isfinite(got_score) and rel <= SCORE_RTOL, (got_score, want_score, rel)
    report = {
        "max_seq": cfg.max_seq, "top_k": 1, "serving": {"wall_s": wall, **stats},
        "parity": parity,
        "router_near_ties": {"positions": near[0], "decode_positions_x_layers": -near[1],
                             "within": ROUTER_NEAR_TIE},
        "beam": {"prompt": MOE_BEAM_PROMPT, "n_tokens": MOE_BEAM_TOKENS, "beam_size": 4,
                 "score": float(np.asarray(beam_scores)[0]), "equal_to_solo": True},
        "score": {"len": MOE_SCORE_LEN, "from_pos": MOE_SCORE_FROM, "served": got_score,
                  "solo": want_score, "rel_diff": rel, "limit": SCORE_RTOL},
        "decode_iteration_profile": _profile_decode_iteration(model, rng, [128, 300, 512, 1000] * 2)}
    return report, windows


def _moe_phase(counted, device="cuda"):
    """MoE on one card: legs (a) ``moe_train_top1``/``moe_train_top2``,
    (b) the capacity sweep, (c) ``moe_serving`` with its ``moe_beam`` and
    ``moe_score`` windows. Returns ``(report, launch counts by window)``."""
    from distriflow_tpu_torch.models.convert import lm_from_jax, random_lm_tree

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 17)
    tree = random_lm_tree(_moe_config(1), rng)  # one tree for top-1 and top-2
    batches = _corpus_windows(_markov_corpus(CORPUS_TOKENS, SEED), MOE_B, MOE_S,
                              MOE_WARM + MOE_STEPS, SEED + 17)
    report, windows = {"config": {**MOE, "dtype": "bfloat16", "optimizer": "adam", "lr": 1e-3}}, {}
    for k in (1, 2):
        report[f"top{k}"], windows[f"moe_train_top{k}"] = _moe_train_leg(k, tree, batches, counted,
                                                                         device)
    report["expert_products"] = _expert_times(_moe_config(2), _flush_buffer(), device)
    sweep_cfg = dataclasses.replace(_moe_config(2), n_layers=1, dtype=torch.float32,
                                    use_flash_attention=False, use_flash_decode=False,
                                    loss="sparse_softmax_cross_entropy")
    xs = torch.as_tensor(rng.integers(0, MOE["vocab_size"], (MOE_B, MOE_S)), device=device)
    sweep = []
    for f in MOE_CAPACITY_SWEEP:
        model = lm_from_jax(dataclasses.replace(sweep_cfg, capacity_factor=f), tree, device=device)
        with torch.no_grad():
            model(xs)
        sweep.append({"capacity_factor": f,
                      "dropped_fraction": float(model.layers[0].moe.dropped_fraction)})
        del model
    drops = [r["dropped_fraction"] for r in sweep]
    assert drops == sorted(drops, reverse=True), sweep  # more capacity drops no more
    report["capacity_sweep"] = sweep
    report["serving"], serve_windows = _moe_serving_leg(tree, rng, counted, device)
    windows.update(serve_windows)
    report["phase_s"] = time.perf_counter() - t0
    return report, windows


# -- the mesh phase: the training layouts on torch.distributed -------------
#
# A world of MESH_WORLD ranks on cuda:0 (spawn, gloo: NCCL refuses two ranks
# on one card; collectives of CUDA tensors are staged through the host by
# parallel/collectives.py and counted), each leg at the flagship's widths
# (vocab 32000, d_model 512, 8 x 64 heads, d_ff 2048, bf16) cut to
# MESH_LAYERS layers, adam 1e-3, MESH_STEPS steps on the LM corpus's
# windows, from one seeded flax-shaped tree. This process runs each leg's
# single-rank reference from the same tree and batches while the world runs
# (the EP leg's after it: it is routed as the mesh routed).
MESH_WORLD, MESH_LAYERS, MESH_STEPS = 4, 2, 3
MESH_B, MESH_S, MESH_LONG_B, MESH_LONG_S = 8, 1024, 1, 16384
MESH_FA_K, MESH_FA_B, MESH_FA_ROUNDS = 4, 128, 2
MESH_DEADLINE_S = 600
# leg -> (mesh, rules, ZeRO level)
MESH_LEGS = {"dp4": ({"data": 4}, "REPLICATED_RULES", 2),
             "dp2_tp2": ({"data": 2, "model": 2}, "TRANSFORMER_TP_RULES", 1),
             "ring": ({"seq": 4}, "REPLICATED_RULES", 0),
             "ulysses": ({"seq": 4}, "REPLICATED_RULES", 0),
             "ep": ({"data": 2, "expert": 2}, "TRANSFORMER_TP_RULES", 0),
             "fedavg_mesh": ({"data": 4}, None, 0)}
# The mesh against one rank on the card, from the same tree and batches.
# The mesh rounds bf16 partial sums (a row-parallel matmul's, the ring's
# chunk outputs) at other points than one rank does, and sums the
# gradients over ranks in f32 in another order; adam normalises each
# gradient element, so an element whose gradient is near 0 may move by up
# to 2 x lr a step either way, and the largest parameter difference
# (reported: 3.0e-3 to 4.4e-3 on the H100) is as large as a whole update.
# What is held is the update: for each parameter, the distance between
# the mesh's and the reference's parameters over the reference update's
# size (Frobenius norms), which reads 1 for a parameter the mesh left
# where it started. Its limit lies between the sound legs' largest
# reading and what the dp4 leg's planted fault reads (the reference
# trained without data rank 3's rows, as if that rank's gradient were
# dropped); the run fails if that fault would pass. The loss limit is
# absolute, per step, every rank: the kernel step's against the plain
# step's (STEP_TOL). FedAvg runs the same kernels at the same shapes on
# each rank as the one-device trainer runs worker by worker, and sums the
# workers in the same order: it is held bit for bit.
MESH_TOL = {"loss_abs": 1e-3, "update_rel": 0.1}
# the legs whose ranks report ``cost_analysis`` and ``mfu`` (per device)
MESH_COST_LEGS = ("dp4", "dp2_tp2")
MESH_COLLECTIVES = ("psum", "all_gather", "reduce_scatter", "ppermute", "all_to_all")


def _kernel_counters():
    """The launch counter of every kernel wrapper, by name."""
    from distriflow_tpu_torch.ops import depthwise_gn as dg
    from distriflow_tpu_torch.ops import flash_attention as fa
    from distriflow_tpu_torch.ops import flash_decode as fd
    from distriflow_tpu_torch.ops import fused_ce as ce

    return {"flash_attention_fwd": fa.flash_attention,
            "flash_decode_paged": fd.flash_decode_paged,
            "flash_decode": fd.flash_decode,
            "flash_decode_paged_int8": fd.flash_decode_paged_int8,
            "flash_decode_int8": fd.flash_decode_int8,
            "flash_attention_bwd": fa.flash_attention_backward,
            "fused_ce_fwd": ce.fused_ce_forward,
            "fused_ce_bwd": ce.fused_ce_backward,
            "depthwise_gn_fwd": dg.depthwise_gn_forward,
            "depthwise_gn_bwd": dg.depthwise_gn_backward,
            "flash_attention_dq": fa.flash_attention_dq,
            "flash_attention_dkv": fa.flash_attention_dkv,
            "fused_ce_dense_fwd": ce.fused_ce_dense_forward,
            "fused_ce_dense_bwd": ce.fused_ce_dense_backward}


# the kernels built at two head dims also count their D 32 launches, and
# those built for two element types their f32 launches
_BY_HEAD_DIM = ("flash_attention_fwd", "flash_decode_paged", "flash_decode",
                "flash_attention_bwd", "flash_attention_dq", "flash_attention_dkv")
_BY_DTYPE = ("flash_attention_fwd", "flash_attention_bwd", "fused_ce_fwd", "fused_ce_bwd",
             "fused_ce_dense_fwd", "fused_ce_dense_bwd", "flash_decode", "flash_decode_paged",
             "flash_attention_dq", "flash_attention_dkv", "depthwise_gn_fwd", "depthwise_gn_bwd")


def _counted(run):
    """``(run(), counts)``: every counter set to 0 just before ``run`` and
    read just after it (``<name>_d32`` for the head-dim-32 launches,
    ``<name>_f32`` for the f32 ones)."""
    counters = _kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    for k in _BY_HEAD_DIM:
        counters[k].launches_by_head_dim = {}
    for k in _BY_DTYPE:
        counters[k].launches_by_dtype = {}
    out = run()
    counts = {k: fn.launches for k, fn in counters.items()}
    counts.update({f"{k}_d32": counters[k].launches_by_head_dim.get(32, 0) for k in _BY_HEAD_DIM})
    counts.update({f"{k}_f32": counters[k].launches_by_dtype.get("float32", 0) for k in _BY_DTYPE})
    return out, counts


def _mesh_cfg(leg):
    """The leg's model: the flagship's widths at MESH_LAYERS layers (B 8 S
    1024), at S 16384 with remat for ring and Ulysses, bench_moe's top-2
    shape for EP."""
    from distriflow_tpu_torch.models.zoo import flagship_lm_config

    if leg == "ep":
        return _moe_config(2)
    if leg in ("ring", "ulysses"):
        return dataclasses.replace(flagship_lm_config(max_seq=MESH_LONG_S), n_layers=MESH_LAYERS,
                                   remat=True, use_ring_attention=leg == "ring",
                                   use_ulysses_attention=leg == "ulysses")
    return dataclasses.replace(flagship_lm_config(max_seq=MESH_S), n_layers=MESH_LAYERS)


_MESH_DATA = {}


def _mesh_data(leg):
    """``(tree, batches)`` of a leg, made from seeds (the same in every
    process): LM windows of the CLI corpus, or FedAvg's round data."""
    if leg in _MESH_DATA:
        return _MESH_DATA[leg]
    if leg == "fedavg_mesh":
        tree = _convnet_tree(np.random.default_rng(SEED + 33))
        x, y = _to_xy(_synthetic_cifar10(MESH_WORLD * MESH_FA_K * MESH_FA_B * MESH_FA_ROUNDS,
                                         8, SEED + 33)[0])
        rng = np.random.RandomState(SEED + 34)
        n = MESH_WORLD * MESH_FA_K * MESH_FA_B
        rounds = []
        for _ in range(MESH_FA_ROUNDS):
            idx = rng.permutation(len(x))[:n]
            shape = (MESH_WORLD, MESH_FA_K, MESH_FA_B)
            rounds.append((x[idx].reshape(shape + x.shape[1:]), y[idx].reshape(shape + y.shape[1:])))
        out = (tree, rounds)
    else:
        cfg = _mesh_cfg(leg)
        corpus = _MESH_DATA.setdefault("corpus", _markov_corpus(CORPUS_TOKENS, SEED))
        long = leg in ("ring", "ulysses")
        b, s = (MESH_LONG_B, MESH_LONG_S) if long else (MOE_B, MOE_S) if leg == "ep" else (
            MESH_B, MESH_S)
        seed = SEED + (32 if leg == "ep" else 31 if long else 30)
        out = (_flagship_tree(cfg, np.random.default_rng(seed)),
               _corpus_windows(corpus, b, s, MESH_STEPS, seed))
    _MESH_DATA[leg] = out
    return out


def _mesh_windows(leg, cfg):
    """The exact launches of one rank's window: per step and layer kernel
    1 once (once per ring step around the ``seq`` ring, and again in the
    remat recompute), the backward of the layout ``bwd_layout`` gives the
    local attention, the fused CE forward and backward once where the
    mesh keeps it (``data``/``expert`` meshes); FedAvg the dense CE once
    each a local step."""
    from distriflow_tpu_torch.ops.flash_attention import bwd_layout

    if leg == "fedavg_mesh":
        n = MESH_FA_K * MESH_FA_ROUNDS
        return {"fused_ce_dense_fwd": n, "fused_ce_dense_bwd": n}
    shape = MESH_LEGS[leg][0]
    ring = shape.get("seq", 1) if leg == "ring" else 1
    s = MESH_LONG_S // ring if leg in ("ring", "ulysses") else MESH_S
    fwd = cfg.n_layers * ring * (2 if cfg.remat else 1)
    bwd = cfg.n_layers * ring
    out = {"flash_attention_fwd": fwd * MESH_STEPS}
    if bwd_layout(s, cfg.head_dim, cfg.dtype) == "fused":
        out["flash_attention_bwd"] = bwd * MESH_STEPS
    else:
        out["flash_attention_dq"] = out["flash_attention_dkv"] = bwd * MESH_STEPS
    if leg in ("dp4", "ep"):
        out["fused_ce_fwd"] = out["fused_ce_bwd"] = MESH_STEPS
    return out


def _mesh_leg(leg, rank, out_dir, device="cuda"):
    """One leg on this rank: its window's launch counts, losses, step
    times, host-staged bytes, and (rank 0) the gathered parameters."""
    import torch.distributed as dist

    from distriflow_tpu_torch.models.convert import params_from_jax, zoo_params_from_jax
    from distriflow_tpu_torch.models.transformer import transformer_lm
    from distriflow_tpu_torch.parallel import collectives, create_mesh, sharding
    from distriflow_tpu_torch.train.federated import FederatedAveragingTrainer
    from distriflow_tpu_torch.train.sync import SyncTrainer

    shape, rules, zero = MESH_LEGS[leg]
    mesh = create_mesh(shape, device)
    tree, batches = _mesh_data(leg)
    collectives.staged_bytes.clear()
    out = {"backend": dist.get_backend(), "mesh": shape}
    if leg == "fedavg_mesh":
        trainer = FederatedAveragingTrainer(_convnet_spec(device), mesh=mesh, local_steps=MESH_FA_K,
                                            local_batch_size=MESH_FA_B, learning_rate=FA_LR)
        trainer.init(SEED)
        trainer.set_params(zoo_params_from_jax(tree))

        def run():
            losses, ms = [], []
            for xs, ys in batches:
                t0 = time.perf_counter()
                losses.append(trainer.round(xs, ys))
                ms.append((time.perf_counter() - t0) * 1e3)
            return losses, ms

        (losses, ms), counts = _counted(run)
        params = {n: p.detach().cpu() for n, p in trainer.params.items()}
    else:
        cfg = _mesh_cfg(leg)
        trainer = SyncTrainer(transformer_lm(cfg, device=device, mesh=mesh), mesh=mesh, optimizer="adam",
                              learning_rate=1e-3, param_rules=getattr(sharding, rules),
                              zero_level=zero)
        trainer.init()
        trainer.set_params(params_from_jax(tree, cfg, masters=True))
        record, routes = {}, []
        hooks = _route_choices(trainer.model, record) if cfg.n_experts else []

        def run():
            losses, ms = [], []
            for x, y in batches:
                losses.append(trainer.step((x, y)))
                ms.append(trainer.last_step_ms)
                if hooks:
                    routes.append({i: r.cpu() for i, r in record.items()})
            return losses, ms

        (losses, ms), counts = _counted(run)
        for h in hooks:
            h.remove()
        if leg in MESH_COST_LEGS:  # outside the window: it launches the kernels
            cost = trainer.cost_analysis(batches[0])
            p50 = float(np.median(ms))
            out["cost"] = {**_cost_fields(cost), "kernel_by_category": cost["kernel_by_category"],
                           "kernel_tally_added": cost["kernel_tally_added"], "step_ms_p50": p50,
                           "mfu": trainer.mfu(batches[0], p50 / 1e3)}
        st = trainer.state
        out["opt_bytes"] = {n: sum(st.opt_state[k][n].numel() * st.opt_state[k][n].element_size()
                                   for k in ("mu", "nu")) for n in st.params}
        out["param_bytes"] = {n: p.numel() * p.element_size() for n, p in st.params.items()}
        out["zsliced"] = {n: n in trainer._zslices for n in st.params}
        out["routes"] = routes
        out["loss_name"] = trainer.spec.loss
        params = {n: p.cpu() for n, p in trainer.get_params().items()}  # every rank gathers
    if device == "cuda":
        torch.cuda.synchronize()
    out.update(losses=losses, step_ms=ms, counts=counts, staged_bytes=dict(collectives.staged_bytes))
    if rank == 0:
        torch.save(params, os.path.join(out_dir, f"{leg}.params.pt"))
    return out


def _mesh_rank(rank, port, out_dir, device="cuda"):
    """One rank of the mesh world: every leg, then each collective's
    latency at 4 MB over ``data`` of a ``{data 4}`` mesh."""
    import torch.distributed as dist

    from distriflow_tpu_torch.parallel import collective_latency_us, create_mesh, initialize

    torch.backends.cuda.matmul.allow_tf32 = False
    initialize(f"localhost:{port}", MESH_WORLD, rank, device=device, ranks_per_device=MESH_WORLD)
    try:
        res = {leg: _mesh_leg(leg, rank, out_dir, device) for leg in MESH_LEGS}
        res.update({leg: _pipe_leg(leg, rank, out_dir, device) for leg in PIPE_LEGS})
        res["ckpt"] = _ckpt_leg(rank, out_dir, device)
        res["tp"] = _tp_serve_leg(rank, out_dir, device)
        res["tp_spec"] = _tp_spec_leg(rank, out_dir, device)
        mesh = create_mesh({"data": MESH_WORLD}, device)
        res["latency_us"] = {c: collective_latency_us(mesh, 4 * 1024 * 1024, "data", iters=5,
                                                      collective=c) for c in MESH_COLLECTIVES}
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _mesh_reference(leg, routes=None, device="cuda", rows=None):
    """The leg on one rank of the card: ``(losses, params)``. ``routes``
    (the EP leg's, per step and layer, every data rank's rows in order)
    pins the MoE routing; ``rows`` (a slice) trains on those rows of each
    batch alone."""
    from distriflow_tpu_torch.models.convert import zoo_params_from_jax
    from distriflow_tpu_torch.train.federated import FederatedAveragingTrainer

    tree, batches = _mesh_data(leg)
    if leg == "fedavg_mesh":
        trainer = FederatedAveragingTrainer(_convnet_spec(device), local_steps=MESH_FA_K,
                                            local_batch_size=MESH_FA_B, learning_rate=FA_LR,
                                            num_workers=MESH_WORLD)
        trainer.init(SEED)
        trainer.set_params(zoo_params_from_jax(tree))
        losses = [trainer.round(xs, ys) for xs, ys in batches]
        return losses, {n: p.detach().cpu() for n, p in trainer.params.items()}
    cfg = dataclasses.replace(_mesh_cfg(leg), use_ring_attention=False, use_ulysses_attention=False)
    if rows is not None:
        batches = [(x[rows], y[rows]) for x, y in batches]
    if routes is None:
        trainer, losses, _ = _train(cfg, tree, batches, device)
    else:
        from distriflow_tpu_torch.models.convert import params_from_jax
        from distriflow_tpu_torch.models.transformer import transformer_lm
        from distriflow_tpu_torch.train.sync import SyncTrainer

        trainer = SyncTrainer(transformer_lm(cfg, device=device), optimizer="adam",
                              learning_rate=1e-3)
        trainer.init()
        trainer.set_params(params_from_jax(tree, cfg, masters=True))
        losses = []
        for step, (x, y) in enumerate(batches):
            _pin_routes(trainer.model, {i: r.to(device) for i, r in routes[step].items()})
            losses.append(trainer.step((x, y)))
    params = {n: p.cpu() for n, p in trainer.get_params().items()}
    del trainer
    return losses, params


def _mesh_start(leg, cfg):
    """The full parameters a leg starts from (its tree carried over)."""
    from distriflow_tpu_torch.models.convert import params_from_jax, zoo_params_from_jax

    tree = _mesh_data(leg)[0]
    if leg == "fedavg_mesh":
        return zoo_params_from_jax(tree)
    return params_from_jax(tree, cfg, masters=True)


def _mesh_kernel_entries():
    """Kernel 1 at the shapes the mesh legs give it, against its plain
    version (one head at a time) and SDPA: the ring's off-diagonal chunk
    pair (B1 H8 S4096, non-causal, the lse the merge reads) and Ulysses'
    local heads (B1 H2 S16384, causal). Row 1's ``ring_chunk`` and
    ``ulysses_local_heads``."""
    import torch.nn.functional as F

    from distriflow_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 35)
    flush = _flush_buffer()
    d, out = 64, {}
    ring = MESH_LEGS["ring"][0]["seq"]
    for key, h, s, causal in (("ring_chunk", 8, MESH_LONG_S // ring, False),
                              ("ulysses_local_heads", 8 // MESH_LEGS["ulysses"][0]["seq"],
                               MESH_LONG_S, True)):
        q, k, v = (torch.randn(1, h, s, d, generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        o, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)

        def plain(q=q, k=k, v=v, h=h, causal=causal):
            return [fa.flash_attention_reference(q[:, i:i + 1], k[:, i:i + 1], v[:, i:i + 1],
                                                 causal) for i in range(h)]

        ref = plain()
        ro, rl = torch.cat([r[0] for r in ref], 1), torch.cat([r[1] for r in ref], 1)
        del ref
        pairs = s * (s + 1) // 2 if causal else s * s
        tb, by = _bound(4 * h * s * d * 2 + h * s * 4, 4 * h * pairs * d, exps=h * pairs)
        out[key] = {
            "shape": f"B=1 H={h} S={s} D={d} {'causal' if causal else 'non-causal'}",
            "max_abs_err": _over(f"flash_attention_fwd O {key}", o, ro, *TOL["flash_attention_fwd"]),
            "lse_max_abs_err": _over(f"flash_attention_fwd lse {key}", lse, rl, LSE_ATOL, 0.0),
            "ms": _timed(lambda: fa.flash_attention(q, k, v, causal=causal, return_lse=True), 10,
                         flush),
            "plain_ms": _timed(plain, 1, flush), "bound_ms": tb, "bound_by": by,
            "library_ms": _timed(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal),
                                 10, flush)}
        del q, k, v, o, lse, ro, rl
    return out


def _update_rel(params, ref_params, start):
    """``{name: |params - ref| / |ref - start|}`` (Frobenius norms): each
    parameter's distance from the reference over the reference update."""
    out = {}
    for n, ref in ref_params.items():
        num = float((params[n].float() - ref.float()).norm())
        den = float((ref.float() - start[n].float()).norm())
        out[n] = num / den if den > 0 else (0.0 if num == 0 else math.inf)
    return out


def _mesh_vs_reference(leg, ranks, ref, params, start, planted=None):
    """The leg's losses (every rank) and rank 0's gathered parameters
    against the one-rank reference (``start``: the parameters both began
    from; ``planted``: the parameters of a planted fault, which the
    update check must catch)."""
    ref_losses, ref_params = ref
    loss_err = max(abs(a - b) for r in ranks for a, b in zip(r[leg]["losses"], ref_losses))
    diffs = {n: float((params[n].float() - ref_params[n].float()).abs().max()) for n in ref_params}
    worst = max(diffs, key=diffs.get)
    rel = _update_rel(params, ref_params, start)
    worst_rel = max(rel, key=rel.get)
    num = sum(float((params[n].float() - ref_params[n].float()).square().sum()) for n in ref_params)
    den = sum(float((ref_params[n].float() - start[n].float()).square().sum()) for n in ref_params)
    report = {"loss_max_abs_err": loss_err, "update_rel_max": rel[worst_rel],
              "update_rel_worst_param": worst_rel,
              "update_rel_frobenius": math.sqrt(num / max(den, 1e-30)),
              "param_max_abs_err": diffs[worst], "worst_param": worst,
              "losses": ranks[0][leg]["losses"], "ref_losses": ref_losses}
    if leg == "fedavg_mesh":
        report["bitwise"] = _same_bits(params, ref_params) and loss_err == 0.0
        assert report["bitwise"], ("the mesh FedAvg differs from the one-device trainer", report)
        return report
    if planted is not None:
        fault = _update_rel(planted, ref_params, start)
        report["planted_rank_dropped"] = {"max": max(fault.values()), "min": min(fault.values())}
        assert report["planted_rank_dropped"]["max"] > MESH_TOL["update_rel"], (
            "the update check would pass a dropped data rank", leg, report)
    assert loss_err <= MESH_TOL["loss_abs"], (leg, report)
    assert rel[worst_rel] <= MESH_TOL["update_rel"], (leg, report)
    return report


def _mesh_phase(serve_ref, spec_draft, device="cuda"):
    """The ``mesh:`` phase (see MESH_LEGS and PIPE_LEGS): spawn the world,
    run the references alongside, check every leg. ``serve_ref``: the 2k
    phase's ``(one-rank model, tree, requests, solo outputs)``, which the
    TP legs are held to; ``spec_draft``: the speculative phase's distilled
    draft, which the ``tp_spec`` leg serves with. Returns ``(report,
    {window: rank 0's counts})``."""
    import shutil

    import tempfile

    import torch.multiprocessing as mp

    from distriflow_tpu_torch.parallel import backend_for

    t0 = time.perf_counter()
    ctx = mp.get_context("spawn")
    out_dir = tempfile.mkdtemp(prefix="mesh-")
    torch.save({n: t.detach().cpu() for n, t in spec_draft.state_dict().items()},
               os.path.join(out_dir, "spec_draft.pt"))
    port = _free_port()
    procs = [ctx.Process(target=_mesh_rank, args=(r, port, out_dir, device))
             for r in range(MESH_WORLD)]
    for p in procs:
        p.start()
    try:
        refs = {leg: _mesh_reference(leg, device=device) for leg in ("dp4", "ring", "fedavg_mesh")}
        refs["dp2_tp2"], refs["ulysses"] = refs["dp4"], refs["ring"]  # same model, tree, batches
        # the planted fault: dp4 as if data rank 3's gradient were dropped
        dp = MESH_LEGS["dp4"][0]["data"]
        planted = _mesh_reference("dp4", device=device, rows=slice(0, MESH_B - MESH_B // dp))[1]
        # the pipeline legs' reference (every leg: one tree, one batch
        # stream), and its planted fault: the last microbatch's gradient
        # dropped (the reference trained without those rows)
        pipe_tree, pipe_batches = _pipe_data()
        pipe_ref = _pipe_reference(pipe_tree, pipe_batches, device)
        last = MESH_B // PIPE_LEGS["pp4_gpipe"][2]
        pipe_planted = _pipe_reference(pipe_tree, [(x[:-last], y[:-last]) for x, y in pipe_batches],
                                       device)[1]
        end = time.monotonic() + MESH_DEADLINE_S
        for p in procs:
            p.join(max(0.0, end - time.monotonic()))
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    assert not hung, f"mesh ranks {hung} outlived {MESH_DEADLINE_S} s"
    codes = [p.exitcode for p in procs]
    assert not any(codes), f"a mesh rank failed: exit codes {codes}"
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
             for r in range(MESH_WORLD)]
    world_s = time.perf_counter() - t0
    # the EP reference routed as the mesh routed: ranks 0 and 2 hold data
    # rows 0-3 and 4-7 ({data 2, expert 2}, row-major)
    ep_routes = [{i: torch.cat([ranks[0]["ep"]["routes"][s][i], ranks[2]["ep"]["routes"][s][i]])
                  for i in ranks[0]["ep"]["routes"][s]} for s in range(MESH_STEPS)]
    refs["ep"] = _mesh_reference("ep", ep_routes, device)
    report = {"world": MESH_WORLD, "layers": MESH_LAYERS, "steps": MESH_STEPS, "tol": MESH_TOL,
              "note": "4 ranks sharing one H100 over gloo: not a multi-card figure",
              "latency_us_4MB": ranks[0]["latency_us"], "legs": {}}
    windows, expected = {}, {}
    for leg, (shape, rules, zero) in MESH_LEGS.items():
        params = torch.load(os.path.join(out_dir, f"{leg}.params.pt"), weights_only=False)
        cfg = None if leg == "fedavg_mesh" else _mesh_cfg(leg)
        want = _mesh_windows(leg, cfg)
        for r, res in enumerate(ranks):
            got = {k: n for k, n in res[leg]["counts"].items() if n}
            assert got == want, (f"mesh_{leg}", f"rank {r}", got, want)
            assert res[leg]["backend"] == backend_for(device, MESH_WORLD) == "gloo", res[leg]
        expected[f"mesh_{leg}"] = want
        rec = {"mesh": shape, "rules": rules, "zero_level": zero, "backend": ranks[0][leg]["backend"],
               "launches_per_rank": want,
               "step_ms_p50_by_rank": [float(np.median(r[leg]["step_ms"])) for r in ranks],
               "staged_bytes": ranks[0][leg]["staged_bytes"],
               **_mesh_vs_reference(leg, ranks, refs[leg], params, _mesh_start(leg, cfg),
                                    planted if leg == "dp4" else None)}
        if leg != "fedavg_mesh":
            rec["loss"] = ranks[0][leg]["loss_name"]
            sliced = 0
            for res in ranks:  # ZeRO: a sliced leaf's moments are 1/data of replicated
                for n, nbytes in res[leg]["opt_bytes"].items():
                    full = 2 * res[leg]["param_bytes"][n]
                    if res[leg]["zsliced"][n]:
                        assert nbytes * shape["data"] == full, (leg, n, nbytes, full)
                        sliced += 1
                    else:
                        assert nbytes == full, (leg, n, nbytes, full)
            assert (sliced > 0) == (zero > 0), (leg, sliced)
            rec["opt_state_bytes_rank0"] = sum(ranks[0][leg]["opt_bytes"].values())
            rec["opt_state_bytes_replicated"] = 2 * sum(ranks[0][leg]["param_bytes"].values())
        if leg in MESH_COST_LEGS:
            rec["cost_by_rank"] = _mesh_cost_check(leg, cfg, ranks)
        report["legs"][leg] = rec
        windows[f"mesh_{leg}"] = ranks[0][leg]["counts"]
    for leg in PIPE_LEGS:
        report["legs"][leg] = _pipe_check(ranks, pipe_ref, pipe_planted, leg, out_dir)
        windows[f"mesh_{leg}"] = ranks[0][leg]["counts"]
        expected[f"mesh_{leg}"] = report["legs"][leg]["launches_per_rank"]
    report["pipe_memory"] = _pipe_memory_order(report["legs"])
    report["legs"]["ckpt"] = _ckpt_check(ranks)
    tp = ranks[0]["tp"]
    stats = {k: tp[k]["stats"] for k in ("tp_serve", "tp_serve_int8")}
    want = _tp_windows(stats, _tp_cfg())
    for key, w in want.items():
        for r, res in enumerate(ranks):
            got = {k: n for k, n in res["tp"]["windows"][key].items() if n}
            assert got == w, (f"mesh_{key}", f"rank {r}", got, w)
        windows[f"mesh_{key}"] = tp["windows"][key]
        expected[f"mesh_{key}"] = w
    report["legs"]["tp_serve"] = {
        "mesh": TP_SERVE_MESH, "rules": "TRANSFORMER_TP_RULES", "layers": _tp_cfg().n_layers,
        "local_heads": tp["local_heads"], "launches_per_rank": want,
        "follower_ops": [r["tp"].get("tp_serve_follower_ops") for r in ranks[1:]],
        "stats": {k: {q: v[q] for q in ("prefills", "decode_steps", "decode_batches",
                                       "prefix_hits", "ttft_ms_p50", "tpot_ms_p50")}
                  for k, v in stats.items()},
        "vs_one_rank": _tp_check(serve_ref, tp)}
    spec_rec, spec_windows, spec_expected = _tp_spec_check(ranks, device)
    report["legs"]["tp_spec"] = spec_rec
    windows.update(spec_windows)
    expected.update(spec_expected)
    report["windows_expected"] = expected
    report["phase_s"] = time.perf_counter() - t0
    report["world_s"] = world_s
    shutil.rmtree(out_dir, ignore_errors=True)
    return report, windows


def _tp_cfg():
    from distriflow_tpu_torch.models.zoo import flagship_lm_config

    return flagship_lm_config()


def _pipe_reference(tree, batches, device="cuda"):
    """The pipeline legs' model on one rank: ``(losses, parameters)``."""
    trainer, losses, _ = _train(_pipe_cfg(), tree, batches, device)
    params = {n: p.cpu() for n, p in trainer.get_params().items()}
    del trainer
    return losses, params


def _ckpt_check(ranks):
    """The ckpt leg: every rank restored, the restored state the saved one
    bit for bit, the next step's loss within MESH_TOL of the saver's, the
    shard files the state's unique bytes, and both planted faults caught."""
    res = [r["ckpt"] for r in ranks]
    loss_err = max(abs(r["next_loss_saver"] - r["next_loss_restored"]) for r in res)
    rec = {"saved_on": MESH_LEGS["dp2_tp2"][0], "restored_on": {"data": MESH_WORLD},
           "zero_level": 1, "state_bytes": res[0]["state_bytes"], "disk_bytes": res[0]["disk_bytes"],
           "save_s": res[0]["save_s"], "restore_s": res[0]["restore_s"],
           "next_loss_abs_err": loss_err,
           "planted_flipped_byte_caught": all(not r["flipped_equal"] for r in res),
           "planted_missing_shard_raised": [r["missing_raised"] for r in res]}
    assert all(r["restored"] and r["restored_equal"] for r in res), ("ckpt restore", rec)
    assert loss_err <= MESH_TOL["loss_abs"], ("ckpt next step", rec)
    assert rec["disk_bytes"] == rec["state_bytes"], ("ckpt bytes on disk", rec)
    assert rec["planted_flipped_byte_caught"], ("a flipped shard byte restored unseen", rec)
    assert all(rec["planted_missing_shard_raised"]), ("a missing shard restored", rec)
    return rec


# -- the mesh phase's second half: the pipeline, sharded checkpoints and
# TP-sharded decoding and serving ------------------------------------------
#
# The same world runs these legs after the training layouts. The pipeline
# legs train the flagship at all 8 layers (B 8 S 1024, adam 1e-3,
# MESH_STEPS steps, the plain sparse CE a mesh with pipe > 1 resolves to)
# from JAX-shaped pipelined trees of one seed (`random_pipelined_lm_tree`:
# the same layers stacked into each leg's stages); this process trains
# the flat tree of that seed on one rank as their reference.
# leg -> (mesh, schedule, microbatches)
PIPE_LEGS = {"pp4_gpipe": ({"pipe": 4}, "gpipe", 4),
             "pp4_remat": ({"pipe": 4}, "remat", 4),
             "pp4_1f1b": ({"pipe": 4}, "1f1b", 4),
             "dp2_pp2": ({"data": 2, "pipe": 2}, "gpipe", 2),
             "pp2_tp2": ({"pipe": 2, "model": 2}, "gpipe", 2)}
# the microbatch counts whose step memory the {pipe 4} legs report
PIPE_MEM_M = (4, 8)
# 1F1B's step memory at M 8 over M 4: "flat" (JAX's test holds 8x the
# microbatches under 3x the temp memory)
PIPE_FLAT = 1.1
PIPE_SEED = SEED + 36
TP_SERVE_MESH = {"data": 2, "model": 2}
# the TP legs' lengths: the beam's tokens and width, the planted fault's
TP_BEAM = (16, 4)
TP_PLANTED_TOKENS = 16
# |a TP beam's score - one rank's teacher-forced score of its tokens| (16
# tokens, bf16): the one earlier reading put a TP beam 0.034 from one
# rank's best (H100 80GB HBM3, 700 W); the limit leaves about 3x
BEAM_SCORE_TOL = 0.1


def _pipe_cfg():
    from distriflow_tpu_torch.models.zoo import flagship_lm_config

    return dataclasses.replace(flagship_lm_config(max_seq=MESH_S),
                               loss="sparse_softmax_cross_entropy")


def _pipe_data():
    """``(flat tree, batches)`` of every pipeline leg (the same in every
    process)."""
    if "pipe" not in _MESH_DATA:
        cfg = _pipe_cfg()
        corpus = _MESH_DATA.setdefault("corpus", _markov_corpus(CORPUS_TOKENS, SEED))
        _MESH_DATA["pipe"] = (_flagship_tree(cfg, np.random.default_rng(PIPE_SEED)),
                              _corpus_windows(corpus, MESH_B, MESH_S, MESH_STEPS, PIPE_SEED))
    return _MESH_DATA["pipe"]


def _pipe_windows(leg, cfg):
    """The exact launches of one rank's window of a pipeline leg: every
    tick of the M + P - 1 runs the stage's blocks (kernel 1 each, zeros in
    the bubbles) and, under gpipe, each tick's backward (kernel 6, or the
    two-kernel backward past 8 KV blocks); remat re-runs every tick's
    forward in its backward; 1F1B recomputes each microbatch's forward
    twice in its backward (the forward wave and the re-linearisation)
    and runs M backwards."""
    from distriflow_tpu_torch.ops.flash_attention import bwd_layout

    shape, sched, m = PIPE_LEGS[leg]
    p = shape["pipe"]
    per = cfg.n_layers // p
    ticks = m + p - 1
    fwd = {"gpipe": ticks, "remat": 2 * ticks, "1f1b": ticks + 2 * m}[sched] * per
    bwd = (m if sched == "1f1b" else ticks) * per
    out = {"flash_attention_fwd": fwd * MESH_STEPS}
    if bwd_layout(MESH_S, cfg.head_dim, cfg.dtype) == "fused":
        out["flash_attention_bwd"] = bwd * MESH_STEPS
    else:
        out["flash_attention_dq"] = out["flash_attention_dkv"] = bwd * MESH_STEPS
    return out


def _pipe_trainer(leg, mesh, cfg, m, device):
    from distriflow_tpu_torch.models.convert import (
        pipelined_params_from_jax,
        random_pipelined_lm_tree,
    )
    from distriflow_tpu_torch.models.transformer import pipelined_transformer_lm
    from distriflow_tpu_torch.parallel import sharding
    from distriflow_tpu_torch.train.sync import SyncTrainer

    shape, sched, _ = PIPE_LEGS[leg]
    spec = pipelined_transformer_lm(dataclasses.replace(cfg, pipeline_schedule=sched),
                                    device=device, mesh=mesh, num_microbatches=m)
    trainer = SyncTrainer(spec, mesh=mesh, optimizer="adam", learning_rate=1e-3,
                          param_rules=sharding.PIPELINED_TRANSFORMER_RULES)
    trainer.init()
    p = shape["pipe"]
    tree = random_pipelined_lm_tree(cfg, p, np.random.default_rng(PIPE_SEED))
    trainer.set_params(pipelined_params_from_jax(tree, cfg, p, masters=True))
    return trainer


def _step_memory(trainer, batch, device):
    """One step: ``(loss, (its peak bytes, the peak over what the step
    started with))`` (zeros off CUDA)."""
    if device != "cuda":
        return trainer.step(batch), (0, 0)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loss = trainer.step(batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return loss, (peak, peak - base)


def _pipe_leg(leg, rank, out_dir, device="cuda"):
    """One pipeline leg on this rank: its window's counts, losses, step
    times, the step memory at each of PIPE_MEM_M ({pipe 4} legs) and (rank
    0) the gathered parameters, unstacked into the plain LM's layers."""
    from distriflow_tpu_torch.models.convert import pipelined_to_layers
    from distriflow_tpu_torch.parallel import collectives, create_mesh

    shape, sched, m = PIPE_LEGS[leg]
    mesh = create_mesh(shape, device)
    cfg = _pipe_cfg()
    batches = _pipe_data()[1]
    collectives.staged_bytes.clear()
    trainer = _pipe_trainer(leg, mesh, cfg, m, device)
    mem = {}

    def run():
        losses, ms = [], []
        for i, (x, y) in enumerate(batches):
            if i == len(batches) - 1 and shape == {"pipe": 4}:
                loss, mem[m] = _step_memory(trainer, (x, y), device)
                losses.append(loss)
            else:
                losses.append(trainer.step((x, y)))
            ms.append(trainer.last_step_ms)
        return losses, ms

    (losses, ms), counts = _counted(run)
    out = {"losses": losses, "step_ms": ms, "counts": counts, "loss_name": trainer.spec.loss,
           "staged_bytes": dict(collectives.staged_bytes), "schedule": sched}
    params = {n: p.cpu() for n, p in trainer.get_params().items()}
    del trainer
    if shape == {"pipe": 4}:
        for mm in PIPE_MEM_M:
            if mm not in mem:
                t = _pipe_trainer(leg, mesh, cfg, mm, device)
                mem[mm] = _step_memory(t, batches[0], device)[1]
                del t
        out["step_mem"] = {str(k): v for k, v in mem.items()}
    if device == "cuda":
        torch.cuda.empty_cache()
    if rank == 0:
        torch.save(pipelined_to_layers(params, shape["pipe"]),
                   os.path.join(out_dir, f"{leg}.params.pt"))
    return out


def _state_bytes(tree):
    """The bytes of every leaf of a (full) state tree: each unique element
    of the state once."""
    if isinstance(tree, dict):
        return sum(_state_bytes(v) for v in tree.values())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return np.asarray(tree).nbytes


def _ckpt_leg(rank, out_dir, device="cuda"):
    """The dp2_tp2 ZeRO-1 trainer saves a sharded checkpoint after one
    step and takes its next step; a trainer on {data 4} restores it (the
    reshard path) and takes the same next step. Then the planted faults:
    a copy with one flipped byte in a shard file (the restored state must
    differ from the saved) and one with a shard file missing (restore
    must raise)."""
    import shutil

    import torch.distributed as dist

    from distriflow_tpu_torch.models.convert import params_from_jax
    from distriflow_tpu_torch.models.transformer import transformer_lm
    from distriflow_tpu_torch.parallel import create_mesh, sharding
    from distriflow_tpu_torch.train.sync import SyncTrainer

    cfg = _mesh_cfg("dp2_tp2")
    tree, batches = _mesh_data("dp2_tp2")
    root = os.path.join(out_dir, "ckpt")

    def trainer(shape, d, seed=0):
        mesh = create_mesh(shape, device)
        t = SyncTrainer(transformer_lm(cfg, device=device, mesh=mesh), mesh=mesh, optimizer="adam",
                        learning_rate=1e-3, param_rules=sharding.TRANSFORMER_TP_RULES,
                        zero_level=1, checkpoint_dir=d, sharded_checkpoints=True)
        t.init(seed)
        return t

    saver = trainer(MESH_LEGS["dp2_tp2"][0], os.path.join(root, "main"))
    saver.set_params(params_from_jax(tree, cfg, masters=True))
    saver.step(batches[0])
    t0 = time.perf_counter()
    version = saver.save(wait=True)
    save_s = time.perf_counter() - t0
    full = saver._full_state_tree()
    saved = {k: v for k, v in full.items()}
    out = {"version": version, "save_s": save_s, "state_bytes": _state_bytes(full)}
    out["next_loss_saver"] = saver.step(batches[1])
    saver.close()
    del saver
    vdir = os.path.join(root, "main", version)
    if rank == 0:
        out["disk_bytes"] = sum(os.path.getsize(os.path.join(vdir, f))
                                for f in os.listdir(vdir) if f.startswith("shards."))
        # the planted copies: one byte flipped in the middle of rank 1's
        # shard file; rank 2's shard file missing
        for name in ("flip", "missing"):
            shutil.copytree(os.path.join(root, "main"), os.path.join(root, name), symlinks=True)
        path = os.path.join(root, "flip", version, "shards.1.bin")
        with open(path, "r+b") as f:
            f.seek(os.path.getsize(path) // 2)
            b = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([b[0] ^ 0x40]))
        os.remove(os.path.join(root, "missing", version, "shards.2.bin"))
    dist.barrier()
    again = trainer({"data": MESH_WORLD}, os.path.join(root, "main"), seed=5)
    t0 = time.perf_counter()
    out["restored"] = again.restore(version)
    out["restore_s"] = time.perf_counter() - t0
    out["restored_equal"] = _same_bits(_flat_state(again._full_state_tree()), _flat_state(saved))
    out["next_loss_restored"] = again.step(batches[1])
    again.close()
    del again
    flip = trainer({"data": MESH_WORLD}, os.path.join(root, "flip"), seed=5)
    flip.restore(version)
    out["flipped_equal"] = _same_bits(_flat_state(flip._full_state_tree()), _flat_state(saved))
    flip.close()
    del flip
    missing = trainer({"data": MESH_WORLD}, os.path.join(root, "missing"), seed=5)
    try:
        missing.restore(version)
        out["missing_raised"] = None
    except OSError as e:
        out["missing_raised"] = type(e).__name__
    missing.close()
    del missing
    dist.barrier()
    if rank == 0:
        shutil.rmtree(root)
    return out


def _flat_state(tree, prefix=""):
    """A state tree's tensors by path, on the host."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_state(v, f"{prefix}{k}/"))
        elif isinstance(v, torch.Tensor):
            out[f"{prefix}{k}"] = v.detach().cpu()
    return out


def _tp_serve_leg(rank, out_dir, device="cuda"):
    """The full flagship (8 layers) on {data 2, model 2} under
    TRANSFORMER_TP_RULES: rank 0 serves the 8 requests of the 2k phase
    (the others follow), then every rank runs a bf16 and an int8_force
    ``generate``, a beam and an int8_force server wave of 2 requests, each
    in a window of its own; then the planted fault (every rank skips the
    ``o_proj`` psum) generates and searches once more."""
    from distriflow_tpu_torch.client.inference_client import InferenceClient
    from distriflow_tpu_torch.models import transformer as tr
    from distriflow_tpu_torch.models.convert import lm_from_jax
    from distriflow_tpu_torch.models.generate import beam_search, generate
    from distriflow_tpu_torch.models.zoo import flagship_lm_config
    from distriflow_tpu_torch.obs.telemetry import Telemetry
    from distriflow_tpu_torch.parallel import create_mesh
    from distriflow_tpu_torch.server.inference_server import InferenceServer

    cfg = flagship_lm_config()
    rng = np.random.default_rng(SEED)  # the 2k phase's tree and requests
    tree = _flagship_tree(cfg, rng)
    reqs = _requests(rng, cfg.vocab_size)
    mesh = create_mesh(TP_SERVE_MESH, device)
    model = lm_from_jax(cfg, tree, device=device, mesh=mesh)
    int8 = lm_from_jax(dataclasses.replace(cfg, kv_cache_dtype="int8_force"), tree,
                       device=device, mesh=mesh)
    out, windows = {"local_heads": model.local_heads}, {}

    def serve(m, wave, key):
        server = InferenceServer(m, telemetry=Telemetry())
        if rank:
            _, windows[key] = _counted(server.follow)
            out[f"{key}_follower_ops"] = server.follower_ops
            return
        server.setup()
        clients = [InferenceClient(server.address, timeout=600).setup() for _ in wave]
        try:
            (outs, stats), windows[key] = _counted(lambda: _generate_wave(server, clients, wave))
        finally:
            for c in clients:
                c.close()
            server.stop()
        out[key] = {"outs": {k: np.asarray(v) for k, v in outs.items()}, "stats": stats}

    serve(model, reqs, "tp_serve")
    name, prompt, _ = reqs[3]
    out["generate"], windows["tp_generate"] = _counted(
        lambda: generate(model, prompt, N_TOKENS).cpu())
    out["generate_int8"], windows["tp_generate_int8"] = _counted(
        lambda: generate(int8, prompt, N_TOKENS).cpu())
    n_beam, width = TP_BEAM
    (toks, scores), windows["tp_beam"] = _counted(
        lambda: beam_search(model, reqs[0][1], n_beam, beam_size=width))
    out["beam"] = (toks.cpu(), scores.cpu())
    serve(int8, reqs[1:3], "tp_serve_int8")
    reduce = tr.Attention._reduce
    tr.Attention._reduce = lambda self, x: x  # the planted fault: no o_proj psum
    try:
        out["planted"] = generate(model, reqs[0][1], TP_PLANTED_TOKENS).cpu()
        toks, scores = beam_search(model, reqs[0][1], n_beam, beam_size=width)
        out["planted_beam"] = (toks.cpu(), scores.cpu())
    finally:
        tr.Attention._reduce = reduce
    out["windows"] = windows
    return out


def _tp_windows(stats, cfg):
    """The exact windows of the TP legs (every rank the same): a fresh
    prefill launches kernel 1 once a layer, a decode step the decode
    kernel once a layer."""
    n = cfg.n_layers
    n_beam, _ = TP_BEAM
    return {"tp_serve": {"flash_attention_fwd": n * stats["tp_serve"]["prefills"],
                         "flash_decode_paged": n * stats["tp_serve"]["decode_steps"]},
            "tp_generate": {"flash_attention_fwd": n, "flash_decode": n * (N_TOKENS - 1)},
            "tp_generate_int8": {"flash_attention_fwd": n,
                                 "flash_decode_int8": n * (N_TOKENS - 1)},
            "tp_beam": {"flash_attention_fwd": n, "flash_decode": n * (n_beam - 1)},
            "tp_serve_int8": {"flash_attention_fwd": n * stats["tp_serve_int8"]["prefills"],
                              "flash_decode_paged_int8":
                                  n * stats["tp_serve_int8"]["decode_steps"]}}


def _decode_logprob(model, prompt, gen):
    """One rank's teacher-forced score of ``gen`` [1, n] after ``prompt``
    on the path a beam scores on: the prefill, then one slab decode step a
    token, summing the log-softmax of the f32 decode logits."""
    from distriflow_tpu_torch.models.generate import _int8_for

    gen = gen.to(model.device)
    logits, cache = model.decode(prompt, int8=_int8_for(model.config,
                                                        prompt.shape[1] + gen.shape[1]))
    total = 0.0
    for t in range(gen.shape[1]):
        total += float(torch.log_softmax(logits[0, -1].float(), dim=-1)[int(gen[0, t])])
        if t + 1 < gen.shape[1]:
            logits, cache = model.decode(gen[:, t:t + 1], cache)
    return total


def _beam_verdict(model, prompt, got, ref):
    """A TP beam ``got = (tokens, scores)`` against one rank's ``ref`` on
    the same prompt (length penalty 0: a score is the sum of its tokens'
    log-probabilities). Its score must be one rank's teacher-forced score
    of its own tokens within BEAM_SCORE_TOL. Its tokens must equal one
    rank's, or differ at a near tie: the first differing step, where one
    rank's logits of the two tokens after their common prefix lie within
    NEAR_TIE, or the whole beams, whose one-rank scores lie within
    NEAR_TIE (the TP beam no worse than that below one rank's best; beam
    search ranks whole beams, so a tie there also flips the winner)."""
    toks, scores = got
    ref_toks, ref_scores = (t.cpu() for t in ref)
    p = prompt.shape[1]
    gen, ref_gen = toks[:, p:], ref_toks[:, p:]
    rescored = _decode_logprob(model, prompt, gen)
    rep = {"score": float(scores[0]), "ref_score": float(ref_scores[0]),
           "one_rank_score_of_its_tokens": rescored,
           "score_err": abs(float(scores[0]) - rescored), "within": BEAM_SCORE_TOL,
           "equal": torch.equal(toks, ref_toks)}
    ok = rep["score_err"] < BEAM_SCORE_TOL
    if not rep["equal"]:
        t = int((gen != ref_gen).nonzero()[0, 1])
        logits, _ = model.decode(torch.cat([prompt, ref_gen[:, :t].to(model.device)], dim=1))
        last = logits[0, -1].float()
        step_margin = abs(float(last[int(ref_gen[0, t])] - last[int(gen[0, t])]))
        beam_gap = rep["ref_score"] - rescored
        rep.update(first_mismatch=t, step_margin=step_margin, beam_gap=beam_gap,
                   near_tie=NEAR_TIE)
        ok = ok and (step_margin < NEAR_TIE or beam_gap < NEAR_TIE)
    rep["ok"] = ok
    return rep


def _tp_check(serve_ref, tp):
    """The TP legs against one rank on the card: the served greedy tokens
    and each generate under the near-tie rule, the beam
    (:func:`_beam_verdict`), the int8 wave, and the planted fault, whose
    generate must diverge and whose beam must fail the verdict."""
    from distriflow_tpu_torch.models.convert import lm_from_jax
    from distriflow_tpu_torch.models.generate import beam_search, generate

    model, tree, reqs, solos = serve_ref
    cfg = model.config
    int8 = lm_from_jax(dataclasses.replace(cfg, kv_cache_dtype="int8_force"), tree,
                       device=model.device)
    report = {"serve": _check_greedy(model, reqs, tp["tp_serve"]["outs"], solos, N_TOKENS)}
    name, prompt, _ = reqs[3]
    report["generate"] = _check_greedy(model, [reqs[3]], {name: tp["generate"]}, solos,
                                       N_TOKENS)[name]
    solo8 = {n: generate(int8, p, N_TOKENS).cpu() for n, p, _ in reqs[1:4]}
    report["generate_int8"] = _check_greedy(int8, [reqs[3]], {name: tp["generate_int8"]},
                                            solo8, N_TOKENS)[name]
    report["serve_int8"] = _check_greedy(int8, reqs[1:3], tp["tp_serve_int8"]["outs"], solo8,
                                         N_TOKENS)
    n_beam, width = TP_BEAM
    prompt0 = torch.as_tensor(reqs[0][1], device=model.device)
    ref = beam_search(model, prompt0, n_beam, beam_size=width)
    report["beam"] = _beam_verdict(model, prompt0, tp["beam"], ref)
    assert report["beam"]["ok"], ("tp beam", report["beam"])
    report["planted_beam_no_o_proj_psum"] = _beam_verdict(model, prompt0, tp["planted_beam"], ref)
    assert not report["planted_beam_no_o_proj_psum"]["ok"], (
        "the TP beam check would pass a rank skipping the o_proj psum",
        report["planted_beam_no_o_proj_psum"])
    p0 = reqs[0][1].shape[1]
    planted = tp["planted"]
    want = solos[reqs[0][0]][:, :p0 + TP_PLANTED_TOKENS]
    report["planted_no_o_proj_psum"] = {"tokens_differing": int((planted != want).sum())}
    assert not torch.equal(planted, want), "the TP check would pass a rank skipping the o_proj psum"
    del int8
    return report


def _mesh_cost_check(leg, cfg, ranks):
    """Each rank's ``cost_analysis`` of a ``MESH_COST_LEGS`` leg and its
    ``mfu`` at the rank's step p50: the kernel tally added once on the
    card, and equal to the analytic cost of this rank's launches: per
    layer one flash forward and one backward of its layout over its local
    rows and heads, and, where the mesh keeps it (``data`` meshes), the
    fused sparse CE over its local rows. The MFU is 4 ranks sharing one
    card over host-staged gloo, each rank's per-device FLOPs over its own
    step time and one card's peak: not a multi-card figure."""
    from distriflow_tpu_torch.ops.flash_attention import bwd_layout

    shape = MESH_LEGS[leg][0]
    b = MESH_B // shape.get("data", 1)
    h = cfg.n_heads // shape.get("model", 1)
    unit = 2 * b * h * MESH_S * MESH_S * cfg.head_dim // 2  # one causal matmul
    bwd_hw = 5 if bwd_layout(MESH_S, cfg.head_dim, cfg.dtype) == "fused" else 7
    ce = 8 * b * MESH_S * cfg.vocab_size if "fused_ce_fwd" in _mesh_windows(leg, cfg) else 0
    want = (cfg.n_layers * 6 * unit + ce, cfg.n_layers * (2 + bwd_hw) * unit + ce)
    out = []
    for r, res in enumerate(ranks):
        cost = res[leg]["cost"]
        rec = {**cost, "expected_kernel_flops": want[0], "expected_kernel_hw_flops": want[1],
               "note": "4 ranks sharing one H100 over gloo: per-device FLOPs over one card's "
                       "peak, not a multi-card figure"}
        assert cost["kernel_tally_added"] and cost["flops"] == \
            cost["aten_flops"] + cost["kernel_flops"], (leg, r, rec)
        assert (cost["kernel_flops"], cost["kernel_hw_flops"]) == want, (leg, r, rec)
        assert math.isfinite(cost["mfu"]) and cost["mfu"] > 0, (leg, r, rec)
        out.append(rec)
    return out


# the tp_spec leg's planted fault: the rank whose drafts are altered, and
# the tokens of its request
TP_SPEC_PLANTED_RANK, TP_SPEC_PLANTED_TOKENS = 2, 16


def _tp_spec_leg(rank, out_dir, device="cuda"):
    """Speculative serving over TP_SERVE_MESH (TRANSFORMER_TP_RULES: 2 of
    SPEC_TARGET's 4 heads a rank), from the speculative phase's seeded
    tree and prompt (the 1k context), on the paged server of
    ``_spec_serve`` (SPEC_SLOTS slots, page SPEC_PS, no prefix sharing).
    Rank 0 serves, the others follow; each server's whole life is a
    launch window on every rank:

    - ``tp_spec``: the distilled ``lm_draft`` (whole on every rank, D 32),
      k SPEC_K: a 3-token priming request, a 1-token one, the greedy B 1
      request of SPEC_NEW tokens (ms/token their difference over
      SPEC_NEW - 1 tokens), then SPEC_SAMPLED twice and with another
      seed;
    - ``tp_plain``: the greedy request on a plain TP server;
    - ``tp_spec_self``: ``draft_model="self"`` (the TP target on its local
      heads), the greedy request;
    - then, in no window, the planted fault: rank TP_SPEC_PLANTED_RANK
      alters its drafts before the verify."""
    from distriflow_tpu_torch.client.inference_client import InferenceClient
    from distriflow_tpu_torch.models.convert import lm_from_jax
    from distriflow_tpu_torch.models.generate import pages_per_slot
    from distriflow_tpu_torch.models.transformer import TransformerLM
    from distriflow_tpu_torch.models.zoo import draft_config_for
    from distriflow_tpu_torch.obs.telemetry import Telemetry
    from distriflow_tpu_torch.parallel import create_mesh
    from distriflow_tpu_torch.server.inference_server import InferenceServer
    from distriflow_tpu_torch.utils.config import ServingConfig

    cfg = _spec_config()
    rng = np.random.default_rng(SEED + 12)  # the speculative phase's tree and prompts
    tree = _flagship_tree(cfg, rng)
    prompt = {c: rng.integers(0, cfg.vocab_size, (1, c - SPEC_NEW)).astype(np.int32)
              for c in SPEC_CONTEXTS}[SPEC_CONTEXTS[0]]
    mesh = create_mesh(TP_SERVE_MESH, device)
    model = lm_from_jax(cfg, tree, device=device, mesh=mesh)
    draft = TransformerLM(draft_config_for("lm_draft", cfg), device=device)
    draft.load_state_dict(torch.load(os.path.join(out_dir, "spec_draft.pt")))
    out, windows = {"local_heads": model.local_heads}, {}

    def server_for(draft=None, **serving):
        pool = SPEC_SLOTS * pages_per_slot(cfg.max_seq, SPEC_PS)
        tel = Telemetry()
        return tel, InferenceServer(model, telemetry=tel, draft=draft, serving=ServingConfig(
            kv_layout="paged", max_slots=SPEC_SLOTS, page_size=SPEC_PS, prefix_sharing=False,
            page_pool_pages=pool, batch_window_s=0.02, **serving))

    def serve(key, sampled=False, **serving):
        tel, server = server_for(**serving)
        if rank:
            try:
                _, windows[key] = _counted(server.follow)
                out[key] = {"error": None}
            except Exception as e:
                out[key] = {"error": f"{type(e).__name__}: {e}"}
            out[key].update(follower_ops=server.follower_ops,
                            draft_width=server._draft_cache.k[0].shape[-1]
                            if server._draft_cache is not None else None)
            return
        server.setup()
        client = InferenceClient(server.address, timeout=600).setup()
        rec = {}

        def run():
            client.generate(prompt, n_tokens=3)
            t = time.perf_counter()
            client.generate(prompt, n_tokens=1)
            t1 = time.perf_counter() - t
            r0, p0, a0 = (server.decode_batches, tel.counter_value("serving_spec_proposed_total"),
                          tel.counter_value("serving_spec_accepted_total"))
            t = time.perf_counter()
            rec["out"] = client.generate(prompt, n_tokens=SPEC_NEW)
            tn = time.perf_counter() - t
            rounds = server.decode_batches - r0
            prop = tel.counter_value("serving_spec_proposed_total") - p0
            acc = tel.counter_value("serving_spec_accepted_total") - a0
            rec.update(ms_per_token=(tn - t1) * 1e3 / (SPEC_NEW - 1), request_ms=tn * 1e3,
                       rounds=rounds, proposed=prop, accepted=acc,
                       accept_rate=acc / prop if prop else None,
                       accepted_per_round=acc / rounds if prop else None)
            if sampled:
                a, b = (client.generate(prompt, n_tokens=32, **SPEC_SAMPLED) for _ in range(2))
                c = client.generate(prompt, n_tokens=32,
                                    **{**SPEC_SAMPLED, "seed": SPEC_SAMPLED["seed"] + 1})
                rec["sampled"] = {"same_seed_equal": bool(np.array_equal(a, b)),
                                  "other_seed_differs": not np.array_equal(a, c),
                                  "differing_tokens": int((a != c).sum()),
                                  "in_vocab": bool((a >= 0).all() and (a < cfg.vocab_size).all())}

        try:
            _, windows[key] = _counted(run)
            rec.update(prefills=server.prefills, decode_batches=server.decode_batches,
                       decode_chunk=server.serving.decode_chunk, speculate_k=server._spec_k,
                       target_width=server._slot_cache.k[0].shape[-1],
                       draft_width=server._draft_cache.k[0].shape[-1]
                       if server._draft_cache is not None else None,
                       phases_ms={k: {q: v[q] for q in ("count", "p50", "max", "sum")}
                                  for k, v in server._prof.digests().items()})
        finally:
            client.close()
            server.stop()
        server.release_prefix_cache()
        pool = server._pool
        rec["pool_free"] = bool(pool.free_pages == pool.n_pages and not pool._refs.any()
                                and not any(server._slot_pages) and not any(server._draft_pages))
        out[key] = rec

    serve("tp_spec", sampled=True, speculate_k=SPEC_K, draft_model="lm_draft", draft=draft)
    serve("tp_plain")
    serve("tp_spec_self", speculate_k=SPEC_K, draft_model="self")
    # the planted fault: one follower's drafts altered before the verify
    _, hurt = server_for(speculate_k=SPEC_K, draft_model="lm_draft", draft=draft)
    if rank == TP_SPEC_PLANTED_RANK:
        real = hurt._draft

        def altered(*a, **kw):
            drafts, qprobs = real(*a, **kw)
            return (drafts + 1) % cfg.vocab_size, qprobs

        hurt._draft = altered
    if rank:
        try:
            hurt.follow()
            out["planted"] = {"error": None}
        except Exception as e:
            out["planted"] = {"error": f"{type(e).__name__}: {e}"}
    else:
        hurt.setup()
        outcomes = []
        try:
            with InferenceClient(hurt.address, timeout=600).setup() as c:
                for _ in range(2):
                    try:
                        c.generate(prompt, n_tokens=TP_SPEC_PLANTED_TOKENS)
                        outcomes.append("served")
                    except Exception as e:
                        outcomes.append(f"raised {type(e).__name__}")
        finally:
            hurt.stop()
        out["planted"] = {"outcomes": outcomes, "mesh_error": hurt.mesh_error}
    del model, draft
    if device == "cuda":
        torch.cuda.empty_cache()
    out["windows"] = windows
    return out


def _tp_spec_check(ranks, device="cuda"):
    """The ``tp_spec`` leg (:func:`_tp_spec_leg`) against its contract:
    every window exact on every rank (kernel 1 once a layer a fresh
    prefill of the target at D 64 and of the draft at D 32 or, self, D 64;
    kernel 2 at D 32 rounds x (k + 1) x the draft's layers, never at D 64
    under ``lm_draft``; the plain server decode_chunk steps a layer an
    iteration), the speculative greedy outputs against the plain TP
    server's under the near-tie rule (one rank's target gives the
    margins), the sampled seeds, the self-draft's acceptance, the pools
    and the followers, the caches' head widths, and the planted fault
    stopping every rank with rank 0 naming the altered rank. Returns
    ``(record, windows, expected windows)``."""
    from distriflow_tpu_torch.models.convert import lm_from_jax
    from distriflow_tpu_torch.models.zoo import draft_config_for

    tp = ranks[0]["tp_spec"]
    cfg = _spec_config()
    dcfg = draft_config_for("lm_draft", cfg)
    k, n, nd = SPEC_K, cfg.n_layers, dcfg.n_layers
    spec, plain, self_ = tp["tp_spec"], tp["tp_plain"], tp["tp_spec_self"]
    for r, res in enumerate(ranks[1:], 1):
        for key in ("tp_spec", "tp_plain", "tp_spec_self"):
            f = res["tp_spec"][key]
            assert f["error"] is None and f["follower_ops"] > 0, (key, f"rank {r}", f)
    want = {
        "tp_spec": {"flash_attention_fwd": spec["prefills"] * (n + nd),
                    "flash_attention_fwd_d32": spec["prefills"] * nd,
                    "flash_decode_paged": spec["decode_batches"] * (k + 1) * nd,
                    "flash_decode_paged_d32": spec["decode_batches"] * (k + 1) * nd},
        "tp_plain": {"flash_attention_fwd": plain["prefills"] * n,
                     "flash_decode_paged": plain["decode_batches"] * plain["decode_chunk"] * n},
        "tp_spec_self": {"flash_attention_fwd": 2 * self_["prefills"] * n,
                         "flash_decode_paged": self_["decode_batches"] * (k + 1) * n}}
    for key, w in want.items():
        for r, res in enumerate(ranks):
            got = {q: c for q, c in res["tp_spec"]["windows"][key].items() if c}
            assert got == w, (f"mesh_{key}", f"rank {r}", got, w)
    d = cfg.head_dim
    assert tp["local_heads"] == cfg.n_heads // TP_SERVE_MESH["model"]
    assert spec["target_width"] == tp["local_heads"] * d == self_["draft_width"], tp
    assert spec["draft_width"] == dcfg.n_heads * dcfg.head_dim, spec  # the whole draft
    for r, res in enumerate(ranks[1:], 1):
        assert res["tp_spec"]["tp_spec"]["draft_width"] == spec["draft_width"], r
        assert res["tp_spec"]["tp_spec_self"]["draft_width"] == self_["draft_width"], r
    assert all(v["pool_free"] for v in (spec, plain, self_)), "a tp_spec pool did not reconcile"
    sampled = spec["sampled"]
    assert sampled["same_seed_equal"] and sampled["other_seed_differs"] and sampled["in_vocab"], \
        sampled
    target = lm_from_jax(cfg, _flagship_tree(cfg, np.random.default_rng(SEED + 12)),
                         device=device)
    p_len = spec["out"].shape[1] - SPEC_NEW
    prompt = spec["out"][:, :p_len]
    reqs = [("tp_spec_1k", prompt, {})]
    plain_out = {"tp_spec_1k": torch.as_tensor(plain["out"])}
    parity = _check_greedy(target, reqs, {"tp_spec_1k": spec["out"]}, plain_out, SPEC_NEW)
    self_parity = _check_greedy(target, reqs, {"tp_spec_1k": self_["out"]}, plain_out, SPEC_NEW)
    del target
    assert self_["accept_rate"] >= SPEC_SELF_ACCEPT, \
        f"TP self-draft acceptance {self_['accept_rate']} < {SPEC_SELF_ACCEPT}"
    planted = tp["planted"]
    named = f"rank {TP_SPEC_PLANTED_RANK} drafted"
    assert planted["outcomes"] and all(o.startswith("raised") for o in planted["outcomes"]), planted
    assert named in (planted["mesh_error"] or ""), planted
    for r, res in enumerate(ranks[1:], 1):
        err = res["tp_spec"]["planted"]["error"]
        assert err is not None and named in err, ("the planted draft fault", f"rank {r}", err)
    keep = ("ms_per_token", "request_ms", "rounds", "proposed", "accepted", "accept_rate",
            "accepted_per_round", "prefills", "decode_batches", "phases_ms")
    rec = {"mesh": TP_SERVE_MESH, "rules": "TRANSFORMER_TP_RULES", "k": k,
           "context": SPEC_CONTEXTS[0], "new_tokens": SPEC_NEW, "local_heads": tp["local_heads"],
           "note": "4 ranks sharing one H100 over gloo: not a multi-card figure",
           "launches_per_rank": want, "parity_vs_plain_tp": parity,
           "self_parity_vs_plain_tp": self_parity, "sampled": sampled,
           "widths": {"target": spec["target_width"], "lm_draft": spec["draft_width"],
                      "self_draft": self_["draft_width"]},
           "follower_ops": {key: [r["tp_spec"][key]["follower_ops"] for r in ranks[1:]]
                            for key in want},
           "planted_draft_fault": {"rank": TP_SPEC_PLANTED_RANK, **planted,
                                   "follower_errors": [r["tp_spec"]["planted"]["error"]
                                                       for r in ranks[1:]]},
           **{key: {q: tp[key][q] for q in keep} for key in want}}
    windows = {f"mesh_{key}": tp["windows"][key] for key in want}
    return rec, windows, {f"mesh_{key}": w for key, w in want.items()}


def _pipe_check(ranks, ref, planted, leg, out_dir):
    """A pipeline leg against the one-rank reference (``_mesh_vs_reference``
    on the unstacked parameters, ``planted`` the reference without the
    last microbatch's rows), its exact windows on every rank, and the
    {pipe 4} legs' step memory."""
    cfg = _pipe_cfg()
    params = torch.load(os.path.join(out_dir, f"{leg}.params.pt"), weights_only=False)
    want = _pipe_windows(leg, cfg)
    for r, res in enumerate(ranks):
        got = {k: n for k, n in res[leg]["counts"].items() if n}
        assert got == want, (f"mesh_{leg}", f"rank {r}", got, want)
    from distriflow_tpu_torch.models.convert import params_from_jax

    start = params_from_jax(_pipe_data()[0], cfg, masters=True)
    shape, sched, m = PIPE_LEGS[leg]
    rec = {"mesh": shape, "schedule": sched, "microbatches": m, "layers": cfg.n_layers,
           "rules": "PIPELINED_TRANSFORMER_RULES", "loss": ranks[0][leg]["loss_name"],
           "launches_per_rank": want,
           "step_ms_p50_by_rank": [float(np.median(r[leg]["step_ms"])) for r in ranks],
           "staged_bytes": ranks[0][leg]["staged_bytes"],
           **_mesh_vs_reference(leg, ranks, ref, params, start, planted)}
    if "step_mem" in ranks[0][leg]:
        rec["step_mem_bytes_by_rank"] = [r[leg]["step_mem"] for r in ranks]
    return rec


def _pipe_memory_order(legs):
    """JAX's memory assertions on the card, every rank: remat's step
    (peak over what the step started with) below gpipe's at each M, and
    1F1B's flat from M 4 to 8 (within PIPE_FLAT)."""
    n = len(legs["pp4_gpipe"]["step_mem_bytes_by_rank"])
    out = {}
    for r in range(n):
        g, rm, f = (legs[k]["step_mem_bytes_by_rank"][r] for k in
                    ("pp4_gpipe", "pp4_remat", "pp4_1f1b"))
        for m in PIPE_MEM_M:
            assert rm[str(m)][1] < g[str(m)][1], ("remat not below gpipe", r, m, rm, g)
        lo, hi = (f[str(m)][1] for m in PIPE_MEM_M)
        assert hi <= PIPE_FLAT * lo, ("1f1b not flat in M", r, lo, hi)
        out[f"rank{r}"] = {"remat_over_gpipe": {str(m): rm[str(m)][1] / g[str(m)][1]
                                                for m in PIPE_MEM_M},
                           "1f1b_m8_over_m4": hi / lo}
    return out


def _mesh_tp_entries():
    """The kernels at the second half's shapes, each against its plain
    version and (where one exists) SDPA: kernel 1 at TP's local heads (B2
    H4 S1000 causal) and at the pipeline's microbatch (B2 H8 S1024
    causal); kernel 3 (B1 H4), kernel 2 (B8 H4) and kernel 5 (B1 H4) at
    TP's local heads, at the 2k phase's contexts. ``{row name: {entry:
    ...}}``."""
    import torch.nn.functional as F

    from distriflow_tpu_torch.ops import flash_attention as fa
    from distriflow_tpu_torch.ops import flash_decode as fd

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 37)
    flush = _flush_buffer()
    d, out = 64, {"flash_attention_fwd": {}, "flash_decode": {}, "flash_decode_paged": {},
                  "flash_decode_int8": {}}

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    for key, b, h, s in (("tp_local_heads", 2, 4, 1000), ("pipeline_microbatch", 2, 8, MESH_S)):
        q, k, v = randn(b, h, s, d), randn(b, h, s, d), randn(b, h, s, d)
        o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
        ro, rl = fa.flash_attention_reference(q, k, v, True)
        tb, by = _bound(4 * b * h * s * d * 2 + b * h * s * 4, 4 * b * h * (s * (s + 1) // 2) * d,
                        exps=b * h * (s * (s + 1) // 2))
        out["flash_attention_fwd"][key] = {
            "shape": f"B={b} H={h} S={s} D={d} causal",
            "max_abs_err": _over(f"flash_attention_fwd O {key}", o, ro, *TOL["flash_attention_fwd"]),
            "lse_max_abs_err": _over(f"flash_attention_fwd lse {key}", lse, rl, LSE_ATOL, 0.0),
            "ms": _timed(lambda: fa.flash_attention(q, k, v, causal=True, return_lse=True), 50,
                         flush),
            "plain_ms": _timed(lambda: fa.flash_attention_reference(q, k, v, True), 5, flush),
            "bound_ms": tb, "bound_by": by,
            "library_ms": _timed(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
                                 50, flush)}
    h = 4
    # slab decode, bf16 and int8: solo generate() at max_seq 2048, context 1064
    s_max, n = 2048, 1064
    qs = randn(1, h, d)
    ks, vs = randn(1, s_max, h * d), randn(1, s_max, h * d)
    kh = ks.view(1, s_max, h, d).transpose(1, 2)[:, :, :n].contiguous()
    vh = vs.view(1, s_max, h, d).transpose(1, 2)[:, :, :n].contiguous()
    tb, by = _bound(2 * n * h * d * 2 + 2 * h * d * 2, 4 * n * h * d, exps=n * h)
    out["flash_decode"]["tp_local_heads"] = {
        "shape": f"B=1 S={s_max} valid={n} H={h} D={d}",
        "max_abs_err": _over("flash_decode tp", fd.flash_decode(qs, ks, vs, n),
                             fd.flash_decode_reference(qs, ks, vs, n), *TOL["flash_decode"]),
        "ms": _timed(lambda: fd.flash_decode(qs, ks, vs, n), 200, flush),
        "plain_ms": _timed(lambda: fd.flash_decode_reference(qs, ks, vs, n), 5, flush),
        "bound_ms": tb, "bound_by": by,
        "library_ms": _timed(lambda: F.scaled_dot_product_attention(qs[:, :, None], kh, vh), 200,
                             flush)}
    k8, v8, k_sc, v_sc = _int8_cache(g, (1, s_max), h, d)
    tb, by = _bound(2 * n * h * d + 2 * n * h * 4 + 2 * h * d * 2, 4 * n * h * d, exps=n * h)
    out["flash_decode_int8"]["tp_local_heads"] = {
        "shape": f"B=1 S={s_max} valid={n} H={h} D={d} int8",
        "max_abs_err": _over("flash_decode_int8 tp", fd.flash_decode_int8(qs, k8, v8, k_sc, v_sc, n),
                             fd.flash_decode_int8_reference(qs, k8, v8, k_sc, v_sc, n),
                             *TOL["flash_decode_int8"]),
        "ms": _timed(lambda: fd.flash_decode_int8(qs, k8, v8, k_sc, v_sc, n), 200, flush),
        "plain_ms": _timed(lambda: fd.flash_decode_int8_reference(qs, k8, v8, k_sc, v_sc, n), 5,
                           flush),
        "bound_ms": tb, "bound_by": by, "library_ms": None}
    # paged decode: the engine's 8 slots at the 2k phase's contexts
    n_pages, ps, bsz = 128, 128, 8
    lens_l = [129, 300, 513, 1001, 193, 577, 1064, 128]
    table, lens = _paged_rows(g, lens_l, ps, n_pages, 16)
    kp, vp, q1 = randn(n_pages, ps, h * d), randn(n_pages, ps, h * d), randn(bsz, h, d)
    live = sum(lens_l)
    tb, by = _bound(2 * live * h * d * 2 + 2 * bsz * h * d * 2 + table.numel() * 4 + bsz * 4,
                   4 * live * h * d, exps=live * h)
    out["flash_decode_paged"]["tp_local_heads"] = {
        "shape": f"B={bsz} H={h} D={d} page={ps} contexts={lens_l}",
        "max_abs_err": _over("flash_decode_paged tp", fd.flash_decode_paged(q1, kp, vp, table, lens),
                             fd.flash_decode_paged_reference(q1, kp, vp, table, lens),
                             *TOL["flash_decode_paged"]),
        "ms": _timed(lambda: fd.flash_decode_paged(q1, kp, vp, table, lens), 200, flush),
        "plain_ms": _timed(lambda: fd.flash_decode_paged_reference(q1, kp, vp, table, lens), 5,
                           flush),
        "bound_ms": tb, "bound_by": by, "library_ms": None}
    return out


# The Keras import (keras:): BASELINE #2's ConvNet written as a
# tfjs-layers Sequential model.json whose weights (_convnet_tree's, under
# the Keras layer names) come from the port's export_keras_weights; trained
# from its path at _convnet_phase's recipe (each step's loss within
# KERAS_LOSS_TOL of the zoo ConvNet's from the same tree), loaded from a
# loopback URL, trained over the wire by one worker on the URL's model and
# one on the bare URL string (f32, plain CE), and exported back
KERAS_LOSS_TOL = 1e-2
KERAS_NAMES = {"Conv_0": "conv2d_1", "Conv_1": "conv2d_2", "Conv_2": "conv2d_3",
               "Dense_0": "dense_1", "Dense_1": "dense_2"}
# The streaming token dataset (streaming:): a token file of STREAM_TOKENS
# tokens of the Markov corpus at the flagship's vocabulary (uint16),
# streamed into the flagship LM at B STREAM_B x S STREAM_S, sgd
# STREAM_LR (stateless, so a save_model checkpoint is the trainer's whole
# state), STREAM_STEPS steps, a checkpoint, STREAM_STEPS more; then a
# fresh trainer and dataset resumed from the checkpoint and the cursor
STREAM_TOKENS, STREAM_B, STREAM_S, STREAM_STEPS, STREAM_LR = 1 << 20, 8, 1024, 10, 0.05


def _keras_convnet_files(tree, root):
    """Write ``cifar_convnet`` as a tfjs-layers Sequential topology (conv
    3x3 same 64/128/256 each with ReLU and a 2x2 max pool, flatten, dense
    256 ReLU, dense 10 softmax, on 32x32x3) and export ``tree``'s weights
    next to it with ``export_keras_weights``; returns the model.json path
    (under ``root/www``)."""
    from distriflow_tpu_torch.models.keras_import import export_keras_weights

    layers = []
    for i, f in enumerate((64, 128, 256)):
        cfg = {"name": f"conv2d_{i + 1}", "filters": f, "kernel_size": [3, 3],
               "strides": [1, 1], "padding": "same", "activation": "relu", "use_bias": True}
        if i == 0:
            cfg["batch_input_shape"] = [None, 32, 32, 3]
        layers += [{"class_name": "Conv2D", "config": cfg},
                   {"class_name": "MaxPooling2D", "config": {
                       "name": f"max_pooling2d_{i + 1}", "pool_size": [2, 2],
                       "strides": [2, 2], "padding": "valid"}}]
    layers += [{"class_name": "Flatten", "config": {"name": "flatten_1"}},
               {"class_name": "Dense", "config": {"name": "dense_1", "units": 256,
                                                  "activation": "relu"}},
               {"class_name": "Dense", "config": {"name": "dense_2", "units": 10,
                                                  "activation": "softmax"}}]
    topology = os.path.join(root, "topology.json")
    with open(topology, "w") as f:
        json.dump({"modelTopology": {"model_config": {
            "class_name": "Sequential", "config": {"name": "cifar_convnet", "layers": layers}}}},
            f)
    weights = {KERAS_NAMES[k]: v for k, v in tree["params"].items()}
    return export_keras_weights(topology, weights, os.path.join(root, "www"))


@contextlib.contextmanager
def _http_root(root):
    """A loopback ``http.server`` on port 0 serving ``root``; yields its
    base URL."""
    import functools
    from http.server import SimpleHTTPRequestHandler, ThreadingHTTPServer

    class Quiet(SimpleHTTPRequestHandler):
        def log_message(self, *args):
            pass

    server = ThreadingHTTPServer(("127.0.0.1", 0), functools.partial(Quiet, directory=root))
    thread = threading.Thread(target=server.serve_forever, name="keras-http", daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_port}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(10)


def _keras_model(source, device, **kw):
    """``fetch_model(source)`` in bf16 with the fused dense CE."""
    from distriflow_tpu_torch.models.base import fetch_model

    return fetch_model(source, dtype=torch.bfloat16, loss="fused_softmax_cross_entropy",
                       device=device, **kw)


def _keras_phase(tree, cn_report, counted, payloads, device="cuda"):
    """The ``keras:`` phase: (a) train from the path, (b) load from a URL,
    (c) the wire, (d) the export round trip. Returns ``(report, counts by
    window)``."""
    import tempfile

    from distriflow_tpu_torch.models.base import SpecModel
    from distriflow_tpu_torch.train.sync import SyncTrainer

    report, counts = {}, {}
    with tempfile.TemporaryDirectory(prefix="keras-") as root:
        t0 = time.perf_counter()
        path = _keras_convnet_files(tree, root)
        report["write_s"] = time.perf_counter() - t0
        # (a) training from the path, at the zoo ConvNet's recipe
        t0 = time.perf_counter()
        model = _keras_model(path, device)
        assert model.spec.name == "keras:model:logits", model.spec.name
        trainer = SyncTrainer(model.spec, optimizer="sgd", learning_rate=CN_LR)
        trainer.init(SEED)
        train, batch, counts["keras_train"], counts["keras_eval"] = _run_convnet(
            trainer, counted, device, CN_STEPS, CN_B, "keras:cifar_convnet")
        diffs = [abs(a - b) for a, b in zip(train["losses"], cn_report["losses"])]
        train.update(phase_s=time.perf_counter() - t0, spec_name=model.spec.name,
                     zoo_losses=cn_report["losses"], worst_loss_diff_vs_zoo=max(diffs),
                     bitwise_vs_zoo=train["losses"] == cn_report["losses"])
        assert len(diffs) == CN_STEPS and max(diffs) <= KERAS_LOSS_TOL, \
            f"Keras ConvNet losses {max(diffs)} from the zoo ConvNet's (limit {KERAS_LOSS_TOL})"
        report["train"] = train
        with _http_root(os.path.dirname(path)) as base:
            # (b) the same file over a loopback URL
            t0 = time.perf_counter()
            url = f"{base}/model.json"
            remote, local = _keras_model(url, device), _keras_model(path, device)
            x = torch.as_tensor(batch[0][:256], device=device)
            same_params = _same_bits(remote.get_params(), local.get_params())
            same_logits = torch.equal(remote.predict(x), local.predict(x))
            report["url"] = {"load_s": time.perf_counter() - t0, "params_bitwise": same_params,
                             "logits_bitwise": same_logits}
            assert same_params and same_logits, report["url"]
            del local
            # (c) the wire: a server from the path, a worker on the URL's
            # model and a worker handed the bare URL string
            with payloads.wire("keras"):
                report["wire"], server_tree, counts["keras_wire"] = _keras_wire(
                    path, url, remote.spec, counted, device)
            del remote
        # every blob's leaves: the weights' and gradients' (the Keras tree)
        # and a batch's data ('x', 'y')
        names = {f"['{layer}']['{w}']" for layer, ws in server_tree.items() for w in ws}
        assert payloads.leaf_names["keras"] == names | {"x", "y"}, \
            f"wire leaves {sorted(payloads.leaf_names['keras'])} are not the Keras tree's {sorted(names)}"
        report["wire"]["leaf_names"] = sorted(names)
        if device == "cuda":  # exact windows: one launch each a step, a batch, a bf16 fit
            for k in ("fused_ce_dense_fwd", "fused_ce_dense_bwd"):
                assert counts["keras_train"][k] == CN_STEPS, (k, counts["keras_train"])
                assert counts["keras_wire"][k] == report["wire"]["kernel_fits"], \
                    (k, counts["keras_wire"], report["wire"]["kernel_fits"])
            assert counts["keras_eval"]["fused_ce_dense_fwd"] == -(-CN_VAL // CN_B), \
                counts["keras_eval"]
        # (d) export the trained model and load it back
        t0 = time.perf_counter()
        trained = trainer.get_params()
        out = os.path.join(root, "export")
        from distriflow_tpu_torch.models.keras_import import export_keras_weights

        reloaded = _keras_model(export_keras_weights(path, trained, out), device)
        before = SpecModel(model.spec, params=trained)
        x = torch.as_tensor(batch[0], device=device)
        report["export"] = {"s": time.perf_counter() - t0,
                            "params_bitwise": _same_bits(reloaded.get_params(), trained),
                            "logits_bitwise": torch.equal(reloaded.predict(x), before.predict(x))}
        assert report["export"]["params_bitwise"] and report["export"]["logits_bitwise"], \
            report["export"]
    return report, counts


def _keras_wire(path, url, url_spec, counted, device):
    """Port ``AsynchronousSGDServer`` on the Keras ConvNet from ``path``
    (bf16, fused dense CE, momentum at ``WIRE_LR``) over one epoch of
    ``WIRE_TRAIN`` synthetic images in batches of ``WIRE_B``, with two port
    workers: one on a model of ``url_spec`` (bf16, its fits launch the
    dense CE kernels) and one handed the bare ``url`` (its own
    ``fetch_model``: f32, the plain CE); the server's validation losses
    before and after are taken outside the launch window. Returns
    ``(report, the server's final wire tree, the window's counts)``."""
    import tempfile

    from distriflow_tpu_torch.client import AsynchronousSGDClient, DistributedClientConfig
    from distriflow_tpu_torch.data.dataset import DistributedDataset
    from distriflow_tpu_torch.models.base import params_to_wire
    from distriflow_tpu_torch.obs.telemetry import Telemetry
    from distriflow_tpu_torch.server import (AsynchronousSGDServer, DistributedServerConfig,
                                             DistributedServerInMemoryModel)
    from distriflow_tpu_torch.utils.config import CompileConfig

    train, val = _synthetic_cifar10(WIRE_TRAIN, CN_VAL, SEED + 11)
    (x, y), (vx, vy) = _to_xy(train), _to_xy(val)
    tel, fits = Telemetry(), _Fits()
    server_model = _keras_model(path, device, compile_config=CompileConfig(optimizer="momentum"),
                                learning_rate=WIRE_LR)
    init_val, spread = _val_spread(server_model, vx, vy)
    dataset = DistributedDataset(x, y, {"batch_size": WIRE_B, "epochs": 1})
    batches = dataset.num_batches

    def train(save_dir):
        server = AsynchronousSGDServer(
            DistributedServerInMemoryModel(server_model), dataset,
            DistributedServerConfig(
                # delta_broadcast at its default (on): the bf16 server's
                # leaves ship whole and the f32 worker must install them whole
                server_hyperparams={"maximum_staleness": WIRE_STALENESS},
                client_hyperparams={"batch_size": WIRE_B, "learning_rate": WIRE_LR},
                save_dir=save_dir, telemetry=tel))
        server.setup()
        cfg = DistributedClientConfig(telemetry=tel, upload_timeout_s=120)
        clients, done, errors = [], [0, 0], []

        def work(i):
            try:
                clients[i].setup(timeout=60)
                done[i] = clients[i].train_until_complete(timeout=WIRE_TIMEOUT_S)
            except BaseException as e:  # noqa: BLE001 - relayed to the main thread
                errors.append(e)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=work, args=(i,), name=f"keras-worker-{i}")
                   for i in range(2)]
        try:
            clients.append(AsynchronousSGDClient(server.address, fits.model(url_spec), cfg))
            clients.append(AsynchronousSGDClient(server.address, url, cfg))
            for t in threads:
                t.start()
            for t in threads:
                t.join(WIRE_TIMEOUT_S + 60)
            assert not errors, errors
            assert not any(t.is_alive() for t in threads), "a Keras wire worker did not finish"
            _wait_for(lambda: server.applied_updates + server.rejected_updates
                      + server.suppressed_uploads >= batches, "the Keras server's last apply")
            if device == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            for c in clients:
                c.dispose()
            server.stop()
        return server, clients[1].model, done, wall

    with tempfile.TemporaryDirectory(prefix="keras-wire-") as save_dir:
        (server, plain_client, done, wall), counts = counted(lambda: train(save_dir))
    final_val = server_model.evaluate(vx, vy)[0]
    report = {"batches": batches, "batch": WIRE_B, "wall_s": wall, "fits_by_worker": done,
              "applied": server.applied_updates, "rejected": server.rejected_updates,
              "suppressed": server.suppressed_uploads, "duplicates": server.duplicate_uploads,
              "broadcasts": {k: tel.counter_value(f"comm_broadcasts_{k}_total", role="server")
                             for k in ("delta", "full")},
              "kernel_fits": len(fits.losses), "url_worker_losses": fits.losses,
              "bare_url_worker": {"dtype": str(plain_client.spec.dtype),
                                  "loss": plain_client.spec.loss,
                                  "spec_name": plain_client.spec.name},
              "init_val_loss": init_val, "init_val_spread": spread, "final_val_loss": final_val}
    # every upload handled exactly once, as in _async_leg: the dataset ran
    # out, every batch was applied or rejected as stale, none suppressed or
    # applied twice
    assert dataset.exhausted, report
    assert server.applied_updates + server.rejected_updates == batches \
        and server.applied_updates > 0 and not server.suppressed_uploads \
        and not server.duplicate_uploads, report
    assert sum(done) == batches and all(done), report
    assert report["broadcasts"]["delta"] > 0, report
    assert plain_client.spec.dtype == torch.float32 and \
        plain_client.spec.loss == "softmax_cross_entropy", report
    assert init_val - final_val > spread, \
        f"the Keras wire run did not lower the validation loss: {init_val} -> {final_val}, " \
        f"spread {spread}"
    return report, params_to_wire(server_model, server_model.get_params()), counts


def _streaming_phase(tree, counted, device="cuda"):
    """The ``streaming:`` phase. Returns ``(report, counts by window)``."""
    import tempfile

    from distriflow_tpu_torch.checkpoint import CheckpointStore, load_model, save_model
    from distriflow_tpu_torch.data.streaming import StreamingTokenDataset, write_token_file
    from distriflow_tpu_torch.models.base import SpecModel
    from distriflow_tpu_torch.models.convert import params_from_jax
    from distriflow_tpu_torch.models.transformer import transformer_lm
    from distriflow_tpu_torch.models.zoo import flagship_lm_config
    from distriflow_tpu_torch.train.sync import SyncTrainer

    cfg = flagship_lm_config(max_seq=STREAM_S)
    report = {"config": {"model": "flagship LM", "batch": STREAM_B, "seq": STREAM_S,
                         "optimizer": "sgd", "lr": STREAM_LR, "loss": "fused sparse CE",
                         "steps": [STREAM_STEPS, STREAM_STEPS, STREAM_STEPS]}}

    def trainer_from(params):
        t = SyncTrainer(transformer_lm(cfg, device=device), optimizer="sgd",
                        learning_rate=STREAM_LR)
        t.init()
        t.set_params(params)
        return t

    step_ms = []

    def run(trainer, ds, n):
        batches, losses = [], []
        for x, y in ds.take(n):
            batches.append((x, y))
            losses.append(trainer.step((x, y)))
            step_ms.append(trainer.last_step_ms)
        return batches, losses

    with tempfile.TemporaryDirectory(prefix="streaming-") as root:
        t0 = time.perf_counter()
        corpus = _markov_corpus(STREAM_TOKENS, SEED + 40, vocab=cfg.vocab_size)
        path = write_token_file(os.path.join(root, "corpus"), corpus)
        with open(path + ".json") as f:
            meta = json.load(f)
        ds = StreamingTokenDataset(path, seq_len=STREAM_S, batch_size=STREAM_B, seed=SEED + 41)
        report["data"] = {"tokens": meta["count"], "dtype": meta["dtype"],
                          "windows": ds.n_windows, "batches_per_epoch": ds.batches_per_epoch,
                          "max_token_id": ds.max_token_id(), "write_s": time.perf_counter() - t0,
                          "process": [ds.process_index, ds.process_count]}
        assert meta["dtype"] == "uint16" and meta["count"] >= 1_000_000, meta
        assert ds.max_token_id() < cfg.vocab_size
        trainer = trainer_from(params_from_jax(tree, cfg, masters=True))
        # the first STREAM_STEPS steps, the checkpoint and the cursor, then
        # STREAM_STEPS more: the run the resume must replay
        def train_and_checkpoint():
            first = run(trainer, ds, STREAM_STEPS)[1]
            save_model(CheckpointStore(os.path.join(root, "ckpt")),
                       SpecModel(trainer.spec, params=trainer.get_params()), version="1")
            cursor = ds.state()
            return (first, cursor) + run(trainer, ds, STREAM_STEPS)

        t0 = time.perf_counter()
        (first, state, after, want), counts_train = counted(train_and_checkpoint)
        train_s = time.perf_counter() - t0
        # a fresh trainer from load_model and a fresh dataset from the cursor
        t0 = time.perf_counter()
        loaded = load_model(os.path.join(root, "ckpt"), spec=transformer_lm(cfg, device=device))
        resumed = trainer_from(loaded.get_params())
        del loaded
        ds2 = StreamingTokenDataset(path, seq_len=STREAM_S, batch_size=STREAM_B, seed=SEED + 41)
        ds2.restore(state)
        (again, got), counts_resume = counted(lambda: run(resumed, ds2, STREAM_STEPS))
        resume_s = time.perf_counter() - t0
        same_batches = all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                           for a, b in zip(after, again))
        diffs = [abs(a - b) for a, b in zip(want, got)]
        p50 = float(np.median(step_ms))
        report.update(train_s=train_s, resume_s=resume_s, step_ms_p50=p50,
                      step_ms_max=max(step_ms), tokens_per_s=STREAM_B * STREAM_S / (p50 / 1e3),
                      losses=first + want,
                      resumed_losses=got, cursor=state, batches_bitwise=same_batches,
                      losses_bitwise=got == want, worst_loss_diff=max(diffs))
        assert all(math.isfinite(v) for v in first + want + got), report
        assert len(again) == STREAM_STEPS and same_batches, "the resumed batches differ"
        if got != want:
            # name the parameters whose gradients differ between two
            # identical steps: the op that produced them is at fault
            report["nondeterministic_grads"] = _grad_bits_differ(resumed, after[0])
        # two processes' shards: disjoint, and together the whole epoch
        # less at most each one's last partial batch
        shards = [set(StreamingTokenDataset(path, seq_len=STREAM_S, batch_size=STREAM_B,
                                            seed=SEED + 41, process_index=i,
                                            process_count=2)._epoch_order(0).tolist())
                  for i in range(2)]
        union = len(shards[0] | shards[1])
        report["sharding"] = {"process_count": 2, "windows": [len(s) for s in shards],
                              "disjoint": not shards[0] & shards[1], "covered": union,
                              "epoch_windows": ds.n_windows}
        assert report["sharding"]["disjoint"] and ds.n_windows - union < 2 * STREAM_B, \
            report["sharding"]
    counts = {"streaming_train": counts_train, "streaming_resume": counts_resume}
    per_step = {"flash_attention_fwd": cfg.n_layers, "flash_attention_bwd": cfg.n_layers,
                "fused_ce_fwd": 1, "fused_ce_bwd": 1}
    for window, steps in (("streaming_train", 2 * STREAM_STEPS),
                          ("streaming_resume", STREAM_STEPS)):
        for k, n in per_step.items() if device == "cuda" else ():
            assert counts[window][k] == n * steps, \
                f"{window} launched {k} {counts[window][k]} times, want {n} a step x {steps}"
    return report, counts


def _grad_bits_differ(trainer, batch):
    """The parameters whose gradients differ bit for bit between two
    gradient computations from the same parameters and batch."""
    from distriflow_tpu_torch.models.base import to_device

    model = trainer.model
    x, y = to_device(batch, next(model.parameters()).device)
    grad = trainer.spec.grad_fn()
    one, two = grad(model, x, y)[1], grad(model, x, y)[1]
    return sorted(n for n in one if not torch.equal(one[n], two[n]))


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA port on one GPU.")
    ap.add_argument("--parent", help="an older checkout whose depthwise, dense CE, attention "
                                     "and decode kernels, and whose LM path (b) and (c), f32 "
                                     "MobileNet and speculative 16k steps, to time too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from distriflow_tpu_torch.models.convert import lm_from_jax
    from distriflow_tpu_torch.models.generate import generate
    from distriflow_tpu_torch.models.zoo import flagship_lm_config
    from distriflow_tpu_torch.ops import build

    print(_card(), flush=True)

    t0 = time.perf_counter()
    build.build_all()
    print(f"kernel build s: {time.perf_counter() - t0:.2f}", flush=True)
    for name, log in build.ptxas_reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"ptxas {name}: {line.strip()}")
    print("dwgn_f32_bwd:", json.dumps(_dwgn_f32_build(True)), flush=True)
    print("dwgn_f32_fwd:", json.dumps(_dwgn_f32_build(False)), flush=True)
    print("analysis:", json.dumps(_analysis_phase()), flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = flagship_lm_config()
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    tree = _flagship_tree(cfg, rng)
    model = lm_from_jax(cfg, tree, device="cuda")
    torch.cuda.synchronize()
    print(f"model init s: {time.perf_counter() - t0:.2f}", flush=True)
    reqs = _requests(rng, cfg.vocab_size)
    generate(model, reqs[0][1][:, :16], 4)  # warm-up: library handles, kernel loads
    torch.cuda.synchronize()

    training_only = ("flash_attention_bwd", "fused_ce_fwd", "fused_ce_bwd")
    counted = _counted

    t0 = time.perf_counter()
    payloads = _LivePayloads()
    outs, stats, serving, _ = _serve(model, reqs, counted, payloads=payloads)
    serve_s = time.perf_counter() - t0
    solos, solo = counted(lambda: _solo(model, reqs))
    report = _check_greedy(model, reqs, outs, solos)
    print("serving:", json.dumps({"wall_s": serve_s, **stats}), flush=True)
    print("parity:", json.dumps(report), flush=True)
    assert stats["prefix_hits"] >= 1, "the prefix-sharing path did not run"

    # long context: the same tree at max_seq 16384 with the int8 KV cache
    long_cfg = dataclasses.replace(flagship_lm_config(max_seq=LONG_MAX_SEQ), kv_cache_dtype="int8")
    long_report, long_counts = _long_phase(long_cfg, tree, np.random.default_rng(SEED + 4), counted,
                                           payloads=payloads)
    print("long_context:", json.dumps(long_report), flush=True)
    # speculative decoding: a distilled head-dim-32 draft over the target's
    # page pool, at 1k and 16k context, against plain paged decode
    t0 = time.perf_counter()
    spec_report, spec_counts, spec_draft = _spec_phase(model, reqs, solos, counted)
    spec_report["phase_s"] = time.perf_counter() - t0
    print("speculative:", json.dumps(spec_report), flush=True)
    # the serving fleet: port replicas behind the port's router, the
    # elastic ring and the autoscaler on a sentinel over the timeline
    t0 = time.perf_counter()
    fleet_report, fleet_counts = _fleet_phase(counted)
    fleet_report["phase_s"] = time.perf_counter() - t0
    print("fleet:", json.dumps(fleet_report), flush=True)
    # the port's doctor on the card: its 22 checks, the LM drills on the
    # paged decode kernel at page 16
    doctor_report, doctor_counts = _doctor_phase(counted)
    print("doctor:", json.dumps(doctor_report), flush=True)
    # MoE on one card: Switch top-1 and GShard top-2 trained, the capacity
    # sweep, the top-1 model served (each window checked exactly inside)
    moe_report, moe_counts = _moe_phase(counted)
    print("moe:", json.dumps(_with_spread(moe_report)), flush=True)
    # the training layouts on torch.distributed: 4 ranks on this card
    # (gloo), each leg against one rank on the card
    mesh_report, mesh_counts = _mesh_phase((model, tree, reqs, solos), spec_draft)
    del spec_draft
    print("mesh:", json.dumps(mesh_report), flush=True)

    # training: the flagship from the same tree as f32 masters, one batch
    tokens = np.random.default_rng(SEED + 2).integers(
        0, cfg.vocab_size, (TRAIN_B, TRAIN_S + 1)).astype(np.int32)
    x, y = tokens[:, :-1], tokens[:, 1:]
    (trainer, losses, step_ms), training = counted(lambda: _train(cfg, tree, [(x, y)] * TRAIN_STEPS))
    train_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # MobileNetV2 at the slice's configuration: train, then evaluate
    mn_tree = _mobilenet_tree(np.random.default_rng(SEED + 6), MN["classes"], MN["width"])
    mn_report, mn_trainer, mn_batch, mn_counts = _mobilenet_phase(mn_tree, counted)
    # the same MobileNetV2 at its default f32 (a)-(b), then at 224 px (c)
    t0 = time.perf_counter()
    mnf_report, mnf_counts = _mobilenet_f32_phase(mn_tree, counted)
    mnf_report["phase_s"] = time.perf_counter() - t0
    print("mobilenet_f32:", json.dumps(mnf_report), flush=True)
    # long-context training: the flagship at 16k with remat, the two-kernel
    # backward
    lt_report, lt_trainer, lt_cfg, lt_batch, long_training = _long_training(tree, counted)
    # the JAX LM CLI's own model at head dim 32: its defaults (then
    # --generate and --serve), --seq 16384 --remat and --dtype float32
    t0 = time.perf_counter()
    cli_report, cli_counts = _lm_cli_phase(counted)
    cli_report["phase_s"] = time.perf_counter() - t0
    print("lm_cli:", json.dumps(cli_report), flush=True)
    # the CIFAR-10 ConvNet with the fused dense CE: train, then evaluate
    cn_tree = _convnet_tree(np.random.default_rng(SEED + 9))
    cn_report, cn_trainer, cn_batch, cn_counts = _convnet_phase(cn_tree, counted)
    # the wire-training planes: the same ConvNet trained by port servers and
    # in-process port workers over loopback TCP
    t0 = time.perf_counter()
    with payloads.wire():
        wire_report, wire_counts = _wire_phase(cn_tree, counted)
        wire_report["phase_s"] = time.perf_counter() - t0
        wire_report["topk_probe_leaves"] = _topk_probe(cn_tree)
    print("wire_training:", json.dumps(wire_report), flush=True)
    # the Keras import: the same ConvNet as a model.json, trained from its
    # path, loaded from a loopback URL, trained over the wire, exported
    t0 = time.perf_counter()
    keras_report, keras_counts = _keras_phase(cn_tree, cn_report, counted, payloads)
    keras_report["phase_s"] = time.perf_counter() - t0
    print("keras:", json.dumps(keras_report), flush=True)
    print("payloads:", json.dumps(payloads.report()), flush=True)
    # the streaming token dataset under the flagship LM, and its resume
    t0 = time.perf_counter()
    stream_report, stream_counts = _streaming_phase(tree, counted)
    stream_report["phase_s"] = time.perf_counter() - t0
    print("streaming:", json.dumps(stream_report), flush=True)
    # the in-process trainers on the same ConvNet, then the cost of the
    # ConvNet's and the 16k LM's sync steps at their measured p50
    t0 = time.perf_counter()
    ip_report, ip_counts = _inprocess_phase(cn_tree, counted)
    ip_report["phase_s"] = time.perf_counter() - t0
    ip_report["cost"] = _cost_phase(cn_trainer, cn_batch, cn_report, lt_trainer, lt_cfg,
                                    lt_batch, lt_report)
    print("inprocess_training:", json.dumps(ip_report), flush=True)
    paths = {"serving": serving, "solo_generate": solo, **long_counts, **spec_counts,
             **fleet_counts, "doctor": doctor_counts, **moe_counts, "training": training, **mn_counts,
             **mnf_counts, "long_training": long_training, **cn_counts,
             **wire_counts, **ip_counts, **mesh_counts, **keras_counts, **stream_counts,
             **cli_counts}
    print("launches:", json.dumps(paths), flush=True)
    # each path launches exactly the kernels named here, and no other
    ran = {"serving": ("flash_attention_fwd", "flash_decode_paged"),
           "solo_generate": ("flash_attention_fwd", "flash_decode"),
           "long_serving": ("flash_attention_fwd", "flash_decode_paged_int8"),
           "long_solo_generate": ("flash_attention_fwd", "flash_decode_int8"),
           "beam": ("flash_attention_fwd", "flash_decode_int8"),
           "score": ("flash_attention_fwd",),
           **{w: ("flash_attention_fwd", "flash_attention_fwd_d32", "flash_decode_paged",
                  "flash_decode_paged_d32") for w in ("spec_1k", "spec_16k")},
           **{w: ("flash_attention_fwd", "flash_decode_paged")
              for w in ("plain_1k", "plain_16k", "spec_self")},
           "draft_solo": ("flash_attention_fwd", "flash_attention_fwd_d32", "flash_decode",
                          "flash_decode_d32"),
           **{w: ("flash_attention_fwd", "flash_decode_paged")
              for w in ("fleet_round_robin", "fleet_affinity", "fleet_elastic", "fleet_autoscale")},
           "fleet_solo": ("flash_attention_fwd", "flash_decode"),
           "doctor": ("flash_decode_paged", "flash_decode"),
           "training": ("flash_attention_fwd",) + training_only,
           "mobilenet_train": ("depthwise_gn_fwd", "depthwise_gn_bwd"),
           "mobilenet_eval": ("depthwise_gn_fwd",),
           **{w: ("depthwise_gn_fwd", "depthwise_gn_fwd_f32", "depthwise_gn_bwd",
                  "depthwise_gn_bwd_f32") for w in ("mobilenet_f32_train", "mobilenet_f32_224")},
           "mobilenet_f32_eval": ("depthwise_gn_fwd", "depthwise_gn_fwd_f32"),
           "long_training": ("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv",
                             "fused_ce_fwd", "fused_ce_bwd"),
           **{w: ("flash_attention_fwd",) + training_only
              for w in ("moe_train_top1", "moe_train_top2")},
           "moe_serving": ("flash_attention_fwd", "flash_decode_paged"),
           **{w: ("flash_attention_fwd", "flash_decode") for w in ("moe_solo_generate", "moe_beam")},
           "moe_score": ("flash_attention_fwd",),
           "convnet_train": ("fused_ce_dense_fwd", "fused_ce_dense_bwd"),
           "convnet_eval": ("fused_ce_dense_fwd",),
           **{w: ("fused_ce_dense_fwd", "fused_ce_dense_bwd")
              for w in (*wire_counts, *ip_counts)},
           **{w: tuple(want) for w, want in mesh_report["windows_expected"].items()},
           **{w: ("fused_ce_dense_fwd", "fused_ce_dense_bwd") for w in ("keras_train", "keras_wire")},
           "keras_eval": ("fused_ce_dense_fwd",),
           **{w: ("flash_attention_fwd",) + training_only for w in stream_counts},
           "lm_cli_train": ("flash_attention_fwd", "flash_attention_fwd_d32", "flash_attention_bwd",
                            "flash_attention_bwd_d32", "fused_ce_fwd", "fused_ce_bwd"),
           "lm_cli_generate": ("flash_attention_fwd", "flash_attention_fwd_d32", "flash_decode",
                               "flash_decode_d32"),
           "lm_cli_serve": ("flash_attention_fwd", "flash_attention_fwd_d32", "flash_decode_paged",
                            "flash_decode_paged_d32"),
           "lm_cli_long": ("flash_attention_fwd", "flash_attention_fwd_d32", "flash_attention_dq",
                           "flash_attention_dq_d32", "flash_attention_dkv", "flash_attention_dkv_d32",
                           "fused_ce_fwd", "fused_ce_bwd"),
           "lm_cli_f32": tuple(f"{k}{t}" for k in ("flash_attention_fwd", "flash_attention_bwd")
                               for t in ("", "_d32", "_f32"))
           + tuple(f"{k}{t}" for k in ("fused_ce_fwd", "fused_ce_bwd") for t in ("", "_f32")),
           "lm_cli_f32_generate": tuple(f"{k}{t}" for k in ("flash_attention_fwd", "flash_decode")
                                        for t in ("", "_d32", "_f32")),
           "lm_cli_f32_serve": tuple(f"{k}{t}" for k in ("flash_attention_fwd", "flash_decode",
                                                         "flash_decode_paged")
                                     for t in ("", "_d32", "_f32")),
           "lm_cli_f32_long": tuple(f"{k}{t}" for k in ("flash_attention_fwd", "flash_attention_dq",
                                                        "flash_attention_dkv")
                                    for t in ("", "_d32", "_f32"))
           + tuple(f"{k}{t}" for k in ("fused_ce_fwd", "fused_ce_bwd") for t in ("", "_f32"))}
    for path, counts in paths.items():
        for k, n in counts.items():
            if k in ran[path]:
                assert n > 0, f"kernel {k} never launched on the {path} path"
            else:
                assert n == 0, f"{path} launched {k} {n} times"
    per_step = {"flash_attention_fwd": cfg.n_layers, "flash_attention_bwd": cfg.n_layers,
                "fused_ce_fwd": 1, "fused_ce_bwd": 1}
    for k, n in per_step.items():
        assert training[k] == n * TRAIN_STEPS, f"training launched {k} {training[k]} times, " \
                                               f"want {n} per step x {TRAIN_STEPS}"
    shapes = _depthwise_shapes(MN["image_size"], MN["width"])
    blocks = sum(shapes.values())
    assert blocks == 17, shapes
    mn_train, mn_eval = mn_counts["mobilenet_train"], mn_counts["mobilenet_eval"]
    for k in ("depthwise_gn_fwd", "depthwise_gn_bwd"):
        assert mn_train[k] == blocks * MN_STEPS, f"MobileNet training launched {k} {mn_train[k]} " \
                                                 f"times, want {blocks} per step x {MN_STEPS}"
    assert mn_eval["depthwise_gn_fwd"] == blocks * -(-MN_VAL // MN_B), mn_eval
    # the f32 windows launch the f32 kernels alone, 17 + 17 a step and 17 a
    # chunk (the totals equal the f32 counts: no bf16 launch)
    assert sum(_depthwise_shapes(MN224["image_size"], MN224["width"]).values()) == blocks
    for w, steps in (("mobilenet_f32_train", MN_STEPS), ("mobilenet_f32_224", MN224_STEPS)):
        _exact(w, mnf_counts[w], {f"depthwise_gn_{d}{t}": blocks * steps
                                  for d in ("fwd", "bwd") for t in ("", "_f32")})
    _exact("mobilenet_f32_eval", mnf_counts["mobilenet_f32_eval"],
           {f"depthwise_gn_fwd{t}": blocks * -(-MN_VAL // MN_B) for t in ("", "_f32")})
    # under remat each layer's forward runs twice (once more in the backward)
    long_per_step = {"flash_attention_fwd": 2 * lt_cfg.n_layers,
                     "flash_attention_dq": lt_cfg.n_layers, "flash_attention_dkv": lt_cfg.n_layers,
                     "fused_ce_fwd": 1, "fused_ce_bwd": 1}
    for k, n in long_per_step.items():
        assert long_training[k] == n * LONG_TRAIN_STEPS, \
            f"long training launched {k} {long_training[k]} times, want {n} per step x {LONG_TRAIN_STEPS}"
    cn_train, cn_eval = cn_counts["convnet_train"], cn_counts["convnet_eval"]
    for k in ("fused_ce_dense_fwd", "fused_ce_dense_bwd"):
        assert cn_train[k] == CN_STEPS, f"ConvNet training launched {k} {cn_train[k]} times, " \
                                        f"want 1 per step x {CN_STEPS}"
    assert cn_eval["fused_ce_dense_fwd"] == -(-CN_VAL // CN_B), cn_eval
    train_report = {
        "steps": TRAIN_STEPS, "batch": TRAIN_B, "seq": TRAIN_S, "optimizer": "adam", "lr": 1e-3,
        "loss": trainer.spec.loss, "step_ms_p50": float(np.median(step_ms)),
        "step_ms_max": max(step_ms), "step_ms_first": step_ms[0],
        "tokens_per_s": TRAIN_B * TRAIN_S / (float(np.median(step_ms)) / 1e3),
        "first_loss": losses[0], "last_loss": losses[-1], "losses": losses,
        "peak_mem_gb": train_peak_gb}
    print("training:", json.dumps(train_report), flush=True)
    assert all(math.isfinite(v) for v in losses), losses
    assert losses[-1] <= losses[0] - LOSS_FALL, f"loss fell {losses[0] - losses[-1]} < {LOSS_FALL}"
    print("step_vs_plain:", json.dumps(_step_vs_plain(cfg, tree, x, y)), flush=True)
    print("mobilenet:", json.dumps(mn_report), flush=True)
    print("mobilenet_step_vs_plain:", json.dumps(_mobilenet_step_vs_plain(mn_tree, mn_batch)),
          flush=True)
    print("long_training:", json.dumps(lt_report), flush=True)
    torch.cuda.reset_peak_memory_stats()
    lt_vs_plain = _step_vs_plain(lt_cfg, tree, *lt_batch)
    lt_vs_plain["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print("long_step_vs_plain:", json.dumps(lt_vs_plain), flush=True)
    print("convnet:", json.dumps(cn_report), flush=True)
    print("convnet_step_vs_plain:", json.dumps(_convnet_step_vs_plain(cn_tree, cn_batch)),
          flush=True)

    # each kernel's count on its own path: prefill and paged decode on
    # serving, slab decode on solo generate(), paged int8 on long-context
    # serving, slab int8 on beam, the rest on training
    rows = _kernel_rows({"flash_attention_fwd": serving["flash_attention_fwd"],
                         "flash_decode_paged": serving["flash_decode_paged"],
                         "flash_decode": solo["flash_decode"]})
    int8_rows, rows[0]["long_context"] = _long_kernel_rows(
        {"flash_decode_paged_int8": long_counts["long_serving"]["flash_decode_paged_int8"],
         "flash_decode_int8": long_counts["beam"]["flash_decode_int8"]})
    rows += int8_rows
    train_rows, rows[0]["training_shape"] = _training_kernel_rows(training, TRAIN_STEPS)
    rows[0].update(_mesh_kernel_entries())
    rows += train_rows
    # an older checkout's depthwise kernels before and after this one's
    was = [_parent_times(args.parent, "_dwgn_times", list(shapes))] if args.parent else []
    dw_rows = _mobilenet_kernel_rows(
        {k: mn_train[k] for k in ("depthwise_gn_fwd", "depthwise_gn_bwd")}, shapes)
    if args.parent:
        was.append(_parent_times(args.parent, "_dwgn_times", list(shapes)))
    rows += _with_was(dw_rows, shapes, was)
    # an older checkout's f32 depthwise kernels and f32 MobileNet step
    # before and after this one's, by the same functions
    dwf_was = [_parent_times(args.parent, "_dwgn_f32_times")] if args.parent else []
    mnf_was = [_parent_report(args.parent, "_mobilenet_f32_step")] if args.parent else []
    dwf_rows = _mobilenet_f32_kernel_rows({k: mnf_counts["mobilenet_f32_train"][k]
                                           for k in ("depthwise_gn_fwd_f32", "depthwise_gn_bwd_f32")})
    dwf_now = None
    if args.parent:
        dwf_now, mnf_now = _dwgn_f32_times(), _mobilenet_f32_step()
        dwf_was.append(_parent_times(args.parent, "_dwgn_f32_times"))
        mnf_was.append(_parent_report(args.parent, "_mobilenet_f32_step"))
        print("mobilenet_f32_step:", json.dumps({
            **mnf_now, "was_step_ms_p50": [r["step_ms_p50"] for r in mnf_was],
            "was_profile": mnf_was}), flush=True)
    rows += _with_f32_dwgn_was(dwf_rows, dwf_was, dwf_now)
    rows += _split_bwd_rows(long_training, LONG_TRAIN_STEPS)
    # an older checkout's dense CE kernels before and after this one's
    ce_was = [_parent_times(args.parent, "_dense_ce_times")] if args.parent else []
    ce_rows = _dense_ce_rows(cn_train, CN_STEPS, wire_counts, ip_counts)
    if args.parent:
        ce_was.append(_parent_times(args.parent, "_dense_ce_times"))
    rows += _with_ce_was(ce_rows, ce_was)
    floor = _launch_floor()
    spec_windows = ("spec_1k", "spec_16k")
    # an older checkout's decode kernels and speculative 16k round before
    # and after this one's, by the same functions
    decode_was = [_parent_times(args.parent, "_decode_d32_times")] if args.parent else []
    round_was = [_parent_report(args.parent, "_spec_round_16k")] if args.parent else []
    rows += _with_decode_was(_spec_kernel_rows({
        "flash_attention_fwd_d32": sum(spec_counts[w]["flash_attention_fwd_d32"]
                                       for w in spec_windows),
        "flash_decode_paged_d32": sum(spec_counts[w]["flash_decode_paged_d32"]
                                      for w in spec_windows),
        "flash_decode_d32": spec_counts["draft_solo"]["flash_decode_d32"]}), decode_was)
    if args.parent:
        decode_now, round_now = _decode_d32_times(), _spec_round_16k()
        decode_was.append(_parent_times(args.parent, "_decode_d32_times"))
        round_was.append(_parent_report(args.parent, "_spec_round_16k"))
        print("decode_times:", json.dumps({"now": decode_now, "was": decode_was}), flush=True)
        print("spec_16k_round:", json.dumps({**round_now, "was": round_was}), flush=True)
    rows.append(_p64_kernel_row(fleet_counts["fleet_elastic"]["flash_decode_paged"]))
    # the mesh's TP and pipeline shapes, in the rows of the kernels they run
    tp_entries = _mesh_tp_entries()
    for r in rows:
        r.update(tp_entries.get(r["name"], {}))
    rows.append(_p16_kernel_row(doctor_counts["flash_decode_paged"]))
    # the CLI's paths: each new variant's count from the window that runs it
    cli_rows = {"flash_attention_bwd_d32": "lm_cli_train", "flash_attention_dq_d32": "lm_cli_long",
                "flash_attention_dkv_d32": "lm_cli_long",
                **{k: "lm_cli_f32" for k in ("flash_attention_fwd_f32", "flash_attention_bwd_f32",
                                             "fused_ce_fwd_f32", "fused_ce_bwd_f32")},
                **{k: None for k in ("fused_ce_dense_fwd_f32", "fused_ce_dense_bwd_f32")},
                "flash_decode_f32": "lm_cli_f32_generate", "flash_decode_paged_f32": "lm_cli_f32_serve",
                "flash_attention_dq_f32": "lm_cli_f32_long",
                "flash_attention_dkv_f32": "lm_cli_f32_long",
                "flash_attention_fwd_f32_long": "lm_cli_f32_long"}
    # kernel 1 in f32 at path (d)'s shape reads the f32 forward's counter
    counter = {"flash_attention_fwd_f32_long": "flash_attention_fwd_f32"}
    cli_launches = {k: cli_counts[w][counter.get(k, k)] if w else 0 for k, w in cli_rows.items()}
    # an older checkout's f32 attention kernels before and after this one's
    f32_was = [_parent_times(args.parent, "_f32_attention_times")] if args.parent else []
    bf16_was = [_parent_times(args.parent, "_bf16_attention_times")] if args.parent else []
    steps_was = {p: [_parent_report(args.parent, "_path_steps", p)] if args.parent else []
                 for p in "bc"}
    cli_kernel_rows = (_lm_cli_attention_rows(cli_launches) + _lm_cli_ce_rows(cli_launches)
                       + _lm_cli_f32_rows(cli_launches))
    for r in rows:
        if r["name"] == "flash_attention_fwd_d32":
            r.update(_fwd_d32_entries(_flush_buffer()))
    if args.parent:
        # path (b)'s step and the bf16 attention kernels on this checkout,
        # between the older checkout's runs, by the same functions
        step_now = {p: _path_steps(p) for p in "bc"}
        bf16_now = _bf16_attention_times()
        f32_was.append(_parent_times(args.parent, "_f32_attention_times"))
        bf16_was.append(_parent_times(args.parent, "_bf16_attention_times"))
        for p, window in (("b", "long"), ("c", "float32")):
            steps_was[p].append(_parent_report(args.parent, "_path_steps", p))
            print(f"path_{p}_step:", json.dumps({
                "step_ms_p50": step_now[p]["step_ms_p50"], "profile": step_now[p]["profile"],
                f"lm_cli_{window}_step_ms_p50": cli_report[window]["step_ms_p50"],
                "was_step_ms_p50": [w["step_ms_p50"] for w in steps_was[p]],
                "was_profile": steps_was[p][0]["profile"]}), flush=True)
        print("bf16_attention_times:", json.dumps({"now": bf16_now, "was": bf16_was}), flush=True)
    rows += _with_f32_was(cli_kernel_rows, f32_was)
    _with_bf16_was(rows, bf16_was)
    # a NaN in an input reaches the attention kernels', the fused CE
    # forward's and the decode kernels' outputs as their plain versions'
    t0 = time.perf_counter()
    nan = _nan_phase(LM_CLI["n_heads"])
    print("nan_checks:", json.dumps({**nan, "phase_s": time.perf_counter() - t0}), flush=True)
    for r in rows:
        if r["name"] in NAN_ROWS:
            r["nan_reaches"] = nan[NAN_ROWS[r["name"]]]
    path_of = {"flash_decode": "solo_generate", "flash_decode_paged_int8": "long_serving",
               "flash_decode_int8": "beam", **{k: "training" for k in training_only},
               "depthwise_gn_fwd": "mobilenet_train", "depthwise_gn_bwd": "mobilenet_train",
               "depthwise_gn_fwd_f32": "mobilenet_f32_train",
               "depthwise_gn_bwd_f32": "mobilenet_f32_train",
               "flash_attention_dq": "long_training", "flash_attention_dkv": "long_training",
               "fused_ce_dense_fwd": "convnet_train", "fused_ce_dense_bwd": "convnet_train",
               "flash_attention_fwd_d32": "spec_1k", "flash_decode_paged_d32": "spec_1k",
               "flash_decode_d32": "draft_solo", "flash_decode_paged_p64": "fleet_elastic",
               "flash_decode_paged_p16": "doctor", **cli_rows}
    for r in rows:
        r["floor_ms"] = floor
        r["path"] = path_of.get(r["name"], "serving")
        # page 64 runs on the elastic leg alone, page 16 in the doctor alone,
        # kernel 1 in f32 at S 16384 on path (d) alone: no counter of their own
        own = r["name"] not in ("flash_decode_paged_p64", "flash_decode_paged_p16", *counter)
        r["launches_by_path"] = ({p: c[r["name"]] for p, c in paths.items()} if own
                                 else {r["path"]: r["launches"]})
    print("decode_iteration_profile:",
          json.dumps(_profile_decode_iteration(model, rng, [128, 300, 512, 1000] * 2)), flush=True)
    print("training_step_profile:", json.dumps(_profiled(lambda: trainer.step((x, y)))), flush=True)
    print("mobilenet_step_profile:", json.dumps(_profiled(lambda: mn_trainer.step(mn_batch))),
          flush=True)
    print("long_training_step_profile:", json.dumps(_profiled(lambda: lt_trainer.step(lt_batch))),
          flush=True)
    print("convnet_step_profile:", json.dumps(_profiled(lambda: cn_trainer.step(cn_batch))),
          flush=True)
    roofline = _roofline_phase(ip_report["cost"], rows)
    print("roofline:", json.dumps(roofline), flush=True)
    assert len(rows) == 35, [r["name"] for r in rows]
    print(json.dumps({"kernels": _with_spread(rows)}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
