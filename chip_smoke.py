"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--parent DIR]

``--parent DIR`` (an unpacked older checkout, e.g. ``git archive`` of the
parent commit) also times that checkout's depthwise and dense CE kernels
on the same inputs, before and after this checkout's (rows 11-12, 9d and
10d, ``was_ms``).

1. Prints the card's name and power limit, builds the port's CUDA kernels
   from ``distriflow_tpu_torch/csrc`` (one ``nvcc`` per source, all five
   in parallel) and prints the build time.
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
    does.
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
    [0, 1]; updates/s, samples/s, each phase's p50 and max and the
    staleness histogram. (b) One worker, 16 batches, full broadcasts
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
    profiled (``round_profile``).
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
before the last is the kernel table as JSON (19 rows); the last line is
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
       "flash_attention_dq": (1e-3, 2 ** -7),
       "flash_attention_dkv": (1e-3, 2 ** -7),
       "fused_ce_dense_fwd": (1e-5, 1e-6),
       "fused_ce_dense_bwd": (1e-8, 2 ** -7)}
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
# The dense CE forward adds sum(x * t) over the row in f32 in another
# order than its plain version, as the sparse one adds its exps (measured
# 9.5e-7 at V 10 and at V 32000): the sparse limit. The dense CE gradient
# differs only by a rounding flip of the bf16 output (measured 0.0), as
# the sparse one.
LSE_ATOL = 1e-4
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
# The timer's device spin before each bracket (_timed): between SPIN_MIN_S
# and SPIN_MAX_S, counted in cycles of the H100 SXM's highest SM clock
# (1.98 GHz), so that a card at a lower clock spins longer, never shorter
SPIN_MIN_S, SPIN_MAX_S, SPIN_CLOCK_HZ = 1e-4, 0.1, 1.98e9
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12          # H100 SXM f32 outside the tensor cores
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


def _serve(model, reqs, counted, direct=()):
    """Drive the port's server with the port's client: the ``generate``
    requests in one counted window (:func:`_generate_wave`), then each
    ``(name, fn(client))`` of ``direct`` in a window of its own. Returns
    ``(outputs by name, engine stats, the generate window's launch counts,
    {name: (result, launch counts)})`` after stopping the server."""
    from distriflow_tpu_torch.client.inference_client import InferenceClient
    from distriflow_tpu_torch.obs.telemetry import Telemetry
    from distriflow_tpu_torch.server.inference_server import InferenceServer

    server = InferenceServer(model, telemetry=Telemetry()).setup()
    clients = [InferenceClient(server.address, timeout=600).setup() for _ in reqs]
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
    return outs, {
        "decode_batches": server.decode_batches,
        "prefix_hits": server.prefix_hits,
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


def _profiled(step):
    """One call of ``step`` under ``torch.profiler``: host wall time against
    the device time of the kernels it launched, and the kernels that took
    the most."""
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
    return {"wall_ms": wall_ms, "device_ms": dev_ms if kernels else "not measured",
            "idle_share": (1 - dev_ms / wall_ms) if kernels else "not measured",
            "device_launches": sum(e.count for e in kernels),
            "top_kernels": [[e.key[:70], e.count, e.self_device_time_total / 1e3] for e in top]}


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
    return f"atol {atol} + rtol {rtol} x |plain|"


def _over(name, got, want, atol, rtol):
    """Max abs error of ``got`` against ``want``; raises where an element
    lies outside ``atol + rtol * |want|``."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bad = int((err > atol + rtol * want.abs()).sum())
    if bad:
        raise AssertionError(f"{name}: {bad} elements outside atol {atol} + rtol {rtol}, "
                             f"max abs err {float(err.max())}")
    return float(err.max())


def _bound(nbytes, flops, peak=BF16_FLOPS):
    """(least ms, what bounds it): bytes over the HBM rate against the
    operations over the card's peak for their type."""
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def _flush_buffer():
    return torch.empty(32 << 20, dtype=torch.float32, device="cuda")  # 128 MB > 50 MB L2


def _wrong_combines(name, parts, want):
    """The share of elements outside ``name``'s limit around the plain
    output ``want`` for three wrong combines of the plain split partials
    ``parts``: without the exp(m_i - M) rescale (over the rows with two or
    more live splits, the only ones it changes), without the split holding
    each (row, head)'s max, and without each row's last live split (which
    may hold too little of a peaked softmax to show: reported only)."""
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
    return {"no_rescale": _rejected(name, no_rescale[multi], want[multi]),
            "drop_max_split": _rejected(name, fd.combine_partials(no_max).to(want.dtype), want),
            "drop_last_split": _rejected(name, fd.combine_partials(no_last).to(want.dtype), want)}


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
    tb, by = _bound(4 * b * h * s * d * 2 + b * h * s * 4, 4 * b * h * pairs * d)
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
                   4 * live * h * d)
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
    tb, by = _bound(2 * n * h * d * 2 + 2 * h * d * 2, 4 * n * h * d)
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


def _train(cfg, tree, batches, device="cuda"):
    """The port's ``SyncTrainer`` (adam, lr 1e-3) on the flagship from the
    carried-over f32 masters, one step per ``(x, y)`` of ``batches``;
    returns ``(trainer, losses, step ms)``."""
    from distriflow_tpu_torch.models.convert import params_from_jax
    from distriflow_tpu_torch.models.transformer import transformer_lm
    from distriflow_tpu_torch.train.sync import SyncTrainer

    trainer = SyncTrainer(transformer_lm(cfg, device=device), optimizer="adam", learning_rate=1e-3)
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
    tb, by = _bound(4 * b * h * s * d * 2 + b * h * s * 4, 4 * b * h * pairs * d)
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
    tb, by = _bound(7 * b * h * s * d * 2 + 2 * b * h * s * 4, 5 * 2 * b * h * pairs * d)
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
    tb, by = _bound(7 * b * h * s * d * 2 + 2 * b * h * s * 4, 5 * 2 * b * h * s * (s + 1) // 2 * d)
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


def _long_phase(cfg, tree, rng, counted, device="cuda"):
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
    outs, stats, serving, done = _serve(model, reqs, counted, direct)
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
                  4 * live * h * d, INT8_OPS)


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
            "bf16_bound_ms": _bound(2 * 8 * ctx * h * d * 2, 4 * 8 * ctx * h * d)[0],
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
    tb, by = _bound(4 * h * s * d * 2 + h * s * 4, 4 * h * pairs * d)
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


def _mobilenet_spec(device="cuda"):
    """The slice's MobileNetV2 spec: fused depthwise kernels, bf16, uint8
    input, sparse CE (the CLI's ``--wire-format u8``)."""
    from distriflow_tpu_torch.models.base import with_uint8_inputs
    from distriflow_tpu_torch.models.mobilenet import mobilenet_v2

    spec = mobilenet_v2(**MN, norm="group", dtype=torch.bfloat16, depthwise_impl="fused",
                        gn_impl="flax", device=device)
    return dataclasses.replace(with_uint8_inputs(spec), loss="sparse_softmax_cross_entropy")


def _mobilenet_phase(tree, counted, device="cuda"):
    """MobileNetV2 trained ``MN_STEPS`` steps by the port's ``run_chunked``
    over ``sampling_iterator`` + ``prefetch_to_device``, then evaluated by
    ``evaluate_dataset`` on the validation split, each in its own launch
    window. Returns ``(report, trainer, a batch, launch counts by window)``."""
    from distriflow_tpu_torch.data.prefetch import prefetch_to_device, sampling_iterator, to_uint8_wire
    from distriflow_tpu_torch.models.convert import mobilenet_params_from_jax
    from distriflow_tpu_torch.train.loop import evaluate_dataset, run_chunked
    from distriflow_tpu_torch.train.sync import SyncTrainer

    t0 = time.perf_counter()
    train, val = _synthetic_imagenet(MN_TRAIN, MN_VAL, MN["classes"], MN["image_size"], SEED)
    x, y = to_uint8_wire(*train)
    vx, vy = to_uint8_wire(*val)
    data_s = time.perf_counter() - t0
    trainer = SyncTrainer(_mobilenet_spec(device), optimizer="momentum", learning_rate=MN_LR)
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
        "config": {**MN, "batch": MN_B, "dtype": "bfloat16", "depthwise_impl": "fused",
                   "gn_impl": "flax", "norm": "group", "wire": "uint8",
                   "loss": trainer.spec.loss, "optimizer": "momentum", "lr": MN_LR},
        "steps": MN_STEPS, "train_images": MN_TRAIN, "val_images": MN_VAL, "data_s": data_s,
        "step_ms_p50": p50, "step_ms_max": max(step_ms), "step_ms_first": step_ms[0],
        "samples_per_s": MN_B / (p50 / 1e3),
        "steady_samples_per_s": res.steps_per_sec * MN_B,
        "first_loss": losses[0], "last_loss": losses[-1], "first5_mean": first,
        "last5_mean": last, "losses": losses, "val_loss": val_loss, "val_accuracy": val_acc,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9 if device == "cuda" else None}
    batch = next(sampling_iterator(x, y, MN_B, steps=1, seed=SEED + 1))
    return report, trainer, batch, {"mobilenet_train": train_counts, "mobilenet_eval": eval_counts}


def _mobilenet_step_vs_plain(tree, batch, device="cuda"):
    """One step's loss and gradients through the depthwise kernels and
    through their plain versions (patched in for the wrappers, forward and
    backward), from the same f32 masters and batch."""
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
    spec, out = _mobilenet_spec(device), {}
    for name in ("kernels", "plain"):
        model = spec.init(SEED)
        model.load_state_dict(mobilenet_params_from_jax(tree), strict=True)
        with plain() if name == "plain" else contextlib.nullcontext():
            loss, grads = spec.grad_fn()(model, x, y)
        out[name] = (float(loss), grads)
        del model
    return _grads_vs_plain(out, MN_STEP_TOL, "loss_rel")


def _dwgn_inputs(g, b, h, w, c):
    """bf16 NHWC x ~ N(0, 1), a lecun-scaled [3, 3, C] kernel, affine near
    flax's init, and an upstream gradient ~ U(0, 1): of nonzero mean, so
    the GroupNorm statistics' terms carry real weight in dx."""
    dev = torch.device("cuda")
    x = torch.randn(b, h, w, c, generator=g, device=dev).to(torch.bfloat16)
    k = (torch.randn(3, 3, c, generator=g, device=dev) / 3).to(torch.bfloat16)
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


def _dwgn_cases(shapes):
    """``(shape, x, k, scale, bias, g)`` of every depthwise shape at B
    ``MN_B``, drawn in order from one seeded generator: the same tensors in
    every run and every checkout."""
    from distriflow_tpu_torch.ops import depthwise_gn as dg

    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    for key in shapes:
        h, w, c, s = key
        x, k, sc, bi = _dwgn_inputs(g, MN_B, h, w, c)
        _, _, oh, ow = dg._geometry(h, w, s)
        gout = torch.rand(MN_B, oh, ow, c, generator=g, device="cuda").to(torch.bfloat16)
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
    return {"cc": plan.cc, "cluster": plan.cluster, "tile": [plan.rows, plan.cols],
            "tiles_per_cta": plan.tiles_per_cta, "images_per_cta": plan.images,
            "ctas": plan.ctas(batch), "smem_bytes": plan.smem}


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


def _markov_corpus(n_tokens: int, seed: int) -> np.ndarray:
    """The JAX repo's ``experiments/lm/data.py::generate_corpus`` recipe at
    order 1: a seeded table of ``CORPUS_BRANCHING`` successors for each of
    the ``CORPUS_VOCAB`` ids, walked by seeded choices; ``[n_tokens]``
    int32."""
    rng = np.random.RandomState(seed)
    table = rng.randint(0, CORPUS_VOCAB, size=(CORPUS_VOCAB, CORPUS_BRANCHING))
    rng = np.random.RandomState(seed + 1)
    out = np.empty(n_tokens, np.int32)
    ctx = rng.randint(0, CORPUS_VOCAB)
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
    from distriflow_tpu_torch.data.prefetch import prefetch_to_device, sampling_iterator
    from distriflow_tpu_torch.models.convert import zoo_params_from_jax
    from distriflow_tpu_torch.train.loop import evaluate_dataset, run_chunked
    from distriflow_tpu_torch.train.sync import SyncTrainer

    t0 = time.perf_counter()
    train, val = _synthetic_cifar10(CN_TRAIN, CN_VAL, SEED)
    (x, y), (vx, vy) = _to_xy(train), _to_xy(val)
    data_s = time.perf_counter() - t0
    trainer = SyncTrainer(_convnet_spec(device), optimizer="sgd", learning_rate=CN_LR)
    trainer.init(SEED)
    trainer.set_params(zoo_params_from_jax(tree))
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
    assert last < first, f"ConvNet loss did not fall: first 5 mean {first}, last 5 mean {last}"
    assert math.isfinite(val_loss) and 0.0 <= val_acc <= 1.0, (val_loss, val_acc)
    p50 = float(np.median(step_ms))
    report = {
        "config": {"model": "cifar_convnet", "batch": batch, "dtype": "bfloat16",
                   "loss": trainer.spec.loss, "targets": "one-hot f32", "optimizer": "sgd",
                   "lr": CN_LR},
        "steps": steps, "train_images": CN_TRAIN, "val_images": CN_VAL, "data_s": data_s,
        "step_ms_p50": p50, "step_ms_max": max(step_ms), "step_ms_first": step_ms[0],
        "samples_per_s": batch / (p50 / 1e3), "steady_samples_per_s": res.steps_per_sec * batch,
        "first_loss": losses[0], "last_loss": losses[-1], "first5_mean": first,
        "last5_mean": last, "losses": losses, "val_loss": val_loss, "val_accuracy": val_acc}
    step_batch = next(sampling_iterator(x, y, batch, steps=1, seed=SEED + 1))
    return report, trainer, step_batch, {"convnet_train": train_counts, "convnet_eval": eval_counts}


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


def _async_leg(tree, x, y, device, workers, epochs, delta_broadcast, save_dir, snapshot_at=0):
    """Port ``AsynchronousSGDServer`` over ``epochs`` epochs of ``x, y`` in
    batches of ``WIRE_B``, with ``workers`` port ``AsynchronousSGDClient``
    threads on ``device``. Returns ``(report, server model, dispatch order,
    fits, a copy of the server's params after ``snapshot_at`` applied
    updates or None)``."""
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
    order, snap = [], []
    server.on_upload(lambda msg: order.append(msg.batch))
    # fired on the apply thread after each apply, before the next one
    server.on_new_version(lambda _: snap.append(copy_tree(server.model.get_params()))
                          if server.applied_updates == snapshot_at else None)
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
    return report, server_model, order, fits, (snap[0] if snap else None)


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


def _wire_legs(tree, counted, device, x, y, vx, vy, save_dir):
    from distriflow_tpu_torch import native

    batches = WIRE_TRAIN // WIRE_B * WIRE_EPOCHS
    epoch = WIRE_TRAIN // WIRE_B
    (a_report, a_model, a_order, a_fits, a_epoch), a_counts = counted(lambda: _async_leg(
        tree, x, y, device, WIRE_WORKERS, WIRE_EPOCHS, True, save_dir, snapshot_at=epoch))
    val_loss, val_acc = a_model.evaluate(vx, vy)[:2]
    del a_model
    # the no-update control: the initial weights, which a server that
    # applied nothing would end with; the spread of their validation loss
    # over four slices of the set is the margin training must clear
    probe = _wire_model(tree, device)
    init_val, spread = _val_spread(probe, vx, vy)
    probe.set_params(a_epoch)
    epoch_val = probe.evaluate(vx, vy)[0]
    del probe, a_epoch
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
                    epoch1_val_loss=epoch_val, replays=replays)
    assert all(math.isfinite(v) for v in losses), losses
    # the loss falls: after the first epoch the server's weights beat the
    # initial weights' validation loss by more than the control's spread
    # (a server that applied no update fails this). The second epoch's
    # climb, and so the final weights, are not held to it
    assert init_val - epoch_val > spread, \
        f"async wire training did not lower the validation loss in epoch 1: {init_val} -> " \
        f"{epoch_val}, spread {spread}"
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


def _rejected(name, wrong, want):
    """The share of ``wrong``'s elements outside ``name``'s limit around
    ``want``."""
    atol, rtol = TOL[name]
    wrong, want = wrong.float(), want.float()
    return float(((wrong - want).abs() > atol + rtol * want.abs()).float().mean())


# (S, causal) of the backward kernels' ragged checks: lengths that end
# inside a tile, on both causal branches
RAGGED_BWD = ((37, True), (37, False), (1000, True), (1000, False))


def _atol_needed(name, pairs):
    """The least atol that the elements of every (kernel, plain) pair need
    above ``name``'s rtol."""
    rtol = TOL[name][1]
    return max(float(((a.float() - w.float()).abs() - rtol * w.float().abs()).max())
               for a, w in pairs)


def _bwd_inputs(g, b, h, s, causal):
    """The backward kernels' arguments ``(q, k, v, dO, lse, delta, causal)``
    at [b, h, s, 64] bf16 from one forward, K and V drawn around 1 (see
    :func:`_split_bwd_rows`)."""
    from distriflow_tpu_torch.ops import flash_attention as fa

    q, k, v, do = ((torch.randn(b, h, s, 64, generator=g, device="cuda") + mean)
                   .to(torch.bfloat16) for mean in (0.0, 1.0, 1.0, 0.0))
    o, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    return q, k, v, do, lse, (do.float() * o.float()).sum(-1), causal


def _ragged_bwd(name, fn, plain, g, b, h):
    """The max abs error of ``fn`` (a tuple of gradients) against ``plain``
    at each (S, causal) of :data:`RAGGED_BWD`; raises outside the limit."""
    out = {}
    for s, causal in RAGGED_BWD:
        args = _bwd_inputs(g, b, h, s, causal)
        tag = f"S={s} {'causal' if causal else 'non-causal'}"
        out[tag] = max(_over(f"{name} {tag}", a, w, *TOL[name])
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
    err_q = _over("flash_attention_dq", dq, want_q, *TOL["flash_attention_dq"])
    # the least atol each kernel's elements need above the limit's rtol
    needed = {"flash_attention_dq": _atol_needed("flash_attention_dq", [(dq, want_q)]),
              "flash_attention_dkv": _atol_needed("flash_attention_dkv",
                                                  [(dk, want_k), (dv, want_v)])}
    err_kv = max(_over("flash_attention_dkv dk", dk, want_k, *TOL["flash_attention_dkv"]),
                 _over("flash_attention_dkv dv", dv, want_v, *TOL["flash_attention_dkv"]))
    # no atomics: a second launch gives the same bits
    again_k, again_v = fa.flash_attention_dkv(*args)
    assert torch.equal(fa.flash_attention_dq(*args), dq), "flash_attention_dq is not deterministic"
    assert torch.equal(again_k, dk) and torch.equal(again_v, dv), \
        "flash_attention_dkv is not deterministic"
    # the limits must reject wrong gradients: dS without the delta term,
    # and dK without the 1/sqrt(D) scale
    no_delta = fa.flash_attention_dq_reference(q, k, v, do, lse, torch.zeros_like(delta), True)
    controls_q = {"no_delta": _rejected("flash_attention_dq", no_delta, want_q)}
    controls_kv = {"dk_unscaled": _rejected("flash_attention_dkv", want_k.float() * math.sqrt(d),
                                            want_k)}
    del no_delta, again_k, again_v
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
        tb, by = _bound(io + outs * b * h * s * d * 2, products * 2 * pairs * d)
        rows.append({
            "name": name, "route": "cuda", "source": "distriflow_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": line, "launches": launches[name], "launches_per_step": launches[name] / steps,
            "max_abs_err": err, "tol": _tol(name), "shape": f"B={b} H={h} S={s} D={d} causal",
            "ms": _timed(lambda: fn(*args), 10, flush), "plain_ms": _timed(lambda: plain(*args), 1, flush),
            "bound_ms": tb, "bound_by": by, "library_ms": library,
            "library_note": "F.scaled_dot_product_attention backward: dQ, dK and dV together",
            "rejected_share": controls, "deterministic": True,
            "atol_needed": needed[name]})
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
    """``fn(*args)`` (a timing function of this file, by name) on the
    checkout at ``parent``, in a process of its own (the parent's package
    and kernels, this file's timer)."""
    torch.cuda.empty_cache()
    code = ("import importlib.util, json, sys\n"
            f"spec = importlib.util.spec_from_file_location('smoke', {os.path.abspath(__file__)!r})\n"
            "m = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(m)\n"
            f"print(json.dumps(m.{fn}(*{list(args)!r})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=parent, capture_output=True, text=True,
                         timeout=600, check=True)
    return {k: [float(v) for v in t] for k, t in json.loads(out.stdout.splitlines()[-1]).items()}


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


def _profile_spec_round(target, draft, prompt, device="cuda"):
    """One speculative round (draft k, verify, commit) of the engine's
    ``SPEC_SLOTS`` slots with one live row at ``prompt``'s context, under
    ``torch.profiler`` after a warm round (:func:`_profiled`)."""
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
    return _profiled(round_)


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
    windows)``."""
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
    return report, windows


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
    decode rows' wrong-combine rejections, split sweep and edges."""
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
        tb, by = _bound(4 * h * s * d * 2 + h * s * 4, 4 * h * pairs * d)
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
    tb, by = _bound(2 * live * h * d * 2 + 2 * bsz * h * d * 2 + table.numel() * 4 + bsz * 4,
                    4 * live * h * d)
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
                         lambda: fd.split_partials(q1, kp, vp, lens, table), flush, 200)})

    # slab: the draft's solo generate() (max_seq 16384) at its last step
    s_max, n = SPEC_CONTEXTS[1], SPEC_CONTEXTS[0] - SPEC_NEW + SPEC_DRAFT_SOLO_NEW
    ks, vs, qs = randn(1, s_max, h * d), randn(1, s_max, h * d), randn(1, h, d)
    kh = ks.view(1, s_max, h, d).transpose(1, 2)[:, :, :n].contiguous()
    vh = vs.view(1, s_max, h, d).transpose(1, 2)[:, :, :n].contiguous()
    tb, by = _bound(2 * n * h * d * 2 + 2 * h * d * 2, 4 * n * h * d)
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
                         lambda: fd.split_partials(qs, ks, vs, n), flush, 200)})
    return rows


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
                    4 * live * h * d)
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


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA port on one GPU.")
    ap.add_argument("--parent", help="an older checkout whose depthwise kernels to time too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from distriflow_tpu_torch.models.convert import lm_from_jax
    from distriflow_tpu_torch.models.generate import generate
    from distriflow_tpu_torch.models.zoo import flagship_lm_config
    from distriflow_tpu_torch.ops import build
    from distriflow_tpu_torch.ops import depthwise_gn as dg
    from distriflow_tpu_torch.ops import flash_attention as fa
    from distriflow_tpu_torch.ops import flash_decode as fd
    from distriflow_tpu_torch.ops import fused_ce as ce

    print(_card(), flush=True)

    t0 = time.perf_counter()
    build.build_all()
    print(f"kernel build s: {time.perf_counter() - t0:.2f}", flush=True)
    for name, log in build.ptxas_reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")

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

    counters = {"flash_attention_fwd": fa.flash_attention,
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
    training_only = ("flash_attention_bwd", "fused_ce_fwd", "fused_ce_bwd")

    # the kernels built at two head dims also count their D 32 launches
    by_head_dim = ("flash_attention_fwd", "flash_decode_paged", "flash_decode")

    def counted(run):
        for fn in counters.values():
            fn.launches = 0
        for k in by_head_dim:
            counters[k].launches_by_head_dim = {}
        out = run()
        counts = {k: fn.launches for k, fn in counters.items()}
        counts.update({f"{k}_d32": counters[k].launches_by_head_dim.get(32, 0)
                       for k in by_head_dim})
        return out, counts

    t0 = time.perf_counter()
    outs, stats, serving, _ = _serve(model, reqs, counted)
    serve_s = time.perf_counter() - t0
    solos, solo = counted(lambda: _solo(model, reqs))
    report = _check_greedy(model, reqs, outs, solos)
    print("serving:", json.dumps({"wall_s": serve_s, **stats}), flush=True)
    print("parity:", json.dumps(report), flush=True)
    assert stats["prefix_hits"] >= 1, "the prefix-sharing path did not run"

    # long context: the same tree at max_seq 16384 with the int8 KV cache
    long_cfg = dataclasses.replace(flagship_lm_config(max_seq=LONG_MAX_SEQ), kv_cache_dtype="int8")
    long_report, long_counts = _long_phase(long_cfg, tree, np.random.default_rng(SEED + 4), counted)
    print("long_context:", json.dumps(long_report), flush=True)
    # speculative decoding: a distilled head-dim-32 draft over the target's
    # page pool, at 1k and 16k context, against plain paged decode
    t0 = time.perf_counter()
    spec_report, spec_counts = _spec_phase(model, reqs, solos, counted)
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

    # training: the flagship from the same tree as f32 masters, one batch
    tokens = np.random.default_rng(SEED + 2).integers(
        0, cfg.vocab_size, (TRAIN_B, TRAIN_S + 1)).astype(np.int32)
    x, y = tokens[:, :-1], tokens[:, 1:]
    (trainer, losses, step_ms), training = counted(lambda: _train(cfg, tree, [(x, y)] * TRAIN_STEPS))
    train_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # MobileNetV2 at the slice's configuration: train, then evaluate
    mn_tree = _mobilenet_tree(np.random.default_rng(SEED + 6), MN["classes"], MN["width"])
    mn_report, mn_trainer, mn_batch, mn_counts = _mobilenet_phase(mn_tree, counted)
    # long-context training: the flagship at 16k with remat, the two-kernel
    # backward
    lt_report, lt_trainer, lt_cfg, lt_batch, long_training = _long_training(tree, counted)
    # the CIFAR-10 ConvNet with the fused dense CE: train, then evaluate
    cn_tree = _convnet_tree(np.random.default_rng(SEED + 9))
    cn_report, cn_trainer, cn_batch, cn_counts = _convnet_phase(cn_tree, counted)
    # the wire-training planes: the same ConvNet trained by port servers and
    # in-process port workers over loopback TCP
    t0 = time.perf_counter()
    wire_report, wire_counts = _wire_phase(cn_tree, counted)
    wire_report["phase_s"] = time.perf_counter() - t0
    print("wire_training:", json.dumps(wire_report), flush=True)
    # the in-process trainers on the same ConvNet, then the cost of the
    # ConvNet's and the 16k LM's sync steps at their measured p50
    t0 = time.perf_counter()
    ip_report, ip_counts = _inprocess_phase(cn_tree, counted)
    ip_report["phase_s"] = time.perf_counter() - t0
    ip_report["cost"] = _cost_phase(cn_trainer, cn_batch, cn_report, lt_trainer, lt_cfg,
                                    lt_batch, lt_report)
    print("inprocess_training:", json.dumps(ip_report), flush=True)
    paths = {"serving": serving, "solo_generate": solo, **long_counts, **spec_counts,
             **fleet_counts, "doctor": doctor_counts, "training": training, **mn_counts, "long_training": long_training, **cn_counts,
             **wire_counts, **ip_counts}
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
           "long_training": ("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv",
                             "fused_ce_fwd", "fused_ce_bwd"),
           "convnet_train": ("fused_ce_dense_fwd", "fused_ce_dense_bwd"),
           "convnet_eval": ("fused_ce_dense_fwd",),
           **{w: ("fused_ce_dense_fwd", "fused_ce_dense_bwd")
              for w in (*wire_counts, *ip_counts)}}
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
    rows += train_rows
    # an older checkout's depthwise kernels before and after this one's
    was = [_parent_times(args.parent, "_dwgn_times", list(shapes))] if args.parent else []
    dw_rows = _mobilenet_kernel_rows(
        {k: mn_train[k] for k in ("depthwise_gn_fwd", "depthwise_gn_bwd")}, shapes)
    if args.parent:
        was.append(_parent_times(args.parent, "_dwgn_times", list(shapes)))
    rows += _with_was(dw_rows, shapes, was)
    rows += _split_bwd_rows(long_training, LONG_TRAIN_STEPS)
    # an older checkout's dense CE kernels before and after this one's
    ce_was = [_parent_times(args.parent, "_dense_ce_times")] if args.parent else []
    ce_rows = _dense_ce_rows(cn_train, CN_STEPS, wire_counts, ip_counts)
    if args.parent:
        ce_was.append(_parent_times(args.parent, "_dense_ce_times"))
    rows += _with_ce_was(ce_rows, ce_was)
    floor = _launch_floor()
    spec_windows = ("spec_1k", "spec_16k")
    rows += _spec_kernel_rows({
        "flash_attention_fwd_d32": sum(spec_counts[w]["flash_attention_fwd_d32"]
                                       for w in spec_windows),
        "flash_decode_paged_d32": sum(spec_counts[w]["flash_decode_paged_d32"]
                                      for w in spec_windows),
        "flash_decode_d32": spec_counts["draft_solo"]["flash_decode_d32"]})
    rows.append(_p64_kernel_row(fleet_counts["fleet_elastic"]["flash_decode_paged"]))
    rows.append(_p16_kernel_row(doctor_counts["flash_decode_paged"]))
    path_of = {"flash_decode": "solo_generate", "flash_decode_paged_int8": "long_serving",
               "flash_decode_int8": "beam", **{k: "training" for k in training_only},
               "depthwise_gn_fwd": "mobilenet_train", "depthwise_gn_bwd": "mobilenet_train",
               "flash_attention_dq": "long_training", "flash_attention_dkv": "long_training",
               "fused_ce_dense_fwd": "convnet_train", "fused_ce_dense_bwd": "convnet_train",
               "flash_attention_fwd_d32": "spec_1k", "flash_decode_paged_d32": "spec_1k",
               "flash_decode_d32": "draft_solo", "flash_decode_paged_p64": "fleet_elastic",
               "flash_decode_paged_p16": "doctor"}
    for r in rows:
        r["floor_ms"] = floor
        r["path"] = path_of.get(r["name"], "serving")
        # page 64 runs on the elastic leg alone, page 16 in the doctor alone
        # (the counters do not split by page)
        by_page = r["name"] in ("flash_decode_paged_p64", "flash_decode_paged_p16")
        r["launches_by_path"] = ({r["path"]: r["launches"]} if by_page
                                 else {p: c[r["name"]] for p, c in paths.items()})
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
    assert len(rows) == 19, [r["name"] for r in rows]
    print(json.dumps({"kernels": _with_spread(rows)}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
