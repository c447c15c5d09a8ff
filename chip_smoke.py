"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

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
   it), with CUDA events and the L2 cache flushed before every launch.
   The paged int8 row also times the paged bf16 and int8 kernels on the
   same 8 rows at contexts 1024, 4096 and 16000 (``by_context``).
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
    10 depthwise shapes at B 256 against the plain versions and time the
    largest-bytes (48x48x96 stride 2) and the smallest (3x3x960) shape
    against the plain versions, the bound and the three-call library
    composition; ``step_ms_all_blocks`` sums the kernel over the 17
    blocks of a step. Row 12 also shows that a backward without the
    GroupNorm statistics' gradient terms fails its limit.
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
    profiles one step.
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
    reject a dQ without the delta term and a dK without the scale. Rows
    9d and 10d (the dense CE) at the ConvNet's N 2048 x V 10 one-hot and,
    under ``large``, at N 8192 x V 32000 with soft targets.

The kernel table holds every kernel at its path's shapes (the three
training kernels at B8 H8 S1024 D64 and N 8192 x V 32000, the int8 ones
at the long phase's rows); the flash forward, which runs on every path,
is also held and timed at the training shape (its row's
``training_shape``) and at B1 H8 S16000 (``long_context``). Each row's
``launches_by_path`` gives its count in every window. The line
before the last is the kernel table as JSON (14 rows); the last line is
``{"ok": true, "device": {...}}``. Any failure exits non-zero. Without a
CUDA device the script exits 1 before doing anything.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
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
# The decode kernels add in the plain version's tile order, so only a
# rounding flip of the bf16 output separates them (measured 0.0 on the
# H100). The prefill plain version rounds p against the row's final max,
# the kernel against its running tile max, which adds up to ~2**-9 of |o|
# before the output rounding: atol 2e-3 covers it. lse is f32 and sums the
# same f32 p in both.
# The flash backward rounds P and dS to bf16 like its plain version, but
# from scores summed in another order, so a rounding flip of P or dS can
# move dQ/dK/dV by more than one output step: atol 5e-3 above rtol 2**-7
# (measured max abs error 0.0156 on the H100 at B8 H8 S1024, one bf16 step
# of a dV near 4). dQ also sums its K-tile partials with atomics, in an
# order that changes between runs. The CE forward sums f32 exps in another
# order (measured 9.5e-7 on lse ~ 11); the CE gradient differs only by a
# rounding flip of the bf16 output, which rtol 2**-7 covers. Its row draws
# the upstream gradient g of order 1, so that the softmax term p * g
# (~1e-5 for V=32000) of every column lies far above atol 1e-8 and is
# held to rtol, not only the label column; the row also checks that
# gradients missing the softmax term, with it doubled, or from an lse off
# by 0.05 fail this limit.
# The int8 decode kernels take the exact int dot (dp4a) and the f32
# products in the plain version's order, and round p * v_scale to bf16
# where it does, so only the f32 sums of the online softmax (per lane
# group in the kernel, one einsum in the plain version) and expf against
# torch.exp differ: the limit of the bf16 decode kernels, one rounding step
# of the bf16 output.
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
# The dQ and dK/dV kernels round P and dS to bf16 as the fused backward
# does and add in another order than their plain versions. Started from
# kernel 6's limit and tightened to atol 1e-3: at B1 H8 S16384 the
# largest atol any element needed above rtol 2**-7 was 3.2e-4 (dQ), 1.9e-4
# (dK) and 1.1e-4 (dV) on the H100, against gradients of median 0.008-0.013
# that kernel 6's atol 5e-3 would hold to less than 40%. Neither kernel
# uses atomics, so each gives the same bits every launch.
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
    d, hd, f, v = cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.d_ff, cfg.vocab_size

    def w(*shape, fan_in):
        return rng.standard_normal(shape, dtype=np.float32) / np.float32(math.sqrt(fan_in))

    def ln():
        return {"scale": np.ones(d, np.float32), "bias": np.zeros(d, np.float32)}

    p = {"embed": {"embedding": w(v, d, fan_in=d)}, "ln_f": ln(),
         "lm_head": {"kernel": w(d, v, fan_in=d)}}
    for i in range(cfg.n_layers):
        p[f"layers_{i}"] = {
            "ln_attn": ln(), "ln_mlp": ln(),
            "attn": {name: {"kernel": w(d, cfg.n_heads, cfg.head_dim, fan_in=d)}
                     for name in ("q_proj", "k_proj", "v_proj")}
            | {"o_proj": {"kernel": w(cfg.n_heads, cfg.head_dim, d, fan_in=hd)}},
            "mlp": {"wi": {"kernel": w(d, f, fan_in=d)}, "wo": {"kernel": w(f, d, fan_in=f)}},
        }
    return {"params": p}


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


def _check_greedy(model, reqs, outs, solos):
    report = {}
    for name, prompt, kw in reqs:
        got, solo = torch.as_tensor(outs[name]), solos[name]
        assert got.shape == (1, prompt.shape[1] + N_TOKENS), (name, got.shape)
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


def _timed(fn, iters, flush):
    """Mean device ms of ``fn`` over ``iters`` launches, each with L2 cold."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
           for _ in range(iters)]
    for a, b in evs:
        flush.zero_()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in evs) / iters


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

    # prefill attention: the engine prefills the two same-length prompts together
    errs, lse_errs, b, h, d = [], [], 2, 8, 64
    for s in (512, 1000):
        q, k, v = randn(b, h, s, d), randn(b, h, s, d), randn(b, h, s, d)
        o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
        ro, rl = fa.flash_attention_reference(q, k, v, True)
        errs.append(_over(f"flash_attention_fwd O S={s}", o, ro, *TOL["flash_attention_fwd"]))
        lse_errs.append(_over(f"flash_attention_fwd lse S={s}", lse, rl, LSE_ATOL, 0.0))
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
    })

    # slab decode: solo generate() at max_seq 2048
    s_max, n = 2048, 1064
    ks, vs, qs = randn(1, s_max, h * d), randn(1, s_max, h * d), randn(1, h, d)
    err = _over("flash_decode", fd.flash_decode(qs, ks, vs, n),
                fd.flash_decode_reference(qs, ks, vs, n), *TOL["flash_decode"])
    kh = ks.view(1, s_max, h, d).transpose(1, 2)[:, :, :n]
    vh = vs.view(1, s_max, h, d).transpose(1, 2)[:, :, :n]
    tb, by = _bound(2 * n * h * d * 2 + 2 * h * d * 2 + 4, 4 * n * h * d)
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
    got = fa.flash_attention_backward(q, k, v, do, lse, delta, True)
    want = fa.flash_attention_backward_reference(q, k, v, do, lse, delta, True)
    err = max(_over(f"flash_attention_bwd d{n}", a, r, *TOL["flash_attention_bwd"])
              for n, a, r in zip("qkv", got, want))
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    sdpa = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    tb, by = _bound(7 * b * h * s * d * 2 + 2 * b * h * s * 4, 5 * 2 * b * h * pairs * d)
    rows.append(row(
        "flash_attention_bwd", "distriflow_tpu_torch/csrc/flash_attention_bwd.cu",
        "distriflow_tpu/ops/flash_attention.py:272", err, f"B={b} H={h} S={s} D={d} causal",
        ms=_timed(lambda: fa.flash_attention_backward(q, k, v, do, lse, delta, True), 20, flush),
        plain_ms=_timed(lambda: fa.flash_attention_backward_reference(q, k, v, do, lse, delta, True),
                        3, flush),
        bound_ms=tb, bound_by=by,
        library_ms=_timed(lambda: torch.autograd.grad(sdpa, (qs, ks, vs), do, retain_graph=True),
                          20, flush)))
    del q, k, v, do, o, got, want, qs, ks, vs, sdpa

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
    return rows, fwd


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
    })
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


def _mobilenet_kernel_rows(launches, shapes):
    """Rows 11 and 12: each depthwise shape of one step at B ``MN_B`` held
    against the plain versions; times (kernel, plain, the library
    composition, bound) at the largest-bytes shape (48x48x96 stride 2) and
    the smallest (3x3x960), and the kernel and bound summed over all 17
    blocks of a step."""
    from distriflow_tpu_torch.ops import depthwise_gn as dg

    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    flush = _flush_buffer()
    big, small = (48, 48, 96, 2), (3, 3, 960, 1)
    lib_note = ("composition of three calls (cuDNN depthwise F.conv2d(groups=C) + F.group_norm + "
                "F.hardtanh(0, 6); autograd through it for the backward): no single PyTorch "
                "call computes this function")
    fwd = {"errs": [], "by_shape": {}, "ms": 0.0, "bound": 0.0}
    bwd = {"errs": [], "shares": [], "sums": {}, "by_shape": {}, "ms": 0.0, "bound": 0.0}
    controls = {}
    for key, count in shapes.items():
        h, w, c, s = key
        x, k, sc, bi = _dwgn_inputs(g, MN_B, h, w, c)
        _, _, oh, ow = dg._geometry(h, w, s)
        gout = torch.rand(MN_B, oh, ow, c, generator=g, device="cuda").to(torch.bfloat16)
        tag = f"{h}x{w}x{c} s{s}"
        fwd["errs"].append(_over(f"depthwise_gn_fwd {tag}", dg.depthwise_gn_forward(x, k, sc, bi, s),
                                 dg.depthwise3x3_groupnorm_reference(x, k, sc, bi, s),
                                 *TOL["depthwise_gn_fwd"]))
        want = dg.depthwise3x3_groupnorm_backward_reference(x, k, sc, bi, gout, s)
        err, share, sums = _dwgn_bwd_check(f"depthwise_gn_bwd {tag}",
                                           dg.depthwise_gn_backward(x, k, sc, bi, gout, s), want)
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
        if key not in (big, small):
            continue
        kl = k.permute(2, 0, 1).unsqueeze(1).contiguous()
        scb, bib = sc.to(torch.bfloat16), bi.to(torch.bfloat16)
        leaves = [t.detach().clone().requires_grad_() for t in (x, kl, scb, bib)]
        lib_out = _dwgn_library(*leaves, s)
        gout_nchw = gout.permute(0, 3, 1, 2)
        fwd["by_shape"][tag] = {
            "blocks_per_step": count, "max_abs_err": fwd["errs"][-1], "ms": tf,
            "plain_ms": _timed(lambda: dg.depthwise3x3_groupnorm_reference(x, k, sc, bi, s), 3, flush),
            "bound_ms": fb[0], "bound_by": fb[1],
            "library_ms": _timed(lambda: _dwgn_library(x, kl, scb, bib, s), 20, flush)}
        bwd["by_shape"][tag] = {
            "blocks_per_step": count, "max_abs_err": err, "dx_outside_share": share,
            "sum_rel_err": sums, "ms": tb,
            "plain_ms": _timed(lambda: dg.depthwise3x3_groupnorm_backward_reference(
                x, k, sc, bi, gout, s), 3, flush),
            "bound_ms": bb[0], "bound_by": bb[1],
            "library_ms": _timed(lambda: torch.autograd.grad(lib_out, leaves, gout_nchw,
                                                             retain_graph=True), 20, flush)}
        if key == big:
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
        del x, k, gout, want, leaves, lib_out
    shape_note = f"B={MN_B} NHWC bf16; 17 blocks of {len(shapes)} shapes; ms/plain/library at {{}}"
    rows = []
    for name, d, line, extra in (
            ("depthwise_gn_fwd", fwd, "distriflow_tpu/ops/depthwise_gn.py:180", {}),
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
            "step_bound_ms_all_blocks": d["bound"], **extra})
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
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9 if device == "cuda" else None}
    assert all(math.isfinite(v) for v in losses), losses
    assert last < first, f"long-context loss did not fall: first 3 mean {first}, last 3 mean {last}"
    return report, trainer, cfg, batches[-1], counts


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


def _rejected(name, wrong, want):
    """The share of ``wrong``'s elements outside ``name``'s limit around
    ``want``."""
    atol, rtol = TOL[name]
    wrong, want = wrong.float(), want.float()
    return float(((wrong - want).abs() > atol + rtol * want.abs()).float().mean())


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

    def randn(mean=0.0):
        return (torch.randn(b, h, s, d, generator=g, device=dev) + mean).to(torch.bfloat16)

    q, k, v, do = randn(), randn(1.0), randn(1.0), randn()
    o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, True)
    dq, want_q = fa.flash_attention_dq(*args), fa.flash_attention_dq_reference(*args)
    (dk, dv), (want_k, want_v) = fa.flash_attention_dkv(*args), fa.flash_attention_dkv_reference(*args)
    err_q = _over("flash_attention_dq", dq, want_q, *TOL["flash_attention_dq"])
    # the least atol each kernel's elements need above the limit's rtol
    needed = {name: max(float(((a.float() - w.float()).abs() - TOL[name][1] * w.float().abs()).max())
                        for a, w in pairs_)
              for name, pairs_ in (("flash_attention_dq", [(dq, want_q)]),
                                   ("flash_attention_dkv", [(dk, want_k), (dv, want_v)]))}
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
    return rows


def _dense_ce_rows(launches, steps):
    """Rows 9d and 10d, the dense CE, at the ConvNet's shape (N 2048 x V
    10, one-hot f32 targets) and, under ``large``, at N 8192 x V 32000
    with soft targets, where the kernels stream real bytes."""
    import torch.nn.functional as F

    from distriflow_tpu_torch.ops import fused_ce as ce

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    flush = _flush_buffer()
    fwd, bwd = {}, {}
    for tag, n, vocab in (("path", CN_B, 10), ("large", 8192, 32000)):
        logits = torch.randn(n, vocab, generator=g, device=dev).to(torch.bfloat16)
        if tag == "path":
            labels = torch.randint(0, vocab, (n,), generator=g, device=dev)
            t = F.one_hot(labels, vocab).float()
            kind = "one-hot"
        else:
            t = torch.softmax(2 * torch.randn(n, vocab, generator=g, device=dev), -1)
            kind = "soft"
        loss, lse = ce.fused_ce_dense_forward(logits, t)
        rl, rs = ce.fused_ce_dense_forward_reference(logits, t)
        err = max(_over(f"fused_ce_dense_fwd loss {tag}", loss, rl, *TOL["fused_ce_dense_fwd"]),
                  _over(f"fused_ce_dense_fwd lse {tag}", lse, rs, *TOL["fused_ce_dense_fwd"]))
        gr = torch.rand(n, generator=g, device=dev)
        want = ce.fused_ce_dense_backward_reference(logits, t, lse, gr)
        berr = _over(f"fused_ce_dense_bwd {tag}", ce.fused_ce_dense_backward(logits, t, lse, gr),
                     want, *TOL["fused_ce_dense_bwd"])
        lg = logits.detach().clone().requires_grad_()
        lib_loss = F.cross_entropy(lg, t, reduction="none")
        shape = f"N={n} V={vocab} bf16 logits, {kind} f32 targets"
        io = n * vocab * (2 + 4)
        tb, by = _bound(io + 2 * n * 4, 4 * n * vocab, F32_FLOPS)
        fwd[tag] = {
            "shape": shape, "max_abs_err": err,
            "ms": _timed(lambda: ce.fused_ce_dense_forward(logits, t), 20, flush),
            "plain_ms": _timed(lambda: ce.fused_ce_dense_forward_reference(logits, t), 3, flush),
            "bound_ms": tb, "bound_by": by,
            "library_ms": _timed(lambda: F.cross_entropy(logits, t, reduction="none"), 20, flush)}
        tb, by = _bound(io + 2 * n * 4 + n * vocab * 2, 4 * n * vocab, F32_FLOPS)
        bwd[tag] = {
            "shape": shape, "max_abs_err": berr,
            "ms": _timed(lambda: ce.fused_ce_dense_backward(logits, t, lse, gr), 20, flush),
            "plain_ms": _timed(lambda: ce.fused_ce_dense_backward_reference(logits, t, lse, gr),
                               3, flush),
            "bound_ms": tb, "bound_by": by,
            "library_ms": _timed(lambda: torch.autograd.grad(
                lib_loss, lg, gr.to(lib_loss.dtype), retain_graph=True), 20, flush)}
        del logits, t, want, lg, lib_loss
    rows = []
    for name, line, d in (("fused_ce_dense_fwd", "distriflow_tpu/ops/fused_ce.py:77", fwd),
                          ("fused_ce_dense_bwd", "distriflow_tpu/ops/fused_ce.py:107", bwd)):
        rows.append({
            **d["path"], "name": name, "route": "cuda",
            "source": "distriflow_tpu_torch/csrc/fused_ce.cu", "replaces": line,
            "variant": "sparse=False (dense targets)", "launches": launches[name],
            "launches_per_step": launches[name] / steps,
            "max_abs_err": max(d["path"]["max_abs_err"], d["large"]["max_abs_err"]),
            "tol": _tol(name), "large": d["large"],
            "library_note": "F.cross_entropy with probability targets (its backward for the "
                            "gradient)"})
    return rows


def main() -> int:
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

    def counted(run):
        for fn in counters.values():
            fn.launches = 0
        out = run()
        return out, {k: fn.launches for k, fn in counters.items()}

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
    paths = {"serving": serving, "solo_generate": solo, **long_counts, "training": training,
             **mn_counts, "long_training": long_training, **cn_counts}
    print("launches:", json.dumps(paths), flush=True)
    # each path launches exactly the kernels named here, and no other
    ran = {"serving": ("flash_attention_fwd", "flash_decode_paged"),
           "solo_generate": ("flash_attention_fwd", "flash_decode"),
           "long_serving": ("flash_attention_fwd", "flash_decode_paged_int8"),
           "long_solo_generate": ("flash_attention_fwd", "flash_decode_int8"),
           "beam": ("flash_attention_fwd", "flash_decode_int8"),
           "score": ("flash_attention_fwd",),
           "training": ("flash_attention_fwd",) + training_only,
           "mobilenet_train": ("depthwise_gn_fwd", "depthwise_gn_bwd"),
           "mobilenet_eval": ("depthwise_gn_fwd",),
           "long_training": ("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv",
                             "fused_ce_fwd", "fused_ce_bwd"),
           "convnet_train": ("fused_ce_dense_fwd", "fused_ce_dense_bwd"),
           "convnet_eval": ("fused_ce_dense_fwd",)}
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
    rows += _mobilenet_kernel_rows({k: mn_train[k] for k in ("depthwise_gn_fwd", "depthwise_gn_bwd")},
                                   shapes)
    rows += _split_bwd_rows(long_training, LONG_TRAIN_STEPS)
    rows += _dense_ce_rows(cn_train, CN_STEPS)
    path_of = {"flash_decode": "solo_generate", "flash_decode_paged_int8": "long_serving",
               "flash_decode_int8": "beam", **{k: "training" for k in training_only},
               "depthwise_gn_fwd": "mobilenet_train", "depthwise_gn_bwd": "mobilenet_train",
               "flash_attention_dq": "long_training", "flash_attention_dkv": "long_training",
               "fused_ce_dense_fwd": "convnet_train", "fused_ce_dense_bwd": "convnet_train"}
    for r in rows:
        r["path"] = path_of.get(r["name"], "serving")
        r["launches_by_path"] = {p: c[r["name"]] for p, c in paths.items()}
    print("decode_iteration_profile:",
          json.dumps(_profile_decode_iteration(model, rng, [128, 300, 512, 1000] * 2)), flush=True)
    print("training_step_profile:", json.dumps(_profiled(lambda: trainer.step((x, y)))), flush=True)
    print("mobilenet_step_profile:", json.dumps(_profiled(lambda: mn_trainer.step(mn_batch))),
          flush=True)
    print("long_training_step_profile:", json.dumps(_profiled(lambda: lt_trainer.step(lt_batch))),
          flush=True)
    print("convnet_step_profile:", json.dumps(_profiled(lambda: cn_trainer.step(cn_batch))),
          flush=True)
    assert len(rows) == 14, [r["name"] for r in rows]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
