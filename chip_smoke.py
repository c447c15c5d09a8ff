"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

1. Prints the card's name and power limit, builds the port's CUDA kernels
   from ``distriflow_tpu_torch/csrc`` (one ``nvcc`` per source, in
   parallel) and prints the build time.
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
   computed outside both windows). Serving must launch the prefill and the
   paged decode kernel and not the slab one; solo ``generate()`` the
   prefill and the slab decode kernel and not the paged one.
5. Holds each kernel against its plain PyTorch version at the main path's
   shapes, elementwise within ``atol + rtol * |plain|`` (limits in
   ``TOL``), and times kernel, plain version and a PyTorch library call
   computing the same function (a yardstick only: the port never calls
   it), with CUDA events and the L2 cache flushed before every launch.
6. Profiles one engine decode iteration (8 slots, chunk 8) with
   ``torch.profiler``: host wall time, device busy time, the device's idle
   share and the kernels that took the most device time.
7. Trains the flagship LM (the same seeded flax-shaped tree, carried over
   as f32 masters) with the port's ``SyncTrainer`` (adam, lr 1e-3, the
   fused sparse CE) on one fixed seeded batch of B=8 x S=1024 tokens for
   20 steps, with the launch counts read in a window of their own: each
   step must launch the flash forward and backward kernels 8 times each
   and the CE forward and backward once each, and no decode kernel; the
   serving and solo windows must show no backward or CE launch. Prints a
   ``training:`` line (step ms p50/max, tokens/s, first and last loss);
   every loss must be finite and the last at least ``LOSS_FALL`` below
   the first.
8. Takes one step's loss and every parameter's gradient twice from the
   same masters and batch, once through the kernels and once through the
   plain path (``use_flash_attention=False``, plain sparse CE), and holds
   them within ``STEP_TOL`` (``step_vs_plain:`` line).
9. Profiles one training step with ``torch.profiler``
   (``training_step_profile:`` line), the counterpart of step 6.

The kernel table holds every kernel at its path's shapes (the three
training kernels at B8 H8 S1024 D64 and N 8192 x V 32000); the flash
forward, which runs on both paths, is also held and timed at the training
shape (its row's ``training_shape``). The line
before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. Any failure exits non-zero. Without a
CUDA device the script exits 1 before doing anything.
"""

from __future__ import annotations

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
TOL = {"flash_attention_fwd": (2e-3, 2 ** -7),
       "flash_decode_paged": (1e-5, 2 ** -7),
       "flash_decode": (1e-5, 2 ** -7),
       "flash_attention_bwd": (5e-3, 2 ** -7),
       "fused_ce_fwd": (1e-5, 1e-6),
       "fused_ce_bwd": (1e-8, 2 ** -7)}
LSE_ATOL = 1e-4
# A training step through the kernels against the plain path, from the
# same f32 masters and batch: |loss difference| and, for every parameter,
# ||grad_kernels - grad_plain|| / ||grad_plain||. The kernel path feeds
# bf16 logits to the CE and rounds P and dS to bf16, the plain path keeps
# f32 logits and f32 softmax: measured on the H100 8.5e-5 on the loss and
# 0.0188 at worst (median 0.0093) on the gradients. The limits leave a
# margin of about 10x on the loss and 2x on the gradients.
STEP_TOL = {"loss": 1e-3, "grad_rel": 0.04}
# nats the loss must fall over the 20 steps on its fixed batch (measured
# 10.87 -> 4.21 on the H100)
LOSS_FALL = 2.0
NEAR_TIE = 0.05
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12          # H100 SXM f32 outside the tensor cores


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


def _serve(model, reqs):
    """Drive the port's server with the port's client; returns
    ``(outputs by name, engine stats)`` after stopping the server."""
    from distriflow_tpu_torch.client.inference_client import InferenceClient
    from distriflow_tpu_torch.obs.telemetry import Telemetry
    from distriflow_tpu_torch.server.inference_server import InferenceServer

    server = InferenceServer(model, telemetry=Telemetry()).setup()
    outs, errs = {}, []
    clients = [InferenceClient(server.address, timeout=600).setup() for _ in reqs]

    def run(client, name, prompt, kw):
        try:
            outs[name] = client.generate(prompt, N_TOKENS, **kw)
        except Exception as e:  # re-raised on the main thread below
            errs.append((name, e))

    try:
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
        stats = {
            "decode_batches": server.decode_batches,
            "prefix_hits": server.prefix_hits,
            "phases_ms": {k: {q: v[q] for q in ("count", "p50", "max", "sum")}
                          for k, v in server._prof.digests().items()},
        }
        return outs, stats
    finally:
        for c in clients:
            c.close()
        server.stop()


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


def _profile_decode_iteration(model, rng):
    """One engine decode iteration (8 slots, contexts 128-1000, chunk 8,
    greedy) under ``torch.profiler`` (:func:`_profiled`)."""
    from distriflow_tpu_torch.models.generate import decode_chunk, paged_cache, paged_insert, prefill
    from distriflow_tpu_torch.utils.config import ServingConfig

    srv, cfg = ServingConfig(), model.config
    n_pages = srv.pool_pages(cfg.max_seq)
    cache = paged_cache(cfg, srv.max_slots, srv.page_size, n_pages, model.device)
    table = np.full((srv.max_slots, cache.page_table.shape[1]), n_pages, np.int32)
    first = np.zeros(srv.max_slots, np.int32)
    for r, n in enumerate([128, 300, 512, 1000] * 2):
        table[r, :-(-(n + 64) // srv.page_size)] = np.arange(16 * r, 16 * r + (-(-(n + 64) // srv.page_size)))
        logits, row = prefill(model, rng.integers(0, cfg.vocab_size, (1, n)).astype(np.int32))
        paged_insert(cache, row, [r], n, 0, table)
        first[r] = int(logits.argmax())
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


def _train(cfg, tree, tokens):
    """The port's ``SyncTrainer`` on the flagship from the carried-over f32
    masters, ``TRAIN_STEPS`` steps on one fixed batch; returns
    ``(trainer, losses, step ms)``."""
    from distriflow_tpu_torch.models.convert import params_from_jax
    from distriflow_tpu_torch.models.transformer import transformer_lm
    from distriflow_tpu_torch.train.sync import SyncTrainer

    trainer = SyncTrainer(transformer_lm(cfg, device="cuda"), optimizer="adam", learning_rate=1e-3)
    trainer.init()
    trainer.set_params(params_from_jax(tree, cfg, masters=True))
    x, y = tokens[:, :-1], tokens[:, 1:]
    losses, ms = [], []
    for _ in range(TRAIN_STEPS):
        losses.append(trainer.step((x, y)))
        ms.append(trainer.last_step_ms)
    return trainer, losses, ms


def _step_vs_plain(cfg, tree, tokens):
    """One step's loss and gradients through the kernels and through the
    plain path, from the same f32 masters and batch."""
    import dataclasses

    from distriflow_tpu_torch.models.convert import lm_from_jax
    from distriflow_tpu_torch.models.transformer import transformer_lm

    x = torch.as_tensor(tokens[:, :-1], device="cuda")
    y = torch.as_tensor(tokens[:, 1:], device="cuda")
    out = {}
    plain = dataclasses.replace(cfg, use_flash_attention=False, loss="sparse_softmax_cross_entropy")
    for name, c in (("kernels", cfg), ("plain", plain)):
        spec = transformer_lm(c, device="cuda")
        model = lm_from_jax(c, tree, device="cuda", trainable=True)
        loss, grads = spec.grad_fn()(model, x, y)
        out[name] = (float(loss), grads)
        del model
    (lk, gk), (lp, gp) = out["kernels"], out["plain"]
    rel = {n: float((gk[n] - gp[n]).norm() / gp[n].norm().clamp_min(1e-30)) for n in gp}
    worst = max(rel, key=rel.get)
    report = {"loss_kernels": lk, "loss_plain": lp, "loss_abs_diff": abs(lk - lp),
              "grad_rel_frobenius_max": rel[worst], "worst_param": worst,
              "grad_rel_frobenius_median": float(np.median(list(rel.values()))),
              "limits": STEP_TOL}
    assert report["loss_abs_diff"] <= STEP_TOL["loss"], report
    assert rel[worst] <= STEP_TOL["grad_rel"], report
    return report


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from distriflow_tpu_torch.models.convert import lm_from_jax
    from distriflow_tpu_torch.models.generate import generate
    from distriflow_tpu_torch.models.zoo import flagship_lm_config
    from distriflow_tpu_torch.ops import build
    from distriflow_tpu_torch.ops import flash_attention as fa
    from distriflow_tpu_torch.ops import flash_decode as fd
    from distriflow_tpu_torch.ops import fused_ce as ce

    print(_card(), flush=True)

    t0 = time.perf_counter()
    build.build_all(["flash_attention", "flash_decode", "flash_attention_bwd", "fused_ce"])
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
                "flash_attention_bwd": fa.flash_attention_backward,
                "fused_ce_fwd": ce.fused_ce_forward,
                "fused_ce_bwd": ce.fused_ce_backward}
    training_only = ("flash_attention_bwd", "fused_ce_fwd", "fused_ce_bwd")

    def counted(run):
        for fn in counters.values():
            fn.launches = 0
        out = run()
        return out, {k: fn.launches for k, fn in counters.items()}

    t0 = time.perf_counter()
    (outs, stats), serving = counted(lambda: _serve(model, reqs))
    serve_s = time.perf_counter() - t0
    solos, solo = counted(lambda: _solo(model, reqs))
    report = _check_greedy(model, reqs, outs, solos)
    print("serving:", json.dumps({"wall_s": serve_s, **stats}), flush=True)
    print("parity:", json.dumps(report), flush=True)

    # training: the flagship from the same tree as f32 masters, one batch
    tokens = np.random.default_rng(SEED + 2).integers(
        0, cfg.vocab_size, (TRAIN_B, TRAIN_S + 1)).astype(np.int32)
    (trainer, losses, step_ms), training = counted(lambda: _train(cfg, tree, tokens))
    print("launches:", json.dumps({"serving": serving, "solo_generate": solo, "training": training}),
          flush=True)
    for path, counts, ran, idle in (
            ("serving", serving, ("flash_attention_fwd", "flash_decode_paged"),
             ("flash_decode",) + training_only),
            ("solo generate()", solo, ("flash_attention_fwd", "flash_decode"),
             ("flash_decode_paged",) + training_only),
            ("training", training, ("flash_attention_fwd",) + training_only,
             ("flash_decode", "flash_decode_paged"))):
        for k in ran:
            assert counts[k] > 0, f"kernel {k} never launched on the {path} path"
        for k in idle:
            assert counts[k] == 0, f"{path} launched {k} {counts[k]} times"
    assert stats["prefix_hits"] >= 1, "the prefix-sharing path did not run"
    per_step = {"flash_attention_fwd": cfg.n_layers, "flash_attention_bwd": cfg.n_layers,
                "fused_ce_fwd": 1, "fused_ce_bwd": 1}
    for k, n in per_step.items():
        assert training[k] == n * TRAIN_STEPS, f"training launched {k} {training[k]} times, " \
                                               f"want {n} per step x {TRAIN_STEPS}"
    train_report = {
        "steps": TRAIN_STEPS, "batch": TRAIN_B, "seq": TRAIN_S, "optimizer": "adam", "lr": 1e-3,
        "loss": trainer.spec.loss, "step_ms_p50": float(np.median(step_ms)),
        "step_ms_max": max(step_ms), "step_ms_first": step_ms[0],
        "tokens_per_s": TRAIN_B * TRAIN_S / (float(np.median(step_ms)) / 1e3),
        "first_loss": losses[0], "last_loss": losses[-1], "losses": losses,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print("training:", json.dumps(train_report), flush=True)
    assert all(math.isfinite(v) for v in losses), losses
    assert losses[-1] <= losses[0] - LOSS_FALL, f"loss fell {losses[0] - losses[-1]} < {LOSS_FALL}"
    print("step_vs_plain:", json.dumps(_step_vs_plain(cfg, tree, tokens)), flush=True)

    # each kernel's count on its own path: prefill and paged decode on
    # serving, slab decode on solo generate(), the rest on training
    rows = _kernel_rows({"flash_attention_fwd": serving["flash_attention_fwd"],
                         "flash_decode_paged": serving["flash_decode_paged"],
                         "flash_decode": solo["flash_decode"]})
    train_rows, rows[0]["training_shape"] = _training_kernel_rows(training, TRAIN_STEPS)
    rows += train_rows
    path_of = {"flash_decode": "solo_generate", **{k: "training" for k in training_only}}
    for r in rows:
        r["path"] = path_of.get(r["name"], "serving")
        r["launches_by_path"] = {"serving": serving[r["name"]], "solo_generate": solo[r["name"]],
                                 "training": training[r["name"]]}
    print("decode_iteration_profile:", json.dumps(_profile_decode_iteration(model, rng)), flush=True)
    x, y = tokens[:, :-1], tokens[:, 1:]
    print("training_step_profile:", json.dumps(_profiled(lambda: trainer.step((x, y)))), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
