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

The line before the last is the kernel table as JSON; the last line is
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
# Kernel vs plain version, elementwise: |kernel - plain| <= atol + rtol * |plain|.
# rtol 2**-7 is one bf16 rounding step of the output (8 significant bits).
# The decode kernels add in the plain version's tile order, so only a
# rounding flip of the bf16 output separates them (measured 0.0 on the
# H100). The prefill plain version rounds p against the row's final max,
# the kernel against its running tile max, which adds up to ~2**-9 of |o|
# before the output rounding: atol 2e-3 covers it. lse is f32 and sums the
# same f32 p in both.
TOL = {"flash_attention_fwd": (2e-3, 2 ** -7),
       "flash_decode_paged": (1e-5, 2 ** -7),
       "flash_decode": (1e-5, 2 ** -7)}
LSE_ATOL = 1e-4
NEAR_TIE = 0.05
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor-core peak


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
    greedy) under ``torch.profiler``: host wall time against the device
    time of the kernels it launched, and the kernels that took the most."""
    from torch.profiler import ProfilerActivity, profile

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


def _kernel_rows(launches):
    """Each kernel at the main path's shapes: error against its plain
    version, and the times of kernel, plain version and library call."""
    import torch.nn.functional as F

    from distriflow_tpu_torch.ops import flash_attention as fa
    from distriflow_tpu_torch.ops import flash_decode as fd

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    flush = torch.empty(32 << 20, dtype=torch.float32, device=dev)  # 128 MB > 50 MB L2
    rows = []

    def bound(nbytes, flops):
        tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
        return (tb, "bytes") if tb >= tf else (tf, "operations")

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
    tb, by = bound(4 * b * h * s * d * 2 + b * h * s * 4, 4 * b * h * pairs * d)
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
    tb, by = bound(2 * live * h * d * 2 + 2 * bsz * h * d * 2 + table.numel() * 4 + bsz * 4,
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
    tb, by = bound(2 * n * h * d * 2 + 2 * h * d * 2 + 4, 4 * n * h * d)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from distriflow_tpu_torch.models.convert import lm_from_jax
    from distriflow_tpu_torch.models.generate import generate
    from distriflow_tpu_torch.models.transformer import TransformerConfig
    from distriflow_tpu_torch.ops import build
    from distriflow_tpu_torch.ops import flash_attention as fa
    from distriflow_tpu_torch.ops import flash_decode as fd

    print(_card(), flush=True)

    t0 = time.perf_counter()
    build.build_all(["flash_attention", "flash_decode"])
    print(f"kernel build s: {time.perf_counter() - t0:.2f}", flush=True)
    for name, log in build.ptxas_reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TransformerConfig(vocab_size=32000, d_model=512, n_heads=8, n_layers=8,
                            d_ff=2048, max_seq=2048, dtype=torch.bfloat16)
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    model = lm_from_jax(cfg, _flagship_tree(cfg, rng), device="cuda")
    torch.cuda.synchronize()
    print(f"model init s: {time.perf_counter() - t0:.2f}", flush=True)
    reqs = _requests(rng, cfg.vocab_size)
    generate(model, reqs[0][1][:, :16], 4)  # warm-up: library handles, kernel loads
    torch.cuda.synchronize()

    counters = {"flash_attention_fwd": fa.flash_attention,
                "flash_decode_paged": fd.flash_decode_paged,
                "flash_decode": fd.flash_decode}

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
    print("launches:", json.dumps({"serving": serving, "solo_generate": solo}), flush=True)
    for path, counts, ran, idle in (("serving", serving, ("flash_attention_fwd", "flash_decode_paged"),
                                     "flash_decode"),
                                    ("solo generate()", solo, ("flash_attention_fwd", "flash_decode"),
                                     "flash_decode_paged")):
        for k in ran:
            assert counts[k] > 0, f"kernel {k} never launched on the {path} path"
        assert counts[idle] == 0, f"{path} launched {idle} {counts[idle]} times"
    assert stats["prefix_hits"] >= 1, "the prefix-sharing path did not run"

    # each kernel's count on the path it serves: prefill and paged decode
    # on the serving path, slab decode on solo generate()
    rows = _kernel_rows({"flash_attention_fwd": serving["flash_attention_fwd"],
                         "flash_decode_paged": serving["flash_decode_paged"],
                         "flash_decode": solo["flash_decode"]})
    for r in rows:
        r["path"] = "solo_generate" if r["name"] == "flash_decode" else "serving"
        r["launches_by_path"] = {"serving": serving[r["name"]], "solo_generate": solo[r["name"]]}
    print("decode_iteration_profile:", json.dumps(_profile_decode_iteration(model, rng)), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
