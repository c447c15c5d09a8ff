"""Readings behind the design of kernels 7 and 8 at head dim 32
(``distriflow_tpu_torch/csrc/flash_attention_bwd.cu``, namespace ``d32``)
on one CUDA card. Prints one JSON object.

The source is built as it is and as patched copies, one change each
(:data:`VARIANTS`):

- ``exp2_folded``: P = ex2(S * (scale log2 e) - lse log2 e), one FMA;
- ``expf``: P = expf(S * scale - lse), the argument contracted into an FMA
  (the D 64 kernels' form);
- ``mask_in_loop``: the dQ kernel's mask tested inside the exponentials'
  loop (one pass instead of three);
- ``two_warpgroups``: two consumer warpgroups a block instead of three;
- ``no_early_wait``: each stage waited for at the top of its tile, not
  while the previous tile's S and dP run.

For each: the atol that dQ and dK/dV need above ``chip_smoke.TOL``'s
rtol against the plain versions at path (b)'s shape (B8 H8 S16384 D32
causal), drawn as ``chip_smoke._lm_cli_attention_rows`` draws its inputs
and by :data:`DRAWS` more generators, the most over
``chip_smoke.RAGGED_BWD`` at B1 H8, the same bits on a second launch, and
each kernel's median ms at path (b)'s shape. Each
variant runs in a process of its own with a time limit. It also prints
the card's MUFU.EX2 rate (results a clock an SM, from ``clock64`` in a
small kernel of its own) and the exponentials' share of each kernel's
time (``chip_smoke._bound``'s exponential term over the time). With
``--parent DIR`` (an older checkout) it also times that checkout's
kernels 1, 7 and 8 at path (b)'s shape against this one's, in turns.

With ``--limit [--older DIR]`` it prints only the backward limits'
readings instead (:func:`limit_draws`): dQ and dK/dV of this checkout and
of the older checkout ``DIR`` on the smoke's draw and 8 fresh draws at
path (b)'s shape and at D 64, against the scalar limits and the flip
limits of ``chip_smoke._flip_atols``.

Run from the repository's root: ``python3 tools/d32_bwd_probe.py [--parent DIR]``
(about four minutes of command on an H100), or ``python3
tools/d32_bwd_probe.py --limit [--older DIR]`` (about four minutes).
"""

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CSRC = os.path.join(ROOT, "distriflow_tpu_torch", "csrc")


def _sub(src, old, new):
    assert src.count(old) == 1, old[:80]
    return src.replace(old, new)


_PROB = '''  asm("ex2.approx.ftz.f32 %0, %1;\\n"
      : "=f"(p)
      : "f"(__fmul_rn(__fadd_rn(__fmul_rn(s, scale), -lse), kLog2e)));'''


def exp2_folded(src):
    return _sub(src, _PROB, '''  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(p) : "f"(fmaf(s, scale * kLog2e, -lse * kLog2e)));''')


def expf_(src):
    return _sub(src, _PROB, '''  p = expf(s * scale - lse);''')


def mask_in_loop(src):
    return _sub(src, '''#pragma unroll
    for (int r = 0; r < kBK / 2; ++r) acc_s[r] = prob(acc_s[r], scale, l[(r >> 1) & 1]);
    if (k0 + kBK > S || (causal && k0 + kBK - 1 > first_row)) {
#pragma unroll
      for (int r = 0; r < kBK / 2; ++r) {
        const int kpos = k0 + 8 * (r >> 2) + col + (r & 1);
        if (kpos >= S || (causal && kpos > row0 + 8 * ((r >> 1) & 1))) acc_s[r] = 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < kBK / 2; ++r) acc_dp[r] = acc_s[r] * (acc_dp[r] - d[(r >> 1) & 1]);''', '''    const bool masked = k0 + kBK > S || (causal && k0 + kBK - 1 > first_row);
#pragma unroll
    for (int r = 0; r < kBK / 2; ++r) {
      float p = prob(acc_s[r], scale, l[(r >> 1) & 1]);
      if (masked) {
        const int kpos = k0 + 8 * (r >> 2) + col + (r & 1);
        if (kpos >= S || (causal && kpos > row0 + 8 * ((r >> 1) & 1))) p = 0.f;
      }
      acc_dp[r] = p * (acc_dp[r] - d[(r >> 1) & 1]);
    }''')


def two_warpgroups(src):
    return _sub(src, "constexpr int kWarpgroups = 3;", "constexpr int kWarpgroups = 2;")


def no_early_wait(src):
    src = _sub(src, '''  if (n_mine > 0) mbar_wait(&full[0], 0);
  for (int t = 0; t < n_mine; ++t) {
    const int s = Pipe::stage(t);
''', '''  for (int t = 0; t < n_mine; ++t) {
    const int s = Pipe::stage(t);
    mbar_wait(&full[s], Pipe::full_parity(t));
''')
    src = _sub(src, '''    if (t + 1 < n_kb) mbar_wait(&full[Pipe::stage(t + 1)], Pipe::full_parity(t + 1));
''', "")
    src = _sub(src, '''  mbar_wait(&full[0], 0);
  for (int t = 0; t < n_steps; ++t) {
    const int s = Pipe::stage(t);
    if (t < t_first && t + 1 < n_steps) mbar_wait(&full[Pipe::stage(t + 1)], Pipe::full_parity(t + 1));
''', '''  for (int t = 0; t < n_steps; ++t) {
    const int s = Pipe::stage(t);
    mbar_wait(&full[s], Pipe::full_parity(t));
''')
    return _sub(src, '''      if (t + 1 < n_steps) mbar_wait(&full[Pipe::stage(t + 1)], Pipe::full_parity(t + 1));
''', "")


#: generator seeds (beside chip_smoke.SEED) of further draws at path (b)'s shape, each drawn fresh
DRAWS = (41, 42, 43)

VARIANTS = {"as_built": lambda s: s, "exp2_folded": exp2_folded, "expf": expf_,
            "mask_in_loop": mask_in_loop, "two_warpgroups": two_warpgroups,
            "no_early_wait": no_early_wait}

MUFU_SRC = r'''
#include <cuda_runtime.h>
__global__ void ex2_rate(float* out, long long* cyc, int iters) {
  float x[16];
  for (int i = 0; i < 16; ++i) x[i] = -1e-3f * (threadIdx.x + i);
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      float y;
      asm volatile("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x[i]));
      x[i] = y - 1.0f;
    }
  __syncthreads();
  const long long t1 = clock64();
  float s = 0.f;
  for (int i = 0; i < 16; ++i) s += x[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) cyc[blockIdx.x] = t1 - t0;
}
extern "C" int run_ex2_rate(float* out, long long* cyc, int blocks, int threads, int iters) {
  ex2_rate<<<blocks, threads>>>(out, cyc, iters);
  return static_cast<int>(cudaDeviceSynchronize());
}
'''


def _build(src_by_name, work, headers=None):
    """One shared library a name from source text, all nvcc runs at once
    (the port's own compiler and flags, ``ops/build.py``); each source
    takes the headers of ``headers[name]`` (a ``csrc`` directory), else
    this checkout's."""
    from distriflow_tpu_torch.ops import build

    procs = {}
    for name, src in src_by_name.items():
        d = os.path.join(work, name)
        os.makedirs(d, exist_ok=True)
        for h in ("common.cuh", "hopper.cuh"):
            with open(os.path.join((headers or {}).get(name, CSRC), h)) as f, \
                    open(os.path.join(d, h), "w") as g:
                g.write(f.read())
        cu = os.path.join(d, "k.cu")
        with open(cu, "w") as f:
            f.write(src)
        procs[name] = subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-I", d, "-o",
                                        os.path.join(d, "k.so"), cu],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
    return {name: os.path.join(work, name, "k.so") for name in src_by_name}


def _bind(so):
    from distriflow_tpu_torch.ops import flash_attention as fa

    lib = ctypes.CDLL(so)
    for fn, argtypes in {**fa._BWD_SIGNATURES, **fa._SIGNATURES}.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def _calls(lib):
    """dQ and dK/dV through the library's C entries, as the wrappers call them."""
    import torch

    def dq(q, k, v, do, lse, delta, causal):
        b, h, s, d = q.shape
        out = torch.empty_like(q)
        rc = lib.dftt_flash_attention_dq_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                              lse.data_ptr(), delta.data_ptr(), out.data_ptr(),
                                              b * h, s, d, int(causal), 1.0 / math.sqrt(d),
                                              torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return out

    def dkv(q, k, v, do, lse, delta, causal):
        b, h, s, d = q.shape
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        rc = lib.dftt_flash_attention_dkv_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                               lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                                               dv.data_ptr(), b * h, s, d, int(causal),
                                               1.0 / math.sqrt(d), torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return dk, dv

    return dq, dkv


def one_variant(so):
    """The readings of one built variant (run in a process of its own)."""
    import torch

    import chip_smoke as cs
    from distriflow_tpu_torch.ops import flash_attention as fa

    dq, dkv = _calls(_bind(so))
    nq, nk = "flash_attention_dq_d32", "flash_attention_dkv_d32"
    # the draws before the path's in chip_smoke._lm_cli_attention_rows: the
    # fused D 32 row's inputs and its ragged lengths
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 41)
    cs._bwd_inputs(g, cs.LM_CLI_B, 8, cs.LM_CLI["max_seq"], True, 32)
    for ss, causal in cs.RAGGED_BWD:
        cs._bwd_inputs(g, 1, 8, ss, causal, 32)
    args = cs._bwd_inputs(g, cs.LM_CLI_B, 8, cs.LM_CLI_LONG_S, True, 32)
    got_q = dq(*args)
    out = {"dq_atol_needed": cs._atol_needed(nq, [(got_q, fa.flash_attention_dq_reference(*args))]),
           "dq_same_bits": bool(torch.equal(dq(*args), got_q))}
    del got_q
    dk, dv = dkv(*args)
    wk, wv = fa.flash_attention_dkv_reference(*args)
    out["dkv_atol_needed"] = cs._atol_needed(nk, [(dk, wk), (dv, wv)])
    again = dkv(*args)
    out["dkv_same_bits"] = bool(torch.equal(again[0], dk) and torch.equal(again[1], dv))
    del dk, dv, wk, wv, again
    for seed in DRAWS:
        a = cs._bwd_inputs(torch.Generator(device="cuda").manual_seed(cs.SEED + seed), cs.LM_CLI_B, 8,
                           cs.LM_CLI_LONG_S, True, 32)
        out[f"draw_{seed}_atol_needed"] = [
            cs._atol_needed(nq, [(dq(*a), fa.flash_attention_dq_reference(*a))]),
            cs._atol_needed(nk, list(zip(dkv(*a), fa.flash_attention_dkv_reference(*a))))]
        del a
    flush = cs._flush_buffer()
    out["dq_ms"] = float(cs._timed(lambda: dq(*args), 7, flush))
    out["dkv_ms"] = float(cs._timed(lambda: dkv(*args), 7, flush))
    b, h, s = cs.LM_CLI_B, 8, cs.LM_CLI_LONG_S
    exp_ms = cs._bound(0, 0, exps=b * h * s * (s + 1) // 2)[0]
    out["exponentials_share"] = {"dq": exp_ms / out["dq_ms"], "dkv": exp_ms / out["dkv_ms"]}
    gr = torch.Generator(device="cuda").manual_seed(cs.SEED + 56)
    ragged = []
    for ss, causal in cs.RAGGED_BWD:
        a = cs._bwd_inputs(gr, 1, 8, ss, causal, 32)
        ragged.append(max(cs._atol_needed(nq, [(dq(*a), fa.flash_attention_dq_reference(*a))]),
                          cs._atol_needed(nk, list(zip(dkv(*a), fa.flash_attention_dkv_reference(*a))))))
    out["ragged_atol_needed"] = max(ragged)
    return out


def mufu_rate(work):
    """MUFU.EX2 results a clock an SM, one block an SM, by thread count."""
    import torch

    so = _build({"mufu": MUFU_SRC}, work)["mufu"]
    lib = ctypes.CDLL(so)
    lib.run_ex2_rate.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for threads in (128, 512):
        o = torch.empty(sms * threads, device="cuda")
        cyc = torch.empty(sms, dtype=torch.int64, device="cuda")
        for _ in range(2):
            assert lib.run_ex2_rate(o.data_ptr(), cyc.data_ptr(), sms, threads, 2000) == 0
        out[f"threads_{threads}"] = threads * 2000 * 16 / int(cyc.max())
    return out


def in_turns(parent, work):
    """Kernels 1, 7 and 8 at path (b)'s shape, this checkout's against the
    parent's, in turns (parent, this, this, parent) three times."""
    import torch

    import chip_smoke as cs

    srcs = {}
    for who, base in (("parent", os.path.join(parent, "distriflow_tpu_torch", "csrc")), ("this", CSRC)):
        for name in ("flash_attention", "flash_attention_bwd"):
            with open(os.path.join(base, f"{name}.cu")) as f:
                srcs[f"{who}_{name}"] = f.read()
    libs = {k: _bind(so) for k, so in _build(srcs, work).items()}
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 57)
    q, k, v, do, lse, delta, causal = cs._bwd_inputs(g, cs.LM_CLI_B, 8, cs.LM_CLI_LONG_S, True, 32)
    o = torch.empty_like(q)
    lse_out = torch.empty_like(lse)
    flush = cs._flush_buffer()

    def fwd(lib):
        assert lib.dftt_flash_attention_fwd_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                                 lse_out.data_ptr(), 64, cs.LM_CLI_LONG_S, 32, 1,
                                                 1.0 / math.sqrt(32),
                                                 torch.cuda.current_stream().cuda_stream) == 0

    out = {}
    for who in ("parent", "this", "this", "parent") * 3:
        dq, dkv = _calls(libs[f"{who}_flash_attention_bwd"])
        lib1 = libs[f"{who}_flash_attention"]
        for name, fn in (("kernel_1", lambda: fwd(lib1)),
                         ("kernel_7", lambda: dq(q, k, v, do, lse, delta, True)),
                         ("kernel_8", lambda: dkv(q, k, v, do, lse, delta, True))):
            out.setdefault(name, {}).setdefault(who, []).append(float(cs._timed(fn, 10, flush)))
    return out


#: fresh generators (seeds beside chip_smoke.SEED) of the backward limits' draws
LIMIT_DRAWS = tuple(range(41, 49))
LOG2E = 1.4426950408889634


def _dq_exp2_folded(q, k, v, do, lse, delta, causal):
    """The plain dQ with P taken as exp2 of the folded argument, s_raw
    (scale log2 e) - lse log2 e: a kernel's rounding of P, emulated."""
    import torch

    from distriflow_tpu_torch.ops import flash_attention as fa

    scale = 1.0 / math.sqrt(q.shape[-1])

    def one(q, k, v, do, lse, delta):
        s = torch.matmul(q.float(), k.float().transpose(-1, -2))
        if causal:
            s = s.masked_fill(~fa._causal_keep(q.shape[2], q.device), -math.inf)
        p = torch.exp2(s * (scale * LOG2E) - lse.float()[..., None] * LOG2E)
        dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
        ds = (p * (dp - delta.float()[..., None])).to(q.dtype).float()
        return ((torch.matmul(ds, k.float()) * scale).to(q.dtype),)

    return fa._per_head(one, q, k, v, do, lse, delta)[0]


def limit_draws(older_so):
    """The two-kernel backward at D 32 (path (b)'s shape, B8 H8 S16384
    causal) and at D 64 (B1 H8 S16384) on the smoke's own draw and on each
    fresh draw of :data:`LIMIT_DRAWS`: for dQ and for dK/dV of this
    checkout's kernels, the older checkout's (``older_so``, through its C
    entries) and, for dQ, the plain version with the folded exp2's P, the
    atol each needs above the rtol around the plain version (the scalar
    limit's reading), the flips of ``chip_smoke._flip_atols`` each needs
    and its share of elements outside that limit; the share a dQ with
    delta taken as 0 and a dK without its scale put outside the scalar
    and the flip limits; each flip limit's atol (median, largest)."""
    import torch

    import chip_smoke as cs
    from distriflow_tpu_torch.ops import flash_attention as fa

    older = _calls(_bind(older_so)) if older_so else None
    out = {}
    for label, b, d, nq, nkv in (("d32", cs.LM_CLI_B, 32, "flash_attention_dq_d32", "flash_attention_dkv_d32"),
                                 ("d64", cs.LONG_TRAIN_B, 64, "flash_attention_dq", "flash_attention_dkv")):
        rows = []
        for seed in (("smoke",) if d == 32 else ()) + LIMIT_DRAWS:
            g = torch.Generator(device="cuda").manual_seed(cs.SEED + (41 if seed == "smoke" else seed))
            if seed == "smoke":  # the draws before the path's in _lm_cli_attention_rows
                cs._bwd_inputs(g, cs.LM_CLI_B, 8, cs.LM_CLI["max_seq"], True, 32)
                for ss, causal in cs.RAGGED_BWD:
                    cs._bwd_inputs(g, 1, 8, ss, causal, 32)
            args = cs._bwd_inputs(g, b, 8, cs.LM_CLI_LONG_S, True, d)
            q, k, v, do, lse, delta, _ = args
            row = {"seed": seed}
            plain = fa.flash_attention_dq_reference(*args)
            (atol,) = cs._flip_atols(nq, ("dq",), *args)
            row["dq_atol"] = [float(atol.median()), float(atol.max())]
            for who, fn in (("this", fa.flash_attention_dq), ("older", older and older[0]),
                            ("exp2_folded", _dq_exp2_folded)):
                if fn:
                    got = fn(*args)
                    row[f"dq_{who}"] = {"scalar_atol_needed": cs._atol_needed(nq, [(got, plain)]),
                                        "flips_needed": cs._flips_needed(nq, got, plain, atol),
                                        "outside": cs._rejected(nq, got, plain, atol=atol)}
            no_delta = fa.flash_attention_dq_reference(q, k, v, do, lse, torch.zeros_like(delta), True)
            row["dq_no_delta_outside"] = {"scalar": cs._rejected(nq, no_delta, plain),
                                          "flip": cs._rejected(nq, no_delta, plain, atol=atol)}
            del plain, atol, no_delta
            plain = fa.flash_attention_dkv_reference(*args)
            atols = cs._flip_atols(nkv, ("dk", "dv"), *args)
            row["dkv_atol"] = [float(torch.cat([a.flatten() for a in atols]).median()),
                               max(float(a.max()) for a in atols)]
            for who, fn in (("this", fa.flash_attention_dkv), ("older", older and older[1])):
                if fn:
                    got = fn(*args)
                    row[f"dkv_{who}"] = {
                        "scalar_atol_needed": cs._atol_needed(nkv, list(zip(got, plain))),
                        "flips_needed": max(cs._flips_needed(nkv, x, w, a) for x, w, a in zip(got, plain, atols)),
                        "outside": max(cs._rejected(nkv, x, w, atol=a) for x, w, a in zip(got, plain, atols))}
            unscaled = plain[0].float() * math.sqrt(d)
            row["dk_unscaled_outside"] = {"scalar": cs._rejected(nkv, unscaled, plain[0]),
                                          "flip": cs._rejected(nkv, unscaled, plain[0], atol=atols[0])}
            rows.append(row)
            del args, q, k, v, do, lse, delta, plain, atols, unscaled
            torch.cuda.empty_cache()
        out[label] = rows
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="an older checkout to time against this one, in turns")
    ap.add_argument("--limit", action="store_true",
                    help="only the backward limits' draws (limit_draws), with --older")
    ap.add_argument("--older", help="an older checkout whose dQ and dK/dV kernels the --limit draws "
                                    "hold too")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one_variant(args.one)))
        return
    import torch

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    if args.limit:
        older_so = None
        with tempfile.TemporaryDirectory() as work:
            if args.older:
                base = os.path.join(os.path.abspath(args.older), "distriflow_tpu_torch", "csrc")
                with open(os.path.join(base, "flash_attention_bwd.cu")) as f:
                    older_so = _build({"older": f.read()}, work, {"older": base})["older"]
            print(json.dumps({"card": card, "torch": torch.__version__,
                              "flips": __import__("chip_smoke").BWD_FLIPS,
                              "limit_draws": limit_draws(older_so)}))
        return
    with open(os.path.join(CSRC, "flash_attention_bwd.cu")) as f:
        src = f.read()
    from distriflow_tpu_torch.ops import build

    build.build_all(["flash_attention"])
    with tempfile.TemporaryDirectory() as work:
        libs = _build({n: fn(src) for n, fn in VARIANTS.items()}, work)
        report = {"card": card, "torch": torch.__version__, "variants": {}}
        for name, so in libs.items():
            p = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", so], capture_output=True,
                               text=True, timeout=300, cwd=ROOT)
            report["variants"][name] = (json.loads(p.stdout.splitlines()[-1]) if p.returncode == 0
                                        else {"error": p.stderr[-2000:]})
        report["mufu_ex2_per_clock_per_sm"] = mufu_rate(work)
        if args.parent:
            report["in_turns_ms"] = in_turns(os.path.abspath(args.parent), work)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
