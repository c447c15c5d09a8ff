"""Readings behind the design of kernel 1 at head dim 32
(``distriflow_tpu_torch/csrc/flash_attention.cu``, namespace ``d32``) on
one CUDA card. Prints one JSON object.

The source is built as it is and as patched copies, one change each
(:data:`VARIANTS`):

- ``exp2f``: P = exp2f of the same folded argument (without fast math a
  range-checked sequence around MUFU.EX2) instead of ex2.approx.ftz;
- ``three_warpgroups``, ``four_warpgroups``: three or four consumer
  warpgroups a block (192 or 256 query rows, one block an SM) instead of
  two (128 rows, two blocks an SM);
- ``keys128``: 128-key K/V tiles instead of 64;
- ``stages4``: a ring of 4 stages instead of 8;
- ``scores_ahead``: tile t+1's S issued before tile t's exponentials (a
  second S accumulator), not after them.

For each: ptxas' registers and spills of the kernel, the instructions
between its MUFU.EX2 in the SASS (``cuobjdump -sass``: each run of
exponentials with the instructions it spans, and the whole kernel's
count of each opcode a MUFU.EX2), O's and lse's largest error against
the plain version at path (b)'s shape (B8 H8 S16384 D32 causal, head by
head) and at ragged lengths, the same bits on a second launch, and its
median ms at path (b)'s shape and at the other D 32 shapes of the paths
(B8 H8 S512, B1 H4 S1024, B1 H4 S16288), with the exponentials' share of
the time at path (b)'s shape (``chip_smoke._bound``'s exponential term
over the time). Each variant runs in a process of its own with a time
limit. With ``--parent DIR`` (an older checkout) it also times that
checkout's kernel 1 at the same shapes against this one's, in turns
(parent, this, this, parent, three times).

Run from the repository's root: ``python3 tools/d32_fwd_probe.py [--parent DIR]``
(about three minutes of command on an H100).
"""

import argparse
import collections
import ctypes
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "distriflow_tpu_torch", "csrc")

import d32_bwd_probe as bwd  # noqa: E402  (its nvcc runs and ctypes binding)

#: (B, H, S) of kernel 1 at D 32 on the paths: path (b), path (a), the
#: draft's prefill and the TP speculative leg's
SHAPES = {"path_b": (8, 8, 16384), "path_a": (8, 8, 512), "spec_1k": (1, 4, 1024),
          "spec_16k": (1, 4, 16288)}
RAGGED = ((1, True), (37, True), (37, False), (191, True), (193, False), (1000, True), (1000, False))


def _sub(src, old, new):
    assert src.count(old) == 1, old[:80]
    return src.replace(old, new)


def exp2f_(src):
    return _sub(src, '''  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));
  return y;''', '''  y = exp2f(x);
  return y;''')


def _warpgroups(n):
    def patch(src):
        return _sub(src, "constexpr int kWarpgroups = 2;               // consumer warpgroups",
                    f"constexpr int kWarpgroups = {n};               // consumer warpgroups")
    return patch


def keys128(src):
    return _sub(src, "constexpr int kBK = 64;                      // key positions",
                "constexpr int kBK = 128;                     // key positions")


def stages4(src):
    return _sub(src, "constexpr int kStages = 8;", "constexpr int kStages = 4;")


_LOOP = """    // K tile t's scores run beside tile t-1's P.V; tile t's softmax runs
    // while the tensor cores finish that P.V
    for (int t = 1; t < n_mine; ++t) {
      const int s = Pipe::stage(t), sp = Pipe::stage(t - 1);
      mbar_wait(&k_full[s], Pipe::full_parity(t));
      mbar_wait(&v_full[sp], Pipe::full_parity(t - 1));
      wgmma_fence();
      scores(acc_s, desc_q, desc_kmajor<kRow>(k_s + s * kKVBytes));
      wgmma_commit();
      pv(acc_o, p_a, desc_mnmajor<kRow>(v_s + sp * kKVBytes));
      wgmma_commit();
      wgmma_wait<1>();  // the scores; P.V may still run
      fence_regs(acc_s);
      tile.probabilities(acc_s, t * kBK, m, corr, sum);
      wgmma_wait<0>();
      fence_regs(acc_o);
      fence_regs(p_a);
      if (threadIdx.x % 128 == 0) mbar_arrive(&empty[sp]);  // done with tile t-1
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + sum[i];
#pragma unroll
      for (int r = 0; r < D / 2; ++r) acc_o[r] *= corr[(r >> 1) & 1];
      acc_to_a(acc_s, p_a);
    }
"""

_AHEAD = """    // tile t's P.V, then tile t+1's scores, both beside tile t's softmax
    float acc_n[kBK / 2];
    auto step = [&](int t, float (&cur)[kBK / 2], float (&nxt)[kBK / 2]) {
      const int sp = Pipe::stage(t - 1);
      mbar_wait(&v_full[sp], Pipe::full_parity(t - 1));
      wgmma_fence();
      pv(acc_o, p_a, desc_mnmajor<kRow>(v_s + sp * kKVBytes));
      wgmma_commit();
      wgmma_wait<1>();  // tile t's scores
      fence_regs(cur);
      const bool ahead = t + 1 < n_mine;
      if (ahead) {
        const int sn = Pipe::stage(t + 1);
        mbar_wait(&k_full[sn], Pipe::full_parity(t + 1));
        wgmma_fence();
        scores(nxt, desc_q, desc_kmajor<kRow>(k_s + sn * kKVBytes));
        wgmma_commit();
      }
      tile.probabilities(cur, t * kBK, m, corr, sum);
      if (ahead)
        wgmma_wait<1>();  // tile t-1's P.V
      else
        wgmma_wait<0>();
      fence_regs(acc_o);
      fence_regs(p_a);
      if (threadIdx.x % 128 == 0) mbar_arrive(&empty[sp]);
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + sum[i];
#pragma unroll
      for (int r = 0; r < D / 2; ++r) acc_o[r] *= corr[(r >> 1) & 1];
      acc_to_a(cur, p_a);
    };
    for (int t = 1; t < n_mine; t += 2) {
      step(t, acc_n, acc_s);
      if (t + 1 < n_mine) step(t + 1, acc_s, acc_n);
    }
"""


def scores_ahead(src):
    """Tile t+1's S issued before tile t's exponentials (two score
    accumulators)."""
    src = _sub(src, """    tile.probabilities(acc_s, 0, m, corr, sum);
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = sum[i];
    acc_to_a(acc_s, p_a);
""", """    if (n_mine > 1) {
      mbar_wait(&k_full[Pipe::stage(1)], Pipe::full_parity(1));
      wgmma_fence();
      scores(acc_n, desc_q, desc_kmajor<kRow>(k_s + Pipe::stage(1) * kKVBytes));
      wgmma_commit();
    }
    tile.probabilities(acc_s, 0, m, corr, sum);
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = sum[i];
    acc_to_a(acc_s, p_a);
""")
    src = _sub(src, "  if (n_mine > 0) {\n    // K tile 0", "  if (n_mine > 0) {\n    float acc_n[kBK / 2];\n    // K tile 0")
    return _sub(src, _LOOP, _AHEAD.replace("    float acc_n[kBK / 2];\n", ""))


VARIANTS = {"as_built": lambda s: s, "exp2f": exp2f_, "three_warpgroups": _warpgroups(3),
            "four_warpgroups": _warpgroups(4), "keys128": keys128, "stages4": stages4,
            "scores_ahead": scores_ahead}


def _fwd(lib):
    """Kernel 1 through the library's C entry, as the wrapper calls it."""
    import torch

    def fwd(q, k, v, causal=True):
        b, h, s, d = q.shape
        o = torch.empty_like(q)
        lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
        rc = lib.dftt_flash_attention_fwd_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                               lse.data_ptr(), b * h, s, d, int(causal),
                                               1.0 / math.sqrt(d), torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return o, lse

    return fwd


def _inputs(g, b, h, s):
    import torch

    return tuple(torch.randn(b, h, s, 32, generator=g, device="cuda").to(torch.bfloat16)
                 for _ in range(3))


def one_variant(so):
    """The readings of one built variant (run in a process of its own)."""
    import torch

    import chip_smoke as cs
    from distriflow_tpu_torch.ops import flash_attention as fa

    fwd = _fwd(bwd._bind(so))
    nf = "flash_attention_fwd"
    out = {"ragged": {}}
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 58)
    for s, causal in RAGGED:
        q, k, v = _inputs(g, 1, 8, s)
        (o, lse), (ro, rl) = fwd(q, k, v, causal), fa.flash_attention_reference(q, k, v, causal)
        out["ragged"][f"S={s} {'causal' if causal else 'non-causal'}"] = [
            cs._atol_needed(nf, [(o, ro)]), float((lse - rl).abs().max())]
    b, h, s = SHAPES["path_b"]
    q, k, v = _inputs(g, b, h, s)
    o, lse = fwd(q, k, v)
    again = fwd(q, k, v)
    out["same_bits"] = bool(torch.equal(again[0], o) and torch.equal(again[1], lse))
    del again
    ro, rl = fa._per_head(lambda *x: fa.flash_attention_reference(*x, True), q, k, v)
    out["path_b_atol_needed"] = {"o": cs._atol_needed(nf, [(o, ro)]),
                                 "lse": float((lse - rl).abs().max())}
    del o, lse, ro, rl, q, k, v
    flush = cs._flush_buffer()
    out["ms"] = {}
    for label, (b, h, s) in SHAPES.items():
        q, k, v = _inputs(g, b, h, s)
        out["ms"][label] = float(cs._timed(lambda: fwd(q, k, v), 10, flush))
    b, h, s = SHAPES["path_b"]
    exp_ms = cs._bound(0, 0, exps=b * h * s * (s + 1) // 2)[0]
    out["exponentials_share"] = exp_ms / out["ms"]["path_b"]
    return out


_INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")


def sass_readings(so):
    """The d32 forward kernel's SASS: each run of MUFU.EX2 (consecutive ones
    at most 40 instructions apart, 32 or more of them) with the
    instructions it spans a MUFU.EX2, its branches and its opcodes; and the
    whole kernel's count of each opcode a MUFU.EX2."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True, check=True).stdout
    funcs = re.split(r"\n\s*Function : ", text)
    body = next(f for f in funcs if "d32" in f.split("\n", 1)[0] and "fwd_kernel" in f.split("\n", 1)[0])
    ops = []
    for line in body.splitlines():
        m = _INSTR.search(line)
        if m:
            toks = [t for t in m.group(1).split() if not t.startswith("@")]
            if toks:
                ops.append(toks[0])
    at = [i for i, op in enumerate(ops) if op == "MUFU.EX2"]
    runs, cur = [], at[:1]
    for i in at[1:]:
        if i - cur[-1] > 40:
            runs.append(cur)
            cur = []
        cur.append(i)
    runs.append(cur)
    out = {"instructions": len(ops), "mufu_ex2": len(at), "runs": []}
    for r in runs:
        if len(r) < 32:
            continue
        span = ops[r[0]:r[-1] + 1]
        out["runs"].append({"mufu": len(r), "per_mufu": len(span) / len(r),
                            "branches": sum(op.startswith("BRA") for op in span),
                            "opcodes": dict(collections.Counter(op.split(".")[0] for op in span))})
    counts = collections.Counter(op.split(".")[0] for op in ops)
    out["per_mufu_whole_kernel"] = {op: n / max(1, len(at)) for op, n in counts.most_common(14)}
    return out


def in_turns(parent, work):
    """Kernel 1 at D 32 at each of :data:`SHAPES`, this checkout's against
    the parent's, in turns (parent, this, this, parent) three times."""
    import torch

    import chip_smoke as cs

    srcs, headers = {}, {}
    for who, base in (("parent", os.path.join(parent, "distriflow_tpu_torch", "csrc")), ("this", CSRC)):
        with open(os.path.join(base, "flash_attention.cu")) as f:
            srcs[who] = f.read()
        headers[who] = base
    fwds = {k: _fwd(bwd._bind(so)) for k, so in bwd._build(srcs, work, headers).items()}
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 59)
    inputs = {label: _inputs(g, *shape) for label, shape in SHAPES.items()}
    flush = cs._flush_buffer()
    out = {}
    for who in ("parent", "this", "this", "parent") * 3:
        for label, (q, k, v) in inputs.items():
            out.setdefault(label, {}).setdefault(who, []).append(
                float(cs._timed(lambda: fwds[who](q, k, v), 10, flush)))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="an older checkout to time against this one, in turns")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one_variant(args.one)))
        return
    import torch

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    with open(os.path.join(CSRC, "flash_attention.cu")) as f:
        src = f.read()
    from distriflow_tpu_torch.ops import build

    with tempfile.TemporaryDirectory() as work:
        srcs = {n: fn(src) for n, fn in VARIANTS.items()}
        procs = {}
        for name, text in srcs.items():  # the ptxas report of each variant
            d = os.path.join(work, "ptxas", name)
            os.makedirs(d)
            with open(os.path.join(d, "k.cu"), "w") as f:
                f.write(text)
            procs[name] = subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-I", CSRC, "-o", os.path.join(d, "k.so"),
                 os.path.join(d, "k.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        report = {"card": card, "torch": torch.__version__, "variants": {}}
        for name, p in procs.items():
            log, _ = p.communicate()
            if p.returncode:
                report["variants"][name] = {"error": log[-3000:]}
                continue
            lines = log.splitlines()
            at = next((i for i, x in enumerate(lines) if "Compiling entry" in x and "d32" in x
                       and "fwd_kernel" in x), None)
            so = os.path.join(work, "ptxas", name, "k.so")
            entry = {"ptxas": [x.strip() for x in lines[at:at + 4]] if at is not None else None,
                     "sass": sass_readings(so)}
            r = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", so],
                               capture_output=True, text=True, timeout=300, cwd=ROOT)
            entry.update(json.loads(r.stdout.splitlines()[-1]) if r.returncode == 0
                         else {"error": r.stderr[-3000:]})
            report["variants"][name] = entry
        if args.parent:
            report["in_turns_ms"] = in_turns(os.path.abspath(args.parent), work)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
