"""Readings behind the f32 fused attention backward's design
(``distriflow_tpu_torch/csrc/flash_attention_f32.cu``: ``split3::bwd_kernel``
and ``dq_sum_kernel``) on one CUDA card. Prints one JSON object.

- ``limit``: at path (c)'s shape (B8 H8 S512 D32 causal) and at D 64
  beside it, on fresh draws (generators ``SEED + 60`` on, inputs as
  ``chip_smoke._bwd_inputs`` draws them), and at ragged lengths (B1 H8,
  :data:`RAGGED`, D 32 and 64): the atol above the row's rtol
  (``chip_smoke.TOL["flash_attention_bwd_f32"]``) that dQ, dK and dV of
  each recipe need against the f32 plain version
  (``flash_attention_backward_reference``): all five products in
  split-precision TF32 (``all_split``: the mirror
  ``flash_attention_fused_split_tf32_reference``), S and dP f32 products
  with the other three split (``scores_f32``), the recipe in f64
  (``f64``), one TF32 pass of the plain version (``tf32_one_pass``) and,
  unless ``--no-kernel``, the kernel; then (``vs_f64``) the atol dQ of
  the plain version, of ``all_split`` and of the kernel need against the
  f64 recipe, the reference ``TOL["flash_attention_dq_f32_exact"]`` holds
  dQ to; and the share of elements the planted faults put outside each
  limit (``no_delta`` and one TF32 pass on dQ, ``dk_unscaled`` on dK).
- ``variants`` (unless ``--no-variants``): the source as it is and patched
  copies of its block shape (:data:`VARIANTS`), each built with the port's
  ``nvcc`` flags and run in a process of its own with a time limit:
  ptxas' registers and spills of the fused kernel, the atol dQ, dK and dV
  need against the plain version at path (c)'s shape and at D 64, and
  dQ's against the f64 recipe, the largest on the ragged lengths, the same
  bits on a second launch, and the median ms at both shapes.
- ``--parent DIR`` (an older checkout): its fused f32 backward and this
  one's at both shapes in turns (parent, this, this, parent, three times).

Run from the repository's root: ``python3 tools/f32_fused_bwd_probe.py
[--no-kernel] [--no-variants] [--parent DIR]``.
"""

import argparse
import json
import math
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "distriflow_tpu_torch", "csrc")

NAME = "flash_attention_bwd_f32"
EXACT = "flash_attention_dq_f32_exact"
#: (S, causal) of the ragged readings: the row's RAGGED_BWD and short
#: causal lengths inside one key block
RAGGED = ((1, True), (37, True), (37, False), (128, True), (300, True), (1000, True),
          (1000, False))
DRAWS = (60, 61, 62)
#: the source's block shape by head dim: (warps, streamed rows)
SHAPE = {32: (4, 32), 64: (4, 16)}


def one_score_accumulator(src):
    """S^T and dP^T each in one accumulator over all D / 8 k-steps."""
    old = """        mma3_add(s[j], kab, kas, frag_b(qtb, off, 4), frag_b(qts, off, 4));
        mma3_add(dp[j], vab, vas, frag_b(otb, off, 4), frag_b(ots, off, 4));"""
    assert src.count(old) == 1
    return src.replace(old, old.replace("mma3_add(", "mma3("))


#: each variant: its block shape by head dim and a patch of the source
VARIANTS = {"source": (SHAPE, None), "keys128": ({32: (8, 32), 64: (8, 16)}, None),
            "keys32": ({32: (2, 32), 64: (2, 16)}, None),
            "keys64_rows16": ({32: (4, 16), 64: (4, 16)}, None),
            "one_score_accumulator": (SHAPE, one_score_accumulator)}


def _f64_recipe(q, k, v, do, lse, delta, causal):
    """(dQ, dK, dV) of the backward's recipe in f64 from its f32 inputs."""
    import torch

    scale = 1.0 / math.sqrt(q.shape[-1])
    q, k, v, do, lse, delta = (t.double() for t in (q, k, v, do, lse, delta))
    p = torch.exp(q @ k.transpose(-1, -2) * scale - lse[..., None])
    if causal:
        n = q.shape[2]
        p = torch.where(torch.ones(n, n, dtype=torch.bool, device=q.device).tril(), p,
                        torch.zeros_like(p))
    ds = p * (do @ v.transpose(-1, -2) - delta[..., None])
    return ds @ k * scale, ds.transpose(-1, -2) @ q * scale, p.transpose(-1, -2) @ do


def _need(name, got, want):
    import chip_smoke as cs

    return cs._atol_needed(name, [(got, want)])


def _readings(args, kernel):
    """The needs of one draw, by recipe and gradient."""
    import chip_smoke as cs
    from distriflow_tpu_torch.ops import flash_attention as fa

    q, k, v, do, lse, delta, causal = args
    plain = fa.flash_attention_backward_reference(*args)
    exact = _f64_recipe(*args)
    recipes = {"all_split": fa.flash_attention_fused_split_tf32_reference(*args),
               "scores_f32": fa.flash_attention_fused_split_tf32_reference(*args, split_scores=False),
               "f64": exact,
               "tf32_one_pass": cs._tf32_run(lambda: fa.flash_attention_backward_reference(*args))}
    if kernel:
        recipes["kernel"] = kernel(*args)
    out = {n: {g: _need(NAME, a, w) for g, a, w in zip(("dq", "dk", "dv"), r, plain)}
           for n, r in recipes.items()}
    out["vs_f64"] = {f"{n}_{g}": _need(EXACT, x, e)
                     for n, r in (("plain", plain), *recipes.items()) if n != "f64"
                     for g, x, e in zip(("dq", "dk", "dv"), r, exact)}
    no_delta = fa.flash_attention_backward_reference(q, k, v, do, lse, 0 * delta, causal)[0]
    faults = {"no_delta": (no_delta, plain[0], exact[0]),
              "tf32_one_pass": (recipes["tf32_one_pass"][0], plain[0], exact[0])}
    out["outside"] = {n: {"vs_plain": cs._rejected(NAME, x, p), "vs_f64": cs._rejected(EXACT, x, e)}
                      for n, (x, p, e) in faults.items()}
    out["outside"]["dk_unscaled"] = {"vs_plain": cs._rejected(NAME, plain[1] * math.sqrt(q.shape[-1]),
                                                              plain[1])}
    return out


def _worst(readings):
    """The largest need of each (recipe, gradient) over draws."""
    out = {}
    for r in readings:
        for n, by in r.items():
            if n == "outside":
                continue
            for g, x in by.items():
                out.setdefault(n, {})[g] = max(out.get(n, {}).get(g, x), x)
    return out


def limit(kernel_on):
    import torch

    import chip_smoke as cs
    from distriflow_tpu_torch.ops import flash_attention as fa

    kernel = fa.flash_attention_backward if kernel_on else None
    h, s = cs.LM_CLI["n_heads"], cs.LM_CLI["max_seq"]
    out = {"atol": cs.TOL[NAME][0], "exact_atol": cs.TOL[EXACT][0]}
    for d in (32, 64):
        draws = []
        for seed in DRAWS:
            g = torch.Generator(device="cuda").manual_seed(cs.SEED + seed)
            draws.append(_readings(cs._bwd_inputs(g, cs.LM_CLI_B, h, s, True, d, torch.float32),
                                   kernel))
        out[f"d{d}"] = {"worst": _worst(draws), "outside": [r["outside"] for r in draws]}
        g = torch.Generator(device="cuda").manual_seed(cs.SEED + 63)
        out[f"d{d}"]["ragged"] = {
            f"S={ss} {'causal' if c else 'non-causal'}": _worst([_readings(
                cs._bwd_inputs(g, 1, h, ss, c, d, torch.float32), kernel)])
            for ss, c in RAGGED}
    return out


def _source_keys(src):
    """The fused kernel's key block by head dim in a source's text: 16 x
    ``FusedShape<D>::kWarps``, or 64 for the FFMA kernel before it."""
    keys = {}
    for d in (32, 64):
        m = re.search(r"struct FusedShape<%d> \{\n  static constexpr int kWarps = (\d+)" % d, src)
        keys[d] = 16 * int(m.group(1)) if m else 64
    return keys


def _shape_src(src, shape):
    for d, (w, r) in shape.items():
        pat = (r"(struct FusedShape<%d> \{\n  static constexpr int kWarps = )\d+(, kRows = )\d+;" % d)
        src, n = re.subn(pat, r"\g<1>%d\g<2>%d;" % (w, r), src)
        assert n == 1, d
    return src


def _build(srcs, work):
    """One shared library a variant, all nvcc runs at once, with the
    port's flags; returns {name: (path, ptxas lines of the fused kernel)}."""
    from distriflow_tpu_torch.ops import build

    procs = {}
    for name, src in srcs.items():
        d = os.path.join(work, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(CSRC, "common.cuh")) as f, open(os.path.join(d, "common.cuh"), "w") as o:
            o.write(f.read())
        with open(os.path.join(d, "k.cu"), "w") as f:
            f.write(src)
        procs[name] = subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-I", d, "-o",
                                        os.path.join(d, "k.so"), os.path.join(d, "k.cu")],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        lines, keep = [], False
        for line in log.splitlines():
            if "Compiling entry" in line:
                keep = "bwd_kernel" in line
            if keep and ("registers" in line or "spill" in line or "Compiling entry" in line):
                lines.append(line.strip())
        out[name] = (os.path.join(work, name, "k.so"), lines)
    return out


def _call(so, keys):
    """The fused backward through the library's C entry, dqp sized for
    ``keys`` (by head dim)."""
    import ctypes

    import torch

    from distriflow_tpu_torch.ops import flash_attention as fa

    lib = ctypes.CDLL(so)
    fn = lib.dftt_flash_attention_bwd_f32
    fn.argtypes, fn.restype = fa._F32_SIGNATURES["dftt_flash_attention_bwd_f32"], ctypes.c_int

    def bwd(q, k, v, do, lse, delta, causal):
        b, h, s, d = q.shape
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        dqp = torch.empty((-(-s // keys[d]), b * h, s, d), device=q.device)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), dqp.data_ptr(), dq.data_ptr(),
                b * h, s, d, int(causal), 1.0 / math.sqrt(d), torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return dq, dk, dv

    return bwd


def one_variant(so, keys):
    """The readings of one built variant (run in a process of its own)."""
    import torch

    import chip_smoke as cs
    from distriflow_tpu_torch.ops import flash_attention as fa

    bwd = _call(so, keys)
    h, s = cs.LM_CLI["n_heads"], cs.LM_CLI["max_seq"]
    flush = cs._flush_buffer()
    out = {}
    for d in (32, 64):
        g = torch.Generator(device="cuda").manual_seed(cs.SEED + DRAWS[0])
        args = cs._bwd_inputs(g, cs.LM_CLI_B, h, s, True, d, torch.float32)
        got, want = bwd(*args), fa.flash_attention_backward_reference(*args)
        again = bwd(*args)
        exact = _f64_recipe(*args)[0]
        r = {"need": {n: _need(NAME, a, w) for n, a, w in zip(("dq", "dk", "dv"), got, want)},
             "dq_vs_f64": _need(EXACT, got[0], exact),
             "same_bits": all(bool(torch.equal(a, b)) for a, b in zip(got, again))}
        del got, want, again, exact
        gr = torch.Generator(device="cuda").manual_seed(cs.SEED + 63)
        rag = []
        for ss, c in RAGGED:
            a = cs._bwd_inputs(gr, 1, h, ss, c, d, torch.float32)
            got, want = bwd(*a), fa.flash_attention_backward_reference(*a)
            rag.append(max(_need(NAME, x, w) for x, w in zip(got[1:], want[1:])))
            r.setdefault("ragged_dq_vs_f64", 0.0)
            r["ragged_dq_vs_f64"] = max(r["ragged_dq_vs_f64"], _need(EXACT, got[0], _f64_recipe(*a)[0]))
        r["ragged_dkv_need"] = max(rag)
        r["ms"] = float(cs._timed(lambda: bwd(*args), 20, flush))
        out[f"d{d}"] = r
    return out


def variants(work):
    with open(os.path.join(CSRC, "flash_attention_f32.cu")) as f:
        src = f.read()
    srcs = {n: _shape_src(patch(src) if patch else src, shape)
            for n, (shape, patch) in VARIANTS.items()}
    built = _build(srcs, work)
    out = {}
    for name, (so, ptxas) in built.items():
        keys = _source_keys(srcs[name])
        code = ("import json, sys\n"
                f"sys.path.insert(0, {os.path.dirname(os.path.abspath(__file__))!r})\n"
                f"sys.path.insert(0, {ROOT!r})\n"
                "import f32_fused_bwd_probe as p\n"
                f"print(json.dumps(p.one_variant({so!r}, {keys!r})))\n")
        try:
            r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                               timeout=240, cwd=ROOT)
            res = (json.loads(r.stdout.splitlines()[-1]) if r.returncode == 0
                   else {"error": r.stderr[-2000:]})
        except subprocess.TimeoutExpired:
            res = {"error": "timed out"}
        out[name] = {"shape": VARIANTS[name][0], "ptxas": ptxas, **res}
    return out


def in_turns(parent, work):
    """The fused f32 backward at path (c)'s shape and at D 64, the parent's
    and this checkout's, in turns (parent, this, this, parent) three times."""
    import torch

    import chip_smoke as cs

    srcs = {}
    for who, base in (("parent", os.path.join(parent, "distriflow_tpu_torch", "csrc")), ("this", CSRC)):
        with open(os.path.join(base, "flash_attention_f32.cu")) as f:
            srcs[who] = f.read()
    built = _build(srcs, work)
    calls = {who: _call(built[who][0], _source_keys(srcs[who])) for who in built}
    h, s = cs.LM_CLI["n_heads"], cs.LM_CLI["max_seq"]
    flush = cs._flush_buffer()
    out = {}
    for d in (32, 64):
        g = torch.Generator(device="cuda").manual_seed(cs.SEED + DRAWS[0])
        args = cs._bwd_inputs(g, cs.LM_CLI_B, h, s, True, d, torch.float32)
        times = {"parent": [], "this": []}
        for _ in range(3):
            for who in ("parent", "this", "this", "parent"):
                times[who].append(float(cs._timed(lambda: calls[who](*args), 20, flush)))
        out[f"d{d}"] = times
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--no-kernel", action="store_true", help="leave the kernel out of the limit readings")
    ap.add_argument("--no-variants", action="store_true")
    ap.add_argument("--parent", help="an older checkout whose fused f32 backward to time in turns")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("f32_fused_bwd_probe: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"card": cs._card(), "limit": limit(not a.no_kernel)}
    print(json.dumps({"limit": out["limit"]}), flush=True)
    build_dir = os.path.join(CSRC, "build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as work:
        if not a.no_variants:
            out["variants"] = variants(work)
        if a.parent:
            out["in_turns"] = in_turns(a.parent, work)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
