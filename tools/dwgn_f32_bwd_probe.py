"""Readings behind the f32 depthwise backward's design
(``distriflow_tpu_torch/csrc/depthwise_gn.cu``: ``f32bwd::bwd_kernel``,
kernel 12 in f32) on one CUDA card. Prints one JSON object.

- ``variants``: the source as it is and patched copies (:data:`VARIANTS`):
  three CTAs an SM asked of its ``__launch_bounds__`` (the source asks
  two), and, for timing only (its results are wrong), pass 2 reading one
  x value where it recomputes the conv: what a conv output kept in shared
  memory could save at most (pass 3 loads the conv's inputs for dw all the
  same). Each is built with the port's ``nvcc`` flags and run in a
  process of its own with a time limit: ptxas' registers and spills of
  the kernel (one instance a channel chunk); then at each shape of
  :data:`SHAPES` (B 256, the inputs ``chip_smoke.py``'s f32 rows draw)
  every resident plan of the f32 backward within the card's shared memory
  (``ops/depthwise_gn.py::_f32_bwd_plans``), and the streamed plans where
  the shape's own plan streams (else one, to hold that path): the CTAs an
  SM holds (the runtime's occupancy calculator), the median ms, the
  plan's estimated cost (``f32_bwd_cost``) and, unless timing only,
  whether dx, dscale and dbias stay within the row's limit and dw within
  ``DWGN_F32_SUM_RTOL`` of the plain version (``chip_smoke._dwgn_f32_check``)
  and give the same bits on a second launch. ``plan`` names the one
  ``dwgn_plan`` picks.
- ``--phases``: a build whose thread 0 of every CTA stamps ``clock64()``
  between the kernel's phases (:data:`PHASES`): each phase's median
  cycles over the CTAs of one launch at :data:`SHAPES` under their plans.
- ``--sass FILE``: the kernel's SASS (``cuobjdump -sass``, the instance
  for chunks of 8) into FILE, and its instructions by opcode.
- ``--parent DIR`` (an older checkout): its f32 backward (its source and
  its plan) and this one's at :data:`SHAPES` in turns (parent, this, this,
  parent, three times).
- ``--all-shapes``: all 20 shapes of the f32 rows (96 px at B 256, 224 px
  at B 64) instead of :data:`SHAPES`; ``--no-variants`` leaves the
  variants out.

Run from the repository's root: ``python3 tools/dwgn_f32_bwd_probe.py
[--all-shapes] [--no-variants] [--phases] [--sass FILE] [--parent DIR]``.
"""

import argparse
import ctypes
import importlib.util
import json
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

NAME = "depthwise_gn_bwd_f32"
#: the issue's four shapes at 96 px (h, w, c, stride)
SHAPES = ((48, 48, 96, 2), (24, 24, 144, 1), (6, 6, 384, 1), (3, 3, 960, 1))
CONV_CALL = "conv<CC>(p, l.xs, wr, ly, lx)"


def _blocks(n):
    def patch(src):
        assert src.count("constexpr int kBlocks = 2;") == 1
        return src.replace("constexpr int kBlocks = 2;", f"constexpr int kBlocks = {n};")
    return patch


def _no_recompute(src):
    """Pass 2 reads the tap (0, 0) value instead of the conv."""
    assert src.count(CONV_CALL) == 1, src.count(CONV_CALL)
    return src.replace(CONV_CALL, "l.xs[((ly * p.s) * p.xc + lx * p.s) * p.cc]")


#: each variant: its patch of the source, and whether it is for timing only
VARIANTS = {"source": (None, False), "blocks3": (_blocks(3), False),
            "no_recompute": (_no_recompute, True)}


def _ptxas(log):
    """ptxas' registers and spills of the f32 backward kernel in ``log``."""
    lines, keep = [], False
    for line in log.splitlines():
        if "Compiling entry" in line:
            keep = "f32bwd" in line or "dwgn_bwd_kernelINS_3F32" in line
        elif keep and ("registers" in line or "spill" in line):
            lines.append(line.strip())
    return lines


def _build(srcs, work, csrc=CSRC, log_filter=_ptxas):
    """One shared library a variant, all nvcc runs at once, with the
    port's flags and the headers of ``csrc``; returns {name: (path,
    ``log_filter`` of its log: ptxas lines of the f32 backward kernel)}."""
    from distriflow_tpu_torch.ops import build

    procs = {}
    for name, src in srcs.items():
        d = os.path.join(work, name)
        os.makedirs(d, exist_ok=True)
        for h in ("common.cuh", "hopper.cuh"):
            shutil.copy(os.path.join(csrc, h), os.path.join(d, h))
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
        out[name] = (os.path.join(work, name, "k.so"), log_filter(log))
    return out


def _entry(so):
    """The library's f32 backward C entry and its occupancy entry (None
    where the source has none)."""
    from distriflow_tpu_torch.ops import depthwise_gn as dg

    lib = ctypes.CDLL(so)
    fn = lib.dftt_dwgn_bwd_f32
    fn.argtypes, fn.restype = dg._SIGNATURES["dftt_dwgn_bwd_f32"], ctypes.c_int
    ctas = getattr(lib, "dftt_dwgn_bwd_f32_ctas_per_sm", None)
    if ctas is not None:
        ctas.argtypes, ctas.restype = [ctypes.c_int] * 2, ctypes.c_int
    return fn, ctas


def _call(fn, plan, x, k, sc, bi, g, s):
    """``(dx, dw, dscale, dbias)`` of the f32 backward through ``fn`` under
    ``plan`` (the wrapper's allocation and batch sum)."""
    import torch

    from distriflow_tpu_torch.ops import depthwise_gn as dg

    b, h, wd, c = x.shape
    dx = torch.empty_like(x)
    dwp = torch.empty(b, 3, 3, c, device=x.device)
    dsp, dbp = torch.empty(b, c, device=x.device), torch.empty(b, c, device=x.device)
    rc = fn(x.data_ptr(), k.data_ptr(), sc.data_ptr(), bi.data_ptr(), g.data_ptr(), dx.data_ptr(),
            dwp.data_ptr(), dsp.data_ptr(), dbp.data_ptr(), b, h, wd, c, s, 1e-6, 1,
            plan.cc, plan.rows, plan.cols, plan.cluster, plan.tiles_per_cta, plan.images,
            plan.smem, torch.cuda.current_stream().cuda_stream)
    assert rc == 0, f"launch failed with CUDA error {rc}"
    return dg._reduce(dx, dwp, dsp, dbp, k, sc, bi)


def _plan_key(plan):
    return [plan.cc, plan.rows, plan.cols, plan.cluster, plan.tiles_per_cta, plan.images, plan.smem]


def _cases(all_shapes):
    """``(tag, shape, x, k, scale, bias, g)`` as the f32 rows draw them."""
    import torch

    import chip_smoke as cs

    for px, batch, size in ((96, cs.MN_B, cs.MN), (224, cs.MN224_B, cs.MN224)):
        shapes = cs._depthwise_shapes(size["image_size"], size["width"])
        for key, x, k, sc, bi, g in cs._dwgn_cases(shapes, batch, torch.float32, cs.SEED + 8):
            if all_shapes or (px == 96 and key in SHAPES):
                yield f"{px}px {key[0]}x{key[1]}x{key[2]} s{key[3]}", key, x, k, sc, bi, g


def one_variant(so, timing_only, all_shapes):
    """The readings of one built variant (run in a process of its own)."""
    import torch

    import chip_smoke as cs
    from distriflow_tpu_torch.ops import depthwise_gn as dg

    fn, ctas = _entry(so)
    flush, out = cs._flush_buffer(), {}
    for tag, (h, w, c, s), x, k, sc, bi, g in _cases(all_shapes):
        want = None if timing_only else dg.depthwise3x3_groupnorm_backward_reference(
            x, k, sc, bi, g, s)
        chosen = dg.dwgn_plan(h, w, c, s, True, 4)
        plans = dg._f32_bwd_plans(h, w, c, s, dg.SMEM_LIMIT)
        if chosen.tiles_per_cta > 1:  # the streamed plans it was chosen from
            plans += dg._f32_bwd_plans(h, w, c, s, dg.SMEM_TARGET[(True, 4)], streamed=True)
        else:  # and one streamed plan, to hold that path
            plans.append(dg.make_plan(h, w, c, s, True, chosen.cc, -(-chosen.rows // 2),
                                      chosen.cols, cluster=1, itemsize=4))
        rows = []
        for plan in plans:
            r = {"plan": _plan_key(plan), "cost": dg.f32_bwd_cost(plan),
                 "ctas_per_sm": ctas(plan.cc, plan.smem)}
            try:
                got = _call(fn, plan, x, k, sc, bi, g, s)
                if want is not None:
                    cs._dwgn_f32_check(NAME, got, want)
                    again = _call(fn, plan, x, k, sc, bi, g, s)
                    r["same_bits"] = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
                    del again
                del got
                r["ok"] = True
            except AssertionError as e:
                r.update(ok=False, error=str(e)[:300])
            r["ms"] = float(cs._timed(lambda: _call(fn, plan, x, k, sc, bi, g, s), 5, flush))
            rows.append(r)
        rows.sort(key=lambda r: r["ms"])
        out[tag] = {"plan": _plan_key(chosen), "plan_rank": [r["plan"] for r in rows].index(
            _plan_key(chosen)), "plans": rows}
        del x, k, g, want
        torch.cuda.empty_cache()
    return out


#: the phase stamps' places in the kernel: (anchor, before or after it)
STAMPS = (("  const Smem<F32> sm = carve<F32>(p);\n", False),
          ("  // pass 1: the statistics (box-local outputs start one ring in)\n", True),
          ("    v[0] = group_sum(v[0]);", True),
          ("    stats_from_slots(p, sm, eps);\n  }\n", False),
          ("  if (resident) mbar_wait(sm.bar + 1, 0);  // the g box\n", False),
          ("    v[2] = group_sum(v[2]);", True),
          ("  const float kv = sm.st[grp + 4]", True),
          ("    // dx at the inputs this tile owns", True),
          ("  // dw: one slice sum of the nine taps", True),
          ("  if (rank == 0) {\n    for (int v = threadIdx.x; v < 9 * ncc", True),
          ("  if (p.cluster > 1) cluster_sync();  // no CTA leaves while rank 0", True))
#: the phases between the stamps
PHASES = ("x_wait", "pass1_loop", "pass1_sums", "g_wait", "pass2_loop", "pass2_sums",
          "dacc_dw", "dx", "dw_sums", "dw_out")
MAX_STAMP_CTAS = 65536


def _stamped(src, namespace="f32bwd", stamps=STAMPS):
    """The source with thread 0 of every CTA writing clock64() at each of
    ``stamps`` (anchors in ``namespace``) into a device array, and a C
    entry that reads it."""
    head, body = src.split(f"namespace {namespace} {{")
    body, tail = body.split(f"}}  // namespace {namespace}\n")
    for i, (anchor, before) in enumerate(stamps):
        assert body.count(anchor) == 1, anchor
        stamp = f"STAMP({i});\n"
        body = body.replace(anchor, stamp + anchor if before else anchor + stamp)
    body += f"}}  // namespace {namespace}\n" + tail
    n = len(stamps)
    return (head + f"""__device__ long long dftt_stamps[{MAX_STAMP_CTAS} * {n}];
#define STAMP(i)                                                                  \\
  if (threadIdx.x == 0) {{                                                         \\
    const long long bid = blockIdx.x + gridDim.x * (blockIdx.y + (long long)gridDim.y * blockIdx.z); \\
    if (bid < {MAX_STAMP_CTAS}) dftt_stamps[bid * {n} + (i)] = clock64();  \\
  }}
}}  // namespace
extern "C" int dftt_read_stamps(long long* out, int n) {{
  return (int)cudaMemcpyFromSymbol(out, dftt_stamps, n * sizeof(long long));
}}
namespace {{
namespace {namespace} {{""" + body)


def phases(work):
    """Each phase's median cycles (thread 0 of every CTA, one launch) at
    :data:`SHAPES` under the chosen plans, from a stamped build."""
    import numpy as np
    import torch

    from distriflow_tpu_torch.ops import depthwise_gn as dg

    with open(os.path.join(CSRC, "depthwise_gn.cu")) as f:
        src = f.read()
    so, _ = _build({"stamped": _stamped(src)}, work)["stamped"]
    fn, _ = _entry(so)
    lib = ctypes.CDLL(so)
    read = lib.dftt_read_stamps
    read.argtypes, read.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    out = {}
    for tag, (h, w, c, s), x, k, sc, bi, g in _cases(False):
        plan = dg.dwgn_plan(h, w, c, s, True, 4)
        n = min(plan.ctas(x.shape[0]), MAX_STAMP_CTAS)
        _call(fn, plan, x, k, sc, bi, g, s)
        torch.cuda.synchronize()
        buf = np.zeros(n * len(STAMPS), np.int64)
        assert read(buf.ctypes.data, buf.size) == 0
        st = buf.reshape(n, len(STAMPS)).astype(np.float64)
        d = np.diff(st, axis=1)
        out[tag] = {"ctas": n, "total_cycles_median": float(np.median(st[:, -1] - st[:, 0])),
                    "total_cycles_p90": float(np.percentile(st[:, -1] - st[:, 0], 90)),
                    "phases_median": {ph: float(np.median(d[:, i])) for i, ph in enumerate(PHASES)}}
        del x, k, g
    return out


def sass(work, out_path, namespace="f32bwd", instance="ILi8E", build_fn=None):
    """The kernel's SASS (the ``instance`` of ``namespace``'s kernel: for
    chunks of 8 channels) from ``cuobjdump -sass`` of a build of the
    source: its instructions by opcode; the listing goes to ``out_path``."""
    import collections

    from distriflow_tpu_torch.ops import build

    with open(os.path.join(CSRC, "depthwise_gn.cu")) as f:
        so, _ = (build_fn or _build)({"sass": f.read()}, work)["sass"]
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", so], capture_output=True, text=True, check=True).stdout
    body, keep = [], False
    for line in text.splitlines():
        if "Function :" in line:
            keep = namespace in line and instance in line
        elif keep:
            body.append(line)
    with open(out_path, "w") as f:
        f.write("\n".join(body))
    ops = collections.Counter()
    for line in body:
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m:
            ops[m.group(1).split(".")[0]] += 1
    return {"instructions": sum(ops.values()), "by_opcode": dict(ops.most_common())}


def variants(work, all_shapes):
    with open(os.path.join(CSRC, "depthwise_gn.cu")) as f:
        src = f.read()
    srcs = {n: patch(src) if patch else src for n, (patch, _) in VARIANTS.items()}
    built = _build(srcs, work)
    out = {}
    for name, (so, ptxas) in built.items():
        code = ("import json, sys\n"
                f"sys.path.insert(0, {os.path.dirname(os.path.abspath(__file__))!r})\n"
                f"sys.path.insert(0, {ROOT!r})\n"
                "import dwgn_f32_bwd_probe as p\n"
                f"print(json.dumps(p.one_variant({so!r}, {VARIANTS[name][1]!r}, {all_shapes!r})))\n")
        try:
            r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                               timeout=300, cwd=ROOT)
            res = (json.loads(r.stdout.splitlines()[-1]) if r.returncode == 0
                   else {"error": r.stderr[-3000:]})
        except subprocess.TimeoutExpired:
            res = {"error": "timed out"}
        out[name] = {"timing_only": VARIANTS[name][1], "ptxas": ptxas, **res}
        print(json.dumps({name: {"ptxas": ptxas, "error": res.get("error")}}), file=sys.stderr,
              flush=True)
    return out


def in_turns(parent, work, all_shapes):
    """The f32 backward at :data:`SHAPES`, the parent's (its source and its
    plan) and this checkout's, in turns (parent, this, this, parent) three
    times."""
    import chip_smoke as cs
    from distriflow_tpu_torch.ops import depthwise_gn as dg

    pcsrc = os.path.join(parent, "distriflow_tpu_torch", "csrc")
    srcs = {}
    for who, base in (("parent", pcsrc), ("this", CSRC)):
        with open(os.path.join(base, "depthwise_gn.cu")) as f:
            srcs[who] = f.read()
    built = {**_build({"parent": srcs["parent"]}, work, pcsrc),
             **_build({"this": srcs["this"]}, work)}
    spec = importlib.util.spec_from_file_location(
        "parent_depthwise_gn", os.path.join(parent, "distriflow_tpu_torch", "ops", "depthwise_gn.py"))
    pdg = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = pdg  # its dataclasses look their module up
    spec.loader.exec_module(pdg)
    fns = {who: _entry(built[who][0])[0] for who in built}
    flush, out = cs._flush_buffer(), {"ptxas": {who: built[who][1] for who in built}}
    for tag, (h, w, c, s), x, k, sc, bi, g in _cases(all_shapes):
        plans = {"parent": pdg.dwgn_plan(h, w, c, s, True, 4), "this": dg.dwgn_plan(h, w, c, s, True, 4)}
        times = {"parent": [], "this": []}
        for _ in range(3):
            for who in ("parent", "this", "this", "parent"):
                times[who].append(float(cs._timed(
                    lambda: _call(fns[who], plans[who], x, k, sc, bi, g, s), 5, flush)))
        out[tag] = times
        del x, k, g
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="an older checkout whose f32 backward to time in turns")
    ap.add_argument("--all-shapes", action="store_true", help="all 20 shapes of the f32 rows")
    ap.add_argument("--no-variants", action="store_true")
    ap.add_argument("--phases", action="store_true", help="each phase's cycles from a stamped build")
    ap.add_argument("--sass", help="write the kernel's SASS listing to this file and count its opcodes")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("dwgn_f32_bwd_probe: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke as cs

    out = {"card": cs._card()}
    build_dir = os.path.join(CSRC, "build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as work:
        if not a.no_variants:
            out["variants"] = variants(work, a.all_shapes)
            print(json.dumps({"variants": out["variants"]}), flush=True)
        if a.sass:
            out["sass"] = sass(work, a.sass)
            print(json.dumps({"sass": out["sass"]}), flush=True)
        if a.phases:
            out["phases"] = phases(work)
            print(json.dumps({"phases": out["phases"]}), flush=True)
        if a.parent:
            out["in_turns"] = in_turns(a.parent, work, a.all_shapes)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
