"""Readings behind the f32 depthwise forward's design
(``distriflow_tpu_torch/csrc/depthwise_gn.cu``: ``f32fwd::fwd_kernel``,
kernel 11 in f32) on one CUDA card. Prints one JSON object.

- ``variants``: the source as it is and patched copies (:data:`VARIANTS`):
  a fresh 3 x 3 window loaded for every output (9 loads, where the source
  slides its window down a column and loads 3 S), two and three CTAs an
  SM asked of its ``__launch_bounds__`` (the source asks four), the
  statistics' mean and E[x^2] as the f64 sums times a reciprocal of n
  (``__drcp_rn``) where the source divides, a kept tile's y stored by
  each thread where the source sends it with one TMA store, and each
  unit's place from a division of its number where the source steps it. Each is built with the port's
  ``nvcc`` flags and run in a process of its own with a time limit:
  ptxas' registers and spills of the kernel (one instance a channel
  chunk); then at each shape of :data:`SHAPES` (B 256, the inputs
  ``chip_smoke.py``'s f32 rows draw) every resident plan of the f32
  forward within the card's shared memory, the conv output kept or not
  (``ops/depthwise_gn.py::_f32_fwd_plans``), and the streamed plans where
  the shape's own plan streams (else one, to hold that path): the CTAs an
  SM holds (the runtime's occupancy calculator), the median ms, the plan's
  estimated cost (``f32_fwd_cost``) and whether y equals the plain
  version's bit for bit and gives the same bits on a second launch.
  ``plan`` names the one ``dwgn_plan`` picks.
- ``--phases``: a build whose thread 0 of every CTA stamps ``clock64()``
  between the kernel's phases (:data:`PHASES`): each phase's median
  cycles over the CTAs of one launch at :data:`SHAPES` under their plans.
- ``--sass FILE``: the kernel's SASS (``cuobjdump -sass``, the instance
  for chunks of 32) into FILE, and its instructions by opcode.
- ``--parent DIR`` (an older checkout): its f32 forward (its source and
  its plan) and this one's at :data:`SHAPES` in turns (parent, this, this,
  parent, three times).
- ``--all-shapes``: all 20 shapes of the f32 rows (96 px at B 256, 224 px
  at B 64) instead of :data:`SHAPES`; ``--no-variants`` leaves the
  variants out; ``--only NAME,...`` builds only those variants.

Run from the repository's root: ``python3 tools/dwgn_f32_fwd_probe.py
[--all-shapes] [--no-variants] [--only NAMES] [--phases] [--sass FILE]
[--parent DIR]``.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "distriflow_tpu_torch", "csrc")

import dwgn_f32_bwd_probe as bwd_probe  # noqa: E402  (its build, stamps and SASS helpers)

#: four shapes at 96 px (h, w, c, stride): the two that lose the most time to their
#: bound, the smallest, and the largest-bytes one
SHAPES = ((24, 24, 144, 1), (6, 6, 384, 1), (3, 3, 960, 1), (48, 48, 96, 2))
SHIFT = "    for (int k = 0; k < 9 - 3 * S; ++k) v[k] = v[k + 3 * S];"
DIVIDE = "__ddiv_rn(s, n)), m2 = __double2float_rn(__ddiv_rn(ss, n));"


def _blocks(n):
    def patch(src):
        head, body = src.split("namespace f32fwd {")
        assert body.count("constexpr int kBlocks = 4;") == 1
        return head + "namespace f32fwd {" + body.replace("constexpr int kBlocks = 4;",
                                                          f"constexpr int kBlocks = {n};")
    return patch


def _fresh_window(src):
    """Every output loads its whole 3 x 3 window (the rows it shares with
    the previous output too)."""
    assert src.count(SHIFT) == 1
    return src.replace(SHIFT, "    for (int k = 0; k < 9 - 3 * S; ++k) "
                              "v[k] = at[(k / 3 - (3 - S)) * row + (k % 3) * CC];")


KEPT_Y = """        float* cell = l.gs + (oy * p.cols + x) * CC;
        *cell = y_of(*cell);"""
TMA_STORE = "    if (threadIdx.x == 0) tma_store_nhwc(&tm_y, sm.g, chunk * CC, t.c0, t.r0, blockIdx.z * p.nb);"


def _thread_stores(src):
    """A kept tile's y leaves by each thread's own stores (as the plans
    that compute the conv again store it) instead of one TMA store."""
    assert src.count(KEPT_Y) == 1 and src.count(TMA_STORE) == 1
    src = src.replace(TMA_STORE, "")
    return src.replace(KEPT_Y, """        if (l.live)
          out[((static_cast<int64_t>(l.b) * p.OH + t.r0 + oy) * p.OW + t.c0 + x) * p.C + l.ch] =
              y_of(l.gs[(oy * p.cols + x) * CC]);""")


UNIT_STEP = """  const int blocks = (t.rr + p.strip - 1) / p.strip, dj = l.nsl / t.cw, dx = l.nsl - dj * t.cw;
  for (int j = l.slice / t.cw, x = l.slice - j * t.cw; j < blocks;) {
    const int y0 = j * p.strip;
    f(y0, min(y0 + p.strip, t.rr), x);
    x += dx;
    j += dj;
    if (x >= t.cw) {
      x -= t.cw;
      ++j;
    }
  }"""


def _unit_division(src):
    """Each unit's (row block, column) from a division of its number."""
    assert src.count(UNIT_STEP) == 1
    return src.replace(UNIT_STEP, """  const int units = (t.rr + p.strip - 1) / p.strip * t.cw;
  for (int u = l.slice; u < units; u += l.nsl) {
    const int j = u / t.cw, x = u - j * t.cw, y0 = j * p.strip;
    f(y0, min(y0 + p.strip, t.rr), x);
  }""")


def _reciprocal(src):
    """mean and E[x^2] as the f64 sums times __drcp_rn(n) (every kernel's
    statistics in this build; only the f32 forward is timed)."""
    assert src.count(DIVIDE) == 1
    return src.replace(DIVIDE, "__dmul_rn(s, __drcp_rn(n))), "
                               "m2 = __double2float_rn(__dmul_rn(ss, __drcp_rn(n)));")


#: each variant's patch of the source
VARIANTS = {"source": None, "fresh_window": _fresh_window, "blocks2": _blocks(2),
            "blocks3": _blocks(3), "reciprocal": _reciprocal, "thread_stores": _thread_stores,
            "unit_division": _unit_division}


def _ptxas(log):
    lines, keep = [], False
    for line in log.splitlines():
        if "Compiling entry" in line:
            keep = "f32fwd" in line or "dwgn_fwd_kernelINS_3F32" in line
        elif keep and ("registers" in line or "spill" in line):
            lines.append(line.strip())
    return lines


def _build(srcs, work, csrc=CSRC):
    """One shared library a variant, all nvcc runs at once (the backward
    probe's build); returns {name: (path, ptxas lines of the f32 forward)}."""
    return bwd_probe._build(srcs, work, csrc, log_filter=_ptxas)


def _entry(so, signatures):
    """The library's f32 forward C entry and its occupancy entry (None
    where the source has none)."""
    lib = ctypes.CDLL(so)
    fn = lib.dftt_dwgn_fwd_f32
    fn.argtypes, fn.restype = signatures["dftt_dwgn_fwd_f32"], ctypes.c_int
    ctas = getattr(lib, "dftt_dwgn_fwd_f32_ctas_per_sm", None)
    if ctas is not None:
        ctas.argtypes, ctas.restype = [ctypes.c_int] * 2, ctypes.c_int
    return fn, ctas


def _call(fn, plan_ints, x, k, sc, bi, s):
    """y of the f32 forward through ``fn`` under the plan's ints."""
    import torch

    from distriflow_tpu_torch.ops import depthwise_gn as dg

    b, h, wd, c = x.shape
    _, _, oh, ow = dg._geometry(h, wd, s)
    out = torch.empty(b, oh, ow, c, device=x.device)
    rc = fn(x.data_ptr(), k.data_ptr(), sc.data_ptr(), bi.data_ptr(), out.data_ptr(), b, h, wd, c,
            s, 1e-6, 1, *plan_ints, torch.cuda.current_stream().cuda_stream)
    assert rc == 0, f"launch failed with CUDA error {rc}"
    return out


def _plan_key(plan):
    return [plan.cc, plan.rows, plan.cols, plan.cluster, plan.tiles_per_cta, plan.images,
            plan.strip, int(plan.keep), plan.smem]


def _cases(all_shapes):
    """``(tag, shape, x, k, scale, bias)`` as the f32 rows draw them."""
    import torch

    import chip_smoke as cs

    for px, batch, size in ((96, cs.MN_B, cs.MN), (224, cs.MN224_B, cs.MN224)):
        shapes = cs._depthwise_shapes(size["image_size"], size["width"])
        for key, x, k, sc, bi, _ in cs._dwgn_cases(shapes, batch, torch.float32, cs.SEED + 8):
            if all_shapes or (px == 96 and key in SHAPES):
                yield f"{px}px {key[0]}x{key[1]}x{key[2]} s{key[3]}", key, x, k, sc, bi


def _candidates(h, w, c, s):
    """Every plan the probe times at one shape: the resident plans within
    the card's shared memory, and the streamed plans where the chosen one
    streams (else one streamed plan, to hold that path)."""
    from distriflow_tpu_torch.ops import depthwise_gn as dg

    chosen = dg.dwgn_plan(h, w, c, s, False, 4)
    plans = dg._f32_fwd_plans(h, w, c, s, dg.SMEM_LIMIT)
    if chosen.tiles_per_cta > 1:
        plans += dg._f32_fwd_plans(h, w, c, s, dg.SMEM_TARGET[(False, 4)], streamed=True)
    else:
        plans.append(dg.make_plan(h, w, c, s, False, chosen.cc, -(-chosen.rows // 2),
                                  chosen.cols, cluster=1, itemsize=4))
    if chosen not in plans:
        plans.append(chosen)
    return chosen, plans


def one_variant(so, all_shapes):
    """The readings of one built variant (run in a process of its own)."""
    import torch

    import chip_smoke as cs
    from distriflow_tpu_torch.ops import depthwise_gn as dg

    fn, ctas = _entry(so, dg._SIGNATURES)
    flush, out = cs._flush_buffer(), {}
    for tag, (h, w, c, s), x, k, sc, bi in _cases(all_shapes):
        want = dg.depthwise3x3_groupnorm_reference(x, k, sc, bi, s)
        chosen, plans = _candidates(h, w, c, s)
        rows = []
        for plan in plans:
            ints = dg._plan_ints(plan)
            r = {"plan": _plan_key(plan), "cost": dg.f32_fwd_cost(plan),
                 "ctas_per_sm": ctas(plan.cc, plan.smem)}
            got = _call(fn, ints, x, k, sc, bi, s)
            r["differ_share"] = float((got != want).float().mean())
            r["same_bits"] = bool(torch.equal(got, _call(fn, ints, x, k, sc, bi, s)))
            del got
            r["ms"] = float(cs._timed(lambda: _call(fn, ints, x, k, sc, bi, s), 5, flush))
            rows.append(r)
        rows.sort(key=lambda r: r["ms"])
        out[tag] = {"plan": _plan_key(chosen), "plan_rank": [r["plan"] for r in rows].index(
            _plan_key(chosen)), "plans": rows}
        del x, k, want
        torch.cuda.empty_cache()
    return out


#: the phase stamps' places in the kernel: (anchor, before or after it)
STAMPS = (("  const Smem<F32> sm = carve<F32>(p);\n", False),
          ("  // pass 1: the statistics (and the kept conv output)\n", True),
          ("    v[0] = f32bwd::group_sum(v[0]);", True),
          ("    stats_from_slots(p, sm, eps);\n  }\n", False),
          ("  if (p.cluster > 1) cluster_sync();  // no CTA leaves while another", True))
#: the phases between the stamps
PHASES = ("x_wait", "pass1_loop", "pass1_sums", "pass2")


def phases(work):
    """Each phase's median cycles (thread 0 of every CTA, one launch) at
    :data:`SHAPES` under the chosen plans, from a stamped build."""
    import numpy as np
    import torch

    from distriflow_tpu_torch.ops import depthwise_gn as dg

    with open(os.path.join(CSRC, "depthwise_gn.cu")) as f:
        src = f.read()
    stamped = bwd_probe._stamped(src, "f32fwd", STAMPS)
    so, _ = _build({"stamped": stamped}, work)["stamped"]
    fn, _ = _entry(so, dg._SIGNATURES)
    read = ctypes.CDLL(so).dftt_read_stamps
    read.argtypes, read.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    out = {}
    for tag, (h, w, c, s), x, k, sc, bi in _cases(False):
        plan = dg.dwgn_plan(h, w, c, s, False, 4)
        n = min(plan.ctas(x.shape[0]), bwd_probe.MAX_STAMP_CTAS)
        _call(fn, dg._plan_ints(plan), x, k, sc, bi, s)
        torch.cuda.synchronize()
        buf = np.zeros(n * len(STAMPS), np.int64)
        assert read(buf.ctypes.data, buf.size) == 0
        st = buf.reshape(n, len(STAMPS)).astype(np.float64)
        d = np.diff(st, axis=1)
        out[tag] = {"ctas": n, "total_cycles_median": float(np.median(st[:, -1] - st[:, 0])),
                    "total_cycles_p90": float(np.percentile(st[:, -1] - st[:, 0], 90)),
                    "phases_median": {ph: float(np.median(d[:, i])) for i, ph in enumerate(PHASES)}}
        del x, k
    return out


def variants(work, all_shapes, only=None):
    with open(os.path.join(CSRC, "depthwise_gn.cu")) as f:
        src = f.read()
    names = [n for n in VARIANTS if only is None or n in only]
    srcs = {n: VARIANTS[n](src) if VARIANTS[n] else src for n in names}
    built = _build(srcs, work)
    out = {}
    for name, (so, ptxas) in built.items():
        code = ("import json, sys\n"
                f"sys.path.insert(0, {os.path.dirname(os.path.abspath(__file__))!r})\n"
                f"sys.path.insert(0, {ROOT!r})\n"
                "import dwgn_f32_fwd_probe as p\n"
                f"print(json.dumps(p.one_variant({so!r}, {all_shapes!r})))\n")
        try:
            r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                               timeout=420, cwd=ROOT)
            res = (json.loads(r.stdout.splitlines()[-1]) if r.returncode == 0
                   else {"error": r.stderr[-3000:]})
        except subprocess.TimeoutExpired:
            res = {"error": "timed out"}
        out[name] = {"ptxas": ptxas, **res}
        print(json.dumps({name: {"ptxas": ptxas, "error": res.get("error")}}), file=sys.stderr,
              flush=True)
    return out


def in_turns(parent, work, all_shapes):
    """The f32 forward at :data:`SHAPES`, the parent's (its source, its
    plan and its entry's arguments) and this checkout's, in turns (parent,
    this, this, parent) three times."""
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
    mods = {"parent": pdg, "this": dg}
    fns = {who: _entry(built[who][0], mods[who]._SIGNATURES)[0] for who in built}
    flush, out = cs._flush_buffer(), {"ptxas": {who: built[who][1] for who in built}}
    for tag, (h, w, c, s), x, k, sc, bi in _cases(all_shapes):
        ints = {who: mods[who]._plan_ints(mods[who].dwgn_plan(h, w, c, s, False, 4))
                for who in mods}
        times = {"parent": [], "this": []}
        for _ in range(3):
            for who in ("parent", "this", "this", "parent"):
                times[who].append(float(cs._timed(
                    lambda: _call(fns[who], ints[who], x, k, sc, bi, s), 5, flush)))
        out[tag] = times
        del x, k
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="an older checkout whose f32 forward to time in turns")
    ap.add_argument("--all-shapes", action="store_true", help="all 20 shapes of the f32 rows")
    ap.add_argument("--no-variants", action="store_true")
    ap.add_argument("--only", help="comma-separated variants to build (default: all)")
    ap.add_argument("--phases", action="store_true", help="each phase's cycles from a stamped build")
    ap.add_argument("--sass", help="write the kernel's SASS listing to this file and count its opcodes")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("dwgn_f32_fwd_probe: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke as cs

    out = {"card": cs._card()}
    build_dir = os.path.join(CSRC, "build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as work:
        if not a.no_variants:
            only = set(a.only.split(",")) if a.only else None
            out["variants"] = variants(work, a.all_shapes, only)
            print(json.dumps({"variants": out["variants"]}), flush=True)
        if a.sass:
            out["sass"] = bwd_probe.sass(work, a.sass, "f32fwd", "ILi32E", _build)
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
