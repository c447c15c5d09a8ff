"""Readings behind the design of the head-dim-32 bf16 decode kernel
(``distriflow_tpu_torch/csrc/flash_decode.cu``, namespace ``d32``) on one
CUDA card. Prints one JSON object.

With ``--parent DIR`` (an older checkout whose bf16 D 32 decode is the
split kernel and its combine, e.g. ``git archive`` of PR 31) it first takes
that pair apart at row 2's shape (B4 H4, pages of 128, contexts
968/16381/700/1) and row 3's (B1 S16384, 944 valid), from patched copies of
its source (:func:`breakdown`): both kernels as the wrapper launches them;
the split grid alone; the combine alone, after a finished split grid left
its partials; the split grid with every row of length 0 (every block
dead); an empty kernel (the floor). The launch gap is what the pair takes
beyond the two alone: both - split - combine + floor.

Then it builds this checkout's source as it is and as patched copies, one
change each (:data:`VARIANTS`): 2 or 8 copy groups in a warp's ring
instead of 4, copy groups of 2 or 8 passes instead of 4, 4 lanes a
position (16 bytes a lane; groups of 8 passes, the same bytes), two warps
a split (each half the passes of a tile, the tile max exchanged through
shared memory, the pair's sums added before the slot), and 1-D
TMA copies (``cp.async.bulk`` of a position's 64-byte slice by one lane,
completed on an mbarrier a ring stage) in place of ``cp.async``; and,
timed only (their outputs are not the function's), the kernel without its
combine and the kernel with neither splits nor combine (the launch, the
first reads and the two cluster barriers). For each:
ptxas' registers and spills, the largest error against the plain version
at row 2's shape and on the edges (pages 1, 16, 100, 128 and 256, and the
slab), the same bits on a second launch, the clusters the card holds at
once at 64 splits (C 8 and 16: ``cudaOccupancyMaxActiveClusters``) and the
median ms at four shapes (:data:`SHAPES`). The kernel as built is also
timed at every cluster size from 1 to 16 (``by_cluster``). One max a split
(p rounded against the split's max, not the running tile max) is read on
the plain side: the share of elements its output puts outside the limit of
the plain version. With ``--parent`` it also times the parent's D 32 decode
against this one's at the four shapes in turns (parent, this, this,
parent; three times).

Run from the repository's root: ``python3 tools/decode_d32_probe.py
[--parent DIR]`` (about three minutes of command on an H100).
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
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "distriflow_tpu_torch", "csrc")

import d32_bwd_probe as bwd  # noqa: E402  (its nvcc runs)

H, D = 4, 32
#: label: (B, H, page size or None for the slab, contexts, table width or
#: slab positions): rows 2 and 3 at D 32, the speculative 1k leg's engine
#: (4 slots near 1k over a 16k table) and the CLI's --serve (B4 H8, a
#: 512-position table, one live split a row)
SHAPES = {"row2": (4, H, 128, [968, 16381, 700, 1], 128),
          "row3": (1, H, None, [944], 16384),
          "spec_1k": (4, H, 128, [968, 990, 1010, 1024], 128),
          "cli_serve": (4, 8, 128, [40, 64, 80, 96], 4)}
#: contexts of the edge checks: split starts and ends, a row of length 0
EDGE_PAGES = (1, 16, 100, 128, 256)


def _sub(src, old, new):
    assert src.count(old) == 1, old[:80]
    return src.replace(old, new)


def _const(name, value):
    def patch(src):
        return _sub(src, *(f"constexpr int {name} = {v};" for v in (
            {"kStages": 4, "kGroup": 4, "kLanes": 2}[name], value)))
    return patch


def lanes4(src):
    return _const("kGroup", 8)(_const("kLanes", 4)(src))


_BULK_ISSUE_OLD = '''    if (tile < n_local) {
      const int64_t row = static_cast<int64_t>(a.H) * D * 2;
      const auto* src = static_cast<const unsigned char*>(kind ? a.v : a.k) + base * row +
                        h * D * 2 + (lane % kLanes) * kDims * 2;
      unsigned char* dst = ring + (stage % kStages) * kGroupBytes + lane * kDims * 2;
      const int live_t = live(tile);
#pragma unroll
      for (int rr = 0; rr < kGroup; ++rr) {
        const int p = (g * kGroup + rr) * kPass + lane / kLanes;
        if (p < live_t) {
#pragma unroll
          for (int c = 0; c < kChunks; ++c)
            cp_async16(dst + rr * kItemBytes + 16 * c, src + p * row + 16 * c);
        }
      }
'''
_BULK_ISSUE_NEW = '''    uint64_t* bar = &s_bar[threadIdx.x >> 5][stage % kStages];
    __syncwarp();  // every lane is done with the stage's previous group
    if (tile < n_local) {
      const int64_t row = static_cast<int64_t>(a.H) * D * 2;
      const auto* src = static_cast<const unsigned char*>(kind ? a.v : a.k) + base * row + h * D * 2;
      unsigned char* dst = ring + (stage % kStages) * kGroupBytes;
      const int first = g * kGroup * kPass;
      const int n = min(live(tile) - first, kGroup * kPass);
      if (lane == 0) dftt::hopper::mbar_arrive_expect_tx(bar, n * D * 2);
      __syncwarp();
      for (int p = lane; p < n; p += 32)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\\n"
            ::"r"(smem_addr(dst + p * D * 2)), "l"(src + (first + p) * row), "r"(D * 2),
            "r"(smem_addr(bar))
            : "memory");
'''


def bulk(src):
    """1-D TMA copies, one lane a position, completed on an mbarrier a stage."""
    src = _sub(src, _BULK_ISSUE_OLD, _BULK_ISSUE_NEW)
    src = _sub(src, '''        if (kind == 0) {
          ++tile;
          start_tile();
        }
      }
    }
    asm volatile("cp.async.commit_group;\\n" ::: "memory");''', '''        if (kind == 0) {
          ++tile;
          start_tile();
        }
      }
    } else if (lane == 0) {
      dftt::hopper::mbar_arrive(bar);  // an empty group past the split's end
    }''')
    src = _sub(src, '''  asm volatile("cp.async.wait_group %0;\\n" ::"n"(kStages - 2) : "memory");
  groups.issue''', '''  dftt::hopper::mbar_wait(&s_bar[threadIdx.x >> 5][stage % kStages], (stage / kStages) & 1);
  groups.issue''')
    src = _sub(src, "struct Groups {", "__shared__ uint64_t s_bar[kWarps][kStages];\n\nstruct Groups {")
    return _sub(src, '''  int stage = 0;
  for (int j = warp;''', '''  if (lane == 0) {
    for (int i = 0; i < kStages; ++i) dftt::hopper::mbar_init(&s_bar[warp][i], 1);
    dftt::hopper::fence_barrier_init();
  }
  __syncwarp();
  int stage = 0;
  for (int j = warp;''')


def no_combine(src):
    """Timing only: every split, both cluster barriers, no combine."""
    return _sub(src, "  if (rank == 0) combine(a, slots, reinterpret_cast<float*>(rings), cluster, n_live, bh);\n",
                "")


def launch_only(src):
    """Timing only: the launch, the reads of q, the length and the first
    page, and both cluster barriers; no split, no combine."""
    return _sub(no_combine(src), "  for (int j = warp; rank + cluster * j < n_live; j += kWarps)",
                "  for (int j = warp; false && rank + cluster * j < n_live; j += kWarps)")


def pairs(src):
    """Two warps a split: warp 2p + h runs the copy groups g % 2 == h of
    each tile (half its passes), the two exchange the tile max through
    shared memory behind a named barrier of the pair, and warp 2p adds its
    partner's l and acc to its own (in that order) before the slot."""
    src = _sub(src, "  int tile = 0, kind = 0, g = 0, ng = 0;  // the next group to copy\n",
               "  int tile = 0, kind = 0, g = 0, ng = 0;  // the next group to copy\n  int half = 0;\n")
    src = _sub(src, """                                    int valid_, int64_t first)
      : a(a_), b(b_), h(h_), t0(t0_), n_local(n_local_), valid(valid_), next_base(first) {
    start_tile();
  }""", """                                    int valid_, int64_t first, int half_)
      : a(a_), b(b_), h(h_), t0(t0_), n_local(n_local_), valid(valid_), next_base(first) {
    half = half_;
    g = half_;
    start_tile();
    settle();
  }

  __device__ __forceinline__ void settle() {
    while (tile < n_local && g >= ng) {
      g = half;
      kind ^= 1;
      if (kind == 0) {
        ++tile;
        start_tile();
      }
    }
  }""")
    src = _sub(src, """      if (++g == ng) {
        g = 0;
        kind ^= 1;
        if (kind == 0) {
          ++tile;
          start_tile();
        }
      }
    }
    asm volatile("cp.async.commit_group;\\n" ::: "memory");""".replace("\\\\n", "\\n"), """      g += 2;
      settle();
    }
    asm volatile("cp.async.commit_group;\\n" ::: "memory");""".replace("\\\\n", "\\n"))
    src = _sub(src, """                                         int valid, int lane, int stage, int64_t first) {""",
               """                                         int valid, int lane, int stage, int64_t first,
                                         int half, float (*tm)[2], float* sp, int pair, int& tcount) {""")
    src = _sub(src, "  Groups groups(a, b, h, t0, n_local, valid, first);",
               "  Groups groups(a, b, h, t0, n_local, valid, first, half);")
    src = src.replace("""      if (gk >= ng) break;
      const unsigned char* src = next_group(groups, ring, stage++, lane);""", """      if (gk >= ng) break;
      if ((gk & 1) != half) continue;
      const unsigned char* src = next_group(groups, ring, stage++, lane);""")
    src = _sub(src, """    const float m_new = fmaxf(m, group_max(mx));""", """    float tmax = group_max(mx);
    if (lane == 0) tm[tcount & 1][half] = tmax;
    asm volatile("bar.sync %0, 64;\\n" ::"r"(1 + pair) : "memory");
    tmax = fmaxf(tm[tcount & 1][0], tm[tcount & 1][1]);
    ++tcount;
    const float m_new = fmaxf(m, tmax);""".replace("\\\\n", "\\n"))
    src = _sub(src, """  if (grp == 0) {
#pragma unroll
    for (int e = 0; e < kDims; ++e) slot[2 + (lane % kLanes) * kDims + e] = acc[e];
    if (lane == 0) {
      slot[0] = m;
      slot[1] = l;
    }
  }""", """  if (half == 1 && grp == 0) {
#pragma unroll
    for (int e = 0; e < kDims; ++e) sp[2 + (lane % kLanes) * kDims + e] = acc[e];
    if (lane == 0) sp[1] = l;
  }
  asm volatile("bar.sync %0, 64;\\n" ::"r"(1 + pair) : "memory");
  if (half == 0 && grp == 0) {
#pragma unroll
    for (int e = 0; e < kDims; ++e)
      slot[2 + (lane % kLanes) * kDims + e] = __fadd_rn(acc[e], sp[2 + (lane % kLanes) * kDims + e]);
    if (lane == 0) {
      slot[0] = m;
      slot[1] = __fadd_rn(l, sp[1]);
    }
  }""".replace("\\\\n", "\\n"))
    src = _sub(src, "  const int t_first = (rank + cluster * warp) * a.split_tiles;",
               "  const int t_first = (rank + cluster * (warp >> 1)) * a.split_tiles;")
    return _sub(src, """  int stage = 0;
  for (int j = warp; rank + cluster * j < n_live; j += kWarps)
    stage = run_split(a, ring, slots + j * kSlotFloats, qv, b, h, rank + cluster * j, tiles, valid,
                      lane, stage,
                      j == warp ? first : first_position(a, b, (rank + cluster * j) * a.split_tiles));""",
                """  __shared__ float s_tmax[kWarps / 2][2][2];
  __shared__ float s_part[kWarps / 2][kSlotFloats];
  int tcount = 0;
  int stage = 0;
  for (int j = warp >> 1; rank + cluster * j < n_live; j += kWarps / 2)
    stage = run_split(a, ring, slots + j * kSlotFloats, qv, b, h, rank + cluster * j, tiles, valid,
                      lane, stage,
                      j == (warp >> 1) ? first : first_position(a, b, (rank + cluster * j) * a.split_tiles),
                      warp & 1, s_tmax[warp >> 1], s_part[warp >> 1], warp >> 1, tcount);""")


VARIANTS = {"as_built": lambda s: s, "stages2": _const("kStages", 2), "stages8": _const("kStages", 8),
            "group2": _const("kGroup", 2), "group8": _const("kGroup", 8), "lanes4": lanes4,
            "bulk": bulk, "pairs": pairs, "no_combine": no_combine, "launch_only": launch_only}
#: variants whose output is not the function's: timed only
TIMING_ONLY = ("no_combine", "launch_only")


def _bind(so):
    from distriflow_tpu_torch.ops import flash_decode as fd

    lib = ctypes.CDLL(so)
    for fn, argtypes in fd._SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def _geometry(q, k, table):
    """(tile, n_tiles, S, n_pages) as the wrappers pass them."""
    from distriflow_tpu_torch.ops import flash_decode as fd

    if table is None:
        s = k.shape[1]
        return fd.SLAB_TILE, -(-s // fd.SLAB_TILE), s, 0
    return k.shape[1], table.shape[1], table.shape[1] * k.shape[1], k.shape[0]


def _new_call(lib, cluster_max=None):
    """The D 32 kernel of ``lib`` through ``dftt_flash_decode_d32``, its
    cluster by ``d32_cluster`` (under ``cluster_max`` where given)."""
    import torch

    from distriflow_tpu_torch.ops import flash_decode as fd

    def call(q, k, v, table, lens):
        b, h, d = q.shape
        tile, n_tiles, s, n_pages = _geometry(q, k, table)
        per = fd.split_tiles(tile)
        n_splits = -(-n_tiles // per)
        c = fd.d32_cluster(n_splits) if cluster_max is None else min(fd.d32_cluster(n_splits), cluster_max)
        out = torch.empty_like(q)
        rc = lib.dftt_flash_decode_d32(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                       None if table is None else table.data_ptr(), lens.data_ptr(),
                                       out.data_ptr(), b, h, tile, n_tiles, s, n_pages, per, n_splits, c,
                                       0, 1.0 / math.sqrt(d), torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return out

    return call


def _old_call(lib, partial=None):
    """An older checkout's bf16 decode at D 32 (the split kernel and its
    combine) through ``dftt_flash_decode_bf16``; ``partial``: the scratch to
    use (else a fresh one)."""
    import torch

    from distriflow_tpu_torch.ops import flash_decode as fd

    def call(q, k, v, table, lens):
        b, h, d = q.shape
        tile, n_tiles, s, n_pages = _geometry(q, k, table)
        per = fd.split_tiles(tile)
        n_splits = -(-n_tiles // per)
        part = partial if partial is not None else torch.empty(
            (b, h, n_splits, d + 2), dtype=torch.float32, device=q.device)
        out = torch.empty_like(q)
        rc = lib.dftt_flash_decode_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                        None if table is None else table.data_ptr(), lens.data_ptr(),
                                        part.data_ptr(), out.data_ptr(), b, h, d, tile, n_tiles, s, n_pages,
                                        per, n_splits, 0, 1.0 / math.sqrt(d),
                                        torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return out

    return call


def _inputs(g, label):
    """(q, k, v, table or None, lens) of :data:`SHAPES` ``label``."""
    import torch

    import chip_smoke as cs

    b, h, ps, lens_l, width = SHAPES[label]

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(torch.bfloat16)

    q = randn(b, h, D)
    if ps is None:
        k, v = randn(b, width, h * D), randn(b, width, h * D)
        return q, k, v, None, torch.tensor(lens_l, dtype=torch.int32, device="cuda")
    n_pages = sum(-(-n // ps) for n in lens_l) + 4
    table, lens = cs._paged_rows(g, lens_l, ps, n_pages, width)
    return q, randn(n_pages, ps, h * D), randn(n_pages, ps, h * D), table, lens


def _edges(call, g):
    """Largest error against the plain versions over the edge contexts,
    paged at :data:`EDGE_PAGES` and on the slab; a row of length 0 must
    give exactly 0."""
    import torch

    import chip_smoke as cs
    from distriflow_tpu_torch.ops import flash_decode as fd

    worst = 0.0
    for ps in EDGE_PAGES + (None,):
        split = fd.split_tiles(ps or fd.SLAB_TILE) * (ps or fd.SLAB_TILE)
        lens_l = [1, split, split + 1, 0, 3 * split + 5, 700]
        b, tile = len(lens_l), ps or fd.SLAB_TILE
        pp = -(-max(lens_l) // tile) + 2
        q = torch.randn(b, H, D, generator=g, device="cuda").to(torch.bfloat16)
        if ps is None:
            k, v = (torch.randn(b, pp * tile, H * D, generator=g, device="cuda").to(torch.bfloat16)
                    for _ in range(2))
            table, lens = None, torch.tensor(lens_l, dtype=torch.int32, device="cuda")
            want = fd.flash_decode_reference(q, k, v, lens)
        else:
            n_pages = sum(-(-n // ps) for n in lens_l) + 2
            table, lens = cs._paged_rows(g, lens_l, ps, n_pages, pp)
            k, v = (torch.randn(n_pages, ps, H * D, generator=g, device="cuda").to(torch.bfloat16)
                    for _ in range(2))
            want = fd.flash_decode_paged_reference(q, k, v, table, lens)
        out = call(q, k, v, table, lens)
        assert not out[3].any(), "a row of length 0 did not give 0"
        worst = max(worst, cs._over(f"edges page {ps}", out, want, *cs.TOL["flash_decode_paged"]))
    return worst


def one_variant(so):
    """The readings of one built variant (run in a process of its own)."""
    import torch

    import chip_smoke as cs
    from distriflow_tpu_torch.ops import flash_decode as fd

    lib = _bind(so)
    call = _new_call(lib)
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 60)
    res = {"clusters_at_64_splits": {c: lib.dftt_flash_decode_d32_clusters(64, c) for c in (8, 16)}}
    if os.path.basename(os.path.dirname(so)) not in TIMING_ONLY:
        q, k, v, table, lens = _inputs(g, "row2")
        out = call(q, k, v, table, lens)
        res.update({"row2_err": cs._over("row2", out, fd.flash_decode_paged_reference(q, k, v, table, lens),
                                         *cs.TOL["flash_decode_paged"]),
                    "same_bits": bool(torch.equal(call(q, k, v, table, lens), out)),
                    "edges_err": _edges(call, g)})
    flush = cs._flush_buffer()
    res["ms"] = {}
    for label in SHAPES:
        args = _inputs(g, label)
        res["ms"][label] = float(cs._timed(lambda: call(*args), 100, flush))
    if os.path.basename(os.path.dirname(so)) == "as_built":
        args = _inputs(g, "row2")
        res["by_cluster"] = {}
        for c in (1, 2, 4, 8, 16):
            fn = _new_call(lib, c)
            res["by_cluster"][c] = {"same_bits": bool(torch.equal(fn(*args), call(*args))),
                                    "ms": float(cs._timed(lambda: fn(*args), 100, flush))}
    return res


def _split_max_partials(q, k, v, table, lens):
    """The split pass with one max a split: every score of the split first,
    then p = exp(s - m_split) rounded to bf16 (the plain version's other
    choice of rounding point); ``(m, l, acc, live)`` as ``split_partials``."""
    import torch

    from distriflow_tpu_torch.ops import flash_decode as fd

    tiles = list(fd._paged_tiles(q, k, v, None, None, table) if table is not None
                 else fd._slab_tiles(q, k, v, None, None))
    tile = k.shape[1] if table is not None else fd.SLAB_TILE
    per = fd.split_tiles(tile)
    qf = q.float()
    parts = []
    for j0 in range(0, len(tiles), per):
        kt = torch.cat([t[0] for t in tiles[j0:j0 + per]], 1).float()
        vt = torch.cat([t[1] for t in tiles[j0:j0 + per]], 1).float()
        s = torch.einsum("bhd,bphd->bhp", qf, kt) / math.sqrt(q.shape[-1])
        pos = j0 * tile + torch.arange(kt.shape[1], device=q.device)
        s = torch.where(pos[None, None, :] < lens[:, None, None], s, torch.full_like(s, fd.NEG_INF))
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        acc = torch.einsum("bhp,bphd->bhd", p.to(torch.bfloat16).float(), vt)
        parts.append((m, p.sum(-1), acc, j0 * tile < lens))
    return parts


def split_max_readings():
    """The share of elements that one max a split puts outside the limit
    of the plain version (one max a tile), at rows 2 and 3's shapes."""
    import torch

    import chip_smoke as cs
    from distriflow_tpu_torch.ops import flash_decode as fd

    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 61)
    out = {}
    for label in ("row2", "row3"):
        q, k, v, table, lens = _inputs(g, label)
        want = (fd.flash_decode_paged_reference(q, k, v, table, lens) if table is not None
                else fd.flash_decode_reference(q, k, v, lens))
        got = fd.combine_partials(_split_max_partials(q, k, v, table, lens)).to(q.dtype)
        out[label] = {"share_outside": cs._rejected("flash_decode_paged", got, want),
                      "max_abs_diff": float((got.float() - want.float()).abs().max())}
    return out


def breakdown(parent, work):
    """The parent's split kernel and combine at rows 2 and 3's shapes, by
    part (see the module docstring)."""
    import torch

    import chip_smoke as cs

    with open(os.path.join(parent, "distriflow_tpu_torch", "csrc", "flash_decode.cu")) as f:
        src = f.read()
    srcs = {"both": src,
            "split_only": _sub(src, "  err = cudaLaunchKernelEx(&cfg, combine_kernel<D, Out>, a);",
                               "  err = cudaSuccess;"),
            "combine_only": _sub(src, "  split_kernel<D, C><<<dim3(a.n_splits, a.H, B), kThreads, smem, st>>>(a);",
                                 "")}
    pcsrc = os.path.join(parent, "distriflow_tpu_torch", "csrc")
    libs = {k: _bind(so) for k, so in bwd._build({f"parent_{k}": s for k, s in srcs.items()}, work,
                                                 {f"parent_{k}": pcsrc for k in srcs}).items()}
    libs = {k[len("parent_"):]: lib for k, lib in libs.items()}
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 62)
    flush = cs._flush_buffer()
    out = {"floor": float(cs._launch_floor())}
    for label in ("row2", "row3"):
        q, k, v, table, lens = _inputs(g, label)
        tile, n_tiles, _, _ = _geometry(q, k, table)
        from distriflow_tpu_torch.ops import flash_decode as fd

        n_splits = -(-n_tiles // fd.split_tiles(tile))
        part = torch.empty((q.shape[0], q.shape[1], n_splits, D + 2), dtype=torch.float32, device="cuda")
        both = _old_call(libs["both"], part)
        want = both(q, k, v, table, lens)
        combine = _old_call(libs["combine_only"], part)
        assert torch.equal(combine(q, k, v, table, lens), want), "the combine alone gave other bits"
        zero = torch.zeros_like(lens)
        r = {"both": float(cs._timed(lambda: both(q, k, v, table, lens), 200, flush)),
             "split_only": float(cs._timed(lambda: _old_call(libs["split_only"], part)(q, k, v, table, lens),
                                           200, flush)),
             "combine_only": float(cs._timed(lambda: combine(q, k, v, table, lens), 200, flush)),
             "split_only_every_row_dead": float(cs._timed(
                 lambda: _old_call(libs["split_only"], part)(q, k, v, table, zero), 200, flush)),
             "blocks": [n_splits, q.shape[1], q.shape[0]]}
        r["launch_gap"] = r["both"] - r["split_only"] - r["combine_only"] + out["floor"]
        out[label] = r
    return out


def in_turns(parent, work):
    """The parent's D 32 decode against this one's at :data:`SHAPES`, in
    turns (parent, this, this, parent) three times."""
    import torch

    import chip_smoke as cs

    pcsrc = os.path.join(parent, "distriflow_tpu_torch", "csrc")
    srcs = {}
    for who, base in (("parent", pcsrc), ("this", CSRC)):
        with open(os.path.join(base, "flash_decode.cu")) as f:
            srcs[f"turns_{who}"] = f.read()
    sos = bwd._build(srcs, work, {"turns_parent": pcsrc, "turns_this": CSRC})
    calls = {"parent": _old_call(_bind(sos["turns_parent"])), "this": _new_call(_bind(sos["turns_this"]))}
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 63)
    inputs = {label: _inputs(g, label) for label in SHAPES}
    flush = cs._flush_buffer()
    out = {}
    for who in ("parent", "this", "this", "parent") * 3:
        for label, args in inputs.items():
            out.setdefault(label, {}).setdefault(who, []).append(
                float(cs._timed(lambda: calls[who](*args), 100, flush)))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="an older checkout: its D 32 decode taken apart and timed in turns")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one_variant(args.one)))
        return
    import torch

    from distriflow_tpu_torch.ops import build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    report = {"card": card, "torch": torch.__version__}
    with open(os.path.join(CSRC, "flash_decode.cu")) as f:
        src = f.read()
    with tempfile.TemporaryDirectory() as work:
        if args.parent:
            report["parent_breakdown_ms"] = breakdown(os.path.abspath(args.parent), work)
        procs = {}
        for name, fn in VARIANTS.items():
            d = os.path.join(work, name)
            os.makedirs(d)
            with open(os.path.join(d, "k.cu"), "w") as f:
                f.write(fn(src))
            procs[name] = subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-I", CSRC, "-o", os.path.join(d, "k.so"),
                 os.path.join(d, "k.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        report["variants"] = {}
        for name, p in procs.items():
            log, _ = p.communicate()
            if p.returncode:
                report["variants"][name] = {"error": log[-3000:]}
                continue
            lines = log.splitlines()
            at = next((i for i, x in enumerate(lines) if "Compiling entry" in x and "decode_kernel" in x
                       and "split_kernel" not in x), None)
            entry = {"ptxas": [x.strip() for x in lines[at:at + 4]] if at is not None else None}
            try:
                r = subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                                    os.path.join(work, name, "k.so")],
                                   capture_output=True, text=True, timeout=240, cwd=ROOT)
                entry.update(json.loads(r.stdout.splitlines()[-1]) if r.returncode == 0
                             else {"error": r.stderr[-3000:]})
            except subprocess.TimeoutExpired:
                entry["error"] = "timed out (a hang)"
            report["variants"][name] = entry
        report["split_max"] = split_max_readings()
        if args.parent:
            report["in_turns_ms"] = in_turns(os.path.abspath(args.parent), work)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
