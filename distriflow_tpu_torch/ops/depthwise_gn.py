"""Fused depthwise-3x3 + GroupNorm (+ ReLU6): hand-written Hopper kernels
and their plain versions.

Port of ``distriflow_tpu/ops/depthwise_gn.py``. MobileNetV2's depthwise
blocks run ``depthwise3x3(SAME) -> GroupNorm(8) -> affine -> ReLU6`` as one
pass over the activation: the conv output and the group statistics never
reach device memory.

- ``csrc/depthwise_gn.cu`` replaces the Pallas ``_fwd_kernel`` (forward)
  and ``_bwd_kernel`` (the ``jax.vjp`` of the same tile, which recomputes
  the forward) for bf16 and f32 NHWC activations (JAX's kernel takes
  either; f32 is MobileNetV2's default): in bf16 one template each, in f32
  kernels of their own (one channel a thread), a thread-block cluster per
  (batch element, channel chunk) whose CTAs load their tiles once through
  TMA (SAME padding from the copy's zero fill) and exchange the group
  statistics and partial sums through distributed shared memory in rank
  order. :func:`dwgn_plan` cuts the activation for the element size (the
  f32 kernels by their own cost models) and passes the cut to the kernels;
  :func:`banded_forward_reference` and :func:`banded_backward_reference`
  repeat that cut in plain PyTorch.
- Activations are NHWC with channels in groups of 8; the depthwise kernel
  ``w`` is flax's ``[3, 3, 1, C]`` or squeezed ``[3, 3, C]``, in the
  activation dtype; ``scale``/``bias`` are the f32 GroupNorm affine.

The arithmetic is the TPU tile's (``depthwise_gn.py:141-177``): nine
products ``x * w[ky, kx]`` added in (ky, kx) order, each product and sum
rounded to the activation dtype; statistics in f32 as ``E[x]`` and
``E[x^2]``, ``rsqrt(max(E[x^2] - E[x]^2, 0) + eps)``; the affine in f32,
a cast, then ``min(max(y, 0), 6)``. Every sum over positions (the
statistics, their gradients, dscale, dbias, dw) is the f32 of the exact
sum, accumulated in f64, in the kernels and the plain versions alike: the
one-pass variance of a nearly flat group cancels, and f32 sums in two
orders would leave the two percent apart. The backward is that function's exact
derivative as ``jax.vjp`` takes it, including the ties of ReLU6: at
``y == 0`` and ``y == 6`` half the gradient passes (``jnp.maximum`` and
``jnp.minimum`` split a tie), where the unfused ``F.relu6`` passes none.

:func:`depthwise_gn_forward` and :func:`depthwise_gn_backward` launch the
kernels for CUDA tensors (or raise) and run the plain versions for CPU
tensors; each counts its launches, and its f32 ones apart
(``launches_by_dtype``). :func:`depthwise3x3_groupnorm` is the
differentiable entry point; it saves only ``(x, w, scale, bias)`` and
recomputes in the backward, as the JAX ``custom_vjp`` does.
"""

from __future__ import annotations

import ctypes
import functools
import warnings
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from distriflow_tpu_torch.ops import build, flop_count

GROUP_SIZE = 8  # channels are multiples of 8 by construction (_make_divisible)
MIN_CHANNELS = 8  # below one group there is nothing to normalize over
# the JAX gate's TPU scoped-VMEM limit: the port fuses exactly the shapes
# JAX fuses, so a model takes the same branch on both (the CUDA kernels
# themselves take any spatial size)
VMEM_LIMIT_BYTES = 16 * 1024 * 1024

_warned_gated: set = set()  # (h, w, c, stride) shapes already warned about

_FWD_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_int] * 8 \
    + [ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_int] * 8 \
    + [ctypes.c_void_p]
# the f32 forward's plan adds strip and keep (f32fwd)
_FWD_F32_ARGS = _FWD_ARGS[:-2] + [ctypes.c_int] * 2 + _FWD_ARGS[-2:]
_SIGNATURES = {"dftt_dwgn_fwd_bf16": _FWD_ARGS, "dftt_dwgn_fwd_f32": _FWD_F32_ARGS,
               "dftt_dwgn_bwd_bf16": _BWD_ARGS, "dftt_dwgn_bwd_f32": _BWD_ARGS,
               "dftt_dwgn_bwd_f32_ctas_per_sm": [ctypes.c_int] * 2,
               "dftt_dwgn_fwd_f32_ctas_per_sm": [ctypes.c_int] * 2}
#: the kernels' element types, by the suffix of their entry points
KERNEL_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}


def _same_pads(d: int, stride: int) -> Tuple[int, int]:
    """XLA SAME padding for kernel 3: odd dims at stride 2 pad (1, 1),
    even dims (0, 1)."""
    total = max((-(-d // stride) - 1) * stride + 3 - d, 0)
    return (total // 2, total - total // 2)


def _channel_block(c: int) -> int:
    """The JAX kernel's channel tile (only its VMEM estimate reads it)."""
    if c <= 512:
        return c
    for blk in range(512, 0, -128):
        if c % blk == 0:
            return blk
    return c


def _vmem_estimate_bytes(hp, wp, oh, ow, block_c, itemsize):
    est = hp * wp * block_c * itemsize
    est += 2 * oh * ow * block_c * 4
    est += oh * ow * block_c * itemsize
    return int(est * 1.5)


def _geometry(h: int, w: int, stride: int):
    """``(pads_h, pads_w, out_h, out_w)`` of a SAME 3x3 conv."""
    ph, pw = _same_pads(h, stride), _same_pads(w, stride)
    return ph, pw, (h + sum(ph) - 3) // stride + 1, (w + sum(pw) - 3) // stride + 1


def depthwise_gn_supported(h: int, w: int, c: int, stride: int = 1,
                           group_size: int = GROUP_SIZE, itemsize: int = 4) -> bool:
    """True when the fused kernel runs an ``[_, h, w, c]`` activation: the
    JAX predicate, rule for rule. Channels divisible by the group size and
    at least :data:`MIN_CHANNELS`, stride 1 or 2, at least one output
    position, and the JAX kernel's full-spatial tile within its VMEM
    estimate. Gated shapes bump ``ops_depthwise_gn_gated_total`` and warn
    once; callers take the unfused shift + GroupNorm composition."""
    ok = c >= MIN_CHANNELS and c % group_size == 0 and stride in (1, 2) and min(h, w) >= 1
    if ok:
        ph, pw, oh, ow = _geometry(h, w, stride)
        ok = oh >= 1 and ow >= 1 and _vmem_estimate_bytes(
            h + sum(ph), w + sum(pw), oh, ow, _channel_block(c), itemsize) <= VMEM_LIMIT_BYTES
    if ok:
        return True
    from distriflow_tpu_torch.obs.telemetry import get_telemetry

    get_telemetry().counter(
        "ops_depthwise_gn_gated_total",
        help="depthwise+GN shapes gated off the fused kernel").inc()
    key = (h, w, c, stride)
    if key not in _warned_gated:
        _warned_gated.add(key)
        warnings.warn(
            f"depthwise3x3_groupnorm gated off for activation {h}x{w}x{c} "
            f"stride {stride}: channels must be a multiple of {group_size} "
            f"(>= {MIN_CHANNELS}) and the full-spatial channel tile must "
            "fit the reference's VMEM estimate — running the unfused "
            "shift+GroupNorm composition instead.", stacklevel=3)
    return False


# -- the kernels' plan -------------------------------------------------------

THREADS = 256  # a CTA's threads (csrc/depthwise_gn.cu kThreads)
MAX_CLUSTER = 8  # the portable thread-block cluster size
MAX_BOX = 256  # a TMA box's largest extent in each dimension
SMEM_LIMIT = 232_448  # dynamic shared memory a Hopper CTA may use
# a tile's budget by (backward, itemsize): in bf16 three forward CTAs (80
# registers a thread) or two backward CTAs (128) on an SM's 228 KB; in f32
# (csrc f32fwd and f32bwd: one channel a thread) two CTAs of either, with
# the runtime's 1 KB a CTA
SMEM_TARGET = {(False, 2): 72 * 1024, (True, 2): 112 * 1024,
               (False, 4): 112 * 1024, (True, 4): 112 * 1024}
# CTAs an SM the f32 forward's and backward's __launch_bounds__ ask for
# (csrc f32fwd::kBlocks, f32bwd::kBlocks). The backward's SMEM_TARGET fits
# its two; the forward asks for four (64 registers) so that its smaller
# plans get up to four CTAs an SM, while its target fits two
F32_FWD_BLOCKS = 4
F32_BWD_BLOCKS = 2
# an SM's shared memory for resident CTAs, each with the runtime's 1 KB
SM_SMEM = 228 * 1024
# (position, group) items a CTA of small images takes: four a thread
ITEMS_PER_CTA = 4 * THREADS
# the f32 backward's f64 sums a thread per slice-sum round (pass 2: dscale,
# dbias and the two statistics' gradient terms)
F32_BWD_SLICE_VALUES = 4
# The f32 backward's plan cost (f32_bwd_cost), per output position and
# channel, in the time of one conv output: each tile's conv outputs (the
# tile twice, in passes 1 and 2, and the tile with its ring in pass 3), its
# boxes' elements at F32_BWD_BOX_COST each (the copies, the halo's rows
# through L2; three times on a streamed plan), and a CTA's fixed time (the
# copies' latency, the barriers and exchanges) at F32_BWD_CTA_COST conv
# outputs of each of its threads
F32_BWD_BOX_COST, F32_BWD_CTA_COST = 0.25, 4.0
# The f32 forward's plan cost (f32_fwd_cost): a CTA's time in the time of
# one conv output of pass 1 by a thread (the window slid S rows: 3 S loads,
# 9 products, 8 sums, two f64 sums). Its work w is its slowest slice's:
# pass 1, pass 2 at F32_FWD_KEPT an output where the plan keeps the conv
# output (else the conv again), and each unit's first window rows at
# F32_FWD_START a row (in both passes where pass 2 computes the conv
# again). Its latency is F32_FWD_CTA_COST (the copy, the barriers, the
# exchange) plus F32_FWD_CLUSTER_COST in a cluster of more than one. k of
# them share an SM (its shared memory, at most F32_FWD_BLOCKS by the
# kernel's registers), so an SM spends on each the larger of (latency + w)
# / k and F32_FWD_INSTR w (its warps' instructions), or, where bytes bound
# it, F32_FWD_BOX_COST an element of its boxes (twice on a streamed plan);
# a chunk of cc channels adds F32_FWD_NARROW x 8 / cc of that (narrow
# chunks copy and store in short rows). Fitted to every resident plan's
# time at the 20 step shapes (tools/dwgn_f32_fwd_probe.py --all-shapes).
F32_FWD_START, F32_FWD_KEPT, F32_FWD_INSTR, F32_FWD_NARROW = 6.0, 0.1, 0.85, 0.02
F32_FWD_CTA_COST, F32_FWD_CLUSTER_COST, F32_FWD_BOX_COST = 220.0, 60.0, 0.005


@dataclass(frozen=True)
class DwgnPlan:
    """How the kernels cut one ``[B, h, w, c]`` activation, chosen here and
    passed to the CUDA source as ints. A cluster of ``cluster`` CTAs owns
    one (batch element, chunk of ``cc`` channels); the output is cut into
    tiles of ``rows`` x ``cols`` positions, and rank r of the cluster takes
    tiles r, r + cluster, ... (``tiles_per_cta`` of them). With one tile a
    CTA (a resident plan) its TMA box stays in shared memory for every pass;
    otherwise each pass loads each tile again. ``halo`` is 1 for the
    backward, whose box also covers the outputs next to the tile (their
    cotangent feeds the tile's dx). A CTA holds ``images`` batch elements
    side by side (small images: each takes ``THREADS / images`` threads),
    so that the grid is ``(cluster, c / cc, ceil(B / images))``.
    ``itemsize`` is the element's bytes (2 bf16, 4 f32): a plan is for one
    element type, and the other type's kernel refuses it (its shared
    memory differs)."""

    h: int
    w: int
    c: int
    stride: int
    backward: bool
    cc: int
    rows: int
    cols: int
    cluster: int
    tiles_per_cta: int
    images: int
    smem: int
    itemsize: int = 2
    #: the f32 forward's (csrc f32fwd; 0 and False elsewhere): the rows of
    #: a unit, one column of a tile a thread walks down; whether pass 1's
    #: conv output stays in shared memory for pass 2 (resident plans only)
    strip: int = 0
    keep: bool = False

    @property
    def geometry(self):
        return _geometry(self.h, self.w, self.stride)

    @property
    def halo(self) -> int:
        return int(self.backward)

    @property
    def n_row_tiles(self) -> int:
        return -(-self.geometry[2] // self.rows)

    @property
    def n_col_tiles(self) -> int:
        return -(-self.geometry[3] // self.cols)

    @property
    def slices(self) -> int:
        """Position slices of a channel: the f32 kernels' threads each take
        one channel and a share of a tile's positions (the backward every
        ``slices``-th position, the forward every ``slices``-th unit); 1 in
        bf16."""
        return THREADS // (self.images * self.cc) if self.itemsize == 4 else 1

    @property
    def x_box(self) -> Tuple[int, int]:
        """(rows, cols) of the x box."""
        return _x_box(self.rows, self.cols, self.stride, self.halo)

    def ctas(self, batch: int) -> int:
        return self.cluster * (self.c // self.cc) * -(-batch // self.images)

    def tiles(self):
        """``(rank, row0, col0, n_rows, n_cols)`` of every tile, in the
        order each rank walks them."""
        _, _, oh, ow = self.geometry
        out = []
        for rank in range(self.cluster):
            for i in range(self.tiles_per_cta):
                t = rank + i * self.cluster
                if t < self.n_row_tiles * self.n_col_tiles:
                    r0, c0 = (t // self.n_col_tiles) * self.rows, (t % self.n_col_tiles) * self.cols
                    out.append((rank, r0, c0, min(self.rows, oh - r0), min(self.cols, ow - c0)))
        return out


def _align(n: int) -> int:
    return -(-n // 128) * 128


def _x_box(rows: int, cols: int, stride: int, halo: int) -> Tuple[int, int]:
    return (rows + 2 * halo - 1) * stride + 3, (cols + 2 * halo - 1) * stride + 3


def _smem_bytes(cc: int, rows: int, cols: int, stride: int, backward: bool,
                images: int = 1, itemsize: int = 2, keep: bool = False) -> int:
    """The kernel's dynamic shared memory (csrc/depthwise_gn.cu
    ``make_plan``, which refuses a launch whose count differs): the x boxes
    and the backward's g boxes (overwritten by the conv-output cotangent)
    at ``itemsize`` bytes an element, two f64 reduction buffers of 8 warps,
    the bf16 backward's f32 warp sums of dw (9 taps; the f32 backward sums
    dw through the reduction buffers), the cluster's exchange slots, the
    group statistics, the two mbarriers, and 128 bytes to align the base.
    The f32 kernels have layouts of their own (:func:`_f32_bwd_parts`,
    :func:`_f32_fwd_parts`; ``keep``: the f32 forward keeps its conv
    output)."""
    xr, xc = _x_box(rows, cols, stride, int(backward))
    gc = cc // GROUP_SIZE
    warps = THREADS // 32
    if itemsize == 4:
        parts = (_f32_bwd_parts(cc, rows, cols, xr, xc, images) if backward
                 else _f32_fwd_parts(cc, rows, cols, xr, xc, images, keep))
        return 128 + sum(_align(p) for p in parts) + 16
    parts = (images * xr * xc * cc * itemsize,
             images * (rows + 2) * (cols + 2) * cc * itemsize if backward else 0,
             2 * warps * cc * 8, 9 * warps * cc * 4 if backward and itemsize == 2 else 0,
             images * (11 * cc + 4 * gc if backward else 2 * gc) * 8, images * gc * 32)
    return 128 + sum(_align(p) for p in parts) + 16


def _f32_bwd_parts(cc: int, rows: int, cols: int, xr: int, xc: int, images: int):
    """The f32 backward's shared-memory regions (csrc/depthwise_gn.cu
    ``f32bwd``): the x boxes, at least as large as the nine taps' f64 dw
    sums of every thread (which take their place once dw's last product is
    read); the g boxes (then the cotangent); one f64 buffer of
    ``F32_BWD_SLICE_VALUES`` sums a thread for the slice sums of passes 1
    and 2; the cluster's exchange slots; 8 floats of statistics a group."""
    gc = cc // GROUP_SIZE
    return (max(images * xr * xc * cc * 4, 9 * THREADS * 8),
            images * (rows + 2) * (cols + 2) * cc * 4, F32_BWD_SLICE_VALUES * THREADS * 8,
            images * (11 * cc + 4 * gc) * 8, images * gc * 32)


def _f32_fwd_parts(cc: int, rows: int, cols: int, xr: int, xc: int, images: int, keep: bool):
    """The f32 forward's shared-memory regions (csrc/depthwise_gn.cu
    ``f32fwd``): the x boxes; the conv-output tiles where the plan keeps
    them; one f64 buffer of 2 sums a thread (pass 1's slice sum); the
    cluster's exchange slots; 8 floats of statistics a group."""
    gc = cc // GROUP_SIZE
    return (images * xr * xc * cc * 4, images * rows * cols * cc * 4 if keep else 0,
            2 * THREADS * 8, images * 2 * gc * 8, images * gc * 32)


def _f32_fwd_work(rows: int, cols: int, strip: int, nsl: int, stride: int, keep: bool) -> float:
    """The f32 forward's work for its slowest slice over one tile of
    ``rows x cols`` outputs in units of ``strip`` rows (see
    ``F32_FWD_START``)."""
    blocks = -(-rows // strip)
    per = -(-blocks * cols // nsl)  # units of the slowest slice
    out = 1 + (F32_FWD_KEPT if keep else 1)
    return per * (rows / blocks * out + (3 - stride) * F32_FWD_START * (1 if keep else 2))


def _f32_fwd_strip(rows: int, cols: int, nsl: int, stride: int, keep: bool) -> int:
    """The rows of the f32 forward's units for a ``rows x cols`` tile: the
    least :func:`_f32_fwd_work` among ``ceil(rows / k)``, k = 1 to 8 (ties:
    the longest)."""
    strips = sorted({-(-rows // k) for k in range(1, min(rows, 8) + 1)}, reverse=True)
    return min(strips, key=lambda st: _f32_fwd_work(rows, cols, st, nsl, stride, keep))


def f32_fwd_cost(plan: "DwgnPlan") -> float:
    """The f32 forward's estimated time for ``plan``, per output position
    and channel of one image (see ``F32_FWD_START``): what its plan search
    minimizes. A CTA's work is rank 0's tiles'."""
    _, _, oh, ow = plan.geometry
    xr, xc = plan.x_box
    loads = 1 if plan.tiles_per_cta == 1 else 2
    work = box = 0.0
    for rank, _, _, rr, cw in plan.tiles():
        if rank == 0:
            work += _f32_fwd_work(rr, cw, min(plan.strip, rr), plan.slices, plan.stride, plan.keep)
            box += loads * xr * xc * plan.cc * plan.images
    latency = F32_FWD_CTA_COST + (F32_FWD_CLUSTER_COST if plan.cluster > 1 else 0.0)
    k = min(F32_FWD_BLOCKS, SM_SMEM // (plan.smem + 1024))
    cta = max((latency + work) / k, F32_FWD_INSTR * work, F32_FWD_BOX_COST * box)
    return plan.cluster * cta * (1 + F32_FWD_NARROW * GROUP_SIZE / plan.cc) / (
        plan.cc * plan.images * oh * ow)


def f32_bwd_cost(plan: "DwgnPlan") -> float:
    """The f32 backward's estimated time for ``plan``, per output position
    and channel of one image (see ``F32_BWD_BOX_COST``): what its plan
    search minimizes. A streamed plan loads each tile's boxes once a pass
    (three times)."""
    _, _, oh, ow = plan.geometry
    rows, cols = plan.rows, plan.cols
    xr, xc = plan.x_box
    loads = 1 if plan.tiles_per_cta == 1 else 3
    tile = 2 * rows * cols + (rows + 2) * (cols + 2) + loads * F32_BWD_BOX_COST * (
        xr * xc + (rows + 2) * (cols + 2))
    ctas = plan.cluster * F32_BWD_CTA_COST * THREADS / (plan.cc * plan.images)
    return (plan.n_row_tiles * plan.n_col_tiles * tile + ctas) / (oh * ow)


def _chunks(c: int, positions: int):
    """Channels a cluster may own, widest first: 8 * 2^k dividing C, at
    most 64 (128 on an image of 64 positions or fewer, where a CTA has
    little else to do), so that a thread keeps one group of 8 throughout."""
    cap = 128 if positions <= 64 else 64
    return [cc for cc in (128, 64, 32, 16, 8) if cc <= cap and c % cc == 0]


def make_plan(h: int, w: int, c: int, stride: int, backward: bool, cc: int, rows: int,
              cols: int, cluster: int = MAX_CLUSTER, images: int = 1,
              itemsize: int = 2, strip: "int | None" = None, keep: bool = False) -> DwgnPlan:
    """A plan of ``rows x cols`` output tiles spread over a cluster of at
    most ``cluster`` CTAs (fewer where there are fewer tiles). The f32
    forward's also takes ``strip`` (by default :func:`_f32_fwd_strip`'s)
    and ``keep``."""
    _, _, oh, ow = _geometry(h, w, stride)
    n_tiles = -(-oh // rows) * -(-ow // cols)
    cluster = min(cluster, n_tiles)
    if not backward and itemsize == 4:
        strip = strip or _f32_fwd_strip(rows, cols, THREADS // (images * cc), stride, keep)
    else:
        strip, keep = 0, False
    return DwgnPlan(h, w, c, stride, backward, cc, rows, cols, cluster, -(-n_tiles // cluster),
                    images, _smem_bytes(cc, rows, cols, stride, backward, images, itemsize, keep),
                    itemsize, strip, keep)


def _f32_cuts(oh: int, ow: int, streamed: bool):
    """The f32 kernels' candidate tiles ``(rows, cols, tiles)``: each cut
    into at most ``MAX_CLUSTER`` tiles (rows and columns), or with
    ``streamed`` into more (up to 4 columns of tiles), which a cluster of
    ``MAX_CLUSTER`` CTAs walks (one CTA walking all of them leaves most of
    the card idle at B 64)."""
    n_rt = range(1, oh + 1) if streamed else range(1, MAX_CLUSTER + 1)
    cuts = {(-(-oh // nr), -(-ow // nc)) for nr in n_rt
            for nc in range(1, (min(4, ow) if streamed else MAX_CLUSTER // nr) + 1)}
    for rows, cols in sorted(cuts):
        tiles = -(-oh // rows) * -(-ow // cols)
        if streamed == (tiles > MAX_CLUSTER):
            yield rows, cols, tiles


def _f32_bwd_plans(h: int, w: int, c: int, stride: int, budget: int, streamed: bool = False):
    """Every resident f32 backward plan within ``budget``: each channel
    chunk, each cut of :func:`_f32_cuts`, and on a single tile each number
    of images side by side. With ``streamed``, the streamed plans
    instead."""
    _, _, oh, ow = _geometry(h, w, stride)
    out = []
    for cc in _chunks(c, oh * ow):
        for rows, cols, tiles in _f32_cuts(oh, ow, streamed):
            for images in (1, 2, 4, 8) if tiles == 1 else (1,):
                xr, xc = _x_box(rows, cols, stride, 1)
                if (images * cc > THREADS or max(xr, xc, rows + 2, cols + 2) > MAX_BOX
                        or _smem_bytes(cc, rows, cols, stride, True, images, 4) > budget):
                    continue
                out.append(make_plan(h, w, c, stride, True, cc, rows, cols, images=images,
                                     itemsize=4))
    return out


def _f32_fwd_plans(h: int, w: int, c: int, stride: int, budget: int, streamed: bool = False):
    """Every resident f32 forward plan within ``budget``: each channel
    chunk that divides C (8 to 128), each cut of :func:`_f32_cuts`, on a
    single tile each number of images side by side, the conv output kept
    or not, each with its best strip (:func:`_f32_fwd_strip`). With
    ``streamed``, the streamed plans instead (the conv computed in both
    passes)."""
    _, _, oh, ow = _geometry(h, w, stride)
    out = []
    for cc in (cc for cc in (128, 64, 32, 16, 8) if c % cc == 0):
        for rows, cols, tiles in _f32_cuts(oh, ow, streamed):
            xr, xc = _x_box(rows, cols, stride, 0)
            if max(xr, xc) > MAX_BOX:
                continue
            for images in (1, 2, 4, 8) if tiles == 1 else (1,):
                for keep in (True, False) if not streamed else (False,):
                    if (images * cc > THREADS or _smem_bytes(
                            cc, rows, cols, stride, False, images, 4, keep) > budget):
                        continue
                    out.append(make_plan(h, w, c, stride, False, cc, rows, cols, images=images,
                                         itemsize=4, keep=keep))
    return out


@functools.lru_cache(maxsize=512)
def dwgn_plan(h: int, w: int, c: int, stride: int, backward: bool,
              itemsize: int = 2) -> DwgnPlan:
    """The plan of the kernel for an ``[_, h, w, c]`` activation of
    ``itemsize``-byte elements (any shape :func:`depthwise_gn_supported`
    admits at that itemsize). Tiles span the whole width
    where the TMA box allows (256 columns), else the fewest column tiles
    that fit. Then, for the widest channel chunk that allows it, the
    fewest row tiles whose cluster is at most ``MAX_CLUSTER`` and whose
    shared memory is within ``SMEM_TARGET``, or failing that the most row
    tiles within ``SMEM_LIMIT``: every tile stays resident. Failing both,
    a cluster of ``MAX_CLUSTER`` walks tiles
    within ``SMEM_TARGET`` and loads each tile once a pass (two passes
    over x in the forward, three over x and g in the backward)."""
    _, _, oh, ow = _geometry(h, w, stride)
    halo, target = int(backward), SMEM_TARGET[(backward, itemsize)]

    def smem(cc, rows, cols, images=1):
        return _smem_bytes(cc, rows, cols, stride, backward, images, itemsize)

    def fits(cc, rows, cols, budget):
        xr, xc = _x_box(rows, cols, stride, halo)
        return (max(xr, xc, rows + 2 * halo, cols + 2 * halo) <= MAX_BOX
                and smem(cc, rows, cols) <= budget)

    def plan(cc, rows, cols, images=1):
        return make_plan(h, w, c, stride, backward, cc, rows, cols, images=images,
                         itemsize=itemsize)

    row_counts = sorted({-(-oh // n) for n in range(1, oh + 1)}, reverse=True)
    chunks = _chunks(c, oh * ow)
    n_ct = 1
    while not fits(chunks[-1], 1, -(-ow // n_ct), SMEM_LIMIT):
        n_ct += 1
    cols = -(-ow // n_ct)
    n_ct = -(-ow // cols)
    resident = [r for r in row_counts if -(-oh // r) * n_ct <= MAX_CLUSTER]
    if itemsize == 4:  # the f32 kernels: the least cost within the target
        plans, cost = (_f32_bwd_plans, f32_bwd_cost) if backward else (_f32_fwd_plans, f32_fwd_cost)
        best = min(plans(h, w, c, stride, target) or plans(h, w, c, stride, target, streamed=True),
                   key=cost, default=None)
        if best is not None:
            return best
    for cc in chunks:
        rows = next((r for r in resident if fits(cc, r, cols, target)), None)
        if rows is not None and rows >= oh and cols >= ow:  # one tile: images side by side
            images = max(n for n in (1, 2, 4, 8) if n == 1 or (
                n * cc <= THREADS and n * oh * ow * cc // GROUP_SIZE <= ITEMS_PER_CTA
                and smem(cc, rows, cols, n) <= target))
            return plan(cc, rows, cols, images)
        if rows is not None:
            return plan(cc, rows, cols)
    for cc in chunks:  # the most tiles, the least shared memory
        rows = next((r for r in reversed(resident) if fits(cc, r, cols, SMEM_LIMIT)), None)
        if rows is not None:
            return plan(cc, rows, cols)
    cc = chunks[0]  # stream
    while not fits(cc, 1, cols, target) and cols > 1:
        cols = -(-cols // 2)
    rows = next((r for r in row_counts if fits(cc, r, cols, target)), 1)
    return plan(cc, rows, cols)


# -- plain versions ----------------------------------------------------------


def depthwise3x3(x: torch.Tensor, w3: torch.Tensor, stride: int) -> torch.Tensor:
    """SAME depthwise 3x3 over NHWC ``x`` as nine shifted products, added in
    (ky, kx) order in ``x``'s dtype (``w3``: ``[3, 3, C]``, same dtype).
    The conv of the plain versions and of the unfused shift branch."""
    _, h, wd, _ = x.shape
    ph, pw, oh, ow = _geometry(h, wd, stride)
    return _taps(F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1])), w3, stride, oh, ow)


def _taps(xp: torch.Tensor, w3: torch.Tensor, stride: int, oh: int, ow: int) -> torch.Tensor:
    """The nine shifted products of an already padded ``xp``, ``oh x ow``
    outputs from its corner."""
    acc = None
    for ky in range(3):
        for kx in range(3):
            sl = xp[:, ky:ky + (oh - 1) * stride + 1:stride, kx:kx + (ow - 1) * stride + 1:stride]
            term = sl * w3[ky, kx]
            acc = term if acc is None else acc + term
    return acc


def _sum(t: torch.Tensor, dims) -> torch.Tensor:
    """The f32 of the exact sum (accumulated in f64): the same bits in any
    order, as the kernels' f64 accumulators give."""
    return t.double().sum(dim=dims, keepdim=True).float()


def _div(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t / n`` rounded once, as the kernels divide. PyTorch's CUDA
    kernels divide by a host number (and take a mean) by multiplying with
    its reciprocal, which can round an f32 result the other way; a divisor
    on ``t``'s device is a true division there and on the CPU alike."""
    return t / torch.tensor(n, dtype=t.dtype, device=t.device)


def _stats(acc: torch.Tensor, group_size: int, eps: float):
    """``(xg [B, P, G, gs] f32, mean, E[x^2] - mean^2, inv)`` per group;
    the means are f32 of the exact means."""
    b, oh, ow, c = acc.shape
    xg = acc.reshape(b, oh * ow, c // group_size, group_size).float()
    n = oh * ow * group_size
    m = _div(xg.double().sum(dim=(1, 3), keepdim=True), n).float()
    m2 = _div((xg * xg).double().sum(dim=(1, 3), keepdim=True), n).float()
    var = m2 - m * m
    inv = torch.rsqrt(torch.clamp(var, min=0.0) + eps)
    return xg, m, var, inv


def _w3(w: torch.Tensor) -> torch.Tensor:
    return w.reshape(3, 3, w.shape[-1])


def depthwise3x3_groupnorm_reference(x, w, scale, bias, stride: int = 1, eps: float = 1e-6,
                                     group_size: int = GROUP_SIZE, relu6: bool = True
                                     ) -> torch.Tensor:
    """Plain version of the forward kernel: ``[B, oh, ow, C]`` in ``x``'s
    dtype."""
    acc = depthwise3x3(x, _w3(w), stride)
    xg, m, _, inv = _stats(acc, group_size, eps)
    y = ((xg - m) * inv).reshape(acc.shape)
    y = (y * scale.float() + bias.float()).to(x.dtype)
    return torch.clamp(y, 0.0, 6.0) if relu6 else y


def _half_at_ties(v: torch.Tensor, lo: bool, hi: bool) -> torch.Tensor:
    """JAX's derivative factor of max/min at a tie: 1 inside, 0.5 on a
    bound, 0 outside (``lo``/``hi`` pick the bounds 0 and 6)."""
    one = torch.ones_like(v)
    f = one
    if lo:
        f = torch.where(v > 0, one, torch.where(v == 0, 0.5 * one, 0.0 * one))
    if hi:
        f = f * torch.where(v < 6, one, torch.where(v == 6, 0.5 * one, 0.0 * one))
    return f


def _dacc_reference(x, w, scale, bias, g, stride, eps, group_size, relu6, drop_stats=False):
    """The backward up to the conv: ``(acc, dacc in x's dtype, dscale and
    dbias per batch [B, C] f32)``. ``drop_stats`` treats the mean and inv
    as constants, a deliberately wrong gradient for the limit checks."""
    acc = depthwise3x3(x, _w3(w), stride)
    b, oh, ow, c = acc.shape
    xg, m, var, inv = _stats(acc, group_size, eps)
    xc = xg - m
    yn = (xc * inv).reshape(acc.shape)
    y = (yn * scale.float() + bias.float()).to(x.dtype)
    dz = g.float() * _half_at_ties(y.float(), True, True) if relu6 else g.float()
    dscale = _sum(dz * yn, (1, 2))[:, 0, 0]
    dbias = _sum(dz, (1, 2))[:, 0, 0]
    dyn = (dz * scale.float()).reshape(xg.shape)
    dxc = dyn * inv
    if drop_stats:
        return acc, dxc.reshape(acc.shape).to(x.dtype), dscale, dbias
    n = xg.shape[1] * xg.shape[3]
    dinv = _sum(dyn * xc, (1, 3))
    dvar = dinv * (-0.5 * (inv / (torch.clamp(var, min=0.0) + eps)))
    dvar = dvar * _half_at_ties(var, True, False)
    dm = -_sum(dxc, (1, 3)) - 2.0 * dvar * m
    dxg = dxc + 2.0 * xg * _div(dvar, n) + _div(dm, n)
    return acc, dxg.reshape(acc.shape).to(x.dtype), dscale, dbias


def _conv_transpose_reference(x, w3, dacc, stride):
    """``(dx, dw per batch [B, 3, 3, C] f32)`` of the nine shifted products.
    dx sums the nine contributions in the activation dtype from the last
    tap (2, 2) to the first, the order in which ``jax.vjp`` accumulates
    them (bitwise equal to the interpreted Pallas kernel at bf16). Each dw
    term is the f32 of the exact sum of rounded products ``dacc * x``,
    rounded to the activation dtype per batch element (the interpreter on
    the CPU adds them in bf16 one by one instead)."""
    b, h, wd, c = x.shape
    ph, pw, oh, ow = _geometry(h, wd, stride)
    xp = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))
    dxp = torch.zeros_like(xp)
    dw = torch.empty(b, 3, 3, c, dtype=torch.float32, device=x.device)
    for ky in (2, 1, 0):
        for kx in (2, 1, 0):
            rows = slice(ky, ky + (oh - 1) * stride + 1, stride)
            cols = slice(kx, kx + (ow - 1) * stride + 1, stride)
            dxp[:, rows, cols] = dxp[:, rows, cols] + dacc * w3[ky, kx]
            dw[:, ky, kx] = _sum(dacc * xp[:, rows, cols], (1, 2))[:, 0, 0].to(x.dtype).float()
    return dxp[:, ph[0]:ph[0] + h, pw[0]:pw[0] + wd], dw


def depthwise3x3_groupnorm_backward_reference(x, w, scale, bias, g, stride: int = 1,
                                              eps: float = 1e-6, group_size: int = GROUP_SIZE,
                                              relu6: bool = True, drop_stats: bool = False):
    """Plain version of the backward kernel and the sum over the batch:
    ``(dx in x's dtype, dw like w, dscale, dbias like scale and bias)``."""
    _, dacc, dsp, dbp = _dacc_reference(x, w, scale, bias, g, stride, eps, group_size, relu6,
                                        drop_stats)
    dx, dwp = _conv_transpose_reference(x, _w3(w), dacc, stride)
    return _reduce(dx, dwp, dsp, dbp, w, scale, bias)


def _reduce(dx, dwp, dsp, dbp, w, scale, bias):
    """Sum the per-batch partials (fixed order, as JAX sums them outside
    its kernel) and cast each to its parameter's dtype."""
    return (dx, dwp.sum(0).reshape(w.shape).to(w.dtype), dsp.sum(0).to(scale.dtype),
            dbp.sum(0).to(bias.dtype))


# -- the kernels' decomposition, in plain PyTorch ------------------------------
#
# Mirrors of the kernels' plan: tile by tile from each tile's TMA box (zeros
# outside the image), per-rank f64 partials added in rank order, and the
# backward's dx from each tile's cotangent over the tile and its ring. The
# CPU tests hold them to the plain versions above bit for bit, which shows
# that the band split changes no bits.


def _boxes(x, plan: DwgnPlan):
    """``(rank, r0, c0, rr, cw, box)`` of every tile: the x box from
    output ``(r0 - halo, c0 - halo)`` on, zeros outside the image."""
    _, h, wd, _ = x.shape
    pt, pl, s, halo = _same_pads(h, plan.stride)[0], _same_pads(wd, plan.stride)[0], \
        plan.stride, plan.halo
    pad = 3 * s + 2
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    xr, xc = plan.x_box
    for rank, r0, c0, rr, cw in plan.tiles():
        y0, x0 = (r0 - halo) * s - pt + pad, (c0 - halo) * s - pl + pad
        yield rank, r0, c0, rr, cw, xp[:, y0:y0 + xr, x0:x0 + xc]


def slice_lanes(n_sums: int, nsl: int) -> int:
    """The lanes that share one of the f32 backward's ``n_sums`` slice sums
    over ``nsl`` slices (csrc/depthwise_gn.cu ``slice_lanes``): the most, a
    power of two up to 32 and to ``nsl``, with ``n_sums * lanes`` within the
    CTA's threads."""
    lanes = 1
    while lanes < 32 and lanes < nsl and n_sums * lanes * 2 <= THREADS:
        lanes *= 2
    return lanes


def _slice_total(part: torch.Tensor, lanes: int) -> torch.Tensor:
    """A rank's ``[nsl, ...]`` slice partials added as the kernel adds them:
    ``lanes`` blocks of neighbouring slices, each in slice order, then the
    blocks pairwise (a butterfly over the lanes)."""
    per = part.shape[0] // lanes
    blocks = []
    for i in range(lanes):
        tot = part[i * per]
        for sl in range(i * per + 1, (i + 1) * per):
            tot = tot + part[sl]
        blocks.append(tot)
    while len(blocks) > 1:
        blocks = [a + b for a, b in zip(blocks[::2], blocks[1::2])]
    return blocks[0]


def _rank_sums(parts, ranks, lanes=1, slices=None):
    """The f64 per-rank partials added in rank order, each rank's by
    position slice (``[nsl, ...]``, :func:`_by_slice`) added first as the
    f32 backward adds them over ``lanes`` (:func:`_slice_total`; one slice
    elsewhere). With ``slices``, only those slices count, in order (a
    deliberately wrong sum for the limit checks)."""
    tot = None
    for r in ranks:
        if r in parts:
            if slices is None:
                part = _slice_total(parts[r], lanes)
            else:
                part = parts[r][slices[0]]
                for sl in slices[1:]:
                    part = part + parts[r][sl]
            tot = part if tot is None else tot + part
    return tot


def _lanes(plan: "DwgnPlan", n_values: int) -> int:
    """The lanes of ``plan``'s slice sums of ``n_values`` values a thread."""
    return slice_lanes(n_values * plan.images * plan.cc, plan.slices)


def _by_slice(t: torch.Tensor, nsl: int, dims, order=None) -> torch.Tensor:
    """``[nsl, ...]``: the f64 sums over ``dims`` (kept) of ``t`` for each
    position slice, positions along dim 1 and position q in slice q %
    ``nsl`` (the f32 backward's threads; 1 elsewhere), q its index in the
    tile's row-major order or ``order[q]``."""
    q = torch.arange(t.shape[1], device=t.device) if order is None else order
    return torch.stack([t[:, q % nsl == sl].double().sum(dim=dims, keepdim=True)
                        for sl in range(nsl)])


def _unit_of(plan: DwgnPlan, rr: int, cw: int, device) -> torch.Tensor:
    """``[rr * cw]``: for each position of a tile of ``rr x cw`` outputs,
    in row-major order, the index whose remainder mod ``plan.slices`` is
    its slice: the f32 forward's unit (csrc ``f32fwd::for_units``: row
    block ``qy // strip``, column ``qx``, numbered ``block * cw + qx``), the
    position's own index elsewhere."""
    if plan.backward or plan.itemsize != 4:
        return torch.arange(rr * cw, device=device)
    qy = torch.arange(rr, device=device)[:, None] // plan.strip
    return (qy * cw + torch.arange(cw, device=device)[None, :]).flatten()


def _banded_stats(x, w3, plan: DwgnPlan, eps, ranks=None, slices=None):
    """Pass 1: ``(m, var, inv)`` per (batch, group) from the tiles' f64
    (sum, sum of squares), by position slice where the plan has them, from
    ``ranks`` only if given, and from those ``slices`` of each rank only if
    given."""
    b, c = x.shape[0], x.shape[3]
    nsl = plan.slices
    parts, count = {}, {}
    for rank, _, _, rr, cw, box in _boxes(x, plan):
        h0 = plan.halo
        acc = _taps(box[:, h0 * plan.stride:, h0 * plan.stride:], w3, plan.stride, rr, cw)
        xg = acc.reshape(b, rr * cw, c // GROUP_SIZE, GROUP_SIZE).float()
        unit = _unit_of(plan, rr, cw, x.device)
        sums = torch.stack([_by_slice(xg, nsl, (1, 3), unit),
                            _by_slice(xg * xg, nsl, (1, 3), unit)], dim=1)
        parts[rank] = sums if rank not in parts else parts[rank] + sums
        per = [int((unit % nsl == sl).sum()) * GROUP_SIZE for sl in range(nsl)]
        count[rank] = [a + q for a, q in zip(count.get(rank, [0] * nsl), per)]
    ranks = range(plan.cluster) if ranks is None else ranks
    s, ss = _rank_sums(parts, ranks, _lanes(plan, 2), slices)
    n = sum(count[r][sl] for r in ranks for sl in (range(nsl) if slices is None else slices))
    m, m2 = _div(s, n).float(), _div(ss, n).float()
    var = m2 - m * m
    return m, var, torch.rsqrt(torch.clamp(var, min=0.0) + eps)


def banded_forward_reference(x, w, scale, bias, stride: int = 1, eps: float = 1e-6,
                             relu6: bool = True, stats_ranks=None, plan=None,
                             stats_slices=None) -> torch.Tensor:
    """The forward kernel's decomposition under ``plan`` (by default
    :func:`dwgn_plan`'s at ``x``'s itemsize): the statistics by rank and,
    in f32, by position slice (:func:`_unit_of`), added as the kernel adds
    them. With ``stats_ranks`` (``stats_slices``) the statistics come from
    those ranks' tiles (those slices of each rank) alone, a deliberately
    wrong forward for the limit checks."""
    b, h, wd, c = x.shape
    plan = plan or dwgn_plan(h, wd, c, stride, False, x.element_size())
    w3 = _w3(w)
    m, _, inv = _banded_stats(x, w3, plan, eps, stats_ranks, stats_slices)
    _, _, oh, ow = plan.geometry
    out = torch.empty(b, oh, ow, c, dtype=x.dtype, device=x.device)
    for _, r0, c0, rr, cw, box in _boxes(x, plan):
        acc = _taps(box, w3, stride, rr, cw)
        xg = acc.reshape(b, rr * cw, c // GROUP_SIZE, GROUP_SIZE).float()
        y = ((xg - m) * inv).reshape(acc.shape)
        y = (y * scale.float() + bias.float()).to(x.dtype)
        out[:, r0:r0 + rr, c0:c0 + cw] = torch.clamp(y, 0.0, 6.0) if relu6 else y
    return out


def banded_backward_reference(x, w, scale, bias, g, stride: int = 1, eps: float = 1e-6,
                              relu6: bool = True, plan=None, dw_slices=None):
    """The backward kernel's decomposition under ``plan`` (by default
    :func:`dwgn_plan`'s at ``x``'s itemsize): ``(dx, dw, dscale, dbias)`` as
    :func:`depthwise3x3_groupnorm_backward_reference` gives them. Every sum
    over positions is taken by position slice (the f32 backward's; one
    slice elsewhere), the slices added as that kernel adds them, then the
    ranks in order. With ``dw_slices`` dw counts those slices only, a
    deliberately wrong dw for the limit checks."""
    b, h, wd, c = x.shape
    plan = plan or dwgn_plan(h, wd, c, stride, True, x.element_size())
    w3, s, nsl = _w3(w), stride, plan.slices
    gsz, ng = GROUP_SIZE, c // GROUP_SIZE
    (pt, _), (pl, _), oh, ow = plan.geometry
    m, var, inv = _banded_stats(x, w3, plan, eps)
    gp = F.pad(g, (0, 0, 1, 1, 1, 1))  # the g box's ring: zeros outside

    def terms(acc, gt):
        xg = acc.reshape(b, -1, ng, gsz).float()
        xc = xg - m
        yn = (xc * inv).reshape(acc.shape)
        y = (yn * scale.float() + bias.float()).to(x.dtype)
        dz = gt.float() * _half_at_ties(y.float(), True, True) if relu6 else gt.float()
        dyn = (dz * scale.float()).reshape(xg.shape)
        return xg, xc, yn, dz, dyn

    parts = {}
    for rank, r0, c0, rr, cw, box in _boxes(x, plan):
        acc = _taps(box[:, s:, s:], w3, s, rr, cw)
        xg, xc, yn, dz, dyn = terms(acc, g[:, r0:r0 + rr, c0:c0 + cw])
        p = (_by_slice((dz * yn).flatten(1, 2), nsl, 1), _by_slice(dz.flatten(1, 2), nsl, 1),
             _by_slice(dyn * inv, nsl, (1, 3)), _by_slice(dyn * xc, nsl, (1, 3)))
        parts[rank] = p if rank not in parts else tuple(a + q for a, q in zip(parts[rank], p))
    ranks = range(plan.cluster)
    dsp, dbp, sxc, dinv = (_rank_sums({r: v[i] for r, v in parts.items()}, ranks, _lanes(plan, 4))
                           for i in range(4))
    dsp, dbp, sxc, dinv = dsp[:, 0].float(), dbp[:, 0].float(), sxc.float(), dinv.float()
    n = oh * ow * gsz
    dvar = dinv * (-0.5 * (inv / (torch.clamp(var, min=0.0) + eps)))
    dvar = dvar * _half_at_ties(var, True, False)
    dm = -sxc - 2.0 * dvar * m

    dx = torch.empty_like(x)
    dw_parts = {}
    for rank, r0, c0, rr, cw, box in _boxes(x, plan):
        acc = _taps(box, w3, s, rr + 2, cw + 2)  # the tile and its ring
        xg, _, _, _, dyn = terms(acc, gp[:, r0:r0 + rr + 2, c0:c0 + cw + 2])
        dacc = (dyn * inv + 2.0 * xg * _div(dvar, n) + _div(dm, n)).reshape(acc.shape).to(x.dtype)
        oy = torch.arange(r0 - 1, r0 + rr + 1, device=x.device)
        ox = torch.arange(c0 - 1, c0 + cw + 1, device=x.device)
        live = ((oy >= 0) & (oy < oh))[:, None] & ((ox >= 0) & (ox < ow))[None, :]
        dacc = torch.where(live[None, :, :, None], dacc, torch.zeros_like(dacc))
        dwt = torch.empty(nsl, b, 3, 3, c, dtype=torch.float64, device=x.device)
        # dw's products come with the cotangent, in the order of the live
        # cells of the tile and its ring (the ring's cells outside the image
        # left out)
        ly0, lx0 = int(r0 == 0), int(c0 == 0)
        wide = min(cw + 2, ow - c0 + 1) - lx0
        order = ((torch.arange(1, rr + 1, device=x.device)[:, None] - ly0) * wide
                 + torch.arange(1, cw + 1, device=x.device)[None, :] - lx0).flatten()
        canvas = torch.zeros_like(box)
        for ky in (2, 1, 0):
            for kx in (2, 1, 0):
                own = box[:, s + ky:s + ky + (rr - 1) * s + 1:s, s + kx:s + kx + (cw - 1) * s + 1:s]
                dwt[:, :, ky, kx] = _by_slice(
                    (dacc[:, 1:rr + 1, 1:cw + 1] * own).flatten(1, 2), nsl, 1, order)[:, :, 0]
                rows = slice(ky, ky + (rr + 1) * s + 1, s)
                cols = slice(kx, kx + (cw + 1) * s + 1, s)
                canvas[:, rows, cols] = canvas[:, rows, cols] + dacc * w3[ky, kx]
        dw_parts[rank] = dwt if rank not in dw_parts else dw_parts[rank] + dwt
        iy0, ix0 = r0 * s, c0 * s
        iy1, ix1 = min((r0 + plan.rows) * s, h), min((c0 + plan.cols) * s, wd)
        by, bx = (r0 - 1) * s - pt, (c0 - 1) * s - pl
        dx[:, iy0:iy1, ix0:ix1] = canvas[:, iy0 - by:iy1 - by, ix0 - bx:ix1 - bx]
    dwp = _rank_sums(dw_parts, ranks, _lanes(plan, 9), dw_slices).float().to(x.dtype).float()
    return _reduce(dx, dwp, dsp, dbp, w, scale, bias)


# -- the kernels -------------------------------------------------------------


def _check(what: str, x, w, scale, bias, stride, group_size, g=None) -> None:
    """Raise unless the kernels take these tensors: contiguous bf16 or f32
    NHWC ``x`` (and ``g``, in ``x``'s dtype) on CUDA, a contiguous
    ``[3, 3, C]`` kernel in ``x``'s dtype, contiguous f32 ``[C]`` affine,
    groups of 8, stride 1 or 2."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dim() != 4 or x.dtype not in KERNEL_DTYPES or not x.is_contiguous():
        raise TypeError(f"{what}: the kernel takes contiguous bf16 or f32 NHWC x, got "
                        f"{x.dtype} {tuple(x.shape)}")
    c = x.shape[3]
    if group_size != GROUP_SIZE or c % GROUP_SIZE or c < MIN_CHANNELS or stride not in (1, 2):
        raise ValueError(f"{what}: the kernel takes groups of {GROUP_SIZE} channels and "
                         f"stride 1 or 2, got C={c}, group_size={group_size}, stride={stride}")
    if (w.numel() != 9 * c or w.shape[-1] != c or w.dtype != x.dtype
            or not w.is_contiguous() or w.device != x.device):
        raise ValueError(f"{what}: w must be a contiguous {x.dtype} [3, 3, (1,) {c}] on "
                         f"{x.device}")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.shape != (c,) or t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != x.device:
            raise ValueError(f"{what}: {name} must be a contiguous f32 [{c}] on {x.device}")
    if g is not None:
        _, _, oh, ow = _geometry(x.shape[1], x.shape[2], stride)
        want = (x.shape[0], oh, ow, c)
        if g.shape != want or g.dtype != x.dtype or not g.is_contiguous() or g.device != x.device:
            raise ValueError(f"{what}: g must be a contiguous {x.dtype} {want} on {x.device}")
    if any(t.data_ptr() % 16 for t in (x, w) + (() if g is None else (g,))):
        raise ValueError(f"{what}: x, w and g must start on a 16-byte boundary (TMA, 16-byte loads)")
    if not 1 <= x.shape[0] <= 65535:
        raise ValueError(f"{what}: the kernel's grid takes a batch of 1 to 65535, got {x.shape[0]}")


def _plan_ints(plan: DwgnPlan):
    """The plan as its kernel's entry point takes it (the f32 forward's
    with its strip and keep)."""
    f32_fwd = (plan.strip, int(plan.keep)) if plan.itemsize == 4 and not plan.backward else ()
    return (plan.cc, plan.rows, plan.cols, plan.cluster, plan.tiles_per_cta, plan.images,
            *f32_fwd, plan.smem)


def _record_cost(x: torch.Tensor, stride: int, backward: bool) -> None:
    """JAX's analytic cost of one pass (``_record_cost``): 28 model FLOPs
    an output element forward (9 MACs, GroupNorm), twice that backward,
    whose recomputed forward counts in ``hw_flops`` only; every wrapper
    records it, on either path."""
    b, h, wd, c = x.shape
    ph, pw, oh, ow = _geometry(h, wd, stride)
    fwd = 28 * b * oh * ow * c
    itemsize = x.element_size()
    flop_count.record_kernel_cost(
        flops=2 * fwd if backward else fwd,
        bytes_accessed=(b * (h + sum(ph)) * (wd + sum(pw)) * c * itemsize
                        + b * oh * ow * c * itemsize) * (2 if backward else 1),
        transcendentals=b * (c // GROUP_SIZE), category="depthwise_gn",
        hw_flops=3 * fwd if backward else fwd)


def depthwise_gn_forward(x, w, scale, bias, stride: int = 1, eps: float = 1e-6,
                         group_size: int = GROUP_SIZE, relu6: bool = True) -> torch.Tensor:
    """The fused forward: the kernel on CUDA, the plain version on the CPU."""
    _record_cost(x, stride, backward=False)
    if x.device.type == "cpu":
        return depthwise3x3_groupnorm_reference(x, w, scale, bias, stride, eps, group_size, relu6)
    _check("depthwise_gn_forward", x, w, scale, bias, stride, group_size)
    b, h, wd, c = x.shape
    _, _, oh, ow = _geometry(h, wd, stride)
    out = torch.empty(b, oh, ow, c, dtype=x.dtype, device=x.device)
    lib = build.load("depthwise_gn", _SIGNATURES)
    plan = dwgn_plan(h, wd, c, stride, False, x.element_size())
    rc = getattr(lib, f"dftt_dwgn_fwd_{KERNEL_DTYPES[x.dtype]}")(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
        b, h, wd, c, stride, eps, int(relu6), *_plan_ints(plan),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "depthwise_gn_forward")
    build.count_launch(depthwise_gn_forward, dtype=x.dtype)
    return out


def depthwise_gn_backward(x, w, scale, bias, g, stride: int = 1, eps: float = 1e-6,
                          group_size: int = GROUP_SIZE, relu6: bool = True):
    """The fused backward for the upstream gradient ``g``: ``(dx, dw,
    dscale, dbias)``, each in its input's dtype and shape. The kernel
    writes dx and per-batch f32 partials of dw, dscale and dbias; they
    are summed over the batch here."""
    _record_cost(x, stride, backward=True)
    if x.device.type == "cpu":
        return depthwise3x3_groupnorm_backward_reference(x, w, scale, bias, g, stride, eps,
                                                         group_size, relu6)
    _check("depthwise_gn_backward", x, w, scale, bias, stride, group_size, g)
    b, h, wd, c = x.shape
    dx = torch.empty_like(x)
    dwp = torch.empty(b, 3, 3, c, dtype=torch.float32, device=x.device)
    dsp = torch.empty(b, c, dtype=torch.float32, device=x.device)
    dbp = torch.empty(b, c, dtype=torch.float32, device=x.device)
    lib = build.load("depthwise_gn", _SIGNATURES)
    plan = dwgn_plan(h, wd, c, stride, True, x.element_size())
    rc = getattr(lib, f"dftt_dwgn_bwd_{KERNEL_DTYPES[x.dtype]}")(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(), g.data_ptr(),
        dx.data_ptr(), dwp.data_ptr(), dsp.data_ptr(), dbp.data_ptr(),
        b, h, wd, c, stride, eps, int(relu6), *_plan_ints(plan),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "depthwise_gn_backward")
    build.count_launch(depthwise_gn_backward, dtype=x.dtype)
    return _reduce(dx, dwp, dsp, dbp, w, scale, bias)


def f32_ctas_per_sm(plan: DwgnPlan) -> int:
    """CTAs of the f32 forward or backward kernel (``plan.backward``) an
    SM holds under ``plan`` (its registers and ``plan.smem``), from the
    CUDA runtime's occupancy calculator; needs the card."""
    lib = build.load("depthwise_gn", _SIGNATURES)
    fn = lib.dftt_dwgn_bwd_f32_ctas_per_sm if plan.backward else lib.dftt_dwgn_fwd_f32_ctas_per_sm
    n = fn(plan.cc, plan.smem)
    build.check(max(-n, 0), "f32_ctas_per_sm")
    return n


#: kernel launches since the count was last set to 0, and by element type
#: (``"float32"``, ``"bfloat16"``)
for _fn in (depthwise_gn_forward, depthwise_gn_backward):
    _fn.launches = 0
    _fn.launches_by_dtype = {}


class _DepthwiseGN(torch.autograd.Function):
    """Saves ``(x, w, scale, bias)`` and recomputes in the backward (JAX:
    the ``custom_vjp`` of ``depthwise3x3_groupnorm``)."""

    @staticmethod
    def forward(ctx, x, w, scale, bias, stride, eps, group_size, relu6):
        ctx.save_for_backward(x, w, scale, bias)
        ctx.args = (stride, eps, group_size, relu6)
        return depthwise_gn_forward(x, w, scale, bias, stride, eps, group_size, relu6)

    @staticmethod
    def backward(ctx, g):
        x, w, scale, bias = ctx.saved_tensors
        grads = depthwise_gn_backward(x, w, scale, bias, g.contiguous(), *ctx.args)
        return (*grads, None, None, None, None)


def depthwise3x3_groupnorm(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                           bias: torch.Tensor, stride: int = 1, eps: float = 1e-6,
                           group_size: int = GROUP_SIZE, relu6: bool = True) -> torch.Tensor:
    """Fused ``depthwise3x3(SAME) -> GroupNorm -> ReLU6`` over NHWC ``x``,
    differentiable. ``w``: ``[3, 3, 1, C]`` or ``[3, 3, C]`` in ``x``'s
    dtype; ``scale``/``bias``: f32 ``[C]``. Callers consult
    :func:`depthwise_gn_supported` first."""
    return _DepthwiseGN.apply(x, w, scale, bias, stride, eps, group_size, relu6)
