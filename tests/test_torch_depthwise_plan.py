"""The depthwise kernels' plan (``ops/depthwise_gn.py::dwgn_plan``) and its
plain mirror.

The CUDA kernels cut each (batch element, channel chunk) into tiles spread
over a thread-block cluster, as the plan says; they run only on the card.
Here, on the CPU:

- the plan, over MobileNetV2's 10 depthwise shapes at 96 px and its 10 at
  224 px, the CPU tests' shapes and a sweep of shapes the gate admits
  (wide rows at C 8 among them), each in bf16 and in f32 (every one of
  them admitted by the gate at both itemsizes), covers every output
  position exactly once, keeps every
  tile's input rows and columns within the SAME-padded image, gives every
  input position to exactly one tile's dx, has its channel chunk divide C
  with a power-of-two number of groups, keeps the cluster within the
  portable 8 CTAs and shared memory within the card's 232,448 bytes, and
  keeps every TMA box within 256 in each dimension, with shared memory
  counted at the plan's itemsize (2 or 4 bytes an element);
- the banded plain mirror (per-tile f64 partials added in rank order, dx
  from each tile's cotangent over the tile and its ring) equals the plain
  versions bit for bit, under the plan and under forced plans of several
  tiles a cluster and several tiles a CTA, in bf16 and in f32, so the band
  split changes no bits; statistics from rank 0's tiles alone do not;
- the plan is cut for the element's size: every MobileNetV2 shape stays
  resident at both, a bf16 plan's cut counts other shared memory at 4
  bytes (the f32 kernel refuses it), and the cut itself differs where the
  count moves a shape past its budget.
"""

import warnings

import numpy as np
import pytest
import torch

from distriflow_tpu_torch.ops import depthwise_gn as dg

pytestmark = pytest.mark.port

# (h, w, c, stride): MobileNetV2's depthwise shapes at 96 px
STEP_SHAPES = [(48, 48, 32, 1), (48, 48, 96, 2), (24, 24, 144, 1), (24, 24, 144, 2),
               (12, 12, 192, 1), (12, 12, 192, 2), (6, 6, 384, 1), (6, 6, 576, 1),
               (6, 6, 576, 2), (3, 3, 960, 1)]
# and at 224 px, MobileNetV2's ImageNet resolution
IMAGENET_SHAPES = [(112, 112, 32, 1), (112, 112, 96, 2), (56, 56, 144, 1), (56, 56, 144, 2),
                   (28, 28, 192, 1), (28, 28, 192, 2), (14, 14, 384, 1), (14, 14, 576, 1),
                   (14, 14, 576, 2), (7, 7, 960, 1)]
# the CPU parity tests' shapes and shapes the gate admits at bf16: the
# 112 px stages at 224 px, wide and tall slivers at C 8 (rows past the TMA
# box's 256 columns), odd sizes at stride 2, single positions
SWEEP_SHAPES = [(8, 8, 16, 1), (9, 7, 16, 2), (8, 8, 16, 2), (13, 13, 32, 1), (13, 13, 32, 2),
                (112, 112, 32, 1), (112, 112, 32, 2), (56, 56, 144, 1), (300, 300, 8, 2),
                (1, 50000, 8, 1), (2, 3000, 16, 2), (600, 5, 8, 1), (5, 600, 8, 1),
                (7, 300, 8, 2), (3, 257, 8, 2), (130, 130, 16, 1), (200, 17, 24, 1),
                (64, 64, 40, 2), (1, 1, 8, 1), (1, 1, 8, 2), (2, 2, 8, 2)]


def _shape_id(shape, itemsize):
    return "-".join(map(str, shape)) + ("-f32" if itemsize == 4 else "")


# every shape at bf16 (the ids the bf16 cases have always had), then every
# shape at f32; the 224 px shapes, new here, at both
PLAN_CASES = ([pytest.param(*s, 2, id=_shape_id(s, 2)) for s in STEP_SHAPES + SWEEP_SHAPES]
              + [pytest.param(*s, 2, id=_shape_id(s, 2) + "-224px") for s in IMAGENET_SHAPES]
              + [pytest.param(*s, 4, id=_shape_id(s, 4)) for s in STEP_SHAPES + SWEEP_SHAPES]
              + [pytest.param(*s, 4, id=_shape_id(s, 4) + "-224px") for s in IMAGENET_SHAPES])


def _needed_rows(plan, r0, rr, oh, pt):
    """Input rows (padded coordinates may be negative) the tile reads for
    the outputs it computes: its own, and in the backward the live ring."""
    s = plan.stride
    lo, hi = (max(r0 - 1, 0), min(r0 + rr + 1, oh)) if plan.backward else (r0, r0 + rr)
    return lo * s - pt, (hi - 1) * s - pt + 3


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("h,w,c,stride,itemsize", PLAN_CASES)
def test_plan_covers_the_image_within_the_card(h, w, c, stride, itemsize, backward):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert dg.depthwise_gn_supported(h, w, c, stride, itemsize=itemsize)
    plan = dg.dwgn_plan(h, w, c, stride, backward, itemsize)
    assert plan.itemsize == itemsize
    (pt, pb), (pl, pr), oh, ow = dg._geometry(h, w, stride)
    assert c % plan.cc == 0 and plan.cc % 8 == 0 and 32 % (plan.cc // 8) == 0
    assert 1 <= plan.cluster <= dg.MAX_CLUSTER
    assert plan.images in (1, 2, 4, 8) and plan.images * plan.cc <= dg.THREADS
    assert plan.smem <= dg.SMEM_LIMIT
    assert plan.smem == dg._smem_bytes(plan.cc, plan.rows, plan.cols, stride, backward, plan.images,
                                       itemsize, plan.keep)
    xr, xc = plan.x_box
    assert max(xr, xc, plan.rows + 2 * plan.halo, plan.cols + 2 * plan.halo) <= dg.MAX_BOX
    tiles = plan.tiles()
    assert {t[0] for t in tiles} == set(range(plan.cluster))  # no rank idles
    assert len(tiles) <= plan.cluster * plan.tiles_per_cta
    covered = np.zeros((oh, ow), np.int32)
    owned = np.zeros((h, w), np.int32)
    for _, r0, c0, rr, cw in tiles:
        covered[r0:r0 + rr, c0:c0 + cw] += 1
        # every row and column the tile reads lies in the padded image and
        # in the tile's box, which starts one ring out in the backward
        for lo_hi, start, pad_lo, pad_hi, full, box in (
                (_needed_rows(plan, r0, rr, oh, pt), r0, pt, pb, h, xr),
                (_needed_rows(plan, c0, cw, ow, pl), c0, pl, pr, w, xc)):
            lo, hi = lo_hi
            assert -pad_lo <= lo < hi <= full + pad_hi
            box_lo = (start - plan.halo) * stride - pad_lo
            assert box_lo <= lo and hi <= box_lo + box
        if backward:  # the inputs whose dx the tile writes
            owned[r0 * stride:min((r0 + plan.rows) * stride, h),
                  c0 * stride:min((c0 + plan.cols) * stride, w)] += 1
    assert (covered == 1).all()
    if backward:
        assert (owned == 1).all()


def _inputs(b, h, w, c, stride, seed=0, dtype=torch.bfloat16):
    rng = np.random.RandomState(seed)
    _, _, oh, ow = dg._geometry(h, w, stride)

    def act(*shape, scale=1.0):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32) * scale).to(dtype)

    return (act(b, h, w, c), act(3, 3, c, scale=1 / 3),
            torch.from_numpy(1 + 0.1 * rng.randn(c).astype(np.float32)),
            torch.from_numpy(0.1 * rng.randn(c).astype(np.float32)),
            torch.from_numpy(rng.rand(b, oh, ow, c).astype(np.float32)).to(dtype))


# (rows, cols, cluster) of forced plans: bands of one row, tiles in both
# directions, several tiles a CTA (the streamed plans)
FORCED = [None, (1, 64, 8), (2, 3, 4), (3, 64, 2), (64, 2, 8), (2, 2, 3)]


MIRROR_SHAPES = [(8, 8, 16, 1), (9, 7, 16, 2), (13, 13, 32, 1), (13, 13, 32, 2), (8, 8, 32, 1),
                 (9, 7, 32, 2)]


@pytest.mark.parametrize("forced", FORCED)
@pytest.mark.parametrize("h,w,c,stride,itemsize",
                         [pytest.param(*s, i, id=_shape_id(s, i)) for i in (2, 4)
                          for s in MIRROR_SHAPES])
def test_banded_mirror_is_the_plain_version_bit_for_bit(h, w, c, stride, itemsize, forced):
    dtype = torch.float32 if itemsize == 4 else torch.bfloat16
    x, k, scale, bias, g = _inputs(2, h, w, c, stride, dtype=dtype)
    plans = [None, None]
    if forced is not None:
        rows, cols, cluster = forced
        plans = [dg.make_plan(h, w, c, stride, bwd, 8, rows, cols, cluster, itemsize=itemsize)
                 for bwd in (False, True)]
    y = dg.depthwise3x3_groupnorm_reference(x, k, scale, bias, stride)
    assert torch.equal(dg.banded_forward_reference(x, k, scale, bias, stride, plan=plans[0]), y)
    want = dg.depthwise3x3_groupnorm_backward_reference(x, k, scale, bias, g, stride)
    got = dg.banded_backward_reference(x, k, scale, bias, g, stride, plan=plans[1])
    for name, a, r in zip(("dx", "dw", "dscale", "dbias"), got, want):
        assert torch.equal(a, r), name


RANK0_CASES = [((13, 13, 32, 1), (2, 3, 4), "forced0"), ((13, 13, 32, 2), (2, 2, 3), "forced1"),
               ((48, 48, 32, 1), None, "None")]


@pytest.mark.parametrize("h,w,c,stride,forced,itemsize", [
    pytest.param(*s, f, i, id=f"{_shape_id(s, i)}-{tag}") for i in (2, 4)
    for s, f, tag in RANK0_CASES])
def test_rank0_statistics_alone_differ(h, w, c, stride, forced, itemsize):
    dtype = torch.float32 if itemsize == 4 else torch.bfloat16
    x, k, scale, bias, _ = _inputs(2, h, w, c, stride, dtype=dtype)
    plan = dg.make_plan(h, w, c, stride, False, 8, *forced, itemsize=itemsize) if forced else None
    wrong = dg.banded_forward_reference(x, k, scale, bias, stride, stats_ranks=[0], plan=plan)
    y = dg.depthwise3x3_groupnorm_reference(x, k, scale, bias, stride)
    assert (plan or dg.dwgn_plan(h, w, c, stride, False, itemsize)).cluster > 1
    assert (wrong.float() - y.float()).abs().max() > 0.01


def test_step_shapes_take_resident_plans():
    # every MobileNetV2 shape at 96 px and at 224 px keeps its tile in
    # shared memory for every pass (one load of x, and of g) in bf16 and in
    # f32, and the small ones put several images in a CTA; but the f32
    # backward (its own kernel, two CTAs an SM) streams the 112 px stage at
    # C 32, whose resident cuts take more than its target (a CTA an SM)
    streamed = {((112, 112, 32, 1), True, 4)}
    for h, w, c, stride in STEP_SHAPES + IMAGENET_SHAPES:
        for backward in (False, True):
            for itemsize in (2, 4):
                plan = dg.dwgn_plan(h, w, c, stride, backward, itemsize)
                want = ((h, w, c, stride), backward, itemsize) not in streamed
                assert (plan.tiles_per_cta == 1) == want, (h, w, c, stride, backward, itemsize)
    for itemsize in (2, 4):
        assert dg.dwgn_plan(3, 3, 960, 1, False, itemsize).images > 1


@pytest.mark.parametrize("backward", [False, True])
def test_plans_are_cut_for_the_element_size(backward):
    # the f32 boxes count 4 bytes an element: the f32 forward (its own
    # kernel, f32fwd: one channel a thread) of 3x3x960 (cc 64, one 3x3
    # tile, 4 images a CTA) holds 4 x 5 x 5 x 64 x 4 bytes of x, where it
    # keeps its conv output 4 x 3 x 3 x 64 x 4 bytes more, one f64 buffer
    # of 2 sums a thread, 2 f64 statistics slots a group and image, 8
    # floats of statistics a group and image, 16 bytes of mbarriers and
    # 128 to align. The f32 backward (f32bwd) keeps x boxes at least as
    # large as its nine f64 dw sums a thread (which take their place at
    # the end) and one f64 buffer of 4 sums a thread, and no 8-warp buffers
    assert dg._smem_bytes(64, 3, 3, 1, False, 4, 4) == (
        128 + 4 * 5 * 5 * 64 * 4 + 2 * 256 * 8 + 4 * 2 * 8 * 8 + 4 * 8 * 32 + 16)
    assert dg._smem_bytes(64, 3, 3, 1, False, 4, 4, keep=True) == (
        128 + 4 * 5 * 5 * 64 * 4 + 4 * 3 * 3 * 64 * 4 + 2 * 256 * 8 + 4 * 2 * 8 * 8 + 4 * 8 * 32
        + 16)
    assert dg._smem_bytes(64, 3, 3, 1, True, 1, 4) == (
        128 + max(7 * 7 * 64 * 4, 9 * 256 * 8) + 5 * 5 * 64 * 4 + 4 * 256 * 8
        + (11 * 64 + 4 * 8) * 8 + 8 * 32 + 16)
    assert dg._smem_bytes(64, 3, 3, 1, True, 4, 4) == (
        128 + 4 * 7 * 7 * 64 * 4 + 4 * 5 * 5 * 64 * 4 + 4 * 256 * 8
        + 4 * (11 * 64 + 4 * 8) * 8 + 4 * 8 * 32 + 16)
    assert dg._smem_bytes(64, 3, 3, 1, True, 1, 2) == (
        128 + 7 * 7 * 64 * 2 + 5 * 5 * 64 * 2 + 2 * 8 * 64 * 8 + 9 * 8 * 64 * 4
        + (11 * 64 + 4 * 8) * 8 + 8 * 32 + 16)
    cuts = set()
    for h, w, c, stride in STEP_SHAPES + IMAGENET_SHAPES + SWEEP_SHAPES:
        p2, p4 = (dg.dwgn_plan(h, w, c, stride, backward, i) for i in (2, 4))
        # a bf16 plan's cut at 4 bytes is other shared memory: the f32
        # entry point refuses it, as the bf16 one refuses an f32 plan
        assert dg._smem_bytes(p2.cc, p2.rows, p2.cols, stride, backward, p2.images, 4) != p2.smem
        assert dg._smem_bytes(p4.cc, p4.rows, p4.cols, stride, backward, p4.images, 2) != p4.smem
        if (p2.cc, p2.rows, p2.cols, p2.cluster, p2.images) != (
                p4.cc, p4.rows, p4.cols, p4.cluster, p4.images):
            cuts.add((h, w, c, stride))
    # the f32 kernels are cut by their own searches (the least
    # f32_bwd_cost, f32_fwd_cost), most of whose cuts differ from bf16's:
    # narrower chunks and larger tiles at the wide images, and 4 images
    # side by side at 3x3x960 as in bf16; the forward's 112 px stage at C
    # 32 takes cc 8 in columns of the whole height where bf16 takes cc 16
    # in bands of 16 rows
    assert len(cuts & set(STEP_SHAPES + IMAGENET_SHAPES)) >= 10
    if backward:
        p = dg.dwgn_plan(48, 48, 96, 2, True, 4)
        assert p.cc < dg.dwgn_plan(48, 48, 96, 2, True, 2).cc and p.rows * p.cols > 8 * 24
        assert dg.dwgn_plan(3, 3, 960, 1, True, 4).images == 4
    else:
        f, b = dg.dwgn_plan(112, 112, 32, 1, False, 4), dg.dwgn_plan(112, 112, 32, 1, False, 2)
        assert (f.cc, f.rows) == (8, 112) and (b.cc, b.rows) == (16, 16)
        assert dg.dwgn_plan(3, 3, 960, 1, False, 4).images == 4


# the plans of the bf16 kernels at MobileNetV2's 20 step shapes: (cc,
# rows, cols, cluster, tiles_per_cta, images, smem), by (shape, backward,
# itemsize). The f32 kernels' plans are cut anew for their own kernels
# (f32bwd, f32fwd: test_torch_depthwise_f32_bwd.py and _f32_fwd.py hold
# them); these stay as they were.
PINNED_PLANS = {
    ((48, 48, 32, 1), False, 2): (32, 16, 48, 3, 1, 1, 62096),
    ((48, 48, 96, 2), False, 2): (32, 8, 24, 3, 1, 1, 57872),
    ((24, 24, 144, 1), False, 2): (16, 24, 24, 1, 1, 1, 24080),
    ((24, 24, 144, 2), False, 2): (16, 12, 12, 1, 1, 2, 42512),
    ((12, 12, 192, 1), False, 2): (64, 12, 12, 1, 1, 1, 33808),
    ((12, 12, 192, 2), False, 2): (64, 6, 6, 1, 1, 2, 52368),
    ((6, 6, 384, 1), False, 2): (128, 6, 6, 1, 1, 1, 33680),
    ((6, 6, 576, 1), False, 2): (64, 6, 6, 1, 1, 2, 25488),
    ((6, 6, 576, 2), False, 2): (64, 3, 3, 1, 1, 4, 34960),
    ((3, 3, 960, 1), False, 2): (64, 3, 3, 1, 1, 4, 22672),
    ((112, 112, 32, 1), False, 2): (16, 16, 112, 7, 1, 1, 68112),
    ((112, 112, 96, 2), False, 2): (16, 8, 56, 7, 1, 1, 64016),
    ((56, 56, 144, 1), False, 2): (16, 28, 56, 2, 1, 1, 58128),
    ((56, 56, 144, 2), False, 2): (16, 14, 28, 2, 1, 1, 55440),
    ((28, 28, 192, 1), False, 2): (64, 14, 28, 2, 1, 1, 70160),
    ((28, 28, 192, 2), False, 2): (64, 7, 14, 2, 1, 1, 64400),
    ((14, 14, 384, 1), False, 2): (64, 14, 14, 1, 1, 1, 41488),
    ((14, 14, 576, 1), False, 2): (64, 14, 14, 1, 1, 1, 41488),
    ((14, 14, 576, 2), False, 2): (64, 7, 7, 1, 1, 2, 66704),
    ((7, 7, 960, 1), False, 2): (64, 7, 7, 1, 1, 2, 29840),
    ((48, 48, 32, 1), True, 2): (32, 12, 48, 4, 1, 1, 114576),
    ((48, 48, 96, 2), True, 2): (32, 8, 24, 3, 1, 1, 104464),
    ((24, 24, 144, 1), True, 2): (16, 24, 24, 1, 1, 1, 55184),
    ((24, 24, 144, 2), True, 2): (16, 12, 12, 1, 1, 2, 76304),
    ((12, 12, 192, 1), True, 2): (64, 12, 12, 1, 1, 1, 90768),
    ((12, 12, 192, 2), True, 2): (64, 6, 6, 1, 1, 1, 78096),
    ((6, 6, 384, 1), True, 2): (128, 6, 6, 1, 1, 1, 107664),
    ((6, 6, 576, 1), True, 2): (64, 6, 6, 1, 1, 2, 81040),
    ((6, 6, 576, 2), True, 2): (64, 3, 3, 1, 1, 2, 76432),
    ((3, 3, 960, 1), True, 2): (64, 3, 3, 1, 1, 4, 89232),
    ((112, 112, 32, 1), True, 2): (8, 23, 112, 5, 1, 1, 100240),
    ((112, 112, 96, 2), True, 2): (16, 8, 56, 7, 1, 1, 105744),
    ((56, 56, 144, 1), True, 2): (16, 19, 56, 3, 1, 1, 91664),
    ((56, 56, 144, 2), True, 2): (16, 14, 28, 2, 1, 1, 88336),
    ((28, 28, 192, 1), True, 2): (64, 7, 28, 4, 1, 1, 112528),
    ((28, 28, 192, 2), True, 2): (64, 5, 14, 3, 1, 1, 110608),
    ((14, 14, 384, 1), True, 2): (64, 14, 14, 1, 1, 1, 107152),
    ((14, 14, 576, 1), True, 2): (64, 14, 14, 1, 1, 1, 107152),
    ((14, 14, 576, 2), True, 2): (64, 7, 7, 1, 1, 1, 89488),
    ((7, 7, 960, 1), True, 2): (64, 7, 7, 1, 1, 2, 90768),
}


@pytest.mark.parametrize("shape,backward,itemsize", [
    pytest.param(s, b, i, id=f"{_shape_id(s, i)}-{'bwd' if b else 'fwd'}")
    for s, b, i in PINNED_PLANS])
def test_other_plans_stay_pinned(shape, backward, itemsize):
    p = dg.dwgn_plan(*shape, backward, itemsize)
    assert (p.cc, p.rows, p.cols, p.cluster, p.tiles_per_cta, p.images, p.smem) == \
        PINNED_PLANS[(shape, backward, itemsize)]
    assert p.slices == 1
