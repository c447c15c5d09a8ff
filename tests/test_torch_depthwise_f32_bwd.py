"""The f32 depthwise backward's own design (kernel 12 in f32:
``csrc/depthwise_gn.cu`` namespace ``f32bwd``), on the CPU.

The kernel takes one channel a thread and every ``plan.slices``-th
position of each tile; every sum over positions is taken by slice, the
slices added in blocks over neighbouring lanes and then a butterfly, then
the cluster's ranks in order; its plan is the least ``f32_bwd_cost`` among
the resident plans within its shared-memory target (streamed ones where
none fits). The kernel runs only on the card; here:

- the banded mirror of that decomposition (``banded_backward_reference``),
  under the f32 backward's own plan and under forced plans of several
  slices, images, tiles a CTA and ranks, against ``jax.vjp`` through the
  JAX package's fused op on the same numpy inputs (rtol 1e-4 with atol 1e-4
  of the tensor's largest element: test_torch_depthwise_gn.py's f32
  backward limit, the sums in another order);
- the same mirror against the plain version: dx, dscale and dbias bit for
  bit, dw within ``chip_smoke.DWGN_F32_SUM_RTOL`` of its largest element
  (its f64 sums in another order may round to the neighbouring f32);
- dw from one position slice alone (the smoke's planted fault
  ``dw_from_slice0_only``) falls outside that limit for most of dw;
- the plan: slices x images x channels is the CTA's threads at every step
  shape, its shared memory is ``_smem_bytes``' count, the target fits the
  CTAs an SM the kernel's ``__launch_bounds__`` asks for
  (``F32_BWD_BLOCKS``, the source's ``f32bwd::kBlocks``), and each
  step shape's plan is the least cost of its candidates.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from distriflow_tpu.ops.depthwise_gn import depthwise3x3_groupnorm as jax_dwgn
from distriflow_tpu_torch.ops import build
from distriflow_tpu_torch.ops import depthwise_gn as dg

pytestmark = pytest.mark.port
torch.set_num_threads(2)

STEP_SHAPES = [(48, 48, 32, 1), (48, 48, 96, 2), (24, 24, 144, 1), (24, 24, 144, 2),
               (12, 12, 192, 1), (12, 12, 192, 2), (6, 6, 384, 1), (6, 6, 576, 1),
               (6, 6, 576, 2), (3, 3, 960, 1), (112, 112, 32, 1), (112, 112, 96, 2),
               (56, 56, 144, 1), (56, 56, 144, 2), (28, 28, 192, 1), (28, 28, 192, 2),
               (14, 14, 384, 1), (14, 14, 576, 1), (14, 14, 576, 2), (7, 7, 960, 1)]

# (h, w, c, stride, forced plan or None): the f32 backward's own plan, then
# (cc, rows, cols, cluster, images) forced: 32 slices over two ranks, 16
# slices of one tile, two and four images of 4 and 2 slices, tiles of one
# row walked three a CTA (a streamed plan), columns cut in two
MIRROR_CASES = [
    ((8, 8, 16, 1), None), ((9, 7, 16, 2), None), ((6, 6, 64, 2), None), ((5, 5, 32, 1), None),
    ((8, 8, 16, 1), (8, 3, 8, 2, 1)), ((9, 7, 16, 2), (16, 5, 4, 1, 1)),
    ((6, 6, 64, 1), (32, 6, 6, 1, 2)), ((3, 3, 32, 1), (32, 3, 3, 1, 4)),
    ((7, 6, 16, 1), (16, 1, 6, 2, 1)), ((13, 13, 32, 2), (8, 7, 4, 4, 1))]


def _case_id(case):
    (h, w, c, s), forced = case
    return f"{h}-{w}-{c}-{s}-" + ("own" if forced is None else "-".join(map(str, forced)))


def _plan(h, w, c, s, forced):
    if forced is None:
        return dg.dwgn_plan(h, w, c, s, True, 4)
    cc, rows, cols, cluster, images = forced
    return dg.make_plan(h, w, c, s, True, cc, rows, cols, cluster, images, itemsize=4)


def _inputs(h, w, c, stride, b=2, seed=0):
    """numpy inputs as test_torch_depthwise_gn.py draws them (f32)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, c).astype(np.float32)
    k = rng.randn(3, 3, 1, c).astype(np.float32)
    scale = (rng.randn(c) * 0.5 + 1.0).astype(np.float32)
    bias = (rng.randn(c) * 0.5 + 1.0).astype(np.float32)
    _, _, oh, ow = dg._geometry(h, w, stride)
    g = rng.randn(b, oh, ow, c).astype(np.float32)
    return x, k, scale, bias, g


@pytest.mark.parametrize("case", MIRROR_CASES, ids=_case_id)
def test_f32_backward_mirror_matches_jax_vjp(case):
    (h, w, c, s), forced = case
    plan = _plan(h, w, c, s, forced)
    x, k, scale, bias, g = _inputs(h, w, c, s)
    _, vjp = jax.vjp(lambda *a: jax_dwgn(*a, s, 1e-6, 8, True, True),
                     *(jnp.asarray(a) for a in (x, k, scale, bias)))
    want = [np.asarray(a) for a in vjp(jnp.asarray(g))]
    got = dg.banded_backward_reference(*(torch.from_numpy(a) for a in (x, k, scale, bias, g)),
                                       s, plan=plan)
    for name, a, r in zip(("dx", "dw", "dscale", "dbias"), got, want):
        np.testing.assert_allclose(a.numpy(), r, rtol=1e-4, atol=1e-4 * np.abs(r).max(),
                                   err_msg=name)


@pytest.mark.parametrize("case", MIRROR_CASES, ids=_case_id)
def test_f32_backward_mirror_is_the_plain_version(case):
    (h, w, c, s), forced = case
    plan = _plan(h, w, c, s, forced)
    x, k, scale, bias, g = (torch.from_numpy(a) for a in _inputs(h, w, c, s, seed=1))
    want = dg.depthwise3x3_groupnorm_backward_reference(x, k, scale, bias, g, s)
    got = dg.banded_backward_reference(x, k, scale, bias, g, s, plan=plan)
    for name in (0, 2, 3):
        assert torch.equal(got[name], want[name]), name
    big = float(want[1].abs().max())
    assert float((got[1] - want[1]).abs().max()) <= chip_smoke.DWGN_F32_SUM_RTOL * big


@pytest.mark.parametrize("shape,forced", [((8, 8, 16, 1), None), ((9, 7, 16, 2), (16, 5, 4, 1, 1)),
                                          ((6, 6, 64, 1), (32, 6, 6, 1, 2))])
def test_dw_from_one_slice_falls_outside_the_limit(shape, forced):
    h, w, c, s = shape
    plan = _plan(h, w, c, s, forced)
    assert plan.slices > 1
    x, k, scale, bias, g = (torch.from_numpy(a) for a in _inputs(h, w, c, s, seed=2))
    want = dg.depthwise3x3_groupnorm_backward_reference(x, k, scale, bias, g, s)[1]
    wrong = dg.banded_backward_reference(x, k, scale, bias, g, s, plan=plan, dw_slices=[0])[1]
    outside = (wrong - want).abs() > chip_smoke.DWGN_F32_SUM_RTOL * want.abs().max()
    assert float(outside.float().mean()) > 0.5


@pytest.mark.parametrize("shape", STEP_SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_f32_backward_plan_is_its_own_least_cost(shape):
    plan = dg.dwgn_plan(*shape, True, 4)
    assert plan.slices * plan.images * plan.cc == dg.THREADS
    assert plan.smem == dg._smem_bytes(plan.cc, plan.rows, plan.cols, shape[3], True,
                                       plan.images, 4)
    # a resident plan within the target where one fits, else a streamed one
    # (the 112 px stage at C 32)
    candidates = (dg._f32_bwd_plans(*shape, dg.SMEM_TARGET[(True, 4)])
                  or dg._f32_bwd_plans(*shape, dg.SMEM_TARGET[(True, 4)], streamed=True))
    assert (plan.tiles_per_cta > 1) == (shape == (112, 112, 32, 1))
    assert plan in candidates and plan.smem <= dg.SMEM_TARGET[(True, 4)]
    assert dg.f32_bwd_cost(plan) == min(dg.f32_bwd_cost(p) for p in candidates)


def test_target_fits_the_kernels_ctas_an_sm():
    # the source's launch bounds and the plan's budget agree: F32_BWD_BLOCKS
    # CTAs of SMEM_TARGET bytes (and the runtime's 1 KB a CTA) fit an SM's
    # 228 KB of shared memory
    src = (build.CSRC / "depthwise_gn.cu").read_text()
    m = re.search(r"constexpr int kBlocks = (\d+);", src)
    assert m and int(m.group(1)) == dg.F32_BWD_BLOCKS
    assert dg.F32_BWD_BLOCKS * (dg.SMEM_TARGET[(True, 4)] + 1024) <= 228 * 1024
    assert "__launch_bounds__(kThreads, kBlocks) bwd_kernel" in src
    assert "DWGN_BWD_ENTRY(dftt_dwgn_bwd_f32, F32)" in src and "return f32bwd::kernel_of(cc);" in src
