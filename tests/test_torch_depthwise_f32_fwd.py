"""The f32 depthwise forward's own design (kernel 11 in f32:
``csrc/depthwise_gn.cu`` namespace ``f32fwd``), on the CPU.

The kernel takes one channel a thread and a share of each tile's units
(one column of up to ``plan.strip`` rows each, numbered block by block);
its statistics are f64 sums by slice, the slices added in blocks over
neighbouring lanes and then a butterfly, then the cluster's ranks in
order; its plan is the least ``f32_fwd_cost`` among the resident plans
within its shared-memory target, the conv output kept or not (streamed
ones where none fits). The kernel runs only on the card; here:

- the banded mirror of that decomposition (``banded_forward_reference``),
  under the f32 forward's own plan and under forced plans of several
  slices, strips, images, tiles a CTA and ranks, against the JAX
  package's fused forward (the Pallas kernel in interpret mode) on the
  same numpy inputs, at atol 1e-5 + rtol 1e-5 (test_torch_depthwise_gn.py's
  f32 forward limit: jit contracts some multiply-adds into FMAs);
- the same mirror against the plain version, bit for bit;
- statistics from slice 0 alone, or from rank 0 alone, fall outside the
  f32 forward row's limit (``chip_smoke.TOL["depthwise_gn_fwd_f32"]``)
  for more than a tenth of y (the smoke's planted fault
  ``stats_from_slice0_only``);
- the plan: slices x images x channels is the CTA's threads at every step
  shape, its shared memory is ``_smem_bytes``' count, each step shape's
  plan is the least cost of its candidates, and the Python twins
  (``F32_FWD_BLOCKS``, ``SMEM_TARGET[(False, 4)]``, the entry's plan
  arguments) agree with the source.
"""

import re

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

# (h, w, c, stride, forced plan or None): the f32 forward's own plan, then
# (cc, rows, cols, cluster, images, strip, keep) forced: 32 slices over two
# ranks, strips of 2 and 3 rows, two and four images, the conv output kept
# and not, tiles of one row walked several a CTA (a streamed plan), columns
# cut in two
MIRROR_CASES = [
    ((8, 8, 16, 1), None), ((9, 7, 16, 2), None), ((6, 6, 64, 2), None), ((13, 13, 32, 1), None),
    ((8, 8, 16, 1), (8, 4, 8, 2, 1, 2, True)), ((9, 7, 16, 2), (16, 5, 4, 1, 1, 2, False)),
    ((6, 6, 64, 1), (32, 6, 6, 1, 2, 3, True)), ((3, 3, 32, 1), (32, 3, 3, 1, 4, 3, True)),
    ((7, 6, 16, 1), (16, 1, 6, 2, 1, 1, False)), ((13, 13, 32, 2), (8, 7, 4, 4, 1, 3, False)),
    ((11, 10, 24, 1), (8, 11, 5, 2, 1, 4, True))]


def _case_id(case):
    (h, w, c, s), forced = case
    return f"{h}-{w}-{c}-{s}-" + ("own" if forced is None else "-".join(map(str, forced)))


def _plan(h, w, c, s, forced):
    if forced is None:
        return dg.dwgn_plan(h, w, c, s, False, 4)
    cc, rows, cols, cluster, images, strip, keep = forced
    return dg.make_plan(h, w, c, s, False, cc, rows, cols, cluster, images, itemsize=4,
                        strip=strip, keep=keep)


def _inputs(h, w, c, stride, b=2, seed=0):
    """numpy inputs as test_torch_depthwise_gn.py draws them (f32)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, c).astype(np.float32)
    k = rng.randn(3, 3, 1, c).astype(np.float32)
    scale = (rng.randn(c) * 0.5 + 1.0).astype(np.float32)
    bias = (rng.randn(c) * 0.5 + 1.0).astype(np.float32)
    return x, k, scale, bias


@pytest.mark.parametrize("case", MIRROR_CASES, ids=_case_id)
def test_f32_forward_mirror_matches_jax(case):
    (h, w, c, s), forced = case
    plan = _plan(h, w, c, s, forced)
    x, k, scale, bias = _inputs(h, w, c, s)
    want = np.asarray(jax_dwgn(*(jnp.asarray(a) for a in (x, k, scale, bias)), s, 1e-6, 8, True,
                               True))
    got = dg.banded_forward_reference(*(torch.from_numpy(a) for a in (x, k, scale, bias)), s,
                                      plan=plan)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", MIRROR_CASES, ids=_case_id)
def test_f32_forward_mirror_is_the_plain_version(case):
    (h, w, c, s), forced = case
    plan = _plan(h, w, c, s, forced)
    x, k, scale, bias = (torch.from_numpy(a) for a in _inputs(h, w, c, s, seed=1))
    want = dg.depthwise3x3_groupnorm_reference(x, k, scale, bias, s)
    assert torch.equal(dg.banded_forward_reference(x, k, scale, bias, s, plan=plan), want)


@pytest.mark.parametrize("shape,forced,fault", [
    ((8, 8, 16, 1), None, "slice0"), ((9, 7, 16, 2), (16, 5, 4, 1, 1, 2, False), "slice0"),
    ((6, 6, 64, 1), (32, 6, 6, 1, 2, 3, True), "slice0"),
    ((8, 8, 16, 1), (8, 4, 8, 2, 1, 2, True), "rank0")])
def test_statistics_from_one_slice_or_rank_fall_outside_the_limit(shape, forced, fault):
    h, w, c, s = shape
    plan = _plan(h, w, c, s, forced)
    assert (plan.slices if fault == "slice0" else plan.cluster) > 1
    x, k, scale, bias = (torch.from_numpy(a) for a in _inputs(h, w, c, s, seed=2))
    want = dg.depthwise3x3_groupnorm_reference(x, k, scale, bias, s)
    wrong = dg.banded_forward_reference(x, k, scale, bias, s, plan=plan,
                                        **{"stats_slices" if fault == "slice0" else "stats_ranks":
                                           [0]})
    atol, rtol = chip_smoke.TOL["depthwise_gn_fwd_f32"]
    outside = (wrong - want).abs() > atol + rtol * want.abs()
    assert float(outside.float().mean()) > 0.1


@pytest.mark.parametrize("shape", STEP_SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_f32_forward_plan_is_its_own_least_cost(shape):
    plan = dg.dwgn_plan(*shape, False, 4)
    target = dg.SMEM_TARGET[(False, 4)]
    assert plan.slices * plan.images * plan.cc == dg.THREADS
    assert 1 <= plan.strip <= plan.rows and (not plan.keep or plan.tiles_per_cta == 1)
    assert plan.smem == dg._smem_bytes(plan.cc, plan.rows, plan.cols, shape[3], False,
                                       plan.images, 4, plan.keep)
    candidates = (dg._f32_fwd_plans(*shape, target)
                  or dg._f32_fwd_plans(*shape, target, streamed=True))
    assert plan in candidates and plan.smem <= target
    assert dg.f32_fwd_cost(plan) == min(dg.f32_fwd_cost(p) for p in candidates)


def test_twins_agree_with_the_source():
    # the source's launch bounds are the most CTAs an SM the plan's cost
    # counts on (F32_FWD_BLOCKS, four at 64 registers); two CTAs of
    # SMEM_TARGET bytes (and the runtime's 1 KB a CTA) fit an SM's 228 KB of
    # shared memory, four of the small plans' 56 KB; the f32 entry takes the
    # plan's strip and keep
    src = (build.CSRC / "depthwise_gn.cu").read_text()
    body = src.split("namespace f32fwd {")[1].split("}  // namespace f32fwd")[0]
    m = re.search(r"constexpr int kBlocks = (\d+);", body)
    assert m and int(m.group(1)) == dg.F32_FWD_BLOCKS == 4
    assert dg.SM_SMEM // (dg.SMEM_TARGET[(False, 4)] + 1024) == 2
    assert dg.SM_SMEM // (56 * 1024 + 1024) == dg.F32_FWD_BLOCKS
    assert "__launch_bounds__(kThreads, kBlocks) fwd_kernel" in body
    assert re.search(r'extern "C" int dftt_dwgn_fwd_f32\([^)]*int nb, int strip, int keep, int smem',
                     src)
    plan = dg.dwgn_plan(24, 24, 144, 1, False, 4)
    assert dg._plan_ints(plan)[-3:] == (plan.strip, int(plan.keep), plan.smem)
    assert len(dg._SIGNATURES["dftt_dwgn_fwd_f32"]) == len(dg._SIGNATURES["dftt_dwgn_fwd_bf16"]) + 2
