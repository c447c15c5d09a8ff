"""Port parity: the arithmetic of the f32 two-kernel backward's
split-precision TF32 kernels (``csrc/flash_attention_f32.cu``:
``dq_kernel`` and ``dkv_kernel``), through their plain mirror
``ops/flash_attention.py::flash_attention_split_tf32_reference``.

- ``_tf32_rna`` rounds as ``cvt.rna.tf32.f32`` does: to 10 mantissa bits,
  to nearest with ties away from zero, on the f32 bits (hand-picked ties,
  and an integer model of the rounding on random bit patterns).
- The split ``big = tf32(x)``, ``small = tf32(x - big)`` gives two TF32
  values (13 low bits clear) whose sum holds x to 2**-22 of ``|x|``.
- At B 1, H 2, S 200 (a ragged last tile for the kernels' 64 keys or
  queries and 128 rows), head dims 32 and 64, causal and not, on inputs
  made from one numpy seed with K and V around 1 (as ``chip_smoke.py``
  draws them), the mirror's dQ, dK and dV:
  - against ``jax.grad`` of the JAX package's ``flash_attention_with_lse``
    in f32 with its backward tiles pinned at 8 (25 KV blocks: JAX's
    ``_dq_kernel`` and ``_dkv_kernel`` in interpret mode, as
    ``test_torch_flash_attention_split.py`` runs them), the port's
    autograd taking the mirror in place of its plain dQ and dK/dV
    versions. Tolerance: four times that file's first-order f32 error
    bound (``_f32_error_bound``) for these inputs. The bound is linear in
    the unit roundoff, so this is the bound with 2**-22 in place of
    2**-24; a split product's every term is within 3 * 2**-22 of exact
    (2**-22 for each operand's split, 2**-22 for the dropped
    small * small term), under the n * 2**-22 that the bound charges a sum
    of n >= 32 terms.
  - against the port's plain f32 versions within ``chip_smoke.py``'s f32
    limits for these kernels (``TOL["flash_attention_dq_f32"]``,
    ``TOL["flash_attention_dkv_f32"]``), the limits the kernels are held
    to on the card.
  - one TF32 pass of the same products (``passes=1``) puts most elements
    of each gradient outside those limits (more than half; 61-97% here),
    which is why the kernels take three.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from unittest import mock

import chip_smoke
from distriflow_tpu_torch.ops import flash_attention as port_fa
from test_torch_flash_attention_split import BLOCK as SPLIT_BLOCK
from test_torch_flash_attention_split import _f32_error_bound, _jax_grads, _port_grads

pytestmark = pytest.mark.port
torch.set_num_threads(2)

B, H, S = 1, 2, 200
BLOCK = SPLIT_BLOCK  # JAX's backward tile, 8: 25 KV blocks, the two-kernel layout
LIMITS = {"dq": chip_smoke.TOL["flash_attention_dq_f32"],
          "dk": chip_smoke.TOL["flash_attention_dkv_f32"],
          "dv": chip_smoke.TOL["flash_attention_dkv_f32"]}
SPLIT_UNIT_FACTOR = 4  # 2**-22 / 2**-24


def _cvt_rna_model(bits: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32 on int32 f32 bit patterns, in integers: add half of
    the 13 dropped bits' weight to the magnitude, clear them, keep the
    sign."""
    b = bits.astype(np.int64) & 0xFFFFFFFF
    mag = ((b & 0x7FFFFFFF) + (1 << 12)) & ~0x1FFF
    return ((b & 0x80000000) | mag).astype(np.uint32).view(np.int32)


def test_tf32_rounding_is_cvt_rna():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -11 - 2 ** -23,
                      2.5, -0.0, 3.0e38], dtype=torch.float32)
    want = [1.0, 1 + 2 ** -10, 1 + 2 ** -9, -(1 + 2 ** -10), 1.0, 2.5, -0.0, 3.0e38]
    got = port_fa._tf32_rna(x)
    assert got[:6].tolist() == want[:6]
    assert got[6].item() == 0.0 and torch.signbit(got[6])
    assert got[7].item() == pytest.approx(want[7], rel=2 ** -10)
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 0x7F000000, 4096, dtype=np.int64).astype(np.int32)
    bits[::2] |= np.int32(-0x80000000)
    vals = torch.from_numpy(bits.view(np.float32).copy())
    np.testing.assert_array_equal(port_fa._tf32_rna(vals).numpy().view(np.int32),
                                  _cvt_rna_model(bits))


def test_split_holds_f32_to_two_pow_minus_22():
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.standard_normal(20000) * 10.0 ** rng.integers(-6, 6, 20000))
                         .astype(np.float32))
    big = port_fa._tf32_rna(x)
    small = port_fa._tf32_rna(x - big)
    for part in (big, small):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    resid = (x.double() - big.double() - small.double()).abs()
    assert bool((resid <= 2.0 ** -22 * x.double().abs()).all())


def _inputs(d, causal, seed):
    """numpy q, k, v, dO (K and V around 1), an lse cotangent, and the
    port's f32 tensors with the forward's lse and delta (the cotangent
    folded in, as the port's autograd folds it)."""
    rng = np.random.RandomState(seed)
    arrs = [(rng.randn(B, H, S, d) + mean).astype(np.float32) for mean in (0.0, 1.0, 1.0, 0.0)]
    glse = rng.randn(B, H, S).astype(np.float32)
    q, k, v, do = (torch.from_numpy(a) for a in arrs)
    o, lse = port_fa.flash_attention_reference(q, k, v, causal)
    delta = (do * o).sum(-1) - torch.from_numpy(glse)
    return arrs, glse, (q, k, v, do, lse, delta, causal)


def _mirror(passes):
    def dq(*a):
        return port_fa.flash_attention_split_tf32_reference(*a, passes=passes)[0]

    def dkv(*a):
        return port_fa.flash_attention_split_tf32_reference(*a, passes=passes)[1:]

    return dq, dkv


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 64])
def test_mirror_matches_jax_two_kernel_backward(d, causal):
    assert port_fa.bwd_layout(S, d, torch.float32, BLOCK) == "split"
    arrs, glse, _ = _inputs(d, causal, seed=d + causal)
    jx = [jnp.asarray(a) for a in arrs]
    ref = _jax_grads(*jx, glse, causal, True)
    dq, dkv = _mirror(3)
    tt = [torch.from_numpy(a) for a in arrs]
    # that file's helpers pin the same tiles (its BLOCK is 8)
    with mock.patch.object(port_fa, "flash_attention_dq_reference", dq), \
            mock.patch.object(port_fa, "flash_attention_dkv_reference", dkv):
        ours = _port_grads(*tt, glse, causal, True)
    bound = _f32_error_bound(*arrs, glse, causal, True)
    for name, a, r, limit in zip(("dq", "dk", "dv"), ours, ref, bound):
        np.testing.assert_allclose(a, r, rtol=0, atol=SPLIT_UNIT_FACTOR * limit, err_msg=name)


def _outside(got, want, limit):
    atol, rtol = limit
    err = (got.double() - want.double()).abs()
    return float((err > atol + rtol * want.double().abs()).double().mean())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 64])
def test_mirror_holds_the_chip_limits_of_the_plain_version(d, causal):
    _, _, args = _inputs(d, causal, seed=10 + d + causal)
    want = (port_fa.flash_attention_dq_reference(*args),
            *port_fa.flash_attention_dkv_reference(*args))
    got = port_fa.flash_attention_split_tf32_reference(*args)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32 and a.shape == w.shape
        assert _outside(a, w, LIMITS[name]) == 0.0, name


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 64])
def test_one_tf32_pass_fails_the_chip_limits(d, causal):
    _, _, args = _inputs(d, causal, seed=10 + d + causal)
    want = (port_fa.flash_attention_dq_reference(*args),
            *port_fa.flash_attention_dkv_reference(*args))
    one = port_fa.flash_attention_split_tf32_reference(*args, passes=1)
    for name, a, w in zip(("dq", "dk", "dv"), one, want):
        assert _outside(a, w, LIMITS[name]) > 0.5, name
