"""Port parity: the arithmetic of the f32 attention forward's
split-precision TF32 kernel (``csrc/flash_attention_f32.cu``:
``fwd_kernel``), through its plain mirror
``ops/flash_attention.py::flash_attention_forward_split_tf32_reference``
(both products, S = Q K^T and P V, as three TF32 products each).

At B 1, H 2, S 200 (a ragged last tile for the kernel's 64 keys and 128
rows), head dims 32 and 64, causal and not, on inputs made from one numpy
seed, the mirror's O and lse:

- against the JAX package's f32 ``flash_attention_with_lse`` with Pallas
  in interpret mode (JAX's ``_fwd_kernel``, its tiles pinned at 40: five
  KV blocks, so its online rescale runs). Tolerance: the first-order f32
  error bound of the forward recipe for these inputs
  (:func:`_f32_forward_error_bound`, the forward half of
  ``test_torch_flash_attention_split.py::_f32_error_bound``: every sum of
  n terms off by at most n u sum(|terms|), carried through P = exp(S - m)
  and O = P V / l, doubled for two sides) with u = 2**-22 in place of
  2**-24. A split product's every term is within 3 * 2**-22 of exact
  (2**-22 for each operand's split, 2**-22 for the dropped small * small
  term), under the n u that the bound charges a sum of n >= 32 terms.
- against the port's plain f32 forward within ``chip_smoke.py``'s f32
  forward limit (``TOL["flash_attention_fwd_f32"]``), the limit the kernel
  is held to on the card.
- one TF32 pass of the same products (``passes=1``) puts more than half
  of O's elements outside that limit, which is why the kernel takes three.

A NaN survives the split: ``_tf32_rna`` leaves a NaN or an infinity as it
is (the rounding's carry would make a NaN a zero or an infinity), and a NaN
in q, k or v reaches the same outputs of the forward's and the two-kernel
backward's mirrors as of the plain versions (``chip_smoke._nan_check``,
the check the kernels meet on the card).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from distriflow_tpu.ops.flash_attention import flash_attention_with_lse as jax_fa_lse
from distriflow_tpu_torch.ops import flash_attention as port_fa

pytestmark = pytest.mark.port
torch.set_num_threads(2)

B, H, S = 1, 2, 200
BLOCK = 40  # JAX's forward tiles: 5 KV blocks at S 200
LIMIT = chip_smoke.TOL["flash_attention_fwd_f32"]
SPLIT_UNIT = 2.0 ** -22


def _arrays(d, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, H, S, d).astype(np.float32) for _ in range(3)]


def _f32_forward_error_bound(q, k, v, causal, u):
    """Twice the first-order error bound of the forward recipe at unit
    roundoff ``u``, the largest element of O and of lse."""
    _, _, s, d = q.shape
    sc = 1 / np.sqrt(d)
    q, k, v = (np.asarray(a, np.float64) for a in (q, k, v))
    keep = np.tril(np.ones((s, s), bool)) if causal else np.ones((s, s), bool)
    sco = np.where(keep, np.einsum("bhid,bhjd->bhij", q, k) * sc, -np.inf)
    e_s = np.where(keep, sc * d * u * np.einsum("bhid,bhjd->bhij", np.abs(q), np.abs(k)), 0.0)
    m = sco.max(-1, keepdims=True)
    p = np.exp(sco - m)
    lse = m[..., 0] + np.log(p.sum(-1))
    p /= p.sum(-1, keepdims=True)
    e_p = p * (e_s + (p * e_s).sum(-1, keepdims=True) + s * u + u)
    e_o = (np.einsum("bhij,bhjd->bhid", e_p, np.abs(v))
           + s * u * np.einsum("bhij,bhjd->bhid", p, np.abs(v)))
    e_lse = (p * e_s).sum(-1) + s * u + u + u * np.abs(lse)
    return 2 * float(e_o.max()), 2 * float(e_lse.max())


def _outside(got, want, limit):
    atol, rtol = limit
    err = (got.double() - want.double()).abs()
    return float((err > atol + rtol * want.double().abs()).double().mean())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 64])
def test_mirror_matches_jax_forward(d, causal):
    arrs = _arrays(d, seed=d + causal)
    o_ref, lse_ref = jax_fa_lse(*(jnp.asarray(a) for a in arrs), causal, block_q=BLOCK,
                                block_k=BLOCK, interpret=True)
    o, lse = port_fa.flash_attention_forward_split_tf32_reference(
        *(torch.from_numpy(a) for a in arrs), causal)
    assert o.dtype == lse.dtype == torch.float32
    assert o.shape == (B, H, S, d) and lse.shape == (B, H, S)
    bound_o, bound_lse = _f32_forward_error_bound(*arrs, causal, SPLIT_UNIT)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=0, atol=bound_o)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), rtol=0, atol=bound_lse)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 64])
def test_mirror_holds_the_chip_limit_of_the_plain_version(d, causal):
    q, k, v = (torch.from_numpy(a) for a in _arrays(d, seed=10 + d + causal))
    want = port_fa.flash_attention_reference(q, k, v, causal)
    got = port_fa.flash_attention_forward_split_tf32_reference(q, k, v, causal)
    for name, a, w in zip(("o", "lse"), got, want):
        assert _outside(a, w, LIMIT) == 0.0, name


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 64])
def test_one_tf32_pass_fails_the_chip_limit(d, causal):
    q, k, v = (torch.from_numpy(a) for a in _arrays(d, seed=10 + d + causal))
    want, _ = port_fa.flash_attention_reference(q, k, v, causal)
    one, _ = port_fa.flash_attention_forward_split_tf32_reference(q, k, v, causal, passes=1)
    assert _outside(one, want, LIMIT) > 0.5


def test_tf32_rounding_keeps_nan_and_infinity():
    bits = torch.tensor([0x7FFFFFFF, -1, 0x7FC00000, 0x7F800001, 0x7FFFF000, 0x7F800000,
                         -0x800000], dtype=torch.int32)  # NaNs, then +inf, -inf
    x = bits.view(torch.float32)
    big = port_fa._tf32_rna(x)
    assert torch.equal(big.view(torch.int32), bits)
    assert bool(port_fa._tf32_rna(x - big)[:5].isnan().all())


@pytest.mark.parametrize("d", [32, 64])
def test_nan_input_reaches_the_outputs(d):
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(d, seed=30 + d) + _arrays(d, seed=40)[:1])

    def mirror_bwd(*a):
        return port_fa.flash_attention_split_tf32_reference(*a, True)

    def plain_bwd(*a):
        return (port_fa.flash_attention_dq_reference(*a, True),
                *port_fa.flash_attention_dkv_reference(*a, True))

    reached = chip_smoke._nan_check(
        f"mirrors D={d}", lambda *a: port_fa.flash_attention_forward_split_tf32_reference(*a, True),
        mirror_bwd, lambda *a: port_fa.flash_attention_reference(*a, True), plain_bwd, q, k, v, do)
    # dV = P^T dO and lse do not read V
    assert reached == {"q": list(chip_smoke.NAN_OUTPUTS), "k": list(chip_smoke.NAN_OUTPUTS),
                       "v": ["o", "dq", "dk"]}
