"""Port parity: the arithmetic of the f32 fused attention backward's
split-precision TF32 kernel (``csrc/flash_attention_f32.cu``:
``split3::bwd_kernel`` and ``dq_sum_kernel``), through its plain mirror
``ops/flash_attention.py::flash_attention_fused_split_tf32_reference``.

- At B 1, H 2, S 256 and 300 (four of the kernel's 64-key blocks, and a
  ragged fifth; JAX takes its fused ``_dkvq_kernel`` at both, one KV block
  of its f32 tile), head dims 32 and 64, causal and not, on
  inputs made from one numpy seed with K and V around 1 (as
  ``chip_smoke.py`` draws them), the mirror's dQ, dK and dV against
  ``jax.grad`` of the JAX package's ``flash_attention_with_lse`` in f32
  (``_flash_backward`` in interpret mode), the port's autograd taking the
  mirror in place of its plain fused version. Tolerance: four times the
  first-order f32 error bound of the recipe for these inputs
  (``test_torch_flash_attention_split._f32_error_bound``), the bound with
  2**-22 in place of 2**-24: each term of a split product is within 3 *
  2**-22 of exact, under the n * 2**-22 the bound charges a sum of n >= 32
  terms.
- Against the port's plain f32 version, the limits the kernel is held to
  on the card: dK and dV within ``chip_smoke.TOL["flash_attention_bwd_f32"]``
  of the plain version, dQ within ``TOL["flash_attention_dq_f32_exact"]``
  of the recipe in f64 (``chip_smoke._dq_f64_recipe``), as
  ``chip_smoke.py``'s row ``flash_attention_bwd_f32`` holds them.
- One TF32 pass of the same products (``passes=1``) puts more than half of
  each gradient's elements outside those limits.
- A NaN in q, k or v reaches the mirror's gradients as it reaches the
  plain version's (dQ and dK always; dV for q and k: dV = P^T dO reads no
  V).
- The dQ partial slabs: the wrapper allocates one a block of
  ``FusedShape<D>::kWarps`` x 16 keys of the CUDA source, and the second
  pass's live range (``live_kv_blocks``) holds every block whose partial
  is not exactly zero.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from unittest import mock

import chip_smoke
from distriflow_tpu.ops.flash_attention import flash_attention_with_lse as jax_fa_lse
from distriflow_tpu_torch.ops import flash_attention as port_fa
from test_torch_flash_attention_split import _f32_error_bound

pytestmark = pytest.mark.port
torch.set_num_threads(2)

B, H = 1, 2
SPLIT_UNIT_FACTOR = 4  # 2**-22 / 2**-24
NAME, EXACT = "flash_attention_bwd_f32", "flash_attention_dq_f32_exact"
SOURCE = os.path.join(os.path.dirname(port_fa.__file__), "..", "csrc", "flash_attention_f32.cu")


def _inputs(s, d, causal, seed):
    """numpy q, k, v, dO (K and V around 1), an lse cotangent, and the
    port's f32 tensors with the forward's lse and delta (the cotangent
    folded in, as the port's autograd folds it)."""
    rng = np.random.RandomState(seed)
    arrs = [(rng.randn(B, H, s, d) + mean).astype(np.float32) for mean in (0.0, 1.0, 1.0, 0.0)]
    glse = rng.randn(B, H, s).astype(np.float32)
    q, k, v, do = (torch.from_numpy(a) for a in arrs)
    o, lse = port_fa.flash_attention_reference(q, k, v, causal)
    delta = (do * o).sum(-1) - torch.from_numpy(glse)
    return arrs, glse, (q, k, v, do, lse, delta, causal)


def _jax_grads(q, k, v, do, glse, causal):
    def f(q, k, v):
        o, lse = jax_fa_lse(q, k, v, causal, interpret=True)
        return jnp.sum(o * do) + jnp.sum(lse * glse)

    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(q, k, v)]


def _port_grads(q, k, v, do, glse, causal):
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    o, lse = port_fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    ((o * do).sum() + (lse * torch.from_numpy(glse)).sum()).backward()
    return [t.grad.numpy() for t in (q, k, v)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("s", [256, 300])
def test_mirror_matches_jax_fused_backward(s, d, causal):
    assert port_fa.bwd_layout(s, d, torch.float32) == "fused"
    arrs, glse, _ = _inputs(s, d, causal, seed=s + d + causal)
    ref = _jax_grads(*(jnp.asarray(a) for a in arrs), glse, causal)
    with mock.patch.object(port_fa, "flash_attention_backward_reference",
                           port_fa.flash_attention_fused_split_tf32_reference):
        ours = _port_grads(*(torch.from_numpy(a) for a in arrs), glse, causal)
    bound = _f32_error_bound(*arrs, glse, causal, True)
    for name, a, r, limit in zip(("dq", "dk", "dv"), ours, ref, bound):
        np.testing.assert_allclose(a, r, rtol=0, atol=SPLIT_UNIT_FACTOR * limit, err_msg=name)


def _outside(name, got, want):
    atol, rtol = chip_smoke.TOL[name]
    err = (got.double() - want.double()).abs()
    return float((err > atol + rtol * want.double().abs()).double().mean())


def _shares(args, passes):
    """Each gradient's share of elements outside its chip limit: dQ
    against the f64 recipe, dK and dV against the plain version."""
    got = port_fa.flash_attention_fused_split_tf32_reference(*args, passes=passes)
    want = port_fa.flash_attention_backward_reference(*args)
    exact = chip_smoke._dq_f64_recipe(*args)
    return {"dq": _outside(EXACT, got[0], exact), "dk": _outside(NAME, got[1], want[1]),
            "dv": _outside(NAME, got[2], want[2])}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 64])
def test_mirror_holds_the_chip_limits(d, causal):
    _, _, args = _inputs(300, d, causal, seed=10 + d + causal)
    assert _shares(args, 3) == {"dq": 0.0, "dk": 0.0, "dv": 0.0}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 64])
def test_one_tf32_pass_fails_the_chip_limits(d, causal):
    _, _, args = _inputs(300, d, causal, seed=10 + d + causal)
    shares = _shares(args, 1)
    assert all(x > 0.5 for x in shares.values()), shares


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_nan_reaches_the_gradients_as_in_the_plain_version(which):
    _, _, args = _inputs(300, 32, True, seed=5)
    q, k, v, do, lse, delta, causal = args
    t = {"q": q.clone(), "k": k.clone(), "v": v.clone()}
    t[which][0, 1, 150, 3] = float("nan")
    o, lse = port_fa.flash_attention_reference(t["q"], t["k"], t["v"], causal)
    nan_args = (t["q"], t["k"], t["v"], do, lse, (do * o).sum(-1), causal)
    got = port_fa.flash_attention_fused_split_tf32_reference(*nan_args)
    want = port_fa.flash_attention_backward_reference(*nan_args)
    reach = [bool(g.isnan().any()) for g in got]
    assert reach == [bool(w.isnan().any()) for w in want]
    assert reach == [True, True, which != "v"]


def _source_block(d):
    with open(SOURCE) as f:
        src = f.read()
    m = re.search(r"struct FusedShape<%d> \{\n  static constexpr int kWarps = (\d+), kRows = (\d+);"
                  % d, src)
    assert m, d
    assert "return causal && row / keys + 1 < n_kv ? row / keys + 1 : n_kv;" in src
    return 16 * int(m.group(1))


@pytest.mark.parametrize("d", [32, 64])
def test_partial_slabs_are_the_kernels_key_blocks(d):
    keys = _source_block(d)
    assert port_fa._F32_BWD_BLOCK_KV[d] == keys
    for s in (1, 37, 127, 128, 129, 300, 512, 1000, 2048):
        assert port_fa._dq_slabs(s, d, torch.float32) == -(-s // keys)
    # the partials past each row's live range (live_kv_blocks: the blocks
    # that start at or before the row, causal) hold only masked pairs
    for s, causal in ((300, True), (300, False), (512, True)):
        _, _, args = _inputs(s, d, causal, seed=s)
        _, ds = port_fa._probs_and_dscores(*args)
        n_kv = port_fa._dq_slabs(s, d, torch.float32)
        for row in range(s):
            live = min(row // keys + 1, n_kv) if causal else n_kv
            assert torch.equal(ds[..., row, live * keys:], torch.zeros_like(ds[..., row, live * keys:]))
