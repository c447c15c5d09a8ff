"""Port parity: prefill attention (``distriflow_tpu_torch/ops/flash_attention.py``).

The port's wrapper on CPU tensors runs its plain version, which follows the
CUDA kernel's numeric contract. It is held against the JAX Pallas kernel in
interpret mode and against ``blockwise_attention``, on inputs made from one
numpy seed, at a length that is not a multiple of 8.

Tolerances: f32 1e-4. Both sides run the same algorithm in f32 but sum
in orders chosen by their own CPU kernels (XLA's dot and reduction
emitters against torch's BLAS and vectorised reductions), and those
orders are not fixed from run to run: they follow the kernels' blocking
for the threads each library gets on a loaded machine. What f32 itself
guarantees is the bound of a sum of n terms, |error| <= n * 2**-24 *
sum(|terms|): for the scores, n = D = 32 products of unit normals
(sum |q k| ~ 25, scaled by 1/sqrt(32)) that is ~8e-6 on a score, which
moves p by that relative amount and o by ~8e-6 x |v| (|v| up to ~3), and
the softmax sums over S = 37 terms add ~7e-6 more; two sides at opposite
ends of that bound differ by up to ~6e-5 (one run measured 7e-5 against
a 1e-5 limit; typical runs differ by 6e-7). bf16 2e-2 (outputs round to
bf16, whose spacing near 1 is 2**-7 = 7.8e-3, and p is rounded to bf16
before the PV product on both sides).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distriflow_tpu.ops.flash_attention import flash_attention_with_lse
from distriflow_tpu.parallel.ring_attention import blockwise_attention
from distriflow_tpu_torch.ops import flash_attention as port_fa

pytestmark = pytest.mark.port
torch.set_num_threads(2)

B, H, S = 2, 2, 37
#: the kernel's head dims: the flagship's 64 and the speculative draft's 32
HEAD_DIMS = (32, 64)
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _inputs(dtype_name, d):
    rng = np.random.RandomState(0)
    arrs = [rng.randn(B, H, S, d).astype(np.float32) for _ in range(3)]
    jx = [jnp.asarray(a, dtype=getattr(jnp, dtype_name)) for a in arrs]
    # widen the rounded JAX values so both sides start from the same bits
    tt = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(getattr(torch, dtype_name))
          for a in jx]
    return jx, tt


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_prefill_matches_pallas_interpret(dtype_name, causal, d):
    (q, k, v), (tq, tk, tv) = _inputs(dtype_name, d)
    o_ref, lse_ref = flash_attention_with_lse(q, k, v, causal, interpret=True)
    o, lse = port_fa.flash_attention(tq, tk, tv, causal=causal, return_lse=True)
    assert o.dtype == tq.dtype and o.shape == (B, H, S, d)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, S)
    np.testing.assert_allclose(_np(o), _np(o_ref), rtol=0, atol=TOL[dtype_name])
    np.testing.assert_allclose(_np(lse), _np(lse_ref), rtol=0, atol=TOL[dtype_name])


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_prefill_matches_blockwise(dtype_name, causal, d):
    (q, k, v), (tq, tk, tv) = _inputs(dtype_name, d)
    ref = blockwise_attention(q, k, v, causal=causal)
    out = port_fa.flash_attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=0, atol=TOL[dtype_name])


def test_seq_gate_is_the_cards_shared_memory_rule():
    # any length tiles (edges are masked) and the kernel's shared memory
    # does not grow with S; it is built for bf16 and f32 at D 64 and 32
    for s in (1, 7, 37, 1000, 32_701):
        for d in HEAD_DIMS:
            assert port_fa.flash_seq_supported(s, d)
    assert not port_fa.flash_seq_supported(512, 128)
    assert not port_fa.flash_seq_supported(512, 16)
    assert port_fa.flash_seq_supported(512, 64, itemsize=4)  # the f32 kernel
    assert port_fa.flash_seq_supported(512, 32, itemsize=4)
    assert not port_fa.flash_seq_supported(512, 64, itemsize=1)
    assert not port_fa.flash_seq_supported(0, 64)
    assert port_fa.BWD_HEAD_DIMS == (32, 64)  # the backward at both head dims


def test_wrapper_refuses_devices_it_has_no_kernel_for():
    q = torch.empty(1, 1, 8, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        port_fa.flash_attention(q, q, q)
