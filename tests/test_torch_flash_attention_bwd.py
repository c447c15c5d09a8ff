"""Port parity: the flash attention backward
(``distriflow_tpu_torch/ops/flash_attention.py``).

On CPU tensors the port's differentiable ``flash_attention`` runs the
plain forward and :func:`flash_attention_backward_reference`, which follows
the CUDA kernel's numeric contract. Its gradients, taken through
``torch.autograd`` on the wrapper, are held against ``jax.grad`` of the JAX
package's ``flash_attention`` / ``flash_attention_with_lse`` with the
Pallas kernels in interpret mode, on inputs made from one numpy seed, at a
length that is not a multiple of 8, causal and not, with and without a
cotangent on the lse output.

Tolerances: f32 9.6e-4. Both sides run the same algorithm in f32 but sum
in orders chosen by their own CPU kernels, and those orders follow the
kernels' blocking for the threads each library gets on a loaded machine
(a loaded run once put dq past the earlier limit of 3e-5; typical runs
differ by 7.2e-7). What f32
itself guarantees is the bound of a sum of n terms, |error| <= n * 2**-24
* sum(|terms|): carried through the D = 32-term sums (the scores, dP and
delta) and the S = 37-term sums (lse, O, dQ, dK, dV), through P = exp(S -
lse) and dS = P (dP - delta), and doubled for two sides at opposite ends
of it, it comes to at most 4.0e-4 on dq, 9.6e-4 on dk and 2.2e-4 on dv
over these eight cases (computed by
``test_torch_flash_attention_split.py::test_f32_limits_cover_the_error_bound``).
bf16 0.016: both
sides round P and dS to bf16 before the products they feed, but from
scores summed in another order, so a rounding flip can move a gradient
element by one output step; gradients reach ~4 here, where one bf16 step
is 2**-6 = 0.016 (measured worst case 0.002).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distriflow_tpu.ops.flash_attention import flash_attention as jax_fa
from distriflow_tpu.ops.flash_attention import flash_attention_with_lse as jax_fa_lse
from distriflow_tpu_torch.ops import flash_attention as port_fa

pytestmark = pytest.mark.port
torch.set_num_threads(2)

B, H, S, D = 2, 2, 37, 32
TOL = {"float32": 9.6e-4, "bfloat16": 0.016}


def _inputs(dtype_name, seed=0):
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(B, H, S, D).astype(np.float32) for _ in range(4)]
    glse = rng.randn(B, H, S).astype(np.float32)
    jx = [jnp.asarray(a, dtype=getattr(jnp, dtype_name)) for a in arrs]
    # widen the rounded JAX values so both sides start from the same bits
    tt = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(getattr(torch, dtype_name))
          for a in jx]
    return jx, tt, glse


def _jax_grads(q, k, v, do, glse, causal, with_lse):
    def f(q, k, v):
        if with_lse:
            o, lse = jax_fa_lse(q, k, v, causal, interpret=True)
            return jnp.sum(o.astype(jnp.float32) * do.astype(jnp.float32)) + jnp.sum(lse * glse)
        o = jax_fa(q, k, v, causal, interpret=True)
        return jnp.sum(o.astype(jnp.float32) * do.astype(jnp.float32))

    return [np.asarray(g.astype(jnp.float32)) for g in jax.grad(f, argnums=(0, 1, 2))(q, k, v)]


def _port_grads(q, k, v, do, glse, causal, with_lse):
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    if with_lse:
        o, lse = port_fa.flash_attention(q, k, v, causal=causal, return_lse=True)
        loss = (o.float() * do.float()).sum() + (lse * torch.from_numpy(glse)).sum()
    else:
        o = port_fa.flash_attention(q, k, v, causal=causal)
        loss = (o.float() * do.float()).sum()
    loss.backward()
    for t in (q, k, v):
        assert t.grad.dtype == q.dtype and t.grad.shape == q.shape
    return [t.grad.float().numpy() for t in (q, k, v)]


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_plain_backward_matches_jax_grad_interpret(dtype_name, causal, with_lse):
    (q, k, v, do), (tq, tk, tv, tdo), glse = _inputs(dtype_name)
    ref = _jax_grads(q, k, v, do, glse, causal, with_lse)
    ours = _port_grads(tq, tk, tv, tdo, glse, causal, with_lse)
    for name, a, r in zip(("dq", "dk", "dv"), ours, ref):
        np.testing.assert_allclose(a, r, rtol=0, atol=TOL[dtype_name], err_msg=name)


def test_backward_reference_is_the_autograd_of_plain_attention():
    """At f32 the kernel's contract has no rounding, so its plain version
    equals autograd through the plain forward."""
    (_, _, _, _), (q, k, v, do), glse = _inputs("float32", seed=3)
    o, lse = port_fa.flash_attention_reference(q, k, v, True)
    delta = (do * o).sum(-1) - torch.from_numpy(glse)
    got = port_fa.flash_attention_backward_reference(q, k, v, do, lse, delta, True)
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    oa, lsea = port_fa.flash_attention_reference(qa, ka, va, True)
    ((oa * do).sum() + (lsea * torch.from_numpy(glse)).sum()).backward()
    for a, r in zip(got, (qa.grad, ka.grad, va.grad)):
        torch.testing.assert_close(a, r, rtol=0, atol=3e-5)


def test_no_grad_forward_skips_autograd():
    """Serving runs under no_grad: the forward is called with no autograd
    node around it."""
    (_, _, _, _), (q, k, v, _), _ = _inputs("bfloat16")
    q.requires_grad_()
    with torch.no_grad():
        o = port_fa.flash_attention(q, k, v)
    assert o.grad_fn is None and not o.requires_grad
    assert port_fa.flash_attention(q, k, v).grad_fn is not None


def test_backward_wrapper_refuses_devices_it_has_no_kernel_for():
    q = torch.empty(1, 1, 8, 64, dtype=torch.bfloat16, device="meta")
    lse = torch.empty(1, 1, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        port_fa.flash_attention_backward(q, q, q, q, lse, lse)
