"""Port parity: the fused depthwise-3x3 + GroupNorm + ReLU6
(``distriflow_tpu_torch/ops/depthwise_gn.py``).

On CPU tensors the port runs the kernels' plain versions through its
``autograd.Function``. They are held against the JAX package's
``depthwise3x3_groupnorm`` (the Pallas kernel in interpret mode) and
``jax.vjp`` through it, on the same numpy inputs.

Tolerances:
- forward f32: atol 1e-5 + rtol 1e-5 (the same arithmetic; jit contracts
  some multiply-adds into FMAs, measured 9.5e-7); bf16: one output step,
  2**-7 of the reference plus 1e-6 (the products and sums round to bf16 at
  the same places on both sides; measured equal).
- backward f32: rtol 1e-4 with atol 1e-4 of the tensor's largest element
  (sums in another order; measured 2e-7 of the largest). bf16: dx one
  output step (the cotangent and the nine taps round where jax.vjp rounds
  them, measured equal); dscale and dbias rtol 1e-4 (f32 sums); dw within
  2**-5 of its largest element: the interpreter adds each batch element's
  dw over the positions in bf16 one term at a time, the port rounds the
  exact sum of the rounded products once (measured 0.7%).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from distriflow_tpu.ops.depthwise_gn import (
    depthwise3x3_groupnorm as jax_dwgn,
    depthwise_gn_supported as jax_supported,
)
from distriflow_tpu_torch.obs.telemetry import get_telemetry
from distriflow_tpu_torch.ops import depthwise_gn as port

pytestmark = pytest.mark.port
torch.set_num_threads(2)


def _inputs(dtype_name, h, w, c, stride, b=2, tie=None, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, c).astype(np.float32)
    k = rng.randn(3, 3, 1, c).astype(np.float32)
    scale = (rng.randn(c) * 0.5 + 1.0).astype(np.float32)
    bias = (rng.randn(c) * 0.5 + 1.0).astype(np.float32)
    if tie is not None:  # every output lands exactly on a ReLU6 bound
        scale[:], bias[:] = 0.0, tie
    _, _, oh, ow = port._geometry(h, w, stride)
    g = rng.randn(b, oh, ow, c).astype(np.float32)
    jd = getattr(jnp, dtype_name)
    jx, jk, jg = jnp.asarray(x, jd), jnp.asarray(k, jd), jnp.asarray(g, jd)

    def t(a):  # the JAX-rounded values, so both sides start from the same bits
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(getattr(torch, dtype_name))

    return (jx, jk, jnp.asarray(scale), jnp.asarray(bias), jg), \
        (t(jx), t(jk), torch.from_numpy(scale), torch.from_numpy(bias), t(jg))


def _np(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a.astype(jnp.float32))


@pytest.mark.parametrize("dtype_name,stride,h,w,c,relu6", [
    ("float32", 1, 8, 8, 16, True),
    ("float32", 2, 8, 8, 16, True),
    ("float32", 2, 9, 7, 16, True),
    ("float32", 1, 7, 9, 24, False),
    ("float32", 1, 4, 4, 1024, True),  # two JAX channel blocks of 512
    ("bfloat16", 1, 8, 8, 16, True),
    ("bfloat16", 2, 9, 7, 16, True),
    ("bfloat16", 2, 8, 8, 16, False),
])
def test_forward_matches_pallas_interpret(dtype_name, stride, h, w, c, relu6):
    (jx, jk, js, jb, _), (tx, tk, ts, tb, _) = _inputs(dtype_name, h, w, c, stride)
    want = _np(jax_dwgn(jx, jk, js, jb, stride, 1e-6, 8, relu6, True))
    before = port.depthwise_gn_forward.launches
    got = port.depthwise3x3_groupnorm(tx, tk, ts, tb, stride, 1e-6, 8, relu6)
    assert port.depthwise_gn_forward.launches == before  # CPU: the plain version, no launch
    assert got.dtype == tx.dtype and got.shape == want.shape
    if dtype_name == "float32":
        np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(_np(got), want, rtol=2 ** -7, atol=1e-6)


def _grads(dtype_name, stride, h, w, c, tie=None, relu6=True):
    (jx, jk, js, jb, jg), (tx, tk, ts, tb, tg) = _inputs(dtype_name, h, w, c, stride, tie=tie)
    _, vjp = jax.vjp(lambda *a: jax_dwgn(*a, stride, 1e-6, 8, relu6, True), jx, jk, js, jb)
    want = [_np(a) for a in vjp(jg)]
    leaves = [t.clone().requires_grad_() for t in (tx, tk, ts, tb)]
    out = port.depthwise3x3_groupnorm(*leaves, stride, 1e-6, 8, relu6)
    got = torch.autograd.grad(out, leaves, tg)
    for a, t in zip(got, (tx, tk, ts, tb)):
        assert a.dtype == t.dtype and a.shape == t.shape
    return [_np(a) for a in got], want, tg


@pytest.mark.parametrize("dtype_name,stride,h,w,relu6", [
    ("float32", 1, 8, 8, True),
    ("float32", 2, 9, 7, True),
    ("float32", 2, 8, 8, False),
    ("bfloat16", 1, 8, 8, True),
    ("bfloat16", 2, 9, 7, True),
])
def test_backward_matches_jax_vjp(dtype_name, stride, h, w, relu6):
    got, want, _ = _grads(dtype_name, stride, h, w, 16, relu6=relu6)
    for name, a, r in zip(("dx", "dw", "dscale", "dbias"), got, want):
        big = np.abs(r).max()
        if dtype_name == "float32" or name in ("dscale", "dbias"):
            np.testing.assert_allclose(a, r, rtol=1e-4, atol=1e-4 * big, err_msg=name)
        elif name == "dx":
            np.testing.assert_allclose(a, r, rtol=2 ** -7, atol=1e-6, err_msg=name)
        else:
            assert np.abs(a - r).max() <= 2 ** -5 * big, name


@pytest.mark.parametrize("bias", [0.0, 6.0])
def test_relu6_tie_passes_half_the_gradient(bias):
    # scale 0: every output is exactly the bias, on a ReLU6 bound, where
    # jax.grad of min(max(y, 0), 6) passes 0.5 of the gradient
    got, want, g = _grads("float32", 1, 8, 8, 16, tie=bias)
    for a, r in zip(got, want):
        np.testing.assert_allclose(a, r, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[3], 0.5 * g.sum(dim=(0, 1, 2)).numpy(), rtol=1e-5)
    assert not np.any(got[0]) and not np.any(got[1])  # scale 0: nothing reaches x or w
    # the unfused composition (mobilenet.py's gated branch) ends in F.relu6,
    # whose gradient at the bounds is 0
    (_, _, _, _, _), (tx, tk, ts, tb, tg) = _inputs("float32", 8, 8, 16, 1, tie=bias)
    tb = tb.clone().requires_grad_()
    from distriflow_tpu_torch.models.mobilenet import _onepass_gn_affine

    y = F.relu6(_onepass_gn_affine(port.depthwise3x3(tx, tk.reshape(3, 3, 16), 1), ts, tb))
    (db,) = torch.autograd.grad(y, tb, tg)
    assert not db.any()


# (h, w, c, stride, itemsize): the model's 96 px stages, the 112x112 stages
# at 224 px (32 channels fit the reference's VMEM estimate, 96 do not), a
# sliver, a channel count off the group size, stride 3, empty dims
GATE_SHAPES = [
    (48, 48, 32, 1, 2), (48, 48, 96, 2, 2), (24, 24, 144, 1, 2), (3, 3, 960, 1, 2),
    (112, 112, 32, 1, 2), (112, 112, 96, 1, 2), (112, 112, 96, 1, 4), (56, 56, 144, 1, 4),
    (8, 8, 4, 1, 4), (8, 8, 12, 1, 4), (8, 8, 16, 3, 4), (0, 5, 8, 1, 4), (1, 1, 8, 2, 4),
]


def test_gate_equals_jax_and_counts_gated_shapes():
    tel = get_telemetry()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for h, w, c, s, item in GATE_SHAPES:
            before = tel.total("ops_depthwise_gn_gated_total")
            ok = port.depthwise_gn_supported(h, w, c, s, itemsize=item)
            assert ok == jax_supported(h, w, c, s, itemsize=item), (h, w, c, s, item)
            assert tel.total("ops_depthwise_gn_gated_total") == before + (0 if ok else 1)
    assert not port.depthwise_gn_supported(112, 112, 96, 1, itemsize=2)
    assert port.depthwise_gn_supported(112, 112, 32, 1, itemsize=2)
    # warn once per shape
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        port.depthwise_gn_supported(13, 11, 20, 1)
        port.depthwise_gn_supported(13, 11, 20, 1)
    assert len(rec) == 1 and "gated off" in str(rec[0].message)
