"""Port parity: the two-kernel attention backward and its layout gate
(``distriflow_tpu_torch/ops/flash_attention.py``).

- The gate: the port's :func:`bwd_layout` takes the fused backward exactly
  where JAX's ``_bwd_autotune`` plus ``_FUSED_BWD_MAX_KV_BLOCKS`` do, on a
  fixed list of lengths around the switch (bf16 switches above S 8192;
  16001 has no aligned divisor, so JAX takes one whole block and the
  fused kernel; f32 switches above S 2048).
- The plain versions of the dQ and dK/dV kernels, through autograd on the
  port's ``flash_attention`` with ``bwd_block_q=bwd_block_k=8`` at S 96
  (12 KV blocks: the two-kernel layout on both sides), held against
  ``jax.grad`` of the JAX package's ``flash_attention`` /
  ``flash_attention_with_lse`` with the same pinned blocks, Pallas in
  interpret mode (JAX's ``_dq_kernel`` and ``_dkv_kernel``), on inputs
  made from one numpy seed, causal and not, with and without a cotangent
  on the lse output.
- f32 in the two-kernel layout (the CUDA ``dq_kernel`` and ``dkv_kernel``
  of ``csrc/flash_attention_f32.cu``, the JAX LM CLI's ``--dtype float32
  --seq 16384``) at head dims 32 and 64, ``bwd_block_k`` pinned to 8 so
  that S 96 takes it: the dQ and dK/dV wrappers' plain versions against
  JAX's f32 ``_dq_kernel``/``_dkv_kernel`` in interpret mode, each
  gradient element within the first-order f32 error bound of the recipe
  computed for these very inputs (:func:`_f32_error_bound`).
- The dispatcher calls the dQ and dK/dV wrappers exactly when the gate
  says so, and the fused wrapper otherwise.

Tolerances. f32 2.1e-3: both sides run the same recipe in f32 and sum in
orders their CPU kernels choose. The first-order f32 error bound of that
recipe, with each sum of n terms off by at most n * 2**-24 * sum(|terms|)
(the D-term sums of S, dP and delta, the S-term sums of lse, O, dQ, dK and
dV), carried through P = exp(S - lse) and dS = P (dP - delta), and doubled
for two sides at opposite ends of it, is at most 9.9e-4 on dQ, 2.1e-3 on
dK and 3.4e-4 on dV over these eight cases (measured 2.1e-6;
:func:`_f32_error_bound` computes the bound, here and for the fused
backward's test at S 37, whose limit of 9.6e-4 it also derives). bf16 0.016:
both sides round P and dS to bf16 before the products they feed, but from
scores summed in another order, so a rounding flip can move a gradient
element by one output step; gradients reach ~4 here, where one bf16 step
is 2**-6 = 0.016 (measured 0.002).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from unittest import mock

from distriflow_tpu.ops.flash_attention import flash_attention as jax_fa
from distriflow_tpu.ops.flash_attention import flash_attention_with_lse as jax_fa_lse
from distriflow_tpu_torch.ops import flash_attention as port_fa

pytestmark = pytest.mark.port
torch.set_num_threads(2)

B, H, S, D = 2, 2, 96, 32
BLOCK = 8  # 12 KV blocks: past the fused backward's 8
TOL = {"float32": 2.1e-3, "bfloat16": 0.016}


def _jax_layout(s, dtype_name):
    import importlib

    jfa = importlib.import_module("distriflow_tpu.ops.flash_attention")
    _, bk = jfa._bwd_autotune(s, 64, getattr(jnp, dtype_name))
    return "fused" if s // bk <= jfa._FUSED_BWD_MAX_KV_BLOCKS else "split"


@pytest.mark.parametrize("s,dtype_name,want", [
    (1024, "bfloat16", "fused"), (8192, "bfloat16", "fused"), (8200, "bfloat16", "split"),
    (9216, "bfloat16", "split"), (16000, "bfloat16", "split"), (16001, "bfloat16", "fused"),
    (16384, "bfloat16", "split"), (2048, "float32", "fused"), (2304, "float32", "split"),
])
def test_layout_gate_matches_jax(s, dtype_name, want):
    assert _jax_layout(s, dtype_name) == want
    assert port_fa.bwd_layout(s, 64, getattr(torch, dtype_name)) == want


def test_pinned_blocks_choose_the_layout_as_in_jax():
    import importlib

    jfa = importlib.import_module("distriflow_tpu.ops.flash_attention")
    for s, blk in ((96, 8), (96, 12), (96, 16), (1024, 64), (1024, 128)):
        bk = jfa._aligned_block(s, min(blk, jfa._BWD_BLOCK_CAP))
        want = "fused" if s // bk <= jfa._FUSED_BWD_MAX_KV_BLOCKS else "split"
        assert port_fa.bwd_layout(s, D, torch.bfloat16, bwd_block_k=blk) == want, (s, blk)


def _inputs(dtype_name, seed=0, d=D):
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(B, H, S, d).astype(np.float32) for _ in range(4)]
    glse = rng.randn(B, H, S).astype(np.float32)
    jx = [jnp.asarray(a, dtype=getattr(jnp, dtype_name)) for a in arrs]
    # widen the rounded JAX values so both sides start from the same bits
    tt = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(getattr(torch, dtype_name))
          for a in jx]
    return jx, tt, glse


def _jax_grads(q, k, v, do, glse, causal, with_lse):
    blocks = dict(interpret=True, bwd_block_q=BLOCK, bwd_block_k=BLOCK)

    def f(q, k, v):
        if with_lse:
            o, lse = jax_fa_lse(q, k, v, causal, **blocks)
            return jnp.sum(o.astype(jnp.float32) * do.astype(jnp.float32)) + jnp.sum(lse * glse)
        o = jax_fa(q, k, v, causal, **blocks)
        return jnp.sum(o.astype(jnp.float32) * do.astype(jnp.float32))

    return [np.asarray(g.astype(jnp.float32)) for g in jax.grad(f, argnums=(0, 1, 2))(q, k, v)]


def _port_grads(q, k, v, do, glse, causal, with_lse):
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    blocks = dict(bwd_block_q=BLOCK, bwd_block_k=BLOCK)
    if with_lse:
        o, lse = port_fa.flash_attention(q, k, v, causal=causal, return_lse=True, **blocks)
        loss = (o.float() * do.float()).sum() + (lse * torch.from_numpy(glse)).sum()
    else:
        o = port_fa.flash_attention(q, k, v, causal=causal, **blocks)
        loss = (o.float() * do.float()).sum()
    loss.backward()
    for t in (q, k, v):
        assert t.grad.dtype == q.dtype and t.grad.shape == q.shape
    return [t.grad.float().numpy() for t in (q, k, v)]


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_two_kernel_plain_backward_matches_jax_grad_interpret(dtype_name, causal, with_lse):
    assert port_fa.bwd_layout(S, D, getattr(torch, dtype_name), BLOCK) == "split"
    (q, k, v, do), (tq, tk, tv, tdo), glse = _inputs(dtype_name)
    ref = _jax_grads(q, k, v, do, glse, causal, with_lse)
    ours = _port_grads(tq, tk, tv, tdo, glse, causal, with_lse)
    for name, a, r in zip(("dq", "dk", "dv"), ours, ref):
        np.testing.assert_allclose(a, r, rtol=0, atol=TOL[dtype_name], err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 64])
def test_f32_two_kernel_backward_matches_jax_at_head_dims(d, causal):
    """The f32 two-kernel layout at both built head dims: the dQ and dK/dV
    wrappers (through autograd, the layout pinned) against JAX's f32 split
    kernels, elementwise within the error bound of these inputs."""
    assert port_fa.bwd_layout(S, d, torch.float32, BLOCK) == "split"
    assert port_fa.backward_supported(d, torch.float32)
    (q, k, v, do), (tq, tk, tv, tdo), glse = _inputs("float32", seed=5, d=d)
    ref = _jax_grads(q, k, v, do, glse, causal, True)
    ours = _port_grads(tq, tk, tv, tdo, glse, causal, True)
    bound = _f32_error_bound(*(np.asarray(a) for a in (q, k, v, do)), glse, causal, True)
    for name, a, r, limit in zip(("dq", "dk", "dv"), ours, ref, bound):
        np.testing.assert_allclose(a, r, rtol=0, atol=limit, err_msg=name)


def _f32_error_bound(q, k, v, do, glse, causal, with_lse):
    """Twice the first-order f32 error bound of the backward recipe, the
    largest element of each of (dq, dk, dv): every sum of n terms is off by
    at most n * 2**-24 * sum(|terms|), carried through the steps."""
    u = 2.0 ** -24
    _, _, s, d = q.shape
    sc = 1 / np.sqrt(d)
    q, k, v, do = (np.asarray(a, np.float64) for a in (q, k, v, do))

    def mm(eq, a, b):
        return np.einsum(eq, a, b)

    keep = np.tril(np.ones((s, s), bool)) if causal else np.ones((s, s), bool)
    sco = np.where(keep, mm("bhid,bhjd->bhij", q, k) * sc, -np.inf)
    e_s = np.where(keep, sc * d * u * mm("bhid,bhjd->bhij", np.abs(q), np.abs(k)), 0.0)
    p = np.exp(sco - sco.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    e_p = p * (e_s + (p * e_s).sum(-1, keepdims=True) + s * u + u)
    o = mm("bhij,bhjd->bhid", p, v)
    e_o = mm("bhij,bhjd->bhid", e_p, np.abs(v)) + s * u * mm("bhij,bhjd->bhid", p, np.abs(v))
    delta = (do * o).sum(-1, keepdims=True) - (glse[..., None] if with_lse else 0.0)
    e_delta = (np.abs(do) * e_o).sum(-1, keepdims=True) + d * u * np.abs(do * o).sum(-1, keepdims=True)
    dp = mm("bhid,bhjd->bhij", do, v)
    e_dp = d * u * mm("bhid,bhjd->bhij", np.abs(do), np.abs(v))
    ds = p * (dp - delta)
    e_ds = e_p * np.abs(dp - delta) + p * (e_dp + e_delta) + u * np.abs(ds)
    e_dq = sc * (mm("bhij,bhjd->bhid", e_ds, np.abs(k)) + s * u * mm("bhij,bhjd->bhid", np.abs(ds), np.abs(k)))
    e_dk = sc * (mm("bhij,bhid->bhjd", e_ds, np.abs(q)) + s * u * mm("bhij,bhid->bhjd", np.abs(ds), np.abs(q)))
    e_dv = mm("bhij,bhid->bhjd", e_p, np.abs(do)) + s * u * mm("bhij,bhid->bhjd", p, np.abs(do))
    return [2 * float(e.max()) for e in (e_dq, e_dk, e_dv)]


@pytest.mark.parametrize("s,limit", [(S, TOL["float32"]), (37, 9.6e-4)])
def test_f32_limits_cover_the_error_bound(s, limit):
    """The f32 limits of this file (S 96) and of the fused backward's test
    (``test_torch_flash_attention_bwd.py``, S 37, the same seed) are the
    largest bound over their eight cases, rounded up at two digits."""
    rng = np.random.RandomState(0)
    q, k, v, do = (rng.randn(B, H, s, D).astype(np.float32) for _ in range(4))
    glse = rng.randn(B, H, s).astype(np.float32)
    worst = max(max(_f32_error_bound(q, k, v, do, glse, c, w)) for c in (True, False)
                for w in (False, True))
    assert worst <= limit < worst * 1.05, (worst, limit)


def test_split_plain_versions_are_the_fused_plain_version():
    """The two halves compute, one (b, h) slice at a time, exactly what
    the fused plain version computes at once."""
    _, (q, k, v, do), glse = _inputs("bfloat16", seed=4)
    o, lse = port_fa.flash_attention_reference(q, k, v, True)
    delta = (do.float() * o.float()).sum(-1) - torch.from_numpy(glse)
    dq, dk, dv = port_fa.flash_attention_backward_reference(q, k, v, do, lse, delta, True)
    assert torch.equal(port_fa.flash_attention_dq_reference(q, k, v, do, lse, delta, True), dq)
    got_k, got_v = port_fa.flash_attention_dkv_reference(q, k, v, do, lse, delta, True)
    assert torch.equal(got_k, dk) and torch.equal(got_v, dv)


@pytest.mark.parametrize("s,block,want", [(96, BLOCK, "split"), (96, None, "fused"),
                                          (96, 16, "fused"), (80, 8, "split")])
def test_dispatcher_calls_the_wrappers_the_gate_names(s, block, want):
    calls = []

    def spy(name):
        real = getattr(port_fa, name)

        def wrapper(*args):
            calls.append(name)
            return real(*args)
        return mock.patch.object(port_fa, name, wrapper)

    rng = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, s, 16).astype(np.float32)).requires_grad_()
               for _ in range(3))
    with spy("flash_attention_backward"), spy("flash_attention_dq"), spy("flash_attention_dkv"):
        port_fa.flash_attention(q, k, v, bwd_block_k=block).sum().backward()
    assert port_fa.bwd_layout(s, 16, torch.float32, block) == want
    if want == "split":
        assert calls == ["flash_attention_dq", "flash_attention_dkv"]
    else:
        assert calls == ["flash_attention_backward"]


def test_split_wrappers_refuse_devices_they_have_no_kernel_for():
    q = torch.empty(1, 1, 8, 64, dtype=torch.bfloat16, device="meta")
    lse = torch.empty(1, 1, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        port_fa.flash_attention_dq(q, q, q, q, lse, lse)
    with pytest.raises(ValueError, match="unsupported device"):
        port_fa.flash_attention_dkv(q, q, q, q, lse, lse)
