"""Port parity: the fused softmax cross-entropy
(``distriflow_tpu_torch/ops/fused_ce.py``).

On CPU tensors the port's fused CE, sparse and dense, runs the kernels'
plain versions through its ``autograd.Function``. Loss and gradient are
held against the JAX package's ``fused_sparse_softmax_cross_entropy`` and
``fused_softmax_cross_entropy`` (Pallas in interpret mode) and the sparse
one's plain optax reference, at a vocabulary that spans several of the
Pallas vocab tiles (4096 forward, 2048 backward) and ends in a ragged
tile, with weighted means and an out-of-range label (sparse), one-hot and
soft targets and a -1e30 and a -inf logit (dense).

Tolerances: loss 1e-5 and f32 gradient 1e-6 (the same f32 exps summed in
another order; measured 2.9e-6 on losses ~ 14 and 4.1e-8). bf16 gradient
2**-8 of the largest element (it is written in bf16 on both sides, and a
rounding flip moves an element by one step; measured 1.2e-10).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distriflow_tpu.ops.fused_ce import (
    fused_softmax_cross_entropy as jax_dense_ce,
    fused_softmax_cross_entropy_per_example as jax_dense_ce_rows,
    fused_sparse_softmax_cross_entropy as jax_sparse_ce,
    fused_sparse_softmax_cross_entropy_per_example as jax_sparse_ce_rows,
)
from distriflow_tpu_torch.models import losses as port_losses
from distriflow_tpu_torch.ops import fused_ce as port_ce

pytestmark = pytest.mark.port
torch.set_num_threads(2)

N, V = 12, 9000


def _inputs(dtype_name, seed=0, out_of_range=False):
    rng = np.random.RandomState(seed)
    x = (rng.randn(N, V) * 3).astype(np.float32)
    labels = rng.randint(0, V, N).astype(np.int32)
    if out_of_range:
        # negative: the JAX kernel's label compare then matches no column
        # (a label in [V, the padded tile's end) would match a masked pad
        # column there; the port matches no column for any label >= V)
        labels[2], labels[5] = -1, -7
    weight = rng.rand(N).astype(np.float32)
    weight[3] = 0.0
    jx = jnp.asarray(x, dtype=getattr(jnp, dtype_name))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype_name))
    return jx, tx, labels, weight


def _jax(fn, jx, labels, weight):
    def f(x):
        return fn(x, jnp.asarray(labels), jnp.asarray(weight))

    loss, grad = jax.value_and_grad(f)(jx)
    return float(loss), np.asarray(grad.astype(jnp.float32))


def _port(tx, labels, weight):
    x = tx.clone().requires_grad_()
    loss = port_ce.fused_sparse_softmax_cross_entropy(
        x, torch.from_numpy(labels), torch.from_numpy(weight))
    loss.backward()
    assert loss.dtype == torch.float32 and x.grad.dtype == tx.dtype
    return loss.item(), x.grad.float().numpy()


@pytest.mark.parametrize("out_of_range", [False, True])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_sparse_matches_jax_fused_interpret(dtype_name, out_of_range):
    jx, tx, labels, weight = _inputs(dtype_name, out_of_range=out_of_range)
    ref_loss, ref_grad = _jax(jax_sparse_ce, jx, labels, weight)
    loss, grad = _port(tx, labels, weight)
    assert loss == pytest.approx(ref_loss, abs=1e-5)
    atol = 1e-6 if dtype_name == "float32" else 2 ** -8 * np.abs(ref_grad).max()
    np.testing.assert_allclose(grad, ref_grad, rtol=0, atol=atol)


def test_sparse_matches_optax_reference():
    jx, tx, labels, weight = _inputs("float32", seed=1)

    def ref(x, y, w):
        per = optax.softmax_cross_entropy_with_integer_labels(x, y)
        return jnp.sum(per * w) / jnp.maximum(jnp.sum(w), 1e-9)

    ref_loss, ref_grad = _jax(ref, jx, labels, weight)
    loss, grad = _port(tx, labels, weight)
    assert loss == pytest.approx(ref_loss, abs=1e-5)
    np.testing.assert_allclose(grad, ref_grad, rtol=0, atol=1e-6)


def test_out_of_range_label_loss_is_lse_and_gradient_pure_softmax():
    _, tx, labels, _ = _inputs("float32", out_of_range=True)
    labels[7] = V
    x = tx.clone().requires_grad_()
    per = port_ce.fused_sparse_softmax_cross_entropy_per_example(x, torch.from_numpy(labels))
    lse = torch.logsumexp(tx, -1)
    for row in (2, 5, 7):
        assert per[row].item() == pytest.approx(float(lse[row]), abs=1e-5)
    per[2].backward()
    torch.testing.assert_close(x.grad[2], torch.softmax(tx[2], -1), rtol=0, atol=1e-7)


def test_per_example_keeps_leading_dims_and_registers():
    _, tx, labels, _ = _inputs("float32")
    per = port_losses.get_loss("fused_sparse_softmax_cross_entropy")
    logits = tx.reshape(3, 4, V)
    lab = torch.from_numpy(labels).reshape(3, 4)
    out = port_ce.fused_sparse_softmax_cross_entropy_per_example(logits, lab)
    assert out.shape == (3, 4)
    assert float(per(logits, lab)) == pytest.approx(float(out.mean()), abs=1e-6)
    assert "fused_softmax_cross_entropy" in port_losses.LOSSES


def test_dense_plain_matches_jax_and_refuses_the_card():
    jx, tx, labels, weight = _inputs("float32", seed=2)
    onehot = np.eye(V, dtype=np.float32)[labels]
    ref_loss, ref_grad = _jax(lambda x, y, w: jax_dense_ce(x, jnp.asarray(onehot), w), jx, labels, weight)
    x = tx.clone().requires_grad_()
    loss = port_ce.fused_softmax_cross_entropy(x, torch.from_numpy(onehot), torch.from_numpy(weight))
    loss.backward()
    assert loss.item() == pytest.approx(ref_loss, abs=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), ref_grad, rtol=0, atol=1e-6)
    meta = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        port_ce.fused_softmax_cross_entropy_per_example(meta, meta)


def _dense_inputs(dtype_name, soft, seed=3):
    """Logits with a -1e30 and a -inf entry, dense targets (one-hot, or a
    random distribution over every column with target 0 at the -inf
    logit), weights with a zero."""
    jx, tx, labels, weight = _inputs(dtype_name, seed=seed)
    x = np.array(jx.astype(jnp.float32))
    x[4, 17] = -1e30
    x[6, 3] = -np.inf
    rng = np.random.RandomState(seed + 1)
    if soft:
        t = rng.rand(N, V).astype(np.float32) ** 4
        t[6, 3] = 0.0
        t /= t.sum(-1, keepdims=True)
    else:
        labels[6] = 5
        t = np.eye(V, dtype=np.float32)[labels]
    jx = jnp.asarray(x, dtype=getattr(jnp, dtype_name))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype_name))
    return jx, tx, t, weight


@pytest.mark.parametrize("soft", [False, True])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_dense_matches_jax_fused_interpret(dtype_name, soft):
    """Loss and gradient of the dense variant through the port's
    ``autograd.Function`` against JAX's fused dense CE (Pallas in interpret
    mode), at V 9000 (two full 4096 tiles and a ragged one), with weights,
    a -1e30 logit and a -inf logit: both mask them out of sum(x * t)."""
    jx, tx, t, weight = _dense_inputs(dtype_name, soft)
    ref_loss, ref_grad = _jax(jax_dense_ce, jx, t, weight)
    x = tx.clone().requires_grad_()
    loss = port_ce.fused_softmax_cross_entropy(x, torch.from_numpy(t), torch.from_numpy(weight))
    loss.backward()
    assert loss.dtype == torch.float32 and x.grad.dtype == tx.dtype
    assert np.isfinite(ref_loss) and loss.item() == pytest.approx(ref_loss, abs=1e-5)
    atol = 1e-6 if dtype_name == "float32" else 2 ** -8 * np.abs(ref_grad).max()
    np.testing.assert_allclose(x.grad.float().numpy(), ref_grad, rtol=0, atol=atol)


def test_dense_per_row_losses_match_jax_and_targets_get_no_gradient():
    jx, tx, t, _ = _dense_inputs("float32", soft=True, seed=5)
    ref = np.asarray(jax_dense_ce_rows(jx, jnp.asarray(t)))
    tt = torch.from_numpy(t).requires_grad_()
    per = port_ce.fused_softmax_cross_entropy_per_example(tx.reshape(3, 4, V), tt.reshape(3, 4, V))
    assert per.shape == (3, 4)
    np.testing.assert_allclose(per.detach().reshape(-1).numpy(), ref, rtol=0, atol=1e-5)
    assert not per.requires_grad and tt.grad is None


def test_dense_plain_version_repairs_the_minus_inf_nan():
    """``lse - sum(x * t)`` is NaN where a logit is -inf and its target 0;
    the plain version masks such logits first, as JAX's kernel does."""
    x = torch.tensor([[0.5, -float("inf"), 1.0, -1e30]])
    t = torch.tensor([[0.25, 0.0, 0.75, 0.0]])
    assert torch.isnan(torch.logsumexp(x, -1) - (x * t).sum(-1)).all()
    loss, lse = port_ce.fused_ce_dense_forward_reference(x, t)
    want = torch.logsumexp(x[:, [0, 2]], -1) - (0.25 * 0.5 + 0.75 * 1.0)
    torch.testing.assert_close(loss, want, rtol=0, atol=1e-6)
    grad = port_ce.fused_ce_dense_backward_reference(x, t, lse, torch.ones(1))
    assert torch.isfinite(grad).all() and grad[0, 1] == 0.0 and grad[0, 3] == 0.0


def test_dense_half_targets_widen_exactly():
    _, tx, t, _ = _dense_inputs("float32", soft=False, seed=6)
    got = port_ce.fused_softmax_cross_entropy_per_example(tx, torch.from_numpy(t).to(torch.bfloat16))
    want = port_ce.fused_softmax_cross_entropy_per_example(tx, torch.from_numpy(t))
    assert torch.equal(got, want)


def test_kernel_wrappers_refuse_devices_they_have_no_kernel_for():
    x = torch.empty(2, 8, dtype=torch.bfloat16, device="meta")
    lab = torch.empty(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        port_ce.fused_ce_forward(x, lab)
    with pytest.raises(ValueError, match="unsupported device"):
        port_ce.fused_ce_backward(x, lab, lab.float(), lab.float())
    with pytest.raises(ValueError, match="unsupported device"):
        port_ce.fused_ce_dense_forward(x, x.float())
    with pytest.raises(ValueError, match="unsupported device"):
        port_ce.fused_ce_dense_backward(x, x.float(), lab.float(), lab.float())


# -- the narrow layout (V <= 256): row tiles of G lanes a row ---------------


def _narrow_inputs(kind, v, n, dtype_name):
    """Inputs at a narrow vocabulary, where the CUDA kernels take the row
    tile: logits with a -1e30 and a -inf entry in row 0, weights (one of
    them 0 where there are several rows), and one-hot or soft targets
    (target 0 at the -inf logit) or integer labels, one of them out of
    range (negative: see ``_inputs``)."""
    rng = np.random.RandomState(1000 * v + n)
    x = (rng.randn(n, v) * 3).astype(np.float32)
    x[0, 3], x[0, 7] = -1e30, -np.inf
    labels = rng.randint(0, v, n).astype(np.int32)
    labels[0] = 5
    weight = rng.rand(n).astype(np.float32)
    if n > 1:
        weight[n // 3] = 0.0
    if kind == "sparse":
        labels[n // 2] = -1
        t = labels
    elif kind == "soft":
        t = rng.rand(n, v).astype(np.float32) ** 4
        t[0, 7] = 0.0
        t /= t.sum(-1, keepdims=True)
    else:
        t = np.eye(v, dtype=np.float32)[labels]
    jx = jnp.asarray(x, dtype=getattr(jnp, dtype_name))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype_name))
    return jx, tx, t, weight


@pytest.mark.parametrize("n", [1, 129, 2047])
@pytest.mark.parametrize("v", [10, 100])
@pytest.mark.parametrize("kind", ["one-hot", "soft", "sparse"])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_narrow_vocab_matches_jax_fused_interpret(dtype_name, kind, v, n):
    """Loss, per-row losses and gradient through the port's
    ``autograd.Function`` against JAX's fused CE (Pallas in interpret mode)
    at the vocabularies the row-tile layout takes (V 10: G 2, R 128; V 100:
    G 16, R 16) and at N 1, one more than a tile (129) and one less than 16
    tiles (2047), with weights, a -1e30 and a -inf logit, and (sparse) an
    out-of-range label."""
    jx, tx, t, weight = _narrow_inputs(kind, v, n, dtype_name)
    if kind == "sparse":
        jax_mean, jax_rows = jax_sparse_ce, jax_sparse_ce_rows
        port_mean = port_ce.fused_sparse_softmax_cross_entropy
        port_rows = port_ce.fused_sparse_softmax_cross_entropy_per_example
    else:
        jax_mean, jax_rows = jax_dense_ce, jax_dense_ce_rows
        port_mean = port_ce.fused_softmax_cross_entropy
        port_rows = port_ce.fused_softmax_cross_entropy_per_example
    ref_loss, ref_grad = _jax(jax_mean, jx, t, weight)
    x = tx.clone().requires_grad_()
    loss = port_mean(x, torch.from_numpy(t), torch.from_numpy(weight))
    loss.backward()
    assert loss.dtype == torch.float32 and x.grad.dtype == tx.dtype
    assert np.isfinite(ref_loss) and loss.item() == pytest.approx(ref_loss, abs=1e-5)
    atol = 1e-6 if dtype_name == "float32" else 2 ** -8 * np.abs(ref_grad).max()
    np.testing.assert_allclose(x.grad.float().numpy(), ref_grad, rtol=0, atol=atol)
    ref_rows = np.asarray(jax_rows(jx, jnp.asarray(t)))
    rows = port_rows(tx, torch.from_numpy(t)).detach().numpy()
    assert np.isfinite(ref_rows).all()
    np.testing.assert_allclose(rows, ref_rows, rtol=0, atol=1e-5)


@pytest.mark.parametrize("v, want", [(1, (1, 256)), (8, (1, 256)), (9, (2, 128)), (10, (2, 128)),
                                     (100, (16, 16)), (256, (32, 8)), (257, None),
                                     (32000, None)])
def test_row_tile_and_the_flat_loads(v, want):
    """``_row_tile``: G the least power of two with 8 G >= V, R = 256 / G,
    at most the kernels' 2048-element tile; ``None`` (one block a row)
    above V 256. A tile's bf16 bytes R V 2 are a multiple of 16, so every
    tile of an aligned tensor starts on 16 bytes and the backward's flat
    16-byte loads and stores are taken there; a [1:] view whose base is
    off 16 bytes is marked for element loads (``aligned`` 0)."""
    tile = port_ce._row_tile(v)
    assert tile == want
    if tile is not None:
        lanes, rows = tile
        assert lanes * rows == port_ce.THREADS and v <= 8 * lanes and (lanes == 1 or v > 4 * lanes)
        assert rows * v <= 2048 and rows * v * 2 % 16 == 0
    x = torch.zeros(3, v, dtype=torch.bfloat16)
    t = torch.zeros(3, v)
    assert x.data_ptr() % 16 == 0 and t.data_ptr() % 16 == 0
    assert port_ce._tile_args(x, t) == (*(tile or (0, 0)), 1)
    # the view's base lies 2 V bytes (logits) and 4 V bytes (targets) in
    assert port_ce._tile_args(x[1:], t[1:]) == (*(tile or (0, 0)), int(v % 8 == 0))
