"""Port parity: where a NaN input goes.

JAX's kernels clamp a softmax sum with ``jnp.maximum(l, 1e-30)``
(``flash_attention.py``, ``fused_ce.py``, ``flash_decode.py``), which keeps
a NaN, so a NaN in an input reaches the outputs that read it. The port's
plain versions clamp with ``clamp_min``, which keeps it too, and its CUDA
kernels with ``l < 1e-30f ? 1e-30f : l`` (``fmaxf`` would drop it; the card
holds each kernel against its plain version in ``chip_smoke.py``'s NaN
checks). These tests plant one NaN in inputs made from a numpy seed and
require that the port's plain versions carry it to the same elements of
the same outputs as the JAX package's functions (Pallas in interpret mode):

- ``flash_attention_with_lse`` (O and lse): a NaN in q, k or v, causal and
  not, at head dims 32 and 64;
- the fused CE per row (sparse labels and dense targets): a NaN in a logit
  that is not the label's and in the label's own;
- paged and slab decode on bf16 caches: a NaN in q and in one live K
  position. Here the same rows: JAX's kernel multiplies all of a row's
  heads in one block-diagonal product, where 0 x NaN spreads the NaN to
  every head of the row (a layout of the TPU's), while the port's stays in
  the head it was planted in.

It also holds ``chip_smoke._bound``'s exponential term at path (b)'s shape.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from distriflow_tpu.ops.flash_attention import flash_attention_with_lse
from distriflow_tpu.ops.flash_decode import flash_decode as jax_flash_decode
from distriflow_tpu.ops.flash_decode import flash_decode_paged as jax_flash_decode_paged
from distriflow_tpu.ops.fused_ce import (
    fused_softmax_cross_entropy_per_example as jax_dense_ce_rows,
    fused_sparse_softmax_cross_entropy_per_example as jax_sparse_ce_rows,
)
from distriflow_tpu_torch.ops import flash_attention as port_fa
from distriflow_tpu_torch.ops import flash_decode as port_fd
from distriflow_tpu_torch.ops import fused_ce as port_ce

pytestmark = pytest.mark.port
torch.set_num_threads(2)


def _pair(a, dtype_name="bfloat16"):
    """A JAX array of ``dtype_name`` and the torch tensor holding the same bits."""
    j = jnp.asarray(a, getattr(jnp, dtype_name))
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(getattr(torch, dtype_name))


def _nan_mask(x):
    return np.isnan(x.float().numpy() if isinstance(x, torch.Tensor)
                    else np.asarray(x, np.float32))


def _same_nans(got, want):
    """The port's output carries a NaN exactly where JAX's does, and somewhere."""
    g, w = _nan_mask(got), _nan_mask(want)
    assert g.shape == w.shape
    np.testing.assert_array_equal(g, w)
    return bool(w.any())


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_attention_nan_reaches_the_outputs_jax_gives(which, causal, d):
    b, h, s = 1, 2, 37
    rng = np.random.RandomState(11)
    arrs = {n: rng.randn(b, h, s, d).astype(np.float32) for n in "qkv"}
    arrs[which][0, 1, s // 3, 3] = np.nan
    (jq, q), (jk, k), (jv, v) = (_pair(arrs[n], "float32") for n in "qkv")
    o_ref, lse_ref = flash_attention_with_lse(jq, jk, jv, causal, interpret=True)
    o, lse = port_fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    reached = {"o": _same_nans(o, o_ref), "lse": _same_nans(lse, lse_ref)}
    # O always reads the NaN; lse reads q and k, never v
    assert reached == {"o": True, "lse": which != "v"}


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("at", ["other", "label"])
def test_sparse_ce_nan_reaches_the_loss_jax_gives(at, dtype_name):
    n, v = 6, 300
    rng = np.random.RandomState(12)
    x = (rng.randn(n, v) * 3).astype(np.float32)
    labels = rng.randint(0, v, n).astype(np.int32)
    col = labels[2] if at == "label" else (labels[2] + 5) % v
    x[2, col] = np.nan
    jx, tx = _pair(x, dtype_name)
    want = jax_sparse_ce_rows(jx, jnp.asarray(labels))
    got = port_ce.fused_sparse_softmax_cross_entropy_per_example(tx, torch.from_numpy(labels))
    assert _same_nans(got, want)
    loss, lse = port_ce.fused_ce_forward_reference(tx, torch.from_numpy(labels))
    assert torch.isnan(lse[2]) and torch.isnan(loss[2]) and torch.isfinite(lse[[0, 1, 3, 4, 5]]).all()


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("at", ["other", "label"])
def test_dense_ce_nan_reaches_the_loss_jax_gives(at, dtype_name):
    n, v = 6, 300
    rng = np.random.RandomState(13)
    x = (rng.randn(n, v) * 3).astype(np.float32)
    labels = rng.randint(0, v, n)
    t = np.eye(v, dtype=np.float32)[labels]
    col = labels[4] if at == "label" else (labels[4] + 7) % v
    x[4, col] = np.nan
    jx, tx = _pair(x, dtype_name)
    want = jax_dense_ce_rows(jx, jnp.asarray(t))
    got = port_ce.fused_softmax_cross_entropy_per_example(tx, torch.from_numpy(t))
    assert _same_nans(got, want)
    loss, lse = port_ce.fused_ce_dense_forward_reference(tx, torch.from_numpy(t))
    assert torch.isnan(lse[4]) and torch.isnan(loss[4])


def _same_rows(got, want):
    """The port's decode output carries a NaN in the same batch rows as
    JAX's; returns the port's NaN mask over (row, head)."""
    g, w = _nan_mask(got).any(-1), _nan_mask(want).any(-1)
    np.testing.assert_array_equal(g.any(-1), w.any(-1))
    return g


def _decode_inputs(rng, d, shape_k):
    b, h = 3, 4
    q = rng.randn(b, h, d).astype(np.float32)
    k = rng.randn(*shape_k, h * d).astype(np.float32)
    v = rng.randn(*shape_k, h * d).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("which", ["q", "k"])
def test_paged_decode_nan_reaches_the_output_jax_gives(which, d):
    n_pages, ps, pp = 7, 16, 3
    rng = np.random.RandomState(14)
    q, k, v = _decode_inputs(rng, d, (n_pages, ps))
    table = np.full((3, pp), n_pages, np.int32)
    table[0, :pp] = [5, 0, 3]
    table[1, :2] = [6, 2]
    table[2, :1] = [4]
    valid = np.array([pp * ps - 3, ps + 1, 1], np.int32)
    if which == "q":
        q[1, 2, 5] = np.nan
    else:
        k[0, 4, 2 * d + 1] = np.nan  # page 0, row 0's second: position 20 of 45, head 2
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a) for a in (q, k, v))
    want = jax_flash_decode_paged(jq, jk, jv, jnp.asarray(table), jnp.asarray(valid),
                                  interpret=True)
    got = port_fd.flash_decode_paged(tq, tk, tv, torch.from_numpy(table), torch.from_numpy(valid))
    heads = np.zeros((3, 4), bool)
    heads[1 if which == "q" else 0, 2] = True
    np.testing.assert_array_equal(_same_rows(got, want), heads)
    assert _nan_mask(got).any(-1).sum() == _nan_mask(got).all(-1).sum()  # the whole head


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("which", ["q", "k"])
def test_slab_decode_nan_reaches_the_output_jax_gives(which, d):
    s = 136
    rng = np.random.RandomState(15)
    q, k, v = _decode_inputs(rng, d, (2, s))
    q = q[:2]
    valid = np.array([130, 9], np.int32)
    if which == "q":
        q[0, 1, 0] = np.nan
    else:
        k[0, 129, d + 3] = np.nan  # row 0's last live position, head 1
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a) for a in (q, k, v))
    want = jax_flash_decode(jq, jk, jv, jnp.asarray(valid), interpret=True)
    got = port_fd.flash_decode(tq, tk, tv, torch.from_numpy(valid))
    heads = np.zeros((2, 4), bool)
    heads[0, 1] = True
    np.testing.assert_array_equal(_same_rows(got, want), heads)
    assert _nan_mask(got)[0, 1].all()


def test_bound_names_the_exponentials_at_path_b():
    b, h, s, d = 8, 8, 16384, 32
    pairs = b * h * s * (s + 1) // 2
    nbytes = 4 * b * h * s * d * 2 + 2 * b * h * s * 4 + b * h * s * d * 2
    # kernel 7: three products a pair, one exponential a pair
    ms, by = chip_smoke._bound(nbytes, 3 * 2 * pairs * d, exps=pairs)
    assert by == "exponentials" and ms == pytest.approx(2.22, abs=0.005)
    assert ms == pytest.approx(pairs / chip_smoke.SFU_EXP_PER_S * 1e3)
    # kernel 8: four products a pair, the operations just win
    ms, by = chip_smoke._bound(nbytes + b * h * s * d * 2, 4 * 2 * pairs * d, exps=pairs)
    assert by == "operations" and ms == pytest.approx(2.224, abs=0.001)
    # the largest term wins, and no exponentials leave the two-term bound
    assert chip_smoke._bound(1e12, 1.0, exps=1.0) == (pytest.approx(1e12 / chip_smoke.HBM_BYTES_PER_S * 1e3),
                                                      "bytes")
    assert chip_smoke._bound(1.0, 1e15) == chip_smoke._bound(1.0, 1e15, exps=0)
    assert chip_smoke._bound(1.0, 1.0, exps=1e12)[1] == "exponentials"


def test_no_kernel_clamp_drops_a_nan():
    """``fmaxf(l, 1e-30f)`` returns 1e-30f for a NaN l; every kernel
    clamps with a compare that keeps it (``l < 1e-30f ? 1e-30f : l``)."""
    import re
    from pathlib import Path

    csrc = Path(port_fa.__file__).resolve().parent.parent / "csrc"
    found = {p.name: re.findall(r"fmaxf\([^;]*1e-30f\)", p.read_text()) for p in csrc.glob("*.cu")}
    assert found and not any(found.values()), found
    assert all("1e-30f ? 1e-30f :" in (csrc / f).read_text()
               for f in ("flash_attention.cu", "flash_attention_f32.cu", "fused_ce.cu", "flash_decode.cu"))
