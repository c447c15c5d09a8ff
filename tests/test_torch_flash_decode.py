"""Port parity: decode attention (``distriflow_tpu_torch/ops/flash_decode.py``).

The port's paged and slab wrappers on CPU tensors run their plain versions
(the CUDA kernel's numeric contract). They are held against the JAX Pallas
kernels in interpret mode on the same inputs, bf16 and f32 caches (as the
JAX package's own ``tests/test_flash_decode.py`` runs f32): scattered page
tables, sentinel tails and per-row lengths, as the JAX package's own paged
test builds them. Tolerances:

- bf16 3e-2: outputs are bf16 and the two sides add the online-softmax
  terms in different orders (the TPU kernel's block-diagonal matmuls
  against the port's per-head dot products).
- f32: both sides round q, K and V to bf16 alike and keep scores, m, l and
  acc in f32, and on these inputs round each p to bf16 against the same
  running max (a JAX page and a port page are one tile each; a JAX slab
  tile is the whole slab, and the slab test asserts that each (row,
  head)'s top position lies in the port's first tile, so that the port's
  running max is the row's max throughout). So p can differ only by a
  flip: f32 scores summed in another order round to the neighbouring bf16
  value, moving output element d by at most ``2**-7 * w_j |v_jd|``, w the
  softmax weights; the top position cannot flip (p = exp(0) = 1 on both
  sides). The bound, :func:`_p_flip_bound`, is ``1e-6`` for the f32 sums
  plus two flips at the heaviest other position of each (row, head), and
  it must put some element of the unrounded (true f32) decode outside, so
  that it tells the bf16-compute contract from the true-f32 decode JAX
  runs where its gate says no. Measured: at most 2.4e-7 absolute, 0.24
  of the bound where it is 1e-6 (a row of one position) and at most
  2.4e-4 of it elsewhere; the unrounded decode falls outside for 3 to 38%
  of the elements.

The f32 gate (:func:`supports_seq`/:func:`supports_paged` at itemsize 4)
is held against JAX's own gate on a grid of cache lengths, packed widths
and page sizes: the same decision, and the ``ops_flash_decode_gated_total``
counters of both packages move alike.
"""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distriflow_tpu.obs import get_telemetry as jax_telemetry
from distriflow_tpu.ops.flash_decode import flash_decode as jax_flash_decode
from distriflow_tpu.ops.flash_decode import VMEM_LIMIT_BYTES as JAX_VMEM_LIMIT_BYTES
from distriflow_tpu.ops.flash_decode import _vmem_estimate_bytes as jax_vmem_estimate_bytes
from distriflow_tpu.ops.flash_decode import flash_decode_paged as jax_flash_decode_paged
from distriflow_tpu.ops.flash_decode import pick_block_k as jax_pick_block_k
from distriflow_tpu.ops.flash_decode import supports_paged as jax_supports_paged
from distriflow_tpu.ops.flash_decode import supports_seq as jax_supports_seq
from distriflow_tpu_torch.obs import get_telemetry
from distriflow_tpu_torch.ops import flash_decode as port_fd

pytestmark = pytest.mark.port
torch.set_num_threads(2)

ATOL = 3e-2


def _pair(a, dtype_name="bfloat16"):
    """A JAX array of ``dtype_name`` and the torch tensor holding the same bits."""
    j = jnp.asarray(a, getattr(jnp, dtype_name))
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(getattr(torch, dtype_name))


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).double().numpy()


def _unrounded(q, keys, vals, lens):
    """Each row's decode with no bf16 rounding anywhere, in f64, and the
    softmax weights ``w`` [B, H, S] of the bf16-rounded scores."""
    b, h, d = q.shape
    out, w = np.zeros((b, h, d)), np.zeros((b, h, keys.shape[1]))
    for r in range(b):
        n = int(lens[r])
        if n == 0:
            continue
        for x, rq, rk in ((out, q, keys), (w, _bf16(q), _bf16(keys))):
            sc = np.einsum("hd,phd->hp", np.float64(rq[r]),
                           np.float64(rk[r, :n]).reshape(n, h, d)) / np.sqrt(d)
            e = np.exp(sc - sc.max(-1, keepdims=True))
            e /= e.sum(-1, keepdims=True)
            if x is out:
                out[r] = np.einsum("hp,phd->hd", e, np.float64(vals[r, :n]).reshape(n, h, d))
            else:
                w[r, :, :n] = e
    return out, w


def _p_flip_bound(q, keys, vals, lens, first_tile=None):
    """Elementwise [B, H, D] limit of an f32-cache output against the other
    side's: ``1e-6 + 2 * 2**-7 * max_j w_j |v_jd|`` over each (row, head)'s
    valid positions but its top one (two flips of a bf16 p, see the module
    docstring), with ``w`` the softmax of the bf16-rounded q.K / sqrt(D) in
    f64; ``keys``/``vals`` each row's positions ``[B, S, H*D]``. Given
    ``first_tile``, asserts each top position lies in the port's first tile
    of that many positions, so the two sides round every p against the same
    running max."""
    b, h, d = q.shape
    _, w = _unrounded(q, keys, vals, lens)
    top = w.argmax(-1)
    if first_tile is not None:
        assert (top < first_tile).all()
    np.put_along_axis(w, top[..., None], 0.0, -1)
    vb = np.abs(_bf16(vals).reshape(b, -1, h, d)).transpose(0, 2, 1, 3)
    return 1e-6 + 2 * 2.0 ** -7 * (w[..., None] * vb).max(2)


def _assert_close(out, ref, dtype_name, rows):
    """``out`` against JAX's ``ref``: bf16 within :data:`ATOL`; f32 within
    :func:`_p_flip_bound` of ``rows()`` (its arguments), which must also
    put some element of the unrounded decode outside: the bound tells the
    bf16-compute contract from true f32."""
    assert out.dtype == getattr(torch, dtype_name)
    got, want = out.float().numpy(), np.asarray(ref, np.float32)
    if dtype_name == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    else:
        args = rows()
        bound = _p_flip_bound(*args)
        err = np.abs(got.astype(np.float64) - want)
        assert (err <= bound).all(), float((err - bound).max())
        assert (np.abs(_unrounded(*args[:4])[0] - want) > bound).any()


@pytest.mark.parametrize("dtype_name", ["bfloat16", "float32"])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("ps,pp", [(16, 3), (128, 2)])
def test_plain_paged_matches_pallas_interpret(ps, pp, d, dtype_name):
    b, h, n_pages = 3, 4, 7
    rng = np.random.RandomState(8)
    jq, q = _pair(rng.randn(b, h, d), dtype_name)
    jk, k = _pair(rng.randn(n_pages, ps, h * d), dtype_name)
    jv, v = _pair(rng.randn(n_pages, ps, h * d), dtype_name)
    table = np.full((b, pp), n_pages, np.int32)  # sentinel tails
    table[0, :pp] = [5, 0, 3][:pp]               # scattered, unordered
    table[1, :2] = [6, 2]
    table[2, :1] = [4]
    valid = np.array([pp * ps - 3, ps + 1, 1], np.int32)
    ref = jax_flash_decode_paged(jq, jk, jv, jnp.asarray(table), jnp.asarray(valid),
                                 interpret=True)
    out = port_fd.flash_decode_paged(q, k, v, torch.from_numpy(table), torch.from_numpy(valid))
    assert out.shape == (b, h, d)

    def rows():  # each row's positions, gathered through its table (pages are tiles)
        keys, vals = (np.stack([np.concatenate([x.float().numpy()[min(pg, n_pages - 1)]
                                                for pg in t]) for t in table]) for x in (k, v))
        return q.float().numpy(), keys, vals, valid

    _assert_close(out, ref, dtype_name, rows)


@pytest.mark.parametrize("dtype_name", ["bfloat16", "float32"])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("per_row", [False, True])
def test_plain_slab_matches_pallas_interpret(per_row, d, dtype_name):
    b, h, s = 2, 4, 136  # past one 128-position tile
    rng = np.random.RandomState(3)
    jq, q = _pair(rng.randn(b, h, d), dtype_name)
    jk, k = _pair(rng.randn(b, s, h * d), dtype_name)
    jv, v = _pair(rng.randn(b, s, h * d), dtype_name)
    valid = np.array([130, 9], np.int32) if per_row else np.int32(100)
    ref = jax_flash_decode(jq, jk, jv, jnp.asarray(valid), interpret=True)
    out = port_fd.flash_decode(q, k, v, torch.from_numpy(np.atleast_1d(valid))
                               if per_row else int(valid))
    _assert_close(out, ref, dtype_name, lambda: (
        q.float().numpy(), k.float().numpy(), v.float().numpy(),
        np.broadcast_to(valid, (b,)), port_fd.SLAB_TILE))


def test_paged_and_slab_accumulate_in_the_same_order():
    """At page_size == SLAB_TILE a slab row and the same positions laid out
    in scattered pages give the same bits (engine decode == solo decode)."""
    b, h, d, ps = 1, 2, 64, port_fd.SLAB_TILE
    rng = np.random.RandomState(5)
    q = torch.from_numpy(rng.randn(b, h, d).astype(np.float32)).to(torch.bfloat16)
    k = torch.from_numpy(rng.randn(b, 3 * ps, h * d).astype(np.float32)).to(torch.bfloat16)
    v = torch.from_numpy(rng.randn(b, 3 * ps, h * d).astype(np.float32)).to(torch.bfloat16)
    order = [2, 0, 1]
    kp = torch.zeros(3, ps, h * d, dtype=torch.bfloat16)
    vp = torch.zeros_like(kp)
    for j, pg in enumerate(order):
        kp[pg], vp[pg] = k[0, j * ps:(j + 1) * ps], v[0, j * ps:(j + 1) * ps]
    table = torch.tensor([order], dtype=torch.int32)
    for n in (1, 200, 3 * ps):
        slab = port_fd.flash_decode(q, k, v, n)
        paged = port_fd.flash_decode_paged(q, kp, vp, table, torch.tensor([n], dtype=torch.int32))
        assert torch.equal(slab, paged)


def test_gates_count_and_refuse_what_the_kernel_lacks():
    ctr = get_telemetry().counter("ops_flash_decode_gated_total")
    before = ctr.value
    assert port_fd.supports_seq(2048, hd=512, kv_item=2, d=64)
    assert port_fd.supports_paged(128, hd=512, kv_item=2, d=64)
    # f32 where JAX's gate tiles it: 2048 positions at packed width 512 in
    # tiles of 1024 (the whole slab's VMEM estimate is over 16 MB)
    assert port_fd.supports_seq(2048, hd=512, kv_item=4, d=64)
    assert ctr.value == before
    assert not port_fd.supports_paged(512, hd=512, kv_item=2, d=64)  # page > MAX_TILE
    assert not port_fd.supports_paged(128, hd=1024, kv_item=2, d=128)  # built for D 64 and 32
    assert port_fd.supports_paged(128, hd=128, kv_item=2, d=32)  # the draft's bf16 pages
    assert port_fd.supports_seq(2048, hd=128, kv_item=2, d=32)
    assert not port_fd.supports_paged(128, hd=128, kv_item=1, d=32)  # int8 only at D 64
    assert ctr.value == before + 3


#: the f32 gate's grid: cache lengths (2056 = 8 x 257 has no aligned tile
#: of at least 128), packed widths (8 heads of 32 and of 64) and page sizes
F32_SEQS, F32_WIDTHS, F32_PAGES = (512, 1000, 2056, 16384), (256, 512), (16, 64, 128, 256)


def _gated_counts():
    return (jax_telemetry().counter("ops_flash_decode_gated_total").value,
            get_telemetry().counter("ops_flash_decode_gated_total").value)


@pytest.mark.parametrize("hd", F32_WIDTHS)
@pytest.mark.parametrize("layout,n", [("seq", s) for s in F32_SEQS]
                         + [("paged", p) for p in F32_PAGES])
def test_f32_gate_is_jax_gate(layout, n, hd):
    """At itemsize 4 the port takes a decode shape exactly where JAX runs
    its kernel (else JAX decodes through XLA in true f32, and the port
    refuses), and both packages' gated counters move alike."""
    port_fn = port_fd.supports_seq if layout == "seq" else port_fd.supports_paged
    jax_fn = jax_supports_seq if layout == "seq" else jax_supports_paged
    before = _gated_counts()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # JAX warns once per gated shape
        want = jax_fn(n, hd=hd, kv_item=4)
    got = port_fn(n, hd=hd, kv_item=4, d=hd // 8)
    after = _gated_counts()
    assert got == want
    assert after[0] - before[0] == after[1] - before[1] == (0 if want else 1)


@pytest.mark.parametrize("hd", (256, 512, 2048, 4096))
def test_f32_tile_model_is_jax_model(hd):
    """The port's copy of JAX's f32 tile model, also at packed widths past
    those its kernels take (there a page that does not fit has smaller
    divisors that do): the slab predicate is JAX's ``pick_block_k``
    finding a tile, the page predicate JAX's VMEM check of one tile."""
    for n in (8, 128, 136, 256, 512, 1000, 1024, 2048, 2056, 4096, 16384):
        assert port_fd._jax_tiles_f32(n, hd) == (jax_pick_block_k(n, hd, 4) is not None)
        assert port_fd._jax_f32_fits(n, hd) == (
            jax_vmem_estimate_bytes(n, hd, 4) <= JAX_VMEM_LIMIT_BYTES)


@pytest.mark.parametrize("kw,page_size,what", [
    (dict(dtype=torch.float16), None, "prefill attention, slab decode"),
    (dict(d_model=256, n_heads=2), None, "head dim 128"),
    ({}, 512, "paged decode at page_size 512"),
    # an f32 slab no JAX tile divides (2056 = 8 x 257): JAX decodes it
    # through XLA in true f32
    (dict(dtype=torch.float32, max_seq=2056), None, "no CUDA kernel for slab decode"),
])
def test_cuda_model_raises_where_the_kernels_do_not_take_it(kw, page_size, what):
    """On the card there is no plain path to fall back to: a model, or the
    decode cache it would decode through, that the kernels cannot serve is
    refused when it is built."""
    from distriflow_tpu_torch.models.transformer import TransformerConfig, check_kernels_take

    cfg = TransformerConfig(**{**dict(vocab_size=64, d_model=128, n_heads=2, n_layers=1,
                                      d_ff=64, max_seq=256), **kw})
    with pytest.raises(NotImplementedError, match=what):
        check_kernels_take(cfg, torch.device("cuda"), page_size)
    check_kernels_take(cfg, torch.device("cpu"), page_size)  # the CPU runs the plain path
    off = dataclasses.replace(cfg, use_flash_attention=False, use_flash_decode=False)
    check_kernels_take(off, torch.device("cuda"), page_size)  # the caller asked for plain


def test_cuda_model_at_served_shapes_is_accepted():
    from distriflow_tpu_torch.models.transformer import TransformerConfig, check_kernels_take

    cfg = TransformerConfig(vocab_size=64, d_model=128, n_heads=2, n_layers=1, d_ff=64,
                            max_seq=256)
    check_kernels_take(cfg, torch.device("cuda"), 128)
