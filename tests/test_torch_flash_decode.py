"""Port parity: decode attention (``distriflow_tpu_torch/ops/flash_decode.py``).

The port's paged and slab wrappers on CPU tensors run their plain versions
(the CUDA kernel's numeric contract). They are held against the JAX Pallas
kernels in interpret mode on the same bf16 inputs: scattered page tables,
sentinel tails and per-row lengths, as the JAX package's own paged test
builds them. Tolerance 3e-2: outputs are bf16 and the two sides add the
online-softmax terms in different orders (the TPU kernel's block-diagonal
matmuls against the port's per-head dot products).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distriflow_tpu.ops.flash_decode import flash_decode as jax_flash_decode
from distriflow_tpu.ops.flash_decode import flash_decode_paged as jax_flash_decode_paged
from distriflow_tpu_torch.obs import get_telemetry
from distriflow_tpu_torch.ops import flash_decode as port_fd

pytestmark = pytest.mark.port
torch.set_num_threads(2)

ATOL = 3e-2


def _pair(a):
    """A bf16 JAX array and the torch tensor holding the same bits."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("ps,pp", [(16, 3), (128, 2)])
def test_plain_paged_matches_pallas_interpret(ps, pp, d):
    b, h, n_pages = 3, 4, 7
    rng = np.random.RandomState(8)
    jq, q = _pair(rng.randn(b, h, d))
    jk, k = _pair(rng.randn(n_pages, ps, h * d))
    jv, v = _pair(rng.randn(n_pages, ps, h * d))
    table = np.full((b, pp), n_pages, np.int32)  # sentinel tails
    table[0, :pp] = [5, 0, 3][:pp]               # scattered, unordered
    table[1, :2] = [6, 2]
    table[2, :1] = [4]
    valid = np.array([pp * ps - 3, ps + 1, 1], np.int32)
    ref = jax_flash_decode_paged(jq, jk, jv, jnp.asarray(table), jnp.asarray(valid),
                                 interpret=True)
    out = port_fd.flash_decode_paged(q, k, v, torch.from_numpy(table), torch.from_numpy(valid))
    assert out.shape == (b, h, d) and out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("per_row", [False, True])
def test_plain_slab_matches_pallas_interpret(per_row, d):
    b, h, s = 2, 4, 136  # past one 128-position tile
    rng = np.random.RandomState(3)
    jq, q = _pair(rng.randn(b, h, d))
    jk, k = _pair(rng.randn(b, s, h * d))
    jv, v = _pair(rng.randn(b, s, h * d))
    valid = np.array([130, 9], np.int32) if per_row else np.int32(100)
    ref = jax_flash_decode(jq, jk, jv, jnp.asarray(valid), interpret=True)
    out = port_fd.flash_decode(q, k, v, torch.from_numpy(np.atleast_1d(valid))
                               if per_row else int(valid))
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=0, atol=ATOL)


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
    assert ctr.value == before
    assert not port_fd.supports_seq(2048, hd=512, kv_item=4, d=64)
    assert not port_fd.supports_paged(512, hd=512, kv_item=2, d=64)  # page > MAX_TILE
    assert not port_fd.supports_paged(128, hd=1024, kv_item=2, d=128)  # built for D 64 and 32
    assert port_fd.supports_paged(128, hd=128, kv_item=2, d=32)  # the draft's bf16 pages
    assert port_fd.supports_seq(2048, hd=128, kv_item=2, d=32)
    assert not port_fd.supports_paged(128, hd=128, kv_item=1, d=32)  # int8 only at D 64
    assert ctr.value == before + 4


@pytest.mark.parametrize("kw,page_size,what", [
    (dict(dtype=torch.float16), None, "prefill attention, slab decode"),
    (dict(d_model=256, n_heads=2), None, "head dim 128"),
    ({}, 512, "paged decode at page_size 512"),
    # f32 has prefill kernels; the decode kernels read bf16
    (dict(dtype=torch.float32), None, "no CUDA kernel for slab decode"),
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
