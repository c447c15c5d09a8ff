"""Port parity: the split-KV decode plain versions (``ops/flash_decode.py``).

The port cuts each (row, head) into splits of ``split_tiles(tile)`` tiles
(a tile is a page, or ``SLAB_TILE`` slab positions; a split spans
``SPLIT_TILES`` x ``SLAB_TILE`` positions), runs the online softmax from a
fresh (m, l, acc) in each and combines the live splits in ascending order,
as its CUDA kernels do. These tests hold the plain versions, which the
wrappers run on CPU tensors:

- against the JAX Pallas kernels in interpret mode (one recurrence over the
  whole row) at contexts spanning three or more splits, with scattered
  pages, sentinel tails, per-row lengths and a length ending exactly on a
  split boundary;
- paged against slab (the same bits: engine decode == solo decode);
- within one split, against the single recurrence the kernels ran before
  splits (the same bits);
- under a wider page table or a longer slab, whose extra splits are dead
  (the same bits).

Tolerance against JAX, derived: both sides round each p * v_scale (bf16:
p) to bf16, each within 2**-9 of the exact value, but against another
running max (JAX: the row's, the port: the split's), and all else is f32.
So |port - jax| <= 2**-8 * sum(p * |V|) / l, plus one bf16 rounding step
of the output (rtol 2**-7) and 1e-6 for f32 sums. sum(p * |V|) / l is the
plain version's own output with |V| in place of V (``_abs_v_bound``).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distriflow_tpu.ops.flash_decode import flash_decode as jax_flash_decode
from distriflow_tpu.ops.flash_decode import flash_decode_paged as jax_flash_decode_paged
from distriflow_tpu_torch.ops import build
from distriflow_tpu_torch.ops import flash_decode as port_fd

pytestmark = pytest.mark.port
torch.set_num_threads(2)

H = 4
RTOL, ATOL = 2 ** -7, 1e-6


def _inputs(rng, b, d, lead, int8):
    """q [B, H, D] bf16 (JAX and torch holding the same bits) and K/V (with
    U(0.005, 0.05) f32 scales for int8) of shape ``lead + (H*D,)``."""
    jq = jnp.asarray(rng.randn(b, H, d), jnp.bfloat16)
    q = torch.from_numpy(np.array(jq.astype(jnp.float32))).to(torch.bfloat16)
    if int8:
        k = rng.randint(-127, 128, lead + (H * d,)).astype(np.int8)
        v = rng.randint(-127, 128, lead + (H * d,)).astype(np.int8)
        ks = rng.uniform(0.005, 0.05, lead + (H,)).astype(np.float32)
        vs = rng.uniform(0.005, 0.05, lead + (H,)).astype(np.float32)
        return jq, q, (k, v, ks, vs)
    k, v = (np.array(jnp.asarray(rng.randn(*lead, H * d), jnp.bfloat16).astype(jnp.float32))
            for _ in range(2))
    return jq, q, (k, v, None, None)


def _jax_kv(k, v, ks, vs):
    if ks is None:
        return jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16), {}
    return jnp.asarray(k), jnp.asarray(v), dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))


def _torch_kv(k, v, ks, vs):
    if ks is None:
        return torch.from_numpy(k).to(torch.bfloat16), torch.from_numpy(v).to(torch.bfloat16), {}
    return (torch.from_numpy(k), torch.from_numpy(v),
            dict(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs)))


def _abs_v_bound(q, tk, tv, scales, lens, table=None):
    """sum(p * |V|) / l per element: the plain version with |V| for V (f32)."""
    av = tv.abs() if tv.dtype == torch.int8 else tv.float().abs().to(torch.bfloat16)
    return port_fd.combine_partials(port_fd.split_partials(
        q, tk, av, lens, table, scales.get("k_scale"), scales.get("v_scale")))


def _hold(out, ref, bound):
    ref = np.asarray(ref, np.float32)
    lim = 2 ** -8 * bound.numpy() + RTOL * np.abs(ref) + ATOL
    err = np.abs(out.float().numpy() - ref)
    assert (err <= lim).all(), f"max err {err.max()}, worst excess {(err - lim).max()}"


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("ps", [16, 128])
def test_split_paged_matches_pallas_interpret(ps, int8):
    split = port_fd.split_tiles(ps) * ps
    # three splits and more, exactly two splits, one split plus 1, 1 position
    lens_l = [3 * split + 5, 2 * split, split + 1, 1]
    pp = -(-max(lens_l) // ps) + 2  # sentinel tails
    d, b = 64, len(lens_l)
    n_pages = sum(-(-n // ps) for n in lens_l) + 3
    rng = np.random.RandomState(21 + ps)
    jq, q, kv = _inputs(rng, b, d, (n_pages, ps), int8)
    table = np.full((b, pp), n_pages, np.int32)
    pages = rng.permutation(n_pages).astype(np.int32)  # scattered, unordered
    used = 0
    for r, n in enumerate(lens_l):
        k = -(-n // ps)
        table[r, :k] = pages[used:used + k]
        used += k
    valid = np.array(lens_l, np.int32)
    jk, jv, jscales = _jax_kv(*kv)
    ref = jax_flash_decode_paged(jq, jk, jv, jnp.asarray(table), jnp.asarray(valid),
                                 interpret=True, **jscales)
    tk, tv, scales = _torch_kv(*kv)
    tt, tl = torch.from_numpy(table), torch.from_numpy(valid)
    out = port_fd.flash_decode_paged(q, tk, tv, tt, tl, **scales)
    assert out.shape == (b, H, d) and out.dtype == torch.bfloat16
    _hold(out, ref, _abs_v_bound(q, tk, tv, scales, tl, tt))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("per_row", [False, True])
def test_split_slab_matches_pallas_interpret(per_row, int8):
    split = port_fd.split_tiles(port_fd.SLAB_TILE) * port_fd.SLAB_TILE
    s, d, b = 3 * split + 40, 32 if not int8 else 64, 3
    rng = np.random.RandomState(31 + per_row)
    jq, q, kv = _inputs(rng, b, d, (b, s), int8)
    valid = np.array([3 * split + 7, split, 2 * split + 1], np.int32) if per_row \
        else np.int32(3 * split)
    jk, jv, jscales = _jax_kv(*kv)
    ref = jax_flash_decode(jq, jk, jv, jnp.asarray(valid), interpret=True, **jscales)
    tk, tv, scales = _torch_kv(*kv)
    lens = torch.from_numpy(np.atleast_1d(valid)) if per_row else int(valid)
    out = port_fd.flash_decode(q, tk, tv, lens, **scales)
    _hold(out, ref, _abs_v_bound(q, tk, tv, scales, lens))


def _paged_copy(kv, order, ps):
    """The slab row 0 of each of ``kv`` laid out in pages ``order``."""
    pools = []
    for t in kv:
        if t is None:
            pools.append(None)
            continue
        pool = torch.zeros((len(order), ps) + tuple(t.shape[2:]), dtype=t.dtype)
        for j, pg in enumerate(order):
            pool[pg] = t[0, j * ps:(j + 1) * ps]
        pools.append(pool)
    return pools


@pytest.mark.parametrize("int8", [False, True])
def test_paged_and_slab_give_the_same_bits_across_splits(int8):
    ps = port_fd.SLAB_TILE
    split = port_fd.split_tiles(ps) * ps
    n_tiles = -(-(3 * split + 5) // ps) + 1
    rng = np.random.RandomState(41 + int8)
    _, q, kv = _inputs(rng, 1, 64, (1, n_tiles * ps), int8)
    tk, tv, scales = _torch_kv(*kv)
    slab = (tk, tv, scales.get("k_scale"), scales.get("v_scale"))
    order = list(rng.permutation(n_tiles))
    pk, pv, pks, pvs = _paged_copy(slab, order, ps)
    table = torch.tensor([order], dtype=torch.int32)
    pscales = {} if pks is None else dict(k_scale=pks, v_scale=pvs)
    for n in (1, split, split + 1, 2 * split, 3 * split + 5):
        got = port_fd.flash_decode(q, tk, tv, n, **scales)
        paged = port_fd.flash_decode_paged(q, pk, pv, table, torch.tensor([n], dtype=torch.int32),
                                           **pscales)
        assert torch.equal(got, paged), n


def _single_recurrence(q, tiles, lens, tile):
    """The decode kernels' recurrence before splits: one online softmax over
    every tile of the row."""
    b, h, d = q.shape
    scale = 1.0 / np.sqrt(d)
    m = torch.full((b, h), port_fd.NEG_INF)
    l = torch.zeros((b, h))
    acc = torch.zeros((b, h, d))
    qf = q.to(torch.bfloat16).float()
    q8, qs = port_fd.quantize_int8(q)
    qscale = (qs.clamp_min(1e-20) * scale)[..., None]
    for j, (kt, vt, kst, vst) in enumerate(tiles):
        if kst is None:
            s = torch.einsum("bhd,bphd->bhp", qf, kt.to(torch.bfloat16).float()) * scale
        else:
            s = torch.einsum("bhd,bphd->bhp", q8, kt.float()) * kst.permute(0, 2, 1) * qscale
        pos = j * tile + torch.arange(kt.shape[1])
        s = torch.where(pos[None, None, :] < lens[:, None, None], s, torch.full_like(s, -1e30))
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        pw = p if vst is None else p * vst.permute(0, 2, 1)
        pv = torch.einsum("bhp,bphd->bhd", pw.to(torch.bfloat16).float(),
                          vt.to(torch.bfloat16).float())
        acc = acc * corr[..., None] + pv
        m = m_new
    return (acc * (1.0 / l.clamp_min(1e-30))[..., None]).to(q.dtype)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("layout", ["paged", "slab"])
def test_a_context_within_one_split_keeps_the_single_recurrence_bits(layout, int8):
    ps = port_fd.SLAB_TILE if layout == "slab" else 16
    split = port_fd.split_tiles(ps) * ps
    lens_l = [1, split // 2 + 3, split, split - 1]
    n_tiles = 3 * port_fd.split_tiles(ps)  # three splits of storage, one live
    rng = np.random.RandomState(51 + int8)
    b = len(lens_l)
    lens = torch.tensor(lens_l, dtype=torch.int32)
    if layout == "slab":
        _, q, kv = _inputs(rng, b, 64, (b, n_tiles * ps), int8)
        tk, tv, scales = _torch_kv(*kv)
        ks, vs = scales.get("k_scale"), scales.get("v_scale")
        got = port_fd.flash_decode(q, tk, tv, lens, **scales)
        want = _single_recurrence(q, port_fd._slab_tiles(q, tk, tv, ks, vs), lens, ps)
    else:
        n_pages = b * n_tiles
        _, q, kv = _inputs(rng, b, 64, (n_pages, ps), int8)
        tk, tv, scales = _torch_kv(*kv)
        ks, vs = scales.get("k_scale"), scales.get("v_scale")
        table = torch.from_numpy(rng.permutation(n_pages).astype(np.int32).reshape(b, n_tiles))
        got = port_fd.flash_decode_paged(q, tk, tv, table, lens, **scales)
        want = _single_recurrence(q, port_fd._paged_tiles(q, tk, tv, ks, vs, table), lens, ps)
    assert torch.equal(got, want)


@pytest.mark.parametrize("int8", [False, True])
def test_dead_splits_are_skipped(int8):
    """The same context under a wider page table (sentinel columns) and in
    a longer slab (masked tiles) gives the same bits: the extra splits hold
    no valid position and the combine reads none of them."""
    ps = 16
    split = port_fd.split_tiles(ps) * ps
    lens_l = [2 * split + 3, split, 1, 0]
    b, pp = len(lens_l), -(-(2 * split + 3) // ps)
    n_pages = b * pp
    rng = np.random.RandomState(61 + int8)
    _, q, kv = _inputs(rng, b, 64, (n_pages, ps), int8)
    tk, tv, scales = _torch_kv(*kv)
    table = torch.from_numpy(rng.permutation(n_pages).astype(np.int32).reshape(b, pp))
    wide = torch.cat([table, torch.full((b, 3 * port_fd.split_tiles(ps) + 1), n_pages,
                                        dtype=torch.int32)], 1)
    lens = torch.tensor(lens_l, dtype=torch.int32)
    narrow_out = port_fd.flash_decode_paged(q, tk, tv, table, lens, **scales)
    assert torch.equal(port_fd.flash_decode_paged(q, tk, tv, wide, lens, **scales), narrow_out)
    assert not narrow_out[3].any()  # a row of length 0 gives 0
    s = 2 * split + 3 * port_fd.SLAB_TILE
    _, q2, kv2 = _inputs(rng, b, 64, (b, 2 * s), int8)
    sk, sv, sscales = _torch_kv(*kv2)
    short = {k: t[:, :s].contiguous() for k, t in sscales.items()}
    assert torch.equal(port_fd.flash_decode(q2, sk, sv, lens, **sscales),
                       port_fd.flash_decode(q2, sk[:, :s].contiguous(), sv[:, :s].contiguous(),
                                            lens, **short))


def test_split_rule_is_one_python_constant_passed_to_the_kernels():
    """SPLIT_TILES lives in ops/flash_decode.py and reaches the kernels as
    an argument (tiles a split, by ``split_tiles``); the CUDA source keeps
    no atomics and launches its combine kernel."""
    assert port_fd.SPLIT_TILES in (1, 2, 4)
    ps = port_fd.SLAB_TILE
    assert port_fd.split_tiles(ps) == port_fd.SPLIT_TILES  # pages of 128 split as the slab
    assert port_fd.split_tiles(16) * 16 == port_fd.SPLIT_TILES * ps
    assert port_fd.split_tiles(256) == max(1, port_fd.SPLIT_TILES // 2)
    src = (build.CSRC / "flash_decode.cu").read_text()
    # the bf16, f32 and int8 entry points
    assert len(re.findall(r"int split_tiles, int n_splits, int len_all", src)) == 3
    assert not re.search(r"\batomic\w*\s*\(|\bred\.|\batom\.", src) and "cp.async" in src
    assert re.search(r"__global__[^;{]*\bcombine_kernel\s*\(", src)
    assert "cudaLaunchKernelEx(&cfg, combine_kernel<D, Out>" in src
    assert "flash_decode" in build.HEADERS and "hopper.cuh" in build.HEADERS["flash_decode"]
