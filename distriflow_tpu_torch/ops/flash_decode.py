"""Single-token decode attention: hand-written Hopper kernels for the
paged and the slab KV cache, bf16, f32 and int8, and their plain versions.

Port of ``distriflow_tpu/ops/flash_decode.py``. ``csrc/flash_decode.cu``
replaces four Pallas kernels:

- ``_paged_kernel`` and ``_paged_kernel_quant``
  (:func:`flash_decode_paged`, one query per row against a
  ``[n_pages, page_size, H*D]`` pool through a ``[B, PP]`` page table);
- ``_decode_kernel`` and ``_decode_kernel_quant`` (:func:`flash_decode`,
  against a token-major ``[B, S, H*D]`` slab).

The first two take bf16 and f32 caches (an f32 query with an f32 cache:
the JAX LM CLI's ``--dtype float32``), each with a kernel of its own (the
f32 launches also counted in ``launches_by_dtype``). One kernel per cache
type serves both layouts: the slab is read as a page
table that is the identity, with :data:`SLAB_TILE`-position pages, so at
``page_size == SLAB_TILE`` both accumulate in the same order and the
serving engine's paged decode matches solo ``generate()`` on the card.
Given ``k_scale``/``v_scale`` the two wrappers take int8 K/V and launch
the int8 kernel (:func:`flash_decode_paged_int8`, :func:`flash_decode_int8`,
each with its own launch count).

Split-KV: each (row, head) is cut into splits of consecutive tiles (a
tile is a page, or :data:`SLAB_TILE` slab positions), :func:`split_tiles`
of them: :data:`SPLIT_TILES` at pages of SLAB_TILE. A split runs the
online-softmax recurrence from a fresh ``(m, l, acc)``; a second pass
combines the splits that hold a valid position, in
ascending order: ``M = max m_i``, ``acc = sum acc_i * exp(m_i - M)``,
``l = sum l_i * exp(m_i - M)``, ``out = acc * (1 / max(l, 1e-30))``. A
row of length 0 has no such split and gives 0. The plain versions here
follow the same order (:func:`split_partials`, :func:`combine_partials`).

Numeric contract, bf16 (the kernel and the plain versions here): q, K and
V enter the products as bf16; scores, the running max and sum stay f32; p
is rounded to bf16 for the PV product; accumulation is f32; positions at
or past a row's valid length score -1e30. Sentinel page-table entries
(``>= n_pages``) clamp to the last page, whose contents the length mask
discards. The TPU kernel's block-diagonal query layout existed only to
feed the TPU's matrix unit and is not carried over.

Numeric contract, f32 (JAX's "bf16-compute contract for f32 caches",
``flash_decode.py:46-56``): q, K and V are read in f32 and each value is
rounded to bf16 (round to nearest even) before its product; from there on
it is the bf16 contract; the output is f32, unrounded. So an f32 cache
buys no contraction accuracy over bf16 here, as in JAX. The f32 gate
(:func:`supports_seq`, :func:`supports_paged` at ``kv_item`` 4) is JAX's
own VMEM model and tile floor (:func:`_jax_f32_fits`,
:func:`_jax_tiles_f32`; pages a multiple of 8 and at least
:data:`MIN_BLOCK_K`), which the port copies: where it says no, JAX decodes
through XLA in true f32, a different computation, and the port refuses by
name instead of rounding to bf16.

Numeric contract, int8 (``flash_decode.py:176-215, 245-271, 545-551``):
q is quantized per (row, head), ``qs = max(max|q| / 127, 1e-20)``,
``q8 = clip(round_half_even(q / qs), -127, 127)``; the score is the exact
int dot ``K8 . q8`` times ``k_scale``, times ``qs / sqrt(D)``, multiplied
in that order in f32; ``l`` sums the unscaled p; the PV operand is
``bf16(p * v_scale)`` against V int8 (exact as float), f32 accumulation;
the output is ``acc / max(l, 1e-30)`` in q's dtype.

bf16 at head dim 32 (the speculative draft's and the JAX LM CLI's) is
one cluster launch of its own: the same splits, recurrence and combine,
with a cluster of :func:`d32_cluster` CTAs a (row, head), each warp
running one split at a time and rank 0 combining the partials through
distributed shared memory, no scratch in device memory. A row of more
than 967 x C splits (15,472 at C 16: about 3.9M positions at
``SPLIT_TILES`` 2) is refused at launch.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple, Union

import torch

from distriflow_tpu_torch.ops import build

NEG_INF = -1e30
SLAB_TILE = 128  # slab positions per tile: the identity table's page size
#: a split of the split-KV kernels spans SPLIT_TILES tiles of SLAB_TILE
#: positions (:func:`split_tiles`), the same for every shape, so that pages
#: of SLAB_TILE and slab tiles split at the same positions
SPLIT_TILES = 2
MAX_TILE = 256  # largest page: the kernels keep a tile's scores in registers
#: the head dims the bf16 kernel is built and checked for: the flagship's
#: 64 and the speculative draft's 32
SUPPORTED_HEAD_DIMS = (32, 64)
#: the head dims the int8 kernel is built for
INT8_HEAD_DIMS = (64,)
#: the largest cluster of the head-dim-32 bf16 kernel (:func:`d32_cluster`;
#: a power of two, at most 16)
D32_CLUSTER_MAX = 16
#: warps a CTA of that kernel, each running one split at a time
#: (``csrc/flash_decode.cu``: ``d32::kWarps``)
D32_WARPS = 4

# JAX's f32 decode gate (distriflow_tpu/ops/flash_decode.py:85-163, 445-455),
# the port's own copy: the TPU tile model decides where JAX runs its kernel
# on an f32 cache and where it takes XLA's true-f32 decode instead
BLOCK_K = 2048
VMEM_LIMIT_BYTES = 16 * 1024 * 1024
MIN_BLOCK_K = 128

# pointers, then B, H, D, T, n_tiles, S, n_pages, split_tiles, n_splits,
# the length of every row (where lens is NULL), the score scale, the stream
_INTS = [ctypes.c_int] * 10
_SIGNATURES = {
    "dftt_flash_decode_bf16": [ctypes.c_void_p] * 7 + _INTS + [ctypes.c_float, ctypes.c_void_p],
    "dftt_flash_decode_f32": [ctypes.c_void_p] * 7 + _INTS + [ctypes.c_float, ctypes.c_void_p],
    "dftt_flash_decode_int8": [ctypes.c_void_p] * 9 + _INTS + [ctypes.c_float, ctypes.c_void_p],
    # q, k, v, table, lens, out; B, H, T, n_tiles, S, n_pages, split_tiles,
    # n_splits, the cluster, len_all; the scale, the stream
    "dftt_flash_decode_d32": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
    + [ctypes.c_float, ctypes.c_void_p],
    "dftt_flash_decode_d32_clusters": [ctypes.c_int] * 2,
}


def _note_refused() -> None:
    from distriflow_tpu_torch.obs import get_telemetry

    get_telemetry().counter(
        "ops_flash_decode_gated_total",
        help="decode shapes the kernel gates refused (a CUDA model raises on them)",
    ).inc()


def _kernel_takes(hd: int, kv_item: int, d: int) -> bool:
    dims = INT8_HEAD_DIMS if kv_item == 1 else SUPPORTED_HEAD_DIMS
    return kv_item in (1, 2, 4) and d in dims and hd % d == 0


def _jax_f32_fits(bk: int, hd: int) -> bool:
    """JAX's scoped-VMEM model of an f32 cache tile of ``bk`` positions at
    packed width ``hd``: double-buffered f32 K/V tiles and their bf16 cast
    copies, plus 10%, within :data:`VMEM_LIMIT_BYTES`."""
    return int((2 * 2 * bk * hd * 4 + 2 * bk * hd * 2) * 1.1) <= VMEM_LIMIT_BYTES


def _jax_tiles_f32(s: int, hd: int) -> bool:
    """True when JAX's gate finds a tile for an f32 slab of ``s``
    positions: ``s`` itself up to :data:`BLOCK_K`, else a multiple-of-8
    divisor of ``s`` down to :data:`MIN_BLOCK_K`, that fits the VMEM model."""
    if s <= BLOCK_K and _jax_f32_fits(s, hd):
        return True
    return any(s % bk == 0 and _jax_f32_fits(bk, hd)
               for bk in range(min(BLOCK_K, s) // 8 * 8, MIN_BLOCK_K - 1, -8))


def supports_seq(s: int, hd: int = 512, kv_item: int = 2, d: int = 64) -> bool:
    """True when :func:`flash_decode` takes a slab of ``s`` positions at
    packed width ``hd``, itemsize ``kv_item`` and head dim ``d``: bf16 or
    int8 (``kv_item`` 1) at a supported head dim and any ``s`` (the last
    tile is masked); f32 (``kv_item`` 4) where JAX's own gate runs its
    kernel (:func:`_jax_tiles_f32`). A refused shape bumps
    ``ops_flash_decode_gated_total``; there is no plain path on the card
    to route it to, so the caller raises."""
    if s >= 1 and _kernel_takes(hd, kv_item, d) and (
            kv_item != 4 or _jax_tiles_f32(s, hd)):
        return True
    _note_refused()
    return False


def supports_paged(page_size: int, hd: int = 512, kv_item: int = 2, d: int = 64) -> bool:
    """True when :func:`flash_decode_paged` takes pages of ``page_size``
    positions: at most :data:`MAX_TILE`, bf16, f32 or int8, a supported
    head dim; f32 only where JAX's own gate runs its kernel too (a
    multiple of 8, at least :data:`MIN_BLOCK_K`, a page pair within the
    VMEM model). A refused shape bumps ``ops_flash_decode_gated_total``."""
    jax_takes = kv_item != 4 or (page_size % 8 == 0 and page_size >= MIN_BLOCK_K and
                                 _jax_f32_fits(page_size, hd))
    if 1 <= page_size <= MAX_TILE and _kernel_takes(hd, kv_item, d) and jax_takes:
        return True
    _note_refused()
    return False


def split_tiles(tile: int) -> int:
    """Tiles of ``tile`` positions in one split: the :data:`SPLIT_TILES` x
    :data:`SLAB_TILE` positions of a split in whole tiles, at least one (a
    page of SLAB_TILE gives SPLIT_TILES; a smaller page more pages, so the
    partials of a row stay one per SPLIT_TILES x SLAB_TILE positions)."""
    return max(1, SPLIT_TILES * SLAB_TILE // tile)


def d32_cluster(n_splits: int) -> int:
    """CTAs in the cluster of one (row, head) of the head-dim-32 bf16
    kernel: the least power of two at or above ``n_splits`` (a row's
    splits, from the table width or the slab length: no length is read),
    at most :data:`D32_CLUSTER_MAX`. Rank r of the cluster runs splits r,
    r + C, ..., one a warp at a time, so a row takes at most
    ceil(n_splits / (C * :data:`D32_WARPS`)) passes of its warps."""
    c = 1
    while c < min(n_splits, D32_CLUSTER_MAX):
        c *= 2
    return c


def _row_lens(valid_len: Union[int, torch.Tensor], b: int, device) -> torch.Tensor:
    if isinstance(valid_len, torch.Tensor):
        return valid_len.to(device=device, dtype=torch.int32).reshape(-1).expand(b).contiguous()
    return torch.full((b,), int(valid_len), dtype=torch.int32, device=device)


_DIVISOR_127 = {}  # one 127.0 tensor per device, see quantize_int8


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric absmax int8 over the last dim (JAX ``_quantize`` and the
    decode kernels' q). Returns ``(values, s)``: ``s = max |x| / 127`` in
    f32, unclamped (a zero row gives 0), and ``values = clip(
    round_half_even(x / max(s, 1e-20)), -127, 127)`` as f32. ``s`` is taken
    by true division: PyTorch multiplies a CUDA tensor divided by a Python
    scalar by the scalar's reciprocal, which can differ in the last bit
    from the division the kernels and the JAX package do."""
    xf = x.float()
    c = _DIVISOR_127.get(x.device)
    if c is None:
        c = _DIVISOR_127[x.device] = torch.full((), 127.0, device=x.device)
    scale = xf.abs().amax(dim=-1) / c
    return torch.clamp(torch.round(xf / scale.clamp_min(1e-20)[..., None]), -127, 127), scale


def _split_partials(q, tiles, lens, tile, per_split):
    """The split kernel in plain PyTorch: the recurrence from a fresh
    ``(m, l, acc)`` over each run of ``per_split`` consecutive tiles.
    ``tiles`` yields ``(k, v, k_scale, v_scale)`` for consecutive tiles of
    ``tile`` positions, K/V ``[B, T, H, D]`` and, for an int8 cache, scales
    ``[B, T, H]`` (else None). Returns one ``(m [B, H], l [B, H], acc
    [B, H, D], live [B])`` per split; ``live`` marks the rows with a valid
    position in the split (the kernel's live blocks)."""
    b, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qf = q.to(torch.bfloat16).float()
    q8, qs = quantize_int8(q)  # the int8 kernels' q
    qscale = (qs.clamp_min(1e-20) * scale)[..., None]
    parts = []
    for j, (kt, vt, kst, vst) in enumerate(tiles):
        if j % per_split == 0:
            m = torch.full((b, h), NEG_INF, dtype=torch.float32, device=q.device)
            l = torch.zeros((b, h), dtype=torch.float32, device=q.device)
            acc = torch.zeros((b, h, d), dtype=torch.float32, device=q.device)
            parts.append([m, l, acc, j * tile < lens])
        m, l, acc, _ = parts[-1]
        if kst is None:
            s = torch.einsum("bhd,bphd->bhp", qf, kt.to(torch.bfloat16).float()) * scale
        else:
            # integers below 2**24 in every partial sum: the f32 dot is exact
            dot = torch.einsum("bhd,bphd->bhp", q8, kt.float())
            s = dot * kst.permute(0, 2, 1) * qscale
        pos = j * tile + torch.arange(kt.shape[1], device=q.device)
        s = torch.where(pos[None, None, :] < lens[:, None, None], s,
                        torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        pw = p if vst is None else p * vst.permute(0, 2, 1)
        # int8 V widens to bf16 exactly, as the TPU kernel casts it
        pv = torch.einsum("bhp,bphd->bhd", pw.to(torch.bfloat16).float(),
                          vt.to(torch.bfloat16).float())
        parts[-1][:3] = m_new, l, acc * corr[..., None] + pv
    return parts


def combine_partials(parts) -> torch.Tensor:
    """The combine kernel in plain PyTorch: the live splits of ``parts``
    (:func:`split_partials`) in ascending order, each product and sum
    rounded on its own; [B, H, D] f32."""
    live = torch.stack([lv for *_, lv in parts])[..., None]  # [n, B, 1]
    top = torch.where(live, torch.stack([m for m, *_ in parts]), NEG_INF).amax(0)
    acc = torch.zeros_like(parts[0][2])
    l = torch.zeros_like(parts[0][1])
    for m, li, ai, lv in parts:
        w = torch.exp(m - top)
        lv = lv[:, None]
        acc = torch.where(lv[..., None], acc + ai * w[..., None], acc)
        l = torch.where(lv, l + li * w, l)
    return acc * (1.0 / l.clamp_min(1e-30))[..., None]


def _paged_tiles(q, k, v, k_scale, v_scale, page_table):
    """One tile per page-table column: ``(k, v [B, ps, H, D], k_scale,
    v_scale [B, ps, H] or None)``; sentinels clamp to the last page."""
    b, h, d = q.shape
    n_pages, ps, _ = k.shape
    tab = page_table.long().clamp(0, n_pages - 1)
    for j in range(tab.shape[1]):
        pg = tab[:, j]
        yield (k[pg].reshape(b, ps, h, d), v[pg].reshape(b, ps, h, d),
               None if k_scale is None else k_scale[pg],
               None if v_scale is None else v_scale[pg])


def _slab_tiles(q, k, v, k_scale, v_scale):
    """:data:`SLAB_TILE`-position tiles of the slabs, as :func:`_paged_tiles`."""
    b, h, d = q.shape
    s = k.shape[1]
    for t0 in range(0, s, SLAB_TILE):
        w = slice(t0, min(t0 + SLAB_TILE, s))
        n = w.stop - t0
        yield (k[:, w].reshape(b, n, h, d), v[:, w].reshape(b, n, h, d),
               None if k_scale is None else k_scale[:, w],
               None if v_scale is None else v_scale[:, w])


def split_partials(q, k, v, valid_len, page_table=None, k_scale=None, v_scale=None):
    """The split pass of any of the four kernels in plain PyTorch: the
    paged layout where ``page_table`` is given, else the slab; int8 where
    ``k_scale``/``v_scale`` are. One ``(m, l, acc, live)`` per split of
    :func:`split_tiles` tiles (:func:`_split_partials`)."""
    lens = _row_lens(valid_len, q.shape[0], q.device)
    if page_table is None:
        tiles, tile = _slab_tiles(q, k, v, k_scale, v_scale), SLAB_TILE
    else:
        tiles, tile = _paged_tiles(q, k, v, k_scale, v_scale, page_table), k.shape[1]
    return _split_partials(q, tiles, lens, tile, split_tiles(tile))


def flash_decode_paged_reference(q, k, v, page_table, valid_len) -> torch.Tensor:
    """Plain version of :func:`flash_decode_paged` (bf16 or f32 cache)."""
    return combine_partials(split_partials(q, k, v, valid_len, page_table)).to(q.dtype)


def flash_decode_reference(q, k, v, valid_len) -> torch.Tensor:
    """Plain version of :func:`flash_decode` (bf16 or f32 cache)."""
    return combine_partials(split_partials(q, k, v, valid_len)).to(q.dtype)


def flash_decode_paged_int8_reference(q, k, v, k_scale, v_scale, page_table,
                                      valid_len) -> torch.Tensor:
    """Plain version of :func:`flash_decode_paged_int8`."""
    return combine_partials(split_partials(q, k, v, valid_len, page_table, k_scale,
                                           v_scale)).to(q.dtype)


def flash_decode_int8_reference(q, k, v, k_scale, v_scale, valid_len) -> torch.Tensor:
    """Plain version of :func:`flash_decode_int8`."""
    return combine_partials(split_partials(q, k, v, valid_len, None, k_scale,
                                           v_scale)).to(q.dtype)


def _check_cuda(q, pools, what, dtype=None, scales=()):
    """``dtype`` None: the bf16 or the f32 kernel, q and the pools of one
    dtype; else (int8) a bf16 q and pools of ``dtype``."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    q_dtypes = (torch.bfloat16, torch.float32) if dtype is None else (torch.bfloat16,)
    if q.dim() != 3 or q.dtype not in q_dtypes or not q.is_contiguous():
        names = " or ".join(str(t).replace("torch.", "") for t in q_dtypes)
        raise ValueError(f"{what}: q must be contiguous {names} [B, H, D], got "
                         f"{q.dtype} {tuple(q.shape)}")
    dtype = q.dtype if dtype is None else dtype
    b, h, d = q.shape
    if d not in (INT8_HEAD_DIMS if dtype == torch.int8 else SUPPORTED_HEAD_DIMS):
        raise ValueError(f"{what}: no kernel for head dim {d}")
    for name, t in pools:
        if t.device != q.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous {dtype} on {q.device}")
        if t.dim() != 3 or t.shape[2] != h * d:
            raise ValueError(f"{what}: {name} must be [*, *, H*D={h * d}], got {tuple(t.shape)}")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")
    for name, t in scales:
        if (t.device != q.device or t.dtype != torch.float32 or not t.is_contiguous()
                or t.shape != pools[0][1].shape[:2] + (h,)):
            raise ValueError(f"{what}: {name} must be contiguous f32 "
                             f"{tuple(pools[0][1].shape[:2]) + (h,)} on {q.device}")


def _check_table(q, k, v, page_table, what):
    if k.shape != v.shape or not 1 <= k.shape[1] <= MAX_TILE:
        raise ValueError(f"{what}: pools {tuple(k.shape)}/{tuple(v.shape)} "
                         f"must match with page_size <= {MAX_TILE}")
    b = q.shape[0]
    if (page_table.device != q.device or page_table.dtype != torch.int32
            or page_table.dim() != 2 or page_table.shape[0] != b
            or not page_table.is_contiguous()):
        raise ValueError(f"{what}: page_table must be a contiguous "
                         f"int32 [B={b}, PP] tensor on {q.device}")


def _check_slab(q, k, v, what):
    b = q.shape[0]
    if k.shape != v.shape or k.shape[0] != b:
        raise ValueError(f"{what}: slabs {tuple(k.shape)}/{tuple(v.shape)} "
                         f"must be [B={b}, S, H*D]")


def _launch(q, k, v, scales, table, valid_len, tile, n_tiles, s, n_pages, what):
    """The bf16 or f32 kernels (``scales`` None, by q's dtype) or the int8
    kernels (``scales`` = (k_scale, v_scale)) over ceil(n_tiles /
    :func:`split_tiles`) splits. bf16 at head dim 32: one cluster launch of
    :func:`d32_cluster` CTAs a (row, head), no scratch. Else the split
    kernel, then the combine, which reads the f32 partials ``[B, H,
    n_splits, D + 2]`` (never zeroed: only live splits are written and
    read). An int ``valid_len`` is passed by value, a tensor as the
    kernels' ``[B]`` int32 lengths."""
    b, h, d = q.shape
    if isinstance(valid_len, torch.Tensor):
        lens, len_all = _row_lens(valid_len, b, q.device), 0
    else:
        lens, len_all = None, int(valid_len)
    per_split = split_tiles(tile)
    n_splits = -(-n_tiles // per_split)
    out = torch.empty_like(q)
    lib = build.load("flash_decode", _SIGNATURES)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr()]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if scales is None and q.dtype == torch.bfloat16 and d == 32:
        rc = lib.dftt_flash_decode_d32(*ptrs, None if table is None else table.data_ptr(),
                                       None if lens is None else lens.data_ptr(), out.data_ptr(),
                                       b, h, tile, n_tiles, s, n_pages, per_split, n_splits,
                                       d32_cluster(n_splits), len_all, 1.0 / math.sqrt(d), stream)
        build.check(rc, what)
        return out
    partial = torch.empty((b, h, n_splits, d + 2), dtype=torch.float32, device=q.device)
    if scales is None:
        fn = lib.dftt_flash_decode_f32 if q.dtype == torch.float32 else lib.dftt_flash_decode_bf16
    else:
        fn = lib.dftt_flash_decode_int8
        ptrs += [scales[0].data_ptr(), scales[1].data_ptr()]
    rc = fn(*ptrs, None if table is None else table.data_ptr(),
            None if lens is None else lens.data_ptr(),
            partial.data_ptr(), out.data_ptr(), b, h, d, tile,
            n_tiles, s, n_pages, per_split, n_splits, len_all, 1.0 / math.sqrt(d), stream)
    build.check(rc, what)
    return out


def flash_decode_paged(q, k, v, page_table, valid_len, k_scale=None, v_scale=None
                       ) -> torch.Tensor:
    """Decode attention against a paged cache, one query token per row.

    ``q``: [B, H, D]; ``k``/``v``: page pools ``[n_pages, page_size,
    H*D]`` (q's dtype, bf16 or f32; or int8 with ``k_scale``/``v_scale`` ``[n_pages,
    page_size, H]`` f32 pools: :func:`flash_decode_paged_int8`);
    ``page_table``: [B, PP] int32 (entries ``>= n_pages`` are sentinels);
    ``valid_len``: an int or a ``[B]`` tensor of per-row windows. Returns
    [B, H, D] in q's dtype."""
    if k_scale is not None:
        return flash_decode_paged_int8(q, k, v, k_scale, v_scale, page_table, valid_len)
    if q.device.type == "cpu":
        return flash_decode_paged_reference(q, k, v, page_table, valid_len)
    _check_cuda(q, (("k", k), ("v", v)), "flash_decode_paged")
    _check_table(q, k, v, page_table, "flash_decode_paged")
    n_pages, ps, _ = k.shape
    pp = page_table.shape[1]
    out = _launch(q, k, v, None, page_table, valid_len,
                  ps, pp, pp * ps, n_pages, "flash_decode_paged")
    build.count_launch(flash_decode_paged, q.shape[-1], q.dtype)
    return out


def flash_decode(q, k, v, valid_len, k_scale=None, v_scale=None) -> torch.Tensor:
    """Decode attention for ONE query token per row against a token-major
    slab ``k``/``v`` ``[B, S, H*D]`` (q's dtype, bf16 or f32; or int8 with
    ``k_scale``/``v_scale`` ``[B, S, H]`` f32: :func:`flash_decode_int8`);
    ``valid_len`` is an int (every row attends to ``[0, valid_len)``) or a
    ``[B]`` tensor. Returns [B, H, D] in q's dtype."""
    if k_scale is not None:
        return flash_decode_int8(q, k, v, k_scale, v_scale, valid_len)
    if q.device.type == "cpu":
        return flash_decode_reference(q, k, v, valid_len)
    _check_cuda(q, (("k", k), ("v", v)), "flash_decode")
    _check_slab(q, k, v, "flash_decode")
    s = k.shape[1]
    out = _launch(q, k, v, None, None, valid_len,
                  SLAB_TILE, -(-s // SLAB_TILE), s, 0, "flash_decode")
    build.count_launch(flash_decode, q.shape[-1], q.dtype)
    return out


def flash_decode_paged_int8(q, k, v, k_scale, v_scale, page_table, valid_len) -> torch.Tensor:
    """:func:`flash_decode_paged` over an int8 pool with f32 scale pools
    (the int8 kernel, its own launch count)."""
    if q.device.type == "cpu":
        return flash_decode_paged_int8_reference(q, k, v, k_scale, v_scale, page_table,
                                                 valid_len)
    what = "flash_decode_paged_int8"
    _check_cuda(q, (("k", k), ("v", v)), what, torch.int8,
                (("k_scale", k_scale), ("v_scale", v_scale)))
    _check_table(q, k, v, page_table, what)
    n_pages, ps, _ = k.shape
    pp = page_table.shape[1]
    out = _launch(q, k, v, (k_scale, v_scale), page_table,
                  valid_len, ps, pp, pp * ps, n_pages, what)
    build.count_launch(flash_decode_paged_int8)
    return out


def flash_decode_int8(q, k, v, k_scale, v_scale, valid_len) -> torch.Tensor:
    """:func:`flash_decode` over an int8 slab with f32 scales (the int8
    kernel, its own launch count)."""
    if q.device.type == "cpu":
        return flash_decode_int8_reference(q, k, v, k_scale, v_scale, valid_len)
    what = "flash_decode_int8"
    _check_cuda(q, (("k", k), ("v", v)), what, torch.int8,
                (("k_scale", k_scale), ("v_scale", v_scale)))
    _check_slab(q, k, v, what)
    s = k.shape[1]
    out = _launch(q, k, v, (k_scale, v_scale), None, valid_len,
                  SLAB_TILE, -(-s // SLAB_TILE), s, 0, what)
    build.count_launch(flash_decode_int8)
    return out


#: kernel launches since the count was last set to 0 (bf16 and f32 also by
#: head dim and by dtype)
flash_decode_paged.launches = 0
flash_decode_paged.launches_by_head_dim = {}
flash_decode_paged.launches_by_dtype = {}
flash_decode.launches = 0
flash_decode.launches_by_head_dim = {}
flash_decode.launches_by_dtype = {}
flash_decode_paged_int8.launches = 0
flash_decode_int8.launches = 0
