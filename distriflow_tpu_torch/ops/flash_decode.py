"""Single-token decode attention: a hand-written Hopper kernel for the
paged and the slab KV cache, and its plain version.

Port of ``distriflow_tpu/ops/flash_decode.py`` (bf16 caches; the int8
variants wait). ``csrc/flash_decode.cu`` replaces two Pallas kernels:
``_paged_kernel`` (:func:`flash_decode_paged`, one query per row against a
``[n_pages, page_size, H*D]`` pool through a ``[B, PP]`` page table) and
``_decode_kernel`` (:func:`flash_decode`, against a token-major
``[B, S, H*D]`` slab). One kernel serves both: the slab is read as a page
table that is the identity, with :data:`SLAB_TILE`-position pages, so at
``page_size == SLAB_TILE`` both accumulate in the same order and the
serving engine's paged decode matches solo ``generate()`` on the card.

Numeric contract (both the kernel and the plain versions here): q, K and
V enter the products as bf16; scores, the running max and sum stay f32; p
is rounded to bf16 for the PV product; accumulation is f32; positions at
or past a row's valid length score -1e30. Sentinel page-table entries
(``>= n_pages``) clamp to the last page, whose contents the length mask
discards. The TPU kernel's block-diagonal query layout existed only to
feed the TPU's matrix unit and is not carried over.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Union

import torch

from distriflow_tpu_torch.ops import build

NEG_INF = -1e30
SLAB_TILE = 128  # slab positions per tile: the identity table's page size
MAX_TILE = 256  # largest page the kernel's shared score row holds
SUPPORTED_HEAD_DIMS = (64,)  # the head dims the kernel is built and checked for

_SIGNATURES = {
    "dftt_flash_decode_bf16": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
}


def _note_refused() -> None:
    from distriflow_tpu_torch.obs import get_telemetry

    get_telemetry().counter(
        "ops_flash_decode_gated_total",
        help="decode shapes the kernel gates refused (a CUDA model raises on them)",
    ).inc()


def _kernel_takes(hd: int, kv_item: int, d: int) -> bool:
    return kv_item == 2 and d in SUPPORTED_HEAD_DIMS and hd % d == 0


def supports_seq(s: int, hd: int = 512, kv_item: int = 2, d: int = 64) -> bool:
    """True when :func:`flash_decode` takes a slab of ``s`` positions at
    packed width ``hd``, itemsize ``kv_item`` and head dim ``d``: bf16 and
    a supported head dim (any ``s``; the last tile is masked). A refused
    shape bumps ``ops_flash_decode_gated_total``; there is no plain path
    on the card to route it to, so the caller raises."""
    if s >= 1 and _kernel_takes(hd, kv_item, d):
        return True
    _note_refused()
    return False


def supports_paged(page_size: int, hd: int = 512, kv_item: int = 2, d: int = 64) -> bool:
    """True when :func:`flash_decode_paged` takes pages of ``page_size``
    positions: at most :data:`MAX_TILE`, bf16, a supported head dim. A
    refused shape bumps ``ops_flash_decode_gated_total``."""
    if 1 <= page_size <= MAX_TILE and _kernel_takes(hd, kv_item, d):
        return True
    _note_refused()
    return False


def _row_lens(valid_len: Union[int, torch.Tensor], b: int, device) -> torch.Tensor:
    if isinstance(valid_len, torch.Tensor):
        return valid_len.to(device=device, dtype=torch.int32).reshape(-1).expand(b).contiguous()
    return torch.full((b,), int(valid_len), dtype=torch.int32, device=device)


def _online_softmax(q, tiles, lens, tile):
    """The kernel's recurrence in plain PyTorch: ``tiles`` yields
    ``(k, v)`` of shape ``[B, T, H, D]`` for consecutive tiles of ``tile``
    positions; returns ``[B, H, D]`` f32."""
    b, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qf = q.to(torch.bfloat16).float()
    m = torch.full((b, h), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, d), dtype=torch.float32, device=q.device)
    for j, (kt, vt) in enumerate(tiles):
        kt = kt.to(torch.bfloat16).float()
        vt = vt.to(torch.bfloat16).float()
        s = torch.einsum("bhd,bphd->bhp", qf, kt) * scale
        pos = j * tile + torch.arange(kt.shape[1], device=q.device)
        s = torch.where(pos[None, None, :] < lens[:, None, None], s,
                        torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhp,bphd->bhd", p.to(torch.bfloat16).float(), vt)
        acc = acc * corr[..., None] + pv
        m = m_new
    return acc * (1.0 / l.clamp_min(1e-30))[..., None]


def flash_decode_paged_reference(q, k, v, page_table, valid_len) -> torch.Tensor:
    """Plain version of :func:`flash_decode_paged`."""
    b, h, d = q.shape
    n_pages, ps, hd = k.shape
    lens = _row_lens(valid_len, b, q.device)
    tab = page_table.long().clamp(0, n_pages - 1)

    def tiles():
        for j in range(tab.shape[1]):
            yield (k[tab[:, j]].reshape(b, ps, h, d), v[tab[:, j]].reshape(b, ps, h, d))

    return _online_softmax(q, tiles(), lens, ps).to(q.dtype)


def flash_decode_reference(q, k, v, valid_len) -> torch.Tensor:
    """Plain version of :func:`flash_decode`."""
    b, h, d = q.shape
    s = k.shape[1]
    lens = _row_lens(valid_len, b, q.device)

    def tiles():
        for t0 in range(0, s, SLAB_TILE):
            t1 = min(t0 + SLAB_TILE, s)
            yield (k[:, t0:t1].reshape(b, t1 - t0, h, d), v[:, t0:t1].reshape(b, t1 - t0, h, d))

    return _online_softmax(q, tiles(), lens, SLAB_TILE).to(q.dtype)


def _check_cuda(q, pools, what):
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    if q.dim() != 3 or q.dtype != torch.bfloat16 or not q.is_contiguous():
        raise ValueError(f"{what}: q must be contiguous bf16 [B, H, D], got "
                         f"{q.dtype} {tuple(q.shape)}")
    b, h, d = q.shape
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{what}: no kernel for head dim {d}")
    for name, t in pools:
        if t.device != q.device or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous bf16 on {q.device}")
        if t.dim() != 3 or t.shape[2] != h * d:
            raise ValueError(f"{what}: {name} must be [*, *, H*D={h * d}], got {tuple(t.shape)}")


def _launch(q, k, v, table, lens, tile, n_tiles, s, n_pages, what):
    b, h, d = q.shape
    out = torch.empty_like(q)
    lib = build.load("flash_decode", _SIGNATURES)
    rc = lib.dftt_flash_decode_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if table is None else table.data_ptr(), lens.data_ptr(),
        out.data_ptr(), b, h, d, tile, n_tiles, s, n_pages, 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, what)
    return out


def flash_decode_paged(q, k, v, page_table, valid_len) -> torch.Tensor:
    """Decode attention against a paged cache, one query token per row.

    ``q``: [B, H, D]; ``k``/``v``: page pools ``[n_pages, page_size,
    H*D]``; ``page_table``: [B, PP] int32 (entries ``>= n_pages`` are
    sentinels); ``valid_len``: an int or a ``[B]`` tensor of per-row
    windows. Returns [B, H, D] in q's dtype."""
    if q.device.type == "cpu":
        return flash_decode_paged_reference(q, k, v, page_table, valid_len)
    _check_cuda(q, (("k", k), ("v", v)), "flash_decode_paged")
    if k.shape != v.shape or not 1 <= k.shape[1] <= MAX_TILE:
        raise ValueError(f"flash_decode_paged: pools {tuple(k.shape)}/{tuple(v.shape)} "
                         f"must match with page_size <= {MAX_TILE}")
    b = q.shape[0]
    if (page_table.device != q.device or page_table.dtype != torch.int32
            or page_table.dim() != 2 or page_table.shape[0] != b
            or not page_table.is_contiguous()):
        raise ValueError("flash_decode_paged: page_table must be a contiguous "
                         f"int32 [B={b}, PP] tensor on {q.device}")
    n_pages, ps, _ = k.shape
    pp = page_table.shape[1]
    out = _launch(q, k, v, page_table, _row_lens(valid_len, b, q.device),
                  ps, pp, pp * ps, n_pages, "flash_decode_paged")
    flash_decode_paged.launches += 1
    return out


def flash_decode(q, k, v, valid_len) -> torch.Tensor:
    """Decode attention for ONE query token per row against a token-major
    slab ``k``/``v`` ``[B, S, H*D]``; ``valid_len`` is an int (every row
    attends to ``[0, valid_len)``) or a ``[B]`` tensor. Returns [B, H, D]
    in q's dtype."""
    if q.device.type == "cpu":
        return flash_decode_reference(q, k, v, valid_len)
    _check_cuda(q, (("k", k), ("v", v)), "flash_decode")
    b = q.shape[0]
    if k.shape != v.shape or k.shape[0] != b:
        raise ValueError(f"flash_decode: slabs {tuple(k.shape)}/{tuple(v.shape)} "
                         f"must be [B={b}, S, H*D]")
    s = k.shape[1]
    out = _launch(q, k, v, None, _row_lens(valid_len, b, q.device),
                  SLAB_TILE, -(-s // SLAB_TILE), s, 0, "flash_decode")
    flash_decode.launches += 1
    return out


#: kernel launches since the count was last set to 0
flash_decode_paged.launches = 0
flash_decode.launches = 0
