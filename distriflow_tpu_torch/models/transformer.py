"""Port of ``distriflow_tpu/models/transformer.py``: the dense decoder LM.

``TransformerConfig`` keeps the JAX field names (``dtype`` is a
``torch.dtype``). The modules are ``nn.Module``s holding weights in the
JAX kernel layout (``[in, out]``), so
:mod:`distriflow_tpu_torch.models.convert` copies a flax params tree over
without transposes. :func:`pipelined_transformer_lm` builds the pipelined
LM (:class:`PipelinedTransformerLM`) over a mesh's ``pipe`` axis.

One module class serves both uses; whoever builds it picks the parameter
storage with ``TransformerLM(config, trainable=...)``:

- **serving** (``trainable=False``, the default): matmul weights and the
  embedding are stored once in ``cfg.dtype`` and frozen. The per-call cast
  to ``cfg.dtype`` is then the identity, so decoding pays nothing for it.
- **training** (``trainable=True``, what :func:`transformer_lm`'s
  ``init`` builds): every parameter is an f32 master that requires grad
  and is cast to ``cfg.dtype`` inside ``forward``, as flax keeps f32
  params and computes in ``dtype``. The embedding is indexed, then cast:
  the same values as flax's cast-then-take without casting the whole
  table every step.

Layer arithmetic follows flax exactly: ``LayerNorm`` runs in f32 with
``eps=1e-6``; every ``Dense``/``DenseGeneral`` computes in ``cfg.dtype``;
``gelu`` is the tanh form; the residual stream is ``cfg.dtype`` (f32 from
the first MoE block on: see :class:`MoEFFN`). Training
logits stay in ``cfg.dtype`` when they feed the fused CE and are f32
otherwise (``_cast_logits``); decode logits are f32. ``remat=True`` wraps
each block in ``torch.utils.checkpoint`` during training (flax
``nn.remat``): its activations are recomputed in the backward.

Training-mode attention goes through the differentiable
:func:`~distriflow_tpu_torch.ops.flash_attention.flash_attention` (the
forward and backward kernels on CUDA) or, with ``use_flash_attention``
off, through plain attention.

Decoding carries an explicit :class:`KVCache` in place of flax's mutable
``cache`` collection. Its three layouts match the JAX cache pytrees:

- solo: ``[B, max_seq, H*D]`` slabs with a scalar position (``generate``);
- slot: the same slabs at ``max_slots`` rows with a ``[B]`` position
  vector (the continuous-batching engine's slab layout);
- paged: one ``[n_pages, page_size, H*D]`` pool per layer, a ``[B]``
  position vector and a ``[B, pages_per_slot + 1]`` page table whose last
  column is pinned at the sentinel ``n_pages``.

With ``kv_cache_dtype="int8"`` (gated on context, see
:meth:`TransformerConfig.kv_cache_dtype_for`) or ``"int8_force"`` the
cache holds int8 K/V with f32 scales per (position, head) beside them, in
every layout; a fresh prefill attends over the exact projections, the
decode kernels fold the scales in, and the plain path dequantizes (f32
product, then cast) and quantizes q for single-token steps, as JAX does.

**On a mesh** (``TransformerLM(..., mesh=)``, a five-axis mesh of
``distriflow_tpu_torch.parallel``) every rank holds its local blocks of the
parameters (``parallel/sharding.py::shard_params``) and computes on local
tensors, with the collectives GSPMD would insert written out:

- a sharded ``q/k/v_proj`` (whole heads) and ``mlp.wi`` are
  column-parallel, ``o_proj`` and ``mlp.wo`` row-parallel: the block's
  input passes ``copy_to`` over ``model`` and its output ``psum``
  (Megatron's f/g); attention (kernel 1 on CUDA) runs on the local
  ``[B/dp, H/tp, S, D]`` with no collective;
- ``embed`` sharded on ``d_model``: its output is all-gathered over
  ``model``; ``lm_head`` sharded on vocab: the logits stay vocab-parallel
  (the spec's loss then runs the vocab-parallel CE, ``models/losses.py``);
- with ``use_ring_attention`` or ``use_ulysses_attention`` and a ``seq``
  axis above 1, the residual stream stays sequence-sharded: RoPE takes
  global positions (the local index plus ``rank_in_seq x chunk``) and
  attention runs over the ring or the all-to-all;
- MoE experts sharded over ``expert`` (EP): tokens are sharded over
  ``data`` only, so every rank of an ``expert`` group holds the same
  tokens; each rank dispatches to, runs and combines its own E/ep experts
  (and their ``model`` slice) and the combine is ``psum``'d over
  ``expert``. The routing group is ``_auto_block`` of the global token
  count, and the load-balance term's means and ``dropped_fraction`` are
  global (all-reduced over ``data``).

A parameter is sharded where its local shape is smaller than its full
shape, so the same module runs any rule table that shards these dims.
Decoding on a mesh (``decode``, so every path of ``models/generate.py``)
runs SPMD: every rank takes the same tokens (rows replicated over
``data``), its KV cache holds its ``model`` slice of the heads, every
attention path runs on those heads (kernel 1 for a fresh prefill, kernels
2-5 for a token), ``o_proj``'s partials are ``psum``'d, and the
vocab-parallel logits are all-gathered over ``model`` before any
sampling; dense MoE dispatch over sharded experts ``psum``'s each rank's
partial combine over ``expert``/``model``.

Cache writes update the tensors in place (JAX rebuilds them functionally);
that saves a copy of the whole pool per step. JAX's scatters silently drop
out-of-range indices where ``index_put_`` would raise or wrap, so every
write here masks them out explicitly.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from distriflow_tpu_torch.models.base import ModelSpec
from distriflow_tpu_torch.ops import flop_count
from distriflow_tpu_torch.ops.flash_attention import (
    BWD_HEAD_DIMS,
    KERNEL_DTYPES,
    backward_supported,
    flash_attention,
    flash_seq_supported,
)
from distriflow_tpu_torch.parallel.collectives import (
    _all_gather,
    all_gather_invariant,
    copy_to,
    psum,
)
from distriflow_tpu_torch.parallel.mesh import axis_index, axis_size
from distriflow_tpu_torch.parallel.ring_attention import (
    _auto_block,
    dense_attention,
    ring_attention,
)
from distriflow_tpu_torch.parallel.ulysses import ulysses_attention
from distriflow_tpu_torch.ops.flash_decode import (
    INT8_HEAD_DIMS,
    MAX_TILE,
    MIN_BLOCK_K,
    SUPPORTED_HEAD_DIMS,
    flash_decode,
    flash_decode_paged,
    quantize_int8,
    supports_paged,
    supports_seq,
)

NEG_INF = -1e30
LN_EPS = 1e-6  # flax nn.LayerNorm's default epsilon
# Context length from which kv_cache_dtype="int8" stores an int8 cache
# (below it the cache stays cfg.dtype). The JAX package's value, copied
# as it is: it decides which cache a request gets, so it is part of the
# semantics the port must match. It was measured on a TPU; the H100's own
# int8-vs-bf16 crossover is measured by chip_smoke.py (row 4's
# by_context) and recorded in PERF.md.
INT8_KV_DECODE_CROSSOVER_SEQ = 8192
KV_CACHE_DTYPES = (None, "int8", "int8_force")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Same fields as the JAX config."""

    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 4
    d_ff: int = 2048
    max_seq: int = 2048
    n_experts: int = 0
    moe_top_k: int = 1
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_group_size: int = 1024
    moe_dense_dispatch: bool = False
    dtype: torch.dtype = torch.bfloat16
    use_ring_attention: bool = False
    use_ulysses_attention: bool = False
    # hand-written CUDA kernels (distriflow_tpu_torch/ops): None = the
    # kernel whenever the tensors are on CUDA, the plain path on the CPU
    use_flash_attention: Optional[bool] = None
    causal: bool = True
    use_rope: bool = True
    rope_base: float = 10000.0
    remat: bool = False
    pipeline_schedule: Optional[str] = None
    loss: Optional[str] = None
    kv_cache_dtype: Optional[str] = None
    use_flash_decode: Optional[bool] = None

    def __post_init__(self):
        if not isinstance(self.dtype, torch.dtype):
            raise TypeError(f"dtype must be a torch.dtype, got {self.dtype!r}")
        if self.d_model % self.n_heads:
            raise ValueError(
                f"d_model {self.d_model} not divisible by n_heads {self.n_heads}")
        if self.n_experts > 0 and not 1 <= self.moe_top_k <= self.n_experts:
            raise ValueError(
                f"moe_top_k must be in [1, n_experts={self.n_experts}], got {self.moe_top_k}")
        if self.use_ring_attention and self.use_ulysses_attention:
            raise ValueError(
                "use_ring_attention and use_ulysses_attention are mutually "
                "exclusive sequence-parallel strategies; pick one")
        if self.kv_cache_dtype not in KV_CACHE_DTYPES:
            raise ValueError(
                f"kv_cache_dtype must be None, 'int8', or 'int8_force', "
                f"got {self.kv_cache_dtype!r}")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def kv_cache_dtype_for(self, context_len: int) -> Optional[str]:
        """The cache precision a decode that reads ``context_len`` positions
        stores: ``"int8"`` when forced or at/above
        :data:`INT8_KV_DECODE_CROSSOVER_SEQ`, else None (``cfg.dtype``)."""
        if self.kv_cache_dtype == "int8_force":
            return "int8"
        if self.kv_cache_dtype == "int8" and context_len >= INT8_KV_DECODE_CROSSOVER_SEQ:
            return "int8"
        return None

    @property
    def resolved_kv_cache_dtype(self) -> Optional[str]:
        """:meth:`kv_cache_dtype_for` at ``max_seq``: the precision when only
        the allocation bound is known (the serving engine's caches)."""
        return self.kv_cache_dtype_for(self.max_seq)

    def resolved_loss_for(self, device: Optional[Union[str, torch.device]] = None,
                          mesh=None) -> str:
        """The loss name the model spec trains with. An explicit ``loss`` is
        always honored; ``loss=None`` resolves to the fused sparse CE (its
        CUDA kernels) on a CUDA device and to the plain sparse CE on the
        CPU, as JAX resolves to the fused Pallas CE on a TPU only.
        ``device=None`` is the port's default device, CUDA. On a ``mesh``
        whose ``model``, ``pipe`` or ``seq`` axis is above 1 it is the
        plain sparse CE, as in JAX (vocab-sharded logits, or a sequence
        dim the fused CE's flat rows do not cover); a mesh whose only
        axes above 1 are ``data`` and ``expert`` keeps the fused CE on the
        local rows."""
        if self.loss is not None:
            return self.loss
        if mesh is not None and any(axis_size(mesh, ax) > 1 for ax in ("model", "pipe", "seq")):
            return "sparse_softmax_cross_entropy"
        dev = torch.device("cuda" if device is None else device)
        return ("fused_sparse_softmax_cross_entropy" if dev.type == "cuda"
                else "sparse_softmax_cross_entropy")

    @property
    def resolved_loss(self) -> str:
        """Resolution on the default device (single-device semantics)."""
        return self.resolved_loss_for(None)

    def sequence_sharded(self, mesh) -> bool:
        """True when the residual stream runs sequence-sharded on ``mesh``:
        ring or Ulysses attention and a ``seq`` axis above 1."""
        return (self.use_ring_attention or self.use_ulysses_attention) and \
            axis_size(mesh, "seq") > 1


def apply_rope(
    q: torch.Tensor, k: torch.Tensor, base: float = 10000.0,
    offset: Union[int, torch.Tensor] = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotary embeddings (rotate-half) over ``[B, H, S, D]`` q/k, angles in
    f32. ``offset`` is a scalar (every row starts there) or a ``[B]``
    vector (each slot row at its own depth)."""
    d = q.shape[-1]
    if d % 2:
        raise ValueError(f"RoPE needs an even head dim, got {d}")
    half = d // 2
    dev = q.device
    steps = torch.arange(q.shape[2], dtype=torch.float32, device=dev)
    off = torch.as_tensor(offset, dtype=torch.float32, device=dev)
    if off.dim() == 0:
        pos = off + steps  # [S]
    elif off.dim() == 1:
        pos = off[:, None] + steps[None, :]  # [B, S]
    else:
        raise ValueError(f"RoPE offset must be scalar or [B], got ndim={off.dim()}")
    freqs = base ** (-torch.arange(0, half, dtype=torch.float32, device=dev) / half)
    angles = pos[..., None] * freqs  # [S, half] or [B, S, half]
    cos, sin = torch.cos(angles), torch.sin(angles)
    if off.dim() == 1:
        cos, sin = cos[:, None], sin[:, None]  # broadcast over heads

    def rot(x):
        xf = x.float()
        x1, x2 = xf[..., :half], xf[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)

    return rot(q), rot(k)


def _use_kernel(flag: Optional[bool], t: torch.Tensor) -> bool:
    """The tri-state kernel switch: None means "on CUDA tensors"."""
    return t.device.type == "cuda" if flag is None else flag


def check_kernels_take(config: TransformerConfig, device: torch.device,
                       page_size: Optional[int] = None, training: bool = False,
                       decode: bool = True) -> None:
    """Raise ``NotImplementedError`` when a model on CUDA would need a
    kernel for a dtype, head dim, length or page size the kernels do not
    take. The prompt attention is always checked, its backward with
    ``training``, and the decode kernels with ``decode`` (paged ones at
    ``page_size``). A model is checked when it is built, without
    ``decode``; a decode cache when it is built (:func:`cache_buffers`,
    ``models/generate.py::paged_cache``), with it. So a model whose decode
    shape JAX would send to XLA (an f32 cache at pages under 128, or a slab
    no JAX tile divides) trains and refuses its decode by name, when one is
    set up. There is no plain path on the card to fall back to; a caller who wants
    the plain path there sets ``use_flash_attention``/``use_flash_decode``
    to False."""
    if device.type != "cuda":
        return
    item = torch.empty((), dtype=config.dtype).element_size()
    hd, d = config.n_heads * config.head_dim, config.head_dim
    refused = []
    flash = config.use_flash_attention is not False
    if flash and not (config.dtype in KERNEL_DTYPES
                      and flash_seq_supported(config.max_seq, d, item)):
        refused.append("prefill attention")
    if training and flash and not backward_supported(d, config.dtype):
        refused.append("the attention backward")
    if decode and config.use_flash_decode is not False:
        # the cache precisions a decode can get: the context gate may pick
        # either side of the crossover under kv_cache_dtype="int8"
        for kv_item in sorted({1 if config.kv_cache_dtype_for(n) == "int8" else item
                               for n in (1, config.max_seq)}):
            tag = " (int8 cache)" if kv_item == 1 else ""
            # the kernels read a q of the cache's dtype, bf16 or f32; the
            # int8 kernels a bf16 q
            q_taken = config.dtype == torch.bfloat16 or (
                config.dtype == torch.float32 and kv_item == 4)
            if not (supports_seq(config.max_seq, hd=hd, kv_item=kv_item, d=d) and q_taken):
                refused.append("slab decode" + tag)
            if page_size is not None and not (
                    supports_paged(page_size, hd=hd, kv_item=kv_item, d=d) and q_taken):
                refused.append(f"paged decode at page_size {page_size}{tag}")
    if refused:
        raise NotImplementedError(
            f"no CUDA kernel for {', '.join(refused)} at dtype {config.dtype}, "
            f"head dim {d}, max_seq {config.max_seq}: the attention kernels take bf16 and "
            f"f32 at head dims {SUPPORTED_HEAD_DIMS} (the backward at {BWD_HEAD_DIMS}), the "
            f"decode kernels bf16 and f32 caches with a query of the cache's dtype at "
            f"{SUPPORTED_HEAD_DIMS} and pages up to {MAX_TILE} (f32 where JAX's flash-decode "
            f"gate takes the shape: pages of at least {MIN_BLOCK_K}, a multiple of 8, slabs "
            f"it can tile), int8 caches with a bf16 query at {INT8_HEAD_DIMS}")


def quantize_kv(t: torch.Tensor, n_heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric absmax int8 per (position, head), JAX ``_quantize``:
    ``[B, s, H*D]`` -> (int8 ``[B, s, H*D]``, f32 scales ``[B, s, H]``).
    Values are ``clip(round_half_even(t / max(scale, 1e-20)), -127, 127)``;
    the stored scale is the unclamped one, so a zero row stores 0."""
    b, s, hd = t.shape
    q8, scale = quantize_int8(t.reshape(b, s, n_heads, hd // n_heads))
    return q8.to(torch.int8).reshape(b, s, hd), scale


def dequantize_kv(x8: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int8 ``[B, S, H*D]`` with ``[B, S, H]`` scales -> ``dtype``: the f32
    product, then the cast (JAX ``transformer.py:472-480``)."""
    b, s, hd = x8.shape
    h = scale.shape[-1]
    return (x8.float().reshape(b, s, h, hd // h) * scale[..., None]).to(dtype).reshape(b, s, hd)


class KVCache:
    """Per-layer K/V storage plus the write position(s); see the module
    docstring for the three layouts. ``index`` is an ``int`` (solo) or a
    ``[B]`` int32 tensor (slot and paged). The page table is held once,
    not per layer as in the JAX pytree: every layer's copy was identical.

    An int8 cache also carries ``k_scale``/``v_scale``: per-layer f32
    ``[B, max_seq, H]`` slabs or ``[n_pages, page_size, H]`` pools, written
    by every path that writes K/V. ``stores`` maps each leaf name (JAX's
    ``_POOL_LEAVES``: ``k``, ``v`` and, for int8, ``k_scale``, ``v_scale``)
    to its per-layer storages, ``pools`` to the same without the scratch
    page.

    A paged cache is built from ``[n_pages + 1, page_size, F]`` storages
    whose last page is scratch: ``k``/``v`` (and the scale pools) are the
    ``[n_pages, ...]`` pools in front of it, and writes that JAX drops
    (sentinel pages, masked positions) are routed into the scratch page,
    which nothing reads. That drops them without the host sync a
    boolean-mask index would cost.
    """

    def __init__(self, k: List[torch.Tensor], v: List[torch.Tensor],
                 index: Union[int, torch.Tensor], max_seq: int,
                 page_table: Optional[torch.Tensor] = None,
                 k_scale: Optional[List[torch.Tensor]] = None,
                 v_scale: Optional[List[torch.Tensor]] = None):
        self.index = index
        self.max_seq = max_seq
        self.page_table: Optional[torch.Tensor] = None
        self._kernel_table: Optional[torch.Tensor] = None
        self.stores = {"k": k, "v": v}
        if k_scale is not None:
            self.stores.update(k_scale=k_scale, v_scale=v_scale)
        if page_table is None:
            self.pools = self.stores
        else:  # leading slices: still contiguous
            self.pools = {name: [t[:-1] for t in ts] for name, ts in self.stores.items()}
            self.set_page_table(page_table)
        self.k, self.v = self.pools["k"], self.pools["v"]
        self.k_scale, self.v_scale = self.pools.get("k_scale"), self.pools.get("v_scale")

    @property
    def quant(self) -> bool:
        """True for an int8 cache (K/V int8, f32 scales beside them)."""
        return self.k_scale is not None

    def drop_to_scratch(self, flat: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
        """Paged: flat pool offsets with every ``~keep`` entry moved into
        the scratch page (same in-page offset, so it stays in range)."""
        n_pg, ps, _ = self.k[0].shape
        return torch.where(keep, flat, n_pg * ps + flat % ps)

    @property
    def paged(self) -> bool:
        return self.page_table is not None

    @property
    def slot_mode(self) -> bool:
        return isinstance(self.index, torch.Tensor)

    def set_page_table(self, table: torch.Tensor) -> None:
        """Install ``table`` ([B, pages_per_slot + 1] int32, last column the
        sentinel) and refresh the contiguous copy the decode kernel reads."""
        self.page_table = table.to(torch.int32).contiguous()
        self._kernel_table = self.page_table[:, :-1].contiguous()

    def store(self, layer: int, k_tok: torch.Tensor, v_tok: torch.Tensor) -> None:
        """Write ``[B, s, H*D]`` K/V at each row's own position (an int8
        cache quantizes them first and writes their scales alongside)."""
        b, s, _ = k_tok.shape
        vals = {"k": k_tok, "v": v_tok}
        if self.quant:
            h = self.k_scale[0].shape[-1]
            vals["k"], vals["k_scale"] = quantize_kv(k_tok, h)
            vals["v"], vals["v_scale"] = quantize_kv(v_tok, h)
        ck = self.k[layer]
        dev = ck.device
        if self.paged:
            n_pg, ps, _ = ck.shape
            pp = self.page_table.shape[1] - 1  # last column is the sentinel
            cols = self.index[:, None].long() + torch.arange(s, device=dev)[None, :]
            pg = torch.clamp(cols // ps, max=pp)  # logical past the table -> sentinel
            phys = torch.gather(self.page_table.long(), 1, pg)
            # sentinel pages (retired or unallocated) land in the scratch page
            flat = self.drop_to_scratch(phys * ps + cols % ps, phys < n_pg).reshape(-1)
            for name, val in vals.items():
                buf = self.stores[name][layer]
                buf.view(-1, buf.shape[-1])[flat] = val.reshape(-1, buf.shape[-1]).to(buf.dtype)
        elif self.slot_mode:
            rows = torch.arange(b, device=dev)[:, None].expand(b, s)
            cols = self.index[:, None].long() + torch.arange(s, device=dev)[None, :]
            keep = cols < ck.shape[1]  # frozen rows parked past max_seq: drop
            for name, val in vals.items():
                buf = self.stores[name][layer]
                buf[rows[keep], cols[keep]] = val[keep].to(buf.dtype)
        else:
            i = int(self.index)
            if i + s > ck.shape[1]:
                raise ValueError(f"cache write [{i}, {i + s}) past max_seq {ck.shape[1]}")
            for name, val in vals.items():
                buf = self.stores[name][layer]
                buf[:, i:i + s] = val.to(buf.dtype)

    def _rows(self, pool: torch.Tensor) -> torch.Tensor:
        """Slab-shaped ``[B, max_seq, F]`` rows of one layer's buffer. Paged
        rows are gathered through the table; sentinel entries clamp to the
        last real page, whose contents the per-row visibility mask
        discards."""
        if not self.paged:
            return pool
        n_pg, ps, feat = pool.shape
        tab = torch.clamp(self._kernel_table.long(), max=n_pg - 1)
        b, pp = tab.shape
        return pool[tab].reshape(b, pp * ps, feat)[:, :self.max_seq]

    def view(self, layer: int, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
        """Slab-shaped ``[B, max_seq, F]`` K/V of every row; an int8 cache
        is dequantized to ``dtype`` (:func:`dequantize_kv`)."""
        keys, vals = self._rows(self.k[layer]), self._rows(self.v[layer])
        if not self.quant:
            return keys, vals
        return (dequantize_kv(keys, self._rows(self.k_scale[layer]), dtype),
                dequantize_kv(vals, self._rows(self.v_scale[layer]), dtype))

    def reorder(self, rows: torch.Tensor) -> None:
        """Solo cache: gather every buffer's batch rows by ``rows`` (beam
        search tiles and reorders its beams this way, scales included)."""
        if self.paged or self.slot_mode:
            raise ValueError("reorder takes a solo cache")
        for bufs in self.stores.values():
            bufs[:] = [t[rows] for t in bufs]

    def kernel_table(self) -> torch.Tensor:
        """``[B, pages_per_slot]`` int32 table without the sentinel column."""
        return self._kernel_table

    def advance(self, s: int) -> None:
        self.index = self.index + s


def _param(*shape: int, dtype: torch.dtype, trainable: bool) -> nn.Parameter:
    """A weight: an f32 master that requires grad when ``trainable``, else
    a frozen ``dtype`` copy."""
    return nn.Parameter(torch.empty(*shape, dtype=torch.float32 if trainable else dtype),
                        requires_grad=trainable)


class Attention(nn.Module):
    def __init__(self, config: TransformerConfig, trainable: bool = False, mesh=None):
        super().__init__()
        cfg = config
        self.config = cfg
        self.mesh = mesh
        hd = cfg.n_heads * cfg.head_dim
        # JAX layout: DenseGeneral kernels [d, H, D] and [H, D, d], flattened
        self.q_proj = _param(cfg.d_model, hd, dtype=cfg.dtype, trainable=trainable)
        self.k_proj = _param(cfg.d_model, hd, dtype=cfg.dtype, trainable=trainable)
        self.v_proj = _param(cfg.d_model, hd, dtype=cfg.dtype, trainable=trainable)
        self.o_proj = _param(hd, cfg.d_model, dtype=cfg.dtype, trainable=trainable)

    def _qkv(self, x):
        cfg = self.config
        b, s, _ = x.shape
        xc = x.to(cfg.dtype)
        return tuple(
            torch.matmul(xc, w.to(cfg.dtype)).view(b, s, -1, cfg.head_dim).transpose(1, 2)
            for w in (self.q_proj, self.k_proj, self.v_proj))  # [B, H (local), s, D]

    def _out(self, ctx):
        """``ctx`` [B, s, H, D] -> [B, s, d_model] in cfg.dtype."""
        b, s = ctx.shape[:2]
        dt = self.config.dtype
        return torch.matmul(ctx.reshape(b, s, -1).to(dt), self.o_proj.to(dt))

    def _prompt_attention(self, q, k, v):
        cfg = self.config
        if _use_kernel(cfg.use_flash_attention, q):  # on CUDA: the kernels or a raise
            # differentiable: under autograd the backward kernel runs too
            return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                   causal=cfg.causal)
        return dense_attention(q, k, v, causal=cfg.causal)

    @property
    def heads_sharded(self) -> bool:
        """True when this rank holds a ``model`` slice of the heads."""
        return self.q_proj.shape[1] < self.config.n_heads * self.config.head_dim

    @property
    def local_heads(self) -> int:
        """The heads this rank holds (all of them off a mesh)."""
        return self.q_proj.shape[1] // self.config.head_dim

    def _reduce(self, out: torch.Tensor) -> torch.Tensor:
        """The row-parallel ``o_proj``'s partial sums ``psum``'d over
        ``model`` where the heads are sharded."""
        return psum(out, "model", self.mesh) if self.mesh is not None and \
            self.heads_sharded else out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Training-mode attention over the whole sequence (no cache); on a
        mesh over this rank's heads and, sequence-sharded, its chunk."""
        cfg, mesh = self.config, self.mesh
        tp = mesh is not None and self.heads_sharded
        if tp:
            x = copy_to(x, "model", mesh)
        q, k, v = self._qkv(x)
        sp = mesh is not None and cfg.sequence_sharded(mesh)
        if cfg.use_rope:
            # sequence-sharded: global positions, this chunk's start first
            offset = axis_index(mesh, "seq") * q.shape[2] if sp else 0
            q, k = apply_rope(q, k, base=cfg.rope_base, offset=offset)
        if sp and cfg.use_ring_attention:
            out = ring_attention(q, k, v, mesh, axis="seq", causal=cfg.causal,
                                 use_flash=_use_kernel(cfg.use_flash_attention, q))
        elif sp:
            out = ulysses_attention(q, k, v, mesh, axis="seq", causal=cfg.causal,
                                    use_flash=_use_kernel(cfg.use_flash_attention, q))
        else:  # local [B/dp, H/tp, S, D]: no collective
            out = self._prompt_attention(q, k, v)
        out = self._out(out.transpose(1, 2))
        return psum(out, "model", mesh) if tp else out

    def decode(self, x: torch.Tensor, cache: KVCache, layer: int, fresh: bool) -> torch.Tensor:
        """Incremental attention against ``cache`` (JAX ``_decode_attend``):
        writes this call's K/V at each row's position, then attends. With
        the heads sharded over ``model`` the cache holds this rank's heads
        and every attention path runs on them (kernel 1 for a fresh
        prefill, kernels 2-5 for a token); ``o_proj``'s partials are
        ``psum``'d."""
        return self._reduce(self._decode_local(x, cache, layer, fresh))

    def _decode_local(self, x: torch.Tensor, cache: KVCache, layer: int, fresh: bool
                      ) -> torch.Tensor:
        cfg = self.config
        b, s, _ = x.shape
        hd, heads = self.q_proj.shape[1], self.local_heads
        q, k, v = self._qkv(x)
        idx = cache.index
        if cfg.use_rope:
            q, k = apply_rope(q, k, base=cfg.rope_base, offset=idx)
        k_tok = k.transpose(1, 2).reshape(b, s, hd)
        v_tok = v.transpose(1, 2).reshape(b, s, hd)
        cache.store(layer, k_tok, v_tok)

        if s > 1 and fresh:
            # initial prefill: the cache held only zeros, so attention over
            # the prompt alone is the whole answer (prefill kernel)
            return self._out(self._prompt_attention(q, k, v).transpose(1, 2))

        if s == 1 and _use_kernel(cfg.use_flash_decode, q):  # on CUDA: the kernel or a raise
            qf = q[:, :, 0, :].contiguous()  # [B, H, D]
            lens = idx + s
            scales = {}
            if cache.quant:  # the int8 kernels quantize q and fold the scales in
                scales = dict(k_scale=cache.k_scale[layer], v_scale=cache.v_scale[layer])
            if cache.paged:
                ctx = flash_decode_paged(qf, cache.k[layer], cache.v[layer],
                                         cache.kernel_table(), lens, **scales)
            else:
                ctx = flash_decode(qf, cache.k[layer], cache.v[layer], lens, **scales)
            return self._out(ctx[:, None].to(cfg.dtype))

        if cache.quant and s == 1:
            # the int8 kernels' per-head absmax q quantization, mirrored as
            # JAX's plain path does (transformer.py:571-584)
            q8, qsc = quantize_int8(q)
            q = (q8 * qsc.clamp_min(1e-20)[..., None]).to(q.dtype)
        keys, vals = cache.view(layer, cfg.dtype)
        keys = keys.reshape(b, cfg.max_seq, heads, cfg.head_dim)
        vals = vals.reshape(b, cfg.max_seq, heads, cfg.head_dim)
        scores = torch.einsum("bhqd,bkhd->bhqk", q.float(), keys.float()) / math.sqrt(cfg.head_dim)
        k_pos = torch.arange(cfg.max_seq, device=q.device)
        steps = torch.arange(s, device=q.device)
        if cache.slot_mode:
            # per-row windows: row i sees [0, idx[i] + q); masked scores at
            # -1e30 carry exactly zero softmax mass
            q_pos = idx[:, None].long() + steps[None, :]  # [B, s]
            if cfg.causal:
                visible = k_pos[None, None, :] <= q_pos[..., None]
            else:
                visible = (k_pos[None, :] < (idx.long() + s)[:, None])[:, None, :].expand(b, s, -1)
            visible = visible[:, None]  # over heads
        else:
            q_pos = idx + steps[:, None]
            if cfg.causal:
                visible = k_pos[None, :] <= q_pos
            else:
                visible = (k_pos < idx + s)[None, :].expand(s, -1)
        scores = torch.where(visible, scores, torch.full_like(scores, NEG_INF))
        p = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bhqk,bkhd->bqhd", p, vals.float()).to(cfg.dtype)
        return self._out(ctx)


class DenseFFN(nn.Module):
    def __init__(self, config: TransformerConfig, trainable: bool = False, mesh=None):
        super().__init__()
        self.config = config
        self.mesh = mesh
        self.wi = _param(config.d_model, config.d_ff, dtype=config.dtype, trainable=trainable)
        self.wo = _param(config.d_ff, config.d_model, dtype=config.dtype, trainable=trainable)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.config.dtype
        tp = self.mesh is not None and self.wi.shape[1] < self.config.d_ff
        if tp:  # column-parallel wi, row-parallel wo
            x = copy_to(x, "model", self.mesh)
        h = F.gelu(torch.matmul(x.to(dt), self.wi.to(dt)), approximate="tanh")
        out = torch.matmul(h, self.wo.to(dt))
        return psum(out, "model", self.mesh) if tp else out


def moe_phase_fwd_flops(config: TransformerConfig, n_tok: int) -> dict:
    """Exact forward FLOPs of one capacity-routed MoE layer's phases over
    ``n_tok`` tokens (JAX ``bench.py::_moe_phase_fwd_flops``): the router's
    ``Dense(E)``, the dispatch and combine one-hot contractions over the
    choice-major ``k * g`` axis, and the experts' two ``[E, C, d] x [d, f]``
    products. These are the matmuls :class:`MoEFFN` runs, so
    ``FlopCounterMode`` counts their sum for one forward."""
    k, e = config.moe_top_k, config.n_experts
    g = _auto_block(n_tok, config.moe_group_size)
    groups = n_tok // g
    c = max(1, int(config.capacity_factor * k * g / e))
    d, f = config.d_model, config.d_ff
    return {"router": 2.0 * n_tok * d * e,
            "dispatch": 2.0 * groups * k * g * e * c * d,
            "expert": 4.0 * groups * e * c * d * f,
            "combine": 2.0 * groups * k * g * e * c * d}


class Router(nn.Module):
    """flax ``nn.Dense(E, dtype=float32)`` with a bias: ``kernel`` [d, E]
    and ``bias`` [E] are f32 in the serving model too."""

    def __init__(self, d: int, e: int, trainable: bool = False):
        super().__init__()
        self.kernel = _param(d, e, dtype=torch.float32, trainable=trainable)
        self.bias = nn.Parameter(torch.zeros(e), requires_grad=trainable)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x.float(), self.kernel) + self.bias


class MoEFFN(nn.Module):
    """JAX ``MoEFFN``: Switch top-1 (``moe_top_k=1``, combine scaled by the
    raw chosen probability) or GShard top-k (the chosen probabilities
    normalised over the pair), with capacity dispatch in routing groups of
    ``_auto_block(B*S, moe_group_size)`` tokens and ``capacity =
    max(1, int(capacity_factor * k * g / E))`` slots an expert. The
    (token, choice) pairs take slots choice-major, every first choice
    before any second; a pair past its expert's capacity gets a zero row
    and rides the residual. Dispatch and combine are one-hot contractions,
    as in JAX. ``dense=True`` (``moe_dense_dispatch``, and every call with
    a KV cache) runs every expert on every token and weighs each token's
    true top-k with the same gate weights: the no-drop limit.

    Dtypes are JAX's promotions: the router runs in f32 from f32
    parameters; the experts' contractions run in the promotion of the
    input's dtype and ``cfg.dtype`` (f32, since the input is LayerNorm's
    f32 output) over ``cfg.dtype``-rounded weights, and the dispatch and
    combine weights are rounded to ``cfg.dtype`` before they multiply, so
    the output is f32 under a bf16 config. Ties between experts go to the
    lower index, as ``jax.lax.top_k`` breaks them.

    ``forward`` returns ``(out, load_balance)``: the Switch term ``E *
    sum_e f_e * P_e`` (f_e the first-choice fraction, P_e the mean router
    probability) of a capacity forward, None for a dense one (JAX sows it
    into ``aux`` on the capacity path only). ``dropped_fraction`` holds the
    last forward's ``1 - sum(dispatch) / (k * B*S)`` (a detached 0-d
    tensor; None after a dense forward), JAX's ``moe_stats`` entry."""

    def __init__(self, config: TransformerConfig, trainable: bool = False, mesh=None):
        super().__init__()
        cfg = config
        self.config = cfg
        self.mesh = mesh
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        self.experts_wi = _param(e, d, f, dtype=cfg.dtype, trainable=trainable)
        self.experts_wo = _param(e, f, d, dtype=cfg.dtype, trainable=trainable)
        self.router = Router(d, e, trainable)
        self.dropped_fraction: Optional[torch.Tensor] = None
        # the axis the tokens are sharded over; None inside a pipeline
        # stage, whose routing groups are cut from the local tokens (JAX's
        # stages run under the manual data axis)
        self.data_axis: Optional[str] = "data"

    def _top_k(self, probs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(values, indices)`` of the k largest probabilities, equal
        values by ascending expert index (``torch.topk`` does not promise
        an order among ties on CUDA)."""
        k = self.config.moe_top_k
        if k == 1:
            idx = torch.argmax(probs, dim=-1, keepdim=True)  # the first maximum
            return torch.gather(probs, -1, idx), idx
        vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        return vals[..., :k], idx[..., :k]

    def forward(self, x: torch.Tensor, dense: bool = False
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        cfg, mesh = self.config, self.mesh
        e, k, dt = cfg.n_experts, cfg.moe_top_k, cfg.dtype
        ct = torch.promote_types(x.dtype, dt)  # jnp.einsum's promotion
        wi = self.experts_wi.to(dt).to(ct)
        wo = self.experts_wo.to(dt).to(ct)
        xc = x.to(ct)
        probs = torch.softmax(self.router(x), dim=-1)  # [B, S, E] f32
        e_local, tp = wi.shape[0], mesh is not None and wi.shape[2] < cfg.d_ff
        ep = mesh is not None and e_local < e
        if dense or cfg.moe_dense_dispatch:
            topv, topi = self._top_k(probs)
            w = topv if k == 1 else topv / topv.sum(-1, keepdim=True)
            gate = (F.one_hot(topi, e).to(probs.dtype) * w[..., None]).sum(-2)  # [B, S, E]
            # sharded experts: each rank runs its E/ep experts (and their
            # model slice of d_ff) on every token and the partial combines
            # are psum'd; x and the gates reach every rank of those axes
            axes = tuple(ax for ax, on in (("expert", ep), ("model", tp)) if on)
            if axes:
                xc, gate = copy_to(xc, axes, mesh), copy_to(gate, axes, mesh)
            if ep:
                e0 = axis_index(mesh, "expert") * e_local
                gate = gate[..., e0:e0 + e_local]
            h = F.gelu(torch.einsum("bsd,edf->bsef", xc, wi), approximate="tanh")
            out = torch.einsum("bsef,efd->bsed", h, wo)
            self.dropped_fraction = None
            out = torch.einsum("bsed,bse->bsd", out, gate.to(dt).to(ct))
            return (psum(out, axes, mesh) if axes else out), None

        b, s, d = x.shape
        n_tok = b * s
        # on a mesh the tokens are sharded over data alone: the routing
        # group is JAX's, cut from the global token count
        dp = axis_size(mesh, self.data_axis) if self.data_axis else 1
        g = _auto_block(n_tok * dp, cfg.moe_group_size)
        if n_tok % g:
            raise NotImplementedError(
                f"routing groups of {g} tokens span data ranks ({n_tok} tokens a rank); "
                "lower moe_group_size")
        n_grp = n_tok // g
        capacity = max(1, int(cfg.capacity_factor * k * g / e))
        grp_probs = probs.reshape(n_grp, g, e)
        topv, topi = self._top_k(grp_probs)  # [G, g, K]
        onehot = F.one_hot(topi, e)  # [G, g, K, E] int64
        gate = topv if k == 1 else topv / topv.sum(-1, keepdim=True)
        # the load-balance term on the first choice; f_e carries no gradient;
        # both means are global (every data rank holds as many tokens)
        f_frac = onehot[:, :, 0, :].float().mean(dim=(0, 1))
        p_mean = grp_probs.mean(dim=(0, 1))
        if dp > 1:
            f_frac = psum(f_frac, "data", mesh) / dp
            p_mean = psum(p_mean, "data", mesh) / dp
        load_balance = e * (f_frac * p_mean).sum()
        # each (token, choice) pair's slot in its expert's buffer (the
        # 1-based cumsum, less one), pairs flattened choice-major; -1 (not
        # routed) and >= capacity (overflow) match no slot, so their rows
        # are zero (F.one_hot would raise on them)
        oh_flat = onehot.transpose(1, 2).reshape(n_grp, k * g, e)
        slot = torch.cumsum(oh_flat, dim=1) * oh_flat - 1
        slots = torch.arange(capacity, device=x.device)
        dispatch = (slot[..., None] == slots).to(torch.float32)  # [G, K*g, E, C] 0/1
        kept = dispatch.sum()
        if dp > 1:
            kept = psum(kept.detach(), "data", mesh)
        self.dropped_fraction = (1.0 - kept / torch.tensor(
            float(k * n_tok * dp), device=x.device)).detach()
        gate_flat = gate.transpose(1, 2).reshape(n_grp, k * g)
        grp_x = xc.reshape(n_grp, g, d)
        if ep:
            # this rank's experts: the dispatch, the run and the combine of
            # E/ep experts; x and the gates reach the other experts' ranks
            # too, so their gradients are summed over expert (copy_to)
            e0 = axis_index(mesh, "expert") * e_local
            dispatch = dispatch[:, :, e0:e0 + e_local]
            grp_x = copy_to(grp_x, "expert", mesh)
            gate_flat = copy_to(gate_flat, "expert", mesh)
        combine = dispatch * gate_flat[..., None, None]
        x_rep = grp_x if k == 1 else grp_x.repeat(1, k, 1)  # jnp.tile: choice-major
        expert_in = torch.einsum("xtec,xtd->xecd", dispatch.to(dt).to(ct), x_rep)
        if tp:  # each expert's d_ff sliced over model
            expert_in = copy_to(expert_in, "model", mesh)
        h = F.gelu(torch.einsum("xecd,edf->xecf", expert_in, wi), approximate="tanh")
        expert_out = torch.einsum("xecf,efd->xecd", h, wo)
        if tp:
            expert_out = psum(expert_out, "model", mesh)
        out = torch.einsum("xtec,xecd->xtd", combine.to(dt).to(ct), expert_out)
        if k > 1:
            out = out.reshape(n_grp, k, g, d).sum(dim=1)
        if ep:
            out = psum(out, "expert", mesh)
        return out.reshape(b, s, d), load_balance


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)``: f32 math, eps 1e-6, f32 out."""

    def __init__(self, d: int, trainable: bool = False):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d), requires_grad=trainable)
        self.bias = nn.Parameter(torch.zeros(d), requires_grad=trainable)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), x.shape[-1:], self.scale, self.bias, LN_EPS)


class Block(nn.Module):
    def __init__(self, config: TransformerConfig, trainable: bool = False, mesh=None):
        super().__init__()
        self.ln_attn = LayerNorm(config.d_model, trainable)
        self.attn = Attention(config, trainable, mesh)
        self.ln_mlp = LayerNorm(config.d_model, trainable)
        if config.n_experts > 0:  # flax names the FFN "moe" or "mlp"
            self.moe = MoEFFN(config, trainable, mesh)
        else:
            self.mlp = DenseFFN(config, trainable, mesh)

    def forward(self, x, cache: Optional[KVCache] = None, layer: int = 0, fresh: bool = False
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``(x, load_balance)``; the MoE term is None for a dense FFN and
        for dense dispatch, which every call with a cache takes (JAX
        ``generate.py::_decode_module``)."""
        h = self.ln_attn(x)
        a = self.attn(h) if cache is None else self.attn.decode(h, cache, layer, fresh)
        x = x + a
        if not hasattr(self, "moe"):
            return x + self.mlp(self.ln_mlp(x)), None
        out, aux = self.moe(self.ln_mlp(x), dense=cache is not None)
        return x + out, aux


class TransformerLM(nn.Module):
    """The causal LM. ``forward(tokens)`` is the training-mode pass;
    ``decode(tokens, cache)`` the KV-cache pass every decoding path uses.
    ``trainable`` selects f32 master parameters that require grad (see the
    module docstring). ``mesh`` makes it run on this rank's local blocks
    (the parameters are built full; whatever builds it on the mesh,
    ``SyncTrainer._shard_model`` or ``lm_from_jax``, swaps in the blocks
    through ``models/base.py::cut_blocks``, which records the rule table
    on the model)."""

    def __init__(self, config: TransformerConfig, device: Optional[Union[str, torch.device]] = None,
                 trainable: bool = False, mesh=None):
        super().__init__()
        from distriflow_tpu_torch.utils.device import resolve_device

        self.config = config
        self.mesh = mesh
        cfg = config
        self.embed = _param(cfg.vocab_size, cfg.d_model, dtype=cfg.dtype, trainable=trainable)
        self.layers = nn.ModuleList(Block(cfg, trainable, mesh) for _ in range(cfg.n_layers))
        self.ln_f = LayerNorm(cfg.d_model, trainable)
        self.lm_head = _param(cfg.d_model, cfg.vocab_size, dtype=cfg.dtype, trainable=trainable)
        dev = resolve_device(device)
        check_kernels_take(config, dev, training=trainable, decode=False)
        self.to(dev)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def vocab_parallel(self) -> bool:
        """True when ``lm_head`` holds a ``model`` slice of the vocabulary:
        the training logits are then this rank's vocabulary slice."""
        return self.lm_head.shape[1] < self.config.vocab_size

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embed[tokens.long()].to(self.config.dtype)
        if self.mesh is not None and self.embed.shape[1] < self.config.d_model:
            x = all_gather_invariant(x, "model", self.mesh, gather_axis=-1)
        return x

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        """Logits in ``cfg.dtype`` (vocab-parallel: this rank's slice)."""
        dt = self.config.dtype
        h = self.ln_f(x).to(dt)
        if self.mesh is not None and self.vocab_parallel:
            h = copy_to(h, "model", self.mesh)
        return torch.matmul(h, self.lm_head.to(dt))

    def _decode_logits(self, x: torch.Tensor) -> torch.Tensor:
        """Decode logits: f32, and vocab-parallel ones all-gathered over
        ``model``, so sampling sees exactly the one-rank logits."""
        logits = self._head(x).float()
        if self.mesh is not None and self.vocab_parallel:
            logits = _all_gather(logits, self.mesh, "model", logits.dim() - 1)
        return logits

    @property
    def local_heads(self) -> int:
        """The heads of this rank's KV cache (``model``-sharded ones are
        a slice of ``n_heads``)."""
        return self.layers[0].attn.local_heads if len(self.layers) else self.config.n_heads

    def forward(self, tokens: torch.Tensor, with_aux: bool = False):
        """Training-mode logits; with ``with_aux``, ``(logits, aux)``: the
        MoE load-balance terms of this forward summed over the layers and
        scaled by ``router_aux_weight / their count`` (JAX
        ``transformer_lm``'s ``apply_with_aux``; 0.0 where no layer gave
        one). Under remat each term is taken from the block's first
        forward, so the backward's recompute does not add it again, and
        its gradient reaches the router through the recompute."""
        cfg = self.config
        x = self._embed(tokens)
        remat = cfg.remat and torch.is_grad_enabled()
        terms = []
        for blk in self.layers:
            # the recompute's kernel costs are hardware FLOPs, not model FLOPs
            x, aux = torch.utils.checkpoint.checkpoint(
                blk, x, use_reentrant=False, context_fn=flop_count.remat_contexts
            ) if remat else blk(x)
            if aux is not None:
                terms.append(aux)
        logits = _cast_logits(self._head(x), cfg.resolved_loss_for(self.device, self.mesh))
        if not with_aux:
            return logits
        return logits, sum(terms) * (cfg.router_aux_weight / max(len(terms), 1))

    def new_cache(self, batch: int, int8: Optional[bool] = None) -> KVCache:
        """A zeroed solo cache: ``[batch, max_seq, H*D]`` slabs at position
        0, int8 with scales when ``int8`` (None: the config's
        :attr:`~TransformerConfig.resolved_kv_cache_dtype`)."""
        cfg = self.config
        if int8 is None:
            int8 = cfg.resolved_kv_cache_dtype == "int8"
        k, v, ks, vs = cache_buffers(cfg, (batch, cfg.max_seq), int8, self.device,
                                     self.local_heads)
        return KVCache(k, v, 0, cfg.max_seq, k_scale=ks, v_scale=vs)

    @torch.no_grad()
    def decode(self, tokens: torch.Tensor, cache: Optional[KVCache] = None,
               int8: Optional[bool] = None) -> Tuple[torch.Tensor, KVCache]:
        """Run ``tokens`` [B, s] through the cache; returns ``(logits
        [B, s, V] f32, cache)``. ``cache=None`` starts a fresh solo cache
        (the prefill, which takes the prompt-attention kernel), int8 as
        :meth:`new_cache` decides from ``int8``. On a mesh every rank runs
        the same call on the same (replicated) tokens over its local
        heads and experts, and gets the full logits."""
        fresh = cache is None
        if fresh:
            cache = self.new_cache(tokens.shape[0], int8)
        x = self._embed(tokens)
        for i, blk in enumerate(self.layers):
            x, _ = blk(x, cache, i, fresh)
        cache.advance(tokens.shape[1])
        return self._decode_logits(x), cache


def cache_buffers(config: TransformerConfig, lead: Tuple[int, int], int8: bool, device,
                  heads: Optional[int] = None) -> Tuple[List[torch.Tensor], ...]:
    """Zeroed per-layer ``(k, v, k_scale, v_scale)`` buffers of shape
    ``lead + (H*D,)`` (scales ``lead + (H,)`` f32, or None when not
    ``int8``); K/V in ``cfg.dtype`` or int8. ``heads`` (``n_heads`` by
    default) is a ``model``-sharded model's local head count."""
    check_kernels_take(config, torch.device(device))  # the decode kernels must take it
    n = config.n_layers
    heads = config.n_heads if heads is None else heads

    def bufs(width, dtype):
        return [torch.zeros(lead + (width,), dtype=dtype, device=device) for _ in range(n)]

    kv_dtype = torch.int8 if int8 else config.dtype
    width = heads * config.head_dim
    k, v = bufs(width, kv_dtype), bufs(width, kv_dtype)
    if not int8:
        return k, v, None, None
    return k, v, bufs(heads, torch.float32), bufs(heads, torch.float32)


def _cast_logits(logits: torch.Tensor, loss_name: str) -> torch.Tensor:
    """Training logits: ``cfg.dtype`` for the fused CE, which reads the
    compute dtype and upcasts row by row (an f32 copy of the ``[tokens,
    V]`` logits, and its twin in the backward, would be wasted bytes),
    f32 for every other loss. ``loss_name`` must be the resolved name the
    spec trains with, so dtype and loss never diverge."""
    if loss_name.startswith("fused_"):
        return logits
    return logits.float()


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random weights: every matmul kernel and the embedding
    ``normal(0, 1/fan_in)`` (lecun-normal scale; fan_in = d_model for the
    embedding, and flax's product of every axis but the last for the
    ``[E, in, out]`` expert weights: E*d and E*f; a pipelined LM's stage
    weights leave the leading stages dim out), LayerNorm scale 1 and
    every bias (LayerNorm's, the MoE router's) 0. Drawn on the CPU from one
    ``torch.Generator``, so a seed gives the same weights on every device;
    they are not flax's bits (carry a flax tree over with
    :mod:`~distriflow_tpu_torch.models.convert` for that)."""
    g = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        if name.endswith(".scale"):
            p.fill_(1.0)
        elif name.endswith(".bias"):
            p.zero_()
        else:
            lead = 1 if name.startswith("stages.") else 0
            fan_in = p.shape[1] if name == "embed" else math.prod(p.shape[lead:-1])
            p.copy_(torch.randn(p.shape, generator=g) / math.sqrt(fan_in))
    return model


def _lm_flax_path(name: str) -> Tuple[str, ...]:
    from distriflow_tpu_torch.models.convert import lm_flax_path  # convert imports this module

    return lm_flax_path(name)


def transformer_lm(
    config: Optional[TransformerConfig] = None,
    device: Optional[Union[str, torch.device]] = None,
    example_seq: int = 128,
    mesh=None,
    **overrides,
) -> ModelSpec:
    """ModelSpec for the causal LM on ``device`` (``cuda`` by default). ``x``
    = int tokens ``[B, S]``; ``y`` = int next-token ids ``[B, S]`` (sparse
    CE, fused on CUDA; set ``config.loss="softmax_cross_entropy"`` for
    one-hot ``[B, S, V]`` targets). ``init(seed)`` builds a trainable model
    (f32 masters, see the module docstring) with :func:`init_weights`.
    A capacity-routed MoE config with ``router_aux_weight > 0`` trains with
    ``apply_with_aux``: the logits and the weighted load-balance term of
    the same forward (eval metrics leave the term out). On a ``mesh`` the
    loss resolves as JAX's does there (:meth:`TransformerConfig.resolved_loss_for`)
    and ``init`` builds the mesh-aware model with full parameters; the
    trainer shards them by its rules."""
    from distriflow_tpu_torch.utils.device import resolve_device

    if config is None:
        config = TransformerConfig(**overrides)
    elif overrides:
        config = dataclasses.replace(config, **overrides)
    dev = resolve_device(device)
    loss = config.resolved_loss_for(dev, mesh)

    def init(seed: int = 0) -> TransformerLM:
        return init_weights(TransformerLM(config, device=dev, trainable=True, mesh=mesh), seed)

    spec = ModelSpec(
        init=init,
        apply=lambda model, tokens: model(tokens),
        loss=loss,
        input_shape=(example_seq,),
        output_shape=(config.vocab_size,),
        name="transformer_lm",
        device=dev,
        dtype=config.dtype,
        apply_with_aux=(
            (lambda model, tokens: model(tokens, with_aux=True))
            if config.n_experts > 0 and config.router_aux_weight > 0
            and not config.moe_dense_dispatch else None),
        mesh=mesh,
        flax_path=_lm_flax_path,
    )
    spec.check_loss()  # the fused CE takes bf16 and f32 logits
    return spec


class StageBlocks(nn.Module):
    """One pipeline stage's ``per`` consecutive blocks (``block_0`` ...),
    every parameter stacked over the stages: ``[n_stages, ...]`` when
    built, this rank's ``[1, ...]`` slice once the trainer shards it over
    ``pipe``. :meth:`stage_fn` runs one stage's slices through the blocks
    (``torch.func.functional_call``), which is what the pipeline schedules
    call; with the heads, FFN or experts sharded the blocks run their
    ``model``/``expert`` collectives as :class:`TransformerLM`'s do. MoE
    routing groups are cut from the stage's local tokens."""

    def __init__(self, config: TransformerConfig, per: int, n_stages: int,
                 trainable: bool = False, mesh=None):
        super().__init__()
        self.per = per
        for i in range(per):
            blk = Block(config, trainable, mesh)
            if hasattr(blk, "moe"):
                blk.moe.data_axis = None
            self.add_module(f"block_{i}", blk)
        with torch.no_grad():
            for mod in self.modules():
                for pname, p in list(mod._parameters.items()):
                    mod._parameters[pname] = nn.Parameter(
                        p.new_empty((n_stages,) + tuple(p.shape)), requires_grad=p.requires_grad)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The blocks on ``x`` with the parameters in place (call it
        through :meth:`stage_fn`, which puts one stage's slices there)."""
        for i in range(self.per):
            x, _ = getattr(self, f"block_{i}")(x)
        return x

    def stage_fn(self, params, x: torch.Tensor) -> torch.Tensor:
        return torch.func.functional_call(self, params, (x,))


class PipelinedTransformerLM(nn.Module):
    """JAX ``pipelined_transformer_lm``'s model: the embedding
    (``_EmbedIn``), P stages of ``n_layers / P`` blocks run by the
    schedule of ``pipeline_schedule`` over ``pipe``
    (:mod:`distriflow_tpu_torch.parallel.pipeline`), and the head
    (``_HeadOut``: ``ln_f`` and ``lm_head``). The embedding and the head
    live outside the pipeline on every pipe rank; TP shards them as
    :class:`TransformerLM`'s."""

    def __init__(self, config: TransformerConfig, mesh, num_microbatches: int,
                 device: Optional[Union[str, torch.device]] = None, trainable: bool = False):
        super().__init__()
        from distriflow_tpu_torch.parallel.pipeline import SCHEDULES
        from distriflow_tpu_torch.utils.device import resolve_device

        cfg = config
        self.config, self.mesh = cfg, mesh
        n_stages = axis_size(mesh, "pipe")
        self.num_microbatches = num_microbatches
        self.schedule = SCHEDULES[pipeline_schedule_of(cfg)]
        self.embed = _param(cfg.vocab_size, cfg.d_model, dtype=cfg.dtype, trainable=trainable)
        self.stages = StageBlocks(cfg, cfg.n_layers // n_stages, n_stages, trainable, mesh)
        self.ln_f = LayerNorm(cfg.d_model, trainable)
        self.lm_head = _param(cfg.d_model, cfg.vocab_size, dtype=cfg.dtype, trainable=trainable)
        dev = resolve_device(device)
        check_kernels_take(config, dev, training=trainable, decode=False)
        self.to(dev)
        self.eval()

    device = TransformerLM.device
    vocab_parallel = TransformerLM.vocab_parallel
    _embed = TransformerLM._embed
    _head = TransformerLM._head

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Training-mode logits of this rank's rows (vocab-parallel over
        ``model``: this rank's slice), on every pipe rank."""
        x = self._embed(tokens)
        stacked = dict(self.stages.named_parameters())
        x = self.schedule(self.stages.stage_fn, stacked, x, self.mesh, self.num_microbatches)
        return _cast_logits(self._head(x), self.config.resolved_loss_for(self.device, self.mesh))


def pipeline_schedule_of(config: TransformerConfig) -> str:
    """The backward schedule: ``pipeline_schedule``, else ``"remat"`` with
    ``remat=True`` and ``"gpipe"`` without (JAX's choice); an unknown
    name is JAX's ``ValueError``."""
    from distriflow_tpu_torch.parallel.pipeline import SCHEDULES

    schedule = config.pipeline_schedule or ("remat" if config.remat else "gpipe")
    if schedule not in SCHEDULES:
        raise ValueError(f"pipeline_schedule must be one of {sorted(SCHEDULES)}, "
                         f"got {schedule!r}")
    return schedule


def _pipelined_flax_path(name: str) -> Tuple[str, ...]:
    from distriflow_tpu_torch.models.convert import pipelined_lm_flax_path

    return pipelined_lm_flax_path(name)


def pipelined_transformer_lm(
    config: Optional[TransformerConfig] = None,
    device: Optional[Union[str, torch.device]] = None,
    mesh=None,
    num_microbatches: Optional[int] = None,
    example_seq: int = 128,
    **overrides,
) -> ModelSpec:
    """JAX ``pipelined_transformer_lm``: the causal LM over the mesh's
    ``pipe`` axis (DP x PP x TP), ``n_layers / P`` blocks a stage, the
    batch in ``num_microbatches`` microbatches (default P). ``init`` builds
    the model with full, stacked parameters; the trainer shards them with
    ``PIPELINED_TRANSFORMER_RULES``. The loss resolves as on any mesh with
    ``pipe`` > 1: the plain sparse CE."""
    from distriflow_tpu_torch.utils.device import resolve_device

    if config is None:
        config = TransformerConfig(**overrides)
    elif overrides:
        config = dataclasses.replace(config, **overrides)
    if mesh is None or axis_size(mesh, "pipe") < 2:
        raise ValueError("pipelined_transformer_lm needs a mesh with pipe >= 2")
    pipeline_schedule_of(config)
    n_stages = axis_size(mesh, "pipe")
    if config.n_layers % n_stages:
        raise ValueError(f"n_layers {config.n_layers} not divisible by pipe axis {n_stages}")
    m = num_microbatches or n_stages
    dev = resolve_device(device)

    def init(seed: int = 0) -> PipelinedTransformerLM:
        return init_weights(PipelinedTransformerLM(config, mesh, m, device=dev, trainable=True),
                            seed)

    spec = ModelSpec(
        init=init,
        apply=lambda model, tokens: model(tokens),
        loss=config.resolved_loss_for(dev, mesh),
        input_shape=(example_seq,),
        output_shape=(config.vocab_size,),
        name="pipelined_transformer_lm",
        device=dev,
        dtype=config.dtype,
        mesh=mesh,
        flax_path=_pipelined_flax_path,
    )
    spec.check_loss()
    return spec
