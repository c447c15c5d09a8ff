"""Port of ``distriflow_tpu/models/transformer.py``: the dense decoder LM.

``TransformerConfig`` keeps the JAX field names (``dtype`` is a
``torch.dtype``). The modules are ``nn.Module``s holding weights in the
JAX kernel layout (``[in, out]``), so
:mod:`distriflow_tpu_torch.models.convert` copies a flax params tree over
without transposes. MoE, ring/Ulysses attention, the pipelined LM and the
int8 KV cache are not ported yet: the config refuses them.

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
``gelu`` is the tanh form; the residual stream is ``cfg.dtype``. Training
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
from distriflow_tpu_torch.ops.flash_attention import flash_attention, flash_seq_supported
from distriflow_tpu_torch.ops.flash_decode import (
    SUPPORTED_HEAD_DIMS,
    flash_decode,
    flash_decode_paged,
    supports_paged,
    supports_seq,
)

NEG_INF = -1e30
LN_EPS = 1e-6  # flax nn.LayerNorm's default epsilon


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Same fields as the JAX config. Values that select code this port
    does not have yet (MoE, sequence-parallel attention, int8 KV) raise."""

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
        unported = {
            "n_experts": self.n_experts != 0,
            "use_ring_attention": self.use_ring_attention,
            "use_ulysses_attention": self.use_ulysses_attention,
            "kv_cache_dtype": self.kv_cache_dtype is not None,
        }
        for name, set_ in unported.items():
            if set_:
                raise NotImplementedError(
                    f"{name}={getattr(self, name)!r} is not ported yet")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def resolved_loss_for(self, device: Optional[Union[str, torch.device]] = None) -> str:
        """The loss name the model spec trains with. An explicit ``loss`` is
        always honored; ``loss=None`` resolves to the fused sparse CE (its
        CUDA kernels) on a CUDA device and to the plain sparse CE on the
        CPU, as JAX resolves to the fused Pallas CE on a TPU only.
        ``device=None`` is the port's default device, CUDA."""
        if self.loss is not None:
            return self.loss
        dev = torch.device("cuda" if device is None else device)
        return ("fused_sparse_softmax_cross_entropy" if dev.type == "cuda"
                else "sparse_softmax_cross_entropy")

    @property
    def resolved_loss(self) -> str:
        """Resolution on the default device (single-device semantics)."""
        return self.resolved_loss_for(None)


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


def dense_attention(q, k, v, causal: bool = True) -> torch.Tensor:
    """Plain softmax attention over ``[B, H, S, D]`` in f32 (the path JAX
    takes through ``blockwise_attention`` when flash is off)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if causal:
        n = q.shape[2]
        keep = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    return torch.matmul(torch.softmax(s, dim=-1), v.float()).to(q.dtype)


def _use_kernel(flag: Optional[bool], t: torch.Tensor) -> bool:
    """The tri-state kernel switch: None means "on CUDA tensors"."""
    return t.device.type == "cuda" if flag is None else flag


def check_kernels_take(config: TransformerConfig, device: torch.device,
                       page_size: Optional[int] = None) -> None:
    """Raise ``NotImplementedError`` when a model on CUDA would need a
    kernel for a dtype, head dim or page size the kernels do not take.
    There is no plain path on the card to fall back to; a caller who wants
    the plain path there sets ``use_flash_attention``/``use_flash_decode``
    to False."""
    if device.type != "cuda":
        return
    item = torch.empty((), dtype=config.dtype).element_size()
    hd, d = config.n_heads * config.head_dim, config.head_dim
    refused = []
    if config.use_flash_attention is not False and not flash_seq_supported(
            config.max_seq, d, item):
        refused.append("prefill attention")
    if config.use_flash_decode is not False:
        if not supports_seq(config.max_seq, hd=hd, kv_item=item, d=d):
            refused.append("slab decode")
        if page_size is not None and not supports_paged(page_size, hd=hd, kv_item=item, d=d):
            refused.append(f"paged decode at page_size {page_size}")
    if refused:
        raise NotImplementedError(
            f"no CUDA kernel for {', '.join(refused)} at dtype {config.dtype}, "
            f"head dim {d}: the kernels take bf16 at head dims {SUPPORTED_HEAD_DIMS}")


class KVCache:
    """Per-layer K/V storage plus the write position(s); see the module
    docstring for the three layouts. ``index`` is an ``int`` (solo) or a
    ``[B]`` int32 tensor (slot and paged). The page table is held once,
    not per layer as in the JAX pytree: every layer's copy was identical.

    A paged cache is built from ``[n_pages + 1, page_size, F]`` storages
    whose last page is scratch: ``k``/``v`` are the ``[n_pages, ...]``
    pools in front of it, and writes that JAX drops (sentinel pages, masked
    positions) are routed into the scratch page, which nothing reads. That
    drops them without the host sync a boolean-mask index would cost.
    """

    def __init__(self, k: List[torch.Tensor], v: List[torch.Tensor],
                 index: Union[int, torch.Tensor], max_seq: int,
                 page_table: Optional[torch.Tensor] = None):
        self.index = index
        self.max_seq = max_seq
        self.page_table: Optional[torch.Tensor] = None
        self._kernel_table: Optional[torch.Tensor] = None
        if page_table is None:
            self.k, self.v = k, v
            self.k_store = self.v_store = None
        else:
            self.k_store, self.v_store = k, v
            self.k = [t[:-1] for t in k]  # leading slices: still contiguous
            self.v = [t[:-1] for t in v]
            self.set_page_table(page_table)

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
        """Write ``[B, s, H*D]`` K/V at each row's own position."""
        b, s, _ = k_tok.shape
        ck, cv = self.k[layer], self.v[layer]
        if self.paged:
            n_pg, ps, feat = ck.shape
            pp = self.page_table.shape[1] - 1  # last column is the sentinel
            cols = self.index[:, None].long() + torch.arange(s, device=ck.device)[None, :]
            pg = torch.clamp(cols // ps, max=pp)  # logical past the table -> sentinel
            phys = torch.gather(self.page_table.long(), 1, pg)
            # sentinel pages (retired or unallocated) land in the scratch page
            flat = self.drop_to_scratch(phys * ps + cols % ps, phys < n_pg).reshape(-1)
            self.k_store[layer].view(-1, feat)[flat] = k_tok.reshape(-1, feat).to(ck.dtype)
            self.v_store[layer].view(-1, feat)[flat] = v_tok.reshape(-1, feat).to(cv.dtype)
        elif self.slot_mode:
            rows = torch.arange(b, device=ck.device)[:, None].expand(b, s)
            cols = self.index[:, None].long() + torch.arange(s, device=ck.device)[None, :]
            keep = cols < ck.shape[1]  # frozen rows parked past max_seq: drop
            ck[rows[keep], cols[keep]] = k_tok[keep].to(ck.dtype)
            cv[rows[keep], cols[keep]] = v_tok[keep].to(cv.dtype)
        else:
            i = int(self.index)
            if i + s > ck.shape[1]:
                raise ValueError(f"cache write [{i}, {i + s}) past max_seq {ck.shape[1]}")
            ck[:, i:i + s] = k_tok.to(ck.dtype)
            cv[:, i:i + s] = v_tok.to(cv.dtype)

    def view(self, layer: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Slab-shaped ``[B, max_seq, F]`` K/V of every row. Paged rows are
        gathered through the table; sentinel entries clamp to the last
        real page, whose contents the per-row visibility mask discards."""
        ck, cv = self.k[layer], self.v[layer]
        if not self.paged:
            return ck, cv
        n_pg, ps, feat = ck.shape
        tab = torch.clamp(self._kernel_table.long(), max=n_pg - 1)
        b, pp = tab.shape
        return tuple(buf[tab].reshape(b, pp * ps, feat)[:, :self.max_seq]
                     for buf in (ck, cv))

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
    def __init__(self, config: TransformerConfig, trainable: bool = False):
        super().__init__()
        cfg = config
        self.config = cfg
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
            torch.matmul(xc, w.to(cfg.dtype)).view(b, s, cfg.n_heads, cfg.head_dim).transpose(1, 2)
            for w in (self.q_proj, self.k_proj, self.v_proj))  # [B, H, s, D]

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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Training-mode attention over the whole sequence (no cache)."""
        cfg = self.config
        q, k, v = self._qkv(x)
        if cfg.use_rope:
            q, k = apply_rope(q, k, base=cfg.rope_base)
        return self._out(self._prompt_attention(q, k, v).transpose(1, 2))

    def decode(self, x: torch.Tensor, cache: KVCache, layer: int, fresh: bool) -> torch.Tensor:
        """Incremental attention against ``cache`` (JAX ``_decode_attend``):
        writes this call's K/V at each row's position, then attends."""
        cfg = self.config
        b, s, _ = x.shape
        hd = cfg.n_heads * cfg.head_dim
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

        ck = cache.k[layer]
        if s == 1 and _use_kernel(cfg.use_flash_decode, q):  # on CUDA: the kernel or a raise
            qf = q[:, :, 0, :].contiguous()  # [B, H, D]
            lens = idx + s
            if cache.paged:
                ctx = flash_decode_paged(qf, ck, cache.v[layer], cache.kernel_table(), lens)
            else:
                ctx = flash_decode(qf, ck, cache.v[layer], lens)
            return self._out(ctx[:, None].to(cfg.dtype))

        keys, vals = cache.view(layer)
        keys = keys.reshape(b, cfg.max_seq, cfg.n_heads, cfg.head_dim)
        vals = vals.reshape(b, cfg.max_seq, cfg.n_heads, cfg.head_dim)
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
    def __init__(self, config: TransformerConfig, trainable: bool = False):
        super().__init__()
        self.config = config
        self.wi = _param(config.d_model, config.d_ff, dtype=config.dtype, trainable=trainable)
        self.wo = _param(config.d_ff, config.d_model, dtype=config.dtype, trainable=trainable)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.config.dtype
        h = F.gelu(torch.matmul(x.to(dt), self.wi.to(dt)), approximate="tanh")
        return torch.matmul(h, self.wo.to(dt))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)``: f32 math, eps 1e-6, f32 out."""

    def __init__(self, d: int, trainable: bool = False):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d), requires_grad=trainable)
        self.bias = nn.Parameter(torch.zeros(d), requires_grad=trainable)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), x.shape[-1:], self.scale, self.bias, LN_EPS)


class Block(nn.Module):
    def __init__(self, config: TransformerConfig, trainable: bool = False):
        super().__init__()
        self.ln_attn = LayerNorm(config.d_model, trainable)
        self.attn = Attention(config, trainable)
        self.ln_mlp = LayerNorm(config.d_model, trainable)
        self.mlp = DenseFFN(config, trainable)

    def forward(self, x, cache: Optional[KVCache] = None, layer: int = 0, fresh: bool = False):
        h = self.ln_attn(x)
        a = self.attn(h) if cache is None else self.attn.decode(h, cache, layer, fresh)
        x = x + a
        return x + self.mlp(self.ln_mlp(x))


class TransformerLM(nn.Module):
    """The causal LM. ``forward(tokens)`` is the training-mode pass;
    ``decode(tokens, cache)`` the KV-cache pass every decoding path uses.
    ``trainable`` selects f32 master parameters that require grad (see the
    module docstring)."""

    def __init__(self, config: TransformerConfig, device: Optional[Union[str, torch.device]] = None,
                 trainable: bool = False):
        super().__init__()
        from distriflow_tpu_torch.utils.device import resolve_device

        self.config = config
        cfg = config
        self.embed = _param(cfg.vocab_size, cfg.d_model, dtype=cfg.dtype, trainable=trainable)
        self.layers = nn.ModuleList(Block(cfg, trainable) for _ in range(cfg.n_layers))
        self.ln_f = LayerNorm(cfg.d_model, trainable)
        self.lm_head = _param(cfg.d_model, cfg.vocab_size, dtype=cfg.dtype, trainable=trainable)
        dev = resolve_device(device)
        check_kernels_take(config, dev)
        self.to(dev)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed[tokens.long()].to(self.config.dtype)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        """Logits in ``cfg.dtype``."""
        dt = self.config.dtype
        return torch.matmul(self.ln_f(x).to(dt), self.lm_head.to(dt))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        x = self._embed(tokens)
        remat = cfg.remat and torch.is_grad_enabled()
        for blk in self.layers:
            x = torch.utils.checkpoint.checkpoint(blk, x, use_reentrant=False) if remat else blk(x)
        return _cast_logits(self._head(x), cfg.resolved_loss_for(self.device))

    def new_cache(self, batch: int) -> KVCache:
        """A zeroed solo cache: ``[batch, max_seq, H*D]`` slabs at position 0."""
        cfg = self.config
        shape = (batch, cfg.max_seq, cfg.d_model)
        return KVCache(
            [torch.zeros(shape, dtype=cfg.dtype, device=self.device) for _ in range(cfg.n_layers)],
            [torch.zeros(shape, dtype=cfg.dtype, device=self.device) for _ in range(cfg.n_layers)],
            0, cfg.max_seq)

    @torch.no_grad()
    def decode(self, tokens: torch.Tensor, cache: Optional[KVCache] = None
               ) -> Tuple[torch.Tensor, KVCache]:
        """Run ``tokens`` [B, s] through the cache; returns ``(logits
        [B, s, V] f32, cache)``. ``cache=None`` starts a fresh solo cache
        (the prefill, which takes the prompt-attention kernel)."""
        fresh = cache is None
        if fresh:
            cache = self.new_cache(tokens.shape[0])
        x = self._embed(tokens)
        for i, blk in enumerate(self.layers):
            x = blk(x, cache, i, fresh)
        cache.advance(tokens.shape[1])
        return self._head(x).float(), cache


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
def init_weights(model: TransformerLM, seed: int = 0) -> TransformerLM:
    """Seeded random weights: every matmul kernel and the embedding
    ``normal(0, 1/fan_in)`` (lecun-normal scale; fan_in = d_model for the
    embedding), LayerNorm scale 1 and bias 0. Drawn on the CPU from one
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
            fan_in = p.shape[1] if name == "embed" else p.shape[0]
            p.copy_(torch.randn(p.shape, generator=g) / math.sqrt(fan_in))
    return model


def transformer_lm(
    config: Optional[TransformerConfig] = None,
    device: Optional[Union[str, torch.device]] = None,
    example_seq: int = 128,
    **overrides,
) -> ModelSpec:
    """ModelSpec for the causal LM on ``device`` (``cuda`` by default). ``x``
    = int tokens ``[B, S]``; ``y`` = int next-token ids ``[B, S]`` (sparse
    CE, fused on CUDA; set ``config.loss="softmax_cross_entropy"`` for
    one-hot ``[B, S, V]`` targets). ``init(seed)`` builds a trainable model
    (f32 masters, see the module docstring) with :func:`init_weights`."""
    from distriflow_tpu_torch.utils.device import resolve_device

    if config is None:
        config = TransformerConfig(**overrides)
    elif overrides:
        config = dataclasses.replace(config, **overrides)
    dev = resolve_device(device)
    loss = config.resolved_loss_for(dev)
    if dev.type == "cuda" and loss == "fused_sparse_softmax_cross_entropy" \
            and config.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"no CUDA fused cross-entropy kernel for {config.dtype} logits: it takes bf16; "
            "set loss='sparse_softmax_cross_entropy' for the plain loss")

    def init(seed: int = 0) -> TransformerLM:
        return init_weights(TransformerLM(config, device=dev, trainable=True), seed)

    return ModelSpec(
        init=init,
        apply=lambda model, tokens: model(tokens),
        loss=loss,
        input_shape=(example_seq,),
        output_shape=(config.vocab_size,),
        name="transformer_lm",
    )
