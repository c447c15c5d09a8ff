"""Port of ``distriflow_tpu/models/generate.py``: solo decoding, beam
search, sequence scoring, the continuous-batching engine's device half
and speculative decoding's three device programs (:func:`draft_k`,
:func:`verify`, :func:`commit`).

PyTorch runs eagerly, so the JAX package's jit builders
(``_build_prefill``, ``_build_paged_fns``, ``_build_slot_fns``,
``_build_beam_fns``, ``_build_score_fn``) become plain functions of the
same names' members: :func:`prefill`/:func:`extend`,
:func:`paged_insert`/:func:`gather_rows`,
:func:`slot_insert`/:func:`pick_rows`/:func:`decode_chunk`,
:func:`beam_search` and :func:`sequence_logprob`; ``lax.scan`` becomes a
Python loop.

**int8 KV cache.** Solo :func:`generate` and :func:`beam_search` know the
context they will read (prompt + n_tokens) and gate an ``"int8"`` request
on it (:func:`_gate_kv_dtype`); the engine's caches only know ``max_seq``
and follow ``config.resolved_kv_cache_dtype``. Every engine cache helper
carries the scale buffers beside K/V, as JAX's ``_POOL_LEAVES`` do.

**Sampling.** JAX keys a sampled token by ``fold_in(PRNGKey(seed),
position)``; torch cannot reproduce those bits. Here each ``(seed,
absolute position)`` pair seeds its own ``torch.Generator``, so a sampled
token depends only on the request's seed and progress — never on batch
composition or chunk size — and a single-row request samples the same
tokens solo and in the engine. Greedy decoding matches JAX token for token.
Speculative rounds keep JAX's three decision kinds on streams of their
own: ``(seed, position, tag)`` with tag 1 the draft's sample, 2 the
accept coin, 3 the residual sample; tag 0 is the plain stream above.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from distriflow_tpu_torch.parallel.collectives import _all_gather
from distriflow_tpu_torch.models.transformer import (
    KVCache,
    TransformerConfig,
    TransformerLM,
    cache_buffers,
    check_kernels_take,
)

_MASK64 = (1 << 64) - 1


def _truncate_logits(logits: torch.Tensor, top_k: Optional[int],
                     top_p: Optional[float]) -> torch.Tensor:
    """Mask logits outside the top-k set and/or the top-p nucleus to the
    dtype's minimum: k first, then p over the k-renormalized survivors."""
    neg = torch.finfo(logits.dtype).min
    if top_k is not None:
        k = min(int(top_k), logits.shape[-1])
        kth = torch.topk(logits, k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, torch.full_like(logits, neg), logits)
    if top_p is not None:
        srt = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        n_keep = ((cum - probs) < top_p).sum(dim=-1, keepdim=True)
        cutoff = torch.gather(srt, -1, n_keep - 1)
        logits = torch.where(logits < cutoff, torch.full_like(logits, neg), logits)
    return logits


def _truncate_logit_rows(logits: torch.Tensor, top_ks: torch.Tensor,
                         top_ps: torch.Tensor) -> torch.Tensor:
    """Per-row :func:`_truncate_logits`: ``top_ks``/``top_ps`` are [B]
    vectors, 0 / 1.0 meaning off for that row."""
    neg = torch.finfo(logits.dtype).min
    v = logits.shape[-1]
    srt = torch.sort(logits, dim=-1, descending=True).values
    kth = torch.gather(srt, -1, (torch.clamp(top_ks, 1, v)[:, None] - 1).long())
    logits = torch.where((top_ks[:, None] > 0) & (logits < kth),
                         torch.full_like(logits, neg), logits)
    srt2 = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(srt2, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    n_keep = ((cum - probs) < top_ps[:, None]).sum(dim=-1, keepdim=True)
    cutoff = torch.gather(srt2, -1, n_keep - 1)
    return torch.where((top_ps[:, None] < 1.0) & (logits < cutoff),
                       torch.full_like(logits, neg), logits)


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def _stream_seed(seed: int, position: int, tag: int = 0) -> int:
    """SplitMix64 of ``(seed, position)``: one generator seed per pair; a
    nonzero ``tag`` (the speculative decisions, JAX's ``fold_in`` tags)
    mixes once more, so tag 0 is the plain stream and each tag its own."""
    z = _splitmix64(((int(seed) & 0xFFFFFFFF) << 32 | (int(position) & 0xFFFFFFFF)) & _MASK64)
    if tag:
        z = _splitmix64(z ^ (int(tag) & 0xFFFFFFFF))
    return z & ((1 << 63) - 1)


def _generator(device, seed: int, position: int, tag: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(_stream_seed(seed, position, tag))
    return gen


def _sample(logits: torch.Tensor, seed: int, position: int, tag: int = 0) -> torch.Tensor:
    """Categorical samples for the rows of ``logits`` [R, V] by the
    Gumbel-max rule, noise drawn from the ``(seed, position, tag)`` stream."""
    gen = _generator(logits.device, seed, position, tag)
    u = torch.rand(logits.shape, generator=gen, device=logits.device, dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return torch.argmax(logits.float() + gumbel, dim=-1)


def _uniform(device, seed: int, position: int, tag: int) -> torch.Tensor:
    """One U[0, 1) f32 draw from the ``(seed, position, tag)`` stream."""
    return torch.rand((), generator=_generator(device, seed, position, tag), device=device,
                      dtype=torch.float32)


def _check_fits(p: int, n_tokens: int, config: TransformerConfig) -> None:
    if p + n_tokens > config.max_seq:
        raise ValueError(
            f"prompt ({p}) + n_tokens ({n_tokens}) exceeds max_seq "
            f"({config.max_seq}); raise config.max_seq")


def _gate_kv_dtype(config: TransformerConfig, context_len: int) -> TransformerConfig:
    """Re-gate an ``"int8"`` KV request on the context this call reads
    (JAX ``generate.py:111-126``): a long-``max_seq`` config serving a short
    request keeps the ``cfg.dtype`` cache; ``"int8_force"`` is never
    demoted."""
    if (config.kv_cache_dtype == "int8"
            and config.kv_cache_dtype_for(context_len) is None
            and config.resolved_kv_cache_dtype == "int8"):
        return dataclasses.replace(config, kv_cache_dtype=None)
    return config


def _int8_for(config: TransformerConfig, context_len: int) -> bool:
    """Whether a solo decode reading ``context_len`` positions stores int8."""
    return _gate_kv_dtype(config, context_len).resolved_kv_cache_dtype == "int8"


def _tokens(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x,
                           device=device).to(torch.int32)


@torch.no_grad()
def generate(
    model: TransformerLM,
    prompt,
    n_tokens: int,
    temperature: float = 0.0,
    seed: int = 0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    eos_id: Optional[int] = None,
) -> torch.Tensor:
    """``n_tokens`` continuations of ``prompt`` [B, P]; returns
    ``[B, P + n_tokens]`` int32 on the model's device. ``temperature=0``
    is greedy; otherwise sampling keyed by ``(seed, position)``. With
    ``eos_id`` a finished row keeps emitting it."""
    config = model.config
    prompt = _tokens(prompt, model.device)
    b, p = prompt.shape
    if n_tokens <= 0:
        return prompt
    _check_fits(p, n_tokens, config)
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if eos_id is not None and not 0 <= eos_id < config.vocab_size:
        raise ValueError(f"eos_id {eos_id} outside vocab [0, {config.vocab_size})")

    def pick(logits, pos):
        if temperature > 0:
            logits = logits / temperature
            if top_k is not None or top_p is not None:
                logits = _truncate_logits(logits, top_k, top_p)
            return _sample(logits, seed, pos).to(torch.int32)
        return torch.argmax(logits, dim=-1).to(torch.int32)

    logits, cache = model.decode(prompt, int8=_int8_for(config, p + n_tokens))
    tok = pick(logits[:, -1], p)
    done = tok == eos_id if eos_id is not None else None
    out = [prompt, tok[:, None]]
    for i in range(n_tokens - 1):
        logits, cache = model.decode(tok[:, None], cache)
        nxt = pick(logits[:, -1], p + 1 + i)
        if eos_id is not None:
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
            done = done | (nxt == eos_id)
        tok = nxt
        out.append(tok[:, None])
    return torch.cat(out, dim=1)


def _penalize(scores: torch.Tensor, lengths: torch.Tensor, length_penalty: float) -> torch.Tensor:
    """GNMT length penalty ``((5 + len) / 6) ** alpha``; alpha 0 = raw."""
    if length_penalty == 0.0:
        return scores
    return scores / (((5.0 + lengths) / 6.0) ** length_penalty)


@torch.no_grad()
def beam_search(
    model: TransformerLM,
    prompt,
    n_tokens: int,
    beam_size: int = 4,
    length_penalty: float = 0.0,
    eos_id: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam-search decode: ``(tokens [B, P + n_tokens] int32, scores [B]
    f32)`` on the model's device (JAX ``generate.py:180-316``).

    The prefix cache is tiled to ``B x beam_size`` rows after the prefill
    and reordered with the beams at every step, scale buffers included;
    each step is a solo slab decode, so an int8 search launches the int8
    slab kernel. ``eos_id`` freezes finished beams (they repeat eos at zero
    added score); ``length_penalty`` is the GNMT form, applied to pruning
    and to the final ranking."""
    config = model.config
    prompt = _tokens(prompt, model.device)
    b, p = prompt.shape
    if not 1 <= beam_size <= config.vocab_size:
        raise ValueError(f"beam_size must be in [1, vocab_size={config.vocab_size}], "
                         f"got {beam_size}")
    if eos_id is not None and not 0 <= eos_id < config.vocab_size:
        raise ValueError(f"eos_id {eos_id} out of range for vocab_size {config.vocab_size}")
    if n_tokens <= 0:
        return prompt, torch.zeros((b,), dtype=torch.float32, device=model.device)
    _check_fits(p, n_tokens, config)
    dev, vocab, beam = model.device, config.vocab_size, beam_size
    logits, cache = model.decode(prompt, int8=_int8_for(config, p + n_tokens))
    scores, first = torch.topk(torch.log_softmax(logits[:, -1].float(), dim=-1), beam)
    # batch row i serves beams i*beam .. i*beam + beam - 1
    cache.reorder(torch.arange(b, device=dev).repeat_interleave(beam))
    rows = b * beam
    seqs = torch.zeros((rows, n_tokens), dtype=torch.int32, device=dev)
    seqs[:, 0] = first.reshape(rows).to(torch.int32)
    flat_scores = scores.reshape(rows)
    finished = (first.reshape(rows) == eos_id if eos_id is not None
                else torch.zeros((rows,), dtype=torch.bool, device=dev))
    lengths = torch.ones((rows,), dtype=torch.float32, device=dev)
    base = torch.arange(b, device=dev)[:, None] * beam
    for t in range(1, n_tokens):
        logits, cache = model.decode(seqs[:, t - 1:t], cache)
        logp = torch.log_softmax(logits[:, -1].float(), dim=-1)  # [rows, V]
        if eos_id is not None:
            # a finished beam may only repeat eos at zero added score
            only_eos = torch.full_like(logp, -1e30)
            only_eos[:, eos_id] = 0.0
            logp = torch.where(finished[:, None], only_eos, logp)
        total = flat_scores[:, None] + logp  # raw cumulative
        # prune by the objective the winner is ranked with
        cand_len = lengths + torch.where(finished, 0.0, 1.0)
        ranked = _penalize(total, cand_len[:, None], length_penalty).reshape(b, beam * vocab)
        idx = torch.topk(ranked, beam, dim=-1).indices  # [B, beam]
        new_scores = torch.gather(total.reshape(b, beam * vocab), -1, idx)
        flat_parent = (base + idx // vocab).reshape(rows)
        token = (idx % vocab).reshape(rows).to(torch.int32)
        cache.reorder(flat_parent)
        seqs = seqs[flat_parent]
        seqs[:, t] = token
        was_finished = finished[flat_parent]
        lengths = lengths[flat_parent] + torch.where(was_finished, 0.0, 1.0)
        if eos_id is not None:
            finished = was_finished | (token == eos_id)
        flat_scores = new_scores.reshape(rows)
    ranked = _penalize(flat_scores.reshape(b, beam), lengths.reshape(b, beam), length_penalty)
    best = torch.argmax(ranked, dim=-1)
    pick = torch.arange(b, device=dev) * beam + best
    return (torch.cat([prompt, seqs[pick]], dim=1),
            ranked[torch.arange(b, device=dev), best])


@torch.no_grad()
def sequence_logprob(model: TransformerLM, tokens, from_pos: int = 1) -> torch.Tensor:
    """Teacher-forced ``sum_{t >= from_pos} log P(tokens[:, t] |
    tokens[:, :t])`` per row, ``[B]`` f32 on the model's device, from one
    training-mode forward (JAX ``generate.py:318-376``; on CUDA the
    prefill-attention kernel)."""
    config = model.config
    tokens = np.asarray(tokens.cpu() if isinstance(tokens, torch.Tensor) else tokens,
                        dtype=np.int64)
    b, s = tokens.shape
    if not 1 <= from_pos < s:
        raise ValueError(f"from_pos must be in [1, {s - 1}], got {from_pos}")
    if s > config.max_seq:
        raise ValueError(f"sequence length {s} exceeds max_seq ({config.max_seq})")
    lo, hi = int(tokens.min()), int(tokens.max())
    if lo < 0 or hi >= config.vocab_size:
        raise ValueError(f"token ids span [{lo}, {hi}] but vocab_size is {config.vocab_size}")
    t = torch.as_tensor(tokens, device=model.device)
    logits = model(t[:, :-1]).float()
    if model.mesh is not None and model.vocab_parallel:  # every rank: the whole vocabulary
        logits = _all_gather(logits, model.mesh, "model", logits.dim() - 1)
    logp = torch.log_softmax(logits, dim=-1)
    target = torch.gather(logp, -1, t[:, 1:, None])[..., 0]  # [B, S-1]
    mask = torch.arange(s - 1, device=model.device)[None, :] >= from_pos - 1
    return (target * mask).sum(dim=-1)


# ---------------------------------------------------------------------------
# Continuous batching: the engine's device half (see the JAX module for the
# design). A slot/paged cache carries a [max_slots] position vector, which
# flips TransformerLM.decode into per-row RoPE offsets, writes and windows.


def pages_per_slot(max_seq: int, page_size: int) -> int:
    """Logical pages a full-depth row spans (the page-table width, plus
    one pinned sentinel column)."""
    return -(-max_seq // page_size)


def slot_cache(config: TransformerConfig, max_slots: int, device,
               heads: Optional[int] = None) -> KVCache:
    """The engine's zeroed slab cache: ``[max_slots, max_seq, H*D]`` per
    layer (int8 with ``[max_slots, max_seq, H]`` scales when
    ``config.resolved_kv_cache_dtype`` says so) and a ``[max_slots]``
    position vector; ``heads`` is a ``model``-sharded model's local head
    count (``TransformerLM.local_heads``)."""
    k, v, ks, vs = cache_buffers(config, (max_slots, config.max_seq),
                                 config.resolved_kv_cache_dtype == "int8", device, heads)
    return KVCache(k, v, torch.zeros(max_slots, dtype=torch.int32, device=device),
                   config.max_seq, k_scale=ks, v_scale=vs)


def paged_cache(config: TransformerConfig, max_slots: int, page_size: int,
                n_pages: int, device, heads: Optional[int] = None) -> KVCache:
    """The engine's paged cache: one ``[n_pages, page_size, H*D]`` pool
    per layer (int8 with ``[n_pages, page_size, H]`` scale pools when
    ``config.resolved_kv_cache_dtype`` says so; each plus one scratch page,
    see ``KVCache``) and a ``[max_slots, pages_per_slot + 1]`` table whose
    entries start at the sentinel ``n_pages`` (nothing allocated). ``heads``
    as :func:`slot_cache`'s."""
    if page_size <= 0:
        raise ValueError(f"page_size must be positive, got {page_size}")
    if n_pages <= 0:
        raise ValueError(f"n_pages must be positive, got {n_pages}")
    check_kernels_take(config, torch.device(device), page_size)
    pp = pages_per_slot(config.max_seq, page_size)
    k, v, ks, vs = cache_buffers(config, (n_pages + 1, page_size),  # + the scratch page
                                 config.resolved_kv_cache_dtype == "int8", device, heads)
    return KVCache(
        k, v, torch.zeros(max_slots, dtype=torch.int32, device=device), config.max_seq,
        page_table=torch.full((max_slots, pp + 1), n_pages, dtype=torch.int32, device=device),
        k_scale=ks, v_scale=vs)


def set_page_tables(cache: KVCache, table) -> KVCache:
    """Install the host-authoritative ``table`` on the device."""
    cache.set_page_table(torch.as_tensor(np.asarray(table), device=cache.k[0].device))
    return cache


def prefill(model: TransformerLM, prompt) -> Tuple[torch.Tensor, KVCache]:
    """Fresh-cache prefill: ``(last-position logits [R, V], row cache)``."""
    logits, cache = model.decode(_tokens(prompt, model.device))
    return logits[:, -1], cache


def extend(model: TransformerLM, cache: KVCache, tokens) -> Tuple[torch.Tensor, KVCache]:
    """Continue an existing row cache over ``tokens`` (chunked prefill)."""
    logits, cache = model.decode(_tokens(tokens, model.device), cache)
    return logits[:, -1], cache


def _index_vector(slots: torch.Tensor, length, cache: KVCache) -> None:
    """``cache.index[slots] = length`` for the slot ids in range."""
    keep = (slots >= 0) & (slots < cache.index.shape[0])
    cache.index[slots[keep]] = torch.as_tensor(length, dtype=torch.int32,
                                               device=cache.index.device)


@torch.no_grad()
def paged_insert(cache: KVCache, row_cache: KVCache, slots, length: int,
                 start: int, table) -> KVCache:
    """Scatter freshly prefilled dense rows ([R, max_seq, F] row caches)
    into the page pool through ``table`` (the host's full table, installed
    in the same call). Only positions in ``[start, length)`` are written:
    below ``start`` lie shared prefix pages that must not be rewritten, at
    or past ``length`` there is no data. Those, and positions whose page is
    the sentinel, are dropped into the cache's scratch page."""
    set_page_tables(cache, table)
    dev = cache.k[0].device
    slots = torch.as_tensor(np.asarray(slots), dtype=torch.long, device=dev)
    r = slots.shape[0]
    n_pg, ps, _ = cache.k[0].shape
    pp = cache.page_table.shape[1] - 1
    max_seq = cache.max_seq
    cols = torch.arange(max_seq, device=dev)[None, :].expand(r, max_seq)
    pg = torch.clamp(cols // ps, max=pp)
    phys = torch.gather(cache.page_table[slots].long(), 1, pg)
    keep = (cols >= start) & (cols < length) & (phys < n_pg)
    flat = cache.drop_to_scratch(phys * ps + cols % ps, keep).reshape(-1)
    for name, dsts in cache.stores.items():
        for dst, src in zip(dsts, row_cache.stores[name]):
            w = dst.shape[-1]
            dst.view(-1, w)[flat] = src[:, :max_seq].reshape(-1, w).to(dst.dtype)
    _index_vector(slots, length, cache)
    return cache


@torch.no_grad()
def gather_rows(cache: KVCache, tables, start: int) -> KVCache:
    """A dense solo-structured row cache ([R, max_seq, F], position
    ``start``) from shared prefix pages, zeroed past ``start`` so it equals
    a fresh prefill stopped there; ``extend`` then runs the suffix."""
    dev = cache.k[0].device
    tables = torch.as_tensor(np.asarray(tables), dtype=torch.long, device=dev)
    n_pg, ps, _ = cache.k[0].shape
    pp = pages_per_slot(cache.max_seq, ps)
    tab = torch.clamp(tables[:, :pp], max=n_pg - 1)
    r = tab.shape[0]
    live = (torch.arange(cache.max_seq, device=dev) < start)[None, :, None]

    def rows(pool):
        g = pool[tab].reshape(r, pp * ps, pool.shape[-1])[:, :cache.max_seq]
        return torch.where(live, g, torch.zeros_like(g))

    out = {name: [rows(t) for t in ts] for name, ts in cache.pools.items()}
    return KVCache(out["k"], out["v"], int(start), cache.max_seq,
                   k_scale=out.get("k_scale"), v_scale=out.get("v_scale"))


@torch.no_grad()
def slot_insert(cache: KVCache, row_cache: KVCache, slots, length: int) -> KVCache:
    """Copy prefilled row caches into slab slots; slot ids outside
    ``[0, max_slots)`` are dropped (JAX's scatter drops them)."""
    dev = cache.k[0].device
    slots = torch.as_tensor(np.asarray(slots), dtype=torch.long, device=dev)
    keep = (slots >= 0) & (slots < cache.index.shape[0])
    for name, dsts in cache.stores.items():
        for dst, src in zip(dsts, row_cache.stores[name]):
            dst[slots[keep]] = src[keep].to(dst.dtype)
    _index_vector(slots, length, cache)
    return cache


def pick_rows(logits: torch.Tensor, temps: Sequence[float], top_ks, top_ps,
              seeds: Sequence[int], positions: Sequence[int]) -> torch.Tensor:
    """Next token per row: greedy where ``temps == 0``, else sampled from
    the row's ``(seed, position)`` stream after per-row truncation."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    temps = np.asarray(temps, np.float32)
    if not (temps > 0).any():
        return greedy
    dev = logits.device
    t = torch.as_tensor(np.where(temps > 0, temps, 1.0), device=dev)[:, None]
    lg = _truncate_logit_rows(logits / t, torch.as_tensor(np.asarray(top_ks), device=dev),
                              torch.as_tensor(np.asarray(top_ps, np.float32), device=dev))
    out = greedy.clone()
    for r in np.flatnonzero(temps > 0):
        out[r] = _sample(lg[r:r + 1], int(seeds[r]), int(positions[r]))[0].to(torch.int32)
    return out


@torch.no_grad()
def decode_chunk(model: TransformerLM, cache: KVCache, tok, done, temps, top_ks,
                 top_ps, seeds, eos, chunk: int
                 ) -> Tuple[KVCache, np.ndarray, np.ndarray, np.ndarray]:
    """Advance every slot ``chunk`` tokens. Finished rows keep emitting eos
    (``eos = -1``: the row has none). Returns ``(cache, tok [S], done [S],
    toks [S, chunk])`` with the host arrays as numpy."""
    dev = model.device
    tok_t = torch.as_tensor(np.asarray(tok, np.int32), device=dev)
    done_t = torch.as_tensor(np.asarray(done, bool), device=dev)
    eos_t = torch.as_tensor(np.asarray(eos, np.int32), device=dev)
    # every row (frozen ones too) advances one position per step, so the
    # positions of the tokens picked at step i are known on the host: one
    # read of the position vector per chunk, and only when sampling
    pos0 = cache.index.cpu().numpy().astype(np.int64) if (np.asarray(temps) > 0).any() else None
    toks = []
    for i in range(chunk):
        logits, cache = model.decode(tok_t[:, None], cache)
        pos = None if pos0 is None else pos0 + i + 1
        nxt = pick_rows(logits[:, -1], temps, top_ks, top_ps, seeds, pos)
        nxt = torch.where(done_t, torch.clamp(eos_t, min=0), nxt)
        done_t = done_t | (nxt == eos_t)
        tok_t = nxt
        toks.append(nxt)
    toks_np = torch.stack(toks, dim=1).cpu().numpy()
    return cache, tok_t.cpu().numpy(), done_t.cpu().numpy(), toks_np


# ---------------------------------------------------------------------------
# Speculative decoding (JAX ``_build_spec_fns``): a small draft model
# proposes k tokens a round; the target scores all k + 1 positions in one
# multi-token pass over the slot batch (the s > 1 path of
# ``Attention.decode``, per-row visibility over the paged cache), so its
# logits at each position are those of plain decode and greedy acceptance
# gives the plain token stream. Sampled rows use the Leviathan et al.
# rejection-sampling correction on the tagged streams below.

#: stream tags under a row's ``(seed, position)``: one per decision kind
_SPEC_DRAFT_TAG = 1   # the draft model's own sample
_SPEC_ACCEPT_TAG = 2  # the accept/reject uniform
_SPEC_RESID_TAG = 3   # the residual (correction) sample


def _set_cache_positions(cache: KVCache, pos: torch.Tensor) -> KVCache:
    """Set the cache's ``[B]`` position vector to ``pos`` (JAX
    ``_set_cache_positions``; the port's cache keeps one index for every
    layer, so there are no leaves to find, ``_find_cache_leaf``)."""
    cache.index = pos.to(device=cache.index.device, dtype=torch.int32).clone()
    return cache


def _oob_write_position(cache: KVCache) -> int:
    """A position whose cache write lands nowhere (JAX
    ``_oob_write_position``): paged, ``pages_per_slot * page_size``, which
    maps through the pinned sentinel column into the scratch page; a slab,
    ``max_seq``, which the slot write drops."""
    if cache.paged:
        return (cache.page_table.shape[1] - 1) * cache.k[0].shape[1]
    return cache.max_seq


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@torch.no_grad()
def draft_k(model: TransformerLM, cache: KVCache, tok, temps, top_ks, top_ps, seeds,
            k: int) -> Tuple[KVCache, torch.Tensor, torch.Tensor]:
    """k single-token draft steps from each row's committed position:
    ``(cache, drafts [B, k] int32, q [B, k, V] f32)``, ``q`` the draft's
    proposal distributions after temperature and truncation (a
    ``[B, k, 1]`` placeholder when no row samples). The draft cache's
    index ends at ``p + k``."""
    dev = model.device
    tk = torch.as_tensor(np.array(tok, np.int32), device=dev)
    temps = np.asarray(temps, np.float32)
    sampled = np.flatnonzero(temps > 0)
    if sampled.size:
        t = torch.as_tensor(np.where(temps > 0, temps, 1.0), device=dev)[:, None]
        kk = torch.as_tensor(np.asarray(top_ks), device=dev)
        pp = torch.as_tensor(np.asarray(top_ps, np.float32), device=dev)
        pos0 = _host(cache.index).astype(np.int64)
    drafts, qs = [], []
    for i in range(k):
        logits, cache = model.decode(tk[:, None], cache)
        lg = logits[:, -1]
        nxt = torch.argmax(lg, dim=-1).to(torch.int32)
        if sampled.size:
            tl = _truncate_logit_rows(lg / t, kk, pp)
            for r in sampled:  # the sample's position is the draft token's own
                nxt[r] = _sample(tl[r:r + 1], int(seeds[r]), int(pos0[r]) + i + 1,
                                 _SPEC_DRAFT_TAG)[0]
            qs.append(torch.softmax(tl.float(), dim=-1))
        else:
            qs.append(torch.zeros((lg.shape[0], 1), dtype=torch.float32, device=dev))
        drafts.append(nxt)
        tk = nxt
    return cache, torch.stack(drafts, dim=1), torch.stack(qs, dim=1)


def _residual(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The correction distribution after a rejection, ``norm(max(p - q,
    0))`` row by row; ``p`` itself where that is all zero (which only
    rounding can give: p <= q everywhere accepts every draft)."""
    resid = torch.clamp(p - q, min=0.0)
    rs = resid.sum(dim=-1, keepdim=True)
    return torch.where(rs > 1e-20, resid / torch.clamp(rs, min=1e-20), p)


@torch.no_grad()
def verify(model: TransformerLM, cache: KVCache, tok, drafts: torch.Tensor,
           qprobs: torch.Tensor, temps, top_ks, top_ps, seeds, done, eos, k: int):
    """One target pass over ``[tok, d_1..d_k]`` (s = k + 1) and the round's
    decisions: ``(cache, emit [B, k+1], n_emit [B], n_acc [B], new_tok [B],
    new_done [B], catch_up [B], new_idx [B])``, all tensors on the device.

    Greedy rows accept the longest prefix of drafts equal to the target's
    argmax; sampled rows accept draft j with probability ``min(1, p(d) /
    q(d))`` (the accept coin at the draft's position). The correction (or,
    after k acceptances, the bonus) token is the target's argmax after the
    accepted prefix, or a sample of the residual ``norm(max(p - q, 0))``
    (q padded with zeros after the last draft, so the bonus samples p).
    An eos among the emitted tokens freezes the row there; rows done at
    entry stay frozen. The index rolls back to ``p + n_acc + 1``: writes
    at rejected positions stay behind it, invisible, and the next round
    overwrites them."""
    dev = model.device
    tok_t = torch.as_tensor(np.array(tok, np.int32), device=dev)
    done_t = torch.as_tensor(np.array(done, bool), device=dev)
    eos_t = torch.as_tensor(np.array(eos, np.int32), device=dev)
    temps = np.asarray(temps, np.float32)
    sampled = np.flatnonzero(temps > 0)
    b = tok_t.shape[0]
    p = cache.index.clone()  # committed per-row positions
    seq = torch.cat([tok_t[:, None], drafts], dim=1)  # [B, k+1]
    logits, cache = model.decode(seq, cache)
    tgt = torch.argmax(logits, dim=-1).to(torch.int32)  # [B, k+1]
    acc = drafts == tgt[:, :k]
    rows = torch.arange(b, device=dev)
    if sampled.size:
        v = logits.shape[-1]
        t = torch.as_tensor(np.where(temps > 0, temps, 1.0), device=dev)
        flat = (logits / t[:, None, None]).reshape(b * (k + 1), v)
        kk = torch.as_tensor(np.asarray(top_ks), device=dev).repeat_interleave(k + 1)
        pp = torch.as_tensor(np.asarray(top_ps, np.float32), device=dev).repeat_interleave(k + 1)
        pprobs = torch.softmax(_truncate_logit_rows(flat, kk, pp).float(), dim=-1).reshape(
            b, k + 1, v)
        p_host = _host(p).astype(np.int64)
        us = torch.zeros((b, k), dtype=torch.float32, device=dev)
        for r in sampled:  # draft j sits at absolute position p + 1 + j
            for j in range(k):
                us[r, j] = _uniform(dev, int(seeds[r]), int(p_host[r]) + 1 + j, _SPEC_ACCEPT_TAG)
        pd = torch.gather(pprobs[:, :k], 2, drafts.long()[..., None])[..., 0]
        qd = torch.gather(qprobs, 2, drafts.long()[..., None])[..., 0]
        acc_sampled = us < torch.clamp(pd / torch.clamp(qd, min=1e-20), max=1.0)
        is_sampled = torch.as_tensor(temps > 0, device=dev)[:, None]
        acc = torch.where(is_sampled, acc_sampled, acc)
    n_acc = torch.cumprod(acc.to(torch.int32), dim=1).sum(dim=1)  # [B], 0..k
    corr = tgt[rows, n_acc.long()]
    if sampled.size:
        qpad = torch.cat([qprobs, torch.zeros((b, 1, qprobs.shape[-1]), dtype=qprobs.dtype,
                                              device=dev)], dim=1)
        dist = _residual(pprobs[rows, n_acc.long()], qpad[rows, n_acc.long()])
        n_acc_host = _host(n_acc).astype(np.int64)
        corr = corr.clone()
        for r in sampled:
            corr[r] = _sample(torch.log(torch.clamp(dist[r:r + 1], min=1e-30)), int(seeds[r]),
                              int(p_host[r]) + 1 + int(n_acc_host[r]), _SPEC_RESID_TAG)[0]
    # the round's tokens: d_1..d_{n_acc}, then the correction
    cols = torch.arange(k + 1, device=dev)[None, :]
    drafts_pad = torch.cat([drafts, torch.zeros((b, 1), dtype=torch.int32, device=dev)], dim=1)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    emit = torch.where(cols < n_acc[:, None], drafts_pad,
                       torch.where(cols == n_acc[:, None], corr[:, None], zero))
    # an eos among them freezes the row exactly where plain decode would
    hit = (eos_t >= 0)[:, None] & (emit == eos_t[:, None]) & (cols <= n_acc[:, None])
    hit_any = hit.any(dim=1)
    first_eos = torch.argmax(hit.to(torch.int32), dim=1).to(torch.int32)
    n_emit = torch.where(hit_any, torch.minimum(n_acc + 1, first_eos + 1), n_acc + 1)
    new_done = done_t | hit_any
    eos0 = torch.clamp(eos_t, min=0)
    new_tok = torch.where(new_done, eos0, corr)
    # rows done at entry stay frozen (a retired slot; the host reads nothing)
    emit = torch.where(done_t[:, None], eos0[:, None], emit)
    n_emit = torch.where(done_t, torch.full_like(n_emit, k + 1), n_emit)
    n_acc = torch.where(done_t, torch.zeros_like(n_acc), n_acc)
    new_idx = (p + n_acc + 1).to(torch.int32)
    catch_up = (n_acc == k) & ~done_t
    return (_set_cache_positions(cache, new_idx), emit, n_emit, n_acc, new_tok, new_done,
            catch_up, new_idx)


@torch.no_grad()
def commit(model: TransformerLM, cache: KVCache, last_draft: torch.Tensor,
           catch_up: torch.Tensor, new_idx: torch.Tensor) -> KVCache:
    """Re-sync the draft cache after a verify: rows that accepted all k
    drafts lack d_k's own KV (the draft steps wrote only their inputs), so
    one more draft step writes it at ``p + k``; the other rows' write is
    diverted to :func:`_oob_write_position`. Every row then commits to
    ``new_idx``."""
    divert = torch.where(catch_up, cache.index,
                         torch.full_like(cache.index, _oob_write_position(cache)))
    _set_cache_positions(cache, divert)
    _, cache = model.decode(last_draft.to(torch.int32)[:, None], cache)
    return _set_cache_positions(cache, new_idx)
