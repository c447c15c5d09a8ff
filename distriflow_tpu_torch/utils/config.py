"""Port of ``distriflow_tpu/utils/config.py``: ``CompileConfig``,
``ServingConfig`` and the strict-key helpers (the mesh, client and server
configs wait for the slices that use them).

``override(defaults, overrides)`` merges and raises on unrecognized keys;
:func:`make_config` builds a dataclass config through it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Sequence, Type, TypeVar

T = TypeVar("T")


class UnknownConfigKeyError(KeyError):
    """Raised when an override references a key the config does not define."""


def override(defaults: Mapping[str, Any], overrides: Optional[Mapping[str, Any]]) -> Dict[str, Any]:
    """Merge ``overrides`` into ``defaults``, rejecting unknown keys.

    Mirrors reference ``src/common/utils.ts:206-218`` (which throws on
    unrecognized keys) as a plain-dict utility. Dataclass configs below use
    :func:`make_config`, which routes through this.
    """
    merged = dict(defaults)
    if overrides:
        for key, value in overrides.items():
            if key not in defaults:
                raise UnknownConfigKeyError(
                    f"unrecognized config key {key!r}; valid keys: {sorted(defaults)}"
                )
            if value is not None:
                merged[key] = value
    return merged


def make_config(cls: Type[T], overrides: Optional[Mapping[str, Any]] = None, **kw: Any) -> T:
    """Build a dataclass config from defaults + overrides with strict keys."""
    if not dataclasses.is_dataclass(cls):
        raise TypeError(f"{cls!r} is not a dataclass config")
    defaults = {f.name: getattr(cls(), f.name) for f in dataclasses.fields(cls)}
    merged = override(defaults, {**(overrides or {}), **kw})
    return cls(**merged)


@dataclass
class CompileConfig:
    """Model compile arguments, the fields ``SpecModel`` reads. ``loss=None``
    means "use the model spec's loss", so setting only the optimizer never
    silently substitutes the objective."""

    loss: Optional[str] = None
    metrics: Sequence[str] = field(default_factory=lambda: ("accuracy",))
    optimizer: str = "sgd"


@dataclass
class ServingConfig:
    """Inference-server scheduling knobs (``server/inference_server.py``).

    ``max_slots`` caps the continuous-batching engine's concurrent rows
    (the KV cache is allocated ``[max_slots, max_seq, ...]`` up front);
    ``decode_chunk`` is how many tokens each device dispatch advances the
    whole batch (amortizes the host round-trip floor; retirement and
    admission happen at chunk boundaries, so it also bounds scheduling
    latency in tokens). ``prefill_chunk`` optionally splits admission
    prefill into fixed-size pieces so a long prompt cannot stall the
    running batch for its full length. ``batch_window_s`` /
    ``max_prompt_batch`` default to ``None`` = "use the module-level
    constants at call time" (which existing tests monkeypatch).

    ``kv_layout`` selects the KV cache organisation: ``"paged"`` (default)
    allocates a single pool of ``page_pool_pages`` pages of ``page_size``
    tokens each, indirected through per-slot page tables, so a request
    holds only the pages its context fills; ``"slab"`` keeps the legacy
    ``[max_slots, max_seq, ...]`` worst-case slab (retained for one
    release as the bit-identity oracle). ``page_pool_pages=None`` sizes
    the pool to the slab's HBM budget (``max_slots * ceil(max_seq /
    page_size)`` pages) so paged-vs-slab comparisons are equal-memory by
    construction. ``prefix_sharing`` lets requests whose prompts share
    full leading pages pin the same read-only pages (refcounted,
    copy-on-write on divergence).

    ``speculate_k`` enables draft/verify speculative decoding on the
    engine (docs/PERFORMANCE.md §7g): a small draft model proposes ``k``
    tokens per round and the target model scores all ``k+1`` positions in
    one batched pass, accepting the agreeing prefix (greedy) or the
    rejection-sampling-corrected prefix (sampled). ``0`` (default) keeps
    plain chunked decode. Requires the paged layout — the draft model's
    KV rides spare pages of the same pool, so admission reserves (and
    retirement reclaims) both models' pages. ``draft_model`` names the
    zoo draft config (``models/zoo.py::draft_config_for``); ``"self"``
    means self-speculation (draft == target — the mechanical ceiling
    benches measure).
    """

    max_slots: int = 8
    decode_chunk: int = 8
    prefill_chunk: Optional[int] = None
    batch_window_s: Optional[float] = None
    max_prompt_batch: Optional[int] = None
    kv_layout: str = "paged"
    page_size: int = 128
    page_pool_pages: Optional[int] = None
    prefix_sharing: bool = True
    speculate_k: int = 0
    draft_model: Optional[str] = None

    def pool_pages(self, max_seq: int) -> int:
        """Resolved pool size in pages: explicit override or the
        slab-equivalent HBM budget."""
        if self.page_pool_pages is not None:
            return self.page_pool_pages
        return self.max_slots * (-(-max_seq // self.page_size))

    def validate(self) -> "ServingConfig":
        if self.max_slots <= 0:
            raise ValueError(f"max_slots must be positive, got {self.max_slots}")
        if self.decode_chunk <= 0:
            raise ValueError(
                f"decode_chunk must be positive, got {self.decode_chunk}")
        if self.prefill_chunk is not None and self.prefill_chunk <= 0:
            raise ValueError(
                f"prefill_chunk must be positive when set, got {self.prefill_chunk}")
        if self.batch_window_s is not None and self.batch_window_s < 0:
            raise ValueError(
                f"batch_window_s must be >= 0 when set, got {self.batch_window_s}")
        if self.max_prompt_batch is not None and self.max_prompt_batch <= 0:
            raise ValueError(
                f"max_prompt_batch must be positive when set, got {self.max_prompt_batch}")
        if self.kv_layout not in ("paged", "slab"):
            raise ValueError(
                f"kv_layout must be 'paged' or 'slab', got {self.kv_layout!r}")
        if self.page_size <= 0:
            raise ValueError(f"page_size must be positive, got {self.page_size}")
        if self.page_pool_pages is not None and self.page_pool_pages <= 0:
            raise ValueError(
                f"page_pool_pages must be positive when set, got {self.page_pool_pages}")
        if self.speculate_k < 0:
            raise ValueError(
                f"speculate_k must be >= 0, got {self.speculate_k}")
        if self.speculate_k > 0 and self.kv_layout != "paged":
            # the draft model's KV rides spare pages of the target's pool;
            # there is no slab home for it — fail at construction, not at
            # the first admission
            raise ValueError(
                "speculate_k > 0 requires kv_layout='paged' (the draft "
                f"KV rides the page pool), got kv_layout={self.kv_layout!r}")
        if self.draft_model is not None and self.speculate_k == 0:
            raise ValueError(
                "draft_model is set but speculate_k is 0 — enable "
                "speculation or drop the draft")
        return self


def serving_config(overrides: Optional[Mapping[str, Any]] = None) -> ServingConfig:
    """Validated inference-serving config (strict keys, like the rest)."""
    return make_config(ServingConfig, overrides).validate()
