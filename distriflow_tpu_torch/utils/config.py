"""Port of ``distriflow_tpu/utils/config.py``: the strict-key helpers,
the wire-training configs (``RetryPolicy``, ``ClientHyperparams``,
``ServerHyperparams``, ``QuarantinePolicy``, ``DatasetConfig``),
``CompileConfig``, ``MeshConfig`` and ``ServingConfig``. Every default is
the JAX package's.

``override(defaults, overrides)`` merges and raises on unrecognized keys;
:func:`make_config` builds a dataclass config through it.
"""

from __future__ import annotations

import dataclasses
import random
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, Mapping, Optional, Sequence, Type, TypeVar

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


def asdict(cfg: Any) -> Dict[str, Any]:
    """Dataclass config -> plain dict (wire-friendly; used by DownloadMsg)."""
    return dataclasses.asdict(cfg)


# allowed gradient_compression values (shared with AbstractClient.compress_grads).
# "topk"/"topk_int8" are the sparse modes: ship only the top-|k| entries per
# leaf (k = topk_fraction of the leaf size) with client-side error feedback;
# "topk_int8" additionally int8-quantizes the kept values.
COMPRESSION_DTYPES = ("none", "float16", "bfloat16", "int8", "topk", "topk_int8")

# allowed weight_compression values (server weight broadcasts): no int8 —
# quantization error on WEIGHTS compounds every round, unlike gradients
# where client-side error feedback absorbs it
WEIGHT_COMPRESSION_DTYPES = ("none", "float16", "bfloat16")


@dataclass
class RetryPolicy:
    """Exponential backoff with jitter, shared by the client's upload-retry
    and reconnect loops (no reference counterpart — the reference dies on
    the first transient failure; SURVEY §5).

    ``delays()`` yields ``max_retries`` sleep durations: the base doubles
    (``multiplier``) from ``initial_backoff_s`` up to ``max_backoff_s``,
    and each delay is stretched by up to ``jitter`` of itself so a fleet
    of clients re-dialing a restarted server doesn't stampede in lockstep.
    A set ``seed`` makes the schedule fully deterministic (chaos tests).
    """

    max_retries: int = 8
    initial_backoff_s: float = 0.2
    max_backoff_s: float = 10.0
    multiplier: float = 2.0
    jitter: float = 0.5  # fraction of the base delay, uniformly sampled
    seed: Optional[int] = None

    def validate(self) -> "RetryPolicy":
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        if self.initial_backoff_s < 0 or self.max_backoff_s < self.initial_backoff_s:
            raise ValueError(
                f"need 0 <= initial_backoff_s <= max_backoff_s, got "
                f"{self.initial_backoff_s} / {self.max_backoff_s}"
            )
        if self.multiplier < 1.0:
            raise ValueError(f"multiplier must be >= 1, got {self.multiplier}")
        if self.jitter < 0:
            raise ValueError(f"jitter must be >= 0, got {self.jitter}")
        return self

    def delays(self) -> Iterator[float]:
        rng = random.Random(self.seed)
        base = self.initial_backoff_s
        for _ in range(self.max_retries):
            yield base * (1.0 + self.jitter * rng.random())
            base = min(base * self.multiplier, self.max_backoff_s)


@dataclass
class ClientHyperparams:
    """Client-side training hyperparameters.

    Defaults mirror reference ``src/common/utils.ts:181-186``
    (``{batchSize:32, learningRate:.001, epochs:5, examplesPerUpdate:5}``).
    """

    batch_size: int = 32
    learning_rate: float = 0.001
    epochs: int = 5
    examples_per_update: int = 5
    # wire-bandwidth knob (no reference counterpart — gradients there always
    # travel at full precision): cast uploaded gradients to a 16-bit float
    # before serialization, halving upload bytes; the server accumulates the
    # mean in float32 either way. One of COMPRESSION_DTYPES.
    gradient_compression: str = "none"
    # sparse-upload knob (gradient_compression in ("topk", "topk_int8")):
    # fraction of each leaf's entries shipped per update. The un-sent mass
    # stays in the client's error-feedback residual, so smaller fractions
    # trade convergence speed for wire bytes, not correctness (DGC, Lin et
    # al. 2018). Ignored by the dense modes.
    topk_fraction: float = 0.01
    # double-buffered upload window (docs/PERFORMANCE.md pipelining §):
    # how many unacked uploads a client may have in flight while it fits
    # the next batch. 1 = serial fit->compress->serialize->submit->ack;
    # 2 = classic double buffer (compress/serialize/submit ride a comm
    # thread). The async server clamps its dispatch-ahead at
    # min(inflight_window, maximum_staleness + 1) so the pipeline can
    # never push effective staleness past the bound.
    inflight_window: int = 1
    # fleet telemetry plane (docs/OBSERVABILITY.md §10): how often a client
    # piggybacks a telemetry report on its upload metadata (inference
    # clients ride the heartbeat instead). 0 disables shipping. Server-
    # pushable like every other client hyperparameter, so an operator can
    # throttle the whole fleet's reporting from one place.
    telemetry_report_interval_s: float = 5.0

    def validate(self) -> "ClientHyperparams":
        if self.batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {self.batch_size}")
        if self.learning_rate <= 0:
            raise ValueError(f"learning_rate must be positive, got {self.learning_rate}")
        if self.epochs <= 0:
            raise ValueError(f"epochs must be positive, got {self.epochs}")
        if self.examples_per_update <= 0:
            raise ValueError(
                f"examples_per_update must be positive, got {self.examples_per_update}"
            )
        if self.gradient_compression not in COMPRESSION_DTYPES:
            raise ValueError(
                f"gradient_compression must be one of {COMPRESSION_DTYPES}, "
                f"got {self.gradient_compression!r}"
            )
        if not 0.0 < self.topk_fraction <= 1.0:
            raise ValueError(
                f"topk_fraction must be in (0, 1], got {self.topk_fraction}"
            )
        if self.inflight_window < 1:
            raise ValueError(
                f"inflight_window must be >= 1, got {self.inflight_window}"
            )
        if self.telemetry_report_interval_s < 0:
            raise ValueError(
                f"telemetry_report_interval_s must be >= 0, got "
                f"{self.telemetry_report_interval_s}"
            )
        return self


@dataclass
class ServerHyperparams:
    """Server-side aggregation hyperparameters.

    Defaults mirror reference ``src/common/utils.ts:188-191``
    (``{aggregation:'mean', minUpdatesPerVersion:20}``), plus the
    README-promised-but-unimplemented bounded staleness knob
    (``maximum_staleness``; reference ``README.md:27``). ``staleness_decay``
    optionally down-weights stale-but-accepted gradients instead of a hard
    accept/reject cliff.
    """

    aggregation: str = "mean"
    min_updates_per_version: int = 20
    maximum_staleness: int = 0
    staleness_decay: float = 1.0
    # weight-broadcast compression: the dtype the server serializes params
    # in for DownloadMsg. 16-bit halves every broadcast; clients restore
    # their model's own param dtype on install. (int8 is deliberately NOT
    # offered here: quantization error on weights compounds every round,
    # unlike gradients where error feedback absorbs it.)
    weight_compression: str = "none"
    # delta weight broadcasts: when True the server tracks the last params
    # each connection is known to hold and ships per-leaf ``new - base``
    # (through the same weight_compression cast) instead of full weights,
    # falling back to a full broadcast whenever the client's base version
    # is unknown, aged out of the retained window, or the connection is
    # fresh (first download / reconnect / post-restart).
    delta_broadcast: bool = True

    def validate(self) -> "ServerHyperparams":
        if self.aggregation not in ("mean", "sum"):
            raise ValueError(f"aggregation must be 'mean' or 'sum', got {self.aggregation!r}")
        if self.weight_compression not in WEIGHT_COMPRESSION_DTYPES:
            raise ValueError(
                f"weight_compression must be one of {WEIGHT_COMPRESSION_DTYPES}, "
                f"got {self.weight_compression!r}"
            )
        if self.min_updates_per_version <= 0:
            raise ValueError(
                f"min_updates_per_version must be positive, got {self.min_updates_per_version}"
            )
        if self.maximum_staleness < 0:
            raise ValueError(f"maximum_staleness must be >= 0, got {self.maximum_staleness}")
        if not 0.0 < self.staleness_decay <= 1.0:
            raise ValueError(f"staleness_decay must be in (0, 1], got {self.staleness_decay}")
        return self


@dataclass
class QuarantinePolicy:
    """Gradient-quarantine gate for the wire-serving training servers.

    One poisoned upload (NaN/inf from a diverged or buggy worker) applied
    to the canonical model corrupts every subsequent broadcast — the
    classic parameter-server failure (Li et al., OSDI 2014 §5.3). The gate
    sits in front of every apply: non-finite gradients are rejected
    outright, and a global-norm outlier (vs. an EMA of accepted norms) is
    rejected once the EMA has seen ``warmup_updates`` accepted gradients.
    Rejected payloads are dumped under ``save_dir/quarantine/`` for
    postmortem (``docs/ROBUSTNESS.md`` §8). A post-apply rollback guard
    restores the previous params if an update drove THEM non-finite.
    """

    enabled: bool = True
    # reject when gradient global-norm > multiplier * EMA(accepted norms)
    max_norm_multiplier: float = 10.0
    ema_decay: float = 0.9
    warmup_updates: int = 5  # no norm gating until the EMA is warm
    dump: bool = True  # write rejected payloads to save_dir/quarantine/

    def validate(self) -> "QuarantinePolicy":
        if self.max_norm_multiplier <= 1.0:
            raise ValueError(
                f"max_norm_multiplier must be > 1, got {self.max_norm_multiplier}"
            )
        if not 0.0 < self.ema_decay < 1.0:
            raise ValueError(f"ema_decay must be in (0, 1), got {self.ema_decay}")
        if self.warmup_updates < 1:
            raise ValueError(f"warmup_updates must be >= 1, got {self.warmup_updates}")
        return self


@dataclass
class DatasetConfig:
    """Dataset sharding config (reference ``src/common/utils.ts:193-197``).

    Unlike the reference — which accepts ``smallLastBatch`` but never honors it
    and silently over-runs the final slice (``src/server/dataset.ts:69-85``) —
    ``small_last_batch`` here actually controls whether a final partial batch
    is emitted (True) or dropped (False).
    """

    batch_size: int = 32
    epochs: int = 5
    small_last_batch: bool = False
    shuffle: bool = False
    seed: int = 0

    def validate(self) -> "DatasetConfig":
        if self.batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {self.batch_size}")
        if self.epochs <= 0:
            raise ValueError(f"epochs must be positive, got {self.epochs}")
        return self


@dataclass
class CompileConfig:
    """Model compile arguments, the fields ``SpecModel`` reads. ``loss=None``
    means "use the model spec's loss", so setting only the optimizer never
    silently substitutes the objective."""

    loss: Optional[str] = None
    metrics: Sequence[str] = field(default_factory=lambda: ("accuracy",))
    optimizer: str = "sgd"


@dataclass
class MeshConfig:
    """Device-mesh layout for the parallel layer (JAX ``MeshConfig``, field
    for field). Axis sizes of 1 are always legal; the product of the sizes
    must equal the number of ranks. ``data`` is DP, ``model`` TP, ``seq``
    SP (ring or Ulysses attention), ``pipe`` PP, ``expert`` EP."""

    data: int = 1
    model: int = 1
    seq: int = 1
    pipe: int = 1
    expert: int = 1

    @property
    def size(self) -> int:
        return self.data * self.model * self.seq * self.pipe * self.expert


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


DEFAULT_CLIENT_HYPERPARAMS = ClientHyperparams()
DEFAULT_SERVER_HYPERPARAMS = ServerHyperparams()
DEFAULT_DATASET_CONFIG = DatasetConfig()


def client_hyperparams(overrides: Optional[Mapping[str, Any]] = None) -> ClientHyperparams:
    """Validated client hyperparams (reference ``src/common/utils.ts:220-227``)."""
    return make_config(ClientHyperparams, overrides).validate()


def server_hyperparams(overrides: Optional[Mapping[str, Any]] = None) -> ServerHyperparams:
    """Validated server hyperparams (reference ``src/common/utils.ts:229-234``)."""
    return make_config(ServerHyperparams, overrides).validate()


#: async-mode default for ``maximum_staleness`` when the user leaves it unset:
#: with N concurrent workers the steady-state staleness is N-1 (every other
#: worker's apply bumps the version mid-flight), so the sync-mode default of 0
#: would reject most honest async work. 8 covers typical worker counts while
#: still dropping pathologically stale gradients — the bound the reference
#: promised but never implemented (``README.md:27``; its async server applies
#: with no check at all, ``asynchronousSGD_server.ts:95-108``).
ASYNC_DEFAULT_MAXIMUM_STALENESS = 8


def async_server_hyperparams(
    overrides: Optional[Mapping[str, Any]] = None,
) -> ServerHyperparams:
    """:func:`server_hyperparams` with the tolerant async-mode staleness
    default. ``None`` values mean "unset" (matching :func:`override`)."""
    hp = server_hyperparams(overrides)
    if overrides is None or overrides.get("maximum_staleness") is None:
        hp.maximum_staleness = ASYNC_DEFAULT_MAXIMUM_STALENESS
    return hp


def dataset_config(overrides: Optional[Mapping[str, Any]] = None) -> DatasetConfig:
    return make_config(DatasetConfig, overrides).validate()
