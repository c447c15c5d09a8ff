"""Port of ``distriflow_tpu/server/inference_server.py``: serve KV-cache
decoding over the wire transport.

Events, byte-compatible with the JAX package's clients (arrays travel as
``pack_bytes``/``SerializedArray`` buffers):

- ``model_info``  {} -> {vocab_size, max_seq, d_model, n_layers, n_heads, name}
- ``generate``    {prompt: <packed {tokens}>, n_tokens, temperature?,
  top_k?, top_p?, eos_id?, seed?, request_id?, tier?} ->
  {result: <packed {tokens}>, serving: {path, queue_ms?, ...}}
- ``beam``        {prompt, n_tokens, beam_size?, length_penalty?, eos_id?}
  -> {result: <packed {tokens, scores}>}
- ``score``       {prompt: <packed {tokens}>, from_pos?} ->
  {result: <packed {scores}>}
- ``drain``, ``fleet_stats``, ``hedge_cancel`` — the fleet-router plane.

``beam`` and ``score`` run on the direct path (one device program at a
time, beside the engine) and echo a request's ``trace_id``.

``generate`` requests are served by the continuous-batching engine: one
scheduler thread admits queued requests into free slots (gated on free KV
pages under the default paged layout, with prefix sharing and
copy-on-write), advances every live row ``decode_chunk`` tokens per
iteration and retires finished rows at chunk boundaries. Requests the
engine cannot take (more rows than slots, multi-row sampled prompts) run
the solo :func:`~distriflow_tpu_torch.models.generate.generate` ("direct").
Greedy rows are row-independent; sampled rows draw from their own
``(seed, position)`` streams, so neither depends on batch composition.

Speculative decoding (``ServingConfig.speculate_k > 0``, paged layout
only): a small draft model keeps its own paged cache over the same page
pool; each engine round drafts k tokens, verifies all k + 1 positions in
one target pass and commits the accepted prefix
(:func:`~distriflow_tpu_torch.models.generate.verify`). Greedy output
equals plain decode's.

**Mesh-aware serving** (JAX's "mesh-aware serving"): a model on a mesh
(``TransformerLM(..., mesh=)`` holding this rank's blocks, cut by
``models/base.py::cut_blocks``, e.g. ``lm_from_jax(mesh=)`` under
``TRANSFORMER_TP_RULES``: the model carries its rule table, by which a
weight load cuts the new weights) is served SPMD, one process a rank. Every rank
constructs the server; rank 0 owns the transport, admission, the page
allocator and every other host decision, and the other ranks run
:meth:`InferenceServer.follow`. Each device program rank 0 runs (the cache
allocation, an admission's prefill and insert, an engine iteration, a
direct ``generate``, ``beam``, ``score``, a weight load) is first sent to
the followers over a gloo group of its own (``broadcast_object_list``:
the op and its host arguments: rows, slot and page tables, tokens,
sampling settings), under the device lock, so every rank runs the same
programs in the same order on the same inputs: each over its local heads
(its paged pool holds those heads' K/V at the same page indices) and with
the same collectives. Host-only paths (a refusal, a disconnect, a
cancelled row's retirement) send nothing; their effect reaches the
followers in the next program's tables. After each program every rank
reports over the same group how it ended: the mesh stays in step when
every rank succeeded or every rank raised the same error (a program
refused on identical inputs); otherwise every rank stops serving at once,
rank 0 with :attr:`InferenceServer.mesh_error` naming the rank and its
error (a rank that failed before one of the program's collectives holds
its partners there until the mesh group's timeout first). While no
program runs, rank 0 sends a no-op every half control timeout, so an idle
rank 0 is never taken for a lost one. ``stop`` sends the followers' exit.
A follower that loses rank 0 (no program and no no-op) raises within the
control group's timeout.

Speculative serving runs over a mesh too: the draft's prefill at admission
and each round's draft, verify and commit are device programs every rank
runs (one ``spec_round`` program a round). The draft follows JAX's layout:
a separate draft (``lm_draft``, or a ``draft=`` model built with no mesh)
is whole on every rank, and ``draft_model="self"`` drafts with the TP
target on its local heads (its cache sized by them). Each rank computes
the drafts the target's verify consumes itself, none is sent: the same
programs on the same inputs give the same drafts, and each rank reports a
digest of its drafts and proposal sums with its outcome, so ranks that
drafted apart stop every rank at once, with ``mesh_error`` naming them.
"""

from __future__ import annotations

import hashlib
import queue as queue_mod
import threading
from datetime import timedelta
import time as time_mod
from collections import OrderedDict, deque
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from distriflow_tpu_torch.analysis.witness import PoolWitness
from distriflow_tpu_torch.comm.transport import ServerTransport
from distriflow_tpu_torch.fleet.prefix_hash import page_hashes
from distriflow_tpu_torch.models.generate import (
    _check_fits,
    beam_search,
    commit,
    decode_chunk,
    draft_k,
    extend,
    gather_rows,
    generate,
    paged_cache,
    paged_insert,
    pages_per_slot,
    pick_rows,
    prefill,
    sequence_logprob,
    set_page_tables,
    slot_cache,
    slot_insert,
    verify,
)
from distriflow_tpu_torch.models.base import shard_state
from distriflow_tpu_torch.models.transformer import TransformerLM, init_weights
from distriflow_tpu_torch.models.zoo import draft_config_for
from distriflow_tpu_torch.obs import FleetTable, get_telemetry
from distriflow_tpu_torch.utils.config import ServingConfig
from distriflow_tpu_torch.utils.logging import VerboseLogger
from distriflow_tpu_torch.utils.serialization import (
    deserialize_array,
    pack_bytes,
    serialize_array,
    unpack_bytes,
)

MAX_PROMPT_BATCH = 64  # refuse absurd wire batches before touching the device
BATCH_WINDOW_S = 0.004  # collection window after the first idle-state request


class _Request:
    """One queued ``generate`` request awaiting the engine."""

    __slots__ = (
        "prompt", "n_tokens", "temperature", "top_k", "top_p", "eos",
        "seed", "client_id", "enq_t", "admit_t", "rows_out", "rows_left",
        "cancelled", "done", "result", "error", "page_plan",
        "trace_id", "parent_span", "request_id", "tier", "first_tok_t",
        "ttft_ms", "tpot_ms",
    )

    def __init__(self, prompt: np.ndarray, n_tokens: int, temperature: float,
                 top_k: int, top_p: float, eos: int, seed: int,
                 client_id: str):
        self.prompt = prompt
        self.n_tokens = n_tokens
        self.temperature = temperature
        self.top_k = top_k          # 0 = off
        self.top_p = top_p          # 1.0 = off
        self.eos = eos              # -1 = no eos
        self.seed = seed
        self.client_id = client_id
        self.enq_t = time_mod.monotonic()
        self.admit_t: Optional[float] = None
        self.rows_out: List[Optional[np.ndarray]] = [None] * prompt.shape[0]
        self.rows_left = prompt.shape[0]
        self.cancelled = False
        self.done = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[Exception] = None
        # paged layout: per-row page reservation ({"shared", "owned",
        # "hashes", "committed"}), released at slot retirement (committed)
        # or by _release_plan (admission failure)
        self.page_plan: Optional[List[Dict[str, Any]]] = None
        self.trace_id = ""
        self.parent_span = ""
        self.request_id: Optional[str] = None
        self.tier = 0
        self.first_tok_t: Optional[float] = None
        self.ttft_ms: Optional[float] = None
        self.tpot_ms: Optional[float] = None


class _PagePool:
    """Host-side allocator for the paged KV cache's physical pages: free
    list plus refcounts. Runs on the single scheduler thread."""

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self._free: List[int] = list(range(n_pages - 1, -1, -1))
        self._refs = np.zeros((n_pages,), np.int32)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.n_pages - len(self._free)

    def refcount(self, page: int) -> int:
        return int(self._refs[page])

    # dfcheck: pairs acquire=alloc release=unref
    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise RuntimeError(
                f"page pool exhausted: need {n}, have {len(self._free)}")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        return pages

    # dfcheck: pairs acquire=ref release=unref mode=state
    def ref(self, pages: List[int]) -> None:
        for p in pages:
            if self._refs[p] <= 0:
                raise RuntimeError(f"ref of free page {p}")
            self._refs[p] += 1

    def unref(self, pages: List[int]) -> int:
        """Drop one reference per page; returns how many went free."""
        freed = 0
        for p in pages:
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free.append(p)
                freed += 1
            elif self._refs[p] < 0:
                raise RuntimeError(f"unref of free page {p}")
        return freed


def _prompt_from(payload: Dict[str, Any], limit: Optional[int] = None) -> np.ndarray:
    cap = MAX_PROMPT_BATCH if limit is None else limit
    arr = np.asarray(deserialize_array(unpack_bytes(payload["prompt"])["tokens"]))
    if arr.ndim != 2:
        raise ValueError(f"prompt must be [B, P], got shape {arr.shape}")
    if not 1 <= arr.shape[0] <= cap:
        raise ValueError(f"prompt batch {arr.shape[0]} outside [1, {cap}]")
    if not np.issubdtype(arr.dtype, np.integer):
        raise ValueError(f"prompt must be integer tokens, got {arr.dtype}")
    return arr.astype(np.int32)


def _ready(t: torch.Tensor) -> None:
    """Wait for the device work behind ``t`` (a phase's end on the card)."""
    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()


class InferenceServer:
    """Serve a :class:`TransformerLM`'s decoding over the native transport.
    The model's device (``cuda`` unless it was built on the CPU) is where
    every request runs.

    With ``serving.speculate_k > 0`` the draft is ``draft`` (the
    counterpart of JAX's ``draft_params``; its config must share the
    target's vocab, ``max_seq`` and dtype) or, with none given, a model of
    ``draft_config_for(serving.draft_model or "lm_draft", config)`` with
    seeded weights (:func:`init_weights`, seed 0). ``draft_model="self"``
    drafts with the target itself, so :meth:`set_params` moves both."""

    def __init__(
        self,
        model: TransformerLM,
        host: str = "127.0.0.1",
        port: int = 0,
        verbose: Optional[bool] = None,
        serving: Optional[ServingConfig] = None,
        telemetry: Any = None,
        draft: Optional[TransformerLM] = None,
        control_timeout_s: float = 60.0,
    ):
        self.model = model
        self.config = config = model.config
        self.serving = (serving or ServingConfig()).validate()
        self.logger = VerboseLogger("InferenceServer", verbose)
        self._device_lock = threading.Lock()  # one device program at a time
        # the mesh (see the module docstring): rank 0 leads, the rest follow
        import torch.distributed as dist

        self.mesh = getattr(model, "mesh", None)
        self._spmd = self.mesh is not None and dist.is_initialized() and \
            dist.get_world_size() > 1
        self.is_leader = not self._spmd or dist.get_rank() == 0
        # every rank makes the control group, in the same order
        self._ctl = dist.new_group(backend="gloo", timeout=timedelta(
            seconds=control_timeout_s)) if self._spmd else None
        self._ctl_timeout_s = control_timeout_s
        self._ctl_closed = False  # guarded-by: _device_lock
        self._last_send = 0.0  # guarded-by: _device_lock
        # why the mesh stopped serving (rank 0; None while in step)
        self.mesh_error: Optional[str] = None  # guarded-by: _device_lock
        self._heartbeat: Optional[threading.Thread] = None
        self._follower: Optional[threading.Thread] = None
        self.follower_error: Optional[BaseException] = None
        self.follower_ops = 0  # device programs a follower ran
        # what the running program's inputs were, for the ranks to agree on
        # (None, or a short string; set by a program, read by _agree)
        self._op_check: Optional[str] = None
        self.transport = ServerTransport(host, port)
        self.transport.on("model_info", self._on_info)
        self.transport.on("generate", self._on_generate)
        self.transport.on("beam", self._on_beam)
        self.transport.on("score", self._on_score)
        self.transport.on("fleet_stats", self._on_fleet_stats)
        self.transport.on("drain", self._on_drain)
        self.transport.on("hedge_cancel", self._on_hedge_cancel)
        self.transport.on_disconnect = self._on_client_disconnect
        # fleet-router plane: draining refuses NEW generates; request-id
        # dedup returns a cached ack for a replayed id and parks a
        # duplicate of an in-flight id on the original's compute
        self._draining = False
        self._dedup_lock = threading.Lock()
        self._req_results: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()  # guarded-by: _dedup_lock
        self._req_live: Dict[str, threading.Event] = {}  # guarded-by: _dedup_lock
        self._dedup_cap = 256
        self._evicted_prefixes: Deque[bytes] = deque(maxlen=512)
        self._prefix_hit_counts: Dict[bytes, int] = {}
        self.prefix_hits = 0  # single-writer: scheduler thread
        self._queue: "queue_mod.Queue[Optional[_Request]]" = queue_mod.Queue()
        self._backlog: Deque[_Request] = deque()  # pulled, awaiting a slot
        self._dispatcher: Optional[threading.Thread] = None
        self._stopped = threading.Event()
        # single-writer counters (scheduler thread), read by tests
        self.decode_batches = 0
        self.batched_requests = 0
        # the target's fresh prefills: one prompt-attention kernel launch a
        # layer each (a shared-prefix group's extend runs none)
        self.prefills = 0
        self._inflight_lock = threading.Lock()
        self._inflight: Dict[str, List[_Request]] = {}  # guarded-by: _inflight_lock
        # slot state (host side; the device cache is allocated at the first
        # admission). Free slots sit done=True so the decode loop leaves
        # them frozen; their writes stay confined to their own row.
        s = self.serving.max_slots
        self._slot_cache: Any = None
        self._tok = np.zeros((s,), np.int32)
        self._done = np.ones((s,), bool)
        self._temps = np.zeros((s,), np.float32)
        self._top_ks = np.zeros((s,), np.int32)
        self._top_ps = np.ones((s,), np.float32)
        self._seeds = np.zeros((s,), np.int32)
        self._eos = np.full((s,), -1, np.int32)
        self._slot_req: List[Optional[_Request]] = [None] * s
        self._slot_row = np.zeros((s,), np.int32)
        self._slot_emitted = np.zeros((s,), np.int64)
        # paged layout: the host owns the authoritative page table; every
        # mutation marks it dirty and the next dispatch re-installs it, so
        # a retired slot's frozen writes never land in a re-issued page
        self._paged = self.serving.kv_layout == "paged"
        self._pp = pages_per_slot(config.max_seq, self.serving.page_size)
        self._n_pages = self.serving.pool_pages(config.max_seq)
        self._pool = _PagePool(self._n_pages) if self._paged else None
        self._pool_witness = PoolWitness(self._n_pages) if self._paged else None
        self._tables = np.full((s, self._pp + 1), self._n_pages, np.int32)
        self._tables_dirty = False
        self._slot_pages: List[List[int]] = [[] for _ in range(s)]
        # prefix-reuse map: chain hash of a prompt's j-th full page ->
        # physical page; one pool reference per entry; insertion order is
        # the LRU order
        self._prefix_map: "OrderedDict[bytes, int]" = OrderedDict()
        # speculative decoding: the draft keeps its own paged cache and page
        # tables but draws page ids from the same _PagePool, so draft KV
        # competes with target KV for the pool and every occupancy metric
        # counts it
        # (a self-draft is the target object itself, so set_params, which
        # loads in place, moves both)
        self._spec_k = self.serving.speculate_k
        self.draft_model: Optional[TransformerLM] = None
        self._draft_cache: Any = None
        self._draft_tables = np.full((s, self._pp + 1), self._n_pages, np.int32)
        self._draft_tables_dirty = False
        self._draft_pages: List[List[int]] = [[] for _ in range(s)]
        self.spec_accept_per_step = 0.0  # single-writer: scheduler thread
        if self._spec_k:
            name = self.serving.draft_model or "lm_draft"
            if name == "self":
                if draft is not None:
                    raise ValueError('draft_model="self" drafts with the target; pass no draft')
                self.draft_model = model
            elif draft is not None:
                shared = ("vocab_size", "max_seq", "dtype")
                if any(getattr(draft.config, f) != getattr(config, f) for f in shared):
                    raise ValueError(f"the draft must share the target's {', '.join(shared)}")
                self.draft_model = draft
            else:
                self.draft_model = init_weights(
                    TransformerLM(draft_config_for(name, config), device=model.device), seed=0)
        elif draft is not None:
            raise ValueError("a draft model needs serving.speculate_k > 0")
        tel = telemetry if telemetry is not None else get_telemetry()
        self._m_batches = tel.counter(
            "serving_decode_batches_total",
            help="decode batches dispatched by the engine loop")
        self._m_admitted = tel.counter(
            "serving_batched_requests_total",
            help="requests admitted into a decode slot")
        self._m_tokens = tel.counter(
            "serving_tokens_generated_total",
            help="output tokens committed across all slots")
        self._m_slots = tel.gauge(
            "serving_slots_active", help="decode slots currently occupied")
        self._m_qwait = tel.histogram(
            "serving_queue_wait_ms",
            help="enqueue-to-admission wait per request (ms)")
        self._m_ttft = {t: tel.histogram(
            "serving_ttft_ms", tier=str(t),
            help="enqueue-to-first-token wall per request (ms), by tier")
            for t in (0, 1, 2)}
        self._m_tpot = {t: tel.histogram(
            "serving_time_per_output_token_ms", tier=str(t),
            help="per-slot decode interval per emitted token (ms), by tier")
            for t in (0, 1, 2)}
        self._ttft_peak = {0: 0.0, 1: 0.0, 2: 0.0}
        self._tpot_peak = {0: 0.0, 1: 0.0, 2: 0.0}
        self._slot_emit_t = [0.0] * s
        self._m_pages = tel.gauge(
            "serving_page_occupancy",
            help="fraction of KV-cache pages currently allocated")
        self._m_prefix_hits = tel.counter(
            "serving_prefix_hits_total",
            help="admissions that reused a cached prefix")
        self._m_dedup_hits = tel.counter(
            "serving_dedup_hits_total",
            help="duplicate request_ids suppressed by the dedup gate "
                 "(cached-ack returns + in-flight parks)")
        self._m_hedge_cancelled = tel.counter(
            "serving_hedge_cancelled_total",
            help="in-flight requests flagged cancelled by hedge_cancel")
        self._m_prefix_tokens = tel.counter(
            "serving_prefix_tokens_saved_total",
            help="prompt tokens skipped via prefix-cache reuse")
        self._m_pages_alloc = tel.counter(
            "serving_pages_allocated_total", help="KV-cache pages allocated")
        self._m_pages_freed = tel.counter(
            "serving_pages_released_total", help="KV-cache pages released")
        self._m_spec_proposed = tel.counter(
            "serving_spec_proposed_total",
            help="draft tokens proposed by speculative decoding")
        self._m_spec_accepted = tel.counter(
            "serving_spec_accepted_total",
            help="draft tokens accepted by the target model")
        self._m_spec_rate = tel.gauge(
            "serving_spec_accepted_per_step",
            help="accepted draft tokens per speculative step")
        self._prof = tel.profiler("serving")
        self.fleet = FleetTable()
        self._tel = tel
        tel.register_fleet(id(self), self.fleet.snapshot)

    # -- lifecycle ---------------------------------------------------------

    def setup(self) -> "InferenceServer":
        """Start serving (rank 0), or start following rank 0's programs
        (every other rank of a mesh; :meth:`follow` waits for the end)."""
        if not self.is_leader:
            self._follower = threading.Thread(target=self._follow_loop, daemon=True,
                                              name="inference-follower")
            self._follower.start()
            return self
        self._stopped.clear()
        self._drain_and_error()
        self.transport.start()
        self._dispatcher = threading.Thread(
            target=self._engine_loop, daemon=True, name="inference-batcher")
        self._dispatcher.start()
        if self._spmd:
            with self._device_lock:
                self._last_send = time_mod.monotonic()
            self._heartbeat = threading.Thread(
                target=self._heartbeat_loop, daemon=True, name="inference-heartbeat")
            self._heartbeat.start()
        self.logger.log(f"serving on {self.address}")
        return self

    def stop(self) -> None:
        if not self.is_leader:
            self.follow()
            return
        self._stopped.set()  # before the drain: closes the enqueue race
        self.transport.stop()
        if self._dispatcher is not None:
            self._queue.put(None)  # wake + exit sentinel
            self._dispatcher.join(timeout=5.0)
            self._dispatcher = None
        self._drain_and_error()
        if self._spmd:
            with self._device_lock:  # the followers' last program
                if not self._ctl_closed:
                    self._send("stop", {})
                    self._ctl_closed = True
            if self._heartbeat is not None:
                self._heartbeat.join(timeout=5.0)
                self._heartbeat = None
        self._tel.unregister_fleet(id(self))
        self.verify_pool_conservation("stop")

    # -- the mesh: rank 0 sends each device program, the others follow ------

    def _send(self, op: str, kw: Dict[str, Any]) -> None:
        """Broadcast program ``op`` to the followers (device lock held)."""
        import torch.distributed as dist

        dist.broadcast_object_list([(op, kw)], src=0, group=self._ctl)
        self._last_send = time_mod.monotonic()

    def _mirror(self, op: str, **kw: Any) -> Any:
        """Run device program ``op`` here, sent to the followers first on a
        mesh (call with the device lock held: the lock orders the
        programs), then agree with them on how it ended."""
        if not self._spmd:
            return getattr(self, f"_op_{op}")(**kw)
        if self._ctl_closed:
            raise RuntimeError(f"mesh serving stopped: {self.mesh_error}" if self.mesh_error
                               else "inference server stopped")
        try:
            self._send(op, kw)
        except Exception as e:  # a follower is gone
            self._stop_mesh(f"{op}: sending the program failed: {e!r}")
            raise RuntimeError(f"mesh serving stopped: {self.mesh_error}") from e
        err: Optional[Exception] = None
        out = None
        self._op_check = None
        try:
            out = getattr(self, f"_op_{op}")(**kw)
        except Exception as e:
            err = e
        broken = self._agree(op, err, self._op_check)
        if broken is not None:
            self._stop_mesh(broken)
            raise RuntimeError(f"mesh serving stopped: {broken}") from err
        if err is not None:  # every rank raised it: the mesh stays in step
            raise err
        return out

    def _stop_mesh(self, why: str) -> None:
        """Rank 0 stops sending programs (device lock held)."""
        self._ctl_closed = True
        self.mesh_error = why
        self.logger.log(f"mesh serving stopped: {why}")

    def _agree(self, op: str, err: Optional[Exception],
               check: Optional[str] = None) -> Optional[str]:
        """Every rank reports how program ``op`` ended (None, or its error)
        and the program's ``check`` (what it computed on, where it says);
        returns None when the mesh stays in step (every rank succeeded, or
        every rank raised the same error, on the same check), else why
        every rank stops. All ranks see the same reports, so all reach the
        same verdict."""
        import torch.distributed as dist

        mine = (None if err is None else f"{type(err).__name__}: {err}", check)
        seen: List[Any] = [None] * dist.get_world_size(self._ctl)
        try:
            dist.all_gather_object(seen, mine, group=self._ctl)
        except Exception as e:
            return f"{op}: the ranks' status exchange failed: {e!r}"
        if all(s == seen[0] for s in seen):
            return None
        if all(s[0] == seen[0][0] for s in seen):  # the same outcome on other inputs
            return f"{op}: " + "; ".join(
                f"rank {r} {c} where rank 0 {seen[0][1]}"
                for r, (_, c) in enumerate(seen) if c != seen[0][1])
        return f"{op}: " + "; ".join(
            f"rank {r} raised {s}" if s is not None else f"rank {r} succeeded"
            for r, (s, _) in enumerate(seen))

    def _heartbeat_loop(self) -> None:
        """Rank 0 while it serves: a no-op program whenever none was sent
        for half the control timeout, so the followers, which wait at most
        that timeout for the next program, never take an idle rank 0 for
        a lost one."""
        period = self._ctl_timeout_s / 2
        while not self._stopped.wait(period / 4):
            with self._device_lock:
                if self._ctl_closed:
                    return
                if time_mod.monotonic() - self._last_send < period:
                    continue
                try:
                    self._send("noop", {})
                except Exception as e:
                    self._stop_mesh(f"noop: sending failed: {e!r}")
                    return

    def _follow_loop(self) -> None:
        import torch.distributed as dist

        try:
            while True:
                box: List[Any] = [None]
                dist.broadcast_object_list(box, src=0, group=self._ctl)
                op, kw = box[0]
                if op == "stop":
                    return
                if op == "noop":
                    continue
                self.follower_ops += 1
                err: Optional[Exception] = None
                self._op_check = None
                try:
                    getattr(self, f"_op_{op}")(**kw)
                except Exception as e:
                    err = e
                broken = self._agree(op, err, self._op_check)
                if broken is not None:
                    self.follower_error = RuntimeError(f"mesh serving stopped: {broken}")
                    self.follower_error.__cause__ = err
                    return
                if err is not None:  # rank 0 raised it too and reports it
                    self.logger.log(f"follower: {op} raised {err!r} on every rank")
        except BaseException as e:  # rank 0 lost: the control group timed out
            self.follower_error = e

    def follow(self) -> None:
        """A follower rank: run rank 0's device programs until its
        ``stop``; raises if rank 0 was lost (within the control group's
        timeout) or the mesh stopped serving (a program ended on some rank
        unlike on the others)."""
        if self.is_leader:
            raise RuntimeError("rank 0 serves; only the other ranks follow")
        if self._follower is None:
            self.setup()
        self._follower.join()
        if self.follower_error is not None:
            raise self.follower_error

    @property
    def address(self) -> str:
        return self.transport.address

    def set_params(self, state_dict: Dict[str, Any]) -> None:
        """Swap serving weights; live requests continue on the new weights
        from their next chunk (the KV cache is config-shaped only). Under
        ``draft_model="self"`` the draft is the target, so it follows."""
        with self._device_lock:
            self._mirror("load", state_dict=state_dict)

    def _op_load(self, state_dict: Dict[str, Any]) -> None:
        if self.mesh is not None:  # the full tensors: each rank keeps its blocks
            state_dict = shard_state(
                self.model, {n: torch.as_tensor(v) for n, v in state_dict.items()})
        self.model.load_state_dict(state_dict, strict=True)

    def _window_s(self) -> float:
        w = self.serving.batch_window_s
        return BATCH_WINDOW_S if w is None else w

    def _prompt_cap(self) -> int:
        cap = self.serving.max_prompt_batch
        return MAX_PROMPT_BATCH if cap is None else cap

    # -- handlers (run in the transport's executor; return value = ack) ----

    def _on_info(self, client_id: str, payload: Any) -> Dict[str, Any]:
        cfg = self.config
        return {
            "name": "transformer_lm",
            "vocab_size": cfg.vocab_size,
            "max_seq": cfg.max_seq,
            "d_model": cfg.d_model,
            "n_layers": cfg.n_layers,
            "n_heads": cfg.n_heads,
        }

    def _on_client_disconnect(self, client_id: str) -> None:
        """Cancel the departed client's work: queued requests are skipped at
        admission, live slots retire at the next chunk boundary."""
        with self._inflight_lock:
            for req in self._inflight.get(client_id, ()):
                req.cancelled = True
        self.fleet.disconnect(client_id)

    def begin_drain(self) -> None:
        """Refuse NEW generates with ``{"refused": "draining"}`` while
        in-flight work completes."""
        self._draining = True
        self.logger.log("draining: refusing new generates")

    def end_drain(self) -> None:
        self._draining = False

    @property
    def draining(self) -> bool:
        return self._draining

    def _on_drain(self, client_id: str, payload: Any) -> Dict[str, Any]:
        if bool((payload or {}).get("enable", True)):
            self.begin_drain()
        else:
            self.end_drain()
        return {"draining": self._draining}

    # dfcheck: payload -> fleet_stats
    def _on_fleet_stats(self, client_id: str, payload: Any) -> Dict[str, Any]:
        """Routing signals for the fleet router (advisory snapshots).
        ``evicted_prefixes`` is a drain: each evicted hash ships once."""
        evicted: List[str] = []
        while True:
            try:
                evicted.append(self._evicted_prefixes.popleft().hex())
            except IndexError:
                break
        try:
            counts = list(self._prefix_hit_counts.items())
        except RuntimeError:  # resized mid-iteration by the scheduler
            counts = []
        counts.sort(key=lambda kv: -kv[1])
        warm = [[h.hex(), int(n)] for h, n in counts[:256]]
        paged = self._paged
        return {
            "queue_depth": self._queue.qsize() + len(self._backlog),
            "slots_active": sum(1 for r in self._slot_req if r is not None),
            "max_slots": self.serving.max_slots,
            "draining": self._draining,
            "page_size": self.serving.page_size,
            "prefix_sharing": bool(paged and self.serving.prefix_sharing),
            "page_occupancy": (self._pool.used_pages / self._n_pages) if paged else 0.0,
            "free_pages": self._pool.free_pages if paged else -1,
            "prefix_hits": self.prefix_hits,
            "speculate_k": self._spec_k,
            "spec_accept_per_step": self.spec_accept_per_step,
            "evicted_prefixes": evicted,
            "warm_prefixes": warm,
            "prefix_entries": len(self._prefix_map),
        }

    # dfcheck: payload payload=hedge_cancel -> hedge_cancel_ack
    def _on_hedge_cancel(self, client_id: str, payload: Dict[str, Any]) -> Dict[str, Any]:
        """Cancel every in-flight admission carrying this request_id (the
        losing attempt of a hedged request)."""
        rid = str(payload.get("request_id"))
        cancelled = 0
        with self._inflight_lock:
            for reqs in self._inflight.values():
                for req in reqs:
                    if req.request_id == rid and not req.cancelled:
                        req.cancelled = True
                        cancelled += 1
        if cancelled:
            self._m_hedge_cancelled.inc(cancelled)
        return {"request_id": rid, "cancelled": cancelled}

    # dfcheck: payload payload=generate_request -> generate_ack
    def _on_generate(self, client_id: str, payload: Dict[str, Any]) -> Dict[str, Any]:
        """Drain refusal + request-id idempotency around :meth:`_generate_ack`."""
        rid = payload.get("request_id")
        if rid is None:
            if self._draining:
                return {"refused": "draining"}
            return self._generate_ack(client_id, payload)
        rid = str(rid)
        with self._dedup_lock:
            cached = self._req_results.get(rid)
            if cached is not None:
                self._req_results.move_to_end(rid)
                self._m_dedup_hits.inc()
                return cached
            gate = self._req_live.get(rid)
            if gate is None and not self._draining:
                self._req_live[rid] = threading.Event()
        if gate is not None:
            # duplicate of an in-flight request: ride the original
            self._m_dedup_hits.inc()
            gate.wait(timeout=600.0)
            with self._dedup_lock:
                cached = self._req_results.get(rid)
            if cached is not None:
                return cached
            # the original errored: compute fresh (deterministic decode)
        if self._draining:
            return {"refused": "draining"}
        try:
            ack = self._generate_ack(client_id, payload)
            with self._dedup_lock:
                self._req_results[rid] = ack
                while len(self._req_results) > self._dedup_cap:
                    self._req_results.popitem(last=False)
            return ack
        finally:
            with self._dedup_lock:
                evt = self._req_live.pop(rid, None)
            if evt is not None:
                evt.set()

    # dfcheck: payload payload=generate_request -> generate_ack
    def _generate_ack(self, client_id: str, payload: Dict[str, Any]) -> Dict[str, Any]:
        prompt = _prompt_from(payload, self._prompt_cap())
        n_tokens = int(payload["n_tokens"])
        temperature = float(payload.get("temperature", 0.0))
        top_k = payload.get("top_k")
        top_p = payload.get("top_p")
        eos_id = payload.get("eos_id")
        seed = int(payload.get("seed", 0))
        rows = prompt.shape[0]
        use_engine = (
            self._dispatcher is not None
            and n_tokens >= 1
            and rows <= self.serving.max_slots
            and (temperature == 0.0 or rows == 1)
        )
        if use_engine:
            # validate like generate() before enqueueing
            _check_fits(prompt.shape[1], n_tokens, self.config)
            if top_k is not None and int(top_k) < 1:
                raise ValueError(f"top_k must be >= 1, got {top_k}")
            if top_p is not None and not 0.0 < float(top_p) <= 1.0:
                raise ValueError(f"top_p must be in (0, 1], got {top_p}")
            if eos_id is not None and not 0 <= int(eos_id) < self.config.vocab_size:
                raise ValueError(
                    f"eos_id {eos_id} outside vocab [0, {self.config.vocab_size})")
            item = _Request(
                prompt, n_tokens, temperature,
                int(top_k) if top_k is not None else 0,
                float(top_p) if top_p is not None else 1.0,
                int(eos_id) if eos_id is not None else -1,
                seed, client_id,
            )
            item.trace_id = str(payload.get("trace_id") or "")
            item.parent_span = str(payload.get("span_id") or "")
            rid = payload.get("request_id")
            item.request_id = str(rid) if rid is not None else None
            item.tier = min(max(int(payload.get("tier", 0) or 0), 0), 2)
            with self._inflight_lock:
                self._inflight.setdefault(client_id, []).append(item)
            self._queue.put(item)
            # re-check after enqueueing: stop() may have drained already
            if self._stopped.is_set() and not item.done.is_set():
                item.error = RuntimeError("inference server stopped")
                item.done.set()
            if not item.done.wait(timeout=600.0):
                self._unregister(item)
                raise RuntimeError("batched generate timed out awaiting the scheduler")
            self._unregister(item)
            if item.result is None and item.error is not None:
                raise item.error
            out = item.result
            meta = {"path": "slots"}  # dfcheck: payload serving_meta
            if item.admit_t is not None:
                meta["queue_ms"] = round((item.admit_t - item.enq_t) * 1000.0, 3)
            if item.page_plan is not None:
                saved = sum(len(p["shared"]) for p in item.page_plan)
                if saved:
                    meta["prefix_tokens"] = saved * self.serving.page_size
            if item.ttft_ms is not None:
                meta["ttft_ms"] = item.ttft_ms
            if item.tpot_ms is not None:
                meta["tpot_ms"] = item.tpot_ms
        else:
            with self._device_lock, self.logger.time(
                f"generate[{prompt.shape[0]}x{prompt.shape[1]}+{n_tokens}]"
            ):
                out = self._mirror(
                    "generate", prompt=prompt, n_tokens=n_tokens, temperature=temperature,
                    seed=seed, top_k=int(top_k) if top_k is not None else None,
                    top_p=float(top_p) if top_p is not None else None,
                    eos_id=int(eos_id) if eos_id is not None else None)
            meta = {"path": "direct"}  # dfcheck: payload serving_meta
        ack = {"result": pack_bytes({"tokens": serialize_array(out)}), "serving": meta}
        tid = payload.get("trace_id")
        if tid:
            ack["trace_id"] = tid
        return ack

    # dfcheck: payload payload=beam_request -> direct_ack
    def _on_beam(self, client_id: str, payload: Dict[str, Any]) -> Dict[str, Any]:
        prompt = _prompt_from(payload, self._prompt_cap())
        n_tokens = int(payload["n_tokens"])
        # .get with a default, not `or`: an explicit beam_size=0 must reach
        # beam_search's validation, not silently become the default
        beam_size = int(payload.get("beam_size", 4))
        length_penalty = float(payload.get("length_penalty", 0.0))
        eos_id = payload.get("eos_id")
        with self._device_lock, self.logger.time(
            f"beam[{prompt.shape[0]}x{prompt.shape[1]}+{n_tokens} k={beam_size}]"
        ):
            out, scores = self._mirror(
                "beam", prompt=prompt, n_tokens=n_tokens, beam_size=beam_size,
                length_penalty=length_penalty, eos_id=int(eos_id) if eos_id is not None else None)
            result = {"tokens": serialize_array(out), "scores": serialize_array(scores)}
        return self._direct_ack(payload, result)

    # dfcheck: payload payload=score_request -> direct_ack
    def _on_score(self, client_id: str, payload: Dict[str, Any]) -> Dict[str, Any]:
        tokens = _prompt_from(payload, self._prompt_cap())
        from_pos = int(payload.get("from_pos", 1))
        with self._device_lock, self.logger.time(
            f"score[{tokens.shape[0]}x{tokens.shape[1]} from={from_pos}]"
        ):
            scores = self._mirror("score", tokens=tokens, from_pos=from_pos)
        return self._direct_ack(payload, {"scores": serialize_array(scores)})

    # the direct paths' device programs (every rank of a mesh runs them)

    def _op_generate(self, prompt: np.ndarray, n_tokens: int, **kw: Any) -> np.ndarray:
        return generate(self.model, prompt, n_tokens, **kw).cpu().numpy()

    def _op_beam(self, prompt: np.ndarray, n_tokens: int, **kw: Any
                 ) -> Tuple[np.ndarray, np.ndarray]:
        out, scores = beam_search(self.model, prompt, n_tokens, **kw)
        return out.cpu().numpy(), scores.cpu().numpy()

    def _op_score(self, tokens: np.ndarray, from_pos: int) -> np.ndarray:
        return sequence_logprob(self.model, tokens, from_pos).cpu().numpy()

    @staticmethod
    def _direct_ack(payload: Dict[str, Any], result: Dict[str, Any]) -> Dict[str, Any]:
        ack = {"result": pack_bytes(result)}
        tid = payload.get("trace_id")
        if tid:
            ack["trace_id"] = tid
        return ack

    # -- continuous-batching engine ----------------------------------------

    def _engine_loop(self) -> None:
        """Pull requests into the backlog, admit into free slots, advance
        every live row one ``decode_chunk``, retire. On shutdown every
        waiter is errored."""
        while True:
            try:
                if self._gather():
                    self._shutdown_engine()
                    return
                self._admit()
                if any(r is not None for r in self._slot_req):
                    self._decode_iteration()
            except Exception as e:  # device failure: fail loud, stay up
                self.logger.log(f"engine error: {e!r}")
                self._abort_all(e)

    def _gather(self) -> bool:
        """Queue -> backlog. Returns True on the shutdown sentinel."""
        idle = not self._backlog and all(r is None for r in self._slot_req)
        if idle:
            self.verify_pool_conservation("engine idle")
            item = self._queue.get()
            if item is None:
                return True
            self._backlog.append(item)
            deadline = time_mod.monotonic() + self._window_s()
            while True:
                remaining = deadline - time_mod.monotonic()
                if remaining <= 0:
                    return False
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue_mod.Empty:
                    return False
                if nxt is None:
                    return True
                self._backlog.append(nxt)
        while True:
            try:
                nxt = self._queue.get_nowait()
            except queue_mod.Empty:
                return False
            if nxt is None:
                return True
            self._backlog.append(nxt)

    # -- paged-layout bookkeeping (scheduler thread only) ------------------

    def _pages_needed(self, plen: int, n_tokens: int) -> int:
        """Pages one row holds over its full horizon, reserved up front:
        prompt plus generated tokens rounded up to the chunk boundary (a
        row frozen at eos keeps appending until retirement). Under
        speculation a verify pass writes the whole ``[tok, d_1..d_k]``
        window, up to ``speculate_k + 1`` positions past the committed
        horizon; positions past ``pages_per_slot * page_size`` drop through
        the sentinel and need no page (the ``min``)."""
        chunk = self.serving.decode_chunk
        written = plen
        if self._spec_k:
            written += (n_tokens - 1) + self._spec_k + 1
        elif n_tokens > 1:
            written += -(-(n_tokens - 1) // chunk) * chunk
        ps = self.serving.page_size
        return min(-(-written // ps), self._pp)

    def _row_plan(self, tokens: np.ndarray) -> Tuple[List[int], List[bytes]]:
        """(shared leading pages, per-page chain hashes) for one prompt row."""
        shared: List[int] = []
        if not self.serving.prefix_sharing:
            return shared, []
        hashes = page_hashes(tokens, self.serving.page_size)
        for hj in hashes:
            pg = self._prefix_map.get(hj)
            if pg is None:
                break
            shared.append(pg)
            self._prefix_map.move_to_end(hj)
        return shared, hashes

    def _evict_prefix(self, shortfall: int) -> None:
        """Drop cold prefix-map entries until ``shortfall`` pages came free
        or the map is empty."""
        while shortfall > 0 and self._prefix_map:
            _h, pg = self._prefix_map.popitem(last=False)
            self._evicted_prefixes.append(_h)
            self._prefix_hit_counts.pop(_h, None)
            shortfall -= self._pool.unref([pg])

    # dfcheck: pairs acquire=_reserve release=_release_plan|_retire_slot counter=_m_pages_freed mode=state
    def _reserve(self, req: _Request) -> bool:
        """The paged admission gate: plan every row's pages (prefix hits
        first, owned pages for the rest of the horizon) and commit the
        reservation. False = not enough free pages even after eviction."""
        plen = req.prompt.shape[1]
        need = self._pages_needed(plen, req.n_tokens)
        # the draft's pages hold the draft model's KV, which target prefix
        # hashes say nothing about: every draft page is owned, full horizon
        dneed = need if self._spec_k else 0
        plans: List[Dict[str, Any]] = []
        for row in range(req.prompt.shape[0]):
            shared, hashes = self._row_plan(req.prompt[row])
            plans.append({"shared": shared, "hashes": hashes,
                          "owned": None, "draft": [], "committed": False})
        # ref shared pages FIRST so eviction below can never free them
        for plan in plans:
            self._pool.ref(plan["shared"])
        total_owned = sum(need + dneed - len(p["shared"]) for p in plans)
        if total_owned > self._pool.free_pages:
            self._evict_prefix(total_owned - self._pool.free_pages)
        if total_owned > self._pool.free_pages:
            for plan in plans:
                self._pool.unref(plan["shared"])
            return False
        for plan in plans:
            plan["owned"] = self._pool.alloc(need - len(plan["shared"]))
            plan["draft"] = self._pool.alloc(dneed)
            if plan["shared"]:
                self.prefix_hits += 1
                self._m_prefix_hits.inc()
                self._m_prefix_tokens.inc(len(plan["shared"]) * self.serving.page_size)
                for hj in plan["hashes"][:len(plan["shared"])]:
                    self._prefix_hit_counts[hj] = self._prefix_hit_counts.get(hj, 0) + 1
            self._m_pages_alloc.inc(
                len(plan["shared"]) + len(plan["owned"]) + len(plan["draft"]))
        req.page_plan = plans
        return True

    def _release_plan(self, plan: Optional[Dict[str, Any]]) -> None:
        """Return an uncommitted row reservation to the pool."""
        if plan is None or plan["committed"]:
            return
        pages = plan["shared"] + (plan["owned"] or []) + plan["draft"]
        self._pool.unref(pages)
        self._m_pages_freed.inc(len(pages))
        plan["committed"] = True  # never release twice

    def _register_prefix(self, plan: Dict[str, Any]) -> None:
        """Publish an admitted row's full prompt pages into the prefix map
        (each new entry takes its own pool reference)."""
        pages = plan["shared"] + plan["owned"]
        for j, hj in enumerate(plan["hashes"]):
            if hj not in self._prefix_map:
                self._pool.ref([pages[j]])
                self._prefix_map[hj] = pages[j]
            else:
                self._prefix_map.move_to_end(hj)

    def _note_occupancy(self) -> None:
        if self._pool is not None:
            self._m_pages.set(self._pool.used_pages / self._n_pages)

    def _note_client_pages(self, client_id: str) -> None:
        held = sum(len(self._slot_pages[s]) + len(self._draft_pages[s])
                   for s, r in enumerate(self._slot_req)
                   if r is not None and r.client_id == client_id)
        self.fleet.note_pages(client_id, held)

    def _req_span(self, req: _Request, name: str, mono0: float,
                  dur_ms: float, **attrs: Any) -> None:
        """One per-request engine span; a no-op for untraced requests."""
        if not req.trace_id or not self._tel.tracer.enabled:
            return
        start = time_mod.time() - (time_mod.monotonic() - mono0)
        self._tel.tracer.emit(
            name, trace_id=req.trace_id, parent_id=req.parent_span,
            dur_ms=dur_ms, start=start, mono=mono0,
            request_id=req.request_id, tier=req.tier, **attrs)

    def _ensure_cache(self) -> None:
        if self._slot_cache is not None:
            return
        with self._device_lock:
            self._mirror("ensure_cache")

    def _op_ensure_cache(self) -> None:
        """The engine's caches, of this rank's heads."""
        srv, dev, heads = self.serving, self.model.device, self.model.local_heads
        if self._paged:
            self._slot_cache = paged_cache(
                self.config, srv.max_slots, srv.page_size, self._n_pages, dev, heads)
            if self._spec_k:
                # the draft's own K/V arrays (other dims; a self-draft on a
                # mesh holds the target's local heads), the same page ids
                self._draft_cache = paged_cache(
                    self.draft_model.config, srv.max_slots, srv.page_size, self._n_pages,
                    dev, self.draft_model.local_heads)
        else:
            self._slot_cache = slot_cache(self.config, srv.max_slots, dev, heads)

    def _admit(self) -> None:
        """Move backlog requests into free slots (strict FIFO), prefill
        grouped by (prompt length, shared-prefix depth), insert, emit first
        tokens, retire rows already finished. Under the paged layout a
        request enters only when its full-horizon pages fit the pool."""
        admit: List[_Request] = []
        free = sum(1 for r in self._slot_req if r is None)
        while self._backlog:
            head = self._backlog[0]
            if head.cancelled:
                self._backlog.popleft()
                self._finish_error(head, RuntimeError("client disconnected"))
                continue
            if head.prompt.shape[0] > free:
                break
            if self._paged and not self._reserve(head):
                break
            free -= head.prompt.shape[0]
            admit.append(self._backlog.popleft())
        if not admit:
            return
        with self._prof.phase("admission"):
            self._ensure_cache()
            now = time_mod.monotonic()
            groups: Dict[Tuple[int, int], List[Tuple[_Request, int]]] = {}
            ps = self.serving.page_size
            for req in admit:
                req.admit_t = now
                self._m_qwait.observe((now - req.enq_t) * 1000.0)
                self._req_span(req, "queue_wait", req.enq_t, (now - req.enq_t) * 1000.0)
                for row in range(req.prompt.shape[0]):
                    shared_len = 0
                    if self._paged and req.page_plan is not None:
                        shared_len = len(req.page_plan[row]["shared"]) * ps
                    groups.setdefault((req.prompt.shape[1], shared_len), []).append((req, row))
            for (plen, shared_len), members in sorted(groups.items()):
                try:
                    self._admit_group(plen, shared_len, members)
                except Exception as e:
                    # contain a failed prefill to its own group: claimed
                    # slots stay unrecorded (free); uncommitted pages go back
                    # and unclaimed table rows re-sentinel
                    if self._paged:
                        for req, row in members:
                            if req.page_plan is not None:
                                self._release_plan(req.page_plan[row])
                        for s, r in enumerate(self._slot_req):
                            if r is None:
                                self._tables[s, :] = self._n_pages
                                self._draft_tables[s, :] = self._n_pages
                        self._tables_dirty = True
                        self._draft_tables_dirty = bool(self._spec_k)
                    for req in {id(r): r for r, _ in members}.values():
                        self._finish_error(req, e)
            self.batched_requests += len(admit)
            self._m_admitted.inc(len(admit))
            self._m_slots.set(sum(1 for r in self._slot_req if r is not None))
            self._note_occupancy()

    def _admit_group(self, plen: int, shared_len: int,
                     members: List[Tuple[_Request, int]]) -> None:
        """Prefill + insert + first token for the rows of one prompt length
        and shared-prefix depth. Rows with ``shared_len > 0`` skip the
        shared prefix: their tables point at the shared pages, which are
        gathered into dense row caches so ``extend`` runs just the suffix.

        Groups run at their exact size: the JAX engine padded slab groups
        to power-of-two buckets (dropped slot ids) only to bound XLA
        recompiles, which eager PyTorch does not have."""
        n = len(members)
        stacked = np.stack([req.prompt[row] for req, row in members])
        free_ids = [i for i, r in enumerate(self._slot_req) if r is None]
        slots = np.array(free_ids[:n], np.int32)
        temps = np.array([req.temperature for req, _ in members], np.float32)
        top_ks = np.array([req.top_k for req, _ in members], np.int32)
        top_ps = np.array([req.top_p for req, _ in members], np.float32)
        seeds = np.array([req.seed & 0x7FFFFFFF for req, _ in members], np.int64)
        eos = np.array([req.eos for req, _ in members], np.int32)
        if self._paged:
            for j, (req, row) in enumerate(members):
                plan = req.page_plan[row]
                pages = plan["shared"] + plan["owned"]
                s = int(slots[j])
                self._tables[s, :] = self._n_pages
                self._tables[s, :len(pages)] = pages
                if self._spec_k:
                    dpages = plan["draft"]
                    self._draft_tables[s, :] = self._n_pages
                    self._draft_tables[s, :len(dpages)] = dpages
        pf0 = time_mod.monotonic()
        with self._prof.phase("prefill"), self._device_lock, self.logger.time(
            f"admit[{n}x{plen}]"
        ):
            first = self._mirror(
                "prefill", stacked=stacked, slots=slots, plen=plen, shared_len=shared_len,
                tables=self._tables.copy() if self._paged else None, temps=temps,
                top_ks=top_ks, top_ps=top_ps, seeds=seeds)
            self._tables_dirty = self._tables_dirty and not self._paged
        pf1 = time_mod.monotonic()  # first tokens are on the host now
        if self._spec_k:
            with self._prof.phase("spec_draft"), self._device_lock:
                self._mirror("draft_prefill", stacked=stacked, slots=slots, plen=plen,
                             tables=self._draft_tables.copy())
                self._draft_tables_dirty = False
        for j, (req, row) in enumerate(members):
            s = int(slots[j])
            self._slot_req[s] = req
            self._slot_row[s] = row
            self._slot_emitted[s] = 1
            self._slot_emit_t[s] = pf1
            if req.first_tok_t is None:
                req.first_tok_t = pf1
                req.ttft_ms = round((pf1 - req.enq_t) * 1000.0, 3)
                self._m_ttft[req.tier].observe(req.ttft_ms)
                if req.ttft_ms > self._ttft_peak[req.tier]:
                    self._ttft_peak[req.tier] = req.ttft_ms
                    self._tel.flight.record(
                        "ttft_high", request_id=req.request_id,
                        trace_id=req.trace_id, tier=req.tier, ttft_ms=req.ttft_ms)
                self._req_span(req, "admission", req.admit_t, (pf0 - req.admit_t) * 1000.0)
            self._req_span(req, "prefill", pf0, (pf1 - pf0) * 1000.0,
                           slot=s, row=row, plen=plen, shared=shared_len)
            if self._paged:
                plan = req.page_plan[row]
                plan["committed"] = True
                self._slot_pages[s] = plan["shared"] + plan["owned"]
                self._draft_pages[s] = plan["draft"]
                self._register_prefix(plan)
                self._note_client_pages(req.client_id)
            self._tok[s] = first[j]
            self._temps[s] = temps[j]
            self._top_ks[s] = top_ks[j]
            self._top_ps[s] = top_ps[j]
            self._seeds[s] = seeds[j]
            self._eos[s] = eos[j]
            hit_eos = req.eos >= 0 and int(first[j]) == req.eos
            self._done[s] = hit_eos
            self._m_tokens.inc()
            out = np.asarray([first[j]], np.int32)
            if hit_eos and req.n_tokens > 1:
                # instant eos: the rest of the budget is frozen repeats
                out = np.concatenate([out, np.full((req.n_tokens - 1,), req.eos, np.int32)])
            req.rows_out[row] = out
            if req.n_tokens == 1 or hit_eos:
                self._complete_row(s)

    def _op_prefill(self, stacked: np.ndarray, slots: np.ndarray, plen: int, shared_len: int,
                    tables: Optional[np.ndarray], temps, top_ks, top_ps, seeds) -> np.ndarray:
        """An admission group's device program: prefill (or extend past a
        shared prefix), insert into the engine cache, pick the first
        tokens. ``tables`` (paged) is the full host table, so pending
        sentinel edits of retired slots are installed too."""
        pc = self.serving.prefill_chunk
        if shared_len > 0:
            row_cache = gather_rows(self._slot_cache, tables[slots], shared_len)
            logits = None
            for i in range(shared_len, plen, pc or plen):
                logits, row_cache = extend(self.model, row_cache,
                                           stacked[:, i:i + (pc or plen)])
        elif pc is None or pc >= plen:
            logits, row_cache = prefill(self.model, stacked)
            self.prefills += 1
        else:
            logits, row_cache = prefill(self.model, stacked[:, :pc])
            self.prefills += 1
            for i in range(pc, plen, pc):
                logits, row_cache = extend(self.model, row_cache, stacked[:, i:i + pc])
        if tables is not None:
            paged_insert(self._slot_cache, row_cache, slots, plen, shared_len, tables)
        else:
            slot_insert(self._slot_cache, row_cache, slots, plen)
        return pick_rows(logits, temps, top_ks, top_ps, seeds,
                         np.full((len(slots),), plen, np.int64)).cpu().numpy()

    def _op_draft_prefill(self, stacked: np.ndarray, slots: np.ndarray, plen: int,
                          tables: np.ndarray) -> None:
        """An admission group's draft program: the draft prefills the full
        prompts (the target's shared prefix pages hold target KV, nothing
        the draft can reuse) and inserts them into the draft cache through
        ``tables``, the host's full draft table."""
        dmodel, pc = self.draft_model, self.serving.prefill_chunk
        if pc is None or pc >= plen:
            _, d_row = prefill(dmodel, stacked)
        else:
            _, d_row = prefill(dmodel, stacked[:, :pc])
            for i in range(pc, plen, pc):
                _, d_row = extend(dmodel, d_row, stacked[:, i:i + pc])
        paged_insert(self._draft_cache, d_row, slots, plen, 0, tables)

    def _op_decode(self, tables: Optional[np.ndarray], tok, done, temps, top_ks, top_ps,
                   seeds, eos, chunk: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """An engine iteration's device program (``tables``: the host page
        table when it changed since the last install)."""
        if tables is not None:
            set_page_tables(self._slot_cache, tables)
        cache, tok, done, toks = decode_chunk(self.model, self._slot_cache, tok, done, temps,
                                              top_ks, top_ps, seeds, eos, chunk)
        self._slot_cache = cache
        return tok, done, toks

    def _decode_iteration(self) -> None:
        """Advance every live slot ``decode_chunk`` tokens, then retire
        finished and cancelled rows."""
        srv = self.serving
        active = [i for i, r in enumerate(self._slot_req) if r is not None]
        for s in active:  # cancelled rows retire before the dispatch
            req = self._slot_req[s]
            if req.cancelled:
                self._retire_slot(s)
                self._finish_error(req, RuntimeError("client disconnected"))
        active = [i for i, r in enumerate(self._slot_req) if r is not None]
        if not active:
            self._m_slots.set(0)
            return
        if self._spec_k:
            self._spec_round(active)
            return
        with self._prof.phase("decode_iter"):
            t0 = time_mod.monotonic()
            with self._device_lock:
                # retired slots re-sentineled their rows on the host:
                # install before the dispatch so frozen rows' appends drop
                tables = self._tables.copy() if self._paged and self._tables_dirty else None
                self._tables_dirty = self._tables_dirty and tables is None
                tok, done, toks = self._mirror(
                    "decode", tables=tables, tok=self._tok, done=self._done,
                    temps=self._temps, top_ks=self._top_ks, top_ps=self._top_ps,
                    seeds=self._seeds, eos=self._eos, chunk=srv.decode_chunk)
            t1 = time_mod.monotonic()
            elapsed_ms = (t1 - t0) * 1000.0
            self.decode_batches += 1
            self._m_batches.inc()
            self._tok = tok
            self._done = done
            emitted_now = 0
            for s in active:
                req = self._slot_req[s]
                row = int(self._slot_row[s])
                have = int(self._slot_emitted[s])
                take = min(srv.decode_chunk, req.n_tokens - have)
                chunk_toks = toks[s, :take].astype(np.int32)
                emitted_now += take
                self._slot_emitted[s] = have + take
                if take > 0:
                    self._m_tpot[req.tier].observe(
                        (t1 - self._slot_emit_t[s]) * 1000.0 / take)
                self._slot_emit_t[s] = t1
                self._req_span(req, "decode_iter", t0, elapsed_ms,
                               slot=s, n_active=len(active), take=take,
                               share=round(elapsed_ms / len(active), 3))
                req.rows_out[row] = np.concatenate([req.rows_out[row], chunk_toks])
                if done[s]:
                    # froze to eos in the loop: pad the rest of the budget
                    pad = req.n_tokens - have - take
                    if pad:
                        req.rows_out[row] = np.concatenate(
                            [req.rows_out[row], np.full((pad,), req.eos, np.int32)])
                    self._complete_row(s)
                elif have + take >= req.n_tokens:
                    self._complete_row(s)
            self._m_tokens.inc(emitted_now)
            self._m_slots.set(sum(1 for r in self._slot_req if r is not None))

    def _spec_round(self, active: List[int]) -> None:
        """One speculative round over every live slot: draft k tokens,
        verify all k + 1 positions in one target pass, commit the accepted
        prefix (JAX ``_spec_round``; the device programs are one
        ``spec_round``, :meth:`_op_spec_round`). A round yields 1 to k + 1
        tokens a row; the host clips to the row's budget and retires rows
        as the chunk path does."""
        k = self._spec_k
        with self._device_lock:
            tables = self._tables.copy() if self._tables_dirty else None
            draft_tables = self._draft_tables.copy() if self._draft_tables_dirty else None
            self._tables_dirty = self._draft_tables_dirty = False
            emit, n_emit, n_acc, new_tok, new_done, (t0, td, tv, tc) = self._mirror(
                "spec_round", tables=tables, draft_tables=draft_tables, tok=self._tok,
                temps=self._temps, top_ks=self._top_ks, top_ps=self._top_ps,
                seeds=self._seeds, done=self._done, eos=self._eos, k=k)
        self.decode_batches += 1
        self._m_batches.inc()
        self._tok = new_tok
        self._done = new_done
        emitted_now = 0
        accepted_now = 0
        for s in active:
            req = self._slot_req[s]
            row = int(self._slot_row[s])
            have = int(self._slot_emitted[s])
            take = min(int(n_emit[s]), req.n_tokens - have)
            emitted_now += take
            accepted_now += int(n_acc[s])
            self._slot_emitted[s] = have + take
            # per-slot TPOT: the interval normalized by what this slot took
            if take > 0:
                self._m_tpot[req.tier].observe((tc - self._slot_emit_t[s]) * 1000.0 / take)
                self._slot_emit_t[s] = tc
            self._req_span(req, "spec_draft", t0, (td - t0) * 1000.0, slot=s)
            self._req_span(req, "spec_verify", td, (tv - td) * 1000.0, slot=s)
            self._req_span(req, "spec_commit", tv, (tc - tv) * 1000.0,
                           slot=s, accepted=int(n_acc[s]), take=take)
            req.rows_out[row] = np.concatenate([req.rows_out[row], emit[s, :take].astype(np.int32)])
            if new_done[s]:
                pad = req.n_tokens - have - take
                if pad:
                    req.rows_out[row] = np.concatenate(
                        [req.rows_out[row], np.full((pad,), req.eos, np.int32)])
                self._complete_row(s)
            elif have + take >= req.n_tokens:
                self._complete_row(s)
        self._m_tokens.inc(emitted_now)
        self._m_spec_proposed.inc(k * len(active))
        self._m_spec_accepted.inc(accepted_now)
        self.spec_accept_per_step = accepted_now / len(active)
        self._m_spec_rate.set(self.spec_accept_per_step)
        self._m_slots.set(sum(1 for r in self._slot_req if r is not None))

    def _draft(self, tok, temps, top_ks, top_ps, seeds, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The draft's k steps from the draft cache (``draft_k``):
        ``(drafts [B, k], proposal distributions)``."""
        self._draft_cache, drafts, qprobs = draft_k(
            self.draft_model, self._draft_cache, tok, temps, top_ks, top_ps, seeds, k)
        return drafts, qprobs

    def _op_spec_round(self, tables: Optional[np.ndarray], draft_tables: Optional[np.ndarray],
                       tok, temps, top_ks, top_ps, seeds, done, eos, k: int):
        """A speculative round's device programs: the table installs
        (``tables``/``draft_tables``: the host's, where they changed), the
        draft's k steps, the target's verify and the draft's commit. Each
        of the three is waited for before its phase closes, so
        ``spec_draft``/``spec_verify``/``spec_commit`` attribute wall time
        honestly. Returns the verify's host results and the round's clock
        ``(t0, draft done, verify done, commit done)``. On a mesh its check
        is a digest of the drafts and proposal sums the verify consumed,
        which every rank computes for itself (see the module docstring)."""
        if tables is not None:
            set_page_tables(self._slot_cache, tables)
        if draft_tables is not None:
            set_page_tables(self._draft_cache, draft_tables)
        t0 = time_mod.monotonic()
        with self._prof.phase("spec_draft"):
            drafts, qprobs = self._draft(tok, temps, top_ks, top_ps, seeds, k)
            _ready(drafts)
            if self._spmd:
                digest = hashlib.sha1(drafts.cpu().numpy().tobytes())
                digest.update(qprobs.float().sum(dim=(1, 2)).cpu().numpy().tobytes())
                self._op_check = f"drafted {digest.hexdigest()[:16]}"
        td = time_mod.monotonic()
        with self._prof.phase("spec_verify"):
            (self._slot_cache, emit, n_emit, n_acc, new_tok, new_done, catch,
             new_idx) = verify(self.model, self._slot_cache, tok, drafts, qprobs, temps,
                               top_ks, top_ps, seeds, done, eos, k)
            host = tuple(t.cpu().numpy() for t in (emit, n_emit, n_acc, new_tok, new_done))
        tv = time_mod.monotonic()
        with self._prof.phase("spec_commit"):
            self._draft_cache = commit(self.draft_model, self._draft_cache, drafts[:, -1],
                                       catch, new_idx)
            _ready(self._draft_cache.index)
        return (*host, (t0, td, tv, time_mod.monotonic()))

    def _complete_row(self, s: int) -> None:
        """Retire one finished slot and resolve its request once every row
        is in."""
        req = self._slot_req[s]
        self._retire_slot(s)
        req.rows_left -= 1
        if req.rows_left == 0 and not req.done.is_set():
            req.result = np.concatenate([req.prompt, np.stack(req.rows_out)], axis=1)
            now = time_mod.monotonic()
            if req.first_tok_t is not None:
                req.tpot_ms = round((now - req.first_tok_t) * 1000.0
                                    / max(req.n_tokens - 1, 1), 3)
                if req.tpot_ms > self._tpot_peak[req.tier]:
                    self._tpot_peak[req.tier] = req.tpot_ms
                    self._tel.flight.record(
                        "tpot_high", request_id=req.request_id,
                        trace_id=req.trace_id, tier=req.tier, tpot_ms=req.tpot_ms)
            self._req_span(req, "retire", now, 0.0, outcome="complete",
                           emitted=int(req.n_tokens),
                           ttft_ms=req.ttft_ms, tpot_ms=req.tpot_ms)
            self._unregister(req)
            req.done.set()

    def _retire_slot(self, s: int) -> None:
        """Park a slot frozen (done, no eos). Under the paged layout its
        pages go back to the pool now and its table row re-sentinels, so
        the frozen row's writes land nowhere (installed at the next
        dispatch)."""
        with self._prof.phase("retire"):
            req = self._slot_req[s]
            self._slot_req[s] = None
            self._done[s] = True
            self._temps[s] = 0.0
            self._eos[s] = -1
            if self._paged and (self._slot_pages[s] or self._draft_pages[s]):
                pages = self._slot_pages[s]
                self._slot_pages[s] = []
                self._pool.unref(pages)
                self._tables[s, :] = self._n_pages
                dpages = self._draft_pages[s]
                self._draft_pages[s] = []
                if dpages:
                    self._pool.unref(dpages)
                    self._draft_tables[s, :] = self._n_pages
                    self._draft_tables_dirty = True
                self._m_pages_freed.inc(len(pages) + len(dpages))
                self._tables_dirty = True
                self._note_occupancy()
                if req is not None:
                    self._note_client_pages(req.client_id)

    def _finish_error(self, req: _Request, err: Exception) -> None:
        if not req.done.is_set():
            req.error = err
            self._req_span(
                req, "retire", time_mod.monotonic(), 0.0,
                outcome="cancelled" if req.cancelled else "error",
                error=type(err).__name__)
            self._unregister(req)
            req.done.set()

    def _unregister(self, req: _Request) -> None:
        with self._inflight_lock:
            lst = self._inflight.get(req.client_id)
            if lst is not None:
                try:
                    lst.remove(req)
                except ValueError:
                    pass
                if not lst:
                    self._inflight.pop(req.client_id, None)

    def release_prefix_cache(self) -> int:
        """Drop every prefix-map reference; returns how many pages that
        freed. After a full drain plus this flush the pool is all-free."""
        freed = 0
        if self._paged:
            while self._prefix_map:
                _h, pg = self._prefix_map.popitem(last=False)
                self._evicted_prefixes.append(_h)
                self._prefix_hit_counts.pop(_h, None)
                freed += self._pool.unref([pg])
            self._note_occupancy()
            self.verify_pool_conservation("release_prefix_cache")
        return freed

    def verify_pool_conservation(self, context: str = "") -> None:
        """Assert ``free + referenced + shared == pool size`` when the pool
        witness is enabled (``DISTRIFLOW_POOL_WITNESS=1``), else a no-op."""
        if self._pool is None or self._pool_witness is None or not self._pool_witness.enabled:
            return
        held: set = set()
        for pages in self._slot_pages + self._draft_pages:
            held.update(pages)
        shared_only = set(self._prefix_map.values()) - held
        self._pool_witness.verify(self._pool.free_pages, len(held), len(shared_only),
                                  context=context)

    def _abort_all(self, err: Exception) -> None:
        """Device failure mid-engine: error every waiter and reset slots."""
        for s, req in enumerate(self._slot_req):
            if req is not None:
                self._retire_slot(s)
                self._finish_error(req, err)
        while self._backlog:
            self._finish_error(self._backlog.popleft(), err)
        self._m_slots.set(0)

    def _shutdown_engine(self) -> None:
        self._abort_all(RuntimeError("inference server stopped"))
        self._drain_and_error()

    def _drain_and_error(self) -> None:
        """Error every request still queued at shutdown."""
        while True:
            try:
                item = self._queue.get_nowait()
            except queue_mod.Empty:
                return
            if item is not None:
                self._finish_error(item, RuntimeError("inference server stopped"))
