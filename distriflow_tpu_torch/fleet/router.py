"""Port of ``distriflow_tpu/fleet/router.py`` (copied with its imports rewritten).

FleetRouter: an affinity-aware front door over N inference replicas.

The round-13 subsystem (design in docs/PERFORMANCE.md §7h): one router
process fronts N independent :class:`InferenceServer` replicas on the
same native transport clients already speak — an ``InferenceClient``
pointed at the router works unchanged, and the router forwards
``generate`` / ``beam`` / ``score`` / ``model_info`` over its own
``ClientTransport`` per replica.

Three routing planes compose per request:

* **prefix affinity** (``policy="affinity"``, the default): the router
  hashes the prompt's leading pages with the SAME chain hash the
  server's prefix map uses (``fleet/prefix_hash.py`` — hoisted, so the
  two sides cannot drift) and scores each live replica by
  warmest-prefix depth from a bounded shadow map learned from its own
  routing history; ties fall back to least load (outstanding forwards,
  then polled page occupancy). ``"round_robin"`` and ``"least_loaded"``
  are the bench baselines.
* **SLO-tiered admission**: requests carry a priority tier (0 =
  interactive, never shed; higher = sheddable). When the *least* queue
  depth across live replicas exceeds the tier's threshold the router
  answers ``{"shed": true}`` instead of forwarding — a structured
  refusal (a raising handler would reach the client as an opaque
  ``None`` ack), raised client-side as :class:`RequestShed`.
  Long decodes prefer ``speculate_k > 0`` replicas whose live accept
  rate (``serving_spec_accepted_per_step``) clears the floor.
* **drain/failover**: every forwarded request is stamped with a
  ``request_id``; the replica dedups on it (bounded LRU + in-flight
  gating, the uploads' idempotency pattern applied to serving). A replica
  that dies mid-request (``ConnectionLost``/``AckTimeout``) or answers
  ``{"refused": "draining"}`` is excluded and the SAME request_id is
  resubmitted to a peer — at-most-once compute per replica, exactly
  one answer at the front door, and greedy/seeded decode makes the
  replayed result bit-identical.

Round 19 adds the **elastic** planes (docs/ROBUSTNESS.md §11):

* ``policy="ring"``: prefix -> replica placement through a consistent
  hash ring (``fleet/ring.py``) keyed on the prompt's FIRST chain hash
  — a pure function of live membership, so replicas join/leave under
  traffic with only their ring arcs remapping (~1/N of the warm set)
  while shadow-map warmth stays the metrics/diagnostics plane. The
  ring tracks ``registry.live()`` through every liveness transition
  (``_sync_ring``); membership changes land on the run timeline and in
  a bounded ``ring_membership`` event log.
* **probation revival**: a dead replica is re-probed on a jittered
  exponential backoff (``fleet/registry.py``) instead of on every poll
  — and instead of never, which is what ``redial=False`` used to mean
  for a replica lost to a forward failure. A successful re-dial of a
  replica that had served before counts on
  ``router_replica_revivals_total`` and rejoins the ring.
* **tail hedging** (``hedge_ms={tier: watermark_ms}``): when the
  primary attempt has not acked inside the tier's watermark, the SAME
  ``request_id`` races against the second-warmest ring replica; the
  first usable ack wins, the loser is cancelled server-side
  (``hedge_cancel`` -> the replica-side dedup/in-flight gate and the
  engine's cancel path suppress the duplicate) and both attempts
  assemble into ONE trace round via the request-id merge.

Metrics (docs/OBSERVABILITY.md §1): ``router_requests_total{tier}``,
``router_affinity_hits_total``, ``router_shed_total{tier}``,
``router_failovers_total``, ``router_replicas_live``,
``router_goodput_total{tier}``, ``router_hedge_candidates_total``,
``router_hedges_total``, ``router_hedge_wins_total``,
``router_replica_revivals_total``.
Tracing (docs/OBSERVABILITY.md §11): when the inbound payload carries a
``trace_id`` header the router emits one ``route`` span per forwarding
attempt (replica, policy, affinity depth, shed/failover verdict), so
the request assembler can reconstruct the failover chain from the
router's run dir alone.
"""

from __future__ import annotations

import queue
import random
import threading
import time
import uuid
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from distriflow_tpu_torch.comm.transport import (
    AckTimeout,
    ClientTransport,
    ConnectionLost,
    FaultPlan,
    ServerTransport,
)
from distriflow_tpu_torch.fleet.prefix_hash import page_hashes
from distriflow_tpu_torch.fleet.registry import ReplicaRegistry, ReplicaState
from distriflow_tpu_torch.fleet.ring import DEFAULT_VNODES, HashRing
from distriflow_tpu_torch.obs import get_telemetry
from distriflow_tpu_torch.utils.logging import VerboseLogger
from distriflow_tpu_torch.utils.serialization import deserialize_array, unpack_bytes

#: default per-tier shed thresholds: shed tier t when every live replica's
#: queue depth exceeds this. Tier 0 (interactive) is never shed.
DEFAULT_SHED_DEPTH: Dict[int, int] = {1: 32, 2: 8}

#: decodes at least this long prefer speculative replicas (the spec win is
#: memory-bound long decodes; short ones lose the draft overhead)
LONG_DECODE_TOKENS = 64

#: minimum live accept rate (accepted_per_step / speculate_k) for a spec
#: replica to keep its long-decode preference; unknown rate = benefit of
#: the doubt (a cold replica has no signal yet)
SPEC_ACCEPT_FLOOR = 0.25

ROUTE_TIMEOUT_S = 600.0  # forwarded generate: replica may be cold-compiling
STATS_TIMEOUT_S = 5.0


class FleetRouter:
    """Front-door router over N ``InferenceServer`` replicas."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        policy: str = "affinity",
        shed_depth: Optional[Dict[int, int]] = None,
        long_decode_tokens: int = LONG_DECODE_TOKENS,
        spec_accept_floor: float = SPEC_ACCEPT_FLOOR,
        stats_interval_s: float = 0.5,
        redial: bool = True,
        request_timeout: float = ROUTE_TIMEOUT_S,
        ring_vnodes: int = DEFAULT_VNODES,
        hedge_ms: Optional[Dict[int, float]] = None,
        telemetry: Any = None,
        verbose: Optional[bool] = None,
        rng: Optional[random.Random] = None,
    ):
        if policy not in ("affinity", "round_robin", "least_loaded", "ring"):
            raise ValueError(f"unknown routing policy {policy!r}")
        self.policy = policy
        self.shed_depth = dict(DEFAULT_SHED_DEPTH if shed_depth is None
                               else shed_depth)
        self.long_decode_tokens = int(long_decode_tokens)
        self.spec_accept_floor = float(spec_accept_floor)
        self.stats_interval_s = float(stats_interval_s)
        self.redial = bool(redial)
        self.request_timeout = float(request_timeout)
        # tail hedging watermark per tier, in ms; None/missing tier = off.
        # Default OFF: hedging doubles worst-case per-request replica load,
        # so it is an explicit opt-in for the tiers whose tail matters.
        self.hedge_ms = dict(hedge_ms) if hedge_ms else {}
        self.logger = VerboseLogger("FleetRouter", verbose)
        self.registry = ReplicaRegistry(rng=rng)  # rng: the probation jitter
        # the consistent ring tracks registry.live() through _sync_ring on
        # every liveness/draining transition — maintained under ALL
        # policies (the autoscaler reads arc shares even when routing is
        # affinity-based), consulted by _pick only under policy="ring"
        self.ring = HashRing(ring_vnodes)
        self._ring_lock = threading.Lock()
        # bounded ring_membership event log (comm/schema.py payload),
        # newest last — the doctor drill and snapshot read it
        self._membership_log: Deque[Dict[str, Any]] = deque(maxlen=256)  # guarded-by: _ring_lock
        self.transport = ServerTransport(host, port)
        self.transport.on("model_info", self._on_info)
        self.transport.on("generate", self._on_generate)
        self.transport.on("beam", self._on_forward_beam)
        self.transport.on("score", self._on_forward_score)
        self.transport.on("router_snapshot", self._on_snapshot)
        self._stopped = threading.Event()
        self._poller: Optional[threading.Thread] = None
        self._rr_lock = threading.Lock()
        self._rr_next = 0  # guarded-by: _rr_lock
        # per-replica fault plans (chaos: scripted resets on the forward
        # path), installed at add_replica time and honored across redials
        self._fault_plans: Dict[str, Optional[FaultPlan]] = {}
        tel = telemetry if telemetry is not None else get_telemetry()
        self._tel = tel
        self._m_requests = {t: tel.counter(
            "router_requests_total", tier=str(t),
            help="requests accepted by the router, by SLO tier")
            for t in (0, 1, 2)}
        self._m_shed = {t: tel.counter(
            "router_shed_total", tier=str(t),
            help="requests shed at admission, by SLO tier")
            for t in (0, 1, 2)}
        self._m_affinity = tel.counter(
            "router_affinity_hits_total",
            help="requests routed to their session-affine replica")
        self._m_failovers = tel.counter(
            "router_failovers_total",
            help="requests re-dispatched after a replica failure")
        self._m_live = tel.gauge(
            "router_replicas_live", help="replicas currently routable")
        # goodput = generate requests answered with a result (sheds,
        # drain refusals, and handler errors all miss); hedge candidates
        # = answered requests that needed >=1 failover, i.e. where a
        # hedged duplicate fired at first-submit time would have beaten
        # the failover round trip
        self._m_goodput = {t: tel.counter(
            "router_goodput_total", tier=str(t),
            help="generate requests answered with a result, by SLO tier")
            for t in (0, 1, 2)}
        self._m_hedge = tel.counter(
            "router_hedge_candidates_total",
            help="answered requests that needed >=1 failover (a hedge "
                 "fired at submit time would have beaten the retry)")
        self._m_hedges = tel.counter(
            "router_hedges_total",
            help="hedged duplicate attempts actually fired (same "
                 "request_id raced against a second replica)")
        self._m_hedge_wins = tel.counter(
            "router_hedge_wins_total",
            help="hedged attempts whose duplicate acked first (the "
                 "primary lost the race and was cancelled)")
        self._m_revivals = tel.counter(
            "router_replica_revivals_total",
            help="dead replicas revived by a probation re-probe")
        # the router is a fleet citizen too: its own row (plus one row
        # per replica from the registry view routing actually used)
        # merges into ``tel.snapshot()["fleet"]`` so ``dump --fleet`` on
        # the router's run dir shows the front door next to the replicas
        tel.register_fleet(id(self), self._fleet_rows)

    # -- lifecycle ---------------------------------------------------------

    def add_replica(self, address: str, name: Optional[str] = None,
                    fault_plan: Optional[FaultPlan] = None) -> str:
        """Register and dial one replica. ``fault_plan`` (chaos drills)
        rides THIS replica's forward connection only — per-replica plans
        keep scripted ``nth`` counts deterministic."""
        name = name or f"replica-{len(self.registry.all())}"
        state = self.registry.add(name, address)
        self._fault_plans[name] = fault_plan
        self._dial(state)
        self._note_live()
        self._sync_ring(event="join", replica=name)
        return name

    def remove_replica(self, name: str) -> bool:
        """Forget a replica entirely (autoscaler decommission after its
        drain completed); its ring arcs remap to the survivors."""
        state = self.registry.remove(name)
        if state is None:
            return False
        self._fault_plans.pop(name, None)
        if state.conn is not None:
            try:
                state.conn.close()
            except Exception:
                pass
        self._note_live()
        self._sync_ring(event="leave", replica=name)
        return True

    def _dial(self, state: ReplicaState) -> bool:
        conn = ClientTransport(state.address,
                               fault_plan=self._fault_plans.get(state.name))
        conn.on_server_lost = lambda n=state.name: self._on_replica_lost(n)
        try:
            conn.connect()
        except Exception as e:
            self.logger.log(f"dial {state.name} ({state.address}): {e!r}")
            self.registry.mark_dead(state.name)
            self.registry.note_probe_failure(state.name)
            return False
        old, state.conn = state.conn, conn
        if old is not None:
            try:
                old.close()
            except Exception:
                pass
        if self.registry.mark_live(state.name):
            self._m_revivals.inc()
            self.logger.log(f"replica {state.name} revived from probation")
        return True

    def setup(self) -> "FleetRouter":
        self._stopped.clear()
        self.transport.start()
        self.refresh_stats()
        if self.stats_interval_s > 0:
            self._poller = threading.Thread(
                target=self._poll_loop, daemon=True, name="router-stats")
            self._poller.start()
        self.logger.log(f"routing on {self.address} "
                        f"({len(self.registry.all())} replicas, "
                        f"policy={self.policy})")
        return self

    def stop(self) -> None:
        self._tel.unregister_fleet(id(self))
        self._stopped.set()
        if self._poller is not None:
            self._poller.join(timeout=5.0)
            self._poller = None
        self.transport.stop()
        for state in self.registry.all():
            if state.conn is not None:
                try:
                    state.conn.close()
                except Exception:
                    pass

    @property
    def address(self) -> str:
        return self.transport.address

    # -- stats plane -------------------------------------------------------

    def _poll_loop(self) -> None:
        while not self._stopped.wait(self.stats_interval_s):
            self.refresh_stats()

    def refresh_stats(self) -> None:
        """Poll every replica's ``fleet_stats`` once. A dead replica is
        re-probed first when ``redial`` is on AND its probation backoff
        has elapsed (``registry.probe_due`` — the first probe after a
        death is immediate, so a torn connection to a healthy server
        still heals on the next poll; consecutive failures back off)."""
        for state in self.registry.all():
            if not state.alive:
                if not (self.redial
                        and self.registry.probe_due(state.name)
                        and self._dial(state)):
                    continue
            conn = state.conn
            if conn is None:
                continue
            try:
                stats = conn.request("fleet_stats", {},
                                     timeout=STATS_TIMEOUT_S)
            except (ConnectionLost, AckTimeout) as e:
                self.logger.log(f"stats poll {state.name}: {e!r}")
                self.registry.mark_dead(state.name)
                continue
            if isinstance(stats, dict):
                self.registry.update_stats(state.name, stats)
        self._note_live()
        self._sync_ring()

    def _on_replica_lost(self, name: str) -> None:
        self.registry.mark_dead(name)
        self._note_live()
        self._sync_ring(event="leave", replica=name)
        self.logger.log(f"replica {name} lost")

    def _note_live(self) -> None:
        self._m_live.set(self.registry.live_count())

    def drain_replica(self, name: str) -> bool:
        """Ask one replica to drain (refuse new generates; in-flight work
        completes). Returns True when the replica acknowledged."""
        state = self.registry.get(name)
        if state is None or state.conn is None:
            return False
        try:
            ack = state.conn.request("drain", {"enable": True},
                                     timeout=STATS_TIMEOUT_S)
        except (ConnectionLost, AckTimeout):
            self.registry.mark_dead(name)
            self._note_live()
            self._sync_ring(event="leave", replica=name)
            return False
        self.registry.mark_draining(name, True)
        self._sync_ring(event="drain", replica=name)
        return bool(ack)

    def undrain_replica(self, name: str) -> bool:
        """Lift a drain: the replica admits new work again and rejoins
        the ring (the autoscaler's scale-OUT fast path — a drained
        standby is warm and already dialed)."""
        state = self.registry.get(name)
        if state is None or state.conn is None:
            return False
        try:
            ack = state.conn.request("drain", {"enable": False},
                                     timeout=STATS_TIMEOUT_S)
        except (ConnectionLost, AckTimeout):
            self.registry.mark_dead(name)
            self._note_live()
            self._sync_ring(event="leave", replica=name)
            return False
        self.registry.mark_draining(name, False)
        self._sync_ring(event="undrain", replica=name)
        return bool(ack)

    # -- consistent ring (round 19) ----------------------------------------

    def _sync_ring(self, event: Optional[str] = None,
                   replica: Optional[str] = None) -> bool:
        """Reconcile ring membership with ``registry.live()`` (alive and
        not draining). Called on every liveness/draining transition; a
        change appends one ``ring_membership`` event (bounded log + run
        timeline) stamped with the post-change epoch."""
        names = [r.name for r in self.registry.live()]
        with self._ring_lock:
            if not self.ring.sync(names):
                return False
            evt = {
                "epoch": self.ring.epoch,
                "vnodes": self.ring.vnodes,
                "members": self.ring.members(),
                "event": event or "sync",
                "replica": replica,
            }  # dfcheck: payload ring_membership
            self._membership_log.append(evt)
        self._tel.timeline.event("ring_membership", **evt)
        self.logger.log(f"ring epoch {evt['epoch']}: {evt['event']} "
                        f"{replica or ''} -> {evt['members']}")
        return True

    def ring_membership(self) -> List[Dict[str, Any]]:
        """The bounded ``ring_membership`` event log, oldest first."""
        with self._ring_lock:
            return list(self._membership_log)

    # -- routing -----------------------------------------------------------

    def _candidates(self, exclude: Any) -> List[ReplicaState]:
        return [r for r in self.registry.live() if r.name not in exclude]

    def _pick(self, hashes: List[bytes], n_tokens: int,
              exclude: Any = ()) -> Optional[Tuple[ReplicaState, int]]:
        """(replica, affinity_depth) for one request, or None when no
        live replica remains. Affinity depth is reported even under the
        baseline policies (it feeds metrics, not their choice)."""
        cands = self._candidates(exclude)
        if not cands:
            return None
        # speculative preference: long decodes narrow to spec replicas
        # whose live accept rate clears the floor (unknown = assume ok).
        # Skipped under ring placement — ring owners are a pure function
        # of membership, and narrowing would reintroduce load-coupled
        # placement exactly where churn-stability is the point.
        if self.policy != "ring" and n_tokens >= self.long_decode_tokens:
            spec = [r for r in cands if r.speculate_k > 0 and (
                r.spec_accept_per_step is None
                or r.spec_accept_per_step
                >= self.spec_accept_floor * r.speculate_k)]
            if spec:
                cands = spec
        depths = {r.name: (self.registry.warmth(r.name, hashes)
                           if r.prefix_capable else 0)
                  for r in cands}
        if self.policy == "ring" and hashes:
            # owner order for the prompt's FIRST chain hash; the first
            # candidate in that order wins, so an excluded/dead owner
            # fails over to the NEXT arc owner — still deterministic in
            # (membership, key), which is what bounds remap under churn
            with self._ring_lock:
                order = self.ring.lookup(hashes[0], n=len(self.ring))
            by_name = {r.name: r for r in cands}
            for nm in order:
                r = by_name.get(nm)
                if r is not None:
                    return r, depths[r.name]
            # ring empty or owners all excluded: fall through to load
        if self.policy == "round_robin":
            with self._rr_lock:
                chosen = cands[self._rr_next % len(cands)]
                self._rr_next += 1
            return chosen, depths[chosen.name]
        if self.policy == "least_loaded" or not any(depths.values()):
            chosen = min(cands, key=lambda r: (
                r.outstanding, r.page_occupancy, r.queue_depth, r.rr_seq))
            return chosen, depths[chosen.name]
        chosen = min(cands, key=lambda r: (
            -depths[r.name], r.outstanding, r.page_occupancy, r.rr_seq))
        return chosen, depths[chosen.name]

    def _should_shed(self, tier: int) -> Optional[int]:
        """Queue depth justifying a shed of ``tier``, else None."""
        limit = self.shed_depth.get(tier)
        if limit is None:
            return None
        live = self.registry.live()
        if not live:
            return None  # no-replica failures are loud, not silent sheds
        depth = min(r.queue_depth for r in live)
        return depth if depth > limit else None

    # -- handlers (transport executor threads) -----------------------------

    def _on_info(self, client_id: str, payload: Any) -> Dict[str, Any]:
        ack, state, _, _ = self._submit("model_info", {}, [], 0, set())
        return ack

    def _on_snapshot(self, client_id: str, payload: Any) -> Dict[str, Any]:
        with self._ring_lock:
            ring = {"epoch": self.ring.epoch,
                    "vnodes": self.ring.vnodes,
                    "members": self.ring.members(),
                    "arc_share": {n: round(self.ring.arc_share(n), 4)
                                  for n in self.ring.members()}}
        return {"policy": self.policy, "ring": ring,
                "replicas": self.registry.snapshot()}

    def _on_forward_beam(self, client_id: str, payload: Any) -> Dict[str, Any]:
        ack, _, _, _ = self._submit("beam", payload, [], 0, set())
        return ack

    def _on_forward_score(self, client_id: str, payload: Any) -> Dict[str, Any]:
        ack, _, _, _ = self._submit("score", payload, [], 0, set())
        return ack

    def _on_generate(self, client_id: str, payload: Dict[str, Any]) -> Dict[str, Any]:
        tier = min(max(int(payload.get("tier", 1)), 0), 2)
        # the clamped tier rides to the replica so its per-tier SLO
        # labels (serving_ttft_ms{tier=...}) agree with the router's
        payload["tier"] = tier
        if payload.get("request_id") is None:
            # the idempotency key failover replays ride on; client-supplied
            # ids pass through untouched (end-to-end retries dedup too)
            payload["request_id"] = f"rt-{uuid.uuid4().hex[:16]}"
        depth = self._should_shed(tier)
        if depth is not None:
            self._m_shed[tier].inc()
            self._route_span(payload, "shed", queue_depth=depth)
            return {"shed": True, "tier": tier, "queue_depth": depth}
        hashes = self._prompt_hashes(payload)
        n_tokens = int(payload.get("n_tokens", 0))
        hedge_after = self.hedge_ms.get(tier)
        if hedge_after is not None and self.registry.live_count() >= 2:
            ack, state, aff_depth, failovers = self._submit_hedged(
                payload, hashes, n_tokens, float(hedge_after))
        else:
            ack, state, aff_depth, failovers = self._submit(
                "generate", payload, hashes, n_tokens, set())
        if state is None:
            return ack  # whole-fleet drain refusal: not an accepted request
        self._m_requests[tier].inc()
        if aff_depth > 0:
            self._m_affinity.inc()
        if failovers > 0:
            self._m_hedge.inc()
        serving = ack.get("serving")
        if isinstance(serving, dict):
            if serving.get("path") == "slots" and state.prefix_capable:
                self.registry.learn(state.name, hashes)
            serving["router"] = {"replica": state.name,
                                 "affinity_depth": aff_depth,
                                 "failovers": failovers, "tier": tier}
        if "result" in ack:
            self._m_goodput[tier].inc()
        return ack

    def _prompt_hashes(self, payload: Dict[str, Any]) -> List[bytes]:
        """Chain hashes of row 0 of the prompt (multi-row prompts route by
        their first row). Needs a page size — taken from any live
        prefix-capable replica's stats; a uniform fleet is assumed
        (mixed page sizes would make affinity hints meaningless)."""
        ps = None
        for r in self.registry.live():
            if r.prefix_capable:
                ps = int(r.stat("page_size", 0)) or None
                break
        if ps is None:
            return []
        try:
            arr = deserialize_array(unpack_bytes(payload["prompt"])["tokens"])
        except Exception:
            return []  # malformed prompt: let the replica raise the real error
        if arr.ndim != 2 or arr.shape[0] < 1:
            return []
        row = arr[0]
        if isinstance(row, torch.Tensor):
            # a bf16 payload deserializes to a CPU tensor; JAX hashes its
            # values cast to int32, as page_hashes casts this f32 row
            row = row.float().numpy()
        return page_hashes(np.asarray(row), ps)

    def _submit(self, event: str, payload: Dict[str, Any],
                hashes: List[bytes], n_tokens: int,
                tried: set) -> Tuple[Dict[str, Any], ReplicaState, int, int]:
        """Forward with failover: on ConnectionLost/AckTimeout mark the
        replica dead, on a drain refusal mark it draining, and resubmit
        the SAME payload (same request_id) to a peer. The replica-side
        dedup makes the replay at-most-once per replica; determinism
        makes any recompute bit-identical."""
        failovers = 0
        drains = 0
        while True:
            pick = self._pick(hashes, n_tokens, exclude=tried)
            if pick is None:
                if drains or any(r.alive and r.draining
                                 for r in self.registry.all()):
                    # exhaustion because the fleet is rolling over (refusals
                    # this call, or replicas already registered as draining):
                    # pass the structured refusal through so the client sees
                    # RequestRefused (retryable), not an opaque handler error
                    self._route_span(payload, "drain", failovers=failovers)
                    return {"refused": "draining"}, None, 0, failovers
                raise RuntimeError(
                    f"no live replica for {event!r} "
                    f"({len(tried)} tried, {failovers} failovers)")
            state, depth = pick
            self.registry.note_submit(state.name)
            a_start, a_mono = time.time(), time.monotonic()
            try:
                ack = state.conn.request(event, payload,
                                         timeout=self.request_timeout)
            except (ConnectionLost, AckTimeout) as e:
                self.logger.log(f"{event} on {state.name} failed: {e!r}")
                self.registry.mark_dead(state.name)
                self._note_live()
                tried.add(state.name)
                failovers += 1
                self._m_failovers.inc()
                self._route_span(payload, f"failover:{type(e).__name__}",
                                 replica=state.name, depth=depth,
                                 start=a_start, mono=a_mono)
                continue
            finally:
                self.registry.note_done(state.name)
            if ack is None:
                # the replica handler raised — a stopping server and a bad
                # request look identical here, so try each peer once; a
                # truly bad request fails everywhere and surfaces loudly
                tried.add(state.name)
                failovers += 1
                self._m_failovers.inc()
                self._route_span(payload, "failover:handler_error",
                                 replica=state.name, depth=depth,
                                 start=a_start, mono=a_mono)
                continue
            if isinstance(ack, dict) and ack.get("refused") == "draining":
                self.registry.mark_draining(state.name, True)
                tried.add(state.name)
                drains += 1
                failovers += 1
                self._m_failovers.inc()
                self._route_span(payload, "failover:draining",
                                 replica=state.name, depth=depth,
                                 start=a_start, mono=a_mono)
                continue
            extra: Dict[str, Any] = {"failovers": failovers}
            meta = ack.get("serving") if isinstance(ack, dict) else None
            if isinstance(meta, dict):
                # echo the replica-measured SLO latencies onto the route
                # span: dump --requests then attributes per-tier TTFT/
                # TPOT from the ROUTER's run dir alone (§11)
                for k in ("ttft_ms", "tpot_ms"):
                    if meta.get(k) is not None:
                        extra[k] = meta[k]
            self._route_span(payload, "forwarded", replica=state.name,
                             depth=depth, start=a_start, mono=a_mono,
                             **extra)
            return ack, state, depth, failovers

    # -- tail hedging (round 19) -------------------------------------------

    @staticmethod
    def _usable(ack: Any) -> bool:
        """An ack that answers the request: a dict that is neither a
        transport exception nor a drain refusal (handler errors arrive
        as None)."""
        return isinstance(ack, dict) and ack.get("refused") != "draining"

    def _submit_hedged(
        self, payload: Dict[str, Any], hashes: List[bytes], n_tokens: int,
        hedge_after_ms: float,
    ) -> Tuple[Dict[str, Any], Optional[ReplicaState], int, int]:
        """Hedged generate (Dean & Barroso, "The Tail at Scale"): submit
        to the primary placement; when no ack lands inside the tier's
        watermark, race the SAME ``request_id`` against the next-ranked
        replica (under ring placement, the second arc owner — the
        "second-warmest" in consistent-hash order). First USABLE ack
        wins; the loser gets a best-effort server-side ``hedge_cancel``
        and its admission is suppressed by the replica's dedup/in-flight
        gate, so at most one replica ever computes the result to
        completion. Both attempts share the request_id, so the trace
        assembler merges them into ONE round (the idempotency-key
        merge) — the chaos-churn invariant the elastic tests pin."""
        pick = self._pick(hashes, n_tokens, exclude=set())
        if pick is None:
            # no live replica: the serial path owns the drain/raise logic
            return self._submit("generate", payload, hashes, n_tokens, set())
        primary, p_depth = pick
        results: "queue.Queue[Tuple[ReplicaState, int, Any, float, float]]" \
            = queue.Queue()

        def attempt(state: ReplicaState, depth: int) -> None:
            self.registry.note_submit(state.name)
            a_start, a_mono = time.time(), time.monotonic()
            try:
                ack: Any = state.conn.request(
                    "generate", payload, timeout=self.request_timeout)
            except (ConnectionLost, AckTimeout) as e:
                ack = e
            finally:
                self.registry.note_done(state.name)
            results.put((state, depth, ack, a_start, a_mono))

        threading.Thread(target=attempt, args=(primary, p_depth),
                         daemon=True, name="hedge-primary").start()
        racing: List[ReplicaState] = [primary]
        hedged = False
        try:
            first = results.get(timeout=hedge_after_ms / 1000.0)
        except queue.Empty:
            first = None
        if first is None:
            hpick = self._pick(hashes, n_tokens, exclude={primary.name})
            if hpick is not None:
                hstate, h_depth = hpick
                hedged = True
                self._m_hedges.inc()
                self._route_span(payload, "hedge", replica=hstate.name,
                                 depth=h_depth)
                threading.Thread(target=attempt, args=(hstate, h_depth),
                                 daemon=True, name="hedge-duplicate").start()
                racing.append(hstate)
            first = results.get()
        # first usable ack wins; wait on the straggler only when the
        # first arrival is itself unusable (its replica died/refused)
        arrivals = [first]
        if len(racing) == 2 and not self._usable(first[2]):
            arrivals.append(results.get())
        winner = next((a for a in arrivals if self._usable(a[2])), None)
        failovers = 0
        if winner is None:
            # every racer failed: book-keep each failure exactly as the
            # serial loop would, then fall back to it with both tried
            tried: set = set()
            for state, depth, ack, a_start, a_mono in arrivals:
                tried.add(state.name)
                failovers += 1
                self._m_failovers.inc()
                if isinstance(ack, Exception):
                    self.logger.log(
                        f"generate on {state.name} failed: {ack!r}")
                    self.registry.mark_dead(state.name)
                    self._note_live()
                    self._sync_ring(event="leave", replica=state.name)
                    verdict = f"failover:{type(ack).__name__}"
                elif isinstance(ack, dict):
                    self.registry.mark_draining(state.name, True)
                    self._sync_ring(event="drain", replica=state.name)
                    verdict = "failover:draining"
                else:
                    verdict = "failover:handler_error"
                self._route_span(payload, verdict, replica=state.name,
                                 depth=depth, start=a_start, mono=a_mono)
            ack2, st2, d2, f2 = self._submit(
                "generate", payload, hashes, n_tokens, tried)
            return ack2, st2, d2, failovers + f2
        state, depth, ack, a_start, a_mono = winner
        if hedged:
            if state is not primary:
                self._m_hedge_wins.inc()
            loser = racing[1] if state is primary else racing[0]
            self._cancel_attempt(loser, payload)
        extra: Dict[str, Any] = {"failovers": failovers, "hedged": hedged}
        meta = ack.get("serving")
        if isinstance(meta, dict):
            for k in ("ttft_ms", "tpot_ms"):
                if meta.get(k) is not None:
                    extra[k] = meta[k]
        self._route_span(payload, "forwarded", replica=state.name,
                         depth=depth, start=a_start, mono=a_mono, **extra)
        return ack, state, depth, failovers

    def _cancel_attempt(self, state: ReplicaState, payload: Dict[str, Any]) -> None:
        """Best-effort server-side cancel of the LOSING hedge attempt:
        the replica flags the request_id cancelled, so it is skipped at
        admission or retired at the next decode-chunk boundary instead
        of computing a result nobody will read. Purely an efficiency
        move — correctness is already held by the dedup gate."""
        conn = state.conn
        if conn is None:
            return
        cancel = {"request_id": payload.get("request_id")}  # dfcheck: payload hedge_cancel
        try:
            conn.request("hedge_cancel", cancel, timeout=STATS_TIMEOUT_S)
        except (ConnectionLost, AckTimeout):
            pass  # the loser may be the replica that just died

    def _route_span(self, payload: Dict[str, Any], verdict: str,
                    replica: Optional[str] = None, depth: int = 0,
                    start: Optional[float] = None,
                    mono: Optional[float] = None, **extra: Any) -> None:
        """One ``route`` span per routing attempt — externally timed via
        ``tracer.emit`` (the transport round trip IS the span), guarded
        on the wire header so an untraced request costs one dict get."""
        tid = payload.get("trace_id")
        if not tid or not self._tel.tracer.enabled:
            return
        dur = 0.0 if mono is None else (time.monotonic() - mono) * 1000.0
        self._tel.tracer.emit(
            "route", trace_id=tid, parent_id=payload.get("span_id"),
            dur_ms=dur, start=start, mono=mono, verdict=verdict,
            policy=self.policy, replica=replica, affinity_depth=int(depth),
            tier=payload.get("tier"), request_id=payload.get("request_id"),
            **extra)

    def _fleet_rows(self) -> Dict[str, Dict[str, Any]]:
        """Fleet-table rows: the ``router`` row reconciles EXACTLY with
        the ``router_*`` counters (read from the same handles), and one
        row per replica mirrors the registry view routing actually
        used."""
        rows: Dict[str, Dict[str, Any]] = {
            "router": {
                "role": "router",
                "policy": self.policy,
                "replicas_live": self.registry.live_count(),
                "requests": int(sum(c.value
                                    for c in self._m_requests.values())),
                "shed": int(sum(c.value for c in self._m_shed.values())),
                "failovers": int(self._m_failovers.value),
                "goodput": int(sum(c.value
                                   for c in self._m_goodput.values())),
                "affinity_hits": int(self._m_affinity.value),
                "hedges": int(self._m_hedges.value),
                "hedge_wins": int(self._m_hedge_wins.value),
                "revivals": int(self._m_revivals.value),
                "ring_epoch": self.ring.epoch,
            }
        }
        for name, snap in self.registry.snapshot().items():
            rows[name] = {"role": "replica", **snap}
        return rows
