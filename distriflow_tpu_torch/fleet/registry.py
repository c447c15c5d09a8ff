"""Port of ``distriflow_tpu/fleet/registry.py`` (copied with its imports rewritten).

Replica registry: the router's view of each inference replica.

One :class:`ReplicaState` per registered ``InferenceServer``, fed by the
``fleet_stats`` poll the router runs over the same transport the
heartbeat/fleet-telemetry plane uses (liveness, queue depth, page
occupancy, speculative accept rate, draining flag), plus a bounded
per-replica **shadow prefix map** — chain hash -> depth — learned from
the prompts the router itself routed (ack metadata proves they reached
the slots path). The shadow map is a HINT, never correctness: a stale
entry at worst routes a request to a replica that admits it cold, and
greedy decode is bit-identical either way (pinned by
``tests/test_fleet_router.py``). Replicas ship the prefix hashes they
evict (`release_prefix_cache()` / pool-pressure eviction) in their stats
ack, and :meth:`ReplicaRegistry.update_stats` forgets those entries so a
post-evict route doesn't chase warmth that is no longer there.
"""

from __future__ import annotations

import random
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional

#: per-replica shadow-map entry cap — bounds router memory regardless of
#: traffic mix; LRU within one replica's map (touch on hit, evict cold)
SHADOW_CAP = 4096

#: probation re-probe backoff (round 19): the FIRST re-probe after a
#: death is immediate (a torn connection to a healthy server heals on
#: the next stats poll, exactly the pre-probation behaviour), then each
#: failed probe doubles the jittered wait so a truly dead replica costs
#: one dial attempt per backoff window instead of one per poll
PROBE_BASE_S = 0.5
PROBE_MAX_S = 10.0


class ReplicaState:
    """Mutable per-replica record. All mutation goes through the owning
    :class:`ReplicaRegistry` under its lock."""

    def __init__(self, name: str, address: str):
        self.name = name
        self.address = address
        self.conn: Any = None            # ClientTransport, owned by the router
        self.alive = False
        self.draining = False
        self.stats: Dict[str, Any] = {}  # last fleet_stats ack, verbatim
        self.stats_t = 0.0               # monotonic time of that ack
        # chain hash -> depth (1-based page count the hash proves warm)
        self.shadow: "OrderedDict[bytes, int]" = OrderedDict()
        self.outstanding = 0             # requests forwarded, not yet acked
        self.routed = 0                  # requests ever routed here
        self.rr_seq = 0                  # insertion order, the final tie-break
        # probation (round 19): a dead replica is re-probed on a jittered
        # exponential backoff instead of every poll — and instead of never
        self.probe_at = 0.0              # monotonic time the next probe may run
        self.probe_backoff_s = 0.0       # current backoff rung (0 = first probe)
        self.revivals = 0                # dead -> live transitions survived

    # -- read helpers (racy reads are fine: stats are advisory) ------------

    def stat(self, key: str, default: Any = None) -> Any:
        return self.stats.get(key, default)

    @property
    def queue_depth(self) -> int:
        return int(self.stat("queue_depth", 0))

    @property
    def page_occupancy(self) -> float:
        return float(self.stat("page_occupancy", 0.0))

    @property
    def speculate_k(self) -> int:
        return int(self.stat("speculate_k", 0))

    @property
    def spec_accept_per_step(self) -> Optional[float]:
        v = self.stat("spec_accept_per_step")
        return None if v is None else float(v)

    @property
    def prefix_capable(self) -> bool:
        return bool(self.stat("prefix_sharing", False))


class ReplicaRegistry:
    """Thread-safe registry of :class:`ReplicaState` rows.

    Router handler threads (routing decisions, ack learning) and the
    stats poller all touch the same rows, so every mutation and every
    multi-field read goes through ``_lock``.

    ``rng`` draws the probation jitter (JAX draws from the module-level
    ``random``); it defaults to a fresh, unseeded ``random.Random``, and a
    seeded one makes the backoff schedule reproducible."""

    def __init__(self, shadow_cap: int = SHADOW_CAP,
                 rng: Optional[random.Random] = None):
        self._lock = threading.Lock()
        self.shadow_cap = int(shadow_cap)
        self._rng = rng if rng is not None else random.Random()  # guarded-by: _lock
        self._replicas: "OrderedDict[str, ReplicaState]" = OrderedDict()  # guarded-by: _lock

    # -- membership --------------------------------------------------------

    def add(self, name: str, address: str) -> ReplicaState:
        with self._lock:
            if name in self._replicas:
                raise ValueError(f"replica {name!r} already registered")
            state = ReplicaState(name, address)
            state.rr_seq = len(self._replicas)
            self._replicas[name] = state
            return state

    def get(self, name: str) -> Optional[ReplicaState]:
        with self._lock:
            return self._replicas.get(name)

    def remove(self, name: str) -> Optional[ReplicaState]:
        """Forget a replica entirely (autoscaler decommission after its
        drain completed). Returns the removed row, caller closes conn."""
        with self._lock:
            return self._replicas.pop(name, None)

    def all(self) -> List[ReplicaState]:
        with self._lock:
            return list(self._replicas.values())

    def live(self) -> List[ReplicaState]:
        """Replicas eligible for NEW work: alive and not draining."""
        with self._lock:
            return [r for r in self._replicas.values()
                    if r.alive and not r.draining]

    def live_count(self) -> int:
        with self._lock:
            return sum(1 for r in self._replicas.values() if r.alive)

    # -- liveness / stats --------------------------------------------------

    def mark_live(self, name: str) -> bool:
        """Mark alive; resets the probation backoff. Returns True when
        this was a REVIVAL (the replica was dead) — the router counts
        those on ``router_replica_revivals_total``."""
        with self._lock:
            r = self._replicas.get(name)
            if r is None:
                return False
            # first-ever dial is a JOIN, not a revival: a replica only
            # "revives" when it had served (stats seen) before it died
            revived = not r.alive and r.stats_t > 0.0
            r.alive = True
            r.probe_backoff_s = 0.0
            r.probe_at = 0.0
            if revived:
                r.revivals += 1
            return revived

    def mark_dead(self, name: str) -> None:
        """A dead replica's warmth is unknowable — drop the shadow map so
        a later revival starts cold instead of chasing stale hints. The
        replica enters PROBATION, not a terminal state: the first
        re-probe is due immediately (``probe_at`` stays in the past) and
        each failed probe backs off via :meth:`note_probe_failure`."""
        with self._lock:
            r = self._replicas.get(name)
            if r is not None:
                r.alive = False
                r.shadow.clear()

    def probe_due(self, name: str) -> bool:
        """May the router re-dial this dead replica yet? (Jittered
        backoff gate — a live replica is never 'due'.)"""
        with self._lock:
            r = self._replicas.get(name)
            return (r is not None and not r.alive
                    and time.monotonic() >= r.probe_at)

    def note_probe_failure(self, name: str) -> None:
        """A probation re-dial failed: double the backoff (capped) and
        schedule the next probe with +/-50% jitter so a fleet of routers
        probing one dead replica never thundering-herds its address."""
        with self._lock:
            r = self._replicas.get(name)
            if r is None:
                return
            r.probe_backoff_s = min(
                PROBE_MAX_S, (r.probe_backoff_s * 2.0) or PROBE_BASE_S)
            r.probe_at = (time.monotonic()
                          + r.probe_backoff_s * self._rng.uniform(0.5, 1.5))

    def mark_draining(self, name: str, draining: bool = True) -> None:
        with self._lock:
            r = self._replicas.get(name)
            if r is not None:
                r.draining = draining

    # dfcheck: payload stats=fleet_stats
    def update_stats(self, name: str, stats: Dict[str, Any]) -> None:
        """Fold one ``fleet_stats`` ack in: refresh the advisory numbers,
        the draining flag, FORGET any prefix hashes the replica says it
        evicted since the last poll, and LEARN the replica-authoritative
        warm set from the v2 ``warm_prefixes`` hit counters (round 19:
        shadow maps rebuild from replica truth, not routing history
        alone — a restarted router, or a revived replica whose shadow
        was dropped at death, recovers warmth on the next poll)."""
        with self._lock:
            r = self._replicas.get(name)
            if r is None:
                return
            r.stats = dict(stats)
            r.stats_t = time.monotonic()
            r.alive = True
            r.draining = bool(stats.get("draining", False))
            for hexdigest in stats.get("evicted_prefixes", ()):
                try:
                    r.shadow.pop(bytes.fromhex(hexdigest), None)
                except (ValueError, TypeError):
                    continue
            # v2 field — absent from pre-round-19 replicas, so .get only.
            # warmth() judges membership (the consecutive-run walk), so
            # folding an entry whose chain depth we never routed is safe:
            # the value stores the replica-reported hit count, advisory.
            for entry in stats.get("warm_prefixes") or ():
                try:
                    h = bytes.fromhex(entry[0])
                    hits = int(entry[1])
                except (ValueError, TypeError, IndexError):
                    continue
                r.shadow[h] = hits
                r.shadow.move_to_end(h)
            while len(r.shadow) > self.shadow_cap:
                r.shadow.popitem(last=False)

    # -- shadow prefix map -------------------------------------------------

    def learn(self, name: str, hashes: List[bytes]) -> None:
        """Record that ``hashes`` (chain hashes of one routed prompt's
        leading pages) are now resident on ``name`` — called after a
        successful slots-path ack, because admission registers the full
        prompt into the replica's prefix map whether or not it hit."""
        if not hashes:
            return
        with self._lock:
            r = self._replicas.get(name)
            if r is None:
                return
            for depth, h in enumerate(hashes, start=1):
                r.shadow[h] = depth
                r.shadow.move_to_end(h)
            while len(r.shadow) > self.shadow_cap:
                r.shadow.popitem(last=False)

    def warmth(self, name: str, hashes: List[bytes]) -> int:
        """Warmest-prefix depth: how many LEADING hashes of this prompt
        the replica's shadow map holds consecutively (mirrors the
        server's ``_row_plan`` walk — a gap ends the shared run)."""
        with self._lock:
            r = self._replicas.get(name)
            if r is None:
                return 0
            depth = 0
            for h in hashes:
                if h not in r.shadow:
                    break
                r.shadow.move_to_end(h)
                depth += 1
            return depth

    # -- accounting --------------------------------------------------------

    def note_submit(self, name: str) -> None:
        with self._lock:
            r = self._replicas.get(name)
            if r is not None:
                r.outstanding += 1
                r.routed += 1

    def note_done(self, name: str) -> None:
        with self._lock:
            r = self._replicas.get(name)
            if r is not None and r.outstanding > 0:
                r.outstanding -= 1

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Operator/doctor view: one row per replica (no raw hashes)."""
        with self._lock:
            return {
                name: {
                    "address": r.address,
                    "alive": r.alive,
                    "draining": r.draining,
                    "revivals": r.revivals,
                    "routed": r.routed,
                    "outstanding": r.outstanding,
                    "shadow_entries": len(r.shadow),
                    "queue_depth": r.queue_depth,
                    "page_occupancy": r.page_occupancy,
                    "speculate_k": r.speculate_k,
                    "spec_accept_per_step": r.spec_accept_per_step,
                    "stats_age_s": (
                        round(time.monotonic() - r.stats_t, 3)
                        if r.stats_t else None),
                }
                for name, r in self._replicas.items()
            }
