"""Port of ``distriflow_tpu/fleet/controller.py``: :class:`FleetAutoscaler`
only (copied with its imports rewritten; the training-fleet
``AdaptiveController`` is not ported yet).

The autoscaler closes the serving SLO loop over fleet membership: it
polls a health sentinel (``obs/health.py``) and the router's shed
counters, undrains a warm standby or dials a cold standby address on
pressure, and drains the coldest ring arc after a clean-idle streak.
Every decision is a ``controller_action`` dict in a bounded action log
and an ``autoscaler_*`` event on the run timeline.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

__all__ = ["FleetAutoscaler"]

#: bounded action log length (a soak can poll for hours)
_MAX_ACTIONS = 4096


class FleetAutoscaler:
    """SLO-closed membership control over one :class:`~distriflow_tpu_torch.
    fleet.router.FleetRouter` (round 19, docs/ROBUSTNESS.md §11).

    The serving twin of the JAX package's ``AdaptiveController``: where
    that one steers per-client training knobs, this one steers fleet
    MEMBERSHIP from the telemetry the serving plane already ships —

    * **scale-out** when a ``sustained``-kind per-tier TTFT/TPOT p99
      band newly breaches (sustained judges, so a single slow
      request cannot trigger it), or when the router's shed counters
      moved since the last poll (capacity refusals are the loudest
      demand signal there is). The fast path UNDRAINS a warm standby —
      a drained-but-alive replica rejoins the ring in one RPC — else a
      cold standby address is dialed into the fleet.
    * **scale-in** only after ``scale_in_clean_checks`` consecutive
      polls with zero breaches, zero sheds, and zero outstanding /
      queued work (the idle criterion), and never below
      ``min_replicas``. The victim is the **coldest arc**: fewest
      replica-reported prefix entries, then smallest ring arc share —
      draining it forfeits the least warmth. The drain rides the
      existing ``begin_drain()`` handoff; the drained replica becomes
      the next scale-out's warm standby.
    * **hysteresis**: every action arms a ``cooldown_checks``-poll
      cooldown during which the autoscaler only observes, so a
      transient spike can never flap membership (out and back in)
      inside one control horizon.

    Decisions are ``controller_action`` payload dicts in a bounded log
    (action ``scale_out`` / ``scale_in``), counted on
    ``autoscaler_scale_out_total`` / ``autoscaler_scale_in_total``,
    gauged on ``autoscaler_standbys_available``, and stamped on the run
    timeline. Not thread-safe — one poller at a time.
    """

    #: band-name prefixes that count as serving-latency pressure
    _LATENCY_BANDS = ("ttft", "tpot", "serving_ttft", "serving_tpot")

    def __init__(self, router: Any, sentinel: Any, *,
                 standbys: Sequence[str] = (),
                 min_replicas: int = 1,
                 max_replicas: Optional[int] = None,
                 cooldown_checks: int = 3,
                 scale_in_clean_checks: int = 6,
                 telemetry: Any = None):
        self.router = router
        self.sentinel = sentinel
        self.standbys: List[str] = list(standbys)  # cold spare addresses
        self.min_replicas = int(min_replicas)
        self.max_replicas = (None if max_replicas is None
                             else int(max_replicas))
        self.cooldown_checks = int(cooldown_checks)
        self.scale_in_clean_checks = int(scale_in_clean_checks)
        self.telemetry = (telemetry if telemetry is not None
                          else router._tel)
        self._actions: List[Dict[str, Any]] = []
        self._cooldown = 0
        self._clean_streak = 0
        self._shed_seen = self._shed_total()
        self.scale_outs = 0
        self.scale_ins = 0
        self._c_out = self.telemetry.counter(
            "autoscaler_scale_out_total",
            help="autoscaler scale-out actions (standby admitted)")
        self._c_in = self.telemetry.counter(
            "autoscaler_scale_in_total",
            help="autoscaler scale-in actions (coldest arc drained)")
        self._g_standbys = self.telemetry.gauge(
            "autoscaler_standbys_available",
            help="warm (drained) + cold (address) standbys on hand")
        self._note_standbys()

    # -- public surface -----------------------------------------------------

    def actions(self) -> List[Dict[str, Any]]:
        """The decision log: ``controller_action`` payload dicts, oldest
        first (bounded)."""
        return list(self._actions)

    def step(self) -> List[Dict[str, Any]]:
        """One control poll: run the sentinel, read the demand signals,
        move membership at most one replica per poll. Returns the
        actions taken this poll."""
        before = len(self._actions)
        hits = self.sentinel.check()
        pressure = [h for h in hits
                    if h.get("kind") == "sustained"
                    and str(h.get("band", "")).startswith(
                        self._LATENCY_BANDS)]
        shed_now = self._shed_total()
        shed_delta = shed_now - self._shed_seen
        self._shed_seen = shed_now
        if self._cooldown > 0:
            # hysteresis window: observe only, and a dirty poll inside
            # it still resets the scale-in streak
            self._cooldown -= 1
            if pressure or shed_delta:
                self._clean_streak = 0
            self._note_standbys()
            return self._actions[before:]
        if pressure or shed_delta:
            self._clean_streak = 0
            hit = pressure[0] if pressure else None
            self._scale_out(hit, shed_delta)
        elif self._idle():
            self._clean_streak += 1
            if self._clean_streak >= self.scale_in_clean_checks:
                self._scale_in()
        else:
            self._clean_streak = 0
        self._note_standbys()
        return self._actions[before:]

    # -- signals ------------------------------------------------------------

    def _shed_total(self) -> int:
        return int(sum(c.value for c in self.router._m_shed.values()))

    def _idle(self) -> bool:
        """No queued or in-flight work anywhere in the fleet — the only
        state a drain can't hurt tail latency from."""
        live = self.router.registry.live()
        return bool(live) and all(
            r.outstanding == 0 and r.queue_depth == 0 for r in live)

    def _warm_standby(self) -> Optional[str]:
        """A drained-but-alive replica: rejoins the ring in one RPC."""
        for r in self.router.registry.all():
            if r.alive and r.draining:
                return r.name
        return None

    # -- actions ------------------------------------------------------------

    def _scale_out(self, hit: Optional[Dict[str, Any]],
                   shed_delta: int) -> None:
        live = len(self.router.registry.live())
        if self.max_replicas is not None and live >= self.max_replicas:
            return
        cause = (str(hit.get("band")) if hit
                 else f"shed_delta:{shed_delta}")
        warm = self._warm_standby()
        if warm is not None:
            if not self.router.undrain_replica(warm):
                return
            name, via = warm, "undrain"
        elif self.standbys:
            name = self.router.add_replica(self.standbys.pop(0))
            if not self.router.registry.get(name).alive:
                self.router.remove_replica(name)
                return  # standby address did not answer; try next poll
            via = "add"
        else:
            return  # nothing on hand: the breach stays visible upstream
        self.scale_outs += 1
        self._c_out.inc()
        self._cooldown = self.cooldown_checks
        self._record("scale_out", cause, replica=name, via=via,
                     observed=hit.get("observed") if hit else None,
                     replicas_live=len(self.router.registry.live()))

    def _scale_in(self) -> None:
        live = self.router.registry.live()
        if len(live) <= self.min_replicas:
            return
        # coldest arc: fewest replica-reported prefix entries, then the
        # smallest ring arc share, then join order (newest first would
        # churn the ring's oldest arcs; rr_seq keeps it deterministic)
        def coldness(r: Any) -> Any:
            return (int(r.stat("prefix_entries", len(r.shadow))),
                    self.router.ring.arc_share(r.name), -r.rr_seq)
        victim = min(live, key=coldness)
        if not self.router.drain_replica(victim.name):
            return
        self.scale_ins += 1
        self._c_in.inc()
        self._cooldown = self.cooldown_checks
        self._clean_streak = 0
        self._record("scale_in", "idle", replica=victim.name,
                     replicas_live=len(self.router.registry.live()))

    # -- bookkeeping --------------------------------------------------------

    def _note_standbys(self) -> None:
        warm = sum(1 for r in self.router.registry.all()
                   if r.alive and r.draining)
        self._g_standbys.set(warm + len(self.standbys))

    def _record(self, action: str, band: str, **extra: Any) -> None:
        row = {  # dfcheck: payload controller_action
            "action": action,
            "band": band,
        }
        row.update({k: v for k, v in extra.items() if v is not None})
        self._actions.append(row)
        del self._actions[:-_MAX_ACTIONS]
        self.telemetry.timeline.event(
            f"autoscaler_{action}",
            **{k: v for k, v in row.items() if k != "action"})
