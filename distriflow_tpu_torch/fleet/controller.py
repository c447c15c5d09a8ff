"""Port of ``distriflow_tpu/fleet/controller.py`` (copied with its imports rewritten).

Adaptive fleet controller: closes the telemetry -> control loop.

The fleet plane (``obs/collector.py``) ships every client's counters,
phase digests, and round times to the server; the health sentinel
(``obs/health.py``) turns them into edge-triggered SLO breaches. This
module is the missing actuator: a poll-driven controller that consumes
those breaches and steers the training fleet through the server's
per-client hyperparam override path (``AbstractServer.
set_client_hyperparams``) and the async server's fleet-wide dispatch
window cap — the pace-steering / graceful-degradation loop Bonawitz et
al. (SysML 2019) identify as the hard part of federated training at
scale.

Degradation ladder (docs/ROBUSTNESS.md §10):

* ``fleet_straggler`` breach for one client -> push THAT client a
  per-client override: ``inflight_window=1`` (stop dispatch-ahead work
  queueing behind its slow fits — the knob that actually shortens its
  round time) and a boosted ``topk_fraction`` (its rare surviving
  updates ship denser, offsetting the staleness decay they land with).
* sustained ``fleet_ack_p99`` breach -> shrink the FLEET-WIDE dispatch
  window cap (halve toward 1): every client's in-flight work drops, the
  wire and the apply queue drain.
* recovery ramps back: the per-client override is cleared (and pushed)
  / the window cap is doubled toward uncapped only once its signal has
  stayed clean for a **sustained-clean window** — ``recovery_window_s``
  of wall clock judged against the telemetry timeline
  (docs/OBSERVABILITY.md §12) when one is running, falling back to
  ``recovery_checks`` consecutive clean point-polls when not. Knobs
  move one rung per poll — no thrash on a flapping signal.

Every adapt/ramp is also stamped on the run timeline
(``controller_adapt`` / ``controller_ramp`` events), so ``python -m
distriflow_tpu.obs.dump RUN_DIR --timeline`` shows each knob move
aligned against the series that caused it.

Every decision is recorded as a ``controller_action`` payload dict
(``comm/schema.py``) in a bounded action log, and counted on
``controller_adaptations_total{band=...}`` / ``controller_ramps_total``.
``controller_overrides_active`` gauges how many clients are currently
pinned — band it with ``default_bands(controller_overrides_max=...)``
to page a human when per-client steering saturates.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

__all__ = ["AdaptiveController", "FleetAutoscaler"]

#: bounded action log length (a soak can poll for hours)
_MAX_ACTIONS = 4096


class AdaptiveController:
    """Poll-driven controller over one async server + health sentinel.

    Call :meth:`step` periodically (the soak harness and doctor drill
    poll it; production would tick it from a timer thread). Not
    thread-safe — one poller at a time.
    """

    def __init__(self, server: Any, sentinel: Any, *,
                 topk_boost: float = 4.0,
                 straggler_window: int = 1,
                 cap_floor: int = 1,
                 recovery_checks: int = 3,
                 recovery_window_s: Optional[float] = None):
        self.server = server
        self.sentinel = sentinel
        self.topk_boost = float(topk_boost)
        self.straggler_window = int(straggler_window)
        self.cap_floor = int(cap_floor)
        self.recovery_checks = int(recovery_checks)
        # trend-aware recovery: with a running telemetry timeline, ramp
        # only after the signal stayed clean for this much WALL CLOCK
        # (a sustained-clean window) instead of counting point polls;
        # None keeps the point-poll recovery_checks behaviour
        self.recovery_window_s = (None if recovery_window_s is None
                                  else float(recovery_window_s))
        self.telemetry = server.telemetry
        self._actions: List[Dict[str, Any]] = []
        self.adaptations = 0
        self.ramps = 0
        # consecutive clean polls per pinned client / for the window cap
        self._clear_streak: Dict[str, int] = {}
        self._cap_clear_streak = 0
        # trend mode: wall time each knob's signal was last seen dirty
        self._clean_since: Dict[str, float] = {}
        self._cap_clean_since: Optional[float] = None
        self._g_overrides = self.telemetry.gauge(
            "controller_overrides_active",
            help="clients currently pinned on a controller override")
        self._c_ramps = self.telemetry.counter(
            "controller_ramps_total",
            help="controller recovery ramps (knobs restored)")

    def _trend_mode(self) -> bool:
        """True when ramp-back is judged on the timeline's wall clock
        (a sustained-clean window) instead of poll streaks."""
        return (self.recovery_window_s is not None
                and self.telemetry.timeline.active)

    # -- public surface -----------------------------------------------------

    def actions(self) -> List[Dict[str, Any]]:
        """The decision log: ``controller_action`` payload dicts, oldest
        first (bounded)."""
        return list(self._actions)

    def step(self) -> List[Dict[str, Any]]:
        """One control poll: run the sentinel, react to newly-entered
        breaches, ramp recovered knobs back. Returns the actions taken
        this poll."""
        before = len(self._actions)
        hits = self.sentinel.check()
        for hit in hits:
            band = hit.get("band")
            if band == "fleet_straggler":
                self._adapt_straggler(hit)
            elif band == "fleet_ack_p99":
                self._shrink_fleet_window(hit)
        self._ramp_back()
        self._g_overrides.set(len(self.server.override_ids()))
        return self._actions[before:]

    # -- breach reactions ---------------------------------------------------

    def _adapt_straggler(self, hit: Dict[str, Any]) -> None:
        """Per-client degradation rung 1: pin the straggler's window to 1
        and boost its topk fraction (see module docstring for why this
        direction)."""
        stable = hit.get("client") or self.server.identity_of(
            hit.get("client_id", ""))
        if not stable:
            return  # connection never identified itself; nothing to key on
        if self.server.client_overrides(stable):
            return  # already pinned; the streak logic owns it from here
        old_topk = float(self.server.client_hyperparams.topk_fraction)
        old_window = int(self.server.client_hyperparams.inflight_window)
        new_topk = min(1.0, old_topk * self.topk_boost)
        new_window = max(1, min(old_window, self.straggler_window))
        override = {  # dfcheck: payload hyperparam_override
            "topk_fraction": new_topk,
            "inflight_window": new_window,
        }
        self.server.set_client_hyperparams(stable, override, push=True)
        self._clear_streak[stable] = 0
        self._clean_since.pop(stable, None)
        self.adaptations += 1
        self.telemetry.counter("controller_adaptations_total",
                               band="fleet_straggler",
                               help="controller degradations, by band").inc()
        self._record("adapt", "fleet_straggler", client=stable,
                     knob="topk_fraction", old=old_topk, new=new_topk,
                     observed=hit.get("observed"))
        self._record("adapt", "fleet_straggler", client=stable,
                     knob="inflight_window", old=old_window, new=new_window,
                     observed=hit.get("observed"))

    def _shrink_fleet_window(self, hit: Dict[str, Any]) -> None:
        """Fleet-wide degradation rung 2: halve the dispatch window cap
        toward ``cap_floor``."""
        base = int(self.server.client_hyperparams.inflight_window)
        cap = self.server.fleet_window_cap
        old = base if cap is None else cap
        new = max(self.cap_floor, old // 2)
        if new >= old:
            return  # already at the floor; nothing left to shed
        self.server.set_fleet_window_cap(new)
        self._cap_clear_streak = 0
        self._cap_clean_since = None
        self.adaptations += 1
        self.telemetry.counter("controller_adaptations_total",
                               band="fleet_ack_p99",
                               help="controller degradations, by band").inc()
        self._record("adapt", "fleet_ack_p99", knob="dispatch_window_cap",
                     old=old, new=new, observed=hit.get("observed"))

    # -- recovery -----------------------------------------------------------

    def _clean_long_enough(self, key: str, now: float) -> bool:
        """Trend mode: has ``key``'s signal been clean (as polled) for a
        full ``recovery_window_s`` of wall clock — AND has the timeline
        actually observed that long a span (a freshly started sampler
        has not witnessed a sustained-clean window yet)?"""
        since = self._clean_since.setdefault(key, now)
        if now - since < self.recovery_window_s:
            return False
        return self.telemetry.timeline.span_s() >= self.recovery_window_s

    def _ramp_back(self) -> None:
        """Clear knobs whose signal stayed clean long enough — a
        sustained-clean wall-clock window in trend mode (see
        ``recovery_window_s``), ``recovery_checks`` consecutive clean
        polls otherwise. A client with no live connections counts as
        clean — its override would otherwise pin a ghost forever."""
        trend = self._trend_mode()
        now = time.time()
        breached = set(self.sentinel.breached())
        for stable in self.server.override_ids():
            conns = self.server.connections_of(stable)
            dirty = any(f"fleet_straggler:{c}" in breached for c in conns)
            if dirty:
                self._clear_streak[stable] = 0
                self._clean_since.pop(stable, None)
                continue
            if trend:
                if not self._clean_long_enough(stable, now):
                    continue
            else:
                streak = self._clear_streak.get(stable, 0) + 1
                self._clear_streak[stable] = streak
                if streak < self.recovery_checks:
                    continue
            self.server.clear_client_hyperparams(stable, push=True)
            self._clear_streak.pop(stable, None)
            self._clean_since.pop(stable, None)
            self.ramps += 1
            self._c_ramps.inc()
            self._record("ramp", "fleet_straggler", client=stable,
                         knob="override", old=1, new=0)
        cap = self.server.fleet_window_cap
        if cap is None:
            self._cap_clear_streak = 0
            self._cap_clean_since = None
        elif "fleet_ack_p99" in breached:
            self._cap_clear_streak = 0
            self._cap_clean_since = None
        else:
            ready = False
            if trend:
                if self._cap_clean_since is None:
                    self._cap_clean_since = now
                ready = (now - self._cap_clean_since
                         >= self.recovery_window_s
                         and self.telemetry.timeline.span_s()
                         >= self.recovery_window_s)
            else:
                self._cap_clear_streak += 1
                ready = self._cap_clear_streak >= self.recovery_checks
            if ready:
                base = int(self.server.client_hyperparams.inflight_window)
                new: Optional[int] = cap * 2
                if new >= base:
                    new = None
                self.server.set_fleet_window_cap(new)
                self._cap_clear_streak = 0
                self._cap_clean_since = None
                self.ramps += 1
                self._c_ramps.inc()
                self._record("ramp", "fleet_ack_p99",
                             knob="dispatch_window_cap", old=cap,
                             new=base if new is None else new)

    # -- action log ---------------------------------------------------------

    def _record(self, action: str, band: str, **extra: Any) -> None:
        row = {  # dfcheck: payload controller_action
            "action": action,
            "band": band,
        }
        row.update({k: v for k, v in extra.items() if v is not None})
        self._actions.append(row)
        del self._actions[:-_MAX_ACTIONS]
        # stamp the knob move on the run timeline (no-op until a
        # timeline is started) so `dump --timeline` aligns it with the
        # series that caused it
        self.telemetry.timeline.event(
            f"controller_{action}",
            **{k: v for k, v in row.items() if k != "action"})


class FleetAutoscaler:
    """SLO-closed membership control over one :class:`~distriflow_tpu_torch.
    fleet.router.FleetRouter` (round 19, docs/ROBUSTNESS.md §11).

    The serving twin of :class:`AdaptiveController`: where
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
