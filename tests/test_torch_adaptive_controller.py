"""Port parity: ``AdaptiveController`` (``distriflow_tpu_torch/fleet/
controller.py``) against the JAX package's, over one scripted fake server,
sentinel and telemetry.

Each script is a list of polls: the breaches the sentinel newly reports,
the bands still breached, the wall clock, and the timeline's witnessed
span. Both controllers run it on their own fakes; the calls each makes
(override pushes and clears, window caps, gauges, counters, timeline
events), the actions each ``step()`` returns and the decision log must be
equal, poll by poll: the per-client straggler rung, the fleet window cap
halving to its floor and doubling back, ghosts and unidentified
connections, point-poll and trend-mode (sustained-clean window) recovery.
"""

from types import SimpleNamespace

import pytest

from distriflow_tpu.fleet import controller as jax_controller
from distriflow_tpu_torch.fleet import controller as port_controller

pytestmark = pytest.mark.port


class _Clock:
    def __init__(self):
        self.now = 1000.0

    def time(self):
        return self.now


class _Handle:
    def __init__(self, calls, ident):
        self.calls, self.ident = calls, ident

    def set(self, v):
        self.calls.append(("gauge.set", self.ident, v))

    def inc(self, v=1.0):
        self.calls.append(("counter.inc", self.ident, v))


class _Timeline:
    def __init__(self, calls):
        self.calls = calls
        self.active = False
        self.span = 0.0

    def span_s(self):
        return self.span

    def event(self, kind, **fields):
        self.calls.append(("timeline.event", kind, tuple(sorted(fields.items()))))


class _Telemetry:
    def __init__(self, calls):
        self.calls = calls
        self.timeline = _Timeline(calls)

    def gauge(self, name, help="", **labels):
        return _Handle(self.calls, (name, tuple(sorted(labels.items()))))

    def counter(self, name, help="", **labels):
        return _Handle(self.calls, (name, tuple(sorted(labels.items()))))


class _Hyper:
    topk_fraction = 0.1
    inflight_window = 4


class _Server:
    """Records every call the controller makes. Connections ``c<i>`` belong
    to ``worker-<i>``; ``conn-ghost`` to no one; ``worker-9`` has no live
    connection."""

    def __init__(self):
        self.calls = []
        self.telemetry = _Telemetry(self.calls)
        self.client_hyperparams = _Hyper()
        self._cap = None
        self._overrides = {}

    def identity_of(self, conn_id):
        self.calls.append(("identity_of", conn_id))
        return None if conn_id == "conn-ghost" else "worker-" + conn_id[1:]

    def connections_of(self, stable):
        self.calls.append(("connections_of", stable))
        return [] if stable == "worker-9" else ["c" + stable.split("-")[1]]

    def client_overrides(self, stable):
        self.calls.append(("client_overrides", stable))
        return dict(self._overrides.get(stable, {}))

    def set_client_hyperparams(self, stable, override, push=False):
        self.calls.append(("set_client_hyperparams", stable, tuple(sorted(override.items())),
                           push))
        self._overrides[stable] = dict(override)

    def clear_client_hyperparams(self, stable, push=False):
        self.calls.append(("clear_client_hyperparams", stable, push))
        self._overrides.pop(stable, None)

    def override_ids(self):
        return sorted(self._overrides)

    @property
    def fleet_window_cap(self):
        return self._cap

    def set_fleet_window_cap(self, cap):
        self.calls.append(("set_fleet_window_cap", cap))
        self._cap = cap


class _Sentinel:
    def __init__(self, calls):
        self.calls = calls
        self.hits, self.dirty = [], []

    def check(self):
        self.calls.append(("sentinel.check",))
        hits, self.hits = self.hits, []
        return hits

    def breached(self):
        return list(self.dirty)


def _strag(conn, observed=900.0, stable=None):
    hit = {"band": "fleet_straggler", "client_id": conn, "observed": observed}
    if stable:
        hit["client"] = stable
    return hit


def _ack(observed=700.0):
    return {"band": "fleet_ack_p99", "observed": observed}


#: (controller kwargs, polls); a poll is (new hits, still-breached bands,
#: seconds the clock moves before it, the timeline's span, timeline active)
SCRIPTS = {
    "straggler_point_poll": ({"recovery_checks": 3}, [
        ([_strag("c1")], ["fleet_straggler:c1"], 1, 0, False),
        ([], ["fleet_straggler:c1"], 1, 0, False),
        ([], [], 1, 0, False), ([], [], 1, 0, False), ([], [], 1, 0, False),
        ([], [], 1, 0, False)]),
    "already_pinned_and_second_client": ({"recovery_checks": 2}, [
        ([_strag("c1")], [], 1, 0, False),
        ([_strag("c1"), _strag("c2", stable="worker-2")], ["fleet_straggler:c2"], 1, 0, False),
        ([], ["fleet_straggler:c2"], 1, 0, False),
        ([], [], 1, 0, False), ([], [], 1, 0, False), ([], [], 1, 0, False)]),
    "ghost_and_no_connection": ({"recovery_checks": 2}, [
        ([_strag("conn-ghost"), _strag("c9")], [], 1, 0, False),
        ([], [], 1, 0, False), ([], [], 1, 0, False)]),
    "window_cap_ladder": ({"recovery_checks": 2, "cap_floor": 1}, [
        ([_ack()], ["fleet_ack_p99"], 1, 0, False),
        ([_ack()], ["fleet_ack_p99"], 1, 0, False),
        ([_ack()], ["fleet_ack_p99"], 1, 0, False),  # at the floor: nothing
        ([], [], 1, 0, False), ([], [], 1, 0, False), ([], [], 1, 0, False),
        ([], [], 1, 0, False), ([], [], 1, 0, False), ([], [], 1, 0, False)]),
    "mixed_bands": ({"recovery_checks": 1, "topk_boost": 20.0, "straggler_window": 2}, [
        ([_strag("c3"), _ack(650.0)], ["fleet_straggler:c3", "fleet_ack_p99"], 1, 0, False),
        ([], ["fleet_ack_p99"], 1, 0, False),
        ([], [], 1, 0, False), ([], [], 1, 0, False)]),
    "trend_recovery": ({"recovery_checks": 1, "recovery_window_s": 10.0}, [
        ([_strag("c1"), _ack()], [], 0, 0.0, True),
        ([], [], 4, 4.0, True),      # clean, but not for 10 s yet
        ([], [], 7, 4.0, True),      # 11 s of clock, the timeline saw 4
        # the cap's window is full: it ramps; the straggler is dirty again
        ([], ["fleet_straggler:c1"], 1, 12.0, True),
        ([], [], 5, 17.0, True),
        ([], [], 11, 28.0, True),    # the straggler's restarted window is full
        ([], [], 11, 39.0, True)]),
}


def _run(module, kwargs, polls, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(module, "time", SimpleNamespace(time=clock.time))
    server = _Server()
    sentinel = _Sentinel(server.calls)
    ctrl = module.AdaptiveController(server, sentinel, **kwargs)
    steps = []
    for hits, dirty, dt, span, active in polls:
        clock.now += dt
        server.telemetry.timeline.span = span
        server.telemetry.timeline.active = active
        sentinel.hits, sentinel.dirty = list(hits), list(dirty)
        steps.append(ctrl.step())
    return {"calls": server.calls, "steps": steps, "actions": ctrl.actions(),
            "adaptations": ctrl.adaptations, "ramps": ctrl.ramps,
            "overrides": server.override_ids(), "cap": server.fleet_window_cap}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_same_calls_as_jax(name, monkeypatch):
    kwargs, polls = SCRIPTS[name]
    want = _run(jax_controller, kwargs, polls, monkeypatch)
    got = _run(port_controller, kwargs, polls, monkeypatch)
    assert got == want
    assert want["calls"], name


def test_scripts_reach_every_rung(monkeypatch):
    """The scripts are not vacuous: each rung and each ramp happens."""
    out = {n: _run(port_controller, *SCRIPTS[n], monkeypatch) for n in SCRIPTS}
    assert out["straggler_point_poll"]["adaptations"] == 1
    assert out["straggler_point_poll"]["ramps"] == 1
    assert out["already_pinned_and_second_client"]["adaptations"] == 2
    assert out["ghost_and_no_connection"]["adaptations"] == 1  # worker-9 only
    assert out["ghost_and_no_connection"]["ramps"] == 1        # a ghost counts as clean
    caps = [c[1] for c in out["window_cap_ladder"]["calls"] if c[0] == "set_fleet_window_cap"]
    assert caps == [2, 1, 2, None]  # doubled back to the base window 4: uncapped
    assert out["mixed_bands"]["overrides"] == [] and out["mixed_bands"]["cap"] is None
    trend = out["trend_recovery"]
    ramps_at = [i for i, s in enumerate(trend["steps"]) if any(a["action"] == "ramp" for a in s)]
    assert ramps_at == [3, 5], trend["steps"]
    assert trend["ramps"] == 2 and trend["overrides"] == [] and trend["cap"] is None
