"""Port of ``distriflow_tpu/obs/timeline.py``: the no-op timeline only.

``Telemetry.timeline`` hands this shared store out until a timeline is
started, so event call sites (``telemetry.timeline.event(...)`` on the
servers' quarantine, rollback, resync and lease-expiry paths) cost
nothing. The windowed ``TimelineStore`` itself is not ported yet.
"""

from __future__ import annotations

from typing import Any, List, Mapping, Optional


class _NoopTimeline:
    """Shared no-op store handed out by disabled/unstarted telemetry."""

    __slots__ = ()

    active = False
    interval_s = 0.0

    def start(self) -> "_NoopTimeline":
        return self

    def stop(self, final_sample: bool = True) -> None:
        pass

    def sample(self, now: Optional[float] = None) -> None:
        return None

    def add_sample(self, t: float, counters: Mapping[str, float],
                   gauges: Mapping[str, float],
                   hists: Optional[Mapping[str, Any]] = None) -> None:
        return None

    def event(self, kind: str, t: Optional[float] = None,
              **fields: Any) -> None:
        return None

    def samples(self, window_s: Optional[float] = None) -> List[Any]:
        return []

    def events(self, window_s: Optional[float] = None) -> List[Any]:
        return []

    def span_s(self) -> float:
        return 0.0

    def rate(self, ident: str, window_s: Optional[float] = None) -> None:
        return None

    def delta(self, ident: str, window_s: Optional[float] = None) -> None:
        return None

    def gauge_stats(self, ident: str,
                    window_s: Optional[float] = None) -> None:
        return None

    def hist_delta(self, ident: str,
                   window_s: Optional[float] = None) -> None:
        return None

    def quantile(self, ident: str, q: float,
                 window_s: Optional[float] = None) -> None:
        return None

    def window_summary(self, ident: str,
                       window_s: Optional[float] = None) -> None:
        return None

    def series(self, ident: str, stat: str = "value",
               window_s: Optional[float] = None) -> List[Any]:
        return []

    def slope(self, ident: str, stat: str = "value",
              window_s: Optional[float] = None) -> None:
        return None


NOOP_TIMELINE = _NoopTimeline()
