"""Port of ``distriflow_tpu/fleet/client.py`` (copied with its imports rewritten).

Router client shim: an :class:`InferenceClient` that speaks SLO tiers.

The router's front door IS the server protocol, so a plain
``InferenceClient`` pointed at a :class:`FleetRouter` already works;
this shim adds the fleet niceties — a default priority tier stamped on
every generate, optional bounded retry-with-backoff on
:class:`RequestShed` (a shed is backpressure, not failure), and a
``last_replica``/``last_route`` view of the routing decision the ack's
serving metadata carried back.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np

from distriflow_tpu_torch.client.inference_client import (
    InferenceClient,
    RequestShed,
)


class RouterClient(InferenceClient):
    """Tier-aware client for a :class:`FleetRouter` front door."""

    def __init__(self, address: str, tier: int = 1, shed_retries: int = 0,
                 shed_backoff_s: float = 0.05, **kwargs: Any):
        super().__init__(address, **kwargs)
        self.tier = int(tier)
        self.shed_retries = int(shed_retries)
        self.shed_backoff_s = float(shed_backoff_s)

    @property
    def last_route(self) -> Optional[Dict[str, Any]]:
        """Routing metadata from the last generate ack (replica name,
        affinity depth, failover count, tier), or None."""
        meta = self.last_serving_meta
        if isinstance(meta, dict):
            return meta.get("router")
        return None

    @property
    def last_replica(self) -> Optional[str]:
        route = self.last_route
        return route.get("replica") if route else None

    def generate(self, prompt: np.ndarray, n_tokens: int,
                 tier: Optional[int] = None, **kwargs: Any) -> np.ndarray:
        """Routed generate at ``tier`` (default: the client's tier).
        Sheds are retried ``shed_retries`` times with linear backoff —
        attempt ``i`` sleeps ``i * shed_backoff_s`` — then re-raised."""
        t = self.tier if tier is None else int(tier)
        attempt = 0
        while True:
            try:
                return super().generate(prompt, n_tokens, tier=t, **kwargs)
            except RequestShed:
                attempt += 1
                if attempt > self.shed_retries:
                    raise
                time.sleep(attempt * self.shed_backoff_s)
