"""Port of ``distriflow_tpu/fleet``: the serving fleet.

``FleetRouter`` fronts independent ``InferenceServer`` replicas with
prefix-affinity, round-robin, least-loaded or consistent-ring placement
(``HashRing`` over the prompt chain hash of ``prefix_hash.py``),
SLO-tiered shedding, drain/failover under one ``request_id``, probation
revival and tier-scoped hedging; ``RouterClient`` is its tier-aware
client and ``FleetAutoscaler`` moves membership on sustained SLO breaches
and shed pressure. ``run_soak`` drives a fleet of simulated training
clients through churn and chaos and audits exactly-once accounting at
quiescence; ``AdaptiveController`` steers that fleet's per-client
hyperparams and dispatch window from the health sentinel's breaches.
"""

from distriflow_tpu_torch.fleet.client import RouterClient
from distriflow_tpu_torch.fleet.controller import AdaptiveController, FleetAutoscaler
from distriflow_tpu_torch.fleet.prefix_hash import page_hashes, shareable_pages
from distriflow_tpu_torch.fleet.registry import ReplicaRegistry, ReplicaState
from distriflow_tpu_torch.fleet.ring import HashRing
from distriflow_tpu_torch.fleet.router import FleetRouter
from distriflow_tpu_torch.fleet.soak import (
    SoakConfig,
    SoakError,
    SoakModel,
    SoakResult,
    run_soak,
)

__all__ = [
    "AdaptiveController",
    "FleetAutoscaler",
    "FleetRouter",
    "HashRing",
    "RouterClient",
    "ReplicaRegistry",
    "ReplicaState",
    "SoakConfig",
    "SoakError",
    "SoakModel",
    "SoakResult",
    "page_hashes",
    "run_soak",
    "shareable_pages",
]
