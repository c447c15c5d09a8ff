"""Port of ``distriflow_tpu/fleet``: the serving fleet.

``FleetRouter`` fronts independent ``InferenceServer`` replicas with
prefix-affinity, round-robin, least-loaded or consistent-ring placement
(``HashRing`` over the prompt chain hash of ``prefix_hash.py``),
SLO-tiered shedding, drain/failover under one ``request_id``, probation
revival and tier-scoped hedging; ``RouterClient`` is its tier-aware
client and ``FleetAutoscaler`` moves membership on sustained SLO breaches
and shed pressure. The training-fleet soak and ``AdaptiveController`` are
not ported yet.
"""

from distriflow_tpu_torch.fleet.client import RouterClient
from distriflow_tpu_torch.fleet.controller import FleetAutoscaler
from distriflow_tpu_torch.fleet.prefix_hash import page_hashes, shareable_pages
from distriflow_tpu_torch.fleet.registry import ReplicaRegistry, ReplicaState
from distriflow_tpu_torch.fleet.ring import HashRing
from distriflow_tpu_torch.fleet.router import FleetRouter

__all__ = [
    "FleetAutoscaler",
    "FleetRouter",
    "HashRing",
    "RouterClient",
    "ReplicaRegistry",
    "ReplicaState",
    "page_hashes",
    "shareable_pages",
]
