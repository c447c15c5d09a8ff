"""Port of ``distriflow_tpu/fleet/ring.py`` (copied with its imports rewritten).

Consistent hash ring: prefix -> replica placement that survives churn.

The round-19 elastic-fleet keystone (Karger et al., "Consistent Hashing
and Random Trees"). Each member contributes ``vnodes`` deterministic
points on a 64-bit ring — ``sha1(f"{name}#{i}")`` — and a key (a chain
hash from ``fleet/prefix_hash.py``) maps to the first member point at or
clockwise past ``sha1(key)``. Placement is therefore a **pure function
of the live membership set**: two routers holding the same member names
compute identical placements with no shared state, and a join/leave
remaps only the arcs adjacent to the changed member's points — an
expected ``1/N`` of the key space, which is the whole reason the warm
prefix set survives membership churn (``tests/test_fleet_elastic.py``
pins the bound as a property test over memberships).

The ring is membership + arithmetic, nothing else: no liveness, no
load, no locks (the owning :class:`~distriflow_tpu_torch.fleet.router.
FleetRouter` mutates it under its registry transitions and reads are
idempotent on a consistent snapshot of ``_points``). ``epoch``
increments on every membership change so snapshots and membership
events (``ring_membership`` payloads, ``comm/schema.py``) can be
ordered without timestamps.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Dict, Iterable, List, Tuple

__all__ = ["HashRing", "DEFAULT_VNODES"]

#: virtual nodes per member. 64 keeps the per-member arc-share standard
#: deviation near 12% of fair share at small N (the doctor drill's
#: 3-replica fleet) while membership ops stay O(vnodes log points).
DEFAULT_VNODES = 64

_SPACE = 1 << 64


def _point(data: bytes) -> int:
    """A position on the 64-bit ring (first 8 sha1 bytes, big-endian)."""
    return int.from_bytes(hashlib.sha1(data).digest()[:8], "big")


class HashRing:
    """Deterministic consistent-hash ring over member names."""

    def __init__(self, vnodes: int = DEFAULT_VNODES):
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self.vnodes = int(vnodes)
        self.epoch = 0
        # sorted (point, name); ties are impossible in practice (64-bit
        # sha1 prefixes) and harmless if they happen (stable tuple order)
        self._points: List[Tuple[int, str]] = []
        self._members: Dict[str, List[int]] = {}

    # -- membership ----------------------------------------------------------

    def members(self) -> List[str]:
        return sorted(self._members)

    def __len__(self) -> int:
        return len(self._members)

    def __contains__(self, name: str) -> bool:
        return name in self._members

    def add(self, name: str) -> bool:
        """Insert ``name``'s vnode points. Returns False when already a
        member (idempotent — membership sync re-adds freely)."""
        if name in self._members:
            return False
        pts = [_point(f"{name}#{i}".encode()) for i in range(self.vnodes)]
        for p in pts:
            bisect.insort(self._points, (p, name))
        self._members[name] = pts
        self.epoch += 1
        return True

    def remove(self, name: str) -> bool:
        """Drop ``name``'s points. Returns False when not a member."""
        pts = self._members.pop(name, None)
        if pts is None:
            return False
        for p in pts:
            i = bisect.bisect_left(self._points, (p, name))
            if i < len(self._points) and self._points[i] == (p, name):
                del self._points[i]
        self.epoch += 1
        return True

    def sync(self, names: Iterable[str]) -> bool:
        """Make membership exactly ``names`` (set-diff add/remove, so the
        surviving members' points never move). Returns True on change."""
        want = set(names)
        changed = False
        for name in [n for n in self._members if n not in want]:
            changed |= self.remove(name)
        for name in sorted(want - set(self._members)):
            changed |= self.add(name)
        return changed

    # -- placement -----------------------------------------------------------

    def lookup(self, key: bytes, n: int = 1) -> List[str]:
        """The first ``n`` DISTINCT members clockwise from ``key``'s ring
        position: ``[primary, hedge, ...]``. Fewer when the ring holds
        fewer members; empty on an empty ring."""
        if not self._points or n < 1:
            return []
        want = min(n, len(self._members))
        # first member point at or clockwise past the key's position
        start = bisect.bisect_left(self._points, (_point(key), ""))
        out: List[str] = []
        for off in range(len(self._points)):
            name = self._points[(start + off) % len(self._points)][1]
            if name not in out:
                out.append(name)
                if len(out) == want:
                    break
        return out

    def primary(self, key: bytes) -> str:
        """Convenience: ``lookup(key, 1)[0]`` (raises on an empty ring)."""
        owners = self.lookup(key, 1)
        if not owners:
            raise LookupError("hash ring has no members")
        return owners[0]

    def arc_share(self, name: str) -> float:
        """Fraction of the key space ``name``'s points own (a key belongs
        to the first point clockwise, so a point owns the arc from its
        predecessor). The autoscaler's coldest-arc tie-break."""
        if name not in self._members or not self._points:
            return 0.0
        if len(self._members) == 1:
            return 1.0
        owned = 0
        for i, (p, nm) in enumerate(self._points):
            if nm != name:
                continue
            prev = self._points[i - 1][0]
            owned += (p - prev) % _SPACE or _SPACE
        return owned / float(_SPACE)

    def assignment(self, keys: Iterable[bytes]) -> Dict[bytes, str]:
        """Primary owner for every key — the warm-set snapshot the remap
        bound is measured against (bench ``serving_elastic`` and the
        churn property test diff two of these across a membership
        event)."""
        return {k: self.primary(k) for k in keys}
