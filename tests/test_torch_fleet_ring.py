"""Port parity: the consistent hash ring (``distriflow_tpu_torch/fleet/ring.py``).

Placement is sha1 arithmetic over member names, so the port's ring must
equal the JAX package's bit for bit: ``lookup(key, n)``, ``primary``,
``arc_share``, ``epoch`` and ``assignment`` over seeded memberships and
keys, through joins, leaves and ``sync``. The 1/N remap bound and
``bench.py::bench_serving_elastic``'s remap fractions (a join of D and a
leave of A from ``HashRing(256)`` over A/B/C and ``warmset-0..1999``) are
pinned against JAX's ring; ``chip_smoke.py``'s ``fleet:`` phase checks the
same two fractions on the card.
"""

import math

import numpy as np
import pytest

from distriflow_tpu.fleet.ring import DEFAULT_VNODES as JAX_VNODES
from distriflow_tpu.fleet.ring import HashRing as JaxRing
from distriflow_tpu_torch.fleet import HashRing
from distriflow_tpu_torch.fleet.ring import DEFAULT_VNODES

pytestmark = pytest.mark.port

# bench_serving_elastic's remap fractions, from JAX's ring (sha1: exact)
ELASTIC_JOIN_FRAC = 0.2515
ELASTIC_LEAVE_FRAC = 0.3475


def _keys(rng, n):
    return [rng.bytes(20) for _ in range(n)]


def _same(port, ref, keys):
    assert port.members() == ref.members()
    assert port.epoch == ref.epoch
    assert len(port) == len(ref)
    for k in keys:
        for n in (1, 2, 3, len(ref) + 2):
            assert port.lookup(k, n) == ref.lookup(k, n)
    for name in ref.members() + ["ghost"]:
        assert port.arc_share(name) == ref.arc_share(name)  # bit for bit
    if not len(ref):  # an empty ring places nothing: both raise
        for ring in (port, ref):
            with pytest.raises(LookupError):
                ring.assignment(keys[:1])
        return
    assert port.assignment(keys) == ref.assignment(keys)


def test_default_vnodes_match():
    assert DEFAULT_VNODES == JAX_VNODES == 64


@pytest.mark.parametrize("seed,vnodes", [(0, 64), (1, 8), (2, 256), (3, 1)])
def test_placement_bit_for_bit_vs_jax(seed, vnodes):
    """Seeded memberships and keys through adds, removes and syncs: every
    placement, arc share and epoch equals JAX's."""
    rng = np.random.default_rng(seed)
    keys = _keys(rng, 300)
    port, ref = HashRing(vnodes), JaxRing(vnodes)
    _same(port, ref, keys)  # empty ring
    names = [f"replica-{i}" for i in rng.permutation(8)]
    for nm in names[:5]:
        assert port.add(nm) == ref.add(nm)
        _same(port, ref, keys)
    assert port.add(names[0]) is ref.add(names[0]) is False  # idempotent
    for nm in (names[2], "ghost", names[4]):
        assert port.remove(nm) == ref.remove(nm)
        _same(port, ref, keys)
    want = list(rng.choice(names, size=4, replace=False))
    assert port.sync(want) == ref.sync(want)
    _same(port, ref, keys)
    assert port.sync(want) is ref.sync(want) is False  # no-op sync
    assert port.primary(keys[0]) == ref.primary(keys[0])


def test_remap_bound_on_join_and_leave():
    """The JAX suite's property: a single join or leave moves at most
    1/N + 0.5/sqrt(vnodes) of the key space, only to the joiner or away
    from the leaver, and the port moves exactly the keys JAX moves."""
    keys = [f"chain-hash-{i}".encode() for i in range(1500)]
    for n in range(2, 9):
        port, ref = HashRing(), JaxRing()
        for i in range(n):
            port.add(f"m{i}")
            ref.add(f"m{i}")
        slack = 0.5 / math.sqrt(port.vnodes)
        base = port.assignment(keys)
        port.add("joiner")
        ref.add("joiner")
        after = port.assignment(keys)
        assert after == ref.assignment(keys)
        moved = [k for k in keys if after[k] != base[k]]
        assert len(moved) / len(keys) <= 1.0 / (n + 1) + slack
        assert all(after[k] == "joiner" for k in moved)
        port.remove("joiner")
        ref.remove("joiner")
        assert port.assignment(keys) == base
        port.remove("m0")
        ref.remove("m0")
        after = port.assignment(keys)
        assert after == ref.assignment(keys)
        moved = [k for k in keys if after[k] != base[k]]
        assert len(moved) / len(keys) <= 1.0 / n + slack
        assert all(base[k] == "m0" for k in moved)


def _elastic_fractions(ring_cls):
    ring = ring_cls(256)
    ring.sync(["A", "B", "C"])
    keys = [f"warmset-{i}".encode() for i in range(2000)]
    base = ring.assignment(keys)
    ring.add("D")
    join = sum(1 for k, v in ring.assignment(keys).items() if v != base[k]) / len(keys)
    ring.remove("D")
    assert ring.assignment(keys) == base
    ring.remove("A")
    leave = sum(1 for k, v in ring.assignment(keys).items() if v != base[k]) / len(keys)
    return join, leave


def test_elastic_bench_remap_fractions_pinned():
    assert _elastic_fractions(JaxRing) == (ELASTIC_JOIN_FRAC, ELASTIC_LEAVE_FRAC)
    assert _elastic_fractions(HashRing) == (ELASTIC_JOIN_FRAC, ELASTIC_LEAVE_FRAC)


def test_ring_invariants():
    ring = HashRing()
    for nm in ("A", "B", "C"):
        ring.add(nm)
    assert math.isclose(sum(ring.arc_share(n) for n in ring.members()), 1.0)
    owners = ring.lookup(b"some-chain-hash", n=3)
    assert sorted(owners) == ["A", "B", "C"]
    assert ring.lookup(b"some-chain-hash", n=99) == owners
    solo = HashRing(vnodes=8)
    solo.add("only")
    assert solo.arc_share("only") == 1.0
    assert HashRing().lookup(b"x") == []
    with pytest.raises(LookupError):
        HashRing().primary(b"x")
    with pytest.raises(ValueError):
        HashRing(0)
