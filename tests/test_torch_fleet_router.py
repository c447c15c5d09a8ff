"""Port parity: the serving fleet (``distriflow_tpu_torch/fleet``) in front of
port replicas on the CPU.

The cases of ``tests/test_fleet_router.py`` and ``tests/test_fleet_elastic.py``
run against port ``InferenceServer`` replicas behind the port's
``FleetRouter``, with weights carried over from the JAX package by
``lm_from_jax``; every routed greedy stream must equal the JAX package's
``generate`` on the same weights token for token:

- the shared chain hash, the server's row plan, routed bit-identity under
  affinity, affinity against round-robin on shared prefixes, a wrong
  affinity hint, shadow eviction, shedding and admission under queue
  pressure, drain refusal and failover, a whole-fleet drain, a replica
  killed mid-decode (exactly once), in-flight request-id dedup, the
  snapshot and metrics;
- ring placement, the churn kill / probation revival with one trace round
  per request and zero orphan spans, hedging suppressed exactly once,
  the jittered probation backoff (from a seeded ``rng``), the autoscaler
  over a scripted sentinel, and the warm shadow rebuilt from
  ``warm_prefixes``;
- across packages over loopback: a JAX ``FleetRouter`` in front of port
  replicas and a port ``FleetRouter`` in front of JAX ``InferenceServer``s
  give the same tokens, the same ``last_route`` and the same shed and
  refusal behaviour as the port's router in front of port replicas.
"""

import random
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distriflow_tpu.client import RequestRefused as JaxRefused
from distriflow_tpu.client import RequestShed as JaxShed
from distriflow_tpu.fleet import FleetRouter as JaxRouter
from distriflow_tpu.fleet import RouterClient as JaxRouterClient
from distriflow_tpu.fleet.registry import ReplicaRegistry as JaxRegistry
from distriflow_tpu.models.generate import generate as jax_generate
from distriflow_tpu.models.transformer import TransformerConfig as JaxConfig
from distriflow_tpu.models.transformer import transformer_lm
from distriflow_tpu.obs.telemetry import Telemetry as JaxTelemetry
from distriflow_tpu.server import InferenceServer as JaxServer
from distriflow_tpu.utils.config import ServingConfig as JaxServingConfig
from distriflow_tpu_torch.client import InferenceClient, RequestRefused, RequestShed
from distriflow_tpu_torch.comm.transport import FaultPlan, ScriptedFault
from distriflow_tpu_torch.fleet import (
    FleetAutoscaler,
    FleetRouter,
    RouterClient,
    page_hashes,
    shareable_pages,
)
from distriflow_tpu_torch.fleet.registry import PROBE_BASE_S, PROBE_MAX_S, ReplicaRegistry
from distriflow_tpu_torch.models.convert import lm_from_jax
from distriflow_tpu_torch.models.transformer import TransformerConfig
from distriflow_tpu_torch.obs.telemetry import Telemetry
from distriflow_tpu_torch.obs.trace_assembler import assemble
from distriflow_tpu_torch.server import InferenceServer
from distriflow_tpu_torch.utils.config import ServingConfig

pytestmark = pytest.mark.port
torch.set_num_threads(2)

JCFG = JaxConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=48,
                 dtype=jnp.float32, use_flash_attention=False, use_flash_decode=False)
PCFG = TransformerConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=48,
                         dtype=torch.float32, use_flash_attention=False, use_flash_decode=False)
PS = 16  # 3 pages per slot
SERVING = dict(batch_window_s=0.05, decode_chunk=4, kv_layout="paged", page_size=PS,
               max_slots=2, page_pool_pages=24)


@pytest.fixture(scope="module")
def params():
    p = transformer_lm(JCFG, example_seq=16).init(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, p)


@pytest.fixture(scope="module")
def model(params):
    return lm_from_jax(PCFG, params, device="cpu")


_SOLO = {}


def _solo(params, prompt, n):
    """The JAX package's greedy ``generate`` on the same weights (cached)."""
    key = (prompt.tobytes(), prompt.shape, n)
    if key not in _SOLO:
        _SOLO[key] = np.asarray(jax_generate(JCFG, params, jnp.asarray(prompt), n))
    return _SOLO[key]


def _replica(model, telemetry, **serving_kw):
    return InferenceServer(model, port=0, telemetry=telemetry,
                           serving=ServingConfig(**{**SERVING, **serving_kw})).setup()


def _router(**kw):
    kw.setdefault("stats_interval_s", 0.0)  # tests drive refresh_stats
    kw.setdefault("redial", False)
    kw.setdefault("telemetry", Telemetry())
    kw.setdefault("rng", random.Random(0))
    return FleetRouter(port=0, **kw)


@pytest.fixture()
def fleet(model):
    """Two paged port replicas with private telemetry plus a router factory."""
    tel_a, tel_b = Telemetry(), Telemetry()
    sa, sb = _replica(model, tel_a), _replica(model, tel_b)
    made = []

    def mk_router(**kw):
        plan_a = kw.pop("fault_plan_a", None)
        router = _router(**kw)
        router.add_replica(sa.address, name="A", fault_plan=plan_a)
        router.add_replica(sb.address, name="B")
        made.append(router)
        return router.setup()

    yield sa, sb, tel_a, tel_b, mk_router
    for router in made:
        router.stop()
    sa.stop()
    sb.stop()


@pytest.fixture()
def trio(model, tmp_path):
    """Three port replicas and their router on ONE telemetry, so every span
    of a request lands in one tracer."""
    tel = Telemetry(save_dir=str(tmp_path))
    servers = [_replica(model, tel) for _ in range(3)]
    made = []

    def mk_router(**kw):
        plan_a = kw.pop("fault_plan_a", None)
        kw.setdefault("telemetry", tel)
        router = _router(**kw)
        for name, s in zip("ABC", servers):
            router.add_replica(s.address, name=name, fault_plan=plan_a if name == "A" else None)
        made.append(router)
        return router.setup()

    yield servers, tel, mk_router
    for router in made:
        router.stop()
    for s in servers:
        s.stop()


def _prompt(seed, plen=33, batch=1):
    rng = np.random.default_rng(seed)
    return rng.integers(1, PCFG.vocab_size, size=(batch, plen)).astype(np.int32)


def _owned_prompt(ring, owner, plen=33, start_seed=0):
    for seed in range(start_seed, start_seed + 4096):
        p = _prompt(seed, plen=plen)
        if ring.primary(page_hashes(p[0], PS)[0]) == owner:
            return p
    raise AssertionError(f"no prompt owned by {owner} in 4096 seeds")


# -- the chain hash -------------------------------------------------------------


def test_golden_chain_hash_and_shareable_pages():
    hashes = page_hashes(np.arange(40, dtype=np.int32), 16)
    assert [h.hex() for h in hashes] == [
        "0e084ffc26a48083caf4f0c48b4f4750fd4e4cb2",
        "960bd526e93cb085d008d0d285ffba8aa18df024",
    ]
    assert page_hashes(np.arange(40, dtype=np.int64), 16) == hashes
    assert [shareable_pages(n, 16) for n in (16, 17, 32, 33)] == [0, 1, 1, 2]


def test_server_row_plan_uses_shared_hash(fleet):
    sa, *_ = fleet
    tokens = _prompt(7)[0]
    _shared, hashes = sa._row_plan(tokens)
    assert hashes == page_hashes(tokens, PS)
    assert len(hashes) == shareable_pages(len(tokens), PS)


def test_router_hashes_a_tensor_row_like_jax():
    """A bf16 prompt deserializes to a CPU tensor in the port; the router
    hashes its values as the int32 row JAX hashes."""
    from distriflow_tpu_torch.utils.serialization import pack_bytes, serialize_array

    router = _router()
    state = router.registry.add("A", "127.0.0.1:1")
    state.alive = True
    state.stats = {"prefix_sharing": True, "page_size": PS}
    tokens = _prompt(3)
    for arr in (tokens, torch.as_tensor(tokens).to(torch.bfloat16)):
        payload = {"prompt": pack_bytes({"tokens": serialize_array(arr)})}
        assert router._prompt_hashes(payload) == page_hashes(tokens[0], PS)


# -- routed decode ----------------------------------------------------------------


def test_two_replica_bit_identity_vs_jax_generate(fleet, params):
    *_, mk_router = fleet
    router = mk_router(policy="affinity")
    with RouterClient(router.address) as c:
        for seed, n in ((1, 6), (2, 3), (3, 8)):
            prompt = _prompt(seed)
            out = c.generate(prompt, n)
            np.testing.assert_array_equal(out, _solo(params, prompt, n))
            assert c.last_route is not None and c.last_replica in ("A", "B")


def test_affinity_beats_round_robin_on_shared_prefix(fleet, params):
    sa, sb, *_rest, mk_router = fleet

    def run_leg(policy):
        before = sa.prefix_hits + sb.prefix_hits
        router = mk_router(policy=policy)
        with RouterClient(router.address) as c:
            for _rep in range(4):
                for group in (10, 11, 12):
                    prompt = _prompt(group)
                    np.testing.assert_array_equal(c.generate(prompt, 4), _solo(params, prompt, 4))
        router.stop()
        return sa.prefix_hits + sb.prefix_hits - before

    hits_rr = run_leg("round_robin")
    sa.release_prefix_cache()
    sb.release_prefix_cache()
    hits_aff = run_leg("affinity")
    assert (hits_aff, hits_rr) == (9, 6)


def test_wrong_affinity_hint_is_harmless(fleet, params):
    *_, mk_router = fleet
    router = mk_router(policy="affinity")
    prompt = _prompt(21)
    router.registry.learn("B", page_hashes(prompt[0], PS))
    with RouterClient(router.address) as c:
        out = c.generate(prompt, 5)
        assert c.last_replica == "B" and c.last_route["affinity_depth"] == 2
        np.testing.assert_array_equal(out, _solo(params, prompt, 5))


def test_release_prefix_cache_evicts_router_shadow(fleet):
    sa, sb, _ta, _tb, mk_router = fleet
    router = mk_router(policy="affinity")
    prompt = _prompt(31)
    hashes = page_hashes(prompt[0], PS)
    with RouterClient(router.address) as c:
        c.generate(prompt, 4)
        warm = c.last_replica
    assert router.registry.warmth(warm, hashes) == len(hashes) == 2
    (sa if warm == "A" else sb).release_prefix_cache()
    router.refresh_stats()
    assert router.registry.warmth(warm, hashes) == 0


def test_shed_then_admit_under_queue_pressure(fleet, params):
    sa, sb, *_rest, mk_router = fleet
    router = mk_router(policy="least_loaded", shed_depth={2: 0})

    def block(server, i):
        with InferenceClient(server.address) as c:
            c.generate(_prompt(40 + i, plen=16), 30)

    blockers = []
    for server in (sa, sb):
        for i in range(sa.serving.max_slots + 2):
            t = threading.Thread(target=block, args=(server, i))
            t.start()
            blockers.append(t)
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline:
        if (sa._queue.qsize() + len(sa._backlog) > 0
                and sb._queue.qsize() + len(sb._backlog) > 0):
            break
        time.sleep(0.005)
    router.refresh_stats()
    with RouterClient(router.address, tier=2) as c:
        prompt = _prompt(50)
        with pytest.raises(RequestShed) as exc:
            c.generate(prompt, 3)
        assert exc.value.tier == 2 and exc.value.queue_depth > 0
        np.testing.assert_array_equal(c.generate(prompt, 3, tier=0), _solo(params, prompt, 3))
        for t in blockers:
            t.join(timeout=120.0)
        router.refresh_stats()
        np.testing.assert_array_equal(c.generate(prompt, 3), _solo(params, prompt, 3))
        assert router._tel.counter_value("router_shed_total", tier="2") == 1.0


def test_drain_refusal_and_failover(fleet, params):
    sa, sb, _ta, _tb, mk_router = fleet
    router = mk_router(policy="affinity")
    prompt = _prompt(60)
    with RouterClient(router.address) as c:
        c.generate(prompt, 4)
        warm = c.last_replica
        warm_server = sa if warm == "A" else sb
        warm_server.begin_drain()
        try:
            with InferenceClient(warm_server.address) as direct:
                with pytest.raises(RequestRefused):
                    direct.generate(prompt, 4)
            out = c.generate(prompt, 4)
            assert c.last_replica != warm and c.last_route["failovers"] == 1
            np.testing.assert_array_equal(out, _solo(params, prompt, 4))
        finally:
            warm_server.end_drain()


def test_whole_fleet_drain_is_structured_refusal(fleet, params):
    sa, sb, _ta, _tb, mk_router = fleet
    router = mk_router(policy="affinity")
    prompt = _prompt(65)
    sa.begin_drain()
    sb.begin_drain()
    try:
        with RouterClient(router.address) as c:
            with pytest.raises(RequestRefused):
                c.generate(prompt, 4)
    finally:
        sa.end_drain()
        sb.end_drain()
    assert router._tel.counter_value("router_requests_total", tier="1") == 0.0
    router.refresh_stats()
    with RouterClient(router.address) as c:
        np.testing.assert_array_equal(c.generate(prompt, 4), _solo(params, prompt, 4))
    assert router._tel.counter_value("router_requests_total", tier="1") == 1.0


def _wait_mid_decode(server):
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline:
        if any(r is not None for r in server._slot_req):
            return
        time.sleep(0.002)


def test_faultplan_kill_mid_decode_exactly_once(fleet, params):
    sa, sb, _ta, _tb, mk_router = fleet
    plan = FaultPlan(seed=13, schedule=[ScriptedFault(event="generate", nth=3, action="reset")])
    router = mk_router(policy="affinity", fault_plan_a=plan)
    shared = _prompt(70)
    with RouterClient(router.address) as c:
        c.generate(shared, 3)
        assert c.last_replica == "A"
        results = {}
        long_prompt = shared[:, :17]

        def long_decode():
            with RouterClient(router.address) as cl:
                results["long"] = (cl.generate(long_prompt, 31, seed=0), cl.last_route)

        t = threading.Thread(target=long_decode)
        t.start()
        _wait_mid_decode(sa)
        out = c.generate(shared, 5)
        t.join(timeout=120.0)
        assert not t.is_alive()
        assert c.last_replica == "B" and c.last_route["failovers"] >= 1
        np.testing.assert_array_equal(out, _solo(params, shared, 5))
        long_out, long_route = results["long"]
        assert long_route["replica"] == "B"
        np.testing.assert_array_equal(long_out, _solo(params, long_prompt, 31))
        assert router._tel.counter_value("router_failovers_total") >= 2.0
        with InferenceClient(sb.address) as direct:
            first = direct.generate(shared, 5, request_id="replay-proof")
            admitted = sb.batched_requests
            again = direct.generate(shared, 5, request_id="replay-proof")
            np.testing.assert_array_equal(first, again)
            assert sb.batched_requests == admitted  # served from the cache


def test_request_id_dedup_in_flight_gating(fleet, params):
    sa, *_ = fleet
    prompt = _prompt(80, plen=16)
    outs = []

    def call():
        with InferenceClient(sa.address) as c:
            outs.append(c.generate(prompt, 24, request_id="dup-1"))

    before = sa.batched_requests
    threads = [threading.Thread(target=call) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120.0)
    assert len(outs) == 2
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], _solo(params, prompt, 24))
    assert sa.batched_requests - before == 1


def test_router_snapshot_and_metrics(fleet):
    *_, mk_router = fleet
    router = mk_router(policy="affinity")
    with RouterClient(router.address) as c:
        prompt = _prompt(90)
        c.generate(prompt, 3)
        c.generate(prompt, 3)
    snap = router.registry.snapshot()
    assert set(snap) == {"A", "B"}
    assert sum(r["routed"] for r in snap.values()) == 2
    tel = router._tel
    assert tel.counter_value("router_requests_total", tier="1") == 2.0
    assert tel.counter_value("router_affinity_hits_total") == 1.0
    assert tel.gauge("router_replicas_live").value == 2
    row = tel.snapshot()["fleet"]["router"]
    assert row["requests"] == 2 and row["goodput"] == 2 and row["replicas_live"] == 2


# -- the elastic fleet --------------------------------------------------------------


def test_ring_policy_routes_to_arc_owner(fleet, params):
    *_, mk_router = fleet
    router = mk_router(policy="ring")
    with RouterClient(router.address) as c:
        for owner in ("A", "B"):
            p = _owned_prompt(router.ring, owner)
            out = c.generate(p, 4)
            assert c.last_replica == owner
            np.testing.assert_array_equal(out, _solo(params, p, 4))
    snap = router._on_snapshot("t", {})
    assert snap["ring"]["members"] == ["A", "B"]
    assert snap["ring"]["epoch"] == router.ring.epoch
    log = router.ring_membership()
    assert [e["replica"] for e in log if e["event"] == "join"] == ["A", "B"]
    assert [e["epoch"] for e in log] == sorted(e["epoch"] for e in log)


def test_ring_churn_kill_rejoin_bit_identical_zero_orphans(trio, params):
    servers, tel, mk_router = trio
    plan = FaultPlan(seed=13, schedule=[ScriptedFault(event="generate", nth=3, action="reset")])
    router = mk_router(policy="ring", fault_plan_a=plan, redial=True)
    p_warm = _owned_prompt(router.ring, "A")
    p_long = _owned_prompt(router.ring, "A", plen=17)
    with RouterClient(router.address, telemetry=tel) as c:
        np.testing.assert_array_equal(c.generate(p_warm, 3), _solo(params, p_warm, 3))
        assert c.last_replica == "A"
        router.refresh_stats()  # A has served stats: a later dial is a revival
        base_assign = dict(router.ring.assignment(
            [page_hashes(p_warm[0], PS)[0], page_hashes(p_long[0], PS)[0]]))
        results = {}

        def long_decode():
            with RouterClient(router.address, telemetry=tel) as cl:
                results["long"] = (cl.generate(p_long, 31, seed=0), cl.last_route)

        t = threading.Thread(target=long_decode)
        t.start()
        _wait_mid_decode(servers[0])
        out = c.generate(p_warm, 5)
        t.join(timeout=120.0)
        assert not t.is_alive()
        assert c.last_replica != "A" and c.last_route["failovers"] >= 1
        np.testing.assert_array_equal(out, _solo(params, p_warm, 5))
        long_out, long_route = results["long"]
        assert long_route["replica"] != "A"
        np.testing.assert_array_equal(long_out, _solo(params, p_long, 31))
        assert router.ring.members() == ["B", "C"]
        leaves = [e for e in router.ring_membership() if e["event"] == "leave"]
        assert leaves and leaves[-1]["replica"] == "A"
        router.refresh_stats()  # probation: the first re-probe is immediate
        assert router.ring.members() == ["A", "B", "C"]
        assert router.registry.get("A").revivals == 1
        assert tel.counter_value("router_replica_revivals_total") == 1.0
        assert dict(router.ring.assignment(list(base_assign))) == base_assign
        np.testing.assert_array_equal(c.generate(p_warm, 4), _solo(params, p_warm, 4))
        assert c.last_replica == "A"
    asm = assemble(tel.tracer.finished())
    assert asm.orphans == []
    reqs = asm.requests()
    assert len(reqs) == 4 and len({r.attrs["request_id"] for r in reqs}) == 4
    for r in reqs:
        assert r.applied and r.apply_spans == 1
    assert len([r for r in reqs if r.retries >= 1]) == 2


def test_hedge_duplicate_suppressed_exactly_once(model, params):
    tel_a, tel_b = Telemetry(), Telemetry()
    sa = _replica(model, tel_a, batch_window_s=0.25)  # the straggler
    sb = _replica(model, tel_b)
    router = _router(policy="ring", hedge_ms={0: 25.0})
    try:
        router.add_replica(sa.address, name="A")
        router.add_replica(sb.address, name="B")
        router.setup()
        p = _owned_prompt(router.ring, "A")
        assert router.ring.lookup(page_hashes(p[0], PS)[0], n=2) == ["A", "B"]
        with InferenceClient(sb.address) as cl:
            cl.generate(_prompt(999), 3)
        admitted_a, admitted_b = sa.batched_requests, sb.batched_requests
        with RouterClient(router.address, tier=0) as c:
            out = c.generate(p, 3, request_id="hedge-1")
            np.testing.assert_array_equal(out, _solo(params, p, 3))
            assert c.last_replica == "B"
        rtel = router._tel
        assert rtel.counter_value("router_hedges_total") == 1.0
        assert rtel.counter_value("router_hedge_wins_total") == 1.0
        assert tel_a.counter_value("serving_hedge_cancelled_total") == 1.0
        assert sa.batched_requests - admitted_a == 0
        assert sb.batched_requests - admitted_b == 1
        assert tel_a.counter_value("serving_dedup_hits_total") == 0.0
        assert tel_b.counter_value("serving_dedup_hits_total") == 0.0
        with InferenceClient(sb.address) as direct:
            np.testing.assert_array_equal(direct.generate(p, 3, request_id="hedge-1"), out)
            assert sb.batched_requests - admitted_b == 1
        assert tel_b.counter_value("serving_dedup_hits_total") == 1.0
    finally:
        router.stop()
        sa.stop()
        sb.stop()


def _backoff_schedule(registry_cls, rng):
    reg = registry_cls(rng=rng) if rng is not None else registry_cls()
    reg.add("A", "127.0.0.1:0")
    reg.mark_live("A")
    reg.mark_dead("A")
    assert reg.probe_due("A")
    out = []
    for _ in range(8):
        before = time.monotonic()
        reg.note_probe_failure("A")
        r = reg.get("A")
        out.append((r.probe_backoff_s, r.probe_at - before))
        assert not reg.probe_due("A")
    return reg, out


def test_probation_backoff_doubles_with_seeded_jitter():
    reg, sched = _backoff_schedule(ReplicaRegistry, random.Random(7))
    expect = PROBE_BASE_S
    for backoff, delay in sched:
        assert backoff == expect
        assert 0.5 * expect <= delay <= 1.5 * expect + 0.01
        expect = min(PROBE_MAX_S, expect * 2.0)
    assert reg.get("A").probe_backoff_s == PROBE_MAX_S
    # a seeded rng gives the same jitter draws as JAX's module-level random
    # under the same seed
    random.seed(7)
    _, jax_sched = _backoff_schedule(JaxRegistry, None)
    _, again = _backoff_schedule(ReplicaRegistry, random.Random(7))
    for (b0, d0), (b1, d1), (b2, d2) in zip(sched, jax_sched, again):
        assert b0 == b1 == b2
        assert abs(d0 - d1) < 0.01 and abs(d0 - d2) < 0.01
    assert reg.mark_live("A") is False and reg.get("A").revivals == 0  # a join
    reg.update_stats("A", {"queue_depth": 0})
    reg.mark_dead("A")
    assert reg.mark_live("A") is True and reg.get("A").revivals == 1  # a revival
    assert reg.probe_due("A") is False


class _StubSentinel:
    def __init__(self):
        self.hits = []

    def check(self):
        return list(self.hits)


_TTFT_HIT = {"band": "ttft_p99_tier0", "kind": "sustained", "observed": 480.0}


def test_autoscaler_scale_out_cooldown_scale_in_shed(fleet):
    *_, mk_router = fleet
    router = mk_router(policy="ring", shed_depth={2: -1})
    with RouterClient(router.address) as c:
        p = _owned_prompt(router.ring, "A")
        c.generate(p, 3)
        c.generate(p, 3)
    router.refresh_stats()
    assert router.drain_replica("B")
    stub = _StubSentinel()
    scaler = FleetAutoscaler(router, stub, min_replicas=1, cooldown_checks=2,
                             scale_in_clean_checks=2)
    rtel = router._tel
    stub.hits = [dict(_TTFT_HIT)]
    acts = scaler.step()
    assert [a["action"] for a in acts] == ["scale_out"]
    assert acts[0]["via"] == "undrain" and acts[0]["replica"] == "B"
    assert acts[0]["observed"] == 480.0 and acts[0]["band"] == "ttft_p99_tier0"
    assert router.ring.members() == ["A", "B"]
    assert rtel.counter_value("autoscaler_scale_out_total") == 1.0
    assert scaler.step() == [] and scaler.step() == []  # the cooldown observes
    stub.hits = []
    router.refresh_stats()
    assert router.registry.get("A").stat("prefix_entries", 0) > 0
    assert scaler.step() == []
    acts = scaler.step()
    assert [a["action"] for a in acts] == ["scale_in"]
    assert acts[0]["replica"] == "B" and acts[0]["band"] == "idle"
    assert router.ring.members() == ["A"]
    assert rtel.counter_value("autoscaler_scale_in_total") == 1.0
    assert scaler.step() == [] and scaler.step() == []
    with RouterClient(router.address, tier=2, shed_retries=0) as c:
        with pytest.raises(RequestShed):
            c.generate(_prompt(7), 3)
    acts = scaler.step()
    assert [a["action"] for a in acts] == ["scale_out"]
    assert acts[0]["band"].startswith("shed_delta:")
    assert len(scaler.actions()) == 3


def test_autoscaler_cold_standby_and_bad_address(fleet):
    sa, sb, *_ = fleet
    router = _router(policy="ring")
    try:
        router.add_replica(sa.address, name="A")
        router.setup()
        stub = _StubSentinel()
        stub.hits = [dict(_TTFT_HIT)]
        scaler = FleetAutoscaler(router, stub, standbys=["127.0.0.1:9", sb.address],
                                 cooldown_checks=0, max_replicas=2)
        assert scaler.step() == []  # a dead address: rolled back
        assert len(router.registry.all()) == 1
        acts = scaler.step()
        assert [a["action"] for a in acts] == ["scale_out"] and acts[0]["via"] == "add"
        assert router.registry.live_count() == 2 and len(router.ring) == 2
        assert scaler.standbys == []
        assert scaler.step() == []  # max_replicas
    finally:
        router.stop()


def test_shadow_rebuilt_from_warm_prefixes(fleet):
    sa, *_rest, mk_router = fleet
    router1 = mk_router(policy="ring")
    p = _owned_prompt(router1.ring, "A")
    with RouterClient(router1.address) as c:
        c.generate(p, 3)
        c.generate(p, 3)
    router2 = _router(policy="ring")
    try:
        router2.add_replica(sa.address, name="A")
        r = router2.registry.get("A")
        assert not r.shadow
        router2.refresh_stats()
        assert r.shadow and router2.registry.warmth("A", page_hashes(p[0], PS)) > 0
        reported = {bytes.fromhex(h) for h, _ in r.stat("warm_prefixes")}
        assert set(r.shadow) <= reported
    finally:
        router2.stop()


# -- across packages ----------------------------------------------------------------


def _scenario(router, servers, client_cls, params):
    """One scripted session through ``router``: affinity hits, a shed, a
    replica-side drain that fails over, a whole-fleet refusal and service
    after it. Returns what the client saw at each step."""
    seen = []
    with client_cls(router.address) as c:
        def gen(prompt, n, **kw):
            try:
                out = np.asarray(c.generate(prompt, n, **kw))
            except (RequestShed, RequestRefused, JaxShed, JaxRefused) as e:
                seen.append((type(e).__name__, getattr(e, "tier", None),
                             getattr(e, "queue_depth", None), getattr(e, "reason", None)))
                return
            np.testing.assert_array_equal(out, _solo(params, prompt, n))
            seen.append(("ok", out.tolist(), dict(c.last_route)))

        p1, p2, p3 = _prompt(101), _prompt(102), _prompt(103, plen=20)
        gen(p1, 4)
        gen(p1, 4)
        gen(p2, 3)
        gen(p2, 3)
        gen(p3, 3, tier=2)  # shed_depth {2: -1}: always shed
        servers[0].begin_drain()
        gen(p1, 4)  # A refuses: fails over to B
        servers[1].begin_drain()
        gen(p2, 3)  # both refuse: a structured refusal
        for s in servers:
            s.end_drain()
        router.refresh_stats()
        gen(p1, 4)
        gen(p3, 5, tier=0)
    return seen


def _run_scenario(router, servers, client_cls, params):
    try:
        for name, s in zip("AB", servers):
            router.add_replica(s.address, name=name)
        router.setup()
        return _scenario(router, servers, client_cls, params)
    finally:
        router.stop()
        for s in servers:
            s.stop()


@pytest.fixture(scope="module")
def port_port_session(model, params):
    servers = [_replica(model, Telemetry()) for _ in range(2)]
    return _run_scenario(_router(policy="affinity", shed_depth={2: -1}), servers, RouterClient,
                         params)


def test_port_router_session(port_port_session):
    kinds = [s[0] for s in port_port_session]
    assert kinds == ["ok"] * 4 + ["RequestShed", "ok", "RequestRefused", "ok", "ok"]
    routes = [s[2] for s in port_port_session if s[0] == "ok"]
    assert [r["affinity_depth"] for r in routes[:4]] == [0, 2, 0, 2]
    assert routes[4]["failovers"] == 1 and routes[4]["replica"] == "B"
    assert port_port_session[4][1:3] == (2, 0)
    assert port_port_session[6][3] == "draining"


def test_jax_router_in_front_of_port_replicas(model, params, port_port_session):
    servers = [_replica(model, Telemetry()) for _ in range(2)]
    router = JaxRouter(port=0, policy="affinity", shed_depth={2: -1}, stats_interval_s=0.0,
                       redial=False, telemetry=JaxTelemetry())
    assert _run_scenario(router, servers, RouterClient, params) == port_port_session


def test_port_router_in_front_of_jax_replicas(params, port_port_session):
    kw = dict(SERVING)
    servers = [JaxServer(JCFG, params, port=0, telemetry=JaxTelemetry(),
                         serving=JaxServingConfig(**kw)).setup() for _ in range(2)]
    router = _router(policy="affinity", shed_depth={2: -1})
    assert _run_scenario(router, servers, JaxRouterClient, params) == port_port_session
