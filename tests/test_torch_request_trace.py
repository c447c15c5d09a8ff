"""Port parity: request tracing and trace assembly
(``distriflow_tpu_torch/obs/trace_assembler.py`` over the port's ``Tracer``).

- The port's ``assemble`` and JAX's give equal ``Assembly`` fields, round
  by round, over the same span rows: serving request rounds (failover
  chains, a double commit, a shed, client retries merged by request id),
  wire rounds (carving, dedup deliveries, unapplied and rejected rounds,
  rounds merged by update id), trainer step rounds, orphans, a wall-clock
  step and a second host's clock domain; their attributions and renders
  agree line for line, and ``assemble_dir`` counts torn lines alike.
- The cases of ``tests/test_request_trace.py`` that need no JAX server,
  against port replicas: a direct request's span set and its TTFT/TPOT
  metadata, per-slot TPOT under unequal budgets, one round per request
  and zero orphan spans after a replica is killed mid-decode and after a
  hedge, the shed verdict and the router's fleet row reconciled with its
  counters. The JAX package's ``dump`` reads the port's run dir.
"""

import dataclasses
import itertools
import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distriflow_tpu.models.generate import generate as jax_generate
from distriflow_tpu.models.transformer import TransformerConfig as JaxConfig
from distriflow_tpu.models.transformer import transformer_lm
from distriflow_tpu.obs import trace_assembler as jax_asm
from distriflow_tpu_torch.client import InferenceClient, RequestShed
from distriflow_tpu_torch.comm.transport import FaultPlan, ScriptedFault
from distriflow_tpu_torch.fleet import FleetRouter, RouterClient, page_hashes
from distriflow_tpu_torch.models.convert import lm_from_jax
from distriflow_tpu_torch.models.transformer import TransformerConfig
from distriflow_tpu_torch.obs import trace_assembler as port_asm
from distriflow_tpu_torch.obs.telemetry import Telemetry
from distriflow_tpu_torch.obs.tracing import SPANS_FILENAME
from distriflow_tpu_torch.server import InferenceServer
from distriflow_tpu_torch.utils.config import ServingConfig

pytestmark = pytest.mark.port
torch.set_num_threads(2)

JCFG = JaxConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=48,
                 dtype=jnp.float32, use_flash_attention=False, use_flash_decode=False)
PCFG = TransformerConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=48,
                         dtype=torch.float32, use_flash_attention=False, use_flash_decode=False)
PS = 16
GOLDEN_KEYS = {"name", "trace_id", "span_id", "parent_id", "start", "mono", "pid", "dur_ms",
               "status"}


@pytest.fixture(scope="module")
def params():
    p = transformer_lm(JCFG, example_seq=16).init(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, p)


@pytest.fixture(scope="module")
def model(params):
    return lm_from_jax(PCFG, params, device="cpu")


_SOLO = {}


def _solo(params, prompt, n):
    key = (prompt.tobytes(), prompt.shape, n)
    if key not in _SOLO:
        _SOLO[key] = np.asarray(jax_generate(JCFG, params, jnp.asarray(prompt), n))
    return _SOLO[key]


def _prompt(seed, plen=33, batch=1):
    rng = np.random.default_rng(seed)
    return rng.integers(1, PCFG.vocab_size, size=(batch, plen)).astype(np.int32)


# -- synthetic span rows: the two assemblers agree ------------------------------

_SEQ = itertools.count()


def _row(name, tid, t0, dur_ms=1.0, **attrs):
    base = {"name": name, "trace_id": tid, "span_id": f"s{next(_SEQ):04d}", "parent_id": None,
            "start": t0, "mono": t0, "pid": 7, "dur_ms": dur_ms, "status": "ok"}
    base.update(attrs)
    return base


def _wrow(name, t0, dur_ms, trace_id="t" * 32, offset=500.0, **attrs):
    """A wire/step row whose wall clock is mono + offset."""
    return {"name": name, "trace_id": trace_id, "span_id": f"s-{name}-{t0}", "parent_id": None,
            "start": t0 + offset, "mono": t0, "pid": 1, "dur_ms": dur_ms, "status": "ok",
            **attrs}


def _failover(tid="t-fail", rid="r-1"):
    return [
        _row("request", tid, 100.000, 600.0, op="generate", tier=0),
        _row("route", tid, 100.010, 50.0, verdict="failover:ConnectionLost", policy="affinity",
             replica="A", request_id=rid, tier=0),
        _row("route", tid, 100.070, 500.0, verdict="forwarded", policy="affinity", replica="B",
             request_id=rid, tier=0, ttft_ms=80.0, tpot_ms=9.5),
        _row("queue_wait", tid, 100.080, 20.0, request_id=rid, tier=0),
        _row("admission", tid, 100.100, 30.0, request_id=rid, tier=0),
        _row("prefill", tid, 100.130, 60.0, request_id=rid, tier=0),
        _row("decode_iter", tid, 100.200, 150.0, request_id=rid, tier=0),
        _row("decode_iter", tid, 100.360, 150.0, request_id=rid, tier=0),
        _row("retire", tid, 100.550, 0.0, request_id=rid, tier=0, outcome="complete",
             ttft_ms=80.0, tpot_ms=9.5),
    ]


def _double_commit():
    return _failover("t-dc", "r-dc") + [
        _row("route", "t-dc", 100.600, 10.0, verdict="forwarded", policy="affinity",
             replica="A", request_id="r-dc", tier=0)]


def _shed():
    return [_row("request", "t-shed", 200.0, 5.0, op="generate", tier=2,
                 status="error:RequestShed"),
            _row("route", "t-shed", 200.001, 0.1, verdict="shed", policy="affinity",
                 replica=None, request_id="r-shed", tier=2, queue_depth=3)]


def _rid_merge():
    rid = "r-retry"
    return [
        _row("request", "t-first", 300.0, 40.0, op="generate", tier=1, status="error:AckTimeout"),
        _row("route", "t-first", 300.001, 30.0, verdict="failover:AckTimeout", policy="affinity",
             replica="A", request_id=rid, tier=1),
        _row("request", "t-second", 300.1, 200.0, op="generate", tier=1),
        _row("route", "t-second", 300.101, 180.0, verdict="forwarded", policy="affinity",
             replica="B", request_id=rid, tier=1, ttft_ms=42.0),
        _row("retire", "t-second", 300.290, 0.0, request_id=rid, tier=1, outcome="complete",
             ttft_ms=42.0, tpot_ms=3.0),
    ]


def _hedge():
    rid, tid = "r-hedge", "t-hedge"
    return [
        _row("request", tid, 400.0, 120.0, op="generate", tier=0),
        _row("route", tid, 400.025, 0.0, verdict="hedge", policy="ring", replica="B",
             request_id=rid, tier=0),
        _row("queue_wait", tid, 400.030, 5.0, request_id=rid, tier=0),
        _row("prefill", tid, 400.040, 20.0, request_id=rid, tier=0),
        _row("retire", tid, 400.110, 0.0, request_id=rid, tier=0, outcome="complete",
             ttft_ms=40.0),
        _row("route", tid, 400.026, 90.0, verdict="forwarded", policy="ring", replica="B",
             request_id=rid, tier=0, hedged=True, failovers=0, ttft_ms=40.0),
    ]


def _wire():
    upload = _wrow("upload", 0.16, 350.0, serialize_ms=10.0, attempts=2, ack_wait_ms=200.0,
                   update_id="u1")
    apply_owned = _wrow("apply", 0.25, 50.0, quarantine_ms=20.0, update_id="u1", accepted=True)
    apply_owned["parent_id"] = upload["span_id"]
    return [_wrow("dispatch", 0.00, 20.0), _wrow("install", 0.03, 10.0),
            _wrow("fit", 0.05, 100.0), upload, _wrow("decode", 0.20, 10.0), apply_owned,
            _wrow("apply", 0.43, 5.0, dedup=True, accepted=False)]


def _unapplied():
    return [_wrow("dispatch", 0.0, 5.0, trace_id="a" * 32),
            _wrow("upload", 0.0, 50.0, trace_id="b" * 32, update_id="u2"),
            _wrow("apply", 0.02, 10.0, trace_id="b" * 32, update_id="u2", accepted=False,
                  verdict="quarantined")]


def _steps():
    bad = _wrow("round", 0.0, 100.0, trace_id="c" * 32, role="trainer", worker=1,
                status="error:RuntimeError")
    return [_wrow("round", 0.0, 100.0, role="trainer", worker=0), _wrow("fit", 0.01, 60.0),
            _wrow("submit", 0.07, 30.0), bad]


def _update_merge():
    t_orig, t_re = "d" * 32, "e" * 32
    upload = _wrow("upload", 0.10, 80.0, trace_id=t_orig, update_id="u7")
    apply_ = _wrow("apply", 0.15, 10.0, trace_id=t_orig, update_id="u7", accepted=True)
    apply_["parent_id"] = upload["span_id"]
    return [_wrow("dispatch", 0.00, 5.0, trace_id=t_orig, update_id="u7"), upload, apply_,
            _wrow("dispatch", 0.30, 5.0, trace_id=t_re, update_id="u7"),
            _wrow("dispatch", 0.40, 5.0, trace_id="f" * 32, update_id="u8")]


def _orphans_and_clock_step():
    upload = _wrow("upload", 0.10, 80.0, update_id="u9")
    upload["start"] += 3600.0
    other_host = _wrow("fit", 0.03, 40.0, trace_id="9" * 32, offset=-20.0, host="h2")
    return [{"name": "mystery", "dur_ms": 1.0}, _wrow("dispatch", 0.00, 5.0), upload,
            _wrow("apply", 0.15, 10.0, update_id="u9", accepted=True), _wrow("fit", 0.02, 60.0),
            _wrow("round", 0.0, 50.0, trace_id="9" * 32, host="h2", role="trainer"),
            other_host]


ROW_SETS = {"failover": _failover, "double_commit": _double_commit, "shed": _shed,
            "request_id_merge": _rid_merge, "hedge": _hedge, "wire": _wire,
            "unapplied": _unapplied, "steps": _steps, "update_id_merge": _update_merge,
            "orphans_clock_step": _orphans_and_clock_step,
            "everything": lambda: [r for f in (_failover, _shed, _rid_merge, _hedge, _wire,
                                               _steps) for r in f()]}


def _fields(asm):
    return (dataclasses.asdict(asm), asm.request_attribution(), asm.attribution())


@pytest.mark.parametrize("case", list(ROW_SETS))
def test_assemble_matches_jax(case):
    rows = ROW_SETS[case]()
    got, want = port_asm.assemble(rows), jax_asm.assemble(rows)
    assert _fields(got) == _fields(want)
    assert port_asm.render(got) == jax_asm.render(want)
    for tier in (None, 0, 2):
        assert port_asm.render_requests(got, tier=tier) == jax_asm.render_requests(want, tier=tier)


def test_assembled_request_rounds_read_as_jax_pins():
    r, = port_asm.assemble(_failover()).rounds
    assert r.kind == "request" and r.applied and r.retries == 1 and r.apply_spans == 1
    assert r.attrs["replicas"] == ["A", "B"] and r.attrs["ttft_ms"] == 80.0
    assert not port_asm.assemble(_double_commit()).rounds[0].applied
    assert port_asm.assemble(_shed()).request_attribution()["tiers"][2]["shed"] == 1
    merged, = port_asm.assemble(_rid_merge()).rounds
    assert merged.applied and merged.span_count == 5


def test_assemble_dir_counts_malformed_lines_like_jax(tmp_path):
    rows = _wire()
    lines = [json.dumps(rows[0]), "{torn-tail", *map(json.dumps, rows[1:]), '{"also": "no']
    (tmp_path / SPANS_FILENAME).write_text("\n".join(lines) + "\n")
    got, want = port_asm.assemble_dir(str(tmp_path)), jax_asm.assemble_dir(str(tmp_path))
    assert got.skipped == 2 and _fields(got) == _fields(want)
    assert any("2 malformed jsonl line(s) skipped" in ln for ln in port_asm.render(got))
    empty = port_asm.assemble_dir(str(tmp_path / "nope"))
    assert empty.rounds == [] and empty.skipped == 0


def test_port_tracer_rows_have_the_golden_schema(tmp_path):
    tel = Telemetry(save_dir=str(tmp_path))
    with tel.tracer.span("dispatch") as root:
        with tel.tracer.span("upload", trace_id=root.trace_id, parent_id=root.span_id,
                             client_id="c1"):
            time.sleep(0.001)
    child, root_row = [json.loads(ln) for ln in (tmp_path / SPANS_FILENAME).read_text()
                       .splitlines()]
    assert GOLDEN_KEYS <= set(child) and GOLDEN_KEYS - {"parent_id"} <= set(root_row)
    assert child["parent_id"] == root_row["span_id"] and child["pid"] == os.getpid()
    assert child["client_id"] == "c1" and child["status"] == "ok"
    # what assemble reads in memory: the same rows, None values kept
    assert [{k: v for k, v in r.items() if v is not None}
            for r in tel.tracer.finished()] == [child, root_row]


# -- live spans from port replicas ---------------------------------------------------


@pytest.fixture(scope="module")
def served_traced(model):
    """One slab replica on a private telemetry shared with its clients."""
    tel = Telemetry()
    server = InferenceServer(model, port=0, telemetry=tel, serving=ServingConfig(
        batch_window_s=0.4, decode_chunk=2, max_slots=4, kv_layout="slab")).setup()
    yield server, tel
    server.stop()


def _hcount(tel, ident):
    return tel.snapshot()["histograms"].get(ident, {}).get("count", 0)


def test_direct_request_span_set_and_slo_meta(served_traced, params):
    server, tel = served_traced
    prompt = _prompt(1, plen=6)
    with InferenceClient(server.address, telemetry=tel) as c:
        out = c.generate(prompt, 5, request_id="direct-1")
        meta = c.last_serving_meta
    np.testing.assert_array_equal(out, _solo(params, prompt, 5))
    assert meta["ttft_ms"] > 0 and meta["tpot_ms"] > 0
    tid = tel.tracer.finished("request")[-1]["trace_id"]
    rows = [r for r in tel.tracer.finished() if r.get("trace_id") == tid]
    assert {"request", "queue_wait", "admission", "prefill", "decode_iter", "retire"} <= \
        {r["name"] for r in rows}
    for r in rows:
        if r["name"] != "request":
            assert r["request_id"] == "direct-1" and r["tier"] == 0
    retire = [r for r in rows if r["name"] == "retire"]
    assert len(retire) == 1 and retire[0]["outcome"] == "complete"
    assert retire[0]["ttft_ms"] == meta["ttft_ms"]
    asm = port_asm.assemble(rows)
    assert _fields(asm) == _fields(jax_asm.assemble(rows))
    r, = asm.rounds
    assert r.kind == "request" and r.applied and r.attrs["verdict"] == "complete"
    assert r.attrs["ttft_ms"] == meta["ttft_ms"]
    assert "prefill" in r.phases and "decode_iter" in r.phases


def test_per_slot_tpot_unequal_budgets(served_traced, params):
    server, tel = served_traced
    ttft_id, tpot_id = "serving_ttft_ms{tier=0}", "serving_time_per_output_token_ms{tier=0}"
    ttft0, tpot0, batches0 = _hcount(tel, ttft_id), _hcount(tel, tpot_id), server.decode_batches
    prompts, budgets = [_prompt(11, plen=6), _prompt(12, plen=6)], [5, 9]
    results, errors = [None, None], []
    barrier = threading.Barrier(2)

    def run(i):
        try:
            with InferenceClient(server.address, telemetry=tel) as c:
                barrier.wait()
                results[i] = (c.generate(prompts[i], budgets[i]), dict(c.last_serving_meta))
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    for i in (0, 1):
        np.testing.assert_array_equal(results[i][0], _solo(params, prompts[i], budgets[i]))
    assert _hcount(tel, ttft_id) - ttft0 == 2
    assert _hcount(tel, tpot_id) - tpot0 == 6  # (5 - 1) / 2 + (9 - 1) / 2
    assert server.decode_batches - batches0 <= 5


def _replica(model, tel, **kw):
    cfg = dict(batch_window_s=0.05, decode_chunk=4, kv_layout="paged", page_size=PS,
               max_slots=2, page_pool_pages=24)
    cfg.update(kw)
    return InferenceServer(model, port=0, telemetry=tel, serving=ServingConfig(**cfg)).setup()


@pytest.fixture()
def fleet_traced(model, tmp_path):
    tel = Telemetry(save_dir=str(tmp_path))
    sa, sb = _replica(model, tel), _replica(model, tel)
    made = []

    def mk_router(**kw):
        plan_a = kw.pop("fault_plan_a", None)
        router = FleetRouter(port=0, stats_interval_s=0.0, redial=False, telemetry=tel, **kw)
        router.add_replica(sa.address, name="A", fault_plan=plan_a)
        router.add_replica(sb.address, name="B")
        made.append(router)
        return router.setup()

    yield sa, sb, tel, str(tmp_path), mk_router
    for router in made:
        router.stop()
    sa.stop()
    sb.stop()


def test_chaos_failover_assembles_one_round_per_request(fleet_traced, params):
    sa, _sb, tel, run_dir, mk_router = fleet_traced
    plan = FaultPlan(seed=13, schedule=[ScriptedFault(event="generate", nth=3, action="reset")])
    router = mk_router(policy="affinity", fault_plan_a=plan)
    shared = _prompt(70)
    with RouterClient(router.address, telemetry=tel) as c:
        c.generate(shared, 3)
        assert c.last_replica == "A"
        results = {}
        long_prompt = shared[:, :17]

        def long_decode():
            with RouterClient(router.address, telemetry=tel) as cl:
                results["long"] = (cl.generate(long_prompt, 31, seed=0), cl.last_route)

        t = threading.Thread(target=long_decode)
        t.start()
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline and not any(r is not None for r in sa._slot_req):
            time.sleep(0.002)
        out = c.generate(shared, 5)
        t.join(timeout=120.0)
        assert not t.is_alive()
        assert c.last_replica == "B" and c.last_route["failovers"] >= 1
        np.testing.assert_array_equal(out, _solo(params, shared, 5))
        long_out, long_route = results["long"]
        assert long_route["replica"] == "B"
        np.testing.assert_array_equal(long_out, _solo(params, long_prompt, 31))
    rows = tel.tracer.finished()
    asm = port_asm.assemble(rows)
    assert _fields(asm) == _fields(jax_asm.assemble(rows))
    assert asm.orphans == []
    reqs = asm.requests()
    assert len(reqs) == 3 and len({r.attrs["request_id"] for r in reqs}) == 3
    for r in reqs:
        assert r.applied and r.apply_spans == 1
        assert r.attrs["attempts"][-1]["verdict"] == "forwarded"
    failed_over = [r for r in reqs if r.retries >= 1]
    assert len(failed_over) == 2
    for r in failed_over:
        assert r.attrs["replicas"] == ["A", "B"]
    assert sum(r.retries for r in reqs) == tel.counter_value("router_failovers_total")
    # the JAX package's dump reads the port's run dir
    from distriflow_tpu.obs.dump import summarize_requests
    body = "\n".join(summarize_requests(run_dir))
    assert "3 assembled, 3 committed, 0 orphan span(s)" in body and "B[forwarded]" in body


def test_hedged_request_assembles_one_round(model, params):
    tel = Telemetry()
    sa = _replica(model, tel, batch_window_s=0.25)  # the straggler
    sb = _replica(model, tel)
    router = FleetRouter(port=0, policy="ring", stats_interval_s=0.0, redial=False,
                         telemetry=tel, hedge_ms={0: 25.0})
    try:
        router.add_replica(sa.address, name="A")
        router.add_replica(sb.address, name="B")
        router.setup()
        p = next(q for q in (_prompt(s) for s in range(4096))
                 if router.ring.primary(page_hashes(q[0], PS)[0]) == "A")
        with RouterClient(router.address, tier=0, telemetry=tel) as c:
            out = c.generate(p, 3, request_id="hedge-1")
            assert c.last_replica == "B"
        np.testing.assert_array_equal(out, _solo(params, p, 3))
        assert tel.counter_value("router_hedges_total") == 1.0
        time.sleep(0.4)  # the loser retires unadmitted once A's window closes
    finally:
        router.stop()
        sa.stop()
        sb.stop()
    rows = tel.tracer.finished()
    asm = port_asm.assemble(rows)
    assert _fields(asm) == _fields(jax_asm.assemble(rows))
    assert asm.orphans == []
    r, = asm.requests()
    assert r.applied and r.apply_spans == 1 and r.attrs["request_id"] == "hedge-1"
    assert [a["verdict"] for a in r.attrs["attempts"]] == ["hedge", "forwarded"]


def test_shed_verdict_wrong_hint_and_fleet_row(fleet_traced, params):
    _sa, _sb, tel, run_dir, mk_router = fleet_traced
    router = mk_router(policy="affinity", shed_depth={2: -1})
    prompt = _prompt(50)
    with RouterClient(router.address, tier=2, telemetry=tel) as c:
        with pytest.raises(RequestShed) as exc:
            c.generate(prompt, 3)
        assert exc.value.tier == 2
        np.testing.assert_array_equal(c.generate(prompt, 3, tier=0), _solo(params, prompt, 3))
    hinted = _prompt(21)
    router.registry.learn("B", page_hashes(hinted[0], PS))
    with RouterClient(router.address, telemetry=tel) as c:
        np.testing.assert_array_equal(c.generate(hinted, 5), _solo(params, hinted, 5))
        assert c.last_replica == "B" and c.last_route["affinity_depth"] == 2
        hint_tid = tel.tracer.finished("request")[-1]["trace_id"]
    asm = port_asm.assemble(tel.tracer.finished())
    assert asm.orphans == []
    reqs = asm.requests()
    shed, = [r for r in reqs if r.attrs["verdict"] == "shed"]
    assert not shed.applied and shed.attrs["tier"] == 2
    assert [a["replica"] for a in shed.attrs["attempts"]] == [None]
    hint_round = next(r for r in reqs if r.trace_id == hint_tid)
    assert hint_round.applied and hint_round.retries == 0 and "prefill" in hint_round.phases
    row = tel.snapshot()["fleet"]["router"]
    assert row["role"] == "router" and row["policy"] == "affinity"
    assert row["requests"] == 2 == int(sum(
        tel.counter_value("router_requests_total", tier=str(t)) for t in (0, 1, 2)))
    assert row["shed"] == 1 == int(tel.counter_value("router_shed_total", tier="2"))
    assert row["goodput"] == 2 and row["failovers"] == 0 and row["replicas_live"] == 2
    fleet = tel.snapshot()["fleet"]
    assert fleet["A"]["role"] == fleet["B"]["role"] == "replica"
    tel.export_snapshot()
    from distriflow_tpu.obs.dump import summarize_fleet
    body = "\n".join(summarize_fleet(run_dir))
    assert "role=router" in body and "role=replica" in body
