"""Port of ``distriflow_tpu/doctor.py``:
``python -m distriflow_tpu_torch.doctor [--device cpu]``.

The same 22 checks in the same order under the same names, with the same
mandatory flags, on the port's planes. They run on ``cuda`` (the default)
or, with ``--device cpu``, on the CPU; without a GPU and without
``--device cpu`` the ``backend/devices`` check fails and the doctor stops
there with exit code 1.

What differs from the JAX doctor:

* ``backend/devices`` reports the card's name and count and the process
  group's rank/world (``0/1`` when none is up); ``mesh construction`` and
  ``allreduce`` start a single-process group (``nccl`` on ``cuda``,
  ``gloo`` on the CPU) when none is up and destroy it when done, so the
  later checks and the caller's process see none.
* The four LM drills (fleet failover, elastic fleet, request trace, pool
  witness) share :func:`_drill_config`: head dim 64 in bf16, the shape the
  CUDA decode kernels take (the JAX drills' head dim 8 in f32 has no
  kernel), with weights from a numpy seed carried over by
  ``models/convert.py``. On the card every drill decode runs the paged
  decode kernel at page 16 and solo ``generate()`` the slab decode kernel.
* "Bit-identical to solo" holds exactly on the CPU. On CUDA the engine's
  batched decode and a B 1 ``generate()`` round bf16 apart (other matmul
  algorithms, the paged and the slab kernel), so a routed output may part
  from solo only where the top-2 logit margin at the first differing
  position is below :data:`NEAR_TIE` (:class:`_Solo`); each drill's detail
  counts those near-ties. Every other assertion is exact on both devices.

The checks, as the JAX doctor describes them (on the port, 3 is a
``torch.distributed`` all_reduce after one warm-up):

One command that answers "is this machine ready to train?" — the
operational front door the reference never had (its failure mode was a
silent socket.io hang). Checks, in order:

1. backend + devices (platform, device kinds, process count);
2. mesh construction over the visible devices;
3. a jit-compiled allreduce (the sync-SGD hot collective) with measured
   dispatch latency;
4. a tiny train step (MLP, one optimizer update, loss finite);
5. loopback transport round trip (server + client + ack);
6. chaos self-test: a loopback train run under a seeded 10% frame-drop +
   duplicate FaultPlan plus a scripted mid-upload connection reset,
   asserting every upload applies exactly once (retry + dedup machinery,
   see ``docs/ROBUSTNESS.md``);
7. telemetry reconciliation: the chaos run's ``Telemetry.snapshot()``
   counters must EXACTLY match the FaultPlans' injected-event counts and
   ``frames_seen`` totals, at least one upload trace must span the
   reconnect, and every apply span must link to a client upload trace
   (see ``docs/OBSERVABILITY.md``);
8. fleet telemetry drill: two wire clients — one scripted-slow, one
   under a scripted mid-upload connection reset — ship interval-gated
   telemetry reports on their uploads; the server-side collector's
   fleet totals must reconcile EXACTLY with the sum of the clients'
   local counters (the reconnect forcing exactly one full-snapshot
   fallback beyond the two handshakes), and the fleet straggler band
   must trip exactly once, naming the slow client
   (see ``docs/OBSERVABILITY.md`` §10);
9. kill-and-resume recovery drill: an async training run hard-stopped at
   a (seeded-)random mid-run point, restarted as a fresh server on the
   same ``save_dir``; the manifest restores the dataset cursor/version
   clock/dedup keys and the drill asserts exactly-once batch accounting
   end-to-end (see ``docs/ROBUSTNESS.md`` §8);
10. straggler drill: one artificially slow client, a short batch lease —
    the run must complete via speculative re-dispatch and the straggler's
    late gradient must be suppressed by first-wins arbitration;
11. sparse-wire drill: top-k + int8 uploads with error feedback and
    delta broadcasts reconstruct the dense mean within tolerance, and a
    forced reconnect is repaired with a full sync;
12. health-sentinel drill: a scripted 0.4 s ack delay must trip the
    ack-latency SLO band exactly once (edge-triggered) and dump exactly
    one flight bundle; a clean run must trip nothing;
13. request-trace drill: a clean two-replica routed serving run must
    assemble every request into exactly one APPLIED round with zero
    orphan spans — and ``dump --requests`` must agree from the run dir
    alone — while the tier-0 TTFT band stays silent; a scripted 0.4 s
    prefill delay on one tier-0 request must then trip
    ``ttft_p99_tier0`` exactly once (edge-triggered) with the flight
    bundle's ``ttft_high`` watermark naming the offending request
    (see ``docs/OBSERVABILITY.md`` §11);
14. critical-path drill: assembled round traces must attribute a clean
    run to its dominant compute phase, attribute a PIPELINED clean run
    (``inflight_window=2``) to ``fit`` with the upload tail hidden on
    the comm thread, and shift ``bound_by`` to ``submit`` under a
    scripted 0.3 s upload delay (and only then); the bench ledger must
    flag a synthetically slowed row as ``regress`` on exactly one
    metric (see ``docs/OBSERVABILITY.md`` §9);
15. lock-order witness drill: a scripted A->B / B->A inversion on
    witnessed locks (``analysis/witness.py``) must raise
    ``LockOrderViolation`` exactly once, a clean same-order run must
    raise nothing, and the disabled factory must hand back a plain
    ``threading.Lock`` (the zero-cost-off contract);
16. native C++ host library presence (optional — numpy fallback is fine);
17. checkpoint write/read round trip in a temp dir.

Exit code 0 when every mandatory check passes; each check prints
``ok``/``FAIL`` with a one-line detail, so CI and humans read the same
output.

"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

#: a routed greedy output may part from solo ``generate()`` on CUDA only
#: where the top-2 logit margin is below this (a bf16 near-tie)
NEAR_TIE = 0.05


def _tiny_model_cls():
    """Protocol-level fake model (fixed 'gradients', no ML) shared by the
    chaos self-test and the recovery/straggler drills. Built lazily so
    importing the doctor never imports numpy-heavy deps."""
    import numpy as np

    from distriflow_tpu_torch.models.base import DistributedModel

    class TinyModel(DistributedModel):
        def __init__(self):
            self._params = {"w": np.ones((4,), np.float32)}

        def setup(self):
            pass

        def fit(self, x, y):
            return {"w": np.full((4,), 0.1, np.float32)}

        def update(self, grads):
            self._params = {
                "w": np.asarray(self._params["w"] - grads["w"], np.float32)
            }

        def predict(self, x):
            return np.zeros((len(x), 2), np.float32)

        def evaluate(self, x, y):
            return [0.0]

        def get_params(self):
            return self._params

        def set_params(self, params):
            self._params = {k: np.asarray(v, np.float32) for k, v in params.items()}

        @property
        def input_shape(self):
            return (1,)

        @property
        def output_shape(self):
            return (2,)

    return TinyModel


def _drill_config():
    """The LM drills' model: vocab 64, d_model 256, 4 heads x 64, 2 layers,
    d_ff 512, max_seq 48, bf16, the plain prefill attention
    (``use_flash_attention=False``, as the JAX drills set it) and the
    decode kernels left at their default (on CUDA tensors)."""
    import torch

    from distriflow_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(
        vocab_size=64, d_model=256, n_heads=4, n_layers=2, d_ff=512,
        max_seq=48, dtype=torch.bfloat16, use_flash_attention=False)


def _drill_model(device, seed: int = 0):
    """:func:`_drill_config`'s LM on ``device``, its weights drawn from a
    numpy ``seed`` in flax's layout and carried over by
    ``models/convert.py``."""
    import numpy as np

    from distriflow_tpu_torch.models.convert import lm_from_jax, random_lm_tree

    cfg = _drill_config()
    return lm_from_jax(cfg, random_lm_tree(cfg, np.random.default_rng(seed)), device=device)


class _Solo:
    """Solo ``generate()`` references for one drill model (cached), and
    the rule a routed greedy output is held to: equal on the CPU; on CUDA
    equal up to the first differing position, where the solo path's top-2
    logit margin must be below :data:`NEAR_TIE` (counted in
    ``near_ties``)."""

    def __init__(self, model):
        self.model = model
        self.exact = model.device.type != "cuda"
        self.near_ties = 0
        self._refs: Dict[Any, Any] = {}

    def __call__(self, prompt, n: int):
        from distriflow_tpu_torch.models.generate import generate

        key = (prompt.tobytes(), prompt.shape, n)
        if key not in self._refs:
            self._refs[key] = generate(self.model, prompt, n).cpu().numpy()
        return self._refs[key]

    def check(self, out, prompt, n: int) -> None:
        import numpy as np
        import torch

        want = self(prompt, n)
        out = np.asarray(out)
        if self.exact:
            assert np.array_equal(out, want), (
                f"routed output differs from solo: {out} vs {want}")
            return
        assert out.shape == want.shape, (out.shape, want.shape)
        plen = prompt.shape[1]
        assert np.array_equal(out[:, :plen], want[:, :plen]), "prompt changed"
        diff = np.nonzero(out[0] != want[0])[0]
        if not len(diff):
            return
        pos = int(diff[0])
        toks = torch.as_tensor(want[:, :pos], device=self.model.device)
        with torch.no_grad():
            logits, _ = self.model.decode(toks)
        top = torch.topk(logits[0, -1].float(), 2).values
        margin = float(top[0] - top[1])
        assert margin < NEAR_TIE, (
            f"routed output parts from solo at position {pos} with top-2 "
            f"margin {margin:.4f} >= {NEAR_TIE}")
        self.near_ties += 1

    @property
    def agreement(self) -> str:
        if self.exact:
            return "bit-identical to solo"
        return f"equal to solo up to {self.near_ties} bf16 near-tie(s)"


def _run_check(name: str, fn, mandatory: bool = True,
               report: Optional[List[Dict[str, Any]]] = None) -> bool:
    t0 = time.perf_counter()
    try:
        detail = fn()
        print(f"  ok   {name}" + (f" — {detail}" if detail else ""), flush=True)
        status, passed = "ok", True
    except Exception as e:  # the whole point: report, don't crash
        status = "FAIL" if mandatory else "warn"
        print(f"  {status} {name} — {type(e).__name__}: {e}", flush=True)
        passed = not mandatory
    if report is not None:
        report.append({"name": name, "status": status,
                       "s": time.perf_counter() - t0})
    return passed


def main(argv: Optional[List[str]] = None,
         report: Optional[List[Dict[str, Any]]] = None) -> int:
    """Run the checks on ``--device`` (``cuda`` by default); 0 when every
    mandatory check passes. ``report``, when given, gets one
    ``{"name", "status", "s"}`` row a check (its wall seconds)."""
    parser = argparse.ArgumentParser(
        prog="python -m distriflow_tpu_torch.doctor",
        description="Is this machine ready to train with the port?")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    # the drills time rounds across the threads of this one process: keep
    # the import-time heap out of the collector's full passes
    from distriflow_tpu_torch.fleet.soak import frozen_heap

    with frozen_heap():
        return _run_checks(args.device, report)


def _run_checks(device_arg: str, report: Optional[List[Dict[str, Any]]]) -> int:
    """The checks of :func:`main` on ``device_arg``."""
    print("distriflow_tpu_torch doctor", flush=True)

    def _check(name, fn, mandatory=True):
        return _run_check(name, fn, mandatory, report)

    def backend():
        import torch
        import torch.distributed as dist

        from distriflow_tpu_torch.utils.device import resolve_device

        dev = resolve_device(device_arg)
        if dev.type == "cuda":
            n = torch.cuda.device_count()
            kinds = sorted({torch.cuda.get_device_name(i) for i in range(n)})
        else:
            n, kinds = 1, ["cpu"]
        rank, world = ((dist.get_rank(), dist.get_world_size())
                       if dist.is_initialized() else (0, 1))
        return f"{dev.type} x{n} ({', '.join(kinds)}), process {rank}/{world}"

    if not _check("backend/devices", backend):
        print("SOME CHECKS FAILED", flush=True)
        return 1  # never carry on on another device than the one asked for
    import torch

    device = torch.device(device_arg)
    ok = True

    def mesh():
        import torch.distributed as dist

        from distriflow_tpu_torch.parallel import (
            data_parallel_mesh,
            ensure_process_group,
            mesh_shape,
        )

        created = ensure_process_group(device)
        try:
            m = data_parallel_mesh(device)
            return f"mesh {mesh_shape(m)}"
        finally:
            if created:
                dist.destroy_process_group()

    ok &= _check("mesh construction", mesh)

    def allreduce():
        import torch.distributed as dist

        from distriflow_tpu_torch.parallel import (
            collective_latency_us,
            data_parallel_mesh,
            ensure_process_group,
        )

        created = ensure_process_group(device)
        try:
            m = data_parallel_mesh(device)
            # one warm-up (communicator set-up), then time dispatch
            # (collective_latency_us sizes its buffer per rank)
            us = collective_latency_us(m, nbytes=256 * 1024, iters=5)
        finally:
            if created:
                dist.destroy_process_group()
        return f"256KiB all_reduce {us / 1e3:.2f} ms"

    ok &= _check("allreduce (sync-SGD hot path)", allreduce)

    def train_step():
        import numpy as np

        from distriflow_tpu_torch.models.zoo import mnist_mlp
        from distriflow_tpu_torch.train.sync import SyncTrainer

        t = SyncTrainer(mnist_mlp(hidden=4, device=device), learning_rate=0.05)
        t.init(0)
        rng = np.random.RandomState(0)
        b = 2
        x = rng.rand(b, 28, 28, 1).astype(np.float32)
        y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, b)]
        loss = t.step((x, y))
        assert np.isfinite(loss), f"non-finite loss {loss}"
        return f"loss {loss:.3f}"

    ok &= _check("train step", train_step)

    def transport():
        from distriflow_tpu_torch.comm.transport import ClientTransport, ServerTransport

        srv = ServerTransport("127.0.0.1", 0)
        srv.on("ping", lambda client_id, payload: payload + 1)
        srv.start()
        try:
            c = ClientTransport(srv.address).connect(timeout=5.0)
            assert c.request("ping", 41) == 42
            c.close()
        finally:
            srv.stop()
        return f"loopback ack on {srv.address}"

    ok &= _check("wire transport", transport)

    # populated by the chaos run, consumed by the telemetry reconciliation
    # check right after it (one loopback run feeds both checks)
    chaos_state = {}

    def chaos():
        import numpy as np

        from distriflow_tpu_torch.client.abstract_client import DistributedClientConfig
        from distriflow_tpu_torch.client.async_client import AsynchronousSGDClient
        from distriflow_tpu_torch.comm.transport import FaultPlan, ScriptedFault
        from distriflow_tpu_torch.data.dataset import DistributedDataset
        from distriflow_tpu_torch.obs import Telemetry
        from distriflow_tpu_torch.server.abstract_server import DistributedServerConfig
        from distriflow_tpu_torch.server.async_server import AsynchronousSGDServer
        from distriflow_tpu_torch.server.models import DistributedServerInMemoryModel
        from distriflow_tpu_torch.utils.config import RetryPolicy

        TinyModel = _tiny_model_cls()
        x = np.arange(8, dtype=np.float32).reshape(8, 1)
        y = np.eye(2, dtype=np.float32)[np.arange(8) % 2]
        dataset = DistributedDataset(x, y, {"batch_size": 2, "epochs": 1})
        applied = []
        # one Telemetry for both endpoints: cross-endpoint traces land in a
        # single tracer and the counters reconcile against both fault plans
        tel = Telemetry()
        server_plan = FaultPlan(seed=5, duplicate=0.1)
        # the scripted reset tears the connection down mid-upload, forcing
        # at least one upload trace to span a reconnect (checked below)
        client_plan = FaultPlan(
            seed=3, drop=0.1, duplicate=0.1,
            schedule=[ScriptedFault(event="uploadVars", nth=2, action="reset")],
        )
        with tempfile.TemporaryDirectory() as d:
            server = AsynchronousSGDServer(
                DistributedServerInMemoryModel(TinyModel()),
                dataset,
                DistributedServerConfig(
                    save_dir=d,
                    heartbeat_interval_s=0.1,
                    heartbeat_timeout_s=2.0,
                    fault_plan=server_plan,
                    telemetry=tel,
                ),
            )
            server.setup()
            server.on_upload(lambda m: applied.append(m.update_id))
            client = AsynchronousSGDClient(
                server.address,
                TinyModel(),
                DistributedClientConfig(
                    heartbeat_interval_s=0.1,
                    heartbeat_timeout_s=2.0,
                    upload_timeout_s=2.0,
                    upload_retry=RetryPolicy(
                        max_retries=6, initial_backoff_s=0.05, max_backoff_s=0.5, seed=3
                    ),
                    fault_plan=client_plan,
                    telemetry=tel,
                ),
            )
            try:
                client.setup(timeout=10.0)
                client.train_until_complete(timeout=60.0)
            finally:
                client.dispose()
                server.stop()
        assert server.applied_updates == 4, (
            f"expected 4 applied updates, got {server.applied_updates}"
        )
        assert len(applied) == len(set(applied)) == 4, (
            f"updates not applied exactly once: {applied}"
        )
        chaos_state.update(
            telemetry=tel, client_plan=client_plan, server_plan=server_plan,
            applied_updates=server.applied_updates,
        )
        injected = dict(client_plan.injected)
        injected.update({f"srv_{k}": v for k, v in server_plan.injected.items()})
        return ("4 uploads exactly-once under 10% drop+duplicate+reset "
                f"(injected: {injected or 'none'}, "
                f"duplicates suppressed: {server.duplicate_uploads})")

    ok &= _check("chaos self-test (drop+duplicate+reset faults)", chaos)

    def telemetry_reconciliation():
        """The chaos run's snapshot must agree EXACTLY with its FaultPlans:
        every injected fault is accounted by the transport counters, every
        offered frame matches ``FaultPlan.frames_seen``, at least one upload
        trace spans a reconnect, and every applied update's server span
        links to a client upload span with the same trace_id."""
        tel = chaos_state["telemetry"]
        # in-flight client spans close a beat after dispose() returns (the
        # upload thread finishes its span when the dead transport's ack wait
        # aborts): wait briefly for span quiescence before reconciling
        want = chaos_state["applied_updates"]
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            span_ids = {s["span_id"] for s in tel.tracer.finished("upload")}
            applies = [s for s in tel.tracer.finished("apply")
                       if not s.get("dedup")]
            if len(applies) >= want and all(
                    a["parent_id"] in span_ids for a in applies):
                break
            time.sleep(0.02)
        # phase-digest quiescence (docs/OBSERVABILITY.md §5): the continuous
        # profiler must have booked one server apply phase per applied
        # update and one client fit phase per batch before the digests are
        # judged — a snapshot taken mid-flight would under-count
        reg = tel.registry
        want_applies = chaos_state["applied_updates"]

        def _digest_count(metric, **labels):
            h = reg.find(metric, **labels)
            return h.summary()["count"] if h is not None else 0

        while time.monotonic() < deadline:
            if (_digest_count("phase_ms", phase="apply", role="server")
                    >= want_applies
                    and _digest_count("phase_ms", phase="fit", role="client")
                    >= want_applies):
                break
            time.sleep(0.02)
        for phase, role in (("apply", "server"), ("decode", "server"),
                            ("fit", "client"), ("submit", "client")):
            n = _digest_count("phase_ms", phase=phase, role=role)
            assert n >= want_applies, (
                f"phase_ms{{phase={phase},role={role}}} has {n} samples, "
                f"expected >= {want_applies}"
            )
        steps = _digest_count("phase_step_wall_ms", role="client")
        assert steps >= want_applies, (
            f"client step digest has {steps} samples, "
            f"expected >= {want_applies}"
        )
        plans = (("client", chaos_state["client_plan"]),
                 ("server", chaos_state["server_plan"]))
        for action, counter in (
            ("drop", "transport_frames_dropped_total"),
            ("duplicate", "transport_frames_duplicated_total"),
            ("corrupt", "transport_frames_corrupted_total"),
            ("delay", "transport_frames_delayed_total"),
            ("reset", "transport_resets_total"),
        ):
            for role, plan in plans:
                got = tel.counter_value(counter, role=role)
                want = plan.injected.get(action, 0)
                assert got == want, (
                    f"{counter}{{role={role}}} = {got:g} but the plan "
                    f"injected {action} x{want}"
                )
        for role, plan in plans:
            offered = tel.counter_value("transport_frames_offered_total", role=role)
            seen = sum(plan.seen().values())
            assert offered == seen, (
                f"transport_frames_offered_total{{role={role}}} = {offered:g} "
                f"but the plan saw {seen} frames"
            )
        uploads = tel.tracer.finished("upload")
        spanning = [s for s in uploads if s.get("reconnects_spanned", 0) > 0]
        assert spanning, "no upload trace spanned a reconnect (scripted reset?)"
        upload_tids = {s["trace_id"] for s in uploads}
        applies = [s for s in tel.tracer.finished("apply") if not s.get("dedup")]
        unlinked = [a for a in applies if a["trace_id"] not in upload_tids]
        assert applies and not unlinked, (
            f"{len(unlinked)}/{len(applies)} apply spans not linked to an "
            "upload trace"
        )
        dedup_spans = [s for s in tel.tracer.finished("apply") if s.get("dedup")]
        return (f"counters == injected faults; offered == frames_seen; "
                f"{len(spanning)} upload trace(s) span a reconnect; "
                f"{len(applies)} applies + {len(dedup_spans)} dedup'd "
                "duplicates all linked to client traces; phase digests "
                f"booked >= {want_applies} samples per hot phase")

    ok &= _check("telemetry reconciliation (snapshot vs FaultPlan)",
                 telemetry_reconciliation)

    def fleet_telemetry():
        """Fleet telemetry plane drill (docs/OBSERVABILITY.md §10): two
        wire clients with SEPARATE Telemetry instances (the in-process
        stand-in for separate processes) ship interval-gated reports on
        their uploads. One client straggles (slow fit), the other eats a
        scripted mid-upload connection reset. Asserts: the collector's
        fleet totals reconcile EXACTLY with the sum of the clients' local
        cumulative counters; exactly one full-snapshot fallback beyond
        the two handshake fulls (the reconnect); the fleet straggler band
        trips exactly once, naming the slow client."""
        import numpy as np

        from distriflow_tpu_torch.client.abstract_client import DistributedClientConfig
        from distriflow_tpu_torch.client.async_client import AsynchronousSGDClient
        from distriflow_tpu_torch.comm.transport import FaultPlan, ScriptedFault
        from distriflow_tpu_torch.data.dataset import DistributedDataset
        from distriflow_tpu_torch.obs import HealthSentinel, Telemetry
        from distriflow_tpu_torch.server.abstract_server import DistributedServerConfig
        from distriflow_tpu_torch.server.async_server import AsynchronousSGDServer
        from distriflow_tpu_torch.server.models import DistributedServerInMemoryModel
        from distriflow_tpu_torch.utils.config import RetryPolicy

        TinyModel = _tiny_model_cls()

        class SlowFit(TinyModel):
            def fit(self, x, y):
                time.sleep(0.3)
                return super().fit(x, y)

        class FastFit(TinyModel):
            """Paced so the slow client still lands >= 2 uploads (a row
            needs two for a round time) before the dataset drains."""

            def fit(self, x, y):
                time.sleep(0.03)
                return super().fit(x, y)

        n_batches = 32
        x = np.arange(2 * n_batches, dtype=np.float32).reshape(-1, 1)
        y = np.eye(2, dtype=np.float32)[np.arange(len(x)) % 2]
        dataset = DistributedDataset(x, y, {"batch_size": 2, "epochs": 1})
        # separate telemetry per endpoint: the fleet view must be built
        # from wire-shipped reports, not a shared in-process registry
        tel_s, tel_fast, tel_slow = Telemetry(), Telemetry(), Telemetry()
        with tempfile.TemporaryDirectory() as d:
            server = AsynchronousSGDServer(
                DistributedServerInMemoryModel(TinyModel()),
                dataset,
                DistributedServerConfig(
                    heartbeat_interval_s=0.1, heartbeat_timeout_s=10.0,
                    # the reset's retried upload lands a few versions late;
                    # this drill is about telemetry, not staleness policy
                    server_hyperparams={"maximum_staleness": 1000},
                    telemetry=tel_s,
                ),
            )
            server.setup()
            sentinel = HealthSentinel(
                tel_s, collector=server.collector,
                fleet_straggler_factor=1.5, dump_dir=d)

            def mk(cid, model, tel, fault_plan=None):
                return AsynchronousSGDClient(
                    server.address, model,
                    DistributedClientConfig(
                        client_id=cid,
                        hyperparams={"telemetry_report_interval_s": 0.01},
                        heartbeat_interval_s=0.1, heartbeat_timeout_s=10.0,
                        upload_timeout_s=5.0,
                        upload_retry=RetryPolicy(
                            max_retries=6, initial_backoff_s=0.05,
                            max_backoff_s=0.5, seed=7),
                        fault_plan=fault_plan, telemetry=tel,
                    ),
                )

            fast = slow = None
            try:
                slow = mk("slow-client", SlowFit(), tel_slow)
                slow.setup(timeout=10.0)
                fast = mk("fast-client", FastFit(), tel_fast,
                          FaultPlan(seed=11, schedule=[ScriptedFault(
                              event="uploadVars", nth=2, action="reset")]))
                fast.setup(timeout=10.0)
                fast.train_until_complete(timeout=60.0)
                deadline = time.monotonic() + 20.0
                # quiesce: every batch applied, and the slow client's row
                # has a round time + client-authoritative report columns
                while time.monotonic() < deadline:
                    rows = server.fleet.snapshot()
                    slow_rows = [r for r in rows.values()
                                 if r.get("client") == "slow-client"]
                    if (server.applied_updates == n_batches and slow_rows
                            and slow_rows[0].get("round_ms")
                            and slow_rows[0].get("fit_ms") is not None):
                        break
                    time.sleep(0.02)
                assert server.applied_updates == n_batches, (
                    f"{server.applied_updates}/{n_batches} applied")
                # straggler band: trips once, names the slow client
                hits = [h for h in sentinel.check()
                        if h["band"] == "fleet_straggler"]
                assert len(hits) == 1, f"straggler hits: {hits}"
                assert hits[0]["client"] == "slow-client", hits[0]
                again = [h for h in sentinel.check()
                         if h["band"] == "fleet_straggler"]
                assert not again, "straggler band re-triggered (not edge)"
                n_breach = tel_s.counter_value(
                    "obs_slo_breach_total", band="fleet_straggler")
                assert n_breach == 1, f"breach counter {n_breach}"
                # reconcile at quiescence: a live connection never stops
                # moving its own comm counters (every report's carrier
                # frame is itself counted), so freeze the clients first,
                # then ship each builder's FINAL delta report and demand
                # exact equality across every counter ident
                for c in (fast, slow):
                    c.dispose()
                for c in (fast, slow):
                    server.collector.ingest(
                        c.client_id, c._report_builder.build())

                def local_sums():
                    out = {}
                    for t in (tel_fast, tel_slow):
                        for ident, v in t.registry.snapshot()["counters"].items():
                            out[ident] = out.get(ident, 0.0) + v
                    return out

                totals = server.collector.totals()
                local = local_sums()
                assert totals == local, (
                    "fleet totals do not reconcile: "
                    f"{ {k: (totals.get(k), local.get(k)) for k in set(totals) | set(local) if totals.get(k) != local.get(k)} }"
                )
                # merged fleet histogram == sum of local fit digests
                merged = server.collector.fleet_histogram(
                    "phase_ms", phase="fit", role="client")
                want_fits = sum(
                    t.registry.find("phase_ms", phase="fit",
                                    role="client").summary()["count"]
                    for t in (tel_fast, tel_slow))
                assert merged.summary()["count"] == want_fits, (
                    f"merged fit digest {merged.summary()['count']} != "
                    f"local {want_fits}")
                # exactly one full beyond the two handshakes (the reset)
                assert server.collector.full_reports == 3, (
                    f"full reports: {server.collector.full_reports}")
                n_reports = server.collector.reports_ingested
                n_clients = len(server.collector.client_ids())
            finally:
                for c in (fast, slow):
                    if c is not None:
                        c.dispose()
                server.stop()
        assert n_clients == 2, f"collector saw {n_clients} clients"
        return (f"{n_reports} reports from {n_clients} clients reconcile "
                f"exactly ({len(totals)} counter idents, "
                f"{server.collector.full_reports} full snapshots incl. 1 "
                "post-reset fallback); straggler band tripped once for "
                "slow-client")

    ok &= _check("fleet telemetry drill (wire reports + straggler band)",
                 fleet_telemetry)

    def fleet_soak():
        """Soak drill (docs/ROBUSTNESS.md §10), two legs over the fleet
        soak harness. Leg A (clean): a seeded heterogeneous fleet with
        abrupt churn must quiesce with EXACT accounting — applied +
        rejected == total completions, model version == applies, zero
        leaked leases/outstanding batches, fleet telemetry totals equal
        to the sum of every client's local counters — and take zero
        controller actions. Chaos stays off in this leg: fault-injected
        resets/retries stall a round for whole seconds, which IS a
        transient straggler the controller is entitled to steer (the
        tier-1 soak test covers chaos reconciliation and lets the
        controller act); "clean" here pins the converse — no straggler,
        no adaptation. Leg B
        (scripted straggler): one client fits 8x slow for its first
        three batches; the straggler band must trip, the controller must
        push exactly one per-client adaptation, the band must clear on
        recovery and ramp the override back — with the same exact
        reconciliation at the end."""
        from distriflow_tpu_torch.fleet import SoakConfig, run_soak

        with tempfile.TemporaryDirectory() as d:
            clean = run_soak(SoakConfig(
                n_clients=12, n_batches=48, epochs=2, churn_kills=2,
                chaos=False, fit_delay_range_s=(0.01, 0.02),
                straggler_factor=50.0,  # scheduler-jitter headroom on loaded boxes
                save_dir=d, timeout_s=90))
        assert clean.errors == [], clean.errors
        assert clean.adaptations == 0, (
            f"clean leg took {clean.adaptations} controller actions: "
            f"{clean.actions}")
        assert clean.reconcile_ok and clean.rejoins == clean.kills
        with tempfile.TemporaryDirectory() as d:
            strag = run_soak(SoakConfig(
                n_clients=6, n_batches=120, epochs=2, chaos=False,
                churn_kills=0, straggler_slow_fits=3,
                straggler_slow_mult=8.0, fit_delay_range_s=(0.015, 0.025),
                straggler_factor=3.0, recovery_checks=2,
                poll_interval_s=0.05, save_dir=d, timeout_s=90))
        assert strag.errors == [], strag.errors
        assert strag.adaptations == 1, (
            f"straggler leg: {strag.adaptations} adaptations "
            f"(want exactly 1): {strag.actions}")
        assert strag.ramps >= 1 and strag.overrides_active == 0, (
            "override never ramped back")
        assert strag.hparam_pushes >= 2  # the adapt push + the clear push
        assert strag.reconcile_ok
        return (f"clean: {clean.applied}/{clean.total_batches} applies, "
                f"{clean.kills} kills rejoined, 0 adaptations, "
                f"{clean.counter_idents} counter idents reconcile exactly; "
                f"straggler: 1 adaptation pushed + ramped back, "
                f"goodput {strag.goodput_applies_per_s:.0f} applies/s")

    ok &= _check("fleet soak drill (churn exactness + adaptive "
                 "controller)", fleet_soak)

    def fleet_failover():
        """Fleet-router drill (docs/PERFORMANCE.md §7h): two paged
        replicas behind an affinity router. Clean phase: ten
        shared-prefix requests must route >= 80% to the warm replica
        (the affinity contract). Chaos phase: a scripted FaultPlan reset
        tears the router->warm connection mid-decode with one request in
        flight and one being sent — both must complete exactly once on
        the survivor, matching solo decode (:class:`_Solo`), and replaying a
        completed request_id against the survivor must return the cached
        ack without a second engine admission (the exactly-once proof)."""
        import threading

        import numpy as np

        from distriflow_tpu_torch.comm.transport import FaultPlan, ScriptedFault
        from distriflow_tpu_torch.fleet import FleetRouter, RouterClient
        from distriflow_tpu_torch.obs import Telemetry
        from distriflow_tpu_torch.server import InferenceServer
        from distriflow_tpu_torch.utils.config import ServingConfig

        model = _drill_model(device)
        solo = _Solo(model)
        rng = np.random.default_rng(17)
        shared = rng.integers(1, 64, size=(1, 33)).astype(np.int32)
        for n in (3, 5, 12):
            solo(shared, n)
        N_CLEAN = 10
        # frames on the warm conn: 1 warm-up + N_CLEAN clean + 1 in-flight
        # long decode; the NEXT generate send is the scripted kill
        plan = FaultPlan(seed=13, schedule=[ScriptedFault(
            event="generate", nth=N_CLEAN + 3, action="reset")])

        def replica():
            return InferenceServer(
                model, port=0, telemetry=Telemetry(),
                serving=ServingConfig(
                    batch_window_s=0.05, decode_chunk=4, kv_layout="paged",
                    page_size=16, max_slots=2, page_pool_pages=24)).setup()

        sa, sb = replica(), replica()
        router = FleetRouter(port=0, policy="affinity", stats_interval_s=0.0,
                             redial=False, telemetry=Telemetry())
        router.add_replica(sa.address, name="A", fault_plan=plan)
        router.add_replica(sb.address, name="B")
        router.setup()
        try:
            with RouterClient(router.address) as c:
                out = c.generate(shared, 3)  # warm-up: cold fleet -> A
                solo.check(out, shared, 3)
                warm = c.last_replica
                routes = []
                for _ in range(N_CLEAN):
                    out = c.generate(shared, 3)
                    solo.check(out, shared, 3)
                    routes.append(c.last_replica)
                warm_frac = routes.count(warm) / float(N_CLEAN)
                assert warm_frac >= 0.8, (
                    f"warm routing {warm_frac:.0%} < 80% ({routes})")

                results = {}

                def long_decode():
                    with RouterClient(router.address) as cl:
                        results["out"] = cl.generate(shared, 12)
                        results["route"] = cl.last_route

                t = threading.Thread(target=long_decode)
                t.start()
                deadline = time.monotonic() + 20.0
                while time.monotonic() < deadline:  # A mid-decode
                    if any(r is not None for r in sa._slot_req):
                        break
                    time.sleep(0.002)
                out = c.generate(shared, 5)  # the scripted kill fires here
                t.join(timeout=60.0)
                assert not t.is_alive(), "in-flight request lost"
                assert c.last_replica == "B", c.last_replica
                solo.check(out, shared, 5)
                # On a starved box A may finish the long decode before the
                # scripted reset lands; either way the tokens must match.
                long_route = results["route"]["replica"]
                assert long_route in ("A", "B"), long_route
                solo.check(results["out"], shared, 12)
                failovers = router._tel.counter_value(
                    "router_failovers_total")
                want = 2.0 if long_route == "B" else 1.0
                assert failovers >= want, (failovers, long_route)
            # exactly-once: a completed request_id replayed against the
            # survivor returns the cached ack, no second admission
            from distriflow_tpu_torch.client import InferenceClient
            with InferenceClient(sb.address) as direct:
                first = direct.generate(shared, 5, request_id="doctor-replay")
                admitted = sb.batched_requests
                again = direct.generate(shared, 5, request_id="doctor-replay")
                assert np.array_equal(first, again)
                assert sb.batched_requests == admitted, "dedup double-applied"
        finally:
            router.stop()
            sa.stop()
            sb.stop()
        moved = 2 if long_route == "B" else 1
        return (f"clean: {warm_frac:.0%} of {N_CLEAN} shared-prefix requests "
                f"on warm replica {warm}; chaos: scripted reset mid-decode, "
                f"{moved} request(s) failed over to B ({failovers:.0f} "
                f"failovers); routed outputs {solo.agreement}; replayed "
                "request_id served from dedup cache (no second admission)")

    ok &= _check("fleet failover drill (affinity routing + exactly-once)",
                 fleet_failover)

    def elastic_fleet():
        """Elastic-fleet drill (docs/ROBUSTNESS.md §11), three legs over
        one 3-replica ring fleet. Clean leg: every request lands on its
        chain hash's arc owner matching solo (see :class:`_Solo`), the ring epoch is
        stable, the tier-0 TTFT band stays silent, and the autoscaler
        takes zero actions. Straggler leg: the arc owner's admission
        window is stretched to 250 ms, so the 25 ms tier-0 watermark
        fires ONE hedged duplicate at the second arc owner, which wins;
        the loser retires UNADMITTED via hedge_cancel and the TTFT band
        stays silent — hedging hid the straggler. Kill+rejoin leg: a
        scripted reset kills the owner mid-decode; both in-flight
        requests fail over matching solo, the remap is bounded by
        1/N + slack (measured over a fixed key set), a replayed
        request_id is served from the dedup cache, and the probation
        re-probe restores the EXACT pre-churn assignment."""
        import math
        import threading

        import numpy as np

        from distriflow_tpu_torch.client import InferenceClient
        from distriflow_tpu_torch.comm.transport import FaultPlan, ScriptedFault
        from distriflow_tpu_torch.fleet import (
            FleetAutoscaler,
            FleetRouter,
            RouterClient,
            page_hashes,
        )
        from distriflow_tpu_torch.obs import Telemetry
        from distriflow_tpu_torch.obs.health import HealthSentinel, default_bands
        from distriflow_tpu_torch.server import InferenceServer
        from distriflow_tpu_torch.utils.config import ServingConfig

        model = _drill_model(device)
        solo = _Solo(model)
        ps = 16
        tel = Telemetry()  # ONE registry: fleet-wide serving histograms

        def replica():
            return InferenceServer(
                model, port=0, telemetry=tel,
                serving=ServingConfig(
                    batch_window_s=0.05, decode_chunk=4, kv_layout="paged",
                    page_size=ps, max_slots=2, page_pool_pages=24)).setup()

        def prompt(seed, plen=33):
            rng = np.random.default_rng(seed)
            return rng.integers(1, 64, size=(1, plen)).astype(np.int32)

        def owned(ring, owner, plen=33, start=0):
            for seed in range(start, start + 4096):
                p = prompt(seed, plen)
                if ring.primary(page_hashes(p[0], ps)[0]) == owner:
                    return p
            raise AssertionError(f"no prompt owned by {owner}")

        servers = {n: replica() for n in ("A", "B", "C")}
        sa = servers["A"]
        plan = FaultPlan(seed=13, schedule=[ScriptedFault(
            event="generate", nth=3, action="reset")])
        router = FleetRouter(port=0, policy="ring", stats_interval_s=0.0,
                             redial=False, telemetry=tel)
        # 256 vnodes: at N=3 the arc-share spread is ~1/(3*16) of the
        # space, so the 1/N + 0.5/sqrt(V) remap bound holds with margin
        router2 = FleetRouter(port=0, policy="ring", stats_interval_s=0.0,
                              redial=True, ring_vnodes=256,
                              telemetry=Telemetry())
        try:
            for name, srv in servers.items():
                # the scripted reset rides ONLY router2's connection —
                # the clean/straggler legs must never see it
                router.add_replica(srv.address, name=name)
            router.setup()

            # -- clean leg: arc-owner routing, stable epoch, silent band,
            #    idle autoscaler ------------------------------------------
            epoch0 = router.ring.epoch
            assert epoch0 == 3 and router.ring.members() == ["A", "B", "C"]
            prompts = {n: owned(router.ring, n) for n in servers}
            # warm every replica's compile at tier 1 (direct, unrouted)
            # so the tier-0 band judges serving latency, not XLA
            for name, srv in servers.items():
                with InferenceClient(srv.address) as w:
                    w.generate(prompts[name], 4, tier=1)
            with RouterClient(router.address, tier=0) as c:
                for name, p in prompts.items():
                    for n_tok in (4, 4):
                        out = c.generate(p, n_tok)
                        assert c.last_replica == name, (
                            f"{name}-owned prompt routed to "
                            f"{c.last_replica}")
                        solo.check(out, p, n_tok)
                router.refresh_stats()
                assert router.ring.epoch == epoch0, "clean traffic moved the ring"
                clean_p99 = float(tel.registry.find(
                    "serving_ttft_ms", tier="0").summary()["p99"])
                ceiling = clean_p99 + 200.0
                watch = HealthSentinel(
                    tel, bands=default_bands(ttft_p99_ms={0: ceiling}))
                scaler = FleetAutoscaler(router, watch)
                for _ in range(3):
                    scaler.step()
                assert scaler.actions() == [], (
                    f"autoscaler acted on a clean fleet: {scaler.actions()}")
                assert not watch.breached(), watch.breached()

                # -- straggler leg: stretch A's admission window; the
                #    tier-0 watermark hedges to the second arc owner ------
                key = page_hashes(prompts["A"][0], ps)[0]
                second = router.ring.lookup(key, 2)[1]
                sa.serving.batch_window_s = 0.25  # read at use time
                router.hedge_ms[0] = 25.0  # arm the tier-0 watermark
                try:
                    out = c.generate(prompts["A"], 4, request_id="hedge-1")
                finally:
                    router.hedge_ms.clear()
                    sa.serving.batch_window_s = 0.05
                solo.check(out, prompts["A"], 4)
                assert c.last_replica == second, (
                    f"hedge won on {c.last_replica}, expected {second}")
                hedges = tel.counter_value("router_hedges_total")
                wins = tel.counter_value("router_hedge_wins_total")
                cancelled = tel.counter_value("serving_hedge_cancelled_total")
                assert hedges == 1.0 and wins == 1.0, (hedges, wins)
                assert cancelled == hedges, (
                    f"{cancelled:g} cancels for {hedges:g} hedges")
                scaler.step()
                assert scaler.actions() == [] and not watch.breached(), (
                    "hedged straggler leaked into the TTFT band")

            # -- kill+rejoin leg: fresh router (redial on), same fleet ---
            for name, srv in servers.items():
                router2.add_replica(
                    srv.address, name=name,
                    fault_plan=plan if name == "A" else None)
            router2.setup()
            keys = [f"warmset-{i}".encode() for i in range(600)]
            base = router2.ring.assignment(keys)
            # ownership is per-ring: 256 vnodes may place router1's
            # A-owned prompt elsewhere, so re-search on router2's ring
            p_a = owned(router2.ring, "A")
            p_long = owned(router2.ring, "A", plen=17)
            with RouterClient(router2.address) as c:
                out = c.generate(p_a, 3)  # 1st on A
                assert c.last_replica == "A"
                solo.check(out, p_a, 3)
                router2.refresh_stats()  # A serves stats: next dial REVIVES
                results = {}

                def long_decode():
                    with RouterClient(router2.address) as cl:
                        results["out"] = cl.generate(p_long, 12)

                t = threading.Thread(target=long_decode)
                t.start()
                deadline = time.monotonic() + 20.0
                while time.monotonic() < deadline:  # A mid-decode
                    if any(r is not None for r in sa._slot_req):
                        break
                    time.sleep(0.002)
                out = c.generate(p_a, 5)  # 3rd on A: the scripted kill
                t.join(timeout=60.0)
                assert not t.is_alive(), "in-flight request lost"
                assert c.last_replica != "A"
                solo.check(out, p_a, 5)
                solo.check(results["out"], p_long, 12)
                # remap bound: only A's arcs moved, at most 1/N + slack
                assert router2.ring.members() == ["B", "C"]
                after = router2.ring.assignment(keys)
                moved = [k for k in keys if after[k] != base[k]]
                frac = len(moved) / float(len(keys))
                bound = 1.0 / 3.0 + 0.5 / math.sqrt(router2.ring.vnodes)
                assert frac <= bound, f"remap {frac:.3f} > {bound:.3f}"
                assert all(base[k] == "A" for k in moved), (
                    "a surviving replica's keys moved")
                # exactly-once: replay a completed id on the survivor
                survivor = servers[c.last_replica]
                with InferenceClient(survivor.address) as direct:
                    first = direct.generate(p_a, 5,
                                            request_id="elastic-replay")
                    admitted = survivor.batched_requests
                    again = direct.generate(p_a, 5,
                                            request_id="elastic-replay")
                    assert np.array_equal(first, again)
                    assert survivor.batched_requests == admitted, (
                        "dedup double-applied")
                # rejoin: the probation re-probe restores the EXACT
                # pre-churn placement
                router2.refresh_stats()
                assert router2.ring.members() == ["A", "B", "C"]
                assert router2.registry.get("A").revivals == 1
                assert router2._tel.counter_value(
                    "router_replica_revivals_total") == 1.0
                assert router2.ring.assignment(keys) == base, (
                    "rejoin did not restore the pre-churn assignment")
                out = c.generate(p_a, 4)  # 1st on the NEW connection
                assert c.last_replica == "A"
                solo.check(out, p_a, 4)
        finally:
            router.stop()
            router2.stop()
            for srv in servers.values():
                srv.stop()
        return (f"clean: 6 requests on their arc owners, "
                f"epoch stable at {epoch0}, TTFT band silent (p99 "
                f"{clean_p99:.0f} ms), autoscaler idle; straggler: 250 ms "
                f"window on A -> 1 hedge, won on {second}, loser cancelled "
                f"unadmitted, band still silent; kill+rejoin: remap "
                f"{frac:.0%} <= {bound:.0%} (A's arcs only), replay served "
                "from dedup cache, revival restored the exact assignment; "
                f"routed outputs {solo.agreement}")

    ok &= _check("elastic fleet drill (ring placement + tail hedging + "
                 "kill/rejoin remap)", elastic_fleet)

    def kill_and_resume():
        """Hard-stop an async training run at a seeded-random mid-run point,
        restart a FRESH server (new object, fresh dataset instance — the
        in-process stand-in for a new process) on the same save_dir, and
        assert exactly-once batch accounting end-to-end: the manifest
        restores the dataset cursor, version clock, and dedup keys, the
        outstanding batch is requeued, and the cumulative applied count
        equals the batch count exactly — none lost, none double-applied."""
        import random

        import numpy as np

        from distriflow_tpu_torch.client.abstract_client import DistributedClientConfig
        from distriflow_tpu_torch.client.async_client import AsynchronousSGDClient
        from distriflow_tpu_torch.data.dataset import DistributedDataset
        from distriflow_tpu_torch.obs import Telemetry
        from distriflow_tpu_torch.server.abstract_server import DistributedServerConfig
        from distriflow_tpu_torch.server.async_server import AsynchronousSGDServer
        from distriflow_tpu_torch.utils.config import RetryPolicy

        TinyModel = _tiny_model_cls()
        n_batches = 8
        x = np.arange(2 * n_batches, dtype=np.float32).reshape(-1, 1)
        y = np.eye(2, dtype=np.float32)[np.arange(len(x)) % 2]
        tel = Telemetry()

        def make_server(dataset, port):
            # a BARE model: auto-wrapped into a checkpointed server model on
            # save_dir, which is what persists+restores the manifest
            return AsynchronousSGDServer(
                TinyModel(),
                dataset,
                DistributedServerConfig(
                    save_dir=d, port=port, max_checkpoints=3,
                    heartbeat_interval_s=0.1, heartbeat_timeout_s=2.0,
                    telemetry=tel,
                ),
            )

        with tempfile.TemporaryDirectory() as d:
            ds1 = DistributedDataset(x, y, {"batch_size": 2, "epochs": 1})
            server1 = make_server(ds1, 0)
            server1.setup()
            port = server1.transport.port
            client = AsynchronousSGDClient(
                server1.address,
                TinyModel(),
                DistributedClientConfig(
                    heartbeat_interval_s=0.1, heartbeat_timeout_s=1.0,
                    upload_timeout_s=2.0,
                    upload_retry=RetryPolicy(
                        max_retries=8, initial_backoff_s=0.05,
                        max_backoff_s=0.5, seed=7,
                    ),
                    reconnect_retry=RetryPolicy(
                        max_retries=10, initial_backoff_s=0.1,
                        max_backoff_s=1.0, seed=7,
                    ),
                    telemetry=tel,
                ),
            )
            server2 = None
            kill_at = random.Random(0xD0C).randint(2, n_batches - 3)
            try:
                client.setup(timeout=10.0)
                deadline = time.monotonic() + 30.0
                while (server1.applied_updates < kill_at
                       and time.monotonic() < deadline):
                    time.sleep(0.005)
                assert server1.applied_updates >= kill_at, (
                    f"never reached the kill point ({server1.applied_updates}"
                    f"/{kill_at} applied)"
                )
                server1.stop()  # hard kill: NOTHING copied to the new server
                # fresh dataset + fresh server = what a new process sees;
                # every bit of resume state must come from the manifest
                ds2 = DistributedDataset(x, y, {"batch_size": 2, "epochs": 1})
                server2 = make_server(ds2, port)
                server2.setup()
                assert server2.recovered, "manifest not restored"
                client.train_until_complete(timeout=60.0)
            finally:
                client.dispose()
                if server2 is not None:
                    server2.stop()
            assert ds2.exhausted, "restored dataset never exhausted"
            # applied_updates is cumulative across incarnations (restored
            # from the manifest): exactly one apply per batch, ever
            assert server2.applied_updates == n_batches, (
                f"exactly-once violated: {server2.applied_updates} applies "
                f"for {n_batches} batches (rejected {server2.rejected_updates}, "
                f"suppressed {server2.suppressed_uploads})"
            )
            assert server2.rejected_updates == 0, (
                f"{server2.rejected_updates} updates rejected across restart"
            )
            assert tel.counter_value("server_recoveries_total") == 1
            return (f"killed after {server1.applied_updates} applies, resumed "
                    f"from manifest, {server2.applied_updates}/{n_batches} "
                    f"batches applied exactly once "
                    f"(dedup hits {server2.duplicate_uploads + server1.duplicate_uploads})")

    ok &= _check("kill-and-resume recovery drill", kill_and_resume)

    def straggler():
        """One artificially slow client: its batch lease expires, the batch
        is speculatively re-dispatched to the fast client, the run completes
        without the straggler, and the straggler's late upload is suppressed
        by first-wins arbitration."""
        import numpy as np

        from distriflow_tpu_torch.client.abstract_client import DistributedClientConfig
        from distriflow_tpu_torch.client.async_client import AsynchronousSGDClient
        from distriflow_tpu_torch.data.dataset import DistributedDataset
        from distriflow_tpu_torch.obs import Telemetry
        from distriflow_tpu_torch.server.abstract_server import DistributedServerConfig
        from distriflow_tpu_torch.server.async_server import AsynchronousSGDServer
        from distriflow_tpu_torch.server.models import DistributedServerInMemoryModel

        TinyModel = _tiny_model_cls()

        class SlowFirstFit(TinyModel):
            """Straggles on its first batch only — long enough to lose the
            race, short enough that its late upload lands in-drill."""

            def fit(self, x, y):
                if not getattr(self, "_straggled", False):
                    self._straggled = True
                    time.sleep(1.5)
                return super().fit(x, y)

        n_batches = 8
        x = np.arange(2 * n_batches, dtype=np.float32).reshape(-1, 1)
        y = np.eye(2, dtype=np.float32)[np.arange(len(x)) % 2]
        dataset = DistributedDataset(x, y, {"batch_size": 2, "epochs": 1})
        tel = Telemetry()
        server = AsynchronousSGDServer(
            DistributedServerInMemoryModel(TinyModel()),
            dataset,
            DistributedServerConfig(
                batch_lease_s=0.3,
                heartbeat_interval_s=0.1, heartbeat_timeout_s=10.0,
                telemetry=tel,
            ),
        )
        server.setup()
        fast = slow = None
        try:
            def mk(model):
                return AsynchronousSGDClient(
                    server.address, model,
                    DistributedClientConfig(
                        heartbeat_interval_s=0.1, heartbeat_timeout_s=10.0,
                        upload_timeout_s=5.0, telemetry=tel,
                    ),
                )

            slow = mk(SlowFirstFit())
            slow.setup(timeout=10.0)
            fast = mk(TinyModel())
            fast.setup(timeout=10.0)
            fast.train_until_complete(timeout=30.0)
            # the straggler's late upload arrives ~1.5 s in; wait for the
            # suppression to be recorded before asserting
            deadline = time.monotonic() + 10.0
            while (server.suppressed_uploads < 1
                   and time.monotonic() < deadline):
                time.sleep(0.02)
        finally:
            for c in (fast, slow):
                if c is not None:
                    c.dispose()
            server.stop()
        assert dataset.exhausted, "run did not complete"
        assert server.lease_expirations >= 1, "no lease expired"
        assert tel.counter_value("server_lease_expirations_total") >= 1
        assert server.suppressed_uploads >= 1, (
            "straggler's late gradient was not suppressed"
        )
        assert server.applied_updates == n_batches, (
            f"exactly-once violated: {server.applied_updates} applies "
            f"for {n_batches} batches"
        )
        return (f"run completed without the straggler "
                f"({server.lease_expirations} lease expirations, "
                f"{server.suppressed_uploads} late upload(s) suppressed, "
                f"{server.applied_updates}/{n_batches} applied exactly once)")

    ok &= _check("straggler drill (lease re-dispatch + first-wins)", straggler)

    def sparse_wire():
        """Short async session with top-k + int8 uploads and delta
        broadcasts under a seeded mid-session connection reset: the
        dense-reconstructed mean of the sparse uploads matches the model's
        constant gradient within the error-feedback + quantization bound,
        and the reconnected client is repaired with a FULL broadcast —
        exactly one beyond the handshake — while steady-state downloads
        ship as deltas."""
        import numpy as np

        from distriflow_tpu_torch.client.abstract_client import DistributedClientConfig
        from distriflow_tpu_torch.client.async_client import AsynchronousSGDClient
        from distriflow_tpu_torch.comm.transport import FaultPlan, ScriptedFault
        from distriflow_tpu_torch.data.dataset import DistributedDataset
        from distriflow_tpu_torch.obs import Telemetry
        from distriflow_tpu_torch.server.abstract_server import DistributedServerConfig
        from distriflow_tpu_torch.server.async_server import AsynchronousSGDServer
        from distriflow_tpu_torch.server.models import DistributedServerInMemoryModel
        from distriflow_tpu_torch.utils.config import RetryPolicy
        from distriflow_tpu_torch.utils.serialization import mean_serialized

        TinyModel = _tiny_model_cls()
        x = np.arange(8, dtype=np.float32).reshape(8, 1)
        y = np.eye(2, dtype=np.float32)[np.arange(8) % 2]
        dataset = DistributedDataset(x, y, {"batch_size": 2, "epochs": 1})
        tel = Telemetry()
        # reset while sending the SECOND download (the first post-apply
        # delta): the client reconnects and must be repaired with a full
        server_plan = FaultPlan(
            seed=11,
            schedule=[ScriptedFault(event="downloadVars", nth=2,
                                    action="reset")],
        )
        collected = []
        with tempfile.TemporaryDirectory() as d:
            server = AsynchronousSGDServer(
                DistributedServerInMemoryModel(TinyModel()),
                dataset,
                DistributedServerConfig(
                    save_dir=d,
                    heartbeat_interval_s=0.1, heartbeat_timeout_s=2.0,
                    fault_plan=server_plan, telemetry=tel,
                    client_hyperparams={
                        "gradient_compression": "topk_int8",
                        "topk_fraction": 0.5,
                    },
                ),
            )
            server.setup()
            server.on_upload(
                lambda m: collected.append(m.gradients.vars)
                if m.gradients is not None else None
            )
            client = AsynchronousSGDClient(
                server.address, TinyModel(),
                DistributedClientConfig(
                    heartbeat_interval_s=0.1, heartbeat_timeout_s=2.0,
                    upload_timeout_s=2.0,
                    upload_retry=RetryPolicy(
                        max_retries=6, initial_backoff_s=0.05,
                        max_backoff_s=0.5, seed=7,
                    ),
                    telemetry=tel,
                ),
            )
            try:
                client.setup(timeout=10.0)
                client.train_until_complete(timeout=60.0)
            finally:
                client.dispose()
                server.stop()
        assert server.applied_updates == 4, (
            f"expected 4 applied updates, got {server.applied_updates}"
        )
        assert collected, "no sparse uploads collected"
        sparse = sum(
            1 for u in collected
            for s in u.values() if s.indices is not None
        )
        assert sparse, "uploads were not sparse (topk_int8 not in effect?)"
        # (a) the EF invariant on the wire: the dense-reconstructed mean of
        # the uploads tracks the constant 0.1 gradient — the un-sent mass is
        # bounded by the residual carried across rounds plus the int8 grid
        mean = mean_serialized(collected, {"w": np.zeros((4,), np.float32)})
        tol = 0.2 / len(collected) + 0.01
        err = float(np.max(np.abs(np.asarray(mean["w"]) - 0.1)))
        assert err <= tol, (
            f"dense-reconstructed mean off by {err:.4f} (> {tol:.4f}): "
            f"{np.asarray(mean['w'])}"
        )
        # (b) delta-broadcast fallback: handshake full + exactly one repair
        # full after the reset-forced reconnect; everything else is a delta
        full = tel.counter_value("comm_broadcasts_full_total", role="server")
        delta = tel.counter_value("comm_broadcasts_delta_total", role="server")
        reconnects = tel.counter_value("client_reconnects_total")
        assert reconnects == 1, f"expected 1 reconnect, got {reconnects:g}"
        assert full == 2, (
            f"expected 2 full broadcasts (handshake + post-reconnect "
            f"repair), got {full:g}"
        )
        assert delta >= 1, "no delta broadcast in steady state"
        up = tel.counter_value("comm_up_bytes_total", role="server")
        return (f"{len(collected)} topk+int8 uploads ({sparse} sparse frames, "
                f"{up:g} B up), mean within {tol:.3f} of truth; "
                f"{full:g} full + {delta:g} delta broadcasts, "
                f"1 reset-forced reconnect repaired with a full sync")

    ok &= _check("sparse-wire drill (topk+int8 uploads, delta broadcasts)",
                 sparse_wire)

    def sentinel():
        """Health-sentinel drill (docs/OBSERVABILITY.md §6), both ways: a
        clean loopback run checked against the stock ack-latency band must
        raise ZERO breaches and write no flight bundle; the SAME run with a
        scripted 0.4 s ack delay must trip the band exactly once — one
        ``obs_slo_breach_total`` increment (edge-triggered: a second
        ``check()`` must not re-fire) and exactly one postmortem bundle on
        disk."""
        import os

        import numpy as np

        from distriflow_tpu_torch.client.abstract_client import DistributedClientConfig
        from distriflow_tpu_torch.client.async_client import AsynchronousSGDClient
        from distriflow_tpu_torch.comm.transport import FaultPlan, ScriptedFault
        from distriflow_tpu_torch.data.dataset import DistributedDataset
        from distriflow_tpu_torch.obs import Telemetry
        from distriflow_tpu_torch.obs.flight_recorder import read_bundles
        from distriflow_tpu_torch.obs.health import HealthSentinel, default_bands
        from distriflow_tpu_torch.server.abstract_server import DistributedServerConfig
        from distriflow_tpu_torch.server.async_server import AsynchronousSGDServer
        from distriflow_tpu_torch.server.models import DistributedServerInMemoryModel

        TinyModel = _tiny_model_cls()

        def run_once(fault_plan, dump_dir):
            x = np.arange(8, dtype=np.float32).reshape(8, 1)
            y = np.eye(2, dtype=np.float32)[np.arange(8) % 2]
            dataset = DistributedDataset(x, y, {"batch_size": 2, "epochs": 1})
            tel = Telemetry()
            watch = HealthSentinel(
                tel, bands=default_bands(ack_p99_ms=250.0),
                dump_dir=dump_dir)
            server = AsynchronousSGDServer(
                DistributedServerInMemoryModel(TinyModel()),
                dataset,
                DistributedServerConfig(
                    heartbeat_interval_s=0.1, heartbeat_timeout_s=2.0,
                    telemetry=tel,
                ),
            )
            server.setup()
            client = AsynchronousSGDClient(
                server.address, TinyModel(),
                DistributedClientConfig(
                    heartbeat_interval_s=0.1, heartbeat_timeout_s=2.0,
                    upload_timeout_s=2.0, fault_plan=fault_plan,
                    telemetry=tel,
                ),
            )
            try:
                client.setup(timeout=10.0)
                client.train_until_complete(timeout=60.0)
            finally:
                client.dispose()
                server.stop()
            entered = watch.check()
            watch.check()  # edge trigger: still in breach, must not re-fire
            count = tel.counter_value(
                "obs_slo_breach_total", band="ack_latency_p99")
            return entered, count, read_bundles(dump_dir)

        with tempfile.TemporaryDirectory() as d:
            clean_dir = os.path.join(d, "clean")
            fault_dir = os.path.join(d, "fault")
            entered, count, bundles = run_once(None, clean_dir)
            assert not entered and count == 0, (
                f"clean run breached the SLO: {entered} (count {count:g})"
            )
            assert not bundles, (
                f"clean run wrote {len(bundles)} flight bundle(s)"
            )
            plan = FaultPlan(seed=13, schedule=[
                ScriptedFault(event="uploadVars", nth=2, action="delay",
                              delay_s=0.4)])
            entered, count, bundles = run_once(plan, fault_dir)
            assert [e["band"] for e in entered] == ["ack_latency_p99"], (
                f"expected exactly the ack band to enter breach: {entered}"
            )
            assert count == 1, (
                f"obs_slo_breach_total{{band=ack_latency_p99}} = {count:g}, "
                "expected exactly 1 (edge trigger)"
            )
            assert len(bundles) == 1, (
                f"expected exactly 1 flight bundle, got {len(bundles)}"
            )
            assert bundles[0]["trigger"] == "slo_ack_latency_p99"
            assert any(e["kind"] == "slo_breach"
                       for e in bundles[0]["events"]), (
                "breach event missing from the bundle"
            )
            observed = entered[0]["observed"]
        return (f"clean run: 0 breaches, 0 bundles; 0.4 s scripted ack "
                f"delay: ack p99 {observed:.0f} ms > 250 ms tripped "
                "ack_latency_p99 exactly once (1 counter increment, "
                "1 flight bundle, edge-triggered)")

    ok &= _check("health-sentinel drill (SLO breach + flight dump)", sentinel)

    def timeline_drill():
        """Time-resolved telemetry drill (docs/OBSERVABILITY.md §12),
        three ways over the same loopback run. Clean: the sampled
        timeline persists to ``timeline.jsonl``, carries ZERO events,
        and ``dump --timeline`` renders it from the run dir alone.
        Transient: one scripted 0.4 s ack delay is a single out-of-band
        interval — the ``sustained`` band (3 consecutive observed
        samples) must stay silent where the old point band would have
        paged. Sustained: delaying EVERY frame 0.35 s trips the band
        exactly once (edge-triggered), and the breach event lands on the
        rendered timeline at its recorded timestamp."""
        import os

        import numpy as np

        from distriflow_tpu_torch.client.abstract_client import DistributedClientConfig
        from distriflow_tpu_torch.client.async_client import AsynchronousSGDClient
        from distriflow_tpu_torch.comm.transport import FaultPlan, ScriptedFault
        from distriflow_tpu_torch.data.dataset import DistributedDataset
        from distriflow_tpu_torch.obs import Telemetry, TIMELINE_FILENAME
        from distriflow_tpu_torch.obs.dump import summarize_timeline
        from distriflow_tpu_torch.obs.health import HealthSentinel, SLOBand
        from distriflow_tpu_torch.obs.timeline import TimelineStore
        from distriflow_tpu_torch.server.abstract_server import DistributedServerConfig
        from distriflow_tpu_torch.server.async_server import AsynchronousSGDServer
        from distriflow_tpu_torch.server.models import DistributedServerInMemoryModel

        TinyModel = _tiny_model_cls()
        band = SLOBand("ack_sustained", "transport_ack_latency_ms", "p99",
                       {"role": "client"}, upper=250.0, kind="sustained",
                       sustained_samples=3, sustained_s=0.1, window_s=60.0)

        def run_once(fault_plan, run_dir):
            x = np.arange(8, dtype=np.float32).reshape(8, 1)
            y = np.eye(2, dtype=np.float32)[np.arange(8) % 2]
            dataset = DistributedDataset(x, y, {"batch_size": 2, "epochs": 1})
            tel = Telemetry()
            tel.start_timeline(interval_s=0.05, save_dir=run_dir)
            watch = HealthSentinel(tel, bands=[band], dump_dir=run_dir)
            server = AsynchronousSGDServer(
                DistributedServerInMemoryModel(TinyModel()),
                dataset,
                DistributedServerConfig(
                    heartbeat_interval_s=0.1, heartbeat_timeout_s=5.0,
                    telemetry=tel,
                ),
            )
            server.setup()
            client = AsynchronousSGDClient(
                server.address, TinyModel(),
                DistributedClientConfig(
                    heartbeat_interval_s=0.1, heartbeat_timeout_s=5.0,
                    upload_timeout_s=5.0, fault_plan=fault_plan,
                    telemetry=tel,
                ),
            )
            try:
                client.setup(timeout=10.0)
                client.train_until_complete(timeout=60.0)
            finally:
                client.dispose()
                server.stop()
            tel.stop_timeline()
            entered = watch.check()
            watch.check()  # edge trigger: must not re-fire
            count = tel.counter_value(
                "obs_slo_breach_total", band="ack_sustained")
            return tel, entered, count

        with tempfile.TemporaryDirectory() as d:
            # -- clean leg: flat timeline, zero events, renderable -------
            clean_dir = os.path.join(d, "clean")
            tel, entered, count = run_once(None, clean_dir)
            assert not entered and count == 0, (
                f"clean run breached the sustained band: {entered}"
            )
            assert os.path.exists(
                os.path.join(clean_dir, TIMELINE_FILENAME)), (
                "clean run wrote no timeline.jsonl"
            )
            clean = TimelineStore.load(clean_dir)
            # >= 2 is structural (first thread tick + the closing sample
            # stop() takes); a loaded host can starve everything between
            assert len(clean.samples()) >= 2, (
                f"only {len(clean.samples())} timeline samples — the "
                "sampler thread never ticked"
            )
            assert clean.events() == [], (
                f"clean run stamped events: {clean.events()}"
            )
            lines, found = summarize_timeline(clean_dir)
            assert found and any("|" in ln for ln in lines), (
                "dump --timeline rendered no sparkline for the clean run"
            )
            clean_samples = len(clean.samples())

            # -- transient leg: one 0.4 s spike must NOT trip sustained --
            transient_dir = os.path.join(d, "transient")
            plan = FaultPlan(seed=13, schedule=[
                ScriptedFault(event="uploadVars", nth=2, action="delay",
                              delay_s=0.4)])
            _, entered, count = run_once(plan, transient_dir)
            assert not entered and count == 0, (
                f"a single transient spike tripped the sustained band: "
                f"{entered} (count {count:g})"
            )

            # -- sustained leg: every frame slow -> exactly one breach ---
            sustained_dir = os.path.join(d, "sustained")
            _, entered, count = run_once(
                FaultPlan(delay=1.0, delay_s=0.35), sustained_dir)
            assert [e["band"] for e in entered] == ["ack_sustained"], (
                f"expected exactly the sustained band to enter: {entered}"
            )
            assert count == 1, (
                f"obs_slo_breach_total{{band=ack_sustained}} = {count:g}, "
                "expected exactly 1 (edge trigger)"
            )
            assert entered[0]["run_samples"] >= 3
            store = TimelineStore.load(sustained_dir)
            breaches = [e for e in store.events()
                        if e["kind"] == "slo_breach"]
            assert len(breaches) == 1, (
                f"expected 1 slo_breach timeline event, got {breaches}"
            )
            # the rendered legend carries the breach at its recorded
            # timestamp (offset from the axis origin, 2dp)
            lines, found = summarize_timeline(sustained_dir)
            t_lo = min([s["t"] for s in store.samples()]
                       + [e["t"] for e in store.events()])
            stamp = f"+{breaches[0]['t'] - t_lo:.2f}s B slo_breach"
            joined = "\n".join(lines)
            assert found and stamp in joined, (
                f"breach stamp {stamp!r} missing from dump --timeline:\n"
                f"{joined}"
            )
        return (f"clean: {clean_samples} samples, 0 events, sparklines "
                "render; 1 transient 0.4 s spike: sustained band silent; "
                "0.35 s delay on every frame: ack_sustained tripped "
                f"exactly once ({entered[0]['run_samples']} consecutive "
                "slow samples) with the breach event time-aligned on the "
                "rendered timeline")

    ok &= _check("timeline drill (sustained vs transient SLO, "
                 "event-annotated dump)", timeline_drill)

    def request_trace():
        """Request-trace drill (docs/OBSERVABILITY.md §11), both ways:
        a clean two-replica routed serving run must assemble every
        request into exactly one APPLIED round with zero orphan spans —
        and ``dump --requests`` must say so from the run dir alone —
        while the tier-0 TTFT band stays silent; then a scripted 0.4 s
        prefill delay on one tier-0 request must trip
        ``ttft_p99_tier0`` exactly once (edge-triggered) with the
        flight bundle's ``ttft_high`` watermark naming the offending
        request. Warm-up requests ride tier 1 so cold-compile seconds
        land outside the tier-0 histogram the band watches."""
        import os

        import numpy as np

        from distriflow_tpu_torch.client import InferenceClient
        from distriflow_tpu_torch.fleet import FleetRouter, RouterClient
        from distriflow_tpu_torch.obs import Telemetry
        from distriflow_tpu_torch.obs.dump import summarize_requests
        from distriflow_tpu_torch.obs.flight_recorder import read_bundles
        from distriflow_tpu_torch.obs.health import HealthSentinel, default_bands
        from distriflow_tpu_torch.obs.trace_assembler import assemble
        from distriflow_tpu_torch.server import InferenceServer
        from distriflow_tpu_torch.utils.config import ServingConfig

        model = _drill_model(device)
        rng = np.random.default_rng(29)
        prompt = rng.integers(1, 64, size=(1, 9)).astype(np.int32)
        N_CLEAN = 4

        with tempfile.TemporaryDirectory() as run_dir:
            dump_dir = os.path.join(run_dir, "slo")
            tel = Telemetry(save_dir=run_dir)

            def replica():
                return InferenceServer(
                    model, port=0, telemetry=tel,
                    serving=ServingConfig(batch_window_s=0.05,
                                          decode_chunk=4,
                                          max_slots=2)).setup()

            sa, sb = replica(), replica()
            router = FleetRouter(port=0, policy="least_loaded",
                                 stats_interval_s=0.0, redial=False,
                                 telemetry=tel)
            router.add_replica(sa.address, name="A")
            router.add_replica(sb.address, name="B")
            router.setup()
            try:
                # warm BOTH replicas directly on tier 1: each server owns
                # its jit cache, so every cold compile must happen before
                # the tier-0 clean phase the band is measured against
                for srv in (sa, sb):
                    with InferenceClient(srv.address, telemetry=tel) as w:
                        w.generate(prompt, 4, tier=1)
                with RouterClient(router.address, telemetry=tel) as c:
                    for _ in range(N_CLEAN):
                        c.generate(prompt, 4, tier=0)
                    asm = assemble(tel.tracer.finished())
                    reqs = asm.requests()
                    assert asm.orphans == [], (
                        f"{len(asm.orphans)} orphan span(s) in a clean run")
                    assert len(reqs) == N_CLEAN + 2, (
                        f"{len(reqs)} rounds for {N_CLEAN + 2} requests")
                    assert all(r.applied for r in reqs), (
                        "unapplied round in a clean run")
                    routed = [r for r in reqs if r.apply_spans]
                    assert len(routed) == N_CLEAN and all(
                        r.apply_spans == 1 for r in routed), (
                        "routed requests not exactly-once committed")
                    body = "\n".join(summarize_requests(run_dir))
                    assert f"{N_CLEAN + 2} assembled" in body, body
                    assert "0 orphan span(s)" in body, body
                    clean_p99 = float(tel.registry.find(
                        "serving_ttft_ms", tier="0").summary()["p99"])
                    ceiling = clean_p99 + 200.0
                    watch = HealthSentinel(
                        tel, bands=default_bands(ttft_p99_ms={0: ceiling}),
                        dump_dir=dump_dir)
                    entered = watch.check()
                    assert not entered, f"clean run breached: {entered}"
                    assert not read_bundles(dump_dir), (
                        "clean run wrote a flight bundle")

                    # scripted fault: 0.4 s admission->prefill delay on
                    # whichever replica admits the next tier-0 request
                    def slowed(orig):
                        def admit(plen, shared_len, members):
                            time.sleep(0.4)
                            return orig(plen, shared_len, members)
                        return admit

                    for srv in (sa, sb):
                        srv._admit_group = slowed(srv._admit_group)
                    c.generate(prompt, 4, tier=0, request_id="doctor-slow")
                entered = watch.check()
                assert [e["band"] for e in entered] == ["ttft_p99_tier0"], (
                    f"expected exactly ttft_p99_tier0 to trip: {entered}")
                observed = entered[0]["observed"]
                watch.check()  # edge trigger: still breached, no re-fire
                count = tel.counter_value(
                    "obs_slo_breach_total", band="ttft_p99_tier0")
                assert count == 1, (
                    f"obs_slo_breach_total{{band=ttft_p99_tier0}} = "
                    f"{count:g}, expected exactly 1 (edge trigger)")
                bundles = read_bundles(dump_dir)
                assert len(bundles) == 1, (
                    f"expected exactly 1 flight bundle, got {len(bundles)}")
                assert bundles[0]["trigger"] == "slo_ttft_p99_tier0"
                highs = [e for e in bundles[0]["events"]
                         if e.get("kind") == "ttft_high"]
                assert highs and highs[-1].get(
                    "request_id") == "doctor-slow", (
                    f"bundle does not name the slow request: {highs}")
                slow = [r for r in assemble(tel.tracer.finished()).requests()
                        if r.attrs.get("request_id") == "doctor-slow"]
                assert len(slow) == 1 and slow[0].applied, (
                    "slow request did not assemble into one applied round")
            finally:
                router.stop()
                sa.stop()
                sb.stop()
        return (f"clean: {N_CLEAN + 2} requests -> {N_CLEAN + 2} applied "
                f"rounds, 0 orphans, tier-0 TTFT band silent "
                f"(p99 {clean_p99:.0f} ms); 0.4 s scripted prefill delay: "
                f"ttft p99 {observed:.0f} ms > {ceiling:.0f} ms tripped "
                "ttft_p99_tier0 exactly once, bundle names doctor-slow")

    ok &= _check("request-trace drill (lifecycle assembly + tier SLO)",
                 request_trace)

    def critical_path():
        """Critical-path drill (docs/OBSERVABILITY.md §9), three ways: a
        clean loopback async run (fit padded to ~30 ms so the round has a
        real dominant phase) must NOT attribute its rounds to ``submit``;
        the same run PIPELINED (``inflight_window=2``, round-6) must
        attribute to ``fit`` — the upload tail rides the comm thread and
        must not leak onto the critical path; and the run with every
        upload frame under a scripted 0.3 s delay must shift every
        applied round's ``bound_by`` to ``submit`` — and only that run.
        Then the ledger gate: three baseline rows plus one synthetically
        slowed candidate must produce a ``regress`` verdict on exactly
        one metric."""
        import os

        import numpy as np

        from distriflow_tpu_torch.client.abstract_client import DistributedClientConfig
        from distriflow_tpu_torch.client.async_client import AsynchronousSGDClient
        from distriflow_tpu_torch.comm.transport import FaultPlan, ScriptedFault
        from distriflow_tpu_torch.data.dataset import DistributedDataset
        from distriflow_tpu_torch.obs import Telemetry
        from distriflow_tpu_torch.obs.dump import summarize_critical_path
        from distriflow_tpu_torch.obs.ledger import BenchLedger
        from distriflow_tpu_torch.obs.trace_assembler import assemble_dir
        from distriflow_tpu_torch.server.abstract_server import DistributedServerConfig
        from distriflow_tpu_torch.server.async_server import AsynchronousSGDServer
        from distriflow_tpu_torch.server.models import DistributedServerInMemoryModel

        TinyModel = _tiny_model_cls()

        class SlowFitModel(TinyModel):
            # a measurable compute phase: without it every phase is
            # sub-ms noise and "what bounds the round" is a coin flip
            def fit(self, x, y):
                time.sleep(0.03)
                return super().fit(x, y)

        def run_once(fault_plan, save_dir, window=1):
            x = np.arange(8, dtype=np.float32).reshape(8, 1)
            y = np.eye(2, dtype=np.float32)[np.arange(8) % 2]
            dataset = DistributedDataset(x, y, {"batch_size": 2, "epochs": 1})
            tel = Telemetry(save_dir=save_dir)  # spans.jsonl on disk
            server = AsynchronousSGDServer(
                DistributedServerInMemoryModel(SlowFitModel()),
                dataset,
                DistributedServerConfig(
                    heartbeat_interval_s=0.1, heartbeat_timeout_s=2.0,
                    client_hyperparams={"inflight_window": window},
                    telemetry=tel,
                ),
            )
            server.setup()
            client = AsynchronousSGDClient(
                server.address, SlowFitModel(),
                DistributedClientConfig(
                    heartbeat_interval_s=0.1, heartbeat_timeout_s=2.0,
                    upload_timeout_s=2.0, fault_plan=fault_plan,
                    telemetry=tel,
                ),
            )
            try:
                client.setup(timeout=10.0)
                client.train_until_complete(timeout=60.0)
            finally:
                client.dispose()
                server.stop()
            # assembled from DISK — the same path `obs.dump
            # --critical-path` takes, so the drill covers the full
            # emit -> jsonl -> assemble pipeline
            return assemble_dir(save_dir), server.applied_updates, save_dir

        with tempfile.TemporaryDirectory() as d:
            base, applied, base_dir = run_once(None, os.path.join(d, "base"))
            agg = base.attribution()
            assert agg["applied"] == applied == 4, (
                f"expected 4 applied rounds, assembled {agg['applied']} "
                f"(server applied {applied})"
            )
            assert not base.orphans, (
                f"{len(base.orphans)} orphan span(s) in a clean run"
            )
            assert agg["bound_by"] != "submit", (
                f"clean run attributed to submit: {agg}"
            )
            baseline_bound = agg["bound_by"]
            # the CLI rendering over the same run dir must survive too
            lines = summarize_critical_path(base_dir)
            assert any("bound_by" in ln for ln in lines), lines

            # pipelined clean run (round-6 double-buffered client): the
            # server dispatches ahead and the upload tail rides the client
            # comm thread, so with fit padded to ~30 ms the rounds must
            # attribute to FIT — a hidden submit that still showed up as
            # bound_by would mean the overlap booking leaks into the
            # critical path
            piped, applied, _ = run_once(None, os.path.join(d, "piped"),
                                         window=2)
            agg_piped = piped.attribution()
            assert agg_piped["applied"] == applied == 4, (
                f"pipelined run lost exactly-once: assembled "
                f"{agg_piped['applied']}, server applied {applied}"
            )
            assert not piped.orphans, (
                f"{len(piped.orphans)} orphan span(s) in pipelined run"
            )
            # load tolerance: on a busy 1-core box the scheduler can open
            # idle gaps that outweigh the 30 ms fit pad, so "idle" is an
            # acceptable verdict; the actual contract — the upload tail
            # must NOT leak onto the critical path — is pinned by the
            # scheduler-independent phase means (fit is padded, submit is
            # a loopback send riding the comm thread)
            assert agg_piped["bound_by"] in ("fit", "idle"), (
                f"pipelined clean run not fit/idle-bound: {agg_piped}"
            )
            piped_means = agg_piped["phase_mean_ms"]
            assert (piped_means.get("fit", 0.0)
                    > piped_means.get("submit", 0.0)), (
                f"pipelined run: submit outweighed the padded fit — "
                f"overlap booking leaked onto the critical path: "
                f"{piped_means}"
            )

            plan = FaultPlan(seed=11, schedule=[
                ScriptedFault(event="uploadVars", nth=n, action="delay",
                              delay_s=0.3) for n in (1, 2, 3, 4)])
            slow, applied, _ = run_once(plan, os.path.join(d, "slow"))
            agg_slow = slow.attribution()
            assert agg_slow["applied"] == applied == 4
            # same load tolerance as above: idle gaps on a loaded box may
            # outweigh even the 0.3 s delay, so gate on the scheduler-
            # independent signal instead — the scripted delay sits INSIDE
            # the submit phase, so its mean must carry the ~300 ms floor
            # (load only adds time to a phase, never removes it) and must
            # dominate the 30 ms fit pad
            assert agg_slow["bound_by"] in ("submit", "idle"), (
                f"0.3 s submit delay did not shift attribution: {agg_slow}"
            )
            slow_means = agg_slow["phase_mean_ms"]
            assert slow_means.get("submit", 0.0) >= 200.0, (
                f"scripted 0.3 s upload delay not visible in the submit "
                f"phase mean: {slow_means}"
            )
            assert (slow_means.get("submit", 0.0)
                    > slow_means.get("fit", 0.0)), (
                f"submit delay did not dominate the fit pad: {slow_means}"
            )
            # per-round: no round may attribute to fit (30 ms pad can
            # never beat a 300 ms submit segment); idle is tolerated —
            # a loopback event-loop stall shows up as an idle gap that
            # can outweigh that round's submit segment under load
            assert agg_slow["bound_counts"].get("fit", 0) == 0, (
                f"delayed round attributed to fit: "
                f"{agg_slow['bound_counts']}"
            )

            # ledger gate: 3 healthy rows, then one slowed candidate —
            # regress on exactly one metric, and only for the slowed row
            led = BenchLedger(os.path.join(d, "BENCH_LEDGER.jsonl"))
            for i in range(3):
                led.record("drill_async",
                           {"value": 1000.0 + i, "round_ms": 50.0})
            healthy = led.compare("drill_async",
                                  {"value": 1001.0, "round_ms": 50.5})
            assert healthy["verdict"] == "ok", healthy
            slowed = led.compare("drill_async",
                                 {"value": 600.0, "round_ms": 51.0})
            assert slowed["verdict"] == "regress", slowed
            n_regress = sum(1 for e in slowed["metrics"].values()
                            if e["verdict"] == "regress")
            assert n_regress == 1, (
                f"expected regress on exactly 1 metric, got {n_regress}: "
                f"{slowed['metrics']}"
            )
        submit_mean = agg_slow["phase_mean_ms"].get("submit", 0.0)
        return (f"clean run bound_by={baseline_bound}, pipelined "
                f"(window=2) bound_by={agg_piped['bound_by']} with "
                f"fit>submit means (4 rounds, 0 orphans each); 0.3 s "
                f"scripted upload delay landed in the submit phase "
                f"({submit_mean:.0f} ms/round, bound_by="
                f"{agg_slow['bound_by']}); ledger: healthy row ok, "
                "slowed row regressed exactly 1 metric")

    ok &= _check("critical-path drill (submit-delay attribution + "
                 "ledger gate)", critical_path)

    def lock_witness():
        import threading

        from distriflow_tpu_torch.analysis.witness import (
            LockOrderViolation,
            OrderedLock,
            ordered_lock,
            reset_witness,
        )

        # zero-cost-off contract: the factory hands back a PLAIN lock when
        # the witness is disabled (no wrapper in any hot path by default)
        plain = ordered_lock("doctor.plain", enabled=False)
        if isinstance(plain, OrderedLock):
            raise RuntimeError("ordered_lock(enabled=False) returned a wrapper")

        reset_witness()
        try:
            a = OrderedLock("doctor.A")
            b = OrderedLock("doctor.B")

            # clean run: the same A -> B order from two threads is silent
            def take_ab():
                with a:
                    with b:
                        pass

            take_ab()
            t = threading.Thread(target=take_ab)
            t.start()
            t.join()

            # scripted inversion: B -> A must raise exactly once, at the
            # inner acquire, before the inner lock is touched
            raised = 0
            try:
                with b:
                    with a:
                        raise RuntimeError("inverted acquire succeeded")
            except LockOrderViolation:
                raised = 1
            if raised != 1:
                raise RuntimeError("lock-order inversion did not raise")

            # the refused acquire must not corrupt witness state: the
            # recorded order still works and the locks are all free
            take_ab()
        finally:
            reset_witness()
        return "inversion raised once; clean order silent"

    ok &= _check("lock-order witness drill (scripted inversion)", lock_witness)

    def pool_witness():
        """Pool-conservation witness drill (docs/ANALYSIS.md §6): a clean
        paged serving session balances ``free + referenced + shared ==
        pool size`` at every quiescence point; a scripted leak — one page
        allocated behind the engine's back — trips the witness exactly
        once; returning the page restores balance through ``stop()``."""
        import os

        import numpy as np

        from distriflow_tpu_torch.analysis.witness import (
            POOL_ENV_VAR,
            PoolConservationViolation,
        )
        from distriflow_tpu_torch.client import InferenceClient
        from distriflow_tpu_torch.server import InferenceServer
        from distriflow_tpu_torch.utils.config import ServingConfig

        model = _drill_model(device)
        prev = os.environ.get(POOL_ENV_VAR)
        os.environ[POOL_ENV_VAR] = "1"  # before __init__: witness arms there
        try:
            server = InferenceServer(
                model, port=0, serving=ServingConfig(
                    kv_layout="paged", page_size=16, max_slots=2,
                    page_pool_pages=24, batch_window_s=0.0)).setup()
            try:
                rng = np.random.default_rng(7)
                with InferenceClient(server.address) as c:
                    for n in (3, 5):
                        prompt = rng.integers(
                            1, 64, size=(1, 17)).astype(np.int32)
                        out = c.generate(prompt, n_tokens=n)
                        assert out.shape == (1, 17 + n)
                server.release_prefix_cache()  # flush-point verify inside
                wit = server._pool_witness
                clean_checks = wit.checks
                assert clean_checks > 0, "witness never checked"
                assert wit.trips == 0, f"clean session tripped {wit.trips}x"

                # scripted leak: one page taken behind the engine's back is
                # neither free nor slot-held nor prefix-shared
                leaked = server._pool.alloc(1)
                tripped = 0
                try:
                    server.verify_pool_conservation("doctor scripted leak")
                except PoolConservationViolation:
                    tripped = 1
                assert tripped == 1, "leaked page did not trip the witness"
                assert wit.trips == 1, f"expected 1 trip, saw {wit.trips}"

                # restitution: the freed page balances the pool again, and
                # stop() runs one more (passing) quiescence check
                server._pool.unref(leaked)
                server.verify_pool_conservation("doctor after restitution")
            finally:
                server.stop()
            assert wit.trips == 1 and wit.checks > clean_checks + 1
        finally:
            if prev is None:
                os.environ.pop(POOL_ENV_VAR, None)
            else:
                os.environ[POOL_ENV_VAR] = prev
        return (f"clean paged session balanced at {clean_checks} quiescence "
                f"point(s); scripted 1-page leak tripped the witness once; "
                f"restitution re-balanced through stop() "
                f"({wit.checks} checks total)")

    ok &= _check("pool-conservation witness drill (scripted page leak)",
                 pool_witness)

    def native():
        from distriflow_tpu_torch import native

        if not native.ensure_built():
            raise RuntimeError("C++ library not built (numpy fallback active)")
        return "C++ host kernels loaded"

    _check("native host library", native, mandatory=False)

    def checkpoint():
        import numpy as np

        from distriflow_tpu_torch.checkpoint import CheckpointStore

        with tempfile.TemporaryDirectory() as d:
            store = CheckpointStore(d)
            tree = {"w": np.arange(8, dtype=np.float32)}
            v = store.save(tree)
            out = store.load(v, tree)
            np.testing.assert_array_equal(out["w"], tree["w"])
        return "versioned round trip"

    ok &= _check("checkpoint store", checkpoint)

    print("all checks passed" if ok else "SOME CHECKS FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
