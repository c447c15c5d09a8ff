"""Port parity: the bench regression ledger (``distriflow_tpu_torch/obs/
ledger.py``), the ``dump`` CLI's ledger-side cases and the CUDA memory
gauge (``obs/cuda_hooks.py``).

- The cases of ``tests/test_ledger.py`` on the port's ledger and dump:
  verdict semantics, pinned bands, persistence and torn lines, the env
  override, the summary, ``--critical-path`` and the malformed-line
  counts, the snapshot-time sampler.
- The JAX and port ledgers read one rows file and give the same verdicts,
  per-metric entries and summary lines for the same candidates.
- ``install_cuda_hooks`` is idempotent per telemetry; on a process without
  CUDA the ``device_peak_bytes`` gauge is absent (it measures nothing
  there), as JAX's is on a CPU backend.
"""

import json

import pytest
import torch

from distriflow_tpu.obs import ledger as jax_ledger
from distriflow_tpu_torch.obs import Telemetry
from distriflow_tpu_torch.obs import ledger as port_ledger
from distriflow_tpu_torch.obs.cuda_hooks import install_cuda_hooks
from distriflow_tpu_torch.obs.ledger import (
    BANDS,
    DEFAULT_BAND,
    LEDGER_ENV,
    LEDGER_FILENAME,
    BenchLedger,
    band_for,
    lower_is_better,
)
from distriflow_tpu_torch.obs.tracing import SPANS_FILENAME

pytestmark = pytest.mark.port


# -- the same tables as JAX's ----------------------------------------------


def test_constants_equal_jax():
    assert port_ledger.BANDS == jax_ledger.BANDS
    assert port_ledger.DEFAULT_BAND == jax_ledger.DEFAULT_BAND
    assert port_ledger.VERDICTS == jax_ledger.VERDICTS
    assert LEDGER_ENV == jax_ledger.LEDGER_ENV == "BENCH_LEDGER_PATH"
    assert LEDGER_FILENAME == jax_ledger.LEDGER_FILENAME


@pytest.mark.parametrize("metric", ["step_ms", "up_bytes_per_update", "wall_secs", "mfu",
                                    "tokens_per_sec", "gflops", "roundms", "value"])
def test_direction_equals_jax(metric):
    assert lower_is_better(metric) == jax_ledger.lower_is_better(metric)


def test_direction_heuristic():
    assert lower_is_better("step_ms")
    assert lower_is_better("up_bytes_per_update")
    assert lower_is_better("wall_secs")
    assert not lower_is_better("mfu")
    assert not lower_is_better("tokens_per_sec")
    assert not lower_is_better("gflops")


def test_pinned_bands(tmp_path):
    assert band_for("cifar_async", "up_bytes_per_update") == BANDS[""]["up_bytes"]
    assert band_for("cifar_async", "mfu") == BANDS[""]["mfu"]
    assert band_for("cifar_async", "no_such_metric") == DEFAULT_BAND
    led = BenchLedger(str(tmp_path / "L.jsonl"))
    row = led.record("cfg", {"step_ms": 10.0, "mfu": 0.4, "note": "x"})
    assert row["metrics"] == {"step_ms": 10.0, "mfu": 0.4}  # non-numeric dropped
    assert row["bands"]["mfu"] == BANDS[""]["mfu"]
    assert row["bands"]["step_ms"] == DEFAULT_BAND


# -- verdicts ---------------------------------------------------------------


def _ledger(tmp_path):
    return BenchLedger(str(tmp_path / "BENCH_LEDGER.jsonl"))


def test_first_run_seeds_ok(tmp_path):
    cmp_ = _ledger(tmp_path).compare("cfg", {"step_ms": 100.0})
    assert cmp_["verdict"] == "ok" and cmp_["history_rows"] == 0


def test_verdicts_vs_best_and_prev(tmp_path):
    led = _ledger(tmp_path)
    led.record("cfg", {"step_ms": 100.0, "mfu": 0.40})
    led.record("cfg", {"step_ms": 104.0, "mfu": 0.39})
    assert led.compare("cfg", {"step_ms": 105.0})["verdict"] == "ok"
    assert led.compare("cfg", {"step_ms": 115.0})["verdict"] == "warn"
    got = led.compare("cfg", {"step_ms": 130.0})
    assert got["verdict"] == "regress"
    assert got["metrics"]["step_ms"]["vs_best_pct"] == pytest.approx(30.0)
    assert led.compare("cfg", {"mfu": 0.28})["verdict"] == "regress"
    assert led.compare("cfg", {"step_ms": 50.0, "mfu": 0.9})["verdict"] == "ok"
    assert led.compare("other", {"step_ms": 900.0})["verdict"] == "ok"


def test_warn_vs_prev_cannot_regress(tmp_path):
    led = _ledger(tmp_path)
    led.record("cfg", {"step_ms": 100.0})
    led.record("cfg", {"step_ms": 70.0})
    got = led.compare("cfg", {"step_ms": 78.5})
    assert got["verdict"] == "warn"
    assert "vs_best_pct" in got["metrics"]["step_ms"]
    assert led.compare("cfg", {"step_ms": 65.0})["verdict"] == "ok"


def test_regress_fires_exactly_once_per_slowed_metric(tmp_path):
    led = _ledger(tmp_path)
    for i in range(3):
        led.record("cfg", {"value": 1000.0 + i, "round_ms": 50.0})
    got = led.compare("cfg", {"value": 600.0, "round_ms": 51.0})
    assert got["verdict"] == "regress"
    assert [e["verdict"] for e in got["metrics"].values()].count("regress") == 1


def test_persistence_and_torn_lines(tmp_path):
    led = _ledger(tmp_path)
    led.record("cfg", {"step_ms": 100.0}, run_id="r1")
    with open(led.path, "a") as f:
        f.write("{torn mid-append\n")
        f.write(json.dumps({"no": "metrics key"}) + "\n")
    led.record("cfg", {"step_ms": 90.0}, run_id="r2")
    led2 = BenchLedger(led.path)
    assert [r["run_id"] for r in led2.rows("cfg")] == ["r1", "r2"]
    assert led2.best("cfg", "step_ms") == 90.0
    assert led2.compare("cfg", {"step_ms": 91.0})["verdict"] == "ok"


def test_env_override(tmp_path, monkeypatch):
    monkeypatch.setenv(LEDGER_ENV, str(tmp_path / "elsewhere.jsonl"))
    led = BenchLedger()
    assert led.path == str(tmp_path / "elsewhere.jsonl")
    led.record("cfg", {"v": 1.0})
    assert (tmp_path / "elsewhere.jsonl").exists()


def test_summary_renders_flagged_metrics(tmp_path):
    led = _ledger(tmp_path)
    led.record("cfg", {"step_ms": 100.0})
    s = led.summary(led.compare("cfg", {"step_ms": 140.0}))
    assert "regress" in s and "step_ms" in s
    assert "ok" in led.summary(led.compare("cfg", {"step_ms": 100.0}))


# -- both ledgers over one rows file -----------------------------------------

_HISTORY = [("cfg", {"step_ms": 100.0, "mfu": 0.40, "up_bytes_per_update": 4096.0}),
            ("cfg", {"step_ms": 104.0, "mfu": 0.39, "up_bytes_per_update": 4096.0}),
            ("cfg", {"step_ms": 70.0, "mfu": 0.41, "up_bytes_per_update": 4100.0}),
            ("serving_paged_mixed", {"value": 2.0, "prefix_hit_rate": 0.5}),
            ("drill_async", {"value": 1000.0, "round_ms": 50.0}),
            ("drill_async", {"value": 1001.0, "round_ms": 50.0})]

_CANDIDATES = [("cfg", {"step_ms": 71.0}), ("cfg", {"step_ms": 78.5}),
               ("cfg", {"step_ms": 95.0, "mfu": 0.30}), ("cfg", {"up_bytes_per_update": 4200.0}),
               ("cfg", {"step_ms": 50.0, "mfu": 0.9, "new_metric": 3.0}),
               ("serving_paged_mixed", {"value": 1.8, "prefix_hit_rate": 0.2}),
               ("drill_async", {"value": 600.0, "round_ms": 51.0}),
               ("unseen", {"step_ms": 1.0})]


def _strip_time(cmp_):
    return {k: v for k, v in cmp_.items() if k not in ("time", "timestamp")}


@pytest.mark.parametrize("case", range(len(_CANDIDATES)))
def test_same_rows_file_same_verdicts(tmp_path, case):
    path = str(tmp_path / "BENCH_LEDGER.jsonl")
    writer = jax_ledger.BenchLedger(path)
    for i, (cfg, metrics) in enumerate(_HISTORY):
        writer.record(cfg, metrics, run_id=f"r{i}")
    with open(path, "a") as f:
        f.write("{torn\n")
    cfg, metrics = _CANDIDATES[case]
    want = jax_ledger.BenchLedger(path).compare(cfg, metrics)
    got = BenchLedger(path).compare(cfg, metrics)
    assert _strip_time(got) == _strip_time(want)
    assert BenchLedger(path).summary(got).splitlines() == \
        jax_ledger.BenchLedger(path).summary(want).splitlines()


def test_port_rows_read_by_jax(tmp_path):
    path = str(tmp_path / "BENCH_LEDGER.jsonl")
    led = BenchLedger(path)
    for i, (cfg, metrics) in enumerate(_HISTORY):
        led.record(cfg, metrics, run_id=f"r{i}")
    jled = jax_ledger.BenchLedger(path)
    assert jled.rows("cfg") == led.rows("cfg")
    assert jled.best("cfg", "step_ms") == led.best("cfg", "step_ms") == 70.0


# -- dump CLI ---------------------------------------------------------------


def _span_row(name, t0, dur_ms, **attrs):
    return {"name": name, "trace_id": "f" * 32, "span_id": f"s-{name}",
            "start": t0 + 500.0, "mono": t0, "pid": 1, "dur_ms": dur_ms,
            "status": "ok", **attrs}


def test_dump_critical_path_cli(tmp_path, capsys):
    from distriflow_tpu_torch.obs import dump

    rows = [_span_row("upload", 0.0, 80.0, update_id="u1", serialize_ms=5.0),
            _span_row("apply", 0.05, 10.0, update_id="u1", accepted=True)]
    (tmp_path / SPANS_FILENAME).write_text("".join(json.dumps(r) + "\n" for r in rows)
                                           + "{torn\n")
    rc = dump.main([str(tmp_path), "--critical-path"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "1 applied" in out and "bound_by=submit" in out
    assert "1 malformed jsonl line(s) skipped" in out
    assert dump.main([str(tmp_path / "empty"), "--critical-path"]) == 2


def test_dump_counts_malformed_metric_lines(tmp_path, capsys):
    from distriflow_tpu_torch.obs import dump

    (tmp_path / "metrics.jsonl").write_text(
        json.dumps({"time": 1.0, "loss": 2.0}) + "\n{half a row\n")
    (tmp_path / SPANS_FILENAME).write_text(
        json.dumps(_span_row("upload", 0.0, 5.0)) + "\nnot json at all\n")
    assert dump.main([str(tmp_path)]) == 0
    assert capsys.readouterr().out.count("1 malformed line(s) skipped") == 2


# -- snapshot-time sampler and the CUDA memory gauge --------------------------


def test_register_sampler_runs_at_snapshot():
    tel = Telemetry()
    calls = []
    tel.register_sampler(lambda: calls.append(1))

    def bad():
        raise RuntimeError("sampler must never break a snapshot")

    tel.register_sampler(bad)
    assert isinstance(tel.snapshot(), dict) and calls == [1]
    tel.snapshot()
    assert calls == [1, 1]


def test_cuda_hooks_idempotent_and_absent_on_cpu():
    assert not torch.cuda.is_available()  # this suite runs on the CPU
    tel = Telemetry()
    assert install_cuda_hooks(tel) is True
    assert install_cuda_hooks(tel) is True  # idempotent per telemetry
    assert len(tel._samplers) == 1
    snap = tel.snapshot()
    assert not any(k.startswith("device_peak_bytes") for k in snap["gauges"]), snap["gauges"]
    assert tel.registry.find("device_peak_bytes", device="cuda:0") is None
    # a second telemetry gets its own sampler
    other = Telemetry()
    assert install_cuda_hooks(other) is True and len(other._samplers) == 1


def test_cuda_hooks_disabled_and_global():
    from distriflow_tpu_torch.obs.telemetry import set_telemetry

    assert install_cuda_hooks(Telemetry(enabled=False)) is False
    fresh = Telemetry()
    prev = set_telemetry(fresh)
    try:
        assert install_cuda_hooks() is True  # the process-global telemetry
        assert len(fresh._samplers) == 1 and install_cuda_hooks(fresh) is True
        assert len(fresh._samplers) == 1
    finally:
        set_telemetry(prev)


def test_cuda_sampler_reads_the_allocator_peak(monkeypatch):
    """With the CUDA calls stubbed, the gauge is the allocator's
    ``allocated_bytes.all.peak`` per card, labelled ``cuda:<i>``; a card
    whose allocator was never used is skipped."""
    stats = {0: {"allocated_bytes.all.peak": 123456789}, 1: {}}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: stats[i])
    tel = Telemetry()
    install_cuda_hooks(tel)
    gauges = tel.snapshot()["gauges"]
    assert gauges["device_peak_bytes{device=cuda:0}"] == 123456789.0
    assert not any("cuda:1" in k for k in gauges)
