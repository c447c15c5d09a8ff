"""Port of ``distriflow_tpu/obs/ledger.py`` (copied with its imports rewritten).

Append-only bench regression ledger.

The BENCH_r*.json snapshots record every bench run, but comparing them
is folklore: a human opens two files, eyeballs the deltas, and decides
whether 0.3965 MFU against a best of 0.43 is noise or a regression.
This module turns that into a gate. Every bench row is appended to a
persistent JSONL ledger (``BENCH_LEDGER.jsonl``, env override
``BENCH_LEDGER_PATH``) together with the tolerance band that was in
force when it was recorded, and :meth:`BenchLedger.compare` renders a
per-metric verdict — ``ok`` / ``warn`` / ``regress`` — against BOTH the
best row in history and the immediately previous run of the same
config. Pinning the band per row means tightening a tolerance later
never rewrites history's verdicts.

Direction is inferred from the metric name: ``*_ms``/``*ms`` and
``*bytes*`` metrics are lower-is-better, everything else (mfu, gflops,
tokens/s) higher-is-better. ``compare()``'s headline verdict is the
worst of the two comparisons; ``regress`` fires only when the delta
exceeds the regress band against best-of-history — a slow previous run
alone can at most ``warn``.

PERFORMANCE.md documents the workflow a perf PR follows to prove its
claim against this file.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

LEDGER_ENV = "BENCH_LEDGER_PATH"
LEDGER_FILENAME = "BENCH_LEDGER.jsonl"

#: default tolerance band, pinned into every row at record time:
#: ``warn_pct`` beyond best/previous → warn; ``regress_pct`` beyond best
#: → regress. Benches on shared CPU runners are noisy; the defaults are
#: deliberately loose — per-config overrides tighten where it matters.
DEFAULT_BAND = {"warn_pct": 10.0, "regress_pct": 25.0}

#: per-(config, metric-prefix) band overrides. Keys are matched with
#: ``str.startswith`` on the metric name so one entry covers e.g.
#: ``up_bytes_per_update`` and ``down_bytes_per_broadcast``. Wire sizes
#: are deterministic — any growth is a real encoding change.
BANDS: Dict[str, Dict[str, Dict[str, float]]] = {
    "": {  # every config
        "up_bytes": {"warn_pct": 0.5, "regress_pct": 2.0},
        "down_bytes": {"warn_pct": 0.5, "regress_pct": 2.0},
        "mfu": {"warn_pct": 8.0, "regress_pct": 20.0},
    },
    "serving_paged_mixed": {
        # "value" is the capacity headline (concurrent requests sustained
        # at equal KV HBM, paged / slab) and must not quietly erode;
        # occupancy and hit-rate are diagnostics with wider slack —
        # scheduler timing jitters them
        "value": {"warn_pct": 5.0, "regress_pct": 15.0},
        "prefix_hit_rate": {"warn_pct": 20.0, "regress_pct": 50.0},
        "page_occupancy": {"warn_pct": 20.0, "regress_pct": 50.0},
    },
    "serving_speculative": {
        # round-12 draft/verify row (docs/PERFORMANCE.md §7g): "value" is
        # the spec-vs-plain decode speedup at the distilled short context
        # and guards the serving-plane mechanics; the per-context ms/token
        # pairs get CI-host slack like the other serving latencies.
        # accepted_per_step / accept_rate are pinned by the in-leg
        # distillation (near-ceiling at the short context by construction)
        # — movement there means the draft plumbing changed, not the host.
        # distill_secs is setup cost, advisory-only.
        "value": {"warn_pct": 10.0, "regress_pct": 25.0},
        "spec_ms_tok": {"warn_pct": 15.0, "regress_pct": 40.0},
        "plain_ms_tok": {"warn_pct": 15.0, "regress_pct": 40.0},
        "accepted_per_step": {"warn_pct": 15.0, "regress_pct": 40.0},
        "accept_rate_1k": {"warn_pct": 10.0, "regress_pct": 25.0},
        "accept_rate_16k": {"warn_pct": 1e9, "regress_pct": 1e9},
        "distill_secs": {"warn_pct": 1e9, "regress_pct": 1e9},
    },
    "serving_fleet": {
        # round-13 fleet-router row (docs/PERFORMANCE.md §7h): "value" is
        # the affinity-vs-round-robin aggregate tok/s/user speedup on
        # shared-prefix traffic under pool pressure and guards the router
        # win itself; the per-leg throughputs get CI-host slack. The hit
        # rates are structural (which replica admitted which group) so
        # they move only when routing logic changes; the round-robin leg's
        # numbers are the baseline diagnostics.
        "value": {"warn_pct": 10.0, "regress_pct": 25.0},
        "affinity_tok_s_user": {"warn_pct": 15.0, "regress_pct": 40.0},
        "rr_tok_s_user": {"warn_pct": 15.0, "regress_pct": 40.0},
        "affinity_hit_rate": {"warn_pct": 10.0, "regress_pct": 25.0},
        "rr_hit_rate": {"warn_pct": 1e9, "regress_pct": 1e9},
    },
    "transformer_moe_flagship": {
        # round-12 phase attribution (router/dispatch/expert/combine via
        # the exact-FLOP tally): shares of a jittery step_ms, so they get
        # the same CI-host slack as the serving latencies. "other" is the
        # unattributed remainder — diagnostic only.
        "top2_": {"warn_pct": 15.0, "regress_pct": 40.0},
    },
    "long_context": {
        # prefill seconds / ms-per-token on 16k-32k prompts: chunked
        # prefill makes these steady, but CI hosts jitter ~15%
        "prefill_secs": {"warn_pct": 15.0, "regress_pct": 40.0},
        "ms_per_token": {"warn_pct": 15.0, "regress_pct": 40.0},
    },
    "obs_overhead": {
        # fleet telemetry plane cost (docs/OBSERVABILITY.md §10): the
        # guarded numbers are the absolute on/off round times; the
        # headline delta ("value"/"overhead_ms") is a difference of two
        # jittery loopback means — often sub-ms, sometimes negative —
        # so its pct-of-reference gate is advisory-only. "reports" is a
        # count, not a performance number.
        "obs_on_round_ms": {"warn_pct": 50.0, "regress_pct": 150.0},
        "obs_off_round_ms": {"warn_pct": 50.0, "regress_pct": 150.0},
        "overhead_ms": {"warn_pct": 1e9, "regress_pct": 1e9},
        "value": {"warn_pct": 1e9, "regress_pct": 1e9},
        "reports": {"warn_pct": 1e9, "regress_pct": 1e9},
    },
    "serving_slo": {
        # mixed-tier serving SLOs over two replicas behind the router
        # (docs/OBSERVABILITY.md §11): "value" is fleet goodput — the
        # guarded headline. Per-tier TTFT/TPOT quantiles and the
        # trace-on/off legs are absolute loopback wall times on shared
        # runners, guarded loosely like the obs_overhead rows; the
        # overhead delta is a difference of two jittery means (often
        # sub-ms) so its pct-of-reference gate is advisory-only.
        "ttft_": {"warn_pct": 50.0, "regress_pct": 150.0},
        "tpot_": {"warn_pct": 50.0, "regress_pct": 150.0},
        "trace_on_ms": {"warn_pct": 50.0, "regress_pct": 150.0},
        "trace_off_ms": {"warn_pct": 50.0, "regress_pct": 150.0},
        "trace_overhead_ms": {"warn_pct": 1e9, "regress_pct": 1e9},
        "requests": {"warn_pct": 1e9, "regress_pct": 1e9},
        "shed": {"warn_pct": 1e9, "regress_pct": 1e9},
        "failovers": {"warn_pct": 1e9, "regress_pct": 1e9},
    },
    "serving_elastic": {
        # round-19 elastic-fleet row (docs/ROBUSTNESS.md §11): "value" is
        # the unhedged/hedged straggler p50 ratio. Every request is
        # identically straggled by a scripted 1 s admission window, so
        # the medians are window-dominated and steady; the ratio and the
        # p50s get serving-latency slack. The p99s are single-worst-wall
        # loopback times on shared runners — guarded very loosely. Hedge
        # counters and churn goodput are structural (every straggler
        # request hedges and the second owner wins; drain drops nothing)
        # and the join/leave remap fractions are sha1-deterministic over
        # a fixed key set — ANY movement there is a real ring change, so
        # they get wire-size-tight bands.
        "value": {"warn_pct": 25.0, "regress_pct": 60.0},
        "unhedged_p50_ms": {"warn_pct": 30.0, "regress_pct": 80.0},
        "hedged_p50_ms": {"warn_pct": 30.0, "regress_pct": 80.0},
        "unhedged_p99_ms": {"warn_pct": 50.0, "regress_pct": 150.0},
        "hedged_p99_ms": {"warn_pct": 50.0, "regress_pct": 150.0},
        "hedges": {"warn_pct": 0.5, "regress_pct": 2.0},
        "hedge_wins": {"warn_pct": 0.5, "regress_pct": 2.0},
        "churn_goodput": {"warn_pct": 0.5, "regress_pct": 2.0},
        "join_remap_frac": {"warn_pct": 0.5, "regress_pct": 2.0},
        "leave_remap_frac": {"warn_pct": 0.5, "regress_pct": 2.0},
    },
    "fleet_soak": {
        # churn+chaos soak row (docs/ROBUSTNESS.md §10): the run itself
        # enforces the exactness invariants (it raises on violation), so
        # the ledger only pins the performance of surviving the abuse.
        # Goodput ("value") is loopback wall time over hundreds of
        # threads on a shared host — guarded loosely; the p99 latencies
        # likewise. Churn/dedup/suppression/adaptation counts are
        # seeded-schedule structure, not performance — advisory-only —
        # and final_loss moves with apply interleaving, bounded by the
        # in-run convergence audit rather than the ledger.
        "value": {"warn_pct": 40.0, "regress_pct": 100.0},
        "goodput_applies_per_s": {"warn_pct": 40.0, "regress_pct": 100.0},
        "round_p99_ms": {"warn_pct": 50.0, "regress_pct": 150.0},
        "ack_p99_ms": {"warn_pct": 50.0, "regress_pct": 150.0},
        "clients": {"warn_pct": 1e9, "regress_pct": 1e9},
        "kills": {"warn_pct": 1e9, "regress_pct": 1e9},
        "rejoins": {"warn_pct": 1e9, "regress_pct": 1e9},
        "deduped": {"warn_pct": 1e9, "regress_pct": 1e9},
        "suppressed": {"warn_pct": 1e9, "regress_pct": 1e9},
        "adaptations": {"warn_pct": 1e9, "regress_pct": 1e9},
        "final_loss": {"warn_pct": 1e9, "regress_pct": 1e9},
    },
    "cifar10_convnet_async_bounded_staleness": {
        # round-6 semantic change: floor_ms/ceiling_sps are now derived
        # from the continuous profiler's phase digests (per-upload
        # bottleneck-stage time) instead of the r05 tiny-op dispatch
        # hand-math. Values across the boundary measure different
        # quantities, so history comparison is advisory-only here —
        # samples/sec ("value") remains the guarded headline.
        "floor_ms": {"warn_pct": 1e9, "regress_pct": 1e9},
        "ceiling_sps": {"warn_pct": 1e9, "regress_pct": 1e9},
    },
}

_LOWER_BETTER_TOKENS = ("ms", "bytes", "secs", "seconds", "occupancy")

VERDICTS = ("ok", "warn", "regress")


def default_path() -> str:
    return os.environ.get(LEDGER_ENV, LEDGER_FILENAME)


def band_for(config: str, metric: str) -> Dict[str, float]:
    """The tolerance band in force for (config, metric) right now."""
    for cfg in (config, ""):
        for prefix, band in BANDS.get(cfg, {}).items():
            if metric.startswith(prefix):
                return dict(band)
    return dict(DEFAULT_BAND)


def lower_is_better(metric: str) -> bool:
    parts = metric.lower().replace("-", "_").split("_")
    return any(tok in parts or metric.lower().endswith(tok)
               for tok in _LOWER_BETTER_TOKENS)


def _regression_pct(metric: str, value: float, reference: float) -> float:
    """How much WORSE ``value`` is than ``reference``, in percent of the
    reference (<= 0 means no worse)."""
    if reference == 0:
        return 0.0
    delta = (value - reference) / abs(reference) * 100.0
    return delta if lower_is_better(metric) else -delta


class BenchLedger:
    """Persistent append-only bench history with pinned tolerance bands."""

    def __init__(self, path: Optional[str] = None):
        self.path = str(path) if path else default_path()

    # -- recording ---------------------------------------------------------

    def record(self, config: str, metrics: Dict[str, Any],
               run_id: Optional[str] = None,
               meta: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Append one bench row. ``metrics`` keeps only finite numeric
        values; each gets the band in force right now pinned alongside it.
        Returns the row as written."""
        clean: Dict[str, float] = {}
        bands: Dict[str, Dict[str, float]] = {}
        for k, v in metrics.items():
            try:
                f = float(v)
            except (TypeError, ValueError):
                continue
            if f != f or f in (float("inf"), float("-inf")):
                continue
            clean[k] = f
            bands[k] = band_for(config, k)
        row = {
            "time": time.time(),
            "config": str(config),
            "run_id": run_id,
            "metrics": clean,
            "bands": bands,
        }
        if meta:
            row["meta"] = meta
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(self.path, "a") as f:
            f.write(json.dumps(row) + "\n")
        return row

    # -- reading -----------------------------------------------------------

    def rows(self, config: Optional[str] = None) -> List[Dict[str, Any]]:
        """All rows (oldest first), torn/malformed lines skipped."""
        if not os.path.exists(self.path):
            return []
        out: List[Dict[str, Any]] = []
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    row = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if not isinstance(row, dict) or "metrics" not in row:
                    continue
                if config is None or row.get("config") == config:
                    out.append(row)
        return out

    def best(self, config: str, metric: str,
             rows: Optional[List[Dict[str, Any]]] = None
             ) -> Optional[float]:
        """Best historical value of ``metric`` for ``config``."""
        rows = self.rows(config) if rows is None else rows
        vals = [r["metrics"][metric] for r in rows
                if metric in r.get("metrics", {})]
        if not vals:
            return None
        return min(vals) if lower_is_better(metric) else max(vals)

    # -- the gate ----------------------------------------------------------

    def compare(self, config: str, metrics: Dict[str, Any],
                history: Optional[List[Dict[str, Any]]] = None
                ) -> Dict[str, Any]:
        """Verdict for a CANDIDATE row against the ledger (the candidate
        itself need not be recorded yet — bench compares, then records).

        Per metric: ``regress`` iff worse than best-of-history by more
        than the regress band, ``warn`` iff worse than best OR previous
        run by more than the warn band, else ``ok``. The headline
        ``verdict`` is the worst per-metric verdict; with no history it
        is ``ok`` (first run seeds the ledger)."""
        rows = self.rows(config) if history is None else [
            r for r in history if r.get("config") == config]
        prev = rows[-1] if rows else None
        per_metric: Dict[str, Dict[str, Any]] = {}
        worst = "ok"
        for metric, value in metrics.items():
            try:
                v = float(value)
            except (TypeError, ValueError):
                continue
            band = band_for(config, metric)
            best = self.best(config, metric, rows=rows)
            prev_v = (prev or {}).get("metrics", {}).get(metric)
            entry: Dict[str, Any] = {
                "value": v, "best": best, "prev": prev_v,
                "band": band, "verdict": "ok",
            }
            if best is not None:
                pct_best = _regression_pct(metric, v, best)
                entry["vs_best_pct"] = round(pct_best, 3)
                if pct_best > band["regress_pct"]:
                    entry["verdict"] = "regress"
                elif pct_best > band["warn_pct"]:
                    entry["verdict"] = "warn"
            if prev_v is not None and entry["verdict"] == "ok":
                pct_prev = _regression_pct(metric, v, float(prev_v))
                entry["vs_prev_pct"] = round(pct_prev, 3)
                if pct_prev > band["warn_pct"]:
                    entry["verdict"] = "warn"
            per_metric[metric] = entry
            if VERDICTS.index(entry["verdict"]) > VERDICTS.index(worst):
                worst = entry["verdict"]
        return {
            "config": config,
            "verdict": worst,
            "metrics": per_metric,
            "history_rows": len(rows),
        }

    def summary(self, comparison: Dict[str, Any]) -> str:
        """One-line human rendering of a compare() result."""
        flagged = [f"{m}:{e['verdict']}"
                   + (f"({e.get('vs_best_pct', e.get('vs_prev_pct', 0)):+.1f}%"
                      f" vs {'best' if 'vs_best_pct' in e else 'prev'})"
                      if e["verdict"] != "ok" else "")
                   for m, e in sorted(comparison["metrics"].items())
                   if e["verdict"] != "ok"]
        head = f"ledger[{comparison['config']}]: {comparison['verdict']}"
        if flagged:
            return head + " (" + ", ".join(flagged) + ")"
        return head + f" ({len(comparison['metrics'])} metric(s), "\
                      f"{comparison['history_rows']} prior row(s))"
