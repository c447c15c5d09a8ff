"""Port parity: the static-analysis plane (``distriflow_tpu_torch/analysis``)
pointed at the port.

- **Cross-package oracle.** Every ``tmp_path`` case of JAX's
  ``tests/test_analysis.py`` but the four tracing ones runs with its
  ``_findings`` (and, for the CLI cases, ``subprocess.run``) routed through
  both analyzers: each fixture source gives the same ``(check, line,
  symbol, detail)`` set in both, and the JAX case's own assertions still
  hold.
- **The whole-package gate over the port:** zero non-baselined findings,
  no stale baseline entries, every reason non-empty, every ``*.py`` parsed.
- **Planted faults** in a copy of the port's ``server/inference_server.py``:
  the lock, wire and resource families read the serving engine.
- **The CLI:** ``--json``, the ``--check`` selectors, ``tracing`` refused.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import pytest

from distriflow_tpu.analysis import run_checks as jax_run_checks
from distriflow_tpu.analysis.core import load_baseline as jax_load_baseline
from distriflow_tpu_torch.analysis import ALL_FAMILIES, run_checks
from distriflow_tpu_torch.analysis.core import (
    BASELINE_PATH,
    PACKAGE_ROOT,
    load_baseline,
    load_modules,
    match_baseline,
)

pytestmark = [pytest.mark.port, pytest.mark.analysis]

_JAX_TESTS = Path(__file__).with_name("test_analysis.py")
_PORT_CLI = "distriflow_tpu_torch.analysis"

#: the ``tmp_path`` cases of JAX's tests/test_analysis.py that reach an
#: analyzer (all but the tracing family, which the port does not carry)
ORACLE_CASES = [
    "test_guarded_by_miss_is_flagged",
    "test_guarded_by_hit_is_silent",
    "test_holds_annotation_trusts_caller",
    "test_locked_suffix_helper_is_allowlisted",
    "test_inline_ignore_suppresses",
    "test_lock_order_cycle_is_flagged",
    "test_consistent_lock_order_is_silent",
    "test_undocumented_metric_is_flagged",
    "test_documented_metric_is_silent",
    "test_metric_without_help_is_flagged",
    "test_metric_ident_needs_no_help",
    "test_fleet_prefix_outside_collector_is_flagged",
    "test_unbalanced_span_is_flagged",
    "test_balanced_span_shapes_are_silent",
    "test_undocumented_phase_is_flagged",
    "test_undocumented_phase_ignore_comment",
    "test_baseline_rejects_missing_reason",
    "test_fingerprint_survives_line_moves",
    "test_match_baseline_splits_fresh_and_stale",
    "test_cli_json_reports_and_fails_on_findings",
    "test_wire_bound_payload_hit_is_silent",
    "test_wire_unknown_key_is_flagged",
    "test_wire_unguarded_optional_subscript_is_flagged",
    "test_wire_not_in_early_exit_proves_the_rest",
    "test_wire_to_wire_unknown_key_is_drift",
    "test_wire_to_wire_missing_required_is_drift",
    "test_wire_message_attribute_and_ctor_checked",
    "test_resource_balanced_finally_is_silent",
    "test_resource_bare_discard_is_a_leak",
    "test_resource_never_released_is_a_leak",
    "test_resource_raise_between_acquire_and_release_leaks",
    "test_resource_acquire_name_mismatch_is_flagged",
    "test_resource_missing_release_def_is_flagged",
    "test_resource_state_mode_dead_release_is_flagged",
    "test_resource_counter_unpaired_on_release_path",
    "test_lock_order_cycle_through_call_chain_is_flagged",
    "test_holds_inference_covers_always_locked_helper",
    "test_cli_check_wire_selector",
    "test_cli_check_resource_selector",
]
TRACING_CASES = [
    "test_side_effect_in_jit_body_is_flagged",
    "test_concretization_of_traced_value_is_flagged",
    "test_static_attrs_and_pure_body_are_silent",
    "test_scan_body_is_linted",
]


def _jax_tests():
    spec = importlib.util.spec_from_file_location("_jax_test_analysis", _JAX_TESTS)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _keys(findings):
    return {(f.check, f.line, f.symbol, f.detail) for f in findings}


def _cli_keys(stdout):
    return {(f["check"], f["line"], f["symbol"], f["fingerprint"])
            for f in json.loads(stdout)["findings"]}


def test_oracle_list_covers_every_tmp_path_case():
    import ast

    tree = ast.parse(_JAX_TESTS.read_text())
    tmp_cases = {n.name for n in tree.body
                 if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")
                 and any(a.arg == "tmp_path" for a in n.args.args)}
    assert tmp_cases == set(ORACLE_CASES) | set(TRACING_CASES)
    assert len(ORACLE_CASES) == len(set(ORACLE_CASES))


@pytest.mark.parametrize("case", ORACLE_CASES)
def test_fixture_oracle(case, tmp_path, monkeypatch):
    jt = _jax_tests()
    seen = []

    def both(tmp, source, checks):
        (tmp / "fixture.py").write_text(source)
        want = jax_run_checks([tmp], checks=checks)
        got = run_checks([tmp], checks=checks)
        seen.append((_keys(want), _keys(got)))
        return want

    real_run = subprocess.run

    def both_cli(argv, **kw):
        want = real_run(argv, **kw)
        port_argv = [_PORT_CLI if a == "distriflow_tpu.analysis" else a for a in argv]
        assert port_argv != argv
        got = real_run(port_argv, **kw)
        seen.append(((want.returncode, _cli_keys(want.stdout)),
                     (got.returncode, _cli_keys(got.stdout))))
        return want

    def both_baseline(path):
        with pytest.raises(ValueError, match="triage reason"):
            load_baseline(path)
        seen.append(("raises", "raises"))
        return jax_load_baseline(path)

    monkeypatch.setattr(jt, "_findings", both)
    monkeypatch.setattr(jt, "load_baseline", both_baseline)
    monkeypatch.setattr(subprocess, "run", both_cli)
    getattr(jt, case)(tmp_path)  # the JAX case's own assertions hold
    assert seen, f"{case} reached no analyzer"
    for want, got in seen:
        assert got == want


# ---------------------------------------------------------------------------
# the whole-package gate over the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_findings():
    return run_checks([PACKAGE_ROOT])


def test_port_has_zero_nonbaselined_findings(port_findings):
    fresh, _stale = match_baseline(port_findings, load_baseline())
    assert fresh == [], "\n".join(f.render() for f in fresh)


def test_port_baseline_has_no_stale_entries(port_findings):
    _fresh, stale = match_baseline(port_findings, load_baseline())
    assert stale == [], f"baseline entries nothing matches anymore: {stale}"


def test_port_baseline_entries_all_carry_reasons():
    assert BASELINE_PATH == PACKAGE_ROOT / "analysis" / "baseline.json"
    entries = load_baseline()
    assert entries
    for fp, reason in entries.items():
        assert fp.count(":") >= 3
        assert reason.strip()
        # fingerprints name the port's files or the docs it reads
        assert fp.split(":")[1].split("/")[0] in ("distriflow_tpu_torch", "docs")


def test_port_parses_completely():
    mods = load_modules([PACKAGE_ROOT])
    py_files = set(PACKAGE_ROOT.rglob("*.py"))
    assert len(mods) == len(py_files)
    assert all(m.relpath.startswith("distriflow_tpu_torch/") for m in mods)


def test_port_phase_taxonomy_documents_the_apply_phases():
    from distriflow_tpu_torch.analysis.obs_check import collect_doc_phases

    names = collect_doc_phases()
    assert {"template", "deserialize", "mean", "update", "rollback_guard",
            "download"} <= names
    # and the reference's taxonomy is still read
    assert {"request", "route", "queue_wait", "admission", "prefill",
            "decode_iter", "retire", "quarantine", "apply"} <= names


# ---------------------------------------------------------------------------
# planted faults in the serving engine
# ---------------------------------------------------------------------------

_SERVER = PACKAGE_ROOT / "server" / "inference_server.py"

PLANTED = {
    # _retire_slot detaches its pages, counts them freed, never unrefs them
    "retire_drops_unref": (
        "                self._pool.unref(pages)\n"
        "                self._tables[s, :] = self._n_pages\n",
        "                self._tables[s, :] = self._n_pages\n",
        ["resource"], "resource-leak",
        "_reserve:_retire_slot:pages:counted-unreleased"),
    # _release_plan frees pages but no longer counts them
    "release_plan_drops_count": (
        "        self._pool.unref(pages)\n"
        "        self._m_pages_freed.inc(len(pages))\n",
        "        self._pool.unref(pages)\n",
        ["resource"], "counter-unpaired",
        "_reserve:_release_plan:_m_pages_freed:unbumped"),
    # a dedup-cache read with its lock removed
    "dedup_read_unlocked": (
        "            with self._dedup_lock:\n"
        "                cached = self._req_results.get(rid)\n"
        "            if cached is not None:\n",
        "            cached = self._req_results.get(rid)\n"
        "            if cached is not None:\n",
        ["lock"], "lock-discipline", "_req_results"),
    # an optional generate-request field read without a guard
    "generate_reads_optional_unguarded": (
        '        top_k = payload.get("top_k")\n',
        '        top_k = payload["top_k"]\n',
        ["wire"], "wire-version", "generate_request.top_k:unversioned-read"),
}


@pytest.mark.parametrize("fault", sorted(PLANTED))
def test_planted_fault_in_serving_engine(fault, tmp_path):
    old, new, checks, check, detail = PLANTED[fault]
    source = _SERVER.read_text()
    assert source.count(old) == 1, f"{fault}: the site moved"
    pristine = tmp_path / "pristine"
    planted = tmp_path / "planted"
    pristine.mkdir()
    planted.mkdir()
    (pristine / "inference_server.py").write_text(source)
    (planted / "inference_server.py").write_text(source.replace(old, new))
    assert run_checks([pristine], checks=checks) == []
    found = run_checks([planted], checks=checks)
    assert [(f.check, f.detail) for f in found] == [(check, detail)], \
        "\n".join(f.render() for f in found)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _cli(*args):
    return subprocess.run([sys.executable, "-m", _PORT_CLI, *args],
                          capture_output=True, text=True, timeout=120)


def test_cli_exits_zero_over_the_port():
    proc = _cli("--json")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    payload = json.loads(proc.stdout)
    assert payload["findings"] == [] and payload["stale_baseline"] == []
    assert payload["baselined"] == len(load_baseline())


def test_cli_no_baseline_lists_only_the_baselined_entries():
    proc = _cli("--json", "--no-baseline")
    assert proc.returncode == 1
    got = {f["fingerprint"] for f in json.loads(proc.stdout)["findings"]}
    assert got == set(load_baseline())


def test_cli_check_selectors(tmp_path):
    (tmp_path / "fixture.py").write_text('''
def bad(payload):  # dfcheck: payload payload=generate_request
    return payload["bogus_knob"]


class Pool:
    # dfcheck: pairs acquire=alloc release=free
    def alloc(self, n):
        return list(range(n))

    def free(self, pages):
        pass


def leak(pool):
    pool.alloc(2)
''')
    for family, want in (("wire", ["wire-unknown-key"]),
                         ("resource", ["resource-leak"]),
                         ("lock", []), ("obs", [])):
        proc = _cli("--json", "--no-baseline", "--check", family, str(tmp_path))
        assert proc.returncode == (1 if want else 0), proc.stdout + proc.stderr
        assert [f["check"] for f in json.loads(proc.stdout)["findings"]] == want
    proc = _cli("--json", "--no-baseline", "--check", "wire", "--check", "resource",
                str(tmp_path))
    assert sorted(f["check"] for f in json.loads(proc.stdout)["findings"]) == \
        ["resource-leak", "wire-unknown-key"]


def test_cli_refuses_tracing():
    proc = _cli("--check", "tracing")
    assert proc.returncode == 2
    assert "invalid choice: 'tracing'" in proc.stderr
    assert set(ALL_FAMILIES) == {"lock", "obs", "wire", "resource"}
    with pytest.raises(ValueError, match="tracing"):
        run_checks([PACKAGE_ROOT / "analysis"], checks=["tracing"])
