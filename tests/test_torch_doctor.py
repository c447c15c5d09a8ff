"""The port's doctor CLI (``python -m distriflow_tpu_torch.doctor``).

- ``--device cpu`` runs every check and exits 0 with "all checks passed";
  its check names, in order, are the JAX doctor's ``_check(...)`` names,
  read from ``distriflow_tpu/doctor.py`` with ``ast`` (the JAX doctor's
  own test runs it), and every check prints ``ok``.
- Without ``--device cpu`` on a machine without a GPU, ``backend/devices``
  fails and the doctor stops there with exit code 1: it never carries on
  on the CPU.
- :class:`_Solo`'s rule on the CPU is exact equality.
"""

import ast
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.port
torch.set_num_threads(2)


def _jax_check_names():
    tree = ast.parse(open(os.path.join(REPO, "distriflow_tpu", "doctor.py")).read())
    names = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "_check"):
            names.append((node.lineno, node.args[0].value))
    return [n for _, n in sorted(names)]


def _doctor(*args, timeout=600):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"  # as the in-process port tests: share the host's cores
    return subprocess.run([sys.executable, "-m", "distriflow_tpu_torch.doctor", *args],
                          capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO)


_LINE = re.compile(r"^  (ok  |FAIL|warn) (.+?)(?: — .*)?$")


def test_doctor_passes_on_cpu_with_jax_names():
    out = _doctor("--device", "cpu")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "all checks passed" in out.stdout
    rows = [m.groups() for m in map(_LINE.match, out.stdout.splitlines()) if m]
    names = _jax_check_names()
    assert len(names) == 22
    assert [n for _, n in rows] == names, out.stdout
    assert all(tag == "ok  " for tag, _ in rows), out.stdout
    # the five-axis mesh, as JAX's doctor prints dict(mesh.shape)
    assert "process 0/1" in out.stdout and \
        "mesh {'data': 1, 'model': 1, 'seq': 1, 'pipe': 1, 'expert': 1}" in out.stdout
    assert "routed outputs bit-identical to solo" in out.stdout


def test_doctor_without_gpu_stops_at_backend():
    out = _doctor()
    assert out.returncode == 1, out.stdout + out.stderr
    lines = [ln for ln in out.stdout.splitlines() if _LINE.match(ln)]
    assert len(lines) == 1 and lines[0].startswith("  FAIL backend/devices"), out.stdout
    assert "no CUDA device" in lines[0]
    assert "SOME CHECKS FAILED" in out.stdout


def test_solo_rule_is_exact_on_cpu():
    from distriflow_tpu_torch.doctor import _drill_model, _Solo

    model = _drill_model("cpu")
    assert model.config.head_dim == 64 and model.config.dtype == torch.bfloat16
    solo = _Solo(model)
    prompt = np.random.default_rng(3).integers(1, 64, size=(1, 9)).astype(np.int32)
    want = solo(prompt, 4)
    assert want.shape == (1, 13)
    solo.check(want.copy(), prompt, 4)
    bad = want.copy()
    bad[0, -1] = (bad[0, -1] + 1) % 64
    with pytest.raises(AssertionError, match="differs from solo"):
        solo.check(bad, prompt, 4)
    assert solo.agreement == "bit-identical to solo"


def test_solo_near_tie_rule(monkeypatch):
    """The CUDA rule, driven on the CPU: a routed output may part from
    solo only at a top-2 margin below ``NEAR_TIE``, and each such parting
    is counted."""
    from distriflow_tpu_torch import doctor

    solo = doctor._Solo(doctor._drill_model("cpu"))
    solo.exact = False
    prompt = np.random.default_rng(3).integers(1, 64, size=(1, 9)).astype(np.int32)
    want = solo(prompt, 4)
    solo.check(want.copy(), prompt, 4)
    assert solo.near_ties == 0
    bad = want.copy()
    bad[0, 10:] = (bad[0, 10:] + 1) % 64
    with pytest.raises(AssertionError, match="top-2 margin"):
        solo.check(bad, prompt, 4)
    monkeypatch.setattr(doctor, "NEAR_TIE", float("inf"))
    solo.check(bad, prompt, 4)
    assert solo.near_ties == 1
    assert solo.agreement == "equal to solo up to 1 bf16 near-tie(s)"
    with pytest.raises(AssertionError, match="prompt changed"):
        changed = want.copy()
        changed[0, 0] = (changed[0, 0] + 1) % 64
        solo.check(changed, prompt, 4)


def _one_drill(monkeypatch, capsys, name):
    """Run the drill whose name contains ``name`` alone, in this process,
    on the CPU; returns its ``ok``/``FAIL`` line."""
    from distriflow_tpu_torch import doctor

    run = doctor._run_check
    monkeypatch.setattr(doctor, "_run_check", lambda check, fn, mandatory=True, report=None: (
        run(check, fn, mandatory, report) if name in check else True))
    doctor._run_checks("cpu", None)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if name in ln]
    assert len(lines) == 1, lines
    return lines[0]


def test_kill_and_resume_kills_at_the_kill_point(monkeypatch, capsys):
    """The kill is an event: the apply that reaches the seeded kill point
    holds server1's apply thread until stop() begins, so server1 cannot
    run on to the end of the dataset (and broadcast its completion) before
    the kill; the drill reports exactly that many applies."""
    line = _one_drill(monkeypatch, capsys, "kill-and-resume")
    assert line.startswith("  ok   ") and "killed after 5 applies" in line, line


def test_elastic_drill_verdict_survives_a_stalled_winner(monkeypatch, capsys):
    """The hedged winner's prefill stalls well past the clean ceiling
    (clean p99 + 200 ms): the straggler verdict, which counts events (A
    admitted nothing, the tier-0 band gained exactly the winner's TTFT),
    still holds."""
    from distriflow_tpu_torch.server.inference_server import InferenceServer

    admit = InferenceServer._admit_group

    def stalled(self, plen, shared_len, members):
        if any(getattr(req, "request_id", None) == "hedge-1" for req, _ in members):
            time.sleep(0.6)
        return admit(self, plen, shared_len, members)

    monkeypatch.setattr(InferenceServer, "_admit_group", stalled)
    line = _one_drill(monkeypatch, capsys, "elastic fleet")
    assert line.startswith("  ok   "), line
