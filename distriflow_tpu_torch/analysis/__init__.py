"""Port of ``distriflow_tpu/analysis`` (copied with its imports rewritten).

dfcheck — the project-native static-analysis plane, pointed at the port.
Run ``python -m distriflow_tpu_torch.analysis [--json] [paths]`` to verify
the port's concurrency, observability, wire and resource invariants over
its source:

* **lock-discipline / lock-order** (:mod:`.lock_check`) — ``# guarded-by:``
  annotated fields are only touched under their lock; the static
  acquisition graph is acyclic.
* **metric/span/fleet contracts** (:mod:`.obs_check`) — metric idents
  parse and match docs/OBSERVABILITY.md; spans are balanced on all paths;
  ``fleet/`` idents never ship from outside the collector; every phase is
  documented in docs/OBSERVABILITY.md or the port's ``analysis/taxonomy.md``.
* **wire drift** (:mod:`.wire_check`) — message envelopes and
  ``# dfcheck: payload`` dicts agree with :mod:`..comm.schema`.
* **resource lifecycles** (:mod:`.resource_check`) — ``# dfcheck: pairs``
  acquire/release pairs are balanced and their counters paired.

The reference's tracing family (``tracing_check.py``: side effects and
concretization inside ``jax.jit`` bodies) is not ported: the port traces
nothing under ``jit``, so it has no such bodies to check.

Triaged suppressions live in ``analysis/baseline.json``; the port's gate
(``tests/test_torch_analysis.py``) asserts zero non-baselined findings.
:mod:`.witness` holds the runtime lock-order and page-pool witnesses. See
docs/ANALYSIS.md for the annotation grammar and baseline workflow.
"""

from distriflow_tpu_torch.analysis.core import (  # noqa: F401
    BASELINE_PATH,
    Finding,
    load_baseline,
    load_modules,
    match_baseline,
)
from distriflow_tpu_torch.analysis.witness import (  # noqa: F401
    LockOrderViolation,
    OrderedLock,
    PoolConservationViolation,
    PoolWitness,
    ordered_lock,
    pool_witness_enabled,
    reset_witness,
    witness_enabled,
)

#: every check family the runner knows; ``--check`` and the default set
ALL_FAMILIES = ("lock", "obs", "wire", "resource")


def run_checks(paths, checks=None):
    """Run the selected check families over ``paths``; returns findings
    sorted by (path, line).  ``checks`` is an iterable of family names
    (``lock``, ``obs``, ``wire``, ``resource``); None runs all of them."""
    from distriflow_tpu_torch.analysis.lock_check import check_locks
    from distriflow_tpu_torch.analysis.obs_check import check_obs
    from distriflow_tpu_torch.analysis.resource_check import check_resource
    from distriflow_tpu_torch.analysis.wire_check import check_wire

    fams = set(checks) if checks else set(ALL_FAMILIES)
    unknown = fams - set(ALL_FAMILIES)
    if unknown:
        raise ValueError(f"unknown check families {sorted(unknown)}; "
                         f"the port has {list(ALL_FAMILIES)}")
    modules = load_modules(paths)
    findings = []
    if "lock" in fams:
        findings.extend(check_locks(modules))
    if "obs" in fams:
        findings.extend(check_obs(modules))
    if "wire" in fams:
        findings.extend(check_wire(modules))
    if "resource" in fams:
        findings.extend(check_resource(modules))
    findings.sort(key=lambda f: (f.path, f.line, f.check, f.detail))
    return findings
