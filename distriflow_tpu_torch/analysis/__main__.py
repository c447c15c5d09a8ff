"""Port of ``distriflow_tpu/analysis/__main__.py`` (copied with its imports rewritten).

dfcheck CLI: ``python -m distriflow_tpu_torch.analysis [--json] [--no-baseline]
[--check lock|obs|wire|resource ...] [--write-baseline] [paths]``.

Exit status 0 when every finding is baselined, 1 otherwise.  Stale baseline
entries (fingerprints nothing matched anymore) are reported on stderr so a
fix that removes a violation also prompts shrinking the baseline — but they
do not fail the run.

``--write-baseline`` regenerates ``analysis/baseline.json`` from the
current findings with a placeholder reason; the committed file must then be
hand-edited so every entry carries a real triage reason (the tier-1 gate
rejects empty reasons).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from distriflow_tpu_torch.analysis import ALL_FAMILIES, run_checks
from distriflow_tpu_torch.analysis.core import (
    BASELINE_PATH,
    PACKAGE_ROOT,
    load_baseline,
    match_baseline,
    write_baseline,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m distriflow_tpu_torch.analysis",
        description="dfcheck: lock-discipline, observability-contract, "
        "wire-schema, and resource-lifecycle static analysis",
    )
    ap.add_argument(
        "paths", nargs="*", default=None,
        help="files/directories to analyze (default: the distriflow_tpu_torch package)",
    )
    ap.add_argument("--json", action="store_true", help="machine-readable output")
    ap.add_argument(
        "--no-baseline", action="store_true",
        help="report every finding, ignoring analysis/baseline.json",
    )
    ap.add_argument(
        "--baseline", type=Path, default=BASELINE_PATH,
        help="alternate baseline file",
    )
    ap.add_argument(
        "--check", action="append",
        choices=list(ALL_FAMILIES),
        help="restrict to one or more check families (default: all)",
    )
    ap.add_argument(
        "--write-baseline", action="store_true",
        help="rewrite the baseline from current findings (placeholder reasons)",
    )
    args = ap.parse_args(argv)

    paths = [Path(p) for p in args.paths] if args.paths else [PACKAGE_ROOT]
    findings = run_checks(paths, checks=args.check)

    if args.write_baseline:
        write_baseline(findings, args.baseline, reason="TODO: triage")
        print(f"wrote {len(findings)} entr{'y' if len(findings) == 1 else 'ies'} "
              f"to {args.baseline}", file=sys.stderr)
        return 0

    baseline = {} if args.no_baseline else load_baseline(args.baseline)
    fresh, stale = match_baseline(findings, baseline)

    if args.json:
        print(json.dumps(
            {
                "findings": [f.to_json() for f in fresh],
                "baselined": len(findings) - len(fresh),
                "stale_baseline": stale,
            },
            indent=2,
        ))
    else:
        for f in fresh:
            print(f.render())
        print(
            f"dfcheck: {len(fresh)} finding(s), "
            f"{len(findings) - len(fresh)} baselined, "
            f"{len(stale)} stale baseline entr"
            f"{'y' if len(stale) == 1 else 'ies'}",
            file=sys.stderr,
        )
        for fp in stale:
            print(f"  stale baseline (violation fixed? remove it): {fp}",
                  file=sys.stderr)
    return 1 if fresh else 0


if __name__ == "__main__":
    sys.exit(main())
