"""CLI of the collective-schedule linter.

    python -m repro_torch.analysis.lint [--json REPORT.json] [--quick]
                                        [--no-budgets] [--expect-fixture]
                                        [--device cpu|cuda]

Runs every registered decomposition combo's pod-batched search under a
schedule recorder (rules R1-R3) and the budget enumeration (rule R4),
prints a summary, optionally writes the whole JSON report, and exits 1
on any finding.  ``--expect-fixture`` also lints the broken 2D entry
(``analysis/fixtures.py``) and fails unless R1 flags it: the linter
showing it catches the deadlock class it exists for.

The meshes are simulated on one device, so ``--device`` picks the
device they run on: the card by default (which raises without one),
``cpu`` for the plain versions.
"""
from __future__ import annotations

import argparse
import json
import sys


def _print_findings(findings) -> None:
    for f in findings:
        print(f"  [{f['rule']}] {f['combo']}: {f['message']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="collective-schedule lint of every registered "
                    "decomposition combo, over recorded searches")
    ap.add_argument("--json", metavar="PATH",
                    help="write the full JSON report here")
    ap.add_argument("--quick", action="store_true",
                    help="one representative combo per entry (fast)")
    ap.add_argument("--no-budgets", action="store_true",
                    help="skip the R4 budget sweep")
    ap.add_argument("--expect-fixture", action="store_true",
                    help="also lint the broken 2D fixture and fail unless "
                         "R1 flags it")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                    help="the device the simulated meshes run on "
                         "(default cuda)")
    args = ap.parse_args(argv)

    from repro_torch.analysis.fixtures import FIXTURE_NAME, lint_fixture
    from repro_torch.analysis.registry import lint_registry

    report = lint_registry(quick=args.quick,
                           with_budgets=not args.no_budgets,
                           device=args.device)
    rc = 0
    n_combos = len(report["combos"])
    if report["clean"]:
        print(f"lint: {n_combos} registry combos clean"
              + ("" if args.no_budgets else
                 f", {len(report.get('budget_cases', []))} budget cases "
                 f"within comm_model budgets"))
    else:
        print(f"lint: {report['n_findings']} finding(s) across "
              f"{n_combos} combos:")
        _print_findings(report["findings"])
        rc = 1

    if args.expect_fixture:
        fix = [f.to_json() for f in lint_fixture(False, args.device)]
        fix += [f.to_json() for f in lint_fixture(True, args.device)]
        report["fixture"] = {"name": FIXTURE_NAME, "findings": fix}
        r1 = [f for f in fix if f["rule"] == "R1"
              and f["detail"].get("collective") == "ppermute"]
        if r1:
            print(f"fixture: R1 correctly flags {FIXTURE_NAME} "
                  f"({len(r1)} divergent-ppermute finding(s)), e.g.:")
            _print_findings(r1[:1])
        else:
            print(f"fixture: FAILED — R1 did not flag {FIXTURE_NAME}; "
                  f"the linter cannot catch the deadlock class it "
                  f"exists for")
            _print_findings(fix)
            rc = 1

    if args.json:
        with open(args.json, "w") as fh:
            json.dump(report, fh, indent=2)
        print(f"report written to {args.json}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
