"""CLI: ``PYTHONPATH=src python -m repro_torch.analysis [--check] ...``.

Modes
  (default)           run every case, run every rule, print the report
  --check             same, exit 1 on any ERROR finding
  --write-budgets     rewrite this backend's keys of the op-count ratchet
  --write-docs-table  refresh the generated memory table in
                      docs/analysis_torch.md

Knobs
  --budgets PATH      ratchet file (default: budgets.json beside this module)
  --methods a,b       tableaus for the per-case rules (default: dopri5;
                      the memory rule always runs dopri5 AND bosh3)
  --no-memory         skip the memory-bound rule (fast budget/dtype pass)
  --device D          cuda (default) or cpu; the combine backend follows it
                      (cuda on the card, torch on the CPU)
"""
from __future__ import annotations

import argparse
import pathlib
import sys

from .report import (BUDGET_PATH, load_budgets, render_report, run_analysis,
                     write_budgets, write_docs_table)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="recording auditor for the port's solver stack")
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero on any error-severity finding")
    ap.add_argument("--write-budgets", action="store_true",
                    help="rewrite this backend's op-count budgets")
    ap.add_argument("--write-docs-table", action="store_true",
                    help="refresh the table in docs/analysis_torch.md")
    ap.add_argument("--budgets", type=pathlib.Path, default=BUDGET_PATH)
    ap.add_argument("--methods", default="dopri5",
                    help="comma-separated tableau names for per-case rules")
    ap.add_argument("--no-memory", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    methods = tuple(m for m in args.methods.split(",") if m)
    budgets = None if args.write_budgets else load_budgets(args.budgets)
    if budgets is None and not args.write_budgets and args.check:
        print(f"{args.budgets}: no committed budget file; bootstrap with "
              "`python -m repro_torch.analysis --write-budgets`",
              file=sys.stderr)
        return 1

    run_memory = not args.no_memory or args.write_docs_table
    report = run_analysis(budgets, methods=methods, run_memory=run_memory,
                          device=args.device)

    if args.write_budgets:
        write_budgets(report.counts, args.budgets)
        print(f"wrote {len(report.counts)} budgets to {args.budgets}")
    if args.write_docs_table:
        write_docs_table(report.rows)
        print("wrote memory table into docs/analysis_torch.md")

    print(render_report(report))
    if args.check and not report.ok:
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
