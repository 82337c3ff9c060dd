"""Orchestration: enumerate cases, run every rule, render the report (the
JAX package's ``repro.analysis.report``).

``run_analysis`` is the one entry point the CLI (``__main__.py``), the
dryrun wiring, the card's smoke run and the tests share.  Budgets live in
``budgets.json`` beside this module, keyed ``case:kind:backend``;
``--write-budgets`` rewrites the keys of the backend it ran and keeps the
other backend's.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core.combine import resolve_backend
from .cases import (SHARDED_PROBE_CELLS, case_op_counts, case_records,
                    engine_advance_probe, enumerate_cases,
                    sharded_solve_probe)
from .memory import (MemoryRow, memory_findings, memory_rows,
                     memory_table_markdown)
from .rules import (Finding, budget_findings, collective_findings,
                    constant_findings, donation_findings, dtype_findings,
                    flatness_findings)
from .traversal import count_ops

__all__ = ["AnalysisReport", "run_analysis", "load_budgets", "write_budgets",
           "render_report", "BUDGET_PATH", "DOCS_PATH", "write_docs_table",
           "docs_table_block", "N_OBS"]

REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
BUDGET_PATH = pathlib.Path(__file__).resolve().parent / "budgets.json"
DOCS_PATH = REPO_ROOT / "docs" / "analysis_torch.md"

N_OBS = (4, 8, 16)                 # SaveAt flatness probe sizes

DOCS_BEGIN = ("<!-- memory-table:begin -- GENERATED by "
              "`PYTHONPATH=src python -m repro_torch.analysis --device cpu "
              "--write-docs-table`; bytes are the recorder's live bytes on "
              "the CPU -->")
DOCS_END = "<!-- memory-table:end -->"


@dataclasses.dataclass
class AnalysisReport:
    findings: List[Finding]
    rows: List[MemoryRow]
    counts: Dict[str, int]           # "case-key:kind:backend" -> op count
    failed_probes: List[str] = dataclasses.field(default_factory=list)

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def ok(self) -> bool:
        return not self.errors


def load_budgets(path: pathlib.Path = BUDGET_PATH) -> Optional[Dict[str,
                                                                    int]]:
    if not path.exists():
        return None
    return json.loads(path.read_text())


def write_budgets(counts: Dict[str, int],
                  path: pathlib.Path = BUDGET_PATH) -> None:
    """Write ``counts`` in place of the keys of their backends; keys of a
    backend ``counts`` does not hold stay as they were."""
    backends = {k.rsplit(":", 1)[1] for k in counts}
    kept = {k: v for k, v in (load_budgets(path) or {}).items()
            if k.rsplit(":", 1)[1] not in backends}
    path.write_text(json.dumps(dict(sorted({**kept, **counts}.items())),
                               indent=2) + "\n")


def run_analysis(budgets: Optional[Dict[str, int]] = None, *,
                 methods: Tuple[str, ...] = ("dopri5",),
                 run_memory: bool = True, run_flatness: bool = True,
                 device="cuda") -> AnalysisReport:
    """Run every enumerated case once on ``device`` and every rule over it.

    ``budgets=None`` skips the ratchet comparison (used by
    ``--write-budgets``, which only needs the counts)."""
    backend = resolve_backend("auto", torch.device(device))  # follows it
    findings: List[Finding] = []
    counts: Dict[str, int] = {}
    failed: List[str] = []

    def per_call(rec, key, kind):
        counts[f"{key}:{kind}:{backend}"] = count_ops(rec)
        out = dtype_findings(rec, key) + constant_findings(rec, key)
        if budgets is not None:
            out += budget_findings(rec, key, budgets, kind, backend)
        return out

    for case in enumerate_cases(methods):
        recs = case_records(case, n_obs=N_OBS[0], device=device)
        if not recs["succeeded"]:
            failed.append(case.key)
        for kind in ("value", "grad"):
            rec = recs[kind]
            if rec is None:
                continue
            findings += per_call(rec, case.key, kind)
            findings += donation_findings(rec, case.key)
        if run_flatness and case.saveat in ("ts", "dense"):
            series = {n: case_op_counts(case, n_obs=n, device=device)
                      for n in N_OBS}
            for kind in ("value", "grad"):
                if recs[kind] is not None:
                    findings += flatness_findings(
                        case.key, kind, {n: c[kind]
                                         for n, c in series.items()})
    # sharded solve cells: the shard-local-replay communication contract
    # (forward collective-free, backward one all_reduce per theta leaf),
    # audited on a world of 1
    for method in methods:
        for strategy, stepping_kind in SHARDED_PROBE_CELLS:
            key = f"parallel/{strategy}/{method}/{stepping_kind}/t1/sharded"
            probe = sharded_solve_probe(strategy, stepping_kind, method,
                                        device=device)
            for kind in ("value", "grad"):
                rec, comm_counts = probe[kind]
                findings += per_call(rec, key, kind)
                findings += collective_findings(
                    comm_counts, rec.collectives, key, kind=kind,
                    param_shapes=probe["param_shapes"])
    # the serve engine's attempt: its slot tensors must keep their storage
    # (the counterpart of the JAX engine's donated executable), so the
    # in-place rule runs at ERROR severity
    for method in methods:
        key = f"serve/engine/{method}/advance"
        probe = engine_advance_probe(method, device=device)
        findings += per_call(probe["rec"], key, "value")
        findings += donation_findings(probe["rec"], key,
                                      before=probe["before"],
                                      after=probe["after"],
                                      severity="error")
    rows = memory_rows(device=device) if run_memory else []
    findings += memory_findings(rows)
    return AnalysisReport(findings=findings, rows=rows, counts=counts,
                          failed_probes=failed)


def render_report(report: AnalysisReport) -> str:
    lines = []
    if report.rows:
        lines.append("## Peak live bytes per gradient strategy (recorded "
                     "runs)")
        lines.append("")
        lines.append(memory_table_markdown(report.rows))
        lines.append("")
    n_cases = len({k.split(":", 1)[0] for k in report.counts})
    lines.append(f"analyzed {n_cases} solve cases "
                 f"({len(report.counts)} recorded calls)")
    if report.failed_probes:
        lines.append(f"probes whose solve did not succeed: "
                     f"{report.failed_probes}")
    by_sev = {"error": 0, "warning": 0, "info": 0}
    for f in report.findings:
        by_sev[f.severity] = by_sev.get(f.severity, 0) + 1
    for f in sorted(report.findings,
                    key=lambda f: ("error", "warning",
                                   "info").index(f.severity)):
        lines.append(str(f))
    lines.append(f"{by_sev['error']} error(s), {by_sev['warning']} "
                 f"warning(s), {by_sev['info']} info")
    return "\n".join(lines)


def docs_table_block(rows: List[MemoryRow]) -> str:
    return "\n".join([DOCS_BEGIN, "", memory_table_markdown(rows), "",
                      DOCS_END])


def write_docs_table(rows: List[MemoryRow],
                     path: pathlib.Path = DOCS_PATH) -> None:
    """Replace the generated block between the markers in
    docs/analysis_torch.md."""
    text = path.read_text()
    try:
        start = text.index(DOCS_BEGIN)
        end = text.index(DOCS_END) + len(DOCS_END)
    except ValueError:
        raise SystemExit(
            f"{path}: memory-table markers not found; re-add the marker "
            "pair (see docs/analysis_torch.md)")
    path.write_text(text[:start] + docs_table_block(rows) + text[end:])
