"""repro_torch.analysis — the recording auditor for the port's solver stack
(the JAX package's ``repro.analysis``).

JAX proves its properties on jaxprs before anything runs.  Eager PyTorch
has no trace, so the port runs each probe once, small, under a
``TorchDispatchMode`` that records every aten op, the bytes live at each
moment, the kernel launches and the collectives (``traversal``), and holds
those records to the same rules:

  * the Table-1 memory ordering (symplectic O(N + s + L) flat in N vs
    DirectBackprop O(N s L) linear) on the peak of live bytes of each
    strategy's loss+gradient                     (``memory``)
  * dtype discipline: no silent float demotions in steps or cotangent
    paths                                        (``rules.dtype_findings``)
  * op-count budgets: a committed ratchet per enumerated case and backend
                                                 (``rules.budget_findings``)
  * hazards: large captured tensors, a serve-engine attempt that does not
    write its state in place, a sharded backward that communicates more
    than one all_reduce per parameter leaf

Run it: ``PYTHONPATH=src python -m repro_torch.analysis --check --device
cpu`` (the card: ``--device cuda``, the default).
"""
from .cases import (Case, case_records, engine_advance_probe,
                    enumerate_cases, make_probe, mlp_field, mlp_params,
                    sharded_solve_probe)
from .memory import (MemoryRow, memory_findings, memory_rows,
                     memory_table_markdown)
from .report import (AnalysisReport, BUDGET_PATH, load_budgets,
                     render_report, run_analysis, write_budgets)
from .rules import (Finding, RULE_REGISTRY, budget_findings,
                    collective_findings, constant_findings,
                    donation_findings, dtype_findings, flatness_findings,
                    register_rule)
from .traversal import (OpContext, OpRecord, OpRecorder, count_ops,
                        kernel_launches, record, tensor_bytes)

__all__ = [
    "AnalysisReport", "BUDGET_PATH", "Case", "Finding", "MemoryRow",
    "OpContext", "OpRecord", "OpRecorder", "RULE_REGISTRY",
    "budget_findings", "case_records", "collective_findings",
    "constant_findings", "count_ops", "donation_findings", "dtype_findings",
    "engine_advance_probe", "enumerate_cases", "flatness_findings",
    "kernel_launches", "load_budgets", "make_probe", "memory_findings",
    "memory_rows", "memory_table_markdown", "mlp_field", "mlp_params",
    "record", "register_rule", "render_report", "run_analysis",
    "sharded_solve_probe", "tensor_bytes", "write_budgets",
]
