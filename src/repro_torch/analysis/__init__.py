"""Contract checks of the port (counterpart of ``repro.analysis``).

:mod:`repro_torch.analysis.trace_check` runs every public entry point under
an op recorder and a ``CountingOperator``: the Θ(n²) densify detector
(RPRJ01), sweep-budget verification against each registered
``SelectionPolicy`` (RPRJ02) and the bf16_f32acc accumulation scan
(RPRJ03).  Run them with ``python -m repro_torch.analysis``.  The
reference's AST lint rules (RPR001–RPR005) stay with the reference: they
check JAX idioms, and RPR005 already covers ``src/``.
"""
from repro_torch.analysis.findings import Finding, report_dict  # noqa: F401
from repro_torch.analysis.trace_check import (TraceSize,  # noqa: F401
                                              run_trace_checks)

__all__ = ["Finding", "report_dict", "TraceSize", "run_trace_checks"]
