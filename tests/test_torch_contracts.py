"""The port's contract checks (``repro_torch.analysis``) on the CPU.

Every check passes on the port at the reference's smoke sizes, and each
entry's meters equal the reference's ``run_jaxpr_checks`` report entry for
entry (its abstract traces bump the same ``CountingOperator`` count model).
Deliberately broken fixtures are caught, as ``tests/test_analysis.py``
catches them for the reference: an operator that densifies (its sweeps
call ``full()``, RPRJ01 and RPRJ02), a policy that spends a sweep it does
not declare (RPRJ02), and an unaccumulated bf16 contraction (RPRJ03).
"""
from __future__ import annotations

import json

import pytest
import torch

from repro.analysis import jaxpr_check
from repro_torch.analysis import __main__ as analysis_main
from repro_torch.analysis import trace_check as tc
from repro_torch.core import selection as tsel
from repro_torch.core import sweep as tsweep
from repro_torch.core.instrument import CountingOperator
from repro_torch.kernels.pairwise import specs as tspecs


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Keep torch's intra-op pool small; one small ``torch.exp`` first (see
    ROADMAP C, torch 2.13 CPU builds)."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    torch.exp(torch.zeros(64))
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def port_run():
    return tc.run_trace_checks()


@pytest.fixture(scope="module")
def reference_run():
    return jaxpr_check.run_jaxpr_checks()


def test_every_check_passes_on_the_port(port_run):
    findings, reports = port_run
    assert findings == [], [f.format() for f in findings]
    assert reports and all(r["ok"] for r in reports)


def _subject(entry: str) -> str:
    """The policy or spec an entry is about: ``sweep[rbf,bf16_f32acc]`` ->
    ``rbf``; entries without one -> ''."""
    inside = entry.partition("[")[2].rstrip("]")
    return inside.split(",")[0]


def test_counts_equal_the_reference_report(port_run, reference_run):
    """Entry for entry, in order, the same meters.  The reference's run
    iterates over its live registries, where another test of the process
    may have left a fixture (``tests/test_pairwise_kernels.py`` registers
    a spec); entries about names the port does not register are left
    out of the comparison, and only those."""
    ref_findings, ref_reports = reference_run
    _, reports = port_run
    ported = set(tsel.registered_policies()) | set(
        tspecs.registered_kernels())
    shared = [r for r in ref_reports
              if _subject(r["entry"]) in ported | {"", "f32", "bf16_f32acc"}]
    assert [r["entry"] for r in reports] == [r["entry"] for r in shared]
    names = {r["entry"] for r in shared}
    assert [f for f in ref_findings
            if f.path.partition(":")[2] in names] == []
    for got, want in zip(reports, shared):
        assert got["counts"] == want["counts"], got["entry"]
        assert got["expected"] == want["expected"], got["entry"]


def test_smoke_sizes_are_the_references():
    assert (tc.SMOKE_N, tc.SMOKE_D, tc.SMOKE_C, tc.SMOKE_S, tc.SMOKE_BLOCK,
            tc.DENSIFY_FRACTION) == (
        jaxpr_check.SMOKE_N, jaxpr_check.SMOKE_D, jaxpr_check.SMOKE_C,
        jaxpr_check.SMOKE_S, jaxpr_check.SMOKE_BLOCK,
        jaxpr_check.DENSIFY_FRACTION)


class _Densifying(CountingOperator):
    """Materializes the kernel (``full()``) before every sweep."""

    def sweep(self, plans, block_size=None, mesh=None):
        self.full()
        return super().sweep(plans, block_size=block_size, mesh=mesh)


def test_densifying_operator_is_caught():
    """full() inside a streaming entry trips RPRJ01 (the n×n launch
    output) and RPRJ02 (fulls = 1 per sweep, declared 0)."""
    inner = tc.smoke_operator().inner
    fs, rep = tc.check_policy_select("uniform_adaptive2",
                                     op=_Densifying(inner))
    rules = {f.rule for f in fs}
    assert rules == {"RPRJ01", "RPRJ02"}, [f.format() for f in fs]
    assert not rep["ok"] and rep["counts"]["fulls"] == 2
    assert any("kernel:pairwise_block" in f.message and
               f"({tc.SMOKE_N}, {tc.SMOKE_N})" in f.message
               for f in fs if f.rule == "RPRJ01")


def test_densify_detector_flags_a_dense_toy_entry():
    op = tc.smoke_operator(size=tc.TraceSize(n=256))
    trace, _ = tc.record(lambda: op.inner.full() @ torch.ones(op.n, 4))
    fs = tc.scan_densify(trace, op.n, "toy_dense")
    assert fs and all(f.rule == "RPRJ01" for f in fs)


def test_a_launch_is_one_op_and_panels_stay_thin():
    """A fused launch records only its outputs (n × M), a panel route its
    (b × n) blocks; neither reaches n²/2 at the smoke size."""
    op = tc.smoke_operator()
    V = torch.ones(op.n, 8)
    trace, _ = tc.record(lambda: op.sweep([tsweep.MatmulPlan(V)],
                                          block_size=tc.SMOKE_BLOCK))
    assert ("kernel:pairwise_matmat_multi", (tc.SMOKE_N, 8)) in trace.outputs
    assert tc.scan_densify(trace, op.n, "fused") == []
    op_panel = CountingOperator(type(op.inner)(
        op.inner.X, op.inner.spec, use_kernel=False, device="cpu"))
    trace, _ = tc.record(lambda: op_panel.sweep([tsweep.MatmulPlan(V)],
                                                block_size=tc.SMOKE_BLOCK))
    assert ("kernel:pairwise_block", (tc.SMOKE_BLOCK, tc.SMOKE_N)) in \
        trace.outputs
    assert tc.scan_densify(trace, op.n, "panel") == []


def test_off_budget_policy_is_caught():
    """A policy that declares 0 sweeps but spends 1 trips RPRJ02."""
    class LyingPolicy(tsel.SelectionPolicy):
        name = "lying_fixture"
        rounds = 0

        def select(self, K, c, *, generator=None, block_size=None,
                   mesh=None, mask=None):
            K.sweep([tsweep.MatmulPlan(torch.zeros(K.n, 4))],
                    block_size=block_size)
            return torch.randperm(K.n, generator=generator)[:c]

    tsel.register_policy("lying_fixture")(LyingPolicy)
    try:
        fs, rep = tc.check_policy_select("lying_fixture")
        assert any(f.rule == "RPRJ02" for f in fs), [f.format() for f in fs]
        assert not rep["ok"]
    finally:
        tsel._POLICIES.pop("lying_fixture")


def test_a_failing_entry_is_a_finding():
    """uniform_adaptive2 refuses c < 3 (it could not keep its budget)."""
    fs, rep = tc.check_policy_select("uniform_adaptive2",
                                     size=tc.TraceSize(c=2))
    assert [f.rule for f in fs] == ["RPRJ02"] and not rep["ok"]
    assert "failed to run" in fs[0].message


def test_unaccumulated_bf16_contraction_is_caught():
    a, b = torch.ones(8, 8), torch.ones(8, 8)
    trace, _ = tc.record(lambda: a.bfloat16() @ b.bfloat16())
    fs = tc.scan_contractions(trace, "toy_bf16")
    assert fs and fs[0].rule == "RPRJ03"


@pytest.mark.parametrize("name", ("laplacian", "linear", "rbf"))
def test_bf16_sweep_rounds_then_contracts_in_f32(name):
    """The bf16_f32acc sweep passes the scan, and its trace holds the bf16
    rounding the scan reads (so the pass is not vacuous)."""
    fs, rep = tc.check_kernel_precision(name)
    assert fs == [] and rep["counts"]["bf16_sweeps"] == 1
    opc = tc.smoke_operator(spec_name=name, precision="bf16_f32acc")
    trace, _ = tc.record(lambda: opc.sweep(
        [tsweep.MatmulPlan(torch.ones(opc.n, 8))], block_size=tc.SMOKE_BLOCK))
    assert trace.low_precision_ops
    assert trace.contractions and all(
        "torch.bfloat16" not in ins for _, ins, _ in trace.contractions)


def test_cli_runs_clean_and_writes_its_report(tmp_path):
    out = tmp_path / "report.json"
    rc = analysis_main.main(["--device", "cpu", "--quiet",
                             "--json", str(out)])
    assert rc == 0
    report = json.loads(out.read_text())
    assert report["total"] == 0
    assert len(report["trace_entries"]) == 20
