"""Contract checks over traced runs of the entry points (the port's
counterpart of ``repro.analysis.jaxpr_check``).

The reference checks abstract jaxprs; PyTorch has no abstract trace of
these entry points, so the port runs each one for real at a small size,
under a ``TorchDispatchMode`` (:class:`OpTrace`) that records every aten
op's outputs, with a ``CountingOperator`` metering the operator.  One run
yields three verdicts, with the reference's finding IDs:

RPRJ01 *densify detector* — no intermediate holds ≥ n²/2 elements for the
    operator's n.  The streaming claim of arXiv:1503.08395 holds iff no run
    ever materializes the kernel matrix.  A pairwise kernel launch counts as
    ONE op whose outputs are recorded, as a ``pallas_call`` is one primitive
    of the reference's trace: on the card the kernel builds its tiles on
    chip and PyTorch sees only its outputs; on CPU tensors the launch's
    plain version stands in for those tiles.  View outputs allocate nothing
    and are not recorded.
RPRJ02 *sweep-budget verifier* — the meters equal each
    ``SelectionPolicy.sweep_budget()`` declaration and the pipeline
    contracts (``fast_model`` = 1 + budget, ``fast_cur`` = 1 + 2·budget,
    ``serve_kernel_model`` = one cross launch per bucket, an append = one
    ``append_sweeps`` tick of exactly b·c entries).  Policies are read from
    the port's registry, so a new policy is checked once it registers.  An
    entry point that raises is an RPRJ02 finding too.
RPRJ03 *accumulation-precision scan* — under ``bf16_f32acc`` no contraction
    op (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``dot``, ``matmul`` and the
    matrix-vector forms) sees a bf16 or f16 operand: the port rounds the
    operands to the tile dtype and contracts them in f32, which is f32
    accumulation.  Scanned for every registered kernel spec, inside the
    launches' plain versions too.  A CUDA launch is opaque to the recorder:
    on the card the scan sees only the torch-level ops around the kernel,
    so there it does not check the kernel's own accumulation (each entry's
    report says how many contractions the scan saw).

Entry points: ``fast_model`` (every registered policy),
``fast_model_with_error``, ``fast_cur`` (every registered policy), each
policy's ``select`` (plus a growing-operator variant for every policy with
a nonzero sweep budget), ``serve_kernel_model`` over a small artifact, and
``append_rows``.  The reference's smoke sizes are the default
(:class:`TraceSize`); any size and device can be passed, so the same checks
run on the card at the main path's n.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.analysis.findings import Finding
from repro_torch.core import cur as cur_lib
from repro_torch.core import selection as selection_lib
from repro_torch.core import spsd
from repro_torch.core import sweep as sweep_lib
from repro_torch.core.instrument import CountingOperator
from repro_torch.core.kernelop import PairwiseKernel
from repro_torch.kernels.pairwise import kernel as pw_kernel
from repro_torch.kernels.pairwise import specs as pw_specs

# the reference's smoke shape: n²/2 = 131,072 elements separates Θ(n²)
# from Θ(n·c), the row panels (64 × n) and a right-hand side padded to 128
# columns (65,536), yet every check runs in well under a second
SMOKE_N = 512
SMOKE_D = 4
SMOKE_C = 12
SMOKE_S = 24
SMOKE_BLOCK = 64          # keeps legitimate row panels (64 × n) thin
DENSIFY_FRACTION = 0.5    # an output ≥ n²/2 elements counts as densified
SMOKE_PROBES = 8          # Hutchinson probes of fast_model_with_error
APPEND_ROWS = 16          # rows of the appended batch

_LOW_PRECISION = (torch.bfloat16, torch.float16)
CONTRACTIONS = frozenset(("mm", "bmm", "addmm", "baddbmm", "dot", "matmul",
                          "mv", "addmv", "vdot"))
# the pairwise launches, recorded as one op each (see RPRJ01)
_KERNELS = ("pairwise_block", "pairwise_matmat_multi",
            "pairwise_matmat_multi_slab")


@dataclasses.dataclass(frozen=True)
class TraceSize:
    """The problem every check runs: n points in d features, c columns, a
    sketch of s, panels of ``block`` rows (None: the engine's default), on
    ``device``.  The defaults are the reference's smoke sizes."""

    n: int = SMOKE_N
    d: int = SMOKE_D
    c: int = SMOKE_C
    s: int = SMOKE_S
    block: Optional[int] = SMOKE_BLOCK
    device: str = "cpu"


SMOKE = TraceSize()


# ---------------------------------------------------------------------------
# the op recorder
# ---------------------------------------------------------------------------

class OpTrace(TorchDispatchMode):
    """Records each aten op's non-view output shapes (``outputs``: the set
    of (op, shape)), the dtypes of every contraction's operands and result
    (``contractions``), and the ops that produced a bf16/f16 tensor
    (``low_precision_ops``).  Inside a pairwise launch (:meth:`launches`) only
    the contraction scan runs; the launch's outputs are recorded as one op
    named ``kernel:<wrapper>``."""

    def __init__(self):
        super().__init__()
        self.outputs = set()
        self.contractions = set()
        self.low_precision_ops = set()
        self._launch_depth = 0

    def _record(self, name: str, tensors, views: bool = False) -> None:
        for t in tensors:
            if isinstance(t, torch.Tensor) and (views or not t._is_view()):
                self.outputs.add((name, tuple(int(s) for s in t.shape)))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if name in CONTRACTIONS:
            ins = [t for t in tree_flatten((args, kwargs or {}))[0]
                   if isinstance(t, torch.Tensor)]
            self.contractions.add((name, tuple(str(t.dtype) for t in ins),
                                   tuple(str(t.dtype) for t in outs)))
        if any(t.dtype in _LOW_PRECISION for t in outs):
            self.low_precision_ops.add(name)
        if self._launch_depth == 0:
            self._record(name, outs)
        return out

    @contextlib.contextmanager
    def launches(self):
        """Route the pairwise dispatchers through :meth:`_launch` while the
        block runs (module attributes, restored on exit)."""
        saved = {k: getattr(pw_kernel, k) for k in _KERNELS}

        def wrap(name, fn):
            def launch(*args, **kwargs):
                return self._launch(name, fn, *args, **kwargs)
            return launch

        try:
            for k, fn in saved.items():
                setattr(pw_kernel, k, wrap(k, fn))
            yield self
        finally:
            for k, fn in saved.items():
                setattr(pw_kernel, k, fn)

    def _launch(self, name: str, fn: Callable, *args, **kwargs):
        self._launch_depth += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self._launch_depth -= 1
        if self._launch_depth == 0:
            # a launch's outputs may be views of its one result buffer
            self._record(f"kernel:{name}", tree_flatten(out)[0], views=True)
        return out


def record(fn: Callable) -> Tuple[OpTrace, object]:
    """Run ``fn()`` under a fresh :class:`OpTrace`; (trace, result)."""
    trace = OpTrace()
    with trace, trace.launches():
        out = fn()
    return trace, out


# ---------------------------------------------------------------------------
# the three scans
# ---------------------------------------------------------------------------

def scan_densify(trace: OpTrace, n: int, entry: str) -> List[Finding]:
    """RPRJ01: any recorded output with ≥ DENSIFY_FRACTION·n² elements."""
    threshold = max(1, int(n * n * DENSIFY_FRACTION))
    findings: List[Finding] = []
    for name, shape in sorted(trace.outputs):
        size = int(np.prod(shape, dtype=np.int64)) if shape else 1
        if size < threshold:
            continue
        findings.append(Finding(
            path=f"trace:{entry}", line=0, rule="RPRJ01",
            message=(f"Θ(n²) intermediate {shape} ({size} elems ≥ "
                     f"{threshold}) at op '{name}' — a streaming entry "
                     f"point materialized the operator (n={n})"),
            snippet=f"{name}{shape}"))
    return findings


def scan_contractions(trace: OpTrace, entry: str) -> List[Finding]:
    """RPRJ03: a contraction with a bf16/f16 operand."""
    low = tuple(str(dt) for dt in _LOW_PRECISION)
    findings: List[Finding] = []
    for name, in_dts, out_dts in sorted(trace.contractions):
        if not any(dt in low for dt in in_dts):
            continue
        findings.append(Finding(
            path=f"trace:{entry}", line=0, rule="RPRJ03",
            message=(f"{name} contracts {list(in_dts)} -> {list(out_dts)} "
                     "under a low-precision tile policy — round the "
                     "operands to the tile dtype and contract them in f32 "
                     "(specs.dot_f32acc)"),
            snippet=f"{name}{in_dts}"))
    return findings


def _check_counts(entry: str, counts: Dict[str, int],
                  expected: Dict[str, int]) -> List[Finding]:
    """RPRJ02: the meters vs the declared budgets."""
    findings = []
    for key, want in expected.items():
        got = counts.get(key, 0)
        if got != want:
            findings.append(Finding(
                path=f"trace:{entry}", line=0, rule="RPRJ02",
                message=(f"declared budget says {key}={want} but the run "
                         f"metered {key}={got} — the declaration and the "
                         "implementation disagree"),
                snippet=f"{entry}:{key}={got}!={want}"))
    return findings


def _run(entry: str, fn: Callable) -> Tuple[Optional[OpTrace],
                                            List[Finding]]:
    """``record(fn)``; a raised exception is itself a finding."""
    try:
        trace, _ = record(fn)
        return trace, []
    except Exception as exc:  # noqa: BLE001 — any failure fails the gate
        return None, [Finding(
            path=f"trace:{entry}", line=0, rule="RPRJ02",
            message=f"entry point failed to run: {exc!r}",
            snippet=f"{entry}:run-error")]


def _entry_report(entry: str, counts: Dict[str, int],
                  expected: Dict[str, int], findings: Sequence[Finding],
                  trace: Optional[OpTrace]) -> dict:
    """The entry's meters and verdict, with what RPRJ03 could see: the
    distinct contraction signatures scanned and the ops that made a
    bf16/f16 tensor (none of either inside a CUDA launch)."""
    return {"entry": entry, "counts": dict(counts),
            "expected": dict(expected), "ok": not findings,
            "contractions_scanned": len(trace.contractions) if trace else 0,
            "low_precision_ops": sorted(trace.low_precision_ops)
            if trace else []}


def _verdict(entry: str, trace: Optional[OpTrace], opc: CountingOperator,
             expected: Dict[str, int], findings: List[Finding],
             n: Optional[int] = None) -> Tuple[List[Finding], dict]:
    if trace is not None:
        findings += _check_counts(entry, opc.counts, expected)
        findings += scan_densify(trace, opc.n if n is None else n, entry)
        findings += scan_contractions(trace, entry)
    return findings, _entry_report(entry, opc.counts, expected, findings,
                                   trace)


# ---------------------------------------------------------------------------
# smoke data and operators
# ---------------------------------------------------------------------------

def smoke_points(n: int = SMOKE_N, d: int = SMOKE_D, seed: int = 0,
                 lattice: bool = False, device="cpu") -> torch.Tensor:
    """Seeded points: standard normal, or integers in [0, 5) (inside a
    sign-split plan) with ``lattice``."""
    rng = np.random.default_rng(seed)
    if lattice:
        X = rng.integers(0, 5, size=(n, d)).astype(np.float32)
    else:
        X = rng.standard_normal((n, d)).astype(np.float32)
    return torch.as_tensor(X, device=device)


def smoke_operator(spec_name: str = "rbf", precision: str = "f32",
                   size: TraceSize = SMOKE,
                   use_kernel: bool = True) -> CountingOperator:
    """A counting-wrapped ``PairwiseKernel`` at ``size``."""
    X = smoke_points(size.n, size.d, lattice=spec_name == "laplacian",
                     device=size.device)
    spec = pw_specs.suggested_spec(spec_name, size.d).with_precision(
        precision)
    return CountingOperator(PairwiseKernel(X, spec, use_kernel,
                                           device=size.device))


def _gen(seed: int = 0) -> torch.Generator:
    return torch.Generator(device="cpu").manual_seed(seed)


# ---------------------------------------------------------------------------
# entry-point checks (each returns (findings, report))
# ---------------------------------------------------------------------------

def check_policy_select(policy_name: str,
                        op: Optional[CountingOperator] = None,
                        size: TraceSize = SMOKE
                        ) -> Tuple[List[Finding], dict]:
    """policy.select == sweep_budget() sweeps, gathers as declared, 0 fulls."""
    pol = selection_lib.get_policy(policy_name)
    opc = op if op is not None else smoke_operator(size=size)
    opc.reset()
    entry = f"select[{policy_name}]"
    trace, findings = _run(entry, lambda: pol.select(
        opc, size.c, generator=_gen(), block_size=size.block))
    expected = {"sweeps": pol.sweep_budget(), "columns": pol.gathers,
                "fulls": 0}
    return _verdict(entry, trace, opc, expected, findings)


class _GrowingOperator(CountingOperator):
    """A CountingOperator whose corpus grows after every panel sweep — the
    incremental maintainer rebinding the live operator between adaptive
    selection rounds.  The meters are cumulative across the growth
    (``rebind`` keeps them)."""

    def __init__(self, X_full: torch.Tensor, spec, n0: int, grow: int,
                 device, use_kernel: bool = True):
        self._X_full = X_full
        self._spec = spec
        self._grow = grow
        self._device = device
        self._use_kernel = use_kernel
        self.live_n = n0
        super().__init__(self._operator(n0))

    def _operator(self, n: int) -> PairwiseKernel:
        return PairwiseKernel(self._X_full[:n], self._spec, self._use_kernel,
                              device=self._device)

    def sweep(self, plans, block_size=None, mesh=None):
        out = super().sweep(plans, block_size=block_size, mesh=mesh)
        nxt = min(self.live_n + self._grow, int(self._X_full.shape[0]))
        if nxt != self.live_n:
            self.live_n = nxt
            self.rebind(self._operator(nxt))
        return out


def check_policy_select_grown(policy_name: str, grow: int = SMOKE_BLOCK,
                              size: TraceSize = SMOKE
                              ) -> Tuple[List[Finding], dict]:
    """Adaptive selection over a growing operator: budgets still exact.

    Growth adds rows between a policy's adaptive rounds, never kernel
    passes; a policy that sizes per-round masks from an n captured at entry
    fails to broadcast against the grown round's statistics (a run failure,
    RPRJ02).
    """
    pol = selection_lib.get_policy(policy_name)
    spec = pw_specs.suggested_spec("rbf", size.d)
    X_full = smoke_points(size.n + pol.sweep_budget() * grow, size.d,
                          device=size.device)
    opc = _GrowingOperator(X_full, spec, size.n, grow, size.device)
    entry = f"select_grown[{policy_name}]"
    trace, findings = _run(entry, lambda: pol.select(
        opc, size.c, generator=_gen(), block_size=size.block))
    expected = {"sweeps": pol.sweep_budget(), "columns": pol.gathers,
                "fulls": 0}
    if trace is not None and pol.sweep_budget() > 0 and \
            opc.live_n <= size.n:
        findings.append(Finding(
            path=f"trace:{entry}", line=0, rule="RPRJ02",
            message=("growth harness did not grow the operator — the "
                     "grown-selection invariant was checked vacuously"),
            snippet=f"{entry}:no-growth"))
    return _verdict(entry, trace, opc, expected, findings, n=opc.live_n)


def _artifact_problem(size: TraceSize):
    """The serve/append checks' small artifact: (artifact, y, spec)."""
    from repro_torch.serve.artifact import build_artifact

    X = smoke_points(size.n, size.d, seed=7, device=size.device)
    y = torch.as_tensor(np.random.default_rng(8).standard_normal(size.n),
                        dtype=torch.float32, device=size.device)
    spec = pw_specs.get_spec("rbf", sigma=1.5)
    artifact = build_artifact(X, y, spec, size.c, size.s,
                              generator=_gen(), use_kernel=False,
                              device=size.device)
    return artifact, y


def check_append(size: TraceSize = SMOKE) -> Tuple[List[Finding], dict]:
    """Incremental absorb: ONE thin metered launch of exactly b·c entries
    (zero panel sweeps, zero fulls, zero query crosses)."""
    from repro_torch.serve.incremental import append_rows, init_state

    b = APPEND_ROWS
    entry = "append_rows"
    expected = {"append_sweeps": 1, "sweeps": 0, "fulls": 0,
                "cross_sweeps": 0, "columns": 0, "entries": b * size.c}
    artifact, y = _artifact_problem(size)
    state = init_state(artifact, y)
    opc = CountingOperator(artifact.landmark_operator())
    rng = np.random.default_rng(9)
    X_new = torch.as_tensor(rng.standard_normal((b, size.d)),
                            dtype=torch.float32, device=size.device)
    y_new = torch.as_tensor(rng.standard_normal(b), dtype=torch.float32,
                            device=size.device)
    trace, findings = _run(entry, lambda: append_rows(
        artifact, state, X_new, y_new, op=opc))
    return _verdict(entry, trace, opc, expected, findings, n=size.n)


def check_fast_model(policy_name: str = "uniform", precision: str = "f32",
                     size: TraceSize = SMOKE) -> Tuple[List[Finding], dict]:
    """fast_model(gaussian, streaming) == 1 sweep + the policy's budget."""
    pol = selection_lib.get_policy(policy_name)
    opc = smoke_operator(precision=precision, size=size)
    entry = f"fast_model[{policy_name}"
    entry += f",{precision}]" if precision != "f32" else "]"
    trace, findings = _run(entry, lambda: spsd.fast_model(
        opc, size.c, size.s, s_sketch="gaussian", streaming=True,
        block_size=size.block, selection=policy_name, generator=_gen()))
    expected = {"sweeps": 1 + pol.sweep_budget(), "fulls": 0}
    return _verdict(entry, trace, opc, expected, findings)


def check_fast_model_with_error(policy_name: str = "uniform",
                                size: TraceSize = SMOKE
                                ) -> Tuple[List[Finding], dict]:
    """Model + Hutchinson error fused: still 1 sweep + the policy budget."""
    pol = selection_lib.get_policy(policy_name)
    opc = smoke_operator(size=size)
    entry = f"fast_model_with_error[{policy_name}]"
    trace, findings = _run(entry, lambda: spsd.fast_model_with_error(
        opc, size.c, size.s, s_sketch="gaussian", probes=SMOKE_PROBES,
        block_size=size.block, selection=policy_name, generator=_gen()))
    expected = {"sweeps": 1 + pol.sweep_budget(), "fulls": 0}
    return _verdict(entry, trace, opc, expected, findings)


def check_fast_cur(policy_name: str = "uniform",
                   size: TraceSize = SMOKE) -> Tuple[List[Finding], dict]:
    """Streaming kernel-CUR: 1 sweep + 2× the policy budget (C and R)."""
    pol = selection_lib.get_policy(policy_name)
    opc = smoke_operator(size=size)
    entry = f"fast_cur[{policy_name}]"
    trace, findings = _run(entry, lambda: cur_lib.fast_cur(
        opc, c=size.c, r=size.c, sc=size.s, sr=size.s,
        sketch_kind="gaussian", block_size=size.block,
        selection=policy_name, generator=_gen(3)))
    expected = {"sweeps": 1 + 2 * pol.sweep_budget(), "fulls": 0}
    return _verdict(entry, trace, opc, expected, findings)


def check_serve(precision: str = "f32",
                size: TraceSize = SMOKE) -> Tuple[List[Finding], dict]:
    """serve_kernel_model: one fused cross launch per query bucket, 0
    sweeps, over a small built artifact and query batches whose sizes
    force two buckets."""
    from repro_torch.serve.engine import QueryRequest, plan_buckets, \
        serve_kernel_model

    entry = "serve_kernel_model"
    entry += f"[{precision}]" if precision != "f32" else ""
    sizes = (40, 5, 4)   # bucket_by_size -> [[40], [5, 4]]: two launches
    reqs = [QueryRequest(X=torch.zeros((m, size.d))) for m in sizes]
    expected = {"cross_sweeps": len(plan_buckets(reqs)), "sweeps": 0,
                "fulls": 0}
    artifact, _ = _artifact_problem(size)
    opc = CountingOperator(artifact.landmark_operator(use_kernel=True,
                                                      precision=precision))
    queries = [QueryRequest(X=torch.zeros((m, size.d), device=size.device))
               for m in sizes]
    trace, findings = _run(entry, lambda: serve_kernel_model(
        artifact, queries, op=opc))
    return _verdict(entry, trace, opc, expected, findings, n=size.n)


def check_kernel_precision(spec_name: str, size: TraceSize = SMOKE
                           ) -> Tuple[List[Finding], dict]:
    """One bf16_f32acc sweep per registered kernel: every contraction sees
    f32 operands."""
    opc = smoke_operator(spec_name=spec_name, precision="bf16_f32acc",
                         size=size)
    entry = f"sweep[{spec_name},bf16_f32acc]"
    V = torch.zeros((opc.n, 8), device=size.device)
    trace, findings = _run(entry, lambda: opc.sweep(
        [sweep_lib.MatmulPlan(V)], block_size=size.block))
    expected = {"sweeps": 1, "fulls": 0}
    return _verdict(entry, trace, opc, expected, findings)


def run_trace_checks(log: Optional[Callable[[str], None]] = None,
                     size: TraceSize = SMOKE
                     ) -> Tuple[List[Finding], List[dict]]:
    """Every entry-point check over the port's live registries, in the
    reference's order and with its entry names."""
    def note(msg):
        if log:
            log(msg)

    findings: List[Finding] = []
    reports: List[dict] = []

    def add(label: str, result) -> None:
        note(f"run {label}")
        fs, rep = result()
        findings.extend(fs)
        reports.append(rep)

    policies = selection_lib.registered_policies()
    for name in policies:
        for check in (check_policy_select, check_fast_model, check_fast_cur):
            add(f"{check.__name__}[{name}]",
                lambda: check(name, size=size))
    for name in policies:
        if selection_lib.get_policy(name).sweep_budget() > 0:
            add(f"select_grown[{name}]", lambda: check_policy_select_grown(
                name, grow=size.block or SMOKE_BLOCK, size=size))
    add("append_rows", lambda: check_append(size=size))
    add("fast_model_with_error[uniform]",
        lambda: check_fast_model_with_error("uniform", size=size))
    add("fast_model[uniform,bf16_f32acc]",
        lambda: check_fast_model("uniform", precision="bf16_f32acc",
                                 size=size))
    for prec in ("f32", "bf16_f32acc"):
        add(f"serve_kernel_model[{prec}]",
            lambda: check_serve(precision=prec, size=size))
    for spec_name in pw_specs.registered_kernels():
        add(f"sweep[{spec_name},bf16_f32acc]",
            lambda: check_kernel_precision(spec_name, size=size))
    return findings, reports
