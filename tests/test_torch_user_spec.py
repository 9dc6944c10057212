"""User-registered kernels: a ``KernelSpec`` with only a Python ``entry_fn``
lowered to the pairwise kernels' CUDA epilogue (``repro_torch.kernels.
pairwise.lower``), held on the CPU.

- (a) ``lower_entry(f).evaluate(t)`` equals ``f(t)`` bit for bit for one
  entry per op family and statistic, on a grid with 0, subnormals, large
  values, inf / NaN and (for dot) negatives, and on each statistic's block;
- (b) ``source()`` of cauchy against a golden string; its key is the same
  in another process and for another object, and changes with gamma;
- (c) the refusals (a reduction, a branch on the data, an op off the list, a
  shape change, a numpy call) raise ``ValueError`` naming the op on the
  CUDA path, while the same spec's CPU path runs;
- (d) the reference's custom-kernel story against the port on the CPU: the
  same cauchy spec built on both sides (not registered: the reference's
  conformance suites iterate its registry), its ``PairwiseKernel`` with the
  Pallas sweep in interpret mode against the port's, the same ``idx`` and S:
  the sweep, ``fast_U``, ``fast_model_from_C`` and
  ``fast_model_with_error`` within f32 1e-5 scale-normalized, the meters
  equal and the route ``fused`` against ``pallas_fused``;
- (e) a user library's build command and hash: ``-include`` of the header
  and the statistic's define, a new path when the header changes, the
  built-in library's flags unchanged.
"""
from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sketch as jsk
from repro.core import spsd as jsp
from repro.core import sweep as jsweep
from repro.core.instrument import CountingOperator as JCounting
from repro.core.kernelop import PairwiseKernel as JPairwise
from repro.kernels.pairwise import specs as jspecs
from repro_torch.core import spsd as tsp
from repro_torch.core import sweep as tsweep
from repro_torch.core.instrument import CountingOperator as TCounting
from repro_torch.core.kernelop import PairwiseKernel as TPairwise
from repro_torch.kernels import build as kbuild
from repro_torch.kernels.pairwise import build as pw_build
from repro_torch.kernels.pairwise import kernel as tkernel
from repro_torch.kernels.pairwise import lower
from repro_torch.kernels.pairwise import specs as tspecs

from _torch_user_entries import ENTRIES, cauchy_entry

REPO = Path(__file__).resolve().parents[1]
N, D, C, S, PROBES = 160, 6, 12, 48, 16
KEY = jax.random.PRNGKey(3)
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Keep torch's intra-op pool small beside the other test workers; one
    small ``torch.exp`` first (the first multi-threaded one of a process
    can come out ~1e-4 off with torch 2.13 CPU builds)."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    torch.exp(torch.zeros(64))
    yield
    torch.set_num_threads(old)


def _grid(stat: str) -> torch.Tensor:
    rng = np.random.default_rng(0)
    tiny = np.finfo(np.float32).tiny
    vals = [0.0, -0.0, 1e-45, 1e-42, tiny / 2, tiny, 1e-30, 1.0, 2.0, 1e20,
            3e38, np.inf, np.nan, *rng.uniform(0, 60, 400)]
    if stat == "dot":
        vals += [-1e-42, -1.0, -1e20, -np.inf, *rng.normal(size=200) * 20]
    return torch.tensor(vals, dtype=torch.float32)


def _stat_values(stat: str) -> torch.Tensor:
    rng = np.random.default_rng(1)
    X = torch.as_tensor(rng.normal(size=(40, D)), dtype=torch.float32)
    return tspecs.stat_block(stat, X[:20], X[20:]).reshape(-1)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("name,stat,entry", ENTRIES,
                         ids=[e[0] for e in ENTRIES])
def test_evaluate_is_entry_fn_bit_for_bit(name, stat, entry):
    program = lower.lower_entry(entry, name)
    for t in (_grid(stat), _stat_values(stat),
              _stat_values(stat).reshape(20, 20)):
        with np.errstate(all="ignore"):
            want = entry(t)
        got = program.evaluate(t)
        assert got.dtype == torch.float32 and got.shape == t.shape
        assert torch.equal(_bits(got), _bits(want)), name
    src = program.source()
    assert src.startswith(CAUCHY_HEAD + lower.HELPERS)
    # one correctly rounded op an instruction: nothing to contract
    assert "fma" not in src[src.index("float user_entry(float t)"):]


CAUCHY_HEAD = """\
// KernelSpec.entry_fn lowered by repro_torch.kernels.pairwise.lower:
// the pairwise kernels' EPI_USER epilogue.
#include <cuda_runtime.h>

"""
CAUCHY_ENTRY = """\
__device__ __forceinline__ float user_entry(float t) {
  const float v1 = __fmul_rn(t, 0x1p-1f);
  const float v2 = __fadd_rn(v1, 0x1p+0f);
  const float v3 = user_rcp(v2);
  const float v4 = __fmul_rn(v3, 0x1p+0f);
  return v4;
}
"""
CAUCHY_SOURCE = CAUCHY_HEAD + lower.HELPERS + "\n" + CAUCHY_ENTRY


def test_cauchy_source_and_key():
    """torch evaluates 1.0 / x as reciprocal(x) · 1.0: the program keeps
    that order, each op one correctly rounded instruction or helper."""
    program = lower.lower_entry(cauchy_entry(0.5), "cauchy")
    assert program.source() == CAUCHY_SOURCE
    assert lower.lower_entry(cauchy_entry(0.5)).key == program.key
    assert lower.lower_entry(cauchy_entry(0.25)).key != program.key
    code = ("from repro_torch.kernels.pairwise import lower; "
            "print(lower.lower_entry(lambda t: 1.0 / (1.0 + 0.5 * t)).key)")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    assert out.stdout.strip() == program.key


def test_literals_are_exact():
    for x in (0.5, 1.0, -0.0, 0.1, 3.4028234663852886e38, 1e-45, -2.5e-40):
        v = lower.f32(x)
        lit = lower.literal(v)
        assert lit.endswith("f") and float.fromhex(lit[:-1]) == v
    assert lower.literal(float("inf")) == "__int_as_float(0x7f800000)"
    assert lower.f32(0.1) == float(np.float32(0.1))


def test_specs_are_lowered_once_and_pow_follows_torch():
    spec = tspecs.KernelSpec("cauchy_once", "sqdist", cauchy_entry(0.5))
    assert lower.program_for(spec) is lower.program_for(spec)
    src = lower.lower_entry(lambda t: t ** 2 + t ** 4 + t ** -2).source()
    assert "__fmul_rn(t, t)" in src and "user_rcp(__fmul_rn(t, t))" in src
    assert "powf" not in src
    assert "powf(t, 0x1.b33334p+0f)" in \
        lower.lower_entry(lambda t: t ** 1.7).source()
    # a division by a power of two is the exact product by its reciprocal
    assert "__fmul_rn(t, 0x1p-3f)" in \
        lower.lower_entry(lambda t: t / 8.0).source()
    assert "__fmul_rn(t, 0x1p+127f)" in \
        lower.lower_entry(lambda t: t / 2.0 ** -127).source()
    for c in (3.0, 2.0 ** -128, 0.0):
        assert "user_div(t, " in lower.lower_entry(lambda t: t / c).source()


def test_helpers_call_no_subroutine_and_max_min_propagate_nan():
    """The header's reciprocal, quotient and square root are inline (the
    correctly rounded intrinsics call a slow-path subroutine), and maximum,
    minimum and clamp are single NaN-propagating instructions in torch's
    order, min(max(x, lo), hi)."""
    for intrinsic in ("__frcp_rn", "__fdiv_rn", "__fsqrt_rn", "__ddiv_rn",
                      "__dsqrt_rn"):
        assert f"{intrinsic}(" not in lower.HELPERS
    assert "max.NaN.f32" in lower.HELPERS and "min.NaN.f32" in lower.HELPERS
    src = lower.lower_entry(
        lambda t: torch.maximum(t, 1 - t) + torch.clamp(t, 0.5, 3.0)
        - torch.minimum(t, torch.tensor(0.25))).source()
    body = src[src.index("float user_entry(float t)"):]
    assert "user_max(t, v1)" in body
    assert "user_min(user_max(t, 0x1p-1f), 0x1.8p+1f)" in body
    assert "user_min(t, 0x1p-2f)" in body and "?" not in body


REFUSED = (
    ("reduction", lambda t: t - t.mean(), "aten.mean"),
    ("branch", lambda t: t if float(t.max()) > 0 else -t,
     "_local_scalar_dense"),
    ("off_list", lambda t: torch.erf(t), "aten.erf"),
    ("shape", lambda t: t + torch.tensor([[0.5]]), "aten.lift_fresh_copy"),
    ("numpy", lambda t: torch.as_tensor(np.exp(t.numpy())), "numpy"),
)


@pytest.mark.parametrize("name,entry,op", REFUSED,
                         ids=[r[0] for r in REFUSED])
def test_refusals_name_the_op_and_the_cpu_path_runs(name, entry, op):
    spec = tspecs.KernelSpec(f"user_{name}", "sqdist", entry)
    X = torch.as_tensor(np.random.default_rng(2).normal(size=(9, 3)),
                        dtype=torch.float32)
    V = torch.ones((9, 2))
    calls = (lambda: tkernel.pairwise_block_cuda(spec, X, X),
             lambda: tkernel.pairwise_matmat_multi_cuda(spec, X, X, [V]),
             lambda: tkernel.pairwise_matmat_multi_slab_cuda(spec, X, 0, 4,
                                                             [V]))
    for call in calls:
        with pytest.raises(ValueError, match=op) as info:
            call()
        assert f"user_{name}" in str(info.value)
    blk = tkernel.pairwise_block(spec, X, X)
    assert torch.equal(blk, entry(tspecs.stat_block("sqdist", X, X)))
    (out,) = tkernel.pairwise_matmat_multi(spec, X, X, [V])
    assert out.shape == (9, 2) and bool(torch.isfinite(out).all())


def test_user_epilogue_id_matches_the_cuda_source():
    """The .cu's epilogue enum: the built-in kinds at their indices in
    ``EPILOGUE_KINDS``, then ``EPI_USER`` at ``kernel.EPI_USER``; a spec
    cannot name a kind outside the built-in ones."""
    src = (REPO / "src/repro_torch/kernels/pairwise/csrc/pairwise_wgmma.cu"
           ).read_text()
    enum = re.search(r"enum \{\s*(EPI_IDENTITY.*?)\};", src, re.S).group(1)
    ids = [int(v) for v in re.findall(r"EPI_\w+ = (\d+)", enum)]
    assert ids == list(range(len(tspecs.EPILOGUE_KINDS) + 1))
    assert f"EPI_USER = {tkernel.EPI_USER}" in enum
    assert tkernel.EPI_USER == len(tspecs.EPILOGUE_KINDS)
    assert "#ifdef PAIRWISE_USER_STAT" in src
    with pytest.raises(ValueError, match="epilogue=None"):
        tspecs.KernelSpec("u", "sqdist", cauchy_entry(0.5),
                          epilogue=tspecs.Epilogue("user"))


# ---------------------------------------------------------------------------
# (d) the reference's custom-kernel story, both sides on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def points():
    rng = np.random.default_rng(7)
    centers = rng.normal(size=(4, D)) * 1.5
    return (centers[rng.integers(0, 4, size=N)]
            + rng.normal(size=(N, D)) * 0.3).astype(np.float32)


def _both(X, gamma=0.5):
    """The same cauchy spec built directly on both sides, unregistered."""
    jspec = jspecs.KernelSpec(name="cauchy", stat="sqdist",
                              entry_fn=cauchy_entry(gamma),
                              params=(("gamma", gamma),))
    tspec = tspecs.KernelSpec("cauchy", "sqdist", cauchy_entry(gamma),
                              params=(("gamma", gamma),))
    return (JCounting(JPairwise(jnp.asarray(X), jspec, use_pallas=True)),
            TCounting(TPairwise(X, tspec, device="cpu")))


def scaled(port, ref) -> float:
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


def _same_meter(t, j):
    assert t.counts == j.counts
    assert t.last_route == j.last_route.replace("pallas_", "")


def test_custom_spec_sweep_and_fast_U_match_the_reference(points):
    Kj, Kt = _both(points)
    rng = np.random.default_rng(8)
    idx = rng.choice(N, C, replace=False)
    Smat = (rng.normal(size=(N, S)) / np.sqrt(S)).astype(np.float32)
    Cj, KSj = Kj.sweep([jsweep.ColumnGatherPlan(jnp.asarray(idx)),
                        jsweep.MatmulPlan(jnp.asarray(Smat))])
    Ct, KSt = Kt.sweep([tsweep.ColumnGatherPlan(torch.from_numpy(idx)),
                        tsweep.MatmulPlan(torch.from_numpy(Smat))])
    assert Kj.last_route == "pallas_fused" and Kt.last_route == "fused"
    _same_meter(Kt, Kj)
    assert scaled(Ct, Cj) <= TOL and scaled(KSt, KSj) <= TOL
    Uj = jsp.fast_U(jnp.asarray(Smat.T) @ Cj, jnp.asarray(Smat.T) @ KSj)
    St = torch.from_numpy(Smat)
    Ut = tsp.fast_U(St.T @ Ct, St.T @ KSt)
    assert scaled(Ut, Uj) <= TOL


def test_custom_spec_fast_model_from_C_matches_the_reference(points):
    Kj, Kt = _both(points)
    idx = np.random.default_rng(9).choice(N, C, replace=False)
    Cj = Kj.columns(jnp.asarray(idx))
    Ct = Kt.columns(torch.from_numpy(idx))
    assert scaled(Ct, Cj) <= TOL
    Kj.reset(), Kt.reset()
    apj = jsp.fast_model_from_C(Kj, Cj, KEY, S, P_indices=jnp.asarray(idx),
                                s_sketch="gaussian")
    Smat = np.array(jsk.GaussianSketch(KEY, N, S)._mat())
    apt = tsp.fast_model_from_C(Kt, Ct, S, P_indices=idx,
                                s_sketch="gaussian", S=Smat)
    assert Kj.last_route == "pallas_fused" and Kt.last_route == "fused"
    _same_meter(Kt, Kj)
    assert scaled(apt.U, apj.U) <= TOL


def test_custom_spec_fast_model_with_error_matches_the_reference(points):
    Kj, Kt = _both(points)
    apj, errj = jsp.fast_model_with_error(Kj, KEY, C, S, s_sketch="gaussian",
                                          probes=PROBES)
    ks = jax.random.split(KEY)[1]
    Smat = np.array(jsk.GaussianSketch(ks, N, S)._mat())
    Z = np.array(jax.random.rademacher(jax.random.fold_in(KEY, 777),
                                       (N, PROBES), dtype=jnp.float32))
    idx = np.array(apj.P_indices)
    apt, errt = tsp.fast_model_with_error(Kt, C, S, s_sketch="gaussian",
                                          probes=PROBES, idx=idx, S=Smat, Z=Z)
    assert Kj.last_route == "pallas_fused" and Kt.last_route == "fused"
    _same_meter(Kt, Kj)
    assert Kt.counts["fused_sweeps"] == 1 and Kt.counts["sweeps"] == 1
    assert scaled(apt.C, apj.C) <= TOL and scaled(apt.U, apj.U) <= TOL
    assert abs(float(errt) - float(errj)) <= TOL


# ---------------------------------------------------------------------------
# (e) the user library's build
# ---------------------------------------------------------------------------

def test_user_library_flags_header_and_hash(tmp_path, monkeypatch):
    monkeypatch.setattr(kbuild, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(pw_build, "_USER", {})
    program = lower.lower_entry(cauchy_entry(0.5), "cauchy")
    lib = pw_build.user_library(program, "sqdist")
    assert pw_build.user_library(program, "sqdist") is lib
    header = tmp_path / f"user_entry_{program.key}.h"
    assert header.read_text() == program.source()
    cmd = lib.nvcc_command("nvcc", Path("out.so"))
    assert "-DPAIRWISE_USER_STAT=1" in cmd
    i = cmd.index("-include")
    assert cmd[i + 1] == str(header) and cmd[-1].endswith("pairwise_wgmma.cu")
    assert "arch=compute_90a,code=sm_90a" in cmd
    path = lib.library_path()
    assert path.parent == tmp_path
    assert path.name.startswith(f"libpairwise_user_{program.key}_sqdist_")
    assert path != pw_build.user_library(program, "l1dist").library_path()
    assert "-DPAIRWISE_USER_STAT=2" in pw_build.user_library(
        program, "l1dist").nvcc_command("nvcc", Path("o.so"))
    header.write_text(program.source() + "// edited\n")
    assert lib.library_path() != path
    # the built-in library: no extra flag, no header, the same command
    assert pw_build.LIBRARY.flags == () and pw_build.LIBRARY.headers == ()
    src = str(pw_build.SOURCES[0])
    assert pw_build.LIBRARY.nvcc_command("nvcc", Path("o.so")) == \
        ["nvcc", *kbuild.NVCC_FLAGS, "-o", "o.so", src]


PTXAS = """\
ptxas info    : Compiling entry function '_Z17pairwise_block_tcILi2ELi0ELi4EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z17pairwise_block_tcILi2ELi0ELi4EEvv
    {frame} bytes stack frame, {st} bytes spill stores, {ld} bytes spill loads
ptxas info    : Used 80 registers
ptxas info    : Compiling entry function '_Z11prep_pointsv' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
"""


@pytest.mark.parametrize("spilled", [False, True])
def test_user_library_refuses_a_build_that_spills(tmp_path, monkeypatch,
                                                  spilled):
    """The loader reads the build's ptxas report: a variant whose kernels
    spill raises (such a build computed wrong entries on the card); one
    that does not is bound.  The library file is a stand-in here."""
    monkeypatch.setattr(kbuild, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(pw_build, "_USER", {})
    monkeypatch.setattr(pw_build, "_bind", lambda cdll: cdll)
    monkeypatch.setattr(kbuild.ctypes, "CDLL", lambda path: ("loaded", path))
    program = lower.lower_entry(cauchy_entry(0.5), "cauchy")
    lib = pw_build.user_library(program, "l1dist")
    path = lib.library_path()
    path.write_bytes(b"")
    st = 4 if spilled else 0
    path.with_suffix(".log").write_text(
        PTXAS.format(frame=2 * st, st=st, ld=st))
    report = lib.build_log()
    assert pw_build.spills(report) == (
        {"_Z17pairwise_block_tcILi2ELi0ELi4EEvv": 8} if spilled else {})
    if spilled:
        with pytest.raises(RuntimeError, match="spill"):
            lib.load()
    else:
        assert lib.load() == ("loaded", str(path))
