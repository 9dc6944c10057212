#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits non-zero:

1. card: ``nvidia-smi`` name and power limit, torch/CUDA versions, TF32 off;
2. build: compile the pairwise CUDA kernels from ``src/repro_torch/.../csrc``;
3. parity: every kernel against its plain PyTorch version on the card, for
   every registered spec × precision at a ragged shape (plus laplacian with
   a sign-split edge table), and the one-hot gather exact;
4. main path: the fast SPSD model (paper Algorithm 1) at the documented
   large-n setting (``examples/quickstart.py`` ``large_n_demo``: n = 50,000
   points, d = 16, 32 Gaussian clusters, RBF σ = 3, c = n/250 = 200,
   s = 4c = 800, 64 Hutchinson probes) — ``fast_model_with_error``
   (gaussian, one fused launch), ``fast_model`` (leverage column sketch,
   block kernel) and ``relative_error(method="blocked")`` (75 panels of the
   block kernel) — with launch counts and metered entries, results checked
   against the plain versions and the Hutchinson estimate against the exact
   error; then the entry counts at the n = 3,000 scaling shape;
5. one JSON line ``{"kernels": [...]}``: per kernel its launches on the main
   path, time, plain-version time, bound, library-call time, error;
6. the card line again, then the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

It exits non-zero without a CUDA device, and in a directory without the
repository's ``src/``.  It never imports JAX or the reference package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import sketch as sk  # noqa: E402
from repro_torch.core import spsd  # noqa: E402
from repro_torch.core import sweep as sweep_lib  # noqa: E402
from repro_torch.core.instrument import CountingOperator  # noqa: E402
from repro_torch.core.kernelop import RBFKernel  # noqa: E402
from repro_torch.core.selection import get_policy  # noqa: E402
from repro_torch.kernels.pairwise import build, kernel, signsplit, specs  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_TC_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

TOL_F32 = 1e-5          # f32 kernel vs plain, scale-normalized
TOL_BF16_SAME = 1e-2    # bf16_f32acc kernel vs plain under the same policy
TOL_BF16_F32 = 5e-2     # bf16_f32acc kernel vs the f32 plain version
# At the main shape every fused output sums 50,000 products.  Two f32
# implementations that add them in different orders (the kernel's tile sums,
# cuBLAS's in the plain version) differ by their rounding, which grows like
# sqrt(n)·eps of the partial sums; 1e-5 is the reference's gate at its test
# sizes (n ≤ 600).  So the kernel is held to 1e-5 against the exact (f64)
# contraction of the plain version's f32 entries, and to this stated
# tolerance against the f32 plain version itself.
TOL_F32_MAIN = 5e-5

DEV = "cuda"

# the main-path configuration (quickstart large_n_demo)
N, D, CLUSTERS, NOISE, SIGMA = 50_000, 16, 32, 0.5, 3.0
C_COLS, S_COLS, PROBES = N // 250, 4 * (N // 250), 64


class SmokeFailure(AssertionError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def cuda_ms(fn, reps: int = 1, warmup: int = 0):
    """Mean milliseconds of ``fn`` on the current stream (CUDA events),
    after ``warmup`` untimed calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps, out


def scaled_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a − b| / max |b|."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def clusters(n: int, seed: int) -> torch.Tensor:
    """The large-n demo data: 32 Gaussian clusters in d = 16, noise 0.5."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(CLUSTERS, D)) * 2.0
    labels = rng.integers(0, CLUSTERS, size=n)
    X = centers[labels] + rng.normal(size=(n, D)) * NOISE
    return torch.as_tensor(X, dtype=torch.float32, device=DEV)


def letters(n: int, seed: int) -> torch.Tensor:
    """The scaling bench's data (``benchmarks/common.py`` ``make_dataset``,
    "letters"): 26 clusters in d = 16, noise 0.7, standardized features."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(26, D)) * 2.0
    labels = rng.integers(0, 26, size=n)
    X = centers[labels] + rng.normal(size=(n, D)) * 0.7
    X = (X - X.mean(0)) / (X.std(0) + 1e-9)
    return torch.as_tensor(X, dtype=torch.float32, device=DEV)


def gen(seed: int) -> torch.Generator:
    return torch.Generator(device=DEV).manual_seed(seed)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_card() -> str:
    line = card_line()
    log(f"card: {line}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}")
    return line


def phase_build() -> None:
    t0 = time.perf_counter()
    build.load_library()
    log(f"build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {build.build_seconds()} s) -> {build.library_path()}")
    for ln in build.build_log().splitlines():
        if "registers" in ln or "spill" in ln or "Compiling" in ln:
            log(f"  ptxas: {ln.strip()}")


def _parity_case(spec, Xr, Xc, Vs, edges, label) -> dict:
    """B1 and B2 against their plain versions; returns the errors."""
    f32 = spec.with_precision("f32")
    blk = kernel.pairwise_block_cuda(spec, Xr, Xc, edges)
    blk_plain = kernel.pairwise_block_plain(spec, Xr, Xc, edges)
    outs = kernel.pairwise_matmat_multi_cuda(spec, Xr, Xc, Vs, edges)
    outs_plain = kernel.pairwise_matmat_multi_plain(spec, Xr, Xc, Vs, edges)
    torch.cuda.synchronize()
    errs = {"block": scaled_err(blk, blk_plain),
            "multi": max(scaled_err(o, p) for o, p in zip(outs, outs_plain))}
    if spec.precision == "f32":
        for k, e in errs.items():
            check(e <= TOL_F32, f"{label} {k}: {e:.3g} > {TOL_F32}")
    else:
        for k, e in errs.items():
            check(e <= TOL_BF16_SAME,
                  f"{label} {k}: {e:.3g} > {TOL_BF16_SAME}")
        blk32 = kernel.pairwise_block_plain(f32, Xr, Xc, edges)
        outs32 = kernel.pairwise_matmat_multi_plain(f32, Xr, Xc, Vs, edges)
        e32 = max(scaled_err(blk, blk32),
                  max(scaled_err(o, p) for o, p in zip(outs, outs32)))
        check(e32 <= TOL_BF16_F32, f"{label} vs f32: {e32:.3g}")
        errs["vs_f32"] = e32
    check(all(bool(torch.isfinite(o).all()) for o in (blk, *outs)),
          f"{label}: non-finite output")
    return errs


def phase_parity() -> None:
    rng = np.random.default_rng(1)
    nr, nc = 1000, 1500
    dev = DEV
    Xr = torch.as_tensor(rng.normal(size=(nr, D)), dtype=torch.float32,
                         device=dev)
    Xc = torch.as_tensor(rng.normal(size=(nc, D)), dtype=torch.float32,
                         device=dev)
    gidx = torch.as_tensor(rng.choice(nc, 37, replace=False), device=dev)
    Vs = (sweep_lib.one_hot_columns(gidx, nc, dev),
          torch.as_tensor(rng.normal(size=(nc, 129)), dtype=torch.float32,
                          device=dev),
          torch.as_tensor(rng.normal(size=(nc, 16)), dtype=torch.float32,
                          device=dev))
    for name in specs.registered_kernels():
        for prec in specs.PRECISIONS:
            spec = specs.suggested_spec(name, D).with_precision(prec)
            errs = _parity_case(spec, Xr, Xc, Vs, None, f"{name}/{prec}")
            if prec == "f32":
                # the one-hot gather through B1 is the block entries exactly
                gathered = kernel.pairwise_matmat_multi_cuda(
                    spec, Xr, Xc, Vs[:1])[0]
                direct = kernel.pairwise_block_cuda(spec, Xr, Xc[gidx])
                gap = float((gathered - direct).abs().max())
                check(gap == 0.0, f"{name}: one-hot gather not exact ({gap})")
                errs["gather_gap"] = gap
            log(f"parity {name:10s} {prec:12s} " + " ".join(
                f"{k}={v:.3g}" for k, v in errs.items()))
    # laplacian on integer-valued data, with the sign-split edge table
    Xi = rng.integers(0, 6, size=(nr + nc, D)).astype(np.float32)
    edges = torch.as_tensor(signsplit.build_plan(Xi).edges, device=dev)
    Xir = torch.as_tensor(Xi[:nr], device=dev)
    Xic = torch.as_tensor(Xi[nr:], device=dev)
    for prec in specs.PRECISIONS:
        spec = specs.suggested_spec("laplacian", D).with_precision(prec)
        errs = _parity_case(spec, Xir, Xic, Vs, edges,
                            f"laplacian+edges/{prec}")
        log(f"parity laplacian+edges {prec:12s} " + " ".join(
            f"{k}={v:.3g}" for k, v in errs.items()))


def _main_calls(op, idx, S, Z):
    """The three main-path calls, each timed; returns results and times."""
    times, out = {}, {}
    op.reset()
    times["fast_model_with_error"], (out["apg"], out["err_h"]) = cuda_ms(
        lambda: spsd.fast_model_with_error(
            op, C_COLS, S_COLS, s_sketch="gaussian", probes=PROBES, idx=idx,
            S=S, Z=Z))
    out["counts_fused"] = dict(op.counts)
    out["route_fused"] = op.last_route
    op.reset()
    times["fast_model_leverage"], out["apl"] = cuda_ms(
        lambda: spsd.fast_model(op, C_COLS, S_COLS, s_sketch="leverage",
                                idx=idx, generator=gen(3)))
    out["counts_leverage"] = dict(op.counts)
    op.reset()
    times["relative_error_blocked"], out["err_b"] = cuda_ms(
        lambda: spsd.relative_error(op, out["apg"], method="blocked"))
    out["counts_blocked"] = dict(op.counts)
    out["route_blocked"] = op.last_route
    return times, out


def phase_main() -> dict:
    # the reference's count model: a sweep evaluates nblocks · b · n entries
    # (75 panels of 671 rows at n = 50,000: 2,516,250,000)
    block = sweep_lib.resolved_block_size(N, N, None)
    panels = sweep_lib.num_panels(N, N, None)
    fused_entries = panels * block * N
    if N == 50_000:
        check(panels == 75 and block == 671
              and fused_entries == 2_516_250_000,
              f"panel model {panels} x {block}")
    X = clusters(N, seed=0)
    op = CountingOperator(RBFKernel(X, sigma=SIGMA, device=DEV))
    spec = op.inner.spec
    g = gen(0)
    idx = get_policy("uniform").select(op, C_COLS, generator=g)
    S = sk.GaussianSketch.draw(N, S_COLS, generator=g, device=DEV)
    Z = sk.rademacher(N, PROBES, generator=g, device=DEV)

    _main_calls(op, idx, S, Z)                      # warm-up
    torch.cuda.synchronize()
    kernel.reset_launch_counts()
    times, out = _main_calls(op, idx, S, Z)         # the counted run
    torch.cuda.synchronize()
    launches = kernel.launch_counts()
    log(f"main path (n={N}, d={D}, c={C_COLS}, s={S_COLS}, "
        f"probes={PROBES}): times ms {json.dumps(times)}")
    log(f"main path launches {json.dumps(launches)}")
    for k in ("counts_fused", "counts_leverage", "counts_blocked"):
        log(f"main path {k}: {json.dumps(out[k])}")

    cf, cb = out["counts_fused"], out["counts_blocked"]
    check(launches["pairwise_matmat_multi"] > 0 and
          launches["pairwise_block"] > 0, f"a kernel never ran: {launches}")
    check(launches["pairwise_matmat_multi"] == 1,
          f"fast_model_with_error should be one fused launch: {launches}")
    check(cf["sweeps"] == 1 and cf["fused_sweeps"] == 1
          and cf["entries"] == fused_entries and out["route_fused"] == "fused",
          f"fused sweep metering {cf} {out['route_fused']}")
    check(out["counts_leverage"]["columns"] == 1
          and out["counts_leverage"]["blocks"] == 1
          and out["counts_leverage"]["sweeps"] == 0,
          f"leverage path metering {out['counts_leverage']}")
    check(cb["sweeps"] == 1 and cb["panels"] == panels
          and cb["entries"] == fused_entries and out["route_blocked"] == "panel",
          f"blocked error metering {cb} {out['route_blocked']}")
    check(launches["pairwise_block"] == 2 + panels,
          f"block launches {launches['pairwise_block']} != {2 + panels}")

    apg, apl = out["apg"], out["apl"]
    err_h, err_b = float(out["err_h"]), float(out["err_b"])
    for name, t, shape in (("C", apg.C, (N, C_COLS)), ("U", apg.U,
                           (C_COLS, C_COLS)), ("C_lev", apl.C, (N, C_COLS)),
                           ("U_lev", apl.U, (C_COLS, C_COLS))):
        check(tuple(t.shape) == shape and bool(torch.isfinite(t).all()),
              f"{name}: shape {tuple(t.shape)} or non-finite")
    check(np.isfinite(err_h) and np.isfinite(err_b) and err_b > 0,
          f"errors {err_h} {err_b}")
    check(abs(err_h - err_b) <= 0.5 * err_b,
          f"Hutchinson {err_h:.5f} not within 50% of blocked {err_b:.5f}")
    log(f"main path rel err: hutchinson {err_h:.6f}, blocked {err_b:.6f}")

    # results against the plain versions on 512 sampled rows
    rows = torch.randperm(N, generator=gen(5), device=DEV)[:512]
    K_rows = kernel.pairwise_block_plain(spec, X[rows], X)
    e_c = scaled_err(apg.C[rows], K_rows[:, idx])
    e_cl = scaled_err(apl.C[rows], K_rows[:, idx])
    check(e_c <= TOL_F32 and e_cl <= TOL_F32, f"C rows: {e_c} {e_cl}")
    log(f"main path C rows vs plain: fused {e_c:.3g}, columns {e_cl:.3g}")
    return dict(X=X, spec=spec, idx=idx, S=S, Z=Z, launches=launches,
                times=times, err_h=err_h, err_b=err_b)


def phase_scaling() -> None:
    """Entry counts at the BENCH_pr10 scaling shape (n=3000, c=32, s=128)."""
    X = letters(3000, seed=0)
    op = CountingOperator(RBFKernel(X, sigma=SIGMA, device=DEV))
    ap = spsd.fast_model(op, 32, 128, s_sketch="gaussian", streaming=True,
                         generator=gen(0))
    err = float(spsd.relative_error(op, ap, method="hutchinson", probes=16,
                                    generator=gen(1)))
    separate = op.counts["entries"]
    op.reset()
    _, err_f = spsd.fast_model_with_error(op, 32, 128, s_sketch="gaussian",
                                          probes=16, generator=gen(0))
    fused = op.counts["entries"]
    log(f"scaling n=3000: entries separate {separate:,} fused {fused:,}; "
        f"rel err {err:.5f} / fused {float(err_f):.5f}")
    check(separate == 18_000_000 and fused == 9_000_000,
          f"scaling entries {separate} {fused}")


def _b1_line(m: dict) -> dict:
    """B1 at the main shape: kernel, plain version (row slabs), bound."""
    X, spec = m["X"], m["spec"]
    Vs = (sweep_lib.one_hot_columns(m["idx"], N, DEV), m["S"].mat, m["Z"])
    ms, outs = cuda_ms(
        lambda: kernel.pairwise_matmat_multi_cuda(spec, X, X, Vs), reps=2)
    out = torch.cat(outs, dim=1)
    del outs
    slab = 5000
    plain = torch.empty_like(out)

    def run_plain():
        for r0 in range(0, N, slab):
            plain[r0:r0 + slab] = torch.cat(kernel.pairwise_matmat_multi_plain(
                spec, X[r0:r0 + slab], X, Vs), dim=1)
        return plain

    plain_ms, _ = cuda_ms(run_plain, warmup=1)
    err = float((out - plain).abs().max())
    rel = err / float(plain.abs().max())
    # the plain version's f32 entries contracted in f64
    V64 = torch.cat(Vs, dim=1).double()
    err_k = err_p = scale = 0.0
    for r0 in range(0, N, slab):
        exact = kernel.pairwise_block_plain(spec, X[r0:r0 + slab], X).double() \
            @ V64
        err_k = max(err_k, float((out[r0:r0 + slab] - exact).abs().max()))
        err_p = max(err_p, float((plain[r0:r0 + slab] - exact).abs().max()))
        scale = max(scale, float(exact.abs().max()))
    del V64, exact
    log(f"B1 main shape: vs plain {rel:.3g} (max abs {err:.3g}); vs the f64 "
        f"contraction: kernel {err_k / scale:.3g}, plain {err_p / scale:.3g}")
    check(err_k / scale <= TOL_F32, f"B1 vs f64 contraction {err_k / scale}")
    check(rel <= TOL_F32_MAIN, f"B1 main shape vs plain: {rel:.3g}")

    spec16 = spec.with_precision("bf16_f32acc")
    ms16, outs16 = cuda_ms(
        lambda: kernel.pairwise_matmat_multi_cuda(spec16, X, X, Vs), warmup=1)
    rows = torch.arange(0, N, N // 512, device=DEV)[:512]
    plain16 = kernel.pairwise_matmat_multi_plain(spec16, X[rows], X, Vs)
    e16 = max(scaled_err(o[rows], p) for o, p in zip(outs16, plain16))
    check(e16 <= TOL_BF16_SAME, f"B1 bf16_f32acc rows vs plain: {e16:.3g}")
    del outs16, plain16
    # the l1dist statistic inside B1 (laplacian, the same inputs)
    lap = specs.suggested_spec("laplacian", D)
    ms_l1, outs_l1 = cuda_ms(
        lambda: kernel.pairwise_matmat_multi_cuda(lap, X, X, Vs), warmup=1)
    plain_l1 = kernel.pairwise_matmat_multi_plain(lap, X[rows], X, Vs)
    e_l1 = max(scaled_err(o[rows], p) for o, p in zip(outs_l1, plain_l1))
    check(e_l1 <= TOL_F32_MAIN, f"B1 laplacian rows vs plain: {e_l1:.3g}")
    del outs_l1, plain_l1

    M = sum(int(V.shape[1]) for V in Vs)
    flops = 2 * N * N * M + 2 * D * N * N
    nbytes = 4 * (2 * N * D + N * M + N * M)
    bound_f32 = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
    bound_bf16 = max(flops / PEAK_BF16_TC_FLOPS,
                     nbytes / PEAK_HBM_BYTES) * 1e3
    log(f"B1 main shape: {ms:.3f} ms, plain {plain_ms:.3f} ms, bound f32 "
        f"{bound_f32:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
        f"{bound_f32 / ms:.1%} of the FP32 roof); bf16_f32acc {ms16:.3f} ms "
        f"(tensor-core bound {bound_bf16:.3f} ms, rows vs plain {e16:.3g}); "
        f"laplacian (l1dist) {ms_l1:.3f} ms (rows vs plain {e_l1:.3g})")
    return {"name": "pairwise_matmat_multi", "route": "cuda",
            "source": "src/repro_torch/kernels/pairwise/csrc/pairwise.cu",
            "replaces": "src/repro/kernels/pairwise/kernel.py:127",
            "launches": m["launches"]["pairwise_matmat_multi"],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_f32, "bound_by": "operations",
            "library_ms": None,
            "shape": {"nr": N, "nc": N, "d": D, "M": M, "spec": "rbf",
                      "precision": "f32"},
            "scaled_err_vs_f64_contraction": err_k / scale,
            "ms_bf16_f32acc": ms16, "ms_laplacian_l1dist": ms_l1,
            "bound_ms_bf16_tensor_cores": bound_bf16}


def _b2_line(m: dict) -> dict:
    """B2 at the panel shape of the blocked error (671 × 50,000)."""
    X, spec = m["X"], m["spec"]
    b = sweep_lib.resolved_block_size(N, N, None)
    Xr = X[:b].contiguous()
    ms, out = cuda_ms(lambda: kernel.pairwise_block_cuda(spec, Xr, X), reps=5)
    plain_ms, plain = cuda_ms(
        lambda: kernel.pairwise_block_plain(spec, Xr, X), reps=5, warmup=1)
    err = float((out - plain).abs().max())
    check(scaled_err(out, plain) <= TOL_F32, f"B2 panel vs plain: {err:.3g}")
    # the main path's other two B2 shapes: C = K[:, idx] and the
    # (s + c)² SᵀKS block of the leverage sketch
    Xs = X[m["idx"]]
    Xb = X[:S_COLS + C_COLS].contiguous()
    for Xa, Xz, what in ((X, Xs, "columns"), (Xb, Xb, "sketch block")):
        e = scaled_err(kernel.pairwise_block_cuda(spec, Xa, Xz),
                       kernel.pairwise_block_plain(spec, Xa, Xz))
        check(e <= TOL_F32, f"B2 {what} vs plain: {e:.3g}")
    lap = specs.suggested_spec("laplacian", D)
    ms_l1, out_l1 = cuda_ms(
        lambda: kernel.pairwise_block_cuda(lap, Xr, X), reps=5, warmup=1)
    check(scaled_err(out_l1, kernel.pairwise_block_plain(lap, Xr, X))
          <= TOL_F32, "B2 laplacian vs plain")
    lin = specs.linear()
    lin_ms, lin_out = cuda_ms(
        lambda: kernel.pairwise_block_cuda(lin, Xr, X), reps=5, warmup=1)
    lib_ms, lib_out = cuda_ms(lambda: torch.mm(Xr, X.T), reps=5, warmup=1)
    check(scaled_err(lin_out, lib_out) <= TOL_F32, "B2 linear vs torch.mm")
    flops = 2 * D * b * N
    nbytes = 4 * (b * D + N * D + b * N)
    bound = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
    log(f"B2 panel shape ({b} x {N}): {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound:.4f} ms, linear spec {lin_ms:.4f} ms vs torch.mm "
        f"{lib_ms:.4f} ms, laplacian (l1dist) {ms_l1:.4f} ms, "
        f"max abs err {err:.3g}")
    return {"name": "pairwise_block", "route": "cuda",
            "source": "src/repro_torch/kernels/pairwise/csrc/pairwise.cu",
            "replaces": "src/repro/kernels/pairwise/kernel.py:241",
            "launches": m["launches"]["pairwise_block"],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "bytes", "library_ms": lib_ms,
            "shape": {"nr": b, "nc": N, "d": D, "spec": "rbf",
                      "precision": "f32"},
            "library_call": "torch.mm(Xr, Xc.T) (the linear spec)",
            "linear_spec_ms": lin_ms, "ms_laplacian_l1dist": ms_l1}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    phase_card()
    phase_build()
    phase_parity()
    m = phase_main()
    phase_scaling()
    kernels_line = {"kernels": [_b1_line(m), _b2_line(m)]}
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps(kernels_line), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
