#!/usr/bin/env python3
"""Hold the pairwise kernels of this checkout against another version of
``pairwise_wgmma.cu`` on one NVIDIA card: accuracy of the f32 sqdist
statistic and times in turns.

    python3 tools/pairwise_ab.py --ref path/to/other/pairwise_wgmma.cu

The other source (an earlier commit's, unpacked with ``git archive``) is
built beside this checkout's as its own library; both serve the same
wrappers in turn.  On the main path's data (``chip_smoke._main_inputs``:
quickstart's n = 50,000 points in 32 clusters, d = 16, 200 columns, the
Gaussian sketch and the probes):

- rbf at σ = 1 and 3: C through B1's one-hot gather, B2's block and B4's
  slab rows, and B2's 671-row panel, each against the f64 statistic's
  entries; B1's gather against B2 (bit for bit at 2^-104 and more), B4's
  rows against B1's;
- the share of pairs below ``kernel.NEAR_TAU`` (‖x‖² + ‖y‖²) in f64;
- B1 (rbf σ = 3, M = 1,064), B2's panel, B4 (rows 25,004 on) and the
  statistic-only B2 (50,000 × 200) in turns ref, this, this, ref;
- this checkout's user cauchy spec (γ = 0.5) beside rbf, and its C
  against f64;
- one tight cluster far from the origin (every pair near): B1 for both
  and laplacian's direct form, B2's panel, and C against f64.

Prints one JSON object (and writes it to ``build/pairwise_ab.json``)
after the card's name and power limit.  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.core import sweep as sweep_lib  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels.pairwise import build as pw_build  # noqa: E402
from repro_torch.kernels.pairwise import kernel, specs  # noqa: E402

N, DEV = cs.N, cs.DEV
SLAB = 25_004        # rank 1's slab of spsd_sharded at n = 50,000


def err(a: torch.Tensor, b: torch.Tensor) -> float:
    return cs.scaled_err(a, b)


def near_share(Xr: torch.Tensor, Xc: torch.Tensor) -> float:
    nn = (Xr * Xr).sum(1).double()[:, None] + (Xc * Xc).sum(1).double()
    D = torch.cdist(Xr.double(), Xc.double()) ** 2
    return float((D < kernel.NEAR_TAU * nn).double().mean())


def in_turns(fns: dict, libs: dict, reps: int, warmup: int) -> dict:
    """ms of each call, in turns a, b, ..., b, a; each its turns' mean and
    the turns."""
    order = list(fns) + list(fns)[::-1]
    ms = {k: [] for k in fns}
    for k in order:
        pw_build.LIBRARY = libs[k]
        ms[k].append(cs.cuda_ms(fns[k], reps=reps, warmup=warmup)[0])
    return {k: {"ms": sum(v) / len(v), "turns": v} for k, v in ms.items()}


def accuracy(X, idx, onehot, sigma: float, lib) -> dict:
    pw_build.LIBRARY = lib
    spec = specs.rbf(sigma)
    gamma = 0.5 / sigma ** 2
    C64 = torch.exp(-gamma * torch.cdist(X.double(), X[idx].double()) ** 2)
    gathered = kernel.pairwise_matmat_multi_cuda(spec, X, X, (onehot,))[0]
    block = kernel.pairwise_block_cuda(spec, X, X[idx])
    rows = kernel.slab_rows(N, SLAB, SLAB, DEV)
    slab = kernel.pairwise_matmat_multi_slab_cuda(spec, X, SLAB, SLAB,
                                                  (onehot,))[0]
    big = block.abs() >= 2.0 ** -104
    gap = (gathered - block).abs()
    b = sweep_lib.resolved_block_size(N, N, None)
    Xr = X[:b].contiguous()
    P64 = torch.exp(-gamma * torch.cdist(Xr.double(), X.double()) ** 2)
    panel = kernel.pairwise_block_cuda(spec, Xr, X)
    return {"b1_gather_vs_f64": err(gathered.double(), C64),
            "b2_vs_f64": err(block.double(), C64),
            "b4_rows_vs_f64": err(slab.double(), C64[rows]),
            "b2_panel_vs_f64": err(panel.double(), P64),
            "gather_equals_b2": bool(torch.where(big, gap == 0,
                                                 gap < 2.0 ** -126).all()),
            "b4_rows_equal_b1": bool(torch.equal(slab, gathered[rows]))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ref", required=True, type=Path,
                    help="the other version's pairwise_wgmma.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("pairwise_ab: no CUDA device is visible", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = {"ref": kbuild.Library("pairwise_ref", (args.ref.resolve(),),
                                  pw_build._bind),
            "this": pw_build.LIBRARY}
    cauchy = cs.USER_SPECS[0]
    kbuild.build_all([*libs.values(), cs.user_library(cauchy)])
    out = {"card": card, "near_tau": kernel.NEAR_TAU,
           "spills": {k: sum(cs.ptxas_spills(lib.build_log(),
                                             "pairwise_").values())
                      for k, lib in libs.items()}}

    X, _, idx, S, Z = cs._main_inputs()
    onehot = sweep_lib.one_hot_columns(idx, N, DEV)
    Vs = (onehot, S.mat, Z)
    out["near_share_C"] = near_share(X, X[idx])
    for sigma in (1.0, 3.0):
        C64 = torch.exp(-0.5 / sigma ** 2
                        * torch.cdist(X.double(), X[idx].double()) ** 2)
        plain = kernel.pairwise_block_plain(specs.rbf(sigma), X, X[idx])
        out[f"sigma_{sigma:g}"] = {
            "plain_vs_f64": err(plain.double(), C64),
            **{k: accuracy(X, idx, onehot, sigma, lib)
               for k, lib in libs.items()}}
    pw_build.LIBRARY = libs["this"]

    rbf = specs.rbf(3.0)
    b = sweep_lib.resolved_block_size(N, N, None)
    Xr, Xa = X[:b].contiguous(), X[idx].contiguous()
    stat = specs.stat_only("sqdist")
    out["b1_ms"] = in_turns({k: lambda: kernel.pairwise_matmat_multi_cuda(
        rbf, X, X, Vs) for k in libs}, libs, reps=3, warmup=1)
    out["b2_panel_ms"] = in_turns({k: lambda: kernel.pairwise_block_cuda(
        rbf, Xr, X) for k in libs}, libs, reps=20, warmup=2)
    out["b4_ms"] = in_turns({
        k: lambda: kernel.pairwise_matmat_multi_slab_cuda(
            rbf, X, SLAB, SLAB, Vs) for k in libs}, libs, reps=3, warmup=1)
    out["b2_statistic_only_ms"] = in_turns({
        k: lambda: kernel.pairwise_block_cuda(stat, X, Xa) for k in libs},
        libs, reps=50, warmup=2)
    pw_build.LIBRARY = libs["this"]

    C64 = 1.0 / (1.0 + cs.USER_GAMMA
                 * torch.cdist(X.double(), X[idx].double()) ** 2)
    out["cauchy"] = {
        "b1_gather_vs_f64": err(kernel.pairwise_matmat_multi_cuda(
            cauchy, X, X, (onehot,))[0].double(), C64),
        "statistic_passes": cs.passes(cauchy)["statistic"],
        "b1_ms": cs._timed_pair({s.name: (
            lambda s=s: kernel.pairwise_matmat_multi_cuda(s, X, X, Vs))
            for s in (rbf, cauchy)}, reps=2, warmup=1),
        "b2_panel_ms": cs._timed_pair({s.name: (
            lambda s=s: kernel.pairwise_block_cuda(s, Xr, X))
            for s in (rbf, cauchy)}, reps=20, warmup=2),
        "b4_ms": cs._timed_pair({s.name: (
            lambda s=s: kernel.pairwise_matmat_multi_slab_cuda(
                s, X, SLAB, SLAB, Vs)) for s in (rbf, cauchy)},
            reps=2, warmup=1)}
    del C64

    # one tight cluster far from the origin: every pair is near
    rng = np.random.default_rng(5)
    center = rng.normal(size=(1, cs.D)) * 2.0
    Xt = torch.as_tensor(center + rng.normal(size=(N, cs.D)) * 0.05,
                         dtype=torch.float32, device=DEV)
    lap = specs.suggested_spec("laplacian", cs.D)
    sig = 0.05 * float(np.sqrt(2 * cs.D))
    T64 = torch.exp(-torch.cdist(Xt.double(), Xt[idx].double()) ** 2
                    / (2 * sig ** 2))
    tight = {"near_share": near_share(Xt[:2000], Xt[:2000]),
             "sigma": sig,
             "C_vs_f64": err(kernel.pairwise_matmat_multi_cuda(
                 specs.rbf(sig), Xt, Xt, (onehot,))[0].double(), T64),
             "plain_vs_f64": err(kernel.pairwise_block_plain(
                 specs.rbf(sig), Xt, Xt[idx]).double(), T64)}
    del T64
    libs3 = {**libs, "laplacian": libs["this"]}
    calls = {"ref": rbf, "this": rbf, "laplacian": lap}
    tight["b1_ms"] = in_turns({k: (lambda s=s: kernel.pairwise_matmat_multi_cuda(
        s, Xt, Xt, Vs)) for k, s in calls.items()}, libs3, reps=2, warmup=1)
    Xtr = Xt[:b].contiguous()
    tight["b2_panel_ms"] = in_turns({k: lambda: kernel.pairwise_block_cuda(
        rbf, Xtr, Xt) for k in libs}, libs, reps=20, warmup=2)
    out["tight_cluster"] = tight
    pw_build.LIBRARY = libs["this"]

    print(card, flush=True)
    line = json.dumps(out)
    (ROOT / "build").mkdir(exist_ok=True)
    (ROOT / "build" / "pairwise_ab.json").write_text(line)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
