"""The port's data-parallel sweep against the reference's sharded sweep (CPU).

Reference side: two subprocesses see 4 CPU devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``, ``JAX_PLATFORMS=cpu``,
as ``tests/test_distributed_paths.py`` runs its multi-device cases) and run
the reference's ``shard_map`` sweeps on a ("data",) mesh, with their fused
routes' Pallas kernels in interpret mode; they write .npz files with the
inputs, the reference's random draws, the results and the meters.  The
reference passes ``check_rep`` to ``shard_map``, the keyword of the jax it
was written for; under newer jax the subprocess renames it to ``check_vma``
at the call (the reference package itself is not edited).

Port side: 4 gloo ranks (``torch.multiprocessing`` spawn, a ``file://``
store in a temp dir) form a ("data",) ``DeviceMesh`` and run the same calls
with the reference's draws; every rank writes its results.  Each side runs
once per module (one fixture each).

Held exactly: the route names (``pallas_fused_sharded`` ↔ ``fused_sharded``,
``panel``), the slab mode, and the meter (sweeps, panels, entries, fused
sweeps, blocks, columns), sentinel panels included.  Held to tolerance,
scale-normalized: sweep products ≤ 1e-5; U and C U Cᵀ ≤ 1e-4 and residual
norms / leverage scores ≤ 1e-4 (pinvs and SVDs of two libraries, as in
``test_torch_spsd.py`` and ``test_torch_selection.py``); relative errors
≤ 1e-5 absolute; eigenvalues ≤ 1e-5 relative; eigenvector subspaces by
``misalignment`` ≤ 1e-4.  On the port side alone: every rank returns the
same result, the sharded fused route equals the single-device one bit for
bit, a 1-wide and a ("model",)-only mesh fall back to the single-device
route, and a ("pod", "data") mesh gives the ("data",) mesh's result.
"""
from __future__ import annotations

import datetime
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import convert
from repro_torch.core import cur as tcur
from repro_torch.core import eig as teig
from repro_torch.core import sketch as tsk
from repro_torch.core import spsd as tsp
from repro_torch.core import sweep as tsweep
from repro_torch.core.adaptive import uniform_adaptive2_indices
from repro_torch.core.instrument import CountingOperator
from repro_torch.core.kernelop import PairwiseKernel
from repro_torch.core.leverage import (column_leverage_scores_gram,
                                       row_leverage_scores_gram)
from repro_torch.core.selection import get_policy, residual_column_norms
from repro_torch.distributed import sharding
from repro_torch.kernels.pairwise import specs as tspecs

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
COUNT_KEYS = ("sweeps", "panels", "entries", "fused_sweeps", "blocks",
              "columns")
BUNDLES = ("bundle533", "bundle512", "sentinel100")
METERED = BUNDLES + ("panel", "fast_model", "with_error", "blocked",
                     "hutchinson", "resnorms", "adaptive2", "leverage",
                     "cur_gaussian", "cur_leverage", "eigh")

# Part A: the fused bundles (n = 533 and 512, the reference's sharded test
# shapes; n = 100 at block_size 8: 15 panels of 7 rows and one sentinel),
# the panel route and selection.  Part B: the models, metrics, CUR and the
# eigensolver on n = 300.
REF_SCRIPT = r'''
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from repro.core import cur, eig, spsd
from repro.core import sketch as jsk
from repro.core import sweep as sw
from repro.core.adaptive import uniform_adaptive2_indices
from repro.core.instrument import CountingOperator
from repro.core.kernelop import PairwiseKernel
from repro.core.leverage import (column_leverage_scores_gram,
                                 row_leverage_scores_gram)
from repro.core.selection import get_policy, residual_column_norms
from repro.kernels.pairwise import specs

_shard_map = sw._shard_map


def _compat(f, *, check_rep=None, **kw):
    return _shard_map(f, check_vma=check_rep, **kw)


sw._shard_map = _compat
assert len(jax.devices()) == 4, jax.devices()
MESH = Mesh(np.asarray(jax.devices()), ("data",))
COUNT_KEYS = ("sweeps", "panels", "entries", "fused_sweeps", "blocks",
              "columns")
out = {}


def points(n, seed):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(8, 8)) * 2.5
    X = centers[rng.integers(0, 8, size=n)] + rng.normal(size=(n, 8)) * 0.4
    return X.astype(np.float32)


def op(X, use_pallas=True):
    return CountingOperator(PairwiseKernel(jnp.asarray(X), specs.rbf(2.0),
                                           use_pallas=use_pallas))


def meter(name, K):
    out[name + "/counts"] = np.array([K.counts[k] for k in COUNT_KEYS])
    out[name + "/route"] = np.array(str(K.last_route))
    out[name + "/slab"] = np.array(str(K.last_slab_mode))


def put(name, **arrays):
    for k, v in arrays.items():
        out[f"{name}/{k}"] = np.asarray(v)


n = 300
X = points(n, 1)
out["X"] = X
rng = np.random.default_rng(2)
Cp = rng.normal(size=(n, 5)).astype(np.float32)
Mp = rng.normal(size=(5, n)).astype(np.float32) * 0.1
Q = np.linalg.qr(rng.normal(size=(n, 4)))[0].astype(np.float32)
out.update({"Cp": Cp, "Mp": Mp, "Q": Q})

if sys.argv[2] == "A":
    for name, m, bs in (("bundle533", 533, None), ("bundle512", 512, None),
                        ("sentinel100", 100, 8)):
        Xb = points(m, m)
        rngb = np.random.default_rng(m + 1)
        V = rngb.normal(size=(m, 6)).astype(np.float32)
        cidx = np.array([1, m // 2, m - 1])
        K = op(Xb)
        a, b = K.sweep([sw.MatmulPlan(jnp.asarray(V)),
                        sw.ColumnGatherPlan(jnp.asarray(cidx))],
                       block_size=bs, mesh=MESH)
        put(name, X=Xb, V=V, cidx=cidx, bs=-1 if bs is None else bs,
            KV=a, KC=b)
        meter(name, K)

    K = op(X, use_pallas=False)
    (res, fro), colnorms, gram = K.sweep(
        [sw.ResidualFroPlan(jnp.asarray(Cp), jnp.asarray(Mp)),
         sw.ProjResidualColNormPlan(jnp.asarray(Q)), sw.GramPlan(n)],
        block_size=64, mesh=MESH)
    put("panel", res=res, fro=fro, colnorms=colnorms, gram=gram)
    meter("panel", K)

    K = op(X, use_pallas=False)
    idx0 = np.array([3, 50, 100, 150, 200, 250])
    put("resnorms", idx=idx0,
        norms=residual_column_norms(K, jnp.asarray(idx0), mesh=MESH))
    meter("resnorms", K)
    put("gramlev",
        lev=row_leverage_scores_gram(jnp.asarray(Cp), 64, mesh=MESH),
        levc=column_leverage_scores_gram(jnp.asarray(Mp), 64, mesh=MESH))
    K = op(X, use_pallas=False)
    uniform_adaptive2_indices(K, jax.random.PRNGKey(4), 12, mesh=MESH)
    meter("adaptive2", K)
    K = op(X, use_pallas=False)
    get_policy("leverage").select(K, jax.random.PRNGKey(4), 12, mesh=MESH)
    meter("leverage", K)
else:
    key = jax.random.PRNGKey(0)
    ks = jax.random.split(key)[1]
    S = jsk.GaussianSketch(ks, n, 80)._mat()
    K = op(X)
    ap = spsd.fast_model(K, key, c=20, s=80, s_sketch="gaussian",
                         streaming=True, mesh=MESH)
    put("fast_model", idx=ap.P_indices, S=S, C=ap.C, U=ap.U)
    meter("fast_model", K)

    K = op(X)
    ap2, err = spsd.fast_model_with_error(K, key, c=20, s=80, probes=32,
                                          mesh=MESH)
    Z = jax.random.rademacher(jax.random.fold_in(key, 777), (n, 32),
                              dtype=jnp.float32)
    put("with_error", idx=ap2.P_indices, S=S, Z=Z, C=ap2.C, U=ap2.U,
        err=err)
    meter("with_error", K)

    K = op(X)
    put("blocked", err=spsd.relative_error(K, ap, method="blocked",
                                           mesh=MESH))
    meter("blocked", K)
    K = op(X)
    k1 = jax.random.PRNGKey(1)
    eh = spsd.relative_error(K, ap, method="hutchinson", probes=32, key=k1,
                             mesh=MESH)
    put("hutchinson", err=eh,
        Z=jax.random.rademacher(k1, (n, 32), dtype=jnp.float32))
    meter("hutchinson", K)

    for kind in ("gaussian", "leverage"):
        K = op(X)
        k3 = jax.random.PRNGKey(3)
        apc = cur.fast_cur(K, k3, c=12, r=12, sc=48, sr=48,
                           sketch_kind=kind, mesh=MESH)
        _, kc, kr = jax.random.split(k3, 3)
        draws = dict(cidx=apc.col_indices, ridx=apc.row_indices, C=apc.C,
                     R=apc.R, U=apc.U)
        if kind == "gaussian":
            draws.update(Sc=jsk.GaussianSketch(kc, n, 48)._mat(),
                         Sr=jsk.GaussianSketch(kr, n, 48)._mat())
        else:
            Sc = jsk.leverage_column_sketch(
                kc, row_leverage_scores_gram(apc.C, 1024, mesh=MESH), 48)
            Sr = jsk.leverage_column_sketch(
                kr, column_leverage_scores_gram(apc.R, 1024, mesh=MESH), 48)
            draws.update(Sc_idx=Sc.indices, Sc_scales=Sc.scales,
                         Sr_idx=Sr.indices, Sr_scales=Sr.scales)
        put("cur_" + kind, **draws)
        meter("cur_" + kind, K)

    K = op(X)
    k5 = jax.random.PRNGKey(5)
    e = eig.streaming_subspace_eigh(K, 4, key=k5, power_iters=2, mesh=MESH)
    put("eigh", Omega=jax.random.normal(k5, (n, 12), jnp.float32),
        lam=e.eigenvalues, vecs=e.eigenvectors)
    meter("eigh", K)

np.savez(sys.argv[1], **out)
'''


# ---------------------------------------------------------------------------
# the port's ranks
# ---------------------------------------------------------------------------

def _op(X):
    return CountingOperator(PairwiseKernel(X, tspecs.rbf(2.0), device="cpu"))


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _port_cases(ref: dict, mesh) -> dict:
    """The reference's calls on the port, with the reference's inputs and
    draws; returns results and meters under the reference's keys."""
    out = {}

    def meter(name, K):
        out[name + "/counts"] = np.array([K.counts[k] for k in COUNT_KEYS])
        out[name + "/route"] = np.array(str(K.last_route))
        out[name + "/slab"] = np.array(str(K.last_slab_mode))

    def put(name, **arrays):
        for k, v in arrays.items():
            out[f"{name}/{k}"] = v.numpy() if isinstance(v, torch.Tensor) \
                else np.asarray(v)

    for name in BUNDLES:
        K = _op(ref[f"{name}/X"])
        bs = int(ref[f"{name}/bs"])
        bs = None if bs < 0 else bs

        def plans():
            return [tsweep.MatmulPlan(_t(ref[f"{name}/V"])),
                    tsweep.ColumnGatherPlan(_t(ref[f"{name}/cidx"],
                                               torch.int64))]

        a, b = K.sweep(plans(), block_size=bs, mesh=mesh)
        put(name, KV=a, KC=b)
        meter(name, K)
        a1, b1 = K.inner.sweep(plans(), block_size=bs)
        put(name, equals_local=np.array(torch.equal(a, a1)
                                        and torch.equal(b, b1)))

    X = ref["X"]
    n = X.shape[0]
    K = _op(X)
    (res, fro), colnorms, gram = K.sweep(
        [tsweep.ResidualFroPlan(_t(ref["Cp"]), _t(ref["Mp"])),
         tsweep.ProjResidualColNormPlan(_t(ref["Q"])), tsweep.GramPlan(n)],
        block_size=64, mesh=mesh)
    put("panel", res=res, fro=fro, colnorms=colnorms, gram=gram)
    meter("panel", K)

    K = _op(X)
    put("resnorms", norms=residual_column_norms(
        K, _t(ref["resnorms/idx"], torch.int64), mesh=mesh))
    meter("resnorms", K)
    put("gramlev", lev=row_leverage_scores_gram(_t(ref["Cp"]), 64, mesh=mesh),
        levc=column_leverage_scores_gram(_t(ref["Mp"]), 64, mesh=mesh))
    K = _op(X)
    uniform_adaptive2_indices(K, 12, generator=torch.Generator().manual_seed(4),
                              mesh=mesh)
    meter("adaptive2", K)
    K = _op(X)
    get_policy("leverage").select(
        K, 12, generator=torch.Generator().manual_seed(4), mesh=mesh)
    meter("leverage", K)

    K = _op(X)
    ap = tsp.fast_model(K, 20, 80, s_sketch="gaussian", streaming=True,
                        idx=ref["fast_model/idx"], S=ref["fast_model/S"],
                        mesh=mesh)
    put("fast_model", C=ap.C, U=ap.U)
    meter("fast_model", K)
    K = _op(X)
    ap2, err = tsp.fast_model_with_error(
        K, 20, 80, probes=32, idx=ref["with_error/idx"],
        S=ref["with_error/S"], Z=ref["with_error/Z"], mesh=mesh)
    put("with_error", C=ap2.C, U=ap2.U, err=err)
    meter("with_error", K)
    approx = convert.approx_from_reference(
        ref["fast_model/C"], ref["fast_model/U"], ref["fast_model/idx"],
        device="cpu")
    K = _op(X)
    put("blocked", err=tsp.relative_error(K, approx, method="blocked",
                                          mesh=mesh))
    meter("blocked", K)
    K = _op(X)
    put("hutchinson", err=tsp.relative_error(
        K, approx, method="hutchinson", Z=ref["hutchinson/Z"], mesh=mesh))
    meter("hutchinson", K)

    for kind in ("gaussian", "leverage"):
        p = f"cur_{kind}/"
        if kind == "gaussian":
            Sc = tsk.GaussianSketch(_t(ref[p + "Sc"]))
            Sr = tsk.GaussianSketch(_t(ref[p + "Sr"]))
        else:
            Sc = (ref[p + "Sc_idx"], ref[p + "Sc_scales"])
            Sr = (ref[p + "Sr_idx"], ref[p + "Sr_scales"])
        K = _op(X)
        apc = tcur.fast_cur(K, 12, 12, 48, 48, sketch_kind=kind, mesh=mesh,
                            cidx=ref[p + "cidx"], ridx=ref[p + "ridx"],
                            Sc=Sc, Sr=Sr)
        put("cur_" + kind, C=apc.C, R=apc.R, U=apc.U)
        meter("cur_" + kind, K)

    K = _op(X)
    e = teig.streaming_subspace_eigh(K, 4, power_iters=2, mesh=mesh,
                                     Omega=ref["eigh/Omega"])
    put("eigh", lam=e.eigenvalues, vecs=e.eigenvectors)
    meter("eigh", K)
    return out


def _fallbacks(ref: dict, mesh) -> dict:
    """Meshes of data width 1 take the single-device route; a ("pod",
    "data") mesh, in either dim order, gives the ("data",) mesh's result."""
    from torch.distributed.device_mesh import init_device_mesh
    X, V = ref["bundle533/X"], _t(ref["bundle533/V"])
    K = _op(X)
    one_wide = init_device_mesh("cpu", (WORLD, 1),
                                mesh_dim_names=("model", "data"))
    model_only = init_device_mesh("cpu", (WORLD,),
                                  mesh_dim_names=("model",))
    local = K.matmat(V, block_size=64)
    out = {"fallback/sizes": np.array([
        tsweep.mesh_data_size(None), tsweep.mesh_data_size(one_wide),
        tsweep.mesh_data_size(model_only), tsweep.mesh_data_size(mesh)])}
    equal = []
    for m in (one_wide, model_only):
        got = K.matmat(V, block_size=64, mesh=m)
        equal.append(torch.equal(got, local) and K.last_route == "fused")
    out["fallback/equal"] = np.array(equal)
    wide = K.matmat(V, mesh=mesh)
    shards, same = [], []
    for names in (("pod", "data"), ("data", "pod")):
        pd = init_device_mesh("cpu", (2, 2), mesh_dim_names=names)
        shards.append(sharding.shard_index(pd))
        got = K.matmat(V, mesh=pd)
        same.append(torch.equal(got, wide)
                    and K.last_route == "fused_sharded")
    out["podmesh/shards"] = np.array(shards + [sharding.shard_index(mesh)])
    out["podmesh/equal"] = np.array(same)
    return out


def _port_rank(rank: int, world: int, d: str) -> None:
    torch.set_num_threads(1)
    torch.exp(torch.zeros(64))    # see test_torch_spsd.py
    dist.init_process_group("gloo", init_method=f"file://{d}/store",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        ref = dict(np.load(os.path.join(d, "ref.npz")))
        mesh = sharding.data_parallel_mesh("cpu")
        out = _port_cases(ref, mesh)
        out.update(_fallbacks(ref, mesh))
        np.savez(os.path.join(d, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("reference")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(REPO / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, str(d / f"{part}.npz"), part],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for part in ("A", "B")]
    ref = {}
    for part, proc in zip(("A", "B"), procs):
        stdout, stderr = proc.communicate(timeout=420)
        assert proc.returncode == 0, stdout + "\n" + stderr
        ref.update(dict(np.load(d / f"{part}.npz")))
    return ref


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    d = tmp_path_factory.mktemp("ranks")
    np.savez(d / "ref.npz", **reference)
    mp.spawn(_port_rank, args=(WORLD, str(d)), nprocs=WORLD, join=True)
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def port(ranks):
    return ranks[0]


def scaled(port, ref) -> float:
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


def misalignment(U, V) -> float:
    return float(teig.misalignment(_t(U).double(), _t(V).double()))


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", METERED)
def test_routes_and_meters_match(reference, port, case):
    assert port[case + "/counts"].tolist() == \
        reference[case + "/counts"].tolist()
    assert str(port[case + "/route"]) == \
        str(reference[case + "/route"]).replace("pallas_", "")
    assert str(port[case + "/slab"]) == str(reference[case + "/slab"])


def test_fused_routes_claim_a_prefetch_slab(port):
    """The fused cases ride 'fused_sharded' with the in-launch slab, and the
    n = 100 sweep counts its sentinel panel: 16 panels of 7 rows."""
    for case in BUNDLES + ("fast_model", "with_error", "hutchinson",
                           "cur_gaussian", "eigh"):
        assert str(port[case + "/route"]) == "fused_sharded", case
        assert str(port[case + "/slab"]) == "prefetch", case
    sweeps, panels, entries = port["sentinel100/counts"][:3]
    assert (sweeps, panels, entries) == (1, 16, 16 * 7 * 100)
    assert entries == WORLD * tsweep.local_slab_rows(100, 100, 8, WORLD) * 100
    for case in ("panel", "blocked", "resnorms", "adaptive2"):
        assert str(port[case + "/route"]) == "panel", case


@pytest.mark.parametrize("case", BUNDLES)
def test_fused_bundles_match(reference, port, case):
    assert scaled(port[case + "/KV"], reference[case + "/KV"]) <= 1e-5
    assert scaled(port[case + "/KC"], reference[case + "/KC"]) <= 1e-5


def test_panel_route_plans_match(reference, port):
    assert abs(float(port["panel/res"]) / float(reference["panel/res"])
               - 1) <= 1e-5
    assert abs(float(port["panel/fro"]) / float(reference["panel/fro"])
               - 1) <= 1e-5
    assert scaled(port["panel/colnorms"], reference["panel/colnorms"]) <= 1e-4
    assert scaled(port["panel/gram"], reference["panel/gram"]) <= 1e-5


def test_models_and_metrics_match(reference, port):
    assert scaled(port["fast_model/C"], reference["fast_model/C"]) <= 1e-5
    assert scaled(port["fast_model/U"], reference["fast_model/U"]) <= 1e-4
    assert scaled(port["with_error/C"], reference["with_error/C"]) <= 1e-5
    assert scaled(port["with_error/U"], reference["with_error/U"]) <= 1e-4
    for case in ("with_error", "blocked", "hutchinson"):
        assert abs(float(port[case + "/err"])
                   - float(reference[case + "/err"])) <= 1e-5, case


def test_selection_statistics_match(reference, port):
    assert scaled(port["resnorms/norms"], reference["resnorms/norms"]) <= 1e-4
    assert scaled(port["gramlev/lev"], reference["gramlev/lev"]) <= 1e-4
    assert scaled(port["gramlev/levc"], reference["gramlev/levc"]) <= 1e-4


@pytest.mark.parametrize("kind", ["gaussian", "leverage"])
def test_fast_cur_matches(reference, port, kind):
    p = f"cur_{kind}/"
    assert scaled(port[p + "C"], reference[p + "C"]) <= 1e-5
    assert scaled(port[p + "R"], reference[p + "R"]) <= 1e-5
    assert scaled(port[p + "U"], reference[p + "U"]) <= 1e-4


def test_streaming_subspace_eigh_matches(reference, port):
    lam, lam_ref = port["eigh/lam"], reference["eigh/lam"]
    assert float(np.max(np.abs(lam - lam_ref) / np.abs(lam_ref))) <= 1e-5
    assert misalignment(reference["eigh/vecs"], port["eigh/vecs"]) <= 1e-4


# ---------------------------------------------------------------------------
# the port on its own
# ---------------------------------------------------------------------------

def test_every_rank_returns_the_same_result(ranks):
    for other in ranks[1:]:
        for k, v in ranks[0].items():
            if k.startswith("podmesh/shards"):
                continue
            assert np.array_equal(other[k], v), k


@pytest.mark.parametrize("case", BUNDLES)
def test_sharded_fused_route_equals_the_single_device_one(port, case):
    """Each row comes from exactly one rank and the others add exact
    zeros, so the all-reduced carries equal the local sweep bit for bit."""
    assert bool(port[case + "/equals_local"])


def test_trivial_meshes_fall_back(port):
    assert port["fallback/sizes"].tolist() == [1, 1, 1, WORLD]
    assert port["fallback/equal"].tolist() == [True, True]


def test_pod_data_mesh_matches_the_data_mesh(ranks):
    assert all(r["podmesh/equal"].tolist() == [True, True] for r in ranks)
    shards = np.array([r["podmesh/shards"] for r in ranks])
    # ("pod", "data") and ("data",): rank r is shard r (pod outer); with
    # the dims listed ("data", "pod") the order is still pod-major
    assert shards[:, 0].tolist() == list(range(WORLD))
    assert shards[:, 2].tolist() == list(range(WORLD))
    assert shards[:, 1].tolist() == [0, 2, 1, 3]
