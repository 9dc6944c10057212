"""The port's slice as a whole held against the JAX reference (CPU).

The reference runs its fused Pallas sweep in interpret mode
(``use_pallas=True``).  Its random draws are recovered from its keys —
``idx`` from ``P_indices``, the Gaussian sketch from
``GaussianSketch(split(key)[1], n, s)._mat()``, the probes from the
``fold_in(key, 777)`` Rademacher draw, the leverage sketch by redrawing it
from the same key and scores — and handed to the port as numpy arrays.

Tolerances: C, KS and SᵀKS ≤ 1e-5 scale-normalized; U and C U Cᵀ ≤ 1e-4
scale-normalized (two SVD implementations: torch's and JAX's differ by
~2e-6 here); relative errors ≤ 1e-5 absolute.  ``CountingOperator`` counts
must be identical, with the route names mapped by dropping ``pallas_``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import leverage as jlev
from repro.core import sketch as jsk
from repro.core import spsd as jsp
from repro.core import sweep as jsweep
from repro.core.instrument import CountingOperator as JCounting
from repro.core.kernelop import DenseSPSD as JDense
from repro.core.kernelop import LinearKernel as JLinear
from repro.core.kernelop import PairwiseKernel as JPairwise
from repro.kernels.pairwise import specs as jspecs
from repro_torch import convert
from repro_torch.core import leverage as tlev
from repro_torch.core import selection as tsel
from repro_torch.core import sketch as tsk
from repro_torch.core import spsd as tsp
from repro_torch.core import sweep as tsweep
from repro_torch.core.instrument import CountingOperator as TCounting
from repro_torch.core.kernelop import DenseSPSD as TDense
from repro_torch.core.kernelop import LinearKernel as TLinear
from repro_torch.core.kernelop import PairwiseKernel as TPairwise

N, D, C, S, PROBES = 300, 8, 16, 64, 64
SIGMA = 2.0
KEY = jax.random.PRNGKey(0)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Six test workers share the CPU: keep torch's intra-op pool small.
    The first multi-threaded ``torch.exp`` of a process can come out ~1e-4
    off (seen with torch 2.13 CPU builds: a lazy-initialization race); one
    small call first makes every later one exact."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    torch.exp(torch.zeros(64))
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def X():
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(6, D)) * 2.0
    labels = rng.integers(0, 6, size=N)
    return (centers[labels] + rng.normal(size=(N, D)) * 0.7).astype(
        np.float32)


def jop(X, prec="f32", use_pallas=True, name="rbf", params=None):
    spec = jspecs.get_spec(name, **(params or {"sigma": SIGMA}))
    return JCounting(JPairwise(jnp.asarray(X), spec.with_precision(prec),
                               use_pallas=use_pallas))


def top(X, prec="f32", use_kernel=True, name="rbf", params=None):
    return TCounting(convert.operator_from_reference(
        X, name, params or {"sigma": SIGMA}, precision=prec, device="cpu",
        use_kernel=use_kernel))


def np_(a) -> np.ndarray:
    return np.array(a)


def scaled(port, ref) -> float:
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


def port_route(jax_route: str) -> str:
    """The documented mapping of route names (``repro_torch.core.sweep``)."""
    return jax_route.replace("pallas_", "")


def assert_same_meter(t: TCounting, j: JCounting):
    assert t.counts == j.counts
    assert t.last_route == port_route(j.last_route)
    assert t.last_precision == j.last_precision


def gaussian_draws(key=KEY, n=N, s=S, probes=PROBES):
    ks = jax.random.split(key)[1]
    Smat = np_(jsk.GaussianSketch(ks, n, s)._mat())
    Z = np_(jax.random.rademacher(jax.random.fold_in(key, 777),
                                  (n, probes), dtype=jnp.float32))
    return Smat, Z


def leverage_draw(C, key=KEY, s=S):
    ks = jax.random.split(key)[1]
    base = jsk.leverage_column_sketch(ks, jlev.row_leverage_scores(C), s)
    return np_(base.indices), np_(base.scales)


@pytest.fixture(scope="module")
def gaussian_run(X):
    """The fused main path on both sides: fast_model_with_error (gaussian)."""
    Kj, Kt = jop(X), top(X)
    apj, errj = jsp.fast_model_with_error(Kj, KEY, C, S, s_sketch="gaussian")
    Smat, Z = gaussian_draws()
    idx = np_(apj.P_indices)
    apt, errt = tsp.fast_model_with_error(Kt, C, S, s_sketch="gaussian",
                                          idx=idx, S=Smat, Z=Z)
    return dict(Kj=Kj, Kt=Kt, apj=apj, errj=errj, apt=apt, errt=errt,
                idx=idx, Smat=Smat, Z=Z)


# ---------------------------------------------------------------------------
# the fused sweep and the fast model
# ---------------------------------------------------------------------------

def test_fused_sweep_outputs_match(X, gaussian_run):
    r = gaussian_run
    Kj, Kt = jop(X), top(X)
    Cj, KSj = Kj.sweep([jsweep.ColumnGatherPlan(jnp.asarray(r["idx"])),
                        jsweep.MatmulPlan(jnp.asarray(r["Smat"]))])
    Ct, KSt = Kt.sweep([tsweep.ColumnGatherPlan(torch.from_numpy(r["idx"])),
                        tsweep.MatmulPlan(torch.from_numpy(r["Smat"]))])
    assert scaled(Ct, Cj) <= 1e-5
    assert scaled(KSt, KSj) <= 1e-5
    StKS_j = r["Smat"].T @ np.asarray(KSj)
    assert scaled(torch.from_numpy(r["Smat"]).T @ KSt, StKS_j) <= 1e-5
    assert_same_meter(Kt, Kj)
    assert Kt.last_route == "fused"


def test_fast_model_with_error_matches(gaussian_run):
    r = gaussian_run
    assert scaled(r["apt"].C, r["apj"].C) <= 1e-5
    assert scaled(r["apt"].U, r["apj"].U) <= 1e-4
    assert scaled(r["apt"].dense(), r["apj"].dense()) <= 1e-4
    assert abs(float(r["errt"]) - float(r["errj"])) <= 1e-5
    np.testing.assert_array_equal(np_(r["apt"].P_indices), r["idx"])


def test_fast_model_with_error_is_one_sweep(gaussian_run):
    """Model + error: exactly one sweep of nblocks·b·n entries, on the
    fused route, on both sides."""
    Kj, Kt = gaussian_run["Kj"], gaussian_run["Kt"]
    assert_same_meter(Kt, Kj)
    b = tsweep.resolved_block_size(N, N, None)
    assert Kt.counts["sweeps"] == 1 and Kt.counts["fused_sweeps"] == 1
    assert Kt.counts["entries"] == -(-N // b) * b * N


def test_fast_model_gaussian_matches(X):
    Kj, Kt = jop(X), top(X)
    apj = jsp.fast_model(Kj, KEY, C, S, s_sketch="gaussian")
    Smat, _ = gaussian_draws()
    apt = tsp.fast_model(Kt, C, S, s_sketch="gaussian",
                         idx=np_(apj.P_indices), S=Smat)
    assert scaled(apt.C, apj.C) <= 1e-5
    assert scaled(apt.U, apj.U) <= 1e-4
    assert scaled(apt.dense(), apj.dense()) <= 1e-4
    assert_same_meter(Kt, Kj)


def test_fast_model_leverage_matches(X):
    """The default column sketch: C through the block kernel, SᵀKS an
    explicit (s + c)² block; no sweep on either side."""
    Kj, Kt = jop(X), top(X)
    apj = jsp.fast_model(Kj, KEY, C, S)
    indices, scales = leverage_draw(apj.C)
    apt = tsp.fast_model(Kt, C, S, idx=np_(apj.P_indices),
                         S=(indices, scales))
    assert scaled(apt.C, apj.C) <= 1e-5
    assert scaled(apt.U, apj.U) <= 1e-4
    assert scaled(apt.dense(), apj.dense()) <= 1e-4
    assert Kt.counts == Kj.counts
    assert Kt.counts["columns"] == 1 and Kt.counts["blocks"] == 1
    assert Kt.counts["entries"] == N * C + (S + C) ** 2


def test_fast_model_with_error_leverage_matches(X):
    Kj, Kt = jop(X), top(X)
    apj, errj = jsp.fast_model_with_error(Kj, KEY, C, S, s_sketch="leverage")
    _, Z = gaussian_draws()
    indices, scales = leverage_draw(apj.C)
    apt, errt = tsp.fast_model_with_error(
        Kt, C, S, s_sketch="leverage", idx=np_(apj.P_indices),
        S=(indices, scales), Z=Z)
    assert scaled(apt.U, apj.U) <= 1e-4
    assert abs(float(errt) - float(errj)) <= 1e-5
    assert_same_meter(Kt, Kj)


@pytest.mark.parametrize("method", ["dense", "blocked", "hutchinson"])
def test_relative_error_matches(X, gaussian_run, method):
    apj = gaussian_run["apj"]
    Kj, Kt = jop(X), top(X)
    key = jax.random.PRNGKey(3)
    ej = jsp.relative_error(Kj, apj, method=method, key=key)
    Z = np_(jax.random.rademacher(key, (N, PROBES), dtype=jnp.float32))
    at = convert.approx_from_reference(apj.C, apj.U, apj.P_indices,
                                       device="cpu")
    et = tsp.relative_error(Kt, at, method=method, Z=Z)
    assert abs(float(et) - float(ej)) <= 1e-5
    assert Kt.counts == Kj.counts
    if method != "dense":
        assert_same_meter(Kt, Kj)


def test_counts_with_clamped_tail_panel(X, gaussian_run):
    """block_size=128 at n=300: 3 panels, the last one clamp-padded — the
    reference counts the padding and so does the port."""
    r = gaussian_run
    Kj, Kt = jop(X), top(X)
    jsp.fast_model_with_error(Kj, KEY, C, S, s_sketch="gaussian",
                              block_size=128)
    tsp.fast_model_with_error(Kt, C, S, s_sketch="gaussian", block_size=128,
                              idx=r["idx"], S=r["Smat"], Z=r["Z"])
    jsp.relative_error(Kj, r["apj"], method="blocked", block_size=128)
    at = convert.approx_from_reference(r["apj"].C, r["apj"].U, device="cpu")
    tsp.relative_error(Kt, at, method="blocked", block_size=128)
    assert Kt.counts == Kj.counts
    assert Kt.counts["panels"] == 2 * 3 and \
        Kt.counts["entries"] == 2 * 3 * 128 * N
    assert_same_meter(Kt, Kj)


def test_panel_route_without_the_fused_kernel(X, gaussian_run):
    r = gaussian_run
    Kj, Kt = jop(X, use_pallas=False), top(X, use_kernel=False)
    apj, errj = jsp.fast_model_with_error(Kj, KEY, C, S, s_sketch="gaussian")
    apt, errt = tsp.fast_model_with_error(Kt, C, S, s_sketch="gaussian",
                                          idx=r["idx"], S=r["Smat"],
                                          Z=r["Z"])
    assert Kt.last_route == "panel" == Kj.last_route
    assert_same_meter(Kt, Kj)
    assert scaled(apt.C, apj.C) <= 1e-5
    assert abs(float(errt) - float(errj)) <= 1e-5


def test_bf16_policy_route_and_meter(X, gaussian_run):
    r = gaussian_run
    Kj, Kt = jop(X, prec="bf16_f32acc"), top(X, prec="bf16_f32acc")
    apj, errj = jsp.fast_model_with_error(Kj, KEY, C, S, s_sketch="gaussian")
    apt, errt = tsp.fast_model_with_error(Kt, C, S, s_sketch="gaussian",
                                          idx=r["idx"], S=r["Smat"],
                                          Z=r["Z"])
    assert Kt.last_route == "fused+bf16_f32acc"
    assert_same_meter(Kt, Kj)
    assert Kt.counts["bf16_sweeps"] == 1
    assert scaled(apt.C, apj.C) <= 1e-2
    # the policy's own gate against the f32 run
    assert scaled(apt.C, r["apj"].C) <= 5e-2


def test_projection_sketch_through_the_panel_route(X, gaussian_run):
    """CountSketch (like SRHT) is not matmul-shaped: SᵀKS streams through
    the panel route (``SketchRightPlan``) on both sides."""
    r = gaussian_run
    Kj, Kt = jop(X), top(X)
    Cj = r["apj"].C
    apj = jsp.fast_model_from_C(Kj, Cj, KEY, S, s_sketch="countsketch")
    Sj = jsk.make_sketch("countsketch", KEY, N, S)
    St = tsk.CountSketch(torch.from_numpy(np_(Sj.hashes)).long(),
                         torch.from_numpy(np_(Sj.signs)), S)
    apt = tsp.fast_model_from_C(Kt, torch.from_numpy(np_(Cj)), S,
                                s_sketch="countsketch", S=St)
    assert scaled(apt.U, apj.U) <= 1e-4
    assert_same_meter(Kt, Kj)
    assert Kt.last_route == "panel"


def test_prototype_and_nystrom_models_match(X, gaussian_run):
    r = gaussian_run
    Kj, Kt = jop(X), top(X)
    Cj = r["apj"].C
    pj = jsp.prototype_model(Kj, Cj)
    pt = tsp.prototype_model(Kt, torch.from_numpy(np_(Cj)))
    assert scaled(pt.U, pj.U) <= 1e-4
    nj = jsp.nystrom_model(Kj, KEY, C)
    nt = tsp.nystrom_model(Kt, C, idx=np_(nj.P_indices))
    assert scaled(nt.C, nj.C) <= 1e-5
    assert scaled(nt.U, nj.U) <= 1e-4
    assert Kt.counts == Kj.counts


def test_streaming_topk_eigvals_match(X):
    Kj, Kt = jop(X), top(X)
    key = jax.random.PRNGKey(5)
    lj = jsp.streaming_topk_eigvals(Kj, 5, key)
    Omega = np_(jax.random.normal(key, (N, 13), dtype=jnp.float32))
    lt = tsp.streaming_topk_eigvals(Kt, 5, Omega=Omega)
    assert scaled(lt, lj) <= 1e-4
    assert Kt.counts == Kj.counts


@pytest.mark.parametrize("method", ["blocked", "hutchinson"])
def test_error_vs_best_rank_k_matches(X, gaussian_run, method):
    apj = gaussian_run["apj"]
    Kj, Kt = jop(X), top(X)
    key = jax.random.PRNGKey(7)
    ej = jsp.error_vs_best_rank_k(Kj, apj, 5, method=method, key=key)
    keig, kprobe = jax.random.split(key)
    Omega = np_(jax.random.normal(keig, (N, 13), dtype=jnp.float32))
    Z = np_(jax.random.rademacher(kprobe, (N, PROBES), dtype=jnp.float32))
    at = convert.approx_from_reference(apj.C, apj.U, device="cpu")
    et = tsp.error_vs_best_rank_k(Kt, at, 5, method=method, Omega=Omega, Z=Z)
    assert abs(float(et) - float(ej)) <= 1e-4 * abs(float(ej))
    assert Kt.counts == Kj.counts


def test_error_vs_best_rank_k_dense_matches(X, gaussian_run):
    apj = gaussian_run["apj"]
    ej = jsp.error_vs_best_rank_k(jop(X), apj, 5, method="dense")
    at = convert.approx_from_reference(apj.C, apj.U, device="cpu")
    et = tsp.error_vs_best_rank_k(top(X), at, 5, method="dense")
    assert abs(float(et) - float(ej)) <= 1e-4 * abs(float(ej))


# ---------------------------------------------------------------------------
# operators, sketches, leverage
# ---------------------------------------------------------------------------

def test_operator_protocol_matches(X):
    Kj, Kt = jop(X), top(X)
    rows = np.arange(0, N, 7)
    cols = np.arange(3, N, 11)
    assert scaled(Kt.block(rows, cols), Kj.block(jnp.asarray(rows),
                                                 jnp.asarray(cols))) <= 1e-5
    assert scaled(Kt.columns(cols), Kj.columns(jnp.asarray(cols))) <= 1e-5
    assert scaled(Kt.diag(), Kj.diag()) <= 1e-5
    V = np.linspace(-1, 1, N * 3, dtype=np.float32).reshape(N, 3)
    assert scaled(Kt.matmat(torch.from_numpy(V)),
                  Kj.matmat(jnp.asarray(V))) <= 1e-5
    assert scaled(Kt.frobenius_norm_sq(), Kj.frobenius_norm_sq()) <= 1e-5
    tsums = Kt.map_row_panels(lambda p, i, v: (p.sum(1) * v).sum(),
                              block_size=128)
    jsums = Kj.map_row_panels(lambda p, i, v: (p.sum(1) * v).sum(),
                              block_size=128)
    assert scaled(tsums, jsums) <= 1e-5
    assert Kt.counts == Kj.counts


def test_cross_matches_including_signsplit_route():
    rng = np.random.default_rng(4)
    Xl = rng.integers(0, 4, size=(200, D)).astype(np.float32)
    params = {"gamma": 0.3}
    Kj = jop(Xl, name="laplacian", params=params)
    Kt = top(Xl, name="laplacian", params=params)
    heads = [rng.normal(size=(200, 2)).astype(np.float32)]
    for Xq in (Xl[:9] + 0.0, Xl[:9] + 0.25):
        oj = Kj.cross(jnp.asarray(Xq), [jnp.asarray(h) for h in heads])
        ot = Kt.cross(torch.from_numpy(Xq), [torch.from_numpy(h)
                                             for h in heads])
        assert scaled(ot[0], oj[0]) <= 1e-5
        assert Kt.inner._last_cross_l1_route == Kj.inner._last_cross_l1_route
        assert_same_meter(Kt, Kj)
    assert Kt.inner.l1_route() == Kj.inner.l1_route() == "mxu_signsplit"


def test_linear_and_dense_operators_match(X):
    Lj, Lt = JLinear(jnp.asarray(X)), TLinear(X, device="cpu")
    cols = np.arange(0, N, 13)
    assert scaled(Lt.columns(cols), Lj.columns(jnp.asarray(cols))) <= 1e-5
    V = np.ones((N, 2), np.float32)
    assert scaled(Lt.matmat(torch.from_numpy(V)),
                  Lj.matmat(jnp.asarray(V))) <= 1e-5
    assert scaled(Lt.frobenius_norm_sq(), Lj.frobenius_norm_sq()) <= 1e-5
    K = np.asarray(JPairwise(jnp.asarray(X), jspecs.rbf(SIGMA)).full())
    Dj, Dt = JDense(jnp.asarray(K)), TDense(torch.from_numpy(np.array(K)))
    assert Dt.device == torch.device("cpu")
    apj = jsp.fast_model(Dj, KEY, C, S)
    indices, scales = leverage_draw(apj.C)
    apt = tsp.fast_model(Dt, C, S, idx=np_(apj.P_indices),
                         S=(indices, scales))
    assert scaled(apt.U, apj.U) <= 1e-4


@pytest.mark.parametrize("kind", ["srht", "countsketch"])
def test_sketch_products_match(kind):
    rng = np.random.default_rng(6)
    A = rng.normal(size=(50, 7)).astype(np.float32)
    K = A @ A.T
    mask = (np.arange(50) < 41).astype(np.float32)
    Sj = jsk.make_sketch(kind, jax.random.PRNGKey(9), 50, 12)
    if kind == "srht":
        St = tsk.SRHTSketch(torch.from_numpy(np_(Sj.signs)),
                            torch.from_numpy(np_(Sj.indices)).long(), 50)
    else:
        St = tsk.CountSketch(torch.from_numpy(np_(Sj.hashes)).long(),
                             torch.from_numpy(np_(Sj.signs)), 12)
    Mj = jsk.MaskedSketch(Sj, jnp.asarray(mask))
    Mt = tsk.MaskedSketch(St, torch.from_numpy(mask))

    @jax.jit
    def products(A, K):          # one compile instead of eager op-by-op
        return [f for s in (Sj, Mj)
                for f in (s.left(A), s.right(A.T), s.sym(K))]

    want = products(jnp.asarray(A), jnp.asarray(K))
    At, Kt = torch.from_numpy(A), torch.from_numpy(K)
    got = [f for s in (St, Mt) for f in (s.left(At), s.right(At.T),
                                         s.sym(Kt))]
    for g, w in zip(got, want):
        assert scaled(g, w) <= 1e-5
    x = rng.normal(size=(16, 3)).astype(np.float32)
    assert scaled(tsk.fwht(torch.from_numpy(x)), jsk.fwht(jnp.asarray(x))) \
        <= 1e-6


def test_pinv_and_leverage_scores_match():
    rng = np.random.default_rng(8)
    A = rng.normal(size=(60, 9)).astype(np.float32)
    A[:, 8] = A[:, 0] + A[:, 1]                      # rank deficient
    At = torch.from_numpy(A)
    assert scaled(tlev.pinv(At), jlev.pinv(jnp.asarray(A))) <= 1e-4
    lev = tlev.row_leverage_scores(At)
    assert scaled(lev, jlev.row_leverage_scores(jnp.asarray(A))) <= 1e-5
    assert float(lev.sum()) == pytest.approx(8.0, abs=1e-4)
    Q = tlev.orthonormal_basis(At)
    assert scaled(Q.T @ Q, np.eye(9, dtype=np.float32)) <= 1e-5


@pytest.mark.parametrize("plan", ["diag", "proj_residual", "gram",
                                  "row_quad_form"])
def test_panel_plans_match(X, gaussian_run, plan):
    """The plans no main-path call uses, through the panel route on both
    sides (block_size=128: three panels, the last clamp-padded)."""
    C = np_(gaussian_run["apj"].C)
    Q = np.linalg.qr(C)[0].astype(np.float32)
    mask = (np.arange(N) < 280).astype(np.float32)
    W = np.asarray(np.linspace(-1, 1, N * N, dtype=np.float32)
                   .reshape(N, N)[:C.shape[1], :C.shape[1]])
    make = {
        "diag": (lambda m: m.DiagPlan(), None),
        "proj_residual": (lambda m: m.ProjResidualColNormPlan(
            *((jnp.asarray(Q), jnp.asarray(mask)) if m is jsweep else
              (torch.from_numpy(Q), torch.from_numpy(mask)))), None),
        "gram": (lambda m: m.GramPlan(C.shape[1]), C),
        "row_quad_form": (lambda m: m.RowQuadFormPlan(
            jnp.asarray(W) if m is jsweep else torch.from_numpy(W)), C),
    }
    mk, panel_src = make[plan]
    if panel_src is None:
        Kj, Kt = jop(X), top(X)
        (got,) = Kt.sweep([mk(tsweep)], block_size=128)
        (want,) = Kj.sweep([mk(jsweep)], block_size=128)
        assert Kt.counts == Kj.counts
    else:
        Pj, Pt = jnp.asarray(panel_src), torch.from_numpy(panel_src)
        (got,) = tsweep.sweep_panels(lambda i: Pt[i], N, C.shape[1],
                                     [mk(tsweep)], block_size=128)
        (want,) = jsweep.sweep_panels(lambda i: jnp.take(Pj, i, axis=0), N,
                                      C.shape[1], [mk(jsweep)],
                                      block_size=128)
    assert scaled(got, want) <= 1e-5


# ---------------------------------------------------------------------------
# the port's own draws
# ---------------------------------------------------------------------------

def test_generator_draws_are_reproducible(X):
    Kt = top(X)
    a1 = tsp.fast_model(Kt, C, S, s_sketch="gaussian",
                        generator=torch.Generator().manual_seed(11))
    a2 = tsp.fast_model(Kt, C, S, s_sketch="gaussian",
                        generator=torch.Generator().manual_seed(11))
    assert torch.equal(a1.U, a2.U) and torch.equal(a1.P_indices,
                                                   a2.P_indices)
    d1, d2 = tsp.fast_model(Kt, C, S), tsp.fast_model(Kt, C, S)
    assert torch.equal(d1.U, d2.U)                 # DEFAULT_SEED
    idx = tsel.get_policy("uniform").select(
        Kt, C, generator=torch.Generator().manual_seed(1))
    assert len(set(idx.tolist())) == C
    mask = (torch.arange(N) < 40).float()
    idx = tsel.get_policy("uniform").select(Kt, C, mask=mask)
    assert len(set(idx.tolist())) == C and int(idx.max()) < 40
    with pytest.raises(ValueError, match="unknown selection policy"):
        tsel.get_policy("no_such_policy")


def test_fast_model_masked_rows(X):
    """n_valid restricts every draw and product to the valid rows."""
    Kt = top(X)
    ap = tsp.fast_model(Kt, C, S, s_sketch="gaussian", n_valid=250,
                        generator=torch.Generator().manual_seed(2))
    assert int(ap.P_indices.max()) < 250
    assert float(ap.C[250:].abs().max()) == 0.0
    ap = tsp.fast_model(Kt, C, S, s_sketch="uniform", n_valid=250,
                        generator=torch.Generator().manual_seed(2))
    assert torch.isfinite(ap.U).all()


def test_convert_round_trip(X):
    Kt = convert.operator_from_reference(X, "rbf", {"sigma": SIGMA},
                                         device="cpu")
    assert isinstance(Kt, TPairwise) and Kt.spec.param("sigma") == SIGMA
    sk_g = convert.sketch_from_reference("gaussian", N, mat=np.ones((N, 4)),
                                         device="cpu")
    assert sk_g.s == 4 and sk_g.n == N
    sk_c = convert.sketch_from_reference("leverage", N, indices=[1, 2],
                                         scales=[1.0, 1.0], device="cpu")
    assert sk_c.s == 2 and sk_c.indices.dtype == torch.int64
    with pytest.raises(ValueError):
        convert.sketch_from_reference("srht", N, device="cpu")
