"""The port's CUR decomposition and eigensolvers held against the JAX
reference (CPU).

The reference's random draws are recovered from its keys (``fast_cur``:
``cidx``/``ridx`` from the returned indices, the sketches redrawn from
``split(key, 3)[1:]``; ``streaming_subspace_eigh``: ``normal(key, (n, q))``)
and handed to the port as numpy arrays.  The kernel operator runs the
reference's Pallas kernels in interpret mode.

Tolerances, scale-normalized: C, R and sketched products ≤ 1e-5; U and the
dense C U R ≤ 1e-4 (pinvs through two SVD implementations, as in
``test_torch_spsd.py``); relative errors ≤ 1e-5 absolute; eigenvalues
≤ 1e-5 relative; eigenvectors by subspace (``misalignment`` ≤ 1e-5) or, in
the KPCA features and the spectral embedding, after aligning each
column's sign, ≤ 1e-4.  Meters must be identical.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cur as jcur
from repro.core import eig as jeig
from repro.core import sketch as jsk
from repro.core import spsd as jsp
from repro.core.instrument import CountingOperator as JCounting
from repro.core.kernelop import PairwiseKernel as JPairwise
from repro.core.leverage import (column_leverage_scores_gram,
                                 row_leverage_scores, row_leverage_scores_gram)
from repro.kernels.pairwise import specs as jspecs
from repro_torch.core import cur as tcur
from repro_torch.core import eig as teig
from repro_torch.core import sketch as tsk
from repro_torch.core.instrument import CountingOperator as TCounting
from repro_torch.core.kernelop import PairwiseKernel as TPairwise
from repro_torch.kernels.pairwise import specs as tspecs

N, D, SIGMA = 240, 8, 2.0
M_ROWS, N_COLS = 120, 90
KINDS = ("uniform", "leverage", "gaussian", "srht", "countsketch")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Six test workers share the CPU (and warm ``torch.exp`` once, see
    test_torch_spsd.py)."""
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


@pytest.fixture(scope="module")
def A():
    """A rectangular matrix of low rank plus noise."""
    rng = np.random.default_rng(1)
    L = rng.normal(size=(M_ROWS, 6)) @ rng.normal(size=(6, N_COLS))
    return (L + 0.05 * rng.normal(size=(M_ROWS, N_COLS))).astype(np.float32)


def scaled(port, ref) -> float:
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


def jop(X):
    return JCounting(JPairwise(jnp.asarray(X), jspecs.rbf(SIGMA),
                               use_pallas=True))


def top(X):
    return TCounting(TPairwise(X, tspecs.rbf(SIGMA), device="cpu"))


def ref_sketches(kind, key, m, n, sc, sr, C, R, streaming, block_size):
    """The sketches ``fast_cur`` drew from ``key``, in the port's form."""
    _, kc, kr = jax.random.split(key, 3)
    if kind == "uniform":
        a = jsk.uniform_column_sketch(kc, m, sc, scale=False)
        b = jsk.uniform_column_sketch(kr, n, sr, scale=False)
    elif kind == "leverage":
        if streaming:
            lc = row_leverage_scores_gram(C, block_size)
            lr = column_leverage_scores_gram(R, block_size)
        else:
            lc, lr = row_leverage_scores(C), row_leverage_scores(R.T)
        a = jsk.leverage_column_sketch(kc, lc, sc)
        b = jsk.leverage_column_sketch(kr, lr, sr)
    else:
        a = jsk.make_sketch(kind, kc, m, sc)
        b = jsk.make_sketch(kind, kr, n, sr)
    return to_port(a), to_port(b)


def to_port(S):
    if isinstance(S, jsk.ColumnSketch):
        return (np.asarray(S.indices), np.asarray(S.scales))
    if isinstance(S, jsk.GaussianSketch):
        return tsk.GaussianSketch(torch.as_tensor(np.asarray(S._mat())))
    if isinstance(S, jsk.SRHTSketch):
        return tsk.SRHTSketch(torch.as_tensor(np.asarray(S.signs)),
                              torch.as_tensor(np.asarray(S.indices)), S.n)
    return tsk.CountSketch(torch.as_tensor(np.asarray(S.hashes)),
                           torch.as_tensor(np.asarray(S.signs)), S.s)


def assert_cur_matches(apt, apj, A=None):
    assert scaled(apt.C, apj.C) <= 1e-5
    assert scaled(apt.R, apj.R) <= 1e-5
    assert scaled(apt.U, apj.U) <= 1e-4
    assert scaled(apt.dense(), apj.dense()) <= 1e-4
    if A is not None:
        et = float(tcur.relative_error(torch.as_tensor(A), apt))
        ej = float(jcur.relative_error(jnp.asarray(A), apj))
        assert abs(et - ej) <= 1e-5


# ---------------------------------------------------------------------------
# CUR
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_fast_cur_dense_matches(A, kind, streaming):
    key = jax.random.PRNGKey(3)
    kw = dict(sketch_kind=kind, streaming=streaming, block_size=32)
    apj = jcur.fast_cur(jnp.asarray(A), key, 8, 10, 40, 36, **kw)
    Sc, Sr = ref_sketches(kind, key, M_ROWS, N_COLS, 40, 36, apj.C, apj.R,
                          streaming, 32)
    apt = tcur.fast_cur(torch.as_tensor(A), 8, 10, 40, 36, **kw,
                        cidx=np.asarray(apj.col_indices),
                        ridx=np.asarray(apj.row_indices), Sc=Sc, Sr=Sr)
    assert apt.col_indices.tolist() == np.asarray(apj.col_indices).tolist()
    assert_cur_matches(apt, apj, A)


@pytest.mark.parametrize("kind", ["uniform", "leverage", "gaussian"])
def test_fast_cur_on_a_kernel_operator_matches(X, kind):
    """Kernel CUR: C and R are gathered blocks, the Gaussian A S_R is one
    fused sweep; the meters agree."""
    key = jax.random.PRNGKey(4)
    Kj, Kt = jop(X), top(X)
    apj = jcur.fast_cur(Kj, key, 10, 10, 40, 40, sketch_kind=kind)
    Sc, Sr = ref_sketches(kind, key, N, N, 40, 40, apj.C, apj.R, True, 1024)
    apt = tcur.fast_cur(Kt, 10, 10, 40, 40, sketch_kind=kind,
                        cidx=np.asarray(apj.col_indices),
                        ridx=np.asarray(apj.row_indices), Sc=Sc, Sr=Sr)
    assert_cur_matches(apt, apj)
    assert Kt.counts == Kj.counts
    assert str(Kt.last_route) == str(Kj.last_route).replace("pallas_", "")


@pytest.mark.parametrize("selection", ["leverage", "uniform_adaptive2"])
def test_select_cur_sketches_meters_the_policy(X, selection):
    """The port's own draws: distinct indices and the reference's meter
    (the policy's pilot or adaptive sweeps, then the C and R panels)."""
    Kj, Kt = jop(X), top(X)
    jcur.select_cur_sketches(Kj, jax.random.PRNGKey(5), 12, 9,
                             selection=selection)
    C, R, cidx, ridx = tcur.select_cur_sketches(
        Kt, 12, 9, selection=selection,
        generator=torch.Generator().manual_seed(5))
    assert Kt.counts == Kj.counts
    assert len(set(cidx.tolist())) == 12 and len(set(ridx.tolist())) == 9
    assert tuple(C.shape) == (N, 12) and tuple(R.shape) == (9, N)
    assert torch.equal(C, Kt.inner.columns(cidx))


def test_select_cur_sketches_refuses_rectangular_policies(A):
    with pytest.raises(ValueError, match="square"):
        tcur.select_cur_sketches(torch.as_tensor(A), 4, 4,
                                 selection="leverage")


def test_optimal_cur_matches(A):
    key = jax.random.PRNGKey(6)
    apj = jcur.optimal_cur(jnp.asarray(A), key, 8, 10)
    apt = tcur.optimal_cur(torch.as_tensor(A), 8, 10,
                           cidx=np.asarray(apj.col_indices),
                           ridx=np.asarray(apj.row_indices))
    assert_cur_matches(apt, apj, A)


@pytest.mark.parametrize("kind", ["srht", "countsketch"])
def test_blocked_right_sketch_matches(kind):
    rng = np.random.default_rng(15)
    A = rng.normal(size=(413, 170)).astype(np.float32)
    S = jsk.make_sketch(kind, jax.random.PRNGKey(4), 170, 48)
    want = jcur.blocked_right_sketch(jnp.asarray(A), S, block_size=64)
    got = tcur.blocked_right_sketch(torch.as_tensor(A), to_port(S),
                                    block_size=64)
    assert scaled(got, want) <= 1e-5


def test_adaptive_row_indices(A):
    """The residual probabilities against an f64 computation, the
    reference's draw passed through, and the port's own draw on the rows
    with positive probability."""
    base = np.array([0, 5, 17, 40])
    p = tcur.adaptive_row_probabilities(torch.as_tensor(A), base).numpy()
    A64 = A.astype(np.float64)
    R1 = A64[base]
    resid = A64 - A64 @ np.linalg.pinv(R1) @ R1
    want = np.sum(resid * resid, axis=1)
    assert scaled(p, want / want.sum()) <= 1e-4
    jidx = np.asarray(jcur.adaptive_row_indices(
        jnp.asarray(A), jnp.asarray(base), jax.random.PRNGKey(7), 6))
    got = tcur.adaptive_row_indices(torch.as_tensor(A), base, 6,
                                    idx=jidx[4:])
    assert got.tolist() == jidx.tolist()
    own = tcur.adaptive_row_indices(
        torch.as_tensor(A), base, 30,
        generator=torch.Generator().manual_seed(7))
    assert own[:4].tolist() == base.tolist() and len(own) == 34
    assert np.all(p[own[4:].numpy()] > 0)


def test_drineas08_and_relative_error(A):
    rng = np.random.default_rng(8)
    cidx, ridx = rng.choice(N_COLS, 8, replace=False), \
        rng.choice(M_ROWS, 10, replace=False)
    Uj = jcur.drineas08_U(jnp.asarray(A), jnp.asarray(cidx),
                          jnp.asarray(ridx))
    Ut = tcur.drineas08_U(torch.as_tensor(A), cidx, ridx)
    assert scaled(Ut, Uj) <= 1e-4
    apj = jcur.CURApprox(jnp.asarray(A[:, cidx]), Uj, jnp.asarray(A[ridx]))
    apt = tcur.CURApprox(torch.as_tensor(A[:, cidx]), Ut,
                         torch.as_tensor(A[ridx]))
    assert abs(float(tcur.relative_error(torch.as_tensor(A), apt))
               - float(jcur.relative_error(jnp.asarray(A), apj))) <= 1e-5


# ---------------------------------------------------------------------------
# eigensolvers on C U Cᵀ and on the operator
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model(X):
    """A reference fast model (C, U) of the RBF kernel."""
    ap = jsp.fast_model(jop(X), jax.random.PRNGKey(0), 24, 96,
                        s_sketch="gaussian")
    return np.asarray(ap.C), np.asarray(ap.U)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def align_signs(got, want):
    """Flip each column of ``got`` to the sign of ``want``'s."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    signs = np.sign(np.sum(got * want, axis=0))
    return got * np.where(signs == 0, 1.0, signs)[None, :]


def test_approx_eigh_matches(model):
    C, U = model
    ej = jeig.approx_eigh(jnp.asarray(C), jnp.asarray(U), 5)
    et = teig.approx_eigh(_t(C), _t(U), 5)
    lam_j = np.asarray(ej.eigenvalues)
    assert float(np.max(np.abs(et.eigenvalues.numpy() - lam_j)
                        / np.abs(lam_j))) <= 1e-5
    assert float(teig.misalignment(_t(ej.eigenvectors),
                                   et.eigenvectors)) <= 1e-5
    assert float(teig.misalignment(et.eigenvectors, et.eigenvectors)) \
        <= 1e-6


def test_woodbury_solve_matches(model):
    C, U = model
    y = np.random.default_rng(9).normal(size=(N,)).astype(np.float32)
    want = jeig.woodbury_solve(jnp.asarray(C), jnp.asarray(U), 0.5,
                               jnp.asarray(y))
    got = teig.woodbury_solve(_t(C), _t(U), 0.5, _t(y))
    assert scaled(got, want) <= 1e-5
    for bad in (0.0, -1.0, float("nan"), float("inf")):
        with pytest.raises(ValueError, match="alpha"):
            teig.woodbury_solve(_t(C), _t(U), bad, _t(y))


def test_kpca_features_and_transform_match(model, X):
    C, U = model
    fj, ej = jeig.kpca_features(jnp.asarray(C), jnp.asarray(U), 4)
    ft, et = teig.kpca_features(_t(C), _t(U), 4)
    ft_aligned = align_signs(ft.numpy(), fj)
    assert scaled(ft_aligned, fj) <= 1e-4
    kx = np.asarray(JPairwise(jnp.asarray(X), jspecs.rbf(SIGMA)).columns(
        jnp.arange(7)))
    tj = np.asarray(jeig.kpca_transform(ej, jnp.asarray(kx)))
    tt = teig.kpca_transform(et, _t(kx)).numpy()
    signs = np.sign(np.sum(ft.numpy() * np.asarray(fj), axis=0))
    assert scaled(tt * signs[:, None], tj) <= 1e-4


def test_misalignment_matches(model):
    C, _ = model
    rng = np.random.default_rng(10)
    Ut = np.linalg.qr(rng.normal(size=(N, 4)))[0].astype(np.float32)
    Va = np.linalg.qr(C[:, :6])[0].astype(np.float32)
    want = float(jeig.misalignment(jnp.asarray(Ut), jnp.asarray(Va)))
    got = float(teig.misalignment(_t(Ut), _t(Va)))
    assert abs(got - want) <= 1e-6


@pytest.mark.parametrize("power_iters", [0, 3])
def test_streaming_subspace_eigh_matches(X, power_iters):
    key = jax.random.PRNGKey(11)
    Kj, Kt = jop(X), top(X)
    ej = jeig.streaming_subspace_eigh(Kj, 5, key=key,
                                      power_iters=power_iters)
    Omega = np.asarray(jax.random.normal(key, (N, 13), jnp.float32))
    et = teig.streaming_subspace_eigh(Kt, 5, power_iters=power_iters,
                                      Omega=Omega)
    lam_j = np.asarray(ej.eigenvalues)
    assert float(np.max(np.abs(et.eigenvalues.numpy() - lam_j)
                        / np.abs(lam_j))) <= 1e-5
    assert float(teig.misalignment(_t(ej.eigenvectors),
                                   et.eigenvectors)) <= 1e-5
    assert Kt.counts == Kj.counts
    assert Kt.counts["sweeps"] == power_iters + 2
    assert Kt.last_route == "fused"
    # the port's own draw, after the power iterations: the same leading
    # spectrum
    own = teig.streaming_subspace_eigh(
        Kt, 5, power_iters=3, generator=torch.Generator().manual_seed(1))
    assert tuple(own.eigenvectors.shape) == (N, 5)
    if power_iters == 3:
        assert float(np.max(np.abs(own.eigenvalues.numpy()[:2] - lam_j[:2])
                            / lam_j[:2])) <= 1e-3


@pytest.mark.parametrize("exact_degrees", [False, True])
def test_spectral_embedding_matches(model, X, exact_degrees):
    C, U = model
    deg = None
    if exact_degrees:
        deg = np.asarray(JPairwise(jnp.asarray(X), jspecs.rbf(SIGMA)).matmat(
            jnp.ones((N,), jnp.float32)))
    want = jeig.spectral_embedding(
        jnp.asarray(C), jnp.asarray(U), 3,
        degrees=None if deg is None else jnp.asarray(deg))
    got = teig.spectral_embedding(_t(C), _t(U), 3,
                                  degrees=None if deg is None else _t(deg))
    assert scaled(align_signs(got.numpy(), want), want) <= 1e-4
    norms = np.linalg.norm(got.numpy(), axis=1)
    assert np.allclose(norms, 1.0, atol=1e-5)
