"""The port's selection policies (CPU).

The deterministic parts are held against the JAX reference on the same
inputs and indices: ``residual_column_norms`` (one C gather and one
``ProjResidualColNorm`` sweep; the reference runs its Pallas kernels in
interpret mode) and the blocked-Gram leverage scores.  The random parts use
the port's own ``torch.Generator`` draws and are checked for what the
policies promise: distinct indices, masked and already-selected indices
never drawn, metered sweeps and gathers equal to the declared budget, and
the reference's attention error band for policy-chosen landmarks.

Tolerances, scale-normalized: residual norms ≤ 1e-4 (a difference
‖K e_j‖² − ‖Qᵀ K e_j‖² of two f32 sums, with two SVDs behind Q); leverage
scores ≤ 1e-4 (a pinv of the Gram); coherence ≤ 1e-5 relative.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cur as jcur
from repro.core import leverage as jlev
from repro.core import selection as jsel
from repro.core.kernelop import PairwiseKernel as JPairwise
from repro.kernels.pairwise import specs as jspecs
from repro_torch.core import adaptive as tadapt
from repro_torch.core import cur as tcur
from repro_torch.core import leverage as tlev
from repro_torch.core import selection as tsel
from repro_torch.core import sketched_attention as tsa
from repro_torch.core import sweep as tsweep
from repro_torch.core.instrument import CountingOperator
from repro_torch.core.kernelop import PairwiseKernel
from repro_torch.kernels.pairwise import specs as tspecs

N, D, SIGMA = 300, 8, 2.0


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Six test workers share the CPU: keep torch's intra-op pool small
    (and warm ``torch.exp`` once, see test_torch_spsd.py)."""
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


def scaled(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def top(X, counting=True):
    op = PairwiseKernel(X, tspecs.rbf(SIGMA), device="cpu")
    return CountingOperator(op) if counting else op


def gen(seed):
    return torch.Generator().manual_seed(seed)


# ---------------------------------------------------------------------------
# deterministic parts against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_residual_column_norms_match_reference(X, masked):
    idx = np.random.default_rng(1).choice(N, 20, replace=False)
    mask = (np.arange(N) < 250).astype(np.float32) if masked else None
    jop = JPairwise(jnp.asarray(X), jspecs.rbf(SIGMA))
    want = jsel.residual_column_norms(
        jop, jnp.asarray(idx), mask=None if mask is None
        else jnp.asarray(mask))
    got = tsel.residual_column_norms(
        top(X, counting=False), torch.as_tensor(idx),
        mask=None if mask is None else torch.as_tensor(mask))
    assert scaled(got.numpy(), want) <= 1e-4
    assert scaled(tadapt._residual_column_norms(
        top(X, counting=False), torch.as_tensor(idx)).numpy(),
        jsel.residual_column_norms(jop, jnp.asarray(idx))) <= 1e-4


@pytest.mark.parametrize("block_size", [None, 64])
def test_gram_leverage_scores_match_reference(block_size):
    rng = np.random.default_rng(2)
    A = (rng.normal(size=(300, 12)) @ rng.normal(size=(12, 20))).astype(
        np.float32)                                   # rank 12 of 20
    want = jlev.row_leverage_scores_gram(jnp.asarray(A),
                                         block_size=block_size)
    got = tlev.row_leverage_scores_gram(torch.as_tensor(A),
                                        block_size=block_size)
    assert scaled(got.numpy(), want) <= 1e-4
    assert abs(float(got.sum()) - 12.0) <= 1e-3
    R = np.ascontiguousarray(A.T)
    assert scaled(tlev.column_leverage_scores_gram(
        torch.as_tensor(R), block_size=block_size).numpy(),
        jlev.column_leverage_scores_gram(jnp.asarray(R),
                                         block_size=block_size)) <= 1e-4
    assert scaled(tlev.column_leverage_scores(torch.as_tensor(R)).numpy(),
                  jlev.column_leverage_scores(jnp.asarray(R))) <= 1e-4
    mu_t = float(tlev.row_coherence(torch.as_tensor(A)))
    mu_j = float(jlev.row_coherence(jnp.asarray(A)))
    assert abs(mu_t - mu_j) <= 1e-5 * mu_j


def test_cur_U_matrices_match_reference():
    rng = np.random.default_rng(3)
    A = rng.normal(size=(60, 40)).astype(np.float32)
    cidx, ridx = rng.choice(40, 8, replace=False), rng.choice(60, 10,
                                                              replace=False)
    C, R = A[:, cidx], A[ridx]
    At, Ct, Rt = (torch.as_tensor(x) for x in (A, C, R))
    assert scaled(tcur.optimal_U(At, Ct, Rt).numpy(),
                  jcur.optimal_U(jnp.asarray(A), jnp.asarray(C),
                                 jnp.asarray(R))) <= 1e-4
    assert scaled(tcur.drineas08_U(At, cidx, ridx).numpy(),
                  jcur.drineas08_U(jnp.asarray(A), jnp.asarray(cidx),
                                   jnp.asarray(ridx))) <= 1e-4
    sq, sr = rng.choice(60, 24, replace=False), rng.choice(40, 24,
                                                           replace=False)
    want = jcur.fast_U_cur(jnp.asarray(C[sq]), jnp.asarray(A[sq][:, sr]),
                           jnp.asarray(R[:, sr]))
    got = tcur.fast_U_cur(Ct[sq], At[sq][:, sr], Rt[:, sr])
    assert scaled(got.numpy(), want) <= 1e-4
    ap = tcur.CURApprox(Ct, got, Rt)
    assert tuple(ap.dense().shape) == (60, 40)


# ---------------------------------------------------------------------------
# the port's own draws
# ---------------------------------------------------------------------------

POLICIES = ("uniform", "leverage", "uniform_adaptive2")


@pytest.mark.parametrize("name", POLICIES)
def test_policies_draw_distinct_indices_within_budget(X, name):
    op = top(X)
    pol = tsel.get_policy(name)
    idx = pol.select(op, 24, generator=gen(0))
    assert idx.dtype == torch.int64 and len(set(idx.tolist())) == 24
    assert op.counts["sweeps"] == pol.sweep_budget()
    assert op.counts["columns"] == pol.gathers
    assert op.counts["fulls"] == 0
    b = tsweep.resolved_block_size(N, N, None)
    sweep_entries = pol.sweep_budget() * -(-N // b) * b * N
    if name == "uniform_adaptive2":            # C gathers of 8 then 16 cols
        assert op.counts["entries"] == sweep_entries + N * (8 + 16)
    if name == "leverage":                     # one pilot of max(2c, c+8)
        assert op.counts["entries"] == N * 48
    # the same generator state gives the same draw
    assert torch.equal(pol.select(top(X), 24, generator=gen(0)), idx)


@pytest.mark.parametrize("name", POLICIES)
def test_masked_rows_are_never_drawn(X, name):
    mask = torch.zeros(N)
    mask[::3] = 1.0                                   # 100 valid rows
    idx = tsel.get_policy(name).select(top(X), 24, generator=gen(1),
                                       mask=mask)
    assert len(set(idx.tolist())) == 24
    assert bool((mask[idx] == 1.0).all())


def test_adaptive_rounds_skip_selected_and_zero_weight_indices(X):
    """Already-selected indices get zero probability; with every other
    weight zero the relative floor keeps the draw uniform over the allowed
    set instead of failing."""
    w = torch.zeros(N)
    allowed = torch.ones(N)
    allowed[:250] = 0.0
    idx = tsel._weighted_indices_without_replacement(w, 50, allowed, gen(2))
    assert sorted(idx.tolist()) == list(range(250, 300))
    w = torch.rand(N, generator=gen(3))
    allowed = torch.ones(N)
    allowed[torch.arange(0, N, 2)] = 0.0
    idx = tsel._weighted_indices_without_replacement(w, 100, allowed,
                                                     gen(4))
    assert len(set(idx.tolist())) == 100 and all(i % 2 for i in
                                                 idx.tolist())


def test_uniform_adaptive2_refuses_c_below_three_and_shim_agrees(X):
    with pytest.raises(ValueError, match="c ≥ 3"):
        tsel.get_policy("uniform_adaptive2").select(top(X), 2,
                                                    generator=gen(0))
    a = tadapt.uniform_adaptive2_indices(top(X), 24, generator=gen(5))
    b = tsel.UniformAdaptive2Policy().select(top(X), 24, generator=gen(5))
    assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["leverage", "uniform"])
def test_select_pair_shares_the_pilot_for_leverage(X, name):
    op = top(X)
    pol = tsel.get_policy(name)
    cidx, ridx = pol.select_pair(op, 16, 20, generator=gen(6))
    assert len(set(cidx.tolist())) == 16 and len(set(ridx.tolist())) == 20
    assert op.counts["columns"] == pol.gathers   # one pilot for both sides


def _exact_attention(q, k, v):
    w = torch.softmax((q @ k.T) / np.sqrt(q.shape[1]), dim=-1)
    return w @ v


@pytest.mark.parametrize("selection", POLICIES)
def test_policy_landmarks_stay_in_the_attention_error_band(selection):
    """The reference's ``test_selection_policy_landmarks``: distinct
    landmarks from the softmax-Gram operator, finite output, mean relative
    error < 0.35 over 3 draws at S = 192, D = 16, c = 24."""
    rng = np.random.default_rng(14)
    q, k = (torch.as_tensor((rng.normal(size=(192, 16)) * 0.4).astype(
        np.float32)) for _ in range(2))
    v = torch.as_tensor(rng.normal(size=(192, 16)).astype(np.float32))
    exact = _exact_attention(q, k, v)
    idx = tsa.select_landmarks(k, 24, selection=selection,
                               generator=gen(15))
    assert len(set(idx.tolist())) == 24
    errs = []
    for i in range(3):
        out = tsa.sketched_attention(q, k, v, 24, 4, selection=selection,
                                     generator=gen(20 + i), device="cpu")
        assert torch.isfinite(out).all()
        errs.append(float((out - exact).norm() / exact.norm()))
    assert np.mean(errs) < 0.35, errs
