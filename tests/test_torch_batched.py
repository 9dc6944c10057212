"""The batched and ragged fast model (``fast_model_batched``,
``fast_model_ragged``, ``bucket_by_size``) held against the JAX reference
(CPU).

The reference vmaps ``fast_model`` over per-item keys; the port loops over
items.  Each item's draws are recovered from its key as
``tests/test_torch_spsd.py`` does — the columns from ``P_indices``, the
Gaussian sketch from ``GaussianSketch(split(key)[1], n_pad, s)``, the
uniform column sketch by redrawing it from the same key and mask — and
handed to the port.  Tolerances: C ≤ 1e-5 and U ≤ 1e-4 scale-normalized
(two SVD implementations), as for the unbatched model.

The meter: the reference's ``CountingOperator`` is not a JAX type, so a
batch of metered operators cannot pass through its vmap (the test below
shows the TypeError).  The port meters each item's operator; its counts
equal the reference's unbatched ``fast_model`` on that item (ROADMAP C3).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sketch as jsk
from repro.core import spsd as jsp
from repro.core.instrument import CountingOperator as JCounting
from repro.core.kernelop import RBFKernel as JRBF
from repro_torch.core import spsd as tsp
from repro_torch.core.instrument import CountingOperator as TCounting
from repro_torch.core.kernelop import RBFKernel as TRBF

SIGMA, C, S = 1.5, 12, 48


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Small intra-op pool for the six workers; one small ``torch.exp``
    first (ROADMAP C: the first multi-threaded exp of a process)."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    torch.exp(torch.zeros(64))
    yield
    torch.set_num_threads(old)


def scaled(port, ref) -> float:
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


def trbf(X):
    return TRBF(torch.as_tensor(np.asarray(X), dtype=torch.float32),
                sigma=SIGMA, device="cpu")


def gaussian_draw(key, n_pad, s=S) -> np.ndarray:
    return np.array(jsk.GaussianSketch(jax.random.split(key)[1], n_pad,
                                       s)._mat())


def uniform_draw(key, n_pad, n_valid=None, s=S):
    """The reference's column sketch as its vmap draws it: traced, so an
    s above the valid count takes the duplicated-valid-rows branch."""
    mask = None if n_valid is None else \
        (jnp.arange(n_pad) < n_valid).astype(jnp.float32)
    base = jax.jit(lambda k, m: jsk.uniform_column_sketch(
        k, n_pad, s, scale=False, mask=m))(jax.random.split(key)[1], mask)
    return np.array(base.indices), np.array(base.scales)


def poisoned(seed, n_valid, n_pad, d=6):
    rng = np.random.default_rng(seed)
    Xb = rng.normal(size=(len(n_valid), n_pad, d))
    for b, nv in enumerate(n_valid):
        Xb[b, nv:] = 99.0                    # poison the padding rows
    return Xb.astype(np.float32)


def assert_items_match(bat_t, bat_j, B):
    assert tuple(bat_t.C.shape) == tuple(bat_j.C.shape)
    assert tuple(bat_t.U.shape) == tuple(bat_j.U.shape)
    for i in range(B):
        assert scaled(bat_t.C[i], bat_j.C[i]) <= 1e-5, i
        assert scaled(bat_t.U[i], bat_j.U[i]) <= 1e-4, i
        assert np.array_equal(np.asarray(bat_t.P_indices[i]),
                              np.asarray(bat_j.P_indices[i]))


# ---------------------------------------------------------------------------
# bucket_by_size: the reference's buckets, ties in the same order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sizes,waste", [
    ([3000, 2900, 1000, 950, 120, 110, 100], 0.25),
    ([5, 17, 33, 64, 64, 5, 17, 33, 5, 64], 0.25),
    ([100, 100, 100, 80, 80, 125], 0.25),
    ([7], 0.0), ([], 0.25), ([10, 9, 8, 7, 6, 5], 0.5),
    (list(np.random.default_rng(0).integers(1, 500, 40)), 0.1),
])
def test_bucket_by_size_equals_the_reference(sizes, waste):
    assert tsp.bucket_by_size(sizes, waste) == \
        jsp.bucket_by_size(sizes, waste)


def test_bucket_by_size_bounds_padding_waste():
    sizes = [3000, 2900, 1000, 950, 120, 110, 100]
    buckets = tsp.bucket_by_size(sizes, waste=0.25)
    assert sorted(i for b in buckets for i in b) == list(range(len(sizes)))
    for b in buckets:
        cap = max(sizes[i] for i in b)
        assert all(cap <= sizes[i] * 1.25 + 1e-9 for i in b)
    by_item = {i: tuple(b) for b in buckets for i in b}
    assert by_item[0] != by_item[4]


# ---------------------------------------------------------------------------
# fast_model_batched against the reference on shared per-item draws
# ---------------------------------------------------------------------------

def test_batched_gaussian_matches_reference():
    rng = np.random.default_rng(0)
    Xb = rng.normal(size=(3, 200, 6)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(7), 3)
    bat_j = jsp.fast_model_batched(JRBF(jnp.asarray(Xb), sigma=SIGMA), keys,
                                   c=C, s=S, s_sketch="gaussian")
    bat_t = tsp.fast_model_batched(
        [trbf(X) for X in Xb], C, S, s_sketch="gaussian",
        idx=[np.array(p) for p in bat_j.P_indices],
        S=[gaussian_draw(k, 200) for k in keys])
    assert_items_match(bat_t, bat_j, 3)


def test_batched_ragged_padding_matches_reference_and_masks():
    """Poisoned padding rows: C's padding rows exactly 0, P in the valid
    range, each item equal to the reference's and a good model of its
    unpadded kernel."""
    n_valid, n_pad = [150, 200], 200
    Xb = poisoned(11, n_valid, n_pad)
    keys = jax.random.split(jax.random.PRNGKey(7), 2)
    bat_j = jsp.fast_model_batched(JRBF(jnp.asarray(Xb), sigma=SIGMA), keys,
                                   c=C, s=S, s_sketch="gaussian",
                                   n_valid=jnp.asarray(n_valid))
    bat_t = tsp.fast_model_batched(
        [trbf(X) for X in Xb], C, S, s_sketch="gaussian", n_valid=n_valid,
        idx=[np.array(p) for p in bat_j.P_indices],
        S=[gaussian_draw(k, n_pad) for k in keys])
    assert_items_match(bat_t, bat_j, 2)
    assert torch.isfinite(bat_t.U).all()
    for b, nv in enumerate(n_valid):
        assert torch.count_nonzero(bat_t.C[b][nv:]) == 0
        assert int(bat_t.P_indices[b].max()) < nv
        ap = tsp.SPSDApprox(C=bat_t.C[b][:nv], U=bat_t.U[b])
        err = float(tsp.relative_error(trbf(Xb[b, :nv]), ap, method="dense"))
        assert np.isfinite(err) and err < 0.5, (b, err)


def test_batched_uniform_column_sketch_matches_reference():
    n_valid, n_pad = [30, 200], 200           # s > 30: duplicated valid rows
    Xb = poisoned(4, n_valid, n_pad)
    keys = jax.random.split(jax.random.PRNGKey(5), 2)
    bat_j = jsp.fast_model_batched(JRBF(jnp.asarray(Xb), sigma=SIGMA), keys,
                                   c=C, s=S, s_sketch="uniform",
                                   n_valid=jnp.asarray(n_valid))
    bat_t = tsp.fast_model_batched(
        [trbf(X) for X in Xb], C, S, s_sketch="uniform", n_valid=n_valid,
        idx=[np.array(p) for p in bat_j.P_indices],
        S=[uniform_draw(k, n_pad, nv) for k, nv in zip(keys, n_valid)])
    assert_items_match(bat_t, bat_j, 2)
    for b, nv in enumerate(n_valid):
        ap = tsp.SPSDApprox(C=bat_t.C[b][:nv], U=bat_t.U[b])
        err = float(tsp.relative_error(trbf(Xb[b, :nv]), ap, method="dense"))
        assert np.isfinite(err) and err < 0.5, (b, err)


def test_batched_dense_input_matches_reference():
    rng = np.random.default_rng(1)
    Y = rng.normal(size=(3, 100, 5)).astype(np.float32)
    Kb = np.einsum("bnd,bmd->bnm", Y, Y)
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    bat_j = jsp.fast_model_batched(jnp.asarray(Kb), keys, c=8, s=24,
                                   s_sketch="uniform")
    bat_t = tsp.fast_model_batched(
        torch.from_numpy(Kb), 8, 24, s_sketch="uniform",
        idx=[np.array(p) for p in bat_j.P_indices],
        S=[uniform_draw(k, 100, s=24) for k in keys])
    assert tuple(bat_t.U.shape) == (3, 8, 8)
    assert_items_match(bat_t, bat_j, 3)


def test_batched_equals_per_item_fast_model_bitwise():
    """The loop is the unbatched model item by item: same draws, the same
    bits."""
    rng = np.random.default_rng(2)
    Xb = rng.normal(size=(3, 120, 6)).astype(np.float32)
    g = torch.Generator().manual_seed(3)
    draws = [(torch.randperm(120, generator=g)[:C],
              torch.randn(120, S, generator=g)) for _ in range(3)]
    bat = tsp.fast_model_batched([trbf(X) for X in Xb], C, S,
                                 s_sketch="gaussian",
                                 idx=[d[0] for d in draws],
                                 S=[d[1] for d in draws])
    for i, (idx, Sm) in enumerate(draws):
        one = tsp.fast_model(trbf(Xb[i]), C, S, s_sketch="gaussian",
                             idx=idx, S=Sm)
        assert torch.equal(bat.C[i], one.C) and torch.equal(bat.U[i], one.U)


@pytest.mark.parametrize("selection", ["leverage", "uniform_adaptive2"])
def test_batched_selection_policies_keep_padding_out(selection):
    """The reference's policy test as a port case: non-uniform policies run
    per item with the mask and never pick a padding row."""
    n_valid, n_pad = [150, 200], 200
    Xb = poisoned(3, n_valid, n_pad)
    bat = tsp.fast_model_batched(
        [trbf(X) for X in Xb], C, S, s_sketch="gaussian", n_valid=n_valid,
        selection=selection, generator=torch.Generator().manual_seed(4))
    assert torch.isfinite(bat.U).all()
    for b, nv in enumerate(n_valid):
        assert int(bat.P_indices[b].max()) < nv
        ap = tsp.SPSDApprox(C=bat.C[b][:nv], U=bat.U[b])
        err = float(tsp.relative_error(trbf(Xb[b, :nv]), ap, method="dense"))
        assert np.isfinite(err) and err < 0.5, (selection, b, err)


def test_batched_rejects_mixed_sizes_and_short_draws():
    rng = np.random.default_rng(5)
    a, b = (rng.normal(size=(n, 4)).astype(np.float32) for n in (50, 60))
    with pytest.raises(ValueError, match="share one n"):
        tsp.fast_model_batched([trbf(a), trbf(b)], 4, 8, s_sketch="gaussian")
    with pytest.raises(ValueError, match="idx has 1 entries for 2 items"):
        tsp.fast_model_batched([trbf(a), trbf(a)], 4, 8,
                               s_sketch="gaussian", idx=[np.arange(4)])


# ---------------------------------------------------------------------------
# fast_model_ragged
# ---------------------------------------------------------------------------

def test_ragged_matches_reference_per_item():
    rng = np.random.default_rng(5)
    sizes = [150, 160, 90, 300, 95]
    Xs = [rng.normal(size=(n, 6)).astype(np.float32) for n in sizes]
    keys = jax.random.split(jax.random.PRNGKey(6), len(sizes))
    outs_j = jsp.fast_model_ragged(
        [jnp.asarray(X) for X in Xs], lambda Xb: JRBF(Xb, sigma=SIGMA), keys,
        c=C, s=S, s_sketch="gaussian", waste=0.25)
    pad = {}
    for bucket in jsp.bucket_by_size(sizes, 0.25):
        for i in bucket:
            pad[i] = max(sizes[j] for j in bucket)
    outs_t = tsp.fast_model_ragged(
        Xs, trbf, C, S, s_sketch="gaussian", waste=0.25,
        idx=[np.array(o.P_indices) for o in outs_j],
        S=[gaussian_draw(k, pad[i]) for i, k in enumerate(keys)])
    assert [tuple(o.C.shape) for o in outs_t] == [(n, C) for n in sizes]
    for i, (ot, oj) in enumerate(zip(outs_t, outs_j)):
        assert scaled(ot.C, oj.C) <= 1e-5, i
        assert scaled(ot.U, oj.U) <= 1e-4, i
        err = float(tsp.relative_error(trbf(Xs[i]), ot, method="dense"))
        assert np.isfinite(err) and err < 0.5, (i, err)


def test_ragged_generator_draws_give_good_models():
    rng = np.random.default_rng(6)
    sizes = [150, 160, 90, 300]
    Xs = [rng.normal(size=(n, 6)).astype(np.float32) for n in sizes]
    outs = tsp.fast_model_ragged(Xs, trbf, C, S, s_sketch="gaussian",
                                 generator=torch.Generator().manual_seed(0))
    assert [tuple(o.C.shape) for o in outs] == [(n, C) for n in sizes]
    for o, X, n in zip(outs, Xs, sizes):
        assert int(o.P_indices.max()) < n
        err = float(tsp.relative_error(trbf(X), o, method="dense"))
        assert np.isfinite(err) and err < 0.5, (n, err)


# ---------------------------------------------------------------------------
# the meter
# ---------------------------------------------------------------------------

def test_reference_meter_cannot_pass_through_its_vmap():
    Xb = jnp.asarray(np.random.default_rng(0).normal(size=(2, 60, 6)),
                     jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(7), 2)
    with pytest.raises(TypeError, match="not a valid JAX type"):
        jsp.fast_model_batched(JCounting(JRBF(Xb, sigma=SIGMA)), keys,
                               c=C, s=S, s_sketch="gaussian")


def test_per_item_meter_equals_the_reference_unbatched_counts():
    """Each item's ``CountingOperator`` reads what the reference's meter
    reads for the unbatched ``fast_model`` on that item (padded, with its
    mask): one fused sweep of nblocks·b·n entries."""
    n_valid, n_pad = [150, 200], 200
    Xb = poisoned(11, n_valid, n_pad)
    keys = jax.random.split(jax.random.PRNGKey(7), 2)
    ops_t = [TCounting(trbf(X)) for X in Xb]
    ref = []
    for X, key, nv in zip(Xb, keys, n_valid):
        opj = JCounting(JRBF(jnp.asarray(X), sigma=SIGMA, use_pallas=True))
        apj = jsp.fast_model(opj, key, c=C, s=S, s_sketch="gaussian",
                             n_valid=nv)
        ref.append((opj, apj))
    tsp.fast_model_batched(
        ops_t, C, S, s_sketch="gaussian", n_valid=n_valid,
        idx=[np.array(apj.P_indices) for _, apj in ref],
        S=[gaussian_draw(k, n_pad) for k in keys])
    for opt, (opj, _) in zip(ops_t, ref):
        assert opt.counts == opj.counts
        assert opt.counts["sweeps"] == 1 and opt.counts["fused_sweeps"] == 1
        assert opt.last_route == opj.last_route.replace("pallas_", "")
