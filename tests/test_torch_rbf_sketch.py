"""The port's RBF bindings held against the JAX reference (CPU).

Same inputs (numpy, seeded) go through ``repro.kernels.rbf_sketch`` (its
Pallas kernels in interpret mode, as the reference's own tests run them) and
``repro_torch.kernels.rbf_sketch`` (the pairwise kernels' plain versions,
since the tensors lie on the CPU), at the shapes of the reference's RBF
tests (``tests/test_kernels.py``).  The reference's ``_padded`` entry points
take tile multiples only; the port's take any shape, and are also held to
the port's plain oracle at ragged shapes.

Tolerance: f32 ≤ 1e-5, scale-normalized (max |port − ref| / max |ref|).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rbf_sketch import kernel as jk
from repro.kernels.rbf_sketch import ops as jops
from repro.kernels.rbf_sketch import ref as jref
from repro_torch import kernels as tkernels
from repro_torch.core.kernelop import RBFKernel
from repro_torch.kernels.rbf_sketch import kernel as tk
from repro_torch.kernels.rbf_sketch import ops as tops
from repro_torch.kernels.rbf_sketch import ref as tref

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Keep torch's intra-op pool small; one small ``torch.exp`` first (see
    ROADMAP C, torch 2.13 CPU builds)."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    torch.exp(torch.zeros(64))
    yield
    torch.set_num_threads(old)


def _normal(seed, *shape) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _err(got, want) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


T = torch.as_tensor
J = jnp.asarray


@pytest.mark.parametrize("nr,nc,d", [(128, 128, 16), (96, 64, 8),
                                     (200, 50, 32), (17, 33, 4)])
@pytest.mark.parametrize("sigma", [0.5, 2.0])
def test_rbf_block(nr, nc, d, sigma):
    X, Y = _normal(1, nr, d), _normal(2, nc, d)
    got = tops.rbf_block(T(X), T(Y), sigma)
    assert _err(got, jops.rbf_block(J(X), J(Y), sigma)) <= TOL
    assert _err(tref.rbf_block(T(X), T(Y), sigma),
                jref.rbf_block(J(X), J(Y), sigma)) <= TOL


def test_rbf_block_diag_is_one():
    X = T(_normal(3, 64, 8))
    K = tops.rbf_block(X, X, 1.3)
    assert float((torch.diagonal(K) - 1.0).abs().max()) <= 1e-6


def test_sketched_gram():
    X = _normal(4, 150, 12)
    scales = np.abs(_normal(5, 150)) + 0.5
    for sc in (None, scales):
        got = tops.sketched_gram(T(X), 1.1, None if sc is None else T(sc))
        want = jops.sketched_gram(J(X), 1.1, None if sc is None else J(sc))
        assert _err(got, want) <= TOL
        assert _err(tref.sketched_gram(T(X), 1.1,
                                       None if sc is None else T(sc)),
                    jref.sketched_gram(J(X), 1.1,
                                       None if sc is None else J(sc))) <= TOL


@pytest.mark.parametrize("n,d,m", [(128, 8, 128), (300, 16, 7), (130, 5, 1),
                                   (256, 32, 200)])
def test_rbf_matmat(n, d, m):
    X, V = _normal(6, n, d), _normal(7, n, m)
    got = tops.rbf_matmat(T(X), T(V), 1.3)
    assert _err(got, jops.rbf_matmat(J(X), J(V), 1.3)) <= TOL
    assert _err(tref.rbf_matmat(T(X), T(V), 1.3),
                jref.rbf_matmat(J(X), J(V), 1.3)) <= TOL


@pytest.mark.parametrize("nr,nc,d", [(128, 256, 8), (67, 533, 6), (40, 40, 4)])
def test_rbf_matmat_multi_rows(nr, nc, d):
    Xc = _normal(8, nc, d)
    Xr = Xc[:nr]
    Vs = (_normal(9, nc, 5), _normal(10, nc, 130))
    got = tops.rbf_matmat_multi_rows(T(Xr), T(Xc), [T(V) for V in Vs], 1.3)
    want = jops.rbf_matmat_multi_rows(J(Xr), J(Xc), [J(V) for V in Vs], 1.3)
    refs = tref.rbf_matmat_multi_rows(T(Xr), T(Xc), [T(V) for V in Vs], 1.3)
    assert len(got) == 2
    for g, w, r in zip(got, want, refs):
        assert _err(g, w) <= TOL
        assert _err(r, w) <= TOL


def test_rbf_matmat_multi_square_is_the_rows_launch():
    X = _normal(11, 150, 8)
    Vs = (_normal(12, 150, 9),)
    a = tops.rbf_matmat_multi(T(X), [T(V) for V in Vs], 0.8)
    b = tops.rbf_matmat_multi_rows(T(X), T(X), [T(V) for V in Vs], 0.8)
    assert torch.equal(a[0], b[0])
    assert _err(a[0], jops.rbf_matmat_multi(J(X), [J(V) for V in Vs],
                                            0.8)[0]) <= TOL
    assert _err(tref.rbf_matmat_multi(T(X), [T(V) for V in Vs], 0.8)[0],
                jref.rbf_matmat_multi(J(X), [J(V) for V in Vs],
                                      0.8)[0]) <= TOL


def test_rbf_matmat_vector_rhs_and_operator_wiring():
    X, v = _normal(13, 100, 6), _normal(14, 100)
    out = tops.rbf_matmat(T(X), T(v), 0.9)
    assert out.shape == (100,)
    assert _err(out, jops.rbf_matmat(J(X), J(v), 0.9)) <= TOL
    op = RBFKernel(X, sigma=0.9, device="cpu")
    assert _err(op.matmat(T(v)[:, None])[:, 0], out.numpy()) <= TOL
    assert _err(op.full() @ T(v), out.numpy()) <= TOL


@pytest.mark.parametrize("nr,nc,d,m", [(128, 256, 8, 128),
                                       (256, 128, 16, 256)])
def test_padded_entry_points_at_tile_multiples(nr, nc, d, m):
    """At the reference's tile multiples, every ``_padded`` function equals
    the reference's (its Pallas kernels in interpret mode)."""
    Xr, Xc = _normal(15, nr, d), _normal(16, nc, d)
    V1, V2 = _normal(17, nc, m), _normal(18, nc, 128)
    assert _err(tk.rbf_block_padded(T(Xr), T(Xc), 1.2),
                jk.rbf_block_padded(J(Xr), J(Xc), 1.2,
                                    interpret=True)) <= TOL
    assert _err(tk.rbf_matmat_padded(T(Xr), T(Xc), T(V1), 1.2),
                jk.rbf_matmat_padded(J(Xr), J(Xc), J(V1), 1.2,
                                     interpret=True)) <= TOL
    got = tk.rbf_matmat_multi_padded(T(Xr), T(Xc), (T(V1), T(V2)), 1.2)
    want = jk.rbf_matmat_multi_padded(J(Xr), J(Xc), (J(V1), J(V2)), 1.2,
                                      interpret=True)
    for g, w in zip(got, want):
        assert _err(g, w) <= TOL


@pytest.mark.parametrize("nr,nc,d,m", [(17, 33, 4, 1), (200, 67, 5, 9)])
def test_padded_entry_points_take_any_shape(nr, nc, d, m):
    """The port's kernels mask their own edges: the ``_padded`` names take
    ragged shapes, held to the port's plain oracle."""
    Xr, Xc, V = T(_normal(19, nr, d)), T(_normal(20, nc, d)), \
        T(_normal(21, nc, m))
    assert _err(tk.rbf_block_padded(Xr, Xc, 0.7),
                tref.rbf_block(Xr, Xc, 0.7).numpy()) <= TOL
    want = tref.rbf_matmat_multi_rows(Xr, Xc, (V,), 0.7)[0].numpy()
    assert _err(tk.rbf_matmat_padded(Xr, Xc, V, 0.7), want) <= TOL
    assert _err(tk.rbf_matmat_multi_padded(Xr, Xc, (V,), 0.7)[0],
                want) <= TOL


def test_reexported_as_rbf_ops():
    assert tkernels.rbf_ops is tops
