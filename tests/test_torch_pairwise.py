"""The port's pairwise kernel layer held against the JAX reference (CPU).

Same inputs, made with numpy, go through ``repro.kernels.pairwise`` and
``repro_torch.kernels.pairwise`` for every spec × precision, on shapes that
are not multiples of the 128-wide tiles — the slab launch (B4) at a head, a
middle and a clamped tail slab of n = 533, compared on the rows below n
(past n the reference reads zero-padded points, the port clamps to the
last row; the sweep masks those rows either way).  The JAX side runs its Pallas
kernels in interpret mode (``use_pallas=True``, as the reference's own tests
do off-TPU); the port's wrappers run their plain versions because the
tensors lie on the CPU.

Tolerances, scale-normalized (max |port − ref| / max |ref|):
f32 ≤ 1e-5; bf16_f32acc against the reference under the same policy ≤ 1e-2
(an entry at a bf16 rounding tie can land one ulp apart); bf16_f32acc
against the f32 oracle ≤ 5e-2 (the reference's own gate).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.pairwise import ops as jops
from repro.kernels.pairwise import ref as jref
from repro.kernels.pairwise import signsplit as jss
from repro.kernels.pairwise import specs as jspecs
from repro_torch.kernels.pairwise import kernel as tkernel
from repro_torch.kernels.pairwise import ops as tops
from repro_torch.kernels.pairwise import ref as tref
from repro_torch.kernels.pairwise import signsplit as tss
from repro_torch.kernels.pairwise import specs as tspecs

NAMES = ("laplacian", "linear", "matern32", "polynomial", "rbf")
PRECISIONS = ("f32", "bf16_f32acc")
D = 16
TOL = {"f32": 1e-5, "bf16_f32acc": 1e-2}
TOL_BF16_VS_F32 = 5e-2

CASES = [(n, p) for n in NAMES for p in PRECISIONS]


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
def data():
    rng = np.random.default_rng(0)
    Xr = rng.normal(size=(150, D)).astype(np.float32)
    Xc = rng.normal(size=(200, D)).astype(np.float32)
    Vs = (rng.normal(size=(200, 3)).astype(np.float32),
          rng.normal(size=(200, 130)).astype(np.float32))
    return Xr, Xc, Vs


@pytest.fixture(scope="module")
def lattice():
    """Integer-valued data: inside a sign-split plan."""
    rng = np.random.default_rng(1)
    X = rng.integers(0, 5, size=(350, D)).astype(np.float32)
    return X[:150], X[150:], X


def _specs(name, prec):
    return (jspecs.suggested_spec(name, D).with_precision(prec),
            tspecs.suggested_spec(name, D).with_precision(prec))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def scaled(port, ref) -> float:
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


def test_registry_matches_reference():
    assert tspecs.registered_kernels() == NAMES
    assert set(NAMES) <= set(jspecs.registered_kernels())
    for name in NAMES:
        assert tspecs.suggested_params(name, D) == \
            jspecs.suggested_params(name, D)
        jspec, tspec = _specs(name, "f32")
        assert tspec.stat == jspec.stat and tspec.params == jspec.params
        assert tspec.epilogue is not None
        assert tspec.with_precision("bf16_f32acc").with_precision("f32") \
            is tspec


@pytest.mark.parametrize("name,prec", CASES)
def test_stat_block_apply_diag(data, name, prec):
    Xr, Xc, _ = data
    jspec, tspec = _specs(name, prec)
    got = tspecs.stat_block(tspec.stat, _t(Xr), _t(Xc), prec)
    want = jspecs.stat_block(jspec.stat, jnp.asarray(Xr), jnp.asarray(Xc),
                             prec)
    assert scaled(got, want) <= TOL[prec]
    assert scaled(tspecs.apply(tspec, _t(Xr), _t(Xc)),
                  jspecs.apply(jspec, jnp.asarray(Xr), jnp.asarray(Xc))) \
        <= TOL[prec]
    assert scaled(tspecs.diag(tspec, _t(Xr)),
                  jspecs.diag(jspec, jnp.asarray(Xr))) <= TOL[prec]


@pytest.mark.parametrize("name,prec", CASES)
def test_kernel_block_matches_pallas(data, name, prec):
    Xr, Xc, _ = data
    jspec, tspec = _specs(name, prec)
    got = tops.kernel_block(tspec, _t(Xr), _t(Xc))
    want = jops.kernel_block(jspec, jnp.asarray(Xr), jnp.asarray(Xc),
                             use_pallas=True)
    assert got.shape == (150, 200)
    assert scaled(got, want) <= TOL[prec]


@pytest.mark.parametrize("name,prec", CASES)
def test_matmat_multi_rows_matches_pallas(data, name, prec):
    Xr, Xc, Vs = data
    jspec, tspec = _specs(name, prec)
    got = tops.kernel_matmat_multi_rows(tspec, _t(Xr), _t(Xc),
                                        [_t(V) for V in Vs])
    want = jops.kernel_matmat_multi_rows(
        jspec, jnp.asarray(Xr), jnp.asarray(Xc),
        [jnp.asarray(V) for V in Vs], use_pallas=True)
    assert [tuple(g.shape) for g in got] == [(150, 3), (150, 130)]
    for g, w in zip(got, want):
        assert scaled(g, w) <= TOL[prec]


@pytest.mark.parametrize("name", NAMES)
def test_bf16_policy_within_gate_of_f32_oracle(data, name):
    Xr, Xc, Vs = data
    _, tspec = _specs(name, "bf16_f32acc")
    oracle = jref.kernel_block(jspecs.suggested_spec(name, D),
                               jnp.asarray(Xr), jnp.asarray(Xc))
    assert scaled(tops.kernel_block(tspec, _t(Xr), _t(Xc)), oracle) \
        <= TOL_BF16_VS_F32
    got = tops.kernel_matmat_multi_rows(tspec, _t(Xr), _t(Xc),
                                        [_t(V) for V in Vs])
    for g, V in zip(got, Vs):
        assert scaled(g, np.asarray(oracle) @ V) <= TOL_BF16_VS_F32


@pytest.mark.parametrize("name", NAMES)
def test_oracles_match_reference_oracles(data, name):
    Xr, Xc, Vs = data
    jspec, tspec = _specs(name, "f32")
    assert scaled(tref.kernel_block(tspec, _t(Xr), _t(Xc)),
                  jref.kernel_block(jspec, jnp.asarray(Xr),
                                    jnp.asarray(Xc))) <= 1e-5
    # and the port's f32 entries agree with its own independent oracle
    assert scaled(tops.kernel_block(tspec, _t(Xr), _t(Xc)),
                  tref.kernel_block(tspec, _t(Xr), _t(Xc))) <= 1e-5
    got = tref.kernel_matmat_multi_rows(tspec, _t(Xr), _t(Xc),
                                        [_t(V) for V in Vs])
    want = jref.kernel_matmat_multi_rows(jspec, jnp.asarray(Xr),
                                         jnp.asarray(Xc),
                                         [jnp.asarray(V) for V in Vs])
    for g, w in zip(got, want):
        assert scaled(g, w) <= 1e-5


# ---------------------------------------------------------------------------
# laplacian: sign-split plan and the plan-free loop
# ---------------------------------------------------------------------------

def test_build_plan_edges_identical(lattice):
    _, _, X = lattice
    jplan, tplan = jss.build_plan(jnp.asarray(X)), tss.build_plan(X)
    assert tplan is not None and jplan is not None
    np.testing.assert_array_equal(tplan.edges, np.asarray(jplan.edges))
    assert tplan.segments == jplan.segments
    assert tss.build_plan(torch.from_numpy(X)).edges.tobytes() == \
        tplan.edges.tobytes()


@pytest.mark.parametrize("case", ["continuous", "too_many", "nonfinite",
                                  "one_value"])
def test_build_plan_refusals_identical(case):
    rng = np.random.default_rng(2)
    X = {"continuous": rng.normal(size=(60, 3)),
         "too_many": np.tile(np.arange(40.0)[:, None], (1, 2)),
         "nonfinite": np.array([[0.0, np.inf], [1.0, 2.0]]),
         "one_value": np.ones((5, 2))}[case].astype(np.float32)
    jplan, tplan = jss.build_plan(jnp.asarray(X)), tss.build_plan(X)
    assert (jplan is None) == (tplan is None)
    if tplan is not None:
        np.testing.assert_array_equal(tplan.edges, np.asarray(jplan.edges))


@pytest.mark.parametrize("case", ["on", "off", "nonfinite", "one_d",
                                  "wrong_d"])
def test_query_in_plan_decisions_identical(lattice, case):
    _, _, X = lattice
    Q = {"on": X[:7] + 0.0,
         "off": X[:7] + 0.5,
         "nonfinite": np.full((2, D), np.nan, np.float32),
         "one_d": X[3],
         "wrong_d": X[:2, :5]}[case]
    want = jss.query_in_plan(jnp.asarray(X), jnp.asarray(Q))
    assert tss.query_in_plan(X, Q) == want
    assert tss.query_in_plan(torch.from_numpy(X), torch.from_numpy(Q)) == want


@pytest.mark.parametrize("prec", PRECISIONS)
def test_embed_identical(lattice, prec):
    Xr, _, X = lattice
    edges = tss.build_plan(X).edges
    jdt = jspecs.tile_dtype(prec)
    tdt = tspecs.tile_dtype(prec)
    ja, jb = jss.embed(jnp.asarray(Xr).astype(jdt), jnp.asarray(edges), jdt)
    ta, tb = tss.embed(_t(Xr).to(tdt), torch.from_numpy(edges), tdt)
    np.testing.assert_array_equal(ta.float().numpy(),
                                  np.asarray(ja.astype(jnp.float32)))
    np.testing.assert_array_equal(tb.float().numpy(),
                                  np.asarray(jb.astype(jnp.float32)))


@pytest.mark.parametrize("prec", PRECISIONS)
@pytest.mark.parametrize("with_plan", [True, False])
def test_laplacian_with_and_without_plan(lattice, data, prec, with_plan):
    Xr, Xc, X = lattice
    _, _, Vs = data
    jspec, tspec = _specs("laplacian", prec)
    edges = tss.build_plan(X).edges if with_plan else None
    tedges = None if edges is None else torch.from_numpy(edges)
    jedges = None if edges is None else jnp.asarray(edges)
    got = tspecs.stat_block("l1dist", _t(Xr), _t(Xc), prec, tedges)
    want = jspecs.stat_block("l1dist", jnp.asarray(Xr), jnp.asarray(Xc),
                             prec, jedges)
    assert scaled(got, want) <= TOL[prec]
    got = tops.kernel_block(tspec, _t(Xr), _t(Xc), edges=tedges)
    want = jops.kernel_block(jspec, jnp.asarray(Xr), jnp.asarray(Xc),
                             use_pallas=True, edges=jedges)
    assert scaled(got, want) <= TOL[prec]
    got = tops.kernel_matmat_multi_rows(tspec, _t(Xr), _t(Xc),
                                        [_t(V) for V in Vs], edges=tedges)
    want = jops.kernel_matmat_multi_rows(
        jspec, jnp.asarray(Xr), jnp.asarray(Xc),
        [jnp.asarray(V) for V in Vs], use_pallas=True, edges=jedges)
    for g, w in zip(got, want):
        assert scaled(g, w) <= TOL[prec]


def test_signsplit_equals_loop_on_plan_data(lattice):
    """The identity the CUDA kernels rely on: on in-plan data the
    sign-split form and the direct |x − y| sum are the same function."""
    Xr, Xc, X = lattice
    edges = torch.from_numpy(tss.build_plan(X).edges)
    split = tss.l1dist(_t(Xr), _t(Xc), edges)
    loop = tspecs.stat_block("l1dist", _t(Xr), _t(Xc))
    assert scaled(split, loop) <= 1e-6


# ---------------------------------------------------------------------------
# the wrappers' CPU path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_cpu_tensors_take_the_plain_version(data, name):
    Xr, Xc, Vs = data
    _, tspec = _specs(name, "f32")
    tkernel.reset_launch_counts()
    blk = tkernel.pairwise_block(tspec, _t(Xr), _t(Xc))
    assert torch.equal(blk, tkernel.pairwise_block_plain(tspec, _t(Xr),
                                                         _t(Xc)))
    outs = tkernel.pairwise_matmat_multi(tspec, _t(Xr), _t(Xc),
                                         [_t(V) for V in Vs])
    plain = tkernel.pairwise_matmat_multi_plain(tspec, _t(Xr), _t(Xc),
                                                [_t(V) for V in Vs])
    assert all(torch.equal(o, p) for o, p in zip(outs, plain))
    X = _t(Xc)
    slab = tkernel.pairwise_matmat_multi_slab(tspec, X, 30, 50,
                                              [_t(V) for V in Vs])
    slab_plain = tkernel.pairwise_matmat_multi_slab_plain(
        tspec, X, 30, 50, [_t(V) for V in Vs])
    assert all(torch.equal(o, p) for o, p in zip(slab, slab_plain))
    assert tkernel.launch_counts() == {"pairwise_block": 0,
                                       "pairwise_matmat_multi": 0,
                                       "pairwise_matmat_multi_slab": 0}


SLAB_N = 533
SLABS = {"head": (0, 200), "middle": (150, 230), "tail": (400, 200)}


@pytest.fixture(scope="module")
def slab_data():
    rng = np.random.default_rng(5)
    X = rng.normal(size=(SLAB_N, D)).astype(np.float32)
    Vs = (rng.normal(size=(SLAB_N, 3)).astype(np.float32),
          rng.normal(size=(SLAB_N, 130)).astype(np.float32))
    return X, Vs


@pytest.mark.parametrize("where", list(SLABS))
@pytest.mark.parametrize("name,prec", CASES)
def test_slab_matches_pallas(slab_data, name, prec, where):
    X, Vs = slab_data
    start, length = SLABS[where]
    jspec, tspec = _specs(name, prec)
    want = jops.kernel_matmat_multi_slab(
        jspec, jnp.asarray(X), start, length,
        tuple(jnp.asarray(V) for V in Vs), use_pallas=True, interpret=True)
    got = tops.kernel_matmat_multi_slab(tspec, _t(X), start, length,
                                        [_t(V) for V in Vs])
    rows = min(length, SLAB_N - start)
    for g, w, V in zip(got, want, Vs):
        assert tuple(g.shape) == (length, V.shape[1])
        assert scaled(g[:rows], np.asarray(w)[:rows]) <= TOL[prec]
    if prec == "bf16_f32acc":
        f32 = tspec.with_precision("f32")
        exact = tops.kernel_matmat_multi_slab(f32, _t(X), start, length,
                                              [_t(V) for V in Vs])
        assert max(scaled(g, e) for g, e in zip(got, exact)) \
            <= TOL_BF16_VS_F32


@pytest.mark.parametrize("where", list(SLABS))
def test_plain_slab_is_b1_rows(slab_data, where):
    """The plain B4 slab is the plain B1 output's rows start + i, clamped to
    n − 1; the one-hot gather rides along exactly."""
    X, Vs = slab_data
    start, length = SLABS[where]
    _, tspec = _specs("rbf", "f32")
    onehot = np.zeros((SLAB_N, 2), np.float32)
    onehot[[7, SLAB_N - 1], [0, 1]] = 1.0
    rhs = [_t(V) for V in Vs] + [_t(onehot)]
    got = tkernel.pairwise_matmat_multi_slab_plain(tspec, _t(X), start,
                                                   length, rhs)
    rows = tkernel.slab_rows(SLAB_N, start, length)
    assert rows.tolist() == [min(start + i, SLAB_N - 1)
                             for i in range(length)]
    full = tkernel.pairwise_matmat_multi_plain(tspec, _t(X)[rows], _t(X),
                                               rhs)
    assert all(torch.equal(g, f) for g, f in zip(got, full))
    b1 = tkernel.pairwise_matmat_multi_plain(tspec, _t(X), _t(X), rhs)
    assert max(scaled(g, b[rows]) for g, b in zip(got, b1)) <= 1e-6
    blk = tkernel.pairwise_block_plain(tspec, _t(X)[rows],
                                       _t(X)[[7, SLAB_N - 1]])
    assert torch.equal(got[2], blk)


def test_kernel_matmat_squeezes_vectors(data):
    Xr, _, _ = data
    _, tspec = _specs("rbf", "f32")
    v = torch.linspace(-1.0, 1.0, 150)
    got = tops.kernel_matmat(tspec, _t(Xr), v)
    assert got.shape == (150,)
    assert torch.allclose(got, tops.kernel_matmat(tspec, _t(Xr),
                                                  v[:, None])[:, 0])


def test_sketched_gram_matches_reference(data):
    Xr, _, _ = data
    jspec, tspec = _specs("matern32", "f32")
    scales = np.linspace(0.5, 2.0, 150).astype(np.float32)
    got = tops.sketched_gram(tspec, _t(Xr), _t(scales))
    want = jops.sketched_gram(jspec, jnp.asarray(Xr), jnp.asarray(scales))
    assert scaled(got, want) <= 1e-5
