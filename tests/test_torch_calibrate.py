"""The port's per-spec calibration held against the JAX reference (CPU).

Same data and anchor columns (numpy) go through
``repro.kernels.pairwise.calibrate.calibrate_sigma`` (its Pallas block
kernel in interpret mode, ``use_pallas=True``) and the port's
``calibrate_sigma`` (the block kernel's plain version, since the tensors lie
on the CPU).  JAX keys and torch generators never draw the same anchors, so
both sides get the same ``anchor_idx``.

Tolerances: calibrated parameters ≤ 1e-5 relative; the statistic panel
f32 ≤ 1e-5 scale-normalized; the quantile of 2^24 + 1 values equal to
numpy's up to one f32 rounding (1e-6 relative).  The metered budget is
exact: one n·m ``columns`` gather and nothing else (none for linear).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.kernelop import PairwiseKernel as JPairwise
from repro.kernels.pairwise import calibrate as jcal
from repro.kernels.pairwise import specs as jspecs
from repro_torch.core import spsd
from repro_torch.core.instrument import CountingOperator
from repro_torch.core.kernelop import PairwiseKernel
from repro_torch.kernels import pairwise as tpairwise
from repro_torch.kernels.pairwise import calibrate as tcal
from repro_torch.kernels.pairwise import specs as tspecs

NAMES = ("laplacian", "linear", "matern32", "polynomial", "rbf")
N, D = 257, 8
TOL_PARAM = 1e-5
TOL_F32 = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Six test workers share the CPU: keep torch's intra-op pool small;
    one small ``torch.exp`` first (see ROADMAP C, torch 2.13 CPU builds)."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    torch.exp(torch.zeros(64))
    yield
    torch.set_num_threads(old)


def _clustered(seed: int, n: int = N, d: int = D) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(6, d)) * 3.0
    labels = rng.integers(0, 6, size=n)
    return (centers[labels] + rng.normal(size=(n, d))).astype(np.float32)


ANCHORS = np.arange(3, N, 11)


def _close(a: float, b: float, rel: float) -> bool:
    return abs(a - b) <= rel * max(abs(a), abs(b), 1e-30)


def test_every_spec_has_a_rule_and_the_registry_is_the_ports():
    assert tcal.registered_calibrations() == tuple(sorted(NAMES))
    assert set(NAMES) <= set(jcal.registered_calibrations())


@pytest.mark.parametrize("name", NAMES)
def test_calibrate_sigma_matches_the_reference_at_one_gather(name):
    """Parameters equal the reference's on the same X and anchors, at a
    metered budget of ONE n×m statistic gather — exactly n·m entries, no
    sweep, no full — and no gather at all for linear."""
    X = _clustered(10)
    jspec = jspecs.suggested_spec(name, D)
    tspec = tspecs.suggested_spec(name, D)
    ref = jcal.calibrate_sigma(jnp.asarray(X), spec=jspec,
                               anchor_idx=jnp.asarray(ANCHORS),
                               use_pallas=True)
    stat_op = CountingOperator(PairwiseKernel(
        X, tspecs.stat_only(tspec), device="cpu"))
    got = tcal.calibrate_sigma(X, spec=tspec, anchor_idx=ANCHORS,
                               stat_op=stat_op)

    assert stat_op.counts["sweeps"] == 0 and stat_op.counts["fulls"] == 0
    if tcal.calibration_rule(name).needs_stat:
        assert stat_op.counts["columns"] == 1
        assert stat_op.counts["entries"] == N * len(ANCHORS)
    else:
        assert stat_op.counts["columns"] == 0
        assert stat_op.counts["entries"] == 0
    assert got.name == ref.name
    assert [k for k, _ in got.params] == [k for k, _ in ref.params]
    for (k, v1), (_, v2) in zip(got.params, ref.params):
        if v1 is None or v2 is None:
            assert v1 == v2, k
        else:
            assert _close(float(v1), float(v2), TOL_PARAM), (name, k, v1, v2)


@pytest.mark.parametrize("name", NAMES)
def test_calibrate_sigma_by_name_builds_its_own_stat_operator(name):
    """The default route (no ``stat_op``): the statistic operator is made
    from X on the requested device; by name and by spec agree."""
    X = _clustered(11)
    a = tcal.calibrate_sigma(X, spec=name, anchor_idx=ANCHORS, device="cpu")
    b = tcal.calibrate_sigma(torch.as_tensor(X), spec=tspecs.get_spec(name),
                             anchor_idx=ANCHORS, device="cpu",
                             use_kernel=False)
    assert a == b


@pytest.mark.parametrize("name", ("laplacian", "polynomial", "rbf"))
def test_stat_operator_shares_data_and_meters_one_gather(name):
    """``stat_operator()``: the identity-entry operator over the spec's
    statistic on the same data, routing and device; its n×m panel equals
    the reference's ``stat_operator().columns``."""
    X = _clustered(12)
    spec = tspecs.suggested_spec(name, D)
    op = PairwiseKernel(X, spec, use_kernel=False, device="cpu")
    st = op.stat_operator()
    assert st.spec is tspecs.stat_only(spec)
    assert st.X is op.X and st.use_kernel is False
    assert st.device == op.device
    opc = CountingOperator(st)
    panel = opc.columns(torch.as_tensor(ANCHORS))
    assert opc.counts == {**opc.counts, "columns": 1,
                          "entries": N * len(ANCHORS), "sweeps": 0}
    ref = JPairwise(jnp.asarray(X), jspecs.suggested_spec(name, D),
                    True).stat_operator().columns(jnp.asarray(ANCHORS))
    ref = np.asarray(ref)
    err = np.abs(panel.numpy() - ref).max() / np.abs(ref).max()
    assert err <= TOL_F32, err


def test_anchor_indices_are_distinct_and_drawn_from_the_generator():
    g1 = torch.Generator().manual_seed(4)
    g2 = torch.Generator().manual_seed(4)
    a = tcal.anchor_indices(g1, 1000, 128)
    assert a.shape == (128,) and len(set(a.tolist())) == 128
    assert torch.equal(a, tcal.anchor_indices(g2, 1000, 128))
    assert tcal.anchor_indices(torch.Generator().manual_seed(4), 50,
                               128).shape == (50,)
    X = _clustered(13)
    s1 = tcal.calibrate_sigma(X, anchors=64, device="cpu",
                              generator=torch.Generator().manual_seed(1))
    s2 = tcal.calibrate_sigma(X, anchors=64, device="cpu",
                              generator=torch.Generator().manual_seed(1))
    assert s1 == s2


def test_stat_quantile_beyond_torch_quantiles_limit():
    """2^24 + 1 = 97 × 172,961 statistic values: ``torch.quantile``
    refuses them; the port's quantile equals numpy's over the same panel
    (numpy given an f64 q, so that its index arithmetic is f64 too)."""
    n, m = 172_961, 97
    assert n * m == 2 ** 24 + 1
    rng = np.random.default_rng(3)
    X = rng.normal(size=(n, 4)).astype(np.float32)
    op = PairwiseKernel(X, tspecs.stat_only("sqdist"), device="cpu")
    anchors = np.arange(0, n, n // m)[:m]
    panel = op.columns(torch.as_tensor(anchors))
    assert panel.numel() == 2 ** 24 + 1
    with pytest.raises(RuntimeError):
        torch.quantile(panel.reshape(-1), 0.5)
    vals = panel.numpy().reshape(-1)
    for q in (0.5, 0.1, 0.9):
        got = float(tcal.stat_quantile(op, q=q, anchor_idx=anchors))
        want = float(np.quantile(vals, np.float64(q)))
        assert _close(got, want, 1e-6), (q, got, want)


@pytest.mark.parametrize("q", (0.0, 0.25, 0.5, 0.731, 1.0))
def test_quantile_matches_numpy_on_small_panels(q):
    rng = np.random.default_rng(int(q * 1000))
    v = rng.normal(size=(57, 13)).astype(np.float32)
    got = float(tcal.quantile(torch.as_tensor(v), q))
    assert _close(got, float(np.quantile(v, np.float64(q))), 1e-6)


def test_a_port_rule_stays_out_of_the_reference_registry():
    """Registering in the port touches only the port's registry."""
    name = "port_only_fixture"

    @tcal.register_calibration(name)
    def _rule(stat_q, base):
        return base

    try:
        assert name in tcal.registered_calibrations()
        assert name not in jcal.registered_calibrations()
        assert name not in jcal._RULES
    finally:
        tcal._RULES.pop(name)


def test_unknown_family_raises_with_the_registered_names():
    spec = tspecs.KernelSpec("no_rule", "sqdist", lambda t: t)
    with pytest.raises(ValueError, match="register_calibration"):
        tcal.calibrate_sigma(_clustered(14), spec=spec, device="cpu")


def test_package_reexports():
    assert tpairwise.calibrate_sigma is tcal.calibrate_sigma
    assert tpairwise.register_calibration is tcal.register_calibration
    assert tpairwise.stat_quantile is tcal.stat_quantile


@pytest.mark.parametrize("name", NAMES)
def test_calibrated_specs_drive_the_fast_model(name):
    """A calibrated spec drops straight into the fast model."""
    X = _clustered(15, n=300)
    spec = tcal.calibrate_sigma(X, spec=tspecs.suggested_spec(name, D),
                                anchors=64, device="cpu",
                                generator=torch.Generator().manual_seed(2))
    op = PairwiseKernel(X, spec, device="cpu")
    ap = spsd.fast_model(op, 12, 48, s_sketch="gaussian",
                         generator=torch.Generator().manual_seed(3))
    err = float(spsd.relative_error(op, ap, method="dense"))
    assert np.isfinite(err) and err < 1.0, (name, err)
