"""The port's sketched (landmark) attention held against the JAX reference
(CPU).

Inputs are made with numpy from a seed and go through
``repro.core.sketched_attention`` / ``repro.kernels.landmark_attention``
(Pallas in interpret mode, as the reference's own tests run off-TPU) and
their counterparts in ``repro_torch`` (``device="cpu"``, so the plain
versions run).  The reference's random draws are recovered from its keys —
``select_landmarks`` and ``_sketch_indices`` / ``_extend_without_replacement``
called with the keys it splits — and handed to the port as numpy.

Tolerances, scale-normalized (max |port − ref| / max |ref|):

- landmark read (B5): f32 ≤ 1e-5; bf16 inputs within the reference's own
  ``_tol(bf16)`` (rtol = atol = 2e-2);
- ``exp_affine`` spec through B1 and B2: f32 ≤ 1e-5; bf16_f32acc ≤ 1e-2
  against the reference under the same policy;
- landmark state (UV, U1) and decode: ≤ 1e-4 (the pinv of nearly
  rank-deficient exp-score blocks amplifies the two SVD implementations'
  rounding); k_land exact; the offset ≤ 1e-6 relative; a decode of the
  reference's own state ≤ 1e-5;
- ``sketched_attention`` outputs: ≤ 1e-4, except Nyström over adaptive²
  landmarks ≤ 5e-3: its W has condition number 5.2e4 here, both sides' U
  sit ~1e-4 from the f64 pinv and their outputs 2.4e-3 apart (ROADMAP §C).
"""
from __future__ import annotations

import importlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.landmark_attention import ops as jlm_ops
from repro.kernels.pairwise import ops as jpw_ops
from repro_torch import convert
from repro_torch.core import sketched_attention as tsa
from repro_torch.kernels.landmark_attention import kernel as tlm_kernel
from repro_torch.kernels.landmark_attention import ops as tlm_ops
from repro_torch.kernels.pairwise import ops as tpw_ops

# ``repro.core`` re-exports the function ``sketched_attention``, which shadows
# the submodule attribute
jsa = importlib.import_module("repro.core.sketched_attention")

READ_SHAPES = [(128, 16, 64, 64), (200, 32, 32, 16), (64, 8, 128, 128),
               (1, 16, 64, 64)]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL_STATE = 1e-4
# Nyström with the reference's uniform_adaptive2 landmarks at the BENCH_pr10
# shape pseudo-inverts a W of condition number 5.2e4: the two f32 pinvs
# differ by 2.4e-3 scale-normalized on the output (ROADMAP §C, PR 12).
# That one case is held to twice that; every other case to TOL_STATE.
TOL_NYSTROM_ADAPTIVE2 = 5e-3


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Six test workers share the CPU: keep torch's intra-op pool small.
    The first multi-threaded ``torch.exp`` of a process can come out ~1e-4
    off (seen with torch 2.13 CPU builds); one small call first makes every
    later one exact."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    torch.exp(torch.zeros(64))
    yield
    torch.set_num_threads(old)


def scaled(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).numpy()


def qkv(seed: int, S: int, D: int, scale: float = 0.4):
    """The workloads bench's law: q, k ~ 0.4·N(0, 1), v ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(S, D)) * scale).astype(np.float32)
    k = (rng.normal(size=(S, D)) * scale).astype(np.float32)
    v = rng.normal(size=(S, D)).astype(np.float32)
    return q, k, v


def read_inputs(m, c, d, dv, seed=3):
    """The inputs of the reference's ``test_landmark_read_vs_ref``."""
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(m, d)) * 0.5).astype(np.float32),
            (rng.normal(size=(c, d)) * 0.5).astype(np.float32),
            rng.normal(size=(c, dv)).astype(np.float32),
            (np.abs(rng.normal(size=(c,))) + 0.5).astype(np.float32),
            np.float32(0.3))


# ---------------------------------------------------------------------------
# B5: the fused landmark read
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,c,d,dv", READ_SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_landmark_read_matches_reference(m, c, d, dv, dtype):
    jdt, tdt = DTYPES[dtype]
    Q, kl, UV, U1, off = read_inputs(m, c, d, dv)
    want = jlm_ops.landmark_read(
        jnp.asarray(Q).astype(jdt), jnp.asarray(kl).astype(jdt),
        jnp.asarray(UV).astype(jdt), jnp.asarray(U1), jnp.asarray(off))
    got = tlm_ops.landmark_read(
        torch.as_tensor(Q).to(tdt), torch.as_tensor(kl).to(tdt),
        torch.as_tensor(UV).to(tdt), torch.as_tensor(U1),
        torch.tensor(off))
    assert got.dtype == tdt and tuple(got.shape) == (m, dv)
    want = np.asarray(want, np.float32)
    if dtype == "f32":
        assert scaled(_np(got), want) <= 1e-5
    else:
        np.testing.assert_allclose(_np(got), want, rtol=2e-2, atol=2e-2)


def test_landmark_read_sign_flip_is_exact():
    """Negating (UV, U1) flips num and den together: the sign-preserving
    floor leaves the read unchanged (the reference's
    ``test_decode_and_kernel_read_sign_preserved``); a negated U1 alone
    flips the output's sign exactly."""
    Q, kl, UV, U1, off = (torch.as_tensor(x) for x in
                          read_inputs(128, 16, 64, 64))
    a = tlm_ops.landmark_read(Q, kl, UV, U1, off)
    assert torch.equal(tlm_ops.landmark_read(Q, kl, -UV, -U1, off), a)
    assert torch.equal(tlm_ops.landmark_read(Q, kl, UV, -U1, off), -a)
    assert tlm_kernel.launch_counts() == {"landmark_read": 0,
                                          "landmark_read_tc": 0,
                                          "landmark_read_split": 0}


def test_denominator_floor_keeps_sign_of_zero_and_nan():
    den = torch.tensor([-0.0, 0.0, -2e-7, 3e-7, -4.0, float("nan")])
    got = tsa.signed_den_floor(den)
    assert got[:5].tolist() == pytest.approx([1e-6, 1e-6, -1e-6, 1e-6,
                                              -4.0])
    assert torch.isnan(got[5])


# ---------------------------------------------------------------------------
# the exp_affine epilogue: the softmax-Gram spec through B1 and B2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prec", ["f32", "bf16_f32acc"])
def test_softmax_gram_spec_matches_reference(prec):
    rng = np.random.default_rng(4)
    d = 32
    X = (rng.normal(size=(350, d)) * 0.4).astype(np.float32)
    Xr, Xc = X[:150], X[150:]
    Vs = (rng.normal(size=(200, 3)).astype(np.float32),
          rng.normal(size=(200, 130)).astype(np.float32))
    op = tsa.softmax_gram_operator(torch.as_tensor(X))
    inv, off = op.spec.param("inv_sqrt_d"), op.spec.param("offset")
    # the reference's own offset rule
    assert off == round(float(jnp.max(jnp.sum(jnp.asarray(X) ** 2, axis=1)))
                        * (1.0 / float(d) ** 0.5), 3)
    assert op.spec.epilogue.kind == "exp_affine"
    jspec = jsa._softmax_gram_spec(inv, off).with_precision(prec)
    tspec = tsa._softmax_gram_spec(inv, off).with_precision(prec)
    tol = 1e-5 if prec == "f32" else 1e-2
    want = jpw_ops.kernel_block(jspec, jnp.asarray(Xr), jnp.asarray(Xc))
    got = tpw_ops.kernel_block(tspec, torch.as_tensor(Xr),
                               torch.as_tensor(Xc))
    assert scaled(_np(got), want) <= tol
    wants = jpw_ops.kernel_matmat_multi_rows(
        jspec, jnp.asarray(Xr), jnp.asarray(Xc),
        tuple(jnp.asarray(V) for V in Vs))
    gots = tpw_ops.kernel_matmat_multi_rows(
        tspec, torch.as_tensor(Xr), torch.as_tensor(Xc),
        tuple(torch.as_tensor(V) for V in Vs))
    for g, w in zip(gots, wants):
        assert scaled(_np(g), w) <= tol


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------

def _reference_state_draws(k, key, c, theta, selection):
    """The reference's own p_idx and skx for ``build_landmark_state``."""
    kp, ks = jax.random.split(key)
    p_idx = jsa.select_landmarks(k, kp, c, selection=selection)
    skx = jsa._extend_without_replacement(ks, p_idx, min(theta * c,
                                                         k.shape[0]),
                                          k.shape[0])
    return np.array(p_idx), np.array(skx)


@pytest.mark.parametrize("selection", ["strided", "leverage"])
def test_landmark_state_and_decode_match_reference(selection):
    S, D, c, theta = 256, 32, 32, 4
    _, k, v = qkv(2, S, D)
    q1 = (np.random.default_rng(5).normal(size=(8, D)) * 0.4).astype(
        np.float32)
    key = jax.random.PRNGKey(7)
    ref = jsa.build_landmark_state(jnp.asarray(k), jnp.asarray(v), key, c,
                                   theta, selection=selection)
    p_idx, skx = _reference_state_draws(jnp.asarray(k), key, c, theta,
                                        selection)
    st = tsa.build_landmark_state(k, v, c, theta, p_idx=p_idx, skx=skx,
                                  device="cpu")
    assert np.array_equal(_np(st.k_land), np.asarray(ref.k_land))
    assert abs(float(st.scale) - float(ref.scale)) <= \
        1e-6 * abs(float(ref.scale))
    assert scaled(_np(st.UV), ref.UV) <= TOL_STATE
    assert scaled(_np(st.U1), ref.U1) <= TOL_STATE

    want = jax.vmap(lambda qq: jsa.landmark_decode(ref, qq))(
        jnp.asarray(q1))
    same = convert.landmark_state_from_reference(
        *(np.array(x) for x in ref), device="cpu")
    assert scaled(_np(tsa.landmark_decode(same, torch.as_tensor(q1))),
                  want) <= 1e-5
    assert scaled(_np(tsa.landmark_decode(st, torch.as_tensor(q1))),
                  want) <= TOL_STATE
    one = tsa.landmark_decode(st, torch.as_tensor(q1[0]))
    assert tuple(one.shape) == (D,)
    assert scaled(_np(one), np.asarray(want)[0]) <= TOL_STATE


# ---------------------------------------------------------------------------
# the whole slice: sketched_attention in its three modes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("selection", ["strided", "uniform_adaptive2"])
@pytest.mark.parametrize("mode", ["fast", "nystrom", "prototype"])
def test_sketched_attention_matches_reference(mode, selection):
    """The BENCH_pr10 attention shape: S = 256, D = 32, c = 32, θ = 4."""
    S, D, c, theta = 256, 32, 32, 4
    q, k, v = qkv(0, S, D)
    key = jax.random.PRNGKey(1)
    want = jsa.sketched_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), key, c, theta, mode=mode,
                                  selection=selection)
    kp, kq, kk = jax.random.split(key, 3)
    p_idx = jsa.select_landmarks(jnp.asarray(k), kp, c, selection=selection)
    sq, skx = jsa._sketch_indices(kq, kk, p_idx, S, S, c, theta)
    got = tsa.sketched_attention(q, k, v, c, theta, mode=mode,
                                 p_idx=np.array(p_idx), sq=np.array(sq),
                                 skx=np.array(skx), device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == (S, D)
    tol = TOL_NYSTROM_ADAPTIVE2 if (mode, selection) == (
        "nystrom", "uniform_adaptive2") else TOL_STATE
    assert scaled(_np(got), want) <= tol


def test_rectangular_queries_and_port_draws():
    """m ≠ n takes the landmark keys as Qp and a plain row sample; the
    port's own draws give distinct sketch sets and finite outputs."""
    _, k, v = qkv(3, 192, 16)
    q = (np.random.default_rng(6).normal(size=(40, 16)) * 0.4).astype(
        np.float32)
    g = torch.Generator().manual_seed(0)
    out = tsa.sketched_attention(q, k, v, 24, 4, generator=g, device="cpu")
    assert tuple(out.shape) == (40, 16) and torch.isfinite(out).all()
    p_idx = tsa.landmark_indices(192, 24, torch.Generator().manual_seed(1))
    sq, skx = tsa._sketch_indices(p_idx, 40, 192, 24, 4,
                                  torch.Generator().manual_seed(2))
    assert len(set(skx.tolist())) == 96 and set(p_idx.tolist()) <= \
        set(skx.tolist())
    assert len(set(sq.tolist())) == 40 and int(sq.max()) < 40
    with pytest.raises(ValueError, match="unknown mode"):
        tsa.sketched_attention(q, k, v, 24, mode="exact", device="cpu")


def test_landmark_indices_clamp_to_n_with_a_warning():
    g = torch.Generator().manual_seed(0)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        idx = tsa.landmark_indices(16, 32, g)
    assert sorted(idx.tolist()) == list(range(16))
    assert any("clamping" in str(x.message) for x in w)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert len(set(tsa.landmark_indices(16, 16, g).tolist())) == 16
        idx = tsa.landmark_indices(100, 10, g)
    assert len(set(idx.tolist())) == 10 and int(idx.max()) < 100
