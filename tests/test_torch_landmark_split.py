"""The numerics of the landmark read's two CUDA routes (B5), emulated on the
CPU and held to the reference.

``csrc/landmark_wgmma.cu`` (the tensor-core route) computes

- the scores S = Q·k_landᵀ per 128-byte feature chunk (32 f32 or 64 bf16
  features) in a fresh f32 sum that is added into S: f32 inputs in split
  TF32, each value as hi = tf32(x), lo = tf32(x − hi), three passes
  hi·lo + lo·hi + hi·hi; bf16 inputs in one pass, products exact;
- P = exp(S·inv − off) (two roundings), then per 64-landmark tile, in a
  fresh sum added into the running one: the numerator P·UV (f32: three
  passes lo·Vhi + hi·Vlo + hi·Vhi over P's and UV's TF32 parts; bf16: P
  rounded to bf16) and the denominator from the same rounded P (f32:
  hi + lo, exact in f32; bf16: bf16(P)) times the f32 U1;
- UVᵀ with the landmarks of each group of 8 stored in the order 0, 2, 4, 6,
  1, 3, 5, 7, so the scores' accumulator is the A fragment of P·UV.

``csrc/landmark_split.cu`` (the split route) forms, per run of 64-landmark
chunks, partial numerators and denominators in FP32, and adds the runs in
a fixed order.

TF32 rounding is ``cvt.rna.tf32.f32``: round to nearest, ties away from
zero, the 13 low mantissa bits cleared; emulated on the int32 view.
Products of TF32 parts are exact in f32, so an f32 matmul of the parts is
each pass up to the order of its sums; the card's tensor cores add in
their own order, which ``tests/test_torch_cuda.py`` covers on the card.

Gates: f32 ≤ 1e-5 scale-normalized (max |got − want| / max |want|) against
the reference's ``landmark_read`` (its Pallas kernel in interpret mode) and
against f64; bf16 inputs within the reference's rtol = atol = 2e-2.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.landmark_attention import ops as jlm_ops
from repro_torch.kernels.landmark_attention import kernel as lm_kernel
from repro_torch.kernels.landmark_attention.ref import inv_sqrt_d, \
    signed_floor

TOL_F32 = 1e-5
TOL_BF16 = 2e-2
BK = 64                     # landmarks of a tile / a split chunk
CHUNK = {torch.float32: 32, torch.bfloat16: 64}   # features of a chunk
PERM = (0, 2, 4, 6, 1, 3, 5, 7)
# the reference's test_landmark_read_vs_ref shapes, the main width at a
# small m, and the decode shape
SHAPES = [(128, 16, 64, 64), (200, 32, 32, 16), (64, 8, 128, 128),
          (1, 16, 64, 64), (64, 512, 256, 256), (16, 512, 256, 256)]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    torch.exp(torch.zeros(64))
    yield
    torch.set_num_threads(old)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on the raw bits: add half of the 13 dropped bits to
    the magnitude, then clear them; inf and NaN stay as they are."""
    raw = x.contiguous().view(torch.int32)
    b = raw.to(torch.int64) & 0xFFFFFFFF
    b = (b + 0x1000) & 0xFFFFE000
    b = torch.where(b >= 2 ** 31, b - 2 ** 32, b).to(torch.int32)
    special = (raw & 0x7F800000) == 0x7F800000
    return torch.where(special, raw, b).view(torch.float32)


def split2(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def scores_tc(Q, kl):
    """S as the tensor-core route builds it: per feature chunk the passes
    in a fresh sum, added into S."""
    S = torch.zeros((Q.shape[0], kl.shape[0]), dtype=torch.float32)
    step = CHUNK[Q.dtype]
    if Q.dtype == torch.bfloat16:
        passes = [(Q.float(), kl.float())]
    else:
        qh, ql = split2(Q)
        kh, klo = split2(kl)
        passes = [(qh, klo), (ql, kh), (qh, kh)]
    for f0 in range(0, Q.shape[1], step):
        f = slice(f0, f0 + step)
        part = torch.zeros_like(S)
        for a, b in passes:
            part = part + a[:, f] @ b[:, f].T
        S = S + part
    return S


def probs(S, d, off):
    return torch.exp(S * inv_sqrt_d(d) - off)


def read_tc(Q, kl, UV, U1, off, eps=1e-6):
    """The tensor-core route: per 64-landmark tile the numerator's passes
    and the denominator from the same rounded P, each tile's sum added into
    the running one."""
    P = probs(scores_tc(Q, kl), Q.shape[1], off)
    m, c, dv = Q.shape[0], kl.shape[0], UV.shape[1]
    num = torch.zeros((m, dv), dtype=torch.float32)
    den = torch.zeros((m,), dtype=torch.float32)
    if Q.dtype == torch.bfloat16:
        Pb = P.bfloat16().float()
        parts = [(Pb, UV.float())]
        Peff = Pb
    else:
        ph, pl = split2(P)
        vh, vl = split2(UV)
        parts = [(pl, vh), (ph, vl), (ph, vh)]
        Peff = ph + pl
    for k0 in range(0, c, BK):
        t = slice(k0, k0 + BK)
        acc = torch.zeros((m, dv), dtype=torch.float32)
        for a, b in parts:
            acc = acc + a[:, t] @ b[t]
        num = num + acc
        den = den + Peff[:, t] @ U1[t]
    return (num / signed_floor(den, eps)[:, None]).to(Q.dtype)


def read_split(Q, kl, UV, U1, off, per, eps=1e-6):
    """The split route: f32 scores, per run of `per` 64-landmark chunks a
    partial num/den, the runs added in order."""
    Qf, kf, Vf = Q.float(), kl.float(), UV.float()
    P = probs(Qf @ kf.T, Q.shape[1], off)
    num = den = None
    for k0 in range(0, kl.shape[0], per * BK):
        t = slice(k0, k0 + per * BK)
        pn, pd = P[:, t] @ Vf[t], P[:, t] @ U1[t]
        num = pn if num is None else num + pn
        den = pd if den is None else den + pd
    return (num / signed_floor(den, eps)[:, None]).to(Q.dtype)


def read_f64(Q, kl, UV, U1, off, eps=1e-6):
    d = Q.shape[1]
    P = torch.exp((Q.double() @ kl.double().T) / np.sqrt(d) - float(off))
    den = P @ U1.double()
    den = torch.where(den < 0, -1.0, 1.0).double() * den.abs().clamp_min(eps)
    return (P @ UV.double()) / den[:, None]


def inputs(m, c, d, dv, seed=3):
    """The inputs of the reference's ``test_landmark_read_vs_ref``."""
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(m, d)) * 0.5).astype(np.float32),
            (rng.normal(size=(c, d)) * 0.5).astype(np.float32),
            rng.normal(size=(c, dv)).astype(np.float32),
            (np.abs(rng.normal(size=(c,))) + 0.5).astype(np.float32),
            np.float32(0.3))


def reference(Q, kl, UV, U1, off, dtype):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    out = jlm_ops.landmark_read(jnp.asarray(Q).astype(jdt),
                                jnp.asarray(kl).astype(jdt),
                                jnp.asarray(UV).astype(jdt),
                                jnp.asarray(U1), jnp.asarray(off))
    return torch.as_tensor(np.array(out, np.float32))


def scaled(a, b) -> float:
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max())


def routes(m, c, dv):
    """Each route's emulation: the tensor-core route, the split route at
    one chunk a run and at the runs the wrapper picks on 132 SMs."""
    per, _ = lm_kernel.split_runs(m, c, dv, 132)
    return {"tc": read_tc,
            "split1": lambda *a: read_split(*a, per=1),
            f"split{per}": lambda *a: read_split(*a, per=per)}


@pytest.mark.parametrize("m,c,d,dv", SHAPES)
def test_f32_routes_match_reference_and_f64(m, c, d, dv):
    Q, kl, UV, U1, off = inputs(m, c, d, dv)
    want = reference(Q, kl, UV, U1, off, torch.float32)
    t = [torch.as_tensor(x) for x in (Q, kl, UV, U1)]
    exact = read_f64(*t, off)
    assert scaled(want, exact) <= TOL_F32
    for name, fn in routes(m, c, dv).items():
        got = fn(*t, torch.tensor(off))
        assert got.dtype == torch.float32 and got.shape == (m, dv)
        assert scaled(got, want) <= TOL_F32, name
        assert scaled(got, exact) <= TOL_F32, name


@pytest.mark.parametrize("m,c,d,dv", SHAPES)
def test_bf16_routes_match_reference(m, c, d, dv):
    """bf16 inputs: the tensor-core route rounds P to bf16 for P·UV and the
    denominator; the split route widens to f32 throughout."""
    Q, kl, UV, U1, off = inputs(m, c, d, dv)
    want = reference(Q, kl, UV, U1, off, torch.bfloat16)
    t = [torch.as_tensor(x).bfloat16() for x in (Q, kl, UV)]
    for name, fn in routes(m, c, dv).items():
        got = fn(*t, torch.as_tensor(U1), torch.tensor(off))
        assert got.dtype == torch.bfloat16 and got.shape == (m, dv)
        torch.testing.assert_close(got.float(), want, rtol=TOL_BF16,
                                   atol=TOL_BF16, msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,c,d,dv", [SHAPES[0], SHAPES[4], SHAPES[5]])
def test_u1_sign_flip_is_exact(m, c, d, dv, dtype):
    """Negating U1 negates every denominator term and nothing else, so the
    output of each route's emulation flips its sign exactly."""
    Q, kl, UV, U1, off = inputs(m, c, d, dv)
    t = [torch.as_tensor(x).to(dtype) for x in (Q, kl, UV)]
    u1, o = torch.as_tensor(U1), torch.tensor(off)
    for name, fn in routes(m, c, dv).items():
        assert torch.equal(fn(*t, -u1, o), -fn(*t, u1, o)), name


def test_parts_of_p_add_back_exactly():
    """The denominator multiplies U1 by hi + lo in f32: that sum is exact
    (hi + lo == its f64 value) and within 2^-21 of P."""
    rng = np.random.default_rng(5)
    P = torch.as_tensor(np.exp(rng.normal(size=20_000) * 3).astype(
        np.float32))
    hi, lo = split2(P)
    s = hi + lo
    assert torch.equal(s.double(), hi.double() + lo.double())
    assert float(((s.double() - P.double()).abs() / P.double()).max()) \
        <= 2.0 ** -21


def test_value_permutation_is_the_a_fragment():
    """The scores' accumulator of n8 block j holds, in lane l, landmarks
    8 j + 2 (l % 4) + {0, 1}; TF32's A fragment of k8 step j wants logical
    columns l % 4 and l % 4 + 4.  With UVᵀ's landmarks stored in the order
    0, 2, 4, 6, 1, 3, 5, 7 (prep_rhs), reading landmarks 2 q and 2 q + 1 as
    columns q and q + 4 is the same product."""
    for q in range(4):
        assert PERM[q] == 2 * q and PERM[q + 4] == 2 * q + 1
    rng = np.random.default_rng(4)
    P = torch.as_tensor(rng.random((64, 512)).astype(np.float32))
    UV = torch.as_tensor(rng.normal(size=(512, 40)).astype(np.float32))
    order = torch.as_tensor([8 * g + p for g in range(64) for p in PERM])
    assert torch.allclose(P[:, order] @ UV[order], P @ UV, rtol=1e-5,
                          atol=1e-5)


def test_route_rule():
    """The split route while its grid at one 64-landmark chunk a block,
    ceil(m/16)·ceil(dv/64)·ceil(c/64) blocks, is at most two waves of two
    blocks on each of 132 SMs — at c = 512, dv = 256: m ≤ 256 — and its
    landmark runs: 8 at a decode step of 16 queries (8 × 4 = 32 blocks),
    one run of all chunks once the rows alone fill the card (Q that TMA
    cannot load takes the split route at any m)."""
    assert not lm_kernel.tensor_core_route(16, 512, 256, 132)
    assert not lm_kernel.tensor_core_route(256, 512, 256, 132)
    assert lm_kernel.tensor_core_route(257, 512, 256, 132)
    assert lm_kernel.tensor_core_route(524_288, 512, 256, 132)
    assert not lm_kernel.tensor_core_route(4224, 100, 64, 132)
    assert lm_kernel.tensor_core_route(4225, 100, 64, 132)
    assert lm_kernel.split_runs(16, 512, 256, 132) == (1, 8)
    assert lm_kernel.split_runs(256, 512, 256, 132) == (2, 4)
    assert lm_kernel.split_runs(4096, 512, 256, 132) == (8, 1)


@pytest.mark.parametrize("m,c,dv", [(1, 16, 64), (16, 512, 256),
                                    (300, 130, 300), (4096, 512, 256),
                                    (16, 4000, 8)])
def test_split_runs_cover_every_chunk_once(m, c, dv):
    per, runs = lm_kernel.split_runs(m, c, dv, 132)
    chunks = -(-c // BK)
    assert per >= 1 and runs >= 1
    assert (runs - 1) * per < chunks <= runs * per
