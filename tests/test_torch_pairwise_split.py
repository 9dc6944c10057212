"""The numerics of the tensor-core pairwise kernels, emulated on the CPU.

``csrc/pairwise_wgmma.cu`` computes, under the f32 policy,

- the cross term x·y of the dot and sqdist statistics in split TF32: each
  point as hi = tf32(x), lo = tf32(x − hi), and per 32-feature chunk four
  passes lo·lo + hi·lo + lo·hi + hi·hi into a fresh f32 sum that is added
  into the statistic, then the combine max((xx + yy) − 2 x·y, 0) with f32
  norms;
- sqdist's near pairs: where that combine is below NEAR_TAU (xx + yy), the
  entry again as Σ (x_k − y_k)² in feature order, one FMA a feature, each
  point read as hi + lo (``sq_near``);
- the sweep's contraction K @ V in four TF32 passes per 64-key tile, hi·Vhi
  + hi·Vlo + lo·Vhi + rem·Vhi, where hi, lo, rem are the entry's three TF32
  parts and Vhi, Vlo V's two, each tile's sum added into a running f32 sum;
  V's keys are stored permuted within each group of 8 (0, 2, 4, 6, 1, 3, 5,
  7) so the statistic's accumulator is the contraction's A fragment.

TF32 rounding is ``cvt.rna.tf32.f32``: round to nearest, ties away from
zero, the 13 low mantissa bits cleared; emulated here on the int32 view.
The products of TF32 parts are exact in f32; each pass is summed here in
feature order, so a pair's statistic depends on its two points alone, as
the kernels' does.  The card's tensor cores add in their own order (and
flush subnormal inputs), which the card tests cover.  An FMA is emulated in
f64 and rounded once to f32 (exact up to a rare double rounding).

What is shown here (tolerances stated per test):
(a) the parts of an f32 value sum back to it exactly;
(b) the emulated contraction returns a one-hot column bit for bit;
(c) the emulated contraction is within 1e-5 of the f64 contraction;
(d) the emulated split-TF32 statistic is within TOL["f32"] = 1e-5 of the
    f32 plain statistic;
(e) on quickstart's data the combine alone cancels at the points' norms
    (however exact its cross term), and the near pairs repair it.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import sketched_attention as tsa
from repro_torch.kernels.pairwise import kernel, specs

TOL = {"f32": 1e-5}
TOL_F64 = 1e-5       # the emulated f32 contraction against f64 (chip_smoke's
                     # gate for B1 at the main shape)
BK = 64              # keys of a tile: one running-sum add per tile
CHUNK = 32           # features of a chunk: one statistic add per chunk


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    torch.exp(torch.zeros(64))
    yield
    torch.set_num_threads(old)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32, as the kernels compute it: add half of the 13
    dropped bits to the magnitude (sign-magnitude, so on the raw bits),
    then clear them; inf and NaN stay as they are."""
    raw = x.contiguous().view(torch.int32)
    b = raw.to(torch.int64) & 0xFFFFFFFF
    b = (b + 0x1000) & 0xFFFFE000
    b = torch.where(b >= 2 ** 31, b - 2 ** 32, b).to(torch.int32)
    special = (raw & 0x7F800000) == 0x7F800000
    return torch.where(special, raw, b).view(torch.float32)


def split2(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def split3(x: torch.Tensor):
    hi = tf32(x)
    r1 = x - hi
    lo = tf32(r1)
    return hi, lo, r1 - lo


def low_bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32) & 0x1FFF


#: the row and key parts (0 = hi, 1 = lo, 2 = rem) of each pass of the
#: cross term, small ones first: the kernels' four, and a three-part
#: variant's six
PASSES = {2: ((1, 1), (0, 1), (1, 0), (0, 0)),
          3: ((1, 1), (2, 0), (0, 2), (0, 1), (1, 0), (0, 0))}


def fma_sum_sq(diffs) -> torch.Tensor:
    """Σ_k diffs[k]² in order, one f32 FMA a term (emulated in f64)."""
    acc = torch.zeros_like(diffs[0])
    for df in diffs:
        acc = (df.double() * df.double() + acc.double()).float()
    return acc


def cross_split(Xr: torch.Tensor, Xc: torch.Tensor,
                parts: int = 2) -> torch.Tensor:
    """x·y from the TF32 parts: per 32-feature chunk the passes, each
    summed in feature order into the chunk's fresh f32 sum, the chunk's sum
    added into the statistic."""
    split = split3 if parts == 3 else split2
    rp = [p.T.contiguous() for p in split(Xr)]     # features first
    cp = [p.T.contiguous() for p in split(Xc)]
    cross = torch.zeros((Xr.shape[0], Xc.shape[0]), dtype=torch.float32)
    for f0 in range(0, Xr.shape[1], CHUNK):
        part = torch.zeros_like(cross)
        for pr, pc in PASSES[parts]:
            for k in range(f0, min(f0 + CHUNK, Xr.shape[1])):
                # a product of TF32 values is exact in f32: one rounding
                part.addcmul_(rp[pr][k, :, None], cp[pc][k, None, :])
        cross = cross + part
    return cross


def stat_split(stat: str, Xr: torch.Tensor, Xc: torch.Tensor,
               parts: int = 2, exact_cross: bool = False,
               near: bool = True) -> torch.Tensor:
    """The statistic as the kernels compute it under the f32 policy:
    ``parts`` TF32 parts of the cross term (or, ``exact_cross``, the f64
    x·y rounded once), the norms by FMAs in feature order, the combine,
    then (``near``) the near pairs summed again directly from hi + lo."""
    cross = (Xr.double() @ Xc.double().T).float() if exact_cross \
        else cross_split(Xr, Xc, parts)
    if stat == "dot":
        return cross
    xx, yy = fma_sum_sq(Xr.T), fma_sum_sq(Xc.T)
    nn = xx[:, None] + yy[None, :]
    D = torch.clamp(nn - 2.0 * cross, min=0.0)
    if near:
        i, j = torch.nonzero(D < kernel.NEAR_TAU * nn, as_tuple=True)
        xr, xc = (sum(split2(X)) for X in (Xr, Xc))
        D[i, j] = fma_sum_sq((xr[i] - xc[j]).T)
    return D


def entries_split(spec, Xr, Xc):
    """B2's entries: the split statistic (l1dist stays a direct f32 sum),
    then the entry function."""
    if spec.stat == "l1dist":
        return specs.apply(spec, Xr, Xc)
    return spec.entry_fn(stat_split(spec.stat, Xr, Xc))


def contract_split(K: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """The sweep's contraction: per 64-key tile four passes into a tile sum,
    the tile sum added into the running f32 sum."""
    vh, vl = split2(V)
    kh, kl, kr = split3(K)
    out = torch.zeros((K.shape[0], V.shape[1]), dtype=torch.float32)
    for k0 in range(0, K.shape[1], BK):
        s = slice(k0, k0 + BK)
        acc = kh[:, s] @ vh[s]
        acc = acc + kh[:, s] @ vl[s]
        acc = acc + kl[:, s] @ vh[s]
        acc = acc + kr[:, s] @ vh[s]
        out = out + acc
    return out


def _specs(d):
    return [specs.suggested_spec(name, d)
            for name in specs.registered_kernels()]


def _data(rng, n, d, scale=1.0):
    return torch.as_tensor(rng.normal(size=(n, d)) * scale,
                           dtype=torch.float32)


def test_parts_sum_back_exactly():
    """(a) hi + lo + rem == x bit for bit, x − hi exact, and each part a
    TF32 value for |x| ≥ 2^-104, over random values of every exponent,
    subnormals, ±0, 1 and the largest values below powers of two."""
    rng = np.random.default_rng(0)
    mant = rng.uniform(1.0, 2.0, size=4000)
    expo = rng.integers(-149, 120, size=4000)
    vals = np.concatenate([
        mant * np.exp2(expo.astype(np.float64)) * rng.choice([-1, 1], 4000),
        [0.0, -0.0, 1.0, -1.0, 2.0 ** -149, 2.0 ** -130, -(2.0 ** -127),
         float(np.float32(1.17e-38))],
        [np.nextafter(np.float32(2.0) ** k, np.float32(0))
         for k in range(-120, 120, 7)],
        rng.normal(size=2000)])
    x = torch.as_tensor(vals.astype(np.float32))
    hi, lo, rem = split3(x)
    assert torch.equal((hi + lo) + rem, x)
    assert torch.equal(x.double() - hi.double(), (x - hi).double())
    # each part is a TF32 value wherever the tensor cores can take it: for
    # |x| ≥ 2^-104 the smallest part stays normal; below, a part is
    # subnormal and the card flushes it (< 2^-126, the card tests' contract)
    normal = x.abs() >= 2.0 ** -104
    for part in (hi, lo, rem):
        assert bool((low_bits(part[normal]) == 0).all())
    # inf and NaN pass through; a tie rounds away from zero
    odd = tf32(torch.tensor([float("inf"), -float("inf"), float("nan")]))
    assert odd[0] == float("inf") and odd[1] == -float("inf")
    assert bool(torch.isnan(odd[2]))
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert torch.equal(tf32(tie), torch.tensor([1.0 + 2.0 ** -10,
                                                -(1.0 + 2.0 ** -10)]))


@pytest.mark.parametrize("d", [16, 256])
def test_one_hot_gather_is_exact(d):
    """(b) against a 0/1 column every product but the entry's own parts is
    an exact 0, and the parts add back exactly: the contraction returns the
    block's entries bit for bit, for every registered spec and the softmax
    Gram's exp_affine."""
    rng = np.random.default_rng(1)
    Xr, Xc = _data(rng, 90, d, 0.4), _data(rng, 700, d, 0.4)
    gidx = rng.choice(700, 33, replace=False)
    onehot = torch.zeros((700, 33), dtype=torch.float32)
    onehot[gidx, np.arange(33)] = 1.0
    soft = tsa.softmax_gram_operator(torch.cat([Xr, Xc])).spec
    for spec in _specs(d) + [soft]:
        K = entries_split(spec, Xr, Xc)
        assert torch.equal(contract_split(K, onehot), K[:, gidx]), spec


@pytest.mark.parametrize("d", [16, 256])
def test_contraction_within_1e5_of_f64(d):
    """(c) 300 rows, 3,000 keys, M = 300 (a one-hot block, Gaussian and
    Rademacher columns, as the fused sweep's): the emulated statistic and
    contraction against the f64 contraction of the f32 plain entries,
    scale-normalized, within 1e-5; every registered spec, and exp_affine
    at d = 256."""
    rng = np.random.default_rng(2)
    scale = 1.0 if d == 16 else 0.4
    Xr, Xc = _data(rng, 300, d, scale), _data(rng, 3000, d, scale)
    V = torch.cat([torch.eye(3000, 100)[rng.permutation(3000)],
                   _data(rng, 3000, 136),
                   torch.as_tensor(rng.choice([-1.0, 1.0], (3000, 64)),
                                   dtype=torch.float32)], dim=1)
    cases = _specs(d)
    if d == 256:
        cases = cases + [tsa.softmax_gram_operator(
            torch.cat([Xr, Xc])).spec]
    for spec in cases:
        got = contract_split(entries_split(spec, Xr, Xc), V)
        exact = specs.apply(spec, Xr, Xc).double() @ V.double()
        err = float((got.double() - exact).abs().max()
                    / exact.abs().max())
        assert err <= TOL_F64, (spec, err)


@pytest.mark.parametrize("d", [16, 256])
def test_split_statistic_within_f32_tolerance(d):
    """(d) the split-TF32 statistic and the entries built on it against the
    f32 plain version (max |got − plain| / max |plain| ≤ TOL["f32"])."""
    rng = np.random.default_rng(3)
    scale = 1.0 if d == 16 else 0.4
    Xr, Xc = _data(rng, 200, d, scale), _data(rng, 900, d, scale)
    for stat in ("dot", "sqdist"):
        got = stat_split(stat, Xr, Xc)
        want = specs.stat_block(stat, Xr, Xc)
        assert float((got - want).abs().max() / want.abs().max()) \
            <= TOL["f32"], stat
    for spec in _specs(d):
        got, want = entries_split(spec, Xr, Xc), specs.apply(spec, Xr, Xc)
        assert float((got - want).abs().max() / want.abs().max()) \
            <= TOL["f32"], spec


def test_key_permutation_is_the_a_fragment():
    """The accumulator of n8 block j holds, in lane l, keys 8 j + 2 (l % 4)
    + {0, 1}; TF32's A fragment of k8 step j wants logical columns l % 4 and
    l % 4 + 4.  Reading keys 2 q and 2 q + 1 as columns q and q + 4, with
    V's keys stored in the order 0, 2, 4, 6, 1, 3, 5, 7 (prep_rhs), is the
    same product."""
    perm = [0, 2, 4, 6, 1, 3, 5, 7]
    # every lane's two accumulator keys land on its two fragment columns
    for q in range(4):
        assert perm[q] == 2 * q and perm[q + 4] == 2 * q + 1
    rng = np.random.default_rng(4)
    K, V = _data(rng, 64, 128), _data(rng, 128, 40)
    order = torch.as_tensor([8 * g + p for g in range(16) for p in perm])
    A = K[:, order]                  # column 8 g + l holds key 8 g + perm[l]
    B = V[order]                     # V^T's stored key order, transposed
    assert torch.allclose(A @ B, K @ V, rtol=1e-5, atol=1e-5)


def _quickstart(n: int, cols: int, seed: int = 0):
    """``examples/quickstart.py``'s data (32 centers 2·N(0, 1), spread
    0.5, d = 16) and ``cols`` columns drawn uniformly."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(32, 16)) * 2.0
    labels = rng.integers(0, 32, size=n)
    X = centers[labels] + rng.normal(size=(n, 16)) * 0.5
    idx = rng.choice(n, cols, replace=False)
    return torch.as_tensor(X, dtype=torch.float32), torch.as_tensor(idx)


@pytest.fixture(scope="module")
def quickstart_c():
    X, idx = _quickstart(5000, 200)
    return X, idx, torch.cdist(X.double(), X[idx].double()) ** 2


def _rbf_err(sigma, D, D64) -> float:
    """max |rbf(D) − rbf(D64)| / max rbf(D64), the entries in f32."""
    want = torch.exp(-D64 / (2.0 * sigma ** 2))
    got = specs.rbf(sigma).entry_fn(D).double()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("form", ["two_parts", "three_parts", "exact_cross"])
def test_combine_cancels_at_the_norms(quickstart_c, form):
    """(e) C = K(X, X[idx]) of rbf at σ = 1 on quickstart's data (n =
    5,000, 200 columns): the combine alone reads ≥ 1e-5 from the f64
    statistic's entries, with the kernels' two TF32 parts, with three, and
    with the exact cross term rounded once to f32.  The points' squared
    norms lie near 68, so ‖x‖² + ‖y‖² in [128, 256) rounds to 2^-16 =
    1.53e-5, and rbf passes γ = 0.5 of a near pair's error on: the cause is
    the combine, not the cross term.  (The plain version, the reference's
    combine, reads 1.53e-5 here too.)"""
    X, idx, D64 = quickstart_c
    kw = {"two_parts": {}, "three_parts": {"parts": 3},
          "exact_cross": {"exact_cross": True}}[form]
    D = stat_split("sqdist", X, X[idx], near=False, **kw)
    assert _rbf_err(1.0, D, D64) >= 1e-5


@pytest.mark.parametrize("sigma", [1.0, 3.0])
def test_near_pairs_repair_the_statistic(quickstart_c, sigma):
    """(e) With the near pairs (D0 < NEAR_TAU (xx + yy), 3.2 % of C's
    entries) summed again directly, C reads ≤ 1e-6 from the f64 statistic's
    entries at σ = 1 and 3, and every pair of a point with itself is
    exactly 0.  The plain version reads 1.53e-5 from f64 at σ = 1 and
    2.2e-6 at σ = 3 (its combine): it is not the yardstick here."""
    X, idx, D64 = quickstart_c
    D = stat_split("sqdist", X, X[idx])
    assert _rbf_err(sigma, D, D64) <= 1e-6
    assert bool((D[idx, torch.arange(idx.numel())] == 0).all())
    nn = torch.sum(X * X, 1)[:, None] + torch.sum(X[idx] * X[idx], 1)
    share = float((D64 < kernel.NEAR_TAU * nn.double()).double().mean())
    assert 0.02 < share < 0.05


def test_near_pairs_keep_the_gather_exact(quickstart_c):
    """(e) The emulated B1 one-hot gather of K(X[:600], X) @ P equals the
    emulated B2 block K(X[:600], X[idx]) bit for bit: a pair's statistic,
    near or not, depends on its two points alone."""
    X, idx, _ = quickstart_c
    rows = X[:600]
    onehot = torch.zeros((X.shape[0], idx.numel()), dtype=torch.float32)
    onehot[idx, torch.arange(idx.numel())] = 1.0
    spec = specs.rbf(1.0)
    gathered = contract_split(entries_split(spec, rows, X), onehot)
    assert torch.equal(gathered, entries_split(spec, rows, X[idx]))


def test_near_tau_matches_the_cuda_source():
    """``kernel.NEAR_TAU`` is the kernels' threshold."""
    src = (Path(kernel.__file__).parent / "csrc" / "pairwise_wgmma.cu"
           ).read_text()
    m = re.search(r"constexpr float NEAR_TAU = ([0-9.]+)f;", src)
    assert m and float(m.group(1)) == kernel.NEAR_TAU
