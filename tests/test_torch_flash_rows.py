"""Query rows that see no key: the port's flash attention (B6) on the CPU
against the JAX reference's Pallas kernel (interpret mode).

In the causal case with Sq > Sk the queries are right-aligned to the keys,
so query rows i < Sq − Sk sit before key 0 and see no key.  The reference's
kernel body returns 0 there (``m_safe`` and ``max(l, 1e-30)``); the port's
plain version must too, and must stay bit for bit what it was on every row
that does see a key.

Tolerances: f32 ≤ 1e-5 scale-normalized (max |port − ref| / max |ref|);
bf16 within rtol = atol = 2e-2 (the reference's ``_tol(bf16)``).  The empty
rows are exactly 0, and no output is NaN.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jfa_ops
from repro_torch.kernels.flash_attention import ops as tfa_ops
from repro_torch.kernels.flash_attention import ref as tfa_ref

# (B, Hq, Hkv, Sq, Sk, D, window): the case of ROADMAP §C1, and GQA with a
# window where the first 40 rows see no key
EMPTY_ROW_CASES = [
    (1, 2, 1, 4, 2, 8, None),
    (2, 4, 2, 100, 60, 16, 24),
]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL_F32 = 1e-5
TOL_BF16 = 2e-2


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Keep torch's intra-op pool small beside other test workers; one small
    ``torch.exp`` first (see ``tests/test_torch_flash.py``)."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    torch.exp(torch.zeros(64))
    yield
    torch.set_num_threads(old)


def _inputs(B, Hq, Hkv, Sq, Sk, D, seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(B, Hq, Sq, D)) * 0.5).astype(np.float32)
    k = (rng.normal(size=(B, Hkv, Sk, D)) * 0.5).astype(np.float32)
    v = rng.normal(size=(B, Hkv, Sk, D)).astype(np.float32)
    return q, k, v


def _unguarded(q, k, v, causal=True, window=None):
    """The plain version as it was before rows without a key were guarded
    (NaN there): every other row must come out bit for bit the same."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    f32 = torch.float32
    kr = torch.repeat_interleave(k, Hq // Hkv, dim=1)
    vr = torch.repeat_interleave(v, Hq // Hkv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(f32), kr.to(f32)) \
        / torch.sqrt(torch.tensor(float(D), dtype=f32))
    row = (torch.arange(Sq) + (Sk - Sq))[:, None]
    col = torch.arange(Sk)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool)
    if causal:
        mask &= col <= row
    if window is not None:
        mask &= (row - col) < window
    s = torch.where(mask[None, None], s, float("-inf"))
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = p / torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-30)
    return torch.einsum("bhqk,bhkd->bhqd", p, vr.to(f32)).to(q.dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", EMPTY_ROW_CASES)
def test_rows_without_keys_vs_reference(case, dtype):
    B, Hq, Hkv, Sq, Sk, D, window = case
    arrs = _inputs(B, Hq, Hkv, Sq, Sk, D)
    jdt, tdt = DTYPES[dtype]
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in arrs)
    tq, tk, tv = (torch.as_tensor(a).to(tdt) for a in arrs)
    port = tfa_ops.flash_attention(tq, tk, tv, causal=True, window=window)
    ref = np.asarray(jfa_ops.flash_attention(jq, jk, jv, causal=True,
                                             window=window), np.float32)
    got = port.float().numpy()
    assert not np.isnan(got).any()
    empty = Sq - Sk
    assert np.all(got[:, :, :empty] == 0.0)
    assert np.all(ref[:, :, :empty] == 0.0)
    if dtype == "f32":
        err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
        assert err <= TOL_F32, err
    else:
        np.testing.assert_allclose(got, ref, rtol=TOL_BF16, atol=TOL_BF16)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape,window", [
    ((1, 2, 1, 4, 2, 8), None), ((2, 4, 2, 100, 60, 16), 24),
    ((2, 8, 2, 128, 128, 32), None), ((1, 2, 2, 1, 256, 64), None),
    ((1, 4, 2, 64, 256, 32), 16)])
def test_rows_with_keys_unchanged(shape, window, dtype):
    B, Hq, Hkv, Sq, Sk, D = shape
    tdt = DTYPES[dtype][1]
    tq, tk, tv = (torch.as_tensor(a).to(tdt)
                  for a in _inputs(B, Hq, Hkv, Sq, Sk, D, seed=3))
    got = tfa_ref.attention(tq, tk, tv, causal=True, window=window)
    old = _unguarded(tq, tk, tv, causal=True, window=window)
    seen = max(0, Sq - Sk)
    assert torch.equal(got[:, :, seen:], old[:, :, seen:])
    assert not torch.isnan(got).any()
