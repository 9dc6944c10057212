"""The port's flash attention (B6) held against the JAX reference (CPU).

Inputs are made with numpy from a seed and go through
``repro.kernels.flash_attention.ops.flash_attention`` (the Pallas kernel in
interpret mode, as ``tests/test_kernels.py`` runs it off-TPU), the
reference's ``ref.attention`` oracle, and the port's
``repro_torch.kernels.flash_attention.ops.flash_attention`` on CPU tensors
(its plain version).  The shapes are every shape of the reference's
``test_flash_vs_ref`` and ``test_flash_sliding_window``.

Tolerances: f32 ≤ 1e-5 scale-normalized (max |port − ref| / max |ref|);
bf16 within rtol = atol = 2e-2 (the reference's ``_tol(bf16)``).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jfa_ops
from repro.kernels.flash_attention import ref as jfa_ref
from repro_torch.kernels.flash_attention import kernel as tfa_kernel
from repro_torch.kernels.flash_attention import ops as tfa_ops
from repro_torch.kernels.flash_attention import ref as tfa_ref

FLASH_SHAPES = [
    (1, 4, 4, 128, 128, 64),      # MHA square
    (2, 8, 2, 128, 128, 32),      # GQA 4:1
    (1, 4, 1, 256, 256, 64),      # MQA
    (2, 4, 2, 100, 100, 32),      # ragged length
    (1, 2, 2, 1, 256, 64),        # decode: Sq = 1 right-aligned
    (1, 4, 2, 64, 256, 32),       # chunked prefill continuation
]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL_F32 = 1e-5
TOL_BF16 = 2e-2


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


def _inputs(B, Hq, Hkv, Sq, Sk, D, seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(B, Hq, Sq, D)) * 0.5).astype(np.float32)
    k = (rng.normal(size=(B, Hkv, Sk, D)) * 0.5).astype(np.float32)
    v = rng.normal(size=(B, Hkv, Sk, D)).astype(np.float32)
    return q, k, v


def _both(arrs, dtype):
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.as_tensor(a).to(tdt) for a in arrs])


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _assert_close(port, ref, dtype, label):
    p, r = _f32(port), _f32(ref)
    assert p.shape == r.shape, (label, p.shape, r.shape)
    if dtype == "f32":
        err = float(np.abs(p - r).max() / max(np.abs(r).max(), 1e-30))
        assert err <= TOL_F32, f"{label}: {err:.3g} > {TOL_F32}"
    else:
        np.testing.assert_allclose(p, r, rtol=TOL_BF16, atol=TOL_BF16,
                                   err_msg=label)


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_matches_reference(B, Hq, Hkv, Sq, Sk, D, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(B, Hq, Hkv, Sq, Sk, D), dtype)
    port = tfa_ops.flash_attention(tq, tk, tv, causal=True)
    assert port.dtype == tq.dtype and tuple(port.shape) == (B, Hq, Sq, D)
    _assert_close(port, jfa_ops.flash_attention(jq, jk, jv, causal=True),
                  dtype, "vs Pallas kernel (interpret)")
    _assert_close(port, jfa_ref.attention(jq, jk, jv, causal=True), dtype,
                  "vs ref.attention")


@pytest.mark.parametrize("window", [16, 64, 200])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_sliding_window_matches_reference(window, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(1, 2, 2, 256, 256, 32, 1),
                                       dtype)
    port = tfa_ops.flash_attention(tq, tk, tv, causal=True, window=window)
    _assert_close(port, jfa_ops.flash_attention(jq, jk, jv, causal=True,
                                                window=window),
                  dtype, f"window {window} vs Pallas kernel (interpret)")
    _assert_close(port, jfa_ref.attention(jq, jk, jv, causal=True,
                                          window=window), dtype,
                  f"window {window} vs ref.attention")


@pytest.mark.parametrize("shape", [(2, 4, 2, 100, 100, 32),
                                   (1, 4, 2, 64, 256, 32)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_non_causal_matches_reference(shape, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(*shape, seed=5), dtype)
    port = tfa_ops.flash_attention(tq, tk, tv, causal=False)
    _assert_close(port, jfa_ops.flash_attention(jq, jk, jv, causal=False),
                  dtype, "non-causal vs Pallas kernel (interpret)")
    _assert_close(port, jfa_ref.attention(jq, jk, jv, causal=False), dtype,
                  "non-causal vs ref.attention")


@pytest.mark.parametrize("window", [None, 24])
def test_query_positions_give_the_rows_of_the_full_call(window):
    """``q_pos`` computes a subset of query rows exactly as the full call
    does (the card check compares sampled rows this way)."""
    q, k, v = (torch.as_tensor(a) for a in _inputs(2, 4, 2, 96, 160, 32, 2))
    full = tfa_ref.attention(q, k, v, causal=True, window=window)
    rows = torch.tensor([0, 5, 63, 64, 95])
    part = tfa_ref.attention(q[:, :, rows], k, v, causal=True, window=window,
                             q_pos=rows + (160 - 96))
    assert torch.equal(part, full[:, :, rows])


def test_strided_views_and_the_launch_counter():
    """The model hands (B, S, H, D) activations over as (B, H, S, D) views;
    on the CPU they go to the plain version, and the kernel's counter does
    not move."""
    q, k, v = (torch.as_tensor(a) for a in _inputs(1, 4, 2, 48, 48, 16, 3))
    views = [x.transpose(1, 2).contiguous().transpose(1, 2)
             for x in (q, k, v)]
    assert not views[0].is_contiguous()
    before = tfa_kernel.launch_counts()
    out = tfa_ops.flash_attention(*views, causal=True)
    assert tfa_kernel.launch_counts() == before
    assert torch.equal(out, tfa_ops.flash_attention(q, k, v, causal=True))


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    q, k, v = (torch.as_tensor(a) for a in _inputs(1, 2, 1, 8, 8, 16, 4))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa_kernel.flash_attention_cuda(q, k, v)
    with pytest.raises(TypeError, match="dtype"):
        tfa_kernel.flash_attention_cuda(q.double(), k.double(), v.double())
    wide = torch.zeros((1, 2, 8, 512))
    with pytest.raises(ValueError, match="head dims"):
        tfa_kernel.flash_attention_cuda(wide, wide[:, :1], wide[:, :1])
    with pytest.raises(ValueError, match="multiple"):
        tfa_kernel.flash_attention_cuda(q[:, :1], torch.cat([k, k], 1),
                                        torch.cat([v, v], 1))
    with pytest.raises(ValueError, match="window"):
        tfa_kernel.flash_attention_cuda(q, k, v, window=0)
    assert tfa_kernel.launch_counts() == {"flash_attention": 0}
