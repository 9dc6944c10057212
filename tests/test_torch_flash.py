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

The card's bf16 route runs a tensor-core kernel that rounds P to bf16 for
the PV product (the reference keeps f32 p).  ``_tc_emulation`` repeats that
arithmetic in plain torch -- online softmax in f32 per 64-key tile, P
rounded to bf16 before the PV product, f32 accumulation, the output rounded
to bf16 -- and is held to the reference at every shape above within the bf16
gate, and to an f64 oracle at a served-width case within the card's 1e-2
per-row relative gate: the precision contract is checked here before any
chip time.
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


def test_tma_strides_of_the_tensor_core_route():
    """The strides the wrapper hands to TMA: batch, head and row strides in
    elements, a packed one for an axis of length 1, and ValueError for a
    misaligned base or a stride that is not a multiple of 16 bytes."""
    act = torch.zeros((2, 70, 4, 64), dtype=torch.bfloat16).transpose(1, 2)
    assert tfa_kernel.tma_strides(act, "q") == (70 * 4 * 64, 64, 4 * 64)
    one = torch.zeros((1, 2, 1, 32), dtype=torch.bfloat16)
    assert tfa_kernel.tma_strides(one, "q") == (64, 32, 32)
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        tfa_kernel.tma_strides(torch.zeros((1, 2, 3, 36),
                                           dtype=torch.bfloat16), "k")
    flat = torch.zeros(1 + 2 * 3 * 64, dtype=torch.bfloat16)
    shifted = flat[1:].view(1, 2, 3, 64)
    assert shifted.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="16-byte aligned base"):
        tfa_kernel.tma_strides(shifted, "v")


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
    assert tfa_kernel.launch_counts() == {"flash_attention": 0,
                                          "flash_attention_tc": 0}


# ---------------------------------------------------------------------------
# the tensor-core kernel's precision contract, emulated on the CPU
# ---------------------------------------------------------------------------

def _tc_emulation(q, k, v, causal=True, window=None, q_pos=None, bk=64):
    """What ``csrc/flash_wgmma.cu`` computes, in plain torch: s = q·kᵀ in f32
    (products of bf16 values are exact in f32) times the f32 scale; per
    ``bk``-key tile the reference's online softmax in f32 (m from −inf,
    m_safe, alpha, l += the f32 p); P rounded to bf16 (RNE) for the PV
    product, accumulated in f32; acc / max(l, 1e-30) rounded to bf16."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    kr = torch.repeat_interleave(k.float(), G, dim=1)
    vr = torch.repeat_interleave(v.float(), G, dim=1)
    scale = torch.tensor(tfa_kernel.softmax_scale(D), dtype=torch.float32)
    s_all = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) * scale
    if q_pos is None:
        q_pos = torch.arange(Sq) + (Sk - Sq)
    row = q_pos[:, None]
    m = torch.full((B, Hq, Sq, 1), float("-inf"))
    l = torch.zeros((B, Hq, Sq, 1))
    acc = torch.zeros((B, Hq, Sq, v.shape[3]))
    for j0 in range(0, Sk, bk):
        col = torch.arange(j0, min(j0 + bk, Sk))[None, :]
        mask = torch.ones((Sq, col.shape[1]), dtype=torch.bool)
        if causal:
            mask &= col <= row
        if window is not None:
            mask &= (row - col) < window
        s = torch.where(mask, s_all[..., j0:j0 + bk], float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.where(mask, torch.exp(s - m_safe), 0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = alpha * acc + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(),
            vr[:, :, j0:j0 + bk])
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(torch.bfloat16)


_TC_CASES = [(shape, None) for shape in FLASH_SHAPES] + \
    [((1, 2, 2, 256, 256, 32), w) for w in (16, 64, 200)]


@pytest.mark.parametrize("shape,window", _TC_CASES)
def test_tensor_core_arithmetic_fits_the_bf16_gate(shape, window):
    """bf16 P in the PV product, emulated, against the Pallas kernel in
    interpret mode and ``ref.attention`` at every reference shape and
    window, within the reference's rtol = atol = 2e-2."""
    seed = 0 if window is None else 1
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(*shape, seed=seed), "bf16")
    emu = _tc_emulation(tq, tk, tv, causal=True, window=window)
    assert emu.dtype == torch.bfloat16 and tuple(emu.shape) == tuple(tq.shape)
    _assert_close(emu, jfa_ops.flash_attention(jq, jk, jv, causal=True,
                                               window=window),
                  "bf16", f"emulation window {window} vs Pallas (interpret)")
    _assert_close(emu, jfa_ref.attention(jq, jk, jv, causal=True,
                                         window=window),
                  "bf16", f"emulation window {window} vs ref.attention")


@pytest.mark.parametrize("window", [None, 1024])
def test_tensor_core_arithmetic_at_served_width(window):
    """One kv head, 2 query heads, S = 4,096, D = 256 with unit-variance q
    and k (what qk-norm gives): 64 sampled rows of the emulation against an
    f64 oracle within the card's per-row relative gate of 1e-2."""
    S, D, n_rows = 4096, 256, 64
    rng = np.random.default_rng(11)
    q = torch.as_tensor(rng.normal(size=(1, 2, S, D)), dtype=torch.bfloat16)
    k = torch.as_tensor(rng.normal(size=(1, 1, S, D)), dtype=torch.bfloat16)
    v = torch.as_tensor(rng.normal(size=(1, 1, S, D)), dtype=torch.bfloat16)
    rows = torch.as_tensor(np.sort(rng.choice(S, n_rows, replace=False)))
    emu = _tc_emulation(q[:, :, rows], k, v, causal=True, window=window,
                        q_pos=rows)
    s = torch.einsum("bhqd,bkd->bhqk", q[:, :, rows].double(),
                     k[:, 0].double()) / np.sqrt(D)
    col = torch.arange(S)[None, :]
    mask = col <= rows[:, None]
    if window is not None:
        mask &= (rows[:, None] - col) < window
    s = torch.where(mask, s, float("-inf"))
    exact = torch.einsum("bhqk,bkd->bhqd", torch.softmax(s, dim=-1),
                         v[:, 0].double())
    rel = (emu.double() - exact).norm(dim=-1) / exact.norm(dim=-1)
    assert float(rel.max()) <= 1e-2, float(rel.max())
