"""The gradient of the port's flash attention held against the JAX
reference (CPU): ``grad.attention_vjp`` against ``jax.vjp`` of the
reference's oracle ``repro.kernels.flash_attention.ref.attention`` and of
its training attention ``repro.models.attention._sdpa`` (the einsum path
``attn_impl="xla"`` that the reference differentiates), and against torch
autograd of the port's plain version.

``ops.flash_attention`` goes through ``grad.FlashAttention`` (the B6
forward, ``attention_vjp`` backward) when grad mode is on and an input
requires grad; otherwise it is today's call, bit for bit, with no autograd
node.

Shapes: every shape of ``test_torch_flash.py`` (MHA, GQA, MQA, ragged,
decode Sq = 1, chunked prefill Sq < Sk), causal; windows 16/64/200; GQA
groups 1/2/8; MLA's D ≠ Dv scaled down (24/16); non-causal; causal
Sq > Sk, whose first rows see no key and get zero gradients.

Tolerances, scale-normalized (max |port − ref| / max |ref|): f32 ≤ 1e-5,
bf16 ≤ 5e-2.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels.flash_attention import ref as jfa_ref
from repro.models import attention as JA
from repro_torch.kernels.flash_attention import grad as tgrad
from repro_torch.kernels.flash_attention import kernel as tfa_kernel
from repro_torch.kernels.flash_attention import ops as tfa_ops

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
TOL = {"f32": 1e-5, "bf16": 5e-2}
CHUNK = 48                       # query rows per panel: several chunks a call


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Keep torch's intra-op pool small beside the other test workers; the
    first multi-threaded ``torch.exp`` of a process can come out ~1e-4
    off (torch 2.13 CPU builds), so one small call goes first."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    torch.exp(torch.zeros(64))
    yield
    torch.set_num_threads(old)


def _inputs(B, Hq, Hkv, Sq, Sk, D, Dv=None, seed=0):
    rng = np.random.default_rng(seed)
    Dv = D if Dv is None else Dv
    q = (rng.normal(size=(B, Hq, Sq, D)) * 0.5).astype(np.float32)
    k = (rng.normal(size=(B, Hkv, Sk, D)) * 0.5).astype(np.float32)
    v = rng.normal(size=(B, Hkv, Sk, Dv)).astype(np.float32)
    do = rng.normal(size=(B, Hq, Sq, Dv)).astype(np.float32)
    return q, k, v, do


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def scaled(port, ref) -> float:
    p, r = _f32(port), _f32(ref)
    assert p.shape == r.shape, (p.shape, r.shape)
    return float(np.abs(p - r).max() / max(np.abs(r).max(), 1e-30))


def _port_vjp(arrs, dtype, causal, window, chunk=CHUNK):
    tdt = DTYPES[dtype][1]
    q, k, v, do = (torch.as_tensor(a).to(tdt) for a in arrs)
    out = tfa_kernel.flash_attention_plain(q, k, v, causal=causal,
                                           window=window)
    return tgrad.attention_vjp(q, k, v, out, do, causal, window, chunk)


def _ref_vjp(arrs, dtype, causal, window):
    jdt = DTYPES[dtype][0]
    q, k, v, do = (jnp.asarray(a).astype(jdt) for a in arrs)
    _, vjp = jax.vjp(lambda a, b, c: jfa_ref.attention(a, b, c, causal,
                                                       window), q, k, v)
    return vjp(do)


def _check(port, ref, dtype, label=""):
    for name, a, b in zip("qkv", port, ref):
        e = scaled(a, b)
        assert e <= TOL[dtype], f"{label} d{name} {e:.3g}"


CASES = ([(s, None, True) for s in FLASH_SHAPES]
         + [((1, 4, 2, 256, 256, 32), w, True) for w in (16, 64, 200)]
         + [((1, 8, h, 96, 96, 16), None, True) for h in (8, 4, 1)]
         + [((2, 4, 4, 80, 80, 32), None, False),
            ((1, 4, 2, 64, 160, 32), 40, False)])


@pytest.mark.parametrize("shape,window,causal", CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_vjp_matches_reference_oracle(shape, window, causal, dtype):
    """dq, dk, dv against ``jax.vjp`` of the reference's ``ref.attention``
    (f32 ≤ 1e-5, bf16 ≤ 5e-2): causal with right-aligned queries, windows,
    GQA groups 1/2/8, non-causal (with and without a window)."""
    arrs = _inputs(*shape, seed=sum(shape))
    _check(_port_vjp(arrs, dtype, causal, window),
           _ref_vjp(arrs, dtype, causal, window), dtype, f"{shape}")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_vjp_mla_head_widths(causal, dtype):
    """MLA's D ≠ Dv (deepseek 192/128, here 24/16)."""
    arrs = _inputs(2, 4, 4, 72, 72, 24, Dv=16, seed=7)
    _check(_port_vjp(arrs, dtype, causal, None),
           _ref_vjp(arrs, dtype, causal, None), dtype, "mla")


@pytest.mark.parametrize("shape,window,causal", [
    ((2, 4, 2, 100, 100, 32), None, True),
    ((1, 4, 2, 128, 128, 32), 16, True),
    ((1, 8, 1, 64, 64, 16), None, True),
    ((2, 4, 4, 80, 80, 32), None, False),
    ((1, 2, 2, 1, 256, 64), None, True)])
def test_vjp_matches_reference_training_attention(shape, window, causal):
    """dq, dk, dv against ``jax.vjp`` of ``_sdpa``, the einsum attention
    the reference trains on, in its (B, S, H, D) layout (f32 ≤ 1e-5)."""
    arrs = _inputs(*shape, seed=3)
    cfg = dataclasses.replace(jconfigs.get_smoke("gemma3-12b"),
                              dtype="float32")
    qj, kj, vj, doj = (jnp.asarray(a).transpose(0, 2, 1, 3) for a in arrs)
    _, vjp = jax.vjp(lambda a, b, c: JA._sdpa(a, b, c, cfg, causal=causal,
                                              window=window), qj, kj, vj)
    ref = [g.transpose(0, 2, 1, 3) for g in vjp(doj)]
    _check(_port_vjp(arrs, "f32", causal, window), ref, "f32", "_sdpa")


@pytest.mark.parametrize("shape,window,causal", CASES + [
    ((1, 4, 2, 64, 24, 16), None, True),            # rows with no key
    ((1, 2, 1, 50, 20, 16), 8, True),
    ((2, 4, 4, 72, 72, 24), None, True)])
def test_vjp_matches_torch_autograd_of_the_plain_version(shape, window,
                                                         causal):
    """The Function's gradients (through ``ops.flash_attention``) against
    torch autograd of the plain version, f32 ≤ 1e-5; chunked at 48 rows
    and in one panel alike."""
    q, k, v, do = (torch.as_tensor(a) for a in
                   _inputs(*shape, seed=11))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = tfa_kernel.flash_attention_plain(*leaves, causal=causal,
                                           window=window)
    ref = torch.autograd.grad(out, leaves, do)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = tfa_ops.flash_attention(*leaves, causal=causal, window=window)
    assert out.grad_fn is not None
    port = torch.autograd.grad(out, leaves, do)
    _check(port, ref, "f32", f"{shape}")
    one = tgrad.attention_vjp(q, k, v, out.detach(), do, causal, window,
                              chunk_q=shape[3])
    _check(one, ref, "f32", "one panel")


def test_rows_that_see_no_key_get_zero_gradients():
    """Causal Sq > Sk: query i sits at key position i + Sk − Sq, so the
    first Sq − Sk rows see no key.  Their output is 0 and so is their dq;
    they add nothing to dk and dv (the same as the gradient of the other
    rows alone)."""
    q, k, v, do = (torch.as_tensor(a) for a in
                   _inputs(1, 4, 2, 64, 24, 16, seed=5))
    out = tfa_kernel.flash_attention_plain(q, k, v)
    dq, dk, dv = tgrad.attention_vjp(q, k, v, out, do, True, None, 16)
    empty = 64 - 24
    assert torch.count_nonzero(out[:, :, :empty]) == 0
    assert torch.count_nonzero(dq[:, :, :empty]) == 0
    assert torch.isfinite(dq).all() and torch.count_nonzero(dq[:, :, empty:])
    tail = slice(empty, None)
    _, dk2, dv2 = tgrad.attention_vjp(q[:, :, tail], k, v, out[:, :, tail],
                                      do[:, :, tail], True, None, 16)
    assert scaled(dk, dk2) <= 1e-6 and scaled(dv, dv2) <= 1e-6


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_no_grad_keeps_todays_call(dtype):
    """Under ``torch.no_grad()`` (serving) the output has no ``grad_fn``
    and equals the plain call bit for bit, even for inputs that require
    grad; under grad mode the Function's forward is the same bits."""
    tdt = DTYPES[dtype][1]
    q, k, v, _ = (torch.as_tensor(a).to(tdt) for a in
                  _inputs(2, 8, 2, 128, 128, 32, seed=2))
    today = tfa_kernel.flash_attention_plain(q, k, v, causal=True, window=64)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    with torch.no_grad():
        out = tfa_ops.flash_attention(*leaves, causal=True, window=64)
    assert out.grad_fn is None and torch.equal(out, today)
    plain = tfa_ops.flash_attention(q, k, v, causal=True, window=64)
    assert plain.grad_fn is None and torch.equal(plain, today)
    graded = tfa_ops.flash_attention(*leaves, causal=True, window=64)
    assert graded.grad_fn is not None
    assert torch.equal(graded.detach(), today)


def test_gqa_never_repeats_kv_and_dtypes_follow_the_inputs():
    """dk, dv have the kv heads' shape (the group's contributions summed),
    and each gradient comes back in its input's dtype."""
    q, k, v, do = (torch.as_tensor(a).to(torch.bfloat16) for a in
                   _inputs(1, 8, 2, 64, 64, 16, Dv=8, seed=4))
    out = tfa_kernel.flash_attention_plain(q, k, v)
    dq, dk, dv = tgrad.attention_vjp(q, k, v, out, do)
    assert dq.shape == q.shape and dk.shape == k.shape and \
        dv.shape == v.shape
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
