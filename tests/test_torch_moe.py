"""The port's MoE FFN (``repro_torch.models.moe``) held against the JAX
reference's (``repro.models.moe``) on the CPU.

qwen2-moe-a2.7b's and deepseek-v3-671b's SMOKE configs, in f32 and bf16
compute; the reference's parameters (``init_moe`` from a JAX key) cross as
numpy, and both sides get the same seeded numpy activations.  Tolerances,
scale-normalized: the router (f32 on both sides whatever the compute
dtype) ≤ 1e-6; the dispatch and the whole FFN f32 ≤ 1e-5, bf16 ≤ 5e-2 (the
reference adds a token's k expert outputs in bf16 in expert order, the port
in routing order).  The capacity factor 0.5 forces drops, and the test
asserts that some assignment drops; the combine is bit-equal across calls.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import moe as JMoE
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import moe as TMoE

ARCHS = ("qwen2-moe-a2.7b", "deepseek-v3-671b")
TOL = {"float32": 1e-5, "bfloat16": 5e-2}
TOL_ROUTE = 1e-6
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
B, S = 2, 16


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    torch.exp(torch.zeros(64))
    yield
    torch.set_num_threads(old)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def scaled(port, ref) -> float:
    p, r = _f32(port), _f32(ref)
    assert p.shape == r.shape, (p.shape, r.shape)
    return float(np.abs(p - r).max() / max(np.abs(r).max(), 1e-30))


def _setup(arch, dtype, cf=None, seed=0):
    kw = {"dtype": dtype}
    if cf is not None:
        kw["capacity_factor"] = cf
    jc = dataclasses.replace(jconfigs.get_smoke(arch), **kw)
    tc = dataclasses.replace(tconfigs.get_smoke(arch), **kw)
    jp = JMoE.init_moe(jax.random.PRNGKey(seed), jc)
    tp = convert._tree_to_torch(jax.tree.map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


def _x(tc, s, seed=1):
    x = np.random.default_rng(seed).normal(size=(B, s, tc.d_model)).astype(
        np.float32)
    return (jnp.asarray(x).astype(JDT[tc.dtype]),
            torch.as_tensor(x).to(tc.cdtype))


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_reference(arch, dtype):
    jc, tc, jp, tp = _setup(arch, dtype)
    jx, tx = _x(tc, S)
    jw, jidx, jaux = JMoE._route(jp, jc, jx.reshape(-1, jc.d_model))
    tw, tidx, taux = TMoE._route(tp, tc, tx.reshape(-1, tc.d_model))
    assert tw.dtype == torch.float32 and tidx.shape == (B * S, tc.moe_top_k)
    assert np.array_equal(tidx.numpy(), np.asarray(jidx))
    assert scaled(tw, jw) <= TOL_ROUTE
    assert abs(float(taux) - float(jaux)) <= TOL_ROUTE * float(jaux)
    # the renormalized weights sum to 1 per token
    assert torch.allclose(tw.sum(-1), torch.ones(B * S), atol=1e-6)


@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_and_ffn_match_reference(arch, dtype, cf):
    """``_dispatch_compute`` on the reference's routing, and ``moe_ffn``
    (shared experts included), at the default capacity factor and at 0.5,
    where some assignments overflow and drop."""
    jc, tc, jp, tp = _setup(arch, dtype, cf)
    jx, tx = _x(tc, S, seed=2)
    xf_j, xf_t = jx.reshape(-1, jc.d_model), tx.reshape(-1, tc.d_model)
    jw, jidx, _ = JMoE._route(jp, jc, xf_j)
    w = torch.as_tensor(np.array(jw))
    idx = torch.as_tensor(np.array(jidx), dtype=torch.int64)
    C = TMoE.capacity(tc, B * S)
    _, _, keep = TMoE._assign(tc, idx, C)
    if cf == 0.5:
        assert not bool(keep.all()), "cf = 0.5 should drop an assignment"
    else:
        assert bool(keep.all())
    e = scaled(TMoE._dispatch_compute(tp, tc, xf_t, w, idx),
               JMoE._dispatch_compute(jp, jc, xf_j, jw, jidx))
    assert e <= TOL[dtype], f"dispatch {e:.3g}"
    (jo, jaux), (to, taux) = JMoE.moe_ffn(jp, jc, jx), TMoE.moe_ffn(tp, tc,
                                                                    tx)
    assert to.dtype == tc.cdtype and to.shape == tx.shape
    e = scaled(to, jo)
    assert e <= TOL[dtype], f"moe_ffn {e:.3g}"
    assert abs(float(taux) - float(jaux)) <= TOL_ROUTE * float(jaux)


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_sized_batch(arch, dtype):
    """T = B tokens (one decode step): C = 8, nothing drops."""
    jc, tc, jp, tp = _setup(arch, dtype)
    jx, tx = _x(tc, 1, seed=3)
    assert TMoE.capacity(tc, B) == 8
    (jo, _), (to, _) = JMoE.moe_ffn(jp, jc, jx), TMoE.moe_ffn(tp, tc, tx)
    e = scaled(to, jo)
    assert e <= TOL[dtype], f"decode-sized moe_ffn {e:.3g}"


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_and_stable_overflow(arch):
    """The capacity is the reference's integer arithmetic; within an expert
    the assignments keep routing order (a stable sort), so the ones that
    drop are its last."""
    tc = tconfigs.get_smoke(arch)
    E, k = tc.n_experts, tc.moe_top_k
    for T in (1, 2, 7, 32, 1000, 65_536):
        C = max(1, int(tc.capacity_factor * T * k / E))
        assert TMoE.capacity(tc, T) == -(-C // 8) * 8
    tc = dataclasses.replace(tc, capacity_factor=0.5)
    T = 64
    g = torch.Generator().manual_seed(4)
    idx = torch.stack([torch.randperm(E, generator=g)[:k] for _ in range(T)])
    C = TMoE.capacity(tc, T)
    tok, slot, keep = TMoE._assign(tc, idx, C)
    eids = idx.reshape(-1)
    for e in range(E):
        mine = torch.nonzero(eids == e).flatten()      # routing order
        assert bool(keep[mine[:C]].all()) and not bool(keep[mine[C:]].any())
        assert torch.equal(slot[mine[:C]], e * C + torch.arange(
            min(C, len(mine))))
        assert bool((slot[mine[C:]] == E * C).all())
    assert torch.equal(tok, torch.arange(T * k) // k)


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("arch", ARCHS)
def test_combine_is_bit_repeatable(arch, dtype):
    _, tc, _, tp = _setup(arch, dtype, 0.5)
    _, tx = _x(tc, S, seed=5)
    a, aux_a = TMoE.moe_ffn(tp, tc, tx)
    b, aux_b = TMoE.moe_ffn(tp, tc, tx)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


def test_router_stays_f32_after_prepare():
    from repro_torch.models import model as TM
    tc = tconfigs.get_smoke("qwen2-moe-a2.7b")
    model = TM.build_model(tc)
    prepared = model.prepare(model.init(torch.Generator().manual_seed(0),
                                        "cpu"))
    moe = prepared["stack"]["scanned"][0][0]["moe"]
    assert moe["router"].dtype == torch.float32
    assert moe["wi_gate"].dtype == moe["wo"].dtype == torch.bfloat16
    assert moe["shared"]["wi_up"].dtype == torch.bfloat16
