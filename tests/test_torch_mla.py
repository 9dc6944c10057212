"""The port's MLA attention (``repro_torch.models.attention``: ``_mla_project``
/ ``mla_attend_full``, the latent cache, ``_mla_decode``) held against the
JAX reference's (``repro.models.attention``) on the CPU.

Configs: deepseek-v3-671b's SMOKE, and the reference's own MLA test config
(``tests/test_models.py::test_mla_decode_matches_forward``: d_model 64, 4
heads, q_lora = kv_lora = 32, nope 16, rope 8, v 16), each in f32 and bf16.
The reference's mixer parameters (``init_attention`` from a JAX key) cross
as numpy; activations come from a seeded numpy generator.  The full
attention goes through B6's plain version here (q/k of width nope + rope,
v of width v_head_dim).  Tolerances, scale-normalized: f32 ≤ 1e-5, bf16
≤ 5e-2.  Decode against the teacher-forced forward is held as the
reference holds its own (rtol = atol = 5e-3, f32).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import ModelConfig as JModelConfig
from repro.models import attention as JA
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.kernels.flash_attention import kernel as tfa_kernel
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT

TOL = {"float32": 1e-5, "bfloat16": 5e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
B, S_PRE, S_MAX = 2, 12, 16
#: the reference's own MLA test config (tests/test_models.py)
MLA_TEST = dict(name="t", family="moe", n_layers=2, d_model=64, n_heads=4,
                n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=128,
                dtype="float32", use_mla=True, q_lora_rank=32,
                kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
                v_head_dim=16)
CONFIGS = ("deepseek-v3-671b", "mla-test")


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


def _configs(which, dtype, **kw):
    if which == "mla-test":
        return (JModelConfig(**{**MLA_TEST, "dtype": dtype, **kw}),
                TModelConfig(**{**MLA_TEST, "dtype": dtype, **kw}))
    return (dataclasses.replace(jconfigs.get_smoke(which), dtype=dtype, **kw),
            dataclasses.replace(tconfigs.get_smoke(which), dtype=dtype, **kw))


def _mixer(jc, tc, seed=0):
    jp = JA.init_attention(jax.random.PRNGKey(seed), jc)
    return jp, convert._tree_to_torch(jax.tree.map(np.asarray, jp), "cpu")


def _x(tc, s, seed):
    x = np.random.default_rng(seed).normal(size=(B, s, tc.d_model)).astype(
        np.float32)
    return (jnp.asarray(x).astype(JDT[tc.dtype]),
            torch.as_tensor(x).to(tc.cdtype))


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("which", CONFIGS)
def test_mla_full_matches_reference(which, dtype):
    jc, tc = _configs(which, dtype)
    jp, tp = _mixer(jc, tc)
    jx, tx = _x(tc, S_PRE, 1)
    pos = np.arange(S_PRE)
    ref = JA._mla_full(jp, jc, jx, jnp.asarray(pos))
    tfa_kernel.reset_launch_counts()
    port = TA.attention_full(tp, tc, tx, torch.as_tensor(pos))
    assert port.dtype == tc.cdtype
    e = scaled(port, ref)
    assert e <= TOL[dtype], f"_mla_full {e:.3g}"
    # the same numbers through the prefill's split (project once, attend)
    parts = TA._mla_project(tp, tc, tx, torch.as_tensor(pos))
    again = TA.mla_attend_full(tp, tc, *parts)
    assert torch.equal(again, port)
    # B6's plain version on the CPU: no kernel launch
    assert tfa_kernel.launch_counts() == {"flash_attention": 0,
                                          "flash_attention_tc": 0}


@pytest.mark.parametrize("absorb", [True, False],
                         ids=["absorbed", "materialized"])
@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("which", CONFIGS)
def test_prefill_cache_and_decode_match_reference(which, dtype, absorb):
    """The latent cache (ckv, krope padded to max_len) of one layer, then
    three decode steps on it: the outputs and the cache, updated in
    place."""
    jc, tc = _configs(which, dtype, mla_absorb=absorb)
    jp, tp = _mixer(jc, tc, seed=2)
    jx, tx = _x(tc, S_PRE, 3)
    pos = np.arange(S_PRE)
    jcache = JT._attn_prefill_cache(jp, jc, "attn", jx, jnp.asarray(pos),
                                    S_MAX, jax.random.PRNGKey(0))
    parts = TA._mla_project(tp, tc, tx, torch.as_tensor(pos))
    tcache = {"ckv": torch.nn.functional.pad(parts[2], (0, 0, 0, S_MAX
                                                        - S_PRE)),
              "krope": torch.nn.functional.pad(parts[3], (0, 0, 0, S_MAX
                                                          - S_PRE))}
    assert set(tcache) == set(jcache) == {"ckv", "krope"}
    for name in jcache:
        assert tuple(tcache[name].shape) == jcache[name].shape
        e = scaled(tcache[name], jcache[name])
        assert e <= TOL[dtype], f"prefill cache {name}: {e:.3g}"
    # a block's prefill builds its cache from the same projection of its
    # normed input
    blk = {"norm1": {"scale": torch.zeros(tc.d_model)}, "mixer": tp}
    _, bcache = TT.block_prefill(blk, tc, "attn", tx, torch.as_tensor(pos),
                                 S_MAX)
    xin = TL.rmsnorm(blk["norm1"], tx, tc.norm_eps)
    ref_parts = TA._mla_project(tp, tc, xin, torch.as_tensor(pos))
    assert torch.equal(bcache["ckv"][:, :S_PRE], ref_parts[2])
    assert torch.equal(bcache["krope"][:, :S_PRE], ref_parts[3])
    xd = np.random.default_rng(4).normal(size=(B, 1, tc.d_model)).astype(
        np.float32)
    for step in range(3):
        p = S_PRE + step
        jy, jcache = JA.attention_decode(
            jp, jc, jnp.asarray(xd * (step + 1)).astype(JDT[dtype]), jcache,
            jnp.asarray(p, jnp.int32), "attn")
        ckv_id = id(tcache["ckv"])
        ty, tcache = TA.attention_decode(
            tp, tc, torch.as_tensor(xd * (step + 1)).to(tc.cdtype), tcache,
            p, "attn")
        assert id(tcache["ckv"]) == ckv_id          # updated in place
        e = scaled(ty, jy)
        assert e <= TOL[dtype], f"decode step {step}: {e:.3g}"
        for name in jcache:
            e = scaled(tcache[name], jcache[name])
            assert e <= TOL[dtype], f"cache {name} step {step}: {e:.3g}"


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("which", CONFIGS)
def test_absorbed_matches_materialized(which, dtype):
    """The two decode forms on the same cache: the same function."""
    jc, tc = _configs(which, dtype)
    tc2 = dataclasses.replace(tc, mla_absorb=False)
    _, tp = _mixer(jc, tc, seed=5)
    _, tx = _x(tc, S_PRE, 6)
    parts = TA._mla_project(tp, tc, tx, torch.arange(S_PRE))
    pad = (0, 0, 0, S_MAX - S_PRE)
    c1 = {"ckv": torch.nn.functional.pad(parts[2], pad),
          "krope": torch.nn.functional.pad(parts[3], pad)}
    c2 = {k: v.clone() for k, v in c1.items()}
    xd = torch.as_tensor(np.random.default_rng(7).normal(
        size=(B, 1, tc.d_model)).astype(np.float32)).to(tc.cdtype)
    y1, c1 = TA.attention_decode(tp, tc, xd, c1, S_PRE, "attn")
    y2, c2 = TA.attention_decode(tp, tc2, xd, c2, S_PRE, "attn")
    assert torch.equal(c1["ckv"], c2["ckv"])
    assert torch.equal(c1["krope"], c2["krope"])
    e = scaled(y1, y2)
    assert e <= TOL[dtype], f"absorbed vs materialized {e:.3g}"


@pytest.mark.parametrize("absorb", [True, False],
                         ids=["absorbed", "materialized"])
def test_mla_decode_matches_forward(absorb):
    """The reference's ``test_mla_decode_matches_forward`` on the port:
    prefill 4 tokens, then each decode step's logits against the
    teacher-forced forward's (f32, rtol = atol = 5e-3)."""
    cfg = TModelConfig(**{**MLA_TEST, "mla_absorb": absorb})
    m = TM.build_model(cfg)
    params = m.init(torch.Generator().manual_seed(0), "cpu")
    S = 12
    toks = torch.randint(0, 128, (B, S),
                         generator=torch.Generator().manual_seed(1))
    full_logits, _ = m.forward(params, {"tokens": toks})
    _, cache = m.prefill(params, {"tokens": toks[:, :4]}, S)
    for t in range(4, S):
        lg, cache = m.decode_step(params, cache, toks[:, t:t + 1], t)
        np.testing.assert_allclose(lg.numpy(), full_logits[:, t].numpy(),
                                   rtol=5e-3, atol=5e-3)
