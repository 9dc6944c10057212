"""The port's serving path held against the JAX reference (CPU): gemma3-12b
in depth (layers, attention, caches), and every ported arch's SMOKE config
(gemma3-12b, yi-6b, yi-9b, minitron-4b, chameleon-34b with patch
embeddings, qwen2-moe-a2.7b, deepseek-v3-671b) through prefill and
teacher-forced decode.  The MoE and MLA modules have their own files
(``test_torch_moe.py``, ``test_torch_mla.py``).

The reference model (``repro.models``) is built from the SMOKE config and
initialized from a JAX key; its params are converted to the
port's (``convert.model_params_from_reference``), and both sides get the
same numpy inputs: activations made from a seed, and token sequences.
Decode steps are teacher-forced with the same tokens on both sides; free-
running greedy output is never compared.  The reference's landmark draws
are recovered from its keys (``stack_prefill`` → ``build_landmark_cache`` →
``build_landmark_state``) and handed to the port.  Pallas kernels run in
interpret mode on the JAX side, as the reference's own tests run them.

Tolerances, scale-normalized (max |port − ref| / max |ref|): f32 ≤ 1e-4,
bf16 ≤ 5e-2 (bf16 intermediates round at different places in the two
frameworks, and the differences grow over the layers); the MoE load-balance
aux of ``forward`` ≤ 1e-5.
"""
from __future__ import annotations

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import SHAPES as JSHAPES
from repro.configs import config_for_shape as jconfig_for_shape
from repro.configs import gemma3_12b as jg
from repro.configs.base import ModelConfig as JModelConfig
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import moe as JMoE
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.configs import gemma3_12b as tg
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.kernels.flash_attention import kernel as tfa_kernel
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE
from repro_torch.models import transformer as TT

jsa = importlib.import_module("repro.core.sketched_attention")

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
TOL_AUX = 1e-5
#: a MoE router decision the two sides may take differently: the reference's
#: k-th and (k+1)-th probabilities within this relative margin.  In bf16 the
#: router's input carries the roundings of every earlier layer (2^-8 each),
#: and a near-tie flips one way or the other; in f32 no flip is allowed.
TIE_MARGIN = {"float32": 0.0, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
B, S_PRE, S_MAX, N_DECODE = 2, 32, 40, 6
N_PATCH = 6             # chameleon's early-fusion patch embeddings
#: every arch the port serves, in the port's registry order
PORTED = ("gemma3-12b", "minitron-4b", "yi-9b", "yi-6b", "deepseek-v3-671b",
          "qwen2-moe-a2.7b", "chameleon-34b")


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


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def scaled(port, ref) -> float:
    p, r = _f32(port), _f32(ref)
    assert p.shape == r.shape, (p.shape, r.shape)
    return float(np.abs(p - r).max() / max(np.abs(r).max(), 1e-30))


def _configs(dtype="float32", arch="gemma3-12b", **kw):
    return (dataclasses.replace(jconfigs.get_smoke(arch), dtype=dtype, **kw),
            dataclasses.replace(tconfigs.get_smoke(arch), dtype=dtype, **kw))


def _patches(cfg, seed=9):
    """Early-fusion inputs for a vlm config (none for the others)."""
    if cfg.family != "vlm":
        return {}
    return {"patches": _x((B, N_PATCH, cfg.d_model), seed)}


def _params(jcfg, tcfg, seed=0):
    jp = JM.build_model(jcfg).init(jax.random.PRNGKey(seed))
    tp = convert.model_params_from_reference(jax.tree.map(np.asarray, jp),
                                             tcfg, device="cpu")
    return jp, tp


def _block(tree, r=0, i=0):
    """Block (rep r, pattern slot i) of both sides' stack params."""
    jb = jax.tree.map(lambda t: t[r], tree[0]["stack"]["scanned"][i])
    return jb, tree[1]["stack"]["scanned"][r][i]


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _tokens(cfg, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S_MAX)).astype(np.int32)


def reference_landmark_draws(cfg, key, batch: int, n: int) -> dict:
    """The landmark and column-sketch indices the reference's prefill draws
    for every landmark layer, keyed by the layer's flat index (the port's
    ``transformer.layer_slots`` order): each superblock's key is
    ``split(key, reps)[r]``, a layer's is ``fold_in(·, slot)``, a head's
    ``split(·, B·KV)[b·KV + h]``, and ``build_landmark_state`` splits that
    into (landmarks, sketch)."""
    prefix, pattern, reps, remainder = JT.stack_layout(cfg)
    assert not any(k == "global" for k in prefix + remainder)
    c, theta, KV = cfg.landmark_c, cfg.landmark_theta, cfg.n_kv_heads
    s = min(theta * c, n)
    keys = jax.random.key_data(jax.random.split(key, reps))
    draws = {}
    for r in range(reps):
        kk = jax.random.wrap_key_data(keys[r])
        for i, kind in enumerate(pattern):
            if kind != "global" or not cfg.use_landmark_decode:
                continue
            heads = jax.random.split(jax.random.fold_in(kk, i),
                                     batch * KV).reshape(batch, KV)
            p_idx = np.zeros((batch, KV, min(c, n)), np.int64)
            skx = np.zeros((batch, KV, s), np.int64)
            for b in range(batch):
                for h in range(KV):
                    kp, ks = jax.random.split(heads[b, h])
                    p = jsa.landmark_indices(kp, n, c)
                    p_idx[b, h] = np.asarray(p)
                    skx[b, h] = np.asarray(
                        jsa._extend_without_replacement(ks, p, s, n))
            draws[len(prefix) + r * len(pattern) + i] = {"p_idx": p_idx,
                                                         "skx": skx}
    return draws


class RoutingHandover:
    """The reference's MoE routing handed to the port at near-ties.

    The reference's ``_route`` reports each call's expert ids and router
    probabilities (``jax.debug.callback``, in call order); the port's
    ``_route`` compares its own top-k sets with them, call by call.  Where
    a token's set differs, the reference's margin between its k-th and
    (k+1)-th probability must be within ``TIE_MARGIN`` — else the test
    fails — and the port takes the reference's experts, weighted by its own
    probabilities: the routing is teacher-forced there, as decode is with
    tokens, so the rest of the computation is compared on the same
    decisions.  ``flips`` counts the tokens handed over."""

    def __init__(self, monkeypatch, dtype: str):
        self.records, self.flips = [], 0
        self.tie = TIE_MARGIN[dtype]
        ref_route, port_route = JMoE._route, TMoE._route

        def record(idx, probs):
            self.records.append((np.asarray(idx), np.asarray(probs)))

        def jroute(params, cfg, xf):
            out = ref_route(params, cfg, xf)
            jax.debug.callback(record, out[1], jax.nn.softmax(
                xf.astype(jnp.float32) @ params["router"], axis=-1),
                ordered=True)
            return out

        def troute(params, cfg, xf):
            w, idx, aux = port_route(params, cfg, xf)
            jax.effects_barrier()
            ref_idx, ref_p = self.records.pop(0)
            bad = np.nonzero((np.sort(ref_idx, 1) != np.sort(
                idx.numpy(), 1)).any(1))[0]
            if len(bad):
                k = cfg.moe_top_k
                p = -np.sort(-ref_p[bad], 1)
                margin = (p[:, k - 1] - p[:, k]) / p[:, k - 1]
                assert (margin <= self.tie).all(), (
                    f"routing differs beyond a near-tie: margins {margin}")
                self.flips += len(bad)
                probs = torch.softmax(xf.float() @ params["router"].float(),
                                      dim=-1)
                rows = torch.as_tensor(bad)
                ridx = torch.as_tensor(ref_idx[bad], dtype=idx.dtype)
                rw = probs[rows].gather(1, ridx)
                idx, w = idx.clone(), w.clone()
                idx[rows] = ridx
                w[rows] = rw / rw.sum(-1, keepdim=True).clamp_min(1e-9)
            return w, idx, aux

        monkeypatch.setattr(JMoE, "_route", jroute)
        monkeypatch.setattr(TMoE, "_route", troute)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_configs_carry_over_from_the_reference():
    assert tconfigs.ARCHS == list(PORTED)
    for name in PORTED:
        for jc, tc in ((jconfigs.get_config(name), tconfigs.get_config(name)),
                       (jconfigs.get_smoke(name), tconfigs.get_smoke(name))):
            assert dataclasses.asdict(jc) == dataclasses.asdict(tc), name
            assert tc.cdtype == torch.bfloat16
            assert tc.pdtype == getattr(torch, jc.param_dtype)
    assert tconfigs.get_config("deepseek-v3-671b").pdtype == torch.bfloat16
    jl = jconfig_for_shape(jg.FULL, JSHAPES["long_500k"])
    tl = tconfigs.config_for_shape(tg.FULL, tconfigs.SHAPES["long_500k"])
    assert dataclasses.asdict(jl) == dataclasses.asdict(tl)
    assert tl.use_landmark_decode and tl.landmark_c == 512
    assert {k: dataclasses.astuple(v) for k, v in JSHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in tconfigs.SHAPES.items()}
    assert tconfigs.get_config("gemma3-12b") is tg.FULL
    assert tconfigs.get_smoke("gemma3-12b") is tg.SMOKE
    for name in ("xlstm-125m", "whisper-large-v3", "no-such-arch"):
        with pytest.raises(KeyError, match="A11"):
            tconfigs.get_config(name)
    assert [f.name for f in dataclasses.fields(JModelConfig)] == \
        [f.name for f in dataclasses.fields(TModelConfig)]


@pytest.mark.parametrize("arch", PORTED)
def test_config_arithmetic_matches_the_reference(arch):
    """``param_count``, ``active_param_count`` and their per-layer terms
    equal the reference's, for the published config and its SMOKE twin."""
    for jc, tc in ((jconfigs.get_config(arch), tconfigs.get_config(arch)),
                   (jconfigs.get_smoke(arch), tconfigs.get_smoke(arch))):
        assert tc.param_count() == jc.param_count()
        assert tc.active_param_count() == jc.active_param_count()
        for i in range(tc.n_layers):
            assert tc._mlp_params(i) == jc._mlp_params(i)
        for kind in ("attn", "local", "global"):
            assert tc._mixer_params(kind) == jc._mixer_params(kind)


@pytest.mark.parametrize("arch", PORTED)
def test_init_trees_match_the_reference(arch):
    """The port's ``init`` makes the reference's tree (prefix blocks, MoE
    banks, the MTP head) with its shapes and dtypes, and
    ``model_params_from_reference`` carries every leaf (bf16 ones too)."""
    jc, tc = _configs("float32", arch)
    if arch == "deepseek-v3-671b":
        jc, tc = (dataclasses.replace(c, param_dtype="bfloat16")
                  for c in (jc, tc))
    jp, tp = _params(jc, tc)
    own = TM.build_model(tc).init(torch.Generator().manual_seed(0), "cpu")

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], path + (k,))
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from leaves(v, path + (i,))
        else:
            yield path, tuple(tree.shape), tree.dtype

    assert list(leaves(own)) == list(leaves(tp))
    assert ("mtp" in own) == jc.mtp
    if jc.mtp:
        assert set(own["mtp"]) == set(jp["mtp"])
    n_ref = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jp))
    assert sum(int(np.prod(s)) for _, s, _ in leaves(own)) == n_ref
    if jc.n_experts:
        moe = tp["stack"]["scanned"][0][0]["moe"]
        assert moe["router"].dtype == torch.float32
        assert moe["wi_gate"].dtype == tc.pdtype


def test_unported_families_raise():
    rec = dataclasses.replace(tg.SMOKE, layer_pattern=("rglru", "local"))
    with pytest.raises(NotImplementedError, match="A11"):
        TM.build_model(rec).init(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="A11"):
        TM.build_model(dataclasses.replace(tg.SMOKE, is_encdec=True))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(TOL))
def test_rmsnorm_rope_embed_unembed(dtype):
    jc, tc = _configs(dtype)
    jp, tp = _params(jc, tc)
    x = _x((B, 12, jc.d_model), 1)
    scale = _x((jc.d_model,), 2, 0.1)
    jx, tx = jnp.asarray(x).astype(JDT[dtype]), torch.as_tensor(x).to(
        tc.cdtype)
    e = scaled(TL.rmsnorm({"scale": torch.as_tensor(scale)}, tx, tc.norm_eps),
               JL.rmsnorm({"scale": jnp.asarray(scale)}, jx, jc.norm_eps))
    assert e <= TOL[dtype], f"rmsnorm {e:.3g}"
    h = _x((B, 4, 12, jc.head_dim), 3)
    pos = np.arange(12) + 1000
    for theta in (jc.rope_theta, jc.rope_theta_local):
        e = scaled(TL.apply_rope(torch.as_tensor(h).to(tc.cdtype),
                                 torch.as_tensor(pos), theta),
                   JL.apply_rope(jnp.asarray(h).astype(JDT[dtype]),
                                 jnp.asarray(pos), theta))
        assert e <= TOL[dtype], f"apply_rope θ={theta}: {e:.3g}"
    toks = _tokens(jc)
    je = JL.embed(jp["embed"], jc, jnp.asarray(toks))
    te = TL.embed(tp["embed"], tc, torch.as_tensor(toks))
    assert te.dtype == tc.cdtype
    assert scaled(te, je) <= TOL[dtype]
    # √d_model in the compute dtype: 8.0 exactly at d_model = 64
    assert torch.equal(te, tp["embed"]["embedding"][torch.as_tensor(
        toks).long()].to(tc.cdtype) * 8.0)
    e = scaled(TL.unembed(tp["embed"], tc, tx), JL.unembed(jp["embed"], jc,
                                                           jx))
    assert e <= TOL[dtype], f"unembed {e:.3g}"


@pytest.mark.parametrize("variant", ["swiglu", "geglu", "relu2", "gelu"])
@pytest.mark.parametrize("dtype", list(TOL))
def test_mlp_variants(variant, dtype):
    jc, tc = _configs(dtype, mlp_variant=variant)
    jp = JL.init_mlp(jax.random.PRNGKey(3), jc)
    tp = convert._tree_to_torch(jax.tree.map(np.asarray, jp), "cpu")
    x = _x((B, 8, jc.d_model), 4)
    e = scaled(TL.mlp(tp, tc, torch.as_tensor(x).to(tc.cdtype)),
               JL.mlp(jp, jc, jnp.asarray(x).astype(JDT[dtype])))
    assert e <= TOL[dtype], f"mlp {variant}: {e:.3g}"


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["local", "global"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", list(TOL))
def test_attention_full(kind, impl, dtype):
    """Both reference paths (the XLA einsums and the Pallas flash kernel)
    against the port's one path (the plain flash version on the CPU)."""
    jc, tc = _configs(dtype, attn_impl=impl)
    jb, tb = _block(_params(jc, tc))
    x = _x((B, S_PRE, jc.d_model), 5)
    pos = np.arange(S_PRE)
    ref = JA.attention_full(jb["mixer"], jc, jnp.asarray(x).astype(
        JDT[dtype]), jnp.asarray(pos), kind)
    port = TA.attention_full(tb["mixer"], tc, torch.as_tensor(x).to(
        tc.cdtype), torch.as_tensor(pos), kind)
    assert port.dtype == tc.cdtype
    e = scaled(port, ref)
    assert e <= TOL[dtype], f"{kind}/{impl}: {e:.3g}"


@pytest.mark.parametrize("kind", ["local", "global", "landmark"])
@pytest.mark.parametrize("dtype", list(TOL))
def test_attention_decode(kind, dtype):
    """Prefill cache of one layer, then one decode step on it: the cache
    (ring buffer, full cache or landmark factors) and the output."""
    lm = kind == "landmark"
    jc, tc = _configs(dtype, use_landmark_decode=lm)
    lkind = "global" if lm else kind
    jb, tb = _block(_params(jc, tc))
    x = _x((B, S_PRE, jc.d_model), 6)
    xd = _x((B, 1, jc.d_model), 7)
    pos = np.arange(S_PRE)
    # a typed key, as the reference's stack_prefill hands its layers
    key = jax.random.wrap_key_data(jax.random.PRNGKey(4))
    jcache = JT._attn_prefill_cache(jb["mixer"], jc, lkind,
                                    jnp.asarray(x).astype(JDT[dtype]),
                                    jnp.asarray(pos), S_MAX, key)
    _, k, v = TA._qkv(tb["mixer"], tc, torch.as_tensor(x).to(tc.cdtype),
                      torch.as_tensor(pos), TA._theta(tc, lkind))
    draws = None
    if lm:
        heads = jax.random.split(key, B * jc.n_kv_heads).reshape(
            B, jc.n_kv_heads)
        s = min(jc.landmark_theta * jc.landmark_c, S_PRE)
        draws = {"p_idx": np.zeros((B, jc.n_kv_heads, jc.landmark_c), int),
                 "skx": np.zeros((B, jc.n_kv_heads, s), int)}
        for b in range(B):
            for h in range(jc.n_kv_heads):
                kp, ks = jax.random.split(heads[b, h])
                p = jsa.landmark_indices(kp, S_PRE, jc.landmark_c)
                draws["p_idx"][b, h] = np.asarray(p)
                draws["skx"][b, h] = np.asarray(
                    jsa._extend_without_replacement(ks, p, s, S_PRE))
    tcache = TT._attn_prefill_cache(tc, lkind, k, v, S_MAX, draws)
    assert set(tcache) == set(jcache)
    for name in jcache:
        e = scaled(tcache[name], jcache[name])
        assert e <= TOL[dtype], f"{kind} prefill cache {name}: {e:.3g}"
    for step in range(3):
        p = S_PRE + step
        jy, jcache = JA.attention_decode(
            jb["mixer"], jc, jnp.asarray(xd).astype(JDT[dtype]) * (step + 1),
            jcache, jnp.asarray(p, jnp.int32), lkind)
        ty, tcache = TA.attention_decode(
            tb["mixer"], tc, torch.as_tensor(xd).to(tc.cdtype) * (step + 1),
            tcache, p, lkind)
        e = scaled(ty, jy)
        assert e <= TOL[dtype], f"{kind} decode step {step}: {e:.3g}"
        for name in jcache:
            e = scaled(tcache[name], jcache[name])
            assert e <= TOL[dtype], f"{kind} cache {name} step {step}: {e:.3g}"


# ---------------------------------------------------------------------------
# the model: prefill logits and caches, teacher-forced decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,landmark", [
    pytest.param("gemma3-12b", False, id="full_cache"),
    pytest.param("gemma3-12b", True, id="landmark")] + [
    pytest.param(a, False, id=a) for a in PORTED if a != "gemma3-12b"])
@pytest.mark.parametrize("dtype", list(TOL))
def test_prefill_and_decode_match_reference(arch, landmark, dtype,
                                            monkeypatch):
    """Prefill logits and every cache (k/v, ring buffers, landmark factors,
    MLA latents), then teacher-forced decode steps; chameleon's prefill
    fuses patch embeddings into its leading positions.  MoE archs route
    through ``RoutingHandover`` (no flip in f32; near-ties only in bf16)."""
    jc, tc = _configs(dtype, arch, use_landmark_decode=landmark)
    if jc.n_experts:
        RoutingHandover(monkeypatch, dtype)
    jp, tp = _params(jc, tc)
    jm, tm = JM.build_model(jc), TM.build_model(tc)
    toks = _tokens(jc, seed=1)
    key = jax.random.PRNGKey(2)
    extra = _patches(jc)
    jl, jcache = jm.prefill(
        jp, {"tokens": jnp.asarray(toks[:, :S_PRE]),
             **{k: jnp.asarray(v) for k, v in extra.items()}}, key, S_MAX)
    draws = reference_landmark_draws(jc, key, B, S_PRE)
    assert bool(draws) == landmark
    tl, tcache = tm.prefill(tp, {"tokens": torch.as_tensor(toks[:, :S_PRE]),
                                 **extra}, S_MAX, landmark_draws=draws)
    assert tl.dtype == tc.cdtype and tuple(tl.shape) == (B, jc.vocab_size)
    e = scaled(tl, jl)
    assert e <= TOL[dtype], f"prefill logits {e:.3g}"
    errs = jax.tree.map(lambda r, p: scaled(p, r),
                        jax.tree.map(np.asarray, jcache),
                        convert.cache_to_reference(tcache, tc))
    worst = max(jax.tree.leaves(errs))
    assert worst <= TOL[dtype], f"prefill caches {errs}"
    decode = jax.jit(jm.decode_step)
    for t in range(S_PRE, S_PRE + N_DECODE):
        jl, jcache = decode(jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                            jnp.asarray(t, jnp.int32))
        tl, tcache = tm.decode_step(tp, tcache,
                                    torch.as_tensor(toks[:, t:t + 1]), t)
        e = scaled(tl, jl)
        assert e <= TOL[dtype], f"decode step at {t}: {e:.3g}"


@pytest.mark.parametrize("arch", PORTED)
def test_forward_and_aux_match_reference(arch):
    """``forward``'s logits (f32 ≤ 1e-4) and its aux: the sum of the MoE
    blocks' load-balance losses (≤ 1e-5 relative; exactly 0 for a dense
    arch)."""
    jc, tc = _configs("float32", arch)
    jp, tp = _params(jc, tc, seed=3)
    toks = _tokens(jc, seed=5)
    extra = _patches(jc)
    jl, jaux = JM.build_model(jc).forward(
        jp, {"tokens": jnp.asarray(toks),
             **{k: jnp.asarray(v) for k, v in extra.items()}})
    tl, taux = TM.build_model(tc).forward(
        tp, {"tokens": torch.as_tensor(toks), **extra})
    e = scaled(tl, jl)
    assert e <= TOL["float32"], f"forward {e:.3g}"
    assert taux.dtype == torch.float32 and taux.shape == ()
    if jc.n_experts:
        assert float(taux) > 0.0
        assert abs(float(taux) - float(jaux)) <= TOL_AUX * float(jaux)
    else:
        assert float(taux) == float(jaux) == 0.0


def test_flash_path_and_unstacked_params():
    """The reference's Pallas path and its unscanned layout
    (``scan_layers=False``) give the same model: forward logits and the
    prefill of a full-cache model."""
    jc, tc = _configs("float32", attn_impl="pallas", scan_layers=False,
                      n_layers=12)
    jp, tp = _params(jc, tc, seed=5)
    assert isinstance(jp["stack"]["scanned"], list)
    assert len(tp["stack"]["scanned"]) == 2
    toks = _tokens(jc, seed=2)
    jl, _ = JM.build_model(jc).forward(jp, {"tokens": jnp.asarray(toks)})
    tl, aux = TM.build_model(tc).forward(tp, {"tokens": torch.as_tensor(toks)})
    assert float(aux) == 0.0
    e = scaled(tl, jl)
    assert e <= TOL["float32"], f"forward {e:.3g}"
    assert tfa_kernel.launch_counts() == {"flash_attention": 0,
                                          "flash_attention_tc": 0}


def test_prepare_casts_matmul_weights_once():
    tc = dataclasses.replace(tg.SMOKE, use_landmark_decode=True)
    model = TM.build_model(tc)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    prepared = model.prepare(params)
    blk, pblk = params["stack"]["scanned"][0][5], \
        prepared["stack"]["scanned"][0][5]
    assert blk["mixer"]["wq"].dtype == torch.float32
    assert pblk["mixer"]["wq"].dtype == torch.bfloat16
    assert pblk["mlp"]["wo"].dtype == torch.bfloat16
    assert pblk["norm1"]["scale"].dtype == torch.float32
    assert prepared["embed"]["embedding"].dtype == torch.bfloat16
    toks = torch.as_tensor(_tokens(tc, seed=3))
    g = dict(generator=torch.Generator().manual_seed(1))
    a, _ = model.prefill(params, {"tokens": toks[:, :S_PRE]}, S_MAX, **g)
    g = dict(generator=torch.Generator().manual_seed(1))
    b, _ = model.prefill(prepared, {"tokens": toks[:, :S_PRE]}, S_MAX, **g)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the port on its own: decode == teacher-forced forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pattern,window", [
    (("attn",), None),
    (("local", "global"), 8),
])
def test_decode_matches_forward(pattern, window):
    cfg = TModelConfig(name="t", family="dense", n_layers=2, d_model=64,
                       n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                       vocab_size=128, layer_pattern=pattern, window=window,
                       dtype="float32")
    m = TM.build_model(cfg)
    params = m.init(torch.Generator().manual_seed(0), "cpu")
    S = 24
    toks = torch.randint(0, 128, (B, S), generator=torch.Generator()
                         .manual_seed(1))
    full_logits, _ = m.forward(params, {"tokens": toks})
    npre = 8
    _, cache = m.prefill(params, {"tokens": toks[:, :npre]}, S)
    for t in range(npre, S):
        lg, cache = m.decode_step(params, cache, toks[:, t:t + 1], t)
        np.testing.assert_allclose(lg.numpy(), full_logits[:, t].numpy(),
                                   rtol=2e-3, atol=2e-3)


def test_serve_cli_on_the_cpu(capsys):
    tserve.main(["--arch", "gemma3-12b", "--smoke", "--batch", "2",
                 "--prompt-len", "24", "--gen", "4", "--landmark",
                 "--device", "cpu"])
    out = capsys.readouterr().out
    assert "generated (2, 4) on cpu" in out and "serve ok" in out


@pytest.mark.parametrize("arch", [a for a in PORTED if a != "gemma3-12b"])
def test_serve_cli_serves_every_ported_arch(arch, capsys):
    tserve.main(["--arch", arch, "--smoke", "--batch", "2",
                 "--prompt-len", "24", "--gen", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "generated (2, 4) on cpu" in out and "serve ok" in out


def test_generate_fuses_patches():
    """``generate``'s patch embeddings reach the prefill: the first tokens
    depend on them, and the same patches give the same tokens."""
    tc = tconfigs.get_smoke("chameleon-34b")
    model = TM.build_model(tc)
    params = model.prepare(model.init(torch.Generator().manual_seed(0),
                                      "cpu"))
    prompts = torch.as_tensor(_tokens(tc, seed=6)[:, :S_PRE])
    patches = [torch.as_tensor(_x((B, N_PATCH, tc.d_model), s)).to(
        tc.cdtype) for s in (1, 1, 2)]
    outs = [tserve.generate(model, params, prompts, 3, patches=p)
            for p in patches]
    assert torch.equal(outs[0], outs[1])
    plain = tserve.generate(model, params, prompts, 3)
    logits = [model.prefill(params, {"tokens": prompts, "patches": p},
                            S_PRE + 3)[0] for p in (patches[0], patches[2])]
    assert not torch.equal(logits[0], logits[1])
    assert tuple(plain.shape) == tuple(outs[2].shape) == (B, 3)


def test_generate_takes_the_reference_draws():
    """generate's landmark draws reach every landmark layer: with the same
    draws two runs agree token for token; the port's own draws come from
    the generator."""
    tc = dataclasses.replace(tg.SMOKE, use_landmark_decode=True)
    model = TM.build_model(tc)
    params = model.prepare(model.init(torch.Generator().manual_seed(0),
                                      "cpu"))
    prompts = torch.as_tensor(_tokens(tc, seed=4)[:, :S_PRE])
    jc = dataclasses.replace(jg.SMOKE, use_landmark_decode=True)
    draws = reference_landmark_draws(jc, jax.random.PRNGKey(7), B, S_PRE)
    assert list(draws) == [5]
    a = tserve.generate(model, params, prompts, 4, landmark_draws=draws)
    b = tserve.generate(model, params, prompts, 4, landmark_draws=draws)
    assert torch.equal(a, b) and tuple(a.shape) == (B, 4)
    assert bool(((a >= 0) & (a < tc.vocab_size)).all())
