"""The port's encoder-decoder (whisper-large-v3) held against the JAX
reference on the CPU, at whisper's SMOKE config.

The reference model is built from SMOKE and initialized at PRNGKey(0); its
params are carried across by ``convert.model_params_from_reference``, in
both layouts of the encoder (``scan_layers`` True: stacked on the layer
axis; False: a list), and both sides get the same numpy frames and tokens.
Compared: ``_encode``, ``encoder_kv`` + ``cross_attention``, ``forward``'s
logits, ``prefill``'s logits and both caches (the decoder's self-attention
k/v and the encoder K/V, through ``convert.cache_to_reference``), and 4
greedy decode steps: the port is fed the reference's tokens, its logits are
held to the reference's and, in f32, its own greedy tokens must equal the
reference's.  On the CPU every attention is B6's plain version.

Tolerances, scale-normalized (max |port − ref| / max |ref|): f32 ≤ 1e-5,
bf16 ≤ 5e-2 (bf16 intermediates round at different places in the two
frameworks).  The reference's eager prefill takes seconds on the CPU, so
its outputs are computed once per (layout, dtype) in module fixtures.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as JA
from repro.models import model as JM
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.kernels.flash_attention import ops as tfa_ops
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as TA
from repro_torch.models import model as TM

TOL = {"float32": 1e-5, "bfloat16": 5e-2}
ARCH = "whisper-large-v3"
B, S_ENC, S_DEC, MAX_LEN, N_DECODE = 2, 24, 8, 12, 4


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Six test workers share the CPU: keep torch's intra-op pool small,
    and make one small ``torch.exp`` call first (see ROADMAP C)."""
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


def _configs(dtype: str, scan_layers: bool = True, **kw):
    return tuple(dataclasses.replace(c, dtype=dtype, scan_layers=scan_layers,
                                     **kw)
                 for c in (jconfigs.get_smoke(ARCH), tconfigs.get_smoke(ARCH)))


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    frames = rng.normal(size=(B, S_ENC, cfg.frontend_dim)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, S_DEC)).astype(np.int32)
    return frames, toks


class Run:
    """Both sides built from one reference init, with the reference's
    outputs on the shared inputs."""

    def __init__(self, dtype: str, scan_layers: bool):
        self.dtype = dtype
        self.jc, self.tc = _configs(dtype, scan_layers)
        self.jm, self.tm = JM.build_model(self.jc), TM.build_model(self.tc)
        self.jp = self.jm.init(jax.random.PRNGKey(0))
        self.tp = convert.model_params_from_reference(
            jax.tree.map(np.asarray, self.jp), self.tc, device="cpu")
        self.frames, self.toks = _inputs(self.jc)
        jf = jnp.asarray(self.frames)
        self.enc = np.asarray(JM._encode(self.jp, self.jc, jf))
        self.fwd = np.asarray(self.jm.forward(
            self.jp, {"frames": jf, "tokens": jnp.asarray(self.toks)})[0])
        logits, cache = self.jm.prefill(
            self.jp, {"frames": jf, "tokens": jnp.asarray(self.toks[:, :1])},
            jax.random.PRNGKey(1), MAX_LEN)
        self.prefill = (np.asarray(logits), jax.tree.map(np.asarray, cache))
        # greedy decode: each step feeds the argmax of the last logits
        self.steps = []
        tok = jnp.argmax(logits, axis=-1)
        for t in range(1, 1 + N_DECODE):
            logits, cache = self.jm.decode_step(
                self.jp, cache, tok[:, None], jnp.asarray(t, jnp.int32))
            self.steps.append((np.asarray(tok), np.asarray(logits)))
            tok = jnp.argmax(logits, axis=-1)
        self.last_token = np.asarray(tok)

    def batch(self, n_tokens: int) -> dict:
        return {"frames": self.frames,
                "tokens": torch.as_tensor(self.toks[:, :n_tokens])}


_RUNS = {}


def _run(dtype: str, scan_layers: bool) -> Run:
    key = (dtype, scan_layers)
    if key not in _RUNS:
        _RUNS[key] = Run(dtype, scan_layers)
    return _RUNS[key]


@pytest.fixture(scope="module", params=[
    pytest.param(("float32", True), id="f32-scanned"),
    pytest.param(("float32", False), id="f32-unrolled"),
    pytest.param(("bfloat16", True), id="bf16-scanned"),
    pytest.param(("bfloat16", False), id="bf16-unrolled")])
def run(request):
    return _run(*request.param)


# ---------------------------------------------------------------------------
# configs and trees
# ---------------------------------------------------------------------------

def test_config_and_arithmetic_carry_over():
    for jc, tc in ((jconfigs.get_config(ARCH), tconfigs.get_config(ARCH)),
                   (jconfigs.get_smoke(ARCH), tconfigs.get_smoke(ARCH))):
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        assert tc.param_count() == jc.param_count()
        assert tc.cdtype == torch.bfloat16 and tc.pdtype == torch.float32
    full = tconfigs.get_config(ARCH)
    assert (full.n_enc_layers, full.n_dec_layers, full.d_model,
            full.n_heads, full.n_kv_heads, full.head_dim, full.d_ff,
            full.vocab_size, full.frontend_dim, full.mlp_variant) == (
        32, 32, 1280, 20, 20, 64, 5120, 51_866, 128, "gelu")


@pytest.mark.parametrize("scan_layers", [True, False])
def test_init_tree_matches_the_reference(scan_layers):
    """The port's ``init`` makes the tree ``model_params_from_reference``
    carries over (names, shapes, dtypes), with the reference's number of
    parameters: the encoder in either layout, the decoder always stacked
    and ``xattn`` vmapped on the reference's side."""
    jc, tc = _configs("float32", scan_layers)
    jp = JM.build_model(jc).init(jax.random.PRNGKey(0))
    tp = convert.model_params_from_reference(jax.tree.map(np.asarray, jp),
                                             tc, device="cpu")
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
    assert set(own) == set(jp) == {"frontend_proj", "encoder", "enc_norm",
                                   "decoder", "xattn", "embed", "final_norm"}
    assert len(own["xattn"]) == len(own["decoder"]["scanned"]) == \
        jc.n_dec_layers
    assert len(own["encoder"]["scanned"]) == jc.n_enc_layers
    n_ref = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jp))
    assert sum(int(np.prod(s)) for _, s, _ in leaves(own)) == n_ref


def test_prepare_casts_the_frontend_projection_once():
    tc = tconfigs.get_smoke(ARCH)
    model = TM.build_model(tc)
    p = model.prepare(model.init(torch.Generator().manual_seed(0), "cpu"))
    assert p["frontend_proj"].dtype == torch.bfloat16
    assert p["xattn"][0]["xattn"]["wq"].dtype == torch.bfloat16
    assert p["xattn"][0]["xnorm"]["scale"].dtype == torch.float32
    assert p["encoder"]["scanned"][0][0]["mlp"]["wi_up"].dtype == \
        torch.bfloat16


@pytest.mark.parametrize("enc_len", [1500, 7])
def test_cache_shape_matches_the_reference(enc_len):
    jc, tc = _configs("bfloat16")
    ref = jax.eval_shape(lambda: JM._encdec_cache(jc, 3, 448,
                                                  enc_len=enc_len))
    got = TM.build_model(tc).cache_shape(3, 448, "cpu", enc_len=enc_len)
    got_np = convert.cache_to_reference(got, tc)
    assert jax.tree.structure(ref) == jax.tree.structure(got_np) == \
        jax.tree.structure({"self": {"k": 0, "v": 0}, "enc_kv": (0, 0)})
    assert [(x.shape, str(x.dtype)) for x in jax.tree.leaves(ref)] == \
        [(tuple(t.shape), str(t.dtype).split(".")[-1])
         for t in jax.tree.leaves(got)]
    assert not any(x.any() for x in jax.tree.leaves(got_np))


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def test_encode_matches_the_reference(run):
    """The frontend projection, the sinusoid, the bidirectional stack with
    RoPE on its q and k, and ``enc_norm``."""
    got = TM._encode(run.tp, run.tc, run.frames)
    assert got.dtype == run.tc.cdtype
    assert tuple(got.shape) == (B, S_ENC, run.tc.d_model)
    e = scaled(got, run.enc)
    assert e <= TOL[run.dtype], f"_encode {e:.3g}"


@pytest.mark.parametrize("S,d", [(24, 64), (1500, 1280)])
def test_sinusoid_matches_the_reference(S, d):
    """The f32 sinusoid is as close to its f64 value as the reference's.
    The two round pow(10⁴, 2i/d) to neighbouring f32 values in places, and
    a one-ulp difference there moves an angle of ~S radians by ~S·2⁻²⁴:
    the two sides then differ by less than either's own f32 error, which
    is what they are held to."""
    pos = np.arange(S, dtype=np.float64)[:, None]
    dim = np.arange(d // 2, dtype=np.float64)[None, :]
    ang = pos / (10_000.0 ** (2 * dim / d))
    exact = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    got = TM._sinusoid(S, d, "cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == (S, d)
    ref = np.asarray(JM._sinusoid(S, d))
    ref_err = np.abs(ref - exact).max()
    assert np.abs(got.numpy() - exact).max() <= ref_err
    assert np.abs(got.numpy() - ref).max() <= ref_err


@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("n_q", [1, 5])
@pytest.mark.parametrize("dtype", list(TOL))
def test_cross_attention_matches_the_reference(dtype, n_q, qk_norm,
                                              monkeypatch):
    """``encoder_kv`` and ``cross_attention`` of one cross-attention's
    weights, at a decode step (one query) and a prompt (5 queries), with
    and without qk-norm: one non-causal B6 call (its plain version here)
    against the reference's einsum attention."""
    jc, tc = _configs(dtype, qk_norm=qk_norm)
    jp = JA.init_attention(jax.random.PRNGKey(3), jc, cross=True)
    if qk_norm:        # non-zero norm scales, so the norms are exercised
        jp = dict(jp, q_norm={"scale": jnp.full((jc.head_dim,), 0.3)},
                  k_norm={"scale": jnp.full((jc.head_dim,), -0.2)})
    tp = convert._tree_to_torch(jax.tree.map(np.asarray, jp), "cpu")
    assert set(tp) == set(TA.init_attention(
        torch.Generator().manual_seed(0), tc, "cpu", cross=True))
    rng = np.random.default_rng(4)
    enc = rng.normal(size=(B, S_ENC, jc.d_model)).astype(np.float32)
    x = rng.normal(size=(B, n_q, jc.d_model)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    jk, jv = JA.encoder_kv(jp, jc, jnp.asarray(enc, jdt))
    tk, tv = TA.encoder_kv(tp, tc, torch.as_tensor(enc).to(tc.cdtype))
    assert scaled(tk, jk) <= TOL[dtype] and scaled(tv, jv) <= TOL[dtype]
    ref = JA.cross_attention(jp, jc, jnp.asarray(x, jdt), jk, jv)
    calls = []
    real = tfa_ops.flash_attention

    def counted(q, k, v, causal=True, window=None):
        calls.append((tuple(q.shape), tuple(k.shape), causal, window))
        return real(q, k, v, causal=causal, window=window)

    monkeypatch.setattr(tfa_ops, "flash_attention", counted)
    got = TA.cross_attention(tp, tc, torch.as_tensor(x).to(tc.cdtype), tk, tv)
    assert calls == [((B, jc.n_heads, n_q, jc.head_dim),
                      (B, jc.n_kv_heads, S_ENC, jc.head_dim), False, None)]
    assert got.dtype == tc.cdtype
    e = scaled(got, ref)
    assert e <= TOL[dtype], f"cross_attention {e:.3g}"


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_forward_matches_the_reference(run):
    logits, aux = run.tm.forward(run.tp, run.batch(S_DEC))
    assert tuple(logits.shape) == (B, S_DEC, run.tc.vocab_size)
    assert aux.dtype == torch.float32 and float(aux) == 0.0
    e = scaled(logits, run.fwd)
    assert e <= TOL[run.dtype], f"forward {e:.3g}"


def test_prefill_logits_and_caches_match_the_reference(run):
    logits, cache = run.tm.prefill(run.tp, run.batch(1), MAX_LEN)
    assert logits.dtype == run.tc.cdtype
    e = scaled(logits, run.prefill[0])
    assert e <= TOL[run.dtype], f"prefill logits {e:.3g}"
    ref = run.prefill[1]
    got = convert.cache_to_reference(cache, run.tc)
    assert jax.tree.structure(ref) == jax.tree.structure(got)
    errs = jax.tree.map(lambda r, p: scaled(p, r), ref, got)
    assert max(jax.tree.leaves(errs)) <= TOL[run.dtype], errs
    # the self cache past the prompt is zero, as the reference pads it
    assert not got["self"]["k"][:, :, 1:].any()


def test_greedy_decode_matches_the_reference(run):
    """4 greedy steps after the prefill: the port is fed the reference's
    tokens; its logits are held to the reference's, and in f32 its own
    argmax equals the reference's next token."""
    logits, cache = run.tm.prefill(run.tp, run.batch(1), MAX_LEN)
    mine = []
    for t, (tok, ref) in enumerate(run.steps, start=1):
        if run.dtype == "float32":
            assert np.array_equal(torch.argmax(logits, -1).numpy(), tok)
        logits, cache = run.tm.decode_step(
            run.tp, cache, torch.as_tensor(tok.copy())[:, None], t)
        e = scaled(logits, ref)
        assert e <= TOL[run.dtype], f"decode step {t}: {e:.3g}"
        mine.append(torch.argmax(logits, -1).numpy())
    if run.dtype == "float32":
        assert np.array_equal(mine[-1], run.last_token)


def test_decode_matches_forward():
    """Prefill of the first token and teacher-forced decode steps give
    ``forward``'s logits at the same positions (f32, the port alone)."""
    tc = tconfigs.get_smoke(ARCH)
    tc = dataclasses.replace(tc, dtype="float32")
    model = TM.build_model(tc)
    params = model.init(torch.Generator().manual_seed(5), "cpu")
    frames, toks = _inputs(tc, seed=6)
    toks = torch.as_tensor(toks)
    full, _ = model.forward(params, {"frames": frames, "tokens": toks})
    logits, cache = model.prefill(params, {"frames": frames,
                                           "tokens": toks[:, :1]}, S_DEC)
    np.testing.assert_allclose(logits.numpy(), full[:, 0].numpy(),
                               rtol=1e-5, atol=1e-5)
    for t in range(1, S_DEC):
        logits, cache = model.decode_step(params, cache, toks[:, t:t + 1], t)
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_encdec_launches_b6_per_layer(monkeypatch):
    """A prefill calls flash attention once per encoder layer
    (non-causal), once per decoder layer's self-attention (causal) and once
    per cross-attention (non-causal); a decode step once per
    cross-attention, the self-attention reading its cache directly."""
    tc = tconfigs.get_smoke(ARCH)
    model = TM.build_model(tc)
    params = model.prepare(model.init(torch.Generator().manual_seed(0),
                                      "cpu"))
    calls = []
    real = tfa_ops.flash_attention

    def counted(q, k, v, causal=True, window=None):
        calls.append((q.shape[2], k.shape[2], causal))
        return real(q, k, v, causal=causal, window=window)

    monkeypatch.setattr(tfa_ops, "flash_attention", counted)
    frames, toks = _inputs(tc)
    logits, cache = model.prefill(
        params, {"frames": frames, "tokens": torch.as_tensor(toks[:, :1])},
        MAX_LEN)
    L_enc, L_dec = tc.n_enc_layers, tc.n_dec_layers
    assert calls == [(S_ENC, S_ENC, False)] * L_enc + \
        [(1, 1, True), (1, S_ENC, False)] * L_dec
    calls.clear()
    model.decode_step(params, cache, torch.argmax(logits, -1)[:, None], 1)
    assert calls == [(1, S_ENC, False)] * L_dec


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_generate_takes_frames():
    """``generate``'s frames reach the encoder: the same frames give the
    same tokens, other frames other logits."""
    tc = tconfigs.get_smoke(ARCH)
    model = TM.build_model(tc)
    params = model.prepare(model.init(torch.Generator().manual_seed(0),
                                      "cpu"))
    frames = [torch.as_tensor(_inputs(tc, seed=s)[0]).to(tc.cdtype)
              for s in (1, 1, 2)]
    prompts = torch.zeros((B, 1), dtype=torch.int64)
    a, b = (tserve.generate(model, params, prompts, 5, max_len=16,
                            frames=f) for f in frames[:2])
    assert torch.equal(a, b) and tuple(a.shape) == (B, 5)
    assert bool(((a >= 0) & (a < tc.vocab_size)).all())
    la, lb = (model.prefill(params, {"frames": f, "tokens": prompts}, 4)[0]
              for f in (frames[0], frames[2]))
    assert not torch.equal(la, lb)


def test_serve_cli_serves_whisper(capsys):
    tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "generated (4, 32) on cpu" in out and "serve ok" in out
