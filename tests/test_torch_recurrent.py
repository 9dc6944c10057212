"""The port's recurrent mixers (``repro_torch.models.recurrent``) held
against the JAX reference's (``repro.models.recurrent``) on the CPU.

RG-LRU, mLSTM and sLSTM at three configs: xlstm-125m's and
recurrentgemma-2b's SMOKE, and the reference's own small test config
(``tests/test_models.py::test_recurrent_decode_matches_full``: d_model 32,
2 heads of 16, lru_width 32, mlstm_chunk 4).  The reference's parameters
(its ``init_*`` from a JAX key) cross as numpy, and both sides get the same
seeded numpy activations.  Tolerances, scale-normalized (max |port − ref| /
max |ref|): f32 ≤ 1e-5, bf16 ≤ 5e-2.  The port's full pass hands prefill
its final state; it is held to the reference's ``_rec_prefill_state`` (a
per-token decode scan over the prompt) at the same tolerances, and the
port's doubling scan to its own per-token loop.

Training: each mixer's gradient against ``jax.grad`` of the reference's
``*_full`` (≤ 1e-4), ``LinearScan`` (the RG-LRU scan's adjoint) by
``gradcheck`` in f64 and against autograd of the per-token loop, the
gradient across the scan's time chunks; and the serving forms of RG-LRU
and sLSTM, grad mode on or off, bit for bit the code serving ran before
training was ported.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import configs as jconfigs
from repro.configs.base import ModelConfig as JModelConfig
from repro.models import recurrent as JR
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.models import model as TM
from repro_torch.models import recurrent as TR
from repro_torch.models import transformer as TT
from repro_torch.models.layers import as_compute

TOL = {"float32": 1e-5, "bfloat16": 5e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
B = 2
#: the reference's own recurrent test config (tests/test_models.py)
SMALL = dict(name="t", family="hybrid", n_layers=3, d_model=32, n_heads=2,
             n_kv_heads=1, head_dim=16, d_ff=64, vocab_size=64,
             layer_pattern=("rglru", "mlstm", "slstm"), window=8,
             lru_width=32, mlstm_chunk=4)
#: (config, mixer kind, full-pass length): every mixer of each config
CASES = [("xlstm-125m", "mlstm", 64), ("xlstm-125m", "slstm", 40),
         ("recurrentgemma-2b", "rglru", 40), ("small", "rglru", 12),
         ("small", "mlstm", 12), ("small", "slstm", 12)]
IDS = [f"{c}-{k}" for c, k, _ in CASES]


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


def _configs(name: str, dtype: str):
    if name == "small":
        return (JModelConfig(**SMALL, dtype=dtype),
                TModelConfig(**SMALL, dtype=dtype))
    return (dataclasses.replace(jconfigs.get_smoke(name), dtype=dtype),
            dataclasses.replace(tconfigs.get_smoke(name), dtype=dtype))


JINIT = {"rglru": JR.init_rglru, "mlstm": JR.init_mlstm,
         "slstm": JR.init_slstm}
JFULL = {"rglru": JR.rglru_full, "mlstm": JR.mlstm_full,
         "slstm": JR.slstm_full}
JDECODE = {"rglru": JR.rglru_decode, "mlstm": JR.mlstm_decode,
           "slstm": JR.slstm_decode}
JSTATE = {"rglru": JR.init_rglru_state, "mlstm": JR.init_mlstm_state,
          "slstm": JR.init_slstm_state}


def _setup(name, kind, dtype, seed=0):
    jc, tc = _configs(name, dtype)
    jp = JINIT[kind](jax.random.PRNGKey(seed), jc)
    tp = convert._tree_to_torch(jax.tree.map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


def _x(tc, S, seed=1):
    x = np.random.default_rng(seed).normal(size=(B, S, tc.d_model)).astype(
        np.float32)
    return (jnp.asarray(x).astype(JDT[tc.dtype]),
            torch.as_tensor(x).to(tc.cdtype))


def linear_scan_loop(log_a, b, h0=None):
    """h_t = exp(log_a_t)·h_{t−1} + b_t one step a token: the plain oracle
    of the port's doubling scan."""
    h = torch.zeros_like(b[:, 0]) if h0 is None else h0
    out = torch.empty_like(b)
    for t in range(b.shape[1]):
        h = torch.exp(log_a[:, t]) * h + b[:, t]
        out[:, t] = h
    return out


def _check_state(tstate: dict, jstate: dict, tol: float, what: str):
    assert set(tstate) == set(jstate)
    for name in jstate:
        assert tstate[name].dtype == getattr(
            torch, str(jstate[name].dtype)), (what, name)
        e = scaled(tstate[name], jstate[name])
        assert e <= tol, f"{what} state {name}: {e:.3g}"


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("name,kind,S", CASES, ids=IDS)
def test_full_matches_reference(name, kind, S, dtype):
    jc, tc, jp, tp = _setup(name, kind, dtype)
    jx, tx = _x(tc, S)
    out = TR.FULL[kind](tp, tc, tx)
    assert out.dtype == tc.cdtype and out.shape == tx.shape
    e = scaled(out, JFULL[kind](jp, jc, jx))
    assert e <= TOL[dtype], f"{kind}_full {e:.3g}"


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("name,kind,S", CASES, ids=IDS)
def test_prefill_state_matches_reference_rec_prefill_state(name, kind, S,
                                                           dtype):
    """The state the port's full pass hands prefill against the reference's
    per-token decode scan over the same input, and the pass's output
    against the reference's ``*_full``."""
    jc, tc, jp, tp = _setup(name, kind, dtype)
    jx, tx = _x(tc, S, seed=2)
    y, state = TR.PREFILL[kind](tp, tc, tx)
    e = scaled(y, JFULL[kind](jp, jc, jx))
    assert e <= TOL[dtype], f"{kind}_prefill output {e:.3g}"
    jstate = JT._rec_prefill_state(jp, jc, kind, jx)
    _check_state(state, jstate, TOL[dtype], f"{kind} prefill")


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("name,kind,S", CASES, ids=IDS)
def test_decode_matches_reference(name, kind, S, dtype):
    """Three decode steps from the zero state and then three more from the
    state of an S-token prefix (the reference's decode scan on both
    sides): each step's output and state."""
    jc, tc, jp, tp = _setup(name, kind, dtype)
    jx, tx = _x(tc, S, seed=3)
    jstate = JT._rec_prefill_state(jp, jc, kind, jx)
    tstate = TT._rec_prefill_state(tp, tc, kind, tx)
    _check_state(tstate, jstate, TOL[dtype], f"{kind} decode scan")
    zero_j, zero_t = JSTATE[kind](jc, B), TR.INIT_STATE[kind](tc, B, "cpu")
    _check_state(zero_t, zero_j, 0.0, f"{kind} zero")
    jd, td = _x(tc, 6, seed=4)
    for step in range(6):
        if step < 3:
            js, ts = zero_j, zero_t
        else:
            js, ts = jstate, tstate
        jy, js2 = JDECODE[kind](jp, jc, jd[:, step:step + 1], js)
        ty, ts2 = TR.DECODE[kind](tp, tc, td[:, step:step + 1], ts)
        assert ts2 is ts                          # updated in place
        assert ty.dtype == tc.cdtype and tuple(ty.shape) == (B, 1,
                                                             tc.d_model)
        e = scaled(ty, jy)
        assert e <= TOL[dtype], f"{kind} decode step {step}: {e:.3g}"
        _check_state(ts, js2, TOL[dtype], f"{kind} decode step {step}")
        if step < 3:
            zero_j = js2
        else:
            jstate = js2


@pytest.mark.parametrize("S", [1, 2, 3, 7, 64, 300])
@pytest.mark.parametrize("with_h0", [False, True])
def test_scan_matches_its_per_token_loop(S, with_h0):
    """``linear_scan`` (the doubling scan) against the per-token
    ``linear_scan_loop``, f32 ≤ 1e-5, with log a spanning the RG-LRU's
    (−8·softplus(Λ), 0] and b of either sign."""
    g = np.random.default_rng(S)
    log_a = torch.as_tensor(-g.uniform(0.0, 0.1, (B, S, 24)),
                            dtype=torch.float32)
    b = torch.as_tensor(g.normal(size=(B, S, 24)), dtype=torch.float32)
    h0 = torch.as_tensor(g.normal(size=(B, 24)),
                         dtype=torch.float32) if with_h0 else None
    e = scaled(TR.linear_scan(log_a, b, h0), linear_scan_loop(log_a, b, h0))
    assert e <= TOL["float32"], f"scan vs loop at S = {S}: {e:.3g}"


@pytest.mark.parametrize("dtype", list(TOL))
def test_scan_chunks_carry_the_state(dtype, monkeypatch):
    """RG-LRU's scan in time chunks of 16 and 7 tokens (the carry enters
    each chunk as exp(Σ log a)·h) against one chunk, and both against the
    reference; S = 40 is no multiple of either."""
    jc, tc, jp, tp = _setup("recurrentgemma-2b", "rglru", dtype)
    jx, tx = _x(tc, 40, seed=5)
    one_y, one_s = TR.rglru_prefill(tp, tc, tx)
    ref = JR.rglru_full(jp, jc, jx)
    jstate = JT._rec_prefill_state(jp, jc, "rglru", jx)
    for chunk in (16, 7):
        monkeypatch.setattr(TR, "SCAN_CHUNK", chunk)
        y, state = TR.rglru_prefill(tp, tc, tx)
        assert scaled(y, ref) <= TOL[dtype]
        _check_state(state, jstate, TOL[dtype], f"chunk {chunk}")
        assert scaled(y, one_y) <= TOL[dtype]
        assert torch.equal(state["conv"], one_s["conv"])


def test_prefill_state_matches_the_ports_decode_scan():
    """The port on its own: each mixer's full-pass state against the port's
    ``_rec_prefill_state`` (its per-token oracle), f32 ≤ 1e-5, also at a
    prompt shorter than RG-LRU's conv history (the state's leading entries
    zero)."""
    for name, kind, S in CASES + [("recurrentgemma-2b", "rglru", 2),
                                  ("xlstm-125m", "slstm", 1)]:
        _, tc, _, tp = _setup(name, kind, "float32")
        _, tx = _x(tc, S, seed=6)
        _, state = TR.PREFILL[kind](tp, tc, tx)
        oracle = TT._rec_prefill_state(tp, tc, kind, tx)
        for key in oracle:
            e = scaled(state[key], oracle[key])
            assert e <= TOL["float32"], f"{name} {kind} S={S} {key}: {e:.3g}"
    _, tc, _, tp = _setup("recurrentgemma-2b", "rglru", "float32")
    _, tx = _x(tc, 2, seed=7)
    conv = TR.rglru_prefill(tp, tc, tx)[1]["conv"]
    assert conv.shape == (B, tc.rglru_conv_width - 1, tc.lru_width)
    assert bool((conv[:, 0] == 0).all()) and not bool((conv[:, 1:] == 0)
                                                      .all())


def test_mlstm_refuses_a_length_off_its_chunk():
    """mLSTM takes S % min(mlstm_chunk, S) == 0, as the reference asserts;
    there is no padding."""
    _, tc, _, tp = _setup("xlstm-125m", "mlstm", "float32")
    for S in (33, 50):
        _, tx = _x(tc, S)
        with pytest.raises(ValueError, match="multiple of its chunk"):
            TR.mlstm_full(tp, tc, tx)
    _, tx = _x(tc, 20)                      # one chunk of 20
    assert TR.mlstm_full(tp, tc, tx).shape == tx.shape


def test_prepare_casts_by_mixer_kind():
    """``prepare`` casts each recurrent mixer's compute weights to bf16 and
    leaves the f32 ones: sLSTM's ``wo`` (the output gate's input weight,
    read in f32 by the reference) and its other gate and recurrent
    weights, mLSTM's ``wi`` / ``wf`` / ``bf``, RG-LRU's ``lam``; prefill
    and decode give the same bits from the prepared and the raw params."""
    for arch in ("xlstm-125m", "recurrentgemma-2b"):
        tc = tconfigs.get_smoke(arch)
        model = TM.build_model(tc)
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        prepared = model.prepare(params)
        for (_, r, i, kind), blk in zip(
                TT.layer_slots(tc), [b for rep in prepared["stack"]["scanned"]
                                     for b in rep]
                + prepared["stack"]["remainder"]):
            mixer = blk["mixer"]
            if kind == "slstm":
                for n in ("wz", "wi", "wf", "wo", "rz", "ri", "rf", "ro",
                          "bf"):
                    assert mixer[n].dtype == torch.float32, n
                assert mixer["wo_proj"].dtype == torch.bfloat16
            elif kind == "mlstm":
                for n in ("wq", "wk", "wv", "wog", "wo"):
                    assert mixer[n].dtype == torch.bfloat16, n
                for n in ("wi", "wf", "bf"):
                    assert mixer[n].dtype == torch.float32, n
            elif kind == "rglru":
                for n in TR.COMPUTE_WEIGHTS["rglru"]:
                    assert mixer[n].dtype == torch.bfloat16, n
                assert mixer["lam"].dtype == torch.float32
            else:
                assert mixer["wq"].dtype == torch.bfloat16
            assert blk["norm1"]["scale"].dtype == torch.float32
        toks = torch.as_tensor(np.random.default_rng(3).integers(
            0, tc.vocab_size, (B, 36)))
        outs = []
        for p in (params, prepared):
            lg, cache = model.prefill(p, {"tokens": toks[:, :32]}, 40)
            seq = [lg]
            for t in range(32, 36):
                lg, cache = model.decode_step(p, cache, toks[:, t:t + 1], t)
                seq.append(lg)
            outs.append(torch.stack(seq))
        assert torch.equal(outs[0], outs[1]), arch


@pytest.mark.parametrize("arch,S,npre", [("small", 12, 4),
                                         ("xlstm-125m", 64, 32),
                                         ("recurrentgemma-2b", 40, 32)])
def test_decode_matches_forward(arch, S, npre):
    """The port on its own, as the reference's
    ``test_recurrent_decode_matches_full``: a prefill of ``npre`` tokens,
    then teacher-forced decode against ``forward``'s logits at the
    reference's tolerance (rtol = atol = 5e-3), in f32."""
    _, tc = _configs(arch, "float32")
    m = TM.build_model(tc)
    params = m.init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, tc.vocab_size, (1, S),
                         generator=torch.Generator().manual_seed(1))
    full, _ = m.forward(params, {"tokens": toks})
    _, cache = m.prefill(params, {"tokens": toks[:, :npre]}, S)
    for t in range(npre, S):
        lg, cache = m.decode_step(params, cache, toks[:, t:t + 1], t)
        np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(),
                                   rtol=5e-3, atol=5e-3)


# ---------------------------------------------------------------------------
# gradients (training)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [1, 2, 7, 16])
@pytest.mark.parametrize("with_h0", [False, True])
def test_linear_scan_gradient(S, with_h0):
    """``LinearScan`` (the doubling scan forward, its adjoint scan
    backward) in f64: ``torch.autograd.gradcheck`` against finite
    differences, and its gradient against autograd of the per-token
    ``linear_scan_loop`` (≤ 1e-10 scale-normalized)."""
    g = np.random.default_rng(S + 10 * with_h0)
    log_a = torch.as_tensor(-g.uniform(0.0, 0.5, (B, S, 3)),
                            dtype=torch.float64).requires_grad_(True)
    b = torch.as_tensor(g.normal(size=(B, S, 3)),
                        dtype=torch.float64).requires_grad_(True)
    h0 = torch.as_tensor(g.normal(size=(B, 3)), dtype=torch.float64
                         ).requires_grad_(True) if with_h0 else None
    assert torch.autograd.gradcheck(TR.LinearScan.apply, (log_a, b, h0))
    inputs = [t for t in (log_a, b, h0) if t is not None]
    dh = torch.as_tensor(g.normal(size=(B, S, 3)), dtype=torch.float64)
    got = torch.autograd.grad(TR.linear_scan(log_a, b, h0), inputs, dh)
    ref = torch.autograd.grad(linear_scan_loop(log_a, b, h0), inputs, dh)
    for a, r in zip(got, ref):
        assert scaled(a, r) <= 1e-10


@pytest.mark.parametrize("name,kind,S", CASES, ids=IDS)
def test_full_gradient_matches_reference(name, kind, S):
    """Each mixer's ``*_full`` differentiated in f32 against ``jax.grad``
    of the reference's, under a seeded cotangent: the input's and every
    parameter's gradient ≤ 1e-4 scale-normalized (RG-LRU through
    ``LinearScan``, sLSTM through its out-of-place loop, mLSTM as it
    is)."""
    jc, tc, jp, tp = _setup(name, kind, "float32")
    jx, tx = _x(tc, S, seed=8)
    cot = np.random.default_rng(9).normal(size=tuple(tx.shape)).astype(
        np.float32)
    jgp, jgx = jax.grad(lambda p, x: jnp.sum(JFULL[kind](p, jc, x) * cot),
                        argnums=(0, 1))(jp, jx)
    names = sorted(tp)
    leaves = [tp[n].requires_grad_(True) for n in names]
    tx.requires_grad_(True)
    y = TR.FULL[kind](tp, tc, tx)
    grads = torch.autograd.grad((y * torch.as_tensor(cot)).sum(),
                                leaves + [tx])
    for n, g in zip(names + ["x"], grads):
        e = scaled(g, jgx if n == "x" else jgp[n])
        assert e <= 1e-4, f"{kind} d{n}: {e:.3g}"


@pytest.mark.parametrize("dtype", list(TOL))
def test_scan_chunks_carry_the_gradient(dtype, monkeypatch):
    """RG-LRU in time chunks of 16 and 7 tokens: the carry h_last enters
    the next chunk with its gradient, so every parameter's and the
    input's gradient equals one chunk's (f32 ≤ 1e-5, bf16 ≤ 5e-2)."""
    _, tc, _, tp = _setup("recurrentgemma-2b", "rglru", dtype)
    _, tx = _x(tc, 40, seed=10)
    names = sorted(tp)

    def grads():
        leaves = [tp[n].detach().requires_grad_(True) for n in names]
        x = tx.detach().requires_grad_(True)
        y = TR.rglru_full(dict(zip(names, leaves)), tc, x)
        return torch.autograd.grad(y.float().square().sum(), leaves + [x])

    one = grads()
    for chunk in (16, 7):
        monkeypatch.setattr(TR, "SCAN_CHUNK", chunk)
        for n, a, b in zip(names + ["x"], grads(), one):
            assert scaled(a, b) <= TOL[dtype], (chunk, n)


def _rglru_prefill_serving(params, cfg, x):
    """RG-LRU's prefill as serving ran it before training was ported (the
    same code, the doubling scan called directly)."""
    dt = cfg.cdtype
    S = x.shape[1]
    u_in = x @ as_compute(params["w_x"], dt)
    u = TR._causal_conv_full(u_in, as_compute(params["conv_k"], dt))
    K = cfg.rglru_conv_width
    conv = F.pad(u_in, (0, 0, max(K - 1 - S, 0), 0))[:, -(K - 1):]
    hb = torch.empty_like(u)
    h_last = None
    for s0 in range(0, S, TR.SCAN_CHUNK):
        log_a, b = TR._rglru_gates(params, cfg, u[:, s0:s0 + TR.SCAN_CHUNK])
        h = TR._doubling_scan(log_a, b, h_last)
        h_last = h[:, -1].clone()
        hb[:, s0:s0 + TR.SCAN_CHUNK] = h.to(dt)
    gate = F.gelu(x @ as_compute(params["w_gate"], dt), approximate="tanh")
    return (hb * gate) @ as_compute(params["w_out"], dt), {"h": h_last,
                                                           "conv": conv}


def _slstm_prefill_serving(params, cfg, x):
    """sLSTM's prefill as serving ran it before training was ported: each
    step's h written in place (``out=``)."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    w, r = TR._slstm_weights(params)
    proj = (x.to(torch.float32) @ w).view(B, S, H, 4 * hd).permute(
        1, 2, 0, 3).contiguous()
    state = TR._state_hb(TR.init_slstm_state(cfg, B, x.device))
    hs = torch.empty((S, H, B, hd), dtype=torch.float32)
    state = TR._slstm_loop(proj, r, params["bf"][:, None], state, hs, 0, S)
    y = TR._out_proj(hs.permute(2, 0, 1, 3).to(cfg.cdtype),
                     params["wo_proj"], cfg.cdtype)
    return y, TR._state_bh(state)


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("kind", ["rglru", "slstm"])
def test_serving_forms_are_unchanged(kind, dtype):
    """RG-LRU's and sLSTM's prefill with grad mode off and on (nothing
    requiring grad) equal the serving code as it was before training was
    ported, bit for bit, and record no autograd graph; the training form
    (the params requiring grad) computes the same bits."""
    name = "recurrentgemma-2b" if kind == "rglru" else "xlstm-125m"
    _, tc, _, tp = _setup(name, kind, dtype)
    _, tx = _x(tc, 40, seed=11)
    serving = {"rglru": _rglru_prefill_serving,
               "slstm": _slstm_prefill_serving}[kind]
    with torch.no_grad():
        ref_y, ref_s = serving(tp, tc, tx)
    for grad_mode in (False, True):
        with torch.set_grad_enabled(grad_mode):
            y, state = TR.PREFILL[kind](tp, tc, tx)
        assert y.grad_fn is None and torch.equal(y, ref_y), grad_mode
        for k in ref_s:
            assert torch.equal(state[k], ref_s[k]), (grad_mode, k)
    trained = {k: v.detach().requires_grad_(True) for k, v in tp.items()}
    y, state = TR.PREFILL[kind](trained, tc, tx)
    assert y.grad_fn is not None and torch.equal(y.detach(), ref_y)
    for k in ref_s:
        assert torch.equal(state[k].detach(), ref_s[k]), k
