"""Training in the port held against the JAX reference (CPU): the losses,
the gradient of every parameter, the train step, the trainer and the
train state carried across.

- For each of the eight attention archs' SMOKE config (gemma3-12b, yi-6b,
  yi-9b, minitron-4b, chameleon-34b with patch embeddings, qwen2-moe-a2.7b
  and deepseek-v3-671b with the MoE aux loss and MTP, whisper-large-v3)
  and the two recurrent ones (recurrentgemma-2b: RG-LRU and local
  attention; xlstm-125m: mLSTM and sLSTM; at 64 tokens, two mLSTM chunks
  and past the local window of 16), in f32 with converted weights under
  the default ``remat="full"``: ``Model.loss`` and every metric against
  the reference's ``loss`` (≤ 1e-5), and every gradient leaf against
  ``jax.grad``'s (≤ 1e-4 scale-normalized, none missing) — the MoE
  dispatch's backward and the RG-LRU scan's adjoint included; in bf16
  the loss ≤ 5e-2 (MoE through ``test_torch_models.RoutingHandover``).
- ``make_train_step`` on the reference test's ``itiny`` config in f32, 3
  steps against the reference's jitted step (losses and params ≤ 1e-5);
  accum = 1 against accum = 2 on the port itself (the property; the
  reference's own bf16 check is its known failure); resume from a
  checkpoint equal to continuing live, exactly; 40 steps lower the loss
  and compressed training (ratio 4) still learns, at the reference's own
  thresholds; remat ``"none"``, ``"full"``, ``"dots"`` and ``"save_io"``
  give the same gradients (two attention and both recurrent archs);
  three steps of xlstm-125m's SMOKE against the reference's jitted step;
  the CLI trains and resumes, an attention arch and both recurrent ones.
- ``moe_ffn`` under ``torch.no_grad()`` (serving) is bit for bit today's
  in-place dispatch, and the out-of-place dispatch of grad mode gives the
  same bits.
- ``convert``: a gradient tree, and adamw's, adafactor's (momentum on and
  off) and lion's states survive the round trip through the port's
  layout; a checkpoint the reference's trainer committed resumes in the
  port.
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
from repro import optim as jopt
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data import make_pipeline as jmake_pipeline
from repro.launch import steps as jsteps
from repro.models import model as JM
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch import optim as topt
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import ShapeConfig as TShapeConfig
from repro_torch.data import make_pipeline
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE
from repro_torch.models.layers import as_compute
from repro_torch.optim.optimizers import (_flatten_upto, tree_leaves,
                                         tree_unflatten)
from test_torch_models import RoutingHandover

ATTN_ARCHS = ("gemma3-12b", "yi-6b", "yi-9b", "minitron-4b",
              "chameleon-34b", "qwen2-moe-a2.7b", "deepseek-v3-671b",
              "whisper-large-v3")
REC_ARCHS = ("recurrentgemma-2b", "xlstm-125m")
TOL_LOSS, TOL_GRAD, TOL_BF16 = 1e-5, 1e-4, 5e-2
B, S, N_PATCH, ENC_LEN = 2, 32, 6, 40
#: the recurrent archs' length: two of xlstm's SMOKE mLSTM chunks (32),
#: four of recurrentgemma's local windows (16)
S_REC = 64
ITINY = dict(name="itiny", family="dense", n_layers=2, d_model=32,
             n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64, vocab_size=128)


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


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def scaled(port, ref) -> float:
    p, r = _f32(port), _f32(ref)
    assert p.shape == r.shape, (p.shape, r.shape)
    return float(np.abs(p - r).max() / max(np.abs(r).max(), 1e-30))


def _configs(arch, dtype="float32", **kw):
    return (dataclasses.replace(jconfigs.get_smoke(arch), dtype=dtype, **kw),
            dataclasses.replace(tconfigs.get_smoke(arch), dtype=dtype, **kw))


def _params(jc, tc, seed=0):
    jp = JM.build_model(jc).init(jax.random.PRNGKey(seed))
    return jp, convert.model_params_from_reference(
        jax.tree.map(np.asarray, jp), tc, device="cpu")


def _seq(cfg) -> int:
    return S_REC if cfg.name.startswith(REC_ARCHS) else S


def _batch(cfg, seed=1) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size,
                        (B, _seq(cfg) + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        batch["patches"] = rng.normal(
            size=(B, N_PATCH, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        batch["frames"] = rng.normal(
            size=(B, ENC_LEN, cfg.frontend_dim)).astype(np.float32)
    return batch


def _jbatch(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port_grads(tm, tp, batch):
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = tm.loss(tp, batch)
    return loss, metrics, torch.autograd.grad(loss, leaves,
                                              allow_unused=True)


# ---------------------------------------------------------------------------
# losses and gradients
# ---------------------------------------------------------------------------

_REFERENCE = {}


def _reference_grads(arch, **kw):
    """(jc, tc, jp, tp, batch, (loss, metrics), grads) of the reference's
    jitted ``value_and_grad`` of its loss, once per (arch, config
    change) in a worker."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _REFERENCE:
        jc, tc = _configs(arch, **kw)
        jp, tp = _params(jc, tc)
        batch = _batch(jc)
        (jl, jmet), jg = jax.jit(jax.value_and_grad(
            JM.build_model(jc).loss, has_aux=True))(jp, _jbatch(batch))
        _REFERENCE[key] = (jc, tc, jp, tp, batch, (jl, jmet),
                           jax.tree.map(np.asarray, jg))
    return _REFERENCE[key]


@pytest.mark.parametrize("arch", ATTN_ARCHS + REC_ARCHS)
def test_loss_and_every_gradient_match_reference(arch):
    """f32: the total and every metric ≤ 1e-5 of the reference's
    ``loss``; each parameter's gradient ≤ 1e-4 of ``jax.grad``'s, none
    missing (every attention layer's backward is ``attention_vjp``, the
    MoE dispatch's is out of place, the RG-LRU scan's is its adjoint scan
    and the sLSTM loop runs out of place), under ``remat="full"``: a
    checkpoint's recompute skips autograd's version check, so a saved
    tensor written in place would give a wrong gradient, not an error."""
    jc, tc, _, tp, batch, (jl, jmet), jg = _reference_grads(arch)
    tl, tmet, grads = _port_grads(TM.build_model(tc), tp, batch)
    tmet = {k: v.detach() for k, v in tmet.items()}
    assert sorted(tmet) == sorted(jmet)
    assert ("mtp" in tmet) == jc.mtp and ("aux" in tmet) != jc.is_encdec
    for k in tmet:
        assert abs(float(tmet[k]) - float(jmet[k])) <= TOL_LOSS * max(
            abs(float(jmet[k])), 1.0), (k, float(tmet[k]), float(jmet[k]))
    assert float(tl.detach()) == float(tmet["loss"])
    if jc.n_experts:
        assert float(tmet["aux"]) > 0
    ref = tree_leaves(convert.model_params_from_reference(jg, tc,
                                                          device="cpu"))
    assert len(grads) == len(ref)
    for i, (g, r) in enumerate(zip(grads, ref)):
        assert g is not None, f"leaf {i} got no gradient"
        e = scaled(g, r)
        assert e <= TOL_GRAD, f"gradient leaf {i} {tuple(g.shape)}: {e:.3g}"


@pytest.mark.parametrize("arch", ATTN_ARCHS + REC_ARCHS)
def test_bf16_loss_matches_reference(arch, monkeypatch):
    """bf16 compute: the loss ≤ 5e-2 of the reference's; a MoE router's
    near-tie takes the reference's experts (``RoutingHandover``)."""
    jc, tc = _configs(arch, "bfloat16")
    if jc.n_experts:
        RoutingHandover(monkeypatch, "bfloat16")
    jp, tp = _params(jc, tc)
    batch = _batch(jc, seed=2)
    jl, _ = JM.build_model(jc).loss(jp, _jbatch(batch))
    with torch.no_grad():
        tl, tmet = TM.build_model(tc).loss(tp, batch)
    assert tl.dtype == torch.float32 and tl.shape == ()
    assert abs(float(tl) - float(jl)) <= TOL_BF16 * abs(float(jl))


def test_softmax_xent_masks_negative_labels():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    labels[0, :3] = -1
    t = TM.softmax_xent(torch.as_tensor(logits),
                        torch.as_tensor(labels, dtype=torch.int64))
    j = JM.softmax_xent(jnp.asarray(logits), jnp.asarray(labels))
    assert abs(float(t) - float(j)) <= 1e-6 * abs(float(j))
    none = TM.softmax_xent(torch.as_tensor(logits),
                           torch.full((2, 5), -1, dtype=torch.int64))
    assert float(none) == 0.0


@pytest.mark.parametrize("arch", ["gemma3-12b", "qwen2-moe-a2.7b",
                                  "recurrentgemma-2b", "xlstm-125m"])
def test_remat_full_and_none_give_the_same_gradients(arch):
    """A remat policy changes memory and time, never the value: the loss
    and gradients of ``remat="full"`` (the default), ``"none"``,
    ``"dots"`` (the matmul outputs saved) and ``"save_io"`` (a checkpoint
    per half-block) agree, each leaf ≤ 1e-6 of full's, and every policy
    the reference accepts runs."""
    out = {}
    for remat in ("full", "none", "dots", "save_io"):
        jc, tc = _configs(arch, remat=remat)
        _, tp = _params(jc, tc)
        out[remat] = _port_grads(TM.build_model(tc), tp, _batch(jc))
    for remat in ("none", "dots", "save_io"):
        assert float(out["full"][0]) == float(out[remat][0]), remat
        assert len(out[remat][2]) == len(out["full"][2])
        for a, b in zip(out["full"][2], out[remat][2]):
            assert scaled(a, b) <= 1e-6, remat


# ---------------------------------------------------------------------------
# the MoE dispatch: serving unchanged, training out of place
# ---------------------------------------------------------------------------

def _dispatch_in_place(params, cfg, xf, w, idx):
    """The MoE dispatch as serving ran it before training was ported: one
    buffer filled in place and reused for the experts' outputs."""
    T, d = xf.shape
    E, k, dt = cfg.n_experts, cfg.moe_top_k, cfg.cdtype
    C = TMoE.capacity(cfg, T)
    tok, slot, keep = TMoE._assign(cfg, idx, C)
    buf = torch.empty((E * C + 1, d), dtype=dt, device=xf.device)
    buf[:E * C] = 0
    buf[slot] = xf[tok].to(dt)
    eb = buf[:E * C].view(E, C, d)
    gate = F.silu(torch.bmm(eb, as_compute(params["wi_gate"], dt)))
    up = torch.bmm(eb, as_compute(params["wi_up"], dt))
    ob = torch.bmm(gate * up, as_compute(params["wo"], dt))
    buf[:E * C] = ob.view(E * C, d)
    buf[E * C] = 0
    wk = (w.reshape(-1) * keep.to(torch.float32)).to(dt)
    vals = (buf[slot] * wk[:, None]).view(T, k, d)
    out = vals[:, 0]
    for j in range(1, k):
        out = out + vals[:, j]
    return out


@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "deepseek-v3-671b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_serving_is_unchanged_and_training_dispatch_agrees(arch, dtype,
                                                               cf):
    """``moe_ffn`` under ``torch.no_grad()`` equals the in-place dispatch
    bit for bit (at cf 0.5 assignments drop); with grad enabled the
    out-of-place dispatch gives the same bits and a backward."""
    _, tc = _configs(arch, dtype, capacity_factor=cf)
    _, tp = _params(*_configs(arch, dtype, capacity_factor=cf))
    moe = tp["stack"]["scanned"][0][0]["moe"]
    x = torch.as_tensor(np.random.default_rng(4).normal(
        size=(2, 24, tc.d_model)).astype(np.float32)).to(tc.cdtype)
    with torch.no_grad():
        out, aux = TMoE.moe_ffn(moe, tc, x)
        xf = x.reshape(-1, tc.d_model)
        w, idx, _ = TMoE._route(moe, tc, xf)
        today = _dispatch_in_place(moe, tc, xf, w, idx)
        if tc.n_shared_experts:
            today = today + TMoE.L.mlp(moe["shared"], tc, xf)
    assert torch.equal(out, today.reshape(out.shape))
    xg = x.clone().requires_grad_(True)
    out2, aux2 = TMoE.moe_ffn(moe, tc, xg)
    assert out2.grad_fn is not None and torch.equal(out2.detach(), out)
    assert torch.equal(aux2.detach(), aux)
    (g,) = torch.autograd.grad(out2.float().sum() + aux2, xg)
    assert torch.isfinite(g).all() and torch.count_nonzero(g) > 0


class DispatchSpy:
    """Records ``moe._tracks_grad``'s answers: True is the out-of-place
    dispatch of training, False serving's in-place buffer."""

    def __init__(self, monkeypatch):
        self.seen = []
        tracks = TMoE._tracks_grad

        def spy(*args):
            self.seen.append(tracks(*args))
            return self.seen[-1]
        monkeypatch.setattr(TMoE, "_tracks_grad", spy)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "deepseek-v3-671b"])
def test_serving_with_grad_mode_on_fills_the_moe_buffer_in_place(
        arch, monkeypatch):
    """Serving never turns grad mode off: ``generate`` (prefill and decode)
    with grad mode on takes the in-place dispatch in every MoE layer and
    gives the same tokens as under ``torch.no_grad()``; the loss of params
    that require grad takes the out-of-place one."""
    from repro_torch.launch.serve import generate
    jc, tc = _configs(arch)
    _, tp = _params(jc, tc)
    model = TM.build_model(tc)
    prompts = torch.as_tensor(_batch(jc)["tokens"][:, :8])
    spy = DispatchSpy(monkeypatch)
    assert torch.is_grad_enabled()
    toks = generate(model, tp, prompts, 3)
    assert spy.seen and not any(spy.seen)
    with torch.no_grad():
        assert torch.equal(generate(model, tp, prompts, 3), toks)
    spy.seen.clear()
    _port_grads(model, tp, _batch(jc))
    assert spy.seen and all(spy.seen)


def test_serving_after_a_train_step_records_no_graph(monkeypatch):
    """A train step gives its params back with the ``requires_grad`` flags
    they came with, so serving them right after records no autograd graph:
    no output carries a ``grad_fn`` and the MoE dispatch is in place."""
    jc, tc = _configs("qwen2-moe-a2.7b")
    _, tp = _params(jc, tc)
    model = TM.build_model(tc)
    opt = topt.adamw()
    step = tsteps.make_train_step(model, opt, peak_lr=1e-3, warmup=1,
                                  total=2)
    tp, _, met = step(tp, opt.init(tp), _batch(jc))
    assert np.isfinite(float(met["loss"]))
    assert not any(p.requires_grad for p in tree_leaves(tp))
    spy = DispatchSpy(monkeypatch)
    logits, cache = model.prefill(tp, {"tokens": _batch(jc)["tokens"]},
                                  S + 2)
    assert logits.grad_fn is None
    assert all(t.grad_fn is None for t in tree_leaves(cache))
    logits, _ = model.decode_step(tp, cache, torch.argmax(
        logits, dim=-1)[:, None], S)
    assert logits.grad_fn is None
    assert spy.seen and not any(spy.seen)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _itiny(dtype="float32"):
    return (JModelConfig(**ITINY, dtype=dtype),
            TModelConfig(**ITINY, dtype=dtype))


def _port_run(tc, steps, start=0, params=None, opt_state=None, accum=1,
              total=None):
    model = TM.build_model(tc)
    opt = topt.adamw()
    step = tsteps.make_train_step(model, opt, peak_lr=1e-2, warmup=2,
                                  total=total or steps or 1, accum=accum)
    pipe = make_pipeline("synthetic", vocab_size=128, seq_len=32,
                         global_batch=4, seed=3)
    if params is None:
        _, params = _params(*_itiny(tc.dtype))
        opt_state = opt.init(params)
    losses = []
    for s in range(start, steps):
        params, opt_state, met = step(params, opt_state, pipe.batch_at(s))
        losses.append(float(met["loss"]))
    return params, opt_state, losses, met


def test_train_step_matches_the_reference_jitted_step():
    """Three f32 steps of ``make_train_step`` (adamw, warmup 2) against the
    reference's jitted step from the same weights and batches: losses and
    params ≤ 1e-5; the metrics carry ``grad_norm`` and ``lr``."""
    jc, tc = _itiny()
    model = JM.build_model(jc)
    opt = jopt.adamw()
    jstep = jax.jit(jsteps.make_train_step(model, opt, peak_lr=1e-2,
                                           warmup=2, total=3))
    pipe = jmake_pipeline("synthetic", vocab_size=128, seq_len=32,
                          global_batch=4, seed=3)
    jp = model.init(jax.random.PRNGKey(0))
    js = opt.init(jp)
    jlosses = []
    for s in range(3):
        jp, js, jmet = jstep(jp, js, jax.tree.map(jnp.asarray,
                                                  pipe.batch_at(s)))
        jlosses.append(float(jmet["loss"]))
    tp, ts, tlosses, tmet = _port_run(tc, 3)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert sorted(tmet) == sorted(jmet)
    for k in ("grad_norm", "lr", "ce", "aux"):
        assert abs(float(tmet[k]) - float(jmet[k])) <= 1e-5 * max(
            abs(float(jmet[k])), 1e-3), k
    ref = jax.tree.leaves(jax.tree.map(np.asarray, jp))
    port = jax.tree.leaves(convert.params_to_reference(tp, tc))
    for a, b in zip(port, ref):
        assert scaled(a, b) <= 1e-5
    assert int(ts.step) == 3 and ts.step.dtype == torch.int32


def test_grad_accumulation_equals_one_batch():
    """accum = 2 against accum = 1 on the same global batch, f32: losses
    and params ≤ 1e-5 (the microbatch gradients summed in f32 and divided
    by accum, the metrics averaged)."""
    _, tc = _itiny()
    p1, _, l1, _ = _port_run(tc, 3, accum=1)
    p2, _, l2, _ = _port_run(tc, 3, accum=2)
    np.testing.assert_allclose(l1, l2, rtol=1e-5)
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        assert scaled(a, b) <= 1e-5


def test_grad_accumulation_sums_bf16_leaves_in_f32():
    """A bf16 parameter's microbatch gradients are summed in an f32
    buffer, as the reference's f32 accumulator does: accum = 2 against
    accum = 1 agree to bf16's rounding of the update."""
    _, tc = _itiny()
    tc = dataclasses.replace(tc, param_dtype="bfloat16")
    out = []
    for accum in (1, 2):
        _, tp = _params(*(dataclasses.replace(c, param_dtype="bfloat16")
                          for c in _itiny()))
        opt = topt.adamw()
        step = tsteps.make_train_step(TM.build_model(tc), opt, peak_lr=1e-2,
                                      warmup=1, total=2, accum=accum)
        batch = make_pipeline("synthetic", vocab_size=128, seq_len=32,
                              global_batch=4, seed=3).batch_at(0)
        tp, _, met = step(tp, opt.init(tp), batch)
        out.append((tp, float(met["loss"]), float(met["grad_norm"])))
    assert abs(out[0][1] - out[1][1]) <= 1e-5 * abs(out[0][1])
    assert abs(out[0][2] - out[1][2]) <= 1e-2 * abs(out[0][2])
    for a, b in zip(tree_leaves(out[0][0]), tree_leaves(out[1][0])):
        assert a.dtype == torch.bfloat16
        assert scaled(a, b) <= 2 ** -6


def test_checkpoint_resume_is_exact(tmp_path):
    """Save the train state after 5 steps, restore it into fresh tensors,
    and the next 3 steps' losses equal continuing live, exactly."""
    _, tc = _itiny()
    params, opt_state, _, _ = _port_run(tc, 5, total=8)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, ttrain.train_tree(params, opt_state))
    _, fresh = _params(*_itiny())
    fresh_state = topt.adamw().init(fresh)
    ttrain.load_train_tree(fresh, fresh_state,
                           mgr.restore(5, ttrain.train_tree(fresh,
                                                             fresh_state)))
    assert int(fresh_state.step) == 5
    _, _, live, _ = _port_run(tc, 8, 5, params, opt_state)
    _, _, rest, _ = _port_run(tc, 8, 5, fresh, fresh_state)
    assert live == rest


def test_loss_decreases():
    """40 bf16 steps lower the mean loss of the last 5 by more than 0.1
    against the first 5 (the reference's threshold)."""
    _, tc = _itiny("bfloat16")
    _, _, losses, _ = _port_run(tc, 40)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, losses


def test_compressed_training_still_learns():
    """The reference's test: each step's gradient goes through the
    count-sketch compressor (ratio 4, error feedback, identity
    all-reduce) before adamw at lr 1e-2; 40 steps lower the loss by more
    than 0.05."""
    _, tc = _itiny("bfloat16")
    model = TM.build_model(tc)
    opt = topt.adamw()
    init_c, apply_c = topt.make_gradient_compressor(ratio=4)
    pipe = make_pipeline("synthetic", vocab_size=128, seq_len=32,
                         global_batch=4, seed=3)
    _, params = _params(*_itiny("bfloat16"))
    opt_state = opt.init(params)
    leaves = tree_leaves(params)
    cstate = init_c(params, torch.Generator().manual_seed(9))
    losses = []
    for s in range(40):
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = model.loss(params, pipe.batch_at(s))
        grads = torch.autograd.grad(loss, leaves)
        loss = loss.detach()
        grads, cstate = apply_c(tree_unflatten(params, iter(grads)),
                                cstate, lambda x: x)
        params, opt_state, _ = opt.update(grads, opt_state, params, 1e-2)
        losses.append(float(loss))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.05, losses


def test_recurrent_train_step_matches_the_reference_jitted_step():
    """Three f32 steps of ``make_train_step`` on xlstm-125m's SMOKE (mLSTM
    and sLSTM, adamw, warmup 2) against the reference's jitted step from
    the same weights and batches of 64 tokens: losses and ``grad_norm`` ≤
    1e-5; params ≤ 1e-4 scale-normalized.  adamw moves every entry by
    about lr whatever its gradient's size, so an entry whose gradient is a
    hundredth of its leaf's largest carries the gradient's ~1e-6
    scale-normalized rounding into its update at ~1e-4 of the leaf; the
    zero-initialized norm scales are nothing but such updates (measured:
    1.0e-5 after 3 steps)."""
    jc, tc = _configs("xlstm-125m")
    model = JM.build_model(jc)
    opt = jopt.adamw()
    jstep = jax.jit(jsteps.make_train_step(model, opt, peak_lr=1e-2,
                                           warmup=2, total=3))
    jpipe = jmake_pipeline("synthetic", vocab_size=jc.vocab_size,
                           seq_len=S_REC, global_batch=2, seed=3)
    jp, tp = _params(jc, tc)
    js = opt.init(jp)
    jlosses = []
    for s in range(3):
        jp, js, jmet = jstep(jp, js, jax.tree.map(jnp.asarray,
                                                  jpipe.batch_at(s)))
        jlosses.append(float(jmet["loss"]))
    port_opt = topt.adamw()
    step = tsteps.make_train_step(TM.build_model(tc), port_opt, peak_lr=1e-2,
                                  warmup=2, total=3)
    pipe = make_pipeline("synthetic", vocab_size=tc.vocab_size,
                         seq_len=S_REC, global_batch=2, seed=3)
    ts, tlosses = port_opt.init(tp), []
    for s in range(3):
        tp, ts, tmet = step(tp, ts, pipe.batch_at(s))
        tlosses.append(float(tmet["loss"]))
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert abs(float(tmet["grad_norm"]) - float(jmet["grad_norm"])) <= \
        1e-5 * float(jmet["grad_norm"])
    for a, b in zip(jax.tree.leaves(convert.params_to_reference(tp, tc)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jp))):
        assert scaled(a, b) <= 1e-4


def test_default_optimizer_and_accum_match_reference():
    class Mesh:
        def __init__(self, **shape):
            self.shape = shape

    for arch in tconfigs.ARCHS:
        jc, tc = jconfigs.get_config(arch), tconfigs.get_config(arch)
        assert tsteps.default_optimizer(tc).name == \
            jsteps.default_optimizer(jc).name
        for shape in (("t", 4096, 256, "train"), ("t", 32768, 8, "train"),
                      ("p", 4096, 2, "prefill")):
            for dp in (1, 4):
                assert tsteps.default_accum(tc, TShapeConfig(*shape), dp=dp) \
                    == jsteps.default_accum(jc, JShapeConfig(*shape),
                                            Mesh(data=dp, model=1))


def test_train_cli_runs_then_resumes(tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch yi-6b --smoke --steps 3
    --device cpu --ckpt-dir D`` trains and checkpoints; a second run with
    more steps restores the latest step and goes on.  A mesh of 4 devices
    asks for 4 ranks (``tests/test_torch_train_mesh.py`` trains on one)."""
    args = ["--arch", "yi-6b", "--smoke", "--device", "cpu", "--seq-len",
            "32", "--global-batch", "2", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2", "--log-every", "1"]
    first = ttrain.main(args + ["--steps", "3"])
    out = capsys.readouterr().out
    assert len(first) == 3 and all(np.isfinite(first))
    assert "step     0  loss" in out and "tok/s" in out
    again = ttrain.main(args + ["--steps", "5"])
    out = capsys.readouterr().out
    assert "restored checkpoint @ step 2" in out
    assert len(again) == 3 and again[0] == first[2]
    with pytest.raises(RuntimeError, match="torchrun"):
        ttrain.main(args + ["--steps", "1", "--mesh", "2x2"])


@pytest.mark.parametrize("arch", REC_ARCHS)
def test_train_cli_trains_and_resumes_a_recurrent_arch(arch, tmp_path,
                                                       capsys):
    """The CLI trains a recurrent arch's SMOKE config at 64 tokens
    (xlstm's mLSTM takes a multiple of its chunk of 32), checkpoints, and
    a longer rerun resumes from the latest step."""
    args = ["--arch", arch, "--smoke", "--device", "cpu", "--seq-len",
            str(S_REC), "--global-batch", "2", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2", "--log-every", "1"]
    first = ttrain.main(args + ["--steps", "3"])
    assert len(first) == 3 and all(np.isfinite(first))
    assert "step     0  loss" in capsys.readouterr().out
    again = ttrain.main(args + ["--steps", "4"])
    assert "restored checkpoint @ step 2" in capsys.readouterr().out
    assert len(again) == 2 and again[0] == first[2]


def test_train_cli_prints_the_loss_summary(capsys):
    losses = ttrain.main(["--arch", "gemma3-12b", "--smoke", "--device",
                          "cpu", "--steps", "20", "--seq-len", "16",
                          "--global-batch", "2", "--peak-lr", "1e-2",
                          "--log-every", "10"])
    out = capsys.readouterr().out
    assert len(losses) == 20 and " -> " in out.splitlines()[-1]
    assert "improved" in out.splitlines()[-1]


# ---------------------------------------------------------------------------
# train state carried across
# ---------------------------------------------------------------------------

def _ref_tree_equal(port, ref):
    pl, rl = jax.tree.leaves(port), jax.tree.leaves(ref)
    assert jax.tree.structure(jax.tree.map(lambda x: 0, port)) == \
        jax.tree.structure(jax.tree.map(lambda x: 0, ref))
    for a, b in zip(pl, rl):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


@pytest.mark.parametrize("arch,scan", [("gemma3-12b", True),
                                       ("deepseek-v3-671b", True),
                                       ("whisper-large-v3", True),
                                       ("chameleon-34b", False),
                                       ("recurrentgemma-2b", True),
                                       ("xlstm-125m", False)])
def test_gradient_tree_round_trip(arch, scan):
    """A reference gradient tree has the params' structure:
    ``model_params_from_reference`` maps it and ``params_to_reference``
    maps it back, every leaf unchanged."""
    _, tc, *_, jg = _reference_grads(arch, scan_layers=scan)
    port = convert.model_params_from_reference(jg, tc, device="cpu")
    _ref_tree_equal(convert.params_to_reference(port, tc), jg)


_MAKERS = {"adamw": lambda m, **kw: m.adamw(),
           "lion": lambda m, **kw: m.lion(),
           "adafactor": lambda m, **kw: m.adafactor(**kw),
           "adafactor_momentum": lambda m, **kw: m.adafactor(momentum=True,
                                                             **kw)}


def _port_optimizer(name, tc):
    """The port's optimizer ``name``; adafactor updates the layers the
    reference stacks as one tensor (``stacked_layers``)."""
    if name.startswith("adafactor"):
        return _MAKERS[name](topt, stacks=lambda p: TM.stacked_layers(p, tc))
    return _MAKERS[name](topt)


@pytest.mark.parametrize("name,scan", [
    ("adamw", True), ("lion", True), ("adafactor", False),
    ("adafactor_momentum", False), ("adafactor", True),
    ("adafactor_momentum", True)])
def test_opt_state_round_trip(name, scan):
    """A reference ``OptState`` after two updates carries into the port's
    layout and back leaf for leaf (under ``scan_layers`` adafactor's
    statistics of a stacked norm scale too); one more update on each side
    then agrees (≤ 1e-5)."""
    jc, tc = _configs("gemma3-12b", scan_layers=scan)
    jp, tp = _params(jc, tc)
    jo, to = _MAKERS[name](jopt), _port_optimizer(name, tc)
    js = jo.init(jp)
    rng = np.random.default_rng(3)
    for _ in range(2):
        g = jax.tree.map(lambda x: jnp.asarray(rng.normal(size=x.shape),
                                               x.dtype), jp)
        jp, js, _ = jo.update(g, js, jp, 1e-3)
    ts = convert.opt_state_from_reference(js, tp, device="cpu")
    assert ts.step.dtype == torch.int32 and int(ts.step) == 2
    back = convert.opt_state_to_reference(ts, tc)
    assert int(back.step) == 2
    _ref_tree_equal(back.inner, jax.tree.map(np.asarray, js.inner))
    g = jax.tree.map(lambda x: jnp.asarray(rng.normal(size=x.shape),
                                           x.dtype), jp)
    jp2, js2, _ = jo.update(g, js, jp, 1e-3)
    tp = convert.model_params_from_reference(jax.tree.map(np.asarray, jp),
                                             tc, device="cpu")
    tg = convert.model_params_from_reference(jax.tree.map(np.asarray, g),
                                             tc, device="cpu")
    tp2, ts2, _ = to.update(tg, ts, tp, 1e-3)
    for a, b in zip(jax.tree.leaves(convert.params_to_reference(tp2, tc)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jp2))):
        assert scaled(a, b) <= 1e-5


@pytest.mark.parametrize("momentum", [False, True])
@pytest.mark.parametrize("arch", ["gemma3-12b", "deepseek-v3-671b",
                                  "whisper-large-v3"])
def test_adafactor_updates_stacked_layers_as_the_reference(arch, momentum):
    """Under ``scan_layers`` (the reference's default) the reference's
    adafactor sees a pattern slot's layers (and whisper's decoder and
    cross-attention) stacked: it factors a stacked norm scale across the
    layers and clips each stacked tensor's update by its RMS.  The port's
    adafactor with ``stacks=stacked_layers`` does the same on its per-layer
    tensors: 3 updates from the same params and gradients, params and every
    f32 state leaf ≤ 1e-6 relative; the stacked vectors' statistics are
    factored (a row statistic per layer).  The bf16 momentum is held
    within one bf16 ulp after each update (where the f32 value lands on a
    rounding boundary differently) and then handed over from the
    reference, so a flipped rounding does not carry into the next
    update."""
    # gemma3's SMOKE stack is one superblock; two make every slot a stack
    jc, tc = _configs(arch, scan_layers=True,
                      **({"n_layers": 12} if arch == "gemma3-12b" else {}))
    jp, tp = _params(jc, tc)
    name = "adafactor_momentum" if momentum else "adafactor"
    jo, to = _MAKERS[name](jopt), _port_optimizer(name, tc)
    js, ts = jo.init(jp), to.init(tp)
    rng = np.random.default_rng(5)
    for _ in range(3):
        g = jax.tree.map(lambda x: jnp.asarray(rng.normal(size=x.shape),
                                               x.dtype), jp)
        jp, js, jm = jo.update(g, js, jp, 1e-2)
        tg = convert.model_params_from_reference(
            jax.tree.map(np.asarray, g), tc, device="cpu")
        tp, ts, tm = to.update(tg, ts, tp, 1e-2)
        assert scaled(tm["grad_norm"], jm["grad_norm"]) <= 1e-6
        if momentum:
            ref_m = convert.model_params_from_reference(
                jax.tree.map(np.asarray, js.inner["m"]), tc, device="cpu")
            for a, b in zip(tree_leaves(ts.inner["m"]), tree_leaves(ref_m)):
                assert scaled(a, b) <= 2 ** -7
                a.copy_(b)
    ref = jax.tree.map(np.asarray, js.inner)
    assert any("r" in st and st["r"].ndim == 0
               for st in _flatten_upto(ts.inner["stats"], tp))
    back = convert.opt_state_to_reference(ts, tc)
    assert jax.tree.structure(jax.tree.map(lambda x: 0, back.inner)) == \
        jax.tree.structure(jax.tree.map(lambda x: 0, ref))
    for a, b in zip(jax.tree.leaves(back.inner), jax.tree.leaves(ref)):
        assert scaled(a, b) <= 1e-6
    for a, b in zip(jax.tree.leaves(convert.params_to_reference(tp, tc)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jp))):
        assert scaled(a, b) <= 1e-6


def test_default_optimizer_stacks_adafactor_as_the_reference():
    """deepseek-v3 (> 100B) gets adafactor, and its state has the
    reference's stacked layout: a stacked norm scale's statistics are a
    row entry per layer and one shared column."""
    opt = tsteps.default_optimizer(tconfigs.get_config("deepseek-v3-671b"))
    assert opt.name == "adafactor"
    jc, tc = _configs("deepseek-v3-671b", scan_layers=True)
    jp, tp = _params(jc, tc)
    ts = opt.init(tp)
    js = jopt.adafactor().init(jp)
    back = convert.opt_state_to_reference(ts, tc)
    assert jax.tree.structure(jax.tree.map(lambda x: 0, back.inner)) == \
        jax.tree.structure(jax.tree.map(lambda x: 0, js.inner))
    for a, b in zip(jax.tree.leaves(back.inner), jax.tree.leaves(js.inner)):
        assert np.shape(a) == np.shape(b)


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """The reference's trainer commits ``{"params", "opt": OptState}``
    after 3 f32 steps; the port restores it from the shared store and its
    next 2 steps equal the reference's (losses ≤ 1e-5)."""
    jc, tc = _itiny()
    model = JM.build_model(jc)
    opt = jopt.adamw()
    jstep = jax.jit(jsteps.make_train_step(model, opt, peak_lr=1e-2,
                                           warmup=2, total=5))
    pipe = jmake_pipeline("synthetic", vocab_size=128, seq_len=32,
                          global_batch=4, seed=3)
    jp = model.init(jax.random.PRNGKey(0))
    js = opt.init(jp)
    for s in range(3):
        jp, js, _ = jstep(jp, js, jax.tree.map(jnp.asarray,
                                               pipe.batch_at(s)))
    JCheckpointManager(str(tmp_path)).save(3, {"params": jp, "opt": js})
    jlosses = []
    for s in range(3, 5):
        jp, js, met = jstep(jp, js, jax.tree.map(jnp.asarray,
                                                 pipe.batch_at(s)))
        jlosses.append(float(met["loss"]))
    _, like = _params(jc, tc)
    tp, ts = convert.train_state_from_reference_checkpoint(
        tmp_path, 3, like, device="cpu")
    assert int(ts.step) == 3
    _, _, tlosses, _ = _port_run(tc, 5, 3, tp, ts)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
