"""The port's optimizers, schedules and gradient compressor held against
the reference's ``repro.optim`` (CPU).

The same numpy tree and gradients go through both packages: ``adamw``,
``adafactor`` (momentum on and off; matrix, vector, 3-d and thin leaves)
and ``lion`` over 1 and 3 updates — params and every state leaf ≤ 1e-6
relative in f32; ``global_norm`` and clipping; the schedules at every step
from 0 to total + 2 (≤ 1e-7 of the peak); ``countsketch_compress`` /
``decompress`` and the compressor's ``apply`` with the reference's own
hash and sign tables (``_leaf_tables``, the keys split as its ``apply``
splits them), ≤ 1e-6; and the error-feedback identity, exactly.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.optim import compress as jcomp
from repro.optim import optimizers as jopts
from repro_torch import optim as topt
from repro_torch.optim import compress as tcomp
from repro_torch.optim import optimizers as topts

TOL = 1e-6
SHAPES = {"w": (6, 8), "t3": (3, 4, 5), "thin": (1, 7),
          "nest": {"b": (5,), "m": (4, 9)}}


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _tree(shapes, rng, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _tree(v, rng, scale) for k, v in shapes.items()}
    return (rng.normal(size=shapes) * scale).astype(np.float32)


def _torch(tree, dtype=torch.float32):
    if isinstance(tree, dict):
        return {k: _torch(v, dtype) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree, np.float32)).to(dtype)


def _jax(tree, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), tree)


def _close(port, ref, tol=TOL, what=""):
    pl, rl = topts.tree_leaves(port), jax.tree.leaves(ref)
    assert len(pl) == len(rl), what
    for p, r in zip(pl, rl):
        p = p.detach().float().numpy() if isinstance(p, torch.Tensor) \
            else np.asarray(p, np.float32)
        r = np.asarray(r, np.float32)
        assert p.shape == r.shape, (what, p.shape, r.shape)
        err = np.abs(p - r).max() / max(np.abs(r).max(), 1e-30)
        assert err <= tol, f"{what}: {err:.3g}"


MAKERS = {
    "adamw": lambda m: m.adamw(),
    "adamw_noclip": lambda m: m.adamw(b2=0.999, weight_decay=0.0,
                                      clip_norm=None),
    "adafactor": lambda m: m.adafactor(momentum=False),
    "adafactor_momentum": lambda m: m.adafactor(momentum=True,
                                                weight_decay=0.01),
    "lion": lambda m: m.lion(),
}


@pytest.mark.parametrize("updates", [1, 3])
@pytest.mark.parametrize("name", list(MAKERS))
def test_optimizer_matches_reference(name, updates):
    """Params and every state leaf after 1 and 3 updates, f32, ≤ 1e-6;
    the grad norm too.  The lr is a 0-d tensor (as the schedule gives
    it) on the port's side."""
    rng = np.random.default_rng(len(name) + updates)
    params = _tree(SHAPES, rng)
    jo, to = MAKERS[name](jopt), MAKERS[name](topt)
    jp, tp = _jax(params), _torch(params)
    js, ts = jo.init(jp), to.init(tp)
    assert ts.step.dtype == torch.int32 and int(ts.step) == 0
    for u in range(updates):
        grads = _tree(SHAPES, rng, scale=0.5 + u)
        lr = 1e-2 / (u + 1)
        jp, js, jm = jo.update(_jax(grads), js, jp, lr)
        tp, ts, tm = to.update(_torch(grads), ts, tp,
                               torch.tensor(lr, dtype=torch.float32))
        _close(tm["grad_norm"], jm["grad_norm"], what="grad_norm")
    assert int(ts.step) == int(js.step) == updates
    _close(tp, jp, what="params")
    _close(ts.inner, js.inner, what="state")


@pytest.mark.parametrize("name", ["adamw", "lion", "adafactor_momentum"])
def test_update_is_in_place_and_bf16_params_round_like_the_reference(name):
    """``update`` writes into the given tensors (the same objects come
    back) and stores a bf16 parameter as the reference's ``astype`` does
    (within one bf16 ulp, where the f32 update lands on a rounding
    boundary differently)."""
    rng = np.random.default_rng(9)
    params, grads = _tree(SHAPES, rng), _tree(SHAPES, rng)
    jo, to = MAKERS[name](jopt), MAKERS[name](topt)
    tp = _torch(params, torch.bfloat16)
    ts = to.init(tp)
    before = topts.tree_leaves(tp) + topts.tree_leaves(ts.inner)
    tp2, ts2, _ = to.update(_torch(grads, torch.bfloat16), ts, tp, 1e-2)
    assert all(a is b for a, b in zip(before, topts.tree_leaves(tp2)
                                      + topts.tree_leaves(ts2.inner)))
    jp = _jax(params, jnp.bfloat16)
    jp2, _, _ = jo.update(_jax(grads, jnp.bfloat16), jo.init(jp), jp, 1e-2)
    for p, r in zip(topts.tree_leaves(tp2), jax.tree.leaves(jp2)):
        assert p.dtype == torch.bfloat16
        r = np.asarray(r, np.float32)
        assert np.abs(p.float().numpy() - r).max() <= 2 ** -7 * np.abs(
            r).max()


def test_global_norm_and_clipping():
    rng = np.random.default_rng(4)
    tree = _tree(SHAPES, rng, scale=3.0)
    _close(topts.global_norm(_torch(tree)), jopts.global_norm(_jax(tree)))
    for max_norm in (0.5, 1e6):
        tc, tn = topts.clip_by_global_norm(_torch(tree), max_norm)
        jc, jn = jopts.clip_by_global_norm(_jax(tree), max_norm)
        _close(tc, jc, what=f"clip {max_norm}")
        _close(tn, jn)
    tc, _ = topts.clip_by_global_norm(_torch(tree), 0.5)
    assert abs(float(topts.global_norm(tc)) - 0.5) <= 1e-6


@pytest.mark.parametrize("kw", [
    dict(peak=3e-4, warmup_steps=10, total_steps=50),
    dict(peak=1e-2, warmup_steps=2, total_steps=3),
    dict(peak=1.0, warmup_steps=0, total_steps=17)])
def test_schedules_match_reference(kw):
    """Every step from 0 to total + 2, ≤ 1e-7 of the peak; a 0-d tensor
    step gives a 0-d f32 tensor on its device."""
    for fn in ("warmup_cosine", "warmup_linear"):
        for step in range(kw["total_steps"] + 3):
            t = getattr(topt, fn)(torch.tensor(step, dtype=torch.int32),
                                  **kw)
            j = getattr(jopt, fn)(step, **kw)
            assert t.dtype == torch.float32 and t.shape == ()
            assert abs(float(t) - float(j)) <= 1e-7 * kw["peak"], \
                (fn, step, float(t), float(j))
            assert float(getattr(topt, fn)(step, **kw)) == float(t)
    cos = topt.warmup_cosine(0, peak=1.0, warmup_steps=0, total_steps=4,
                             floor=0.1)
    assert abs(float(cos) - 1.0) <= 1e-7
    assert abs(float(topt.warmup_cosine(9, peak=1.0, warmup_steps=0,
                                        total_steps=4, floor=0.1))
               - 0.1) <= 1e-7


def _ref_tables(key, n, ratio):
    h, s = jcomp._leaf_tables(key, n, max(1, n // ratio))
    return np.array(h), np.array(s)


@pytest.mark.parametrize("shape,ratio", [((37,), 4), ((16, 24), 8),
                                         ((3, 5, 7), 2), ((5,), 8)])
def test_countsketch_with_the_reference_tables(shape, ratio):
    """Sᵀg (a segment sum into max(1, n // ratio) buckets) and S(Sᵀg) with
    the reference's hashes and signs, ≤ 1e-6."""
    g = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    key = jax.random.PRNGKey(sum(shape))
    jsk, jmeta = jcomp.countsketch_compress(jnp.asarray(g), key, ratio)
    tables = _ref_tables(key, g.size, ratio)
    tsk, tmeta = tcomp.countsketch_compress(torch.as_tensor(g), tables,
                                            ratio)
    _close(tsk, jsk, what="sketch")
    _close(tcomp.countsketch_decompress(tsk, tmeta),
           jcomp.countsketch_decompress(jsk, jmeta), what="unsketch")
    assert tsk.shape == (max(1, g.size // ratio),)


def test_compressor_apply_matches_reference():
    """Two steps of ``apply`` (error feedback carried) with the tables the
    reference's keys give, ≤ 1e-6; the identity all-reduce."""
    rng = np.random.default_rng(8)
    shapes = {"a": (6, 8), "b": (13,)}
    jinit, japply = jopt.make_gradient_compressor(ratio=4)
    tinit, tapply = topt.make_gradient_compressor(ratio=4)
    g0 = _tree(shapes, rng)
    js = jinit(_jax(g0), jax.random.PRNGKey(9))
    ts = tinit(_torch(g0), torch.Generator().manual_seed(9))
    for _ in range(2):
        grads = _tree(shapes, rng)
        flat = jax.tree.leaves(grads)
        keys = jax.random.split(js.key, len(flat) + 1)
        tables = [_ref_tables(keys[i], x.size, 4)
                  for i, x in enumerate(flat)]
        jg, js = japply(_jax(grads), js, lambda x: x)
        tg, ts = tapply(_torch(grads), ts, lambda x: x, tables=tables)
        _close(tg, jg, what="grads")
        _close(ts.error, js.error, what="error")


def test_error_feedback_identity_is_exact():
    """The residual the state carries is exactly (g + e) − δ·S Sᵀ(g + e),
    and the output is exactly δ·S Sᵀ(g + e) under the identity all-reduce,
    with the tables the generator draws (δ = 1/(1 + ratio))."""
    ratio = 4
    delta = 1.0 / (1.0 + ratio)
    init, apply = topt.make_gradient_compressor(ratio=ratio)
    rng = np.random.default_rng(2)
    g = {"w": torch.as_tensor(rng.normal(size=(10, 12)).astype(np.float32))}
    st = init(g, torch.Generator().manual_seed(1))
    st.error["w"].copy_(torch.as_tensor(
        rng.normal(size=(10, 12)).astype(np.float32)))
    e = st.error["w"].clone()
    twin = torch.Generator().manual_seed(1)
    out, st2 = apply(g, st, lambda x: x)
    gc = g["w"] + e
    sk, meta = tcomp.countsketch_compress(gc, twin, ratio)
    rec = delta * tcomp.countsketch_decompress(sk, meta)
    assert torch.equal(out["w"], rec)
    assert torch.equal(st2.error["w"], gc - rec)
    assert torch.allclose(rec + st2.error["w"], gc, rtol=0, atol=1e-6)


def test_compression_commutes_with_allreduce():
    """Sᵀ is linear: sketching a sum is the sum of the sketches."""
    rng = np.random.default_rng(6)
    g1, g2 = (torch.as_tensor(rng.normal(size=300).astype(np.float32))
              for _ in range(2))
    tables = tcomp.leaf_tables(torch.Generator().manual_seed(3), 300, 75)
    s1, _ = tcomp.countsketch_compress(g1, tables, 4)
    s2, _ = tcomp.countsketch_compress(g2, tables, 4)
    s12, _ = tcomp.countsketch_compress(g1 + g2, tables, 4)
    assert torch.allclose(s1 + s2, s12, atol=1e-5)


def test_make_optimizer():
    for name in ("adamw", "adafactor", "lion"):
        assert topt.make_optimizer(name).name == name
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.make_optimizer("sgd")
