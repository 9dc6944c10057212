"""The port's train step on a device mesh (CPU): against one rank and
against the reference's expert and sequence parallelism.

Port side: 4 gloo ranks (``torch.multiprocessing`` spawn, a ``file://``
store in a temp dir) form ("data", "model") meshes (2, 2) and (1, 4) and
run, once for the module:

- yi-6b (GQA: 8 heads, 2 kv heads, so at model = 4 the kv heads stay
  whole and each rank reads the one its q heads map to), gemma3-12b
  (local windows, qk-norm, post-norms, a tied and softcapped
  embedding; 4 heads over 2 kv heads), qwen2-moe-a2.7b (6 experts: over
  ``model`` at 2, the FFN width split at 4, which they do not divide),
  yi-6b with ``fsdp`` (the weights gathered over ``data`` on use) and
  deepseek-v3 with and without ``fsdp`` (MLA over heads, MTP, 8 experts
  top-2 over ``model``, one dense prefix layer), SMOKE in f32: the loss,
  every gradient leaf (``launch.steps.loss_and_grads``, the shards
  gathered back) and three steps' losses of ``make_train_step`` against
  the same on one rank (loss ≤ 1e-5, gradients ≤ 1e-4 scale-normalized,
  the steps ≤ 1e-4);
- adafactor on shards (deepseek-v3 with and without ``fsdp``, yi-6b with
  ``fsdp``, whose factored dims split over ``data``): three steps
  (``ADA_STEPS``: momentum off and on), the stacked layers as one tensor,
  against one rank (≤ 1e-4); one update's statistics, momentum and params
  gathered back
  against the reference's ``adafactor().update`` on the gathered
  gradients (≤ 1e-6; the bf16 momentum within one ulp);
- expert parallelism (``moe_impl="shard_map"``) on the reference test's
  config (E 8, k 2, cf 8.0) on (2, 2), and a capacity-bound case (cf 0.7,
  k 6) on (1, 4): the output and the aux against the reference's
  ``_moe_shard_map`` on the same inputs (≤ 1e-5, aux ≤ 1e-6 relative),
  every gradient of sum(out·g) + aux (router, shared experts, banks;
  summed over the data ranks) against the reference's ``jax.grad``
  (≤ 1e-4), and at cf 8.0, where nothing drops, the expert banks'
  gradients against the gather path on one rank (≤ 1e-4);
- sequence-parallel attention on the reference test's config (6 heads on
  model = 4) on (1, 4): the loss against the reference's at its mesh (1,
  4) (≤ 1e-5), the gradients against one rank;
- the trainer's checkpoints (bf16 SMOKE yi-6b): a mesh run's checkpoint
  (whole leaves, in the one-device layout) resumes on one device, and a
  one-device checkpoint resumes on the mesh; both continue the
  uninterrupted run's losses (≤ 2e-3 relative: bf16 sums in another
  order); the shards gathered back are the params bit for bit (qwen2-moe
  with ``fsdp``: every rule's layout), to every rank and, as a checkpoint
  gathers them, to rank 0's host alone; a preemption signal on one rank
  stops them all; ``--arch deepseek-v3-671b --mesh 2x2`` trains;
- deepseek-v3 SMOKE on (1, 3), whose 4 heads do not divide ``model``
  while ``wq_a``'s q_rank columns do: the loss and every gradient against
  one rank;
- ``ROWS``: batches laid out as the reference's ``batch_pspec`` lays them
  (``steps.local_rows``) where ``pod × data`` does not divide the rows —
  yi-6b with ``fsdp`` on (2, 1) at B = 1 (whole on both data ranks; FSDP's
  reduce-scatter sums their equal shares), on (pod, data, model) = (2, 2,
  1) at B = 2 (over ``data`` alone, the pods holding the same rows) and
  B = 1 (whole), qwen2-moe with expert parallelism at B = 1 on (2, 1)
  (the tokens split over ``data`` as the reference's ``tok_spec`` splits
  them; capacity factor E/k, so nothing drops), recurrentgemma-2b at B = 1
  on (2, 1) — and MLA under ``seq_parallel_attn``: deepseek-v3 SMOKE on
  (1, 3) at 48 tokens (16 query rows a rank, against 16, 32 and 48 keys).
  Each against one rank (the loss, every gradient, grad_norm, the loss
  after one adamw step; the EP case without its aux, which EP forms per
  token slice) and against the reference's jitted train step on the same
  mesh with its ``build_cell`` shardings (the same, its gradients read
  from adamw's first moment); each rank's rows against the reference's
  ``batch_pspec``.

Reference side: one subprocess sees 4 CPU devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``, as
``tests/test_distributed_paths.py`` runs its multi-device cases) and runs
``moe_ffn`` with ``moe_impl="shard_map"`` and the SP loss under ``with
mesh:``; it asserts that the expert- and sequence-parallel paths engaged.
A second subprocess jits the ``ROWS`` cases' train steps.
The two sides run at once.  The spawn and the subprocess each have their
own timeout (240 s), and the gloo group a 120 s one, so a hung collective
fails the module instead of running out the suite's clock.
"""
from __future__ import annotations

import dataclasses
import datetime
import functools
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_smoke
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.launch import steps
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE
from repro_torch.optim import make_optimizer
from repro_torch.optim.optimizers import tree_leaves, tree_unflatten

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT = 240
MESHES = ((2, 2), (1, 4))
ARCHS = (("yi-6b", False), ("gemma3-12b", False), ("qwen2-moe-a2.7b", False),
         ("yi-6b", True), ("deepseek-v3-671b", False),
         ("deepseek-v3-671b", True))
#: the runs that also train with adafactor (yi-6b's fsdp splits factored
#: dims over ``data``; deepseek's MLA over ``model``)
ADAFACTOR = (("deepseek-v3-671b", False), ("deepseek-v3-671b", True),
             ("yi-6b", True))
#: (arch, fsdp, momentum) of the three-step adafactor runs: each
#: momentum on deepseek, fsdp's factored dims over ``data`` with and
#: without it
ADA_STEPS = (("deepseek-v3-671b", False, False),
             ("deepseek-v3-671b", False, True),
             ("deepseek-v3-671b", True, False), ("yi-6b", True, True))
ADA_LR = 1e-2
TOL_LOSS, TOL_GRAD, TOL_STEPS = 1e-5, 1e-4, 1e-4
MOE = dict(name="t", family="moe", n_layers=1, d_model=64, n_heads=4,
           n_kv_heads=4, head_dim=16, d_ff=0, vocab_size=128, n_experts=8,
           n_shared_experts=1, moe_top_k=2, moe_d_ff=48, capacity_factor=8.0,
           dtype="float32", moe_impl="shard_map")
EP_CASES = (("cf8", (2, 2), {}),
            ("cf07_k6", (1, 4), {"capacity_factor": 0.7, "moe_top_k": 6}))
SP = dict(name="t", family="dense", n_layers=2, d_model=48, n_heads=6,
          n_kv_heads=2, head_dim=8, d_ff=96, vocab_size=64, dtype="float32",
          seq_parallel_attn=True)
DM, POD = ("data", "model"), ("pod", "data", "model")
#: name: (arch, config changes, mesh shape, its axes, batch, tokens a row)
ROWS = {
    "yi-fsdp-2x1-b1": ("yi-6b", {"fsdp": True}, (2, 1), DM, 1, 32),
    "yi-2x2x1-b2": ("yi-6b", {}, (2, 2, 1), POD, 2, 32),
    "yi-2x2x1-b1": ("yi-6b", {}, (2, 2, 1), POD, 1, 32),
    "qwen2moe-ep-2x1-b1": ("qwen2-moe-a2.7b", {"moe_impl": "shard_map",
                                               "capacity_factor": 3.0},
                           (2, 1), DM, 1, 32),
    "recurrentgemma-2x1-b1": ("recurrentgemma-2b", {}, (2, 1), DM, 1, 32),
    "deepseek-sp-1x3": ("deepseek-v3-671b", {"seq_parallel_attn": True},
                        (1, 3), DM, 2, 48),
}
#: the rows cases' adamw steps (lr 1e-2 from the first step on)
ROWS_LR = dict(peak_lr=1e-2, warmup=0, total=10)
CLI = ["--arch", "yi-6b", "--smoke", "--seq-len", "32", "--global-batch",
       "4", "--device", "cpu", "--log-every", "1"]
DS_CLI = ["--arch", "deepseek-v3-671b"] + CLI[2:]

REF_SCRIPT = r'''
import dataclasses, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs.base import ModelConfig
from repro.models import attention as A
from repro.models import moe as M
from repro.models.model import build_model

assert len(jax.devices()) == 4, jax.devices()
d = sys.argv[1]
inp = dict(np.load(d + "/inputs.npz", allow_pickle=True))
cfgs = inp.pop("cfgs").item()
out = {}
for name, shape in cfgs["ep"]:
    cfg = ModelConfig(**cfgs["moe"][name])
    params = {k[len(name) + 4:]: jnp.asarray(v) for k, v in inp.items()
              if k.startswith(name + "/ep/")}
    params = {"router": params["router"], "wi_gate": params["wi_gate"],
              "wi_up": params["wi_up"], "wo": params["wo"],
              "shared": {k[7:]: v for k, v in params.items()
                         if k.startswith("shared/")}}
    mesh = jax.make_mesh(tuple(shape), ("data", "model"))
    x, g = jnp.asarray(inp[name + "/x"]), jnp.asarray(inp[name + "/g"])

    def objective(p, x):
        o, a = M.moe_ffn(p, cfg, x)
        return jnp.sum(o * g) + a
    with mesh:
        assert M._ep_axes_available(cfg), name
        o, a = jax.jit(lambda p, x: M.moe_ffn(p, cfg, x))(params, x)
        grads = jax.jit(jax.grad(objective))(params, x)
    out[name + "/out"], out[name + "/aux"] = np.asarray(o), np.asarray(a)
    for k, v in grads.items():
        for sub, leaf in (v.items() if isinstance(v, dict) else [("", v)]):
            out[name + "/grad/" + k + ("/" + sub if sub else "")] = \
                np.asarray(leaf)
sp = ModelConfig(**cfgs["sp"])
flat = {k[3:]: v for k, v in inp.items() if k.startswith("sp/")}
leaves, treedef = jax.tree_util.tree_flatten(build_model(sp).init(
    jax.random.PRNGKey(0)))
paths = [jax.tree_util.keystr(p) for p, _ in
         jax.tree_util.tree_flatten_with_path(build_model(sp).init(
             jax.random.PRNGKey(0)))[0]]
params = jax.tree_util.tree_unflatten(
    treedef, [jnp.asarray(flat[p]) for p in paths])
batch = {"tokens": jnp.asarray(inp["sp_tokens"]),
         "labels": jnp.asarray(inp["sp_labels"])}
with jax.make_mesh((1, 4), ("data", "model")):
    assert A._sp_active(sp, batch["tokens"].shape[1])
    loss, _ = jax.jit(build_model(sp).loss)(params, batch)
out["sp/loss"] = np.asarray(loss)
np.savez(d + "/ref.npz", **out)
'''

#: the reference's train steps of ``ROWS`` (a second subprocess): loss,
#: grad_norm, the gradients (adamw's first moment over 1 - b1, unclipped)
#: and the loss after one step, with ``build_cell``'s shardings
REF_ROWS_SCRIPT = r'''
import dataclasses, math, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_smoke
from repro.configs.base import ShapeConfig
from repro.launch.steps import build_cell, make_train_step
from repro.models import attention as A
from repro.optim.optimizers import adamw

assert len(jax.devices()) == 4, jax.devices()
d = sys.argv[1]
inp = dict(np.load(d + "/rows_inputs.npz", allow_pickle=True))
cases = inp.pop("cases").item()
out = {}


def keys(tree):
    return [jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


for name, (arch, kw, shape, axes, B, S, lr) in cases.items():
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32", **kw)
    mesh = jax.make_mesh(tuple(shape), tuple(axes),
                         devices=jax.devices()[:math.prod(shape)],
                         axis_types=(jax.sharding.AxisType.Auto,) * len(shape))
    batch = {k: jnp.asarray(inp[name + "/" + k]) for k in ("tokens",
                                                          "labels")}
    with mesh:
        cell = build_cell(cfg, ShapeConfig("t", S, B, "train"), mesh,
                          opt=adamw())
        shapes = jax.eval_shape(cell.model.init, jax.random.PRNGKey(0))
        params = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(shapes),
            [jnp.asarray(inp[name + "/p" + p]) for p in keys(shapes)])
        if cfg.seq_parallel_attn:
            assert A._sp_active(cfg, S), name
        step = jax.jit(make_train_step(cell.model, adamw(), **lr),
                       in_shardings=cell.in_shardings,
                       out_shardings=cell.out_shardings)
        p1, s1, m1 = step(params, adamw().init(params), batch)
        _, _, m2 = step(p1, s1, batch)
    gn = float(m1["grad_norm"])
    out[name + "/loss"] = np.asarray(m1["loss"])
    out[name + "/gnorm"] = np.asarray(gn)
    out[name + "/losses"] = np.asarray([m1["loss"], m2["loss"]])
    clip = min(1.0, 1.0 / max(gn, 1e-12))
    m = s1.inner["m"]
    for p, leaf in zip(keys(m), jax.tree_util.tree_leaves(m)):
        out[name + "/grad" + p] = np.asarray(leaf) / (1 - 0.9) / clip
np.savez(d + "/ref_rows.npz", **out)
'''


# ---------------------------------------------------------------------------
# inputs shared by both sides
# ---------------------------------------------------------------------------

def arch_cfg(arch: str, fsdp: bool) -> ModelConfig:
    return dataclasses.replace(get_smoke(arch), dtype="float32", fsdp=fsdp)


def arch_batch(cfg) -> dict:
    rng = np.random.default_rng(3)
    t = rng.integers(0, cfg.vocab_size, size=(4, 32)).astype(np.int32)
    return {"tokens": t, "labels": np.roll(t, -1, 1)}


def arch_params(cfg):
    return TM.build_model(cfg).init(torch.Generator().manual_seed(5), "cpu")


def adafactor_of(cfg, momentum: bool):
    """adafactor as ``default_optimizer`` gives it to the >100B configs:
    the layers the reference stacks update as one tensor each."""
    return make_optimizer("adafactor", momentum=momentum,
                          stacks=functools.partial(TM.stacked_layers,
                                                   cfg=cfg))


def moe_cfg(kw) -> ModelConfig:
    return ModelConfig(**{**MOE, **kw})


def moe_params(cfg):
    return TMoE.init_moe(torch.Generator().manual_seed(7), cfg, "cpu")


def moe_x() -> np.ndarray:
    return (np.random.default_rng(8).normal(size=(4, 16, 64)) * 0.5
            ).astype(np.float32)


def moe_cotangent() -> torch.Tensor:
    return torch.as_tensor(np.random.default_rng(9).normal(
        size=(4, 16, 64)).astype(np.float32))


def sp_inputs():
    cfg = ModelConfig(**SP)
    params = TM.build_model(cfg).init(torch.Generator().manual_seed(11),
                                      "cpu")
    rng = np.random.default_rng(12)
    t = rng.integers(0, 64, size=(2, 64)).astype(np.int32)
    return cfg, params, {"tokens": t, "labels": np.roll(t, -1, 1)}


def rows_cfg(name: str) -> ModelConfig:
    arch, kw = ROWS[name][:2]
    return dataclasses.replace(get_smoke(arch), dtype="float32", **kw)


def rows_batch(name: str) -> dict:
    B, S = ROWS[name][4:]
    rng = np.random.default_rng(13)
    t = rng.integers(0, rows_cfg(name).vocab_size, size=(B, S)).astype(
        np.int32)
    return {"tokens": t, "labels": np.roll(t, -1, 1)}


def rows_params(name: str):
    return arch_params(rows_cfg(name))


def ce_only(model):
    """``model`` whose loss leaves out the MoE aux: expert parallelism
    forms the aux per token slice, the gather path on one rank over every
    token.  On a mesh a rank's total holds its data rank's share of the
    aux."""
    def loss(p, b):
        total, met = model.loss(p, b)
        share = met["aux"] / shd.data_size(shd.ambient_mesh())
        return (total - TM.MOE_AUX_WEIGHT * share,
                {**met, "loss": met["ce"]})
    return model._replace(loss=loss)


def rows_models(name: str) -> dict:
    """{"ref": the model held to the reference and to one rank}, or for
    the EP case also {"one": the model held to one rank, without its
    aux}."""
    model = TM.build_model(rows_cfg(name))
    if rows_cfg(name).moe_impl != "shard_map":
        return {"ref": model}
    return {"ref": model, "one": ce_only(model)}


def _flat_ref(tree, prefix=""):
    """A reference-layout tree as {jax keystr: array}."""
    import jax
    return {prefix + jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _gathered(tree, specs, mesh) -> list:
    return [t.detach().clone() for t in tree_leaves(
        steps.gather_tree(tree, specs, mesh))]


def _arch_runs(mesh, out: dict) -> None:
    for arch, fsdp in ARCHS:
        cfg = arch_cfg(arch, fsdp)
        model = TM.build_model(cfg)
        local, specs = steps.shard_params(cfg, arch_params(cfg), mesh)
        grads, met, gn = steps.loss_and_grads(model, local, arch_batch(cfg),
                                              mesh=mesh, specs=specs)
        key = f"{tuple(mesh.shape)}/{arch}/{fsdp}"
        out[key + "/loss"] = float(met["loss"])
        out[key + "/gnorm"] = float(gn)
        out[key + "/grads"] = _gathered(tree_unflatten(local, iter(grads)),
                                        specs, mesh)
        if (arch, fsdp) in ADAFACTOR:
            out[key + "/adafactor_update"] = _adafactor_update(
                local, grads, gn, specs, mesh)
        opt = make_optimizer("adamw")
        out[key + "/steps"] = _three_steps(cfg, opt, local, mesh, specs)
        for momentum in [m for a, f, m in ADA_STEPS
                         if (a, f) == (arch, fsdp)]:
            opt = adafactor_of(cfg, momentum)
            local, _ = steps.shard_params(cfg, arch_params(cfg), mesh)
            out[f"{key}/adafactor_steps/{momentum}"] = _three_steps(
                cfg, opt, local, mesh, specs)


def _mla_heads_whole_run(out: dict) -> None:
    """deepseek-v3 SMOKE on (1, 3), a mesh of the first three ranks (each
    rank builds it; the fourth has no coordinate): the loss and the
    gradients gathered back."""
    mesh = DeviceMesh("cpu", torch.arange(3).reshape(1, 3),
                      mesh_dim_names=("data", "model"))
    if mesh.get_coordinate() is None:
        return
    cfg = arch_cfg("deepseek-v3-671b", False)
    local, specs = steps.shard_params(cfg, arch_params(cfg), mesh)
    grads, met, _ = steps.loss_and_grads(TM.build_model(cfg), local,
                                         arch_batch(cfg), mesh=mesh,
                                         specs=specs)
    out["1x3/loss"] = float(met["loss"])
    out["1x3/grads"] = _gathered(tree_unflatten(local, iter(grads)), specs,
                                 mesh)


def _sub_mesh(shape, axes):
    """A mesh of ``shape`` over the first ranks of the world: every rank
    builds it (its groups), a rank outside has no coordinate."""
    n = int(np.prod(shape))
    if n == WORLD:
        return make_mesh(shape, axes, "cpu")
    return DeviceMesh("cpu", torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def _rows_runs(out: dict) -> None:
    """Each ``ROWS`` case on its mesh: per model (``rows_models``) the loss,
    grad_norm, the gradients gathered and two adamw steps' losses; and this
    rank's record: its coordinate, its rows, the tokens each expert-
    parallel dispatch routed and the (query, key) lengths of each MLA
    attention."""
    recs = {}
    for name, (_, _, shape, axes, _, _) in ROWS.items():
        mesh = _sub_mesh(shape, axes)
        if mesh.get_coordinate() is None:
            continue
        cfg = rows_cfg(name)
        rec = {"coord": [int(c) for c in mesh.get_coordinate()],
               "rows": torch.as_tensor(steps.local_rows(
                   rows_batch(name), mesh)["tokens"]),
               "routed": [], "attend": []}
        assign, attend = TMoE._assign, TA.mla_attend_full

        def spy_assign(cfg_, idx, cap, *a, **k):
            rec["routed"].append(int(idx.shape[0]))
            return assign(cfg_, idx, cap, *a, **k)

        def spy_attend(params, cfg_, q_nope, q_rope, ckv, k_rope):
            rec["attend"].append((int(q_nope.shape[1]), int(ckv.shape[1])))
            return attend(params, cfg_, q_nope, q_rope, ckv, k_rope)
        TMoE._assign, TA.mla_attend_full = spy_assign, spy_attend
        try:
            for side, model in rows_models(name).items():
                local, specs = steps.shard_params(cfg, rows_params(name),
                                                  mesh)
                grads, met, gn = steps.loss_and_grads(
                    model, local, rows_batch(name), mesh=mesh, specs=specs)
                key = f"rows/{name}/{side}"
                out[key + "/loss"] = float(met["loss"])
                out[key + "/gnorm"] = float(gn)
                out[key + "/grads"] = _gathered(
                    tree_unflatten(local, iter(grads)), specs, mesh)
                out[key + "/steps"] = _adamw_steps(model, local, mesh, specs,
                                                   rows_batch(name))
        finally:
            TMoE._assign, TA.mla_attend_full = assign, attend
        recs[name] = rec
    every = [None] * WORLD
    dist.all_gather_object(every, recs)
    out["rows/ranks"] = every


def _adamw_steps(model, local, mesh, specs, batch) -> list:
    """Two adamw steps' losses (``ROWS_LR``: the second after an update),
    on ``mesh`` or, with None, on one rank."""
    opt = make_optimizer("adamw")
    step = steps.make_train_step(model, opt, mesh=mesh, specs=specs,
                                 **ROWS_LR)
    state = opt.init(local, mesh=mesh, specs=None if specs is None else
                     [s for _, s in shd.leaves_with_path(specs)])
    losses = []
    for _ in range(2):
        local, state, m = step(local, state, batch)
        losses.append(float(m["loss"]))
    return losses


def _three_steps(cfg, opt, local, mesh, specs) -> list:
    step = steps.make_train_step(TM.build_model(cfg), opt, peak_lr=1e-2,
                                 warmup=1, total=10, mesh=mesh, specs=specs)
    state = opt.init(local, mesh=mesh,
                     specs=[s for _, s in shd.leaves_with_path(specs)])
    losses = []
    for _ in range(3):
        local, state, m = step(local, state, arch_batch(cfg))
        losses.append(float(m["loss"]))
    return losses


def _adafactor_update(local, grads, gn, specs, mesh) -> dict:
    """One adafactor update (momentum on, every leaf its own tensor, as
    the reference's) of copies of the shards by the synced gradients: its
    statistics (whole on every rank), and the params and momentum
    gathered back."""
    flat = [s for _, s in shd.leaves_with_path(specs)]
    params = tree_unflatten(local, iter([t.detach().clone()
                                         for t in tree_leaves(local)]))
    opt = make_optimizer("adafactor", momentum=True)
    state = opt.init(params, mesh=mesh, specs=flat)
    params, state, _ = opt.update(tree_unflatten(local, iter(grads)), state,
                                  params, torch.tensor(ADA_LR), gnorm=gn,
                                  mesh=mesh, specs=flat)
    return {"stats": [t.clone() for t in tree_leaves(state.inner["stats"])],
            "m": _gathered(state.inner["m"], specs, mesh),
            "params": _gathered(params, specs, mesh)}


def _ep_runs(out: dict) -> None:
    x = torch.as_tensor(moe_x())
    for name, shape, kw in EP_CASES:
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        cfg = moe_cfg(kw)
        full = moe_params(cfg)
        specs = shd.param_shardings({"moe": full}, mesh,
                                    moe_ep2d=True)["moe"]
        local = shd.shard_tree(full, specs, mesh)
        for t in tree_leaves(local):
            t.requires_grad_(True)
        with shd.use_mesh(mesh):
            xl = steps.local_rows({"x": x}, mesh)["x"]
            o, aux = TMoE.moe_ffn(shd.mesh_view(local, specs), cfg, xl)
            g = steps.local_rows({"g": moe_cotangent()}, mesh)["g"]
            # each data rank's share of sum(out·g) + aux
            (torch.sum(o * g) + aux / shd.data_size(mesh)).backward()
        rows = torch.cat([t.detach() for t in _all_rows(o.detach(), mesh)])
        out[name + "/out"] = rows
        out[name + "/aux"] = float(aux)
        grads = [t.grad for t in tree_leaves(local)]
        steps.sync_grads(grads, [s for _, s in shd.leaves_with_path(specs)],
                         mesh)
        out[name + "/grads"] = _gathered(tree_unflatten(local, iter(grads)),
                                         specs, mesh)


def _all_rows(t, mesh) -> list:
    """Every data rank's rows, in data order (the ranks of one ``model``
    group hold the same rows; ranks are row-major over (data, model))."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t.contiguous())
    return parts[::mesh.shape[1]]


def _sp_run(out: dict) -> None:
    mesh = make_mesh((1, 4), ("data", "model"), "cpu")
    cfg, params, batch = sp_inputs()
    local, specs = steps.shard_params(cfg, params, mesh)
    grads, met, _ = steps.loss_and_grads(TM.build_model(cfg), local, batch,
                                         mesh=mesh, specs=specs)
    out["sp/loss"] = float(met["loss"])
    out["sp/grads"] = _gathered(tree_unflatten(local, iter(grads)), specs,
                                mesh)


def _cli_runs(d: str, out: dict) -> None:
    ttrain.main(CLI + ["--steps", "2", "--mesh", "2x2", "--ckpt-dir",
                       d + "/ck_mesh", "--ckpt-every", "2"])
    out["cli/mesh_resumes_single"] = ttrain.main(
        CLI + ["--steps", "3", "--mesh", "2x2", "--ckpt-dir",
               d + "/ck_single", "--ckpt-every", "5"])
    out["cli/deepseek"] = ttrain.main(DS_CLI + ["--steps", "3", "--mesh",
                                                "2x2"])
    # what a mesh checkpoint stores: the shards gathered back, bit for bit
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    cfg = dataclasses.replace(get_smoke("qwen2-moe-a2.7b"), fsdp=True)
    full = arch_params(cfg)
    local, specs = steps.shard_params(cfg, full, mesh)
    out["cli/roundtrip"] = all(
        torch.equal(a, b) for a, b in zip(
            _gathered(local, specs, mesh), tree_leaves(full)))
    # the checkpoint's gather: whole leaves on rank 0's host only
    to0 = steps.gather_tree(local, specs, mesh, dst=0)
    out["cli/roundtrip_rank0"] = (to0 is None) != (dist.get_rank() == 0) \
        and (to0 is None or all(
            a.device.type == "cpu" and torch.equal(a, b)
            for a, b in zip(tree_leaves(to0), tree_leaves(full))))
    out["cli/gathered_on"] = [int(v) for v in _all_ranks(to0 is not None)]
    # a preemption signal on rank 1 alone stops every rank
    out["cli/stop_by_rank"] = [int(v) for v in _all_ranks(ttrain._any_rank(
        dist.get_rank() == 1, mesh, torch.device("cpu")))]
    out["cli/stop_none"] = ttrain._any_rank(False, mesh, torch.device("cpu"))


def _all_ranks(flag: bool) -> list:
    parts = [torch.zeros(1, dtype=torch.int64)
             for _ in range(dist.get_world_size())]
    dist.all_gather(parts, torch.tensor([int(flag)]))
    return [int(p) for p in parts]


def _port_rank(rank: int, world: int, d: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/store",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        out = {}
        for shape in MESHES:
            _arch_runs(make_mesh(shape, ("data", "model"), "cpu"), out)
        _mla_heads_whole_run(out)
        _rows_runs(out)
        _ep_runs(out)
        _sp_run(out)
        _cli_runs(d, out)
        if rank == 0:
            torch.save(out, f"{d}/port.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _spawn(fn, args, nprocs: int, timeout: float) -> None:
    ctx = mp.spawn(fn, args=args, nprocs=nprocs, join=False)
    t0 = time.monotonic()
    while not ctx.join(timeout=5):
        if time.monotonic() - t0 > timeout:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"the {nprocs} ranks ran past {timeout} s")


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    inputs = {"cfgs": np.array({
        "moe": {name: {**MOE, **kw} for name, _, kw in EP_CASES},
        "ep": [(name, shape) for name, shape, _ in EP_CASES], "sp": SP},
        dtype=object)}
    rows = {"cases": np.array({
        name: c + (ROWS_LR,) for name, c in ROWS.items()}, dtype=object)}
    for name in ROWS:
        rows.update(_flat_ref(convert.params_to_reference(
            rows_params(name), rows_cfg(name)), name + "/p"))
        rows.update({f"{name}/{k}": v for k, v in rows_batch(name).items()})
    np.savez(d / "rows_inputs.npz", **rows)
    x = moe_x()
    for name, _, kw in EP_CASES:
        inputs[name + "/x"] = x
        inputs[name + "/g"] = moe_cotangent().numpy()
        for path, leaf in shd.leaves_with_path(moe_params(moe_cfg(kw))):
            inputs[name + "/ep/" + "/".join(path)] = leaf.numpy()
    cfg, params, batch = sp_inputs()
    ref_params = convert.params_to_reference(params, cfg)
    inputs.update(_flat_ref(ref_params, "sp/"))
    inputs["sp_tokens"], inputs["sp_labels"] = batch["tokens"], \
        batch["labels"]
    np.savez(d / "inputs.npz", **inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(REPO / "src"))
    procs = [subprocess.Popen([sys.executable, "-c", script, str(d)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for script in (REF_SCRIPT, REF_ROWS_SCRIPT)]
    # the reverse checkpoint: two steps on one device, resumed on the mesh
    ttrain.main(CLI + ["--steps", "2", "--ckpt-dir", str(d / "ck_single"),
                       "--ckpt-every", "2"])
    try:
        _spawn(_port_rank, (WORLD, str(d)), WORLD, TIMEOUT)
    finally:
        for proc in procs:
            try:
                stdout, stderr = proc.communicate(timeout=TIMEOUT)
            except subprocess.TimeoutExpired:
                proc.kill()
                raise
            assert proc.returncode == 0, stdout + "\n" + stderr
    return {"port": torch.load(d / "port.pt"),
            "ref": {**np.load(d / "ref.npz"), **np.load(d / "ref_rows.npz")},
            "dir": d}


def scaled(got, want) -> float:
    got = torch.as_tensor(got, dtype=torch.float64)
    want = torch.as_tensor(want, dtype=torch.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float((got - want).abs().max() / max(float(want.abs().max()),
                                                 1e-30))


def one_rank(cfg, params, batch):
    grads, met, _ = steps.loss_and_grads(TM.build_model(cfg), params, batch)
    return float(met["loss"]), [g.detach() for g in grads]


# ---------------------------------------------------------------------------
# against one rank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch,fsdp", ARCHS,
                         ids=[f"{a}{'-fsdp' if f else ''}" for a, f in ARCHS])
def test_mesh_step_matches_one_rank(runs, shape, arch, fsdp):
    cfg = arch_cfg(arch, fsdp)
    params = arch_params(cfg)
    loss, grads = one_rank(cfg, params, arch_batch(cfg))
    key = f"{shape}/{arch}/{fsdp}"
    got = runs["port"]
    assert abs(got[key + "/loss"] - loss) <= TOL_LOSS * abs(loss)
    assert len(got[key + "/grads"]) == len(grads)
    errs = [scaled(a, b) for a, b in zip(got[key + "/grads"], grads)]
    assert max(errs) <= TOL_GRAD, max(errs)
    gn = float(torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads)))
    assert abs(got[key + "/gnorm"] - gn) <= 1e-5 * gn
    model, opt = TM.build_model(cfg), make_optimizer("adamw")
    step = steps.make_train_step(model, opt, peak_lr=1e-2, warmup=1,
                                 total=10)
    state, losses = opt.init(params), []
    for _ in range(3):
        params, state, m = step(params, state, arch_batch(cfg))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(got[key + "/steps"], losses, rtol=TOL_STEPS)


ADA_IDS = [f"{a}{'-fsdp' if f else ''}" for a, f in ADAFACTOR]


@functools.lru_cache(maxsize=None)
def _reference_adafactor():
    """(the reference's adafactor with momentum, its jitted update): one
    trace per tree structure for the module."""
    import jax
    from repro.optim import optimizers as jopts
    opt = jopts.adafactor(momentum=True)
    return opt, jax.jit(opt.update)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize(
    "arch,fsdp,momentum", ADA_STEPS,
    ids=[f"{a}{'-fsdp' if f else ''}{'-momentum' if m else ''}"
         for a, f, m in ADA_STEPS])
def test_mesh_adafactor_steps_match_one_rank(runs, shape, arch, fsdp,
                                             momentum):
    """Three ``make_train_step`` steps with adafactor on shards (its
    statistics whole and replicated, the stacked layers as one tensor)
    against the same on one rank: the losses ≤ 1e-4."""
    cfg = arch_cfg(arch, fsdp)
    opt = adafactor_of(cfg, momentum)
    step = steps.make_train_step(TM.build_model(cfg), opt, peak_lr=1e-2,
                                 warmup=1, total=10)
    params = arch_params(cfg)
    state, losses = opt.init(params), []
    for _ in range(3):
        params, state, m = step(params, state, arch_batch(cfg))
        losses.append(float(m["loss"]))
    got = runs["port"][f"{shape}/{arch}/{fsdp}/adafactor_steps/{momentum}"]
    np.testing.assert_allclose(got, losses, rtol=TOL_STEPS)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch,fsdp", ADAFACTOR, ids=ADA_IDS)
def test_adafactor_on_shards_matches_reference(runs, shape, arch, fsdp):
    """One adafactor update (momentum on) on the mesh, from the step's
    synced gradients: the statistics r / c / v (whole on every rank) and
    the params gathered back, against the reference's
    ``adafactor().update`` on the gathered gradients and params (every
    leaf its own tensor), ≤ 1e-6 relative; the bf16 momentum within one
    bf16 ulp of each element (its f32 value rounds either way at a
    boundary)."""
    import jax
    import jax.numpy as jnp
    key = f"{shape}/{arch}/{fsdp}"
    got = runs["port"][key + "/adafactor_update"]
    params = tree_leaves(arch_params(arch_cfg(arch, fsdp)))

    def tree(leaves):
        return {f"{i:04d}": jnp.asarray(t.float().numpy())
                for i, t in enumerate(leaves)}
    jp = tree(params)
    opt, update = _reference_adafactor()
    jp, js, _ = update(tree(runs["port"][key + "/grads"]), opt.init(jp), jp,
                       ADA_LR)
    for what, port, ref in (("stats", got["stats"], js.inner["stats"]),
                            ("m", got["m"], js.inner["m"]),
                            ("params", got["params"], jp)):
        ref = jax.tree.leaves(ref)
        assert len(port) == len(ref), what
        for i, (a, b) in enumerate(zip(port, ref)):
            b = np.asarray(b, np.float32)
            assert tuple(a.shape) == b.shape, (what, i, a.shape, b.shape)
            if what == "m":
                assert np.all(np.abs(a.float().numpy() - b)
                              <= 2.0 ** -7 * np.abs(b)), (what, i)
            else:
                assert scaled(a.float(), b) <= 1e-6, (what, i,
                                                      scaled(a.float(), b))


def test_mla_whose_heads_do_not_divide_model(runs):
    """deepseek-v3 SMOKE on (1, 3): its 4 heads do not divide model = 3,
    so the MLA body runs whole on every rank, while ``wq_a``'s 24 q_rank
    columns do and split (the body gathers the weight whole; its gradient
    is each rank's part).  The loss ≤ 1e-5 and every gradient ≤ 1e-4 of
    one rank's."""
    cfg = arch_cfg("deepseek-v3-671b", False)
    params = arch_params(cfg)
    specs = shd.param_shardings(params, {"data": 1, "model": 3})
    mixer = specs["stack"]["prefix"][0]["mixer"]
    assert "model" in mixer["wq_a"] and "model" not in mixer["wq_b"]
    loss, grads = one_rank(cfg, params, arch_batch(cfg))
    got = runs["port"]
    assert abs(got["1x3/loss"] - loss) <= TOL_LOSS * abs(loss)
    errs = [scaled(a, b) for a, b in zip(got["1x3/grads"], grads)]
    assert len(errs) == len(grads) and max(errs) <= TOL_GRAD, max(errs)


@pytest.mark.parametrize("leaf", ("norm1", "router"))
def test_replicated_leaf_gradients_are_one_ranks(runs, leaf):
    """A norm scale and the router are whole on every rank; their gradient
    is summed over the data ranks (and, for what a ``model`` rank uses in
    part, over ``model``) to one rank's."""
    cfg = arch_cfg("qwen2-moe-a2.7b", False)
    params = arch_params(cfg)
    _, grads = one_rank(cfg, params, arch_batch(cfg))
    paths = ["/".join(p) for p, _ in shd.leaves_with_path(params)]
    picked = [i for i, p in enumerate(paths) if f"/{leaf}/" in p
              or p.endswith("/" + leaf)]
    assert picked
    for shape in MESHES:
        got = runs["port"][f"{shape}/qwen2-moe-a2.7b/False/grads"]
        for i in picked:
            assert scaled(got[i], grads[i]) <= TOL_GRAD, (shape, paths[i])


# ---------------------------------------------------------------------------
# expert and sequence parallelism against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [c[0] for c in EP_CASES])
def test_expert_parallel_matches_reference(runs, name):
    got, ref = runs["port"], runs["ref"]
    assert scaled(got[name + "/out"], ref[name + "/out"]) <= 1e-5
    assert abs(got[name + "/aux"] - float(ref[name + "/aux"])) \
        <= 1e-6 * abs(float(ref[name + "/aux"]))


def test_expert_parallel_capacity_bound_case_drops():
    """cf 0.7, k 6: 16 tokens a rank make 96 assignments for 8 experts of
    8 slots each, so the reference's capacity drops some."""
    cfg = moe_cfg(dict(EP_CASES[1][2]))
    assert TMoE.ep_capacity(cfg, 16) == 8 < 96 // 8


def test_expert_parallel_gradients_match_gather_path(runs):
    """At cf 8.0 nothing drops, so EP computes the gather path's function:
    the expert banks' gradients against it on one rank."""
    cfg = dataclasses.replace(moe_cfg({}), moe_impl="gather")
    params = moe_params(cfg)
    for t in tree_leaves(params):
        t.requires_grad_(True)
    out, _ = TMoE.moe_ffn(params, cfg, torch.as_tensor(moe_x()))
    torch.sum(out * moe_cotangent()).backward()
    got = dict(zip(["/".join(p) for p, _ in shd.leaves_with_path(params)],
                   runs["port"]["cf8/grads"]))
    for path, leaf in shd.leaves_with_path(params):
        if path[0] in ("wi_gate", "wi_up", "wo"):
            assert scaled(got["/".join(path)], leaf.grad) <= TOL_GRAD, path


@pytest.mark.parametrize("name", [c[0] for c in EP_CASES])
def test_expert_parallel_gradients_match_reference(runs, name):
    """``jax.grad`` of the reference's ``_moe_shard_map`` (sum(out·g) +
    aux) against the port's expert-parallel backward, each rank's
    gradients summed over the data ranks as the train step sums them:
    the router (summed over ``model`` by ``copy_to``; the aux's term
    through the ``pmean``), the shared experts and the expert banks."""
    cfg = moe_cfg(dict(next(c for c in EP_CASES if c[0] == name)[2]))
    ref = runs["ref"]
    got = runs["port"][name + "/grads"]
    paths = ["/".join(p) for p, _ in shd.leaves_with_path(moe_params(cfg))]
    assert sorted(paths) == sorted(k[len(name) + 6:] for k in ref
                                   if k.startswith(name + "/grad/"))
    for path, g in zip(paths, got):
        assert scaled(g, ref[name + "/grad/" + path]) <= TOL_GRAD, path


def test_sequence_parallel_matches_reference_and_one_rank(runs):
    got = runs["port"]
    ref_loss = float(runs["ref"]["sp/loss"])
    assert abs(got["sp/loss"] - ref_loss) <= TOL_LOSS * abs(ref_loss)
    cfg, params, batch = sp_inputs()
    loss, grads = one_rank(cfg, params, batch)
    assert abs(got["sp/loss"] - loss) <= TOL_LOSS * abs(loss)
    errs = [scaled(a, b) for a, b in zip(got["sp/grads"], grads)]
    assert max(errs) <= TOL_GRAD, max(errs)


# ---------------------------------------------------------------------------
# checkpoints across layouts
# ---------------------------------------------------------------------------

def test_checkpoints_cross_between_mesh_and_one_device(runs, capsys):
    d = runs["dir"]
    full = ttrain.main(CLI + ["--steps", "3"])
    resumed = ttrain.main(CLI + ["--steps", "3", "--ckpt-dir",
                                 str(d / "ck_mesh")])
    assert "restored checkpoint @ step 2" in capsys.readouterr().out
    np.testing.assert_allclose(resumed, full[2:], rtol=2e-3)
    np.testing.assert_allclose(runs["port"]["cli/mesh_resumes_single"],
                               full[2:], rtol=2e-3)
    # the mesh's checkpoint holds whole leaves of the one-device layout
    model = TM.build_model(get_smoke("yi-6b"))
    params = model.init(None, "cpu")
    opt = steps.default_optimizer(get_smoke("yi-6b"))
    like = ttrain.train_tree(params, opt.init(params))
    restored = CheckpointManager(str(d / "ck_mesh")).restore(2, like)
    assert int(restored["opt"]["step"]) == 2
    assert [np.shape(a) for a in tree_leaves(restored)] == \
        [tuple(t.shape) for t in tree_leaves(like)]
    assert runs["port"]["cli/roundtrip"]
    assert runs["port"]["cli/roundtrip_rank0"]
    assert runs["port"]["cli/gathered_on"] == [1, 0, 0, 0]


def test_cli_trains_deepseek_on_a_mesh(runs):
    """``train.py --arch deepseek-v3-671b --mesh 2x2`` (bf16 SMOKE: MLA over
    heads, MTP, the MoE's experts over ``model``): finite losses, the
    first (the same seeded params on both) one device's ≤ 2e-3 relative
    (bf16 sums in another order).  The later steps may part further: a
    bf16 router near-tie sends a token to another expert (the f32 runs
    above hold the steps to one rank's)."""
    got = runs["port"]["cli/deepseek"]
    assert len(got) == 3 and np.isfinite(got).all()
    one = ttrain.main(DS_CLI + ["--steps", "1"])
    np.testing.assert_allclose(got[0], one[0], rtol=2e-3)


def test_a_preemption_on_one_rank_stops_every_rank(runs):
    """The trainer's stop flag is or-ed over the ranks, so every rank
    enters the checkpoint's collectives at the same step."""
    assert runs["port"]["cli/stop_by_rank"] == [1] * WORLD
    assert runs["port"]["cli/stop_none"] is False


# ---------------------------------------------------------------------------
# batches laid out as the reference lays them, and MLA under SP
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def rows_one_rank(name: str):
    """(loss, gradients, two adamw steps' losses) on one rank."""
    model = list(rows_models(name).values())[-1]
    grads, met, _ = steps.loss_and_grads(model, rows_params(name),
                                         rows_batch(name))
    steps_ = _adamw_steps(model, rows_params(name), None, None,
                          rows_batch(name))
    return float(met["loss"]), [g.detach() for g in grads], steps_


@pytest.mark.parametrize("name", ROWS)
def test_batch_rows_and_sp_mla_match_one_rank(runs, name):
    """The loss ≤ 1e-5, every gradient ≤ 1e-4, grad_norm ≤ 1e-5 and two
    adamw steps' losses ≤ 1e-4 of one rank's."""
    loss, grads, steps_ = rows_one_rank(name)
    key = f"rows/{name}/{list(rows_models(name))[-1]}"
    got = runs["port"]
    assert abs(got[key + "/loss"] - loss) <= TOL_LOSS * abs(loss)
    errs = [scaled(a, b) for a, b in zip(got[key + "/grads"], grads)]
    assert len(errs) == len(grads) and max(errs) <= TOL_GRAD, max(errs)
    gn = float(torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads)))
    assert abs(got[key + "/gnorm"] - gn) <= 1e-5 * gn
    np.testing.assert_allclose(got[key + "/steps"], steps_, rtol=TOL_STEPS)


@pytest.mark.parametrize("name", ROWS)
def test_batch_rows_and_sp_mla_match_reference(runs, name):
    """The reference's train step jitted with its ``build_cell``
    shardings on the same mesh: the loss ≤ 1e-5, every gradient (in the
    reference's layout) ≤ 1e-4, grad_norm ≤ 1e-5 and the loss after one
    adamw step ≤ 1e-4."""
    ref, got = runs["ref"], runs["port"]
    key = f"rows/{name}/ref"
    want = float(ref[name + "/loss"])
    assert abs(got[key + "/loss"] - want) <= TOL_LOSS * abs(want)
    gn = float(ref[name + "/gnorm"])
    assert abs(got[key + "/gnorm"] - gn) <= 1e-5 * gn
    grads = _flat_ref(convert.params_to_reference(tree_unflatten(
        rows_params(name), iter(got[key + "/grads"])), rows_cfg(name)))
    assert len(grads) == len([k for k in ref
                              if k.startswith(name + "/grad")])
    for p, g in grads.items():
        assert scaled(g, ref[name + "/grad" + p]) <= TOL_GRAD, p
    np.testing.assert_allclose(got[key + "/steps"], ref[name + "/losses"],
                               rtol=TOL_STEPS)


@pytest.mark.parametrize("name", ROWS)
def test_batch_rows_lie_as_the_reference_lays_them(runs, name):
    """Each rank's rows are its block under the reference's
    ``batch_pspec`` (over the data axes, ``data`` alone, or whole); an
    expert-parallel dispatch routes the reference's token slice, B·S over
    pod × data × model; each MLA attention under SP takes the rank's S/3
    query rows against the keys up to its last row."""
    from repro.distributed import sharding as jshd
    arch, _, shape, axes, B, S = ROWS[name]
    sizes = dict(zip(axes, shape))
    entry = jshd.batch_pspec((B, S), type("Mesh", (), {"shape": sizes})())[0]
    split = () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))
    tokens = torch.as_tensor(rows_batch(name)["tokens"])
    recs = [r[name] for r in runs["port"]["rows/ranks"] if name in r]
    assert len(recs) == int(np.prod(shape))
    for rec in recs:
        coord = dict(zip(axes, rec["coord"]))
        n, i = 1, 0
        for a in split:
            n, i = n * sizes[a], i * sizes[a] + coord[a]
        assert torch.equal(torch.as_tensor(rec["rows"]),
                           tokens[i * B // n:(i + 1) * B // n]), coord
        if rows_cfg(name).moe_impl == "shard_map":
            assert rec["routed"] and set(rec["routed"]) == {B * S // int(
                np.prod(shape))}, rec["routed"]
        if rows_cfg(name).seq_parallel_attn:
            rows = S // sizes["model"]
            assert rec["attend"] and set(rec["attend"]) == {
                (rows, (coord["model"] + 1) * rows)}, rec["attend"]
