"""The recurrent families and the encoder-decoder on a device mesh (CPU):
training and serving against one rank and against the reference's
sharded cells.

Port side: 4 gloo ranks (``torch.multiprocessing`` spawn, a ``file://``
store in a temp dir) form ("data", "model") meshes (1, 2) and (2, 1) (of
the first two ranks) and (2, 2), and run, once for the module, every case
of ``CASES``: three configs in f32 whose widths trip the sharding rules,

- recurrentgemma-2b at d_model = lru_width = 1,024 (the RG-LRU's five
  matrices split by rows over ``model``, its state by width), 6 layers (2
  reps of (rglru, rglru, local)), 4 heads over 1 kv head, window 16;
- xlstm-125m at head_dim 128, 4 layers (the mLSTM's heads over
  ``model``, C and n split on their key dimension, the sLSTM's gate
  weights on d and its state on head_dim);
- whisper-large-v3 at SMOKE width with 1,024 frames (on (1, 2) at B = 2
  ``enc_kv`` is split by sequence and read through a log-sum-exp merge;
  on (2, 2) by rows and heads);
- on one mesh each: recurrentgemma-2b at width 256 on (1, 2) (its state
  split by width, its matrices whole), and xlstm-125m with 6 heads on
  (1, 4) (heads that ``model`` does not divide: the mixers run whole,
  while the states split on head_dim);

each with a batch of 2 rows:

- train: ``launch.steps.loss_and_grads`` at S = 32 (whisper: 64 frames, 8
  tokens): the loss and every gradient (gathered back) against one rank
  (≤ 1e-5, gradients ≤ 1e-4 scale-normalized); the collectives' counts of
  a train step and of a prefill at S and 2S (equal: no collective runs
  inside a time loop);
- serve: ``Model.prefill`` under ``use_mesh`` (to a 32-token prompt + 8,
  whisper to 448 positions) and 8 greedy tokens through ``build_cell``'s
  decode cell; the prefill cell at the prompt's length: logits ≤ 1e-5
  scale-normalized of one rank's, the same tokens, and each rank's cache
  shards (states, rings, ``enc_kv``) ``local_shard`` of the one-rank
  cache under ``cache_shardings`` (≤ 1e-5), after the prefill and after
  the last step, and gathered back whole.  Where ``data`` splits the
  rows, the one-rank run is of each row alone (``_oracle``): on
  xlstm-125m the one-device logits of a row served alone and in a batch
  of 2 part by 1.0e-5 at one decode step (the mLSTM's normalizer
  q·n near its floor), the GEMM's rounding of another shape;
- the CLI: ``train.py`` and ``serve.py`` with ``--mesh 2x2`` for the
  three SMOKE archs.

Reference side: one subprocess sees 4 CPU devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``) and, for each
family on each of the three meshes (``REF_CASES``: the variants' layouts
are the port's own, held to one rank), jits with the reference's
``build_cell`` shardings its train cell's
loss and gradients (``value_and_grad`` of its model's loss, in the cell's
param and batch specs, out in the param specs), its prefill (the prefill
cell's in specs, the decode cell's cache specs out) and its decode cell,
teacher-forced with the one-rank greedy tokens, on the weights
``convert.params_to_reference`` gives: the port's mesh loss, gradients
and logits against its (the same gates).  The spawn and the subprocess
run at once, each with its own timeout (240 s), and the gloo group a
120 s one.
"""
from __future__ import annotations

import dataclasses
import datetime
import functools
import math
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
from repro_torch.configs import get_smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as shd
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as TM
from repro_torch.optim.optimizers import tree_leaves, tree_unflatten

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT = 240
TOL, TOL_GRAD = 1e-5, 1e-4
B, S, GEN = 2, 32, 8
FRAMES, TRAIN_FRAMES = 1024, 64
MESHES = ((1, 2), (2, 1), (2, 2))
RG = dict(n_layers=6, d_model=1024, lru_width=1024, n_heads=4,
          n_kv_heads=1, head_dim=16, d_ff=64, vocab_size=64, window=16)
XL = dict(n_layers=4, d_model=256, n_heads=4, n_kv_heads=4, head_dim=128,
          vocab_size=64, mlstm_chunk=16)
#: name: (arch, the SMOKE config's changes that make its widths trip the
#: rules).  Two more layouts, one mesh each: the RG-LRU's width split
#: while its matrices stay whole (under the fallback's 1,024), and 6
#: mLSTM / sLSTM heads that ``model`` = 4 does not divide (the mixers run
#: whole, their d-splits gathered or summed) while it splits their
#: head_dim 128 (the states' layout)
ARCHS = {
    "recurrentgemma-2b": ("recurrentgemma-2b", RG),
    "xlstm-125m": ("xlstm-125m", XL),
    "whisper-large-v3": ("whisper-large-v3", dict(vocab_size=64)),
    "recurrentgemma-2b-w256": ("recurrentgemma-2b",
                               dict(RG, d_model=256, lru_width=256)),
    "xlstm-125m-h6": ("xlstm-125m", dict(XL, n_heads=6, n_kv_heads=6)),
}
FAMILIES = ["recurrentgemma-2b", "xlstm-125m", "whisper-large-v3"]
#: the gate of a decode step's logits against the reference's where
#: ``data`` splits the rows (each rank, and each reference device, serves
#: one row), by arch: xlstm-125m's mLSTM divides by max(|q·n|, e^−m), and
#: where |q·n| nears its floor a layer turns 1e-7 of rounding (another
#: GEMM shape or framework) into ~2e-5: one device's own logits of a row
#: served alone and in a batch of 2 part by 1.0e-5 (d_model 256) and
#: 1.7e-5 (768), and the port's mesh against the reference's by 1.02e-5
#: on (2, 1) and 1.41e-5 on (2, 2), each at one of the 8 steps, while the
#: states agree to ~1e-6
REF_DECODE_TOL = {"xlstm-125m": 1e-4}
CASES = [(a, m) for a in FAMILIES for m in MESHES] + [
    ("recurrentgemma-2b-w256", (1, 2)), ("xlstm-125m-h6", (1, 4))]
IDS = [f"{a}-{m[0]}x{m[1]}" for a, m in CASES]
#: the cases held to the reference's cells: each family on each mesh
REF_CASES = [c for c in CASES if c[0] in FAMILIES]
REF_IDS = [i for c, i in zip(CASES, IDS) if c in REF_CASES]

REF_SCRIPT = r'''
import dataclasses, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_smoke
from repro.configs.base import ShapeConfig
from repro.launch.steps import build_cell

assert len(jax.devices()) == 4, jax.devices()
d = sys.argv[1]
inp = dict(np.load(d + "/ref_inputs.npz", allow_pickle=True))
cases = inp.pop("cases").item()
out = {}


def keys(tree):
    return [jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


for name, (arch, kw, shape, seq, max_len, gen) in cases.items():
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32", **kw)
    mesh = jax.make_mesh(tuple(shape), ("data", "model"),
                         devices=jax.devices()[:shape[0] * shape[1]],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    train = {k[len(name) + 7:]: jnp.asarray(v) for k, v in inp.items()
             if k.startswith(name + "/train/")}
    serve = {k[len(name) + 7:]: jnp.asarray(v) for k, v in inp.items()
             if k.startswith(name + "/serve/")}
    B = train["tokens"].shape[0]
    with mesh:
        tcell = build_cell(cfg, ShapeConfig("t", train.get(
            "frames", train["tokens"]).shape[1], B, "train"), mesh)
        model = tcell.model
        shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        params = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(shapes),
            [jnp.asarray(inp[name + "/p" + p]) for p in keys(shapes)])
        grad = jax.jit(jax.value_and_grad(lambda p, b: model.loss(p, b)[0]),
                       in_shardings=(tcell.in_shardings[0],
                                     tcell.in_shardings[2]),
                       out_shardings=(tcell.out_shardings[2],
                                      tcell.out_shardings[0]))
        loss, grads = grad(params, train)
        out[name + "/loss"] = np.asarray(loss)
        for p, g in zip(keys(grads), jax.tree_util.tree_leaves(grads)):
            out[name + "/grad" + p] = np.asarray(g)
        pcell = build_cell(cfg, ShapeConfig("p", seq, B, "prefill"), mesh)
        dcell = build_cell(cfg, ShapeConfig(
            "d", seq if cfg.is_encdec else max_len, B, "decode"), mesh)
        prefill = jax.jit(
            lambda p, b: model.prefill(p, b, jax.random.PRNGKey(0), max_len),
            in_shardings=pcell.in_shardings,
            out_shardings=(pcell.out_shardings[0], dcell.in_shardings[1]))
        decode = jax.jit(dcell.step_fn, in_shardings=dcell.in_shardings,
                         out_shardings=dcell.out_shardings)
        logits, cache = prefill(params, serve)
        got = [np.asarray(logits)]
        toks = inp[name + "/greedy"]
        start = serve["tokens"].shape[1]
        for i in range(gen - 1):
            logits, cache = decode(params, cache,
                                   jnp.asarray(toks[:, i:i + 1], jnp.int32),
                                   jnp.asarray(start + i, jnp.int32))
            got.append(np.asarray(logits))
    out[name + "/logits"] = np.stack(got)
np.savez(d + "/ref.npz", **out)
'''


# ---------------------------------------------------------------------------
# inputs shared by every side
# ---------------------------------------------------------------------------

def case_name(arch: str, shape) -> str:
    return f"{arch}-{shape[0]}x{shape[1]}"


def arch_cfg(name: str):
    arch, kw = ARCHS[name]
    return dataclasses.replace(get_smoke(arch), dtype="float32", **kw)


@functools.lru_cache(maxsize=None)
def arch_params(arch: str) -> dict:
    """The config's seeded params, drawn once a process (read, never
    updated)."""
    return TM.build_model(arch_cfg(arch)).init(
        torch.Generator().manual_seed(5), "cpu")


@functools.lru_cache(maxsize=None)
def ref_params(arch: str) -> dict:
    """``arch_params`` in the reference's layout, as {keystr: array}."""
    return _flat_ref(convert.params_to_reference(arch_params(arch),
                                                 arch_cfg(arch)), "")


def train_batch(arch: str, seq: int = S) -> dict:
    """B rows of ``seq`` tokens (whisper: ``seq`` · 2 frames and ``seq``
    // 4 tokens, input_specs' 8 : 1 at TRAIN_FRAMES)."""
    cfg = arch_cfg(arch)
    rng = np.random.default_rng(3)
    if cfg.is_encdec:
        n = seq * TRAIN_FRAMES // S
        t = rng.integers(0, cfg.vocab_size, size=(B, n // 8 + 1))
        return {"frames": rng.standard_normal(
                    (B, n, cfg.frontend_dim)).astype(np.float32),
                "tokens": t[:, :-1].astype(np.int32),
                "labels": t[:, 1:].astype(np.int32)}
    t = rng.integers(0, cfg.vocab_size, size=(B, seq + 1))
    return {"tokens": t[:, :-1].astype(np.int32),
            "labels": t[:, 1:].astype(np.int32)}


def serve_batch(arch: str, seq: int = S) -> dict:
    """The prompts: B rows of ``seq`` tokens; whisper's ``seq`` · 32
    frames (FRAMES at S) and a 1-token decoder prompt."""
    cfg = arch_cfg(arch)
    rng = np.random.default_rng(6)
    if cfg.is_encdec:
        return {"frames": torch.as_tensor(rng.standard_normal(
                    (B, seq * FRAMES // S, cfg.frontend_dim)).astype(
                    np.float32)),
                "tokens": torch.as_tensor(rng.integers(
                    0, cfg.vocab_size, size=(B, 1)))}
    return {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                   size=(B, seq)))}


def max_len(arch: str) -> int:
    return steps.WHISPER_DECODER_LEN if arch_cfg(arch).is_encdec \
        else S + GEN


def prompt_len(arch: str) -> int:
    return serve_batch(arch)["tokens"].shape[1]


def cell_seq(arch: str) -> int:
    """The serving cells' ``seq_len``: whisper's frames, else the
    prompt."""
    return FRAMES if arch_cfg(arch).is_encdec else S


def one_rank(arch: str) -> dict:
    """On one device: the loss and gradients of the whole batch; the
    serving runs (``one_serve``) of the whole batch ("whole") and of each
    row alone, their results concatenated by rows ("rows": what a data
    rank of one row holds against)."""
    cfg = arch_cfg(arch)
    model, params = TM.build_model(cfg), arch_params(arch)
    grads, met, _ = steps.loss_and_grads(model, params, train_batch(arch))
    out = {"loss": float(met["loss"]),
           "grads": [g.detach().clone() for g in grads]}
    for p in tree_leaves(params):
        p.requires_grad_(False)
        p.grad = None
    out["whole"] = one_serve(model, params, arch, 0, B)
    per = [one_serve(model, params, arch, b, 1) for b in range(B)]
    dim = 1 if cfg.is_encdec else 0          # a cache leaf's batch

    def cat(key, d):
        return torch.cat([r[key] for r in per], d)
    out["rows"] = {
        "logits": cat("logits", 1), "tokens": cat("tokens", 0),
        "cell_logits": cat("cell_logits", 0),
        "prefill_cache": [torch.cat(ts, dim) for ts in zip(
            *[r["prefill_cache"] for r in per])],
        **{key: _whole([torch.cat(ts, dim) for ts in zip(*[
            [t for _, t in shd.leaves_with_path(r[key])] for r in per])],
            per[0][key]) for key in ("cache", "cell_cache")}}
    return out


@torch.no_grad()
def one_serve(model, params, arch: str, first: int, n: int) -> dict:
    """Rows ``first`` to ``first + n`` on one device: the prefill to
    ``max_len``, GEN - 1 greedy steps, and the prefill at the prompt's
    length."""
    cfg = model.cfg
    batch = {k: v[first:first + n] for k, v in serve_batch(arch).items()}
    P = prompt_len(arch)
    logits, cache = model.prefill(params, batch, max_len(arch))
    out = {"prefill_cache": [t.clone() for _, t in
                             shd.leaves_with_path(cache)]}
    lg, toks = [logits], [torch.argmax(logits, -1)]
    for i in range(GEN - 1):
        logits, cache = model.decode_step(params, cache, toks[-1][:, None],
                                          P + i)
        lg.append(logits)
        toks.append(torch.argmax(logits, -1))
    out.update(logits=torch.stack(lg), tokens=torch.stack(toks, 1),
               cache=cache)
    out["cell_logits"], out["cell_cache"] = model.prefill(
        params, batch, steps.WHISPER_DECODER_LEN if cfg.is_encdec else P)
    return out


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def scaled(got, want) -> float:
    got = torch.as_tensor(got, dtype=torch.float64)
    want = torch.as_tensor(want, dtype=torch.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float((got - want).abs().max() / max(float(want.abs().max()),
                                                 1e-30))


def _shard_errs(leaves, whole_cache, mesh) -> list:
    """[(path, shape equal, error)] of this rank's cache leaves against
    ``local_shard`` of the whole cache under ``cache_shardings``."""
    specs = dict(shd.leaves_with_path(shd.cache_shardings(whole_cache,
                                                          mesh)))
    out = []
    for (path, want), got in zip(shd.leaves_with_path(whole_cache), leaves):
        want = shd.local_shard(want, specs[path], mesh)
        same = tuple(got.shape) == tuple(want.shape)
        out.append(("/".join(path), same,
                    scaled(got, want) if same else float("inf")))
    return out


def _whole(leaves, like):
    """The tree of ``like`` with ``leaves`` in its place."""
    it = iter(leaves)
    return shd.map_with_path(lambda _, t: next(it), like)


def _mesh(shape):
    """A ("data", "model") mesh over the first ranks of the world; every
    rank builds it (its groups), a rank outside has no coordinate."""
    if shape[0] * shape[1] == WORLD:
        return make_mesh(shape, ("data", "model"), "cpu")
    return DeviceMesh("cpu", torch.arange(shape[0] * shape[1]).reshape(
        shape), mesh_dim_names=("data", "model"))


def _counts() -> dict:
    return {k: v["count"] for k, v in C.STATS.items()}


def _train(arch: str, mesh, local, specs, model) -> dict:
    """The loss and the gradients gathered back, and the collectives'
    counts of the step at S and at 2S."""
    counts = []
    for seq in (S, 2 * S):
        C.reset_stats()
        grads, met, _ = steps.loss_and_grads(
            model, local, train_batch(arch, seq), mesh=mesh, specs=specs)
        counts.append(_counts())
        if seq == S:
            out = {"loss": float(met["loss"]),
                   "grads": [t.detach().clone() for t in tree_leaves(
                       steps.gather_tree(tree_unflatten(local, iter(grads)),
                                         specs, mesh))],
                   "grad_shapes": [tuple(g.shape) for g in grads]}
    out["train_counts"] = counts
    for p in tree_leaves(local):
        p.requires_grad_(False)
        p.grad = None
    return out


@torch.no_grad()
def _serve(arch: str, mesh, local, specs, model, one: dict) -> dict:
    cfg = arch_cfg(arch)
    rows = shd.row_axes(B, mesh)
    first, n = shd.local_range((rows,), 0, B, mesh)
    P = prompt_len(arch)

    def mine(batch):
        return {k: v[first:first + n] for k, v in batch.items()}
    counts = []
    for seq in (2 * S, S):                 # S last: its cache is served on
        C.reset_stats()
        with shd.use_mesh(mesh):
            logits, cache = model.prefill(
                shd.mesh_view(local, specs), mine(serve_batch(arch, seq)),
                max_len(arch) + seq - S, global_batch=B)
        counts.insert(0, _counts())
    whole = _whole(one["prefill_cache"], one["cache"])
    out = {"rows": (first, n), "prefill_counts": counts,
           "prefill_cache": _shard_errs(
               [t for _, t in shd.leaves_with_path(cache)], whole, mesh),
           "gathered_cache": [
               ("/".join(path), tuple(a.shape) == tuple(b.shape),
                scaled(a, b) if tuple(a.shape) == tuple(b.shape)
                else float("inf"))
               for (path, a), (_, b) in zip(
                   shd.leaves_with_path(shd.gather_cache(cache, mesh)),
                   shd.leaves_with_path(whole))]}
    dcell = steps.build_cell(cfg, ShapeConfig(
        "d", FRAMES if cfg.is_encdec else max_len(arch), B, "decode"), mesh)
    lg, toks = [logits], [torch.argmax(logits, -1)]
    C.reset_stats()
    for i in range(GEN - 1):
        logits, cache = dcell.step_fn(local, cache, toks[-1][:, None], P + i)
        lg.append(logits)
        toks.append(torch.argmax(logits, -1))
    out["decode_counts"] = _counts()
    out.update(logits=torch.stack(lg), tokens=torch.stack(toks, 1),
               cache=_shard_errs([t for _, t in shd.leaves_with_path(cache)],
                                 one["cache"], mesh))
    pcell = steps.build_cell(cfg, ShapeConfig("p", cell_seq(arch), B,
                                              "prefill"), mesh)
    lg_c, cc = pcell.step_fn(local, mine(serve_batch(arch)))
    out["cell_logits"] = lg_c
    out["cell_cache"] = _shard_errs([t for _, t in shd.leaves_with_path(cc)],
                                    one["cell_cache"], mesh)
    return out


def _case(arch: str, shape, one: dict):
    mesh = _mesh(shape)
    if mesh.get_coordinate() is None:
        return None
    cfg = arch_cfg(arch)
    model = TM.build_model(cfg)
    local, specs = steps.shard_params(cfg, arch_params(arch), mesh)
    out = {"param_shapes": [tuple(t.shape) for t in tree_leaves(local)]}
    out.update(_train(arch, mesh, local, specs, model))
    out.update(_serve(arch, mesh, local, specs, model,
                      one[_oracle(shape)]))
    return out


def _oracle(shape) -> str:
    """The one-device serving run a mesh's ranks hold against: each row
    alone where the data axis splits the rows (a data rank computes one
    device's function of its rows: the whole batch's would add the
    rounding of another GEMM shape), else the whole batch."""
    return "rows" if shape[0] > 1 else "whole"


def _all_ranks(t: torch.Tensor) -> list:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t.contiguous())
    return parts


def _port_rank(rank: int, world: int, d: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/store",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        ones = torch.load(f"{d}/one.pt")
        out = {}
        for arch, shape in CASES:
            out[case_name(arch, shape)] = _case(arch, shape, ones[arch])
            dist.barrier()
        for arch in FAMILIES:
            cli = ["--arch", arch, "--smoke", "--device", "cpu", "--mesh",
                   "2x2"]
            losses = ttrain.main(cli + ["--steps", "2", "--seq-len", "32",
                                        "--global-batch", "2",
                                        "--log-every", "1"])
            toks = tserve.main(cli + ["--batch", "2", "--prompt-len", "32",
                                      "--gen", "4"])
            out["cli/" + arch] = {"losses": losses, "tokens": [
                t.clone() for t in _all_ranks(toks)]}
        torch.save(out, f"{d}/rank{rank}.pt")
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

def _flat_ref(tree, prefix: str) -> dict:
    import jax
    return {prefix + jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("rec_mesh")
    ones = {arch: one_rank(arch) for arch in ARCHS}
    torch.save(ones, d / "one.pt")
    inputs = {"gen": np.asarray(GEN)}
    cases = {}
    for arch, shape in REF_CASES:
        name = case_name(arch, shape)
        cases[name] = (*ARCHS[arch], shape, cell_seq(arch), max_len(arch),
                       GEN)
        inputs.update({name + "/p" + k: v
                       for k, v in ref_params(arch).items()})
        for k, v in train_batch(arch).items():
            inputs[f"{name}/train/{k}"] = v
        for k, v in serve_batch(arch).items():
            inputs[f"{name}/serve/{k}"] = v.numpy().astype(
                np.int32 if k == "tokens" else np.float32)
        inputs[name + "/greedy"] = ones[arch]["whole"]["tokens"].numpy(
        ).astype(np.int32)
    inputs["cases"] = np.array(cases, dtype=object)
    np.savez(d / "ref_inputs.npz", **inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(REPO / "src"))
    proc = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, str(d)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        _spawn(_port_rank, (WORLD, str(d)), WORLD, TIMEOUT)
    finally:
        try:
            stdout, stderr = proc.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
    assert proc.returncode == 0, stdout + "\n" + stderr
    return {"one": ones, "ref": dict(np.load(d / "ref.npz")),
            "port": [torch.load(d / f"rank{r}.pt") for r in range(WORLD)]}


def on_mesh(runs, arch, shape) -> list:
    """(rank, its record) of the ranks of the case's mesh."""
    name = case_name(arch, shape)
    return [(r, p[name]) for r, p in enumerate(runs["port"])
            if p[name] is not None]


def _paths(arch: str) -> list:
    return ["/".join(p) for p, _ in shd.leaves_with_path(arch_params(arch))]


# ---------------------------------------------------------------------------
# the widths trip the rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(ARCHS))
def test_the_test_widths_split_what_full_width_splits(arch):
    """At (1, 2) the test configs' params and caches take the layouts
    the rules give the FULL configs: the RG-LRU's matrices by rows and
    its state by width; the mLSTM's heads, its gate weights on d, C and n
    on their key dimension; the sLSTM's gate weights on d and its state
    on head_dim; whisper's frontend on d and ``enc_kv`` by sequence (the
    self cache whole).  The variants on their meshes: the RG-LRU's width
    split with its matrices whole; 6 heads whole on (1, 4) beside their
    split gate weights and states."""
    shape = dict(CASES)[arch] if arch not in FAMILIES else (1, 2)
    mesh = {"data": shape[0], "model": shape[1]}
    cfg = arch_cfg(arch)
    model = TM.build_model(cfg)
    specs = {"/".join(p): tuple(s) for p, s in shd.leaves_with_path(
        shd.param_shardings(model.init(None, "meta"), mesh))}
    cache = model.cache_shape(B, max_len(arch), "meta", **(
        {"enc_len": FRAMES} if cfg.is_encdec else {}))
    cspecs = {"/".join(p): tuple(s) for p, s in shd.leaves_with_path(
        shd.cache_shardings(cache, mesh))}
    if arch == "recurrentgemma-2b":
        mixer = "stack/scanned/0/0/mixer/"
        for w in ("w_gate", "w_x", "w_a", "w_i", "w_out"):
            assert specs[mixer + w] == ("model", None), w
        assert cspecs["scanned/0/0/h"] == (None, "model")
        assert cspecs["scanned/0/0/conv"] == (None, None, "model")
    elif arch == "xlstm-125m":
        m, s_ = "stack/scanned/0/0/mixer/", "stack/scanned/0/1/mixer/"
        assert specs[m + "wq"] == (None, "model", None)
        assert specs[m + "wi"] == ("model", None)
        assert specs[s_ + "wz"] == specs[s_ + "wo"] == ("model", None, None)
        assert cspecs["scanned/0/0/C"] == (None, None, "model", None)
        assert cspecs["scanned/0/0/n"] == (None, None, "model")
        assert cspecs["scanned/0/1/c"] == (None, None, "model")
    elif arch == "whisper-large-v3":
        assert specs["frontend_proj"] == (None, "model")
        assert cspecs["enc_kv/0"][2] == ("data", "model")
        assert cspecs["self/k"] == (None,) * 5
    elif arch == "recurrentgemma-2b-w256":
        assert specs["stack/scanned/0/0/mixer/w_x"] == (None, None)
        assert cspecs["scanned/0/0/h"] == (None, "model")
    else:
        m, s_ = "stack/scanned/0/0/mixer/", "stack/scanned/0/1/mixer/"
        assert specs[m + "wq"] == (None,) * 3
        assert specs[m + "wi"] == ("model", None)
        assert specs[s_ + "wz"] == ("model", None, None)
        assert cspecs["scanned/0/0/C"] == (None, None, "model", None)
        assert cspecs["scanned/0/1/c"] == (None, None, "model")


# ---------------------------------------------------------------------------
# against one rank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_mesh_train_matches_one_rank(runs, arch, shape):
    """The loss ≤ 1e-5 (relative) and every gradient, gathered back,
    ≤ 1e-4 scale-normalized of one rank's (on the first rank; every other
    rank gathers the same bits); each rank's gradient shards have its
    parameter shards' shapes."""
    one = runs["one"][arch]
    paths = _paths(arch)
    (r0, first), *rest = on_mesh(runs, arch, shape)
    for p, a, b in zip(paths, first["grads"], one["grads"]):
        assert scaled(a, b) <= TOL_GRAD, (r0, p, scaled(a, b))
    for r, got in [(r0, first)] + rest:
        assert abs(got["loss"] - one["loss"]) <= TOL * abs(one["loss"]), r
        assert got["grad_shapes"] == got["param_shapes"], r
        assert all(torch.equal(a, b) for a, b in zip(got["grads"],
                                                     first["grads"])), r


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_param_shards_follow_param_pspec(runs, arch, shape):
    """Each rank's parameter shards have the shapes of ``local_shard`` of
    the whole params under ``param_pspec`` on its mesh."""
    mesh = {"data": shape[0], "model": shape[1]}
    params = arch_params(arch)
    specs = shd.param_shardings(params, mesh)
    want = []
    for (_, t), (_, s) in zip(shd.leaves_with_path(params),
                              shd.leaves_with_path(specs)):
        shp = list(t.shape)
        for d, axes in enumerate(shd.split_axes(s, t.ndim, mesh)):
            shp[d] //= math.prod(mesh[a] for a in axes)
        want.append(tuple(shp))
    for r, got in on_mesh(runs, arch, shape):
        assert got["param_shapes"] == want, r


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_mesh_serving_matches_one_rank(runs, arch, shape):
    """Every rank: the prefill's and each decode step's logits of its rows
    ≤ 1e-5 of one rank's, the same greedy tokens."""
    one = runs["one"][arch][_oracle(shape)]
    assert len(on_mesh(runs, arch, shape)) == math.prod(shape)
    for r, got in on_mesh(runs, arch, shape):
        first, n = got["rows"]
        for i, (a, b) in enumerate(zip(got["logits"],
                                       one["logits"][:, first:first + n])):
            assert scaled(a, b) <= TOL, (r, i, scaled(a, b))
        assert torch.equal(got["tokens"], one["tokens"][first:first + n]), r


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_state_shards_follow_cache_shardings(runs, arch, shape):
    """Each rank's cache after the prefill and after the last decode step
    (recurrent states, local rings, the self cache and ``enc_kv``) is
    ``local_shard`` of the one-rank cache under ``cache_shardings``: the
    same shapes, values ≤ 1e-5."""
    for r, got in on_mesh(runs, arch, shape):
        for when in ("prefill_cache", "cache"):
            for path, same, err in got[when]:
                assert same and err <= TOL, (r, when, path, err)


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_gathered_cache_is_one_ranks(runs, arch, shape):
    """``sharding.gather_cache`` of the prefill's shards, on every rank:
    the whole one-rank cache (its shapes, values ≤ 1e-5)."""
    for r, got in on_mesh(runs, arch, shape):
        for path, same, err in got["gathered_cache"]:
            assert same and err <= TOL, (r, path, err)


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_prefill_cell_matches_one_rank(runs, arch, shape):
    """``build_cell``'s prefill cell on the mesh: its logits and cache
    shards against one rank's prefill of the same length."""
    one = runs["one"][arch][_oracle(shape)]
    for r, got in on_mesh(runs, arch, shape):
        first, n = got["rows"]
        assert scaled(got["cell_logits"],
                      one["cell_logits"][first:first + n]) <= TOL, r
        for path, same, err in got["cell_cache"]:
            assert same and err <= TOL, (r, path, err)


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_collectives_do_not_grow_with_the_sequence(runs, arch, shape):
    """A train step's and a prefill's collectives, counted by kind, are
    the same at S and 2S (whisper: twice the frames and tokens): the
    RG-LRU scan, the mLSTM chunks and the sLSTM steps run on local data,
    their exchanges before and after the loops.  A model axis runs some."""
    for r, got in on_mesh(runs, arch, shape):
        for kind in ("train_counts", "prefill_counts"):
            at_s, at_2s = got[kind]
            assert at_s == at_2s, (r, kind, at_s, at_2s)
            if shape[1] > 1:
                assert sum(at_s.values()) > 0, (r, kind)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", REF_CASES, ids=REF_IDS)
def test_mesh_train_matches_reference(runs, arch, shape):
    """The reference's loss and gradients, jitted with its train cell's
    shardings on the same mesh: the port's mesh loss ≤ 1e-5 and every
    gradient (in the reference's layout) ≤ 1e-4."""
    name = case_name(arch, shape)
    ref = runs["ref"]
    cfg = arch_cfg(arch)
    for r, got in on_mesh(runs, arch, shape):
        want = float(ref[name + "/loss"])
        assert abs(got["loss"] - want) <= TOL * abs(want), (r, got["loss"],
                                                            want)
        grads = _flat_ref(convert.params_to_reference(
            _whole(got["grads"], arch_params(arch)), cfg), "")
        for p, g in grads.items():
            assert scaled(g, ref[name + "/grad" + p]) <= TOL_GRAD, (r, p)
        break


@pytest.mark.parametrize("arch,shape", REF_CASES, ids=REF_IDS)
def test_mesh_serving_matches_reference(runs, arch, shape):
    """The reference's prefill and decode cells, jitted with their own
    shardings on the mesh and teacher-forced with the one-rank greedy
    tokens: every step's logits ≤ 1e-5 of the port's mesh logits (the
    decode steps of xlstm-125m's rows served one a rank ≤ 1e-4:
    ``REF_DECODE_TOL``)."""
    ref = runs["ref"][case_name(arch, shape) + "/logits"]
    tol = REF_DECODE_TOL.get(arch, TOL) if shape[0] > 1 else TOL
    for r, got in on_mesh(runs, arch, shape):
        first, n = got["rows"]
        assert got["logits"].shape[0] == ref.shape[0]
        for i in range(ref.shape[0]):
            err = scaled(got["logits"][i], ref[i][first:first + n])
            assert err <= (TOL if i == 0 else tol), (r, i, err)


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_cli_trains_and_serves_on_a_mesh(runs, arch):
    """``train.py --mesh 2x2`` (SMOKE, bf16) takes two steps with finite
    losses; ``serve.py --mesh 2x2`` gives every rank the same tokens for
    the whole batch."""
    parts = runs["port"][0]["cli/" + arch]["tokens"]
    assert all(torch.equal(parts[0], t) for t in parts[1:])
    for port in runs["port"]:
        cli = port["cli/" + arch]
        assert len(cli["losses"]) == 2 and np.isfinite(cli["losses"]).all()
        assert torch.equal(cli["tokens"][0], parts[0])
    assert tuple(parts[0].shape) == (2, 4)
