"""The port's prefill and decode on a device mesh (CPU): against one rank
and against the reference's sharded serving cells.

Port side: 4 gloo ranks (``torch.multiprocessing`` spawn, a ``file://``
store in a temp dir) form ("data", "model") meshes (2, 2), (1, 4) and
(1, 2) and
serve, once for the module, every case of ``CASES``: SMOKE configs in f32
with a cache of more than 1,024 positions, so that ``cache_shardings``
really splits the sequence:

- yi-6b (8 heads over 2 kv heads) on (2, 2) with B = 1 (the cache split by
  sequence over (data, model), K/V computed split by heads: one
  heads-to-sequence all-to-all), on (1, 4) with B = 2 (split by sequence;
  ``wk`` replicated at model = 4) and on (2, 2) with B = 2 (split by batch
  and kv heads), also with ``fsdp`` (each block's weights gathered over
  ``data`` on use);
- the reference's sequence-parallel test config (6 heads on model = 4);
- gemma3-12b with ``window=1024`` on (1, 4) (the local rings split by
  slots, the global caches by positions; a 1,016-token prompt leaves ring
  slots empty and the decode wraps the ring), and with landmark decode on
  (2, 2) under explicit draws (each ``model`` rank builds its kv head's
  factors, all-gathered) and, at B = 2 (the rows split over ``data``),
  with the draws of a seeded generator (every rank draws those of the
  whole batch in one device's order and reads its rows' and heads');
- qwen2-moe-a2.7b: the gather path on (1, 4) (B = 1; the expert FFN width
  split) and on (2, 2) (B = 2: the experts split, the capacity of the
  global batch, 1 token a rank at decode), and expert parallelism on
  (2, 2) (8 experts over (data, model), B = 4, nothing dropped);
- on (1, 2), a mesh of the first two ranks: gemma3-12b with landmark
  decode (each rank builds half the heads' factors) and qwen2-moe (the
  experts split), as the card runs them;
- deepseek-v3 (MLA over heads, its latent cache under the reference's
  layout): absorbed decode on (2, 2) with B = 1 (the latent split by
  sequence over (data, model), the partial reads merged by log-sum-exp)
  and with B = 2 and ``fsdp`` (by batch over ``data``, by sequence over
  ``model``), materialized decode on (1, 4) (the slices all-gathered), and
  a 240-token prompt on (1, 4) whose latent is not split; and under
  ``seq_parallel_attn`` on (1, 3), a mesh of the first three ranks (4
  heads do not divide ``model``): each rank projects 342 of the 1,026
  prompt rows, the latent gathered, and attends them against the keys up
  to its last row; the first layer's latent shards ≤ 1e-6 of one rank's,
  each case's exchanges counted.

For each case: ``Model.prefill`` under ``use_mesh`` to ``max_len`` = prompt
+ 16, then 15 greedy steps through ``build_cell``'s decode cell; the
prefill cell at the prompt's length.  Against the same on one rank (in
this process): every step's logits ≤ 1e-5 scale-normalized, the greedy
tokens identical, and each rank's cache shard (of the prefill, of the
prefill cell and after the last step) equal to ``local_shard`` of the
one-rank cache under ``cache_shardings`` (≤ 1e-5).  The CLI on (2, 2)
gives every rank the same tokens (gemma3 and deepseek).

Reference side: one subprocess sees 4 CPU devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``) and, for each
case without landmark decode but deepseek's fsdp one (``ONE_RANK_ONLY``),
jits the reference's prefill (to
``max_len``) with its prefill cell's in specs and its decode cell's cache
specs as the out specs, and its decode cell with that cell's own in/out
specs, on the weights ``convert.params_to_reference`` gives, teacher-forced
with the one-rank greedy tokens: the port's mesh logits ≤ 1e-5 of its.
The spawn and the subprocess run at once, each with its own timeout
(240 s), and the gloo group a 120 s one.
"""
from __future__ import annotations

import dataclasses
import datetime
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
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as shd
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT = 240
TOL = 1e-5
GEN = 16
SP = dict(name="t", family="dense", n_layers=2, d_model=48, n_heads=6,
          n_kv_heads=2, head_dim=8, d_ff=96, vocab_size=64, dtype="float32",
          seq_parallel_attn=True)
EP = {"moe_impl": "shard_map", "n_experts": 8, "capacity_factor": 8.0}
#: name: (arch, config changes, mesh, batch, prompt length)
CASES = {
    "yi-2x2-b1": ("yi-6b", {}, (2, 2), 1, 1024),
    "yi-1x4-b2": ("yi-6b", {}, (1, 4), 2, 1024),
    "yi-2x2-b2": ("yi-6b", {}, (2, 2), 2, 1024),
    "yi-2x2-b2-fsdp": ("yi-6b", {"fsdp": True}, (2, 2), 2, 1024),
    "sp-1x4-b2": ("sp", {}, (1, 4), 2, 1024),
    "gemma3-1x4-window": ("gemma3-12b", {"window": 1024}, (1, 4), 1, 1016),
    "gemma3-2x2-landmark": ("gemma3-12b", {"window": 1024,
                                           "use_landmark_decode": True},
                            (2, 2), 1, 1016),
    "qwen2moe-1x4-tp": ("qwen2-moe-a2.7b", {}, (1, 4), 1, 1024),
    "qwen2moe-2x2-b2": ("qwen2-moe-a2.7b", {}, (2, 2), 2, 1024),
    "qwen2moe-2x2-ep": ("qwen2-moe-a2.7b", EP, (2, 2), 4, 1024),
    "gemma3-1x2-landmark": ("gemma3-12b", {"window": 1024,
                                           "use_landmark_decode": True},
                            (1, 2), 1, 1016),
    "qwen2moe-1x2": ("qwen2-moe-a2.7b", {}, (1, 2), 1, 1024),
    "gemma3-2x2-b2-generator": ("gemma3-12b", {"window": 1024,
                                               "use_landmark_decode": True},
                                (2, 2), 2, 1016),
    "deepseek-2x2-b1": ("deepseek-v3-671b", {}, (2, 2), 1, 1024),
    "deepseek-2x2-b2-fsdp": ("deepseek-v3-671b", {"fsdp": True}, (2, 2), 2,
                             1024),
    "deepseek-1x4-materialized": ("deepseek-v3-671b", {"mla_absorb": False},
                                  (1, 4), 1, 1024),
    "deepseek-1x4-b2-short": ("deepseek-v3-671b", {}, (1, 4), 2, 240),
    "deepseek-sp-1x3": ("deepseek-v3-671b", {"seq_parallel_attn": True},
                        (1, 3), 1, 1026),
}
#: cases whose landmark draws come from a generator, not given
GENERATOR = {"gemma3-2x2-b2-generator"}
#: cases held to one rank only: the reference's jitted cells are the
#: module's slowest part.  deepseek's three latent layouts (the merged
#: absorbed read, the materialized read, the latent not split) are held
#: to the reference; this case reads with the merged read's code over
#: other axes
ONE_RANK_ONLY = {"deepseek-2x2-b2-fsdp"}
NO_LANDMARK = [n for n, c in CASES.items()
               if not c[1].get("use_landmark_decode")]
REF_CASES = [n for n in NO_LANDMARK if n not in ONE_RANK_ONLY]
CELL_CASES = NO_LANDMARK + sorted(GENERATOR)
CLI = ["--arch", "gemma3-12b", "--smoke", "--landmark", "--device", "cpu",
       "--batch", "2", "--prompt-len", "32", "--gen", "6"]
DS_CLI = ["--arch", "deepseek-v3-671b", "--smoke", "--device", "cpu",
          "--batch", "2", "--prompt-len", "32", "--gen", "6"]

REF_SCRIPT = r'''
import dataclasses, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_smoke
from repro.configs.base import ModelConfig, ShapeConfig
from repro.launch.steps import build_cell

assert len(jax.devices()) == 4, jax.devices()
d = sys.argv[1]
inp = dict(np.load(d + "/ref_inputs.npz", allow_pickle=True))
cases = inp.pop("cases").item()
out = {}
for name, (arch, kw, shape, B, S) in cases.items():
    cfg = ModelConfig(**kw) if arch == "sp" else dataclasses.replace(
        get_smoke(arch), dtype="float32", **kw)
    # Auto axes: the reference's GSPMD cells (jax 0.9 makes Explicit ones)
    mesh = jax.make_mesh(tuple(shape), ("data", "model"),
                         devices=jax.devices()[:shape[0] * shape[1]],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    max_len = S + int(inp["gen"])
    with mesh:
        pcell = build_cell(cfg, ShapeConfig("p", S, B, "prefill"), mesh)
        dcell = build_cell(cfg, ShapeConfig("d", max_len, B, "decode"),
                           mesh)
        model = dcell.model
        shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        paths = [jax.tree_util.keystr(p) for p, _ in
                 jax.tree_util.tree_flatten_with_path(shapes)[0]]
        params = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(shapes),
            [jnp.asarray(inp[name + "/p" + p]) for p in paths])
        prefill = jax.jit(
            lambda p, b: model.prefill(p, b, jax.random.PRNGKey(0), max_len),
            in_shardings=pcell.in_shardings,
            out_shardings=(pcell.out_shardings[0], dcell.in_shardings[1]))
        decode = jax.jit(dcell.step_fn, in_shardings=dcell.in_shardings,
                         out_shardings=dcell.out_shardings)
        logits, cache = prefill(params,
                                {"tokens": jnp.asarray(inp[name + "/tokens"])})
        got = [np.asarray(logits)]
        toks = inp[name + "/greedy"]
        for i in range(toks.shape[1] - 1):
            logits, cache = decode(params, cache,
                                   jnp.asarray(toks[:, i:i + 1], jnp.int32),
                                   jnp.asarray(S + i, jnp.int32))
            got.append(np.asarray(logits))
    out[name] = np.stack(got)
np.savez(d + "/ref.npz", **out)
'''


# ---------------------------------------------------------------------------
# inputs shared by every side
# ---------------------------------------------------------------------------

def case_cfg(name: str) -> ModelConfig:
    arch, kw = CASES[name][:2]
    if arch == "sp":
        return ModelConfig(**SP)
    return dataclasses.replace(get_smoke(arch), dtype="float32", **kw)


def case_params(name: str) -> dict:
    cfg = case_cfg(name)
    return TM.build_model(cfg).init(torch.Generator().manual_seed(5), "cpu")


def case_tokens(name: str) -> torch.Tensor:
    _, _, _, B, S = CASES[name]
    rng = np.random.default_rng(6)
    return torch.as_tensor(rng.integers(0, case_cfg(name).vocab_size,
                                        size=(B, S)))


def case_draws(name: str):
    """Explicit landmark draws of every global layer, (B, KV, ·) each."""
    cfg = case_cfg(name)
    if not cfg.use_landmark_decode or name in GENERATOR:
        return None
    _, _, _, B, S = CASES[name]
    c, s = cfg.landmark_c, cfg.landmark_theta * cfg.landmark_c
    rng = np.random.default_rng(7)
    draws = {}
    for n, (_, _, _, kind) in enumerate(TT.layer_slots(cfg)):
        if kind != "global":
            continue
        p_idx = np.empty((B, cfg.n_kv_heads, c), np.int64)
        skx = np.empty((B, cfg.n_kv_heads, s), np.int64)
        for b in range(B):
            for h in range(cfg.n_kv_heads):
                perm = rng.permutation(S)
                p_idx[b, h], skx[b, h] = perm[:c], perm[:s]
        draws[n] = {"p_idx": torch.as_tensor(p_idx),
                    "skx": torch.as_tensor(skx)}
    return draws


def case_generator(name: str):
    """The generator a case's landmark layers draw from, if it is one of
    ``GENERATOR`` (one for the whole prefill: the layers draw in turn)."""
    return torch.Generator().manual_seed(2) if name in GENERATOR else None


@torch.no_grad()
def one_rank(name: str) -> dict:
    """Prefill to max_len, GEN - 1 greedy steps, and the prefill at the
    prompt's length, on one device."""
    cfg = case_cfg(name)
    _, _, _, B, S = CASES[name]
    model, params = TM.build_model(cfg), case_params(name)
    batch = {"tokens": case_tokens(name)}
    logits, cache = model.prefill(params, batch, S + GEN,
                                  landmark_draws=case_draws(name),
                                  generator=case_generator(name))
    prefill_cache = [t.clone() for _, t in shd.leaves_with_path(cache)]
    steps_ = [logits]
    tok = torch.argmax(logits, -1)
    toks = [tok]
    for i in range(GEN - 1):
        logits, cache = model.decode_step(params, cache, tok[:, None], S + i)
        steps_.append(logits)
        tok = torch.argmax(logits, -1)
        toks.append(tok)
    lg_s, cache_s = model.prefill(params, batch, S,
                                  landmark_draws=case_draws(name))
    return {"logits": torch.stack(steps_), "tokens": torch.stack(toks, 1),
            "prefill_cache": prefill_cache, "cache": cache,
            "cell_logits": lg_s, "cell_cache": cache_s}


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def on_mesh(runs, name) -> list:
    """(rank, its record) of the ranks of the case's mesh."""
    return [(r, p[name]) for r, p in enumerate(runs["port"])
            if p[name] is not None]


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


def _mesh(shape):
    """A ("data", "model") mesh over the first ranks of the world; every
    rank builds it (its groups), a rank outside has no coordinate."""
    if shape[0] * shape[1] == WORLD:
        return make_mesh(shape, ("data", "model"), "cpu")
    return DeviceMesh("cpu", torch.arange(shape[0] * shape[1]).reshape(
        shape), mesh_dim_names=("data", "model"))


@torch.no_grad()
def _serve_case(name: str, one: dict):
    arch, _, shape, B, S = CASES[name]
    cfg = case_cfg(name)
    mesh = _mesh(shape)
    if mesh.get_coordinate() is None:
        return None
    model = TM.build_model(cfg)
    local, specs = steps.shard_params(cfg, case_params(name), mesh)
    first, n = shd.local_range((shd.row_axes(B, mesh),), 0, B, mesh)
    tokens = case_tokens(name)[first:first + n]
    C.reset_stats()
    attend, shapes = TA.mla_attend_full, []

    def spy(params, cfg_, q_nope, q_rope, ckv, k_rope):
        shapes.append((int(q_nope.shape[1]), int(ckv.shape[1])))
        return attend(params, cfg_, q_nope, q_rope, ckv, k_rope)
    TA.mla_attend_full = spy
    try:
        with shd.use_mesh(mesh):
            logits, cache = model.prefill(shd.mesh_view(local, specs),
                                          {"tokens": tokens}, S + GEN,
                                          landmark_draws=case_draws(name),
                                          generator=case_generator(name),
                                          global_batch=B)
    finally:
        TA.mla_attend_full = attend
    whole = _whole(one["prefill_cache"], one["cache"])
    out = {"rows": (first, n), "prefill_stats": dict(C.STATS),
           "mla_attend": shapes, "coord": [int(c) for c in
                                           mesh.get_coordinate()],
           "prefill_cache": _shard_errs(
               [t for _, t in shd.leaves_with_path(cache)], whole, mesh),
           "gathered_cache": [
               ("/".join(path), tuple(a.shape) == tuple(b.shape),
                scaled(a, b) if tuple(a.shape) == tuple(b.shape)
                else float("inf"))
               for (path, a), (_, b) in zip(
                   shd.leaves_with_path(shd.gather_cache(cache, mesh)),
                   shd.leaves_with_path(whole))]}
    dcell = steps.build_cell(cfg, ShapeConfig("d", S + GEN, B, "decode"),
                             mesh)
    # the one-rank cache laid out by ``shard_cache``: gathered back bit for
    # bit, and a decode step from it gives the one-rank step's logits
    mine = shd.shard_cache(_whole([t.clone() for t in one["prefill_cache"]],
                                  one["cache"]), mesh)
    out["roundtrip"] = all(torch.equal(a, b) for (_, a), b in zip(
        shd.leaves_with_path(shd.gather_cache(mine, mesh)),
        one["prefill_cache"]))
    tok0 = one["tokens"][first:first + n, 0]
    with shd.use_mesh(mesh):
        out["from_sharded"] = model.decode_step(
            shd.mesh_view(local, specs), mine, tok0[:, None], S)[0]
    steps_, toks = [logits], [torch.argmax(logits, -1)]
    C.reset_stats()
    for i in range(GEN - 1):
        logits, cache = dcell.step_fn(local, cache, toks[-1][:, None], S + i)
        steps_.append(logits)
        toks.append(torch.argmax(logits, -1))
    out["decode_stats"] = {k: {"count": v["count"] / (GEN - 1),
                               "bytes": v["bytes"] / (GEN - 1)}
                           for k, v in C.STATS.items()}
    out["logits"] = torch.stack(steps_)
    out["tokens"] = torch.stack(toks, 1)
    out["cache"] = _shard_errs([t for _, t in shd.leaves_with_path(cache)],
                               one["cache"], mesh)
    pcell = steps.build_cell(cfg, ShapeConfig("p", S, B, "prefill"), mesh)
    if name not in CELL_CASES:         # the cell takes no explicit draws
        lg, cc = None, None
    else:
        lg, cc = pcell.step_fn(local, {"tokens": tokens})
    out["cell_logits"] = lg
    out["cell_cache"] = None if cc is None else _shard_errs(
        [t for _, t in shd.leaves_with_path(cc)], one["cell_cache"], mesh)
    return out


def _whole(leaves, like):
    """The tree of ``like`` with ``leaves`` in its place."""
    it = iter(leaves)
    return shd.map_with_path(lambda _, t: next(it), like)


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
        for name in CASES:
            out[name] = _serve_case(name, ones[name])
            dist.barrier()
        toks = tserve.main(CLI + ["--mesh", "2x2"])
        out["cli"] = [t.clone() for t in _all_ranks(toks)]
        toks = tserve.main(DS_CLI + ["--mesh", "2x2"])
        out["cli_deepseek"] = [t.clone() for t in _all_ranks(toks)]
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
    d = tmp_path_factory.mktemp("serve_mesh")
    ones = {name: one_rank(name) for name in CASES}
    torch.save(ones, d / "one.pt")
    inputs = {"cases": np.array({
        n: (CASES[n][0], SP if CASES[n][0] == "sp" else CASES[n][1],
            CASES[n][2], CASES[n][3], CASES[n][4]) for n in REF_CASES},
        dtype=object), "gen": np.asarray(GEN)}
    for name in REF_CASES:
        cfg = case_cfg(name)
        inputs.update(_flat_ref(convert.params_to_reference(
            case_params(name), cfg), name + "/p"))
        inputs[name + "/tokens"] = case_tokens(name).numpy().astype(np.int32)
        inputs[name + "/greedy"] = ones[name]["tokens"].numpy().astype(
            np.int32)
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
            "port": [torch.load(d / f"rank{r}.pt") for r in range(WORLD)],
            "cli_one": tserve.main(CLI)}


# ---------------------------------------------------------------------------
# against one rank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CASES)
def test_mesh_serving_matches_one_rank(runs, name):
    """Every rank: the prefill's and each decode step's logits of its rows
    (the vocabulary whole) ≤ 1e-5 of one rank's, the same greedy tokens."""
    one = runs["one"][name]
    assert len(on_mesh(runs, name)) == math.prod(CASES[name][2])
    for r, got in on_mesh(runs, name):
        first, n = got["rows"]
        for i, (a, b) in enumerate(zip(got["logits"],
                                       one["logits"][:, first:first + n])):
            assert scaled(a, b) <= TOL, (r, i, scaled(a, b))
        assert torch.equal(got["tokens"],
                           one["tokens"][first:first + n]), r


@pytest.mark.parametrize("name", CASES)
def test_cache_shards_follow_cache_shardings(runs, name):
    """Each rank's cache after the prefill and after the last decode step
    is ``local_shard`` of the one-rank cache under the reference's
    ``cache_shardings`` layout: the same shapes, values ≤ 1e-5."""
    for r, got in on_mesh(runs, name):
        for when in ("prefill_cache", "cache"):
            for path, same, err in got[when]:
                assert same and err <= TOL, (r, when, path, err)


@pytest.mark.parametrize("name", CELL_CASES)
def test_serving_cells_match_one_rank(runs, name):
    """``build_cell``'s prefill cell on the mesh at the prompt's length:
    its logits and cache shards against one rank's prefill there (a
    landmark layer's draws from the default generator on both sides)."""
    one = runs["one"][name]
    for r, got in on_mesh(runs, name):
        first, n = got["rows"]
        assert scaled(got["cell_logits"],
                      one["cell_logits"][first:first + n]) <= TOL, r
        for path, same, err in got["cell_cache"]:
            assert same and err <= TOL, (r, path, err)


@pytest.mark.parametrize("name", CASES)
def test_shard_cache_lays_out_a_whole_cache(runs, name):
    """``sharding.shard_cache`` of the one-rank prefill cache, on every
    rank: ``gather_cache`` gives it back bit for bit, and a decode step
    from it gives the one-rank step's logits (≤ 1e-5)."""
    one = runs["one"][name]
    for r, got in on_mesh(runs, name):
        first, n = got["rows"]
        assert got["roundtrip"], r
        assert scaled(got["from_sharded"],
                      one["logits"][1, first:first + n]) <= TOL, r


@pytest.mark.parametrize("name", CASES)
def test_gathered_cache_is_one_ranks(runs, name):
    """``sharding.gather_cache`` of the prefill's shards, on every rank:
    the whole one-rank cache (its shapes, values ≤ 1e-5)."""
    for r, got in on_mesh(runs, name):
        for path, same, err in got["gathered_cache"]:
            assert same and err <= TOL, (r, path, err)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", REF_CASES)
def test_mesh_serving_matches_reference(runs, name):
    """The reference's prefill and decode cells, jitted with their own
    shardings on the 4-device mesh and teacher-forced with the one-rank
    greedy tokens (the port's, see above): every step's logits."""
    ref = runs["ref"][name]
    for _, got in on_mesh(runs, name):
        first, n = got["rows"]
        assert got["logits"].shape[0] == ref.shape[0]
        for i in range(ref.shape[0]):
            err = scaled(got["logits"][i], ref[i][first:first + n])
            assert err <= TOL, (name, i, err)


# ---------------------------------------------------------------------------
# the paths taken
# ---------------------------------------------------------------------------

def test_the_layouts_take_their_exchanges(runs):
    """K/V split by heads go to a sequence-split cache through one
    all-to-all a layer (yi on (2, 2), B = 1: model = 2 divides the kv
    heads, the batch of 1 puts the sequence on (data, model)); a decode
    step of a sequence-split cache merges its partial reads with one
    all-gather a layer; a batch- and head-split decode gathers only the
    logits' vocabulary."""
    p = runs["port"][0]
    layers = case_cfg("yi-2x2-b1").n_layers
    assert p["yi-2x2-b1"]["prefill_stats"]["all_to_all"]["count"] \
        == 2 * layers                                       # k and v
    assert p["yi-2x2-b1"]["decode_stats"]["all_gather"]["count"] \
        >= layers + 1
    assert "all_to_all" not in p["yi-2x2-b2"]["prefill_stats"]
    assert p["yi-2x2-b2"]["decode_stats"]["all_gather"]["count"] == 1
    assert p["qwen2moe-2x2-ep"]["decode_stats"]["all_to_all"]["count"] \
        == 2 * case_cfg("qwen2moe-2x2-ep").n_layers         # there, back


MLA_CASES = [n for n in CASES if CASES[n][0] == "deepseek-v3-671b"]


@pytest.mark.parametrize("name", MLA_CASES)
def test_mla_latent_shards_are_one_ranks_slices(runs, name):
    """Each rank's ``ckv`` / ``krope`` of the first layer, whose input (the
    embedding) is one rank's bits, after the prefill and after the last
    decode step: ``local_shard`` of one rank's latent cache ≤ 1e-6.  The
    deeper layers' inputs carry the tensor-parallel sums' order (≈ 1e-6 at
    the third layer); ``test_cache_shards_follow_cache_shardings`` holds
    them at 1e-5."""
    for r, got in on_mesh(runs, name):
        for when in ("prefill_cache", "cache"):
            first = [(p, same, err) for p, same, err in got[when]
                     if p.startswith("prefix/0/")]
            assert len(first) == 2, first
            for path, same, err in first:
                assert same and err <= 1e-6, (r, when, path, err)


def test_mla_latent_layouts_take_their_exchanges(runs):
    """deepseek's latent cache: its prefill slice is a narrow (no
    all-to-all: the latent is whole on every ``model`` rank).  A decode
    step all-gathers ql over q_rank in each layer; absorbed over a
    sequence-split latent it also gathers the latent queries of every head
    and merges the partial reads (two more all-gathers a layer);
    materialized, it gathers ckv and krope over the sequence; a latent not
    split reads with no exchange of its own.  One more all-gather brings
    the logits' vocabulary.  (With ``fsdp`` each block's weights are
    gathered too.)"""
    layers = case_cfg("deepseek-2x2-b1").n_layers
    want = {"deepseek-2x2-b1": 3 * layers + 1,
            "deepseek-1x4-materialized": 3 * layers + 1,
            "deepseek-1x4-b2-short": layers + 1}
    for name, n in want.items():
        for r, got in on_mesh(runs, name):
            assert "all_to_all" not in got["prefill_stats"], (name, r)
            assert got["decode_stats"]["all_gather"]["count"] == n, (
                name, r, got["decode_stats"])


def test_cli_serves_the_same_tokens_on_every_rank(runs):
    """``serve.py --mesh 2x2`` (gemma3 SMOKE with landmark decode, bf16):
    every rank returns the same tokens for the whole batch."""
    parts = runs["port"][0]["cli"]
    assert all(torch.equal(parts[0], t) for t in parts[1:])
    for port in runs["port"][1:]:
        assert torch.equal(port["cli"][0], parts[0])
    assert parts[0].shape == runs["cli_one"].shape


def test_cli_serves_deepseek_on_a_mesh(runs):
    """``serve.py --arch deepseek-v3-671b --mesh 2x2`` (bf16 SMOKE): every
    rank returns the same tokens for the whole batch, of one device's
    shape."""
    parts = runs["port"][0]["cli_deepseek"]
    assert all(torch.equal(parts[0], t) for t in parts[1:])
    for port in runs["port"][1:]:
        assert torch.equal(port["cli_deepseek"][0], parts[0])
    assert parts[0].shape == tserve.main(DS_CLI).shape


@pytest.mark.parametrize("name", MLA_CASES)
def test_mla_prefill_splits_query_rows_under_seq_parallel(runs, name):
    """Under ``seq_parallel_attn`` with heads that do not divide ``model``
    each rank's MLA attends its S/3 prompt rows against the keys up to its
    last row (the latent gathered; the prefill and the first layer's
    latent shards held above); over heads every attention takes the whole
    prompt."""
    S = CASES[name][4]
    sp = case_cfg(name).seq_parallel_attn
    for r, got in on_mesh(runs, name):
        rows = S // 3 if sp else S
        end = (got["coord"][1] + 1) * rows if sp else S
        assert got["mla_attend"] and set(got["mla_attend"]) == {
            (rows, end)}, (r, got["mla_attend"])


# ---------------------------------------------------------------------------
# the merge and the layout helpers, on one process
# ---------------------------------------------------------------------------

def test_partial_reads_merge_to_the_whole_read():
    """Keys cut into three parts, the last wholly after ``pos`` (m = −inf,
    l = 0: no NaN), merged by the same log-sum-exp: the one-rank decode
    read ≤ 1e-6."""
    g = torch.Generator().manual_seed(0)
    cfg = dataclasses.replace(get_smoke("yi-6b"), dtype="float32")
    q = torch.randn((2, 1, 8, 16), generator=g)
    k = torch.randn((2, 48, 2, 16), generator=g)
    v = torch.randn((2, 48, 2, 16), generator=g)
    pos = 20
    valid = (torch.arange(48) <= pos)[None]
    want = TA._decode_read(q, k, v, cfg, valid)
    parts = [TA._partial_read(q, k[:, a:a + 16], v[:, a:a + 16],
                              valid[:, a:a + 16]) for a in (0, 16, 32)]
    assert torch.isinf(parts[2][0]).all() and (parts[2][1] == 0).all()
    packed = torch.stack([torch.cat([o, m[..., None], l[..., None]], -1)
                          for m, l, o in parts])
    got = C._lse_combine(packed).reshape(2, 1, 8, 16)
    assert not torch.isnan(got).any()
    assert scaled(got, want) <= 1e-6


def test_local_range_and_row_axes_on_a_dict_mesh():
    """The rows a serving batch splits over and the cache's sequence
    ranges, from the sizes alone."""
    mesh = {"data": 2, "model": 2}
    assert shd.row_axes(1, mesh) == ()
    assert shd.row_axes(2, mesh) == ("data",)
    assert shd.row_axes(3, {"data": 1, "model": 4}) == ()
    spec = shd.cache_shardings({"k": torch.empty((1, 1040, 2, 8),
                                                 device="meta")}, mesh)["k"]
    assert tuple(spec) == (None, ("data", "model"), None, None)
    assert shd.local_range(spec, 2, 2, mesh) == (0, 2)
