"""The port's sharding rules against the reference's (CPU, no devices).

The reference's rules read only ``mesh.shape``, so both sides are asked
about the production meshes — {"data": 16, "model": 16} and {"pod": 2,
"data": 16, "model": 16} — without 256 devices: the port takes the dict,
the reference an object with that ``shape`` (its ``NamedSharding`` is
patched, in this process only, to hand back the ``PartitionSpec``).

- **Params**: for every arch of ``ARCHS`` at FULL size, the port's
  abstract tree (``Model.init`` on ``meta``) against the reference's
  ``jax.eval_shape(model.init)``, with fsdp on and off and the expert
  banks over ('data', 'model') on and off: every port leaf's spec equals
  the reference's for the leaf it belongs to, its first entry dropped
  where the reference stacks layers (``scan_layers`` superblocks, the
  whisper decoder and its ``xattn``); shapes likewise.
- **Batches**: ``batch_pspec`` over a grid of shapes, with and without a
  sequence axis, on the production meshes and small ones.
- **Caches**: ``cache_shardings`` over each arch's SMOKE decode cache at B
  1 and 32 and S 256, 1,024 and 32,768 (the 2e9-byte branch crossed by
  the shapes alone); a per-layer cache leaf against the reference's
  stacked one (first entry dropped, and that entry unsplit); a recurrent
  state's leaf against the reference's through the kept difference C11
  (``c11_state``: the rows over the data axes, not the layer reps).
- **``_opt_shardings``**: each arch's default optimizer state (adamw;
  adafactor for deepseek) and adafactor's on yi-6b against the
  reference's.
- **``build_cell``**: on a (1, 1) mesh, the three kinds of yi-6b's SMOKE
  config: the abstract args materialized and run on the CPU equal
  ``Model.loss`` / ``prefill`` / ``decode_step`` called directly; and
  the cells' in/out specs on a (2, 4) mesh against the reference's
  ``build_cell`` in one subprocess with
  ``XLA_FLAGS=--xla_force_host_platform_device_count=8`` (its own
  timeout, 240 s).
"""
from __future__ import annotations

import copy
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch

from repro import configs as jconfigs
from repro.distributed import sharding as jshd
from repro.launch import steps as jsteps
from repro.models.model import build_model as jbuild
from repro_torch import configs as tconfigs
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import sharding as shd
from repro_torch.launch import steps as tsteps
from repro_torch.models.model import build_model as tbuild

REPO = Path(__file__).resolve().parents[1]
PROD = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16})
SMALL = ({"data": 2, "model": 4}, {"data": 4}, {"data": 1, "model": 1},
         {"pod": 2, "data": 2, "model": 2})


class FakeMesh:
    def __init__(self, shape: dict):
        self.shape = dict(shape)


@pytest.fixture(autouse=True)
def _bare_specs(monkeypatch):
    monkeypatch.setattr(jshd, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jsteps.shd, "NamedSharding",
                        lambda mesh, spec: spec)


def norm(spec) -> tuple:
    """A spec with one-axis tuples as the axis name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else
                 (tuple(e) if isinstance(e, (tuple, list)) else e)
                 for e in spec)


def _jkey(k) -> str:
    return str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))


def ref_leaves(tree) -> dict:
    """{path tuple: leaf} of a reference tree."""
    return {tuple(_jkey(k) for k in p): leaf for p, leaf in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]}


def ref_path(path: tuple, stacked_scanned: bool) -> tuple:
    """The reference leaf a port leaf belongs to, and whether the
    reference stacks it: ``scanned/<rep>/<slot>`` -> ``scanned/<slot>``
    (when the reference stacks the superblocks), ``xattn/<i>`` ->
    ``xattn``."""
    p = list(path)
    if "xattn" in p and p[p.index("xattn") + 1].isdigit():
        i = p.index("xattn")
        return tuple(p[:i + 1] + p[i + 2:]), True
    if "scanned" in p and stacked_scanned:
        i = p.index("scanned")
        return tuple(p[:i + 1] + p[i + 2:]), True
    return tuple(p), False


def _stacks(cfg, path) -> bool:
    """Does the reference stack the superblocks this path lies in?"""
    if cfg.is_encdec and ("encoder" in path or "decoder" in path):
        return "decoder" in path or cfg.scan_layers
    return cfg.scan_layers


def c11_state(want: tuple, stacked: bool, shape: tuple, mesh) -> tuple:
    """The port's spec of a recurrent state leaf of ``shape`` from the
    reference's (ROADMAP C11): the reference's stacked first entry (the
    layer reps, which it may put on the data axes) dropped; the data axes
    taken off every dimension and put on the rows where ``batch_pspec``
    splits a batch of that many; ``model`` where the reference puts it,
    and on the widest of the other dimensions where the reference's data
    axes took it (a batch of one) and ``model`` fits it from 128 on."""
    want = list(want[1:] if stacked else want)
    data = set(shd.data_axes(mesh))
    took = [d for d, e in enumerate(want)
            if d and data & set(shd._entry_axes(e))]
    out = []
    for e in want:
        axes = tuple(a for a in shd._entry_axes(e) if a not in data)
        out.append(axes[0] if len(axes) == 1 else (axes or None))
    rows = shd.batch_pspec((shape[0],), mesh)[0]
    out[0] = norm((rows,))[0] if shape[0] > 1 and rows is not None \
        and math.prod(mesh[a] for a in shd._entry_axes(rows)) > 1 else None
    widest = max(range(1, len(shape)), key=lambda d: shape[d])
    if widest in took and shape[widest] >= 128 \
            and shape[widest] % mesh.get("model", 1) == 0 \
            and mesh.get("model", 1) > 1:
        out[widest] = "model"
    return tuple(out)


def compare(port_tree, ref_tree, cfg, port_shapes=None, ref_shapes=None,
            mesh=None):
    """Every port leaf's spec against its reference leaf's (first entry
    dropped where stacked; a recurrent state's through ``c11_state`` on
    ``mesh``); the shapes too when given."""
    ref = ref_leaves(ref_tree)
    rshape = ref_leaves(ref_shapes) if ref_shapes is not None else None
    pshape = dict(shd.leaves_with_path(port_shapes)) \
        if port_shapes is not None else None
    n = 0
    for path, spec in shd.leaves_with_path(port_tree):
        rp, stacked = ref_path(path, _stacks(cfg, path))
        assert rp in ref, (path, rp)
        want = norm(ref[rp])
        if mesh is not None and shd._is_state(path):
            want = c11_state(want, stacked and bool(want),
                             tuple(pshape[path].shape), mesh)
        elif stacked and want:
            assert want[0] is None, (path, want)
            want = want[1:]
        assert norm(spec) == want, (path, norm(spec), want)
        if rshape is not None:
            rs = tuple(rshape[rp].shape)
            ps = tuple(pshape[path].shape)
            assert (rs[1:] if stacked else rs) == ps, (path, rs, ps)
        n += 1
    return n


@pytest.fixture(scope="module")
def abstract():
    out = {}
    for arch in tconfigs.ARCHS:
        jm = jbuild(jconfigs.get_config(arch))
        out[arch] = (
            tbuild(tconfigs.get_config(arch)).init(None, "meta"),
            jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0))))
    return out


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_param_specs_match_reference(abstract, arch):
    cfg = tconfigs.get_config(arch)
    tparams, jparams = abstract[arch]
    for mesh in PROD:
        for fsdp in (False, True):
            for ep in (False, True):
                got = shd.param_shardings(tparams, mesh, fsdp=fsdp,
                                          moe_ep2d=ep)
                want = jshd.param_shardings(jparams, FakeMesh(mesh),
                                            fsdp=fsdp, moe_ep2d=ep)
                n = compare(got, want, cfg, tparams, jparams)
                assert n == len(shd.leaves_with_path(tparams))


def test_whisper_xattn_is_per_layer_in_the_port():
    """The port's ``xattn`` leaves have no layers dimension: their specs
    start at the weight's first dimension (the reference's rule, applied
    to the port's list of per-layer dicts, would skip it)."""
    assert not shd._is_stacked(["xattn", "3", "xattn", "wq"])
    assert shd.param_pspec("xattn/3/xattn/wq", (1280, 20, 64), PROD[0],
                           fsdp=True) == ("data", None, None)
    assert shd._is_stacked(["stack", "scanned", "0", "mixer", "wq"])
    assert not shd._is_stacked(["stack", "scanned", "2", "0", "mixer",
                                "wq"])


BATCH_SHAPES = [(b, s) for b in (1, 2, 3, 16, 32, 64, 256, 512)
                for s in (1, 1024, 4096, 524_288)] + [(32, 1024, 1280), ()]


@pytest.mark.parametrize("mesh", PROD + SMALL, ids=lambda m: "x".join(
    f"{k}{v}" for k, v in m.items()))
def test_batch_specs_match_reference(mesh):
    for shape in BATCH_SHAPES:
        for seq_axis in (None, 1):
            got = shd.batch_pspec(shape, mesh, seq_axis=seq_axis)
            want = jshd.batch_pspec(shape, FakeMesh(mesh), seq_axis=seq_axis)
            assert norm(got) == norm(want), (shape, seq_axis, got, want)
    batch = {"tokens": torch.empty((32, 128), device="meta"),
             "labels": torch.empty((32, 128), device="meta")}
    assert shd.batch_shardings(batch, mesh) == {
        k: shd.batch_pspec((32, 128), mesh) for k in batch}


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_cache_specs_match_reference(arch):
    tcfg, jcfg = tconfigs.get_smoke(arch), jconfigs.get_smoke(arch)
    tm, jm = tbuild(tcfg), jbuild(jcfg)
    for B in (1, 32):
        for S in (256, 1024, 32_768):
            if tcfg.is_encdec:
                tc = tm.cache_shape(B, 448, "meta", enc_len=S)
                jc = jax.eval_shape(lambda: jm.cache_shape(B, 448, S))
            else:
                tc = tm.cache_shape(B, S, "meta")
                jc = jax.eval_shape(lambda: jm.cache_shape(B, S))
            for mesh in PROD + SMALL[:1]:
                got = shd.cache_shardings(tc, mesh)
                want = jshd.cache_shardings(jc, FakeMesh(mesh))
                compare(got, want, tcfg, tc, jc, mesh)


def test_full_caches_cross_the_byte_branch():
    """At FULL size, B 32 and S 32,768 a stacked k/v cache is over 2e9
    bytes a data rank where its kv heads do not divide ``model``: its
    sequence goes to ``model``, decided on the stack's bytes for the
    port's per-layer leaves too."""
    crossed = 0
    for arch in tconfigs.ARCHS:
        tcfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
        tm, jm = tbuild(tcfg), jbuild(jcfg)
        if tcfg.is_encdec:
            tc = tm.cache_shape(32, 448, "meta", enc_len=32_768)
            jc = jax.eval_shape(lambda: jm.cache_shape(32, 448, 32_768))
        else:
            tc = tm.cache_shape(32, 32_768, "meta")
            jc = jax.eval_shape(lambda: jm.cache_shape(32, 32_768))
        for mesh in PROD:
            got = shd.cache_shardings(tc, mesh)
            compare(got, shd_ref(jc, mesh), tcfg, tc, jc, mesh)
            crossed += sum(
                1 for path, spec in shd.leaves_with_path(got)
                if path[-1] in ("k", "v") and len(spec) == 4
                and spec[1] == "model")
    assert crossed > 0


def shd_ref(cache, mesh):
    return jshd.cache_shardings(cache, FakeMesh(mesh))


@pytest.mark.parametrize("arch,name", [(a, None) for a in tconfigs.ARCHS]
                         + [("yi-6b", "adafactor")])
def test_opt_specs_match_reference(abstract, arch, name):
    """Each arch's default optimizer (adamw; adafactor for deepseek-v3),
    and adafactor on a dense arch."""
    tcfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    tparams, jparams = abstract[arch]
    if name is None:
        topt = tsteps.default_optimizer(tcfg)
        jopt = jsteps.default_optimizer(jcfg)
    else:
        from repro.optim import make_optimizer as jmake
        from repro_torch.models.model import stacked_layers
        from repro_torch.optim import make_optimizer as tmake
        topt = tmake(name, momentum=False, stacks=lambda p: stacked_layers(
            p, cfg=tcfg))
        jopt = jmake(name, momentum=False)
    assert topt.name == jopt.name
    taopt = topt.init(tparams)
    jaopt = jax.eval_shape(jopt.init, jparams)
    for mesh in PROD:
        tpsh = shd.param_shardings(tparams, mesh, fsdp=tcfg.fsdp)
        jpsh = jshd.param_shardings(jparams, FakeMesh(mesh), fsdp=jcfg.fsdp)
        got = tsteps._opt_shardings(taopt, tparams, tpsh, mesh)
        want = jsteps._opt_shardings(jaopt, jparams, jpsh, FakeMesh(mesh))
        compare(got.inner, want.inner, tcfg)
        assert norm(got.step) == norm(want.step) == ()


# ---------------------------------------------------------------------------
# build_cell
# ---------------------------------------------------------------------------

CELL_SHAPES = {"train": ShapeConfig("t", 64, 4, "train"),
               "prefill": ShapeConfig("p", 64, 2, "prefill"),
               "decode": ShapeConfig("d", 64, 2, "decode")}


def _real(t: torch.Tensor, seed: int, vocab: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    if t.dtype in (torch.int32, torch.int64):
        return torch.randint(0, vocab, tuple(t.shape), generator=g,
                             dtype=t.dtype)
    return torch.randn(tuple(t.shape), generator=g).to(t.dtype)


def test_build_cell_runs_on_one_device():
    cfg = tconfigs.get_smoke("yi-6b")
    mesh = {"data": 1, "model": 1}
    model = tbuild(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    cells = {k: tsteps.build_cell(cfg, s, mesh)
             for k, s in CELL_SHAPES.items()}
    for cell in cells.values():
        leaves = [t for _, t in shd.leaves_with_path(cell.abstract_args)]
        assert all(t.device.type == "meta" for t in leaves)
        assert [tuple(t.shape) for _, t in shd.leaves_with_path(
            cell.abstract_args[0])] == [tuple(t.shape) for _, t in
                                        shd.leaves_with_path(params)]
    # train: the step's loss is Model.loss's on the same params
    cell = cells["train"]
    batch = {k: _real(v, 1, cfg.vocab_size)
             for k, v in cell.abstract_args[2].items()}
    want, _ = model.loss(params, batch)
    p2 = copy.deepcopy(params)
    _, _, met = cell.step_fn(p2, tsteps.default_optimizer(cfg).init(p2),
                             batch)
    assert float(met["loss"]) == float(want)
    # prefill and decode: the model's own entry points
    cell = cells["prefill"]
    batch = {k: _real(v, 2, cfg.vocab_size)
             for k, v in cell.abstract_args[1].items()}
    with torch.no_grad():
        lg, cache = cell.step_fn(params, batch)
        lg2, cache2 = model.prefill(params, batch, 64)
        assert torch.equal(lg, lg2)
        for (_, a), (_, b) in zip(shd.leaves_with_path(cache),
                                  shd.leaves_with_path(cache2)):
            assert torch.equal(a, b)
        dcell = cells["decode"]
        assert [tuple(t.shape) for _, t in shd.leaves_with_path(
            dcell.abstract_args[1])] == [tuple(t.shape) for _, t in
                                         shd.leaves_with_path(cache)]
        tok = _real(dcell.abstract_args[2], 3, cfg.vocab_size)
        out, _ = dcell.step_fn(params, cache, tok, 10)
        want, _ = model.decode_step(params, cache2, tok, 10)
        assert torch.equal(out, want)


def test_serving_cells_refuse_a_larger_mesh():
    """A {name: size} mesh of more than one device gives the serving
    cells' specs only: it has no ranks to run the steps on (they run on a
    ``DeviceMesh``, ``tests/test_torch_serve_mesh.py``)."""
    cfg = tconfigs.get_smoke("yi-6b")
    for kind in ("prefill", "decode"):
        cell = tsteps.build_cell(cfg, CELL_SHAPES[kind],
                                 {"data": 2, "model": 4})
        with pytest.raises(ValueError, match="specs only"):
            cell.step_fn(*cell.abstract_args)


REF_CELLS = r'''
import json, sys
import jax
from jax.sharding import PartitionSpec
from repro.configs import get_smoke
from repro.configs.base import ShapeConfig
from repro.launch.mesh import make_mesh
from repro.launch.steps import build_cell
assert len(jax.devices()) == 8
mesh = make_mesh((2, 4), ("data", "model"))
out = {}
for kind, (name, S, B) in json.loads(sys.argv[1]).items():
    with mesh:
        cell = build_cell(get_smoke("yi-6b"), ShapeConfig(name, S, B, kind),
                          mesh)
    def dump(tree):
        flat = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.Sharding))[0]
        return [[[str(getattr(k, "key", getattr(k, "idx", getattr(
            k, "name", k)))) for k in p],
                 [list(e) if isinstance(e, tuple) else e for e in s.spec]]
                for p, s in flat]
    out[kind] = {"in": dump(cell.in_shardings),
                 "out": dump(cell.out_shardings)}
print(json.dumps(out))
'''


def test_build_cell_specs_match_reference_on_2x4():
    shapes = {k: (s.name, s.seq_len, s.global_batch)
              for k, s in CELL_SHAPES.items()}
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", REF_CELLS,
                           json.dumps(shapes)], env=env, capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + "\n" + proc.stderr
    ref = json.loads(proc.stdout.strip().splitlines()[-1])
    cfg = tconfigs.get_smoke("yi-6b")
    mesh = {"data": 2, "model": 4}
    for kind, shape in CELL_SHAPES.items():
        cell = tsteps.build_cell(cfg, shape, mesh)
        for side, tree in (("in", cell.in_shardings),
                           ("out", cell.out_shardings)):
            want = {tuple(p): tuple(tuple(e) if isinstance(e, list) else e
                                    for e in s) for p, s in ref[kind][side]}
            got = dict(shd.leaves_with_path(tree))
            n = 0
            for path, spec in got.items():
                rp, stacked = ref_path(path, _stacks(cfg, path))
                key = _ref_key(rp, want)
                w = norm(want[key])
                if stacked and w:
                    assert w[0] is None
                    w = w[1:]
                assert norm(spec) == w, (kind, side, path, spec, w)
                n += 1
            assert n == len(got)


def _ref_key(rp: tuple, want: dict) -> tuple:
    """The reference's dump keys the top tuple by index ("0", "1", ...),
    the port by position too; NamedTuple fields by name."""
    if rp in want:
        return rp
    for k in want:
        if tuple(x.lstrip(".") for x in k) == rp:
            return k
    raise KeyError(rp)


# ---------------------------------------------------------------------------
# placements, local shards, the ambient mesh
# ---------------------------------------------------------------------------

def test_placements_follow_the_spec_row_major():
    from torch.distributed.tensor import Replicate, Shard
    mesh = {"pod": 2, "data": 2, "model": 4}
    assert shd.placements(("data", "model", None), mesh) == [
        Replicate(), Shard(0), Shard(1)]
    assert shd.placements((("data", "model"), None, None), mesh) == [
        Replicate(), Shard(0), Shard(0)]
    assert shd.placements((), mesh) == [Replicate()] * 3
    with pytest.raises(ValueError):
        shd.placements((("model", "data"),), mesh)


def test_ambient_mesh_and_constrain_off_a_mesh():
    x = torch.arange(12.).reshape(3, 4)
    assert shd.ambient_mesh() is None and not shd.mesh_active()
    assert shd.ambient_axis_size("model") == 1
    assert shd.constrain(x, (None, "model")) is x
    with shd.use_mesh({"data": 2, "model": 4}):
        assert shd.ambient_axis_size("model") == 4
        assert shd.ambient_axis_size(("data", "model")) == 8
        assert shd.mesh_active()
    with shd.use_mesh({"data": 1, "model": 1}):
        assert not shd.mesh_active()
        assert shd.constrain(x, (None, "model")) is x
    assert shd.ambient_mesh() is None
