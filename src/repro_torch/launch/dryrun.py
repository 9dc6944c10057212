"""Multi-pod dry run: trace every (arch x shape) cell's step on the
production mesh and extract its memory, cost and roofline terms (port of
``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun

Nothing is allocated and no card is needed.  ``fake_world`` starts a
``fake`` process group of the mesh's size in this one process (rank 0)
and builds the ``DeviceMesh`` over it; each cell's step (``build_cell``)
then runs on rank 0's ``meta`` blocks of its arguments
(``steps.local_args``): the model code, its collectives (which move
nothing under the fake backend) and the kernels' custom ops (their fake
kernels give the output's shape).  ``meta`` rather than fake CUDA tensors:
on a build of torch without CUDA a fake CUDA tensor cannot be indexed.
The traced step is rank 0's program, so every number is a device's.
Where the cell's step is the step at accum 1 (prefill, decode, train at
accum 1) one trace at full depth gives them all (``trace_cell``):

- the peak live bytes a device (``roofline.OpRecorder``: the arguments,
  every storage an op makes until it is freed, an in-place update of a
  donated argument counted once), under the reference's
  ``memory_analysis`` keys.  A train step of accum > 1 takes them from a
  trace at its own accum (``memory_trace``: of accum > 2, two of its
  microbatches at their own size and the whole batch's bytes; every
  microbatch after the first holds what the second holds);
- FLOPs (``torch.utils.flop_counter``; the kernels' custom ops carry
  their own formulas), bytes (the recorder's ``hlo_bytes`` and
  ``hbm_bytes``) and collective bytes by kind, of one step at accum 1;
- ``kernels``: the calls of each custom op (``repro_torch::*``) in that
  trace: the hand-written kernels the cell reaches.

A trace counts every pass of a loop, so the reference's two-point
extrapolation over 1 and 2 superblocks (XLA counted a loop body once) is
not needed, and is off where a decode cache's layout depends on the
depth (the byte rule of ``sharding._cache_spec`` reads the stacked
leaf's size).  It stays for xlstm past 2,048 tokens, whose per-token
sLSTM loop makes a direct trace take minutes: there the costs come from
the reference's sequence probe (``extrapolated_costs``) and the memory
from traces at two lengths.

The record keys and file names are the reference's (``kernels`` and
``accum`` added).  ``compile_full_s`` is the seconds of the full-depth
traces here, ``compile_extrap_s`` those of the probe (0 where there is
none), and ``collective_count_per_superblock`` the collectives of the
traced step (of the probe's one-superblock step, as the reference's).
Bytes a device are printed against one H100's 80 GB.  The trace takes
the branches a ``meta`` tensor takes: where the model picks a path by
device type (the sLSTM's CUDA-graph serving loop) it traces the plain
one.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, SHAPES, get_config, shapes_for
from repro_torch.distributed import collectives as C
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import roofline as rl
from repro_torch.launch.steps import (build_cell, decode_position,
                                      default_optimizer, local_args)

#: one H100's device memory, the capacity a cell's bytes a device face
HBM_BYTES = 80e9
#: the sequence probe: its first length, and the lengths past which an
#: sLSTM arch is probed (xlstm)
PROBE_S = 1024
PROBE_PAST = 2048


def scan_reps(cfg) -> int:
    if cfg.is_encdec:
        return cfg.n_enc_layers
    return (cfg.n_layers - cfg.first_k_dense) // len(cfg.layer_pattern)


def _reduced_cfg(cfg, extra_reps: int):
    """Unrolled config with ``extra_reps`` scanned superblocks (prefix and
    remainder kept) — used for the two-point layer-cost extrapolation.
    ``scan_layers`` and ``unroll_scans`` are set as the reference sets
    them (here ``scan_layers`` only decides how adafactor groups the
    layers' statistics)."""
    if cfg.is_encdec:
        return dataclasses.replace(
            cfg, n_layers=extra_reps, n_enc_layers=extra_reps,
            n_dec_layers=extra_reps, scan_layers=False, unroll_scans=True)
    plen = len(cfg.layer_pattern)
    rem = (cfg.n_layers - cfg.first_k_dense) % plen
    nl = cfg.first_k_dense + extra_reps * plen + rem
    return dataclasses.replace(cfg, n_layers=nl, scan_layers=False,
                               unroll_scans=True)


def _parse_override(kv: str):
    k, v = kv.split("=", 1)
    if v in ("True", "False"):
        return k, v == "True"
    try:
        return k, int(v)
    except ValueError:
        pass
    try:
        return k, float(v)
    except ValueError:
        return k, v


# ---------------------------------------------------------------------------
# the fake world
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(spec: str):
    """A ``DeviceMesh`` of ``spec`` ("16x16": data, model; "2x16x16": pod,
    data, model; ``mesh.mesh_dims``) over a ``fake`` process group of its
    size in this process, as rank 0.  On exit the group, the collectives'
    cached groups and ``collectives.STATS`` are as they were.  Inside a
    ``fake`` group of the same size it builds the mesh there and leaves
    the group up; it refuses any other initialized group."""
    dims, axes = mesh_lib.mesh_dims(spec)
    world = math.prod(dims)
    own = not dist.is_initialized()
    if not own and (dist.get_backend() != "fake"
                    or dist.get_world_size() != world):
        raise RuntimeError(
            f"the dry run needs a fake process group of {world} ranks; this "
            f"process has a {dist.get_backend()!r} group of "
            f"{dist.get_world_size()}")
    stats = {k: dict(v) for k, v in C.STATS.items()}
    if own:
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    try:
        yield mesh_lib.make_mesh(dims, axes, device_type="cpu")
    finally:
        C.clear_groups()
        C.STATS.clear()
        C.STATS.update(stats)
        if own:
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# traces
# ---------------------------------------------------------------------------

def trace_step(fn, args, *, count_flops: bool = True) -> dict:
    """Run ``fn(*args)`` (a cell's ``step_fn``) under an ``OpRecorder``
    (and a FLOP counter): the recorder's counts, ``flops`` and
    ``flops_by_op``, and the memory terms (``args_bytes``, ``out_bytes``,
    ``alias_bytes``: the outputs' bytes in an argument's storage).  On
    ``meta`` args a trace; on real ones a run, counted the same way."""
    from torch.utils.flop_counter import FlopCounterMode
    rec = rl.OpRecorder()
    rec.track(args)
    arg_keys = {t.untyped_storage()._cdata for t in rl._tensors(args)}
    fc = FlopCounterMode(display=False) if count_flops else None
    t0 = time.perf_counter()
    with rec, (fc or contextlib.nullcontext()):
        out = fn(*args)
    res = rec.counts()
    res["seconds"] = time.perf_counter() - t0
    res["args_bytes"] = rec.args_bytes
    outs = rl._tensors(out)
    res["out_bytes"] = rec.held_bytes(outs)
    res["alias_bytes"] = rec.held_bytes(
        [t for t in outs if t.untyped_storage()._cdata in arg_keys])
    res["calls"] = dict(rec.calls)
    res["hbm_by_op"] = dict(rec.hbm_by_op)
    if fc is not None:
        res["flops"] = float(fc.get_total_flops())
        res["flops_by_op"] = {str(k): int(v) for k, v in
                              fc.get_flop_counts().get("Global", {}).items()}
    del out
    return res


def _cost_terms(r: dict) -> dict:
    """A trace's cost terms (``trace_step``'s result): the counts
    ``roofline.analyze`` reads, the kernels' calls."""
    return {"flops": r["flops"], "hlo_bytes": r["hlo_bytes"],
            "hbm": r["hbm"], "coll": r["coll"], "n_coll": r["n_coll"],
            "kernels": {k: float(v) for k, v in r["kernels"].items()}}


def _costs(cfg, shape, mesh) -> dict:
    """The cost terms of one step at accum 1, traced at full depth."""
    cell = build_cell(cfg, shape, mesh, accum=1)
    return _cost_terms(trace_step(cell.step_fn, local_args(cell, mesh)))


def _seq_probed(cfg, shape) -> bool:
    """Is the cell traced at ``PROBE_S`` and twice that and its terms
    taken as linear in S (an sLSTM arch past ``PROBE_PAST`` tokens, whose
    per-token loop makes a direct trace take minutes)?"""
    return ("slstm" in cfg.layer_pattern and shape.kind != "decode"
            and shape.seq_len > PROBE_PAST)


def memory_trace(cfg, shape, mesh, accum: Optional[int] = None) -> tuple:
    """(the cell at its own accum, or ``accum``; the reference's
    ``memory_analysis`` dict) from a full-depth trace.  A train step of
    accum A > 2 is traced at accum 2 over 2/A of the batch, so each
    microbatch keeps its size; the rest of the whole batch's bytes (an
    argument, alive throughout) is added back to the arguments and the
    peak.  An sLSTM arch past ``PROBE_PAST`` tokens is traced at
    ``PROBE_S`` and twice that, and each term taken as a + b·S (an
    attention-free stack holds bytes linear in S)."""
    cell = build_cell(cfg, shape, mesh, accum=accum)
    if _seq_probed(cfg, shape):
        S1, S = PROBE_S, shape.seq_len
        m1 = memory_trace(cfg, dataclasses.replace(shape, seq_len=S1),
                          mesh, cell.accum)[1]
        m2 = memory_trace(cfg, dataclasses.replace(shape, seq_len=2 * S1),
                          mesh, cell.accum)[1]
        mem = {k: m1[k] + (m2[k] - m1[k]) * (S - S1) // S1 for k in m1}
        return cell, mem
    run, extra = cell, 0
    if cell.kind == "train" and cell.accum > 2:
        cut = dataclasses.replace(
            shape, global_batch=2 * shape.global_batch // cell.accum)
        run = build_cell(cfg, cut, mesh, accum=2)
        whole = sum(t.numel() * t.element_size()
                    for t in cell.abstract_args[2].values())
        extra = whole - sum(t.numel() * t.element_size()
                            for t in run.abstract_args[2].values())
    r = trace_step(run.step_fn, local_args(run, mesh), count_flops=False)
    return cell, memory_analysis(r, extra)


def memory_analysis(r: dict, extra: int = 0) -> dict:
    """The reference's ``memory_analysis`` keys from a trace ``r``
    (``trace_step``), with ``extra`` bytes of arguments alive throughout
    added to the arguments and the peak."""
    args_b, out_b, alias_b = r["args_bytes"] + extra, r["out_bytes"], \
        r["alias_bytes"]
    peak = r["peak_bytes"] + extra
    mem = {"argument_size_in_bytes": args_b,
           "output_size_in_bytes": out_b,
           "temp_size_in_bytes": max(peak - (args_b + out_b - alias_b), 0),
           "alias_size_in_bytes": alias_b,
           "generated_code_size_in_bytes": 0}
    mem["bytes_per_chip"] = (mem["argument_size_in_bytes"]
                             + mem["output_size_in_bytes"]
                             + mem["temp_size_in_bytes"]
                             - mem["alias_size_in_bytes"])
    return mem


def extrapolated_costs(cfg, shape, mesh) -> dict:
    """The cost terms of one step at accum 1 by the reference's two-point
    extrapolation over 1 and 2 superblocks (XLA counts a loop body once;
    a trace counts it every pass, so here it is exact), with xlstm's sequence probe past ``PROBE_PAST`` tokens: the
    step traced at S1 and 2·S1 tokens (``PROBE_S``) and every term taken
    as c + l·S outside the superblocks and R·(c' + l'·S) inside.  The
    reference multiplies a superblock's constant c' by S too, since XLA
    counted the sLSTM scan's body once; a trace counted it every step, so
    c' is what does not grow with S (the weights' reads) and is counted
    once a superblock."""
    R = scan_reps(cfg)
    if _seq_probed(cfg, shape):
        S1 = PROBE_S
        sh1 = dataclasses.replace(shape, name=shape.name + "_s1",
                                  seq_len=S1)
        sh2 = dataclasses.replace(shape, name=shape.name + "_s2",
                                  seq_len=2 * S1)
        A1 = _costs(_reduced_cfg(cfg, 1), sh1, mesh)
        B1 = _costs(_reduced_cfg(cfg, 2), sh1, mesh)
        A2 = _costs(_reduced_cfg(cfg, 1), sh2, mesh)
        B2 = _costs(_reduced_cfg(cfg, 2), sh2, mesh)
        A = A1
        S = shape.seq_len

        def ex(key, kind=None):
            g = (lambda d: d[key]) if kind is None \
                else (lambda d: d[key].get(kind, 0.0))
            sup1, sup2 = g(B1) - g(A1), g(B2) - g(A2)
            body = max(2 * sup1 - sup2, 0.0)       # a superblock's constant
            sup_lin = (sup2 - sup1) / S1           # per-token superblock
            out1, out2 = g(A1) - sup1, g(A2) - sup2
            out_lin = (out2 - out1) / S1
            out_const = max(2 * out1 - out2, 0.0)
            return (out_const + out_lin * S
                    + R * (sup_lin * S + body))
        parts = (A1, B1, A2, B2)
    else:
        A = _costs(_reduced_cfg(cfg, 1), shape, mesh)
        B = _costs(_reduced_cfg(cfg, 2), shape, mesh)

        def ex(key, kind=None):
            g = (lambda d: d[key]) if kind is None \
                else (lambda d: d[key].get(kind, 0.0))
            return max(g(A) + (R - 1) * (g(B) - g(A)), 0.0)
        parts = (A, B)
    names = sorted({k for p in parts for k in p["kernels"]})
    out = {"flops": ex("flops"), "hlo_bytes": ex("hlo_bytes"),
           "hbm": ex("hbm"), "n_coll": A["n_coll"],
           "coll": {k: ex("coll", k) for k in A["coll"]},
           "kernels": {k: int(round(ex("kernels", k))) for k in names}}
    return out


def concrete_args(cell, device, seed: int = 0) -> tuple:
    """A cell's arguments made real on ``device`` (one device), to hold a
    trace against a run: params from a generator seeded on ``device``,
    the default optimizer's state, seeded tokens (or frames, patches), a
    zero cache and ``decode_position``."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    cfg = cell.cfg

    def real(t):
        if t.dtype in (torch.int32, torch.int64):
            x = torch.randint(0, cfg.vocab_size, tuple(t.shape), generator=g,
                              dtype=t.dtype)
        else:
            x = torch.randn(tuple(t.shape), generator=g).to(t.dtype)
        return x.to(device)

    params = cell.model.init(torch.Generator(device=device).manual_seed(
        seed + 1), device)
    if cell.kind == "train":
        opt = default_optimizer(cfg)
        return (params, opt.init(params),
                {k: real(v) for k, v in cell.abstract_args[2].items()})
    if cell.kind == "prefill":
        return params, {k: real(v) for k, v in cell.abstract_args[1].items()}
    pos = decode_position(cell)
    cache = cell.model.cache_shape(
        cell.shape.global_batch, pos + 1, device,
        **({"enc_len": cell.shape.seq_len} if cfg.is_encdec else {}))
    return params, cache, real(cell.abstract_args[2]), pos


def _mesh_spec(multi_pod: bool, mesh_shape: Optional[str]) -> str:
    return mesh_shape or ("2x16x16" if multi_pod else "16x16")


def trace_cell(cfg, shape, mesh) -> tuple:
    """(the cell, its ``memory_analysis``, the cost terms of one step at
    accum 1, the seconds of the cost terms' extrapolation).  One
    full-depth trace gives both where the cell's step is the accum-1 step
    (prefill, decode, train at accum 1); a train step of accum > 1 takes
    its memory from ``memory_trace``; an sLSTM arch past ``PROBE_PAST``
    tokens is probed in sequence for both (``extrapolated_costs``)."""
    if _seq_probed(cfg, shape):
        cell, mem = memory_trace(cfg, shape, mesh)
        t0 = time.time()
        costs = extrapolated_costs(cfg, shape, mesh)
        return cell, mem, costs, time.time() - t0
    cell = build_cell(cfg, shape, mesh)
    if cell.kind == "train" and cell.accum > 1:
        mem = memory_trace(cfg, shape, mesh)[1]
        return cell, mem, _costs(cfg, shape, mesh), 0.0
    r = trace_step(cell.step_fn, local_args(cell, mesh))
    return cell, memory_analysis(r), _cost_terms(r), 0.0


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str | None = None, verbose: bool = True,
             overrides: dict | None = None, tag: str = "",
             mesh_shape: str | None = None) -> dict:
    """Dry-run one cell on the (16, 16) mesh, the (2, 16, 16) one
    (``multi_pod``) or ``mesh_shape`` ("32x8": data, model).  Returns the
    record, written to ``out_dir`` when given."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    mesh_name = _mesh_spec(multi_pod, mesh_shape)
    chips = math.prod(mesh_lib.mesh_dims(mesh_name)[0])
    with fake_world(mesh_name) as mesh:
        t0 = time.time()
        cell, mem, costs, t_extra = trace_cell(cfg, shape, mesh)
        t_full = time.time() - t0 - t_extra
    R = scan_reps(cell.cfg)
    roof = rl.analyze(costs["flops"], costs, arch=arch, shape=shape,
                      cfg=cell.cfg, mesh_name=mesh_name, chips=chips,
                      memory_stats=mem)
    rec = roof.to_json()
    rec["memory_analysis"] = mem
    rec["kind"] = cell.kind
    rec["compile_full_s"] = round(t_full, 2)
    rec["compile_extrap_s"] = round(t_extra, 2)
    rec["collective_count_per_superblock"] = costs["n_coll"]
    rec["scan_reps"] = R
    rec["kernels"] = {k: int(v) for k, v in costs["kernels"].items()}
    rec["accum"] = cell.accum

    if verbose:
        print(f"[{arch} x {shape_name} x {mesh_name}] kind={cell.kind} "
              f"trace={t_full:.1f}s probe={t_extra:.1f}s reps={R} "
              f"accum={cell.accum}")
        print(f"  memory: "
              f"args={mem.get('argument_size_in_bytes', 0)/1e9:.3f} GB  "
              f"out={mem.get('output_size_in_bytes', 0)/1e9:.3f} GB  "
              f"temp={mem.get('temp_size_in_bytes', 0)/1e9:.3f} GB  "
              f"-> {mem.get('bytes_per_chip', 0)/1e9:.3f} GB/chip of "
              f"{HBM_BYTES/1e9:.0f} GB "
              f"({'fits' if mem['bytes_per_chip'] <= HBM_BYTES else 'OVER'})")
        print(f"  cost: {roof.hlo_gflops:.1f} GFLOP  "
              f"{roof.hlo_gbytes:.1f} GB accessed (unfused) / "
              f"{roof.hbm_gbytes:.1f} GB (fusion-adj)  "
              f"collectives {roof.coll_gbytes:.3f} GB "
              f"{ {k: round(v, 3) for k, v in roof.coll_by_kind.items() if v} }")
        print(f"  roofline ({roof.profile_name}): "
              f"compute={roof.compute_s*1e3:.2f} ms  "
              f"memory={roof.memory_s*1e3:.2f} ms  "
              f"collective={roof.collective_s*1e3:.2f} ms  "
              f"bound={roof.bottleneck}  "
              f"useful={100*roof.useful_flops_frac:.1f}%  "
              f"kernels={rec['kernels']}")

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"__{tag}" if tag else ""
        fname = f"{arch}__{shape_name}__{mesh_name}{suffix}.json".replace(
            "/", "_")
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", choices=ARCHS)
    p.add_argument("--shape", choices=list(SHAPES))
    p.add_argument("--mesh", choices=["single", "multi", "both"],
                   default="single")
    p.add_argument("--all", action="store_true",
                   help="run every (arch x shape) cell")
    p.add_argument("--out", default=None, help="directory for JSON results")
    p.add_argument("--set", nargs="*", default=[], dest="overrides",
                   help="config overrides, e.g. seq_parallel_attn=True")
    p.add_argument("--tag", default="", help="suffix for result filenames")
    p.add_argument("--mesh-shape", default=None,
                   help="override mesh, e.g. 32x8 (axes data,model)")
    args = p.parse_args(argv)
    overrides = dict(_parse_override(kv) for kv in args.overrides)

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    cells = []
    if args.all:
        for a in ARCHS:
            for s in shapes_for(a):
                cells.append((a, s.name))
    else:
        if not args.arch or not args.shape:
            p.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    failures = []
    t0 = time.time()
    for arch, shape in cells:
        for mp in meshes:
            try:
                run_cell(arch, shape, mp, out_dir=args.out,
                         overrides=overrides, tag=args.tag,
                         mesh_shape=args.mesh_shape)
            except Exception:                                 # noqa: BLE001
                failures.append((arch, shape, mp))
                traceback.print_exc()
    if failures:
        print(f"FAILED cells: {failures}", file=sys.stderr)
        sys.exit(1)
    print(f"dry-run complete: all cells traced in {time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
