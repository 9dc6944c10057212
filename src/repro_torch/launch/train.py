"""End-to-end training driver (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --smoke \\
        --steps 50 --ckpt-dir /tmp/ckpt

Wires the layers together: config -> model -> data pipeline -> train step
(``launch.steps``) -> checkpoint manager (atomic, async, retained) ->
fault-tolerance hooks (preemption -> save-and-exit; the data state is the
step, so a restart sees the same batches).  The model runs on the CUDA
device unless ``--device`` names another one (``cpu`` runs every kernel's
plain version).  ``--arch`` takes every arch of the port's registry, the
recurrent ``recurrentgemma-2b`` and ``xlstm-125m`` too.

``--mesh dxm`` (or ``pxdxm``) trains on a device mesh of that shape
(``launch.mesh.parse_mesh``; ``data`` x ``model``, ``pod`` in front):

    torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --arch yi-6b --smoke --mesh 1x2

under ``torchrun`` (the process group is set up from its environment:
NCCL when every rank has a card of its own, else gloo) or in a process
whose group is already initialized.  Each rank draws the same seeded
params and keeps its shards (``launch.steps.shard_params``); the step is
``launch.steps``' mesh executor.  Every family runs there:
``--arch deepseek-v3-671b`` (MLA over heads, multi-token prediction, and
adafactor, which ``default_optimizer`` gives the uncut config, with its
statistics whole on every rank), the recurrent ``recurrentgemma-2b`` and
``xlstm-125m`` and the encoder-decoder ``whisper-large-v3``; on the CPU

    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --arch xlstm-125m --smoke --device cpu --steps 1 --mesh 1x2

A batch whose rows the data axes do not divide lies over ``data`` alone
where ``data`` divides it, else whole on every rank, as the reference
lays it out (``launch.steps.local_rows``); MLA under
``seq_parallel_attn`` splits its query rows over ``model`` where the
heads do not divide it.  The encoder-decoder trains on ``input_specs``' shapes:
``--seq-len`` seeded frame embeddings a row (the stubbed frontend, drawn
from the step) and a decoder of ``--seq-len`` // 8 synthetic tokens.

A checkpoint holds ``{"params", "opt": {"step", "inner"}}`` in whole
leaves; a run with ``--ckpt-dir`` resumes from its latest step.  On a mesh
the leaves are all-gathered one at a time into rank 0's host memory and
rank 0 writes the same store a single device writes; a restore takes each
rank's shards of the stored leaves, so a mesh checkpoint restores on one
device and a one-device checkpoint on a mesh.  The ranks agree each step
on whether a preemption signal reached any of them.  Losses reach the
host only on log steps.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_smoke
from repro_torch.data import make_pipeline
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import setup_mesh
from repro_torch.launch.steps import default_optimizer, make_train_step
from repro_torch.models.model import build_model
from repro_torch.optim import OptState
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.runtime import PreemptionHandler


def train_tree(params, opt_state: OptState) -> dict:
    """The checkpointed train state."""
    return {"params": params,
            "opt": {"step": opt_state.step, "inner": opt_state.inner}}


@torch.no_grad()
def load_train_tree(params, opt_state: OptState, restored: dict,
                    specs=None, mesh=None) -> None:
    """Copy a restored train state (numpy leaves, ``train_tree``'s
    structure) into the live tensors, the step included; on a mesh each
    rank takes its shard of every leaf (``specs``: the train tree's spec
    tree)."""
    flat = [s for _, s in shd.leaves_with_path(specs)] if specs else None
    for i, (t, arr) in enumerate(zip(
            tree_leaves(train_tree(params, opt_state)),
            tree_leaves(restored))):
        a = torch.as_tensor(arr)
        t.copy_(a if flat is None else shd.local_shard(a, flat[i], mesh))


def _any_rank(flag: bool, mesh, device) -> bool:
    """``flag`` or-ed over every rank of the mesh's group: a preemption
    signal may reach the ranks a step apart, and all of them must enter
    the checkpoint's collectives together."""
    if mesh is None:
        return flag
    t = torch.tensor([int(flag)], device="cpu" if dist.get_backend()
                     == "gloo" else device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def batch_at(pipe, cfg, step: int, seq_len: int) -> dict:
    """The global batch of ``step``: the pipeline's tokens and labels, and
    for an encoder-decoder (B, ``seq_len``, frontend_dim) frame
    embeddings drawn from (seed 0, step), the same on every rank and at
    every restart."""
    batch = pipe.batch_at(step)
    if cfg.is_encdec:
        rng = np.random.default_rng(np.random.SeedSequence([0, int(step)]))
        batch["frames"] = rng.standard_normal(
            (batch["tokens"].shape[0], seq_len, cfg.frontend_dim),
            dtype=np.float32)
    return batch


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--arch", required=True)
    p.add_argument("--smoke", action="store_true",
                   help="use the reduced config (CPU-runnable)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--seq-len", type=int, default=256)
    p.add_argument("--global-batch", type=int, default=8)
    p.add_argument("--mesh", default="1x1",
                   help="dxm or pxdxm (data x model, pod in front); more "
                        "than one device needs torchrun or an initialized "
                        "process group")
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--accum", type=int, default=1)
    p.add_argument("--peak-lr", type=float, default=3e-4)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--compress-pod-grads", type=int, default=0,
                   help="CountSketch compression ratio for the cross-pod "
                        "all-reduce (0 = off); parsed and unused, as in the "
                        "reference: one device has no pods")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain "
                        "versions)")
    args = p.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    mesh, device = setup_mesh(args.mesh, resolve_device(args.device))
    rank0 = mesh is None or dist.get_rank() == 0
    model = build_model(cfg)
    opt = default_optimizer(cfg)
    pipe = make_pipeline("synthetic", vocab_size=cfg.vocab_size,
                         seq_len=max(args.seq_len // 8, 1) if cfg.is_encdec
                         else args.seq_len, global_batch=args.global_batch)

    preempt = PreemptionHandler(install_signal=True)
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None

    state_specs = specs = None
    if mesh is not None:
        aparams = model.init(None, "meta")
        aopt = opt.init(aparams)
        specs = shd.param_shardings(aparams, mesh, fsdp=cfg.fsdp,
                                    moe_ep2d=cfg.moe_impl == "shard_map")
        state_specs = train_tree(specs, OptState(
            shd.replicated(mesh),
            steps_lib._opt_shardings(aopt, aparams, specs, mesh).inner))
    step_fn = make_train_step(model, opt, peak_lr=args.peak_lr,
                              total=args.steps,
                              warmup=max(args.steps // 10, 1),
                              accum=args.accum, mesh=mesh, specs=specs)
    params = model.init(torch.Generator(device="cpu").manual_seed(0), device)
    flat_specs = None
    if mesh is not None:
        params = shd.shard_tree(params, specs, mesh)
        flat_specs = [s for _, s in shd.leaves_with_path(specs)]
    opt_state = opt.init(params, mesh=mesh, specs=flat_specs)
    start = 0
    if mgr is not None:
        latest = mgr.latest_step()
        if latest is not None:
            like = train_tree(params, opt_state) if mesh is None \
                else train_tree(aparams, aopt)
            restored = mgr.restore(latest, like)
            load_train_tree(params, opt_state, restored, state_specs, mesh)
            start = latest
            if rank0:
                print(f"restored checkpoint @ step {latest}")

    t0 = time.time()
    losses = []
    for step in range(start, args.steps):
        params, opt_state, metrics = step_fn(params, opt_state,
                                             batch_at(pipe, cfg, step,
                                                      args.seq_len))
        losses.append(metrics["loss"])
        if rank0 and (step % args.log_every == 0 or step == args.steps - 1):
            dt = time.time() - t0
            tput = (step - start + 1) * args.global_batch \
                * args.seq_len / max(dt, 1e-9)
            print(f"step {step:5d}  loss {float(metrics['loss']):.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"lr {float(metrics['lr']):.2e}  "
                  f"{tput:,.0f} tok/s", flush=True)
        stop = _any_rank(preempt.should_exit, mesh, device)
        if mgr is not None and ((step + 1) % args.ckpt_every == 0 or stop):
            if mesh is None:
                mgr.save(step + 1, train_tree(params, opt_state),
                         blocking=stop)
            else:
                # leaf by leaf into rank 0's host memory; rank 0 writes
                whole = steps_lib.gather_tree(train_tree(params, opt_state),
                                              state_specs, mesh, dst=0)
                if rank0:
                    mgr.save(step + 1, whole, blocking=True)
                del whole
                dist.barrier()
        if stop:
            print(f"preempted: checkpointed at step {step + 1}, exiting")
            break
    if mgr is not None:
        mgr.join()
    losses = torch.stack(losses).tolist() if losses else []

    if rank0 and len(losses) >= 20:
        first, last = np.mean(losses[:10]), np.mean(losses[-10:])
        print(f"loss {first:.4f} -> {last:.4f} "
              f"({'improved' if last < first else 'NOT improved'})")
    return losses


if __name__ == "__main__":
    main()
