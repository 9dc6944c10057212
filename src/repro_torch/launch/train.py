"""End-to-end training driver (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --smoke \\
        --steps 50 --ckpt-dir /tmp/ckpt

Wires the layers together: config -> model -> data pipeline -> train step
(``launch.steps``) -> checkpoint manager (atomic, async, retained) ->
fault-tolerance hooks (preemption -> save-and-exit; the data state is the
step, so a restart sees the same batches).  The model runs on the CUDA
device unless ``--device`` names another one (``cpu`` runs every kernel's
plain version).  ``--arch`` takes every arch of the port's registry, the
recurrent ``recurrentgemma-2b`` and ``xlstm-125m`` too.  One device only:
``--mesh`` takes ``1x1`` (the model-stack sharding is ROADMAP A10-rest).

A checkpoint holds ``{"params", "opt": {"step", "inner"}}``; a run with
``--ckpt-dir`` resumes from its latest step.  Losses reach the host only
on log steps.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_smoke
from repro_torch.data import make_pipeline
from repro_torch.device import resolve_device
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
def load_train_tree(params, opt_state: OptState, restored: dict) -> None:
    """Copy a restored train state (numpy leaves, ``train_tree``'s
    structure) into the live tensors, the step included."""
    for t, arr in zip(tree_leaves(train_tree(params, opt_state)),
                      tree_leaves(restored)):
        t.copy_(torch.as_tensor(arr))


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
                   help="only 1x1: the model-stack sharding is not ported")
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
    if args.mesh != "1x1":
        raise NotImplementedError(
            f"--mesh {args.mesh}: the port trains on one device; the "
            f"model-stack sharding is ROADMAP A10-rest")

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    device = resolve_device(args.device)
    model = build_model(cfg)
    opt = default_optimizer(cfg)
    step_fn = make_train_step(model, opt, peak_lr=args.peak_lr,
                              total=args.steps,
                              warmup=max(args.steps // 10, 1),
                              accum=args.accum)
    pipe = make_pipeline("synthetic", vocab_size=cfg.vocab_size,
                         seq_len=args.seq_len, global_batch=args.global_batch)

    preempt = PreemptionHandler(install_signal=True)
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None

    params = model.init(torch.Generator(device="cpu").manual_seed(0), device)
    opt_state = opt.init(params)
    start = 0
    if mgr is not None:
        latest = mgr.latest_step()
        if latest is not None:
            restored = mgr.restore(latest, train_tree(params, opt_state))
            load_train_tree(params, opt_state, restored)
            start = latest
            print(f"restored checkpoint @ step {latest}")

    t0 = time.time()
    losses = []
    for step in range(start, args.steps):
        params, opt_state, metrics = step_fn(params, opt_state,
                                             pipe.batch_at(step))
        losses.append(metrics["loss"])
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            tput = (step - start + 1) * args.global_batch \
                * args.seq_len / max(dt, 1e-9)
            print(f"step {step:5d}  loss {float(metrics['loss']):.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"lr {float(metrics['lr']):.2e}  "
                  f"{tput:,.0f} tok/s", flush=True)
        if mgr is not None and (
                (step + 1) % args.ckpt_every == 0 or preempt.should_exit):
            mgr.save(step + 1, train_tree(params, opt_state),
                     blocking=preempt.should_exit)
        if preempt.should_exit:
            print(f"preempted: checkpointed at step {step + 1}, exiting")
            break
    if mgr is not None:
        mgr.join()
    losses = torch.stack(losses).tolist() if losses else []

    if len(losses) >= 20:
        first, last = np.mean(losses[:10]), np.mean(losses[-10:])
        print(f"loss {first:.4f} -> {last:.4f} "
              f"({'improved' if last < first else 'NOT improved'})")
    return losses


if __name__ == "__main__":
    main()
