"""The train step of the port (port of the train half of
``repro.launch.steps``).

    train_step(params, opt_state, batch) -> (params, opt_state, metrics)

One optimizer step: the model's loss and its gradient (``Model.loss``;
every attention layer's forward is B6, its backward
``kernels.flash_attention.grad.attention_vjp``), the learning rate
``warmup_cosine(opt_state.step, ...)`` and the optimizer's in-place update.
``accum`` > 1 splits the global batch into sequential microbatches (row
blocks, as the reference reshapes it) and sums their gradients in f32: an
f32 parameter's ``.grad`` accumulates in place, any other dtype's in an f32
buffer; the sum is divided by ``accum`` and the metrics are averaged.
The batch moves to the params' device once per step.  The parameters
require grad only inside the step: they come back with the flags they
were given, so serving them afterwards records no autograd graph.  ``metrics`` holds
0-d device tensors (the loss's, ``grad_norm`` and ``lr``), so a step reads
nothing back to the host.  The update runs inside the profiler range
``OPT_RANGE``.

Every family trains: the recurrent mixers differentiate through the
RG-LRU scan's ``LinearScan`` (its adjoint scan as the backward) and the
sLSTM loop's out-of-place form (``models.recurrent``).  ``build_cell``
and the optimizer-state shardings wait for the model-stack sharding
(ROADMAP A10-rest).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.model import Model, stacked_layers
from repro_torch.optim import make_optimizer, warmup_cosine
from repro_torch.optim.optimizers import tree_leaves, tree_unflatten

_F32 = torch.float32
#: profiler range of the optimizer's update inside a train step
OPT_RANGE = "train.optimizer"


def default_optimizer(cfg: ModelConfig):
    """adafactor for the >=100B configs (memory budget), adamw otherwise.
    adafactor updates the layers the reference stacks as one tensor each
    (``stacked_layers``), as the reference's does."""
    if cfg.param_count() > 100e9:
        return make_optimizer(
            "adafactor", momentum=False,
            stacks=functools.partial(stacked_layers, cfg=cfg))
    return make_optimizer("adamw")


def _microbatch(batch: dict, accum: int, i: int) -> dict:
    if accum == 1:
        return batch
    return {k: v.reshape((accum, v.shape[0] // accum) + v.shape[1:])[i]
            for k, v in batch.items()}


def make_train_step(model: Model, opt, *, peak_lr: float = 3e-4,
                    warmup: int = 100, total: int = 10_000, accum: int = 1):
    """One optimizer step; ``accum`` > 1 splits the global batch into
    sequential microbatches (activation memory / accum)."""
    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        device = leaves[0].device
        flags = [p.requires_grad for p in leaves]
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()}
        acc, mets = {}, []
        with torch.enable_grad():
            for i in range(accum):
                loss, met = model.loss(params, _microbatch(batch, accum, i))
                loss.backward()
                del loss
                mets.append({k: v.detach() for k, v in met.items()})
                if accum == 1:
                    continue
                for j, p in enumerate(leaves):
                    if p.dtype != _F32 and p.grad is not None:
                        g = p.grad.to(_F32)
                        p.grad = None
                        acc[j] = g if j not in acc else acc[j].add_(g)
        grads = []
        for j, p in enumerate(leaves):
            g = acc.pop(j, p.grad)
            if g is None:                        # a leaf the loss never read
                g = torch.zeros(p.shape, dtype=_F32 if accum > 1 else p.dtype,
                                device=device)
            grads.append(g.div_(accum) if accum > 1 else g)
        if accum == 1:
            metrics = mets[0]
        else:
            metrics = {k: torch.mean(torch.stack([m[k] for m in mets]))
                       for k in mets[0]}
        lr = warmup_cosine(opt_state.step, peak=peak_lr, warmup_steps=warmup,
                           total_steps=total)
        with torch.profiler.record_function(OPT_RANGE):
            params, opt_state, om = opt.update(
                tree_unflatten(params, iter(grads)), opt_state, params, lr)
        del grads
        for p, flag in zip(leaves, flags):      # serving them records no graph
            p.grad = None
            p.requires_grad_(flag)
        return params, opt_state, {**metrics, **om, "lr": lr}
    return train_step


def default_accum(cfg: ModelConfig, shape: ShapeConfig, dp: int = 1) -> int:
    """Microbatch count so per-step activation temps fit ~8 GB a device
    (the reference's calibrated budget: ~10x the bf16 block inputs).
    ``dp`` is the data-parallel size (the port has no model mesh yet, so
    1); ``accum`` is capped at the local batch."""
    if shape.kind != "train":
        return 1
    local_b = max(shape.global_batch // dp, 1)
    layers = cfg.n_layers + (cfg.n_dec_layers if cfg.is_encdec else 0)
    act = layers * local_b * shape.seq_len * cfg.d_model * 2 * 10
    accum = 1
    while act / accum > 8e9 and accum < local_b:
        accum *= 2
    return accum
