"""Step functions and shardings for one (arch, shape, mesh) cell (port of
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
``OPT_RANGE``.  Every family trains on one device.

**On a mesh** (``make_train_step(..., mesh=, specs=)``, a ``DeviceMesh``
of more than one device; a mesh of one device takes the code above) the
params and the optimizer state are this rank's local shards, laid out by
``specs`` (``distributed.sharding.param_shardings`` of the global params;
``shard_params`` makes both).  Every rank is handed the same global
batch; a microbatch is the reference's global row block, of which a rank
takes the rows that ``batch_pspec`` gives it (``local_rows``): its block
over (pod, data) where they divide the rows, else over ``data`` alone
where it divides them, else the whole microbatch, as the reference's
``batch_shardings`` lays a batch out.  The model runs under
``sharding.use_mesh`` on a ``mesh_view`` of the shards: FSDP gathers
each block's weights over ``data`` on use, ``model`` carries heads, FFN
width, vocabulary and experts (``models``).  A rank's loss is its share
of the global loss (the global token count counts a row once for each
rank that holds it, so the shares of ranks holding the same rows add up
to that rows' loss), so after the backward each gradient is summed over
the data axes that do not split the leaf (an FSDP
leaf's was reduce-scattered over ``data`` in the backward); the leaves
that a ``model`` rank uses in part (under TP, SP and EP) were summed over
``model`` inside autograd (``collectives.copy_to``).  The global-norm
clip sums each leaf's squares over the axes it is split over and counts
a replicated leaf once (``mesh_global_norm``).  The optimizer's update
gets the mesh and each leaf's spec: adamw and lion update the shards
elementwise; adafactor keeps its factored statistics whole and
replicated, as the reference lays them out (``_opt_shardings``), formed
from local sums added over the axes that split the reduced dimension in
rank order (``optim.optimizers``); its state is made on the mesh by
``opt.init(local, mesh=, specs=)``.  Every family trains there, MLA
under ``seq_parallel_attn`` too.

``build_cell`` is the entry point the reference's dry-run, trainer and
server share: the step function, its abstract arguments (tensors on the
``meta`` device: nothing is allocated; ``Model.init`` on ``meta`` draws
nothing, see ``layers.dense_init``) and the in/out spec trees for the
train, prefill and decode kinds.  The train cell's step runs on a mesh as
above.  The prefill and decode steps run on a ``DeviceMesh`` as the
reference's jitted cells run on theirs: they take this rank's shards
under the in specs (the params, the batch rows, the cache) and return
its shards under the out specs (the logits, vocabulary whole; the cache,
laid out by ``cache_shardings``).  A {name: size} mesh gives the specs
only: its serving steps raise ``ValueError`` on more than one device.
``_opt_shardings`` gives an optimizer-state leaf its parameter's spec by
path suffix and shape, else replicated.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.configs import config_for_shape
from repro_torch.configs.base import ModelConfig, ShapeConfig, input_specs
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as shd
from repro_torch.models.model import Model, build_model, stacked_layers
from repro_torch.optim import make_optimizer, warmup_cosine
from repro_torch.optim.optimizers import tree_leaves, tree_unflatten

_F32 = torch.float32
#: profiler range of the optimizer's update inside a train step
OPT_RANGE = "train.optimizer"
WHISPER_DECODER_LEN = 448        # fixed decoder horizon (enc-dec decode cells)
#: elements of one gradient all-reduce bucket
_BUCKET = 1 << 26


class Cell(NamedTuple):
    cfg: ModelConfig
    shape: ShapeConfig
    model: Model
    step_fn: Callable
    abstract_args: tuple          # meta tensors, positional
    in_shardings: tuple           # spec trees
    out_shardings: Any
    kind: str                     # train | prefill | decode
    accum: int = 1                # the train step's microbatches


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


def _grads_and_metrics(loss_fn, params, leaves, micro, accum: int):
    """Each microbatch's loss and backward; (a gradient per leaf, the
    metrics averaged over the microbatches)."""
    device = leaves[0].device
    acc, mets = {}, []
    with torch.enable_grad():
        for i in range(accum):
            loss, met = loss_fn(params, micro(i))
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
        if g is None:                            # a leaf the loss never read
            g = torch.zeros(p.shape, dtype=_F32 if accum > 1 else p.dtype,
                            device=device)
        grads.append(g.div_(accum) if accum > 1 else g)
    if accum == 1:
        metrics = mets[0]
    else:
        metrics = {k: torch.mean(torch.stack([m[k] for m in mets]))
                   for k in mets[0]}
    return grads, metrics


def make_train_step(model: Model, opt, *, peak_lr: float = 3e-4,
                    warmup: int = 100, total: int = 10_000, accum: int = 1,
                    mesh=None, specs=None):
    """One optimizer step; ``accum`` > 1 splits the global batch into
    sequential microbatches (activation memory / accum).  With a ``mesh``
    of more than one device the params are local shards laid out by
    ``specs`` (see the module's docstring)."""
    on_mesh = not shd.is_trivial(mesh)
    flat_specs = None
    if on_mesh:
        if specs is None:
            raise ValueError("a mesh step needs the params' spec tree")
        flat_specs = [s for _, s in shd.leaves_with_path(specs)]

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        flags = [p.requires_grad for p in leaves]
        grads, metrics, gnorm = loss_and_grads(
            model, params, batch, accum=accum, mesh=mesh if on_mesh else None,
            specs=specs)
        lr = warmup_cosine(opt_state.step, peak=peak_lr, warmup_steps=warmup,
                           total_steps=total)
        with torch.profiler.record_function(OPT_RANGE):
            extra = {} if gnorm is None else {
                "gnorm": gnorm, "mesh": mesh, "specs": flat_specs}
            params, opt_state, om = opt.update(
                tree_unflatten(params, iter(grads)), opt_state, params, lr,
                **extra)
        del grads
        for p, flag in zip(leaves, flags):      # serving them records no graph
            p.grad = None
            p.requires_grad_(flag)
        return params, opt_state, {**metrics, **om, "lr": lr}
    return train_step


def loss_and_grads(model: Model, params, batch: dict, *, accum: int = 1,
                   mesh=None, specs=None):
    """The step's forward and backward: (a gradient per leaf of
    ``params`` in tree order, the metrics, the global norm on a mesh or
    None).  On a mesh the gradients are this rank's shards, summed over
    the data axes (``sync_grads``); each microbatch's loss runs on this
    rank's rows of it under ``sharding.use_rows``.  The leaves require
    grad on return."""
    leaves = tree_leaves(params)
    device = leaves[0].device
    for p in leaves:
        p.requires_grad_(True)
        p.grad = None
    batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    if shd.is_trivial(mesh):
        grads, metrics = _grads_and_metrics(
            model.loss, params, leaves, lambda i: _microbatch(batch, accum, i),
            accum)
        return grads, metrics, None
    flat_specs = [s for _, s in shd.leaves_with_path(specs)]

    def loss_fn(p, micro):
        B = next(iter(micro.values())).shape[0]
        with shd.use_rows(shd.row_axes(B, mesh)):
            return model.loss(p, local_rows(micro, mesh))
    with shd.use_mesh(mesh):
        grads, metrics = _grads_and_metrics(
            loss_fn, shd.mesh_view(params, specs), leaves,
            lambda i: _microbatch(batch, accum, i), accum)
    sync_grads(grads, flat_specs, mesh)
    return grads, metrics, mesh_global_norm(grads, flat_specs, mesh)


# ---------------------------------------------------------------------------
# the mesh executor's pieces
# ---------------------------------------------------------------------------

def local_rows(batch: dict, mesh) -> dict:
    """This rank's rows of a (micro)batch, as ``batch_pspec`` lays them
    out (``sharding.row_axes``): its block over (pod, data), row-major
    with ``pod`` outer, where they divide the rows; else its block over
    ``data`` alone where it divides them (the ``pod`` ranks hold the same
    rows); else the whole batch.  The reference's trainer lays its batch
    out so (``batch_shardings``, no sequence axis)."""
    B = next(iter(batch.values())).shape[0]
    axes = shd.row_axes(B, mesh)
    if not axes:
        return batch
    first, n = shd.local_range((axes,), 0, B, mesh)
    return {k: v[first:first + n] for k, v in batch.items()}


def _reduce_axes(spec, mesh) -> tuple:
    """The data axes a leaf's gradient is summed over: those (of size > 1)
    that do not split the leaf.  Each rank's loss is its share of the
    global loss, whether the axis splits the batch or its ranks hold the
    same rows."""
    own = shd.spec_axes(spec)
    return tuple(a for a in shd.data_axes(mesh)
                 if a not in own and shd.mesh_shape(mesh)[a] > 1)


@torch.no_grad()
def sync_grads(grads: list, flat_specs: list, mesh) -> None:
    """Sum each gradient in place over ``_reduce_axes``, in buckets of one
    dtype and axis set, in the same order on every rank."""
    groups: dict = {}
    for j, (g, spec) in enumerate(zip(grads, flat_specs)):
        axes = _reduce_axes(spec, mesh)
        if axes:
            groups.setdefault((axes, g.dtype), []).append(j)
    for (axes, _), idx in groups.items():
        start = 0
        while start < len(idx):
            end, n = start, 0
            while end < len(idx) and (n == 0 or n + grads[idx[end]].numel()
                                      <= _BUCKET):
                n += grads[idx[end]].numel()
                end += 1
            part = idx[start:end]
            buf = C.all_reduce(torch.cat([grads[j].reshape(-1)
                                          for j in part]), axes, mesh=mesh)
            for j, piece in zip(part, torch.split(
                    buf, [grads[j].numel() for j in part])):
                grads[j].copy_(piece.view_as(grads[j]))
            del buf
            start = end


@torch.no_grad()
def mesh_global_norm(grads: list, flat_specs: list, mesh) -> torch.Tensor:
    """The global norm of a gradient tree of local shards: each leaf's sum
    of squares summed over the axes it is split over in rank order, a
    replicated leaf counted once (``collectives.sum_by_axes``, which
    adafactor's update clip shares)."""
    return torch.sqrt(C.sum_by_axes(
        [(torch.sum(torch.square(g.to(_F32))), shd.leaf_axes(spec, mesh))
         for g, spec in zip(grads, flat_specs)], mesh))


def shard_params(cfg: ModelConfig, params, mesh):
    """(this rank's shards of the global ``params``, their spec tree) under
    ``cfg``'s rules (``fsdp``; expert banks over ('data', 'model') for
    ``moe_impl="shard_map"``)."""
    specs = shd.param_shardings(params, mesh, fsdp=cfg.fsdp,
                                moe_ep2d=cfg.moe_impl == "shard_map")
    return shd.shard_tree(params, specs, mesh), specs


@torch.no_grad()
def gather_tree(tree, specs, mesh, dst: Optional[int] = None):
    """Whole leaves of a tree of local shards laid out by ``specs``: the
    inverse of ``sharding.shard_tree``, gathered leaf by leaf.  Every rank
    gets them; with ``dst``, only global rank ``dst`` keeps them, each
    moved to the host as soon as it is whole (a checkpoint of a model
    whose train state fits no device whole), and the others get None."""
    flat = dict(shd.leaves_with_path(specs))
    keep = dst is None or dist.get_rank() == dst

    def one(path, t):
        t = shd.gather_leaf(t, flat.get(path, ()), mesh)
        if dst is None:
            return t
        return t.cpu() if keep else None
    out = shd.map_with_path(one, tree)
    return out if keep else None


def default_accum(cfg: ModelConfig, shape: ShapeConfig, mesh=None, *,
                  dp: Optional[int] = None) -> int:
    """Microbatch count so per-step activation temps fit ~8 GB a device
    (the reference's calibrated budget: ~10x the bf16 block inputs).
    The local batch is a rank's rows of the global batch on ``mesh``
    (``sharding.row_axes``: the whole batch where it lies whole on every
    rank), or the global batch over ``dp`` ranks, as the reference sizes
    it, where ``dp`` is given; ``accum`` is capped at the local batch."""
    if shape.kind != "train":
        return 1
    if dp is None:
        dp = math.prod(shd.mesh_shape(mesh)[a] for a in shd.row_axes(
            shape.global_batch, mesh))
    local_b = max(shape.global_batch // dp, 1)
    layers = cfg.n_layers + (cfg.n_dec_layers if cfg.is_encdec else 0)
    act = layers * local_b * shape.seq_len * cfg.d_model * 2 * 10
    accum = 1
    while act / accum > 8e9 and accum < local_b:
        accum *= 2
    return accum


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def _abstract(spec) -> torch.Tensor:
    return torch.empty(tuple(spec.shape), dtype=spec.dtype, device="meta")


def _serving_mesh(mesh, kind: str):
    """The mesh a serving cell runs on: None for one device; a {name:
    size} mesh of more than one device carries no ranks (its cell gives
    the specs only)."""
    if shd.is_trivial(mesh):
        return None
    if isinstance(mesh, dict):
        raise ValueError(f"the {kind} cell on {shd.mesh_shape(mesh)}: a "
                         f"{{name: size}} mesh gives the specs only; run "
                         f"the step on a DeviceMesh")
    return mesh


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
               opt=None, accum: Optional[int] = None) -> Cell:
    """The step, its abstract args and its in/out spec trees for a cell on
    ``mesh`` (a ``DeviceMesh`` or a {name: size} dict: the specs need only
    the sizes; the train step runs on a ``DeviceMesh``)."""
    cfg = config_for_shape(cfg, shape)
    model = build_model(cfg)
    aparams = model.init(None, "meta")
    psh = shd.param_shardings(aparams, mesh, fsdp=cfg.fsdp,
                              moe_ep2d=cfg.moe_impl == "shard_map")
    batch = {k: _abstract(v) for k, v in input_specs(cfg, shape).items()}
    repl = shd.replicated(mesh)
    B = shape.global_batch

    if shape.kind == "train":
        opt = opt or default_optimizer(cfg)
        aopt = opt.init(aparams)
        osh = _opt_shardings(aopt, aparams, psh, mesh)
        bsh = shd.batch_shardings(batch, mesh)
        accum = accum if accum is not None \
            else default_accum(cfg, shape, mesh)
        step = make_train_step(
            model, opt, mesh=None if isinstance(mesh, dict) else mesh,
            specs=psh, accum=accum)
        return Cell(cfg, shape, model, step, (aparams, aopt, batch),
                    (psh, osh, bsh), (psh, osh, repl), "train", accum)

    if shape.kind == "prefill":
        max_len = WHISPER_DECODER_LEN if cfg.is_encdec else shape.seq_len

        def prefill_step(params, batch):
            m = _serving_mesh(mesh, "prefill")
            if m is None:
                return model.prefill(params, batch, max_len)
            with shd.use_mesh(m):
                return model.prefill(shd.mesh_view(params, psh), batch,
                                     max_len, global_batch=B)

        acache = model.cache_shape(B, max_len, "meta", **(
            {"enc_len": shape.seq_len} if cfg.is_encdec else {}))
        lsh = shd.batch_pspec((B, cfg.vocab_size), mesh)
        return Cell(cfg, shape, model, prefill_step, (aparams, batch),
                    (psh, shd.batch_shardings(batch, mesh)),
                    (lsh, shd.cache_shardings(acache, mesh)), "prefill")

    # decode
    acache = model.cache_shape(
        B, WHISPER_DECODER_LEN if cfg.is_encdec else shape.seq_len, "meta",
        **({"enc_len": shape.seq_len} if cfg.is_encdec else {}))
    csh = shd.cache_shardings(acache, mesh)
    tokens = torch.empty((B, 1), dtype=torch.int32, device="meta")
    pos = torch.empty((), dtype=torch.int32, device="meta")

    def decode_step(params, cache, tokens, pos):
        m = _serving_mesh(mesh, "decode")
        if m is None:
            return model.decode_step(params, cache, tokens, pos)
        with shd.use_mesh(m):
            return model.decode_step(shd.mesh_view(params, psh),
                                     shd.mesh_view(cache, csh), tokens, pos)

    return Cell(cfg, shape, model, decode_step,
                (aparams, acache, tokens, pos),
                (psh, csh, shd.batch_pspec((B, 1), mesh), repl),
                (shd.batch_pspec((B, cfg.vocab_size), mesh), csh), "decode")


def decode_position(cell: Cell) -> int:
    """The position a decode cell's step writes: the cache's last (the
    encoder-decoder's decoder horizon's last)."""
    return (WHISPER_DECODER_LEN if cell.cfg.is_encdec
            else cell.shape.seq_len) - 1


def local_args(cell: Cell, mesh) -> tuple:
    """This rank's arguments of ``cell.step_fn`` on ``mesh`` (a
    ``DeviceMesh``), as ``meta`` tensors: its blocks of the abstract
    arguments under ``in_shardings``.  The params and the optimizer state
    are taken by ``sharding.shard_tree`` (the optimizer state's specs are
    ``_opt_shardings``': adafactor's factored statistics stay whole); a
    prefill's batch and a decode's cache and tokens by their specs.  A
    train step is handed the global batch and takes its rows itself
    (``local_rows``), so its batch stays whole.  A decode step gets a
    Python int position, ``decode_position``.  On a mesh of one device
    the arguments are the abstract ones."""
    args = list(cell.abstract_args)
    for i, spec in enumerate(cell.in_shardings):
        if shd.is_trivial(mesh) or (cell.kind == "train" and i == 2):
            continue
        args[i] = shd.local_shard(args[i], spec, mesh) \
            if isinstance(args[i], torch.Tensor) \
            else shd.shard_tree(args[i], spec, mesh)
    if cell.kind == "decode":
        args[3] = decode_position(cell)
    return tuple(args)


def _opt_shardings(aopt, aparams, psh, mesh):
    """Optimizer-state specs: a state leaf whose path *suffix* matches a
    parameter path and whose shape matches that parameter inherits the
    parameter's spec (so Adam's m/v are ZeRO-sharded exactly like the
    weights); factored/scalar stats are replicated."""
    specs = dict(shd.leaves_with_path(psh))
    pinfo = {path: (tuple(leaf.shape), specs[path])
             for path, leaf in shd.leaves_with_path(aparams)}

    def one(path, leaf):
        for i in range(len(path)):
            info = pinfo.get(path[i:])
            if info is not None and info[0] == tuple(leaf.shape):
                return info[1]
        return shd.replicated(mesh)
    return shd.map_with_path(one, aopt)
