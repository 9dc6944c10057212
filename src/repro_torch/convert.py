"""State carried across from the reference.

The kernel methods have no weights: their state is the data, the kernel
spec and the random draws.  The model stack has weights and decode caches.
These helpers build the port's objects from numpy arrays (as the
reference's arrays convert with ``np.asarray``), so both sides compute the
same thing from the same numbers, and hand the port's caches back in the
reference's layout for comparison.  A served kernel model's state is its
artifact: ``artifact_from_reference`` takes the reference's artifact tree
or a store the reference committed.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from repro_torch.core import sketch as sk
from repro_torch.core.kernelop import PairwiseKernel
from repro_torch.core.sketched_attention import LandmarkState
from repro_torch.core.spsd import SPSDApprox
from repro_torch.device import resolve_device
from repro_torch.kernels.pairwise import specs
from repro_torch.serve import artifact as art_lib


def operator_from_reference(X: np.ndarray, spec_name: str,
                            params: Optional[dict] = None,
                            precision: str = "f32", device=None,
                            use_kernel: bool = True) -> PairwiseKernel:
    """``PairwiseKernel`` over the reference's data and spec parameters (a
    reference spec's ``dict(spec.params)`` passes as ``params``)."""
    spec = specs.get_spec(spec_name, **(params or {})).with_precision(
        precision)
    return PairwiseKernel(np.array(X, np.float32), spec,
                          use_kernel=use_kernel, device=device)


def sketch_from_reference(kind: str, n: int, *, mat=None, indices=None,
                          scales=None, device=None):
    """The reference's sketch draws as a port sketch: ``mat`` (n × s, already
    divided by sqrt(s)) for ``kind="gaussian"``; ``indices`` and ``scales``
    for ``"uniform"``/``"leverage"`` column sketches."""
    device = resolve_device(device)
    if kind == "gaussian":
        return sk.GaussianSketch(torch.as_tensor(np.array(mat, np.float32),
                                                 device=device))
    if kind in ("uniform", "leverage"):
        return sk.ColumnSketch(
            torch.as_tensor(np.array(indices, np.int64), device=device),
            torch.as_tensor(np.array(scales, np.float32), device=device),
            n)
    raise ValueError(f"sketch_from_reference: unsupported kind {kind!r}")


def approx_from_reference(C, U, P_indices=None, device=None) -> SPSDApprox:
    """A reference ``SPSDApprox`` (C, U, P_indices) as the port's."""
    device = resolve_device(device)
    P = None if P_indices is None else torch.as_tensor(
        np.array(P_indices, np.int64), device=device)
    return SPSDApprox(
        C=torch.as_tensor(np.array(C, np.float32), device=device),
        U=torch.as_tensor(np.array(U, np.float32), device=device),
        P_indices=P)


def landmark_state_from_reference(k_land, UV, U1, scale, device=None):
    """A reference ``LandmarkState`` (k_land, UV, U1, scale as numpy) as
    the port's, in f32 (bf16 values widen exactly)."""
    device = resolve_device(device)

    def f32(x):
        return torch.as_tensor(np.array(x, np.float32), device=device)

    return LandmarkState(k_land=f32(k_land), UV=f32(UV), U1=f32(U1),
                         scale=f32(scale).reshape(()))


def artifact_from_reference(tree_or_dir, device=None):
    """The reference's ``KernelModelArtifact`` as the port's: from its tree
    (``repro.serve.artifact_to_tree``'s dict, leaves as numpy) or from a
    store directory the reference committed (the checkpoint layout is
    shared; the latest step is restored, a delta chain replayed)."""
    if isinstance(tree_or_dir, (str, os.PathLike)):
        artifact = art_lib.load_artifact(os.fspath(tree_or_dir),
                                         device=device)
        if artifact is None:
            raise FileNotFoundError(
                f"no committed artifact in {tree_or_dir}")
        return artifact
    return art_lib.artifact_from_tree(tree_or_dir, device=device)


# ---------------------------------------------------------------------------
# model parameters and decode caches
# ---------------------------------------------------------------------------

def _tree_to_torch(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to_torch(v, device) for v in tree]
    arr = np.array(tree)
    if arr.dtype.name == "bfloat16":      # ml_dtypes' bf16: exact via f32
        return torch.as_tensor(arr.astype(np.float32),
                               device=device).to(torch.bfloat16)
    return torch.as_tensor(arr, device=device)


def _unstack(tree, r: int):
    """Slice ``r`` of every leaf's leading axis.  Adafactor's statistics
    of a stacked vector (a row statistic (layers,) beside a column
    statistic (d,); a stacked matrix's row statistic has two axes) give
    each layer its row entry and the whole column statistic."""
    if isinstance(tree, dict):
        if set(tree) == {"r", "c"} and np.ndim(tree["r"]) == 1:
            return {"r": np.asarray(tree["r"])[r], "c": tree["c"]}
        return {k: _unstack(v, r) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_unstack(v, r) for v in tree]
    return np.asarray(tree)[r]


def _stack_from_reference(stack: dict, cfg) -> dict:
    """A reference stack's superblocks as a list of per-rep lists: stacked
    on a leading ``reps`` axis when ``cfg.scan_layers`` (its ``init_stack``
    vmaps them), a list of per-rep tuples otherwise."""
    from repro_torch.models.transformer import stack_layout
    _, _, reps, _ = stack_layout(cfg)
    scanned = stack["scanned"]
    if reps == 0:
        scanned = []
    elif cfg.scan_layers:
        scanned = [_unstack(scanned, r) for r in range(reps)]
    return {"prefix": stack["prefix"], "scanned": scanned,
            "remainder": stack["remainder"]}


def model_params_from_reference(params, cfg, device=None) -> dict:
    """The reference model's params pytree (leaves as numpy, or anything
    ``np.asarray`` takes) as the port's params, in the reference's dtypes
    (bf16 leaves, as deepseek's ``param_dtype`` makes them, stay bf16).

    A stack's superblocks become a list of per-rep lists, however the
    reference stores them (``_stack_from_reference``).  Everything else
    carries over as it is: the prefix blocks (deepseek's dense first
    layers), the MoE banks ((E, d, ff) / (E, ff, d), the f32 router, the
    shared MLP), MLA's projections, the recurrent mixers' weights (RG-LRU's
    f32 ``lam``, mLSTM's and sLSTM's gate weights) and the ``"mtp"``
    sub-tree.  An encoder-decoder's ``encoder`` follows ``cfg.scan_layers``;
    its ``decoder`` is always stored stacked and its ``xattn`` always
    vmapped, on a leading axis of ``n_dec_layers``, which becomes a list of
    per-layer dicts.
    """
    device = resolve_device(device)
    if cfg.is_encdec:
        from repro_torch.models.model import _dec_cfg, _enc_cfg
        out = dict(params)
        out["encoder"] = _stack_from_reference(params["encoder"],
                                               _enc_cfg(cfg))
        out["decoder"] = _stack_from_reference(params["decoder"],
                                               _dec_cfg(cfg))
        out["xattn"] = [_unstack(params["xattn"], r)
                        for r in range(cfg.n_dec_layers)]
        return _tree_to_torch(out, device)
    out = dict(params)
    out["stack"] = _stack_from_reference(params["stack"], cfg)
    return _tree_to_torch(out, device)


def _tree_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return tuple(_tree_to_numpy(v) for v in tree)
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def cache_to_reference(cache: dict, cfg) -> dict:
    """The port's decode cache in the reference's layout, as numpy (bf16
    widened to f32): ``{"prefix": (...), "scanned": (per pattern slot, each
    leaf stacked on a leading reps axis), "remainder": (...)}``; each
    layer's entry keeps its names (``k``/``v``, the landmark factors, MLA's
    latent ``ckv`` and ``krope``, or a recurrent mixer's state: RG-LRU
    ``h``/``conv``, mLSTM ``C``/``n``/``m``, sLSTM ``c``/``n``/``h``/``m``).
    An encoder-decoder's cache is already laid out as the reference's
    ``_encdec_cache``: ``{"self": {"k", "v"}, "enc_kv": (k, v)}``, stacked
    on the decoder's layer axis."""
    if cfg.is_encdec:
        return _tree_to_numpy(cache)
    from repro_torch.models.transformer import stack_layout
    _, pattern, reps, _ = stack_layout(cfg)
    scanned = None
    if reps > 0:
        per_rep = [_tree_to_numpy(c) for c in cache["scanned"]]

        def stack(*leaves):
            return np.stack(leaves)

        scanned = tuple(
            {name: stack(*(per_rep[r][i][name] for r in range(reps)))
             for name in per_rep[0][i]}
            for i in range(len(pattern)))
    return {"prefix": _tree_to_numpy(cache["prefix"]), "scanned": scanned,
            "remainder": _tree_to_numpy(cache["remainder"])}


# ---------------------------------------------------------------------------
# train state: gradients, optimizer states, reference checkpoints
# ---------------------------------------------------------------------------

def _stats_shapes(shape: tuple) -> list:
    """The statistics ``optim.adafactor`` may keep for a parameter of
    ``shape``: factored over the trailing two dims of a matrix; a vector's
    unfactored, or factored across its stack of layers."""
    if len(shape) >= 2 and min(shape[-2:]) >= 2:
        return [{"r": shape[:-1], "c": shape[:-2] + shape[-1:]}]
    if len(shape) == 1 and shape[0] >= 2:
        return [{"v": shape}, {"r": (), "c": shape}]
    return [{"v": shape}]


def _to_port_layout(ref, like):
    """``ref``, a tree in the reference's layout (numpy leaves; a node at a
    parameter's place may be a dict of Adafactor statistics), laid out as
    the port's params ``like``: stacked superblocks (``scan_layers``) and
    the vmapped cross-attention become per-layer lists.  Shapes are
    checked leaf by leaf."""
    if isinstance(like, torch.Tensor):
        shape = tuple(like.shape)
        if isinstance(ref, dict):
            got = {k: tuple(np.shape(v)) for k, v in ref.items()}
            if got not in _stats_shapes(shape):
                raise ValueError(
                    f"statistics {got} do not factor a parameter of shape "
                    f"{shape} as the port's adafactor does")
        elif tuple(np.shape(ref)) != shape:
            raise ValueError(f"leaf of shape {np.shape(ref)} where the "
                             f"port's parameter is {shape}")
        return ref
    if isinstance(like, dict):
        return {k: _to_port_layout(ref.get(k), v) for k, v in like.items()}
    if not like:
        return []
    if isinstance(ref, dict):                  # vmapped: one entry a layer
        return [_to_port_layout(_unstack(ref, r), like[r])
                for r in range(len(like))]
    if isinstance(like[0], list) and isinstance(ref[0], dict):
        # superblocks stacked per pattern slot -> per rep, per slot
        return [[_to_port_layout(_unstack(ref[i], r), like[r][i])
                 for i in range(len(like[r]))] for r in range(len(like))]
    return [_to_port_layout(a, b) for a, b in zip(ref, like)]


def _restack(trees):
    """Trees of one structure stacked leaf by leaf on a new leading axis;
    adafactor's statistics of a vector factored across the layers (a
    scalar row statistic each) keep one copy of the shared column one."""
    first = trees[0]
    if isinstance(first, dict) and set(first) == {"r", "c"} \
            and np.ndim(first["r"]) == 0:
        return {"r": np.stack([t["r"] for t in trees]), "c": first["c"]}
    if isinstance(first, dict):
        return {k: _restack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return tuple(_restack([t[i] for t in trees])
                     for i in range(len(first)))
    return np.stack(trees)


def _stack_to_reference(stack, cfg):
    from repro_torch.models.transformer import stack_layout
    _, pattern, reps, _ = stack_layout(cfg)
    scanned = stack["scanned"]
    if reps == 0:
        scanned = ()
    elif cfg.scan_layers:                      # one stacked tree a slot
        scanned = tuple(_restack([rep[i] for rep in scanned])
                        for i in range(len(pattern)))
    else:                                      # a list of per-rep tuples
        scanned = [tuple(rep) for rep in scanned]
    return {"prefix": tuple(stack["prefix"]), "scanned": scanned,
            "remainder": tuple(stack["remainder"])}


def params_to_reference(tree, cfg) -> dict:
    """A tree with the port's params structure (params, a gradient, an
    optimizer moment; at a parameter's place also a dict of statistics) in
    the reference's layout, as numpy (bf16 widened to f32): the inverse of
    ``model_params_from_reference``."""
    out = dict(_tree_to_numpy(tree))
    if cfg.is_encdec:
        from repro_torch.models.model import _dec_cfg, _enc_cfg
        out["encoder"] = _stack_to_reference(out["encoder"], _enc_cfg(cfg))
        out["decoder"] = _stack_to_reference(out["decoder"], _dec_cfg(cfg))
        out["xattn"] = _restack(list(out["xattn"]))
    else:
        out["stack"] = _stack_to_reference(out["stack"], cfg)
    return out


def opt_state_from_reference(opt_state, params_like, device=None):
    """The reference's ``OptState`` (``step``, ``inner``; leaves as
    anything ``np.asarray`` takes) as the port's, laid out as the port's
    params ``params_like``: adamw's ``m``/``v``, lion's ``m``, adafactor's
    ``stats`` (factored ``r``/``c`` or ``v`` per parameter) and bf16
    ``m``.  The reference's gradient trees have the params' structure and
    convert with ``model_params_from_reference``."""
    from repro_torch.optim import OptState
    device = resolve_device(device)
    inner = {name: _tree_to_torch(_to_port_layout(sub, params_like), device)
             for name, sub in opt_state.inner.items()}
    step = torch.as_tensor(np.array(opt_state.step), device=device)
    return OptState(step=step.to(torch.int32), inner=inner)


def opt_state_to_reference(opt_state, cfg):
    """The port's ``OptState`` in the reference's layout, as numpy (a bf16
    moment widened to f32): ``OptState(step, inner)``, which the
    reference's ``OptState(*...)`` takes."""
    from repro_torch.optim import OptState
    return OptState(
        step=opt_state.step.detach().cpu().numpy(),
        inner={name: params_to_reference(sub, cfg)
               for name, sub in opt_state.inner.items()})


def _sequences(tree):
    """A restored checkpoint tree with the reference's sequences back: a
    dict whose keys are all indices is a tuple, and a NamedTuple's fields
    (stored under ``.name``) are plain keys."""
    if not isinstance(tree, dict):
        return tree
    if tree and all(k.isdigit() for k in tree):
        return tuple(_sequences(tree[k]) for k in sorted(tree, key=int))
    return {k.lstrip("."): _sequences(v) for k, v in tree.items()}


def train_state_from_reference_checkpoint(directory: str, step: int,
                                          params_like, device=None):
    """(params, opt_state) of the train state the reference's trainer
    committed (``{"params": params, "opt": OptState}``) at ``step`` in
    ``directory``, in the port's layout on ``device``: the shared store is
    read by the port's ``checkpoint.restore_tree``."""
    from repro_torch.checkpoint import restore_tree
    from repro_torch.optim import OptState
    device = resolve_device(device)
    tree = _sequences(restore_tree(os.fspath(directory), step))
    params = _tree_to_torch(_to_port_layout(tree["params"], params_like),
                            device)
    opt = tree["opt"]
    return params, opt_state_from_reference(
        OptState(step=opt["step"], inner=opt["inner"]), params_like, device)
