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
    """Slice ``r`` of every leaf's leading axis."""
    if isinstance(tree, dict):
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
