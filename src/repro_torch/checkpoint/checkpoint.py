"""Atomically committed checkpoints with retention (port of
``repro.checkpoint.checkpoint``).

The on-disk layout is the reference's, so a store either package wrote
restores in the other:

    <dir>/step_000000100.tmp/        # written first
        shard_00000_of_00001.npz     # this host's leaves, keys leaf_%05d
        manifest.json                # leaf key -> path, shape, dtype
    <dir>/step_000000100/            # atomic rename after both are fsync'd

Trees are nested dicts, lists and tuples of arrays (torch tensors, numpy
arrays, or anything ``np.asarray`` takes, a string included); a bf16
tensor is stored widened to f32.  A leaf's path is its keys and indices
joined with ``/`` (``"heads/krr"``,
``"a/0"``), with dict keys visited in sorted order, as ``jax.tree_util``
flattens them; a ``None`` is an empty subtree.  Restores return numpy
arrays on the host; callers move them to their device.

- **Atomic commit**: the rename happens only after the shard and the
  manifest are fsync'd, so a crash mid-write never damages the latest
  checkpoint (the ``.tmp`` dir is ignored and removed by ``gc_tmp``).
- **Retention**: ``CheckpointManager`` keeps the last ``keep`` checkpoints
  plus every multiple of ``keep_period``.
- **Async commit**: ``CheckpointManager.save(blocking=False)`` writes on a
  background thread; ``join()`` waits for it.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch


class CheckpointCorruptionError(RuntimeError):
    """A checkpoint directory exists but cannot be read back faithfully.

    Raised for file-level damage — a missing or truncated ``manifest.json``,
    missing shard files, an undecodable npz — as opposed to the
    ``KeyError`` / ``ValueError`` a healthy checkpoint raises when it does
    not match the requested ``like`` structure.  The serving path's
    recompute-on-corruption hook (``runtime.fault_tolerance
    .ArtifactRecovery``) catches exactly this type.
    """


def _to_host(leaf) -> np.ndarray:
    """A leaf as a host array; a bf16 tensor is widened to f32, exactly
    (numpy has no bf16), and narrows back exactly on restore."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf)


def _flat_with_paths(tree, prefix: Tuple[str, ...] = ()
                     ) -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in the reference's order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flat_with_paths(tree[k], prefix + (str(k),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flat_with_paths(v, prefix + (str(i),))
        return out
    return [("/".join(prefix), tree)]


def _unflatten_like(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten_like(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten_like(v, leaves) for v in like)
    return next(leaves)


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:09d}")


def save(directory: str, step: int, tree: Any,
         process_index: int = 0, process_count: int = 1) -> str:
    """Write one checkpoint synchronously; returns the committed path."""
    final = _step_dir(directory, step)
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)

    arrays, manifest = {}, {}
    for i, (path, leaf) in enumerate(_flat_with_paths(tree)):
        arr = _to_host(leaf)
        key = f"leaf_{i:05d}"
        arrays[key] = arr
        manifest[key] = {"path": path, "shape": list(arr.shape),
                         "dtype": str(arr.dtype)}

    shard = os.path.join(
        tmp, f"shard_{process_index:05d}_of_{process_count:05d}.npz")
    with open(shard, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    man = os.path.join(tmp, "manifest.json")
    with open(man, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())

    # single-host (and host 0 in multi-host after a barrier) commits
    if process_index == 0:
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    return final


def committed_steps(directory: str) -> list:
    """Step numbers whose directories are validly committed, ascending.

    Only entries that parse as ``step_<int>``, are not a ``.tmp`` write,
    are directories and hold a ``manifest.json`` count: a leftover tmp dir,
    a stray file named like a step or a half-deleted dir is never reported
    as the latest checkpoint.
    """
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if not name.startswith("step_") or name.endswith(".tmp"):
            continue
        try:
            step = int(name.split("_")[1])
        except (IndexError, ValueError):
            continue
        path = os.path.join(directory, name)
        if not os.path.isdir(path):
            continue
        if not os.path.isfile(os.path.join(path, "manifest.json")):
            continue
        steps.append(step)
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    steps = committed_steps(directory)
    return steps[-1] if steps else None


def _read_step_arrays(directory: str, step: int) -> dict:
    """{leaf path: array} of one committed step; file-level damage is a
    ``CheckpointCorruptionError``."""
    path = _step_dir(directory, step)
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        by_path = {}
        for name in sorted(os.listdir(path)):
            if not name.endswith(".npz"):
                continue
            with np.load(os.path.join(path, name)) as z:
                for key in z.files:
                    by_path[manifest[key]["path"]] = z[key]
    except (OSError, ValueError, KeyError, json.JSONDecodeError) as e:
        raise CheckpointCorruptionError(
            f"checkpoint step {step} at {path} is unreadable "
            f"({type(e).__name__}: {e})") from e
    if not by_path:
        raise CheckpointCorruptionError(
            f"checkpoint step {step} at {path} has no shard files")
    return by_path


def step_leaf_paths(directory: str, step: int) -> list:
    """Sorted leaf paths of a committed step, from the manifest alone (no
    array I/O): how a full artifact snapshot (``meta_json``) is told from
    an incremental delta (``delta_json``)."""
    path = _step_dir(directory, step)
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        return sorted(str(m["path"]) for m in manifest.values())
    except (OSError, ValueError, KeyError, TypeError,
            json.JSONDecodeError) as e:
        raise CheckpointCorruptionError(
            f"checkpoint step {step} at {path} has no readable manifest "
            f"({type(e).__name__}: {e})") from e


def remove_step(directory: str, step: int) -> None:
    """Delete one committed step directory (delta GC, compaction)."""
    shutil.rmtree(_step_dir(directory, step), ignore_errors=True)


def restore(directory: str, step: int, like: Any) -> Any:
    """Load a checkpoint into the structure of ``like`` (shapes must match
    leaf for leaf); leaves come back as numpy arrays."""
    by_path = _read_step_arrays(directory, step)
    out = []
    for pstr, leaf in _flat_with_paths(like):
        if pstr not in by_path:
            raise KeyError(f"checkpoint step {step} at {directory} is "
                           f"missing leaf {pstr!r}")
        arr = by_path[pstr]
        want = tuple(leaf.shape)
        if tuple(arr.shape) != want:
            raise ValueError(
                f"leaf {pstr!r}: checkpoint shape {arr.shape} != {want}")
        out.append(arr)
    return _unflatten_like(like, iter(out))


def restore_tree(directory: str, step: int) -> dict:
    """Load a checkpoint as nested string-keyed dicts, without a ``like``:
    the manifest records every leaf's path, so a fresh process that knows
    no stored shape (a replica warm-booting an artifact) rebuilds the tree
    from it.  Paths split on ``/``."""
    by_path = _read_step_arrays(directory, step)
    out: dict = {}
    for pstr, arr in by_path.items():
        node = out
        keys = pstr.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = arr
    return out


def gc_tmp(directory: str) -> int:
    """Remove orphaned .tmp dirs (a crash mid-write); returns the count."""
    if not os.path.isdir(directory):
        return 0
    n = 0
    for name in os.listdir(directory):
        if name.endswith(".tmp"):
            shutil.rmtree(os.path.join(directory, name), ignore_errors=True)
            n += 1
    return n


def _host_tree(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_tree(v) for v in tree)
    return _to_host(tree)


class CheckpointManager:
    """save/restore + retention + async commit."""

    def __init__(self, directory: str, keep: int = 3, keep_period: int = 0,
                 process_index: int = 0, process_count: int = 1):
        self.directory = directory
        self.keep = keep
        self.keep_period = keep_period
        self.process_index = process_index
        self.process_count = process_count
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)
        gc_tmp(directory)

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: Any, blocking: bool = True):
        self.join()                                  # one in flight at a time
        host_tree = _host_tree(tree)

        def work():
            save(self.directory, step, host_tree,
                 self.process_index, self.process_count)
            self._retain()

        if blocking:
            work()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def join(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # -- restore --------------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        return latest_step(self.directory)

    def restore(self, step: int, like: Any) -> Any:
        return restore(self.directory, step, like)

    def restore_latest(self, like: Any):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, like)

    # -- retention ------------------------------------------------------------

    def _retain(self):
        if self.process_index != 0:
            return
        # the validity filter of latest_step: junk entries neither crash
        # retention nor shift which real checkpoints are kept
        steps = committed_steps(self.directory)
        doomed = steps[:-self.keep] if self.keep > 0 else []
        for s in doomed:
            if self.keep_period and s % self.keep_period == 0:
                continue
            shutil.rmtree(_step_dir(self.directory, s), ignore_errors=True)
