"""The port's checkpoint store (``repro_torch.checkpoint``) held to the
reference's (``repro.checkpoint``): every behaviour of
``tests/test_checkpoint.py`` as a port case, and the shared on-disk layout
— a store either package writes restores in the other, leaf for leaf and
bit for bit, with the same paths and the same manifest."""
from __future__ import annotations

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro_torch import checkpoint as ckpt
from repro_torch.checkpoint import (
    CheckpointCorruptionError,
    CheckpointManager,
    gc_tmp,
    latest_step,
    restore,
    restore_tree,
    save,
)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "heads": {"krr": rng.standard_normal((3, 1)).astype(np.float32),
                      "kpca": rng.standard_normal((3, 2)).astype(np.float32)},
            "meta_json": np.asarray("hello")}


def _torch_tree(seed=0):
    t = _tree(seed)
    return {"w": torch.from_numpy(t["w"]),
            "heads": {k: torch.from_numpy(v) for k, v in t["heads"].items()},
            "meta_json": "hello"}


# ---------------------------------------------------------------------------
# latest_step / retention ignore junk entries
# ---------------------------------------------------------------------------

def test_latest_step_ignores_stale_tmp_dir(tmp_path):
    save(str(tmp_path), 5, _tree())
    os.makedirs(tmp_path / "step_000000777.tmp")
    assert latest_step(str(tmp_path)) == 5
    out = restore(str(tmp_path), 5, _tree())
    assert np.array_equal(out["w"], _tree()["w"])


def test_latest_step_ignores_stray_file_and_manifestless_dir(tmp_path):
    save(str(tmp_path), 3, _tree())
    (tmp_path / "step_000000888").write_text("not a checkpoint")
    os.makedirs(tmp_path / "step_000000555")
    assert latest_step(str(tmp_path)) == 3


def test_latest_step_concurrent_gc_tmp(tmp_path):
    save(str(tmp_path), 2, _tree())
    os.makedirs(tmp_path / "step_000000004.tmp")
    assert gc_tmp(str(tmp_path)) == 1
    assert latest_step(str(tmp_path)) == 2
    out = restore(str(tmp_path), 2, _tree())
    assert np.array_equal(out["heads"]["kpca"], _tree()["heads"]["kpca"])


def test_retain_survives_junk_entries(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    (tmp_path / "step_junkname").mkdir()
    (tmp_path / "step_000000999").write_text("stray file")
    for step in (1, 2, 3, 4):
        mgr.save(step, _tree(step))
    kept = sorted(n for n in os.listdir(tmp_path)
                  if n.startswith("step_00000000"))
    assert kept == ["step_000000003", "step_000000004"]
    assert latest_step(str(tmp_path)) == 4


def test_manager_async_save_and_torch_leaves(tmp_path):
    """``blocking=False`` commits on a thread that ``join`` waits for; torch
    tensors are written as their numpy values."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(7, _torch_tree(1), blocking=False)
    mgr.join()
    step, out = mgr.restore_latest(_tree(1))
    assert step == 7
    assert np.array_equal(out["w"], _tree(1)["w"])
    assert str(np.asarray(out["meta_json"]).item()) == "hello"


# ---------------------------------------------------------------------------
# restore_tree and corruption classification
# ---------------------------------------------------------------------------

def test_restore_tree_nested_roundtrip(tmp_path):
    tree = _tree(9)
    save(str(tmp_path), 0, tree)
    out = restore_tree(str(tmp_path), 0)
    assert set(out) == {"w", "heads", "meta_json"}
    assert set(out["heads"]) == {"krr", "kpca"}
    assert np.array_equal(out["w"], tree["w"])
    assert np.array_equal(out["heads"]["krr"], tree["heads"]["krr"])
    assert str(np.asarray(out["meta_json"]).item()) == "hello"


def test_truncated_manifest_raises_corruption_error(tmp_path):
    save(str(tmp_path), 1, _tree())
    (tmp_path / "step_000000001" / "manifest.json").write_text('{"leaf_')
    with pytest.raises(CheckpointCorruptionError):
        restore_tree(str(tmp_path), 1)
    with pytest.raises(CheckpointCorruptionError):
        restore(str(tmp_path), 1, _tree())


def test_missing_shards_raise_corruption_error(tmp_path):
    save(str(tmp_path), 1, _tree())
    step_dir = tmp_path / "step_000000001"
    for name in os.listdir(step_dir):
        if name.endswith(".npz"):
            os.remove(step_dir / name)
    with pytest.raises(CheckpointCorruptionError, match="no shard"):
        restore_tree(str(tmp_path), 1)


def test_healthy_mismatch_is_not_corruption(tmp_path):
    save(str(tmp_path), 1, _tree())
    bad_like = _tree()
    bad_like["w"] = np.zeros((2, 2), np.float32)
    with pytest.raises(ValueError, match="shape"):
        restore(str(tmp_path), 1, bad_like)
    bad_like = _tree()
    bad_like["extra"] = np.zeros((1,), np.float32)
    with pytest.raises(KeyError, match="missing leaf"):
        restore(str(tmp_path), 1, bad_like)


def test_corruption_error_is_runtime_error():
    assert issubclass(ckpt.CheckpointCorruptionError, RuntimeError)


def test_manifest_mapping_mismatch_is_corruption(tmp_path):
    save(str(tmp_path), 1, _tree())
    man = tmp_path / "step_000000001" / "manifest.json"
    with open(man) as f:
        manifest = json.load(f)
    manifest.pop(sorted(manifest)[0])
    man.write_text(json.dumps(manifest))
    with pytest.raises(CheckpointCorruptionError):
        restore_tree(str(tmp_path), 1)


# ---------------------------------------------------------------------------
# the shared layout: either package's store restores in the other
# ---------------------------------------------------------------------------

def _nested(seed=3):
    rng = np.random.default_rng(seed)
    return {"b": {"z": rng.standard_normal((2, 5)).astype(np.float32),
                  "a": rng.integers(0, 9, size=(4,)).astype(np.int32)},
            "a": [rng.standard_normal((3,)), np.float64(2.5)],
            "s": np.asarray("meta"), "skip": None}


def _manifest(path, step):
    with open(os.path.join(path, f"step_{step:09d}", "manifest.json")) as f:
        return json.load(f)


def test_same_layout_and_manifest_as_the_reference(tmp_path):
    """Leaf keys, paths (dict keys sorted, list indices, None dropped),
    shapes and dtypes equal the reference's for the same tree."""
    tree = _nested()
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jckpt.save(jdir, 4, tree)
    save(tdir, 4, tree)
    assert _manifest(jdir, 4) == _manifest(tdir, 4)
    assert sorted(os.listdir(os.path.join(jdir, "step_000000004"))) == \
        sorted(os.listdir(os.path.join(tdir, "step_000000004"))) == \
        ["manifest.json", "shard_00000_of_00001.npz"]
    assert ckpt.step_leaf_paths(tdir, 4) == jckpt.step_leaf_paths(jdir, 4)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_a_store_restores_in_the_other_package_bitwise(tmp_path, writer):
    tree = _nested(5)
    d = str(tmp_path)
    if writer == "reference":
        x = jnp.arange(6.0)
        jckpt.save(d, 2, {**tree, "x": x})
        out = restore_tree(d, 2)
        want = {**tree, "x": np.asarray(x)}
    else:
        save(d, 2, {**tree, "x": torch.arange(6.0)})
        out = jckpt.restore_tree(d, 2)
        want = {**tree, "x": np.arange(6.0, dtype=np.float32)}
    assert ckpt.committed_steps(d) == jckpt.committed_steps(d) == [2]
    flat_out = dict(ckpt.checkpoint._flat_with_paths(out))
    flat_want = dict(ckpt.checkpoint._flat_with_paths(want))
    assert set(flat_out) == set(flat_want)
    for k, v in flat_want.items():
        got = np.asarray(flat_out[k])
        v = np.asarray(v)
        assert got.dtype == v.dtype and np.array_equal(got, v), k
