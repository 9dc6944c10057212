"""Checkpoint store of the port, in the reference's on-disk layout."""
from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    CheckpointCorruptionError,
    CheckpointManager,
    committed_steps,
    gc_tmp,
    latest_step,
    remove_step,
    restore,
    restore_tree,
    save,
    step_leaf_paths,
)
