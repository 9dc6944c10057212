"""Architecture registry of the port (port of ``repro.configs``).

``get_config(name)`` / ``get_smoke(name)`` return the published config (or
its reduced smoke twin); ``config_for_shape`` applies per-cell variants
(gemma3 + long_500k turns on the paper's landmark decode on the global
layers).  The port serves the dense attention family; its registry holds
gemma3-12b, and every other architecture of the reference is still to port
(ROADMAP A11).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import List

from repro_torch.configs.base import (  # noqa: F401
    LONG_CONTEXT_OK,
    SHAPES,
    ModelConfig,
    ShapeConfig,
)

_MODULES = {
    "gemma3-12b": "repro_torch.configs.gemma3_12b",
}

ARCHS: List[str] = list(_MODULES)


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(
            f"arch {name!r} is not in the port (ported: {ARCHS}); the rest "
            "of the reference's model registry is ROADMAP A11")
    return importlib.import_module(_MODULES[name])


def get_config(name: str) -> ModelConfig:
    return _module(name).FULL


def get_smoke(name: str) -> ModelConfig:
    return _module(name).SMOKE


def config_for_shape(cfg: ModelConfig, shape: ShapeConfig) -> ModelConfig:
    """Per-cell config variants: long_500k on gemma3 decodes its global
    layers through the paper's landmark (fast-SPSD) attention, whose state
    is O(c) where the full KV cache of 500k tokens is quadratic-time to
    attend."""
    if shape.name == "long_500k" and cfg.name.startswith("gemma3"):
        return dataclasses.replace(cfg, use_landmark_decode=True)
    return cfg
