"""Architecture registry of the port (port of ``repro.configs``).

``get_config(name)`` / ``get_smoke(name)`` return the published config (or
its reduced smoke twin); ``config_for_shape`` applies per-cell variants
(gemma3 + long_500k turns on the paper's landmark decode on the global
layers).  The registry holds the seven decoder-only attention archs the port
serves: the dense ones (gemma3-12b, yi-6b, yi-9b, minitron-4b,
chameleon-34b with early fusion) and the MoE ones (qwen2-moe-a2.7b,
deepseek-v3-671b with MLA).  The recurrent archs (xlstm-125m,
recurrentgemma-2b) and the encoder-decoder (whisper-large-v3) are still to
port (ROADMAP A11-rest.3-4), as are ``shapes_for`` / ``cells`` (A11-rest.6).
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
    "minitron-4b": "repro_torch.configs.minitron_4b",
    "yi-9b": "repro_torch.configs.yi_9b",
    "yi-6b": "repro_torch.configs.yi_6b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2_7b",
    "chameleon-34b": "repro_torch.configs.chameleon_34b",
}

ARCHS: List[str] = list(_MODULES)


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(
            f"arch {name!r} is not in the port (ported: {ARCHS}); the "
            "recurrent and encoder-decoder archs are ROADMAP A11-rest.3-4")
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
