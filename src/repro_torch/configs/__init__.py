"""Architecture registry of the port (port of ``repro.configs``).

``get_config(name)`` / ``get_smoke(name)`` return the published config (or
its reduced smoke twin); ``config_for_shape`` applies per-cell variants
(gemma3 + long_500k turns on the paper's landmark decode on the global
layers); ``shapes_for(name)`` lists an arch's input shapes and ``cells()``
every (arch, shape) cell, honouring the long_500k skip rule for the pure
full-attention archs; ``input_specs(cfg, shape)`` gives the shapes and
dtypes of a cell's model inputs.  The registry holds the reference's ten
archs in its order: the dense ones (gemma3-12b, yi-6b, yi-9b,
minitron-4b, chameleon-34b with early fusion), the MoE ones
(qwen2-moe-a2.7b, deepseek-v3-671b with MLA), the recurrent ones
(xlstm-125m: mLSTM and sLSTM; recurrentgemma-2b: RG-LRU with local
attention) and the encoder-decoder whisper-large-v3.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Iterator, List, Tuple

from repro_torch.configs.base import (  # noqa: F401
    LONG_CONTEXT_OK,
    SHAPES,
    ModelConfig,
    ShapeConfig,
    TensorSpec,
    input_specs,
)

_MODULES = {
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
    "gemma3-12b": "repro_torch.configs.gemma3_12b",
    "minitron-4b": "repro_torch.configs.minitron_4b",
    "yi-9b": "repro_torch.configs.yi_9b",
    "yi-6b": "repro_torch.configs.yi_6b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2_7b",
    "chameleon-34b": "repro_torch.configs.chameleon_34b",
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
}

ARCHS: List[str] = list(_MODULES)


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; one of {ARCHS}")
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


def shapes_for(name: str) -> List[ShapeConfig]:
    """The input shapes of an arch: all four, but long_500k only for the
    archs with a sub-quadratic path (``LONG_CONTEXT_OK``)."""
    return [s for s in SHAPES.values()
            if s.name != "long_500k" or name in LONG_CONTEXT_OK]


def cells() -> Iterator[Tuple[str, ShapeConfig]]:
    for a in ARCHS:
        for s in shapes_for(a):
            yield a, s
