"""The port's configs registry held against the reference's: the archs in
the reference's order, each arch's input shapes (``shapes_for``), every
(arch, shape) cell (``cells``), and the shapes and dtypes of every cell's
model inputs (``input_specs``: the port's ``TensorSpec`` against the
reference's ``jax.ShapeDtypeStruct``).  Nothing is allocated on either
side.
"""
from __future__ import annotations

import dataclasses

import jax
import pytest
import torch

from repro import configs as jconfigs
from repro_torch import configs as tconfigs
from repro_torch.configs.base import TensorSpec

CELLS = [(a, s.name) for a, s in jconfigs.cells()]


def _dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


def test_archs_are_the_reference_archs_in_its_order():
    assert tconfigs.ARCHS == jconfigs.ARCHS
    assert len(tconfigs.ARCHS) == 10 and "whisper-large-v3" in tconfigs.ARCHS
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_smoke("no-such-arch")


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_configs_and_shapes_for_match_the_reference(arch):
    for jc, tc in ((jconfigs.get_config(arch), tconfigs.get_config(arch)),
                   (jconfigs.get_smoke(arch), tconfigs.get_smoke(arch))):
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc), arch
    got = [dataclasses.astuple(s) for s in tconfigs.shapes_for(arch)]
    assert got == [dataclasses.astuple(s) for s in jconfigs.shapes_for(arch)]
    assert ("long_500k" in [s[0] for s in got]) == \
        (arch in tconfigs.LONG_CONTEXT_OK)


def test_cells_match_the_reference():
    got = [(a, dataclasses.astuple(s)) for a, s in tconfigs.cells()]
    ref = [(a, dataclasses.astuple(s)) for a, s in jconfigs.cells()]
    assert got == ref and len(got) == 33


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_the_reference(arch, shape):
    """Every input of the cell, for the published config (with the cell's
    variant, ``config_for_shape``) and its SMOKE twin: the same names,
    shapes and dtypes."""
    for get in ("get_config", "get_smoke"):
        jc = jconfigs.config_for_shape(getattr(jconfigs, get)(arch),
                                       jconfigs.SHAPES[shape])
        tc = tconfigs.config_for_shape(getattr(tconfigs, get)(arch),
                                       tconfigs.SHAPES[shape])
        ref = jconfigs.input_specs(jc, jconfigs.SHAPES[shape])
        got = tconfigs.input_specs(tc, tconfigs.SHAPES[shape])
        assert list(got) == list(ref)
        for name, spec in got.items():
            assert isinstance(spec, TensorSpec)
            assert isinstance(spec.dtype, torch.dtype)
            r = ref[name]
            assert isinstance(r, jax.ShapeDtypeStruct)
            assert tuple(spec.shape) == tuple(r.shape), (name, spec, r)
            assert _dtype_name(spec.dtype) == _dtype_name(r.dtype), name


def test_encoder_decoder_input_specs():
    """whisper's cells: S frames of frontend_dim and a decoder of S // 8
    tokens to train, one decoder token to prefill, one token and its
    position to decode (the cache is built apart)."""
    cfg = tconfigs.get_config("whisper-large-v3")
    sh = tconfigs.SHAPES
    train = tconfigs.input_specs(cfg, sh["train_4k"])
    assert train["frames"] == TensorSpec((256, 4096, 128), torch.bfloat16)
    assert train["tokens"] == train["labels"] == TensorSpec((256, 512),
                                                            torch.int32)
    pre = tconfigs.input_specs(cfg, sh["prefill_32k"])
    assert pre == {"frames": TensorSpec((32, 32_768, 128), torch.bfloat16),
                   "tokens": TensorSpec((32, 1), torch.int32)}
    dec = tconfigs.input_specs(cfg, sh["decode_32k"])
    assert dec == {"tokens": TensorSpec((128, 1), torch.int32),
                   "pos": TensorSpec((), torch.int32)}
    assert [s.name for s in tconfigs.shapes_for("whisper-large-v3")] == \
        ["train_4k", "prefill_32k", "decode_32k"]
