"""The port's kernel roofline held against the reference's, float for float.

``repro.launch.roofline.pairwise_launch_model`` / ``achieved_vs_roofline``
and the port's take the same shapes, spec (by name, statistic and
precision), route and profile; their reports must be equal key for key,
every float bit for bit, under ``CPU_INTERPRET`` and under a profile
carrying the H100 numbers, for every registered spec, both precisions and
both ``l1_route``s.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.kernels.pairwise import specs as jspecs
from repro.launch import roofline as jroof
from repro_torch.kernels.pairwise import specs as tspecs
from repro_torch.launch import roofline as troof

NAMES = ("laplacian", "linear", "matern32", "polynomial", "rbf")
PRECISIONS = ("f32", "bf16_f32acc")
# (nr, nc, d, m_total): the main path's B1 and B2 launches, the
# statistic-only calibration gather, a serving bucket, and a small one
SHAPES = ((50_000, 50_000, 16, 1_064), (671, 50_000, 16, 0),
          (50_000, 128, 16, 0), (2_048, 200, 16, 209), (17, 33, 4, 1))
ROUTES = (("vpu_loop", 0), ("mxu_signsplit", 5))
H100_NUMBERS = dict(peak_flops=989e12, hbm_bw=3.35e12, link_bw=450e9)


def _profiles():
    return ((jroof.CPU_INTERPRET, troof.CPU_INTERPRET),
            (jroof.HardwareProfile("h100-sxm", **H100_NUMBERS),
             troof.H100_SXM),
            (jroof.HardwareProfile("h100-sxm-tf32", peak_flops=494.7e12,
                                   hbm_bw=3.35e12, link_bw=450e9),
             troof.H100_SXM_TF32))


def _specs(name, prec):
    return (jspecs.suggested_spec(name, 8).with_precision(prec),
            tspecs.suggested_spec(name, 8).with_precision(prec))


class _JaxMesh:
    """What the reference reads of a mesh: ``devices.size``."""
    devices = np.zeros((2, 2))


class _TorchMesh:
    """What the port reads of a ``DeviceMesh``: ``size()``."""

    @staticmethod
    def size():
        return 4


def test_profiles_carry_the_stated_numbers():
    assert troof.CPU_INTERPRET == troof.HardwareProfile(
        "cpu-interpret", **{k: getattr(jroof.CPU_INTERPRET, k)
                            for k in ("peak_flops", "hbm_bw", "link_bw")})
    assert (troof.H100_SXM.peak_flops, troof.H100_SXM.hbm_bw,
            troof.H100_SXM.link_bw) == (989e12, 3.35e12, 450e9)
    assert troof.H100_SXM_TF32.peak_flops == 494.7e12
    assert troof.H100_SXM_TF32.hbm_bw == troof.H100_SXM.hbm_bw
    assert troof.H100_SXM_FP32.peak_flops == 67e12


def test_default_profile_is_cpu_interpret_without_an_h100():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible; the CPU default is checked "
                    "where none is")
    assert troof.default_profile() is troof.CPU_INTERPRET


@pytest.mark.parametrize("name,want", [
    ("NVIDIA H100 80GB HBM3", "h100-sxm"), ("NVIDIA A100-SXM4-80GB",
                                            "cpu-interpret")])
def test_default_profile_reads_the_device_name(monkeypatch, name, want):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=None: name)
    assert troof.default_profile().name == want


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("prec", PRECISIONS)
@pytest.mark.parametrize("route,segments", ROUTES)
def test_launch_model_float_for_float(name, prec, route, segments):
    js, ts = _specs(name, prec)
    for nr, nc, d, m in SHAPES:
        want = jroof.pairwise_launch_model(js, nr, nc, d, m, l1_route=route,
                                           segments=segments)
        got = troof.pairwise_launch_model(ts, nr, nc, d, m, l1_route=route,
                                          segments=segments)
        assert got == want, (nr, nc, d, m)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("prec", PRECISIONS)
@pytest.mark.parametrize("route,segments", ROUTES)
def test_achieved_vs_roofline_float_for_float(name, prec, route, segments):
    js, ts = _specs(name, prec)
    for jp, tp in _profiles():
        for nr, nc, d, m in SHAPES:
            for measured in (0.0, 1e-4, 0.0859):
                kw = dict(measured_s=measured, m_total=m, l1_route=route,
                          segments=segments)
                want = jroof.achieved_vs_roofline(js, (nr, nc, d),
                                                  profile=jp, **kw)
                got = troof.achieved_vs_roofline(ts, (nr, nc, d),
                                                 profile=tp, **kw)
                assert got == want, (jp.name, nr, nc, d, m, measured)
                want4 = jroof.achieved_vs_roofline(
                    js, (nr, nc, d), _JaxMesh(), profile=jp, **kw)
                got4 = troof.achieved_vs_roofline(
                    ts, (nr, nc, d), _TorchMesh(), profile=tp, **kw)
                assert got4 == want4 and got4["chips"] == 4


def test_the_main_shapes_read_as_predicted():
    """B1 f32 at the main shape: ~5.43e12 flops, ~11.0 ms on the TF32
    tensor cores; a block launch counts no output bytes (the reference's
    formula, kept)."""
    rbf = tspecs.rbf(3.0)
    b1 = troof.achieved_vs_roofline(rbf, (50_000, 50_000, 16),
                                    measured_s=0.0859, m_total=1_064,
                                    profile=troof.H100_SXM_TF32)
    flops = (b1["mxu_gflops"] + b1["vpu_gflops"]) * 1e9
    assert abs(flops - 5.43e12) / 5.43e12 < 1e-3
    assert abs(b1["roofline_s"] - 0.01098) < 1e-4
    assert b1["bottleneck"] == "compute"
    b2 = troof.pairwise_launch_model(rbf, 671, 50_000, 16, 0)
    assert b2["hbm_gbytes"] * 1e9 == (671 + 50_000) * 16 * 4
