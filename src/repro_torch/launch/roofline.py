"""Kernel-layer roofline of the pairwise launches (port of the kernel half
of ``repro.launch.roofline``).

``pairwise_launch_model`` counts the work of ONE pairwise launch from its
shape and spec alone — the same count whatever implements it — and
``achieved_vs_roofline`` scores a measured launch against that work under a
``HardwareProfile``: roofline = max(flops / peak, bytes / bandwidth).  The
formulas and report keys are the reference's, so a report from either
package reads the same.

The reference's HLO half (``model_flops``, ``Roofline``/``finalize``,
``analyze``, ``hbm_bytes``, ``collective_bytes``, ``format_table``,
``main``) reads XLA's compiled modules and the model configs; it is not
ported here.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    """Peak rates the roofline terms divide by — a parameter, so a report
    names the hardware it models."""

    name: str
    peak_flops: float            # FLOP/s (dense matmul peak)
    hbm_bw: float                # bytes/s
    link_bw: float               # bytes/s per link, one direction


#: the reference's CI profile (order-of-magnitude host figures), kept under
#: its name and numbers so CPU reports match the reference's
CPU_INTERPRET = HardwareProfile("cpu-interpret", peak_flops=2e11,
                                hbm_bw=2e10, link_bw=1e10)

#: one H100 SXM, NVIDIA's data sheet, dense rates at the 700 W limit: the
#: bf16 tensor cores (the peak ``bf16_f32acc`` specs run at), HBM3, and
#: NVLink 4 in one direction
H100_SXM = HardwareProfile("h100-sxm", peak_flops=989e12, hbm_bw=3.35e12,
                           link_bw=450e9)

#: the same card at its TF32 tensor-core peak, for f32 specs
H100_SXM_TF32 = HardwareProfile("h100-sxm-tf32", peak_flops=494.7e12,
                                hbm_bw=3.35e12, link_bw=450e9)

#: the same card's FP32 rate outside the tensor cores (the CUDA cores), for
#: work that runs there (the direct l1 statistic, B6's f32 route)
H100_SXM_FP32 = HardwareProfile("h100-sxm-fp32", peak_flops=67e12,
                                hbm_bw=3.35e12, link_bw=450e9)


def default_profile() -> HardwareProfile:
    """``H100_SXM`` when the current CUDA device is an H100, else
    ``CPU_INTERPRET``."""
    if torch.cuda.is_available() and \
            "H100" in torch.cuda.get_device_name(torch.cuda.current_device()):
        return H100_SXM
    return CPU_INTERPRET


def pairwise_launch_model(spec, nr: int, nc: int, d: int, m_total: int,
                          l1_route: Optional[str] = None,
                          segments: int = 0) -> Dict[str, float]:
    """Analytic FLOP/byte model of ONE fused pairwise launch, split by unit.

    ``nr × nc`` kernel entries from (nr, d) × (nc, d) points, contracted
    against right-hand sides totalling ``m_total`` columns (0 for a block
    launch):

    - ``dot``      2d matrix-unit FLOPs/entry.
    - ``sqdist``   2d matrix-unit FLOPs/entry + O(1) vector combine (+ row
      norms).
    - ``l1dist``   route-dependent — 'mxu_signsplit' pays two contractions
      of inner dimension 2·d·B (B = ``segments``): 8·d·B matrix-unit
      FLOPs/entry plus O((nr+nc)·d·B) vector embedding; 'vpu_loop' pays
      ~4d vector FLOPs/entry (subtract, abs, accumulate, loop bookkeeping).

    The V contraction adds 2·m_total matrix-unit FLOPs/entry; ``entry_fn``
    is modeled at 8 vector FLOPs/entry.  Bytes are the perfect-fusion HBM
    floor: points + right-hand sides in, the contraction's outputs out —
    kernel tiles never touch HBM.  (So a block launch, ``m_total = 0``,
    counts only its points: the formula is the reference's, kept as is.)
    The keys keep the reference's names (``mxu_gflops``, ``vpu_gflops``).
    """
    entries = float(nr) * float(nc)
    stat = spec.stat
    if stat == "dot":
        mxu = 2.0 * d * entries
        vpu = 0.0
    elif stat == "sqdist":
        mxu = 2.0 * d * entries
        vpu = 4.0 * entries + 2.0 * (nr + nc) * d
    elif stat == "l1dist":
        if l1_route == "mxu_signsplit":
            inner = 2.0 * d * max(int(segments), 1)
            mxu = 2.0 * 2.0 * inner * entries          # two contractions
            vpu = 6.0 * (nr + nc) * inner              # the embeddings
        else:
            mxu = 0.0
            vpu = 4.0 * d * entries                    # the direct loop
    else:
        raise ValueError(f"unknown stat {stat!r}")
    mxu += 2.0 * float(m_total) * entries              # K-tile @ V
    vpu += 8.0 * entries                               # entry_fn
    point_bytes = 2 if getattr(spec, "precision", "f32") != "f32" else 4
    gbytes = ((nr + nc) * d * point_bytes
              + (nc + nr) * m_total * 4.0) / 1e9
    return {"mxu_gflops": mxu / 1e9, "vpu_gflops": vpu / 1e9,
            "hbm_gbytes": gbytes}


def achieved_vs_roofline(spec, shape, mesh=None, *, measured_s: float,
                         m_total: int, l1_route: Optional[str] = None,
                         segments: int = 0,
                         profile: Optional[HardwareProfile] = None) -> dict:
    """Score one measured pairwise launch against its modeled roofline.

    ``shape`` is ``(nr, nc, d)`` for the launch; ``mesh`` (an optional
    ``DeviceMesh``) divides the modeled work across its devices like the
    sharded sweep does.  Returns a JSON-ready report: modeled compute and
    memory seconds under ``profile`` (``default_profile()`` when omitted),
    the binding term, and ``achieved_frac`` = roofline_s / measured_s (1.0
    means the launch runs at the modeled roof).
    """
    prof = default_profile() if profile is None else profile
    nr, nc, d = (int(x) for x in shape)
    chips = 1 if mesh is None else max(1, int(mesh.size()))
    model = pairwise_launch_model(spec, nr, nc, d, m_total,
                                  l1_route=l1_route, segments=segments)
    compute_s = (model["mxu_gflops"] + model["vpu_gflops"]) * 1e9 / (
        chips * prof.peak_flops)
    memory_s = model["hbm_gbytes"] * 1e9 / (chips * prof.hbm_bw)
    roofline_s = max(compute_s, memory_s)
    return {
        "kernel": spec.name,
        "stat": spec.stat,
        "precision": getattr(spec, "precision", "f32"),
        "l1_route": l1_route,
        "shape": [nr, nc, d],
        "m_total": int(m_total),
        "chips": chips,
        "profile": prof.name,
        **{k: float(v) for k, v in model.items()},
        "compute_s": float(compute_s),
        "memory_s": float(memory_s),
        "bottleneck": "compute" if compute_s >= memory_s else "memory",
        "roofline_s": float(roofline_s),
        "measured_s": float(measured_s),
        "achieved_frac": float(roofline_s / measured_s)
        if measured_s > 0 else 0.0,
    }
