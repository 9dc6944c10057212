"""Public entry point of the fused landmark read (port of
``repro.kernels.landmark_attention.ops``).

The device of Q picks the route: the plain version on the CPU, the CUDA
kernel on the card (see ``kernel``), the output's shape alone on
``meta``.  Any m goes straight to the kernel, which masks its own ragged
rows: nothing is padded to the TPU's 128-row tiles.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.landmark_attention import kernel as _k

_F32 = torch.float32


def landmark_read(Q: torch.Tensor, k_land: torch.Tensor, UV: torch.Tensor,
                  U1: torch.Tensor, offset, eps: float = 1e-6
                  ) -> torch.Tensor:
    """Attend Q (m, d) to a prebuilt landmark state -> (m, dv) in Q's
    dtype.  ``offset`` is a scalar (a one-element tensor stays on its
    device, so the read costs no sync).  One call of the custom op
    ``repro_torch::landmark_read`` (``kernel.landmark_read_op``)."""
    off = torch.as_tensor(offset, dtype=_F32, device=Q.device).reshape(1)
    return _k.landmark_read_op(Q, k_land, UV, U1, off, eps)
