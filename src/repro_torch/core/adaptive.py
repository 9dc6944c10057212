"""uniform+adaptive² column selection (port of ``repro.core.adaptive``).

Round 0: c/3 columns uniformly.  Rounds 1-2: c/3 columns each, sampled with
probability proportional to the squared residual column norms
||k_:j − C C† k_:j||² of the current sketch — one panel sweep per round.
The implementation is ``selection.UniformAdaptive2Policy``; this module
keeps the historical entry points.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import selection as selection_lib
from repro_torch.core.selection import (_masked_orthonormal_basis,  # noqa: F401
                                        residual_column_norms)


def _residual_column_norms(Kop, idx: torch.Tensor,
                           block_size: Optional[int] = None,
                           mesh=None) -> torch.Tensor:
    """||(I − C C†) K||² column norms in one panel sweep."""
    return residual_column_norms(Kop, idx, block_size=block_size, mesh=mesh)


def uniform_adaptive2_indices(K, c: int, block_size: Optional[int] = None,
                              generator: Optional[torch.Generator] = None,
                              mesh=None) -> torch.Tensor:
    """Return c distinct column indices via uniform + two adaptive rounds."""
    return selection_lib.UniformAdaptive2Policy().select(
        K, c, generator=generator, block_size=block_size, mesh=mesh)
