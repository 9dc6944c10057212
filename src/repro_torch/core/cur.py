"""CUR matrix decomposition (port of ``repro.core.cur``, the U matrices).

Given A (m×n), C = c columns, R = r rows:

- optimal:    U* = C† A R†                              (Eq. 8)
- drineas08:  U  = (P_Rᵀ A P_C)†                        (Fig. 2c baseline)
- fast:       Ũ  = (S_Cᵀ C)† (S_Cᵀ A S_R) (R S_R)†      (Eq. 9)

``fast_cur``, ``select_cur_sketches`` and ``blocked_right_sketch`` are not
ported yet.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.leverage import pinv

_F32 = torch.float32


class CURApprox(NamedTuple):
    C: torch.Tensor                              # (m, c)
    U: torch.Tensor                              # (c, r)
    R: torch.Tensor                              # (r, n)
    col_indices: Optional[torch.Tensor] = None
    row_indices: Optional[torch.Tensor] = None

    def dense(self) -> torch.Tensor:
        return self.C @ self.U @ self.R


def optimal_U(A: torch.Tensor, C: torch.Tensor,
              R: torch.Tensor) -> torch.Tensor:
    return pinv(C) @ A.to(_F32) @ pinv(R)


def drineas08_U(A: torch.Tensor, cidx, ridx) -> torch.Tensor:
    """U = (P_Rᵀ A P_C)† — the poor-quality baseline of Fig. 2(c)."""
    cidx = torch.as_tensor(cidx, dtype=torch.int64, device=A.device)
    ridx = torch.as_tensor(ridx, dtype=torch.int64, device=A.device)
    return pinv(A[ridx][:, cidx])                 # (c, r)


def fast_U_cur(ScC: torch.Tensor, ScASr: torch.Tensor,
               RSr: torch.Tensor) -> torch.Tensor:
    """Ũ = (S_Cᵀ C)† (S_Cᵀ A S_R) (R S_R)†  (Eq. 9)."""
    return pinv(ScC) @ ScASr.to(_F32) @ pinv(RSr)
