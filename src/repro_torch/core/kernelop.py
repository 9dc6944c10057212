"""Implicit SPSD operators with a streaming blockwise access protocol (port
of ``repro.core.kernelop``).

``SPSDOperator`` exposes the access patterns the fast model needs —
``columns(idx)`` (C = K P), ``block(ri, ci)`` (SᵀKS), ``diag()``,
``full()`` (small n only) — plus the streaming protocol: ``sweep(plans)``
(the single-pass panel engine of ``repro_torch.core.sweep``),
``map_row_panels``, ``matmat`` and ``frobenius_norm_sq``.  ``sweep``,
``matmat`` and ``frobenius_norm_sq`` take ``mesh=``: on a mesh of data
width above 1 every rank sweeps its share of the rows and the partial
results are all-reduced (``sweep.sweep_panels``).

``PairwiseKernel`` computes entries on the fly from the data for any
``KernelSpec``.  Every block it needs goes through the pairwise kernels of
``repro_torch.kernels.pairwise``: on a CUDA tensor that is the CUDA kernel,
on a CPU tensor its plain version.  ``use_kernel`` (the counterpart of the
reference's ``use_pallas``, on by default here) picks the route of
matmul-shaped sweeps: on, one fused multi-right-hand-side launch
('fused'), or on a wide mesh one row-slab launch per rank
('fused_sharded'); off, the panel route over explicit blocks ('panel').

Operators live on one device, the CUDA device unless the caller passes
``device=`` (``repro_torch.device.resolve_device``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core import sweep as sweep_lib
from repro_torch.device import resolve_device
from repro_torch.kernels.pairwise import ops as pw_ops
from repro_torch.kernels.pairwise import signsplit
from repro_torch.kernels.pairwise import specs as pairwise_specs
from repro_torch.kernels.pairwise.specs import KernelSpec


def _index(idx, device) -> torch.Tensor:
    return torch.as_tensor(idx, dtype=torch.int64, device=device)


class SPSDOperator:
    n: int
    device: torch.device

    # -- pointwise access ---------------------------------------------------

    def block(self, row_idx, col_idx) -> torch.Tensor:
        raise NotImplementedError

    def columns(self, idx) -> torch.Tensor:
        """K[:, idx] through a ``ColumnGatherPlan`` sweep over the selected
        columns: row indices exist only per panel, peak memory is O(b·c),
        and exactly the n·c requested entries are evaluated.  Operators with
        a cheaper direct form override this."""
        idx = _index(idx, self.device)
        c = idx.shape[0]
        (C,) = sweep_lib.sweep_panels(
            lambda rows: self.block(rows, idx), self.n, c,
            [sweep_lib.ColumnGatherPlan(
                torch.arange(c, device=self.device))],
            device=self.device)
        return C

    def full(self) -> torch.Tensor:
        raise NotImplementedError

    def diag(self) -> torch.Tensor:
        raise NotImplementedError

    # -- fused-sweep capability protocol (see sweep.sweep_operator) ---------

    @property
    def precision(self) -> str:
        return "f32"

    def supports_fused_matmat(self) -> bool:
        return False

    def fused_rows(self, row_idx, Vs):
        """[K[row_idx, :] @ V for V in Vs] in one fused launch (None -> all
        rows).  Only called when ``supports_fused_matmat()``."""
        raise NotImplementedError

    def supports_prefetch_slab(self) -> bool:
        """True when ``fused_slab`` answers a contiguous row slab with the
        slab addressed inside the launch (no gathered row copy)."""
        return False

    def fused_slab(self, start_row: int, slab_len: int, Vs):
        """[K[start:start+slab_len, :] @ V for V in Vs]; rows at indices
        ≥ n are clamp duplicates the caller must mask.  Only called when
        ``supports_prefetch_slab()``."""
        raise NotImplementedError

    def cross(self, Xq, Vs):
        """[K(Xq, ·) @ V for V in Vs] for out-of-sample query points."""
        raise NotImplementedError(
            f"{type(self).__name__} is not data-backed; out-of-sample "
            f"queries need a PairwiseKernel (or another operator that can "
            f"evaluate K(x_query, x_data) from raw points)")

    # -- streaming protocol -------------------------------------------------

    def sweep(self, plans: Sequence, block_size: Optional[int] = None,
              mesh=None):
        """Run the multi-product panel engine over this operator's rows
        (route chosen by ``sweep.sweep_operator``; ``mesh`` shards it)."""
        return sweep_lib.sweep_operator(self, plans, block_size=block_size,
                                        mesh=mesh)

    def map_row_panels(self, fn, block_size: Optional[int] = None):
        """``fn(panel, row_idx, valid)`` on consecutive (b × n) row panels,
        results stacked along a leading block axis."""
        n = self.n
        bs = sweep_lib.resolved_block_size(n, n, block_size)
        nblocks = -(-n // bs)
        cols = torch.arange(n, device=self.device)
        offsets = torch.arange(bs, device=self.device)
        outs = []
        for start in range(0, nblocks * bs, bs):
            idx = start + offsets
            valid = idx < n
            idx = torch.clamp(idx, max=n - 1)
            outs.append(fn(self.block(idx, cols), idx, valid))
        return torch.stack(outs)

    def matmat(self, V: torch.Tensor, block_size: Optional[int] = None,
               mesh=None) -> torch.Tensor:
        """K @ V without materializing K."""
        V2 = V if V.ndim == 2 else V[:, None]
        (out,) = self.sweep([sweep_lib.MatmulPlan(V2)], block_size=block_size,
                            mesh=mesh)
        return out if V.ndim == 2 else out[:, 0]

    def frobenius_norm_sq(self, block_size: Optional[int] = None,
                          mesh=None) -> torch.Tensor:
        """||K||_F² accumulated over row panels."""
        (out,) = self.sweep([sweep_lib.FrobeniusPlan()],
                            block_size=block_size, mesh=mesh)
        return out


class DenseSPSD(SPSDOperator):
    """An explicit (n × n) matrix behind the operator protocol."""

    def __init__(self, K, device=None):
        if device is None and isinstance(K, torch.Tensor):
            device = K.device
        self.K = torch.as_tensor(K, device=resolve_device(device))
        self.device = self.K.device

    @property
    def n(self) -> int:
        return int(self.K.shape[0])

    def columns(self, idx):
        return self.K[:, _index(idx, self.device)]

    def block(self, row_idx, col_idx):
        return self.K[_index(row_idx, self.device)][
            :, _index(col_idx, self.device)]

    def full(self):
        return self.K

    def diag(self):
        return torch.diagonal(self.K)

    def matmat(self, V, block_size: Optional[int] = None, mesh=None):
        return self.K @ V

    def frobenius_norm_sq(self, block_size: Optional[int] = None, mesh=None):
        K32 = self.K.to(torch.float32)
        return torch.sum(K32 * K32)


class PairwiseKernel(SPSDOperator):
    """K_ij = entry_fn(stat(x_i, x_j)) for any ``KernelSpec``::

        from repro_torch.kernels.pairwise import specs
        K = PairwiseKernel(X, specs.get_spec("laplacian", gamma=0.5))
        ap = spsd.fast_model(K, c=100, s=400, s_sketch="gaussian")

    ``X`` (n × d) is stored as f32 on ``device`` (the CUDA device unless
    given).  With ``use_kernel`` (the default) matmul-shaped sweeps are one
    fused launch; blocks and columns always go through the block kernel.
    """

    def __init__(self, X, spec: KernelSpec, use_kernel: bool = True,
                 device=None):
        self.device = resolve_device(device)
        self.X = torch.as_tensor(X, dtype=torch.float32,
                                 device=self.device).contiguous()
        self.spec = spec
        self.use_kernel = bool(use_kernel)

    @property
    def n(self) -> int:
        return int(self.X.shape[0])

    @property
    def precision(self) -> str:
        return self.spec.precision

    def l1_edges(self) -> Optional[torch.Tensor]:
        """Sign-split table of this operator's data, or None (non-l1dist
        statistics, or data whose per-feature cardinality exceeds
        ``signsplit.MAX_SEGMENTS``).  Built once, on the host."""
        if self.spec.stat != "l1dist":
            return None
        if not hasattr(self, "_l1_edges_cache"):
            plan = signsplit.build_plan(self.X)
            self._l1_edges_cache = None if plan is None else \
                torch.as_tensor(plan.edges, device=self.device)
        return self._l1_edges_cache

    def l1_route(self, Xq=None) -> Optional[str]:
        """'mxu_signsplit' when a sign-split plan covers the data (and, with
        ``Xq``, every query value lies on the plan's lattice), 'vpu_loop'
        otherwise, None for non-l1dist statistics — the reference's meaning
        and names.  On the card the CUDA kernels sum |x_k − y_k| directly
        on either route; the plain versions follow the route."""
        if self.spec.stat != "l1dist":
            return None
        if self.l1_edges() is None:
            return "vpu_loop"
        if Xq is None:
            return "mxu_signsplit"
        return ("mxu_signsplit" if signsplit.query_in_plan(self.X, Xq)
                else "vpu_loop")

    def block(self, row_idx, col_idx):
        Xr = self.X[_index(row_idx, self.device)]
        Xc = self.X[_index(col_idx, self.device)]
        return pw_ops.kernel_block(self.spec, Xr, Xc, edges=self.l1_edges())

    def columns(self, idx):
        # n·c entries straight from the data: the columns ARE an
        # (all rows × selected points) block
        Xc = self.X[_index(idx, self.device)]
        return pw_ops.kernel_block(self.spec, self.X, Xc,
                                   edges=self.l1_edges())

    def full(self):
        return pw_ops.kernel_block(self.spec, self.X, self.X,
                                   edges=self.l1_edges())

    def diag(self):
        return pairwise_specs.diag(self.spec, self.X)

    def stat_operator(self) -> "PairwiseKernel":
        """Operator over the raw pairwise statistic (identity entry
        function): what per-spec bandwidth calibration quantiles
        (``repro_torch.kernels.pairwise.calibrate``).  Shares this
        operator's data, routing and device."""
        return PairwiseKernel(self.X, pairwise_specs.stat_only(self.spec),
                              self.use_kernel, device=self.device)

    # -- fused-sweep capability (sweep.sweep_operator routes through these) --

    def supports_fused_matmat(self) -> bool:
        return self.use_kernel

    def fused_rows(self, row_idx, Vs):
        """One multi-right-hand-side launch for a row slab (None -> all
        rows)."""
        Xr = self.X if row_idx is None else \
            self.X[_index(row_idx, self.device)]
        return pw_ops.kernel_matmat_multi_rows(self.spec, Xr, self.X, Vs,
                                               edges=self.l1_edges())

    def supports_prefetch_slab(self) -> bool:
        return self.use_kernel

    def fused_slab(self, start_row, slab_len, Vs):
        """The slab launch: the rank's contiguous row range is addressed
        inside the kernel (``ops.kernel_matmat_multi_slab``), so no row
        copy of X is gathered."""
        return pw_ops.kernel_matmat_multi_slab(
            self.spec, self.X, start_row, int(slab_len), Vs,
            edges=self.l1_edges())

    def cross(self, Xq, Vs):
        """[K(Xq, X) @ V for V in Vs] — the serving-path query launch.

        One rectangular launch against every head matrix.  The sign-split
        route is taken for on-lattice queries only (``l1_route(Xq)``); the
        decision is recorded on ``_last_cross_l1_route`` and the route on
        ``_last_sweep_route`` ('fused_rows' with ``use_kernel``, else
        'dense_rows'; '+mxu_signsplit' and '+bf16_f32acc' suffixes as in the
        reference).
        """
        Xq = torch.as_tensor(Xq, dtype=torch.float32, device=self.device)
        edges = None
        self._last_cross_l1_route = None
        if self.spec.stat == "l1dist":
            q_route = self.l1_route(Xq)
            self._last_cross_l1_route = q_route
            if q_route == "mxu_signsplit":
                edges = self.l1_edges()
        route = "fused_rows" if self.use_kernel else "dense_rows"
        if edges is not None:
            route += "+mxu_signsplit"
        if self.precision != "f32":
            route += "+" + self.precision
        self._last_sweep_route = route
        return pw_ops.kernel_matmat_multi_rows(self.spec, Xq, self.X,
                                               tuple(Vs), edges=edges)


class RBFKernel(PairwiseKernel):
    """K_ij = exp(−|x_i − x_j|² / (2σ²)): ``PairwiseKernel`` with the
    registry's ``rbf`` spec."""

    def __init__(self, X, sigma: float, use_kernel: bool = True,
                 device=None):
        super().__init__(X, pairwise_specs.rbf(sigma), use_kernel, device)

    @property
    def sigma(self) -> float:
        return self.spec.param("sigma")


class LinearKernel(PairwiseKernel):
    """K = X Xᵀ, with the factored O(n·d)-per-product paths the explicit
    structure allows."""

    def __init__(self, X, use_kernel: bool = True, device=None):
        super().__init__(X, pairwise_specs.linear(), use_kernel, device)

    def columns(self, idx):
        return self.X @ self.X[_index(idx, self.device)].T

    def matmat(self, V, block_size: Optional[int] = None, mesh=None):
        return self.X @ (self.X.T @ V)

    def frobenius_norm_sq(self, block_size: Optional[int] = None, mesh=None):
        G = self.X.T @ self.X
        return torch.sum(G * G)


def as_operator(K, device=None) -> SPSDOperator:
    if isinstance(K, SPSDOperator):
        return K
    return DenseSPSD(K, device=device)
