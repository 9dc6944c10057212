"""The paper's Table-3 "#Entries" meter (port of ``repro.core.instrument``).

``CountingOperator`` wraps any ``SPSDOperator`` and counts the kernel
entries each pipeline evaluates, with the reference's counters and count
model:

- ``sweeps`` / ``panels`` / ``entries``: a sweep counts ``nblocks·b·n``
  entries, clamp padding of the tail panel included, whatever route runs it
  (the fused launch evaluates the same row extent).  A sweep sharded over a
  mesh counts the sentinel panels too: its ranks' slabs cover
  ``data width · local_slab_rows`` rows.  Each rank's meter counts the
  whole (global) sweep, as the reference's single SPMD program does;
- ``fused_sweeps``: sweeps the inner operator answered with one fused
  launch (route 'fused…'); ``last_route`` holds the route verbatim;
- ``bf16_sweeps``: sweeps and cross launches under a non-f32 policy;
- ``cross_sweeps``: query-side rectangular launches (n_q·n entries each);
- ``append_sweeps``: the thin launches of the append-row path
  (``append_cross``, ``repro_torch.serve.incremental``), n_q·n entries
  each, metered apart from ``cross_sweeps`` so that both the serving
  invariant (cross launches = query buckets) and the maintenance one (one
  launch per appended batch) can be asserted;
- ``blocks`` / ``columns`` / ``diags`` / ``fulls``: direct-access calls,
  counted at their exact extent.
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.core import sweep as sweep_lib
from repro_torch.core.kernelop import SPSDOperator


class CountingOperator(SPSDOperator):
    """Transparent counting proxy around an ``SPSDOperator``."""

    def __init__(self, inner: SPSDOperator):
        self.inner = inner
        self.reset()

    def reset(self):
        self.counts = {"sweeps": 0, "panels": 0, "entries": 0,
                       "fused_sweeps": 0, "cross_sweeps": 0,
                       "append_sweeps": 0, "bf16_sweeps": 0,
                       "blocks": 0, "columns": 0, "diags": 0, "fulls": 0}
        self.last_route = None
        self.last_precision = None
        self.last_slab_mode = None
        self._in_sweep = False

    @property
    def n(self) -> int:
        return self.inner.n

    @property
    def device(self):
        return self.inner.device

    def rebind(self, inner: SPSDOperator) -> "CountingOperator":
        """Swap the wrapped operator without resetting the meters (a
        serving replica's counter follows a re-sketched artifact); per-call
        counts read ``self.n`` at call time."""
        self.inner = inner
        return self

    # -- direct access (counted exactly) ------------------------------------

    def block(self, row_idx, col_idx):
        if not self._in_sweep:
            self.counts["blocks"] += 1
            self.counts["entries"] += int(len(row_idx)) * int(len(col_idx))
        return self.inner.block(row_idx, col_idx)

    def columns(self, idx):
        self.counts["columns"] += 1
        self.counts["entries"] += self.n * int(len(idx))
        return self.inner.columns(idx)

    def diag(self):
        self.counts["diags"] += 1
        self.counts["entries"] += self.n
        return self.inner.diag()

    def full(self):
        self.counts["fulls"] += 1
        self.counts["entries"] += self.n * self.n
        return self.inner.full()

    # -- streaming protocol (counted per pass) ------------------------------

    def _count_sweep(self, block_size, mesh=None):
        dp = sweep_lib.mesh_data_size(mesh)
        bs = sweep_lib.resolved_block_size(self.n, self.n, block_size, dp)
        nblocks = -(-self.n // bs)
        if dp > 1:
            nblocks += (-nblocks) % dp       # sentinel padding panels
        self.counts["sweeps"] += 1
        self.counts["panels"] += nblocks
        self.counts["entries"] += nblocks * bs * self.n

    def sweep(self, plans: Sequence, block_size: Optional[int] = None,
              mesh=None):
        self._count_sweep(block_size, mesh)
        self._in_sweep = True
        try:
            # delegate so the inner operator's fused route stays engaged
            out = self.inner.sweep(plans, block_size=block_size, mesh=mesh)
        finally:
            self._in_sweep = False
        self._attribute(getattr(self.inner, "_last_sweep_route", "panel"))
        return out

    def _attribute(self, route: str):
        self.last_route = route
        self.last_precision = getattr(self.inner, "precision", "f32")
        self.last_slab_mode = getattr(self.inner, "_last_slab_mode", None)
        if route.startswith("fused"):
            self.counts["fused_sweeps"] += 1
        if self.last_precision != "f32":
            self.counts["bf16_sweeps"] += 1

    def cross(self, Xq, Vs):
        """One ``cross_sweeps`` tick and n_q·n entries per call."""
        self.counts["cross_sweeps"] += 1
        self.counts["entries"] += int(len(Xq)) * self.n
        out = self.inner.cross(Xq, Vs)
        self._attribute(getattr(self.inner, "_last_sweep_route",
                                "dense_rows"))
        return out

    def append_cross(self, Xq, Vs):
        """The append-row maintenance launch: ``cross``'s shape, one
        ``append_sweeps`` tick and n_q·n entries per call."""
        self.counts["append_sweeps"] += 1
        self.counts["entries"] += int(len(Xq)) * self.n
        inner_call = getattr(self.inner, "append_cross", self.inner.cross)
        out = inner_call(Xq, Vs)
        self._attribute(getattr(self.inner, "_last_sweep_route",
                                "dense_rows"))
        return out

    def map_row_panels(self, fn, block_size: Optional[int] = None):
        self._count_sweep(block_size)
        self._in_sweep = True
        try:
            return self.inner.map_row_panels(fn, block_size)
        finally:
            self._in_sweep = False
