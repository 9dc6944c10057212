"""Single-sweep multi-product panel engine (port of ``repro.core.sweep``).

*Panel plans* are small accumulators that all consume the same (b × n) row
panel, so one pass over the kernel rows yields a whole bundle of products
(K @ S for each sketch, column gathers for C, Hutchinson probes, residual
norms) for one evaluation of each kernel entry.  A plan implements::

    init(nrows, ncols, device)        -> carry (f32 zeros)
    update(carry, panel, idx, valid)  -> carry   # MUST mask by ``valid``
    finalize(carry)                   -> result

``sweep_panels`` walks the row panels in a Python loop (the counterpart of
the reference's ``jax.lax.scan``); tail panels are clamped to the last row
and masked by ``valid``, exactly as in the reference, so panel and entry
counts match it.

Data-parallel sweeps.  With a ``mesh`` whose data width (``pod`` × ``data``
dims, ``repro_torch.distributed.sharding``) is above 1, the panel count is
rebalanced to a multiple of the width (``resolved_block_size``), padded with
sentinel starts equal to ``nrows`` (all rows invalid, exact zero
contributions), and each rank walks its contiguous share of the starts — or
makes one slab claim over them (``slab_fn``).  The partial carries are then
summed over the ranks with ``dist.all_reduce`` and finalized on every rank:
the reference's ``shard_map`` + ``psum``.  Inputs are replicated; every rank
returns the full result.

Route names (``op._last_sweep_route``) drop the reference's ``pallas_``
prefix; a non-f32 precision policy is a ``+bf16_f32acc`` suffix in both:

==========================  ==========================
reference                   port
==========================  ==========================
``pallas_fused``            ``fused``
``pallas_fused_sharded``    ``fused_sharded`` (one slab launch per rank)
``pallas_fused_rows``       ``fused_rows``  (``cross``)
``dense_rows``              ``dense_rows``  (``cross``)
``panel``                   ``panel`` (sharded on a wide mesh)
==========================  ==========================
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch.distributed import collectives, sharding

# Row panels are capped at roughly this many f32 elements (b·ncols), so the
# streaming paths stay ~128 MB whatever the problem size (the reference's
# budget, so panel counts match it).
PANEL_ELEMENT_BUDGET = 1 << 25

_F32 = torch.float32


def panel_block_size(ncols: int, block_size: Optional[int]) -> int:
    if block_size is not None:
        return max(1, int(block_size))
    return max(128, min(4096, PANEL_ELEMENT_BUDGET // max(ncols, 1)))


def resolved_block_size(nrows: int, ncols: int, block_size: Optional[int],
                        data_parallel: int = 1) -> int:
    """The panel height a sweep uses: the budgeted (or requested) size,
    clamped to ``nrows``.  With ``data_parallel`` > 1 it shrinks so the
    panel count is (as nearly as possible) a multiple of the width: each
    sentinel panel would evaluate a full b × ncols block of throwaway
    entries."""
    bs = min(panel_block_size(ncols, block_size), max(nrows, 1))
    if data_parallel > 1:
        nblocks = -(-nrows // bs)
        target = data_parallel * (-(-nblocks // data_parallel))
        bs = -(-nrows // target)
    return bs


def num_panels(nrows: int, ncols: int, block_size: Optional[int],
               data_parallel: int = 1) -> int:
    """How many panels one sweep over ``nrows`` rows touches (sentinel
    panels not included)."""
    return -(-nrows // resolved_block_size(nrows, ncols, block_size,
                                           data_parallel))


def local_slab_rows(nrows: int, ncols: int, block_size: Optional[int],
                    data_parallel: int = 1) -> int:
    """Rows of the per-rank slab of a sharded sweep (panels · b), clamp and
    sentinel padding included — the height of a ``slab_fn`` claim."""
    bs = resolved_block_size(nrows, ncols, block_size, data_parallel)
    nblocks = -(-nrows // bs)
    if data_parallel > 1:
        nblocks += (-nblocks) % data_parallel
    return (nblocks // data_parallel) * bs


def mesh_data_size(mesh) -> int:
    """Total data-parallel width of ``mesh`` (1 for None / trivial
    meshes)."""
    return sharding.data_size(mesh)


def _rowmask(valid: torch.Tensor) -> torch.Tensor:
    return valid.to(_F32)[:, None]


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MatmulPlan:
    """A @ V for V (ncols × m)."""

    V: torch.Tensor

    def init(self, nrows, ncols, device):
        return torch.zeros((nrows, self.V.shape[1]), dtype=_F32,
                           device=device)

    def update(self, carry, panel, idx, valid):
        y = panel.to(_F32) @ self.V.to(_F32)
        return carry.index_add(0, idx, y * _rowmask(valid))

    def finalize(self, carry):
        return carry


@dataclasses.dataclass
class ColumnGatherPlan:
    """A[:, col_idx] — the C = K P gather."""

    col_idx: torch.Tensor

    def init(self, nrows, ncols, device):
        return torch.zeros((nrows, self.col_idx.shape[0]), dtype=_F32,
                           device=device)

    def update(self, carry, panel, idx, valid):
        y = panel[:, self.col_idx.to(panel.device)].to(_F32)
        return carry.index_add(0, idx, y * _rowmask(valid))

    def finalize(self, carry):
        return carry


@dataclasses.dataclass
class SketchRightPlan:
    """A S for a sketch object exposing ``S.right`` (SRHT / CountSketch)."""

    S: object
    s: int

    def init(self, nrows, ncols, device):
        return torch.zeros((nrows, self.s), dtype=_F32, device=device)

    def update(self, carry, panel, idx, valid):
        y = self.S.right(panel.to(_F32))
        return carry.index_add(0, idx, y * _rowmask(valid))

    def finalize(self, carry):
        return carry


@dataclasses.dataclass
class FrobeniusPlan:
    """||A||_F² accumulated panel by panel."""

    def init(self, nrows, ncols, device):
        return torch.zeros((), dtype=_F32, device=device)

    def update(self, carry, panel, idx, valid):
        p32 = panel.to(_F32)
        return carry + torch.sum(p32 * p32 * _rowmask(valid))

    def finalize(self, carry):
        return carry


@dataclasses.dataclass
class DiagPlan:
    """diag(A) (square operators): one gather per panel row."""

    def init(self, nrows, ncols, device):
        return torch.zeros((nrows,), dtype=_F32, device=device)

    def update(self, carry, panel, idx, valid):
        d = torch.gather(panel, 1, idx[:, None])[:, 0]
        return carry.index_add(0, idx, d.to(_F32) * valid.to(_F32))

    def finalize(self, carry):
        return carry


@dataclasses.dataclass
class ResidualFroPlan:
    """(||K − C M||_F², ||K||_F²) for a low-rank C M (M = U Cᵀ) in one
    pass; ``C``: (nrows, c), ``M``: (c, ncols), both f32."""

    C: torch.Tensor
    M: torch.Tensor

    def init(self, nrows, ncols, device):
        z = torch.zeros((), dtype=_F32, device=device)
        return (z, z.clone())

    def update(self, carry, panel, idx, valid):
        p32 = panel.to(_F32)
        resid = p32 - self.C[idx] @ self.M
        v = _rowmask(valid)
        return (carry[0] + torch.sum(resid * resid * v),
                carry[1] + torch.sum(p32 * p32 * v))

    def finalize(self, carry):
        return carry


@dataclasses.dataclass
class ProjResidualColNormPlan:
    """Residual column norms ||(I − Q Qᵀ) K e_j||² in one pass, via
    ||K e_j||² − ||Qᵀ K e_j||²; ``mask`` (nrows,) row-masks the statistics."""

    Q: torch.Tensor
    mask: Optional[torch.Tensor] = None

    def init(self, nrows, ncols, device):
        return (torch.zeros((ncols,), dtype=_F32, device=device),
                torch.zeros((self.Q.shape[1], ncols), dtype=_F32,
                            device=device))

    def update(self, carry, panel, idx, valid):
        colnorms, QtK = carry
        rowm = valid.to(_F32)
        if self.mask is not None:
            rowm = rowm * self.mask.to(_F32)[idx]
        p32 = panel.to(_F32) * rowm[:, None]
        colnorms = colnorms + torch.sum(p32 * p32, dim=0)
        QtK = QtK + self.Q[idx].T @ p32
        return (colnorms, QtK)

    def finalize(self, carry):
        colnorms, QtK = carry
        return torch.clamp(colnorms - torch.sum(QtK * QtK, dim=0), min=0.0)


@dataclasses.dataclass
class GramPlan:
    """Σ panelᵀ panel — the blocked Gram pass."""

    dim: int

    def init(self, nrows, ncols, device):
        return torch.zeros((self.dim, self.dim), dtype=_F32, device=device)

    def update(self, carry, panel, idx, valid):
        p32 = panel.to(_F32) * _rowmask(valid)
        return carry + p32.T @ p32

    def finalize(self, carry):
        return carry


@dataclasses.dataclass
class RowQuadFormPlan:
    """q_i = panel_i W panel_iᵀ per row — blocked leverage scoring."""

    W: torch.Tensor

    def init(self, nrows, ncols, device):
        return torch.zeros((nrows,), dtype=_F32, device=device)

    def update(self, carry, panel, idx, valid):
        p32 = panel.to(_F32)
        q = torch.sum((p32 @ self.W) * p32, dim=1)
        return carry.index_add(0, idx, q * valid.to(_F32))

    def finalize(self, carry):
        return carry


# ---------------------------------------------------------------------------
# route selection (the operator capability protocol)
# ---------------------------------------------------------------------------

def is_matmul_shaped(plans: Sequence) -> bool:
    """True when every plan reduces to A @ V for a dense right-hand side
    (matmats as they are; column gathers as one-hot columns)."""
    plans = list(plans)
    return bool(plans) and all(
        isinstance(p, (MatmulPlan, ColumnGatherPlan)) for p in plans)


def one_hot_columns(col_idx: torch.Tensor, ncols: int,
                    device) -> torch.Tensor:
    """(ncols, c) f32 with a single 1.0 in row col_idx[j] of column j."""
    c = int(col_idx.shape[0])
    out = torch.zeros((ncols, c), dtype=_F32, device=device)
    out[col_idx.to(device), torch.arange(c, device=device)] = 1.0
    return out


def fused_right_hand_sides(plans: Sequence, ncols: int, device):
    """Dense f32 right-hand sides for a matmul-shaped plan bundle; column
    gathers ride along as one-hot columns (exact: each output entry is one
    kernel entry times 1.0)."""
    return tuple(
        p.V.to(device=device, dtype=_F32) if isinstance(p, MatmulPlan)
        else one_hot_columns(p.col_idx, ncols, device)
        for p in plans)


def sweep_operator(op, plans: Sequence, block_size: Optional[int] = None,
                   mesh=None):
    """Run a plan bundle over a square operator's rows, fastest route first.

    A matmul-shaped bundle on a capable operator (``supports_fused_matmat``)
    is ONE fused launch ('fused'); on a mesh of data width above 1 it is one
    rectangular row-slab launch per rank through the engine's ``slab_fn``
    claim, the partial carries all-reduced like the panel route's
    ('fused_sharded').  Everything else walks the blocked panel scan over
    ``op.block`` ('panel'), sharded on a wide mesh.  The route is recorded
    on ``op._last_sweep_route``; a sharded claim records on
    ``op._last_slab_mode`` whether it addressed its slab inside the launch
    ('prefetch') or gathered the rows ('gather').
    """
    plans = list(plans)
    n = op.n
    fused = op.supports_fused_matmat() and is_matmul_shaped(plans)
    prec = getattr(op, "precision", "f32")
    suffix = "" if prec == "f32" else "+" + prec
    op._last_slab_mode = None          # only sharded fused claims set this
    if fused and mesh_data_size(mesh) <= 1:
        op._last_sweep_route = "fused" + suffix
        return list(op.fused_rows(
            None, fused_right_hand_sides(plans, n, op.device)))
    if fused:
        op._last_sweep_route = "fused_sharded" + suffix
        Vs = fused_right_hand_sides(plans, n, op.device)
        use_slab = op.supports_prefetch_slab()
        op._last_slab_mode = "prefetch" if use_slab else "gather"

        def slab_fn(row_idx, valid):
            # one launch for this rank's slab; row_idx[0] is the slab start
            # (clamped only on an all-sentinel shard, which valid zeroes)
            if use_slab:
                outs = op.fused_slab(int(row_idx[0]), int(row_idx.shape[0]),
                                     Vs)
            else:
                outs = op.fused_rows(row_idx, Vs)
            v = _rowmask(valid)
            return tuple(p.init(n, n, op.device).index_add(0, row_idx, o * v)
                         for p, o in zip(plans, outs))

        return sweep_panels(None, n, n, plans, block_size=block_size,
                            device=op.device, mesh=mesh, slab_fn=slab_fn)
    op._last_sweep_route = "panel"
    cols = torch.arange(n, device=op.device)
    return sweep_panels(lambda idx: op.block(idx, cols), n, n, plans,
                        block_size=block_size, device=op.device, mesh=mesh)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

def _flatten(carry) -> list:
    if isinstance(carry, (tuple, list)):
        return [t for c in carry for t in _flatten(c)]
    return [carry]


def _unflatten(like, flat: list):
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(c, flat) for c in like)
    return flat.pop(0)


def _sum_over_data(tensors: list, mesh) -> list:
    """Each carry (one dtype) summed over the data dims of ``mesh``, packed
    into one buffer: one all-reduce a sweep, whatever its carries.  A sum
    takes the data dims in the mesh's own order."""
    axes = [a for a in mesh.mesh_dim_names if a in sharding.data_axes(mesh)]
    buf = collectives.all_reduce(torch.cat([t.reshape(-1) for t in tensors]),
                                 axes, mesh=mesh)
    return [part.reshape(t.shape) for part, t in zip(
        torch.split(buf, [t.numel() for t in tensors]), tensors)]


def sweep_panels(panel_fn, nrows: int, ncols: int, plans: Sequence,
                 block_size: Optional[int] = None, device=None, mesh=None,
                 slab_fn=None):
    """Apply every plan to each (b × ncols) row panel in a single pass.

    ``panel_fn(idx)`` materializes rows ``idx`` (a (b,) int64 tensor; tail
    panels are clamped to the last row and masked via ``valid``).  Returns
    ``[plan.finalize(carry) for plan in plans]``.

    With a ``mesh`` of data width above 1 each rank sweeps its share of the
    panel starts (sentinel-padded to a multiple of the width) and the
    carries are summed over the ranks before ``finalize``, so results match
    the single-device sweep to float reassociation.

    ``slab_fn(row_idx, valid) -> tuple(carry per plan)`` lets a caller
    claim a rank's whole contiguous row range in one shot (the fused slab
    launch): ``row_idx`` is the rank's ``local_slab_rows`` rows clamped into
    ``[0, nrows)``, ``valid`` masks clamp and sentinel padding, and the
    returned carries must equal what the panel scan would produce.
    ``panel_fn`` may then be None.
    """
    plans = list(plans)
    device = torch.device("cpu") if device is None else torch.device(device)
    dp = mesh_data_size(mesh)
    bs = resolved_block_size(nrows, ncols, block_size, dp)
    nblocks = -(-nrows // bs)
    starts = list(range(0, nblocks * bs, bs))
    if dp > 1:
        # sentinel starts == nrows: every row invalid, exact zero
        # contributions (≤ dp − 1 thin panels, after the rebalancing)
        starts += [nrows] * ((-nblocks) % dp)
        per = len(starts) // dp
        k = sharding.shard_index(mesh)
        starts = starts[k * per:(k + 1) * per]
    if slab_fn is not None:
        # the shard's panels tile [starts[0], starts[0] + len·bs) exactly
        idx = starts[0] + torch.arange(len(starts) * bs, device=device)
        valid = idx < nrows
        carry = list(slab_fn(torch.clamp(idx, max=nrows - 1), valid))
    else:
        carry = [p.init(nrows, ncols, device) for p in plans]
        offsets = torch.arange(bs, device=device)
        for start in starts:
            idx = start + offsets
            valid = idx < nrows
            idx = torch.clamp(idx, max=nrows - 1)
            panel = panel_fn(idx)
            carry = [p.update(c, panel, idx, valid)
                     for p, c in zip(plans, carry)]
    if dp > 1:
        carry = _unflatten(carry, _sum_over_data(_flatten(carry), mesh))
    return [p.finalize(c) for p, c in zip(plans, carry)]
