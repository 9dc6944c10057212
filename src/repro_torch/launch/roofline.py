"""Roofline terms of a cell and of a kernel launch (port of
``repro.launch.roofline``).

**The cell half** (the reference's HLO half, in a torch form).  Three
terms per (arch, shape, mesh), in seconds:

    compute    = FLOPs a device / PEAK_FLOPS
    memory     = HBM bytes a device / HBM_BW
    collective = collective bytes a device / LINK_BW

``Roofline`` (``finalize``, ``to_json``), ``model_flops`` and
``format_table`` are the reference's arithmetic, copied; ``finalize``
defaults to ``H100_SXM``, the port's target (the reference defaults to its
v5e), and ``profile_name`` names the profile used.  The reference mines
the compiled HLO; the port records the ops that run instead:
``OpRecorder`` is a ``TorchDispatchMode`` that sees every aten op, every
custom op (the port's kernels, ``repro_torch::*``) and every collective of
``distributed.collectives`` (through its ``LISTENERS``) with its operand
and result bytes, on ``meta`` tensors (a trace, ``launch.dryrun``) or on
real ones (a run).  FLOPs come from ``torch.utils.flop_counter`` beside
it.  ``analyze`` takes the recorded counts where the reference takes a
compiled executable.

- ``hlo_bytes``: operands + results of every op but views (the
  reference's unfused ``bytes accessed``).
- ``hbm_bytes``: the same perfect-fusion idealisation as the reference's
  ``hbm_bytes`` — operands + results of the memory-real ops only, every
  elementwise op assumed fused into its consumer.  The aten ops counted,
  by the HLO opcode they stand for:

  ==============================  ======================================
  HLO                             aten
  ==============================  ======================================
  dot / dot-general               mm, addmm, bmm, baddbmm, mv, addmv, dot
  convolution                     convolution, convolution_backward
  reduce / reduce-window          sum, mean, amax, amin, max, min, prod,
                                  var, std, var_mean, linalg_vector_norm,
                                  logsumexp, argmax, argmin, cumsum,
                                  any, all, _softmax, _log_softmax and
                                  their backward ops
  gather / scatter                gather, scatter*, index, index_put*,
                                  index_select, index_add*, index_copy*,
                                  embedding, embedding_dense_backward
  dynamic-(update-)slice, copy    copy_, slice_scatter, select_scatter,
                                  cat, _to_copy, clone
  sort                            sort, topk
  custom-call                     the ``repro_torch::`` kernels
  the collectives                 ``distributed.collectives``
  ==============================  ======================================

- ``collective_bytes``: result bytes by the reference's kind names
  (``collectives.STATS``' ``result_bytes``).

**The kernel half.**  ``pairwise_launch_model`` counts the work of ONE
pairwise launch from its shape and spec alone — the same count whatever
implements it — and ``achieved_vs_roofline`` scores a measured launch
against that work under a ``HardwareProfile``: roofline = max(flops /
peak, bytes / bandwidth).  The formulas and report keys are the
reference's, so a report from either package reads the same.
"""
from __future__ import annotations

import dataclasses
import json
import weakref
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.distributed import collectives as C


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


# ---------------------------------------------------------------------------
# the cell half: the reference's arithmetic
# ---------------------------------------------------------------------------

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_gflops: float              # GFLOP a device (one rank's program)
    hlo_gbytes: float              # GB a device accessed (unfused bound)
    coll_gbytes: float             # collective GB a device (result shapes)
    coll_by_kind: Dict[str, float]
    model_gflops: float            # 6 * N_active * D (per step, all chips)
    bytes_per_chip: float          # peak live bytes a device
    hbm_gbytes: float = 0.0        # fusion-adjusted GB (memory-real ops)
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    bottleneck: str = ""
    useful_flops_frac: float = 0.0
    profile_name: str = "h100-sxm"

    def finalize(self, profile: Optional[HardwareProfile] = None):
        prof = H100_SXM if profile is None else profile
        self.profile_name = prof.name
        self.compute_s = self.hlo_gflops * 1e9 / prof.peak_flops
        gb = self.hbm_gbytes if self.hbm_gbytes > 0 else self.hlo_gbytes
        self.memory_s = gb * 1e9 / prof.hbm_bw
        self.collective_s = self.coll_gbytes * 1e9 / prof.link_bw
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        self.bottleneck = max(terms, key=terms.get)
        if self.hlo_gflops > 0:
            self.useful_flops_frac = self.model_gflops / (
                self.hlo_gflops * self.chips)
        return self

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def model_flops(cfg, shape) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE) per optimizer step; forward-only
    (2*N*D) for serving cells.  D = processed tokens for this cell."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        if cfg.is_encdec:
            # each stream only crosses its half of the params:
            # 6*(N/2)*(enc tokens) + 6*(N/2)*(dec tokens)
            return 3.0 * n_active * shape.global_batch * (
                shape.seq_len + max(shape.seq_len // 8, 1))
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence; attention reads the cache but 6ND
    # convention counts matmul params only
    return 2.0 * n_active * shape.global_batch


def format_table(rows: List[dict]) -> str:
    hdr = (f"{'arch':<18} {'shape':<12} {'mesh':<9} {'GB/chip':>8} "
           f"{'compute_s':>10} {'memory_s':>10} {'coll_s':>10} "
           f"{'bound':>7} {'useful%':>8}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r['arch']:<18} {r['shape']:<12} {r['mesh']:<9} "
            f"{r['bytes_per_chip']/1e9:>8.2f} "
            f"{r['compute_s']:>10.4f} {r['memory_s']:>10.4f} "
            f"{r['collective_s']:>10.4f} {r['bottleneck']:>7.7s} "
            f"{100*r['useful_flops_frac']:>7.1f}%")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# the cell half: the op recorder
# ---------------------------------------------------------------------------

#: aten ops whose operands and results count toward ``hbm_bytes``
MEMORY_REAL_OPS = frozenset((
    # dot / convolution
    "mm", "addmm", "bmm", "baddbmm", "mv", "addmv", "dot", "convolution",
    "convolution_backward",
    # reduce
    "sum", "mean", "amax", "amin", "max", "min", "prod", "var", "std",
    "var_mean", "std_mean", "linalg_vector_norm", "norm", "logsumexp",
    "argmax", "argmin", "cumsum", "cumprod", "any", "all", "_softmax",
    "_log_softmax", "_softmax_backward_data", "_log_softmax_backward_data",
    "native_layer_norm", "native_layer_norm_backward",
    # gather / scatter
    "gather", "scatter", "scatter_", "scatter_add", "scatter_add_",
    "scatter_reduce", "scatter_reduce_", "index", "index_put", "index_put_",
    "_index_put_impl_", "index_select", "index_add", "index_add_",
    "index_copy", "index_copy_", "embedding", "embedding_dense_backward",
    "masked_select", "take",
    # dynamic-update-slice / copy
    "copy_", "slice_scatter", "select_scatter", "cat", "_to_copy", "clone",
    # sort
    "sort", "topk",
))

#: the namespace of the port's custom ops (its kernels)
CUSTOM_NAMESPACE = "repro_torch"


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _meta_key(x):
    """A hashable key of an op's argument: a tensor by its metadata."""
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return (type(x).__name__,) + tuple(_meta_key(v) for v in x)
    if isinstance(x, dict):
        return ("D",) + tuple((k, _meta_key(v)) for k, v in x.items())
    return (type(x).__name__, x)


def _out_spec(out, in_storages):
    """The metadata of an op's tensor output(s), or None (not cached):
    each output a fresh storage of the least size its strides need."""
    if isinstance(out, torch.Tensor):
        st = out.untyped_storage()
        fresh = torch.empty_strided(out.shape, out.stride(), dtype=out.dtype,
                                    device="meta")
        if out.storage_offset() != 0 or st._cdata in in_storages or \
                st.nbytes() != fresh.untyped_storage().nbytes():
            return None
        return (tuple(out.shape), out.stride(), out.dtype)
    if isinstance(out, (list, tuple)) and out and all(
            isinstance(t, torch.Tensor) for t in out):
        specs = tuple(_out_spec(t, in_storages) for t in out)
        if any(s is None for s in specs) or len(
                {t.untyped_storage()._cdata for t in out}) != len(out):
            return None
        return (type(out),) + specs
    return None


def _from_spec(spec):
    if isinstance(spec[0], type):
        return spec[0](_from_spec(s) for s in spec[1:])
    shape, stride, dtype = spec
    return torch.empty_strided(shape, stride, dtype=dtype, device="meta")


class OpRecorder(TorchDispatchMode):
    """Records every op run under it: its calls by name (``calls``), the
    bytes of the operands and results of every op but views
    (``hlo_bytes``) and of the memory-real ones (``hbm_bytes``,
    ``MEMORY_REAL_OPS``, the custom ops and the collectives), the calls of
    each custom op (``kernels``), the collectives' result bytes by the
    reference's kinds (``coll``), their calls by kind (``coll_calls``) and
    in all (``n_coll``).

    It also tracks the live bytes a device: ``track(tree)`` counts the
    tensors already alive (the step's arguments; ``args_bytes``), and every
    storage an op makes is counted until it is freed; ``peak_bytes`` is the
    most alive at once.  A storage is counted once however many views
    share it, so an output written in place into an argument's storage (a
    donated alias) adds nothing.  The collectives of
    ``distributed.collectives`` are recorded from their ``LISTENERS``
    hook, not as ``c10d`` ops, so each is one call of its kind.  A copy
    from host memory to the device (a tensor made from Python data) is
    not device work and is not recorded, so a ``meta`` trace, a CPU run
    and a card run record the same ops."""

    def __init__(self):
        super().__init__()
        self.calls: Dict[str, int] = {}
        self.kernels: Dict[str, int] = {}
        self.hlo_bytes = 0
        self.hbm_bytes = 0
        self.hbm_by_op: Dict[str, int] = {}
        self.coll = {k: 0 for k in _COLLECTIVES}
        self.coll_calls = {k: 0 for k in _COLLECTIVES}
        self.n_coll = 0
        self.live = 0
        self.peak_bytes = 0
        self.args_bytes = 0
        self._storages: Dict[int, int] = {}
        self._meta_specs: dict = {}

    # -- live bytes --------------------------------------------------------
    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    def _hold(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return 0
        n = st.nbytes()
        self._storages[key] = n
        self.live += n
        weakref.finalize(st, self._free, key)
        return n

    def track(self, tree) -> None:
        """Count the tensors of ``tree`` as alive (arguments)."""
        self.args_bytes += sum(self._hold(t) for t in _tensors(tree))
        self.peak_bytes = max(self.peak_bytes, self.live)

    def held_bytes(self, tree) -> int:
        """The bytes of the distinct storages of ``tree``."""
        seen: dict = {}
        for t in _tensors(tree):
            st = t.untyped_storage()
            seen[st._cdata] = st.nbytes()
        return sum(seen.values())

    # -- ops ---------------------------------------------------------------
    def _record(self, name: str, nbytes: int, memory_real: bool) -> None:
        self.calls[name] = self.calls.get(name, 0) + 1
        self.hlo_bytes += nbytes
        if memory_real:
            self.hbm_bytes += nbytes
            self.hbm_by_op[name] = self.hbm_by_op.get(name, 0) + nbytes

    def collective(self, kind: str, inp: torch.Tensor,
                   out: torch.Tensor) -> None:
        """``collectives.LISTENERS``' hook."""
        self._record(f"collective:{kind}", _nbytes([inp, out]), True)
        hlo = C.HLO_KIND[kind]
        self.coll[hlo] += C.result_bytes(kind, inp, out)
        self.coll_calls[hlo] += 1
        self.n_coll += 1

    def __enter__(self):
        C.LISTENERS.append(self.collective)
        return super().__enter__()

    def __exit__(self, *exc):
        C.LISTENERS.remove(self.collective)
        return super().__exit__(*exc)

    def _run_meta(self, func, args, kwargs):
        """``func`` on ``meta`` tensors, its output made from the cached
        result of an earlier call with the same metadata: a functional
        op's meta kernel is a function of its inputs' shapes, strides and
        dtypes and of its other arguments, and most are written in Python
        (a per-step loop calls the same few thousands of times)."""
        try:
            key = (func, _meta_key(args), _meta_key(kwargs))
            hash(key)
        except TypeError:
            return func(*args, **kwargs)
        spec = self._meta_specs.get(key)
        if spec is None:
            out = func(*args, **kwargs)
            ins = {t.untyped_storage()._cdata
                   for t in _tensors((args, kwargs))}
            spec = _out_spec(out, ins)
            self._meta_specs[key] = spec or False
            return out
        if spec is False:                 # an output shares an input's
            return func(*args, **kwargs)  # storage (``_unsafe_view``)
        return _from_spec(spec)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        if ins and not func.is_view and not func._schema.is_mutable \
                and all(t.device.type == "meta" for t in ins):
            out = self._run_meta(func, args, kwargs)
        else:
            out = func(*args, **kwargs)
        ns = func.namespace
        if ns in ("c10d", "_c10d_functional") or func.is_view:
            return out
        outs = _tensors(out)
        for t in outs:
            self._hold(t)
        self.peak_bytes = max(self.peak_bytes, self.live)
        name = func._overloadpacket.__name__
        if name in ("copy_", "_to_copy") and outs \
                and outs[0].device.type != "cpu" \
                and any(t.device.type == "cpu" for t in _tensors(args)):
            return out            # a host upload (a tensor made from data)
        custom = ns == CUSTOM_NAMESPACE
        if custom:
            name = f"{ns}::{name}"
            self.kernels[name] = self.kernels.get(name, 0) + 1
        nbytes = _nbytes(ins) + _nbytes(outs)
        self._record(name, nbytes, custom or name in MEMORY_REAL_OPS)
        return out

    def counts(self) -> dict:
        """The recorded totals (what ``analyze`` and the dry run read)."""
        return {"hlo_bytes": float(self.hlo_bytes),
                "hbm": float(self.hbm_bytes),
                "coll": {k: float(v) for k, v in self.coll.items()},
                "coll_calls": dict(self.coll_calls), "n_coll": self.n_coll,
                "kernels": dict(self.kernels), "peak_bytes": self.peak_bytes}


def analyze(flops: float, counts: dict, *, arch: str, shape, cfg,
            mesh_name: str, chips: int, memory_stats: Optional[dict] = None,
            profile: Optional[HardwareProfile] = None) -> Roofline:
    """The reference's ``analyze`` on recorded counts: ``flops`` a device
    (``FlopCounterMode``) and an ``OpRecorder``'s ``counts()``."""
    coll = counts["coll"]
    mstats = memory_stats or {}
    r = Roofline(
        arch=arch, shape=shape.name, mesh=mesh_name, chips=chips,
        hlo_gflops=flops / 1e9, hlo_gbytes=counts["hlo_bytes"] / 1e9,
        hbm_gbytes=counts["hbm"] / 1e9,
        coll_gbytes=sum(coll.values()) / 1e9,
        coll_by_kind={k: v / 1e9 for k, v in coll.items()},
        model_gflops=model_flops(cfg, shape) / 1e9,
        bytes_per_chip=float(mstats.get("bytes_per_chip", 0.0)),
    )
    return r.finalize(profile)


def main(argv=None):
    import argparse
    import glob
    p = argparse.ArgumentParser()
    p.add_argument("--glob", default="results/dryrun/*.json")
    args = p.parse_args(argv)
    rows = []
    for f in sorted(glob.glob(args.glob)):
        with open(f) as fh:
            rows.append(json.load(fh))
    print(format_table(rows))


if __name__ == "__main__":
    main()
