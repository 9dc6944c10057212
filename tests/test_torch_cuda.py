"""The port's CUDA kernels on the card (skipped where no CUDA device is
visible).

This file imports neither JAX nor the reference package, so it also runs on
a machine with only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances, scale-normalized against the plain PyTorch versions on the same
card: f32 ≤ 1e-5, bf16_f32acc ≤ 1e-2 (the reference's gates); the landmark
read and flash attention with bf16 inputs within the reference's
``_tol(bf16)`` (rtol = atol = 2e-2).  Flash attention runs the CUDA-core
kernel for f32 inputs and the tensor-core kernel for bf16 inputs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import spsd
from repro_torch.core import sweep as sweep_lib
from repro_torch.core.instrument import CountingOperator
from repro_torch.core.kernelop import PairwiseKernel
from repro_torch.core import sketched_attention as tsa
from repro_torch.configs import gemma3_12b
from repro_torch.configs import get_smoke
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.landmark_attention import kernel as lm_kernel
from repro_torch.kernels.landmark_attention import ops as lm_ops
from repro_torch.kernels.pairwise import kernel, specs
from repro_torch.models import model as tm
from repro_torch.models import moe as tmoe

NAMES = ("laplacian", "linear", "matern32", "polynomial", "rbf")
PRECISIONS = ("f32", "bf16_f32acc")
TOL = {"f32": 1e-5, "bf16_f32acc": 1e-2}
D = 16

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py covers the kernels "
                    "on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    # the first multi-threaded CPU torch.exp of a process can come out ~1e-4
    # off (seen with torch 2.13 CPU builds); one small call first fixes it
    torch.exp(torch.zeros(64))
    return torch.device("cuda")


def _rand(rng, *shape, dev):
    return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32,
                           device=dev)


def scaled(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("prec", PRECISIONS)
def test_kernels_match_plain_versions(cuda_device, name, prec):
    rng = np.random.default_rng(0)
    Xr, Xc = _rand(rng, 150, D, dev=cuda_device), _rand(rng, 200, D,
                                                        dev=cuda_device)
    Vs = [_rand(rng, 200, 3, dev=cuda_device),
          _rand(rng, 200, 130, dev=cuda_device)]
    spec = specs.suggested_spec(name, D).with_precision(prec)
    before = kernel.launch_counts()
    blk = kernel.pairwise_block(spec, Xr, Xc)
    outs = kernel.pairwise_matmat_multi(spec, Xr, Xc, Vs)
    after = kernel.launch_counts()
    assert after["pairwise_block"] == before["pairwise_block"] + 1
    assert after["pairwise_matmat_multi"] == \
        before["pairwise_matmat_multi"] + 1
    assert scaled(blk, kernel.pairwise_block_plain(spec, Xr, Xc)) <= TOL[prec]
    for o, p in zip(outs, kernel.pairwise_matmat_multi_plain(spec, Xr, Xc,
                                                             Vs)):
        assert scaled(o, p) <= TOL[prec]


@pytest.mark.parametrize("nr,nc,d,m", [(1, 1, 1, 1), (3, 70, 40, 5),
                                       (65, 33, 33, 129), (200, 150, 72, 257)])
@pytest.mark.parametrize("name", ["rbf", "laplacian", "polynomial"])
def test_ragged_shapes_and_feature_chunks(cuda_device, nr, nc, d, m, name):
    """Tiles of one row, feature dims past the 32-wide staging chunk, and
    right-hand sides past one 128-column chunk — one per statistic."""
    rng = np.random.default_rng(2)
    Xr, Xc = _rand(rng, nr, d, dev=cuda_device), _rand(rng, nc, d,
                                                      dev=cuda_device)
    V = _rand(rng, nc, m, dev=cuda_device)
    spec = specs.suggested_spec(name, d)
    assert scaled(kernel.pairwise_block(spec, Xr, Xc),
                  kernel.pairwise_block_plain(spec, Xr, Xc)) <= 1e-5
    (out,) = kernel.pairwise_matmat_multi(spec, Xr, Xc, [V])
    (plain,) = kernel.pairwise_matmat_multi_plain(spec, Xr, Xc, [V])
    assert out.shape == (nr, m)
    assert scaled(out, plain) <= 1e-5


@pytest.mark.parametrize("start,length", [(0, 70), (65, 200), (250, 130)])
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("prec", PRECISIONS)
def test_slab_matches_plain_and_b1_rows(cuda_device, name, prec, start,
                                        length):
    """B4 at a head, a middle and a clamped tail slab of n = 300: against
    its plain version, and row for row bit for bit against B1's output (the
    clamp rows against B1's last row); one launch per call."""
    rng = np.random.default_rng(4)
    n = 300
    X = _rand(rng, n, D, dev=cuda_device)
    Vs = [_rand(rng, n, 3, dev=cuda_device),
          _rand(rng, n, 130, dev=cuda_device)]
    spec = specs.suggested_spec(name, D).with_precision(prec)
    before = kernel.launch_counts()["pairwise_matmat_multi_slab"]
    outs = kernel.pairwise_matmat_multi_slab(spec, X, start, length, Vs)
    assert kernel.launch_counts()["pairwise_matmat_multi_slab"] == before + 1
    plain = kernel.pairwise_matmat_multi_slab_plain(spec, X, start, length,
                                                    Vs)
    full = kernel.pairwise_matmat_multi_cuda(spec, X, X, Vs)
    rows = kernel.slab_rows(n, start, length, cuda_device)
    for o, p, f in zip(outs, plain, full):
        assert o.shape == (length, p.shape[1])
        assert scaled(o, p) <= TOL[prec]
        assert torch.equal(o, f[rows])


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    X = torch.zeros((8, 4), device=cuda_device)
    spec = specs.rbf(1.0)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.pairwise_block_cuda(spec, X.T.contiguous().T, X)
    with pytest.raises(ValueError, match="on"):
        kernel.pairwise_matmat_multi(spec, X, X, [torch.zeros((8, 2))])
    with pytest.raises(ValueError, match="d ≥ 1"):
        kernel.pairwise_block_cuda(spec, X[:, :0].contiguous(),
                                   X[:, :0].contiguous())


def test_library_checks_scratch_and_reports_passes(cuda_device):
    """The library reports the tensor-core passes it runs (f32: four split-
    TF32 passes of the statistic and of the contraction; bf16_f32acc: one;
    l1dist's statistic is on the CUDA cores) and refuses a scratch buffer
    smaller than the launch needs, or same != 0 for keys that are not the
    rows."""
    from repro_torch.kernels.pairwise import build
    lib = build.load_library()
    ids = kernel._STAT_IDS
    assert [lib.pairwise_passes(ids["sqdist"], 0, w) for w in (0, 1)] == [4, 4]
    assert [lib.pairwise_passes(ids["dot"], 1, w) for w in (0, 1)] == [1, 1]
    assert lib.pairwise_passes(ids["l1dist"], 0, 0) == 0
    assert lib.pairwise_statistic_builds(1064) == 9
    rng = np.random.default_rng(3)
    n, d, m = 100, 16, 5
    spec = specs.rbf(1.0)
    ep = kernel._epilogue(spec)
    X, V = _rand(rng, n, d, dev=cuda_device), _rand(rng, n, m, dev=cuda_device)
    Y = X.clone()
    out = torch.empty((n, m), device=cuda_device)

    def launch(xc, same, nbytes):
        ws = torch.empty((max(nbytes, 1),), dtype=torch.uint8,
                         device=cuda_device)
        code = lib.pairwise_matmat_multi_f32(
            kernel._ptr(X), kernel._ptr(xc), kernel._ptr(V), kernel._ptr(out),
            n, n, d, m, same, ids[spec.stat], ep.id, ep.a, ep.b, ep.degree, 0,
            kernel._ptr(ws), nbytes, cuda_device.index or 0,
            kernel._stream(cuda_device))
        torch.cuda.synchronize()
        return code, lib.pairwise_error_string(code).decode()

    need = lib.pairwise_workspace_bytes(n, n, d, m, ids[spec.stat], 0, 1)
    assert "smaller" in launch(X, 1, need - 1)[1]
    need2 = lib.pairwise_workspace_bytes(n, n, d, m, ids[spec.stat], 0, 0)
    assert "not the rows" in launch(Y, 1, need2)[1]
    assert launch(X, 1, need)[0] == 0
    want = kernel.pairwise_matmat_multi_cuda(spec, X, X, [V])[0]
    assert torch.equal(out, want)
    assert launch(Y, 0, need2)[0] == 0
    assert torch.equal(out, want)


def test_fast_model_with_error_is_one_fused_launch(cuda_device):
    """The slice on the card: one fused launch, the reference's count
    model, and the same model as the plain versions on the CPU."""
    rng = np.random.default_rng(1)
    n, c, s = 700, 24, 96
    X = rng.normal(size=(n, D)).astype(np.float32)
    idx = rng.choice(n, c, replace=False)
    S = (rng.normal(size=(n, s)) / np.sqrt(s)).astype(np.float32)
    Z = rng.choice([-1.0, 1.0], size=(n, 64)).astype(np.float32)
    op = CountingOperator(PairwiseKernel(X, specs.rbf(3.0),
                                         device=cuda_device))
    kernel.reset_launch_counts()
    ap, err = spsd.fast_model_with_error(op, c, s, idx=idx, S=S, Z=Z)
    torch.cuda.synchronize()
    assert kernel.launch_counts()["pairwise_matmat_multi"] == 1
    assert op.counts["sweeps"] == 1 and op.last_route == "fused"
    b = sweep_lib.resolved_block_size(n, n, None)
    assert op.counts["entries"] == -(-n // b) * b * n
    cpu = PairwiseKernel(X, specs.rbf(3.0), device="cpu")
    ap_cpu, err_cpu = spsd.fast_model_with_error(cpu, c, s, idx=idx, S=S,
                                                 Z=Z)
    assert scaled(ap.C.cpu(), ap_cpu.C) <= 1e-5
    assert scaled(ap.dense().cpu(), ap_cpu.dense()) <= 1e-4
    assert abs(float(err) - float(err_cpu)) <= 1e-5


@pytest.mark.parametrize("prec", PRECISIONS)
def test_exp_affine_epilogue_matches_plain_versions(cuda_device, prec):
    """The softmax-Gram spec exp(t/√d − offset) in both kernels."""
    rng = np.random.default_rng(3)
    X = _rand(rng, 300, 64, dev=cuda_device) * 0.4
    V = _rand(rng, 170, 140, dev=cuda_device)
    spec = tsa.softmax_gram_operator(X).spec.with_precision(prec)
    assert spec.epilogue.kind == "exp_affine"
    Xr, Xc = X[:130].contiguous(), X[130:].contiguous()
    assert scaled(kernel.pairwise_block(spec, Xr, Xc),
                  kernel.pairwise_block_plain(spec, Xr, Xc)) <= TOL[prec]
    (out,) = kernel.pairwise_matmat_multi(spec, Xr, Xc, [V])
    (plain,) = kernel.pairwise_matmat_multi_plain(spec, Xr, Xc, [V])
    assert scaled(out, plain) <= TOL[prec]


@pytest.mark.parametrize("d", [1, 8, 16, 33, 72, 256])
@pytest.mark.parametrize("nr,nc,m", [(1, 130, 1), (129, 1001, 5),
                                     (70, 257, 129), (200, 300, 257),
                                     (130, 700, 1064)])
def test_tensor_core_tiles_at_every_shape(cuda_device, d, nr, nc, m):
    """The tensor-core kernels at feature widths off the 8-wide TF32 step
    and across 128-byte chunks, one row, ragged key counts and right-hand
    sides of 1 to 1,064 columns: f32 against the plain versions (≤ 1e-5),
    the one-hot gather through B1 equal to B2's entries bit for bit, B4's
    rows equal to B1's.  The tensor cores flush subnormal inputs, so an
    entry below 2^-104 (whose TF32 parts reach below 2^-126) may come back
    short by less than 2^-126: that is the contract checked there."""
    rng = np.random.default_rng(d + nr)
    # points of variance 16 / d: the suggested parameters keep entries O(1)
    # at d = 16 (at d = 256 unit-variance rbf entries all underflow)
    sd = (16.0 / d) ** 0.5
    Xr, Xc = (_rand(rng, n, d, dev=cuda_device) * sd for n in (nr, nc))
    gidx = torch.as_tensor(rng.choice(nc, min(nc, 17), replace=False),
                           device=cuda_device)
    Vs = [sweep_lib.one_hot_columns(gidx, nc, cuda_device),
          _rand(rng, nc, m, dev=cuda_device)]
    for spec in (specs.suggested_spec("rbf", d), specs.suggested_spec(
            "polynomial", d), specs.suggested_spec("laplacian", d)):
        blk = kernel.pairwise_block(spec, Xr, Xc)
        assert scaled(blk, kernel.pairwise_block_plain(spec, Xr, Xc)) <= 1e-5
        outs = kernel.pairwise_matmat_multi(spec, Xr, Xc, Vs)
        plain = kernel.pairwise_matmat_multi_plain(spec, Xr, Xc, Vs)
        assert outs[1].shape == (nr, m)
        assert scaled(outs[1], plain[1]) <= 1e-5
        direct = kernel.pairwise_block(spec, Xr, Xc[gidx])
        gap = (outs[0] - direct).abs()
        assert bool(torch.where(direct.abs() >= 2.0 ** -104, gap == 0,
                                gap < 2.0 ** -126).all())
        slab = kernel.pairwise_matmat_multi_slab(spec, Xc, nc // 3, nc, Vs)
        full = kernel.pairwise_matmat_multi(spec, Xc, Xc, Vs)
        rows = kernel.slab_rows(nc, nc // 3, nc, cuda_device)
        for o, f in zip(slab, full):
            assert torch.equal(o, f[rows])


@pytest.mark.parametrize("prec", PRECISIONS)
def test_block_kernel_under_exp_affine_at_head_width_256(cuda_device, prec):
    """B2's operation-bound case: the softmax Gram at d = 256 (eight
    128-byte feature chunks a tile), ragged in both dimensions."""
    rng = np.random.default_rng(5)
    K = _rand(rng, 1400, 256, dev=cuda_device) * 0.4
    spec = tsa.softmax_gram_operator(K).spec.with_precision(prec)
    Kr = K[:300].contiguous()
    assert scaled(kernel.pairwise_block(spec, Kr, K),
                  kernel.pairwise_block_plain(spec, Kr, K)) <= TOL[prec]


def _read_inputs(m, c, d, dv, dev, dtype):
    rng = np.random.default_rng(3)
    Q = (_rand(rng, m, d, dev=dev) * 0.5).to(dtype)
    kl = (_rand(rng, c, d, dev=dev) * 0.5).to(dtype)
    UV = _rand(rng, c, dv, dev=dev).to(dtype)
    U1 = _rand(rng, c, dev=dev).abs() + 0.5
    return Q, kl, UV, U1, torch.tensor([0.3], device=dev)


@pytest.mark.parametrize("m,c,d,dv", [(128, 16, 64, 64), (200, 32, 32, 16),
                                      (64, 8, 128, 128), (1, 16, 64, 64),
                                      (300, 130, 40, 300)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_landmark_read_matches_plain_version(cuda_device, m, c, d, dv,
                                             dtype):
    """The reference's shapes, plus a ragged one past one landmark chunk,
    one feature chunk and one 256-wide value chunk."""
    args = _read_inputs(m, c, d, dv, cuda_device, dtype)
    before = lm_kernel.launch_counts()["landmark_read"]
    out = lm_ops.landmark_read(*args)
    assert lm_kernel.launch_counts()["landmark_read"] == before + 1
    plain = lm_kernel.landmark_read_plain(*args)
    assert out.dtype == dtype and out.shape == plain.shape == (m, dv)
    if dtype == torch.float32:
        assert scaled(out, plain) <= 1e-5
    else:
        torch.testing.assert_close(out.float(), plain.float(), rtol=2e-2,
                                   atol=2e-2)
    Q, kl, UV, U1, off = args
    flipped = lm_ops.landmark_read(Q, kl, UV, -U1, off)
    assert torch.equal(flipped, -out)


def _default_route(Q, kl, dv) -> str:
    """The route the wrapper takes for Q and dv (its own rule)."""
    sms = torch.cuda.get_device_properties(Q.device).multi_processor_count
    return "tc" if lm_kernel.tma_loadable(Q) and \
        lm_kernel.tensor_core_route(Q.shape[0], kl.shape[0], dv, sms) \
        else "split"


@pytest.mark.parametrize("m", [1, 16, 127, 128, 129, 256, 257, 4096])
@pytest.mark.parametrize("c,d,dv", [(512, 256, 256), (130, 40, 300),
                                    (100, 100, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("route", [None, "tc", "split"])
def test_landmark_read_routes_at_their_edges(cuda_device, m, c, d, dv, dtype,
                                            route):
    """Both routes of B5 (None: the one the shape picks) at the query
    counts around their tiles (16-row split blocks, 128-row tensor-core
    blocks) and the threshold (at the main width between 256 and 257), at a
    ragged shape with dv > 256, and with d not a multiple of 32 and c not
    a multiple of 64: the route by the counters, identical bits for
    identical calls, the U1 sign flip exact, and the plain-version gates
    (f32 ≤ 1e-5 scale-normalized, bf16 within rtol = atol = 2e-2).  bf16
    rows of 200 bytes cannot be loaded by TMA: the tensor-core route
    refuses them and the default takes the split route."""
    args = _read_inputs(m, c, d, dv, cuda_device, dtype)
    Q, kl, UV, U1, off = args
    lm_kernel.reset_launch_counts()
    if route == "tc" and not lm_kernel.tma_loadable(Q):
        with pytest.raises(ValueError, match="16-byte"):
            lm_kernel.landmark_read_cuda(*args, route=route)
        assert lm_kernel.launch_counts()["landmark_read"] == 0
        return
    want = route or _default_route(Q, kl, dv)
    out = lm_kernel.landmark_read_cuda(*args, route=route)
    again = lm_kernel.landmark_read_cuda(*args, route=route)
    flipped = lm_kernel.landmark_read_cuda(Q, kl, UV, -U1, off, route=route)
    torch.cuda.synchronize()
    other = "split" if want == "tc" else "tc"
    assert lm_kernel.launch_counts() == {"landmark_read": 3,
                                         f"landmark_read_{want}": 3,
                                         f"landmark_read_{other}": 0}
    assert torch.equal(out, again)
    assert torch.equal(flipped, -out)
    plain = lm_kernel.landmark_read_plain(*args)
    assert out.dtype == dtype and out.shape == plain.shape == (m, dv)
    if dtype == torch.float32:
        assert scaled(out, plain) <= 1e-5
    else:
        torch.testing.assert_close(out.float(), plain.float(), rtol=2e-2,
                                   atol=2e-2)


def test_landmark_decode_runs_the_kernel(cuda_device):
    rng = np.random.default_rng(4)
    K = _rand(rng, 512, 32, dev=cuda_device) * 0.4
    V = _rand(rng, 512, 32, dev=cuda_device)
    st = tsa.build_landmark_state(K, V, 32, generator=torch.Generator(
        device=cuda_device).manual_seed(0), device=cuda_device)
    q = _rand(rng, 5, 32, dev=cuda_device) * 0.4
    lm_kernel.reset_launch_counts()
    out = tsa.landmark_decode(st, q)
    assert lm_kernel.launch_counts() == {"landmark_read": 1,
                                         "landmark_read_tc": 0,
                                         "landmark_read_split": 1}
    plain = lm_kernel.landmark_read_plain(q, st.k_land, st.UV, st.U1,
                                          st.scale)
    assert scaled(out, plain) <= 1e-5
    with pytest.raises(TypeError, match="float32"):
        lm_kernel.landmark_read_cuda(q, st.k_land, st.UV, st.U1.double(),
                                     st.scale.reshape(1))


# the shapes of the reference's test_flash_vs_ref
FLASH_SHAPES = [(1, 4, 4, 128, 128, 64), (2, 8, 2, 128, 128, 32),
                (1, 4, 1, 256, 256, 64), (2, 4, 2, 100, 100, 32),
                (1, 2, 2, 1, 256, 64), (1, 4, 2, 64, 256, 32)]


def _flash_inputs(shape, dev, dtype, seed=0):
    B, Hq, Hkv, Sq, Sk, D = shape
    rng = np.random.default_rng(seed)
    q = (_rand(rng, B, Hq, Sq, D, dev=dev) * 0.5).to(dtype)
    k = (_rand(rng, B, Hkv, Sk, D, dev=dev) * 0.5).to(dtype)
    v = _rand(rng, B, Hkv, Sk, D, dev=dev).to(dtype)
    return q, k, v


def _flash_close(out, plain):
    assert out.dtype == plain.dtype and out.shape == plain.shape
    if out.dtype == torch.float32:
        assert scaled(out, plain) <= 1e-5
    else:
        torch.testing.assert_close(out.float(), plain.float(), rtol=2e-2,
                                   atol=2e-2)


@pytest.mark.parametrize("shape", FLASH_SHAPES + [(2, 4, 2, 300, 300, 256)])
@pytest.mark.parametrize("window", [None, 16, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain_version(cuda_device, shape, window,
                                               dtype):
    """The reference's flash shapes with and without a window, plus a
    ragged one at gemma3's head_dim 256; one launch per call."""
    q, k, v = _flash_inputs(shape, cuda_device, dtype)
    before = fa_kernel.launch_counts()["flash_attention"]
    out = fa_ops.flash_attention(q, k, v, causal=True, window=window)
    assert fa_kernel.launch_counts()["flash_attention"] == before + 1
    _flash_close(out, fa_kernel.flash_attention_plain(q, k, v, causal=True,
                                                      window=window))


@pytest.mark.parametrize("shape", [(2, 4, 2, 100, 100, 32),
                                   (1, 4, 2, 64, 256, 32),
                                   (1, 2, 1, 70, 130, 256)])
@pytest.mark.parametrize("window", [None, 24])
def test_flash_attention_non_causal(cuda_device, shape, window):
    q, k, v = _flash_inputs(shape, cuda_device, torch.float32, seed=6)
    out = fa_ops.flash_attention(q, k, v, causal=False, window=window)
    _flash_close(out, fa_kernel.flash_attention_plain(q, k, v, causal=False,
                                                      window=window))


def test_flash_attention_takes_strided_views(cuda_device):
    """(B, S, H, D) activations viewed as (B, H, S, D), as the model passes
    them: no copy, and the output comes back in the same layout."""
    rng = np.random.default_rng(5)
    q, k, v = (_rand(rng, 2, 70, h, 64, dev=cuda_device).transpose(1, 2)
               for h in (4, 2, 2))
    out = fa_ops.flash_attention(q, k, v, causal=True, window=24)
    assert out.stride() == q.stride()
    assert scaled(out, fa_kernel.flash_attention_plain(
        q, k, v, causal=True, window=24)) <= 1e-5
    with pytest.raises(ValueError, match="feature axis"):
        fa_kernel.flash_attention_cuda(q.transpose(2, 3).contiguous()
                                       .transpose(2, 3), k, v)


# the tensor-core kernel's edge cases (bf16): (B, Hq, Hkv, Sq, Sk, D, Dv),
# causal, window
TC_EDGES = [((1, 2, 1, 100, 100, 64, 64), True, None),
            ((1, 2, 1, 1000, 1000, 64, 64), True, 200),
            ((1, 2, 1, 300, 300, 32, 32), True, None),
            ((1, 2, 1, 300, 300, 128, 128), True, None),
            ((1, 2, 1, 300, 300, 256, 256), True, None),
            ((1, 2, 1, 300, 300, 64, 128), True, None),
            ((1, 2, 1, 300, 300, 128, 64), True, 100),
            ((2, 4, 2, 1, 1000, 256, 256), True, None),
            ((2, 4, 2, 1, 1000, 256, 256), True, 64),
            ((1, 4, 2, 100, 1000, 128, 128), True, None),
            ((1, 2, 1, 100, 1000, 256, 256), False, None),
            ((1, 2, 1, 100, 1000, 256, 256), False, 100)]


@pytest.mark.parametrize("shape,causal,window", TC_EDGES)
def test_flash_tensor_core_edge_cases(cuda_device, shape, causal, window):
    """bf16 goes to the tensor-core kernel (one launch of it per call) and
    agrees with the plain version at ragged lengths, every head width,
    Dv ≠ D, decode, chunked prefill and without causality: within
    rtol = atol = 2e-2, and every (b, h, row) within 1e-2 in its own
    relative error (where the softmax is flat the outputs are small and
    the atol alone would pass a dropped or doubled key tile)."""
    B, Hq, Hkv, Sq, Sk, D, Dv = shape
    rng = np.random.default_rng(7)
    q = (_rand(rng, B, Hq, Sq, D, dev=cuda_device) * 0.5).to(torch.bfloat16)
    k = (_rand(rng, B, Hkv, Sk, D, dev=cuda_device) * 0.5).to(torch.bfloat16)
    v = _rand(rng, B, Hkv, Sk, Dv, dev=cuda_device).to(torch.bfloat16)
    tc0 = fa_kernel.launch_counts()["flash_attention_tc"]
    out = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    assert fa_kernel.launch_counts()["flash_attention_tc"] == tc0 + 1
    plain = fa_kernel.flash_attention_plain(q, k, v, causal=causal,
                                            window=window)
    _flash_close(out, plain)
    o, p = out.double(), plain.double()
    row_err = (o - p).norm(dim=-1) / p.norm(dim=-1).clamp_min(1e-300)
    assert float(row_err.max()) <= 1e-2, float(row_err.max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,window", [((1, 2, 1, 300, 100, 64), None),
                                          ((2, 4, 2, 200, 60, 32), 24)])
def test_flash_rows_without_keys_are_zero(cuda_device, shape, window, dtype):
    """Causal with Sq > Sk: the first Sq − Sk query rows see no key and come
    back exactly 0 on both routes, as the plain version and the reference's
    kernel give them (at Sq − Sk = 200 the tensor-core kernel's first
    128-row block sees no key tile at all)."""
    B, Hq, Hkv, Sq, Sk, D = shape
    q, k, v = _flash_inputs(shape, cuda_device, dtype, seed=9)
    out = fa_ops.flash_attention(q, k, v, causal=True, window=window)
    plain = fa_kernel.flash_attention_plain(q, k, v, causal=True,
                                            window=window)
    assert not bool(torch.isnan(out).any())
    assert bool((out[:, :, :Sq - Sk] == 0).all())
    assert bool((plain[:, :, :Sq - Sk] == 0).all())
    _flash_close(out, plain)


def test_flash_routes_by_dtype(cuda_device):
    """bf16 launches the tensor-core kernel, f32 the CUDA-core one; both
    count in ``flash_attention``, only bf16 in ``flash_attention_tc``."""
    q, k, v = _flash_inputs((1, 4, 2, 70, 70, 64), cuda_device,
                            torch.float32)
    fa_kernel.reset_launch_counts()
    fa_ops.flash_attention(q, k, v)
    assert fa_kernel.launch_counts() == {"flash_attention": 1,
                                         "flash_attention_tc": 0}
    fa_ops.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
    torch.cuda.synchronize()
    assert fa_kernel.launch_counts() == {"flash_attention": 2,
                                         "flash_attention_tc": 1}


def test_flash_tensor_core_refuses_what_tma_cannot_load(cuda_device):
    """A bf16 view with a misaligned base or a row stride that is not a
    multiple of 16 bytes raises; nothing falls back to the CUDA-core kernel
    or the plain version."""
    flat = torch.zeros(1 + 2 * 64 * 64, dtype=torch.bfloat16,
                       device=cuda_device)
    shifted = flat[1:].view(1, 2, 64, 64)
    ok = torch.zeros((1, 2, 64, 64), dtype=torch.bfloat16,
                     device=cuda_device)
    odd = torch.zeros((1, 2, 64, 36), dtype=torch.bfloat16,
                      device=cuda_device)
    fa_kernel.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte aligned base"):
        fa_ops.flash_attention(shifted, ok, ok)
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        fa_ops.flash_attention(odd, odd, odd)
    assert fa_kernel.launch_counts() == {"flash_attention": 0,
                                         "flash_attention_tc": 0}


def test_smoke_model_on_the_card_matches_the_cpu(cuda_device):
    """gemma3-12b's smoke model with landmark decode: prefill and three
    decode steps on the card against the same params on the CPU; one B6
    launch per layer in prefill, none in decode."""
    cfg = dataclasses.replace(gemma3_12b.SMOKE, use_landmark_decode=True)
    model = tm.build_model(cfg)
    params = model.prepare(model.init(torch.Generator().manual_seed(0),
                                      "cpu"))
    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, dev) for v in tree]
        return tree.to(dev)

    on_card = to(params, cuda_device)
    toks = torch.randint(0, cfg.vocab_size, (2, 36),
                         generator=torch.Generator().manual_seed(1))
    outs = {}
    for dev, p in (("cpu", params), ("cuda", on_card)):
        fa_kernel.reset_launch_counts()
        lg, cache = model.prefill(p, {"tokens": toks[:, :32].to(dev)}, 40,
                                  generator=torch.Generator().manual_seed(2))
        seq = [lg]
        prefill_launches = fa_kernel.launch_counts()["flash_attention"]
        for t in range(32, 35):
            lg, cache = model.decode_step(p, cache, toks[:, t:t + 1].to(dev),
                                          t)
            seq.append(lg)
        torch.cuda.synchronize()
        outs[dev] = (torch.stack(seq).float().cpu(), prefill_launches,
                     fa_kernel.launch_counts()["flash_attention"])
    assert outs["cpu"][1:] == (0, 0)
    assert outs["cuda"][1:] == (cfg.n_layers, cfg.n_layers)
    assert scaled(outs["cuda"][0], outs["cpu"][0]) <= 5e-2


# B6 at the head shapes of the MoE/MLA/dense configs: (B, Hq, Hkv, Sq, Sk, D,
# Dv) -- yi's GQA group 8 and qwen2-moe's MHA at D = 128; MLA's q/k of
# 128 + 64 and v of 128 (the HD = 256 instance, zero-filled past D and Dv),
# also causal with Sq > Sk
MODEL_HEAD_SHAPES = [(1, 32, 4, 300, 300, 128, 128),
                     (1, 16, 16, 300, 300, 128, 128),
                     (1, 8, 8, 300, 300, 192, 128),
                     (1, 8, 8, 300, 100, 192, 128)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", MODEL_HEAD_SHAPES)
def test_flash_at_the_model_head_shapes(cuda_device, shape, dtype):
    """Both routes against the plain version (f32 ≤ 1e-5; bf16 within
    rtol = atol = 2e-2 and every row within 1e-2); the MLA shape with v a
    strided view of the (B, S, H, nope + v) projection, as the model passes
    it; rows that see no key exactly 0."""
    B, Hq, Hkv, Sq, Sk, D, Dv = shape
    rng = np.random.default_rng(11)
    q = (_rand(rng, B, Hq, Sq, D, dev=cuda_device) * 0.5).to(dtype)
    k = (_rand(rng, B, Hkv, Sk, D, dev=cuda_device) * 0.5).to(dtype)
    if D == Dv:
        v = _rand(rng, B, Hkv, Sk, Dv, dev=cuda_device).to(dtype)
    else:
        kvb = _rand(rng, B, Sk, Hkv, 128 + Dv, dev=cuda_device).to(dtype)
        v = kvb[..., 128:].transpose(1, 2)
    counts = fa_kernel.launch_counts()
    out = fa_ops.flash_attention(q, k, v, causal=True)
    after = fa_kernel.launch_counts()
    assert after["flash_attention"] == counts["flash_attention"] + 1
    assert after["flash_attention_tc"] == counts["flash_attention_tc"] + (
        dtype == torch.bfloat16)
    assert out.shape == (B, Hq, Sq, Dv)
    plain = fa_kernel.flash_attention_plain(q, k, v, causal=True)
    _flash_close(out, plain)
    if Sq > Sk:
        assert bool((out[:, :, :Sq - Sk] == 0).all())
    if dtype == torch.bfloat16:
        o, p = out.double(), plain.double()
        keep = p.norm(dim=-1) > 0
        row_err = (o - p).norm(dim=-1)[keep] / p.norm(dim=-1)[keep]
        assert float(row_err.max()) <= 1e-2, float(row_err.max())


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_ffn_on_the_card_matches_the_cpu(cuda_device, cf):
    """qwen2-moe's SMOKE MoE FFN in bf16 at T = 4,096 tokens: the card's
    output within 5e-2 of the CPU's (scale-normalized), bit-equal across
    two calls; the stable sort drops the same assignments on both (the
    plan from the same expert ids is equal entry for entry)."""
    cfg = dataclasses.replace(get_smoke("qwen2-moe-a2.7b"),
                              capacity_factor=cf)
    params = tmoe.init_moe(torch.Generator().manual_seed(0), cfg, "cpu")
    prepared = tm.build_model(cfg).prepare({"moe": params})["moe"]
    on_card = {k: (v.to(cuda_device) if isinstance(v, torch.Tensor) else
                   {kk: vv.to(cuda_device) for kk, vv in v.items()})
               for k, v in prepared.items()}
    x = torch.as_tensor(np.random.default_rng(12).normal(
        size=(2, 2048, cfg.d_model)), dtype=torch.float32).to(torch.bfloat16)
    cpu_out, cpu_aux = tmoe.moe_ffn(prepared, cfg, x)
    out, aux = tmoe.moe_ffn(on_card, cfg, x.to(cuda_device))
    again, _ = tmoe.moe_ffn(on_card, cfg, x.to(cuda_device))
    assert torch.equal(out, again)
    assert scaled(out.float().cpu(), cpu_out.float()) <= 5e-2
    assert abs(float(aux) - float(cpu_aux)) <= 1e-4 * float(cpu_aux)
    _, idx, _ = tmoe._route(prepared, cfg, x.reshape(-1, cfg.d_model))
    C = tmoe.capacity(cfg, idx.shape[0])
    plan_cpu = tmoe._assign(cfg, idx, C)
    plan_card = tmoe._assign(cfg, idx.to(cuda_device), C)
    for a, b in zip(plan_cpu, plan_card):
        assert torch.equal(a, b.cpu())
    assert bool(plan_cpu[2].all()) == (cf == 1.25)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "deepseek-v3-671b"])
def test_moe_and_mla_smoke_models_on_the_card_match_the_cpu(cuda_device,
                                                            arch):
    """The SMOKE model in f32 (B6 on its CUDA-core route, TF32 off):
    prefill and three decode steps on the card against the CPU, ≤ 1e-4;
    one B6 launch per layer in prefill, none in decode."""
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    model = tm.build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, dev) for v in tree]
        return tree.to(dev)

    toks = torch.randint(0, cfg.vocab_size, (2, 36),
                         generator=torch.Generator().manual_seed(1))
    outs = {}
    for dev, p in (("cpu", params), ("cuda", to(params, cuda_device))):
        fa_kernel.reset_launch_counts()
        lg, cache = model.prefill(p, {"tokens": toks[:, :32].to(dev)}, 40)
        seq = [lg]
        prefill_launches = fa_kernel.launch_counts()["flash_attention"]
        for t in range(32, 35):
            lg, cache = model.decode_step(p, cache, toks[:, t:t + 1].to(dev),
                                          t)
            seq.append(lg)
        torch.cuda.synchronize()
        outs[dev] = (torch.stack(seq).cpu(), prefill_launches,
                     fa_kernel.launch_counts()["flash_attention"])
    assert outs["cpu"][1:] == (0, 0)
    assert outs["cuda"][1:] == (cfg.n_layers, cfg.n_layers)
    assert scaled(outs["cuda"][0], outs["cpu"][0]) <= 1e-4


# ---------------------------------------------------------------------------
# the serving path's launches: B1 at the cross and append shapes
# ---------------------------------------------------------------------------

#: head widths of a bucket: KRR alone (1), KRR + KPCA (9), all three tasks
#: with a 200-wide feature head (209)
CROSS_WIDTHS = {1: (1,), 9: (1, 8), 209: (1, 8, 200)}


def _serving_points(rng, n, dev):
    """The serving problem's points (X ~ N(0, I_16)); RBF σ = 3."""
    return _rand(rng, n, D, dev=dev)


@pytest.mark.parametrize("n_q", [5, 17, 33, 64, 2048])
@pytest.mark.parametrize("c", [48, 200])
@pytest.mark.parametrize("M", sorted(CROSS_WIDTHS))
def test_cross_launch_at_serving_shapes_row_by_row(cuda_device, n_q, c, M):
    """``PairwiseKernel.cross`` over c landmarks, one B1 launch for every
    head: each row's error against the plain version is at most 1e-5 of
    that row's Σ_j |K_ij|·|V_jk| (the size of the sum's terms), so a row
    whose answer cancels to a small value is held to its own terms."""
    rng = np.random.default_rng(n_q + c + M)
    X_land = _serving_points(rng, c, cuda_device)
    Xq = _serving_points(rng, n_q, cuda_device)
    heads = [_rand(rng, c, m, dev=cuda_device) for m in CROSS_WIDTHS[M]]
    op = PairwiseKernel(X_land, specs.rbf(3.0), device=cuda_device)
    before = kernel.launch_counts()["pairwise_matmat_multi"]
    outs = op.cross(Xq, heads)
    assert kernel.launch_counts()["pairwise_matmat_multi"] == before + 1
    K = kernel.pairwise_block_plain(op.spec, Xq, X_land)
    for out, V, plain in zip(outs, heads, kernel.pairwise_matmat_multi_plain(
            op.spec, Xq, X_land, heads)):
        assert tuple(out.shape) == (n_q, V.shape[1])
        terms = (K.abs() @ V.abs()).amax(dim=1)
        row_err = (out - plain).abs().amax(dim=1) / terms
        assert float(row_err.max()) <= 1e-5


@pytest.mark.parametrize("b,c", [(5, 48), (16, 48), (64, 200)])
def test_append_launch_is_the_block_under_the_c2_contract(cuda_device, b, c):
    """The append path's launch, B1 with the identity as right-hand side,
    metered as one ``append_sweeps`` tick of b·c entries: G equals B2's
    entries of the same points bit for bit where they are ≥ 2^-104, else
    within 2^-126 (ROADMAP C2; RBF σ = 3 at d = 16 keeps these far above
    it), and the plain version to ≤ 1e-5."""
    rng = np.random.default_rng(b * c)
    X_land = _serving_points(rng, c, cuda_device)
    Xn = _serving_points(rng, b, cuda_device)
    op = CountingOperator(PairwiseKernel(X_land, specs.rbf(3.0),
                                         device=cuda_device))
    eye = torch.eye(c, device=cuda_device)
    (G,) = op.append_cross(Xn, (eye,))
    assert op.counts["append_sweeps"] == 1 and op.counts["cross_sweeps"] == 0
    assert op.counts["entries"] == b * c
    direct = kernel.pairwise_block(op.inner.spec, Xn, X_land)
    gap = (G - direct).abs()
    assert bool(torch.where(direct.abs() >= 2.0 ** -104, gap == 0,
                            gap < 2.0 ** -126).all())
    assert float(direct.abs().min()) >= 2.0 ** -104
    (plain,) = kernel.pairwise_matmat_multi_plain(op.inner.spec, Xn, X_land,
                                                  (eye,))
    assert scaled(G, plain) <= 1e-5


def test_serving_path_on_the_card(cuda_device, tmp_path):
    """Build, serve, append and warm-boot on the card at a small size: one
    B1 launch per build, per bucket and per appended batch; answers within
    1e-5 of the dense f64 oracles before and after the appends; the delta
    chain restored bit for bit."""
    from repro_torch import serve as tserve
    from repro_torch.launch import serve_kernel as tsk
    params = {"n": 600, "d": D, "c": 48, "s": 96, "alpha": 1.0,
              "n_components": 8, "kernel": "rbf",
              "spec_params": {"sigma": 3.0}, "seed": 0, "use_pallas": True}
    kernel.reset_launch_counts()
    art = tsk.build_from_params(params, device=cuda_device)
    assert kernel.launch_counts()["pairwise_matmat_multi"] == 1
    X, y = tsk.synth_problem(600, D, 0)
    rng = np.random.default_rng(1)
    reqs = [tserve.QueryRequest(rng.standard_normal((n, D)), t)
            for n, t in ((5, "krr"), (64, "kpca"), (33, "features"),
                         (17, "krr"))]
    kernel.reset_launch_counts()
    res = tserve.serve_kernel_model(art, reqs)
    assert kernel.launch_counts()["pairwise_matmat_multi"] == \
        len(tserve.plan_buckets(reqs))
    head = tserve.dense_krr_head(art, y)
    for r, q in zip(res, reqs):
        want = tserve.dense_krr_oracle(art, q.X, head=head) \
            if q.task == "krr" else tserve.dense_oracle(art, q.X, q.task)
        assert tserve.parity_gap(r.out, want) <= 1e-5, q.task
    d = str(tmp_path)
    tserve.save_artifact(d, art)
    m = tserve.IncrementalMaintainer(art, y, directory=d, X=X)
    kernel.reset_launch_counts()
    ys = [y[:, None]]
    for Xb, yb in tsk.synth_batches(params, 2, 64):
        m.append(Xb, yb)
        ys.append(yb[:, None])
    assert kernel.launch_counts()["pairwise_matmat_multi"] == 2
    Xq = rng.standard_normal((19, D)).astype(np.float32)
    (got,) = m.artifact.landmark_operator().cross(
        torch.as_tensor(Xq, device=cuda_device), (m.artifact.heads["krr"],))
    want = tserve.dense_krr_oracle(m.artifact, Xq, np.concatenate(ys))
    assert tserve.parity_gap(got, want) <= 1e-5
    restored = tserve.load_artifact(d, device=cuda_device)
    assert torch.equal(restored.C, m.artifact.C)
    assert all(torch.equal(restored.heads[t], m.artifact.heads[t])
               for t in tserve.TASKS)


@pytest.mark.parametrize("stat", ["sqdist", "l1dist", "dot"])
@pytest.mark.parametrize("n,m,d", [(1, 1, 1), (37, 129, 16), (300, 77, 5),
                                   (1000, 513, 40), (5000, 128, 16)])
@pytest.mark.parametrize("offset", [0.0, 8.0])
def test_statistic_only_block_at_ragged_edges(cuda_device, stat, n, m, d,
                                              offset):
    """B2 with the identity epilogue over the raw statistic (calibration's
    n × m gather) against its plain version; under sqdist and l1dist no
    entry is negative, the self-pairs included.  With the points offset far
    from the origin the sqdist combine ‖x‖² + ‖y‖² − 2x·y cancels most:
    there both versions round at the scale of the norms, so the kernel is
    held to the f64 statistic within twice the plain version's own error
    against it, plus 4 f32 ulps of the largest entry."""
    rng = np.random.default_rng(7)
    X = _rand(rng, n, d, dev=cuda_device) + offset
    m = min(m, n)
    idx = torch.as_tensor(rng.choice(n, size=m, replace=False),
                          device=cuda_device)
    Xa = X[idx]
    spec = specs.stat_only(stat)
    before = kernel.launch_counts()["pairwise_block"]
    out = kernel.pairwise_block(spec, X, Xa)
    assert kernel.launch_counts()["pairwise_block"] == before + 1
    assert out.shape == (n, m)
    plain = kernel.pairwise_block_plain(spec, X, Xa)
    norms = float((X.double() ** 2).sum(1).max()) * 2.0
    if stat == "sqdist" and offset:
        X64, A64 = X.double(), Xa.double()
        exact = torch.clamp((X64 ** 2).sum(1)[:, None] + (A64 ** 2).sum(1)
                            - 2.0 * X64 @ A64.T, min=0.0)
        err_k = float((out.double() - exact).abs().max())
        err_p = float((plain.double() - exact).abs().max())
        ulp = torch.finfo(torch.float32).eps * float(exact.abs().max())
        print(f"sqdist offset {offset} n={n} m={m} d={d}: vs f64 kernel "
              f"{err_k:.3g}, plain {err_p:.3g}, bound {2 * err_p + 4 * ulp:.3g}")
        assert err_k <= 2 * err_p + 4 * ulp
    else:
        assert scaled(out, plain) <= 1e-5
    if stat != "dot":
        assert bool((out >= 0).all())
        self_pairs = out[idx, torch.arange(m, device=cuda_device)]
        assert float(self_pairs.max()) <= 1e-6 * norms


@pytest.mark.parametrize("name", NAMES)
def test_calibrate_on_the_card_matches_the_cpu(cuda_device, name):
    """One B2 launch (none for linear), parameters ≤ 1e-5 of the CPU's."""
    from repro_torch.kernels.pairwise import calibrate
    rng = np.random.default_rng(8)
    X = rng.normal(size=(3000, D)).astype(np.float32)
    idx = rng.choice(3000, size=128, replace=False)
    spec = specs.suggested_spec(name, D)
    before = kernel.launch_counts()["pairwise_block"]
    got = calibrate.calibrate_sigma(X, spec=spec, anchor_idx=idx)
    launched = kernel.launch_counts()["pairwise_block"] - before
    want = calibrate.calibrate_sigma(X, spec=spec, anchor_idx=idx,
                                     device="cpu")
    assert launched == int(calibrate.calibration_rule(name).needs_stat)
    for (k, a), (_, b) in zip(got.params, want.params):
        assert abs(float(a) - float(b)) <= 1e-5 * abs(float(b)), (k, a, b)


def test_rbf_ops_are_the_pairwise_launches(cuda_device):
    """Each wrapper is the launch it binds, bit for bit, counted as B2/B1."""
    from repro_torch.kernels import rbf_ops
    from repro_torch.kernels.rbf_sketch import kernel as rbf_kernel
    rng = np.random.default_rng(9)
    Xr, Xc = _rand(rng, 70, D, dev=cuda_device), _rand(rng, 130, D,
                                                      dev=cuda_device)
    V = _rand(rng, 130, 9, dev=cuda_device)
    spec = specs.rbf(1.3)
    c0 = kernel.launch_counts()
    blk = rbf_ops.rbf_block(Xr, Xc, 1.3)
    (mm,) = rbf_ops.rbf_matmat_multi_rows(Xr, Xc, [V], 1.3)
    pad = rbf_kernel.rbf_matmat_padded(Xr, Xc, V, 1.3)
    c1 = kernel.launch_counts()
    assert c1["pairwise_block"] - c0["pairwise_block"] == 1
    assert c1["pairwise_matmat_multi"] - c0["pairwise_matmat_multi"] == 2
    assert torch.equal(blk, kernel.pairwise_block_cuda(spec, Xr, Xc))
    (ref,) = kernel.pairwise_matmat_multi_cuda(spec, Xr, Xc, [V])
    assert torch.equal(mm, ref) and torch.equal(pad, ref)


def test_append_takes_targets_on_the_card(cuda_device):
    """``append_rows`` with ``y_new`` a CUDA tensor (the contract checks'
    append on the card) equals the append with host targets."""
    from repro_torch import serve as tserve
    from repro_torch.analysis import trace_check
    size = trace_check.TraceSize(device="cuda")
    art, y = trace_check._artifact_problem(size)
    rng = np.random.default_rng(3)
    Xb = torch.as_tensor(rng.standard_normal((16, size.d)),
                         dtype=torch.float32, device=cuda_device)
    yb = rng.standard_normal(16).astype(np.float32)
    a1, *_ = tserve.append_rows(art, tserve.init_state(art, y), Xb, yb)
    a2, *_ = tserve.append_rows(art, tserve.init_state(art, y), Xb,
                                torch.as_tensor(yb, device=cuda_device))
    assert torch.equal(a1.heads["krr"], a2.heads["krr"])
