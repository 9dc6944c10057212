// Pairwise kernel tiles for NVIDIA Hopper (sm_90a), plain C interface.
//
// What each function replaces (the Pallas TPU kernels of the reference):
//
//   pairwise_block_f32         <- src/repro/kernels/pairwise/kernel.py
//                                 pairwise_block_padded / _pairwise_block_kernel
//                                 out[i, j] = entry(stat(Xr[i], Xc[j]))
//   pairwise_matmat_multi_f32  <- src/repro/kernels/pairwise/kernel.py
//                                 pairwise_matmat_multi_padded /
//                                 _pairwise_matmat_multi_kernel (+ _entry_tile,
//                                 _contract_tile)
//                                 out = K(Xr, Xc) @ V with K never written out
//   pairwise_matmat_multi_slab_f32
//                              <- src/repro/kernels/pairwise/kernel.py
//                                 pairwise_matmat_multi_slab /
//                                 _pairwise_matmat_slab_kernel
//                                 out = K(X[start : start + len], X) @ V, the
//                                 row slab of one shard of the data-parallel
//                                 sweep, addressed inside the launch
//
// The statistic (dot, sqdist, l1dist) and the entry function (identity,
// exp(-a t), Matern-3/2, integer polynomial, exp(a t - b)) are selected at run time by the
// ids the wrapper passes (KernelSpec.stat / KernelSpec.epilogue).  The
// l1dist statistic is the direct sum of |x_k - y_k| over the feature axis on
// the CUDA cores, in feature order; on data inside a sign-split plan the
// reference's two-contraction form is exact, so this is the same function.
//
// Precision.  f32 is true f32: FP32 FMAs on the CUDA cores, no TF32, IEEE
// expf/sqrtf (the build uses no fast-math flag), and the sqdist combine
// max((xx + yy) - 2 x.y, 0) is written with _rn intrinsics so the compiler
// cannot contract it.  The one-hot column gather that rides through
// pairwise_matmat_multi stays exact: each output is one entry times 1.0 plus
// exact zeros.  Under bf16_f32acc point values are rounded to bf16
// (round-to-nearest-even, __float2bfloat16) as they are staged, the
// statistic runs in f32 on the rounded values, and in the contraction the
// kernel entry and V are both rounded to bf16 before an f32 accumulation.
// A product of two bf16 values is exact in f32, so FP32 FMAs on the rounded
// values give the reference's bf16-operand / f32-accumulator contraction.
//
// What bounds them on the card.  pairwise_matmat_multi does 2 nr nc M flops
// of contraction plus ~2 d nr nc of statistic, against reads of the points
// and V and the write of out: at the main shape (nr = nc = 50,000, d = 16,
// M = 1,064) that is ~5.4e12 flops against ~0.43 GB, so it is bound by
// operations: under f32 the FP32 CUDA-core rate (67 TFLOP/s on an H100 SXM),
// under bf16_f32acc the tensor cores (989 TFLOP/s).
// pairwise_matmat_multi_slab does the same work per row: at one of two
// shards' slabs of the main shape (25,004 x 50,000, M = 1,064) ~2.7e12
// flops, also bound by operations.  pairwise_block moves
// nr nc 4-byte outputs and does ~2 d flops per output, so at d = 16 it is
// bound by the bytes it writes.
//
// The simple design.  Blocks run in parallel and nothing carries from one
// block to another: the TPU's sequential column-tile grid axis becomes a
// loop inside each block, so sums are deterministic and need no atomics.
//   * pairwise_matmat_multi: one block per (64-row tile, 128-column chunk of
//     V).  The block walks the column tiles of Xc 32 at a time: it stages
//     the point tiles in shared memory feature chunk by feature chunk, builds
//     the 64 x 32 K tile in shared memory, stages the 32 x 128 V tile, and
//     each of the 256 threads contracts them into a 4 x 8 register tile that
//     is then added to its running 4 x 8 output sum.  The two-level sum is
//     the reference's (a per-tile contraction added into the accumulator)
//     and keeps the rounding of a 50,000-term sum to ~1,600 running adds.  A K tile is therefore rebuilt once per 128-column chunk of V
//     (ceil(M / 128) times, 9 at the main shape), not once overall; building
//     each tile exactly once is a later redesign, as are wgmma, TMA and the
//     tensor cores for bf16_f32acc.
//   * pairwise_matmat_multi_slab: pairwise_matmat_multi's kernel itself,
//     run over the rows X[start + i], i < len, against all of X.  The TPU
//     kernel needs a scalar-prefetch block offset because one compiled
//     launch serves every traced slab position; here the start is a plain
//     64-bit argument and nothing is compiled per offset.  Rows past the
//     end clamp to the last row, per row (the reference clamps per 128-row
//     block on zero-padded points); the sweep's validity mask drops them
//     either way.  Each output row is computed by the same instructions in
//     the same order as B1's row start + i, so the two agree bit for bit.
//   * pairwise_block: one block per 64 x 32 output tile, staged in shared
//     memory and written out row-coalesced.
// Out-of-range rows and columns are masked explicitly (entries of invalid
// columns are set to 0 before the contraction; an entry can be inf or NaN,
// so 0 * entry is not relied on).  Row * leading-dimension offsets are
// 64-bit: n^2 exceeds 2^31 at the main shape.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int BR = 64;    // rows of a tile
constexpr int BC = 32;    // columns of a K tile (one contraction step)
constexpr int BM = 128;   // V columns per block (pairwise_matmat_multi)
constexpr int DK = 32;    // features staged per chunk
constexpr int NT = 256;   // threads per block
constexpr int CPT = BC / (NT / BR);  // K-tile columns per thread (8)

enum { STAT_DOT = 0, STAT_SQDIST = 1, STAT_L1 = 2 };
enum {
  EPI_IDENTITY = 0,
  EPI_EXP_NEG = 1,
  EPI_MATERN32 = 2,
  EPI_POLY = 3,
  EPI_EXP_AFFINE = 4   // exp(a t - b): the softmax Gram exp(t / sqrt(d) - offset)
};

struct Params {
  int epi;
  float a;
  float b;
  int degree;
  int bf16;
};

struct StatSmem {
  float xr[DK][BR + 1];   // row points, feature-major (padded: the
  float xc[DK][BC + 1];   // staging writes are conflict-free)
  float yy[BC];       // column squared norms (sqdist)
};

__device__ __forceinline__ float quant(float x, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16(x)) : x;
}

// x^p by binary exponentiation, in the reference's order of multiplications
__device__ __forceinline__ float ipow(float x, int p) {
  float acc = 1.f;
  bool have = false;
  while (p > 0) {
    if (p & 1) {
      acc = have ? __fmul_rn(acc, x) : x;
      have = true;
    }
    p >>= 1;
    if (p > 0) x = __fmul_rn(x, x);
  }
  return acc;
}

__device__ __forceinline__ float entry(float t, const Params& p) {
  switch (p.epi) {
    case EPI_EXP_NEG:
      return expf(__fmul_rn(-p.a, t));
    case EPI_MATERN32: {
      const float ar = __fmul_rn(p.a, sqrtf(fmaxf(t, 0.f)));
      return __fmul_rn(__fadd_rn(1.f, ar), expf(-ar));
    }
    case EPI_POLY:
      return ipow(__fadd_rn(__fmul_rn(p.a, t), p.b), p.degree);
    case EPI_EXP_AFFINE:   // two roundings, no FMA contraction
      return expf(__fsub_rn(__fmul_rn(t, p.a), p.b));
    default:
      return t;
  }
}

// The entries of one BR x BC tile, rows [r0, r0 + BR) x columns
// [c0, c0 + BC).  Thread tid owns row r = tid % BR and columns
// cg + 4 i (cg = tid / BR, i < CPT); ent[i] receives entry(stat).  Values of
// out-of-range rows and columns are unspecified: callers mask them.  Row i
// of the tile reads point min(row0 + r0 + i, row_last) of Xr: row0 = 0 and
// row_last = nr - 1 read rows in place, a slab passes its start and the
// last row of the data.
template <int STAT>
__device__ __forceinline__ void tile_entries(
    const float* __restrict__ Xr, const float* __restrict__ Xc, long long nr,
    long long nc, int d, long long r0, long long c0, long long row0,
    long long row_last, const Params& p, StatSmem& sm, float ent[CPT]) {
  const int tid = threadIdx.x;
  const int r = tid % BR;
  const int cg = tid / BR;
  float acc[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) acc[i] = 0.f;
  float xx = 0.f;    // squared norm of row r
  float yyc = 0.f;   // squared norm of column tid (tid < BC)
  for (int k0 = 0; k0 < d; k0 += DK) {
    const int kw = min(DK, d - k0);
    for (int e = tid; e < BR * kw; e += NT) {
      const int rr = e / kw, kk = e % kw;
      const long long gr = r0 + rr;
      const long long xrow = min(row0 + gr, row_last);
      sm.xr[kk][rr] = gr < nr ? quant(Xr[xrow * d + k0 + kk], p.bf16) : 0.f;
    }
    for (int e = tid; e < BC * kw; e += NT) {
      const int cc = e / kw, kk = e % kw;
      const long long gc = c0 + cc;
      sm.xc[kk][cc] = gc < nc ? quant(Xc[gc * d + k0 + kk], p.bf16) : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < kw; ++kk) {
      const float x = sm.xr[kk][r];
      if (STAT == STAT_L1) {
#pragma unroll
        for (int i = 0; i < CPT; ++i)
          acc[i] = __fadd_rn(acc[i], fabsf(__fsub_rn(x, sm.xc[kk][cg + 4 * i])));
      } else {
#pragma unroll
        for (int i = 0; i < CPT; ++i)
          acc[i] = fmaf(x, sm.xc[kk][cg + 4 * i], acc[i]);
        if (STAT == STAT_SQDIST) {
          xx = fmaf(x, x, xx);
          if (tid < BC) {
            const float y = sm.xc[kk][tid];
            yyc = fmaf(y, y, yyc);
          }
        }
      }
    }
    __syncthreads();
  }
  if (STAT == STAT_SQDIST) {
    if (tid < BC) sm.yy[tid] = yyc;
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    float t = acc[i];
    if (STAT == STAT_SQDIST)
      t = fmaxf(__fsub_rn(__fadd_rn(xx, sm.yy[cg + 4 * i]),
                          __fmul_rn(2.f, acc[i])), 0.f);
    ent[i] = entry(t, p);
  }
}

template <int STAT>
__global__ void __launch_bounds__(NT, 2)
pairwise_block_kernel(const float* __restrict__ Xr,
                      const float* __restrict__ Xc, float* __restrict__ out,
                      long long nr, long long nc, int d, long long tiles_c,
                      Params p) {
  __shared__ StatSmem sm;
  __shared__ float ko[BC][BR + 1];   // padded: conflict-free both ways
  const long long tile = blockIdx.x;
  const long long r0 = (tile / tiles_c) * BR;
  const long long c0 = (tile % tiles_c) * BC;
  const int tid = threadIdx.x;
  const int r = tid % BR;
  const int cg = tid / BR;
  float ent[CPT];
  tile_entries<STAT>(Xr, Xc, nr, nc, d, r0, c0, 0, nr - 1, p, sm, ent);
#pragma unroll
  for (int i = 0; i < CPT; ++i) ko[cg + 4 * i][r] = ent[i];
  __syncthreads();
  for (int e = tid; e < BR * BC; e += NT) {
    const int rr = e / BC, cc = e % BC;
    const long long gr = r0 + rr, gc = c0 + cc;
    if (gr < nr && gc < nc) out[gr * nc + gc] = ko[cc][rr];
  }
}

// out row i = K(Xr[min(row0 + i, row_last)], Xc) @ V for i < nr.
template <int STAT>
__global__ void __launch_bounds__(NT, 2)
pairwise_matmat_kernel(const float* __restrict__ Xr,
                       const float* __restrict__ Xc,
                       const float* __restrict__ V, float* __restrict__ out,
                       long long nr, long long nc, int d, long long M,
                       long long row0, long long row_last, Params p) {
  __shared__ StatSmem sm;
  __shared__ __align__(16) float kt[BC][BR];   // K tile, column-major
  __shared__ __align__(16) float vt[BC][BM];   // V tile
  const int tid = threadIdx.x;
  const int r = tid % BR;
  const int cg = tid / BR;
  const int tx = tid % 16;   // output columns tx*8 .. tx*8+7
  const int ty = tid / 16;   // output rows    ty*4 .. ty*4+3
  const long long r0 = (long long)blockIdx.x * BR;
  const long long m0 = (long long)blockIdx.y * BM;
  const bool row_ok = r0 + r < nr;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (long long c0 = 0; c0 < nc; c0 += BC) {
    float ent[CPT];
    tile_entries<STAT>(Xr, Xc, nr, nc, d, r0, c0, row0, row_last, p, sm,
                       ent);
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int cc = cg + 4 * i;
      kt[cc][r] = (row_ok && c0 + cc < nc) ? quant(ent[i], p.bf16) : 0.f;
    }
    for (int e = tid; e < BC * BM; e += NT) {
      const int cc = e / BM, mm = e % BM;
      const long long gc = c0 + cc, gm = m0 + mm;
      vt[cc][mm] = (gc < nc && gm < M) ? quant(V[gc * M + gm], p.bf16) : 0.f;
    }
    __syncthreads();
    // this tile's contribution, then one add into the running sum: the
    // reference's per-tile contraction followed by the accumulator update
    float part[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) part[i][j] = 0.f;
#pragma unroll 2
    for (int cc = 0; cc < BC; ++cc) {
      const float4 a = *reinterpret_cast<const float4*>(&kt[cc][ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&vt[cc][tx * 8]);
      const float4 b1 = *reinterpret_cast<const float4*>(&vt[cc][tx * 8 + 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          part[i][j] = fmaf(av[i], bv[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = __fadd_rn(acc[i][j], part[i][j]);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long gr = r0 + ty * 4 + i;
    if (gr >= nr) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long gm = m0 + tx * 8 + j;
      if (gm < M) out[gr * M + gm] = acc[i][j];
    }
  }
}

// One launch of pairwise_matmat_kernel: out rows i < nr read points
// min(row0 + i, row_last) of xr.
int launch_matmat(const float* xr, const float* xc, const float* v, float* out,
                  long long nr, long long nc, int d, long long m,
                  long long row0, long long row_last, int stat, int epi,
                  float a, float b, int degree, int bf16, int device,
                  void* stream) {
  if (nr <= 0 || nc <= 0 || d <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long tiles_r = (nr + BR - 1) / BR;
  const long long chunks = (m + BM - 1) / BM;
  if (tiles_r > INT_MAX || chunks > 65535) return (int)cudaErrorInvalidValue;
  const Params p{epi, a, b, degree, bf16};
  const dim3 grid((unsigned)tiles_r, (unsigned)chunks);
  cudaStream_t s = (cudaStream_t)stream;
  switch (stat) {
    case STAT_DOT:
      pairwise_matmat_kernel<STAT_DOT><<<grid, NT, 0, s>>>(xr, xc, v, out, nr, nc, d, m, row0, row_last, p);
      break;
    case STAT_SQDIST:
      pairwise_matmat_kernel<STAT_SQDIST><<<grid, NT, 0, s>>>(xr, xc, v, out, nr, nc, d, m, row0, row_last, p);
      break;
    case STAT_L1:
      pairwise_matmat_kernel<STAT_L1><<<grid, NT, 0, s>>>(xr, xc, v, out, nr, nc, d, m, row0, row_last, p);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out (nr x nc, row-major) = entry(stat(Xr, Xc)); returns cudaGetLastError().
int pairwise_block_f32(const float* xr, const float* xc, float* out,
                       long long nr, long long nc, int d, int stat, int epi,
                       float a, float b, int degree, int bf16, int device,
                       void* stream) {
  if (nr <= 0 || nc <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long tiles_r = (nr + BR - 1) / BR;
  const long long tiles_c = (nc + BC - 1) / BC;
  if (tiles_r * tiles_c > INT_MAX) return (int)cudaErrorInvalidValue;
  const Params p{epi, a, b, degree, bf16};
  const dim3 grid((unsigned)(tiles_r * tiles_c));
  cudaStream_t s = (cudaStream_t)stream;
  switch (stat) {
    case STAT_DOT:
      pairwise_block_kernel<STAT_DOT><<<grid, NT, 0, s>>>(xr, xc, out, nr, nc, d, tiles_c, p);
      break;
    case STAT_SQDIST:
      pairwise_block_kernel<STAT_SQDIST><<<grid, NT, 0, s>>>(xr, xc, out, nr, nc, d, tiles_c, p);
      break;
    case STAT_L1:
      pairwise_block_kernel<STAT_L1><<<grid, NT, 0, s>>>(xr, xc, out, nr, nc, d, tiles_c, p);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// out (nr x M, row-major) = entry(stat(Xr, Xc)) @ V with V (nc x M,
// row-major); returns cudaGetLastError().
int pairwise_matmat_multi_f32(const float* xr, const float* xc,
                              const float* v, float* out, long long nr,
                              long long nc, int d, long long m, int stat,
                              int epi, float a, float b, int degree, int bf16,
                              int device, void* stream) {
  if (nr <= 0) return (int)cudaErrorInvalidValue;
  return launch_matmat(xr, xc, v, out, nr, nc, d, m, 0, nr - 1, stat, epi, a,
                       b, degree, bf16, device, stream);
}

// out (slab_len x M, row-major): row i = entry(stat(X[min(start_row + i,
// n - 1)], X)) @ V, with X (n x d) and V (n x M) row-major; returns
// cudaGetLastError().
int pairwise_matmat_multi_slab_f32(const float* x, const float* v, float* out,
                                   long long n, long long start_row,
                                   long long slab_len, int d, long long m,
                                   int stat, int epi, float a, float b,
                                   int degree, int bf16, int device,
                                   void* stream) {
  if (n <= 0 || start_row < 0) return (int)cudaErrorInvalidValue;
  return launch_matmat(x, x, v, out, slab_len, n, d, m, start_row, n - 1,
                       stat, epi, a, b, degree, bf16, device, stream);
}

const char* pairwise_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
