// Landmark-attention read split across the landmarks (sm_90a), plain C
// interface: the route of landmark_read_cuda where the tensor-core grid
// (landmark_wgmma.cu) would leave the card mostly idle -- a decode step's
// few queries -- and where Q's rows cannot be loaded by TMA.
//
// Replaces src/repro/kernels/landmark_attention/kernel.py
// landmark_read_padded / _landmark_kernel (the Pallas TPU kernel):
//
//   out = (exp(Q k_land^T * inv_sqrt_d - off) @ UV)
//         / sgnfloor(exp(Q k_land^T * inv_sqrt_d - off) @ U1, eps)
//
// Two launches.
//   1. landmark_partials: block (x, y, z) takes 16 query rows (x), 64 UV
//      columns (y) and the z-th run of `per` 64-landmark chunks; it writes
//      its partial numerator (16 x 64) and, for y = 0, its partial
//      denominator (16) into an f32 workspace the wrapper allocates.  The
//      offset is fixed, so partial sums over landmarks add directly, with
//      no rescale (unlike flash decoding).
//   2. landmark_reduce: one thread an output element adds the runs'
//      partials in a fixed order (run 0, 1, 2, ...), applies the
//      sign-preserving floor, divides and writes the output type.
// No atomics: two identical calls give identical bits, and negating U1
// negates every partial denominator and so the output exactly.
//
// Precision.  Q, k_land and UV are f32 or bf16 and are widened to f32 as
// they are staged; U1 and the offset are f32; every product and sum is an
// FP32 FMA on the CUDA cores in feature or landmark order (no TF32, no
// fast-math: expf and the division are IEEE).  The score epilogue is
// expf(__fsub_rn(__fmul_rn(dot, inv), off)), two roundings as the plain
// version computes it; a landmark past c gets the score 0, never
// 0 * exp(...).
//
// What bounds it.  At the decode shape (m = 16, c = 512, d = dv = 256) the
// work is 8.4 Mflop against ~1 MB of k_land and UV: bytes (0.3 us at HBM
// rate), so a block's time is the latency of its loads: it stages its
// rows, the chunk's keys (256 features at a time) and UV columns with all
// of a thread's loads in flight before the first store, 16-byte (f32) or
// 8-byte (bf16) loads where every row is so aligned.  The wrapper picks
// `per` so that the grid holds about two blocks per SM: one chunk a run at
// a decode step (8 x 4 = 32 blocks at m = 16), all chunks in one run once
// the rows alone fill the card.  Each block restages its k_land chunk for
// each of the ceil(dv / 64) column slices.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MT = 16;     // query rows of a block
constexpr int CK = 64;     // landmarks of a chunk
constexpr int DVS = 64;    // UV columns of a block
constexpr int DS = 256;    // features staged at a time
constexpr int NT = 256;    // threads of a block
constexpr int MAX_DEVICES = 64;

struct Smem {
  float q[MT][DS + 1];     // the rows' features
  float k[CK][DS + 1];     // the chunk's keys
  float uv[CK][DVS + 1];   // the chunk's UV columns
  float p[CK][MT + 1];     // the scores, landmark-major
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// sign(den) * max(|den|, eps); -0.0 -> +eps (copysignf would give -eps);
// NaN stays NaN (fmaxf alone would turn it into eps)
__device__ __forceinline__ float signed_floor(float den, float eps) {
  if (isnan(den)) return den;
  const float a = fmaxf(fabsf(den), eps);
  return den < 0.f ? -a : a;
}

// four consecutive values from p, zero past `valid`; VEC: one 16-byte
// (f32) or 8-byte (bf16) load where all four are valid (the wrapper checks
// the alignment)
template <bool VEC>
__device__ __forceinline__ void load4(const float* p, int valid,
                                      float (&x)[4]) {
  if (VEC && valid >= 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t) x[t] = t < valid ? p[t] : 0.f;
  }
}
template <bool VEC>
__device__ __forceinline__ void load4(const __nv_bfloat16* p, int valid,
                                      float (&x)[4]) {
  if (VEC && valid >= 4) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.y));
    x[0] = a.x, x[1] = a.y, x[2] = b.x, x[3] = b.y;
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t) x[t] = t < valid ? load_f32(p + t) : 0.f;
  }
}

// rows x (cols / 4) quads of a row-major source (row stride ld) into
// dst[rows][cols + 1], zero past nrows rows and ncols columns.  VEC: every
// load of a thread is issued before the first store; else (scalar loads,
// four times as many) a quad is stored as it arrives.
template <int ROWS, int COLS, bool VEC, typename TIn>
__device__ __forceinline__ void stage(float (*dst)[COLS + 1],
                                      const TIn* __restrict__ src,
                                      long long ld, long long nrows,
                                      int ncols) {
  constexpr int Q4 = COLS / 4, N = ROWS * Q4 / NT;
  static_assert(ROWS * Q4 % NT == 0, "whole quads a thread");
  if constexpr (!VEC) {
#pragma unroll 2
    for (int i = 0; i < N; ++i) {
      const int e = threadIdx.x + i * NT, r = e / Q4, f = 4 * (e % Q4);
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (r < nrows) load4<false>(src + r * ld + f, ncols - f, x);
#pragma unroll
      for (int t = 0; t < 4; ++t) dst[r][f + t] = x[t];
    }
    return;
  }
  float x[N][4];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int e = threadIdx.x + i * NT, r = e / Q4, f = 4 * (e % Q4);
    if (r < nrows)
      load4<VEC>(src + r * ld + f, ncols - f, x[i]);
    else
      x[i][0] = x[i][1] = x[i][2] = x[i][3] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int e = threadIdx.x + i * NT, r = e / Q4, f = 4 * (e % Q4);
#pragma unroll
    for (int t = 0; t < 4; ++t) dst[r][f + t] = x[i][t];
  }
}

// the partial numerator num_ws[z] (m x dv) and denominator den_ws[z] (m) of
// run z; thread (row t / 16, lane t % 16) forms the scores of landmarks
// t % 16 + 16 i and the numerator of columns t % 16 + 16 i, i < 4
template <typename TIn, bool VEC>
__global__ void __launch_bounds__(NT)
landmark_partials(const TIn* __restrict__ Q, const TIn* __restrict__ KL,
                  const TIn* __restrict__ UV, const float* __restrict__ U1,
                  const float* __restrict__ off_ptr,
                  float* __restrict__ num_ws, float* __restrict__ den_ws,
                  long long m, int c, int d, int dv, int per,
                  float inv_sqrt_d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int row = tid / 16, lx = tid % 16;
  const long long r0 = (long long)blockIdx.x * MT;
  const int v0 = blockIdx.y * DVS;
  const int run = blockIdx.z;
  const float off = __ldg(off_ptr);
  float num[4] = {0.f, 0.f, 0.f, 0.f};
  float den = 0.f;   // thread tid < MT: row tid's
  for (int ck = 0; ck < per; ++ck) {
    const int j0 = (run * per + ck) * CK;
    if (j0 >= c) break;
    // the chunk's UV columns (read after the scores' barriers)
    stage<CK, DVS, VEC>(sm.uv, UV + (long long)j0 * dv + v0, dv, c - j0,
                        dv - v0);
    // scores: running sums in feature order
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int f0 = 0; f0 < d; f0 += DS) {
      const int fw = min(DS, d - f0);
      stage<MT, DS, VEC>(sm.q, Q + r0 * d + f0, d, m - r0, fw);
      stage<CK, DS, VEC>(sm.k, KL + (long long)j0 * d + f0, d, c - j0, fw);
      __syncthreads();
#pragma unroll 4
      for (int ff = 0; ff < fw; ++ff) {
        const float qv = sm.q[row][ff];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s[i] = fmaf(qv, sm.k[lx + 16 * i][ff], s[i]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gj = j0 + lx + 16 * i;
      sm.p[lx + 16 * i][row] =
          gj < c ? expf(__fsub_rn(__fmul_rn(s[i], inv_sqrt_d), off)) : 0.f;
    }
    __syncthreads();
    // the denominator (one thread a row) and the numerator, landmark order
    if (tid < MT) {
#pragma unroll 8
      for (int jj = 0; jj < CK; ++jj) {
        const int gj = j0 + jj;
        den = fmaf(sm.p[jj][tid], gj < c ? __ldg(U1 + gj) : 0.f, den);
      }
    }
#pragma unroll 8
    for (int jj = 0; jj < CK; ++jj) {
      const float pv = sm.p[jj][row];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        num[i] = fmaf(pv, sm.uv[jj][lx + 16 * i], num[i]);
    }
    __syncthreads();   // the next chunk overwrites uv and p
  }
  const long long gr = r0 + row;
  if (gr < m) {
    float* nrow = num_ws + ((long long)run * m + gr) * dv;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gv = v0 + lx + 16 * i;
      if (gv < dv) nrow[gv] = num[i];
    }
  }
  if (blockIdx.y == 0 && tid < MT && r0 + tid < m)
    den_ws[(long long)run * m + r0 + tid] = den;
}

// out[i] = (sum of the runs' numerators) / sgnfloor(sum of their
// denominators), the runs added in order
template <typename TOut>
__global__ void landmark_reduce(const float* __restrict__ num_ws,
                                const float* __restrict__ den_ws,
                                TOut* __restrict__ out, long long m, int dv,
                                int runs, float eps) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= m * dv) return;
  const long long gr = e / dv;
  float num = num_ws[e], den = den_ws[gr];
  for (int z = 1; z < runs; ++z) {
    num = __fadd_rn(num, num_ws[(long long)z * m * dv + e]);
    den = __fadd_rn(den, den_ws[(long long)z * m + gr]);
  }
  store_f32(out + e, __fdiv_rn(num, signed_floor(den, eps)));
}

long long workspace_bytes(long long m, int dv, int runs) {
  return 4LL * runs * m * ((long long)dv + 1);
}

template <typename TIn, bool VEC>
cudaError_t launch_partials(const void* q, const void* kl, const void* uv,
                            const float* u1, const float* off, float* num_ws,
                            float* den_ws, long long m, int c, int d, int dv,
                            int per, int runs, float inv_sqrt_d,
                            int device, cudaStream_t s) {
  const int smem = (int)sizeof(Smem);
  // the attribute, once per device
  static bool smem_set[MAX_DEVICES] = {};
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!smem_set[device]) {
    cudaError_t err = cudaFuncSetAttribute(
        landmark_partials<TIn, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set[device] = true;
  }
  const dim3 grid((unsigned)((m + MT - 1) / MT), (unsigned)((dv + DVS - 1) / DVS),
                  (unsigned)runs);
  landmark_partials<TIn, VEC><<<grid, NT, smem, s>>>(
      static_cast<const TIn*>(q), static_cast<const TIn*>(kl),
      static_cast<const TIn*>(uv), u1, off, num_ws, den_ws, m, c, d, dv, per,
      inv_sqrt_d);
  return cudaGetLastError();
}

template <typename TIn, typename TOut>
cudaError_t launch(const void* q, const void* kl, const void* uv,
                   const float* u1, const float* off, void* out, float* ws,
                   long long m, int c, int d, int dv, int per, int runs,
                   float inv_sqrt_d, float eps, int device, cudaStream_t s) {
  float* num_ws = ws;
  float* den_ws = ws + (long long)runs * m * dv;
  // four values a load where every row starts on a load's alignment
  const uintptr_t a = 4 * sizeof(TIn) - 1;
  const bool vec = d % 4 == 0 && dv % 4 == 0 &&
                   (((uintptr_t)q | (uintptr_t)kl | (uintptr_t)uv) & a) == 0;
  cudaError_t err =
      vec ? launch_partials<TIn, true>(q, kl, uv, u1, off, num_ws, den_ws, m,
                                       c, d, dv, per, runs, inv_sqrt_d,
                                       device, s)
          : launch_partials<TIn, false>(q, kl, uv, u1, off, num_ws, den_ws,
                                        m, c, d, dv, per, runs, inv_sqrt_d,
                                        device, s);
  if (err != cudaSuccess) return err;
  const long long elems = m * dv;
  landmark_reduce<TOut><<<(unsigned)((elems + 255) / 256), 256, 0, s>>>(
      num_ws, den_ws, static_cast<TOut*>(out), m, dv, runs, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// scratch bytes of a split launch: `runs` partial numerators (m x dv) and
// denominators (m), f32
long long landmark_split_workspace_bytes(long long m, int dv, int runs) {
  return workspace_bytes(m, dv, runs);
}

// out (m x dv, row-major, bf16 if out_bf16 else f32) = the landmark read,
// its landmarks split into runs of `per` 64-landmark chunks
// (runs = ceil(ceil(c / 64) / per)): the partials launch, then the reduce
// launch.  Inputs as landmark_read_tc takes them, with no alignment
// requirement.  Returns 0 or a CUDA error code.
int landmark_read_split(const void* q, const void* kl, const void* uv,
                        const void* u1, const void* off, void* out, void* ws,
                        long long ws_bytes, long long m, int c, int d, int dv,
                        int per, int in_bf16, int out_bf16, float inv_sqrt_d,
                        float eps, int device, void* stream) {
  if (m <= 0 || c <= 0 || d <= 0 || dv <= 0 || per <= 0 || ws == nullptr)
    return (int)cudaErrorInvalidValue;
  const int chunks = (c + CK - 1) / CK;
  const int runs = (chunks + per - 1) / per;
  if ((m + MT - 1) / MT > INT_MAX || (dv + DVS - 1) / DVS > 65535 ||
      runs > 65535 || (m * dv + 255) / 256 > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (ws_bytes < workspace_bytes(m, dv, runs))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float* u1f = static_cast<const float*>(u1);
  const float* offf = static_cast<const float*>(off);
  float* w = static_cast<float*>(ws);
  cudaStream_t s = (cudaStream_t)stream;
  if (!in_bf16 && !out_bf16)
    err = launch<float, float>(q, kl, uv, u1f, offf, out, w, m, c, d, dv, per,
                               runs, inv_sqrt_d, eps, device, s);
  else if (in_bf16 && out_bf16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(q, kl, uv, u1f, offf, out, w,
                                               m, c, d, dv, per, runs,
                                               inv_sqrt_d, eps, device, s);
  else if (!in_bf16 && out_bf16)
    err = launch<float, __nv_bfloat16>(q, kl, uv, u1f, offf, out, w, m, c, d,
                                       dv, per, runs, inv_sqrt_d, eps, device,
                                       s);
  else
    err = cudaErrorInvalidValue;  // bf16 in, f32 out: no caller needs it
  return (int)err;
}

}  // extern "C"
