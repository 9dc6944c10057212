// Fused landmark-attention read for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces src/repro/kernels/landmark_attention/kernel.py
// landmark_read_padded / _landmark_kernel (the Pallas TPU kernel):
//
//   out = (exp(Q k_land^T * inv_sqrt_d - off) @ UV)
//         / sgnfloor(exp(Q k_land^T * inv_sqrt_d - off) @ U1, eps)
//
// with Q (m, d), k_land (c, d), UV (c, dv), U1 (c,), off a device scalar and
// sgnfloor(x, eps) = sign(x) * max(|x|, eps) (-0.0 -> +eps, NaN stays NaN).
// The (m, c) score panel never leaves the chip.
//
// Precision.  Q, k_land and UV are f32 or bf16 and are widened to f32 as
// they are staged; U1 and the offset are f32; every product and sum is an
// FP32 FMA on the CUDA cores (no TF32, no fast-math: expf and the division
// are IEEE).  The score epilogue is expf(__fsub_rn(__fmul_rn(dot, inv), off))
// -- two roundings, as the plain version computes it.  inv_sqrt_d is the
// f32 value 1 / sqrtf(d) of the reference's oracle (the Pallas body rounds
// the Python double 1 / sqrt(d) instead; the two agree for d = 256).  The
// output is written in the caller's type (f32 or bf16, round to nearest
// even).
//
// What bounds it on the card.  2 m c (d + dv + 1) flops against reads of Q,
// k_land, UV, U1 and the write of out: at the main shape (m = 524,288,
// c = 512, d = dv = 256) that is 2.75e11 flops against 1.07 GB, so it is
// bound by operations: >= 4.1 ms at the FP32 CUDA-core rate of an H100 SXM
// (67 TFLOP/s), against >= 0.32 ms for the bytes.
//
// The simple design.  One block per (64-row tile of Q, 256-column chunk of
// UV); blocks share nothing.  The block streams the landmarks 64 at a time:
//   1. it stages the Q tile and the k_land chunk in shared memory 32
//      features at a time and forms the 64 x 64 logits with FP32 FMAs
//      (4 x 4 per thread, each a running sum in feature order);
//   2. it applies the epilogue, writes the scores to shared memory, and
//      adds each row's scores times U1 into that row's running denominator
//      (a 16-lane shuffle sum per chunk);
//   3. it stages the 64 x 256 UV chunk and adds scores @ UV into the
//      running numerator, 8 x 8 per thread in registers.
// The offset is fixed, so unlike flash attention there is no running
// maximum and no rescale: num and den are plain sums over the landmarks.
// All of dv up to 256 stays in registers per block (64 accumulators a
// thread); a wider dv is split across blocks (gridDim.y) and the logits are
// recomputed per 256 columns.  Rows past m and landmarks past c are masked
// explicitly (a masked score is 0, never 0 * exp(...)), so nothing is padded
// to the TPU's 128-row tiles.  wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int BQ = 64;    // query rows per block
constexpr int CK = 64;    // landmarks per chunk
constexpr int DK = 32;    // features staged per step
constexpr int DVB = 256;  // value columns per block
constexpr int NT = 256;   // threads per block
constexpr int LD = BQ + 4;  // padded row of a 64-wide tile (float4-aligned)

struct Smem {
  float qs[DK][LD];    // Q tile, feature-major
  float ks[DK][LD];    // k_land chunk, feature-major
  float ps[CK][LD];    // scores, landmark-major
  float uv[CK][DVB];   // UV chunk
  float den[BQ];       // per-row denominators
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

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(NT, 2)
landmark_read_kernel(const TIn* __restrict__ Q, const TIn* __restrict__ KL,
                     const TIn* __restrict__ UV, const float* __restrict__ U1,
                     const float* __restrict__ off_ptr,
                     TOut* __restrict__ out, long long m, int c, int d,
                     int dv, float inv_sqrt_d, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * BQ;
  const int v0 = blockIdx.y * DVB;
  const float off = __ldg(off_ptr);
  // logits: 16 x 16 threads, rows ty*4.., landmarks tx*4..
  const int ty = tid / 16, tx = tid % 16;
  // numerator: 8 x 32 threads, rows py*8.., columns px*4.. and 128+px*4..
  const int py = tid / 32, px = tid % 32;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float den[4] = {0.f, 0.f, 0.f, 0.f};   // rows ty*4+i (every tx holds them)

  for (int j0 = 0; j0 < c; j0 += CK) {
    // 1. logits of this chunk
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int k0 = 0; k0 < d; k0 += DK) {
      const int kw = min(DK, d - k0);
      for (int e = tid; e < BQ * DK; e += NT) {
        const int rr = e / DK, kk = e % DK;
        const long long gr = r0 + rr;
        sm.qs[kk][rr] = (gr < m && kk < kw) ? load_f32(Q + gr * d + k0 + kk)
                                            : 0.f;
      }
      for (int e = tid; e < CK * DK; e += NT) {
        const int jj = e / DK, kk = e % DK;
        const int gj = j0 + jj;
        sm.ks[kk][jj] = (gj < c && kk < kw)
                            ? load_f32(KL + (long long)gj * d + k0 + kk)
                            : 0.f;
      }
      __syncthreads();
      for (int kk = 0; kk < kw; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&sm.qs[kk][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&sm.ks[kk][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
      }
      __syncthreads();
    }

    // 2. scores (masked past c), their U1-weighted row sums, and the UV chunk
    float u1v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gj = j0 + tx * 4 + j;
      u1v[j] = gj < c ? __ldg(U1 + gj) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gj = j0 + tx * 4 + j;
        const float p =
            gj < c ? expf(__fsub_rn(__fmul_rn(s[i][j], inv_sqrt_d), off)) : 0.f;
        sm.ps[tx * 4 + j][ty * 4 + i] = p;
        part = fmaf(p, u1v[j], part);
      }
      // sum over the 16 lanes that share these rows (lanes tx = 0..15 of one
      // half-warp); the xor butterfly leaves the same sum on every lane
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, o));
      den[i] = __fadd_rn(den[i], part);
    }
    const int jn = min(CK, c - j0);
    for (int e = tid; e < CK * DVB; e += NT) {
      const int jj = e / DVB, vv = e % DVB;
      const int gv = v0 + vv;
      sm.uv[jj][vv] = (jj < jn && gv < dv)
                          ? load_f32(UV + (long long)(j0 + jj) * dv + gv)
                          : 0.f;
    }
    __syncthreads();

    // 3. numerator += scores @ UV
    for (int jj = 0; jj < jn; ++jj) {
      const float4 p0 = *reinterpret_cast<const float4*>(&sm.ps[jj][py * 8]);
      const float4 p1 =
          *reinterpret_cast<const float4*>(&sm.ps[jj][py * 8 + 4]);
      const float4 u0 = *reinterpret_cast<const float4*>(&sm.uv[jj][px * 4]);
      const float4 u1 =
          *reinterpret_cast<const float4*>(&sm.uv[jj][128 + px * 4]);
      const float pv[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      const float uvv[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(pv[i], uvv[j], acc[i][j]);
    }
    __syncthreads();   // the next chunk overwrites qs, ks, ps and uv
  }

  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) sm.den[ty * 4 + i] = den[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long gr = r0 + py * 8 + i;
    if (gr >= m) continue;
    const float dn = signed_floor(sm.den[py * 8 + i], eps);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gv = v0 + (j < 4 ? px * 4 + j : 128 + px * 4 + (j - 4));
      if (gv < dv) store_f32(out + gr * dv + gv, __fdiv_rn(acc[i][j], dn));
    }
  }
}

template <typename TIn, typename TOut>
cudaError_t launch(const void* q, const void* kl, const void* uv,
                   const float* u1, const float* off, void* out, long long m,
                   int c, int d, int dv, float inv_sqrt_d, float eps,
                   cudaStream_t s) {
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      landmark_read_kernel<TIn, TOut>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((m + BQ - 1) / BQ), (unsigned)((dv + DVB - 1) / DVB));
  landmark_read_kernel<TIn, TOut><<<grid, NT, smem, s>>>(
      static_cast<const TIn*>(q), static_cast<const TIn*>(kl),
      static_cast<const TIn*>(uv), u1, off, static_cast<TOut*>(out), m, c, d,
      dv, inv_sqrt_d, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out (m x dv, row-major, bf16 if out_bf16 else f32) = the landmark read of
// Q (m x d), k_land (c x d), UV (c x dv) -- all bf16 if in_bf16 else f32 --
// U1 (c,) f32 and the f32 device scalar *off; returns the launch's error.
// bf16 inputs need a bf16 output.
int landmark_read(const void* q, const void* kl, const void* uv,
                  const void* u1, const void* off, void* out, long long m,
                  int c, int d, int dv, int in_bf16, int out_bf16,
                  float inv_sqrt_d, float eps, int device, void* stream) {
  if (m <= 0 || c <= 0 || d <= 0 || dv <= 0) return (int)cudaErrorInvalidValue;
  if ((m + BQ - 1) / BQ > INT_MAX || (dv + DVB - 1) / DVB > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float* u1f = static_cast<const float*>(u1);
  const float* offf = static_cast<const float*>(off);
  cudaStream_t s = (cudaStream_t)stream;
  if (!in_bf16 && !out_bf16)
    err = launch<float, float>(q, kl, uv, u1f, offf, out, m, c, d, dv,
                               inv_sqrt_d, eps, s);
  else if (in_bf16 && out_bf16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(q, kl, uv, u1f, offf, out, m,
                                               c, d, dv, inv_sqrt_d, eps, s);
  else if (!in_bf16 && out_bf16)
    err = launch<float, __nv_bfloat16>(q, kl, uv, u1f, offf, out, m, c, d,
                                       dv, inv_sqrt_d, eps, s);
  else
    err = cudaErrorInvalidValue;  // bf16 in, f32 out: no caller needs it
  return (int)err;
}

const char* landmark_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
