// Online-softmax (flash) attention for NVIDIA Hopper (sm_90a), plain C
// interface.
//
// Replaces src/repro/kernels/flash_attention/kernel.py
// flash_attention_padded / _flash_kernel (the Pallas TPU kernel):
//
//   out[b, h, i] = sum_j p_ij v[b, h/G, j] / max(sum_j p_ij, 1e-30),
//   p_ij = exp(s_ij - max_j s_ij) over the unmasked j,
//   s_ij = (q[b, h, i] . k[b, h/G, j]) * scale,
//
// with q (B, Hq, Sq, D), k (B, Hkv, Sk, D), v (B, Hkv, Sk, Dv), G = Hq / Hkv
// (GQA: kv head h / G is read in place, never repeated), and the reference's
// masks: col < Sk; causal: col <= row + offs; window w: (row + offs) - col < w;
// offs = Sk - Sq right-aligns the queries to the keys (decode, chunked
// prefill).
//
// Precision.  q, k and v are f32 or bf16 and are widened to f32 as they are
// staged; every product and sum is an FP32 FMA on the CUDA cores (no TF32, no
// fast-math: expf is IEEE-accurate, never __expf).  The running state per
// query row is the reference's: m starts at -inf, and with
// m_safe = isfinite(m_new) ? m_new : 0 and
// alpha = isfinite(m_prev) ? exp(m_prev - m_safe) : 0, a row that has seen
// only masked keys keeps l = 0 and acc = 0.  The output is acc / max(l, 1e-30)
// in q's type (bf16 rounds to nearest even).
//
// What bounds it on the card.  Per (b, h) the causal half of 2 Sq Sk (D + Dv)
// flops, against one read of q, k, v and one write of out: at gemma3-12b's
// global layer (B = 2, Hq = 16, Hkv = 8, S = 32,768, D = Dv = 256) that is
// 1.76e13 flops against 1.1 GB, bound by operations -- >= 263 ms at the FP32
// CUDA-core rate of an H100 SXM (67 TFLOP/s), >= 17.8 ms on the bf16 tensor
// cores (989 TFLOP/s), which this design does not use (wgmma is later work).
//
// The simple design (the landmark read's, landmark.cu, plus the running
// max): one block per (64-row query tile, query head, batch row); blocks
// share nothing.  The block walks the key tiles that its rows can see, 64
// keys at a time:
//   1. it stages the q tile and the k tile in shared memory 32 features at a
//      time and forms the 64 x 64 logits with FP32 FMAs (4 x 4 per thread);
//   2. it scales and masks them, takes each row's tile maximum and the new
//      running max, writes p = exp(s - m_safe) to shared memory and alpha per
//      row, and updates l = alpha * l + sum(p) (16-lane shuffles per row);
//   3. it stages the 64 x Dv v tile and rescales acc by alpha before adding
//      p @ v, 8 x 8 accumulators per thread in registers (Dv <= 256).
// Key tiles wholly above the causal diagonal or wholly behind the window are
// never visited: in the reference such a tile leaves m, l and acc unchanged
// (alpha = 1, p = 0), so skipping it gives the same result, and a local layer
// at S = 32,768 touches 17 tiles per query tile instead of up to 512.  Query
// tiles run longest-first.  Rows past Sq and keys past Sk are masked
// explicitly, so nothing is padded; strides are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int BQ = 64;    // query rows per block
constexpr int BK = 64;    // keys per tile
constexpr int DK = 32;    // features staged per step
constexpr int DVB = 256;  // value columns per block (the widest Dv taken)
constexpr int NT = 256;   // threads per block
constexpr int LD = BQ + 4;  // padded row of a 64-wide tile (float4-aligned)

struct Smem {
  float qs[DK][LD];    // q tile, feature-major
  float ks[DK][LD];    // k tile, feature-major
  float ps[BK][LD];    // p, key-major
  float vs[BK][DVB];   // v tile
  float alpha[BQ];     // per-row rescale of this tile
  float l[BQ];         // per-row denominators at the end
};

struct Strides {       // element strides of the batch, head and row axes
  long long b, h, s;
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(NT, 2)
flash_kernel(const T* __restrict__ Q, const T* __restrict__ K,
             const T* __restrict__ V, T* __restrict__ O, Strides sq,
             Strides sk, Strides sv, Strides so, int group, int Sq, int Sk,
             int D, int Dv, float scale, int causal, int window) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int qt = (int)gridDim.x - 1 - (int)blockIdx.x;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const long long r0 = (long long)qt * BQ;
  const long long offs = (long long)Sk - Sq;
  const T* Qb = Q + b * sq.b + h * sq.h;
  const T* Kb = K + b * sk.b + hk * sk.h;
  const T* Vb = V + b * sv.b + hk * sv.h;
  T* Ob = O + b * so.b + h * so.h;

  // the key tiles these rows can see
  long long kend = Sk;
  if (causal) {
    const long long rlast = min(r0 + BQ, (long long)Sq) - 1;
    kend = min(kend, rlast + offs + 1);
  }
  long long kbeg = 0;
  if (window > 0) kbeg = max(0LL, r0 + offs - window + 1);
  kbeg -= kbeg % BK;

  // logits: 16 x 16 threads, rows ty*4.., keys tx*4..
  const int ty = tid / 16, tx = tid % 16;
  // numerator: 8 x 32 threads, rows py*8.., columns px*4.. and 128+px*4..
  const int py = tid / 32, px = tid % 32;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float m_run[4], l_run[4];   // rows ty*4+i (every tx holds them)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
  }

  for (long long j0 = kbeg; j0 < kend; j0 += BK) {
    // 1. logits of this tile
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int k0 = 0; k0 < D; k0 += DK) {
      const int kw = min(DK, D - k0);
      for (int e = tid; e < BQ * DK; e += NT) {
        const int rr = e / DK, kk = e % DK;
        const long long gr = r0 + rr;
        sm.qs[kk][rr] =
            (gr < Sq && kk < kw) ? load_f32(Qb + gr * sq.s + k0 + kk) : 0.f;
      }
      for (int e = tid; e < BK * DK; e += NT) {
        const int jj = e / DK, kk = e % DK;
        const long long gj = j0 + jj;
        sm.ks[kk][jj] =
            (gj < Sk && kk < kw) ? load_f32(Kb + gj * sk.s + k0 + kk) : 0.f;
      }
      __syncthreads();
      for (int kk = 0; kk < kw; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&sm.qs[kk][ty * 4]);
        const float4 c = *reinterpret_cast<const float4*>(&sm.ks[kk][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
      }
      __syncthreads();
    }

    // 2. masks, running max, p and the row sums
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long pos = r0 + ty * 4 + i + offs;   // the row's key position
      bool ok[4];
      float mc = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long col = j0 + tx * 4 + j;
        ok[j] = col < Sk;
        if (causal) ok[j] = ok[j] && col <= pos;
        if (window > 0) ok[j] = ok[j] && (pos - col) < window;
        s[i][j] = ok[j] ? __fmul_rn(s[i][j], scale) : -INFINITY;
        mc = fmaxf(mc, s[i][j]);
      }
      // max over the 16 lanes that share this row (one half-warp); the xor
      // butterfly leaves the same value on every lane
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, o));
      const float m_new = fmaxf(m_run[i], mc);
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      const float al =
          isfinite(m_run[i]) ? expf(__fsub_rn(m_run[i], m_safe)) : 0.f;
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(__fsub_rn(s[i][j], m_safe)) : 0.f;
        sm.ps[tx * 4 + j][ty * 4 + i] = p;
        part = __fadd_rn(part, p);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, o));
      l_run[i] = __fadd_rn(__fmul_rn(al, l_run[i]), part);
      m_run[i] = m_new;
      if (tx == 0) sm.alpha[ty * 4 + i] = al;
    }
    const int jn = (int)min((long long)BK, Sk - j0);
    for (int e = tid; e < BK * DVB; e += NT) {
      const int jj = e / DVB, vv = e % DVB;
      sm.vs[jj][vv] = (jj < jn && vv < Dv)
                          ? load_f32(Vb + (j0 + jj) * sv.s + vv)
                          : 0.f;
    }
    __syncthreads();

    // 3. acc = alpha * acc + p @ v
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float al = sm.alpha[py * 8 + i];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = __fmul_rn(acc[i][j], al);
    }
    for (int jj = 0; jj < jn; ++jj) {
      const float4 p0 = *reinterpret_cast<const float4*>(&sm.ps[jj][py * 8]);
      const float4 p1 =
          *reinterpret_cast<const float4*>(&sm.ps[jj][py * 8 + 4]);
      const float4 u0 = *reinterpret_cast<const float4*>(&sm.vs[jj][px * 4]);
      const float4 u1 =
          *reinterpret_cast<const float4*>(&sm.vs[jj][128 + px * 4]);
      const float pv[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      const float uv[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(pv[i], uv[j], acc[i][j]);
    }
    __syncthreads();   // the next tile overwrites qs, ks, ps, vs and alpha
  }

  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) sm.l[ty * 4 + i] = l_run[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long gr = r0 + py * 8 + i;
    if (gr >= Sq) continue;
    const float den = fmaxf(sm.l[py * 8 + i], 1e-30f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gv = j < 4 ? px * 4 + j : 128 + px * 4 + (j - 4);
      if (gv < Dv) store_f32(Ob + gr * so.s + gv, __fdiv_rn(acc[i][j], den));
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const long long* st, int B, int Hq, int Hkv, int Sq,
                   int Sk, int D, int Dv, int causal, int window, float scale,
                   cudaStream_t s) {
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  const dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)Hq, (unsigned)B);
  flash_kernel<T><<<grid, NT, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, sv, so,
      Hq / Hkv, Sq, Sk, D, Dv, scale, causal, window);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out (B, Hq, Sq, Dv) = flash attention of q (B, Hq, Sq, D) over k
// (B, Hkv, Sk, D) and v (B, Hkv, Sk, Dv), all bf16 if bf16 else f32, each
// addressed by the element strides of its batch, head and row axes
// (strides[0..2] q, [3..5] k, [6..8] v, [9..11] out; the feature axis is
// contiguous).  window <= 0: no window.  Returns the launch's error.
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    const long long* strides, int B, int Hq, int Hkv, int Sq,
                    int Sk, int D, int Dv, int bf16, int causal, int window,
                    float scale, int device, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Sq <= 0 || Sk <= 0 || D <= 0 ||
      Dv <= 0 || Dv > DVB || Hq % Hkv != 0 || B > 65535 || Hq > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    err = launch<__nv_bfloat16>(q, k, v, out, strides, B, Hq, Hkv, Sq, Sk, D,
                                Dv, causal, window, scale, s);
  else
    err = launch<float>(q, k, v, out, strides, B, Hq, Hkv, Sq, Sk, D, Dv,
                        causal, window, scale, s);
  return (int)err;
}

const char* flash_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
