// Landmark-attention read on Hopper's tensor cores (sm_90a), plain C
// interface: the route of landmark_read_cuda for query counts that fill the
// card (landmark_split.cu takes the others).
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
// Precision and passes (landmark_passes reports the counts).
//   * Scores S = Q k_land^T on the tensor cores (wgmma m64n64, one 128-byte
//     feature chunk at a time, each chunk in a fresh accumulator added into
//     S with __fadd_rn: the tensor cores' sums are not round-to-nearest).
//     f32 inputs: split TF32, SCORE_PASSES = 3 passes hi.lo + lo.hi + hi.hi
//     (small ones first), where a value's parts are hi = cvt.rna.tf32(x)
//     and lo = cvt.rna.tf32(x - hi); lo.lo (below 2^-22 of |q||k|) is
//     dropped.  k_land's parts are prepped once per launch; Q's are formed
//     in registers from the raw f32 chunk (A from registers), so Q is read
//     as it is, with no copy.  bf16 inputs: one bf16 pass, products exact
//     in f32.
//   * The epilogue on the CUDA cores, as the plain version rounds it:
//     P = expf(__fsub_rn(__fmul_rn(S, inv_sqrt_d), off)); landmarks past c
//     get P = 0 (never 0 * exp(...)).
//   * num = P @ UV on the tensor cores (wgmma m64n128, A = P from
//     registers).  f32: VALUE_PASSES = 3 passes lo.Vhi + hi.Vlo + hi.Vhi,
//     P's two TF32 parts against UV's two (lo.Vlo dropped).  bf16: P
//     rounded to bf16 (round to nearest even), one bf16 pass against UV.
//     Each 64-landmark tile sums in a fresh accumulator that is added into
//     the running numerator with __fadd_rn.
//   * den = P @ U1 on the CUDA cores from the same rounded P as the
//     numerator (f32: hi + lo, exact in f32; bf16: bf16(P)), times the f32
//     U1 with FP32 FMAs in landmark order, then a fixed butterfly over the
//     four lanes that share a row; each tile's sum added with __fadd_rn.
//     Both signs of U1 take the same operations, so negating U1 negates
//     the output exactly, and two identical calls give identical bits.
//   * out = num / sgnfloor(den, eps) (IEEE division), in the caller's type.
//
// What bounds it.  At the main shape (m = 524,288, c = 512, d = dv = 256,
// f32) the passes do 3 x 2 m c (d + dv) = 8.2e11 flops: 1.67 ms at the TF32
// rate (495 TFLOP/s), against 0.32 ms for the bytes; bf16 inputs 0.28 ms
// at the bf16 rate (989).  This design builds the scores once per
// 128-column chunk of UV, twice at dv = 256 (see below): its own floor is
// 2.5 ms f32.
//
// Design.  A block is three warpgroups (as pairwise_wgmma.cu's sweep): one
// producer thread issues TMA loads (2-d tensor maps, 128-byte boxes with
// the 128-byte swizzle, zero fill past the edges) into a ring of
// mbarrier-guarded stages; two consumer warpgroups own 64 query rows each
// and walk every landmark tile; setmaxnreg moves registers to them.
//   * A stage holds one 128-byte feature chunk of the block's 128 query
//     rows (the raw input: TMA needs 16-byte row strides, which the wrapper
//     checks before it picks this route) and of the tile's 64 landmark keys
//     (prepped parts).  A second two-slot ring holds the tile's UV^T
//     (prepped, K-major: TF32 wgmma takes B K-major only), whose landmarks
//     are stored permuted within each group of 8 (0, 2, 4, 6, 1, 3, 5, 7)
//     under f32, so the scores' f32 accumulator is, lane for lane, the A
//     fragment of the numerator's product (no shuffle, no shared memory).
//   * A block owns 128 query rows x 128 columns of UV: at dv = 256 the
//     numerator of 256 columns (128 registers a thread) beside its tile sum
//     and the scores does not fit in a thread's 255 registers, so the
//     scores are rebuilt per 128-column chunk (blocks of one chunk are
//     adjacent in the grid and stream the same tiles through L2).
// Rows past m are zero-filled by TMA and not stored; row offsets are 64-bit.
// The tensor cores flush subnormal inputs (below 2^-126).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WG = 128;          // threads of a warpgroup
constexpr int BR = 128;          // query rows of a block (64 per warpgroup)
constexpr int BK = 64;           // landmarks of a tile
constexpr int BN = 128;          // UV columns of a block
constexpr int ROWB = 128;        // bytes of one swizzled row of a tile
constexpr int Q_PART = BR * ROWB;    // 16 KB: the block's rows, one chunk
constexpr int K_PART = BK * ROWB;    // 8 KB: a tile's keys, one chunk, part
constexpr int V_BOX = BN * ROWB;     // 16 KB: 32 f32 / 64 bf16 landmarks

// ---- the passes (f32 inputs) ------------------------------------------------
//
// Scores: pass p multiplies Q's part score_q_part(p) by k_land's part
// score_k_part(p) (0 = hi, 1 = lo): hi.lo, lo.hi, hi.hi.
constexpr int SCORE_PASSES = 3;
__host__ __device__ constexpr int score_q_part(int p) { return p == 1; }
__host__ __device__ constexpr int score_k_part(int p) { return p == 0; }
// Numerator: pass p multiplies P's part value_p_part(p) by UV's part
// value_v_part(p): lo.Vhi, hi.Vlo, hi.Vhi.
constexpr int VALUE_PASSES = 3;
__host__ __device__ constexpr int value_p_part(int p) { return p == 0; }
__host__ __device__ constexpr int value_v_part(int p) { return p == 1; }

// ---- numerics ----------------------------------------------------------------

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float quant_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// round to TF32: nearest, ties away from zero (the 13 low bits cleared)
__device__ __forceinline__ float tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// sign(den) * max(|den|, eps); -0.0 -> +eps, NaN stays NaN
__device__ __forceinline__ float signed_floor(float den, float eps) {
  if (isnan(den)) return den;
  const float a = fmaxf(fabsf(den), eps);
  return den < 0.f ? -a : a;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store1(float* p, float a) { *p = a; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float a) {
  *p = __float2bfloat16(a);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo: low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- PTX wrappers --------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptors, 128-byte swizzle, K-major: stride byte
// offset 1 KB (8 rows of 128 bytes), layout type 1; a k8 (TF32) or k16
// (bf16) step adds 32 bytes
constexpr uint32_t DESC_HI = (1024u >> 4) | (1u << 30);
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return ((uint64_t)DESC_HI << 32) | (((addr & 0x3FFFFu) >> 4) | (1u << 16));
}
// a value the compiler may not treat as loop-invariant (keeps descriptors
// from being hoisted into dozens of live 64-bit registers)
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

#define D32                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31}"
#define D32_OPS                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])
#define D64                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, " \
  "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, " \
  "%57, %58, %59, %60, %61, %62, %63}"
#define D64_OPS                                                           \
  D32_OPS, "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),             \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),     \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),     \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),     \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),     \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),     \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d (64 x 64 f32) += A (64 x 8 TF32 from registers) * B (8 x 64, K-major)
__device__ __forceinline__ void mma_tf32_rs64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : D32_OPS
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// d (64 x 64 f32) += A (64 x 16 bf16, K-major, shared) * B (16 x 64, K-major)
__device__ __forceinline__ void mma_bf16_ss(float (&d)[32], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : D32_OPS
      : "l"(da), "l"(db));
}

// d (64 x 128 f32) += A (64 x 8 TF32 from registers) * B (8 x 128, K-major)
__device__ __forceinline__ void mma_tf32_rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : D64_OPS
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// d (64 x 128 f32) += A (64 x 16 bf16 from registers) * B (16 x 128, K-major)
__device__ __forceinline__ void mma_bf16_rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : D64_OPS
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// ---- mbarriers and TMA ---------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
// until the phase of the given parity has completed (no clock64 / __trap
// watchdog: in the flash kernel one made ptxas spill and serialize wgmma)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// ---- launch geometry and the shared-memory layout ----------------------------

// tensor maps of one launch: boxes of 128 bytes of a row (32 f32 or 64 bf16
// values) with the 128-byte swizzle, so a box lands in shared memory in the
// wgmma K-major layout; TMA's zero fill covers rows and features past the
// edges
struct Maps {
  CUtensorMap q;      // Q as given: boxes of 128 rows
  CUtensorMap k[2];   // k_land's parts: boxes of 64 landmarks
  CUtensorMap v[2];   // UV^T's parts: boxes of 128 bytes of landmarks x 128
                      // columns
};

struct Geo {
  const float* u1;
  const float* off;
  long long m;
  int c, dv, nch, stages;
  float inv_sqrt_d, eps;
};

// [stages x (the rows' chunk + the keys' chunk parts)][2 x UV^T slot]
// [barriers], every tile 1 KB aligned
struct Layout {
  uint32_t stage, v, vslot, bars, total;
};
__host__ __device__ __forceinline__ Layout layout(int nkp, int stages,
                                                  int vslot) {
  Layout L;
  L.stage = Q_PART + nkp * K_PART;
  L.v = stages * L.stage;
  L.vslot = vslot;
  L.bars = L.v + 2 * vslot;
  // bars: full[stages], empty[stages], vfull[2], vempty[2]
  L.total = L.bars + 8 * (2 * stages + 4);
  return L;
}
constexpr int MAX_STAGES = 4;
constexpr int NTW = 3 * WG;   // two consumer warpgroups + the producer
constexpr int PRODUCER_REGS = 24;

template <int BF>
struct Kind {
  static constexpr int NKP = BF ? 1 : 2;          // k_land's parts
  static constexpr int FE = BF ? 64 : 32;         // features of a chunk
  static constexpr int VSLOT = BF ? V_BOX : 4 * V_BOX;
};

__device__ __forceinline__ void init_barriers(uint32_t bars, int S) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(bars + 8 * i, 1);              // full: the producer
      mbar_init(bars + 8 * (S + i), 2 * 4);    // empty: 8 consumer warps
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(bars + 8 * (2 * S + i), 1);
      mbar_init(bars + 8 * (2 * S + 2 + i), 2 * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// ---- the producer (one thread) -------------------------------------------------
//
// Steps are (tile, chunk) pairs; step st fills stage st % stages (the rows'
// chunk and the keys' chunk parts), and a tile's first step fills UV^T slot
// t % 2.
template <int BF>
__device__ __forceinline__ void produce(const Maps& maps, const Geo& G,
                                        const Layout& L, uint32_t base,
                                        int r0, int col0) {
  using K = Kind<BF>;
  const int nch = G.nch, S = G.stages;
  const int tiles = (G.c + BK - 1) / BK;
  const uint32_t full = base + L.bars, empty = full + 8 * S;
  const uint32_t vfull = empty + 8 * S, vempty = vfull + 16;
  for (int st = 0; st < tiles * nch; ++st) {
    const int ch = st % nch, tl = st / nch;
    const int key0 = tl * BK;
    const int sc = st % S;
    mbar_wait(empty + 8 * sc, ((uint32_t)(st / S) & 1u) ^ 1u);
    mbar_expect_tx(full + 8 * sc, Q_PART + K::NKP * K_PART);
    const uint32_t stage = base + sc * L.stage;
    tma_2d(stage, &maps.q, full + 8 * sc, ch * K::FE, r0);
    for (int q = 0; q < K::NKP; ++q)
      tma_2d(stage + Q_PART + q * K_PART, &maps.k[q], full + 8 * sc,
             ch * K::FE, key0);
    if (ch == 0) {
      const int sv = tl & 1;
      mbar_wait(vempty + 8 * sv, ((uint32_t)(tl >> 1) & 1u) ^ 1u);
      mbar_expect_tx(vfull + 8 * sv, L.vslot);
      const uint32_t vs = base + L.v + sv * L.vslot;
      if constexpr (BF != 0) {
        tma_2d(vs, &maps.v[0], vfull + 8 * sv, key0, col0);
      } else {
        for (int q = 0; q < 2; ++q)
          for (int hb = 0; hb < 2; ++hb)
            tma_2d(vs + (2 * q + hb) * V_BOX, &maps.v[q], vfull + 8 * sv,
                   key0 + 32 * hb, col0);
      }
    }
  }
}

// ---- the scores of one 64 x 64 warpgroup tile ----------------------------------
//
// s (accumulator layout: warp w, lane l holds rows 16 w + l / 4 + {0, 8},
// landmarks 8 j + 2 (l % 4) + {0, 1} of n8 block j as s[4 j + 2 h + e])
// gains one feature chunk: qa, this warpgroup's 64 rows of the chunk (raw
// f32 or bf16, swizzled); ka, the tile's keys (part 1 at + K_PART).
template <int BF>
__device__ __forceinline__ void score_chunk(float (&s)[32], uint32_t qa,
                                            uint32_t ka,
                                            const unsigned char* smem,
                                            uint32_t smem_base) {
  float part[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) part[i] = 0.f;
  const uint32_t kb = opaque(ka);
  if constexpr (BF != 0) {
    const uint32_t qb = opaque(qa);
    reg_fence(part);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_bf16_ss(part, desc(qb + 32 * kk), desc(kb + 32 * kk));
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(part);
  } else {
    // Q's A fragments of the chunk's four k8 steps, split in registers:
    // a0 (row r, column q), a1 (r + 8, q), a2 (r, q + 4), a3 (r + 8, q + 4)
    // of step kk, column 8 kk + q of the chunk in 16-byte unit 2 kk or
    // 2 kk + 1, swizzled by the row
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % WG) / 32;
    const int r = 16 * warp + lane / 4, q = lane & 3;
    const unsigned char* pq = smem + (qa - smem_base);
    uint32_t qp[2][4][4];   // [hi, lo][k8 step][fragment register]
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r + 8 * (i & 1);
        const int unit = 2 * kk + (i >> 1);
        const float x = *reinterpret_cast<const float*>(
            pq + row * ROWB + ((unit ^ (row & 7)) << 4) + 4 * q);
        const float hi = tf32(x);
        qp[0][kk][i] = __float_as_uint(hi);
        qp[1][kk][i] = __float_as_uint(tf32(__fsub_rn(x, hi)));
      }
    reg_fence(part);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      reg_fence(qp[0][kk]);
      reg_fence(qp[1][kk]);
    }
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < SCORE_PASSES; ++p)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_tf32_rs64(part, qp[score_q_part(p)][kk],
                      desc(kb + score_k_part(p) * K_PART + 32 * kk));
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(part);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      reg_fence(qp[0][kk]);
      reg_fence(qp[1][kk]);
    }
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = __fadd_rn(s[i], part[i]);
}

// ---- the kernel -----------------------------------------------------------------

// out (m x dv) = the read: block (x, y) owns rows [128 x, 128 x + 128) and
// UV columns [128 y, 128 y + 128), and walks every landmark tile.
template <int BF, typename TOut>
__global__ void __launch_bounds__(NTW, 1)
landmark_read_tc(const __grid_constant__ Maps maps, TOut* __restrict__ out,
                 Geo G) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const unsigned char* smem = smem_raw + (base - raw);
  using K = Kind<BF>;
  const Layout L = layout(K::NKP, G.stages, K::VSLOT);
  const long long r0 = (long long)blockIdx.x * BR;
  const int col0 = blockIdx.y * BN;
  const int tiles = (G.c + BK - 1) / BK;
  init_barriers(base + L.bars, G.stages);

  if (threadIdx.x / WG == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 2 * WG) produce<BF>(maps, G, L, base, (int)r0, col0);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(240));
  const int g = threadIdx.x / WG;
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % WG) / 32;
  const int cl = 2 * (lane & 3);
  const int nch = G.nch, S = G.stages, c = G.c;
  const uint32_t full = base + L.bars, empty = full + 8 * S;
  const uint32_t vfull = empty + 8 * S, vempty = vfull + 16;
  const float off = __ldg(G.off);
  const float inv = G.inv_sqrt_d;
  float o[64], acc[64], s[32];
  float den[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  for (int st = 0; st < tiles * nch; ++st) {
    const int ch = st % nch, t = st / nch;
    const int c0 = t * BK;
    const int sc = st % S;
    mbar_wait(full + 8 * sc, (uint32_t)(st / S) & 1u);
    if (ch == 0) {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
    }
    const uint32_t stage = base + sc * L.stage;
    score_chunk<BF>(s, stage + g * 64 * ROWB, stage + Q_PART, smem, base);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * sc);
    if (ch != nch - 1) continue;

    // P in place; landmarks past c contribute exact zeros
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = c0 + 8 * j + cl + e < c;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float& x = s[4 * j + 2 * h + e];
          x = in ? expf(__fsub_rn(__fmul_rn(x, inv), off)) : 0.f;
        }
      }
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    float dpart[2] = {0.f, 0.f};
    const int sv = t & 1;
    mbar_wait(vfull + 8 * sv, (uint32_t)(t >> 1) & 1u);
    const uint32_t vb = opaque(base + L.v + sv * L.vslot);
    if constexpr (BF != 0) {
      // P in bf16: the accumulator of n8 blocks 2 kb, 2 kb + 1 is, lane for
      // lane, the A fragment of k16 step kb; den from the same bf16 P
      uint32_t a[4][4];
#pragma unroll
      for (int kb = 0; kb < 4; ++kb) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[kb][i] = pack_bf16(s[8 * kb + 2 * i], s[8 * kb + 2 * i + 1]);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = 2 * kb + jj;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = c0 + 8 * j + cl + e;
            const float u = key < c ? __ldg(G.u1 + key) : 0.f;
#pragma unroll
            for (int h = 0; h < 2; ++h)
              dpart[h] = fmaf(quant_bf16(s[4 * j + 2 * h + e]), u, dpart[h]);
          }
        }
      }
      reg_fence(acc);
#pragma unroll
      for (int kb = 0; kb < 4; ++kb) reg_fence(a[kb]);
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < 4; ++kb)
        mma_bf16_rs(acc, a[kb], desc(vb + 32 * kb));
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(acc);
#pragma unroll
      for (int kb = 0; kb < 4; ++kb) reg_fence(a[kb]);
    } else {
      // k8 step j is n8 block j: its A fragment (rows r, r + 8 x logical
      // columns q, q + 4) is the accumulator's (landmarks 2 q, 2 q + 1), so
      // UV^T's landmarks are stored in that order (prep_rhs); two steps at
      // a time, VALUE_PASSES each.  ap[0], ap[1]: P's hi, lo.
#pragma unroll
      for (int j2 = 0; j2 < 4; ++j2) {
        uint32_t ap[2][2][4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = 2 * j2 + jj;
          // v[h + 2 e] = row h, landmark 8 j + cl + e
          const float v[4] = {s[4 * j + 0], s[4 * j + 2], s[4 * j + 1],
                              s[4 * j + 3]};
          float u[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = c0 + 8 * j + cl + e;
            u[e] = key < c ? __ldg(G.u1 + key) : 0.f;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float hi = tf32(v[i]);
            const float lo = tf32(__fsub_rn(v[i], hi));
            ap[0][jj][i] = __float_as_uint(hi);
            ap[1][jj][i] = __float_as_uint(lo);
            dpart[i & 1] = fmaf(__fadd_rn(hi, lo), u[i >> 1], dpart[i & 1]);
          }
        }
        reg_fence(acc);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          reg_fence(ap[0][jj]);
          reg_fence(ap[1][jj]);
        }
        wgmma_fence();
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = 2 * j2 + jj;
          const uint32_t vh = vb + (j >> 2) * V_BOX + 32 * (j & 3);
#pragma unroll
          for (int p = 0; p < VALUE_PASSES; ++p)
            mma_tf32_rs(acc, ap[value_p_part(p)][jj],
                        desc(vh + value_v_part(p) * 2 * V_BOX));
        }
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(acc);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          reg_fence(ap[0][jj]);
          reg_fence(ap[1][jj]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(vempty + 8 * sv);
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = __fadd_rn(o[i], acc[i]);
    // the tile's den: the four lanes of a row, a fixed butterfly
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1)
        dpart[h] = __fadd_rn(dpart[h],
                             __shfl_xor_sync(0xffffffffu, dpart[h], x));
      den[h] = __fadd_rn(den[h], dpart[h]);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long gr = r0 + 64 * g + 16 * warp + lane / 4 + 8 * h;
    if (gr >= G.m) continue;
    const float dn = signed_floor(den[h], G.eps);
    TOut* orow = out + gr * G.dv;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int gm = col0 + 8 * j + cl;
      const float v0 = __fdiv_rn(o[4 * j + 2 * h], dn);
      const float v1 = __fdiv_rn(o[4 * j + 2 * h + 1], dn);
      if ((G.dv & 1) == 0) {
        if (gm < G.dv) store2(orow + gm, v0, v1);
      } else {
        if (gm < G.dv) store1(orow + gm, v0);
        if (gm + 1 < G.dv) store1(orow + gm + 1, v1);
      }
    }
  }
}

// ---- prep kernels (once per launch) ---------------------------------------------

// k_land (c x d) -> c rows of dp features (zero past d): f32 the TF32 parts
// hi, lo; bf16 the values.  One thread an element.
template <typename TIn>
__global__ void prep_keys(const TIn* __restrict__ k, int c, int d, int dp,
                          int bf16, float* hi, float* lo,
                          __nv_bfloat16* kb) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)c * dp) return;
  const int i = (int)(e / dp), f = (int)(e % dp);
  const float x = f < d ? load_f32(k + (long long)i * d + f) : 0.f;
  if (bf16) {
    kb[e] = __float2bfloat16(x);   // exact: bf16 inputs
  } else {
    const float h = tf32(x);
    hi[e] = h;
    lo[e] = tf32(__fsub_rn(x, h));
  }
}

// UV (c x dv, row-major) -> UV^T (dvp x cp), zero past c and dv.  f32: the
// TF32 parts hi, lo, with the landmarks of each group of 8 stored in the
// order 0, 2, 4, 6, 1, 3, 5, 7 (the A fragment's columns); bf16: the
// values, landmarks in order.  32 x 32 tiles through shared memory, block
// (32, 8).
template <typename TIn>
__global__ void prep_rhs(const TIn* __restrict__ V, int c, int dv, int cp,
                         int bf16, float* vhi, float* vlo,
                         __nv_bfloat16* vb) {
  __shared__ float t[32][33];
  const int k0 = blockIdx.x * 32, m0 = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int i = ty; i < 32; i += 8) {
    const int key = k0 + i, col = m0 + tx;
    t[i][tx] = (key < c && col < dv) ? load_f32(V + (long long)key * dv + col)
                                     : 0.f;
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    const long long dst = (long long)(m0 + i) * cp + k0 + tx;
    if (bf16) {
      vb[dst] = __float2bfloat16(t[tx][i]);
    } else {
      const int l = tx & 7;
      const int src = (tx & ~7) | (l < 4 ? 2 * l : 2 * (l - 4) + 1);
      const float v = t[src][i];
      const float h = tf32(v);
      vhi[dst] = h;
      vlo[dst] = tf32(__fsub_rn(v, h));
    }
  }
}

// ---- host side ---------------------------------------------------------------------

long long round_up(long long x, long long m) { return (x + m - 1) / m * m; }

struct Form {
  int bf16, es, nkp, dp, cp, dvp;
};

Form form_of(int c, int d, int dv, int bf16) {
  Form f;
  f.bf16 = bf16;
  f.es = bf16 ? 2 : 4;
  f.nkp = bf16 ? 1 : 2;
  f.dp = (int)round_up(d, bf16 ? 16 : 8);   // 32-byte rows
  f.cp = (int)round_up(c, BK);
  f.dvp = (int)round_up(dv, BN);
  return f;
}

long long key_part_bytes(const Form& f, int c) {
  return round_up((long long)c * f.dp * f.es, 256);
}
long long rhs_part_bytes(const Form& f) {
  return round_up((long long)f.dvp * f.cp * f.es, 256);
}
long long workspace_bytes(int c, int d, int dv, int bf16) {
  const Form f = form_of(c, d, dv, bf16);
  return f.nkp * (key_part_bytes(f, c) + rhs_part_bytes(f));
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// codes past cudaError_t's range
constexpr int ERR_NO_ENCODER = 10001;
constexpr int ERR_ENCODE = 10002;
constexpr int ERR_WORKSPACE = 10010;
constexpr int ERR_ALIGN = 10011;

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 2-d map (inner elements per row, rows) with boxes of 128 bytes x
// box_rows, the 128-byte swizzle and zero fill out of bounds
bool encode_2d(EncodeTiled fn, CUtensorMap* map, const void* ptr, int es,
               long long inner, long long rows, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(inner * es)};
  const cuuint32_t box[2] = {(cuuint32_t)(ROWB / es), (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, es == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                         : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
            2, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the most ring stages (2..MAX_STAGES) that fit in `budget` bytes (the
// 1 KB alignment slack included); 0 if not even 2
int stages_for(int nkp, int vslot, int budget) {
  int best = 0;
  for (int st = 2; st <= MAX_STAGES; ++st)
    if ((int)layout(nkp, st, vslot).total + 1024 <= budget) best = st;
  return best;
}

constexpr int SMEM_MAX = 232448;   // dynamic shared memory of a block
constexpr int MAX_DEVICES = 64;

template <int BF, typename TOut>
cudaError_t launch_tc(const Maps& maps, void* out, Geo G, int device,
                      cudaStream_t s) {
  using K = Kind<BF>;
  G.stages = stages_for(K::NKP, K::VSLOT, SMEM_MAX);
  if (G.stages == 0) return cudaErrorInvalidValue;
  const int smem = (int)layout(K::NKP, G.stages, K::VSLOT).total + 1024;
  // the attribute, per device, raised only when it must grow
  static int smem_set[MAX_DEVICES] = {};
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (smem > smem_set[device]) {
    cudaError_t err = cudaFuncSetAttribute(
        landmark_read_tc<BF, TOut>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set[device] = smem;
  }
  const long long row_tiles = (G.m + BR - 1) / BR;
  const long long chunks = (G.dv + BN - 1) / BN;
  if (row_tiles > INT_MAX / BR || chunks > 65535) return cudaErrorInvalidValue;
  landmark_read_tc<BF, TOut><<<dim3((unsigned)row_tiles, (unsigned)chunks),
                               NTW, smem, s>>>(maps, static_cast<TOut*>(out),
                                               G);
  return cudaGetLastError();
}

template <typename TIn>
cudaError_t prep(const void* kl, const void* uv, const Form& f, int c, int d,
                 int dv, char* ws, cudaStream_t s) {
  float* khi = reinterpret_cast<float*>(ws);
  float* klo = reinterpret_cast<float*>(ws + key_part_bytes(f, c));
  char* v = ws + f.nkp * key_part_bytes(f, c);
  float* vhi = reinterpret_cast<float*>(v);
  float* vlo = reinterpret_cast<float*>(v + rhs_part_bytes(f));
  const long long elems = (long long)c * f.dp;
  prep_keys<TIn><<<(unsigned)((elems + 255) / 256), 256, 0, s>>>(
      static_cast<const TIn*>(kl), c, d, f.dp, f.bf16, khi, klo,
      reinterpret_cast<__nv_bfloat16*>(khi));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  prep_rhs<TIn><<<dim3((unsigned)(f.cp / 32), (unsigned)(f.dvp / 32)),
                  dim3(32, 8), 0, s>>>(static_cast<const TIn*>(uv), c, dv,
                                       f.cp, f.bf16, vhi, vlo,
                                       reinterpret_cast<__nv_bfloat16*>(vhi));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// scratch bytes of a tensor-core launch (the wrapper allocates them):
// k_land's and UV^T's operand forms
long long landmark_tc_workspace_bytes(int c, int d, int dv, int in_bf16) {
  return workspace_bytes(c, d, dv, in_bf16 != 0);
}

// the tensor-core passes of the read: of the scores (which = 0) or of the
// numerator's product (which = 1)
int landmark_passes(int in_bf16, int which) {
  if (in_bf16) return 1;
  return which == 0 ? SCORE_PASSES : VALUE_PASSES;
}

// out (m x dv, row-major, bf16 if out_bf16 else f32) = the landmark read of
// Q (m x d), k_land (c x d), UV (c x dv) -- all bf16 if in_bf16 else f32 --
// U1 (c,) f32 and the f32 device scalar *off, on the tensor cores: the prep
// kernels, then the read.  Q's row stride (d times its element size) and
// its address must be multiples of 16 bytes (TMA).  Returns 0 or an error
// code (landmark_error_string).
int landmark_read_tc(const void* q, const void* kl, const void* uv,
                     const void* u1, const void* off, void* out, void* ws,
                     long long ws_bytes, long long m, int c, int d, int dv,
                     int in_bf16, int out_bf16, float inv_sqrt_d, float eps,
                     int device, void* stream) {
  if (m <= 0 || c <= 0 || d <= 0 || dv <= 0 || ws == nullptr)
    return (int)cudaErrorInvalidValue;
  if (in_bf16 && !out_bf16) return (int)cudaErrorInvalidValue;
  const Form f = form_of(c, d, dv, in_bf16 != 0);
  if (((long long)d * f.es) % 16 != 0 || ((uintptr_t)q & 15) != 0)
    return ERR_ALIGN;
  if (ws_bytes < workspace_bytes(c, d, dv, in_bf16 != 0))
    return ERR_WORKSPACE;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  char* w = static_cast<char*>(ws);
  err = in_bf16 ? prep<__nv_bfloat16>(kl, uv, f, c, d, dv, w, s)
                : prep<float>(kl, uv, f, c, d, dv, w, s);
  if (err != cudaSuccess) return (int)err;
  EncodeTiled fn = encoder();
  if (fn == nullptr) return ERR_NO_ENCODER;
  Maps maps;
  char* v = w + f.nkp * key_part_bytes(f, c);
  if (!encode_2d(fn, &maps.q, q, f.es, d, m, BR)) return ERR_ENCODE;
  for (int p = 0; p < 2; ++p) {
    const int pp = p < f.nkp ? p : 0;
    if (!encode_2d(fn, &maps.k[p], w + pp * key_part_bytes(f, c), f.es, f.dp,
                   c, BK))
      return ERR_ENCODE + 1;
    if (!encode_2d(fn, &maps.v[p], v + pp * rhs_part_bytes(f), f.es, f.cp,
                   f.dvp, BN))
      return ERR_ENCODE + 2;
  }
  Geo G{};
  G.u1 = static_cast<const float*>(u1);
  G.off = static_cast<const float*>(off);
  G.m = m;
  G.c = c;
  G.dv = dv;
  G.nch = (int)((d * (long long)f.es + ROWB - 1) / ROWB);
  G.inv_sqrt_d = inv_sqrt_d;
  G.eps = eps;
  if (in_bf16)
    err = launch_tc<1, __nv_bfloat16>(maps, out, G, device, s);
  else if (out_bf16)
    err = launch_tc<0, __nv_bfloat16>(maps, out, G, device, s);
  else
    err = launch_tc<0, float>(maps, out, G, device, s);
  return (int)err;
}

const char* landmark_error_string(int code) {
  switch (code) {
    case ERR_NO_ENCODER:
      return "cuTensorMapEncodeTiled is not available (CUDA 12 or newer)";
    case ERR_ENCODE:
      return "cuTensorMapEncodeTiled refused Q's layout";
    case ERR_ENCODE + 1:
      return "cuTensorMapEncodeTiled refused k_land's layout";
    case ERR_ENCODE + 2:
      return "cuTensorMapEncodeTiled refused UV's layout";
    case ERR_WORKSPACE:
      return "the scratch buffer is smaller than the launch needs";
    case ERR_ALIGN:
      return "Q's rows or address are not 16-byte aligned (TMA)";
    default:
      return cudaGetErrorString((cudaError_t)code);
  }
}

}  // extern "C"
