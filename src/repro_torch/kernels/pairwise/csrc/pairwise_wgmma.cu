// Pairwise kernel tiles on Hopper's tensor cores (sm_90a), plain C interface.
//
// What each entry point replaces (the Pallas TPU kernels of the reference,
// src/repro/kernels/pairwise/kernel.py):
//
//   pairwise_block_f32           <- pairwise_block_padded (:241)
//                                   out[i, j] = entry(stat(Xr[i], Xc[j]))
//   pairwise_matmat_multi_f32    <- pairwise_matmat_multi_padded (:127)
//                                   out = K(Xr, Xc) @ V, K never written out
//   pairwise_matmat_multi_slab_f32
//                                <- pairwise_matmat_multi_slab (:184)
//                                   the same over the rows X[start + i]
//                                   (clamped to n - 1) against all of X
//
// Statistics: dot, sqdist = max((xx + yy) - 2 x.y, 0), l1dist = sum |x - y|;
// entries: identity, exp(-a t), Matern-3/2, integer polynomial,
// exp(a t - b), picked at run time by the ids the wrapper passes.
//
// User variants.  A KernelSpec with only a Python entry_fn is lowered to a
// device function user_entry(float t) (repro_torch.kernels.pairwise.lower)
// and this source is built again with
//   -include <generated header> -DPAIRWISE_USER_STAT=<statistic id>:
// the epilogue is user_entry and its id EPI_USER the only one the variant
// takes, and only that statistic's kernels are instantiated (both
// precisions), so a variant's nvcc is a fraction of the built-in
// library's.  Without the define the library compiles as the built-in one,
// which refuses EPI_USER.
//
// Precision and passes.
//   * Cross term x.y of dot and sqdist on the tensor cores (wgmma, 64 rows x
//     64 keys a warpgroup, k8 / k16 steps over 128-byte feature chunks).
//     f32 policy: split TF32.  The prep kernel stores each point as hi =
//     cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi); STAT_PASSES = 4 passes
//     lo.lo + hi.lo + lo.hi + hi.hi (small ones first), f32 accumulation
//     (pairwise_passes reports the counts a launch runs); x - hi - lo,
//     below 2^-22 |x|, is dropped, which weighs less than the combine's own
//     rounding below.  bf16_f32acc: points rounded to bf16 (RNE), one bf16
//     pass; products of bf16 values are exact in f32.  Each 128-byte
//     feature chunk sums in a fresh accumulator that is then added into the
//     statistic with __fadd_rn.
//   * Row and column squared norms are computed once per point by the prep
//     kernel (FP32 FMAs: in feature order for rows of at most 32 features,
//     else per lane over a warp and a fixed butterfly); the combine is
//     written with _rn intrinsics so the compiler cannot contract it.
//   * The near pairs of sqdist (f32 policy).  The combine (xx + yy) - 2 x.y
//     rounds at the scale of xx + yy, whatever the cross term's accuracy:
//     where the points lie far from the origin and near each other (a point
//     and itself) D comes out a few ulps of xx + yy off, and a steep entry
//     multiplies that (rbf: by gamma).  So each entry whose combine is
//     below NEAR_TAU (xx + yy) is evaluated again directly, sum (x - y)^2
//     in feature order with one FMA a feature, x = hi + lo (sq_near
//     below).
//   * l1dist is a direct |x - y| sum in feature order on the CUDA cores.
//   * The contraction K @ V of the sweep kernel: f32 policy in
//     CONTRACT_PASSES = 4 TF32 passes, hi.Vhi + hi.Vlo + lo.Vhi + rem.Vhi, where hi, lo, rem are the
//     entry's three TF32 parts (hi + lo + rem == entry exactly) and Vhi,
//     Vlo V's two.  Against a 0/1 column every product but the entry's own
//     parts is an exact 0, and the parts add back exactly: the one-hot
//     gather returns the block kernel's entry bit for bit.  The dropped
//     terms (lo.Vlo, rem.Vlo) are ~2^-22 of |K||V|.  bf16_f32acc: entry and V
//     rounded to bf16, one bf16 pass (the reference's bf16-operand,
//     f32-accumulator contraction).
//   * Tensor-core sums are not IEEE round-to-nearest, so each 64-key tile's
//     contribution is accumulated on its own and added into a running f32
//     sum (__fadd_rn): the reference's two-level sum, 782 adds at n = 50,000.
//
// Bitwise agreements the callers check.  The statistic of the block kernel
// and of the sweep kernel comes from one device function (stat_chunk) with
// the same wgmma shape (m64n64) and the same order of steps and passes, on
// the same prepped operands, and the near pairs' direct sum is a function
// of the two points' values alone (sq_near, for both); a row's
// arithmetic depends neither on its position in a tile nor on the slab's
// start.  So the one-hot gather through B1 or B4 equals B2's entries, and
// B4's rows equal B1's.
//
// Design.  Prep kernels write the points once per launch in operand form
// (hi/lo TF32 parts, bf16, or f32 values for l1dist, features zero-padded
// to a 32-byte multiple; a slab's rows are gathered with their clamp) with
// their squared norms, and the sweep's V^T once (prep_rhs): TF32 wgmma
// takes B K-major only, and the keys of each group of 8 are stored permuted
// so the f32 accumulator of the statistic is, lane for lane, the A fragment
// of the contraction (no shuffle, no shared memory).  The wrapper allocates
// that scratch (pairwise_workspace_bytes), and every entry point refuses a
// smaller buffer.  Blocks are three warpgroups (FlashAttention-3's shape, as
// in flash_wgmma.cu): one producer thread issues TMA loads (2-d tensor maps
// over the prepped arrays, 128-byte boxes with the 128-byte swizzle, zero
// fill past the edges) into a ring of mbarrier-guarded stages; two
// consumer warpgroups of 64 rows each wait on a stage, compute, and release
// it, with no block-wide barrier, so one warpgroup's CUDA-core work can run
// beside the other's tensor-core work; setmaxnreg moves registers to them.
//   * pairwise_block_tc: a block owns 128 rows and a strip of 64-key column
//     tiles (one wave of two blocks an SM).  A warpgroup writes its 64 x 64
//     entries into a swizzled staging tile and two TMA stores write it out,
//     clipped at the edges, while the warpgroup goes on to the next tile;
//     where nc % 4 != 0 (TMA needs 16-byte row strides) or the staging does
//     not fit beside two blocks an SM (d > 32), 8-byte streaming stores go
//     straight from the accumulator (each warp store fills 8 whole 32-byte
//     sectors).
//   * pairwise_matmat_tc: a block owns 128 rows x 128 columns of V (9
//     chunks at M = 1,064) and walks all keys: per 64-key tile the
//     statistic (wgmma), the entries in registers, the masked entries' parts
//     as A fragments, the contraction (wgmma m64n128, B = V^T tiles from a
//     second two-slot ring), the tile sum added into the running sum.  The
//     two warpgroups take turns at the contraction (named barriers), so
//     one's entries run on the CUDA cores while the other's contraction
//     runs on the tensor cores.  Blocks of one V chunk are adjacent in the
//     grid, so they stream the same V tiles through L2.
//   * Where a point's padded row is at most 64 bytes (d <= 16 under f32,
//     d <= 32 under bf16), the statistic runs 2 of a chunk's 4 k steps
//     (template KS): past the width TMA filled zeros.
// Entries of keys past nc are set to 0 before the contraction (an entry can
// be inf or NaN, so 0 * entry is not relied on); rows past nr are not
// stored.  Row * leading-dimension offsets are 64-bit.
// The tensor cores flush subnormal inputs: an entry below 2^-104 (whose
// TF32 parts reach below 2^-126) may lose up to 2^-126 in the contraction,
// so the one-hot gather is exact for entries of 2^-104 and more.
//
// What bounds them.  B2 at d = 16 writes nr nc 4-byte entries: bytes.  B2
// under exp_affine at d = 256 does 2 d nr nc flops per pass: operations.
// B1 does 2 nr nc M flops per pass (four under f32, one under bf16): the
// TF32 (495 TFLOP/s) or bf16 (989) tensor-core rate.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int WG = 128;         // threads of a warpgroup
constexpr int BR = 128;         // rows of a block (64 per warpgroup)
constexpr int BK = 64;          // keys of a tile
constexpr int BN = 128;         // V columns of a sweep block
constexpr int ROWB = 128;       // bytes of one swizzled row of a tile
constexpr int XR_PART = BR * ROWB;       // 16 KB: a block's rows, one chunk
constexpr int XC_PART = BK * ROWB;       // 8 KB: a tile's keys, one chunk
constexpr int V_BOX = BN * ROWB;         // 16 KB: 32 f32 / 64 bf16 keys

enum { STAT_DOT = 0, STAT_SQDIST = 1, STAT_L1 = 2 };
enum {
  EPI_IDENTITY = 0,
  EPI_EXP_NEG = 1,
  EPI_MATERN32 = 2,
  EPI_POLY = 3,
  EPI_EXP_AFFINE = 4,  // exp(a t - b): the softmax Gram exp(t / sqrt(d) - offset)
  EPI_USER = 5         // user_entry(t), in a user variant only
};

#ifdef PAIRWISE_USER_STAT
#if PAIRWISE_USER_STAT < 0 || PAIRWISE_USER_STAT > 2
#error "PAIRWISE_USER_STAT must be a statistic id (0, 1 or 2)"
#endif
#endif

struct Params {
  int epi;
  float a;
  float b;
  int degree;
};

// ---- numerics shared by every kernel ---------------------------------------

__device__ __forceinline__ float quant_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// round to TF32: nearest, ties away from zero (the 13 low bits cleared)
__device__ __forceinline__ float tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
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

// the statistic and epilogue ids a launch of this build may pass
bool build_takes(int stat, int epi) {
#ifdef PAIRWISE_USER_STAT
  return stat == PAIRWISE_USER_STAT && epi == EPI_USER;
#else
  return stat >= STAT_DOT && stat <= STAT_L1 && epi >= EPI_IDENTITY &&
         epi <= EPI_EXP_AFFINE;
#endif
}

__device__ __forceinline__ float entry(float t, const Params& p) {
#ifdef PAIRWISE_USER_STAT
  // a user variant: the generated header's lowered entry_fn, the only
  // epilogue it takes (no switch beside it in the tiles' registers)
  (void)p;
  return user_entry(t);
#else
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
#endif
}

// ---- PTX wrappers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptors, 128-byte swizzle, K-major: stride byte
// offset 1 KB (8 rows of 128 bytes), layout type 1; low word = start address
// in 16-byte units and the (unused) leading offset 1.  A k8 (TF32) or k16
// (bf16) step adds 32 bytes.
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

// d (64 x 64 f32) += A (64 x 8 TF32, K-major, shared) * B (8 x 64, K-major)
__device__ __forceinline__ void mma_tf32_ss(float (&d)[32], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " D32
      ", %32, %33, p, 1, 1;\n}\n"
      : D32_OPS
      : "l"(da), "l"(db));
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo: low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- mbarriers and TMA ------------------------------------------------------

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
// shared -> global through the tensor map (clipped at its edges)
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// until the committed bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}
// this thread's shared-memory writes, visible to the async proxy (TMA)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
// a barrier of one warpgroup's 128 threads
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}
// the two consumer warpgroups' turn-taking: wait for the other's arrival
// (256 threads in all), or arrive for it
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, 256;" ::"r"(id) : "memory");
}

// ---- operands and the shared-memory layout -----------------------------------

template <int STAT, int BF>
struct Kind {
  // part 0: TF32 hi (f32 dot / sqdist), bf16 values (bf16_f32acc dot /
  // sqdist) or f32 values (l1dist); part 1: TF32 lo (f32 dot / sqdist)
  static constexpr int NPARTS = (STAT != STAT_L1 && !BF) ? 2 : 1;
  static constexpr int ES = (STAT != STAT_L1 && BF) ? 2 : 4;   // bytes
};

// tensor maps of one launch (prepped operands): boxes of 128 bytes of a row
// (32 f32 or 64 bf16 features) with the 128-byte swizzle, so a box lands in
// shared memory in the wgmma K-major layout; TMA's zero fill covers rows
// past the count and features past the padded width
struct Maps {
  CUtensorMap xr[2];   // the block's rows: boxes of 128 rows
  CUtensorMap xc[2];   // the keys: boxes of 64 rows
  CUtensorMap yy;      // the keys' squared norms: rows of 64, one a box
  CUtensorMap v[2];    // V^T's parts: boxes of 128 bytes of keys x 128 columns
  CUtensorMap out;     // block kernel: the output, boxes of 32 x 64 (store)
};

struct Geo {
  const float* xr_nrm;   // squared norms of the block's rows
  // the prepped parts (f32 sqdist: the near pairs' values where a row
  // spans chunks), rows of dp features
  const float* xr_part[2];
  const float* xc_part[2];
  int dp;
  long long nr, nc, M;
  int row_bytes, nch, stages;
  long long col_tiles;   // block kernel: column tiles of 64 keys
  int tpb;               // block kernel: column tiles per block
  int tma_store;         // block kernel: tiles leave through TMA stores
  Params p;
};

// [rows, when resident][stages x (key chunk parts [+ row chunk parts])]
// [2 x vstage: the sweep's V ring, or the block kernel's two staging
// tiles][stages x 64 key norms][barriers], every tile 1 KB aligned
struct Layout {
  uint32_t xr, ring, stage, v, vstage, yy, bars, total;
};
__host__ __device__ __forceinline__ Layout layout(int np, int nch, int stages,
                                                  int vstage) {
  Layout L;
  L.xr = 0;
  L.ring = nch == 1 ? np * XR_PART : 0;
  L.stage = np * XC_PART + (nch > 1 ? np * XR_PART : 0);
  L.v = L.ring + stages * L.stage;
  L.vstage = vstage;
  L.yy = L.v + 2 * vstage;
  L.bars = L.yy + 256 * stages;
  // bars: rows, full[stages], empty[stages], vfull[2], vempty[2]
  L.total = L.bars + 8 * (1 + 2 * stages + 4);
  return L;
}
constexpr int MAX_STAGES = 4;

// ---- the split-TF32 passes (f32 policy) -------------------------------------
//
// The statistic's cross term, small passes first (lo.lo, hi.lo, lo.hi,
// hi.hi): pass p multiplies the rows' part stat_row_part(p) by the keys'
// part stat_key_part(p) (0 = hi, 1 = lo).
constexpr int STAT_PASSES = 4;
__host__ __device__ constexpr int stat_row_part(int p) { return (p & 1) ^ 1; }
__host__ __device__ constexpr int stat_key_part(int p) { return p < 2; }
// The contraction (hi.Vhi, hi.Vlo, lo.Vhi, rem.Vhi): pass p multiplies the
// entry's part contract_entry_part(p) (0 = hi, 1 = lo, 2 = rem) by V's part
// contract_v_part(p) (0 = Vhi, 1 = Vlo).
constexpr int CONTRACT_PASSES = 4;
__host__ __device__ constexpr int contract_entry_part(int p) {
  return p < 2 ? 0 : p - 1;
}
__host__ __device__ constexpr int contract_v_part(int p) { return p == 1; }

// ---- the statistic of one 64 x 64 warpgroup tile ------------------------------
//
// s (accumulator layout: warp w, lane l holds rows 16 w + l / 4 + {0, 8},
// keys 8 j + 2 (l % 4) + {0, 1} of n8 block j as s[4 j + 2 h + e]) gains
// chunk c's share of the statistic.  xr: this warpgroup's 64 rows (part 0;
// part 1 at + XR_PART), xc: the tile's keys (part 1 at + XC_PART); vb: the
// chunk's valid bytes per row (l1dist's feature count).  One function for both kernels: the order of
// steps and passes fixes the bits.
template <int STAT, int BF, int KS>
__device__ __forceinline__ void stat_chunk(float (&s)[32], uint32_t xr,
                                           uint32_t xc, int vb,
                                           const unsigned char* smem,
                                           uint32_t smem_base) {
  if constexpr (STAT == STAT_L1) {
    // |x - y| summed in feature order on the CUDA cores (f32 values)
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % WG) / 32;
    const int r0 = 16 * warp + lane / 4, cl = 2 * (lane & 3);
    const unsigned char* pr = smem + (xr - smem_base);
    const unsigned char* pc = smem + (xc - smem_base);
    const int nf = vb / 4;
    for (int k = 0; k < nf; ++k) {
      const int q = k >> 2, w = 4 * (k & 3);
      float x[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        x[h] = *reinterpret_cast<const float*>(pr + r * ROWB +
                                               ((q ^ (r & 7)) << 4) + w);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = 8 * j + cl + e;
          const float y = *reinterpret_cast<const float*>(
              pc + n * ROWB + ((q ^ (n & 7)) << 4) + w);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float& a = s[4 * j + 2 * h + e];
            a = __fadd_rn(a, fabsf(__fsub_rn(x[h], y)));
          }
        }
    }
  } else {
    // the chunk's share in a fresh accumulator, added into s in f32: the
    // tensor cores' sums are not round-to-nearest, so fewer of them run at
    // the full sum's magnitude; f32: the small passes first (lo.lo, hi.lo,
    // lo.hi), then hi.hi, each over the chunk's k8 steps
    // KS of the chunk's four 32-byte k steps: 4, or 2 where the padded
    // width is at most 64 bytes (past it TMA filled zeros, whose products
    // would add exact zeros); both kernels pick KS from the width alone
    const uint32_t ra = opaque(xr), ca = opaque(xc);
    float part[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) part[i] = 0.f;
    reg_fence(part);
    wgmma_fence();
    if constexpr (BF != 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        mma_bf16_ss(part, desc(ra + 32 * kk), desc(ca + 32 * kk));
    } else {
#pragma unroll
      for (int p = 0; p < STAT_PASSES; ++p)
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          mma_tf32_ss(part, desc(ra + stat_row_part(p) * XR_PART + 32 * kk),
                      desc(ca + stat_key_part(p) * XC_PART + 32 * kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(part);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = __fadd_rn(s[i], part[i]);
  }
}

// ---- the near pairs of the f32 sqdist statistic -------------------------------
//
// The combine D0 = max((xx + yy) - 2 x.y, 0) is off by a few f32 ulps of
// xx + yy, at most c 2^-23 (xx + yy) with c ~ 4.5 (xx, yy, their sum, 2 x.y
// and the difference each round once; 4.45 at most on quickstart's data),
// however exact x.y is.  An entry whose D0 is below NEAR_TAU (xx + yy) is
// evaluated again directly; one left on the combine has D >= NEAR_TAU
// (xx + yy), so its relative error is at most c 2^-23 / NEAR_TAU = 2.1e-6,
// and an entry f(D) moves by |D f'(D)| times that: at most 1/e of it for
// exp(-g D) (7.9e-7), 1/4 for 1 / (1 + g D) (5.4e-7), of the entries'
// scale 1.  A smaller NEAR_TAU redoes fewer entries for a larger bound:
// at 1/16, tests/test_torch_pairwise_split.py's emulation reads 1.4e-6
// from f64 (rbf at sigma 3); at 1/4, 3.2 % of C's entries are redone on
// quickstart's data (32 clusters of spread 0.5 around centers 2 N(0, 1) in
// 16 dimensions; tools/pairwise_ab.py), whatever the bandwidth.
//
// The direct sum reads each point as hi + lo, its prepped TF32 parts (x
// within 2^-22 |x|; a point against itself gives exactly 0): from shared
// memory where a point's padded row is one 128-byte chunk (the resident
// rows, the stage's keys, which the warps release only after it), else
// from the prepped arrays in global memory.  Each lane evaluates its own
// near slots (about one a lane on quickstart's data).
constexpr float NEAR_TAU = 0.25f;
constexpr unsigned FULL = 0xffffffffu;

// where the near pairs read the points: the warpgroup's rows (rw: the
// first) and the tile's keys (c0: the first), part 0 (hi) with part 1 (lo)
// at + XR_PART / + XC_PART in shared memory, or the prepped parts in G
struct NearSrc {
  const unsigned char* xr;
  const unsigned char* xc;
  long long rw, c0;
};

__device__ __forceinline__ float sq4(float a, const float4& xh,
                                     const float4& xl, const float4& yh,
                                     const float4& yl) {
  float df = __fsub_rn(__fadd_rn(xh.x, xl.x), __fadd_rn(yh.x, yl.x));
  a = __fmaf_rn(df, df, a);
  df = __fsub_rn(__fadd_rn(xh.y, xl.y), __fadd_rn(yh.y, yl.y));
  a = __fmaf_rn(df, df, a);
  df = __fsub_rn(__fadd_rn(xh.z, xl.z), __fadd_rn(yh.z, yl.z));
  a = __fmaf_rn(df, df, a);
  df = __fsub_rn(__fadd_rn(xh.w, xl.w), __fadd_rn(yh.w, yl.w));
  return __fmaf_rn(df, df, a);
}

// sum_k (x_k - y_k)^2 of row r (of the warpgroup's 64) and key n (of the
// tile's 64), x = hi + lo, in feature order, one FMA a feature.  KS: the
// kernel's k steps; where a row is one chunk, its 32-byte steps past the
// width hold zeros (TMA's fill), which add exact zeros, so the sum runs
// over all KS of them, unrolled.
template <int KS>
__device__ __forceinline__ float sq_near(const Geo& G, const NearSrc& src,
                                         int r, int n) {
  float a = 0.f;
  if (KS == 2 || G.nch == 1) {
    const unsigned char* pr = src.xr + r * ROWB;
    const unsigned char* pc = src.xc + n * ROWB;
#pragma unroll
    for (int q = 0; q < 2 * KS; ++q) {
      const int qr = (q ^ (r & 7)) << 4, qn = (q ^ (n & 7)) << 4;
      a = sq4(a, *reinterpret_cast<const float4*>(pr + qr),
              *reinterpret_cast<const float4*>(pr + XR_PART + qr),
              *reinterpret_cast<const float4*>(pc + qn),
              *reinterpret_cast<const float4*>(pc + XC_PART + qn));
    }
  } else {
    // rows and keys clamped: a lane without an entry reads in bounds
    const long long ro = min(src.rw + r, G.nr - 1) * G.dp;
    const long long no = min(src.c0 + n, G.nc - 1) * G.dp;
    for (int q = 0; q < G.dp / 4; ++q)
      a = sq4(a, __ldg(reinterpret_cast<const float4*>(G.xr_part[0] + ro) + q),
              __ldg(reinterpret_cast<const float4*>(G.xr_part[1] + ro) + q),
              __ldg(reinterpret_cast<const float4*>(G.xc_part[0] + no) + q),
              __ldg(reinterpret_cast<const float4*>(G.xc_part[1] + no) + q));
  }
  return a;
}

// row and key (of the warpgroup's 64, of the tile's 64) of slot i = 4 j +
// 2 h + e of lane l
__device__ __forceinline__ int slot_row(int l, int i) {
  return 16 * ((threadIdx.x % WG) / 32) + l / 4 + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int slot_key(int l, int i) {
  return 8 * (i >> 2) + 2 * (l & 3) + (i & 1);
}

__device__ __forceinline__ void entries(float (&s)[32], const Params& p) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = entry(s[i], p);
}

// the entry of the direct statistic at slot i of this lane
template <int KS>
__device__ __forceinline__ float near_entry(const Geo& G, const NearSrc& src,
                                            int i) {
  const int lane = threadIdx.x % 32;
  return entry(sq_near<KS>(G, src, slot_row(lane, i), slot_key(lane, i)),
               G.p);
}

// s (the statistic) -> entries, the near slots' from the direct statistic
// (the sweep: they go on to the contraction in registers).  Each lane
// evaluates its own near slots: the first beside the other entries (it
// needs none of s), the rest two at a time while any lane of the warp has
// some.  The whole warp calls it.
template <int KS>
__device__ __forceinline__ void entries_near(float (&s)[32], uint32_t near,
                                             const Geo& G,
                                             const NearSrc& src) {
  uint32_t m = near;
  const int i0 = __ffs(m) - 1;
  m &= m - 1;
  const float e0 = near_entry<KS>(G, src, max(i0, 0));
  entries(s, G.p);
#pragma unroll
  for (int i = 0; i < 32; ++i)
    if (i == i0) s[i] = e0;
  while (__any_sync(FULL, m != 0)) {
    const int i1 = __ffs(m) - 1;
    m &= m - 1;
    const int i2 = __ffs(m) - 1;
    m &= m - 1;
    float e1 = 0.f, e2 = 0.f;
    if (i1 >= 0) e1 = near_entry<KS>(G, src, i1);
    if (i2 >= 0) e2 = near_entry<KS>(G, src, i2);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (i == i1) s[i] = e1;
      if (i == i2) s[i] = e2;
    }
  }
}

// put(row, key, entry) for each near slot, each lane its own, two at a
// time (the block kernel, after the warp's tile is stored)
template <int KS, class Put>
__device__ __forceinline__ void store_near(uint32_t near, const Geo& G,
                                           const NearSrc& src, Put put) {
  const int lane = threadIdx.x % 32;
  while (near != 0) {
    const int i1 = __ffs(near) - 1;
    near &= near - 1;
    const int i2 = __ffs(near) - 1;
    near &= near - 1;
    const float e1 = near_entry<KS>(G, src, i1);
    put(slot_row(lane, i1), slot_key(lane, i1), e1);
    if (i2 >= 0) {
      const float e2 = near_entry<KS>(G, src, i2);
      put(slot_row(lane, i2), slot_key(lane, i2), e2);
    }
  }
}

// the sqdist combine in place; returns the near slots (f32 policy; rows
// past nr and keys past nc are never near).  xx: this lane's two rows'
// squared norms, yy[2 j + e]: its keys'.
template <int BF>
__device__ __forceinline__ uint32_t combine(float (&s)[32],
                                            const float (&xx)[2],
                                            const float (&yy)[16],
                                            const Geo& G,
                                            const NearSrc& src) {
  uint32_t near = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1, k2 = 2 * (i >> 2) + (i & 1);   // yy index
    float& t = s[i];
    const float nn = __fadd_rn(xx[h], yy[k2]);
    t = fmaxf(__fsub_rn(nn, __fmul_rn(2.f, t)), 0.f);
    if (BF == 0) near |= (t < __fmul_rn(NEAR_TAU, nn) ? 1u : 0u) << i;
  }
  if (BF == 0 && (src.rw + 64 > G.nr || src.c0 + 64 > G.nc)) {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (src.rw + slot_row(lane, i) >= G.nr ||
          src.c0 + slot_key(lane, i) >= G.nc)
        near &= ~(1u << i);
  }
  return near;
}

// this lane's keys' squared norms from the stage's copy
__device__ __forceinline__ void key_norms(float (&yy)[16],
                                          const unsigned char* p) {
  const int cl = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 v = *reinterpret_cast<const float2*>(p + 4 * (8 * j + cl));
    yy[2 * j] = v.x;
    yy[2 * j + 1] = v.y;
  }
}

// this lane's two rows' squared norms (0 past nr)
__device__ __forceinline__ void row_norms(float (&xx)[2], const float* nrm,
                                          long long nr, long long rw0) {
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % WG) / 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long g = rw0 + 16 * warp + lane / 4 + 8 * h;
    xx[h] = g < nr ? __ldg(nrm + g) : 0.f;
  }
}

// ---- the producer (one thread) ------------------------------------------------
//
// steps are (tile, chunk) pairs; step st fills stage st % stages of the
// ring (the keys' chunk parts, the rows' chunk parts when they are not
// resident, the keys' norms on a tile's last chunk) and, for the sweep, a
// tile's first step fills V ring slot t % 2.
template <int STAT, int BF, bool SWEEP>
__device__ __forceinline__ void produce(const Maps& maps, const Geo& G,
                                        const Layout& L, uint32_t base,
                                        long long t0, int ntiles,
                                        long long r0, long long m0) {
  using K = Kind<STAT, BF>;
  constexpr int NP = K::NPARTS;
  constexpr int FE = ROWB / K::ES;   // features of a 128-byte chunk
  const int nch = G.nch, S = G.stages;
  const uint32_t bars = base + L.bars;
  const uint32_t full = bars + 8, empty = full + 8 * S;
  const uint32_t vfull = empty + 8 * S, vempty = vfull + 16;
  if (nch == 1) {
    mbar_expect_tx(bars, NP * XR_PART);
    for (int q = 0; q < NP; ++q)
      tma_2d(base + L.xr + q * XR_PART, &maps.xr[q], bars, 0, (int)r0);
  }
  const int nsteps = ntiles * nch;
  for (int st = 0; st < nsteps; ++st) {
    const int c = st % nch, tl = st / nch;
    const int key0 = (int)((t0 + tl) * BK);
    const int sc = st % S;
    const uint32_t ph = (uint32_t)(st / S) & 1u;
    mbar_wait(empty + 8 * sc, ph ^ 1u);
    const bool norms = STAT == STAT_SQDIST && c == nch - 1;
    const uint32_t bytes = NP * XC_PART + (nch > 1 ? NP * XR_PART : 0) +
                           (norms ? 256 : 0);
    mbar_expect_tx(full + 8 * sc, bytes);
    const uint32_t stage = base + L.ring + sc * L.stage;
    for (int q = 0; q < NP; ++q)
      tma_2d(stage + q * XC_PART, &maps.xc[q], full + 8 * sc, c * FE, key0);
    if (nch > 1)
      for (int q = 0; q < NP; ++q)
        tma_2d(stage + NP * XC_PART + q * XR_PART, &maps.xr[q], full + 8 * sc,
               c * FE, (int)r0);
    if (norms) tma_2d(base + L.yy + 256 * sc, &maps.yy, full + 8 * sc, 0,
                      key0 / BK);
    if (SWEEP && c == 0) {
      const int sv = tl & 1;
      const uint32_t pv = (uint32_t)(tl >> 1) & 1u;
      mbar_wait(vempty + 8 * sv, pv ^ 1u);
      mbar_expect_tx(vfull + 8 * sv, L.vstage);
      const uint32_t vs = base + L.v + sv * L.vstage;
      if constexpr (BF != 0) {
        tma_2d(vs, &maps.v[0], vfull + 8 * sv, key0, (int)m0);
      } else {
        for (int q = 0; q < 2; ++q)
          for (int hb = 0; hb < 2; ++hb)
            tma_2d(vs + (2 * q + hb) * V_BOX, &maps.v[q], vfull + 8 * sv,
                   key0 + 32 * hb, (int)m0);
      }
    }
  }
}

__device__ __forceinline__ void init_barriers(uint32_t bars, int S) {
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int i = 0; i < S; ++i) {
      mbar_init(bars + 8 + 8 * i, 1);                 // full: the producer
      mbar_init(bars + 8 + 8 * (S + i), 2 * 4);       // empty: 8 warps
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(bars + 8 + 8 * (2 * S + i), 1);
      mbar_init(bars + 8 + 8 * (2 * S + 2 + i), 2 * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

constexpr int NTW = 3 * WG;   // two consumer warpgroups + the producer
constexpr int OUT_STAGE = 64 * 64 * 4;   // a warpgroup's 64 x 64 f32 tile
constexpr int TURN = 3;   // named barriers TURN, TURN + 1: the sweep's turns
constexpr int PRODUCER_REGS = 24;

// ---- the block kernel (B2) ------------------------------------------------------

// out (nr x nc) = entry(stat(Xr, Xc)).  Block (x, y): rows [128 y, 128 y +
// 128), column tiles [tpb x, tpb x + tpb); warpgroup g < 2 owns rows 64 g ..
// + 63 and writes its entries from the accumulator to global memory.
template <int STAT, int BF, int KS>
__global__ void __launch_bounds__(NTW, 2)
pairwise_block_tc(const __grid_constant__ Maps maps, float* __restrict__ out,
                  Geo G) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const unsigned char* smem = smem_raw + (base - raw);
  using K = Kind<STAT, BF>;
  const Layout L =
      layout(K::NPARTS, G.nch, G.stages, G.tma_store ? OUT_STAGE : 0);
  const long long r0 = (long long)blockIdx.y * BR;
  const long long t0 = (long long)blockIdx.x * G.tpb;
  const int ntiles = (int)min((long long)G.tpb, G.col_tiles - t0);
  init_barriers(base + L.bars, G.stages);

  if (threadIdx.x / WG == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 2 * WG)
      produce<STAT, BF, false>(maps, G, L, base, t0, ntiles, r0, 0);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(104));
  const int g = threadIdx.x / WG;
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % WG) / 32;
  const int cl = 2 * (lane & 3);
  const int nch = G.nch, S = G.stages;
  const uint32_t bars = base + L.bars;
  const uint32_t full = bars + 8, empty = full + 8 * S;
  float xx[2];
  row_norms(xx, G.xr_nrm, G.nr, r0 + 64 * g);
  if (nch == 1) mbar_wait(bars, 0);
  float s[32];
  const int nsteps = ntiles * nch;
  for (int st = 0; st < nsteps; ++st) {
    const int c = st % nch;
    const long long c0 = (t0 + st / nch) * BK;
    const int sc = st % S;
    mbar_wait(full + 8 * sc, (uint32_t)(st / S) & 1u);
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
    }
    const uint32_t stage = base + L.ring + sc * L.stage;
    const uint32_t xr = (nch == 1 ? base + L.xr : stage + K::NPARTS * XC_PART) +
                        g * 64 * ROWB;
    stat_chunk<STAT, BF, KS>(s, xr, stage, min(ROWB, G.row_bytes - ROWB * c),
                         smem, base);
    float yy[16];
    if constexpr (STAT == STAT_SQDIST)
      if (c == nch - 1) key_norms(yy, smem + L.yy + 256 * sc);
    if (c != nch - 1) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * sc);
      continue;
    }
    // the tile's entries; f32 sqdist: the near pairs, evaluated again once
    // the warp's entries are stored, read the stage, released after them
    const NearSrc src{smem + (xr - base), smem + (stage - base),
                      r0 + 64 * g, c0};
    uint32_t near = 0;
    if constexpr (STAT == STAT_SQDIST) near = combine<BF>(s, xx, yy, G, src);
    entries(s, G.p);
    if (G.tma_store) {
      // the tile through this warpgroup's staging buffer (two 32-column
      // boxes, 128-byte swizzle) and two TMA stores, clipped at the edges
      const uint32_t buf = base + L.v + g * OUT_STAGE;
      if (threadIdx.x % WG == 0) bulk_wait_read();
      wg_sync(1 + g);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + lane / 4 + 8 * h;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 8 * j + cl;               // 0 .. 63, even
          const int q = (col & 31) >> 2;            // 16-byte chunk
          const uint32_t a = buf + (col >> 5) * (OUT_STAGE / 2) + r * ROWB +
                             ((q ^ (r & 7)) << 4) + 4 * (col & 3);
          asm volatile("st.shared.v2.f32 [%0], {%1, %2};" ::"r"(a),
                       "f"(s[4 * j + 2 * h]), "f"(s[4 * j + 2 * h + 1])
                       : "memory");
        }
      }
      if constexpr (STAT == STAT_SQDIST && BF == 0) {
        __syncwarp();
        store_near<KS>(near, G, src, [&](int r, int n, float v) {
          const int q = (n & 31) >> 2;
          const uint32_t a = buf + (n >> 5) * (OUT_STAGE / 2) + r * ROWB +
                             ((q ^ (r & 7)) << 4) + 4 * (n & 3);
          asm volatile("st.shared.f32 [%0], %1;" ::"r"(a), "f"(v) : "memory");
        });
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * sc);
      fence_async_smem();
      wg_sync(1 + g);
      if (threadIdx.x % WG == 0) {
        const int row = (int)(r0 + 64 * g);
        tma_store_2d(&maps.out, buf, (int)c0, row);
        tma_store_2d(&maps.out, buf + OUT_STAGE / 2, (int)c0 + 32, row);
        bulk_commit();
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long gr = r0 + 64 * g + 16 * warp + lane / 4 + 8 * h;
        if (gr >= G.nr) continue;
        float* orow = out + gr * G.nc;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const long long gc = c0 + 8 * j + cl;
          const float v0 = s[4 * j + 2 * h], v1 = s[4 * j + 2 * h + 1];
          if ((G.nc & 1) == 0) {
            if (gc < G.nc)
              __stcs(reinterpret_cast<float2*>(orow + gc), make_float2(v0, v1));
          } else {
            if (gc < G.nc) __stcs(orow + gc, v0);
            if (gc + 1 < G.nc) __stcs(orow + gc + 1, v1);
          }
        }
      }
      if constexpr (STAT == STAT_SQDIST && BF == 0) {
        __syncwarp();
        store_near<KS>(near, G, src, [&](int r, int n, float v) {
          __stcs(out + (r0 + 64 * g + r) * G.nc + c0 + n, v);
        });
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * sc);
    }
  }
  if (G.tma_store && threadIdx.x % WG == 0) bulk_wait();
}

// ---- the sweep kernel (B1, B4) ------------------------------------------------

// out (nr x M) = K(Xr, Xc) @ V: block (x, y) owns rows [128 x, 128 x + 128)
// and V columns [128 y, 128 y + 128), and walks every key tile.
template <int STAT, int BF, int KS>
__global__ void __launch_bounds__(NTW, 1)
pairwise_matmat_tc(const __grid_constant__ Maps maps, float* __restrict__ out,
                   Geo G) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const unsigned char* smem = smem_raw + (base - raw);
  using K = Kind<STAT, BF>;
  const Layout L = layout(K::NPARTS, G.nch, G.stages, BF ? V_BOX : 4 * V_BOX);
  const long long r0 = (long long)blockIdx.x * BR;
  const long long m0 = (long long)blockIdx.y * BN;
  const int tiles = (int)((G.nc + BK - 1) / BK);
  init_barriers(base + L.bars, G.stages);

  if (threadIdx.x / WG == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 2 * WG)
      produce<STAT, BF, true>(maps, G, L, base, 0, tiles, r0, m0);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(240));
  const int g = threadIdx.x / WG;
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % WG) / 32;
  const int cl = 2 * (lane & 3);
  const int nch = G.nch, S = G.stages;
  const uint32_t bars = base + L.bars;
  const uint32_t full = bars + 8, empty = full + 8 * S;
  const uint32_t vfull = empty + 8 * S, vempty = vfull + 16;
  float xx[2];
  row_norms(xx, G.xr_nrm, G.nr, r0 + 64 * g);
  if (nch == 1) mbar_wait(bars, 0);
  float o[64], acc[64], s[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  if (g == 1) turn_pass(TURN);   // warpgroup 0 takes the first turn
  const int nsteps = tiles * nch;
  for (int st = 0; st < nsteps; ++st) {
    const int c = st % nch, t = st / nch;
    const long long c0 = (long long)t * BK;
    const int sc = st % S;
    mbar_wait(full + 8 * sc, (uint32_t)(st / S) & 1u);
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
    }
    const uint32_t stage = base + L.ring + sc * L.stage;
    const uint32_t xr = (nch == 1 ? base + L.xr : stage + K::NPARTS * XC_PART) +
                        g * 64 * ROWB;
    stat_chunk<STAT, BF, KS>(s, xr, stage, min(ROWB, G.row_bytes - ROWB * c),
                         smem, base);
    float yy[16];
    if constexpr (STAT == STAT_SQDIST)
      if (c == nch - 1) key_norms(yy, smem + L.yy + 256 * sc);
    if (c != nch - 1) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * sc);
      continue;
    }
    // the entries; f32 sqdist: the near pairs read the stage, released
    // after them
    if constexpr (STAT == STAT_SQDIST && BF == 0) {
      const NearSrc src{smem + (xr - base), smem + (stage - base),
                        r0 + 64 * g, c0};
      entries_near<KS>(s, combine<BF>(s, xx, yy, G, src), G, src);
    } else {
      if constexpr (STAT == STAT_SQDIST) {
        const NearSrc src{nullptr, nullptr, r0 + 64 * g, c0};
        combine<BF>(s, xx, yy, G, src);
      }
      entries(s, G.p);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * sc);
    // keys past nc contribute exact zeros
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (c0 + 8 * j + cl + e >= G.nc) {
          s[4 * j + e] = 0.f;
          s[4 * j + 2 + e] = 0.f;
        }
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    const int sv = t & 1;
    mbar_wait(vfull + 8 * sv, (uint32_t)(t >> 1) & 1u);
    // the warpgroups take turns at the contraction (0 first), so one's
    // entries run on the CUDA cores while the other's contraction runs on
    // the tensor cores
    turn_wait(TURN + g);
    const uint32_t vb = opaque(base + L.v + sv * L.vstage);
    if constexpr (BF != 0) {
      // entry and V in bf16: the accumulator of n8 blocks 2 kb, 2 kb + 1
      // is, lane for lane, the A fragment of k16 step kb
      uint32_t a[4][4];
#pragma unroll
      for (int kb = 0; kb < 4; ++kb) {
        a[kb][0] = pack_bf16(s[8 * kb + 0], s[8 * kb + 1]);
        a[kb][1] = pack_bf16(s[8 * kb + 2], s[8 * kb + 3]);
        a[kb][2] = pack_bf16(s[8 * kb + 4], s[8 * kb + 5]);
        a[kb][3] = pack_bf16(s[8 * kb + 6], s[8 * kb + 7]);
      }
      reg_fence(acc);
#pragma unroll
      for (int kb = 0; kb < 4; ++kb) reg_fence(a[kb]);
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < 4; ++kb) mma_bf16_rs(acc, a[kb], desc(vb + 32 * kb));
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(acc);
#pragma unroll
      for (int kb = 0; kb < 4; ++kb) reg_fence(a[kb]);
    } else {
      // k8 step j is n8 block j: its A fragment (rows g, g + 8 x logical
      // columns q, q + 4) is the accumulator's (keys 2 q, 2 q + 1), so V^T's
      // keys are stored in that order (prep_rhs); two steps at a time,
      // CONTRACT_PASSES each.  ap[0], ap[1], ap[2]: the entries' hi, lo, rem.
#pragma unroll
      for (int j2 = 0; j2 < 4; ++j2) {
        uint32_t ap[3][2][4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = 2 * j2 + jj;
          const float v[4] = {s[4 * j + 0], s[4 * j + 2], s[4 * j + 1],
                              s[4 * j + 3]};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float hi = tf32(v[q]);
            const float r1 = __fsub_rn(v[q], hi);
            const float lo = tf32(r1);
            ap[0][jj][q] = __float_as_uint(hi);
            ap[1][jj][q] = __float_as_uint(lo);
            ap[2][jj][q] = __float_as_uint(__fsub_rn(r1, lo));
          }
        }
        reg_fence(acc);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int q = 0; q < 3; ++q) reg_fence(ap[q][jj]);
        wgmma_fence();
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = 2 * j2 + jj;
          const uint32_t vh = vb + (j >> 2) * V_BOX + 32 * (j & 3);
#pragma unroll
          for (int p = 0; p < CONTRACT_PASSES; ++p)
            mma_tf32_rs(acc, ap[contract_entry_part(p)][jj],
                        desc(vh + contract_v_part(p) * 2 * V_BOX));
        }
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(acc);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int q = 0; q < 3; ++q) reg_fence(ap[q][jj]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(vempty + 8 * sv);
    if (g == 0 || t < tiles - 1) turn_pass(TURN + 1 - g);
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = __fadd_rn(o[i], acc[i]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long gr = r0 + 64 * g + 16 * warp + lane / 4 + 8 * h;
    if (gr >= G.nr) continue;
    float* orow = out + gr * G.M;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const long long gm = m0 + 8 * j + cl;
      const float v0 = o[4 * j + 2 * h], v1 = o[4 * j + 2 * h + 1];
      if ((G.M & 1) == 0) {
        if (gm < G.M)
          *reinterpret_cast<float2*>(orow + gm) = make_float2(v0, v1);
      } else {
        if (gm < G.M) orow[gm] = v0;
        if (gm + 1 < G.M) orow[gm + 1] = v1;
      }
    }
  }
}

// ---- prep kernels ------------------------------------------------------------

enum { FORM_SPLIT = 0, FORM_BF16 = 1, FORM_F32 = 2 };

// rows i < count of X (n x d, row-major) read as X[min(first + i, last)],
// written in operand form with rows of dp features (zero past d):
// FORM_SPLIT hi = tf32(x), lo = tf32(x - hi); FORM_BF16 bf16(x); FORM_F32 x
// (bf16-rounded first under bf16_f32acc); with their squared norms,
// zero-padded to a multiple of 64 rows
struct PrepJob {
  const float* X;
  long long count, first, last;
  float* p0;
  float* p1;
  __nv_bfloat16* pb;
  float* nrm;
};

// one thread four features (e = element / 4), for up to two point sets;
// dp is a multiple of 8, so a thread's features share a row and 16 bytes
__device__ __forceinline__ void prep_element(const PrepJob& a,
                                             const PrepJob& b, long long e,
                                             int d, int dp, int form,
                                             int bf16, bool seq_norms) {
  const int q4 = dp / 4;   // threads a row
  const long long pad_a = (a.count + BK - 1) / BK * BK;
  const bool in_a = e < pad_a * q4;
  const long long ei = in_a ? e : e - pad_a * q4;
  const long long count = in_a ? a.count : b.count;
  const long long i = ei / q4;
  const int k0 = 4 * (int)(ei % q4);
  if (i >= (count + BK - 1) / BK * BK) return;
  float* nrm = in_a ? a.nrm : b.nrm;
  if (i >= count) {
    if (seq_norms && k0 == 0) nrm[i] = 0.f;
    return;
  }
  const float* src = (in_a ? a.X : b.X) +
                     min((in_a ? a.first : b.first) + i,
                         in_a ? a.last : b.last) * d;
  if (seq_norms && k0 == 0) {   // short rows: the squares in feature order
    float acc = 0.f;
    for (int kk = 0; kk < d; ++kk) {
      float y = src[kk];
      if (bf16) y = quant_bf16(y);
      acc = fmaf(y, y, acc);
    }
    nrm[i] = acc;
  }
  float x[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    x[t] = k0 + t < d ? src[k0 + t] : 0.f;
    if (bf16) x[t] = quant_bf16(x[t]);
  }
  const long long o = i * dp + k0;
  if (form == FORM_SPLIT) {
    float4 hi, lo;
    hi.x = tf32(x[0]); lo.x = tf32(__fsub_rn(x[0], hi.x));
    hi.y = tf32(x[1]); lo.y = tf32(__fsub_rn(x[1], hi.y));
    hi.z = tf32(x[2]); lo.z = tf32(__fsub_rn(x[2], hi.z));
    hi.w = tf32(x[3]); lo.w = tf32(__fsub_rn(x[3], hi.w));
    *reinterpret_cast<float4*>((in_a ? a.p0 : b.p0) + o) = hi;
    *reinterpret_cast<float4*>((in_a ? a.p1 : b.p1) + o) = lo;
  } else if (form == FORM_BF16) {
    uint2 v;
    v.x = pack_bf16(x[0], x[1]);
    v.y = pack_bf16(x[2], x[3]);
    *reinterpret_cast<uint2*>((in_a ? a.pb : b.pb) + o) = v;
  } else {
    *reinterpret_cast<float4*>((in_a ? a.p0 : b.p0) + o) =
        make_float4(x[0], x[1], x[2], x[3]);
  }
}

// the rows' squared norms (rows of more than 32 features), one warp a row:
// lane l sums the squares of
// features l, l + 32, ... in that order (FP32 FMAs), then a fixed butterfly
// adds the lanes' sums; rows past the count up to a multiple of 64 get 0
__device__ __forceinline__ void prep_norm(const PrepJob& a, const PrepJob& b,
                                          long long w, int d, int bf16) {
  const int lane = threadIdx.x % 32;
  const long long pad_a = (a.count + BK - 1) / BK * BK;
  const bool in_a = w < pad_a;
  const long long i = in_a ? w : w - pad_a;
  const long long count = in_a ? a.count : b.count;
  if (i >= (count + BK - 1) / BK * BK) return;
  float* nrm = in_a ? a.nrm : b.nrm;
  if (i >= count) {
    if (lane == 0) nrm[i] = 0.f;
    return;
  }
  const float* src = (in_a ? a.X : b.X) +
                     min((in_a ? a.first : b.first) + i,
                         in_a ? a.last : b.last) * d;
  float acc = 0.f;
  for (int k = lane; k < d; k += 32) {
    float x = src[k];
    if (bf16) x = quant_bf16(x);
    acc = fmaf(x, x, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if (lane == 0) nrm[i] = acc;
}

// both, in one launch: blocks [0, elem_blocks) the elements, the rest the
// norms (256 threads: 8 rows a block); rows of at most 32 features have
// their norms summed by their feature-0 thread instead (no norm blocks)
__global__ void prep_points(PrepJob a, PrepJob b, int d, int dp, int form,
                            int bf16, long long elem_blocks) {
  if ((long long)blockIdx.x < elem_blocks)
    prep_element(a, b, (long long)blockIdx.x * blockDim.x + threadIdx.x, d,
                 dp, form, bf16, dp <= 32);
  else
    prep_norm(a, b,
              ((long long)blockIdx.x - elem_blocks) * (blockDim.x / 32) +
                  threadIdx.x / 32,
              d, bf16);
}

// V (nc x M, row-major) -> V^T (Mp x ncp), zero past nc and M.  f32: the
// TF32 parts hi, lo, with the keys of each group of 8 stored in the order
// 0, 2, 4, 6, 1, 3, 5, 7 (the A fragment's columns); bf16: bf16(V), keys in
// order.  32 x 32 tiles through shared memory, block (32, 8).
__global__ void prep_rhs(const float* __restrict__ V, long long nc,
                         long long M, long long ncp, int bf16, float* vhi,
                         float* vlo, __nv_bfloat16* vb) {
  __shared__ float t[32][33];
  const long long k0 = (long long)blockIdx.x * 32;
  const long long m0 = (long long)blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int i = ty; i < 32; i += 8) {
    const long long key = k0 + i, m = m0 + tx;
    t[i][tx] = (key < nc && m < M) ? V[key * M + m] : 0.f;
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    const long long dst = (m0 + i) * ncp + k0 + tx;
    if (bf16) {
      vb[dst] = __float2bfloat16(t[tx][i]);
    } else {
      const int l = tx & 7;
      const int src = (tx & ~7) | (l < 4 ? 2 * l : 2 * (l - 4) + 1);
      const float v = t[src][i];
      const float hi = tf32(v);
      vhi[dst] = hi;
      vlo[dst] = tf32(__fsub_rn(v, hi));
    }
  }
}

// ---- host side ---------------------------------------------------------------

long long round_up(long long x, long long m) { return (x + m - 1) / m * m; }

struct Form {
  int form, dp, es, nparts;
};

Form form_of(int stat, int bf16, int d) {
  if (stat == STAT_L1) return {FORM_F32, (int)round_up(d, 8), 4, 1};
  if (bf16) return {FORM_BF16, (int)round_up(d, 16), 2, 1};
  return {FORM_SPLIT, (int)round_up(d, 8), 4, 2};
}

long long points_bytes(const Form& f, long long n) {
  // the norms are zero-padded to a multiple of 64 values (256 bytes)
  return round_up(f.nparts * n * f.dp * f.es, 256) + round_up(4 * n, 256);
}

long long rhs_bytes(int bf16, long long nc, long long m) {
  const long long elems = round_up(m, BN) * round_up(nc, BK);
  return bf16 ? round_up(2 * elems, 256) : 2 * round_up(4 * elems, 256);
}

// scratch bytes of a launch (pairwise_workspace_bytes)
long long workspace_bytes(long long nr, long long nc, int d, long long m,
                          int stat, int bf16, bool same) {
  const Form f = form_of(stat, bf16, d);
  long long bytes = points_bytes(f, nr) + (same ? 0 : points_bytes(f, nc));
  if (m > 0) bytes += rhs_bytes(bf16, nc, m);
  return bytes;
}

struct Prepped {
  const char* part[2];
  const float* nrm;
  long long rows;
};

// the job for rows i < count of X[min(first + i, last)], its scratch at ws
PrepJob prep_job(const float* X, long long count, long long first,
                 long long last, const Form& f, char* ws, Prepped* out) {
  const long long part = count * f.dp * f.es;
  char* p0 = ws;
  char* p1 = ws + part;
  float* nrm = reinterpret_cast<float*>(ws + round_up(f.nparts * part, 256));
  *out = Prepped{{p0, f.nparts == 2 ? p1 : p0}, nrm, count};
  return PrepJob{X, count, first, last, reinterpret_cast<float*>(p0),
                 reinterpret_cast<float*>(p1),
                 reinterpret_cast<__nv_bfloat16*>(p0), nrm};
}

// one launch for both point sets (b.count may be 0)
cudaError_t prep(const PrepJob& a, const PrepJob& b, int d, const Form& f,
                 int bf16, cudaStream_t s) {
  const long long elems =
      ((a.count + BK - 1) / BK * BK + (b.count + BK - 1) / BK * BK) * f.dp;
  const long long elem_blocks = (elems / 4 + 255) / 256;   // 4 a thread
  const long long norm_blocks =
      f.dp <= 32 ? 0 : (elems / f.dp + 7) / 8;   // a warp a row
  prep_points<<<(unsigned)(elem_blocks + norm_blocks), 256, 0, s>>>(
      a, b, d, f.dp, f.form, bf16, elem_blocks);
  return cudaGetLastError();
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
constexpr int ERR_SAME = 10011;

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

// the squared norms (n values, zero-padded to a multiple of 64 by
// prep_points) as a 2-d f32 map of rows of 64, one row a box
bool encode_norms(EncodeTiled fn, CUtensorMap* map, const float* ptr,
                  long long n) {
  const cuuint64_t dims[2] = {(cuuint64_t)BK, (cuuint64_t)((n + BK - 1) / BK)};
  const cuuint64_t strides[1] = {(cuuint64_t)(4 * BK)};
  const cuuint32_t box[2] = {(cuuint32_t)BK, 1};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
            const_cast<float*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_NONE,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the point maps of a launch; 0 or an error code
int point_maps(Maps* maps, const Prepped& R, const Prepped& C,
               const Form& f) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return ERR_NO_ENCODER;
  for (int q = 0; q < 2; ++q) {
    if (!encode_2d(fn, &maps->xr[q], R.part[q], f.es, f.dp, R.rows, BR))
      return ERR_ENCODE;
    if (!encode_2d(fn, &maps->xc[q], C.part[q], f.es, f.dp, C.rows, BK))
      return ERR_ENCODE + 1;
  }
  if (!encode_norms(fn, &maps->yy, C.nrm, C.rows)) return ERR_ENCODE + 2;
  maps->v[0] = maps->v[1] = maps->out = maps->xc[0];   // unused or replaced
  return 0;
}

// the most ring stages (2..MAX_STAGES) that fit in `budget` bytes (the
// 1 KB alignment slack included); 0 if not even 2
int stages_for(int np, int nch, int vstage, int budget) {
  int best = 0;
  for (int st = 2; st <= MAX_STAGES; ++st)
    if ((int)layout(np, nch, st, vstage).total + 1024 <= budget) best = st;
  return best;
}

constexpr int SMEM_MAX = 232448;   // dynamic shared memory of a block
constexpr int MAX_DEVICES = 64;

template <int STAT, int BF, int KS>
cudaError_t launch_block(const Maps& maps, float* out, Geo G, int device,
                         cudaStream_t s) {
  using K = Kind<STAT, BF>;
  // two blocks an SM; with TMA stores the V region of the layout holds the
  // two warpgroups' staging buffers
  if (G.tma_store &&
      stages_for(K::NPARTS, G.nch, OUT_STAGE, SMEM_MAX / 2 - 1024) == 0)
    G.tma_store = 0;   // wide rows (d > 32): no room for the staging
  const int ostage = G.tma_store ? OUT_STAGE : 0;
  G.stages = stages_for(K::NPARTS, G.nch, ostage, SMEM_MAX / 2 - 1024);
  if (G.stages == 0) return cudaErrorInvalidValue;
  const int smem = (int)layout(K::NPARTS, G.nch, G.stages, ostage).total + 1024;
  // the attribute, per device, raised only when it must grow
  static int smem_set[MAX_DEVICES] = {};
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (smem > smem_set[device]) {
    cudaError_t err = cudaFuncSetAttribute(
        pairwise_block_tc<STAT, BF, KS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set[device] = smem;
  }
  const long long row_tiles = (G.nr + BR - 1) / BR;
  G.col_tiles = (G.nc + BK - 1) / BK;
  static int sm_count[MAX_DEVICES] = {};
  int& sms = sm_count[device];
  if (sms <= 0 &&
      (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
           cudaSuccess || sms <= 0))
    sms = 132;
  // one wave of two blocks an SM, each on a strip of column tiles
  const long long want = 2LL * sms;
  const long long per = (G.col_tiles * row_tiles + want - 1) / want;
  G.tpb = (int)(per > 1 ? per : 1);
  const long long strips = (G.col_tiles + G.tpb - 1) / G.tpb;
  if (strips > INT_MAX || row_tiles > 65535) return cudaErrorInvalidValue;
  pairwise_block_tc<STAT, BF, KS><<<dim3((unsigned)strips, (unsigned)row_tiles),
                                NTW, smem, s>>>(maps, out, G);
  return cudaGetLastError();
}

template <int STAT, int BF, int KS>
cudaError_t launch_sweep(const Maps& maps, float* out, Geo G, int device,
                         cudaStream_t s) {
  using K = Kind<STAT, BF>;
  const int vstage = BF ? V_BOX : 4 * V_BOX;
  G.stages = stages_for(K::NPARTS, G.nch, vstage, SMEM_MAX);
  if (G.stages == 0) return cudaErrorInvalidValue;
  const int smem = (int)layout(K::NPARTS, G.nch, G.stages, vstage).total + 1024;
  static int smem_set[MAX_DEVICES] = {};
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (smem > smem_set[device]) {
    cudaError_t err = cudaFuncSetAttribute(
        pairwise_matmat_tc<STAT, BF, KS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set[device] = smem;
  }
  const long long row_tiles = (G.nr + BR - 1) / BR;
  const long long chunks = (G.M + BN - 1) / BN;
  if (row_tiles > INT_MAX || chunks > 65535) return cudaErrorInvalidValue;
  pairwise_matmat_tc<STAT, BF, KS><<<dim3((unsigned)row_tiles, (unsigned)chunks),
                                 NTW, smem, s>>>(maps, out, G);
  return cudaGetLastError();
}

// the instantiation for a launch: KS = 2 k steps where a point's padded
// row is at most 64 bytes (one chunk), else 4; l1dist has no k steps.  A
// user variant instantiates its own statistic only and refuses the others.
#if !defined(PAIRWISE_USER_STAT)
#define PAIRWISE_DISPATCH(CALL)                                   \
  switch (stat * 4 + (bf16 ? 2 : 0) + (ks == 2 ? 1 : 0)) {        \
    case 0: err = CALL(STAT_DOT, 0, 4); break;                    \
    case 1: err = CALL(STAT_DOT, 0, 2); break;                    \
    case 2: err = CALL(STAT_DOT, 1, 4); break;                    \
    case 3: err = CALL(STAT_DOT, 1, 2); break;                    \
    case 4: err = CALL(STAT_SQDIST, 0, 4); break;                 \
    case 5: err = CALL(STAT_SQDIST, 0, 2); break;                 \
    case 6: err = CALL(STAT_SQDIST, 1, 4); break;                 \
    case 7: err = CALL(STAT_SQDIST, 1, 2); break;                 \
    case 8: case 9: err = CALL(STAT_L1, 0, 4); break;             \
    default: err = CALL(STAT_L1, 1, 4); break;                    \
  }
#elif PAIRWISE_USER_STAT != 2   // dot or sqdist: the tensor-core kernels
#define PAIRWISE_DISPATCH(CALL)                                   \
  switch ((bf16 ? 2 : 0) + (ks == 2 ? 1 : 0)) {                   \
    case 0: err = CALL(PAIRWISE_USER_STAT, 0, 4); break;          \
    case 1: err = CALL(PAIRWISE_USER_STAT, 0, 2); break;          \
    case 2: err = CALL(PAIRWISE_USER_STAT, 1, 4); break;          \
    default: err = CALL(PAIRWISE_USER_STAT, 1, 2); break;         \
  }
#else   // l1dist
#define PAIRWISE_DISPATCH(CALL)                                   \
  (void)ks;                                                       \
  err = bf16 ? CALL(STAT_L1, 1, 4) : CALL(STAT_L1, 0, 4);
#endif

int k_steps(const Geo& G) { return G.nch == 1 && G.row_bytes <= 64 ? 2 : 4; }

Geo geometry(const Prepped& R, const Prepped& C, const Form& f, long long m,
             int epi, float a, float b, int degree) {
  Geo G{};
  G.xr_nrm = R.nrm;
  for (int q = 0; q < 2; ++q) {
    G.xr_part[q] = reinterpret_cast<const float*>(R.part[q]);
    G.xc_part[q] = reinterpret_cast<const float*>(C.part[q]);
  }
  G.dp = f.dp;
  G.nr = R.rows;
  G.nc = C.rows;
  G.M = m;
  G.row_bytes = f.dp * f.es;
  G.nch = (G.row_bytes + ROWB - 1) / ROWB;
  G.p = Params{epi, a, b, degree};
  return G;
}

// one sweep launch: the prep kernels, then the sweep kernel.  Out rows i <
// count read points min(first + i, last) of xr (n_xr rows).
int sweep(const float* xr, long long count, long long first, long long last,
          bool same, const float* xc, const float* v, float* out,
          long long nc, int d, long long m, int stat, int epi, float a,
          float b, int degree, int bf16, void* ws, long long ws_bytes,
          int device, void* stream) {
  if (count <= 0 || nc <= 0 || d <= 0 || m <= 0 || ws == nullptr ||
      !build_takes(stat, epi))
    return (int)cudaErrorInvalidValue;
  if (ws_bytes < workspace_bytes(count, nc, d, m, stat, bf16, same))
    return ERR_WORKSPACE;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const Form f = form_of(stat, bf16, d);
  char* w = static_cast<char*>(ws);
  Prepped R, C;
  const PrepJob ja = prep_job(xr, count, first, last, f, w, &R);
  w += points_bytes(f, count);
  PrepJob jb{};
  if (same) {
    C = R;
  } else {
    jb = prep_job(xc, nc, 0, nc - 1, f, w, &C);
    w += points_bytes(f, nc);
  }
  err = prep(ja, jb, d, f, bf16, s);
  if (err != cudaSuccess) return (int)err;
  const long long ncp = round_up(nc, BK), mp = round_up(m, BN);
  char* vhi = w;
  char* vlo = w + (bf16 ? 0 : round_up(4 * mp * ncp, 256));
  prep_rhs<<<dim3((unsigned)(ncp / 32), (unsigned)(mp / 32)), dim3(32, 8), 0,
             s>>>(v, nc, m, ncp, bf16, reinterpret_cast<float*>(vhi),
                  reinterpret_cast<float*>(vlo),
                  reinterpret_cast<__nv_bfloat16*>(vhi));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  Maps maps;
  const int code = point_maps(&maps, R, C, f);
  if (code != 0) return code;
  const int ves = bf16 ? 2 : 4;
  if (!encode_2d(encoder(), &maps.v[0], vhi, ves, ncp, mp, BN) ||
      !encode_2d(encoder(), &maps.v[1], vlo, ves, ncp, mp, BN))
    return ERR_ENCODE + 3;
  const Geo G = geometry(R, C, f, m, epi, a, b, degree);
  const int ks = k_steps(G);
#define SWEEP_CALL(S, B, KS) launch_sweep<S, B, KS>(maps, out, G, device, s)
  PAIRWISE_DISPATCH(SWEEP_CALL)
#undef SWEEP_CALL
  return (int)err;
}

}  // namespace

extern "C" {

// scratch bytes a launch needs (the wrapper allocates them): the operand
// form of nr row points and, unless same != 0 (the keys are those rows), of
// nc key points, and for a sweep (m > 0) V^T's parts
long long pairwise_workspace_bytes(long long nr, long long nc, int d,
                                   long long m, int stat, int bf16,
                                   int same) {
  return workspace_bytes(nr, nc, d, m, stat, bf16, same != 0);
}

// the tensor-core passes of a launch: of the statistic's cross term
// (which = 0; 0 for l1dist, which runs on the CUDA cores) or of the sweep's
// contraction (which = 1)
int pairwise_passes(int stat, int bf16, int which) {
  if (which == 0)
    return stat == STAT_L1 ? 0 : bf16 ? 1 : STAT_PASSES;
  return bf16 ? 1 : CONTRACT_PASSES;
}

// the builds of each key tile's statistic in a sweep over M columns of V:
// one for each block's chunk of BN columns
long long pairwise_statistic_builds(long long m) { return (m + BN - 1) / BN; }

// out (nr x nc, row-major) = entry(stat(Xr, Xc)); returns 0 or an error
// code (pairwise_error_string).
int pairwise_block_f32(const float* xr, const float* xc, float* out,
                       long long nr, long long nc, int d, int stat, int epi,
                       float a, float b, int degree, int bf16, void* ws,
                       long long ws_bytes, int device, void* stream) {
  if (nr <= 0 || nc <= 0 || d <= 0 || ws == nullptr ||
      !build_takes(stat, epi))
    return (int)cudaErrorInvalidValue;
  if (ws_bytes < workspace_bytes(nr, nc, d, 0, stat, bf16, false))
    return ERR_WORKSPACE;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const Form f = form_of(stat, bf16, d);
  char* w = static_cast<char*>(ws);
  Prepped R, C;
  const PrepJob ja = prep_job(xr, nr, 0, nr - 1, f, w, &R);
  const PrepJob jb = prep_job(xc, nc, 0, nc - 1, f, w + points_bytes(f, nr),
                              &C);
  err = prep(ja, jb, d, f, bf16, s);
  if (err != cudaSuccess) return (int)err;
  Maps maps;
  const int code = point_maps(&maps, R, C, f);
  if (code != 0) return code;
  Geo G = geometry(R, C, f, 0, epi, a, b, degree);
  // TMA stores need 16-byte row strides (nc % 4 == 0) and room for the
  // staging buffers beside two blocks an SM (d <= 32 under f32); else
  // 8- or 4-byte stores straight from the registers
  G.tma_store = nc % 4 == 0 && ((uintptr_t)out & 15) == 0;
  if (G.tma_store) {
    const cuuint64_t dims[2] = {(cuuint64_t)nc, (cuuint64_t)nr};
    const cuuint64_t strides[1] = {(cuuint64_t)(4 * nc)};
    const cuuint32_t box[2] = {32, 64};
    const cuuint32_t unit[2] = {1, 1};
    if (encoder()(&maps.out, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, out, dims,
                  strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return ERR_ENCODE + 4;
  }
  const int ks = k_steps(G);
#define BLOCK_CALL(S, B, KS) launch_block<S, B, KS>(maps, out, G, device, s)
  PAIRWISE_DISPATCH(BLOCK_CALL)
#undef BLOCK_CALL
  return (int)err;
}

// out (nr x M, row-major) = entry(stat(Xr, Xc)) @ V with V (nc x M,
// row-major); same != 0: the keys are the rows (xc == xr, nc == nr), which
// are then prepped once.  Returns 0 or an error code.
int pairwise_matmat_multi_f32(const float* xr, const float* xc,
                              const float* v, float* out, long long nr,
                              long long nc, int d, long long m, int same,
                              int stat, int epi, float a, float b, int degree,
                              int bf16, void* ws, long long ws_bytes,
                              int device, void* stream) {
  if (nr <= 0) return (int)cudaErrorInvalidValue;
  if (same && (xr != xc || nr != nc)) return ERR_SAME;
  return sweep(xr, nr, 0, nr - 1, same != 0, xc, v, out, nc, d, m, stat, epi,
               a, b, degree, bf16, ws, ws_bytes, device, stream);
}

// out (slab_len x M, row-major): row i = entry(stat(X[min(start_row + i,
// n - 1)], X)) @ V, with X (n x d) and V (n x M) row-major; returns 0 or an
// error code.
int pairwise_matmat_multi_slab_f32(const float* x, const float* v, float* out,
                                   long long n, long long start_row,
                                   long long slab_len, int d, long long m,
                                   int stat, int epi, float a, float b,
                                   int degree, int bf16, void* ws,
                                   long long ws_bytes, int device,
                                   void* stream) {
  if (n <= 0 || start_row < 0 || slab_len <= 0)
    return (int)cudaErrorInvalidValue;
  return sweep(x, slab_len, start_row, n - 1, false, x, v, out, n, d, m, stat,
               epi, a, b, degree, bf16, ws, ws_bytes, device, stream);
}

const char* pairwise_error_string(int code) {
  switch (code) {
    case ERR_NO_ENCODER:
      return "cuTensorMapEncodeTiled is not available (CUDA 12 or newer)";
    case ERR_ENCODE:
      return "cuTensorMapEncodeTiled refused the rows' layout";
    case ERR_ENCODE + 1:
      return "cuTensorMapEncodeTiled refused the keys' layout";
    case ERR_ENCODE + 2:
      return "cuTensorMapEncodeTiled refused the norms' layout";
    case ERR_ENCODE + 3:
      return "cuTensorMapEncodeTiled refused V's layout";
    case ERR_ENCODE + 4:
      return "cuTensorMapEncodeTiled refused the output's layout";
    case ERR_WORKSPACE:
      return "the scratch buffer is smaller than the launch needs";
    case ERR_SAME:
      return "same != 0 but the keys are not the rows";
    default:
      return cudaGetErrorString((cudaError_t)code);
  }
}

}  // extern "C"
