// Online-softmax (flash) attention on Hopper's tensor cores (sm_90a), bf16
// inputs, plain C interface.
//
// Replaces src/repro/kernels/flash_attention/kernel.py:85
// flash_attention_padded / _flash_kernel (the Pallas TPU kernel) for bf16
// q, k, v; f32 inputs keep the CUDA-core kernel of flash.cu (its 1e-5 gate
// rules out bf16 or TF32 operands).  It computes what _flash_kernel computes:
//
//   out[b, h, i] = sum_j p_ij v[b, h/G, j] / max(sum_j p_ij, 1e-30),
//   p_ij = exp(s_ij - max_j s_ij) over the unmasked j,
//   s_ij = (q[b, h, i] . k[b, h/G, j]) * scale,
//
// q (B, Hq, Sq, D), k (B, Hkv, Sk, D), v (B, Hkv, Sk, Dv), G = Hq / Hkv (kv
// head h / G is read in place, never repeated), masks col < Sk; causal:
// col <= row + offs; window w: (row + offs) - col < w; offs = Sk - Sq
// right-aligns the queries to the keys (decode, chunked prefill).  The
// running state per row is the reference's: m from -inf, m_safe =
// isfinite(m_new) ? m_new : 0, alpha = isfinite(m_prev) ? exp(m_prev -
// m_safe) : 0, so a row that has seen only masked keys keeps l = 0 and
// acc = 0; the output is acc / max(l, 1e-30) rounded to bf16 (RNE) in q's
// strided layout.
//
// Precision contract.  S = Q K^T runs as bf16 x bf16 -> f32 on wgmma: the
// products of bf16 values are exact in f32, as in the reference's widened
// dot_general (only the order of the f32 sums differs).  The logits are
// prescaled by scale * log2(e) and exponentiated with exp2f (2 ulp; no
// fast-math flag), the softmax state (m, l, alpha) stays f32, and l sums the
// f32 p.  For O += P V, P is rounded to bf16 (RNE) -- the reference keeps f32
// p -- and accumulated in f32.  That moves an output by at most 2^-9 of
// sum_j p_ij |v_j| / l and on average far less; the bf16 gates (rtol = atol
// = 2e-2 elementwise, 1e-2 per-row relative at the served shapes) hold it
// with room (tests/test_torch_flash.py emulates this arithmetic on the CPU).
//
// What bounds it.  Per (b, h) the causal half of 2 Sq Sk (D + Dv) flops
// against one read of q, k, v and one write of out: at gemma3-12b's global
// layer (B = 2, Hq = 16, Hkv = 8, S = 32,768, D = Dv = 256) 1.76e13 flops
// against 1.1 GB, bound by operations: >= 17.79 ms on the bf16 tensor cores
// of an H100 SXM (989 TFLOP/s); the local layer (window 1,024) >= 1.09 ms.
//
// Design (FlashAttention-3's shape, kept simple).  One block per (128 query
// rows, query head, batch row), 384 threads: warpgroups 0 and 1 are
// consumers of 64 query rows each, warpgroup 2 the producer.  setmaxnreg
// moves registers to the consumers (240 each; the producer keeps 24): at
// head width 256 the O accumulator alone is 64 x 256 f32, 128 registers a
// thread.  Tensors are addressed through TMA tensor maps built on the host
// from the wrapper's strides (4-d: features, rows, heads, batch), boxes of
// 64 features x 64 rows with the 128-byte swizzle; a head width HD in
// {64, 128, 256} >= max(D, Dv) is four, two or one such boxes, and TMA's
// zero fill past D, Dv, Sq and Sk makes any D, Dv <= 256 and any length
// exact (nothing is padded in memory).
//   - producer: one thread loads the block's Q tile once (it stays in shared
//     memory), then streams K and V tiles of BK = 64 keys through a ring of
//     STAGES stages with full (K, V) and empty mbarriers;
//   - consumer, per key tile: S = Q K^T with HD/16 wgmma m64n64k16 (both
//     operands in shared memory, K-major); the online softmax in registers
//     on the accumulator layout (a row lives in 4 lanes: two shuffles for
//     the max; l is kept per lane and summed once at the end); masks per
//     element from 64-bit positions, only on tiles that cross the diagonal,
//     the window's edge or Sk; O rescaled by alpha in registers; P rounded
//     to bf16 and packed into wgmma's A fragments -- the f32 accumulator of
//     two n8 blocks is, lane for lane, the A fragment of one k16 step, so the
//     re-layout is a pack, no shuffle -- and O += P V with wgmma m64n64k16
//     taking A from registers and V (keys x Dv, Dv contiguous) as the
//     transposed (MN-major) B operand;
//   - epilogue: O / max(l, 1e-30) in bf16 straight from registers to q's
//     layout, rows past Sq and columns past Dv masked.
// Key tiles wholly above the causal diagonal or behind the window are not
// loaded; inside the block's range a warpgroup skips the tiles its own rows
// cannot see (the reference leaves m, l, acc unchanged there).  Query tiles
// run longest-first, the heads of one tile side by side (GQA pairs share K
// and V in L2).  Positions and strides are 64-bit.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WG = 128;                 // threads per warpgroup
constexpr int NCONS = 2;                // consumer warpgroups
constexpr int BQ = 64 * NCONS;          // query rows per block
constexpr int BK = 64;                  // keys per tile
constexpr int NT = WG * (NCONS + 1);    // + the producer warpgroup
constexpr int BOX = 64;                 // TMA box: 64 features x 64 rows
constexpr int BOX_BYTES = BOX * BOX * 2;
constexpr int CONSUMER_REGS = 240;
constexpr int PRODUCER_REGS = 24;

template <int HD>
struct Cfg {
  static constexpr int NC = HD / BOX;   // 64-feature chunks of a row
  static constexpr int STAGES = HD == 256 ? 2 : 4;
  static constexpr int Q_BYTES = NCONS * NC * BOX_BYTES;
  static constexpr int TILE_BYTES = NC * BOX_BYTES;   // one K or V tile
  static constexpr int BAR_BYTES = 8 * (1 + 3 * STAGES);
  // + 1 KB to align the base to the 128-byte swizzle's 1,024-byte period
  static constexpr int SMEM =
      Q_BYTES + 2 * STAGES * TILE_BYTES + BAR_BYTES + 1024;
};

// ---- PTX wrappers ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

// wait until the phase of the given parity has completed.  (No watchdog:
// a clock64 / __trap bound in this loop makes ptxas keep the consumers at
// the launch's 168 registers, spill the O accumulator and serialize wgmma.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptors, 128-byte swizzle.  The high word
// (stride byte offset 1 KB: 8 rows of 128 bytes; layout type 1) is the same
// for every operand here; the low word holds the start address and the
// leading byte offset, both in 16-byte units.
constexpr uint32_t DESC_HI = (1024u >> 4) | (1u << 30);
// K-major operand (Q, K: 64-feature rows of 128 bytes): the swizzled K-major
// layout does not use the leading offset (1); a k16 step adds 32 bytes
__device__ __forceinline__ uint32_t kmajor_lo(uint32_t addr) {
  return ((addr & 0x3FFFFu) >> 4) | (1u << 16);
}
// MN-major operand (V: one 64-column chunk of Dv per key row): n = 64 is
// one swizzle width, so only the 8-key stride is used, and both offsets
// carry it (1 KB); a k16 step adds 16 rows, 2 KB
__device__ __forceinline__ uint32_t mnmajor_lo(uint32_t addr) {
  return ((addr & 0x3FFFFu) >> 4) | (64u << 16);
}
__device__ __forceinline__ uint64_t desc(uint32_t lo) {
  return ((uint64_t)DESC_HI << 32) | lo;
}
// a value the compiler may not treat as loop-invariant: the descriptors
// derived from it are recomputed per tile (integer adds) instead of hoisted
// out of the loop into dozens of live 64-bit registers
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

// keep the compiler from moving reads or writes of wgmma's registers across
// the asynchronous instruction's issue and wait
__device__ __forceinline__ void reg_fence(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void reg_fence(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

#define WGMMA_D32                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31}"
#define WGMMA_D32_OPERANDS                                                \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])
#define WGMMA_D32_OUTPUTS                                                 \
  "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), \
      "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]),         \
      "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),     \
      "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]),     \
      "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]),     \
      "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]),     \
      "=f"(d[31])

// d (64 x 64 f32) += A (64 x 16, K-major in shared memory) * B (16 x 64,
// K-major in shared memory)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : WGMMA_D32_OPERANDS
      : "l"(da), "l"(db), "n"(1));
}

// d = A * B as above, d's old value unread (write-only operands, so d is
// not live before the first k16 step)
__device__ __forceinline__ void wgmma_ss_first(float (&d)[32], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : WGMMA_D32_OUTPUTS
      : "l"(da), "l"(db), "n"(0));
}

// d (64 x 64 f32) += A (64 x 16 bf16 from registers) * B (16 x 64,
// MN-major in shared memory)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : WGMMA_D32_OPERANDS
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo: low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- the kernel -----------------------------------------------------------

struct OutStrides {   // element strides of out's batch, head and row axes
  long long b, h, s;
};

template <int HD>
__global__ void __launch_bounds__(NT, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ O, OutStrides so, int Hq,
                   int group, int Sq, int Sk, int Dv, float scale_log2,
                   int causal, int window) {
  using C = Cfg<HD>;
  constexpr int NC = C::NC, ST = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;                       // [warpgroup][chunk] boxes
  const uint32_t sK = sQ + C::Q_BYTES;            // [stage][chunk] boxes
  const uint32_t sV = sK + ST * C::TILE_BYTES;    // [stage][chunk] boxes
  const uint32_t sBar = sV + ST * C::TILE_BYTES;  // Q, K[ST], V[ST], empty[ST]
  const uint32_t bar_q = sBar;
  const uint32_t bar_k = sBar + 8;
  const uint32_t bar_v = bar_k + 8 * ST;
  const uint32_t bar_e = bar_v + 8 * ST;

  const int tid = threadIdx.x;
  const int h = (int)(blockIdx.x % (unsigned)Hq);
  const int b = (int)(blockIdx.x / (unsigned)Hq);
  const int hk = h / group;
  const int qt = (int)gridDim.y - 1 - (int)blockIdx.y;   // longest first
  const long long offs = (long long)Sk - Sq;
  const long long r0 = (long long)qt * BQ;

  // the key tiles the block's rows can see: [kbeg, kbeg + ntiles * BK)
  const long long rlast = min(r0 + BQ, (long long)Sq) - 1;
  const long long kend =
      causal ? min((long long)Sk, rlast + offs + 1) : (long long)Sk;
  long long kbeg = window > 0 ? max(0LL, r0 + offs - window + 1) : 0LL;
  kbeg -= kbeg % BK;
  const int ntiles = kend > kbeg ? (int)((kend - kbeg + BK - 1) / BK) : 0;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_e + 8 * s, NCONS * 4);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid / WG == NCONS) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (tid == NCONS * WG) {
      mbar_expect_tx(bar_q, C::Q_BYTES);
#pragma unroll
      for (int g = 0; g < NCONS; ++g)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tma_load(sQ + (g * NC + c) * BOX_BYTES, &tq, bar_q, c * BOX,
                   (int)(r0 + 64 * g), h, b);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % ST;
        const uint32_t ph = (uint32_t)(t / ST) & 1u;
        const int j0 = (int)(kbeg + (long long)t * BK);
        mbar_wait(bar_e + 8 * s, ph ^ 1u);
        mbar_expect_tx(bar_k + 8 * s, C::TILE_BYTES);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tma_load(sK + s * C::TILE_BYTES + c * BOX_BYTES, &tk, bar_k + 8 * s,
                   c * BOX, j0, hk, b);
        mbar_expect_tx(bar_v + 8 * s, C::TILE_BYTES);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tma_load(sV + s * C::TILE_BYTES + c * BOX_BYTES, &tv, bar_v + 8 * s,
                   c * BOX, j0, hk, b);
      }
    }
  } else {
    // ---- consumers: warpgroup g owns query rows r0 + 64 g .. + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    const int g = tid / WG;
    const int warp = (tid % WG) / 32, lane = tid % 32;
    const long long rw0 = r0 + 64 * g;
    const bool has_rows = rw0 < Sq;
    const long long rwl = min(rw0 + 63, (long long)Sq - 1);
    // keys this warpgroup's rows can see: [wbeg, wend)
    const long long wend =
        causal ? min((long long)Sk, rwl + offs + 1) : (long long)Sk;
    const long long wbeg =
        window > 0 ? max(0LL, rw0 + offs - window + 1) : 0LL;
    // this lane's two rows (accumulator layout: warp w holds rows 16 w ..,
    // lane l rows l / 4 and l / 4 + 8, columns 2 (l % 4) + {0, 1} of each
    // n8 block)
    const long long row0 = rw0 + 16 * warp + lane / 4;
    const int col_l = 2 * (lane & 3);

    float o[NC][32];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
    float s[32];
    uint32_t pa[4][4];
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

    const uint32_t q_lo0 = kmajor_lo(sQ + g * NC * BOX_BYTES);
    const uint32_t k_lo0 = kmajor_lo(sK), v_lo0 = mnmajor_lo(sV);
    constexpr uint32_t CHUNK = BOX_BYTES >> 4, TILE = C::TILE_BYTES >> 4;

    mbar_wait(bar_q, 0);
    for (int t = 0; t < ntiles; ++t) {
      const int st = t % ST;
      const uint32_t ph = (uint32_t)(t / ST) & 1u;
      const long long j0 = kbeg + (long long)t * BK;
      const bool skip = !has_rows || j0 >= wend || j0 + BK <= wbeg;
      mbar_wait(bar_k + 8 * st, ph);
      if (!skip) {
        // S = Q K^T: HD / 16 k16 steps (desc start addresses in 16 B units)
        const uint32_t q_lo = opaque(q_lo0);
        const uint32_t k_lo = opaque(k_lo0) + st * TILE;
        wgmma_fence();
        wgmma_ss_first(s, desc(q_lo), desc(k_lo));
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            if (c | kk)
              wgmma_ss(s, desc(q_lo + c * CHUNK + 2 * kk),
                       desc(k_lo + c * CHUNK + 2 * kk));
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(s);

        const bool edge = j0 + BK > Sk ||
                          (causal && j0 + BK - 1 > rw0 + offs) ||
                          (window > 0 && j0 < rwl + offs - window + 1);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * j + 2 * hh + e;
              float x = s[i] * scale_log2;
              if (edge) {
                const long long pos = row0 + 8 * hh + offs;
                const long long col = j0 + 8 * j + col_l + e;
                bool ok = col < Sk;
                if (causal) ok = ok && col <= pos;
                if (window > 0) ok = ok && pos - col < window;
                x = ok ? x : -INFINITY;
              }
              s[i] = x;
              mx = fmaxf(mx, x);
            }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m_run[hh], mx);
          const float m_safe = isfinite(m_new) ? m_new : 0.f;
          const float alpha =
              isfinite(m_run[hh]) ? exp2f(m_run[hh] - m_safe) : 0.f;
          float part = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * j + 2 * hh + e;
              const float p = exp2f(s[i] - m_safe);   // masked: exp2(-inf) = 0
              s[i] = p;
              part += p;
            }
          l_run[hh] = alpha * l_run[hh] + part;
          m_run[hh] = m_new;
#pragma unroll
          for (int c = 0; c < NC; ++c)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              o[c][4 * j + 2 * hh] *= alpha;
              o[c][4 * j + 2 * hh + 1] *= alpha;
            }
        }
        // P in bf16 as the A fragments of the four k16 steps: step kb is
        // the accumulator's n8 blocks 2 kb and 2 kb + 1
#pragma unroll
        for (int kb = 0; kb < 4; ++kb) {
          pa[kb][0] = pack_bf16(s[8 * kb + 0], s[8 * kb + 1]);
          pa[kb][1] = pack_bf16(s[8 * kb + 2], s[8 * kb + 3]);
          pa[kb][2] = pack_bf16(s[8 * kb + 4], s[8 * kb + 5]);
          pa[kb][3] = pack_bf16(s[8 * kb + 6], s[8 * kb + 7]);
        }
      }
      mbar_wait(bar_v + 8 * st, ph);
      if (!skip) {
        // O += P V: 16-key steps (2 KB of V rows each) x 64-column chunks
#pragma unroll
        for (int c = 0; c < NC; ++c) reg_fence(o[c]);
#pragma unroll
        for (int kb = 0; kb < 4; ++kb) reg_fence(pa[kb]);
        const uint32_t v_lo = opaque(v_lo0) + st * TILE;
        wgmma_fence();
#pragma unroll
        for (int kb = 0; kb < 4; ++kb)
#pragma unroll
          for (int c = 0; c < NC; ++c)
            wgmma_rs(o[c], pa[kb], desc(v_lo + c * CHUNK + 128 * kb));
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int c = 0; c < NC; ++c) reg_fence(o[c]);
#pragma unroll
        for (int kb = 0; kb < 4; ++kb) reg_fence(pa[kb]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_e + 8 * st);
    }

    // epilogue: O / max(l, 1e-30) in bf16
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float l = l_run[hh];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float den = fmaxf(l, 1e-30f);
      const long long row = row0 + 8 * hh;
      if (row >= Sq) continue;
      __nv_bfloat16* orow = O + b * so.b + h * so.h + row * so.s;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = BOX * c + 8 * j + col_l + e;
            if (col < Dv)
              orow[col] = __float2bfloat16_rn(o[c][4 * j + 2 * hh + e] / den);
          }
    }
  }
}

// ---- host side --------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// codes past cudaError_t's range
constexpr int ERR_NO_ENCODER = 10001;
constexpr int ERR_ENCODE_Q = 10002;   // + 1 for k, + 2 for v

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

// a 4-d bf16 map (features, rows, heads, batch) with 64 x 64 boxes, 128-byte
// swizzle, zero fill out of bounds; st = element strides of the batch, head
// and row axes (multiples of 8, checked by the wrapper)
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int feat,
            int rows, int heads, int batch, const long long* st) {
  const cuuint64_t dims[4] = {(cuuint64_t)feat, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {BOX, BOX, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, void* out, const long long* st,
                   int B, int Hq, int Hkv, int Sq, int Sk, int Dv,
                   float scale_log2, int causal, int window, cudaStream_t s) {
  const int smem = Cfg<HD>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)B * (unsigned)Hq, (unsigned)((Sq + BQ - 1) / BQ));
  flash_wgmma_kernel<HD><<<grid, NT, smem, s>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out),
      OutStrides{st[9], st[10], st[11]}, Hq, Hq / Hkv, Sq, Sk, Dv, scale_log2,
      causal, window);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out (B, Hq, Sq, Dv) bf16 = flash attention of bf16 q (B, Hq, Sq, D) over
// k (B, Hkv, Sk, D) and v (B, Hkv, Sk, Dv), each addressed by the element
// strides of its batch, head and row axes (strides[0..2] q, [3..5] k,
// [6..8] v, [9..11] out; the feature axis is contiguous).  q, k and v need
// 16-byte aligned bases and strides (TMA); the wrapper checks that.
// window <= 0: no window; scale = 1/sqrt(D).  Returns 0 or an error code
// (flash_tc_error_string).
int flash_attention_tc(const void* q, const void* k, const void* v,
                       void* out, const long long* strides, int B, int Hq,
                       int Hkv, int Sq, int Sk, int D, int Dv, int causal,
                       int window, float scale, int device, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Sq <= 0 || Sk <= 0 || D <= 0 ||
      Dv <= 0 || D > 256 || Dv > 256 || Hq % Hkv != 0 ||
      (Sq + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  EncodeTiled fn = encoder();
  if (fn == nullptr) return ERR_NO_ENCODER;
  CUtensorMap tq, tk, tv;
  if (!encode(fn, &tq, q, D, Sq, Hq, B, strides)) return ERR_ENCODE_Q;
  if (!encode(fn, &tk, k, D, Sk, Hkv, B, strides + 3)) return ERR_ENCODE_Q + 1;
  if (!encode(fn, &tv, v, Dv, Sk, Hkv, B, strides + 6)) return ERR_ENCODE_Q + 2;
  const float scale_log2 = scale * 1.4426950408889634f;
  const int hd = D > Dv ? D : Dv;
  cudaStream_t s = (cudaStream_t)stream;
  if (hd <= 64)
    err = launch<64>(tq, tk, tv, out, strides, B, Hq, Hkv, Sq, Sk, Dv,
                     scale_log2, causal, window, s);
  else if (hd <= 128)
    err = launch<128>(tq, tk, tv, out, strides, B, Hq, Hkv, Sq, Sk, Dv,
                      scale_log2, causal, window, s);
  else
    err = launch<256>(tq, tk, tv, out, strides, B, Hq, Hkv, Sq, Sk, Dv,
                      scale_log2, causal, window, s);
  return (int)err;
}

const char* flash_tc_error_string(int code) {
  switch (code) {
    case ERR_NO_ENCODER:
      return "cuTensorMapEncodeTiled is not available (CUDA 12 or newer)";
    case ERR_ENCODE_Q:
      return "cuTensorMapEncodeTiled refused q's layout";
    case ERR_ENCODE_Q + 1:
      return "cuTensorMapEncodeTiled refused k's layout";
    case ERR_ENCODE_Q + 2:
      return "cuTensorMapEncodeTiled refused v's layout";
    default:
      return cudaGetErrorString((cudaError_t)code);
  }
}

}  // extern "C"
