// Flash attention (forward): causal or full online-softmax attention, GQA.
//
// Replaces the Pallas TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention.py (`_flash_kernel`).  q [B, S, H, D],
// k/v [B, T, KV, D], out [B, S, H, D], all float32 or all bfloat16, in the
// model's layout (no transposes).  It computes what the TPU kernel does:
// scores, the running max, denominator and accumulator in float32
// (flash_attention.py:27-58), masked entries -1e30, and out = acc /
// max(ell, 1e-30) cast to the input type.
//
// Differences of layout, not of math:
//   * GQA: q head h reads kv head h / (H / KV) inside the kernel; the TPU
//     wrapper folds the group axis into the q rows instead (:75-78).
//   * Any S and T: rows past S are not stored and keys past T are masked.
//     The causal mask is start-aligned (k_pos > q_pos masked), as in the
//     TPU kernel; the wrapper only takes causal with S == T.
//   * Causal key tiles wholly past a query tile's last row are skipped;
//     the TPU kernel visits them with every entry masked, which leaves
//     (m, ell, acc) unchanged, so skipping them is exact.
//
// Added here, not in the TPU kernel: a sliding window (`window` > 0, with
// causal only; 0 means none).  A key with q_pos - k_pos >= window is
// masked, as the JAX model's jnp mask `i - j < sliding_window` does
// (src/repro/models/attention.py:77-80; the Pallas kernel has no window,
// JAX computes windowed attention in jnp).  Key tiles wholly before a
// query tile's first row's window are skipped, so a windowed prefill reads
// O(S * window) keys, not O(S^2).  A row's first visited tiles may hold only
// masked keys for it (running max -1e30); the tile holding its own key
// comes later and rescales what they added by exp(-1e30 - m) = 0, so the
// skip and the mask together are exact.
//
// What bounds it on the H100: at the prefill shapes (S = 512-2048, D = 64)
// the two products, 4*S*T*D flops a head (half of them for causal), over
// the bytes of q, k, v and out: operations, on the tensor cores in
// bfloat16 (989 TFLOP/s).  At D = 64 the softmax's exponentials (S*T a
// head, 16 a clock on an SM's special-function units) cost about as many
// cycles as the products, so a block's softmax has to overlap another
// block's products.
//
// bfloat16: FlashAttention-2's structure on Hopper's instructions.  A block
// is one warpgroup (128 threads) and owns 64 query rows of one (batch,
// head).  TMA copies the q tile once and 64-key K/V tiles into a two-stage
// ring in shared memory, as bfloat16 with the 128-byte swizzle (a 64-column
// panel per 128 bytes of a row; D = 128 has two panels), and an mbarrier
// per stage reports each tile's arrival, so the next tile lands while the
// current one is multiplied; rows and keys past S and T arrive as zeros.
// S = q k^T is wgmma m64n64k16 (bf16 in, f32 accumulators in registers,
// both operands K-major in shared memory).  The online softmax runs on the
// accumulators in registers: the scale is applied to the f32 scores (in
// exp2 form, log2(e) folded in; q is not scaled in bf16), each row's max
// reduces over the 4 threads of a quad with shuffles, and each thread keeps
// a partial row sum until the end.  P is rounded to bf16 in registers and is
// wgmma's A operand for O += P V (m64nDk16, V MN-major through the
// descriptor's transpose), O in f32 registers.  Key tiles past a causal
// query tile are skipped, masks are computed only on tiles that cross the
// diagonal or T, and the longest causal query tiles launch first.  Enough
// blocks share an SM (41 KB of shared memory each at D = 64) for one
// block's softmax to overlap another's wgmma.
//
// Where the caller passes `lse` (autograd records the call), both routes
// also write each row's natural log-sum-exp, m scale + log(ell), float32
// [B, H, S], so the backward (csrc/flash_attention_bwd.cu) needs no walk
// over the keys to recompute it; the serving path passes none.
//
// float32 keeps the SIMT kernel: TF32 or bf16 tensor cores cannot meet the
// float32 tolerance of tests/test_kernels.py (2e-5).  One block of 256
// threads per (64-row query tile, head, batch) streams 64-key K/V tiles
// through shared memory; thread (ty, tx) of a 16 x 16 grid owns query rows
// 4*ty..4*ty+3, score columns tx + 16j and output columns tx + 16c, so the
// row statistics reduce over one half-warp with shuffles.  q is scaled
// first, as flash_attention.py:27 does.
#include <cuda.h>

#include "common.cuh"

namespace {

using repro_torch::allow_smem_once;

// ---------------------------------------------------------- bfloat16 ------
constexpr int kWgThreads = 128;  // one warpgroup
constexpr int kRows = 64;        // query rows a block, keys a tile
constexpr int kPanelBytes = kRows * 64 * 2;  // 64 bf16 columns of 64 rows
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct WgTiles {
  static constexpr int kPanels = D / 64;
  static constexpr int kTile = kPanelBytes * kPanels;  // one q, k or v tile
  static constexpr int kStages = 2;
  // [q][k0][v0][k1][v1] then the mbarriers (q, stage 0, stage 1); +1024
  // to align the base for the swizzle.
  static constexpr int kBarOffset = kTile * (1 + 2 * kStages);
  static constexpr int kSmem = kBarOffset + 8 * (1 + kStages) + 1024;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Waits for the phase of `parity` to complete; traps (a launch error, not a
// hang) if a copy never lands.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 24)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One 64 x 64 box of a [B, rows, heads, D] bf16 tensor into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head),
      "r"(row), "r"(batch)
      : "memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled operand: rows of
// 128 bytes, 8-row groups 1024 bytes apart (SBO); LBO is the distance of
// the next 64-column panel for an MN-major operand (unused K-major).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
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

// Keeps the compiler from moving register reads or writes of an
// accumulator across the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]: A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] B[16 x 64]: A in registers (bf16 pairs), B
// MN-major in shared memory (the transpose flag of 16-bit types).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128]: A in registers (bf16 pairs), B
// MN-major in shared memory (the transpose flag of 16-bit types).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float fast_exp2(float x) {  // 2^x, -inf -> 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Thread layout of a wgmma accumulator (and of its bf16 A fragments):
// warp w of the warpgroup holds rows 16w + g and 16w + g + 8 (g = lane / 4);
// register 4j + e holds column 8j + 2 (lane % 4) + (e & 1) of the first
// row (e < 2) or the second (e >= 2).
template <int D>
__global__ void __launch_bounds__(kWgThreads)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, int S, int Tk, int H, int KV,
                       int causal, int window, float scale_log2) {
  using L = WgTiles<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base, bar_q = base + L::kBarOffset;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * kRows, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int kv_end = causal ? min(Tk, q0 + kRows) : Tk;
  const int j0 = window ? max(0, q0 - window + 1) / kRows : 0;
  const int n_tiles = (kv_end + kRows - 1) / kRows - j0;  // tiles visited

  auto stage_k = [&](int s) { return base + L::kTile * (1 + 2 * s); };
  auto stage_v = [&](int s) { return base + L::kTile * (2 + 2 * s); };
  auto stage_bar = [&](int s) { return bar_q + 8 * (1 + s); };
  auto load_kv = [&](int j, int s) {  // key tile j0 + j into stage s
    mbar_expect_tx(stage_bar(s), 2 * L::kTile);
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p) {
      tma_load(stage_k(s) + p * kPanelBytes, &tk, stage_bar(s), 64 * p, kvh,
               (j0 + j) * kRows, b);
      tma_load(stage_v(s) + p * kPanelBytes, &tv, stage_bar(s), 64 * p, kvh,
               (j0 + j) * kRows, b);
    }
  };

  if (tid == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int s = 0; s < L::kStages; ++s) mbar_init(stage_bar(s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, L::kTile);
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p)
      tma_load(sq + p * kPanelBytes, &tq, bar_q, 64 * p, h, q0, b);
    for (int s = 0; s < L::kStages && s < n_tiles; ++s) load_kv(s, s);
  }

  const int row0 = q0 + 16 * warp + (lane >> 2), row1 = row0 + 8;
  const int cq = 2 * (lane & 3);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
  float sc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
  mbar_wait(bar_q, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % L::kStages;
    mbar_wait(stage_bar(s), (j / L::kStages) & 1);

    // S = q k^T over D / 16 steps of 16 (32 bytes of each 128-byte row).
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kPanelBytes + (kk % 4) * 32;
      wgmma_ss_n64(sc, sw128_desc(sq + off, 16),
                   sw128_desc(stage_k(s) + off, 16), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    const int k0 = (j0 + j) * kRows;
    if (k0 + kRows > Tk || (causal && k0 + kRows - 1 > q0) ||
        (window && q0 + kRows - 1 - k0 >= window)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = k0 + 8 * (i >> 2) + cq + (i & 1);
        const int row = (i & 2) ? row1 : row0;
        if (key >= Tk || (causal && key > row) ||
            (window && row - key >= window))
          sc[i] = -1e30f;
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      mx0 = fmaxf(mx0, fmaxf(sc[i], sc[i + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[i + 2], sc[i + 3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float alpha0 = fast_exp2((m0 - mn0) * scale_log2);
    const float alpha1 = fast_exp2((m1 - mn1) * scale_log2);
    m0 = mn0;
    m1 = mn1;
    // A row with every key so far masked (max -1e30; only a window's first
    // tile does this) takes p = exp2(-1e30 scale) = 0: the fused form's
    // -1e30 s + round(1e30 s) would leave the rounding error, ~1e22.
    const float b0 = mn0 <= -1e30f ? 0.0f : -mn0 * scale_log2;
    const float b1 = mn1 <= -1e30f ? 0.0f : -mn1 * scale_log2;
    float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      sc[i] = fast_exp2(fmaf(sc[i], scale_log2, b0));
      sc[i + 1] = fast_exp2(fmaf(sc[i + 1], scale_log2, b0));
      sc[i + 2] = fast_exp2(fmaf(sc[i + 2], scale_log2, b1));
      sc[i + 3] = fast_exp2(fmaf(sc[i + 3], scale_log2, b1));
      rs0 += sc[i] + sc[i + 1];
      rs1 += sc[i + 2] + sc[i + 3];
    }
    l0 = alpha0 * l0 + rs0;  // this thread's share of the row sum
    l1 = alpha1 * l1 + rs1;
    uint32_t pa[4][4];  // P in bf16: the A fragments of 4 key steps of 16
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }

    // O = alpha O + P V over 4 key steps of 16 (2048 bytes of V each).
#pragma unroll
    for (int i = 0; i < D / 2; i += 4) {
      o[i] *= alpha0;
      o[i + 1] *= alpha0;
      o[i + 2] *= alpha1;
      o[i + 3] *= alpha1;
    }
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = sw128_desc(stage_v(s) + kk * 16 * 128, kPanelBytes);
      if constexpr (D == 64)
        wgmma_rs_n64(o, pa[kk], dv);
      else
        wgmma_rs_n128(o, pa[kk], dv);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);

    __syncthreads();  // every warp is done with stage s
    if (tid == 0 && j + L::kStages < n_tiles) load_kv(j + L::kStages, s);
  }

  const float den0 = fmaxf(quad_sum(l0), 1e-30f);
  const float den1 = fmaxf(quad_sum(l1), 1e-30f);
  if (lse != nullptr && (lane & 3) == 0) {  // natural log-sum-exp of a row
    const long long stat = ((long long)b * H + h) * S;
    if (row0 < S)
      lse[stat + row0] = (m0 * scale_log2 + log2f(den0)) / kLog2e;
    if (row1 < S)
      lse[stat + row1] = (m1 * scale_log2 + log2f(den1)) / kLog2e;
  }
  const long long rstride = (long long)H * D;
  __nv_bfloat16* ob = out + ((long long)b * S * H + h) * D + cq;
#pragma unroll
  for (int i = 0; i < D / 2; i += 4) {
    const int col = 2 * i;  // 8 (i / 4)
    if (row0 < S)
      *reinterpret_cast<uint32_t*>(ob + row0 * rstride + col) =
          pack_bf16(o[i] / den0, o[i + 1] / den0);
    if (row1 < S)
      *reinterpret_cast<uint32_t*>(ob + row1 * rstride + col) =
          pack_bf16(o[i + 2] / den1, o[i + 3] / den1);
  }
}

// A [B, rows, heads, D] bf16 tensor as a TMA map of 64 x 64 boxes (64
// columns of D by 64 rows), 128-byte swizzled, zeros past its edges.
bool encode_map(CUtensorMap* map, const void* ptr, int batch, int rows,
                int heads, int D) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)rows * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, kRows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(
             map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_bf16_d(const __nv_bfloat16* q, const __nv_bfloat16* k,
                  const __nv_bfloat16* v, __nv_bfloat16* out, float* lse,
                  int B, int S, int Tk, int H, int KV, int causal, int window,
                  float scale, cudaStream_t stream) {
  static unsigned smem_set = 0;
  const size_t smem = WgTiles<D>::kSmem;
  cudaError_t err =
      allow_smem_once(flash_fwd_wgmma_kernel<D>, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap tq, tk, tv;
  if (!encode_map(&tq, q, B, S, H, D) || !encode_map(&tk, k, B, Tk, KV, D) ||
      !encode_map(&tv, v, B, Tk, KV, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  flash_fwd_wgmma_kernel<D><<<grid, kWgThreads, smem, stream>>>(
      tq, tk, tv, out, lse, S, Tk, H, KV, causal, window, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                const __nv_bfloat16* v, __nv_bfloat16* out, float* lse, int B,
                int S, int Tk, int H, int KV, int D, int causal, int window,
                float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) %
      16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (Tk == 0)  // no keys: acc = ell = 0, so out = 0
    return static_cast<int>(cudaMemsetAsync(
        out, 0, sizeof(__nv_bfloat16) * B * S * H * D, st));
  if (D == 64)
    return launch_bf16_d<64>(q, k, v, out, lse, B, S, Tk, H, KV, causal,
                             window, scale, st);
  if (D == 128)
    return launch_bf16_d<128>(q, k, v, out, lse, B, S, Tk, H, KV, causal,
                              window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ----------------------------------------------------------- float32 ------

constexpr int kBr = 64;        // query rows per block
constexpr int kBc = 64;        // keys per tile
constexpr int kThreads = 256;  // a 16 x 16 grid

template <int D>
constexpr size_t smem_floats() {
  return (size_t)kBr * (D + 1) + (size_t)kBc * (D + 1) + (size_t)kBc * D +
         (size_t)kBr * (kBc + 1);
}

__device__ __forceinline__ float half_warp_max(float v) {
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      float* __restrict__ lse, int S, int Tk, int H, int KV,
                      int causal, int window, float scale) {
  constexpr int DP = D + 1;      // padded rows: conflict-free column reads
  constexpr int PP = kBc + 1;
  constexpr int NC = D / 16;     // output columns a thread owns
  extern __shared__ float smem[];
  float* qs = smem;              // [kBr][DP]
  float* ks = qs + kBr * DP;     // [kBc][DP]
  float* vs = ks + kBc * DP;     // [kBc][D]
  float* ps = vs + kBc * D;      // [kBr][PP]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBr, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const long long qstride = (long long)H * D, kvstride = (long long)KV * D;
  const float* qb = q + (long long)b * S * qstride + (long long)h * D;
  const float* kb = k + (long long)b * Tk * kvstride + (long long)kvh * D;
  const float* vb = v + (long long)b * Tk * kvstride + (long long)kvh * D;
  float* ob = out + (long long)b * S * qstride + (long long)h * D;

  for (int i = tid; i < kBr * D; i += kThreads) {
    const int r = i / D, c = i % D, s = q0 + r;
    qs[r * DP + c] =
        s < S ? qb[(long long)s * qstride + c] * scale : 0.0f;
  }

  float m[4], ell[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    ell[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  const int kv_end = causal ? min(Tk, q0 + kBr) : Tk;
  const int kv_begin = window ? max(0, q0 - window + 1) / kBc * kBc : 0;
  for (int k0 = kv_begin; k0 < kv_end; k0 += kBc) {
    __syncthreads();  // the last tile's reads are done (and qs is written)
    for (int i = tid; i < kBc * D; i += kThreads) {
      const int r = i / D, c = i % D, t = k0 + r;
      const bool ok = t < Tk;
      ks[r * DP + c] =
          ok ? kb[(long long)t * kvstride + c] : 0.0f;
      vs[r * D + c] =
          ok ? vb[(long long)t * kvstride + c] : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        if (kp >= Tk || (causal && kp > qp) || (window && qp - kp >= window))
          s[i][j] = -1e30f;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty * 4 + i) * PP + tx + 16 * j] = p;
        rs += p;
      }
      ell[i] = alpha * ell[i] + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // every row of p is in shared memory

#pragma unroll 4
    for (int t = 0; t < kBc; ++t) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * PP + t];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = vs[t * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= S) continue;
    const float den = fmaxf(ell[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      ob[(long long)s * qstride + tx + 16 * c] =
          acc[i][c] / den;
    if (lse != nullptr && tx == 0)  // natural log-sum-exp of the row
      lse[((long long)b * H + h) * S + s] = m[i] + logf(den);
  }
}

template <int D>
int launch_f32_d(const float* q, const float* k, const float* v, float* out,
                 float* lse, int B, int S, int Tk, int H, int KV, int causal,
                 int window, float scale, cudaStream_t stream) {
  static unsigned smem_set = 0;
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = allow_smem_once(flash_fwd_simt_kernel<D>, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBr - 1) / kBr, H, B);
  flash_fwd_simt_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k, v, out, lse, S, Tk, H, KV, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const float* q, const float* k, const float* v, float* out,
               float* lse, int B, int S, int Tk, int H, int KV, int D,
               int causal, int window, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_f32_d<64>(q, k, v, out, lse, B, S, Tk, H, KV, causal,
                            window, scale, st);
  if (D == 128)
    return launch_f32_d<128>(q, k, v, out, lse, B, S, Tk, H, KV, causal,
                             window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// lse: [B, H, S] float32, each row's natural log-sum-exp of its scaled,
// masked scores (the backward's), or null: nothing more is written.
extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, float* out, float* lse,
                                   int B, int S, int Tk, int H, int KV, int D,
                                   int causal, int window, float scale,
                                   void* stream) {
  return launch_f32(q, k, v, out, lse, B, S, Tk, H, KV, D, causal, window,
                    scale, stream);
}

extern "C" int flash_attention_bf16(const __nv_bfloat16* q,
                                    const __nv_bfloat16* k,
                                    const __nv_bfloat16* v,
                                    __nv_bfloat16* out, float* lse, int B,
                                    int S, int Tk, int H, int KV, int D,
                                    int causal, int window, float scale,
                                    void* stream) {
  return launch_bf16(q, k, v, out, lse, B, S, Tk, H, KV, D, causal, window,
                     scale, stream);
}
