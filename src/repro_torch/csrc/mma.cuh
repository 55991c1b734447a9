// Tensor-core building blocks of the port's backward kernels: cp.async
// copies, ldmatrix fragment loads and mma.sync m16n8k16 (bf16 in, f32
// accumulate), and the packing of float32 pairs into bf16 fragments.
//
// Fragment layouts of mma.sync m16n8k16, lane = 4 g + t:
//   A (16 x 16, row-major): a0 = (row g, k 2t..2t+1), a1 = (row g + 8, same
//     k), a2 = (row g, k 2t + 8..), a3 = (row g + 8, k 2t + 8..);
//   B (16 x 8, column-major): b0 = (k 2t..2t+1, col g), b1 = (k 2t + 8..);
//   C (16 x 8, float32): c0, c1 = (row g, cols 2t, 2t + 1), c2, c3 = (row
//     g + 8, same cols).
// So the accumulators of two n8 tiles side by side, packed in pairs, are
// the A fragment of one k16 step (`acc_to_a`).
#pragma once

#include "common.cuh"

namespace repro_torch {
namespace mma {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `bytes` < 16 fills the rest with zeros (0: a
// row past the tensor's edge, `src` only has to be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes = 4) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Four 8x8 b16 matrices; lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The address a lane gives ldmatrix.x4 in a row-major bf16 tile `base`
// (`ld` elements a row), for the 16 x 16 block at (row r0, column c0):
// `frag_rows` for an A fragment (rows = the block's rows, ldsm_x4) or the
// B fragments of two n8 tiles whose k runs down the rows (ldsm_x4_t);
__device__ __forceinline__ const __nv_bfloat16* frag_rows(
    const __nv_bfloat16* base, int ld, int r0, int c0, int lane) {
  return base + (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8;
}
// `frag_cols` for the B fragments of two n8 tiles whose k runs along the
// rows (n = the block's rows, ldsm_x4), or an A fragment of the block's
// transpose (ldsm_x4_t).
__device__ __forceinline__ const __nv_bfloat16* frag_cols(
    const __nv_bfloat16* base, int ld, int r0, int c0, int lane) {
  return base + (r0 + (lane & 7) + (lane >> 4) * 8) * ld + c0 +
         ((lane >> 3) & 1) * 8;
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.  Not
// volatile: it touches no memory, so the compiler may interleave
// independent accumulators' products (ldmatrix and cp.async stay volatile,
// ordered against each other and the barriers).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to nearest even into one bf16 pair (lo in the low
// half: the lower column of a fragment).
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(unsigned u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

// A float32 pair as two bf16 pairs, hi + lo: hi rounds the pair, lo rounds
// what hi left out, so hi + lo keeps 16 bits of each mantissa.
__device__ __forceinline__ void split_bf16(float a, float b, unsigned& hi,
                                           unsigned& lo) {
  hi = pack_bf16(a, b);
  const float2 h = unpack_bf16(hi);
  lo = pack_bf16(a - h.x, b - h.y);
}

// The A fragment (k16) made of the float accumulators of n8 tiles n0 and
// n0 + 1 of the same 16 rows, rounded to bf16.
__device__ __forceinline__ void acc_to_a(unsigned (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// The same as hi and lo bf16 terms.
__device__ __forceinline__ void acc_to_a_split(unsigned (&hi)[4],
                                               unsigned (&lo)[4],
                                               const float (&c0)[4],
                                               const float (&c1)[4]) {
  split_bf16(c0[0], c0[1], hi[0], lo[0]);
  split_bf16(c0[2], c0[3], hi[1], lo[1]);
  split_bf16(c1[0], c1[1], hi[2], lo[2]);
  split_bf16(c1[2], c1[3], hi[3], lo[3]);
}

__device__ __forceinline__ float fast_exp2(float x) {  // 2^x, -inf -> 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace mma
}  // namespace repro_torch
