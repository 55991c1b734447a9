// Compressed-uplink client codes: top-k sparsify, optionally int8 stochastic
// rounding, one fused elementwise pass over a client-delta leaf [N, D]:
//
//     v    = isfinite(x[n, d]) ? x[n, d] : 0
//     keep = |v| >= thresh[n]                    (magnitude ties all survive)
//     quantize:  out[n, d] = keep ? clip(floor(v / scale[n] + u[n, d]),
//                                       -127, 127) : 0        (int8)
//     otherwise: out[n, d] = keep ? v : 0                       (float32)
//
// Replaces the Pallas TPU kernel `_compress_kernel` / `sparsify_quantize` in
// src/repro/kernels/compress_topk.py.  The per-row threshold (the k-th
// largest |v|, a top-k outside the kernel as `lax.top_k` is in JAX), the
// dequant scale and the uniform noise u are inputs, so the kernel and its
// plain version produce the same codes bit for bit: the division and the
// add are the IEEE-rounded `__fdiv_rn` / `__fadd_rn`, which the compiler
// never contracts or approximates, and `floorf` is exact.
//
// What bounds it on the H100: it reads x (and u) once and writes the codes
// once, one compare, one divide and one add per entry, so memory.  One
// thread per entry, a row of blocks per client (gridDim.y walks the rows,
// looping past 65,535), neighbouring threads on neighbouring addresses.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kQmax = 127.0f;

template <bool kQuantize>
__global__ void __launch_bounds__(kThreads)
sparsify_quantize_kernel(const float* __restrict__ x,
                         const float* __restrict__ thresh,
                         const float* __restrict__ scale,
                         const float* __restrict__ u, long long n, long long d,
                         void* __restrict__ out) {
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= d) return;
  for (long long row = blockIdx.y; row < n; row += gridDim.y) {
    const long long at = row * d + col;
    float v = x[at];
    v = isfinite(v) ? v : 0.0f;
    const bool keep = fabsf(v) >= thresh[row];
    if (kQuantize) {
      float q = floorf(__fadd_rn(__fdiv_rn(v, scale[row]), u[at]));
      q = fminf(fmaxf(q, -kQmax), kQmax);
      static_cast<int8_t*>(out)[at] =
          keep ? static_cast<int8_t>(q) : static_cast<int8_t>(0);
    } else {
      static_cast<float*>(out)[at] = keep ? v : 0.0f;
    }
  }
}

}  // namespace

extern "C" int sparsify_quantize_f32(const float* x, const float* thresh,
                                     const float* scale, const float* u,
                                     long long n, long long d, int quantize,
                                     void* out, void* stream) {
  if (n > 0 && d > 0) {
    const dim3 grid((unsigned)((d + kThreads - 1) / kThreads),
                    (unsigned)(n < 65535 ? n : 65535));
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (quantize)
      sparsify_quantize_kernel<true><<<grid, kThreads, 0, s>>>(
          x, thresh, scale, u, n, d, out);
    else
      sparsify_quantize_kernel<false><<<grid, kThreads, 0, s>>>(
          x, thresh, scale, u, n, d, out);
  }
  return static_cast<int>(cudaGetLastError());
}
