// RMSNorm over the last axis: out = (x * rsqrt(mean(x^2) + eps)) * scale.
//
// Replaces the Pallas TPU kernel `rmsnorm` in src/repro/kernels/rmsnorm.py
// (`_rmsnorm_kernel`), which the model's `layers.norm_apply` and
// `layers.rms_norm` compute.  x is [rows, d] in float32 or bfloat16, scale
// [d] in the same type; all math is float32, the product with r first and
// then the scale (rmsnorm.py:21-22, layers.py:34-35), and the result is
// cast back to x's type.
//
// What bounds it on the H100: one read of x and one write of out, two
// flops an element, so memory.  The TPU kernel loads a block of 256 rows
// into VMEM; here one warp takes one row (8 rows a block): each lane sums
// the squares of every 32nd element in float32, a warp shuffle totals them,
// and a second pass over the row (now in L1/L2) writes the result.  Rows
// are B*S in prefill and B in decode.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
               T* __restrict__ out, long long rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const T* xr = x + row * d;
  float ss = 0.0f;
  for (int c = lane; c < d; c += 32) {
    const float v = repro_torch::to_f32(xr[c]);
    ss = fmaf(v, v, ss);
  }
  ss = __shfl_sync(0xffffffffu, repro_torch::warp_sum(ss), 0);
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);
  T* orow = out + row * d;
  for (int c = lane; c < d; c += 32) {
    const float v = repro_torch::to_f32(xr[c]) * r;
    orow[c] = repro_torch::from_f32<T>(v * repro_torch::to_f32(scale[c]));
  }
}

template <typename T>
int launch(const T* x, const T* scale, T* out, long long rows, int d,
           float eps, void* stream) {
  const long long blocks = (rows + kWarps - 1) / kWarps;
  rmsnorm_kernel<T><<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(x, scale, out,
                                                           rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rmsnorm_f32(const float* x, const float* scale, float* out,
                           long long rows, int d, float eps, void* stream) {
  return launch(x, scale, out, rows, d, eps, stream);
}

extern "C" int rmsnorm_bf16(const __nv_bfloat16* x,
                            const __nv_bfloat16* scale, __nv_bfloat16* out,
                            long long rows, int d, float eps, void* stream) {
  return launch(x, scale, out, rows, d, eps, stream);
}
