// Eq. (2) masked FedAvg reduction of one parameter leaf:
//
//     out[d] = sum_n w[n] * screen(x[n, d]),   screen(v) = isfinite(v) ? v : 0
//
// Replaces the Pallas TPU kernel `_fedavg_kernel` / `_reduce_leaf` /
// `fedavg_reduce` in src/repro/kernels/fedavg_reduce.py.  The weights
// (finite mask, a_i |D_i|, optional multipliers, norm-clip factors), the
// division by their total and the empty-selection guard stay in the Python
// wrapper, as in the JAX package.  The screen is in the kernel because a
// zero weight cannot stop 0 * NaN.
//
// What bounds it on the H100: it reads the [N, D] client plane once (4N
// bytes per output) for 2N flops, so memory.  The simple design gives
// each feature column one thread that walks the clients in index order
// and accumulates in float32: neighbouring threads read neighbouring
// addresses, every column sums in the same order on every run (the result
// is deterministic), and no second pass or atomic is needed.  With N = 50
// each thread has little work; blocking clients per warp is later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fedavg_reduce_kernel(const float* __restrict__ w, const float* __restrict__ x,
                     long long n, long long d, float* __restrict__ out) {
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= d) return;
  float acc = 0.0f;
  for (long long i = 0; i < n; ++i) {
    const float v = x[i * d + col];
    acc += w[i] * (isfinite(v) ? v : 0.0f);
  }
  out[col] = acc;
}

}  // namespace

extern "C" int fedavg_reduce_f32(const float* w, const float* x, long long n,
                                 long long d, float* out, void* stream) {
  if (d > 0) {
    const long long blocks = (d + kThreads - 1) / kThreads;
    fedavg_reduce_kernel<<<(unsigned)blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(w, x, n, d,
                                                                out);
  }
  return static_cast<int>(cudaGetLastError());
}
