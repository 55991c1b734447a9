// Eq. (2) masked FedAvg reductions of one parameter leaf, single-tier and
// per-BS (hierarchical edge aggregation):
//
//     fedavg_reduce:          out[d]    = sum_n w[n]    * screen(x[n, d])
//     fedavg_segment_reduce:  out[m, d] = sum_n w[n, m] * screen(x[n, d])
//
// screen(v) = isfinite(v) ? v : 0 for float inputs.  Both take x as float32
// or as int8 codes of the compressed uplink: there the in-kernel conversion
// of a code to float32 IS the decompression (the per-client dequant scale
// is folded into w by the caller), as in the JAX package.
//
// Replace the Pallas TPU kernels `_fedavg_kernel` / `_reduce_leaf` and
// `_segment_kernel` / `_segment_reduce_leaf` in
// src/repro/kernels/fedavg_reduce.py, called over f32 client leaves by
// `fedavg_reduce` / `fedavg_segment_reduce` and over int8 codes by
// `fedavg_decompress_reduce` / `fedavg_decompress_segment_reduce`
// (src/repro/kernels/compress_topk.py).  The weights (finite mask, a_i |D_i|,
// multipliers, clip factors, dequant scales), the division by their totals
// and the empty-selection / empty-BS guards stay in the Python wrappers, as
// in the JAX package.  The screen is in the kernel because a zero weight
// cannot stop 0 * NaN.
//
// What bounds them on the H100: the [N, D] client plane is read once per
// output tile (4N bytes per column in f32, N in int8) for 2N flops per
// output, so memory, except for the segmented sum with many BSs, where the
// 2NMD flops (off the tensor cores) take over.
//
// Design, simple first: one thread per feature column walks the clients in
// index order and accumulates in float32.  Neighbouring threads read
// neighbouring addresses, every column sums in the same order on every run
// (deterministic, no atomics, no second pass).  The segmented kernel holds a
// tile of MT BS rows in registers, gridDim.y covers the BS tiles (so any M
// works), and each client chunk's w[n, m-tile] is staged in shared memory,
// where all threads of the block read the same word (a broadcast).  Each BS
// tile re-reads the client plane: ceil(M / MT) passes over x.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 256;  // clients per staged weight chunk

__device__ __forceinline__ float load_screened(const float* p) {
  const float v = *p;
  return isfinite(v) ? v : 0.0f;
}

__device__ __forceinline__ float load_screened(const int8_t* p) {
  return static_cast<float>(*p);  // int8 codes are always finite
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fedavg_reduce_kernel(const float* __restrict__ w, const T* __restrict__ x,
                     long long n, long long d, float* __restrict__ out) {
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= d) return;
  float acc = 0.0f;
  for (long long i = 0; i < n; ++i)
    acc += w[i] * load_screened(x + i * d + col);
  out[col] = acc;
}

template <typename T, int MT>
__global__ void __launch_bounds__(kThreads)
fedavg_segment_reduce_kernel(const float* __restrict__ w,
                             const T* __restrict__ x, long long n, int m,
                             long long d, float* __restrict__ out) {
  __shared__ float sw[kChunk * MT];
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int m0 = blockIdx.y * MT;
  const bool live = col < d;
  float acc[MT];
#pragma unroll
  for (int t = 0; t < MT; ++t) acc[t] = 0.0f;

  for (long long c0 = 0; c0 < n; c0 += kChunk) {
    const long long rest = n - c0;
    const int len = rest < kChunk ? (int)rest : kChunk;
    __syncthreads();  // the previous chunk's weights are consumed
    for (int j = threadIdx.x; j < kChunk * MT; j += blockDim.x) {
      const int i = j / MT, t = j % MT;
      sw[j] = (i < len && m0 + t < m) ? w[(c0 + i) * m + m0 + t] : 0.0f;
    }
    __syncthreads();
    if (live) {
      const T* xc = x + c0 * d + col;
      for (int i = 0; i < len; ++i) {
        const float v = load_screened(xc + (long long)i * d);
#pragma unroll
        for (int t = 0; t < MT; ++t) acc[t] += sw[i * MT + t] * v;
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int t = 0; t < MT; ++t)
    if (m0 + t < m) out[(long long)(m0 + t) * d + col] = acc[t];
}

template <typename T>
int launch_reduce(const float* w, const T* x, long long n, long long d,
                  float* out, void* stream) {
  if (d > 0) {
    const long long blocks = (d + kThreads - 1) / kThreads;
    fedavg_reduce_kernel<T><<<(unsigned)blocks, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(w, x, n, d,
                                                                   out);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MT>
void launch_segment_tiles(const float* w, const T* x, long long n, int m,
                          long long d, float* out, cudaStream_t stream) {
  const dim3 grid((unsigned)((d + kThreads - 1) / kThreads),
                  (unsigned)((m + MT - 1) / MT));
  fedavg_segment_reduce_kernel<T, MT><<<grid, kThreads, 0, stream>>>(
      w, x, n, m, d, out);
}

// MT = 8 covers the paper's 8 BSs in one pass; wider fleets take 16-row
// tiles, halving the passes over x.
template <typename T>
int launch_segment(const float* w, const T* x, long long n, int m,
                   long long d, float* out, void* stream) {
  if (d > 0 && m > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (m <= 8)
      launch_segment_tiles<T, 8>(w, x, n, m, d, out, s);
    else
      launch_segment_tiles<T, 16>(w, x, n, m, d, out, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fedavg_reduce_f32(const float* w, const float* x, long long n,
                                 long long d, float* out, void* stream) {
  return launch_reduce<float>(w, x, n, d, out, stream);
}

extern "C" int fedavg_reduce_i8(const float* w, const int8_t* x, long long n,
                                long long d, float* out, void* stream) {
  return launch_reduce<int8_t>(w, x, n, d, out, stream);
}

extern "C" int fedavg_segment_reduce_f32(const float* w, const float* x,
                                         long long n, int m, long long d,
                                         float* out, void* stream) {
  return launch_segment<float>(w, x, n, m, d, out, stream);
}

extern "C" int fedavg_segment_reduce_i8(const float* w, const int8_t* x,
                                        long long n, int m, long long d,
                                        float* out, void* stream) {
  return launch_segment<int8_t>(w, x, n, m, d, out, stream);
}
