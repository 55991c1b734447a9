// DAGSA's selection argmaxes (Algorithm 1 steps 1 and 3) on [N, M] SNR.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/select_topk.py:
//   * masked_bs_argmax (`_select_kernel`, `_running_argmax`): per BS, the
//     best remaining user -> (cand [M] int32, best [M] f32);
//   * best_bs_argmax (`_rowmax_kernel`): per user, the best BS -> [N] int32.
// Both follow jnp.argmax exactly: the lowest index wins a tie, and an
// all-masked column gives (0, -inf).  Inputs are float32 and finite.
//
// What bounds them on the H100: one read of the [N, M] plane (4 bytes per
// entry) and almost no arithmetic, so memory; at the paper's 50 x 8 shape a
// launch costs more than the work.
//
// masked_bs_argmax.  The TPU kernel walks user blocks in grid order and
// keeps a running (best, index) in VMEM.  A Hopper grid runs its blocks in
// no order, so the scan is two deterministic passes:
//   pass 1: each block takes a contiguous run of rows; blockDim is a
//     multiple of M, so thread t always sees column t % M while the warp's
//     loads stay contiguous in the row-major plane.  Each thread keeps the
//     first maximum of its rows, and the block merges its threads in shared
//     memory into one (max, first index) partial per column.
//   pass 2: one block per column merges the partials.
// Every merge orders candidates by (value descending, index ascending); a
// total order, so the result does not depend on the merge order and equals
// the block-order strictly-greater combine of the TPU kernel.
//
// best_bs_argmax: one thread per user scans its M columns with a strictly-
// greater update, so the lowest column wins ties.
#include <limits.h>

#include "common.cuh"

namespace {

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__global__ void masked_argmax_partial(const float* __restrict__ snr,
                                      const uint8_t* __restrict__ remaining,
                                      int n, int m, int rows_per_block,
                                      float* __restrict__ part_val,
                                      int* __restrict__ part_idx) {
  extern __shared__ unsigned char smem[];
  float* sv = reinterpret_cast<float*>(smem);
  int* si = reinterpret_cast<int*>(sv + blockDim.x);
  const int t = threadIdx.x;
  const int subs = blockDim.x / m;
  const int col = t % m, sub = t / m;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(n, r0 + rows_per_block);

  float best = -INFINITY;
  int bidx = INT_MAX;
  for (int r = r0 + sub; r < r1; r += subs) {
    const float v = remaining[r] ? snr[(long long)r * m + col] : -INFINITY;
    if (better(v, r, best, bidx)) {
      best = v;
      bidx = r;
    }
  }
  sv[t] = best;
  si[t] = bidx;
  __syncthreads();
  if (sub == 0) {
    for (int s = 1; s < subs; ++s) {
      const float v = sv[s * m + col];
      const int i = si[s * m + col];
      if (better(v, i, best, bidx)) {
        best = v;
        bidx = i;
      }
    }
    part_val[(long long)blockIdx.x * m + col] = best;
    part_idx[(long long)blockIdx.x * m + col] = bidx;
  }
}

constexpr int kCombineThreads = 256;

__global__ void __launch_bounds__(kCombineThreads)
masked_argmax_combine(const float* __restrict__ part_val,
                      const int* __restrict__ part_idx, int n_blocks, int m,
                      int* __restrict__ cand, float* __restrict__ best_out) {
  __shared__ float sv[kCombineThreads];
  __shared__ int si[kCombineThreads];
  const int col = blockIdx.x;
  float best = -INFINITY;
  int bidx = INT_MAX;
  for (int b = threadIdx.x; b < n_blocks; b += blockDim.x) {
    const float v = part_val[(long long)b * m + col];
    const int i = part_idx[(long long)b * m + col];
    if (better(v, i, best, bidx)) {
      best = v;
      bidx = i;
    }
  }
  sv[threadIdx.x] = best;
  si[threadIdx.x] = bidx;
  __syncthreads();
  for (int half = blockDim.x / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) {
      const float v = sv[threadIdx.x + half];
      const int i = si[threadIdx.x + half];
      if (better(v, i, sv[threadIdx.x], si[threadIdx.x])) {
        sv[threadIdx.x] = v;
        si[threadIdx.x] = i;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    cand[col] = si[0] == INT_MAX ? 0 : si[0];
    best_out[col] = sv[0];
  }
}

constexpr int kRowThreads = 256;

__global__ void __launch_bounds__(kRowThreads)
best_bs_kernel(const float* __restrict__ snr, int n, int m,
               int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* row = snr + (long long)i * m;
  float best = row[0];
  int bidx = 0;
  for (int j = 1; j < m; ++j) {
    const float v = row[j];
    if (v > best) {
      best = v;
      bidx = j;
    }
  }
  out[i] = bidx;
}

}  // namespace

// part_val/part_idx: [n_blocks, m] scratch the caller allocates, with
// n_blocks = ceil(n / rows_per_block); threads is a multiple of m.
extern "C" int masked_bs_argmax_f32(const float* snr, const uint8_t* remaining,
                                    int n, int m, int threads,
                                    int rows_per_block, float* part_val,
                                    int* part_idx, int* cand, float* best,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_blocks = (n + rows_per_block - 1) / rows_per_block;
  const size_t smem = (size_t)threads * (sizeof(float) + sizeof(int));
  masked_argmax_partial<<<n_blocks, threads, smem, s>>>(
      snr, remaining, n, m, rows_per_block, part_val, part_idx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  masked_argmax_combine<<<m, kCombineThreads, 0, s>>>(part_val, part_idx,
                                                      n_blocks, m, cand, best);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int best_bs_argmax_f32(const float* snr, int n, int m, int* out,
                                  void* stream) {
  const int blocks = (n + kRowThreads - 1) / kRowThreads;
  best_bs_kernel<<<blocks, kRowThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      snr, n, m, out);
  return static_cast<int>(cudaGetLastError());
}
