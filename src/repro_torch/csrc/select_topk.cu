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
// best_bs_argmax.  The TPU kernel (`_rowmax_kernel`) takes a block of user
// rows and reduces each along its M columns.  Here a group of G lanes (a
// power of two <= 32) takes one row: lane j reads columns j, j + G, ...,
// so a group reads G neighbouring floats a load, and the 32 / G rows a warp
// holds are neighbours in the plane.  Each lane issues C column loads for
// each of U rows (C * U = 8) before it compares any and keeps the first
// maximum of its columns; the group then merges under (value descending,
// index ascending), so ties go to the lowest column as in jnp.argmax: a
// whole warp by two redux.sync reductions (the largest value as an
// order-preserving integer key, then the lowest column holding it), a
// smaller group by xor shuffles.  A merge costs the warp the same shuffles
// whether it serves one row or 32 / G, so G is as small as 8 loads a lane
// allow: about M / 8 (on the H100, a sweep over G, C and U put this shape
// first at M = 33, 100, 257 and 1024).  The wrapper picks G, C and U
// (select_topk.py:best_bs_plan).  A row of -inf gives 0, as torch.argmax
// does.
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

// An integer key that orders as the float does (-0 as +0; no NaN).
__device__ __forceinline__ unsigned ordered_key(float v) {
  const unsigned u = __float_as_uint(v + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The lowest column holding the group's largest value, handed to every
// lane of the group.  A whole warp reduces with redux.sync; a smaller
// group by xor shuffles under (value descending, index ascending).
template <int G>
__device__ __forceinline__ int group_argmax(float best, int idx) {
  if constexpr (G == 32) {
    const unsigned key = ordered_key(best);
    const unsigned top = __reduce_max_sync(0xffffffffu, key);
    return __reduce_min_sync(0xffffffffu, key == top ? idx : INT_MAX);
  } else {
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, idx, o);
      if (better(ov, oi, best, idx)) {
        best = ov;
        idx = oi;
      }
    }
    return idx;
  }
}

// G lanes a row, C column loads a lane and pass, U rows a lane group.
template <int G, int C, int U>
__global__ void __launch_bounds__(kRowThreads)
best_bs_kernel(const float* __restrict__ snr, int n, int m,
               int* __restrict__ out) {
  constexpr int kPerLoad = 32 / G;  // rows one load of the warp covers
  const int lane = threadIdx.x & 31;
  const int j = lane & (G - 1);
  const long long warp =
      ((long long)blockIdx.x * kRowThreads + threadIdx.x) >> 5;
  const long long row0 = warp * (kPerLoad * U) + lane / G;
  const float* base = snr + row0 * m;
  bool live[U];
  float best[U];
  int bidx[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    live[u] = row0 + u * kPerLoad < n;
    best[u] = -INFINITY;
    bidx[u] = m;  // "no column yet": past every column
  }
  for (int c0 = j; c0 < m; c0 += C * G) {
    float v[U][C];
#pragma unroll
    for (int u = 0; u < U; ++u) {  // every load issues before any compare
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const int c = c0 + k * G;
        v[u][k] = live[u] && c < m
                      ? __ldg(base + (long long)(u * kPerLoad) * m + c)
                      : -INFINITY;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int k = 0; k < C; ++k) {  // columns rise: the first max stays
        if (v[u][k] > best[u]) {
          best[u] = v[u][k];
          bidx[u] = c0 + k * G;
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = group_argmax<G>(best[u], bidx[u]);
    if (j == 0 && live[u]) out[row0 + u * kPerLoad] = i < m ? i : 0;
  }
}

template <int G, int C, int U>
int launch_best_bs(const float* snr, int n, int m, int* out,
                   cudaStream_t s) {
  constexpr int kRowsPerBlock = kRowThreads / G * U;
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  best_bs_kernel<G, C, U><<<blocks, kRowThreads, 0, s>>>(snr, n, m, out);
  return static_cast<int>(cudaGetLastError());
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

// lanes = G, chunks = C, rows = U as select_topk.py:best_bs_plan gives
// them: C * U = 8, and C = 8 when G > 1.
extern "C" int best_bs_argmax_f32(const float* snr, int n, int m, int lanes,
                                  int chunks, int rows, int* out,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunks * rows != 8) return static_cast<int>(cudaErrorInvalidValue);
  if (lanes == 1) {
    switch (chunks) {
      case 1: return launch_best_bs<1, 1, 8>(snr, n, m, out, s);
      case 2: return launch_best_bs<1, 2, 4>(snr, n, m, out, s);
      case 4: return launch_best_bs<1, 4, 2>(snr, n, m, out, s);
      case 8: return launch_best_bs<1, 8, 1>(snr, n, m, out, s);
    }
  } else if (chunks == 8) {
    switch (lanes) {
      case 2: return launch_best_bs<2, 8, 1>(snr, n, m, out, s);
      case 4: return launch_best_bs<4, 8, 1>(snr, n, m, out, s);
      case 8: return launch_best_bs<8, 8, 1>(snr, n, m, out, s);
      case 16: return launch_best_bs<16, 8, 1>(snr, n, m, out, s);
      case 32: return launch_best_bs<32, 8, 1>(snr, n, m, out, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
