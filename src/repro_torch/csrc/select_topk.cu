// DAGSA's selection argmaxes (Algorithm 1 steps 1 and 3) on [N, M] SNR.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/select_topk.py:
//   * masked_bs_argmax (`_select_kernel`, `_running_argmax`): per BS, the
//     best remaining user -> (cand [M] int32, best [M] f32);
//   * best_bs_argmax (`_rowmax_kernel`): per user, the best BS -> [N] int32.
// Both follow jnp.argmax exactly: the lowest index wins a tie, and an
// all-masked column gives (0, -inf).  Inputs are finite.
//
// What bounds them on the H100: one read of the [N, M] plane and almost no
// arithmetic, so memory; at the paper's 50 x 8 shape a launch costs more
// than the work.
//
// masked_bs_argmax.  The SNR is stored as float32, bfloat16 or int8 codes;
// a value is f32(code) * scale[col] (scale 1 without one), one float32
// multiply before any compare, as the TPU kernel dequantises in-block: a
// caller's scale may be negative, so raw codes are never compared.  The
// TPU kernel walks user blocks in grid order and keeps a running (best,
// index) in VMEM; a Hopper grid runs its blocks in no order, so:
//   * each block takes a run of rows in tiles of `threads x V` consecutive
//     entries (a whole number of rows): thread t loads one 4-byte word of V
//     codes (float32 1, bfloat16 2, int8 4; one code a load off 4-byte
//     alignment) from each tile, 8 tiles in flight, so its V entries keep
//     the same columns from tile to tile; the block stages its rows' mask
//     bytes in shared memory first and reads no code of a row that is not
//     remaining (half the plane on DAGSA's path), and each thread keeps
//     the first maximum of each entry (strict >, rows rise);
//   * the block merges its threads' candidates per column in shared memory
//     (a tree over the tile's rows);
//   * a plane one block covers (32,768 float32 / 65,536 bf16 or int8
//     entries; the main path's [50, 8]) goes to a kernel of its own that
//     reads the mask from global memory beside every code word, so one
//     memory latency, not two, precedes the merge, and writes cand and
//     best itself (a card A/B at [50, 8], PERF.md: 0.0024 ms against
//     0.0026 for the general kernel run as one block).  Otherwise each block folds its candidate into a packed
//     64-bit key per column (the value as an order-preserving integer
//     above the complement of the index; keys 128 bytes apart) by
//     atomicMax, and the last block to take a ticket (__threadfence +
//     atomicAdd) unpacks the keys into the outputs and resets keys and
//     ticket to 0 for the next call.  Card sweep (chip_smoke.py,
//     masked_variants; PERF.md): blocks of ~32k float32 entries, ~64k
//     bf16 / int8.
// Every merge orders candidates by (value descending, index ascending); a
// total order, so the result does not depend on the order blocks finish
// in and equals the block-order strictly-greater combine of the TPU
// kernel.  One launch a call; the keys and the ticket live in a workspace
// the wrapper caches per device and stream (kernels/_lib.py:workspace; a
// call captured into a CUDA graph gets one of its own).
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

// An integer key that orders as the float does (-0 as +0; no NaN).
__device__ __forceinline__ unsigned ordered_key(float v) {
  const unsigned u = __float_as_uint(v + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// ---------------------------------------------------- masked_bs_argmax ---
// The codes of one 4-byte word as float32, exactly.
template <typename T>
struct Word;
template <>
struct Word<float> {
  static constexpr int V = 1;
  static __device__ __forceinline__ void unpack(unsigned w, float* v) {
    v[0] = __uint_as_float(w);
  }
};
template <>
struct Word<__nv_bfloat16> {
  static constexpr int V = 2;
  static __device__ __forceinline__ void unpack(unsigned w, float* v) {
    v[0] = __uint_as_float(w << 16);
    v[1] = __uint_as_float(w & 0xffff0000u);
  }
};
template <>
struct Word<int8_t> {
  static constexpr int V = 4;
  static __device__ __forceinline__ void unpack(unsigned w, float* v) {
    // code c (two's complement) ^ 0x80 is c + 128 as a byte; under the
    // exponent of 2^23 that is the float 2^23 + 128 + c, exactly
    const unsigned biased = w ^ 0x80808080u;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      v[b] = __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540u + b)) -
             8388736.0f;
  }
};

__device__ __forceinline__ float code_f32(float x) { return x; }
__device__ __forceinline__ float code_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float code_f32(int8_t x) {
  return static_cast<float>(x);
}

constexpr int kTilesInFlight = 8;
constexpr int kKeyStride = 16;  // a column's key on its own 128-byte line

// The 4-byte word of V codes at p (V = Word<T>::V, p 4-byte aligned), or
// one code as float32 bits (V = 1).
template <typename T, int V>
__device__ __forceinline__ unsigned load_word(const T* p) {
  if constexpr (V == 1) {
    return __float_as_uint(code_f32(__ldg(p)));
  } else {
    return __ldg(reinterpret_cast<const unsigned*>(p));
  }
}

// The first `valid` codes of that word, packed as the word holds them
// (the word runs past the block's last row).
template <typename T, int V>
__device__ __forceinline__ unsigned load_partial(const T* p, int valid) {
  if constexpr (V == 1) {
    return load_word<T, 1>(p);
  } else {
    constexpr int kBits = 32 / V;
    unsigned w = 0;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      if (e < valid) {
        unsigned short bits16;
        if constexpr (sizeof(T) == 1) {
          bits16 = static_cast<uint8_t>(p[e]);
        } else {
          bits16 = __bfloat16_as_ushort(p[e]);
        }
        w |= (unsigned)bits16 << (kBits * e);
      }
    }
    return w;
  }
}

template <typename T, int V>
__device__ __forceinline__ void unpack(unsigned w, float* v) {
  if constexpr (V == 1) {
    v[0] = __uint_as_float(w);
  } else {
    Word<T>::unpack(w, v);
  }
}

// Folds the V entries of word w of tile row `tile_row` (rows relative to
// the block; bit p of `rem`: entry p's row remains) into the thread's
// running candidates.
template <typename T, int V, bool kAll>
__device__ __forceinline__ void fold(unsigned w, unsigned rem,
                                     const float* sc, int tile_row,
                                     const int* drow, float* best,
                                     int* bidx) {
  float v[V];
  unpack<T, V>(w, v);
#pragma unroll
  for (int p = 0; p < V; ++p) {
    const float x = kAll || ((rem >> p) & 1u) ? v[p] * sc[p] : -INFINITY;
    if (x > best[p]) {  // rows rise: the first maximum stays
      best[p] = x;
      bidx[p] = tile_row + drow[p];
    }
  }
}

// Thread t's V entries: their row in a tile, their column's scale, and
// the running candidate (none yet).
template <int V>
__device__ __forceinline__ void init_entries(int t, int m,
                                             const float* __restrict__ scale,
                                             int* drow, float* sc,
                                             float* best, int* bidx) {
#pragma unroll
  for (int p = 0; p < V; ++p) {
    const int f = t * V + p;
    drow[p] = f / m;
    sc[p] = scale ? scale[f % m] : 1.0f;
    best[p] = -INFINITY;
    bidx[p] = INT_MAX;
  }
}

// Folds the words of kTilesInFlight tiles, tile u at rows tr + u *
// rows_per_tile.
template <typename T, int V>
__device__ __forceinline__ void fold_tiles(const unsigned* w,
                                           const unsigned* rem,
                                           const float* sc, int tr,
                                           int rows_per_tile,
                                           const int* drow, float* best,
                                           int* bidx) {
#pragma unroll
  for (int u = 0; u < kTilesInFlight; ++u) {
    if (rem[u] == (1u << V) - 1u)  // every entry's row remains
      fold<T, V, true>(w[u], rem[u], sc, tr + u * rows_per_tile, drow,
                       best, bidx);
    else if (rem[u])
      fold<T, V, false>(w[u], rem[u], sc, tr + u * rows_per_tile, drow,
                        best, bidx);
  }
}

// The block's candidates (sv, si: entry j * m + c is tile row j, column
// c) merged into row 0 by folding rows j + s into j; ends synchronised.
__device__ __forceinline__ void merge_tile_rows(float* sv, int* si, int m,
                                                int rows_per_tile, int t) {
  for (int s = (1 << (32 - __clz(rows_per_tile - 1))) >> 1; s >= 1;
       s >>= 1) {
    __syncthreads();
    for (int q = t; q < s * m; q += blockDim.x) {
      const int j = q / m, g = q + s * m;
      if (j + s < rows_per_tile && better(sv[g], si[g], sv[q], si[q])) {
        sv[q] = sv[g];
        si[q] = si[g];
      }
    }
  }
  __syncthreads();
}

// Row 0 of the merged candidates as the result: (0, -inf) where no row
// remains.
__device__ __forceinline__ void write_result(const float* sv, const int* si,
                                             int m, int t, int* cand,
                                             float* best_out) {
  for (int c = t; c < m; c += blockDim.x) {
    cand[c] = si[c] == INT_MAX ? 0 : si[c];
    best_out[c] = sv[c];
  }
}

// Block b takes rows [b * rows_per_block, ...), a multiple of
// kTilesInFlight tiles of rows_per_tile rows; blockDim.x * V ==
// rows_per_tile * m.  Dynamic shared memory: blockDim.x * V (value,
// index) pairs, then the block's mask bytes.  packed (a column's key every
// kKeyStride words) and ticket: zero between calls.
template <typename T, int V>
__global__ void masked_argmax_kernel(const T* __restrict__ snr,
                                     const uint8_t* __restrict__ remaining,
                                     const float* __restrict__ scale,
                                     long long n, int m, int rows_per_tile,
                                     long long rows_per_block,
                                     unsigned long long* __restrict__ packed,
                                     unsigned* __restrict__ ticket,
                                     int* __restrict__ cand,
                                     float* __restrict__ best_out) {
  extern __shared__ unsigned char smem[];
  const int tile = blockDim.x * V;
  float* sv = reinterpret_cast<float*>(smem);
  int* si = reinterpret_cast<int*>(sv + tile);
  __shared__ bool is_last;
  const int t = threadIdx.x;
  const long long r0 = blockIdx.x * rows_per_block;
  // rows of this block, and its plane and mask from its first row: the
  // offsets inside a block fit 32 bits
  const int rows = (int)min(rows_per_block, n - r0);
  const T* plane = snr + r0 * m + t * V;
  // the block's mask bytes, staged once in shared memory after the pairs
  uint8_t* rem_rows = reinterpret_cast<uint8_t*>(si + tile);
  for (int r = t; r < rows; r += blockDim.x) rem_rows[r] = remaining[r0 + r];
  __syncthreads();
  int drow[V];
  float sc[V], best[V];
  int bidx[V];
  init_entries<V>(t, m, scale, drow, sc, best, bidx);
  // one mask byte serves the word when its V codes share a row
  const bool one_row = drow[0] == drow[V - 1];
  const int step = kTilesInFlight * rows_per_tile;
  for (int tr = 0; tr < rows; tr += step) {
    unsigned rem[kTilesInFlight], w[kTilesInFlight];
#pragma unroll
    for (int u = 0; u < kTilesInFlight; ++u) {  // the mask, then the codes
      const int r = tr + u * rows_per_tile;
      if (one_row) {
        rem[u] = r + drow[0] < rows && rem_rows[r + drow[0]] ? (1u << V) - 1u
                                                             : 0u;
      } else {
        rem[u] = 0;
#pragma unroll
        for (int p = 0; p < V; ++p)
          rem[u] |= (r + drow[p] < rows && rem_rows[r + drow[p]] ? 1u : 0u)
                    << p;
      }
    }
#pragma unroll
    for (int u = 0; u < kTilesInFlight; ++u) {  // rows not remaining: not read
      const int r = tr + u * rows_per_tile;
      const T* at = plane + (long long)r * m;
      w[u] = 0;
      if (rem[u]) {
        if (r + drow[V - 1] < rows) {
          w[u] = load_word<T, V>(at);
        } else {  // the word runs past the block's last row
          int valid = 0;
#pragma unroll
          for (int p = 0; p < V; ++p) valid += r + drow[p] < rows;
          w[u] = load_partial<T, V>(at, valid);
        }
      }
    }
    fold_tiles<T, V>(w, rem, sc, tr, rows_per_tile, drow, best, bidx);
  }
#pragma unroll
  for (int p = 0; p < V; ++p) {
    sv[t * V + p] = best[p];
    si[t * V + p] = bidx[p] == INT_MAX ? INT_MAX : (int)(r0 + bidx[p]);
  }
  merge_tile_rows(sv, si, m, rows_per_tile, t);
  // One block writes directly.  The launcher sends such planes to
  // masked_argmax_one_block, but this exit stays: without it nvcc
  // schedules the float32 scan above slower on sm_90a (a card A/B at
  // [1e6, 100], PERF.md: 0.139 against 0.111 ms).
  if (gridDim.x == 1) {
    write_result(sv, si, m, t, cand, best_out);
    return;
  }
  for (int c = t; c < m; c += blockDim.x) {
    const unsigned long long key =
        ((unsigned long long)ordered_key(sv[c]) << 32) | (unsigned)~si[c];
    atomicMax(packed + (long long)c * kKeyStride, key);
  }
  __threadfence();
  __syncthreads();
  if (t == 0) is_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int c = t; c < m; c += blockDim.x) {
    const unsigned long long key =
        atomicExch(packed + (long long)c * kKeyStride, 0ull);
    const int idx = (int)~(unsigned)key;
    cand[c] = idx == INT_MAX ? 0 : idx;
    best_out[c] = key_value((unsigned)(key >> 32));
  }
  if (t == 0) *ticket = 0;
}

// The whole plane in one block (N x M up to a block's entries; DAGSA's
// [50, 8]): the mask from global memory and every code word in range, so
// both loads are in flight together, then the same merge, and the result
// written directly.  No workspace.
template <typename T, int V>
__global__ void masked_argmax_one_block(const T* __restrict__ snr,
                                        const uint8_t* __restrict__ remaining,
                                        const float* __restrict__ scale,
                                        int n, int m, int rows_per_tile,
                                        int* __restrict__ cand,
                                        float* __restrict__ best_out) {
  extern __shared__ unsigned char smem[];
  const int tile = blockDim.x * V;
  float* sv = reinterpret_cast<float*>(smem);
  int* si = reinterpret_cast<int*>(sv + tile);
  const int t = threadIdx.x;
  int drow[V];
  float sc[V], best[V];
  int bidx[V];
  init_entries<V>(t, m, scale, drow, sc, best, bidx);
  const int step = kTilesInFlight * rows_per_tile;
  for (int tr = 0; tr < n; tr += step) {
    unsigned rem[kTilesInFlight], w[kTilesInFlight];
#pragma unroll
    for (int u = 0; u < kTilesInFlight; ++u) {
      const int r = tr + u * rows_per_tile;
      rem[u] = 0;
#pragma unroll
      for (int p = 0; p < V; ++p)
        rem[u] |= (r + drow[p] < n && remaining[r + drow[p]] ? 1u : 0u) << p;
    }
#pragma unroll
    for (int u = 0; u < kTilesInFlight; ++u) {
      const int r = tr + u * rows_per_tile;
      w[u] = 0;
      if (r + drow[0] < n) {
        const T* at = snr + (long long)r * m + t * V;
        if (r + drow[V - 1] < n) {
          w[u] = load_word<T, V>(at);
        } else {  // the word runs past the last row
          int valid = 0;
#pragma unroll
          for (int p = 0; p < V; ++p) valid += r + drow[p] < n;
          w[u] = load_partial<T, V>(at, valid);
        }
      }
    }
    fold_tiles<T, V>(w, rem, sc, tr, rows_per_tile, drow, best, bidx);
  }
#pragma unroll
  for (int p = 0; p < V; ++p) {
    sv[t * V + p] = best[p];
    si[t * V + p] = bidx[p];
  }
  merge_tile_rows(sv, si, m, rows_per_tile, t);
  write_result(sv, si, m, t, cand, best_out);
}

template <typename T, int V>
int launch_masked(const T* snr, const uint8_t* remaining, const float* scale,
                  long long n, int m, int threads, int rows_per_tile,
                  long long rows_per_block, void* workspace, int* cand,
                  float* best, cudaStream_t s) {
  if ((long long)threads * V != (long long)rows_per_tile * m ||
      rows_per_block % (kTilesInFlight * rows_per_tile))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + rows_per_block - 1) / rows_per_block;
  if (blocks > 1 && !workspace)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* packed = static_cast<unsigned long long*>(workspace);
  auto* ticket = reinterpret_cast<unsigned*>(packed + (long long)m * kKeyStride);
  if (blocks == 1) {
    masked_argmax_one_block<T, V>
        <<<1, threads, (size_t)threads * V * (sizeof(float) + sizeof(int)),
           s>>>(snr, remaining, scale, (int)n, m, rows_per_tile, cand, best);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem =
      (size_t)threads * V * (sizeof(float) + sizeof(int)) + rows_per_block;
  if (smem > 48 * 1024) {  // few BSs: many rows a block (M = 1: 64 KB)
    const cudaError_t err =
        repro_torch::allow_smem(masked_argmax_kernel<T, V>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  masked_argmax_kernel<T, V><<<(unsigned)blocks, threads, smem, s>>>(
      snr, remaining, scale, n, m, rows_per_tile, rows_per_block, packed,
      ticket, cand, best);
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------------------------------- best_bs_argmax
constexpr int kRowThreads = 256;

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

// snr [n, m] of the entry's type, remaining [n], scale [m] or null;
// `vec`: one 4-byte load of V codes (snr 4-byte aligned), else one code a
// load; threads, rows_per_tile and rows_per_block as
// select_topk.py:masked_bs_plan gives them; workspace: 16 m + 1 zeroed
// 8-byte words (the packed keys, 128 bytes apart, and the ticket), unused
// by one block.
#define MASKED_ENTRY(NAME, T)                                                \
  extern "C" int NAME(const T* snr, int vec, const uint8_t* remaining,     \
                      const float* scale, long long n, int m, int threads, \
                      int rows_per_tile, long long rows_per_block,         \
                      void* workspace, int* cand, float* best,             \
                      void* stream) {                                      \
    const cudaStream_t s = static_cast<cudaStream_t>(stream);              \
    return vec ? launch_masked<T, Word<T>::V>(                             \
                     snr, remaining, scale, n, m, threads, rows_per_tile,  \
                     rows_per_block, workspace, cand, best, s)             \
               : launch_masked<T, 1>(snr, remaining, scale, n, m, threads, \
                                     rows_per_tile, rows_per_block,        \
                                     workspace, cand, best, s);            \
  }
MASKED_ENTRY(masked_bs_argmax_f32, float)
MASKED_ENTRY(masked_bs_argmax_bf16, __nv_bfloat16)
MASKED_ENTRY(masked_bs_argmax_i8, int8_t)
#undef MASKED_ENTRY

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
