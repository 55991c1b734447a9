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
// call captured into a CUDA graph gets one of its own).  A fleet of F
// problems ([F, N, M] planes, DAGSA's batched greedy) is one launch too:
// grid axis y is the problem (the one-block kernel: one block a problem),
// and each problem has its own keys and ticket in the workspace, so a
// problem's last block is the last of its own blocks.
//
// best_bs_argmax.  The TPU kernel (`_rowmax_kernel`) takes a block of user
// rows, multiplies each by the per-BS scale row (ones without one) and
// reduces it along its M columns.  The SNR is float32, bfloat16 or int8
// dB codes; a value is f32(code) * scale[col], one float32 multiply
// before any compare, since dequantisation keeps order only within a
// column.  A block stages the scale row in shared memory when there is
// one.  A fleet of F planes [F, N, M] is one launch: grid axis y is the
// problem, so a block reads one problem's rows and scale row, and problem
// f's plane starts f N M codes past the first (its own offset from 16
// bytes, which the row arithmetic below takes as it comes).  One kernel serves the three types: a group of G lanes (a power of
// two <= 32) takes one row, so the 32 / G rows a warp holds are
// neighbours in the plane, and lane j reads the row's 16-byte words j, j +
// G, ... of the plane (4, 8 or 16 codes each), C words for each of U rows
// (C * U = 4) before it compares any, keeping the first maximum of what it
// reads.  The wrapper passes the plane's base rounded down to 16 bytes and
// the codes before the plane in that first word, so a plane that is not
// 16-byte aligned is read in place; a row that does not start on 16 bytes
// shares its first and last word with its neighbours (L1 serves them), a
// code outside the row is skipped, and the plane's last word, which may
// run past the plane, is read code by code.  The group then merges under
// (value descending, index ascending), so ties go to the lowest column as
// in jnp.argmax: a whole warp by two redux.sync reductions (the largest
// value as an order-preserving integer key, then the lowest column holding
// it), a smaller group by xor shuffles.  A merge costs the warp the same
// shuffles whether it serves one row or 32 / G, so G is as small as the
// four words a lane allow: a quarter of a row's words.  The wrapper picks
// G, C and U (select_topk.py:best_bs_plan).  A row of -inf gives 0, as
// torch.argmax does.
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

// A problem's region of the workspace, in 8-byte words: its M keys, then
// its ticket, each on its own 128-byte line.
__host__ __device__ __forceinline__ long long problem_words(int m) {
  return (long long)(m + 1) * kKeyStride;
}

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

// Block (b, f) takes rows [b * rows_per_block, ...) of problem f, a
// multiple of kTilesInFlight tiles of rows_per_tile rows; blockDim.x * V
// == rows_per_tile * m.  Dynamic shared memory: blockDim.x * V (value,
// index) pairs, then the block's mask bytes.  Problem f's keys (a
// column's key every kKeyStride words) and ticket lie in its region of
// `work` (problem_words(m) words), zero between calls; its "last block"
// is the last of its own gridDim.x blocks.
template <typename T, int V>
__global__ void masked_argmax_kernel(const T* __restrict__ snr,
                                     const uint8_t* __restrict__ remaining,
                                     const float* __restrict__ scale,
                                     long long n, int m, int rows_per_tile,
                                     long long rows_per_block,
                                     unsigned long long* __restrict__ work,
                                     int* __restrict__ cand,
                                     float* __restrict__ best_out) {
  extern __shared__ unsigned char smem[];
  // this block's problem: its plane, mask, scale row, outputs and region
  const long long f = blockIdx.y;
  snr += f * n * m;
  remaining += f * n;
  if (scale) scale += f * m;
  cand += f * m;
  best_out += f * m;
  unsigned long long* packed = work + f * problem_words(m);
  unsigned* ticket =
      reinterpret_cast<unsigned*>(packed + (long long)m * kKeyStride);
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
// [50, 8]), one block a problem (block f takes problem f): the mask from
// global memory and every code word in range, so both loads are in flight
// together, then the same merge, and the result written directly.  No
// workspace.
template <typename T, int V>
__global__ void masked_argmax_one_block(const T* __restrict__ snr,
                                        const uint8_t* __restrict__ remaining,
                                        const float* __restrict__ scale,
                                        int n, int m, int rows_per_tile,
                                        int* __restrict__ cand,
                                        float* __restrict__ best_out) {
  extern __shared__ unsigned char smem[];
  const long long f = blockIdx.x;
  snr += f * n * m;
  remaining += f * n;
  if (scale) scale += f * m;
  cand += f * m;
  best_out += f * m;
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
                  long long n, int m, int fleet, int threads,
                  int rows_per_tile, long long rows_per_block,
                  void* workspace, int* cand, float* best, cudaStream_t s) {
  if ((long long)threads * V != (long long)rows_per_tile * m ||
      rows_per_block % (kTilesInFlight * rows_per_tile) || fleet < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + rows_per_block - 1) / rows_per_block;
  if (blocks > 1 && (!workspace || fleet > 65535))
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 1) {
    masked_argmax_one_block<T, V>
        <<<fleet, threads,
           (size_t)threads * V * (sizeof(float) + sizeof(int)), s>>>(
            snr, remaining, scale, (int)n, m, rows_per_tile, cand, best);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem =
      (size_t)threads * V * (sizeof(float) + sizeof(int)) + rows_per_block;
  if (smem > 48 * 1024) {  // few BSs: many rows a block (M = 1: 64 KB)
    const cudaError_t err =
        repro_torch::allow_smem(masked_argmax_kernel<T, V>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  masked_argmax_kernel<T, V>
      <<<dim3((unsigned)blocks, (unsigned)fleet), threads, smem, s>>>(
          snr, remaining, scale, n, m, rows_per_tile, rows_per_block,
          static_cast<unsigned long long*>(workspace), cand, best);
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

// The scale row in shared memory (sc), or nothing without one.
template <bool kScale>
__device__ __forceinline__ void stage_scale(const float* __restrict__ scale,
                                            int m, float* sc) {
  if constexpr (kScale) {
    for (int c = threadIdx.x; c < m; c += blockDim.x) sc[c] = scale[c];
    __syncthreads();
  }
}

// The 16-byte word w of the plane (from its 16-byte aligned base), as
// four 32-bit parts; the plane's last word code by code (it may run past
// the base's `total` codes), zeros past the end.
template <typename T>
__device__ __forceinline__ uint4 load_plane_word(const T* __restrict__ snr,
                                                 long long w,
                                                 long long total) {
  constexpr int W = 16 / sizeof(T);
  if ((w + 1) * W <= total) return __ldg(reinterpret_cast<const uint4*>(snr) + w);
  unsigned q[4] = {0u, 0u, 0u, 0u};
  for (int e = 0; e < W && w * W + e < total; ++e) {
    unsigned bits;
    if constexpr (sizeof(T) == 1) {
      bits = static_cast<uint8_t>(snr[w * W + e]);
    } else if constexpr (sizeof(T) == 2) {
      bits = __bfloat16_as_ushort(snr[w * W + e]);
    } else {
      bits = __float_as_uint(snr[w * W + e]);
    }
    q[e * sizeof(T) / 4] |= bits << (8 * ((e * sizeof(T)) % 4));
  }
  return make_uint4(q[0], q[1], q[2], q[3]);
}

// Folds the codes of one 16-byte word (parts q, code 0 at column cb) into
// a lane's running first maximum; kChecked skips the codes outside the row
// [0, m) (a word the row shares with a neighbour), else every code is in.
template <typename T, bool kScale, bool kChecked>
__device__ __forceinline__ void fold_word(const uint4& q, int cb, int m,
                                          const float* sc, float& best,
                                          int& bidx) {
  constexpr int P = 4 / sizeof(T);      // codes a 32-bit part
  const unsigned part[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    float x[P];
    Word<T>::unpack(part[h], x);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int c = cb + h * P + p;
      if (kChecked && (c < 0 || c >= m)) continue;
      const float y = kScale ? x[p] * sc[c] : x[p];
      if (y > best) {  // codes rise: the first maximum stays
        best = y;
        bidx = c;
      }
    }
  }
}

// G lanes a row, C 16-byte words a lane and pass, U rows a lane group.
// snr: the fleet's 16-byte aligned base, its first code `off` codes in;
// block (x, f) takes rows of problem f, whose plane starts f n m codes
// after that.
template <typename T, int G, int C, int U, bool kScale>
__global__ void __launch_bounds__(kRowThreads)
best_bs_kernel(const T* __restrict__ snr, int off,
               const float* __restrict__ scale, long long n, int m,
               int* __restrict__ out) {
  extern __shared__ float sc[];
  const long long f = blockIdx.y;
  if (kScale) scale += f * m;
  out += f * n;
  stage_scale<kScale>(scale, m, sc);
  constexpr int W = 16 / sizeof(T);     // codes a word
  constexpr int kPerLoad = 32 / G;
  const int lane = threadIdx.x & 31;
  const int j = lane & (G - 1);
  const long long warp =
      ((long long)blockIdx.x * kRowThreads + threadIdx.x) >> 5;
  const long long row0 = warp * (kPerLoad * U) + lane / G;
  const long long first = off + f * n * m;  // the problem's first code
  const long long total = off + (long long)gridDim.y * n * m;
  const int words_max = (m + W - 1) / W + 1;  // words a row touches, at most
  bool live[U];
  long long e0[U], w0[U];
  int nw[U];
  float best[U];
  int bidx[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long r = row0 + u * kPerLoad;
    live[u] = r < n;
    e0[u] = first + r * m;                // the row's first code
    w0[u] = e0[u] / W;                    // ... and its word
    nw[u] = static_cast<int>((e0[u] + m - 1) / W - w0[u] + 1);
    best[u] = -INFINITY;
    bidx[u] = m;                          // "no column yet": past every one
  }
  for (int k0 = j; k0 < words_max; k0 += C * G) {
    uint4 v[U][C];
#pragma unroll
    for (int u = 0; u < U; ++u) {  // every load issues before any compare
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const int wi = k0 + k * G;
        v[u][k] = live[u] && wi < nw[u]
                      ? load_plane_word<T>(snr, w0[u] + wi, total)
                      : make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int k = 0; k < C; ++k) {  // words and codes rise: first max
        const int wi = k0 + k * G;
        if (!(live[u] && wi < nw[u])) continue;
        const int cb = static_cast<int>((w0[u] + wi) * W - e0[u]);
        if (cb >= 0 && cb + W <= m)   // the word lies inside the row
          fold_word<T, kScale, false>(v[u][k], cb, m, sc, best[u], bidx[u]);
        else
          fold_word<T, kScale, true>(v[u][k], cb, m, sc, best[u], bidx[u]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = group_argmax<G>(best[u], bidx[u]);
    if (j == 0 && live[u]) out[row0 + u * kPerLoad] = i < m ? i : 0;
  }
}

template <typename T, int G, int C, int U, bool kScale>
int launch_best_bs(const T* snr, int off, const float* scale, long long n,
                   int m, int fleet, int* out, cudaStream_t s) {
  constexpr int kRowsPerBlock = kRowThreads / G * U;
  const long long blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  const size_t smem = kScale ? m * sizeof(float) : 0;
  best_bs_kernel<T, G, C, U, kScale>
      <<<dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(fleet)),
         kRowThreads, smem, s>>>(snr, off, scale, n, m, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kScale>
int best_bs(const T* snr, int off, const float* scale, long long n, int m,
            int fleet, int lanes, int chunks, int rows, int* out,
            cudaStream_t s) {
  if (chunks * rows != 4 || reinterpret_cast<uintptr_t>(snr) % 16 ||
      off < 0 || off >= static_cast<int>(16 / sizeof(T)) || fleet < 1 ||
      fleet > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
#define BEST_BS(G, C, U) \
  launch_best_bs<T, G, C, U, kScale>(snr, off, scale, n, m, fleet, out, s)
  if (lanes == 1) {
    switch (chunks) {
      case 1: return BEST_BS(1, 1, 4);
      case 2: return BEST_BS(1, 2, 2);
      case 4: return BEST_BS(1, 4, 1);
    }
  } else if (chunks == 4) {
    switch (lanes) {
      case 2: return BEST_BS(2, 4, 1);
      case 4: return BEST_BS(4, 4, 1);
      case 8: return BEST_BS(8, 4, 1);
      case 16: return BEST_BS(16, 4, 1);
      case 32: return BEST_BS(32, 4, 1);
    }
  }
#undef BEST_BS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// snr [fleet, n, m] of the entry's type, remaining [fleet, n], scale
// [fleet, m] or null, cand and best [fleet, m]; `vec`: one 4-byte load of
// V codes (every problem's plane 4-byte aligned), else one code a load;
// threads, rows_per_tile and rows_per_block as
// select_topk.py:masked_bs_plan gives them for one problem; workspace:
// fleet x 16 (m + 1) zeroed 8-byte words (a problem's packed keys, 128
// bytes apart, and its ticket), unused by one block a problem.
#define MASKED_ENTRY(NAME, T)                                                \
  extern "C" int NAME(const T* snr, int vec, const uint8_t* remaining,     \
                      const float* scale, long long n, int m, int fleet,   \
                      int threads, int rows_per_tile,                      \
                      long long rows_per_block, void* workspace,           \
                      int* cand, float* best, void* stream) {              \
    const cudaStream_t s = static_cast<cudaStream_t>(stream);              \
    return vec ? launch_masked<T, Word<T>::V>(                             \
                     snr, remaining, scale, n, m, fleet, threads,          \
                     rows_per_tile, rows_per_block, workspace, cand, best, \
                     s)                                                    \
               : launch_masked<T, 1>(snr, remaining, scale, n, m, fleet,   \
                                     threads, rows_per_tile,               \
                                     rows_per_block, workspace, cand,      \
                                     best, s);                             \
  }
MASKED_ENTRY(masked_bs_argmax_f32, float)
MASKED_ENTRY(masked_bs_argmax_bf16, __nv_bfloat16)
MASKED_ENTRY(masked_bs_argmax_i8, int8_t)
#undef MASKED_ENTRY

// snr: the 16-byte aligned base of a [fleet, n, m] plane of the entry's
// type that starts `off` codes in (0 <= off < 16 / size); scale [fleet,
// m] or null; out [fleet, n]; lanes = G, chunks = C, rows = U as
// select_topk.py:best_bs_plan gives them: C * U = 4, and C = 4 when G > 1.
#define BEST_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(const T* snr, int off, const float* scale,            \
                      long long n, int m, int fleet, int lanes, int chunks, \
                      int rows, int* out, void* stream) {                   \
    const cudaStream_t s = static_cast<cudaStream_t>(stream);               \
    return scale ? best_bs<T, true>(snr, off, scale, n, m, fleet, lanes,    \
                                    chunks, rows, out, s)                   \
                 : best_bs<T, false>(snr, off, scale, n, m, fleet, lanes,   \
                                     chunks, rows, out, s);                 \
  }
BEST_ENTRY(best_bs_argmax_f32, float)
BEST_ENTRY(best_bs_argmax_bf16, __nv_bfloat16)
BEST_ENTRY(best_bs_argmax_i8, int8_t)
#undef BEST_ENTRY
