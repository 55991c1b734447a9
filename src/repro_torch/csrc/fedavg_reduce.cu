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
// What bounds them on the H100: the [N, D] client plane, read once (4N
// bytes per column in f32, N in int8), for 2N flops per output column of
// fedavg_reduce and 2 nnz(w) per column of the segmented sum.  Memory,
// except for the segmented sum over a dense w with many BSs, where the
// flops (off the tensor cores) take over.
//
// fedavg_reduce has two paths, picked by the wrapper's plan
// (`reduce_plan` in repro_torch/kernels/fedavg_reduce.py):
//
// * "vector" (rows 16-byte aligned: base aligned and d a multiple of 4
//   float32 / 16 int8; and enough clients): a lane owns one 16-byte vector
//   of columns (4 float32 or 16 int8 codes) and keeps kRedLoads client rows
//   of loads in flight; a warp reads 512 contiguous bytes a row.  The
//   clients split into `splits` contiguous ranges (2 to 8), one block
//   each, so the [1000, 100352] fleet leaf runs 784 blocks of 128 threads
//   (float32, 4 splits) or 392 (int8, 8 splits) where one thread a column
//   had one 4-byte (1-byte) load in flight at a time.
//   The split blocks of a column block form one thread-block cluster:
//   each leaves its partial sums in shared memory, and after a cluster
//   barrier every block adds a slice of the columns over the cluster's
//   shared memory in split order.  One launch, no workspace, no atomics:
//   every column sums in the same order on every run.  int8 codes become
//   floats by a byte permute into the mantissa of 2^23 and one exact
//   subtraction (a float add), not by the quarter-rate integer convert.
// * "scalar" (any d, any base): one thread per column walks the clients
//   in index order.  It also takes the path's 50 clients: there the whole
//   plane sits in L2 and the vector path's fewer, longer threads lost.
//
// Both accumulate each client range in client order with fmaf, in
// float32.  At the [1000, 100352] fleet leaf the vector path needs the
// client plane's 401 MB (float32) or 100 MB (int8) in flight at HBM rate
// (~3 MB by Little's law at 3.35 TB/s): with about three blocks an SM
// resident, 132 x 3 x 128 lanes x 16 rows x 16 bytes is 13 MB.
//
// fedavg_segment_reduce: a block owns 512 columns (128 threads x 4
// columns, one float4 or char4 load per client row) and a tile of MT BS
// rows, the 4 x MT sums in registers; the grid covers (BS tile, column
// block) pairs, BS tiles fastest, so any M works and the tiles of one
// column block run side by side.  Clients are staged up to 1024 at a
// time: the block reads their w[n, m-tile] rows and lists, in client
// order (ballot + prefix), the clients with a nonzero weight in its tile,
// then walks only that list.  The path's w is one-hot per client (Eq. (8):
// a user has at most one BS; clip factors and dequant scales keep it so),
// so each client is walked by one BS tile and x is read once in all; a
// dense w does the work of every tile.  Skipping a zero weight changes no
// sum: x is screened to finite values, so fmaf(0, v, acc) == acc.  Two
// groups of 128 threads walk alternate list entries (twice the loads in
// flight), each in client order, and their sums are added in group order:
// deterministic, no atomics, no second pass.
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;     // fedavg_reduce: a column a thread
// fedavg_segment_reduce, shapes chosen on the H100 (chip_smoke.py's fleet
// rows): 4 columns a thread, 512 a block; two client groups of 128
// threads; 8 rows of x in flight a thread; two blocks an SM (128
// registers); 32 KB of staged w rows.
constexpr int kColThreads = 128;
constexpr int kCols = 4;
constexpr int kSegCols = kColThreads * kCols;
constexpr int kGroups = 2;
constexpr int kSegThreads = kColThreads * kGroups;
constexpr int kLoads = 8;
constexpr int kStagedFloats = 8192;

__device__ __forceinline__ float load_screened(const float* p) {
  const float v = *p;
  return isfinite(v) ? v : 0.0f;
}

__device__ __forceinline__ float load_screened(const int8_t* p) {
  return static_cast<float>(*p);  // int8 codes are always finite
}

// fedavg_reduce, "scalar" path: a column a thread, clients in order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fedavg_reduce_kernel(const float* __restrict__ w, const T* __restrict__ x,
                     long long n, long long d, float* __restrict__ out) {
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= d) return;
  float acc = 0.0f;
  for (long long i = 0; i < n; ++i)
    acc = fmaf(w[i], load_screened(x + i * d + col), acc);
  out[col] = acc;
}

// fedavg_reduce, "vector" path.  Shapes chosen on the H100 (PERF.md's
// sweep): 128 lanes a block, 16 client rows in flight a lane, the split's
// weights staged 1,024 at a time.
constexpr int kRedThreads = 128;
constexpr int kRedLoads = 16;
constexpr int kRedChunk = 1024;
constexpr int kMaxSplits = 8;  // a portable cluster

template <typename T>
struct VecOf;  // the columns of one 16-byte vector
template <>
struct VecOf<float> {
  static constexpr int kCols = 4;
};
template <>
struct VecOf<int8_t> {
  static constexpr int kCols = 16;
};

// acc[c] = fmaf(wi, screen(x_c), acc[c]) over one vector's columns.
__device__ __forceinline__ void accumulate_vec(float (&acc)[4], float wi,
                                               uint4 q) {
  const float v[4] = {__uint_as_float(q.x), __uint_as_float(q.y),
                      __uint_as_float(q.z), __uint_as_float(q.w)};
#pragma unroll
  for (int c = 0; c < 4; ++c)
    acc[c] = fmaf(wi, isfinite(v[c]) ? v[c] : 0.0f, acc[c]);
}

__device__ __forceinline__ void accumulate_vec(float (&acc)[16], float wi,
                                               uint4 q) {
  const unsigned words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // code c (two's complement) ^ 0x80 is c + 128 as a byte; under the
    // exponent of 2^23 that is the float 2^23 + 128 + c, exactly
    const unsigned biased = words[k] ^ 0x80808080u;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const float v = __uint_as_float(__byte_perm(biased, 0x4B000000u,
                                                  0x7540u + b)) -
                      8388736.0f;
      acc[4 * k + b] = fmaf(wi, v, acc[4 * k + b]);
    }
  }
}

// One 16-byte read of the client plane, read once: no L1 line kept for it
// (3.5% off the fleet rows in the card sweep).
__device__ __forceinline__ uint4 ld_stream(const uint4* p) {
  uint4 r;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}

// Grid (column blocks, splits); the `splits` blocks of a column block are
// one cluster (dims 1 x splits), whose block rank is the split index.
template <typename T>
__global__ void __launch_bounds__(kRedThreads)
fedavg_reduce_vec_kernel(const float* __restrict__ w, const T* __restrict__ x,
                         long long n, long long d, int splits,
                         float* __restrict__ out) {
  constexpr int V = VecOf<T>::kCols, U = kRedLoads;
  __shared__ float sw[kRedChunk];
  const int tid = threadIdx.x;
  const long long nvec = d / V;
  const long long vcol = (long long)blockIdx.x * kRedThreads + tid;
  const bool live = vcol < nvec;
  const long long per = (n + splits - 1) / splits;
  const long long r0 = min(n, (long long)blockIdx.y * per);
  const long long r1 = min(n, r0 + per);
  const uint4* xv = reinterpret_cast<const uint4*>(x) + vcol;

  float acc[V];
#pragma unroll
  for (int c = 0; c < V; ++c) acc[c] = 0.0f;
  for (long long c0 = r0; c0 < r1; c0 += kRedChunk) {
    const int cnt = (int)min((long long)kRedChunk, r1 - c0);
    __syncthreads();  // the previous chunk's weights are consumed
    for (int i = tid; i < cnt; i += kRedThreads) sw[i] = w[c0 + i];
    __syncthreads();
    if (!live) continue;
    const uint4* p = xv + c0 * nvec;
    int i = 0;
    for (; i + U <= cnt; i += U) {
      uint4 q[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        q[u] = ld_stream(p + (long long)(i + u) * nvec);
#pragma unroll
      for (int u = 0; u < U; ++u) accumulate_vec(acc, sw[i + u], q[u]);
    }
    for (; i < cnt; ++i)
      accumulate_vec(acc, sw[i], ld_stream(p + (long long)i * nvec));
  }

  // The partial sums of this split, column-major in the block's columns.
  __shared__ __align__(16) float part[kRedThreads * V];
  float4* pv = reinterpret_cast<float4*>(part + tid * V);
#pragma unroll
  for (int c = 0; c < V / 4; ++c)
    pv[c] = make_float4(acc[4 * c], acc[4 * c + 1], acc[4 * c + 2],
                        acc[4 * c + 3]);
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  // Block `rank` sums its slice of the block's columns over the splits,
  // in split order.
  const int rank = (int)cluster.block_rank();
  const int slice = kRedThreads * V / splits;
  const long long col0 = (long long)blockIdx.x * kRedThreads * V;
  for (int e = rank * slice + tid; e < (rank + 1) * slice; e += kRedThreads) {
    float total = *cluster.map_shared_rank(part + e, 0);
    for (int r = 1; r < splits; ++r)
      total += *cluster.map_shared_rank(part + e, r);
    if (col0 + e < d) out[col0 + e] = total;
  }
  cluster.sync();  // no block leaves while its partials are read
}

// Four screened columns [col, col + 4) of one client row as float32: one
// float4 / char4 load when rows are 16-byte (f32) or 4-byte (int8) aligned
// (the caller keeps col inside the row: no branch between the loads it
// keeps in flight), else guarded loads of single columns.
template <bool kVec>
__device__ __forceinline__ void load4(const float* row, long long col,
                                      long long d, float v[4]) {
  if (kVec) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(row + col));
    v[0] = isfinite(q.x) ? q.x : 0.0f;
    v[1] = isfinite(q.y) ? q.y : 0.0f;
    v[2] = isfinite(q.z) ? q.z : 0.0f;
    v[3] = isfinite(q.w) ? q.w : 0.0f;
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      v[c] = col + c < d ? load_screened(row + col + c) : 0.0f;
  }
}

template <bool kVec>
__device__ __forceinline__ void load4(const int8_t* row, long long col,
                                      long long d, float v[4]) {
  if (kVec) {
    const char4 q = __ldg(reinterpret_cast<const char4*>(row + col));
    v[0] = static_cast<float>(q.x);
    v[1] = static_cast<float>(q.y);
    v[2] = static_cast<float>(q.z);
    v[3] = static_cast<float>(q.w);
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      v[c] = col + c < d ? load_screened(row + col + c) : 0.0f;
  }
}

// acc[t][c] += wrow[t] * v[c]: one listed client into the 4 x MT sums.
template <int MT>
__device__ __forceinline__ void accumulate(float (&acc)[MT][kCols],
                                           const float* wrow,
                                           const float v[kCols]) {
#pragma unroll
  for (int t = 0; t < MT; t += 4) {
    const float4 w4 = *reinterpret_cast<const float4*>(wrow + t);
    const float ws[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        acc[t + u][c] = fmaf(ws[u], v[c], acc[t + u][c]);
  }
}

// Client group g walks list entries g, g + kGroups, ... (client order
// within the group) and the groups' sums are added in group order at the
// end.  Each thread stages R clients' w rows, kChunk clients a chunk.
template <typename T, int MT, bool kVec>
__global__ void __launch_bounds__(kSegThreads, 2)
fedavg_segment_reduce_kernel(const float* __restrict__ w,
                             const T* __restrict__ x, long long n, int m,
                             long long d, int n_tiles,
                             float* __restrict__ out) {
  constexpr int G = kGroups, U = kLoads, kBlock = kSegThreads;
  constexpr int kWarps = kBlock / 32, kChunk = kStagedFloats / MT;
  constexpr int R = kChunk / kBlock;
  __shared__ __align__(16) float sw[kChunk * MT];  // listed clients' w rows
  __shared__ int sidx[kChunk];                     // and their chunk offsets
  __shared__ int scount[kChunk / 32];              // listed per 32 clients
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ct = tid % kColThreads, grp = tid / kColThreads;
  const int m0 = (blockIdx.x % n_tiles) * MT;
  const long long col =
      (long long)(blockIdx.x / n_tiles) * kSegCols + ct * kCols;
  // Vector loads: columns past d read the row's last 4 (never stored).
  const long long lcol = kVec ? min(col, d - kCols) : col;

  float acc[MT][kCols];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[t][c] = 0.0f;

  for (long long c0 = 0; c0 < n; c0 += kChunk) {
    // List the chunk's clients with any nonzero weight in this tile, in
    // client order, with their w rows: thread tid stages clients
    // c0 + tid + kBlock * r, and 32-client slot r * kWarps + warp holds
    // clients (r * kWarps + warp) * 32 + lane.
    float wt[R][MT];
    unsigned ballot[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long i = c0 + tid + kBlock * r;
      bool any = false;
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        wt[r][t] = (i < n && m0 + t < m) ? w[i * m + m0 + t] : 0.0f;
        any |= wt[r][t] != 0.0f;
      }
      ballot[r] = __ballot_sync(0xffffffffu, any);
    }
    __syncthreads();  // the previous chunk's list is consumed
    if (lane == 0)
#pragma unroll
      for (int r = 0; r < R; ++r) scount[r * kWarps + warp] = __popc(ballot[r]);
    __syncthreads();
    int cnt = 0;
#pragma unroll
    for (int s = 0; s < kChunk / 32; ++s) cnt += scount[s];
    int base = 0;  // listed clients in the slots before this one
    for (int s = 0; s < warp; ++s) base += scount[s];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if ((ballot[r] >> lane) & 1u) {
        const int pos = base + __popc(ballot[r] & ((1u << lane) - 1u));
        sidx[pos] = tid + kBlock * r;
#pragma unroll
        for (int t = 0; t < MT; ++t) sw[pos * MT + t] = wt[r][t];
      }
      if (r + 1 < R)  // on to slot (r + 1) * kWarps + warp
        for (int s = r * kWarps + warp; s < (r + 1) * kWarps + warp; ++s)
          base += scount[s];
    }
    __syncthreads();

    // Walk this group's entries of the list, U rows of x in flight.
    const T* xc = x + c0 * d;
    int j = grp;
    for (; j + (U - 1) * G < cnt; j += U * G) {
      float v[U][kCols];
#pragma unroll
      for (int u = 0; u < U; ++u)
        load4<kVec>(xc + (long long)sidx[j + u * G] * d, lcol, d, v[u]);
#pragma unroll
      for (int u = 0; u < U; ++u)
        accumulate<MT>(acc, sw + (j + u * G) * MT, v[u]);
    }
    for (; j < cnt; j += G) {
      float v[kCols];
      load4<kVec>(xc + (long long)sidx[j] * d, lcol, d, v);
      accumulate<MT>(acc, sw + j * MT, v);
    }
  }

  // Add the groups' sums in group order, one BS row at a time (sw reused).
#pragma unroll
  for (int t = 0; t < MT; ++t) {
    if (G > 1) {
      __syncthreads();
      if (grp > 0)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          sw[((grp - 1) * kColThreads + ct) * kCols + c] = acc[t][c];
      __syncthreads();
      if (grp == 0)
        for (int g = 1; g < G; ++g)
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            acc[t][c] += sw[((g - 1) * kColThreads + ct) * kCols + c];
    }
    if (grp > 0 || m0 + t >= m) continue;
    float* o = out + (long long)(m0 + t) * d;
    if (kVec && col < d) {
      *reinterpret_cast<float4*>(o + col) =
          make_float4(acc[t][0], acc[t][1], acc[t][2], acc[t][3]);
    } else {
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        if (col + c < d) o[col + c] = acc[t][c];
    }
  }
}

// path: 0 "vector", 1 "scalar" (kernels/fedavg_reduce.py REDUCE_PATHS).
template <typename T>
int launch_reduce(const float* w, const T* x, long long n, long long d,
                  float* out, int path, int splits, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 0) return static_cast<int>(cudaGetLastError());
  if (path != 0) {
    const long long blocks = (d + kThreads - 1) / kThreads;
    fedavg_reduce_kernel<T><<<(unsigned)blocks, kThreads, 0, s>>>(w, x, n,
                                                                   d, out);
    return static_cast<int>(cudaGetLastError());
  }
  if (splits < 2 || splits > kMaxSplits || (splits & (splits - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nvec = d / VecOf<T>::kCols;
  const dim3 grid((unsigned)((nvec + kRedThreads - 1) / kRedThreads),
                  (unsigned)splits);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kRedThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = (unsigned)splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, fedavg_reduce_vec_kernel<T>, w, x, n, d, splits, out);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// MT = 8 covers the paper's 8 BSs in one tile; wider fleets take 16-row
// tiles in f32 (half the passes of a dense w over x) and stay at 8 rows in
// int8, where the 4 MT FMAs per 4-byte load bound a one-hot w.  Vector
// loads and stores when every row of x and out is aligned.
template <typename T, int MT>
void launch_segment_tiles(const float* w, const T* x, long long n, int m,
                          long long d, float* out, cudaStream_t stream) {
  const int n_tiles = (m + MT - 1) / MT;
  const long long blocks = (d + kSegCols - 1) / kSegCols * n_tiles;
  const bool vec = d % kCols == 0 &&
                   reinterpret_cast<uintptr_t>(x) % (kCols * sizeof(T)) ==
                       0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec)
    fedavg_segment_reduce_kernel<T, MT, true>
        <<<(unsigned)blocks, kSegThreads, 0, stream>>>(w, x, n, m, d,
                                                       n_tiles, out);
  else
    fedavg_segment_reduce_kernel<T, MT, false>
        <<<(unsigned)blocks, kSegThreads, 0, stream>>>(w, x, n, m, d,
                                                       n_tiles, out);
}

template <typename T>
int launch_segment(const float* w, const T* x, long long n, int m,
                   long long d, float* out, void* stream) {
  if (d > 0 && m > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (m <= 8)
      launch_segment_tiles<T, 8>(w, x, n, m, d, out, s);
    else
      launch_segment_tiles<T, sizeof(T) == 1 ? 8 : 16>(w, x, n, m, d, out,
                                                       s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fedavg_reduce_f32(const float* w, const float* x, long long n,
                                 long long d, float* out, int path,
                                 int splits, void* stream) {
  return launch_reduce<float>(w, x, n, d, out, path, splits, stream);
}

extern "C" int fedavg_reduce_i8(const float* w, const int8_t* x, long long n,
                                long long d, float* out, int path,
                                int splits, void* stream) {
  return launch_reduce<int8_t>(w, x, n, d, out, path, splits, stream);
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
