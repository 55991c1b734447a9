// Batched Eq. (11) root: one t_k^* per row of a [K, U] problem.
//
// Replaces the Pallas TPU kernel `_bw_kernel` / `bandwidth_solve` in
// src/repro/kernels/bandwidth_solve.py.  Each row k solves
//
//     sum_{i: mask[k,i]} coeff[k,i] / (t - tcomp[k,i]) = bw[k]
//
// by the safeguarded Newton iteration (16 steps) or bisection (60 halvings)
// of repro.core.bandwidth, with the bracket
// [clip(lo, tmax, hi), tmax + sum(c)/bw + 1e-9] and 0 for an empty row.
// tcomp may be shared by all rows: a row stride of 0 reads one [U] vector,
// so DAGSA never broadcasts it to [M, N].
//
// What bounds it on the H100.  The solve is 17 dependent passes over a
// row (one set-up pass for the bracket, then one per iteration), each
// ending in a sum over the row.  At DAGSA's shapes ([8, 50]; [1, U] for
// the host greedy) the row is a few hundred bytes and the time is the
// latency of 17 reductions and 16 divisions.  At a fleet row ([100, 1e6],
// 5 bytes a user) re-reading the row from HBM 17 times costs 17 x 500 MB
// / 3.35 TB/s = 2.54 ms, 17x the bytes-once bound; only the masked-in
// users, kept on chip or in L2, beat that.  The wrapper
// (kernels/bandwidth_solve.py:bandwidth_plan) picks one of two kernels:
//
//   * warp path (U <= 256): one warp a row, four rows a block.  Each lane
//     loads its users' c, tc and mask once into registers (masked-out
//     users as c = 0, which adds exactly 0); an iteration is the lane's
//     partial sums and 5 xor shuffles a sum.  No shared memory, no block
//     barrier.  The xor butterfly gives every lane the same bits, so the
//     solver state is warp-uniform.
//   * cluster path: a row split into `slices` slices, one block of 512
//     threads each, the blocks of a row one thread-block cluster (slices
//     = 1: one block a row, the medium rows; the plan keeps K x slices
//     within two blocks an SM, so a row's blocks run at once).  Loads are
//     wide (8 mask bytes, then the 16-byte c and tc of the 4-user groups
//     that hold a masked-in user; the next mask already in flight) when U
//     is a multiple of 8 and the bases are 16-byte aligned, else one user
//     a load.  The set-up pass compacts each warp's masked-in (c, tc)
//     pairs (a scan over the warp's lanes; no prefix sum across warps)
//     into the warp's region of shared memory (96 KB a block) and, past
//     its capacity, into a global spill region of fixed capacity (the
//     warp's users), so the 16 iterations read only masked-in pairs, eight
//     in flight a lane.  (A variant that re-read the slice every iteration
//     instead lost 2.1-9.8x to the compacted pairs in a card sweep at the
//     fleet rows; PERF.md keeps its numbers.)  Each sum goes warp (xor
//     shuffles) -> block (shared memory, fixed warp order) -> cluster (each
//     block's totals read over distributed shared memory in rank order),
//     so every block holds the same bits and the result is the same from
//     run to run.
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpRows = 4;         // rows (one a warp) of a warp-path block
constexpr int kThreads = 512;        // threads of a cluster-path block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSlices = 8;        // a portable cluster

__device__ __forceinline__ float warp_allsum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_allmax(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// One user's terms: c / (t - tc) and its slope c / (t - tc)^2.
__device__ __forceinline__ void add_terms(float t, float c, float tc,
                                          float& fs, float& ds) {
  const float r = 1.0f / fmaxf(t - tc, 1e-12f);
  const float inv = c * r;
  fs += inv;
  ds += inv * r;
}

// The iteration of repro.core.bandwidth, given the row's reduced set-up
// values; `sums(t, fs, ds)` returns sum c r and sum c r^2 at t, the same
// in every thread that calls it.
template <typename Sums>
__device__ __forceinline__ float solve(float tmax, float csum, float b,
                                       float lo_hint, int iters, int bisect,
                                       Sums&& sums) {
  float hi = tmax + csum / fmaxf(b, 1e-12f) + 1e-9f;
  float lo = fminf(fmaxf(lo_hint, tmax), hi);
  float fs, ds;
  if (bisect) {
    for (int it = 0; it < iters; ++it) {
      const float mid = 0.5f * (lo + hi);
      sums(mid, fs, ds);
      const bool too_fast = fs - b > 0.0f;
      lo = too_fast ? mid : lo;
      hi = too_fast ? hi : mid;
    }
    return 0.5f * (lo + hi);
  }
  float t = hi;
  for (int it = 0; it < iters; ++it) {
    sums(t, fs, ds);
    const float f = fs - b, df = -ds;
    const bool below = f > 0.0f;  // t left of the root
    lo = below ? t : lo;
    hi = below ? hi : t;
    // f = 0 (converged) would take the IEEE division's slow path; its
    // quotient is 0 and t - 0 = t either way
    const float step = f != 0.0f ? f / fminf(df, -1e-12f) : 0.0f;
    const float t_newton = t - step;
    const bool safe = (t_newton > lo) && (t_newton < hi);
    t = safe ? t_newton : 0.5f * (lo + hi);
  }
  return t;
}

// ---------------------------------------------------------- warp path ---
// V users a lane (user lane + 32 v), V * 32 >= u.
template <int V>
__global__ void __launch_bounds__(kWarpRows * 32)
bw_warp_kernel(const float* __restrict__ coeff,
               const float* __restrict__ tcomp, long long tc_stride,
               const uint8_t* __restrict__ mask, const float* __restrict__ bw,
               const float* __restrict__ lo_hint, float* __restrict__ out,
               int k, int u, int iters, int bisect) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  if (row >= k) return;  // the whole warp: no barrier follows
  const float* c_row = coeff + row * u;
  const float* tc_row = tcomp + row * tc_stride;
  const uint8_t* m_row = mask + row * u;
  const float b = bw[row], lo0 = lo_hint[row];
  float c[V], tc[V];
  float cnt = 0.0f, csum = 0.0f, tmax = -INFINITY;
  bool in[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {  // c, tc and the mask loads all in flight
    const int i = lane + 32 * v;
    in[v] = i < u && m_row[i];
    c[v] = i < u ? c_row[i] : 0.0f;
    tc[v] = i < u ? tc_row[i] : 0.0f;
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    c[v] = in[v] ? c[v] : 0.0f;  // masked out: adds exactly 0
    tc[v] = in[v] ? tc[v] : 0.0f;
    cnt += in[v] ? 1.0f : 0.0f;
    csum += c[v];
    tmax = in[v] ? fmaxf(tmax, tc[v]) : tmax;
  }
  cnt = warp_allsum(cnt);
  csum = warp_allsum(csum);
  tmax = warp_allmax(tmax);
  const bool any_user = cnt > 0.0f;
  const float t = solve(
      any_user ? tmax : 0.0f, csum, b, lo0, iters, bisect,
      [&](float at, float& fs, float& ds) {
        float a = 0.0f, d = 0.0f;
#pragma unroll
        for (int v = 0; v < V; ++v) add_terms(at, c[v], tc[v], a, d);
        fs = warp_allsum(a);
        ds = warp_allsum(d);
      });
  if (lane == 0) out[row] = any_user ? t : 0.0f;
}

// ------------------------------------------------------- cluster path ---
// One 16-byte read of a streamed row: no L1 line kept for it.
__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 r;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}

__device__ __forceinline__ float4 as_float4(uint4 q) {
  return make_float4(__uint_as_float(q.x), __uint_as_float(q.y),
                     __uint_as_float(q.z), __uint_as_float(q.w));
}

// One 8-byte read of a streamed row's mask.
__device__ __forceinline__ uint2 ld_stream8(const void* p) {
  uint2 r;
  asm volatile("ld.global.nc.L1::no_allocate.v2.u32 {%0,%1}, [%2];"
               : "=r"(r.x), "=r"(r.y)
               : "l"(p));
  return r;
}

// E users [i0, i0 + E) of a row: bit e of `bits` says user i0 + e is
// masked in; c and tc hold it where it is.  kVec: E = 8, i0 a multiple of
// 8 and i0 + 8 <= the slice's end (U % 8 == 0, 16-byte aligned bases).
// The mask word is loaded apart (`mask_at`), one unit ahead, so a thread
// waits on one load latency a unit, not on the mask and then c.
template <bool kVec>
struct Unit {
  static constexpr int E = kVec ? 8 : 1;
  using Mask = std::conditional_t<kVec, uint2, unsigned>;
  float c[E], tc[E];
  unsigned bits;

  static __device__ __forceinline__ Mask mask_at(const uint8_t* m_row,
                                                 long long i0) {
    if constexpr (kVec) {
      return ld_stream8(m_row + i0);
    } else {
      return m_row[i0];
    }
  }

  __device__ __forceinline__ void load(const float* c_row,
                                       const float* tc_row, Mask mk,
                                       long long i0) {
    if constexpr (kVec) {
      const unsigned words[2] = {mk.x, mk.y};
      bits = 0;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        // bool bytes are 0 or 1: gather the four into bits 24..27
        const unsigned nib = ((words[q] & 0x01010101u) * 0x01020408u) >> 24;
        bits |= nib << (4 * q);
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if ((bits >> (4 * q)) & 0xFu) {  // only groups with a user
          const float4 cv = as_float4(ld_stream(c_row + i0 + 4 * q));
          const float4 tv = __ldg(reinterpret_cast<const float4*>(
              tc_row + i0 + 4 * q));
          c[4 * q] = cv.x, c[4 * q + 1] = cv.y, c[4 * q + 2] = cv.z,
          c[4 * q + 3] = cv.w;
          tc[4 * q] = tv.x, tc[4 * q + 1] = tv.y, tc[4 * q + 2] = tv.z,
          tc[4 * q + 3] = tv.w;
        }
      }
    } else {
      bits = mk ? 1u : 0u;
      if (bits) {
        c[0] = c_row[i0];
        tc[0] = tc_row[i0];
      }
    }
  }
};

// Walks a block's units, thread tid taking units tid, tid + kThreads, ...
// with the next unit's mask in flight; `body(x)` sees each loaded unit
// (x.bits = 0 past the slice, where every thread of the block still
// calls it: the loop count is block-uniform).
template <bool kVec, typename Body>
__device__ __forceinline__ void for_units(const float* c_row,
                                          const float* tc_row,
                                          const uint8_t* m_row,
                                          long long beg, long long n_units,
                                          int tid, Body&& body) {
  using U = Unit<kVec>;
  using Mask = typename U::Mask;
  Mask next{};
  if (tid < n_units) next = U::mask_at(m_row, beg + (long long)tid * U::E);
  for (long long jb = 0; jb < n_units; jb += kThreads) {
    const long long j = jb + tid;
    const Mask mk = next;
    if (j + kThreads < n_units)
      next = U::mask_at(m_row, beg + (j + kThreads) * U::E);
    U x;
    x.bits = 0;
    if (j < n_units) x.load(c_row, tc_row, mk, beg + j * U::E);
    body(x);
  }
}

// Eight pairs' terms at once: the eight reciprocals are independent, then
// the sums take them in order.
__device__ __forceinline__ void add_pairs8(float t, const float2 (&q)[8],
                                           float& fs, float& ds) {
  float r[8], inv[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    r[e] = 1.0f / fmaxf(t - q[e].y, 1e-12f);
    inv[e] = q[e].x * r[e];
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    fs += inv[e];
    ds += inv[e] * r[e];
  }
}

// Grid k * slices blocks; the `slices` blocks of a row are one cluster
// (dims slices x 1 x 1), whose block rank is the slice.  Block `rank`
// takes users [rank * slice, min(u, (rank + 1) * slice)).  Warp w keeps
// its first smem_per_warp masked-in pairs in its region of the dynamic
// shared memory, the rest at spill + (block * kWarps + w) *
// spill_per_warp.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
bw_cluster_kernel(const float* __restrict__ coeff,
                  const float* __restrict__ tcomp, long long tc_stride,
                  const uint8_t* __restrict__ mask,
                  const float* __restrict__ bw,
                  const float* __restrict__ lo_hint, float* __restrict__ out,
                  long long u, int slices, long long slice, int iters,
                  int bisect, int smem_per_warp,
                  long long spill_per_warp, float2* __restrict__ spill) {
  using U = Unit<kVec>;
  constexpr int E = U::E;
  extern __shared__ float2 pairs[];
  __shared__ float4 red[2][kWarps];  // warp partials, double-buffered
  __shared__ float4 tot[2];          // the block's totals, read by the cluster
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = (int)(blockIdx.x % (unsigned)slices);
  const long long row = blockIdx.x / (unsigned)slices;
  const long long beg = rank * slice, end = min(u, beg + slice);
  const long long n_units = end > beg ? (end - beg + E - 1) / E : 0;
  const float* c_row = coeff + row * u;
  const float* tc_row = tcomp + row * tc_stride;
  const uint8_t* m_row = mask + row * u;
  float2* my_pairs = pairs + warp * smem_per_warp;
  float2* my_spill = spill + ((long long)blockIdx.x * kWarps + warp) *
                                 spill_per_warp;

  // Sums (x, y) and, kMax, the max of z over the row's blocks in a fixed
  // order; every thread of the cluster gets the same bits.  Warp (xor
  // shuffles) -> block (warp 0 over the warps' partials) -> cluster (lane r
  // of every warp reads block r's totals; a butterfly over the slices'
  // lanes, then lane 0's bits to all).  One block: no cluster barrier.
  int parity = 0;
  auto reduce = [&](float x, float y, float z, auto max_tag) -> float4 {
    constexpr bool kMax = decltype(max_tag)::value;
    x = warp_allsum(x);
    y = warp_allsum(y);
    if constexpr (kMax) z = warp_allmax(z);
    if (lane == 0) red[parity][warp] = make_float4(x, y, z, 0.0f);
    __syncthreads();
    if (warp == 0) {
      const float4 p = lane < kWarps ? red[parity][lane]
                                     : make_float4(0.0f, 0.0f, -INFINITY, 0.0f);
      const float a = warp_allsum(p.x), b = warp_allsum(p.y),
                  m = kMax ? warp_allmax(p.z) : 0.0f;
      if (lane == 0) tot[parity] = make_float4(a, b, m, 0.0f);
    }
    float4 q;
    if (slices == 1) {
      __syncthreads();
      q = tot[parity];
    } else {
      cluster.sync();
      q = lane < slices ? *cluster.map_shared_rank(&tot[parity], lane)
                        : make_float4(0.0f, 0.0f, -INFINITY, 0.0f);
      for (int o = 1; o < slices; o <<= 1) {
        q.x += __shfl_xor_sync(kFull, q.x, o);
        q.y += __shfl_xor_sync(kFull, q.y, o);
        if constexpr (kMax) q.z = fmaxf(q.z, __shfl_xor_sync(kFull, q.z, o));
      }
      q.x = __shfl_sync(kFull, q.x, 0);
      q.y = __shfl_sync(kFull, q.y, 0);
      if constexpr (kMax) q.z = __shfl_sync(kFull, q.z, 0);
    }
    parity ^= 1;
    return q;
  };

  // -- set-up pass: count, sum of c, max tc; compact the pairs ----------
  float cnt = 0.0f, csum = 0.0f, tmax = -INFINITY;
  int n_pairs = 0;  // warp-uniform
  for_units<kVec>(c_row, tc_row, m_row, beg, n_units, tid, [&](const U& x) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if ((x.bits >> e) & 1u) {
        cnt += 1.0f;
        csum += x.c[e];
        tmax = fmaxf(tmax, x.tc[e]);
      }
    }
    // the warp's pairs in lane order, then user order: a lane's first
    // pair goes after the pairs of the lanes below it
    const int mine = __popc(x.bits);
    int upto = mine;  // inclusive scan of the lanes' counts
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, upto, o);
      if (lane >= o) upto += v;
    }
    const int base = n_pairs + upto - mine;
    n_pairs += __shfl_sync(kFull, upto, 31);
    if (!x.bits) return;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if ((x.bits >> e) & 1u) {
        const int p = base + __popc(x.bits & ((1u << e) - 1u));
        const float2 pr = make_float2(x.c[e], x.tc[e]);
        if (p < smem_per_warp) {
          my_pairs[p] = pr;
        } else {
          my_spill[p - smem_per_warp] = pr;
        }
      }
    }
  });
  const float4 s = reduce(cnt, csum, tmax, std::true_type{});
  const bool any_user = s.x > 0.0f;

  const float t = solve(
      any_user ? s.z : 0.0f, s.y, bw[row], lo_hint[row], iters, bisect,
      [&](float at, float& fs, float& ds) {
        float a = 0.0f, d = 0.0f;
        // lane-strided pairs, eight in flight: shared memory, then the
        // spill (smem_per_warp is a multiple of 32, so p stays strided)
        int p = lane;
        const int on_chip = min(n_pairs, smem_per_warp);
        float2 q[8];
        for (; p + 224 < on_chip; p += 256) {
#pragma unroll
          for (int e = 0; e < 8; ++e) q[e] = my_pairs[p + 32 * e];
          add_pairs8(at, q, a, d);
        }
        for (; p < on_chip; p += 32) {
          const float2 q1 = my_pairs[p];
          add_terms(at, q1.x, q1.y, a, d);
        }
        const float2* sp = my_spill - smem_per_warp;
        for (; p + 224 < n_pairs; p += 256) {
#pragma unroll
          for (int e = 0; e < 8; ++e) q[e] = __ldcg(sp + p + 32 * e);
          add_pairs8(at, q, a, d);
        }
        for (; p < n_pairs; p += 32) {
          const float2 q1 = __ldcg(sp + p);
          add_terms(at, q1.x, q1.y, a, d);
        }
        const float4 r = reduce(a, d, 0.0f, std::false_type{});
        fs = r.x;
        ds = r.y;
      });
  if (rank == 0 && tid == 0) out[row] = any_user ? t : 0.0f;
  if (slices > 1) cluster.sync();  // no block leaves while read
}

template <int V>
cudaError_t launch_warp(const float* coeff, const float* tcomp,
                        long long tc_stride, const uint8_t* mask,
                        const float* bw, const float* lo, float* out, int k,
                        int u, int iters, int bisect, cudaStream_t s) {
  const int blocks = (k + kWarpRows - 1) / kWarpRows;
  bw_warp_kernel<V><<<blocks, kWarpRows * 32, 0, s>>>(
      coeff, tcomp, tc_stride, mask, bw, lo, out, k, u, iters, bisect);
  return cudaGetLastError();
}

template <bool kVec>
cudaError_t launch_cluster(const float* coeff, const float* tcomp,
                           long long tc_stride, const uint8_t* mask,
                           const float* bw, const float* lo, float* out,
                           int k, long long u, int iters, int bisect,
                           int slices, long long slice, int smem_per_warp,
                           long long spill_per_warp, float2* spill,
                           cudaStream_t s) {
  auto kernel = bw_cluster_kernel<kVec>;
  const size_t smem = (size_t)kWarps * smem_per_warp * sizeof(float2);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) err = repro_torch::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)k * (unsigned)slices);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)slices;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, coeff, tcomp, tc_stride, mask, bw,
                           lo, out, u, slices, slice, iters, bisect,
                           smem_per_warp, spill_per_warp, spill);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// One warp a row: `users_per_lane` users a lane, a power of two <= 8,
// with 32 * users_per_lane >= u.
extern "C" int bandwidth_solve_warp_f32(const float* coeff,
                                        const float* tcomp,
                                        long long tc_row_stride,
                                        const uint8_t* mask, const float* bw,
                                        const float* lo, float* out, int k,
                                        int u, int iters, int bisect,
                                        int users_per_lane, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 0) return static_cast<int>(cudaGetLastError());
  if (u > 32 * users_per_lane) return static_cast<int>(cudaErrorInvalidValue);
  switch (users_per_lane) {
    case 1: return launch_warp<1>(coeff, tcomp, tc_row_stride, mask, bw, lo,
                                  out, k, u, iters, bisect, s);
    case 2: return launch_warp<2>(coeff, tcomp, tc_row_stride, mask, bw, lo,
                                  out, k, u, iters, bisect, s);
    case 4: return launch_warp<4>(coeff, tcomp, tc_row_stride, mask, bw, lo,
                                  out, k, u, iters, bisect, s);
    case 8: return launch_warp<8>(coeff, tcomp, tc_row_stride, mask, bw, lo,
                                  out, k, u, iters, bisect, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// A cluster of `slices` blocks a row (a power of two, 1-8), `slice` users
// a block (a multiple of 8); `vec`: wide loads (u % 8 == 0, 16-byte
// aligned bases); the masked-in pairs go to `smem_per_warp` pairs of
// shared memory a warp (a multiple of 32) and `spill_per_warp` pairs a
// warp of `spill` ([k * slices * 16 warps, spill_per_warp]).
// kernels/bandwidth_solve.py:pair_capacity gives the two.
extern "C" int bandwidth_solve_cluster_f32(
    const float* coeff, const float* tcomp, long long tc_row_stride,
    const uint8_t* mask, const float* bw, const float* lo, float* out, int k,
    long long u, int iters, int bisect, int slices, long long slice, int vec,
    int smem_per_warp, long long spill_per_warp, void* spill, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 0) return static_cast<int>(cudaGetLastError());
  if (slices < 1 || slices > kMaxSlices || (slices & (slices - 1)) ||
      slice % 8 || (long long)slices * slice < u || smem_per_warp < 0 ||
      smem_per_warp % 32 || spill_per_warp < 0 ||
      (spill_per_warp > 0 && !spill))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto launch = vec ? launch_cluster<true> : launch_cluster<false>;
  return static_cast<int>(launch(coeff, tcomp, tc_row_stride, mask, bw, lo,
                                 out, k, u, iters, bisect, slices, slice,
                                 smem_per_warp, spill_per_warp,
                                 static_cast<float2*>(spill), s));
}
