// RMSNorm over the last axis: out = (x * rsqrt(mean(x^2) + eps)) * scale.
//
// Replaces the Pallas TPU kernel `rmsnorm` in src/repro/kernels/rmsnorm.py
// (`_rmsnorm_kernel`), which the model's `layers.norm_apply` and
// `layers.rms_norm` compute.  x is [rows, d] in float32 or bfloat16, scale
// [d] in the same type; all math is float32 in the reference's order
// (rmsnorm.py:21-22, layers.py:34-35): the sum of squares, rsqrt(ss / d +
// eps), the product with r first and then the scale, and one rounding to
// x's type (to nearest even for bfloat16).
//
// What bounds it on the H100: one read of x and one write of out, two
// flops an element, so memory.  The TPU kernel loads a block of 256 rows
// into VMEM.  Here x is read from HBM once, in 16-byte vectors (8 bfloat16
// or 4 float32 a lane), and kept in registers between the sum and the
// scaled write.  The wrapper picks one of three paths (rmsnorm.py:
// rmsnorm_plan):
//   rows   (PATH_ROWS): a group of L lanes (a power of two <= 32) takes a
//          row, each lane VPL vectors of it in registers (VPL a template
//          parameter, <= 16: d <= 2048 float32, <= 4096 bfloat16), so
//          32 / L rows share a warp when d is small (the qk_norm rows of
//          64 or 128); the group sums by xor shuffles.  d a multiple of the
//          vector width, x and scale 16-byte aligned.
//   wide   (PATH_WIDE): one block a row, 16-byte vectors, a block sum, and
//          a second pass over the row (from L1/L2) for the write; for rows
//          past the register limit.
//   scalar (PATH_SCALAR): one warp a row, element loads, two passes; for d
//          not a multiple of the vector width or a base off 16-byte
//          alignment (a slice of a larger buffer).
// out is always 16-byte aligned: the wrapper allocates it.
//
// The backward (rmsnorm_bwd_*; the TPU has none: JAX differentiates its
// jnp norm, and the port's training path needs one on the card) takes x,
// scale and g = dL/dout and recomputes each row's r = rsqrt(mean(x^2) +
// eps), so the forward stays as it is:
//   dx     = r (g s) - x r^3 mean(g s x)
//   dscale = sum over rows of g x r
// Bound: x and g read once, dx written once (3 row arrays; dscale is one
// row), ~10 flops an element: memory.  The wrapper picks one of two routes
// (rmsnorm.py: rmsnorm_bwd_plan):
//   rows   (BWD_ROWS, rmsnorm_bwd_rows): one pass.  A group of 2^k threads
//          takes a row, each lane up to 4 16-byte vectors of it, as few
//          lanes as that allows (8 rows a warp at bfloat16 d = 128, a warp
//          at 1,024, 2 / 4 warps at 2,048 / 2,560, up to 16 warps: d <=
//          16,384 bfloat16, 8,192 float32).  A lane holds its vectors of
//          x, g and scale in registers (scale loaded once a block; x, g
//          and dx streamed with evict-first hints, __ldcs / __stcs), the
//          group sums ss and g s x by xor shuffles (and across its warps
//          through shared memory), writes dx from registers, and adds g x r
//          of its own columns into float32 accumulators.  The groups walk
//          the rows gid, gid + n_groups, ... in that order; a block of 256
//          threads (or one row's) then adds its groups' accumulators
//          through shared memory in group order into one partial row of
//          dscale (256 blocks at most, 16 rows a block at least).  Registers
//          (-Xptxas -v, sm_90a): bfloat16 64 / 84 / 128 / 128 at 1 / 2 / 3
//          / 4 vectors a lane, float32 49 / 64 / 95 / 124, no spills but
//          12 bytes at float32 2.  The write recomputes the unpacked
//          vectors from the packed words (`opaque`): kept from the sums,
//          they spilled 116 bytes at bfloat16 4.
//   scalar (BWD_SCALAR): a warp a row by element loads for dx and r
//          (rmsnorm_bwd_scalar), then the partial rows from x and g again
//          (rmsnorm_bwd_partial, 32 columns x 8 row lanes a block); for d
//          not a multiple of the vector width, a base off 16-byte alignment
//          (a slice of a larger buffer) or a row past the rows route.
// dscale is a column sum over every row, and float atomics would add in an
// order that changes from run to run; so rmsnorm_bwd_colsum adds the
// partial rows in a fixed order: two runs agree bit for bit, in two
// launches a call on the rows route.  (As a programmatic dependent launch
// it gained 0-4% of a call in a graph, about the spread, and the profiler
// then counts its wait as its time.)  Each shape's route, times and
// bound: PERF.md §6.
#include "common.cuh"

namespace {

enum Path { PATH_ROWS = 0, PATH_WIDE = 1, PATH_SCALAR = 2 };

constexpr int kRowsThreads = 128;
constexpr int kWideThreads = 256;
constexpr int kScalarWarps = 8;

// Unpacks and packs the entries of a 16-byte vector of T.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void unpack(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void unpack(const uint4& v, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(h[i]);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  __device__ static uint4 pack(const float* f) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    }
    return v;
  }
};

template <typename T>
__device__ __forceinline__ float sum_squares(const uint4& v) {
  float f[Vec<T>::kN];
  Vec<T>::unpack(v, f);
  float ss = 0.0f;
#pragma unroll
  for (int e = 0; e < Vec<T>::kN; ++e) ss = fmaf(f[e], f[e], ss);
  return ss;
}

// (v * r) * scale, rounded once to T.
template <typename T>
__device__ __forceinline__ uint4 scaled(const uint4& v, const uint4& s,
                                        float r) {
  float f[Vec<T>::kN], g[Vec<T>::kN];
  Vec<T>::unpack(v, f);
  Vec<T>::unpack(s, g);
#pragma unroll
  for (int e = 0; e < Vec<T>::kN; ++e) f[e] = (f[e] * r) * g[e];
  return Vec<T>::pack(f);
}

// PATH_ROWS: rows of nvec 16-byte vectors; a group of 2^lanes_log2 lanes a
// row, VPL vectors a lane.  A lane loads its scale vectors beside its row
// (their latency hides under the row's), so the write waits on nothing.
// One row a group and no grid-stride loop: on the card, warps that walked
// rows grid-stride, the next row loaded before the current one's write,
// measured slower at every shape.
template <typename T, int VPL>
__global__ void __launch_bounds__(kRowsThreads)
rmsnorm_rows(const uint4* __restrict__ x, const uint4* __restrict__ scale,
             uint4* __restrict__ out, long long rows, int nvec,
             int lanes_log2, int d, float eps) {
  const int lanes = 1 << lanes_log2;
  const int j = threadIdx.x & (lanes - 1);
  const long long row =
      ((long long)blockIdx.x * kRowsThreads + threadIdx.x) >> lanes_log2;
  const bool live = row < rows;
  const uint4* xr = x + row * nvec;
  uint4 v[VPL], sc[VPL];
#pragma unroll
  for (int k = 0; k < VPL; ++k) {  // every load issues before any use
    const int c = j + k * lanes;
    v[k] = live && c < nvec ? __ldg(xr + c) : make_uint4(0, 0, 0, 0);
    sc[k] = c < nvec ? __ldg(scale + c) : make_uint4(0, 0, 0, 0);
  }
  float ss = 0.0f;
#pragma unroll
  for (int k = 0; k < VPL; ++k) ss += sum_squares<T>(v[k]);
  for (int o = lanes >> 1; o > 0; o >>= 1) {  // every lane takes part
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  }
  if (!live) return;
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);
  uint4* orow = out + row * nvec;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int c = j + k * lanes;
    if (c < nvec) orow[c] = scaled<T>(v[k], sc[k], r);
  }
}

// PATH_WIDE: one block a row of nvec 16-byte vectors.
template <typename T>
__global__ void __launch_bounds__(kWideThreads)
rmsnorm_wide(const uint4* __restrict__ x, const uint4* __restrict__ scale,
             uint4* __restrict__ out, int nvec, int d, float eps) {
  __shared__ float sh[64];
  const uint4* xr = x + (long long)blockIdx.x * nvec;
  float ss = 0.0f, unused = 0.0f;
  for (int c = threadIdx.x; c < nvec; c += kWideThreads) {
    ss += sum_squares<T>(__ldg(xr + c));
  }
  repro_torch::block_sum2(ss, unused, sh);
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);
  uint4* orow = out + (long long)blockIdx.x * nvec;
  for (int c = threadIdx.x; c < nvec; c += kWideThreads) {
    orow[c] = scaled<T>(__ldg(xr + c), __ldg(scale + c), r);
  }
}

// PATH_SCALAR: one warp a row, element loads.
template <typename T>
__global__ void __launch_bounds__(kScalarWarps * 32)
rmsnorm_scalar(const T* __restrict__ x, const T* __restrict__ scale,
               T* __restrict__ out, long long rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kScalarWarps + (threadIdx.x >> 5);
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

template <typename T, int VPL>
void launch_rows(const uint4* x, const uint4* scale, uint4* out,
                 long long rows, int nvec, int lanes_log2, int d, float eps,
                 cudaStream_t s) {
  const long long threads = rows << lanes_log2;
  const long long blocks = (threads + kRowsThreads - 1) / kRowsThreads;
  rmsnorm_rows<T, VPL><<<static_cast<unsigned>(blocks), kRowsThreads, 0, s>>>(
      x, scale, out, rows, nvec, lanes_log2, d, eps);
}

template <typename T>
int launch(const T* x, const T* scale, T* out, long long rows, int d,
           float eps, int path, int lanes, int vpl, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kN = Vec<T>::kN;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* sv = reinterpret_cast<const uint4*>(scale);
  uint4* ov = reinterpret_cast<uint4*>(out);
  if (path == PATH_ROWS) {
    const int nvec = d / kN;
    if (d % kN || lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) ||
        (long long)lanes * vpl < nvec) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int lg = __builtin_ctz(lanes);
    switch (vpl) {
      case 1: launch_rows<T, 1>(xv, sv, ov, rows, nvec, lg, d, eps, s); break;
      case 2: launch_rows<T, 2>(xv, sv, ov, rows, nvec, lg, d, eps, s); break;
      case 4: launch_rows<T, 4>(xv, sv, ov, rows, nvec, lg, d, eps, s); break;
      case 8: launch_rows<T, 8>(xv, sv, ov, rows, nvec, lg, d, eps, s); break;
      case 16: launch_rows<T, 16>(xv, sv, ov, rows, nvec, lg, d, eps, s); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (path == PATH_WIDE) {
    if (d % kN) return static_cast<int>(cudaErrorInvalidValue);
    rmsnorm_wide<T><<<static_cast<unsigned>(rows), kWideThreads, 0, s>>>(
        xv, sv, ov, d / kN, d, eps);
  } else if (path == PATH_SCALAR) {
    const long long blocks = (rows + kScalarWarps - 1) / kScalarWarps;
    rmsnorm_scalar<T><<<static_cast<unsigned>(blocks), kScalarWarps * 32, 0,
                        s>>>(x, scale, out, rows, d, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------- backward --
enum BwdRoute { BWD_ROWS = 0, BWD_SCALAR = 1 };

constexpr int kBwdBlock = 256;     // threads a block of BWD_ROWS (or a row's)
constexpr int kBwdMaxLanes = 512;  // threads a row of BWD_ROWS
constexpr int kBwdMaxVpl = 4;      // 16-byte vectors a lane of BWD_ROWS
constexpr int kColCols = 32;       // columns a block in rmsnorm_bwd_colsum
constexpr int kColLanes = 32;      // row lanes a block in rmsnorm_bwd_colsum
constexpr int kBwdWarps = 8;       // rows a block in rmsnorm_bwd_scalar
constexpr int kPartCols = 32;      // columns a block in rmsnorm_bwd_partial
constexpr int kRowLanes = 8;       // row lanes a block in rmsnorm_bwd_partial

// bar.sync on barrier `id` (1-15; 0 is __syncthreads') for `n` threads.
__device__ __forceinline__ void group_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// v, hidden from common subexpression elimination: a vector unpacked
// again from it is recomputed, so the compiler keeps the packed words
// (one register per two bfloat16) live instead of the unpacked floats.
__device__ __forceinline__ uint4 opaque(uint4 v) {
  asm volatile("mov.b32 %0, %0;" : "+r"(v.x));
  asm volatile("mov.b32 %0, %0;" : "+r"(v.y));
  asm volatile("mov.b32 %0, %0;" : "+r"(v.z));
  asm volatile("mov.b32 %0, %0;" : "+r"(v.w));
  return v;
}

// BWD_ROWS: rows of nvec 16-byte vectors.  A group of 2^lanes_log2 threads
// takes a row (32 / lanes rows a warp up to a warp, whole warps past it),
// each lane VPL vectors of it, and walks the rows gid, gid + n_groups, ...
// in that order.  A lane loads its scale vectors once, its x and g vectors
// once a row, and writes dx from registers, x, g and dx with evict-first
// hints (nothing here reads them again); it adds g (x r) of its own
// columns into float32 accumulators.  At the end the block's groups add
// their accumulators through shared memory in group order into one partial
// row of dscale, part[blockIdx.x].  Dynamic shared memory: groups x d
// floats when a block holds more than one group.
template <typename T, int VPL>
__global__ void __launch_bounds__(kBwdMaxLanes)
rmsnorm_bwd_rows(const uint4* __restrict__ x, const uint4* __restrict__ scale,
                 const uint4* __restrict__ g, uint4* __restrict__ dx,
                 float* __restrict__ part, long long rows, int nvec,
                 int lanes_log2, int d, float eps) {
  constexpr int kN = Vec<T>::kN;
  extern __shared__ float4 red4[];
  __shared__ float2 sums[2][kBwdMaxLanes / 32];
  const int lanes = 1 << lanes_log2;
  const int j = threadIdx.x & (lanes - 1);
  const int grp = threadIdx.x >> lanes_log2;
  const int groups = blockDim.x >> lanes_log2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long n_groups = (long long)gridDim.x * groups;
  const long long gid = (long long)blockIdx.x * groups + grp;
  // The lanes of a warp run the same shuffles, so its first group's rows
  // set the trip count; a group past the last row idles through it.
  const long long lead = lanes >= 32 ? gid : gid - (lane >> lanes_log2);
  uint4 sc[VPL];
  float acc[VPL * kN];
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int c = j + k * lanes;
    sc[k] = c < nvec ? __ldg(scale + c) : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int i = 0; i < VPL * kN; ++i) acc[i] = 0.0f;
  int parity = 0;
  for (long long r0 = lead; r0 < rows; r0 += n_groups) {
    const long long row = gid + (r0 - lead);
    const bool live = row < rows;
    const uint4* xr = x + row * nvec;
    const uint4* gr = g + row * nvec;
    uint4 xv[VPL], gv[VPL];
#pragma unroll
    for (int k = 0; k < VPL; ++k) {  // every load issues before any use
      const int c = j + k * lanes;
      const bool in = live && c < nvec;
      xv[k] = in ? __ldcs(xr + c) : make_uint4(0, 0, 0, 0);
      gv[k] = in ? __ldcs(gr + c) : make_uint4(0, 0, 0, 0);
    }
    float ss = 0.0f, dot = 0.0f;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      float xf[kN], gf[kN], sf[kN];
      Vec<T>::unpack(xv[k], xf);
      Vec<T>::unpack(gv[k], gf);
      Vec<T>::unpack(sc[k], sf);
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        ss = fmaf(xf[e], xf[e], ss);
        dot = fmaf(gf[e] * sf[e], xf[e], dot);
      }
    }
    for (int o = min(lanes, 32) >> 1; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      dot += __shfl_xor_sync(0xffffffffu, dot, o);
    }
    if (lanes > 32) {  // the group's warps add their sums in warp order
      if (lane == 0) sums[parity][warp] = make_float2(ss, dot);
      group_sync(grp + 1, lanes);
      const int w0 = grp * (lanes >> 5);
      ss = 0.0f;
      dot = 0.0f;
      for (int w = 0; w < lanes >> 5; ++w) {
        const float2 p = sums[parity][w0 + w];
        ss += p.x;
        dot += p.y;
      }
      parity ^= 1;  // the next row's sums go to the other buffer
    }
    if (!live) continue;
    const float r = rsqrtf(ss / static_cast<float>(d) + eps);
    const float coef = r * r * r * (dot / static_cast<float>(d));
    uint4* orow = dx + row * nvec;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int c = j + k * lanes;
      if (c < nvec) {
        float xf[kN], gf[kN], sf[kN];
        Vec<T>::unpack(opaque(xv[k]), xf);
        Vec<T>::unpack(opaque(gv[k]), gf);
        Vec<T>::unpack(opaque(sc[k]), sf);
#pragma unroll
        for (int e = 0; e < kN; ++e) {
          acc[k * kN + e] = fmaf(gf[e], xf[e] * r, acc[k * kN + e]);
          xf[e] = r * (gf[e] * sf[e]) - xf[e] * coef;
        }
        __stcs(orow + c, Vec<T>::pack(xf));
      }
    }
  }
  // One partial row a block: the groups' accumulators in group order.
  float4* out4 = reinterpret_cast<float4*>(part + (long long)blockIdx.x * d);
  float4* mine = groups > 1 ? red4 + grp * (d / 4) : out4;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int c = j + k * lanes;
    if (c < nvec) {
#pragma unroll
      for (int q = 0; q < kN / 4; ++q) {
        mine[c * (kN / 4) + q] =
            make_float4(acc[k * kN + 4 * q], acc[k * kN + 4 * q + 1],
                        acc[k * kN + 4 * q + 2], acc[k * kN + 4 * q + 3]);
      }
    }
  }
  if (groups > 1) {
    __syncthreads();
    const float* red = reinterpret_cast<const float*>(red4);
    float* prow = part + (long long)blockIdx.x * d;
    for (int col = threadIdx.x; col < d; col += blockDim.x) {
      float s = 0.0f;
      for (int k = 0; k < groups; ++k) s += red[k * d + col];
      prow[col] = s;
    }
  }
}

// BWD_SCALAR: dx of one row a warp by element loads, and r of the row into
// rrow.
template <typename T>
__global__ void __launch_bounds__(kBwdWarps * 32)
rmsnorm_bwd_scalar(const T* __restrict__ x, const T* __restrict__ scale,
                   const T* __restrict__ g, T* __restrict__ dx,
                   float* __restrict__ rrow, long long rows, int d,
                   float eps) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kBwdWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const long long base = row * d;
  float ss = 0.0f, dot = 0.0f;
  for (int c = lane; c < d; c += 32) {
    const float xf = repro_torch::to_f32(x[base + c]);
    const float gs = repro_torch::to_f32(g[base + c]) *
                     repro_torch::to_f32(scale[c]);
    ss = fmaf(xf, xf, ss);
    dot = fmaf(gs, xf, dot);
  }
  for (int o = 16; o > 0; o >>= 1) {
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
    dot += __shfl_xor_sync(0xffffffffu, dot, o);
  }
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);
  const float coef = r * r * r * (dot / static_cast<float>(d));
  for (int c = lane; c < d; c += 32) {
    const float xf = repro_torch::to_f32(x[base + c]);
    const float gs = repro_torch::to_f32(g[base + c]) *
                     repro_torch::to_f32(scale[c]);
    dx[base + c] = repro_torch::from_f32<T>(r * gs - xf * coef);
  }
  if (lane == 0) rrow[row] = r;
}

// BWD_SCALAR: part[chunk][c] = sum over the chunk's rows of g x r, column
// c: 32 columns x 8 row lanes a block, the lanes added in order.  It reads
// x and g a second time.
template <typename T>
__global__ void __launch_bounds__(kPartCols * kRowLanes)
rmsnorm_bwd_partial(const T* __restrict__ x, const T* __restrict__ g,
                    const float* __restrict__ rrow, float* __restrict__ part,
                    long long rows, int d, long long chunk) {
  __shared__ float sh[kRowLanes][kPartCols + 1];
  const int tx = threadIdx.x % kPartCols, ty = threadIdx.x / kPartCols;
  const int col = blockIdx.x * kPartCols + tx;
  const long long r0 = (long long)blockIdx.y * chunk;
  const long long r1 = min(rows, r0 + chunk);
  float acc = 0.0f;
  if (col < d) {
    for (long long r = r0 + ty; r < r1; r += kRowLanes) {
      const long long i = r * d + col;
      acc = fmaf(repro_torch::to_f32(g[i]) * repro_torch::to_f32(x[i]),
                 rrow[r], acc);
    }
  }
  sh[ty][tx] = acc;
  __syncthreads();
  if (ty == 0 && col < d) {
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < kRowLanes; ++k) s += sh[k][tx];
    part[(long long)blockIdx.y * d + col] = s;
  }
}

// dscale[c] = the n partial rows added in a fixed order, rounded once to T:
// 32 columns x 32 row lanes a block, lane ty adding rows ty, ty + 32, ...;
// then warp w takes column w of the block and adds its 32 row lanes by xor
// shuffles.
template <typename T>
__global__ void __launch_bounds__(kColCols * kColLanes)
rmsnorm_bwd_colsum(const float* __restrict__ part, T* __restrict__ dscale,
                   int n, int d) {
  __shared__ float sh[kColLanes][kColCols + 1];
  const int tx = threadIdx.x % kColCols, ty = threadIdx.x / kColCols;
  const int col = blockIdx.x * kColCols + tx;
  float s = 0.0f;
  if (col < d) {
#pragma unroll 8
    for (int k = ty; k < n; k += kColLanes) s += part[(long long)k * d + col];
  }
  sh[ty][tx] = s;
  __syncthreads();
  float t = sh[tx][ty];  // warp ty, lane tx: row lane tx of column ty
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  const int out = blockIdx.x * kColCols + ty;
  if (tx == 0 && out < d) dscale[out] = repro_torch::from_f32<T>(t);
}

template <typename T, int VPL>
void launch_bwd_rows(const T* x, const T* scale, const T* g, T* dx,
                     float* part, long long rows, int d, float eps, int lg,
                     int threads, size_t smem, int blocks, cudaStream_t s) {
  rmsnorm_bwd_rows<T, VPL><<<blocks, threads, smem, s>>>(
      reinterpret_cast<const uint4*>(x), reinterpret_cast<const uint4*>(scale),
      reinterpret_cast<const uint4*>(g), reinterpret_cast<uint4*>(dx), part,
      rows, d / Vec<T>::kN, lg, d, eps);
}

template <typename T>
int launch_bwd(const T* x, const T* scale, const T* g, T* dx, T* dscale,
               float* work, long long rows, int d, float eps, int route,
               int lanes, int vpl, int parts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kN = Vec<T>::kN;
  if (rows <= 0 || d <= 0 || parts <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* part = work;
  int n_parts = parts;
  if (route == BWD_ROWS) {
    const int threads = max(lanes, kBwdBlock);
    const size_t smem =
        threads > lanes ? (size_t)(threads / lanes) * d * sizeof(float) : 0;
    if (d % kN || lanes < 1 || lanes > kBwdMaxLanes ||
        (lanes & (lanes - 1)) || vpl < 1 || vpl > kBwdMaxVpl ||
        (long long)lanes * vpl < d / kN || smem > 48 * 1024) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int lg = __builtin_ctz(lanes);
    switch (vpl) {
      case 1: launch_bwd_rows<T, 1>(x, scale, g, dx, part, rows, d, eps, lg,
                                    threads, smem, parts, s); break;
      case 2: launch_bwd_rows<T, 2>(x, scale, g, dx, part, rows, d, eps, lg,
                                    threads, smem, parts, s); break;
      case 3: launch_bwd_rows<T, 3>(x, scale, g, dx, part, rows, d, eps, lg,
                                    threads, smem, parts, s); break;
      default: launch_bwd_rows<T, 4>(x, scale, g, dx, part, rows, d, eps, lg,
                                     threads, smem, parts, s); break;
    }
  } else if (route == BWD_SCALAR) {
    const long long chunk = (rows + parts - 1) / parts;
    n_parts = static_cast<int>((rows + chunk - 1) / chunk);
    if (n_parts > 65535) return static_cast<int>(cudaErrorInvalidValue);
    float* rrow = work;
    part = work + rows;
    const long long blocks = (rows + kBwdWarps - 1) / kBwdWarps;
    rmsnorm_bwd_scalar<T><<<static_cast<unsigned>(blocks), kBwdWarps * 32, 0,
                            s>>>(x, scale, g, dx, rrow, rows, d, eps);
    const dim3 pgrid((d + kPartCols - 1) / kPartCols, n_parts);
    rmsnorm_bwd_partial<T><<<pgrid, kPartCols * kRowLanes, 0, s>>>(
        x, g, rrow, part, rows, d, chunk);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  rmsnorm_bwd_colsum<T><<<(d + kColCols - 1) / kColCols,
                          kColCols * kColLanes, 0, s>>>(part, dscale,
                                                        n_parts, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// path: PATH_*; lanes and vpl (vectors per lane) are read by PATH_ROWS.
extern "C" int rmsnorm_f32(const float* x, const float* scale, float* out,
                           long long rows, int d, float eps, int path,
                           int lanes, int vpl, void* stream) {
  return launch(x, scale, out, rows, d, eps, path, lanes, vpl, stream);
}

extern "C" int rmsnorm_bf16(const __nv_bfloat16* x,
                            const __nv_bfloat16* scale, __nv_bfloat16* out,
                            long long rows, int d, float eps, int path,
                            int lanes, int vpl, void* stream) {
  return launch(x, scale, out, rows, d, eps, path, lanes, vpl, stream);
}

// route: BWD_ROWS (lanes threads a row, vpl 16-byte vectors a lane, parts
// blocks) or BWD_SCALAR (parts chunks of rows); work: parts x d floats of
// scratch for the partial rows of dscale, after `rows` floats (each row's
// r) on BWD_SCALAR.
extern "C" int rmsnorm_bwd_f32(const float* x, const float* scale,
                               const float* g, float* dx, float* dscale,
                               float* work, long long rows, int d, float eps,
                               int route, int lanes, int vpl, int parts,
                               void* stream) {
  return launch_bwd(x, scale, g, dx, dscale, work, rows, d, eps, route, lanes,
                    vpl, parts, stream);
}

extern "C" int rmsnorm_bwd_bf16(const __nv_bfloat16* x,
                                const __nv_bfloat16* scale,
                                const __nv_bfloat16* g, __nv_bfloat16* dx,
                                __nv_bfloat16* dscale, float* work,
                                long long rows, int d, float eps, int route,
                                int lanes, int vpl, int parts, void* stream) {
  return launch_bwd(x, scale, g, dx, dscale, work, rows, d, eps, route, lanes,
                    vpl, parts, stream);
}
