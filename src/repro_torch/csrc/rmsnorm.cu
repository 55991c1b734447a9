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
//   dx     = r (g s) - x r^3 mean(g s x)      (rmsnorm_bwd_rows)
//   dscale = sum over rows of g x r           (two passes, below)
// It reads x and g and writes dx, so memory bounds it too.  A warp takes a
// row: 16-byte vectors when every base is aligned and d a multiple of the
// vector width, element loads otherwise, so it takes every shape the
// forward's three paths take; the row's two sums reduce by xor shuffles
// and a second pass over the row (from L1/L2) writes dx and keeps r.
// dscale is a column sum over every row, and float atomics would add in an
// order that changes from run to run; so a block of 32 columns x 8 row
// lanes sums one chunk of rows into a partial row (rmsnorm_bwd_partial),
// and one thread a column adds the chunks' partial rows in order
// (rmsnorm_bwd_colsum): two runs agree bit for bit.  The partial pass
// reads x and g a second time (5 row reads and writes where 3 would do):
// the first design, kept simple.
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
constexpr int kBwdWarps = 8;     // rows a block in rmsnorm_bwd_rows
constexpr int kColThreads = 32;  // columns a block in rmsnorm_bwd_partial
constexpr int kRowLanes = 8;     // row lanes a block in rmsnorm_bwd_partial

__device__ __forceinline__ float warp_allsum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// dx of one row a warp; r of the row into rrow.  VEC: 16-byte vectors.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kBwdWarps * 32)
rmsnorm_bwd_rows(const T* __restrict__ x, const T* __restrict__ scale,
                 const T* __restrict__ g, T* __restrict__ dx,
                 float* __restrict__ rrow, long long rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kBwdWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const long long base = row * d;
  float ss = 0.0f, dot = 0.0f;
  if (VEC) {
    constexpr int kN = Vec<T>::kN;
    const uint4* xv = reinterpret_cast<const uint4*>(x + base);
    const uint4* gv = reinterpret_cast<const uint4*>(g + base);
    const uint4* sv = reinterpret_cast<const uint4*>(scale);
    for (int c = lane; c < d / kN; c += 32) {
      float xf[kN], gf[kN], sf[kN];
      Vec<T>::unpack(__ldg(xv + c), xf);
      Vec<T>::unpack(__ldg(gv + c), gf);
      Vec<T>::unpack(__ldg(sv + c), sf);
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        ss = fmaf(xf[e], xf[e], ss);
        dot = fmaf(gf[e] * sf[e], xf[e], dot);
      }
    }
  } else {
    for (int c = lane; c < d; c += 32) {
      const float xf = repro_torch::to_f32(x[base + c]);
      const float gs = repro_torch::to_f32(g[base + c]) *
                       repro_torch::to_f32(scale[c]);
      ss = fmaf(xf, xf, ss);
      dot = fmaf(gs, xf, dot);
    }
  }
  ss = warp_allsum(ss);
  dot = warp_allsum(dot);
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);
  const float coef = r * r * r * (dot / static_cast<float>(d));
  if (VEC) {
    constexpr int kN = Vec<T>::kN;
    const uint4* xv = reinterpret_cast<const uint4*>(x + base);
    const uint4* gv = reinterpret_cast<const uint4*>(g + base);
    const uint4* sv = reinterpret_cast<const uint4*>(scale);
    uint4* ov = reinterpret_cast<uint4*>(dx + base);
    for (int c = lane; c < d / kN; c += 32) {
      float xf[kN], gf[kN], sf[kN];
      Vec<T>::unpack(__ldg(xv + c), xf);
      Vec<T>::unpack(__ldg(gv + c), gf);
      Vec<T>::unpack(__ldg(sv + c), sf);
#pragma unroll
      for (int e = 0; e < kN; ++e) xf[e] = r * (gf[e] * sf[e]) - xf[e] * coef;
      ov[c] = Vec<T>::pack(xf);
    }
  } else {
    for (int c = lane; c < d; c += 32) {
      const float xf = repro_torch::to_f32(x[base + c]);
      const float gs = repro_torch::to_f32(g[base + c]) *
                       repro_torch::to_f32(scale[c]);
      dx[base + c] = repro_torch::from_f32<T>(r * gs - xf * coef);
    }
  }
  if (lane == 0) rrow[row] = r;
}

// partial[chunk][c] = sum over the chunk's rows of g x r, column c: 32
// columns x 8 row lanes a block, the lanes added in order.
template <typename T>
__global__ void __launch_bounds__(kColThreads * kRowLanes)
rmsnorm_bwd_partial(const T* __restrict__ x, const T* __restrict__ g,
                    const float* __restrict__ rrow, float* __restrict__ part,
                    long long rows, int d, int chunk) {
  __shared__ float sh[kRowLanes][kColThreads + 1];
  const int tx = threadIdx.x % kColThreads, ty = threadIdx.x / kColThreads;
  const int col = blockIdx.x * kColThreads + tx;
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

// dscale[c] = the chunks' partial rows added in order, in T.
template <typename T>
__global__ void __launch_bounds__(256)
rmsnorm_bwd_colsum(const float* __restrict__ part, T* __restrict__ dscale,
                   int n_chunks, int d) {
  const int col = blockIdx.x * 256 + threadIdx.x;
  if (col >= d) return;
  float s = 0.0f;
  for (int k = 0; k < n_chunks; ++k) s += part[(long long)k * d + col];
  dscale[col] = repro_torch::from_f32<T>(s);
}

template <typename T>
int launch_bwd(const T* x, const T* scale, const T* g, T* dx, T* dscale,
               float* work, long long rows, int d, float eps, int vec,
               int chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kN = Vec<T>::kN;
  const long long n_chunks = (rows + chunk - 1) / chunk;
  if (rows <= 0 || d <= 0 || chunk <= 0 || n_chunks > 65535 ||
      (vec && d % kN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* rrow = work;
  float* part = work + rows;
  const long long blocks = (rows + kBwdWarps - 1) / kBwdWarps;
  if (vec) {
    rmsnorm_bwd_rows<T, true><<<static_cast<unsigned>(blocks),
                                kBwdWarps * 32, 0, s>>>(x, scale, g, dx, rrow,
                                                        rows, d, eps);
  } else {
    rmsnorm_bwd_rows<T, false><<<static_cast<unsigned>(blocks),
                                 kBwdWarps * 32, 0, s>>>(x, scale, g, dx, rrow,
                                                         rows, d, eps);
  }
  const dim3 pgrid((d + kColThreads - 1) / kColThreads,
                   static_cast<unsigned>(n_chunks));
  rmsnorm_bwd_partial<T><<<pgrid, kColThreads * kRowLanes, 0, s>>>(
      x, g, rrow, part, rows, d, chunk);
  rmsnorm_bwd_colsum<T><<<(d + 255) / 256, 256, 0, s>>>(
      part, dscale, static_cast<int>(n_chunks), d);
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

// work: rows + ceil(rows / chunk) * d floats of scratch (each row's r, then
// the partial rows of dscale); vec: 16-byte vectors (every base aligned, d
// a multiple of the vector width).
extern "C" int rmsnorm_bwd_f32(const float* x, const float* scale,
                               const float* g, float* dx, float* dscale,
                               float* work, long long rows, int d, float eps,
                               int vec, int chunk, void* stream) {
  return launch_bwd(x, scale, g, dx, dscale, work, rows, d, eps, vec, chunk,
                    stream);
}

extern "C" int rmsnorm_bwd_bf16(const __nv_bfloat16* x,
                                const __nv_bfloat16* scale,
                                const __nv_bfloat16* g, __nv_bfloat16* dx,
                                __nv_bfloat16* dscale, float* work,
                                long long rows, int d, float eps, int vec,
                                int chunk, void* stream) {
  return launch_bwd(x, scale, g, dx, dscale, work, rows, d, eps, vec, chunk,
                    stream);
}
