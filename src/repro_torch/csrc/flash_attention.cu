// Flash attention (forward): causal or full online-softmax attention, GQA.
//
// Replaces the Pallas TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention.py (`_flash_kernel`).  q [B, S, H, D],
// k/v [B, T, KV, D], out [B, S, H, D], all float32 or all bfloat16, in the
// model's layout (no transposes).  It computes what the TPU kernel does:
// q scaled first (flash_attention.py:27), scores and the running max,
// denominator and accumulator in float32 (:29-58), masked entries -1e30,
// and out = acc / max(ell, 1e-30) cast to the input type.
//
// Differences of layout, not of math:
//   * GQA: q head h reads kv head h / (H / KV) inside the kernel; the TPU
//     wrapper folds the group axis into the q rows instead (:75-78).
//   * Any S and T: rows past S are not stored and keys past T are masked.
//     The causal mask is start-aligned (k_pos > q_pos masked), as in the
//     TPU kernel; the wrapper only takes causal with S == T.
//   * Causal key tiles wholly past a query tile's last row are skipped;
//     the TPU kernel visits them with every entry masked, which leaves
//     (m, ell, acc) unchanged, so skipping them is exact.
//
// What bounds it on the H100: at the prefill shapes (S = 512-2048, D = 64)
// the products, 4*S*T*D flops a head (half of them for causal), over the
// bytes of q, k, v and out: operations.  This first version is SIMT
// float32, not wgmma: one block of 256 threads per (64-row query tile,
// head, batch) streams 64-key K/V tiles through shared memory as float32;
// thread (ty, tx) of a 16 x 16 grid owns query rows 4*ty..4*ty+3, score
// columns tx + 16j and output columns tx + 16c, so the row statistics of
// the online softmax reduce over one half-warp with shuffles.
#include "common.cuh"

namespace {

constexpr int kBr = 64;        // query rows per block
constexpr int kBc = 64;        // keys per tile
constexpr int kThreads = 256;  // a 16 x 16 grid

template <int D>
constexpr size_t smem_floats() {
  return (size_t)kBr * (D + 1) + (size_t)kBc * (D + 1) + (size_t)kBc * D +
         (size_t)kBr * (kBc + 1);
}

__device__ __forceinline__ float half_warp_max(float v) {
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int S, int Tk,
                 int H, int KV, int causal, float scale) {
  constexpr int DP = D + 1;      // padded rows: conflict-free column reads
  constexpr int PP = kBc + 1;
  constexpr int NC = D / 16;     // output columns a thread owns
  extern __shared__ float smem[];
  float* qs = smem;              // [kBr][DP]
  float* ks = qs + kBr * DP;     // [kBc][DP]
  float* vs = ks + kBc * DP;     // [kBc][D]
  float* ps = vs + kBc * D;      // [kBr][PP]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBr, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const long long qstride = (long long)H * D, kvstride = (long long)KV * D;
  const T* qb = q + (long long)b * S * qstride + (long long)h * D;
  const T* kb = k + (long long)b * Tk * kvstride + (long long)kvh * D;
  const T* vb = v + (long long)b * Tk * kvstride + (long long)kvh * D;
  T* ob = out + (long long)b * S * qstride + (long long)h * D;

  for (int i = tid; i < kBr * D; i += kThreads) {
    const int r = i / D, c = i % D, s = q0 + r;
    qs[r * DP + c] =
        s < S ? repro_torch::to_f32(qb[(long long)s * qstride + c]) * scale
              : 0.0f;
  }

  float m[4], ell[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    ell[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  const int kv_end = causal ? min(Tk, q0 + kBr) : Tk;
  for (int k0 = 0; k0 < kv_end; k0 += kBc) {
    __syncthreads();  // the last tile's reads are done (and qs is written)
    for (int i = tid; i < kBc * D; i += kThreads) {
      const int r = i / D, c = i % D, t = k0 + r;
      const bool ok = t < Tk;
      ks[r * DP + c] =
          ok ? repro_torch::to_f32(kb[(long long)t * kvstride + c]) : 0.0f;
      vs[r * D + c] =
          ok ? repro_torch::to_f32(vb[(long long)t * kvstride + c]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        if (kp >= Tk || (causal && kp > qp)) s[i][j] = -1e30f;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty * 4 + i) * PP + tx + 16 * j] = p;
        rs += p;
      }
      ell[i] = alpha * ell[i] + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // every row of p is in shared memory

#pragma unroll 4
    for (int t = 0; t < kBc; ++t) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * PP + t];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = vs[t * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= S) continue;
    const float den = fmaxf(ell[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      ob[(long long)s * qstride + tx + 16 * c] =
          repro_torch::from_f32<T>(acc[i][c] / den);
  }
}

template <typename T, int D>
int launch_d(const T* q, const T* k, const T* v, T* out, int B, int S, int Tk,
             int H, int KV, int causal, float scale, void* stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = repro_torch::allow_smem(flash_fwd_kernel<T, D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBr - 1) / kBr, H, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      q, k, v, out, S, Tk, H, KV, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* q, const T* k, const T* v, T* out, int B, int S, int Tk,
           int H, int KV, int D, int causal, float scale, void* stream) {
  if (D == 64)
    return launch_d<T, 64>(q, k, v, out, B, S, Tk, H, KV, causal, scale,
                           stream);
  if (D == 128)
    return launch_d<T, 128>(q, k, v, out, B, S, Tk, H, KV, causal, scale,
                            stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, float* out, int B, int S,
                                   int Tk, int H, int KV, int D, int causal,
                                   float scale, void* stream) {
  return launch(q, k, v, out, B, S, Tk, H, KV, D, causal, scale, stream);
}

extern "C" int flash_attention_bf16(const __nv_bfloat16* q,
                                    const __nv_bfloat16* k,
                                    const __nv_bfloat16* v,
                                    __nv_bfloat16* out, int B, int S, int Tk,
                                    int H, int KV, int D, int causal,
                                    float scale, void* stream) {
  return launch(q, k, v, out, B, S, Tk, H, KV, D, causal, scale, stream);
}
