// Flash attention, backward: dq, dk and dv of causal, windowed or full
// online-softmax attention with GQA.
//
// The TPU kernel `flash_attention` (src/repro/kernels/flash_attention.py,
// `_flash_kernel`) has no backward, and no JAX model path calls it (JAX
// differentiates its jnp attention).  The port's training path runs kernel
// 7 (csrc/flash_attention.cu) forward on the card, so its gradient is a
// kernel too.  With P = softmax(scale q k^T) under the forward's mask (a
// key past T, a causal key after its query (start-aligned, S == T), a key
// `window` or more before its query) and O = P v:
//   dv = P^T dO,  dP = dO v^T,  dS = P * (dP - delta),
//   delta = rowsum(dO * O),  dq = scale dS k,  dk = scale dS^T q.
// q, dq, O, dO [B, S, H, D]; k, v, dk, dv [B, T, KV, D]; all float32 or
// all bfloat16, every sum in float32, each gradient written once in the
// input type; D in {64, 128}.
//
// FlashAttention-2's backward, kept simple: SIMT FMAs, two kernels in
// order on the caller's stream.
//   flash_bwd_dq: a block per (64-row query tile, head, batch).  A first
//     walk over the key tiles recomputes each row's log-sum-exp (the
//     forward's online max and sum; the forward kernel stays as it is and
//     writes nothing more), then delta, then a second walk recomputes P,
//     forms dP and dS and adds dS k into dq in registers.  It writes dq
//     and each row's log-sum-exp and delta (float32 scratch).
//   flash_bwd_dkdv: a block per (64-key tile, KV head, batch) walks the
//     G = H / KV query heads of its KV head and their query tiles,
//     recomputing P^T and dS^T from the stored log-sum-exp and delta, and
//     adds P^T dO into dv and dS^T q into dk in registers.  A block owns
//     its keys' whole sums, so GQA needs no atomics and two runs agree bit
//     for bit.
// Both kernels visit only the tiles the mask leaves anything in, as the
// forward does: a causal query tile walks keys up to its last row, a key
// tile queries from its first row; a window bounds both walks.
//
// Thread (ty, tx) of a 16 x 16 grid owns rows 4 ty .. 4 ty + 3 of its
// block's tile (queries in dq, keys in dkdv), score columns tx + 16 j and
// output columns tx + 16 c, as the forward's SIMT kernel; tiles live in
// shared memory as float32 rows padded to D + 1 (conflict-free column
// reads).
//
// What bounds it on the H100: the products, 5 S x T x D multiply-adds a
// head against the forward's 2 (here 8: the scores are computed twice in
// dq and again in dkdv, and dP twice), over the bytes of q, k, v, O, dO
// and the three gradients: operations.  SIMT FMAs reach a fraction of the
// tensor cores' bfloat16 rate; wgmma is later work (ROADMAP.md A.2).
#include "common.cuh"

namespace {

constexpr int kBr = 64;        // query rows a tile
constexpr int kBc = 64;        // keys a tile
constexpr int kThreads = 256;  // a 16 x 16 grid
constexpr int kPP = kBc + 1;   // padded rows of the P / dS tiles

__device__ __forceinline__ float half_warp_max(float v) {
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows r0 .. r0 + 63 of one head of a [batch, n, heads, D] tensor (src
// points at the head's row 0, rows `rstride` apart) into a [64][D + 1]
// float tile; rows past n are zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          long long rstride, int r0, int n) {
  for (int i = threadIdx.x; i < kBr * D; i += kThreads) {
    const int r = i / D, c = i % D, t = r0 + r;
    dst[r * (D + 1) + c] =
        t < n ? repro_torch::to_f32(src[(long long)t * rstride + c]) : 0.0f;
  }
}

// The forward's mask: key kp is hidden from query qp.
__device__ __forceinline__ bool hidden(int qp, int kp, int Tk, int causal,
                                       int window) {
  return kp >= Tk || (causal && kp > qp) || (window && qp - kp >= window);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * ((size_t)4 * kBr * (D + 1) + (size_t)kBr * kPP);
}

template <int D>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(float) *
         ((size_t)4 * kBr * (D + 1) + (size_t)2 * kBc * kPP + 2 * kBr);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ o,
             const T* __restrict__ dout, T* __restrict__ dq,
             float* __restrict__ lse_out, float* __restrict__ delta_out, int S,
             int Tk, int H, int KV, int causal, int window, float scale) {
  constexpr int DP = D + 1;
  constexpr int NC = D / 16;  // output columns a thread owns
  extern __shared__ float smem[];
  float* qs = smem;             // [kBr][DP]
  float* dos = qs + kBr * DP;   // [kBr][DP]
  float* ks = dos + kBr * DP;   // [kBc][DP]
  float* vs = ks + kBc * DP;    // [kBc][DP]
  float* ds = vs + kBc * DP;    // [kBr][kPP]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBr, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const long long qstride = (long long)H * D, kvstride = (long long)KV * D;
  const long long qoff = ((long long)b * S * H + h) * D;
  const long long kvoff = ((long long)b * Tk * KV + kvh) * D;
  load_tile<T, D>(qs, q + qoff, qstride, q0, S);
  load_tile<T, D>(dos, dout + qoff, qstride, q0, S);
  __syncthreads();

  // delta = rowsum(dO * O), over the half-warp that owns the row
  float delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, s = q0 + r;
    float acc = 0.0f;
    if (s < S) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        acc = fmaf(dos[r * DP + col],
                   repro_torch::to_f32(o[qoff + s * qstride + col]), acc);
      }
    }
    delta[i] = half_warp_sum(acc);
  }

  const int kv_end = causal ? min(Tk, q0 + kBr) : Tk;
  const int kv_begin = window ? max(0, q0 - window + 1) / kBc * kBc : 0;

  // walk 1: each row's log-sum-exp of the scaled, masked scores
  float m[4], ell[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    ell[i] = 0.0f;
  }
  for (int k0 = kv_begin; k0 < kv_end; k0 += kBc) {
    __syncthreads();
    load_tile<T, D>(ks, k + kvoff, kvstride, k0, Tk);
    __syncthreads();
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
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
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = hidden(qp, k0 + tx + 16 * j, Tk, causal, window)
                       ? -1e30f
                       : sc[i][j] * scale;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) rs += expf(sc[i][j] - m_new);
      ell[i] = ell[i] * expf(m[i] - m_new) + half_warp_sum(rs);
      m[i] = m_new;
    }
  }
  float lse[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) lse[i] = m[i] + logf(ell[i]);

  // walk 2: dq += scale dS k
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  for (int k0 = kv_begin; k0 < kv_end; k0 += kBc) {
    __syncthreads();  // the last tile's reads are done
    load_tile<T, D>(ks, k + kvoff, kvstride, k0, Tk);
    load_tile<T, D>(vs, v + kvoff, kvstride, k0, Tk);
    __syncthreads();
    float sc[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = qs[(ty * 4 + i) * DP + d];
        gv[i] = dos[(ty * 4 + i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = ks[(tx + 16 * j) * DP + d];
        vv[j] = vs[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        const float p = hidden(q0 + r, k0 + col, Tk, causal, window)
                            ? 0.0f
                            : expf(sc[i][j] * scale - lse[i]);
        ds[r * kPP + col] = p * (dp[i][j] - delta[i]) * scale;
      }
    }
    __syncthreads();  // every row of dS is in shared memory
#pragma unroll 4
    for (int t = 0; t < kBc; ++t) {
      float dv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dv[i] = ds[(ty * 4 + i) * kPP + t];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kk = ks[t * DP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(dv[i], kk, acc[i][c]);
      }
    }
  }

  const long long stat = ((long long)b * H + h) * S;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= S) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      dq[qoff + s * qstride + tx + 16 * c] =
          repro_torch::from_f32<T>(acc[i][c]);
    if (tx == 0) {
      lse_out[stat + s] = lse[i];
      delta_out[stat + s] = delta[i];
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               T* __restrict__ dk, T* __restrict__ dv,
               const float* __restrict__ lse, const float* __restrict__ delta,
               int S, int Tk, int H, int KV, int causal, int window,
               float scale) {
  constexpr int DP = D + 1;
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;              // [kBc][DP]
  float* vs = ks + kBc * DP;     // [kBc][DP]
  float* qs = vs + kBc * DP;     // [kBr][DP]
  float* dos = qs + kBr * DP;    // [kBr][DP]
  float* pt = dos + kBr * DP;    // [kBc][kPP]: P^T
  float* dst = pt + kBc * kPP;   // [kBc][kPP]: scale dS^T
  float* lse_s = dst + kBc * kPP;
  float* delta_s = lse_s + kBr;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * kBc, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const long long qstride = (long long)H * D, kvstride = (long long)KV * D;
  const long long kvoff = ((long long)b * Tk * KV + kvh) * D;
  load_tile<T, D>(ks, k + kvoff, kvstride, k0, Tk);
  load_tile<T, D>(vs, v + kvoff, kvstride, k0, Tk);

  float adk[4][NC], adv[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) adk[i][c] = adv[i][c] = 0.0f;

  // the queries that see a key of this tile
  const int q_begin = causal ? k0 / kBr * kBr : 0;
  const int q_end = window ? min(S, k0 + kBc - 1 + window) : S;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const long long qoff = ((long long)b * S * H + h) * D;
    const long long stat = ((long long)b * H + h) * S;
    for (int q0 = q_begin; q0 < q_end; q0 += kBr) {
      __syncthreads();  // the last tile's reads are done
      load_tile<T, D>(qs, q + qoff, qstride, q0, S);
      load_tile<T, D>(dos, dout + qoff, qstride, q0, S);
      if (tid < kBr) {
        const bool ok = q0 + tid < S;
        lse_s[tid] = ok ? lse[stat + q0 + tid] : 0.0f;
        delta_s[tid] = ok ? delta[stat + q0 + tid] : 0.0f;
      }
      __syncthreads();
      float sc[4][4], dp[4][4];  // [key i][query j]
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kk[4], vv[4], qv[4], gv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kk[i] = ks[(ty * 4 + i) * DP + d];
          vv[i] = vs[(ty * 4 + i) * DP + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = qs[(tx + 16 * j) * DP + d];
          gv[j] = dos[(tx + 16 * j) * DP + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            sc[i][j] = fmaf(kk[i], qv[j], sc[i][j]);
            dp[i][j] = fmaf(vv[i], gv[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = tx + 16 * j, qp = q0 + col;
          const float p = (qp >= S || hidden(qp, k0 + r, Tk, causal, window))
                              ? 0.0f
                              : expf(sc[i][j] * scale - lse_s[col]);
          pt[r * kPP + col] = p;
          dst[r * kPP + col] = p * (dp[i][j] - delta_s[col]) * scale;
        }
      }
      __syncthreads();  // P^T and dS^T are in shared memory
#pragma unroll 4
      for (int t = 0; t < kBr; ++t) {
        float pv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = pt[(ty * 4 + i) * kPP + t];
          sv[i] = dst[(ty * 4 + i) * kPP + t];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float gg = dos[t * DP + tx + 16 * c];
          const float qq = qs[t * DP + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            adv[i][c] = fmaf(pv[i], gg, adv[i][c]);
            adk[i][c] = fmaf(sv[i], qq, adk[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = k0 + ty * 4 + i;
    if (t >= Tk) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const long long at = kvoff + t * kvstride + tx + 16 * c;
      dk[at] = repro_torch::from_f32<T>(adk[i][c]);
      dv[at] = repro_torch::from_f32<T>(adv[i][c]);
    }
  }
}

// cudaFuncSetAttribute once per kernel and device, not on every launch.
template <typename K>
cudaError_t allow_smem_once(K kernel, size_t bytes, unsigned& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 32 && (done >> dev) & 1u)) return err;
  err = repro_torch::allow_smem(kernel, bytes);
  if (err == cudaSuccess && dev < 32) done |= 1u << dev;
  return err;
}

template <typename T, int D>
int launch_d(const T* q, const T* k, const T* v, const T* o, const T* dout,
             T* dq, T* dk, T* dv, float* lse, float* delta, int B, int S,
             int Tk, int H, int KV, int causal, int window, float scale,
             cudaStream_t stream) {
  static unsigned dq_set = 0, dkdv_set = 0;
  cudaError_t err =
      allow_smem_once(flash_bwd_dq<T, D>, dq_smem_bytes<D>(), dq_set);
  if (err == cudaSuccess)
    err = allow_smem_once(flash_bwd_dkdv<T, D>, dkdv_smem_bytes<D>(),
                          dkdv_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q((S + kBr - 1) / kBr, H, B);
  flash_bwd_dq<T, D><<<grid_q, kThreads, dq_smem_bytes<D>(), stream>>>(
      q, k, v, o, dout, dq, lse, delta, S, Tk, H, KV, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_k((Tk + kBc - 1) / kBc, KV, B);
  flash_bwd_dkdv<T, D><<<grid_k, kThreads, dkdv_smem_bytes<D>(), stream>>>(
      q, k, v, dout, dk, dv, lse, delta, S, Tk, H, KV, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* q, const T* k, const T* v, const T* o, const T* dout,
           T* dq, T* dk, T* dv, float* lse, float* delta, int B, int S,
           int Tk, int H, int KV, int D, int causal, int window, float scale,
           void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || Tk < 1 || KV < 1 || H % KV || (causal && S != Tk))
    return static_cast<int>(cudaErrorInvalidValue);
  if (D == 64)
    return launch_d<T, 64>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, S,
                           Tk, H, KV, causal, window, scale, st);
  if (D == 128)
    return launch_d<T, 128>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, S,
                            Tk, H, KV, causal, window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// lse, delta: [B, H, S] float32 scratch, written by the dq kernel and read
// by the dk/dv kernel.
extern "C" int flash_attention_bwd_f32(const float* q, const float* k,
                                       const float* v, const float* o,
                                       const float* dout, float* dq,
                                       float* dk, float* dv, float* lse,
                                       float* delta, int B, int S, int Tk,
                                       int H, int KV, int D, int causal,
                                       int window, float scale,
                                       void* stream) {
  return launch(q, k, v, o, dout, dq, dk, dv, lse, delta, B, S, Tk, H, KV, D,
                causal, window, scale, stream);
}

extern "C" int flash_attention_bwd_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    const __nv_bfloat16* o, const __nv_bfloat16* dout, __nv_bfloat16* dq,
    __nv_bfloat16* dk, __nv_bfloat16* dv, float* lse, float* delta, int B,
    int S, int Tk, int H, int KV, int D, int causal, int window, float scale,
    void* stream) {
  return launch(q, k, v, o, dout, dq, dk, dv, lse, delta, B, S, Tk, H, KV, D,
                causal, window, scale, stream);
}
