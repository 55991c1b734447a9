// Mamba2 SSD chunked scan (state-space duality, arXiv:2405.21060).
//
// Replaces the Pallas TPU kernel `ssd_scan` in src/repro/kernels/ssd_scan.py
// (`_ssd_kernel`).  x [B, S, H, P] and B/C [B, S, G, N] in float32 or
// bfloat16, dt [B, S, H] and A [H] float32; y [B, S, H, P] float32.  The
// output is float32, not x's type: the model's path (`ssm.ssd_chunked`)
// returns float32 and `ssm_forward` adds D*x before one cast, so a
// bfloat16 y would round twice.  S must be a multiple of the chunk Q
// (`ssm_forward` pads first, as in JAX).
//
// Per chunk, with seg = cumsum(dt * A) over the chunk's Q positions:
//   y_i   = sum_{j<=i} (C_i . B_j) exp(seg_i - seg_j) dt_j x_j
//         + exp(seg_i) C_i @ state                        (carried-in term)
//   state = exp(seg_Q) state + sum_j B_j (exp(seg_Q - seg_j) dt_j) x_j^T
// the same terms as the TPU kernel (ssd_scan.py:38-53) and the model.
//
// Layout: a block owns one (batch, head) and a slice of PS of the P head
// columns (grid batch*H x P/PS), and walks the chunks in order with the
// [N, PS] state on chip; the TPU grid carries the state in VMEM scratch
// across its sequential chunk axis.  B/C are read by group (head / (H/G)).
// A P slice recomputes the chunk's C B^T scores, and in exchange halves
// the state and x tiles and doubles the blocks in flight; the wrapper's
// plan (`ssd_plan` in kernels/ssd_scan.py) picks PS.  Both kernels take
// exp(seg_i - seg_j) from __expf: the argument is <= 0, and where the
// fast exponential's relative error grows (|arg| >> 1) the term is tiny.
//
// What bounds it on the H100: per chunk about Q*Q*N/2 + Q*Q*P/2 + 2*Q*N*P
// multiply-adds against Q*(P + 2N) loads and Q*P float32 stores: the
// tensor cores for bf16, register-tiled FFMA for float32, never two
// shared-memory loads a multiply-add:
//
// * bfloat16 (`ssd_mma_kernel`): the four chunk products run on the tensor
//   cores, mma.sync m16n8k16 (bf16 in, f32 accumulate), 4 warps a block.
//   x, B and C arrive by cp.async, the next chunk's copies issued as soon as
//   this one's tiles are consumed; at Zamba2's shapes three blocks share an
//   SM and compute while the others load (a two-stage ring, one block an
//   SM, measured slower: PERF.md).  Each warp takes two
//   16-row tiles of the chunk (t and Q/16-1-t: the causal triangle balanced)
//   and streams the scores 16 columns at a time: C_i B_j^T into registers,
//   times exp(seg_i - seg_j) dt_j, turned in registers into the A operand
//   of the product with x (the accumulator layout of two n8 tiles is the A
//   layout of one k16 step).  The carried-in term is C_i times the state,
//   its rows scaled by exp(seg_i) after.  The state update takes B^T
//   through ldmatrix.trans, scaled by exp(seg_Q - seg_j) dt_j in
//   registers; the state itself stays float32 in registers from chunk to
//   chunk (a bf16 copy in shared memory feeds the next chunk's carried-in
//   term).  x, B and C are bf16 already; each float32 operand (the decayed
//   scores, B * w, the state) enters as two bf16 terms, hi = bf16(v) and
//   lo = bf16(v - hi), two MMAs a product: one bf16 rounding of the scores
//   alone leaves errors up to the 5e-2 gate at Zamba2's shapes (a CPU
//   model of the roundings, tests/test_torch_lm_kernels.py).
// * float32 (`ssd_simt_kernel`): FFMA with register tiles, 8 warps a
//   block: every inner step loads 16-byte vectors from shared memory that
//   feed 8-16 multiply-adds each (a 4 x 4 score tile, 8 x PS/16 output and
//   4 x PS/16 state tiles), lanes laid out so a warp's loads are broadcast
//   or hit distinct banks.  TF32 is not used: it cannot meet the 2e-4 gate.
//
// seg is summed in position order by one thread, each term dt*A rounded
// before the add, as torch.cumsum (and jnp.cumsum on the CPU) sums it: the
// prefix sums reach |seg| ~ 1e2 within a chunk and exp(seg_i - seg_j)
// turns their last-bit rounding into a relative error of the decay.
#include "mma.cuh"

namespace {

using namespace repro_torch::mma;

constexpr int kMmaThreads = 128;   // 4 warps
constexpr int kSimtThreads = 256;  // 8 warps
constexpr int kMaxN = 128;         // the state tiles held in registers

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Kept equal to `_smem_bytes` in repro_torch/kernels/ssd_scan.py.
inline size_t smem_bytes_mma(int Q, int N, int PS) {
  const size_t np = round_up(N, 16), ldx = PS + 8, ldn = np + 8;
  return 2 * Q * ldx + 4 * Q * ldn + 4 * (size_t)Q + 4 * np * ldx +
         12 * (size_t)Q;
}

inline size_t smem_bytes_simt(int Q, int N, int PS) {
  const size_t lq = Q + 4, ln = N + 4, lj = (Q < 32 ? Q : 32) + 4;
  return 4 * (PS * lq + 2 * Q * ln + Q * lj + PS * ln + 4 * (size_t)Q);
}

// seg = cumsum(dt * a) in position order (one thread), then exp(seg_i) and
// exp(seg_last - seg_j) * dt_j for every position; returns exp(seg_last).
__device__ __forceinline__ float chunk_decays(const float* dts, float a,
                                              float* seg, float* ecs,
                                              float* ws, int Q) {
  if (threadIdx.x == 0) {
    // eight terms read ahead into registers, so the adds do not wait on
    // shared memory (Q is a multiple of 16)
    float run = 0.0f;
    for (int i0 = 0; i0 < Q; i0 += 8) {
      float d[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) d[k] = dts[i0 + k];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        run = __fadd_rn(run, __fmul_rn(d[k], a));
        seg[i0 + k] = run;
      }
    }
  }
  __syncthreads();
  const float last = seg[Q - 1];
  for (int i = threadIdx.x; i < Q; i += blockDim.x) {
    ecs[i] = expf(seg[i]);
    ws[i] = expf(last - seg[i]) * dts[i];
  }
  __syncthreads();
  return expf(last);
}

// ------------------------------------------------ bfloat16: tensor cores --
template <int PS>
__global__ void __launch_bounds__(kMmaThreads)
ssd_mma_kernel(const __nv_bfloat16* __restrict__ x,
               const float* __restrict__ dt, const float* __restrict__ A,
               const __nv_bfloat16* __restrict__ Bm,
               const __nv_bfloat16* __restrict__ Cm, float* __restrict__ y,
               int S, int H, int G, int N, int P, int Q) {
  constexpr int NT = PS / 8;            // n8 tiles of the P slice
  constexpr int LDX = PS + 8;           // padded rows: conflict-free ldmatrix
  constexpr int kMaxK = kMaxN / 16;     // k16 steps of the widest state
  const int Np = round_up(N, 16), LDN = Np + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // [Q][LDX]
  __nv_bfloat16* bs = xs + Q * LDX;                             // [Q][LDN]
  __nv_bfloat16* cs = bs + Q * LDN;                             // [Q][LDN]
  float* dts = reinterpret_cast<float*>(cs + Q * LDN);          // [Q]
  // the state as bf16 hi [Np][LDX], then lo [Np][LDX]
  __nv_bfloat16* st_bf = reinterpret_cast<__nv_bfloat16*>(dts + Q);
  float* seg = reinterpret_cast<float*>(st_bf + 2 * Np * LDX);
  float* ecs = seg + Q;
  float* ws = ecs + Q;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / H, h = blockIdx.x % H, grp = h / (H / G);
  const int p0 = blockIdx.y * PS;
  const float a = A[h];

  // Zero the padding columns [N, Np) of B and C (never copied) and the
  // state.
  for (int i = tid; i < Q * (Np - N); i += kMmaThreads) {
    const int j = i / (Np - N), c = N + i % (Np - N);
    bs[j * LDN + c] = __float2bfloat16_rn(0.0f);
    cs[j * LDN + c] = __float2bfloat16_rn(0.0f);
  }
  for (int i = tid; i < 2 * Np * LDX; i += kMmaThreads)
    st_bf[i] = __float2bfloat16_rn(0.0f);

  // One stage: chunk c + 1's copies start once chunk c is consumed; the
  // two or three other blocks on the SM compute meanwhile.
  auto load_chunk = [&](int c) {
    const long long r0 = (long long)b * S + (long long)c * Q;
    for (int i = tid; i < Q * (PS / 8); i += kMmaThreads) {
      const int j = i / (PS / 8), k = i % (PS / 8);
      cp_async16(xs + j * LDX + 8 * k,
                 x + ((r0 + j) * H + h) * P + p0 + 8 * k);
    }
    for (int i = tid; i < Q * (N / 8); i += kMmaThreads) {
      const int j = i / (N / 8), k = i % (N / 8);
      const long long off = ((r0 + j) * G + grp) * N + 8 * k;
      cp_async16(bs + j * LDN + 8 * k, Bm + off);
      cp_async16(cs + j * LDN + 8 * k, Cm + off);
    }
    for (int i = tid; i < Q; i += kMmaThreads)
      cp_async4(dts + i, dt + (r0 + i) * H + h);
  };

  // The float32 state: warp w owns state rows [16 m, 16 m + 16) for
  // m = w, w + 4 (below Np); fragment layout of the mma accumulator.
  float st[2][NT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[m][n][e] = 0.0f;

  const int n_chunks = S / Q, n_tiles = Q / 16;
  load_chunk(0);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<0>();
    __syncthreads();
    const float decay = chunk_decays(dts, a, seg, ecs, ws, Q);
    const long long r0 = (long long)b * S + (long long)c * Q;

    // -- y for this warp's row tiles: t and 7 - t of every 8 ---------------
    for (int base = 0; base < n_tiles; base += 8) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int it = base + (half ? 7 - warp : warp);
        if (it >= n_tiles) continue;
        const int i0 = 16 * it;
        unsigned cfr[kMaxK][4];       // C rows i0.. as A fragments, k over N
#pragma unroll
        for (int kk = 0; kk < kMaxK; ++kk)
          if (16 * kk < Np)
            ldsm_x4(cfr[kk], cs + (i0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                      LDN +
                                  16 * kk + (lane >> 4) * 8);
        float acc[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
        // carried-in term: (C_i @ state) * exp(seg_i)
#pragma unroll
        for (int kk = 0; kk < kMaxK; ++kk) {
          if (16 * kk >= Np) break;
#pragma unroll
          for (int part = 0; part < 2; ++part)
#pragma unroll
            for (int np = 0; np < NT / 2; ++np) {
              unsigned bf[4];
              ldsm_x4_t(bf, st_bf + part * Np * LDX +
                                (16 * kk + (lane & 7) +
                                 ((lane >> 3) & 1) * 8) * LDX +
                                16 * np + (lane >> 4) * 8);
              mma_bf16(acc[2 * np], cfr[kk], bf[0], bf[1]);
              mma_bf16(acc[2 * np + 1], cfr[kk], bf[2], bf[3]);
            }
        }
        const float e_lo = ecs[i0 + g], e_hi = ecs[i0 + g + 8];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          acc[n][0] *= e_lo;
          acc[n][1] *= e_lo;
          acc[n][2] *= e_hi;
          acc[n][3] *= e_hi;
        }
        // diagonal block, 16 score columns at a time
        const float seg_lo = seg[i0 + g], seg_hi = seg[i0 + g + 8];
        for (int jt = 0; jt <= it; ++jt) {
          float sc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f},
                            {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
          for (int kk = 0; kk < kMaxK; ++kk) {
            if (16 * kk >= Np) break;
            unsigned bf[4];
            ldsm_x4(bf, bs + (16 * jt + (lane & 7) + (lane >> 4) * 8) * LDN +
                            16 * kk + ((lane >> 3) & 1) * 8);
            mma_bf16(sc[0], cfr[kk], bf[0], bf[1]);
            mma_bf16(sc[1], cfr[kk], bf[2], bf[3]);
          }
          unsigned af[4], al[4];
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            float v[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = i0 + g + (e >= 2 ? 8 : 0);
              const int col = 16 * jt + 8 * n + 2 * t + (e & 1);
              v[e] = col <= row ? sc[n][e] *
                                      __expf((e >= 2 ? seg_hi : seg_lo) -
                                             seg[col]) *
                                      dts[col]
                                : 0.0f;
            }
            split_bf16(v[0], v[1], af[2 * n], al[2 * n]);
            split_bf16(v[2], v[3], af[2 * n + 1], al[2 * n + 1]);
          }
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            unsigned bf[4];
            ldsm_x4_t(bf, xs + (16 * jt + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                   LDX +
                              16 * np + (lane >> 4) * 8);
            mma_bf16(acc[2 * np], af, bf[0], bf[1]);
            mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
            mma_bf16(acc[2 * np], al, bf[0], bf[1]);
            mma_bf16(acc[2 * np + 1], al, bf[2], bf[3]);
          }
        }
        float* ylo = y + ((r0 + i0 + g) * H + h) * P + p0 + 2 * t;
        float* yhi = ylo + 8LL * H * P;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          *reinterpret_cast<float2*>(ylo + 8 * n) =
              make_float2(acc[n][0], acc[n][1]);
          *reinterpret_cast<float2*>(yhi + 8 * n) =
              make_float2(acc[n][2], acc[n][3]);
        }
      }
    }

    // -- state = decay * state + (B * w)^T x --------------------------------
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int mt = warp + 4 * m;
      if (16 * mt >= Np) continue;
      float contrib[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) contrib[n][e] = 0.0f;
      for (int kk = 0; kk < n_tiles; ++kk) {
        unsigned bt[4], af[4], al[4];
        ldsm_x4_t(bt, bs + (16 * kk + (lane & 7) + (lane >> 4) * 8) * LDN +
                          16 * mt + ((lane >> 3) & 1) * 8);
        const int j = 16 * kk + 2 * t;
#pragma unroll
        for (int r = 0; r < 4; ++r) {   // k columns j, j+1 (r < 2) or j+8, j+9
          const float2 f = unpack_bf16(bt[r]);
          const int k = j + (r >= 2 ? 8 : 0);
          split_bf16(f.x * ws[k], f.y * ws[k + 1], af[r], al[r]);
        }
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          unsigned bf[4];
          ldsm_x4_t(bf, xs + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                 LDX +
                            16 * np + (lane >> 4) * 8);
          mma_bf16(contrib[2 * np], af, bf[0], bf[1]);
          mma_bf16(contrib[2 * np + 1], af, bf[2], bf[3]);
          mma_bf16(contrib[2 * np], al, bf[0], bf[1]);
          mma_bf16(contrib[2 * np + 1], al, bf[2], bf[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          st[m][n][e] = fmaf(decay, st[m][n][e], contrib[n][e]);
    }
    __syncthreads();  // every read of the old state and of the tiles done
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int mt = warp + 4 * m;
      if (16 * mt >= Np) continue;
      unsigned* hi_row = reinterpret_cast<unsigned*>(
          st_bf + (16 * mt + g) * LDX + 2 * t);
      unsigned* lo_row = hi_row + Np * LDX / 2;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        split_bf16(st[m][n][0], st[m][n][1], hi_row[4 * n], lo_row[4 * n]);
        split_bf16(st[m][n][2], st[m][n][3], hi_row[4 * LDX + 4 * n],
                   lo_row[4 * LDX + 4 * n]);
      }
    }
    if (c + 1 < n_chunks) {
      load_chunk(c + 1);  // the tiles are free: the barrier above
      cp_async_commit();
    }
  }
}

// --------------------------------------------------- float32: CUDA cores --
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The scores of a block of columns j0 + jt + CG v (v < NV: 4, or 2 in
// the 16-wide last block of a chunk that is not a multiple of 32), scaled
// by exp(seg_i - seg_j) dt_j and masked to j <= i, into gs: a 4 x NV tile
// a thread, rows it + RG u.
template <int NV>
__device__ __forceinline__ void simt_scores(const float* bs, const float* cs,
                                            const float* seg, const float* dts,
                                            float* gs, int j0, int N, int LN,
                                            int LJ, int RG, int CG) {
  for (int task = threadIdx.x; task < RG * CG; task += kSimtThreads) {
    const int jt = task % CG, it = task / CG;
    const int u0 = j0 / RG;   // the row bands above the block are 0
    float sc[4][NV];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < NV; ++v) sc[u][v] = 0.0f;
    for (int n = 0; n < N; n += 4) {
      float4 bv[NV];
#pragma unroll
      for (int v = 0; v < NV; ++v)
        bv[v] = lds4(bs + (j0 + jt + CG * v) * LN + n);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (u < u0) continue;
        const float4 cv = lds4(cs + (it + RG * u) * LN + n);
#pragma unroll
        for (int v = 0; v < NV; ++v) sc[u][v] = dot4(cv, bv[v], sc[u][v]);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (u < u0) continue;
      const int i = it + RG * u;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int j = j0 + jt + CG * v;
        gs[i * LJ + jt + CG * v] =
            j <= i ? sc[u][v] * __expf(seg[i] - seg[j]) * dts[j] : 0.0f;
      }
    }
  }
}

// Shared tiles (floats): x^T [PS][Q+4], B and C [Q][N+4], a block of the
// scores G [Q][JB+4], the state^T [PS][N+4] and dt/seg/exp terms [4][Q].
// Rows padded by 4 floats: neighbouring rows start on neighbouring 16-byte
// bank groups.  Thread tiles take rows r + R * u (R = rows / tile rows), so
// the lanes of a warp read neighbouring rows and skip the causal triangle
// in whole bands of rows.
template <int PS>
__global__ void __launch_bounds__(kSimtThreads)
ssd_simt_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, float* __restrict__ y, int S,
                int H, int G, int N, int P, int Q) {
  constexpr int TP = PS / 16;           // output columns a thread: pg + 16 v
  const int LQ = Q + 4, LN = N + 4;
  const int JB = Q < 32 ? Q : 32, LJ = JB + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* xt = reinterpret_cast<float*>(smem);  // [PS][LQ]
  float* bs = xt + PS * LQ;                     // [Q][LN]
  float* cs = bs + Q * LN;                      // [Q][LN]
  float* gs = cs + Q * LN;                      // [Q][LJ]
  float* stt = gs + Q * LJ;                     // [PS][LN]
  float* dts = stt + PS * LN;
  float* seg = dts + Q;
  float* ecs = seg + Q;
  float* ws = ecs + Q;

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H, h = blockIdx.x % H, grp = h / (H / G);
  const int p0 = blockIdx.y * PS;
  const float a = A[h];
  for (int i = tid; i < PS * LN; i += kSimtThreads) stt[i] = 0.0f;

  // y tile: rows ig + (Q/8) u (u < 8), columns pg + 16 v (v < TP)
  const int RY = Q / 8;
  const bool y_task = tid < RY * 16;
  const int pg = tid & 15, ig = tid >> 4;
  // score tile: rows it + (Q/4) u, columns jt + (JB/4) v (u, v < 4)
  const int RG = Q / 4, CG = JB / 4;

  for (int c = 0; c < S / Q; ++c) {
    const long long r0 = (long long)b * S + (long long)c * Q;
    __syncthreads();  // the last chunk is done with the tiles
    // B, C and dt by cp.async; x's vectors all requested before the first
    // transposed store (Q * PS / 4 <= 8 a thread)
    for (int i = tid; i < Q * (N / 4); i += kSimtThreads) {
      const int j = i / (N / 4), k = i % (N / 4);
      const long long off = ((r0 + j) * G + grp) * N + 4 * k;
      cp_async16(bs + j * LN + 4 * k, Bm + off);
      cp_async16(cs + j * LN + 4 * k, Cm + off);
    }
    for (int i = tid; i < Q; i += kSimtThreads)
      cp_async4(dts + i, dt + (r0 + i) * H + h);
    cp_async_commit();
    {
      constexpr int kXV = 128 * PS / 4 / kSimtThreads;
      float4 v[kXV];
#pragma unroll
      for (int r = 0; r < kXV; ++r) {
        const int i = tid + r * kSimtThreads;
        if (i < Q * (PS / 4))
          v[r] = __ldg(reinterpret_cast<const float4*>(
              x + ((r0 + i / (PS / 4)) * H + h) * P + p0 + 4 * (i % (PS / 4))));
      }
#pragma unroll
      for (int r = 0; r < kXV; ++r) {
        const int i = tid + r * kSimtThreads;
        if (i < Q * (PS / 4)) {
          const int j = i / (PS / 4), k = i % (PS / 4);
          xt[(4 * k) * LQ + j] = v[r].x;
          xt[(4 * k + 1) * LQ + j] = v[r].y;
          xt[(4 * k + 2) * LQ + j] = v[r].z;
          xt[(4 * k + 3) * LQ + j] = v[r].w;
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();
    const float decay = chunk_decays(dts, a, seg, ecs, ws, Q);

    // -- carried-in term: exp(seg_i) * (C_i . state) ------------------------
    float acc[8][TP];
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int v = 0; v < TP; ++v) acc[u][v] = 0.0f;
    if (y_task) {
      for (int n = 0; n < N; n += 4) {
        float4 sv[TP];
#pragma unroll
        for (int v = 0; v < TP; ++v) sv[v] = lds4(stt + (pg + 16 * v) * LN + n);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float4 cv = lds4(cs + (ig + RY * u) * LN + n);
#pragma unroll
          for (int v = 0; v < TP; ++v) acc[u][v] = dot4(cv, sv[v], acc[u][v]);
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float e = ecs[ig + RY * u];
#pragma unroll
        for (int v = 0; v < TP; ++v) acc[u][v] *= e;
      }
    }

    // -- diagonal block, JB score columns at a time; the last block of a
    // chunk that is not a multiple of 32 (48, 80, 112) is 16 wide: its
    // columns stop at Q, past which B's rows and x's padding are not read --
    for (int j0 = 0; j0 < Q; j0 += JB) {
      const int jb = min(JB, Q - j0);
      __syncthreads();  // the last score block is consumed
      if (jb == 4 * CG)
        simt_scores<4>(bs, cs, seg, dts, gs, j0, N, LN, LJ, RG, CG);
      else
        simt_scores<2>(bs, cs, seg, dts, gs, j0, N, LN, LJ, RG, CG);
      __syncthreads();
      if (!y_task) continue;
      const int u0 = j0 / RY;     // the row bands above the block
      for (int jj = 0; jj < jb; jj += 4) {
        float4 xv[TP];
#pragma unroll
        for (int v = 0; v < TP; ++v)
          xv[v] = lds4(xt + (pg + 16 * v) * LQ + j0 + jj);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          if (u < u0) continue;
          const float4 gv = lds4(gs + (ig + RY * u) * LJ + jj);
#pragma unroll
          for (int v = 0; v < TP; ++v) acc[u][v] = dot4(gv, xv[v], acc[u][v]);
        }
      }
    }
    if (y_task) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        float* yr = y + ((r0 + ig + RY * u) * H + h) * P + p0 + pg;
#pragma unroll
        for (int v = 0; v < TP; ++v) yr[16 * v] = acc[u][v];
      }
    }
    __syncthreads();  // every read of the old state is done

    // -- state = decay * state + (B * w)^T x: rows n0..n0+3, columns
    // pg + 16 v ---------------------------------------------------------------
    for (int task = tid; task < (N / 4) * 16; task += kSimtThreads) {
      const int sp = task & 15, n0 = 4 * (task >> 4);
      float cn[4][TP];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int v = 0; v < TP; ++v) cn[r][v] = 0.0f;
      for (int j = 0; j < Q; j += 4) {
        const float4 wq = lds4(ws + j);
        const float wv[4] = {wq.x, wq.y, wq.z, wq.w};
        float4 xq[TP];
#pragma unroll
        for (int v = 0; v < TP; ++v) xq[v] = lds4(xt + (sp + 16 * v) * LQ + j);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float4 bq = lds4(bs + (j + k) * LN + n0);
          const float bv[4] = {bq.x * wv[k], bq.y * wv[k], bq.z * wv[k],
                               bq.w * wv[k]};
#pragma unroll
          for (int v = 0; v < TP; ++v) {
            const float xv = k == 0 ? xq[v].x : k == 1 ? xq[v].y
                             : k == 2 ? xq[v].z : xq[v].w;
#pragma unroll
            for (int r = 0; r < 4; ++r) cn[r][v] = fmaf(bv[r], xv, cn[r][v]);
          }
        }
      }
#pragma unroll
      for (int v = 0; v < TP; ++v) {
        float4* sp4 =
            reinterpret_cast<float4*>(stt + (sp + 16 * v) * LN + n0);
        const float4 o = *sp4;
        *sp4 = make_float4(
            fmaf(decay, o.x, cn[0][v]), fmaf(decay, o.y, cn[1][v]),
            fmaf(decay, o.z, cn[2][v]), fmaf(decay, o.w, cn[3][v]));
      }
    }
  }
}

template <int PS>
int launch_mma(const __nv_bfloat16* x, const float* dt, const float* A,
               const __nv_bfloat16* Bm, const __nv_bfloat16* Cm, float* y,
               int batch, int S, int H, int G, int N, int P, int Q,
               cudaStream_t stream) {
  const size_t smem = smem_bytes_mma(Q, N, PS);
  cudaError_t err = repro_torch::allow_smem(ssd_mma_kernel<PS>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_mma_kernel<PS><<<dim3(batch * H, P / PS), kMmaThreads, smem, stream>>>(
      x, dt, A, Bm, Cm, y, S, H, G, N, P, Q);
  return static_cast<int>(cudaGetLastError());
}

template <int PS>
int launch_simt(const float* x, const float* dt, const float* A,
                const float* Bm, const float* Cm, float* y, int batch, int S,
                int H, int G, int N, int P, int Q, cudaStream_t stream) {
  const size_t smem = smem_bytes_simt(Q, N, PS);
  cudaError_t err = repro_torch::allow_smem(ssd_simt_kernel<PS>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_simt_kernel<PS><<<dim3(batch * H, P / PS), kSimtThreads, smem,
                        stream>>>(x, dt, A, Bm, Cm, y, S, H, G, N, P, Q);
  return static_cast<int>(cudaGetLastError());
}

// The shapes the kernels take (the wrapper checks them first): Q a
// multiple of 16 up to 128, N a multiple of 8 up to kMaxN, P a multiple of
// PS.
bool shape_ok(int N, int P, int Q, int ps) {
  return Q >= 16 && Q <= 128 && Q % 16 == 0 && N >= 8 && N % 8 == 0 &&
         N <= kMaxN && (ps == 32 || ps == 64) && P % ps == 0;
}

}  // namespace

extern "C" int ssd_scan_f32(const float* x, const float* dt, const float* A,
                            const float* Bm, const float* Cm, float* y,
                            int batch, int S, int H, int G, int N, int P,
                            int Q, int ps, void* stream) {
  if (!shape_ok(N, P, Q, ps)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return ps == 64 ? launch_simt<64>(x, dt, A, Bm, Cm, y, batch, S, H, G, N, P,
                                    Q, s)
                  : launch_simt<32>(x, dt, A, Bm, Cm, y, batch, S, H, G, N, P,
                                    Q, s);
}

extern "C" int ssd_scan_bf16(const __nv_bfloat16* x, const float* dt,
                             const float* A, const __nv_bfloat16* Bm,
                             const __nv_bfloat16* Cm, float* y, int batch,
                             int S, int H, int G, int N, int P, int Q, int ps,
                             void* stream) {
  if (!shape_ok(N, P, Q, ps)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return ps == 64 ? launch_mma<64>(x, dt, A, Bm, Cm, y, batch, S, H, G, N, P,
                                   Q, s)
                  : launch_mma<32>(x, dt, A, Bm, Cm, y, batch, S, H, G, N, P,
                                   Q, s);
}
