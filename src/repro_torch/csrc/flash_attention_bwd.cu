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
// input type; D in {64, 128}.  lse [B, H, S] float32 is each row's
// natural log-sum-exp of the scaled, masked scores, which the forward
// kernel writes when autograd records its call, so P = exp(scale s - lse)
// needs no second walk over the keys.
//
// FlashAttention-2's backward as two kernels in order on the caller's
// stream:
//   dq: a block per (64-row query tile, head, batch) takes delta (written
//     to float32 scratch for the second kernel), then walks the key tiles:
//     S = q k^T and dP = dO v^T, P and dS from lse and delta, dq += dS k.
//   dk/dv: a block per (64-key tile, KV head, batch) walks the G = H / KV
//     query heads of its KV head and their query tiles: S^T = k q^T and
//     dP^T = v dO^T, then dv += P^T dO and dk += dS^T q.  A block owns its
//     keys' whole sums, so GQA needs no atomics and two runs agree bit for
//     bit.
// That is 7 S x T x D products a head (FlashAttention-2's one-kernel form
// has 5, but sums dq across key blocks with float atomics).  Both kernels
// visit only the tiles the mask leaves anything in, as the forward does: a
// causal query tile walks keys up to its last row, a key tile queries from
// its first row; a window bounds both walks.
//
// What bounds it on the H100: at qwen3-0.6b's shape ([4, 512, 16 / 8,
// 128], causal) the products, 7 x 2 S T D / 2 flops a head, take 0.016 ms
// at the bf16 tensor-core rate, about the time to move q, k, v, O, dO and
// the three gradients once (0.015 ms): neither, in practice, but the
// latency of each warp's chain of shared-memory fragment loads and
// mma.sync, at 4 warps a block and 2-4 blocks an SM (wgmma, and one pass
// for the five products, are ROADMAP.md A.2's).
//
// bfloat16 (`flash_bwd_*_mma`): 4 warps a block, tiles kept in bf16 in
// shared memory (rows padded by 16 bytes: ldmatrix reads 8 rows in 8
// distinct bank groups).  Every product is mma.sync m16n8k16 with bf16
// operands and float32 accumulators; P and dS are rounded to bf16 for
// their products, as SDPA does.  The streamed tiles (k / v in dq, q / dO
// and their lse / delta in dk/dv) come by cp.async into two stages, the
// next tile's copies in flight while the current one is multiplied; rows
// past S or T arrive as zeros.  dq: warp w owns query rows 16 w .. 16 w +
// 15 of its tile; S and dP (16 x 64 a warp) stay in registers, and dS
// becomes the A operand of dS k without leaving them.  dk/dv: warp w owns
// keys 16 w .. 16 w + 15; a query tile goes in two halves of 32, so S^T,
// dP^T and the two [16, D] accumulators fit the registers at D = 128.
//
// float32 keeps SIMT FMAs (TF32 cannot meet the 1e-4 gradient gate):
// thread (ty, tx) of a 16 x 16 grid owns rows 4 ty .. 4 ty + 3 of its
// block's tile (queries in dq, keys in dkdv), score columns tx + 16 j and
// output columns tx + 16 c, as the forward's SIMT kernel; tiles live in
// shared memory as float32 rows padded to D + 1.
#include "mma.cuh"

namespace {

using namespace repro_torch::mma;
using repro_torch::allow_smem_once;
using bf16 = __nv_bfloat16;

constexpr int kBr = 64;        // query rows a tile
constexpr int kBc = 64;        // keys a tile
constexpr float kLog2e = 1.4426950408889634f;

// The forward's mask: key kp is hidden from query qp.
__device__ __forceinline__ bool hidden(int qp, int kp, int Tk, int causal,
                                       int window) {
  return kp >= Tk || (causal && kp > qp) || (window && qp - kp >= window);
}

// ------------------------------------------------ bfloat16: tensor cores --
constexpr int kMmaThreads = 128;  // 4 warps

template <int D>
struct MmaTiles {
  static constexpr int kLd = D + 8;            // padded bf16 row
  static constexpr int kTile = kBr * kLd;      // elements of a 64-row tile
  // dq: q, dO, then two stages of (k, v); then delta [64]
  static constexpr size_t kDqSmem = 2 * 6 * (size_t)kTile + 4 * kBr;
  // dk/dv: k, v, then two stages of (q, dO); then lse, delta [2][64] each
  static constexpr size_t kDkdvSmem = 2 * 6 * (size_t)kTile + 4 * 4 * kBr;
};

// Rows r0 .. r0 + 63 of one head of a [batch, n, heads, D] bf16 tensor (src
// points at the head's row 0, rows `rstride` apart) into a padded tile by
// cp.async; rows past n are zeros.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst,
                                          const bf16* __restrict__ src,
                                          long long rstride, int r0, int n) {
  constexpr int kChunks = D / 8;  // 16 bytes each
  for (int i = threadIdx.x; i < kBr * kChunks; i += kMmaThreads) {
    const int r = i / kChunks, c = i % kChunks, t = r0 + r;
    cp_async16(dst + r * MmaTiles<D>::kLd + 8 * c,
               src + (long long)min(t, n - 1) * rstride + 8 * c,
               t < n ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ o,
                 const bf16* __restrict__ dout, bf16* __restrict__ dq,
                 const float* __restrict__ lse, float* __restrict__ delta_out,
                 int S, int Tk, int H, int KV, int causal, int window,
                 float scale) {
  using L = MmaTiles<D>;
  constexpr int LD = L::kLd;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + L::kTile;
  bf16* kst = dos + L::kTile;  // stage s: k at kst + 2 s kTile, v after it
  float* dl = reinterpret_cast<float*>(kst + 4 * L::kTile);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // the longest causal query tiles first
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * kBr, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const long long qstride = (long long)H * D, kvstride = (long long)KV * D;
  const long long qoff = ((long long)b * S * H + h) * D;
  const long long kvoff = ((long long)b * Tk * KV + kvh) * D;
  const long long stat = ((long long)b * H + h) * S;
  const int kv_end = causal ? min(Tk, q0 + kBr) : Tk;
  const int kv_begin = window ? max(0, q0 - window + 1) / kBc * kBc : 0;
  const int n_tiles = (kv_end - kv_begin + kBc - 1) / kBc;

  auto load_kv = [&](int j) {
    bf16* ks = kst + 2 * (j & 1) * L::kTile;
    load_tile<D>(ks, k + kvoff, kvstride, kv_begin + j * kBc, Tk);
    load_tile<D>(ks + L::kTile, v + kvoff, kvstride, kv_begin + j * kBc, Tk);
  };
  load_tile<D>(qs, q + qoff, qstride, q0, S);
  load_tile<D>(dos, dout + qoff, qstride, q0, S);
  if (n_tiles > 0) load_kv(0);
  cp_async_commit();
  if (n_tiles > 1) load_kv(1);
  cp_async_commit();

  // delta = rowsum(dO * O): two threads a row, each half the columns
  cp_async_wait<1>();
  __syncthreads();
  {
    const int r = tid >> 1, c0 = (tid & 1) * (D / 2), s = q0 + r;
    float acc = 0.0f;
    if (s < S) {
      const bf16* orow = o + qoff + s * qstride + c0;
#pragma unroll 8
      for (int c = 0; c < D / 2; c += 2) {
        const float2 ov = unpack_bf16(
            *reinterpret_cast<const unsigned*>(orow + c));
        const float2 gv = unpack_bf16(
            *reinterpret_cast<const unsigned*>(dos + r * LD + c0 + c));
        acc = fmaf(gv.x, ov.x, acc);
        acc = fmaf(gv.y, ov.y, acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((tid & 1) == 0) {
      dl[r] = acc;
      if (s < S) delta_out[stat + s] = acc;
    }
  }
  __syncthreads();

  const float scale_log2 = scale * kLog2e;
  const int r_lo = 16 * warp + g, r_hi = r_lo + 8;  // rows of the tile
  const float lse_lo = q0 + r_lo < S ? lse[stat + q0 + r_lo] * kLog2e : 0.0f;
  const float lse_hi = q0 + r_hi < S ? lse[stat + q0 + r_hi] * kLog2e : 0.0f;
  const float dl_lo = dl[r_lo], dl_hi = dl[r_hi];

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<1>();
    __syncthreads();  // tile j has landed for every thread
    const bf16* ks = kst + 2 * (j & 1) * L::kTile;
    const bf16* vs = ks + L::kTile;
    const int k0 = kv_begin + j * kBc;

    // S = q k^T and dP = dO v^T, 16 x 64 a warp
    float sc[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      unsigned aq[4], ad[4];
      ldsm_x4(aq, frag_rows(qs, LD, 16 * warp, 16 * kk, lane));
      ldsm_x4(ad, frag_rows(dos, LD, 16 * warp, 16 * kk, lane));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned bk[4], bv[4];
        ldsm_x4(bk, frag_cols(ks, LD, 16 * np, 16 * kk, lane));
        ldsm_x4(bv, frag_cols(vs, LD, 16 * np, 16 * kk, lane));
        mma_bf16(sc[2 * np], aq, bk[0], bk[1]);
        mma_bf16(sc[2 * np + 1], aq, bk[2], bk[3]);
        mma_bf16(dp[2 * np], ad, bv[0], bv[1]);
        mma_bf16(dp[2 * np + 1], ad, bv[2], bv[3]);
      }
    }

    // dS = P (dP - delta) scale, P = exp2(s scale log2(e) - lse log2(e))
    const bool edge = k0 + kBc > Tk || (causal && k0 + kBc - 1 > q0) ||
                      (window && q0 + kBr - 1 - k0 >= window);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * n + 2 * t + (e & 1);
        const int row = q0 + (e >= 2 ? r_hi : r_lo);
        const float p =
            edge && hidden(row, key, Tk, causal, window)
                ? 0.0f
                : fast_exp2(fmaf(sc[n][e], scale_log2,
                                 -(e >= 2 ? lse_hi : lse_lo)));
        sc[n][e] = p * (dp[n][e] - (e >= 2 ? dl_hi : dl_lo)) * scale;
      }

    // dq += dS k over the tile's 64 keys
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      unsigned a[4];
      acc_to_a(a, sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        unsigned bk[4];
        ldsm_x4_t(bk, frag_rows(ks, LD, 16 * kk, 16 * np, lane));
        mma_bf16(acc[2 * np], a, bk[0], bk[1]);
        mma_bf16(acc[2 * np + 1], a, bk[2], bk[3]);
      }
    }
    __syncthreads();  // every warp is done with the stage
    if (j + 2 < n_tiles) load_kv(j + 2);
    cp_async_commit();
  }

  bf16* out = dq + qoff + 2 * t;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (q0 + r_lo < S)
      *reinterpret_cast<unsigned*>(out + (q0 + r_lo) * qstride + 8 * n) =
          pack_bf16(acc[n][0], acc[n][1]);
    if (q0 + r_hi < S)
      *reinterpret_cast<unsigned*>(out + (q0 + r_hi) * qstride + 8 * n) =
          pack_bf16(acc[n][2], acc[n][3]);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkdv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   bf16* __restrict__ dk, bf16* __restrict__ dv,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, int S, int Tk, int H,
                   int KV, int causal, int window, float scale) {
  using L = MmaTiles<D>;
  constexpr int LD = L::kLd;
  constexpr int kHalf = kBr / 2;  // queries a pass over the tile
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + L::kTile;
  bf16* qst = vs + L::kTile;  // stage s: q at qst + 2 s kTile, dO after it
  float* lse_s = reinterpret_cast<float*>(qst + 4 * L::kTile);  // [2][64]
  float* dl_s = lse_s + 2 * kBr;                                // [2][64]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kBc, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const long long qstride = (long long)H * D, kvstride = (long long)KV * D;
  const long long kvoff = ((long long)b * Tk * KV + kvh) * D;
  // the queries that see a key of this tile
  const int q_begin = causal ? k0 / kBr * kBr : 0;
  const int q_end = window ? min(S, k0 + kBc - 1 + window) : S;
  const int n_q = max(0, (q_end - q_begin + kBr - 1) / kBr);
  const int n_steps = G * n_q;

  auto load_q = [&](int st) {  // step st: head kvh G + st / n_q
    const int h = kvh * G + st / n_q, q0 = q_begin + (st % n_q) * kBr;
    const int s = st & 1;
    const long long qoff = ((long long)b * S * H + h) * D;
    const long long stat = ((long long)b * H + h) * S;
    bf16* qs = qst + 2 * s * L::kTile;
    load_tile<D>(qs, q + qoff, qstride, q0, S);
    load_tile<D>(qs + L::kTile, dout + qoff, qstride, q0, S);
    if (tid < kBr) {
      const int r = q0 + tid, ok = r < S ? 4 : 0;
      const long long at = stat + min(r, S - 1);
      cp_async4(lse_s + s * kBr + tid, lse + at, ok);
      cp_async4(dl_s + s * kBr + tid, delta + at, ok);
    }
  };
  load_tile<D>(ks, k + kvoff, kvstride, k0, Tk);
  load_tile<D>(vs, v + kvoff, kvstride, k0, Tk);
  if (n_steps > 0) load_q(0);
  cp_async_commit();
  if (n_steps > 1) load_q(1);
  cp_async_commit();

  const float scale_log2 = scale * kLog2e;
  const int kw = k0 + 16 * warp;           // this warp's first key
  const int key_lo = kw + g, key_hi = key_lo + 8;
  float adk[D / 8][4], adv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.0f;

  for (int st = 0; st < n_steps; ++st) {
    cp_async_wait<1>();
    __syncthreads();  // step st's tiles have landed for every thread
    const int s = st & 1;
    const int q0 = q_begin + (st % n_q) * kBr;
    const bf16* qs = qst + 2 * s * L::kTile;
    const bf16* dos = qs + L::kTile;
    const float* ls = lse_s + s * kBr;
    const float* ds = dl_s + s * kBr;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c0 = kHalf * half, qa = q0 + c0;  // the half's first query
      // nothing of the half is visible to this warp's keys
      if ((causal && qa + kHalf - 1 < kw) ||
          (window && qa - (kw + 15) >= window))
        continue;
      float sc[4][4], dp[4][4];  // [16 keys][32 queries]
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        unsigned ak[4], av[4];
        ldsm_x4(ak, frag_rows(ks, LD, 16 * warp, 16 * kk, lane));
        ldsm_x4(av, frag_rows(vs, LD, 16 * warp, 16 * kk, lane));
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          unsigned bq[4], bd[4];
          ldsm_x4(bq, frag_cols(qs, LD, c0 + 16 * np, 16 * kk, lane));
          ldsm_x4(bd, frag_cols(dos, LD, c0 + 16 * np, 16 * kk, lane));
          mma_bf16(sc[2 * np], ak, bq[0], bq[1]);
          mma_bf16(sc[2 * np + 1], ak, bq[2], bq[3]);
          mma_bf16(dp[2 * np], av, bd[0], bd[1]);
          mma_bf16(dp[2 * np + 1], av, bd[2], bd[3]);
        }
      }
      // P^T and dS^T (scaled), masked by the forward's mask
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + 8 * n + 2 * t + (e & 1), qp = q0 + col;
          const int key = e >= 2 ? key_hi : key_lo;
          const float p =
              qp >= S || hidden(qp, key, Tk, causal, window)
                  ? 0.0f
                  : fast_exp2(fmaf(sc[n][e], scale_log2, -ls[col] * kLog2e));
          sc[n][e] = p;
          dp[n][e] = p * (dp[n][e] - ds[col]) * scale;
        }
      // dv += P^T dO, dk += dS^T q over the half's 32 queries
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        unsigned ap[4], as[4];
        acc_to_a(ap, sc[2 * kk], sc[2 * kk + 1]);
        acc_to_a(as, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          unsigned bd[4], bq[4];
          ldsm_x4_t(bd, frag_rows(dos, LD, c0 + 16 * kk, 16 * np, lane));
          ldsm_x4_t(bq, frag_rows(qs, LD, c0 + 16 * kk, 16 * np, lane));
          mma_bf16(adv[2 * np], ap, bd[0], bd[1]);
          mma_bf16(adv[2 * np + 1], ap, bd[2], bd[3]);
          mma_bf16(adk[2 * np], as, bq[0], bq[1]);
          mma_bf16(adk[2 * np + 1], as, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with the stage
    if (st + 2 < n_steps) load_q(st + 2);
    cp_async_commit();
  }

#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = 8 * n + 2 * t;
    if (key_lo < Tk) {
      const long long at = kvoff + key_lo * kvstride + col;
      *reinterpret_cast<unsigned*>(dk + at) = pack_bf16(adk[n][0], adk[n][1]);
      *reinterpret_cast<unsigned*>(dv + at) = pack_bf16(adv[n][0], adv[n][1]);
    }
    if (key_hi < Tk) {
      const long long at = kvoff + key_hi * kvstride + col;
      *reinterpret_cast<unsigned*>(dk + at) = pack_bf16(adk[n][2], adk[n][3]);
      *reinterpret_cast<unsigned*>(dv + at) = pack_bf16(adv[n][2], adv[n][3]);
    }
  }
}

// ---------------------------------------------------- float32: CUDA cores --
constexpr int kThreads = 256;  // a 16 x 16 grid
constexpr int kPP = kBc + 1;   // padded rows of the P / dS tiles

__device__ __forceinline__ float half_warp_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows r0 .. r0 + 63 of one head of a [batch, n, heads, D] tensor (src
// points at the head's row 0, rows `rstride` apart) into a [64][D + 1]
// float tile; rows past n are zeros.
template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst,
                                              const float* __restrict__ src,
                                              long long rstride, int r0,
                                              int n) {
  for (int i = threadIdx.x; i < kBr * D; i += kThreads) {
    const int r = i / D, c = i % D, t = r0 + r;
    dst[r * (D + 1) + c] = t < n ? src[(long long)t * rstride + c] : 0.0f;
  }
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

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_simt(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ o,
                  const float* __restrict__ dout, float* __restrict__ dq,
                  const float* __restrict__ lse, float* __restrict__ delta_out,
                  int S, int Tk, int H, int KV, int causal, int window,
                  float scale) {
  constexpr int DP = D + 1;
  constexpr int NC = D / 16;  // output columns a thread owns
  extern __shared__ float smem_f[];
  float* qs = smem_f;           // [kBr][DP]
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
  const long long stat = ((long long)b * H + h) * S;
  load_tile_f32<D>(qs, q + qoff, qstride, q0, S);
  load_tile_f32<D>(dos, dout + qoff, qstride, q0, S);
  __syncthreads();

  // delta = rowsum(dO * O), over the half-warp that owns the row
  float delta[4], lrow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, s = q0 + r;
    float acc = 0.0f;
    if (s < S) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        acc = fmaf(dos[r * DP + col], o[qoff + s * qstride + col], acc);
      }
    }
    delta[i] = half_warp_sum(acc);
    lrow[i] = s < S ? lse[stat + s] : 0.0f;
  }

  const int kv_end = causal ? min(Tk, q0 + kBr) : Tk;
  const int kv_begin = window ? max(0, q0 - window + 1) / kBc * kBc : 0;

  // dq += scale dS k
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  for (int k0 = kv_begin; k0 < kv_end; k0 += kBc) {
    __syncthreads();  // the last tile's reads are done
    load_tile_f32<D>(ks, k + kvoff, kvstride, k0, Tk);
    load_tile_f32<D>(vs, v + kvoff, kvstride, k0, Tk);
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
                            : expf(sc[i][j] * scale - lrow[i]);
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= S) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      dq[qoff + s * qstride + tx + 16 * c] = acc[i][c];
    if (tx == 0) delta_out[stat + s] = delta[i];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_simt(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout, float* __restrict__ dk,
                    float* __restrict__ dv, const float* __restrict__ lse,
                    const float* __restrict__ delta, int S, int Tk, int H,
                    int KV, int causal, int window, float scale) {
  constexpr int DP = D + 1;
  constexpr int NC = D / 16;
  extern __shared__ float smem_f[];
  float* ks = smem_f;            // [kBc][DP]
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
  load_tile_f32<D>(ks, k + kvoff, kvstride, k0, Tk);
  load_tile_f32<D>(vs, v + kvoff, kvstride, k0, Tk);

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
      load_tile_f32<D>(qs, q + qoff, qstride, q0, S);
      load_tile_f32<D>(dos, dout + qoff, qstride, q0, S);
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
      dk[at] = adk[i][c];
      dv[at] = adv[i][c];
    }
  }
}

// ------------------------------------------------------------ launches --
// The two kernels of one route in order: dq (and delta), then dk / dv.
template <typename T, typename KDq, typename KDkdv>
int launch_pair(KDq dq_kernel, size_t dq_smem, unsigned& dq_set,
                int dq_threads, KDkdv dkdv_kernel, size_t dkdv_smem,
                unsigned& dkdv_set, int dkdv_threads, const T* q, const T* k,
                const T* v, const T* o, const T* dout, T* dq, T* dk, T* dv,
                const float* lse, float* delta, int B, int S, int Tk, int H,
                int KV, int causal, int window, float scale,
                cudaStream_t stream) {
  cudaError_t err = allow_smem_once(dq_kernel, dq_smem, dq_set);
  if (err == cudaSuccess)
    err = allow_smem_once(dkdv_kernel, dkdv_smem, dkdv_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q((S + kBr - 1) / kBr, H, B);
  dq_kernel<<<grid_q, dq_threads, dq_smem, stream>>>(
      q, k, v, o, dout, dq, lse, delta, S, Tk, H, KV, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_k((Tk + kBc - 1) / kBc, KV, B);
  dkdv_kernel<<<grid_k, dkdv_threads, dkdv_smem, stream>>>(
      q, k, v, dout, dk, dv, lse, delta, S, Tk, H, KV, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(const float* q, const float* k, const float* v, const float* o,
             const float* dout, float* dq, float* dk, float* dv,
             const float* lse, float* delta, int B, int S, int Tk, int H,
             int KV, int causal, int window, float scale,
             cudaStream_t stream) {
  static unsigned dq_set = 0, dkdv_set = 0;
  return launch_pair(flash_bwd_dq_simt<D>, dq_smem_bytes<D>(), dq_set,
                     kThreads, flash_bwd_dkdv_simt<D>, dkdv_smem_bytes<D>(),
                     dkdv_set, kThreads, q, k, v, o, dout, dq, dk, dv, lse,
                     delta, B, S, Tk, H, KV, causal, window, scale, stream);
}

template <int D>
int launch_d(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
             const bf16* dout, bf16* dq, bf16* dk, bf16* dv,
             const float* lse, float* delta, int B, int S, int Tk, int H,
             int KV, int causal, int window, float scale,
             cudaStream_t stream) {
  static unsigned dq_set = 0, dkdv_set = 0;
  return launch_pair(flash_bwd_dq_mma<D>, MmaTiles<D>::kDqSmem, dq_set,
                     kMmaThreads, flash_bwd_dkdv_mma<D>,
                     MmaTiles<D>::kDkdvSmem, dkdv_set, kMmaThreads, q, k, v,
                     o, dout, dq, dk, dv, lse, delta, B, S, Tk, H, KV, causal,
                     window, scale, stream);
}

template <typename T>
int launch(const T* q, const T* k, const T* v, const T* o, const T* dout,
           T* dq, T* dk, T* dv, const float* lse, float* delta, int B, int S,
           int Tk, int H, int KV, int D, int causal, int window, float scale,
           void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || Tk < 1 || KV < 1 || H % KV || (causal && S != Tk))
    return static_cast<int>(cudaErrorInvalidValue);
  if (D == 64)
    return launch_d<64>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, S, Tk,
                        H, KV, causal, window, scale, st);
  if (D == 128)
    return launch_d<128>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, S, Tk,
                         H, KV, causal, window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// lse: [B, H, S] float32, the forward's; delta: [B, H, S] float32 scratch,
// written by the dq kernel and read by the dk/dv kernel.  The bf16 route's
// cp.async copies need q, k, v, dO 16-byte aligned (the wrapper's).
extern "C" int flash_attention_bwd_f32(const float* q, const float* k,
                                       const float* v, const float* o,
                                       const float* dout, float* dq,
                                       float* dk, float* dv, const float* lse,
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
    __nv_bfloat16* dk, __nv_bfloat16* dv, const float* lse, float* delta,
    int B, int S, int Tk, int H, int KV, int D, int causal, int window,
    float scale, void* stream) {
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) %
      16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  return launch(q, k, v, o, dout, dq, dk, dv, lse, delta, B, S, Tk, H, KV, D,
                causal, window, scale, stream);
}
