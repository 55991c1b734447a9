// Mamba2 SSD chunked scan, backward: the gradients (dx, ddt, dA, dB, dC)
// of y = ssd_scan(x, dt, A, B, C) given dy = dL/dy.
//
// Replaces no TPU kernel: the Pallas kernel `ssd_scan`
// (src/repro/kernels/ssd_scan.py, `_ssd_kernel`) has no backward, and JAX
// trains by differentiating its jnp `ssm.ssd_chunked`.  This is the
// gradient of the port's forward kernel (csrc/ssd_scan.cu), wrapped as an
// autograd.Function by kernels/ssd_scan.py.  x [B, S, H, P] and B/C
// [B, S, G, N] float32 or bfloat16, dt [B, S, H] and A [H] float32, dy
// [B, S, H, P] float32 (ssd_scan returns float32); dx, dB and dC in x's
// type, ddt and dA float32.
//
// Per (batch, head) and chunk, with positions i, j of the chunk, a = A[h],
// seg_i = sum_{k<=i} a dt_k, L_ij = exp(seg_i - seg_j) for i >= j (else
// 0), D_ij = dy_i . x_j, e_j = exp(seg_last - seg_j), S_c the state
// entering the chunk and G the gradient of the state leaving it:
//   dx_j  = dt_j sum_{i>=j} (C_i . B_j) L_ij dy_i + dt_j e_j G^T B_j
//   dB_j  = dt_j sum_{i>=j} L_ij D_ij C_i + dt_j e_j G x_j   (a head's part)
//   dC_i  = sum_{j<=i} L_ij dt_j D_ij B_j + exp(seg_i) S_c dy_i
//   G'    = exp(seg_last) G + sum_i exp(seg_i) C_i dy_i^T  (the chunk before)
//   ddt_j = sum_{i>=j} (C_i . B_j) L_ij D_ij + e_j beta_j + a R_j
//   dA    = sum over batches, chunks and j of dt_j R_j
// with beta_j = B_j^T G x_j and R_j = sum_{k>=j} dseg_k.  Every exponent
// is <= 0.  kernels/ssd_scan.py's `ssd_scan_bwd_plain` writes the same
// passes in PyTorch, and says how dseg is made of per-position parts.
//
// Kernels in order on the caller's stream; no atomics, every sum in a
// fixed order, so two runs agree bit for bit.  Both routes share the
// scratch layout (`carve`) and passes 3-4.
//
// bfloat16 (the training path's type), on the tensor cores, mma.sync
// m16n8k16 with float32 accumulators; every float32 operand (dy, the
// decayed scores and weights, the states) enters a product as bf16 hi +
// lo terms, as the forward does (one bf16 rounding of the decayed scores
// alone reaches the forward's gate at Zamba2's shapes):
// 1'. `chunk_state_mma`: a block per (batch, head, chunk, 64 or 32 head
//    columns, direction), chunk-parallel: the chunk's term of the state it
//    passes on (B^T diag(e dt) x) or back (C^T diag(exp seg) dy); it also
//    writes seg and exp(seg_last).  `state_scan` then runs both chains
//    across the chunks, an element a thread.
// 2'. `local_mma`: a block per (batch, head, chunk) holds the chunk's x, dy,
//    B and C in shared memory and warp w owns positions 16 w .. 16 w + 15,
//    as columns j (dx, a head's dB, ddt's direct part, cpart, u) and as
//    rows i (a head's dC, rpart), so the causal triangle's tiles split
//    evenly (9 a warp at chunk 128).  The G and S_c terms start the
//    accumulators; S_c arrives by cp.async while the columns run.  A bf16
//    head wider than 128 columns, or whose tiles pass a block's shared
//    memory (N 128 with P 128), takes the SIMT pass 2 instead (the plan in
//    kernels/ssd_scan.py says which).
// float32 (the CUDA cores, FFMA; TF32 cannot meet the 1e-4 gate):
// 1. `state_kernel`: a block per (batch, head, 32 head columns,
//    direction) walks the chunks, the [N, 32] slice of the state in
//    registers: forward, writing each chunk's entry state S_c; in reverse,
//    each chunk's G.  The columns of a state are independent, so the P
//    slices need no exchange.
// 2. `local_kernel`: a block per (batch, head, chunk, 16-wide tile of the
//    chunk, role), chunk-parallel.  A "columns" block owns 16 positions j
//    and walks the row tiles i >= j: dx (stored), a head's dB, the direct
//    part of ddt and the column parts of dseg.  A "rows" block owns 16
//    positions i and walks the column tiles j <= i: a head's dC and the
//    row parts of dseg.  Each recomputes its 16 x 16 score tiles (C_i .
//    B_j and dy_i . x_j) from shared memory in register tiles, so no
//    Q x Q matrix is ever held: at mamba2-2.7b's chunk 128, N 128 the
//    chunk's tiles alone would pass a block's 227 KB.
// Then, both routes:
// 3. `reduce_kernel`: dB and dC summed over each group's heads in head
//    order (cast to B's type), and a block a chunk that takes the reverse
//    cumulative sum of dseg into ddt and a dA part.
// 4. `da_kernel`: dA over batches and chunks, in order.
//
// What bounds it on the H100: the products as written (the local pass
// computes each score tile twice, as a row and as a column tile, and hi
// + lo doubles or triples a float32 product; ~26 / 48 GFLOP at one Mamba2
// layer of Zamba2 / mamba2-2.7b, B = 4, S = 512) take 0.03 / 0.05 ms at
// the bf16 tensor-core peak, the bytes (the inputs once; the float32
// per-head dB and dC, 2 B S H N floats, are more) 0.02 / 0.03 ms.  In
// practice `local_mma` takes most of the time: each warp's fragment loads
// and mma.sync chain leave the tensor cores idle between products, with
// two 8-warp blocks an SM at N <= 64 (128 registers a thread) and one at
// N = 128 (234 registers; mamba2's tiles take 163 KB), whose first loads
// no other block's compute overlaps.  The float32 route is FFMA-bound
// (67 TFLOP/s).
// Further speed work is ROADMAP.md A.2's.
#include "mma.cuh"

namespace {

using repro_torch::from_f32;
using repro_torch::to_f32;
using namespace repro_torch::mma;
using repro_torch::allow_smem_once;

constexpr int kThreads = 256;
constexpr int kTile = 16;    // chunk positions a block of the local pass
constexpr int kSlice = 32;   // head columns a block of the state passes
constexpr int kMaxN = 128;   // the state's rows

// Shared memory of a local-pass block; kept equal to `_bwd_smem_bytes` in
// repro_torch/kernels/ssd_scan.py.
inline size_t local_smem(int Q, int N, int P) {
  const size_t t = kTile;
  return 4 * (2 * (size_t)Q + 2 * t * (N + 4) + 2 * t * (P + 4) +
              (size_t)N * (P + 4) + 8 * t * t + 3 * t * (t + 4) + t * P +
              2 * t * N + t);
}

inline size_t state_smem(int Q, int N) {
  return 4 * ((size_t)Q * N + (size_t)Q * kSlice + 3 * (size_t)Q);
}

// seg = cumsum(dt * a) over the chunk in position order by one thread, each
// term rounded before the add, as the forward kernel sums it (eight terms
// read ahead, so the adds do not wait on shared memory; Q % 16 == 0).
__device__ __forceinline__ void chunk_seg(const float* dts, float a,
                                                float* seg, int Q) {
  if (threadIdx.x == 0) {
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
}

// ------------------------------------------------- 1. states, both ways --
// states [2][B][H][nc][N][P]: S_c (z = 0), then G of chunk c (z = 1).
// Thread: column p0 + lane, state rows warp + 8 k.
template <typename T>
__global__ void __launch_bounds__(kThreads)
state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ A, const T* __restrict__ Bm,
             const T* __restrict__ Cm, const float* __restrict__ dy,
             float* __restrict__ states, int S, int H, int G, int N, int P,
             int Q) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* vs = reinterpret_cast<float*>(smem);  // [Q][N]: B, or C in reverse
  float* us = vs + Q * N;                      // [Q][32]: x, or dy
  float* dts = us + Q * kSlice;
  float* seg = dts + Q;
  float* ws = seg + Q;

  const int tid = threadIdx.x, lane = tid & 31, row = tid >> 5;
  const int bh = blockIdx.x, b = bh / H, h = bh % H, grp = h / (H / G);
  const int p0 = blockIdx.y * kSlice;
  const bool rev = blockIdx.z == 1;
  const int nc = S / Q;
  const float a = A[h];
  const long long plane = (long long)N * P;
  float* out = states + ((long long)blockIdx.z * gridDim.x + bh) * nc * plane +
               p0 + lane;

  float st[kMaxN / 8];
#pragma unroll
  for (int k = 0; k < kMaxN / 8; ++k) st[k] = 0.0f;
  for (int step = 0; step < nc; ++step) {
    const int c = rev ? nc - 1 - step : step;
#pragma unroll
    for (int k = 0; k < kMaxN / 8; ++k) {
      const int n = row + 8 * k;
      if (n < N) out[c * plane + (long long)n * P] = st[k];
    }
    if (step == nc - 1) break;
    __syncthreads();  // the last chunk's tiles are consumed
    const long long r0 = (long long)b * S + (long long)c * Q;
    const T* vsrc = rev ? Cm : Bm;
    for (int i = tid; i < Q * N; i += kThreads)
      vs[i] = to_f32(vsrc[((r0 + i / N) * G + grp) * N + i % N]);
    for (int i = tid; i < Q * kSlice; i += kThreads) {
      const long long off = ((r0 + i / kSlice) * H + h) * P + p0 + i % kSlice;
      us[i] = rev ? dy[off] : to_f32(x[off]);
    }
    for (int i = tid; i < Q; i += kThreads) dts[i] = dt[(r0 + i) * H + h];
    __syncthreads();
    chunk_seg(dts, a, seg, Q);
    const float last = seg[Q - 1];
    for (int i = tid; i < Q; i += kThreads)
      ws[i] = rev ? expf(seg[i]) : expf(last - seg[i]) * dts[i];
    __syncthreads();
    float acc[kMaxN / 8];
#pragma unroll
    for (int k = 0; k < kMaxN / 8; ++k) acc[k] = 0.0f;
    for (int j = 0; j < Q; ++j) {
      const float wu = ws[j] * us[j * kSlice + lane];
#pragma unroll
      for (int k = 0; k < kMaxN / 8; ++k) {
        const int n = row + 8 * k;
        if (n < N) acc[k] = fmaf(vs[j * N + n], wu, acc[k]);
      }
    }
    const float decay = expf(last);
#pragma unroll
    for (int k = 0; k < kMaxN / 8; ++k) st[k] = fmaf(decay, st[k], acc[k]);
  }
}

// --------------------------------------------- 2. chunk-local gradients --
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float s, float4 v, float4& acc) {
  acc.x = fmaf(s, v.x, acc.x);
  acc.y = fmaf(s, v.y, acc.y);
  acc.z = fmaf(s, v.z, acc.z);
  acc.w = fmaf(s, v.w, acc.w);
}

// per_head [2][B][S][H][N]: a head's dB, then dC.  parts [3][B][S][H]:
// rpart, cpart, u.  chunk_f [2][B][H][nc]: exp(seg_last) <G, S_c>, then
// the dA part (reduce_kernel's).  Tiles of 16 positions: "own" the
// block's 16 positions, "str" the 16 of the tile it walks.  Rows are
// padded by 4 floats, so every row starts on a 16-byte boundary and the 8
// rows a quarter-warp reads with one 16-byte load fall in 8 distinct bank
// groups (N and P are multiples of 8: (N + 4) / 4 is odd).
//
// Every product reads 16-byte vectors from shared memory: a score tile is
// four K-slices of 2 x 2 register tiles (64 threads a slice, each float4
// of C and B, or dy and x, feeding 16 multiply-adds), summed in slice
// order; an accumulation into [16, W] takes a float4 of W a thread and
// the 16 scores of its row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
local_kernel(const T* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ A, const T* __restrict__ Bm,
             const T* __restrict__ Cm, const float* __restrict__ dy,
             const float* __restrict__ states, T* __restrict__ dx,
             float* __restrict__ ddt, float* __restrict__ per_head,
             float* __restrict__ parts, float* __restrict__ chunk_f,
             int batch, int S, int H, int G, int N, int P, int Q) {
  const int NA = N + 4, PA = P + 4, TS = kTile + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* seg = reinterpret_cast<float*>(smem);  // [Q]
  float* dts = seg + Q;                         // [Q]
  float* own_a = dts + Q;             // [16][NA]: B_j (columns), C_i (rows)
  float* own_u = own_a + kTile * NA;  // [16][PA]: x_j, dy_i
  float* str_a = own_u + kTile * PA;  // [16][NA]: C_i, B_j
  float* str_u = str_a + kTile * NA;  // [16][PA]: dy_i, x_j
  float* big = str_u + kTile * PA;    // [N][PA]: G (columns), S_c (rows)
  float* part = big + N * PA;         // [2][4][16][16]: K-slice partials
  float* t_m = part + 2 * 4 * kTile * kTile;  // [16][TS]: (C_i.B_j) L_ij
  float* t_w = t_m + kTile * TS;      // [16][TS]: L_ij D_ij (x dt_j: rows)
  float* t_md = t_w + kTile * TS;     // [16][TS]: (C_i . B_j) L_ij D_ij
  float* acc_p = t_md + kTile * TS;   // [16][P]: dx_j / dt_j
  float* acc_n = acc_p + kTile * P;   // [16][N]: dB_j / dt_j, or dC_i
  float* buf = acc_n + kTile * N;     // [16][N]
  float* sums = buf + kTile * N;      // [16]

  const int tid = threadIdx.x;
  const int nc = S / Q;
  const int c = blockIdx.x % nc, bh = blockIdx.x / nc;
  const int b = bh / H, h = bh % H, grp = h / (H / G);
  const bool cols = blockIdx.z == 0;
  const int o0 = kTile * blockIdx.y;  // the block's first position
  const long long r0 = (long long)b * S + (long long)c * Q;
  const long long plane = (long long)N * P;
  const long long bsh = (long long)batch * S * H;
  const float* st_c = states + (long long)bh * nc * plane + c * plane;
  const float* g_c = st_c + (long long)batch * H * nc * plane;
  const int N4 = N / 4, P4 = P / 4;

  auto load_a = [&](float* dst, const T* src, int first) {
    for (int i = tid; i < kTile * N; i += kThreads)
      dst[(i / N) * NA + i % N] =
          to_f32(src[((r0 + first + i / N) * G + grp) * N + i % N]);
  };
  auto load_x = [&](float* dst, int first) {
    for (int i = tid; i < kTile * P; i += kThreads)
      dst[(i / P) * PA + i % P] =
          to_f32(x[((r0 + first + i / P) * H + h) * P + i % P]);
  };
  auto load_dy = [&](float* dst, int first) {
    for (int i = tid; i < kTile * P; i += kThreads)
      dst[(i / P) * PA + i % P] = dy[((r0 + first + i / P) * H + h) * P +
                                     i % P];
  };

  for (int i = tid; i < Q; i += kThreads) dts[i] = dt[(r0 + i) * H + h];
  if (cols) {
    load_a(own_a, Bm, o0);
    load_x(own_u, o0);
  } else {
    load_a(own_a, Cm, o0);
    load_dy(own_u, o0);
  }
  const float* big_src = cols ? g_c : st_c;
  for (int i = tid; i < N * P; i += kThreads)
    big[(i / P) * PA + i % P] = big_src[i];
  for (int i = tid; i < kTile * P; i += kThreads) acc_p[i] = 0.0f;
  for (int i = tid; i < kTile * N; i += kThreads) acc_n[i] = 0.0f;
  if (tid < kTile) sums[tid] = 0.0f;
  __syncthreads();
  chunk_seg(dts, A[h], seg, Q);
  const float last = seg[Q - 1];

  // the score slices: K-slice ks, rows mi and mi + 8, columns mj, mj + 8
  const int ks = tid >> 6, mi = (tid >> 3) & 7, mj = tid & 7;
  const float* c_rows = (cols ? str_a : own_a) + mi * NA;
  const float* b_rows = (cols ? own_a : str_a) + mj * NA;
  const float* dy_rows = (cols ? str_u : own_u) + mi * PA;
  const float* x_rows = (cols ? own_u : str_u) + mj * PA;
  // the summed score this thread finishes: row ii, column jj
  const int ii = tid >> 4, jj = tid & 15;
  const int n_tiles = Q / kTile;
  const int k_first = cols ? blockIdx.y : 0;
  const int k_end = cols ? n_tiles : blockIdx.y + 1;
  for (int k = k_first; k < k_end; ++k) {
    const int s0 = kTile * k;
    __syncthreads();  // the last tiles are consumed
    if (cols) {
      load_a(str_a, Cm, s0);
      load_dy(str_u, s0);
    } else {
      load_a(str_a, Bm, s0);
      load_x(str_u, s0);
    }
    __syncthreads();
    float cb[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
    float dd[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
    for (int q = ks; q < N4; q += 4) {
      const float4 c0 = lds4(c_rows + 4 * q), c1 = lds4(c_rows + 8 * NA + 4 * q);
      const float4 b0 = lds4(b_rows + 4 * q), b1 = lds4(b_rows + 8 * NA + 4 * q);
      cb[0][0] = dot4(c0, b0, cb[0][0]);
      cb[0][1] = dot4(c0, b1, cb[0][1]);
      cb[1][0] = dot4(c1, b0, cb[1][0]);
      cb[1][1] = dot4(c1, b1, cb[1][1]);
    }
    for (int q = ks; q < P4; q += 4) {
      const float4 y0 = lds4(dy_rows + 4 * q), y1 = lds4(dy_rows + 8 * PA + 4 * q);
      const float4 x0 = lds4(x_rows + 4 * q), x1 = lds4(x_rows + 8 * PA + 4 * q);
      dd[0][0] = dot4(y0, x0, dd[0][0]);
      dd[0][1] = dot4(y0, x1, dd[0][1]);
      dd[1][0] = dot4(y1, x0, dd[1][0]);
      dd[1][1] = dot4(y1, x1, dd[1][1]);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int e = (mi + 8 * u) * kTile + mj + 8 * v;
        part[ks * kTile * kTile + e] = cb[u][v];
        part[(4 + ks) * kTile * kTile + e] = dd[u][v];
      }
    __syncthreads();
    {
      const int e = ii * kTile + jj, sl = kTile * kTile;
      const int i = (cols ? s0 : o0) + ii, j = (cols ? o0 : s0) + jj;
      float m = 0.0f, w = 0.0f, md = 0.0f;
      if (i >= j) {
        const float sc = ((part[e] + part[sl + e]) + part[2 * sl + e]) +
                         part[3 * sl + e];
        const float d = ((part[4 * sl + e] + part[5 * sl + e]) +
                         part[6 * sl + e]) + part[7 * sl + e];
        const float l = expf(seg[i] - seg[j]);
        m = sc * l;
        w = cols ? l * d : l * d * dts[j];
        md = m * d;
      }
      t_m[ii * TS + jj] = m;
      t_w[ii * TS + jj] = w;
      t_md[ii * TS + jj] = md;
    }
    __syncthreads();
    if (cols) {
      // dx_j += sum_i M_ij dy_i; dB_j += sum_i W_ij C_i; column sums of MD
      for (int u = tid; u < kTile * P4; u += kThreads) {
        const int jr = u / P4, p = 4 * (u % P4);
        float4 acc = lds4(acc_p + jr * P + p);
#pragma unroll
        for (int r = 0; r < kTile; ++r)
          axpy4(t_m[r * TS + jr], lds4(str_u + r * PA + p), acc);
        *reinterpret_cast<float4*>(acc_p + jr * P + p) = acc;
      }
      for (int u = tid; u < kTile * N4; u += kThreads) {
        const int jr = u / N4, n = 4 * (u % N4);
        float4 acc = lds4(acc_n + jr * N + n);
#pragma unroll
        for (int r = 0; r < kTile; ++r)
          axpy4(t_w[r * TS + jr], lds4(str_a + r * NA + n), acc);
        *reinterpret_cast<float4*>(acc_n + jr * N + n) = acc;
      }
      if (tid < kTile) {
        float s = sums[tid];
#pragma unroll
        for (int r = 0; r < kTile; ++r) s += t_md[r * TS + tid];
        sums[tid] = s;
      }
    } else {
      // dC_i += sum_j L_ij dt_j D_ij B_j; row sums of MD dt_j
      for (int u = tid; u < kTile * N4; u += kThreads) {
        const int ir = u / N4, n = 4 * (u % N4);
        float4 acc = lds4(acc_n + ir * N + n);
#pragma unroll
        for (int r = 0; r < kTile; ++r)
          axpy4(t_w[ir * TS + r], lds4(str_a + r * NA + n), acc);
        *reinterpret_cast<float4*>(acc_n + ir * N + n) = acc;
      }
      if (tid < kTile) {
        float s = sums[tid];
#pragma unroll
        for (int r = 0; r < kTile; ++r)
          s = fmaf(t_md[tid * TS + r], dts[s0 + r], s);
        sums[tid] = s;
      }
    }
  }
  __syncthreads();

  if (cols) {
    // dx_j = dt_j (acc + e_j G^T B_j); dB_j = dt_j (acc + e_j G x_j)
    for (int u = tid; u < kTile * P4; u += kThreads) {
      const int jr = u / P4, p = 4 * (u % P4), j = o0 + jr;
      float4 gb = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int n = 0; n < N; ++n)
        axpy4(own_a[jr * NA + n], lds4(big + n * PA + p), gb);
      const float ej = expf(last - seg[j]), dtj = dts[j];
      const float4 acc = lds4(acc_p + jr * P + p);
      T* out = dx + ((r0 + j) * H + h) * P + p;
      out[0] = from_f32<T>(dtj * fmaf(ej, gb.x, acc.x));
      out[1] = from_f32<T>(dtj * fmaf(ej, gb.y, acc.y));
      out[2] = from_f32<T>(dtj * fmaf(ej, gb.z, acc.z));
      out[3] = from_f32<T>(dtj * fmaf(ej, gb.w, acc.w));
    }
    for (int u = tid; u < kTile * N; u += kThreads) {
      const int jr = u / N, n = u % N, j = o0 + jr;
      float gx = 0.0f;
      for (int q = 0; q < P4; ++q)
        gx = dot4(lds4(own_u + jr * PA + 4 * q), lds4(big + n * PA + 4 * q),
                  gx);
      const float ej = expf(last - seg[j]);
      per_head[((r0 + j) * H + h) * N + n] = dts[j] * fmaf(ej, gx, acc_n[u]);
      buf[u] = own_a[jr * NA + n] * gx;
    }
    __syncthreads();
    if (tid < kTile) {
      const int j = o0 + tid;
      float beta = 0.0f;
      for (int n = 0; n < N; ++n) beta += buf[tid * N + n];
      const float ej = expf(last - seg[j]), md = sums[tid];
      const long long off = (r0 + j) * H + h;
      const float u = ej * dts[j] * beta;
      ddt[off] = fmaf(ej, beta, md);
      parts[bsh + off] = -(dts[j] * md) - u;
      parts[2 * bsh + off] = u;
    }
  } else {
    // dC_i = acc + exp(seg_i) S_c dy_i; rpart_i = row sums of T +
    // exp(seg_i) C_i . (S_c dy_i)
    for (int u = tid; u < kTile * N; u += kThreads) {
      const int ir = u / N, n = u % N, i = o0 + ir;
      float z = 0.0f;
      for (int q = 0; q < P4; ++q)
        z = dot4(lds4(big + n * PA + 4 * q), lds4(own_u + ir * PA + 4 * q), z);
      per_head[bsh * N + ((r0 + i) * H + h) * N + n] =
          fmaf(expf(seg[i]), z, acc_n[u]);
      buf[u] = own_a[ir * NA + n] * z;
    }
    __syncthreads();
    if (tid < kTile) {
      const int i = o0 + tid;
      float cz = 0.0f;
      for (int n = 0; n < N; ++n) cz += buf[tid * N + n];
      parts[(r0 + i) * H + h] = fmaf(expf(seg[i]), cz, sums[tid]);
    }
    if (blockIdx.y == 0) {  // the chunk's exp(seg_last) <G, S_c>
      float acc = 0.0f;
      for (int e = tid; e < N * P; e += kThreads)
        acc = fmaf(g_c[e], big[(e / P) * PA + e % P], acc);
      float unused = 0.0f;
      repro_torch::block_sum2(acc, unused, t_m);
      if (tid == 0) chunk_f[(long long)bh * nc + c] = expf(last) * acc;
    }
  }
}

// ----------------------------------------------------- 3. ordered sums --
// Blocks [0, n_sum): one output element of dB and of dC a thread, summed
// over the group's heads in order.  Blocks past n_sum: one a (batch, head,
// chunk), the reverse cumulative sum of dseg (thread 0, in position
// order) into ddt and the chunk's dA part.
template <typename T>
__global__ void __launch_bounds__(kThreads)
reduce_kernel(const float* __restrict__ dt, const float* __restrict__ A,
              const float* __restrict__ per_head,
              const float* __restrict__ parts, float* __restrict__ chunk_f,
              float* __restrict__ ddt, T* __restrict__ dB, T* __restrict__ dC,
              int batch, int S, int H, int G, int N, int Q, int n_sum) {
  const long long bsh = (long long)batch * S * H;
  if (static_cast<int>(blockIdx.x) < n_sum) {
    const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (e >= (long long)batch * S * G * N) return;
    const int n = e % N, g = (e / N) % G, hg = H / G;
    const long long r = e / N / G;
    const float* pb = per_head + (r * H + (long long)g * hg) * N + n;
    const float* pc = pb + bsh * N;
    float sb = 0.0f, sc = 0.0f;
    for (int k = 0; k < hg; ++k) {
      sb += pb[(long long)k * N];
      sc += pc[(long long)k * N];
    }
    dB[e] = from_f32<T>(sb);
    dC[e] = from_f32<T>(sc);
    return;
  }
  __shared__ float ds[128], us[128], dts[128];
  const int nc = S / Q;
  const int bhc = static_cast<int>(blockIdx.x) - n_sum;
  const int c = bhc % nc, bh = bhc / nc;
  const int b = bh / H, h = bh % H;
  const long long r0 = (long long)b * S + (long long)c * Q;
  for (int k = threadIdx.x; k < Q; k += kThreads) {
    const long long off = (r0 + k) * H + h;
    ds[k] = parts[off] + parts[bsh + off];
    us[k] = parts[2 * bsh + off];
    dts[k] = dt[off];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float run = chunk_f[bhc];  // dseg_last's extra: exp(seg_last) <G, S_c>
    for (int k = 0; k < Q; ++k) run += us[k];   // + sum_j u_j
    float da = 0.0f;
    for (int k = Q - 1; k >= 0; --k) {
      run += ds[k];
      ds[k] = run;  // R_k
      da = fmaf(dts[k], run, da);
    }
    chunk_f[(long long)batch * H * nc + bhc] = da;
  }
  __syncthreads();
  const float a = A[h];
  for (int k = threadIdx.x; k < Q; k += kThreads) {
    const long long off = (r0 + k) * H + h;
    ddt[off] = fmaf(a, ds[k], ddt[off]);
  }
}

// --------------------------------------------------------- 4. dA sums --
__global__ void da_kernel(const float* __restrict__ chunk_f,
                          float* __restrict__ dA, int batch, int H, int nc) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  const float* part = chunk_f + (long long)batch * H * nc;
  float s = 0.0f;
  for (int b = 0; b < batch; ++b)
    for (int c = 0; c < nc; ++c) s += part[((long long)b * H + h) * nc + c];
  dA[h] = s;
}

// ------------------------------------ bfloat16: the tensor-core passes --
// (1') `chunk_state_mma` and `state_scan` take the state kernel's place,
// (2') `local_mma` the local kernel's where its tiles fit (`local_mma_smem`).

__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }

// Shared memory of a `chunk_state_mma` block (PS head columns).
inline size_t chunk_state_smem(int Q, int N, int PS) {
  return 2 * (2 * (size_t)Q * (PS + 8) + (size_t)Q * (round16(N) + 8)) +
         4 * 3 * (size_t)Q;
}

// Shared memory of a `local_mma` block; kept equal to `_bwd_smem_bytes`
// in repro_torch/kernels/ssd_scan.py.
inline size_t local_mma_smem(int Q, int N, int P) {
  const size_t lp = P + 8, ln = round16(N) + 8;
  return 2 * (3 * Q * lp + 2 * Q * ln) + 4 * (round16(N) * lp + 2 * Q + 64);
}

// Q rows of a float32 [rows][W] slice (row j at src + j * rstride) as bf16
// hi and lo terms in two padded tiles.  Four 16-byte loads a thread are in
// flight before the first store (a load waits on no store before it).
__device__ __forceinline__ void load_split(__nv_bfloat16* hi,
                                           __nv_bfloat16* lo, int ld,
                                           const float* __restrict__ src,
                                           long long rstride, int Q, int W) {
  const int w4 = W / 4, n4 = Q * w4, step = blockDim.x;
  for (int i0 = threadIdx.x; i0 < n4; i0 += 4 * step) {
    float4 v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = i0 + k * step;
      if (i < n4)
        v[k] = __ldg(reinterpret_cast<const float4*>(
            src + (i / w4) * rstride + 4 * (i % w4)));
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = i0 + k * step;
      if (i >= n4) break;
      const int j = i / w4, p = 4 * (i % w4);
      uint2 h, l;
      split_bf16(v[k].x, v[k].y, h.x, l.x);
      split_bf16(v[k].z, v[k].w, h.y, l.y);
      *reinterpret_cast<uint2*>(hi + j * ld + p) = h;
      *reinterpret_cast<uint2*>(lo + j * ld + p) = l;
    }
  }
}

// (1') A block per (batch, head, chunk), PS head columns and direction:
// z = 0 the chunk's contribution to the state it passes on, sum_j B_j
// e_j dt_j x_j^T, into S's slot c + 1; z = 1 its term of the state
// gradient it passes back, sum_i exp(seg_i) C_i dy_i^T, into G's slot
// c - 1.  [N, PS] = V^T diag(w) U on the tensor cores: A = (V w)^T through
// ldmatrix.trans, its float32 products as bf16 hi + lo (dy too, three
// MMAs a product).  The block with no slot to fill zeros the chain's
// first slot instead; the (z = 0, first slice) block also writes the
// chunk's seg and exp(seg_last).
template <int PS>
__global__ void __launch_bounds__(128)
chunk_state_mma(const __nv_bfloat16* __restrict__ x,
                const float* __restrict__ dt, const float* __restrict__ A,
                const __nv_bfloat16* __restrict__ Bm,
                const __nv_bfloat16* __restrict__ Cm,
                const float* __restrict__ dy, float* __restrict__ states,
                float* __restrict__ segs, float* __restrict__ decays,
                int batch, int S, int H, int G, int N, int P, int Q) {
  constexpr int LU = PS + 8;
  const int Np = round16(N), LN = Np + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* uh = reinterpret_cast<__nv_bfloat16*>(smem);  // [Q][LU]
  __nv_bfloat16* ul = uh + Q * LU;                              // [Q][LU]
  __nv_bfloat16* vs = ul + Q * LU;                              // [Q][LN]
  float* dts = reinterpret_cast<float*>(vs + Q * LN);
  float* seg = dts + Q;
  float* ws = seg + Q;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nc = S / Q, c = blockIdx.x % nc, bh = blockIdx.x / nc;
  const int b = bh / H, h = bh % H, grp = h / (H / G);
  const int p0 = blockIdx.y * PS;
  const bool back = blockIdx.z == 1;
  const long long r0 = (long long)b * S + (long long)c * Q;
  const long long plane = (long long)N * P;
  float* chain = states + ((long long)blockIdx.z * batch * H + bh) * nc * plane;
  const int dst = back ? c - 1 : c + 1;  // the slot this chunk's term fills
  const bool first = !back && blockIdx.y == 0;

  if (dst < 0 || dst >= nc) {  // zero the chain's first slot
    float* out = chain + (long long)(back ? nc - 1 : 0) * plane + p0;
    for (int i = tid; i < N * PS; i += blockDim.x)
      out[(long long)(i / PS) * P + i % PS] = 0.0f;
    if (!first) return;
  }
  const __nv_bfloat16* vsrc = back ? Cm : Bm;
  for (int i = tid; i < Q * (N / 8); i += blockDim.x) {
    const int j = i / (N / 8), k = i % (N / 8);
    cp_async16(vs + j * LN + 8 * k, vsrc + ((r0 + j) * G + grp) * N + 8 * k);
  }
  if (!back)
    for (int i = tid; i < Q * (PS / 8); i += blockDim.x) {
      const int j = i / (PS / 8), k = i % (PS / 8);
      cp_async16(uh + j * LU + 8 * k, x + ((r0 + j) * H + h) * P + p0 + 8 * k);
    }
  cp_async_commit();
  for (int i = tid; i < Q * (Np - N); i += blockDim.x)
    vs[(i / (Np - N)) * LN + N + i % (Np - N)] = __float2bfloat16_rn(0.0f);
  if (back)
    load_split(uh, ul, LU, dy + (r0 * H + h) * P + p0, (long long)H * P, Q, PS);
  for (int i = tid; i < Q; i += blockDim.x) dts[i] = dt[(r0 + i) * H + h];
  __syncthreads();
  chunk_seg(dts, A[h], seg, Q);
  const float last = seg[Q - 1];
  for (int i = tid; i < Q; i += blockDim.x) {
    ws[i] = back ? expf(seg[i]) : expf(last - seg[i]) * dts[i];
    if (first) segs[(long long)bh * S + c * Q + i] = seg[i];
  }
  if (first && tid == 0) decays[blockIdx.x] = expf(last);
  cp_async_wait<0>();
  __syncthreads();
  if (dst < 0 || dst >= nc) return;

  float* out = chain + (long long)dst * plane + p0;
  for (int mt = warp; 16 * mt < Np; mt += 4) {
    float acc[PS / 8][4];
#pragma unroll
    for (int n = 0; n < PS / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
    for (int kk = 0; kk < Q / 16; ++kk) {
      unsigned vt[4], ah[4], al[4];
      ldsm_x4_t(vt, frag_cols(vs, LN, 16 * kk, 16 * mt, lane));
      const int j = 16 * kk + 2 * t;
#pragma unroll
      for (int r = 0; r < 4; ++r) {  // k columns j, j+1 (r < 2) or j+8, j+9
        const float2 f = unpack_bf16(vt[r]);
        const int k = j + (r >= 2 ? 8 : 0);
        split_bf16(f.x * ws[k], f.y * ws[k + 1], ah[r], al[r]);
      }
#pragma unroll
      for (int np = 0; np < PS / 16; ++np) {
        unsigned bh_[4];
        ldsm_x4_t(bh_, frag_rows(uh, LU, 16 * kk, 16 * np, lane));
        mma_bf16(acc[2 * np], ah, bh_[0], bh_[1]);
        mma_bf16(acc[2 * np + 1], ah, bh_[2], bh_[3]);
        mma_bf16(acc[2 * np], al, bh_[0], bh_[1]);
        mma_bf16(acc[2 * np + 1], al, bh_[2], bh_[3]);
        if (back) {
          unsigned bl[4];
          ldsm_x4_t(bl, frag_rows(ul, LU, 16 * kk, 16 * np, lane));
          mma_bf16(acc[2 * np], ah, bl[0], bl[1]);
          mma_bf16(acc[2 * np + 1], ah, bl[2], bl[3]);
        }
      }
    }
    const int n_lo = 16 * mt + g, n_hi = n_lo + 8;
#pragma unroll
    for (int n = 0; n < PS / 8; ++n) {
      const int p = 8 * n + 2 * t;
      if (n_lo < N)
        *reinterpret_cast<float2*>(out + (long long)n_lo * P + p) =
            make_float2(acc[n][0], acc[n][1]);
      if (n_hi < N)
        *reinterpret_cast<float2*>(out + (long long)n_hi * P + p) =
            make_float2(acc[n][2], acc[n][3]);
    }
  }
}

// The chains across chunks, an element a thread: S_{c+1} = exp(seg_last)
// S_c + (its slot's term), forward; G_{c-1} = exp(seg_last) G_c + (its
// slot's term), in reverse.  The same form as `state_kernel`'s.
__global__ void __launch_bounds__(kThreads)
state_scan(float* __restrict__ states, const float* __restrict__ decays,
           int batch, int H, int nc, int NP) {
  const int bh = blockIdx.x;
  const int e = blockIdx.y * kThreads + threadIdx.x;
  if (e >= NP) return;
  const float* dec = decays + (long long)bh * nc;
  float* fwd = states + (long long)bh * nc * NP + e;
  float* rev = fwd + (long long)batch * H * nc * NP;
  float run = 0.0f;
  for (int c = 1; c < nc; ++c) {
    run = fmaf(dec[c - 1], run, fwd[(long long)c * NP]);
    fwd[(long long)c * NP] = run;
  }
  run = 0.0f;
  for (int c = nc - 2; c >= 0; --c) {
    run = fmaf(dec[c + 1], run, rev[(long long)c * NP]);
    rev[(long long)c * NP] = run;
  }
}

// The B fragment pair (b0, b1) as hi and lo bf16 terms, from a float32
// row-major tile whose k runs along the rows: rows n0 + g, columns k0 +
// 2t .. (b0) and k0 + 2t + 8 .. (b1).
__device__ __forceinline__ void b_split_rows(const float* st, int ld, int n0,
                                             int k0, int lane,
                                             unsigned (&hi)[2],
                                             unsigned (&lo)[2]) {
  const float* p = st + (n0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  const float2 v0 = *reinterpret_cast<const float2*>(p);
  const float2 v1 = *reinterpret_cast<const float2*>(p + 8);
  split_bf16(v0.x, v0.y, hi[0], lo[0]);
  split_bf16(v1.x, v1.y, hi[1], lo[1]);
}

// The same, k running down the rows: rows k0 + 2t, k0 + 2t + 1 (b0) and
// + 8 (b1), column n0 + g.
__device__ __forceinline__ void b_split_cols(const float* st, int ld, int k0,
                                             int n0, int lane,
                                             unsigned (&hi)[2],
                                             unsigned (&lo)[2]) {
  const float* p = st + (k0 + 2 * (lane & 3)) * ld + n0 + (lane >> 2);
  split_bf16(p[0], p[ld], hi[0], lo[0]);
  split_bf16(p[8 * ld], p[9 * ld], hi[1], lo[1]);
}

// Sum over the 4 threads of a quad, in a fixed order.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// (2') The chunk-local gradients on the tensor cores: a block per (batch,
// head, chunk) holds the chunk's x, dy (bf16 hi + lo), B and C in shared
// memory, and warp w owns positions 16 w .. 16 w + 15 of it, as columns
// j (dx, a head's dB, ddt's direct part, cpart, u) and as rows i (a
// head's dC, rpart): the causal triangle's tiles split 9 a warp at chunk
// 128.  Products (m16n8k16, f32 accumulators):
//   G terms: e_j B_j G and e_j G x_j (G float32 in shared memory, split in
//     the B fragments), which start the dx and dB accumulators;
//   columns, i >= j: (C.B)^T and D^T = x_j dy_i^T, then dx += M^T dy and
//     dB += (L D)^T C, M = (C.B) L;
//   S terms: exp(seg_i) S_c dy_i, which starts dC (S_c arrives by cp.async
//     while the columns run);
//   rows, j <= i: C.B and D, then dC += (L D dt_j) B.
// Each score and weight tile is float32 and enters its product as bf16 hi
// + lo (dy: three MMAs a product, hi hi + hi lo + lo hi).  Sums over a
// tile's rows reduce over a quad's shuffles in a fixed order.
template <int PT, int NTM>
__global__ void __launch_bounds__(kThreads, NTM <= 8 && PT <= 8 ? 2 : 1)
local_mma(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
          const __nv_bfloat16* __restrict__ Bm,
          const __nv_bfloat16* __restrict__ Cm, const float* __restrict__ dy,
          const float* __restrict__ states, const float* __restrict__ segs,
          __nv_bfloat16* __restrict__ dx, float* __restrict__ ddt,
          float* __restrict__ per_head, float* __restrict__ parts,
          float* __restrict__ chunk_f, int batch, int S, int H, int G, int N,
          int Q) {
  constexpr int P = 8 * PT, LP = P + 8;
  const int Np = round16(N), LN = Np + 8, NT = Np / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // [Q][LP]
  __nv_bfloat16* dyh = xs + Q * LP;                             // [Q][LP]
  __nv_bfloat16* dyl = dyh + Q * LP;                            // [Q][LP]
  __nv_bfloat16* bs = dyl + Q * LP;                             // [Q][LN]
  __nv_bfloat16* cs = bs + Q * LN;                              // [Q][LN]
  float* st = reinterpret_cast<float*>(cs + Q * LN);  // [Np][LP]: G, S_c
  float* seg = st + Np * LP;
  float* dts = seg + Q;
  float* red = dts + Q;                                         // [64]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int W = Q / 16;
  const int nc = S / Q, c = blockIdx.x % nc, bh = blockIdx.x / nc;
  const int b = bh / H, h = bh % H, grp = h / (H / G);
  const long long r0 = (long long)b * S + (long long)c * Q;
  const long long plane = (long long)N * P;
  const long long bsh = (long long)batch * S * H;
  const float* s_c = states + ((long long)bh * nc + c) * plane;
  const float* g_c = s_c + (long long)batch * H * nc * plane;

  auto load_state = [&](const float* src) {
    for (int i = tid; i < N * PT * 2; i += blockDim.x) {
      const int n = i / (2 * PT), k = i % (2 * PT);
      cp_async16(st + n * LP + 4 * k, src + (long long)n * P + 4 * k);
    }
  };
  for (int i = tid; i < Q * PT; i += blockDim.x) {
    const int j = i / PT, k = i % PT;
    cp_async16(xs + j * LP + 8 * k, x + ((r0 + j) * H + h) * P + 8 * k);
  }
  for (int i = tid; i < Q * (N / 8); i += blockDim.x) {
    const int j = i / (N / 8), k = i % (N / 8);
    const long long off = ((r0 + j) * G + grp) * N + 8 * k;
    cp_async16(bs + j * LN + 8 * k, Bm + off);
    cp_async16(cs + j * LN + 8 * k, Cm + off);
  }
  load_state(g_c);
  cp_async_commit();
  for (int i = tid; i < Q * (Np - N); i += blockDim.x) {
    const int j = i / (Np - N), n = N + i % (Np - N);
    bs[j * LN + n] = cs[j * LN + n] = __float2bfloat16_rn(0.0f);
  }
  for (int i = tid; i < (Np - N) * P; i += blockDim.x)
    st[(N + i / P) * LP + i % P] = 0.0f;
  load_split(dyh, dyl, LP, dy + (r0 * H + h) * P, (long long)H * P, Q, P);
  for (int i = tid; i < Q; i += blockDim.x) {
    dts[i] = dt[(r0 + i) * H + h];
    seg[i] = segs[(long long)bh * S + c * Q + i];
  }
  cp_async_wait<0>();
  __syncthreads();

  const float last = seg[Q - 1];
  const int o0 = 16 * warp;                 // this warp's 16 positions
  const int lo = o0 + g, hi = lo + 8;       // its two rows of a fragment
  const float e_lo = expf(last - seg[lo]), e_hi = expf(last - seg[hi]);

  // ---- G terms: dx and dB start at e_j B_j G and e_j G x_j ------------
  float adx[PT][4], adb[NTM][4];
#pragma unroll
  for (int n = 0; n < PT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adx[n][e] = 0.0f;
#pragma unroll
  for (int n = 0; n < NTM; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adb[n][e] = 0.0f;
  for (int kk = 0; kk < Np / 16; ++kk) {
    unsigned a[4];
    ldsm_x4(a, frag_rows(bs, LN, o0, 16 * kk, lane));
#pragma unroll
    for (int n = 0; n < PT; ++n) {
      unsigned bh_[2], bl[2];
      b_split_cols(st, LP, 16 * kk, 8 * n, lane, bh_, bl);
      mma_bf16(adx[n], a, bh_[0], bh_[1]);
      mma_bf16(adx[n], a, bl[0], bl[1]);
    }
  }
#pragma unroll
  for (int kk = 0; kk < PT / 2; ++kk) {
    unsigned a[4];
    ldsm_x4(a, frag_rows(xs, LP, o0, 16 * kk, lane));
#pragma unroll
    for (int n = 0; n < NTM; ++n) {
      if (n >= NT) break;
      unsigned bh_[2], bl[2];
      b_split_rows(st, LP, 8 * n, 16 * kk, lane, bh_, bl);
      mma_bf16(adb[n], a, bh_[0], bh_[1]);
      mma_bf16(adb[n], a, bl[0], bl[1]);
    }
  }
  // beta_j = B_j . (G x_j)
  float beta_lo = 0.0f, beta_hi = 0.0f;
#pragma unroll
  for (int n = 0; n < NTM; ++n) {
    if (n >= NT) break;
    const int col = 8 * n + 2 * t;
    const float2 b0 = unpack_bf16(
        *reinterpret_cast<const unsigned*>(bs + lo * LN + col));
    const float2 b1 = unpack_bf16(
        *reinterpret_cast<const unsigned*>(bs + hi * LN + col));
    beta_lo = fmaf(b0.x, adb[n][0], fmaf(b0.y, adb[n][1], beta_lo));
    beta_hi = fmaf(b1.x, adb[n][2], fmaf(b1.y, adb[n][3], beta_hi));
  }
  beta_lo = quad_sum(beta_lo);
  beta_hi = quad_sum(beta_hi);
#pragma unroll
  for (int n = 0; n < PT; ++n) {
    adx[n][0] *= e_lo;
    adx[n][1] *= e_lo;
    adx[n][2] *= e_hi;
    adx[n][3] *= e_hi;
  }
#pragma unroll
  for (int n = 0; n < NTM; ++n) {
    adb[n][0] *= e_lo;
    adb[n][1] *= e_lo;
    adb[n][2] *= e_hi;
    adb[n][3] *= e_hi;
  }

  // ---- the chunk's exp(seg_last) <G, S_c>, then S_c in flight ----------
  float gs = 0.0f;  // eight loads of S_c in flight a thread
  for (int e0 = tid; e0 < N * P; e0 += 8 * blockDim.x) {
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int e = e0 + k * blockDim.x;
      v[k] = e < N * P ? __ldg(s_c + e) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int e = e0 + k * blockDim.x;
      if (e < N * P) gs = fmaf(st[(e / P) * LP + e % P], v[k], gs);
    }
  }
  float unused = 0.0f;
  repro_torch::block_sum2(gs, unused, red);  // ends with a barrier
  if (tid == 0) chunk_f[(long long)bh * nc + c] = expf(last) * gs;
  load_state(s_c);
  cp_async_commit();

  // ---- columns j of this warp, rows i >= j ------------------------------
  float md_lo = 0.0f, md_hi = 0.0f;
  for (int it = warp; it < W; ++it) {
    const int i0 = 16 * it;
    float sc[2][4] = {}, dd[2][4] = {};
    for (int kk = 0; kk < Np / 16; ++kk) {
      unsigned a[4], bb[4];
      ldsm_x4(a, frag_rows(bs, LN, o0, 16 * kk, lane));
      ldsm_x4(bb, frag_cols(cs, LN, i0, 16 * kk, lane));
      mma_bf16(sc[0], a, bb[0], bb[1]);
      mma_bf16(sc[1], a, bb[2], bb[3]);
    }
#pragma unroll
    for (int kk = 0; kk < PT / 2; ++kk) {
      unsigned a[4], bh_[4], bl[4];
      ldsm_x4(a, frag_rows(xs, LP, o0, 16 * kk, lane));
      ldsm_x4(bh_, frag_cols(dyh, LP, i0, 16 * kk, lane));
      ldsm_x4(bl, frag_cols(dyl, LP, i0, 16 * kk, lane));
      mma_bf16(dd[0], a, bh_[0], bh_[1]);
      mma_bf16(dd[1], a, bh_[2], bh_[3]);
      mma_bf16(dd[0], a, bl[0], bl[1]);
      mma_bf16(dd[1], a, bl[2], bl[3]);
    }
    // M^T = (C.B)^T L and (L D)^T, 0 above the diagonal (i < j)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = e >= 2 ? hi : lo, i = i0 + 8 * n + 2 * t + (e & 1);
        float m = 0.0f, ld = 0.0f;
        if (i >= j) {
          const float l = expf(seg[i] - seg[j]);
          m = sc[n][e] * l;
          ld = l * dd[n][e];
          if (e >= 2)
            md_hi = fmaf(m, dd[n][e], md_hi);
          else
            md_lo = fmaf(m, dd[n][e], md_lo);
        }
        sc[n][e] = m;
        dd[n][e] = ld;
      }
    unsigned mh[4], ml[4], lh[4], ll[4];
    acc_to_a_split(mh, ml, sc[0], sc[1]);
    acc_to_a_split(lh, ll, dd[0], dd[1]);
#pragma unroll
    for (int np = 0; np < PT / 2; ++np) {  // dx += M^T dy
      unsigned bh_[4], bl[4];
      ldsm_x4_t(bh_, frag_rows(dyh, LP, i0, 16 * np, lane));
      ldsm_x4_t(bl, frag_rows(dyl, LP, i0, 16 * np, lane));
      mma_bf16(adx[2 * np], mh, bh_[0], bh_[1]);
      mma_bf16(adx[2 * np + 1], mh, bh_[2], bh_[3]);
      mma_bf16(adx[2 * np], mh, bl[0], bl[1]);
      mma_bf16(adx[2 * np + 1], mh, bl[2], bl[3]);
      mma_bf16(adx[2 * np], ml, bh_[0], bh_[1]);
      mma_bf16(adx[2 * np + 1], ml, bh_[2], bh_[3]);
    }
#pragma unroll
    for (int np = 0; np < NTM / 2; ++np) {  // dB += (L D)^T C
      if (2 * np >= NT) break;
      unsigned bc[4];
      ldsm_x4_t(bc, frag_rows(cs, LN, i0, 16 * np, lane));
      mma_bf16(adb[2 * np], lh, bc[0], bc[1]);
      mma_bf16(adb[2 * np + 1], lh, bc[2], bc[3]);
      mma_bf16(adb[2 * np], ll, bc[0], bc[1]);
      mma_bf16(adb[2 * np + 1], ll, bc[2], bc[3]);
    }
  }
  md_lo = quad_sum(md_lo);
  md_hi = quad_sum(md_hi);

  // dx_j = dt_j acc, a head's dB_j = dt_j acc; ddt's direct part, cpart, u
  const float dt_lo = dts[lo], dt_hi = dts[hi];
  {
    __nv_bfloat16* out_lo = dx + ((r0 + lo) * H + h) * P + 2 * t;
    __nv_bfloat16* out_hi = dx + ((r0 + hi) * H + h) * P + 2 * t;
#pragma unroll
    for (int n = 0; n < PT; ++n) {
      *reinterpret_cast<unsigned*>(out_lo + 8 * n) =
          pack_bf16(dt_lo * adx[n][0], dt_lo * adx[n][1]);
      *reinterpret_cast<unsigned*>(out_hi + 8 * n) =
          pack_bf16(dt_hi * adx[n][2], dt_hi * adx[n][3]);
    }
    float* db_lo = per_head + ((r0 + lo) * H + h) * N + 2 * t;
    float* db_hi = per_head + ((r0 + hi) * H + h) * N + 2 * t;
#pragma unroll
    for (int n = 0; n < NTM; ++n) {
      if (n >= NT || 8 * n >= N) break;
      *reinterpret_cast<float2*>(db_lo + 8 * n) =
          make_float2(dt_lo * adb[n][0], dt_lo * adb[n][1]);
      *reinterpret_cast<float2*>(db_hi + 8 * n) =
          make_float2(dt_hi * adb[n][2], dt_hi * adb[n][3]);
    }
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = r ? hi : lo;
        const float ej = r ? e_hi : e_lo, dtj = r ? dt_hi : dt_lo;
        const float beta = r ? beta_hi : beta_lo, md = r ? md_hi : md_lo;
        const long long off = (r0 + j) * H + h;
        const float u = ej * dtj * beta;
        ddt[off] = fmaf(ej, beta, md);
        parts[bsh + off] = -(dtj * md) - u;
        parts[2 * bsh + off] = u;
      }
    }
  }

  // ---- S terms: dC starts at exp(seg_i) S_c dy_i ------------------------
  cp_async_wait<0>();
  __syncthreads();  // S_c has landed
  float adc[NTM][4];
#pragma unroll
  for (int n = 0; n < NTM; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adc[n][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < PT / 2; ++kk) {
    unsigned ah[4], al[4];
    ldsm_x4(ah, frag_rows(dyh, LP, o0, 16 * kk, lane));
    ldsm_x4(al, frag_rows(dyl, LP, o0, 16 * kk, lane));
#pragma unroll
    for (int n = 0; n < NTM; ++n) {
      if (n >= NT) break;
      unsigned bh_[2], bl[2];
      b_split_rows(st, LP, 8 * n, 16 * kk, lane, bh_, bl);
      mma_bf16(adc[n], ah, bh_[0], bh_[1]);
      mma_bf16(adc[n], ah, bl[0], bl[1]);
      mma_bf16(adc[n], al, bh_[0], bh_[1]);
    }
  }
  // cz_i = C_i . (S_c dy_i)
  float cz_lo = 0.0f, cz_hi = 0.0f;
#pragma unroll
  for (int n = 0; n < NTM; ++n) {
    if (n >= NT) break;
    const int col = 8 * n + 2 * t;
    const float2 c0 = unpack_bf16(
        *reinterpret_cast<const unsigned*>(cs + lo * LN + col));
    const float2 c1 = unpack_bf16(
        *reinterpret_cast<const unsigned*>(cs + hi * LN + col));
    cz_lo = fmaf(c0.x, adc[n][0], fmaf(c0.y, adc[n][1], cz_lo));
    cz_hi = fmaf(c1.x, adc[n][2], fmaf(c1.y, adc[n][3], cz_hi));
  }
  cz_lo = quad_sum(cz_lo);
  cz_hi = quad_sum(cz_hi);
  const float es_lo = expf(seg[lo]), es_hi = expf(seg[hi]);
#pragma unroll
  for (int n = 0; n < NTM; ++n) {
    adc[n][0] *= es_lo;
    adc[n][1] *= es_lo;
    adc[n][2] *= es_hi;
    adc[n][3] *= es_hi;
  }

  // ---- rows i of this warp, columns j <= i ------------------------------
  float rs_lo = 0.0f, rs_hi = 0.0f;
  for (int jt = 0; jt <= warp; ++jt) {
    const int j0 = 16 * jt;
    float sc[2][4] = {}, dd[2][4] = {};
    for (int kk = 0; kk < Np / 16; ++kk) {
      unsigned a[4], bb[4];
      ldsm_x4(a, frag_rows(cs, LN, o0, 16 * kk, lane));
      ldsm_x4(bb, frag_cols(bs, LN, j0, 16 * kk, lane));
      mma_bf16(sc[0], a, bb[0], bb[1]);
      mma_bf16(sc[1], a, bb[2], bb[3]);
    }
#pragma unroll
    for (int kk = 0; kk < PT / 2; ++kk) {
      unsigned ah[4], al[4], bx[4];
      ldsm_x4(ah, frag_rows(dyh, LP, o0, 16 * kk, lane));
      ldsm_x4(al, frag_rows(dyl, LP, o0, 16 * kk, lane));
      ldsm_x4(bx, frag_cols(xs, LP, j0, 16 * kk, lane));
      mma_bf16(dd[0], ah, bx[0], bx[1]);
      mma_bf16(dd[1], ah, bx[2], bx[3]);
      mma_bf16(dd[0], al, bx[0], bx[1]);
      mma_bf16(dd[1], al, bx[2], bx[3]);
    }
    // L D dt_j, 0 past the diagonal (j > i); T = (C.B) L D dt_j
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >= 2 ? hi : lo, j = j0 + 8 * n + 2 * t + (e & 1);
        float w = 0.0f;
        if (j <= i) {
          w = expf(seg[i] - seg[j]) * dd[n][e] * dts[j];
          if (e >= 2)
            rs_hi = fmaf(sc[n][e], w, rs_hi);
          else
            rs_lo = fmaf(sc[n][e], w, rs_lo);
        }
        dd[n][e] = w;
      }
    unsigned wh[4], wl[4];
    acc_to_a_split(wh, wl, dd[0], dd[1]);
#pragma unroll
    for (int np = 0; np < NTM / 2; ++np) {  // dC += (L D dt_j) B
      if (2 * np >= NT) break;
      unsigned bb[4];
      ldsm_x4_t(bb, frag_rows(bs, LN, j0, 16 * np, lane));
      mma_bf16(adc[2 * np], wh, bb[0], bb[1]);
      mma_bf16(adc[2 * np + 1], wh, bb[2], bb[3]);
      mma_bf16(adc[2 * np], wl, bb[0], bb[1]);
      mma_bf16(adc[2 * np + 1], wl, bb[2], bb[3]);
    }
  }
  rs_lo = quad_sum(rs_lo);
  rs_hi = quad_sum(rs_hi);

  // a head's dC_i; rpart_i = row sums of T + exp(seg_i) C_i . (S_c dy_i)
  float* dc_lo = per_head + bsh * N + ((r0 + lo) * H + h) * N + 2 * t;
  float* dc_hi = per_head + bsh * N + ((r0 + hi) * H + h) * N + 2 * t;
#pragma unroll
  for (int n = 0; n < NTM; ++n) {
    if (n >= NT || 8 * n >= N) break;
    *reinterpret_cast<float2*>(dc_lo + 8 * n) =
        make_float2(adc[n][0], adc[n][1]);
    *reinterpret_cast<float2*>(dc_hi + 8 * n) =
        make_float2(adc[n][2], adc[n][3]);
  }
  if (t == 0) {
    parts[(r0 + lo) * H + h] = fmaf(es_lo, cz_lo, rs_lo);
    parts[(r0 + hi) * H + h] = fmaf(es_hi, cz_hi, rs_hi);
  }
}

// ------------------------------------------------------------ launches --
// Parts of the float32 scratch buffer, each on a 16-byte boundary; kept
// equal to `_bwd_scratch_floats` in repro_torch/kernels/ssd_scan.py.
struct Scratch {
  float *states, *per_head, *parts, *chunk_f, *segs, *decays;
};

inline long long up4(long long v) { return (v + 3) / 4 * 4; }

inline Scratch carve(float* p, int batch, int S, int H, int N, int P, int Q) {
  const long long bh = (long long)batch * H, nc = S / Q;
  const long long bsh = (long long)batch * S * H;
  Scratch s;
  s.states = p;                      // [2][B][H][nc][N][P]: S_c, then G
  s.per_head = s.states + up4(2 * bh * nc * N * P);  // [2][B][S][H][N]
  s.parts = s.per_head + up4(2 * bsh * N);           // [3][B][S][H]
  s.chunk_f = s.parts + up4(3 * bsh);                // [2][B][H][nc]
  s.segs = s.chunk_f + up4(2 * bh * nc);             // [B][H][S] (bf16)
  s.decays = s.segs + up4(bh * S);                   // [B][H][nc] (bf16)
  return s;
}

// Each kernel may take up to the whole 227 KB of dynamic shared memory
// (set once per kernel and device).
constexpr size_t kSmemMax = 232448;

#define SSD_TRY(call)                                     \
  do {                                                    \
    const cudaError_t e_ = (call);                        \
    if (e_ != cudaSuccess) return static_cast<int>(e_);   \
  } while (0)

template <typename T>
int launch_sums(const float* dt, const float* A, const Scratch& sc, float* ddt,
                float* dA, T* dB, T* dC, int batch, int S, int H, int G, int N,
                int Q, cudaStream_t stream) {
  const int nc = S / Q;
  const long long n_out = (long long)batch * S * G * N;
  const int n_sum = static_cast<int>((n_out + kThreads - 1) / kThreads);
  reduce_kernel<T><<<n_sum + batch * H * nc, kThreads, 0, stream>>>(
      dt, A, sc.per_head, sc.parts, sc.chunk_f, ddt, dB, dC, batch, S, H, G,
      N, Q, n_sum);
  SSD_TRY(cudaGetLastError());
  da_kernel<<<(H + 127) / 128, 128, 0, stream>>>(sc.chunk_f, dA, batch, H,
                                                  nc);
  return static_cast<int>(cudaGetLastError());
}

bool shape_ok(int batch, int S, int H, int G, int N, int P, int Q) {
  return batch >= 1 && Q >= 16 && Q <= 128 && Q % kTile == 0 && N >= 8 &&
         N <= kMaxN && N % 8 == 0 && P >= kSlice && P % kSlice == 0 &&
         G >= 1 && H % G == 0 && S % Q == 0 && S >= Q;
}

// float32: the SIMT passes 1-4.
int launch_f32(const float* x, const float* dt, const float* A,
               const float* Bm, const float* Cm, const float* dy, float* dx,
               float* ddt, float* dA, float* dB, float* dC, float* scratch,
               int batch, int S, int H, int G, int N, int P, int Q, int smem,
               cudaStream_t stream) {
  const size_t local = local_smem(Q, N, P);
  if (!shape_ok(batch, S, H, G, N, P, Q) ||
      local != static_cast<size_t>(smem) || local > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  static unsigned state_set = 0, local_set = 0;
  SSD_TRY(allow_smem_once(state_kernel<float>, kSmemMax, state_set));
  SSD_TRY(allow_smem_once(local_kernel<float>, kSmemMax, local_set));
  const Scratch sc = carve(scratch, batch, S, H, N, P, Q);
  const int nc = S / Q;
  state_kernel<float><<<dim3(batch * H, P / kSlice, 2), kThreads,
                        state_smem(Q, N), stream>>>(
      x, dt, A, Bm, Cm, dy, sc.states, S, H, G, N, P, Q);
  SSD_TRY(cudaGetLastError());
  local_kernel<float><<<dim3(batch * H * nc, Q / kTile, 2), kThreads, local,
                        stream>>>(x, dt, A, Bm, Cm, dy, sc.states, dx, ddt,
                                  sc.per_head, sc.parts, sc.chunk_f, batch, S,
                                  H, G, N, P, Q);
  SSD_TRY(cudaGetLastError());
  return launch_sums(dt, A, sc, ddt, dA, dB, dC, batch, S, H, G, N, Q,
                     stream);
}

template <int PT>
cudaError_t launch_local_mma(const __nv_bfloat16* x, const float* dt,
                             const __nv_bfloat16* Bm,
                             const __nv_bfloat16* Cm, const float* dy,
                             const Scratch& sc, __nv_bfloat16* dx, float* ddt,
                             int batch, int S, int H, int G, int N, int Q,
                             int smem, cudaStream_t stream) {
  static unsigned set8 = 0, set16 = 0;
  const dim3 grid(batch * H * (S / Q));
  const int threads = 32 * (Q / 16);
  cudaError_t err;
  if (round16(N) <= 64) {  // N up to 64: two blocks an SM
    err = allow_smem_once(local_mma<PT, 8>, kSmemMax, set8);
    if (err != cudaSuccess) return err;
    local_mma<PT, 8><<<grid, threads, smem, stream>>>(
        x, dt, Bm, Cm, dy, sc.states, sc.segs, dx, ddt, sc.per_head,
        sc.parts, sc.chunk_f, batch, S, H, G, N, Q);
  } else {
    err = allow_smem_once(local_mma<PT, 16>, kSmemMax, set16);
    if (err != cudaSuccess) return err;
    local_mma<PT, 16><<<grid, threads, smem, stream>>>(
        x, dt, Bm, Cm, dy, sc.states, sc.segs, dx, ddt, sc.per_head,
        sc.parts, sc.chunk_f, batch, S, H, G, N, Q);
  }
  return cudaGetLastError();
}

// bfloat16: the chunk states on the tensor cores and their scan, then the
// local pass on the tensor cores (`mma`) or, where its tiles do not fit,
// the SIMT one; then passes 3-4.
int launch_bf16(const __nv_bfloat16* x, const float* dt, const float* A,
                const __nv_bfloat16* Bm, const __nv_bfloat16* Cm,
                const float* dy, __nv_bfloat16* dx, float* ddt, float* dA,
                __nv_bfloat16* dB, __nv_bfloat16* dC, float* scratch,
                int batch, int S, int H, int G, int N, int P, int Q, int mma,
                int smem, cudaStream_t stream) {
  const size_t local = mma ? local_mma_smem(Q, N, P) : local_smem(Q, N, P);
  if (!shape_ok(batch, S, H, G, N, P, Q) ||
      local != static_cast<size_t>(smem) || local > 232448 ||
      (mma && P > 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const Scratch sc = carve(scratch, batch, S, H, N, P, Q);
  const int nc = S / Q, ps = P % 64 ? 32 : 64;
  const dim3 grid_state(batch * H * nc, P / ps, 2);
  if (ps == 64) {
    static unsigned set = 0;
    SSD_TRY(allow_smem_once(chunk_state_mma<64>, kSmemMax, set));
    chunk_state_mma<64><<<grid_state, 128, chunk_state_smem(Q, N, 64),
                          stream>>>(x, dt, A, Bm, Cm, dy, sc.states, sc.segs,
                                    sc.decays, batch, S, H, G, N, P, Q);
  } else {
    static unsigned set = 0;
    SSD_TRY(allow_smem_once(chunk_state_mma<32>, kSmemMax, set));
    chunk_state_mma<32><<<grid_state, 128, chunk_state_smem(Q, N, 32),
                          stream>>>(x, dt, A, Bm, Cm, dy, sc.states, sc.segs,
                                    sc.decays, batch, S, H, G, N, P, Q);
  }
  SSD_TRY(cudaGetLastError());
  state_scan<<<dim3(batch * H, (N * P + kThreads - 1) / kThreads), kThreads,
               0, stream>>>(sc.states, sc.decays, batch, H, nc, N * P);
  SSD_TRY(cudaGetLastError());
  if (!mma) {
    static unsigned set = 0;
    SSD_TRY(allow_smem_once(local_kernel<__nv_bfloat16>, kSmemMax, set));
    local_kernel<__nv_bfloat16><<<dim3(batch * H * nc, Q / kTile, 2),
                                  kThreads, local, stream>>>(
        x, dt, A, Bm, Cm, dy, sc.states, dx, ddt, sc.per_head, sc.parts,
        sc.chunk_f, batch, S, H, G, N, P, Q);
    SSD_TRY(cudaGetLastError());
  } else {
    switch (P / 8) {
      case 4:
        SSD_TRY(launch_local_mma<4>(x, dt, Bm, Cm, dy, sc, dx, ddt, batch, S,
                                    H, G, N, Q, smem, stream));
        break;
      case 8:
        SSD_TRY(launch_local_mma<8>(x, dt, Bm, Cm, dy, sc, dx, ddt, batch, S,
                                    H, G, N, Q, smem, stream));
        break;
      case 12:
        SSD_TRY(launch_local_mma<12>(x, dt, Bm, Cm, dy, sc, dx, ddt, batch, S,
                                     H, G, N, Q, smem, stream));
        break;
      default:
        SSD_TRY(launch_local_mma<16>(x, dt, Bm, Cm, dy, sc, dx, ddt, batch, S,
                                     H, G, N, Q, smem, stream));
    }
  }
  return launch_sums(dt, A, sc, ddt, dA, dB, dC, batch, S, H, G, N, Q,
                     stream);
}

}  // namespace

// scratch: float32, the parts `carve` lays out (the wrapper's one buffer);
// mma and smem: the local pass's route and shared bytes (the wrapper's
// plan; the float32 route has only the SIMT pass).
extern "C" int ssd_scan_bwd_f32(const float* x, const float* dt,
                                const float* A, const float* Bm,
                                const float* Cm, const float* dy, float* dx,
                                float* ddt, float* dA, float* dB, float* dC,
                                float* scratch, int batch, int S, int H, int G,
                                int N, int P, int Q, int mma, int smem,
                                void* stream) {
  if (mma) return static_cast<int>(cudaErrorInvalidValue);
  return launch_f32(x, dt, A, Bm, Cm, dy, dx, ddt, dA, dB, dC, scratch, batch,
                    S, H, G, N, P, Q, smem, static_cast<cudaStream_t>(stream));
}

extern "C" int ssd_scan_bwd_bf16(
    const __nv_bfloat16* x, const float* dt, const float* A,
    const __nv_bfloat16* Bm, const __nv_bfloat16* Cm, const float* dy,
    __nv_bfloat16* dx, float* ddt, float* dA, __nv_bfloat16* dB,
    __nv_bfloat16* dC, float* scratch, int batch, int S, int H, int G, int N,
    int P, int Q, int mma, int smem, void* stream) {
  return launch_bf16(x, dt, A, Bm, Cm, dy, dx, ddt, dA, dB, dC, scratch,
                     batch, S, H, G, N, P, Q, mma, smem,
                     static_cast<cudaStream_t>(stream));
}
