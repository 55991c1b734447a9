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
// Four kernels, in order on the caller's stream; no atomics, every sum in
// a fixed order, so two runs agree bit for bit:
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
// 3. `reduce_kernel`: dB and dC summed over each group's heads in head
//    order (cast to B's type), and a block a chunk that takes the reverse
//    cumulative sum of dseg into ddt and a dA part.
// 4. `da_kernel`: dA over batches and chunks, in order.
//
// What bounds it on the H100: the local pass's score tiles and products,
// about 2x the forward's multiply-adds, run as float32 FFMA on the CUDA
// cores (67 TFLOP/s) from shared memory, and it takes most of the time:
// each 16-position tile step loads its tiles, then computes, with no
// copy in flight, and a block rereads the [N, P] state.  Its float32
// per-head dB and dC (2 B S H N floats, written and read once) are more
// bytes than all the inputs at Zamba2's and mamba2's shapes.  mma.sync or
// wgmma tiles, copies in flight and a head-summed dB are later work
// (ROADMAP A.2).
#include "common.cuh"

namespace {

using repro_torch::from_f32;
using repro_torch::to_f32;

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

// seg = cumsum(dt * a) over the chunk in position order by one thread,
// each term rounded before the add, as the forward kernel sums it.
__device__ __forceinline__ void chunk_seg(const float* dts, float a,
                                          float* seg, int Q) {
  if (threadIdx.x == 0) {
    float run = 0.0f;
    for (int i = 0; i < Q; ++i) {
      run = __fadd_rn(run, __fmul_rn(dts[i], a));
      seg[i] = run;
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

template <typename T>
int launch_bwd(const T* x, const float* dt, const float* A, const T* Bm,
               const T* Cm, const float* dy, T* dx, float* ddt, float* dA,
               T* dB, T* dC, float* states, float* per_head, float* parts,
               float* chunk_f, int batch, int S, int H, int G, int N, int P,
               int Q, int smem, cudaStream_t stream) {
  const size_t local = local_smem(Q, N, P);
  if (Q < 16 || Q > 128 || Q % kTile || N < 8 || N > kMaxN || N % 8 ||
      P < kSlice || P % kSlice || G < 1 || H % G || S % Q ||
      local != static_cast<size_t>(smem) || local > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = S / Q;
  const size_t st_smem = state_smem(Q, N);
  cudaError_t err = repro_torch::allow_smem(state_kernel<T>, st_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  state_kernel<T><<<dim3(batch * H, P / kSlice, 2), kThreads, st_smem,
                    stream>>>(x, dt, A, Bm, Cm, dy, states, S, H, G, N, P,
                              Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if ((err = repro_torch::allow_smem(local_kernel<T>, local)) != cudaSuccess)
    return static_cast<int>(err);
  local_kernel<T><<<dim3(batch * H * nc, Q / kTile, 2), kThreads, local,
                    stream>>>(x, dt, A, Bm, Cm, dy, states, dx, ddt, per_head,
                              parts, chunk_f, batch, S, H, G, N, P, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const long long n_out = (long long)batch * S * G * N;
  const int n_sum = static_cast<int>((n_out + kThreads - 1) / kThreads);
  reduce_kernel<T><<<n_sum + batch * H * nc, kThreads, 0, stream>>>(
      dt, A, per_head, parts, chunk_f, ddt, dB, dC, batch, S, H, G, N, Q,
      n_sum);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  da_kernel<<<(H + 127) / 128, 128, 0, stream>>>(chunk_f, dA, batch, H, nc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Scratch (float32, the wrapper's): states [2][B][H][nc][N][P], per_head
// [2][B][S][H][N], parts [3][B][S][H], chunk_f [2][B][H][nc]; smem: the
// local pass's shared bytes (the wrapper's plan).
extern "C" int ssd_scan_bwd_f32(const float* x, const float* dt,
                                const float* A, const float* Bm,
                                const float* Cm, const float* dy, float* dx,
                                float* ddt, float* dA, float* dB, float* dC,
                                float* states, float* per_head, float* parts,
                                float* chunk_f, int batch, int S, int H, int G,
                                int N, int P, int Q, int smem, void* stream) {
  return launch_bwd(x, dt, A, Bm, Cm, dy, dx, ddt, dA, dB, dC, states,
                    per_head, parts, chunk_f, batch, S, H, G, N, P, Q, smem,
                    static_cast<cudaStream_t>(stream));
}

extern "C" int ssd_scan_bwd_bf16(
    const __nv_bfloat16* x, const float* dt, const float* A,
    const __nv_bfloat16* Bm, const __nv_bfloat16* Cm, const float* dy,
    __nv_bfloat16* dx, float* ddt, float* dA, __nv_bfloat16* dB,
    __nv_bfloat16* dC, float* states, float* per_head, float* parts,
    float* chunk_f, int batch, int S, int H, int G, int N, int P, int Q,
    int smem, void* stream) {
  return launch_bwd(x, dt, A, Bm, Cm, dy, dx, ddt, dA, dB, dC, states,
                    per_head, parts, chunk_f, batch, S, H, G, N, P, Q, smem,
                    static_cast<cudaStream_t>(stream));
}
