// Mamba2 SSD chunked scan (state-space duality, arXiv:2405.21060).
//
// Replaces the Pallas TPU kernel `ssd_scan` in src/repro/kernels/ssd_scan.py
// (`_ssd_kernel`).  x [B, S, H, P] and B/C [B, S, G, N] in float32 or
// bfloat16, dt [B, S, H] and A [H] float32; y [B, S, H, P] float32.  The
// output is float32, not x's type: the model's path (`ssm.ssd_chunked`)
// returns float32 and `ssm_forward` adds D*x before one cast (ssm.py:145-148),
// so a bfloat16 y would round twice.  S must be a multiple of the chunk Q
// (`ssm_forward` pads first, as in JAX).
//
// Per chunk, with seg = cumsum(dt * A) over the chunk's Q positions:
//   y_i   = sum_{j<=i} (C_i . B_j) exp(seg_i - seg_j) dt_j x_j
//         + (C_i exp(seg_i)) @ state                       (carried-in term)
//   state = exp(seg_Q) state + sum_j B_j (exp(seg_Q - seg_j) dt_j) x_j^T
// the same terms as the TPU kernel (ssd_scan.py:38-53) and the model.
//
// Differences of layout, not of math: one block per (batch, head) walks the
// chunks in order and keeps the [N, P] state in float32 shared memory; the
// TPU grid carries it in VMEM scratch across its sequential chunk axis.
// B/C are read by group (head / (H / G)) instead of being broadcast per
// head beforehand (ssd_scan.py:67-70), which would be H times the bytes.
//
// What bounds it on the H100: per chunk about Q*Q*N/2 + Q*P*(Q/2 + N) +
// N*P*Q multiply-adds against Q*(P + 2N) loads: operations.  This first
// version is SIMT float32 from shared memory, one output per thread per
// pass (no register tiling, no wgmma); at Q = 128, N = P = 64 the tiles take
// 183 KB of dynamic shared memory, so one block (512 threads) fits an SM.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;

// Kept equal to `_smem_bytes` in repro_torch/kernels/ssd_scan.py.
inline size_t smem_floats(int Q, int N, int P) {
  return (size_t)Q * P + 2 * (size_t)Q * (N + 1) + (size_t)Q * Q +
         (size_t)N * P + 4 * (size_t)Q;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, float* __restrict__ y, int S, int H,
                int G, int N, int P, int Q) {
  extern __shared__ float sm[];
  const int NP = N + 1;          // padded rows: conflict-free column reads
  float* xs = sm;                // [Q][P]
  float* bs = xs + Q * P;        // [Q][NP]
  float* cs = bs + Q * NP;       // [Q][NP]
  float* gs = cs + Q * NP;       // [Q][Q] masked decayed scores
  float* st = gs + Q * Q;        // [N][P] the carried state
  float* seg = st + N * P;       // [Q] running log-decay
  float* dts = seg + Q;          // [Q]
  float* ecs = dts + Q;          // [Q] exp(seg_i)
  float* ws = ecs + Q;           // [Q] exp(seg_last - seg_j) * dt_j

  const int tid = threadIdx.x, nt = blockDim.x;
  const int b = blockIdx.x / H, h = blockIdx.x % H, g = h / (H / G);
  const float a = A[h];
  for (int i = tid; i < N * P; i += nt) st[i] = 0.0f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    const long long r0 = (long long)b * S + c0;  // the chunk's first row
    __syncthreads();  // the last chunk is done with the tiles
    for (int i = tid; i < Q * P; i += nt) {
      const int j = i / P, p = i % P;
      xs[i] = repro_torch::to_f32(x[((r0 + j) * H + h) * P + p]);
    }
    for (int i = tid; i < Q * N; i += nt) {
      const int j = i / N, n = i % N;
      const long long off = ((r0 + j) * G + g) * N + n;
      bs[j * NP + n] = repro_torch::to_f32(Bm[off]);
      cs[j * NP + n] = repro_torch::to_f32(Cm[off]);
    }
    for (int i = tid; i < Q; i += nt) dts[i] = dt[(r0 + i) * H + h];
    __syncthreads();

    if (tid == 0) {
      // seg = cumsum(dt * A) in position order, one thread: the prefix sums
      // reach |seg| ~ 1e2 within a chunk, and exp(seg_i - seg_j) turns
      // their last-bit rounding into a relative error of the decay, so
      // they are rounded exactly as the plain version's sequential
      // torch.cumsum (and jnp.cumsum on the CPU) round them.
      float run = 0.0f;
      for (int i = 0; i < Q; ++i) {
        run += dts[i] * a;
        seg[i] = run;
      }
    }
    __syncthreads();

    const float seg_last = seg[Q - 1];
    for (int i = tid; i < Q; i += nt) {
      ecs[i] = expf(seg[i]);
      ws[i] = expf(seg_last - seg[i]) * dts[i];
    }
    for (int idx = tid; idx < Q * Q; idx += nt) {
      const int i = idx / Q, j = idx % Q;
      float v = 0.0f;
      if (j <= i) {
        float dot = 0.0f;
        for (int n = 0; n < N; ++n) dot = fmaf(cs[i * NP + n], bs[j * NP + n], dot);
        v = dot * expf(seg[i] - seg[j]) * dts[j];
      }
      gs[idx] = v;
    }
    __syncthreads();

    for (int idx = tid; idx < Q * P; idx += nt) {
      const int i = idx / P, p = idx % P;
      float yd = 0.0f;
      for (int j = 0; j <= i; ++j) yd = fmaf(gs[i * Q + j], xs[j * P + p], yd);
      float yo = 0.0f;
      const float e = ecs[i];
      for (int n = 0; n < N; ++n)
        yo = fmaf(cs[i * NP + n] * e, st[n * P + p], yo);
      y[((r0 + i) * H + h) * P + p] = yd + yo;
    }
    __syncthreads();  // every read of the old state is done

    const float decay = expf(seg_last);
    for (int idx = tid; idx < N * P; idx += nt) {
      const int n = idx / P, p = idx % P;
      float acc = 0.0f;
      for (int j = 0; j < Q; ++j)
        acc = fmaf(bs[j * NP + n] * ws[j], xs[j * P + p], acc);
      st[idx] = decay * st[idx] + acc;
    }
  }
}

template <typename T>
int launch(const T* x, const float* dt, const float* A, const T* Bm,
           const T* Cm, float* y, int batch, int S, int H, int G, int N,
           int P, int Q, void* stream) {
  const size_t smem = smem_floats(Q, N, P) * sizeof(float);
  cudaError_t err = repro_torch::allow_smem(ssd_scan_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<T><<<batch * H, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      x, dt, A, Bm, Cm, y, S, H, G, N, P, Q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ssd_scan_f32(const float* x, const float* dt, const float* A,
                            const float* Bm, const float* Cm, float* y,
                            int batch, int S, int H, int G, int N, int P,
                            int Q, void* stream) {
  return launch(x, dt, A, Bm, Cm, y, batch, S, H, G, N, P, Q, stream);
}

extern "C" int ssd_scan_bf16(const __nv_bfloat16* x, const float* dt,
                             const float* A, const __nv_bfloat16* Bm,
                             const __nv_bfloat16* Cm, float* y, int batch,
                             int S, int H, int G, int N, int P, int Q,
                             void* stream) {
  return launch(x, dt, A, Bm, Cm, y, batch, S, H, G, N, P, Q, stream);
}
