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
//
// What bounds it on the H100: every iteration re-reads the row (4 + 4 + 1
// bytes per user), so a [100, 1e6] fleet solve streams ~0.9 GB per pass
// and is memory-bound; the DAGSA step at the paper's shape ([8, 50]) is a
// single tiny launch and is bound by launch latency.  The simple design
// gives each row one block of 256 threads that stride over U and meet in
// one block reduction (warp shuffles, then shared memory) per iteration;
// the solver state (lo, hi, t) is identical in every thread, so no thread
// waits on another beyond the reduction.  With K < 132 rows the card is
// not full; splitting long rows over several blocks is later work.
//
// tcomp may be shared by all rows: a row stride of 0 reads one [U] vector,
// so DAGSA never broadcasts it to [M, N].
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
bw_solve_kernel(const float* __restrict__ coeff,
                const float* __restrict__ tcomp, long long tc_row_stride,
                const uint8_t* __restrict__ mask,
                const float* __restrict__ bw,
                const float* __restrict__ lo_hint,
                float* __restrict__ out, int u, int iters, int bisect) {
  __shared__ float sh[64];
  const long long row = blockIdx.x;
  const float* c = coeff + row * u;
  const float* tc = tcomp + row * tc_row_stride;
  const uint8_t* m = mask + row * u;

  float cnt = 0.0f, csum = 0.0f, tmax = -INFINITY;
  for (int i = threadIdx.x; i < u; i += blockDim.x) {
    if (m[i]) {
      cnt += 1.0f;
      csum += c[i];
      tmax = fmaxf(tmax, tc[i]);
    }
  }
  repro_torch::block_sum2(cnt, csum, sh);
  tmax = repro_torch::block_max(tmax, sh);
  const bool any_user = cnt > 0.0f;
  if (!any_user) tmax = 0.0f;

  const float b = bw[row];
  float hi = tmax + csum / fmaxf(b, 1e-12f) + 1e-9f;
  float lo = fminf(fmaxf(lo_hint[row], tmax), hi);

  // f(t) - bw and its slope, summed over the masked-in users
  auto f_df = [&](float t, float& f, float& df) {
    float fs = 0.0f, ds = 0.0f;
    for (int i = threadIdx.x; i < u; i += blockDim.x) {
      if (m[i]) {
        const float r = 1.0f / fmaxf(t - tc[i], 1e-12f);
        const float inv = c[i] * r;
        fs += inv;
        ds += inv * r;
      }
    }
    repro_torch::block_sum2(fs, ds, sh);
    f = fs - b;
    df = -ds;
  };

  float t;
  if (bisect) {
    for (int it = 0; it < iters; ++it) {
      const float mid = 0.5f * (lo + hi);
      float f, df;
      f_df(mid, f, df);
      const bool too_fast = f > 0.0f;
      lo = too_fast ? mid : lo;
      hi = too_fast ? hi : mid;
    }
    t = 0.5f * (lo + hi);
  } else {
    t = hi;
    for (int it = 0; it < iters; ++it) {
      float f, df;
      f_df(t, f, df);
      const bool below = f > 0.0f;  // t left of the root
      lo = below ? t : lo;
      hi = below ? hi : t;
      const float t_newton = t - f / fminf(df, -1e-12f);
      const bool safe = (t_newton > lo) && (t_newton < hi);
      t = safe ? t_newton : 0.5f * (lo + hi);
    }
  }
  if (threadIdx.x == 0) out[row] = any_user ? t : 0.0f;
}

}  // namespace

extern "C" int bandwidth_solve_f32(const float* coeff, const float* tcomp,
                                   long long tc_row_stride,
                                   const uint8_t* mask, const float* bw,
                                   const float* lo, float* out, int k, int u,
                                   int iters, int bisect, void* stream) {
  if (k > 0) {
    bw_solve_kernel<<<k, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        coeff, tcomp, tc_row_stride, mask, bw, lo, out, u, iters, bisect);
  }
  return static_cast<int>(cudaGetLastError());
}
