// Shared helpers of the port's CUDA kernels: warp and block reductions.
//
// Every kernel here is launched from Python through ctypes (see
// repro_torch/kernels/_lib.py): plain C entry points, raw device pointers,
// the caller's stream, and cudaGetLastError() as the return code.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace repro_torch {

// Loads and stores of the kernels templated on their storage type: the
// math is float32 throughout; a bfloat16 result rounds to nearest even, as
// torch's `.to(torch.bfloat16)` does.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Sets the dynamic shared memory a kernel may take above the 48 KB default.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// allow_smem once per kernel and device (`done`: a bit a device), not on
// every launch: the call costs host time.
template <typename K>
inline cudaError_t allow_smem_once(K kernel, size_t bytes, unsigned& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 32 && (done >> dev) & 1u)) return err;
  err = allow_smem(kernel, bytes);
  if (err == cudaSuccess && dev < 32) done |= 1u << dev;
  return err;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

// Sums a and b over the block and hands both totals to every thread.
// `sh` holds 64 floats of shared memory; blockDim.x is a multiple of 32.
__device__ __forceinline__ void block_sum2(float& a, float& b, float* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    sh[warp] = a;
    sh[32 + warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < n_warps ? sh[lane] : 0.0f;
    b = lane < n_warps ? sh[32 + lane] : 0.0f;
    a = warp_sum(a);
    b = warp_sum(b);
    if (lane == 0) {
      sh[0] = a;
      sh[32] = b;
    }
  }
  __syncthreads();
  a = sh[0];
  b = sh[32];
  __syncthreads();  // the caller may reuse `sh` at once
}

// Max of v over the block, handed to every thread (same contract).
__device__ __forceinline__ float block_max(float v, float* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  v = warp_max(v);
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < n_warps ? sh[lane] : -INFINITY;
    v = warp_max(v);
    if (lane == 0) sh[0] = v;
  }
  __syncthreads();
  v = sh[0];
  __syncthreads();
  return v;
}

}  // namespace repro_torch
