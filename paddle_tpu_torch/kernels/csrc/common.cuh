// Shared device helpers for the paddle_tpu_torch kernels (bf16 I/O, fp32 math).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptt {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// round to nearest even, the rounding PyTorch's bf16 ops use
__device__ __forceinline__ bf16 to_bf(float x) { return __float2bfloat16_rn(x); }

// the value a bf16 op would have produced: fp32 result rounded to bf16
__device__ __forceinline__ float round_bf(float x) { return to_f(to_bf(x)); }

// Sum of v over the whole block; every thread returns the total.
// `scratch` holds at least THREADS / 32 floats. Call once per kernel.
template <int THREADS>
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  static_assert(THREADS % 32 == 0 && THREADS <= 1024, "whole warps only");
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = lane < THREADS / 32 ? scratch[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 8 bf16 values moved as one 16-byte access (callers check 16-byte alignment)
__device__ __forceinline__ uint4 load8(const bf16* p, int i) {
  return reinterpret_cast<const uint4*>(p)[i];
}
__device__ __forceinline__ void store8(bf16* p, int i, uint4 v) {
  reinterpret_cast<uint4*>(p)[i] = v;
}
__device__ __forceinline__ const bf16* elems(const uint4& v) {
  return reinterpret_cast<const bf16*>(&v);
}
__device__ __forceinline__ bf16* elems(uint4& v) { return reinterpret_cast<bf16*>(&v); }

}  // namespace ptt
