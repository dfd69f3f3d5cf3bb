// Shared device helpers for the paddle_tpu_torch kernels (bf16 I/O unless a
// kernel is templated on its type; fp32 math).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptt {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// round to nearest even, the rounding PyTorch's bf16 ops use
__device__ __forceinline__ bf16 to_bf(float x) { return __float2bfloat16_rn(x); }

// the value a bf16 op would have produced: fp32 result rounded to bf16
__device__ __forceinline__ float round_bf(float x) { return to_f(to_bf(x)); }

// kernels templated on the I/O type T (bf16, fp16 or fp32): fp32 math always
using f16 = __half;
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(f16 x) { return __half2float(x); }
// the int8 payload of the quantized KV pool and of the weight-only
// projections: every int8 value is exact in fp32 (and in bf16 and fp16)
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return to_bf(x); }
template <> __device__ __forceinline__ f16 from_f<f16>(float x) { return __float2half_rn(x); }
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

// the value an op in type T would have produced: fp32 result rounded to T
template <typename T> __device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

// neox rope of one element in type T as the reference computes it: the
// table values c, s rounded to T (the reference casts its fp32 tables to
// x's type), x*c and rot*s each rounded to T, then their sum
// (__fmul_rn/__fadd_rn: never contracted into an FMA, so fp32 rounds too)
template <typename T>
__device__ __forceinline__ float rope_val(float x, float rot, float c, float s) {
  const float a = round_to<T>(__fmul_rn(x, round_to<T>(c)));
  const float b = round_to<T>(__fmul_rn(rot, round_to<T>(s)));
  return round_to<T>(__fadd_rn(a, b));
}

// rope_val of element d of a row of T, the tables' rows of type R (T or fp32)
template <typename T, int D, typename R = T>
__device__ __forceinline__ float rope_elem(const T* row, const R* cos_row, const R* sin_row, int d) {
  const float x = to_f(row[d]);
  const float rot = d < D / 2 ? -to_f(row[d + D / 2]) : to_f(row[d - D / 2]);
  return rope_val<T>(x, rot, to_f(cos_row[d]), to_f(sin_row[d]));
}

// the I/O type codes of the templated kernels' C entry points
enum IoType : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

// Sum of v over one warp; every lane returns the total.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

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

// Column sums of an fp32 [nblk, ncols] array of per-block partials, in a
// fixed order (no atomics: two runs give the same bits): slice s of a block
// sums partials s, s + 8, s + 16, ... in turn, then slice 0 adds the 8 slice
// sums in order and writes out[c] in T. The norm backwards (kernels 8, 11,
// 13) reduce their weight (and bias) gradients with it.
constexpr int kColSumCols = 32, kColSumSlices = 8;

template <typename T>
__global__ void __launch_bounds__(kColSumCols * kColSumSlices)
column_sum_kernel(const float* __restrict__ part, T* __restrict__ out, int nblk, int ncols) {
  __shared__ float acc[kColSumSlices][kColSumCols + 1];
  const int lane = threadIdx.x % kColSumCols, s = threadIdx.x / kColSumCols;
  const int c = blockIdx.x * kColSumCols + lane;
  float v = 0.f;
  if (c < ncols) {
    for (int b = s; b < nblk; b += kColSumSlices) v += part[static_cast<size_t>(b) * ncols + c];
  }
  acc[s][lane] = v;
  __syncthreads();
  if (s == 0 && c < ncols) {
    float t = 0.f;
#pragma unroll
    for (int j = 0; j < kColSumSlices; ++j) t += acc[j][lane];
    out[c] = from_f<T>(t);
  }
}

template <typename T>
int launch_column_sum(const float* part, T* out, int nblk, int ncols, cudaStream_t stream) {
  column_sum_kernel<T><<<(ncols + kColSumCols - 1) / kColSumCols, kColSumCols * kColSumSlices, 0, stream>>>(
      part, out, nblk, ncols);
  return static_cast<int>(cudaGetLastError());
}

// Let a kernel use `smem` bytes of dynamic shared memory (above 48 KB a
// block must opt in); returns a cudaError_t. The 48 KB count the kernel's
// static shared memory too, so 1 KB is left for it (the norm kernels'
// static sums take 256 bytes): kernel 12 at H 12288, exactly 48 KB of fp32
// row, opts in.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem + 1024 <= 48 * 1024) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
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

// the same 16-byte access for any element type T: 16 / sizeof(T) values
template <typename T>
__device__ __forceinline__ uint4 load16(const T* p, size_t i) {
  return reinterpret_cast<const uint4*>(p)[i];
}
template <typename T>
__device__ __forceinline__ void store16(T* p, size_t i, uint4 v) {
  reinterpret_cast<uint4*>(p)[i] = v;
}
template <typename T>
__device__ __forceinline__ const T* elems_of(const uint4& v) {
  return reinterpret_cast<const T*>(&v);
}
template <typename T>
__device__ __forceinline__ T* elems_of(uint4& v) {
  return reinterpret_cast<T*>(&v);
}

}  // namespace ptt
