// The fp32 GEMM mainloop on the CUDA cores of flxent_fp32.cu (the loss
// head's fp32 products; kernel 20's fp32 products run wo_matmul.cu's
// mma.sync instance since it replaced its CUDA-core one): one
// 128 x 128 output tile of C = A B per block of 256 threads, 8 x 8 fp32 FMAs
// a thread from register-double-buffered k tiles of 16 in shared memory.
// Each k tile's 16 products are summed apart and then added to the running
// sum, so the rounding error grows with 16 + K / 16 additions, not K. No
// TF32: it would round the operands. Each caller reads its operands in place
// through a load function of (outer index, k) and writes its own epilogue.
#pragma once

#include <cuda_runtime.h>

namespace ptt {
namespace simt {

constexpr int kBM = 128, kBN = 128, kBK = 16, kThreads = 256;

// A thread's 8 values of a [16 k][128 o] tile, element (o, k) from
// load(o, k), 0 past the extents O and K. K-major (k contiguous in memory):
// o = t % 128 and k = 8 (t / 128) + i (the transposed stores hit 32 banks);
// MN-major: k = t / 16 and o = 8 (t % 16) + i (coalesced loads, two float4
// stores).
template <bool KMAJOR, typename Load>
__device__ __forceinline__ void fetch(float (&v)[8], const Load& load, int o0, int O, int k0, int K, int t) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int o = KMAJOR ? o0 + (t & 127) : o0 + (t & 15) * 8 + i;
    const int k = KMAJOR ? k0 + (t >> 7) * 8 + i : k0 + (t >> 4);
    v[i] = (o < O && k < K) ? load(o, k) : 0.f;
  }
}

template <bool KMAJOR>
__device__ __forceinline__ void put(float (*s)[kBM], const float (&v)[8], int t) {
  if (KMAJOR) {
#pragma unroll
    for (int i = 0; i < 8; ++i) s[(t >> 7) * 8 + i][t & 127] = v[i];
  } else {
    *reinterpret_cast<float4*>(&s[t >> 4][(t & 15) * 8]) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(&s[t >> 4][(t & 15) * 8 + 4]) = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// Thread t's outputs: acc[i][j] is row m0 + sub(t / 16, i), column
// n0 + sub(t % 16, j) of the tile.
__device__ __forceinline__ int sub(int x, int i) { return i < 4 ? x * 4 + i : 64 + x * 4 + i - 4; }

// acc = the [m0, m0 + 128) x [n0, n0 + 128) tile of A [M, K] (element
// (m, k) from load_a) times B [K, N] (element (n, k) from load_b); A_K and
// B_K say which operand has k contiguous in memory.
template <bool A_K, bool B_K, typename LoadA, typename LoadB>
__device__ __forceinline__ void tile_product(float (&acc)[8][8], const LoadA& load_a, int m0, int M,
                                             const LoadB& load_b, int n0, int N, int K) {
  __shared__ __align__(16) float as[2][kBK][kBM];  // [k][row]
  __shared__ __align__(16) float bs[2][kBK][kBN];  // [k][column]
  const int t = threadIdx.x;
  const int ty = t >> 4, tx = t & 15;
  float av[8], bv[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int nk = (K + kBK - 1) / kBK;
  if (nk > 0) {
    fetch<A_K>(av, load_a, m0, M, 0, K, t);
    fetch<B_K>(bv, load_b, n0, N, 0, K, t);
    put<A_K>(as[0], av, t);
    put<B_K>(bs[0], bv, t);
  }
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int b = kt & 1;
    if (kt + 1 < nk) {  // in flight while this tile's FMAs run
      fetch<A_K>(av, load_a, m0, M, (kt + 1) * kBK, K, t);
      fetch<B_K>(bv, load_b, n0, N, (kt + 1) * kBK, K, t);
    }
    float part[8][8];
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[b][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[b][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[b][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[b][kk][64 + tx * 4]);
      const float x[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float y[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) part[i][j] = kk ? fmaf(x[i], y[j], part[i][j]) : x[i] * y[j];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] += part[i][j];
    if (kt + 1 < nk) {  // buffer b ^ 1 was last read before the previous barrier
      put<A_K>(as[b ^ 1], av, t);
      put<B_K>(bs[b ^ 1], bv, t);
    }
    __syncthreads();
  }
}

}  // namespace simt
}  // namespace ptt
