// Weight-only int8 matmul (kernel 20): out = (x @ w8) * scale, x [M, K]
// bf16 or fp16, w8 [K, N] int8 with one fp32 scale per output column, fp32
// accumulation, out [M, N] in x's type.
//
// Replaces: paddle_tpu/kernels/quant.py `_wo_matmul_kernel` (launched by
// `_wo_matmul_pallas`, entry `int8_weight_matmul`), which the serving
// engine's weight-only int8 model reaches from every MLP projection and the
// lm head through `F.weight_only_linear`.
//
// Semantics kept from the Pallas kernel: the product runs over the int8
// values themselves with fp32 accumulation, and the scale row multiplies
// once, after the K walk (dequant factors out of the contraction, so this
// equals dequantizing the whole weight first, which never exists in device
// memory); the fp32 result is rounded once to x's type.
//
// Design. Hopper's tensor cores have no bf16 x int8 product, so each int8
// W slab is staged into shared memory as int8 by cp.async (half the bytes
// of a bf16 slab) and upcast there to x's type before the warps' ldmatrix
// reads it: every int8 value is exact in bf16 and fp16, and a bf16 x bf16
// product is exact in fp32, so mma.sync m16n8k16 with fp32 accumulators
// computes JAX's fp32 x.f32 @ w8.f32 up to the order of the sums. The
// mainloop is the loss head's (flxent_common.cuh, gemm_tile_i8): 128 x 128
// output tiles on 8 warps, k steps of 64, a 3-stage cp.async ring. The
// epilogue multiplies each column by its scale and writes pairs of x's type.
// The JAX (bm, bn, bk) divisibility gate is a Mosaic tiling limit; here M is
// any size, N and K multiples of 16 (the wrapper checks).
//
// Bound on H100: operations at the serving shapes (M = 512 rows of the
// [8, 64] step): 2 M K N flops over ~K N bytes of int8 weight, 2 M = 1024
// flops per weight byte, above the card's ~295 flop/byte ridge (gate/up and
// down 4.62e10 flops, 0.0467 ms; the lm head 1.34e11, 0.136 ms at 989
// TFLOP/s). This first version runs mma.sync, not wgmma, with one extra
// __syncthreads per k step for the upcast.
#include "flxent_common.cuh"

using ptt::bf16;
using ptt::f16;
namespace fx = ptt::flx;

namespace {

template <typename T>
__global__ void __launch_bounds__(fx::kThreads, 2)
wo_matmul_kernel(fx::Operand<T> X, fx::Operand<int8_t> W, const float* __restrict__ scale, T* __restrict__ out,
                 int M, int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tiles_m = (M + fx::kBM - 1) / fx::kBM, tiles_n = (N + fx::kBN - 1) / fx::kBN;
  int tm, tn;
  fx::tile_coords(tiles_m, tiles_n, tm, tn);
  const int m0 = tm * fx::kBM, n0 = tn * fx::kBN;
  float acc[fx::kMT][fx::kNT][4];
  fx::gemm_tile_i8<T, false>(acc, X, W, m0, n0, smem_raw);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / fx::kWarpsN, wn = warp % fx::kWarpsN, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int nt = 0; nt < fx::kNT; ++nt) {
    const int col = n0 + wn * fx::kWN + nt * 8 + 2 * tig;  // even; N % 16 == 0: col + 1 < N with col
    if (col >= N) continue;
    const float s0 = scale[col], s1 = scale[col + 1];
#pragma unroll
    for (int mt = 0; mt < fx::kMT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * fx::kWM + mt * 16 + gid + 8 * h;
        if (row >= M) continue;
        alignas(4) T pair[2] = {ptt::from_f<T>(acc[mt][nt][2 * h] * s0), ptt::from_f<T>(acc[mt][nt][2 * h + 1] * s1)};
        *reinterpret_cast<uint32_t*>(out + static_cast<long long>(row) * N + col) =
            *reinterpret_cast<const uint32_t*>(pair);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* w8, const void* scale, void* out, int M, int K, int N, cudaStream_t stream) {
  auto kernel = wo_matmul_kernel<T>;
  cudaError_t err = fx::allow_smem(kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = ((M + fx::kBM - 1) / fx::kBM) * ((N + fx::kBN - 1) / fx::kBN);
  kernel<<<tiles, fx::kThreads, fx::kSmemBytes, stream>>>(
      fx::operand<T>(x, K, M, K), fx::operand<int8_t>(w8, N, N, K), static_cast<const float*>(scale),
      static_cast<T*>(out), M, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// io: ptt::kBF16 or ptt::kF16 (x and out). x [M, K] with K % 16 == 0, 16-byte
// aligned; w8 [K, N] int8 with N % 16 == 0, 16-byte aligned; scale [N] fp32;
// out [M, N]. Returns cudaErrorInvalidValue for another type or shape.
extern "C" int ptt_wo_matmul(int io, const void* x, const void* w8, const void* scale, void* out, int M, int K,
                             int N, void* stream) {
  if (M < 0 || K % 16 || N % 16 || K <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (io) {
    case ptt::kBF16: return launch<bf16>(x, w8, scale, out, M, K, N, s);
    case ptt::kF16: return launch<f16>(x, w8, scale, out, M, K, N, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
