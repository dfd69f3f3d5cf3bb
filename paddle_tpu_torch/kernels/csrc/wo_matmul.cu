// Weight-only int8 matmul (kernel 20): out = (x @ w8) * scale, x [M, K] in T
// (bf16, fp16 or fp32), w8 [K, N] int8 with one fp32 scale per output column,
// fp32 accumulation, out [M, N] in T. Every operand is read in place in that
// layout: no repacked copy of the weight exists.
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
// memory); the fp32 result is rounded once to T. Every int8 value is exact in
// bf16 and fp16, and a bf16 or fp16 product is exact in fp32, so a
// tensor-core product with fp32 accumulators computes JAX's x.f32 @ w8.f32 up
// to the order of the sums. x is never quantized.
//
// Two instances; the wrapper (kernels/quant.py `wo_route`) picks one from
// the dtype and the shape before the launch:
//
// - wgmma (bf16 and fp16 x, K % 8 == 0 and N % 16 == 0: the TMA maps'
//   16-byte row strides). Hopper's wgmma takes B only from shared memory and
//   both operands in one 16-bit type, so the kernel computes the transposed
//   tile out^T[n, m] = sum_k W^T[n, k] x^T[k, m]: A = W^T through REGISTERS,
//   B = x^T, which is K-major as x lies (wgmma RS with trans-b = 0).
//   The mainloop (csrc/wo_mainloop.cuh, shared with kernel 17's int8 site):
//   a persistent grid of 384 threads, a producer thread keeping the TMA
//   loads of the int8 W box [64 k][128 n] and the x box(es) in a ring, two
//   consumer warpgroups of 64 weight columns each that widen the int8
//   values to T in registers (exactly) as wgmma's A operand, one k16 step a
//   group, the next widened while it runs. The tile follows M: 8 x rows
//   for M <= 8 (decode), 64 for M <= 64, else 256-row tiles (wgmma n256:
//   each widened value feeds 256 products), the 256-row tiles past the last
//   full round over the SMs split into 128-row tiles where that shortens the
//   longest CTA's work (a 128-row tile costs ~0.62 of a 256-row one).
//   - Epilogue from registers: each accumulator row is one weight column, so
//     a thread multiplies by two scales, rounds to T and stores column pairs
//     (32-bit, full 32-byte sectors a warp); rows past M are dropped.
//   Plans at the serving shapes (M 512, 132 SMs): gate/up N 11008: 132
//   256-row tiles, then 80 128-row ones (one round each); down N 4096: 128
//   128-row tiles (0.97 of a round); lm head N 32000: 500 256-row tiles (3.8
//   rounds); eight rows: 86 8-row tiles, one round.
// - CUDA cores (fp32 x, and any K or N the TMA maps cannot address, in any
//   of the three types): simt_gemm.cuh's fp32 mainloop (128 x 128 output
//   tiles of 256 threads, k tiles of 16 summed apart; shared with the loss
//   head's fp32 products, flxent_fp32.cu), x and w8 widened to fp32 as they
//   are staged. No TF32: it would round x. Any M, K and N.
//
// Bound on H100: at the serving shapes (M 512 rows of the [8, 64] step) 2 M
// = 1024 flops per weight byte, above the card's ~295 flop/byte ridge:
// operations (gate/up and down 4.62e10 flops, 0.0467 ms; the lm head 1.34e11,
// 0.1357 ms at 989 TFLOP/s). At eight rows it is bytes: 45.1 MB of int8
// weight, 0.0135 ms at 3.35 TB/s. fp32 on the CUDA cores: 0.690 ms at
// gate/up at 67 TFLOP/s.
//
// Not done yet: the widening does not overlap the tensor cores well; down
// (128 tiles of 128 rows, one round) would take 256-row tiles split in K
// over a cluster; the CUDA-core instance is a plain SIMT tile.
#include "simt_gemm.cuh"
#include "wo_mainloop.cuh"

using ptt::bf16;
using ptt::f16;
namespace hp = ptt::hopper;
namespace wo = ptt::wo;

namespace {

// kernel 20's epilogue from registers: each accumulator row is one weight
// column, so a thread multiplies by two scales, rounds to T and stores
// column pairs (32-bit, full 32-byte sectors a warp); rows past M are
// dropped. Row gid is column n_lo, row gid + 8 column n_lo + 1 (N % 16 == 0:
// both or neither are real); column 8 j + 2 tig + e is x row m0 + 8 j +
// 2 tig + e.
template <typename T>
struct wo_matmul_epilogue {
  static constexpr int kBytesPerRow = 0;
  const float* scale;
  T* out;
  int M, N;
  template <int NR>
  __device__ __forceinline__ void apply(float (&acc)[NR / 2], const wo::Item& it, int wg, int wl, int lane,
                                        unsigned char*) const {
    const int gid = lane >> 2, tig = lane & 3;
    const int n_lo = it.n0 + 64 * wg + 16 * wl + 2 * gid;
    if (n_lo >= N) return;
    const float2 sc = *reinterpret_cast<const float2*>(scale + n_lo);
#pragma unroll
    for (int j = 0; j < NR / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = it.m0 + 8 * j + 2 * tig + e;
        if (m < M)
          *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(m) * N + n_lo) =
              hp::pack2<T>(acc[4 * j + e] * sc.x, acc[4 * j + 2 + e] * sc.y);
      }
    }
  }
};

template <typename T, int BM>
__global__ void __launch_bounds__(wo::kThreads, 1)
wo_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
                       const float* __restrict__ scale, T* __restrict__ out, int M, int K, int N, wo::Plan plan) {
  wo::run<T, BM>(&tm_x, &tm_w, K, plan, wo_matmul_epilogue<T>{scale, out, M, N});
}

template <typename T, int BM>
int launch_wgmma(const void* x, const void* w8, const void* scale, void* out, int M, int K, int N,
                 const wo::Plan& plan, cudaStream_t stream) {
  CUtensorMap tx, tw;
  int err = wo::map_operands<T, BM>(&tx, &tw, x, w8, M, K, N);
  if (err) return err;
  constexpr int kSmem = wo::smem_bytes<BM, wo_matmul_epilogue<T>>();
  static_assert(kSmem <= 227 * 1024, "a block's shared memory");
  auto kernel = wo_matmul_wgmma_kernel<T, BM>;
  err = wo::prepare(kernel, kSmem);
  if (err) return err;
  kernel<<<plan.grid, wo::kThreads, kSmem, stream>>>(tx, tw, static_cast<const float*>(scale), static_cast<T*>(out),
                                                      M, K, N, plan);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_wgmma(const void* x, const void* w8, const void* scale, void* out, int M, int K, int N,
                   cudaStream_t stream) {
  int sms = 0;
  const int err = hp::sm_count(&sms);
  if (err) return err;
  const wo::Plan plan = wo::make_plan(M, N, sms);
  switch (plan.bm) {
    case 8: return launch_wgmma<T, 8>(x, w8, scale, out, M, K, N, plan, stream);
    case 64: return launch_wgmma<T, 64>(x, w8, scale, out, M, K, N, plan, stream);
    case 128: return launch_wgmma<T, 128>(x, w8, scale, out, M, K, N, plan, stream);
    default: return launch_wgmma<T, 256>(x, w8, scale, out, M, K, N, plan, stream);
  }
}

// -- the CUDA-core instance ---------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(ptt::simt::kThreads)
wo_matmul_cuda_core_kernel(const T* __restrict__ x, const int8_t* __restrict__ w8, const float* __restrict__ scale,
                           T* __restrict__ out, int M, int K, int N) {
  using ptt::simt::sub;
  const int m0 = blockIdx.y * ptt::simt::kBM, n0 = blockIdx.x * ptt::simt::kBN;
  // A = x [M, K] (K-major), B = w8 [K, N] read as (n, k) (MN-major)
  const auto load_x = [&](int m, int k) { return ptt::to_f(x[static_cast<size_t>(m) * K + k]); };
  const auto load_w = [&](int n, int k) { return static_cast<float>(w8[static_cast<size_t>(k) * N + n]); };
  float acc[8][8];
  ptt::simt::tile_product<true, false>(acc, load_x, m0, M, load_w, n0, N, K);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + sub(tx, j);
    if (n >= N) continue;
    const float s = scale[n];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + sub(ty, i);
      if (m < M) out[static_cast<size_t>(m) * N + n] = ptt::from_f<T>(acc[i][j] * s);
    }
  }
}

template <typename T>
int launch_cuda_cores(const void* x, const void* w8, const void* scale, void* out, int M, int K, int N,
                      cudaStream_t stream) {
  const dim3 grid((N + ptt::simt::kBN - 1) / ptt::simt::kBN, (M + ptt::simt::kBM - 1) / ptt::simt::kBM);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  wo_matmul_cuda_core_kernel<T><<<grid, ptt::simt::kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w8), static_cast<const float*>(scale), static_cast<T*>(out),
      M, K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// io: ptt::kF32, kBF16 or kF16 (x and out); route 0 the wgmma instance (bf16
// or fp16, K % 8 == 0 and K > 0, N % 16 == 0; x, w8 and scale 16-byte
// aligned), 1 the CUDA-core instance (any type of the three, any M, K, N).
// x [M, K], w8 [K, N] int8, scale [N] fp32, out [M, N], all contiguous.
// Returns cudaErrorInvalidValue for a type, route or shape the route does
// not take.
extern "C" int ptt_wo_matmul(int io, int route, const void* x, const void* w8, const void* scale, void* out, int M,
                             int K, int N, void* stream) {
  if (M < 0 || K < 0 || N < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 0) {
    if (K == 0 || K % 8 || N % 16) return static_cast<int>(cudaErrorInvalidValue);
    switch (io) {
      case ptt::kBF16: return dispatch_wgmma<bf16>(x, w8, scale, out, M, K, N, s);
      case ptt::kF16: return dispatch_wgmma<f16>(x, w8, scale, out, M, K, N, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (route != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (io) {
    case ptt::kF32: return launch_cuda_cores<float>(x, w8, scale, out, M, K, N, s);
    case ptt::kBF16: return launch_cuda_cores<bf16>(x, w8, scale, out, M, K, N, s);
    case ptt::kF16: return launch_cuda_cores<f16>(x, w8, scale, out, M, K, N, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
