// Fused linear cross entropy, dX (kernel 18): dX = D W^T over the vocab,
// one chunk of Vc columns per launch, with D = (softmax - onehot) * gcoef
// rounded to the input type (recomputed per chunk). The C entry point takes
// the route: this file's mma.sync instance serves bf16 / fp16 W [H, V] with
// V % 8 != 0 (D from flxent_fwd.cu); every other bf16 / fp16 W runs
// flxent_wgmma.cu, fp32 flxent_fp32.cu.
//
// Replaces: paddle_tpu/kernels/fused_loss.py `_flxent_dx_kernel` (launched
// by `_make_pallas_core`), the x gradient of the training step's loss head.
//
// Design. The Pallas kernel keeps a [rows, H] fp32 accumulator live across
// its sequential vocab grid; at H 4096 a row block's accumulator exceeds a
// Hopper block's shared memory, and blocks here run in no fixed order. So
// the vocab is walked in chunks by the host: each launch is one GEMM,
// [N, Vc] x [Vc, H], on the shared mainloop (flxent_common.cuh), whose
// every block owns one 128 x 128 tile of dX and adds its product to the
// fp32 [N, H] partial (no atomics, the chunk order fixed: the bits repeat);
// the last chunk writes dX in x's type instead. W is read in place in
// either layout ([H, V]: W^T is k-contiguous; [V, H]: n-contiguous).
//
// Bound on H100: operations. 2 N H V flops for the product, 2.15e12 at the
// train shape, plus the recompute of D (another 2 N H V, shared with dW).
#include "flxent_common.cuh"

using ptt::bf16;
using ptt::f16;
namespace fx = ptt::flx;

namespace {

template <typename T>
int dx_chunk(int vocab_major, const void* d, long long ldd, const void* w, void* acc, void* dx, int N,
             int H, int V, int c0, int vc, int first, int last, cudaStream_t stream) {
  const fx::Operand<T> a = fx::operand<T>(d, ldd, N, vc);  // D [N][Vc]: k-contiguous
  const T* wp = static_cast<const T*>(w);
  const int tiles = ((N + fx::kBM - 1) / fx::kBM) * ((H + fx::kBN - 1) / fx::kBN);
  cudaError_t err;
  if (vocab_major) {  // B[k = v][n = h] = W[c0 + v][h]: [k][n]
    auto kernel = fx::flxent_gemm_kernel<T, true, false>;
    err = fx::allow_smem(kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<tiles, fx::kThreads, fx::kSmemBytes, stream>>>(
        a, fx::operand<T>(wp + static_cast<long long>(c0) * H, H, H, vc), N, H,
        static_cast<float*>(acc), static_cast<T*>(dx), H, first, last);
  } else {            // B[k = v][n = h] = W[h][c0 + v]: [n][k]
    auto kernel = fx::flxent_gemm_kernel<T, true, true>;
    err = fx::allow_smem(kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<tiles, fx::kThreads, fx::kSmemBytes, stream>>>(
        a, fx::operand<T>(wp + c0, V, H, vc), N, H, static_cast<float*>(acc), static_cast<T*>(dx), H,
        first, last);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// io: ptt::kBF16, ptt::kF16 or ptt::kF32; route: ptt::flx::Route (as
// ptt_flxent_dchunk's). d: [N, ldd] (the chunk's D, vc columns); w: [H, V]
// or [V, H]; acc: fp32 [N, H] partial (unused when first and last; fp32
// accumulates in dx itself); dx: [N, H] in x's type, complete after the
// launch with last = 1.
extern "C" int ptt_flxent_dx(int io, int route, int vocab_major, const void* d, long long ldd, const void* w,
                             void* acc, void* dx, int N, int H, int V, int c0, int vc, int first,
                             int last, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == fx::kWgmma) return fx::wgmma_dx(io, vocab_major, d, ldd, w, acc, dx, N, H, V, c0, vc, first, last, s);
  if (route == fx::kCudaCores) {
    if (io != ptt::kF32) return static_cast<int>(cudaErrorInvalidValue);
    return fx::f32_dx(vocab_major, static_cast<const float*>(d), ldd, static_cast<const float*>(w),
                      static_cast<float*>(dx), N, H, V, c0, vc, first, s);
  }
  if (route != fx::kMmaSync) return static_cast<int>(cudaErrorInvalidValue);
  switch (io) {
    case ptt::kBF16: return dx_chunk<bf16>(vocab_major, d, ldd, w, acc, dx, N, H, V, c0, vc, first, last, s);
    case ptt::kF16: return dx_chunk<f16>(vocab_major, d, ldd, w, acc, dx, N, H, V, c0, vc, first, last, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
