// Fused linear cross entropy, dW (kernel 19): dW[:, chunk] = x^T D for one
// chunk of Vc vocab columns per launch, D = (softmax - onehot) * gcoef
// rounded to the input type (recomputed per chunk). The C entry point takes
// the route: this file's mma.sync instance serves bf16 / fp16 W [H, V] with
// V % 8 != 0 (D from flxent_fwd.cu); every other bf16 / fp16 W runs
// flxent_wgmma.cu, fp32 flxent_fp32.cu.
//
// Replaces: paddle_tpu/kernels/fused_loss.py `_flxent_dw_kernel` (launched
// by `_make_pallas_core`), the lm-head weight gradient of the training
// step's loss head.
//
// Design. The Pallas kernel keeps a [blk_v, H] fp32 accumulator live across
// its sequential row grid. Here a chunk's dW columns are complete after one
// GEMM over all N rows (k = N), so each block of the shared mainloop
// (flxent_common.cuh) owns one 128 x 128 tile of dW, sums over the rows in
// fp32 registers and writes it once, cast to W's type: no partials, no
// atomics. Both operands are read in place with the outer dimension
// contiguous (x^T and D for W [H, V]; D^T and x for W [V, H]), which the
// mainloop's ldmatrix.trans takes as it lies.
//
// Bound on H100: operations. 2 N H V flops, 2.15e12 at the train shape,
// plus the recompute of D (shared with dX).
#include "flxent_common.cuh"

using ptt::bf16;
using ptt::f16;
namespace fx = ptt::flx;

namespace {

template <typename T>
int dw_chunk(int vocab_major, const void* x, const void* d, long long ldd, void* dw, int N, int H, int V,
             int c0, int vc, cudaStream_t stream) {
  auto kernel = fx::flxent_gemm_kernel<T, false, false>;
  const cudaError_t err = fx::allow_smem(kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const fx::Operand<T> xo = fx::operand<T>(x, H, H, N);    // x [k = row][h]
  const fx::Operand<T> dop = fx::operand<T>(d, ldd, vc, N);  // D [k = row][v]
  T* out = static_cast<T*>(dw);
  if (vocab_major) {  // dW[c0 + v][h] = sum_r D[r][v] x[r][h]
    const int tiles = ((vc + fx::kBM - 1) / fx::kBM) * ((H + fx::kBN - 1) / fx::kBN);
    kernel<<<tiles, fx::kThreads, fx::kSmemBytes, stream>>>(
        dop, xo, vc, H, nullptr, out + static_cast<long long>(c0) * H, H, 1, 1);
  } else {            // dW[h][c0 + v] = sum_r x[r][h] D[r][v]
    const int tiles = ((H + fx::kBM - 1) / fx::kBM) * ((vc + fx::kBN - 1) / fx::kBN);
    kernel<<<tiles, fx::kThreads, fx::kSmemBytes, stream>>>(xo, dop, H, vc, nullptr, out + c0, V, 1, 1);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// io: ptt::kBF16, ptt::kF16 or ptt::kF32; route: ptt::flx::Route (as
// ptt_flxent_dchunk's). x: [N, H]; d: [N, ldd] (the chunk's D, vc columns);
// dw: [H, V] or, with vocab_major, [V, H], in W's type: the chunk's columns
// (rows) are written.
extern "C" int ptt_flxent_dw(int io, int route, int vocab_major, const void* x, const void* d, long long ldd,
                             void* dw, int N, int H, int V, int c0, int vc, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == fx::kWgmma) return fx::wgmma_dw(io, vocab_major, x, d, ldd, dw, N, H, V, c0, vc, s);
  if (route == fx::kCudaCores) {
    if (io != ptt::kF32) return static_cast<int>(cudaErrorInvalidValue);
    return fx::f32_dw(vocab_major, static_cast<const float*>(x), static_cast<const float*>(d), ldd,
                      static_cast<float*>(dw), N, H, V, c0, vc, s);
  }
  if (route != fx::kMmaSync) return static_cast<int>(cudaErrorInvalidValue);
  switch (io) {
    case ptt::kBF16: return dw_chunk<bf16>(vocab_major, x, d, ldd, dw, N, H, V, c0, vc, s);
    case ptt::kF16: return dw_chunk<f16>(vocab_major, x, d, ldd, dw, N, H, V, c0, vc, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
