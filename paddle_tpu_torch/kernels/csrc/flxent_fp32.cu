// Fused linear cross entropy in fp32 on the CUDA cores: kernel 17's
// partials, the D recompute that kernels 18 and 19 share, dX (18) and dW
// (19) for fp32 x and W, and kernel 17's int8 site for fp32 x against an
// int8 W with per-column scales. The partials' merge is ptt_flxent_merge
// (flxent_fwd.cu), as for bf16. These instances run only for a W that
// flxent_tf32.cu's split and widen passes cannot take: an fp32 W not
// 16-byte aligned or [H, V] with V % 4 != 0 (kernels/fused_loss.py
// `flx_route` "cuda_cores"), an int8 W not 16-byte aligned, with rows not a
// multiple of 16 bytes or with H % 4 != 0 (`flx_int8_route` "cuda_cores");
// the others take its TF32 instances.
//
// Replaces: the fp32 instances of paddle_tpu/kernels/fused_loss.py
// `_flxent_fwd_kernel` (:261), `_flxent_block_d` (:302), `_flxent_dx_kernel`
// (:322) and `_flxent_dw_kernel` (:343), launched by `_make_pallas_core`:
// JAX runs its Pallas kernels in fp32 for an fp32 model whose hidden size is
// a multiple of 128 (`fused_linear_cross_entropy` with FLAGS_use_fused_loss,
// the default); and `_flxent_fwd_kernel` launched by `_make_pallas_quant_fwd`
// (:464) with fp32 activations: JAX sends any activation dtype there
// (`_pallas_quant_path`, :621) and upcasts x to fp32 in the body, so an fp32
// model served with weight_only_int8 reaches it from its loss.
//
// Design. One SIMT tile GEMM serves the four products: simt_gemm.cuh's
// mainloop (128 x 128 output tiles of 256 threads, k tiles of 16 summed
// apart; shared with kernel 20's CUDA-core instance, csrc/wo_matmul.cu),
// each operand read in place in either layout (the layouts of
// flxent_common.cuh's table) and zero past its edges; an int8 W is widened
// to fp32 as it is loaded (exact). No TF32. Epilogues: the forward's per-row
// (max, sum of exp, target logit) partials of each 128-column tile (with an
// int8 W each logit first times its column's scale, before the V mask, in
// the Pallas body's order), reduced
// across the 16 threads that share a row by shuffles, into the [3, tiles,
// N] scratch the merge reads; D = (exp(logit - lse) - onehot) * gcoef, 0
// past the chunk; dX added in place into dx chunk after chunk (the first
// overwrites), in a fixed order; dW written once.
//
// Bound on H100: operations at the fp32 rate outside the tensor cores, 67
// TFLOP/s: 2 N H V flops a product over the vocab.
#include <type_traits>

#include "flxent_common.cuh"
#include "simt_gemm.cuh"

namespace {

using ptt::simt::kBM;
using ptt::simt::kBN;
using ptt::simt::kThreads;
using ptt::simt::sub;
constexpr float kNegInf = -1e30f;  // the Pallas kernels' NEG_INF

enum Mode : int { kFwd = 0, kD = 1, kGemm = 2 };

struct Epi {
  const int* labels;  // kFwd, kD: per row
  const float* wscale;  // kFwd with an int8 W: per vocab column
  const float* lse;   // kD
  const float* gcoef;  // kD
  int c0;             // kD: the chunk's first vocab column
  float* out;         // kD: d; kGemm: dx or dW's chunk; kFwd: the partials
  long long ld;       // out's row stride (kD, kGemm)
  int accumulate;     // kGemm: add out's value (dX after its first chunk)
};

// C = A B over one 128 x 128 tile, A [M, K] and B [K, N] (B read as (n, k))
// read in place (element (o, k) at p[o * ld + k] when K-major, else at
// p[k * ld + o]), with the epilogue MODE; B of type TB (fp32, or int8 for
// the int8 head's forward)
template <typename TB, bool A_K, bool B_K, int MODE>
__global__ void __launch_bounds__(kThreads)
flxent_f32_kernel(const float* __restrict__ A, long long lda, const TB* __restrict__ B, long long ldb, int M,
                  int N, int K, Epi e) {
  constexpr bool kQuant = std::is_same<TB, int8_t>::value;
  static_assert(!kQuant || MODE == kFwd, "the int8 head is forward-only");
  const int t = threadIdx.x;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int ty = t >> 4, tx = t & 15;
  const auto load_a = [&](int o, int k) {
    return A[A_K ? static_cast<size_t>(o) * lda + k : static_cast<size_t>(k) * lda + o];
  };
  const auto load_b = [&](int o, int k) {
    return ptt::to_f(B[B_K ? static_cast<size_t>(o) * ldb + k : static_cast<size_t>(k) * ldb + o]);
  };
  float acc[8][8];
  ptt::simt::tile_product<A_K, B_K>(acc, load_a, m0, M, load_b, n0, N, K);

  if (MODE == kFwd) {
    // per row: the tile's max, the sum of exp over it, the target logit;
    // the 16 threads of a row (one tx each) are 16 lanes of one warp
    const size_t stride = static_cast<size_t>(gridDim.x) * M;
    float sc[8];  // the int8 head's column scales (dequant factors out of the contraction)
#pragma unroll
    for (int j = 0; j < 8; ++j) sc[j] = kQuant && n0 + sub(tx, j) < N ? e.wscale[n0 + sub(tx, j)] : 1.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + sub(ty, i);
      const int lab = m < M ? e.labels[m] : -1;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (kQuant) acc[i][j] *= sc[j];
        if (n0 + sub(tx, j) >= N) acc[i][j] = kNegInf;
        mx = fmaxf(mx, acc[i][j]);
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float s = 0.f, tl = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + sub(tx, j);
        s += expf(acc[i][j] - mx);
        if (n < N && n == lab) tl += acc[i][j];
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
        tl += __shfl_xor_sync(0xffffffffu, tl, o);
      }
      if (tx == 0 && m < M) {
        const size_t at = static_cast<size_t>(blockIdx.x) * M + m;
        e.out[at] = mx;
        e.out[stride + at] = s;
        e.out[2 * stride + at] = tl;
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + sub(ty, i);
    if (m >= M) continue;
    float* row = e.out + static_cast<size_t>(m) * e.ld;
    float ls = 0.f, g = 0.f;
    int lab = -1;
    if (MODE == kD) ls = e.lse[m], g = e.gcoef[m], lab = e.labels[m] - e.c0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + sub(tx, j);
      if (n >= N) continue;
      float v = acc[i][j];
      if (MODE == kD) {
        v = (expf(v - ls) - (n == lab ? 1.f : 0.f)) * g;
      } else if (e.accumulate) {
        v += row[n];
      }
      row[n] = v;
    }
  }
}

template <bool A_K, bool B_K, int MODE, typename TB>
int run(const float* a, long long lda, const TB* b, long long ldb, int M, int N, int K, const Epi& e,
        cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  flxent_f32_kernel<TB, A_K, B_K, MODE><<<grid, kThreads, 0, stream>>>(a, lda, b, ldb, M, N, K, e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

namespace ptt {
namespace flx {

int f32_fwd(int vocab_major, const float* x, const float* w, const int* labels, float* part, int N, int H, int V,
            cudaStream_t s) {
  Epi e{};
  e.labels = labels;
  e.out = part;
  return vocab_major ? run<true, true, kFwd>(x, H, w, H, N, V, H, e, s)    // B(v, h) = W[v][h]
                     : run<true, false, kFwd>(x, H, w, V, N, V, H, e, s);  // B(v, h) = W[h][v]
}

int f32_fwd_int8(int vocab_major, const float* x, const int8_t* w8, const float* wscale, const int* labels,
                 float* part, int N, int H, int V, cudaStream_t s) {
  Epi e{};
  e.labels = labels;
  e.wscale = wscale;
  e.out = part;
  return vocab_major ? run<true, true, kFwd>(x, H, w8, H, N, V, H, e, s)    // B(v, h) = W8[v][h]
                     : run<true, false, kFwd>(x, H, w8, V, N, V, H, e, s);  // B(v, h) = W8[h][v]
}

int f32_dchunk(int vocab_major, const float* x, const float* w, const int* labels, const float* lse,
               const float* gcoef, float* d, long long ldd, int N, int H, int V, int c0, int vc, cudaStream_t s) {
  const Epi e{labels, nullptr, lse, gcoef, c0, d, ldd, 0};
  return vocab_major ? run<true, true, kD>(x, H, w + static_cast<size_t>(c0) * H, H, N, vc, H, e, s)
                     : run<true, false, kD>(x, H, w + c0, V, N, vc, H, e, s);
}

int f32_dx(int vocab_major, const float* d, long long ldd, const float* w, float* dx, int N, int H, int V, int c0,
           int vc, int first, cudaStream_t s) {
  const Epi e{nullptr, nullptr, nullptr, nullptr, 0, dx, H, first ? 0 : 1};
  // B(h, v) = W_c^T: [V, H] -> W[c0 + v][h] (MN-major); [H, V] -> W[h][c0 + v] (K-major)
  return vocab_major ? run<true, false, kGemm>(d, ldd, w + static_cast<size_t>(c0) * H, H, N, H, vc, e, s)
                     : run<true, true, kGemm>(d, ldd, w + c0, V, N, H, vc, e, s);
}

int f32_dw(int vocab_major, const float* x, const float* d, long long ldd, float* dw, int N, int H, int V, int c0,
           int vc, cudaStream_t s) {
  if (vocab_major) {  // dW[c0 + v][h] = sum_r D[r][v] x[r][h]
    const Epi e{nullptr, nullptr, nullptr, nullptr, 0, dw + static_cast<size_t>(c0) * H, H, 0};
    return run<false, false, kGemm>(d, ldd, x, H, vc, H, N, e, s);
  }
  const Epi e{nullptr, nullptr, nullptr, nullptr, 0, dw + c0, V, 0};  // dW[h][c0 + v] = sum_r x[r][h] D[r][v]
  return run<false, false, kGemm>(x, H, d, ldd, H, vc, N, e, s);
}

}  // namespace flx
}  // namespace ptt
