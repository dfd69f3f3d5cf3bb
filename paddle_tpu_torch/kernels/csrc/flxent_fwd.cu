// Fused linear cross entropy, forward (kernel 17), and the per-chunk
// recompute of D that the backward products (kernels 18, 19) share, on the
// mma.sync mainloop; and the forward's C entry points for every route.
//
// Replaces: paddle_tpu/kernels/fused_loss.py `_flxent_fwd_kernel` (launched
// by `_make_pallas_core`, entry `fused_linear_cross_entropy`), the training
// step's loss head, and `_flxent_block_d`, the recompute of
// D = (softmax - onehot) * gcoef inside its dX and dW kernels. This file's
// instances serve the bf16 / fp16 shapes whose W rows TMA cannot address
// (kernels/fused_loss.py `flx_route` "mma_sync": W [H, V] with V % 8 != 0,
// or W not 16-byte aligned); every other bf16 / fp16 W takes the wgmma
// mainloop (flxent_wgmma.cu), fp32 the TF32 tensor cores (flxent_tf32.cu,
// its own entry point) or the CUDA cores (flxent_fp32.cu).
//
// Forward: for x [N, H] and W ([H, V], or [V, H] vocab-major), per row the
// logsumexp of the logits x W and the target logit, both fp32, without the
// [N, V] logits ever reaching device memory. Semantics kept from the Pallas
// kernel: operands in their own type (bf16 or fp16) with fp32 accumulation;
// columns >= V are NEG_INF (-1e30); a label equal to ignore_index or
// outside [0, V) matches no column, so its target logit is 0.
//
// Design. The Pallas forward walks the vocab sequentially per row block,
// carrying (m, l, tl) in VMEM across grid steps. Blocks here run in
// parallel and in no order, so every (row tile, vocab tile) of 128 x 128
// yields per-row partials (tile max, sum of exp over the tile max, target
// logit) in an fp32 [3, tiles_v, N] scratch (24.6 MB at the train shape),
// whatever the route. Here each tile is its own block: the shared mainloop
// (flxent_common.cuh) computes the logits tile in registers and the
// epilogue reduces it through shared memory. A second kernel, launched by
// its own entry point, merges each row's partials in a fixed order (no
// atomics: the bits repeat): lse = m + log(sum_t l_t exp(m_t - m)),
// tl = sum_t tl_t.
//
// D recompute (backward, one vocab chunk of Vc columns per launch): the same
// logits tile, with an epilogue that writes D = ((exp(logit - lse) - onehot)
// * gcoef) rounded to the input type into a [N, Vc] buffer (the Pallas
// `_flxent_block_d`, rounding included), 0 at columns >= V. Computing D
// once per chunk and feeding both products is what the split of this port
// adds over the Pallas one, which recomputes the logits in each of its two
// backward kernels.
//
// Bound on H100: operations. 2 N H V flops (2.15e12 at N 8192, H 4096,
// V 32000: 2.17 ms at 989 TFLOP/s) against ~330 MB of operands. This
// instance runs mma.sync, not wgmma/TMA: it reaches a fraction of that.
//
// The int8 site (`ptt_flxent_fwd_int8`; replaces the quantized call of the
// same Pallas body, `_make_pallas_quant_fwd`, the weight-only int8 lm head's
// forward-only loss): W is int8 with one fp32 scale per vocab column. This
// file's instance serves a vocab-major or ragged int8 W (`flx_int8_route`
// "mma_sync"; W [H, V] with V % 16 == 0 takes kernel 20's mainloop,
// flxent_int8.cu, fp32 x flxent_tf32.cu or the CUDA cores). Its slabs are staged as int8 and
// upcast to x's type in shared memory before ldmatrix (gemm_tile_i8, for
// the H-major and the vocab-major layout: exact, so the logits tile is x
// times the int8 values in fp32), and each logit is multiplied by its
// column's scale before the cols < V mask and the max / sum / target-logit
// partials, in the Pallas kernel's order. The partials and their merge are
// the bf16 forward's.
#include <type_traits>

#include "flxent_common.cuh"

using ptt::bf16;
using ptt::f16;
namespace fx = ptt::flx;

namespace {

// mode 0: (m, l, tl) partials per (row, vocab tile); mode 1: the D tile.
// TW is W's type: T, or int8_t with the per-column scales `wscale` (mode 0).
template <typename T, typename TW, bool B_K, int MODE>
__global__ void __launch_bounds__(fx::kThreads, 2)
flxent_logits_kernel(fx::Operand<T> X, fx::Operand<TW> W, const float* __restrict__ wscale,
              const int* __restrict__ labels, const float* __restrict__ lse, const float* __restrict__ gcoef,
              int N, int vc, int c0, float* __restrict__ part, T* __restrict__ d, long long ldd) {
  constexpr bool kQuant = std::is_same<TW, int8_t>::value;
  static_assert(!kQuant || MODE == 0, "the int8 head is forward-only");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tiles_m = (N + fx::kBM - 1) / fx::kBM, tiles_n = (vc + fx::kBN - 1) / fx::kBN;
  int tm, tn;
  fx::tile_coords(tiles_m, tiles_n, tm, tn);
  const int m0 = tm * fx::kBM, n0 = tn * fx::kBN;
  float acc[fx::kMT][fx::kNT][4];
  if constexpr (kQuant) {
    fx::gemm_tile_i8<T, B_K>(acc, X, W, m0, n0, smem_raw);
  } else {
    fx::gemm_tile<T, true, B_K>(acc, X, W, m0, n0, reinterpret_cast<T*>(smem_raw));
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / fx::kWarpsN, wn = warp % fx::kWarpsN, gid = lane >> 2, tig = lane & 3;

  if (MODE == 1) {
#pragma unroll
    for (int mt = 0; mt < fx::kMT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * fx::kWM + mt * 16 + gid + 8 * h;
        if (row >= N) continue;
        const float ls = lse[row], g = gcoef[row];
        const int lab = labels[row];
        T* drow = d + static_cast<long long>(row) * ldd;
#pragma unroll
        for (int nt = 0; nt < fx::kNT; ++nt) {
          const int col = n0 + wn * fx::kWN + nt * 8 + 2 * tig;  // within the chunk; even
          alignas(4) T out[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool in = col + e < vc;
            const float p = in ? expf(acc[mt][nt][2 * h + e] - ls) : 0.f;
            const float onehot = (in && c0 + col + e == lab) ? 1.f : 0.f;
            out[e] = ptt::from_f<T>((p - onehot) * g);
          }
          if (col + 1 < vc) {  // ldd is even: a 4-byte aligned pair
            *reinterpret_cast<uint32_t*>(drow + col) = *reinterpret_cast<const uint32_t*>(out);
          } else if (col < vc) {
            drow[col] = out[0];
          }
        }
      }
    }
    return;
  }

  // mode 0: red[q][wn][r] for q = max, sum of exp, target logit; r the row in the tile
  float* red = reinterpret_cast<float*>(smem_raw);
  constexpr int kQ = fx::kWarpsN * fx::kBM;
  int labs[fx::kMT][2];
#pragma unroll
  for (int mt = 0; mt < fx::kMT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm * fx::kWM + mt * 16 + gid + 8 * h;
      labs[mt][h] = m0 + r < N ? labels[m0 + r] - c0 : -1;  // as a column of this launch
      float mx = fx::kNegInf;
#pragma unroll
      for (int nt = 0; nt < fx::kNT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn * fx::kWN + nt * 8 + 2 * tig + e;
          float& v = acc[mt][nt][2 * h + e];
          if constexpr (kQuant) {  // dequant factors out of the contraction: scale the logit
            if (col < vc) v *= wscale[col];
          }
          if (col >= vc) v = fx::kNegInf;
          mx = fmaxf(mx, v);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      if (tig == 0) red[wn * fx::kBM + r] = mx;
    }
  }
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < fx::kMT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm * fx::kWM + mt * 16 + gid + 8 * h;
      float m = red[r];
#pragma unroll
      for (int w = 1; w < fx::kWarpsN; ++w) m = fmaxf(m, red[w * fx::kBM + r]);
      float s = 0.f, t = 0.f;
#pragma unroll
      for (int nt = 0; nt < fx::kNT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn * fx::kWN + nt * 8 + 2 * tig + e;
          const float v = acc[mt][nt][2 * h + e];
          s += expf(v - m);
          if (col < vc && col == labs[mt][h]) t += v;
        }
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      t += __shfl_xor_sync(0xffffffffu, t, 1);
      t += __shfl_xor_sync(0xffffffffu, t, 2);
      if (tig == 0) {
        red[kQ + wn * fx::kBM + r] = s;
        red[2 * kQ + wn * fx::kBM + r] = t;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < fx::kBM) {
    const int r = threadIdx.x, row = m0 + r;
    if (row < N) {
      float m = red[r], l = 0.f, t = 0.f;
#pragma unroll
      for (int w = 1; w < fx::kWarpsN; ++w) m = fmaxf(m, red[w * fx::kBM + r]);
#pragma unroll
      for (int w = 0; w < fx::kWarpsN; ++w) {
        // each warp column's sum was taken over the tile max m: no rescale
        l += red[kQ + w * fx::kBM + r];
        t += red[2 * kQ + w * fx::kBM + r];
      }
      const size_t stride = static_cast<size_t>(tiles_n) * N;
      part[static_cast<size_t>(tn) * N + row] = m;
      part[stride + static_cast<size_t>(tn) * N + row] = l;
      part[2 * stride + static_cast<size_t>(tn) * N + row] = t;
    }
  }
}

// per row: merge the vocab tiles' partials in tile order
__global__ void flxent_merge_kernel(const float* __restrict__ part, int tiles_n, int N, float* __restrict__ lse,
                             float* __restrict__ tl) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  const size_t stride = static_cast<size_t>(tiles_n) * N;
  float m = fx::kNegInf;
  for (int t = 0; t < tiles_n; ++t) m = fmaxf(m, part[static_cast<size_t>(t) * N + row]);
  float l = 0.f, s = 0.f;
  for (int t = 0; t < tiles_n; ++t) {
    const size_t i = static_cast<size_t>(t) * N + row;
    l += part[stride + i] * expf(part[i] - m);
    s += part[2 * stride + i];
  }
  lse[row] = m + logf(l);
  tl[row] = s;
}

template <typename T, typename TW, bool B_K, int MODE>
int launch_logits(const void* x, fx::Operand<TW> w, const float* wscale, const void* labels, const void* lse,
                  const void* gcoef, int N, int H, int vc, int c0, void* part, void* d, long long ldd,
                  cudaStream_t stream) {
  auto kernel = flxent_logits_kernel<T, TW, B_K, MODE>;
  cudaError_t err = fx::allow_smem(kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = ((N + fx::kBM - 1) / fx::kBM) * ((vc + fx::kBN - 1) / fx::kBN);
  kernel<<<tiles, fx::kThreads, fx::kSmemBytes, stream>>>(
      fx::operand<T>(x, H, N, H), w, wscale, static_cast<const int*>(labels), static_cast<const float*>(lse),
      static_cast<const float*>(gcoef), N, vc, c0, static_cast<float*>(part), static_cast<T*>(d), ldd);
  return static_cast<int>(cudaGetLastError());
}

// The vocab columns [c0, c0 + vc) of W as the B operand of x W (k = H).
template <typename TW>
fx::Operand<TW> w_columns(const void* w, int vocab_major, int H, int V, int c0, int vc) {
  const TW* p = static_cast<const TW*>(w);
  return vocab_major ? fx::operand<TW>(p + static_cast<long long>(c0) * H, H, vc, H)   // [n][k]
                     : fx::operand<TW>(p + c0, V, vc, H);                              // [k][n]
}

template <typename T>
int fwd(int vocab_major, const void* x, const void* w, const void* labels, void* part, int N, int H, int V,
        cudaStream_t stream) {
  const fx::Operand<T> wo = w_columns<T>(w, vocab_major, H, V, 0, V);
  return vocab_major
      ? launch_logits<T, T, true, 0>(x, wo, nullptr, labels, nullptr, nullptr, N, H, V, 0, part, nullptr, 0, stream)
      : launch_logits<T, T, false, 0>(x, wo, nullptr, labels, nullptr, nullptr, N, H, V, 0, part, nullptr, 0, stream);
}

template <typename T>
int fwd_int8(int vocab_major, const void* x, const void* w8, const void* wscale, const void* labels, void* part,
             int N, int H, int V, cudaStream_t stream) {
  const fx::Operand<int8_t> wo = w_columns<int8_t>(w8, vocab_major, H, V, 0, V);
  const float* s = static_cast<const float*>(wscale);
  return vocab_major
      ? launch_logits<T, int8_t, true, 0>(x, wo, s, labels, nullptr, nullptr, N, H, V, 0, part, nullptr, 0, stream)
      : launch_logits<T, int8_t, false, 0>(x, wo, s, labels, nullptr, nullptr, N, H, V, 0, part, nullptr, 0, stream);
}

template <typename T>
int dchunk(int vocab_major, const void* x, const void* w, const void* labels, const void* lse,
           const void* gcoef, void* d, long long ldd, int N, int H, int V, int c0, int vc,
           cudaStream_t stream) {
  const fx::Operand<T> wo = w_columns<T>(w, vocab_major, H, V, c0, vc);
  return vocab_major
      ? launch_logits<T, T, true, 1>(x, wo, nullptr, labels, lse, gcoef, N, H, vc, c0, nullptr, d, ldd, stream)
      : launch_logits<T, T, false, 1>(x, wo, nullptr, labels, lse, gcoef, N, H, vc, c0, nullptr, d, ldd, stream);
}

}  // namespace

// The forward's partials on the instance `route` names (ptt::flx::Route:
// kWgmma for bf16 / fp16 that TMA can map, kMmaSync for bf16 / fp16,
// kCudaCores for fp32 that flxent_tf32.cu's ptt_flxent_tf32_fwd does not
// take); x and w alike. x: [N, H], H % 8 == 0, 16-byte
// aligned; w: [H, V] or, with vocab_major, [V, H]; labels: [N] int32;
// part: fp32 [3, ceil(V / 128), N].
extern "C" int ptt_flxent_fwd(int io, int route, int vocab_major, const void* x, const void* w,
                              const void* labels, void* part, int N, int H, int V, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == fx::kWgmma) return fx::wgmma_fwd(io, vocab_major, x, w, labels, part, N, H, V, s);
  if (route == fx::kCudaCores) {
    if (io != ptt::kF32) return static_cast<int>(cudaErrorInvalidValue);
    return fx::f32_fwd(vocab_major, static_cast<const float*>(x), static_cast<const float*>(w),
                       static_cast<const int*>(labels), static_cast<float*>(part), N, H, V, s);
  }
  if (route != fx::kMmaSync) return static_cast<int>(cudaErrorInvalidValue);
  switch (io) {
    case ptt::kBF16: return fwd<bf16>(vocab_major, x, w, labels, part, N, H, V, s);
    case ptt::kF16: return fwd<f16>(vocab_major, x, w, labels, part, N, H, V, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The int8 head's partials: as ptt_flxent_fwd with w8 int8 ([H, V] or, with
// vocab_major, [V, H]) and wscale fp32 [V]; io is x's type; `route` as
// kernels/fused_loss.py `flx_int8_route` names it (kWgmma: bf16 / fp16,
// W [H, V], V % 16 == 0, on kernel 20's mainloop; kMmaSync: bf16 / fp16;
// kCudaCores: fp32 that ptt_flxent_tf32_fwd does not take).
extern "C" int ptt_flxent_fwd_int8(int io, int route, int vocab_major, const void* x, const void* w8,
                                   const void* wscale, const void* labels, void* part, int N, int H, int V,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == fx::kWgmma) {
    if (vocab_major) return static_cast<int>(cudaErrorInvalidValue);
    return fx::wgmma_fwd_int8(io, x, w8, wscale, labels, part, N, H, V, s);
  }
  if (route == fx::kCudaCores) {
    if (io != ptt::kF32) return static_cast<int>(cudaErrorInvalidValue);
    return fx::f32_fwd_int8(vocab_major, static_cast<const float*>(x), static_cast<const int8_t*>(w8),
                            static_cast<const float*>(wscale), static_cast<const int*>(labels),
                            static_cast<float*>(part), N, H, V, s);
  }
  if (route != fx::kMmaSync) return static_cast<int>(cudaErrorInvalidValue);
  switch (io) {
    case ptt::kBF16: return fwd_int8<bf16>(vocab_major, x, w8, wscale, labels, part, N, H, V, s);
    case ptt::kF16: return fwd_int8<f16>(vocab_major, x, w8, wscale, labels, part, N, H, V, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The forward's merge of ptt_flxent_fwd's partials into lse, tl: [N] fp32.
extern "C" int ptt_flxent_merge(const void* part, int tiles_n, int N, void* lse, void* tl, void* stream) {
  flxent_merge_kernel<<<(N + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), tiles_n, N, static_cast<float*>(lse), static_cast<float*>(tl));
  return static_cast<int>(cudaGetLastError());
}

// D of the vocab columns [c0, c0 + vc): d [N, ldd] in x's type (ldd a
// multiple of 8, >= vc), from the forward's lse and the per-row gcoef (fp32
// [N]), on the instance `route` names (ptt::flx::Route: kWgmma for bf16 /
// fp16 that TMA can map, kMmaSync for bf16 / fp16, kCudaCores for fp32).
extern "C" int ptt_flxent_dchunk(int io, int route, int vocab_major, const void* x, const void* w,
                                 const void* labels, const void* lse, const void* gcoef, void* d,
                                 long long ldd, int N, int H, int V, int c0, int vc, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == fx::kWgmma) return fx::wgmma_dchunk(io, vocab_major, x, w, labels, lse, gcoef, d, ldd, N, H, V, c0, vc, s);
  if (route == fx::kCudaCores) {
    if (io != ptt::kF32) return static_cast<int>(cudaErrorInvalidValue);
    return fx::f32_dchunk(vocab_major, static_cast<const float*>(x), static_cast<const float*>(w),
                          static_cast<const int*>(labels), static_cast<const float*>(lse),
                          static_cast<const float*>(gcoef), static_cast<float*>(d), ldd, N, H, V, c0, vc, s);
  }
  if (route != fx::kMmaSync) return static_cast<int>(cudaErrorInvalidValue);
  switch (io) {
    case ptt::kBF16: return dchunk<bf16>(vocab_major, x, w, labels, lse, gcoef, d, ldd, N, H, V, c0, vc, s);
    case ptt::kF16: return dchunk<f16>(vocab_major, x, w, labels, lse, gcoef, d, ldd, N, H, V, c0, vc, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
