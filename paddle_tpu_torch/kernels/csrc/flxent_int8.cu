// Kernel 17's int8 site on Hopper's tensor cores: the forward partials of
// the loss of x [N, H] (bf16 or fp16) against a weight-only int8 lm head
// W [H, V] with one fp32 scale per vocab column, on kernel 20's mainloop.
//
// Replaces: paddle_tpu/kernels/fused_loss.py `_flxent_fwd_kernel` (:261)
// launched by `_make_pallas_quant_fwd` (:464), the forward-only loss of the
// weight-only int8 lm head (`fused_linear_cross_entropy` with
// `weight_scale`; the eval loss of an int8-served Llama). Its route
// (kernels/fused_loss.py `flx_int8_route` "wgmma") takes bf16 / fp16 x with
// W [H, V], H % 8 == 0, V % 16 == 0 and W 16-byte aligned (the TMA maps'
// conditions, kernel 20's); a vocab-major or ragged W runs the mma.sync
// instance (flxent_fwd.cu), fp32 x the CUDA cores (flxent_fp32.cu).
//
// Semantics kept from the Pallas body: the logits are the fp32 products of
// x and the int8 values (each int8 value is exact in bf16 and fp16), each
// multiplied by its column's scale, then columns >= V are NEG_INF (-1e30);
// per row the partials (max, sum of exp over that max, target logit) of
// each 128-column vocab tile go to the [3, ceil(V / 128), N] scratch that
// ptt_flxent_merge reduces in a fixed order, as for the bf16 forward. A
// label equal to ignore_index or outside [0, V) matches no column.
//
// Design. W [H, V] is kernel 20's [K, N] layout, so the tile is kernel 20's
// (csrc/wo_mainloop.cuh): out^T = W^T x^T with the int8 W box widened in
// registers as wgmma's A operand and x streamed K-major by TMA as B, 128
// vocab columns (two consumer warpgroups, m64 each) by up to 256 tokens
// (n256), persistent, on kernel 20's plan. A tile is one partial column.
// The new part is the epilogue: each accumulator row is a vocab column and
// each accumulator column a token, so the reduction runs over rows: scale
// and mask each value; per token the max of the thread's two columns, then
// shfl_xor 4, 8, 16 across the warp's 16 columns, then the 8 warps through
// shared memory (one thread a token takes the max over the warps); then
// the sums of exp (ex2.approx of a fused multiply-add) the same way; the
// one thread that holds a token's label column writes its target logit.
// Shared memory beyond kernel 20's ring: 8 x 256 floats of per-warp values
// and the tile's maxima, target logits and labels, 44 bytes a token (11 KB
// at 256 tokens: 217,168 bytes in all).
//
// Bound on H100: operations. 2 N H V flops (2.15e12 at x [8192, 4096], W
// [4096, 32000]: 2.17 ms at 989 TFLOP/s) against ~200 MB of operands.
#include "flxent_common.cuh"
#include "wo_mainloop.cuh"

using ptt::bf16;
using ptt::f16;
namespace hp = ptt::hopper;
namespace wo = ptt::wo;

namespace {

constexpr float kNegInf = -1e30f;  // the Pallas kernels' NEG_INF
constexpr int kEpiBarrier = 1;     // the consumers' named barrier (0 is __syncthreads)

struct flxent_int8_epilogue {
  // per token: the 8 warps' values, the max, the target logit, the label
  static constexpr int kBytesPerRow = (wo::kConsumerWarps + 3) * 4;
  const int* labels;    // [rows]
  const float* scale;  // [V]
  float* part;         // [3, ceil(V / 128), rows]
  int rows, V;

  template <int NR>
  __device__ __forceinline__ void apply(float (&acc)[NR / 2], const wo::Item& it, int wg, int wl, int lane,
                                        unsigned char* smem) const {
    constexpr float kLog2e = 1.4426950408889634f;
    float* red = reinterpret_cast<float*>(smem);  // [8 warps][NR]
    float* mx_s = red + wo::kConsumerWarps * NR;   // [NR]
    float* tl_s = mx_s + NR;                       // [NR]
    int* lab_s = reinterpret_cast<int*>(tl_s + NR);  // [NR]
    const int t = threadIdx.x, warp = 4 * wg + wl, gid = lane >> 2, tig = lane & 3;
    hp::named_barrier(kEpiBarrier, wo::kConsumers);  // the previous item's readers are done
    if (t < NR) {
      const int row = it.m0 + t;
      lab_s[t] = row < rows ? labels[row] : -1;
      tl_s[t] = 0.f;
    }
    // the logits: times the column's scale, then NEG_INF past V (TMA read zeros there)
    const int c = it.n0 + 64 * wg + 16 * wl + 2 * gid;  // this thread's columns c, c + 1
    const float s0 = c < V ? scale[c] : 0.f, s1 = c + 1 < V ? scale[c + 1] : 0.f;
#pragma unroll
    for (int j = 0; j < NR / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        acc[4 * j + e] = c < V ? acc[4 * j + e] * s0 : kNegInf;
        acc[4 * j + 2 + e] = c + 1 < V ? acc[4 * j + 2 + e] * s1 : kNegInf;
      }
    }
    // per token (8 j + 2 tig + e): the max over the warp's 16 columns
#pragma unroll
    for (int j = 0; j < NR / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float m = fmaxf(acc[4 * j + e], acc[4 * j + 2 + e]);
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 8));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 16));
        if (gid == 0) red[warp * NR + 8 * j + 2 * tig + e] = m;
      }
    }
    hp::named_barrier(kEpiBarrier, wo::kConsumers);
    if (t < NR) {  // over the 8 warps
      float m = red[t];
#pragma unroll
      for (int w = 1; w < wo::kConsumerWarps; ++w) m = fmaxf(m, red[w * NR + t]);
      mx_s[t] = m;
    }
    hp::named_barrier(kEpiBarrier, wo::kConsumers);
    // per token: the sum of exp over the tile max, over the warp's columns;
    // the target logit from the thread that holds the label's column
#pragma unroll
    for (int j = 0; j < NR / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int tok = 8 * j + 2 * tig + e;
        const float v0 = acc[4 * j + e], v1 = acc[4 * j + 2 + e];
        const float ml = mx_s[tok] * kLog2e;
        float s = hp::exp2_approx(fmaf(v0, kLog2e, -ml)) + hp::exp2_approx(fmaf(v1, kLog2e, -ml));
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 8);
        s += __shfl_xor_sync(0xffffffffu, s, 16);
        if (gid == 0) red[warp * NR + tok] = s;
        const int lab = lab_s[tok];
        if (lab == c && c < V) tl_s[tok] = v0;
        if (lab == c + 1 && c + 1 < V) tl_s[tok] = v1;
      }
    }
    hp::named_barrier(kEpiBarrier, wo::kConsumers);
    const int row = it.m0 + t;
    if (t < NR && row < rows) {  // token t's partials: the warps summed in order
      float l = 0.f;
#pragma unroll
      for (int w = 0; w < wo::kConsumerWarps; ++w) l += red[w * NR + t];
      const size_t stride = static_cast<size_t>((V + wo::kBN - 1) / wo::kBN) * rows;
      const size_t at = static_cast<size_t>(it.n0 / wo::kBN) * rows + row;
      part[at] = mx_s[t];
      part[stride + at] = l;
      part[2 * stride + at] = tl_s[t];
    }
  }
};

template <typename T, int BM>
__global__ void __launch_bounds__(wo::kThreads, 1)
flxent_fwd_int8_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
                             const flxent_int8_epilogue epi, int K, wo::Plan plan) {
  wo::run<T, BM>(&tm_x, &tm_w, K, plan, epi);
}

template <typename T, int BM>
int launch(const void* x, const void* w8, const flxent_int8_epilogue& epi, int H, const wo::Plan& plan,
           cudaStream_t stream) {
  CUtensorMap tx, tw;
  int err = wo::map_operands<T, BM>(&tx, &tw, x, w8, epi.rows, H, epi.V);
  if (err) return err;
  constexpr int kSmem = wo::smem_bytes<BM, flxent_int8_epilogue>();
  static_assert(kSmem <= 227 * 1024, "a block's shared memory");
  auto kernel = flxent_fwd_int8_wgmma_kernel<T, BM>;
  err = wo::prepare(kernel, kSmem);
  if (err) return err;
  kernel<<<plan.grid, wo::kThreads, kSmem, stream>>>(tx, tw, epi, H, plan);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* w8, const flxent_int8_epilogue& epi, int H, cudaStream_t stream) {
  int sms = 0;
  const int err = hp::sm_count(&sms);
  if (err) return err;
  const wo::Plan plan = wo::make_plan(epi.rows, epi.V, sms);
  switch (plan.bm) {
    case 8: return launch<T, 8>(x, w8, epi, H, plan, stream);
    case 64: return launch<T, 64>(x, w8, epi, H, plan, stream);
    case 128: return launch<T, 128>(x, w8, epi, H, plan, stream);
    default: return launch<T, 256>(x, w8, epi, H, plan, stream);
  }
}

}  // namespace

namespace ptt {
namespace flx {

int wgmma_fwd_int8(int io, const void* x, const void* w8, const void* wscale, const void* labels, void* part, int N,
                   int H, int V, cudaStream_t s) {
  if (H <= 0 || H % 8 || V % 16 || N <= 0 || V <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const flxent_int8_epilogue epi{static_cast<const int*>(labels), static_cast<const float*>(wscale),
                                 static_cast<float*>(part), N, V};
  switch (io) {
    case kBF16: return dispatch<bf16>(x, w8, epi, H, s);
    case kF16: return dispatch<f16>(x, w8, epi, H, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace flx
}  // namespace ptt
