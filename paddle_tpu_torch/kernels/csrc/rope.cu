// Neox (rotate-half) rotary embedding over [B, S, H, D], bf16, fp16 or fp32, with
// fp32 [S, D] cos/sin tables: the forward and its adjoint.
//
// Replaces: paddle_tpu/kernels/fused.py `_rope_kernel` (forward, launched
// by `_make_rope_runner` for `fused_rope_pallas`) and `_rope_bwd_kernel`
// (the adjoint, `rope_adjoint_pallas`): the rope of q and k in the training
// forward, its recompute and its backward.
//
// With x = [x1, x2] split at D/2 and rot([x1, x2]) = [-x2, x1]:
//   forward  y  = x * cos + rot(x) * sin:    y1 = x1 c1 - x2 s1,  y2 = x2 c2 + x1 s2
//   adjoint  dx = g * cos + unrot(g * sin):  dx1 = g1 c1 + g2 s2, dx2 = g2 c2 - g1 s1
// in fp32 from the fp32 tables, cast once to x's type. Each product and sum
// is rounded on its own (no fused multiply-add), as the separate elementwise
// ops of the plain version round them, so the two agree bit for bit.
//
// Bound on H100: bytes. At the 7B train shape ([2, 4096, 32, 128] bf16)
// each call reads and writes one 67 MB tensor; the 4.2 MB of tables are
// read by all 32 heads of a position and stay in L2.
//
// Design: the native [B, S, H, D] layout (the Pallas launcher moves heads
// next to batch, [B*H, S, D], to suit its blocks: a copy not made here).
// One thread per pair of 16-byte vectors, element j..j+N of the first half
// and the same of the second half of one (b, s, h) row; the table row is
// s = (row / H) % S.
#include "common.cuh"

using ptt::bf16;
using ptt::f16;

namespace {

constexpr int kThreads = 256;

// N consecutive fp32 table values as N / 4 16-byte loads
template <int N>
__device__ __forceinline__ void load_f(float (&dst)[N], const float* __restrict__ src) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(src)[q];
    dst[4 * q] = v.x;
    dst[4 * q + 1] = v.y;
    dst[4 * q + 2] = v.z;
    dst[4 * q + 3] = v.w;
  }
}

template <typename T, bool kAdjoint>
__device__ __forceinline__ void rope_pair(const T* __restrict__ x, const float* __restrict__ cos_t,
                                          const float* __restrict__ sin_t, T* __restrict__ y,
                                          size_t npairs, int S, int H, int D) {
  constexpr int N = 16 / sizeof(T);
  const size_t p = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= npairs) return;
  const int half = D / 2, per_row = half / N;
  const size_t row = p / per_row;
  const int j = static_cast<int>(p % per_row);
  const int s = static_cast<int>((row / H) % S);
  const T* xr = x + row * D;
  T* yr = y + row * D;
  const size_t t0 = static_cast<size_t>(s) * D + j * N;  // 16-byte aligned: D % 16 == 0
  float c1[N], c2[N], s1[N], s2[N];
  load_f<N>(c1, cos_t + t0);
  load_f<N>(c2, cos_t + t0 + half);
  load_f<N>(s1, sin_t + t0);
  load_f<N>(s2, sin_t + t0 + half);
  const uint4 av = ptt::load16(xr, j), bv = ptt::load16(xr + half, j);
  const T* a = ptt::elems_of<T>(av);
  const T* b = ptt::elems_of<T>(bv);
  uint4 ov1, ov2;
  T* o1 = ptt::elems_of<T>(ov1);
  T* o2 = ptt::elems_of<T>(ov2);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float x1 = ptt::to_f(a[k]), x2 = ptt::to_f(b[k]);
    float y1, y2;
    if (kAdjoint) {
      y1 = __fadd_rn(__fmul_rn(x1, c1[k]), __fmul_rn(x2, s2[k]));
      y2 = __fadd_rn(__fmul_rn(x2, c2[k]), -__fmul_rn(x1, s1[k]));
    } else {
      y1 = __fadd_rn(__fmul_rn(x1, c1[k]), __fmul_rn(-x2, s1[k]));
      y2 = __fadd_rn(__fmul_rn(x2, c2[k]), __fmul_rn(x1, s2[k]));
    }
    o1[k] = ptt::from_f<T>(y1);
    o2[k] = ptt::from_f<T>(y2);
  }
  ptt::store16(yr, j, ov1);
  ptt::store16(yr + half, j, ov2);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rope_fwd_kernel(const T* __restrict__ x, const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                T* __restrict__ y, size_t npairs, int S, int H, int D) {
  rope_pair<T, false>(x, cos_t, sin_t, y, npairs, S, H, D);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rope_bwd_kernel(const T* __restrict__ g, const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                T* __restrict__ dx, size_t npairs, int S, int H, int D) {
  rope_pair<T, true>(g, cos_t, sin_t, dx, npairs, S, H, D);
}

template <typename T>
int launch(bool adjoint, const void* x, const void* cos_t, const void* sin_t, void* y, int B, int S,
           int H, int D, cudaStream_t stream) {
  const size_t npairs = static_cast<size_t>(B) * S * H * (D / 2 / (16 / sizeof(T)));
  const size_t blocks = (npairs + kThreads - 1) / kThreads;
  auto kernel = adjoint ? rope_bwd_kernel<T> : rope_fwd_kernel<T>;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<T*>(y), npairs, S, H, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: [B, S, H, D] of the I/O type `io` (ptt::IoType), contiguous;
// cos_t, sin_t: [S, D] fp32. D % 16 == 0, 16-byte aligned. adjoint = 0 for
// the forward (y = rope(x)), 1 for the adjoint (x is the cotangent g).
extern "C" int ptt_rope(int io, int adjoint, const void* x, const void* cos_t, const void* sin_t,
                        void* y, int B, int S, int H, int D, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool adj = adjoint != 0;
  switch (io) {
    case ptt::kBF16: return launch<bf16>(adj, x, cos_t, sin_t, y, B, S, H, D, s);
    case ptt::kF16: return launch<f16>(adj, x, cos_t, sin_t, y, B, S, H, D, s);
    case ptt::kF32: return launch<float>(adj, x, cos_t, sin_t, y, B, S, H, D, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
