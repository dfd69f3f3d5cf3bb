// Residual add + RMSNorm for one token row per block: r = x + res (in the
// I/O type: bf16, fp16 or fp32), y = rms(r) * w with the weight multiplied
// in fp32 before the downcast.
//
// Replaces: paddle_tpu/kernels/fused.py `_rms_res_fwd_kernel` (launched by
// `fused_rms_norm_residual_pallas`), the decode layer's residual+norm epilogue.
//
// Bound on H100: bytes. Per row it reads x, res (2H bf16) and w, and writes
// y and r (2H bf16) at ~4 flops per element, far below the 295 flop/byte
// ridge. The design moves each byte once: 16-byte vector loads and stores,
// one fp32 block reduction for the mean of squares, and the second pass
// reads back this thread's own r (cache-resident) instead of keeping H
// values in shared memory. One block per row: at the 7B serving shape
// (512 rows x 4096) that is 512 blocks of 256 threads, about 4 per SM.
#include "common.cuh"

using ptt::bf16;
using ptt::f16;

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
rms_residual_kernel(const T* __restrict__ x, const T* __restrict__ res,
                    const T* __restrict__ w, T* __restrict__ y,
                    T* __restrict__ r, int H, float eps) {
  constexpr int N = 16 / sizeof(T);
  __shared__ float scratch[32];
  const size_t base = static_cast<size_t>(blockIdx.x) * H;
  const int nvec = H / N;
  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const uint4 xv = ptt::load16(x + base, i), rv = ptt::load16(res + base, i);
    uint4 ov;
    const T* xe = ptt::elems_of<T>(xv);
    const T* re = ptt::elems_of<T>(rv);
    T* oe = ptt::elems_of<T>(ov);
#pragma unroll
    for (int e = 0; e < N; ++e) {
      // the residual add happens in the I/O type, as the Pallas kernel's does
      oe[e] = ptt::from_f<T>(ptt::to_f(xe[e]) + ptt::to_f(re[e]));
      const float f = ptt::to_f(oe[e]);
      ss += f * f;
    }
    ptt::store16(r + base, i, ov);
  }
  const float rstd = rsqrtf(ptt::block_sum<kThreads>(ss, scratch) / H + eps);
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const uint4 rv = ptt::load16(r + base, i), wv = ptt::load16(w, i);
    uint4 ov;
    const T* re = ptt::elems_of<T>(rv);
    const T* we = ptt::elems_of<T>(wv);
    T* oe = ptt::elems_of<T>(ov);
#pragma unroll
    for (int e = 0; e < N; ++e) oe[e] = ptt::from_f<T>(ptt::to_f(re[e]) * rstd * ptt::to_f(we[e]));
    ptt::store16(y + base, i, ov);
  }
}

template <typename T>
int launch(const void* x, const void* res, const void* w, void* y, void* r, int rows, int H,
           float eps, cudaStream_t stream) {
  rms_residual_kernel<T><<<rows, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), static_cast<const T*>(w),
      static_cast<T*>(y), static_cast<T*>(r), H, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// io: ptt::IoType of every tensor. x, res, y, r: [rows, H]; w: [H].
// H * sizeof(T) % 16 == 0, 16-byte aligned rows.
extern "C" int ptt_rms_residual(int io, const void* x, const void* res, const void* w, void* y,
                                void* r, int rows, int H, float eps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (io) {
    case ptt::kBF16: return launch<bf16>(x, res, w, y, r, rows, H, eps, s);
    case ptt::kF16: return launch<f16>(x, res, w, y, r, rows, H, eps, s);
    case ptt::kF32: return launch<float>(x, res, w, y, r, rows, H, eps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
