// Residual add + RMSNorm for one token row per block: r = x + res (in bf16),
// y = rms(r) * w with the weight multiplied in fp32 before the downcast.
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

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
rms_residual_kernel(const bf16* __restrict__ x, const bf16* __restrict__ res,
                    const bf16* __restrict__ w, bf16* __restrict__ y,
                    bf16* __restrict__ r, int H, float eps) {
  __shared__ float scratch[32];
  const size_t base = static_cast<size_t>(blockIdx.x) * H;
  const int nvec = H / 8;
  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    uint4 xv = ptt::load8(x + base, i), rv = ptt::load8(res + base, i), ov;
    const bf16* xe = ptt::elems(xv);
    const bf16* re = ptt::elems(rv);
    bf16* oe = ptt::elems(ov);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      // the residual add happens in the I/O dtype, as the Pallas kernel's does
      oe[e] = ptt::to_bf(ptt::to_f(xe[e]) + ptt::to_f(re[e]));
      const float f = ptt::to_f(oe[e]);
      ss += f * f;
    }
    ptt::store8(r + base, i, ov);
  }
  const float rstd = rsqrtf(ptt::block_sum<kThreads>(ss, scratch) / H + eps);
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    uint4 rv = ptt::load8(r + base, i), wv = ptt::load8(w, i), ov;
    const bf16* re = ptt::elems(rv);
    const bf16* we = ptt::elems(wv);
    bf16* oe = ptt::elems(ov);
#pragma unroll
    for (int e = 0; e < 8; ++e) oe[e] = ptt::to_bf(ptt::to_f(re[e]) * rstd * ptt::to_f(we[e]));
    ptt::store8(y + base, i, ov);
  }
}

}  // namespace

// x, res, y, r: [rows, H] bf16; w: [H] bf16. H % 8 == 0, 16-byte aligned rows.
extern "C" int ptt_rms_residual_bf16(const void* x, const void* res, const void* w, void* y,
                                     void* r, int rows, int H, float eps, void* stream) {
  rms_residual_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(res), static_cast<const bf16*>(w),
      static_cast<bf16*>(y), static_cast<bf16*>(r), H, eps);
  return static_cast<int>(cudaGetLastError());
}
