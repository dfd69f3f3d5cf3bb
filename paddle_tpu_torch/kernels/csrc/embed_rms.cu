// Token-id gather + embedding row + its RMSNorm, one token row per block:
// emb = table[clip(id, 0, V-1)], y = rms(emb) * w with the weight multiplied
// in fp32 before the downcast.
//
// Replaces: paddle_tpu/kernels/fused.py `_embed_rms_kernel` (launched by
// `fused_embed_rms_norm_pallas`), the serving step's entry.
//
// Bound on H100: bytes. Per token it reads one H-wide table row and w and
// writes emb and y, a few flops per element. On the TPU the scalar-
// prefetched ids steered the BlockSpec onto the row; here each block reads
// its own id and streams the row with 16-byte accesses, so the [N, V]
// one-hot or a separate gather pass never exists. The second pass reads back
// this thread's own emb writes (cache-resident) rather than holding the row.
#include "common.cuh"

using ptt::bf16;

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
embed_rms_kernel(const int* __restrict__ ids, const bf16* __restrict__ table,
                 const bf16* __restrict__ w, bf16* __restrict__ emb, bf16* __restrict__ y,
                 int V, int H, float eps) {
  __shared__ float scratch[32];
  const int id = min(max(ids[blockIdx.x], 0), V - 1);  // ids clip to [0, V-1]
  const bf16* row = table + static_cast<size_t>(id) * H;
  const size_t base = static_cast<size_t>(blockIdx.x) * H;
  const int nvec = H / 8;
  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    uint4 v = ptt::load8(row, i);
    const bf16* e = ptt::elems(v);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float f = ptt::to_f(e[k]);
      ss += f * f;
    }
    ptt::store8(emb + base, i, v);
  }
  const float rstd = rsqrtf(ptt::block_sum<kThreads>(ss, scratch) / H + eps);
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    uint4 v = ptt::load8(emb + base, i), wv = ptt::load8(w, i), ov;
    const bf16* e = ptt::elems(v);
    const bf16* we = ptt::elems(wv);
    bf16* oe = ptt::elems(ov);
#pragma unroll
    for (int k = 0; k < 8; ++k) oe[k] = ptt::to_bf(ptt::to_f(e[k]) * rstd * ptt::to_f(we[k]));
    ptt::store8(y + base, i, ov);
  }
}

}  // namespace

// ids: [rows] int32; table: [V, H] bf16; w: [H] bf16; emb, y: [rows, H] bf16.
// H % 8 == 0 and 16-byte aligned rows.
extern "C" int ptt_embed_rms_bf16(const void* ids, const void* table, const void* w, void* emb,
                                  void* y, int rows, int V, int H, float eps, void* stream) {
  embed_rms_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), static_cast<const bf16*>(table), static_cast<const bf16*>(w),
      static_cast<bf16*>(emb), static_cast<bf16*>(y), V, H, eps);
  return static_cast<int>(cudaGetLastError());
}
