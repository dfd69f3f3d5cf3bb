// Token-id gather + embedding row + its RMSNorm, one token row per block:
// emb = table[clip(id, 0, V-1)], y = rms(emb) * w with the weight multiplied
// in fp32 before the downcast; bf16, fp16 or fp32, fp32 math.
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
using ptt::f16;

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
embed_rms_kernel(const int* __restrict__ ids, const T* __restrict__ table,
                 const T* __restrict__ w, T* __restrict__ emb, T* __restrict__ y,
                 int V, int H, float eps) {
  constexpr int N = 16 / sizeof(T);
  __shared__ float scratch[32];
  const int id = min(max(ids[blockIdx.x], 0), V - 1);  // ids clip to [0, V-1]
  const T* row = table + static_cast<size_t>(id) * H;
  const size_t base = static_cast<size_t>(blockIdx.x) * H;
  const int nvec = H / N;
  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const uint4 v = ptt::load16(row, i);
    const T* e = ptt::elems_of<T>(v);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float f = ptt::to_f(e[k]);
      ss += f * f;
    }
    ptt::store16(emb + base, i, v);
  }
  const float rstd = rsqrtf(ptt::block_sum<kThreads>(ss, scratch) / H + eps);
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const uint4 v = ptt::load16(emb + base, i), wv = ptt::load16(w, i);
    uint4 ov;
    const T* e = ptt::elems_of<T>(v);
    const T* we = ptt::elems_of<T>(wv);
    T* oe = ptt::elems_of<T>(ov);
#pragma unroll
    for (int k = 0; k < N; ++k) oe[k] = ptt::from_f<T>(ptt::to_f(e[k]) * rstd * ptt::to_f(we[k]));
    ptt::store16(y + base, i, ov);
  }
}

template <typename T>
int launch(const void* ids, const void* table, const void* w, void* emb, void* y, int rows, int V,
           int H, float eps, cudaStream_t stream) {
  embed_rms_kernel<T><<<rows, kThreads, 0, stream>>>(
      static_cast<const int*>(ids), static_cast<const T*>(table), static_cast<const T*>(w),
      static_cast<T*>(emb), static_cast<T*>(y), V, H, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// io: ptt::IoType of table, w, emb and y. ids: [rows] int32; table: [V, H];
// w: [H]; emb, y: [rows, H]. H * sizeof(T) % 16 == 0, 16-byte aligned rows.
extern "C" int ptt_embed_rms(int io, const void* ids, const void* table, const void* w, void* emb,
                             void* y, int rows, int V, int H, float eps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (io) {
    case ptt::kBF16: return launch<bf16>(ids, table, w, emb, y, rows, V, H, eps, s);
    case ptt::kF16: return launch<f16>(ids, table, w, emb, y, rows, V, H, eps, s);
    case ptt::kF32: return launch<float>(ids, table, w, emb, y, rows, V, H, eps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
