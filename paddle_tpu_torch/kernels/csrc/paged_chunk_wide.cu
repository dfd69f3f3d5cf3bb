// Kernels A and 4 at head dims 320, 384, 448 and 512: the instances of
// paged_chunk.cuh with O's columns split over two CTAs (see
// paged_chunk_fused.cu), built in a translation unit of their own so that
// nvcc compiles them beside the head dims up to 256.
#include "paged_chunk.cuh"

namespace ptt::chunk {

template <typename T, typename KV, bool ROPE>
int launch_wide(const void* q, const void* cos_t, const void* sin_t, const void* kc, const void* vc, const void* ks,
                const void* vs, const void* tables, const void* lens, const void* qlens, void* out, int B, int C,
                int HQ, int HKV, int D, int BS, int MBS, int split, int cols, int rows, int ranks, float scale,
                cudaStream_t st) {
#define PTT_LAUNCH(DIM)                                                                                              \
  launch_d<T, KV, DIM, ROPE>(q, cos_t, sin_t, kc, vc, ks, vs, tables, lens, qlens, out, B, C, HQ, HKV, BS, MBS,      \
                             split, cols, rows, ranks, scale, st)
  switch (D) {
    case 320:
      return PTT_LAUNCH(320);
    case 384:
      return PTT_LAUNCH(384);
    case 448:
      return PTT_LAUNCH(448);
    case 512:
      return PTT_LAUNCH(512);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PTT_LAUNCH
}

#define PTT_WIDE(T, KV)                                                                                              \
  template int launch_wide<T, KV, true>(const void*, const void*, const void*, const void*, const void*,             \
                                        const void*, const void*, const void*, const void*, const void*, void*,      \
                                        int, int, int, int, int, int, int, int, int, int, int, float,                \
                                        cudaStream_t);                                                               \
  template int launch_wide<T, KV, false>(const void*, const void*, const void*, const void*, const void*,            \
                                         const void*, const void*, const void*, const void*, const void*,            \
                                         void*, int, int, int, int, int, int, int, int, int, int, int, float,        \
                                         cudaStream_t);
PTT_WIDE(ptt::bf16, ptt::bf16)
PTT_WIDE(ptt::f16, ptt::f16)
PTT_WIDE(float, float)
PTT_WIDE(ptt::bf16, int8_t)
PTT_WIDE(ptt::f16, int8_t)
PTT_WIDE(float, int8_t)
#undef PTT_WIDE

}  // namespace ptt::chunk
