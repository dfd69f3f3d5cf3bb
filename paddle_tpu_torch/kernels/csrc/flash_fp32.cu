// The CUDA-core instances of the flash-attention kernels 14 (forward), 15
// (dq) and 16 (dk/dv): the same functions as flash_fwd.cu, flash_bwd_dq.cu
// and flash_bwd_dkv.cu (see there for the semantics kept from the Pallas
// kernels), computed with fp32 FMAs on the CUDA cores, for fp32 q, k, v, g
// at head dims 320 to 512 (up to 256 the fp32 forward runs flash_fwd_tf32.cu
// and dq and dk/dv flash_bwd_tf32.cu, on the tensor cores in three TF32
// passes of split operands). bf16 and fp16 run on the tensor cores at every
// head dim (flash_fwd.cu and friends to 256, flash_fwd_wide.cu and
// flash_bwd_wide.cu above); fp32 above 512 runs flash_deep.cu.
//
// Replaces: paddle_tpu/kernels/flash_attention.py `_fwd_kernel`,
// `_bwd_dq_kernel` and `_bwd_dkv_kernel` for fp32 inputs at head dims 320
// to 512.
//
// Design (simple first). The same tile walks and FlashMask tile classes as
// the bf16/fp16 kernels (flash_common.cuh `warp_tile_class`, computed by
// every warp alike, so the block agrees): SKIP tiles are neither staged nor
// computed, FULL tiles run without the mask. Blocks of 4 warps; every tile
// is staged in fp32 shared memory (the kernels are written for a stored
// type T widened as it is staged; fp32 is the one instantiated).
// - Forward and dq: a block owns 16 query rows (4 per warp) and walks
//   32-key tiles staged in shared memory; lane j computes the logits of
//   column j for the warp's 4 rows (q rows read as shared-memory
//   broadcasts), the softmax statistics are warp reductions, and each lane
//   accumulates D / 32 output columns of each row (p or dS broadcast by
//   shuffles).
// - dk/dv: a block owns 16 keys (4 per warp) and walks 32-row query tiles of
//   each query head of the group; lane i computes row i's logits against the
//   warp's keys, and each lane accumulates D / 32 columns of dk and dv.
// At D 512 the staged tiles take 164 KB (forward: 16 q rows, 32 padded K
// rows, 32 V rows), 197 KB (dq) and 197 KB (dk/dv) of a block's 227 KB, and
// a lane holds 4 x 16 output columns (forward, dq) or 2 x 4 x 16 (dk and
// dv): the limit of these designs; above 512 flash_deep.cu takes over.
//
// Bound on H100: operations, at fp32's 67 TFLOP/s; this version does one
// FMA per shared-memory load and reaches a fraction of it.
#include "flash_common.cuh"

namespace fl = ptt::flash;

namespace {

constexpr int kThreads = 128;        // 4 warps
constexpr int kRowsPerWarp = 4;
constexpr int kQRows = 4 * kRowsPerWarp;  // forward / dq: query rows per block
constexpr int kKeys = 32;                 // forward / dq: keys per tile
constexpr int kDkvKeys = 16;              // dk/dv: keys per block (4 per warp)
constexpr int kDkvRows = 32;              // dk/dv: query rows per tile

// rows [r0, r0 + R) of a [S][stride] tensor of T into fp32 s[R][ld] (0 past S)
template <int R, int D, typename T>
__device__ __forceinline__ void stage(float* s, int ld, const T* src, size_t stride, int r0, int S) {
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D, c = i % D;
    s[r * ld + c] = r0 + r < S ? ptt::to_f(src[(r0 + r) * stride + c]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel_simt(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const int* __restrict__ bounds, T* __restrict__ out, float* __restrict__ lse, int Sq,
                      int Sk, int H, int HK, int Hm, int C, int causal, float scale) {
  constexpr int kLd = D + 1;  // padded: lane j reads row j
  constexpr int kDD = D / 32;
  extern __shared__ float smf[];
  float* q_s = smf;                  // [kQRows][D]
  float* k_s = q_s + kQRows * D;     // [kKeys][kLd]
  float* v_s = k_s + kKeys * kLd;    // [kKeys][D]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_qt = (Sq + kQRows - 1) / kQRows;
  const int qt = causal ? n_qt - 1 - static_cast<int>(blockIdx.x) : static_cast<int>(blockIdx.x);
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / HK);
  const int r0 = qt * kQRows;
  const size_t q_stride = static_cast<size_t>(H) * D, kv_stride = static_cast<size_t>(HK) * D;
  const T* qb = q + (static_cast<size_t>(b) * Sq * H + h) * D;
  const T* kb = k + (static_cast<size_t>(b) * Sk * HK + hk) * D;
  const T* vb = v + (static_cast<size_t>(b) * Sk * HK + hk) * D;
  const int* bb = C ? bounds + (static_cast<size_t>(b) * Hm + (Hm == 1 ? 0 : h)) * Sk * C : nullptr;
  stage<kQRows, D>(q_s, D, qb, q_stride, r0, Sq);

  float o[kRowsPerWarp][kDD], m[kRowsPerWarp], l[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = -fl::kInf, l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < kDD; ++d) o[i][d] = 0.f;
  }
  const int hi = fl::walk_end(qt * kQRows, kQRows, kKeys, Sq, Sk, causal);
  fl::TileBounds<kKeys> tb;
  for (int t = 0; t < hi; ++t) {
    const int c0 = t * kKeys;
    const int cls = fl::warp_tile_class<kKeys>(tb, bb, C, r0, kQRows, c0, Sq, Sk, causal, lane);
    if (cls == fl::kSkip) continue;
    __syncthreads();  // the previous tile's reads are done (and q staged)
    stage<kKeys, D>(k_s, kLd, kb, kv_stride, c0, Sk);
    stage<kKeys, D>(v_s, D, vb, kv_stride, c0, Sk);
    __syncthreads();
    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float kv = k_s[lane * kLd + d];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) s[i] = fmaf(q_s[(warp * kRowsPerWarp + i) * D + d], kv, s[i]);
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int row = r0 + warp * kRowsPerWarp + i;
      float x = s[i] * scale;
      if (cls == fl::kPartial && fl::masked(row, c0 + lane, Sq, Sk, causal, tb.v[0], C)) x = -fl::kInf;
      float mx = x;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = m_new == -fl::kInf ? 1.f : expf(m[i] - m_new);
      const float p = m_new == -fl::kInf ? 0.f : expf(x - m_new);
      m[i] = m_new;
      l[i] = l[i] * alpha + p;  // this lane's column; summed over the warp at the end
#pragma unroll
      for (int d = 0; d < kDD; ++d) o[i][d] *= alpha;
      for (int j = 0; j < kKeys; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int d = 0; d < kDD; ++d) o[i][d] = fmaf(pj, v_s[j * D + lane + 32 * d], o[i][d]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = r0 + warp * kRowsPerWarp + i;
    const float lt = ptt::warp_sum(l[i]);
    if (row >= Sq) continue;
    const bool seen = lt > 0.f;
    T* orow = out + (static_cast<size_t>(b) * Sq + row) * q_stride + static_cast<size_t>(h) * D;
#pragma unroll
    for (int d = 0; d < kDD; ++d) orow[lane + 32 * d] = ptt::from_f<T>(seen ? o[i][d] / lt : 0.f);
    if (lane == 0) lse[(static_cast<size_t>(b) * H + h) * Sq + row] = seen ? m[i] + logf(lt) : fl::kInf;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel_simt(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                         const int* __restrict__ bounds, const T* __restrict__ g, const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dq, int Sq, int Sk, int H, int HK,
                         int Hm, int C, int causal, float scale) {
  constexpr int kLd = D + 1;
  constexpr int kDD = D / 32;
  extern __shared__ float smf[];
  float* q_s = smf;                  // [kQRows][D]
  float* g_s = q_s + kQRows * D;     // [kQRows][D]
  float* k_s = g_s + kQRows * D;     // [kKeys][kLd]
  float* v_s = k_s + kKeys * kLd;    // [kKeys][kLd]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_qt = (Sq + kQRows - 1) / kQRows;
  const int qt = causal ? n_qt - 1 - static_cast<int>(blockIdx.x) : static_cast<int>(blockIdx.x);
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / HK);
  const int r0 = qt * kQRows;
  const size_t q_stride = static_cast<size_t>(H) * D, kv_stride = static_cast<size_t>(HK) * D;
  const T* qb = q + (static_cast<size_t>(b) * Sq * H + h) * D;
  const T* gb = g + (static_cast<size_t>(b) * Sq * H + h) * D;
  const T* kb = k + (static_cast<size_t>(b) * Sk * HK + hk) * D;
  const T* vb = v + (static_cast<size_t>(b) * Sk * HK + hk) * D;
  const int* bb = C ? bounds + (static_cast<size_t>(b) * Hm + (Hm == 1 ? 0 : h)) * Sk * C : nullptr;
  stage<kQRows, D>(q_s, D, qb, q_stride, r0, Sq);
  stage<kQRows, D>(g_s, D, gb, q_stride, r0, Sq);

  float acc[kRowsPerWarp][kDD], row_lse[kRowsPerWarp], row_dl[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = r0 + warp * kRowsPerWarp + i;
    const size_t at = (static_cast<size_t>(b) * H + h) * Sq + row;
    row_lse[i] = row < Sq ? lse[at] : fl::kInf;
    row_dl[i] = row < Sq ? delta[at] : 0.f;
#pragma unroll
    for (int d = 0; d < kDD; ++d) acc[i][d] = 0.f;
  }
  const int hi = fl::walk_end(qt * kQRows, kQRows, kKeys, Sq, Sk, causal);
  fl::TileBounds<kKeys> tb;
  for (int t = 0; t < hi; ++t) {
    const int c0 = t * kKeys;
    const int cls = fl::warp_tile_class<kKeys>(tb, bb, C, r0, kQRows, c0, Sq, Sk, causal, lane);
    if (cls == fl::kSkip) continue;
    __syncthreads();
    stage<kKeys, D>(k_s, kLd, kb, kv_stride, c0, Sk);
    stage<kKeys, D>(v_s, kLd, vb, kv_stride, c0, Sk);
    __syncthreads();
    float s[kRowsPerWarp], dp[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = dp[i] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float kx = k_s[lane * kLd + d], vx = v_s[lane * kLd + d];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        s[i] = fmaf(q_s[(warp * kRowsPerWarp + i) * D + d], kx, s[i]);
        dp[i] = fmaf(g_s[(warp * kRowsPerWarp + i) * D + d], vx, dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int row = r0 + warp * kRowsPerWarp + i;
      const bool off = cls == fl::kPartial && fl::masked(row, c0 + lane, Sq, Sk, causal, tb.v[0], C);
      const float p = off ? 0.f : expf(scale * s[i] - row_lse[i]);
      const float ds = p * (dp[i] - row_dl[i]) * scale;
      for (int j = 0; j < kKeys; ++j) {
        const float dj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
        for (int d = 0; d < kDD; ++d) acc[i][d] = fmaf(dj, k_s[j * kLd + lane + 32 * d], acc[i][d]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = r0 + warp * kRowsPerWarp + i;
    if (row >= Sq) continue;
    T* drow = dq + (static_cast<size_t>(b) * Sq + row) * q_stride + static_cast<size_t>(h) * D;
#pragma unroll
    for (int d = 0; d < kDD; ++d) drow[lane + 32 * d] = ptt::from_f<T>(acc[i][d]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel_simt(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                          const int* __restrict__ bounds, const T* __restrict__ g, const float* __restrict__ lse,
                          const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int Sq,
                          int Sk, int H, int HK, int Hm, int C, int causal, float scale) {
  constexpr int kLd = D + 1;
  constexpr int kDD = D / 32;
  constexpr int kKPW = kDkvKeys / 4;  // keys per warp
  extern __shared__ float smf[];
  float* k_s = smf;                    // [kDkvKeys][D]
  float* v_s = k_s + kDkvKeys * D;     // [kDkvKeys][D]
  float* q_s = v_s + kDkvKeys * D;     // [kDkvRows][kLd]
  float* g_s = q_s + kDkvRows * kLd;   // [kDkvRows][kLd]
  float* lse_s = g_s + kDkvRows * kLd; // [kDkvRows]
  float* dl_s = lse_s + kDkvRows;      // [kDkvRows]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int hk = blockIdx.y, b = blockIdx.z, G = H / HK;
  const int k0 = blockIdx.x * kDkvKeys;
  const size_t q_stride = static_cast<size_t>(H) * D, kv_stride = static_cast<size_t>(HK) * D;
  stage<kDkvKeys, D>(k_s, D, k + (static_cast<size_t>(b) * Sk * HK + hk) * D, kv_stride, k0, Sk);
  stage<kDkvKeys, D>(v_s, D, v + (static_cast<size_t>(b) * Sk * HK + hk) * D, kv_stride, k0, Sk);

  float dka[kKPW][kDD], dva[kKPW][kDD];
#pragma unroll
  for (int j = 0; j < kKPW; ++j)
#pragma unroll
    for (int d = 0; d < kDD; ++d) dka[j][d] = dva[j][d] = 0.f;
  const int n_qt = (Sq + kDkvRows - 1) / kDkvRows;
  int lo = 0;
  if (causal) {
    const int first = k0 - (Sk - Sq);
    lo = first <= 0 ? 0 : first / kDkvRows;
  }
  fl::TileBounds<kDkvKeys> tb;
  for (int gi = 0; gi < G; ++gi) {
    const int h = hk * G + gi;
    const T* qb = q + (static_cast<size_t>(b) * Sq * H + h) * D;
    const T* gb = g + (static_cast<size_t>(b) * Sq * H + h) * D;
    const int* bb = C ? bounds + (static_cast<size_t>(b) * Hm + (Hm == 1 ? 0 : h)) * Sk * C : nullptr;
    int kbnd[kKPW][4];  // the warp's keys' bounds (0 past Sk: masked anyway)
#pragma unroll
    for (int j = 0; j < kKPW; ++j) {
      const int key = k0 + warp * kKPW + j;
#pragma unroll
      for (int x = 0; x < 4; ++x) kbnd[j][x] = (x < C && key < Sk) ? bb[static_cast<size_t>(key) * C + x] : 0;
    }
    for (int qt = lo; qt < n_qt; ++qt) {
      const int q0 = qt * kDkvRows;
      const int cls = fl::warp_tile_class<kDkvKeys>(tb, bb, C, q0, kDkvRows, k0, Sq, Sk, causal, lane);
      if (cls == fl::kSkip) continue;
      __syncthreads();  // the previous tile's reads are done (and K, V staged)
      stage<kDkvRows, D>(q_s, kLd, qb, q_stride, q0, Sq);
      stage<kDkvRows, D>(g_s, kLd, gb, q_stride, q0, Sq);
      for (int i = threadIdx.x; i < kDkvRows; i += kThreads) {
        const bool in = q0 + i < Sq;
        const size_t at = (static_cast<size_t>(b) * H + h) * Sq + q0 + i;
        lse_s[i] = in ? lse[at] : fl::kInf;
        dl_s[i] = in ? delta[at] : 0.f;
      }
      __syncthreads();
      const int row = q0 + lane;
#pragma unroll
      for (int j = 0; j < kKPW; ++j) {
        const int kl = warp * kKPW + j, key = k0 + kl;
        float s = 0.f, dp = 0.f;
        for (int d = 0; d < D; ++d) {
          s = fmaf(q_s[lane * kLd + d], k_s[kl * D + d], s);
          dp = fmaf(g_s[lane * kLd + d], v_s[kl * D + d], dp);
        }
        const bool off = row >= Sq || key >= Sk ||
                         (cls == fl::kPartial && fl::masked(row, key, Sq, Sk, causal, kbnd[j], C));
        const float p = off ? 0.f : expf(scale * s - lse_s[lane]);
        const float ds = p * (dp - dl_s[lane]) * scale;
        for (int i = 0; i < kDkvRows; ++i) {
          const float pi = __shfl_sync(0xffffffffu, p, i), di = __shfl_sync(0xffffffffu, ds, i);
#pragma unroll
          for (int d = 0; d < kDD; ++d) {
            dva[j][d] = fmaf(pi, g_s[i * kLd + lane + 32 * d], dva[j][d]);
            dka[j][d] = fmaf(di, q_s[i * kLd + lane + 32 * d], dka[j][d]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kKPW; ++j) {
    const int key = k0 + warp * kKPW + j;
    if (key >= Sk) continue;
    const size_t at = (static_cast<size_t>(b) * Sk + key) * kv_stride + static_cast<size_t>(hk) * D;
#pragma unroll
    for (int d = 0; d < kDD; ++d) {
      dk[at + lane + 32 * d] = ptt::from_f<T>(dka[j][d]);
      dv[at + lane + 32 * d] = ptt::from_f<T>(dva[j][d]);
    }
  }
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, const void* bounds, void* out, void* lse, int B, int Sq,
               int Sk, int H, int HK, int Hm, int C, int causal, float scale, cudaStream_t stream) {
  const size_t bytes = (kQRows * D + kKeys * (D + 1) + kKeys * D) * sizeof(float);
  auto kernel = flash_fwd_kernel_simt<T, D>;
  const int err = ptt::allow_smem(kernel, bytes);
  if (err) return err;
  const dim3 grid((Sq + kQRows - 1) / kQRows, H, B);
  kernel<<<grid, kThreads, bytes, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                            static_cast<const T*>(v), static_cast<const int*>(bounds),
                                            static_cast<T*>(out), static_cast<float*>(lse), Sq, Sk, H, HK, Hm, C,
                                            causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* bounds, const void* g, const void* lse,
              const void* delta, void* dq, int B, int Sq, int Sk, int H, int HK, int Hm, int C, int causal,
              float scale, cudaStream_t stream) {
  const size_t bytes = (2 * kQRows * D + 2 * kKeys * (D + 1)) * sizeof(float);
  auto kernel = flash_bwd_dq_kernel_simt<T, D>;
  const int err = ptt::allow_smem(kernel, bytes);
  if (err) return err;
  const dim3 grid((Sq + kQRows - 1) / kQRows, H, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(bounds), static_cast<const T*>(g), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), Sq, Sk, H, HK, Hm, C, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* bounds, const void* g, const void* lse,
               const void* delta, void* dk, void* dv, int B, int Sq, int Sk, int H, int HK, int Hm, int C,
               int causal, float scale, cudaStream_t stream) {
  const size_t bytes = (2 * kDkvKeys * D + 2 * kDkvRows * (D + 1) + 2 * kDkvRows) * sizeof(float);
  auto kernel = flash_bwd_dkv_kernel_simt<T, D>;
  const int err = ptt::allow_smem(kernel, bytes);
  if (err) return err;
  const dim3 grid((Sk + kDkvKeys - 1) / kDkvKeys, HK, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(bounds), static_cast<const T*>(g), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, H, HK, Hm, C,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// the instance of head dim D (320 to 512), as LAUNCH(D)
#define PTT_FLASH_SIMT_WIDE_DIMS(LAUNCH)                                       \
  switch (D) {                                                                 \
    case 320: return LAUNCH(320);                                              \
    case 384: return LAUNCH(384);                                              \
    case 448: return LAUNCH(448);                                              \
    case 512: return LAUNCH(512);                                              \
    default: break;                                                            \
  }                                                                            \
  return static_cast<int>(cudaErrorInvalidValue)

int fwd(const void* q, const void* k, const void* v, const void* bounds, void* out, void* lse, int B, int Sq, int Sk,
        int H, int HK, int D, int Hm, int C, int causal, float scale, void* stream) {
#define PTT_FWD(DIM) \
  launch_fwd<float, DIM>(q, k, v, bounds, out, lse, B, Sq, Sk, H, HK, Hm, C, causal, scale, \
                         static_cast<cudaStream_t>(stream))
  PTT_FLASH_SIMT_WIDE_DIMS(PTT_FWD);
#undef PTT_FWD
}

int dq(const void* q, const void* k, const void* v, const void* bounds, const void* g, const void* lse,
       const void* delta, void* dq_, int B, int Sq, int Sk, int H, int HK, int D, int Hm, int C, int causal,
       float scale, void* stream) {
#define PTT_DQ(DIM)                                                                                           \
  launch_dq<float, DIM>(q, k, v, bounds, g, lse, delta, dq_, B, Sq, Sk, H, HK, Hm, C, causal, scale, \
                        static_cast<cudaStream_t>(stream))
  PTT_FLASH_SIMT_WIDE_DIMS(PTT_DQ);
#undef PTT_DQ
}

int dkv(const void* q, const void* k, const void* v, const void* bounds, const void* g, const void* lse,
        const void* delta, void* dk, void* dv, int B, int Sq, int Sk, int H, int HK, int D, int Hm, int C,
        int causal, float scale, void* stream) {
#define PTT_DKV(DIM)                                                                                             \
  launch_dkv<float, DIM>(q, k, v, bounds, g, lse, delta, dk, dv, B, Sq, Sk, H, HK, Hm, C, causal, scale, \
                         static_cast<cudaStream_t>(stream))
  PTT_FLASH_SIMT_WIDE_DIMS(PTT_DKV);
#undef PTT_DKV
}

}  // namespace

// The entries take the bf16/fp16 wgmma entries' arguments (flash_fwd.cu,
// flash_bwd_dq.cu, flash_bwd_dkv.cu) with every q/k/v/g/out tensor fp32, at
// head dims 320 to 512. The blocks here take fixed
// tiles, so the scheduler counter goes unused. Another head dim returns
// cudaErrorInvalidValue.
extern "C" int ptt_flash_fwd_fp32(const void* q, const void* k, const void* v, const void* bounds, void* out,
                                  void* lse, void* /*sched: unused*/, int B, int Sq, int Sk, int H, int HK, int D,
                                  int Hm, int C, int causal, float scale, void* stream) {
  return fwd(q, k, v, bounds, out, lse, B, Sq, Sk, H, HK, D, Hm, C, causal, scale, stream);
}

extern "C" int ptt_flash_bwd_dq_fp32(const void* q, const void* k, const void* v, const void* bounds, const void* g,
                                     const void* lse, const void* delta, void* dq_, void* /*sched: unused*/, int B,
                                     int Sq, int Sk, int H, int HK, int D, int Hm, int C, int causal, float scale,
                                     void* stream) {
  return dq(q, k, v, bounds, g, lse, delta, dq_, B, Sq, Sk, H, HK, D, Hm, C, causal, scale, stream);
}

extern "C" int ptt_flash_bwd_dkv_fp32(const void* q, const void* k, const void* v, const void* bounds, const void* g,
                                      const void* lse, const void* delta, void* dk, void* dv, void* /*sched: unused*/,
                                      int B, int Sq, int Sk, int H, int HK, int D, int Hm, int C, int causal,
                                      float scale, void* stream) {
  return dkv(q, k, v, bounds, g, lse, delta, dk, dv, B, Sq, Sk, H, HK, D, Hm, C, causal, scale, stream);
}
