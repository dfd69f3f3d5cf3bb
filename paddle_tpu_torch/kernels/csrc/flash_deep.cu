// The flash-attention kernels 14 (forward), 15 (dq) and 16 (dk/dv) at head
// dims above 512 in fp32: one instance each whose head dim D is a runtime
// multiple of 64. They compute what flash_fwd.cu, flash_bwd_dq.cu and
// flash_bwd_dkv.cu compute (see there for the semantics kept from the
// Pallas kernels); fp32 up to 512 runs flash_fp32.cu's instances, and bf16
// and fp16 run on the tensor cores at every head dim (flash_fwd.cu and
// friends to 256, flash_fwd_wide.cu and flash_bwd_wide.cu above).
//
// Replaces: paddle_tpu/kernels/flash_attention.py `_fwd_kernel`,
// `_bwd_dq_kernel` and `_bwd_dkv_kernel` for fp32 inputs at head dims above
// 512.
//
// Design (simple first; speed above 512 is not worked on). flash_fp32.cu's
// CUDA-core walks (the same tiles, tile classes and lane roles: forward and
// dq a block of 16 query rows over 32-key tiles, dk/dv a block of 16 keys
// over 32-row query tiles), with two changes that let D grow without bound:
// - the output's columns (out, dq, or dk and dv) go over ceil(D / 256)
//   blocks (a grid axis), each owning at most 256 of them in whole
//   64-column units, so a lane's accumulators stay at most 8 a row (dk/dv:
//   2 x 4 x 8), as at D 256;
// - each block sums the scores (and dP) over all of D, staging q, k (and g,
//   v) 64 columns at a time, then stages the rows of its own columns that
//   the product with p (or dS) needs.
// The kernels are written for a stored type T widened to fp32 as it is
// staged (fp32 is the one instantiated); the math is fp32. The forward's
// first column block writes lse.
//
// Bound on H100: operations, at fp32's 67 TFLOP/s; these walks do one
// FMA per shared-memory load and redo the scores in every column block.
#include "flash_common.cuh"

namespace fl = ptt::flash;

namespace {

constexpr int kThreads = 128;             // 4 warps
constexpr int kRowsPerWarp = 4;
constexpr int kQRows = 4 * kRowsPerWarp;  // forward / dq: query rows per block
constexpr int kKeys = 32;                 // forward / dq: keys per tile
constexpr int kDkvKeys = 16;              // dk/dv: keys per block (4 per warp)
constexpr int kDkvRows = 32;              // dk/dv: query rows per tile
constexpr int kDC = 64;                   // columns staged at a time for the scores
constexpr int kLdC = kDC + 1;             // padded: lane j reads row j
constexpr int kDO = 256;                  // output columns a block at most
constexpr int kDD = kDO / 32;             // a lane's output columns a row

__host__ __device__ inline void deep_columns(int D, int* split, int* cols) {
  *split = (D + kDO - 1) / kDO;
  *cols = 64 * ((D / 64 + *split - 1) / *split);
}

// columns [c0, c0 + n) of rows [r0, r0 + R) of a [S][stride] tensor of T
// into fp32 s[R][ld] (0 past S or past n, up to `width` columns)
template <int R, typename T>
__device__ __forceinline__ void stage_cols(float* s, int ld, int width, const T* src, size_t stride, int r0, int S,
                                           int c0, int n) {
  for (int i = threadIdx.x; i < R * width; i += kThreads) {
    const int r = i / width, c = i - r * width;
    s[r * ld + c] = (r0 + r < S && c < n) ? ptt::to_f(src[(r0 + r) * stride + c0 + c]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel_deep(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const int* __restrict__ bounds, T* __restrict__ out, float* __restrict__ lse, int Sq, int Sk,
                      int H, int HK, int D, int Hm, int C, int causal, float scale) {
  extern __shared__ float smf[];
  float* q_s = smf;                   // [kQRows][kDC]
  float* k_s = q_s + kQRows * kDC;    // [kKeys][kLdC]
  float* v_s = k_s + kKeys * kLdC;    // [kKeys][kDO]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int split, cols;
  deep_columns(D, &split, &cols);
  const int n_qt = (Sq + kQRows - 1) / kQRows;
  const int x = static_cast<int>(blockIdx.x) / split, slice = static_cast<int>(blockIdx.x) % split;
  const int qt = causal ? n_qt - 1 - x : x;
  const int col0 = slice * cols, cols_here = min(cols, D - col0);
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / HK);
  const int r0 = qt * kQRows;
  const size_t q_stride = static_cast<size_t>(H) * D, kv_stride = static_cast<size_t>(HK) * D;
  const T* qb = q + (static_cast<size_t>(b) * Sq * H + h) * D;
  const T* kb = k + (static_cast<size_t>(b) * Sk * HK + hk) * D;
  const T* vb = v + (static_cast<size_t>(b) * Sk * HK + hk) * D;
  const int* bb = C ? bounds + (static_cast<size_t>(b) * Hm + (Hm == 1 ? 0 : h)) * Sk * C : nullptr;

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
    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.f;
    for (int d0 = 0; d0 < D; d0 += kDC) {
      __syncthreads();  // the previous chunk's (and tile's) reads are done
      stage_cols<kQRows>(q_s, kDC, kDC, qb, q_stride, r0, Sq, d0, kDC);
      stage_cols<kKeys>(k_s, kLdC, kDC, kb, kv_stride, c0, Sk, d0, kDC);
      __syncthreads();
      for (int d = 0; d < kDC; ++d) {
        const float kv = k_s[lane * kLdC + d];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) s[i] = fmaf(q_s[(warp * kRowsPerWarp + i) * kDC + d], kv, s[i]);
      }
    }
    stage_cols<kKeys>(v_s, kDO, kDO, vb, kv_stride, c0, Sk, col0, cols_here);  // v_s is not read before this sync
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int row = r0 + warp * kRowsPerWarp + i;
      float xs = s[i] * scale;
      if (cls == fl::kPartial && fl::masked(row, c0 + lane, Sq, Sk, causal, tb.v[0], C)) xs = -fl::kInf;
      float mx = xs;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = m_new == -fl::kInf ? 1.f : expf(m[i] - m_new);
      const float p = m_new == -fl::kInf ? 0.f : expf(xs - m_new);
      m[i] = m_new;
      l[i] = l[i] * alpha + p;
#pragma unroll
      for (int d = 0; d < kDD; ++d) o[i][d] *= alpha;
      for (int j = 0; j < kKeys; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int d = 0; d < kDD; ++d) o[i][d] = fmaf(pj, v_s[j * kDO + lane + 32 * d], o[i][d]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = r0 + warp * kRowsPerWarp + i;
    const float lt = ptt::warp_sum(l[i]);
    if (row >= Sq) continue;
    const bool seen = lt > 0.f;
    T* orow = out + (static_cast<size_t>(b) * Sq + row) * q_stride + static_cast<size_t>(h) * D + col0;
#pragma unroll
    for (int d = 0; d < kDD; ++d)
      if (lane + 32 * d < cols_here) orow[lane + 32 * d] = ptt::from_f<T>(seen ? o[i][d] / lt : 0.f);
    if (lane == 0 && slice == 0) lse[(static_cast<size_t>(b) * H + h) * Sq + row] = seen ? m[i] + logf(lt) : fl::kInf;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel_deep(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                         const int* __restrict__ bounds, const T* __restrict__ g, const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dq, int Sq, int Sk, int H, int HK, int D,
                         int Hm, int C, int causal, float scale) {
  extern __shared__ float smf[];
  float* q_s = smf;                   // [kQRows][kDC]
  float* g_s = q_s + kQRows * kDC;    // [kQRows][kDC]
  float* k_s = g_s + kQRows * kDC;    // [kKeys][kLdC]
  float* v_s = k_s + kKeys * kLdC;    // [kKeys][kLdC]
  float* kc_s = v_s + kKeys * kLdC;   // [kKeys][kDO]: K's columns of this block
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int split, cols;
  deep_columns(D, &split, &cols);
  const int n_qt = (Sq + kQRows - 1) / kQRows;
  const int x = static_cast<int>(blockIdx.x) / split, slice = static_cast<int>(blockIdx.x) % split;
  const int qt = causal ? n_qt - 1 - x : x;
  const int col0 = slice * cols, cols_here = min(cols, D - col0);
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / HK);
  const int r0 = qt * kQRows;
  const size_t q_stride = static_cast<size_t>(H) * D, kv_stride = static_cast<size_t>(HK) * D;
  const T* qb = q + (static_cast<size_t>(b) * Sq * H + h) * D;
  const T* gb = g + (static_cast<size_t>(b) * Sq * H + h) * D;
  const T* kb = k + (static_cast<size_t>(b) * Sk * HK + hk) * D;
  const T* vb = v + (static_cast<size_t>(b) * Sk * HK + hk) * D;
  const int* bb = C ? bounds + (static_cast<size_t>(b) * Hm + (Hm == 1 ? 0 : h)) * Sk * C : nullptr;

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
    float s[kRowsPerWarp], dp[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = dp[i] = 0.f;
    for (int d0 = 0; d0 < D; d0 += kDC) {
      __syncthreads();
      stage_cols<kQRows>(q_s, kDC, kDC, qb, q_stride, r0, Sq, d0, kDC);
      stage_cols<kQRows>(g_s, kDC, kDC, gb, q_stride, r0, Sq, d0, kDC);
      stage_cols<kKeys>(k_s, kLdC, kDC, kb, kv_stride, c0, Sk, d0, kDC);
      stage_cols<kKeys>(v_s, kLdC, kDC, vb, kv_stride, c0, Sk, d0, kDC);
      __syncthreads();
      for (int d = 0; d < kDC; ++d) {
        const float kx = k_s[lane * kLdC + d], vx = v_s[lane * kLdC + d];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          s[i] = fmaf(q_s[(warp * kRowsPerWarp + i) * kDC + d], kx, s[i]);
          dp[i] = fmaf(g_s[(warp * kRowsPerWarp + i) * kDC + d], vx, dp[i]);
        }
      }
    }
    stage_cols<kKeys>(kc_s, kDO, kDO, kb, kv_stride, c0, Sk, col0, cols_here);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int row = r0 + warp * kRowsPerWarp + i;
      const bool off = cls == fl::kPartial && fl::masked(row, c0 + lane, Sq, Sk, causal, tb.v[0], C);
      const float p = off ? 0.f : expf(scale * s[i] - row_lse[i]);
      const float ds = p * (dp[i] - row_dl[i]) * scale;
      for (int j = 0; j < kKeys; ++j) {
        const float dj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
        for (int d = 0; d < kDD; ++d) acc[i][d] = fmaf(dj, kc_s[j * kDO + lane + 32 * d], acc[i][d]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = r0 + warp * kRowsPerWarp + i;
    if (row >= Sq) continue;
    T* drow = dq + (static_cast<size_t>(b) * Sq + row) * q_stride + static_cast<size_t>(h) * D + col0;
#pragma unroll
    for (int d = 0; d < kDD; ++d)
      if (lane + 32 * d < cols_here) drow[lane + 32 * d] = ptt::from_f<T>(acc[i][d]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel_deep(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                          const int* __restrict__ bounds, const T* __restrict__ g, const float* __restrict__ lse,
                          const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk,
                          int H, int HK, int D, int Hm, int C, int causal, float scale) {
  constexpr int kKPW = kDkvKeys / 4;  // keys per warp
  extern __shared__ float smf[];
  float* k_s = smf;                       // [kDkvKeys][kDC]
  float* v_s = k_s + kDkvKeys * kDC;      // [kDkvKeys][kDC]
  float* q_s = v_s + kDkvKeys * kDC;      // [kDkvRows][kLdC]
  float* g_s = q_s + kDkvRows * kLdC;     // [kDkvRows][kLdC]
  float* qc_s = g_s + kDkvRows * kLdC;    // [kDkvRows][kDO]: q's columns of this block
  float* gc_s = qc_s + kDkvRows * kDO;    // [kDkvRows][kDO]: g's
  float* lse_s = gc_s + kDkvRows * kDO;   // [kDkvRows]
  float* dl_s = lse_s + kDkvRows;         // [kDkvRows]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int split, cols;
  deep_columns(D, &split, &cols);
  const int kt = static_cast<int>(blockIdx.x) / split, slice = static_cast<int>(blockIdx.x) % split;
  const int col0 = slice * cols, cols_here = min(cols, D - col0);
  const int hk = blockIdx.y, b = blockIdx.z, G = H / HK;
  const int k0 = kt * kDkvKeys;
  const size_t q_stride = static_cast<size_t>(H) * D, kv_stride = static_cast<size_t>(HK) * D;
  const T* kb = k + (static_cast<size_t>(b) * Sk * HK + hk) * D;
  const T* vb = v + (static_cast<size_t>(b) * Sk * HK + hk) * D;

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
    int kbnd[kKPW][4];
#pragma unroll
    for (int j = 0; j < kKPW; ++j) {
      const int key = k0 + warp * kKPW + j;
#pragma unroll
      for (int xx = 0; xx < 4; ++xx) kbnd[j][xx] = (xx < C && key < Sk) ? bb[static_cast<size_t>(key) * C + xx] : 0;
    }
    for (int qt = lo; qt < n_qt; ++qt) {
      const int q0 = qt * kDkvRows;
      const int cls = fl::warp_tile_class<kDkvKeys>(tb, bb, C, q0, kDkvRows, k0, Sq, Sk, causal, lane);
      if (cls == fl::kSkip) continue;
      float s[kKPW], dp[kKPW];
#pragma unroll
      for (int j = 0; j < kKPW; ++j) s[j] = dp[j] = 0.f;
      for (int d0 = 0; d0 < D; d0 += kDC) {
        __syncthreads();
        stage_cols<kDkvKeys>(k_s, kDC, kDC, kb, kv_stride, k0, Sk, d0, kDC);
        stage_cols<kDkvKeys>(v_s, kDC, kDC, vb, kv_stride, k0, Sk, d0, kDC);
        stage_cols<kDkvRows>(q_s, kLdC, kDC, qb, q_stride, q0, Sq, d0, kDC);
        stage_cols<kDkvRows>(g_s, kLdC, kDC, gb, q_stride, q0, Sq, d0, kDC);
        __syncthreads();
#pragma unroll
        for (int j = 0; j < kKPW; ++j) {
          const int kl = warp * kKPW + j;
          for (int d = 0; d < kDC; ++d) {
            s[j] = fmaf(q_s[lane * kLdC + d], k_s[kl * kDC + d], s[j]);
            dp[j] = fmaf(g_s[lane * kLdC + d], v_s[kl * kDC + d], dp[j]);
          }
        }
      }
      stage_cols<kDkvRows>(qc_s, kDO, kDO, qb, q_stride, q0, Sq, col0, cols_here);
      stage_cols<kDkvRows>(gc_s, kDO, kDO, gb, q_stride, q0, Sq, col0, cols_here);
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
        const int key = k0 + warp * kKPW + j;
        const bool off = row >= Sq || key >= Sk ||
                         (cls == fl::kPartial && fl::masked(row, key, Sq, Sk, causal, kbnd[j], C));
        const float p = off ? 0.f : expf(scale * s[j] - lse_s[lane]);
        const float ds = p * (dp[j] - dl_s[lane]) * scale;
        for (int i = 0; i < kDkvRows; ++i) {
          const float pi = __shfl_sync(0xffffffffu, p, i), di = __shfl_sync(0xffffffffu, ds, i);
#pragma unroll
          for (int d = 0; d < kDD; ++d) {
            dva[j][d] = fmaf(pi, gc_s[i * kDO + lane + 32 * d], dva[j][d]);
            dka[j][d] = fmaf(di, qc_s[i * kDO + lane + 32 * d], dka[j][d]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kKPW; ++j) {
    const int key = k0 + warp * kKPW + j;
    if (key >= Sk) continue;
    const size_t at = (static_cast<size_t>(b) * Sk + key) * kv_stride + static_cast<size_t>(hk) * D + col0;
#pragma unroll
    for (int d = 0; d < kDD; ++d) {
      if (lane + 32 * d >= cols_here) continue;
      dk[at + lane + 32 * d] = ptt::from_f<T>(dka[j][d]);
      dv[at + lane + 32 * d] = ptt::from_f<T>(dva[j][d]);
    }
  }
}

// shared-memory bytes of each kernel
constexpr size_t kFwdSmem = (kQRows * kDC + kKeys * kLdC + kKeys * kDO) * sizeof(float);
constexpr size_t kDqSmem = (2 * kQRows * kDC + 2 * kKeys * kLdC + kKeys * kDO) * sizeof(float);
constexpr size_t kDkvSmem =
    (2 * kDkvKeys * kDC + 2 * kDkvRows * kLdC + 2 * kDkvRows * kDO + 2 * kDkvRows) * sizeof(float);

bool deep_dim(int D) { return D > 512 && D % 64 == 0; }

int fwd(const void* q, const void* k, const void* v, const void* bounds, void* out, void* lse, int B, int Sq, int Sk,
        int H, int HK, int D, int Hm, int C, int causal, float scale, void* stream) {
  using T = float;
  if (!deep_dim(D)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_fwd_kernel_deep<T>;
  const int err = ptt::allow_smem(kernel, kFwdSmem);
  if (err) return err;
  int split, cols;
  deep_columns(D, &split, &cols);
  const dim3 grid(((Sq + kQRows - 1) / kQRows) * split, H, B);
  kernel<<<grid, kThreads, kFwdSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const int*>(bounds),
      static_cast<T*>(out), static_cast<float*>(lse), Sq, Sk, H, HK, D, Hm, C, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

int dq(const void* q, const void* k, const void* v, const void* bounds, const void* g, const void* lse,
       const void* delta, void* dq_, int B, int Sq, int Sk, int H, int HK, int D, int Hm, int C, int causal,
       float scale, void* stream) {
  using T = float;
  if (!deep_dim(D)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_bwd_dq_kernel_deep<T>;
  const int err = ptt::allow_smem(kernel, kDqSmem);
  if (err) return err;
  int split, cols;
  deep_columns(D, &split, &cols);
  const dim3 grid(((Sq + kQRows - 1) / kQRows) * split, H, B);
  kernel<<<grid, kThreads, kDqSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const int*>(bounds),
      static_cast<const T*>(g), static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<T*>(dq_),
      Sq, Sk, H, HK, D, Hm, C, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

int dkv(const void* q, const void* k, const void* v, const void* bounds, const void* g, const void* lse,
        const void* delta, void* dk, void* dv, int B, int Sq, int Sk, int H, int HK, int D, int Hm, int C,
        int causal, float scale, void* stream) {
  using T = float;
  if (!deep_dim(D)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_bwd_dkv_kernel_deep<T>;
  const int err = ptt::allow_smem(kernel, kDkvSmem);
  if (err) return err;
  int split, cols;
  deep_columns(D, &split, &cols);
  const dim3 grid(((Sk + kDkvKeys - 1) / kDkvKeys) * split, HK, B);
  kernel<<<grid, kThreads, kDkvSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const int*>(bounds),
      static_cast<const T*>(g), static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), Sq, Sk, H, HK, D, Hm, C, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The entries take the other flash entries' arguments (flash_fp32.cu's
// `_fp32`), with every q/k/v/g/out tensor fp32, at head dims above 512 (the
// scheduler counter goes unused). Another head dim returns
// cudaErrorInvalidValue.
extern "C" int ptt_flash_fwd_deep_fp32(const void* q, const void* k, const void* v, const void* bounds, void* out,
                                       void* lse, void* /*sched: unused*/, int B, int Sq, int Sk, int H, int HK,
                                       int D, int Hm, int C, int causal, float scale, void* stream) {
  return fwd(q, k, v, bounds, out, lse, B, Sq, Sk, H, HK, D, Hm, C, causal, scale, stream);
}

extern "C" int ptt_flash_bwd_dq_deep_fp32(const void* q, const void* k, const void* v, const void* bounds,
                                          const void* g, const void* lse, const void* delta, void* dq_,
                                          void* /*sched: unused*/, int B, int Sq, int Sk, int H, int HK, int D,
                                          int Hm, int C, int causal, float scale, void* stream) {
  return dq(q, k, v, bounds, g, lse, delta, dq_, B, Sq, Sk, H, HK, D, Hm, C, causal, scale, stream);
}

extern "C" int ptt_flash_bwd_dkv_deep_fp32(const void* q, const void* k, const void* v, const void* bounds,
                                           const void* g, const void* lse, const void* delta, void* dk, void* dv,
                                           void* /*sched: unused*/, int B, int Sq, int Sk, int H, int HK, int D,
                                           int Hm, int C, int causal, float scale, void* stream) {
  return dkv(q, k, v, bounds, g, lse, delta, dk, dv, B, Sq, Sk, H, HK, D, Hm, C, causal, scale, stream);
}
