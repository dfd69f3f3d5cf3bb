// Kernels A and 4 at head dims above 512: one instance per (type, pool,
// rope) whose head dim D is a runtime multiple of 64 (see
// paged_chunk_fused.cu for what they compute and the semantics kept; the
// instances up to 512 are paged_chunk.cuh's, unchanged).
//
// Design (simple first; speed above 512 is not worked on). The walk, the
// cluster split of the history and the rank-ordered merge are the
// narrower instances', with two changes that let D grow without bound:
// - O's columns go over ceil(D / 256) CTAs (a grid axis, `split`), each
//   owning `cols`, at most 256 of them in whole 64-column units: the split
//   of paged_attention.py `_chunk_columns`, passed in by `chunk_plan`, so a
//   thread's accumulator stays 128 fp32 as at D 256;
// - q and the K tile are staged in 64-column chunks: every 16-position step
//   sums the scores q k^T over D chunk by chunk (q's chunk re-read, and
//   roped, each time), then stages the CTA's columns of the V tile.
// Every tile is widened to fp32 as it is staged and the products run on the
// CUDA cores (paged_chunk.cuh's fp32 WarpTile), p unrounded: the plain
// version's fp32 math, summed in another order, in every storage type. The
// int8 pool's scales fold as in the narrower instances. Loads are plain
// (no cp.async ring): each step waits on its own staging.
#include <type_traits>

#include "paged_chunk.cuh"

namespace {

constexpr int kDC = 64;                // columns of q and K staged at a time
constexpr int kDOMax = 256;            // O's columns a CTA at most
constexpr int kLdC = kDC + 4;          // staged chunk rows, fp32
constexpr int kLdVD = kDOMax + 4;      // staged V rows, fp32
constexpr int kLdPD = kDOMax + 8;      // merge partial rows, fp32

struct DeepLayout {
  static constexpr size_t kQ = 0;                                                   // q chunk [64][kLdC]
  static constexpr size_t kK = kQ + static_cast<size_t>(kMaxRows) * kLdC * 4;        // K chunk [16][kLdC]
  static constexpr size_t kV = kK + static_cast<size_t>(kTileN) * kLdC * 4;          // V tile [16][kLdVD]
  static constexpr size_t kS = kV + static_cast<size_t>(kTileN) * kLdVD * 4;         // scales [2][16]
  static constexpr size_t kWalk = kS + 2 * kTileN * 4;
  static constexpr size_t kMerge = static_cast<size_t>(kMaxRows) * kLdPD * 4;
  static constexpr size_t kSmem = kWalk > kMerge ? kWalk : kMerge;
};

template <typename T, typename KV, bool ROPE>
__global__ void __launch_bounds__(kThreads)
paged_chunk_deep_kernel(const T* __restrict__ q, const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                        const KV* __restrict__ kc, const KV* __restrict__ vc, const float* __restrict__ ks,
                        const float* __restrict__ vs, const int* __restrict__ tables, const int* __restrict__ lens,
                        const int* __restrict__ qlens, T* __restrict__ out, int C, int HQ, int HKV, int D, int BS,
                        int MBS, int split, int cols, int ranks, float scale) {
  using W = WarpTile<float, kDC, kDOMax>;
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  constexpr int kRows = kMaxRows, kNT = W::kNT;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float part_m[kRows], part_l[kRows];
  __shared__ float w_s[kRows][kMaxRanks];
  __shared__ float den_s[kRows];
  float* q_s = reinterpret_cast<float*>(smem + DeepLayout::kQ);
  float* k_s = reinterpret_cast<float*>(smem + DeepLayout::kK);
  float* v_s = reinterpret_cast<float*>(smem + DeepLayout::kV);
  float* sc_s = reinterpret_cast<float*>(smem + DeepLayout::kS);
  float* pacc = reinterpret_cast<float*>(smem);
  int* blk_s = reinterpret_cast<int*>(smem + DeepLayout::kSmem);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int G = HQ / HKV;
  const int item = blockIdx.x / ranks;  // (tile, column slice): the cluster's work
  const int row0 = (item / split) * kRows;
  const int col0 = (item % split) * cols;
  const int cols_here = min(cols, D - col0);
  const int rows_here = min(kRows, C * G - row0);
  const int len = lens[b], ql = qlens[b];
  const int half = D / 2;

  auto out_row = [&](int r) -> T* {
    const int pr = row0 + r;
    return out + ((static_cast<size_t>(b) * C + pr / G) * HQ + h * G + pr % G) * D;
  };

  if (row0 / G >= ql) {  // every row is past q_lens (the same in every rank): exact 0, no KV read
    for (int idx = tid; idx < rows_here * cols_here; idx += kThreads) {
      const int r = idx / cols_here;
      if (r % ranks == rank) out_row(r)[col0 + idx % cols_here] = ptt::from_f<T>(0.f);
    }
    return;
  }
  const int j_last = min((row0 + rows_here - 1) / G, ql - 1);
  const int n_pos = len + j_last + 1;
  const int n_blk = (n_pos + BS - 1) / BS;
  const int per = (n_blk + ranks - 1) / ranks;
  const int beg = rank * per * BS;
  const int end = min(beg + per * BS, n_pos);

  if (beg >= end) {
    for (int r = tid; r < kRows; r += kThreads) part_m[r] = kNegInf;
  } else {
    const int blk0 = beg / BS, n_mine_blk = (end - 1) / BS + 1 - blk0;
    const int* table = tables + static_cast<size_t>(b) * MBS + blk0;
    for (int i = tid; i < n_mine_blk; i += kThreads) blk_s[i] = table[i];
    __syncthreads();
    auto pool_row = [&](int p) -> size_t {  // the pool row of position p (beg <= p < end)
      const int rel = p - beg;
      return (static_cast<size_t>(blk_s[rel / BS]) * HKV + h) * BS + rel % BS;
    };

    const int q0 = 16 * warp;
    int lim[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = q0 + gid + 8 * hf, j = (row0 + r) / G;
      lim[hf] = (r < rows_here && j < ql) ? min(len + j + 1, end) : 0;
    }
    int warp_lim = max(lim[0], lim[1]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) warp_lim = max(warp_lim, __shfl_xor_sync(0xffffffffu, warp_lim, o));

    float m_i[2] = {kNegInf, kNegInf}, l_i[2] = {0.f, 0.f};
    float acc[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

    for (int p0 = beg; p0 < end; p0 += kTileN) {
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      for (int c0 = 0; c0 < D; c0 += kDC) {
        const bool last = c0 + kDC >= D;
        __syncthreads();  // every warp is done with the previous chunk (and the previous step's V tile)
        // q's chunk: rows of the tile in q's type (roped when ROPE) as fp32; rows past the tile or q_lens: 0
        for (int i = tid; i < kRows * kDC; i += kThreads) {
          const int r = i / kDC, d = c0 + i % kDC;
          const int pr = row0 + r, j = pr / G;
          float v = 0.f;
          if (r < rows_here && j < ql) {
            const T* qrow = q + ((static_cast<size_t>(b) * C + j) * HQ + h * G + pr % G) * D;
            v = ptt::to_f(qrow[d]);
            if constexpr (ROPE) {
              const float rot = d < half ? -ptt::to_f(qrow[d + half]) : ptt::to_f(qrow[d - half]);
              const size_t trow = (static_cast<size_t>(b) * C + j) * D + d;
              v = ptt::rope_val<T>(v, rot, cos_t[trow], sin_t[trow]);
            }
          }
          q_s[r * kLdC + i % kDC] = v;
        }
        // K's chunk of the step's positions (0 past the rank's range)
        for (int i = tid; i < kTileN * kDC; i += kThreads) {
          const int t = i / kDC, d = c0 + i % kDC;
          k_s[t * kLdC + i % kDC] = p0 + t < end ? ptt::to_f(kc[pool_row(p0 + t) * D + d]) : 0.f;
        }
        if (last) {  // the CTA's columns of V, and the scales
          for (int i = tid; i < kTileN * kDOMax; i += kThreads) {
            const int t = i / kDOMax, c = i % kDOMax;
            v_s[t * kLdVD + c] = p0 + t < end && c < cols_here ? ptt::to_f(vc[pool_row(p0 + t) * D + col0 + c]) : 0.f;
          }
          if constexpr (kQuant) {
            if (tid < 2 * kTileN) {
              const int which = tid / kTileN, t = tid % kTileN;
              sc_s[tid] = p0 + t < end ? (which ? vs : ks)[pool_row(p0 + t)] : 0.f;
            }
          }
        }
        __syncthreads();
        if (p0 < warp_lim) {
          float sc[2][4];
          W::scores(sc, q_s, kLdC, q0, k_s, kLdC);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[nt][e] += sc[nt][e];
        }
      }
      if (p0 >= warp_lim) continue;  // every row of this warp is masked here: an exact no-op
      float pv[2][4];
      W::softmax(s, pv, p0, lim, kQuant ? sc_s : nullptr, kQuant ? sc_s + kTileN : nullptr, scale, m_i, l_i, acc);
      W::pv_acc(acc, pv, v_s, kLdVD);
    }
    __syncthreads();  // every warp is done with the staged tiles: their bytes take the partials

#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      l_i[hf] += __shfl_xor_sync(0xffffffffu, l_i[hf], 1);
      l_i[hf] += __shfl_xor_sync(0xffffffffu, l_i[hf], 2);
      const int r = 16 * warp + gid + 8 * hf;
      if (tig == 0) {
        part_m[r] = m_i[hf];
        part_l[r] = l_i[hf];
      }
      float* prow = pacc + r * kLdPD + 2 * tig;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
        *reinterpret_cast<float2*>(prow + nt * 8) = make_float2(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
    }
  }
  cluster.sync();  // every rank's partials are written

  merge_ranks<T>(cluster, rank, ranks, rows_here, row0, G, ql, part_m, part_l, pacc, kLdPD, cols_here, w_s, den_s,
                 [&](int r) { return out_row(r) + col0; });
  cluster.sync();  // no rank leaves while another still reads its shared memory
}

}  // namespace

namespace ptt::chunk {

template <typename T, typename KV, bool ROPE>
int launch_deep(const void* q, const void* cos_t, const void* sin_t, const void* kc, const void* vc, const void* ks,
                const void* vs, const void* tables, const void* lens, const void* qlens, void* out, int B, int C,
                int HQ, int HKV, int D, int BS, int MBS, int split, int cols, int ranks, float scale,
                cudaStream_t st) {
  if (D <= 512 || D % 64) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = paged_chunk_deep_kernel<T, KV, ROPE>;
  const size_t smem = DeepLayout::kSmem + sizeof(int) * MBS;
  const int err = ptt::allow_smem(kernel, smem);
  if (err) return err;
  if (q == nullptr) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    *static_cast<int*>(out) = max(1, per_sm * sms);
    return 0;
  }
  if (ranks < 1 || ranks > kMaxRanks || cols < 64 || cols % 64 || cols > kDOMax || split < 1 ||
      (split - 1) * cols >= D || split * cols < D)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (C * (HQ / HKV) + kMaxRows - 1) / kMaxRows;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * split * ranks, HKV, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(q), static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<const KV*>(kc), static_cast<const KV*>(vc), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(tables), static_cast<const int*>(lens),
      static_cast<const int*>(qlens), static_cast<T*>(out), C, HQ, HKV, D, BS, MBS, split, cols, ranks, scale);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

#define PTT_DEEP(T, KV)                                                                                              \
  template int launch_deep<T, KV, true>(const void*, const void*, const void*, const void*, const void*,             \
                                        const void*, const void*, const void*, const void*, const void*, void*,      \
                                        int, int, int, int, int, int, int, int, int, int, float,                     \
                                        cudaStream_t);                                                               \
  template int launch_deep<T, KV, false>(const void*, const void*, const void*, const void*, const void*,            \
                                         const void*, const void*, const void*, const void*, const void*,            \
                                         void*, int, int, int, int, int, int, int, int, int, int, float,             \
                                         cudaStream_t);
PTT_DEEP(ptt::bf16, ptt::bf16)
PTT_DEEP(ptt::f16, ptt::f16)
PTT_DEEP(float, float)
PTT_DEEP(ptt::bf16, int8_t)
PTT_DEEP(ptt::f16, int8_t)
PTT_DEEP(float, int8_t)
#undef PTT_DEEP

}  // namespace ptt::chunk
