// Kernels A and 4's device code and launch (see paged_chunk_fused.cu
// for what they compute, the semantics kept and the design). Three
// translation units instantiate it, so that nvcc builds them in parallel:
// paged_chunk_fused.cu the head dims 64 to 256 and the C entries,
// paged_chunk_wide.cu the head dims 320 to 512 (`launch_wide`),
// paged_chunk_deep.cu every head dim above 512 (`launch_deep`).
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"
#include "flxent_common.cuh"

using ptt::bf16;
using ptt::f16;

namespace {

namespace cg = cooperative_groups;
using ptt::flx::cp_async16;
using ptt::flx::cp_async_commit;
using ptt::flx::cp_async_wait;
using ptt::flx::ldsm_x4;
using ptt::flx::ldsm_x4_t;
using ptt::flx::smem_u32;

constexpr int kThreads = 128;      // 4 warps
constexpr int kMaxRows = 64;       // packed query rows per tile: 16 per warp (Geo::kRows)
constexpr int kTileN = 16;         // KV positions per step
constexpr int kMaxRanks = 8;       // CTAs per cluster (the portable limit)
constexpr float kNegInf = -1e30f;  // the Pallas kernel's NEG_INF
constexpr size_t kSmemBudget = 200 * 1024;  // dynamic shared memory beside the static arrays and the table

// 4 bytes from global to shared memory (zero when src_bytes is 0)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes));
}

// (lo, hi) as two values of T in one register, lo in the low half (exact
// for values already representable in T)
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<bf16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<f16>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// N values of T at p (16-byte aligned) as fp32, and back
template <typename T, int N>
__device__ __forceinline__ void load_vals(const T* p, float (&v)[N]) {
  constexpr int kPer = 16 / sizeof(T);
#pragma unroll
  for (int c = 0; c < N / kPer; ++c) {
    const uint4 raw = reinterpret_cast<const uint4*>(p)[c];
    const T* e = ptt::elems_of<T>(raw);
#pragma unroll
    for (int i = 0; i < kPer; ++i) v[c * kPer + i] = ptt::to_f(e[i]);
  }
}
template <typename T, int N>
__device__ __forceinline__ void store_vals(T* p, const float (&v)[N]) {
  constexpr int kPer = 16 / sizeof(T);
#pragma unroll
  for (int c = 0; c < N / kPer; ++c) {
    uint4 raw;
    T* e = ptt::elems_of<T>(raw);
#pragma unroll
    for (int i = 0; i < kPer; ++i) e[i] = ptt::from_f<T>(v[c * kPer + i]);
    reinterpret_cast<uint4*>(p)[c] = raw;
  }
}

// Shared-memory layout of one CTA (bytes): q (kRows rows of all D
// columns), a ring of kStages (K, V) tiles — K of all D columns, V of the
// CTA's kDO — each with, for the int8 pool, its scales; for the int8 pool
// also one (K, V) pair upcast to T. The merge reuses the bytes for the fp32
// partials (kRows rows of kDO columns). The rank's table entries follow at
// kSmem.
template <typename T, typename KV, int D>
struct Geo {
  static constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  static constexpr int kSplit = D > 256 ? 2 : 1;  // CTAs over O's columns (a grid axis)
  static constexpr int kDO = D / kSplit;          // O's columns per CTA: at most 256
  static constexpr int kRows = sizeof(T) == 4 && D > 256 ? 32 : kMaxRows;  // packed query rows per tile
  static constexpr int kLdQ = D + 16 / static_cast<int>(sizeof(T));     // q and the upcast K, elements of T
  static constexpr int kLdU = kDO + 16 / static_cast<int>(sizeof(T));   // the upcast V, elements of T
  static constexpr int kLdK = D + 16 / static_cast<int>(sizeof(KV));    // staged K rows, elements of KV
  static constexpr int kLdV = kDO + 16 / static_cast<int>(sizeof(KV));  // staged V rows (the CTA's columns)
  static constexpr int kLdP = kDO + 8;                                  // partial acc rows, fp32
  static constexpr size_t kTileK = static_cast<size_t>(kTileN) * kLdK * sizeof(KV);
  static constexpr size_t kTileV = static_cast<size_t>(kTileN) * kLdV * sizeof(KV);
  static constexpr size_t kScales = kQuant ? kTileN * sizeof(float) : 0;  // one tile's scales
  static constexpr size_t kStage = kTileK + kTileV + 2 * kScales;         // one ring slot: K, V, their scales
  static constexpr size_t kUpK = kQuant ? static_cast<size_t>(kTileN) * kLdQ * sizeof(T) : 0;
  static constexpr size_t kUpV = kQuant ? static_cast<size_t>(kTileN) * kLdU * sizeof(T) : 0;
  static constexpr size_t kQRow = static_cast<size_t>(kLdQ) * sizeof(T);
  static constexpr size_t kFixed = kRows * kQRow + kUpK + kUpV;
  static constexpr int kStages = kFixed + 3 * kStage <= kSmemBudget ? 3 : 2;  // K/V ring depth
  static constexpr size_t kRing = kRows * kQRow;                   // the ring's offset
  static constexpr size_t kUp = kRing + kStages * kStage;          // the upcast pair's offset
  static constexpr size_t kWalk = kFixed + kStages * kStage;
  static constexpr size_t kMerge = static_cast<size_t>(kRows) * kLdP * sizeof(float);
  static constexpr size_t kSmem = kWalk > kMerge ? kWalk : kMerge;
  static_assert(D % 64 == 0 && D <= 512, "head dim: a multiple of 64, at most 512");
  static_assert(kSmem <= kSmemBudget, "fits beside the static shared arrays");
};

// One warp's part of the walk: its 16 query rows (q_s rows q0 .. q0 + 15)
// against one 16-position tile, the scores over D columns and the
// accumulator over DO. Thread (gid, tig) owns rows gid and gid + 8 and, in
// s / acc, the columns an mma.sync C fragment gives it.
template <typename T, int D, int DO>
struct WarpTile {
  static constexpr bool kMma = !std::is_same<T, float>::value;
  static constexpr int kNT = DO / 8;  // n8 column tiles of the accumulator

  // s = q . k (unscaled) of this warp's rows and the tile's positions:
  // s[nt][e] is row gid + 8 (e / 2), position nt * 8 + 2 tig + e % 2
  static __device__ __forceinline__ void scores(float (&s)[2][4], const T* q_s, int ldq, int q0, const T* kt,
                                                int ld) {
    const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    if constexpr (kMma) {
      const int li = lane >> 3, lr = lane & 7;
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        uint32_t a[4], bk[4];
        ldsm_x4(a, smem_u32(q_s + (q0 + (lane & 15)) * ldq + kk + (lane >> 4) * 8));
        // K [pos][d]: (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15)
        ldsm_x4(bk, smem_u32(kt + (lr + (li >> 1) * 8) * ld + kk + (li & 1) * 8));
        ptt::flx::mma<T>(s[0], a, bk[0], bk[1]);
        ptt::flx::mma<T>(s[1], a, bk[2], bk[3]);
      }
    } else {
      const float* qa = q_s + (q0 + gid) * ldq;
      const float* qb = qa + 8 * ldq;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        const float4 xa = *reinterpret_cast<const float4*>(qa + d);
        const float4 xb = *reinterpret_cast<const float4*>(qb + d);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float4 k4 = *reinterpret_cast<const float4*>(kt + (nt * 8 + 2 * tig + e) * ld + d);
            s[nt][e] += xa.x * k4.x + xa.y * k4.y + xa.z * k4.z + xa.w * k4.w;
            s[nt][2 + e] += xb.x * k4.x + xb.y * k4.y + xb.z * k4.z + xb.w * k4.w;
          }
        }
      }
    }
  }

  // One online-softmax step: the scores times the key scale (int8: kscale,
  // else null) and `scale`, masked to positions p0 + t < lim[row half];
  // m, l and acc rescaled; pv = p (times the value scale vscale, int8).
  static __device__ __forceinline__ void softmax(float (&s)[2][4], float (&pv)[2][4], int p0, const int (&lim)[2],
                                                 const float* kscale, const float* vscale, float scale,
                                                 float (&m)[2], float (&l)[2], float (&acc)[kNT][4]) {
    const int tig = threadIdx.x & 3;
    bool valid[2][4];
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = nt * 8 + 2 * tig + (e & 1), hf = e >> 1;
        float x = s[nt][e];
        if (kscale) x = __fmul_rn(x, kscale[t]);
        x = __fmul_rn(x, scale);
        valid[nt][e] = p0 + t < lim[hf];
        s[nt][e] = valid[nt][e] ? x : kNegInf;
        mx[hf] = fmaxf(mx[hf], s[nt][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
      const float m_new = fmaxf(m[hf], mx[hf]);
      alpha[hf] = expf(m[hf] - m_new);
      m[hf] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1;
        const float p = valid[nt][e] ? expf(s[nt][e] - m[hf]) : 0.f;
        psum[hf] += p;
        pv[nt][e] = vscale ? __fmul_rn(p, vscale[nt * 8 + 2 * tig + (e & 1)]) : p;
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) l[hf] = l[hf] * alpha[hf] + psum[hf];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      acc[nt][0] *= alpha[0];
      acc[nt][1] *= alpha[0];
      acc[nt][2] *= alpha[1];
      acc[nt][3] *= alpha[1];
    }
  }

  // acc += pv . V over the tile's 16 positions (vt: [pos][d], row stride ld)
  static __device__ __forceinline__ void pv_acc(float (&acc)[kNT][4], const float (&pv)[2][4], const T* vt,
                                                int ld) {
    const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
    if constexpr (kMma) {
      // p = p_hi + p_lo, each in T: the A fragments of two k16 products
      float hi[2][4], lo[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          hi[nt][e] = ptt::round_to<T>(pv[nt][e]);
          lo[nt][e] = pv[nt][e] - hi[nt][e];  // exact in fp32
        }
      }
      const uint32_t a_hi[4] = {pack2<T>(hi[0][0], hi[0][1]), pack2<T>(hi[0][2], hi[0][3]),
                                pack2<T>(hi[1][0], hi[1][1]), pack2<T>(hi[1][2], hi[1][3])};
      const uint32_t a_lo[4] = {pack2<T>(lo[0][0], lo[0][1]), pack2<T>(lo[0][2], lo[0][3]),
                                pack2<T>(lo[1][0], lo[1][1]), pack2<T>(lo[1][2], lo[1][3])};
      const int li = lane >> 3, lr = lane & 7;
#pragma unroll
      for (int np = 0; np < DO / 16; ++np) {
        uint32_t r[4];  // V [pos][d]: (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
        ldsm_x4_t(r, smem_u32(vt + (lr + (li & 1) * 8) * ld + np * 16 + (li >> 1) * 8));
        ptt::flx::mma<T>(acc[2 * np], a_hi, r[0], r[1]);
        ptt::flx::mma<T>(acc[2 * np], a_lo, r[0], r[1]);
        ptt::flx::mma<T>(acc[2 * np + 1], a_hi, r[2], r[3]);
        ptt::flx::mma<T>(acc[2 * np + 1], a_lo, r[2], r[3]);
      }
    } else {
      // fp32: position t's p of rows gid / gid + 8 lives in lane 4 gid + (t % 8) / 2
#pragma unroll
      for (int t = 0; t < kTileN; ++t) {
        const int src = gid * 4 + ((t & 7) >> 1);
        const float pa = __shfl_sync(0xffffffffu, pv[t >> 3][t & 1], src);
        const float pb = __shfl_sync(0xffffffffu, pv[t >> 3][2 + (t & 1)], src);
        const float* vrow = vt + t * ld + 2 * tig;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const float2 v2 = *reinterpret_cast<const float2*>(vrow + nt * 8);
          acc[nt][0] += pa * v2.x;
          acc[nt][1] += pa * v2.y;
          acc[nt][2] += pb * v2.x;
          acc[nt][3] += pb * v2.y;
        }
      }
    }
  }
};

// the int8 tile src ([16][ld8] bytes) as T in dst ([16][ldt]), exact; all
// threads of the block take part
template <typename T, int D>
__device__ __forceinline__ void upcast_tile(T* dst, int ldt, const int8_t* src, int ld8) {
  for (int i = threadIdx.x; i < kTileN * (D / 16); i += kThreads) {
    const int t = i / (D / 16), c = (i % (D / 16)) * 16;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + t * ld8 + c);
    const int8_t* e = ptt::elems_of<int8_t>(raw);
    float v[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) v[k] = ptt::to_f(e[k]);
    store_vals<T, 16>(dst + t * ldt + c, v);
  }
}

// The merge, after cluster.sync(): rank `rank` takes rows rank, rank +
// ranks, ... of the tile; each row's partials (part_m, part_l and the pacc
// rows of stride ldp, `cols` columns, in each rank's shared memory) merged in
// rank order, every rank's load issued before any is used, and written
// through out_row(r) (row r of the output at the CTA's first column); rows at
// or past q_lens are written as 0. w_s and den_s: shared scratch.
template <typename T, typename OutRow>
__device__ __forceinline__ void merge_ranks(cg::cluster_group& cluster, int rank, int ranks, int rows_here, int row0,
                                            int G, int ql, float* part_m, float* part_l, float* pacc, int ldp,
                                            int cols, float (*w_s)[kMaxRanks], float* den_s, OutRow out_row) {
  const int tid = threadIdx.x;
  const int n_mine = rank < rows_here ? (rows_here - rank + ranks - 1) / ranks : 0;
  for (int i = tid; i < n_mine; i += kThreads) {
    const int r = rank + i * ranks;
    if ((row0 + r) / G >= ql) continue;  // written as 0 below
    float mk[kMaxRanks], lk[kMaxRanks];
#pragma unroll
    for (int k = 0; k < kMaxRanks; ++k) {
      mk[k] = k < ranks ? *cluster.map_shared_rank(&part_m[r], k) : kNegInf;
      lk[k] = k < ranks ? *cluster.map_shared_rank(&part_l[r], k) : 0.f;
    }
    float M = kNegInf;
#pragma unroll
    for (int k = 0; k < kMaxRanks; ++k) M = fmaxf(M, mk[k]);
    float L = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxRanks; ++k) {
      // a rank without a valid position for this row adds exactly nothing
      const float w = mk[k] > kNegInf ? expf(mk[k] - M) : 0.f;
      w_s[i][k] = w;
      if (w != 0.f) L += w * lk[k];
    }
    den_s[i] = fmaxf(L, 1e-30f);
  }
  __syncthreads();
  const int c4 = cols / 4;
  for (int idx = tid; idx < n_mine * c4; idx += kThreads) {
    const int i = idx / c4, c = (idx % c4) * 4, r = rank + i * ranks;
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    if ((row0 + r) / G < ql) {
      float4 a[kMaxRanks];
#pragma unroll
      for (int k = 0; k < kMaxRanks; ++k)
        if (k < ranks && w_s[i][k] != 0.f)
          a[k] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(pacc, k) + r * ldp + c);
#pragma unroll
      for (int k = 0; k < kMaxRanks; ++k) {
        if (k >= ranks) break;
        const float w = w_s[i][k];
        if (w == 0.f) continue;
        o[0] += w * a[k].x;
        o[1] += w * a[k].y;
        o[2] += w * a[k].z;
        o[3] += w * a[k].w;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) o[k] /= den_s[i];
    }
    T* dst = out_row(r) + c;
#pragma unroll
    for (int k = 0; k < 4; ++k) dst[k] = ptt::from_f<T>(o[k]);
  }
}

template <typename T, typename KV, int D, bool ROPE>
__global__ void __launch_bounds__(kThreads)
paged_chunk_kernel(const T* __restrict__ q,          // [B, C, HQ, D], pre-rope when ROPE
                   const float* __restrict__ cos_t,  // [B, C, D] fp32 (ROPE only)
                   const float* __restrict__ sin_t,
                   const KV* __restrict__ kc,        // [NB, HKV, BS, D]
                   const KV* __restrict__ vc,
                   const float* __restrict__ ks,     // [NB, HKV, BS] (int8 KV only)
                   const float* __restrict__ vs,
                   const int* __restrict__ tables,   // [B, MBS]
                   const int* __restrict__ lens,     // [B] cached before the chunk
                   const int* __restrict__ qlens,    // [B] valid new rows
                   T* __restrict__ out,              // [B, C, HQ, D]
                   int C, int HQ, int HKV, int BS, int MBS, int ranks, float scale) {
  using G_ = Geo<T, KV, D>;
  constexpr int kDO = G_::kDO, kRows = G_::kRows;
  using W = WarpTile<T, D, kDO>;
  constexpr bool kQuant = G_::kQuant;
  constexpr int kLdQ = G_::kLdQ, kLdU = G_::kLdU, kLdK = G_::kLdK, kLdV = G_::kLdV, kLdP = G_::kLdP;
  constexpr int kNT = W::kNT, kStages = G_::kStages;

  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float part_m[kRows], part_l[kRows];
  __shared__ float w_s[kRows][kMaxRanks];  // the merge's weights of each rank's partial
  __shared__ float den_s[kRows];
  T* q_s = reinterpret_cast<T*>(smem);
  float* pacc = reinterpret_cast<float*>(smem);  // the merge's partials, after the walk
  int* blk_s = reinterpret_cast<int*>(smem + G_::kSmem);  // the rank's physical block ids

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int G = HQ / HKV;
  const int item = blockIdx.x / ranks;  // (tile, column half): the cluster's work
  const int row0 = (item / G_::kSplit) * kRows;
  const int col0 = (item % G_::kSplit) * kDO;  // this CTA's columns of O and V
  const int rows_here = min(kRows, C * G - row0);
  const int len = lens[b], ql = qlens[b];

  // output row r of this tile: query token j = (row0 + r) / G, head h * G + g
  auto out_row = [&](int r) -> T* {
    const int pr = row0 + r;
    return out + ((static_cast<size_t>(b) * C + pr / G) * HQ + h * G + pr % G) * D;
  };

  if (row0 / G >= ql) {  // every row is past q_lens (the same in every rank): exact 0, no KV read
    for (int idx = tid; idx < rows_here * kDO; idx += kThreads) {
      const int r = idx / kDO;
      if (r % ranks == rank) out_row(r)[col0 + idx % kDO] = ptt::from_f<T>(0.f);
    }
    return;
  }
  const int j_last = min((row0 + rows_here - 1) / G, ql - 1);
  const int n_pos = len + j_last + 1;  // the tile's causal limit: positions past it are masked
  const int n_blk = (n_pos + BS - 1) / BS;
  const int per = (n_blk + ranks - 1) / ranks;
  const int beg = rank * per * BS;
  const int end = min(beg + per * BS, n_pos);

  if (beg >= end) {  // an empty range: no partial
    for (int r = tid; r < kRows; r += kThreads) part_m[r] = kNegInf;
  } else {
    // the table entries of blocks [beg / BS, ceil(end / BS)): below ceil((lens + q_lens) / BS)
    const int blk0 = beg / BS, n_mine_blk = (end - 1) / BS + 1 - blk0;
    const int* table = tables + static_cast<size_t>(b) * MBS + blk0;
    for (int i = tid; i < n_mine_blk; i += kThreads) blk_s[i] = table[i];
    __syncthreads();
    // the ring: (K, V) tiles as stored and their scales; after it the pair in T (int8)
    auto kv_at = [&](int slot, int which) {
      return reinterpret_cast<KV*>(smem + G_::kRing + slot * G_::kStage + which * G_::kTileK);
    };
    auto scales_at = [&](int slot, int which) {
      return reinterpret_cast<float*>(smem + G_::kRing + slot * G_::kStage + G_::kTileK + G_::kTileV +
                                      which * G_::kScales);
    };
    // stage positions [p0, p0 + 16) of K and V (and their scales) into ring
    // slot st; rows past the rank's range are zero and read nothing. One
    // division a call: a thread's rows lie in the block of p0 or later ones.
    auto load = [&](int st, int p0) {
      KV* kdst = kv_at(st, 0);
      KV* vdst = kv_at(st, 1);
      const int rel0 = p0 - beg, b0 = rel0 / BS, o0 = rel0 - b0 * BS;  // beg is a multiple of BS
      // the pool row of tile row t (p0 + t < end)
      auto pool_row = [&](int t) -> size_t {
        int blk = b0, off = o0 + t;
        while (off >= BS) {
          off -= BS;
          ++blk;
        }
        return (static_cast<size_t>(blk_s[blk]) * HKV + h) * BS + off;
      };
      // 16-byte chunks of the K rows (all D columns); a chunk below kDO also
      // carries the V chunk of the CTA's columns at col0 + c
      constexpr int kCh = 16 / sizeof(KV), kChRow = D / kCh, kChunks = kTileN * kChRow;
#pragma unroll
      for (int k = 0; k < (kChunks + kThreads - 1) / kThreads; ++k) {
        const int i = tid + k * kThreads;
        if (kChunks % kThreads && i >= kChunks) break;
        const int t = i / kChRow, c = (i % kChRow) * kCh;
        const KV* ksrc = kc;
        const KV* vsrc = vc;
        int bytes = 0;
        if (p0 + t < end) {
          const size_t row = pool_row(t) * D;
          ksrc = kc + row + c;
          vsrc = vc + row + col0 + c;
          bytes = 16;
        }
        cp_async16(smem_u32(kdst + t * kLdK + c), ksrc, bytes);
        if (G_::kSplit == 1 || c < kDO) cp_async16(smem_u32(vdst + t * kLdV + c), vsrc, bytes);
      }
      if constexpr (kQuant) {
        if (tid < 2 * kTileN) {
          const int which = tid / kTileN, t = tid % kTileN;
          const float* base = which ? vs : ks;
          const float* src = base;
          int bytes = 0;
          if (p0 + t < end) {
            src = base + pool_row(t);
            bytes = 4;
          }
          cp_async4(smem_u32(scales_at(st, which) + t), src, bytes);
        }
      }
    };
    const int n_steps = (end - beg + kTileN - 1) / kTileN;
    T* const up_k = reinterpret_cast<T*>(smem + G_::kUp);
    T* const up_v = up_k + kTileN * kLdQ;
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < n_steps) load(st, beg + st * kTileN);
      cp_async_commit();
    }

    // q rows of the tile in q's type, roped when ROPE; rows past the tile or past q_lens: 0
    constexpr int kV = 8, kVecs = D / kV;
#pragma unroll 4
    for (int i = tid; i < kRows * kVecs; i += kThreads) {  // unrolled: several rows' loads in flight
      const int r = i / kVecs, d0 = (i % kVecs) * kV;
      const int pr = row0 + r, j = pr / G;
      float v[kV];
      if (r < rows_here && j < ql) {
        const T* qrow = q + ((static_cast<size_t>(b) * C + j) * HQ + h * G + pr % G) * D;
        load_vals<T, kV>(qrow + d0, v);
        if constexpr (ROPE) {
          float x2[kV], cs[kV], sn[kV];
          const bool lo_half = d0 < D / 2;
          load_vals<T, kV>(qrow + (lo_half ? d0 + D / 2 : d0 - D / 2), x2);
          const size_t trow = (static_cast<size_t>(b) * C + j) * D + d0;
          load_vals<float, kV>(cos_t + trow, cs);
          load_vals<float, kV>(sin_t + trow, sn);
#pragma unroll
          for (int k = 0; k < kV; ++k) v[k] = ptt::rope_val<T>(v[k], lo_half ? -x2[k] : x2[k], cs[k], sn[k]);
        }
      } else {
#pragma unroll
        for (int k = 0; k < kV; ++k) v[k] = 0.f;
      }
      store_vals<T, kV>(q_s + r * kLdQ + d0, v);
    }

    // this thread's two rows (gid, gid + 8 of its warp's 16): positions below lim[hf] are valid
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
    float s[2][4], pv[2][4];

    // every warp reads every tile, for its 16 rows; loads run kStages - 1 tiles ahead
    for (int step = 0; step < n_steps; ++step) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // step's tile has landed; every warp is done with the previous one (and q_s is written)
      const int nxt = step + kStages - 1;
      if (nxt < n_steps) load(nxt % kStages, beg + nxt * kTileN);
      cp_async_commit();
      const int st = step % kStages, p0 = beg + step * kTileN;
      const T* kt = reinterpret_cast<const T*>(kv_at(st, 0));
      const T* vt = reinterpret_cast<const T*>(kv_at(st, 1));
      int ldk = kLdK, ldv = kLdV;
      if constexpr (kQuant) {  // the int8 pair upcast to T (exact), then the same products
        upcast_tile<T, D>(up_k, kLdQ, reinterpret_cast<const int8_t*>(kv_at(st, 0)), kLdK);
        upcast_tile<T, kDO>(up_v, kLdU, reinterpret_cast<const int8_t*>(kv_at(st, 1)), kLdV);
        __syncthreads();
        kt = up_k;
        vt = up_v;
        ldk = kLdQ;
        ldv = kLdU;
      }
      if (p0 >= warp_lim) continue;  // every row of this warp is masked here: an exact no-op
      W::scores(s, q_s, kLdQ, q0, kt, ldk);
      W::softmax(s, pv, p0, lim, kQuant ? scales_at(st, 0) : nullptr, kQuant ? scales_at(st, 1) : nullptr, scale,
                 m_i, l_i, acc);
      W::pv_acc(acc, pv, vt, ldv);
    }
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with q_s and the tiles: their bytes take the partials

    // this warp's partial rows 16 * warp + (gid, gid + 8); a warp past kRows (fp32 above D 256) holds none
#pragma unroll
    for (int hf = 0; hf < 2 && 16 * warp < kRows; ++hf) {
      l_i[hf] += __shfl_xor_sync(0xffffffffu, l_i[hf], 1);
      l_i[hf] += __shfl_xor_sync(0xffffffffu, l_i[hf], 2);
      const int r = 16 * warp + gid + 8 * hf;
      if (tig == 0) {
        part_m[r] = m_i[hf];
        part_l[r] = l_i[hf];
      }
      float* prow = pacc + r * kLdP + 2 * tig;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
        *reinterpret_cast<float2*>(prow + nt * 8) = make_float2(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
    }
  }
  cluster.sync();  // every rank's partials are written

  merge_ranks<T>(cluster, rank, ranks, rows_here, row0, G, ql, part_m, part_l, pacc, kLdP, kDO, w_s, den_s,
                 [&](int r) { return out_row(r) + col0; });
  cluster.sync();  // no rank leaves while another still reads its shared memory
}

// One launch of kernel A (ROPE) or 4 as a cluster of `ranks` CTAs per
// (tile, column half, KV head, slot). The plan, `ranks` included, is
// paged_attention.py `chunk_plan`'s (its `split`, `cols` and `rows` must be
// the instance's own), from the shapes and the cap this
// answers when q is null: the CTAs of this instance the card holds at once
// (its occupancy with up to MBS table entries staged, times the SMs),
// written to the host int `out` with nothing launched (`rows` 0 or its own).
template <typename T, typename KV, int D, bool ROPE>
int launch_d(const void* q, const void* cos_t, const void* sin_t, const void* kc, const void* vc,
             const void* ks, const void* vs, const void* tables, const void* lens, const void* qlens,
             void* out, int B, int C, int HQ, int HKV, int BS, int MBS, int split, int cols, int rows, int ranks,
             float scale, cudaStream_t st) {
  using G_ = Geo<T, KV, D>;
  auto kernel = paged_chunk_kernel<T, KV, D, ROPE>;
  const size_t smem = G_::kSmem + sizeof(int) * MBS;  // the layout and the rank's table entries
  const int err = ptt::allow_smem(kernel, smem);
  if (err) return err;
  if (q == nullptr) {
    if (rows != 0 && rows != G_::kRows) return static_cast<int>(cudaErrorInvalidValue);
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    *static_cast<int*>(out) = max(1, per_sm * sms);
    return 0;
  }
  if (ranks < 1 || ranks > kMaxRanks || split != G_::kSplit || cols != G_::kDO || rows != G_::kRows)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (C * (HQ / HKV) + G_::kRows - 1) / G_::kRows;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * G_::kSplit * ranks, HKV, B);
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
      &cfg, kernel, static_cast<const T*>(q), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<const KV*>(kc), static_cast<const KV*>(vc),
      static_cast<const float*>(ks), static_cast<const float*>(vs), static_cast<const int*>(tables),
      static_cast<const int*>(lens), static_cast<const int*>(qlens), static_cast<T*>(out), C, HQ, HKV, BS, MBS,
      ranks, scale);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

namespace ptt::chunk {

// Kernel A (ROPE) or 4 at head dim D in {320, 384, 448, 512}, as
// paged_chunk_fused.cu's `launch` takes it (q == nullptr: the cap's query
// into the host int `out`); defined in paged_chunk_wide.cu.
template <typename T, typename KV, bool ROPE>
int launch_wide(const void* q, const void* cos_t, const void* sin_t, const void* kc, const void* vc, const void* ks,
                const void* vs, const void* tables, const void* lens, const void* qlens, void* out, int B, int C,
                int HQ, int HKV, int D, int BS, int MBS, int split, int cols, int rows, int ranks, float scale,
                cudaStream_t st);

// Kernels A and 4 at any head dim above 512 (a runtime multiple of 64), as
// `launch_wide` takes them (q == nullptr: the cap of the instance at `rows`
// tile rows, 0 for its own); defined in paged_chunk_deep.cu.
template <typename T, typename KV, bool ROPE>
int launch_deep(const void* q, const void* cos_t, const void* sin_t, const void* kc, const void* vc, const void* ks,
                const void* vs, const void* tables, const void* lens, const void* qlens, void* out, int B, int C,
                int HQ, int HKV, int D, int BS, int MBS, int split, int cols, int rows, int ranks, float scale,
                cudaStream_t st);

// The deep instance's own geometry at head dim D > 512 for q of type T over
// a pool of KV, written to out[6]: split, cols, rows, ring slots,
// shared-memory bytes (without the table entries) and the walk (1: q
// resident, 0: the chunked walk); defined in paged_chunk_deep.cu.
template <typename T, typename KV>
int deep_plan(int D, int* out);

}  // namespace ptt::chunk
