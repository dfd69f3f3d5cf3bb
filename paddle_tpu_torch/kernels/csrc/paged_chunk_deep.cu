// Kernels A and 4 at head dims above 512: one instance per (type, pool,
// rope) whose head dim D is a runtime multiple of 64 (see
// paged_chunk_fused.cu for what they compute and the semantics kept; the
// instances up to 512 are paged_chunk.cuh's, and this walk is theirs with D
// at run time).
//
// Bound on H100: bytes, as at D <= 512 (~64 flops per K/V byte a tile). The
// walk of a long history is latency-bound, so the design keeps the work of
// a 16-position step short and its loads ahead of it:
// - O's columns go over `split` = ceil(D / 256) CTAs, each owning `cols`
//   (whole 64-column units, paged_attention.py `_chunk_columns`), so a
//   thread's accumulator stays 128 fp32 as at D 256. Each CTA computes the
//   scores over all of D (the narrower instances' choice).
// - q is staged and roped once per CTA and stays resident in shared memory
//   in its own type, all D columns: 64 rows x (D + 8) x 2 bytes (74.8 KB at
//   D 576, 132 KB at 1024).
// - K and V stream through a cp.async ring of fixed slots whatever D is:
//   a slot holds 16 positions x at most 256 columns (8.4 KB in bf16). A
//   step of 16 positions takes ceil(D / 256) K slots, summing q k^T over
//   them on mma.sync (two accumulator chains, even and odd k16 steps), then
//   one slot of the CTA's columns of V. Loads run `slots` - 1 slots ahead
//   (3 of a ring of 4; 2 of 3 where 4 do not fit): one __syncthreads a
//   slot. A load divides by BS once; rows past the rank's range are
//   zero-filled and read nothing; the V slot carries both scale rows of the
//   int8 pool.
// - bf16 / fp16: both products on the tensor cores, p split into hi + lo
//   halves of T before PV (paged_chunk.cuh's WarpTile; the one-rounding
//   gate, tests/test_torch_paged_split.py). fp32: the same walk on the
//   CUDA cores, p unrounded.
// - int8 pool: slot i + 1 is upcast to T (exact) while slot i is consumed,
//   in two buffers of one slot's size, so the int8 walk keeps one barrier
//   a slot (its loads run one slot less ahead).
// - Tile rows: 64 (4 warps x 16) where q, the ring and the upcast buffers
//   fit kSmemBudget, else 32 (two warps compute, all four stage), else 16
//   (fp32 32 or 16); half as many where that lets an SM hold two CTAs.
//   `deep_geo` is the rule, `deep_plan` reports it and
//   paged_attention.py `chunk_geometry` mirrors it; a launch with another
//   split or cols is refused, and so are tile rows that do not fit. Where
//   not even 16 rows of q fit (D above ~5300 in bf16 / fp16, ~2400 in fp32)
//   the chunked walk below runs: q and K staged in 64-column chunks every
//   step, both products on the CUDA cores, p in fp32.
#include <type_traits>

#include "paged_chunk.cuh"

namespace {

constexpr int kDOMax = 256;        // O's columns a CTA at most
constexpr int kSlotCols = 256;     // columns of K or V one ring slot holds
constexpr int kLdPD = kDOMax + 8;  // merge partial rows, fp32

// cp.async.wait_group with a runtime count (0 to 3)
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0:
      cp_async_wait<0>();
      break;
    case 1:
      cp_async_wait<1>();
      break;
    case 2:
      cp_async_wait<2>();
      break;
    default:
      cp_async_wait<3>();
  }
}

// The sizes of the resident walk's pieces for q of type T over a pool of KV
template <typename T, typename KV>
struct DeepSizes {
  static constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  static constexpr int kLdS = kSlotCols + 16 / static_cast<int>(sizeof(KV));  // slot rows, elements of KV
  static constexpr int kLdU = kSlotCols + 16 / static_cast<int>(sizeof(T));   // upcast rows, elements of T
  static constexpr size_t kSlotData = static_cast<size_t>(kTileN) * kLdS * sizeof(KV);
  static constexpr size_t kSlot = kSlotData + (kQuant ? 2 * kTileN * sizeof(float) : 0);  // + k and v scales
  static constexpr size_t kUpOne = static_cast<size_t>(kTileN) * kLdU * sizeof(T);
  static constexpr size_t kUp = kQuant ? 2 * kUpOne : 0;
  static_assert(kSlot % 16 == 0 && kUpOne % 16 == 0, "16-byte aligned pieces");

  // q of `rows` rows of all D columns, padded by 16 bytes
  static __host__ __device__ size_t q_bytes(int D, int rows) {
    return static_cast<size_t>(rows) * (D + 16 / sizeof(T)) * sizeof(T);
  }
  // the layout's bytes (q, the ring, the upcast pair; the merge's partials
  // reuse them): the table entries follow at this offset
  static __host__ __device__ size_t smem(int D, int rows, int slots) {
    const size_t walk = q_bytes(D, rows) + slots * kSlot + kUp;
    const size_t merge = static_cast<size_t>(rows) * kLdPD * sizeof(float);
    return walk > merge ? walk : merge;
  }
};

// The chunked walk's layout (bytes)
constexpr int kDC = 64;                // columns of q and K staged at a time
constexpr int kLdC = kDC + 4;          // staged chunk rows, fp32
constexpr int kLdVD = kDOMax + 4;      // staged V rows, fp32
struct ChunkedLayout {
  static constexpr size_t kQ = 0;                                                   // q chunk [64][kLdC]
  static constexpr size_t kK = kQ + static_cast<size_t>(kMaxRows) * kLdC * 4;        // K chunk [16][kLdC]
  static constexpr size_t kV = kK + static_cast<size_t>(kTileN) * kLdC * 4;          // V tile [16][kLdVD]
  static constexpr size_t kS = kV + static_cast<size_t>(kTileN) * kLdVD * 4;         // scales [2][16]
  static constexpr size_t kWalk = kS + 2 * kTileN * 4;
  static constexpr size_t kMerge = static_cast<size_t>(kMaxRows) * kLdPD * 4;
  static constexpr size_t kSmem = kWalk > kMerge ? kWalk : kMerge;
};

// The launch geometry of head dim D > 512 (paged_attention.py
// `chunk_geometry` mirrors it). `rows_want` 0: the most tile rows of 64, 32,
// 16 (fp32: 32, 16) whose layout fits kSmemBudget with 4 ring slots, else
// 3; in bf16 / fp16, where that layout is over kSmemPair (one CTA an SM)
// and half the rows fit within it (two an SM), half the rows: two walks on
// an SM hide each other's latency (on an H100, mixed GQA 8/2 batch: at D
// 640-1024 32 rows ran 10-15% faster than 64, at 1536 16 than 32; at 576
// and 1280, where halving gains no second CTA, 64 stayed faster). Another
// `rows_want` asks for that many rows (valid: 64, 32 or 16 that fit). None
// fitting: the chunked walk (resident 0), or invalid (rows 0) when rows
// were asked.
constexpr size_t kSmemPair = 108 * 1024;  // a layout two CTAs an SM hold beside their tables and static arrays

struct DeepGeo {
  int split, cols, rows, slots, smem, resident;
};

template <typename T, typename KV>
DeepGeo deep_geo(int D, int rows_want) {
  using S = DeepSizes<T, KV>;
  const int units = D / 64;
  const int split = (D + kDOMax - 1) / kDOMax;
  const int cols = 64 * ((units + split - 1) / split);
  auto fit = [&](int rows) {  // the layout at `rows` with 4 slots, else 3; rows 0 when neither fits
    for (int slots = 4; slots >= 3; --slots) {
      const size_t smem = S::smem(D, rows, slots);
      if (smem <= kSmemBudget) return DeepGeo{split, cols, rows, slots, static_cast<int>(smem), 1};
    }
    return DeepGeo{split, cols, 0, 0, 0, 0};
  };
  if (rows_want == 64 || rows_want == 32 || rows_want == 16) return fit(rows_want);
  if (rows_want) return DeepGeo{split, cols, 0, 0, 0, 0};
  const bool fp32 = sizeof(T) == 4;
  for (int rows = fp32 ? 32 : 64; rows >= 16; rows /= 2) {
    const DeepGeo g = fit(rows);
    if (!g.rows) continue;
    if (!fp32 && rows > 16 && static_cast<size_t>(g.smem) > kSmemPair) {
      const DeepGeo h = fit(rows / 2);
      if (static_cast<size_t>(h.smem) <= kSmemPair) return h;
    }
    return g;
  }
  return DeepGeo{split, cols, kMaxRows, 0, static_cast<int>(ChunkedLayout::kSmem), 0};
}

// One warp's products of the resident walk: its 16 query rows (q_s rows
// q0 .. q0 + 15) against a slot of 16 positions; thread (gid, tig) owns
// rows gid and gid + 8 and the columns an mma.sync C fragment gives it, as
// in paged_chunk.cuh's WarpTile (whose softmax the walk takes).
template <typename T>
struct DeepTile {
  static constexpr bool kMma = !std::is_same<T, float>::value;
  static constexpr int kNT = kDOMax / 8;  // n8 column tiles of the accumulator

  // s += q . k (unscaled) over q's columns [c0, c0 + w) and the slot's (kt:
  // [pos][col], row stride ld, its column 0 at c0); w a multiple of 64
  static __device__ __forceinline__ void scores_add(float (&s)[2][4], const T* q_s, int ldq, int q0, int c0,
                                                    const T* kt, int ld, int w) {
    const int lane = threadIdx.x & 31;
    if constexpr (kMma) {
      const int li = lane >> 3, lr = lane & 7;
      const uint32_t qa = smem_u32(q_s + (q0 + (lane & 15)) * ldq + c0 + (lane >> 4) * 8);
      // K [pos][d]: (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15)
      const uint32_t ka = smem_u32(kt + (lr + (li >> 1) * 8) * ld + (li & 1) * 8);
      float s2[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};  // the odd k16 steps' chain
      auto k32 = [&](int kk) {  // columns kk .. kk + 31: one k16 step on each chain
        uint32_t a[4], bk[4], a2[4], bk2[4];
        const uint32_t off = kk * static_cast<uint32_t>(sizeof(T));
        ldsm_x4(a, qa + off);
        ldsm_x4(bk, ka + off);
        ldsm_x4(a2, qa + off + 16 * sizeof(T));
        ldsm_x4(bk2, ka + off + 16 * sizeof(T));
        ptt::flx::mma<T>(s[0], a, bk[0], bk[1]);
        ptt::flx::mma<T>(s[1], a, bk[2], bk[3]);
        ptt::flx::mma<T>(s2[0], a2, bk2[0], bk2[1]);
        ptt::flx::mma<T>(s2[1], a2, bk2[2], bk2[3]);
      };
      if (w == kSlotCols) {  // a whole slot, unrolled: its loads go out ahead of the products (4-7% a call on an H100)
#pragma unroll
        for (int kk = 0; kk < kSlotCols; kk += 32) k32(kk);
      } else {
#pragma unroll 2
        for (int kk = 0; kk < w; kk += 32) k32(kk);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] += s2[nt][e];
    } else {
      const int gid = lane >> 2, tig = lane & 3;
      const float* qa = q_s + (q0 + gid) * ldq + c0;
      const float* qb = qa + 8 * ldq;
#pragma unroll 4
      for (int d = 0; d < w; d += 4) {
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

  // acc += pv . V over the slot's 16 positions and its first `cols`
  // columns (vt: [pos][col], row stride ld)
  static __device__ __forceinline__ void pv_add(float (&acc)[kNT][4], const float (&pv)[2][4], const T* vt, int ld,
                                                int cols) {
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
      const uint32_t va = smem_u32(vt + (lr + (li & 1) * 8) * ld + (li >> 1) * 8);
#pragma unroll
      for (int np = 0; np < kDOMax / 16; ++np) {
        if (np * 16 >= cols) break;
        uint32_t r[4];  // V [pos][d]: (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
        ldsm_x4_t(r, va + np * 16 * static_cast<uint32_t>(sizeof(T)));
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
          if (nt * 8 >= cols) break;
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

// the int8 slot src ([16][ld8] bytes, its first w columns) as T in dst
// ([16][ldt]), exact; all threads of the block take part
template <typename T>
__device__ __forceinline__ void upcast_slot(T* dst, int ldt, const int8_t* src, int ld8, int w) {
  const int per_row = w / 16;
  for (int i = threadIdx.x; i < kTileN * per_row; i += kThreads) {
    const int t = i / per_row, c = (i - t * per_row) * 16;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + t * ld8 + c);
    const int8_t* e = ptt::elems_of<int8_t>(raw);
    float v[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) v[k] = ptt::to_f(e[k]);
    store_vals<T, 16>(dst + t * ldt + c, v);
  }
}

// The resident walk (see the header). Grid and cluster as paged_chunk.cuh's
// paged_chunk_kernel: x = (tile, column slice) x rank, y = KV head, z = slot.
template <typename T, typename KV, bool ROPE>
__global__ void __launch_bounds__(kThreads)
paged_chunk_deep_kernel(const T* __restrict__ q, const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                        const KV* __restrict__ kc, const KV* __restrict__ vc, const float* __restrict__ ks,
                        const float* __restrict__ vs, const int* __restrict__ tables, const int* __restrict__ lens,
                        const int* __restrict__ qlens, T* __restrict__ out, int C, int HQ, int HKV, int D, int BS,
                        int MBS, int split, int cols, int rows, int slots, int ranks, float scale) {
  using S = DeepSizes<T, KV>;
  using DT = DeepTile<T>;
  using WT = WarpTile<T, kSlotCols, kDOMax>;  // its softmax
  constexpr bool kQuant = S::kQuant;
  constexpr int kNT = DT::kNT;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float part_m[kMaxRows], part_l[kMaxRows];
  __shared__ float w_s[kMaxRows][kMaxRanks];  // the merge's weights of each rank's partial
  __shared__ float den_s[kMaxRows];
  const int ldq = D + 16 / static_cast<int>(sizeof(T));
  T* q_s = reinterpret_cast<T*>(smem);
  unsigned char* ring = smem + S::q_bytes(D, rows);
  T* up = reinterpret_cast<T*>(ring + slots * S::kSlot);  // the upcast pair (int8 pool)
  float* pacc = reinterpret_cast<float*>(smem);             // the merge's partials, after the walk
  int* blk_s = reinterpret_cast<int*>(smem + S::smem(D, rows, slots));  // the rank's physical block ids

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int G = HQ / HKV;
  const int item = blockIdx.x / ranks;  // (tile, column slice): the cluster's work
  const int row0 = (item / split) * rows;
  const int col0 = (item % split) * cols;
  const int cols_here = min(cols, D - col0);
  const int rows_here = min(rows, C * G - row0);
  const int len = lens[b], ql = qlens[b];

  // output row r of this tile: query token j = (row0 + r) / G, head h * G + g
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
  const int n_pos = len + j_last + 1;  // the tile's causal limit
  const int n_blk = (n_pos + BS - 1) / BS;
  const int per = (n_blk + ranks - 1) / ranks;
  const int beg = rank * per * BS;
  const int end = min(beg + per * BS, n_pos);

  if (beg >= end) {  // an empty range: no partial
    for (int r = tid; r < rows; r += kThreads) part_m[r] = kNegInf;
  } else {
    const int blk0 = beg / BS, n_mine_blk = (end - 1) / BS + 1 - blk0;
    const int* table = tables + static_cast<size_t>(b) * MBS + blk0;
    for (int i = tid; i < n_mine_blk; i += kThreads) blk_s[i] = table[i];
    __syncthreads();

    const int nk = (D + kSlotCols - 1) / kSlotCols;  // K slots a step; then one V slot
    const int n_steps = (end - beg + kTileN - 1) / kTileN;
    const int n_slots = n_steps * (nk + 1);
    auto slot_at = [&](int st) { return ring + st * S::kSlot; };
    auto scales_at = [&](int st) { return reinterpret_cast<float*>(slot_at(st) + S::kSlotData); };
    // slot c of a step: K's columns [256 c, 256 c + w) for c < nk, else the CTA's columns of V
    auto width_of = [&](int c) { return c == nk ? cols_here : min(kSlotCols, D - c * kSlotCols); };
    // stage slot c of step `step` into ring slot st; rows past the rank's
    // range are zero and read nothing; one division a call
    auto load = [&](int st, int step, int c) {
      KV* dst = reinterpret_cast<KV*>(slot_at(st));
      const int p0 = beg + step * kTileN;
      const int rel0 = p0 - beg, b0 = rel0 / BS, o0 = rel0 - b0 * BS;  // beg is a multiple of BS
      auto pool_row = [&](int t) -> size_t {  // the pool row of slot row t (p0 + t < end)
        int blk = b0, off = o0 + t;
        while (off >= BS) {
          off -= BS;
          ++blk;
        }
        return (static_cast<size_t>(blk_s[blk]) * HKV + h) * BS + off;
      };
      const bool is_v = c == nk;
      const KV* pool = is_v ? vc : kc;
      const int base = is_v ? col0 : c * kSlotCols, w = width_of(c);
      constexpr int kCh = 16 / sizeof(KV), kChRow = kSlotCols / kCh, kChunks = kTileN * kChRow;
      static_assert(kChunks % kThreads == 0 && kThreads % kChRow == 0, "a thread's chunks share a column");
      const int cc = (tid % kChRow) * kCh;
      if (cc < w) {
#pragma unroll
        for (int k = 0; k < kChunks / kThreads; ++k) {
          const int t = (tid + k * kThreads) / kChRow;
          const KV* src = pool;
          int bytes = 0;
          if (p0 + t < end) {
            src = pool + pool_row(t) * D + base + cc;
            bytes = 16;
          }
          cp_async16(smem_u32(dst + t * S::kLdS + cc), src, bytes);
        }
      }
      if constexpr (kQuant) {  // the V slot carries the step's k and v scales
        if (is_v && tid < 2 * kTileN) {
          const int which = tid / kTileN, t = tid % kTileN;
          const float* src = which ? vs : ks;
          int bytes = 0;
          if (p0 + t < end) {
            src += pool_row(t);
            bytes = 4;
          }
          cp_async4(smem_u32(scales_at(st) + tid), src, bytes);
        }
      }
    };
    // the load cursor: slots are loaded in walk order, `slots` - 1 ahead
    int ld_i = 0, ld_step = 0, ld_c = 0, ld_st = 0;
    auto enqueue = [&]() {
      if (ld_i < n_slots) load(ld_st, ld_step, ld_c);
      cp_async_commit();
      ++ld_i;
      if (++ld_c > nk) {
        ld_c = 0;
        ++ld_step;
      }
      if (++ld_st == slots) ld_st = 0;
    };
    for (int k = 0; k < slots - 1; ++k) enqueue();

    // q rows of the tile in q's type, roped when ROPE; rows past the tile or past q_lens: 0
    constexpr int kV = 8;
    const int vecs = D / kV, half = D / 2;
#pragma unroll 4
    for (int i = tid; i < rows * vecs; i += kThreads) {
      const int r = i / vecs, d0 = (i - r * vecs) * kV;
      const int pr = row0 + r, j = pr / G;
      float v[kV];
      if (r < rows_here && j < ql) {
        const T* qrow = q + ((static_cast<size_t>(b) * C + j) * HQ + h * G + pr % G) * D;
        load_vals<T, kV>(qrow + d0, v);
        if constexpr (ROPE) {
          float x2[kV], cs[kV], sn[kV];
          const bool lo_half = d0 < half;
          load_vals<T, kV>(qrow + (lo_half ? d0 + half : d0 - half), x2);
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
      store_vals<T, kV>(q_s + r * ldq + d0, v);
    }
    if constexpr (kQuant) {  // slot 0 upcast before the walk; the walk upcasts slot i + 1 at slot i
      cp_async_wait_n(slots - 2);
      __syncthreads();
      upcast_slot<T>(up, S::kLdU, reinterpret_cast<const int8_t*>(slot_at(0)), S::kLdS, width_of(0));
    }

    // this thread's two rows (gid, gid + 8 of its warp's 16): positions below lim[hf] are valid;
    // a warp past `rows` holds none
    const int q0 = 16 * warp;
    int lim[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = q0 + gid + 8 * hf, j = (row0 + r) / G;
      lim[hf] = (q0 < rows && r < rows_here && j < ql) ? min(len + j + 1, end) : 0;
    }
    int warp_lim = max(lim[0], lim[1]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) warp_lim = max(warp_lim, __shfl_xor_sync(0xffffffffu, warp_lim, o));

    float m_i[2] = {kNegInf, kNegInf}, l_i[2] = {0.f, 0.f};
    float acc[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}}, pv[2][4];

    int c = 0, step = 0, st = 0;
    for (int i = 0; i < n_slots; ++i) {
      cp_async_wait_n(kQuant ? slots - 3 : slots - 2);
      __syncthreads();  // slot i has landed (int8: slot i + 1); every warp is done with slot i - 1
      enqueue();
      const int p0 = beg + step * kTileN;
      const T* tile = reinterpret_cast<const T*>(slot_at(st));
      int ld = S::kLdS;
      if constexpr (kQuant) {
        if (i + 1 < n_slots) {
          const int c1 = c == nk ? 0 : c + 1, st1 = st + 1 == slots ? 0 : st + 1;
          upcast_slot<T>(up + ((i + 1) & 1) * (S::kUpOne / sizeof(T)), S::kLdU,
                         reinterpret_cast<const int8_t*>(slot_at(st1)), S::kLdS, width_of(c1));
        }
        tile = up + (i & 1) * (S::kUpOne / sizeof(T));
        ld = S::kLdU;
      }
      if (p0 < warp_lim) {  // else every row of this warp is masked here: an exact no-op
        if (c < nk) {
          DT::scores_add(s, q_s, ldq, q0, c * kSlotCols, tile, ld, width_of(c));
        } else {
          const float* sc = scales_at(st);
          WT::softmax(s, pv, p0, lim, kQuant ? sc : nullptr, kQuant ? sc + kTileN : nullptr, scale, m_i, l_i, acc);
          DT::pv_add(acc, pv, tile, ld, cols_here);
        }
      }
      if (c == nk) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        c = 0;
        ++step;
      } else {
        ++c;
      }
      if (++st == slots) st = 0;
    }
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with q_s and the ring: their bytes take the partials

#pragma unroll
    for (int hf = 0; hf < 2 && q0 < rows; ++hf) {
      l_i[hf] += __shfl_xor_sync(0xffffffffu, l_i[hf], 1);
      l_i[hf] += __shfl_xor_sync(0xffffffffu, l_i[hf], 2);
      const int r = q0 + gid + 8 * hf;
      if (tig == 0) {
        part_m[r] = m_i[hf];
        part_l[r] = l_i[hf];
      }
      float* prow = pacc + r * kLdPD + 2 * tig;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        if (nt * 8 >= cols_here) break;
        *reinterpret_cast<float2*>(prow + nt * 8) = make_float2(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
      }
    }
  }
  cluster.sync();  // every rank's partials are written

  merge_ranks<T>(cluster, rank, ranks, rows_here, row0, G, ql, part_m, part_l, pacc, kLdPD, cols_here, w_s, den_s,
                 [&](int r) { return out_row(r) + col0; });
  cluster.sync();  // no rank leaves while another still reads its shared memory
}

// The chunked walk, where not even 16 rows of q fit resident: every
// 16-position step sums the scores over D 64 columns at a time (q's chunk
// staged, and roped, each time), then stages the CTA's columns of V; every
// tile widened to fp32, both products on the CUDA cores, p unrounded; plain
// loads, 64 tile rows.
template <typename T, typename KV, bool ROPE>
__global__ void __launch_bounds__(kThreads)
paged_chunk_chunked_kernel(const T* __restrict__ q, const float* __restrict__ cos_t, const float* __restrict__ sin_t,
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
  float* q_s = reinterpret_cast<float*>(smem + ChunkedLayout::kQ);
  float* k_s = reinterpret_cast<float*>(smem + ChunkedLayout::kK);
  float* v_s = reinterpret_cast<float*>(smem + ChunkedLayout::kV);
  float* sc_s = reinterpret_cast<float*>(smem + ChunkedLayout::kS);
  float* pacc = reinterpret_cast<float*>(smem);
  int* blk_s = reinterpret_cast<int*>(smem + ChunkedLayout::kSmem);

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

// Opens `kernel` to `smem` bytes of dynamic shared memory; with `cap` set,
// writes there the CTAs of it the card holds at once (its occupancy times
// the SMs). Returns a CUDA error.
template <typename Kernel>
int prepare(Kernel kernel, size_t smem, void* cap) {
  const int err = ptt::allow_smem(kernel, smem);
  if (err || cap == nullptr) return err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  *static_cast<int*>(cap) = max(1, per_sm * sms);
  return 0;
}

}  // namespace

namespace ptt::chunk {

template <typename T, typename KV>
int deep_plan(int D, int* out) {
  if (D <= 512 || D % 64) return static_cast<int>(cudaErrorInvalidValue);
  const DeepGeo g = deep_geo<T, KV>(D, 0);
  const int geo[6] = {g.split, g.cols, g.rows, g.slots, g.smem, g.resident};
  for (int i = 0; i < 6; ++i) out[i] = geo[i];
  return 0;
}

// `rows` is the plan's: the geometry's own, or for the resident walk another
// count of tile rows that fits (64, 32, 16), which the cap query takes too
// (0 there: the geometry's own). split and cols must be the geometry's.
template <typename T, typename KV, bool ROPE>
int launch_deep(const void* q, const void* cos_t, const void* sin_t, const void* kc, const void* vc, const void* ks,
                const void* vs, const void* tables, const void* lens, const void* qlens, void* out, int B, int C,
                int HQ, int HKV, int D, int BS, int MBS, int split, int cols, int rows, int ranks, float scale,
                cudaStream_t st) {
  if (D <= 512 || D % 64) return static_cast<int>(cudaErrorInvalidValue);
  const DeepGeo own = deep_geo<T, KV>(D, 0);
  const bool asked = q == nullptr ? rows != 0 : rows != own.rows;
  const DeepGeo g = asked ? deep_geo<T, KV>(D, rows) : own;
  if (g.rows == 0) return static_cast<int>(cudaErrorInvalidValue);  // tile rows whose layout does not fit
  const size_t smem = static_cast<size_t>(g.smem) + sizeof(int) * MBS;  // the layout and the rank's table entries
  void* cap = q == nullptr ? out : nullptr;
  const int err = g.resident ? prepare(paged_chunk_deep_kernel<T, KV, ROPE>, smem, cap)
                             : prepare(paged_chunk_chunked_kernel<T, KV, ROPE>, smem, cap);
  if (err || q == nullptr) return err;
  if (ranks < 1 || ranks > kMaxRanks || split != g.split || cols != g.cols || rows != g.rows)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (C * (HQ / HKV) + g.rows - 1) / g.rows;
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
  const T* q_ = static_cast<const T*>(q);
  const float *cos_ = static_cast<const float*>(cos_t), *sin_ = static_cast<const float*>(sin_t);
  const KV *kc_ = static_cast<const KV*>(kc), *vc_ = static_cast<const KV*>(vc);
  const float *ks_ = static_cast<const float*>(ks), *vs_ = static_cast<const float*>(vs);
  const int *tables_ = static_cast<const int*>(tables), *lens_ = static_cast<const int*>(lens);
  const int* qlens_ = static_cast<const int*>(qlens);
  T* out_ = static_cast<T*>(out);
  const cudaError_t e =
      g.resident ? cudaLaunchKernelEx(&cfg, paged_chunk_deep_kernel<T, KV, ROPE>, q_, cos_, sin_, kc_, vc_, ks_, vs_,
                                      tables_, lens_, qlens_, out_, C, HQ, HKV, D, BS, MBS, split, cols, g.rows,
                                      g.slots, ranks, scale)
                 : cudaLaunchKernelEx(&cfg, paged_chunk_chunked_kernel<T, KV, ROPE>, q_, cos_, sin_, kc_, vc_, ks_,
                                      vs_, tables_, lens_, qlens_, out_, C, HQ, HKV, D, BS, MBS, split, cols, ranks,
                                      scale);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

#define PTT_DEEP(T, KV)                                                                                              \
  template int deep_plan<T, KV>(int, int*);                                                                          \
  template int launch_deep<T, KV, true>(const void*, const void*, const void*, const void*, const void*,             \
                                        const void*, const void*, const void*, const void*, const void*, void*,      \
                                        int, int, int, int, int, int, int, int, int, int, int, float,                \
                                        cudaStream_t);                                                               \
  template int launch_deep<T, KV, false>(const void*, const void*, const void*, const void*, const void*,            \
                                         const void*, const void*, const void*, const void*, const void*,            \
                                         void*, int, int, int, int, int, int, int, int, int, int, int, float,        \
                                         cudaStream_t);
PTT_DEEP(ptt::bf16, ptt::bf16)
PTT_DEEP(ptt::f16, ptt::f16)
PTT_DEEP(float, float)
PTT_DEEP(ptt::bf16, int8_t)
PTT_DEEP(ptt::f16, int8_t)
PTT_DEEP(float, int8_t)
#undef PTT_DEEP

}  // namespace ptt::chunk
