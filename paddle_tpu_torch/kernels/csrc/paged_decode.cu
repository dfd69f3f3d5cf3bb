// Flash decode over the paged KV cache: one new query token per slot, whose
// G = HQ / HKV query heads of one KV head attend to positions < lens[b] of
// the slot's paged KV blocks (lens INCLUDES the token just appended). Two
// kernels share this source: with ROPE off, q is taken as given (kernel 5);
// with it on, neox rope is applied to q in q's type first (kernel 6).
//
// Replaces: paddle_tpu/kernels/paged_attention.py `_decode_kernel`
// (launched by `paged_flash_decode`, the decode step of `generate_paged`)
// and `_decode_fused_kernel` (launched by `paged_flash_decode_fused`), each
// with `_dequant_tile` in its block walk when the pool is int8.
//
// Semantics kept from the Pallas kernels: q (roped in its type when ROPE:
// the fp32 rope rows rounded to that type, each product and the sum rounded
// to it) is cast to fp32 and multiplied by `scale`; scores are fp32; the
// softmax is an fp32 online softmax with denominator max(l, 1e-30), so a
// slot with lens == 0 is written as exact 0; positions >= lens contribute
// p == 0 exactly (here: they are never visited); block-table entries at or
// past ceil(lens / BS) are never read, and neither are their blocks.
// Storage is bf16, fp16 or fp32 (the template type T); the math is fp32.
// The head dim D is a runtime multiple of 64, any of them (the staged rows
// must fit a CTA's shared memory: a K row, the CTA's V columns and q's rows
// in fp32, which holds to D 8192 and beyond).
//
// The int8 pool (KV = int8_t, the `_int8` entry points): int8 K/V rows and
// two fp32 scale planes [NB, HKV, BS] addressed by the same physical block
// id; K = float(int8) * k_scale and V = float(int8) * v_scale (the Pallas
// `_dequant_tile`), with the scales folded as kernels A/4 fold them: s =
// (q . k8) * k_scale, and p * v_scale multiplies V's int8 row. q and out
// keep their own type T.
//
// Bound on H100: bytes. Each used K/V row is read once per (KV head, row
// group, column slice), ~1 flop a byte for MHA (G for GQA), far under the
// card's ~295 flop/byte ridge. So the design puts more bytes in flight over
// more SMs (the old one-block-per-(slot, head) walk held 8-16 rows in
// flight and reached 18.5% of the bound), and uses the CUDA cores' FMAs:
// mma.sync would only pay at G >= 8, where the walk is still bytes-bound.
//
// - The history is split over a thread-block cluster, as kernels A/4 split
//   theirs (paged_chunk.cuh): one cluster of R CTAs per (row group, column
//   slice, KV head, slot). The slot's ceil(lens / BS) table entries are cut
//   into R contiguous ranges of ceil(blocks / R) entries; rank r walks range
//   r (possibly empty) with its own fp32 online softmax, and the ranks'
//   partials are merged through distributed shared memory in rank order:
//   one launch, no workspace, no atomics, the same bits every run. R is the
//   most, 1 to 8, whose clusters the card holds at once (one wave, as
//   kernels A/4 choose theirs; cudaOccupancyMaxActiveClusters counts them),
//   chosen on the host from the shapes and the card's occupancy only
//   (paged_attention.py `decode_plan`): no length is read on the host. On
//   an H100 a second wave cost the uniform `generate_paged` step more than
//   any rank count within one wave (PERF.md §6); with every CTA resident
//   the grid's order does not matter, and the most ranks give the longest
//   history of a skewed batch the shortest walk.
// - The history's positions are streamed with bulk asynchronous copies
//   (cp.async.bulk, bytes completing on an mbarrier) into a ring of stages.
//   A stage is up to 16 consecutive positions of the rank's range (one copy
//   per page segment: a stage may span pages): their K rows (all of D) and
//   their V rows (the CTA's columns), plus the int8 pool's scale rows
//   (4-byte cp.async by the producer's lanes, arriving on the same barrier).
//   One producer warp reads 32 table entries at a time (one coalesced load)
//   and keeps the ring full, so no warp ever waits on a table load and then
//   on a row load in turn; it starts before q is staged. Stage size and depth
//   come from the plan: at most 16 KB a stage and ~24 KB a ring (2 stages
//   at least). The MHA instances are held to 64 registers a thread
//   (`__launch_bounds__` with 6 CTAs an SM; the build log's ptxas lines
//   show each instance's registers and spills).
// - Four consumer warps take a stage's positions in batches of 4 (warp w
//   the positions w, w + 4, w + 8, w + 12), each warp with its own online
//   softmax. A warp splits D over its lanes, 2 columns a lane in each
//   64-column unit: a batch's 4 scores are the lane partials summed by one
//   butterfly (6 shuffles for the 4), after which lane l holds position
//   l / 8's score, so each lane takes one exp2 (q is scaled by scale *
//   log2(e) when staged) and the batch's max and sum are 2 shuffles each.
//   The accumulator is 2 columns a lane per unit of the CTA's O columns,
//   for the group's query rows, so any multiple of 64 fits. The G query
//   heads of a KV head (up to 4, or 2 where a CTA holds 512 columns) share
//   each staged position; q's rows sit in shared memory in fp32.
// - Head dims above 512: O's columns go over ceil(D / 512) CTAs (a grid
//   axis, `split`), each computing the scores over all of D and PV over its
//   own columns, so a lane's accumulator stays at most 16 a row.
// - After the walk each CTA merges its four warps' partials in warp order
//   in its own shared memory, then the cluster merges the CTAs' in rank
//   order, each rank writing a contiguous share of the output.
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

using ptt::bf16;
using ptt::f16;

namespace {

namespace cg = cooperative_groups;
namespace hp = ptt::hopper;

constexpr int kWarps = 4;                    // consumer warps
constexpr int kThreads = (kWarps + 1) * 32;  // and one producer warp
constexpr int kMaxRanks = 8;                 // CTAs a cluster (the portable limit)
constexpr int kMaxStageRows = 32;            // positions a stage (it may span pages)
constexpr float kNegInf = -1e30f;            // the Pallas kernel's NEG_INF

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Shared-memory layout of one CTA (bytes): the full and empty barriers of
// the ring, q's rows in fp32, then the ring of `stages` stages, each a K
// box [sp][D], a V box [sp][cols] (of KV) and, for the int8 pool, the two
// scale rows [sp]. The merge reuses the ring's bytes for the warps'
// partials [kWarps][rows][cols] and the CTA's [rows][cols] (fp32), with
// their m and l.
struct Layout {
  int v_off, s_off, stage, q, ring, total;
};

__host__ __device__ inline Layout layout_of(int D, int cols, int rows, int sp, int stages, int kv_bytes, bool quant) {
  Layout L;
  L.v_off = sp * D * kv_bytes;
  L.s_off = L.v_off + sp * cols * kv_bytes;
  L.stage = round_up(L.s_off + (quant ? 2 * sp * 4 : 0), 128);
  L.q = round_up(2 * stages * 8, 128);
  L.ring = round_up(L.q + rows * D * 4, 128);
  const int walk = stages * L.stage;
  const int merge = ((kWarps + 1) * rows * cols + 2 * (kWarps + 1) * rows) * 4;
  L.total = L.ring + (walk > merge ? walk : merge);
  return L;
}

// two consecutive elements of KV (4-, 2-, 8- or 2-byte aligned) as fp32
template <typename KV>
__device__ __forceinline__ float2 load2(const KV* p);
template <>
__device__ __forceinline__ float2 load2<bf16>(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
template <>
__device__ __forceinline__ float2 load2<f16>(const f16* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}
template <>
__device__ __forceinline__ float2 load2<float>(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
template <>
__device__ __forceinline__ float2 load2<int8_t>(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2(static_cast<float>(c.x), static_cast<float>(c.y));
}

// The sum over the warp of four lane partials a[0..3] (one per position
// of a batch), by a butterfly that halves the values in flight at each of
// the first two levels (6 shuffles, not 20): lane l returns the total of
// a[l / 8].
__device__ __forceinline__ float warp_sum4(const float (&a)[4], int lane) {
  const bool u16 = lane & 16, u8 = lane & 8;
  const float b0 = (u16 ? a[2] : a[0]) + __shfl_xor_sync(0xffffffffu, u16 ? a[0] : a[2], 16);
  const float b1 = (u16 ? a[3] : a[1]) + __shfl_xor_sync(0xffffffffu, u16 ? a[1] : a[3], 16);
  float c = (u8 ? b1 : b0) + __shfl_xor_sync(0xffffffffu, u8 ? b0 : b1, 8);
  c += __shfl_xor_sync(0xffffffffu, c, 4);
  c += __shfl_xor_sync(0xffffffffu, c, 2);
  c += __shfl_xor_sync(0xffffffffu, c, 1);
  return c;
}

// kUnits: the CTA's O columns in 64-column units (at most); kRows: its
// query rows (at most)
template <typename T, typename KV, int kUnits, int kRows, bool ROPE>
__global__ void __launch_bounds__(kThreads, kRows == 1 ? 6 : 1)
paged_decode_kernel(const T* __restrict__ q,          // [B, HQ, D], pre-rope when ROPE
                    const float* __restrict__ cos_t,  // [B, D] fp32 (ROPE only)
                    const float* __restrict__ sin_t,
                    const KV* __restrict__ kc,        // [NB, HKV, BS, D]
                    const KV* __restrict__ vc,
                    const float* __restrict__ ks,     // [NB, HKV, BS] (int8 KV only)
                    const float* __restrict__ vs,
                    const int* __restrict__ tables,   // [B, MBS]
                    const int* __restrict__ lens,     // [B] INCLUDING the current token
                    T* __restrict__ out,              // [B, HQ, D]
                    int HQ, int HKV, int D, int BS, int MBS, int rows, int split, int cols, int ranks, int sp,
                    int stages, float scale) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float w_s[kRows][kMaxRanks];  // the cross-rank merge's weights of each row
  __shared__ float den_s[kRows];

  const Layout L = layout_of(D, cols, kRows, sp, stages, static_cast<int>(sizeof(KV)), kQuant);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + stages;
  float* q_s = reinterpret_cast<float*>(smem + L.q);  // [kRows][D]
  unsigned char* ring = smem + L.ring;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.y, b = blockIdx.z;
  const int G = HQ / HKV;
  const int item = blockIdx.x / ranks;  // (row group, column slice): the cluster's work
  const int g0 = (item / split) * rows;
  const int rows_here = min(rows, G - g0);
  const int col0 = (item % split) * cols;
  const int cols_here = min(cols, D - col0);

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      hp::mbar_init(&full[s], 1 + (kQuant ? 32 : 0));  // the producer's expect_tx (+ its lanes' scale copies)
      hp::mbar_init(&empty[s], kWarps);
    }
    hp::mbar_fence_init();
  }
  __syncthreads();  // the barriers are initialised
  const int len = lens[b];
  const int n_blk = (len + BS - 1) / BS;  // table entries below ceil(lens / BS): the only ones read
  const int per = (n_blk + ranks - 1) / ranks;
  const int blk0 = min(rank * per, n_blk), blk1 = min(blk0 + per, n_blk);  // this rank's entries
  const int beg = blk0 * BS, end = min(blk1 * BS, len);                    // and positions

  float m[kRows], l[kRows], acc[kRows][kUnits][2];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int u = 0; u < kUnits; ++u) acc[r][u][0] = acc[r][u][1] = 0.f;
  }

  if (warp == kWarps) {
    // the producer: stages of up to sp positions of the rank's range, in
    // order (a stage may span pages: one copy per page segment), into the
    // ring; the table entries 32 at a time
    const int* table = tables + static_cast<size_t>(b) * MBS;
    int st = 0, win = blk0;
    uint32_t ph = 0;
    int mine = win + lane < blk1 ? table[win + lane] : 0;
    for (int p0 = beg; p0 < end; p0 += sp) {
      const int n = min(sp, end - p0);
      hp::mbar_wait(&empty[st], ph ^ 1);
      unsigned char* base = ring + st * L.stage;
      KV* kdst = reinterpret_cast<KV*>(base);
      KV* vdst = reinterpret_cast<KV*>(base + L.v_off);
      float* sdst = reinterpret_cast<float*>(base + L.s_off);
      if (lane == 0) hp::mbar_arrive_expect_tx(&full[st], n * (D + cols_here) * sizeof(KV));
      for (int pos = p0; pos < p0 + n;) {
        const int page = pos / BS, off = pos - page * BS, seg = min(BS - off, p0 + n - pos);
        if (page >= win + 32) {  // the next 32 table entries
          win += 32;
          mine = win + lane < blk1 ? table[win + lane] : 0;
        }
        const int blk = __shfl_sync(0xffffffffu, mine, page - win);
        const size_t row = (static_cast<size_t>(blk) * HKV + h) * BS + off;  // the segment's first pool row
        const int t = pos - p0;                                               // and its row in the stage
        if (lane == 0) {
          hp::bulk_load(kdst + static_cast<size_t>(t) * D, kc + row * D, seg * D * sizeof(KV), &full[st]);
          if (cols_here == D) {
            hp::bulk_load(vdst + static_cast<size_t>(t) * D, vc + row * D, seg * D * sizeof(KV), &full[st]);
          } else {  // the CTA's columns of each row
            for (int i = 0; i < seg; ++i)
              hp::bulk_load(vdst + static_cast<size_t>(t + i) * cols_here, vc + (row + i) * D + col0,
                        cols_here * sizeof(KV), &full[st]);
          }
        }
        if constexpr (kQuant) {
          for (int i = lane; i < seg; i += 32) {
            hp::cp_async4(sdst + t + i, ks + row + i);
            hp::cp_async4(sdst + sp + t + i, vs + row + i);
          }
        }
        pos += seg;
      }
      if constexpr (kQuant) hp::cp_async_mbar_arrive(&full[st]);
      if (++st == stages) {
        st = 0;
        ph ^= 1;
      }
    }
  } else {
    // the consumers: q's rows (roped in q's type when ROPE) scaled in fp32
    // and by log2(e), so the softmax runs on exp2; rows past the group: 0.
    // Staged while the producer's first copies fly.
    const T* qbase = q + (static_cast<size_t>(b) * HQ + h * G + g0) * D;
    const int half = D / 2;
    const float qscale = scale * kLog2e;
    for (int idx = tid; idx < kRows * D; idx += kWarps * 32) {
      const int r = idx / D, d = idx - r * D;
      float val = 0.f;
      if (r < rows_here) {
        const T* qrow = qbase + static_cast<size_t>(r) * D;
        if constexpr (ROPE) {
          const float x = ptt::to_f(qrow[d]);
          const float rot = d < half ? -ptt::to_f(qrow[d + half]) : ptt::to_f(qrow[d - half]);
          val = ptt::rope_val<T>(x, rot, cos_t[static_cast<size_t>(b) * D + d], sin_t[static_cast<size_t>(b) * D + d]);
        } else {
          val = ptt::to_f(qrow[d]);
        }
        val *= qscale;
      }
      q_s[idx] = val;
    }
    hp::named_barrier(1, kWarps * 32);  // q is staged (the producer does not wait for it)

    // each stage: warp w takes positions w, w + 4, ..., in batches of 4
    int st = 0;
    uint32_t ph = 0;
    for (int p0 = beg; p0 < end; p0 += sp) {
      const int n = min(sp, end - p0);
      hp::mbar_wait(&full[st], ph);
      const unsigned char* base = ring + st * L.stage;
      const KV* kbox = reinterpret_cast<const KV*>(base);
      const KV* vbox = reinterpret_cast<const KV*>(base + L.v_off);
      const float* sbox = reinterpret_cast<const float*>(base + L.s_off);
      for (int t0 = warp; t0 < n; t0 += 4 * kWarps) {
        bool valid[4];
        float s[kRows][4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          valid[k] = t0 + kWarps * k < n;
#pragma unroll
          for (int r = 0; r < kRows; ++r) s[r][k] = 0.f;
        }
        // the scores: lane partials over its 2 columns of each 64-column unit
        for (int u = 2 * lane; u < D; u += 64) {
          float2 qv[kRows];
#pragma unroll
          for (int r = 0; r < kRows; ++r) qv[r] = *reinterpret_cast<const float2*>(q_s + r * D + u);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (!valid[k]) continue;
            const float2 kv = load2<KV>(kbox + (t0 + kWarps * k) * D + u);
#pragma unroll
            for (int r = 0; r < kRows; ++r) s[r][k] = fmaf(qv[r].y, kv.y, fmaf(qv[r].x, kv.x, s[r][k]));
          }
        }
        // lane l holds position kk = l / 8 of the batch: its score, then its p
        const int kk = lane >> 3, t = t0 + kWarps * kk;
        const bool mine = t < n;
        float pv[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          float x = warp_sum4(s[r], lane);
          if constexpr (kQuant) x = mine ? __fmul_rn(x, sbox[t]) : x;
          x = mine ? x : kNegInf;
          float mx = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 8));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
          mx = fmaxf(m[r], mx);
          const float p = mine ? exp2f(x - mx) : 0.f;
          float psum = p + __shfl_xor_sync(0xffffffffu, p, 8);
          psum += __shfl_xor_sync(0xffffffffu, psum, 16);
          const float alpha = exp2f(m[r] - mx);
          l[r] = l[r] * alpha + psum;
          m[r] = mx;
          pv[r] = kQuant && mine ? __fmul_rn(p, sbox[sp + t]) : p;
#pragma unroll
          for (int u = 0; u < kUnits; ++u) {
            acc[r][u][0] *= alpha;
            acc[r][u][1] *= alpha;
          }
        }
        // acc += p V over the CTA's columns
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (!valid[k]) continue;
          float pk[kRows];
#pragma unroll
          for (int r = 0; r < kRows; ++r) pk[r] = __shfl_sync(0xffffffffu, pv[r], 8 * k);
          const KV* vrow = vbox + (t0 + kWarps * k) * cols_here + 2 * lane;
#pragma unroll
          for (int u = 0; u < kUnits; ++u) {
            if (u * 64 >= cols_here) break;
            const float2 v = load2<KV>(vrow + u * 64);
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              acc[r][u][0] = fmaf(pk[r], v.x, acc[r][u][0]);
              acc[r][u][1] = fmaf(pk[r], v.y, acc[r][u][1]);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(&empty[st]);
      if (++st == stages) {
        st = 0;
        ph ^= 1;
      }
    }
  }
  __syncthreads();  // every stage was consumed: the ring's bytes take the partials

  // the warps' partials, then the CTA's: the warps merged in warp order;
  // a warp (or CTA) that visited nothing holds m = -1e30, l = 0, acc = 0
  // (m is in log2 units: scores times log2(e))
  float* pw = reinterpret_cast<float*>(ring);  // [kWarps][kRows][cols]
  float* pw_m = pw + kWarps * kRows * cols;    // [kWarps][kRows]
  float* pw_l = pw_m + kWarps * kRows;
  float* ca = pw_l + kWarps * kRows;           // [kRows][cols]
  float* cm = ca + kRows * cols;               // [kRows]
  float* cl = cm + kRows;
  if (warp < kWarps) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (lane == 0) {
        pw_m[warp * kRows + r] = m[r];
        pw_l[warp * kRows + r] = l[r];
      }
#pragma unroll
      for (int u = 0; u < kUnits; ++u)
        if (u * 64 < cols_here)
          *reinterpret_cast<float2*>(pw + (warp * kRows + r) * cols + u * 64 + 2 * lane) =
              make_float2(acc[r][u][0], acc[r][u][1]);
    }
  }
  __syncthreads();
  for (int idx = tid; idx < rows_here * cols_here; idx += kThreads) {
    const int r = idx / cols_here, c = idx - r * cols_here;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, pw_m[w * kRows + r]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = pw_m[w * kRows + r];
      const float f = mw > kNegInf ? exp2f(mw - M) : 0.f;
      lsum += f * pw_l[w * kRows + r];
      a += f * pw[(w * kRows + r) * cols + c];
    }
    ca[r * cols + c] = a;
    if (c == 0) {
      cm[r] = M;
      cl[r] = lsum;
    }
  }
  cluster.sync();  // every rank's partial is written

  // each row's weights over the ranks, in rank order
  if (tid < rows_here) {
    const int r = tid;
    float mk[kMaxRanks], lk[kMaxRanks];
#pragma unroll
    for (int k = 0; k < kMaxRanks; ++k) {
      mk[k] = k < ranks ? *cluster.map_shared_rank(&cm[r], k) : kNegInf;
      lk[k] = k < ranks ? *cluster.map_shared_rank(&cl[r], k) : 0.f;
    }
    float M = kNegInf;
#pragma unroll
    for (int k = 0; k < kMaxRanks; ++k) M = fmaxf(M, mk[k]);
    float lsum = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxRanks; ++k) {
      const float w = mk[k] > kNegInf ? exp2f(mk[k] - M) : 0.f;  // a rank that saw nothing adds exactly nothing
      w_s[r][k] = w;
      if (w != 0.f) lsum += w * lk[k];
    }
    den_s[r] = fmaxf(lsum, 1e-30f);
  }
  __syncthreads();
  // this rank's contiguous share of the group's outputs
  const int total = rows_here * cols_here, chunk = (total + ranks - 1) / ranks;
  const int e1 = min(total, (rank + 1) * chunk);
  for (int e = rank * chunk + tid; e < e1; e += kThreads) {
    const int r = e / cols_here, c = e - r * cols_here;
    float o = 0.f;
    for (int k = 0; k < ranks; ++k) {
      const float w = w_s[r][k];
      if (w != 0.f) o += w * cluster.map_shared_rank(ca, k)[r * cols + c];
    }
    out[(static_cast<size_t>(b) * HQ + h * G + g0 + r) * D + col0 + c] = ptt::from_f<T>(o / den_s[r]);
  }
  cluster.sync();  // no rank leaves while another still reads its shared memory
}

// One launch of kernel 5 (ROPE off) or 6 as clusters of `ranks` CTAs per
// (row group, column slice, KV head, slot): the plan of paged_attention.py
// `decode_plan` (rows query heads a CTA, O's columns over `split` CTAs of
// `cols` each, sp positions a stage, `stages` stages). With cap non-null
// nothing launches: cap[r - 1] is written the clusters of r CTAs of this
// instance that the card holds at once, for r = 1 .. kMaxRanks.
template <typename T, typename KV, int kUnits, int kRows, bool ROPE>
int launch_inst(const void* q, const void* cos_t, const void* sin_t, const void* kc, const void* vc, const void* ks,
                const void* vs, const void* tables, const void* lens, void* out, int B, int HQ, int HKV, int D,
                int BS, int MBS, int rows, int split, int cols, int ranks, int sp, int stages, float scale,
                cudaStream_t st, int* cap) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  auto kernel = paged_decode_kernel<T, KV, kUnits, kRows, ROPE>;
  const Layout L = layout_of(D, cols, kRows, sp, stages, static_cast<int>(sizeof(KV)), kQuant);
  const int err = ptt::allow_smem(kernel, L.total);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (cap != nullptr) {
    for (int r = 1; r <= kMaxRanks; ++r) {
      cfg.gridDim = dim3(r, 1, 1);
      attr[0].val.clusterDim.x = r;
      const cudaError_t e = cudaOccupancyMaxActiveClusters(&cap[r - 1], reinterpret_cast<const void*>(kernel), &cfg);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    return 0;
  }
  const int G = HQ / HKV;
  if (ranks < 1 || ranks > kMaxRanks || rows < 1 || rows > kRows || sp < 1 || sp > kMaxStageRows || stages < 2 ||
      split < 1 || (split - 1) * cols >= D || split * cols < D)
    return static_cast<int>(cudaErrorInvalidValue);
  cfg.gridDim = dim3(((G + rows - 1) / rows) * split * ranks, HKV, B);
  attr[0].val.clusterDim.x = ranks;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(q), static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<const KV*>(kc), static_cast<const KV*>(vc), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(tables), static_cast<const int*>(lens),
      static_cast<T*>(out), HQ, HKV, D, BS, MBS, rows, split, cols, ranks, sp, stages, scale);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// the instance that holds `cols` columns (2, 4 or 8 units of 64) and `rows`
// query rows (1, or 4 up to 256 columns and 2 above)
template <typename T, typename KV, bool ROPE>
int launch(const void* q, const void* cos_t, const void* sin_t, const void* kc, const void* vc, const void* ks,
           const void* vs, const void* tables, const void* lens, void* out, int B, int HQ, int HKV, int D, int BS,
           int MBS, int rows, int split, int cols, int ranks, int sp, int stages, float scale, cudaStream_t st,
           int* cap) {
  if (D < 64 || D % 64 || cols < 64 || cols % 64 || cols > 512 || HKV < 1 || HQ % HKV)
    return static_cast<int>(cudaErrorInvalidValue);
#define PTT_INST(UNITS, ROWS)                                                                                     \
  launch_inst<T, KV, UNITS, ROWS, ROPE>(q, cos_t, sin_t, kc, vc, ks, vs, tables, lens, out, B, HQ, HKV, D, BS, \
                                        MBS, rows, split, cols, ranks, sp, stages, scale, st, cap)
  if (cols <= 128) return rows == 1 ? PTT_INST(2, 1) : PTT_INST(2, 4);
  if (cols <= 256) return rows == 1 ? PTT_INST(4, 1) : PTT_INST(4, 4);
  return rows == 1 ? PTT_INST(8, 1) : PTT_INST(8, 2);
#undef PTT_INST
}

// QUANT: the cache is int8 with scale planes; else it is of q's type
template <bool ROPE, bool QUANT>
int launch_io(int io, const void* q, const void* cos_t, const void* sin_t, const void* kc, const void* vc,
              const void* ks, const void* vs, const void* tables, const void* lens, void* out, int B, int HQ,
              int HKV, int D, int BS, int MBS, int rows, int split, int cols, int ranks, int sp, int stages,
              float scale, void* stream, int* cap) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PTT_IO(TYPE)                                                                                             \
  launch<TYPE, std::conditional_t<QUANT, int8_t, TYPE>, ROPE>(q, cos_t, sin_t, kc, vc, ks, vs, tables, lens, out, \
                                                              B, HQ, HKV, D, BS, MBS, rows, split, cols, ranks,   \
                                                              sp, stages, scale, st, cap)
  switch (io) {
    case ptt::kBF16:
      return PTT_IO(bf16);
    case ptt::kF16:
      return PTT_IO(f16);
    case ptt::kF32:
      return PTT_IO(float);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PTT_IO
}

}  // namespace

// Kernel 5. `io` is the storage type (ptt::IoType); the ints after MBS are
// paged_attention.py `decode_plan`'s: rows (query heads a CTA), split (CTAs
// over O's columns), cols (columns a CTA), ranks (the cluster size), sp
// (positions a stage) and stages. Returns cudaErrorInvalidValue for a head
// dim that is not a multiple of 64, a plan the instances do not hold, or an
// unknown type.
extern "C" int ptt_paged_decode(int io, const void* q, const void* kc, const void* vc, const void* tables,
                                const void* lens, void* out, int B, int HQ, int HKV, int D, int BS, int MBS, int rows,
                                int split, int cols, int ranks, int sp, int stages, float scale, void* stream) {
  return launch_io<false, false>(io, q, nullptr, nullptr, kc, vc, nullptr, nullptr, tables, lens, out, B, HQ, HKV, D,
                                 BS, MBS, rows, split, cols, ranks, sp, stages, scale, stream, nullptr);
}

// Kernel 6: kernel 5 with q roped first; cos/sin are the slots' fp32 rope
// rows [B, D], rounded to q's type as they are read.
extern "C" int ptt_paged_decode_fused(int io, const void* q, const void* cos_t, const void* sin_t, const void* kc,
                                      const void* vc, const void* tables, const void* lens, void* out, int B, int HQ,
                                      int HKV, int D, int BS, int MBS, int rows, int split, int cols, int ranks,
                                      int sp, int stages, float scale, void* stream) {
  return launch_io<true, false>(io, q, cos_t, sin_t, kc, vc, nullptr, nullptr, tables, lens, out, B, HQ, HKV, D, BS,
                                MBS, rows, split, cols, ranks, sp, stages, scale, stream, nullptr);
}

// Kernel 5 over the int8 pool: kc/vc int8 [NB, HKV, BS, D], ks/vs fp32
// [NB, HKV, BS]; `io` is the type of q and out.
extern "C" int ptt_paged_decode_int8(int io, const void* q, const void* kc, const void* vc, const void* ks,
                                     const void* vs, const void* tables, const void* lens, void* out, int B, int HQ,
                                     int HKV, int D, int BS, int MBS, int rows, int split, int cols, int ranks,
                                     int sp, int stages, float scale, void* stream) {
  return launch_io<false, true>(io, q, nullptr, nullptr, kc, vc, ks, vs, tables, lens, out, B, HQ, HKV, D, BS, MBS,
                                rows, split, cols, ranks, sp, stages, scale, stream, nullptr);
}

// Kernel 6 over the int8 pool.
extern "C" int ptt_paged_decode_fused_int8(int io, const void* q, const void* cos_t, const void* sin_t,
                                           const void* kc, const void* vc, const void* ks, const void* vs,
                                           const void* tables, const void* lens, void* out, int B, int HQ, int HKV,
                                           int D, int BS, int MBS, int rows, int split, int cols, int ranks, int sp,
                                           int stages, float scale, void* stream) {
  return launch_io<true, true>(io, q, cos_t, sin_t, kc, vc, ks, vs, tables, lens, out, B, HQ, HKV, D, BS, MBS, rows,
                               split, cols, ranks, sp, stages, scale, stream, nullptr);
}

// The clusters of kernel 5's (rope 0) or 6's (rope 1) instance for this
// type, pool (quant 1: int8), head dim and stage geometry that the card
// holds at once, for every cluster size r = 1 .. 8, written to the host
// ints cap[r - 1]: the caps of paged_attention.py `decode_plan`. Returns a
// CUDA error; launches nothing.
extern "C" int ptt_paged_decode_cap(int io, int quant, int rope, int D, int rows, int cols, int sp, int stages,
                                    int* cap) {
#define PTT_CAP(ROPE, QUANT)                                                                                      \
  launch_io<ROPE, QUANT>(io, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,   \
                         nullptr, 1, 1, 1, D, 1, 1, rows, 1, cols, 1, sp, stages, 1.f, nullptr, cap)
  return rope ? (quant ? PTT_CAP(true, true) : PTT_CAP(true, false))
              : (quant ? PTT_CAP(false, true) : PTT_CAP(false, false));
#undef PTT_CAP
}
