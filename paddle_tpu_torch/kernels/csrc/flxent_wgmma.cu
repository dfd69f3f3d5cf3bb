// Fused linear cross entropy on Hopper's tensor cores: the forward's
// partials (kernel 17), the D recompute that kernels 18 and 19 share, dX
// (kernel 18) and dW (kernel 19), four products on one warp-specialised,
// persistent wgmma mainloop fed by TMA, each with its own epilogue. The
// forward is one launch over the whole vocab; the backward, per vocab chunk
// of Vc columns (the wrapper, kernels/fused_loss.py `flxent_bwd`, walks the
// chunks in order):
//   fwd = per row and 128-column vocab tile, the partials (max, sum of exp
//         over it, target logit) of the logits x W, NEG_INF at columns >= V
//                                                  [3, ceil(V/128), N] (K = H)
//   D   = ((exp(x W_c - lse) - onehot) * gcoef), rounded to x's type, 0 at
//         columns >= V                            [N, Vc]  (K = H)
//   dX += D W_c^T, fp32 partials, x's type on the last chunk  [N, H]  (K = Vc)
//   dW_c = x^T D, or D^T x when vocab-major, in W's type      (K = N)
//
// Replaces: paddle_tpu/kernels/fused_loss.py `_flxent_fwd_kernel` (:261),
// `_flxent_block_d` (:302, the recompute inside its dX and dW kernels),
// `_flxent_dx_kernel` (:322) and `_flxent_dw_kernel` (:343), launched by
// `_make_pallas_core`: the training step's loss head. Its bf16 / fp16
// instance for W whose rows TMA can address (kernels/fused_loss.py
// `flx_route` "wgmma"); W [H, V] with V % 8 != 0, or W not 16-byte aligned,
// runs flxent_common.cuh's mma.sync mainloop, fp32 the CUDA-core instance
// (flxent_fp32.cu).
//
#include "flxent_common.cuh"
#include "hopper.cuh"

using ptt::bf16;
using ptt::f16;
namespace hp = ptt::hopper;

namespace {

constexpr int kBM = 128;                    // tile rows (64 per consumer warpgroup)
constexpr int kBN = 256;                    // tile columns (a half tile: 128)
constexpr int kBK = 64;                     // k per ring stage: one 128-byte row of 2-byte values
constexpr int kStages = 4;
constexpr int kConsumers = 256;             // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup (one thread of it works)
constexpr int kConsumerWarps = kConsumers / 32;
// Registers a thread: the launch gives each of the 384 threads 168;
// setmaxnreg moves them from the producer warpgroup to the consumers.
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = (168 * kThreads - kConsumers * kConsumerRegs) / 128;
static_assert(kProducerRegs >= 24 && kProducerRegs % 8 == 0, "setmaxnreg takes 24..256 in steps of 8");
constexpr int kBox = 64 * 128;              // one [64][64] box of 2-byte values
constexpr int kABytes = kBM * kBK * 2;      // 16 KB
constexpr int kBBytes = kBN * kBK * 2;      // 32 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kOut = kStages * kStageBytes;  // the epilogue's boxes: 2 a warpgroup
constexpr int kBar = kOut + 4 * kBox;
constexpr int kSmemBytes = kBar + 2 * kStages * 8 + 1024;  // + alignment slack
static_assert(kSmemBytes <= 227 * 1024, "a block's shared memory");
constexpr int kGroup = 16;                  // row tiles per sweep (L2 reuse)
constexpr int kCostBig = 8, kCostHalf = 5;  // a half tile's cost relative to a whole one (kernel 20's)

enum Product : int { kD = 0, kDx = 1, kDw = 2, kFwd = 3 };

// The work items of one launch, in order: [0, big) whole 128 x 256 tiles,
// t = i in the grouped order; then both 128-column halves of tiles big,
// big + 1, ... A persistent CTA b takes items b, b + grid, ...
struct Plan {
  int tiles_m, tiles_n;  // 128-row and 256-column tiles of the output
  int big;               // whole tiles
  int items;             // all items
  int grid;              // CTAs
};

struct Item {
  int m0, n0;
  bool half;
};

__host__ __device__ __forceinline__ Item item_at(const Plan& p, int i) {
  const bool half = i >= p.big;
  const int t = half ? p.big + (i - p.big) / 2 : i;
  const int per_group = kGroup * p.tiles_n;
  const int first = (t / per_group) * kGroup;
  const int size = p.tiles_m - first < kGroup ? p.tiles_m - first : kGroup;
  const int in = t % per_group;
  return Item{(first + in % size) * kBM, (in / size) * kBN + (half ? ((i - p.big) & 1) * (kBN / 2) : 0), half};
}

// The plan of an [M, N] output on `sms` SMs: whole tiles, or the tiles past
// the last full round split in halves where that shortens the longest CTA.
inline Plan make_plan(int M, int N, int sms) {
  Plan p;
  p.tiles_m = (M + kBM - 1) / kBM;
  p.tiles_n = (N + kBN - 1) / kBN;
  const int whole = p.tiles_m * p.tiles_n;
  const int keep = whole - whole % sms;
  const int items_split = keep + 2 * (whole - keep);
  const int grid_all = whole < sms ? whole : sms;
  const int grid_split = items_split < sms ? items_split : sms;
  if (keep < whole && hp::plan_makespan(keep, items_split, grid_split, kCostBig, kCostHalf) <
                          hp::plan_makespan(whole, whole, grid_all, kCostBig, kCostHalf)) {
    p.big = keep, p.items = items_split, p.grid = grid_split;
  } else {
    p.big = whole, p.items = whole, p.grid = grid_all;
  }
  return p;
}

// What a launch computes beyond its operands: the output's extent, the
// chunk's place in W, and each epilogue's inputs.
struct Params {
  int M, N, K;        // output rows and columns, reduction extent
  int b_noff, b_koff;  // B's coordinates in its map: n + b_noff, k + b_koff (W's chunk)
  // D: per row the label, lse and gcoef; the chunk's first vocab column
  const int* labels;
  const float* lse;
  const float* gcoef;
  int c0;
  // dX: the fp32 partial [M, N] of the chunks before; first: none yet;
  // last: write x's type through the output map
  float* acc;
  int first, last;
  // fwd: the partials [3, ceil(N / 128), M] (labels as for D, c0 = 0)
  float* part;
  Plan plan;
};

// A slab's ring stage and the parity of its pass over the ring
struct RingPos {
  uint32_t stage, phase;
};

__device__ __forceinline__ RingPos ring_next(RingPos p) {
  return p.stage + 1 == kStages ? RingPos{0, p.phase ^ 1} : RingPos{p.stage + 1, p.phase};
}

// One consumer warpgroup's walk over an item's k steps: acc (its 64 rows x
// NB columns; a half tile uses the first 64 accumulators) = A B. One wgmma
// group a k step (4 k16 products), one group in flight: a stage is released
// once the group after it has been issued and its own has retired. `pos` is the ring position of the item's first slab,
// and on return that of the next item's.
template <typename T, bool A_K, bool B_K, int NB>
__device__ __forceinline__ void mainloop(float (&acc)[kBN / 2], uint32_t sm, uint64_t* full, uint64_t* empty,
                                         RingPos& pos, int nk, int wg, int lane) {
  // K-major: 32 bytes a k16 step; MN-major: 16 rows of 128 bytes
  constexpr uint64_t kAStep = (A_K ? 32 : 2048) >> 4, kBStep = (B_K ? 32 : 2048) >> 4;
  constexpr uint32_t kALbo = A_K ? 16 : kBox, kBLbo = B_K ? 16 : kBox;
  RingPos cur = pos, prev = pos;
  for (int ks = 0; ks < nk; ++ks) {
    hp::mbar_wait(&full[cur.stage], cur.phase);
    const uint32_t a = sm + cur.stage * kStageBytes + wg * (kABytes / 2);
    const uint64_t da = hp::desc_sw128_at(a, kALbo, 1024);
    const uint64_t db = hp::desc_sw128_at(sm + cur.stage * kStageBytes + kABytes, kBLbo, 1024);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      hp::wgmma_ss_t<T, NB, A_K ? 0 : 1, B_K ? 0 : 1>(acc, da + kk * kAStep, db + kk * kBStep, (ks | kk) != 0);
    hp::wgmma_commit();
    hp::wgmma_wait<1>();
    if (ks > 0) {  // the previous stage's group has retired
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(&empty[prev.stage]);
    }
    prev = cur;
    cur = ring_next(cur);
  }
  hp::wgmma_wait<0>();
  hp::fence_regs(acc);
  __syncwarp();
  if (lane == 0) hp::mbar_arrive(&empty[prev.stage]);
  pos = cur;
}

// The epilogue of one tile, 64 columns (one staging box) at a time, so
// that no more than a box's loads and rounded values are live beside the
// accumulators. acc[4 j + e] is row r + 8 (e >> 1) (r = m0 + 16 warp + gid,
// m0 the warpgroup's first row), column n0 + 8 j + 2 tig + (e & 1).
//   D:  (exp(logit - lse) - onehot) * gcoef, 0 past the chunk (p.N);
//   dX: plus the fp32 partial of the chunks before (not on the first);
//       before the last chunk the sum goes back out as the new partial
//       (float2 stores) and nothing is rounded;
//   dW: as it is.
// A value in T goes out through the warpgroup's two staging boxes in turn:
// each [64 rows][64 columns] box is written 128-byte swizzled (chunk c of
// row q at c ^ (q % 8): a warp's 32 lanes hit 32 banks), then stored by one
// TMA store from the warpgroup's first thread. `boxes` counts the
// warpgroup's boxes so far (which buffer is next).
template <typename T, int NB, int PROD>
__device__ __forceinline__ void epilogue(float (&acc)[kBN / 2], const Params& p, const CUtensorMap* map,
                                         unsigned char* out, int m0, int n0, int wl, int gid, int tig, bool issuer,
                                         int bar_id, int& boxes) {
  constexpr float kLog2e = 1.4426950408889634f;
  const int r = m0 + 16 * wl + gid;
  float ls[2] = {0.f, 0.f}, g[2] = {0.f, 0.f};  // D: lse * log2(e) and gcoef of the thread's two rows
  int lab[2] = {-1, -1};  // the label as a column of this chunk
  if constexpr (PROD == kD) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 8 * h;
      if (row < p.M) ls[h] = p.lse[row] * kLog2e, g[h] = p.gcoef[row], lab[h] = p.labels[row] - p.c0;
    }
  }
  const bool partial = PROD == kDx && !p.last;
  const int q = 16 * wl + gid;  // the row within the staging box (and q + 8)
#pragma unroll
  for (int b = 0; b < NB / 64; ++b) {
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int j = 8 * b + jj;
      const int col = n0 + 8 * j + 2 * tig;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float& v0 = acc[4 * j + 2 * h];
        float& v1 = acc[4 * j + 2 * h + 1];
        if constexpr (PROD == kD) {  // exp as 2^(logit log2(e) - lse log2(e)): accurate to a few fp32 ulps
          v0 = ((col < p.N ? hp::exp2_approx(fmaf(v0, kLog2e, -ls[h])) : 0.f) -
                (col < p.N && col == lab[h] ? 1.f : 0.f)) * g[h];
          v1 = ((col + 1 < p.N ? hp::exp2_approx(fmaf(v1, kLog2e, -ls[h])) : 0.f) -
                (col + 1 < p.N && col + 1 == lab[h] ? 1.f : 0.f)) * g[h];
        }
        if constexpr (PROD == kDx) {
          const int row = r + 8 * h;
          if (row < p.M && col < p.N) {  // N % 8 == 0: a pair is in or out whole
            float* at = p.acc + static_cast<size_t>(row) * p.N + col;
            if (!p.first) {
              const float2 o = *reinterpret_cast<const float2*>(at);
              v0 += o.x;
              v1 += o.y;
            }
            if (partial) *reinterpret_cast<float2*>(at) = make_float2(v0, v1);
          }
        }
      }
    }
    asm volatile("" ::: "memory");  // the next box's loads stay below this one's stores
    if (partial) continue;
    unsigned char* buf = out + (boxes & 1) * kBox;
    if (issuer) hp::bulk_wait_read<1>();  // the store that last read this buffer is done with it
    hp::named_barrier(bar_id, 128);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = q + 8 * h, j = 8 * b + jj;
        *reinterpret_cast<uint32_t*>(buf + row * 128 + ((jj ^ (row & 7)) << 4) + tig * 4) =
            hp::pack2<T>(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
    hp::fence_proxy_async();
    hp::named_barrier(bar_id, 128);
    if (issuer) {
      hp::tma_store_2d(map, buf, n0 + 64 * b, m0);
      hp::bulk_commit();
    }
    ++boxes;
  }
}

// The forward's epilogue (kernel 17): per row of the tile and per 128-column
// half, the partials of the logits (columns < N only) into p.part at the
// half's partial column (n0 / 128 + half), from registers. acc[4 j + e] is
// row r + 8 (e >> 1), column n0 + 8 j + 2 tig + (e & 1), as in `epilogue`.
// One 64-column box at a time: the row's max over the box, then its exps
// over the running max (earlier boxes' sum rescaled), behind a compiler
// memory barrier so that no more than a box's values are live beside the
// accumulators. The quad's four threads (tig 0-3) then merge their states.
template <int NB>
__device__ __forceinline__ void fwd_epilogue(float (&acc)[kBN / 2], const Params& p, int m0, int n0, int wl, int gid,
                                             int tig) {
  constexpr float kLog2e = 1.4426950408889634f;
  constexpr float kNegInf = -1e30f;  // the Pallas kernels' NEG_INF
  const int r = m0 + 16 * wl + gid;
  int lab[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) lab[h] = r + 8 * h < p.M ? p.labels[r + 8 * h] : -1;
  const size_t stride = static_cast<size_t>((p.N + 127) / 128) * p.M;
#pragma unroll
  for (int half = 0; half < NB / 128; ++half) {
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, t[2] = {0.f, 0.f};
#pragma unroll
    for (int bb = 0; bb < 2; ++bb) {
      const int b = 2 * half + bb;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float bm = kNegInf;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = 8 * b + jj, col = n0 + 8 * j + 2 * tig;
          float& v0 = acc[4 * j + 2 * h];
          float& v1 = acc[4 * j + 2 * h + 1];
          if (col >= p.N) v0 = kNegInf;  // TMA read zeros past V
          if (col + 1 >= p.N) v1 = kNegInf;
          if (col < p.N && col == lab[h]) t[h] += v0;
          if (col + 1 < p.N && col + 1 == lab[h]) t[h] += v1;
          bm = fmaxf(bm, fmaxf(v0, v1));
        }
        const float mn = fmaxf(m[h], bm), ml = mn * kLog2e;
        float s = l[h] * hp::exp2_approx((m[h] - mn) * kLog2e);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = 8 * b + jj;
          s += hp::exp2_approx(fmaf(acc[4 * j + 2 * h], kLog2e, -ml)) +
               hp::exp2_approx(fmaf(acc[4 * j + 2 * h + 1], kLog2e, -ml));
        }
        m[h] = mn;
        l[h] = s;
      }
      asm volatile("" ::: "memory");  // the next box's values stay below this one's sums
    }
    const int c = n0 + 128 * half;  // the half's first column: its partial column is c / 128
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mq = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
      mq = fmaxf(mq, __shfl_xor_sync(0xffffffffu, mq, 2));
      float lq = l[h] * hp::exp2_approx((m[h] - mq) * kLog2e);
      lq += __shfl_xor_sync(0xffffffffu, lq, 1);
      lq += __shfl_xor_sync(0xffffffffu, lq, 2);
      float tq = t[h] + __shfl_xor_sync(0xffffffffu, t[h], 1);
      tq += __shfl_xor_sync(0xffffffffu, tq, 2);
      const int row = r + 8 * h;
      if (tig == 0 && row < p.M && c < p.N) {
        const size_t at = static_cast<size_t>(c / 128) * p.M + row;
        p.part[at] = mq;
        p.part[stride + at] = lq;
        p.part[2 * stride + at] = tq;
      }
    }
  }
}

// The body of both kernels below: the forward (kFwd, its own kernel name, so
// that profiles tell kernel 17 from 18 and 19) and D, dX, dW.
template <typename T, bool A_K, bool B_K, int PROD>
__device__ __forceinline__ void wgmma_body(const CUtensorMap* tm_a, const CUtensorMap* tm_b,
                                           const CUtensorMap* tm_out, const Params& p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + kBar);
  uint64_t* empty = full + kStages;
  const int nk = (p.K + kBK - 1) / kBK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(&full[s], 1);                // the producer's arrival + the boxes' bytes
      hp::mbar_init(&empty[s], kConsumerWarps);  // one arrival per consumer warp
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    hp::reg_dealloc<kProducerRegs>();
    if (warp > kConsumerWarps || lane != 0) return;  // one thread issues every copy
    // ---- producer: per item, per k step, A's box(es) and B's boxes ----
    hp::tma_prefetch(tm_a);
    hp::tma_prefetch(tm_b);
    uint32_t s = 0, phase = 0;  // the ring position of the next slab
    for (int i = blockIdx.x; i < p.plan.items; i += gridDim.x) {
      const Item it = item_at(p.plan, i);
      if (it.n0 >= p.N) continue;  // the empty half of a ragged last column tile
      const int nb = it.half ? kBN / 2 : kBN;
      for (int ks = 0; ks < nk; ++ks) {
        const int k0 = ks * kBK;
        hp::mbar_wait(&empty[s], phase ^ 1);  // the slot's last slab is consumed
        hp::mbar_arrive_expect_tx(&full[s], kABytes + nb * kBK * 2);
        unsigned char* a = sm + s * kStageBytes;
        unsigned char* b = a + kABytes;
        if (A_K) {  // [128 rows][64 k]
          hp::tma_load_2d(a, tm_a, &full[s], k0, it.m0);
        } else {    // [64 k][64 rows], twice
          hp::tma_load_2d(a, tm_a, &full[s], it.m0, k0);
          hp::tma_load_2d(a + kBox, tm_a, &full[s], it.m0 + 64, k0);
        }
        if (B_K) {  // [128 columns][64 k], once or twice
          for (int j = 0; j < nb / 128; ++j)
            hp::tma_load_2d(b + j * (kBBytes / 2), tm_b, &full[s], k0 + p.b_koff, it.n0 + p.b_noff + 128 * j);
        } else {    // [64 k][64 columns], two or four times
          for (int j = 0; j < nb / 64; ++j)
            hp::tma_load_2d(b + j * kBox, tm_b, &full[s], it.n0 + p.b_noff + 64 * j, k0 + p.b_koff);
        }
        if (++s == kStages) s = 0, phase ^= 1;
      }
    }
    return;
  }

  hp::reg_alloc<kConsumerRegs>();
  // ---- consumer warpgroups: 64 tile rows each ----
  const int wg = warp >> 2, wl = warp & 3, gid = lane >> 2, tig = lane & 3;
  const bool issuer = (threadIdx.x & 127) == 0;
  const uint32_t sm32 = hp::smem_u32(sm);
  unsigned char* out = sm + kOut + wg * 2 * kBox;
  int boxes = 0;
  RingPos pos{0, 0};
  float acc[kBN / 2];
  for (int i = blockIdx.x; i < p.plan.items; i += gridDim.x) {
    const Item it = item_at(p.plan, i);
    if (it.n0 >= p.N) continue;
    const int m0 = it.m0 + 64 * wg;
    if (it.half) {
      mainloop<T, A_K, B_K, kBN / 2>(acc, sm32, full, empty, pos, nk, wg, lane);
      if constexpr (PROD == kFwd) {
        fwd_epilogue<kBN / 2>(acc, p, m0, it.n0, wl, gid, tig);
      } else {
        epilogue<T, kBN / 2, PROD>(acc, p, tm_out, out, m0, it.n0, wl, gid, tig, issuer, 1 + wg, boxes);
      }
    } else {
      mainloop<T, A_K, B_K, kBN>(acc, sm32, full, empty, pos, nk, wg, lane);
      if constexpr (PROD == kFwd) {
        fwd_epilogue<kBN>(acc, p, m0, it.n0, wl, gid, tig);
      } else {
        epilogue<T, kBN, PROD>(acc, p, tm_out, out, m0, it.n0, wl, gid, tig, issuer, 1 + wg, boxes);
      }
    }
  }
  if (issuer) hp::tma_store_wait_all();  // every store has left shared memory before the CTA exits
}

template <typename T, bool A_K, bool B_K, int PROD>
__global__ void __launch_bounds__(kThreads, 1)
flxent_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
                    const __grid_constant__ CUtensorMap tm_out, const Params p) {
  wgmma_body<T, A_K, B_K, PROD>(&tm_a, &tm_b, &tm_out, p);
}

template <typename T, bool B_K>
__global__ void __launch_bounds__(kThreads, 1)
flxent_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
                        const Params p) {
  wgmma_body<T, true, B_K, kFwd>(&tm_a, &tm_b, &tm_b, p);
}

// The map of a row-major [rows, cols] matrix of T (`ld` elements a row) in
// boxes of box_rows x 64
template <typename T>
int map_of(CUtensorMap* m, const void* base, int rows, int cols, long long ld, int box_rows) {
  return hp::encode_2d(m, hp::tma_dtype<T>(), base, rows, cols, ld * 2, box_rows, 64);
}

template <typename T, bool A_K, bool B_K, int PROD>
int launch(const CUtensorMap& ta, const CUtensorMap& tb, const CUtensorMap& tout, Params p, cudaStream_t stream) {
  int sms = 0;
  int err = hp::sm_count(&sms);
  if (err) return err;
  p.plan = make_plan(p.M, p.N, sms);
  if constexpr (PROD == kFwd) {
    auto kernel = flxent_fwd_wgmma_kernel<T, B_K>;
    err = ptt::allow_smem(kernel, kSmemBytes);
    if (!err) err = hp::check_reg_split(kernel, kThreads, kConsumers * kConsumerRegs + 128 * kProducerRegs);
    if (err) return err;
    kernel<<<p.plan.grid, kThreads, kSmemBytes, stream>>>(ta, tb, p);
  } else {
    auto kernel = flxent_wgmma_kernel<T, A_K, B_K, PROD>;
    err = ptt::allow_smem(kernel, kSmemBytes);
    if (!err) err = hp::check_reg_split(kernel, kThreads, kConsumers * kConsumerRegs + 128 * kProducerRegs);
    if (err) return err;
    kernel<<<p.plan.grid, kThreads, kSmemBytes, stream>>>(ta, tb, tout, p);
  }
  return static_cast<int>(cudaGetLastError());
}

Params params(int M, int N, int K) {
  Params p{};
  p.M = M, p.N = N, p.K = K;
  return p;
}

template <typename T>
int fwd(int vocab_major, const void* x, const void* w, const void* labels, void* part, int N, int H, int V,
        cudaStream_t stream) {
  CUtensorMap ta, tb;
  int err = map_of<T>(&ta, x, N, H, H, kBM);  // x [N][H]: K-major A
  if (!err) err = vocab_major ? map_of<T>(&tb, w, V, H, H, 128)  // W [V][H]: K-major B
                              : map_of<T>(&tb, w, H, V, V, 64);  // W [H][V]: MN-major B
  if (err) return err;
  Params p = params(N, V, H);
  p.labels = static_cast<const int*>(labels);
  p.part = static_cast<float*>(part);
  return vocab_major ? launch<T, true, true, kFwd>(ta, tb, tb, p, stream)
                     : launch<T, true, false, kFwd>(ta, tb, tb, p, stream);
}

template <typename T>
int dchunk(int vocab_major, const void* x, const void* w, const void* labels, const void* lse, const void* gcoef,
           void* d, long long ldd, int N, int H, int V, int c0, int vc, cudaStream_t stream) {
  CUtensorMap ta, tb, tout;
  int err = map_of<T>(&ta, x, N, H, H, kBM);  // x [N][H]: K-major A
  if (!err) err = vocab_major ? map_of<T>(&tb, w, V, H, H, 128)  // W [V][H]: K-major B
                              : map_of<T>(&tb, w, H, V, V, 64);  // W [H][V]: MN-major B
  if (!err) err = map_of<T>(&tout, d, N, vc, ldd, 64);
  if (err) return err;
  Params p = params(N, vc, H);
  p.b_noff = c0;
  p.labels = static_cast<const int*>(labels);
  p.lse = static_cast<const float*>(lse);
  p.gcoef = static_cast<const float*>(gcoef);
  p.c0 = c0;
  return vocab_major ? launch<T, true, true, kD>(ta, tb, tout, p, stream)
                     : launch<T, true, false, kD>(ta, tb, tout, p, stream);
}

template <typename T>
int dx_chunk(int vocab_major, const void* d, long long ldd, const void* w, void* acc, void* dx, int N, int H, int V,
             int c0, int vc, int first, int last, cudaStream_t stream) {
  CUtensorMap ta, tb, tout;
  int err = map_of<T>(&ta, d, N, vc, ldd, kBM);  // D [N][Vc]: K-major A, zero past the chunk
  if (!err) err = vocab_major ? map_of<T>(&tb, w, V, H, H, 64)   // W [V][H]: MN-major B
                              : map_of<T>(&tb, w, H, V, V, 128);  // W [H][V]: K-major B
  if (!err) err = map_of<T>(&tout, dx, N, H, H, 64);
  if (err) return err;
  Params p = params(N, H, vc);
  p.b_koff = c0;
  p.acc = static_cast<float*>(acc);
  p.first = first, p.last = last;
  return vocab_major ? launch<T, true, false, kDx>(ta, tb, tout, p, stream)
                     : launch<T, true, true, kDx>(ta, tb, tout, p, stream);
}

template <typename T>
int dw_chunk(int vocab_major, const void* x, const void* d, long long ldd, void* dw, int N, int H, int V, int c0,
             int vc, cudaStream_t stream) {
  CUtensorMap tx, td, tout;
  int err = map_of<T>(&tx, x, N, H, H, 64);  // x [N][H], MN-major as x^T (A) or as B
  if (!err) err = map_of<T>(&td, d, N, vc, ldd, 64);  // D [N][Vc], MN-major as D^T (A) or as B
  if (err) return err;
  T* out = static_cast<T*>(dw);
  if (vocab_major) {  // dW[c0 + v][h] = sum_r D[r][v] x[r][h]
    err = map_of<T>(&tout, out + static_cast<long long>(c0) * H, vc, H, H, 64);
    if (err) return err;
    return launch<T, false, false, kDw>(td, tx, tout, params(vc, H, N), stream);
  }
  err = map_of<T>(&tout, out + c0, H, vc, V, 64);  // dW[h][c0 + v] = sum_r x[r][h] D[r][v]
  if (err) return err;
  return launch<T, false, false, kDw>(tx, td, tout, params(H, vc, N), stream);
}

// the wgmma instance takes 16-bit I/O whose rows TMA can address, and a
// reduction over H > 0 (its accumulators start at the first k step)
bool mappable(int io, int vocab_major, int H, int V, long long ldd) {
  return (io == ptt::kBF16 || io == ptt::kF16) && H > 0 && H % 8 == 0 && (vocab_major || V % 8 == 0) &&
         ldd % 8 == 0;
}

}  // namespace

namespace ptt {
namespace flx {

int wgmma_fwd(int io, int vocab_major, const void* x, const void* w, const void* labels, void* part, int N, int H,
              int V, cudaStream_t s) {
  if (!mappable(io, vocab_major, H, V, 8)) return static_cast<int>(cudaErrorInvalidValue);
  return io == kF16 ? fwd<f16>(vocab_major, x, w, labels, part, N, H, V, s)
                    : fwd<bf16>(vocab_major, x, w, labels, part, N, H, V, s);
}

int wgmma_dchunk(int io, int vocab_major, const void* x, const void* w, const void* labels, const void* lse,
                 const void* gcoef, void* d, long long ldd, int N, int H, int V, int c0, int vc, cudaStream_t s) {
  if (!mappable(io, vocab_major, H, V, ldd)) return static_cast<int>(cudaErrorInvalidValue);
  return io == kF16 ? dchunk<f16>(vocab_major, x, w, labels, lse, gcoef, d, ldd, N, H, V, c0, vc, s)
                    : dchunk<bf16>(vocab_major, x, w, labels, lse, gcoef, d, ldd, N, H, V, c0, vc, s);
}

int wgmma_dx(int io, int vocab_major, const void* d, long long ldd, const void* w, void* acc, void* dx, int N, int H,
             int V, int c0, int vc, int first, int last, cudaStream_t s) {
  if (!mappable(io, vocab_major, H, V, ldd)) return static_cast<int>(cudaErrorInvalidValue);
  return io == kF16 ? dx_chunk<f16>(vocab_major, d, ldd, w, acc, dx, N, H, V, c0, vc, first, last, s)
                    : dx_chunk<bf16>(vocab_major, d, ldd, w, acc, dx, N, H, V, c0, vc, first, last, s);
}

int wgmma_dw(int io, int vocab_major, const void* x, const void* d, long long ldd, void* dw, int N, int H, int V,
             int c0, int vc, cudaStream_t s) {
  if (!mappable(io, vocab_major, H, V, ldd)) return static_cast<int>(cudaErrorInvalidValue);
  return io == kF16 ? dw_chunk<f16>(vocab_major, x, d, ldd, dw, N, H, V, c0, vc, s)
                    : dw_chunk<bf16>(vocab_major, x, d, ldd, dw, N, H, V, c0, vc, s);
}

}  // namespace flx
}  // namespace ptt

// The plan of an [M, N] output on `sms` SMs as the launches make it, for the
// host's copy (kernels/fused_loss.py `flx_plan`, `flx_items`) to be held
// against: plan = {tiles_m, tiles_n, big, items, grid}, then (first row,
// first column, columns) of items [0, min(items, cap)) into `items`.
extern "C" int ptt_flxent_plan(int M, int N, int sms, int* plan, int* items, int cap) {
  if (M <= 0 || N <= 0 || sms <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(M, N, sms);
  plan[0] = p.tiles_m, plan[1] = p.tiles_n, plan[2] = p.big, plan[3] = p.items, plan[4] = p.grid;
  for (int i = 0; i < p.items && i < cap; ++i) {
    const Item it = item_at(p, i);
    items[3 * i] = it.m0, items[3 * i + 1] = it.n0, items[3 * i + 2] = it.half ? kBN / 2 : kBN;
  }
  return 0;
}
