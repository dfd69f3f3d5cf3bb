// The wgmma RS mainloop of a product against a weight-only int8 matrix,
// shared by kernel 20 (wo_matmul.cu: out = (x @ w8) * scale) and kernel 17's
// int8 site (flxent_int8.cu: the int8 lm head's loss partials). Both compute
// the transposed tile out^T[n, m] = sum_k W^T[n, k] x^T[k, m] of x [M, K]
// (bf16 or fp16) and w8 [K, N] int8, and differ only in their epilogues, so
// the kernel body here is templated on the epilogue.
//
// - A persistent grid (one CTA an SM, items i, i + grid, ... of a plan made
//   on the host: make_plan; kernels/quant.py `wo_plan` mirrors it) of 384
//   threads: a producer thread issues, per k step of 64, the TMA loads of the
//   int8 W box [64 k][128 n] and the x box(es) [rows][64 k] (both 128-byte
//   swizzled; TMA zero-fills past M, K and N) into a ring of stages with
//   full / empty mbarriers; its warpgroup hands its registers to the
//   consumers (setmaxnreg 232 / 40; ptxas: 168 at launch).
// - Two consumer warpgroups own 64 weight columns each (m64 of wgmma). A
//   warp reads a slab's int8 bytes with two ldmatrix.x4.trans (the box read
//   as 16-bit column pairs: each lane gets [c0@k, c1@k, c0@k+1, c1@k+1],
//   conflict-free under the swizzle) and widens them to T in registers,
//   exactly (fp16: 0x6400 | (v ^ 0x80), less 1152; bf16: 0x4300 |
//   (v & 0x7F) less 0x4300 | (v & 0x80), i.e. 128 + l - 128 (1 + s), in
//   bf16x2). The fragment rows are permuted within each warp's 16 columns
//   (row i < 8 is column 2 i, row i + 8 column 2 i + 1), so a thread's two
//   rows are adjacent columns. Each k16 step is one wgmma group; the next
//   step is widened while it runs, at most 4 in flight (wait<3>), as
//   CUTLASS's mixed-input mainloop does. Widening costs ALU time that does
//   not hide under the tensor cores, so the mainloop does no other integer
//   work it can avoid: ring positions advance by increments (a stage count
//   of 5 would cost a division a slab).
// - The tile follows M (make_plan): 8 x rows for M <= 8, 64 for M <= 64,
//   else 256-row tiles (wgmma n256, two 128-row x boxes: each widened value
//   feeds 256 products), with the 256-row tiles past the last full round
//   over the SMs split into 128-row tiles where that shortens the longest
//   CTA's work. A plan left with no 256-row tile runs the 128-row instance,
//   whose ring is deeper. Rings: 16 stages of 9 KB (8 rows), 8 of 16 KB
//   (64), 8 of 24 KB (128: 197,760 bytes of shared memory with the
//   barriers), 5 of 40 KB (256: 205,904 bytes); an epilogue's own shared
//   memory follows the barriers.
//
// An epilogue is a struct with `static constexpr int kBytesPerRow` (its
// shared memory per x row of the tile) and
//   template <int NR> __device__ void apply(float (&acc)[NR / 2], const Item& it, int wg, int wl, int lane,
//                                           unsigned char* smem) const;
// acc holds the consumer's m64 x NR tile of out^T: acc[4 j + e] is weight
// column it.n0 + 64 wg + 16 wl + 2 gid + (e >> 1) (gid = lane / 4), x row
// it.m0 + 8 j + 2 tig + (e & 1) (tig = lane % 4).
#pragma once

#include <type_traits>

#include "hopper.cuh"

namespace ptt {
namespace wo {

namespace hp = ptt::hopper;

constexpr int kBN = 128;                    // weight columns per CTA tile (64 per consumer warpgroup)
constexpr int kBK = 64;                     // k per ring stage (one 128-byte row of x)
constexpr int kConsumers = 256;             // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup (one thread of it works)
constexpr int kConsumerWarps = kConsumers / 32;
// Registers a thread: the launch gives each of the 384 threads 168;
// setmaxnreg moves them from the producer warpgroup to the consumers.
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = (168 * kThreads - kConsumers * kConsumerRegs) / 128;
static_assert(kProducerRegs >= 24 && kProducerRegs % 8 == 0, "setmaxnreg takes 24..256 in steps of 8");

// The ring's layout for x tiles of up to BM rows, from a 1024-byte-aligned
// base: W boxes, x slots (BM rows, as TMA boxes of kBoxRows), then the full
// and empty barriers, then the epilogue's shared memory (kEpi).
template <int BM>
struct Wo {
  static constexpr int kBoxRows = BM == 256 ? 128 : BM;  // a TMA box has at most 256 rows; 256 comes as two
  static constexpr int kWBytes = kBK * kBN;               // int8 [64 k][128 n]
  static constexpr int kXBytes = BM * kBK * 2;
  static constexpr int kStages = BM <= 8 ? 16 : BM <= 128 ? 8 : 5;
  static constexpr int kW = 0;
  static constexpr int kX = kW + kStages * kWBytes;
  static constexpr int kBar = kX + kStages * kXBytes;
  static constexpr int kEpi = kBar + 2 * kStages * 8;
  static constexpr int kBytes = kEpi + 1024;  // + alignment slack, without the epilogue's bytes
  static_assert(kWBytes % 1024 == 0 && kBoxRows * 128 % 1024 == 0, "swizzle atoms start on 1024-byte boundaries");
};

// A launch's dynamic shared memory: the ring and the epilogue's bytes
template <int BM, typename Epi>
constexpr int smem_bytes() {
  return Wo<BM>::kBytes + Epi::kBytesPerRow * BM;
}

// The work items of one call, in launch order. Rows are cut into blocks of
// BM (the 256-row instance: pairs of 128-row blocks). Items [0, big) are
// BM-row tiles: row block i % blocks, column tile i / blocks (the x rows run
// fastest, so the CTAs in flight share a weight slab in L2). With BM 256
// the rest are 128-row tiles: both halves of each 256-row tile from `big`
// on, in the same order, then the odd last 128-row block's, one a column
// tile. A persistent CTA b takes items b, b + grid, ...
struct Plan {
  int bm;      // rows of a big item: 8, 64, 128 or 256
  int blocks;  // bm-row blocks (256: whole pairs of 128-row blocks)
  int nt;      // 128-column tiles
  int big;     // bm-row items
  int items;   // all items
  int grid;    // CTAs
};

struct Item {
  int m0, n0;
  bool big;
};

__device__ __forceinline__ Item item_at(const Plan& p, int i) {
  if (i < p.big) return Item{(i % p.blocks) * p.bm, (i / p.blocks) * kBN, true};
  const int s = i - p.big, split = 2 * (p.blocks * p.nt - p.big);
  if (s < split) {
    const int q = p.big + s / 2;
    return Item{(q % p.blocks) * p.bm + (s & 1) * (p.bm / 2), (q / p.blocks) * kBN, false};
  }
  return Item{p.blocks * p.bm, (s - split) * kBN, false};  // the odd last 128-row block
}

// The costs of a 256-row and a 128-row tile, relative (an H100 at the
// serving shapes: a 128-row tile takes ~0.63 of a 256-row one, since each
// widened weight value feeds half the products).
constexpr int kCost256 = 8, kCost128 = 5;

// The plan of an [M, K] x [K, N] call on `sms` SMs with BM-row tiles,
// every tile of BM rows.
inline Plan uniform_plan(int M, int N, int bm, int sms) {
  Plan p;
  p.bm = bm;
  p.nt = (N + kBN - 1) / kBN;
  p.blocks = (M + bm - 1) / bm;
  p.big = p.items = p.blocks * p.nt;
  p.grid = p.items < sms ? p.items : sms;
  return p;
}

// The plan of an [M, K] x [K, N] call on `sms` SMs (kernels/quant.py
// `wo_plan` mirrors it): 8-row tiles at decode sizes, 64 up to 64 rows.
// Above, 256-row tiles (each widened weight value feeds twice the products
// of a 128-row one), with those past the last full round over the SMs split
// into 128-row tiles where that shortens the longest CTA's work, and an odd
// last 128-row block; a plan left with no 256-row tile runs the 128-row
// instance (its ring is deeper).
inline Plan make_plan(int M, int N, int sms) {
  if (M <= 8) return uniform_plan(M, N, 8, sms);
  if (M <= 64) return uniform_plan(M, N, 64, sms);
  Plan p;
  p.bm = 256;
  p.nt = (N + kBN - 1) / kBN;
  const int halves = (M + 127) / 128;
  p.blocks = halves / 2;
  const int whole = p.blocks * p.nt, odd = (halves & 1) * p.nt;
  // every 256-row tile whole, or those past the last full round split
  const int grid_all = whole + odd < sms ? whole + odd : sms;
  const int keep = whole - whole % sms;
  const int items_split = keep + 2 * (whole - keep) + odd;
  const int grid_split = items_split < sms ? items_split : sms;
  if (keep < whole && hp::plan_makespan(keep, items_split, grid_split, kCost256, kCost128) <
                          hp::plan_makespan(whole, whole + odd, grid_all, kCost256, kCost128)) {
    p.big = keep, p.items = items_split, p.grid = grid_split;
  } else {
    p.big = whole, p.items = whole + odd, p.grid = grid_all;
  }
  return p.big ? p : uniform_plan(M, N, 128, sms);
}

// sub.rn.f16x2 / sub.rn.bf16x2: a - b in both halves
__device__ __forceinline__ uint32_t hsub2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.f16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t bsub2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// t holds the int8 values of two weight columns c0, c1 at two adjacent k,
// bytes [c0@k, c1@k, c0@k+1, c1@k+1]. r0 / r1 get column c0's / c1's
// (k, k+1) pair widened to T, k in the low half: the A-fragment register of
// the row each column stands for. Both forms are exact.
template <typename T>
__device__ __forceinline__ void widen_pairs(uint32_t t, uint32_t& r0, uint32_t& r1) {
  if constexpr (std::is_same<T, f16>::value) {
    // u = v ^ 0x80 = v + 128; fp16 0x64uu is 1024 + u, less 1152 (0x6480) v
    t ^= 0x80808080u;
    r0 = hsub2(__byte_perm(t, 0x64646464u, 0x4240), 0x64806480u);
    r1 = hsub2(__byte_perm(t, 0x64646464u, 0x4341), 0x64806480u);
  } else {
    // byte b = v mod 256, l = b & 0x7F, s = b >> 7 (v = l - 128 s): bf16
    // 0x43 | l is 128 + l and 0x43 | (b & 0x80) is 128 (1 + s), so their
    // difference is v
    const uint32_t y0 = __byte_perm(t, 0x43434343u, 0x4240), y1 = __byte_perm(t, 0x43434343u, 0x4341);
    r0 = bsub2(y0 & 0xFF7FFF7Fu, y0 & 0xFF80FF80u);
    r1 = bsub2(y1 & 0xFF7FFF7Fu, y1 & 0xFF80FF80u);
  }
}

// A slot's W box read for the A fragments of its four k16 steps. Row k of
// the box is 128 bytes at w + 128 k, its 16-byte chunk c at c ^ (k % 8).
// ldmatrix.trans over the box read as 16-bit pairs of columns hands each lane
// (gid, tig) of an 8 x 8 matrix rows 2 tig and 2 tig + 1 of pair gid: bytes
// [c0@k, c1@k, c0@k+1, c1@k+1] for columns c0 = 2 gid, c1 = 2 gid + 1 of the
// warp's chunk, which is what widen_pairs takes. Matrix i of the x4 load p is
// k rows 32 p + 8 i..+7: w[p][i] is k16 step 2 p + i / 2, half i % 2.
// `off` is this lane's row address in load 0 (row k = lane, swizzled chunk).
__device__ __forceinline__ void load_slab(uint32_t (&w)[2][4], const unsigned char* box, int off) {
  hp::ldsm_x4_trans(w[0], box + off);
  hp::ldsm_x4_trans(w[1], box + 32 * 128 + off);
}

// k16 step kk's A fragment from a slab's ldmatrix words
template <typename T>
__device__ __forceinline__ void widen_step(uint32_t (&a)[4], const uint32_t (&w)[2][4], int kk) {
  widen_pairs<T>(w[kk >> 1][2 * (kk & 1)], a[0], a[1]);
  widen_pairs<T>(w[kk >> 1][2 * (kk & 1) + 1], a[2], a[3]);
}

// A slab's ring stage and the parity of its pass over the ring: advanced
// by increments, since a stage count that is no power of two would cost an
// integer division a slab
struct RingPos {
  uint32_t stage, phase;
};

template <typename T, int N>
__device__ __forceinline__ void mma_step(float (&acc)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  hp::wgmma_fence();
  hp::wgmma_rs_k<T, N>(acc, a, db, 1);
  hp::wgmma_commit();
}

// A consumer's view of the ring (full / empty barriers, W boxes, x slots),
// addressed by ring positions
template <int BM>
struct Ring {
  using L = Wo<BM>;
  static constexpr int S = L::kStages;
  unsigned char* sm;
  uint64_t* full;
  uint64_t* empty;
  int lane;
  __device__ __forceinline__ RingPos next(RingPos p) const {
    return p.stage + 1 == S ? RingPos{0, p.phase ^ 1} : RingPos{p.stage + 1, p.phase};
  }
  __device__ __forceinline__ const unsigned char* w_box(RingPos p) const { return sm + L::kW + p.stage * L::kWBytes; }
  __device__ __forceinline__ const unsigned char* x_slot(RingPos p) const { return sm + L::kX + p.stage * L::kXBytes; }
  __device__ __forceinline__ void wait_full(RingPos p) const { hp::mbar_wait(&full[p.stage], p.phase); }
  // this warp's reads of the slot (its loads, its warpgroup's wgmmas) are done
  __device__ __forceinline__ void release(RingPos p) const {
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(&empty[p.stage]);
  }
};

// One consumer thread's walk over an item's k steps: acc (m64 x N, this
// warpgroup's 64 weight columns by N x rows) += W^T x^T. One k16 step a
// group: the step after the one in flight is widened while it runs, and at
// most 4 groups are in flight, so the fragment a widening writes was read by
// a group that wait<3> has retired. `pos` is the ring position of the
// item's first slab, and on return that of the next item's.
template <typename T, int N, typename R>
__device__ __forceinline__ void mainloop(float (&acc)[N / 2], const R& ring, RingPos& pos, int nk, int off) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  uint32_t a[4][4], w[2][4];
  RingPos cur = pos, prev = pos;
  ring.wait_full(cur);
  load_slab(w, ring.w_box(cur), off);
  widen_step<T>(a[0], w, 0);
  for (int j = 0; j < nk; ++j) {
    const RingPos nxt = ring.next(cur);
    const uint64_t db = hp::desc_sw128(ring.x_slot(cur), 16, 1024);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      mma_step<T, N>(acc, a[kk], db + 2 * kk);  // + 32 bytes a k16 step
      hp::wgmma_wait<3>();
      if (kk < 3) {
        widen_step<T>(a[kk + 1], w, kk + 1);
      } else {
        if (j > 0) ring.release(prev);  // its four groups have retired
        if (j + 1 < nk) {
          ring.wait_full(nxt);
          load_slab(w, ring.w_box(nxt), off);
          widen_step<T>(a[0], w, 0);
        }
      }
    }
    prev = cur;
    cur = nxt;
  }
  hp::wgmma_wait<0>();
  ring.release(prev);
  hp::fence_regs(acc);
  pos = cur;
}

// The kernel body (each source wraps it in a __global__ of its own name):
// x [M, K] by tm_x (boxes of Wo<BM>::kBoxRows rows x 64), w8 [K, N] by tm_w
// (boxes [64 k][128 n]), K > 0; the consumers hand each item's tile to
// `epi` with the epilogue's shared memory.
template <typename T, int BM, typename Epi>
__device__ __forceinline__ void run(const CUtensorMap* tm_x, const CUtensorMap* tm_w, int K, const Plan& plan,
                                    const Epi& epi) {
  using L = Wo<BM>;
  constexpr int S = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* empty = full + S;
  const int nk = (K + kBK - 1) / kBK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hp::mbar_init(&full[s], 1);                // the producer's arrival + the boxes' bytes
      hp::mbar_init(&empty[s], kConsumerWarps);  // one arrival per consumer warp
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    hp::reg_dealloc<kProducerRegs>();
    if (warp > kConsumerWarps || lane != 0) return;  // one thread issues every copy
    // ---- producer: per item, per k step, the W box and the x box(es) ----
    hp::tma_prefetch(tm_x);
    hp::tma_prefetch(tm_w);
    int s = 0;
    uint32_t phase = 0;  // the ring position of the next slab
    for (int i = blockIdx.x; i < plan.items; i += gridDim.x) {
      const Item it = item_at(plan, i);
      const int boxes = it.big ? BM / L::kBoxRows : 1;
      for (int ks = 0; ks < nk; ++ks) {
        hp::mbar_wait(&empty[s], phase ^ 1);  // the slot's last slab is consumed
        hp::mbar_arrive_expect_tx(&full[s], L::kWBytes + boxes * L::kBoxRows * kBK * 2);
        hp::tma_load_2d(sm + L::kW + s * L::kWBytes, tm_w, &full[s], it.n0, ks * kBK);
        for (int b = 0; b < boxes; ++b)
          hp::tma_load_2d(sm + L::kX + s * L::kXBytes + b * L::kBoxRows * 128, tm_x, &full[s], ks * kBK,
                          it.m0 + b * L::kBoxRows);
        if (++s == S) s = 0, phase ^= 1;
      }
    }
    return;
  }

  hp::reg_alloc<kConsumerRegs>();
  // ---- consumer warpgroups: 64 weight columns each ----
  const int wg = warp >> 2, wl = warp & 3;
  const int chunk = 4 * wg + wl;  // the 16-byte chunk of a W row that holds this warp's 16 columns
  const int off = lane * 128 + ((chunk ^ (lane & 7)) << 4);
  const Ring<BM> ring{sm, full, empty, lane};
  unsigned char* epi_smem = sm + L::kEpi;
  RingPos pos{0, 0};  // the ring position of the next slab
  float acc[BM / 2];
  for (int i = blockIdx.x; i < plan.items; i += gridDim.x) {
    const Item it = item_at(plan, i);
    if constexpr (BM == 256) {
      if (!it.big) {  // a 128-row item: the first half of the accumulators
        float (&half)[64] = *reinterpret_cast<float(*)[64]>(&acc[0]);
        mainloop<T, 128>(half, ring, pos, nk, off);
        epi.template apply<128>(half, it, wg, wl, lane, epi_smem);
        continue;
      }
    }
    mainloop<T, BM>(acc, ring, pos, nk, off);
    epi.template apply<BM>(acc, it, wg, wl, lane, epi_smem);
  }
}

// Map x [M, K] (T) and w8 [K, N] (int8) for the BM-row instance. Returns a
// cudaError_t.
template <typename T, int BM>
int map_operands(CUtensorMap* tx, CUtensorMap* tw, const void* x, const void* w8, int M, int K, int N) {
  const int err = hp::encode_2d(tx, hp::tma_dtype<T>(), x, M, K, 2LL * K, Wo<BM>::kBoxRows, kBK);
  return err ? err : hp::encode_2d(tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, w8, K, N, N, kBK, kBN);
}

// Allow the kernel its shared memory and check its register split. Returns
// a cudaError_t.
template <typename Kernel>
int prepare(Kernel kernel, int smem) {
  const int err = ptt::allow_smem(kernel, smem);
  return err ? err : hp::check_reg_split(kernel, kThreads, kConsumers * kConsumerRegs + 128 * kProducerRegs);
}

}  // namespace wo
}  // namespace ptt
