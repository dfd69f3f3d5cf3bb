// Flash-attention backward on the tensor cores for every head dim above 256
// (a multiple of 64, D a runtime value), bf16 and fp16: kernel 15, dq =
// sum over visible columns of ds k, and kernel 16, dk = sum over visible
// rows of ds q and dv = sum of p g (the query heads of a KV head's group
// summed), with p = exp(scale q k^T - lse) (0 where masked) and ds = p (g
// v^T - delta) scale, for q, g [B, Sq, H, D] and k, v [B, Sk, HK, D] read in
// place, lse and delta [B, H, Sq] fp32 from the forward and the caller. Up
// to D 256 flash_bwd_dq.cu and flash_bwd_dkv.cu run; fp32 takes
// flash_fp32.cu (to 512) and flash_deep.cu (above).
//
// Replaces: paddle_tpu/kernels/flash_attention.py `_bwd_dq_kernel` and
// `_bwd_dkv_kernel` (launched by `_run_bwd`) at head dims above 256.
//
// Semantics as flash_bwd_dq.cu's and flash_bwd_dkv.cu's (see there): the
// product q k^T is scaled, not q; p is 0 where masked; dS (for dS K), P^T
// and dS^T are rounded to T for their products, every sum is fp32; rows
// past Sq contribute nothing (their lse reads +inf) and a fully masked row
// gets zero gradients; dq, dk and dv are written once, in T, with no
// atomics, so two calls are bitwise equal.
//
// Where the D <= 256 designs stop: a 64-row warpgroup's dq (or dk, or dv)
// is 64 x D fp32, 256 registers a thread at D 512 beside S and dP (32
// each). So the outputs' columns go over column blocks of at most 256 (4
// boxes of 64), while S = Q K^T and dP = g V^T are reductions over all of
// D. Of the two ways there (recompute S and dP for every column block, or
// compute them once a CTA and hand dS between the warpgroups or the CTAs of
// a cluster that own the column blocks) this file takes the first, as
// flash_fwd_wide.cu does: no buffer between warpgroups for dq, the one P^T
// hand-over of flash_bwd_dkv.cu for dk/dv, and one ring that the two
// consumer warpgroups walk in lockstep.
// - dq (15): a work item is (64-row query tile, head, batch, CTA column
//   block); both consumer warpgroups own the same 64 rows and compute S and
//   dP over all of D themselves, each accumulating dq over its own boxes
//   (`group_boxes`: ceil(D / 512) CTAs a query tile, 3 or 4 boxes a
//   warpgroup, one box short recomputing its neighbour's first and not
//   storing it). Flops: 2 (2 D) + 2 D of S, dP and dq per visible pair and
//   CTA against the minimum 6 D: 1.67x at D 320-512, 3.0x at 1024 (two
//   CTAs).
// - dk / dv (16): a work item is (64-key tile, KV head, batch, column
//   block of at most 4 boxes, ceil(D / 256) of them); it walks the group's
//   query heads itself, so no atomics are needed. Warpgroup 0 runs S^T = K
//   Q^T over all of D, P^T, hands P^T in fp32 to warpgroup 1 through one
//   16 KB buffer, and dV += P^T g on the block; warpgroup 1 runs dP^T = V
//   g^T, dS^T, and dK += dS^T Q on the block. Flops: 4 D + 4 x (the block's
//   columns) per visible pair and CTA against the minimum 8 D: 1.6x at D
//   320, 1.5x at 512, 2.5x at 1024.
// Handing dS (or P^T and dS^T) between CTAs of a cluster through
// distributed shared memory would save the recompute but ties the CTAs of a
// query (key) tile into lockstep through a second ring; the recompute is
// the simple design. At these head dims a CTA reads 192 KB of K and V (Q
// and g) from L2 per visible tile pair at D 512 for 21 (dq) or 12.6 (dk/dv)
// MFLOP of products, so the reads more than the products set its pace.
//
// Design (Hopper; the pieces of flash_fwd_wide.cu and flash_bwd_dkv.cu). A
// persistent grid of one CTA per SM takes items from an atomic counter
// (`_sched`), the longest walks of every head first (`query_item`,
// `key_item`), the CTAs of one tile adjacent so they share its operands in
// L2; the producer warp walks the tile classes (flash_common.cuh
// `walk_live_tiles` for dq, the key tile's bounds for dk/dv: a SKIP tile
// costs no copy and no product) and streams each live tile through a ring
// of slots by TMA, full and empty mbarriers:
// - D / 64 reduction slots, slot x holding box x of the two streamed
//   operands (dq: K and V; dk/dv: Q and g) and, where the resident pair
//   does not fit, box x of it too (dq: Q and g; dk/dv: K and V; otherwise
//   they are loaded once an item and stay); the tile's last reduction slot
//   carries its row masks (one 64-bit word a key: flash_common.cuh
//   `rows_mask64`, PARTIAL tiles only) and, for dk/dv, its rows' lse and
//   delta (cp.async, +inf and 0 past Sq);
// - then nw block slots, slot j holding box j of each warpgroup's column
//   block of the operand its output product reads as MN-major B (dq: K;
//   dk/dv: g for dV and Q for dK), read again from L2.
// The consumers run the reductions as wgmma SS (4 k16 steps a box; a slot
// goes back once the next one's products are issued and its own are done),
// p and dS in fp32 on the accumulators, and the output products as wgmma RS
// (the fragments rounded to T in registers). Outputs leave from registers
// (4-byte stores). Inside the wgmma pipelines nothing branches on a value
// ptxas cannot prove warp-uniform (C7520): waits and releases are single
// asm statements, control words are broadcast from lane 0, and a kernel
// instance has one box count (NW, a template).
//
// Budgets (227 KB of shared memory, 65536 registers a CTA). Registers: a
// consumer thread holds nw x 32 fp32 of its output (128 at nw 4) beside S
// and dP (dq: 64) or one of them (dk/dv: 32) and 16 of fragments;
// setmaxnreg gives the consumers 224 a thread (the producer 56). Shared
// memory: the resident pair 2 x 64 x D x 2 bytes (128 KB at D 512), the
// ring's 16 KB slots (dq 5 at D 512, dk/dv 4 beside the 16 KB P^T buffer),
// 8 KB of bounds staging. Where the resident pair leaves no room for 4
// slots (dq above D 576, dk/dv above 512) it rides in the ring instead (32
// KB slots, 6 of them), read again from L2 for every tile. At D 1024 both
// kernels stream it.
//
// Bound on H100: operations, 6 D (dq) and 8 D (dk/dv) flops per visible
// (row, column) at the tensor cores' 989 TFLOP/s (bf16, fp16).
#include "flash_common.cuh"

namespace hp = ptt::hopper;
namespace fl = ptt::flash;

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBM = 64;                     // query rows of a tile
constexpr int kBN = 64;                     // keys of a tile
constexpr int kBox = 64 * 128;              // one [64 rows][64 columns] box of a 2-byte type
constexpr int kXBytes = kBN * kBM * 4;      // dk/dv: the fp32 P^T tile handed between the warpgroups
constexpr int kConsumers = 256;             // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup (one warp of it works)
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kConsumerRegs = 224;
constexpr int kProducerRegs = (168 * kThreads - kConsumers * kConsumerRegs) / 128;
static_assert(kProducerRegs >= 24 && kProducerRegs % 8 == 0, "setmaxnreg takes 24..256 in steps of 8");
constexpr int kMaxWgBoxes = 4;  // a warpgroup's output: at most 4 boxes (256 columns, 128 registers)
constexpr int kMinStages = 4;   // slots the ring needs (a consumer holds at most 2 while it waits)
constexpr int kMaxStages = 8;
constexpr int kStgInts = 2048;  // the producer's bounds staging (8 KB)
constexpr int kSmem = 227 * 1024;
constexpr int kSlotSide = kBN * 8 + 2 * kBM * 4 + 8;  // a slot's row masks, lse / delta and info word
constexpr int kFixed = kStgInts * 4 + (2 + 2 * kMaxStages) * 8 + 16 + 1024;  // staging, barriers, item, alignment
// named barriers (0 is __syncthreads): the P^T buffer full / free (dk/dv)
constexpr int kBarXFull = 4, kBarXFree = 5;

// The launch plan of head dim D for dq (dkv false) or dk/dv (dkv true)
// (kernels/flash_attention.py `flash_bwd_wide_plan` mirrors it;
// ptt_flash_bwd_wide_plan reports it). Offsets are from the 1024-byte-aligned
// base of dynamic shared memory.
struct BwdPlan {
  int nbox;    // D / 64
  int split;   // CTAs a tile (column blocks)
  int groups;  // owners of column boxes: dq 2 split warpgroups, dk/dv split CTAs
  int nw;      // boxes each owner computes (the kernel's instance)
  int stream;  // 1: the resident pair (dq: Q, g; dk/dv: K, V) rides in the ring
  int slot;    // bytes of a slot: 2 boxes (+ 2 of the resident pair when streaming)
  int stages;
  int ring, x, mask, stats, info, stg, bar, item, bytes;
};

__host__ __device__ inline BwdPlan bwd_plan(int D, bool dkv) {
  BwdPlan p;
  p.nbox = D / 64;
  p.split = dkv ? (p.nbox + kMaxWgBoxes - 1) / kMaxWgBoxes : (p.nbox + 2 * kMaxWgBoxes - 1) / (2 * kMaxWgBoxes);
  p.groups = dkv ? p.split : 2 * p.split;
  p.nw = (p.nbox + p.groups - 1) / p.groups;
  const int xbytes = dkv ? kXBytes : 0;
  int res = 2 * p.nbox * kBox;
  p.stream = kSmem - kFixed - xbytes - res < kMinStages * (2 * kBox + kSlotSide);
  if (p.stream) res = 0;
  p.slot = (p.stream ? 4 : 2) * kBox;
  p.stages = (kSmem - kFixed - xbytes - res) / (p.slot + kSlotSide);
  if (p.stages > kMaxStages) p.stages = kMaxStages;
  p.ring = res;
  p.x = p.ring + p.stages * p.slot;
  p.mask = p.x + xbytes;
  p.stats = p.mask + p.stages * kBN * 8;
  p.info = p.stats + p.stages * 2 * kBM * 4;
  p.stg = p.info + (p.stages * 8 + 15) / 16 * 16;
  p.bar = p.stg + kStgInts * 4;
  p.item = p.bar + (2 + 2 * p.stages) * 8;
  p.bytes = p.item + 16 + 1024;
  return p;
}

// The first box and the count of boxes that owner g (of `groups`) stores:
// as even as floors allow; the last owner always has ceil(nbox / groups),
// so one with a box fewer can compute its neighbour's first.
__host__ __device__ inline void group_boxes(int nbox, int groups, int g, int* first, int* count) {
  *first = g * nbox / groups;
  *count = (g + 1) * nbox / groups - *first;
}

// The shared memory of a CTA, carved by the plan.
struct Shared {
  unsigned char* res;   // the resident pair: 2 nbox boxes (unless streaming)
  unsigned char* ring;  // [stages] slots
  float* x;             // dk/dv: the fp32 P^T tile
  uint64_t* masks;      // [stages][kBN]: a PARTIAL tile's masked rows, one word a key
  float* stats;         // [stages][2][kBM]: dk/dv, the tile rows' lse and delta
  int2* info;           // [stages]: (tile, class | kLastTile); tile -1 ends an item
  int* stg;             // the producer's bounds staging
  uint64_t* res_full;   // 1 arrival + the resident pair's bytes
  uint64_t* res_empty;  // one arrival per consumer warp
  uint64_t* full;       // [stages]: 64 arrivals (the producer warp, twice: `publish`) + the slot's bytes
  uint64_t* empty;      // [stages]: one arrival per consumer warp
  volatile int* item;
};

__device__ __forceinline__ Shared shared_of(unsigned char* raw, const BwdPlan& p) {
  unsigned char* base = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  Shared s;
  s.res = base;
  s.ring = base + p.ring;
  s.x = reinterpret_cast<float*>(base + p.x);
  s.masks = reinterpret_cast<uint64_t*>(base + p.mask);
  s.stats = reinterpret_cast<float*>(base + p.stats);
  s.info = reinterpret_cast<int2*>(base + p.info);
  s.stg = reinterpret_cast<int*>(base + p.stg);
  s.res_full = reinterpret_cast<uint64_t*>(base + p.bar);
  s.res_empty = s.res_full + 1;
  s.full = s.res_full + 2;
  s.empty = s.full + p.stages;
  s.item = reinterpret_cast<int*>(base + p.item);
  return s;
}

__device__ __forceinline__ void init_barriers(const Shared& sh, int stages) {
  if (threadIdx.x == 0) {
    hp::mbar_init(sh.res_full, 1);
    hp::mbar_init(sh.res_empty, kConsumerWarps);
    for (int s = 0; s < stages; ++s) {
      hp::mbar_init(&sh.full[s], 64);               // every producer lane arrives twice (publish)
      hp::mbar_init(&sh.empty[s], kConsumerWarps);  // one arrival per consumer warp
    }
    hp::mbar_fence_init();
  }
  __syncthreads();
}

// A slot is ready once every producer lane has arrived twice: once when its
// cp.async copies (dk/dv's lse and delta) land, once after its plain writes
__device__ __forceinline__ void publish(uint64_t* bar) {
  hp::cp_async_mbar_arrive(bar);
  hp::mbar_arrive(bar);
}

// The producer's position in the ring.
struct Cursor {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance(int stages) {
    if (++stage == stages) stage = 0, phase ^= 1;
  }
};

// A 64-row box source: a tensor map and the (head, first row) of the tile.
struct Src {
  const CUtensorMap* map;
  int head, row;
};

// The producer warp's slots of one live tile: D / 64 reduction slots (box x
// of the streamed pair s0, s1, and of the resident pair r0, r1 when
// streaming), then the nw block slots (box first0 + j of o0, first1 + j of
// o1). `side(stage)` runs in the whole warp at the tile's last reduction
// slot, while its copies fly (the row masks, dk/dv's stats).
template <typename Side>
__device__ __forceinline__ void produce_tile(const BwdPlan& p, const Shared& sh, Cursor& cur, int2 tinfo, Src s0,
                                             Src s1, Src r0, Src r1, Src o0, int first0, Src o1, int first1, int b,
                                             int lane, Side&& side) {
  for (int c = 0; c < p.nbox + p.nw; ++c) {
    hp::mbar_wait(&sh.empty[cur.stage], cur.phase ^ 1);  // the slot's last use is released
    uint64_t* bar = &sh.full[cur.stage];
    unsigned char* slot = sh.ring + cur.stage * p.slot;
    if (lane == 0) {  // the copies first: the masks and stats are written while they fly
      sh.info[cur.stage] = tinfo;
      if (c < p.nbox) {
        hp::mbar_expect_tx(bar, (p.stream ? 4 : 2) * kBox);
        hp::tma_load_4d(slot, s0.map, bar, c * 64, s0.head, s0.row, b);
        hp::tma_load_4d(slot + kBox, s1.map, bar, c * 64, s1.head, s1.row, b);
        if (p.stream) {
          hp::tma_load_4d(slot + 2 * kBox, r0.map, bar, c * 64, r0.head, r0.row, b);
          hp::tma_load_4d(slot + 3 * kBox, r1.map, bar, c * 64, r1.head, r1.row, b);
        }
      } else {
        const int j = c - p.nbox;
        hp::mbar_expect_tx(bar, 2 * kBox);
        hp::tma_load_4d(slot, o0.map, bar, (first0 + j) * 64, o0.head, o0.row, b);
        hp::tma_load_4d(slot + kBox, o1.map, bar, (first1 + j) * 64, o1.head, o1.row, b);
      }
    }
    if (c == p.nbox - 1) side(cur.stage);
    publish(bar);  // every lane: its masks and stats and (lane 0) the info word are written
    cur.advance(p.stages);
  }
}

// The item's resident pair (box x of r0 at x, of r1 at nbox + x), or, when
// it streams, the bare arrival that hands the consumers the item.
__device__ __forceinline__ void produce_resident(const BwdPlan& p, const Shared& sh, int it, Src r0, Src r1, int b) {
  *sh.item = it;
  if (p.stream) {
    hp::mbar_arrive(sh.res_full);
    return;
  }
  hp::mbar_arrive_expect_tx(sh.res_full, 2 * p.nbox * kBox);
  for (int x = 0; x < p.nbox; ++x) {
    hp::tma_load_4d(sh.res + x * kBox, r0.map, sh.res_full, x * 64, r0.head, r0.row, b);
    hp::tma_load_4d(sh.res + (p.nbox + x) * kBox, r1.map, sh.res_full, x * 64, r1.head, r1.row, b);
  }
}

// A walk whose final pass held no tile: a slot of its own (tile -1) ends the item.
__device__ __forceinline__ void end_item(const BwdPlan& p, const Shared& sh, Cursor& cur, int lane) {
  hp::mbar_wait(&sh.empty[cur.stage], cur.phase ^ 1);
  if (lane == 0) sh.info[cur.stage] = make_int2(-1, 0);
  publish(&sh.full[cur.stage]);
  cur.advance(p.stages);
}

// acc (+)= A B^T over one 64-column box (A [64][64] and B [64][64], both
// K-major): 4 k16 steps, the first overwriting acc where kZero
template <typename T, bool kZero>
__device__ __forceinline__ void ss_box(float (&acc)[32], const unsigned char* a, const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    hp::wgmma_ss<T, kBN>(acc, hp::desc_sw128(a + kk * 32, 16, 1024), hp::desc_sw128(b + kk * 32, 16, 1024),
                         kZero && kk == 0 ? 0 : 1);
}

// acc += a B with B one [64 k][64 n] box read MN-major: 4 k16 steps
template <typename T>
__device__ __forceinline__ void rs_box(float (&acc)[32], const uint32_t (&a)[4][4], const unsigned char* b) {
#pragma unroll
  for (int kt = 0; kt < 4; ++kt) hp::wgmma_rs_n64<T>(acc, a[kt], hp::desc_sw128(b + kt * 16 * 128, kBox, 1024), 1);
}

// The consumer's side of the ring: waits by one asm loop, releases by a
// predicated arrival (no branch inside a wgmma pipeline)
struct Consumer {
  unsigned char* ring;
  uint64_t *full, *empty, *res_empty;
  int stages, slot, lane;
  int stage = 0, rel = 0;  // the next slot to wait on, the oldest slot held
  uint32_t phase = 0;
  __device__ __forceinline__ Consumer(const Shared& sh, const BwdPlan& p, int lane_)
      : ring(sh.ring), full(sh.full), empty(sh.empty), res_empty(sh.res_empty), stages(p.stages), slot(p.slot),
        lane(lane_) {}
  // the next slot, once it is full
  __device__ __forceinline__ unsigned char* wait() {
    hp::mbar_wait_loop(&full[stage], phase);
    return ring + stage * slot;
  }
  __device__ __forceinline__ void take() {
    if (++stage == stages) stage = 0, phase ^= 1;
  }
  __device__ __forceinline__ void release() {
    __syncwarp();
    hp::mbar_arrive_if(&empty[rel], lane == 0);
    if (++rel == stages) rel = 0;
  }
  __device__ __forceinline__ void release_resident() {
    __syncwarp();
    hp::mbar_arrive_if(res_empty, lane == 0);
  }
};

// The output products over the nw block slots: acc[x] += a (this
// warpgroup's box of slot x, MN-major); every slot goes back
template <typename T, int NW>
__device__ __forceinline__ void block_products(Consumer& cs, float (&acc)[NW][32], uint32_t (&a)[4][4], int wg) {
  hp::wgmma_fence();
#pragma unroll
  for (int x = 0; x < NW; ++x) {
    const unsigned char* slot = cs.wait();
    rs_box<T>(acc[x], a, slot + wg * kBox);
    hp::wgmma_commit();
    cs.take();
    if (x) {
      hp::wgmma_wait<1>();
      cs.release();
    }
  }
  hp::wgmma_wait<0>();
#pragma unroll
  for (int x = 0; x < NW; ++x) hp::fence_regs(acc[x]);
#pragma unroll
  for (int kt = 0; kt < 4; ++kt) hp::fence_regs(a[kt]);
  cs.release();
}

// The boxes [first, first + count) of acc, this thread's rows r0 + row_l
// and r0 + row_l + 8, into out at base0 + row row_stride (rows from n on
// dropped)
template <typename T, int NW>
__device__ __forceinline__ void store_rows(const float (&acc)[NW][32], T* out, size_t row_stride, size_t base0,
                                           int r0, int row_l, int n, int first, int count, int tig) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + row_l + 8 * r;
    if (row >= n) continue;
    T* dst = out + base0 + static_cast<size_t>(row) * row_stride + first * 64 + 2 * tig;
#pragma unroll
    for (int x = 0; x < NW; ++x) {
      if (x >= count) break;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + x * 64 + 8 * j) = hp::pack2<T>(acc[x][4 * j + 2 * r], acc[x][4 * j + 2 * r + 1]);
    }
  }
}

// dq: s <- dS = p (dp - delta) scale with p = exp2(s sl2 - lse2), 0 where
// masked (kMask: the tile's row masks, two 32-bit words a key; this thread's
// rows are bits bit0 and bit0 + 8 of word `word`)
template <bool kMask>
__device__ __forceinline__ void probs_to_ds(float (&s)[32], const float (&dp)[32], float sl2, float scale,
                                            const float (&lse2)[2], const float (&dl)[2], const uint32_t* msk,
                                            int word, int bit0, int tig) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float p0 = hp::exp2_approx(fmaf(s[4 * j + c], sl2, -lse2[0]));
      float p1 = hp::exp2_approx(fmaf(s[4 * j + 2 + c], sl2, -lse2[1]));
      if constexpr (kMask) {
        const uint32_t bits = msk[(8 * j + 2 * tig + c) * 2 + word] >> bit0;
        if (bits & 1u) p0 = 0.f;
        if (bits & 0x100u) p1 = 0.f;
      }
      s[4 * j + c] = p0 * (dp[4 * j + c] - dl[0]) * scale;
      s[4 * j + 2 + c] = p1 * (dp[4 * j + 2 + c] - dl[1]) * scale;
    }
  }
}

// The work items' order: the tile index slowest, so that under `causal`
// every head's longest walks (dq: the last query tiles; dk/dv: the first
// key tiles) are handed out before any shorter one, and a CTA that took a
// short item first takes a long one no later than the rest do. (Within a
// head, as flash_common.cuh `item_of` / `key_item_of` order them, a long
// walk of the last heads could start after every short one of the first:
// at GQA 8/2 `[2, 1024]` that tail cost dq 19% at D 512 and dk/dv 29% at D
// 576 on an H100.) The split CTAs of one tile stay adjacent.
__device__ __forceinline__ fl::Item query_item(int i, int n_qt, int H, int B, int causal) {
  const int rank = i / (H * B), bh = i % (H * B);
  return fl::Item{causal ? n_qt - 1 - rank : rank, bh % H, bh / H};
}

__device__ __forceinline__ fl::KeyItem key_item(int i, int HK, int B) {
  const int bh = i % (HK * B);
  return fl::KeyItem{i / (HK * B), bh % HK, bh / HK};
}

// -- kernel 15: dq ---------------------------------------------------------------

template <typename T, int NW>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel_wide(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_g,
                         const int* __restrict__ bounds, const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dq, int B, int Sq, int Sk, int H, int HK,
                         int D, int Hm, int C, int causal, float scale, int* __restrict__ sched) {
  const BwdPlan p = bwd_plan(D, false);
  extern __shared__ unsigned char smem_raw[];
  const Shared sh = shared_of(smem_raw, p);
  const int n_qt = (Sq + kBM - 1) / kBM;
  const int items = n_qt * H * B * p.split;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  init_barriers(sh, p.stages);

  if (warp >= kConsumerWarps) {
    hp::reg_dealloc<kProducerRegs>();
    if (warp > kConsumerWarps) return;  // the producer warpgroup's other warps only give up their registers
    // ---- producer warp: per item Q and g (resident unless streaming), then each live key tile's slots ----
    if (lane == 0) {
      hp::tma_prefetch(&tm_q);
      hp::tma_prefetch(&tm_g);
      hp::tma_prefetch(&tm_k);
      hp::tma_prefetch(&tm_v);
    }
    Cursor cur;
    for (int it = blockIdx.x, n = 0;; ++n) {
      hp::mbar_wait(sh.res_empty, (n & 1) ^ 1);  // the last item's resident pair is done with
      if (it >= items) {  // none left: tell the consumers
        if (lane == 0) {
          *sh.item = -1;
          hp::mbar_arrive(sh.res_full);
        }
        break;
      }
      int next = 0;
      if (lane == 0) next = atomicAdd(sched, 1) + static_cast<int>(gridDim.x);
      const int cb = it % p.split;
      const fl::Item w = query_item(it / p.split, n_qt, H, B, causal);
      const int r0 = w.qt * kBM, hk = w.h / (H / HK);
      int f0, f1, unused;
      group_boxes(p.nbox, p.groups, 2 * cb, &f0, &unused);
      group_boxes(p.nbox, p.groups, 2 * cb + 1, &f1, &unused);
      const Src q{&tm_q, w.h, r0}, g{&tm_g, w.h, r0};
      if (lane == 0) produce_resident(p, sh, it, q, g, w.b);
      const int* bb = C ? bounds + (static_cast<size_t>(w.b) * Hm + (Hm == 1 ? 0 : w.h)) * Sk * C : nullptr;
      const bool ended = fl::walk_live_tiles<kBN, kStgInts>(
          sh.stg, bb, C, r0, kBM, fl::walk_end(r0, kBM, kBN, Sq, Sk, causal), Sq, Sk, causal, lane,
          [&](int t, int cls, int i, bool last) {
            const int c0 = t * kBN;
            const Src k{&tm_k, hk, c0}, v{&tm_v, hk, c0};
            produce_tile(p, sh, cur, make_int2(t, cls | (last ? fl::kLastTile : 0)), k, v, q, g, k, f0, k, f1, w.b,
                         lane, [&](int st) {
                           if (cls != fl::kPartial) return;
                           for (int cl = lane; cl < kBN; cl += 32)
                             sh.masks[st * kBN + cl] =
                                 fl::rows_mask64(sh.stg + (i * kBN + cl) * C, C, c0 + cl, r0, Sq, Sk, causal);
                         });
          });
      if (!ended) end_item(p, sh, cur, lane);
      it = __shfl_sync(0xffffffffu, next, 0);
    }
  } else {
    hp::reg_alloc<kConsumerRegs>();
    // ---- consumer warpgroups: the same 64 query rows, nw boxes of dq each ----
    const int wg = warp >> 2, wl = warp & 3;
    const int gid = lane >> 2, tig = lane & 3;
    const int row_l = wl * 16 + gid;  // this thread's rows of the tile: row_l, row_l + 8
    const int word = wl >> 1, bit0 = (wl & 1) * 16 + gid;
    const float sl2 = scale * kLog2e;
    Consumer cs(sh, p, lane);
    for (int n = 0;; ++n) {
      hp::mbar_wait_loop(sh.res_full, n & 1);  // the item's resident pair landed
      const int it = __shfl_sync(0xffffffffu, *sh.item, 0);
      if (it < 0) break;
      const int cb = it % p.split;
      const fl::Item w = query_item(it / p.split, n_qt, H, B, causal);
      bool held = !p.stream;
      if (!held) cs.release_resident();  // the item is read: the producer may go on
      int first, count;
      group_boxes(p.nbox, p.groups, 2 * cb + wg, &first, &count);
      float lse2[2], dl[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = w.qt * kBM + row_l + 8 * r;
        const size_t at = (static_cast<size_t>(w.b) * H + w.h) * Sq + row;
        lse2[r] = row < Sq ? lse[at] * kLog2e : fl::kInf;  // +inf: p = 0 (padding, fully masked rows)
        dl[r] = row < Sq ? delta[at] : 0.f;
      }
      float acc[NW][32];
#pragma unroll
      for (int x = 0; x < NW; ++x)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[x][i] = 0.f;
      while (true) {
        const unsigned char* slot = cs.wait();
        const int2 tw = sh.info[cs.stage];
        const int tile = __shfl_sync(0xffffffffu, tw.x, 0), flags = __shfl_sync(0xffffffffu, tw.y, 0);
        if (tile < 0) {  // the walk ended without a tile to flag
          cs.take();
          cs.release();
          break;
        }
        const bool last = flags & fl::kLastTile;

        // S = Q K^T and dP = g V^T over the reduction slots
        float s[32], dp[32];
        hp::wgmma_fence();
        ss_box<T, true>(s, p.stream ? slot + 2 * kBox : sh.res, slot);
        ss_box<T, true>(dp, p.stream ? slot + 3 * kBox : sh.res + p.nbox * kBox, slot + kBox);
        hp::wgmma_commit();
        cs.take();
        for (int c = 1; c < p.nbox; ++c) {
          slot = cs.wait();
          ss_box<T, false>(s, p.stream ? slot + 2 * kBox : sh.res + c * kBox, slot);
          ss_box<T, false>(dp, p.stream ? slot + 3 * kBox : sh.res + (p.nbox + c) * kBox, slot + kBox);
          hp::wgmma_commit();
          cs.take();
          hp::wgmma_wait<1>();
          cs.release();
        }
        hp::wgmma_wait<0>();
        hp::fence_regs(s);
        hp::fence_regs(dp);
        if (held && last) {  // the item's last product with Q and g is done: the producer may load the next
          cs.release_resident();
          held = false;
        }

        // dS on the accumulators (the masks ride in the tile's last reduction slot)
        const uint32_t* msk = reinterpret_cast<const uint32_t*>(sh.masks + cs.rel * kBN);
        if ((flags & 3) == fl::kPartial) {
          probs_to_ds<true>(s, dp, sl2, scale, lse2, dl, msk, word, bit0, tig);
        } else {
          probs_to_ds<false>(s, dp, sl2, scale, lse2, dl, nullptr, 0, 0, tig);
        }
        cs.release();

        // dq += dS K on this warpgroup's boxes: dS rounded to T in registers, K MN-major
        uint32_t da[4][4];
#pragma unroll
        for (int kt = 0; kt < 4; ++kt) fl::c_to_a<T>(da[kt], &s[8 * kt], &s[8 * kt + 4]);
        block_products<T, NW>(cs, acc, da, wg);
        if (last) break;
      }
      if (held) cs.release_resident();
      store_rows<T, NW>(acc, dq, static_cast<size_t>(H) * D, (static_cast<size_t>(w.b) * Sq * H + w.h) * D,
                        w.qt * kBM, row_l, Sq, first, count, tig);
    }
  }
}

// -- kernel 16: dk and dv ----------------------------------------------------------

// The fp32 P^T tile handed from warpgroup 0 to 1: thread t's 32 values (its
// accumulator layout, the same in both warpgroups) as 8 float4 at
// x[(4 i + t) ...]: a warp's accesses are 512 contiguous bytes
__device__ __forceinline__ float4* xchg_at(float* x, int i, int t) { return reinterpret_cast<float4*>(x) + i * 128 + t; }

// Warpgroup 0 (kPSide false): per tile S^T = K Q^T over the reduction slots,
// P^T = exp2(S^T scale log2e - lse log2e) (0 where masked: one bit a (key,
// row) from two 64-bit words a thread), P^T handed to warpgroup 1, then dV
// += P^T g on the block. Warpgroup 1 (kPSide true): dP^T = V g^T, then with
// the tile's P^T dS^T = P^T (dP^T - delta) scale, and dK += dS^T Q. Each
// writes its output's block for the item's 64 keys once.
template <typename T, int NW, bool kPSide>
__device__ __forceinline__ void consume_dkv(const BwdPlan& p, const Shared& sh, T* __restrict__ out, int B, int HK,
                                            int Sk, int D, float scale, int warp, int lane) {
  const int wg = kPSide ? 1 : 0;
  const int gid = lane >> 2, tig = lane & 3, t = threadIdx.x % 128;
  const int key_l = (warp & 3) * 16 + gid;  // this thread's keys in the tile: key_l, key_l + 8
  const float sl2 = scale * kLog2e;
  // the reductions' A operand: K (S^T) or V (dP^T), box x resident at a_res + x kBox or in slot + a_slot
  const int a_res = (kPSide ? p.nbox : 0) * kBox, a_slot = (kPSide ? 3 : 2) * kBox, b_slot = kPSide ? kBox : 0;
  Consumer cs(sh, p, lane);
  if constexpr (kPSide) hp::named_barrier_arrive(kBarXFree, kConsumers);  // the buffer starts free
  for (int n = 0;; ++n) {
    hp::mbar_wait_loop(sh.res_full, n & 1);  // the item's K and V landed
    const int it = __shfl_sync(0xffffffffu, *sh.item, 0);
    if (it < 0) break;
    const int cb = it % p.split;
    const fl::KeyItem w = key_item(it / p.split, HK, B);
    bool held = !p.stream;
    if (!held) cs.release_resident();
    int first, count;
    group_boxes(p.nbox, p.groups, cb, &first, &count);
    float acc[NW][32];
#pragma unroll
    for (int x = 0; x < NW; ++x)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[x][i] = 0.f;
    while (true) {
      const unsigned char* slot = cs.wait();
      const int2 tw = sh.info[cs.stage];
      const int row0 = __shfl_sync(0xffffffffu, tw.x, 0), flags = __shfl_sync(0xffffffffu, tw.y, 0);
      if (row0 < 0) {  // the walk ended without a tile to flag
        cs.take();
        cs.release();
        break;
      }
      const bool last = flags & fl::kLastTile;

      // S^T = K Q^T or dP^T = V g^T: the item's 64 keys x the tile's 64 rows
      float s[32];
      hp::wgmma_fence();
      ss_box<T, true>(s, p.stream ? slot + a_slot : sh.res + a_res, slot + b_slot);
      hp::wgmma_commit();
      cs.take();
      for (int c = 1; c < p.nbox; ++c) {
        slot = cs.wait();
        ss_box<T, false>(s, p.stream ? slot + a_slot : sh.res + a_res + c * kBox, slot + b_slot);
        hp::wgmma_commit();
        cs.take();
        hp::wgmma_wait<1>();
        cs.release();
      }
      hp::wgmma_wait<0>();
      hp::fence_regs(s);
      if (held && last) {
        cs.release_resident();
        held = false;
      }
      const float* st = sh.stats + cs.rel * 2 * kBM;  // the tile rows' lse, then delta
      if constexpr (!kPSide) {
        const bool partial = (flags & 3) == fl::kPartial;
        const uint64_t* mk = sh.masks + cs.rel * kBN;
        const uint64_t m0 = partial ? mk[key_l] : 0ull, m1 = partial ? mk[key_l + 8] : 0ull;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 l = *reinterpret_cast<const float2*>(st + 8 * j + 2 * tig);
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = 8 * j + 2 * tig + c;
            const float l2 = (c ? l.y : l.x) * kLog2e;  // lse +inf (past Sq): p = 0
            float p0 = hp::exp2_approx(fmaf(s[4 * j + c], sl2, -l2));
            float p1 = hp::exp2_approx(fmaf(s[4 * j + 2 + c], sl2, -l2));
            if ((m0 >> col) & 1ull) p0 = 0.f;
            if ((m1 >> col) & 1ull) p1 = 0.f;
            s[4 * j + c] = p0;
            s[4 * j + 2 + c] = p1;
          }
        }
        cs.release();
        hp::named_barrier(kBarXFree, kConsumers);  // warpgroup 1 is done with the last P^T
#pragma unroll
        for (int i = 0; i < 8; ++i) *xchg_at(sh.x, i, t) = make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]);
        hp::named_barrier_arrive(kBarXFull, kConsumers);
      } else {
        float2 d[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) d[i] = *reinterpret_cast<const float2*>(st + kBM + 8 * i + 2 * tig);
        cs.release();
        hp::named_barrier(kBarXFull, kConsumers);  // the tile's P^T is written
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          // s[4 i .. 4 i + 3]: keys gid (then gid + 8) at rows 8 i + 2 tig and 8 i + 2 tig + 1
          const float4 pv = *xchg_at(sh.x, i, t);
          s[4 * i] = pv.x * (s[4 * i] - d[i].x) * scale;
          s[4 * i + 1] = pv.y * (s[4 * i + 1] - d[i].y) * scale;
          s[4 * i + 2] = pv.z * (s[4 * i + 2] - d[i].x) * scale;
          s[4 * i + 3] = pv.w * (s[4 * i + 3] - d[i].y) * scale;
        }
        hp::named_barrier_arrive(kBarXFree, kConsumers);  // the buffer may take the next P^T
      }

      // dV += P^T g or dK += dS^T Q on the block: the fragments rounded to T, g or Q MN-major
      uint32_t a[4][4];
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) fl::c_to_a<T>(a[kt], &s[8 * kt], &s[8 * kt + 4]);
      block_products<T, NW>(cs, acc, a, wg);
      if (last) break;
    }
    if (held) cs.release_resident();
    store_rows<T, NW>(acc, out, static_cast<size_t>(HK) * D, (static_cast<size_t>(w.b) * Sk * HK + w.hk) * D,
                      w.kt * kBN, key_l, Sk, first, count, tig);
  }
  if constexpr (!kPSide) hp::named_barrier(kBarXFree, kConsumers);  // take warpgroup 1's last arrival
}

template <typename T, int NW>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel_wide(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_g,
                          const int* __restrict__ bounds, const float* __restrict__ lse,
                          const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int B, int Sq,
                          int Sk, int H, int HK, int D, int Hm, int C, int causal, float scale,
                          int* __restrict__ sched) {
  const BwdPlan p = bwd_plan(D, true);
  extern __shared__ unsigned char smem_raw[];
  const Shared sh = shared_of(smem_raw, p);
  const int n_kt = (Sk + kBN - 1) / kBN;
  const int items = n_kt * HK * B * p.split;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  init_barriers(sh, p.stages);

  if (warp >= kConsumerWarps) {
    hp::reg_dealloc<kProducerRegs>();
    if (warp > kConsumerWarps) return;
    // ---- producer warp: per item K and V (resident unless streaming), then the walk's live query tiles ----
    if (lane == 0) {
      hp::tma_prefetch(&tm_q);
      hp::tma_prefetch(&tm_g);
      hp::tma_prefetch(&tm_k);
      hp::tma_prefetch(&tm_v);
    }
    const int G = H / HK;
    const int n_qt = (Sq + kBM - 1) / kBM;
    Cursor cur;
    for (int it = blockIdx.x, n = 0;; ++n) {
      hp::mbar_wait(sh.res_empty, (n & 1) ^ 1);  // the last item's resident pair is done with
      if (it >= items) {
        if (lane == 0) {
          *sh.item = -1;
          hp::mbar_arrive(sh.res_full);
        }
        break;
      }
      int next = 0;
      if (lane == 0) next = atomicAdd(sched, 1) + static_cast<int>(gridDim.x);
      const int cb = it % p.split;
      const fl::KeyItem w = key_item(it / p.split, HK, B);
      const int k0 = w.kt * kBN;
      int first, unused;
      group_boxes(p.nbox, p.groups, cb, &first, &unused);
      const Src k{&tm_k, w.hk, k0}, v{&tm_v, w.hk, k0};
      if (lane == 0) produce_resident(p, sh, it, k, v, w.b);
      // for each query head of the group, the query tiles from the causal floor
      // to the walk's end, classed from the key tile's bounds (staged once per
      // mask head); every tile that is not SKIP gets its slots
      const int lo = fl::key_walk_floor(k0, kBM, Sq, Sk, causal);
      const int c1 = min(k0 + kBN, Sk);
      int mn[4] = {0, 0, 0, 0}, mx[4] = {0, 0, 0, 0};
      bool ended = false;
      for (int gi = 0; gi < G; ++gi) {
        const int h = w.hk * G + gi;
        if (C && (gi == 0 || Hm > 1)) {  // the mask head's bounds of the key tile
          const int* bb = bounds + (static_cast<size_t>(w.b) * Hm + (Hm == 1 ? 0 : h)) * Sk * C;
          __syncwarp();  // every lane is done with the previous head's
          fl::stage_bounds(sh.stg, bb, C, k0, c1, lane);
          fl::warp_bounds_minmax(sh.stg, c1 - k0, C, mn, mx, lane);
        }
        const int hi = fl::key_walk_end(mn, mx, C, kBM, Sq, n_qt);
        const size_t row0 = (static_cast<size_t>(w.b) * H + h) * Sq;  // the (batch, head)'s lse and delta
        for (int t0 = lo; t0 < hi; t0 += 32) {
          const int mine = t0 + lane < hi
                               ? fl::tile_class_of(mn, mx, C, (t0 + lane) * kBM, kBM, k0, kBN, Sq, Sk, causal)
                               : fl::kSkip;
          unsigned live = __ballot_sync(0xffffffffu, mine != fl::kSkip);
          const bool final_pass = gi == G - 1 && t0 + 32 >= hi;  // this pass holds the walk's last tile
          while (live) {
            const int j = __ffs(live) - 1;
            live &= live - 1;
            const int r0 = (t0 + j) * kBM;
            const int cls = __shfl_sync(0xffffffffu, mine, j);
            const bool last = final_pass && live == 0;
            const Src q{&tm_q, h, r0}, g{&tm_g, h, r0};
            produce_tile(p, sh, cur, make_int2(r0, cls | (last ? fl::kLastTile : 0)), q, g, k, v, g, first, q,
                         first, w.b, lane, [&](int st) {
                           float* ls = sh.stats + st * 2 * kBM;
                           for (int r = lane; r < kBM; r += 32) {
                             if (r0 + r < Sq) {
                               hp::cp_async4(ls + r, lse + row0 + r0 + r);
                               hp::cp_async4(ls + kBM + r, delta + row0 + r0 + r);
                             } else {  // past Sq: p = 0
                               ls[r] = fl::kInf;
                               ls[kBM + r] = 0.f;
                             }
                           }
                           if (cls != fl::kPartial) return;
                           for (int cl = lane; cl < kBN; cl += 32)
                             sh.masks[st * kBN + cl] =
                                 fl::rows_mask64(sh.stg + cl * C, C, k0 + cl, r0, Sq, Sk, causal);
                         });
            ended = last;
          }
        }
      }
      if (!ended) end_item(p, sh, cur, lane);
      it = __shfl_sync(0xffffffffu, next, 0);
    }
  } else {
    hp::reg_alloc<kConsumerRegs>();
    if (warp < 4) {
      consume_dkv<T, NW, false>(p, sh, dv, B, HK, Sk, D, scale, warp, lane);
    } else {
      consume_dkv<T, NW, true>(p, sh, dk, B, HK, Sk, D, scale, warp, lane);
    }
  }
}

// -- host ---------------------------------------------------------------------------

template <typename T, int NW, bool kDkv>
int launch_nw(const BwdPlan& p, const void* q, const void* k, const void* v, const void* bounds, const void* g,
              const void* lse, const void* delta, void* out0, void* out1, void* sched, int B, int Sq, int Sk, int H,
              int HK, int D, int Hm, int C, int causal, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tg;
  int err = hp::encode_row_tiles<T>(&tq, q, B, Sq, H, D, kBM);
  if (!err) err = hp::encode_row_tiles<T>(&tg, g, B, Sq, H, D, kBM);
  if (!err) err = hp::encode_row_tiles<T>(&tk, k, B, Sk, HK, D, kBN);
  if (!err) err = hp::encode_row_tiles<T>(&tv, v, B, Sk, HK, D, kBN);
  if (err) return err;
  int sms = 0;
  err = hp::sm_count(&sms);
  if (err) return err;
  const int regs = kConsumers * kConsumerRegs + 128 * kProducerRegs;
  const int* bnd = static_cast<const int*>(bounds);
  const float *ls = static_cast<const float*>(lse), *dl = static_cast<const float*>(delta);
  int* sc = static_cast<int*>(sched);
  if constexpr (kDkv) {
    auto kernel = flash_bwd_dkv_kernel_wide<T, NW>;
    err = ptt::allow_smem(kernel, p.bytes);
    if (!err) err = hp::check_reg_split(kernel, kThreads, regs);
    if (err) return err;
    const int items = (Sk + kBN - 1) / kBN * HK * B * p.split;
    kernel<<<items < sms ? items : sms, kThreads, p.bytes, stream>>>(tq, tk, tv, tg, bnd, ls, dl, static_cast<T*>(out0),
                                                                     static_cast<T*>(out1), B, Sq, Sk, H, HK, D, Hm,
                                                                     C, causal, scale, sc);
  } else {
    auto kernel = flash_bwd_dq_kernel_wide<T, NW>;
    err = ptt::allow_smem(kernel, p.bytes);
    if (!err) err = hp::check_reg_split(kernel, kThreads, regs);
    if (err) return err;
    const int items = (Sq + kBM - 1) / kBM * H * B * p.split;
    kernel<<<items < sms ? items : sms, kThreads, p.bytes, stream>>>(tq, tk, tv, tg, bnd, ls, dl, static_cast<T*>(out0),
                                                                     B, Sq, Sk, H, HK, D, Hm, C, causal, scale, sc);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kDkv>
int launch(const void* q, const void* k, const void* v, const void* bounds, const void* g, const void* lse,
           const void* delta, void* out0, void* out1, void* sched, int B, int Sq, int Sk, int H, int HK, int D, int Hm,
           int C, int causal, float scale, void* stream) {
  if (D <= 256 || D % 64) return static_cast<int>(cudaErrorInvalidValue);
  const BwdPlan p = bwd_plan(D, kDkv);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (p.nw) {
    case 3:
      return launch_nw<T, 3, kDkv>(p, q, k, v, bounds, g, lse, delta, out0, out1, sched, B, Sq, Sk, H, HK, D, Hm, C,
                                   causal, scale, st);
    case 4:
      return launch_nw<T, 4, kDkv>(p, q, k, v, bounds, g, lse, delta, out0, out1, sched, B, Sq, Sk, H, HK, D, Hm, C,
                                   causal, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, g [B, Sq, H, D], k/v [B, Sk, HK, D] contiguous, 16-byte aligned, in T;
// bounds [B, Hm, Sk, C] int32 or null (C = 0); lse, delta [B, H, Sq] fp32;
// dq [B, Sq, H, D], dk / dv [B, Sk, HK, D] in T; sched one int32, 0 (the item
// scheduler's counter). D is a multiple of 64 above 256; anything else
// returns cudaErrorInvalidValue. The arguments are flash_bwd_dq.cu's and
// flash_bwd_dkv.cu's.
#define PTT_FLASH_BWD_WIDE_ENTRIES(SUFFIX, T)                                                                      \
  extern "C" int ptt_flash_bwd_dq_wgmma_wide_##SUFFIX(const void* q, const void* k, const void* v,                \
                                                      const void* bounds, const void* g, const void* lse,          \
                                                      const void* delta, void* dq, void* sched, int B, int Sq,     \
                                                      int Sk, int H, int HK, int D, int Hm, int C, int causal,     \
                                                      float scale, void* stream) {                                 \
    return launch<T, false>(q, k, v, bounds, g, lse, delta, dq, nullptr, sched, B, Sq, Sk, H, HK, D, Hm, C,        \
                            causal, scale, stream);                                                                \
  }                                                                                                                \
  extern "C" int ptt_flash_bwd_dkv_wgmma_wide_##SUFFIX(const void* q, const void* k, const void* v,               \
                                                       const void* bounds, const void* g, const void* lse,         \
                                                       const void* delta, void* dk, void* dv, void* sched, int B,  \
                                                       int Sq, int Sk, int H, int HK, int D, int Hm, int C,        \
                                                       int causal, float scale, void* stream) {                    \
    return launch<T, true>(q, k, v, bounds, g, lse, delta, dk, dv, sched, B, Sq, Sk, H, HK, D, Hm, C, causal,      \
                           scale, stream);                                                                         \
  }

PTT_FLASH_BWD_WIDE_ENTRIES(bf16, ptt::bf16)
PTT_FLASH_BWD_WIDE_ENTRIES(fp16, ptt::f16)

// The plan of head dim D for dq (dkv 0) or dk/dv (dkv 1) as 6 ints: boxes,
// boxes an owner computes (nw), CTAs a tile (split), stream, ring stages,
// dynamic shared-memory bytes (chip_smoke.py holds
// kernels/flash_attention.py `flash_bwd_wide_plan` to it).
extern "C" int ptt_flash_bwd_wide_plan(int D, int dkv, int* plan) {
  if (D <= 256 || D % 64) return static_cast<int>(cudaErrorInvalidValue);
  const BwdPlan p = bwd_plan(D, dkv != 0);
  plan[0] = p.nbox;
  plan[1] = p.nw;
  plan[2] = p.split;
  plan[3] = p.stream;
  plan[4] = p.stages;
  plan[5] = p.bytes;
  return 0;
}
