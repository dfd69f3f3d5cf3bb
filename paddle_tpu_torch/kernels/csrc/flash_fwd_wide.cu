// Flash-attention forward on the tensor cores for every head dim above 256
// (a multiple of 64, D a runtime value), bf16 and fp16: out = softmax(scale
// q k^T + mask) v and the row logsumexp lse, for q [B, Sq, H, D] and k, v
// [B, Sk, HK, D], read in place. Up to D 256 flash_fwd.cu runs; fp32 takes
// flash_fp32.cu (to 512) and flash_deep.cu (above).
//
// Replaces: paddle_tpu/kernels/flash_attention.py `_fwd_kernel` (launched by
// `_run_fwd`, entry `flash_attention_pallas`) at head dims above 256.
//
// Semantics as flash_fwd.cu's (see there): masked logits contribute exactly
// 0, the online softmax runs in fp32, P is rounded to T for P V while l sums
// the fp32 p, a row with no visible column writes out = 0 with lse = +inf,
// and lse [B, H, Sq] fp32 feeds kernels 15 and 16 unchanged.
//
// Where flash_fwd.cu's design stops: a 64-row warpgroup's O accumulator is
// n256 at most (128 fp32 registers a thread beside S and P, of the
// consumers' 224). So O's columns go over column blocks
// of at most 256 (4 boxes of 64), one per consumer warpgroup, and every
// warpgroup computes S = Q K^T over the whole of D for its rows. Of the two
// ways (recompute S per column block, or compute S once and hand P between
// warpgroups) this takes the first: no shared P buffer, no barrier between
// warpgroups, and both warpgroups walk one ring in lockstep. S's recompute
// costs 1.5x the forward's flops up to D 512 (two column blocks) and 2.5x
// at 1024 (four).
//
// Design (Hopper). A persistent grid of one CTA per SM walks work items
// (64-row query tile, head, batch, column block of the CTA), the longest
// query tiles first under `causal` (flash_common.cuh `item_of`), the CTAs
// of one query tile adjacent so they share K and V in L2. Both consumer
// warpgroups own the SAME 64 query rows and different column blocks: the
// D / 64 boxes go over 2 `split` warpgroups, `split` the count of least
// work (each warpgroup pays S over all of D and its boxes of P V;
// `wide_split`), and every warpgroup of a launch computes the same NW
// (2-4) boxes, the kernel's instance: one that owns one box fewer
// recomputes its neighbour's first and does not store it. At D 320-512
// that is one CTA a query tile (NW 3, 4), at 576 two (NW 3), at 1024 two
// (NW 4). Four boxes a warpgroup at most was the fastest against two and
// three on an H100 80GB HBM3 at 700 W (PERF.md §6).
// - The producer warp loads the item's Q (D / 64 boxes of [64 rows][64],
//   resident for the item), then walks the key tiles (flash_common.cuh
//   `walk_live_tiles`: SKIP tiles cost nothing) and streams each through a
//   ring of 16 KB slots: ceil(D / 128) K slots of two 64-column boxes (the
//   scores' reduction over D), then the V slots, slot j holding box j of
//   each warpgroup's column block. A PARTIAL tile's row masks (one 64-bit
//   word a key, flash_common.cuh `rows_mask64`) ride in its last K slot.
// - The consumers run S = Q K^T as wgmma SS, 8 k16 steps a K slot (the
//   next slot's copy lands while the last one's products run), then the
//   scale, mask and online softmax on the fp32 accumulator, and O += P V
//   as wgmma RS (P from registers, V MN-major from the slot), one V slot a
//   box. out leaves from registers (4-byte stores: at these head dims the
//   products, not the stores, take the time). Inside the wgmma pipelines
//   nothing branches on a value ptxas cannot prove warp-uniform (it would
//   serialise the wgmmas: C7520), so waits and releases are single asm
//   statements and control words are broadcast from lane 0.
// Shared memory (227 KB a CTA): Q D / 64 x 8 KB, the ring's slots 16 KB
// each, 8 KB of bounds staging. At D 512 Q takes 64 KB and the ring 8
// slots; at D 1024, Q 128 KB and 5 slots. Above D 1152 Q no longer leaves
// room for 4 slots: it then rides in the K slots beside K (32 KB slots, 6
// of them), read again from L2 for every key tile (`stream_q`).
//
// Bound on H100: operations, 4 D flops per visible (row, column) at the
// tensor cores' 989 TFLOP/s (bf16, fp16).
#include "flash_common.cuh"

namespace hp = ptt::hopper;
namespace fl = ptt::flash;

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kBM = 64;                    // query rows per CTA (both consumer warpgroups)
constexpr int kBN = 64;                    // keys per tile
constexpr int kBox = 64 * 128;             // one [64 rows][64 columns] box of a 2-byte type
constexpr int kConsumers = 256;            // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup (one warp of it works)
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kConsumerRegs = 224;
constexpr int kProducerRegs = (168 * kThreads - kConsumers * kConsumerRegs) / 128;
static_assert(kProducerRegs >= 24 && kProducerRegs % 8 == 0, "setmaxnreg takes 24..256 in steps of 8");
constexpr int kMaxWgBoxes = 4;  // a warpgroup's O: at most 4 boxes (256 columns, 128 registers)
constexpr int kMinStages = 4;   // slots the ring needs (a consumer holds at most 2 while it waits)
constexpr int kMaxStages = 8;
constexpr int kStgInts = 2048;  // the producer's bounds staging (8 KB)
constexpr int kSmem = 227 * 1024;
constexpr int kSlotSide = kBN * 2 * 4 + 8;  // a slot's row masks (2 words a key) and info word
constexpr int kFixed = kStgInts * 4 + (2 + 2 * kMaxStages) * 8 + 16 + 1024;  // staging, barriers, item, alignment

// The launch plan of head dim D (kernels/flash_attention.py
// `flash_fwd_wide_plan` mirrors it; ptt_flash_fwd_wide_plan reports it).
// Offsets are from the 1024-byte-aligned base of dynamic shared memory.
struct WidePlan {
  int nbox;      // D / 64
  int nw;        // boxes of O each warpgroup computes (the kernel's instance)
  int split;     // CTAs a query tile
  int stream_q;  // 1: Q rides in the K slots (too wide to stay resident)
  int slot;      // bytes of a slot: 2 boxes (+ 2 Q boxes when streaming)
  int stages;
  int ring, mask, info, stg, bar, item, bytes;
};

// The warpgroups' share of O: the D / 64 boxes go over 2 split warpgroups
// as evenly as floors allow (first box g nbox / n); every warpgroup computes
// nw = ceil(nbox / n) boxes from its first, so that one instance serves the
// launch, and stores its own (a warpgroup with one box fewer recomputes its
// neighbour's first). split: the one of 1..ceil(nbox / 2) CTAs whose
// products cost least, each warpgroup paying the scores over all of D and
// its nw boxes of P V (nw at most kMaxWgBoxes).
__host__ __device__ inline void wide_split(int nbox, int* split, int* nw) {
  long best = -1;
  for (int sp = (nbox + 2 * kMaxWgBoxes - 1) / (2 * kMaxWgBoxes); sp <= (nbox + 1) / 2; ++sp) {
    const int w = (nbox + 2 * sp - 1) / (2 * sp);
    const long cost = 2L * sp * (nbox + w);
    if (best < 0 || cost < best) best = cost, *split = sp, *nw = w;
  }
}

__host__ __device__ inline WidePlan wide_plan(int D) {
  WidePlan p;
  p.nbox = D / 64;
  wide_split(p.nbox, &p.split, &p.nw);
  int q = p.nbox * kBox;
  p.stream_q = kSmem - kFixed - q < kMinStages * (2 * kBox + kSlotSide);
  if (p.stream_q) q = 0;
  p.slot = (p.stream_q ? 4 : 2) * kBox;
  p.stages = (kSmem - kFixed - q) / (p.slot + kSlotSide);
  if (p.stages > kMaxStages) p.stages = kMaxStages;
  p.ring = q;
  p.mask = p.ring + p.stages * p.slot;
  p.info = p.mask + p.stages * kBN * 2 * 4;
  p.stg = p.info + (p.stages * 8 + 15) / 16 * 16;
  p.bar = p.stg + kStgInts * 4;
  p.item = p.bar + (2 + 2 * p.stages) * 8;
  p.bytes = p.item + 16 + 1024;
  return p;
}

// the first box and the count of boxes that warpgroup g (of 2 split) stores
__host__ __device__ inline void wg_boxes(int nbox, int split, int g, int* first, int* count) {
  const int n = 2 * split;
  *first = g * nbox / n;
  *count = (g + 1) * nbox / n - *first;
}

// The row masks of a 64-row query tile from r0 for the key tile at c0 (its
// bounds `v`, [column][C]), two words a key, by the calling warp.
__device__ __forceinline__ void wide_tile_mask(uint32_t* words, const int* v, int C, int r0, int c0, int Sq, int Sk,
                                               int causal, int lane) {
  for (int cl = lane; cl < kBN; cl += 32) {
    const uint64_t m = fl::rows_mask64(v + cl * C, C, c0 + cl, r0, Sq, Sk, causal);
    *reinterpret_cast<uint2*>(words + 2 * cl) = make_uint2(static_cast<uint32_t>(m), static_cast<uint32_t>(m >> 32));
  }
}

// x = s * sl2 (log2 units) with masked logits at -inf (kMask: this thread's
// rows are bits bit0 and bit0 + 8 of word `word` of each key's two), the
// rows' maxima into mx
template <bool kMask>
__device__ __forceinline__ void scale_mask(float (&s)[32], float (&mx)[2], float sl2, const uint32_t* msk, int word,
                                           int bit0, int tig) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float x0 = s[4 * j + c] * sl2, x1 = s[4 * j + 2 + c] * sl2;
      if constexpr (kMask) {
        const uint32_t bits = msk[(8 * j + 2 * tig + c) * 2 + word] >> bit0;
        if (bits & 1u) x0 = -fl::kInf;
        if (bits & 0x100u) x1 = -fl::kInf;
      }
      s[4 * j + c] = x0;
      s[4 * j + 2 + c] = x1;
      mx[0] = fmaxf(mx[0], x0);
      mx[1] = fmaxf(mx[1], x1);
    }
  }
}

// S (+)= Q K^T over one K slot: box 0's 4 k16 steps, and box 1's where the
// slot holds two (the first step overwrites S where kZero)
template <typename T, bool kZero>
__device__ __forceinline__ void s_slot(float (&s)[32], const unsigned char* qa, const unsigned char* kb, bool two) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    hp::wgmma_ss<T, kBN>(s, hp::desc_sw128(qa + kk * 32, 16, 1024), hp::desc_sw128(kb + kk * 32, 16, 1024),
                         kZero && kk == 0 ? 0 : 1);
  if (two) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hp::wgmma_ss<T, kBN>(s, hp::desc_sw128(qa + kBox + kk * 32, 16, 1024),
                           hp::desc_sw128(kb + kBox + kk * 32, 16, 1024), 1);
  }
}

template <typename T, int NW>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel_wide(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, const int* __restrict__ bounds, T* __restrict__ out,
                      float* __restrict__ lse, int B, int Sq, int Sk, int H, int HK, int D, int Hm, int C, int causal,
                      float scale, int* __restrict__ sched) {
  const WidePlan p = wide_plan(D);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* q_s = base;  // the item's Q boxes (resident)
  unsigned char* ring = base + p.ring;  // the slots
  uint32_t* masks = reinterpret_cast<uint32_t*>(base + p.mask);  // [stages][kBN * 2]: a PARTIAL tile's masked rows
  int2* info = reinterpret_cast<int2*>(base + p.info);  // [stages]: (key tile, class | kLastTile); -1 ends an item
  int* stg = reinterpret_cast<int*>(base + p.stg);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + p.bar);  // 1 arrival + Q's bytes
  uint64_t* q_empty = q_full + 1;                                 // one arrival per consumer warp
  uint64_t* full = q_full + 2;         // [stages]: 32 arrivals (the producer warp) + the slot's bytes
  uint64_t* empty = full + p.stages;   // [stages]: one arrival per consumer warp
  volatile int* item_s = reinterpret_cast<int*>(base + p.item);

  const int n_qt = (Sq + kBM - 1) / kBM;
  const int items = n_qt * H * B * p.split;
  const int nks = (p.nbox + 1) / 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    hp::mbar_init(q_full, 1);
    hp::mbar_init(q_empty, kConsumerWarps);
    for (int s = 0; s < p.stages; ++s) {
      hp::mbar_init(&full[s], 32);               // every producer lane arrives
      hp::mbar_init(&empty[s], kConsumerWarps);  // one arrival per consumer warp
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    hp::reg_dealloc<kProducerRegs>();
    if (warp > kConsumerWarps) return;  // the producer warpgroup's other warps only give up their registers
    // ---- producer warp: per item, Q, then each live key tile's K slots and V slots ----
    if (lane == 0) {
      hp::tma_prefetch(&tm_q);
      hp::tma_prefetch(&tm_k);
      hp::tma_prefetch(&tm_v);
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int it = blockIdx.x, n = 0;; ++n) {
      hp::mbar_wait(q_empty, (n & 1) ^ 1);  // the last item's Q is done with
      if (it >= items) {  // none left: tell the consumers
        if (lane == 0) {
          *item_s = -1;
          hp::mbar_arrive(q_full);
        }
        break;
      }
      int next = 0;
      if (lane == 0) next = atomicAdd(sched, 1) + static_cast<int>(gridDim.x);
      const int cb = it % p.split;
      const fl::Item w = fl::item_of(it / p.split, n_qt, H, causal);
      const int r0 = w.qt * kBM, hk = w.h / (H / HK);
      int v0, v1, unused;
      wg_boxes(p.nbox, p.split, 2 * cb, &v0, &unused);
      wg_boxes(p.nbox, p.split, 2 * cb + 1, &v1, &unused);
      if (lane == 0) {
        *item_s = it;
        if (p.stream_q) {
          hp::mbar_arrive(q_full);
        } else {
          hp::mbar_arrive_expect_tx(q_full, p.nbox * kBox);
          for (int x = 0; x < p.nbox; ++x) hp::tma_load_4d(q_s + x * kBox, &tm_q, q_full, x * 64, w.h, r0, w.b);
        }
      }
      const int* bb = C ? bounds + (static_cast<size_t>(w.b) * Hm + (Hm == 1 ? 0 : w.h)) * Sk * C : nullptr;
      const bool ended = fl::walk_live_tiles<kBN, kStgInts>(
          stg, bb, C, r0, kBM, fl::walk_end(r0, kBM, kBN, Sq, Sk, causal), Sq, Sk, causal, lane,
          [&](int t, int cls, int i, bool last) {
            const int c0 = t * kBN;
            const int2 tinfo = make_int2(t, cls | (last ? fl::kLastTile : 0));
            for (int c = 0; c < nks + NW; ++c) {  // K (and, streaming, Q) slots, then V slots
              hp::mbar_wait(&empty[stage], phase ^ 1);  // the slot's last use is released
              uint64_t* bar = &full[stage];
              unsigned char* slot = ring + stage * p.slot;
              if (lane == 0) {  // the copies first: the row masks are computed while they fly
                info[stage] = tinfo;
                if (c < nks) {  // K boxes 2c, 2c + 1
                  const int nb = min(2, p.nbox - 2 * c);
                  hp::mbar_expect_tx(bar, nb * kBox * (p.stream_q ? 2 : 1));
                  for (int x = 0; x < nb; ++x) {
                    hp::tma_load_4d(slot + x * kBox, &tm_k, bar, (2 * c + x) * 64, hk, c0, w.b);
                    if (p.stream_q) hp::tma_load_4d(slot + (2 + x) * kBox, &tm_q, bar, (2 * c + x) * 64, w.h, r0, w.b);
                  }
                } else {  // V: box j of each warpgroup's share
                  const int j = c - nks;
                  hp::mbar_expect_tx(bar, 2 * kBox);
                  hp::tma_load_4d(slot, &tm_v, bar, (v0 + j) * 64, hk, c0, w.b);
                  hp::tma_load_4d(slot + kBox, &tm_v, bar, (v1 + j) * 64, hk, c0, w.b);
                }
              }
              if (c == nks - 1 && cls == fl::kPartial)
                wide_tile_mask(masks + stage * kBN * 2, stg + i * kBN * C, C, r0, c0, Sq, Sk, causal, lane);
              hp::mbar_arrive(bar);  // every lane: its masks and (lane 0) the info word are written
              if (++stage == p.stages) stage = 0, phase ^= 1;
            }
          });
      if (!ended) {  // nothing to flag: a slot of its own ends the item
        hp::mbar_wait(&empty[stage], phase ^ 1);
        if (lane == 0) info[stage] = make_int2(-1, 0);
        hp::mbar_arrive(&full[stage]);
        if (++stage == p.stages) stage = 0, phase ^= 1;
      }
      it = __shfl_sync(0xffffffffu, next, 0);
    }
  } else {
    hp::reg_alloc<kConsumerRegs>();
    // ---- consumer warpgroups: the same 64 query rows, NW boxes of O each ----
    // Inside the wgmma pipelines nothing branches on a value the compiler cannot
    // prove warp-uniform: control words read from shared memory are broadcast from
    // lane 0, waits and arrivals are single asm statements (hopper.cuh mbar_wait_loop,
    // mbar_arrive_if).
    const int wg = warp >> 2, wl = warp & 3;
    const int gid = lane >> 2, tig = lane & 3;
    const int row_l = wl * 16 + gid;  // this thread's rows of the tile: row_l, row_l + 8
    const int word = wl >> 1, bit0 = (wl & 1) * 16 + gid;
    const float sl2 = scale * kLog2e;
    int stage = 0, rel = 0;  // the next slot to wait on, the oldest slot held
    uint32_t phase = 0;
    auto take = [&]() {
      if (++stage == p.stages) stage = 0, phase ^= 1;
    };
    auto release = [&]() {
      __syncwarp();
      hp::mbar_arrive_if(&empty[rel], lane == 0);
      if (++rel == p.stages) rel = 0;
    };
    for (int n = 0;; ++n) {
      hp::mbar_wait_loop(q_full, n & 1);  // the item's Q landed
      const int it = __shfl_sync(0xffffffffu, *item_s, 0);
      if (it < 0) break;
      const int cb = it % p.split;
      const fl::Item w = fl::item_of(it / p.split, n_qt, H, causal);
      bool q_held = !p.stream_q;
      if (!q_held) {  // the item is read: the producer may go on
        __syncwarp();
        hp::mbar_arrive_if(q_empty, lane == 0);
      }
      int first, count;
      wg_boxes(p.nbox, p.split, 2 * cb + wg, &first, &count);
      float o[NW][32];
#pragma unroll
      for (int x = 0; x < NW; ++x)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[x][i] = 0.f;
      float m[2] = {-fl::kInf, -fl::kInf}, l[2] = {0.f, 0.f};
      while (true) {
        hp::mbar_wait_loop(&full[stage], phase);
        const int2 tw = info[stage];
        const int tile = __shfl_sync(0xffffffffu, tw.x, 0), flags = __shfl_sync(0xffffffffu, tw.y, 0);
        if (tile < 0) {  // the walk ended without a tile to flag
          take();
          release();
          break;
        }
        const bool last = flags & fl::kLastTile;

        // S = Q K^T over the K slots; a slot goes back once the next one's
        // products are issued and its own are done
        float s[kBN / 2];
        hp::wgmma_fence();
        const unsigned char* slot = ring + stage * p.slot;
        s_slot<T, true>(s, p.stream_q ? slot + 2 * kBox : q_s, slot, p.nbox > 1);
        hp::wgmma_commit();
        take();
        for (int c = 1; c < nks; ++c) {
          hp::mbar_wait_loop(&full[stage], phase);
          slot = ring + stage * p.slot;
          s_slot<T, false>(s, p.stream_q ? slot + 2 * kBox : q_s + 2 * c * kBox, slot, 2 * c + 1 < p.nbox);
          hp::wgmma_commit();
          take();
          hp::wgmma_wait<1>();
          release();
        }
        hp::wgmma_wait<0>();
        hp::fence_regs(s);
        if (q_held && last) {  // the item's last product with Q is done: the producer may load the next item's
          __syncwarp();
          hp::mbar_arrive_if(q_empty, lane == 0);
          q_held = false;
        }

        // the scale, the mask (held in the tile's last K slot) and the online softmax
        float mx[2] = {-fl::kInf, -fl::kInf};
        if ((flags & 3) == fl::kPartial) {
          scale_mask<true>(s, mx, sl2, masks + rel * kBN * 2, word, bit0, tig);
        } else {
          scale_mask<false>(s, mx, sl2, nullptr, 0, 0, tig);
        }
        release();  // the last K slot
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m[r], mx[r]);
          alpha[r] = (m_new == -fl::kInf) ? 1.f : hp::exp2_approx(m[r] - m_new);
          m[r] = m_new;
        }
        float ls[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i) {
          const int r = (i >> 1) & 1;
          const float pv = (m[r] == -fl::kInf) ? 0.f : hp::exp2_approx(s[i] - m[r]);
          s[i] = pv;
          ls[r] += pv;
        }
        l[0] = l[0] * alpha[0] + ls[0];
        l[1] = l[1] * alpha[1] + ls[1];
#pragma unroll
        for (int x = 0; x < NW; ++x)
#pragma unroll
          for (int i = 0; i < 32; ++i) o[x][i] *= alpha[(i >> 1) & 1];

        // O += P V: P from registers (rounded to T), this warpgroup's box of each V slot
        uint32_t pa[kBN / 16][4];
#pragma unroll
        for (int kt = 0; kt < kBN / 16; ++kt) fl::c_to_a<T>(pa[kt], &s[8 * kt], &s[8 * kt + 4]);
        hp::wgmma_fence();
#pragma unroll
        for (int x = 0; x < NW; ++x) {
          hp::mbar_wait_loop(&full[stage], phase);
          const unsigned char* vb = ring + stage * p.slot + wg * kBox;
#pragma unroll
          for (int kt = 0; kt < kBN / 16; ++kt)
            hp::wgmma_rs_n64<T>(o[x], pa[kt], hp::desc_sw128(vb + kt * 16 * 128, kBox, 1024), 1);
          hp::wgmma_commit();
          take();
          if (x) {
            hp::wgmma_wait<1>();
            release();
          }
        }
        hp::wgmma_wait<0>();
#pragma unroll
        for (int x = 0; x < NW; ++x) hp::fence_regs(o[x]);
#pragma unroll
        for (int kt = 0; kt < kBN / 16; ++kt) hp::fence_regs(pa[kt]);
        release();
        if (last) break;
      }
      if (q_held) {
        __syncwarp();
        hp::mbar_arrive_if(q_empty, lane == 0);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = w.qt * kBM + row_l + 8 * r;
        const bool seen = l[r] > 0.f;
        inv[r] = seen ? 1.f / fmaxf(l[r], 1e-30f) : 0.f;
        if (cb == 0 && wg == 0 && tig == 0 && row < Sq)  // lse: once, from column block 0
          lse[(static_cast<size_t>(w.b) * H + w.h) * Sq + row] = seen ? m[r] * kLn2 + logf(l[r]) : fl::kInf;
      }
      // out from registers: the boxes this warpgroup owns (a recomputed neighbour's box is not stored)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = w.qt * kBM + row_l + 8 * r;
        if (row >= Sq) continue;
        T* dst = out + ((static_cast<size_t>(w.b) * Sq + row) * H + w.h) * D + first * 64 + 2 * tig;
#pragma unroll
        for (int x = 0; x < NW; ++x) {
          if (x >= count) break;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            *reinterpret_cast<uint32_t*>(dst + x * 64 + 8 * j) =
                hp::pack2<T>(o[x][4 * j + 2 * r] * inv[r], o[x][4 * j + 2 * r + 1] * inv[r]);
        }
      }
    }
  }
}

template <typename T, int NW>
int launch_nw(const WidePlan& p, const void* q, const void* k, const void* v, const void* bounds, void* out, void* lse,
              void* sched, int B, int Sq, int Sk, int H, int HK, int D, int Hm, int C, int causal, float scale,
              cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = hp::encode_row_tiles<T>(&tq, q, B, Sq, H, D, kBM);
  if (!err) err = hp::encode_row_tiles<T>(&tk, k, B, Sk, HK, D, kBN);
  if (!err) err = hp::encode_row_tiles<T>(&tv, v, B, Sk, HK, D, kBN);
  if (err) return err;
  auto kernel = flash_fwd_kernel_wide<T, NW>;
  err = ptt::allow_smem(kernel, p.bytes);
  if (!err) err = hp::check_reg_split(kernel, kThreads, kConsumers * kConsumerRegs + 128 * kProducerRegs);
  int sms = 0;
  if (!err) err = hp::sm_count(&sms);
  if (err) return err;
  const int items = (Sq + kBM - 1) / kBM * H * B * p.split;
  kernel<<<items < sms ? items : sms, kThreads, p.bytes, stream>>>(
      tq, tk, tv, static_cast<const int*>(bounds), static_cast<T*>(out), static_cast<float*>(lse), B, Sq, Sk, H, HK,
      D, Hm, C, causal, scale, static_cast<int*>(sched));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bounds, void* out, void* lse, void* sched, int B,
           int Sq, int Sk, int H, int HK, int D, int Hm, int C, int causal, float scale, cudaStream_t stream) {
  if (D <= 256 || D % 64) return static_cast<int>(cudaErrorInvalidValue);
  const WidePlan p = wide_plan(D);
  switch (p.nw) {
    case 2: return launch_nw<T, 2>(p, q, k, v, bounds, out, lse, sched, B, Sq, Sk, H, HK, D, Hm, C, causal, scale, stream);
    case 3: return launch_nw<T, 3>(p, q, k, v, bounds, out, lse, sched, B, Sq, Sk, H, HK, D, Hm, C, causal, scale, stream);
    case 4: return launch_nw<T, 4>(p, q, k, v, bounds, out, lse, sched, B, Sq, Sk, H, HK, D, Hm, C, causal, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q [B, Sq, H, D], k/v [B, Sk, HK, D] contiguous, 16-byte aligned, in T;
// bounds [B, Hm, Sk, C] int32 or null (C = 0); out [B, Sq, H, D] in T; lse
// [B, H, Sq] fp32; sched one int32, 0 (the item scheduler's counter). D is a
// multiple of 64 above 256; anything else returns cudaErrorInvalidValue.
extern "C" int ptt_flash_fwd_wgmma_wide_bf16(const void* q, const void* k, const void* v, const void* bounds,
                                             void* out, void* lse, void* sched, int B, int Sq, int Sk, int H, int HK,
                                             int D, int Hm, int C, int causal, float scale, void* stream) {
  return launch<ptt::bf16>(q, k, v, bounds, out, lse, sched, B, Sq, Sk, H, HK, D, Hm, C, causal, scale,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int ptt_flash_fwd_wgmma_wide_fp16(const void* q, const void* k, const void* v, const void* bounds,
                                             void* out, void* lse, void* sched, int B, int Sq, int Sk, int H, int HK,
                                             int D, int Hm, int C, int causal, float scale, void* stream) {
  return launch<ptt::f16>(q, k, v, bounds, out, lse, sched, B, Sq, Sk, H, HK, D, Hm, C, causal, scale,
                          static_cast<cudaStream_t>(stream));
}

// The plan of head dim D as 6 ints: boxes, boxes a warpgroup computes (nw),
// CTAs a query tile (split), stream_q, ring stages, dynamic shared-memory
// bytes (chip_smoke.py holds kernels/flash_attention.py
// `flash_fwd_wide_plan` to it).
extern "C" int ptt_flash_fwd_wide_plan(int D, int* plan) {
  if (D <= 256 || D % 64) return static_cast<int>(cudaErrorInvalidValue);
  const WidePlan p = wide_plan(D);
  plan[0] = p.nbox;
  plan[1] = p.nw;
  plan[2] = p.split;
  plan[3] = p.stream_q;
  plan[4] = p.stages;
  plan[5] = p.bytes;
  return 0;
}
