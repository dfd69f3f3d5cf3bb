// Flash-attention backward, dk and dv: for each key column,
// dv = sum over visible rows of p g and dk = sum of ds q, with
// p = exp(scale q k^T - lse) (0 where masked) and ds = p (g v^T - delta)
// scale, summed over the query heads of the column's KV head (GQA), for
// q, g [B, Sq, H, D] and k, v [B, Sk, HK, D] read in place in that layout,
// in bf16 or fp16 (fp32: flash_fp32.cu); lse and delta [B, H, Sq] fp32.
//
// Replaces: paddle_tpu/kernels/flash_attention.py `_bwd_dkv_kernel`
// (launched by `_run_bwd`), the second half of the attention's backward.
// The Pallas kernel runs once per query head and writes fp32 [B, H, Sk, D]
// partials that XLA sums over the group afterwards; here one work item owns
// a (key tile, KV head, batch) and walks the group's query heads itself, so
// dk and dv stay in fp32 registers and are written once, in k's dtype, with
// no atomics (deterministic).
//
// Semantics kept from the Pallas kernel: query tiles are walked from the
// causal start floor((k0 - (Sk - Sq)) / BM) (0 if negative) to the end; the
// mask is flash_common.cuh `masked`, and rows past Sq contribute nothing
// (their lse reads as +inf); the product q k^T is scaled, not q; P^T and
// dS^T are rounded to the input type for their products with g and q.
//
// Design (Hopper): the transpose of kernels 14/15's walk. A persistent grid
// of one CTA per SM takes (64-key tile, KV head, batch) items from an atomic
// counter (flash_common.cuh `key_item_of`: under `causal` the lowest key
// tile, the longest walk, first); two consumer warpgroups and one producer
// warp (setmaxnreg moves the rest of its warpgroup's registers to the
// consumers).
// - K and V [64, D] are loaded once per item by TMA into one of two
//   resident buffers (the next item's arrive during this one's walk where
//   they fit: D 64 and 128) and stay for the whole walk.
// - The producer stages the key tile's 64 x C bounds once per (item, mask
//   head), reduces them to the per-slot min and max, and classes each
//   64-row query tile by arithmetic (`tile_class_of`, the classes of 14/15
//   with rows and columns swapped) BEFORE any copy: a SKIP tile costs no
//   copy and no product, and under C=1 (or C=2 with every band reaching Sq)
//   the walk ends at the last row any column sees (`key_walk_end`). The
//   other tiles' Q and g go through a ring of slots (QgRing: full and empty
//   mbarriers) by TMA, their lse and delta by cp.async (+inf and 0 past
//   Sq), and for a PARTIAL tile one 64-bit row mask per key column is built
//   while the copies fly.
// - Both consumer warpgroups own the item's 64 keys and take every slot.
//   Warpgroup 0 runs S^T = K Q^T as wgmma SS (keys as M, the slot's rows as
//   N, all operands K-major), P^T = exp2(S^T scale log2e - lse log2e) on the
//   accumulator (the mask on PARTIAL tiles only: one bit a (key, row) from
//   two 64-bit words a thread; lse read per column), hands P^T in fp32 to
//   warpgroup 1 through one of two shared buffers (named barriers), and runs
//   dV += P^T g as wgmma RS: P^T rounded to T in registers (a C fragment
//   pair is an A fragment), g as MN-major B read from the same swizzled TMA
//   tile, so no transposed copy of Q or g exists. Warpgroup 1 runs
//   dP^T = V g^T, then dS^T = P^T (dP^T - delta) scale, and dK += dS^T Q
//   likewise. Each warpgroup holds one of dk / dv (64 keys x D: 64 fp32 a
//   thread at D 128) beside one 64 x 64 product, which the registers hold
//   without serialising the wgmmas; holding both (128 keys a CTA, 64 a
//   warpgroup, with S^T and dP^T at once) did not: ptxas serialised every
//   wgmma (C7512) and spilled whatever the setmaxnreg split.
// - dk and dv leave through the item's K and V buffers (free once both
//   warpgroups are done with them) by TMA stores of full 128-byte rows; the
//   buffers go back to the producer once the stores have read them.
// - The walk is the same at every head dim: 64 x 64 tiles; one K/V buffer
//   at D 192 and 256 (and one P^T buffer at D 256).
//
// Bound on H100: operations — four products of 2 D flops per visible
// (row, column) against 2 x 4 D bytes per key and per query row at S 4096.
// Not done yet: each Q and g tile feeds 64 keys (twice the L2 reads of a
// 128-key tile); a warpgroup's exponentials do not overlap its own products
// (FA3's intra-warpgroup pipelining); at D 192 and 256 the 128 or 96 fp32 of
// dk or dv a thread still serialise the wgmmas.
#include "flash_common.cuh"

namespace hp = ptt::hopper;
namespace fl = ptt::flash;

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBM = 64;                     // query rows per streamed tile
constexpr int kBN = 64;                     // keys per work item
constexpr int kConsumers = 256;             // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup (one warp of it works)
constexpr int kConsumerWarps = kConsumers / 32;
// Registers a thread: the launch gives each of the 384 threads 168 (65536 /
// 384, rounded down to 8); setmaxnreg moves them from the producer
// warpgroup to the consumers, each of which holds one of dk / dv (64 fp32 a
// thread at D 128, 128 at D 256) beside S^T or dP^T (32).
// The split: the consumers need fewer at D <= 128 than at D 192 and 256
// (128 fp32 of dv a thread); what they do not need goes to the producer,
// whose walk spills to local memory at 40.
template <int D>
constexpr int kConsumerRegs = D <= 128 ? 184 : 216;
template <int D>
constexpr int kProducerRegs = (168 * kThreads - kConsumers * kConsumerRegs<D>) / 128;
static_assert(kProducerRegs<128> % 8 == 0 && kProducerRegs<256> >= 24 && kProducerRegs<256> % 8 == 0,
              "setmaxnreg takes 24..256 in steps of 8");
// Named barriers (0 is __syncthreads): 1 and 2 each consumer warpgroup's
// epilogue, 3 both consumer warpgroups, 4 + b / 6 + b the P^T buffer b full /
// free (warpgroup 0 writes it, warpgroup 1 reads it).
constexpr int kBarBoth = 3, kBarXFull = 4, kBarXFree = 6;

template <int D>
struct Dkv {
  static constexpr int kBoxes = D / 64;          // 128-byte column boxes of a row
  static constexpr int kKVBytes = kBN * D * 2;   // one K or V tile
  static constexpr int kRowBytes = kBM * D * 2;  // one Q or g tile
  static constexpr int kXBytes = kBN * kBM * 4;  // one fp32 P^T tile
  static constexpr int kSlot = 2 * kRowBytes + kBN * 8 + kBM * 8 + 8 + 16;  // + masks, stats, info, barriers
  static constexpr int kFixed = kBN * 4 * 4 + 64 + 1024;  // bounds staging, K/V barriers and items, alignment
  static constexpr int kLimit = 227 * 1024;
  // two K/V buffers (the next item's load during this item) and two P^T
  // buffers (warpgroup 0 a slot ahead of warpgroup 1) where they fit beside two slots
  static constexpr int kKvBufs = 4 * kKVBytes + 2 * kXBytes + 2 * kSlot + kFixed <= kLimit ? 2 : 1;
  static constexpr int kXBufs = 2 * kKvBufs * kKVBytes + 2 * kXBytes + 2 * kSlot + kFixed <= kLimit ? 2 : 1;
  static constexpr int kFit = (kLimit - 2 * kKvBufs * kKVBytes - kXBufs * kXBytes - kFixed) / kSlot;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  // shared memory from a 1024-byte-aligned base: K buffers, V buffers, Q
  // stages, g stages, P^T buffers, the stages' masks, stats and info words,
  // then the bounds staging and the barriers
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKvBufs * kKVBytes;
  static constexpr int kQ = kV + kKvBufs * kKVBytes;
  static constexpr int kG = kQ + kStages * kRowBytes;
  static constexpr int kX = kG + kStages * kRowBytes;
  static constexpr int kMask = kX + kXBufs * kXBytes;
  static constexpr int kStats = kMask + kStages * kBN * 8;
  static constexpr int kInfo = kStats + kStages * kBM * 8;
  static constexpr int kStg = kInfo + (kStages * 8 + 15) / 16 * 16;  // the producer's bounds staging (16-byte aligned)
  static constexpr int kBar = kStg + kBN * 4 * 4;  // kv_full[KB], kv_empty[KB], full[S], empty[S]
  static constexpr int kItem = kBar + (2 * kKvBufs + 2 * kStages) * 8;  // the item of each K/V buffer
  static constexpr int kBytes = kItem + 16 + 1024;  // + alignment slack
  using Ring = fl::QgRing<kBN, kBM, D, kStages>;
  static_assert(kStages >= 2, "two slots at least");
  static_assert(kBytes <= kLimit, "a block's shared memory");
  static_assert(kStg % 16 == 0 && kBar % 8 == 0 && kMask % 8 == 0, "cp.async, mbarrier and mask alignment");
};

// acc (+)= the SS product of the warpgroup's 64 keys of A (K or V: kBN-row
// boxes) with the slot's 64 rows of B (Q or g: kBM-row boxes) over D: D / 16
// k-steps, step kk at box kk / 4, 32 (kk % 4) bytes in (immediate offsets)
template <typename T, int... KK>
__device__ __forceinline__ void ss_keys_rows(float (&acc)[32], uint64_t da, uint64_t db,
                                             std::integer_sequence<int, KK...>) {
  (hp::wgmma_ss_n64_at<T, (KK >> 2) * kBN * 128 + (KK & 3) * 32, (KK >> 2) * kBM * 128 + (KK & 3) * 32>(acc, da, db,
                                                                                                     KK > 0),
   ...);
}

// acc[x] += a · (box x of the slot's B, MN-major) as RS steps j = kt kBoxes
// + x: the A fragments of rows [16 kt, 16 kt + 16) of the slot
template <typename T, int kBoxes, int... J>
__device__ __forceinline__ void rs_rows_cols(float (&acc)[kBoxes][32], const uint32_t (&a)[kBM / 16][4], uint64_t db,
                                             std::integer_sequence<int, J...>) {
  (hp::wgmma_rs_n64_at<T, (J % kBoxes) * kBM * 128 + (J / kBoxes) * 16 * 128>(acc[J % kBoxes], a[J / kBoxes], db, 1),
   ...);
}

// The fp32 P^T tile handed from warpgroup 0 to 1: thread t's 32 values (its
// accumulator layout, the same in both warpgroups) as 8 float4 at
// x[(4 i + t) ...]: a warp's accesses are 512 contiguous bytes
__device__ __forceinline__ float4* xchg_at(unsigned char* x, int i, int t) {
  return reinterpret_cast<float4*>(x) + i * 128 + t;
}

// A slot is ready once every producer lane has arrived twice: once when its
// lse / delta copies land (cp.async), once after its plain writes
__device__ __forceinline__ void publish(uint64_t* bar) {
  hp::cp_async_mbar_arrive(bar);
  hp::mbar_arrive(bar);
}

// The producer warp's walk of one item: for each query head of the KV
// head's group, the query tiles from the causal floor to the walk's end,
// classed from the key tile's bounds (staged once per mask head); every
// tile that is not SKIP goes into the next slot. The walk's last tile
// carries kLastTile; only a walk whose last pass holds no tile sends a slot
// of its own (row -1) to end the item.
template <int BN, int D, int S>
__device__ __forceinline__ void produce_key_walk(fl::QgRing<BN, kBM, D, S>& ring, const CUtensorMap* tm_q,
                                                 const CUtensorMap* tm_g, int* stg, const int* bounds,
                                                 const float* lse, const float* delta, int C, int Hm, int k0, int hk,
                                                 int b, int H, int HK, int Sq, int Sk, int causal, int lane) {
  using Ring = fl::QgRing<BN, kBM, D, S>;
  const int G = H / HK;
  const int n_qt = (Sq + kBM - 1) / kBM;
  const int lo = fl::key_walk_floor(k0, kBM, Sq, Sk, causal);
  const int c1 = min(k0 + BN, Sk);
  int mn[4] = {0, 0, 0, 0}, mx[4] = {0, 0, 0, 0};
  bool ended = false;
  for (int gi = 0; gi < G; ++gi) {
    const int h = hk * G + gi;
    if (C && (gi == 0 || Hm > 1)) {  // the mask head's bounds of the key tile
      const int* bb = bounds + (static_cast<size_t>(b) * Hm + (Hm == 1 ? 0 : h)) * Sk * C;
      __syncwarp();  // every lane is done with the previous head's
      fl::stage_bounds(stg, bb, C, k0, c1, lane);
      fl::warp_bounds_minmax(stg, c1 - k0, C, mn, mx, lane);
    }
    const int hi = fl::key_walk_end(mn, mx, C, kBM, Sq, n_qt);
    const size_t row0 = (static_cast<size_t>(b) * H + h) * Sq;  // the (batch, head)'s lse and delta
    for (int t0 = lo; t0 < hi; t0 += 32) {
      const int mine = t0 + lane < hi
                           ? fl::tile_class_of(mn, mx, C, (t0 + lane) * kBM, kBM, k0, BN, Sq, Sk, causal)
                           : fl::kSkip;
      unsigned live = __ballot_sync(0xffffffffu, mine != fl::kSkip);
      const bool final_pass = gi == G - 1 && t0 + 32 >= hi;  // this pass holds the walk's last tile
      while (live) {
        const int j = __ffs(live) - 1;
        live &= live - 1;
        const int r0 = (t0 + j) * kBM;
        const int cls = __shfl_sync(0xffffffffu, mine, j);
        const bool last = final_pass && live == 0;
        hp::mbar_wait(&ring.empty[ring.stage], ring.phase ^ 1);  // the slot's last tile is consumed
        uint64_t* bar = &ring.full[ring.stage];
        if (lane == 0) {  // the copies first: the stats and masks are written while they fly
          ring.info[ring.stage] = make_int2(r0, cls | (last ? fl::kLastTile : 0));
          hp::mbar_expect_tx(bar, 2 * Ring::kTileBytes);
#pragma unroll
          for (int x = 0; x < D / 64; ++x) {
            hp::tma_load_4d(ring.q_tile() + x * kBM * 128, tm_q, bar, x * 64, h, r0, b);
            hp::tma_load_4d(ring.g_tile() + x * kBM * 128, tm_g, bar, x * 64, h, r0, b);
          }
        }
        float* ls = ring.lse();
        float* dl = ring.delta();
#pragma unroll
        for (int r = lane; r < kBM; r += 32) {
          if (r0 + r < Sq) {
            hp::cp_async4(ls + r, lse + row0 + r0 + r);
            hp::cp_async4(dl + r, delta + row0 + r0 + r);
          } else {  // past Sq: p = 0
            ls[r] = fl::kInf;
            dl[r] = 0.f;
          }
        }
        if (cls == fl::kPartial) {
          uint64_t* m = ring.masks();
          for (int cl = lane; cl < BN; cl += 32) m[cl] = fl::rows_mask64(stg + cl * C, C, k0 + cl, r0, Sq, Sk, causal);
        }
        publish(bar);
        ring.advance();
        ended = last;
      }
    }
  }
  if (!ended) {  // nothing to flag: a slot of its own ends the item
    hp::mbar_wait(&ring.empty[ring.stage], ring.phase ^ 1);
    if (lane == 0) ring.info[ring.stage] = make_int2(-1, 0);
    publish(&ring.full[ring.stage]);
    ring.advance();
  }
}

// Warpgroup 0 ("V side"): per slot S^T = K Q^T, P^T = exp2(S^T scale log2e
// - lse log2e) (0 where masked: PARTIAL tiles only, one bit a (key, row) from
// two 64-bit words a thread), P^T handed to warpgroup 1 in fp32 through a
// shared buffer, then dV += P^T g with P^T rounded to T in registers and g as
// MN-major B. Warpgroup 1 ("K side"): dP^T = V g^T, then with the slot's P^T
// dS^T = P^T (dP^T - delta) scale, and dK += dS^T Q likewise. Each holds its
// one of dv / dk for the item's 64 keys and every column, and writes it once
// through its K or V buffer. lse and delta are read per column (the
// accumulator's columns are the slot's rows).
template <typename T, int D, bool kVSide>
__device__ __forceinline__ void consume(typename Dkv<D>::Ring& ring, unsigned char* sm, uint64_t* kv_full,
                                        uint64_t* kv_empty, volatile int* item_s, const CUtensorMap* tm_out,
                                        int n_kt, int HK, float scale, int warp, int lane) {
  using L = Dkv<D>;
  constexpr int kKvBufs = L::kKvBufs, kXBufs = L::kXBufs, kBoxes = L::kBoxes;
  constexpr int wg = kVSide ? 0 : 1;
  const int t = threadIdx.x % 128;
  const int gid = lane >> 2, tig = lane & 3;
  const int key_l = (warp & 3) * 16 + gid;  // this thread's keys in the tile: key_l, key_l + 8
  const float sl2 = scale * kLog2e;
  int xb = 0;  // the P^T buffer of the next slot
  if constexpr (!kVSide) {
#pragma unroll
    for (int b = 0; b < kXBufs; ++b) hp::named_barrier_arrive(kBarXFree + b, kConsumers);  // every buffer starts free
  }
  for (int n = 0;; ++n) {
    const int kb = n % kKvBufs;
    hp::mbar_wait(&kv_full[kb], (n / kKvBufs) & 1);  // the item's K and V landed
    const int it = item_s[kb];
    if (it < 0) break;
    const fl::KeyItem w = fl::key_item_of(it, n_kt, HK);
    unsigned char* k_s = sm + L::kK + kb * L::kKVBytes;
    unsigned char* v_s = sm + L::kV + kb * L::kKVBytes;
    unsigned char* own = kVSide ? v_s : k_s;  // the buffer this warpgroup's result leaves through
    // A of the first product: K (S^T) or V (dP^T); its k-steps' offsets are immediates
    const uint64_t a_desc = hp::desc_sw128_at(hp::smem_u32(kVSide ? k_s : v_s), 16, 1024);
    float acc[kBoxes][32];
#pragma unroll
    for (int i = 0; i < kBoxes; ++i)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[i][e] = 0.f;
    while (true) {
      hp::mbar_wait(&ring.full[ring.stage], ring.phase);
      const int2 ti = ring.info[ring.stage];
      if (ti.x < 0) {  // the item's walk ended without a tile to flag
        fl::release_slot(ring, lane);
        break;
      }
      const uint32_t qa = hp::smem_u32(ring.q_tile()), ga = hp::smem_u32(ring.g_tile());
      unsigned char* xbuf = sm + L::kX + xb * L::kXBytes;

      // S^T = K Q^T (V side) or dP^T = V g^T (K side): 64 keys x the slot's 64 rows
      float s[32];
      hp::wgmma_fence();
      ss_keys_rows<T>(s, a_desc, hp::desc_sw128_at(kVSide ? qa : ga, 16, 1024), std::make_integer_sequence<int, D / 16>{});
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(s);

      if constexpr (kVSide) {
        const float* lse = ring.lse();
        const bool partial = (ti.y & 3) == fl::kPartial;
        const uint64_t m0 = partial ? ring.masks()[key_l] : 0ull, m1 = partial ? ring.masks()[key_l + 8] : 0ull;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 l = *reinterpret_cast<const float2*>(lse + 8 * j + 2 * tig);
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
        hp::named_barrier(kBarXFree + xb, kConsumers);  // warpgroup 1 is done with the buffer's last P^T
#pragma unroll
        for (int i = 0; i < 8; ++i) *xchg_at(xbuf, i, t) = make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]);
        hp::named_barrier_arrive(kBarXFull + xb, kConsumers);
      } else {
        const float* dl = ring.delta();
        hp::named_barrier(kBarXFull + xb, kConsumers);  // the slot's P^T is written
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          // s[4 i .. 4 i + 3]: keys gid (then gid + 8) at columns 8 i + 2 tig and 8 i + 2 tig + 1
          const float4 p = *xchg_at(xbuf, i, t);
          const float2 d = *reinterpret_cast<const float2*>(dl + 8 * i + 2 * tig);
          s[4 * i] = p.x * (s[4 * i] - d.x) * scale;
          s[4 * i + 1] = p.y * (s[4 * i + 1] - d.y) * scale;
          s[4 * i + 2] = p.z * (s[4 * i + 2] - d.x) * scale;
          s[4 * i + 3] = p.w * (s[4 * i + 3] - d.y) * scale;
        }
        hp::named_barrier_arrive(kBarXFree + xb, kConsumers);  // the buffer may take the next P^T
      }
      if (++xb == kXBufs) xb = 0;

      // dV += P^T g (V side) or dK += dS^T Q (K side): the fragments rounded
      // to T in registers, g or Q MN-major from the slot (K = the 64 rows)
      uint32_t a[kBM / 16][4];
#pragma unroll
      for (int kt = 0; kt < kBM / 16; ++kt) fl::c_to_a<T>(a[kt], &s[8 * kt], &s[8 * kt + 4]);
      hp::wgmma_fence();
      rs_rows_cols<T, kBoxes>(acc, a, hp::desc_sw128_at(kVSide ? ga : qa, kBM * 128, 1024),
                              std::make_integer_sequence<int, kBM / 16 * kBoxes>{});
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < kBoxes; ++i) hp::fence_regs(acc[i]);
#pragma unroll
      for (int kt = 0; kt < kBM / 16; ++kt) hp::fence_regs(a[kt]);
      fl::release_slot(ring, lane);
      if (ti.y & fl::kLastTile) break;
    }
    // the result through the item's own buffer and TMA stores: both
    // warpgroups read K and V, so both must be done with them first
    hp::named_barrier(kBarBoth, kConsumers);
#pragma unroll
    for (int x = 0; x < kBoxes; ++x)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = key_l + 8 * r;
          const int at = x * kBN * 128 + row * 128 + ((j ^ (row & 7)) << 4) + 4 * tig;
          *reinterpret_cast<uint32_t*>(own + at) = hp::pack2<T>(acc[x][4 * j + 2 * r], acc[x][4 * j + 2 * r + 1]);
        }
    hp::fence_proxy_async();
    hp::named_barrier(1 + wg, 128);
    if (t == 0) {
#pragma unroll
      for (int x = 0; x < kBoxes; ++x) hp::tma_store_4d(tm_out, own + x * kBN * 128, x * 64, w.hk, w.kt * kBN, w.b);
      hp::tma_store_wait_read();
    }
    hp::named_barrier(1 + wg, 128);
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(&kv_empty[kb]);  // the buffer's stores have read it
  }
  if constexpr (kVSide) {  // take warpgroup 1's last arrivals, so that no barrier is left half done
#pragma unroll
    for (int b = 0; b < kXBufs; ++b) hp::named_barrier(kBarXFree + b, kConsumers);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_g,
                     const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_dk, const __grid_constant__ CUtensorMap tm_dv,
                     const int* __restrict__ bounds, const float* __restrict__ lse, const float* __restrict__ delta,
                     int B, int Sq, int Sk, int H, int HK, int Hm, int C, int causal, float scale,
                     int* __restrict__ sched) {
  using L = Dkv<D>;
  constexpr int kKvBufs = L::kKvBufs;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* kv_empty = kv_full + kKvBufs;
  typename L::Ring ring;
  ring.q = sm + L::kQ;
  ring.g = sm + L::kG;
  ring.mask = reinterpret_cast<uint64_t*>(sm + L::kMask);
  ring.stats = reinterpret_cast<float*>(sm + L::kStats);
  ring.info = reinterpret_cast<int2*>(sm + L::kInfo);
  ring.full = kv_empty + kKvBufs;
  ring.empty = ring.full + L::kStages;
  volatile int* item_s = reinterpret_cast<int*>(sm + L::kItem);
  int* stg = reinterpret_cast<int*>(sm + L::kStg);

  const int n_kt = (Sk + kBN - 1) / kBN;
  const int items = n_kt * HK * B;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kKvBufs; ++i) {
      hp::mbar_init(&kv_full[i], 1);
      hp::mbar_init(&kv_empty[i], kConsumerWarps);
    }
    for (int s = 0; s < L::kStages; ++s) {
      hp::mbar_init(&ring.full[s], 64);               // every producer lane arrives twice (publish)
      hp::mbar_init(&ring.empty[s], kConsumerWarps);  // one arrival per consumer warp
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    hp::reg_dealloc<kProducerRegs<D>>();
    if (warp > kConsumerWarps) return;  // the producer warpgroup's other warps only give up their registers
    // ---- producer warp: per item, K and V, then the walk's non-SKIP Q/g tiles ----
    if (lane == 0) {
      hp::tma_prefetch(&tm_q);
      hp::tma_prefetch(&tm_g);
      hp::tma_prefetch(&tm_k);
      hp::tma_prefetch(&tm_v);
    }
    // items come from the scheduler's counter: the first from blockIdx.x,
    // each next one as soon as this one starts, so its latency hides
    int n = 0;
    for (int it = blockIdx.x;; ++n) {
      const int kb = n % kKvBufs;
      hp::mbar_wait(&kv_empty[kb], ((n / kKvBufs) & 1) ^ 1);  // the buffer's last item is stored
      if (it >= items) {  // none left: tell the consumers
        if (lane == 0) {
          item_s[kb] = -1;
          hp::mbar_arrive(&kv_full[kb]);
        }
        break;
      }
      int next = 0;
      if (lane == 0) next = atomicAdd(sched, 1) + static_cast<int>(gridDim.x);
      const fl::KeyItem w = fl::key_item_of(it, n_kt, HK);
      const int k0 = w.kt * kBN;
      if (lane == 0) {
        item_s[kb] = it;
        hp::mbar_arrive_expect_tx(&kv_full[kb], 2 * L::kKVBytes);
        unsigned char* k_s = sm + L::kK + kb * L::kKVBytes;
        unsigned char* v_s = sm + L::kV + kb * L::kKVBytes;
#pragma unroll
        for (int x = 0; x < L::kBoxes; ++x) {
          hp::tma_load_4d(k_s + x * kBN * 128, &tm_k, &kv_full[kb], x * 64, w.hk, k0, w.b);
          hp::tma_load_4d(v_s + x * kBN * 128, &tm_v, &kv_full[kb], x * 64, w.hk, k0, w.b);
        }
      }
      produce_key_walk<kBN, D, L::kStages>(ring, &tm_q, &tm_g, stg, bounds, lse, delta, C, Hm, k0, w.hk, w.b, H, HK,
                                           Sq, Sk, causal, lane);
      it = __shfl_sync(0xffffffffu, next, 0);
    }
  } else {
    hp::reg_alloc<kConsumerRegs<D>>();
    if (warp < 4) {
      consume<T, D, true>(ring, sm, kv_full, kv_empty, item_s, &tm_dv, n_kt, HK, scale, warp, lane);
    } else {
      consume<T, D, false>(ring, sm, kv_full, kv_empty, item_s, &tm_dk, n_kt, HK, scale, warp, lane);
    }
    if (threadIdx.x % 128 == 0) hp::tma_store_wait_all();  // the last stores land before the CTA ends
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* bounds, const void* g, const void* lse,
           const void* delta, void* dk, void* dv, void* sched, int B, int Sq, int Sk, int H, int HK, int Hm, int C,
           int causal, float scale, cudaStream_t stream) {
  using L = Dkv<D>;
  CUtensorMap tq, tg, tk, tv, tdk, tdv;
  int err = hp::encode_row_tiles<T>(&tq, q, B, Sq, H, D, kBM);
  if (!err) err = hp::encode_row_tiles<T>(&tg, g, B, Sq, H, D, kBM);
  if (!err) err = hp::encode_row_tiles<T>(&tk, k, B, Sk, HK, D, kBN);
  if (!err) err = hp::encode_row_tiles<T>(&tv, v, B, Sk, HK, D, kBN);
  if (!err) err = hp::encode_row_tiles<T>(&tdk, dk, B, Sk, HK, D, kBN);
  if (!err) err = hp::encode_row_tiles<T>(&tdv, dv, B, Sk, HK, D, kBN);
  if (err) return err;
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  err = ptt::allow_smem(kernel, L::kBytes);
  if (!err) err = hp::check_reg_split(kernel, kThreads, kConsumers * kConsumerRegs<D> + 128 * kProducerRegs<D>);
  int sms = 0;
  if (!err) err = hp::sm_count(&sms);
  if (err) return err;
  const int items = (Sk + kBN - 1) / kBN * HK * B;
  kernel<<<items < sms ? items : sms, kThreads, L::kBytes, stream>>>(
      tq, tg, tk, tv, tdk, tdv, static_cast<const int*>(bounds), static_cast<const float*>(lse),
      static_cast<const float*>(delta), B, Sq, Sk, H, HK, Hm, C, causal, scale, static_cast<int*>(sched));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* bounds, const void* g, const void* lse,
             const void* delta, void* dk, void* dv, void* sched, int B, int Sq, int Sk, int H, int HK, int D, int Hm,
             int C, int causal, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<T, 64>(q, k, v, bounds, g, lse, delta, dk, dv, sched, B, Sq, Sk, H, HK, Hm, C, causal, scale, st);
    case 128: return launch<T, 128>(q, k, v, bounds, g, lse, delta, dk, dv, sched, B, Sq, Sk, H, HK, Hm, C, causal, scale, st);
    case 192: return launch<T, 192>(q, k, v, bounds, g, lse, delta, dk, dv, sched, B, Sq, Sk, H, HK, Hm, C, causal, scale, st);
    case 256: return launch<T, 256>(q, k, v, bounds, g, lse, delta, dk, dv, sched, B, Sq, Sk, H, HK, Hm, C, causal, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, g [B, Sq, H, D], k/v [B, Sk, HK, D] contiguous, 16-byte aligned, in T;
// bounds [B, Hm, Sk, C] int32 or null (C = 0); lse, delta [B, H, Sq] fp32;
// dk, dv [B, Sk, HK, D] in T; sched one int32, 0 (the item scheduler's
// counter). D is 64, 128, 192 or 256.
extern "C" int ptt_flash_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* bounds, const void* g,
                                      const void* lse, const void* delta, void* dk, void* dv, void* sched, int B,
                                      int Sq, int Sk, int H, int HK, int D, int Hm, int C, int causal, float scale,
                                      void* stream) {
  return dispatch<ptt::bf16>(q, k, v, bounds, g, lse, delta, dk, dv, sched, B, Sq, Sk, H, HK, D, Hm, C, causal, scale,
                             stream);
}

extern "C" int ptt_flash_bwd_dkv_fp16(const void* q, const void* k, const void* v, const void* bounds, const void* g,
                                      const void* lse, const void* delta, void* dk, void* dv, void* sched, int B,
                                      int Sq, int Sk, int H, int HK, int D, int Hm, int C, int causal, float scale,
                                      void* stream) {
  return dispatch<ptt::f16>(q, k, v, bounds, g, lse, delta, dk, dv, sched, B, Sq, Sk, H, HK, D, Hm, C, causal, scale,
                            stream);
}
