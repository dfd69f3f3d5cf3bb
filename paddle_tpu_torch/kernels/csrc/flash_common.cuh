// Shared pieces of the flash-attention kernels (flash_fwd.cu,
// flash_fwd_wide.cu, flash_bwd_dq.cu, flash_bwd_dkv.cu, flash_bwd_wide.cu,
// flash_fwd_tf32.cu, flash_bwd_tf32.cu, flash_fp32.cu, flash_deep.cu): the
// FlashMask test, the FlashMask tile classes, the fp32 walks' staging, the
// producer/consumer rings of the wgmma kernels 14-16 and their walks.
//
// wgmma keeps mma.sync m16n8k16's fragment layouts per warp (hopper.cuh).
// With lane = 4 * gid + tig:
//   A 16x16 (row-major): a0 = (gid, 2tig..+1), a1 = (gid+8, 2tig..+1),
//                        a2 = (gid, 2tig+8..+9), a3 = (gid+8, 2tig+8..+9)
//   C 16x8  (fp32):      c0,c1 = (gid, 2tig..+1), c2,c3 = (gid+8, 2tig..+1)
// Two adjacent C tiles (n = 0..7 and 8..15) of one row block are exactly the
// A fragment of a k16 step, so probabilities and dS (14, 15) or their
// transposes (16) feed the next product straight from registers. Each
// 32-bit register holds two 16-bit values, the lower column in the low half.
#pragma once

#include <climits>

#include "hopper.cuh"

namespace ptt {
namespace flash {

constexpr float kInf = __builtin_huge_valf();

using hopper::pack2;

// the A fragment of k16 step t built from C tiles 2t and 2t+1 (fp32 -> T)
template <typename T>
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float* c0, const float* c1) {
  a[0] = pack2<T>(c0[0], c0[1]);
  a[1] = pack2<T>(c0[2], c0[3]);
  a[2] = pack2<T>(c1[0], c1[1]);
  a[3] = pack2<T>(c1[2], c1[3]);
}

// True where the logit of query row `row` and key column `col` is masked:
// padding columns, the causal limit col > row + (Sk - Sq), and the column's
// FlashMask bounds `bnd` (C of them; C = 0 means no FlashMask).
__device__ __forceinline__ bool masked(int row, int col, int Sq, int Sk, int causal,
                                       const int* bnd, int C) {
  if (col >= Sk) return true;
  if (causal && col > row + (Sk - Sq)) return true;
  if (C == 1) return row >= bnd[0];
  if (C == 2) return row >= bnd[0] && row < bnd[1];
  if (C == 4) return (row >= bnd[0] && row < bnd[1]) || (row >= bnd[2] && row < bnd[3]);
  return false;
}

// The FlashMask tile classes of a (query tile [r0, r0 + BM), key tile
// [c0, c0 + BN)) pair. SKIP: every logit is masked (no load, no product);
// FULL: no logit is masked (no mask arithmetic); PARTIAL: the per-element
// mask runs. The classing is conservative: a tile it cannot prove SKIP or
// FULL is PARTIAL. kernels/flash_attention.py `flash_tile_classes` mirrors
// it for the tests and chip_smoke.py.
enum TileClass : int { kSkip = 0, kPartial = 1, kFull = 2 };

// The bounds of one key tile as one warp holds them: lane l has columns
// c0 + l + 32 i (i < BN / 32, at least 1), values v[i][j] for j < C (0 past
// Sk or for a column beyond the tile).
template <int BN>
struct TileBounds {
  static constexpr int kPer = (BN + 31) / 32;
  int v[kPer][4];
};

// The class of a tile from the per-slot min and max (mn, mx) of its bounds
// over the tile's real columns (ignored when C == 0).
__device__ __forceinline__ int tile_class_of(const int (&mn)[4], const int (&mx)[4], int C, int r0, int BM, int c0,
                                             int BN, int Sq, int Sk, int causal) {
  const int r1 = min(r0 + BM, Sq);  // the tile's real rows end here
  const int c1 = min(c0 + BN, Sk);
  const int shift = Sk - Sq;
  if (r1 <= r0 || c1 <= c0) return kSkip;
  if (causal && c0 > r1 - 1 + shift) return kSkip;
  bool full = r0 + BM <= Sq && c0 + BN <= Sk && (!causal || c0 + BN - 1 <= r0 + shift);
  if (C == 0) return full ? kFull : kPartial;
  const int rb = r0 + BM;  // FULL needs every row real, so the tile ends here
  if (C == 1) {            // rows [s, Sq) masked
    if (mx[0] <= r0) return kSkip;
    full = full && mn[0] >= rb;
  } else if (C == 2) {     // rows [s, e) masked
    if (mx[0] <= r0 && mn[1] >= r1) return kSkip;
    full = full && (mn[0] >= rb || mx[1] <= r0);
  } else {                 // rows [LTS, LTE) or [UTS, UTE) masked
    if ((mx[0] <= r0 && mn[1] >= r1) || (mx[2] <= r0 && mn[3] >= r1)) return kSkip;
    full = full && (mn[0] >= rb || mx[1] <= r0) && (mn[2] >= rb || mx[3] <= r0);
  }
  return full ? kFull : kPartial;
}

// Load the key tile's BN x C bounds into `tb` (the calling warp, whole and
// converged: lane l takes columns c0 + l + 32 i, coalesced) and return the
// per-slot min and max over the tile's real columns, reduced over the warp.
template <int BN>
__device__ __forceinline__ void warp_tile_bounds(TileBounds<BN>& tb, int (&mn)[4], int (&mx)[4], const int* bb,
                                                 int C, int c0, int Sk, int lane) {
#pragma unroll
  for (int j = 0; j < 4; ++j) mn[j] = INT_MAX, mx[j] = INT_MIN;
#pragma unroll
  for (int i = 0; i < TileBounds<BN>::kPer; ++i) {
    const int cl = lane + 32 * i, col = c0 + cl;
    const bool in = cl < BN && col < Sk;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int x = (in && j < C) ? bb[static_cast<size_t>(col) * C + j] : 0;
      tb.v[i][j] = x;
      if (in) mn[j] = min(mn[j], x), mx[j] = max(mx[j], x);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mn[j] = min(mn[j], __shfl_xor_sync(0xffffffffu, mn[j], o));
      mx[j] = max(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], o));
    }
  }
}

// The class of the tile, the same in every lane of the calling warp (which
// must be whole and converged), with its bounds left in `tb`. bb: the
// (batch, mask head)'s bounds [Sk][C], null when C == 0.
template <int BN>
__device__ __forceinline__ int warp_tile_class(TileBounds<BN>& tb, const int* bb, int C, int r0, int BM, int c0,
                                               int Sq, int Sk, int causal, int lane) {
  int mn[4], mx[4];
  if (C) warp_tile_bounds<BN>(tb, mn, mx, bb, C, c0, Sk, lane);
  return tile_class_of(mn, mx, C, r0, BM, c0, BN, Sq, Sk, causal);
}

// The first n bits of 64 (n in [0, 64]).
__device__ __forceinline__ uint64_t low_bits(int n) { return n >= 64 ? ~0ull : (1ull << n) - 1ull; }

// Rows [lo, hi) of a 128-row tile (row numbers relative to the tile, any
// int) or-ed into its mask m[0] (rows 0-63), m[1] (rows 64-127).
__device__ __forceinline__ void add_rows(uint64_t (&m)[2], int lo, int hi) {
  lo = max(lo, 0);
  hi = min(hi, 128);
  if (hi <= lo) return;
  m[0] |= low_bits(min(hi, 64)) & ~low_bits(min(lo, 64));
  m[1] |= low_bits(max(hi - 64, 0)) & ~low_bits(max(lo - 64, 0));
}

// The masked rows of a BM-row query tile from r0 (BM / 32 words, bit r of
// word w = row r0 + 32 w + r) for each column of a key tile whose bounds
// `v` holds ([column][C], from column c0), written to words[column * 4 + w]
// (4 words a column) by the calling warp: the mask of `masked` for every
// (row, column) of the tile at once, as at most three row intervals a
// column (the causal prefix and C's bands), so that a consumer thread tests
// its rows' bits with one shared load a column.
template <int BN, int BM>
__device__ __forceinline__ void warp_tile_mask(uint32_t* words, const int* v, int C, int r0, int c0, int Sq, int Sk,
                                               int causal, int lane) {
  static_assert(BM == 128, "the row masks cover a 128-row query tile");
  for (int cl = lane; cl < BN; cl += 32) {
    const int col = c0 + cl;
    uint64_t m[2] = {0ull, 0ull};
    if (col >= Sk) {
      m[0] = m[1] = ~0ull;
    } else {
      if (causal) add_rows(m, -1, col - (Sk - Sq) - r0);  // col > row + Sk - Sq: the rows before
      const int* vc = v + cl * C;
      if (C == 1) add_rows(m, vc[0] - r0, 128);
      if (C >= 2) add_rows(m, vc[0] - r0, vc[1] - r0);
      if (C == 4) add_rows(m, vc[2] - r0, vc[3] - r0);
    }
    uint4 w;
    w.x = static_cast<uint32_t>(m[0]);
    w.y = static_cast<uint32_t>(m[0] >> 32);
    w.z = static_cast<uint32_t>(m[1]);
    w.w = static_cast<uint32_t>(m[1] >> 32);
    *reinterpret_cast<uint4*>(words + cl * 4) = w;
  }
}

// Rows [r0, r0 + R) of a head's [S][stride] fp32 rows (D of them used)
// into s[R][LD] by cp.async, 16 bytes a copy, zeros past S: the staging of
// the fp32 tensor-core walks (flash_fwd_tf32.cu, flash_bwd_tf32.cu), whose
// THREADS threads all take part.
template <int R, int D, int LD, int THREADS>
__device__ __forceinline__ void stage_rows(float* s, const float* src, size_t stride, int r0, int S) {
  constexpr int kChunks = R * D / 4;
#pragma unroll 4
  for (int i = threadIdx.x; i < kChunks; i += THREADS) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    const bool in = r0 + r < S;
    hopper::cp_async16_zfill(s + r * LD + c, in ? src + static_cast<size_t>(r0 + r) * stride + c : src, in);
  }
}

// -- the mainloop shared by kernels 14 and 15 (flash_fwd.cu, flash_bwd_dq.cu) --

// One CTA walks work items (128-row query tile, head, batch) in turn: a
// persistent grid of one CTA per SM takes items i, i + grid, i + 2 grid,
// ... The query tile runs fastest, so the items in flight at once share a
// few heads' K and V in L2; under `causal` a head's longest query tiles come
// first, and a CTA's items spread over the lengths.
struct Item {
  int qt, h, b;
};

__device__ __forceinline__ Item item_of(int i, int n_qt, int H, int causal) {
  const int rank = i % n_qt, bh = i / n_qt;
  return Item{causal ? n_qt - 1 - rank : rank, bh % H, bh / H};
}

// The first key tile past the causal limit of the query tile at r0 (BM
// rows; all tiles without causal).
__device__ __forceinline__ int walk_end(int r0, int BM, int BN, int Sq, int Sk, int causal) {
  const int n_tiles = (Sk + BN - 1) / BN;
  if (!causal) return n_tiles;
  const long long lim = static_cast<long long>(r0) + BM + (Sk - Sq);
  if (lim <= 0) return 0;
  const long long need = (lim + BN - 1) / BN;
  return need < n_tiles ? static_cast<int>(need) : n_tiles;
}

// The ring of K/V slots between the producer warp and the consumer
// warpgroups: S slots of a K and a V tile (BN x D each, as D / 64 swizzled
// boxes), each with its tile's row-mask words (4 a column, PARTIAL tiles
// only), an info word (key tile, class; tile -1 ends an item's walk) and a
// full / empty mbarrier pair. The producer and every consumer thread keep
// their own (stage, phase).
template <int BN, int D, int S>
struct KvRing {
  static constexpr int kTileBytes = BN * D * 2;
  unsigned char* k;  // S K tiles, then...
  unsigned char* v;  // ...S V tiles
  uint32_t* mask;    // [S][BN * 4]
  int2* info;        // [S]
  uint64_t* full;    // [S], 32 arrivals (the producer warp) + the tiles' bytes
  uint64_t* empty;   // [S], one arrival per consumer warp
  int stage = 0;
  uint32_t phase = 0;

  __device__ __forceinline__ unsigned char* k_tile() const { return k + stage * kTileBytes; }
  __device__ __forceinline__ unsigned char* v_tile() const { return v + stage * kTileBytes; }
  __device__ __forceinline__ uint32_t* masks() const { return mask + stage * BN * 4; }
  __device__ __forceinline__ void advance() {
    if (++stage == S) stage = 0, phase ^= 1;
  }
};

// The bounds staging buffer of the producer warp: the bounds of up to
// kStageInts / (BN C) key tiles at once.
constexpr int kStageInts = 4096;

// Copy the bounds of columns [c0, c1) ([column][C] ints from bb) into stg
// with cp.async (16-byte copies where the source is aligned), and wait.
__device__ __forceinline__ void stage_bounds(int* stg, const int* bb, int C, int c0, int c1, int lane) {
  const int* src = bb + static_cast<size_t>(c0) * C;
  const int n = (c1 - c0) * C;
  const int n16 = (reinterpret_cast<uintptr_t>(src) & 15) == 0 ? n / 4 : 0;
  for (int i = lane; i < n16; i += 32) hopper::cp_async16(stg + 4 * i, src + 4 * i);
  for (int i = 4 * n16 + lane; i < n; i += 32) hopper::cp_async4(stg + i, src + i);
  hopper::cp_async_wait_all();
  __syncwarp();
}

// The class of a key tile whose bounds `v` ([column][C] ints from column
// c0, 16-byte aligned, in shared memory) one lane reads alone, 16 bytes at a
// time; the lanes of a warp class 32 staged tiles at once. Each lane starts
// at its own 16-byte chunk, so the warp's reads spread over the banks.
template <int BN, int C>
__device__ __forceinline__ int staged_tile_class(const int* v, int r0, int BM, int c0, int Sq, int Sk, int causal,
                                                 int lane) {
  constexpr int kChunks = BN * C / 4;
  int mn[4] = {INT_MAX, INT_MAX, INT_MAX, INT_MAX}, mx[4] = {INT_MIN, INT_MIN, INT_MIN, INT_MIN};
  const int n = min(BN, Sk - c0) * C;  // the real columns' values
  const int4* v4 = reinterpret_cast<const int4*>(v);
#pragma unroll 4
  for (int k = 0; k < kChunks; ++k) {
    const int kk = (k + lane) % kChunks;
    const int4 x = v4[kk];
    const int e[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      if (4 * kk + m < n) mn[m % C] = min(mn[m % C], e[m]), mx[m % C] = max(mx[m % C], e[m]);
    }
  }
  return tile_class_of(mn, mx, C, r0, BM, c0, BN, Sq, Sk, causal);
}

// The classes of tiles [t0, t0 + nt) of a staged round (tile i's bounds at
// stg + i BN C), lane j holding tile t0 + j + 32 g's for its pass g.
template <int BN>
__device__ __forceinline__ int staged_class(const int* stg, int i, int C, int r0, int BM, int t0, int Sq, int Sk,
                                            int causal) {
  const int* v = stg + i * BN * C;
  const int c0 = (t0 + i) * BN;
  if (C == 1) return staged_tile_class<BN, 1>(v, r0, BM, c0, Sq, Sk, causal, i);
  if (C == 2) return staged_tile_class<BN, 2>(v, r0, BM, c0, Sq, Sk, causal, i);
  if (C == 4) return staged_tile_class<BN, 4>(v, r0, BM, c0, Sq, Sk, causal, i);
  const int none[4] = {0, 0, 0, 0};  // C == 0 reads no bounds
  return tile_class_of(none, none, 0, r0, BM, c0, BN, Sq, Sk, causal);
}

// The info word's flag on the walk's last tile (after its class).
constexpr int kLastTile = 4;

// The producer warp's walk over key tiles [0, hi) of a query tile of BM
// rows from r0: the bounds of a run of tiles are staged in shared memory
// (`stg`, kStg ints) with one round of copies; each tile is then classed
// from them (32 at a time, one a lane) and `emit(t, cls, i, last)` runs,
// in the whole warp, for every tile that is not SKIP, in order: t the
// tile, i its index in the staged run (its bounds at stg + i BN C), `last`
// on the walk's last tile. Returns whether a tile carried `last` (false:
// the final pass held no tile, and the caller ends the item itself).
template <int BN, int kStg, typename Emit>
__device__ __forceinline__ bool walk_live_tiles(int* stg, const int* bb, int C, int r0, int BM, int hi, int Sq,
                                                int Sk, int causal, int lane, Emit&& emit) {
  const int per = C ? kStg / (BN * C) : hi;  // tiles a staging round holds
  bool ended = false;
  for (int t0 = 0; t0 < hi; t0 += per) {
    const int n = min(per, hi - t0);
    if (C) stage_bounds(stg, bb, C, t0 * BN, min((t0 + n) * BN, Sk), lane);
    for (int i0 = 0; i0 < n; i0 += 32) {
      const int mine = i0 + lane < n ? staged_class<BN>(stg, i0 + lane, C, r0, BM, t0, Sq, Sk, causal) : kSkip;
      unsigned live = __ballot_sync(0xffffffffu, mine != kSkip);
      const bool final_pass = t0 + min(i0 + 32, n) >= hi;  // this pass holds the walk's last tile
      while (live) {
        const int j = __ffs(live) - 1;
        live &= live - 1;
        const int cls = __shfl_sync(0xffffffffu, mine, j);
        const bool last = final_pass && live == 0;
        emit(t0 + i0 + j, cls, i0 + j, last);
        ended = last;
      }
    }
  }
  return ended;
}

// The producer warp's walk of one item: key tiles [0, hi), classed by
// walk_live_tiles BEFORE any copy of their K and V. SKIP tiles take no
// slot; every other tile's K and V go into the next slot by TMA, and a
// PARTIAL tile's row masks are written while they fly. The walk's last tile
// carries kLastTile; only a walk whose final pass holds no tile sends a slot
// of its own (tile -1) to end the item.
template <int BN, int BM, int D, int S>
__device__ __forceinline__ void produce_walk(KvRing<BN, D, S>& ring, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                             int* stg, const int* bb, int C, int r0, int hi, int Sq, int Sk,
                                             int causal, int hk, int b, int lane) {
  const bool ended = walk_live_tiles<BN, kStageInts>(
      stg, bb, C, r0, BM, hi, Sq, Sk, causal, lane, [&](int t, int cls, int i, bool last) {
        const int c0 = t * BN;
        hopper::mbar_wait(&ring.empty[ring.stage], ring.phase ^ 1);  // the slot's last tile is consumed
        uint64_t* bar = &ring.full[ring.stage];
        if (lane == 0) {  // the copies first: the row masks are computed while they fly
          ring.info[ring.stage] = make_int2(t, cls | (last ? kLastTile : 0));
          hopper::mbar_expect_tx(bar, 2 * KvRing<BN, D, S>::kTileBytes);
#pragma unroll
          for (int x = 0; x < D / 64; ++x) {
            hopper::tma_load_4d(ring.k_tile() + x * BN * 128, tm_k, bar, x * 64, hk, c0, b);
            hopper::tma_load_4d(ring.v_tile() + x * BN * 128, tm_v, bar, x * 64, hk, c0, b);
          }
        }
        if (cls == kPartial) warp_tile_mask<BN, BM>(ring.masks(), stg + i * BN * C, C, r0, c0, Sq, Sk, causal, lane);
        hopper::mbar_arrive(bar);  // every lane: its masks and (lane 0) the info word are written
        ring.advance();
      });
  if (!ended) {  // nothing to flag: a slot of its own ends the item
    hopper::mbar_wait(&ring.empty[ring.stage], ring.phase ^ 1);
    if (lane == 0) ring.info[ring.stage] = make_int2(-1, 0);
    hopper::mbar_arrive(&ring.full[ring.stage]);
    ring.advance();
  }
}

// A consumer warpgroup's epilogue: its 64 rows of a 128-row tile (this
// thread's rows row_l and row_l + 8 of the tile, value pairs packed to T in
// v[box][j][r]) written into the shared tile `buf` (boxes of 128 rows x 64
// columns, 128-byte swizzled as a TMA load leaves them: chunk c of row r at
// c ^ (r % 8)), then sent to the tensor map by one thread as D / 64 TMA
// stores of 64 rows from tile row r0 + 64 wg; returns when every thread of
// the warpgroup may reuse `buf`.
template <int D>
__device__ __forceinline__ void store_rows_tma(unsigned char* buf, const uint32_t (&v)[D / 64][8][2], int row_l,
                                               int tig, int wg, const CUtensorMap* map, int h, int r0, int b) {
#pragma unroll
  for (int x = 0; x < D / 64; ++x)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row_l + 8 * r;
        *reinterpret_cast<uint32_t*>(buf + x * 128 * 128 + row * 128 + ((j ^ (row & 7)) << 4) + 4 * tig) = v[x][j][r];
      }
  hopper::fence_proxy_async();
  hopper::named_barrier(1 + wg, 128);
  if (threadIdx.x % 128 == 0) {
#pragma unroll
    for (int x = 0; x < D / 64; ++x)
      hopper::tma_store_4d(map, buf + x * 128 * 128 + wg * 64 * 128, x * 64, h, r0 + wg * 64, b);
    hopper::tma_store_wait_read();
  }
  hopper::named_barrier(1 + wg, 128);
}

// -- the transposed walk of kernel 16 (flash_bwd_dkv.cu) ---------------------

// One CTA owns a work item (BN-key tile, KV head, batch) and walks the query
// tiles of the KV head's query heads past its resident K and V. The key
// tile runs fastest, so the items in flight at once share a few heads' Q and
// g in L2. Under `causal` the lowest key tile has the longest walk (every
// query row at or after it sees it), so this order is the longest first
// within a head, as item_of's is for 14 and 15.
struct KeyItem {
  int kt, hk, b;
};

__device__ __forceinline__ KeyItem key_item_of(int i, int n_kt, int HK) {
  const int bh = i / n_kt;
  return KeyItem{i % n_kt, bh % HK, bh / HK};
}

// The first BM-row query tile that can see key k0 under `causal` (the rows
// before (k0 - (Sk - Sq)) see none of the tile's keys); 0 without causal.
__device__ __forceinline__ int key_walk_floor(int k0, int BM, int Sq, int Sk, int causal) {
  const int first = k0 - (Sk - Sq);  // the first query row that can see key k0
  return causal && first > 0 ? first / BM : 0;
}

// The end of a key tile's walk over n_qt query tiles, from the per-slot
// min and max of its bounds: under C=1 (rows [s, Sq) masked), and under C=2
// when every band reaches Sq (min e >= Sq), no row at or past max s is
// visible, so the walk ends at the tile holding row max s - 1. Every tile
// past that end is SKIP in tile_class_of, so the cut only saves classing.
__device__ __forceinline__ int key_walk_end(const int (&mn)[4], const int (&mx)[4], int C, int BM, int Sq, int n_qt) {
  if (C == 1 || (C == 2 && mn[1] >= Sq)) {
    const int end = mx[0] <= 0 ? 0 : (mx[0] + BM - 1) / BM;
    return end < n_qt ? end : n_qt;
  }
  return n_qt;
}

// The per-slot min and max of a key tile's bounds staged in shared memory
// (`v`: ncols columns of C ints), in every lane of the calling warp (whole
// and converged; lane l reads columns l + 32 i).
__device__ __forceinline__ void warp_bounds_minmax(const int* v, int ncols, int C, int (&mn)[4], int (&mx)[4],
                                                   int lane) {
#pragma unroll
  for (int j = 0; j < 4; ++j) mn[j] = INT_MAX, mx[j] = INT_MIN;
  for (int cl = lane; cl < ncols; cl += 32) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < C) mn[j] = min(mn[j], v[cl * C + j]), mx[j] = max(mx[j], v[cl * C + j]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mn[j] = min(mn[j], __shfl_xor_sync(0xffffffffu, mn[j], o));
      mx[j] = max(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], o));
    }
  }
}

// The masked rows of a 64-row query tile from r0 (bit r = row r0 + r) for
// key column `col`, whose C bounds `vc` holds: `masked` for the whole
// column at once, as at most three row intervals (the causal prefix and C's
// bands); every row of a column past Sk.
__device__ __forceinline__ uint64_t rows_mask64(const int* vc, int C, int col, int r0, int Sq, int Sk, int causal) {
  if (col >= Sk) return ~0ull;
  uint64_t m[2] = {0ull, 0ull};  // add_rows' 128-row form: rows 64-127 are dropped
  if (causal) add_rows(m, -1, col - (Sk - Sq) - r0);  // col > row + Sk - Sq: the rows before
  if (C == 1) add_rows(m, vc[0] - r0, 128);
  if (C >= 2) add_rows(m, vc[0] - r0, vc[1] - r0);
  if (C == 4) add_rows(m, vc[2] - r0, vc[3] - r0);
  return m[0];
}

// The ring of query-tile slots between kernel 16's producer warp and its
// consumer warpgroups: S slots of a Q and a g tile (BM x D each, as D / 64
// swizzled boxes), the tile rows' lse and delta (fp32; lse +inf and delta 0
// past Sq), for a PARTIAL tile one 64-bit row mask per key column
// (rows_mask64), an info word (the tile's first row, its class and the
// kLastTile flag; row -1 ends an item's walk) and a full / empty mbarrier
// pair. The producer and every consumer thread keep their own (stage, phase).
template <int BN, int BM, int D, int S>
struct QgRing {
  static_assert(BM == 64, "the row masks and the stats cover a 64-row query tile");
  static constexpr int kTileBytes = BM * D * 2;
  unsigned char* q;  // S Q tiles, then...
  unsigned char* g;  // ...S g tiles
  uint64_t* mask;    // [S][BN]
  float* stats;      // [S][2][BM]: lse, delta
  int2* info;        // [S]
  uint64_t* full;    // [S]: 32 arrivals of the producer warp, 32 of its lanes' cp.async (the stats), the tiles' bytes
  uint64_t* empty;   // [S], one arrival per consumer warp
  int stage = 0;
  uint32_t phase = 0;

  __device__ __forceinline__ unsigned char* q_tile() const { return q + stage * kTileBytes; }
  __device__ __forceinline__ unsigned char* g_tile() const { return g + stage * kTileBytes; }
  __device__ __forceinline__ uint64_t* masks() const { return mask + stage * BN; }
  __device__ __forceinline__ float* lse() const { return stats + stage * 2 * BM; }
  __device__ __forceinline__ float* delta() const { return stats + stage * 2 * BM + BM; }
  __device__ __forceinline__ void advance() {
    if (++stage == S) stage = 0, phase ^= 1;
  }
};

// A consumer warp is done with its ring slot (its wgmmas have completed):
// a KvRing's or a QgRing's.
template <typename Ring>
__device__ __forceinline__ void release_slot(Ring& ring, int lane) {
  __syncwarp();
  if (lane == 0) hopper::mbar_arrive(&ring.empty[ring.stage]);
  ring.advance();
}

}  // namespace flash
}  // namespace ptt
