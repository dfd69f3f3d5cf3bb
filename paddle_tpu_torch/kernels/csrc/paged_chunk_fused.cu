// Paged attention over a mixed ragged chunk: every slot carries up to C new
// query tokens (a decode row has q_lens == 1, a prompt chunk up to C, an idle
// slot 0); query row j of slot b attends to cached positions
// < lens[b] + j + 1 of its paged KV blocks. Two kernels share this source:
// with ROPE on, neox rope is applied to q first (kernel A); with it off, q is
// taken as given (kernel 4, the unfused step, whose q was roped beforehand).
//
// Replaces: paddle_tpu/kernels/paged_attention.py `_chunk_fused_kernel`
// (launched by `paged_flash_chunk_fused`, the fused serving step's
// attention) and `_chunk_kernel` (launched by `paged_flash_chunk`, the
// unfused step's), each with `_dequant_tile` in its block walk when the pool
// is int8.
//
// Semantics kept from the Pallas kernels: q is roped in q's type (the fp32
// rope rows rounded to that type, each product and the sum rounded to it);
// the validity mask is (pos < lens + j + 1) & (j < q_lens); scores of
// invalid positions are -1e30 and their p is exactly 0; the softmax is an
// fp32 online softmax with denominator max(l, 1e-30); rows with j >= q_lens
// are written as exact 0; block-table entries at or past
// ceil((lens + q_lens) / BS) are never read, and neither are their blocks.
// Storage is bf16, fp16 or fp32 (the template type T); head dims 64, 128,
// 192, 256, 320, 384, 448 and 512 as template instances, and every
// multiple of 64 above 512 as one runtime instance (paged_chunk_deep.cu).
//
// The int8 pool (KV = int8_t, the `_int8` entry points): the cache holds
// int8 K/V rows and two fp32 scale planes [NB, HKV, BS], one scale per
// (block, head, slot), addressed by the same physical block id as the
// payload; K/V = float(int8) * scale. q and out keep their own type T.
//
// Bound on H100: bytes. Each used K/V block must be read once per (row
// tile, KV head); with at most 64 packed query rows per tile that is ~64
// flops per byte, under the card's ~295 flop/byte ridge. The design:
//
// - The history is split across a thread-block cluster. One cluster of R
//   CTAs per (tile of 64 packed query rows, KV head, slot); packed row =
//   j * G + g with G = HQ / HKV, so the G query heads of one KV head share
//   each K/V tile (GQA), and a 64-row prompt chunk is one tile. R is the
//   most of 8, 4, 2, 1 whose grid the card holds at once (see
//   paged_attention.py `chunk_plan`, on the cap the card reports): at
//   the 7B serve step (8 slots x 32 heads) that is 2. Every CTA reads its
//   slot's lens / q_lens itself; the tile's causal limit n_pos = lens +
//   j_last + 1 covers ceil(n_pos / 16) tiles of 16 positions, and rank r
//   walks tiles r, r + R, r + 2R, ... below it in increasing order, one a
//   step, keeping its own online softmax (m, l, acc). The split depends on
//   the positions alone, never on the chunk start, lens, q_lens or the
//   tile's limit: a position past a row's limit adds exact zeros and a rank
//   with no valid position for a row keeps m = -1e30 (merge weight 0), so a
//   query row gets the same bits at any chunk start (the prefix cache's warm
//   tail equals the cold prefill; paged_attention.py `chunk_rank_tiles` is
//   the mirror). A rank with no tile stores m = -1e30 and walks nothing.
//   (A contiguous range of ceil(blocks / R) blocks a rank, split at the
//   tile's limit, summed a row in another order whenever its chunk started
//   elsewhere.) After cluster.sync() the partials
//   are merged through distributed shared memory in rank order: rank r
//   merges rows r, r + R, r + 2R, ... (every rank takes a share of the
//   rows, so the merge is parallel), and writes them. One launch, no global
//   workspace, no atomics, the same bits every run. The grid comes from B,
//   C, HQ, HKV, MBS and the card only; no length is read on the host.
//   (A fixed R = 8 ran that step's grid as four waves and a tail, and paid
//   each CTA's fixed costs — q, the table, the first tile's latency, the
//   merge — four times over: slower on every batch measured but GQA.)
// - 4 warps x 16 rows read every K/V tile of a 3-stage cp.async ring (16
//   bytes a thread, loads two tiles ahead, one __syncthreads a step; 4 or 6
//   stages were no faster). A thread's K and V rows share one address
//   computation and a load call divides by BS once: the step's issue cost
//   is on the walk's critical path. A warp whose rows are all masked for a
//   step skips its products. (Decode rows fill one warp's m16 tile; letting
//   the four warps walk alternate steps of it, each with its own slot and
//   softmax, cost registers and occupancy and ran slower.)
// - Staged rows are padded by 16 bytes (ldmatrix then hits 32 distinct
//   banks); a row at or past the tile's limit is zero-filled and never read
//   from the pool. The slot's used table entries are staged once in shared
//   memory.
// - bf16 / fp16: QK^T and PV on the tensor cores (mma.sync m16n8k16, fp32
//   accumulate, fragments by ldmatrix). q stays unscaled in its own type
//   (exact after the rope); the fp32 scores are multiplied by `scale` after
//   the product. p (fp32) is split into p_hi = p rounded to T and p_lo =
//   (p - p_hi) rounded to T, and PV is two products: one rounding of p to
//   bf16 misses the plain version's fp32 softmax by more than the gate
//   1e-4 + 2^-7 |x| (tests/test_torch_paged_split.py emulates both), the
//   split keeps ~16 bits of p.
// - Head dims above 256: an output-column split, a grid axis of 2. Each
//   CTA owns D / 2 columns of O (160, 192, 224 or 256): it computes the
//   scores q k^T over the whole of D, stages only its half of each V tile
//   and runs PV, the merge and the writes over its half, so its
//   accumulator stays at most 256 columns (128 registers a thread, as at D
//   256). The K reads are made twice, once by each half. In fp32 a tile is
//   32 query rows (two of the four warps compute; all four stage) and at D
//   512 the ring has 2 stages, so q, the ring and the merge fit the 200 KB
//   below: 64 fp32 rows of q alone take 129 KB at D 512. The cluster split
//   of the history stays, and its R counts the doubled grid.
// - fp32: the same walk and merge, with the scores and PV on the fp32 FMA
//   units (each thread owns the rows and columns an mma C fragment would),
//   p unrounded: TF32 could not meet 2e-5 + 1e-5 |x|.
// - int8: the staged int8 tile is upcast to T in shared memory (exact in
//   bf16, fp16 and fp32) and runs the same product; the scales are folded:
//   s[r, t] = (q . k8)[r, t] * k_scale[t] * scale, and p'[t] = p[t] *
//   v_scale[t] before the PV product (l sums p itself).
#include <type_traits>

#include "paged_chunk.cuh"

using ptt::bf16;
using ptt::f16;

namespace {

template <typename T, typename KV, bool ROPE>
int launch(const void* q, const void* cos_t, const void* sin_t, const void* kc, const void* vc,
           const void* ks, const void* vs, const void* tables, const void* lens, const void* qlens,
           void* out, int B, int C, int HQ, int HKV, int D, int BS, int MBS, int split, int cols, int rows,
           int ranks, float scale, cudaStream_t st) {
#define PTT_LAUNCH(DIM)                                                                                         \
  launch_d<T, KV, DIM, ROPE>(q, cos_t, sin_t, kc, vc, ks, vs, tables, lens, qlens, out, B, C, HQ, HKV, BS, MBS, \
                             split, cols, rows, ranks, scale, st)
  switch (D) {
    case 64:
      return PTT_LAUNCH(64);
    case 128:
      return PTT_LAUNCH(128);
    case 192:
      return PTT_LAUNCH(192);
    case 256:
      return PTT_LAUNCH(256);
    case 320:
    case 384:
    case 448:
    case 512:  // instantiated in paged_chunk_wide.cu
      return ptt::chunk::launch_wide<T, KV, ROPE>(q, cos_t, sin_t, kc, vc, ks, vs, tables, lens, qlens, out, B, C,
                                                  HQ, HKV, D, BS, MBS, split, cols, rows, ranks, scale, st);
    default:  // above 512: one instance, D a runtime multiple of 64 (paged_chunk_deep.cu)
      return ptt::chunk::launch_deep<T, KV, ROPE>(q, cos_t, sin_t, kc, vc, ks, vs, tables, lens, qlens, out, B, C,
                                                  HQ, HKV, D, BS, MBS, split, cols, rows, ranks, scale, st);
  }
#undef PTT_LAUNCH
}

// QUANT: the cache is int8 with scale planes; else it is of q's type
template <bool ROPE, bool QUANT>
int launch_io(int io, const void* q, const void* cos_t, const void* sin_t, const void* kc,
              const void* vc, const void* ks, const void* vs, const void* tables, const void* lens,
              const void* qlens, void* out, int B, int C, int HQ, int HKV, int D, int BS, int MBS,
              int split, int cols, int rows, int ranks, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PTT_IO(TYPE)                                                                             \
  launch<TYPE, std::conditional_t<QUANT, int8_t, TYPE>, ROPE>(q, cos_t, sin_t, kc, vc, ks, vs,   \
                                                              tables, lens, qlens, out, B, C, HQ, \
                                                              HKV, D, BS, MBS, split, cols, rows, ranks, scale, st)
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

// Kernel A. `io` is the storage type (ptt::IoType) of q and out; cos/sin are
// fp32 [B, C, D]; `split` (CTAs over O's columns), `cols` (O's columns a
// CTA), `rows` (packed query rows a tile) and `ranks` (the cluster size, 1
// to 8) are paged_attention.py `chunk_plan`'s. Returns
// cudaErrorInvalidValue for a head dim that is not a multiple of 64, an
// unknown type, a cluster size out of range, or a column split or tile rows
// the instance does not hold.
extern "C" int ptt_paged_chunk_fused(int io, const void* q, const void* cos_t, const void* sin_t,
                                     const void* kc, const void* vc, const void* tables,
                                     const void* lens, const void* qlens, void* out, int B, int C,
                                     int HQ, int HKV, int D, int BS, int MBS, int split, int cols, int rows,
                                     int ranks, float scale, void* stream) {
  return launch_io<true, false>(io, q, cos_t, sin_t, kc, vc, nullptr, nullptr, tables, lens, qlens, out,
                                B, C, HQ, HKV, D, BS, MBS, split, cols, rows, ranks, scale, stream);
}

// Kernel 4: the same walk with q taken as given.
extern "C" int ptt_paged_chunk(int io, const void* q, const void* kc, const void* vc,
                               const void* tables, const void* lens, const void* qlens, void* out,
                               int B, int C, int HQ, int HKV, int D, int BS, int MBS, int split, int cols,
                               int rows, int ranks, float scale, void* stream) {
  return launch_io<false, false>(io, q, nullptr, nullptr, kc, vc, nullptr, nullptr, tables, lens, qlens,
                                 out, B, C, HQ, HKV, D, BS, MBS, split, cols, rows, ranks, scale, stream);
}

// Kernel A over the int8 pool: kc/vc int8 [NB, HKV, BS, D], ks/vs fp32
// [NB, HKV, BS]; `io` is the type of q and out.
extern "C" int ptt_paged_chunk_fused_int8(int io, const void* q, const void* cos_t, const void* sin_t,
                                          const void* kc, const void* vc, const void* ks, const void* vs,
                                          const void* tables, const void* lens, const void* qlens,
                                          void* out, int B, int C, int HQ, int HKV, int D, int BS,
                                          int MBS, int split, int cols, int rows, int ranks, float scale,
                                          void* stream) {
  return launch_io<true, true>(io, q, cos_t, sin_t, kc, vc, ks, vs, tables, lens, qlens, out, B, C, HQ,
                               HKV, D, BS, MBS, split, cols, rows, ranks, scale, stream);
}

// Kernel 4 over the int8 pool.
extern "C" int ptt_paged_chunk_int8(int io, const void* q, const void* kc, const void* vc, const void* ks,
                                    const void* vs, const void* tables, const void* lens,
                                    const void* qlens, void* out, int B, int C, int HQ, int HKV, int D,
                                    int BS, int MBS, int split, int cols, int rows, int ranks, float scale,
                                    void* stream) {
  return launch_io<false, true>(io, q, nullptr, nullptr, kc, vc, ks, vs, tables, lens, qlens, out, B, C,
                                HQ, HKV, D, BS, MBS, split, cols, rows, ranks, scale, stream);
}

// The CTAs of kernel A's (rope 1) or 4's (rope 0) instance for this type,
// pool (quant 1: int8) and head dim that the card holds at once with MBS
// table entries staged, at `rows` packed query rows a tile (0: the
// instance's own; above head dim 512 another that fits may be asked),
// written to the host int *cap: the cap of paged_attention.py `chunk_plan`.
// Returns a CUDA error; launches nothing.
extern "C" int ptt_paged_chunk_cap(int io, int quant, int rope, int D, int MBS, int rows, int* cap) {
  // launch_io with a null q writes the cap into `out`
#define PTT_CAP(ROPE, QUANT)                                                                                      \
  launch_io<ROPE, QUANT>(io, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, \
                         nullptr, cap, 1, 1, 1, 1, D, 1, MBS, 1, D, rows, 1, 1.f, nullptr)
  return rope ? (quant ? PTT_CAP(true, true) : PTT_CAP(true, false))
              : (quant ? PTT_CAP(false, true) : PTT_CAP(false, false));
#undef PTT_CAP
}

namespace {

// Geo<T, KV, D>'s launch geometry in plan_of's order
template <typename T, typename KV, int D>
int geo_plan(int* out) {
  using G_ = Geo<T, KV, D>;
  const int geo[6] = {G_::kSplit, G_::kDO, G_::kRows, G_::kStages, static_cast<int>(G_::kSmem), 1};
  for (int i = 0; i < 6; ++i) out[i] = geo[i];
  return 0;
}

template <typename T, typename KV>
int plan_of(int D, int* out) {
  switch (D) {
    case 64:
      return geo_plan<T, KV, 64>(out);
    case 128:
      return geo_plan<T, KV, 128>(out);
    case 192:
      return geo_plan<T, KV, 192>(out);
    case 256:
      return geo_plan<T, KV, 256>(out);
    case 320:
      return geo_plan<T, KV, 320>(out);
    case 384:
      return geo_plan<T, KV, 384>(out);
    case 448:
      return geo_plan<T, KV, 448>(out);
    case 512:
      return geo_plan<T, KV, 512>(out);
    default:
      return ptt::chunk::deep_plan<T, KV>(D, out);
  }
}

}  // namespace

// The launch geometry of kernels A and 4's instance for q of type `io` over
// a pool of q's type (quant 0) or the int8 pool (quant 1) at head dim D,
// written to the host int out[6]: split (CTAs over O's columns), cols (O's
// columns a CTA), rows (packed query rows a tile), ring slots (the (K, V)
// stages up to 512; above it the slots of 16 positions x 256 columns),
// shared-memory bytes without the table entries, and the walk (1: q
// resident, 0: above 512 the chunked walk). paged_attention.py
// `chunk_geometry` mirrors it. Returns cudaErrorInvalidValue for a head dim
// that is not a multiple of 64 or an unknown type.
extern "C" int ptt_paged_chunk_plan(int io, int quant, int D, int* out) {
  if (D < 64 || D % 64) return static_cast<int>(cudaErrorInvalidValue);
#define PTT_PLAN(TYPE) (quant ? plan_of<TYPE, int8_t>(D, out) : plan_of<TYPE, TYPE>(D, out))
  switch (io) {
    case ptt::kBF16:
      return PTT_PLAN(bf16);
    case ptt::kF16:
      return PTT_PLAN(f16);
    case ptt::kF32:
      return PTT_PLAN(float);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PTT_PLAN
}
