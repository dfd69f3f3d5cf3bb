// Flash-attention forward with FlashMask bounds: out = softmax(scale q k^T +
// mask) v and the row logsumexp lse, for q [B, Sq, H, D] and k, v
// [B, Sk, HK, D] (query head h reads KV head h / (H / HK)), read in place in
// that layout, in bf16 or fp16 (fp32: flash_fp32.cu).
//
// Replaces: paddle_tpu/kernels/flash_attention.py `_fwd_kernel` (launched by
// `_run_fwd`, entry `flash_attention_pallas`), the training step's attention.
//
// Semantics kept from the Pallas kernel: key tiles are walked from the first
// to the causal limit; a logit is masked for padding columns, causally
// (col > row + Sk - Sq) and by the column's FlashMask bounds (C = 1, 2 or 4
// per column, read per key tile — the dense mask never exists); a masked
// logit contributes exactly 0; the online softmax runs in fp32; out = acc / l
// and lse = m + log(l). q stays in its own type for the product and the fp32
// product is scaled (the Pallas kernel scales q in fp32: the same value up to
// fp32 rounding). P is rounded to the input type for P V; l sums the fp32 p.
// Where a row has no visible column the kernel writes out = 0 and
// lse = +inf (the Pallas kernel averages V there).
//
// Design (Hopper). A persistent grid of one CTA per SM walks work items
// (128-row query tile, head, batch), the longest query tiles first under
// `causal` (flash_common.cuh `item_of`); each CTA has two consumer
// warpgroups of 64 query rows and a producer warpgroup of which one warp
// works (setmaxnreg moves the others' registers to the consumers).
// - The producer loads each item's Q tile by TMA into one of two buffers
//   (the next item's Q arrives while this one's epilogue runs), then walks
//   the key tiles (flash_common.cuh `produce_walk`): it stages their bounds
//   in shared memory with cp.async and classes them, 32 at a time, BEFORE it
//   issues any copy; a SKIP tile costs no copy and no product; the others go
//   through a ring of K/V slots (full and empty mbarriers), each slot
//   carrying the tile's index and class (and the walk's last-tile flag)
//   and, for a PARTIAL tile, per-column row-mask words computed while its
//   copies fly. TMA zero-fills rows past Sq/Sk; the mask covers those
//   columns. Items come from an atomic counter (dynamic scheduling).
// - The consumers run S = Q K^T as wgmma SS (K [BN, D] K-major), then, in
//   fp32 on the accumulator, the scale, the mask (PARTIAL tiles only: one
//   shared load and two bit tests a column) and the online softmax (row max
//   and sum with quad shuffles), round P to T in registers, and O += P V as
//   wgmma RS with V [BN, D] as MN-major B: no transposed copy of V. The two
//   warpgroups interleave their softmax and products on the tensor cores.
//   Each warpgroup writes its 64 rows of out into the item's Q buffer and
//   sends them with TMA stores (full 128-byte rows) before the buffer goes
//   back to the producer.
// - BN = 128 keys at D <= 128 and 64 at D 192 and 256, so that the Q
//   buffers and two K/V stages fit in 227 KB of dynamic shared memory (one Q
//   buffer at D 256).
//
// Bound on H100: operations. At the training shape (S 4096, D 128) it does
// 4 D flops per visible (row, column) against 8 D bytes per row; the
// tensor-core rate (989 TFLOP/s bf16/fp16) is the limit.
#include "flash_common.cuh"

namespace hp = ptt::hopper;
namespace fl = ptt::flash;

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kBM = 128;                   // query rows per CTA (64 per consumer warpgroup)
constexpr int kConsumers = 256;             // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup (one warp of it works)
constexpr int kConsumerWarps = kConsumers / 32;
// Registers a thread: the launch gives each of the 384 threads 168 (65536 /
// 384, rounded down to 8); setmaxnreg moves them from the producer
// warpgroup to the consumers, whose S, O (or dq) and P (or dS) live at once.
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = (168 * kThreads - kConsumers * kConsumerRegs) / 128;
static_assert(kProducerRegs >= 24 && kProducerRegs % 8 == 0, "setmaxnreg takes 24..256 in steps of 8");

template <int D>
struct Fwd {
  static constexpr int kBN = D <= 128 ? 128 : 64;  // keys per tile
  static constexpr int kStages = 2;
  static constexpr int kBoxes = D / 64;            // 128-byte column boxes of a row
  static constexpr int kQBytes = kBM * D * 2;
  static constexpr int kKVBytes = kBN * D * 2;     // one K or V tile
  static constexpr int kRing = kStages * (2 * kKVBytes + kBN * 4 * 4 + 8);
  // two Q buffers (the next item's Q loads during this item) where they fit
  static constexpr int kQBufs = 2 * kQBytes + kRing + fl::kStageInts * 4 + 2048 <= 227 * 1024 ? 2 : 1;
  // shared memory from a 1024-byte-aligned base: Q buffers, K stages, V
  // stages, the stages' row masks and info words, then the barriers
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBufs * kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kMask = kV + kStages * kKVBytes;
  static constexpr int kInfo = kMask + kStages * kBN * 4 * 4;
  static constexpr int kStg = kInfo + (kStages * 8 + 15) / 16 * 16;  // the producer's bounds staging (16-byte aligned)
  static constexpr int kBar = kStg + fl::kStageInts * 4;  // q_full[Q], q_empty[Q], full[S], empty[S]
  static constexpr int kItem = kBar + (2 * kQBufs + 2 * kStages) * 8;  // the item of each Q buffer
  static constexpr int kBytes = kItem + 16 + 1024;  // + alignment slack
  using Ring = fl::KvRing<kBN, D, kStages>;
  static_assert(kBytes <= 227 * 1024, "a block's shared memory");
  static_assert(kStg % 16 == 0 && kBar % 8 == 0, "cp.async and mbarrier alignment");
};

// x = s * sl2 (log2 units) with masked logits at -inf (kMask: `msk` holds
// the tile's row-mask words, 4 a column; this thread's rows are bits bit0
// and bit0 + 8 of word `word`), the rows' maxima into mx
template <bool kMask, int NS>
__device__ __forceinline__ void scale_mask(float (&s)[NS], float (&mx)[2], float sl2, const uint32_t* msk,
                                           int word, int bit0, int tig) {
#pragma unroll
  for (int j = 0; j < NS / 4; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float x0 = s[4 * j + c] * sl2, x1 = s[4 * j + 2 + c] * sl2;
      if constexpr (kMask) {
        const uint32_t bits = msk[(8 * j + 2 * tig + c) * 4 + word] >> bit0;
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
                 const int* __restrict__ bounds, T* __restrict__ out,
                 float* __restrict__ lse, int B, int Sq, int Sk, int H, int HK, int Hm, int C, int causal,
                 float scale, int* __restrict__ sched) {
  using L = Fwd<D>;
  constexpr int kBN = L::kBN, kQBufs = L::kQBufs;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* q_empty = q_full + kQBufs;
  typename L::Ring ring;
  ring.k = sm + L::kK;
  ring.v = sm + L::kV;
  ring.mask = reinterpret_cast<uint32_t*>(sm + L::kMask);
  ring.info = reinterpret_cast<int2*>(sm + L::kInfo);
  ring.full = q_empty + kQBufs;
  ring.empty = ring.full + L::kStages;
  volatile int* item_s = reinterpret_cast<int*>(sm + L::kItem);
  int* stg = reinterpret_cast<int*>(sm + L::kStg);

  const int n_qt = (Sq + kBM - 1) / kBM;
  const int items = n_qt * H * B;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kQBufs; ++i) {
      hp::mbar_init(&q_full[i], 1);
      hp::mbar_init(&q_empty[i], kConsumerWarps);
    }
    for (int s = 0; s < L::kStages; ++s) {
      hp::mbar_init(&ring.full[s], 32);               // every producer lane arrives
      hp::mbar_init(&ring.empty[s], kConsumerWarps);  // one arrival per consumer warp
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    hp::reg_dealloc<kProducerRegs>();
    if (warp > kConsumerWarps) return;  // the producer warpgroup's other warps only give up their registers
    // ---- producer warp: per item, Q, then the walk's non-SKIP K/V tiles ----
    if (lane == 0) {
      hp::tma_prefetch(&tm_q);
      hp::tma_prefetch(&tm_k);
      hp::tma_prefetch(&tm_v);
    }
    // items come from the scheduler's counter: the first from blockIdx.x,
    // each next one as soon as this one starts, so its latency hides
    int n = 0;
    for (int it = blockIdx.x;; ++n) {
      const int qb = n % kQBufs;
      hp::mbar_wait(&q_empty[qb], ((n / kQBufs) & 1) ^ 1);  // the buffer's last item is done
      if (it >= items) {  // none left: tell the consumers
        if (lane == 0) {
          item_s[qb] = -1;
          hp::mbar_arrive(&q_full[qb]);
        }
        break;
      }
      int next = 0;
      if (lane == 0) next = atomicAdd(sched, 1) + static_cast<int>(gridDim.x);
      const fl::Item w = fl::item_of(it, n_qt, H, causal);
      const int r0 = w.qt * kBM, hk = w.h / (H / HK);
      if (lane == 0) item_s[qb] = it;
      if (lane == 0) {
        hp::mbar_arrive_expect_tx(&q_full[qb], L::kQBytes);
        unsigned char* q_s = sm + L::kQ + qb * L::kQBytes;
#pragma unroll
        for (int x = 0; x < L::kBoxes; ++x) hp::tma_load_4d(q_s + x * kBM * 128, &tm_q, &q_full[qb], x * 64, w.h, r0, w.b);
      }
      const int* bb = C ? bounds + (static_cast<size_t>(w.b) * Hm + (Hm == 1 ? 0 : w.h)) * Sk * C : nullptr;
      fl::produce_walk<kBN, kBM, D, L::kStages>(ring, &tm_k, &tm_v, stg, bb, C, r0,
                                                fl::walk_end(r0, kBM, kBN, Sq, Sk, causal), Sq, Sk, causal, hk,
                                                w.b, lane);
      it = __shfl_sync(0xffffffffu, next, 0);
    }
  } else {
    hp::reg_alloc<kConsumerRegs>();
    // ---- consumer warpgroups: 64 query rows each ----
    const int wg = warp >> 2, wl = warp & 3;
    const int gid = lane >> 2, tig = lane & 3;
    const int row_l = wg * 64 + wl * 16 + gid;  // this thread's rows in the tile: row_l, row_l + 8
    const int word = wg * 2 + (wl >> 1), bit0 = (wl & 1) * 16 + gid;  // the rows in the row-mask words
    const float sl2 = scale * kLog2e;
    for (int n = 0;; ++n) {
      const int qb = n % kQBufs;
      hp::mbar_wait(&q_full[qb], (n / kQBufs) & 1);  // the item's Q (and g) landed
      const int it = item_s[qb];
      if (it < 0) break;
      const fl::Item w = fl::item_of(it, n_qt, H, causal);
      const unsigned char* q_s = sm + L::kQ + qb * L::kQBytes;
      float o[L::kBoxes][32];
#pragma unroll
      for (int x = 0; x < L::kBoxes; ++x)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[x][i] = 0.f;
      float m[2] = {-fl::kInf, -fl::kInf}, l[2] = {0.f, 0.f};
      while (true) {
        hp::mbar_wait(&ring.full[ring.stage], ring.phase);
        const int2 ti = ring.info[ring.stage];
        if (ti.x < 0) {  // the item's walk ended without a tile to flag
          fl::release_slot(ring, lane);
          break;
        }
        const int cls = ti.y & 3;
        const unsigned char* k_s = ring.k_tile();
        const unsigned char* v_s = ring.v_tile();

        // S = Q K^T: D / 16 k-steps, 4 per 64-column box
        float s[kBN / 2];
        hp::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int x = kk >> 2, off = (kk & 3) * 32;
          const uint64_t da = hp::desc_sw128(q_s + x * kBM * 128 + wg * 64 * 128 + off, 16, 1024);
          const uint64_t db = hp::desc_sw128(k_s + x * kBN * 128 + off, 16, 1024);
          hp::wgmma_ss<T, kBN>(s, da, db, kk > 0);
        }
        hp::wgmma_commit();
        hp::wgmma_wait<0>();
        hp::fence_regs(s);

        float mx[2] = {-fl::kInf, -fl::kInf};
        if (cls == fl::kPartial) {
          scale_mask<true>(s, mx, sl2, ring.masks(), word, bit0, tig);
        } else {
          scale_mask<false>(s, mx, sl2, nullptr, 0, 0, tig);
        }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          // the 4 lanes of a row group hold its columns
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
          // a row with nothing visible yet keeps p = 0 (m is still -inf)
          const float p = (m[r] == -fl::kInf) ? 0.f : hp::exp2_approx(s[i] - m[r]);
          s[i] = p;
          ls[r] += p;
        }
        l[0] = l[0] * alpha[0] + ls[0];
        l[1] = l[1] * alpha[1] + ls[1];
#pragma unroll
        for (int x = 0; x < L::kBoxes; ++x)
#pragma unroll
          for (int i = 0; i < 32; ++i) o[x][i] *= alpha[(i >> 1) & 1];

        // O += P V: P from registers (rounded to T), V MN-major from the slot
        uint32_t pa[kBN / 16][4];
#pragma unroll
        for (int kt = 0; kt < kBN / 16; ++kt) fl::c_to_a<T>(pa[kt], &s[8 * kt], &s[8 * kt + 4]);
        hp::wgmma_fence();
#pragma unroll
        for (int kt = 0; kt < kBN / 16; ++kt) {
#pragma unroll
          for (int x = 0; x < L::kBoxes; ++x) {
            const uint64_t db = hp::desc_sw128(v_s + x * kBN * 128 + kt * 16 * 128, kBN * 128, 1024);
            hp::wgmma_rs_n64<T>(o[x], pa[kt], db, 1);
          }
        }
        hp::wgmma_commit();
        hp::wgmma_wait<0>();
#pragma unroll
        for (int x = 0; x < L::kBoxes; ++x) hp::fence_regs(o[x]);
#pragma unroll
        for (int kt = 0; kt < kBN / 16; ++kt) hp::fence_regs(pa[kt]);
        fl::release_slot(ring, lane);
        if (ti.y & fl::kLastTile) break;
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
        if (tig == 0 && row < Sq)
          lse[(static_cast<size_t>(w.b) * H + w.h) * Sq + row] = seen ? m[r] * kLn2 + logf(l[r]) : fl::kInf;
      }
      // out through the item's Q buffer (its S products are done) and TMA
      // stores; the buffer goes back to the producer once they have read it
      uint32_t pk[L::kBoxes][8][2];
#pragma unroll
      for (int x = 0; x < L::kBoxes; ++x)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r) pk[x][j][r] = hp::pack2<T>(o[x][4 * j + 2 * r] * inv[r], o[x][4 * j + 2 * r + 1] * inv[r]);
      fl::store_rows_tma<D>(const_cast<unsigned char*>(q_s), pk, row_l, tig, wg, &tm_o, w.h, w.qt * kBM, w.b);
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(&q_empty[qb]);
    }
    if (threadIdx.x % 128 == 0) hp::tma_store_wait_all();  // the last stores land before the CTA ends
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* bounds, void* out, void* lse, void* sched, int B, int Sq,
           int Sk, int H, int HK, int Hm, int C, int causal, float scale, cudaStream_t stream) {
  using L = Fwd<D>;
  CUtensorMap tq, tk, tv, to;
  int err = hp::encode_row_tiles<T>(&tq, q, B, Sq, H, D, kBM);
  if (!err) err = hp::encode_row_tiles<T>(&tk, k, B, Sk, HK, D, L::kBN);
  if (!err) err = hp::encode_row_tiles<T>(&tv, v, B, Sk, HK, D, L::kBN);
  if (!err) err = hp::encode_row_tiles<T>(&to, out, B, Sq, H, D, kBM / 2);  // a warpgroup's 64 rows
  if (err) return err;
  auto kernel = flash_fwd_kernel<T, D>;
  err = ptt::allow_smem(kernel, L::kBytes);
  if (!err) err = hp::check_reg_split(kernel, kThreads, kConsumers * kConsumerRegs + 128 * kProducerRegs);
  int sms = 0;
  if (!err) err = hp::sm_count(&sms);
  if (err) return err;
  const int items = (Sq + kBM - 1) / kBM * H * B;
  kernel<<<items < sms ? items : sms, kThreads, L::kBytes, stream>>>(
      tq, tk, tv, to, static_cast<const int*>(bounds), static_cast<T*>(out), static_cast<float*>(lse), B, Sq, Sk, H, HK,
      Hm, C, causal, scale, static_cast<int*>(sched));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* bounds, void* out, void* lse, void* sched, int B, int Sq,
             int Sk, int H, int HK, int D, int Hm, int C, int causal, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<T, 64>(q, k, v, bounds, out, lse, sched, B, Sq, Sk, H, HK, Hm, C, causal, scale, st);
    case 128: return launch<T, 128>(q, k, v, bounds, out, lse, sched, B, Sq, Sk, H, HK, Hm, C, causal, scale, st);
    case 192: return launch<T, 192>(q, k, v, bounds, out, lse, sched, B, Sq, Sk, H, HK, Hm, C, causal, scale, st);
    case 256: return launch<T, 256>(q, k, v, bounds, out, lse, sched, B, Sq, Sk, H, HK, Hm, C, causal, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q [B, Sq, H, D], k/v [B, Sk, HK, D] contiguous, 16-byte aligned, in T;
// bounds [B, Hm, Sk, C] int32 or null (C = 0); out [B, Sq, H, D] in T; lse
// [B, H, Sq] fp32; sched one int32, 0 (the item scheduler's counter). D is 64,
// 128, 192 or 256.
extern "C" int ptt_flash_fwd_bf16(const void* q, const void* k, const void* v, const void* bounds, void* out,
                                  void* lse, void* sched, int B, int Sq, int Sk, int H, int HK, int D, int Hm, int C, int causal,
                                  float scale, void* stream) {
  return dispatch<ptt::bf16>(q, k, v, bounds, out, lse, sched, B, Sq, Sk, H, HK, D, Hm, C, causal, scale, stream);
}

extern "C" int ptt_flash_fwd_fp16(const void* q, const void* k, const void* v, const void* bounds, void* out,
                                  void* lse, void* sched, int B, int Sq, int Sk, int H, int HK, int D, int Hm, int C, int causal,
                                  float scale, void* stream) {
  return dispatch<ptt::f16>(q, k, v, bounds, out, lse, sched, B, Sq, Sk, H, HK, D, Hm, C, causal, scale, stream);
}
