// Flash-attention backward, dq: dq = sum over visible columns of
// ds k, with p = exp(scale q k^T - lse) (0 where masked) and
// ds = p (g v^T - delta) scale, for q, g [B, Sq, H, D] and k, v
// [B, Sk, HK, D], read in place in that layout, in bf16 or fp16 (fp32:
// flash_fp32.cu); lse and delta [B, H, Sq] fp32 (delta = rowsum(g * out),
// computed by the caller).
//
// Replaces: paddle_tpu/kernels/flash_attention.py `_bwd_dq_kernel`
// (launched by `_run_bwd`), the first half of the attention's backward.
//
// Semantics kept from the Pallas kernel: the same key-tile walk (first tile
// to the causal limit), mask (flash_common.cuh `masked`) and fp32 order —
// the product q k^T is scaled, not q; dS is rounded to the input type for
// dS K; dq is accumulated in fp32 and written once, in q's type (no
// atomics: deterministic). Rows past Sq are not written.
//
// Design (Hopper): kernel 14's mainloop (flash_fwd.cu, flash_common.cuh
// `produce_walk`). A persistent grid of one CTA per SM takes (128-row query
// tile, head, batch) items from an atomic counter, longest first under
// `causal`; two consumer warpgroups of 64 rows and one producer warp. The
// producer loads each item's Q and g tiles by TMA (two buffers where they
// fit, so the next item's arrive during this one's epilogue), then walks the
// key tiles, classes them before any copy (SKIP tiles cost nothing) and
// feeds the ring of K/V slots. Per slot the consumers run S = Q K^T and
// dP = g V^T as wgmma SS (K and V [BN, D] K-major), p and dS in fp32 on the
// accumulators (the mask on PARTIAL tiles only; lse and delta of the item's
// rows in registers), then dq += dS K as wgmma RS with K as MN-major B; dq
// leaves through the item's Q buffer by TMA stores. BN = 64 keys: the S, dP
// and dq accumulators are live at once. Two K/V stages, one at D 256 (Q and
// g take 128 KB there).
//
// Bound on H100: operations — three products of 2 D flops per visible
// (row, column) against 2 x 4 D bytes per row of inputs at S 4096.
#include "flash_common.cuh"

namespace hp = ptt::hopper;
namespace fl = ptt::flash;

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBM = 128;                   // query rows per CTA (64 per consumer warpgroup)
constexpr int kBN = 64;                    // keys per tile
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
struct Dq {
  static constexpr int kStages = D == 256 ? 1 : 2;
  static constexpr int kBoxes = D / 64;
  static constexpr int kQBytes = kBM * D * 2;   // Q or g
  static constexpr int kKVBytes = kBN * D * 2;  // one K or V tile
  static constexpr int kRing = kStages * (2 * kKVBytes + kBN * 4 * 4 + 8);
  // two Q + g buffers (the next item's load during this item) where they fit
  static constexpr int kQBufs = 4 * kQBytes + kRing + fl::kStageInts * 4 + 2048 <= 227 * 1024 ? 2 : 1;
  static constexpr int kQ = 0;                       // Q and g of buffer i at kQ + 2 i kQBytes (+ kQBytes)
  static constexpr int kK = kQ + 2 * kQBufs * kQBytes;
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

// s <- dS = p (dp - delta) scale with p = exp2(s sl2 - lse2), 0 where masked
// (kMask: flash_fwd.cu `scale_mask`'s row-mask words)
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
        const uint32_t bits = msk[(8 * j + 2 * tig + c) * 4 + word] >> bit0;
        if (bits & 1u) p0 = 0.f;
        if (bits & 0x100u) p1 = 0.f;
      }
      s[4 * j + c] = p0 * (dp[4 * j + c] - dl[0]) * scale;
      s[4 * j + 2 + c] = p1 * (dp[4 * j + 2 + c] - dl[1]) * scale;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_g,
                    const __grid_constant__ CUtensorMap tm_dq,
                    const int* __restrict__ bounds, const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int B, int Sq, int Sk, int H, int HK, int Hm, int C, int causal,
                    float scale, int* __restrict__ sched) {
  using L = Dq<D>;
  constexpr int kQBufs = L::kQBufs;
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
      hp::mbar_init(&ring.full[s], 32);
      hp::mbar_init(&ring.empty[s], kConsumerWarps);
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    hp::reg_dealloc<kProducerRegs>();
    if (warp > kConsumerWarps) return;  // the producer warpgroup's other warps only give up their registers
    // ---- producer warp: per item, Q and g, then the walk's non-SKIP K/V tiles ----
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
        hp::mbar_arrive_expect_tx(&q_full[qb], 2 * L::kQBytes);
        unsigned char* q_s = sm + L::kQ + 2 * qb * L::kQBytes;
#pragma unroll
        for (int x = 0; x < L::kBoxes; ++x) {
          hp::tma_load_4d(q_s + x * kBM * 128, &tm_q, &q_full[qb], x * 64, w.h, r0, w.b);
          hp::tma_load_4d(q_s + L::kQBytes + x * kBM * 128, &tm_g, &q_full[qb], x * 64, w.h, r0, w.b);
        }
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
      const unsigned char* q_s = sm + L::kQ + 2 * qb * L::kQBytes;
      const unsigned char* g_s = q_s + L::kQBytes;
      float lse2[2], dl[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = w.qt * kBM + row_l + 8 * r;
        const size_t at = (static_cast<size_t>(w.b) * H + w.h) * Sq + row;
        lse2[r] = row < Sq ? lse[at] * kLog2e : fl::kInf;  // +inf: p = 0 (padding, fully masked rows)
        dl[r] = row < Sq ? delta[at] : 0.f;
      }
      float acc[L::kBoxes][32];
#pragma unroll
      for (int x = 0; x < L::kBoxes; ++x)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[x][i] = 0.f;
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

        // S = Q K^T and dP = g V^T
        float s[32], dp[32];
        hp::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int x = kk >> 2, off = (kk & 3) * 32;
          const int a_off = x * kBM * 128 + wg * 64 * 128 + off, b_off = x * kBN * 128 + off;
          hp::wgmma_ss_n64<T>(s, hp::desc_sw128(q_s + a_off, 16, 1024), hp::desc_sw128(k_s + b_off, 16, 1024), kk > 0);
          hp::wgmma_ss_n64<T>(dp, hp::desc_sw128(g_s + a_off, 16, 1024), hp::desc_sw128(v_s + b_off, 16, 1024), kk > 0);
        }
        hp::wgmma_commit();
        hp::wgmma_wait<0>();
        hp::fence_regs(s);
        hp::fence_regs(dp);

        if (cls == fl::kPartial) {
          probs_to_ds<true>(s, dp, sl2, scale, lse2, dl, ring.masks(), word, bit0, tig);
        } else {
          probs_to_ds<false>(s, dp, sl2, scale, lse2, dl, nullptr, 0, 0, tig);
        }

        // dq += dS K: dS from registers (rounded to T), K MN-major from the slot
        uint32_t da[kBN / 16][4];
#pragma unroll
        for (int kt = 0; kt < kBN / 16; ++kt) fl::c_to_a<T>(da[kt], &s[8 * kt], &s[8 * kt + 4]);
        hp::wgmma_fence();
#pragma unroll
        for (int kt = 0; kt < kBN / 16; ++kt) {
#pragma unroll
          for (int x = 0; x < L::kBoxes; ++x) {
            const uint64_t db = hp::desc_sw128(k_s + x * kBN * 128 + kt * 16 * 128, kBN * 128, 1024);
            hp::wgmma_rs_n64<T>(acc[x], da[kt], db, 1);
          }
        }
        hp::wgmma_commit();
        hp::wgmma_wait<0>();
#pragma unroll
        for (int x = 0; x < L::kBoxes; ++x) hp::fence_regs(acc[x]);
#pragma unroll
        for (int kt = 0; kt < kBN / 16; ++kt) hp::fence_regs(da[kt]);
        fl::release_slot(ring, lane);
        if (ti.y & fl::kLastTile) break;
      }
      // dq through the item's Q buffer (its products are done) and TMA
      // stores; the buffer goes back to the producer once they have read it
      uint32_t pk[L::kBoxes][8][2];
#pragma unroll
      for (int x = 0; x < L::kBoxes; ++x)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r) pk[x][j][r] = hp::pack2<T>(acc[x][4 * j + 2 * r], acc[x][4 * j + 2 * r + 1]);
      fl::store_rows_tma<D>(const_cast<unsigned char*>(q_s), pk, row_l, tig, wg, &tm_dq, w.h, w.qt * kBM, w.b);
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(&q_empty[qb]);
    }
    if (threadIdx.x % 128 == 0) hp::tma_store_wait_all();  // the last stores land before the CTA ends
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* bounds, const void* g, const void* lse,
           const void* delta, void* dq, void* sched, int B, int Sq, int Sk, int H, int HK, int Hm, int C, int causal, float scale,
           cudaStream_t stream) {
  using L = Dq<D>;
  CUtensorMap tq, tk, tv, tg, tdq;
  int err = hp::encode_row_tiles<T>(&tq, q, B, Sq, H, D, kBM);
  if (!err) err = hp::encode_row_tiles<T>(&tg, g, B, Sq, H, D, kBM);
  if (!err) err = hp::encode_row_tiles<T>(&tdq, dq, B, Sq, H, D, kBM / 2);  // a warpgroup's 64 rows
  if (!err) err = hp::encode_row_tiles<T>(&tk, k, B, Sk, HK, D, kBN);
  if (!err) err = hp::encode_row_tiles<T>(&tv, v, B, Sk, HK, D, kBN);
  if (err) return err;
  auto kernel = flash_bwd_dq_kernel<T, D>;
  err = ptt::allow_smem(kernel, L::kBytes);
  if (!err) err = hp::check_reg_split(kernel, kThreads, kConsumers * kConsumerRegs + 128 * kProducerRegs);
  int sms = 0;
  if (!err) err = hp::sm_count(&sms);
  if (err) return err;
  const int items = (Sq + kBM - 1) / kBM * H * B;
  kernel<<<items < sms ? items : sms, kThreads, L::kBytes, stream>>>(
      tq, tk, tv, tg, tdq, static_cast<const int*>(bounds), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), B, Sq, Sk, H, HK, Hm, C, causal, scale,
      static_cast<int*>(sched));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* bounds, const void* g, const void* lse,
             const void* delta, void* dq, void* sched, int B, int Sq, int Sk, int H, int HK, int D, int Hm, int C, int causal,
             float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<T, 64>(q, k, v, bounds, g, lse, delta, dq, sched, B, Sq, Sk, H, HK, Hm, C, causal, scale, st);
    case 128: return launch<T, 128>(q, k, v, bounds, g, lse, delta, dq, sched, B, Sq, Sk, H, HK, Hm, C, causal, scale, st);
    case 192: return launch<T, 192>(q, k, v, bounds, g, lse, delta, dq, sched, B, Sq, Sk, H, HK, Hm, C, causal, scale, st);
    case 256: return launch<T, 256>(q, k, v, bounds, g, lse, delta, dq, sched, B, Sq, Sk, H, HK, Hm, C, causal, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, g [B, Sq, H, D], k/v [B, Sk, HK, D] contiguous, 16-byte aligned, in T;
// bounds [B, Hm, Sk, C] int32 or null (C = 0); lse, delta [B, H, Sq] fp32;
// dq [B, Sq, H, D] in T; sched one int32, 0 (the item scheduler's counter).
// D is 64, 128, 192 or 256.
extern "C" int ptt_flash_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* bounds, const void* g,
                                     const void* lse, const void* delta, void* dq, void* sched, int B, int Sq, int Sk, int H,
                                     int HK, int D, int Hm, int C, int causal, float scale, void* stream) {
  return dispatch<ptt::bf16>(q, k, v, bounds, g, lse, delta, dq, sched, B, Sq, Sk, H, HK, D, Hm, C, causal, scale, stream);
}

extern "C" int ptt_flash_bwd_dq_fp16(const void* q, const void* k, const void* v, const void* bounds, const void* g,
                                     const void* lse, const void* delta, void* dq, void* sched, int B, int Sq, int Sk, int H,
                                     int HK, int D, int Hm, int C, int causal, float scale, void* stream) {
  return dispatch<ptt::f16>(q, k, v, bounds, g, lse, delta, dq, sched, B, Sq, Sk, H, HK, D, Hm, C, causal, scale, stream);
}
