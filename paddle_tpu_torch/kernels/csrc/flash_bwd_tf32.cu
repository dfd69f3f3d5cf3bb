// The fp32 flash-attention backward, dq (kernel 15) and dk/dv (kernel 16), on
// the tensor cores at head dims 64 to 256: fp32 accuracy from TF32 products
// by splitting each operand in two (3xTF32), as flash_fwd_tf32.cu does for
// the forward (tf32.cuh). fp32 dq and dk/dv at 320 to 512 stay on
// flash_fp32.cu's CUDA-core walks; above 512 they run flash_deep.cu.
//
// Replaces: paddle_tpu/kernels/flash_attention.py `_bwd_dq_kernel` and
// `_bwd_dkv_kernel` (launched by `_run_bwd`) for fp32 q, k, v, g up to head
// dim 256.
//
// Semantics kept (see flash_bwd_dq.cu, flash_bwd_dkv.cu): p = exp(scale q
// k^T - lse), 0 where masked; dS = p (g v^T - delta) scale; dq = dS k, dk =
// dS^T q, dv = p^T g, the latter two summed over the GQA group's query heads
// inside the kernel (no atomics: two calls give the same bits); FlashMask
// tile classes (flash_common.cuh) skip SKIP tiles (no copy, no product) and
// run FULL tiles without the mask; a row whose every logit is masked (lse =
// +inf) and rows past Sq contribute nothing, so a fully masked row gets a
// zero dq. lse and delta are the forward's, delta = rowsum(g out) computed
// outside.
//
// The arithmetic (tf32.cuh): each fp32 operand x is split as hi =
// rna_tf32(x) and lo = x - hi left whole (`split_hi`: the tensor core reads
// its top 19 bits, so lo counts within 2^-10 of itself, 2^-21 of x, for two
// fewer integer operations than rounding it: 6-11% of each kernel's time at
// D 128 on an H100 against an edited copy that rounds lo, the errors
// unchanged at 1.2e-6 to 2e-6 rel L2 against the plain versions), and
// a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi, the two small cross terms first.
// The products over D (S, dP and their transposes) keep the cross terms and hi hi in
// accumulators of their own, summed at the end; the products summed over a
// walk (dq over keys, dk and dv over the group's query rows: up to 4096
// terms at GQA 32/8 [2, 1024]) go, a tile at a time, into zeroed partials
// that one FADD a value adds to the accumulator, because the tensor cores'
// fp32 accumulation rounds toward zero (flash_fwd_tf32.cu): chained through
// the accumulators instead, dk and dv missed the fp32 gate (2.4e-5 to
// 4.5e-5 rel L2 against 1e-5) and dq came within 8% of it at S 4096, for
// 1-3% of dk/dv's time and at most 1% of dq's (the same A/B on an H100).
// exp, the mask and dS stay fp32 on the CUDA cores.
//
// Fragment layouts (m16n8k8 .tf32, lane = 4 g + t): A a0 (g, t), a1 (g+8,
// t), a2 (g, t+4), a3 (g+8, t+4); B b0 (k t, n g), b1 (k t+4, n g); C c0
// (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1). Every staged fp32 row
// is padded to D + 4 floats, so both ways a tile is read are free of bank
// conflicts: over D (k index t = column 8 kk + t, t + 4 = 8 kk + t + 4:
// banks 4 g + t), and over its rows for a product summed over the tile
// (k index t = row 2t of the step, t + 4 = row 2t + 1, which is where the
// C layout left P or dS: a = (c0, c2, c1, c3), no shuffle; banks 8 t + g).
//
// Design (simple first).
// - dq: a CTA of W warps owns 16 W query rows of one (head, batch), one m16
//   tile a warp, with q and g resident in shared memory; it walks the key
//   tiles of BN keys up to the causal limit, their K and V by cp.async into
//   two buffers (the next visited tile's copies fly while this one is
//   computed). A warp computes S = q K^T and dP = g V^T (16 rows x BN keys),
//   P and dS in registers, and dq += dS K into a partial of the tile. dq is
//   the forward's walk with one more product: K takes V's place.
// - dk/dv: a CTA of 8 warps owns 64 keys of one (KV head, batch), K and V
//   resident; it walks the group's query heads and, for each, its query
//   tiles of BM rows from the causal start, their q and g (with lse and
//   delta) by cp.async into two buffers. dK and dV are D / 2 fp32 a thread
//   each for a warp's 16 keys, too many for one warp beside the products,
//   so the two warpgroups share the work as flash_bwd_dkv.cu's do: warp w
//   of warpgroup 0 computes S^T = K q^T for keys 16 w.., P^T in registers,
//   hands P^T to warp w of warpgroup 1 through shared memory (a named
//   barrier: its stores are seen there), then dV += P^T g; warp w of
//   warpgroup 1 computes dP^T = V g^T, takes P^T, dS^T = P^T (dP^T - delta)
//   scale, then dK += dS^T q. Each holds one accumulator.
// - The plan (`ptt_flash_bwd_fp32_plan`, mirrored by kernels/flash_attention.py
//   `flash_bwd_fp32_plan`): dq's warps and keys the first of (8, 32), (4, 32),
//   (4, 16) whose CTA fits 227 KB; dk/dv's query rows the first of 64, 32,
//   16 whose CTA fits (at D 128, 32 rows took 1.09-1.11x the time of 64 and
//   16 rows, two CTAs an SM at 128 registers with spills, 1.3-2.0x). Grids run
//   the longest causal walks first (dq: the last query tiles; dk/dv: the
//   first key tiles).
//
// Bound on H100: operations at the TF32 tensor peak (494.7 TFLOP/s dense),
// three passes of each product's 2 D flops a visible (row, key) pair: dq 3
// products, dk/dv 4; at fp32's 67 TFLOP/s on the CUDA cores, one pass.
// mma.sync reaches a fraction of the wgmma peak, and every B value is split
// by each warp that reads it.
#include "flash_common.cuh"
#include "tf32.cuh"

namespace fl = ptt::flash;
namespace hp = ptt::hopper;
using ptt::tf32::mma;
using ptt::tf32::mma_3x;
using ptt::tf32::split_hi;

namespace {

constexpr int kSmemPerSm = 228 * 1024, kSmemPerBlock = 227 * 1024, kReserved = 1024;
constexpr int kDkvKeys = 64;     // keys of a dk/dv CTA, 16 a warp of each warpgroup
constexpr int kDkvThreads = 256;  // two warpgroups
constexpr int kBarHandoff = 1;   // named barrier: P^T written by warpgroup 0, read by warpgroup 1

__host__ __device__ constexpr bool two_fit(int smem) { return 2 * (smem + kReserved) <= kSmemPerSm; }

// dq's CTA at W warps (16 W query rows) and BN keys a tile: q and g, two K and two V tiles
__host__ __device__ constexpr int dq_smem(int D, int W, int BN) { return 4 * (2 * 16 * W + 4 * BN) * (D + 4); }
__host__ __device__ constexpr bool dq_fits(int D, int W, int BN) { return dq_smem(D, W, BN) <= kSmemPerBlock; }
__host__ __device__ constexpr int dq_warps(int D) { return dq_fits(D, 8, 32) ? 8 : 4; }
__host__ __device__ constexpr int dq_keys(int D) { return dq_fits(D, dq_warps(D), 32) ? 32 : 16; }

// dk/dv's CTA at BM query rows a tile: K and V, two q and two g tiles, P^T, two lse and two delta rows
__host__ __device__ constexpr int dkv_smem(int D, int BM) {
  return 4 * (2 * kDkvKeys * (D + 4) + 4 * BM * (D + 4) + kDkvKeys * BM + 4 * BM);
}
__host__ __device__ constexpr int dkv_rows(int D) {
  return dkv_smem(D, 64) <= kSmemPerBlock ? 64 : dkv_smem(D, 32) <= kSmemPerBlock ? 32 : 16;
}

// A warp's P products over D, each of 16 rows of a[p] ([16][LD]) and N rows of b[p] ([N][LD]), as 16 x N
// tiles in the C layout (s[p][n][e]: row g (+ 8 for e >= 2) of a[p], row 8 n + 2 t + e % 2 of b[p]): S = q
// K^T with dP = g V^T (dq, interleaved for more independent mma chains), S^T = K q^T or dP^T = V g^T (dk/dv).
// Each product's cross terms and hi hi go into accumulators of their own, summed at the end
template <int D, int N, int P>
__device__ __forceinline__ void products_over_d(float (&s)[P][N / 8][4], const float* const (&a)[P],
                                                const float* const (&b)[P], int gq, int t4) {
  constexpr int NT = N / 8, DT = D / 8, LD = D + 4;
  float sc[P][NT][4], sh[P][NT][4];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[p][n][e] = sh[p][n][e] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < DT; ++kk) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float* ar = a[p] + gq * LD + t4 + 8 * kk;
      const float* br = b[p] + gq * LD + t4 + 8 * kk;
      uint32_t ah[4], al[4];
      split_hi(ar[0], ah[0], al[0]);
      split_hi(ar[8 * LD], ah[1], al[1]);
      split_hi(ar[4], ah[2], al[2]);
      split_hi(ar[8 * LD + 4], ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t bh0, bl0, bh1, bl1;
        split_hi(br[8 * n * LD], bh0, bl0);
        split_hi(br[8 * n * LD + 4], bh1, bl1);
        mma(sc[p][n], al, bh0, bh1);
        mma(sc[p][n], ah, bl0, bl1);
        mma(sh[p][n], ah, bh0, bh1);
      }
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[p][n][e] = sc[p][n][e] + sh[p][n][e];
}

// acc += x b over a tile's N rows of b ([N][LD]): x a warp's 16 x N tile in the C layout (k index t = row
// 2t of the step, t + 4 = row 2t + 1, where the C layout left them: a = (c0, c2, c1, c3)), acc its 16 x D
// (C layout, column tiles of 8): dq += dS K, dV += P^T g, dK += dS^T q. Each column tile's sum over the
// tile goes into a zeroed partial added to acc
template <int D, int N>
__device__ __forceinline__ void add_product_over_tile(float (&acc)[D / 8][4], const float (&x)[N / 8][4],
                                                      const float* b, int gq, int t4) {
  constexpr int NT = N / 8, DT = D / 8, LD = D + 4;
  uint32_t xh[NT][4], xl[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    split_hi(x[i][0], xh[i][0], xl[i][0]);
    split_hi(x[i][2], xh[i][1], xl[i][1]);
    split_hi(x[i][1], xh[i][2], xl[i][2]);
    split_hi(x[i][3], xh[i][3], xl[i][3]);
  }
  const float* bc = b + 2 * t4 * LD + gq;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      uint32_t bh0, bl0, bh1, bl1;
      split_hi(bc[8 * i * LD + 8 * j], bh0, bl0);
      split_hi(bc[(8 * i + 1) * LD + 8 * j], bh1, bl1);
      mma_3x(part, xh[i], xl[i], bh0, bh1, bl0, bl1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += part[e];
  }
}

template <int D, int W, int BN>
__global__ void __launch_bounds__(32 * W, two_fit(dq_smem(D, W, BN)) ? 2 : 1)
flash_bwd_dq_kernel_tf32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                         const int* __restrict__ bounds, const float* __restrict__ g, const float* __restrict__ lse,
                         const float* __restrict__ delta, float* __restrict__ dq, int B, int Sq, int Sk, int H,
                         int HK, int Hm, int C, int causal, float scale) {
  constexpr int kThreads = 32 * W, RM = 16 * W, NT = BN / 8, DT = D / 8, LD = D + 4;
  extern __shared__ __align__(16) float smf[];
  float* q_s = smf;                // [RM][LD]
  float* g_s = q_s + RM * LD;      // [RM][LD]
  float* k_s = g_s + RM * LD;      // [2][BN][LD]
  float* v_s = k_s + 2 * BN * LD;  // [2][BN][LD]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, t4 = lane & 3;
  // the query tile runs slowest, so under causal the longest walks (the last query tiles) go first
  const int n_qt = (Sq + RM - 1) / RM;
  const int rank = static_cast<int>(blockIdx.x) / (H * B), bh = static_cast<int>(blockIdx.x) % (H * B);
  const int qt = causal ? n_qt - 1 - rank : rank;
  const int h = bh % H, b = bh / H, hk = h / (H / HK);
  const int r0 = qt * RM;
  const size_t q_stride = static_cast<size_t>(H) * D, kv_stride = static_cast<size_t>(HK) * D;
  const float* qb = q + (static_cast<size_t>(b) * Sq * H + h) * D;
  const float* gb = g + (static_cast<size_t>(b) * Sq * H + h) * D;
  const float* kb = k + (static_cast<size_t>(b) * Sk * HK + hk) * D;
  const float* vb = v + (static_cast<size_t>(b) * Sk * HK + hk) * D;
  const int* bb = C ? bounds + (static_cast<size_t>(b) * Hm + (Hm == 1 ? 0 : h)) * Sk * C : nullptr;

  const int row_a = r0 + 16 * warp + gq, row_b = row_a + 8;
  const size_t st = (static_cast<size_t>(b) * H + h) * Sq;
  // rows past Sq read lse = +inf: their p is 0
  const float lse_r[2] = {row_a < Sq ? lse[st + row_a] : fl::kInf, row_b < Sq ? lse[st + row_b] : fl::kInf};
  const float dl_r[2] = {row_a < Sq ? delta[st + row_a] : 0.f, row_b < Sq ? delta[st + row_b] : 0.f};
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int hi_t = fl::walk_end(r0, RM, BN, Sq, Sk, causal);
  fl::TileBounds<BN> tb;
  // the first visited tile at or after t (hi_t if none), its class in cls
  const auto next = [&](int t, int& cls) {
    for (; t < hi_t; ++t) {
      cls = fl::warp_tile_class<BN>(tb, bb, C, r0, RM, t * BN, Sq, Sk, causal, lane);
      if (cls != fl::kSkip) return t;
    }
    return hi_t;
  };
  const auto issue = [&](int t, int buf) {
    fl::stage_rows<BN, D, LD, kThreads>(k_s + buf * BN * LD, kb, kv_stride, t * BN, Sk);
    fl::stage_rows<BN, D, LD, kThreads>(v_s + buf * BN * LD, vb, kv_stride, t * BN, Sk);
  };
  int cls = fl::kSkip;
  int t = next(0, cls);
  if (t < hi_t) {
    fl::stage_rows<RM, D, LD, kThreads>(q_s, qb, q_stride, r0, Sq);
    fl::stage_rows<RM, D, LD, kThreads>(g_s, gb, q_stride, r0, Sq);
    issue(t, 0);
  }
  hp::cp_async_commit();
  int buf = 0;
  while (t < hi_t) {
    int cls_n = fl::kSkip;
    const int tn = next(t + 1, cls_n);
    if (tn < hi_t) issue(tn, buf ^ 1);
    hp::cp_async_commit();
    hp::cp_async_wait_group<1>();  // tile t's copies (and q, g) have landed; tile tn's may fly
    __syncthreads();
    const float* ks = k_s + buf * BN * LD;
    const float* vs = v_s + buf * BN * LD;
    const int c0 = t * BN;

    // S = q K^T and dP = g V^T, 16 rows x BN keys a warp
    float sd[2][NT][4];
    products_over_d<D, BN, 2>(sd, {q_s + 16 * warp * LD, g_s + 16 * warp * LD}, {ks, vs}, gq, t4);
    float(&sc)[NT][4] = sd[0];
    const float(&dp)[NT][4] = sd[1];
    // P = exp(scale S - lse), 0 where masked (the mask on PARTIAL tiles only), and dS = P (dP - delta) scale,
    // in sc: element e of tile n is (row a / b for e < 2 / e >= 2, key c0 + 8 n + 2 t + e % 2)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(scale * sc[n][e] - lse_r[e >> 1]);
        sc[n][e] = p * (dp[n][e] - dl_r[e >> 1]) * scale;
      }
    if (cls == fl::kPartial) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c0 + 8 * n + 2 * t4 + e;
          int bnd[4] = {0, 0, 0, 0};
          if (C && col < Sk) {
            for (int x = 0; x < C; ++x) bnd[x] = bb[static_cast<size_t>(col) * C + x];
          }
          if (fl::masked(row_a, col, Sq, Sk, causal, bnd, C)) sc[n][e] = 0.f;
          if (fl::masked(row_b, col, Sq, Sk, causal, bnd, C)) sc[n][2 + e] = 0.f;
        }
      }
    }
    add_product_over_tile<D, BN>(acc, sc, ks, gq, t4);  // dq += dS K
    __syncthreads();  // every warp is done with this buffer before the next tile's copies go there
    t = tn, cls = cls_n, buf ^= 1;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row_b : row_a;
    if (row >= Sq) continue;
    float* drow = dq + (static_cast<size_t>(b) * Sq + row) * q_stride + static_cast<size_t>(h) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < DT; ++j) *reinterpret_cast<float2*>(drow + 8 * j) = make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
  }
}

template <int D, int BM>
__global__ void __launch_bounds__(kDkvThreads, two_fit(dkv_smem(D, BM)) ? 2 : 1)
flash_bwd_dkv_kernel_tf32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                          const int* __restrict__ bounds, const float* __restrict__ g, const float* __restrict__ lse,
                          const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int B,
                          int Sq, int Sk, int H, int HK, int Hm, int C, int causal, float scale) {
  constexpr int BN = kDkvKeys, NT = BM / 8, DT = D / 8, LD = D + 4;
  extern __shared__ __align__(16) float smf[];
  float* k_s = smf;                  // [64][LD]
  float* v_s = k_s + BN * LD;        // [64][LD]
  float* q_s = v_s + BN * LD;        // [2][BM][LD]
  float* g_s = q_s + 2 * BM * LD;    // [2][BM][LD]
  float* x_s = g_s + 2 * BM * LD;    // [4 warps][NT][32 lanes][4]: P^T from warpgroup 0 to 1
  float* lse_s = x_s + BN * BM;      // [2][BM]
  float* dl_s = lse_s + 2 * BM;      // [2][BM]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, wg = warp >> 2, kw = warp & 3;
  const int gq = lane >> 2, t4 = lane & 3;
  // the key tile runs slowest, so under causal the longest walks (the first key tiles) go first
  const int kt = static_cast<int>(blockIdx.x) / (HK * B), bh = static_cast<int>(blockIdx.x) % (HK * B);
  const int hk = bh % HK, b = bh / HK, G = H / HK;
  const int k0 = kt * BN;
  const size_t q_stride = static_cast<size_t>(H) * D, kv_stride = static_cast<size_t>(HK) * D;
  const float* kb = k + (static_cast<size_t>(b) * Sk * HK + hk) * D;
  const float* vb = v + (static_cast<size_t>(b) * Sk * HK + hk) * D;
  const int n_qt = (Sq + BM - 1) / BM;
  const int lo = causal ? max(k0 - (Sk - Sq), 0) / BM : 0;
  const int n_items = G * n_qt;
  const int key_a = k0 + 16 * kw + gq, key_b = key_a + 8;

  float acc[DT][4];  // warpgroup 0: dV; warpgroup 1: dK (the warp's 16 keys)
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  // the walk: items (query head gi of the group, query tile qt) in order; the per-slot min and max of the
  // key tile's bounds for the head being classed (one head's for all when Hm == 1)
  fl::TileBounds<BN> tb;
  int mn[4] = {0, 0, 0, 0}, mx[4] = {0, 0, 0, 0}, classed = -1;
  const auto bounds_of = [&](int gi) {
    const int h = hk * G + gi;
    return C ? bounds + (static_cast<size_t>(b) * Hm + (Hm == 1 ? 0 : h)) * Sk * C : nullptr;
  };
  // the first visited item at or after it (n_items if none), its class in cls
  const auto next = [&](int it, int& cls) {
    for (; it < n_items; ++it) {
      const int gi = it / n_qt, qt = it % n_qt;
      if (qt < lo) continue;
      const int head = Hm == 1 ? 0 : gi;
      if (C && head != classed) {
        fl::warp_tile_bounds<BN>(tb, mn, mx, bounds_of(gi), C, k0, Sk, lane);
        classed = head;
      }
      cls = fl::tile_class_of(mn, mx, C, qt * BM, BM, k0, BN, Sq, Sk, causal);
      if (cls != fl::kSkip) return it;
    }
    return n_items;
  };
  const auto issue = [&](int it, int buf) {
    const int gi = it / n_qt, q0 = (it % n_qt) * BM, h = hk * G + gi;
    const size_t base = (static_cast<size_t>(b) * Sq * H + h) * D;
    fl::stage_rows<BM, D, LD, kDkvThreads>(q_s + buf * BM * LD, q + base, q_stride, q0, Sq);
    fl::stage_rows<BM, D, LD, kDkvThreads>(g_s + buf * BM * LD, g + base, q_stride, q0, Sq);
    if (threadIdx.x < 2 * BM) {  // lse and delta of the tile's rows (0 past Sq: those rows are masked)
      const int r = threadIdx.x % BM, row = q0 + r;
      const bool in = row < Sq;
      const size_t at = (static_cast<size_t>(b) * H + h) * Sq + (in ? row : 0);
      if (threadIdx.x < BM) hp::cp_async4_zfill(lse_s + buf * BM + r, lse + at, in);
      else hp::cp_async4_zfill(dl_s + buf * BM + r, delta + at, in);
    }
  };
  int cls = fl::kSkip;
  int it = next(0, cls);
  if (it < n_items) {
    fl::stage_rows<BN, D, LD, kDkvThreads>(k_s, kb, kv_stride, k0, Sk);
    fl::stage_rows<BN, D, LD, kDkvThreads>(v_s, vb, kv_stride, k0, Sk);
    issue(it, 0);
  }
  hp::cp_async_commit();
  int buf = 0;
  while (it < n_items) {
    int cls_n = fl::kSkip;
    const int itn = next(it + 1, cls_n);
    if (itn < n_items) issue(itn, buf ^ 1);
    hp::cp_async_commit();
    hp::cp_async_wait_group<1>();  // item it's copies (and K, V) have landed; item itn's may fly
    __syncthreads();
    const int gi = it / n_qt, q0 = (it % n_qt) * BM;
    const float* qs = q_s + buf * BM * LD;
    const float* gs = g_s + buf * BM * LD;
    const float* ls = lse_s + buf * BM;
    const float* dls = dl_s + buf * BM;
    float* xw = x_s + kw * NT * 128 + lane * 4;
    // element e of tile n: key a / b for e < 2 / e >= 2, row q0 + 8 n + 2 t + e % 2
    float st[1][NT][4];
    float(&s)[NT][4] = st[0];
    if (wg == 0) {
      // S^T = K q^T, then P^T = exp(scale S^T - lse), 0 where masked (on PARTIAL tiles, and rows past Sq)
      products_over_d<D, BM, 1>(st, {k_s + 16 * kw * LD}, {qs}, gq, t4);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = expf(scale * s[n][e] - ls[8 * n + 2 * t4 + (e & 1)]);
      if (cls == fl::kPartial) {
        const int* bb = bounds_of(gi);
        int ba[4] = {0, 0, 0, 0}, bz[4] = {0, 0, 0, 0};
        for (int x = 0; x < C; ++x) {
          if (key_a < Sk) ba[x] = bb[static_cast<size_t>(key_a) * C + x];
          if (key_b < Sk) bz[x] = bb[static_cast<size_t>(key_b) * C + x];
        }
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int row = q0 + 8 * n + 2 * t4 + e;
            if (row >= Sq || fl::masked(row, key_a, Sq, Sk, causal, ba, C)) s[n][e] = 0.f;
            if (row >= Sq || fl::masked(row, key_b, Sq, Sk, causal, bz, C)) s[n][2 + e] = 0.f;
          }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) *reinterpret_cast<float4*>(xw + n * 128) = make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
      hp::named_barrier_arrive(kBarHandoff, kDkvThreads);
      add_product_over_tile<D, BM>(acc, s, gs, gq, t4);  // dV += P^T g
    } else {
      // dP^T = V g^T, then dS^T = P^T (dP^T - delta) scale with warpgroup 0's P^T
      products_over_d<D, BM, 1>(st, {v_s + 16 * kw * LD}, {gs}, gq, t4);
      hp::named_barrier(kBarHandoff, kDkvThreads);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float4 p = *reinterpret_cast<const float4*>(xw + n * 128);
        const float pe[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = pe[e] * (s[n][e] - dls[8 * n + 2 * t4 + (e & 1)]) * scale;
      }
      add_product_over_tile<D, BM>(acc, s, qs, gq, t4);  // dK += dS^T q
    }
    __syncthreads();  // both warpgroups are done with this slot and P^T before they are written again
    it = itn, cls = cls_n, buf ^= 1;
  }

  float* out = wg == 0 ? dv : dk;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = r ? key_b : key_a;
    if (key >= Sk) continue;
    float* orow = out + (static_cast<size_t>(b) * Sk + key) * kv_stride + static_cast<size_t>(hk) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < DT; ++j) *reinterpret_cast<float2*>(orow + 8 * j) = make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
  }
}

template <int D, int W, int BN>
int launch_dq_as(const void* q, const void* k, const void* v, const void* bounds, const void* g, const void* lse,
                 const void* delta, void* dq, int B, int Sq, int Sk, int H, int HK, int Hm, int C, int causal,
                 float scale, cudaStream_t stream) {
  constexpr int kSmem = dq_smem(D, W, BN);
  static_assert(kSmem <= kSmemPerBlock, "a block's shared memory");
  auto kernel = flash_bwd_dq_kernel_tf32<D, W, BN>;
  const int err = ptt::allow_smem(kernel, kSmem);
  if (err) return err;
  const int n_qt = (Sq + 16 * W - 1) / (16 * W);
  kernel<<<n_qt * H * B, 32 * W, kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(bounds), static_cast<const float*>(g), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), B, Sq, Sk, H, HK, Hm, C, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int BM>
int launch_dkv_as(const void* q, const void* k, const void* v, const void* bounds, const void* g, const void* lse,
                  const void* delta, void* dk, void* dv, int B, int Sq, int Sk, int H, int HK, int Hm, int C,
                  int causal, float scale, cudaStream_t stream) {
  constexpr int kSmem = dkv_smem(D, BM);
  static_assert(kSmem <= kSmemPerBlock, "a block's shared memory");
  auto kernel = flash_bwd_dkv_kernel_tf32<D, BM>;
  const int err = ptt::allow_smem(kernel, kSmem);
  if (err) return err;
  const int n_kt = (Sk + kDkvKeys - 1) / kDkvKeys;
  kernel<<<n_kt * HK * B, kDkvThreads, kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(bounds), static_cast<const float*>(g), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv), B, Sq, Sk, H, HK, Hm, C,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The fp32 dq and dk/dv on the tensor cores: flash_fp32.cu's entry arguments
// (q, k, v, g, dq, dk, dv fp32), at head dims 64, 128, 192 and 256 (the
// scheduler counter goes unused). Another head dim returns
// cudaErrorInvalidValue.
#define PTT_FLASH_TF32_DIMS(LAUNCH)              \
  switch (D) {                                  \
    case 64: return LAUNCH(64);                 \
    case 128: return LAUNCH(128);               \
    case 192: return LAUNCH(192);               \
    case 256: return LAUNCH(256);               \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

extern "C" int ptt_flash_bwd_dq_tf32x3(const void* q, const void* k, const void* v, const void* bounds, const void* g,
                                       const void* lse, const void* delta, void* dq, void* /*sched: unused*/, int B,
                                       int Sq, int Sk, int H, int HK, int D, int Hm, int C, int causal, float scale,
                                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_DQ(DIM) \
  launch_dq_as<DIM, dq_warps(DIM), dq_keys(DIM)>(q, k, v, bounds, g, lse, delta, dq, B, Sq, Sk, H, HK, Hm, C, causal, scale, s)
  PTT_FLASH_TF32_DIMS(PTT_DQ)
#undef PTT_DQ
}

extern "C" int ptt_flash_bwd_dkv_tf32x3(const void* q, const void* k, const void* v, const void* bounds, const void* g,
                                        const void* lse, const void* delta, void* dk, void* dv,
                                        void* /*sched: unused*/, int B, int Sq, int Sk, int H, int HK, int D, int Hm,
                                        int C, int causal, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_DKV(DIM) \
  launch_dkv_as<DIM, dkv_rows(DIM)>(q, k, v, bounds, g, lse, delta, dk, dv, B, Sq, Sk, H, HK, Hm, C, causal, scale, s)
  PTT_FLASH_TF32_DIMS(PTT_DKV)
#undef PTT_DKV
}

// The fp32 backward's plan at head dim D for `kernel` (0 dq, 1 dk/dv;
// kernels/flash_attention.py `flash_bwd_fp32_plan` mirrors it, chip_smoke.py
// holds the two equal): out[0] the walk (0 this file's 3xTF32 walk, D
// 64-256; 1 flash_fp32.cu's CUDA-core walk, D 320-512), then for this file's
// walk the query rows and keys of a tile (dq: the CTA's query rows and the
// keys of a K/V tile; dk/dv: the query rows of a q/g tile and the CTA's
// keys), the buffers of the ring, the CTA's dynamic shared-memory bytes and
// its warps (0 for the CUDA-core walk, whose geometry is flash_fp32.cu's).
// Returns cudaErrorInvalidValue for a head dim neither walk takes or a
// kernel other than 0 and 1.
extern "C" int ptt_flash_bwd_fp32_plan(int D, int kernel, int* out) {
  if (D <= 0 || D % 64 || D > 512 || (kernel != 0 && kernel != 1)) return static_cast<int>(cudaErrorInvalidValue);
  if (D > 256) {
    out[0] = 1, out[1] = out[2] = out[3] = out[4] = out[5] = 0;
  } else if (kernel == 0) {
    const int w = dq_warps(D), bn = dq_keys(D);
    out[0] = 0, out[1] = 16 * w, out[2] = bn, out[3] = 2, out[4] = dq_smem(D, w, bn), out[5] = w;
  } else {
    const int bm = dkv_rows(D);
    out[0] = 0, out[1] = bm, out[2] = kDkvKeys, out[3] = 2, out[4] = dkv_smem(D, bm), out[5] = kDkvThreads / 32;
  }
  return 0;
}
