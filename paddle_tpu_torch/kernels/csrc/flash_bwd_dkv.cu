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
// partials that XLA sums over the group afterwards; here one block owns a
// (key tile, KV head) and walks the group's query heads itself, so dk and dv
// stay in fp32 registers and are written once, in k's dtype, with no
// atomics (deterministic).
//
// Semantics kept from the Pallas kernel: query tiles are walked from the
// causal start floor((k0 - (Sk - Sq)) / BM) (0 if negative) to the end; the
// mask is flash_common.cuh `masked`, plus rows past Sq contribute nothing;
// the product q k^T is scaled, not q.
//
// Design (simple first). One block of 4 warps per (64-key tile, KV head,
// batch, column part); each warp owns 16 keys and holds their dk, dv rows
// (16 x DO each, DO = D output columns up to D 128, D / 2 above) in fp32
// registers; at D 192 and 256 the columns are split over two blocks,
// each recomputing S and dP over the full D. K and V stay in dynamic shared
// memory for the whole walk. Per (query head, 32-row query tile) the block
// stages Q and g row-major, and their part's columns transposed, from one
// read; then per
// warp S^T = K Q^T and dP^T = V g^T, p and ds on the CUDA cores, dv += P^T g
// and dk += dS^T Q — four mma.sync m16n8k16 products (bf16 or fp16 in, fp32
// accumulate), P^T and dS^T fed from accumulators to A fragments in
// registers, rounded to the input type.
//
// Bound on H100: operations — four products of 2 D flops per visible
// (row, column). Not near it: no pipelining, mma.sync, and every staged
// query tile is written to shared memory twice (row-major and transposed);
// no FlashMask tile is skipped.
#include "flash_common.cuh"

namespace fl = ptt::flash;

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kBN = 64;        // keys per block (16 per warp)
constexpr int kBM = 32;        // query rows per inner tile

template <int D>
struct Smem {
  static constexpr int kDO = D <= 128 ? D : D / 2;     // output columns of one block
  static constexpr int kLd = D + 8;                    // padded row-major tiles
  static constexpr int kLdT = kBM + 8;                 // padded transposed tiles
  static constexpr int kK = 0;                         // K  [kBN][kLd]
  static constexpr int kV = kK + kBN * kLd;            // V  [kBN][kLd]
  static constexpr int kQ = kV + kBN * kLd;            // Q  [kBM][kLd]
  static constexpr int kG = kQ + kBM * kLd;            // g  [kBM][kLd]
  static constexpr int kQt = kG + kBM * kLd;           // Q^T [kDO][kLdT] (the part's columns)
  static constexpr int kGt = kQt + kDO * kLdT;         // g^T [kDO][kLdT]
  static constexpr int kElems = kGt + kDO * kLdT;      // 2-byte elements
  // then fp32 lse[kBM] and delta[kBM]
  static constexpr size_t kBytes = kElems * 2 + 2 * kBM * sizeof(float);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const int* __restrict__ bounds, const T* __restrict__ g, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int H,
                     int HK, int Hm, int C, int causal, float scale) {
  using L = Smem<D>;
  constexpr int kDO = L::kDO;
  constexpr int kNT = kBM / 8;  // S^T column (query) tiles per warp
  constexpr int kDK = D / 16;
  constexpr int kDN = kDO / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  T *k_s = sm + L::kK, *v_s = sm + L::kV, *q_s = sm + L::kQ, *g_s = sm + L::kG;
  T *qt_s = sm + L::kQt, *gt_s = sm + L::kGt;
  float* lse_s = reinterpret_cast<float*>(sm + L::kElems);
  float* dl_s = lse_s + kBM;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int parts = D / kDO;
  const int kt_blk = blockIdx.x / parts, d0 = (blockIdx.x % parts) * kDO;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int G = H / HK;
  const int k0 = kt_blk * kBN;
  const size_t q_stride = static_cast<size_t>(H) * D, kv_stride = static_cast<size_t>(HK) * D;
  const T* kb = k + (static_cast<size_t>(b) * Sk * HK + hk) * D;
  const T* vb = v + (static_cast<size_t>(b) * Sk * HK + hk) * D;
  const int key0 = warp * 16 + gid;  // this thread's keys (tile-local): key0, key0 + 8
  const int keys[2] = {key0, key0 + 8};

  fl::stage_rows<kBN, D, kThreads>(k_s, L::kLd, kb, kv_stride, k0, Sk);
  fl::stage_rows<kBN, D, kThreads>(v_s, L::kLd, vb, kv_stride, k0, Sk);

  float dk_acc[kDN][4], dv_acc[kDN][4];
#pragma unroll
  for (int dn = 0; dn < kDN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dn][e] = dv_acc[dn][e] = 0.f;

  const int n_qt = (Sq + kBM - 1) / kBM;
  int lo = 0;
  if (causal) {
    const int first = k0 - (Sk - Sq);  // the first query row that can see key k0
    lo = first <= 0 ? 0 : first / kBM;
  }

  for (int gi = 0; gi < G; ++gi) {
    const int h = hk * G + gi;
    const T* qb = q + (static_cast<size_t>(b) * Sq * H + h) * D;
    const T* gb = g + (static_cast<size_t>(b) * Sq * H + h) * D;
    const float* lse_h = lse + (static_cast<size_t>(b) * H + h) * Sq;
    const float* dl_h = delta + (static_cast<size_t>(b) * H + h) * Sq;
    const int* bb = C ? bounds + (static_cast<size_t>(b) * Hm + (Hm == 1 ? 0 : h)) * Sk * C : nullptr;
    // this thread's two keys' bounds (0 past Sk: those keys are masked anyway)
    int kbnd[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kbnd[r][j] = (j < C && k0 + keys[r] < Sk) ? bb[static_cast<size_t>(k0 + keys[r]) * C + j] : 0;
    for (int qt = lo; qt < n_qt; ++qt) {
      const int q0 = qt * kBM;
      __syncthreads();  // the previous tile's reads are done (and K, V staged)
      fl::stage_rows_both<kBM, D, kDO, kThreads>(q_s, L::kLd, qt_s, L::kLdT, d0, qb, q_stride, q0, Sq);
      fl::stage_rows_both<kBM, D, kDO, kThreads>(g_s, L::kLd, gt_s, L::kLdT, d0, gb, q_stride, q0, Sq);
      for (int i = threadIdx.x; i < kBM; i += kThreads) {
        const bool in = q0 + i < Sq;
        lse_s[i] = in ? lse_h[q0 + i] : fl::kInf;
        dl_s[i] = in ? dl_h[q0 + i] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V g^T: [16 keys x kBM rows] per warp
      float s[kNT][4], dp[kNT][4];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kDK; ++kk) {
        uint32_t ka[4], va[4];
        fl::load_a(ka, k_s, L::kLd, warp * 16, kk * 16, gid, tig);
        fl::load_a(va, v_s, L::kLd, warp * 16, kk * 16, gid, tig);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          uint32_t b0, b1;
          fl::load_b(b0, b1, q_s, L::kLd, nt * 8, kk * 16, gid, tig);
          fl::mma16816<T>(s[nt], ka, b0, b1);
          fl::load_b(b0, b1, g_s, L::kLd, nt * 8, kk * 16, gid, tig);
          fl::mma16816<T>(dp[nt], va, b0, b1);
        }
      }
      // p in s, ds in dp
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row_l = nt * 8 + 2 * tig + (e & 1);  // query row (column of S^T)
          const int kr = e >> 1;
          const int row = q0 + row_l;
          const bool off = row >= Sq || fl::masked(row, k0 + keys[kr], Sq, Sk, causal, kbnd[kr], C);
          const float p = off ? 0.f : expf(scale * s[nt][e] - lse_s[row_l]);
          s[nt][e] = p;
          dp[nt][e] = p * (dp[nt][e] - dl_s[row_l]) * scale;
        }
      }
      // dv += P^T g, dk += dS^T Q over the part's columns
#pragma unroll
      for (int kt = 0; kt < kBM / 16; ++kt) {
        uint32_t pa[4], da[4];
        fl::c_to_a<T>(pa, s[2 * kt], s[2 * kt + 1]);
        fl::c_to_a<T>(da, dp[2 * kt], dp[2 * kt + 1]);
#pragma unroll
        for (int dn = 0; dn < kDN; ++dn) {
          uint32_t b0, b1;
          fl::load_b(b0, b1, gt_s, L::kLdT, dn * 8, kt * 16, gid, tig);
          fl::mma16816<T>(dv_acc[dn], pa, b0, b1);
          fl::load_b(b0, b1, qt_s, L::kLdT, dn * 8, kt * 16, gid, tig);
          fl::mma16816<T>(dk_acc[dn], da, b0, b1);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + keys[r];
    if (key >= Sk) continue;
    const size_t at = (static_cast<size_t>(b) * Sk + key) * kv_stride + static_cast<size_t>(hk) * D + d0;
#pragma unroll
    for (int dn = 0; dn < kDN; ++dn) {
      const int c = dn * 8 + 2 * tig;
      *reinterpret_cast<uint32_t*>(dk + at + c) = fl::pack2<T>(dk_acc[dn][2 * r], dk_acc[dn][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv + at + c) = fl::pack2<T>(dv_acc[dn][2 * r], dv_acc[dn][2 * r + 1]);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* bounds, const void* g, const void* lse,
           const void* delta, void* dk, void* dv, int B, int Sq, int Sk, int H, int HK, int Hm, int C, int causal,
           float scale, cudaStream_t stream) {
  const size_t bytes = Smem<D>::kBytes;
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  const int err = ptt::allow_smem(kernel, bytes);
  if (err) return err;
  const dim3 grid((Sk + kBN - 1) / kBN * (D / Smem<D>::kDO), HK, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const int*>(bounds),
      static_cast<const T*>(g), static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), Sq, Sk, H, HK, Hm, C, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* bounds, const void* g, const void* lse,
             const void* delta, void* dk, void* dv, int B, int Sq, int Sk, int H, int HK, int D, int Hm, int C,
             int causal, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<T, 64>(q, k, v, bounds, g, lse, delta, dk, dv, B, Sq, Sk, H, HK, Hm, C, causal, scale, st);
    case 128: return launch<T, 128>(q, k, v, bounds, g, lse, delta, dk, dv, B, Sq, Sk, H, HK, Hm, C, causal, scale, st);
    case 192: return launch<T, 192>(q, k, v, bounds, g, lse, delta, dk, dv, B, Sq, Sk, H, HK, Hm, C, causal, scale, st);
    case 256: return launch<T, 256>(q, k, v, bounds, g, lse, delta, dk, dv, B, Sq, Sk, H, HK, Hm, C, causal, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, g [B, Sq, H, D], k/v [B, Sk, HK, D] contiguous in T; bounds
// [B, Hm, Sk, C] int32 or null (C = 0); lse, delta [B, H, Sq] fp32;
// dk, dv [B, Sk, HK, D] in T. D is 64, 128, 192 or 256.
extern "C" int ptt_flash_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* bounds, const void* g,
                                      const void* lse, const void* delta, void* dk, void* dv, int B, int Sq, int Sk,
                                      int H, int HK, int D, int Hm, int C, int causal, float scale, void* stream) {
  return dispatch<ptt::bf16>(q, k, v, bounds, g, lse, delta, dk, dv, B, Sq, Sk, H, HK, D, Hm, C, causal, scale,
                             stream);
}

extern "C" int ptt_flash_bwd_dkv_fp16(const void* q, const void* k, const void* v, const void* bounds, const void* g,
                                      const void* lse, const void* delta, void* dk, void* dv, int B, int Sq, int Sk,
                                      int H, int HK, int D, int Hm, int C, int causal, float scale, void* stream) {
  return dispatch<ptt::f16>(q, k, v, bounds, g, lse, delta, dk, dv, B, Sq, Sk, H, HK, D, Hm, C, causal, scale,
                            stream);
}
