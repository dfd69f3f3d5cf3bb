// Flash-attention backward, dq: dq = sum over visible columns of
// ds k, with p = exp(scale q k^T - lse) (0 where masked) and
// ds = p (g v^T - delta) scale, for q, g [B, Sq, H, D] and k, v
// [B, Sk, HK, D], read in place in that layout; lse and delta [B, H, Sq]
// fp32 (delta = rowsum(g * out), computed by the caller).
//
// Replaces: paddle_tpu/kernels/flash_attention.py `_bwd_dq_kernel`
// (launched by `_run_bwd`), the first half of the attention's backward.
//
// Semantics kept from the Pallas kernel: the same key-tile walk (first tile
// to the causal limit), mask (flash_common.cuh `masked`) and fp32 order —
// the product q k^T is scaled, not q; dq is accumulated in fp32 and written
// in q's dtype. Rows past Sq are not written.
//
// Design (simple first). One block of 4 warps per (64-row query tile, head,
// batch); each warp keeps its 16 rows' Q and g fragments in registers and
// accumulates its dq rows in fp32 registers. Per 32-key tile the block stages
// K row-major (for S = Q K^T), K transposed (for dq += dS K) and V row-major
// (for dP = g V^T); the three products run on mma.sync m16n8k16 (bf16 in,
// fp32 accumulate), dS going from accumulators to A fragments in registers,
// rounded to bf16.
//
// Bound on H100: operations — three products of 2 D flops per visible
// (row, column) against 2 x 4 D bytes per row of inputs at S 4096. Not near
// it: no pipelining, mma.sync, and a tile of only 32 keys to keep five
// fragment sets in registers.
#include "flash_common.cuh"

using ptt::bf16;
namespace fl = ptt::flash;

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kBM = 64;        // query rows per block (16 per warp)
constexpr int kBN = 32;        // keys per tile

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ bounds,
                    const bf16* __restrict__ g, const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq, int Sq, int Sk, int H,
                    int HK, int Hm, int C, int causal, float scale) {
  constexpr int kLd = D + 8;      // padded row-major tiles
  constexpr int kLdT = kBN + 8;   // padded transposed tile
  constexpr int kNT = kBN / 8;    // S column tiles per warp
  constexpr int kDK = D / 16;
  constexpr int kDN = D / 8;
  __shared__ __align__(16) bf16 k_s[kBN * kLd];
  __shared__ __align__(16) bf16 kt_s[D * kLdT];
  __shared__ __align__(16) bf16 v_s[kBN * kLd];
  __shared__ int bnd_s[kBN * 4];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / HK);
  const size_t q_stride = static_cast<size_t>(H) * D, kv_stride = static_cast<size_t>(HK) * D;
  const bf16* qb = q + (static_cast<size_t>(b) * Sq * H + h) * D;
  const bf16* gb = g + (static_cast<size_t>(b) * Sq * H + h) * D;
  const bf16* kb = k + (static_cast<size_t>(b) * Sk * HK + hk) * D;
  const bf16* vb = v + (static_cast<size_t>(b) * Sk * HK + hk) * D;
  const int* bb = C ? bounds + (static_cast<size_t>(b) * Hm + (Hm == 1 ? 0 : h)) * Sk * C : nullptr;
  const int row0 = qt * kBM + warp * 16 + gid;
  const int rows[2] = {row0, row0 + 8};

  uint32_t qa[kDK][4], ga[kDK][4];
#pragma unroll
  for (int kk = 0; kk < kDK; ++kk) {
    const int c = kk * 16 + 2 * tig;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = rows[i & 1];
      const int col = c + (i >> 1) * 8;
      qa[kk][i] = row < Sq ? fl::ld2(qb + row * q_stride + col) : 0u;
      ga[kk][i] = row < Sq ? fl::ld2(gb + row * q_stride + col) : 0u;
    }
  }
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t at = (static_cast<size_t>(b) * H + h) * Sq + rows[r];
    row_lse[r] = rows[r] < Sq ? lse[at] : fl::kInf;
    row_delta[r] = rows[r] < Sq ? delta[at] : 0.f;
  }

  float acc[kDN][4];
#pragma unroll
  for (int dn = 0; dn < kDN; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  const int n_tiles = (Sk + kBN - 1) / kBN;
  int hi = n_tiles;
  if (causal) {
    const long long lim = static_cast<long long>(qt + 1) * kBM + (Sk - Sq);
    const long long need = (lim + kBN - 1) / kBN;
    hi = lim <= 0 ? 0 : (need < n_tiles ? static_cast<int>(need) : n_tiles);
  }

  for (int t = 0; t < hi; ++t) {
    const int k0 = t * kBN;
    __syncthreads();
    fl::stage_rows<kBN, D, kThreads>(k_s, kLd, kt_s, kLdT, kb, kv_stride, k0, Sk);
    fl::stage_rows<kBN, D, kThreads>(v_s, kLd, nullptr, 0, vb, kv_stride, k0, Sk);
    if (C) fl::stage_bounds<kBN, kThreads>(bnd_s, bb, C, k0, Sk);
    __syncthreads();

    float s[kNT][4], dp[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDK; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        uint32_t b0, b1;
        fl::load_b(b0, b1, k_s, kLd, nt * 8, kk * 16, gid, tig);
        fl::mma16816(s[nt], qa[kk], b0, b1);
        fl::load_b(b0, b1, v_s, kLd, nt * 8, kk * 16, gid, tig);
        fl::mma16816(dp[nt], ga[kk], b0, b1);
      }
    }
    // p and ds, in place of s
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col_l = nt * 8 + 2 * tig + (e & 1);
        const int r = e >> 1;
        const bool off = fl::masked(rows[r], k0 + col_l, Sq, Sk, causal, bnd_s + col_l * C, C);
        const float p = off ? 0.f : expf(scale * s[nt][e] - row_lse[r]);
        s[nt][e] = p * (dp[nt][e] - row_delta[r]) * scale;
      }
    }
    // dq += dS K
#pragma unroll
    for (int kt = 0; kt < kBN / 16; ++kt) {
      uint32_t da[4];
      fl::c_to_a(da, s[2 * kt], s[2 * kt + 1]);
#pragma unroll
      for (int dn = 0; dn < kDN; ++dn) {
        uint32_t b0, b1;
        fl::load_b(b0, b1, kt_s, kLdT, dn * 8, kt * 16, gid, tig);
        fl::mma16816(acc[dn], da, b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= Sq) continue;
    bf16* drow = dq + (static_cast<size_t>(b) * Sq + rows[r]) * q_stride + static_cast<size_t>(h) * D;
#pragma unroll
    for (int dn = 0; dn < kDN; ++dn)
      *reinterpret_cast<uint32_t*>(drow + dn * 8 + 2 * tig) =
          fl::pack2(acc[dn][2 * r], acc[dn][2 * r + 1]);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* bounds, const void* g,
           const void* lse, const void* delta, void* dq, int B, int Sq, int Sk, int H, int HK,
           int Hm, int C, int causal, float scale, cudaStream_t stream) {
  const dim3 grid((Sq + kBM - 1) / kBM, H, B);
  flash_bwd_dq_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(bounds), static_cast<const bf16*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<bf16*>(dq),
      Sq, Sk, H, HK, Hm, C, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, g [B, Sq, H, D], k/v [B, Sk, HK, D] bf16 contiguous; bounds
// [B, Hm, Sk, C] int32 or null (C = 0); lse, delta [B, H, Sq] fp32;
// dq [B, Sq, H, D] bf16. D is 64 or 128.
extern "C" int ptt_flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                     const void* bounds, const void* g, const void* lse,
                                     const void* delta, void* dq, int B, int Sq, int Sk, int H,
                                     int HK, int D, int Hm, int C, int causal, float scale,
                                     void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch<128>(q, k, v, bounds, g, lse, delta, dq, B, Sq, Sk, H, HK, Hm, C, causal, scale, st);
  if (D == 64)
    return launch<64>(q, k, v, bounds, g, lse, delta, dq, B, Sq, Sk, H, HK, Hm, C, causal, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
