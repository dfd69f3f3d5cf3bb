// Flash-attention forward with FlashMask bounds: out = softmax(scale q k^T +
// mask) v and the row logsumexp lse, for q [B, Sq, H, D] and k, v
// [B, Sk, HK, D] (query head h reads KV head h / (H / HK)), read in place in
// that layout.
//
// Replaces: paddle_tpu/kernels/flash_attention.py `_fwd_kernel` (launched by
// `_run_fwd`, entry `flash_attention_pallas`), the training step's attention.
//
// Semantics kept from the Pallas kernel: key tiles are walked from the first
// to the causal limit ceil(((qt + 1) * BM + Sk - Sq) / BN); a logit is masked
// for padding columns, causally (col > row + Sk - Sq) and by the column's
// FlashMask bounds (C = 1, 2 or 4 per column, read per key tile — the dense
// mask never exists); a masked logit contributes exactly 0; out = acc / l and
// lse = m + log(l) in fp32. Where a row has no visible column the kernel
// writes out = 0 and lse = +inf (the Pallas kernel averages V there).
// Ragged Sq and Sk are bounds-checked here (no padded copies).
//
// Design (simple first). One block of 4 warps per (64-row query tile, head,
// batch); each warp owns 16 query rows, keeps their Q fragments in registers
// for the whole walk, and runs the online softmax on its rows. Per 64-key
// tile the block stages K row-major and V transposed in shared memory; S =
// Q K^T and O += P V run on the tensor cores (mma.sync m16n8k16, bf16 in,
// fp32 accumulate), P going from the S accumulators to the next product's A
// fragments in registers (rounded to bf16, as flash attention does; l sums
// the fp32 p). Scaling, masking and exp run in fp32 on the CUDA cores.
//
// Bound on H100: operations. At the training shape (S 4096, D 128) it does
// 4 D flops per visible (row, column) against 8 D bytes per row; the bf16
// tensor-core rate (989 TFLOP/s) is the limit. This version reaches a
// fraction of it: no load/compute overlap (no cp.async or TMA pipeline),
// mma.sync rather than wgmma, and blocks on fully masked FlashMask tiles are
// not skipped (flashmask_maxmin block skipping is later work).
#include "flash_common.cuh"

using ptt::bf16;
namespace fl = ptt::flash;

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kBM = 64;        // query rows per block (16 per warp)
constexpr int kBN = 64;        // keys per tile

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ bounds,
                 bf16* __restrict__ out, float* __restrict__ lse, int Sq, int Sk, int H, int HK,
                 int Hm, int C, int causal, float scale) {
  constexpr int kLdK = D + 8;    // padded rows: fragment loads hit 32 banks
  constexpr int kLdV = kBN + 8;
  constexpr int kNT = kBN / 8;   // S column tiles per warp
  constexpr int kDK = D / 16;    // k16 steps over D
  constexpr int kDN = D / 8;     // O column tiles
  __shared__ __align__(16) bf16 k_s[kBN * kLdK];
  __shared__ __align__(16) bf16 vt_s[D * kLdV];
  __shared__ int bnd_s[kBN * 4];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / HK);
  const size_t q_stride = static_cast<size_t>(H) * D, kv_stride = static_cast<size_t>(HK) * D;
  const bf16* qb = q + (static_cast<size_t>(b) * Sq * H + h) * D;
  const bf16* kb = k + (static_cast<size_t>(b) * Sk * HK + hk) * D;
  const bf16* vb = v + (static_cast<size_t>(b) * Sk * HK + hk) * D;
  const int* bb = C ? bounds + (static_cast<size_t>(b) * Hm + (Hm == 1 ? 0 : h)) * Sk * C : nullptr;
  const int row0 = qt * kBM + warp * 16 + gid;  // this thread's rows: row0, row0 + 8
  const int rows[2] = {row0, row0 + 8};

  uint32_t qa[kDK][4];
#pragma unroll
  for (int kk = 0; kk < kDK; ++kk) {
    const int c = kk * 16 + 2 * tig;
    qa[kk][0] = rows[0] < Sq ? fl::ld2(qb + rows[0] * q_stride + c) : 0u;
    qa[kk][1] = rows[1] < Sq ? fl::ld2(qb + rows[1] * q_stride + c) : 0u;
    qa[kk][2] = rows[0] < Sq ? fl::ld2(qb + rows[0] * q_stride + c + 8) : 0u;
    qa[kk][3] = rows[1] < Sq ? fl::ld2(qb + rows[1] * q_stride + c + 8) : 0u;
  }

  float o[kDN][4];
#pragma unroll
  for (int dn = 0; dn < kDN; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  float m[2] = {-fl::kInf, -fl::kInf}, l[2] = {0.f, 0.f};

  const int n_tiles = (Sk + kBN - 1) / kBN;
  int hi = n_tiles;
  if (causal) {
    const long long lim = static_cast<long long>(qt + 1) * kBM + (Sk - Sq);
    const long long need = (lim + kBN - 1) / kBN;
    hi = lim <= 0 ? 0 : (need < n_tiles ? static_cast<int>(need) : n_tiles);
  }

  for (int t = 0; t < hi; ++t) {
    const int k0 = t * kBN;
    __syncthreads();  // the previous tile's reads are done
    fl::stage_rows<kBN, D, kThreads>(k_s, kLdK, nullptr, 0, kb, kv_stride, k0, Sk);
    {
      // V transposed: vt_s[d][key]; neighbouring threads take neighbouring
      // keys of one 8-column chunk, so a warp's 2-byte stores hit 16 banks
      constexpr int kVec = D / 8;
      for (int i = threadIdx.x; i < kBN * kVec; i += kThreads) {
        const int r = i % kBN, c = (i / kBN) * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (k0 + r < Sk) val = *reinterpret_cast<const uint4*>(vb + (k0 + r) * kv_stride + c);
        const bf16* e = ptt::elems(val);
#pragma unroll
        for (int j = 0; j < 8; ++j) vt_s[(c + j) * kLdV + r] = e[j];
      }
    }
    if (C) fl::stage_bounds<kBN, kThreads>(bnd_s, bb, C, k0, Sk);
    __syncthreads();

    float s[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDK; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        uint32_t b0, b1;
        fl::load_b(b0, b1, k_s, kLdK, nt * 8, kk * 16, gid, tig);
        fl::mma16816(s[nt], qa[kk], b0, b1);
      }
    }

    // scale and mask; the tile's row maxima
    float mx[2] = {-fl::kInf, -fl::kInf};
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col_l = nt * 8 + 2 * tig + (e & 1);
        const int r = e >> 1;
        float x = s[nt][e] * scale;
        if (fl::masked(rows[r], k0 + col_l, Sq, Sk, causal, bnd_s + col_l * C, C)) x = -fl::kInf;
        s[nt][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the 4 lanes of a row group hold its 64 columns
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = (m_new == -fl::kInf) ? 1.f : expf(m[r] - m_new);
      m[r] = m_new;
    }
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        // a row with nothing visible yet keeps p = 0 (m is still -inf)
        const float p = (m[r] == -fl::kInf) ? 0.f : expf(s[nt][e] - m[r]);
        s[nt][e] = p;
        ls[r] += p;
      }
    }
    l[0] = l[0] * alpha[0] + ls[0];
    l[1] = l[1] * alpha[1] + ls[1];
#pragma unroll
    for (int dn = 0; dn < kDN; ++dn) {
      o[dn][0] *= alpha[0];
      o[dn][1] *= alpha[0];
      o[dn][2] *= alpha[1];
      o[dn][3] *= alpha[1];
    }

    // O += P V
#pragma unroll
    for (int kt = 0; kt < kBN / 16; ++kt) {
      uint32_t pa[4];
      fl::c_to_a(pa, s[2 * kt], s[2 * kt + 1]);
#pragma unroll
      for (int dn = 0; dn < kDN; ++dn) {
        uint32_t b0, b1;
        fl::load_b(b0, b1, vt_s, kLdV, dn * 8, kt * 16, gid, tig);
        fl::mma16816(o[dn], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rows[r];
    if (row >= Sq) continue;
    const bool seen = l[r] > 0.f;
    bf16* orow = out + (static_cast<size_t>(b) * Sq + row) * q_stride + static_cast<size_t>(h) * D;
#pragma unroll
    for (int dn = 0; dn < kDN; ++dn) {
      const float x0 = seen ? o[dn][2 * r] / l[r] : 0.f;
      const float x1 = seen ? o[dn][2 * r + 1] / l[r] : 0.f;
      *reinterpret_cast<uint32_t*>(orow + dn * 8 + 2 * tig) = fl::pack2(x0, x1);
    }
    if (tig == 0)
      lse[(static_cast<size_t>(b) * H + h) * Sq + row] = seen ? m[r] + logf(l[r]) : fl::kInf;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* bounds, void* out, void* lse,
           int B, int Sq, int Sk, int H, int HK, int Hm, int C, int causal, float scale,
           cudaStream_t stream) {
  const dim3 grid((Sq + kBM - 1) / kBM, H, B);
  flash_fwd_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(bounds), static_cast<bf16*>(out), static_cast<float*>(lse), Sq, Sk,
      H, HK, Hm, C, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, Sq, H, D], k/v [B, Sk, HK, D] bf16 contiguous; bounds [B, Hm, Sk, C]
// int32 or null (C = 0); out [B, Sq, H, D] bf16; lse [B, H, Sq] fp32.
// D is 64 or 128.
extern "C" int ptt_flash_fwd_bf16(const void* q, const void* k, const void* v, const void* bounds,
                                  void* out, void* lse, int B, int Sq, int Sk, int H, int HK,
                                  int D, int Hm, int C, int causal, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) return launch<128>(q, k, v, bounds, out, lse, B, Sq, Sk, H, HK, Hm, C, causal, scale, st);
  if (D == 64) return launch<64>(q, k, v, bounds, out, lse, B, Sq, Sk, H, HK, Hm, C, causal, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
