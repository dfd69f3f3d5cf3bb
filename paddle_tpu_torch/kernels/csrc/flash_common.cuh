// Shared pieces of the flash-attention kernels (flash_fwd.cu,
// flash_bwd_dq.cu, flash_bwd_dkv.cu): the bf16 tensor-core product, fragment
// loads from shared memory, tile staging, and the FlashMask test.
//
// Tensor-core tiles are mma.sync m16n8k16 (bf16 inputs, fp32 accumulators).
// Per warp, with lane = 4 * gid + tig:
//   A 16x16 (row-major): a0 = (gid, 2tig..+1), a1 = (gid+8, 2tig..+1),
//                        a2 = (gid, 2tig+8..+9), a3 = (gid+8, 2tig+8..+9)
//   B 16x8  (k x n):     b0 = (k 2tig..+1, n gid), b1 = (k 2tig+8..+9, n gid)
//   C 16x8  (fp32):      c0,c1 = (gid, 2tig..+1), c2,c3 = (gid+8, 2tig..+1)
// Two adjacent C tiles (n = 0..7 and 8..15) of one row block are exactly the
// A fragment of a k16 step, so probabilities and dS feed the next product
// straight from registers. Each 32-bit register holds two bf16 values, the
// lower column in the low half.
#pragma once

#include "common.cuh"

namespace ptt {
namespace flash {

constexpr float kInf = __builtin_huge_valf();

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two bf16 values at p (p 4-byte aligned) as one register
__device__ __forceinline__ uint32_t ld2(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// (lo, hi) rounded to bf16, lo in the low half
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment of a 16-row block of a row-major [rows][ld] bf16 array, at
// columns k0..k0+15
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* s, int ld, int row0, int k0,
                                       int gid, int tig) {
  const bf16* p = s + (row0 + gid) * ld + k0 + 2 * tig;
  a[0] = ld2(p);
  a[1] = ld2(p + 8 * ld);
  a[2] = ld2(p + 8);
  a[3] = ld2(p + 8 * ld + 8);
}

// B fragment (k x n = 16 x 8) from an array stored n-major: s[n][k] with
// row stride ld; n0, k0 the tile's origin
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1, const bf16* s, int ld, int n0,
                                       int k0, int gid, int tig) {
  const bf16* p = s + (n0 + gid) * ld + k0 + 2 * tig;
  b0 = ld2(p);
  b1 = ld2(p + 8);
}

// the A fragment of k16 step t built from C tiles 2t and 2t+1 (fp32 -> bf16)
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4], const float (&c1)[4]) {
  a[0] = pack2(c0[0], c0[1]);
  a[1] = pack2(c0[2], c0[3]);
  a[2] = pack2(c1[0], c1[1]);
  a[3] = pack2(c1[2], c1[3]);
}

// Stage rows [r0, r0 + R) of a [S][row_stride] bf16 tensor (D contiguous
// values per row) into shared memory: row-major into `s` (row stride ld) and,
// when `t` is given, transposed into t[d][r] (row stride ldt). Rows at or past
// S are zero. 16-byte global loads; all threads of the block take part.
// Without `t` neighbouring threads read neighbouring 16-byte chunks of a row
// (coalesced); with `t` they take neighbouring rows of one chunk, so each of
// the 8 transposed 2-byte stores of a warp hits 16 distinct banks (with
// chunks along a row, 16 threads' stores would share one bank).
template <int R, int D, int THREADS>
__device__ __forceinline__ void stage_rows(bf16* s, int ld, bf16* t, int ldt, const bf16* src,
                                           size_t row_stride, int r0, int S) {
  constexpr int kVec = D / 8;
  for (int i = threadIdx.x; i < R * kVec; i += THREADS) {
    const int r = t ? i % R : i / kVec;
    const int c = (t ? i / R : i % kVec) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S) v = *reinterpret_cast<const uint4*>(src + (r0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(s + r * ld + c) = v;
    if (t != nullptr) {
      const bf16* e = elems(v);
#pragma unroll
      for (int j = 0; j < 8; ++j) t[(c + j) * ldt + r] = e[j];
    }
  }
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

// Stage the bounds of key columns [k0, k0 + N) into s[N * C] (0 past Sk).
template <int N, int THREADS>
__device__ __forceinline__ void stage_bounds(int* s, const int* bnd, int C, int k0, int Sk) {
  for (int i = threadIdx.x; i < N * C; i += THREADS) {
    const int r = i / C;
    s[i] = (k0 + r < Sk) ? bnd[static_cast<size_t>(k0 + r) * C + i % C] : 0;
  }
}

}  // namespace flash
}  // namespace ptt
