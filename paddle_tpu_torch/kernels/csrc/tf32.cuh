// fp32 products on the TF32 tensor cores at fp32 accuracy: the operand
// split and the m16n8k8 mma that flash_fwd_tf32.cu and flash_bwd_tf32.cu
// (kernels 14, 15 and 16 in fp32, three passes) and wo_matmul.cu's mma.sync
// instance (kernel 20 in fp32, two passes) share. tests/test_torch_tf32_split.py
// mirrors the rounding on the bits and models the mma with its accumulation
// rounded toward zero, for the forward and the backward.
//
// A TF32 mma reads 19 bits of each fp32 register (sign, exponent, 10
// significand bits); the low 13 are ignored, so one TF32 product of fp32
// values misses by ~2^-11. x = hi + lo with hi = rna_tf32(x) (round to
// nearest, ties away, the rounding of cvt.rna.tf32.f32) and lo = rna_tf32(x -
// hi): hi is exactly what the tensor core reads, x - hi is exact in fp32,
// and hi + lo misses x by at most 2^-22 of it. The rounding is done on the
// bits with full-rate integer operations (add half of the dropped unit to
// the magnitude, clear the 13 bits), not with cvt.
#pragma once

#include <cstdint>

namespace ptt {
namespace tf32 {

__device__ __forceinline__ uint32_t rna(uint32_t bits) { return (bits + 0x1000u) & 0xFFFFE000u; }

// x = hi + lo, both TF32 values held as fp32 bit patterns
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna(__float_as_uint(x));
  lo = rna(__float_as_uint(x - __uint_as_float(hi)));
}

// x = hi + lo with lo = x - hi left whole (exact in fp32): the tensor core
// reads its top 19 bits, so lo counts within 2^-10 of itself, 2^-21 of x,
// for two fewer operations. The two-pass product of an exact TF32 operand
// (kernel 20's int8 weight) and the three-pass products of kernels 15 and 16
// take it; the three-pass q k^T and P V (kernel 14) round lo as `split` does.
__device__ __forceinline__ void split_hi(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna(__float_as_uint(x));
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a b, one m16n8k8 TF32 product (fp32 accumulators)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in three TF32 passes of split operands: the cross terms first, then hi hi
__device__ __forceinline__ void mma_3x(float (&d)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4], uint32_t bh0,
                                       uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma(d, al, bh0, bh1);
  mma(d, ah, bl0, bl1);
  mma(d, ah, bh0, bh1);
}

// the int8 value in byte b (as loaded, 0..255) as fp32 bits (exact in
// TF32): 2^23 + 128 + v built from the biased byte, less 2^23 + 128, in two
// full-rate operations
__device__ __forceinline__ uint32_t int8_bits(uint32_t b) {
  return __float_as_uint(__uint_as_float((b ^ 0x80u) | 0x4B000000u) - 8388736.0f);
}

}  // namespace tf32
}  // namespace ptt
