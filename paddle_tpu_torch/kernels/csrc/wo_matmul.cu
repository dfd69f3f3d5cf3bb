// Weight-only int8 matmul (kernel 20): out = (x @ w8) * scale, x [M, K] in T
// (bf16, fp16 or fp32), w8 [K, N] int8 with one fp32 scale per output column,
// fp32 accumulation, out [M, N] in T. Every operand is read in place in that
// layout: no repacked copy of the weight exists.
//
// Replaces: paddle_tpu/kernels/quant.py `_wo_matmul_kernel` (launched by
// `_wo_matmul_pallas`, entry `int8_weight_matmul`), which the serving
// engine's weight-only int8 model reaches from every MLP projection and the
// lm head through `F.weight_only_linear`.
//
// Semantics kept from the Pallas kernel: the product runs over the int8
// values themselves with fp32 accumulation, and the scale row multiplies
// once, after the K walk (dequant factors out of the contraction, so this
// equals dequantizing the whole weight first, which never exists in device
// memory); the fp32 result is rounded once to T. Every int8 value is exact in
// bf16 and fp16, and a bf16 or fp16 product is exact in fp32, so a
// tensor-core product with fp32 accumulators computes JAX's x.f32 @ w8.f32 up
// to the order of the sums. x is never quantized.
//
// Two instances; the wrapper (kernels/quant.py `wo_route`: "wgmma" or
// "mma_sync") picks one from the dtype and the shape before the launch:
//
// - wgmma (bf16 and fp16 x, K % 8 == 0 and N % 16 == 0: the TMA maps'
//   16-byte row strides). Hopper's wgmma takes B only from shared memory and
//   both operands in one 16-bit type, so the kernel computes the transposed
//   tile out^T[n, m] = sum_k W^T[n, k] x^T[k, m]: A = W^T through REGISTERS,
//   B = x^T, which is K-major as x lies (wgmma RS with trans-b = 0).
//   The mainloop (csrc/wo_mainloop.cuh, shared with kernel 17's int8 site):
//   a persistent grid of 384 threads, a producer thread keeping the TMA
//   loads of the int8 W box [64 k][128 n] and the x box(es) in a ring, two
//   consumer warpgroups of 64 weight columns each that widen the int8
//   values to T in registers (exactly) as wgmma's A operand, one k16 step a
//   group, the next widened while it runs. The tile follows M: 8 x rows
//   for M <= 8 (decode), 64 for M <= 64, else 256-row tiles (wgmma n256:
//   each widened value feeds 256 products), the 256-row tiles past the last
//   full round over the SMs split into 128-row tiles where that shortens the
//   longest CTA's work (a 128-row tile costs ~0.62 of a 256-row one).
//   - Epilogue from registers: each accumulator row is one weight column, so
//     a thread multiplies by two scales, rounds to T and stores column pairs
//     (32-bit, full 32-byte sectors a warp); rows past M are dropped.
//   Plans at the serving shapes (M 512, 132 SMs): gate/up N 11008: 132
//   256-row tiles, then 80 128-row ones (one round each); down N 4096: 128
//   128-row tiles (0.97 of a round); lm head N 32000: 500 256-row tiles (3.8
//   rounds); eight rows: 86 8-row tiles, one round.
// - mma.sync (every shape and type the wgmma instance does not take: fp32 x,
//   and bf16 / fp16 x with K % 8 or N % 16 non-zero, e.g. an odd vocabulary
//   such as 32003 in the lm head; any M, K and N, any row alignment). TMA
//   cannot address such rows, so the operands come through cp.async: a CTA
//   of 8 warps owns a 128-column strip of W against BM x rows (128, or 64
//   where M fits), grid (row blocks, strips) with the row blocks of a strip
//   adjacent in launch order, so at M <= 128 (the ragged head's 77 rows)
//   every weight byte is read from device memory once. k stages of 64 flow
//   through a ring by cp.async: x rows are 2K or 4K and W
//   rows N bytes, so a row's slab starts at any 2- or 1-byte offset, and each
//   is copied as the 16-byte aligned chunks that hold it (zero past the
//   tensor), its offset recomputed from the low bits of its address when it
//   is read: x whole where its rows are 8-byte aligned, else as aligned words
//   funnel-shifted into place; W one byte of each of a thread's 4 k rows a
//   column. m16 tiles wholly past M are skipped. bf16 / fp16: mma.sync
//   m16n8k16, W widened exactly to x's type in registers. fp32: m16n8k8
//   TF32 in two passes, x = hi + lo (tf32.cuh split_hi: hi = rna_tf32(x),
//   lo = x - hi whole, whose top 19 bits the tensor core reads), lo w then
//   hi w, 2 x 4 warps (each x value is split by the 4 warps that read it,
//   not 8): the int8 values are exact in TF32, so the products miss the fp32
//   ones by at most ~2^-21 of |x w| (one pass would miss by 2^-11). The tensor cores' fp32 accumulation rounds toward zero, so
//   each k16 block's 4 mma go into a zeroed partial that one FADD a value
//   adds to the running sum: summed in the mma over all of K, the fp32
//   weight-only model's logits sat 16x further from an fp64 run than the
//   plain fp32 path's (5.1e-5 against 3.2e-6 relative L2 on an H100). The
//   epilogue scales, rounds once to T and stores elements.
//
// Bound on H100: at the serving shapes (M 512 rows of the [8, 64] step) 2 M
// = 1024 flops per weight byte, above the card's ~295 flop/byte ridge:
// operations (gate/up and down 4.62e10 flops, 0.0467 ms; the lm head 1.34e11,
// 0.1357 ms at 989 TFLOP/s). At eight rows it is bytes: 45.1 MB of int8
// weight, 0.0135 ms at 3.35 TB/s. fp32 at gate/up: two TF32 passes at 494.7
// TFLOP/s, 0.187 ms (0.690 ms at fp32's 67 TFLOP/s on the CUDA cores). The
// ragged bf16 head [77, 4100] x [4100, 32003]: bytes, 131 MB of int8 weight,
// 0.0409 ms.
//
// Not done yet: the widening does not overlap the tensor cores well; down
// (128 tiles of 128 rows, one round) would take 256-row tiles split in K
// over a cluster; the mma.sync instance reads W a byte at a time from shared
// memory and at M <= 64 its 64-row tiles compute unused rows.
#include "tf32.cuh"
#include "wo_mainloop.cuh"

using ptt::bf16;
using ptt::f16;
namespace hp = ptt::hopper;
namespace wo = ptt::wo;

namespace {

// kernel 20's epilogue from registers: each accumulator row is one weight
// column, so a thread multiplies by two scales, rounds to T and stores
// column pairs (32-bit, full 32-byte sectors a warp); rows past M are
// dropped. Row gid is column n_lo, row gid + 8 column n_lo + 1 (N % 16 == 0:
// both or neither are real); column 8 j + 2 tig + e is x row m0 + 8 j +
// 2 tig + e.
template <typename T>
struct wo_matmul_epilogue {
  static constexpr int kBytesPerRow = 0;
  const float* scale;
  T* out;
  int M, N;
  template <int NR>
  __device__ __forceinline__ void apply(float (&acc)[NR / 2], const wo::Item& it, int wg, int wl, int lane,
                                        unsigned char*) const {
    const int gid = lane >> 2, tig = lane & 3;
    const int n_lo = it.n0 + 64 * wg + 16 * wl + 2 * gid;
    if (n_lo >= N) return;
    const float2 sc = *reinterpret_cast<const float2*>(scale + n_lo);
#pragma unroll
    for (int j = 0; j < NR / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = it.m0 + 8 * j + 2 * tig + e;
        if (m < M)
          *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(m) * N + n_lo) =
              hp::pack2<T>(acc[4 * j + e] * sc.x, acc[4 * j + 2 + e] * sc.y);
      }
    }
  }
};

template <typename T, int BM>
__global__ void __launch_bounds__(wo::kThreads, 1)
wo_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
                       const float* __restrict__ scale, T* __restrict__ out, int M, int K, int N, wo::Plan plan) {
  wo::run<T, BM>(&tm_x, &tm_w, K, plan, wo_matmul_epilogue<T>{scale, out, M, N});
}

template <typename T, int BM>
int launch_wgmma(const void* x, const void* w8, const void* scale, void* out, int M, int K, int N,
                 const wo::Plan& plan, cudaStream_t stream) {
  CUtensorMap tx, tw;
  int err = wo::map_operands<T, BM>(&tx, &tw, x, w8, M, K, N);
  if (err) return err;
  constexpr int kSmem = wo::smem_bytes<BM, wo_matmul_epilogue<T>>();
  static_assert(kSmem <= 227 * 1024, "a block's shared memory");
  auto kernel = wo_matmul_wgmma_kernel<T, BM>;
  err = wo::prepare(kernel, kSmem);
  if (err) return err;
  kernel<<<plan.grid, wo::kThreads, kSmem, stream>>>(tx, tw, static_cast<const float*>(scale), static_cast<T*>(out),
                                                      M, K, N, plan);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_wgmma(const void* x, const void* w8, const void* scale, void* out, int M, int K, int N,
                   cudaStream_t stream) {
  int sms = 0;
  const int err = hp::sm_count(&sms);
  if (err) return err;
  const wo::Plan plan = wo::make_plan(M, N, sms);
  switch (plan.bm) {
    case 8: return launch_wgmma<T, 8>(x, w8, scale, out, M, K, N, plan, stream);
    case 64: return launch_wgmma<T, 64>(x, w8, scale, out, M, K, N, plan, stream);
    case 128: return launch_wgmma<T, 128>(x, w8, scale, out, M, K, N, plan, stream);
    default: return launch_wgmma<T, 256>(x, w8, scale, out, M, K, N, plan, stream);
  }
}

// -- the mma.sync instance --------------------------------------------------

namespace mm {

constexpr int kThreads = 256;       // 8 warps
constexpr int kBN = 128;         // weight columns a tile
constexpr int kRowW = kBN + 16;  // a W row of a stage: 128 columns from any byte offset (9 chunks of 16)

// BM x rows a tile: warps 2 x 4 (BM 128, and fp32, which splits each x value in every warp that reads
// it: 4, not 8) or 1 x 8 (bf16 / fp16 BM 64), each MT m16 x NT n8 tiles. k stages of 64 through a
// ring of kStages: each stage's barrier and walk cost more than its bytes, so 64 beat 32 on an H100,
// and the ring's depth did not matter (3, 4, 6 stages alike); fp32 takes 2, as 3 of its larger stages
// would leave one CTA an SM. An x row of a stage: kBK elements from any offset (2-byte aligned bf16 /
// fp16 rows of odd K, 4-byte fp32 rows)
template <typename T, int BM>
struct Geo {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kBK = 64, kStages = kF32 ? 2 : 3;
  static constexpr int kWM = (BM == 128 || kF32) ? 2 : 1, kWN = 8 / kWM;
  static constexpr int kMT = BM / kWM / 16, kNT = kBN / kWN / 8;
  static constexpr int kRowX = kBK * static_cast<int>(sizeof(T)) + 16;
  static constexpr int kXBytes = BM * kRowX, kStageBytes = kXBytes + kBK * kRowW;
  static constexpr int kSmem = kStages * kStageBytes;
};

template <typename T>
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, f16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// w holds one weight column's int8 values at k, k+1, k+2, k+3 (k in the low
// byte); b0 gets (k, k+1), b1 (k+2, k+3) widened to T, the lower k in the
// low half (wo_mainloop.cuh `widen_pairs`' exact forms, other bytes)
template <typename T>
__device__ __forceinline__ void widen4(uint32_t w, uint32_t& b0, uint32_t& b1) {
  if constexpr (std::is_same<T, f16>::value) {
    w ^= 0x80808080u;
    b0 = wo::hsub2(__byte_perm(w, 0x64646464u, 0x4140), 0x64806480u);
    b1 = wo::hsub2(__byte_perm(w, 0x64646464u, 0x4342), 0x64806480u);
  } else {
    const uint32_t y0 = __byte_perm(w, 0x43434343u, 0x4140), y1 = __byte_perm(w, 0x43434343u, 0x4342);
    b0 = wo::bsub2(y0 & 0xFF7FFF7Fu, y0 & 0xFF80FF80u);
    b1 = wo::bsub2(y1 & 0xFF7FFF7Fu, y1 & 0xFF80FF80u);
  }
}

__device__ __forceinline__ void cp_async16(unsigned char* dst, const unsigned char* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(hp::smem_u32(dst)), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Chunk j of the 16-byte aligned chunks that hold a row whose first byte lies
// `at` bytes from the (16-byte aligned) base: it starts at (at & ~15) + 16 j;
// bytes past `total` (the tensor's end; 0 for a row past M or K) are zero
__device__ __forceinline__ void chunk_copy(unsigned char* dst, const unsigned char* base, long long at, int j,
                                           long long total) {
  const long long c = (at & ~15ll) + 16ll * j;
  const long long left = total - c;
  const int bytes = left <= 0 ? 0 : (left >= 16 ? 16 : static_cast<int>(left));
  cp_async16(dst, bytes ? base + c : base, bytes);
}

// Stage k0's slabs into `st` by cp.async, every row as the aligned 16-byte
// chunks that hold it: x rows [m0, min(m0 + BM, M)) from element k0 (kBK
// elements), W rows [k0, k0 + kBK) from column n0 (128 bytes), each from its
// own byte offset (row_offset) into the stage's row. W rows past K are zero;
// x rows past M are not copied (zero_tail zeroed them once).
template <typename T, int BM>
__device__ __forceinline__ void load_stage(unsigned char* st, const T* x, const int8_t* w8, int M, int K, int N,
                                           int m0, int n0, int k0) {
  using G = Geo<T, BM>;
  constexpr int kXC = G::kRowX / 16, kWC = kRowW / 16;
  const auto* xb = reinterpret_cast<const unsigned char*>(x);
  const auto* wb = reinterpret_cast<const unsigned char*>(w8);
  const long long x_total = static_cast<long long>(M) * K * static_cast<long long>(sizeof(T));
  const int rows = min(BM, M - m0);  // rows past M stay as zero_tail left them
  for (int c = threadIdx.x; c < rows * kXC; c += kThreads) {
    const int r = c / kXC, j = c % kXC;
    const long long at = (static_cast<long long>(m0 + r) * K + k0) * static_cast<long long>(sizeof(T));
    chunk_copy(st + r * G::kRowX + 16 * j, xb, at, j, x_total);
  }
  unsigned char* ws = st + G::kXBytes;
  const long long w_total = static_cast<long long>(K) * N;
  for (int c = threadIdx.x; c < G::kBK * kWC; c += kThreads) {
    const int r = c / kWC, j = c % kWC, k = k0 + r;
    chunk_copy(ws + r * kRowW + 16 * j, wb, static_cast<long long>(k) * N + n0, j, k < K ? w_total : 0);
  }
}

// x rows [M - m0, BM) of every stage zeroed, once
// before the first copy: nothing writes them, and the m16 tiles that hold
// both real rows and these read them
template <typename T, int BM>
__device__ __forceinline__ void zero_tail(unsigned char* smem, int M, int m0) {
  using G = Geo<T, BM>;
  const int rows = min(BM, M - m0);
  if (rows == BM) return;
  constexpr int kWords = G::kRowX / 4;
  const int per = (BM - rows) * kWords;
  for (int i = threadIdx.x; i < G::kStages * per; i += kThreads) {
    const int s = i / per, rest = i % per;
    *reinterpret_cast<uint32_t*>(smem + s * G::kStageBytes + (rows + rest / kWords) * G::kRowX + 4 * (rest % kWords)) =
        0u;
  }
}

// the byte offset of a row's first byte within its staged chunks (the low 4
// bits of its address from the 16-byte aligned base; 32-bit arithmetic keeps them)
__device__ __forceinline__ int row_offset(int row, int row_bytes, int first_byte) {
  return static_cast<int>((static_cast<uint32_t>(row) * static_cast<uint32_t>(row_bytes) +
                           static_cast<uint32_t>(first_byte)) & 15u);
}

// kS-byte elements k 4t..4t+3 of an x row as kS words, its first at byte
// `p`: 8-byte loads (XA 8: x rows 8-byte aligned, so the row's offset is 0
// or 8), four words (fp32 otherwise), or three aligned words funnel-shifted
// by 0 or 16 bits (2-byte aligned bf16 / fp16 rows)
template <int kS, int XA>
__device__ __forceinline__ void load_x(uint32_t (&v)[kS], const unsigned char* p) {
  if constexpr (XA == 8) {
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    v[0] = a.x, v[1] = a.y;
    if constexpr (kS == 4) {
      const uint2 b = *reinterpret_cast<const uint2*>(p + 8);
      v[2] = b.x, v[3] = b.y;
    }
  } else if constexpr (kS == 4) {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = *reinterpret_cast<const uint32_t*>(p + 4 * e);
  } else {
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    const auto* w = reinterpret_cast<const uint32_t*>(a & ~static_cast<uintptr_t>(3));
    const uint32_t sh = static_cast<uint32_t>(a & 3) * 8;
    v[0] = __funnelshift_r(w[0], w[1], sh);
    v[1] = __funnelshift_r(w[1], w[2], sh);
  }
}

// acc += one stage's products. Each 16-wide k step takes its k indices
// permuted so that a thread's four k of it are 4t..4t+3 of the step (t =
// lane % 4): 8 (bf16 / fp16) or 16 (fp32) bytes of an x row, read as
// aligned words and shifted into place where the row's offset is not, and
// one byte of each of 4 W rows a column. bf16 / fp16: m16n8k16, A (rows g,
// g + 8) k indices 2t, 2t+1 = k 4t, 4t+1 and 2t+8, 2t+9 = k 4t+2, 4t+3, the
// same in B (W widened exactly). fp32: two m16n8k8 steps, step s's k
// indices t, t + 4 = k 4t + 2s, 4t + 2s + 1; x = hi + lo (split_hi), the
// W values exact in TF32, lo w summed before hi w, each k16 block's products
// in a partial added to acc. x values past K (the last stage) are
// zeroed. XA: the alignment of x's rows (load_x). m16 tiles wholly past M
// are skipped.
template <typename T, int BM, int XA>
__device__ __forceinline__ void stage_products(float (&acc)[Geo<T, BM>::kMT][Geo<T, BM>::kNT][4],
                                               const unsigned char* st, int M, int m0, int n0, int k0, int K, int N,
                                               int wm, int wn, int g, int t) {
  using G = Geo<T, BM>;
  constexpr int kS = sizeof(T);
  const unsigned char* ws = st + G::kXBytes;
  const int kv = K - k0;  // the stage's k that are real (kBK or more: all)
  const int live = (M - m0 - wm * G::kMT * 16 + 15) / 16;  // the warp's m16 tiles that hold real rows
  // x rows g, g + 8 of m16 tile mt: this thread's 4 k of k16 block kk as kS words, k past K zeroed
  const auto x_rows = [&](uint32_t (&xv)[2][kS], int mt, int kk) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm * G::kMT * 16 + mt * 16 + g + 8 * h;
      // k0 kS is a multiple of 128 bytes: a row's offset is the same in every stage
      load_x<kS, XA>(xv[h], st + r * G::kRowX + row_offset(m0 + r, K * kS, 0) + kS * (16 * kk + 4 * t));
    }
    if (kv < G::kBK) {  // the last stage: k past K is whatever followed the row
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (16 * kk + 4 * t + e < kv) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if constexpr (kS == 4) {
            xv[h][e] = 0u;
          } else {
            xv[h][e >> 1] &= (e & 1) ? 0x0000FFFFu : 0xFFFF0000u;
          }
        }
      }
    }
  };
#pragma unroll
  for (int kk = 0; kk < G::kBK / 16; ++kk) {
    int wrow[4];  // this thread's 4 W rows of the block: 16 kk + 4 t + i, at their offsets
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 16 * kk + 4 * t + i;
      wrow[i] = r * kRowW + row_offset(k0 + r, N, n0);
    }
    if constexpr (kS == 4) {
      uint32_t bf[G::kNT][4];  // B: the 4 k of the lane's column of each tile as fp32 values (exact in TF32)
#pragma unroll
      for (int nt = 0; nt < G::kNT; ++nt) {
        const int col = wn * G::kNT * 8 + nt * 8 + g;
#pragma unroll
        for (int i = 0; i < 4; ++i) bf[nt][i] = ptt::tf32::int8_bits(ws[wrow[i] + col]);
      }
#pragma unroll
      for (int mt = 0; mt < G::kMT; ++mt) {
        if (mt >= live) break;
        uint32_t xv[2][4];
        x_rows(xv, mt, kk);
        uint32_t ah[2][4], al[2][4];  // a0..a3 of step s: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
#pragma unroll
        for (int s2 = 0; s2 < 2; ++s2)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            ptt::tf32::split_hi(__uint_as_float(xv[e & 1][2 * s2 + (e >> 1)]), ah[s2][e], al[s2][e]);
#pragma unroll
        for (int nt = 0; nt < G::kNT; ++nt) {
          // the block's 4 mma into a zeroed partial that one FADD a value adds to acc: the tensor core's
          // fp32 accumulation rounds toward zero, and over all of K its error grows with the mma count
          float p[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int s2 = 0; s2 < 2; ++s2) {
            ptt::tf32::mma(p, al[s2], bf[nt][2 * s2], bf[nt][2 * s2 + 1]);
            ptt::tf32::mma(p, ah[s2], bf[nt][2 * s2], bf[nt][2 * s2 + 1]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += p[e];
        }
      }
    } else {
      uint32_t bf[G::kNT][2];  // B as T pairs: the 4 k of the lane's column of each tile, widened exactly
#pragma unroll
      for (int nt = 0; nt < G::kNT; ++nt) {
        const int col = wn * G::kNT * 8 + nt * 8 + g;
        const uint32_t bw = static_cast<uint32_t>(ws[wrow[0] + col]) | (static_cast<uint32_t>(ws[wrow[1] + col]) << 8) |
                            (static_cast<uint32_t>(ws[wrow[2] + col]) << 16) |
                            (static_cast<uint32_t>(ws[wrow[3] + col]) << 24);
        widen4<T>(bw, bf[nt][0], bf[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < G::kMT; ++mt) {
        if (mt >= live) break;
        uint32_t xv[2][2];
        x_rows(xv, mt, kk);
        const uint32_t a[4] = {xv[0][0], xv[1][0], xv[0][1], xv[1][1]};
#pragma unroll
        for (int nt = 0; nt < G::kNT; ++nt) mma16<T>(acc[mt][nt], a, bf[nt][0], bf[nt][1]);
      }
    }
  }
}

// out[m0:m0+BM, n0:n0+128] = (x w8) * scale, rounded once to T. Grid
// (ceil(M / BM), ceil(N / 128)): the x row blocks of a weight strip are
// neighbours in launch order, so a strip is read from device memory once
// and M <= 128 (one row block) reads the whole weight once. Stages of k
// flow through a ring of kStages by cp.async.
template <typename T, int BM, int XA>
__global__ void __launch_bounds__(kThreads, 2)
wo_matmul_mma_kernel(const T* __restrict__ x, const int8_t* __restrict__ w8, const float* __restrict__ scale,
                     T* __restrict__ out, int M, int K, int N) {
  using G = Geo<T, BM>;
  extern __shared__ __align__(16) unsigned char mm_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, wm = warp / G::kWN, wn = warp % G::kWN;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * kBN;
  float acc[G::kMT][G::kNT][4];
#pragma unroll
  for (int i = 0; i < G::kMT; ++i)
#pragma unroll
    for (int j = 0; j < G::kNT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  const int nk = (K + G::kBK - 1) / G::kBK;
  zero_tail<T, BM>(mm_smem, M, m0);  // ordered before the copies' reads by the loop's first barrier
  const auto slot = [&](int k) { return mm_smem + (k % G::kStages) * G::kStageBytes; };
#pragma unroll
  for (int s = 0; s < G::kStages - 1; ++s) {
    if (s < nk) load_stage<T, BM>(slot(s), x, w8, M, K, N, m0, n0, s * G::kBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<G::kStages - 2>();
    __syncthreads();  // stage kt has landed everywhere; every warp is done with stage kt - 1
    const int nxt = kt + G::kStages - 1;
    if (nxt < nk) load_stage<T, BM>(slot(nxt), x, w8, M, K, N, m0, n0, nxt * G::kBK);
    cp_async_commit();
    stage_products<T, BM, XA>(acc, slot(kt), M, m0, n0, kt * G::kBK, K, N, wm, wn, g, t);
  }
  cp_async_wait<0>();
#pragma unroll
  for (int j = 0; j < G::kNT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + wn * G::kNT * 8 + j * 8 + 2 * t + e;
      if (n >= N) continue;
      const float s = scale[n];
#pragma unroll
      for (int i = 0; i < G::kMT; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + wm * G::kMT * 16 + i * 16 + g + 8 * h;
          if (m < M) out[static_cast<size_t>(m) * N + n] = ptt::from_f<T>(acc[i][j][2 * h + e] * s);
        }
      }
    }
  }
}

template <typename T, int BM, int XA>
int launch(const void* x, const void* w8, const void* scale, void* out, int M, int K, int N, cudaStream_t stream) {
  constexpr int kSmem = Geo<T, BM>::kSmem;
  static_assert(2 * (kSmem + 1024) <= 228 * 1024, "two CTAs an SM");
  auto kernel = wo_matmul_mma_kernel<T, BM, XA>;
  const int err = ptt::allow_smem(kernel, kSmem);
  if (err) return err;
  const dim3 grid((M + BM - 1) / BM, (N + kBN - 1) / kBN);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<grid, kThreads, kSmem, stream>>>(static_cast<const T*>(x), static_cast<const int8_t*>(w8),
                                            static_cast<const float*>(scale), static_cast<T*>(out), M, K, N);
  return static_cast<int>(cudaGetLastError());
}

// 64-row tiles where M fits one, else 128; x rows 8- or 2-byte aligned (x itself is 16-byte aligned)
template <typename T, int XA>
int dispatch_rows(const void* x, const void* w8, const void* scale, void* out, int M, int K, int N,
                  cudaStream_t stream) {
  return M <= 64 ? launch<T, 64, XA>(x, w8, scale, out, M, K, N, stream)
                 : launch<T, 128, XA>(x, w8, scale, out, M, K, N, stream);
}

template <typename T>
int dispatch(const void* x, const void* w8, const void* scale, void* out, int M, int K, int N, cudaStream_t stream) {
  return (static_cast<long long>(K) * sizeof(T)) % 8 == 0
             ? dispatch_rows<T, 8>(x, w8, scale, out, M, K, N, stream)
             : dispatch_rows<T, 0>(x, w8, scale, out, M, K, N, stream);
}

}  // namespace mm

}  // namespace

// io: ptt::kF32, kBF16 or kF16 (x and out); route 0 the wgmma instance (bf16
// or fp16, K % 8 == 0 and K > 0, N % 16 == 0; x, w8 and scale 16-byte
// aligned), 1 the mma.sync instance (any type of the three, any M, K, N).
// x [M, K], w8 [K, N] int8, scale [N] fp32, out [M, N], all contiguous.
// Returns cudaErrorInvalidValue for a type, route or shape the route does
// not take.
extern "C" int ptt_wo_matmul(int io, int route, const void* x, const void* w8, const void* scale, void* out, int M,
                             int K, int N, void* stream) {
  if (M < 0 || K < 0 || N < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 0) {
    if (K == 0 || K % 8 || N % 16) return static_cast<int>(cudaErrorInvalidValue);
    switch (io) {
      case ptt::kBF16: return dispatch_wgmma<bf16>(x, w8, scale, out, M, K, N, s);
      case ptt::kF16: return dispatch_wgmma<f16>(x, w8, scale, out, M, K, N, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (route != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (io) {
    case ptt::kF32: return mm::dispatch<float>(x, w8, scale, out, M, K, N, s);
    case ptt::kBF16: return mm::dispatch<bf16>(x, w8, scale, out, M, K, N, s);
    case ptt::kF16: return mm::dispatch<f16>(x, w8, scale, out, M, K, N, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
