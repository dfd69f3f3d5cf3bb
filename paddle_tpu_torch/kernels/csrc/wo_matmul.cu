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
// Two instances; the wrapper (kernels/quant.py `wo_route`) picks one from
// the dtype and the shape before the launch:
//
// - wgmma (bf16 and fp16 x, K % 8 == 0 and N % 16 == 0: the TMA maps'
//   16-byte row strides). Hopper's wgmma takes B only from shared memory and
//   both operands in one 16-bit type, so the kernel computes the transposed
//   tile out^T[n, m] = sum_k W^T[n, k] x^T[k, m]: A = W^T through REGISTERS,
//   B = x^T, which is K-major as x lies (wgmma RS with trans-b = 0).
//   - A persistent grid (one CTA an SM, items i, i + grid, ... of a plan
//     made on the host) of 384 threads: a producer thread issues, per k step
//     of 64, the TMA loads of the int8 W box [64 k][128 n] and the x box(es)
//     [rows][64 k] (both 128-byte swizzled; TMA zero-fills past M, K and N)
//     into a ring of stages with full / empty mbarriers; its warpgroup hands
//     its registers to the consumers (setmaxnreg 232 / 40; ptxas: 168 at
//     launch, no spills).
//   - Two consumer warpgroups own 64 weight columns each (m64 of wgmma). A
//     warp reads a slab's int8 bytes with two ldmatrix.x4.trans (the box read
//     as 16-bit column pairs: each lane gets [c0@k, c1@k, c0@k+1, c1@k+1],
//     conflict-free under the swizzle) and widens them to T in registers,
//     exactly (fp16: 0x6400 | (v ^ 0x80), less 1152; bf16: 0x4300 |
//     (v & 0x7F) less 0x4300 | (v & 0x80), i.e. 128 + l - 128 (1 + s), in
//     bf16x2). The fragment rows are permuted within each warp's 16 columns
//     (row i < 8 is column 2 i, row i + 8 column 2 i + 1), so a thread's two
//     rows are adjacent columns and the epilogue writes them as one 32-bit
//     pair. Each k16 step is one wgmma group; the next step is widened while
//     it runs, at most 4 in flight (wait<3>), as CUTLASS's mixed-input
//     mainloop does. Widening costs ALU time that does not hide under the
//     tensor cores, so its cost per product is what the tile shape below
//     trades on, and the mainloop does no other integer work it can avoid:
//     ring positions advance by increments (a stage count of 5 would cost
//     a division a slab).
//   - The tile follows M (`make_plan`): 8 x rows for M <= 8 (decode), 64 for
//     M <= 64, else 256-row tiles (wgmma n256, two 128-row x boxes: each
//     widened value feeds 256 products), with the 256-row tiles past the
//     last full round over the SMs split into 128-row tiles where that
//     shortens the longest CTA's work (a 128-row tile costs ~0.62 of a
//     256-row one). A plan left with no 256-row tile runs the 128-row
//     instance, whose ring is deeper. Rings: 16 stages of 9 KB (8 rows), 8
//     of 16 KB (64), 8 of 24 KB (128: 197,760 bytes of shared memory with
//     the barriers), 5 of 40 KB (256: 205,904 bytes).
//   - Epilogue from registers: each accumulator row is one weight column, so
//     a thread multiplies by two scales, rounds to T and stores column pairs
//     (32-bit, full 32-byte sectors a warp); rows past M are dropped.
//   Plans at the serving shapes (M 512, 132 SMs): gate/up N 11008: 132
//   256-row tiles, then 80 128-row ones (one round each); down N 4096: 128
//   128-row tiles (0.97 of a round); lm head N 32000: 500 256-row tiles (3.8
//   rounds); eight rows: 86 8-row tiles, one round.
// - CUDA cores (fp32 x, and any K or N the TMA maps cannot address, in any
//   of the three types): simt_gemm.cuh's fp32 mainloop (128 x 128 output
//   tiles of 256 threads, k tiles of 16 summed apart; shared with the loss
//   head's fp32 products, flxent_fp32.cu), x and w8 widened to fp32 as they
//   are staged. No TF32: it would round x. Any M, K and N.
//
// Bound on H100: at the serving shapes (M 512 rows of the [8, 64] step) 2 M
// = 1024 flops per weight byte, above the card's ~295 flop/byte ridge:
// operations (gate/up and down 4.62e10 flops, 0.0467 ms; the lm head 1.34e11,
// 0.1357 ms at 989 TFLOP/s). At eight rows it is bytes: 45.1 MB of int8
// weight, 0.0135 ms at 3.35 TB/s. fp32 on the CUDA cores: 0.690 ms at
// gate/up at 67 TFLOP/s.
//
// Not done yet: the widening does not overlap the tensor cores well; down
// (128 tiles of 128 rows, one round) would take 256-row tiles split in K
// over a cluster; the CUDA-core instance is a plain SIMT tile.
#include "hopper.cuh"
#include "simt_gemm.cuh"

using ptt::bf16;
using ptt::f16;
namespace hp = ptt::hopper;

namespace {

constexpr int kBN = 128;                    // weight columns per CTA tile (64 per consumer warpgroup)
constexpr int kBK = 64;                     // k per ring stage (one 128-byte row of x)
constexpr int kConsumers = 256;             // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup (one thread of it works)
constexpr int kConsumerWarps = kConsumers / 32;
// Registers a thread: the launch gives each of the 384 threads 168;
// setmaxnreg moves them from the producer warpgroup to the consumers.
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = (168 * kThreads - kConsumers * kConsumerRegs) / 128;
static_assert(kProducerRegs >= 24 && kProducerRegs % 8 == 0, "setmaxnreg takes 24..256 in steps of 8");

// The ring's layout for x tiles of up to BM rows, from a 1024-byte-aligned
// base: W boxes, x slots (BM rows, as TMA boxes of kBoxRows), then the full
// and empty barriers.
template <int BM>
struct Wo {
  static constexpr int kBoxRows = BM == 256 ? 128 : BM;  // a TMA box has at most 256 rows; 256 comes as two
  static constexpr int kWBytes = kBK * kBN;               // int8 [64 k][128 n]
  static constexpr int kXBytes = BM * kBK * 2;
  static constexpr int kStages = BM <= 8 ? 16 : BM <= 128 ? 8 : 5;
  static constexpr int kW = 0;
  static constexpr int kX = kW + kStages * kWBytes;
  static constexpr int kBar = kX + kStages * kXBytes;
  static constexpr int kBytes = kBar + 2 * kStages * 8 + 1024;  // + alignment slack
  static_assert(kBytes <= 227 * 1024, "a block's shared memory");
  static_assert(kWBytes % 1024 == 0 && kBoxRows * 128 % 1024 == 0, "swizzle atoms start on 1024-byte boundaries");
};

// The work items of one call, in launch order. Rows are cut into blocks of
// BM (the 256-row instance: pairs of 128-row blocks). Items [0, big) are
// BM-row tiles: row block i % blocks, column tile i / blocks (the x rows run
// fastest, so the CTAs in flight share a weight slab in L2). With BM 256
// the rest are 128-row tiles: both halves of each 256-row tile from `big`
// on, in the same order, then the odd last 128-row block's, one a column
// tile. A persistent CTA b takes items b, b + grid, ...
struct Plan {
  int bm;      // rows of a big item: 8, 64, 128 or 256
  int blocks;  // bm-row blocks (256: whole pairs of 128-row blocks)
  int nt;      // 128-column tiles
  int big;     // bm-row items
  int items;   // all items
  int grid;    // CTAs
};

struct Item {
  int m0, n0;
  bool big;
};

__device__ __forceinline__ Item item_at(const Plan& p, int i) {
  if (i < p.big) return Item{(i % p.blocks) * p.bm, (i / p.blocks) * kBN, true};
  const int s = i - p.big, split = 2 * (p.blocks * p.nt - p.big);
  if (s < split) {
    const int q = p.big + s / 2;
    return Item{(q % p.blocks) * p.bm + (s & 1) * (p.bm / 2), (q / p.blocks) * kBN, false};
  }
  return Item{p.blocks * p.bm, (s - split) * kBN, false};  // the odd last 128-row block
}

// The costs of a 256-row and a 128-row tile, relative (an H100 at the
// serving shapes: a 128-row tile takes ~0.63 of a 256-row one, since each
// widened weight value feeds half the products).
constexpr int kCost256 = 8, kCost128 = 5;

// The plan of an [M, K] x [K, N] call on `sms` SMs with BM-row tiles,
// every tile of BM rows.
inline Plan uniform_plan(int M, int N, int bm, int sms) {
  Plan p;
  p.bm = bm;
  p.nt = (N + kBN - 1) / kBN;
  p.blocks = (M + bm - 1) / bm;
  p.big = p.items = p.blocks * p.nt;
  p.grid = p.items < sms ? p.items : sms;
  return p;
}

// The plan of an [M, K] x [K, N] call on `sms` SMs (kernels/quant.py
// `wo_plan` mirrors it): 8-row tiles at decode sizes, 64 up to 64 rows.
// Above, 256-row tiles (each widened weight value feeds twice the products
// of a 128-row one), with those past the last full round over the SMs split
// into 128-row tiles where that shortens the longest CTA's work, and an odd
// last 128-row block; a plan left with no 256-row tile runs the 128-row
// instance (its ring is deeper).
inline Plan make_plan(int M, int N, int sms) {
  if (M <= 8) return uniform_plan(M, N, 8, sms);
  if (M <= 64) return uniform_plan(M, N, 64, sms);
  Plan p;
  p.bm = 256;
  p.nt = (N + kBN - 1) / kBN;
  const int halves = (M + 127) / 128;
  p.blocks = halves / 2;
  const int whole = p.blocks * p.nt, odd = (halves & 1) * p.nt;
  // every 256-row tile whole, or those past the last full round split
  const int grid_all = whole + odd < sms ? whole + odd : sms;
  const int keep = whole - whole % sms;
  const int items_split = keep + 2 * (whole - keep) + odd;
  const int grid_split = items_split < sms ? items_split : sms;
  if (keep < whole && hp::plan_makespan(keep, items_split, grid_split, kCost256, kCost128) <
                          hp::plan_makespan(whole, whole + odd, grid_all, kCost256, kCost128)) {
    p.big = keep, p.items = items_split, p.grid = grid_split;
  } else {
    p.big = whole, p.items = whole + odd, p.grid = grid_all;
  }
  return p.big ? p : uniform_plan(M, N, 128, sms);
}

// sub.rn.f16x2 / sub.rn.bf16x2: a - b in both halves
__device__ __forceinline__ uint32_t hsub2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.f16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t bsub2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// t holds the int8 values of two weight columns c0, c1 at two adjacent k,
// bytes [c0@k, c1@k, c0@k+1, c1@k+1]. r0 / r1 get column c0's / c1's
// (k, k+1) pair widened to T, k in the low half: the A-fragment register of
// the row each column stands for. Both forms are exact.
template <typename T>
__device__ __forceinline__ void widen_pairs(uint32_t t, uint32_t& r0, uint32_t& r1) {
  if constexpr (std::is_same<T, f16>::value) {
    // u = v ^ 0x80 = v + 128; fp16 0x64uu is 1024 + u, less 1152 (0x6480) v
    t ^= 0x80808080u;
    r0 = hsub2(__byte_perm(t, 0x64646464u, 0x4240), 0x64806480u);
    r1 = hsub2(__byte_perm(t, 0x64646464u, 0x4341), 0x64806480u);
  } else {
    // byte b = v mod 256, l = b & 0x7F, s = b >> 7 (v = l - 128 s): bf16
    // 0x43 | l is 128 + l and 0x43 | (b & 0x80) is 128 (1 + s), so their
    // difference is v
    const uint32_t y0 = __byte_perm(t, 0x43434343u, 0x4240), y1 = __byte_perm(t, 0x43434343u, 0x4341);
    r0 = bsub2(y0 & 0xFF7FFF7Fu, y0 & 0xFF80FF80u);
    r1 = bsub2(y1 & 0xFF7FFF7Fu, y1 & 0xFF80FF80u);
  }
}

// A slot's W box read for the A fragments of its four k16 steps. Row k of
// the box is 128 bytes at w + 128 k, its 16-byte chunk c at c ^ (k % 8).
// ldmatrix.trans over the box read as 16-bit pairs of columns hands each lane
// (gid, tig) of an 8 x 8 matrix rows 2 tig and 2 tig + 1 of pair gid: bytes
// [c0@k, c1@k, c0@k+1, c1@k+1] for columns c0 = 2 gid, c1 = 2 gid + 1 of the
// warp's chunk, which is what widen_pairs takes. Matrix i of the x4 load p is
// k rows 32 p + 8 i..+7: w[p][i] is k16 step 2 p + i / 2, half i % 2.
// `off` is this lane's row address in load 0 (row k = lane, swizzled chunk).
__device__ __forceinline__ void load_slab(uint32_t (&w)[2][4], const unsigned char* box, int off) {
  hp::ldsm_x4_trans(w[0], box + off);
  hp::ldsm_x4_trans(w[1], box + 32 * 128 + off);
}

// k16 step kk's A fragment from a slab's ldmatrix words
template <typename T>
__device__ __forceinline__ void widen_step(uint32_t (&a)[4], const uint32_t (&w)[2][4], int kk) {
  widen_pairs<T>(w[kk >> 1][2 * (kk & 1)], a[0], a[1]);
  widen_pairs<T>(w[kk >> 1][2 * (kk & 1) + 1], a[2], a[3]);
}

// A slab's ring stage and the parity of its pass over the ring: advanced
// by increments, since a stage count that is no power of two would cost an
// integer division a slab
struct RingPos {
  uint32_t stage, phase;
};

template <typename T, int N>
__device__ __forceinline__ void mma_step(float (&acc)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  hp::wgmma_fence();
  hp::wgmma_rs_k<T, N>(acc, a, db, 1);
  hp::wgmma_commit();
}

// One consumer thread's walk over an item's k steps: acc (m64 x N, this
// warpgroup's 64 weight columns by N x rows) += W^T x^T. One k16 step a
// group: the step after the one in flight is widened while it runs, and at
// most 4 groups are in flight, so the fragment a widening writes was read by
// a group that wait<3> has retired. `pos` is the ring position of the
// item's first slab, and on return that of the next item's.
template <typename T, int N, typename Ring>
__device__ __forceinline__ void mainloop(float (&acc)[N / 2], const Ring& ring, RingPos& pos, int nk, int off) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  uint32_t a[4][4], w[2][4];
  RingPos cur = pos, prev = pos;
  ring.wait_full(cur);
  load_slab(w, ring.w_box(cur), off);
  widen_step<T>(a[0], w, 0);
  for (int j = 0; j < nk; ++j) {
    const RingPos nxt = ring.next(cur);
    const uint64_t db = hp::desc_sw128(ring.x_slot(cur), 16, 1024);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      mma_step<T, N>(acc, a[kk], db + 2 * kk);  // + 32 bytes a k16 step
      hp::wgmma_wait<3>();
      if (kk < 3) {
        widen_step<T>(a[kk + 1], w, kk + 1);
      } else {
        if (j > 0) ring.release(prev);  // its four groups have retired
        if (j + 1 < nk) {
          ring.wait_full(nxt);
          load_slab(w, ring.w_box(nxt), off);
          widen_step<T>(a[0], w, 0);
        }
      }
    }
    prev = cur;
    cur = nxt;
  }
  hp::wgmma_wait<0>();
  ring.release(prev);
  hp::fence_regs(acc);
  pos = cur;
}

// out[m0 + m, n] for this thread's accumulators: row gid is column n_lo, row
// gid + 8 column n_lo + 1 (N % 16 == 0: both or neither are real); column
// 8 j + 2 tig + e is x row m0 + 8 j + 2 tig + e; rows past M are dropped
template <typename T, int NR>
__device__ __forceinline__ void epilogue(const float (&acc)[NR / 2], const float* __restrict__ scale,
                                         T* __restrict__ out, int m0, int n_lo, int M, int N, int tig) {
  if (n_lo >= N) return;
  const float2 sc = *reinterpret_cast<const float2*>(scale + n_lo);
#pragma unroll
  for (int j = 0; j < NR / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + 8 * j + 2 * tig + e;
      if (m < M)
        *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(m) * N + n_lo) =
            hp::pack2<T>(acc[4 * j + e] * sc.x, acc[4 * j + 2 + e] * sc.y);
    }
  }
}

// A consumer's view of the ring (full / empty barriers, W boxes, x slots),
// addressed by ring positions
template <int BM>
struct Ring {
  using L = Wo<BM>;
  static constexpr int S = L::kStages;
  unsigned char* sm;
  uint64_t* full;
  uint64_t* empty;
  int lane;
  __device__ __forceinline__ RingPos next(RingPos p) const {
    return p.stage + 1 == S ? RingPos{0, p.phase ^ 1} : RingPos{p.stage + 1, p.phase};
  }
  __device__ __forceinline__ const unsigned char* w_box(RingPos p) const { return sm + L::kW + p.stage * L::kWBytes; }
  __device__ __forceinline__ const unsigned char* x_slot(RingPos p) const { return sm + L::kX + p.stage * L::kXBytes; }
  __device__ __forceinline__ void wait_full(RingPos p) const { hp::mbar_wait(&full[p.stage], p.phase); }
  // this warp's reads of the slot (its loads, its warpgroup's wgmmas) are done
  __device__ __forceinline__ void release(RingPos p) const {
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(&empty[p.stage]);
  }
};

template <typename T, int BM>
__global__ void __launch_bounds__(kThreads, 1)
wo_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
                       const float* __restrict__ scale, T* __restrict__ out, int M, int K, int N, Plan plan) {
  using L = Wo<BM>;
  constexpr int S = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* empty = full + S;
  const int nk = (K + kBK - 1) / kBK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hp::mbar_init(&full[s], 1);                // the producer's arrival + the boxes' bytes
      hp::mbar_init(&empty[s], kConsumerWarps);  // one arrival per consumer warp
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    hp::reg_dealloc<kProducerRegs>();
    if (warp > kConsumerWarps || lane != 0) return;  // one thread issues every copy
    // ---- producer: per item, per k step, the W box and the x box(es) ----
    hp::tma_prefetch(&tm_x);
    hp::tma_prefetch(&tm_w);
    int s = 0;
    uint32_t phase = 0;  // the ring position of the next slab
    for (int i = blockIdx.x; i < plan.items; i += gridDim.x) {
      const Item it = item_at(plan, i);
      const int boxes = it.big ? BM / L::kBoxRows : 1;
      for (int ks = 0; ks < nk; ++ks) {
        hp::mbar_wait(&empty[s], phase ^ 1);  // the slot's last slab is consumed
        hp::mbar_arrive_expect_tx(&full[s], L::kWBytes + boxes * L::kBoxRows * kBK * 2);
        hp::tma_load_2d(sm + L::kW + s * L::kWBytes, &tm_w, &full[s], it.n0, ks * kBK);
        for (int b = 0; b < boxes; ++b)
          hp::tma_load_2d(sm + L::kX + s * L::kXBytes + b * L::kBoxRows * 128, &tm_x, &full[s], ks * kBK,
                          it.m0 + b * L::kBoxRows);
        if (++s == S) s = 0, phase ^= 1;
      }
    }
    return;
  }

  hp::reg_alloc<kConsumerRegs>();
  // ---- consumer warpgroups: 64 weight columns each ----
  const int wg = warp >> 2, wl = warp & 3, gid = lane >> 2, tig = lane & 3;
  const int chunk = 4 * wg + wl;  // the 16-byte chunk of a W row that holds this warp's 16 columns
  const int off = lane * 128 + ((chunk ^ (lane & 7)) << 4);
  const Ring<BM> ring{sm, full, empty, lane};
  RingPos pos{0, 0};  // the ring position of the next slab
  float acc[BM / 2];
  for (int i = blockIdx.x; i < plan.items; i += gridDim.x) {
    const Item it = item_at(plan, i);
    const int n_lo = it.n0 + 64 * wg + 16 * wl + 2 * gid;
    if constexpr (BM == 256) {
      if (!it.big) {  // a 128-row item: the first half of the accumulators
        float (&half)[64] = *reinterpret_cast<float(*)[64]>(&acc[0]);
        mainloop<T, 128>(half, ring, pos, nk, off);
        epilogue<T, 128>(half, scale, out, it.m0, n_lo, M, N, tig);
        continue;
      }
    }
    mainloop<T, BM>(acc, ring, pos, nk, off);
    epilogue<T, BM>(acc, scale, out, it.m0, n_lo, M, N, tig);
  }
}

template <typename T, int BM>
int launch_wgmma(const void* x, const void* w8, const void* scale, void* out, int M, int K, int N, const Plan& plan,
                 cudaStream_t stream) {
  using L = Wo<BM>;
  CUtensorMap tx, tw;
  int err = hp::encode_2d(&tx, hp::tma_dtype<T>(), x, M, K, 2LL * K, L::kBoxRows, kBK);
  if (!err) err = hp::encode_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, w8, K, N, N, kBK, kBN);
  if (err) return err;
  auto kernel = wo_matmul_wgmma_kernel<T, BM>;
  err = ptt::allow_smem(kernel, L::kBytes);
  if (!err) err = hp::check_reg_split(kernel, kThreads, kConsumers * kConsumerRegs + 128 * kProducerRegs);
  if (err) return err;
  kernel<<<plan.grid, kThreads, L::kBytes, stream>>>(tx, tw, static_cast<const float*>(scale), static_cast<T*>(out),
                                                      M, K, N, plan);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_wgmma(const void* x, const void* w8, const void* scale, void* out, int M, int K, int N,
                   cudaStream_t stream) {
  int sms = 0;
  const int err = hp::sm_count(&sms);
  if (err) return err;
  const Plan plan = make_plan(M, N, sms);
  switch (plan.bm) {
    case 8: return launch_wgmma<T, 8>(x, w8, scale, out, M, K, N, plan, stream);
    case 64: return launch_wgmma<T, 64>(x, w8, scale, out, M, K, N, plan, stream);
    case 128: return launch_wgmma<T, 128>(x, w8, scale, out, M, K, N, plan, stream);
    default: return launch_wgmma<T, 256>(x, w8, scale, out, M, K, N, plan, stream);
  }
}

// -- the CUDA-core instance ---------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(ptt::simt::kThreads)
wo_matmul_cuda_core_kernel(const T* __restrict__ x, const int8_t* __restrict__ w8, const float* __restrict__ scale,
                           T* __restrict__ out, int M, int K, int N) {
  using ptt::simt::sub;
  const int m0 = blockIdx.y * ptt::simt::kBM, n0 = blockIdx.x * ptt::simt::kBN;
  // A = x [M, K] (K-major), B = w8 [K, N] read as (n, k) (MN-major)
  const auto load_x = [&](int m, int k) { return ptt::to_f(x[static_cast<size_t>(m) * K + k]); };
  const auto load_w = [&](int n, int k) { return static_cast<float>(w8[static_cast<size_t>(k) * N + n]); };
  float acc[8][8];
  ptt::simt::tile_product<true, false>(acc, load_x, m0, M, load_w, n0, N, K);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + sub(tx, j);
    if (n >= N) continue;
    const float s = scale[n];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + sub(ty, i);
      if (m < M) out[static_cast<size_t>(m) * N + n] = ptt::from_f<T>(acc[i][j] * s);
    }
  }
}

template <typename T>
int launch_cuda_cores(const void* x, const void* w8, const void* scale, void* out, int M, int K, int N,
                      cudaStream_t stream) {
  const dim3 grid((N + ptt::simt::kBN - 1) / ptt::simt::kBN, (M + ptt::simt::kBM - 1) / ptt::simt::kBM);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  wo_matmul_cuda_core_kernel<T><<<grid, ptt::simt::kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w8), static_cast<const float*>(scale), static_cast<T*>(out),
      M, K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// io: ptt::kF32, kBF16 or kF16 (x and out); route 0 the wgmma instance (bf16
// or fp16, K % 8 == 0 and K > 0, N % 16 == 0; x, w8 and scale 16-byte
// aligned), 1 the CUDA-core instance (any type of the three, any M, K, N).
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
    case ptt::kF32: return launch_cuda_cores<float>(x, w8, scale, out, M, K, N, s);
    case ptt::kBF16: return launch_cuda_cores<bf16>(x, w8, scale, out, M, K, N, s);
    case ptt::kF16: return launch_cuda_cores<f16>(x, w8, scale, out, M, K, N, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
