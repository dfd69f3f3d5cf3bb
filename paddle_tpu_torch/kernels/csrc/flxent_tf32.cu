// Fused linear cross entropy in fp32 on the TF32 tensor cores: kernel 17's
// partials, the D recompute that kernels 18 and 19 share, dX (kernel 18) and
// dW (kernel 19) for fp32 x and W, each product in three TF32 passes of split
// operands (3xTF32) on a warp-specialised wgmma mainloop fed by TMA; kernel
// 17's int8 site for fp32 x in two passes on the same mainloop; and the
// split and widen passes that lay the products' operands out for it.
//
// Replaces: the fp32 instances of paddle_tpu/kernels/fused_loss.py
// `_flxent_fwd_kernel` (:261), `_flxent_block_d` (:302), `_flxent_dx_kernel`
// (:322) and `_flxent_dw_kernel` (:343), launched by `_make_pallas_core`
// (:366): JAX runs its Pallas kernels in fp32 for an fp32 model whose hidden
// size is a multiple of 128 (the fp32 train step's loss head); and
// `_flxent_fwd_kernel` launched by `_make_pallas_quant_fwd` (:464) with fp32
// activations against the int8 W (the fp32 weight-only model's loss).
// kernels/fused_loss.py `flx_route` names this instance "tf32x3" (kernel 17
// and the backward alike) where the split pass reads W in 16-byte vectors
// (W 16-byte aligned, its rows a multiple of 4 floats), and `flx_int8_route`
// "tf32x2" where the widen pass takes the int8 W (16-byte aligned, rows a
// multiple of 16 bytes, H a multiple of 4); other fp32 shapes stay on the
// CUDA cores (flxent_fp32.cu).
//
// Per vocab sub-chunk of Vc columns (the wrapper walks them in order):
//   partials of x W_c (kernel 17; with an int8 W each logit times its
//   column's scale) into the [3, ceil(V / 128), N] scratch   (K = H)
//   D    = (exp(x W_c - lse) - onehot) * gcoef     [N, Vc]  (K = H)
//   dX  += D W_c^T (the first chunk overwrites)     [N, H]   (K = Vc)
//   dW_c = x^T D, or D^T x when vocab-major         (K = N)
//
// The arithmetic (tf32.cuh): every operand x is split once as hi =
// rna_tf32(x), lo = rna_tf32(x - hi) (`split`), and a b ~ a_lo b_hi + a_hi
// b_lo + a_hi b_hi. An int8 value is a TF32 value, so the int8 W is widened
// exactly and has no lo plane: x W ~ x_lo W + x_hi W, two passes. The tensor
// cores' fp32 accumulation rounds toward zero (flash_fwd_tf32.cu), so
// chained over a long K it drifts: each k block of 32 is summed into zeroed
// partials, the cross terms and hi hi each in their own, and each partial is
// added to the running sum with one FADD a value (to nearest).
// tests/test_torch_flxent_tf32.py and tests/test_torch_flxent_fwd_tf32.py
// model this on the CPU.
//
// Design. TF32 wgmma reads both operands from shared memory K-major only
// (it has no transpose for 4-byte types), and three of the six operands lie
// MN-major in device memory (D's and kernel 17's W_c for W [H, V], dX's W_c
// for a vocab-major W, both of dW's). So the split pass (`flxent_split_kernel`)
// writes each operand once into hi and lo planes laid out K-major: x (and
// x^T) once a forward or backward, W_c in the orientations a sub-chunk needs;
// D's epilogue writes D's planes and D^T's; the widen pass
// (`flxent_widen_kernel`) writes the int8 W_c^T's one plane. Every wgmma
// operand then arrives by TMA with no split and no transpose in the
// mainloop. The mainloop: one 128 x 128 output tile a CTA (tiles in groups
// of 8 row tiles for L2 reuse), a producer warp that keeps three stages of
// four [128][32] boxes (A hi, A lo, B hi, B lo; 64 KB a stage) in flight
// (two passes: four stages of three boxes), two consumer warpgroups of 64
// rows (m64n128k8), each with three 64-register sets: the cross-term
// partial, the hi hi partial and the running sum. Each partial's FADD runs
// while the other partial's wgmmas are on the tensor cores. The epilogues
// write from registers: kernel 17's per-row (max, sum of exp, target logit)
// of its 128-column tile (a row's 32 values a thread lie in the 4 lanes of a
// quad: two shuffles, no shared memory), written where the CUDA-core route
// writes them, for ptt_flxent_merge (flxent_fwd.cu); D's (exp in fp32) its
// planes and, for flxent_dchunk, D itself; dX adds the chunks before in
// place; dW stores. No atomics: two calls give the same bits, and a product
// runs only when asked for.
//
// Bound on H100: three TF32 passes (two for the int8 W) at 494.7 TFLOP/s,
// 6 N H Vc (4 N H Vc) flops a product; the split and widen passes are bound
// by their bytes (one fp32 or int8 value read, two or four fp32 values
// written, resp. one).
#include "common.cuh"
#include "hopper.cuh"
#include "tf32.cuh"

namespace hp = ptt::hopper;

namespace {

constexpr int kBM = 128;                    // tile rows (64 per consumer warpgroup)
constexpr int kBN = 128;                    // tile columns
constexpr int kBK = 32;                     // k per stage: one 128-byte row of fp32
constexpr int kConsumers = 256;             // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup (one thread of it works)
constexpr int kConsumerWarps = kConsumers / 32;
// Registers a thread: the launch gives each of the 384 threads 168;
// setmaxnreg moves them from the producer warpgroup to the consumers, whose
// three accumulator sets take 192.
constexpr int kConsumerRegs = 240;
constexpr int kProducerRegs = (168 * kThreads - kConsumers * kConsumerRegs) / 128;
static_assert(kProducerRegs >= 24 && kProducerRegs % 8 == 0, "setmaxnreg takes 24..256 in steps of 8");
constexpr int kBox = kBM * kBK * 4;         // one [128][32] fp32 box: 16 KB
constexpr int kGroup = 8;                   // row tiles per sweep of the column tiles
constexpr int kAcc = kBN / 2;               // accumulators a thread (m64n128)
constexpr float kNegInf = -1e30f;           // the Pallas kernels' NEG_INF: kernel 17's columns past V

// A stage: A hi, A lo, B hi and, in three passes, B lo. Two passes (B exact
// in TF32) free a box a stage, spent on a fourth stage.
template <int PASSES>
struct Geo {
  static_assert(PASSES == 2 || PASSES == 3, "two or three TF32 passes");
  static constexpr int kStages = PASSES == 3 ? 3 : 4;
  static constexpr int kStageBytes = (PASSES + 1) * kBox;
  static constexpr int kBar = kStages * kStageBytes;
  static constexpr int kSmemBytes = kBar + 2 * kStages * 8 + 1024;  // + alignment slack
  static_assert(kSmemBytes <= 227 * 1024, "a block's shared memory");
};

enum Product : int { kD = 0, kDx = 1, kDw = 2, kFwd = 3 };

// A plane pair: hi at p, lo at p + plane, rows `ld` floats apart
struct Planes {
  float* p;
  long long ld, plane;
};

struct Params {
  int M, N, K;         // output rows and columns, reduction extent
  int tiles_m, tiles_n;
  // D, kernel 17: per row the label; the sub-chunk's first vocab column
  const int* labels;
  int c0;
  // D: per row lse and gcoef; outputs (each may be null): D itself [M][ldd],
  // D's planes [M][.], D^T's [N][.]
  const float* lse;
  const float* gcoef;
  float* d;
  long long ldd;
  Planes dp, dtp;
  // dX, dW: the output [M][ldo]; dX after its first chunk adds what it holds
  float* out;
  long long ldo;
  int accumulate;
  // kernel 17: the sub-chunk's column scales (an int8 W; else null), the
  // partials [3][tiles][M] (`part_stride` = tiles M floats apart) and the
  // sub-chunk's first tile (c0 / 128)
  const float* wscale;
  float* part;
  long long part_stride;
  int tile0;
};

// The output tile of CTA t: groups of kGroup row tiles, column tiles across each
__device__ __forceinline__ void tile_of(const Params& p, int t, int& m0, int& n0) {
  const int per_group = kGroup * p.tiles_n;
  const int first = (t / per_group) * kGroup;
  const int size = p.tiles_m - first < kGroup ? p.tiles_m - first : kGroup;
  const int in = t % per_group;
  m0 = (first + in % size) * kBM;
  n0 = (in / size) * kBN;
}

__device__ __forceinline__ void store2(float* o, float v0, float v1, bool two) {
  if (two) {
    *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
  } else {
    o[0] = v0;
  }
}

__device__ __forceinline__ void store_split2(const Planes& pl, long long at, float v0, float v1, bool two) {
  uint32_t h0, l0, h1, l1;
  ptt::tf32::split(v0, h0, l0);
  ptt::tf32::split(v1, h1, l1);
  store2(pl.p + at, __uint_as_float(h0), __uint_as_float(h1), two);
  store2(pl.p + pl.plane + at, __uint_as_float(l0), __uint_as_float(l1), two);
}

// One warpgroup's 64 rows x 128 columns from registers: acc[4 j + e] is row
// m0 + 16 wl + gid + 8 (e >> 1), column n0 + 8 j + 2 tig + (e & 1).
template <int PROD>
__device__ __forceinline__ void epilogue(const float (&acc)[kAcc], const Params& p, int m0, int n0, int wl, int gid,
                                         int tig) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + 16 * wl + gid + 8 * h;
    if (row >= p.M) continue;
    float ls = 0.f, g = 0.f;
    int lab = -1;  // the label as a column of this chunk
    if constexpr (PROD == kD) ls = p.lse[row], g = p.gcoef[row], lab = p.labels[row] - p.c0;
#pragma unroll
    for (int j = 0; j < kAcc / 4; ++j) {
      const int col = n0 + 8 * j + 2 * tig;
      if (col >= p.N) continue;
      const bool two = col + 1 < p.N;
      float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if constexpr (PROD == kD) {
        v0 = (expf(v0 - ls) - (col == lab ? 1.f : 0.f)) * g;
        v1 = two ? (expf(v1 - ls) - (col + 1 == lab ? 1.f : 0.f)) * g : 0.f;
        if (p.d) store2(p.d + row * p.ldd + col, v0, v1, two);
        if (p.dp.p) store_split2(p.dp, row * p.dp.ld + col, v0, v1, two);
        if (p.dtp.p) {  // D^T [N][.]: column col's row, then col + 1's
          uint32_t hh, ll;
          float* t = p.dtp.p + static_cast<long long>(col) * p.dtp.ld + row;
          ptt::tf32::split(v0, hh, ll);
          t[0] = __uint_as_float(hh);
          t[p.dtp.plane] = __uint_as_float(ll);
          if (two) {
            ptt::tf32::split(v1, hh, ll);
            t[p.dtp.ld] = __uint_as_float(hh);
            t[p.dtp.ld + p.dtp.plane] = __uint_as_float(ll);
          }
        }
      } else {
        float* o = p.out + row * p.ldo + col;
        if (PROD == kDx && p.accumulate) {
          v0 += o[0];
          if (two) v1 += o[1];
        }
        store2(o, v0, v1, two);
      }
    }
  }
}

// Kernel 17's epilogue: per row of the warpgroup's 64 the tile's max, sum
// of exp over it and target logit, each logit first times its column's
// scale (an int8 W: `wscale` set) and NEG_INF past the sub-chunk's N
// columns, in the Pallas body's order. A row's 128 columns lie in the 4
// lanes of its quad, 32 a lane: two shuffles merge them. Written at
// part[q][tile0 + n0 / 128][row], where the CUDA-core route writes them.
__device__ __forceinline__ void fwd_epilogue(float (&acc)[kAcc], const Params& p, int m0, int n0, int wl, int gid,
                                             int tig) {
  const long long at0 = static_cast<long long>(p.tile0 + n0 / kBN) * p.M;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + 16 * wl + gid + 8 * h;
    const int lab = row < p.M ? p.labels[row] - p.c0 : -1;  // the label as a column of this sub-chunk
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kAcc / 4; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + 8 * j + 2 * tig + e;
        float& v = acc[4 * j + 2 * h + e];
        if (p.wscale != nullptr && col < p.N) v *= p.wscale[col];
        if (col >= p.N) v = kNegInf;
        mx = fmaxf(mx, v);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    float s = 0.f, t = 0.f;
#pragma unroll
    for (int j = 0; j < kAcc / 4; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + 8 * j + 2 * tig + e;
        const float v = acc[4 * j + 2 * h + e];
        s += expf(v - mx);
        if (col < p.N && col == lab) t += v;
      }
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    t += __shfl_xor_sync(0xffffffffu, t, 1);
    t += __shfl_xor_sync(0xffffffffu, t, 2);
    if (tig == 0 && row < p.M) {
      p.part[at0 + row] = mx;
      p.part[p.part_stride + at0 + row] = s;
      p.part[2 * p.part_stride + at0 + row] = t;
    }
  }
}

// C [M, N] = A [M, K] B [N, K]^T in PASSES TF32 passes, A as a hi / lo plane
// pair and B as one (three passes) or as its hi plane alone (two: B is exact
// in TF32), read through TMA maps (K-major, zero past every edge), with the
// epilogue PROD. Each __global__ below is this body under its own name.
template <int PROD, int PASSES>
__device__ __forceinline__ void tf32_tile(const CUtensorMap* ta_hi, const CUtensorMap* ta_lo,
                                          const CUtensorMap* tb_hi, const CUtensorMap* tb_lo, const Params& p) {
  using G = Geo<PASSES>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + G::kBar);
  uint64_t* empty = full + G::kStages;
  const int nk = (p.K + kBK - 1) / kBK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int m0, n0;
  tile_of(p, blockIdx.x, m0, n0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < G::kStages; ++s) {
      hp::mbar_init(&full[s], 1);                // the producer's arrival + the boxes' bytes
      hp::mbar_init(&empty[s], kConsumerWarps);  // one arrival per consumer warp
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    hp::reg_dealloc<kProducerRegs>();
    if (warp > kConsumerWarps || lane != 0) return;  // one thread issues every copy
    hp::tma_prefetch(ta_hi);
    hp::tma_prefetch(ta_lo);
    hp::tma_prefetch(tb_hi);
    if constexpr (PASSES == 3) hp::tma_prefetch(tb_lo);
    uint32_t s = 0, phase = 0;
    for (int ks = 0; ks < nk; ++ks) {
      const int k0 = ks * kBK;
      hp::mbar_wait(&empty[s], phase ^ 1);  // the slot's last stage is consumed
      hp::mbar_arrive_expect_tx(&full[s], G::kStageBytes);
      unsigned char* st = sm + s * G::kStageBytes;
      hp::tma_load_2d(st, ta_hi, &full[s], k0, m0);
      hp::tma_load_2d(st + kBox, ta_lo, &full[s], k0, m0);
      hp::tma_load_2d(st + 2 * kBox, tb_hi, &full[s], k0, n0);
      if constexpr (PASSES == 3) hp::tma_load_2d(st + 3 * kBox, tb_lo, &full[s], k0, n0);
      if (++s == G::kStages) s = 0, phase ^= 1;
    }
    return;
  }

  hp::reg_alloc<kConsumerRegs>();
  const int wg = warp >> 2, wl = warp & 3, gid = lane >> 2, tig = lane & 3;
  const uint32_t sm32 = hp::smem_u32(sm);
  float run[kAcc], pc[kAcc], ph[kAcc];  // the running sum; the cross-term and hi hi partials
#pragma unroll
  for (int i = 0; i < kAcc; ++i) run[i] = 0.f, ph[i] = 0.f;
  uint32_t stage = 0, phase = 0, prev = 0;
  // Per stage: the cross terms into pc (group 1); wait for the previous
  // stage's hi hi group, release that stage and add ph; the hi hi terms into
  // ph (group 2); wait for group 1 and add pc. So each FADD overlaps the
  // other partial's wgmmas, and the running sum takes pc, ph, pc, ph, ...
  // No C++ branch while wgmmas are in flight (hopper.cuh mbar_wait_loop):
  // waits and arrivals are single asm statements, and ph starts at 0.
  for (int ks = 0; ks < nk; ++ks) {
    hp::mbar_wait_loop(&full[stage], phase);
    const uint32_t base = sm32 + stage * G::kStageBytes;
    const uint64_t dah = hp::desc_sw128_at(base + wg * (kBox / 2), 16, 1024);
    const uint64_t dal = hp::desc_sw128_at(base + kBox + wg * (kBox / 2), 16, 1024);
    const uint64_t dbh = hp::desc_sw128_at(base + 2 * kBox, 16, 1024);
    const uint64_t dbl = PASSES == 3 ? hp::desc_sw128_at(base + 3 * kBox, 16, 1024) : 0;
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {  // a k8 step is 32 bytes: 2 in the descriptor's address field
      hp::wgmma_tf32_n128(pc, dal + 2 * kk, dbh + 2 * kk, kk);
      if constexpr (PASSES == 3) hp::wgmma_tf32_n128(pc, dah + 2 * kk, dbl + 2 * kk, 1);
    }
    hp::wgmma_commit();
    hp::wgmma_wait<1>();  // every group but this stage's cross terms has retired
    hp::mbar_arrive_if(&empty[prev], lane == 0 && ks > 0);
    hp::fence_regs(ph);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) run[i] += ph[i];
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) hp::wgmma_tf32_n128(ph, dah + 2 * kk, dbh + 2 * kk, kk);
    hp::wgmma_commit();
    hp::wgmma_wait<1>();  // this stage's cross terms have retired
    hp::fence_regs(pc);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) run[i] += pc[i];
    prev = stage;
    if (++stage == G::kStages) stage = 0, phase ^= 1;
  }
  hp::wgmma_wait<0>();
  hp::fence_regs(ph);
#pragma unroll
  for (int i = 0; i < kAcc; ++i) run[i] += ph[i];
  if constexpr (PROD == kFwd) {
    fwd_epilogue(run, p, m0 + 64 * wg, n0, wl, gid, tig);
  } else {
    epilogue<PROD>(run, p, m0 + 64 * wg, n0, wl, gid, tig);
  }
}

// The backward's products: D, dX, dW (three passes)
template <int PROD>
__global__ void __launch_bounds__(kThreads, 1)
flxent_tf32_kernel(const __grid_constant__ CUtensorMap ta_hi, const __grid_constant__ CUtensorMap ta_lo,
                   const __grid_constant__ CUtensorMap tb_hi, const __grid_constant__ CUtensorMap tb_lo,
                   const Params p) {
  tf32_tile<PROD, 3>(&ta_hi, &ta_lo, &tb_hi, &tb_lo, p);
}

// Kernel 17's partials (three passes against an fp32 W, two against the
// int8 W's widened plane): a name of its own, so the profiles count it with
// kernel 17 ("flxent_fwd"), apart from D / 18 / 19
template <int PASSES>
__global__ void __launch_bounds__(kThreads, 1)
flxent_fwd_tf32_kernel(const __grid_constant__ CUtensorMap ta_hi, const __grid_constant__ CUtensorMap ta_lo,
                       const __grid_constant__ CUtensorMap tb_hi, const __grid_constant__ CUtensorMap tb_lo,
                       const Params p) {
  tf32_tile<kFwd, PASSES>(&ta_hi, &ta_lo, &tb_hi, &tb_lo, p);
}

// The hi and lo planes of src [rows][cols] (`ld` floats a row; cols, ld
// multiples of 4 and src 16-byte aligned: float4 loads): into `same`
// [rows][.] and / or `trans` [cols][.], the latter through a 32 x 32 tile in
// shared memory, its rows padded with zeros up to a multiple of 4.
__global__ void __launch_bounds__(256)
flxent_split_kernel(const float* __restrict__ src, long long ld, int rows, int cols, Planes same, Planes trans) {
  __shared__ float sh[2][32][33];
  const int t = threadIdx.x;
  const int r0 = blockIdx.y * 32, c0 = blockIdx.x * 32;
  const int r = t >> 3, c = (t & 7) * 4;
  const int row = r0 + r, col = c0 + c;
  const bool in = row < rows && col < cols;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (in) v = *reinterpret_cast<const float4*>(src + static_cast<long long>(row) * ld + col);
  const float x[4] = {v.x, v.y, v.z, v.w};
  float hi[4], lo[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t h, l;
    ptt::tf32::split(x[i], h, l);
    hi[i] = __uint_as_float(h);
    lo[i] = __uint_as_float(l);
  }
  if (same.p && in) {
    float* o = same.p + static_cast<long long>(row) * same.ld + col;
    *reinterpret_cast<float4*>(o) = make_float4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<float4*>(o + same.plane) = make_float4(lo[0], lo[1], lo[2], lo[3]);
  }
  if (trans.p) {
#pragma unroll
    for (int i = 0; i < 4; ++i) sh[0][c + i][r] = hi[i], sh[1][c + i][r] = lo[i];
    __syncthreads();
    const int oc = t >> 3, orr = (t & 7) * 4;  // a source column and 4 of the tile's source rows
    if (c0 + oc < cols && r0 + orr < rows) {
      float* o = trans.p + static_cast<long long>(c0 + oc) * trans.ld + r0 + orr;
      *reinterpret_cast<float4*>(o) = make_float4(sh[0][oc][orr], sh[0][oc][orr + 1], sh[0][oc][orr + 2],
                                                  sh[0][oc][orr + 3]);
      *reinterpret_cast<float4*>(o + trans.plane) = make_float4(sh[1][oc][orr], sh[1][oc][orr + 1],
                                                                sh[1][oc][orr + 2], sh[1][oc][orr + 3]);
    }
  }
}

// One int8 value of the word `w` (byte k) as fp32: exact.
__device__ __forceinline__ float int8_at(uint32_t w, int k) {
  return static_cast<float>(static_cast<int>(w << (24 - 8 * k)) >> 24);
}

// The int8 values of src [rows][cols] (`ld` bytes a row; cols and ld
// multiples of 16, src 16-byte aligned) widened to fp32 (exact: an int8 value
// is a TF32 value, so it needs no lo plane) into out [rows][out_ld] as they
// lie or, with TRANS, [cols][out_ld] (rows a multiple of 4). Both read 4-byte
// words and write 16-byte vectors, a warp's 32 lanes on consecutive ones.
// As they lie: a CTA takes 1024 words of one row, 4 a thread. TRANS: a CTA
// takes a tile of 128 source rows x 64 source columns. A thread loads a word
// from each of 4 consecutive rows, transposes the 4 x 4 bytes in registers
// (byte_perm) and stores 4 words, each a column's 4 rows, in shared memory
// [64 columns][32 words + 1]; a warp then writes each output row's 128
// floats from one word a lane. The word slot of rows 4q..4q+3 of column c is
// q ^ (2 * (c / 32)): no two lanes of a warp's stores share a bank.
template <bool TRANS>
__global__ void __launch_bounds__(256)
flxent_widen_kernel(const int8_t* __restrict__ src, long long ld, int rows, int cols, float* __restrict__ out,
                    long long out_ld) {
  const int t = threadIdx.x;
  if constexpr (!TRANS) {
    const int row = blockIdx.y, words = cols >> 2, w0 = blockIdx.x * 1024 + t;
    const int8_t* s = src + static_cast<long long>(row) * ld;
    float* o = out + static_cast<long long>(row) * out_ld;
    uint32_t v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int w = w0 + 256 * j;
      v[j] = w < words ? *reinterpret_cast<const uint32_t*>(s + 4 * w) : 0u;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int w = w0 + 256 * j;
      if (w < words) {
        *reinterpret_cast<float4*>(o + 4 * w) =
            make_float4(int8_at(v[j], 0), int8_at(v[j], 1), int8_at(v[j], 2), int8_at(v[j], 3));
      }
    }
  } else {
    __shared__ uint32_t sh[64][33];
    const int r0 = blockIdx.y * 128, c0 = blockIdx.x * 64;
    const int wc = t & 15;  // the thread's word of each source row: columns 4 wc .. 4 wc + 3
    const bool col_in = c0 + 4 * wc < cols;
    uint32_t a[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int q = (t >> 4) + 16 * j;  // rows 4 q .. 4 q + 3 of the tile
      const bool in = col_in && r0 + 4 * q < rows;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        a[j][k] = in ? *reinterpret_cast<const uint32_t*>(src + static_cast<long long>(r0 + 4 * q + k) * ld + c0 +
                                                           4 * wc)
                     : 0u;
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int q = ((t >> 4) + 16 * j) ^ (2 * (wc >> 3));
      const uint32_t t0 = __byte_perm(a[j][0], a[j][1], 0x5140), t1 = __byte_perm(a[j][0], a[j][1], 0x7362);
      const uint32_t t2 = __byte_perm(a[j][2], a[j][3], 0x5140), t3 = __byte_perm(a[j][2], a[j][3], 0x7362);
      sh[4 * wc + 0][q] = __byte_perm(t0, t2, 0x5410);  // byte i: row 4 q + i of column 4 wc
      sh[4 * wc + 1][q] = __byte_perm(t0, t2, 0x7632);
      sh[4 * wc + 2][q] = __byte_perm(t1, t3, 0x5410);
      sh[4 * wc + 3][q] = __byte_perm(t1, t3, 0x7632);
    }
    __syncthreads();
    const int lane = t & 31;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int oc = (t >> 5) * 8 + i;  // a source column: one output row
      if (c0 + oc < cols && r0 + 4 * lane < rows) {
        const uint32_t w = sh[oc][lane ^ (2 * (oc >> 5))];
        *reinterpret_cast<float4*>(out + static_cast<long long>(c0 + oc) * out_ld + r0 + 4 * lane) =
            make_float4(int8_at(w, 0), int8_at(w, 1), int8_at(w, 2), int8_at(w, 3));
      }
    }
  }
}

// The map of one plane [rows][k] (`ld` floats a row) in [128][32] boxes
int map_plane(CUtensorMap* m, const float* base, int rows, int k, long long ld) {
  return hp::encode_2d(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, base, rows, k, ld * 4, kBM, kBK);
}

bool mappable(const Planes& pl) {
  return pl.p != nullptr && pl.ld % 4 == 0 && pl.plane % 4 == 0 && reinterpret_cast<uintptr_t>(pl.p) % 16 == 0;
}

// One launch of `kernel` (a __global__ of the PASSES-pass mainloop) over the
// [p.M, p.N] output; B's lo plane is read in three passes only.
template <int PASSES, typename Kernel>
int launch(Kernel kernel, const Planes& a, const Planes& b, Params p, cudaStream_t stream) {
  using G = Geo<PASSES>;
  if (p.M <= 0 || p.N <= 0 || p.K <= 0 || !mappable(a) || !mappable(b)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tah, tal, tbh, tbl;
  int err = map_plane(&tah, a.p, p.M, p.K, a.ld);
  if (!err) err = map_plane(&tal, a.p + a.plane, p.M, p.K, a.ld);
  if (!err) err = map_plane(&tbh, b.p, p.N, p.K, b.ld);
  if (!err) err = map_plane(&tbl, PASSES == 3 ? b.p + b.plane : b.p, p.N, p.K, b.ld);
  if (err) return err;
  p.tiles_m = (p.M + kBM - 1) / kBM;
  p.tiles_n = (p.N + kBN - 1) / kBN;
  err = ptt::allow_smem(kernel, G::kSmemBytes);
  if (!err) err = hp::check_reg_split(kernel, kThreads, kConsumers * kConsumerRegs + 128 * kProducerRegs);
  if (err) return err;
  kernel<<<p.tiles_m * p.tiles_n, kThreads, G::kSmemBytes, stream>>>(tah, tal, tbh, tbl, p);
  return static_cast<int>(cudaGetLastError());
}

// One launch of the backward's product PROD
template <int PROD>
int launch_product(const Planes& a, const Planes& b, const Params& p, cudaStream_t stream) {
  return launch<3>(flxent_tf32_kernel<PROD>, a, b, p, stream);
}

Planes planes(void* p, long long ld, long long plane) { return Planes{static_cast<float*>(p), ld, plane}; }

}  // namespace

// The hi / lo TF32 planes of src [rows][cols] (fp32, `ld` floats a row;
// cols and ld multiples of 4, src 16-byte aligned) into `same` [2][rows][.]
// and / or `trans` [2][cols][.] (null: not written), each plane pair as
// (pointer, floats a row, floats from hi to lo). One launch.
extern "C" int ptt_flxent_split(const void* src, long long ld, int rows, int cols, void* same, long long same_ld,
                                long long same_plane, void* trans, long long trans_ld, long long trans_plane,
                                void* stream) {
  const Planes s = planes(same, same_ld, same_plane), t = planes(trans, trans_ld, trans_plane);
  if (rows <= 0 || cols <= 0 || cols % 4 || ld % 4 || reinterpret_cast<uintptr_t>(src) % 16 ||
      (same && !mappable(s)) || (trans && !mappable(t)) || (!same && !trans) || (rows + 31) / 32 > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((cols + 31) / 32, (rows + 31) / 32);
  flxent_split_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(src), ld, rows,
                                                                           cols, s, t);
  return static_cast<int>(cudaGetLastError());
}

// The int8 values of src [rows][cols] (`ld` bytes a row) widened to fp32
// into out [rows][out_ld], or with `trans` [cols][out_ld]: cols and ld
// multiples of 16, src 16-byte aligned; out 16-byte aligned, out_ld a
// multiple of 4, and with `trans` rows a multiple of 4. One launch.
extern "C" int ptt_flxent_widen(const void* src, long long ld, int rows, int cols, int trans, void* out,
                                long long out_ld, void* stream) {
  if (rows <= 0 || cols <= 0 || cols % 16 || ld % 16 || reinterpret_cast<uintptr_t>(src) % 16 || out == nullptr ||
      reinterpret_cast<uintptr_t>(out) % 16 || out_ld % 4 || (trans && rows % 4) ||
      (trans ? (rows + 127) / 128 : rows) > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int8_t* s = static_cast<const int8_t*>(src);
  float* o = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (trans) {
    flxent_widen_kernel<true><<<dim3((cols + 63) / 64, (rows + 127) / 128), 256, 0, st>>>(s, ld, rows, cols, o,
                                                                                          out_ld);
  } else {
    flxent_widen_kernel<false><<<dim3((cols / 4 + 1023) / 1024, rows), 256, 0, st>>>(s, ld, rows, cols, o, out_ld);
  }
  return static_cast<int>(cudaGetLastError());
}

// Kernel 17's partials of the vocab columns [c0, c0 + vc) (c0 a multiple of
// 128) from x's planes xp [2][N][H] and the sub-chunk's W_c^T planes wp
// [2][vc][H] in three passes, or (passes 2) wp's one plane of the int8 W's
// widened values with the per-column scales wscale [V]: into part
// [3][tiles][N] (tiles = ceil(V / 128)) at the sub-chunk's tiles, c0 / 128
// on. ptt_flxent_merge reduces them once every sub-chunk has run.
extern "C" int ptt_flxent_tf32_fwd(int passes, const void* xp, long long x_ld, long long x_plane, const void* wp,
                                   long long w_ld, long long w_plane, const void* wscale, const void* labels,
                                   void* part, int tiles, int N, int H, int c0, int vc, void* stream) {
  Params p{};
  p.M = N, p.N = vc, p.K = H;
  p.labels = static_cast<const int*>(labels);
  p.c0 = c0;
  p.wscale = wscale ? static_cast<const float*>(wscale) + c0 : nullptr;
  p.part = static_cast<float*>(part);
  p.part_stride = static_cast<long long>(tiles) * N;
  p.tile0 = c0 / kBN;
  if (c0 < 0 || c0 % kBN || static_cast<long long>(tiles) * kBN < static_cast<long long>(c0) + vc ||
      (passes == 2) != (wscale != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Planes a = planes(const_cast<void*>(xp), x_ld, x_plane), b = planes(const_cast<void*>(wp), w_ld, w_plane);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (passes == 3) return launch<3>(flxent_fwd_tf32_kernel<3>, a, b, p, s);
  if (passes == 2) return launch<2>(flxent_fwd_tf32_kernel<2>, a, b, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// D of the vocab columns [c0, c0 + vc) from x's planes xp [2][N][H] and the
// chunk's W_c^T planes wp [2][vc][H]: into d [N][ldd] (flxent_dchunk), D's
// planes dp [2][N][.] (dX's A) and D^T's dtp [2][vc][.] (dW's operand);
// each output may be null.
extern "C" int ptt_flxent_tf32_dchunk(const void* xp, long long x_ld, long long x_plane, const void* wp,
                                      long long w_ld, long long w_plane, const void* labels, const void* lse,
                                      const void* gcoef, void* d, long long ldd, void* dp, long long dp_ld,
                                      long long dp_plane, void* dtp, long long dtp_ld, long long dtp_plane, int N,
                                      int H, int c0, int vc, void* stream) {
  Params p{};
  p.M = N, p.N = vc, p.K = H;
  p.labels = static_cast<const int*>(labels);
  p.lse = static_cast<const float*>(lse);
  p.gcoef = static_cast<const float*>(gcoef);
  p.c0 = c0;
  p.d = static_cast<float*>(d);
  p.ldd = ldd;
  p.dp = planes(dp, dp_ld, dp_plane);
  p.dtp = planes(dtp, dtp_ld, dtp_plane);
  if ((d && ldd % 2) || (dp && !mappable(p.dp))) return static_cast<int>(cudaErrorInvalidValue);
  return launch_product<kD>(planes(const_cast<void*>(xp), x_ld, x_plane),
                            planes(const_cast<void*>(wp), w_ld, w_plane), p, static_cast<cudaStream_t>(stream));
}

// dX (+)= D W_c^T from D's planes dp [2][N][.] and the chunk's W_c planes wp
// [2][H][.] (K = vc) into dx [N][H]; `first` overwrites dx, later chunks add.
extern "C" int ptt_flxent_tf32_dx(const void* dp, long long dp_ld, long long dp_plane, const void* wp, long long w_ld,
                                  long long w_plane, void* dx, int N, int H, int vc, int first, void* stream) {
  Params p{};
  p.M = N, p.N = H, p.K = vc;
  p.out = static_cast<float*>(dx);
  p.ldo = H;
  p.accumulate = first ? 0 : 1;
  if (H % 2) return static_cast<int>(cudaErrorInvalidValue);
  return launch_product<kDx>(planes(const_cast<void*>(dp), dp_ld, dp_plane),
                             planes(const_cast<void*>(wp), w_ld, w_plane), p, static_cast<cudaStream_t>(stream));
}

// dW's chunk out [M][ldo] = A B^T, A's planes [2][M][.] and B's [2][Nc][.]
// over K = the rows: x^T and D^T for W [H, V] (M = H, Nc = vc, out = dW +
// c0), D^T and x^T for a vocab-major W (M = vc, Nc = H, out = dW + c0 H).
extern "C" int ptt_flxent_tf32_dw(const void* ap, long long a_ld, long long a_plane, const void* bp, long long b_ld,
                                  long long b_plane, void* out, long long ldo, int M, int Nc, int K, void* stream) {
  Params p{};
  p.M = M, p.N = Nc, p.K = K;
  p.out = static_cast<float*>(out);
  p.ldo = ldo;
  if (ldo % 2 || reinterpret_cast<uintptr_t>(out) % 8) return static_cast<int>(cudaErrorInvalidValue);
  return launch_product<kDw>(planes(const_cast<void*>(ap), a_ld, a_plane),
                             planes(const_cast<void*>(bp), b_ld, b_plane), p, static_cast<cudaStream_t>(stream));
}
