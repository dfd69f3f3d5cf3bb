// Fused linear cross entropy's backward in fp32 on the TF32 tensor cores:
// the D recompute that kernels 18 and 19 share, dX (kernel 18) and dW
// (kernel 19) for fp32 x and W, each product in three TF32 passes of split
// operands (3xTF32) on a warp-specialised wgmma mainloop fed by TMA, and the
// split pass that lays the products' operands out for it.
//
// Replaces: the fp32 instances of paddle_tpu/kernels/fused_loss.py
// `_flxent_block_d` (:302), `_flxent_dx_kernel` (:322) and
// `_flxent_dw_kernel` (:343), launched by `_make_pallas_core` (:366): JAX
// runs its Pallas kernels in fp32 for an fp32 model whose hidden size is a
// multiple of 128 (the fp32 train step's loss head). kernels/fused_loss.py
// `flx_bwd_route` names this instance "tf32x3" where the split pass reads W
// in 16-byte vectors (W 16-byte aligned, its rows a multiple of 4 floats);
// other fp32 shapes, and kernel 17 in fp32, stay on the CUDA cores
// (flxent_fp32.cu).
//
// Per vocab chunk of Vc columns (the wrapper walks the chunks in order):
//   D    = (exp(x W_c - lse) - onehot) * gcoef     [N, Vc]  (K = H)
//   dX  += D W_c^T (the first chunk overwrites)     [N, H]   (K = Vc)
//   dW_c = x^T D, or D^T x when vocab-major         (K = N)
//
// The arithmetic (tf32.cuh): every operand x is split once as hi =
// rna_tf32(x), lo = rna_tf32(x - hi) (`split`), and a b ~ a_lo b_hi + a_hi
// b_lo + a_hi b_hi. The tensor cores' fp32 accumulation rounds toward zero
// (flash_fwd_tf32.cu), so chained over a long K it drifts: each k block of
// 32 is summed into zeroed partials, the cross terms and hi hi each in their
// own, and each partial is added to the running sum with one FADD a value
// (to nearest). tests/test_torch_flxent_tf32.py models this on the CPU.
//
// Design. TF32 wgmma reads both operands from shared memory K-major only
// (it has no transpose for 4-byte types), and three of the six operands lie
// MN-major in device memory (D's W_c for W [H, V], dX's W_c for a
// vocab-major W, both of dW's). So the split pass (`flxent_split_kernel`)
// writes each operand once into hi and lo planes laid out K-major: x and
// x^T once a backward, W_c in both orientations once a chunk; D's epilogue
// writes D's planes and D^T's. Every wgmma operand then arrives by TMA with
// no split and no transpose in the mainloop. The mainloop: one 128 x 128
// output tile a CTA (tiles in groups of 8 row tiles for L2 reuse), a
// producer warp that keeps three stages of four [128][32] boxes (A hi, A lo,
// B hi, B lo; 64 KB a stage) in flight, two consumer warpgroups of 64 rows
// (m64n128k8), each with three 64-register sets: the cross-term partial,
// the hi hi partial and the running sum. Each partial's FADD runs while the
// other partial's wgmmas are on the tensor cores. The epilogues write from
// registers: D's (exp in fp32) its planes and, for flxent_dchunk, D itself;
// dX adds the chunks before in place; dW stores. No atomics: two calls give
// the same bits, and a product runs only when asked for.
//
// Bound on H100: three TF32 passes at 494.7 TFLOP/s, 6 N H Vc flops a
// product; the split pass is bound by its bytes (one fp32 read, two or four
// written a value).
#include "common.cuh"
#include "hopper.cuh"
#include "tf32.cuh"

namespace hp = ptt::hopper;

namespace {

constexpr int kBM = 128;                    // tile rows (64 per consumer warpgroup)
constexpr int kBN = 128;                    // tile columns
constexpr int kBK = 32;                     // k per stage: one 128-byte row of fp32
constexpr int kStages = 3;
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
constexpr int kStageBytes = 4 * kBox;       // A hi, A lo, B hi, B lo
constexpr int kBar = kStages * kStageBytes;
constexpr int kSmemBytes = kBar + 2 * kStages * 8 + 1024;  // + alignment slack
static_assert(kSmemBytes <= 227 * 1024, "a block's shared memory");
constexpr int kGroup = 8;                   // row tiles per sweep of the column tiles
constexpr int kAcc = kBN / 2;               // accumulators a thread (m64n128)

enum Product : int { kD = 0, kDx = 1, kDw = 2 };

// A plane pair: hi at p, lo at p + plane, rows `ld` floats apart
struct Planes {
  float* p;
  long long ld, plane;
};

struct Params {
  int M, N, K;         // output rows and columns, reduction extent
  int tiles_m, tiles_n;
  // D: per row the label, lse and gcoef; the chunk's first vocab column;
  // outputs (each may be null): D itself [M][ldd], D's planes [M][.], D^T's [N][.]
  const int* labels;
  const float* lse;
  const float* gcoef;
  int c0;
  float* d;
  long long ldd;
  Planes dp, dtp;
  // dX, dW: the output [M][ldo]; dX after its first chunk adds what it holds
  float* out;
  long long ldo;
  int accumulate;
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

// C [M, N] = A [M, K] B [N, K]^T in three TF32 passes, A and B as hi / lo
// plane pairs read through TMA maps (K-major, zero past every edge), with
// the epilogue PROD.
template <int PROD>
__global__ void __launch_bounds__(kThreads, 1)
flxent_tf32_kernel(const __grid_constant__ CUtensorMap ta_hi, const __grid_constant__ CUtensorMap ta_lo,
                   const __grid_constant__ CUtensorMap tb_hi, const __grid_constant__ CUtensorMap tb_lo,
                   const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + kBar);
  uint64_t* empty = full + kStages;
  const int nk = (p.K + kBK - 1) / kBK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int m0, n0;
  tile_of(p, blockIdx.x, m0, n0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(&full[s], 1);                // the producer's arrival + the boxes' bytes
      hp::mbar_init(&empty[s], kConsumerWarps);  // one arrival per consumer warp
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    hp::reg_dealloc<kProducerRegs>();
    if (warp > kConsumerWarps || lane != 0) return;  // one thread issues every copy
    hp::tma_prefetch(&ta_hi);
    hp::tma_prefetch(&ta_lo);
    hp::tma_prefetch(&tb_hi);
    hp::tma_prefetch(&tb_lo);
    uint32_t s = 0, phase = 0;
    for (int ks = 0; ks < nk; ++ks) {
      const int k0 = ks * kBK;
      hp::mbar_wait(&empty[s], phase ^ 1);  // the slot's last stage is consumed
      hp::mbar_arrive_expect_tx(&full[s], kStageBytes);
      unsigned char* st = sm + s * kStageBytes;
      hp::tma_load_2d(st, &ta_hi, &full[s], k0, m0);
      hp::tma_load_2d(st + kBox, &ta_lo, &full[s], k0, m0);
      hp::tma_load_2d(st + 2 * kBox, &tb_hi, &full[s], k0, n0);
      hp::tma_load_2d(st + 3 * kBox, &tb_lo, &full[s], k0, n0);
      if (++s == kStages) s = 0, phase ^= 1;
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
    const uint32_t base = sm32 + stage * kStageBytes;
    const uint64_t dah = hp::desc_sw128_at(base + wg * (kBox / 2), 16, 1024);
    const uint64_t dal = hp::desc_sw128_at(base + kBox + wg * (kBox / 2), 16, 1024);
    const uint64_t dbh = hp::desc_sw128_at(base + 2 * kBox, 16, 1024);
    const uint64_t dbl = hp::desc_sw128_at(base + 3 * kBox, 16, 1024);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {  // a k8 step is 32 bytes: 2 in the descriptor's address field
      hp::wgmma_tf32_n128(pc, dal + 2 * kk, dbh + 2 * kk, kk);
      hp::wgmma_tf32_n128(pc, dah + 2 * kk, dbl + 2 * kk, 1);
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
    if (++stage == kStages) stage = 0, phase ^= 1;
  }
  hp::wgmma_wait<0>();
  hp::fence_regs(ph);
#pragma unroll
  for (int i = 0; i < kAcc; ++i) run[i] += ph[i];
  epilogue<PROD>(run, p, m0 + 64 * wg, n0, wl, gid, tig);
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

// The map of one plane [rows][k] (`ld` floats a row) in [128][32] boxes
int map_plane(CUtensorMap* m, const float* base, int rows, int k, long long ld) {
  return hp::encode_2d(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, base, rows, k, ld * 4, kBM, kBK);
}

bool mappable(const Planes& pl) {
  return pl.p != nullptr && pl.ld % 4 == 0 && pl.plane % 4 == 0 && reinterpret_cast<uintptr_t>(pl.p) % 16 == 0;
}

template <int PROD>
int launch(const Planes& a, const Planes& b, Params p, cudaStream_t stream) {
  if (p.M <= 0 || p.N <= 0 || p.K <= 0 || !mappable(a) || !mappable(b)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tah, tal, tbh, tbl;
  int err = map_plane(&tah, a.p, p.M, p.K, a.ld);
  if (!err) err = map_plane(&tal, a.p + a.plane, p.M, p.K, a.ld);
  if (!err) err = map_plane(&tbh, b.p, p.N, p.K, b.ld);
  if (!err) err = map_plane(&tbl, b.p + b.plane, p.N, p.K, b.ld);
  if (err) return err;
  p.tiles_m = (p.M + kBM - 1) / kBM;
  p.tiles_n = (p.N + kBN - 1) / kBN;
  auto kernel = flxent_tf32_kernel<PROD>;
  err = ptt::allow_smem(kernel, kSmemBytes);
  if (!err) err = hp::check_reg_split(kernel, kThreads, kConsumers * kConsumerRegs + 128 * kProducerRegs);
  if (err) return err;
  kernel<<<p.tiles_m * p.tiles_n, kThreads, kSmemBytes, stream>>>(tah, tal, tbh, tbl, p);
  return static_cast<int>(cudaGetLastError());
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
  return launch<kD>(planes(const_cast<void*>(xp), x_ld, x_plane), planes(const_cast<void*>(wp), w_ld, w_plane), p,
                    static_cast<cudaStream_t>(stream));
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
  return launch<kDx>(planes(const_cast<void*>(dp), dp_ld, dp_plane), planes(const_cast<void*>(wp), w_ld, w_plane), p,
                     static_cast<cudaStream_t>(stream));
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
  return launch<kDw>(planes(const_cast<void*>(ap), a_ld, a_plane), planes(const_cast<void*>(bp), b_ld, b_plane), p,
                     static_cast<cudaStream_t>(stream));
}
