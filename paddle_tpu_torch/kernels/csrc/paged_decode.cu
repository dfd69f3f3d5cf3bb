// Flash decode over the paged KV cache: one new query token per slot, whose
// G = HQ / HKV query heads of one KV head attend to positions < lens[b] of
// the slot's paged KV blocks (lens INCLUDES the token just appended). Two
// kernels share this source: with ROPE off, q is taken as given (kernel 5);
// with it on, neox rope is applied to q in q's type first (kernel 6).
//
// Replaces: paddle_tpu/kernels/paged_attention.py `_decode_kernel`
// (launched by `paged_flash_decode`, the decode step of `generate_paged`)
// and `_decode_fused_kernel` (launched by `paged_flash_decode_fused`), each
// with `_dequant_tile` in its block walk when the pool is int8.
//
// Semantics kept from the Pallas kernels: q (roped in its type when ROPE:
// the fp32 rope rows rounded to that type, each product and the sum rounded
// to it) is cast to fp32 and multiplied by `scale`; scores are fp32; the
// softmax is an fp32 online softmax with denominator max(l, 1e-30), so a
// slot with lens == 0 is written as exact 0; positions >= lens contribute
// p == 0 exactly (here: they are never visited); block-table entries at or
// past ceil(lens / BS) are never read, and neither are their blocks.
// Storage is bf16, fp16 or fp32 (the template type T); the math is fp32.
//
// The int8 pool (KV = int8_t, the `_int8` entry points): int8 K/V rows and
// two fp32 scale planes [NB, HKV, BS] addressed by the same physical block
// id; each loaded element is dequantized as float(int8) * scale (the
// Pallas `_dequant_tile`, one fp32 multiply, the plain version's bits). A
// lane's slice is then 8 or 16 bytes (one load at D 64, 128, 256 and 512),
// 12 (three 4-byte loads at D 192 and 384), 20 or 28 (five or seven 4-byte
// loads at D 320 and 448), so the lanes of a row and their shuffle
// reduction stay as they are.
// q and out keep their own type T.
//
// Design (simple first, not yet fast). One CUDA block of 4 warps per (up to
// ROWS query heads of one KV head, KV head, slot): ROWS is 1 for MHA and 4
// otherwise (2 where a lane holds more than 16 elements of a row: D 320 and
// 448), so GQA heads share each K/V row they read. The block splits the
// slot's positions over lane groups of LANES lanes (8 at D 64 and 128, 16 at
// D 192, 256, 320 and 448, 32 at D 384 and 512: the widest group whose
// slice of an int8 row is still whole 4-byte loads, so a lane holds 8 to 28
// elements of a row): group t takes positions t, t + G, t + 2 G, ... (G =
// 128 / LANES groups); its lanes each hold D / LANES elements of the K and
// V row (loads of 16 bytes where the slice allows, else 8 or 4: at D 192 a
// lane's 12 elements are three 8-byte loads in bf16 and fp16 and three
// 4-byte loads in int8),
// reduce the dot product with shuffles and keep their own online-softmax
// state (m, l and a D / LANES slice of the accumulator per row). At the end
// the partial states are merged: across the groups of a warp with shuffles,
// across the 4 warps through shared memory.
//
// Bound on H100: bytes. Each used K/V row is read once per block, ~1 flop
// per byte for MHA, far under the card's ~295 flop/byte ridge. With G = 1
// at the 7B decode shape there are only B * HKV blocks (256 at 8 slots,
// 32 KV heads) for 132 SMs, each walking its slot's whole history with one
// K/V row in flight per lane group: latency-bound, not bandwidth-bound.
// Splitting the walk over more blocks (flash-decoding) is later work.
#include <type_traits>

#include "common.cuh"

using ptt::bf16;
using ptt::f16;

namespace {

constexpr int kThreads = 128;             // 4 warps
constexpr float kNegInf = -1e30f;         // the Pallas kernel's NEG_INF

// lanes that share one K/V row: a lane's slice is D / 8 elements up to D
// 128, D / 16 up to 256 (16 at D 256, as at D 128: the registers do not
// grow); above, D / 32 where that slice of an int8 row is a whole number of
// 4-byte loads (D 384 and 512: 12 and 16 elements), else D / 16 (D 320 and
// 448: 20 and 28 elements, held by 2 query rows a block instead of 4)
__host__ __device__ constexpr int lanes_of(int d) { return d <= 128 ? 8 : d <= 256 || (d / 32) % 4 ? 16 : 32; }

// query heads a block takes under GQA: 4, or 2 where a lane's slice passes 16
__host__ __device__ constexpr int gqa_rows_of(int d) { return d / lanes_of(d) > 16 ? 2 : 4; }

// elements per load of a lane's slice of e elements of `size` bytes: the
// widest of 16, 8 and 4 bytes that divides the slice
__host__ __device__ constexpr int vec_of(int e, int size) {
  return e * size % 16 == 0 ? 16 / size : e * size % 8 == 0 ? 8 / size : 4 / size;
}

// the kVec elements of chunk c of a row (kVec * sizeof(T) bytes: 16, 8 or
// 4), as fp32
template <typename T, int kVec>
__device__ __forceinline__ void load_chunk(const T* row, int c, float* dst) {
  constexpr int kBytes = kVec * static_cast<int>(sizeof(T));
  static_assert(kBytes == 16 || kBytes == 8 || kBytes == 4, "16-, 8- or 4-byte loads");
  if constexpr (kBytes == 16) {
    const uint4 raw = ptt::load16<T>(row, c);
    const T* e = ptt::elems_of<T>(raw);
#pragma unroll
    for (int i = 0; i < kVec; ++i) dst[i] = ptt::to_f(e[i]);
  } else if constexpr (kBytes == 8) {
    const uint2 raw = reinterpret_cast<const uint2*>(row)[c];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < kVec; ++i) dst[i] = ptt::to_f(e[i]);
  } else {
    const uint32_t raw = reinterpret_cast<const uint32_t*>(row)[c];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < kVec; ++i) dst[i] = ptt::to_f(e[i]);
  }
}

template <typename T, typename KV, int D, int ROWS, bool ROPE>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q,      // [B, HQ, D], pre-rope when ROPE
                    const float* __restrict__ cos_t,  // [B, D] fp32 (ROPE only)
                    const float* __restrict__ sin_t,
                    const KV* __restrict__ kc,    // [NB, HKV, BS, D]
                    const KV* __restrict__ vc,
                    const float* __restrict__ ks,  // [NB, HKV, BS] (int8 KV only)
                    const float* __restrict__ vs,
                    const int* __restrict__ tables,  // [B, MBS]
                    const int* __restrict__ lens,    // [B] INCLUDING the current token
                    T* __restrict__ out,             // [B, HQ, D]
                    int HQ, int HKV, int BS, int MBS, float scale) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  constexpr int kLanes = lanes_of(D);     // lanes that share one K/V row
  constexpr int kGroups = kThreads / kLanes;  // positions in flight per block (16, or 8 above D 128)
  constexpr int kE = D / kLanes;         // elements per lane of a row
  constexpr int kVec = vec_of(kE, static_cast<int>(sizeof(KV)));
  constexpr int kLoads = kE / kVec;      // loads per lane of a row
  static_assert(kE % kVec == 0 && kLoads >= 1, "a lane's slice must be whole chunks");
  constexpr int kWarps = kThreads / 32;

  __shared__ float q_s[ROWS][D];
  __shared__ float m_s[kWarps][ROWS];
  __shared__ float l_s[kWarps][ROWS];
  __shared__ float acc_s[kWarps][ROWS][D];

  const int tid = threadIdx.x, warp = tid >> 5;
  const int sub = tid % kLanes, grp = tid / kLanes;
  const int h = blockIdx.y, b = blockIdx.z;
  const int G = HQ / HKV;
  const int g0 = blockIdx.x * ROWS;
  const int rows_here = min(ROWS, G - g0);
  const int len = lens[b];
  const T* qbase = q + (static_cast<size_t>(b) * HQ + h * G + g0) * D;

  // q rows (roped in q's type when ROPE) scaled in fp32; rows past G: 0
  for (int idx = tid; idx < ROWS * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    float val = 0.f;
    if (r < rows_here) {
      if constexpr (ROPE) {
        val = ptt::rope_elem<T, D, float>(qbase + r * D, cos_t + static_cast<size_t>(b) * D,
                                   sin_t + static_cast<size_t>(b) * D, d) * scale;
      } else {
        val = ptt::to_f(qbase[r * D + d]) * scale;
      }
    }
    q_s[r][d] = val;
  }
  __syncthreads();

  // this lane's slice: chunks sub, sub + kLanes, ... of the row
  float qr[ROWS][kE];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < kLoads; ++j)
#pragma unroll
      for (int i = 0; i < kVec; ++i) qr[r][j * kVec + i] = q_s[r][(j * kLanes + sub) * kVec + i];

  float m[ROWS], l[ROWS], acc[ROWS][kE];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[r][e] = 0.f;
  }

  // every lane runs every step (the shuffles need the whole warp); a group
  // whose position is past len loads nothing and leaves its state as it is
  const int* table = tables + static_cast<size_t>(b) * MBS;
  for (int base = 0; base < len; base += kGroups) {
    const int pos = base + grp;
    const bool valid = pos < len;  // so pos / BS < ceil(len / BS)
    float kf[kE], vf[kE];
    if (valid) {
      const size_t row = (static_cast<size_t>(table[pos / BS]) * HKV + h) * BS + pos % BS;
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        load_chunk<KV, kVec>(kc + row * D, j * kLanes + sub, kf + j * kVec);
        load_chunk<KV, kVec>(vc + row * D, j * kLanes + sub, vf + j * kVec);
      }
      if constexpr (kQuant) {  // the dequant tile: the token's scale, one fp32 multiply
        const float sk = ks[row], sv = vs[row];
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          kf[e] = __fmul_rn(kf[e], sk);
          vf[e] = __fmul_rn(vf[e], sv);
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < kE; ++e) kf[e] = vf[e] = 0.f;
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < kE; ++e) s += qr[r][e] * kf[e];
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (valid) {
        const float m_new = fmaxf(m[r], s);
        const float alpha = expf(m[r] - m_new);
        const float p = expf(s - m_new);
        l[r] = l[r] * alpha + p;
#pragma unroll
        for (int e = 0; e < kE; ++e) acc[r][e] = acc[r][e] * alpha + p * vf[e];
        m[r] = m_new;
      }
    }
  }

  // merge the lane groups of each warp (lanes sub, sub + kLanes, ...);
  // a group that visited nothing holds m = -1e30, l = 0, acc = 0
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    float mw = m[r];
#pragma unroll
    for (int o = kLanes; o < 32; o <<= 1) mw = fmaxf(mw, __shfl_xor_sync(0xffffffffu, mw, o));
    const float f = expf(m[r] - mw);
    float lw = l[r] * f;
#pragma unroll
    for (int o = kLanes; o < 32; o <<= 1) lw += __shfl_xor_sync(0xffffffffu, lw, o);
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      float a = acc[r][e] * f;
#pragma unroll
      for (int o = kLanes; o < 32; o <<= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
      acc[r][e] = a;
    }
    if (grp % (32 / kLanes) == 0) {  // the first group of the warp writes its state
#pragma unroll
      for (int j = 0; j < kLoads; ++j)
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc_s[warp][r][(j * kLanes + sub) * kVec + i] = acc[r][j * kVec + i];
      if (sub == 0) {
        m_s[warp][r] = mw;
        l_s[warp][r] = lw;
      }
    }
  }
  __syncthreads();

  // merge the 4 warps and write: out = acc / max(l, 1e-30)
  for (int idx = tid; idx < rows_here * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    float mb = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mb = fmaxf(mb, m_s[w][r]);
    float lb = 0.f, ab = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(m_s[w][r] - mb);
      lb += l_s[w][r] * f;
      ab += acc_s[w][r][d] * f;
    }
    out[(static_cast<size_t>(b) * HQ + h * G + g0 + r) * D + d] = ptt::from_f<T>(ab / fmaxf(lb, 1e-30f));
  }
}

template <typename T, typename KV, int D, int ROWS, bool ROPE>
int launch_rows(const void* q, const void* cos_t, const void* sin_t, const void* kc, const void* vc,
                const void* ks, const void* vs, const void* tables, const void* lens, void* out, int B,
                int HQ, int HKV, int BS, int MBS, float scale, cudaStream_t st) {
  const dim3 grid((HQ / HKV + ROWS - 1) / ROWS, HKV, B);
  paged_decode_kernel<T, KV, D, ROWS, ROPE><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<const KV*>(kc), static_cast<const KV*>(vc), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(tables), static_cast<const int*>(lens),
      static_cast<T*>(out), HQ, HKV, BS, MBS, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename KV, bool ROPE>
int launch(const void* q, const void* cos_t, const void* sin_t, const void* kc, const void* vc,
           const void* ks, const void* vs, const void* tables, const void* lens, void* out, int B, int HQ,
           int HKV, int D, int BS, int MBS, float scale, cudaStream_t st) {
#define PTT_LAUNCH(DIM)                                                                                     \
  (HQ == HKV ? launch_rows<T, KV, DIM, 1, ROPE>(q, cos_t, sin_t, kc, vc, ks, vs, tables, lens, out, B, HQ, \
                                                HKV, BS, MBS, scale, st)                                   \
             : launch_rows<T, KV, DIM, gqa_rows_of(DIM), ROPE>(q, cos_t, sin_t, kc, vc, ks, vs, tables,    \
                                                               lens, out, B, HQ, HKV, BS, MBS, scale, st))
  switch (D) {
    case 64: return PTT_LAUNCH(64);
    case 128: return PTT_LAUNCH(128);
    case 192: return PTT_LAUNCH(192);
    case 256: return PTT_LAUNCH(256);
    case 320: return PTT_LAUNCH(320);
    case 384: return PTT_LAUNCH(384);
    case 448: return PTT_LAUNCH(448);
    case 512: return PTT_LAUNCH(512);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PTT_LAUNCH
}

// QUANT: the cache is int8 with scale planes; else it is of q's type
template <bool ROPE, bool QUANT>
int launch_io(int io, const void* q, const void* cos_t, const void* sin_t, const void* kc,
              const void* vc, const void* ks, const void* vs, const void* tables, const void* lens,
              void* out, int B, int HQ, int HKV, int D, int BS, int MBS, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PTT_IO(TYPE)                                                                             \
  launch<TYPE, std::conditional_t<QUANT, int8_t, TYPE>, ROPE>(q, cos_t, sin_t, kc, vc, ks, vs,   \
                                                              tables, lens, out, B, HQ, HKV, D,  \
                                                              BS, MBS, scale, st)
  switch (io) {
    case ptt::kBF16:
      return PTT_IO(bf16);
    case ptt::kF16:
      return PTT_IO(f16);
    case ptt::kF32:
      return PTT_IO(float);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PTT_IO
}

}  // namespace

// Kernel 5. `io` is the storage type (ptt::IoType). Returns
// cudaErrorInvalidValue for a head dim that is not a multiple of 64 up to
// 512 or an unknown type.
extern "C" int ptt_paged_decode(int io, const void* q, const void* kc, const void* vc,
                                const void* tables, const void* lens, void* out, int B, int HQ,
                                int HKV, int D, int BS, int MBS, float scale, void* stream) {
  return launch_io<false, false>(io, q, nullptr, nullptr, kc, vc, nullptr, nullptr, tables, lens, out, B,
                                 HQ, HKV, D, BS, MBS, scale, stream);
}

// Kernel 6: kernel 5 with q roped first; cos/sin are the slots' fp32 rope rows [B, D],
// rounded to q's type as they are read.
extern "C" int ptt_paged_decode_fused(int io, const void* q, const void* cos_t, const void* sin_t,
                                      const void* kc, const void* vc, const void* tables,
                                      const void* lens, void* out, int B, int HQ, int HKV, int D,
                                      int BS, int MBS, float scale, void* stream) {
  return launch_io<true, false>(io, q, cos_t, sin_t, kc, vc, nullptr, nullptr, tables, lens, out, B, HQ,
                                HKV, D, BS, MBS, scale, stream);
}

// Kernel 5 over the int8 pool: kc/vc int8 [NB, HKV, BS, D], ks/vs fp32
// [NB, HKV, BS]; `io` is the type of q and out.
extern "C" int ptt_paged_decode_int8(int io, const void* q, const void* kc, const void* vc, const void* ks,
                                     const void* vs, const void* tables, const void* lens, void* out,
                                     int B, int HQ, int HKV, int D, int BS, int MBS, float scale,
                                     void* stream) {
  return launch_io<false, true>(io, q, nullptr, nullptr, kc, vc, ks, vs, tables, lens, out, B, HQ, HKV, D,
                                BS, MBS, scale, stream);
}

// Kernel 6 over the int8 pool.
extern "C" int ptt_paged_decode_fused_int8(int io, const void* q, const void* cos_t, const void* sin_t,
                                           const void* kc, const void* vc, const void* ks, const void* vs,
                                           const void* tables, const void* lens, void* out, int B, int HQ,
                                           int HKV, int D, int BS, int MBS, float scale, void* stream) {
  return launch_io<true, true>(io, q, cos_t, sin_t, kc, vc, ks, vs, tables, lens, out, B, HQ, HKV, D, BS,
                               MBS, scale, stream);
}
