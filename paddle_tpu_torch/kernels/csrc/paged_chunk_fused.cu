// Paged attention over a mixed ragged chunk: every slot carries up to C new
// query tokens (a decode row has q_lens == 1, a prompt chunk up to C, an idle
// slot 0); query row j of slot b attends to cached positions
// < lens[b] + j + 1 of its paged KV blocks. Two kernels share this source:
// with ROPE on, neox rope is applied to q first (kernel A); with it off, q is
// taken as given (kernel 4, the unfused step, whose q was roped beforehand).
//
// Replaces: paddle_tpu/kernels/paged_attention.py `_chunk_fused_kernel`
// (launched by `paged_flash_chunk_fused`, the fused serving step's
// attention) and `_chunk_kernel` (launched by `paged_flash_chunk`, the
// unfused step's), each with `_dequant_tile` in its block walk when the pool
// is int8.
//
// Semantics kept from the Pallas kernels: q is roped in q's type (each
// product and the sum rounded to that type) before the cast to fp32 and the
// multiply by `scale`; scores of invalid positions are -1e30 and their p is
// exactly 0; the validity mask is (pos < lens + j + 1) & (j < q_lens); the
// softmax is an fp32 online softmax with denominator max(l, 1e-30); rows with
// j >= q_lens are written as exact 0; block-table entries at or past
// ceil((lens + q_lens) / BS) are never read, and neither are their blocks.
// Storage is bf16, fp16 or fp32 (the template type T); the math is fp32.
//
// The int8 pool (KV = int8_t, the `_int8` entry points): the cache holds
// int8 K/V rows and two fp32 scale planes [NB, HKV, BS], one scale per
// (block, head, slot), addressed by the same physical block id as the
// payload. Each staged element is dequantized as float(int8) * scale — the
// Pallas `_dequant_tile` and the plain version's `gathered.float() * scale`,
// one fp32 multiply, so both see the same fp32 K/V bits. q and out keep
// their own type T (bf16, fp16 or fp32).
//
// Design (simple first, not yet fast). One CUDA block per (tile of 32 packed
// query rows, KV head, slot); packed row = j * G + g with G = HQ / HKV, so
// the G query heads of one KV head share each K/V tile (GQA). The block reads
// its slot's lens/q_lens and table row itself (no scalar prefetch), skips a
// row tile whose rows are all past q_lens, and walks positions only up to
// the tile's causal limit, 16 at a time: K and V are staged in shared memory
// as fp32, scores are fp32 FMA dot products (a 16-lane group per row
// shares one K row), p and the rescale factor go through shared memory, and
// each warp accumulates 8 rows x D in registers.
//
// Bound on H100: bytes. Each used K/V block must be read once; with at most
// C = 64 query rows per block that is ~64 flops per byte, under the card's
// ~295 flop/byte ridge. This version is far from that bound: it reads each
// block once per row tile and runs its 4*D flops per (row, position) on the
// fp32 FMA units, not the tensor cores — the mma/wgmma path with TMA-fed
// K/V tiles is later work.
#include <type_traits>

#include "common.cuh"

using ptt::bf16;
using ptt::f16;

namespace {

constexpr int kThreads = 128;      // 4 warps
constexpr int kRows = 32;          // packed query rows per block
constexpr int kTile = 16;          // KV positions per inner step
constexpr float kNegInf = -1e30f;  // the Pallas kernel's NEG_INF

template <typename T, typename KV, int D, bool ROPE>
__global__ void __launch_bounds__(kThreads)
paged_chunk_kernel(const T* __restrict__ q,      // [B, C, HQ, D], pre-rope when ROPE
                   const T* __restrict__ cos_t,  // [B, C, D] in q's type (ROPE only)
                   const T* __restrict__ sin_t,
                   const KV* __restrict__ kc,    // [NB, HKV, BS, D]
                   const KV* __restrict__ vc,
                   const float* __restrict__ ks,  // [NB, HKV, BS] (int8 KV only)
                   const float* __restrict__ vs,
                   const int* __restrict__ tables,  // [B, MBS]
                   const int* __restrict__ lens,    // [B] cached before the chunk
                   const int* __restrict__ qlens,   // [B] valid new rows
                   T* __restrict__ out,             // [B, C, HQ, D]
                   int C, int HQ, int HKV, int BS, int MBS, float scale) {
  static_assert(D % 32 == 0 && D <= 128, "head dim: a multiple of 32, at most 128");
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  constexpr int kDV = D / 32;                         // columns per lane, PV phase
  constexpr int kGroups = kThreads / kTile;           // row groups, score phase (8)
  constexpr int kRowsPerThread = kRows / kGroups;     // score phase (4)
  constexpr int kRowsPerWarp = kRows / (kThreads / 32);  // PV phase (8)

  __shared__ float q_s[kRows][D + 1];  // +1: rows land in different banks
  __shared__ float k_s[kTile][D + 1];
  __shared__ float v_s[kTile][D];
  __shared__ float p_s[kRows][kTile + 1];
  __shared__ float alpha_s[kRows];
  __shared__ float l_s[kRows];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.y, b = blockIdx.z;
  const int G = HQ / HKV;
  const int row0 = blockIdx.x * kRows;
  const int rows_here = min(kRows, C * G - row0);
  const int len = lens[b], ql = qlens[b];

  // output element (r, d) of this tile; row r is query token j, head h*G + g
  auto out_at = [&](int r, int d) -> T* {
    const int pr = row0 + r;
    return out + ((static_cast<size_t>(b) * C + pr / G) * HQ + h * G + pr % G) * D + d;
  };

  if (row0 / G >= ql) {  // every row of the tile is past q_lens: exact 0, no KV read
    for (int idx = tid; idx < rows_here * D; idx += kThreads) *out_at(idx / D, idx % D) = ptt::from_f<T>(0.f);
    return;
  }
  const int j_last = min((row0 + rows_here - 1) / G, ql - 1);
  const int n_pos = len + j_last + 1;  // the tile's causal limit: positions past it are masked

  // q rows (roped in q's type when ROPE) scaled in fp32; rows past the tile: 0
  for (int idx = tid; idx < kRows * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    float val = 0.f;
    if (r < rows_here) {
      const int pr = row0 + r, j = pr / G;
      const T* qrow = q + ((static_cast<size_t>(b) * C + j) * HQ + h * G + pr % G) * D;
      if constexpr (ROPE) {
        const size_t trow = (static_cast<size_t>(b) * C + j) * D;
        val = ptt::rope_elem<T, D>(qrow, cos_t + trow, sin_t + trow, d) * scale;
      } else {
        val = ptt::to_f(qrow[d]) * scale;
      }
    }
    q_s[r][d] = val;
  }

  // score phase: this thread scores position t for rows grp + kGroups * i
  const int t = tid % kTile, grp = tid / kTile;
  float m_i[kRowsPerThread], l_i[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
  }
  // PV phase: this warp owns rows warp + 4 * m, this lane columns lane + 32 * k
  float acc[kRowsPerWarp][kDV];
#pragma unroll
  for (int m = 0; m < kRowsPerWarp; ++m)
#pragma unroll
    for (int k = 0; k < kDV; ++k) acc[m][k] = 0.f;

  const int* table = tables + static_cast<size_t>(b) * MBS;
  for (int p0 = 0; p0 < n_pos; p0 += kTile) {
    __syncthreads();  // q_s is written; the previous step's k_s, v_s, p_s are consumed
    for (int idx = tid; idx < kTile * D; idx += kThreads) {
      const int tt = idx / D, d = idx % D, pos = p0 + tt;
      float kv = 0.f, vv = 0.f;
      if (pos < n_pos) {  // pos / BS stays below ceil((lens + q_lens) / BS)
        const size_t row = (static_cast<size_t>(table[pos / BS]) * HKV + h) * BS + pos % BS;
        kv = ptt::to_f(kc[row * D + d]);
        vv = ptt::to_f(vc[row * D + d]);
        if constexpr (kQuant) {  // the dequant tile: the token's scale, one fp32 multiply
          kv = __fmul_rn(kv, ks[row]);
          vv = __fmul_rn(vv, vs[row]);
        }
      }
      k_s[tt][d] = kv;
      v_s[tt][d] = vv;
    }
    __syncthreads();

    float s[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) s[i] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kd = k_s[t][d];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) s[i] += q_s[grp + kGroups * i][d] * kd;
    }
    const int pos = p0 + t;
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = grp + kGroups * i;
      const int j = (row0 + r) / G;
      const bool valid = r < rows_here && j < ql && pos < len + j + 1;
      const float sv = valid ? s[i] : kNegInf;
      // the 16 lanes of a row group hold one row's 16 positions
      float m_cur = sv;
#pragma unroll
      for (int o = kTile / 2; o > 0; o >>= 1) m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, o));
      const float m_new = fmaxf(m_i[i], m_cur);
      const float alpha = expf(m_i[i] - m_new);
      const float p = valid ? expf(sv - m_new) : 0.f;
      float p_sum = p;
#pragma unroll
      for (int o = kTile / 2; o > 0; o >>= 1) p_sum += __shfl_xor_sync(0xffffffffu, p_sum, o);
      l_i[i] = l_i[i] * alpha + p_sum;
      m_i[i] = m_new;
      p_s[r][t] = p;
      if (t == 0) alpha_s[r] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int m = 0; m < kRowsPerWarp; ++m) {
      const float a = alpha_s[warp + 4 * m];
#pragma unroll
      for (int k = 0; k < kDV; ++k) acc[m][k] *= a;
    }
#pragma unroll 4
    for (int tt = 0; tt < kTile; ++tt) {
      float vcol[kDV];
#pragma unroll
      for (int k = 0; k < kDV; ++k) vcol[k] = v_s[tt][lane + 32 * k];
#pragma unroll
      for (int m = 0; m < kRowsPerWarp; ++m) {
        const float p = p_s[warp + 4 * m][tt];
#pragma unroll
        for (int k = 0; k < kDV; ++k) acc[m][k] += p * vcol[k];
      }
    }
  }

  if (t == 0) {
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) l_s[grp + kGroups * i] = l_i[i];
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < kRowsPerWarp; ++m) {
    const int r = warp + 4 * m;
    if (r >= rows_here) continue;
    const bool valid_row = (row0 + r) / G < ql;
    const float denom = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int k = 0; k < kDV; ++k)
      *out_at(r, lane + 32 * k) = ptt::from_f<T>(valid_row ? acc[m][k] / denom : 0.f);
  }
}

template <typename T, typename KV, bool ROPE>
int launch(const void* q, const void* cos_t, const void* sin_t, const void* kc, const void* vc,
           const void* ks, const void* vs, const void* tables, const void* lens, const void* qlens,
           void* out, int B, int C, int HQ, int HKV, int D, int BS, int MBS, float scale, cudaStream_t st) {
  const dim3 grid((C * (HQ / HKV) + kRows - 1) / kRows, HKV, B);
#define PTT_LAUNCH(DIM)                                                                          \
  paged_chunk_kernel<T, KV, DIM, ROPE><<<grid, kThreads, 0, st>>>(                               \
      static_cast<const T*>(q), static_cast<const T*>(cos_t), static_cast<const T*>(sin_t),      \
      static_cast<const KV*>(kc), static_cast<const KV*>(vc), static_cast<const float*>(ks),     \
      static_cast<const float*>(vs), static_cast<const int*>(tables),                            \
      static_cast<const int*>(lens), static_cast<const int*>(qlens), static_cast<T*>(out), C, HQ, \
      HKV, BS, MBS, scale)
  if (D == 128) {
    PTT_LAUNCH(128);
  } else if (D == 64) {
    PTT_LAUNCH(64);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PTT_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// QUANT: the cache is int8 with scale planes; else it is of q's type
template <bool ROPE, bool QUANT>
int launch_io(int io, const void* q, const void* cos_t, const void* sin_t, const void* kc,
              const void* vc, const void* ks, const void* vs, const void* tables, const void* lens,
              const void* qlens, void* out, int B, int C, int HQ, int HKV, int D, int BS, int MBS,
              float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PTT_IO(TYPE)                                                                             \
  launch<TYPE, std::conditional_t<QUANT, int8_t, TYPE>, ROPE>(q, cos_t, sin_t, kc, vc, ks, vs,   \
                                                              tables, lens, qlens, out, B, C, HQ, \
                                                              HKV, D, BS, MBS, scale, st)
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

// Kernel A. `io` is the storage type (ptt::IoType). Returns
// cudaErrorInvalidValue for a head dim other than 64 or 128 or an unknown type.
extern "C" int ptt_paged_chunk_fused(int io, const void* q, const void* cos_t, const void* sin_t,
                                     const void* kc, const void* vc, const void* tables,
                                     const void* lens, const void* qlens, void* out, int B, int C,
                                     int HQ, int HKV, int D, int BS, int MBS, float scale,
                                     void* stream) {
  return launch_io<true, false>(io, q, cos_t, sin_t, kc, vc, nullptr, nullptr, tables, lens, qlens, out,
                                B, C, HQ, HKV, D, BS, MBS, scale, stream);
}

// Kernel 4: the same walk with q taken as given.
extern "C" int ptt_paged_chunk(int io, const void* q, const void* kc, const void* vc,
                               const void* tables, const void* lens, const void* qlens, void* out,
                               int B, int C, int HQ, int HKV, int D, int BS, int MBS, float scale,
                               void* stream) {
  return launch_io<false, false>(io, q, nullptr, nullptr, kc, vc, nullptr, nullptr, tables, lens, qlens,
                                 out, B, C, HQ, HKV, D, BS, MBS, scale, stream);
}

// Kernel A over the int8 pool: kc/vc int8 [NB, HKV, BS, D], ks/vs fp32
// [NB, HKV, BS]; `io` is the type of q, the rope rows and out.
extern "C" int ptt_paged_chunk_fused_int8(int io, const void* q, const void* cos_t, const void* sin_t,
                                          const void* kc, const void* vc, const void* ks, const void* vs,
                                          const void* tables, const void* lens, const void* qlens,
                                          void* out, int B, int C, int HQ, int HKV, int D, int BS,
                                          int MBS, float scale, void* stream) {
  return launch_io<true, true>(io, q, cos_t, sin_t, kc, vc, ks, vs, tables, lens, qlens, out, B, C, HQ,
                               HKV, D, BS, MBS, scale, stream);
}

// Kernel 4 over the int8 pool.
extern "C" int ptt_paged_chunk_int8(int io, const void* q, const void* kc, const void* vc, const void* ks,
                                    const void* vs, const void* tables, const void* lens,
                                    const void* qlens, void* out, int B, int C, int HQ, int HKV, int D,
                                    int BS, int MBS, float scale, void* stream) {
  return launch_io<false, true>(io, q, nullptr, nullptr, kc, vc, ks, vs, tables, lens, qlens, out, B, C,
                                HQ, HKV, D, BS, MBS, scale, stream);
}
