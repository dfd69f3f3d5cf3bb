// The fp32 flash-attention forward (kernel 14) on the tensor cores, at head
// dims 64 to 256: fp32 accuracy from TF32 products by splitting each operand
// in two (3xTF32). fp32 dq and dk/dv, and the fp32 forward at 320 to 512,
// stay on flash_fp32.cu's CUDA-core walks; fp32 above 512 runs flash_deep.cu.
//
// Replaces: paddle_tpu/kernels/flash_attention.py `_fwd_kernel` (launched by
// `_run_fwd`) for fp32 q, k, v up to head dim 256.
//
// Semantics kept (see flash_fwd.cu): q is scaled before q k^T; FlashMask tile
// classes (flash_common.cuh `warp_tile_class`, computed by every warp alike,
// so the block agrees) skip SKIP tiles (no copy, no product) and run FULL
// tiles without the mask; a row whose every logit is masked is written as 0
// with lse = +inf; GQA query head h reads KV head h / (H / HK). out is fp32,
// lse fp32.
//
// The arithmetic (tf32.cuh). A TF32 mma.sync reads 19 bits of each fp32
// register (the low 13 are ignored), so one TF32 product misses an fp32 gate
// by ~2^-11. Each operand x is split as hi = rna_tf32(x), lo = rna_tf32(x -
// hi) (x - hi is exact in fp32, and hi is exactly what the tensor core
// reads), and a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi: the dropped a_lo b_lo
// and the rounding of lo cost ~2^-22 of |a b|. The two small cross terms are summed
// before a_hi b_hi, as CUTLASS's OpMultiplyAddFastF32 does: in P V into the
// same accumulator, cross terms first at every k step, each 32 keys' P V
// in a zeroed partial added to O by FADD (the tensor cores' fp32
// accumulation rounds toward zero: chained through O over the walk it left
// the output at 0.32-0.54 of the fp32 gate's limit, against 0.07-0.17 with
// the partials, for ~1% more time at D 128 and 25% at D 256 on an H100,
// chip_smoke.py's fp32 flash cases); in q k^T, whose sum
// over D is one serial chain of mma a key column, into an accumulator of
// their own, added to the hi hi one at the end (two independent chains, and
// at D 128 each split in two by alternating k steps). Both products (q k^T
// and P V) take the three passes; the softmax statistics stay fp32 on the
// CUDA cores with expf.
//
// Design (simple first). A CTA of 4 warps owns 64 query rows (16 a warp, one
// m16 tile) of one (head, batch), so every K/V tile staged feeds 64 rows;
// causal walks run the longest query tiles first. Key tiles of BN keys
// (tf32_plan: 64 where two CTAs fit an SM, else 32) of K and V come into
// fp32 shared memory by cp.async (16 bytes a thread, zero past Sk), two
// buffers: the next visited tile's copies fly while this one is computed.
// q * scale stays in shared memory for the whole walk. Fragment layouts
// (m16n8k8 .tf32, lane = 4 g + t): A a0 (g, t), a1 (g+8, t), a2 (g, t+4),
// a3 (g+8, t+4); B b0 (k t, n g), b1 (k t+4, n g); C c0 (g, 2t), c1 (g, 2t+1),
// c2 (g+8, 2t), c3 (g+8, 2t+1). A product sums over k in any order, so each
// 8-wide k step takes its k indices permuted:
// - q k^T: k index t is column 2t of the step, t+4 column 2t+1, so a thread
//   reads q's and K's two values as one float2 (rows of D + 8 floats: every
//   half-warp's 8-byte loads hit distinct banks);
// - P V: k index t is key 2t of the step, t+4 key 2t+1, which is where the
//   accumulator layout left P: a = (c0, c2, c1, c3) of the S tile, no
//   shuffle; V's b0 / b1 are keys 2t / 2t+1 of column g (rows of D + 4
//   floats: conflict-free).
// Per 64-row tile and BN keys a warp issues 3 x (BN/8) x (D/8) mma for each
// product. q k^T as a single chain of 3 D / 8 dependent mma a key column (4
// columns a warp at 32 keys) left the walk bound by the mma latency on an
// H100, hence the separate accumulators above.
//
// Bound on H100: operations at the TF32 tensor peak (494.7 TFLOP/s dense),
// three passes of each product's 2 D flops a visible (row, key) pair; at
// fp32's 67 TFLOP/s on the CUDA cores, one pass. mma.sync reaches a fraction
// of the wgmma peak, and every B value is split by each warp that reads it.
#include "flash_common.cuh"
#include "tf32.cuh"

namespace fl = ptt::flash;
using ptt::tf32::mma_3x;
using ptt::tf32::split;
namespace hp = ptt::hopper;

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kRows = 64;      // query rows of a CTA, 16 a warp
constexpr int kSmemPerSm = 228 * 1024, kSmemPerBlock = 227 * 1024, kReserved = 1024;

// the CTA's dynamic shared memory at head dim D and BN keys a tile: q (64
// rows), two K and two V tiles, fp32, rows padded
__host__ __device__ constexpr int tf32_smem(int D, int BN) {
  return 4 * (kRows * (D + 8) + 2 * BN * (D + 8) + 2 * BN * (D + 4));
}

// keys a tile: 64 where two CTAs of it fit an SM, else 32
__host__ __device__ constexpr int tf32_keys(int D) {
  return 2 * (tf32_smem(D, 64) + kReserved) <= kSmemPerSm ? 64 : 32;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel_tf32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                      const int* __restrict__ bounds, float* __restrict__ out, float* __restrict__ lse, int Sq,
                      int Sk, int H, int HK, int Hm, int C, int causal, float scale) {
  constexpr int BN = tf32_keys(D), NT = BN / 8, DT = D / 8;
  // k phases of q k^T: two where the tile's accumulators leave registers for them (D 128: NT 4)
  constexpr int U = (NT >= 8 || D > 128) ? 1 : 2;
  // k steps of P V summed in one partial (32 keys: the whole tile, half of D 64's), P's split fragments of
  // the group held across O's columns: 8 of them, D 64's whole tile, spill
  constexpr int PG = 4;
  static_assert(NT % PG == 0, "whole groups of k steps");
  constexpr int LQ = D + 8, LK = D + 8, LV = D + 4;
  extern __shared__ __align__(16) float smf[];
  float* q_s = smf;                 // [64][LQ], q * scale
  float* k_s = q_s + kRows * LQ;    // [2][BN][LK]
  float* v_s = k_s + 2 * BN * LK;   // [2][BN][LV]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int n_qt = (Sq + kRows - 1) / kRows;
  const int qt = causal ? n_qt - 1 - static_cast<int>(blockIdx.x) : static_cast<int>(blockIdx.x);
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / HK);
  const int r0 = qt * kRows;
  const size_t q_stride = static_cast<size_t>(H) * D, kv_stride = static_cast<size_t>(HK) * D;
  const float* qb = q + (static_cast<size_t>(b) * Sq * H + h) * D;
  const float* kb = k + (static_cast<size_t>(b) * Sk * HK + hk) * D;
  const float* vb = v + (static_cast<size_t>(b) * Sk * HK + hk) * D;
  const int* bb = C ? bounds + (static_cast<size_t>(b) * Hm + (Hm == 1 ? 0 : h)) * Sk * C : nullptr;

  for (int i = threadIdx.x; i < kRows * D / 4; i += kThreads) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < Sq) x = *reinterpret_cast<const float4*>(qb + static_cast<size_t>(r0 + r) * q_stride + c);
    *reinterpret_cast<float4*>(q_s + r * LQ + c) =
        make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
  }

  float o[DT][4], m[2] = {-fl::kInf, -fl::kInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  const int row_a = r0 + 16 * warp + g, row_b = row_a + 8;

  const int hi_t = fl::walk_end(r0, kRows, BN, Sq, Sk, causal);
  fl::TileBounds<BN> tb;
  // the first visited tile at or after t (hi_t if none), its class in cls
  const auto next = [&](int t, int& cls) {
    for (; t < hi_t; ++t) {
      cls = fl::warp_tile_class<BN>(tb, bb, C, r0, kRows, t * BN, Sq, Sk, causal, lane);
      if (cls != fl::kSkip) return t;
    }
    return hi_t;
  };
  const auto issue = [&](int t, int buf) {
    fl::stage_rows<BN, D, LK, kThreads>(k_s + buf * BN * LK, kb, kv_stride, t * BN, Sk);
    fl::stage_rows<BN, D, LV, kThreads>(v_s + buf * BN * LV, vb, kv_stride, t * BN, Sk);
  };
  int cls = fl::kSkip;
  int t = next(0, cls);
  if (t < hi_t) issue(t, 0);
  hp::cp_async_commit();
  int buf = 0;
  while (t < hi_t) {
    int cls_n = fl::kSkip;
    const int tn = next(t + 1, cls_n);
    if (tn < hi_t) issue(tn, buf ^ 1);
    hp::cp_async_commit();
    hp::cp_async_wait_group<1>();  // tile t's copies have landed (tile tn's may fly)
    __syncthreads();   // ...for every thread, and q is staged
    const float* ks = k_s + buf * BN * LK;
    const float* vs = v_s + buf * BN * LV;
    const int c0 = t * BN;

    // S = (q * scale) K^T, 16 rows x BN keys a warp: the cross terms and hi hi in accumulators of their
    // own (summed at the end, cross terms first), over U interleaved k phases: 2 U chains of mma a tile
    float sc[U][NT][4], sb[U][NT][4];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[u][n][e] = sb[u][n][e] = 0.f;
    const float* qa = q_s + (16 * warp + g) * LQ + 2 * t4;
#pragma unroll 2
    for (int k0 = 0; k0 < DT; k0 += U) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int kk = k0 + u;
        const float2 xa = *reinterpret_cast<const float2*>(qa + 8 * kk);
        const float2 xb = *reinterpret_cast<const float2*>(qa + 8 * LQ + 8 * kk);
        uint32_t ah[4], al[4];
        split(xa.x, ah[0], al[0]);
        split(xb.x, ah[1], al[1]);
        split(xa.y, ah[2], al[2]);
        split(xb.y, ah[3], al[3]);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float2 kv2 = *reinterpret_cast<const float2*>(ks + (8 * n + g) * LK + 8 * kk + 2 * t4);
          uint32_t bh0, bl0, bh1, bl1;
          split(kv2.x, bh0, bl0);
          split(kv2.y, bh1, bl1);
          ptt::tf32::mma(sc[u][n], al, bh0, bh1);
          ptt::tf32::mma(sc[u][n], ah, bl0, bl1);
          ptt::tf32::mma(sb[u][n], ah, bh0, bh1);
        }
      }
    }
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float c = sc[0][n][e], h = sb[0][n][e];
#pragma unroll
        for (int u = 1; u < U; ++u) c += sc[u][n][e], h += sb[u][n][e];
        s[n][e] = c + h;
      }
    if (cls == fl::kPartial) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c0 + 8 * n + 2 * t4 + e;
          int bnd[4] = {0, 0, 0, 0};
          if (C && col < Sk) {
            for (int x = 0; x < C; ++x) bnd[x] = bb[static_cast<size_t>(col) * C + x];
          }
          if (fl::masked(row_a, col, Sq, Sk, causal, bnd, C)) s[n][e] = -fl::kInf;
          if (fl::masked(row_b, col, Sq, Sk, causal, bnd, C)) s[n][2 + e] = -fl::kInf;
        }
      }
    }
    // online softmax of rows a (s[.][0..1]) and b (s[.][2..3]); a row's columns lie in a quad
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -fl::kInf;
#pragma unroll
      for (int n = 0; n < NT; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const bool none = m_new == -fl::kInf;
      alpha[r] = none ? 1.f : expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = none ? 0.f : expf(s[n][2 * r + e] - m_new);
          s[n][2 * r + e] = p;
          sum += p;
        }
      }
      m[r] = m_new;
      l[r] = l[r] * alpha[r] + sum;  // this thread's columns; summed over the quad at the end
    }
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      o[j][0] *= alpha[0], o[j][1] *= alpha[0];
      o[j][2] *= alpha[1], o[j][3] *= alpha[1];
    }
    // O += P V: k step n takes keys 8n + 2t (k index t) and 8n + 2t + 1 (t + 4). The tensor core's fp32
    // accumulation rounds toward zero, and chained through o over the whole walk its bias would grow with
    // the walk's length: each group of PG k steps goes into a zeroed partial that one FADD a value adds to o
#pragma unroll
    for (int n0 = 0; n0 < NT; n0 += PG) {
      uint32_t ph[PG][4], pl[PG][4];
#pragma unroll
      for (int i = 0; i < PG; ++i) {
        split(s[n0 + i][0], ph[i][0], pl[i][0]);
        split(s[n0 + i][2], ph[i][1], pl[i][1]);
        split(s[n0 + i][1], ph[i][2], pl[i][2]);
        split(s[n0 + i][3], ph[i][3], pl[i][3]);
      }
      const float* v0 = vs + (8 * n0 + 2 * t4) * LV + g;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int i = 0; i < PG; ++i) {
          uint32_t bh0, bl0, bh1, bl1;
          split(v0[8 * i * LV + 8 * j], bh0, bl0);
          split(v0[(8 * i + 1) * LV + 8 * j], bh1, bl1);
          mma_3x(part, ph[i], pl[i], bh0, bh1, bl0, bl1);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][e] += part[e];
      }
    }
    __syncthreads();  // every warp is done with this buffer before the next tile's copies go there
    t = tn, cls = cls_n, buf ^= 1;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int row = r ? row_b : row_a;
    if (row >= Sq) continue;
    const bool seen = lt > 0.f;
    const float inv = seen ? 1.f / lt : 0.f;
    float* orow = out + (static_cast<size_t>(b) * Sq + row) * q_stride + static_cast<size_t>(h) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j) = make_float2(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
    if (t4 == 0) lse[(static_cast<size_t>(b) * H + h) * Sq + row] = seen ? m[r] + logf(lt) : fl::kInf;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* bounds, void* out, void* lse, int B, int Sq,
           int Sk, int H, int HK, int Hm, int C, int causal, float scale, cudaStream_t stream) {
  constexpr int kSmem = tf32_smem(D, tf32_keys(D));
  static_assert(kSmem <= kSmemPerBlock, "a block's shared memory");
  auto kernel = flash_fwd_kernel_tf32<D>;
  const int err = ptt::allow_smem(kernel, kSmem);
  if (err) return err;
  const dim3 grid((Sq + kRows - 1) / kRows, H, B);
  kernel<<<grid, kThreads, kSmem, stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                            static_cast<const float*>(v), static_cast<const int*>(bounds),
                                            static_cast<float*>(out), static_cast<float*>(lse), Sq, Sk, H, HK, Hm,
                                            C, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The fp32 forward on the tensor cores: flash_fwd.cu's entry arguments with
// q, k, v and out fp32, at head dims 64, 128, 192 and 256 (the scheduler
// counter goes unused). Another head dim returns cudaErrorInvalidValue.
extern "C" int ptt_flash_fwd_tf32x3(const void* q, const void* k, const void* v, const void* bounds, void* out,
                                    void* lse, void* /*sched: unused*/, int B, int Sq, int Sk, int H, int HK, int D,
                                    int Hm, int C, int causal, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(q, k, v, bounds, out, lse, B, Sq, Sk, H, HK, Hm, C, causal, scale, s);
    case 128: return launch<128>(q, k, v, bounds, out, lse, B, Sq, Sk, H, HK, Hm, C, causal, scale, s);
    case 192: return launch<192>(q, k, v, bounds, out, lse, B, Sq, Sk, H, HK, Hm, C, causal, scale, s);
    case 256: return launch<256>(q, k, v, bounds, out, lse, B, Sq, Sk, H, HK, Hm, C, causal, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The fp32 forward's plan at head dim D (kernels/flash_attention.py
// `flash_fwd_fp32_plan` mirrors it; chip_smoke.py holds the two equal):
// out[0] the walk (0 this file's 3xTF32 walk, D 64-256; 1 flash_fp32.cu's
// CUDA-core walk, D 320-512), then for this file's walk the query rows and
// keys of a tile, the buffers of the K/V ring and the CTA's dynamic
// shared-memory bytes (0 for the CUDA-core walk, whose geometry is
// flash_fp32.cu's). Returns cudaErrorInvalidValue for a head dim that
// neither walk takes.
extern "C" int ptt_flash_fwd_fp32_plan(int D, int* out) {
  if (D <= 0 || D % 64 || D > 512) return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 256) {
    const int bn = tf32_keys(D);
    out[0] = 0, out[1] = kRows, out[2] = bn, out[3] = 2, out[4] = tf32_smem(D, bn);
  } else {
    out[0] = 1, out[1] = out[2] = out[3] = out[4] = 0;
  }
  return 0;
}
