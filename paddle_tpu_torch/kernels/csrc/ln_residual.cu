// Residual add + LayerNorm (kernel 12) and its adjoint (kernel 13) over the
// last axis of a [rows, H] tensor, bf16, fp16 or fp32, fp32 math.
//
// Replaces: paddle_tpu/kernels/fused.py `_ln_res_fwd_kernel` (launched by
// `fused_layer_norm_residual_pallas`) and `_ln_res_bwd_kernel` (launched by
// `layer_norm_residual_adjoint_pallas`): the `ln_2` of GPT's pre-LN block
// under FLAGS_use_fused_decode_layer, forward and backward.
//
// Forward:  r = x + res in the I/O type (stored), then in fp32
//   mu = mean(r), var = mean((r - mu)^2), y = (r - mu) * rsqrt(var + eps) * w + b,
//   cast once; a null bias counts as zeros.
// Backward, from the saved r (mu and rstd recomputed), x^ = (r - mu) * rstd,
// gw = g * w:
//   dx = rstd * (gw - mean(gw) - x^ * mean(gw * x^))   (in the I/O type)
//   dw = sum over rows of g * x^, db = sum over rows of g (fp32, cast to w's type)
//
// Bound on H100: bytes. At GPT-3 13B's train shape (8192 rows x 5120, bf16)
// the forward reads x, res and writes y, r (335.5 MB, 0.100 ms at 3.35
// TB/s); the backward reads r, g and writes dx (251.7 MB, 0.075 ms), at ~10
// fp32 flops per element, far below the ridge.
//
// Design: every byte of the big tensors crosses device memory once. One
// block of 256 threads per row in the forward; the row's fp32 values stay
// in shared memory (H * 4 bytes, 20 KB at H 5120), so the two-pass mean and
// variance (the Pallas order, no E[r^2] - mu^2 cancellation) and the output
// pass read no byte twice from device memory. Each thread touches only its
// own elements of that buffer, so the only barriers are the block sums'.
// The backward follows kernel 8 (csrc/rms_norm.cu): a block owns a
// contiguous range of rows and keeps fp32 partials of dw and db in shared
// memory (each thread owns fixed columns: no atomics), writes them to an
// fp32 [blocks, 2H] scratch, and ptt::column_sum_kernel adds the partials
// per column in a fixed order, so two runs give the same bits; g and w are
// read twice per row (the mean pass and the dx pass), the second time from
// cache.
#include "common.cuh"

using ptt::bf16;
using ptt::f16;

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float bias_at(const float* b, int c) { return b[c]; }
template <typename T>
__device__ __forceinline__ float bias_at(const T* b, int c) { return ptt::to_f(b[c]); }

// B: the bias's type, T or float (an fp32 bias beside a bf16/fp16 row, read
// as it is, as the Pallas kernel casts it to fp32)
template <typename T, typename B>
__global__ void __launch_bounds__(kThreads)
ln_residual_kernel(const T* __restrict__ x, const T* __restrict__ res, const T* __restrict__ w,
                   const B* __restrict__ b, T* __restrict__ y, T* __restrict__ r, int H, float eps) {
  constexpr int N = 16 / sizeof(T);
  // vals[k * nvec + i] holds element k of vector i in fp32 (no bank conflicts)
  extern __shared__ float vals[];
  __shared__ float scratch[2][32];
  const size_t base = static_cast<size_t>(blockIdx.x) * H;
  const int nvec = H / N;
  float s = 0.f;
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const uint4 xv = ptt::load16(x + base, i), rv = ptt::load16(res + base, i);
    uint4 ov;
    const T* xe = ptt::elems_of<T>(xv);
    const T* re = ptt::elems_of<T>(rv);
    T* oe = ptt::elems_of<T>(ov);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      // the residual add happens in the I/O type, as the Pallas kernel's does
      oe[k] = ptt::from_f<T>(ptt::to_f(xe[k]) + ptt::to_f(re[k]));
      const float f = ptt::to_f(oe[k]);
      vals[k * nvec + i] = f;
      s += f;
    }
    ptt::store16(r + base, i, ov);
  }
  const float mu = ptt::block_sum<kThreads>(s, scratch[0]) / H;
  float v = 0.f;
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float d = vals[k * nvec + i] - mu;
      v += d * d;
    }
  }
  const float rstd = rsqrtf(ptt::block_sum<kThreads>(v, scratch[1]) / H + eps);
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const uint4 wv = ptt::load16(w, i);
    uint4 ov;
    const T* we = ptt::elems_of<T>(wv);
    T* oe = ptt::elems_of<T>(ov);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float bk = b ? bias_at(b, i * N + k) : 0.f;
      oe[k] = ptt::from_f<T>((vals[k * nvec + i] - mu) * rstd * ptt::to_f(we[k]) + bk);
    }
    ptt::store16(y + base, i, ov);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_residual_bwd_kernel(const T* __restrict__ r, const T* __restrict__ w, const T* __restrict__ g,
                       T* __restrict__ dx, float* __restrict__ part, int rows, int H,
                       int rows_per_block, float eps) {
  constexpr int N = 16 / sizeof(T);
  // three fp32 [H] buffers, element k of vector i at k * nvec + i: this
  // row's r, and the block's dw and db partials
  extern __shared__ float smem[];
  float* vals = smem;
  float* dw_acc = smem + H;
  float* db_acc = smem + 2 * H;
  // two reduction buffers used in turn: a warp can only rewrite one after
  // every warp has passed the barrier of the reduction between
  __shared__ float scratch[2][32];
  const int nvec = H / N;
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
#pragma unroll
    for (int k = 0; k < N; ++k) dw_acc[k * nvec + i] = db_acc[k * nvec + i] = 0.f;
  }
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(r0 + rows_per_block, rows);
  int buf = 0;
  for (int row = r0; row < r1; ++row) {
    const size_t base = static_cast<size_t>(row) * H;
    float s = 0.f;
    for (int i = threadIdx.x; i < nvec; i += kThreads) {
      const uint4 rv = ptt::load16(r + base, i);
      const T* re = ptt::elems_of<T>(rv);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float f = ptt::to_f(re[k]);
        vals[k * nvec + i] = f;
        s += f;
      }
    }
    const float mu = ptt::block_sum<kThreads>(s, scratch[buf]) / H;
    buf ^= 1;
    float v = 0.f;
    for (int i = threadIdx.x; i < nvec; i += kThreads) {
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float d = vals[k * nvec + i] - mu;
        v += d * d;
      }
    }
    const float rstd = rsqrtf(ptt::block_sum<kThreads>(v, scratch[buf]) / H + eps);
    buf ^= 1;
    float s1 = 0.f, s2 = 0.f;
    for (int i = threadIdx.x; i < nvec; i += kThreads) {
      const uint4 gv = ptt::load16(g + base, i), wv = ptt::load16(w, i);
      const T* ge = ptt::elems_of<T>(gv);
      const T* we = ptt::elems_of<T>(wv);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const int j = k * nvec + i;
        const float xh = (vals[j] - mu) * rstd, gf = ptt::to_f(ge[k]);
        vals[j] = xh;  // the dx pass reads x^ back
        const float gw = gf * ptt::to_f(we[k]);
        s1 += gw;
        s2 += gw * xh;
        dw_acc[j] += gf * xh;
        db_acc[j] += gf;
      }
    }
    const float m1 = ptt::block_sum<kThreads>(s1, scratch[buf]) / H;
    buf ^= 1;
    const float m2 = ptt::block_sum<kThreads>(s2, scratch[buf]) / H;
    buf ^= 1;
    for (int i = threadIdx.x; i < nvec; i += kThreads) {
      const uint4 gv = ptt::load16(g + base, i), wv = ptt::load16(w, i);
      uint4 ov;
      const T* ge = ptt::elems_of<T>(gv);
      const T* we = ptt::elems_of<T>(wv);
      T* oe = ptt::elems_of<T>(ov);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float gw = ptt::to_f(ge[k]) * ptt::to_f(we[k]);
        oe[k] = ptt::from_f<T>(rstd * (gw - m1 - vals[k * nvec + i] * m2));
      }
      ptt::store16(dx + base, i, ov);
    }
  }
  // this block's partials: dw at [blockIdx.x, 0:H], db at [blockIdx.x, H:2H]
  float* p = part + static_cast<size_t>(blockIdx.x) * 2 * H;
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      p[i * N + k] = dw_acc[k * nvec + i];
      p[H + i * N + k] = db_acc[k * nvec + i];
    }
  }
}

template <typename T, typename B>
int launch_fwd(const void* x, const void* res, const void* w, const void* b, void* y, void* r, int rows,
               int H, float eps, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(H) * sizeof(float);
  const int e = ptt::allow_smem(ln_residual_kernel<T, B>, smem);
  if (e) return e;
  ln_residual_kernel<T, B><<<rows, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), static_cast<const T*>(w),
      static_cast<const B*>(b), static_cast<T*>(y), static_cast<T*>(r), H, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* r, const void* w, const void* g, void* dx, void* dwdb, void* part, int rows,
               int H, int rows_per_block, int nblk, float eps, cudaStream_t stream) {
  const size_t smem = 3 * static_cast<size_t>(H) * sizeof(float);
  int e = ptt::allow_smem(ln_residual_bwd_kernel<T>, smem);
  if (e) return e;
  ln_residual_bwd_kernel<T><<<nblk, kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(w), static_cast<const T*>(g), static_cast<T*>(dx),
      static_cast<float*>(part), rows, H, rows_per_block, eps);
  e = static_cast<int>(cudaGetLastError());
  if (e) return e;
  // dwdb = [dw | db]: the 2H columns of the partials summed in one launch
  return ptt::launch_column_sum<T>(static_cast<const float*>(part), static_cast<T*>(dwdb), nblk, 2 * H, stream);
}

}  // namespace

// io: ptt::IoType of x, res, w, y, r ([rows, H]; w [H]). b: [H] of the
// same type, or fp32 when bias_f32 is 1, or null (zeros). H % 8 == 0,
// 16-byte aligned rows; H * 4 bytes of shared memory per block.
extern "C" int ptt_ln_residual(int io, int bias_f32, const void* x, const void* res, const void* w,
                               const void* b, void* y, void* r, int rows, int H, float eps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (io) {
    case ptt::kBF16:
      return bias_f32 ? launch_fwd<bf16, float>(x, res, w, b, y, r, rows, H, eps, s)
                      : launch_fwd<bf16, bf16>(x, res, w, b, y, r, rows, H, eps, s);
    case ptt::kF16:
      return bias_f32 ? launch_fwd<f16, float>(x, res, w, b, y, r, rows, H, eps, s)
                      : launch_fwd<f16, f16>(x, res, w, b, y, r, rows, H, eps, s);
    case ptt::kF32: return launch_fwd<float, float>(x, res, w, b, y, r, rows, H, eps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// r, g, dx: [rows, H]; w: [H]; dwdb: [2, H] (dw, then db) in the I/O type;
// part: [nblk, 2H] fp32 scratch, nblk = ceil(rows / rows_per_block).
// 3 * H * 4 bytes of shared memory per block, at most 227 KB.
extern "C" int ptt_ln_residual_bwd(int io, const void* r, const void* w, const void* g, void* dx, void* dwdb,
                                   void* part, int rows, int H, int rows_per_block, int nblk, float eps,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (io) {
    case ptt::kBF16: return launch_bwd<bf16>(r, w, g, dx, dwdb, part, rows, H, rows_per_block, nblk, eps, s);
    case ptt::kF16: return launch_bwd<f16>(r, w, g, dx, dwdb, part, rows, H, rows_per_block, nblk, eps, s);
    case ptt::kF32: return launch_bwd<float>(r, w, g, dx, dwdb, part, rows, H, rows_per_block, nblk, eps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
