// RMSNorm forward and backward over the last axis of a [rows, H] tensor,
// bf16, fp16 or fp32, fp32 math; and the adjoint of the residual RMSNorm.
//
// Replaces: paddle_tpu/kernels/fused.py `_rms_fwd_kernel` (forward, saves
// rstd; launched by `_make_rms` for `fused_rms_norm_pallas`) and
// `_rms_bwd_kernel` (dx and dw), the norms of the training forward, its
// recompute and its backward; and `_rms_res_bwd_kernel` (launched by
// `rms_norm_residual_adjoint_pallas`), the backward of
// `fused_rms_norm_residual`, which takes the saved residual stream r and
// recomputes rstd from it instead of reading a saved one.
//
// Forward: y = (x * rstd * w) in fp32, cast once (the weight multiplied
// before the downcast, the Pallas order); rstd = rsqrt(mean(x^2) + eps) is
// written per row in fp32 for the backward.
// Backward: x^ = x * rstd, gw = g * w,
//   dx = rstd * (gw - x^ * mean(gw * x^))   (in x's type)
//   dw = sum over rows of g * x^            (fp32, cast to w's type)
// The residual adjoint is the same with x = r and rstd = rsqrt(mean(r^2) +
// eps) recomputed per row (one more pass over the row, cache-resident).
//
// Bound on H100: bytes. At the 7B train shape (8192 rows x 4096, bf16) the
// forward reads x and writes y (~134 MB), the backward reads x and g and
// writes dx (~201 MB), at a few fp32 flops per element; the residual
// adjoint moves the same bytes (r, g in, dx out).
//
// Forward design, two routes; the wrapper's plan (kernels/fused.py
// `rms_fwd_plan`, a host function of H and the type)
// picks one and its shape:
// - registers (`rms_fwd_kernel_regs`): the row width is known per instance,
//   V 16-byte vectors a lane (V = 1..16). A group of W warps (4 where the
//   row's vectors allow, else 2 or 1) owns a row: each of its lanes issues
//   all V loads of its share of the row at once (streaming loads: x is read
//   once), keeps them in registers, reduces the sum of squares (warp
//   shuffles, then shared memory across the group's warps), and writes y
//   from those registers (streaming stores), with its share of w loaded
//   into registers beside them. At H 4096 in bf16 that is V = 4: 16
//   registers of x and 16 of w a lane, so an SM keeps many rows in flight.
//   The widest split is the fastest on an H100 (chip_smoke.py's
//   `rms_norm_fwd_rows` times the train shape at 1, 2 and 4 warps a row):
//   fewer, wider warps keep fewer loads in flight, and walking several
//   rows a warp with w held in registers saved L2 reads of w but lost
//   more to the same.
// - loop (`rms_fwd_kernel_loop`): a width with no register instance (not a
//   whole number of vectors per lane, or more than 16): one warp per row,
//   a warp-shuffle sum of squares over a runtime H / 8, then a second pass
//   that re-reads the row (cache-resident) to write y; 8 rows per block.
// Both bound-check the ragged last rows (Pallas pads rows to its block).
//
// Backward design: the Pallas kernel adds dw into one output block across
// its sequential grid; blocks here run in parallel and in no order, so each
// block owns a contiguous range of rows and keeps its own fp32 dw partial
// in shared memory (each thread owns fixed columns: no races, no atomics),
// then writes it to a [blocks, H] fp32 scratch. A second kernel
// (ptt::column_sum_kernel) sums the partials per column in a fixed order.
// Both orders are fixed by the shape and the card's SM count, so two runs
// give the same bits.
#include "common.cuh"

using ptt::bf16;
using ptt::f16;

namespace {

constexpr int kFwdRows = 8;  // the loop route: rows (warps) per block
constexpr int kFwdWarps = 4;  // the register route: warps per block
constexpr int kFwdMaxVecs = 16;  // the register route: 16-byte vectors a lane holds, at most
constexpr int kBwdThreads = 256;

// The register route: V vectors of x a lane, W warps a row (the block holds
// kFwdWarps / W rows). Vector j of warp `part` of the row's group covers
// the row's 16-byte vectors (j W + part) 32 + lane: each load instruction of
// a warp reads 512 contiguous bytes.
template <typename T, int V>
__global__ void __launch_bounds__(kFwdWarps * 32)
rms_fwd_kernel_regs(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
                    float* __restrict__ rstd_out, int rows, int H, int W, float eps) {
  constexpr int N = 16 / sizeof(T);
  __shared__ float red[kFwdWarps];  // the group's partial sums
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int part = warp % W;
  const int row = blockIdx.x * (kFwdWarps / W) + warp / W;
  const bool valid = row < rows;  // the same in every warp of a group
  const size_t base = static_cast<size_t>(valid ? row : 0) * H / N;
  uint4 xv[V], wv[V];
  float ss = 0.f;
  if (valid) {
    const uint4* src = reinterpret_cast<const uint4*>(x) + base;
    const uint4* wsrc = reinterpret_cast<const uint4*>(w);
#pragma unroll
    for (int j = 0; j < V; ++j) xv[j] = __ldcs(src + (j * W + part) * 32 + lane);
#pragma unroll
    for (int j = 0; j < V; ++j) wv[j] = wsrc[(j * W + part) * 32 + lane];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const T* e = ptt::elems_of<T>(xv[j]);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float f = ptt::to_f(e[i]);
        ss += f * f;
      }
    }
  }
  ss = ptt::warp_sum(ss);
  if (W > 1) {  // every warp of the block reaches the barrier, valid row or not
    if (lane == 0) red[warp] = ss;
    __syncthreads();
    ss = 0.f;
    for (int i = warp - part; i < warp - part + W; ++i) ss += red[i];
  }
  if (!valid) return;
  const float rstd = rsqrtf(ss / H + eps);
  uint4* dst = reinterpret_cast<uint4*>(y) + base;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const T* xe = ptt::elems_of<T>(xv[j]);
    const T* we = ptt::elems_of<T>(wv[j]);
    uint4 ov;
    T* oe = ptt::elems_of<T>(ov);
#pragma unroll
    for (int i = 0; i < N; ++i) oe[i] = ptt::from_f<T>(ptt::to_f(xe[i]) * rstd * ptt::to_f(we[i]));
    __stcs(dst + (j * W + part) * 32 + lane, ov);
  }
  if (part == 0 && lane == 0) rstd_out[row] = rstd;
}

template <typename T>
__global__ void __launch_bounds__(kFwdRows * 32)
rms_fwd_kernel_loop(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
                    float* __restrict__ rstd_out, int rows, int H, float eps) {
  constexpr int N = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kFwdRows + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps only: no block-wide barrier below
  const size_t base = static_cast<size_t>(row) * H;
  const int nvec = H / N;
  float ss = 0.f;
  for (int i = lane; i < nvec; i += 32) {
    const uint4 v = ptt::load16(x + base, i);
    const T* e = ptt::elems_of<T>(v);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float f = ptt::to_f(e[k]);
      ss += f * f;
    }
  }
  const float rstd = rsqrtf(ptt::warp_sum(ss) / H + eps);
  for (int i = lane; i < nvec; i += 32) {
    const uint4 xv = ptt::load16(x + base, i), wv = ptt::load16(w, i);
    uint4 ov;
    const T* xe = ptt::elems_of<T>(xv);
    const T* we = ptt::elems_of<T>(wv);
    T* oe = ptt::elems_of<T>(ov);
#pragma unroll
    for (int k = 0; k < N; ++k) oe[k] = ptt::from_f<T>(ptt::to_f(xe[k]) * rstd * ptt::to_f(we[k]));
    ptt::store16(y + base, i, ov);
  }
  if (lane == 0) rstd_out[row] = rstd;
}

// kRecompute: rstd is null and each row's rstd is recomputed from x (the
// residual adjoint, kernel 11); otherwise it is read (kernel 8).
template <typename T, bool kRecompute>
__global__ void __launch_bounds__(kBwdThreads)
rms_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ rstd,
               const T* __restrict__ g, T* __restrict__ dx, float* __restrict__ dw_part,
               int rows, int H, int rows_per_block, float eps) {
  constexpr int N = 16 / sizeof(T);
  // dw_acc[k * nvec + i] holds element k of vector i: neighbouring threads
  // touch neighbouring words (no bank conflicts)
  extern __shared__ float dw_acc[];
  // two reduction buffers used in turn: a warp can only rewrite one after
  // every warp has passed the barrier of the reduction between
  __shared__ float scratch[2][32];
  const int nvec = H / N;
  for (int i = threadIdx.x; i < nvec; i += kBwdThreads) {
#pragma unroll
    for (int k = 0; k < N; ++k) dw_acc[k * nvec + i] = 0.f;
  }
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(r0 + rows_per_block, rows);
  int buf = 0;
  for (int row = r0; row < r1; ++row) {
    const size_t base = static_cast<size_t>(row) * H;
    float rs;
    if constexpr (kRecompute) {
      float ss = 0.f;
      for (int i = threadIdx.x; i < nvec; i += kBwdThreads) {
        const uint4 xv = ptt::load16(x + base, i);
        const T* xe = ptt::elems_of<T>(xv);
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float f = ptt::to_f(xe[k]);
          ss += f * f;
        }
      }
      rs = rsqrtf(ptt::block_sum<kBwdThreads>(ss, scratch[buf]) / H + eps);
      buf ^= 1;
    } else {
      rs = rstd[row];
    }
    float dot = 0.f;
    for (int i = threadIdx.x; i < nvec; i += kBwdThreads) {
      const uint4 xv = ptt::load16(x + base, i), gv = ptt::load16(g + base, i), wv = ptt::load16(w, i);
      const T* xe = ptt::elems_of<T>(xv);
      const T* ge = ptt::elems_of<T>(gv);
      const T* we = ptt::elems_of<T>(wv);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float xh = ptt::to_f(xe[k]) * rs, gf = ptt::to_f(ge[k]);
        dot += gf * ptt::to_f(we[k]) * xh;
        dw_acc[k * nvec + i] += gf * xh;
      }
    }
    const float mean = ptt::block_sum<kBwdThreads>(dot, scratch[buf]) / H;
    buf ^= 1;
    for (int i = threadIdx.x; i < nvec; i += kBwdThreads) {
      const uint4 xv = ptt::load16(x + base, i), gv = ptt::load16(g + base, i), wv = ptt::load16(w, i);
      uint4 ov;
      const T* xe = ptt::elems_of<T>(xv);
      const T* ge = ptt::elems_of<T>(gv);
      const T* we = ptt::elems_of<T>(wv);
      T* oe = ptt::elems_of<T>(ov);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float xh = ptt::to_f(xe[k]) * rs, gw = ptt::to_f(ge[k]) * ptt::to_f(we[k]);
        oe[k] = ptt::from_f<T>(rs * (gw - xh * mean));
      }
      ptt::store16(dx + base, i, ov);
    }
  }
  float* part = dw_part + static_cast<size_t>(blockIdx.x) * H;
  for (int i = threadIdx.x; i < nvec; i += kBwdThreads) {
#pragma unroll
    for (int k = 0; k < N; ++k) part[i * N + k] = dw_acc[k * nvec + i];
  }
}

template <typename T, int V>
int launch_regs(const void* x, const void* w, void* y, void* rstd, int rows, int H, int W, float eps,
                cudaStream_t stream) {
  const int blocks = (rows + kFwdWarps / W - 1) / (kFwdWarps / W);
  rms_fwd_kernel_regs<T, V><<<blocks, kFwdWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), static_cast<float*>(rstd), rows, H,
      W, eps);
  return static_cast<int>(cudaGetLastError());
}

// vecs 0: the loop route (8 rows a block); else the register instance of
// `vecs` vectors a lane, W warps a row
template <typename T>
int launch_fwd(const void* x, const void* w, void* y, void* rstd, int rows, int H, int vecs, int W, float eps,
               cudaStream_t stream) {
  if (vecs == 0) {
    rms_fwd_kernel_loop<T><<<(rows + kFwdRows - 1) / kFwdRows, kFwdRows * 32, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
        static_cast<float*>(rstd), rows, H, eps);
    return static_cast<int>(cudaGetLastError());
  }
  const int n = 16 / static_cast<int>(sizeof(T));
  if (vecs > kFwdMaxVecs || (W != 1 && W != 2 && W != 4) || H != vecs * W * 32 * n)
    return static_cast<int>(cudaErrorInvalidValue);
#define PTT_V(NV) \
  case NV: return launch_regs<T, NV>(x, w, y, rstd, rows, H, W, eps, stream)
  switch (vecs) {
    PTT_V(1); PTT_V(2); PTT_V(3); PTT_V(4); PTT_V(5); PTT_V(6); PTT_V(7); PTT_V(8);
    PTT_V(9); PTT_V(10); PTT_V(11); PTT_V(12); PTT_V(13); PTT_V(14); PTT_V(15); PTT_V(16);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PTT_V
}

template <typename T, bool kRecompute>
int launch_bwd(const void* x, const void* w, const void* rstd, const void* g, void* dx, void* dw,
               void* dw_part, int rows, int H, int rows_per_block, int nblk, float eps, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(H) * sizeof(float);
  int e = ptt::allow_smem(rms_bwd_kernel<T, kRecompute>, smem);
  if (e) return e;
  rms_bwd_kernel<T, kRecompute><<<nblk, kBwdThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(rstd),
      static_cast<const T*>(g), static_cast<T*>(dx), static_cast<float*>(dw_part), rows, H,
      rows_per_block, eps);
  e = static_cast<int>(cudaGetLastError());
  if (e) return e;
  return ptt::launch_column_sum<T>(static_cast<const float*>(dw_part), static_cast<T*>(dw), nblk, H, stream);
}

}  // namespace

// x, y: [rows, H] of the I/O type `io` (ptt::IoType); w: [H], same type;
// rstd: [rows] fp32. H % 8 == 0, 16-byte aligned rows. The plan (fused.py
// `rms_fwd_plan`): vecs 0 takes the loop route; else vecs vectors a lane and
// `warps_per_row` (1, 2, 4) warps a row, with H == vecs * warps_per_row *
// 32 * (16 / element size); anything else returns cudaErrorInvalidValue.
extern "C" int ptt_rms_norm_fwd(int io, const void* x, const void* w, void* y, void* rstd, int rows, int H,
                                int vecs, int warps_per_row, float eps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (io) {
    case ptt::kBF16: return launch_fwd<bf16>(x, w, y, rstd, rows, H, vecs, warps_per_row, eps, s);
    case ptt::kF16: return launch_fwd<f16>(x, w, y, rstd, rows, H, vecs, warps_per_row, eps, s);
    case ptt::kF32: return launch_fwd<float>(x, w, y, rstd, rows, H, vecs, warps_per_row, eps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x, g, dx: [rows, H]; w, dw: [H]; rstd: [rows] fp32; dw_part: [nblk, H]
// fp32 scratch, nblk = ceil(rows / rows_per_block). H * 4 bytes of shared
// memory per block, at most 227 KB.
extern "C" int ptt_rms_norm_bwd(int io, const void* x, const void* w, const void* rstd,
                                const void* g, void* dx, void* dw, void* dw_part, int rows, int H,
                                int rows_per_block, int nblk, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (io) {
    case ptt::kBF16: return launch_bwd<bf16, false>(x, w, rstd, g, dx, dw, dw_part, rows, H, rows_per_block, nblk, 0.f, s);
    case ptt::kF16: return launch_bwd<f16, false>(x, w, rstd, g, dx, dw, dw_part, rows, H, rows_per_block, nblk, 0.f, s);
    case ptt::kF32: return launch_bwd<float, false>(x, w, rstd, g, dx, dw, dw_part, rows, H, rows_per_block, nblk, 0.f, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The residual RMSNorm's adjoint (kernel 11): r, g, dx: [rows, H]; w, dw:
// [H]; dw_part: [nblk, H] fp32 scratch as for ptt_rms_norm_bwd; rstd is
// recomputed per row from r with eps.
extern "C" int ptt_rms_residual_bwd(int io, const void* r, const void* w, const void* g, void* dx,
                                    void* dw, void* dw_part, int rows, int H, int rows_per_block,
                                    int nblk, float eps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (io) {
    case ptt::kBF16: return launch_bwd<bf16, true>(r, w, nullptr, g, dx, dw, dw_part, rows, H, rows_per_block, nblk, eps, s);
    case ptt::kF16: return launch_bwd<f16, true>(r, w, nullptr, g, dx, dw, dw_part, rows, H, rows_per_block, nblk, eps, s);
    case ptt::kF32: return launch_bwd<float, true>(r, w, nullptr, g, dx, dw, dw_part, rows, H, rows_per_block, nblk, eps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
