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
// TB/s); the backward reads r, g and writes dx (251.7 MB, 0.075 ms), at ~14
// fp32 flops per element, far below the ridge.
//
// Forward design: every byte of the big tensors crosses device memory once.
// One block of 256 threads per row; the row's fp32 values stay in shared
// memory (H * 4 bytes, 20 KB at H 5120), so the two-pass mean and variance
// (the Pallas order, no E[r^2] - mu^2 cancellation) and the output pass read
// no byte twice from device memory.
//
// Backward design, two routes; the wrapper's plan (kernels/fused.py
// `ln_bwd_plan`, a host function of H and the type) picks one and its shape.
// Both keep the Pallas kernel's sequential dw / db sum deterministic: a
// block owns a contiguous range of rows and keeps fp32 partials of dw and db
// for fixed columns, writes them to an fp32 [blocks, 2H] scratch, and
// ptt::column_sum_kernel adds the partials per column in a fixed order, so
// two runs give the same bits.
// - registers (`ln_residual_bwd_kernel_regs`, the main path): a block of W
//   warps (4 where the row's vectors allow, 8 where 4 would take more than
//   kBwdMaxVecs vectors a lane, else 2 or 1) walks its rows one at a time;
//   lane l of warp p holds the row's 16-byte vectors (j W + p) 32 + l, j < V
//   (V = 5 at H 5120 bf16: 40 elements), of r and g in registers, w's
//   beside them (loaded once), and the dw and db partials of those columns
//   in fp32 registers. The next two rows' r and g stream into a ring of two
//   shared-memory stages by cp.async.bulk (one elected thread, completion
//   on an mbarrier), issued as soon as every warp has read the stage, so
//   two rows are in flight while one reduces. Three block sums a row: the
//   mean, the variance on the register row (two passes, as Pallas), and
//   (sum gw, sum gw x^) as one two-value sum. Shared memory is the ring
//   (two stages of r and g: 4 H elements of the I/O type, 40 KB at H 5120
//   bf16) and the sums; registers set the occupancy (ptxas gives V 5 and
//   6 255 registers a thread: 2 blocks of 4 warps an SM, 4 rows in
//   flight). At H 5120 bf16 on an H100 80GB HBM3 at 700 W it takes 64.5%
//   of the bound where the loop route takes 37% (PERF.md §6).
// - loop (`ln_residual_bwd_kernel`, the other widths: not a whole number of
//   vectors a lane, or more than kBwdMaxVecs): 256 threads a row over a
//   runtime H, with the row's fp32 values and the block's dw and db partials
//   in shared memory (3 H * 4 bytes), g and w read twice a row.
#include "common.cuh"
#include "hopper.cuh"

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

// The register route: V vectors of r and g a lane, W = blockDim.x / 32
// warps a row (see the header). part: this block's dw at [block, 0:H] and
// db at [block, H:2H].
constexpr int kBwdMaxWarps = 8;
constexpr int kBwdMaxVecs = 6;  // 16-byte vectors a lane, at most: r, g, w and 2 x 8 partials a vector
constexpr int kBwdStages = 2;

// the block's sum of v (W warps, W = blockDim.x / 32), the same bits in
// every thread: warp sums, then the W of them added in order
__device__ __forceinline__ float row_sum(float v, float* red, int W, int warp, int lane) {
  v = ptt::warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < W; ++i) t += red[i];
  return t;
}

template <typename T, int V>
__global__ void __launch_bounds__(kBwdMaxWarps * 32)
ln_residual_bwd_kernel_regs(const T* __restrict__ r, const T* __restrict__ w, const T* __restrict__ g,
                            T* __restrict__ dx, float* __restrict__ part, int rows, int H, int rows_per_block,
                            float eps) {
  namespace hp = ptt::hopper;
  constexpr int N = 16 / sizeof(T);
  // the ring: stage s holds a row's r, then its g ([2][H] of T)
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ uint64_t full[kBwdStages];
  // one buffer per sum of a row: a warp reaches a buffer's next write only
  // after every warp has passed the two barriers between
  __shared__ float red_m[kBwdMaxWarps], red_v[kBwdMaxWarps], red_1[kBwdMaxWarps], red_2[kBwdMaxWarps];
  const int W = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * rows_per_block;
  const int n = min(rows_per_block, rows - r0);
  const uint32_t row_bytes = static_cast<uint32_t>(H) * sizeof(T);
  auto issue = [&](int i) {  // row r0 + i's r and g into stage i % 2 (one thread)
    const int st = i % kBwdStages;
    unsigned char* dst = ring + st * 2 * row_bytes;
    const size_t off = static_cast<size_t>(r0 + i) * H;
    hp::mbar_arrive_expect_tx(&full[st], 2 * row_bytes);
    hp::bulk_load(dst, r + off, row_bytes, &full[st]);
    hp::bulk_load(dst + row_bytes, g + off, row_bytes, &full[st]);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kBwdStages; ++s) hp::mbar_init(&full[s], 1);
    hp::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 0; i < kBwdStages && i < n; ++i) issue(i);
  }
  uint4 wv[V];
  const uint4* w4 = reinterpret_cast<const uint4*>(w);
#pragma unroll
  for (int j = 0; j < V; ++j) wv[j] = w4[(j * W + warp) * 32 + lane];
  float dw_acc[V * N], db_acc[V * N];
#pragma unroll
  for (int e = 0; e < V * N; ++e) dw_acc[e] = db_acc[e] = 0.f;
  for (int i = 0; i < n; ++i) {
    const int st = i % kBwdStages;
    hp::mbar_wait(&full[st], (i / kBwdStages) & 1);
    const uint4* rs = reinterpret_cast<const uint4*>(ring + st * 2 * row_bytes);
    const uint4* gs = reinterpret_cast<const uint4*>(ring + st * 2 * row_bytes + row_bytes);
    uint4 rv[V], gv[V];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      rv[j] = rs[(j * W + warp) * 32 + lane];
      gv[j] = gs[(j * W + warp) * 32 + lane];
      const T* re = ptt::elems_of<T>(rv[j]);
#pragma unroll
      for (int k = 0; k < N; ++k) s += ptt::to_f(re[k]);
    }
    const float mu = row_sum(s, red_m, W, warp, lane) / H;
    // every warp has read the stage (the barrier of that sum): refill it
    if (threadIdx.x == 0 && i + kBwdStages < n) issue(i + kBwdStages);
    float v = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const T* re = ptt::elems_of<T>(rv[j]);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float d = ptt::to_f(re[k]) - mu;
        v += d * d;
      }
    }
    const float rstd = rsqrtf(row_sum(v, red_v, W, warp, lane) / H + eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const T* re = ptt::elems_of<T>(rv[j]);
      const T* ge = ptt::elems_of<T>(gv[j]);
      const T* we = ptt::elems_of<T>(wv[j]);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float xh = (ptt::to_f(re[k]) - mu) * rstd, gf = ptt::to_f(ge[k]);
        const float gw = gf * ptt::to_f(we[k]);
        s1 += gw;
        s2 += gw * xh;
        dw_acc[j * N + k] += gf * xh;
        db_acc[j * N + k] += gf;
      }
    }
    // (sum gw, sum gw x^): one barrier for both
    s1 = ptt::warp_sum(s1);
    s2 = ptt::warp_sum(s2);
    if (lane == 0) red_1[warp] = s1, red_2[warp] = s2;
    __syncthreads();
    float t1 = 0.f, t2 = 0.f;
    for (int q = 0; q < W; ++q) t1 += red_1[q], t2 += red_2[q];
    const float m1 = t1 / H, m2 = t2 / H;
    uint4* out = reinterpret_cast<uint4*>(dx + static_cast<size_t>(r0 + i) * H);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const T* re = ptt::elems_of<T>(rv[j]);
      const T* ge = ptt::elems_of<T>(gv[j]);
      const T* we = ptt::elems_of<T>(wv[j]);
      uint4 ov;
      T* oe = ptt::elems_of<T>(ov);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float xh = (ptt::to_f(re[k]) - mu) * rstd;
        oe[k] = ptt::from_f<T>(rstd * (ptt::to_f(ge[k]) * ptt::to_f(we[k]) - m1 - xh * m2));
      }
      out[(j * W + warp) * 32 + lane] = ov;
    }
  }
  float* p = part + static_cast<size_t>(blockIdx.x) * 2 * H;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = ((j * W + warp) * 32 + lane) * N;
#pragma unroll
    for (int k = 0; k < N; k += 4) {
      *reinterpret_cast<float4*>(p + c + k) =
          make_float4(dw_acc[j * N + k], dw_acc[j * N + k + 1], dw_acc[j * N + k + 2], dw_acc[j * N + k + 3]);
      *reinterpret_cast<float4*>(p + H + c + k) =
          make_float4(db_acc[j * N + k], db_acc[j * N + k + 1], db_acc[j * N + k + 2], db_acc[j * N + k + 3]);
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

template <typename T, int V>
int launch_regs(const void* r, const void* w, const void* g, void* dx, void* part, int rows, int H,
                int rows_per_block, int nblk, int W, float eps, cudaStream_t stream) {
  const size_t smem = kBwdStages * 2 * static_cast<size_t>(H) * sizeof(T);
  const int e = ptt::allow_smem(ln_residual_bwd_kernel_regs<T, V>, smem);
  if (e) return e;
  ln_residual_bwd_kernel_regs<T, V><<<nblk, W * 32, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(w), static_cast<const T*>(g), static_cast<T*>(dx),
      static_cast<float*>(part), rows, H, rows_per_block, eps);
  return static_cast<int>(cudaGetLastError());
}

// The register instance of `vecs` vectors a lane as LAUNCH(V); another
// count returns cudaErrorInvalidValue.
#define PTT_BWD_VECS(LAUNCH) \
  switch (vecs) {            \
    case 1: return LAUNCH(1);  \
    case 2: return LAUNCH(2);  \
    case 3: return LAUNCH(3);  \
    case 4: return LAUNCH(4);  \
    case 5: return LAUNCH(5);  \
    case 6: return LAUNCH(6);  \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

// blocks of the register instance (vecs, W) that an SM holds at once
template <typename T>
int bwd_blocks_per_sm(int H, int vecs, int W, int* per_sm) {
  const size_t smem = kBwdStages * 2 * static_cast<size_t>(H) * sizeof(T);
#define PTT_OCC(NV)                                                                                          \
  (ptt::allow_smem(ln_residual_bwd_kernel_regs<T, NV>, smem)                                                  \
       ? static_cast<int>(cudaErrorInvalidValue)                                                              \
       : static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, ln_residual_bwd_kernel_regs<T, NV>, \
                                                                         W * 32, smem)))
  PTT_BWD_VECS(PTT_OCC)
#undef PTT_OCC
}

// vecs 0: the loop route; else the register instance of `vecs` vectors a
// lane, W warps a row, with H == vecs * W * 32 * (16 / element size)
template <typename T>
int launch_bwd(const void* r, const void* w, const void* g, void* dx, void* dwdb, void* part, int rows, int H,
               int rows_per_block, int nblk, int vecs, int W, float eps, cudaStream_t stream) {
  int e;
  if (vecs == 0) {
    const size_t smem = 3 * static_cast<size_t>(H) * sizeof(float);
    e = ptt::allow_smem(ln_residual_bwd_kernel<T>, smem);
    if (e) return e;
    ln_residual_bwd_kernel<T><<<nblk, kThreads, smem, stream>>>(
        static_cast<const T*>(r), static_cast<const T*>(w), static_cast<const T*>(g), static_cast<T*>(dx),
        static_cast<float*>(part), rows, H, rows_per_block, eps);
    e = static_cast<int>(cudaGetLastError());
  } else {
    const int n = 16 / static_cast<int>(sizeof(T));
    if (W < 1 || W > kBwdMaxWarps || (W & (W - 1)) || H != vecs * W * 32 * n)
      return static_cast<int>(cudaErrorInvalidValue);
    e = [&]() -> int {
#define PTT_REGS(NV) launch_regs<T, NV>(r, w, g, dx, part, rows, H, rows_per_block, nblk, W, eps, stream)
      PTT_BWD_VECS(PTT_REGS)
#undef PTT_REGS
    }();
  }
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
// part: [nblk, 2H] fp32 scratch, nblk = ceil(rows / rows_per_block). The
// plan (fused.py `ln_bwd_plan`): vecs 0 takes the loop route (3 * H * 4
// bytes of shared memory per block, at most 227 KB); else vecs vectors a
// lane and `warps_per_row` (1, 2, 4, 8) warps a row, with H == vecs *
// warps_per_row * 32 * (16 / element size); anything else returns
// cudaErrorInvalidValue.
extern "C" int ptt_ln_residual_bwd(int io, const void* r, const void* w, const void* g, void* dx, void* dwdb,
                                   void* part, int rows, int H, int rows_per_block, int nblk, int vecs,
                                   int warps_per_row, float eps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (io) {
    case ptt::kBF16:
      return launch_bwd<bf16>(r, w, g, dx, dwdb, part, rows, H, rows_per_block, nblk, vecs, warps_per_row, eps, s);
    case ptt::kF16:
      return launch_bwd<f16>(r, w, g, dx, dwdb, part, rows, H, rows_per_block, nblk, vecs, warps_per_row, eps, s);
    case ptt::kF32:
      return launch_bwd<float>(r, w, g, dx, dwdb, part, rows, H, rows_per_block, nblk, vecs, warps_per_row, eps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The register route's blocks an SM holds at once (occupancy of registers
// and the ring's shared memory) for width H in the plan's (vecs,
// warps_per_row), into *per_sm; the wrapper sizes its grid and partials
// by it. Returns a cudaError_t.
extern "C" int ptt_ln_residual_bwd_blocks(int io, int H, int vecs, int warps_per_row, int* per_sm) {
  switch (io) {
    case ptt::kBF16: return bwd_blocks_per_sm<bf16>(H, vecs, warps_per_row, per_sm);
    case ptt::kF16: return bwd_blocks_per_sm<f16>(H, vecs, warps_per_row, per_sm);
    case ptt::kF32: return bwd_blocks_per_sm<float>(H, vecs, warps_per_row, per_sm);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
