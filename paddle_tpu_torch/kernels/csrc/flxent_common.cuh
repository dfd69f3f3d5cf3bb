// Shared pieces of the fused linear cross-entropy kernels (flxent_fwd.cu,
// flxent_dx.cu, flxent_dw.cu): an mma.sync tensor-core GEMM mainloop that
// serves, where TMA cannot address W (W [H, V] with V % 8 != 0, or W not
// 16-byte aligned), kernel 17 (bf16 / fp16) and the backward's products;
// its form with an int8 B operand (gemm_tile_i8: kernel 17's int8 site for
// a vocab-major or ragged int8 lm head);
// the output-tile order; and the declarations of the backward's other
// instances (flxent_wgmma.cu, flxent_fp32.cu).
//
// The three products differ only in how their operands lie in memory:
//   logits  = x W       A = x [rows][H] (k contiguous);
//                       B = W [H][V] (n contiguous) or W [V][H] (k contiguous)
//   dX     += D W^T     A = D [rows][Vc] (k contiguous);
//                       B = W^T: [H][V] -> k contiguous, [V][H] -> n contiguous
//   dW      = x^T D     A = x^T or D^T (m contiguous), B = D or x (n contiguous)
// so one mainloop takes each operand as it lies: a tile is staged in shared
// memory in its own layout, and ldmatrix reads the mma.sync fragments from
// it, with .trans where the outer (m or n) dimension is the contiguous one.
// No operand is ever copied or transposed in device memory.
//
// Tiles: one 128 x 128 output tile per block of 8 warps (2 x 4 warps of
// 64 x 32), k steps of 64, mma.sync m16n8k16 (bf16 or fp16 in, fp32
// accumulate), operands staged by cp.async (16 bytes a thread, zero-filled
// past the ragged edge) in a 3-stage ring so loads overlap the products.
// Rows padded by 16 bytes make every ldmatrix phase hit 32 distinct banks.
// (On the card k steps of 64 beat 32 and 4 stages did not help; warps of
// 64 x 64, which read less shared memory per product, lost more to having
// half the warps in flight.)
// An operand whose rows are not 16-byte aligned (W [H, V] with V % 8 != 0)
// is staged element by element instead.
#pragma once

#include "common.cuh"

namespace ptt {
namespace flx {

constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kStages = 3;
constexpr int kWM = 64, kWN = 32;         // one warp's sub-tile
constexpr int kWarpsN = kBN / kWN;        // warps along n (2 along m)
constexpr int kThreads = 32 * (kBM / kWM) * kWarpsN;
constexpr int kMT = kWM / 16, kNT = kWN / 8;
constexpr int kLdK = kBK + 8;             // [outer][k] tile rows: 144 bytes
constexpr int kLdO = kBM + 8;             // [k][outer] tile rows: 272 bytes
constexpr int kTile = kBM * kLdK;         // elements of one operand tile
static_assert(kBM == kBN && kBM * kLdK >= kBK * kLdO, "one tile size serves both layouts");
constexpr int kSmemBytes = kStages * 2 * kTile * 2;  // 110,592 bytes: 2 blocks per SM
constexpr float kNegInf = -1e30f;         // the Pallas kernels' NEG_INF
constexpr int kGroup = 16;                // output row tiles per sweep (L2 reuse)

// One matrix operand read in place: element (outer o, k) lies at
// ptr[o * ld + k] when the layout is k-contiguous, else at ptr[k * ld + o].
template <typename T>
struct Operand {
  const T* ptr;
  long long ld;
  int outer;  // extent along m (A) or n (B)
  int k;      // extent along k
  int vec;    // 1: rows are 16-byte aligned, staged by cp.async
};

template <typename T>
Operand<T> operand(const void* ptr, long long ld, int outer, int k) {
  const bool vec = (ld * static_cast<long long>(sizeof(T))) % 16 == 0 && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  return Operand<T>{static_cast<const T*>(ptr), ld, outer, k, vec ? 1 : 0};
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; bytes past `src_bytes` are zero
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a b for one m16n8k16 tile (fp32 accumulators)
template <typename T>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1);
template <>
__device__ __forceinline__ void mma<bf16>(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma<f16>(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage the slab k in [k0, k0 + kBK) x outer in [o0, o0 + 128) of `op` into
// `s`, in the operand's own layout: [outer][kLdK] when KCONTIG, else
// [k][kLdO]. Elements past the operand's extents are zero.
template <typename T, bool KCONTIG>
__device__ __forceinline__ void load_tile(T* s, const Operand<T>& op, int o0, int k0) {
  constexpr int kChunks = kBM * kBK / 8;  // 16-byte chunks of 8 elements
  static_assert(kChunks % kThreads == 0, "whole chunks per thread");
#pragma unroll
  for (int it = 0; it < kChunks / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    int n_valid, soff;
    const T* src;
    if (KCONTIG) {
      const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
      const int o = o0 + r, kk = k0 + c;
      n_valid = o < op.outer ? max(0, min(8, op.k - kk)) : 0;
      src = op.ptr + static_cast<long long>(o) * op.ld + kk;
      soff = r * kLdK + c;
    } else {
      const int r = i / (kBM / 8), c = (i % (kBM / 8)) * 8;
      const int kk = k0 + r, o = o0 + c;
      n_valid = kk < op.k ? max(0, min(8, op.outer - o)) : 0;
      src = op.ptr + static_cast<long long>(kk) * op.ld + o;
      soff = r * kLdO + c;
    }
    if (op.vec) {
      cp_async16(smem_u32(s + soff), n_valid ? src : op.ptr, n_valid * 2);
    } else {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      T* e = elems_of<T>(v);
      for (int j = 0; j < n_valid; ++j) e[j] = src[j];
      *reinterpret_cast<uint4*>(s + soff) = v;
    }
  }
}

// acc += the products of one staged k slab: a and b are its A and B tiles
// in shared memory, each in its operand's layout (see load_tile).
template <typename T, bool A_K, bool B_K>
__device__ __forceinline__ void mma_slab(float (&acc)[kMT][kNT][4], const T* a, const T* b) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int li = lane >> 3, lr = lane & 7;  // ldmatrix: which 8x8 matrix, which of its rows
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    uint32_t af[kMT][4], bfr[kNT][2];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const int mb = wm * kWM + mt * 16;
      if (A_K) {  // [m][k]: matrices (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15), (m 8-15, k 8-15)
        ldsm_x4(af[mt], smem_u32(a + (mb + (lane & 15)) * kLdK + kk + (lane >> 4) * 8));
      } else {    // [k][m]: the same four matrices, transposed on the way out
        ldsm_x4_t(af[mt], smem_u32(a + (kk + lr + (li >> 1) * 8) * kLdO + mb + (li & 1) * 8));
      }
    }
#pragma unroll
    for (int np = 0; np < kNT / 2; ++np) {
      const int nb = wn * kWN + np * 16;
      uint32_t r[4];
      if (B_K) {  // [n][k]: (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15)
        ldsm_x4(r, smem_u32(b + (nb + lr + (li >> 1) * 8) * kLdK + kk + (li & 1) * 8));
      } else {    // [k][n]: (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
        ldsm_x4_t(r, smem_u32(b + (kk + lr + (li & 1) * 8) * kLdO + nb + (li >> 1) * 8));
      }
      bfr[2 * np][0] = r[0];
      bfr[2 * np][1] = r[1];
      bfr[2 * np + 1][0] = r[2];
      bfr[2 * np + 1][1] = r[3];
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) mma<T>(acc[mt][nt], af[mt], bfr[nt][0], bfr[nt][1]);
  }
}

// acc = A[m0:m0+128, :] B[:, n0:n0+128] over the whole k extent (A.k ==
// B.k). Each thread holds the accumulators of its warp's kWM x kWN
// sub-tile: acc[mt][nt][e] is row wm*kWM + mt*16 + gid + 8*(e/2), column
// wn*kWN + nt*8 + 2*tig + e%2 of the tile (warp = kWarpsN wm + wn, lane =
// 4 gid + tig). Returns with the shared memory free for the epilogue.
template <typename T, bool A_K, bool B_K>
__device__ __forceinline__ void gemm_tile(float (&acc)[kMT][kNT][4], const Operand<T>& A,
                                          const Operand<T>& B, int m0, int n0, T* smem) {
  T* sA = smem;
  T* sB = smem + kStages * kTile;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  const int ktiles = (A.k + kBK - 1) / kBK;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < ktiles) {
      load_tile<T, A_K>(sA + st * kTile, A, m0, st * kBK);
      load_tile<T, B_K>(sB + st * kTile, B, n0, st * kBK);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slab kt has landed; every warp is done with slab kt - 1
    const int nk = kt + kStages - 1;
    if (nk < ktiles) {
      load_tile<T, A_K>(sA + (nk % kStages) * kTile, A, m0, nk * kBK);
      load_tile<T, B_K>(sB + (nk % kStages) * kTile, B, n0, nk * kBK);
    }
    cp_async_commit();
    mma_slab<T, A_K, B_K>(acc, sA + (kt % kStages) * kTile, sB + (kt % kStages) * kTile);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Stage the int8 slab k in [k0, k0 + kBK) x outer in [o0, o0 + 128) of `op`
// into `s` as it lies: [outer][kBK] bytes when KCONTIG, else [k][kBM].
// Bytes past the operand's extents are zero.
template <bool KCONTIG>
__device__ __forceinline__ void load_tile_i8(int8_t* s, const Operand<int8_t>& op, int o0, int k0) {
  constexpr int kChunks = kBM * kBK / 16;  // 16-byte chunks of 16 values
  static_assert(kChunks % kThreads == 0, "whole chunks per thread");
#pragma unroll
  for (int it = 0; it < kChunks / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    int n_valid, soff;
    const int8_t* src;
    if (KCONTIG) {
      const int r = i / (kBK / 16), c = (i % (kBK / 16)) * 16;
      const int o = o0 + r, kk = k0 + c;
      n_valid = o < op.outer ? max(0, min(16, op.k - kk)) : 0;
      src = op.ptr + static_cast<long long>(o) * op.ld + kk;
      soff = r * kBK + c;
    } else {
      const int r = i / (kBM / 16), c = (i % (kBM / 16)) * 16;
      const int kk = k0 + r, o = o0 + c;
      n_valid = kk < op.k ? max(0, min(16, op.outer - o)) : 0;
      src = op.ptr + static_cast<long long>(kk) * op.ld + o;
      soff = r * kBM + c;
    }
    if (op.vec) {
      cp_async16(smem_u32(s + soff), n_valid ? src : op.ptr, n_valid);
    } else {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      int8_t* e = elems_of<int8_t>(v);
      for (int j = 0; j < n_valid; ++j) e[j] = src[j];
      *reinterpret_cast<uint4*>(s + soff) = v;
    }
  }
}

// The staged int8 slab as a tile of T in the layout gemm_tile's B tiles have
// ([outer][kLdK] when KCONTIG, else [k][kLdO]): every int8 value is exact in
// bf16 and fp16, so the products below are those of the int8 weight itself.
template <typename T, bool KCONTIG>
__device__ __forceinline__ void upcast_tile_i8(T* dst, const int8_t* src) {
  constexpr int kChunks = kBM * kBK / 16;
#pragma unroll
  for (int it = 0; it < kChunks / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    int soff, doff;
    if (KCONTIG) {
      const int r = i / (kBK / 16), c = (i % (kBK / 16)) * 16;
      soff = r * kBK + c;
      doff = r * kLdK + c;
    } else {
      const int r = i / (kBM / 16), c = (i % (kBM / 16)) * 16;
      soff = r * kBM + c;
      doff = r * kLdO + c;
    }
    const uint4 raw = *reinterpret_cast<const uint4*>(src + soff);
    const int8_t* e = elems_of<int8_t>(raw);
    uint4 lo, hi;
    T* l = elems_of<T>(lo);
    T* h = elems_of<T>(hi);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      l[j] = from_f<T>(to_f(e[j]));
      h[j] = from_f<T>(to_f(e[8 + j]));
    }
    *reinterpret_cast<uint4*>(dst + doff) = lo;
    *reinterpret_cast<uint4*>(dst + doff + 8) = hi;
  }
}

constexpr int kTileI8 = kBM * kBK;  // bytes of one staged int8 slab
static_assert(kStages * kTile * 2 + kStages * kTileI8 + kTile * 2 <= kSmemBytes, "the int8 ring fits");

// gemm_tile with an int8 B operand (a weight-only int8 matrix): B's slabs
// are staged as int8 by cp.async in their own ring (half the bytes of a
// bf16 slab) and each, once landed, is upcast to T into one T tile that the
// warps' ldmatrix reads; A is staged as in gemm_tile. Accumulators and
// return state as in gemm_tile. Hopper has no mixed bf16 x int8 MMA, and
// the upcast is exact, so acc is the fp32 product of A and the int8 values.
template <typename T, bool B_K>
__device__ __forceinline__ void gemm_tile_i8(float (&acc)[kMT][kNT][4], const Operand<T>& A,
                                             const Operand<int8_t>& B, int m0, int n0, unsigned char* smem) {
  T* sA = reinterpret_cast<T*>(smem);
  int8_t* sB8 = reinterpret_cast<int8_t*>(smem + kStages * kTile * sizeof(T));
  T* sB = reinterpret_cast<T*>(smem + kStages * kTile * sizeof(T) + kStages * kTileI8);
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  const int ktiles = (A.k + kBK - 1) / kBK;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < ktiles) {
      load_tile<T, true>(sA + st * kTile, A, m0, st * kBK);
      load_tile_i8<B_K>(sB8 + st * kTileI8, B, n0, st * kBK);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slab kt has landed; every warp is done with slab kt - 1 and with sB
    upcast_tile_i8<T, B_K>(sB, sB8 + (kt % kStages) * kTileI8);
    const int nk = kt + kStages - 1;
    if (nk < ktiles) {
      load_tile<T, true>(sA + (nk % kStages) * kTile, A, m0, nk * kBK);
      load_tile_i8<B_K>(sB8 + (nk % kStages) * kTileI8, B, n0, nk * kBK);
    }
    cp_async_commit();
    __syncthreads();  // sB holds slab kt in T
    mma_slab<T, true, B_K>(acc, sA + (kt % kStages) * kTile, sB);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The output tile of this block: 1-D grid, kGroup row tiles at a time swept
// across all column tiles, so the blocks in flight share a few row tiles
// of A and column tiles of B in L2 instead of streaming all of A or B.
__device__ __forceinline__ void tile_coords(int tiles_m, int tiles_n, int& tm, int& tn) {
  const int t = blockIdx.x;
  const int per_group = kGroup * tiles_n;
  const int first = (t / per_group) * kGroup;
  const int size = min(tiles_m - first, kGroup);
  const int in = t % per_group;
  tm = first + in % size;
  tn = in / size;
}

// C = A B written per element (row < M, col < N) at out[row * ld + col]:
// with `first` 0 the fp32 partial acc_buf is added in; with `last` the sum
// is written to `out` in T, else to acc_buf in fp32. The dX and dW products
// (flxent_dx.cu, flxent_dw.cu) instantiate it.
template <typename T, bool A_K, bool B_K>
__global__ void __launch_bounds__(kThreads, 2)
flxent_gemm_kernel(Operand<T> A, Operand<T> B, int M, int N, float* __restrict__ acc_buf, T* __restrict__ out,
            long long ld, int first, int last) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tiles_m = (M + kBM - 1) / kBM, tiles_n = (N + kBN - 1) / kBN;
  int tm, tn;
  tile_coords(tiles_m, tiles_n, tm, tn);
  const int m0 = tm * kBM, n0 = tn * kBN;
  float acc[kMT][kNT][4];
  gemm_tile<T, A_K, B_K>(acc, A, B, m0, n0, reinterpret_cast<T*>(smem_raw));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * kWM + mt * 16 + gid + 8 * h;
      if (row >= M) continue;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn * kWN + nt * 8 + 2 * tig + e;
          if (col >= N) continue;
          const long long idx = static_cast<long long>(row) * ld + col;
          float v = acc[mt][nt][2 * h + e];
          if (!first) v += acc_buf[idx];
          if (last) {
            out[idx] = from_f<T>(v);
          } else {
            acc_buf[idx] = v;
          }
        }
      }
    }
  }
}

// above 48 KB a block's shared memory must be asked for, per kernel
template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
}

// The instances of each product (kernels/fused_loss.py `flx_route` and, for
// the int8 head, `flx_int8_route` name one before each launch): the wgmma
// mainloop (flxent_wgmma.cu: bf16 / fp16 whose rows TMA can address; the
// int8 head's on kernel 20's mainloop, flxent_int8.cu), this file's mma.sync
// mainloop (bf16 / fp16, any V), and fp32 on the CUDA cores
// (flxent_fp32.cu). The fp32 TF32 instances (`flx_route` "tf32x3",
// `flx_int8_route` "tf32x2", flxent_tf32.cu) have entry points of their own.
enum Route : int { kWgmma = 0, kMmaSync = 1, kCudaCores = 2 };

// flxent_wgmma.cu: the forward's partials [3, ceil(V / 128), N] (as
// ptt_flxent_fwd's); D of the vocab columns [c0, c0 + vc) into d [N, ldd]; dX's
// chunk (fp32 partial acc, dx on the last); dW's chunk. io is kBF16 or kF16;
// each returns a cudaError_t (cudaErrorInvalidValue for what TMA cannot map).
int wgmma_fwd(int io, int vocab_major, const void* x, const void* w, const void* labels, void* part, int N, int H,
              int V, cudaStream_t s);
int wgmma_dchunk(int io, int vocab_major, const void* x, const void* w, const void* labels, const void* lse,
                 const void* gcoef, void* d, long long ldd, int N, int H, int V, int c0, int vc, cudaStream_t s);
int wgmma_dx(int io, int vocab_major, const void* d, long long ldd, const void* w, void* acc, void* dx, int N, int H,
             int V, int c0, int vc, int first, int last, cudaStream_t s);
int wgmma_dw(int io, int vocab_major, const void* x, const void* d, long long ldd, void* dw, int N, int H, int V,
             int c0, int vc, cudaStream_t s);

// flxent_int8.cu: the int8 head's partials for bf16 / fp16 x [N, H] and
// w8 [H, V] (H % 8 == 0, V % 16 == 0, 16-byte aligned) with fp32 wscale [V].
int wgmma_fwd_int8(int io, const void* x, const void* w8, const void* wscale, const void* labels, void* part, int N,
                   int H, int V, cudaStream_t s);

// flxent_fp32.cu: the same four products in fp32 on the CUDA cores: the
// forward's partials (as ptt_flxent_fwd's), D, dX (accumulated in place in
// dx: first overwrites it) and dW; and the int8 head's partials for fp32 x.
int f32_fwd(int vocab_major, const float* x, const float* w, const int* labels, float* part, int N, int H, int V,
            cudaStream_t s);
int f32_fwd_int8(int vocab_major, const float* x, const int8_t* w8, const float* wscale, const int* labels,
                 float* part, int N, int H, int V, cudaStream_t s);
int f32_dchunk(int vocab_major, const float* x, const float* w, const int* labels, const float* lse,
               const float* gcoef, float* d, long long ldd, int N, int H, int V, int c0, int vc, cudaStream_t s);
int f32_dx(int vocab_major, const float* d, long long ldd, const float* w, float* dx, int N, int H, int V, int c0,
           int vc, int first, cudaStream_t s);
int f32_dw(int vocab_major, const float* x, const float* d, long long ldd, float* dw, int N, int H, int V, int c0,
           int vc, cudaStream_t s);

}  // namespace flx
}  // namespace ptt
