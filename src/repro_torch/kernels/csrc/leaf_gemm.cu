// Ragged grouped GEMM over capacity-padded leaf groups.
//
// Replaces repro/kernels/leaf_gemm/kernel.py::grouped_matmul (y[e] =
// act(x[e] @ w[e])) and ::grouped_matmul_dual (the SwiGLU up-projection
// silu(x[e] @ wg[e]) * (x[e] @ wu[e])), Pallas TPU kernels.  x (E, C, D)
// holds each leaf's routed tokens in its first group_sizes[e] rows (zeros
// after); w (E, D, H).  A token tile with c * BM >= group_sizes[e] is
// skipped: it writes zeros and reads no weights, as the Pallas kernel's
// ragged early-out does (act(0) = 0 for every activation used).
//
// Bound on the H100: at internlm2-20b prefill (E = 16, C = 128, 1024
// tokens) the weights dominate the bytes (201 MB per 6144x1024 weight set
// in bf16) and the arithmetic intensity is ~C = 128 operations per weight
// byte, so the card's limit is its memory rate, ~60 us per weight set.
// Design (simple, exact first kernels; wgmma/TMA come later): one block
// per (leaf e, 64-token tile, 64-column tile), the loop over D inside the
// block taking the place of the TPU's sequential k grid axis and its VMEM
// accumulator.  float32 runs on the CUDA cores: 16-deep slices of x and w
// staged in shared memory, each of 256 threads accumulating a 4x4 output
// patch (two for the dual form) in f32 registers, so float32 inputs keep
// full float32 products.  bfloat16 runs on the tensor cores (below).
// Ragged edges (C, D, H not multiples of the tile, as in the tests' leaf
// widths 4 and 8) are masked on load and store.
#include <mma.h>

#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 16, kThreads = 256;

template <typename T, bool kDual>
__global__ void __launch_bounds__(kThreads)
grouped_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const T* __restrict__ w2, const int* __restrict__ gs,
                      T* __restrict__ y, int C, int D, int H, int act) {
  const int e = blockIdx.z, c0 = blockIdx.y * BM, h0 = blockIdx.x * BN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  T* yb = y + static_cast<size_t>(e) * C * H;
  if (c0 >= gs[e]) {  // empty token tile: zeros, no weight traffic
    for (int i = tid; i < BM * BN; i += kThreads) {
      const int r = c0 + i / BN, c = h0 + i % BN;
      if (r < C && c < H) yb[static_cast<size_t>(r) * H + c] = fff::from_f32<T>(0.0f);
    }
    return;
  }
  __shared__ float As[BK][BM + 4];          // x slice, transposed [k][m]
  __shared__ __align__(16) float Bs[BK][BN];
  __shared__ __align__(16) float Bs2[kDual ? BK : 1][BN];
  const T* xb = x + static_cast<size_t>(e) * C * D;
  const T* wb = w + static_cast<size_t>(e) * D * H;
  const T* w2b = kDual ? w2 + static_cast<size_t>(e) * D * H : nullptr;
  float acc[4][4] = {}, acc2[4][4] = {};
  for (int k0 = 0; k0 < D; k0 += BK) {
#pragma unroll
    for (int i = 0; i < BM * BK / kThreads; ++i) {
      const int idx = tid + i * kThreads, m = idx / BK, k = idx % BK;
      const int r = c0 + m, kk = k0 + k;
      As[k][m] = (r < C && kk < D) ? fff::to_f32(xb[static_cast<size_t>(r) * D + kk]) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < BK * BN / kThreads; ++i) {
      const int idx = tid + i * kThreads, k = idx / BN, n = idx % BN;
      const int kk = k0 + k, c = h0 + n;
      const bool ok = kk < D && c < H;
      const size_t off = static_cast<size_t>(kk) * H + c;
      Bs[k][n] = ok ? fff::to_f32(wb[off]) : 0.0f;
      if constexpr (kDual) Bs2[k][n] = ok ? fff::to_f32(w2b[off]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty * 4 + i];
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * bv[j];
      if constexpr (kDual) {
        const float4 b2 = *reinterpret_cast<const float4*>(&Bs2[k][tx * 4]);
        const float bv2[4] = {b2.x, b2.y, b2.z, b2.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc2[i][j] += a[i] * bv2[j];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = c0 + ty * 4 + i;
    if (r >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = h0 + tx * 4 + j;
      if (c >= H) continue;
      const float v = kDual ? fff::silu(acc[i][j]) * acc2[i][j]
                            : fff::activate(acc[i][j], act);
      yb[static_cast<size_t>(r) * H + c] = fff::from_f32<T>(v);
    }
  }
}

// bfloat16: the same tiling on the tensor cores (warp-level mma through
// the WMMA API, bf16 products accumulated in f32).  A block of four warps
// owns a 64-token x 64-column tile; each warp a 32x32 quarter as 2x2
// fragments of 16x16.  32-deep slices of x and w stream into a 3-stage
// ring in shared memory with 16-byte cp.async copies (element-wise,
// masked, at ragged or unaligned edges), so the loads of slices k+1 and
// k+2 are in flight while slice k is multiplied.  The activation (or
// silu(g) * u) is applied to the accumulator fragments, which share one
// element mapping, and the tile leaves through shared memory (reusing the
// ring) for the masked bf16 store.
constexpr int TM = 64, TN = 64, TK = 32, kStages = 3, kTcThreads = 128;
constexpr int kALd = TK + 8, kBLd = TN + 8, kCLd = TN + 4;  // padded rows
using bf16 = __nv_bfloat16;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 8 elements of row r, columns c..c+7 of a (rows x cols, leading dim ld)
// matrix into shared memory: one async 16-byte copy when whole and
// aligned, else masked element stores (zeros outside the matrix)
__device__ __forceinline__ void load8(bf16* dst, const bf16* src, int r, int c,
                                      int rows, int cols, int ld) {
  const bf16* p = src + static_cast<size_t>(r) * ld + c;
  if (r < rows && c + 8 <= cols && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    cp_async16(dst, p);
  } else {
#pragma unroll
    for (int t = 0; t < 8; ++t)
      dst[t] = (r < rows && c + t < cols) ? p[t] : __float2bfloat16(0.0f);
  }
}

template <bool kDual>
struct TcSmem {
  static constexpr int kA = TM * kALd, kB = TK * kBLd;      // elements
  static constexpr int kStage = kA + kB * (kDual ? 2 : 1);  // elements
  static constexpr int kBytes = kStages * kStage * 2;
  static_assert(TM * kCLd * 4 <= kBytes, "the output tile reuses the ring");
  static_assert((kA * 2) % 32 == 0 && (kB * 2) % 32 == 0, "wmma alignment");
};

template <bool kDual>
__global__ void __launch_bounds__(kTcThreads)
grouped_matmul_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                         const bf16* __restrict__ w2, const int* __restrict__ gs,
                         bf16* __restrict__ y, int C, int D, int H, int act) {
  namespace wmma = nvcuda::wmma;
  using L = TcSmem<kDual>;
  const int e = blockIdx.z, c0 = blockIdx.y * TM, h0 = blockIdx.x * TN;
  const int tid = threadIdx.x, warp = tid / 32;
  bf16* yb = y + static_cast<size_t>(e) * C * H;
  if (c0 >= gs[e]) {  // empty token tile: zeros, no weight traffic
    for (int i = tid; i < TM * TN; i += kTcThreads) {
      const int r = c0 + i / TN, c = h0 + i % TN;
      if (r < C && c < H) yb[static_cast<size_t>(r) * H + c] = __float2bfloat16(0.0f);
    }
    return;
  }
  __shared__ __align__(128) unsigned char smem[L::kBytes];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const bf16* xb = x + static_cast<size_t>(e) * C * D;
  const bf16* wb = w + static_cast<size_t>(e) * D * H;
  const bf16* w2b = kDual ? w2 + static_cast<size_t>(e) * D * H : nullptr;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int nk = (D + TK - 1) / TK;

  auto load_stage = [&](int kt) {
    bf16* As = ring + (kt % kStages) * L::kStage;
    bf16* Bs = As + L::kA;
    const int k0 = kt * TK;
    for (int i = tid; i < TM * TK / 8; i += kTcThreads) {
      const int r = i / (TK / 8), c = (i % (TK / 8)) * 8;
      load8(As + r * kALd + c, xb, c0 + r, k0 + c, C, D, D);
    }
    for (int i = tid; i < TK * TN / 8; i += kTcThreads) {
      const int r = i / (TN / 8), c = (i % (TN / 8)) * 8;
      load8(Bs + r * kBLd + c, wb, k0 + r, h0 + c, D, H, H);
      if constexpr (kDual) load8(Bs + L::kB + r * kBLd + c, w2b, k0 + r, h0 + c, D, H, H);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2], acc2[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(acc[i][j], 0.0f);
      if constexpr (kDual) wmma::fill_fragment(acc2[i][j], 0.0f);
    }
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) load_stage(st);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();  // this thread's copies of slice kt landed
    __syncthreads();               // everyone's did; slice kt-1 is consumed
    if (kt + kStages - 1 < nk) load_stage(kt + kStages - 1);
    cp_async_commit();
    const bf16* As = ring + (kt % kStages) * L::kStage;
    const bf16* Bs = As + L::kA;
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], As + (wm + 16 * i) * kALd + kk, kALd);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], Bs + kk * kBLd + wn + 16 * j, kBLd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      if constexpr (kDual) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(b[j], Bs + L::kB + kk * kBLd + wn + 16 * j, kBLd);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc2[i][j], a[i], b[j], acc2[i][j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it for the output tile
  float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int t = 0; t < acc[i][j].num_elements; ++t) {
        if constexpr (kDual) acc[i][j].x[t] = fff::silu(acc[i][j].x[t]) * acc2[i][j].x[t];
        else acc[i][j].x[t] = fff::activate(acc[i][j].x[t], act);
      }
      wmma::store_matrix_sync(Cs + (wm + 16 * i) * kCLd + wn + 16 * j, acc[i][j], kCLd,
                              wmma::mem_row_major);
    }
  __syncthreads();
  for (int i = tid; i < TM * TN; i += kTcThreads) {
    const int r = c0 + i / TN, c = h0 + i % TN;
    if (r < C && c < H)
      yb[static_cast<size_t>(r) * H + c] = __float2bfloat16(Cs[(i / TN) * kCLd + i % TN]);
  }
}

template <bool kDual>
int launch(const void* x, const void* w, const void* w2, const int* gs,
           void* y, int E, int C, int D, int H, int act, int dtype,
           void* stream) {
  if (E < 1 || C < 1 || D < 1 || H < 1) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == fff::kF32) {
    const dim3 grid((H + BN - 1) / BN, (C + BM - 1) / BM, E);
    grouped_matmul_kernel<float, kDual><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(w2), gs, static_cast<float*>(y), C, D, H, act);
  } else if (dtype == fff::kBF16) {
    const dim3 grid((H + TN - 1) / TN, (C + TM - 1) / TM, E);
    grouped_matmul_tc_kernel<kDual><<<grid, kTcThreads, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<const bf16*>(w2), gs, static_cast<bf16*>(y), C, D, H, act);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (E, C, D), w (E, D, H), group_sizes (E,) int32 -> y (E, C, H), one
// dtype; act is an activation code other than swiglu.
extern "C" int grouped_matmul(const void* x, const void* w, const int* gs,
                              void* y, int E, int C, int D, int H, int act,
                              int dtype, int device, void* stream) {
  if (const cudaError_t err = cudaSetDevice(device)) return static_cast<int>(err);
  if (act < fff::kActNone || act > fff::kActSilu) return cudaErrorInvalidValue;
  return launch<false>(x, w, nullptr, gs, y, E, C, D, H, act, dtype, stream);
}

// SwiGLU up-projection: y = silu(x @ wg) * (x @ wu), grouped per leaf.
extern "C" int grouped_matmul_dual(const void* x, const void* wg,
                                   const void* wu, const int* gs, void* y,
                                   int E, int C, int D, int H, int dtype,
                                   int device, void* stream) {
  if (const cudaError_t err = cudaSetDevice(device)) return static_cast<int>(err);
  return launch<true>(x, wg, wu, gs, y, E, C, D, H, fff::kActSwiglu, dtype,
                      stream);
}
