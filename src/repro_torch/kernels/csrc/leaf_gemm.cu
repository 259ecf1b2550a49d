// Ragged grouped GEMM over capacity-padded leaf groups.
//
// Replaces repro/kernels/leaf_gemm/kernel.py::grouped_matmul (y[e] =
// act(x[e] @ w[e])) and ::grouped_matmul_dual (the SwiGLU up-projection
// silu(x[e] @ wg[e]) * (x[e] @ wu[e])), Pallas TPU kernels.  x (E, C, D)
// holds each leaf's routed tokens in its first group_sizes[e] rows; w
// (E, D, H).  Rows at or past group_sizes[e] come out zero whatever x holds
// there, and rows with no live token read no weights, as the Pallas
// kernel's ragged early-out does.  Every sum runs in a fixed order and each
// output element has one writer (no atomics), so two calls give
// bit-identical results.
//
// Bound on the H100: bytes.  A live leaf's weights are the traffic: 201 MB
// per 6144 x 1024 weight set in bf16 at internlm2-20b, ~68 us for the down
// projection (1024 -> 6144) and ~125 us for the dual form (two sets, 6144 ->
// 1024) at 1024 prefill tokens.  A weight element takes at most C
// multiply-adds, so at C <= 256 bf16 does at most 256 operations per weight
// byte, below the ~295 where the tensor cores would be the limit.  Reading
// each live leaf's weights once, keeping enough bytes in flight on every SM
// and spreading the work evenly over the 132 SMs is what the design is for.
//
// The caller (kernels/leaf_gemm/kernel.py::plan) picks one of three paths
// and its tile, D split and grid; this file checks and launches that plan.
//
// bfloat16, TMA path (D and H multiples of 8, 16-byte aligned bases: what a
// tensor map can describe).  Persistent blocks, one an SM, walk a static
// list of units, block b taking units b, b + grid, ... (no atomic counter,
// so a CUDA graph replays it as it is): a unit is (leaf, column tile of 64,
// 128 or 256 columns, range of D), the column tiles of a leaf adjacent, so
// the blocks running side by side share the leaf's x in L2.  A unit covers
// all of its leaf's rows up to 256 (four 64-row slices), so its weight tile
// crosses from memory once; a capacity above 256 loops over 256-row tiles
// inside the unit.  A block is one producer warp and four consumer
// warpgroups.  Lane 0 of the producer issues every copy with
// cp.async.bulk.tensor: x through a 3-D tensor map over (E, C, D), only the
// live 64-row slices, and the weights through one over (E, D, H), as
// 64-column atoms of 64 rows of D, both in the 128-byte swizzle that the
// wgmma descriptors read; out-of-range rows and columns arrive as zeros.
// The weights stream with an L2 evict-first policy and x with evict-last,
// since every column tile of the leaf reads x again.  The producer reads
// group_sizes on the device, so the host never syncs.  The copies stream
// through a ring of 4-8 stages (~192 KB) with a full and an empty mbarrier
// a stage: the producer sets the full barrier's byte count to what it
// copies; each consumer warp arrives on the empty barrier once its
// warpgroup's wgmma on the stage has retired (one step's products drain
// behind the next's).  No block-wide barrier runs after the set-up, so one
// unit's epilogue overlaps the producer's loads for the next.  A consumer
// warpgroup owns one or two row slices of a column group: two 64-column
// atoms of the down projection, or the dual form's g and u atoms side by
// side, so that one m64n128k16 reads its x slice once for both (at most 64
// f32 accumulators a thread: 17 warps leave 96 registers); a slice past the
// group's size issues no wgmma.  The epilogue works on the accumulators in
// registers: the activation (or silu(g) * u), bf16 rounding, a shuffle in
// each 4-lane quad that gathers 8 adjacent columns a lane, one 16-byte
// store a lane, zeros at rows past the group's size.  Each kernel is
// compiled for one activation, so its epilogue is one short run of code:
// with the activation switched inside the unrolled epilogue (an unexecuted
// GELU between every two stores) the H100 spent several times longer in
// it, while the producer's ring stood full.  (Staging the output through
// shared memory for TMA stores, two smaller blocks an SM, and releasing
// each stage as soon as its own products retire measured no faster.)
// Where the units are fewer than the SMs, D may be split over units (each
// range at least 4 steps of D; whisper-small's up projection: 8 leaves x 6
// column tiles of 64, D in 2): each writes f32 partials of its live rows to
// a workspace the wrapper allocates, and a second kernel in the same entry
// point sums them in split order, applies the activation and writes the
// element type.
//
// bfloat16, masked path (rows whose stride is not a multiple of 16 bytes,
// such as the tests' leaf width 4, or bases off 16 bytes): one block per
// (column tile, 128 rows, leaf), 2 x kCg warpgroups on the same wgmma core,
// fed by a 4-stage ring of 16-byte cp.async copies issued by every thread
// into the swizzled layout, with masked element copies at ragged edges and
// zeros for rows past the group's size.
//
// float32 runs on the CUDA cores in full float32 (no TF32): one block per
// (leaf, 64 rows, 64 columns[, range of D]), 16-deep slices of x and w
// staged in shared memory, each of 256 threads accumulating a 4x4 output
// patch (two for the dual form) in registers.  Where that grid has fewer
// blocks than the card has SMs (the starcoder2 draft's 16-wide leaves) D is
// split over blocks through the same fixed-order partial pass.
#include <algorithm>
#include <mutex>
#include <type_traits>
#include <unordered_map>

#include "tma.cuh"

namespace {

// the paths (kernels/leaf_gemm/kernel.py PATH_CODES)
constexpr int kPathCudaCores = 0;
constexpr int kPathMasked = 1;
constexpr int kPathTma = 2;
constexpr int kMaxDevices = 16;

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------
constexpr int BM = 64, BN = 64, BK = 16, kThreads = 256;

// grid (H / BN, C / BM, E x splits): blockIdx.z = split * E + leaf.
// Unsplit (kSplit false) it writes y, the activation kAct fixed at compile
// time; split, the block's f32 sums over its range of D go to ws (splits,
// ops, E, C, H) and split_sum_kernel finishes.  Each instance holds one
// epilogue: compiled together, the split and unsplit stores and a switch
// over the activations made the unsplit kernel slower on the H100.
template <typename T, bool kDual, bool kSplit, int kAct>
__global__ void __launch_bounds__(kThreads)
grouped_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const T* __restrict__ w2, const int* __restrict__ gs,
                      T* __restrict__ y, float* __restrict__ ws, int E, int C, int D, int H,
                      int splits) {
  const int e = kSplit ? blockIdx.z % E : blockIdx.z;
  const int c0 = blockIdx.y * BM, h0 = blockIdx.x * BN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int rows = min(gs[e], C);
  T* yb = y + static_cast<size_t>(e) * C * H;
  if (c0 >= rows) {  // no live row: zeros (under a split the second pass
                     // writes them), no weight traffic
    if constexpr (!kSplit)
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
  int k_begin = 0, k_end = D;
  if constexpr (kSplit) {
    const int split = blockIdx.z / E, nk = (D + BK - 1) / BK;
    k_begin = split * nk / splits * BK;
    k_end = min(D, (split + 1) * nk / splits * BK);
  }
  float acc[4][4] = {}, acc2[4][4] = {};
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
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
      if constexpr (kSplit) {
        const size_t plane = static_cast<size_t>(E) * C * H;
        float* p = ws + static_cast<size_t>(blockIdx.z / E) * (kDual ? 2 : 1) * plane +
                   (static_cast<size_t>(e) * C + r) * H + c;
        p[0] = acc[i][j];
        if constexpr (kDual) p[plane] = acc2[i][j];
      } else {
        const float v = kDual ? fff::silu(acc[i][j]) * acc2[i][j]
                              : fff::activate_as<kAct>(acc[i][j]);
        yb[static_cast<size_t>(r) * H + c] = fff::from_f32<T>(r < rows ? v : 0.0f);
      }
    }
  }
}

// The D split's second pass: y = act(sum of the splits' partials), or
// silu(sum g) * (sum u) for the dual form, summed in split order; zeros at
// rows past the group's size (whose partials are never read).  V adjacent
// columns a thread (H % V == 0), 32-bit index arithmetic (n < 2^31 chunks)
template <typename T, bool kDual, int V>
__global__ void __launch_bounds__(256)
split_sum_kernel(const float* __restrict__ ws, const int* __restrict__ gs, T* __restrict__ y,
                 int E, int C, int H, int splits, int act) {
  const size_t plane = static_cast<size_t>(E) * C * H;
  const int hv = H / V, n = E * C * hv;
  for (int q = blockIdx.x * blockDim.x + threadIdx.x; q < n; q += gridDim.x * blockDim.x) {
    const int row = q / hv, e = row / C, r = row - e * C;
    const size_t i = static_cast<size_t>(q) * V;
    float v[V];
#pragma unroll
    for (int t = 0; t < V; ++t) v[t] = 0.0f;
    if (r < gs[e]) {
      float a[V], b[V];
#pragma unroll
      for (int t = 0; t < V; ++t) a[t] = b[t] = 0.0f;
      for (int s = 0; s < splits; ++s) {
        const float* p = ws + static_cast<size_t>(s) * (kDual ? 2 : 1) * plane + i;
        float pa[V], pb[V];
        if constexpr (V == 4) {
          *reinterpret_cast<float4*>(pa) = *reinterpret_cast<const float4*>(p);
          if constexpr (kDual) *reinterpret_cast<float4*>(pb) = *reinterpret_cast<const float4*>(p + plane);
        } else {
          pa[0] = p[0];
          if constexpr (kDual) pb[0] = p[plane];
        }
#pragma unroll
        for (int t = 0; t < V; ++t) {
          a[t] += pa[t];
          if constexpr (kDual) b[t] += pb[t];
        }
      }
#pragma unroll
      for (int t = 0; t < V; ++t) v[t] = kDual ? fff::silu(a[t]) * b[t] : fff::activate(a[t], act);
    }
    T out[V];
#pragma unroll
    for (int t = 0; t < V; ++t) out[t] = fff::from_f32<T>(v[t]);
    if constexpr (V == 4 && sizeof(T) == 2)
      *reinterpret_cast<uint2*>(y + i) = *reinterpret_cast<const uint2*>(out);
    else if constexpr (V == 4)
      *reinterpret_cast<float4*>(y + i) = *reinterpret_cast<const float4*>(out);
    else
      y[i] = out[0];
  }
}

template <typename T, bool kDual>
cudaError_t split_sum(const float* ws, const int* gs, T* y, int E, int C, int H, int splits,
                      int act, cudaStream_t s) {
  const int V = H % 4 == 0 ? 4 : 1;
  const size_t n = static_cast<size_t>(E) * C * H / V;
  if (n >= (1u << 31)) return cudaErrorInvalidValue;
  const int blocks = static_cast<int>(std::min<size_t>((n + 255) / 256, 2048));
  if (V == 4)
    split_sum_kernel<T, kDual, 4><<<blocks, 256, 0, s>>>(ws, gs, y, E, C, H, splits, act);
  else
    split_sum_kernel<T, kDual, 1><<<blocks, 256, 0, s>>>(ws, gs, y, E, C, H, splits, act);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

constexpr int kTileK = 64;        // k-step: 64 bf16, one 128-byte row of x
constexpr int kAtomBytes = 64 * kRowBytes;   // 64 rows: a 64-row slice of x,
                                             // or one 64-column weight atom

// 128-byte swizzle of a byte offset inside a 1024-aligned region: the
// 16-byte chunk index (bits 4-6) XOR the row within the 8-row group
// (bits 7-9), as wgmma's SW128 layout reads it
__device__ __forceinline__ uint32_t swizzle128(uint32_t off) {
  return off ^ ((off >> 3) & 0x70);
}

// 8 elements of row r, columns c..c+7 of a (rows x cols, leading dim ld)
// matrix into shared memory: one async 16-byte copy when whole and
// aligned, zeros for a chunk wholly outside, else masked element stores
__device__ __forceinline__ void load8(unsigned char* dst, const bf16* src, int r, int c,
                                      int rows, int cols, int ld) {
  const bf16* p = src + static_cast<size_t>(r) * ld + c;
  if (r < rows && c + 8 <= cols && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    cp_async16(smem_addr(dst), p, 16);
  } else if (r >= rows || c >= cols) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  } else {
    bf16* d = reinterpret_cast<bf16*>(dst);
#pragma unroll
    for (int t = 0; t < 8; ++t) d[t] = c + t < cols ? p[t] : __float2bfloat16(0.0f);
  }
}

// 8 bf16 (one uint4) into row r, columns c..c+7 of y (C x H), masked
__device__ __forceinline__ void store8(bf16* y, int r, int c, int C, int H, uint4 v) {
  if (r >= C || c >= H) return;
  bf16* p = y + static_cast<size_t>(r) * H + c;
  if (c + 8 <= H && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    *reinterpret_cast<uint4*>(p) = v;
  } else {
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int t = 0; t < 8; ++t)
      if (c + t < H) p[t] = e[t];
  }
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (all in 16-byte units)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 | static_cast<uint64_t>(sbo >> 4) << 32 |
         1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N, f32 accumulators of the warpgroup) += A (64 x 16, K-major)
// . B (16 x N, MN-major: the transpose flag), both from shared memory
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b);
template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),
        "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// Within each quad of lanes, lane p holds v[t] = columns 8t + 2p, 2p + 1
// of its row (t = 0..3, two bf16 each); afterwards lane q holds the 8
// columns 8q..8q+7 in order: a 4x4 transpose in two shuffle rounds
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int lane) {
  const bool odd = lane & 1, high = lane & 2;
#pragma unroll
  for (int p = 0; p < 4; p += 2) {
    const uint32_t got = __shfl_xor_sync(0xffffffffu, odd ? v[p] : v[p + 1], 1);
    if (odd) v[p] = got; else v[p + 1] = got;
  }
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const uint32_t got = __shfl_xor_sync(0xffffffffu, high ? v[p] : v[p + 2], 2);
    if (high) v[p] = got; else v[p + 2] = got;
  }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// One 64-row slice of a warpgroup's accumulators (m64nNk16, f32: warp w of
// the warpgroup owns rows 16w + lane/4 (+8 for odd pairs); register 4t +
// 2i + {0, 1} holds columns 8t + 2 (lane % 4) + {0, 1} of row +8i; the dual
// form's u columns follow g's, 32 registers on) into 64 columns of y from
// column c0: the activation kAct (silu(g) * u for the dual form), bf16, a
// quad transpose, 16-byte stores; zeros at rows r >= rows
template <bool kDual, int kAct>
__device__ __forceinline__ void store_slice(const float* acc, bf16* yb, int r0, int c0,
                                            int rows, int C, int H, int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    const bool keep = r < rows;
#pragma unroll
    for (int g = 0; g < 2; ++g) {   // 4 column groups of 8 per round
      uint32_t v[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int idx = 4 * (4 * g + t) + 2 * i;
        float a = acc[idx], b = acc[idx + 1];
        if constexpr (kDual) {
          a = fff::silu(a) * acc[idx + 32];
          b = fff::silu(b) * acc[idx + 33];
        } else {
          a = fff::activate_as<kAct>(a);
          b = fff::activate_as<kAct>(b);
        }
        v[t] = keep ? pack_bf16x2(a, b) : 0u;
      }
      quad_transpose(v, lane);
      store8(yb, r, c0 + 8 * (4 * g + lane % 4), C, H, make_uint4(v[0], v[1], v[2], v[3]));
    }
  }
}

// f(std::integral_constant<int, kAct>) for the runtime activation code act
// (the dual form's is always its own), so that each epilogue, or each
// kernel instance on the host, is compiled for one activation
#pragma nv_exec_check_disable
template <bool kDual, typename F>
__host__ __device__ __forceinline__ void with_act(int act, F f) {
  if constexpr (kDual) {
    f(std::integral_constant<int, fff::kActSwiglu>{});
  } else {
    switch (act) {
      case fff::kActRelu: f(std::integral_constant<int, fff::kActRelu>{}); break;
      case fff::kActGelu: f(std::integral_constant<int, fff::kActGelu>{}); break;
      case fff::kActSilu: f(std::integral_constant<int, fff::kActSilu>{}); break;
      default: f(std::integral_constant<int, fff::kActNone>{});
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16, masked path: cp.async by every thread
// ---------------------------------------------------------------------------
constexpr int kTileM = 128;       // token rows per block: two 64-row halves
constexpr int kStages = 4;        // ring of k-steps; 2 in flight ahead of the
                                  // one being multiplied, 1 being drained

// A block is 2 x kCg warpgroups: two 64-row halves times kCg column groups
// of 64 columns per operand: 4 for the down projection (1024 threads, 64
// registers each), 2 for the dual form (its 64 accumulators a thread allow
// 512).
template <bool kDual>
struct TcTile {
  static constexpr int kCg = kDual ? 2 : 4;
  static constexpr int kN = 64 * kCg;            // block columns per operand
  static constexpr int kThreads = 256 * kCg;
  static constexpr int kOps = kDual ? 2 : 1;     // weight operands
  static constexpr int kInstrN = 64 * kOps;      // one wgmma spans [g | u]
  static constexpr int kAcc = kInstrN / 2;       // accumulators a thread
  static constexpr int kStage = kTileM * kRowBytes + kOps * kN * kRowBytes;   // bytes
  static constexpr int kSmem = kStages * kStage + 1024;   // + alignment slack
  static_assert(kSmem <= 232448, "ring exceeds a block's shared memory");
};

template <bool kDual>
__global__ void __launch_bounds__(TcTile<kDual>::kThreads, 1)
grouped_matmul_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                            const bf16* __restrict__ w2, const int* __restrict__ gs,
                            bf16* __restrict__ y, int C, int D, int H, int act) {
  using T = TcTile<kDual>;
  constexpr int kChunks = T::kN / 8;       // 16-byte chunks in a weight row
  constexpr int kAhead = kStages - 2;      // k-steps loaded ahead
  const int e = blockIdx.z, c0 = blockIdx.y * kTileM, h0 = blockIdx.x * T::kN;
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int half = wg % 2, cg = wg / 2;    // this warpgroup's rows and columns
  const int rows = min(gs[e], C);          // the group's live rows
  bf16* yb = y + static_cast<size_t>(e) * C * H;
  if (c0 >= rows) {  // no live row: zeros, no weight traffic
    for (int i = tid; i < kTileM * kChunks; i += T::kThreads)
      store8(yb, c0 + i / kChunks, h0 + 8 * (i % kChunks), C, H, make_uint4(0, 0, 0, 0));
    return;
  }
  const int halves = (min(rows - c0, kTileM) + 63) / 64;   // live 64-row halves
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const bf16* xb = x + static_cast<size_t>(e) * C * D;
  const bf16* wb[2] = {w + static_cast<size_t>(e) * D * H,
                       kDual ? w2 + static_cast<size_t>(e) * D * H : nullptr};
  const int nk = (D + kTileK - 1) / kTileK;

  // A stage: x's rows (128 B each, swizzled; rows of dead halves are not
  // copied), then the weights as 64-column atoms of 64 k-rows (128 B per
  // k-row, swizzled) in (column group, operand) order, so that a
  // warpgroup's g and u atoms are adjacent and one wgmma reads both
  auto load_stage = [&](int kt) {
    unsigned char* st = smem + (kt % kStages) * T::kStage;
    const int k0 = kt * kTileK;
    for (int i = tid; i < halves * 64 * 8; i += T::kThreads) {
      const int r = i / 8, c = i % 8;
      load8(st + swizzle128(r * kRowBytes + c * 16), xb, c0 + r, k0 + 8 * c, rows, D, D);
    }
#pragma unroll
    for (int op = 0; op < T::kOps; ++op)
      for (int i = tid; i < kTileK * kChunks; i += T::kThreads) {
        const int k = i / kChunks, c = i % kChunks;
        const int atom = (c / 8) * T::kOps + op;
        load8(st + kTileM * kRowBytes + swizzle128(atom * kAtomBytes + k * kRowBytes + (c % 8) * 16),
              wb[op], k0 + k, h0 + 8 * c, D, H, H);
      }
  };

  float acc[T::kAcc];
#pragma unroll
  for (int i = 0; i < T::kAcc; ++i) acc[i] = 0.0f;

#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < nk) load_stage(s);
    cp_async_commit();
  }
  // The k loop, with or without this warpgroup's products (a half past the
  // group's size has none).  Each branch holds the whole wgmma pipeline: a
  // pipeline that crosses a divergent branch is serialised by ptxas.
  auto mainloop = [&](auto mma) {
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<kAhead - 1>();   // this thread's copies of step kt landed
      // order them (generic proxy) before wgmma's reads (async proxy)
      fence_proxy_async();
      // everyone's copies landed, and every warpgroup's step kt-2 products
      // are done (its wait below), so step kt-2's stage can refill
      __syncthreads();
      if (kt + kAhead < nk) load_stage(kt + kAhead);
      cp_async_commit();
      if constexpr (decltype(mma)::value) {
        const uint32_t st = smem_addr(smem + (kt % kStages) * T::kStage);
        // x: K-major, 8-row groups 1024 B apart.  w: MN-major (the
        // transpose flag), 8-k-row groups 1024 B apart (stride offset),
        // 64-column atoms kAtomBytes apart (leading offset)
        const uint64_t da = sw128_desc(st + half * kAtomBytes, 16, 1024);
        const uint64_t db = sw128_desc(
            st + kTileM * kRowBytes + cg * T::kOps * kAtomBytes, kAtomBytes, 1024);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTileK / 16; ++kk)   // k16: 32 B along x's rows,
          wgmma_ss<T::kInstrN>(acc, da + (kk * 32 >> 4), db + (kk * 2048 >> 4));  // 16 k-rows of w
        wgmma_commit();
        wgmma_wait<1>();   // step kt-1's products are done; kt's run on
      }
    }
    if constexpr (decltype(mma)::value) wgmma_wait<0>();
  };
  if (half < halves) mainloop(std::true_type{});
  else mainloop(std::false_type{});
  cp_async_wait<0>();
  fence_regs(acc);
  with_act<kDual>(act, [&](auto k) {
    store_slice<kDual, decltype(k)::value>(acc, yb, c0 + half * 64 + (tid % 128) / 32 * 16 +
                                           lane / 4, h0 + cg * 64, rows, C, H, lane);
  });
}

// ---------------------------------------------------------------------------
// bfloat16, TMA path: a producer warp, persistent blocks
// ---------------------------------------------------------------------------
constexpr int kConsumers = 4;                        // consumer warpgroups a block
constexpr int kConsumerWarps = 4 * kConsumers;       // the empty barriers' arrivals
constexpr int kTmaThreads = kConsumers * 128 + 32;   // and one producer warp
constexpr int kRing = 196608;                        // the ring's shared memory

// A unit's tile: kSlices 64-row slices (a row tile of 128 or 256 rows) by
// kCg 64-column atoms.  A warpgroup's column group is kAtoms adjacent atoms:
// two of the down projection where the tile has them, else one (the dual
// form's, with its [g | u] pair): one wgmma of 128 columns where it can.
// The (slice, column group) pairs are dealt to the consumer warpgroups, kSpw
// slices of one column group each; with fewer pairs than warpgroups the
// rest only keep the ring's count.
template <bool kDual, int kSlices, int kCg>
struct TmaTile {
  static constexpr int kOps = kDual ? 2 : 1;
  static constexpr int kAtoms = kDual || kCg == 1 ? 1 : 2;
  static constexpr int kRows = 64 * kSlices;
  static constexpr int kN = 64 * kCg;                    // output columns a unit
  static constexpr int kGroups = kCg / kAtoms;           // column groups a unit
  static constexpr int kPairs = kSlices * kGroups;
  static constexpr int kActive = kPairs < kConsumers ? kPairs : kConsumers;
  static constexpr int kSpw = kPairs / kActive;          // slices a warpgroup
  static constexpr int kRowWgs = kActive / kGroups;      // warpgroups on one column group
  static constexpr int kInstrN = 64 * kAtoms * kOps;
  static constexpr int kSliceAcc = kInstrN / 2;          // accumulators a slice
  static constexpr int kAcc = kSpw * kSliceAcc;
  static constexpr int kXBytes = kSlices * kAtomBytes;   // a stage: x's slices, then
  static constexpr int kStage = kXBytes + kCg * kOps * kAtomBytes;   // the weight atoms
  static constexpr int kStages = kRing / kStage < 8 ? kRing / kStage : 8;
  static constexpr int kSmem = kStages * kStage + 1024;  // + alignment slack
  static_assert(kActive % kGroups == 0 && kSpw * kRowWgs == kSlices, "slices dealt unevenly");
  static_assert(kAcc <= 64, "more than 64 accumulators a thread");
  static_assert(kSmem <= 232448, "ring exceeds a block's shared memory");
};

// L2 policies for the copies: the weights stream through once (evict
// first), x is read again by every column tile of its leaf (evict last)
__device__ __forceinline__ uint64_t l2_policy(bool first) {
  uint64_t p;
  if (first)
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  else
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}
// tma_load with an L2 cache policy
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap& map, int c0, int c1,
                                         int c2, uint32_t bar, uint64_t policy) {
  asm volatile("cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
               ".L2::cache_hint [%0], [%1, {%3, %4, %5}], [%2], %6;\n"
               ::"r"(dst), "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(c0), "r"(c1),
                 "r"(c2), "l"(policy)
               : "memory");
}

template <bool kDual, int kSlices, int kCg, int kAct>
__global__ void __launch_bounds__(kTmaThreads, 1)
grouped_matmul_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                          const __grid_constant__ CUtensorMap wmap,
                          const __grid_constant__ CUtensorMap w2map,
                          const int* __restrict__ gs, bf16* __restrict__ y,
                          float* __restrict__ ws, int E, int C, int D, int H, int splits) {
  using T = TmaTile<kDual, kSlices, kCg>;
  constexpr int kAtoms = T::kAtoms;
  static_assert(kDual == (kAct == fff::kActSwiglu), "the dual form's activation is its own");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  __shared__ __align__(8) uint64_t full[T::kStages], empty[T::kStages];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(smem_addr(&full[s]));
      mbar_init(smem_addr(&empty[s]), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int nk = (D + kTileK - 1) / kTileK;            // k-steps over all of D
  const int tiles = (H + T::kN - 1) / T::kN;
  const int units = E * tiles * splits;
  // unit u: leaf u / (tiles splits), column tile, range [kb, ke) of k-steps
  auto unit = [&](int u, int& e, int& n0, int& split, int& kb, int& ke) {
    split = u % splits;
    n0 = (u / splits) % tiles * T::kN;
    e = u / (splits * tiles);
    kb = split * nk / splits;
    ke = (split + 1) * nk / splits;
  };

  if (warp == kConsumerWarps) {   // the producer
    if (lane != 0) return;
    const uint64_t stream = l2_policy(true), keep = l2_policy(false);
    uint32_t it = 0;              // k-steps issued so far: the ring position
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      int e, n0, split, kb, ke;
      unit(u, e, n0, split, kb, ke);
      const int rows = min(gs[e], C);
      int atoms = 0;              // weight atoms inside H (the rest are never read out)
#pragma unroll
      for (int cg = 0; cg < kCg; ++cg) atoms += n0 + 64 * cg < H;
      for (int r0 = 0; r0 < rows; r0 += T::kRows) {
        const int live = (min(rows - r0, T::kRows) + 63) / 64;   // live slices
        const uint32_t bytes = (live + atoms * T::kOps) * kAtomBytes;
        for (int kt = kb; kt < ke; ++kt, ++it) {
          const int s = it % T::kStages;
          mbar_wait(smem_addr(&empty[s]), ((it / T::kStages) & 1) ^ 1);
          const uint32_t bar = smem_addr(&full[s]);
          const uint32_t st = smem_addr(smem + s * T::kStage);
          mbar_expect(bar, bytes);
          for (int sl = 0; sl < live; ++sl)
            tma_load(st + sl * kAtomBytes, xmap, kt * kTileK, r0 + 64 * sl, e, bar, keep);
#pragma unroll
          for (int cg = 0; cg < kCg; ++cg)
            if (n0 + 64 * cg < H) {
              const uint32_t at = st + T::kXBytes + cg * T::kOps * kAtomBytes;
              tma_load(at, wmap, n0 + 64 * cg, kt * kTileK, e, bar, stream);
              if constexpr (kDual)
                tma_load(at + kAtomBytes, w2map, n0 + 64 * cg, kt * kTileK, e, bar, stream);
            }
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg multiplies column group cg of the unit's
  // tile (atoms cg kAtoms ...) for row slices rw, rw + kRowWgs, ...
  const int wg = warp / 4, wl = warp % 4;
  const bool active = wg < T::kActive;
  const int cg = wg % T::kGroups, rw = wg / T::kGroups;
  const size_t plane = static_cast<size_t>(E) * C * H;
  uint32_t it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    int e, n0, split, kb, ke;
    unit(u, e, n0, split, kb, ke);
    const int rows = min(gs[e], C);
    bf16* yb = y + static_cast<size_t>(e) * C * H;
    int r0 = 0;
    for (; r0 < rows; r0 += T::kRows) {
      const int tile_rows = min(rows - r0, T::kRows);
      int mine = 0;   // this warpgroup's live slices: its first `mine`
#pragma unroll
      for (int j = 0; j < T::kSpw; ++j) mine += active && (rw + j * T::kRowWgs) * 64 < tile_rows;
      float acc[T::kAcc];
#pragma unroll
      for (int i = 0; i < T::kAcc; ++i) acc[i] = 0.0f;
      // The k loop with kLive slices' products.  Each instance holds the
      // whole wgmma pipeline (a pipeline that crosses a divergent branch is
      // serialised by ptxas); a warpgroup with none still waits for each
      // stage and releases it, so every warp's arrivals stay in step.
      auto mainloop = [&](auto live) {
        constexpr int kLive = decltype(live)::value;
        for (int kt = kb; kt < ke; ++kt, ++it) {
          const int s = it % T::kStages;
          mbar_wait(smem_addr(&full[s]), (it / T::kStages) & 1);
          if constexpr (kLive > 0) {
            const uint32_t st = smem_addr(smem + s * T::kStage);
            // x: K-major, 8-row groups 1024 B apart.  w: MN-major (the
            // transpose flag), 8-k-row groups 1024 B apart (stride offset),
            // its atoms ([g | u] for the dual form) kAtomBytes apart
            // (leading offset)
            const uint64_t db = sw128_desc(
                st + T::kXBytes + cg * kAtoms * T::kOps * kAtomBytes, kAtomBytes, 1024);
            fence_regs(acc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kTileK / 16; ++kk)
#pragma unroll
              for (int j = 0; j < kLive; ++j) {
                const uint64_t da = sw128_desc(st + (rw + j * T::kRowWgs) * kAtomBytes, 16, 1024);
                wgmma_ss<T::kInstrN>(acc + j * T::kSliceAcc, da + (kk * 32 >> 4),
                                     db + (kk * 2048 >> 4));
              }
            wgmma_commit();
            wgmma_wait<1>();   // the step before's products are done: release its stage
            if (kt > kb && lane == 0) mbar_arrive(smem_addr(&empty[(it - 1) % T::kStages]));
          } else {
            if (lane == 0) mbar_arrive(smem_addr(&empty[s]));
          }
        }
        if constexpr (kLive > 0) {
          wgmma_wait<0>();
          if (lane == 0) mbar_arrive(smem_addr(&empty[(it - 1) % T::kStages]));
        }
      };
      if (mine == 0) mainloop(std::integral_constant<int, 0>{});
      else if (mine == 1) mainloop(std::integral_constant<int, 1>{});
      else mainloop(std::integral_constant<int, T::kSpw>{});
      fence_regs(acc);
      if (!active) continue;
      const int c = n0 + cg * kAtoms * 64;
      if (splits == 1) {
#pragma unroll
        for (int j = 0; j < T::kSpw; ++j)
#pragma unroll
          for (int a = 0; a < kAtoms; ++a)
            store_slice<kDual, kAct>(acc + j * T::kSliceAcc + 32 * a, yb,
                                     r0 + (rw + j * T::kRowWgs) * 64 + wl * 16 + lane / 4,
                                     c + 64 * a, rows, C, H, lane);
        continue;
      }
      // f32 partials of the live slices' rows
      float* p = ws + static_cast<size_t>(split) * T::kOps * plane + static_cast<size_t>(e) * C * H;
#pragma unroll
      for (int j = 0; j < T::kSpw; ++j) {
        if (j >= mine) continue;
        const int r = r0 + (rw + j * T::kRowWgs) * 64 + wl * 16 + lane / 4;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int rr = r + 8 * i;
          if (rr >= C) continue;
#pragma unroll
          for (int t = 0; t < 8 * kAtoms; ++t) {
            const int cc = c + 8 * t + 2 * (lane % 4);
            if (cc >= H) continue;
            const int idx = j * T::kSliceAcc + 4 * t + 2 * i;
            float* q = p + static_cast<size_t>(rr) * H + cc;
            *reinterpret_cast<float2*>(q) = make_float2(acc[idx], acc[idx + 1]);
            if constexpr (kDual)
              *reinterpret_cast<float2*>(q + plane) = make_float2(acc[idx + 32], acc[idx + 33]);
          }
        }
      }
    }
    if (splits == 1) {   // rows [r0, C) hold no live row: zeros
      constexpr int kChunks = T::kN / 8;
      for (int i = tid; i < (C - r0) * kChunks; i += kConsumers * 128)
        store8(yb, r0 + i / kChunks, n0 + 8 * (i % kChunks), C, H, make_uint4(0, 0, 0, 0));
    }
  }
}

// a contiguous bf16 array (outer, mid, inner) as a 3-D tensor map read in
// boxes of 64 inner elements (128 bytes) by 64 rows of one outer index,
// 128-byte swizzle, zeros outside
cudaError_t box_map(CUtensorMap* map, const void* base, int inner, int mid, int outer) {
  const PFN_cuTensorMapEncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(mid),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(inner) * sizeof(bf16),
                                 static_cast<cuuint64_t>(mid) * inner * sizeof(bf16)};
  const cuuint32_t box[3] = {kTileK, 64, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
      unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A weight's tensor map, cached by (pointer, shape, device): a map is a
// pure function of those (the weights are contiguous), so a stale entry
// whose pointer was reused for a tensor of the same shape is still right.
struct MapKey {
  const void* p;
  int E, D, H, device;
  bool operator==(const MapKey& o) const {
    return p == o.p && E == o.E && D == o.D && H == o.H && device == o.device;
  }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    size_t h = std::hash<const void*>()(k.p);
    const int parts[4] = {k.E, k.D, k.H, k.device};
    for (int v : parts) h = h * 1000003u ^ static_cast<size_t>(v);
    return h;
  }
};

cudaError_t weight_map(CUtensorMap* map, const void* w, int E, int D, int H, int device) {
  constexpr size_t kMaxMaps = 4096;   // cleared when full (new weights each call)
  static std::mutex mu;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> cache;
  const MapKey key{w, E, D, H, device};
  std::lock_guard<std::mutex> lock(mu);
  const auto found = cache.find(key);
  if (found != cache.end()) {
    *map = found->second;
    return cudaSuccess;
  }
  if (const cudaError_t err = box_map(map, w, H, D, E)) return err;
  if (cache.size() >= kMaxMaps) cache.clear();
  cache.emplace(key, *map);
  return cudaSuccess;
}

// raises one kernel's dynamic shared-memory limit to `bytes`, once a
// device; `allowed` is that kernel's own record of what it allows so far
cudaError_t allow_smem(int (&allowed)[kMaxDevices], const void* kernel, int bytes, int device) {
  if (device < kMaxDevices && allowed[device] >= bytes) return cudaSuccess;
  if (const cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes))
    return err;
  if (device < kMaxDevices) allowed[device] = bytes;
  return cudaSuccess;
}

template <bool kDual, int kSlices, int kCg>
cudaError_t launch_tma_as(const bf16* x, const bf16* w, const bf16* w2, const int* gs, bf16* y,
                          float* ws, int E, int C, int D, int H, int act, int splits, int grid,
                          int device, cudaStream_t s) {
  using T = TmaTile<kDual, kSlices, kCg>;
  CUtensorMap xmap, wmap, w2map = {};
  if (const cudaError_t err = box_map(&xmap, x, D, C, E)) return err;
  if (const cudaError_t err = weight_map(&wmap, w, E, D, H, device)) return err;
  if constexpr (kDual)
    if (const cudaError_t err = weight_map(&w2map, w2, E, D, H, device)) return err;
  cudaError_t err = cudaSuccess;
  with_act<kDual>(act, [&](auto k) {   // a kernel compiled for the activation
    auto kernel = grouped_matmul_tma_kernel<kDual, kSlices, kCg, decltype(k)::value>;
    static int allowed[kMaxDevices] = {};
    err = allow_smem(allowed, reinterpret_cast<const void*>(kernel), T::kSmem, device);
    if (err == cudaSuccess) {
      kernel<<<grid, kTmaThreads, T::kSmem, s>>>(xmap, wmap, w2map, gs, y, ws, E, C, D, H,
                                                 splits);
      err = cudaGetLastError();
    }
  });
  if (err != cudaSuccess) return err;
  return splits > 1 ? split_sum<bf16, kDual>(ws, gs, y, E, C, H, splits, act, s) : cudaSuccess;
}

// the tiles a plan may name (kernel.py TMA_COLS): rows 128 or 256; columns
// 64 to 256 for the down projection, 64 or 128 for the dual form
template <bool kDual>
cudaError_t launch_tma(const bf16* x, const bf16* w, const bf16* w2, const int* gs, bf16* y,
                       float* ws, int E, int C, int D, int H, int act, int rows, int cols,
                       int splits, int grid, int device, cudaStream_t s) {
#define FFF_TMA(S, G) \
  launch_tma_as<kDual, S, G>(x, w, w2, gs, y, ws, E, C, D, H, act, splits, grid, device, s)
  if (rows == 128 && cols == 64) return FFF_TMA(2, 1);
  if (rows == 128 && cols == 128) return FFF_TMA(2, 2);
  if (rows == 256 && cols == 64) return FFF_TMA(4, 1);
  if constexpr (!kDual) {
    if (rows == 128 && cols == 256) return FFF_TMA(2, 4);
    if (rows == 256 && cols == 128) return FFF_TMA(4, 2);
  }
#undef FFF_TMA
  return cudaErrorInvalidValue;
}

template <bool kDual>
int launch(const void* x, const void* w, const void* w2, const int* gs, void* y, void* ws,
           int E, int C, int D, int H, int act, int dtype, int path, int rows, int cols,
           int splits, int grid, int device, void* stream) {
  if (E < 1 || C < 1 || D < 1 || H < 1 || splits < 1 || grid < 1) return cudaErrorInvalidValue;
  if (splits > 1 && ws == nullptr) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(ws);
  cudaError_t err = cudaErrorInvalidValue;
  if (path == kPathCudaCores && dtype == fff::kF32) {
    if (splits > (D + BK - 1) / BK || static_cast<long long>(E) * splits > 65535)
      return cudaErrorInvalidValue;
    const dim3 blocks((H + BN - 1) / BN, (C + BM - 1) / BM, E * splits);
    const float* xf = static_cast<const float*>(x);
    float* yf = static_cast<float*>(y);
    auto run = [&](auto kernel) {
      kernel<<<blocks, kThreads, 0, s>>>(xf, static_cast<const float*>(w),
                                         static_cast<const float*>(w2), gs, yf, part, E, C, D,
                                         H, splits);
    };
    if (splits > 1)
      run(grouped_matmul_kernel<float, kDual, true, fff::kActNone>);
    else
      with_act<kDual>(act, [&](auto k) {
        run(grouped_matmul_kernel<float, kDual, false, decltype(k)::value>);
      });
    err = cudaGetLastError();
    if (err == cudaSuccess && splits > 1)
      err = split_sum<float, kDual>(part, gs, yf, E, C, H, splits, act, s);
  } else if (path == kPathMasked && dtype == fff::kBF16 && splits == 1) {
    using T = TcTile<kDual>;
    auto kernel = grouped_matmul_wgmma_kernel<kDual>;
    static int allowed[kMaxDevices] = {};
    err = allow_smem(allowed, reinterpret_cast<const void*>(kernel), T::kSmem, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 blocks((H + T::kN - 1) / T::kN, (C + kTileM - 1) / kTileM, E);
    kernel<<<blocks, T::kThreads, T::kSmem, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<const bf16*>(w2), gs, static_cast<bf16*>(y), C, D, H, act);
    err = cudaGetLastError();
  } else if (path == kPathTma && dtype == fff::kBF16 && splits <= (D + kTileK - 1) / kTileK) {
    err = launch_tma<kDual>(static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                            static_cast<const bf16*>(w2), gs, static_cast<bf16*>(y), part, E,
                            C, D, H, act, rows, cols, splits, grid, device, s);
  }
  return static_cast<int>(err);
}

}  // namespace

// x (E, C, D), w (E, D, H), group_sizes (E,) int32 -> y (E, C, H), one
// dtype; act is an activation code other than swiglu.  The plan (path,
// rows, cols, splits, grid) comes from kernels/leaf_gemm/kernel.py::plan;
// ws holds splits x E x C x H float32 partials when splits > 1, else may be
// null.  Returns the first CUDA error (a refused plan or tensor map
// included), else cudaGetLastError() after the launches.
extern "C" int grouped_matmul(const void* x, const void* w, const int* gs, void* y, void* ws,
                              int E, int C, int D, int H, int act, int dtype, int path,
                              int rows, int cols, int splits, int grid, int device,
                              void* stream) {
  if (const cudaError_t err = cudaSetDevice(device)) return static_cast<int>(err);
  if (act < fff::kActNone || act > fff::kActSilu) return cudaErrorInvalidValue;
  return launch<false>(x, w, nullptr, gs, y, ws, E, C, D, H, act, dtype, path, rows, cols,
                       splits, grid, device, stream);
}

// SwiGLU up-projection: y = silu(x @ wg) * (x @ wu), grouped per leaf; ws
// holds splits x 2 x E x C x H float32 partials (g's, then u's) when
// splits > 1.
extern "C" int grouped_matmul_dual(const void* x, const void* wg, const void* wu,
                                   const int* gs, void* y, void* ws, int E, int C, int D,
                                   int H, int dtype, int path, int rows, int cols, int splits,
                                   int grid, int device, void* stream) {
  if (const cudaError_t err = cudaSetDevice(device)) return static_cast<int>(err);
  return launch<true>(x, wg, wu, gs, y, ws, E, C, D, H, fff::kActSwiglu, dtype, path, rows,
                      cols, splits, grid, device, stream);
}
