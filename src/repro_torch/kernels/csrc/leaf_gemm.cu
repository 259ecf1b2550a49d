// Ragged grouped GEMM over capacity-padded leaf groups.
//
// Replaces repro/kernels/leaf_gemm/kernel.py::grouped_matmul (y[e] =
// act(x[e] @ w[e])) and ::grouped_matmul_dual (the SwiGLU up-projection
// silu(x[e] @ wg[e]) * (x[e] @ wu[e])), Pallas TPU kernels.  x (E, C, D)
// holds each leaf's routed tokens in its first group_sizes[e] rows (zeros
// after); w (E, D, H).  Rows at or past group_sizes[e] come out zero, and
// a token tile with no live row reads no weights, as the Pallas kernel's
// ragged early-out does.
//
// Bound on the H100: bytes.  At internlm2-20b prefill (E = 16, C = 128,
// 1024 tokens) the weights dominate the traffic: 201 MB per 6144 x 1024
// weight set in bf16, read once per live leaf, so ~68 us for the down
// projection (1024 -> 6144, with 25 MB of output) and ~125 us for the
// dual form (two weight sets, 6144 -> 1024).  The arithmetic intensity is
// at most C = 128 operations per weight byte, below the ~295 where the
// tensor cores would be the limit, yet at the bound the dual still needs
// ~200 TFLOP/s of bf16 products: more than warp-level mma reaches from
// small tiles, so bf16 runs on wgmma.
//
// float32 runs on the CUDA cores (off the bf16 main path): one block per
// (leaf e, 64-token tile, 64-column tile), the loop over D inside the
// block taking the place of the TPU's sequential k grid axis and its VMEM
// accumulator; 16-deep slices of x and w staged in shared memory, each of
// 256 threads accumulating a 4x4 output patch (two for the dual form) in
// f32 registers, so float32 inputs keep full float32 products.
//
// bfloat16 (one kernel template for both forms, below): one block per
// (leaf, column tile) covers 128 token rows, the whole group at the main
// path's capacity, so each weight tile crosses from memory once per leaf;
// C > 128 adds a grid row axis (one block per 128 rows, each rereading the
// weights; not on the measured path, where C = 128).  A block is two
// 64-row halves times 2 (dual) or 4 (down) column groups of 64 columns,
// one warpgroup each, so the block's x tile feeds 128 (dual, per operand)
// or 256 (down) columns.  Each warpgroup runs wgmma.mma_async with both
// operands in shared memory through hand-built matrix descriptors, f32
// accumulators in registers: x K-major, w (D, H) MN-major through the
// instruction's B-transpose flag, both in the 128-byte swizzle; the dual
// form's g and u atoms sit side by side, so one m64n128k16 computes both
// from one read of x.  A half at or past the group's size issues no wgmma
// and stores zeros.  64-deep k-steps (one 128-byte row of x) stream
// through a 4-stage ring with 16-byte cp.async copies issued by every
// thread straight into the swizzled layout; ragged or unaligned edges (the
// tests' leaf widths 4 and 8, D or H off the tile) take masked element
// copies, and rows past the group's size are zero-filled instead of read.
// Copies run two k-steps ahead while the products of the step before
// last drain (wgmma.wait_group 1).  The epilogue works on the accumulators
// in registers: the activation (or silu(g) * u), bf16 rounding, a shuffle
// within each 4-lane quad that gathers 8 adjacent columns per lane, and
// one 16-byte store per lane where the row allows.
// Copies are cp.async and not TMA: a TMA tensor map is encoded on the host
// per call and pointer (a cost on a prefill that is host-bound), and
// cannot describe the 8-byte row strides of leaf width 4.  On the H100 the
// copies are what limits the down projection: with its products removed
// its copies alone stream below the card's rate, most of all with its
// 16 k-steps per block, whose ramp-up and drain are exposed (one block
// per SM).  A TMA producer warp and persistent blocks are the next step.
#include <type_traits>

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

// ---------------------------------------------------------------------------
// bfloat16: wgmma
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

constexpr int kTileM = 128;       // token rows per block: two 64-row halves
constexpr int kTileK = 64;        // k-step: 64 bf16, one 128-byte row of x
constexpr int kRowBytes = 128;    // one swizzled row (and the swizzle's span)
constexpr int kAtomBytes = 64 * kRowBytes;   // 64 rows: a half's x, or one
                                             // 64-column weight atom
constexpr int kStages = 4;        // ring of k-steps; 2 in flight ahead of the
                                  // one being multiplied, 1 being drained

// A block is 2 x kCg warpgroups: two 64-row halves times kCg column groups
// of 64 columns per operand.  The down projection takes 4 column groups
// (1024 threads, 64 registers each: more threads keep more 16-byte copies
// in flight), the dual form 2 (its 64 accumulators a thread allow 512).
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 128-byte swizzle of a byte offset inside a 1024-aligned region: the
// 16-byte chunk index (bits 4-6) XOR the row within the 8-row group
// (bits 7-9), as wgmma's SW128 layout reads it
__device__ __forceinline__ uint32_t swizzle128(uint32_t off) {
  return off ^ ((off >> 3) & 0x70);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 8 elements of row r, columns c..c+7 of a (rows x cols, leading dim ld)
// matrix into shared memory: one async 16-byte copy when whole and
// aligned, zeros for a chunk wholly outside, else masked element stores
__device__ __forceinline__ void load8(unsigned char* dst, const bf16* src, int r, int c,
                                      int rows, int cols, int ld) {
  const bf16* p = src + static_cast<size_t>(r) * ld + c;
  if (r < rows && c + 8 <= cols && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    cp_async16(smem_addr(dst), p);
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
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

  // epilogue from registers.  Accumulator layout (m64nNk16, f32): warp w
  // of the warpgroup owns rows 16w + lane/4 (+8 for odd pairs); register
  // 4t + 2i + {0, 1} holds columns 8t + 2 (lane % 4) + {0, 1} of row +8i;
  // u's columns (dual) follow g's, 32 registers on
  const int r0 = c0 + half * 64 + (tid % 128) / 32 * 16 + lane / 4;
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
          a = fff::activate(a, act);
          b = fff::activate(b, act);
        }
        v[t] = keep ? pack_bf16x2(a, b) : 0u;
      }
      quad_transpose(v, lane);
      store8(yb, r, h0 + cg * 64 + 8 * (4 * g + lane % 4), C, H,
             make_uint4(v[0], v[1], v[2], v[3]));
    }
  }
}

template <bool kDual>
int launch(const void* x, const void* w, const void* w2, const int* gs,
           void* y, int E, int C, int D, int H, int act, int dtype,
           int device, void* stream) {
  if (E < 1 || C < 1 || D < 1 || H < 1) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == fff::kF32) {
    const dim3 grid((H + BN - 1) / BN, (C + BM - 1) / BM, E);
    grouped_matmul_kernel<float, kDual><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(w2), gs, static_cast<float*>(y), C, D, H, act);
  } else if (dtype == fff::kBF16) {
    using T = TcTile<kDual>;
    auto kernel = grouped_matmul_wgmma_kernel<kDual>;
    static unsigned configured = 0;   // devices whose shared-memory limit is raised
    if (device >= 32 || !(configured >> device & 1u)) {
      if (const cudaError_t err = cudaFuncSetAttribute(
              kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem))
        return static_cast<int>(err);
      if (device < 32) configured |= 1u << device;
    }
    const dim3 grid((H + T::kN - 1) / T::kN, (C + kTileM - 1) / kTileM, E);
    kernel<<<grid, T::kThreads, T::kSmem, s>>>(
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
  return launch<false>(x, w, nullptr, gs, y, E, C, D, H, act, dtype, device, stream);
}

// SwiGLU up-projection: y = silu(x @ wg) * (x @ wu), grouped per leaf.
extern "C" int grouped_matmul_dual(const void* x, const void* wg,
                                   const void* wu, const int* gs, void* y,
                                   int E, int C, int D, int H, int dtype,
                                   int device, void* stream) {
  if (const cudaError_t err = cudaSetDevice(device)) return static_cast<int>(err);
  return launch<true>(x, wg, wu, gs, y, E, C, D, H, fff::kActSwiglu, dtype,
                      device, stream);
}
