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
// float32 runs on the CUDA cores in full float32 (fused multiply-adds, no
// TF32) in one of two forms, which kernels/leaf_gemm/kernel.py::plan names
// by N, the output columns.  Bound on the H100: at the main shape the
// operations (the dual's 25.8 GFLOP over 1024 tokens at 67 TFLOP/s, 0.385 ms,
// against 0.24 ms for its weights' bytes); at the ViT's and the draft's
// narrow leaves, x's bytes.  Both forms stream k-steps of 32 floats (one
// 128-byte row of x) through a ring of kF32Stages shared-memory stages that
// every thread fills with 16-byte cp.async copies, so the next steps' loads
// are in flight while one is multiplied.  x's rows lie 144 bytes apart in a
// stage (a 16-byte pad), so the 8 rows a warp reads at one k fall in
// distinct banks.  Operands a 16-byte copy cannot describe (D or H off 4, a
// base off 16 bytes) take element-wise copies by every thread into the same
// layout, in the same kernel.
//
// Wide form (N > 32): a block is (leaf, 128 or 64 rows, 128 weight
// columns[, range of D]): 128 output columns, or the dual form's 64 of g
// beside the same 64 of u, so that one read of x feeds both.  Its warps are
// 4 or 2 row slices of 32 by 4 column groups, each thread a 4 x 8 patch of
// accumulators: for 4 k it reads its 4 rows of x as float4s along k and 4
// rows of its 8 weight columns, 12 loads for 128 multiply-adds.  The plan
// takes 128 rows where D is long (a weight panel streams once for them) and
// 64 (two blocks an SM) where D is short or C small.  A warp whose slice
// lies wholly at or past the group's size issues no multiply-add (at ~64 +-
// 8 tokens a leaf of capacity 128, a sixth of the products fall on dead
// rows, where a 64-row granularity wastes a third); each scheduler of the SM
// holds one warp of every slice, so 64 or 96 live rows keep all four busy;
// and where a leaf has one row tile, the dual form deals the leaves to the
// blocks most live rows first.  A thread's copies keep fixed sources that
// advance by the step.  (On the
// H100: an 8 x 8 patch, at 128 registers for two blocks an SM or with 8
// warps for one, ran slower; so did a break inside the full steps' loop,
// and multiplying only 16 rows of a slice with at most 16 live (faster at
// one shape, slower at others).  Dealing leaves by load is compiled into
// the dual form only: its code slowed the down projection's instances,
// which never took it.)
// Capacities above the tile take more row tiles in the grid.
//
// Narrow form (N <= 32): a block is (leaf, R rows, all N columns[, range of
// D]) with its threads over (rows, group of CT columns), CT (the plan's
// cols) the largest of 8, 4, 2 and 1 that divides N, so that no thread
// computes a column that does not exist; a thread takes 4 rows where N has
// more than one group (each load of the panel feeds 4 rows), else 1.  A
// stage holds the R rows of x and the step's 32 rows of the leaf's weight
// panel (32 x N floats, read by broadcast).  The plan splits a long D over
// blocks (the starcoder2 draft's 6144 at 8 leaves), shortens R where a
// short D leaves few blocks, and keeps the ring within the 227 KB a block
// may hold.
//
// Either form splits D only where its blocks are fewer than the SMs; each
// range writes f32 partials to the workspace, and split_sum_kernel sums
// them in split order.
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
constexpr int kF32Step = 32;      // k-step: 32 floats, one 128-byte row of x
constexpr int kXRow = 36;         // floats from one row of x to the next in a stage
constexpr int kF32Stages = 3;     // ring: two steps in flight beside the one multiplied
constexpr int kF32Threads = 256;  // narrow form: a block's most threads
constexpr int kWideCols = 128;    // wide form: a block's weight columns
constexpr int kNarrowMax = 32;    // N at or below which the narrow form runs

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// 4 floats from src into shared dst (16-byte aligned), the first `valid` of
// them read and the rest zero: one async 16-byte copy when vec (src 16-byte
// aligned), else element by element
__device__ __forceinline__ void copy4(float* dst, const float* src, int valid, bool vec) {
  if (valid <= 0) {
    *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  } else if (vec) {
    cp_async16(smem_addr(dst), src, 4 * min(valid, 4));
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t) dst[t] = t < valid ? __ldg(src + t) : 0.0f;
  }
}

// rows [r0, r0 + n) of x (row length D) at k-step k0 into a stage, row i's
// 32 floats at st + i * kXRow; columns past D are zeros
__device__ __forceinline__ void load_x(float* st, const float* xb, int r0, int n, int k0, int D,
                                       bool vec, int tid, int nthreads) {
  for (int i = tid; i < n * 8; i += nthreads) {
    const int r = i >> 3, k = k0 + 4 * (i & 7);
    copy4(st + r * kXRow + 4 * (i & 7), xb + static_cast<size_t>(r0 + r) * D + k, D - k, vec);
  }
}

// n floats (a multiple of 4) from src, the first `valid` read and the rest
// zero, into shared dst: 16-byte copies where src is 16-byte aligned
__device__ __forceinline__ void load_flat(float* dst, const float* src, int valid, int n,
                                          int tid, int nthreads) {
  const bool vec = aligned16(src);
  for (int i = tid; i < n / 4; i += nthreads) copy4(dst + 4 * i, src + 4 * i, valid - 4 * i, vec);
}

// 4 floats into columns c..c+3 of a row of length H: one 16-byte store when
// vec (H % 4 == 0, the row 16-byte aligned), else masked element stores
__device__ __forceinline__ void store4(float* row, int c, int H, float4 v, bool vec) {
  if (c >= H) return;
  if (vec) {
    *reinterpret_cast<float4*>(row + c) = v;
    return;
  }
  const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int t = 0; t < 4; ++t)
    if (c + t < H) row[c + t] = e[t];
}

__device__ __forceinline__ float lane_of(const float4& a, int q) {
  return q == 0 ? a.x : q == 1 ? a.y : q == 2 ? a.z : a.w;
}

// With one row tile a leaf (C <= 128) a block's work grows with its leaf's
// live 32-row slices.  Slot s of the leaves then goes to the leaf of rank s
// in the order of most live slices first (ties by index), so the blocks the
// scheduler starts first carry the most work and the last wave the least.
// Every thread returns the same leaf; gs is read on the device.
__device__ __forceinline__ int leaf_by_load(const int* gs, int E, int C, int slot, int tid,
                                            int nthreads) {
  __shared__ int leaf;
  for (int t = tid; t < E; t += nthreads) {
    const int mine = (min(gs[t], C) + 31) / 32;
    int rank = 0;
    for (int e = 0; e < E; ++e) {
      const int s = (min(gs[e], C) + 31) / 32;
      rank += s > mine || (s == mine && e < t);
    }
    if (rank == slot) leaf = t;
  }
  __syncthreads();
  return leaf;
}
constexpr int kMaxSortedLeaves = 256;   // more leaves keep their index order

// Wide form.  One block per (leaf, kRows-row tile, column tile[, range of
// D]), blockIdx.x = ((split * E + leaf) * row tiles + row tile) * column
// tiles + column tile (kernel.py::work's order), of kRows / 8 warps: row
// slices of 32 by 4 column groups of 32 weight columns, a thread 4 rows (rg
// + 8 i) by 8 weight columns.  Warp w takes column group w % 4 and slice w
// / 4, so each of the SM's four schedulers holds one warp of every slice,
// and a group of 64 or 96 live rows keeps all four busy; with one row tile
// a leaf, the dual form takes the leaves in leaf_by_load's order.  Unsplit
// (kSplit false) it writes y with the activation kAct fixed at compile
// time; split, its f32 sums over its range of D go to ws (splits, ops, E,
// C, H) and split_sum_kernel finishes.  vec_x: D % 4 == 0 and x on 16 bytes; vec_w:
// H % 4 == 0 and the weights on 16 bytes.
constexpr int kTR = 4, kLR = 8, kLC = 4;   // a thread's rows; a warp's row and column lanes

template <int kRows, bool kDual, bool kSplit, int kAct>
__global__ void __launch_bounds__(kRows * 4, kRows == 64 ? 2 : 1)
f32_wide_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ w2, const int* __restrict__ gs, float* __restrict__ y,
                float* __restrict__ ws, int E, int C, int D, int H, int splits, int vec_x,
                int vec_w) {
  constexpr int kThreads = kRows * 4;                               // 32-row slices x 4 groups
  constexpr int kOut = kDual ? kWideCols / 2 : kWideCols;           // output columns a block
  constexpr int kXFloats = kRows * kXRow;
  constexpr int kStage = kXFloats + kF32Step * kWideCols;           // floats a stage
  const int ctiles = (H + kOut - 1) / kOut, rtiles = (C + kRows - 1) / kRows;
  const int ct = blockIdx.x % ctiles, rt = blockIdx.x / ctiles % rtiles;
  const int z = blockIdx.x / (ctiles * rtiles), split = z / E;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int e = z % E;
  if constexpr (kDual)
    if (rtiles == 1 && E <= kMaxSortedLeaves) e = leaf_by_load(gs, E, C, e, tid, kThreads);
  const int r0 = rt * kRows, n0 = ct * kOut;
  const int rows = min(gs[e], C);
  float* yb = y + static_cast<size_t>(e) * C * H;
  if (r0 >= rows) {  // no live row: zeros (under a split the second pass
                     // writes them), no weight traffic
    if constexpr (!kSplit)
      for (int i = tid; i < kRows * kOut / 4; i += kThreads) {
        const int r = r0 + i / (kOut / 4);
        if (r < C)
          store4(yb + static_cast<size_t>(r) * H, n0 + 4 * (i % (kOut / 4)), H,
                 make_float4(0.0f, 0.0f, 0.0f, 0.0f), (H & 3) == 0);
      }
    return;
  }
  const int live = min(rows - r0, kRows);   // the tile's live rows
  const int slice = warp >> 2, cgrp = warp & 3;
  const int rg = lane / kLC, cg = lane % kLC;   // the lane's rows rg + kLR i
  const bool mine = slice * 32 < live;          // a slice past the group's size: no products
  // the lane's two groups of 4 weight columns in the stage, [c0, c0 + 4)
  // and [c1, c1 + 4): of the down projection's 128, or g's and u's of the
  // same 4 output columns for the dual form
  const int c0 = kDual ? cgrp * 4 * kLC + cg * 4 : cgrp * 8 * kLC + cg * 4;
  const int c1 = kDual ? kWideCols / 2 + c0 : c0 + 4 * kLC;
  const int nk = (D + kF32Step - 1) / kF32Step;
  const int kb = split * nk / splits, ke = (split + 1) * nk / splits;
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  const float* xb = x + static_cast<size_t>(e) * C * D;
  const float* wb = w + static_cast<size_t>(e) * D * H;
  const float* w2b = kDual ? w2 + static_cast<size_t>(e) * D * H : nullptr;

  // a k-step's stage: x's live rows, then 32 weight rows of kWideCols
  // columns ([n0, n0 + 128) of w, or [n0, n0 + 64) of w then of w2).  A
  // thread's pieces are fixed across steps: where every piece of the step
  // is whole (vec, k0 + 32 <= D, the tile inside H), each is one 16-byte
  // copy from a source that advances by the step
  constexpr int kXPieces = kRows * 8 / kThreads;   // a thread's x pieces at most
  constexpr int kWPieces = kF32Step * kWideCols / 4 / kThreads;
  // piece j of the thread: x row tid / 8 + j kRows / 2, weight row tid / 32
  // + j kThreads / 32, at a fixed column
  const float* xsrc = xb + static_cast<size_t>(r0 + (tid >> 3)) * D + 4 * (tid & 7);
  const uint32_t xdst = 4 * ((tid >> 3) * kXRow + 4 * (tid & 7));
  const int q = tid & 31;
  const bool second = kDual && q >= kWideCols / 8;
  const float* wsrc = (second ? w2b : wb) + static_cast<size_t>(tid >> 5) * H + n0 + 4 * q -
                      (second ? kWideCols / 2 : 0);
  const uint32_t wdst = 4 * (kXFloats + (tid >> 5) * kWideCols + 4 * q);
  const bool whole = vec_x && vec_w && n0 + kOut <= H;
  auto load = [&](int kt) {
    float* st = smem + (kt - kb) % kF32Stages * kStage;
    const int k0 = kt * kF32Step;
    if (whole && k0 + kF32Step <= D) {
      const uint32_t base = smem_addr(st);
#pragma unroll
      for (int j = 0; j < kXPieces; ++j)
        if (tid + j * kThreads < live * 8)
          cp_async16(base + xdst + 4 * j * (kRows / 2) * kXRow,
                     xsrc + static_cast<size_t>(j * (kRows / 2)) * D + k0, 16);
#pragma unroll
      for (int j = 0; j < kWPieces; ++j)
        cp_async16(base + wdst + 4 * j * (kThreads / 32) * kWideCols,
                   wsrc + static_cast<size_t>(k0 + j * (kThreads / 32)) * H, 16);
      return;
    }
    load_x(st, xb, r0, live, k0, D, vec_x, tid, kThreads);
    float* sw = st + kXFloats;
    for (int i = tid; i < kF32Step * kWideCols / 4; i += kThreads) {
      const int k = i / (kWideCols / 4), q = i % (kWideCols / 4), kk = k0 + k;
      const float* src = wb;
      int c = n0 + 4 * q;
      if constexpr (kDual)
        if (q >= kWideCols / 8) {
          src = w2b;
          c -= kWideCols / 2;
        }
      copy4(sw + k * kWideCols + 4 * q, src + static_cast<size_t>(kk) * H + c,
            kk < D ? H - c : 0, vec_w);
    }
  };

  float acc[kTR][8];
#pragma unroll
  for (int i = 0; i < kTR; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
#pragma unroll
  for (int s = 0; s < kF32Stages - 1; ++s) {
    if (kb + s < ke) load(kb + s);
    cp_async_commit();
  }
  for (int kt = kb; kt < ke; ++kt) {
    cp_async_wait<kF32Stages - 2>();   // this thread's copies of step kt landed
    __syncthreads();                   // everyone's, and step kt-1's products are done
    if (kt + kF32Stages - 1 < ke) load(kt + kF32Stages - 1);
    cp_async_commit();
    if (!mine) continue;
    const float* st = smem + (kt - kb) % kF32Stages * kStage;
    const float* xs = st + (slice * 32 + rg) * kXRow;
    const float* sw = st + kXFloats;
    // 4 k at a time; a step that ends past D skips its zero pieces, in an
    // instance of its own: a break or a bound read at run time inside the
    // full steps' loop costs the H100 its overlap of one piece's loads with
    // the last one's products
    auto multiply = [&](auto whole_step) {
      const int pieces = (min(kF32Step, D - kt * kF32Step) + 3) / 4;
#pragma unroll
      for (int kk = 0; kk < kF32Step / 4; ++kk) {
        if constexpr (!decltype(whole_step)::value)
          if (kk >= pieces) break;
        float4 a[kTR];   // 4 k of each of the lane's rows
#pragma unroll
        for (int i = 0; i < kTR; ++i)
          a[i] = *reinterpret_cast<const float4*>(xs + i * kLR * kXRow + 4 * kk);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float* wr = sw + (4 * kk + q) * kWideCols;
          const float4 b0 = *reinterpret_cast<const float4*>(wr + c0);
          const float4 b1 = *reinterpret_cast<const float4*>(wr + c1);
#pragma unroll
          for (int i = 0; i < kTR; ++i) {
            const float v = lane_of(a[i], q);
            acc[i][0] = fmaf(v, b0.x, acc[i][0]);
            acc[i][1] = fmaf(v, b0.y, acc[i][1]);
            acc[i][2] = fmaf(v, b0.z, acc[i][2]);
            acc[i][3] = fmaf(v, b0.w, acc[i][3]);
            acc[i][4] = fmaf(v, b1.x, acc[i][4]);
            acc[i][5] = fmaf(v, b1.y, acc[i][5]);
            acc[i][6] = fmaf(v, b1.z, acc[i][6]);
            acc[i][7] = fmaf(v, b1.w, acc[i][7]);
          }
        }
      }
    };
    if ((kt + 1) * kF32Step <= D) multiply(std::true_type{});
    else multiply(std::false_type{});
  }
  cp_async_wait<0>();

  const bool vec_y = (H & 3) == 0;
  const size_t plane = static_cast<size_t>(E) * C * H;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int r = r0 + slice * 32 + rg + kLR * i;
    if (r >= C) continue;
    const bool keep = r < rows;
    const float4 lo = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    const float4 hi = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    if constexpr (kSplit) {
      if (!keep) continue;
      float* p = ws + static_cast<size_t>(split) * (kDual ? 2 : 1) * plane +
                 (static_cast<size_t>(e) * C + r) * H;
      store4(p, n0 + c0, H, lo, vec_y);
      if constexpr (kDual) store4(p + plane, n0 + c0, H, hi, vec_y);
      else store4(p, n0 + c1, H, hi, vec_y);
    } else {
      float* p = yb + static_cast<size_t>(r) * H;
      if constexpr (kDual) {
        const float4 v = make_float4(fff::silu(lo.x) * hi.x, fff::silu(lo.y) * hi.y,
                                     fff::silu(lo.z) * hi.z, fff::silu(lo.w) * hi.w);
        store4(p, n0 + c0, H, keep ? v : zero, vec_y);
      } else {
        auto act4 = [&](const float4& v) {
          return keep ? make_float4(fff::activate_as<kAct>(v.x), fff::activate_as<kAct>(v.y),
                                    fff::activate_as<kAct>(v.z), fff::activate_as<kAct>(v.w))
                      : zero;
        };
        store4(p, n0 + c0, H, act4(lo), vec_y);
        store4(p, n0 + c1, H, act4(hi), vec_y);
      }
    }
  }
}

// Narrow form.  One block per (leaf, R-row tile[, range of D]), blockIdx.x =
// (split * E + leaf) * row tiles + row tile, of G x R / kRT threads (G = N /
// kCT column groups): thread t computes rows t / G + (R / kRT) i (i < kRT)
// of the tile and columns [g kCT, (g + 1) kCT) for g = t % G.  Stores and
// splits as the wide form.
template <int kCT, int kRT, bool kDual, bool kSplit, int kAct>
__global__ void __launch_bounds__(kF32Threads)
f32_narrow_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ w2, const int* __restrict__ gs, float* __restrict__ y,
                  float* __restrict__ ws, int E, int C, int D, int H, int splits, int R,
                  int vec_x) {
  constexpr int kOps = kDual ? 2 : 1;
  const int G = H / kCT, RL = R / kRT, rtiles = (C + R - 1) / R;
  const int rt = blockIdx.x % rtiles, z = blockIdx.x / rtiles, e = z % E, split = z / E;
  const int r0 = rt * R, rows = min(gs[e], C);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  float* yb = y + static_cast<size_t>(e) * C * H;
  if (r0 >= rows) {  // no live row: zeros (or, split, nothing), no weight traffic
    if constexpr (!kSplit)
      for (int i = tid; i < min(R, C - r0) * H; i += nthreads)
        yb[static_cast<size_t>(r0) * H + i] = 0.0f;
    return;
  }
  const int live = min(rows - r0, R);
  const int g = tid % G, rl = tid / G;
  const bool any = rl < live;   // this thread's first row is live
  const int nk = (D + kF32Step - 1) / kF32Step;
  const int kb = split * nk / splits, ke = (split + 1) * nk / splits;
  const int xfloats = R * kXRow, panel = kF32Step * H;   // a stage: x's rows, then the
  const int stage = xfloats + kOps * panel;              // panel's 32 rows an operand
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  const float* xb = x + static_cast<size_t>(e) * C * D;
  const float* wb[2] = {w + static_cast<size_t>(e) * D * H,
                        kDual ? w2 + static_cast<size_t>(e) * D * H : nullptr};

  auto load = [&](int kt) {
    float* st = smem + (kt - kb) % kF32Stages * stage;
    const int k0 = kt * kF32Step;
    load_x(st, xb, r0, live, k0, D, vec_x, tid, nthreads);
#pragma unroll
    for (int op = 0; op < kOps; ++op)   // the panel's 32 rows are contiguous in w
      load_flat(st + xfloats + op * panel, wb[op] + static_cast<size_t>(k0) * H,
                min(kF32Step, D - k0) * H, panel, tid, nthreads);
  };

  float acc[kOps][kRT][kCT];
#pragma unroll
  for (int op = 0; op < kOps; ++op)
#pragma unroll
    for (int i = 0; i < kRT; ++i)
#pragma unroll
      for (int j = 0; j < kCT; ++j) acc[op][i][j] = 0.0f;
#pragma unroll
  for (int s = 0; s < kF32Stages - 1; ++s) {
    if (kb + s < ke) load(kb + s);
    cp_async_commit();
  }
  for (int kt = kb; kt < ke; ++kt) {
    cp_async_wait<kF32Stages - 2>();
    __syncthreads();
    if (kt + kF32Stages - 1 < ke) load(kt + kF32Stages - 1);
    cp_async_commit();
    if (!any) continue;
    const float* st = smem + (kt - kb) % kF32Stages * stage;
    const float* xs = st + rl * kXRow;
    const float* wp = st + xfloats + g * kCT;
    auto multiply = [&](auto whole_step) {   // as the wide form's
      const int pieces = (min(kF32Step, D - kt * kF32Step) + 3) / 4;
#pragma unroll
      for (int kk = 0; kk < kF32Step / 4; ++kk) {
        if constexpr (!decltype(whole_step)::value)
          if (kk >= pieces) break;
        float4 a[kRT];   // 4 k of each of the thread's rows (a dead row's are never stored)
#pragma unroll
        for (int i = 0; i < kRT; ++i)
          a[i] = *reinterpret_cast<const float4*>(xs + i * RL * kXRow + 4 * kk);
#pragma unroll
        for (int op = 0; op < kOps; ++op) {
          const float* wr = wp + op * panel + 4 * kk * H;
          float b[4][kCT];   // the panel at 4 k by the thread's kCT columns
          if constexpr (kCT % 4 == 0) {
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
              for (int j = 0; j < kCT; j += 4) {
                const float4 t = *reinterpret_cast<const float4*>(wr + q * H + j);
                b[q][j] = t.x, b[q][j + 1] = t.y, b[q][j + 2] = t.z, b[q][j + 3] = t.w;
              }
          } else if (G == 1) {   // N = kCT: the 4 k's rows are 4 kCT adjacent floats
#pragma unroll
            for (int j = 0; j < kCT; ++j) {
              const float4 t = *reinterpret_cast<const float4*>(wr + 4 * j);
              const float f[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
              for (int u = 0; u < 4; ++u) b[(4 * j + u) / kCT][(4 * j + u) % kCT] = f[u];
            }
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
              for (int j = 0; j < kCT; ++j) b[q][j] = wr[q * H + j];
          }
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int i = 0; i < kRT; ++i) {
              const float v = lane_of(a[i], q);
#pragma unroll
              for (int j = 0; j < kCT; ++j) acc[op][i][j] = fmaf(v, b[q][j], acc[op][i][j]);
            }
        }
      }
    };
    if ((kt + 1) * kF32Step <= D) multiply(std::true_type{});
    else multiply(std::false_type{});
  }
  cp_async_wait<0>();

  const size_t plane = static_cast<size_t>(E) * C * H;
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    const int r = r0 + rl + RL * i;
    const bool keep = rl + RL * i < live;
    if (r >= C || (kSplit && !keep)) continue;
    float out[kCT];
#pragma unroll
    for (int j = 0; j < kCT; ++j)
      out[j] = !keep ? 0.0f
               : kDual ? fff::silu(acc[0][i][j]) * acc[kOps - 1][i][j]
                       : fff::activate_as<kAct>(acc[0][i][j]);
#pragma unroll
    for (int op = 0; op < (kSplit ? kOps : 1); ++op) {
      float* p = kSplit ? ws + (static_cast<size_t>(split) * kOps + op) * plane +
                              (static_cast<size_t>(e) * C + r) * H + g * kCT
                        : yb + static_cast<size_t>(r) * H + g * kCT;
      const float* v = kSplit ? acc[op][i] : out;
      if constexpr (kCT % 4 == 0) {
#pragma unroll
        for (int j = 0; j < kCT; j += 4)
          *reinterpret_cast<float4*>(p + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
      } else if constexpr (kCT == 2) {
        *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
      } else {
        p[0] = v[0];
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

// one float32 kernel instance on a plan's grid, its dynamic shared memory
// allowed once a device
template <auto kKernel, typename... A>
cudaError_t run_f32(int grid, int threads, int smem, int device, cudaStream_t s, A... args) {
  static int allowed[kMaxDevices] = {};
  if (const cudaError_t err =
          allow_smem(allowed, reinterpret_cast<const void*>(kKernel), smem, device))
    return err;
  kKernel<<<grid, threads, smem, s>>>(args...);
  return cudaGetLastError();
}

// The float32 plan (kernel.py::plan): the narrow form where H <= kNarrowMax
// (rows = R, a power of two; cols = the columns a thread, 8, 4, 2 or 1
// dividing H; a thread takes 4 rows where its columns are not all of H,
// else 1; G R / (rows a thread) <= 256 threads), else the wide form (rows
// 128 or 64, cols 128, or 64 for the dual form); grid = leaves x row tiles
// x column tiles x splits.  Anything else is refused.
template <bool kDual>
cudaError_t launch_f32(const float* x, const float* w, const float* w2, const int* gs, float* y,
                       float* ws, int E, int C, int D, int H, int act, int rows, int cols,
                       int splits, int grid, int device, cudaStream_t s) {
  constexpr int kOps = kDual ? 2 : 1;
  if (splits > (D + kF32Step - 1) / kF32Step) return cudaErrorInvalidValue;
  if (!aligned16(y) || (ws != nullptr && !aligned16(ws))) return cudaErrorInvalidValue;
  const int vec_x = D % 4 == 0 && aligned16(x);
  cudaError_t err = cudaErrorInvalidValue;
  if (H <= kNarrowMax) {
    const int ct = cols, G = H / ct, rt = ct == H ? 1 : 4;
    if ((ct != 8 && ct != 4 && ct != 2 && ct != 1) || H % ct != 0 || rows < rt ||
        (rows & (rows - 1)) != 0 || G * rows / rt > kF32Threads)
      return cudaErrorInvalidValue;
    if (static_cast<long long>(E) * ((C + rows - 1) / rows) * splits != grid)
      return cudaErrorInvalidValue;
    const int smem = kF32Stages * (rows * kXRow + kOps * kF32Step * H) * 4;
    auto run = [&](auto kct, auto krt, auto split, auto k) {
      constexpr int kRT = decltype(krt)::value;
      err = run_f32<f32_narrow_kernel<decltype(kct)::value, kRT, kDual, decltype(split)::value,
                                      decltype(k)::value>>(
          grid, G * rows / kRT, smem, device, s, x, w, w2, gs, y, ws, E, C, D, H, splits, rows,
          vec_x);
    };
    // the column groups' rows a thread: 1 where one group covers N, else 4
    auto by_act = [&](auto kct) {
      auto with_rt = [&](auto krt) {
        if (splits > 1)
          run(kct, krt, std::true_type{}, std::integral_constant<int, fff::kActNone>{});
        else
          with_act<kDual>(act, [&](auto k) { run(kct, krt, std::false_type{}, k); });
      };
      if (rt == 1) with_rt(std::integral_constant<int, 1>{});
      else with_rt(std::integral_constant<int, 4>{});
    };
    switch (ct) {
      case 8: by_act(std::integral_constant<int, 8>{}); break;
      case 4: by_act(std::integral_constant<int, 4>{}); break;
      case 2: by_act(std::integral_constant<int, 2>{}); break;
      default: by_act(std::integral_constant<int, 1>{});
    }
  } else {
    const int out = kDual ? kWideCols / 2 : kWideCols;
    if ((rows != 64 && rows != 128) || cols != out) return cudaErrorInvalidValue;
    if (static_cast<long long>(E) * ((C + rows - 1) / rows) * ((H + out - 1) / out) * splits !=
        grid)
      return cudaErrorInvalidValue;
    const int vec_w = H % 4 == 0 && aligned16(w) && (!kDual || aligned16(w2));
    auto run = [&](auto krows, auto split, auto k) {
      constexpr int kRows = decltype(krows)::value;
      constexpr int smem = kF32Stages * (kRows * kXRow + kF32Step * kWideCols) * 4;
      err = run_f32<f32_wide_kernel<kRows, kDual, decltype(split)::value, decltype(k)::value>>(
          grid, kRows * 4, smem, device, s, x, w, w2, gs, y, ws, E, C, D, H, splits, vec_x,
          vec_w);
    };
    auto by_rows = [&](auto krows) {
      if (splits > 1)
        run(krows, std::true_type{}, std::integral_constant<int, fff::kActNone>{});
      else
        with_act<kDual>(act, [&](auto k) { run(krows, std::false_type{}, k); });
    };
    if (rows == 64) by_rows(std::integral_constant<int, 64>{});
    else by_rows(std::integral_constant<int, 128>{});
  }
  if (err != cudaSuccess) return err;
  return splits > 1 ? split_sum<float, kDual>(ws, gs, y, E, C, H, splits, act, s) : cudaSuccess;
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
    err = launch_f32<kDual>(static_cast<const float*>(x), static_cast<const float*>(w),
                            static_cast<const float*>(w2), gs, static_cast<float*>(y), part, E,
                            C, D, H, act, rows, cols, splits, grid, device, s);
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
