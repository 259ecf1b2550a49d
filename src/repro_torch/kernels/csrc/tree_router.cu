// FFF tree descent (FORWARD_I routing) for a token batch.
//
// Replaces repro/kernels/tree_router/kernel.py::tree_router (the Pallas TPU
// kernel, body _router_kernel): logits x . node_w^T + node_b for all
// N = 2^depth - 1 collapsed node hyperplanes, f32 accumulation, then the
// descent idx = 2 idx + (logit[2^m - 1 + idx] >= 0) -- ties go right.
//
// Bound on the H100: bytes.  The work is 2 N D operations per token
// against 2 D bytes of token (bf16), ~15 operations per byte at depth 4,
// far below the ~295 where the tensor cores would be the limit: at
// internlm2-20b width (D = 6144, N = 15) 1024 tokens move 12.8 MB, 3.8 us
// at 3.35 TB/s, and the 32-token verify slab 0.58 MB, 0.17 us, where one
// launch costs more than the bytes.
//
// Design.  The TPU kernel does one MXU product for all node logits of a
// 256-token tile with the node matrix in VMEM.  Here a 64-token tile is one
// thread-block cluster, and each of its blocks takes every kCluster-th
// 128-byte column chunk of D: a tile's bytes spread over kCluster SMs, and
// each block reads its share of x once.  The cluster has 16 blocks while
// the grid has at most 8 tiles (512 tokens; the 32-token verify slab and
// the 256-token admission slab spread over 16 SMs), else 8 (1024 tokens:
// 16 clusters, 128 blocks on the 132 SMs).  Per chunk one thread asks the
// copy engine (TMA, 2-D tensor maps encoded on the host per call) for the
// 64 x 128-byte box of x and the N x 128-byte box of node rows (N padded to
// the 8-node mma tile), both in the 128-byte swizzle, completing on the
// ring stage's mbarrier; out-of-range rows and columns arrive as zeros.  So
// the node slice is read once per block and shared by every token of the
// tile, and no thread spends instructions on copies.  (On the H100, 16-byte
// cp.async copies by every thread streamed each SM's share well below its
// rate, and one bulk copy per 128-byte row, without a tensor map, slower
// still.)
//   bf16: tensor cores, mma.sync m16n8k16 (bf16 in, f32 accumulation); the
//   8 warps are 4 token groups of 16 x 2 node groups, each warp looping
//   over its 8-node tiles (node tiles 2j + group).
//   float32: CUDA cores in full float32 (no TF32): thread = (token, node
//   group q of 4), the group's nodes 8 i + q and 8 i + q + 4, whose two
//   swizzle patterns keep every node row's address an immediate offset;
//   float4 loads along D.
// Each block then pushes its partial logits into the shared memory of the
// block that finishes each token (block r finishes tokens r kOwn ..), one
// slot per source block (st.shared::cluster), and the cluster meets at one
// barrier.  A block sums its slots in rank order, so the result is the same
// bit for bit from run to run (no atomics), adds node_b and descends.  One
// launch per call: no workspace, no memset, no host sync.
// Sizes: depth <= 4 (N <= 15): one node tile per warp, 8 stages (80 KB
// ring); depth 5-7: up to 8 tiles per warp, 6 stages (up to 144 KB);
// depth 8 (N = 255): 16 tiles per warp, 4 stages (160 KB), beside 64 x N
// floats of pushed partials (64 KB at depth 8).  D off the 16-byte vector,
// or a base pointer off 16 bytes, which a tensor map cannot describe, takes
// element-wise copies by every thread into the same layout, zero past D.
#include "tma.cuh"

namespace {

constexpr int kThreads = 256;                 // 8 warps
constexpr int kTokens = 64;                   // token tile = one cluster
constexpr int kSmallGrid = 8;                 // up to this many tiles: 16-block clusters
constexpr int kMaxDevices = 16;

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// store v at shared address `addr` in the shared memory of cluster block `rank`
__device__ __forceinline__ void store_peer(uint32_t addr, uint32_t rank, float v) {
  uint32_t peer;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(peer) : "r"(addr), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(peer), "f"(v) : "memory");
}

// Element-wise copy of one column chunk into a ring stage, in the layout TMA
// writes: rows 0..rows_x-1 of the token tile, node rows 0..N-1 at stage rows
// kTokens + n; columns past D are zero.
template <typename T>
__device__ __forceinline__ void copy_chunk(unsigned char* stage, const T* x, const T* nw,
                                           int rows_x, int N, int D, int col0) {
  constexpr int kCols = kRowBytes / sizeof(T);
  for (int p = threadIdx.x; p < (rows_x + N) * kCols; p += kThreads) {
    const int r = p / kCols, cc = p % kCols, col = col0 + cc;
    const bool is_x = r < rows_x;
    const T* src = is_x ? x + static_cast<size_t>(r) * D : nw + static_cast<size_t>(r - rows_x) * D;
    const int row = is_x ? r : kTokens + r - rows_x;
    const int byte = cc * static_cast<int>(sizeof(T));
    *reinterpret_cast<T*>(stage + swz(row, byte / 16) + byte % 16) =
        col < D ? src[col] : fff::from_f32<T>(0.0f);
  }
}

// kCluster: blocks per token tile; kTiles: 8-node mma tiles per warp (bf16),
// or nodes per thread / 4 (f32); kTma: copies by tensor map, else element-wise.
template <typename T, int kCluster, int kTiles, int kStages, bool kTma>
__global__ void __launch_bounds__(kThreads)
tree_router_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap wmap, const T* __restrict__ x,
                   const T* __restrict__ nw, const T* __restrict__ nb,
                   int* __restrict__ out, int B, int D, int depth) {
  extern __shared__ unsigned char smem_raw[];
  constexpr bool kBF16 = sizeof(T) == 2;
  constexpr int kCols = kRowBytes / sizeof(T);   // columns per chunk
  constexpr int kOwn = kTokens / kCluster;       // tokens each block finishes
  const int N = (1 << depth) - 1;
  const int NP = (N + 7) & ~7;                   // node rows, padded to the mma tile
  const int stage_bytes = (kTokens + NP) * kRowBytes;
  // [ring: kStages stages][pushed partials: kCluster x N x kOwn][node_b][mbarriers]
  unsigned char* smem = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  float* recv = reinterpret_cast<float*>(smem + kStages * stage_bytes);
  float* bias = recv + kCluster * N * kOwn;
  const uint32_t bars = smem_addr(bias + NP);
  const int rank = static_cast<int>(cluster_rank());
  const int tile0 = blockIdx.x / kCluster * kTokens;
  const int rows_x = min(kTokens, B - tile0);
  // chunk i of this block is column chunk rank + i kCluster
  const int chunks = (D + kCols - 1) / kCols;
  const int nk = rank < chunks ? (chunks - rank + kCluster - 1) / kCluster : 0;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // bf16: warp = (16-token group mt, node group ng); f32: thread = (token t, node group q)
  const int mt = warp % 4, ng = warp / 4, g = lane / 4, c = lane % 4;
  const int t = tid % kTokens, q = tid / kTokens;
  // bf16: acc[j] is node tile 2 j + ng's mma fragment; f32: acc[j / 4][j % 4]
  // is node f32_node(j, q) (whose row mod 8 is q or q + 4: two swizzle patterns)
  auto f32_node = [](int j, int q) { return 8 * (j / 2) + 4 * (j % 2) + q; };
  float acc[kTiles][4];
#pragma unroll
  for (int j = 0; j < kTiles; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  const bool live = kBF16 ? mt * 16 < rows_x : t < rows_x;

  for (int n = tid; n < N; n += kThreads) bias[n] = fff::to_f32(nb[n]);
  if (kTma && tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load = [&](int i) {   // chunk i into stage i % kStages
    unsigned char* stage = smem + i % kStages * stage_bytes;
    const int col0 = (rank + i * kCluster) * kCols;
    if constexpr (kTma) {
      if (tid == 0) {
        const uint32_t bar = bars + 8 * (i % kStages);
        mbar_expect(bar, stage_bytes);
        tma_load(smem_addr(stage), xmap, col0, tile0, bar);
        tma_load(smem_addr(stage + kTokens * kRowBytes), wmap, col0, 0, bar);
      }
    } else {
      copy_chunk<T>(stage, x + static_cast<size_t>(tile0) * D, nw, rows_x, N, D, col0);
    }
  };
  for (int s = 0; s < kStages - 1 && s < nk; ++s) load(s);
  for (int i = 0; i < nk; ++i) {
    __syncthreads();   // chunk i - 1's stage is free; element copies of chunk i are in
    if (i + kStages - 1 < nk) load(i + kStages - 1);
    if constexpr (kTma) mbar_wait(bars + 8 * (i % kStages), (i / kStages) & 1);
    const unsigned char* xs = smem + i % kStages * stage_bytes;
    const unsigned char* ws = xs + kTokens * kRowBytes;
    if (!live) continue;
    if constexpr (kBF16) {
      const int r = mt * 16 + g;
#pragma unroll
      for (int k = 0; k < kRowBytes / 32; ++k) {   // k16 steps: pieces 2k and 2k + 1
        const uint32_t a[4] = {lds32(xs + swz(r, 2 * k) + 4 * c),
                               lds32(xs + swz(r + 8, 2 * k) + 4 * c),
                               lds32(xs + swz(r, 2 * k + 1) + 4 * c),
                               lds32(xs + swz(r + 8, 2 * k + 1) + 4 * c)};
#pragma unroll
        for (int j = 0; j < kTiles; ++j) {
          const int n = (2 * j + ng) * 8 + g;
          if (n < NP)
            mma_bf16(acc[j], a, lds32(ws + swz(n, 2 * k) + 4 * c),
                     lds32(ws + swz(n, 2 * k + 1) + 4 * c));
        }
      }
    } else {
#pragma unroll 2
      for (int k = 0; k < kRowBytes / 16; ++k) {   // float4 pieces
        const float4 xv = *reinterpret_cast<const float4*>(xs + swz(t, k));
        const unsigned char* w0 = ws + swz(q, k);       // nodes 8 i + q
        const unsigned char* w4 = ws + swz(q + 4, k);   // nodes 8 i + q + 4
#pragma unroll
        for (int j = 0; j < 4 * kTiles; ++j) {
          if (f32_node(j, q) < N) {
            const float4 wv = *reinterpret_cast<const float4*>(
                (j % 2 ? w4 : w0) + 8 * (j / 2) * kRowBytes);
            float& a = acc[j / 4][j % 4];
            a = fmaf(xv.x, wv.x, a);
            a = fmaf(xv.y, wv.y, a);
            a = fmaf(xv.z, wv.z, a);
            a = fmaf(xv.w, wv.w, a);
          }
        }
      }
    }
  }

  // push each partial logit to the block finishing its token: slot
  // recv[rank][n][token % kOwn] of block token / kOwn
  const uint32_t slots = smem_addr(recv) + rank * N * kOwn * 4;
  auto push = [&](int tok, int n, float v) {
    if (tok < rows_x && n < N) store_peer(slots + (n * kOwn + tok % kOwn) * 4, tok / kOwn, v);
  };
  if (live) {
    if constexpr (kBF16) {
#pragma unroll
      for (int j = 0; j < kTiles; ++j) {
        const int n = (2 * j + ng) * 8 + 2 * c, tok = mt * 16 + g;
        if (n < NP) {
          push(tok, n, acc[j][0]);
          push(tok, n + 1, acc[j][1]);
          push(tok + 8, n, acc[j][2]);
          push(tok + 8, n + 1, acc[j][3]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4 * kTiles; ++j) push(t, f32_node(j, q), acc[j / 4][j % 4]);
    }
  }
  cluster_sync();   // every partial is in place; no block reads a peer after this

  // this block finishes tokens own0 .. own0 + own - 1 of the tile
  float* logits = reinterpret_cast<float*>(smem);   // [kOwn][NP], over the idle ring
  const int own0 = rank * kOwn;
  const int own = max(0, min(kOwn, rows_x - own0));
  for (int i = tid; i < kOwn * N; i += kThreads) {
    const int tl = i % kOwn, n = i / kOwn;
    if (tl >= own) continue;
    float s = 0.0f;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) s += recv[(r * N + n) * kOwn + tl];   // rank order
    logits[tl * NP + n] = s + bias[n];
  }
  __syncthreads();
  if (tid < own) {
    const float* l = logits + tid * NP;
    int idx = 0, off = 0;
    for (int m = 0; m < depth; ++m) {
      idx = 2 * idx + (l[off + idx] >= 0.0f ? 1 : 0);
      off += 1 << m;
    }
    out[tile0 + own0 + tid] = idx;
  }
}

// a (rows, cols) row-major matrix, boxes of 128 bytes x box_rows, 128-byte swizzle
template <typename T>
cudaError_t tensor_map(CUtensorMap* map, const T* base, int rows, int cols, int box_rows) {
  const PFN_cuTensorMapEncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * sizeof(T)};
  const cuuint32_t box[2] = {kRowBytes / sizeof(T), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      2, const_cast<T*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, int kCluster, int kTiles, int kStages, bool kTma>
cudaError_t launch(const T* x, const T* nw, const T* nb, int* out, int B, int D,
                   int depth, int device, cudaStream_t s) {
  const int N = (1 << depth) - 1, NP = (N + 7) & ~7;
  const int smem = 1024 + kStages * (kTokens + NP) * kRowBytes   // alignment, ring
                   + (kTokens * N + NP) * 4 + kStages * 8;       // partials, node_b, mbarriers
  auto kernel = tree_router_kernel<T, kCluster, kTiles, kStages, kTma>;
  static int allowed[kMaxDevices] = {};   // dynamic shared memory allowed so far
  if (device >= kMaxDevices || allowed[device] < smem) {
    if (const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
      return err;
    if (kCluster > 8)
      if (const cudaError_t err = cudaFuncSetAttribute(
              kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1))
        return err;
    if (device < kMaxDevices) allowed[device] = smem;
  }
  CUtensorMap xmap = {}, wmap = {};
  if constexpr (kTma) {
    if (const cudaError_t err = tensor_map(&xmap, x, B, D, kTokens)) return err;
    if (const cudaError_t err = tensor_map(&wmap, nw, N, D, NP)) return err;
  }
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = kCluster;
  cluster.val.clusterDim.y = cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((B + kTokens - 1) / kTokens * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  if (const cudaError_t err =
          cudaLaunchKernelEx(&cfg, kernel, xmap, wmap, x, nw, nb, out, B, D, depth))
    return err;
  return cudaGetLastError();
}

template <typename T, int kCluster, bool kTma>
cudaError_t by_depth(const T* x, const T* nw, const T* nb, int* out, int B, int D, int depth,
                     int device, cudaStream_t s) {
  if (depth <= 4) return launch<T, kCluster, 1, 8, kTma>(x, nw, nb, out, B, D, depth, device, s);
  if (depth <= 7) return launch<T, kCluster, 8, 6, kTma>(x, nw, nb, out, B, D, depth, device, s);
  return launch<T, kCluster, 16, 4, kTma>(x, nw, nb, out, B, D, depth, device, s);
}

template <typename T>
cudaError_t dispatch(const void* xv, const void* nwv, const void* nbv, int* out, int B, int D,
                     int depth, int device, cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  const T* nw = static_cast<const T*>(nwv);
  const T* nb = static_cast<const T*>(nbv);
  // a tensor map needs 16-byte aligned bases and row strides
  const bool tma = D % fff::kVec<T> == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(nw)) & 15) == 0;
  const bool small = (B + kTokens - 1) / kTokens <= kSmallGrid;
  if (small)
    return tma ? by_depth<T, 16, true>(x, nw, nb, out, B, D, depth, device, s)
               : by_depth<T, 16, false>(x, nw, nb, out, B, D, depth, device, s);
  return tma ? by_depth<T, 8, true>(x, nw, nb, out, B, D, depth, device, s)
             : by_depth<T, 8, false>(x, nw, nb, out, B, D, depth, device, s);
}

}  // namespace

// x (B, D), nw (N, D), nb (N,) of one dtype, N = 2^depth - 1 with
// 1 <= depth <= 8; out (B,) int32.  Returns the first CUDA error (a refused
// cluster launch or tensor map included), else cudaGetLastError() after the
// launch.
extern "C" int tree_router(const void* x, const void* nw, const void* nb,
                           int* out, int B, int D, int depth, int dtype,
                           int device, void* stream) {
  if (const cudaError_t err = cudaSetDevice(device)) return static_cast<int>(err);
  if (B < 1 || D < 1 || depth < 1 || depth > 8) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == fff::kF32)
    return static_cast<int>(dispatch<float>(x, nw, nb, out, B, D, depth, device, s));
  if (dtype == fff::kBF16)
    return static_cast<int>(dispatch<__nv_bfloat16>(x, nw, nb, out, B, D, depth, device, s));
  return cudaErrorInvalidValue;
}
