// FFF tree descent (FORWARD_I routing) for a token batch.
//
// Replaces repro/kernels/tree_router/kernel.py::tree_router (the Pallas TPU
// kernel, body _router_kernel): logits x . node_w^T + node_b for the
// N = 2^depth - 1 collapsed node hyperplanes, f32 accumulation, then the
// descent idx = 2 idx + (logit[2^m - 1 + idx] >= 0) -- ties go right.
//
// Bound on the H100: bytes.  A hard descent needs depth dot products a
// token against D elements of token read: at internlm2-20b width (D = 6144,
// bf16) 1024 tokens move 12.8 MB, 3.8 us at 3.35 TB/s, and the 32-token
// verify slab 0.58 MB, 0.17 us, where one launch costs more than the bytes;
// the paper ViT's site (16384 tokens, D = 128, float32) moves 8.4 MB, 2.5 us.
//
// Two forms; kernels/tree_router/kernel.py::plan picks one by shape alone
// and passes it here (path, lanes, vecs, warps, grid).
//
// The cluster form (every bf16 shape; float32 past the resident form's
// limits).  The TPU kernel does one MXU product for all node logits of a
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
//
// The resident form (float32, D <= 1024, the node matrix within one
// block's shared memory: at D = 128 every depth 1-8).  At the ViT's narrow,
// deep trees the cluster form leaves most of a cluster idle (D = 128 is
// four 128-byte chunks) and computes all N logits where a descent needs
// depth.  Here one persistent block an SM (4-16 warps, the fewest that
// spread B over the SMs; grid min(SMs, B / the block's tokens at once); no
// cluster, no tensor map) copies node_w and node_b into shared memory once
// (16-byte cp.async where node_w's rows are whole float4s on a 16-byte
// base, else element-wise, zero past D), and each token descends one node
// a level: `lanes` lanes a token, lane l holding float4 pieces l, l +
// lanes, .. of its x row (`vecs` of them, up to 8, loaded straight from
// HBM, the next token's row in flight while this one descends).  Up to
// D = 128 a batch that fills the SMs, down 4 or more levels, takes 4 lanes
// a token (a warp descends 8 tokens at once: fewer shuffles a token);
// anything else 8 (a shorter chain a level); wider rows 16 or 32.  Per
// level: the node row's pieces from shared memory (the 8 lanes a 16-byte
// load serves at once read 8 distinct bank groups: at 4 lanes a token the
// second token of the 8 takes its pieces in a flipped order), FMAs in
// a fixed order, a butterfly __shfl_xor_sync sum over the token's lanes
// (both partners of a step add the same two values, so every lane holds
// the same logit), + node_b, then idx = 2 idx + (logit >= 0).  No atomics:
// two calls give the same bits.  D off 4 or an x off 16 bytes takes
// element-wise loads into the same registers, zero past D.  What bounds it
// on the H100 is the SM's shared-memory and shuffle pipe: a token reads a
// whole node row (4 x 128 bytes at D = 128) a level, so its time grows
// with depth.  (Probes on the H100 at the ViT's 16384 tokens with 16 or 32
// lanes a token, 4 without the flipped order, 2 tokens a lane group, both
// children's rows read ahead, 32 warps a block, or the top levels' rows
// held in registers were slower, or no faster.)
#include <type_traits>

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

// ---------------------------------------------------------------------------
// the resident form
// ---------------------------------------------------------------------------

constexpr int kResMaxThreads = 512;   // 16 warps; the plan may launch fewer

// kLanes: lanes a token (4, 8, 16 or 32); kVecs: float4 pieces of x a lane
// (1, 2, 4 or 8); kAligned: x's rows are whole float4s on a 16-byte base.
// nw_aligned: the same of node_w.  blockDim.x: the plan's warps x 32.
template <int kLanes, int kVecs, bool kAligned>
__global__ void __launch_bounds__(kResMaxThreads, 1)
resident_kernel(const float* __restrict__ x, const float* __restrict__ nw,
                const float* __restrict__ nb, int* __restrict__ out, int B, int D,
                int depth, bool nw_aligned) {
  extern __shared__ float4 res_smem[];
  constexpr int kPer = 32 / kLanes;                 // tokens a warp descends at once
  const int N = (1 << depth) - 1;
  const int C4 = (D + 3) / 4;                       // float4 pieces of a row
  float4* rows = res_smem;                          // [N][C4], zero past D
  float* bias = reinterpret_cast<float*>(rows + N * C4);
  const int tid = threadIdx.x, lane = tid % 32, threads = blockDim.x;
  const int lg = lane % kLanes;                     // this lane's place in its token's group
  // A 16-byte load serves a warp 8 lanes at a time.  With 4 lanes a token
  // those 8 lanes are two tokens in two node rows, and rows 512 bytes apart
  // would meet in the same banks; so the odd group takes its pieces in the
  // order k ^ 1 (the other 64 bytes of each 128), and every 8 lanes read 8
  // distinct bank groups.  Pieces k and k ^ 1 are summed as one pair, so
  // the sum is the same either way.
  const int flip = kLanes == 4 && kVecs > 1 ? (lane / kLanes) & 1 : 0;
  const int warp0 = (blockIdx.x * threads + tid) / 32 * kPer;
  const int stride = gridDim.x * threads / 32 * kPer;   // tokens a pass of the grid

  // token t's pieces lg + kLanes (k ^ flip); zeros past D and for t >= B
  auto load_x = [&](int t, float4 (&v)[kVecs]) {
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const int c = lg + (k ^ flip) * kLanes;
      v[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (t < B && c < C4) {
        const float* p = x + static_cast<size_t>(t) * D + 4 * c;
        if constexpr (kAligned) {
          v[k] = __ldcs(reinterpret_cast<const float4*>(p));
        } else {
          const int n = min(4, D - 4 * c);
          v[k].x = p[0];
          if (n > 1) v[k].y = p[1];
          if (n > 2) v[k].z = p[2];
          if (n > 3) v[k].w = p[3];
        }
      }
    }
  };
  float4 xc[kVecs];
  load_x(warp0 + lane / kLanes, xc);   // in flight while the node matrix arrives

  if (nw_aligned) {   // node_w's layout is the shared one: copy it as it lies
    for (int i = tid; i < N * C4; i += threads)
      cp_async16(smem_addr(rows + i), nw + 4 * static_cast<size_t>(i), 16);
    cp_async_commit();
  } else {
    float* r = reinterpret_cast<float*>(rows);
    for (int i = tid; i < N * C4 * 4; i += threads) {
      const int n = i / (4 * C4), col = i % (4 * C4);
      r[i] = col < D ? nw[static_cast<size_t>(n) * D + col] : 0.0f;
    }
  }
  for (int n = tid; n < N; n += threads) bias[n] = nb[n];
  if (nw_aligned) cp_async_wait<0>();
  __syncthreads();

  for (int base = warp0; base < B; base += stride) {   // warp-uniform
    const int t = base + lane / kLanes;
    float4 xn[kVecs];
    load_x(t + stride, xn);   // the next pass's row, in flight during this descent
    int idx = 0;
    const float4* level = rows;   // level m's first node row
    for (int m = 0; m < depth; ++m) {
      const float4* w = level + idx * C4;
      float part[kVecs];
#pragma unroll
      for (int k = 0; k < kVecs; ++k) {
        const int c = lg + (k ^ flip) * kLanes;
        part[k] = 0.0f;
        if (c < C4) {
          const float4 v = w[c];
          part[k] = fmaf(xc[k].w, v.w, fmaf(xc[k].z, v.z, fmaf(xc[k].y, v.y, xc[k].x * v.x)));
        }
      }
#pragma unroll
      for (int h = 1; h < kVecs; h *= 2)   // pairwise, in a fixed order
#pragma unroll
        for (int k = 0; k < kVecs; k += 2 * h) part[k] += part[k + h];
      float s = part[0];
#pragma unroll
      for (int o = kLanes / 2; o > 0; o /= 2) s += __shfl_xor_sync(0xffffffffu, s, o);
      idx = 2 * idx + (s + bias[(1 << m) - 1 + idx] >= 0.0f ? 1 : 0);
      level += (1 << m) * C4;
    }
    if (lg == 0 && t < B) out[t] = idx;
#pragma unroll
    for (int k = 0; k < kVecs; ++k) xc[k] = xn[k];
  }
}

template <int kLanes, int kVecs, bool kAligned>
cudaError_t launch_resident(const float* x, const float* nw, const float* nb, int* out, int B,
                            int D, int depth, int warps, int grid, int device,
                            cudaStream_t s) {
  const int N = (1 << depth) - 1;
  const int smem = N * ((D + 3) / 4) * 16 + N * 4;   // node rows, node_b
  auto kernel = resident_kernel<kLanes, kVecs, kAligned>;
  static int allowed[kMaxDevices] = {};   // dynamic shared memory allowed so far
  if (device >= kMaxDevices || allowed[device] < smem) {
    if (const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
      return err;
    if (device < kMaxDevices) allowed[device] = smem;
  }
  const bool nw_aligned = D % 4 == 0 && (reinterpret_cast<uintptr_t>(nw) & 15) == 0;
  kernel<<<grid, warps * 32, smem, s>>>(x, nw, nb, out, B, D, depth, nw_aligned);
  return cudaGetLastError();
}

template <int kLanes, int kVecs>
cudaError_t resident_as(const float* x, const float* nw, const float* nb, int* out, int B,
                        int D, int depth, int warps, int grid, int device, cudaStream_t s) {
  const bool aligned = D % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  return aligned ? launch_resident<kLanes, kVecs, true>(x, nw, nb, out, B, D, depth, warps,
                                                        grid, device, s)
                 : launch_resident<kLanes, kVecs, false>(x, nw, nb, out, B, D, depth, warps,
                                                         grid, device, s);
}

template <int V>
using Int = std::integral_constant<int, V>;

// the plan's (lanes, vecs): 4 lanes of 1-8 pieces, 8 of 1-4, 16 of 4, 32 of 4 or 8
cudaError_t resident(const float* x, const float* nw, const float* nb, int* out, int B, int D,
                     int depth, int lanes, int vecs, int warps, int grid, int device,
                     cudaStream_t s) {
  if (warps < 1 || warps * 32 > kResMaxThreads || grid < 1 || 4 * lanes * vecs < D)
    return cudaErrorInvalidValue;
  const auto as = [&](auto lanes_c, auto vecs_c) {
    return resident_as<decltype(lanes_c)::value, decltype(vecs_c)::value>(
        x, nw, nb, out, B, D, depth, warps, grid, device, s);
  };
  switch (lanes * 16 + vecs) {
    case 4 * 16 + 1: return as(Int<4>{}, Int<1>{});
    case 4 * 16 + 2: return as(Int<4>{}, Int<2>{});
    case 4 * 16 + 4: return as(Int<4>{}, Int<4>{});
    case 4 * 16 + 8: return as(Int<4>{}, Int<8>{});
    case 8 * 16 + 1: return as(Int<8>{}, Int<1>{});
    case 8 * 16 + 2: return as(Int<8>{}, Int<2>{});
    case 8 * 16 + 4: return as(Int<8>{}, Int<4>{});
    case 16 * 16 + 4: return as(Int<16>{}, Int<4>{});
    case 32 * 16 + 4: return as(Int<32>{}, Int<4>{});
    case 32 * 16 + 8: return as(Int<32>{}, Int<8>{});
    default: return cudaErrorInvalidValue;
  }
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

// path codes (kernels/tree_router/kernel.py PATH_CODES)
constexpr int kPathCluster = 0;
constexpr int kPathResident = 1;

// x (B, D), nw (N, D), nb (N,) of one dtype, N = 2^depth - 1 with
// 1 <= depth <= 8; out (B,) int32.  `path` is the plan's form; the resident
// form (float32 only) takes the plan's lanes a token, float4 pieces a lane,
// warps a block and grid, which the cluster form ignores.  Returns the first
// CUDA error (a refused cluster launch, tensor map or shared-memory size
// included), else cudaGetLastError() after the launch.
extern "C" int tree_router(const void* x, const void* nw, const void* nb,
                           int* out, int B, int D, int depth, int dtype, int path,
                           int lanes, int vecs, int warps, int grid, int device,
                           void* stream) {
  if (const cudaError_t err = cudaSetDevice(device)) return static_cast<int>(err);
  if (B < 1 || D < 1 || depth < 1 || depth > 8) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (path == kPathResident) {
    if (dtype != fff::kF32) return cudaErrorInvalidValue;
    return static_cast<int>(resident(static_cast<const float*>(x), static_cast<const float*>(nw),
                                     static_cast<const float*>(nb), out, B, D, depth, lanes,
                                     vecs, warps, grid, device, s));
  }
  if (path != kPathCluster) return cudaErrorInvalidValue;
  if (dtype == fff::kF32)
    return static_cast<int>(dispatch<float>(x, nw, nb, out, B, D, depth, device, s));
  if (dtype == fff::kBF16)
    return static_cast<int>(dispatch<__nv_bfloat16>(x, nw, nb, out, B, D, depth, device, s));
  return cudaErrorInvalidValue;
}
