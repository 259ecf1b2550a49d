// The whole FFF decode forward: for every token and tree the hard descent,
// only the routed leaf's MLP (plain or SwiGLU), the forest combine in f32,
// and the optional always-on master leaf.
//
// Replaces repro/kernels/fused_decode/kernel.py::fused_forest_decode (the
// Pallas TPU megakernel, body _fused_decode_kernel).
//
// Bound on the H100: bytes.  A decode token reads its routed leaf's weight
// slabs, 3 * 6144 * 1024 bf16 = 37.7 MB per SwiGLU leaf at internlm2-20b
// width, for 2 * 3 * 6144 * 1024 operations: one operation per byte.  The
// least traffic is each tree's distinct routed leaves, read once whatever
// number of tokens share them, plus the nodes on each token's path.
//
// Design.  The TPU kernel runs one grid step per token, each re-reading its
// routed leaf.  Here one call is up to five kernels on the caller's stream,
// launched from the one C entry point; the host reads nothing back between
// them, so a CUDA graph captures the call and replays it on new inputs:
//   1. route: one block per (token, tree) descends the tree, one node dot
//      product a level in f32 (ties go right), block sums in warp order;
//      each thread holds its share of x and of the node's row in registers
//      and loads both children's rows while the level reduces.  It writes
//      leaf_idx.
//   2. up: blocks over (column tile of l, range of D, tree x rank).  Block
//      (j, q, t x rmax + r) finds in leaf_idx tree t's r-th smallest routed
//      leaf and that leaf's tokens in token order (a rank at or past the
//      tree's distinct leaves exits at once; the master leaf takes the last
//      z with every token), then streams the leaf's column tile of the
//      (D, l) matrices over range q of D once for all of those tokens.  With
//      D whole (the plan's choice wherever the routed leaves' tiles fill the
//      card) it applies the activation (silu(g) * u for SwiGLU) and writes
//      h rounded to the element type, as the Pallas body does; else it
//      writes f32 partial sums to the workspace and
//   3. finish sums each (tree, token, hidden unit)'s ranges of D in order,
//      applies the activation and writes h.
//   4. down: the same kernel over (column tile of O, range of l, tree x
//      rank) streams each routed leaf's (l, O) slab once; with one tree, no
//      master leaf and l whole it writes y, else f32 partial sums, a slot
//      for each tree and the master, and
//   5. combine sums over (token, column chunk of O) each tree's ranges of l
//      in order, the trees in order and then the master, and rounds once.
// No atomics anywhere and every sum in a fixed order, so two calls on one
// input give bit-identical outputs.  Kernels 2-5 launch as programmatic
// dependents: each starts while the one before it drains and waits for it
// (griddepcontrol.wait) before reading its output; the down projection
// streams its first stages' weights, which need only the routing, before
// that wait.
// A stream block is one producer warp and four consumer warps.  Lane 0 of
// the producer issues TMA copies (cp.async.bulk.tensor, 128-byte swizzle)
// through a ring of shared-memory stages with a full and an empty mbarrier
// a stage: per step of 128 rows of k, the leaf's weight box (one 128-byte
// column tile; both matrices of the SwiGLU pair) with an L2 evict-first
// policy, and only the 8-token windows of the activations that hold the
// leaf's tokens, evict-last.
//   bf16: tensor cores, mma.sync m16n8k16 with the weights as A (ldmatrix
//   .trans of 16 columns x 16 rows of k) and 8 tokens as an N tile, over
//   the N tiles of the leaf's tokens; a kernel's accumulators are sized for
//   its chunk (8, 32 or 64 tokens): at a decode batch of 8 a thread keeps 8
//   of them and an SM holds many blocks.
//   float32: CUDA cores in full float32 (no TF32): thread = (column,
//   quarter of a stage's rows of k), the quarters' sums met by shuffles.
// Batches above a chunk (64 tokens in bf16, 32 in float32) run the phases
// chunk by chunk.  Shapes or bases a tensor map cannot describe (a row off
// 16 bytes) take the element-wise path: the producer warp copies elements
// into the same layout and every lane arrives on the stage.
// kernels/fused_decode/kernel.py::plan chooses the path, the chunk, the
// splits of D and of l, the stages and the workspace; this file checks and
// launches that plan.
#include <mutex>
#include <unordered_map>
#include <utility>

#include "tma.cuh"

namespace {

// the paths (kernels/fused_decode/kernel.py PATH_CODES)
constexpr int kPathElementwise = 0;
constexpr int kPathTma = 1;
constexpr int kConsumers = 4;                      // consumer warps a stream block
constexpr int kThreads = (kConsumers + 1) * 32;    // and one producer warp
constexpr int kRouteThreads = 512;
constexpr int kCombineThreads = 256;
constexpr int kMaxStages = 8;
constexpr int kWin = 8;                            // token rows of one activation window
constexpr int kWinBytes = kWin * kRowBytes;        // one 1024-byte swizzle atom
constexpr int kStageK = 2;                         // 128-byte rows of k a ring stage
constexpr int kMaxDevices = 16;

template <typename T>
struct Geo {
  static constexpr bool kBF16 = sizeof(T) == 2;
  static constexpr int kCols = kRowBytes / sizeof(T);   // columns of a weight tile
  static constexpr int kXK = kRowBytes / sizeof(T);      // elements of k an activation row holds
  static constexpr int kK = kStageK * kXK;               // rows of k a stage
  static constexpr int kBox = kK * kRowBytes;            // one weight box's bytes
  static constexpr int kMaxTok = kBF16 ? 64 : 32;        // tokens of a chunk
};

// ---------------------------------------------------------------------------
// device helpers
// ---------------------------------------------------------------------------

// L2 policies: the leaf weights stream through once (evict first), the
// activations are read again by every column tile (evict last)
__device__ __forceinline__ uint64_t l2_policy(bool first) {
  uint64_t p;
  if (first)
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  else
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}
// the box at (c0, c1, c2) of a 3-D tensor map, with an L2 cache policy
__device__ __forceinline__ void tma_load_hint(uint32_t dst, const CUtensorMap& map, int c0,
                                              int c1, int c2, uint32_t bar, uint64_t policy) {
  asm volatile("cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
               ".L2::cache_hint [%0], [%1, {%3, %4, %5}], [%2], %6;\n"
               ::"r"(dst), "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(c0), "r"(c1),
                 "r"(c2), "l"(policy)
               : "memory");
}
// programmatic dependent launch: a grid launched with the attribute runs
// its prologue while the grid before it finishes, waits for that grid (and
// its memory) here, and lets the grid after it launch once every one of its
// blocks has called launch_dependents (or exited)
__device__ __forceinline__ void grid_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }
__device__ __forceinline__ void grid_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}
// a 16 x 16 bf16 A fragment from four 8 x 8 matrices, transposed on the way
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(addr));
}

// ---------------------------------------------------------------------------
// 1. route: one block per (token, tree)
// ---------------------------------------------------------------------------

// V elements a load (16 bytes' worth; 1 on the element-wise path).  kPer >
// 0: each thread holds kPer loads of x and of the current node's row in
// registers and loads both children's rows while the level reduces; kPer =
// 0: a loop over D, the children's rows prefetched into L2.
template <typename T, int V, int kPer>
__global__ void __launch_bounds__(kRouteThreads)
route_kernel(const T* __restrict__ x, const T* __restrict__ nw, const T* __restrict__ nb,
             int* __restrict__ leaf_idx, int D, int trees, int depth) {
  grid_launch_dependents();   // the up projection's blocks wait for this grid's leaf_idx
  __shared__ float red[kRouteThreads / 32];
  __shared__ int s_bit;
  const int b = blockIdx.x, t = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int N = (1 << depth) - 1;
  const T* xr = x + static_cast<size_t>(b) * D;
  const T* nwt = nw + static_cast<size_t>(t) * N * D;
  // a level's logit: this thread's share of the dot product, then the
  // block's in warp order, plus the node's bias; the bit taken
  auto decide = [&](float acc, int node) {
    acc = fff::warp_sum(acc);
    if (lane == 0) red[warp] = acc;
    __syncthreads();
    if (tid == 0) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kRouteThreads / 32; ++w) s += red[w];
      s += fff::to_f32(nb[t * N + node]);
      s_bit = s >= 0.0f ? 1 : 0;
    }
    __syncthreads();
    return s_bit;
  };
  int idx = 0;
  if constexpr (kPer > 0) {
    float xv[kPer][V], cur[kPer][V], k0[kPer][V], k1[kPer][V];
    auto load_row = [&](const T* row, float (&dst)[kPer][V]) {
#pragma unroll
      for (int p = 0; p < kPer; ++p) {
        const int d = (p * kRouteThreads + tid) * V;
        if (d < D) {
          fff::load_vec<T, V>(row + d, dst[p]);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) dst[p][v] = 0.0f;
        }
      }
    };
    load_row(xr, xv);
    load_row(nwt, cur);
    for (int m = 0; m < depth; ++m) {
      const int node = (1 << m) - 1 + idx;
      if (m + 1 < depth) {   // both children, in flight while this level reduces
        load_row(nwt + static_cast<size_t>(2 * node + 1) * D, k0);
        load_row(nwt + static_cast<size_t>(2 * node + 2) * D, k1);
      }
      float acc = 0.0f;
#pragma unroll
      for (int p = 0; p < kPer; ++p)
#pragma unroll
        for (int v = 0; v < V; ++v) acc = fmaf(xv[p][v], cur[p][v], acc);
      const int bit = decide(acc, node);
#pragma unroll
      for (int p = 0; p < kPer; ++p)
#pragma unroll
        for (int v = 0; v < V; ++v) cur[p][v] = bit ? k1[p][v] : k0[p][v];
      idx = 2 * idx + bit;
    }
  } else {
    const int lines = (D * static_cast<int>(sizeof(T)) + 127) / 128;   // 128-byte lines a row
    const int row_bytes = D * static_cast<int>(sizeof(T));
    for (int m = 0; m < depth; ++m) {
      const int node = (1 << m) - 1 + idx;
      if (m + 1 < depth) {   // both children's rows toward L2 while this level reduces
        const char* kids = reinterpret_cast<const char*>(nwt + static_cast<size_t>(2 * node + 1) * D);
        for (int i = tid; i < 2 * lines; i += kRouteThreads)
          prefetch_l2(kids + static_cast<size_t>(i / lines) * row_bytes +
                      min((i % lines) * 128, row_bytes - 1));
      }
      const T* wr = nwt + static_cast<size_t>(node) * D;
      float acc = 0.0f, xv[V], wv[V];
      for (int d = tid * V; d < D; d += kRouteThreads * V) {
        fff::load_vec<T, V>(xr + d, xv);
        fff::load_vec<T, V>(wr + d, wv);
#pragma unroll
        for (int v = 0; v < V; ++v) acc = fmaf(xv[v], wv[v], acc);
      }
      idx = 2 * idx + decide(acc, node);
    }
  }
  if (tid == 0) leaf_idx[b * trees + t] = idx;
}


// ---------------------------------------------------------------------------
// 2, 3. the up and down projections: one stream kernel
// ---------------------------------------------------------------------------

template <typename T>
struct StreamArgs {
  const T* w[2];        // the leaves' matrices (trees, E, K, M), by operand
  const T* m[2];        // the master's (Km, Mm)
  const T* in;          // activations: x (Bc, D) [up], h (trees, Bc, l) [down]
  const T* in_m;        // the master's: x [up], hm (Bc, mw) [down]
  const int* leaf_idx;  // (Bc, trees) of this chunk
  float* part;          // partial sums: up (splits, trees, Bc, ops, l); down
                        // (splits, trees + master, Bc, O), the master at slot trees
  float* part_m;        // up: the master's (splits, Bc, ops, mw)
  T* out;               // one range of k: h (trees, Bc, l) [up]; y (Bc, O) [down, one
                        // slot], written directly; else null
  T* out_m;             // up, one range of k: hm (Bc, mw)
  int Bc, trees, E, K, M, Km, Mm;   // k extent and columns, leaves and master
  int act, rmax, master, stages, stage_bytes;
  int win_bytes;        // a stage's windows for one 128-byte row of k: ceil(Bc / 8) x 1024
};

// kOps matrices a leaf (2: the SwiGLU pair); kUp: x -> partial sums of g
// (and u), else h -> partial sums of the output; kTma: copies by tensor map,
// else element-wise; kTok: the most tokens a leaf of the chunk can hold (the
// accumulators a thread keeps).  Grid (column tile, range of k, tree x rank + master):
// a block streams one column tile of one routed leaf (or of the master
// leaf) over one range of k for all of the leaf's tokens; its partial sums
// stay in registers and go to the workspace (or y) at the end.
template <typename T, int kOps, bool kUp, bool kTma, int kTok>
__global__ void __launch_bounds__(kThreads)
stream_kernel(const __grid_constant__ CUtensorMap wmap0, const __grid_constant__ CUtensorMap wmap1,
              const __grid_constant__ CUtensorMap mmap0, const __grid_constant__ CUtensorMap mmap1,
              const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap xmmap,
              const StreamArgs<T> a) {
  using G = Geo<T>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages];
  __shared__ int toks[64];
  __shared__ int s_ntok, s_leaf;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bool master = blockIdx.z >= a.trees * a.rmax;
  const int t = master ? a.trees : blockIdx.z / a.rmax;   // the tree, or trees for the master
  const int K = master ? a.Km : a.K, M = master ? a.Mm : a.M;
  const int c0 = blockIdx.x * G::kCols, q = blockIdx.y, splits = gridDim.y;
  if (c0 >= M) return;   // a tile past the master's (or a leaf's) width
  if constexpr (kUp) grid_wait();   // leaf_idx is the route grid's

  // the block's leaf: tree t's r-th smallest routed leaf, and its tokens in
  // token order (a token is its leaf's first if no earlier token has that
  // leaf; a leaf's rank is the first occurrences of smaller leaves)
  if (warp == 0) {
    if (master) {
      for (int b = lane; b < a.Bc; b += 32) toks[b] = b;
      if (lane == 0) s_ntok = a.Bc, s_leaf = 0;
    } else {
      const int r = blockIdx.z % a.rmax;
      const bool in0 = lane < a.Bc, in1 = lane + 32 < a.Bc;
      const int v0 = in0 ? __ldcg(a.leaf_idx + lane * a.trees + t) : -1;
      const int v1 = in1 ? __ldcg(a.leaf_idx + (lane + 32) * a.trees + t) : -1;
      int same0 = 0, same1 = 0;
      for (int j = 0; j < a.Bc; ++j) {
        const int u = __shfl_sync(~0u, j < 32 ? v0 : v1, j & 31);
        same0 += u == v0 && j < lane;
        same1 += u == v1 && j < lane + 32;
      }
      const unsigned m0 = __ballot_sync(~0u, in0 && same0 == 0);
      const unsigned m1 = __ballot_sync(~0u, in1 && same1 == 0);
      int r0 = 0, r1 = 0;
      for (int j = 0; j < a.Bc; ++j) {
        const bool first = j < 32 ? (m0 >> j) & 1u : (m1 >> (j - 32)) & 1u;
        const int u = __shfl_sync(~0u, j < 32 ? v0 : v1, j & 31);
        r0 += first && u < v0;
        r1 += first && u < v1;
      }
      const unsigned h0 = __ballot_sync(~0u, in0 && same0 == 0 && r0 == r);
      const unsigned h1 = __ballot_sync(~0u, in1 && same1 == 0 && r1 == r);
      const int e = h0 ? __shfl_sync(~0u, v0, __ffs(h0) - 1)
                       : h1 ? __shfl_sync(~0u, v1, __ffs(h1) - 1) : -1;
      const bool on0 = e >= 0 && v0 == e, on1 = e >= 0 && v1 == e;
      const unsigned k0 = __ballot_sync(~0u, on0), k1 = __ballot_sync(~0u, on1);
      const unsigned below = (1u << lane) - 1u;
      if (on0) toks[__popc(k0 & below)] = lane;
      if (on1) toks[__popc(k0) + __popc(k1 & below)] = lane + 32;
      if (lane == 0) s_ntok = __popc(k0) + __popc(k1), s_leaf = e;
    }
  }
  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(smem_addr(&full[s]), kTma ? 1 : 32);
      mbar_init(smem_addr(&empty[s]), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the next grid may launch: the finish (which waits for this grid), or
  // the combine (likewise); the down projection's own reads of h wait below
  grid_launch_dependents();
  const int ntok = s_ntok, leaf = s_leaf;
  if (ntok == 0) return;   // a rank at or past the tree's distinct leaves
  const int nk = (K + G::kK - 1) / G::kK;
  const int kb = q * nk / splits, ke = (q + 1) * nk / splits;

  if (warp == kConsumers) {   // the producer
    unsigned win = 0;         // the activation windows holding the tokens
    for (int n = 0; n < ntok; ++n) win |= 1u << (toks[n] / kWin);
    const int xz = kUp || master ? 0 : t;                // the activations' tree
    const int wz = master ? 0 : t * a.E + leaf;          // the weights' (tree, leaf)
    if constexpr (kTma) {
      if (lane == 0) {
        const uint64_t stream = l2_policy(true), keep = l2_policy(false);
        const CUtensorMap& w0 = master ? mmap0 : wmap0;
        const CUtensorMap& w1 = master ? mmap1 : wmap1;
        const CUtensorMap& xm = master ? xmmap : xmap;
        const uint32_t bytes = kOps * G::kBox + __popc(win) * kStageK * kWinBytes;
        auto weights = [&](int i) {   // stage i's weight boxes, its byte count set
          const int s = i % a.stages;
          mbar_wait(smem_addr(&empty[s]), ((i / a.stages) & 1) ^ 1);
          const uint32_t bar = smem_addr(&full[s]);
          const uint32_t st = smem_addr(ring + s * a.stage_bytes);
          const int k0 = (kb + i) * G::kK;
          mbar_expect(bar, bytes);
          tma_load_hint(st, w0, c0, k0, wz, bar, stream);
          if constexpr (kOps == 2) tma_load_hint(st + G::kBox, w1, c0, k0, wz, bar, stream);
        };
        auto windows = [&](int i) {   // stage i's activation windows
          const int s = i % a.stages;
          const uint32_t bar = smem_addr(&full[s]);
          const uint32_t st = smem_addr(ring + s * a.stage_bytes);
          const int k0 = (kb + i) * G::kK;
          for (unsigned w = win; w; w &= w - 1) {
            const int wi = __ffs(w) - 1;
#pragma unroll
            for (int xb = 0; xb < kStageK; ++xb)
              tma_load_hint(st + kOps * G::kBox + xb * a.win_bytes + wi * kWinBytes, xm,
                            k0 + xb * G::kXK, wi * kWin, xz, bar, keep);
          }
        };
        // the down projection's weights need only the routing: its first
        // stages' weights stream while the grids before it finish h
        const int steps = ke - kb, early = kUp ? 0 : min(steps, a.stages);
        for (int i = 0; i < early; ++i) weights(i);
        if constexpr (!kUp) grid_wait();
        for (int i = 0; i < early; ++i) windows(i);
        for (int i = early; i < steps; ++i) {
          weights(i);
          windows(i);
        }
      }
    } else {
      if constexpr (!kUp) grid_wait();   // h is the finish grid's
      const T* xs = master ? a.in_m : a.in + static_cast<size_t>(xz) * a.Bc * K;
      for (int k = kb, i = 0; k < ke; ++k, ++i) {
        const int s = i % a.stages;
        mbar_wait(smem_addr(&empty[s]), ((i / a.stages) & 1) ^ 1);
        unsigned char* st = ring + s * a.stage_bytes;
        const int k0 = k * G::kK;
#pragma unroll
        for (int op = 0; op < kOps; ++op) {
          const T* w = master ? a.m[op] : a.w[op] + static_cast<size_t>(wz) * K * M;
          for (int p = lane; p < G::kK * G::kCols; p += 32) {
            const int r = p / G::kCols, cc = p % G::kCols, kr = k0 + r, col = c0 + cc;
            const int byte = cc * static_cast<int>(sizeof(T));
            *reinterpret_cast<T*>(st + op * G::kBox + swz(r, byte / 16) + byte % 16) =
                kr < K && col < M ? w[static_cast<size_t>(kr) * M + col] : fff::from_f32<T>(0.0f);
          }
        }
        for (unsigned w = win; w; w &= w - 1) {
          const int wi = __ffs(w) - 1;
          for (int p = lane; p < kWin * G::kK; p += 32) {
            const int b = wi * kWin + p / G::kK, kc = p % G::kK, kr = k0 + kc;
            const int byte = kc % G::kXK * static_cast<int>(sizeof(T));
            *reinterpret_cast<T*>(st + kOps * G::kBox + kc / G::kXK * a.win_bytes +
                                  swz(b, byte / 16) + byte % 16) =
                b < a.Bc && kr < K ? xs[static_cast<size_t>(b) * K + kr] : fff::from_f32<T>(0.0f);
          }
        }
        mbar_arrive(smem_addr(&full[s]));   // each lane, after its own copies
      }
    }
    return;
  }

  // column `col` of token `b`: its sums over this block's range of k (v[1]
  // the SwiGLU up operand's).  Where the range is all of k they are whole:
  // the up projection writes h = act(g) (silu(g) * u) and the down
  // projection y, each rounded to the element type; else they go to the
  // workspace as partial sums.
  auto store = [&](int b, int col, const float (&v)[kOps]) {
    if (col >= M) return;
    if constexpr (kUp) {
      if (a.out != nullptr) {
        const float h = kOps == 2 ? fff::silu(v[0]) * v[kOps - 1] : fff::activate(v[0], a.act);
        (master ? a.out_m + static_cast<size_t>(b) * M
                : a.out + (static_cast<size_t>(t) * a.Bc + b) * M)[col] = fff::from_f32<T>(h);
        return;
      }
#pragma unroll
      for (int op = 0; op < kOps; ++op) {
        if (master)
          a.part_m[((static_cast<size_t>(q) * a.Bc + b) * kOps + op) * M + col] = v[op];
        else
          a.part[(((static_cast<size_t>(q) * a.trees + t) * a.Bc + b) * kOps + op) * M + col] =
              v[op];
      }
    } else if (a.out != nullptr) {
      a.out[static_cast<size_t>(b) * M + col] = fff::from_f32<T>(v[0]);
    } else {
      a.part[((static_cast<size_t>(q) * (a.trees + a.master) + t) * a.Bc + b) * M + col] = v[0];
    }
  };
  if constexpr (G::kBF16) {
    // fragments: acc[nt] is token tile nt's; the warp owns columns 16 warp ..
    constexpr int kNT = kTok / 8;   // N tiles of 8 tokens
    float acc[kNT][4], acc2[kOps == 2 ? kNT : 1][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[n][j] = 0.0f;
        if constexpr (kOps == 2) acc2[n][j] = 0.0f;
      }
    const int g = lane / 4, c = lane % 4, ntiles = (ntok + 7) / 8;
    int trow[kNT];   // the token row lane g of each N tile reads (the last token past ntok)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) trow[nt] = toks[min(nt * 8 + g, ntok - 1)];
    // matrix lane / 8 of the A fragment: rows of k +8 for matrices 2, 3,
    // columns +8 (the next 16-byte piece) for matrices 1, 3
    const int mi = lane / 8, piece = 2 * warp + (mi & 1);
    for (int k = kb, i = 0; k < ke; ++k, ++i) {
      const int s = i % a.stages;
      mbar_wait(smem_addr(&full[s]), (i / a.stages) & 1);
      const uint32_t sa = smem_addr(ring + s * a.stage_bytes);
      const unsigned char* xs = ring + s * a.stage_bytes + kOps * G::kBox;
#pragma unroll
      for (int kk = 0; kk < G::kK / 16; ++kk) {
        const int row = kk * 16 + (mi >> 1) * 8 + lane % 8;
        uint32_t a0[4], a1[4];
        ldsm_x4_trans(a0, sa + swz(row, piece));
        if constexpr (kOps == 2) ldsm_x4_trans(a1, sa + G::kBox + swz(row, piece));
        const unsigned char* xr = xs + kk / 4 * a.win_bytes + 4 * c;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          if (nt < ntiles) {
            const uint32_t b0 = lds32(xr + swz(trow[nt], 2 * (kk % 4)));
            const uint32_t b1 = lds32(xr + swz(trow[nt], 2 * (kk % 4) + 1));
            mma_bf16(acc[nt], a0, b0, b1);
            if constexpr (kOps == 2) mma_bf16(acc2[nt], a1, b0, b1);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_addr(&empty[s]));
    }
    // fragment element e: column g (+8 for e >= 2) of the warp's 16, token 2c (+1 for odd e)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = nt * 8 + 2 * c + (e & 1), col = c0 + 16 * warp + g + 8 * (e >> 1);
        if (nt < ntiles && n < ntok) {
          float v[kOps];
          v[0] = acc[nt][e];
          if constexpr (kOps == 2) v[1] = acc2[nt][e];
          store(toks[n], col, v);
        }
      }
  } else {
    // thread = (column 8 warp + lane % 8, quarter lane / 8 of a stage's
    // rows of k); the quarters' sums meet by shuffles in a fixed order
    float acc[kTok], acc2[kOps == 2 ? kTok : 1];
#pragma unroll
    for (int n = 0; n < kTok; ++n) {
      acc[n] = 0.0f;
      if constexpr (kOps == 2) acc2[n] = 0.0f;
    }
    const int cl = 8 * warp + lane % 8, kq = lane / 8;
    constexpr int kRowsQ = G::kK / 4;   // rows of k a quarter
    for (int k = kb, i = 0; k < ke; ++k, ++i) {
      const int s = i % a.stages;
      mbar_wait(smem_addr(&full[s]), (i / a.stages) & 1);
      const unsigned char* st = ring + s * a.stage_bytes;
      const unsigned char* xs = st + kOps * G::kBox;
#pragma unroll
      for (int m = 0; m < kRowsQ / 4; ++m) {
        const int r0 = kq * kRowsQ + 4 * m;   // rows r0 .. r0 + 3: one float4 of x
        float wv[4], wv2[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int o = swz(r0 + r, cl / 4) + 4 * (cl % 4);
          wv[r] = *reinterpret_cast<const float*>(st + o);
          if constexpr (kOps == 2) wv2[r] = *reinterpret_cast<const float*>(st + G::kBox + o);
        }
        const unsigned char* xr = xs + r0 / G::kXK * a.win_bytes;
        const int piece = r0 % G::kXK / 4;
#pragma unroll
        for (int n = 0; n < kTok; ++n) {
          if (n < ntok) {
            const float4 xv = *reinterpret_cast<const float4*>(xr + swz(toks[n], piece));
            float& s0 = acc[n];
            s0 = fmaf(xv.x, wv[0], s0);
            s0 = fmaf(xv.y, wv[1], s0);
            s0 = fmaf(xv.z, wv[2], s0);
            s0 = fmaf(xv.w, wv[3], s0);
            if constexpr (kOps == 2) {
              float& s1 = acc2[n];
              s1 = fmaf(xv.x, wv2[0], s1);
              s1 = fmaf(xv.y, wv2[1], s1);
              s1 = fmaf(xv.z, wv2[2], s1);
              s1 = fmaf(xv.w, wv2[3], s1);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_addr(&empty[s]));
    }
#pragma unroll
    for (int n = 0; n < kTok; ++n) {
      if (n < ntok) {
        float v[kOps];
        v[0] = acc[n];
        if constexpr (kOps == 2) v[1] = acc2[n];
#pragma unroll
        for (int op = 0; op < kOps; ++op) {
          v[op] += __shfl_xor_sync(~0u, v[op], 8);
          v[op] += __shfl_xor_sync(~0u, v[op], 16);
        }
        if (kq == 0) store(toks[n], c0 + cl, v);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// between the projections: h = act(the up partials summed in split order)
// ---------------------------------------------------------------------------

template <typename T, int kOps>
__global__ void __launch_bounds__(kCombineThreads)
finish_kernel(const float* __restrict__ part, const float* __restrict__ part_m, T* __restrict__ h,
              T* __restrict__ hm, int trees, int Bc, int l, int mw, int splits, int act) {
  grid_launch_dependents();   // the down projection's weights may start streaming
  grid_wait();                // the up projection's partial sums
  const size_t leaf_n = static_cast<size_t>(trees) * Bc * l;
  const size_t n = leaf_n + static_cast<size_t>(Bc) * mw;
  for (size_t i = blockIdx.x * static_cast<size_t>(kCombineThreads) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * kCombineThreads) {
    const bool master = i >= leaf_n;
    const size_t r = master ? (i - leaf_n) / mw : i / l;   // row: (tree, token), or token
    const int col = static_cast<int>(master ? (i - leaf_n) % mw : i % l);
    const int width = master ? mw : l;
    const size_t rows = master ? Bc : static_cast<size_t>(trees) * Bc;
    const float* p = (master ? part_m : part) + r * kOps * width + col;
    float v[kOps];
#pragma unroll
    for (int op = 0; op < kOps; ++op) {
      v[op] = 0.0f;
      for (int q = 0; q < splits; ++q) v[op] += __ldcg(p + (q * rows * kOps + op) * width);
    }
    const float out = kOps == 2 ? fff::silu(v[0]) * v[kOps - 1] : fff::activate(v[0], act);
    (master ? hm + r * mw : h + r * l)[col] = fff::from_f32<T>(out);
  }
}

// ---------------------------------------------------------------------------
// 4. combine: y = each tree's partials over l summed in order, the trees
//    and then the master summed in order, rounded once
// ---------------------------------------------------------------------------

template <typename T, int V>
__global__ void __launch_bounds__(kCombineThreads)
combine_kernel(const float* __restrict__ part, T* __restrict__ y, int Bc, int O, int slots,
               int splits) {
  grid_wait();   // the down projection's partial sums
  const int b = blockIdx.y, o = (blockIdx.x * kCombineThreads + threadIdx.x) * V;
  if (o >= O) return;
  const size_t slot = static_cast<size_t>(Bc) * O;   // to the next slot
  const float* p = part + static_cast<size_t>(b) * O + o;
  float sum[V] = {};
  for (int u = 0; u < slots; ++u) {
    float tree[V] = {};
    for (int q = 0; q < splits; ++q) {
      const float* pq = p + (static_cast<size_t>(q) * slots + u) * slot;
      if constexpr (V == 4) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(pq));
        tree[0] += v.x, tree[1] += v.y, tree[2] += v.z, tree[3] += v.w;
      } else {
        tree[0] += __ldcg(pq);
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) sum[v] += tree[v];
  }
  T* yr = y + static_cast<size_t>(b) * O + o;
#pragma unroll
  for (int v = 0; v < V; ++v) yr[v] = fff::from_f32<T>(sum[v]);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// A 3-D tensor map over a contiguous (outer, mid, inner) array read in boxes
// of 128 bytes of inner x box_mid rows of one outer index, 128-byte swizzle,
// zeros outside; cached by everything it is a pure function of.
struct MapKey {
  const void* p;
  int inner, mid, outer, box_mid, bf16, device;
  bool operator==(const MapKey& o) const {
    return p == o.p && inner == o.inner && mid == o.mid && outer == o.outer &&
           box_mid == o.box_mid && bf16 == o.bf16 && device == o.device;
  }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    size_t h = std::hash<const void*>()(k.p);
    const int parts[6] = {k.inner, k.mid, k.outer, k.box_mid, k.bf16, k.device};
    for (int v : parts) h = h * 1000003u ^ static_cast<size_t>(v);
    return h;
  }
};

cudaError_t tensor_map(CUtensorMap* map, const void* base, bool bf16, int inner, int mid,
                       int outer, int box_mid, int device) {
  constexpr size_t kMaxMaps = 4096;   // cleared when full
  static std::mutex mu;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> cache;
  const MapKey key{base, inner, mid, outer, box_mid, bf16 ? 1 : 0, device};
  std::lock_guard<std::mutex> lock(mu);
  const auto found = cache.find(key);
  if (found != cache.end()) {
    *map = found->second;
    return cudaSuccess;
  }
  const PFN_cuTensorMapEncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const size_t sz = bf16 ? 2 : 4;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(mid),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(inner) * sz,
                                 static_cast<cuuint64_t>(inner) * mid * sz};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kRowBytes / sz),
                             static_cast<cuuint32_t>(box_mid), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
      const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  if (cache.size() >= kMaxMaps) cache.clear();
  cache.emplace(key, *map);
  return cudaSuccess;
}

// raises one kernel's dynamic shared-memory limit to `bytes`, once a device
cudaError_t allow_smem(int (&allowed)[kMaxDevices], const void* kernel, int bytes, int device) {
  if (device < kMaxDevices && allowed[device] >= bytes) return cudaSuccess;
  if (const cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)) {
    cudaGetLastError();   // returned here: leave no error for a later launch check
    return err;
  }
  if (device < kMaxDevices) allowed[device] = bytes;
  return cudaSuccess;
}

size_t align256(size_t n) { return (n + 255) / 256 * 256; }
int cdiv(int a, int b) { return (a + b - 1) / b; }

struct Call {
  const void *x, *nw, *nb, *w1, *w3, *w2, *m1, *m3, *m2;
  void* y;
  int* leaf_idx;
  unsigned char* ws;
  int B, D, T, depth, E, l, O, mw, act, path, chunk, splits_up, splits_down, rmax, stages_up,
      stages_down, device;
  cudaStream_t s;
};

// the workspace of a call whose largest chunk is b0 tokens (kernel.py
// workspace_layout): the up partials and the master's (with D split), h,
// hm, then (unless the down projection writes y directly) the down
// partials, (splits_down, T + master, b0, O) f32
struct Workspace {
  size_t part_m, h, hm, part_down;
  Workspace(int T, int b0, int l, int mw, int ops, int elem, int splits_up) {
    const size_t ranges = splits_up > 1 ? splits_up : 0;   // one range: h directly
    part_m = align256(ranges * T * b0 * ops * l * 4);
    h = align256(part_m + ranges * b0 * ops * mw * 4);
    hm = align256(h + static_cast<size_t>(T) * b0 * l * elem);
    part_down = align256(hm + static_cast<size_t>(b0) * mw * elem);
  }
};

// a launch that may begin while the grid before it on the stream finishes
// (programmatic dependent launch; the kernel waits with grid_wait)
template <typename... Params, typename... Args>
cudaError_t launch_after(void (*kernel)(Params...), dim3 grid, int threads, int smem,
                         cudaStream_t s, Args&&... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if (const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...))
    return err;
  return cudaGetLastError();
}

// one projection of a chunk: the kernel for its operands and path
template <typename T, int kOps, bool kUp, bool kTma, int kTok>
cudaError_t stream_phase_as(const Call& c, const StreamArgs<T>& a, dim3 grid, int smem,
                            const CUtensorMap (&maps)[6]) {
  auto kernel = stream_kernel<T, kOps, kUp, kTma, kTok>;
  static int allowed[kMaxDevices] = {};
  if (const cudaError_t err =
          allow_smem(allowed, reinterpret_cast<const void*>(kernel), smem, c.device))
    return err;
  return launch_after(kernel, grid, kThreads, smem, c.s, maps[0], maps[1], maps[2], maps[3],
                      maps[4], maps[5], a);
}

// the kernel whose accumulators hold the chunk's tokens: 8 (one N tile),
// 32 or 64 in bf16 on the TMA path, 8 or 32 in float32 on it; the chunk's
// most on the element-wise path
template <typename T, int kOps, bool kUp, bool kTma>
cudaError_t stream_phase(const Call& c, const StreamArgs<T>& a, dim3 grid, int smem,
                         const CUtensorMap (&maps)[6]) {
  constexpr int kMax = Geo<T>::kMaxTok;
  if constexpr (kTma) {
    if (a.Bc <= 8) return stream_phase_as<T, kOps, kUp, kTma, 8>(c, a, grid, smem, maps);
    if (a.Bc <= 32) return stream_phase_as<T, kOps, kUp, kTma, 32>(c, a, grid, smem, maps);
  }
  return stream_phase_as<T, kOps, kUp, kTma, kMax>(c, a, grid, smem, maps);
}

// the route phase of a chunk: x's and each node's row in registers where
// 512 threads hold them in at most 4 loads each, else a loop over D
template <typename T, bool kTma>
cudaError_t route(const Call& c, const T* x, int* idx, int bc) {
  constexpr int V = kTma ? fff::kVec<T> : 1;
  const int per = cdiv(c.D, kRouteThreads * V);
  const T* nw = static_cast<const T*>(c.nw);
  const T* nb = static_cast<const T*>(c.nb);
  auto kernel = !kTma || per > 4 ? route_kernel<T, V, 0>
                : per == 1       ? route_kernel<T, V, 1>
                : per == 2       ? route_kernel<T, V, 2>
                                 : route_kernel<T, V, 4>;
  kernel<<<dim3(bc, c.T), kRouteThreads, 0, c.s>>>(x, nw, nb, idx, c.D, c.T, c.depth);
  return cudaGetLastError();
}

template <typename T, bool kTma>
cudaError_t run(const Call& c) {
  using G = Geo<T>;
  constexpr bool kBF16 = G::kBF16;
  const bool dual = c.w3 != nullptr, master = c.mw > 0;
  const int ops = dual ? 2 : 1;
  const int b0 = c.B < c.chunk ? c.B : c.chunk;             // the largest chunk
  const int win_bytes = cdiv(b0, kWin) * kWinBytes;         // windows of one row of k
  const int stage_up = ops * G::kBox + kStageK * win_bytes;
  const int stage_down = G::kBox + kStageK * win_bytes;
  const int smem_up = 1024 + c.stages_up * stage_up, smem_down = 1024 + c.stages_down * stage_down;
  const int z = c.T * c.rmax + (master ? 1 : 0);   // (tree, rank) blocks, then the master's
  if (c.rmax < (b0 < c.E ? b0 : c.E)) return cudaErrorInvalidValue;   // a rank left uncovered
  const bool direct = c.T == 1 && !master && c.splits_down == 1;   // down writes y
  const size_t sz = sizeof(T);
  const Workspace w(c.T, b0, c.l, c.mw, ops, static_cast<int>(sz), c.splits_up);
  float* part_up = reinterpret_cast<float*>(c.ws);
  float* part_upm = reinterpret_cast<float*>(c.ws + w.part_m);
  T* h = reinterpret_cast<T*>(c.ws + w.h);
  T* hm = reinterpret_cast<T*>(c.ws + w.hm);
  float* part_down = direct ? nullptr : reinterpret_cast<float*>(c.ws + w.part_down);
  const T* x = static_cast<const T*>(c.x);
  const int trees_e = c.T * c.E;

  CUtensorMap w_up[2] = {}, m_up[2] = {}, w_down = {}, m_down = {}, none = {};
  if constexpr (kTma) {
    const void* ups[2] = {c.w1, c.w3};
    const void* mups[2] = {c.m1, c.m3};
    for (int op = 0; op < ops; ++op) {
      if (const cudaError_t err = tensor_map(&w_up[op], ups[op], kBF16, c.l, c.D, trees_e, G::kK,
                                             c.device))
        return err;
      if (master)
        if (const cudaError_t err =
                tensor_map(&m_up[op], mups[op], kBF16, c.mw, c.D, 1, G::kK, c.device))
          return err;
    }
    if (const cudaError_t err =
            tensor_map(&w_down, c.w2, kBF16, c.O, c.l, trees_e, G::kK, c.device))
      return err;
    if (master)
      if (const cudaError_t err = tensor_map(&m_down, c.m2, kBF16, c.O, c.mw, 1, G::kK, c.device))
        return err;
  }

  for (int c0 = 0; c0 < c.B; c0 += c.chunk) {
    const int bc = c.B - c0 < c.chunk ? c.B - c0 : c.chunk;
    const T* xc = x + static_cast<size_t>(c0) * c.D;
    T* yc = static_cast<T*>(c.y) + static_cast<size_t>(c0) * c.O;
    int* idx = c.leaf_idx + static_cast<size_t>(c0) * c.T;

    if (const cudaError_t err = route<T, kTma>(c, xc, idx, bc)) return err;

    CUtensorMap xmap = {}, hmap = {}, hmmap = {};
    if constexpr (kTma) {
      if (const cudaError_t err = tensor_map(&xmap, xc, kBF16, c.D, bc, 1, kWin, c.device))
        return err;
      if (const cudaError_t err = tensor_map(&hmap, h, kBF16, c.l, bc, c.T, kWin, c.device))
        return err;
      if (master)
        if (const cudaError_t err = tensor_map(&hmmap, hm, kBF16, c.mw, bc, 1, kWin, c.device))
          return err;
    }

    StreamArgs<T> up = {};
    up.w[0] = static_cast<const T*>(c.w1);
    up.w[1] = static_cast<const T*>(c.w3);
    up.m[0] = static_cast<const T*>(c.m1);
    up.m[1] = static_cast<const T*>(c.m3);
    up.in = up.in_m = xc;
    up.leaf_idx = idx;
    up.part = part_up;
    up.part_m = part_upm;
    if (c.splits_up == 1) up.out = h, up.out_m = hm;   // h directly, no finish
    up.Bc = bc, up.trees = c.T, up.E = c.E, up.K = c.D, up.M = c.l, up.Km = c.D, up.Mm = c.mw;
    up.act = c.act, up.rmax = c.rmax, up.master = master, up.stages = c.stages_up;
    up.stage_bytes = stage_up;
    up.win_bytes = win_bytes;
    const dim3 grid_up(cdiv(c.l > c.mw ? c.l : c.mw, G::kCols), c.splits_up, z);
    const CUtensorMap up_maps[6] = {w_up[0], w_up[1], m_up[0], m_up[1], xmap, xmap};
    const cudaError_t err_up =
        dual ? stream_phase<T, 2, true, kTma>(c, up, grid_up, smem_up, up_maps)
             : stream_phase<T, 1, true, kTma>(c, up, grid_up, smem_up, up_maps);
    if (err_up != cudaSuccess) return err_up;

    if (c.splits_up > 1) {
      const dim3 fin_grid(cdiv((c.T * bc * c.l + bc * c.mw), kCombineThreads));
      const float* pu = part_up;
      const float* pm = part_upm;
      if (const cudaError_t err =
              dual ? launch_after(finish_kernel<T, 2>, fin_grid, kCombineThreads, 0, c.s, pu, pm,
                                  h, hm, c.T, bc, c.l, c.mw, c.splits_up, c.act)
                   : launch_after(finish_kernel<T, 1>, fin_grid, kCombineThreads, 0, c.s, pu, pm,
                                  h, hm, c.T, bc, c.l, c.mw, c.splits_up, c.act))
        return err;
    }

    StreamArgs<T> down = {};
    down.w[0] = static_cast<const T*>(c.w2);
    down.m[0] = static_cast<const T*>(c.m2);
    down.in = h;
    down.in_m = hm;
    down.leaf_idx = idx;
    down.part = part_down;
    down.out = direct ? yc : nullptr;
    down.Bc = bc, down.trees = c.T, down.E = c.E, down.K = c.l, down.M = c.O, down.Km = c.mw,
    down.Mm = c.O;
    down.rmax = c.rmax, down.master = master, down.stages = c.stages_down,
    down.stage_bytes = stage_down, down.win_bytes = win_bytes;
    const dim3 grid_down(cdiv(c.O, G::kCols), c.splits_down, z);
    const CUtensorMap down_maps[6] = {w_down, none, m_down, none, hmap, hmmap};
    if (const cudaError_t err =
            stream_phase<T, 1, false, kTma>(c, down, grid_down, smem_down, down_maps))
      return err;

    if (!direct) {
      const int slots = c.T + (master ? 1 : 0);
      const float* pd = part_down;
      if (const cudaError_t err =
              c.O % 4 == 0
                  ? launch_after(combine_kernel<T, 4>, dim3(cdiv(c.O, kCombineThreads * 4), bc),
                                 kCombineThreads, 0, c.s, pd, yc, bc, c.O, slots, c.splits_down)
                  : launch_after(combine_kernel<T, 1>, dim3(cdiv(c.O, kCombineThreads), bc),
                                 kCombineThreads, 0, c.s, pd, yc, bc, c.O, slots, c.splits_down))
        return err;
    }
  }
  return cudaSuccess;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
cudaError_t dispatch(const Call& c) {
  if (c.chunk < 1 || c.chunk > Geo<T>::kMaxTok) return cudaErrorInvalidValue;
  if (c.path == kPathElementwise) return run<T, false>(c);
  // a tensor map needs 16-byte rows and bases
  constexpr int V = fff::kVec<T>;
  const bool rows = c.D % V == 0 && c.l % V == 0 && c.O % V == 0 && c.mw % V == 0;
  const bool bases = aligned16(c.x) && aligned16(c.nw) && aligned16(c.w1) && aligned16(c.w2) &&
                     (c.w3 == nullptr || aligned16(c.w3)) && aligned16(c.m1) &&
                     aligned16(c.m2) && aligned16(c.m3) && aligned16(c.ws);
  if (c.path != kPathTma || !rows || !bases) return cudaErrorInvalidValue;
  return run<T, true>(c);
}

}  // namespace

// x (B, D); collapsed nodes nw (T, N, D), nb (T, N); leaves w1 (T, E, D, l)
// [gate for SwiGLU], w3 (T, E, D, l) [SwiGLU up, else null],
// w2 (T, E, l, O); optional master m1/m3 (D, mw), m2 (mw, O) (null and mw
// = 0 when absent); all one dtype.  Writes y (B, O) and leaf_idx (B, T)
// int32.  The plan (kernels/fused_decode/kernel.py::plan): path, tokens a
// chunk, ranges of D (up) and of l (down), ranks a tree's blocks cover and
// the ring stages of the two projections; ws is its workspace
// (kernel.py::workspace_layout), which needs no fill.  Returns the first
// CUDA error (a refused launch or tensor map included), else cudaSuccess
// after the last launch.
extern "C" int fused_forest_decode(const void* x, const void* nw, const void* nb,
                                   const void* w1, const void* w3, const void* w2,
                                   const void* m1, const void* m3, const void* m2, void* y,
                                   int* leaf_idx, void* ws, int B, int D, int T, int depth,
                                   int E, int l, int O, int mw, int act, int dtype, int path,
                                   int chunk, int splits_up, int splits_down, int rmax,
                                   int stages_up, int stages_down, int device, void* stream) {
  if (const cudaError_t err = cudaSetDevice(device)) return static_cast<int>(err);
  const bool swiglu = act == fff::kActSwiglu;
  if (B < 1 || D < 1 || T < 1 || depth < 1 || depth > 12 || l < 1 || O < 1 || mw < 0 ||
      E != (1 << depth) || act < fff::kActNone || act > fff::kActSwiglu ||
      swiglu != (w3 != nullptr) || (mw > 0) != (m1 != nullptr) ||
      (mw > 0 && swiglu != (m3 != nullptr)) || splits_up < 1 || splits_up > 65535 ||
      splits_down < 1 || splits_down > 65535 || rmax < 1 || stages_up < 2 || stages_up > kMaxStages ||
      stages_down < 2 || stages_down > kMaxStages || ws == nullptr)
    return cudaErrorInvalidValue;
  const Call c{x, nw, nb, w1, w3, w2, m1, m3, m2, y, leaf_idx,
               static_cast<unsigned char*>(ws), B, D, T, depth, E, l, O, mw, act, path,
               chunk, splits_up, splits_down, rmax, stages_up, stages_down, device,
               static_cast<cudaStream_t>(stream)};
  if (dtype == fff::kF32) return static_cast<int>(dispatch<float>(c));
  if (dtype == fff::kBF16) return static_cast<int>(dispatch<__nv_bfloat16>(c));
  return cudaErrorInvalidValue;
}
