// Per-token gathered leaf matmuls: y[i] = act(x[i] @ w[leaf_idx[i]]) and
// the SwiGLU up-projection y[i] = silu(x[i] @ wg[idx[i]]) * (x[i] @ wu[idx[i]]).
//
// Replaces repro/kernels/fused_fff/kernel.py::gathered_matmul and
// ::gathered_matmul_dual (Pallas TPU kernels, bodies _gathered_kernel and
// _gathered_dual_kernel).  x (B, D), w (E, D, H), leaf_idx (B,) int32 ->
// y (B, H) in x's dtype, f32 accumulation.  The routed leaf index is the
// offset of the weight loads: the paper's "conditional execution is an
// offset in the data load".
//
// Bound on the H100: bytes.  A token multiplies its D-vector into one
// leaf's (D, H) slab, one multiply-add per weight element and token, so the
// work is a few operations per weight byte, ~100x below where the tensor
// cores would be the limit.  The least traffic is the distinct routed
// leaves' slabs, read once (25.2 MB per leaf for the dual form at
// internlm2-20b width, D = 6144, H = 1024).
//
// Design: the grid runs over (column tile, leaf), so each block owns one
// leaf's 128-byte-wide column tile (64 columns in bf16, 32 in float32) and
// reads it once for every token routed to that leaf.  A block reads the B
// leaf indices, lists its leaf's tokens in token order in shared memory (up
// to kMaxTok = 32 a pass; a leaf with more takes further passes, each
// rereading the tile) and exits at once if the list is empty.  Blocks of
// leaf 0 also write the zero rows of tokens whose index lies outside
// [0, E), which no leaf owns.  The loop over D streams the tile through a
// ring of shared-memory stages, each kRows rows of D deep: one thread asks
// the copy engine (TMA, a 3-D tensor map over (E, D, H) in the 128-byte
// swizzle; out-of-range rows and columns arrive as zeros) for the weight
// box, wg's and wu's together for the dual form, completing on the stage's
// mbarrier, while every thread copies 16-byte pieces of the listed tokens'
// x rows (the matching kRows elements, zeros past D) with cp.async, one
// commit group a stage, into rows padded to 144 bytes against bank
// conflicts.  (On the H100 a bulk copy per token row, and an mbarrier
// arrival per thread for its copies, both ran slower.)  D or H off the
// 16-byte vector, or a base pointer off 16 bytes, which the copies cannot
// describe, takes element-wise copies by every thread into the same
// layout, zero past D and H.
//   bf16: tensor cores, mma.sync m16n8k16 with the weights as A (ldmatrix
//   .trans of 16 columns x 16 rows of D) and the tokens as N in tiles of 8;
//   each of the 4 warps owns 16 columns and runs every row of D, so its
//   fragments are the finished sums.
//   float32: CUDA cores in full float32 (no TF32): thread = (column, warp q),
//   warp q takes the row quads q and q + 4 of each stage, reading x four
//   rows at a time and skipping an empty second half of the last 8-token
//   tile; the 4 warps' partials are summed in warp order through shared
//   memory.
// The activation is applied in f32 and the result rounds to the element
// type once.  No atomics: each output element is written by one thread, and
// every sum runs in a fixed order, so two calls give bit-identical outputs.
#include "tma.cuh"

namespace {

constexpr int kThreads = 128;             // 4 warps
constexpr int kMaxTok = 32;               // tokens of one leaf in one pass: 4 mma n-tiles
constexpr int kXPitch = kRowBytes + 16;   // a token's x row in a stage, padded
constexpr int kMaxDevices = 16;

// a block's column tile and a stage's rows of D: one 128-byte swizzled row
// of each weight matrix per row of D, and kRows elements of each x row
template <typename T>
struct Tile {
  static constexpr int kCols = kRowBytes / sizeof(T);
  static constexpr int kRows = kRowBytes / sizeof(T);
  static constexpr int kW = kRows * kRowBytes;   // one matrix's bytes in a stage
};

// weights (1 or 2 matrices), then kMaxTok x rows; 1024-byte aligned stages
template <typename T, bool kDual>
__host__ __device__ constexpr int stage_bytes() {
  return ((kDual ? 2 : 1) * Tile<T>::kW + kMaxTok * kXPitch + 1023) / 1024 * 1024;
}

// a 16 x 16 bf16 A fragment from four 8 x 8 matrices, transposed on the way
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(addr));
}

template <typename T, bool kDual, int kStages, bool kTma>
__global__ void __launch_bounds__(kThreads)
gathered_kernel(const __grid_constant__ CUtensorMap wmap,
                const __grid_constant__ CUtensorMap w2map, const T* __restrict__ x,
                const T* __restrict__ w, const T* __restrict__ w2,
                const int* __restrict__ leaf_idx, T* __restrict__ y, int B, int D, int H,
                int E, int act) {
  constexpr bool kBF16 = sizeof(T) == 2;
  constexpr int kCols = Tile<T>::kCols, kRows = Tile<T>::kRows, kW = Tile<T>::kW;
  constexpr int kStage = stage_bytes<T, kDual>();
  constexpr int kXOff = (kDual ? 2 : 1) * kW;   // x rows in a stage
  constexpr int kNT = kMaxTok / 8;
  static_assert(kBF16 || kStages * kStage >= (kDual ? 8 : 4) * kMaxTok * kCols * 4,
                "the float32 partials meet over the ring");
  extern __shared__ unsigned char smem_raw[];
  // [ring: kStages stages][mbarriers]
  unsigned char* smem = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  const uint32_t bars = smem_addr(smem + kStages * kStage);
  __shared__ int toks[kMaxTok];
  __shared__ int s_ntok, s_cursor;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int h0 = blockIdx.x * kCols, leaf = blockIdx.y;

  if (leaf == 0)   // the owner of tokens routed outside [0, E): zero rows
    for (int p = tid; p < B * kCols; p += kThreads) {
      const int b = p / kCols, col = h0 + p % kCols, e = leaf_idx[b];
      if ((e < 0 || e >= E) && col < H) y[static_cast<size_t>(b) * H + col] = fff::from_f32<T>(0.0f);
    }
  if (kTma && tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  const int nk = (D + kRows - 1) / kRows;   // stages per pass
  int it = 0;                               // stages consumed by earlier passes
  int cursor = 0;                           // first token not yet scanned
  for (;;) {
    // this pass's tokens: the next kMaxTok routed to this leaf, in token order
    if (warp == 0) {
      if (lane == 0) s_cursor = B;
      __syncwarp();
      int n = 0;
      for (int base = cursor; base < B && n < kMaxTok; base += 32) {
        const int b = base + lane;
        const bool hit = b < B && leaf_idx[b] == leaf;
        const unsigned mask = __ballot_sync(0xffffffffu, hit);
        const int pos = n + __popc(mask & ((1u << lane) - 1));
        if (hit && pos < kMaxTok) toks[pos] = b;
        if (hit && pos == kMaxTok - 1) s_cursor = b + 1;
        n += __popc(mask);
      }
      if (lane == 0) s_ntok = min(n, kMaxTok);
    }
    __syncthreads();
    const int ntok = s_ntok;
    if (ntok == 0) return;
    cursor = s_cursor;
    const int ntiles = (ntok + 7) / 8;

    auto load = [&](int i) {   // rows [i kRows, (i + 1) kRows) of D into stage (it + i) % kStages
      const int si = (it + i) % kStages, d0 = i * kRows;
      unsigned char* st = smem + si * kStage;
      if constexpr (kTma) {
        const uint32_t bar = bars + 8 * si;
        if (tid == 0) {
          mbar_expect(bar, (kDual ? 2 : 1) * kW);
          tma_load(smem_addr(st), wmap, h0, d0, leaf, bar);
          if constexpr (kDual) tma_load(smem_addr(st + kW), w2map, h0, d0, leaf, bar);
        }
        constexpr int kPieces = kRowBytes / 16, kPer = 16 / sizeof(T);
        for (int p = tid; p < ntok * kPieces; p += kThreads) {
          const int s = p / kPieces, k = p % kPieces, d = d0 + k * kPer;
          cp_async16(smem_addr(st + kXOff + s * kXPitch + 16 * k),
                     x + static_cast<size_t>(toks[s]) * D + (d < D ? d : 0), d < D ? 16 : 0);
        }
        cp_async_commit();
      } else {
        for (int p = tid; p < kRows * kCols; p += kThreads) {
          const int r = p / kCols, cc = p % kCols, d = d0 + r, col = h0 + cc;
          const bool in = d < D && col < H;
          const size_t off = (static_cast<size_t>(leaf) * D + d) * H + col;
          const int byte = cc * static_cast<int>(sizeof(T));
          const int o = swz(r, byte / 16) + byte % 16;
          *reinterpret_cast<T*>(st + o) = in ? w[off] : fff::from_f32<T>(0.0f);
          if constexpr (kDual) *reinterpret_cast<T*>(st + kW + o) = in ? w2[off] : fff::from_f32<T>(0.0f);
        }
        for (int p = tid; p < ntok * kRows; p += kThreads) {
          const int s = p / kRows, r = p % kRows, d = d0 + r;
          *reinterpret_cast<T*>(st + kXOff + s * kXPitch + r * static_cast<int>(sizeof(T))) =
              d < D ? x[static_cast<size_t>(toks[s]) * D + d] : fff::from_f32<T>(0.0f);
        }
      }
    };

    // bf16: acc[nt] is token tile nt's mma fragment; float32: acc[0][s] is token s
    float acc[kBF16 ? kNT : 1][kBF16 ? 4 : kMaxTok], acc2[kBF16 ? kNT : 1][kBF16 ? 4 : kMaxTok];
#pragma unroll
    for (int i = 0; i < (kBF16 ? kNT : 1); ++i)
#pragma unroll
      for (int j = 0; j < (kBF16 ? 4 : kMaxTok); ++j) acc[i][j] = acc2[i][j] = 0.0f;

    for (int i = 0; i < kStages - 1; ++i) {
      if (i < nk)
        load(i);
      else if constexpr (kTma)
        cp_async_commit();
    }
    for (int i = 0; i < nk; ++i) {
      // every thread's x copies of stage i have landed (one group a stage)
      if constexpr (kTma) cp_async_wait<kStages - 2>();
      __syncthreads();   // stage i - 1 is free; the copies of stage i are in
      if (i + kStages - 1 < nk)
        load(i + kStages - 1);
      else if constexpr (kTma)
        cp_async_commit();   // an empty group keeps the count
      const int si = (it + i) % kStages;
      if constexpr (kTma) mbar_wait(bars + 8 * si, ((it + i) / kStages) & 1);
      const unsigned char* st = smem + si * kStage;
      const unsigned char* xs = st + kXOff;
      if constexpr (kBF16) {
        // matrix lane / 8 of the A fragment: rows of D +8 for matrices 2, 3,
        // columns +8 (the next 16-byte piece) for matrices 1, 3
        const int mi = lane / 8, piece = 2 * warp + (mi & 1);
        const uint32_t sa = smem_addr(st);
#pragma unroll
        for (int kk = 0; kk < kRows / 16; ++kk) {
          const int row = kk * 16 + (mi >> 1) * 8 + lane % 8;
          uint32_t a[4], a2[4];
          ldsm_x4_trans(a, sa + swz(row, piece));
          if constexpr (kDual) ldsm_x4_trans(a2, sa + kW + swz(row, piece));
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            if (nt < ntiles) {
              const unsigned char* xr = xs + (nt * 8 + g) * kXPitch + 32 * kk + 4 * c;
              const uint32_t b0 = lds32(xr), b1 = lds32(xr + 16);
              mma_bf16(acc[nt], a, b0, b1);
              if constexpr (kDual) mma_bf16(acc2[nt], a2, b0, b1);
            }
          }
        }
      } else {
        // column `lane` (piece lane / 4 of its row), rows 4 j .. 4 j + 3
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = warp + 4 * jj;
          float wv[4], wv2[4];
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int o = swz(4 * j + t, lane / 4) + 4 * (lane % 4);
            wv[t] = *reinterpret_cast<const float*>(st + o);
            if constexpr (kDual) wv2[t] = *reinterpret_cast<const float*>(st + kW + o);
          }
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            if (nt < ntiles) {
#pragma unroll
              for (int u = 0; u < 8; ++u) {
                const int s = nt * 8 + u;
                if (u == 4 && s >= ntok) break;   // the tile's second half is empty
                const float4 xv = *reinterpret_cast<const float4*>(xs + s * kXPitch + 16 * j);
                float& a = acc[0][s];
                a = fmaf(xv.x, wv[0], a);
                a = fmaf(xv.y, wv[1], a);
                a = fmaf(xv.z, wv[2], a);
                a = fmaf(xv.w, wv[3], a);
                if constexpr (kDual) {
                  float& a2 = acc2[0][s];
                  a2 = fmaf(xv.x, wv2[0], a2);
                  a2 = fmaf(xv.y, wv2[1], a2);
                  a2 = fmaf(xv.z, wv2[2], a2);
                  a2 = fmaf(xv.w, wv2[3], a2);
                }
              }
            }
          }
        }
      }
    }
    it += nk;

    auto finish = [&](int s, int col, float v, float v2) {
      if (s < ntok && col < H)
        y[static_cast<size_t>(toks[s]) * H + col] =
            fff::from_f32<T>(kDual ? fff::silu(v) * v2 : fff::activate(v, act));
    };
    if constexpr (kBF16) {
      // fragment element e: column g (+8 for e >= 2) of the warp's 16, token 2c (+1 for odd e)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
        if (nt < ntiles)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            finish(nt * 8 + 2 * c + (e & 1), h0 + 16 * warp + g + 8 * (e >> 1), acc[nt][e],
                   acc2[nt][e]);
    } else {
      // the 4 warps' partials meet over the idle ring, summed in warp order
      __syncthreads();
      float* red = reinterpret_cast<float*>(smem);   // [matrix][warp][token][column]
#pragma unroll
      for (int s = 0; s < kMaxTok; ++s) {
        red[(warp * kMaxTok + s) * kCols + lane] = acc[0][s];
        if constexpr (kDual) red[((4 + warp) * kMaxTok + s) * kCols + lane] = acc2[0][s];
      }
      fence_proxy_async();   // before later copies into these bytes
      __syncthreads();
      for (int p = tid; p < ntok * kCols; p += kThreads) {
        const int s = p / kCols, cc = p % kCols;
        float v = 0.0f, v2 = 0.0f;
        for (int q = 0; q < 4; ++q) {
          v += red[(q * kMaxTok + s) * kCols + cc];
          if constexpr (kDual) v2 += red[((4 + q) * kMaxTok + s) * kCols + cc];
        }
        finish(s, h0 + cc, v, v2);
      }
    }
    __syncthreads();   // toks and the ring are free for the next pass
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// w (E, D, H) as a 3-D tensor map: boxes of one column tile x kRows rows of
// one leaf, 128-byte swizzle, zeros outside
template <typename T>
cudaError_t weight_map(CUtensorMap* map, const T* w, int E, int D, int H) {
  const PFN_cuTensorMapEncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(E)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(H) * sizeof(T),
                                 static_cast<cuuint64_t>(D) * H * sizeof(T)};
  const cuuint32_t box[3] = {Tile<T>::kCols, Tile<T>::kRows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      3, const_cast<T*>(w), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, bool kDual, int kStages, bool kTma>
cudaError_t launch_as(const T* x, const T* w, const T* w2, const int* idx, T* y, int B, int D,
                      int H, int E, int act, int device, cudaStream_t s) {
  const int smem = 1024 + kStages * stage_bytes<T, kDual>() + kStages * 8;
  auto kernel = gathered_kernel<T, kDual, kStages, kTma>;
  static int allowed[kMaxDevices] = {};   // dynamic shared memory allowed so far
  if (device >= kMaxDevices || allowed[device] < smem) {
    if (const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
      return err;
    if (device < kMaxDevices) allowed[device] = smem;
  }
  CUtensorMap wmap = {}, w2map = {};
  if constexpr (kTma) {
    if (const cudaError_t err = weight_map(&wmap, w, E, D, H)) return err;
    if (kDual)
      if (const cudaError_t err = weight_map(&w2map, w2, E, D, H)) return err;
  }
  const dim3 grid((H + Tile<T>::kCols - 1) / Tile<T>::kCols, E);
  kernel<<<grid, kThreads, smem, s>>>(wmap, w2map, x, w, w2, idx, y, B, D, H, E, act);
  return cudaGetLastError();
}

template <typename T, bool kDual>
int launch_typed(const void* xv, const void* wv, const void* w2v, const int* idx, void* yv,
                 int B, int D, int H, int E, int act, int device, cudaStream_t s) {
  // bf16: 5 stages for the dual form (106 KB, two blocks an SM), 4 for the
  // single (53 KB, four); float32: 3 (28-40 KB, five to seven)
  constexpr int kStages = sizeof(T) == 2 ? (kDual ? 5 : 4) : 3;
  const T* x = static_cast<const T*>(xv);
  const T* w = static_cast<const T*>(wv);
  const T* w2 = static_cast<const T*>(w2v);
  T* y = static_cast<T*>(yv);
  // the copies need 16-byte aligned bases and rows
  constexpr int V = fff::kVec<T>;
  const bool tma = D % V == 0 && H % V == 0 && aligned16(x) && aligned16(w) &&
                   (!kDual || aligned16(w2));
  return static_cast<int>(
      tma ? launch_as<T, kDual, kStages, true>(x, w, w2, idx, y, B, D, H, E, act, device, s)
          : launch_as<T, kDual, kStages, false>(x, w, w2, idx, y, B, D, H, E, act, device, s));
}

template <bool kDual>
int launch(const void* x, const void* w, const void* w2, const int* idx, void* y, int B, int D,
           int H, int E, int act, int dtype, int device, void* stream) {
  if (B < 1 || D < 1 || H < 1 || E < 1 || E > 65535) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == fff::kF32)
    return launch_typed<float, kDual>(x, w, w2, idx, y, B, D, H, E, act, device, s);
  if (dtype == fff::kBF16)
    return launch_typed<__nv_bfloat16, kDual>(x, w, w2, idx, y, B, D, H, E, act, device, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// x (B, D), w (E, D, H), leaf_idx (B,) int32 -> y (B, H), one dtype; act is
// an activation code other than swiglu.  Returns the first CUDA error (a
// refused tensor map included), else cudaGetLastError() after the launch.
extern "C" int gathered_matmul(const void* x, const void* w, const int* leaf_idx,
                               void* y, int B, int D, int H, int E, int act,
                               int dtype, int device, void* stream) {
  if (const cudaError_t err = cudaSetDevice(device)) return static_cast<int>(err);
  if (act < fff::kActNone || act > fff::kActSilu) return cudaErrorInvalidValue;
  return launch<false>(x, w, nullptr, leaf_idx, y, B, D, H, E, act, dtype, device, stream);
}

// SwiGLU up-projection with per-token leaves: y = silu(x @ wg[i]) * (x @ wu[i]).
extern "C" int gathered_matmul_dual(const void* x, const void* wg, const void* wu,
                                    const int* leaf_idx, void* y, int B, int D,
                                    int H, int E, int dtype, int device,
                                    void* stream) {
  if (const cudaError_t err = cudaSetDevice(device)) return static_cast<int>(err);
  return launch<true>(x, wg, wu, leaf_idx, y, B, D, H, E, fff::kActSwiglu, dtype, device,
                      stream);
}
