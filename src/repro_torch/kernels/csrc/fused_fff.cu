// Per-token gathered leaf matmuls: y[i] = act(x[i] @ w[leaf_idx[i]]) and
// the SwiGLU up-projection y[i] = silu(x[i] @ wg[idx[i]]) * (x[i] @ wu[idx[i]]).
//
// Replaces repro/kernels/fused_fff/kernel.py::gathered_matmul and
// ::gathered_matmul_dual (Pallas TPU kernels, bodies _gathered_kernel and
// _gathered_dual_kernel).  x (B, D), w (E, D, H), leaf_idx (B,) int32 ->
// y (B, H) in x's dtype, f32 accumulation.  The routed leaf index is the
// offset of the weight loads, w + idx[i] * D * H: the paper's "conditional
// execution is an offset in the data load".
//
// Bound on the H100: bytes.  A token multiplies its D-vector into one
// leaf's (D, H) slab, one multiply-add per weight element, so the work is
// one operation per weight byte in bf16, ~300x below where the tensor cores
// would be the limit.  The least traffic is the distinct routed leaves'
// slabs, read once (25.2 MB per leaf for the dual form at internlm2-20b
// width, D = 6144, H = 1024).
// Design (simple first kernel): the TPU grid (B, H/bh, D/bk) carries an f32
// VMEM accumulator across its sequential k axis; here the loop over D
// lives inside the block, and the work spreads over the SMs by output
// column tiles: block (i, j) owns token i's columns [64 j, 64 j + 64), so
// 32 verify tokens give 512 blocks at H = 1024 and 3072 at H = 6144 (one
// block per token would occupy 32 of 132 SMs).  Tokens are the fastest
// grid axis, so the blocks of tokens that share a leaf read the same
// column tile at about the same time and the rereads can hit L2.  Each
// block stages its token row in shared memory as f32; its 256 threads
// stride over the rows of D, each owning V adjacent columns and reading
// them 16 bytes at a time (8 bf16, 4 f32) where H and the pointers allow,
// element by element otherwise; the dual form reads wg and wu in the same
// pass.  Partial sums meet in shared memory, the activation is applied in
// f32 and the result rounds to the element type once.  Every token still
// reads its own leaf, so a leaf routed to by n tokens is read up to n times
// from L2 or memory; sharing leaf tiles across tokens is later work.
// A leaf index outside [0, E) reads no weights and yields a zero row.
#include "common.cuh"

namespace {

constexpr int kBH = 64;  // output columns per block
constexpr int kThreads = 256;

// V columns per thread: kTpr threads across one row's kBH columns, kRows
// weight rows read at once
template <int V>
struct Tile {
  static constexpr int kTpr = kBH / V;
  static constexpr int kRows = kThreads / kTpr;
};

template <typename T, int V, bool kDual>
__global__ void __launch_bounds__(kThreads)
gathered_kernel(const T* __restrict__ x, const T* __restrict__ w,
                const T* __restrict__ w2, const int* __restrict__ leaf_idx,
                T* __restrict__ y, int D, int H, int E, int act) {
  constexpr int kTpr = Tile<V>::kTpr, kRows = Tile<V>::kRows;
  extern __shared__ float smem[];
  float* xs = smem;                   // [D]
  float* part = xs + D;               // [kRows][kBH]
  float* part2 = part + kRows * kBH;  // [kRows][kBH], dual form only
  const int b = blockIdx.x, h0 = blockIdx.y * kBH, tid = threadIdx.x;
  const int leaf = leaf_idx[b];
  T* yr = y + static_cast<size_t>(b) * H;
  if (leaf < 0 || leaf >= E) {
    for (int c = tid; c < kBH; c += kThreads)
      if (h0 + c < H) yr[h0 + c] = fff::from_f32<T>(0.0f);
    return;
  }
  const T* xr = x + static_cast<size_t>(b) * D;
  for (int d = tid; d < D; d += kThreads) xs[d] = fff::to_f32(xr[d]);
  __syncthreads();

  const size_t slab = static_cast<size_t>(leaf) * D * H;
  const T* wl = w + slab;
  const T* w2l = kDual ? w2 + slab : nullptr;
  const int c0 = (tid % kTpr) * V, r0 = tid / kTpr, c = h0 + c0;
  float a1[V] = {}, a2[V] = {}, wv[V];
  if (c < H) {  // V > 1 needs H % V == 0, so the whole vector is inside
#pragma unroll 4
    for (int d = r0; d < D; d += kRows) {
      const float xv = xs[d];
      const size_t off = static_cast<size_t>(d) * H + c;
      fff::load_vec<T, V>(wl + off, wv);
#pragma unroll
      for (int v = 0; v < V; ++v) a1[v] += xv * wv[v];
      if constexpr (kDual) {
        fff::load_vec<T, V>(w2l + off, wv);
#pragma unroll
        for (int v = 0; v < V; ++v) a2[v] += xv * wv[v];
      }
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    part[r0 * kBH + c0 + v] = a1[v];
    if constexpr (kDual) part2[r0 * kBH + c0 + v] = a2[v];
  }
  __syncthreads();
  if (tid < kBH && h0 + tid < H) {
    float g = 0.0f, u = 0.0f;
    for (int r = 0; r < kRows; ++r) {
      g += part[r * kBH + tid];
      if constexpr (kDual) u += part2[r * kBH + tid];
    }
    yr[h0 + tid] = fff::from_f32<T>(kDual ? fff::silu(g) * u : fff::activate(g, act));
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, int V, bool kDual>
int launch_as(const void* x, const void* w, const void* w2, const int* idx,
              void* y, int B, int D, int H, int E, int act, cudaStream_t s) {
  const size_t smem =
      (static_cast<size_t>(D) + (kDual ? 2 : 1) * Tile<V>::kRows * kBH) * sizeof(float);
  auto kernel = gathered_kernel<T, V, kDual>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(B, (H + kBH - 1) / kBH);
  kernel<<<grid, kThreads, smem, s>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                      static_cast<const T*>(w2), idx, static_cast<T*>(y),
                                      D, H, E, act);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kDual>
int launch_typed(const void* x, const void* w, const void* w2, const int* idx,
                 void* y, int B, int D, int H, int E, int act, cudaStream_t s) {
  constexpr int V = fff::kVec<T>;
  const bool vector = H % V == 0 && aligned16(w) && (!kDual || aligned16(w2));
  return vector ? launch_as<T, V, kDual>(x, w, w2, idx, y, B, D, H, E, act, s)
                : launch_as<T, 1, kDual>(x, w, w2, idx, y, B, D, H, E, act, s);
}

template <bool kDual>
int launch(const void* x, const void* w, const void* w2, const int* idx,
           void* y, int B, int D, int H, int E, int act, int dtype,
           void* stream) {
  if (B < 1 || D < 1 || H < 1 || E < 1) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == fff::kF32)
    return launch_typed<float, kDual>(x, w, w2, idx, y, B, D, H, E, act, s);
  if (dtype == fff::kBF16)
    return launch_typed<__nv_bfloat16, kDual>(x, w, w2, idx, y, B, D, H, E, act, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// x (B, D), w (E, D, H), leaf_idx (B,) int32 -> y (B, H), one dtype; act is
// an activation code other than swiglu.
extern "C" int gathered_matmul(const void* x, const void* w, const int* leaf_idx,
                               void* y, int B, int D, int H, int E, int act,
                               int dtype, int device, void* stream) {
  if (const cudaError_t err = cudaSetDevice(device)) return static_cast<int>(err);
  if (act < fff::kActNone || act > fff::kActSilu) return cudaErrorInvalidValue;
  return launch<false>(x, w, nullptr, leaf_idx, y, B, D, H, E, act, dtype, stream);
}

// SwiGLU up-projection with per-token leaves: y = silu(x @ wg[i]) * (x @ wu[i]).
extern "C" int gathered_matmul_dual(const void* x, const void* wg, const void* wu,
                                    const int* leaf_idx, void* y, int B, int D,
                                    int H, int E, int dtype, int device,
                                    void* stream) {
  if (const cudaError_t err = cudaSetDevice(device)) return static_cast<int>(err);
  return launch<true>(x, wg, wu, leaf_idx, y, B, D, H, E, fff::kActSwiglu, dtype,
                      stream);
}
