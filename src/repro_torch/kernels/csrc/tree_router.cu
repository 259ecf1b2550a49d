// FFF tree descent (FORWARD_I routing) for a token batch.
//
// Replaces repro/kernels/tree_router/kernel.py::tree_router (the Pallas TPU
// kernel, body _router_kernel): logits x . node_w^T + node_b for all
// N = 2^depth - 1 collapsed node hyperplanes, f32 accumulation, then the
// descent idx = 2 idx + (logit[2^m - 1 + idx] >= 0) — ties go right.
//
// Bound on the H100: bytes.  The work is N*D multiply-adds per token
// (15 * 6144 at internlm2-20b width) against 2*D bytes of token read once,
// ~15 operations per byte, far below the ~295 where the tensor cores would
// be the limit.  Design: one warp per token, eight tokens per block; the
// lanes stride over D and each lane keeps NB node sums in registers, so the
// token row is read once per NB nodes (once in all for N <= 16); the node
// hyperplanes (N*D, 184 KB in bf16) are shared by every warp and stay in
// L1/L2.  When D and the pointers allow, each lane reads 16 bytes at a
// time (8 bf16 or 4 f32) of the token and of each node row, which cuts the
// load instructions 8x (4x); otherwise it reads element by element.  The
// N logits are reduced with warp shuffles into shared memory and lane 0
// descends.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;   // tokens per block
constexpr int kNB = 16;     // node sums held in registers per pass

template <typename T, bool kVector>
__global__ void __launch_bounds__(kWarps * 32)
tree_router_kernel(const T* __restrict__ x, const T* __restrict__ nw,
                   const T* __restrict__ nb, int* __restrict__ out, int B,
                   int D, int depth) {
  extern __shared__ float logits[];  // [kWarps][N]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;  // the ragged last tile: whole warps drop out
  const int N = (1 << depth) - 1;
  float* mine = logits + warp * N;
  const T* xr = x + static_cast<size_t>(b) * D;
  for (int n0 = 0; n0 < N; n0 += kNB) {
    float acc[kNB];
#pragma unroll
    for (int j = 0; j < kNB; ++j) acc[j] = 0.0f;
    if constexpr (kVector) {
      constexpr int V = fff::kVec<T>;
      for (int d = lane * V; d < D; d += 32 * V) {
        float xv[V], wv[V];
        fff::load_vec<T, V>(xr + d, xv);
#pragma unroll
        for (int j = 0; j < kNB; ++j) {
          if (n0 + j < N) {
            fff::load_vec<T, V>(nw + static_cast<size_t>(n0 + j) * D + d, wv);
#pragma unroll
            for (int v = 0; v < V; ++v) acc[j] += xv[v] * wv[v];
          }
        }
      }
    } else {
      for (int d = lane; d < D; d += 32) {
        const float xv = fff::to_f32(xr[d]);
#pragma unroll
        for (int j = 0; j < kNB; ++j)
          if (n0 + j < N)
            acc[j] += xv * fff::to_f32(nw[static_cast<size_t>(n0 + j) * D + d]);
      }
    }
#pragma unroll
    for (int j = 0; j < kNB; ++j) {
      const float s = fff::warp_sum(acc[j]);
      if (lane == 0 && n0 + j < N) mine[n0 + j] = s + fff::to_f32(nb[n0 + j]);
    }
  }
  __syncwarp();
  if (lane == 0) {
    int idx = 0, off = 0;
    for (int m = 0; m < depth; ++m) {
      idx = 2 * idx + (mine[off + idx] >= 0.0f ? 1 : 0);
      off += 1 << m;
    }
    out[b] = idx;
  }
}

template <typename T>
void launch(const void* x, const void* nw, const void* nb, int* out, int B,
            int D, int depth, cudaStream_t s) {
  const dim3 grid((B + kWarps - 1) / kWarps);
  const size_t smem = kWarps * ((1 << depth) - 1) * sizeof(float);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(nw);
  const bool vector = D % fff::kVec<T> == 0 &&
                      (reinterpret_cast<uintptr_t>(xt) & 15) == 0 &&
                      (reinterpret_cast<uintptr_t>(wt) & 15) == 0;
  if (vector)
    tree_router_kernel<T, true><<<grid, kWarps * 32, smem, s>>>(
        xt, wt, static_cast<const T*>(nb), out, B, D, depth);
  else
    tree_router_kernel<T, false><<<grid, kWarps * 32, smem, s>>>(
        xt, wt, static_cast<const T*>(nb), out, B, D, depth);
}

}  // namespace

// x (B, D), nw (N, D), nb (N,) of one dtype, N = 2^depth - 1 with
// 1 <= depth <= 8; out (B,) int32.  Returns cudaGetLastError().
extern "C" int tree_router(const void* x, const void* nw, const void* nb,
                           int* out, int B, int D, int depth, int dtype,
                           int device, void* stream) {
  if (const cudaError_t err = cudaSetDevice(device)) return static_cast<int>(err);
  if (B < 1 || D < 1 || depth < 1 || depth > 8) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == fff::kF32)
    launch<float>(x, nw, nb, out, B, D, depth, s);
  else if (dtype == fff::kBF16)
    launch<__nv_bfloat16>(x, nw, nb, out, B, D, depth, s);
  else
    return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}
