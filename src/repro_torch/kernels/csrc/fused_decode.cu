// The whole FFF decode forward in one launch: for every token and tree,
// node logits, the hard descent, only the routed leaf's MLP (plain or
// SwiGLU), the forest combine in f32, and the optional always-on master
// leaf.
//
// Replaces repro/kernels/fused_decode/kernel.py::fused_forest_decode (the
// Pallas TPU megakernel, body _fused_decode_kernel).
//
// Bound on the H100: bytes.  A decode token reads its routed leaf's weight
// slabs, 3 * 6144 * 1024 bf16 = 37.7 MB per SwiGLU leaf at internlm2-20b
// width, for 2 * 3 * 6144 * 1024 operations: one operation per byte.  The
// least traffic is the distinct routed leaves plus the node hyperplanes.
// Design: the TPU kernel's grid of one step per token would occupy 8 of
// 132 SMs at decode batch 8, so the leaf's hidden width is split across
// blocks instead: block (s, b) owns 32 hidden units of token b's leaf in
// one tree (or of the master leaf).  Each block
//   1. stages the token row in shared memory as f32;
//   2. recomputes that tree's N node logits (15 x 6144 multiply-adds, one
//      warp per node, 16-byte reads, shuffle-reduced) and descends — ties go right — so
//      the routed leaf index is the offset of its weight loads, the
//      paper's "conditionality is an offset in the data load";
//   3. computes its 32 hidden units (threads over units and rows of D,
//      16-byte coalesced reads of the (D, l) slab where the shapes allow),
//      applies the activation and rounds h to the element type, as the
//      Pallas kernel does;
//   4. multiplies them into the matching 32 rows of the (l, O) down slab
//      (threads over O, 16-byte reads) and stores its partial output, in
//      f32, into a slot of its own: slot s of token b, part[s][b][:].
// The last block to finish a token (a per-token arrival counter, the only
// atomic) sums that token's slots in slot order, 0 to S - 1 (S = gridDim.x:
// trees x ceil(l/32) + ceil(mw/32)), with all its threads over O and
// 16-byte loads from L2, and rounds to the output type once; so the launch
// is the only one, and the sum takes the same order on every run: the
// outputs are bit-identical from call to call.
#include "common.cuh"

namespace {

constexpr int kHS = 32;      // hidden units per block (one per lane)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// V = 1 reads the weights element by element (any shape); V = 16 bytes'
// worth (8 bf16, 4 f32) needs D, l, mw and O divisible by V and 16-byte
// aligned weights, and cuts the load instructions by V.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
fused_decode_kernel(const T* __restrict__ x, const T* __restrict__ nw,
                    const T* __restrict__ nb, const T* __restrict__ w1,
                    const T* __restrict__ w3, const T* __restrict__ w2,
                    const T* __restrict__ m1, const T* __restrict__ m3,
                    const T* __restrict__ m2, T* __restrict__ y,
                    float* __restrict__ part, int* __restrict__ counter,
                    int* __restrict__ leaf_idx, int D, int T_, int depth,
                    int E, int l, int O, int mw, int act) {
  constexpr int kTpr = kHS / V;           // threads across one row's 32 units
  constexpr int kRows = kThreads / kTpr;  // weight rows read at once
  extern __shared__ float smem[];
  const int N = (1 << depth) - 1;
  float* xs = smem;                        // [D]
  float* logits = xs + D;                  // [N]
  float* part1 = logits + N;               // [kRows][kHS]
  float* part3 = part1 + kRows * kHS;      // [kRows][kHS]
  float* hs = part3 + kRows * kHS;         // [kHS]
  __shared__ int s_idx;
  __shared__ bool s_last;

  const int b = blockIdx.y, s = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bool dual = act == fff::kActSwiglu;
  const int slices = (l + kHS - 1) / kHS;
  const bool master = s >= T_ * slices;

  const T* xr = x + static_cast<size_t>(b) * D;
  for (int d = tid; d < D; d += kThreads) xs[d] = fff::to_f32(xr[d]);
  __syncthreads();

  const T *up, *up3, *down;
  int width, j0;
  if (!master) {
    const int t = s / slices;
    j0 = (s % slices) * kHS;
    const T* nwt = nw + static_cast<size_t>(t) * N * D;
    for (int n = warp; n < N; n += kWarps) {
      float acc = 0.0f, wn[V];
      for (int d = lane * V; d < D; d += 32 * V) {
        fff::load_vec<T, V>(nwt + static_cast<size_t>(n) * D + d, wn);
#pragma unroll
        for (int v = 0; v < V; ++v) acc += xs[d + v] * wn[v];
      }
      acc = fff::warp_sum(acc);
      if (lane == 0) logits[n] = acc + fff::to_f32(nb[t * N + n]);
    }
    __syncthreads();
    if (tid == 0) {
      int idx = 0, off = 0;
      for (int m = 0; m < depth; ++m) {
        idx = 2 * idx + (logits[off + idx] >= 0.0f ? 1 : 0);
        off += 1 << m;
      }
      s_idx = idx;
      if (j0 == 0) leaf_idx[b * T_ + t] = idx;
    }
    __syncthreads();
    const size_t leaf = static_cast<size_t>(t) * E + s_idx;
    up = w1 + leaf * D * l;
    up3 = dual ? w3 + leaf * D * l : nullptr;
    down = w2 + leaf * l * O;
    width = l;
  } else {
    j0 = (s - T_ * slices) * kHS;
    up = m1;
    up3 = m3;
    down = m2;
    width = mw;
  }

  // hidden units j0 .. j0+31: each thread owns V of them and strides over
  // the rows of D with kRows - 1 other row groups
  const int u0 = (tid % kTpr) * V, r0 = tid / kTpr;
  float a1[V] = {}, a3[V] = {}, w[V];
  if (j0 + u0 < width) {
#pragma unroll 4
    for (int d = r0; d < D; d += kRows) {
      const float xv = xs[d];
      const size_t off = static_cast<size_t>(d) * width + j0 + u0;
      fff::load_vec<T, V>(up + off, w);
#pragma unroll
      for (int v = 0; v < V; ++v) a1[v] += xv * w[v];
      if (dual) {
        fff::load_vec<T, V>(up3 + off, w);
#pragma unroll
        for (int v = 0; v < V; ++v) a3[v] += xv * w[v];
      }
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    part1[r0 * kHS + u0 + v] = a1[v];
    part3[r0 * kHS + u0 + v] = a3[v];
  }
  __syncthreads();
  if (tid < kHS) {
    float g = 0.0f, u = 0.0f;
    for (int r = 0; r < kRows; ++r) {
      g += part1[r * kHS + tid];
      u += part3[r * kHS + tid];
    }
    const float h = dual ? fff::silu(g) * u : fff::activate(g, act);
    hs[tid] = j0 + tid < width ? fff::round_to<T>(h) : 0.0f;
  }
  __syncthreads();

  // this slice's share of the down-projection, stored in f32 into slot s
  const int nj = min(kHS, width - j0);
  const T* dn = down + static_cast<size_t>(j0) * O;
  const int B = gridDim.y, S = gridDim.x;
  float* slot = part + (static_cast<size_t>(s) * B + b) * O;
  for (int o = tid * V; o < O; o += kThreads * V) {
    float acc[V] = {};
    for (int jj = 0; jj < nj; ++jj) {
      fff::load_vec<T, V>(dn + static_cast<size_t>(jj) * O + o, w);
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] += hs[jj] * w[v];
    }
    if constexpr (V > 1) {   // O % V == 0: whole float4s
#pragma unroll
      for (int v = 0; v < V; v += 4)
        *reinterpret_cast<float4*>(slot + o + v) =
            make_float4(acc[v], acc[v + 1], acc[v + 2], acc[v + 3]);
    } else {
      slot[o] = acc[0];
    }
  }

  // the last block of token b sums its S slots in slot order and writes
  // the output row
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&counter[b], 1) == S - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const float* col = part + static_cast<size_t>(b) * O;   // slot 0 of token b
  const size_t stride = static_cast<size_t>(B) * O;       // to the next slot
  T* yr = y + static_cast<size_t>(b) * O;
  if constexpr (V > 1) {
    for (int o = tid * 4; o < O; o += kThreads * 4) {
      float4 sum = __ldcg(reinterpret_cast<const float4*>(col + o));
#pragma unroll 8
      for (int k = 1; k < S; ++k) {
        const float4 p = __ldcg(reinterpret_cast<const float4*>(col + k * stride + o));
        sum.x += p.x;
        sum.y += p.y;
        sum.z += p.z;
        sum.w += p.w;
      }
      yr[o] = fff::from_f32<T>(sum.x);
      yr[o + 1] = fff::from_f32<T>(sum.y);
      yr[o + 2] = fff::from_f32<T>(sum.z);
      yr[o + 3] = fff::from_f32<T>(sum.w);
    }
  } else {
    for (int o = tid; o < O; o += kThreads) {
      float sum = __ldcg(col + o);
      for (int k = 1; k < S; ++k) sum += __ldcg(col + k * stride + o);
      yr[o] = fff::from_f32<T>(sum);
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
int launch(const void* x, const void* nw, const void* nb, const void* w1,
           const void* w3, const void* w2, const void* m1, const void* m3,
           const void* m2, void* y, float* part, int* counter, int* leaf_idx,
           int B, int D, int T_, int depth, int E, int l, int O, int mw,
           int act, cudaStream_t s) {
  constexpr int V = fff::kVec<T>;
  const bool vector =
      D % V == 0 && l % V == 0 && O % V == 0 && (m1 == nullptr || mw % V == 0) &&
      aligned16(nw) && aligned16(w1) && aligned16(w2) && (w3 == nullptr || aligned16(w3)) &&
      (m1 == nullptr || (aligned16(m1) && aligned16(m2) &&
                         (m3 == nullptr || aligned16(m3))));
  const int slices = (l + kHS - 1) / kHS;
  const int m_slices = m1 != nullptr ? (mw + kHS - 1) / kHS : 0;
  const dim3 grid(T_ * slices + m_slices, B);
  const int rows = vector ? kThreads / (kHS / V) : kThreads / kHS;
  const size_t smem = (D + (1 << depth) - 1 + 2 * rows * kHS + kHS) * sizeof(float);
  auto kernel = vector ? fused_decode_kernel<T, V> : fused_decode_kernel<T, 1>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(nw), static_cast<const T*>(nb),
      static_cast<const T*>(w1), static_cast<const T*>(w3), static_cast<const T*>(w2),
      static_cast<const T*>(m1), static_cast<const T*>(m3), static_cast<const T*>(m2),
      static_cast<T*>(y), part, counter, leaf_idx, D, T_, depth, E, l, O, mw, act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, D); collapsed nodes nw (T, N, D), nb (T, N); leaves w1 (T, E, D, l)
// [gate for SwiGLU], w3 (T, E, D, l) [SwiGLU up, else null],
// w2 (T, E, l, O); optional master m1/m3 (D, mw), m2 (mw, O) (null when
// absent); all one dtype.  Scratch: part (S, B, O) f32, one slot per block
// of a token, S = T * ceil(l / 32) + ceil(mw / 32) (mw = 0 without a master
// leaf), needs no fill; counter (B,) int32 must be zero.  Writes y (B, O)
// and leaf_idx (B, T) int32.
extern "C" int fused_forest_decode(const void* x, const void* nw, const void* nb,
                                   const void* w1, const void* w3, const void* w2,
                                   const void* m1, const void* m3, const void* m2,
                                   void* y, float* part, int* counter,
                                   int* leaf_idx, int B, int D, int T, int depth,
                                   int E, int l, int O, int mw, int act,
                                   int dtype, int device, void* stream) {
  if (const cudaError_t err = cudaSetDevice(device)) return static_cast<int>(err);
  if (B < 1 || D < 1 || T < 1 || depth < 1 || depth > 12 || l < 1 || O < 1 ||
      E != (1 << depth) || act < fff::kActNone || act > fff::kActSwiglu ||
      ((act == fff::kActSwiglu) != (w3 != nullptr)) ||
      (m1 != nullptr && (mw < 1 || (act == fff::kActSwiglu) != (m3 != nullptr))))
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == fff::kF32)
    return launch<float>(x, nw, nb, w1, w3, w2, m1, m3, m2, y, part, counter,
                         leaf_idx, B, D, T, depth, E, l, O, mw, act, s);
  if (dtype == fff::kBF16)
    return launch<__nv_bfloat16>(x, nw, nb, w1, w3, w2, m1, m3, m2, y, part,
                                 counter, leaf_idx, B, D, T, depth, E, l, O,
                                 mw, act, s);
  return cudaErrorInvalidValue;
}
