// Shared device helpers for the FFF kernels: float conversion of the two
// element types the kernels take (float, bf16), the activations, warp
// reduction, and the error-string export every library carries.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace fff {

// dtype codes (kernels/common.py DTYPE_CODES)
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

// activation codes (kernels/common.py ACT_CODES)
constexpr int kActNone = 0;
constexpr int kActRelu = 1;
constexpr int kActGelu = 2;  // tanh approximation, as jax.nn.gelu
constexpr int kActSilu = 3;
constexpr int kActSwiglu = 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// round through the element type (what storing h in T and reloading does)
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// elements of T in one 16-byte load (8 bf16, 4 f32)
template <typename T> constexpr int kVec = 16 / sizeof(T);

// V consecutive elements of T as floats: one 16-byte load when V is a
// whole vector (p must then be 16-byte aligned), else element by element
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  if constexpr (V == kVec<T>) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    if constexpr (sizeof(T) == 4) {
      const float* f = reinterpret_cast<const float*>(&v);
#pragma unroll
      for (int i = 0; i < V; ++i) out[i] = f[i];
    } else {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int i = 0; i < V / 2; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        out[2 * i] = f.x;
        out[2 * i + 1] = f.y;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = to_f32(p[i]);
  }
}

__device__ __forceinline__ float silu(float v) { return v / (1.0f + __expf(-v)); }

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case kActRelu: return fmaxf(v, 0.0f);
    case kActGelu: {
      const float k = 0.7978845608028654f;  // sqrt(2/pi)
      return 0.5f * v * (1.0f + tanhf(k * (v + 0.044715f * v * v * v)));
    }
    case kActSilu: return silu(v);
    default: return v;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace fff

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
