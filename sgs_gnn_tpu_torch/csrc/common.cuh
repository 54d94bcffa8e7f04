// Shared helpers for the port's kernels: element type conversion and the
// plain C error reporting every entry point uses.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sgs {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Round an f32 result to T's precision and back: an elementwise op on T
// tensors (PyTorch and JAX alike) computes in f32 and stores T.
template <typename T>
__device__ __forceinline__ float round_as(float x);
template <>
__device__ __forceinline__ float round_as<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_as<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

inline int ceil_div_ll(long long a, long long b) {
  return static_cast<int>((a + b - 1) / b);
}

}  // namespace sgs
