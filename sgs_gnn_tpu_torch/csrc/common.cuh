// Shared helpers for the port's kernels: element type conversion, the
// counter-based dropout hash, and the plain C error reporting every entry
// point uses.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sgs {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
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

// murmur3's 32-bit finalizer: a bijection on 32-bit words with full
// avalanche.
__host__ __device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// Dropout bits of unit `counter` under `seed`. The counter of hidden unit k
// of edge slot e is e * K + k, with e the slot's position in the call's
// edge list, so no block size enters the mask. ops/dropout.py holds the
// torch twin (hash32_plain); tests hold both to one table of values.
__host__ __device__ __forceinline__ uint32_t hash32(uint32_t seed,
                                                    unsigned long long counter) {
  const uint32_t inner = fmix32(
      seed ^ 0x243F6A88u ^
      (static_cast<uint32_t>(counter >> 32) * 0x9E3779B9u));
  return fmix32(static_cast<uint32_t>(counter) ^ inner);
}

inline int ceil_div_ll(long long a, long long b) {
  return static_cast<int>((a + b - 1) / b);
}

// streaming multiprocessors of the current device
inline int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

}  // namespace sgs
