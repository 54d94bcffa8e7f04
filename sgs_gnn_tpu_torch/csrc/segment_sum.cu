// segment_sum_scalar: deg[ids[i]] += w[i], f32.
//
// Replaces sgs_gnn_tpu/ops/scatter_pallas.py:_scalar_kernel (behind
// _segment_sum_scalar_pallas), which multiplied a bf16 one-hot panel by the
// weights on the MXU and so rounded w to bf16; this kernel keeps f32.
//
// Bound: bytes (8E: ids and weights read once; ~2.4 us at E=1M). Each block
// walks a grid-stride share of the items and accumulates a private histogram
// of all N nodes in shared memory, then adds each touched node into the
// output with one global atomic: the output sees (blocks x touched nodes)
// atomics instead of E. Where N is too large for the shared histogram
// (kSmemNodes), items go straight to global atomics. Ids outside [0, N) are
// dropped.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSmemNodes = 12288;   // 48 KB of f32: no opt-in attribute needed
constexpr int kItemsPerThread = 16;
constexpr int kMaxBlocks = 1024;

__global__ void __launch_bounds__(kThreads)
segment_sum_smem_kernel(const float* __restrict__ w, const int* __restrict__ ids,
                        float* __restrict__ out, long long num_items,
                        int num_segments) {
  extern __shared__ float hist[];
  for (int n = threadIdx.x; n < num_segments; n += blockDim.x) hist[n] = 0.f;
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < num_items; i += stride) {
    const int id = __ldg(ids + i);
    if (id >= 0 && id < num_segments) atomicAdd(hist + id, __ldg(w + i));
  }
  __syncthreads();
  for (int n = threadIdx.x; n < num_segments; n += blockDim.x) {
    const float v = hist[n];
    if (v != 0.f) atomicAdd(out + n, v);
  }
}

__global__ void __launch_bounds__(kThreads)
segment_sum_global_kernel(const float* __restrict__ w,
                          const int* __restrict__ ids, float* __restrict__ out,
                          long long num_items, int num_segments) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < num_items; i += stride) {
    const int id = __ldg(ids + i);
    if (id >= 0 && id < num_segments) atomicAdd(out + id, __ldg(w + i));
  }
}

}  // namespace

extern "C" int sgs_segment_sum_scalar(const void* w, const void* ids,
                                      void* out, long long num_items,
                                      int num_segments, void* stream) {
  int blocks = sgs::ceil_div_ll(num_items, kThreads * kItemsPerThread);
  blocks = blocks < kMaxBlocks ? blocks : kMaxBlocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wp = static_cast<const float*>(w);
  const int* ip = static_cast<const int*>(ids);
  float* op = static_cast<float*>(out);
  if (num_segments <= kSmemNodes) {
    const size_t smem = static_cast<size_t>(num_segments) * sizeof(float);
    segment_sum_smem_kernel<<<blocks, kThreads, smem, s>>>(
        wp, ip, op, num_items, num_segments);
  } else {
    segment_sum_global_kernel<<<blocks, kThreads, 0, s>>>(
        wp, ip, op, num_items, num_segments);
  }
  return static_cast<int>(cudaGetLastError());
}
