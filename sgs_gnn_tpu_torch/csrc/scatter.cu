// scatter_add: out[ids[i], :] += vals[i, :], f32 accumulation.
//
// Replaces sgs_gnn_tpu/ops/scatter_pallas.py:_scatter_kernel (behind
// scatter_add_pallas). The TPU kernel built an (N, B) one-hot panel per block
// of edges and accumulated onehot @ vals on the MXU, because the TPU has no
// fast dynamic scatter. Here each warp walks a chunk of consecutive edges
// with its lanes across the feature columns and adds rows straight into the
// output with f32 atomics.
//
// Bound: bytes (E*F*itemsize in, 4E ids, 4NF out); ~0.16 ms for E=1M, F=256
// bf16 at 3.35 TB/s. The risk is atomic traffic on few rows (N=2048): a warp
// keeps a running sum in registers while consecutive edges share an id and
// issues one atomic per run, so a receiver-sorted edge list costs about one
// flush per chunk instead of one per edge. Any id order stays correct; ids
// outside [0, N) are dropped.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;              // warps per block
constexpr int kPerLane = 8;            // columns per lane
constexpr int kColTile = 32 * kPerLane;  // columns per block (gridDim.y tiles)
constexpr int kEdgesPerWarp = 32;

// Adds one run's register sums into out[cur, :] (dropped if cur is out of
// range, which also covers the initial empty run, cur = -1).
__device__ __forceinline__ void flush_run(const float (&acc)[kPerLane],
                                          int cur, float* __restrict__ out,
                                          int feat, int num_segments, int f0) {
  if (cur < 0 || cur >= num_segments) return;
  float* row = out + static_cast<long long>(cur) * feat;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int f = f0 + 32 * j;
    if (f < feat) atomicAdd(row + f, acc[j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
scatter_add_kernel(const T* __restrict__ vals, const int* __restrict__ ids,
                   float* __restrict__ out, long long num_items, int feat,
                   int num_segments) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long e0 =
      (static_cast<long long>(blockIdx.x) * kWarps + warp) * kEdgesPerWarp;
  if (e0 >= num_items) return;
  const long long e1 = min(e0 + kEdgesPerWarp, num_items);
  const int f0 = blockIdx.y * kColTile + lane;

  float acc[kPerLane];
  int cur = -1;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) acc[j] = 0.f;

  for (long long e = e0; e < e1; ++e) {
    const int id = __ldg(ids + e);
    if (id != cur) {
      flush_run(acc, cur, out, feat, num_segments, f0);
      cur = id;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) acc[j] = 0.f;
    }
    const T* row = vals + e * feat;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int f = f0 + 32 * j;
      if (f < feat) acc[j] += sgs::to_float(row[f]);
    }
  }
  flush_run(acc, cur, out, feat, num_segments, f0);
}

}  // namespace

extern "C" int sgs_scatter_add(const void* vals, int vals_bf16,
                               const void* ids, void* out,
                               long long num_items, int feat,
                               int num_segments, void* stream) {
  const dim3 grid(sgs::ceil_div_ll(num_items, kWarps * kEdgesPerWarp),
                  sgs::ceil_div_ll(feat, kColTile));
  const dim3 block(kWarps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vals_bf16) {
    scatter_add_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(vals), static_cast<const int*>(ids),
        static_cast<float*>(out), num_items, feat, num_segments);
  } else {
    scatter_add_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(vals), static_cast<const int*>(ids),
        static_cast<float*>(out), num_items, feat, num_segments);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sgs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
