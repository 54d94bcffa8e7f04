// segment_sum_scalar: deg[ids[i]] += w[i], f32.
//
// Replaces sgs_gnn_tpu/ops/scatter_pallas.py:_scalar_kernel (behind
// _segment_sum_scalar_pallas), which multiplied a bf16 one-hot panel by the
// weights on the MXU and so rounded w to bf16; this kernel keeps f32.
//
// Bound: bytes (8E: ids and weights read once; ~2.4 us at E=1M), close to
// the floor of any launch. What cost the time was atomics: on sorted ids the
// 32 lanes of a warp hit one address at once, and blocks that strode across
// the whole array each flushed nearly every node. Design:
// - each block owns a contiguous range of items (items_per_block, from
//   ops/scatter.py segment_plan), so on sorted ids it touches a few nodes;
// - a warp reads 32 consecutive items per step and sums runs of equal ids
//   with a segmented shuffle scan (head flags from the neighbour's id); the
//   last lane of each run adds the run's sum once;
// - "shared" route (N <= kSmemNodes): those adds go into the block's
//   histogram in shared memory, and the block flushes only the nodes in the
//   id range it touched, skipping zeros; "global" route (larger N): the run
//   sums go straight to global atomics.
// Ids outside [0, N) are dropped.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 4;          // 32-item steps whose loads a warp issues
constexpr int kSmemNodes = 12288;   // 48 KB of f32 (+8 bytes: opted in)
constexpr unsigned kFull = 0xffffffffu;

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const float* __restrict__ w, const int* __restrict__ ids,
                   float* __restrict__ out, long long num_items,
                   int num_segments, long long items_per_block) {
  extern __shared__ float hist[];
  __shared__ int range[2];  // lowest and highest node this block touched
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const long long b0 = static_cast<long long>(blockIdx.x) * items_per_block;
  const long long b1 = min(b0 + items_per_block, num_items);
  if (kShared) {
    for (int n = threadIdx.x; n < num_segments; n += blockDim.x) hist[n] = 0.f;
    if (threadIdx.x == 0) {
      range[0] = INT_MAX;
      range[1] = -1;
    }
    __syncthreads();
  }
  float* dst = kShared ? hist : out;
  int lo = INT_MAX, hi = -1;

  const long long step = static_cast<long long>(warps) * 32;
  for (long long t = b0 + warp * 32; t < b1; t += step * kUnroll) {
    int id[kUnroll];
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long e = t + u * step + lane;
      id[u] = e < b1 ? __ldg(ids + e) : -1;
      v[u] = e < b1 ? __ldg(w + e) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t + u * step >= b1) break;  // uniform across the warp
      const int prev = __shfl_up_sync(kFull, id[u], 1);
      const int next = __shfl_down_sync(kFull, id[u], 1);
      const unsigned heads =
          __ballot_sync(kFull, lane == 0 || prev != id[u]);
      // first lane of this lane's run: the highest head at or below it
      const int start = 31 - __clz(heads & (kFull >> (31 - lane)));
      float sum = v[u];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const float o = __shfl_up_sync(kFull, sum, d);
        if (lane - d >= start) sum += o;
      }
      const bool tail = lane == 31 || next != id[u];
      if (tail && id[u] >= 0 && id[u] < num_segments) {
        atomicAdd(dst + id[u], sum);
        lo = min(lo, id[u]);
        hi = max(hi, id[u]);
      }
    }
  }
  if (!kShared) return;

  if (hi >= 0) {
    atomicMin(range, lo);
    atomicMax(range + 1, hi);
  }
  __syncthreads();
  // a block whose items are all out of range keeps (INT_MAX, -1): nothing
  // to flush (int arithmetic: range[0] + threadIdx.x would be unsigned)
  const int first = range[0], last = range[1];
  if (last < 0) return;
  for (int n = first + static_cast<int>(threadIdx.x); n <= last;
       n += static_cast<int>(blockDim.x)) {
    const float s = hist[n];
    if (s != 0.f) atomicAdd(out + n, s);
  }
}

}  // namespace

// items_per_block: the contiguous items of one block (gridDim.x =
// ceil(E / items_per_block)), from ops/scatter.py segment_plan; the route
// follows N.
extern "C" int sgs_segment_sum_scalar(const void* w, const void* ids,
                                      void* out, long long num_items,
                                      int num_segments,
                                      long long items_per_block,
                                      void* stream) {
  if (items_per_block <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = sgs::ceil_div_ll(num_items, items_per_block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wp = static_cast<const float*>(w);
  const int* ip = static_cast<const int*>(ids);
  float* op = static_cast<float*>(out);
  if (num_segments <= kSmemNodes) {
    static bool opted_in = false;  // 48 KB dynamic + the static range
    if (!opted_in) {
      const cudaError_t err = cudaFuncSetAttribute(
          segment_sum_kernel<true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          kSmemNodes * static_cast<int>(sizeof(float)));
      if (err != cudaSuccess) return static_cast<int>(err);
      opted_in = true;
    }
    const size_t smem = static_cast<size_t>(num_segments) * sizeof(float);
    segment_sum_kernel<true><<<blocks, kThreads, smem, s>>>(
        wp, ip, op, num_items, num_segments, items_per_block);
  } else {
    segment_sum_kernel<false><<<blocks, kThreads, 0, s>>>(
        wp, ip, op, num_items, num_segments, items_per_block);
  }
  return static_cast<int>(cudaGetLastError());
}
