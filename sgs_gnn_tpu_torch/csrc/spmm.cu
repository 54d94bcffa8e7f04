// spmm_fused: y[r] = sum over edges e with receivers[e] == r of
// w[e] * x[senders[e]], f32 accumulation, in one pass.
//
// Replaces sgs_gnn_tpu/ops/spmm_pallas.py:_spmm_kernel (:42, behind
// _spmm_pallas_impl). The TPU kernel gathered x[senders] as a one-hot
// (B, N) @ (N, F) matmul with the weights folded into the one-hot rows and
// scattered into the receivers with a second one-hot matmul, so no (E, F)
// message matrix reached HBM. Its arithmetic: the weight is rounded to x's
// type, each product w * x[s] is formed in f32 (exact for bf16 x), the sum is
// f32. Senders or receivers outside [0, N) contribute nothing.
//
// Bound: operations by this repository's count (2EF f32 products and sums
// at 67 TFLOP/s: 7.6 us for E=1M, F=256), since x (1 MB at N=2048, F=256
// bf16) and the output stay in L2 and HBM sees only the edge lists. What
// holds a simple kernel is the L2 traffic of the row gathers, E*F*itemsize
// (512 MB at E=1M, F=256 bf16). Design: each warp owns kEdgesPerWarp
// consecutive edges, its lanes across 256 columns (rows.cuh: 16-byte loads
// where the layout allows), kUnroll rows gathered ahead; it sums runs of
// equal receivers in registers and adds each run into the output with one
// f32 atomic per column, staged through shared memory so that each atomic
// instruction covers contiguous bytes (rows.cuh add_row_staged). Any
// receiver order is correct: the backward calls it on the reversed edge
// list, whose receivers (the forward's senders) are not sorted, so nearly
// every edge flushes there.
#include "rows.cuh"

namespace {

constexpr int kWarps = 8;                  // warps per block
constexpr int kEdgesPerWarp = 64;
constexpr int kUnroll = 4;                 // rows in flight per warp

template <typename T, bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
spmm_kernel(const int* __restrict__ senders, const int* __restrict__ receivers,
            const float* __restrict__ weights, const T* __restrict__ x,
            float* __restrict__ out, long long num_edges, int num_nodes,
            int feat) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long e0 =
      (static_cast<long long>(blockIdx.x) * kWarps + warp) * kEdgesPerWarp;
  if (e0 >= num_edges) return;
  const long long e1 = min(e0 + kEdgesPerWarp, num_edges);
  const int tile0 = blockIdx.y * sgs::kRowTile;
  __shared__ float stage[kWarps][sgs::kRowTile];

  float acc[sgs::kRowPerLane];
  sgs::zero_row(acc);
  int cur = -1;  // receiver of the open run; -1: none

  for (long long e = e0; e < e1; e += kUnroll) {
    int r[kUnroll];
    float w[kUnroll];
    float rows[kUnroll][sgs::kRowPerLane];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      r[u] = -1;
      if (e + u < e1) {
        const int s = __ldg(senders + e + u);
        const int rr = __ldg(receivers + e + u);
        if (s >= 0 && s < num_nodes && rr >= 0 && rr < num_nodes) {
          r[u] = rr;
          w[u] = sgs::round_as<T>(__ldg(weights + e + u));
          sgs::load_row<T, kVec>(x + static_cast<long long>(s) * feat, feat,
                                 tile0, lane, rows[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r[u] < 0) continue;  // past the range, or an endpoint out of range
      if (r[u] != cur) {
        if (cur >= 0) {
          sgs::add_row_staged<T, kVec>(
              acc, out + static_cast<long long>(cur) * feat, stage[warp], feat,
              tile0, lane);
        }
        cur = r[u];
        sgs::zero_row(acc);
      }
#pragma unroll
      for (int a = 0; a < sgs::kRowPerLane; ++a) acc[a] += w[u] * rows[u][a];
    }
  }
  if (cur >= 0) {
    sgs::add_row_staged<T, kVec>(acc, out + static_cast<long long>(cur) * feat,
                                 stage[warp], feat, tile0, lane);
  }
}

template <typename T>
void launch(const void* senders, const void* receivers, const void* weights,
            const void* x, void* out, long long num_edges, int num_nodes,
            int feat, cudaStream_t s) {
  const dim3 grid(sgs::ceil_div_ll(num_edges, kWarps * kEdgesPerWarp),
                  sgs::ceil_div_ll(feat, sgs::kRowTile));
  const dim3 block(kWarps * 32);
  const int* sp = static_cast<const int*>(senders);
  const int* rp = static_cast<const int*>(receivers);
  const float* wp = static_cast<const float*>(weights);
  const T* xp = static_cast<const T*>(x);
  float* o = static_cast<float*>(out);
  if (sgs::vector_rows<T>(feat, x, out)) {
    spmm_kernel<T, true><<<grid, block, 0, s>>>(sp, rp, wp, xp, o, num_edges,
                                                num_nodes, feat);
  } else {
    spmm_kernel<T, false><<<grid, block, 0, s>>>(sp, rp, wp, xp, o, num_edges,
                                                 num_nodes, feat);
  }
}

}  // namespace

// x: (num_nodes, feat) bf16 or f32; weights: (num_edges,) f32; out:
// (num_nodes, feat) f32, zeroed by the caller.
extern "C" int sgs_spmm_fused(const void* senders, const void* receivers,
                              const void* weights, const void* x, int x_bf16,
                              void* out, long long num_edges, int num_nodes,
                              int feat, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    launch<__nv_bfloat16>(senders, receivers, weights, x, out, num_edges,
                          num_nodes, feat, s);
  } else {
    launch<float>(senders, receivers, weights, x, out, num_edges, num_nodes,
                  feat, s);
  }
  return static_cast<int>(cudaGetLastError());
}
