// scatter_add_sorted: out[ids[i], :] += vals[i, :] over non-decreasing ids,
// f32 accumulation, with the band rule of the TPU kernel.
//
// Replaces sgs_gnn_tpu/ops/scatter_pallas.py:_make_sorted_kernel (:109,
// behind scatter_add_sorted_pallas). The TPU kernel built a (band, 1024)
// one-hot panel per window of 1024 items and added panel @ vals into a
// band-row slice of the output, because the TPU has no fast dynamic
// scatter. That panel defines what the kernel adds: item i of window w
// counts iff 0 <= ids[i] - start_w < band and ids[i] < num_segments, with
// start_w = min(floor(ids[w*window] / 8) * 8, n_pad - band). This kernel
// applies the same predicate per item (ops/scatter.py sorted_band_keep is
// its plain twin); negative ids are dropped.
//
// Bound: bytes (E*F*itemsize in, 4E ids, 4NF out): ~0.155 ms for E=1M,
// F=256 bf16 at 3.35 TB/s. Design: a segmented reduction over the sorted
// ids. Each warp owns kItemsPerWarp consecutive items, its lanes across 256
// columns (rows.cuh: 16-byte loads where the layout allows). A warp sums
// each run of equal ids in registers. A run whose id does not appear just
// outside the warp's range belongs to this warp alone (the ids are sorted)
// and is stored straight into the zeroed output; only a run that crosses
// the range's boundary takes f32 atomics (16 bytes at a time). Longer
// ranges cross fewer boundaries; loading rows ahead did not pay
// (tools/tune_row_kernels.py). The ids must be non-decreasing, as the TPU
// kernel requires.
#include "rows.cuh"

namespace {

constexpr int kWarps = 8;                  // warps per block
constexpr int kItemsPerWarp = 128;

template <typename T, bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
scatter_sorted_kernel(const T* __restrict__ vals, const int* __restrict__ ids,
                      float* __restrict__ out, long long num_items, int feat,
                      int num_segments, int band, int n_pad, int window) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long e0 =
      (static_cast<long long>(blockIdx.x) * kWarps + warp) * kItemsPerWarp;
  if (e0 >= num_items) return;
  const long long e1 = min(e0 + kItemsPerWarp, num_items);
  const int tile0 = blockIdx.y * sgs::kRowTile;
  // ids just outside the range: a run of either may continue there
  const int before = e0 > 0 ? __ldg(ids + e0 - 1) : -1;
  const int after = e1 < num_items ? __ldg(ids + e1) : -1;

  float acc[sgs::kRowPerLane];
  sgs::zero_row(acc);
  int cur = -1;            // id of the open run; -1: none
  long long win_end = -1;  // first item past the current window
  long long start = 0;     // the current window's band origin

  for (long long i = e0; i < e1; ++i) {
    if (i >= win_end) {
      const long long w0 = i / window * window;
      win_end = w0 + window;
      const long long first = __ldg(ids + w0);
      const long long floor8 = (first >= 0 ? first : first - 7) / 8 * 8;
      start = min(floor8, static_cast<long long>(n_pad - band));
    }
    const int id = __ldg(ids + i);
    const long long lid = id - start;
    if (id < 0 || id >= num_segments || lid < 0 || lid >= band) {
      continue;  // dropped, as the TPU kernel's band panel drops it
    }
    if (id != cur) {
      if (cur >= 0) {
        sgs::write_row<T, kVec>(acc, out + static_cast<long long>(cur) * feat,
                                cur == before || cur == after, feat, tile0,
                                lane);
      }
      cur = id;
      sgs::zero_row(acc);
    }
    float row[sgs::kRowPerLane];
    sgs::load_row<T, kVec>(vals + i * feat, feat, tile0, lane, row);
#pragma unroll
    for (int a = 0; a < sgs::kRowPerLane; ++a) acc[a] += row[a];
  }
  if (cur >= 0) {
    sgs::write_row<T, kVec>(acc, out + static_cast<long long>(cur) * feat,
                            cur == before || cur == after, feat, tile0, lane);
  }
}

template <typename T>
void launch(const void* vals, const void* ids, void* out, long long num_items,
            int feat, int num_segments, int band, int n_pad, int window,
            cudaStream_t s) {
  const dim3 grid(sgs::ceil_div_ll(num_items, kWarps * kItemsPerWarp),
                  sgs::ceil_div_ll(feat, sgs::kRowTile));
  const dim3 block(kWarps * 32);
  const T* v = static_cast<const T*>(vals);
  const int* i = static_cast<const int*>(ids);
  float* o = static_cast<float*>(out);
  if (sgs::vector_rows<T>(feat, vals, out)) {
    scatter_sorted_kernel<T, true><<<grid, block, 0, s>>>(
        v, i, o, num_items, feat, num_segments, band, n_pad, window);
  } else {
    scatter_sorted_kernel<T, false><<<grid, block, 0, s>>>(
        v, i, o, num_items, feat, num_segments, band, n_pad, window);
  }
}

}  // namespace

// band: a multiple of 8; n_pad = round_up(max(N, 8), 8) + band; window: the
// TPU kernel's block (items per band window).
extern "C" int sgs_scatter_add_sorted(const void* vals, int vals_bf16,
                                      const void* ids, void* out,
                                      long long num_items, int feat,
                                      int num_segments, int band, int n_pad,
                                      int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vals_bf16) {
    launch<__nv_bfloat16>(vals, ids, out, num_items, feat, num_segments, band,
                          n_pad, window, s);
  } else {
    launch<float>(vals, ids, out, num_items, feat, num_segments, band, n_pad,
                  window, s);
  }
  return static_cast<int>(cudaGetLastError());
}
