// Row access for the warp-per-item-range kernels (scatter_sorted.cu,
// spmm.cu): a warp's 32 lanes cover kRowTile columns of one row, kRowPerLane
// columns (f32 accumulators) each. Where the row layout allows (feat a
// multiple of 16 / sizeof(T) and 16-byte aligned base pointers), a lane
// reads its columns with 16-byte loads; otherwise element by element.
#pragma once

#include "common.cuh"

namespace sgs {

constexpr int kRowPerLane = 8;                  // columns per lane
constexpr int kRowTile = 32 * kRowPerLane;      // columns per warp

// Elements of one 16-byte load.
template <typename T>
struct Vec {
  static constexpr int kLen = 16 / sizeof(T);
};

__device__ __forceinline__ void load16(const float* p, float* dst) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* dst) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    dst[2 * k] = f.x;
    dst[2 * k + 1] = f.y;
  }
}

// Column of accumulator a of this lane. Vector layout: load j of a lane
// covers V consecutive columns from (j * 32 + lane) * V; element layout:
// column a * 32 + lane.
template <typename T, bool kVec>
__device__ __forceinline__ int row_column(int tile0, int lane, int a) {
  if constexpr (kVec) {
    constexpr int V = Vec<T>::kLen;
    return tile0 + ((a / V) * 32 + lane) * V + a % V;
  } else {
    return tile0 + a * 32 + lane;
  }
}

// This lane's columns of one row as f32 (0 past feat).
template <typename T, bool kVec>
__device__ __forceinline__ void load_row(const T* __restrict__ row, int feat,
                                         int tile0, int lane,
                                         float (&dst)[kRowPerLane]) {
  if constexpr (kVec) {
    constexpr int V = Vec<T>::kLen;
#pragma unroll
    for (int j = 0; j < kRowPerLane / V; ++j) {
      const int c = row_column<T, kVec>(tile0, lane, j * V);
      if (c < feat) {
        load16(row + c, dst + j * V);
      } else {
#pragma unroll
        for (int t = 0; t < V; ++t) dst[j * V + t] = 0.f;
      }
    }
  } else {
#pragma unroll
    for (int a = 0; a < kRowPerLane; ++a) {
      const int c = row_column<T, kVec>(tile0, lane, a);
      dst[a] = c < feat ? to_float(row[c]) : 0.f;
    }
  }
}

__device__ __forceinline__ void zero_row(float (&acc)[kRowPerLane]) {
#pragma unroll
  for (int a = 0; a < kRowPerLane; ++a) acc[a] = 0.f;
}

// Writes a run's sums into the f32 output row: with atomics when other
// warps may add to the same row (`shared`), else a plain store. In the
// vector layout (feat % V == 0 keeps out rows 16-byte aligned) both go 16
// bytes at a time: Hopper's float4 atomicAdd makes a warp's atomics cover
// contiguous 512-byte spans, where scalar atomics from this layout would
// touch 32 sectors per instruction (PERF.md; tools/tune_row_kernels.py
// times both).
template <typename T, bool kVec>
__device__ __forceinline__ void write_row(const float (&acc)[kRowPerLane],
                                          float* __restrict__ row, bool shared,
                                          int feat, int tile0, int lane) {
  if constexpr (kVec) {
    constexpr int V = Vec<T>::kLen;
#pragma unroll
    for (int j = 0; j < kRowPerLane / V; ++j) {
      const int c = row_column<T, kVec>(tile0, lane, j * V);
      if (c >= feat) continue;
#pragma unroll
      for (int t = 0; t < V; t += 4) {
        const float4 v = make_float4(acc[j * V + t], acc[j * V + t + 1],
                                     acc[j * V + t + 2], acc[j * V + t + 3]);
        float4* p = reinterpret_cast<float4*>(row + c + t);
        if (shared) {
          atomicAdd(p, v);
        } else {
          *p = v;
        }
      }
    }
  } else {
#pragma unroll
    for (int a = 0; a < kRowPerLane; ++a) {
      const int c = row_column<T, kVec>(tile0, lane, a);
      if (c >= feat) continue;
      if (shared) {
        atomicAdd(row + c, acc[a]);
      } else {
        row[c] = acc[a];
      }
    }
  }
}

// Adds a run's sums into the f32 output row with one atomic per column,
// for kernels that flush often. In the vector layout the sums pass through
// `stage` (kRowTile floats of shared memory for this warp) so that lane l
// adds columns l, 32 + l, ...: each atomic instruction covers 128
// contiguous bytes. Where every edge flushes (K8 on unsorted receivers)
// this beats the float4 atomics of write_row (PERF.md).
template <typename T, bool kVec>
__device__ __forceinline__ void add_row_staged(
    const float (&acc)[kRowPerLane], float* __restrict__ row,
    float* __restrict__ stage, int feat, int tile0, int lane) {
  if constexpr (kVec) {
#pragma unroll
    for (int a = 0; a < kRowPerLane; ++a) {
      stage[row_column<T, kVec>(0, lane, a)] = acc[a];
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kRowPerLane; ++j) {
      const int c = tile0 + j * 32 + lane;
      if (c < feat) atomicAdd(row + c, stage[j * 32 + lane]);
    }
    __syncwarp();
  } else {  // the element layout's atomics are coalesced already
    write_row<T, kVec>(acc, row, true, feat, tile0, lane);
  }
}

// Whether the vector layout applies to rows of `feat` elements of T at
// `base` with f32 output rows at `out`.
template <typename T>
inline bool vector_rows(int feat, const void* base, const void* out) {
  return feat % Vec<T>::kLen == 0 &&
         reinterpret_cast<unsigned long long>(base) % 16 == 0 &&
         reinterpret_cast<unsigned long long>(out) % 16 == 0;
}

}  // namespace sgs
