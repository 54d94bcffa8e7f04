// scatter_add: out[ids[i], :] += vals[i, :], f32 accumulation.
//
// Replaces sgs_gnn_tpu/ops/scatter_pallas.py:_scatter_kernel (behind
// scatter_add_pallas). The TPU kernel built an (N, B) one-hot panel per block
// of edges and accumulated onehot @ vals on the MXU, because the TPU has no
// fast dynamic scatter.
//
// Bound: bytes (E*F*itemsize in, 4E ids, 4NF out): ~0.155 ms for E=1M, F=256
// bf16 at 3.35 TB/s, ~0.031 ms for q=200k. What costs the time beyond it is
// f32 atomics into a small output (N=2048: 2 MB at F=256, held in L2): most
// ids the main path feeds are unsorted (sampled edges), where merging runs
// of equal ids saves little, and one global atomic per (edge, column) ran at
// a quarter of the bound. Two routes, picked per call by the wrapper
// (ops/scatter.py scatter_plan, a function of N, F and the value type):
//
// "slab" (an N x W f32 slab fits in shared memory): block (x, y) owns the
//   W-column slab x of all N output rows (column-major, padded so that the
//   lanes on one row hit distinct banks) and the contiguous edge chunk y.
//   Shared-memory f32 atomics are compare-and-swap loops on sm_90, so the
//   block counting-sorts each sub-chunk's ids in shared memory first.
//   Walkers of W / V lanes then take equal ranges of the sorted order; a
//   lane reads V consecutive columns of each row with one 16-byte load (V =
//   8 bf16 or 4 f32; V = 1 where rows are not 16-byte aligned, as at F=41
//   bf16), sums runs of equal ids in registers and adds a run that lies
//   inside its range without atomics. The slab blocks of one chunk run side
//   by side (x varies fastest), so a row's other sectors are still in L2
//   when their slabs read them. Each block flushes its slab once (16-byte
//   global atomics where F allows, zeros skipped): the output sees (chunks x
//   N x F) adds instead of (E x F). That is the chunk's "sort" mode. A
//   chunk whose sampled ids are non-decreasing (a receiver-sorted edge
//   list, a sorted sample) needs no slab ("rows" mode): its sibling blocks
//   split it and add runs of whole rows with float4 atomics (add_rows), a
//   few adds per warp and whole-row reads. The mode depends on the ids, so
//   the kernel counts its chunks per mode on the card (chunk_modes; read by
//   ops/scatter.py slab_chunk_modes).
// "direct" (larger N): each warp adds the runs of its range of edges with
//   add_rows.
//
// Ids outside [0, N) are dropped. Any id order is correct.
#include <cstring>

#include "rows.cuh"

namespace {

constexpr int kSlabThreads = 1024;  // threads per slab block
constexpr int kSlabUnroll = 2;      // edges whose loads a lane issues at once
constexpr int kKeyBits = 15;        // sub-chunk offset bits of a sort key
constexpr int kMaxSubItems = 1 << kKeyBits;
constexpr int kDirectWarps = 8;     // warps per direct block
constexpr int kMaxSmem = 232448;    // Hopper's opt-in shared memory per block

// Column stride of the slab (column-major, N rows): the smallest S >= N
// with S % 8 == 2, so that the lanes of one walker (columns j, j + V, ...
// of one row, V = 4 or 8) and of a scalar walker (columns 0..W-1) fall in
// distinct shared-memory banks. ops/scatter.py slab_stride is its twin.
__host__ __device__ __forceinline__ int slab_stride(int num_segments) {
  return num_segments + ((10 - num_segments % 8) % 8);
}

// Shared memory of a slab block: the slab, the sort's histogram, its keys
// and 32 ints of scan scratch (ops/scatter.py scatter_plan).
inline int slab_smem(int num_segments, int slab_cols, int sub_items) {
  return 4 * (slab_cols * slab_stride(num_segments) + num_segments +
              sub_items + 32);
}

// Whether chunk [e0, e1) looks sorted: every thread compares a sampled
// item with the next one and with the next sample. A heuristic that picks
// the chunk's mode; each mode is right for any ids, and the sibling blocks
// of one chunk read the same samples, so they all pick the same mode.
// ops/scatter.py slab_chunk_sorted is its twin.
__device__ __forceinline__ bool chunk_looks_sorted(
    const int* __restrict__ ids, long long e0, long long e1) {
  const long long span = e1 - e0;
  const long long step = max(1LL, span / blockDim.x);
  const long long p = e0 + threadIdx.x * step;
  bool descent = false;
  if (p + 1 < e1) {
    const int a = __ldg(ids + p);
    descent = a > __ldg(ids + p + 1) ||
              (p + step < e1 && a > __ldg(ids + p + step));
  }
  return !__syncthreads_or(descent);
}

// A warp adds the rows of items [a0, a1) into columns [tile0, tile0 + 256)
// of the output (rows.cuh: lanes across the columns, 16-byte loads where
// the layout allows): it sums runs of equal ids in registers and adds each
// run with float4 atomics (scalar ones in the element layout).
template <typename T, bool kVec>
__device__ void add_rows(const T* __restrict__ vals,
                         const int* __restrict__ ids, float* __restrict__ out,
                         long long a0, long long a1, int feat,
                         int num_segments, int tile0) {
  const int lane = threadIdx.x & 31;
  float acc[sgs::kRowPerLane];
  sgs::zero_row(acc);
  int cur = -1;
  for (long long e = a0; e < a1; ++e) {
    const int id = __ldg(ids + e);
    if (id != cur) {
      if (cur >= 0 && cur < num_segments) {
        sgs::write_row<T, kVec>(acc, out + static_cast<long long>(cur) * feat,
                                true, feat, tile0, lane);
      }
      cur = id;
      sgs::zero_row(acc);
    }
    float row[sgs::kRowPerLane];
    sgs::load_row<T, kVec>(vals + e * feat, feat, tile0, lane, row);
#pragma unroll
    for (int k = 0; k < sgs::kRowPerLane; ++k) acc[k] += row[k];
  }
  if (cur >= 0 && cur < num_segments) {
    sgs::write_row<T, kVec>(acc, out + static_cast<long long>(cur) * feat,
                            true, feat, tile0, lane);
  }
}

// A lane's V values of one row, kept as loaded until they are added.
template <typename T, int V>
struct Raw {
  T x[V];
};

template <typename T, int V>
__device__ __forceinline__ Raw<T, V> load_raw(const T* p, bool ok) {
  Raw<T, V> r;
  if constexpr (V * sizeof(T) == 16) {
    uint4 u = make_uint4(0, 0, 0, 0);
    if (ok) u = __ldg(reinterpret_cast<const uint4*>(p));
    memcpy(&r, &u, 16);
  } else {
    r.x[0] = ok ? p[0] : sgs::from_float<T>(0.f);
  }
  return r;
}

// Exclusive prefix sum of a[0, n) in place by the whole block; returns
// the total. scratch: 32 ints.
__device__ int block_exclusive_scan(int* a, int n, int* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int i0 = min(static_cast<int>(threadIdx.x) * per, n);
  const int i1 = min(i0 + per, n);
  int own = 0;
  for (int i = i0; i < i1; ++i) own += a[i];
  int x = own;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int warps = blockDim.x >> 5;
    int t = lane < warps ? scratch[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, t, d);
      if (lane >= d) t += y;
    }
    scratch[lane] = t;
  }
  __syncthreads();
  int run = x - own + (warp > 0 ? scratch[warp - 1] : 0);
  for (int i = i0; i < i1; ++i) {
    const int c = a[i];
    a[i] = run;
    run += c;
  }
  const int total = scratch[31];
  __syncthreads();
  return total;
}

// Adds a run's V columns into the slab: plainly where no other walker can
// hold the same id (the run lies inside the walker's sorted range), else
// with shared-memory atomics.
template <int V>
__device__ __forceinline__ void add_run(float* slab, int stride, int j,
                                        int id, const float (&acc)[V],
                                        bool shared) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
    float* p = slab + (j + k) * stride + id;
    if (shared) {
      atomicAdd(p, acc[k]);
    } else {
      *p += acc[k];
    }
  }
}

// Block (x, y): slab x (columns [x*W, x*W + W)) of every output row, held in
// shared memory, over edge chunk y. A chunk that looks sorted takes
// add_rows instead ("rows" mode). Otherwise ("sort" mode), per sub-chunk of
// sub_items edges, the block counting-sorts the in-range ids into keys (id,
// offset) in shared memory, and walkers of W / V lanes take equal ranges of
// the sorted keys; a lane reads V consecutive columns of each key's row
// (one 16-byte load where the row layout allows, V = 16 / sizeof(T); else
// V = 1), sums runs of equal ids in registers and adds each run into the
// slab: plainly if the run lies inside its walker's range, with
// shared-memory atomics if it may continue in a neighbour's. Block (0, y)
// counts chunk y's mode in chunk_modes[0] ("sort") or [1] ("rows").
template <typename T, int V>
__global__ void __launch_bounds__(kSlabThreads, 1)
scatter_slab_kernel(const T* __restrict__ vals, const int* __restrict__ ids,
                    float* __restrict__ out, long long num_items, int feat,
                    int num_segments, int slab_cols, long long chunk_items,
                    int sub_items, bool vec4, int* __restrict__ chunk_modes) {
  // slab_cols columns of stride S; then the sort's histogram (N ints), keys
  // (sub_items ints: id << kKeyBits | offset) and scan scratch
  extern __shared__ float slab[];
  const long long e0 = static_cast<long long>(blockIdx.y) * chunk_items;
  const long long e1 = min(e0 + chunk_items, num_items);
  const bool rows_mode = chunk_looks_sorted(ids, e0, e1);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    atomicAdd(chunk_modes + (rows_mode ? 1 : 0), 1);
  }
  if (rows_mode) {
    // the chunk's sibling blocks split it; each warp adds whole rows
    const long long warps =
        static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
    const long long warp = static_cast<long long>(blockIdx.x) *
                               (blockDim.x >> 5) + (threadIdx.x >> 5);
    const long long per = (e1 - e0 + warps - 1) / warps;
    const long long a0 = min(e0 + warp * per, e1);
    const long long a1 = min(a0 + per, e1);
    for (int tile0 = 0; tile0 < feat; tile0 += sgs::kRowTile) {
      add_rows<T, (V > 1)>(vals, ids, out, a0, a1, feat, num_segments,
                           tile0);
    }
    return;
  }
  const int stride = slab_stride(num_segments);
  const int c0 = blockIdx.x * slab_cols;
  const int cells = slab_cols * stride;
  for (int k = threadIdx.x; k < cells; k += blockDim.x) slab[k] = 0.f;
  __syncthreads();

  const int lanes = slab_cols / V;             // lanes of one walker
  const int walkers = blockDim.x / lanes;
  const int w = threadIdx.x / lanes;
  const int j = (threadIdx.x % lanes) * V;     // first slab column of lane
  const bool live = c0 + j < feat;             // feat % V == 0 if V > 1
  int* hist = reinterpret_cast<int*>(slab + cells);
  int* keys = hist + num_segments;
  int* scratch = keys + sub_items;
  for (long long s0 = e0; s0 < e1; s0 += sub_items) {
    const int m = static_cast<int>(min(static_cast<long long>(sub_items),
                                       e1 - s0));
    // counting sort of the sub-chunk's in-range ids
    for (int n = threadIdx.x; n < num_segments; n += blockDim.x) hist[n] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      const int id = __ldg(ids + s0 + i);
      if (id >= 0 && id < num_segments) atomicAdd(hist + id, 1);
    }
    __syncthreads();
    const int total = block_exclusive_scan(hist, num_segments, scratch);
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      const int id = __ldg(ids + s0 + i);
      if (id >= 0 && id < num_segments) {
        keys[atomicAdd(hist + id, 1)] = (id << kKeyBits) | i;
      }
    }
    __syncthreads();

    // walker w sums runs over sorted positions [p0, p1)
    const int per = (total + walkers - 1) / walkers;
    const int p0 = min(w * per, total);
    const int p1 = min(p0 + per, total);
    const int before = p0 > 0 ? keys[p0 - 1] >> kKeyBits : -1;
    const int after = p1 < total ? keys[p1] >> kKeyBits : -1;
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.f;
    int cur = -1;
    for (int p = p0; p < p1; p += kSlabUnroll) {
      int id[kSlabUnroll];
      Raw<T, V> v[kSlabUnroll];
#pragma unroll
      for (int u = 0; u < kSlabUnroll; ++u) {
        const bool in = p + u < p1;
        const int key = in ? keys[p + u] : 0;
        id[u] = key >> kKeyBits;
        const long long e = s0 + (key & (kMaxSubItems - 1));
        v[u] = load_raw<T, V>(vals + e * feat + c0 + j, in && live);
      }
#pragma unroll
      for (int u = 0; u < kSlabUnroll; ++u) {
        if (p + u >= p1) break;
        if (id[u] != cur) {
          if (cur >= 0 && live) {
            add_run<V>(slab, stride, j, cur, acc,
                       cur == before || cur == after);
          }
          cur = id[u];
#pragma unroll
          for (int k = 0; k < V; ++k) acc[k] = 0.f;
        }
#pragma unroll
        for (int k = 0; k < V; ++k) acc[k] += sgs::to_float(v[u].x[k]);
      }
    }
    if (cur >= 0 && live) {
      add_run<V>(slab, stride, j, cur, acc, cur == before || cur == after);
    }
    __syncthreads();  // the keys and histogram are reused
  }

  // flush: thread k adds (row, 4 columns) with one 16-byte atomic where F
  // keeps output rows 16-byte aligned, else (row, column) with a scalar one;
  // consecutive threads take consecutive columns of one row
  if (vec4) {
    const int quads = slab_cols / 4;
    for (int k = threadIdx.x; k < num_segments * quads; k += blockDim.x) {
      const int row = k / quads;
      const int q = 4 * (k % quads);
      const float* col = slab + q * stride + row;
      const float4 v = make_float4(col[0], col[stride], col[2 * stride],
                                   col[3 * stride]);
      if (c0 + q < feat &&
          (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f)) {
        atomicAdd(reinterpret_cast<float4*>(
                      out + static_cast<long long>(row) * feat + c0 + q), v);
      }
    }
  } else {
    for (int k = threadIdx.x; k < num_segments * slab_cols;
         k += blockDim.x) {
      const int row = k / slab_cols;
      const int c = k % slab_cols;
      const float v = slab[c * stride + row];
      if (c0 + c < feat && v != 0.f) {
        atomicAdd(out + static_cast<long long>(row) * feat + c0 + c, v);
      }
    }
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kDirectWarps * 32)
scatter_direct_kernel(const T* __restrict__ vals, const int* __restrict__ ids,
                      float* __restrict__ out, long long num_items, int feat,
                      int num_segments, long long chunk_items) {
  const long long per_warp = chunk_items / kDirectWarps;
  const long long e0 = static_cast<long long>(blockIdx.y) * chunk_items +
                       (threadIdx.x >> 5) * per_warp;
  if (e0 >= num_items) return;
  add_rows<T, kVec>(vals, ids, out, e0, min(e0 + per_warp, num_items), feat,
                    num_segments, blockIdx.x * sgs::kRowTile);
}

template <typename T, int V>
int launch_slab(const T* v, const int* i, float* o, dim3 grid,
                long long num_items, int feat, int num_segments, int col_tile,
                long long chunk_items, int sub_items, int smem, bool vec4,
                int* chunk_modes, cudaStream_t s) {
  static bool opted_in = false;  // once per instantiation (one card)
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        scatter_slab_kernel<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  scatter_slab_kernel<T, V><<<grid, kSlabThreads, smem, s>>>(
      v, i, o, num_items, feat, num_segments, col_tile, chunk_items,
      sub_items, vec4, chunk_modes);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* vals, const void* ids, void* out, long long num_items,
           int feat, int num_segments, int route, int col_tile,
           long long chunk_items, int sub_items, int smem, int* chunk_modes,
           cudaStream_t s) {
  const dim3 grid(sgs::ceil_div_ll(feat, col_tile),
                  sgs::ceil_div_ll(num_items, chunk_items));
  const T* v = static_cast<const T*>(vals);
  const int* i = static_cast<const int*>(ids);
  float* o = static_cast<float*>(out);
  if (route == 0) {  // slab
    if (col_tile < 1 || col_tile > 32 || 32 % col_tile != 0 ||
        sub_items < 1 || sub_items > kMaxSubItems ||
        num_segments >= (1 << (31 - kKeyBits)) ||
        smem != slab_smem(num_segments, col_tile, sub_items) ||
        smem > kMaxSmem || chunk_modes == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const bool vec4 = feat % 4 == 0 && col_tile % 4 == 0 &&
                      reinterpret_cast<unsigned long long>(out) % 16 == 0;
    // 16-byte loads: whole vectors per lane, 16-byte aligned rows
    constexpr int kV = sgs::Vec<T>::kLen;
    if (col_tile % kV == 0 && sgs::vector_rows<T>(feat, vals, out)) {
      return launch_slab<T, kV>(v, i, o, grid, num_items, feat, num_segments,
                                col_tile, chunk_items, sub_items, smem, vec4,
                                chunk_modes, s);
    }
    return launch_slab<T, 1>(v, i, o, grid, num_items, feat, num_segments,
                             col_tile, chunk_items, sub_items, smem, vec4,
                             chunk_modes, s);
  } else {  // direct
    if (col_tile != sgs::kRowTile || chunk_items % kDirectWarps != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (sgs::vector_rows<T>(feat, vals, out)) {
      scatter_direct_kernel<T, true><<<grid, kDirectWarps * 32, 0, s>>>(
          v, i, o, num_items, feat, num_segments, chunk_items);
    } else {
      scatter_direct_kernel<T, false><<<grid, kDirectWarps * 32, 0, s>>>(
          v, i, o, num_items, feat, num_segments, chunk_items);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// route 0 "slab": col_tile = slab columns W (a divisor of 32), sub_items =
// items of one sort pass (<= 2^15), smem = slab_smem(N, W, sub_items) bytes;
// route 1 "direct": col_tile = 256, sub_items and smem unused. chunk_items:
// edges per block row (gridDim.y = ceil(E / chunk_items)). ops/scatter.py
// scatter_plan computes them. chunk_modes: 2 ints on the card to which the
// slab route adds its chunks by mode ("sort", "rows"); unused by "direct".
extern "C" int sgs_scatter_add(const void* vals, int vals_bf16,
                               const void* ids, void* out,
                               long long num_items, int feat,
                               int num_segments, int route, int col_tile,
                               long long chunk_items, int sub_items, int smem,
                               void* chunk_modes, void* stream) {
  int* modes = static_cast<int*>(chunk_modes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vals_bf16) {
    return launch<__nv_bfloat16>(vals, ids, out, num_items, feat,
                                 num_segments, route, col_tile, chunk_items,
                                 sub_items, smem, modes, s);
  }
  return launch<float>(vals, ids, out, num_items, feat, num_segments, route,
                       col_tile, chunk_items, sub_items, smem, modes, s);
}

extern "C" const char* sgs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
