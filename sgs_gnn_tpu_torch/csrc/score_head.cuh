// CUDA-core device code of the edge-score head kernels: K5 (score_sampled.cu,
// the backward), and the f32 forward of K3 (score_sampled.cu, dynamic
// (sender, receiver) pairs) and K6 (score_tiles.cu, every tile-pair slot).
// Their bf16 forward runs on the tensor cores (head_mma.cuh).
//
//   z  = (h[s]*h[r]) @ W1a + (h[s]-h[r]) @ W1b + b1          (edge, K)
//   zd = drop(relu(z))                                     dropout mask
//   p  = sigmoid(zd . w2 + b2)
//
// A block owns BM=64 edges. The reduction runs over the 2F feature columns
// [h_u*h_v || h_u-h_v] in chunks of BK: the block forms the chunk of the
// product/difference features for its 64 edges in shared memory (rounded
// to h's type, as an elementwise op on h would be) and the matching BK rows
// of [W1a; W1b] (through L2), then each thread accumulates an 8x8 tile of z
// in f32 registers. K is covered in tiles of BN=256 columns. Ragged chunks
// and tiles are zero-padded; ids outside [0, N) read as a zero row, as the
// TPU kernels' one-hot select (and their zero-padded h) gives.
#pragma once

#include "common.cuh"

namespace sgs {
namespace head {

constexpr int BM = 64;    // edges per block
constexpr int BN = 256;   // hidden (or feature) columns per tile
constexpr int BK = 16;    // reduction columns per chunk
constexpr int TM = 8;     // edges per thread
constexpr int TN = 8;     // columns per thread (strided by 32)
constexpr int kThreads = 256;  // 8 warps x 32 lanes: warp -> rows, lane -> cols
static_assert(BM == (kThreads / 32) * TM, "warps cover the edge rows");
static_assert(BN == 32 * TN, "lanes cover the columns");

// Dropout of one call: unit (e, k) is kept when hash32(seed, e*K + k) >=
// thresh and then scaled by `scale`; thresh == 0 keeps every unit.
struct Drop {
  uint32_t seed;
  uint32_t thresh;
  float scale;

  __device__ __forceinline__ bool keep(long long e, int hidden,
                                       int col) const {
    if (thresh == 0u) return true;
    const unsigned long long c =
        static_cast<unsigned long long>(e) * static_cast<unsigned>(hidden) +
        static_cast<unsigned>(col);
    return hash32(seed, c) >= thresh;
  }
};

// +1 on each row: conflict-free transposed stores
struct GemmSmem {
  float a[BK][BM + 1];
  float b[BK][BN + 1];
};

// Stores an endpoint id for the block's table, -1 when outside [0, N).
__device__ __forceinline__ int checked_id(int id, int n_rows) {
  return (id >= 0 && id < n_rows) ? id : -1;
}

// acc[i][j] = z[m][n0 + lane + 32 j] - b1 for m = warp*TM + i: the first
// layer of the head for the block's edges s_s / r_s and one tile of K.
template <typename T>
__device__ __forceinline__ void first_layer(
    float (&acc)[TM][TN], GemmSmem& sm, const T* __restrict__ h,
    const T* __restrict__ w1a, const T* __restrict__ w1b, const int* s_s,
    const int* r_s, int n0, int feat, int hidden) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  const int cols = 2 * feat;
  for (int c0 = 0; c0 < cols; c0 += BK) {
    // features of this chunk: consecutive threads read consecutive columns
    // of one endpoint row
    for (int i = tid; i < BM * BK; i += kThreads) {
      const int m = i / BK;
      const int kk = i % BK;
      const int c = c0 + kk;
      float v = 0.f;
      if (c < cols) {
        const int f = c < feat ? c : c - feat;
        const int s = s_s[m];
        const int r = r_s[m];
        const float hu =
            s >= 0 ? to_float(h[static_cast<long long>(s) * feat + f]) : 0.f;
        const float hv =
            r >= 0 ? to_float(h[static_cast<long long>(r) * feat + f]) : 0.f;
        v = round_as<T>(c < feat ? hu * hv : hu - hv);
      }
      sm.a[kk][m] = v;
    }
    // matching rows of [W1a; W1b], consecutive threads on consecutive
    // hidden columns
    for (int i = tid; i < BK * BN; i += kThreads) {
      const int kk = i / BN;
      const int n = i % BN;
      const int c = c0 + kk;
      const int col = n0 + n;
      float v = 0.f;
      if (c < cols && col < hidden) {
        v = to_float(c < feat
                         ? w1a[static_cast<long long>(c) * hidden + col]
                         : w1b[static_cast<long long>(c - feat) * hidden +
                               col]);
      }
      sm.b[kk][n] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = sm.a[kk][warp * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = sm.b[kk][lane + 32 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// Adds this K tile's share of each edge's logit, drop(relu(z)) . w2, to
// logit_s (each row of the tile belongs to one warp: a warp reduction, then
// lane 0 adds).
__device__ __forceinline__ void add_logits(const float (&acc)[TM][TN],
                                           float* logit_s,
                                           const float* __restrict__ b1,
                                           const float* __restrict__ w2,
                                           int n0, int hidden, long long e0,
                                           const Drop& d) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float part[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) part[i] = 0.f;
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int col = n0 + lane + 32 * j;
    if (col < hidden) {
      const float bias = b1[col];
      const float wout = w2[col];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float zr = fmaxf(acc[i][j] + bias, 0.f);
        const float zd =
            d.keep(e0 + warp * TM + i, hidden, col) ? zr * d.scale : 0.f;
        part[i] += zd * wout;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part[i] += __shfl_xor_sync(0xffffffffu, part[i], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < TM; ++i) logit_s[warp * TM + i] += part[i];
  }
}

// Forward over q edge slots. kTiles = false (K3): slot e's endpoints are
// sid[e] / rid[e]. kTiles = true (K6): sid / rid hold tile-local ids and
// the endpoints are su[e / tile_b] * tile_t + sid[e] (and rv / rid).
template <typename T, bool kTiles>
__global__ void __launch_bounds__(kThreads)
head_fwd_kernel(const T* __restrict__ h, const T* __restrict__ w1a,
                const T* __restrict__ w1b, const float* __restrict__ b1,
                const float* __restrict__ w2, const float* __restrict__ b2,
                const int* __restrict__ sid, const int* __restrict__ rid,
                const int* __restrict__ su, const int* __restrict__ rv,
                int tile_t, int tile_b, const int* __restrict__ seed,
                uint32_t thresh, float scale, float* __restrict__ out,
                long long q, int n_rows, int feat, int hidden) {
  __shared__ GemmSmem sm;
  __shared__ int s_s[BM];
  __shared__ int r_s[BM];
  __shared__ float logit_s[BM];

  const int tid = threadIdx.x;
  const long long e0 = static_cast<long long>(blockIdx.x) * BM;
  if (tid < BM) {
    const long long e = e0 + tid;
    int s = -1, r = -1;
    if (e < q) {
      s = sid[e];
      r = rid[e];
      if (kTiles) {
        const long long b = e / tile_b;
        s += su[b] * tile_t;
        r += rv[b] * tile_t;
      }
    }
    s_s[tid] = checked_id(s, n_rows);
    r_s[tid] = checked_id(r, n_rows);
    logit_s[tid] = 0.f;
  }
  const Drop d{static_cast<uint32_t>(seed[0]), thresh, scale};
  __syncthreads();

  for (int n0 = 0; n0 < hidden; n0 += BN) {
    float acc[TM][TN];
    first_layer<T>(acc, sm, h, w1a, w1b, s_s, r_s, n0, feat, hidden);
    add_logits(acc, logit_s, b1, w2, n0, hidden, e0, d);
  }
  __syncthreads();
  if (tid < BM) {
    const long long e = e0 + tid;
    if (e < q) out[e] = 1.f / (1.f + expf(-(logit_s[tid] + b2[0])));
  }
}

}  // namespace head
}  // namespace sgs
