// score_head_fwd: the edge-score head over dynamic (sender, receiver) pairs,
//   p[e] = sigmoid(w2 . relu((h[s]*h[r]) @ W1a + (h[s]-h[r]) @ W1b + b1) + b2)
// for q edges, f32 out. Forward only, no dropout (serving is deterministic).
//
// Replaces sgs_gnn_tpu/ops/score_sampled.py:_make_fwd_kernel (the full,
// unbanded kernel behind _fwd_call.call_full). The TPU kernel selected the
// endpoint rows with (N, B) one-hot matmuls on the MXU, because Mosaic has
// no dynamic VMEM gather. Here a block gathers its edges' rows straight
// from h (N*F*2 = 1 MB at N=2048, F=256: it stays in the 50 MB L2).
//
// Design: one block of 256 threads per tile of BM=64 edges. The reduction
// runs over the 2F "feature" columns [h_u*h_v || h_u-h_v] in chunks of BK:
// the block forms the chunk of the product/difference features for its 64
// edges in shared memory (rounded to h's type, as an elementwise op on h
// would be) and the matching BK rows of [W1a; W1b] (through L2), then each
// thread accumulates an 8x8 tile of z in f32 registers. K is covered in
// tiles of BN=256 columns; each tile's epilogue adds b1, applies relu, dots
// with w2 and reduces across the warp into a per-edge logit in shared
// memory. Any N, F, K and q work: ragged chunks and tiles are zero-padded.
// Ids outside [0, N) read as a zero row, as the one-hot select gives.
//
// Bound: operations, 2*(2F*K)*q (~268 GFLOP at q=1M, F=K=256: ~0.27 ms at
// the bf16 tensor-core rate); its bytes are ~13 MB. This first version runs
// on CUDA cores in f32, so it sits an order of magnitude above that bound;
// the tensor-core (wgmma) version is later work.
#include "common.cuh"

namespace {

constexpr int BM = 64;    // edges per block
constexpr int BN = 256;   // hidden columns per tile
constexpr int BK = 16;    // feature columns per chunk
constexpr int TM = 8;     // edges per thread
constexpr int TN = 8;     // hidden columns per thread (strided by 32)
constexpr int kThreads = 256;  // 8 warps x 32 lanes: warp -> rows, lane -> cols
static_assert(BM == (kThreads / 32) * TM, "warps cover the edge rows");
static_assert(BN == 32 * TN, "lanes cover the hidden columns");

template <typename T>
__global__ void __launch_bounds__(kThreads)
score_head_fwd_kernel(const T* __restrict__ h, const T* __restrict__ w1a,
                      const T* __restrict__ w1b, const float* __restrict__ b1,
                      const float* __restrict__ w2,
                      const float* __restrict__ b2,
                      const int* __restrict__ sid, const int* __restrict__ rid,
                      float* __restrict__ out, long long q, int n_rows,
                      int feat, int hidden) {
  __shared__ float a_s[BK][BM + 1];   // +1: conflict-light transposed stores
  __shared__ float b_s[BK][BN];
  __shared__ int s_s[BM];
  __shared__ int r_s[BM];
  __shared__ float logit_s[BM];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long e0 = static_cast<long long>(blockIdx.x) * BM;
  if (tid < BM) {
    const long long e = e0 + tid;
    int s = -1, r = -1;
    if (e < q) {
      s = sid[e];
      r = rid[e];
    }
    s_s[tid] = (s >= 0 && s < n_rows) ? s : -1;
    r_s[tid] = (r >= 0 && r < n_rows) ? r : -1;
    logit_s[tid] = 0.f;
  }
  __syncthreads();

  const int cols = 2 * feat;
  for (int n0 = 0; n0 < hidden; n0 += BN) {
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    for (int c0 = 0; c0 < cols; c0 += BK) {
      // features of this chunk: consecutive threads read consecutive
      // columns of one endpoint row
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
              s >= 0 ? sgs::to_float(h[static_cast<long long>(s) * feat + f])
                     : 0.f;
          const float hv =
              r >= 0 ? sgs::to_float(h[static_cast<long long>(r) * feat + f])
                     : 0.f;
          v = sgs::round_as<T>(c < feat ? hu * hv : hu - hv);
        }
        a_s[kk][m] = v;
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
          v = sgs::to_float(
              c < feat ? w1a[static_cast<long long>(c) * hidden + col]
                       : w1b[static_cast<long long>(c - feat) * hidden + col]);
        }
        b_s[kk][n] = v;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = a_s[kk][warp * TM + i];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = b_s[kk][lane + 32 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

    // epilogue of this hidden tile: relu(z + b1) . w2, summed over the
    // warp's 32 lanes (each row of the tile belongs to one warp)
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
        for (int i = 0; i < TM; ++i)
          part[i] += fmaxf(acc[i][j] + bias, 0.f) * wout;
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
  __syncthreads();
  if (tid < BM) {
    const long long e = e0 + tid;
    if (e < q) out[e] = 1.f / (1.f + expf(-(logit_s[tid] + b2[0])));
  }
}

template <typename T>
void launch(const void* h, const void* w1a, const void* w1b, const void* b1,
            const void* w2, const void* b2, const void* sid, const void* rid,
            void* out, long long q, int n_rows, int feat, int hidden,
            cudaStream_t s) {
  score_head_fwd_kernel<T><<<sgs::ceil_div_ll(q, BM), kThreads, 0, s>>>(
      static_cast<const T*>(h), static_cast<const T*>(w1a),
      static_cast<const T*>(w1b), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<const int*>(sid), static_cast<const int*>(rid),
      static_cast<float*>(out), q, n_rows, feat, hidden);
}

}  // namespace

extern "C" int sgs_score_head_fwd(const void* h, int h_bf16, const void* w1a,
                                  const void* w1b, const void* b1,
                                  const void* w2, const void* b2,
                                  const void* sid, const void* rid, void* out,
                                  long long q, int n_rows, int feat,
                                  int hidden, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h_bf16) {
    launch<__nv_bfloat16>(h, w1a, w1b, b1, w2, b2, sid, rid, out, q, n_rows,
                          feat, hidden, s);
  } else {
    launch<float>(h, w1a, w1b, b1, w2, b2, sid, rid, out, q, n_rows, feat,
                  hidden, s);
  }
  return static_cast<int>(cudaGetLastError());
}
