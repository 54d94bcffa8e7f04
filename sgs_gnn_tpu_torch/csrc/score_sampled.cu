// The edge-score head over dynamic (sender, receiver) pairs: K3 forward and
// K5 backward, with counter-based dropout between relu and the w2 dot.
//
// K3, sgs_score_head_fwd: p[e] = sigmoid(w2 . drop(relu(z[e])) + b2), f32.
// Replaces sgs_gnn_tpu/ops/score_sampled.py:_make_fwd_kernel, behind both
// _fwd_call.call_full and _fwd_call.call_banded. The TPU kernel selected the
// endpoint rows with (N, B) one-hot matmuls on the MXU (banded to (band, B)
// on the near-sorted side), because Mosaic has no dynamic VMEM gather. Here
// a block gathers its edges' rows straight from h (N*F*2 = 1 MB at N=2048,
// F=256: it stays in the 50 MB L2), so the band has nothing left to cut and
// the banded and full variants are one kernel. Nor are the gathered hu/hv
// rows written out as residuals: the TPU kept them only to skip a second
// one-hot select in the backward; K5 gathers them again from L2.
// Bound: operations, 2*(2F*K) per edge (~53 us at q=200k, F=K=256, on the
// bf16 tensor cores). bf16 h runs on the tensor cores (head_mma.cuh, which
// says how); f32 h on CUDA cores (score_head.cuh), since the tensor cores
// have no full-f32 product.
//
// K5, sgs_score_head_bwd: the VJP. Replaces
// sgs_gnn_tpu/ops/score_sampled.py:_make_bwd_kernel (behind _bwd_call, full
// and banded). The TPU grid ran in order and carried dh and the weight
// gradients in VMEM accumulators from step to step; Hopper blocks run in no
// order, so the work is split in kernels on the stream. bf16 h runs three
// tensor-core kernels (head_bwd_mma.cuh, which says how); f32 h the two
// CUDA-core kernels below:
//   1. edge pass (grid-stride over 64-edge tiles): recompute z, the dropout
//      mask (regenerated from the same seed and counters) and p; dlogit =
//      dp*p*(1-p); dz1 (cast to h's type, written to a (q, K) scratch);
//      db1, dw2, db2 summed in shared memory and flushed once per block;
//      dprod = dz1 W1a^T, ddiff = dz1 W1b^T (a second register-tiled GEMM),
//      dhu = dprod*hv + ddiff, dhv = dprod*hu - ddiff (cast to h's type)
//      scattered into dh with f32 atomics, merging runs of equal ids on the
//      first (sorted) side in registers.
//   2. weight pass: dW1a = prod^T dz1, dW1b = diff^T dz1, a GEMM reduced
//      over q. Each block owns a (64 features x 256 hidden) tile of one of
//      the two matrices and a long range of edges (q split ~33 ways at
//      F=K=256 to fill 2 waves), accumulates in registers and flushes once
//      with atomics: ~4M atomics in all, not one per edge and weight.
// Cast points follow the JAX kernel (score_sampled.py:248, 260-261): dz1
// and dhu/dhv are rounded to h's type; db1 sums dz1 before the cast.
// Bound: operations, 3x the forward's (~0.16 ms at q=200k on tensor cores).
#include "head_bwd_mma.cuh"
#include "head_mma.cuh"
#include "score_head.cuh"

namespace {

using namespace sgs::head;

constexpr int WM = 64;   // feature rows per block in the weight pass

// Flushes one run of dh contributions to row `cur` (none for cur < 0).
__device__ __forceinline__ void flush_row(float* __restrict__ dh, int cur,
                                          int feat, int f, float v) {
  if (cur >= 0) atomicAdd(dh + static_cast<long long>(cur) * feat + f, v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
head_bwd_edge_kernel(const T* __restrict__ h, const T* __restrict__ w1a,
                     const T* __restrict__ w1b, const float* __restrict__ b1,
                     const float* __restrict__ w2,
                     const float* __restrict__ b2,
                     const int* __restrict__ sid, const int* __restrict__ rid,
                     const float* __restrict__ dp,
                     const int* __restrict__ seed, uint32_t thresh,
                     float scale, T* __restrict__ dz1,
                     float* __restrict__ dh, float* __restrict__ db1,
                     float* __restrict__ dw2, float* __restrict__ db2,
                     long long q, int n_rows, int feat, int hidden) {
  __shared__ GemmSmem sm;
  __shared__ float b2_s[BK][BN + 1];   // W1b^T chunk of the dh GEMM
  __shared__ int s_s[BM];
  __shared__ int r_s[BM];
  __shared__ float g_s[BM];        // logits, then dlogit
  __shared__ float db2_s;
  extern __shared__ float red_s[];  // [0, K): dw2, [K, 2K): db1

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int c = tid; c < 2 * hidden; c += kThreads) red_s[c] = 0.f;
  if (tid == 0) db2_s = 0.f;
  const Drop d{static_cast<uint32_t>(seed[0]), thresh, scale};
  const long long n_tiles = (q + BM - 1) / BM;

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long e0 = tile * BM;
    if (tid < BM) {
      const long long e = e0 + tid;
      s_s[tid] = e < q ? checked_id(sid[e], n_rows) : -1;
      r_s[tid] = e < q ? checked_id(rid[e], n_rows) : -1;
      g_s[tid] = 0.f;
    }
    __syncthreads();

    // forward again: the logits over every K tile
    float acc[TM][TN];
    for (int n0 = 0; n0 < hidden; n0 += BN) {
      first_layer<T>(acc, sm, h, w1a, w1b, s_s, r_s, n0, feat, hidden);
      add_logits(acc, g_s, b1, w2, n0, hidden, e0, d);
    }
    __syncthreads();
    if (tid < BM) {
      const long long e = e0 + tid;
      float g = 0.f;
      if (e < q) {
        const float p = 1.f / (1.f + expf(-(g_s[tid] + b2[0])));
        g = dp[e] * p * (1.f - p);
      }
      g_s[tid] = g;
    }
    __syncthreads();
    if (warp == 0) {
      float v = g_s[lane] + g_s[lane + 32];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) db2_s += v;
    }

    // dz1, tile by tile over K (z is recomputed when K spans several tiles;
    // with one tile the forward's registers still hold it)
    for (int n0 = 0; n0 < hidden; n0 += BN) {
      if (hidden > BN)
        first_layer<T>(acc, sm, h, w1a, w1b, s_s, r_s, n0, feat, hidden);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = n0 + lane + 32 * j;
        if (col >= hidden) continue;
        const float bias = b1[col];
        const float wout = w2[col];
        float dw2_part = 0.f, db1_part = 0.f;
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int m = warp * TM + i;
          const long long e = e0 + m;
          const float z = acc[i][j] + bias;
          const bool kept = d.keep(e, hidden, col);
          const float g = g_s[m];
          const float zd = kept ? fmaxf(z, 0.f) * d.scale : 0.f;
          dw2_part += zd * g;
          const float dzd = g * wout;
          const float dz = (kept && z > 0.f) ? dzd * d.scale : 0.f;
          db1_part += dz;
          if (e < q)
            dz1[e * hidden + col] = sgs::from_float<T>(dz);
        }
        atomicAdd(red_s + col, dw2_part);
        atomicAdd(red_s + hidden + col, db1_part);
      }
    }
    __syncthreads();   // the tile's dz1 rows are written and visible

    // dh: dprod = dz1 W1a^T, ddiff = dz1 W1b^T over F tiles
    for (int f0 = 0; f0 < feat; f0 += BN) {
      float pb[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = pb[i][j] = 0.f;
      for (int k0 = 0; k0 < hidden; k0 += BK) {
        for (int i = tid; i < BM * BK; i += kThreads) {
          const int m = i / BK;
          const int kk = i % BK;
          const int k = k0 + kk;
          const long long e = e0 + m;
          sm.a[kk][m] = (k < hidden && e < q)
                            ? sgs::to_float(dz1[e * hidden + k])
                            : 0.f;
        }
        for (int i = tid; i < BK * BN; i += kThreads) {
          const int n = i / BK;
          const int kk = i % BK;
          const int f = f0 + n;
          const int k = k0 + kk;
          const bool ok = f < feat && k < hidden;
          const long long at = static_cast<long long>(f) * hidden + k;
          sm.b[kk][n] = ok ? sgs::to_float(w1a[at]) : 0.f;
          b2_s[kk][n] = ok ? sgs::to_float(w1b[at]) : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
          float a[TM], ba[TN], bb[TN];
#pragma unroll
          for (int i = 0; i < TM; ++i) a[i] = sm.a[kk][warp * TM + i];
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            ba[j] = sm.b[kk][lane + 32 * j];
            bb[j] = b2_s[kk][lane + 32 * j];
          }
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) {
              acc[i][j] = fmaf(a[i], ba[j], acc[i][j]);
              pb[i][j] = fmaf(a[i], bb[j], pb[i][j]);
            }
        }
        __syncthreads();
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int f = f0 + lane + 32 * j;
        if (f >= feat) continue;
        int cur = -1;
        float run = 0.f;
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int m = warp * TM + i;
          const int s = s_s[m];
          const int r = r_s[m];
          const float hu =
              s >= 0 ? sgs::to_float(h[static_cast<long long>(s) * feat + f])
                     : 0.f;
          const float hv =
              r >= 0 ? sgs::to_float(h[static_cast<long long>(r) * feat + f])
                     : 0.f;
          // unfused multiply and add: the same f32 roundings as the plain
          // version before the cast to h's type
          const float dhu = sgs::round_as<T>(
              __fadd_rn(__fmul_rn(acc[i][j], hv), pb[i][j]));
          const float dhv = sgs::round_as<T>(
              __fsub_rn(__fmul_rn(acc[i][j], hu), pb[i][j]));
          if (s != cur) {
            flush_row(dh, cur, feat, f, run);
            cur = s;
            run = 0.f;
          }
          run += dhu;
          flush_row(dh, r, feat, f, dhv);
        }
        flush_row(dh, cur, feat, f, run);
      }
    }
    __syncthreads();   // before the next tile reuses s_s / r_s / g_s
  }

  for (int c = tid; c < hidden; c += kThreads) {
    atomicAdd(dw2 + c, red_s[c]);
    atomicAdd(db1 + c, red_s[hidden + c]);
  }
  if (tid == 0) atomicAdd(db2, db2_s);
}

// dW1a (blockIdx.z even) or dW1b (odd) over edges [split*per, (split+1)*per),
// split = blockIdx.z / 2: acc[i][j] = sum_e feat[e][f] * dz1[e][col] for
// f = f0 + warp*TM + i, col = n0 + lane + 32 j.
template <typename T>
__global__ void __launch_bounds__(kThreads)
head_bwd_weight_kernel(const T* __restrict__ h, const int* __restrict__ sid,
                       const int* __restrict__ rid, const T* __restrict__ dz1,
                       float* __restrict__ dw1a, float* __restrict__ dw1b,
                       long long q, int n_rows, int feat, int hidden,
                       long long per_split) {
  __shared__ float a_s[BK][WM + 1];
  __shared__ float b_s[BK][BN];
  __shared__ int s_s[BK];
  __shared__ int r_s[BK];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool diff = (blockIdx.z & 1) != 0;
  const long long e_begin = static_cast<long long>(blockIdx.z >> 1) * per_split;
  const long long e_end = min(q, e_begin + per_split);
  const int f0 = blockIdx.x * WM;
  const int n0 = blockIdx.y * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (long long c0 = e_begin; c0 < e_end; c0 += BK) {
    if (tid < BK) {
      const long long e = c0 + tid;
      s_s[tid] = e < e_end ? checked_id(sid[e], n_rows) : -1;
      r_s[tid] = e < e_end ? checked_id(rid[e], n_rows) : -1;
    }
    __syncthreads();
    for (int i = tid; i < BK * WM; i += kThreads) {
      const int kk = i / WM;
      const int m = i % WM;
      const int f = f0 + m;
      float v = 0.f;
      if (f < feat) {
        const int s = s_s[kk];
        const int r = r_s[kk];
        const float hu =
            s >= 0 ? sgs::to_float(h[static_cast<long long>(s) * feat + f])
                   : 0.f;
        const float hv =
            r >= 0 ? sgs::to_float(h[static_cast<long long>(r) * feat + f])
                   : 0.f;
        v = sgs::round_as<T>(diff ? hu - hv : hu * hv);
      }
      a_s[kk][m] = v;
    }
    for (int i = tid; i < BK * BN; i += kThreads) {
      const int kk = i / BN;
      const int n = i % BN;
      const int col = n0 + n;
      const long long e = c0 + kk;
      b_s[kk][n] = (col < hidden && e < e_end)
                       ? sgs::to_float(dz1[e * hidden + col])
                       : 0.f;
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

  float* out = diff ? dw1b : dw1a;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int f = f0 + warp * TM + i;
    if (f >= feat) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + lane + 32 * j;
      if (col < hidden)
        atomicAdd(out + static_cast<long long>(f) * hidden + col, acc[i][j]);
    }
  }
}

__global__ void dropout_bits_kernel(const int* __restrict__ seed,
                                    const long long* __restrict__ counters,
                                    long long* __restrict__ out, long long n) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n)
    out[i] = sgs::hash32(static_cast<uint32_t>(seed[0]),
                         static_cast<unsigned long long>(counters[i]));
}

// the f32 forward (CUDA cores; bf16 takes head_mma.cuh)
int launch_fwd_f32(const void* h, const void* w1a, const void* w1b,
                   const void* b1, const void* w2, const void* b2,
                   const void* sid, const void* rid, const void* seed,
                   unsigned thresh, float scale, void* out, long long q,
                   int n_rows, int feat, int hidden, cudaStream_t s) {
  using T = float;
  head_fwd_kernel<T, false><<<sgs::ceil_div_ll(q, BM), kThreads, 0, s>>>(
      static_cast<const T*>(h), static_cast<const T*>(w1a),
      static_cast<const T*>(w1b), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<const int*>(sid), static_cast<const int*>(rid), nullptr,
      nullptr, 0, 1, static_cast<const int*>(seed), thresh, scale,
      static_cast<float*>(out), q, n_rows, feat, hidden);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* h, const void* w1a, const void* w1b,
               const void* b1, const void* w2, const void* b2,
               const void* sid, const void* rid, const void* dp,
               const void* seed, unsigned thresh, float scale, void* dz1,
               void* dh, void* dw1a, void* dw1b, void* db1, void* dw2,
               void* db2, long long q, int n_rows, int feat, int hidden,
               cudaStream_t s) {
  const int sms = sgs::sm_count();
  const long long tiles = (q + BM - 1) / BM;
  const int grid1 = static_cast<int>(tiles < 2LL * sms ? tiles : 2LL * sms);
  const size_t smem = 2 * static_cast<size_t>(hidden) * sizeof(float);
  head_bwd_edge_kernel<T><<<grid1, kThreads, smem, s>>>(
      static_cast<const T*>(h), static_cast<const T*>(w1a),
      static_cast<const T*>(w1b), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<const int*>(sid), static_cast<const int*>(rid),
      static_cast<const float*>(dp), static_cast<const int*>(seed), thresh,
      scale, static_cast<T*>(dz1), static_cast<float*>(dh),
      static_cast<float*>(db1), static_cast<float*>(dw2),
      static_cast<float*>(db2), q, n_rows, feat, hidden);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int ftiles = sgs::ceil_div_ll(feat, WM);
  const int ktiles = sgs::ceil_div_ll(hidden, BN);
  const long long per_grid = 2LL * ftiles * ktiles;
  long long splits = (2LL * sms + per_grid - 1) / per_grid;
  const long long max_splits = (q + BK - 1) / BK;
  if (splits > max_splits) splits = max_splits;
  if (splits > 32767) splits = 32767;      // gridDim.z <= 65535
  if (splits < 1) splits = 1;
  long long per_split = (q + splits - 1) / splits;
  per_split = (per_split + BK - 1) / BK * BK;
  splits = (q + per_split - 1) / per_split;
  const dim3 grid2(ftiles, ktiles, static_cast<unsigned>(2 * splits));
  head_bwd_weight_kernel<T><<<grid2, kThreads, 0, s>>>(
      static_cast<const T*>(h), static_cast<const int*>(sid),
      static_cast<const int*>(rid), static_cast<const T*>(dz1),
      static_cast<float*>(dw1a), static_cast<float*>(dw1b), q, n_rows, feat,
      hidden, per_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K3. bf16 h goes to the tensor cores (head_mma.cuh: h rows `pitch`
// elements apart, W1 as the packed image `wpack`); f32 h to the CUDA-core
// kernel (w1a / w1b).
extern "C" int sgs_score_head_fwd(const void* h, int h_bf16, int pitch,
                                  const void* w1a, const void* w1b,
                                  const void* wpack, const void* b1,
                                  const void* w2, const void* b2,
                                  const void* sid, const void* rid,
                                  const void* seed, unsigned thresh,
                                  float scale, void* out, long long q,
                                  int n_rows, int feat, int hidden,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h_bf16)
    return sgs::mma::launch<false>(h, pitch, wpack, b1, w2, b2, sid, rid,
                                   nullptr, nullptr, 0, 1, seed, thresh,
                                   scale, out, q, n_rows, feat, hidden, s);
  return launch_fwd_f32(h, w1a, w1b, b1, w2, b2, sid, rid, seed, thresh,
                        scale, out, q, n_rows, feat, hidden, s);
}

// K5. bf16 h goes to the tensor cores (head_bwd_mma.cuh: h rows `pitch`
// elements apart, W1 as the packed images `wpack` and `wpack_t`, dz1 the
// scratch image of every 128-edge tile); f32 h to the CUDA-core kernels
// (w1a / w1b, dz1 a (q, K) scratch).
extern "C" int sgs_score_head_bwd(const void* h, int h_bf16, int pitch,
                                  const void* w1a, const void* w1b,
                                  const void* wpack, const void* wpack_t,
                                  const void* b1, const void* w2,
                                  const void* b2, const void* sid,
                                  const void* rid, const void* dp,
                                  const void* seed, unsigned thresh,
                                  float scale, void* dz1, void* dh,
                                  void* dw1a, void* dw1b, void* db1,
                                  void* dw2, void* db2, long long q,
                                  int n_rows, int feat, int hidden,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h_bf16)
    return sgs::mma::launch_bwd(h, pitch, wpack, wpack_t, b1, w2, b2, sid,
                                rid, dp, seed, thresh, scale, dz1, dh, dw1a,
                                dw1b, db1, dw2, db2, q, n_rows, feat, hidden,
                                s);
  return launch_bwd<float>(h, w1a, w1b, b1, w2, b2, sid, rid, dp, seed,
                           thresh, scale, dz1, dh, dw1a, dw1b, db1, dw2, db2,
                           q, n_rows, feat, hidden, s);
}

extern "C" int sgs_dropout_bits(const void* seed, const void* counters,
                                void* out, long long n, void* stream) {
  const int threads = 256;
  dropout_bits_kernel<<<sgs::ceil_div_ll(n, threads), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(seed),
      static_cast<const long long*>(counters), static_cast<long long*>(out),
      n);
  return static_cast<int>(cudaGetLastError());
}
