// rows_at: out[e, :] = TOut(g[ids[e], :]) where 0 <= ids[e] < n, else 0;
// g f32 (the cotangent of an f32 sum), TOut the summed values' f32 or bf16.
//
// The VJP of both segment sums (K1 scatter_add, K2 segment_sum_scalar):
// the cotangent rows at the ids, zero for the ids the sum dropped, written
// in the summed values' dtype. No TPU kernel of the JAX package does this:
// there the VJP is XLA's g[ids] (scatter_pallas.py:332-333). It replaces a
// library chain of about eight launches (the in-range mask, a clamp, an
// int64 copy of the ids, an f32 gather, a broadcast where, a cast), which
// moved ~18 bytes of device memory per element for a result of 2 (bf16) or
// 4 (f32).
//
// Bound: the bytes written. g is N x F f32 with N a partition's nodes
// (~2k: ~2 MB at F = 256), so its rows come from L2; each output element is
// written once (E = 200k, F = 256 bf16: 102 MB, ~0.031 ms at 3.35 TB/s).
// Design:
// - one pass over the output in units of kVec elements: 16 bytes of output
//   a unit (8 bf16 or 4 f32) where F is a multiple of kVec and g is 16-byte
//   aligned, one element a unit otherwise (F = 41, F = 1 for K2's (N,) g);
// - consecutive threads take consecutive units, so a warp stores 512
//   contiguous bytes on the vector route; the lanes that share a row load
//   its id from the same address, one broadcast transaction;
// - a grid-stride loop over a grid that fills every SM;
// - bf16 is rounded to nearest even (__float2bfloat16_rn), as PyTorch's
//   cast, so the result is bit for bit the library chain's.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;     // 2048 threads: a full SM

template <typename T, int kVec>
struct alignas(sizeof(T) * kVec < 16 ? sizeof(T) * kVec : 16) Pack {
  T v[kVec];
};

template <typename TOut>
__device__ __forceinline__ TOut convert(float x);
template <>
__device__ __forceinline__ float convert<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 convert<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Index: unsigned (units below 2^31) or unsigned long long.
template <typename TOut, int kVec, typename Index>
__global__ void __launch_bounds__(kThreads)
rows_at_kernel(const float* __restrict__ g, const int* __restrict__ ids,
               TOut* __restrict__ out, Index units, Index row_units,
               long long cols, int num_segments) {
  using In = Pack<float, kVec>;
  using Out = Pack<TOut, kVec>;
  const Index stride = static_cast<Index>(gridDim.x) * kThreads;
  for (Index u = static_cast<Index>(blockIdx.x) * kThreads + threadIdx.x;
       u < units; u += stride) {
    const Index row = u / row_units;
    const Index col = (u - row * row_units) * kVec;
    const int id = __ldg(ids + row);
    Out o;
    if (id >= 0 && id < num_segments) {
      const In v = *reinterpret_cast<const In*>(
          g + static_cast<long long>(id) * cols + col);
#pragma unroll
      for (int k = 0; k < kVec; ++k) o.v[k] = convert<TOut>(v.v[k]);
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k) o.v[k] = convert<TOut>(0.f);
    }
    *reinterpret_cast<Out*>(out + static_cast<long long>(row) * cols + col) =
        o;
  }
}

template <typename TOut, int kVec>
cudaError_t launch(const void* g, const void* ids, void* out, long long rows,
                   long long cols, int num_segments, cudaStream_t stream) {
  const long long row_units = cols / kVec;
  const long long units = rows * row_units;
  const long long want = (units + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(
      want < sgs::sm_count() * kBlocksPerSm ? want
                                            : sgs::sm_count() * kBlocksPerSm);
  const float* gp = static_cast<const float*>(g);
  const int* ip = static_cast<const int*>(ids);
  TOut* op = static_cast<TOut*>(out);
  if (units < (1ll << 31)) {
    rows_at_kernel<TOut, kVec, unsigned><<<blocks, kThreads, 0, stream>>>(
        gp, ip, op, static_cast<unsigned>(units),
        static_cast<unsigned>(row_units), cols, num_segments);
  } else {
    rows_at_kernel<TOut, kVec, unsigned long long>
        <<<blocks, kThreads, 0, stream>>>(
            gp, ip, op, static_cast<unsigned long long>(units),
            static_cast<unsigned long long>(row_units), cols, num_segments);
  }
  return cudaGetLastError();
}

template <typename TOut>
cudaError_t dispatch(const void* g, const void* ids, void* out,
                     long long rows, long long cols, int num_segments,
                     int vector, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(TOut);
  if (vector)
    return launch<TOut, kVec>(g, ids, out, rows, cols, num_segments,
                              stream);
  return launch<TOut, 1>(g, ids, out, rows, cols, num_segments, stream);
}

}  // namespace

// g: (num_segments, cols) f32, contiguous; ids: int32 (rows,); out: (rows,
// cols) f32 or bf16 (out_bf16), contiguous, every element written. vector:
// 1 if cols is a multiple of 16 / sizeof(out's element) and g is 16-byte
// aligned (ops/scatter.py rows_at_cast picks it). rows, cols > 0.
extern "C" int sgs_rows_at(const void* g, const void* ids, void* out,
                           int out_bf16, long long rows, int cols,
                           int num_segments, int vector, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      out_bf16 ? dispatch<__nv_bfloat16>(g, ids, out, rows, cols,
                                         num_segments, vector, s)
               : dispatch<float>(g, ids, out, rows, cols, num_segments,
                                 vector, s);
  return static_cast<int>(err);
}
