// K6, sgs_score_head_tiles: the edge-score head over every slot of the
// tile-pair index, in tile order, with dropout; f32 probabilities out.
//
// Replaces sgs_gnn_tpu/ops/score_tiles.py:_make_kernel (behind
// _score_tiles_call). On the TPU each 512-slot block touched exactly one
// (T, F) tile of h per endpoint side, which BlockSpecs brought into VMEM,
// and its rows were selected by (T, B) one-hot matmuls on the MXU. Here the
// slot's global ids are su[b]*t + ls and rv[b]*t + lr, and the slots'
// rows are gathered from h (1 MB, L2-resident) with the same head code and
// dropout mask as K3: the counter of a unit is the slot's position in the
// (Ep,) list times K plus the unit, so the mask depends on neither block
// size. Padding slots are scored too (the sampler drops them through
// tile_mask); ids past N read zero rows, as the TPU's zero-padded h gives.
// Bound: operations, 2*(2F*K) per slot (~0.28 ms at Ep = 1,065,984,
// F=K=256, on the bf16 tensor cores). bf16 h runs on the tensor cores
// (head_mma.cuh, 128-slot tiles that gather their rows as K3's do; staging
// the two (t, F) tiles of a 512-slot block in shared memory would take
// 128 KB beside the 128 KB weight ring), f32 h on CUDA cores
// (score_head.cuh).
#include "head_mma.cuh"
#include "score_head.cuh"

namespace {

using namespace sgs::head;

int launch_f32(const void* h, const void* w1a, const void* w1b,
               const void* b1, const void* w2, const void* b2,
               const void* ls, const void* lr, const void* su,
               const void* rv, int tile_t, int tile_b, const void* seed,
               unsigned thresh, float scale, void* out, long long ep,
               int n_rows, int feat, int hidden, cudaStream_t s) {
  using T = float;
  head_fwd_kernel<T, true><<<sgs::ceil_div_ll(ep, BM), kThreads, 0, s>>>(
      static_cast<const T*>(h), static_cast<const T*>(w1a),
      static_cast<const T*>(w1b), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<const int*>(ls), static_cast<const int*>(lr),
      static_cast<const int*>(su), static_cast<const int*>(rv), tile_t,
      tile_b, static_cast<const int*>(seed), thresh, scale,
      static_cast<float*>(out), ep, n_rows, feat, hidden);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 h goes to the tensor cores (rows `pitch` elements apart, W1 as the
// packed image `wpack`), f32 h to the CUDA-core kernel (w1a / w1b).
extern "C" int sgs_score_head_tiles(const void* h, int h_bf16, int pitch,
                                    const void* w1a, const void* w1b,
                                    const void* wpack, const void* b1,
                                    const void* w2, const void* b2,
                                    const void* ls, const void* lr,
                                    const void* su, const void* rv,
                                    int tile_t, int tile_b, const void* seed,
                                    unsigned thresh, float scale, void* out,
                                    long long ep, int n_rows, int feat,
                                    int hidden, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h_bf16)
    return sgs::mma::launch<true>(h, pitch, wpack, b1, w2, b2, ls, lr, su,
                                  rv, tile_t, tile_b, seed, thresh, scale,
                                  out, ep, n_rows, feat, hidden, s);
  return launch_f32(h, w1a, w1b, b1, w2, b2, ls, lr, su, rv, tile_t, tile_b,
                    seed, thresh, scale, out, ep, n_rows, feat, hidden, s);
}
