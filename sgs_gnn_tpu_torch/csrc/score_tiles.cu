// K6, sgs_score_head_tiles: the edge-score head over every slot of the
// tile-pair index, in tile order, with dropout; f32 probabilities out.
//
// Replaces sgs_gnn_tpu/ops/score_tiles.py:_make_kernel (behind
// _score_tiles_call). On the TPU each 512-slot block touched exactly one
// (T, F) tile of h per endpoint side, which BlockSpecs brought into VMEM,
// and its rows were selected by (T, B) one-hot matmuls on the MXU. Here the
// slot's global ids are su[b]*t + ls and rv[b]*t + lr, and the block of 64
// slots gathers their rows from h (1 MB, L2-resident) with the same head
// code and dropout mask as K3 (score_head.cuh): the counter of a unit is
// the slot's position in the (Ep,) list times K plus the unit, so the mask
// depends on neither block size. Padding slots are scored too (the sampler
// drops them through tile_mask); ids past N read zero rows, as the TPU's
// zero-padded h gives. Staging the two (t, F) tiles in shared memory is
// left for the kernel redesign.
// Bound: operations, 2*(2F*K) per slot (~0.28 ms at Ep = 1,065,984,
// F=K=256, on the bf16 tensor cores); this version runs f32 FMAs on CUDA
// cores.
#include "score_head.cuh"

namespace {

using namespace sgs::head;

template <typename T>
int launch(const void* h, const void* w1a, const void* w1b, const void* b1,
           const void* w2, const void* b2, const void* ls, const void* lr,
           const void* su, const void* rv, int tile_t, int tile_b,
           const void* seed, unsigned thresh, float scale, void* out,
           long long ep, int n_rows, int feat, int hidden, cudaStream_t s) {
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

extern "C" int sgs_score_head_tiles(const void* h, int h_bf16,
                                    const void* w1a, const void* w1b,
                                    const void* b1, const void* w2,
                                    const void* b2, const void* ls,
                                    const void* lr, const void* su,
                                    const void* rv, int tile_t, int tile_b,
                                    const void* seed, unsigned thresh,
                                    float scale, void* out, long long ep,
                                    int n_rows, int feat, int hidden,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h_bf16)
    return launch<__nv_bfloat16>(h, w1a, w1b, b1, w2, b2, ls, lr, su, rv,
                                 tile_t, tile_b, seed, thresh, scale, out, ep,
                                 n_rows, feat, hidden, s);
  return launch<float>(h, w1a, w1b, b1, w2, b2, ls, lr, su, rv, tile_t,
                       tile_b, seed, thresh, scale, out, ep, n_rows, feat,
                       hidden, s);
}
