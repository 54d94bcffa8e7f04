// The edge-score head's backward on Hopper's tensor cores, for bf16 h: the
// bf16 route of K5 (score_sampled.cu, sgs_score_head_bwd). It computes what
// score_head_bwd_plain (ops/score_sampled.py) computes, with the JAX
// kernel's cast points and the forward's counter-based mask:
//
//   z1    = bf16(hu*hv) @ W1a + bf16(hu-hv) @ W1b + b1                (f32)
//   zd    = drop(relu(z1)); p = sigmoid(zd . w2 + b2); dl = dp p (1 - p)
//   db2  += sum dl; dw2 += sum zd dl; dz1 = [z1 > 0] drop'(dl w2)
//   db1  += sum dz1
//   dz1c  = bf16(dz1)
//   dW1a += bf16(hu*hv)^T dz1c;  dW1b += bf16(hu-hv)^T dz1c
//   dhu   = bf16(dz1c W1a^T * hv + dz1c W1b^T); dhv = bf16(dz1c W1a^T * hu
//           - dz1c W1b^T); dh[s] += dhu; dh[r] += dhv                  (f32)
//
// Replaces sgs_gnn_tpu/ops/score_sampled.py:_make_bwd_kernel (:184, behind
// _bwd_call's full :403 and banded :429 calls) in bf16; f32 h keeps the
// CUDA-core kernels of score_sampled.cu (the tensor cores have no full-f32
// product). Bound: operations, three products of 2 (2F K) flops per edge on
// the bf16 tensor cores (F=K=256: 0.16 ms at q=200k on an H100 SXM). The
// CUDA-core kernels ran all three as f32 FMAs (14 TFLOP/s); here each is a
// wgmma with f32 accumulators, in three kernels on the stream:
//
//  1. dz1 pass (head_bwd_mma_dz1_kernel): the forward's kernel
//     (head_mma.cuh: 128-edge tiles, two consumer warpgroups, W1 streamed
//     through the bulk-copy ring, gathered A_prod / A_diff) with a new
//     epilogue. After the logits (a quad shuffle per row) the accumulator
//     registers still hold z1 when K <= 256; for a larger K a second sweep
//     recomputes z1 per K tile. Each unit's keep bit is computed once and
//     serves zd and dz1. dz1c goes to the scratch image below; the db1 and
//     dw2 partials of a tile's columns are reduce-scattered over the eight
//     lanes that share a column (three shuffle levels, 112 shuffles a tile
//     instead of 384 for a plain reduction), summed in shared memory and
//     flushed once per block.
//  2. dh pass (head_bwd_mma_dh_kernel): per 128-edge tile and feature part
//     of 128, dprod = dz1c W1a^T and ddiff = dz1c W1b^T (m64n128k16, two
//     accumulators of 64 registers), the reduction over hidden chunks of 64
//     streamed by bulk copies: 16 copies of 1 KB of the dz1 image (no
//     gather, no re-layout) and one of 32 KB of the transposed weight image
//     (ops/head_mma.py pack_head_weights_t) per ring stage. The epilogue
//     reads hu / hv at its columns from L2, rounds dh_u / dh_v to bf16,
//     adds dh_v with float2 atomics and stages dh_u in shared memory, where
//     runs of equal ids on the sorted side are merged before one atomic per
//     run and column (a hub of 36,169 in-edges would otherwise serialise
//     one atomic per edge on one row in L2).
//  3. weight pass (head_bwd_mma_dw_kernel): a block owns one 64-feature
//     chunk, one K tile and a range of edges (q split so the grid is about
//     one wave); warpgroup 0 accumulates dW1a, warpgroup 1 dW1b (64 x 256
//     f32 each). A = prod^T / diff^T: the gathered rows in the forward's
//     (edge, feature) image read MN-major; B = the dz1 image's (64 edges x
//     256 hidden) block read MN-major, one bulk copy of 32 KB. Both
//     warpgroups gather for each other (each thread writes both A halves of
//     its segments), three A buffers with one barrier of the 256 consumer
//     threads per chunk. Blocks of one edge range are adjacent in the grid,
//     so the four feature chunks read each dz1 block from L2 together.
//     One flush of float2 atomics per block.
//
// The dz1 scratch image (ops/head_mma.py dz1_offset): per block of 64
// edges and K tile of 256, the 8-edge groups (4096 bytes apart) of 32 core
// matrices of 8 edges x 8 hidden columns (128 bytes apart). Read K-major
// with the edges as rows, it is the dh pass's A operand (lbo 128, sbo
// 4096); read MN-major with the edges as k, the weight pass's B operand:
// an (edge, hidden) core matrix of a K-major A image holds the same bytes
// as the MN-major B image of (k = edge, n = hidden).
#pragma once

#include "head_mma.cuh"

namespace sgs {
namespace mma {

constexpr int kFPart = 128;        // features per dh-pass accumulator
constexpr int kBwdStages = 3;      // ring depth of the dh and weight passes
constexpr int kSplitChunk = 64;    // edges per weight-pass chunk
constexpr int kDz1Block = kWgRows * kN;         // elements per (64, K tile)
constexpr int kDz1Group = 8 * kN;               // elements per 8-edge group
// MN-major no-swizzle descriptors: lbo steps 8 rows of k (edges), sbo 8
// columns of m or n (features, hidden)
constexpr uint32_t kMnLboA = 8 * kChunk * 2;    // A_prod / A_diff: 1024
constexpr uint32_t kMnSboA = kCoreBytes;        // 128
constexpr uint32_t kMnLboB = kDz1Group * 2;     // dz1 block: 4096
constexpr uint32_t kMnSboB = kCoreBytes;        // 128

// dz1 pass: the forward's layout, then 2K + 1 floats (db1, dw2, db2) and
// the (b1, w2) pairs of the padded columns (zero past K)
constexpr int kDz1Red = kSmemBytes;
__host__ __device__ inline int dz1_bw_offset(int hidden) {
  return kDz1Red + (2 * hidden + 4) * 4;
}
inline int dz1_smem_bytes(int hidden) {
  return dz1_bw_offset(hidden) + ((hidden + kN - 1) / kN) * kN * 8;
}

// dh pass: ring stages of (dz1 chunk of the tile's 128 edges x 64 hidden,
// W1a^T and W1b^T chunks of 128 features x 64 hidden), the dh_u staging
// rows (padded: a quad's float2 stores of 8 rows fill two wavefronts), the
// sorted side's ids, the ring's barriers
constexpr int kDhA = kRows * kChunk * 2;             // 16,384
constexpr int kDhBHalf = kFPart * kChunk * 2;        // 16,384
constexpr int kDhBElems = 2 * kFPart * kChunk;      // one W1^T chunk
constexpr int kDhStage = kDhA + 2 * kDhBHalf;        // 49,152
constexpr int kStageRow = kFPart + 8;                // floats per row
constexpr int kDhStaging = kBwdStages * kDhStage;    // 147,456
constexpr int kDhIds = kDhStaging + 2 * kWgRows * kStageRow * 4;
constexpr int kDhBar = kDhIds + kRows * 4;
constexpr int kDhSmem = kDhBar + 2 * kBwdStages * 8;   // 217,648
static_assert(kDhSmem <= 232448, "one block per SM");

// weight pass: ring of dz1 blocks (64 edges x 256 hidden), three A buffers
// of (A_prod, A_diff) for 64 edges x 64 features, the ring's barriers
constexpr int kDwB = kSplitChunk * kN * 2;           // 32,768
constexpr int kDwAHalf = kSplitChunk * kChunk * 2;   // 8,192
constexpr int kDwABuf = 2 * kDwAHalf;
constexpr int kDwA = kBwdStages * kDwB;
constexpr int kDwBar = kDwA + kBwdStages * kDwABuf;
constexpr int kDwSmem = kDwBar + 2 * kBwdStages * 8;   // 147,504
static_assert(kDwSmem <= 232448, "one block per SM");

// Adds (a, b) to p[0], p[1] (b only where `second`): one float2 atomic when
// the pair is 8-byte aligned (`pairs`: an even row length).
__device__ __forceinline__ void add_pair(float* p, float a, float b,
                                         bool second, bool pairs) {
  if (pairs) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(a, b));
  } else {
    atomicAdd(p, a);
    if (second) atomicAdd(p + 1, b);
  }
}

// *addr += v for an f32 in shared memory at (32-bit) address `addr`
__device__ __forceinline__ void red_shared_add(uint32_t addr, float v) {
  asm volatile("red.shared.add.f32 [%0], %1;\n" :: "r"(addr), "f"(v)
               : "memory");
}

__device__ __forceinline__ float2 ld_shared_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}

// The bf16 pair at columns col, col + 1 of row `id` of h (zero for row -1
// or col past feat; col is even and pitch a multiple of 8).
__device__ __forceinline__ float2 h_pair(const __nv_bfloat16* __restrict__ h,
                                         int pitch, int id, int col,
                                         int feat) {
  if (id < 0 || col >= feat) return make_float2(0.f, 0.f);
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
      h + static_cast<long long>(id) * pitch + col));
}

// The dz1 pass's epilogue of one K tile (columns n0 ...): dz1c of this
// thread's rows r0 and r0 + 8 into the image block `blk` of its warpgroup's
// 64 rows, and the tile's db1 / dw2 column partials added to the shared
// floats at `red` ([0, K): db1, [K, 2K): dw2). `bw`: the shared (b1, w2)
// pairs, zero past K (so padding columns give zeros without a test). Each
// lane holds columns n0 + 8 j + 2 (lane % 4) + {0, 1}; the eight lanes
// that share them (lane bits 2-4) reduce-scatter their four values per
// column pair: bit 2 picks db1 or dw2, bit 3 the column of the pair, bit 4
// the parity of j, and each pair of j's ends in one shared add per lane.
template <DropMode kMode>
__device__ __forceinline__ void tile_dz1(
    const float (&acc)[128], const float (&dl)[2], uint32_t bw, int n0,
    int hidden, const unsigned long long (&rowc)[2],
    const uint32_t (&inner)[2], uint32_t seed, uint32_t thresh, float scale,
    __nv_bfloat16* __restrict__ blk, uint32_t red, int r0, int lane) {
  const int q4 = lane & 3;
  const int cbase = n0 + 2 * q4;
  const bool bit2 = (lane >> 2) & 1;
  const bool bit3 = (lane >> 3) & 1;
  const bool bit4 = (lane >> 4) & 1;
  // rows r0 and r0 + 8 in the block: (row / 8) * 8 kN + (row % 8) * 8
  const int rowoff = (r0 >> 3) * kDz1Group + (r0 & 7) * 8;
  const uint32_t dst = red + (bit2 ? 4 * hidden : 0);
  float hold = 0.f;
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    float v[2][2];     // [db1, dw2][x]
    float dz[2][2];    // [r][x]
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int col = cbase + 8 * j + x;
      const float2 p = ld_shared_f2(bw + 8 * col);   // (b1, w2)
      v[0][x] = 0.f;
      v[1][x] = 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float z = acc[4 * j + 2 * r + x] + p.x;
        const float zr = fmaxf(z, 0.f);
        const float dzr = dl[r] * p.y;
        float zd = zr, d = dzr;
        if (kMode != kNoDrop) {
          // one keep bit for both uses
          const bool kept =
              unit_kept<kMode>(rowc[r], col, inner[r], seed, thresh);
          zd = kept ? zr * scale : 0.f;
          d = kept ? dzr * scale : 0.f;
        }
        d = z > 0.f ? d : 0.f;
        v[0][x] += d;
        v[1][x] += zd * dl[r];
        dz[r][x] = d;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<__nv_bfloat162*>(blk + rowoff + r * kDz1Group +
                                         j * 64 + 2 * q4) =
          __floats2bfloat162_rn(dz[r][0], dz[r][1]);
    float w[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const float send = bit2 ? v[0][x] : v[1][x];
      const float keep = bit2 ? v[1][x] : v[0][x];
      w[x] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
    }
    const float send = bit3 ? w[0] : w[1];
    const float keep = bit3 ? w[1] : w[0];
    const float u = keep + __shfl_xor_sync(0xffffffffu, send, 8);
    if ((j & 1) == 0) {
      hold = u;
    } else {
      const float send4 = bit4 ? hold : u;
      const float keep4 = bit4 ? u : hold;
      const float sum = keep4 + __shfl_xor_sync(0xffffffffu, send4, 16);
      const int col = cbase + 8 * (j - 1 + bit4) + bit3;
      if (col < hidden) red_shared_add(dst + 4 * col, sum);
    }
  }
}

// dz1 pass over q edge slots (sid sorted or not), bf16 h with rows `pitch`
// elements apart, W1 packed by pack_head_weights; writes every row of every
// 128-edge tile of the dz1 image (zeros past q and past K) and adds db1,
// dw2, db2. Persistent, as head_mma_kernel. kOneTile: K <= 256, one K tile
// whose z1 the accumulators still hold after the logits (the bench's
// width); else the logits' sweep over the K tiles and a second that
// recomputes z1 per tile.
template <bool kOneTile>
__global__ void __launch_bounds__(kThreads, 1)
head_bwd_mma_dz1_kernel(const __nv_bfloat16* __restrict__ h, int pitch,
                        const __nv_bfloat16* __restrict__ wpack,
                        const float* __restrict__ b1,
                        const float* __restrict__ w2,
                        const float* __restrict__ b2,
                        const int* __restrict__ sid,
                        const int* __restrict__ rid,
                        const float* __restrict__ dp,
                        const int* __restrict__ seed_p, uint32_t thresh,
                        float scale, __nv_bfloat16* __restrict__ dz1,
                        float* __restrict__ db1, float* __restrict__ dw2,
                        float* __restrict__ db2, long long q, int n_rows,
                        int chunks, int hidden, int ktiles) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const uint32_t sbase = smem_u32(smem);
  const uint32_t full0 = sbase + kSmemBar;
  const uint32_t empty0 = full0 + 8 * kStages;
  const uint32_t red_s = sbase + kDz1Red;
  for (int i = tid; i < 2 * hidden + 1; i += kThreads)
    reinterpret_cast<float*>(smem + kDz1Red)[i] = 0.f;
  const int nkt = kOneTile ? 1 : ktiles;
  const int bw_off = dz1_bw_offset(hidden);
  const uint32_t bw_s = sbase + bw_off;
  for (int c = tid; c < nkt * kN; c += kThreads)
    reinterpret_cast<float2*>(smem + bw_off)[c] =
        c < hidden ? make_float2(b1[c], w2[c]) : make_float2(0.f, 0.f);
  init_ring(full0, empty0);
  __syncthreads();
  const long long tiles = (q + kRows - 1) / kRows;
  const int period = nkt * chunks;
  if (warp >= kConsumers / 32) {
    // the logits' sweep over every K tile, then (K > 256) a second sweep
    weight_producer(wpack, sbase, full0, empty0, tiles,
                    kOneTile ? period : 2 * period, period);
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(kConsumerRegs));
  const int wg = warp >> 2;
  const int wwarp = warp & 3;
  const uint32_t abase = sbase + kSmemA + wg * 2 * kABufBytes;
  Gather gt;
  gt.init(wwarp, lane);
  const int r0 = 16 * wwarp + (lane >> 2);
  const uint32_t seed = static_cast<uint32_t>(seed_p[0]);
  const float bias2 = b2[0];
  long long g = 0;

  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long e_wg = t * kRows + wg * kWgRows;
    tile_rows<false>(gt, e_wg, q, sid, rid, nullptr, nullptr, 0, 1, n_rows);
    float acc[128];
    float logit[2] = {0.f, 0.f};
    for (int kt = 0; kt < nkt; ++kt) {
      ktile_mma(acc, h, pitch, gt, abase, sbase, full0, empty0, chunks, wg,
                g);
      const int n0 = kt * kN;
      unsigned long long rowc[2];
      uint32_t inner[2];
      row_counters(e_wg, r0, hidden, n0, seed, rowc, inner);
      const bool hoist = tile_hoist(t, hidden, n0);
      float part[2] = {0.f, 0.f};
      if (thresh == 0u)
        tile_logits<kNoDrop>(acc, part, b1, w2, n0, hidden, rowc, inner,
                             seed, thresh, scale);
      else if (hoist)
        tile_logits<kHoisted>(acc, part, b1, w2, n0, hidden, rowc, inner,
                              seed, thresh, scale);
      else
        tile_logits<kPerUnit>(acc, part, b1, w2, n0, hidden, rowc, inner,
                              seed, thresh, scale);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        part[r] += __shfl_xor_sync(0xffffffffu, part[r], 1);
        part[r] += __shfl_xor_sync(0xffffffffu, part[r], 2);
        logit[r] += part[r];
      }
    }
    // dlogit of rows r0 and r0 + 8 (every lane of the quad), db2's share
    float dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long e = e_wg + r0 + 8 * r;
      const float p = 1.f / (1.f + expf(-(logit[r] + bias2)));
      dl[r] = e < q ? dp[e] * p * (1.f - p) : 0.f;
    }
    float sum = (lane & 3) == 0 ? dl[0] + dl[1] : 0.f;
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) red_shared_add(red_s + 8 * hidden, sum);

    __nv_bfloat16* img = dz1 + (2 * t + wg) * kDz1Block * nkt;
    for (int kt = 0; kt < nkt; ++kt) {
      if (!kOneTile)
        ktile_mma(acc, h, pitch, gt, abase, sbase, full0, empty0, chunks, wg,
                  g);
      const int n0 = kt * kN;
      unsigned long long rowc[2];
      uint32_t inner[2];
      row_counters(e_wg, r0, hidden, n0, seed, rowc, inner);
      const bool hoist = tile_hoist(t, hidden, n0);
      __nv_bfloat16* blk = img + kt * kDz1Block;
      if (thresh == 0u)
        tile_dz1<kNoDrop>(acc, dl, bw_s, n0, hidden, rowc, inner, seed,
                          thresh, scale, blk, red_s, r0, lane);
      else if (hoist)
        tile_dz1<kHoisted>(acc, dl, bw_s, n0, hidden, rowc, inner, seed,
                           thresh, scale, blk, red_s, r0, lane);
      else
        tile_dz1<kPerUnit>(acc, dl, bw_s, n0, hidden, rowc, inner, seed,
                           thresh, scale, blk, red_s, r0, lane);
    }
  }
  consumers_sync();
  const float* red = reinterpret_cast<const float*>(smem + kDz1Red);
  for (int i = tid; i < hidden; i += kConsumers) {
    atomicAdd(db1 + i, red[i]);
    atomicAdd(dw2 + i, red[hidden + i]);
  }
  if (tid == 0) atomicAdd(db2, red[2 * hidden]);
}

// dh pass over the 128-edge tiles of the dz1 image (kp: K padded to 256),
// W1^T packed by pack_head_weights_t; sid is the sorted side. Persistent.
__global__ void __launch_bounds__(kThreads, 1)
head_bwd_mma_dh_kernel(const __nv_bfloat16* __restrict__ h, int pitch,
                       const __nv_bfloat16* __restrict__ dz1,
                       const __nv_bfloat16* __restrict__ wpack_t,
                       const int* __restrict__ sid,
                       const int* __restrict__ rid, float* __restrict__ dh,
                       long long q, int n_rows, int feat, int kp) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const uint32_t sbase = smem_u32(smem);
  const uint32_t full0 = sbase + kDhBar;
  const uint32_t empty0 = full0 + 8 * kBwdStages;
  init_ring<kBwdStages>(full0, empty0);
  __syncthreads();
  const long long tiles = (q + kRows - 1) / kRows;
  const int parts = (feat + kFPart - 1) / kFPart;
  const int hchunks = kp / kChunk;

  if (warp >= kConsumers / 32) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    if (tid != kConsumers) return;
    long long g = 0;
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x)
      for (int p = 0; p < parts; ++p)
        for (int hc = 0; hc < hchunks; ++hc, ++g) {
          const int s = static_cast<int>(g % kBwdStages);
          if (g >= kBwdStages)
            mbar_wait(empty0 + 8 * s,
                      static_cast<uint32_t>(g / kBwdStages - 1) & 1u);
          const uint32_t bar = full0 + 8 * s;
          const uint32_t st = sbase + s * kDhStage;
          mbar_expect_tx(bar, kDhStage);
          // the tile's 16 8-edge groups, 8 hidden groups (1 KB) each
          for (int grp = 0; grp < kRows / 8; ++grp) {
            const long long eb = 2 * t + (grp >> 3);
            bulk_load(st + grp * 8 * kCoreBytes,
                      dz1 + eb * kWgRows * kp + (hc >> 2) * kDz1Block +
                          (grp & 7) * kDz1Group + (hc & 3) * 8 * kChunk,
                      8 * kCoreBytes, bar);
          }
          bulk_load(st + kDhA,
                    wpack_t + static_cast<long long>(p * hchunks + hc) *
                                  kDhBElems,
                    2 * kDhBHalf, bar);
        }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(kConsumerRegs));
  const int wg = warp >> 2;
  const int wwarp = warp & 3;
  const int wtid = tid & 127;
  const int r0 = 16 * wwarp + (lane >> 2);
  const int q4 = lane & 3;
  const bool pairs = (feat & 1) == 0;
  float* stg = reinterpret_cast<float*>(smem + kDhStaging) +
               wg * kWgRows * kStageRow;
  int* ids = reinterpret_cast<int*>(smem + kDhIds) + wg * kWgRows;
  long long g = 0;

  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long e_wg = t * kRows + wg * kWgRows;
    int sr[2], rr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long e = e_wg + r0 + 8 * r;
      sr[r] = e < q ? sgs::head::checked_id(sid[e], n_rows) : -1;
      rr[r] = e < q ? sgs::head::checked_id(rid[e], n_rows) : -1;
    }
    if (wtid < kWgRows) {
      const long long e = e_wg + wtid;
      ids[wtid] = e < q ? sgs::head::checked_id(sid[e], n_rows) : -1;
    }
    for (int p = 0; p < parts; ++p) {
      float dpr[64], ddf[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) dpr[i] = ddf[i] = 0.f;
      for (int hc = 0; hc < hchunks; ++hc, ++g) {
        const int s = static_cast<int>(g % kBwdStages);
        mbar_wait(full0 + 8 * s, static_cast<uint32_t>(g / kBwdStages) & 1u);
        const uint32_t st = sbase + s * kDhStage;
        const uint32_t a = st + wg * (kDhA / 2);
        const uint32_t b = st + kDhA;
        fence_acc(dpr);
        fence_acc(ddf);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < kChunk / 16; ++k) {
          wgmma_m64n128k16(dpr, desc(a + 256 * k), desc(b + 256 * k));
          wgmma_m64n128k16(ddf, desc(a + 256 * k),
                           desc(b + kDhBHalf + 256 * k));
        }
        wgmma_commit();
        fence_acc(dpr);
        fence_acc(ddf);
        wgmma_wait<1>();
        fence_acc(dpr);
        fence_acc(ddf);
        if (hc > 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(empty0 + 8 * ((g - 1) % kBwdStages));
        }
      }
      wgmma_wait<0>();
      fence_acc(dpr);
      fence_acc(ddf);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * ((g - 1) % kBwdStages));

      // dh_u / dh_v of this thread's rows and columns f0 + 8 j + 2 q4 + x:
      // the same f32 roundings as the plain version before the bf16 cast
      const int f0 = p * kFPart;
#pragma unroll
      for (int j = 0; j < kFPart / 8; ++j) {
        const int col = f0 + 8 * j + 2 * q4;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 hu = h_pair(h, pitch, sr[r], col, feat);
          const float2 hv = h_pair(h, pitch, rr[r], col, feat);
          const float dp0 = dpr[4 * j + 2 * r], dp1 = dpr[4 * j + 2 * r + 1];
          const float dd0 = ddf[4 * j + 2 * r], dd1 = ddf[4 * j + 2 * r + 1];
          const float2 du = make_float2(
              round_as<__nv_bfloat16>(__fadd_rn(__fmul_rn(dp0, hv.x), dd0)),
              round_as<__nv_bfloat16>(__fadd_rn(__fmul_rn(dp1, hv.y), dd1)));
          *reinterpret_cast<float2*>(stg + (r0 + 8 * r) * kStageRow + 8 * j +
                                     2 * q4) = du;
          if (rr[r] >= 0 && col < feat)
            add_pair(dh + static_cast<long long>(rr[r]) * feat + col,
                     round_as<__nv_bfloat16>(
                         __fsub_rn(__fmul_rn(dp0, hu.x), dd0)),
                     round_as<__nv_bfloat16>(
                         __fsub_rn(__fmul_rn(dp1, hu.y), dd1)),
                     col + 1 < feat, pairs);
        }
      }
      wg_sync(wg);
      // dh_u: runs of equal ids on the sorted side, one atomic per run and
      // column; thread wtid walks column f0 + wtid down the 64 rows
      const int col = f0 + wtid;
      if (col < feat) {
        int cur = -1;
        float run = 0.f;
        for (int row = 0; row < kWgRows; ++row) {
          const int s = ids[row];
          if (s != cur) {
            if (cur >= 0)
              atomicAdd(dh + static_cast<long long>(cur) * feat + col, run);
            cur = s;
            run = 0.f;
          }
          run += stg[row * kStageRow + wtid];
        }
        if (cur >= 0)
          atomicAdd(dh + static_cast<long long>(cur) * feat + col, run);
      }
      wg_sync(wg);
    }
  }
}

// weight pass: block (c, t, split) adds prod^T dz1c (warpgroup 0, into
// dW1a) and diff^T dz1c (warpgroup 1, dW1b) over edges [split * per_split,
// ...) for features 64 c ... and hidden columns 256 t ...
__global__ void __launch_bounds__(kThreads, 1)
head_bwd_mma_dw_kernel(const __nv_bfloat16* __restrict__ h, int pitch,
                       const __nv_bfloat16* __restrict__ dz1,
                       const int* __restrict__ sid,
                       const int* __restrict__ rid,
                       float* __restrict__ dw1a, float* __restrict__ dw1b,
                       long long q, int n_rows, int feat, int hidden, int kp,
                       long long per_split) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const uint32_t sbase = smem_u32(smem);
  const uint32_t full0 = sbase + kDwBar;
  const uint32_t empty0 = full0 + 8 * kBwdStages;
  init_ring<kBwdStages>(full0, empty0);
  __syncthreads();
  const int fc = blockIdx.x;
  const int kt = blockIdx.y;
  const long long e_begin = static_cast<long long>(blockIdx.z) * per_split;
  const long long e_end = min(q, e_begin + per_split);
  const int nchunks =
      static_cast<int>((e_end - e_begin + kSplitChunk - 1) / kSplitChunk);

  if (warp >= kConsumers / 32) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    if (tid != kConsumers) return;
    for (int c = 0; c < nchunks; ++c) {
      const int s = c % kBwdStages;
      if (c >= kBwdStages)
        mbar_wait(empty0 + 8 * s, static_cast<uint32_t>(c / kBwdStages - 1) &
                                      1u);
      mbar_expect_tx(full0 + 8 * s, kDwB);
      const long long eb =
          (e_begin + static_cast<long long>(c) * kSplitChunk) / kWgRows;
      bulk_load(sbase + s * kDwB, dz1 + eb * kWgRows * kp + kt * kDz1Block,
                kDwB, full0 + 8 * s);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(kConsumerRegs));
  const int wg = warp >> 2;
  // gathers: edge el of the chunk's 64 (warp w: edges 8 w ...), 16-byte
  // feature segments lane / 8 and lane / 8 + 4 of the chunk: eight lanes
  // hold eight edges of one segment (conflict-free 128-byte stores)
  const int el = 8 * warp + (lane & 7);
  const int seg0 = lane >> 3;
  uint32_t aoff[2];
#pragma unroll
  for (int x = 0; x < 2; ++x)
    aoff[x] = (el >> 3) * kMnLboA + (seg0 + 4 * x) * kCoreBytes +
              (el & 7) * 16;
  const uint32_t abuf0 = sbase + kDwA;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4 hu[2], hv[2];
  auto load = [&](int c) {
    const long long e =
        e_begin + static_cast<long long>(c) * kSplitChunk + el;
    int s = -1, r = -1;
    if (e < e_end) {
      s = sgs::head::checked_id(sid[e], n_rows);
      r = sgs::head::checked_id(rid[e], n_rows);
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int col = fc * kChunk + (seg0 + 4 * x) * 8;
      const bool in = col < pitch;
      hu[x] = (in && s >= 0)
                  ? __ldg(reinterpret_cast<const uint4*>(
                        h + static_cast<long long>(s) * pitch + col))
                  : zero;
      hv[x] = (in && r >= 0)
                  ? __ldg(reinterpret_cast<const uint4*>(
                        h + static_cast<long long>(r) * pitch + col))
                  : zero;
    }
  };
  // both halves of this thread's segments into buffer `buf`, visible to
  // both warpgroups' MMAs
  auto store = [&](int buf) {
    const uint32_t a = abuf0 + buf * kDwABuf;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      uint4 p, d;
      prod_diff(hu[x], hv[x], p, d);
      st_shared_v4(a + aoff[x], p);
      st_shared_v4(a + kDwAHalf + aoff[x], d);
    }
    fence_async_smem();
    consumers_sync();
  };

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  load(0);
  store(0);
  // buffer (c + 1) % 3 was last read by the MMAs of chunk c - 2, which both
  // warpgroups waited for before the barrier of chunk c - 1
  for (int c = 0; c < nchunks; ++c) {
    const int s = c % kBwdStages;
    mbar_wait(full0 + 8 * s, static_cast<uint32_t>(c / kBwdStages) & 1u);
    const uint32_t a = abuf0 + s * kDwABuf + wg * kDwAHalf;
    const uint32_t b = sbase + s * kDwB;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kSplitChunk / 16; ++k)
      wgmma_m64n256k16<1, 1>(acc, desc(a + 2 * kMnLboA * k, kMnLboA, kMnSboA),
                             desc(b + 2 * kMnLboB * k, kMnLboB, kMnSboB));
    wgmma_commit();
    fence_acc(acc);
    if (c + 1 < nchunks) load(c + 1);
    wgmma_wait<1>();
    fence_acc(acc);
    if (c > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * ((c - 1) % kBwdStages));
    }
    if (c + 1 < nchunks) store((c + 1) % kBwdStages);
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // rows: features 64 fc + r0 (+ 8); columns 256 kt + 8 j + 2 (lane % 4)
  float* out = wg == 0 ? dw1a : dw1b;
  const int r0 = 16 * (warp & 3) + (lane >> 2);
  const bool pairs = (hidden & 1) == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int f = fc * kChunk + r0 + 8 * r;
    if (f >= feat) continue;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const int col = kt * kN + 8 * j + 2 * (lane & 3);
      if (col < hidden)
        add_pair(out + static_cast<long long>(f) * hidden + col,
                 acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1], col + 1 < hidden,
                 pairs);
    }
  }
}

// (edges per split, splits) of the weight pass: a grid of about one block
// per SM (ops/head_mma.py weight_splits)
inline void weight_splits(long long q, int chunks, int ktiles, int sms,
                          long long& per_split, int& splits) {
  const long long per_grid = static_cast<long long>(chunks) * ktiles;
  const long long n = (q + kSplitChunk - 1) / kSplitChunk;
  long long sp = (sms + per_grid - 1) / per_grid;
  if (sp < 1) sp = 1;
  if (sp > n) sp = n;
  const long long per = (n + sp - 1) / sp;
  per_split = per * kSplitChunk;
  splits = static_cast<int>((n + per - 1) / per);
}

// Launches the three kernels on `s`; returns the first CUDA error.
inline int launch_bwd(const void* h, int pitch, const void* wpack,
                      const void* wpack_t, const void* b1, const void* w2,
                      const void* b2, const void* sid, const void* rid,
                      const void* dp, const void* seed, unsigned thresh,
                      float scale, void* dz1, void* dh, void* dw1a,
                      void* dw1b, void* db1, void* dw2, void* db2,
                      long long q, int n_rows, int feat, int hidden,
                      cudaStream_t s) {
  if (wpack == nullptr || wpack_t == nullptr || pitch % 8 != 0 ||
      pitch < feat)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ktiles = (hidden + kN - 1) / kN;
  const auto dz1_kernel = ktiles == 1 ? head_bwd_mma_dz1_kernel<true>
                                      : head_bwd_mma_dz1_kernel<false>;
  const int dz1_smem = dz1_smem_bytes(hidden);
  cudaError_t err = cudaFuncSetAttribute(
      dz1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dz1_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(head_bwd_mma_dh_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kDhSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(head_bwd_mma_dw_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kDwSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* hb = static_cast<const __nv_bfloat16*>(h);
  auto* img = static_cast<__nv_bfloat16*>(dz1);
  const int chunks = (feat + kChunk - 1) / kChunk;
  const int kp = ktiles * kN;
  const long long tiles = (q + kRows - 1) / kRows;
  const int sms = sm_count();
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);

  dz1_kernel<<<grid, kThreads, dz1_smem, s>>>(
      hb, pitch, static_cast<const __nv_bfloat16*>(wpack),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const int*>(sid),
      static_cast<const int*>(rid), static_cast<const float*>(dp),
      static_cast<const int*>(seed), thresh, scale, img,
      static_cast<float*>(db1), static_cast<float*>(dw2),
      static_cast<float*>(db2), q, n_rows, chunks, hidden, ktiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  head_bwd_mma_dh_kernel<<<grid, kThreads, kDhSmem, s>>>(
      hb, pitch, img, static_cast<const __nv_bfloat16*>(wpack_t),
      static_cast<const int*>(sid), static_cast<const int*>(rid),
      static_cast<float*>(dh), q, n_rows, feat, kp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  long long per_split = 0;
  int splits = 0;
  weight_splits(q, chunks, ktiles, sms, per_split, splits);
  head_bwd_mma_dw_kernel<<<dim3(chunks, ktiles, splits), kThreads, kDwSmem,
                           s>>>(
      hb, pitch, img, static_cast<const int*>(sid),
      static_cast<const int*>(rid), static_cast<float*>(dw1a),
      static_cast<float*>(dw1b), q, n_rows, feat, hidden, kp, per_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mma
}  // namespace sgs
