// The edge-score head's forward on Hopper's tensor cores, for bf16 h: the
// bf16 route of K3 (score_sampled.cu) and K6 (score_tiles.cu).
//
//   z  = bf16(h[s]*h[r]) @ W1a + bf16(h[s]-h[r]) @ W1b + b1       (edge, K)
//   p  = sigmoid(drop(relu(z)) . w2 + b2)
//
// Replaces sgs_gnn_tpu/ops/score_sampled.py:_make_fwd_kernel (:127, behind
// _fwd_call.call_full :340 and call_banded :368) and
// sgs_gnn_tpu/ops/score_tiles.py:_make_kernel (:115, behind
// _score_tiles_call :184) in bf16. f32 h keeps the CUDA-core kernel of
// score_head.cuh: the tensor cores have no full-f32 product.
//
// Bound: operations, 2*(2F*K) per edge on the bf16 tensor cores (F=K=256:
// 0.27 ms at q=1M on an H100 SXM). What the CUDA-core version lost, and
// what this design does about it:
//  1. f32 FMAs on CUDA cores: the first layer is wgmma.mma_async
//     m64n256k16, bf16 operands from shared memory, f32 accumulators in
//     registers. A block owns 128 edges: two consumer warpgroups of 64
//     rows, each holding a (64, 256) accumulator (128 f32 a thread). K
//     runs in tiles of 256 columns, the reduction over the 2F feature
//     columns in chunks of 64: each gathered (64, 64) slice of hu and hv
//     gives A_prod = bf16(hu*hv) (against the W1a rows) and A_diff =
//     bf16(hu-hv) (against the W1b rows), so a gathered element is read
//     once for both halves. The rounding points are those of the plain
//     version: f32 product and difference, then bf16.
//  2. scalar 2-byte gathers: a thread loads 16 bytes of a row (h stays in
//     L2: 1 MB at N=2048, F=256); the eight lanes that share a 16-byte
//     column segment hold eight different rows, so both the 64-byte runs
//     in global memory and the stores into the core-matrix image are
//     conflict-free. Each warp gathers exactly the 16 rows its share of the
//     MMA reads, so it may overwrite them as soon as its own wgmma group
//     has completed. The next chunk's loads are in flight while the
//     current chunk's MMAs run.
//  3. W1 streamed per 64 edges: the wrapper packs [W1a; W1b] once per call
//     into the exact shared-memory image the B descriptors read (below),
//     and one thread of a producer warpgroup streams it chunk by chunk (64
//     KB: the W1a and W1b rows of one feature chunk and one K tile) with
//     cp.async.bulk into a ring of two stages, tracked by mbarriers (no
//     tensor map). The producer gives its registers to the consumers
//     (setmaxnreg: 232 a consumer thread; at the 168 that ptxas gives each
//     of 384 threads, the accumulators spilled and the kernel took 1.5x
//     the time). The grid is persistent (one 197 KB block per
//     SM), so the ring runs on across tiles. L2 reads of weights: 2F*Kp*2 /
//     128 bytes per edge, 2 KB at F=K=256 (the CUDA-core kernel's 64-edge
//     blocks read 4 KB); the row gathers add 2*2F bytes (1 KB). Measured
//     (tools/tune_head_mma.py), loading each stage once instead changes
//     the time by under 5%, so the weight stream is not what bounds it, and
//     a 2-CTA cluster multicasting the chunks is left out.
//  4. the dropout hash on the critical path: the hash's inner fmix32
//     depends only on the seed and the counter's high word, so the
//     epilogue computes it once per row and K tile when the tile's counters
//     share their high word (every tile at q*K < 2^32), else per unit; the
//     mask is bit-identical to hash32 (ops/dropout.py).
//     The hash takes a third of the time with dropout (tools/
//     tune_head_mma.py, no_hash); computing the keep bits between the
//     MMAs' issue and their wait, to overlap them, was measured slower.
//
// Shared-memory images (no swizzle, K-major, the wgmma "interleave" core
// matrix layout): a core matrix is 8 rows x 16 bytes (8 bf16 of k),
// stored as 128 contiguous bytes. Within an A half (64 rows x 64 k) or a
// B half (256 n x 64 k), core matrix (row/8, k/8) starts at
// (row/8) * 1024 + (k/8) * 128: the descriptor's leading byte offset (next
// 8 k) is 128, its stride byte offset (next 8 rows) 1024, and the k16 step
// j of a chunk starts 256 * j bytes in. ops/head_mma.py builds the B image
// (pack_head_weights) and follows this schedule in plain torch.
#pragma once

#include "common.cuh"
#include "score_head.cuh"

namespace sgs {
namespace mma {

constexpr int kRows = 128;                 // edges per tile
constexpr int kWgRows = 64;                // rows per consumer warpgroup
constexpr int kN = 256;                    // hidden columns per K tile
constexpr int kChunk = 64;                 // feature columns per chunk
constexpr int kStages = 2;                 // weight ring depth
constexpr int kConsumers = 2 * 128;        // two warpgroups
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
// registers a thread after setmaxnreg: 232 x 256 + 40 x 128 <= 65,536
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;
constexpr int kCoreBytes = 128;            // one 8 x 16-byte core matrix
constexpr int kLbo = kCoreBytes;                    // next 8 columns of k
constexpr int kSbo = (kChunk / 8) * kCoreBytes;     // next 8 rows: 1024
constexpr int kHalfBytes = kN * kChunk * 2;         // W1a or W1b slice
constexpr int kChunkBytes = 2 * kHalfBytes;         // one ring stage
constexpr int kAHalfBytes = kWgRows * kChunk * 2;   // A_prod or A_diff
constexpr int kABufBytes = 2 * kAHalfBytes;
constexpr int kSmemA = kStages * kChunkBytes;       // after the ring
constexpr int kSmemBar = kSmemA + 2 * 2 * kABufBytes;   // 2 WG x 2 buffers
constexpr int kSmemBytes = kSmemBar + 2 * kStages * 8;  // full[], empty[]
static_assert(kSmemBytes <= 232448, "one block per SM");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// one bulk copy of `bytes` (a multiple of 16) from global to shared memory,
// completing on `bar`'s transaction count
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// the threads' stores to shared memory become visible to the async proxy
// (wgmma reads its operands through it)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the 128 threads of warpgroup `wg` (named barriers 1 and 2)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(wg + 1) : "memory");
}

// the 256 threads of both consumer warpgroups (named barrier 3)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 3, %0;\n" :: "n"(kConsumers) : "memory");
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// wgmma matrix descriptor (no swizzle) of an operand at `addr` whose core
// matrices are `lbo` and `sbo` bytes apart: K-major, lbo steps 8 columns of
// k and sbo 8 rows of m or n; MN-major, lbo steps 8 rows of k and sbo 8
// columns of m or n. The default is the K-major layout above.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo = kLbo,
                                         uint32_t sbo = kSbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous MMAs
template <int kN>
__device__ __forceinline__ void fence_acc(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(kPending)
               : "memory");
}

#define SGS_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define SGS_D16(i) SGS_D4(i), SGS_D4(i + 4), SGS_D4(i + 8), SGS_D4(i + 12)
#define SGS_D64(i) SGS_D16(i), SGS_D16(i + 16), SGS_D16(i + 32), \
                   SGS_D16(i + 48)

// d (64 x 256, f32) += A (64 x 16, bf16) * B (16 x 256, bf16), both from
// shared memory; kTransA / kTransB = 0: K-major, 1: MN-major (the operand's
// M or N index runs along the 16-byte rows of its core matrices)
template <int kTransA = 0, int kTransB = 0>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128],
                                                 uint64_t da, uint64_t db) {
  const int accumulate = 1;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n"
      "}\n"
      : SGS_D64(0), SGS_D64(64)
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTransA), "n"(kTransB));
}

// d (64 x 128, f32) += A (64 x 16, bf16) * B (16 x 128, bf16), both from
// shared memory, K-major
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  const int accumulate = 1;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : SGS_D64(0)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef SGS_D64
#undef SGS_D16
#undef SGS_D4

// bf16(u*v) and bf16(u-v) of eight bf16 pairs, through f32 as an
// elementwise op on bf16 tensors computes them
__device__ __forceinline__ void prod_diff(uint4 u, uint4 v, uint4& p,
                                          uint4& d) {
  const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&u);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&v);
  __nv_bfloat162* pp = reinterpret_cast<__nv_bfloat162*>(&p);
  __nv_bfloat162* dd = reinterpret_cast<__nv_bfloat162*>(&d);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(a[i]);
    const float2 y = __bfloat1622float2(b[i]);
    pp[i] = __floats2bfloat162_rn(__fmul_rn(x.x, y.x), __fmul_rn(x.y, y.y));
    dd[i] = __floats2bfloat162_rn(__fsub_rn(x.x, y.x), __fsub_rn(x.y, y.y));
  }
}

__device__ __forceinline__ uint32_t hash_inner(uint32_t seed, uint32_t hi) {
  return fmix32(seed ^ 0x243F6A88u ^ (hi * 0x9E3779B9u));
}

// Dropout modes of one K tile's epilogue: no dropout; the hash's inner
// word hoisted per row (the row's counters share their high word); the
// full hash per unit.
enum DropMode { kNoDrop, kHoisted, kPerUnit };

// Whether unit `col` of the row whose counters start at `rowc` is kept
// (its inner hash word `inner` when kMode is kHoisted).
template <DropMode kMode>
__device__ __forceinline__ bool unit_kept(unsigned long long rowc, int col,
                                          uint32_t inner, uint32_t seed,
                                          uint32_t thresh) {
  if (kMode == kNoDrop) return true;
  const unsigned long long c = rowc + static_cast<unsigned>(col);
  const uint32_t in = kMode == kHoisted
                          ? inner
                          : hash_inner(seed, static_cast<uint32_t>(c >> 32));
  return fmix32(static_cast<uint32_t>(c) ^ in) >= thresh;
}

// The dropout counters of this thread's epilogue rows (e_wg + r0 and
// e_wg + r0 + 8) and their inner hash words for the K tile starting at
// column n0.
__device__ __forceinline__ void row_counters(long long e_wg, int r0,
                                             int hidden, int n0,
                                             uint32_t seed,
                                             unsigned long long (&rowc)[2],
                                             uint32_t (&inner)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const unsigned long long e =
        static_cast<unsigned long long>(e_wg + r0 + 8 * r);
    rowc[r] = e * static_cast<unsigned>(hidden);
    inner[r] = hash_inner(seed, static_cast<uint32_t>((rowc[r] + n0) >> 32));
  }
}

// Whether every dropout counter e * K + c of 128-edge tile t over the K
// tile's columns [n0, n0 + 256) shares one high word (every tile at
// q * K < 2^32): then each row's inner hash word serves all its units.
// Decided per tile, so the epilogue's branch is uniform across the warp
// (the backward's epilogue shuffles inside it: under a per-thread branch
// ptxas wrapped the shuffles in WARPSYNC.COLLECTIVE loops and spilled).
__device__ __forceinline__ bool tile_hoist(long long t, int hidden, int n0) {
  const unsigned long long k = static_cast<unsigned>(hidden);
  const unsigned long long e0 = static_cast<unsigned long long>(t) * kRows;
  const int n_end = min(hidden, n0 + kN) - 1;
  return ((e0 * k + n0) >> 32) == (((e0 + kRows - 1) * k + n_end) >> 32);
}

// This thread's share of one K tile's logits: rows r0 (part[0]) and r0 + 8
// (part[1]) of its warp, columns n0 + 8 j + 2 (lane % 4) + {0, 1}, as the
// m64nNk16 accumulator layout holds them (d[4 j + 2 r + x]).
template <DropMode kMode>
__device__ __forceinline__ void tile_logits(
    const float (&acc)[128], float (&part)[2], const float* __restrict__ b1,
    const float* __restrict__ w2, int n0, int hidden,
    const unsigned long long (&rowc)[2], const uint32_t (&inner)[2],
    uint32_t seed, uint32_t thresh, float scale) {
  const int cbase = n0 + 2 * (threadIdx.x & 3);
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int col = cbase + 8 * j + x;
      if (col < hidden) {
        const float bias = __ldg(b1 + col);
        const float wout = __ldg(w2 + col);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float zr = fmaxf(acc[4 * j + 2 * r + x] + bias, 0.f);
          if (kMode != kNoDrop)
            zr = unit_kept<kMode>(rowc[r], col, inner[r], seed, thresh)
                     ? zr * scale
                     : 0.f;
          part[r] += zr * wout;
        }
      }
    }
  }
}

// One consumer thread's part of the row gathers: rows grow[j] = 16 wwarp +
// lane % 8 + 8 j of its warpgroup's 64, 16-byte column segments lane / 8
// and lane / 8 + 4 of each 64-column chunk, and where they land in an A
// half (aoff[j][x]); sr / rr: the endpoint rows of its two rows, -1 for a
// zero row.
struct Gather {
  int grow[2];
  uint32_t aoff[2][2];
  int seg0;
  int sr[2], rr[2];

  __device__ __forceinline__ void init(int wwarp, int lane) {
    seg0 = lane >> 3;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      grow[j] = 16 * wwarp + (lane & 7) + 8 * j;
#pragma unroll
      for (int x = 0; x < 2; ++x)
        aoff[j][x] = (grow[j] >> 3) * kSbo + (seg0 + 4 * x) * kLbo +
                     (grow[j] & 7) * 16;
    }
  }
};

// The 16-byte segments of chunk c of h's rows sr / rr (zero past the row
// pitch or for row -1).
__device__ __forceinline__ void gather_chunk(
    const __nv_bfloat16* __restrict__ h, int pitch, const Gather& gt, int c,
    uint4 (&hu)[2][2], uint4 (&hv)[2][2]) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int col = c * kChunk + (gt.seg0 + 4 * x) * 8;
      const bool in = col < pitch;
      hu[j][x] = (in && gt.sr[j] >= 0)
                     ? __ldg(reinterpret_cast<const uint4*>(
                           h + static_cast<long long>(gt.sr[j]) * pitch + col))
                     : zero;
      hv[j][x] = (in && gt.rr[j] >= 0)
                     ? __ldg(reinterpret_cast<const uint4*>(
                           h + static_cast<long long>(gt.rr[j]) * pitch + col))
                     : zero;
    }
}

// acc = the first layer without b1 of the warpgroup's 64 rows over one K
// tile: for each feature chunk, A_prod / A_diff of the gathered segments go
// into one of the warpgroup's two A buffers at `abase` (each warp writes
// only the 16 rows its share of the MMA reads) and meet the chunk's W1a /
// W1b rows from the weight ring; `g` counts the ring's chunks consumed. The
// next chunk's loads are in flight while the current chunk's MMAs run.
__device__ __forceinline__ void ktile_mma(
    float (&acc)[128], const __nv_bfloat16* __restrict__ h, int pitch,
    const Gather& gt, uint32_t abase, uint32_t sbase, uint32_t full0,
    uint32_t empty0, int chunks, int wg, long long& g) {
  const int lane = threadIdx.x & 31;
  uint4 hu[2][2], hv[2][2];
  // A_prod / A_diff of the loaded segments into buffer `buf`, then make the
  // warpgroup's stores visible to its MMAs
  auto store = [&](int buf) {
    const uint32_t a = abase + buf * kABufBytes;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        uint4 p, d;
        prod_diff(hu[j][x], hv[j][x], p, d);
        st_shared_v4(a + gt.aoff[j][x], p);
        st_shared_v4(a + kAHalfBytes + gt.aoff[j][x], d);
      }
    fence_async_smem();
    wg_sync(wg);
  };

#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  gather_chunk(h, pitch, gt, 0, hu, hv);
  store(0);
  for (int c = 0; c < chunks; ++c, ++g) {
    const int s = static_cast<int>(g % kStages);
    mbar_wait(full0 + 8 * s, static_cast<uint32_t>(g / kStages) & 1u);
    const uint32_t a = abase + (c & 1) * kABufBytes;
    const uint32_t w = sbase + s * kChunkBytes;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kChunk / 16; ++k)
      wgmma_m64n256k16(acc, desc(a + 256 * k), desc(w + 256 * k));
#pragma unroll
    for (int k = 0; k < kChunk / 16; ++k)
      wgmma_m64n256k16(acc, desc(a + kAHalfBytes + 256 * k),
                       desc(w + kHalfBytes + 256 * k));
    wgmma_commit();
    fence_acc(acc);
    if (c + 1 < chunks) gather_chunk(h, pitch, gt, c + 1, hu, hv);
    // the previous chunk's MMAs are done: its weight stage goes back to the
    // producer, its A buffer takes the next chunk
    wgmma_wait<1>();
    fence_acc(acc);
    if (c > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * ((g - 1) % kStages));
    }
    if (c + 1 < chunks) store((c + 1) & 1);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  __syncwarp();
  if (lane == 0) mbar_arrive(empty0 + 8 * ((g - 1) % kStages));
}

// The producer warpgroup of a kernel on the weight ring: gives its
// registers to the consumers, and one thread streams `steps` chunks per
// 128-edge tile (step i of a tile is chunk i % period of the packed image),
// in the order the consumers use them.
__device__ __forceinline__ void weight_producer(
    const __nv_bfloat16* __restrict__ wpack, uint32_t sbase, uint32_t full0,
    uint32_t empty0, long long tiles, int steps, int period) {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
               :: "n"(kProducerRegs));
  if (threadIdx.x != kConsumers) return;
  long long g = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    for (int i = 0; i < steps; ++i, ++g) {
      const int s = static_cast<int>(g % kStages);
      if (g >= kStages)
        mbar_wait(empty0 + 8 * s, static_cast<uint32_t>(g / kStages - 1) & 1u);
      mbar_expect_tx(full0 + 8 * s, kChunkBytes);
      bulk_load(sbase + s * kChunkBytes,
                wpack + static_cast<long long>(i % period) * (kChunkBytes / 2),
                kChunkBytes, full0 + 8 * s);
    }
  }
}

// The endpoint rows of this thread's two gathered rows of 128-edge tile t
// (K3: sid / rid; K6: through the tile index).
template <bool kTiles>
__device__ __forceinline__ void tile_rows(
    Gather& gt, long long e_wg, long long q, const int* __restrict__ sid,
    const int* __restrict__ rid, const int* __restrict__ su,
    const int* __restrict__ rv, int tile_t, int tile_b, int n_rows) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const long long e = e_wg + gt.grow[j];
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
    gt.sr[j] = sgs::head::checked_id(s, n_rows);
    gt.rr[j] = sgs::head::checked_id(r, n_rows);
  }
}

// Initializes the barriers of a ring of kS stages (thread 0): full[s] at
// full0 + 8 s, empty[s] at empty0 + 8 s; the caller syncs.
template <int kS = kStages>
__device__ __forceinline__ void init_ring(uint32_t full0, uint32_t empty0) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers / 32);   // one arrive per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// Forward over q edge slots, bf16 h with rows `pitch` elements apart (a
// multiple of 8: 16-byte rows), W1 packed by pack_head_weights (chunks of
// [ktiles][chunks][W1a, W1b]). kTiles = false (K3): slot e's endpoints are
// sid[e] / rid[e]; kTiles = true (K6): su[e / tile_b] * tile_t + sid[e]
// and rv[e / tile_b] * tile_t + rid[e]. Persistent: block b takes the
// 128-edge tiles b, b + gridDim.x, ...
template <bool kTiles>
__global__ void __launch_bounds__(kThreads, 1)
head_mma_kernel(const __nv_bfloat16* __restrict__ h, int pitch,
                const __nv_bfloat16* __restrict__ wpack,
                const float* __restrict__ b1, const float* __restrict__ w2,
                const float* __restrict__ b2, const int* __restrict__ sid,
                const int* __restrict__ rid, const int* __restrict__ su,
                const int* __restrict__ rv, int tile_t, int tile_b,
                const int* __restrict__ seed_p, uint32_t thresh, float scale,
                float* __restrict__ out, long long q, int n_rows, int chunks,
                int hidden, int ktiles) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const uint32_t sbase = smem_u32(smem);
  const uint32_t full0 = sbase + kSmemBar;       // full[s]: full0 + 8 s
  const uint32_t empty0 = full0 + 8 * kStages;   // empty[s]
  init_ring(full0, empty0);
  __syncthreads();
  const long long tiles = (q + kRows - 1) / kRows;
  const int steps = ktiles * chunks;   // weight chunks per tile

  if (warp >= kConsumers / 32) {
    // every tile: K tile outer, chunk inner
    weight_producer(wpack, sbase, full0, empty0, tiles, steps, steps);
    return;
  }

  // consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(kConsumerRegs));
  const int wg = warp >> 2;
  const int wwarp = warp & 3;
  const uint32_t abase = sbase + kSmemA + wg * 2 * kABufBytes;
  Gather gt;
  gt.init(wwarp, lane);
  // epilogue rows: r0 = 16 wwarp + lane / 4 and r0 + 8
  const int r0 = 16 * wwarp + (lane >> 2);
  const uint32_t seed = static_cast<uint32_t>(seed_p[0]);
  const float bias2 = b2[0];

  long long g = 0;   // weight chunks consumed

  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long e_wg = t * kRows + wg * kWgRows;
    tile_rows<kTiles>(gt, e_wg, q, sid, rid, su, rv, tile_t, tile_b, n_rows);
    float logit[2] = {0.f, 0.f};

    for (int kt = 0; kt < ktiles; ++kt) {
      float acc[128];
      ktile_mma(acc, h, pitch, gt, abase, sbase, full0, empty0, chunks, wg,
                g);

      // epilogue: + b1, relu, dropout, . w2 over this K tile's columns
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
      // the four lanes of a quad hold the row's columns
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        part[r] += __shfl_xor_sync(0xffffffffu, part[r], 1);
        part[r] += __shfl_xor_sync(0xffffffffu, part[r], 2);
        logit[r] += part[r];
      }
    }
    if ((lane & 3) == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const long long e = e_wg + r0 + 8 * r;
        if (e < q) out[e] = 1.f / (1.f + expf(-(logit[r] + bias2)));
      }
    }
  }
}

// Launches the kernel on `s` over q slots; returns cudaGetLastError().
template <bool kTiles>
int launch(const void* h, int pitch, const void* wpack, const void* b1,
           const void* w2, const void* b2, const void* sid, const void* rid,
           const void* su, const void* rv, int tile_t, int tile_b,
           const void* seed, unsigned thresh, float scale, void* out,
           long long q, int n_rows, int feat, int hidden, cudaStream_t s) {
  if (wpack == nullptr || pitch % 8 != 0 || pitch < feat)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      head_mma_kernel<kTiles>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (q + kRows - 1) / kRows;
  const int sms = sm_count();
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  head_mma_kernel<kTiles><<<grid, kThreads, kSmemBytes, s>>>(
      static_cast<const __nv_bfloat16*>(h), pitch,
      static_cast<const __nv_bfloat16*>(wpack),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const int*>(sid),
      static_cast<const int*>(rid), static_cast<const int*>(su),
      static_cast<const int*>(rv), tile_t, tile_b,
      static_cast<const int*>(seed), thresh, scale, static_cast<float*>(out),
      q, n_rows, (feat + kChunk - 1) / kChunk, hidden,
      (hidden + kN - 1) / kN);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mma
}  // namespace sgs
