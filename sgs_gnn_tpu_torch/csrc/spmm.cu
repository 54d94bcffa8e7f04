// spmm_fused: y[r] = sum over edges e with receivers[e] == r of
// w[e] * x[senders[e]], f32 accumulation.
//
// Replaces sgs_gnn_tpu/ops/spmm_pallas.py:_spmm_kernel (:42, behind
// _spmm_pallas_impl :94). The TPU kernel gathered x[senders] as a one-hot
// (B, N) @ (N, F) matmul with the weights folded into the one-hot rows and
// scattered into the receivers with a second one-hot matmul, so no (E, F)
// message matrix reached HBM; it was written for E >> N, the cluster
// partitions this framework trains on. Its arithmetic: the weight is rounded
// to x's type, each product w * x[s] is formed in f32 (exact for bf16 x),
// the sum is f32. Senders or receivers outside [0, N) contribute nothing.
//
// Two routes, picked on the host from the shapes and x's type alone
// (ops/spmm.py spmm_plan; counted in _build.ROUTES):
//
// "tiles" (bf16 x with at least MIN_TILE_EDGES = 64 edges per 64 x 64
//   adjacency tile on average, and at most kMaxBins tiles; ops/spmm.py
//   spmm_plan says why). Bound: bytes, 12E (the edge lists) + N*F*(2 + 4)
//   (x in, f32 y out): 4.5 us at E=1M, N=2048, F=256 on an H100 SXM; the
//   2EF products on the tensor cores take 0.5 us. The gather route below
//   moves E*F*2 bytes of row gathers through L2 (512 MB at E=1M, F=256)
//   and, on unsorted receivers (the backward's reversed edges), one f32
//   atomic per edge and column. These graphs are dense as matrices (the
//   bench partition fills 24% of its 2048^2 pairs), so the counterpart of
//   the one-hot MXU product is a dense product of adjacency tiles:
//   1. Binning, two kernels after a memset, no host read: a counting sort
//      of the in-range edges by tile (receiver block of 64 major, sender
//      block of 64 minor), so each tile's edges are one contiguous run in
//      tile order. spmm_bin_count_kernel histograms a chunk of kBinChunk
//      edges in shared memory and adds its nonzero bins to the global
//      counts. spmm_bin_scatter_kernel scans the counts (each block: a few
//      KB from L2, cheaper than a kernel of its own), ranks each edge in
//      its chunk's shared histogram, reserves one range per nonzero bin
//      with a global atomic, sorts the chunk into tile order in shared
//      memory and writes each bin's run contiguously (scattered 4-byte
//      stores cost a 32-byte sector each), an edge as 4 bytes: its place in
//      the tile (12 bits) and its weight rounded to bf16 (the rounding of
//      x's type, exact). Out-of-range edges are dropped here. It also
//      notes whether any weight differs from 1.
//   2. spmm_tile_kernel: block (p, c) takes the p-th of `parts` equal
//      ranges of the binned edges (any receiver order costs the same) and
//      the column slice c of kW columns (F padded to a multiple of 16). For
//      each tile its range touches, it adds each edge's weight into a 64 x
//      64 panel in shared memory: integer counts where every weight is 1
//      (native shared-memory atomics), else f32 sums, whose shared-memory
//      atomics are compare-and-swap loops on sm_90, so a warp's duplicate
//      places are summed in registers first (__match_any_sync) and added
//      once. The panel is split into bf16 hi and lo = bf16(a - hi) in the
//      K-major A image, and two warpgroups multiply it by x's 64 sender rows
//      (wgmma m64nNk16, each half of the columns, f32 accumulators in
//      registers): hi + lo keeps ~16 bits of a summed weight, a relative
//      error of at most 2^-17; the lo product is skipped when every lo of
//      the tile is 0 (single edges, counts up to 256). While a tile's MMAs
//      run, the next tile's rows are copied into the other of two B buffers
//      (cp.async, the MN-major image the B descriptor reads) and its first
//      1024 codes are loaded into registers: the block is latency-bound (a
//      few tiles each), so the grid holds parts_per_sm blocks on every SM.
//      x is read once per tile, N/64 * N*F*2 bytes of L2 reads (32 MB at
//      N=2048, F=256), not once per edge. The parts of one receiver block
//      (split-K) meet in the zeroed f32 output: a block adds its
//      accumulators with float4 atomics (float2 or scalar where F is not a
//      multiple of 4) when its range leaves a receiver block, 64 x kW
//      values, zeros skipped. ptxas serializes the MMAs around the
//      conditional lo product (remark C7520); tools/tune_row_kernels.py
//      measured ~2 us of the tile kernel's ~54 at F=256 for it, and an
//      unconditional lo product costs more at F=41.
// "gather" (f32 x: JAX multiplies f32 at Precision.HIGHEST, and the tensor
//   cores have no full-f32 product; bf16 x on graphs too sparse for
//   tiles). Bound: 2EF f32 operations at 67 TFLOP/s. Each warp owns
//   kEdgesPerWarp consecutive edges, its lanes across 256 columns (rows.cuh:
//   16-byte loads where the layout allows), kUnroll rows gathered ahead; it
//   sums runs of equal receivers in registers and adds each run into the
//   output with one f32 atomic per column, staged through shared memory so
//   that each atomic instruction covers contiguous bytes (rows.cuh
//   add_row_staged). Any receiver order is correct.
#include "head_mma.cuh"
#include "rows.cuh"

namespace {

// ---- the gather route ----

constexpr int kWarps = 8;                  // warps per block
constexpr int kEdgesPerWarp = 64;
constexpr int kUnroll = 4;                 // rows in flight per warp

template <typename T, bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
spmm_kernel(const int* __restrict__ senders, const int* __restrict__ receivers,
            const float* __restrict__ weights, const T* __restrict__ x,
            float* __restrict__ out, long long num_edges, int num_nodes,
            int feat) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long e0 =
      (static_cast<long long>(blockIdx.x) * kWarps + warp) * kEdgesPerWarp;
  if (e0 >= num_edges) return;
  const long long e1 = min(e0 + kEdgesPerWarp, num_edges);
  const int tile0 = blockIdx.y * sgs::kRowTile;
  __shared__ float stage[kWarps][sgs::kRowTile];

  float acc[sgs::kRowPerLane];
  sgs::zero_row(acc);
  int cur = -1;  // receiver of the open run; -1: none

  for (long long e = e0; e < e1; e += kUnroll) {
    int r[kUnroll];
    float w[kUnroll];
    float rows[kUnroll][sgs::kRowPerLane];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      r[u] = -1;
      if (e + u < e1) {
        const int s = __ldg(senders + e + u);
        const int rr = __ldg(receivers + e + u);
        if (s >= 0 && s < num_nodes && rr >= 0 && rr < num_nodes) {
          r[u] = rr;
          w[u] = sgs::round_as<T>(__ldg(weights + e + u));
          sgs::load_row<T, kVec>(x + static_cast<long long>(s) * feat, feat,
                                 tile0, lane, rows[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r[u] < 0) continue;  // past the range, or an endpoint out of range
      if (r[u] != cur) {
        if (cur >= 0) {
          sgs::add_row_staged<T, kVec>(
              acc, out + static_cast<long long>(cur) * feat, stage[warp], feat,
              tile0, lane);
        }
        cur = r[u];
        sgs::zero_row(acc);
      }
#pragma unroll
      for (int a = 0; a < sgs::kRowPerLane; ++a) acc[a] += w[u] * rows[u][a];
    }
  }
  if (cur >= 0) {
    sgs::add_row_staged<T, kVec>(acc, out + static_cast<long long>(cur) * feat,
                                 stage[warp], feat, tile0, lane);
  }
}

template <typename T>
void launch_gather(const void* senders, const void* receivers,
                   const void* weights, const void* x, void* out,
                   long long num_edges, int num_nodes, int feat,
                   cudaStream_t s) {
  const dim3 grid(sgs::ceil_div_ll(num_edges, kWarps * kEdgesPerWarp),
                  sgs::ceil_div_ll(feat, sgs::kRowTile));
  const dim3 block(kWarps * 32);
  const int* sp = static_cast<const int*>(senders);
  const int* rp = static_cast<const int*>(receivers);
  const float* wp = static_cast<const float*>(weights);
  const T* xp = static_cast<const T*>(x);
  float* o = static_cast<float*>(out);
  if (sgs::vector_rows<T>(feat, x, out)) {
    spmm_kernel<T, true><<<grid, block, 0, s>>>(sp, rp, wp, xp, o, num_edges,
                                                num_nodes, feat);
  } else {
    spmm_kernel<T, false><<<grid, block, 0, s>>>(sp, rp, wp, xp, o, num_edges,
                                                 num_nodes, feat);
  }
}

// ---- the tile route ----

constexpr int kTileShift = 6;
constexpr int kTileRows = 1 << kTileShift;  // receivers of a tile (wgmma M)
constexpr int kTileK = 1 << kTileShift;     // senders of a tile
constexpr int kTileThreads = 256;           // two warpgroups
constexpr int kPanelStride = kTileK + 4;    // floats per panel row
constexpr int kABytes = kTileRows * kTileK * 2;              // hi or lo
constexpr int kPanelBytes = kTileRows * kPanelStride * 4;    // 17,408
constexpr int kWin = kTileThreads;          // tile offsets held at a time
constexpr int kBatch = 4;                   // codes a thread loads at once
constexpr int kBinThreads = 256;
constexpr int kBinPer = 8;                  // edges per thread of a chunk
constexpr int kBinChunk = kBinThreads * kBinPer;
constexpr uint32_t kOneBf16 = 0x3F80;      // 1.0 in bf16
// duplicate (receiver, sender) places within a warp's step are summed in
// registers and added once; the flush adds 4 columns per atomic where F
// allows (tools/tune_row_kernels.py times each off)
constexpr int kMatchPeers = 1;
constexpr int kFlushV4 = 1;
constexpr int kMaxBins = 8192;              // ops/spmm.py MAX_BINS
constexpr int kMaxSmem = 232448;            // Hopper's opt-in limit

// shared memory of a tile block of kW columns: two buffers of x's rows
// (MN-major B), the hi and lo A images, the f32 panel, the window of tile
// offsets (ops/spmm.py tile_smem)
constexpr int tile_smem(int w) {
  return 2 * kTileK * w * 2 + 2 * kABytes + kPanelBytes + (kWin + 4) * 4;
}
static_assert(2 * (tile_smem(256) + 1024) <= 233472, "two blocks per SM");

// shared memory of a binning scatter block: counts, chunk starts, range
// starts and global starts per bin, the chunk's codes and tiles in tile
// order (ops/spmm.py bin_smem)
constexpr int bin_smem(int bins) {
  return 4 * ((bins + 31) / 32 * 32) + 12 * bins + 8 * kBinChunk;
}
static_assert(bin_smem(kMaxBins) <= kMaxSmem, "largest histogram");

__device__ __forceinline__ bool in_range(int v, int n) {
  return v >= 0 && v < n;
}

// tile of an in-range edge: receiver block major, sender block minor
__device__ __forceinline__ int tile_of(int s, int r, int sblocks) {
  return (r >> kTileShift) * sblocks + (s >> kTileShift);
}

// Where a chunk histogram keeps tile t's count: t's low five bits XOR its
// next five, a bijection on each aligned group of 32. A chunk of the
// reversed (sender-sorted) list hits tiles sblocks apart (32 at N=2048),
// which would all fall in one shared-memory bank.
__device__ __forceinline__ int slot(int t) { return t ^ ((t >> 5) & 31); }

// bins rounded up to whole groups of 32 (the swizzled histogram's size)
__host__ __device__ constexpr int bins32(int bins) {
  return (bins + 31) / 32 * 32;
}

__global__ void __launch_bounds__(kBinThreads)
spmm_bin_count_kernel(const int* __restrict__ senders,
                      const int* __restrict__ receivers, long long num_edges,
                      int num_nodes, int sblocks, int bins,
                      int* __restrict__ counts) {
  extern __shared__ int hist[];      // bins32(bins), by slot()
  for (int i = threadIdx.x; i < bins32(bins); i += kBinThreads) hist[i] = 0;
  __syncthreads();
  const long long e0 =
      static_cast<long long>(blockIdx.x) * kBinChunk + threadIdx.x;
#pragma unroll 4
  for (int j = 0; j < kBinPer; ++j) {
    const long long e = e0 + j * kBinThreads;
    if (e < num_edges) {
      const int s = __ldg(senders + e);
      const int r = __ldg(receivers + e);
      if (in_range(s, num_nodes) && in_range(r, num_nodes))
        atomicAdd(&hist[slot(tile_of(s, r, sblocks))], 1);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < bins; i += kBinThreads) {
    const int c = hist[slot(i)];
    if (c) atomicAdd(counts + i, c);
  }
}

// Exclusive scan of in[0..n) (entry b at slot(b) if kSlots) into out[0..n)
// (and out2, if given) by the kThreads threads of the block, each over a
// contiguous run of entries; returns the total to every thread. Ends with a
// barrier.
template <int kThreads, bool kSlots = false>
__device__ __forceinline__ int block_scan(const int* in, int* out, int* out2,
                                          int n, int* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int per = (n + kThreads - 1) / kThreads;
  const int b0 = threadIdx.x * per;
  int local = 0;
  for (int i = 0; i < per; ++i)
    if (b0 + i < n) local += in[kSlots ? slot(b0 + i) : b0 + i];
  int v = local;  // inclusive scan over the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += t;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  int run = v - local, total = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    const int ws = warp_sums[w];
    if (w < warp) run += ws;
    total += ws;
  }
  for (int i = 0; i < per; ++i) {
    const int b = b0 + i;
    if (b < n) {
      out[b] = run;
      if (out2) out2[b] = run;
      run += in[kSlots ? slot(b) : b];
    }
  }
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(kBinThreads)
spmm_bin_scatter_kernel(const int* __restrict__ senders,
                        const int* __restrict__ receivers,
                        const float* __restrict__ weights, long long num_edges,
                        int num_nodes, int sblocks, int bins,
                        const int* __restrict__ counts,
                        int* __restrict__ cursor, int* __restrict__ offsets,
                        int* __restrict__ weighted,
                        uint32_t* __restrict__ binned) {
  extern __shared__ int cnt[];       // bin_smem(bins); counts by slot()
  int* lbase = cnt + bins32(bins);   // a bin's start in the chunk's order
  int* gbase = lbase + bins;         // its start in `binned`
  int* goff = gbase + bins;          // the bin's start among all edges
  uint32_t* codes = reinterpret_cast<uint32_t*>(goff + bins);
  int* keys = reinterpret_cast<int*>(codes + kBinChunk);
  __shared__ int warp_sums[kBinThreads / 32];
  // every block scans the counts (a few KB from L2: cheaper than a kernel
  // of its own); block 0 writes the offsets the tile kernel reads
  const int total = block_scan<kBinThreads>(
      counts, goff, blockIdx.x == 0 ? offsets : nullptr, bins, warp_sums);
  if (blockIdx.x == 0 && threadIdx.x == 0) offsets[bins] = total;
  for (int i = threadIdx.x; i < bins32(bins); i += kBinThreads) cnt[i] = 0;
  __syncthreads();
  const long long e0 =
      static_cast<long long>(blockIdx.x) * kBinChunk + threadIdx.x;
  int key[kBinPer], rank[kBinPer];
  uint32_t code[kBinPer];
  bool other = false;   // an in-range weight that is not 1 in bf16
#pragma unroll
  for (int j = 0; j < kBinPer; ++j) {
    key[j] = -1;
    const long long e = e0 + j * kBinThreads;
    if (e < num_edges) {
      const int s = __ldg(senders + e);
      const int r = __ldg(receivers + e);
      if (in_range(s, num_nodes) && in_range(r, num_nodes)) {
        key[j] = tile_of(s, r, sblocks);
        const uint32_t at = ((static_cast<uint32_t>(r) & (kTileRows - 1))
                             << kTileShift) |
                            (static_cast<uint32_t>(s) & (kTileK - 1));
        const uint32_t wb =
            __bfloat16_as_ushort(__float2bfloat16(__ldg(weights + e)));
        code[j] = (at << 16) | wb;
        other |= wb != kOneBf16;
        rank[j] = atomicAdd(&cnt[slot(key[j])], 1);
      }
    }
  }
  if (__syncthreads_or(other) && threadIdx.x == 0) *weighted = 1;
  // the chunk in tile order in shared memory, then each bin's run written
  // out contiguously (scattered 4-byte stores cost a sector each)
  const int kept = block_scan<kBinThreads, true>(cnt, lbase, nullptr, bins,
                                           warp_sums);
#pragma unroll 4
  for (int i = threadIdx.x; i < bins; i += kBinThreads) {
    const int c = cnt[slot(i)];
    if (c) gbase[i] = goff[i] + atomicAdd(cursor + i, c);
  }
#pragma unroll
  for (int j = 0; j < kBinPer; ++j) {
    if (key[j] >= 0) {
      const int p = lbase[key[j]] + rank[j];
      codes[p] = code[j];
      keys[p] = key[j];
    }
  }
  __syncthreads();
  for (int p = threadIdx.x; p < kept; p += kBinThreads) {
    const int k = keys[p];
    binned[gbase[k] + p - lbase[k]] = codes[p];
  }
}

// 16 bytes from global to shared memory, asynchronously; `bytes` 0 fills
// zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// d (64 x kN, f32) = A (64 x 16, bf16, K-major) * B (16 x kN, bf16,
// MN-major) + (accumulate ? d : 0), both operands from shared memory
template <int kN>
__device__ __forceinline__ void wgmma_tile(float (&d)[kN / 2], uint64_t da,
                                           uint64_t db, int accumulate);

#define SGS_SPMM_D4(i) \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])

template <>
__device__ __forceinline__ void wgmma_tile<8>(float (&d)[4], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, 0, 1;\n"
      "}\n"
      : SGS_SPMM_D4(0)
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tile<16>(float (&d)[8], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 1;\n"
      "}\n"
      : SGS_SPMM_D4(0), SGS_SPMM_D4(4)
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tile<24>(float (&d)[12], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11"
      "}, %12, %13, p, 1, 1, 0, 1;\n"
      "}\n"
      : SGS_SPMM_D4(0), SGS_SPMM_D4(4), SGS_SPMM_D4(8)
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tile<32>(float (&d)[16], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 1;\n"
      "}\n"
      : SGS_SPMM_D4(0), SGS_SPMM_D4(4), SGS_SPMM_D4(8), SGS_SPMM_D4(12)
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tile<48>(float (&d)[24], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1, 0, 1;\n"
      "}\n"
      : SGS_SPMM_D4(0), SGS_SPMM_D4(4), SGS_SPMM_D4(8), SGS_SPMM_D4(12),
        SGS_SPMM_D4(16), SGS_SPMM_D4(20)
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tile<64>(float (&d)[32], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : SGS_SPMM_D4(0), SGS_SPMM_D4(4), SGS_SPMM_D4(8), SGS_SPMM_D4(12),
        SGS_SPMM_D4(16), SGS_SPMM_D4(20), SGS_SPMM_D4(24), SGS_SPMM_D4(28)
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tile<96>(float (&d)[48], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 1;\n"
      "}\n"
      : SGS_SPMM_D4(0), SGS_SPMM_D4(4), SGS_SPMM_D4(8), SGS_SPMM_D4(12),
        SGS_SPMM_D4(16), SGS_SPMM_D4(20), SGS_SPMM_D4(24), SGS_SPMM_D4(28),
        SGS_SPMM_D4(32), SGS_SPMM_D4(36), SGS_SPMM_D4(40), SGS_SPMM_D4(44)
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tile<128>(float (&d)[64], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : SGS_SPMM_D4(0), SGS_SPMM_D4(4), SGS_SPMM_D4(8), SGS_SPMM_D4(12),
        SGS_SPMM_D4(16), SGS_SPMM_D4(20), SGS_SPMM_D4(24), SGS_SPMM_D4(28),
        SGS_SPMM_D4(32), SGS_SPMM_D4(36), SGS_SPMM_D4(40), SGS_SPMM_D4(44),
        SGS_SPMM_D4(48), SGS_SPMM_D4(52), SGS_SPMM_D4(56), SGS_SPMM_D4(60)
      : "l"(da), "l"(db), "r"(accumulate));
}


#undef SGS_SPMM_D4

// x's rows s0 .. s0 + 63, columns c0 .. c0 + kW - 1 as the MN-major B
// image: core matrix (k / 8, n / 8) of 8 senders x 8 columns at (k / 8) *
// 16 kW + (n / 8) * 128, sender k % 8 at 16 (k % 8) within it (lbo 16 kW,
// sbo 128). Segment i of 8 columns lands at 16 i; eight neighbouring
// lanes hold eight rows of one column segment (one 128-byte store, 32-byte
// runs of a row across lane groups). Zeros past N and F.
template <int kW>
__device__ __forceinline__ void load_rows(const __nv_bfloat16* __restrict__ x,
                                          int num_nodes, int feat, int s0,
                                          int c0, bool vec, uint32_t b) {
  constexpr int kSegs = kTileK * kW / 8;
  for (int i = threadIdx.x; i < kSegs; i += kTileThreads) {
    const int s = s0 + (i / kW) * 8 + (i & 7);
    const int col = c0 + ((i >> 3) % (kW / 8)) * 8;
    if (vec) {  // feat % 8 == 0: a segment is in or out whole
      const bool in = s < num_nodes && col < feat;
      cp_async16(b + 16 * i,
                 in ? x + static_cast<long long>(s) * feat + col : x,
                 in ? 16 : 0);
    } else {
      uint32_t h[4];
      const unsigned short* row = reinterpret_cast<const unsigned short*>(
          x + static_cast<long long>(s) * feat);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = col + 2 * q;
        const uint32_t lo =
            (s < num_nodes && c < feat) ? __ldg(row + c) : 0u;
        const uint32_t hi =
            (s < num_nodes && c + 1 < feat) ? __ldg(row + c + 1) : 0u;
        h[q] = lo | (hi << 16);
      }
      sgs::mma::st_shared_v4(b + 16 * i, make_uint4(h[0], h[1], h[2], h[3]));
    }
  }
}

// Adds one receiver block's accumulators into the output: this thread's
// rows 16 (warp % 4) + lane / 4 (+ 8) and columns c + 8 j + 2 (lane % 4) +
// {0, 1} of its warpgroup's kN (the m64nNk16 layout, d[4 j + 2 r + x]).
// `vec` 4 (F % 4 == 0): neighbouring lanes swap halves so that each adds 4
// consecutive columns of one row with one float4 atomic; 2 (F even):
// float2 atomics; 1: scalar. All lanes of the warpgroup take part.
template <int kN>
__device__ __forceinline__ void flush_rows(const float (&acc)[kN / 2],
                                           float* __restrict__ out, int rb,
                                           int c, int num_nodes, int feat,
                                           int vec) {
  const int lane = threadIdx.x & 31;
  const int r0 = rb * kTileRows + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  if (kFlushV4 && vec == 4) {
    const bool even = (lane & 1) == 0;
    const int row = even ? r0 : r0 + 8;
    float* orow = out + static_cast<long long>(row) * feat;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const float a0 = acc[4 * j], a1 = acc[4 * j + 1];       // row r0
      const float b0 = acc[4 * j + 2], b1 = acc[4 * j + 3];   // row r0 + 8
      const float g0 = __shfl_xor_sync(0xffffffffu, even ? b0 : a0, 1);
      const float g1 = __shfl_xor_sync(0xffffffffu, even ? b1 : a1, 1);
      const float4 v = even ? make_float4(a0, a1, g0, g1)
                            : make_float4(g0, g1, b0, b1);
      const int col = c + 8 * j + 2 * (lane & 2);
      if (row >= num_nodes || col >= feat ||
          (v.x == 0.f && v.y == 0.f && v.z == 0.f && v.w == 0.f))
        continue;
      atomicAdd(reinterpret_cast<float4*>(orow + col), v);
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= num_nodes) continue;
    float* orow = out + static_cast<long long>(row) * feat;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const int col = c + 8 * j + 2 * (lane & 3);
      const float a = acc[4 * j + 2 * r];
      const float b = acc[4 * j + 2 * r + 1];
      if (col >= feat || (a == 0.f && b == 0.f)) continue;
      if (vec >= 2) {
        atomicAdd(reinterpret_cast<float2*>(orow + col), make_float2(a, b));
      } else {
        atomicAdd(orow + col, a);
        if (col + 1 < feat) atomicAdd(orow + col + 1, b);
      }
    }
  }
}

template <int kN>
__global__ void __launch_bounds__(kTileThreads, 2)
spmm_tile_kernel(const uint32_t* __restrict__ binned,
                 const int* __restrict__ offsets,
                 const int* __restrict__ weighted,
                 const __nv_bfloat16* __restrict__ x, float* __restrict__ out,
                 int num_nodes, int feat, int sblocks, int bins, int parts,
                 int vec, int out_vec) {
  constexpr int kW = 2 * kN;                 // columns of the block
  constexpr int kBBytes = kTileK * kW * 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t b_img = sgs::mma::smem_u32(smem);   // two B buffers
  const uint32_t a_hi = b_img + 2 * kBBytes;
  const uint32_t a_lo = a_hi + kABytes;
  float* panel = reinterpret_cast<float*>(smem + 2 * kBBytes + 2 * kABytes);
  int* win = reinterpret_cast<int*>(smem + 2 * kBBytes + 2 * kABytes +
                                    kPanelBytes);
  __shared__ int first;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int c0 = blockIdx.y * kW;

  // every weight 1: the panel counts in integers, whose shared-memory
  // atomics are native (an f32 one is a compare-and-swap loop on sm_90)
  const bool ones = *weighted == 0;
  const int total = offsets[bins];
  const int begin = static_cast<int>(static_cast<long long>(total) *
                                     blockIdx.x / parts);
  const int end = static_cast<int>(static_cast<long long>(total) *
                                   (blockIdx.x + 1) / parts);
  if (begin >= end) return;
#pragma unroll 4
  for (int i = tid; i < bins; i += kTileThreads)   // the tile of `begin`
    if (offsets[i] <= begin && begin < offsets[i + 1]) first = i;
  for (int i = tid; i < kTileRows * kPanelStride; i += kTileThreads)
    panel[i] = 0.f;
  __syncthreads();

  // offsets[wbase .. wbase + kWin] in shared memory
  int wbase = first;
  auto load_window = [&]() {
    for (int j = tid; j <= kWin; j += kTileThreads)
      win[j] = wbase + j <= bins ? offsets[wbase + j] : 0x7fffffff;
  };
  load_window();
  __syncthreads();
  // the first tile from t on whose edges meet [begin, end), or -1; its
  // part's edges [lo, hi). Uniform over the block.
  auto find = [&](int t, int& lo, int& hi) -> int {
    for (; t < bins; ++t) {
      if (t + 1 - wbase > kWin) {
        __syncthreads();
        wbase = t;
        load_window();
        __syncthreads();
      }
      const int a = win[t - wbase];
      if (a >= end) return -1;
      lo = max(a, begin);
      hi = min(win[t + 1 - wbase], end);
      if (hi > lo) return t;
    }
    return -1;
  };
  // codes of a tile's first kBatch * kTileThreads edges, loaded ahead; 0 (a
  // weight of +0 at place 0) adds nothing. Called by all threads together.
  uint32_t pre[kBatch];
  auto prefetch = [&](int lo, int hi) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = lo + u * kTileThreads + tid;
      pre[u] = e < hi ? __ldg(binned + e) : 0u;
    }
  };
  auto add = [&](uint32_t code) {
    const uint32_t at = code >> 16;
    float* cell = panel + (at >> kTileShift) * kPanelStride +
                  (at & (kTileK - 1));
    if (ones) {
      if (code) atomicAdd(reinterpret_cast<int*>(cell), 1);
      return;
    }
    float w = __uint_as_float(code << 16);
    if (kMatchPeers) {
      const unsigned peers =
          __match_any_sync(0xffffffffu, code ? at : 0xffffffffu);
      if (code && (peers & (peers - 1))) {   // the lowest peer adds the sum
        float sum = 0.f;
        for (unsigned m = peers; m; m &= m - 1)
          sum += __shfl_sync(peers, w, __ffs(m) - 1);
        if ((tid & 31) != __ffs(peers) - 1) return;
        w = sum;
      }
    }
    if (code) atomicAdd(cell, w);
  };

  int lo = 0, hi = 0;
  int t = find(first, lo, hi);
  int cur = t / sblocks;     // the receiver block being accumulated
  int buf = 0;
  prefetch(lo, hi);
  load_rows<kW>(x, num_nodes, feat, (t - cur * sblocks) * kTileK, c0,
                vec != 0, b_img);
  float acc[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) acc[i] = 0.f;
  bool fresh = true;         // acc holds nothing of block `cur` yet
  while (true) {
    // densify: the loaded codes, then the rest of the part's edges
#pragma unroll
    for (int u = 0; u < kBatch; ++u) add(pre[u]);
    for (int e0 = lo + kBatch * kTileThreads; e0 < hi;
         e0 += kBatch * kTileThreads) {
      uint32_t c[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * kTileThreads + tid;
        c[u] = e < hi ? __ldg(binned + e) : 0u;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) add(c[u]);
    }
    __syncthreads();
    // hi / lo split into the K-major A images: segment i (8 senders of one
    // receiver) at 16 i, receiver (i / 64) * 8 + i % 8, senders 8 ((i / 8)
    // % 8) .. (lbo 128, sbo 1024); the panel is zeroed behind the reads
    bool any_lo = false;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int i = tid + k * kTileThreads;
      float* p = panel + ((i >> 6) * 8 + (i & 7)) * kPanelStride +
                 ((i >> 3) & 7) * 8;
      const float4 u = *reinterpret_cast<const float4*>(p);
      const float4 v = *reinterpret_cast<const float4*>(p + 4);
      *reinterpret_cast<float4*>(p) = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(p + 4) = make_float4(0.f, 0.f, 0.f, 0.f);
      float a[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
      if (ones) {
#pragma unroll
        for (int q = 0; q < 8; ++q)
          a[q] = static_cast<float>(__float_as_int(a[q]));
      }
      uint32_t h[4], l[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const __nv_bfloat162 hp = __floats2bfloat162_rn(a[2 * q],
                                                        a[2 * q + 1]);
        const float2 hf = __bfloat1622float2(hp);
        const __nv_bfloat162 lp = __floats2bfloat162_rn(
            __fsub_rn(a[2 * q], hf.x), __fsub_rn(a[2 * q + 1], hf.y));
        h[q] = *reinterpret_cast<const uint32_t*>(&hp);
        l[q] = *reinterpret_cast<const uint32_t*>(&lp);
      }
      any_lo |= (l[0] | l[1] | l[2] | l[3]) != 0u;
      sgs::mma::st_shared_v4(a_hi + 16 * i, make_uint4(h[0], h[1], h[2], h[3]));
      sgs::mma::st_shared_v4(a_lo + 16 * i, make_uint4(l[0], l[1], l[2], l[3]));
    }
    cp_async_wait_all();       // this tile's rows
    sgs::mma::fence_async_smem();
    const bool use_lo = __syncthreads_or(any_lo);
    // this warpgroup's kN columns: n group offset wg * kN / 8 * 128 bytes
    const uint32_t b = b_img + buf * kBBytes + wg * kN * 16;
    sgs::mma::fence_acc(acc);
    sgs::mma::wgmma_fence();
#pragma unroll
    for (int k = 0; k < kTileK / 16; ++k)   // the first of a block starts it
      wgmma_tile<kN>(acc, sgs::mma::desc(a_hi + 256 * k),
                     sgs::mma::desc(b + 32 * kW * k, 16 * kW, 128),
                     k > 0 || !fresh);
    if (use_lo) {
#pragma unroll
      for (int k = 0; k < kTileK / 16; ++k)
        wgmma_tile<kN>(acc, sgs::mma::desc(a_lo + 256 * k),
                       sgs::mma::desc(b + 32 * kW * k, 16 * kW, 128), 1);
    }
    fresh = false;
    sgs::mma::wgmma_commit();
    // the next tile's rows (into the other buffer, whose MMAs completed
    // last round) and first codes, while the MMAs run
    int nlo = 0, nhi = 0;
    const int nt = find(t + 1, nlo, nhi);
    if (nt >= 0) {
      load_rows<kW>(x, num_nodes, feat, (nt % sblocks) * kTileK, c0,
                    vec != 0, b_img + (buf ^ 1) * kBBytes);
      prefetch(nlo, nhi);
    }
    sgs::mma::wgmma_wait<0>();
    sgs::mma::fence_acc(acc);
    if (nt < 0 || nt / sblocks != cur) {
      // no writes to acc on this path: the next MMA starts it afresh
      // (ptxas serializes the MMAs when a divergent path defines them)
      flush_rows<kN>(acc, out, cur, c0 + wg * kN, num_nodes, feat, out_vec);
      if (nt < 0) break;
      fresh = true;
      cur = nt / sblocks;
    }
    __syncthreads();   // the A images, the panel and this buffer are free
    t = nt;
    lo = nlo;
    hi = nhi;
    buf ^= 1;
  }
}

template <int kN>
int launch_tiles(const uint32_t* binned, const int* offsets,
                 const int* weighted, const __nv_bfloat16* x, float* out,
                 int num_nodes, int feat, int sblocks, int bins, int parts,
                 int vec, int out_vec, cudaStream_t s) {
  constexpr int kSmem = tile_smem(2 * kN);
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        spmm_tile_kernel<kN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const dim3 grid(parts, sgs::ceil_div_ll(feat, 2 * kN));
  spmm_tile_kernel<kN><<<grid, kTileThreads, kSmem, s>>>(
      binned, offsets, weighted, x, out, num_nodes, feat, sblocks, bins,
      parts, vec, out_vec);
  return static_cast<int>(cudaGetLastError());
}

int launch_tile_route(const void* senders, const void* receivers,
                      const void* weights, const void* x, void* out,
                      long long num_edges, int num_nodes, int feat, int width,
                      int parts, void* scratch, cudaStream_t s) {
  const int sblocks = (num_nodes + kTileK - 1) / kTileK;
  const int bins = sblocks * sblocks;
  if (bins > kMaxBins || parts < 1) return cudaErrorInvalidValue;
  // scratch (ops/spmm.py scratch_ints): counts, cursors, the weighted
  // flag (zeroed together), offsets, edges
  int* counts = static_cast<int*>(scratch);
  int* cursor = counts + bins;
  int* weighted = cursor + bins;
  int* offsets = weighted + 1;
  uint32_t* binned = reinterpret_cast<uint32_t*>(offsets + bins + 1);
  const int* sp = static_cast<const int*>(senders);
  const int* rp = static_cast<const int*>(receivers);
  const float* wp = static_cast<const float*>(weights);
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * (2 * bins + 1),
                                    s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = sgs::ceil_div_ll(num_edges, kBinChunk);
  spmm_bin_count_kernel<<<chunks, kBinThreads, sizeof(int) * bins32(bins),
                          s>>>(
      sp, rp, num_edges, num_nodes, sblocks, bins, counts);
  static bool opted_in = false;
  if (!opted_in) {
    err = cudaFuncSetAttribute(spmm_bin_scatter_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bin_smem(kMaxBins));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  spmm_bin_scatter_kernel<<<chunks, kBinThreads, bin_smem(bins), s>>>(
      sp, rp, wp, num_edges, num_nodes, sblocks, bins, counts, cursor,
      offsets, weighted, binned);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  float* o = static_cast<float*>(out);
  const int vec = sgs::vector_rows<__nv_bfloat16>(feat, x, out);
  const int out_vec = feat % 4 == 0 ? 4 : feat % 2 == 0 ? 2 : 1;
  switch (width) {   // ops/spmm.py WIDTHS
#define SGS_SPMM_WIDTH(w)                                                   \
  case w:                                                                   \
    return launch_tiles<(w) / 2>(binned, offsets, weighted, xb, o,          \
                                 num_nodes, feat, sblocks, bins, parts, vec, \
                                 out_vec, s);
    SGS_SPMM_WIDTH(16)
    SGS_SPMM_WIDTH(32)
    SGS_SPMM_WIDTH(48)
    SGS_SPMM_WIDTH(64)
    SGS_SPMM_WIDTH(96)
    SGS_SPMM_WIDTH(128)
    SGS_SPMM_WIDTH(192)
    SGS_SPMM_WIDTH(256)
#undef SGS_SPMM_WIDTH
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (num_nodes, feat) bf16 or f32; weights: (num_edges,) f32; out:
// (num_nodes, feat) f32, zeroed here (both routes add into it). width > 0
// takes the tile route (bf16 x only) with column slices of `width` and
// `parts` edge ranges, over `scratch` (3 * bins + 2 + num_edges ints);
// width 0 the gather route.
extern "C" int sgs_spmm_fused(const void* senders, const void* receivers,
                              const void* weights, const void* x, int x_bf16,
                              void* out, long long num_edges, int num_nodes,
                              int feat, int width, int parts, void* scratch,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(
      out, 0, sizeof(float) * static_cast<size_t>(num_nodes) * feat, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (width > 0) {
    if (!x_bf16) return cudaErrorInvalidValue;
    return launch_tile_route(senders, receivers, weights, x, out, num_edges,
                             num_nodes, feat, width, parts, scratch, s);
  }
  if (x_bf16) {
    launch_gather<__nv_bfloat16>(senders, receivers, weights, x, out,
                                 num_edges, num_nodes, feat, s);
  } else {
    launch_gather<float>(senders, receivers, weights, x, out, num_edges,
                         num_nodes, feat, s);
  }
  return static_cast<int>(cudaGetLastError());
}
