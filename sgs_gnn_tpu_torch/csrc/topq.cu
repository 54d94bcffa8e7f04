// topq: the ids of the q largest keys of one draw, in ascending id.
//
// Replaces no Pallas kernel: the JAX sampler (sgs_gnn_tpu/ops/
// sampling_ops.py) leaves its top-k to XLA. The port drew with torch.topk:
// about fifteen elementwise launches to form the keys, a radix select, and a
// sort of the q winners by key that no caller read.
//
// The keys, with the f32 operations of ops/sampling_ops.py (accurate logf,
// no fast math), so they equal the plain version's bit for bit:
//   Gumbel   key[e] = mask[e] ? logw[e] - log(-log(max(u[e], FLT_MIN))) : -inf
//   uniform  key[e] = mask[e] ? max(u[e], FLT_MIN) : -inf
//
// Bound: bytes. A draw reads logw and u (4 bytes each) and the mask (1), and
// writes q ids: ~10 MB at E = 1M, q = 200k, ~3 us at 3.35 TB/s. What costs
// the time is the number of passes and launches, not arithmetic. Design:
// - keys_kernel forms each key once and writes its order-preserving uint32
//   image (4E bytes; at the path's sizes they stay in the 50 MB L2, where the
//   later passes read them) and the histogram of the images' top 13 bits
//   (a draw's keys fall in a few exponents: 13 bits leave a few % of the
//   entries to the next pass, 11 would leave a quarter);
// - pass_kernel<2>, <3> histogram the next 11 and the last 8 bits of the
//   entries whose higher bits equal the threshold's so far. The block that
//   ends a pass last (a counter in scratch) picks the bucket that holds the
//   q-th largest key and zeroes the histogram for the next pass. After the
//   third pass the image T of the q-th largest key is known, and how many
//   entries equal to T to take (need);
// - count_kernel counts per tile the entries above T and equal to T; its
//   last block turns the counts into exclusive prefixes;
// - write_kernel writes each tile's winners in id order: an entry above T,
//   or one equal to T with fewer than need equal entries before it. Its slot
//   is (entries above T before it) + min(entries equal to T before it, need):
//   each warp counts its contiguous 256 entries by ballots, one block scan
//   gives the warps' offsets.
// Histograms live in shared memory per block, and the lanes of a warp that
// add to one bin add once (__match_any_sync): a draw's keys fall in a few
// top-11-bit buckets. Every decision is made on the card, so a draw needs no
// host read and is captured into a CUDA graph whole: a memset and five
// launches. Ties at T go to the lowest ids; -0 and +0 are one key.
#include <cfloat>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kItems = 8;                   // entries per thread and tile
constexpr int kTile = kThreads * kItems;    // entries per block
constexpr int kWarps = kThreads / 32;
// the three digits: bits 31..19, 18..8, 7..0 of the image
constexpr int kDigit1 = 13, kDigit2 = 11, kDigit3 = 8;
constexpr int kBins = 1 << kDigit1;         // the largest histogram
constexpr unsigned kFull = 0xffffffffu;

// scratch, in 32-bit words: the histogram and the state (zeroed by the C
// entry), then the per-tile counts (ntiles + 1 pairs), then the images
enum State { kDone, kPrefix, kRank, kThresh, kNeed, kStateWords = 8 };
constexpr long long kHead = kBins + kStateWords;

long long tiles_of(long long n) { return (n + kTile - 1) / kTile; }

// The order-preserving image of an f32 key: a > b as floats (with -0 ==
// +0) exactly where image(a) > image(b) as unsigned.
__device__ __forceinline__ unsigned ordered(float k) {
  if (k == 0.f) k = 0.f;
  const unsigned b = __float_as_uint(k);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

template <bool kGumbel>
__device__ __forceinline__ float draw_key(
    const float* __restrict__ logw, const float* __restrict__ u,
    const unsigned char* __restrict__ mask, long long e) {
  if (mask != nullptr && !mask[e]) return __uint_as_float(0xff800000u);
  const float uu = fmaxf(__ldg(u + e), FLT_MIN);
  return kGumbel ? __ldg(logw + e) - logf(-logf(uu)) : uu;
}

// hist[digit] += 1 for each active lane, one shared atomic per distinct
// digit of the warp. Every lane of the warp calls it.
__device__ __forceinline__ void hist_add(unsigned* hist, unsigned digit,
                                         bool active) {
  const unsigned peers = __match_any_sync(kFull, active ? digit : kFull);
  if (active && (threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(hist + digit, __popc(peers));
}

// Exclusive sum over the block's threads (thread order) and the total.
__device__ __forceinline__ unsigned block_scan(unsigned v, unsigned* total) {
  __shared__ unsigned warp_sums[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned o = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += o;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  unsigned before = 0, all = 0;
  for (int w = 0; w < kWarps; ++w) {
    const unsigned s = warp_sums[w];
    before += w < warp ? s : 0;
    all += s;
  }
  __syncthreads();   // warp_sums is reused by the next call
  *total = all;
  return before + incl - v;
}

// Whether this block is the last of the grid to get here. Every thread's
// global writes before the call are visible to the last block.
__device__ __forceinline__ bool last_block(unsigned* done) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// Adds the block's shared histogram into the global one, skipping zeros.
__device__ __forceinline__ void flush_hist(const unsigned* sh, unsigned* hist,
                                           int bins) {
  __syncthreads();
  for (int i = threadIdx.x; i < bins; i += kThreads)
    if (sh[i] != 0) atomicAdd(hist + i, sh[i]);
}

// In the last block of a pass: the bucket of the global histogram (kB
// bins) that holds the rank-th largest entry (rank >= 1), counted from the
// top bin, the entries in higher bins and in the bucket. Zeroes the
// histogram.
template <int kB>
__device__ void pick_bucket(unsigned* hist, unsigned rank, unsigned* bucket,
                            unsigned* above, unsigned* count) {
  constexpr int kPer = kB >= kThreads ? kB / kThreads : 1;  // bins a thread
  __shared__ unsigned pick[3];
  unsigned c[kPer];
  unsigned local = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {   // descending: position p is bin kB-1-p
    const int p = threadIdx.x * kPer + j;
    c[j] = p < kB ? __ldcg(hist + kB - 1 - p) : 0u;
    local += c[j];
  }
  unsigned total;
  unsigned acc = block_scan(local, &total);
  if (acc < rank && rank <= acc + local) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (acc < rank && rank <= acc + c[j]) {
        pick[0] = kB - 1 - (threadIdx.x * kPer + j);
        pick[1] = acc;
        pick[2] = c[j];
      }
      acc += c[j];
    }
  }
  for (int i = threadIdx.x; i < kB; i += kThreads) hist[i] = 0;
  __syncthreads();
  *bucket = pick[0];
  *above = pick[1];
  *count = pick[2];
}

template <bool kGumbel>
__global__ void __launch_bounds__(kThreads)
topq_keys_kernel(const float* __restrict__ logw, const float* __restrict__ u,
                 const unsigned char* __restrict__ mask, long long n,
                 unsigned q, unsigned* __restrict__ img,
                 unsigned* __restrict__ hist, unsigned* __restrict__ state) {
  __shared__ unsigned sh[kBins];
  for (int i = threadIdx.x; i < kBins; i += kThreads) sh[i] = 0;
  __syncthreads();
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
#pragma unroll 4
  for (int i = 0; i < kItems; ++i) {
    const long long e = base + i * kThreads + threadIdx.x;
    const bool active = e < n;
    unsigned b = 0;
    if (active) {
      b = ordered(draw_key<kGumbel>(logw, u, mask, e));
      img[e] = b;
    }
    hist_add(sh, b >> (32 - kDigit1), active);
  }
  flush_hist(sh, hist, kBins);
  if (!last_block(state + kDone)) return;
  unsigned bucket, above, count;
  pick_bucket<kBins>(hist, q, &bucket, &above, &count);
  if (threadIdx.x == 0) {
    state[kPrefix] = bucket;
    state[kRank] = q - above;
    state[kDone] = 0;
  }
}

// Pass 2 histograms bits 18..8 of the entries whose bits 31..19 are the
// prefix; pass 3 bits 7..0 of those whose bits 31..8 are. After pass 3
// the state holds the threshold image and how many entries equal to it to
// take; ties[0] counts the draws that took fewer than all entries equal to
// the threshold, ties[1] the entries equal to it that they took.
template <int kPass>
__global__ void __launch_bounds__(kThreads)
topq_pass_kernel(const unsigned* __restrict__ img, long long n,
                 unsigned* __restrict__ hist, unsigned* __restrict__ state,
                 unsigned long long* __restrict__ ties) {
  constexpr int kLow = kPass == 2 ? kDigit3 : 0;            // bits below
  constexpr int kWidth = kPass == 2 ? kDigit2 : kDigit3;     // the digit
  constexpr int kHigh = kLow + kWidth;                       // bits above
  constexpr int kPassBins = 1 << kWidth;
  __shared__ unsigned sh[kPassBins];
  for (int i = threadIdx.x; i < kPassBins; i += kThreads) sh[i] = 0;
  __syncthreads();
  const unsigned prefix = state[kPrefix];
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
#pragma unroll 4
  for (int i = 0; i < kItems; ++i) {
    const long long e = base + i * kThreads + threadIdx.x;
    const unsigned b = e < n ? img[e] : 0u;
    const bool active = e < n && (b >> kHigh) == prefix;
    hist_add(sh, (b >> kLow) & (kPassBins - 1), active);
  }
  flush_hist(sh, hist, kPassBins);
  if (!last_block(state + kDone)) return;
  const unsigned rank = state[kRank];
  unsigned bucket, above, count;
  pick_bucket<kPassBins>(hist, rank, &bucket, &above, &count);
  if (threadIdx.x != 0) return;
  if (kPass == 2) {
    state[kPrefix] = (prefix << kWidth) | bucket;
    state[kRank] = rank - above;
  } else {
    const unsigned need = rank - above;
    state[kThresh] = (prefix << kWidth) | bucket;
    state[kNeed] = need;
    if (count > need) {
      atomicAdd(ties, 1ull);
      atomicAdd(ties + 1, static_cast<unsigned long long>(need));
    }
  }
  state[kDone] = 0;
}

// counts[2t], [2t+1]: tile t's entries above and equal to the threshold;
// the last block makes both exclusive prefixes over ntiles + 1 pairs.
__global__ void __launch_bounds__(kThreads)
topq_count_kernel(const unsigned* __restrict__ img, long long n,
                  unsigned* __restrict__ state, unsigned* __restrict__ counts,
                  int ntiles) {
  const unsigned t = state[kThresh];
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  unsigned gt = 0, eq = 0;
#pragma unroll 4
  for (int i = 0; i < kItems; ++i) {
    const long long e = base + i * kThreads + threadIdx.x;
    if (e < n) {
      const unsigned b = img[e];
      gt += b > t;
      eq += b == t;
    }
  }
  unsigned gt_all, eq_all;
  block_scan(gt, &gt_all);
  block_scan(eq, &eq_all);
  if (threadIdx.x == 0) {
    counts[2 * blockIdx.x] = gt_all;
    counts[2 * blockIdx.x + 1] = eq_all;
  }
  if (!last_block(state + kDone)) return;
  unsigned carry_gt = 0, carry_eq = 0;
  for (int t0 = 0; t0 <= ntiles; t0 += kThreads) {
    const int k = t0 + threadIdx.x;
    const bool in = k < ntiles;
    const unsigned g = in ? __ldcg(counts + 2 * k) : 0u;
    const unsigned q = in ? __ldcg(counts + 2 * k + 1) : 0u;
    unsigned g_all, q_all;
    const unsigned g_before = block_scan(g, &g_all);
    const unsigned q_before = block_scan(q, &q_all);
    if (k <= ntiles) {
      counts[2 * k] = carry_gt + g_before;
      counts[2 * k + 1] = carry_eq + q_before;
    }
    carry_gt += g_all;
    carry_eq += q_all;
  }
  if (threadIdx.x == 0) state[kDone] = 0;
}

__global__ void __launch_bounds__(kThreads)
topq_write_kernel(const unsigned* __restrict__ img, long long n,
                  const unsigned* __restrict__ state,
                  const unsigned* __restrict__ counts, int* __restrict__ out) {
  const unsigned t = state[kThresh], need = state[kNeed];
  const unsigned gt_tile0 = counts[2 * blockIdx.x];
  const unsigned eq_tile0 = counts[2 * blockIdx.x + 1];
  if (counts[2 * blockIdx.x + 2] == gt_tile0 &&
      (counts[2 * blockIdx.x + 3] == eq_tile0 || eq_tile0 >= need))
    return;   // no winner in this tile
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1;
  // warp w owns the contiguous entries [w0, w0 + 32 * kItems) of the tile
  const long long w0 = static_cast<long long>(blockIdx.x) * kTile +
                       warp * 32 * kItems;
  unsigned m_gt[kItems], m_eq[kItems];
  unsigned n_gt = 0, n_eq = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long e = w0 + i * 32 + lane;
    const unsigned b = e < n ? img[e] : 0u;
    m_gt[i] = __ballot_sync(kFull, e < n && b > t);
    m_eq[i] = __ballot_sync(kFull, e < n && b == t);
    n_gt += __popc(m_gt[i]);
    n_eq += __popc(m_eq[i]);
  }
  // the warps' offsets: one block scan of (gt, eq) packed, kTile < 2^16
  unsigned all;
  const unsigned before = block_scan(lane == 0 ? (n_eq << 16) | n_gt : 0u,
                                     &all);
  const unsigned from = __shfl_sync(kFull, before, 0);
  unsigned g = gt_tile0 + (from & 0xffffu);
  unsigned q = eq_tile0 + (from >> 16);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long e = w0 + i * 32 + lane;
    const unsigned my_g = g + __popc(m_gt[i] & below);
    const unsigned my_q = q + __popc(m_eq[i] & below);
    if ((m_gt[i] >> lane) & 1u)
      out[my_g + min(my_q, need)] = static_cast<int>(e);
    else if (((m_eq[i] >> lane) & 1u) && my_q < need)
      out[my_g + my_q] = static_cast<int>(e);
    g += __popc(m_gt[i]);
    q += __popc(m_eq[i]);
  }
}

}  // namespace

// The int32 scratch words of a draw over n entries: the histogram and the
// state, (tiles + 1) pairs of counts, then the keys' images (the tail).
extern "C" long long sgs_topq_scratch_words(long long n) {
  return kHead + 2 * (tiles_of(n) + 1) + n;
}

// ids (q int32) of the q largest keys in ascending id. logw: (n,) f32 for
// Gumbel keys, or null for uniform ones; u: (n,) f32; mask: (n,) bool or
// null; scratch: at least sgs_topq_scratch_words(n) int32 words; ties: 2
// uint64 on the card that the draw adds its tie counts to.
// 1 <= q <= n < 2^31.
extern "C" int sgs_topq(const void* logw, const void* u, const void* mask,
                        long long n, long long q, void* scratch,
                        long long scratch_words, void* ties, void* out,
                        void* stream) {
  const long long tiles = tiles_of(n);
  if (q < 1 || q > n || n >= (1LL << 31) ||
      scratch_words < sgs_topq_scratch_words(n))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned ntiles = static_cast<unsigned>(tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* words = static_cast<unsigned*>(scratch);
  unsigned* hist = words;
  unsigned* state = words + kBins;
  unsigned* counts = words + kHead;
  unsigned* img = counts + 2 * (tiles + 1);
  auto* tie = static_cast<unsigned long long*>(ties);
  cudaError_t err = cudaMemsetAsync(words, 0, kHead * sizeof(unsigned), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* lw = static_cast<const float*>(logw);
  const float* up = static_cast<const float*>(u);
  const auto* mp = static_cast<const unsigned char*>(mask);
  const unsigned qq = static_cast<unsigned>(q);
  if (lw != nullptr)
    topq_keys_kernel<true><<<ntiles, kThreads, 0, s>>>(lw, up, mp, n, qq, img,
                                                       hist, state);
  else
    topq_keys_kernel<false><<<ntiles, kThreads, 0, s>>>(lw, up, mp, n, qq,
                                                        img, hist, state);
  topq_pass_kernel<2><<<ntiles, kThreads, 0, s>>>(img, n, hist, state, tie);
  topq_pass_kernel<3><<<ntiles, kThreads, 0, s>>>(img, n, hist, state, tie);
  topq_count_kernel<<<ntiles, kThreads, 0, s>>>(img, n, state, counts,
                                                static_cast<int>(ntiles));
  topq_write_kernel<<<ntiles, kThreads, 0, s>>>(img, n, state, counts,
                                                static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
