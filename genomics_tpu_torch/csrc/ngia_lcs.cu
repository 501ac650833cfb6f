// nGIA's accept for Hopper (sm_90a): the word filter over every
// (representative, job) pair, then the banded LCS of the pairs it lets
// through only, each pair's band split over a group of lanes.
//
// Replaces round_body of genomics_tpu/models/ngia.py:91 (folded into up to
// 32 rounds a dispatch by rounds_step, :180) and accept_body (:215), jnp
// run on the TPU.  For representative rep = reps[s] and job j = jobs[c],
// the five steps of func.cu:321-468:
//   1. the word filter: sum over the 256 bins of min(rep's count, j's
//      count);
//   2. thr = max(mlen - ceil(f32(mlen) * f32(1 - sim)) * 4, 1), mlen =
//      min(net[j], net[rep]); the pair goes on where the sum >= thr;
//   3. the banded LCS (bitlcs.cuh): shift = ceil(ceil(net[rep] - net[j] *
//      sim) / 32) words, and query base k (in query word iw = k / 32)
//      updates only row words [iw - shift, iw + shift] clipped to the row,
//      with no carry into the band's lowest word and the carry out of its
//      highest dropped (ngia.py:146's cout & band); a shift below 0 is an
//      empty band: matched 0;
//   4. accept = matched >= ceil(f32(mlen) * f32(sim));
//   5. with `cluster` (a round, one representative): only a job whose
//      cluster is -1 counts, and an accepted one gets cluster[j] = rep in
//      place (one owner a job: the thread of its column, or the lead lane
//      of the group that ran its LCS; the representative accepts itself,
//      which is how the round assigns it); without, out[s][c] = accept
//      (the speculative window), written for every pair.
// A pair that fails the filter, is clustered already or has an empty band
// runs no LCS (the JAX functions compute every pair).
//
// f32 as the JAX package computes it on the CPU, bit for bit: XLA
// contracts shift_f = ceil(rep - net * sim) into one fma, written out here
// as __fmaf_rn so that it does not depend on nvcc's contraction; thr's and
// the cutoff's products are single roundings (__fmul_rn, no contraction).
// The words at or past ceil(net[rep] / 32) are not computed: they feed no
// lower word.
//
// Design.  A block serves one representative (blockIdx.y) and `chunk`
// job columns, the fewest (a multiple of 32) that keep the launch to one
// wave of blocks (bitlcs::chunk_for), so that every LCS pair starts at
// once.  First the throughput pass, a warp a job over the warp's slices
// of 32 columns (lane l owns column l of a slice): lane l compares bins
// [8l, 8l + 8) of the job's 512-byte histogram, one coalesced 16-byte
// load a lane, with the representative's same bins, which the lane keeps
// in registers for the block's life (the whole histogram is one 16-byte
// load a lane, so it needs no shared copy); unsigned 16-bit SIMD minima,
// five shuffles for the sum, kBatch jobs in flight; a warp takes only the
// jobs still unclustered.  Each lane then tests its own columns, writes
// the accept of a pair that runs no LCS, and the block compacts the rest
// into two lists in shared memory: the pairs whose band fits a group and
// those whose band is wider.  Then the latency pass: the block's lane
// groups take the first list's pairs in turn, G lanes a pair, K band
// slots a lane with their planes in registers (bitlcs.cuh's group_lcs),
// the band sliding up a word every 32 query bases by a shuffle down the
// group.  G x K is the smallest of 1, 2, 4, 8, 16, 32, 64, 128 at least
// 2 * shift + 1 of the launch's widest band, at most 128
// (ops/lcs.ngia_bucket; K = 2 at 64 words, 4 at 128): 5 words (shift 2) at
// bench_ngia's 1,200 bp run 4 pairs a warp at G = 8.  Then the block's
// warps take the second list's pairs, a warp a pair, the whole row in the
// warp's slot of max_words words of shared memory, or of `scratch` where
// the wrapper passes one (bitlcs.cuh's wide_lcs).  A block whose lists
// hold thread_min pairs or more (a launch argument, ops/lcs.thread_min),
// in a launch of at least a wave of blocks (bitlcs::launch_shape; a
// launch bound by the LCS's work, not by one pair's chain, such as a
// mixed-length window), runs them a thread each instead, the rows in
// shared memory (bitlcs.cuh's thread_lcs).
//
// Bound: integer work, counted as cluster_lcs.cu counts it.  Per band word
// (below ceil(net[rep] / 32)) and active query step, 4 operations; per
// active step 5; per filter bin 2 (the min, the add).  chip_smoke.py
// counts bins x 2 + band words x 4 + steps x 5 over the pairs the filter
// sees, the pairs that run the LCS and their steps
// (ops/lcs.banded_lcs_accept_plain(stats=)); the ballots and shuffles are
// the design's own and not counted.  The bytes: the jobs' histograms (512
// bytes each) and codes, the representatives' histograms and planes, the
// accepts (or the cluster words), read or written once.  A serial round
// has a few LCS pairs, so its launch is bound by one pair's 1,200 steps
// times a step's latency, not by either count.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bitlcs.cuh"

namespace {

constexpr int kThreads = 128;  // a block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 4096;  // job columns a block at most
constexpr int kBins = 256;     // the 4-mer histogram
constexpr int kBatch = 8;      // histograms a warp has in flight
constexpr int kSharedWords = 12288;  // a warp's row in shared memory

// Sum over a lane's 8 bins (two 16-bit counts a word) of min(a, b).
__device__ __forceinline__ int min_sum8(uint4 a, uint4 b) {
  const uint32_t m[4] = {__vminu2(a.x, b.x), __vminu2(a.y, b.y),
                         __vminu2(a.z, b.z), __vminu2(a.w, b.w)};
  int v = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    v += static_cast<int>((m[e] & 0xFFFFu) + (m[e] >> 16));
  return v;
}

// The band's half-width in words: ceil(ceil(f32 fma(-qn, sim, rnet)) / 32).
__device__ __forceinline__ int band_shift(int rnet, int qn, float sim) {
  const float f = ceilf(__fmaf_rn(-static_cast<float>(qn), sim,
                                  static_cast<float>(rnet)));
  return static_cast<int>(ceilf(f * 0.03125f));
}

// 4-5. the cutoff, matched >= ceil(f32(mlen) * f32(sim)), and the write:
// the window's accept, or a round's cluster word where it accepts.
__device__ __forceinline__ void accept_write(int matched, int qn, int rnet,
                                             float sim, int* cluster,
                                             uint8_t* out, int s, int ld,
                                             int c, int j, int rep) {
  const float mlen = static_cast<float>(min(qn, rnet));
  const bool accept =
      matched >= static_cast<int>(ceilf(__fmul_rn(mlen, sim)));
  if (cluster == nullptr)
    out[static_cast<long long>(s) * ld + c] = accept ? 1 : 0;
  else if (accept)
    cluster[j] = rep;
}

// G lanes a pair, K words a lane; bands of more than G x K words a warp a
// pair.
template <int G, int K>
__global__ void __launch_bounds__(kThreads)
ngia_lcs_kernel(const uint16_t* __restrict__ words,
                const int* __restrict__ net, const uint32_t* __restrict__ low,
                const uint32_t* __restrict__ high, int W,
                const uint8_t* __restrict__ codes, long long cs,
                const int* __restrict__ reps, const int* __restrict__ jobs,
                int J, float sim, float oms, int* __restrict__ cluster,
                uint8_t* __restrict__ out, int ld, int chunk, int max_words,
                int thread_min, uint32_t* __restrict__ scratch) {
  __shared__ int list[kMaxChunk];
  __shared__ int sums[kWarps];
  // with thread_min, the match masks [4, max_words] and a thread's row
  // ([max_words, kThreads]); else a warp's row (max_words words)
  extern __shared__ uint32_t smem[];
  uint32_t* mt = smem;
  uint32_t* rows = smem + (thread_min > 0 ? 4 * max_words : 0);
  const int s = blockIdx.y;
  const int rep = reps[s];
  const int rnet = net[rep];
  const uint32_t* tl = low + static_cast<long long>(rep) * W;
  const uint32_t* th = high + static_cast<long long>(rep) * W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint4 rb = __ldg(reinterpret_cast<const uint4*>(
                             words + static_cast<long long>(rep) * kBins) +
                         lane);
  const int first = blockIdx.x * chunk;
  // bit k: slice warp + kWarps k, this lane's column, runs the LCS (in a
  // group, or, in `wide`, a warp to itself)
  uint32_t runs = 0, wide = 0;
  for (int k = 0, sl = warp; 32 * sl < chunk; ++k, sl += kWarps) {
    const int c = first + 32 * sl + lane;
    if (__all_sync(bitlcs::kFull, c >= J)) break;
    const int j = c < J ? jobs[c] : 0;
    const bool mine = c < J && (cluster == nullptr || cluster[j] == -1);
    // 1. the word filter, a warp a job: lane `src` of the warp owns it
    int sum = 0;
    uint32_t todo = __ballot_sync(bitlcs::kFull, mine);
    while (todo) {
      int src[kBatch];
      uint4 h[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        src[u] = todo ? __ffs(todo) - 1 : -1;
        todo &= todo - 1;
        const int ju = __shfl_sync(bitlcs::kFull, j, src[u] & 31);
        h[u] = src[u] >= 0
                   ? __ldg(reinterpret_cast<const uint4*>(
                               words + static_cast<long long>(ju) * kBins) +
                           lane)
                   : make_uint4(0, 0, 0, 0);
      }
      int v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) v[u] = min_sum8(h[u], rb);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          v[u] += __shfl_xor_sync(bitlcs::kFull, v[u], o);
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (lane == src[u]) sum = v[u];
    }
    // 2. this column's threshold; the pairs that run no LCS answer now
    const int qn = c < J ? net[j] : 0;
    const int mlen = min(qn, rnet);
    const int thr = max(
        mlen -
            static_cast<int>(ceilf(__fmul_rn(static_cast<float>(mlen), oms))) *
                4,
        1);
    const bool passed = mine && sum >= thr;
    const int shift = band_shift(rnet, qn, sim);
    if (passed && shift >= 0) {
      runs |= 1u << k;
      if (2 * shift + 1 > G * K) wide |= 1u << k;
    } else if (c < J) {
      // an empty band matches 0 bases
      const bool accept =
          passed &&
          static_cast<int>(ceilf(__fmul_rn(static_cast<float>(mlen), sim))) <=
              0;
      if (cluster == nullptr)
        out[static_cast<long long>(s) * ld + c] = accept ? 1 : 0;
      else if (accept)
        cluster[j] = rep;
    }
  }
  // the lists: bands that fit a group first, the wider after them (two
  // counts in the halves of one scan)
  int total;
  const int at = bitlcs::block_offset<kWarps>(
      __popc(runs & ~wide) + (__popc(wide) << 16), sums, total);
  const int n_narrow = total & 0xFFFF, n_wide = total >> 16;
  int an = at & 0xFFFF, aw = n_narrow + (at >> 16);
  for (uint32_t m = runs; m != 0; m &= m - 1) {
    const int k = __ffs(m) - 1;
    list[(wide >> k & 1) ? aw++ : an++] =
        first + 32 * (warp + kWarps * k) + lane;
  }
  __syncthreads();
  // 3-5. the banded LCS of each survivor, the cutoff and the write: both
  // lists a thread a pair where the block has many, else the first a
  // group of G lanes a pair, the second a warp a pair
  if (thread_min > 0 && n_narrow + n_wide >= thread_min) {
    bitlcs::match_table(mt, max_words, tl, th, (rnet + 31) >> 5, kThreads);
    __syncthreads();
    for (int item = threadIdx.x; item < n_narrow + n_wide;
         item += kThreads) {
      const int cc = list[item];
      const int jj = jobs[cc];
      const int qj = net[jj];
      const int matched = bitlcs::thread_lcs<true>(
          mt, max_words, rnet, codes + static_cast<long long>(jj) * cs, qj,
          band_shift(rnet, qj, sim), rows + threadIdx.x, kThreads);
      accept_write(matched, qj, rnet, sim, cluster, out, s, ld, cc, jj, rep);
    }
    return;
  }
  uint32_t* row =
      (scratch != nullptr
           ? scratch + (static_cast<long long>(blockIdx.y) * gridDim.x +
                        blockIdx.x) * kWarps * max_words
           : rows) +
      static_cast<long long>(warp) * max_words;
  for (int pass = 0; pass < 2; ++pass) {
    const int per = pass == 0 ? G : 32;
    const int n = pass == 0 ? n_narrow : n_wide;
    const int base = pass == 0 ? 0 : n_narrow;
    for (int i0 = 0; i0 < n; i0 += kThreads / per) {
      const int item = i0 + static_cast<int>(threadIdx.x) / per;
      const int cc = item < n ? list[base + item] : -1;
      const int jj = cc >= 0 ? jobs[cc] : 0;
      const int qj = cc >= 0 ? net[jj] : 0;
      const int sh = cc >= 0 ? band_shift(rnet, qj, sim) : 0;
      const uint8_t* q = codes + static_cast<long long>(jj) * cs;
      // a warp without a pair touches no row (one of 0 words)
      const int matched =
          pass == 0
              ? bitlcs::group_lcs<G, K, true>(tl, th, rnet, q, qj, sh)
              : bitlcs::wide_lcs<true>(tl, th, cc >= 0 ? rnet : 0, q, qj, sh,
                                       row);
      if (cc >= 0 && (threadIdx.x & (per - 1)) == 0)
        accept_write(matched, qj, rnet, sim, cluster, out, s, ld, cc, jj,
                     rep);
    }
  }
}

template <int G, int K>
cudaError_t launch(int S, int J, cudaStream_t stream, const uint16_t* words,
                   const int* net, const uint32_t* low, const uint32_t* high,
                   int W, const uint8_t* codes, long long cs, const int* reps,
                   const int* jobs, float sim, float oms, int* cluster,
                   uint8_t* out, int ld, int max_words, int thread_min,
                   uint32_t* scratch) {
  size_t smem = 0;
  int chunk = 0;
  const cudaError_t e = bitlcs::launch_shape(
      ngia_lcs_kernel<G, K>, kThreads, S, J, max_words, scratch != nullptr,
      kMaxChunk, thread_min, smem, chunk);
  if (e != cudaSuccess) return e;
  const dim3 grid((J + chunk - 1) / chunk, S);
  ngia_lcs_kernel<G, K><<<grid, kThreads, smem, stream>>>(
      words, net, low, high, W, codes, cs, reps, jobs, J, sim, oms, cluster,
      out, ld, chunk, max_words, thread_min, scratch);
  return cudaGetLastError();
}

}  // namespace

// words: [N, 256] uint16 histograms (rows 16-byte aligned); net: [N]
// int32; low / high: [N, W] uint32 planes; codes: [N, *] uint8 rows cs
// bytes apart (255 past net; the base and cs multiples of 16); reps: [S]
// and jobs: [J] int32 read indices; sim: f32(sim); oms: f32(1 - sim);
// cluster: [N] int32 for a round (S must be 1; out null), else null and
// out: [S, *] uint8 at row stride ld.  max_words >= ceil(net / 32) of
// every representative; bw: the band words a group holds, G x K (1, 2,
// 4, 8, 16, 32, 64 or 128; G = min(bw, 32) lanes a pair): a pair whose
// band 2 * shift + 1 is wider runs a warp to itself, its row in shared
// memory (kWarps x max_words words a block, at most kSharedWords a warp),
// or, with `scratch`, in device memory ([S, ceil(J / 32), kWarps,
// max_words] uint32 at least).  thread_min: a block whose lists hold this
// many pairs or more runs them a thread each, the rows in shared memory
// ((4 + kThreads) x max_words words a block; no `scratch`); 0 for never,
// and taken as 0 where blocks of 32 columns fill less than a wave.  S and
// J must be at least 1.  Launches on `stream` without synchronising;
// returns the first CUDA error.
extern "C" int ngia_lcs_launch(const void* words, const void* net,
                               const void* low, const void* high, int W,
                               const void* codes, long long cs,
                               const void* reps, int S, const void* jobs,
                               int J, float sim, float oms, void* cluster,
                               void* out, int ld, int max_words, int bw,
                               int thread_min, void* scratch, void* stream) {
  if (S < 1 || J < 1 || W < 1 || max_words < 0 || ld < J || S > 65535 ||
      thread_min < 0 || (thread_min > 0 && scratch != nullptr) ||
      (cluster == nullptr) == (out == nullptr) ||
      (cluster != nullptr && S != 1) ||
      (scratch == nullptr && max_words > kSharedWords) ||
      reinterpret_cast<uintptr_t>(words) % 16 != 0 || cs % 16 != 0 ||
      reinterpret_cast<uintptr_t>(codes) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* wd = static_cast<const uint16_t*>(words);
  const auto* nt = static_cast<const int*>(net);
  const auto* lo = static_cast<const uint32_t*>(low);
  const auto* hi = static_cast<const uint32_t*>(high);
  const auto* cd = static_cast<const uint8_t*>(codes);
  const auto* rp = static_cast<const int*>(reps);
  const auto* jb = static_cast<const int*>(jobs);
  auto* cl = static_cast<int*>(cluster);
  auto* ot = static_cast<uint8_t*>(out);
  auto* sc = static_cast<uint32_t*>(scratch);
  cudaError_t e;
  switch (bw) {
#define NGIA_LCS_CASE(B, G, K)                                              \
  case B:                                                                   \
    e = launch<G, K>(S, J, st, wd, nt, lo, hi, W, cd, cs, rp, jb,           \
                     sim, oms, cl, ot, ld, max_words, thread_min, sc);      \
    break;
    NGIA_LCS_CASE(1, 1, 1)
    NGIA_LCS_CASE(2, 2, 1)
    NGIA_LCS_CASE(4, 4, 1)
    NGIA_LCS_CASE(8, 8, 1)
    NGIA_LCS_CASE(16, 16, 1)
    NGIA_LCS_CASE(32, 32, 1)
    NGIA_LCS_CASE(64, 32, 2)
    NGIA_LCS_CASE(128, 32, 4)
#undef NGIA_LCS_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}
