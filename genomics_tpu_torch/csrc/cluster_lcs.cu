// Greedy clustering's LCS accept, for Hopper (sm_90a): the gate over every
// (representative, job) pair, then the LCS of the pairs it lets through
// only, each pair's row split over a group of lanes.
//
// Replaces _lcs_batch of genomics_tpu/models/cluster.py:192 (jnp, run on
// the TPU), vmapped as _lcs_multi (:266) and fused with the cutoff and the
// filters' pass 2 as _lcs_accept_bits (:425).  For representative reps[s]
// and job jobs[c]:
//   out[s][c] = gate[s][c] && LCS(job, representative) > bcut[job]
// where the LCS is kernel_dynamic's bit-parallel count (bitlcs.cuh): the
// job's net codes, from the first, each update the representative's row;
// a code of 255 leaves it as it is.  The JAX package resolves each step's
// carries with a monotone fix-point over all W words; carry-lookahead gives
// the same sums, since carries only flow upward (and at most one of the
// two adds of a word carries out).  For the same reason the words at or
// past ceil(rnet / 32), rnet the representative's net length, are not
// computed: they feed no lower word, and the count masks them.
//
// Design.  A block serves one representative (blockIdx.y) and `chunk`
// job columns, the fewest (a multiple of 32) that keep the launch to one
// wave of blocks (bitlcs::chunk_for), so that every gated pair starts at
// once.  First the throughput pass: each warp gates its slices of 32
// columns (a coalesced byte a lane), writes 0 for those the gate rejects,
// and the block compacts the rest into a list in shared memory (a warp
// scan of the threads' counts, the warps' totals in shared memory).  Then
// the latency pass: the block's lane groups take the list's pairs in
// turn, G lanes a pair, K row words a lane with their planes in
// registers (bitlcs.cuh's group_lcs): G x K is the smallest of 1, 2, 4,
// 8, 16, 32, 64, 128 that holds the launch's widest representative, at
// most 128 (ops/lcs.cluster_bucket; K = 2 at 64 words, 4 at 128), so
// a warp runs 32 / G pairs at once; a step is a lookahead over the warp,
// not a chain over the words.  A block whose representative is wider
// than G x K words (past 128) runs its pairs a warp each, the row in the
// warp's slot of max_words words of shared memory, or of `scratch` where
// the wrapper passes one (bitlcs.cuh's wide_lcs).  Lane 0 of a group writes its
// pair's accept: every out word has one writer.  A block whose list
// holds thread_min pairs or more (a launch argument, ops/lcs.thread_min),
// in a launch of at least a wave of blocks (bitlcs::launch_shape; a
// launch bound by the LCS's work, not by one pair's chain, such as every
// column gated), runs them a thread each instead, the rows in shared
// memory (bitlcs.cuh's thread_lcs).
//
// Bound: integer work, counted as myers.cu counts it (a match-mask select,
// the carrying add and each three-input bitwise function one op).  Per
// word and active query step, 4 operations: the match mask, x = row &
// match, the carrying add, and the OR with row & ~match (one three-input
// function); per active step 5 (the code's load and 255 test, the two
// plane masks, the loop test).  chip_smoke.py counts words x 4 + steps x
// 5 over the gated pairs' active steps and their representatives' words
// (ops/lcs.lcs_accept_plain(stats=)); the lookahead's ballots and the
// codes' shuffles are the design's own and not counted.  The bytes: the
// gate and the accepts, the jobs' codes, and the representatives' planes,
// read once.  A pair's steps stay a serial chain, so a launch with few
// gated pairs is bound by one pair's steps times a step's latency.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bitlcs.cuh"

namespace {

constexpr int kThreads = 128;  // a block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 4096;  // job columns a block at most
constexpr int kSharedWords = 12288;  // a warp's row in shared memory

// G lanes a pair, K words a lane; rows of more than G x K words a warp a
// pair.
template <int G, int K>
__global__ void __launch_bounds__(kThreads)
cluster_lcs_kernel(const uint32_t* __restrict__ low,
                   const uint32_t* __restrict__ high, int W,
                   const int* __restrict__ net,
                   const uint8_t* __restrict__ codes, long long cs,
                   const int* __restrict__ bcut, const int* __restrict__ reps,
                   const int* __restrict__ jobs, int J,
                   const uint8_t* __restrict__ gate, uint8_t* __restrict__ out,
                   int ld, int chunk, int max_words, int thread_min,
                   uint32_t* __restrict__ scratch) {
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
  const long long row0 = static_cast<long long>(s) * ld;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // 1. the gate over the warp's slices of 32 columns, and the list
  const int first = blockIdx.x * chunk;
  uint32_t mine = 0;  // bit k: slice warp + kWarps k, this lane's column
  for (int k = 0, sl = warp; 32 * sl < chunk; ++k, sl += kWarps) {
    const int c = first + 32 * sl + lane;
    if (c >= J) break;
    if (gate == nullptr || gate[row0 + c] != 0)
      mine |= 1u << k;
    else
      out[row0 + c] = 0;
  }
  int total;
  int at = bitlcs::block_offset<kWarps>(__popc(mine), sums, total);
  for (uint32_t m = mine; m != 0; m &= m - 1)
    list[at++] = first + 32 * (warp + kWarps * (__ffs(m) - 1)) + lane;
  __syncthreads();
  // 2. the LCS of each survivor: a thread each where the block has many,
  // else a group of G lanes, or a warp where the representative is wider
  // than G x K words (the same for the whole block)
  if (thread_min > 0 && total >= thread_min) {
    bitlcs::match_table(mt, max_words, tl, th, (rnet + 31) >> 5, kThreads);
    __syncthreads();
    for (int item = threadIdx.x; item < total; item += kThreads) {
      const int c = list[item];
      const int job = jobs[c];
      const int matched = bitlcs::thread_lcs<false>(
          mt, max_words, rnet, codes + static_cast<long long>(job) * cs,
          net[job], 0, rows + threadIdx.x, kThreads);
      out[row0 + c] = matched > bcut[job] ? 1 : 0;
    }
    return;
  }
  const bool wide = rnet > 32 * G * K;
  const int per = wide ? 32 : G;
  uint32_t* row =
      (scratch != nullptr
           ? scratch + (static_cast<long long>(blockIdx.y) * gridDim.x +
                        blockIdx.x) * kWarps * max_words
           : rows) +
      static_cast<long long>(warp) * max_words;
  for (int i0 = 0; i0 < total; i0 += kThreads / per) {
    const int item = i0 + static_cast<int>(threadIdx.x) / per;
    const int c = item < total ? list[item] : -1;
    const int job = c >= 0 ? jobs[c] : 0;
    const int qn = c >= 0 ? net[job] : 0;
    const uint8_t* q = codes + static_cast<long long>(job) * cs;
    // a warp without a pair touches no row (one of 0 words)
    const int matched =
        wide ? bitlcs::wide_lcs<false>(tl, th, c >= 0 ? rnet : 0, q, qn, 0,
                                       row)
             : bitlcs::group_lcs<G, K, false>(tl, th, rnet, q, qn, 0);
    if (c >= 0 && (threadIdx.x & (per - 1)) == 0)
      out[row0 + c] = matched > bcut[job] ? 1 : 0;
  }
}

template <int G, int K>
cudaError_t launch(int S, int J, cudaStream_t stream, const uint32_t* low,
                   const uint32_t* high, int W, const int* net,
                   const uint8_t* codes, long long cs, const int* bcut,
                   const int* reps, const int* jobs, const uint8_t* gate,
                   uint8_t* out, int ld, int max_words, int thread_min,
                   uint32_t* scratch) {
  size_t smem = 0;
  int chunk = 0;
  const cudaError_t e = bitlcs::launch_shape(
      cluster_lcs_kernel<G, K>, kThreads, S, J, max_words, scratch != nullptr,
      kMaxChunk, thread_min, smem, chunk);
  if (e != cudaSuccess) return e;
  const dim3 grid((J + chunk - 1) / chunk, S);
  cluster_lcs_kernel<G, K><<<grid, kThreads, smem, stream>>>(
      low, high, W, net, codes, cs, bcut, reps, jobs, J, gate, out, ld, chunk,
      max_words, thread_min, scratch);
  return cudaGetLastError();
}

}  // namespace

// low / high: [N, W] uint32 planes; net / bcut: [N] int32; codes: [N, *]
// uint8 rows cs bytes apart (255 past net; the base and cs multiples of
// 16); reps: [S] and jobs: [J] int32 read indices; gate: [S, *] uint8 at
// row stride ld, or null for all; out: [S, *] uint8 at row stride ld.
// max_words >= ceil(net / 32) of every representative; nw: the row words
// a group holds, G x K (1, 2, 4, 8, 16, 32, 64 or 128; G = min(nw, 32)
// lanes a pair): a representative of more words runs a warp a pair, its
// row in shared memory (kWarps x max_words words a block, at most
// kSharedWords a warp), or, with `scratch`, in device memory ([S,
// ceil(J / 32), kWarps, max_words] uint32 at least).  thread_min: a block
// whose list holds this many pairs or more runs them a thread each, the
// rows in shared memory ((4 + kThreads) x max_words words a block; no
// `scratch`); 0 for never, and taken as 0 where blocks of 32 columns
// fill less than a wave.  S and J must be at least 1.  Launches on
// `stream` without synchronising; returns the first CUDA error.
extern "C" int cluster_lcs_launch(const void* low, const void* high, int W,
                                  const void* net, const void* codes,
                                  long long cs, const void* bcut,
                                  const void* reps, int S, const void* jobs,
                                  int J, const void* gate, void* out, int ld,
                                  int max_words, int nw, int thread_min,
                                  void* scratch, void* stream) {
  if (S < 1 || J < 1 || W < 1 || max_words < 0 || ld < J || S > 65535 ||
      thread_min < 0 || (thread_min > 0 && scratch != nullptr) ||
      (scratch == nullptr && max_words > kSharedWords) || cs % 16 != 0 ||
      reinterpret_cast<uintptr_t>(codes) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* lo = static_cast<const uint32_t*>(low);
  const auto* hi = static_cast<const uint32_t*>(high);
  const auto* nt = static_cast<const int*>(net);
  const auto* cd = static_cast<const uint8_t*>(codes);
  const auto* bc = static_cast<const int*>(bcut);
  const auto* rp = static_cast<const int*>(reps);
  const auto* jb = static_cast<const int*>(jobs);
  const auto* gt = static_cast<const uint8_t*>(gate);
  auto* ot = static_cast<uint8_t*>(out);
  auto* sc = static_cast<uint32_t*>(scratch);
  cudaError_t e;
  switch (nw) {
#define CLUSTER_LCS_CASE(N, G, K)                                           \
  case N:                                                                   \
    e = launch<G, K>(S, J, st, lo, hi, W, nt, cd, cs, bc, rp, jb, gt,       \
                     ot, ld, max_words, thread_min, sc);                    \
    break;
    CLUSTER_LCS_CASE(1, 1, 1)
    CLUSTER_LCS_CASE(2, 2, 1)
    CLUSTER_LCS_CASE(4, 4, 1)
    CLUSTER_LCS_CASE(8, 8, 1)
    CLUSTER_LCS_CASE(16, 16, 1)
    CLUSTER_LCS_CASE(32, 32, 1)
    CLUSTER_LCS_CASE(64, 32, 2)
    CLUSTER_LCS_CASE(128, 32, 4)
#undef CLUSTER_LCS_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}
