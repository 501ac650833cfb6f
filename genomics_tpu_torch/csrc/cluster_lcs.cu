// Greedy clustering's LCS accept, one thread per (representative, job)
// pair, for Hopper (sm_90a).
//
// Replaces _lcs_batch of genomics_tpu/models/cluster.py:192 (jnp, run on
// the TPU), vmapped as _lcs_multi (:266) and fused with the cutoff and the
// filters' pass 2 as _lcs_accept_bits (:425).  For representative reps[s]
// and job jobs[c]:
//   out[s][c] = gate[s][c] && LCS(job, representative) > bcut[job]
// where the LCS is kernel_dynamic's bit-parallel count (bitlcs.cuh): the
// job's net codes, from the first, each update the representative's row;
// a code of 255 leaves it as it is.  The JAX package resolves each step's
// carries with a monotone fix-point over all W words; a carry chain gives
// the same sums, since carries only flow upward (and at most one of the
// two adds of a word carries out).  For the same reason the words at or
// past ceil(rnet / 32), rnet the representative's net length, are not
// computed: they feed no lower word, and the count masks them.
//
// A block serves one representative and kThreads jobs; it stages the
// representative's two planes in shared memory (read from device memory
// where they do not fit).  A thread keeps the row in registers, NW words
// (the smallest of 1, 2, 4, 8, 16, 32 that holds the launch's widest
// representative: ops/lcs.cluster_bucket), or, past 32 words, in a
// [words, pairs] scratch in device memory, word-major so that a warp's
// loads of one word are one run.  A pair the gate rejects runs no LCS:
// its accept is 0 either way.
//
// Bound: integer work, counted as myers.cu counts it (a match-mask select,
// the carrying add and each three-input bitwise function one op).  Per
// word and active query step, 4 operations: the match mask, x = row &
// match, the carrying add, and the OR with row & ~match (one three-input
// function); per active step 5 (the code's load and 255 test, the two
// plane masks, the loop test).  chip_smoke.py counts words x 4 + steps x
// 5 over the gated pairs' active steps and their representatives' words
// (ops/lcs.lcs_accept_plain(stats=)).  The bytes: the gate and the
// accepts, the jobs' codes, and the representatives' planes, read once.
// This is the simple design: one thread a pair, its query codes read a
// byte a step through __ldg.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bitlcs.cuh"

namespace {

constexpr int kThreads = 128;            // jobs a block
constexpr int kPlaneBytes = 200 * 1024;  // planes staged up to this size

template <int NW>
__global__ void __launch_bounds__(kThreads)
cluster_lcs_kernel(const uint32_t* __restrict__ low,
                   const uint32_t* __restrict__ high, int W,
                   const int* __restrict__ net,
                   const uint8_t* __restrict__ codes, long long cs,
                   const int* __restrict__ bcut, const int* __restrict__ reps,
                   const int* __restrict__ jobs, int J,
                   const uint8_t* __restrict__ gate, uint8_t* __restrict__ out,
                   int ld, int max_words, bool staged,
                   uint32_t* __restrict__ scratch) {
  extern __shared__ uint32_t planes[];
  const int s = blockIdx.y;
  const int rep = reps[s];
  const int rnet = net[rep];
  const int wr = (rnet + 31) >> 5;
  const uint32_t* tl = low + static_cast<long long>(rep) * W;
  const uint32_t* th = high + static_cast<long long>(rep) * W;
  if (staged) {
    for (int w = threadIdx.x; w < wr; w += kThreads) {
      planes[w] = __ldg(tl + w);
      planes[max_words + w] = __ldg(th + w);
    }
    __syncthreads();
    tl = planes;
    th = planes + max_words;
  }
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= J) return;
  const long long o = static_cast<long long>(s) * ld + c;
  if (gate != nullptr && gate[o] == 0) {
    out[o] = 0;
    return;
  }
  const int job = jobs[c];
  const int qn = net[job];
  const uint8_t* q = codes + static_cast<long long>(job) * cs;
  int matched = 0;
  if constexpr (NW > 0) {
    uint32_t row[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) row[w] = 0xFFFFFFFFu;
    for (int k = 0; k < qn; ++k) {
      const uint32_t b = __ldg(q + k);
      if (b == 255u) continue;
      const uint32_t ql = bitlcs::plane(b, 0), qh = bitlcs::plane(b, 1);
      uint32_t carry = 0;
#pragma unroll
      for (int w = 0; w < NW; ++w)
        if (w < wr)
          row[w] = bitlcs::step(row[w], bitlcs::match(tl[w], th[w], ql, qh),
                                carry);
    }
#pragma unroll
    for (int w = 0; w < NW; ++w)
      if (w < wr) matched += __popc(~row[w] & bitlcs::mask(rnet, w));
  } else {
    // word w of this pair's row at row[w * P], P the launch's pairs
    const long long P = static_cast<long long>(gridDim.y) * J;
    uint32_t* row = scratch + static_cast<long long>(s) * J + c;
    for (int w = 0; w < wr; ++w) row[w * P] = 0xFFFFFFFFu;
    for (int k = 0; k < qn; ++k) {
      const uint32_t b = __ldg(q + k);
      if (b == 255u) continue;
      const uint32_t ql = bitlcs::plane(b, 0), qh = bitlcs::plane(b, 1);
      uint32_t carry = 0;
      for (int w = 0; w < wr; ++w)
        row[w * P] = bitlcs::step(row[w * P],
                                  bitlcs::match(tl[w], th[w], ql, qh), carry);
    }
    for (int w = 0; w < wr; ++w)
      matched += __popc(~row[w * P] & bitlcs::mask(rnet, w));
  }
  out[o] = matched > bcut[job] ? 1 : 0;
}

template <int NW>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t stream,
                   const uint32_t* low, const uint32_t* high, int W,
                   const int* net, const uint8_t* codes, long long cs,
                   const int* bcut, const int* reps, const int* jobs, int J,
                   const uint8_t* gate, uint8_t* out, int ld, int max_words,
                   bool staged, uint32_t* scratch) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cluster_lcs_kernel<NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  cluster_lcs_kernel<NW><<<grid, kThreads, smem, stream>>>(
      low, high, W, net, codes, cs, bcut, reps, jobs, J, gate, out, ld,
      max_words, staged, scratch);
  return cudaGetLastError();
}

}  // namespace

// low / high: [N, W] uint32 planes; net / bcut: [N] int32; codes: [N, *]
// uint8 rows cs bytes apart (255 past net); reps: [S] and jobs: [J] int32
// read indices; gate: [S, *] uint8 at row stride ld, or null for all;
// out: [S, *] uint8 at row stride ld.  max_words >= ceil(net / 32) of
// every representative; nw: the register words (1, 2, 4, 8, 16 or 32), or
// 0 for the row in `scratch` ([max_words, S * J] uint32).  S and J must be
// at least 1.  Launches on `stream` without synchronising; returns
// cudaGetLastError().
extern "C" int cluster_lcs_launch(const void* low, const void* high, int W,
                                  const void* net, const void* codes,
                                  long long cs, const void* bcut,
                                  const void* reps, int S, const void* jobs,
                                  int J, const void* gate, void* out, int ld,
                                  int max_words, int nw, void* scratch,
                                  void* stream) {
  if (S < 1 || J < 1 || W < 1 || max_words < 0 || ld < J || S > 65535 ||
      (nw == 0 && scratch == nullptr) || (nw > 0 && max_words > nw))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool staged = 8LL * max_words <= kPlaneBytes;
  const size_t smem = staged ? 8 * static_cast<size_t>(max_words) : 0;
  const dim3 grid((J + kThreads - 1) / kThreads, S);
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
#define CLUSTER_LCS_CASE(N)                                                 \
  case N:                                                                   \
    e = launch<N>(grid, smem, st, lo, hi, W, nt, cd, cs, bc, rp, jb, J, gt, \
                  ot, ld, max_words, staged, sc);                           \
    break;
    CLUSTER_LCS_CASE(0)
    CLUSTER_LCS_CASE(1)
    CLUSTER_LCS_CASE(2)
    CLUSTER_LCS_CASE(4)
    CLUSTER_LCS_CASE(8)
    CLUSTER_LCS_CASE(16)
    CLUSTER_LCS_CASE(32)
#undef CLUSTER_LCS_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}
