// nGIA's accept, one thread per (representative, job) pair, for Hopper
// (sm_90a).
//
// Replaces round_body of genomics_tpu/models/ngia.py:91 (folded into up to
// 32 rounds a dispatch by rounds_step, :180) and accept_body (:215), jnp
// run on the TPU.  For representative rep = reps[s] and job j = jobs[c],
// the five steps of func.cu:321-468 in one thread:
//   1. the word filter: sum over the 256 bins of min(rep's count, j's
//      count), the representative's histogram in shared memory;
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
//      place (a thread owns its job, so no two threads write one word; the
//      representative accepts itself, which is how the round assigns it);
//      without, out[s][c] = accept (the speculative window).
// A pair that fails the filter, or is clustered already, runs no LCS: its
// accept is false either way (the JAX functions compute every pair).
//
// f32 as the JAX package computes it on the CPU, bit for bit: XLA
// contracts shift_f = ceil(rep - net * sim) into one fma, written out here
// as __fmaf_rn so that it does not depend on nvcc's contraction; thr's and
// the cutoff's products are single roundings (__fmul_rn, no contraction).
// The words at or past ceil(net[rep] / 32) are not computed: they feed no
// lower word.
//
// The band's window slides up one word every 32 query bases, so a thread
// keeps BW = 2 * shift + 1 row words in registers (the smallest of 1, 3,
// 5, 9, 17, 33 that holds the launch's widest band: ops/lcs.ngia_bucket),
// slot t holding word iw - shift + t: when iw moves on, slot 0's word
// leaves the band for good, its zero bits are counted and the slots move
// down one.  Past 33 words the whole row lives in a [words, pairs] scratch
// in device memory, word-major, and a step loops over the band's words.
//
// Bound: integer work, counted as cluster_lcs.cu counts it.  Per band word
// (below ceil(net[rep] / 32)) and active query step, 4 operations; per
// active step 5; per filter bin 2 (the min, the add).  chip_smoke.py
// counts bins x 2 + band words x 4 + steps x 5 over the pairs the filter
// sees, the pairs that run the LCS and their steps
// (ops/lcs.banded_lcs_accept_plain(stats=)).  The bytes: the jobs'
// histograms (512 bytes each) and codes, the representatives' histograms
// and planes, the accepts (or the cluster words), read or written once.
// This is the simple design: one thread a pair, a job's histogram read 16
// bytes a load and its codes a byte a step through __ldg.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bitlcs.cuh"

namespace {

constexpr int kThreads = 128;            // jobs a block
constexpr int kBins = 256;               // the 4-mer histogram
constexpr int kPlaneBytes = 200 * 1024;  // planes staged up to this size

// Zero bits below the text of word (value v, index w).
__device__ __forceinline__ int zeros(uint32_t v, int rnet, int w) {
  return __popc(~v & bitlcs::mask(rnet, w));
}

template <int BW>
__device__ int banded_lcs(const uint32_t* tl, const uint32_t* th,
                          const uint8_t* __restrict__ q, int qn, int rnet,
                          int wr, int shift, uint32_t* row, long long P) {
  int matched = 0;
  if constexpr (BW > 0) {
    uint32_t win[BW];
#pragma unroll
    for (int t = 0; t < BW; ++t) win[t] = 0xFFFFFFFFu;
    int base = -shift;  // the word slot 0 holds
    const int top = 2 * shift;
    for (int k = 0; k < qn; ++k) {
      if (k != 0 && (k & 31) == 0) {
        if (base >= 0 && base < wr) matched += zeros(win[0], rnet, base);
#pragma unroll
        for (int t = 0; t + 1 < BW; ++t) win[t] = win[t + 1];
        win[BW - 1] = 0xFFFFFFFFu;
        ++base;
      }
      const uint32_t b = __ldg(q + k);
      if (b == 255u) continue;
      const uint32_t ql = bitlcs::plane(b, 0), qh = bitlcs::plane(b, 1);
      uint32_t carry = 0;
#pragma unroll
      for (int t = 0; t < BW; ++t) {
        const int w = base + t;
        if (t <= top && w >= 0 && w < wr)
          win[t] = bitlcs::step(win[t], bitlcs::match(tl[w], th[w], ql, qh),
                                carry);
      }
    }
#pragma unroll
    for (int t = 0; t < BW; ++t) {
      const int w = base + t;
      if (w >= 0 && w < wr) matched += zeros(win[t], rnet, w);
    }
  } else {
    for (int w = 0; w < wr; ++w) row[w * P] = 0xFFFFFFFFu;
    for (int k = 0; k < qn; ++k) {
      const uint32_t b = __ldg(q + k);
      if (b == 255u) continue;
      const uint32_t ql = bitlcs::plane(b, 0), qh = bitlcs::plane(b, 1);
      const int iw = k >> 5;
      const int hi = min(wr - 1, iw + shift);
      uint32_t carry = 0;
      for (int w = max(0, iw - shift); w <= hi; ++w)
        row[w * P] = bitlcs::step(row[w * P],
                                  bitlcs::match(tl[w], th[w], ql, qh), carry);
    }
    for (int w = 0; w < wr; ++w) matched += zeros(row[w * P], rnet, w);
  }
  return matched;
}

template <int BW>
__global__ void __launch_bounds__(kThreads)
ngia_lcs_kernel(const uint16_t* __restrict__ words,
                const int* __restrict__ net, const uint32_t* __restrict__ low,
                const uint32_t* __restrict__ high, int W,
                const uint8_t* __restrict__ codes, long long cs,
                const int* __restrict__ reps, const int* __restrict__ jobs,
                int J, float sim, float oms, int* __restrict__ cluster,
                uint8_t* __restrict__ out, int ld, int max_words, bool staged,
                uint32_t* __restrict__ scratch) {
  __shared__ int hist[kBins];
  extern __shared__ uint32_t planes[];
  const int s = blockIdx.y;
  const int rep = reps[s];
  const int rnet = net[rep];
  const int wr = (rnet + 31) >> 5;
  const uint32_t* tl = low + static_cast<long long>(rep) * W;
  const uint32_t* th = high + static_cast<long long>(rep) * W;
  for (int b = threadIdx.x; b < kBins; b += kThreads)
    hist[b] = words[static_cast<long long>(rep) * kBins + b];
  if (staged) {
    for (int w = threadIdx.x; w < wr; w += kThreads) {
      planes[w] = __ldg(tl + w);
      planes[max_words + w] = __ldg(th + w);
    }
    tl = planes;
    th = planes + max_words;
  }
  __syncthreads();
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= J) return;
  const int j = jobs[c];
  if (cluster != nullptr && cluster[j] != -1) return;
  const int qn = net[j];
  // 1-2. the word filter
  const uint4* wj = reinterpret_cast<const uint4*>(
      words + static_cast<long long>(j) * kBins);
  int sum = 0;
#pragma unroll 4
  for (int v = 0; v < kBins / 8; ++v) {
    const uint4 u = __ldg(wj + v);
    const uint32_t part[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int b = 8 * v + 2 * e;
      sum += min(static_cast<int>(part[e] & 0xFFFFu), hist[b]) +
             min(static_cast<int>(part[e] >> 16), hist[b + 1]);
    }
  }
  const int mlen = min(qn, rnet);
  const int thr = max(
      mlen - static_cast<int>(ceilf(__fmul_rn(static_cast<float>(mlen), oms))) *
                 4,
      1);
  bool accept = false;
  if (sum >= thr) {
    // 3-4. the banded LCS and the cutoff
    const float shift_f = ceilf(__fmaf_rn(-static_cast<float>(qn), sim,
                                          static_cast<float>(rnet)));
    const int shift = static_cast<int>(ceilf(shift_f * 0.03125f));
    const long long P = static_cast<long long>(gridDim.y) * J;
    const uint8_t* q = codes + static_cast<long long>(j) * cs;
    uint32_t* row = scratch + static_cast<long long>(s) * J + c;
    const int matched =
        shift < 0 ? 0 : banded_lcs<BW>(tl, th, q, qn, rnet, wr, shift, row, P);
    accept = matched >= static_cast<int>(
                            ceilf(__fmul_rn(static_cast<float>(mlen), sim)));
  }
  // 5. the round's assignment, or the window's accept
  if (cluster != nullptr) {
    if (accept) cluster[j] = rep;
  } else {
    out[static_cast<long long>(s) * ld + c] = accept ? 1 : 0;
  }
}

template <int BW>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t stream,
                   const uint16_t* words, const int* net, const uint32_t* low,
                   const uint32_t* high, int W, const uint8_t* codes,
                   long long cs, const int* reps, const int* jobs, int J,
                   float sim, float oms, int* cluster, uint8_t* out, int ld,
                   int max_words, bool staged, uint32_t* scratch) {
  if (smem > 46 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ngia_lcs_kernel<BW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  ngia_lcs_kernel<BW><<<grid, kThreads, smem, stream>>>(
      words, net, low, high, W, codes, cs, reps, jobs, J, sim, oms, cluster,
      out, ld, max_words, staged, scratch);
  return cudaGetLastError();
}

}  // namespace

// words: [N, 256] uint16 histograms (rows 16-byte aligned); net: [N]
// int32; low / high: [N, W] uint32 planes; codes: [N, *] uint8 rows cs
// bytes apart (255 past net); reps: [S] and jobs: [J] int32 read indices;
// sim: f32(sim); oms: f32(1 - sim); cluster: [N] int32 for a round (S
// must be 1; out null), else null and out: [S, *] uint8 at row stride ld.
// max_words >= ceil(net / 32) of every representative; bw: the register
// window (1, 3, 5, 9, 17 or 33, at least 2 * shift + 1 of every pair), or
// 0 for the row in `scratch` ([max_words, S * J] uint32).  S and J must be
// at least 1.  Launches on `stream` without synchronising; returns
// cudaGetLastError().
extern "C" int ngia_lcs_launch(const void* words, const void* net,
                               const void* low, const void* high, int W,
                               const void* codes, long long cs,
                               const void* reps, int S, const void* jobs,
                               int J, float sim, float oms, void* cluster,
                               void* out, int ld, int max_words, int bw,
                               void* scratch, void* stream) {
  if (S < 1 || J < 1 || W < 1 || max_words < 0 || ld < J || S > 65535 ||
      (cluster == nullptr) == (out == nullptr) ||
      (cluster != nullptr && S != 1) || (bw == 0 && scratch == nullptr) ||
      reinterpret_cast<uintptr_t>(words) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool staged = 8LL * max_words <= kPlaneBytes;
  const size_t smem = staged ? 8 * static_cast<size_t>(max_words) : 0;
  const dim3 grid((J + kThreads - 1) / kThreads, S);
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
#define NGIA_LCS_CASE(B)                                                     \
  case B:                                                                    \
    e = launch<B>(grid, smem, st, wd, nt, lo, hi, W, cd, cs, rp, jb, J, sim, \
                  oms, cl, ot, ld, max_words, staged, sc);                   \
    break;
    NGIA_LCS_CASE(0)
    NGIA_LCS_CASE(1)
    NGIA_LCS_CASE(3)
    NGIA_LCS_CASE(5)
    NGIA_LCS_CASE(9)
    NGIA_LCS_CASE(17)
    NGIA_LCS_CASE(33)
#undef NGIA_LCS_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}
