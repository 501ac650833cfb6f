// Greedy clustering's window filters, for Hopper (sm_90a): the prefix
// filter (kernel_preFilter) and the word filter (kernel_filter) of S
// representatives against J jobs in one launch.
//
// Replaces _filters_dev of genomics_tpu/models/cluster.py:408 with its
// word min-sum _word_min_sum (:375), which jnp runs on the TPU as K 0/1
// indicator products on the MXU (no Pallas kernel).  For representative
// r = rp[s] and job j = jp[c]:
//   pass2[s, c] = (sum_b min(prefix[r][b], prefix[j][b]) >= bcut[j])
//               & (sum_w min(count_r(w), count_j(w)) >= wcut[j])
// over the four bases b and the words w of the job; any[c] = 1 where some
// representative passes column c.
//
// Reads (`ops/cluster_filter.pack_words`): each read's distinct words as
// packed [N, WP] uint32, word << 16 | count (a count past 255 held as
// 255, as the dense uint8 matrix of the JAX package holds it), padded
// with zeros to a multiple of 16 slots (WP); a read's real words come
// first, so a slot of count 0 ends it.
//
// Design: the dense product spends 2 S J K 4^wl int8 operations (629 G at
// bench_cluster's first window) on bins that are almost all zero; a job
// has at most L - wl + 1 distinct words (135 at 140 bp).  So a block
// keeps R representatives' count tables in shared memory, a row of 4^wl
// + 4 bytes each (the 4 bytes put lane r's byte of one word in bank (r +
// word / 4) mod 32: no conflict when R lanes look up one word), built
// from the packed words (zeroed, then scattered).  Lane r of a group of R
// lanes takes representative r, and the group walks one job's words:
// each lane loads the same 64 bytes (16 slots as four 16-byte broadcasts
// issued together; the next job's row is prefetched into L1 meanwhile, a
// line a lane) and looks each word up in its row, the byte at row + word
// (one lea.hi); the two mins and adds of a pair of words are one 16x2
// SIMD min (__vminu2) and one add on the counts and bytes paired by byte
// permutes.  A job that fails the prefix filter against all R skips its
// words.  R is 32 where S and the tables allow (32 x 4,100 bytes at wl =
// 6, 8 x 16,388 at wl = 7), so a warp is one group; smaller R runs 32 / R
// groups a warp on their own jobs.  A group takes tiles of 32 consecutive
// jobs from its representatives' counter (an atomic ticket: the blocks of
// one group finish together), keeps each lane's 32 results as the bits
// of one register, and writes them as 32 bytes of its representative's
// row of pass2 (two 16-byte stores: pass2's rows are padded to a multiple
// of 16 bytes); the group's OR of those bits sets any[] (zeroed with the
// counters by the entry point first, so only 1s are written, by any
// block of the representatives' groups).  Blocks: G = S / R groups of
// representatives, each over as many blocks as one wave of the card
// holds (at least one).
//
// Bound: integer work and shared-memory lookups.  Per representative and
// job word a min and an add (the lookup is a load); per pair the prefix
// minimum-sum (4 mins, 3 adds), two compares and an AND: chip_smoke.py's
// CF_OPS_PER_LOOKUP / CF_OPS_PER_PAIR over the words
// `ops/cluster_filter.filter_work` counts.  The bytes: the packed words
// of the representatives and jobs, prefix, cutoffs, indices, pass2 and
// any, each once.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "bitlcs.cuh"   // bitlcs::wave_blocks

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;   // jobs a tile: one bit each of a lane's mask
constexpr int kPad = 4;     // bytes after each table row
constexpr int kFold = 128;  // quads between folds of the 16-bit sums
//                             (2 x 255 a quad in each half: below 2^16)

// The four bits of n as the bytes 0 / 1 of a word (no carries: each bit
// of the product comes from one term).
__device__ __forceinline__ uint32_t spread4(uint32_t n) {
  return (n * 0x00204081u) & 0x01010101u;
}

// min(the representative's counts, the job's) of two slots a and b as
// 16-bit halves: the table bytes at row + word (one lea.hi each), paired
// with the slots' counts (their low halves).
__device__ __forceinline__ uint32_t pair_min(const uint8_t* row, uint32_t a,
                                             uint32_t b) {
  const uint32_t ta = row[a >> 16];
  const uint32_t tb = row[b >> 16];
  return __vminu2(__byte_perm(ta, tb, 0x5410),
                  __byte_perm(a, b, 0x5410));
}

__global__ void __launch_bounds__(kThreads)
cluster_filter_kernel(const uint4* __restrict__ packed, int wq,
                      const int4* __restrict__ prefix,
                      const int* __restrict__ wcut,
                      const int* __restrict__ bcut,
                      const int* __restrict__ rp, int S,
                      const int* __restrict__ jp, int J, int R, int bins,
                      int chunks, uint8_t* __restrict__ pass2, long long ldp,
                      uint8_t* __restrict__ any, int* __restrict__ tickets) {
  extern __shared__ __align__(16) uint8_t tables[];
  const int g = blockIdx.x / chunks;        // the block's representatives
  // zero the R tables, then scatter each representative's counts
  const int stride = bins + kPad;
  uint32_t* t32 = reinterpret_cast<uint32_t*>(tables);
  for (int i = threadIdx.x; i < R * stride / 4; i += kThreads) t32[i] = 0;
  __syncthreads();
  const uint32_t* flat = reinterpret_cast<const uint32_t*>(packed);
  const int wp = 4 * wq;
  for (int i = threadIdx.x; i < R * wp; i += kThreads) {
    const int r = i / wp, s = g * R + r;
    if (s >= S) continue;
    const uint32_t v = __ldg(flat + static_cast<long long>(__ldg(rp + s)) * wp
                             + i % wp);
    if (v & 0xFFFFu) tables[r * stride + (v >> 16)] =
        static_cast<uint8_t>(min(v & 0xFFFFu, 255u));
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int grp = lane / R, r = lane % R;
  const int s = g * R + r;
  const bool live = s < S;
  const int4 pr = live ? __ldg(prefix + __ldg(rp + s)) : make_int4(0, 0, 0, 0);
  const uint8_t* row = tables + r * stride;
  const unsigned gmask =
      R == 32 ? 0xFFFFFFFFu : ((1u << R) - 1u) << (grp * R);
  const int tiles = (J + kTile - 1) / kTile;
  for (;;) {
    int tile = 0;
    if (r == 0) tile = atomicAdd(tickets + g, 1);
    tile = __shfl_sync(gmask, tile, grp * R);
    if (tile >= tiles) break;
    const int j0 = tile * kTile;
    const int n = min(kTile, J - j0);
    uint32_t mask = 0;
    for (int t = 0; t < n; ++t) {
      const int j = __ldg(jp + j0 + t);
      const uint4* words = packed + static_cast<long long>(j) * wq;
      if (t + 1 < n && r * 128 < wq * 16 + 128) {   // the next row into L1
        const uint4* nx = packed + static_cast<long long>(
            __ldg(jp + j0 + t + 1)) * wq;
        asm volatile("prefetch.global.L1 [%0];" ::"l"(
            reinterpret_cast<const char*>(nx) + 128 * r));
      }
      const int4 pj = __ldg(prefix + j);
      const int pre = min(pr.x, pj.x) + min(pr.y, pj.y) + min(pr.z, pj.z) +
                      min(pr.w, pj.w);
      const bool first = pre >= __ldg(bcut + j);
      int got = 0;
      if (__any_sync(gmask, first)) {       // else no lane can pass
        uint32_t acc = 0;                   // two 16-bit sums
        for (int q = 0; q < wq; q += 4) {
          uint4 v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) v[u] = __ldg(words + q + u);
#pragma unroll
          for (int u = 0; u < 4; ++u)
            acc += pair_min(row, v[u].x, v[u].y) +
                   pair_min(row, v[u].z, v[u].w);
          if ((q + 4) % kFold == 0) {
            got += static_cast<int>((acc & 0xFFFFu) + (acc >> 16));
            acc = 0;
          }
          if ((v[3].w & 0xFFFFu) == 0) break;   // the read's words ended
        }
        got += static_cast<int>((acc & 0xFFFFu) + (acc >> 16));
      }
      const bool pass = first && got >= __ldg(wcut + j);
      mask |= static_cast<uint32_t>(pass) << t;
    }
    if (!live) {
      mask = 0;
    } else {
      uint8_t* out = pass2 + static_cast<long long>(s) * ldp + j0;
      if (n == kTile) {
        uint4 a, b;
        a.x = spread4(mask & 15u);
        a.y = spread4((mask >> 4) & 15u);
        a.z = spread4((mask >> 8) & 15u);
        a.w = spread4((mask >> 12) & 15u);
        b.x = spread4((mask >> 16) & 15u);
        b.y = spread4((mask >> 20) & 15u);
        b.z = spread4((mask >> 24) & 15u);
        b.w = spread4(mask >> 28);
        reinterpret_cast<uint4*>(out)[0] = a;
        reinterpret_cast<uint4*>(out)[1] = b;
      } else {
        for (int t = 0; t < n; ++t) out[t] = (mask >> t) & 1u;
      }
    }
    const uint32_t hit = __reduce_or_sync(gmask, mask);
    for (int t = r; t < n; t += R)
      if ((hit >> t) & 1u) any[j0 + t] = 1;
  }
}

}  // namespace

// packed: [N, 4 * wq] uint32 (word << 16 | count; wq a multiple of 4,
// 16-byte aligned rows);
// prefix: [N, 4] int32 (16-byte aligned); wcut / bcut: [N] int32; rp: [S]
// and jp: [J] int32 read indices; R: representatives a block (1, 2, 4, 8,
// 16 or 32); bins: 4^wl; pass2: [S,
// ldp] uint8 (ldp a multiple of 16, 16-byte aligned), columns below J
// written; work: any [J] uint8 (1 where a representative passes) and
// then, at the next multiple of 16 bytes, ceil(S / R) int32 tickets;
// zeroed here.  S and J at least 1.  Launches on `stream` without
// synchronising; returns the first CUDA error.
extern "C" int cluster_filter_launch(const void* packed, int wq,
                                     const void* prefix, const void* wcut,
                                     const void* bcut, const void* rp, int S,
                                     const void* jp, int J, int R, int bins,
                                     void* pass2, long long ldp, void* work,
                                     void* stream) {
  if (S < 1 || J < 1 || wq < 4 || wq % 4 || R < 1 || R > 32 ||
      (R & (R - 1)) || bins < 4 || bins % 4 || ldp < J || ldp % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(R) * (bins + kPad);
  int wave = 0;
  cudaError_t e =
      bitlcs::wave_blocks(cluster_filter_kernel, kThreads, smem, wave);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long groups = (S + R - 1) / R;
  const long long at = (J + 15) / 16 * 16;
  if ((e = cudaMemsetAsync(work, 0, at + 4 * groups, st)) != cudaSuccess)
    return static_cast<int>(e);
  const long long tiles = (J + kTile - 1) / kTile;
  const long long per_block = static_cast<long long>(kWarps) * (32 / R);
  const long long chunks = std::max(
      1LL, std::min(wave / groups, (tiles + per_block - 1) / per_block));
  if (groups * chunks > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  uint8_t* any = static_cast<uint8_t*>(work);
  cluster_filter_kernel<<<static_cast<unsigned>(groups * chunks), kThreads,
                          smem, st>>>(
      static_cast<const uint4*>(packed), wq, static_cast<const int4*>(prefix),
      static_cast<const int*>(wcut), static_cast<const int*>(bcut),
      static_cast<const int*>(rp), S, static_cast<const int*>(jp), J, R, bins,
      static_cast<int>(chunks), static_cast<uint8_t*>(pass2), ldp, any,
      reinterpret_cast<int*>(any + at));
  return static_cast<int>(cudaGetLastError());
}
