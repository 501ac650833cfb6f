// The bit-parallel LCS shared by cluster_lcs.cu and ngia_lcs.cu
// (kernel_dynamic of CDP/CLUSTER/func.cu:641-660 and its nGIA variant),
// with a pair's row split over a group of G lanes of one warp.
//
// A text (the representative) is two bit-planes of 32-base words: bit b of
// word w of `low` / `high` is the low / high bit of the 2-bit code of base
// 32w + b.  A query base c updates the row, a big integer of words that
// starts all ones, as
//   row <- (row + (row & match)) | (row & ~match)
// with match the text positions whose code is c.  The carry of the add runs
// from word to word upward; the matched count is the zero bits of the row
// below the text's net length.
//
// Lane groups.  A group of G lanes (a power of two; 32 / G groups a warp,
// each a pair of its own) holds K row words a lane, slots [t K, t K + K)
// of the group in lane t, with those words' two text planes in registers
// (K = 1 up to 32 words, G = 32 past them).  A query step adds within
// each lane's K words as a short chain, then resolves the carries between
// lanes by carry-lookahead across the warp: a lane's K-word sum s = r +
// (r & m) either generates a carry out (s wrapped) or, where s is all
// ones, propagates the carry in.  The two exclude each other (a wrapped s is at
// most 2^(32 K) - 2), so with the warp's generate bits Gm and propagate
// bits Pm, bit i of ((Gm | Pm) + Gm) ^ Pm is the carry into lane i: one
// 32-bit add does the whole ripple, and the lane adds its carry in to its
// words.  Clearing both bits at each group's top lane ends every carry
// there, so one add serves all groups of the warp, and the top word's
// carry out is dropped (as the row's top word's is, and nGIA's band's
// highest).  A word that is not live (past the row or the band) passes no
// carry on, and a lane with one has no propagate bit, so no carry crosses
// it into the group's next live word.  Taken over a skewed pipeline (lane
// w at step k - w, its carry from the lane below by __shfl_up_sync): that
// wavefront costs a shuffle's latency a step on the carry's path plus G -
// 1 steps to fill, and it would move nGIA's band at a different step in
// every lane; the lookahead's two ballots are independent, so a step's
// path is about ten integer operations and one vote at K = 1.
//
// A group reads its query's codes 16 bytes a lane, 16 G steps ahead (rows
// 16-byte aligned, cs a multiple of 16), and every 16 steps hands the
// lane's 16 codes to the whole group in four shuffles; a code of 255, or a
// step past the query's net length, skips the step for the whole group.
//
// A pair whose row or band is wider than its launch's group holds (past
// 128 words: a clustering row past 4,096 bases, an nGIA band past 127
// words) runs a warp to itself with its row in the warp's slot of shared
// memory (of a device-memory scratch past rows of SHARED_WORDS): lane l
// takes ceil(width / 32) consecutive words, the same lookahead over the
// lanes' blocks, in two passes a step.
//
// A block with many pairs (thread_min or more, a launch argument that
// ops/lcs.py sets, in a launch of a wave of blocks or more: where the
// LCS's work, not one pair's chain, sets the time) runs them a thread each
// instead (thread_lcs), the rows in shared memory: lane groups spend a
// step's ballots, shuffles and selects on every pair (at a band of 59
// words over 32 lanes, some 40 warp instructions a pair-step by count),
// where a thread's serial chain spends about 6 instructions a word, a
// warp's 32 pairs at once.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>

namespace bitlcs {

constexpr uint32_t kFull = 0xFFFFFFFFu;

// The text positions of word (tl, th) whose code equals the query base:
// ql / qh are all ones where the base's low / high bit is set.
__device__ __forceinline__ uint32_t match(uint32_t tl, uint32_t th,
                                          uint32_t ql, uint32_t qh) {
  return ~((tl ^ ql) | (th ^ qh));
}

// All ones where bit `bit` of base code b is set.
__device__ __forceinline__ uint32_t plane(uint32_t b, int bit) {
  return 0u - ((b >> bit) & 1u);
}

// The bits of word w that lie below a text of `tnet` bases.
__device__ __forceinline__ uint32_t mask(int tnet, int w) {
  const int bits = tnet - 32 * w;
  return bits >= 32 ? 0xFFFFFFFFu : bits <= 0 ? 0u : (1u << bits) - 1u;
}

// The lanes that may pass a carry on: all but the top lane of each group
// of G.
template <int G>
__device__ __forceinline__ constexpr uint32_t carriers() {
  uint32_t m = 0;
  for (int l = 0; l < 32; ++l)
    if ((l & (G - 1)) != G - 1) m |= 1u << l;
  return m;
}

// The carry into each lane from the warp's generate and propagate bits
// (exclusive), each group's top lane cleared in both by `carry`.
__device__ __forceinline__ uint32_t carries(uint32_t gen, uint32_t prop,
                                            uint32_t carry) {
  gen &= carry;
  prop &= carry;
  return ((gen | prop) + gen) ^ prop;
}

// One query step of the K words this lane holds (m: their match masks;
// live: the word is in the row and the band; on: the group takes the
// step); every lane of the warp calls it.
template <int G, int K>
__device__ __forceinline__ void step(uint32_t (&r)[K], const uint32_t (&m)[K],
                                     const bool (&live)[K], bool on,
                                     uint32_t lbit) {
  if constexpr (K == 1) {
    // both outcomes ready before the votes: the carry in picks one
    const bool go = on && live[0];
    const uint32_t x = r[0] & m[0], u = r[0] & ~m[0];
    const uint32_t s = r[0] + x;
    const uint32_t gen = __ballot_sync(kFull, go && s < x) & carriers<G>();
    const uint32_t prop =
        __ballot_sync(kFull, go && s == 0xFFFFFFFFu) & carriers<G>();
    const uint32_t n0 = go ? s | u : r[0], n1 = go ? (s + 1u) | u : r[0];
    r[0] = (((gen | prop) + gen) ^ prop) & lbit ? n1 : n0;
    return;
  }
  uint32_t s[K];
  uint32_t c = 0;
  bool ones = on;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const unsigned long long t =
        static_cast<unsigned long long>(r[i]) + (r[i] & m[i]) + c;
    s[i] = static_cast<uint32_t>(t);
    c = live[i] ? static_cast<uint32_t>(t >> 32) : 0u;
    ones = ones && live[i] && s[i] == 0xFFFFFFFFu;
  }
  c = (carries(__ballot_sync(kFull, on && c != 0u), __ballot_sync(kFull, ones),
               carriers<G>()) & lbit) ? 1u : 0u;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const uint32_t t = s[i] + c;
    c = live[i] && s[i] == 0xFFFFFFFFu ? c : 0u;
    if (on && live[i]) r[i] = t | (r[i] & ~m[i]);
  }
}

// Sum of v over the lane's group of G.
template <int G>
__device__ __forceinline__ int group_sum(int v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o, G);
  return v;
}

// Codes [pos, pos + 16) of a query of qn codes whose row q is 16-byte
// aligned; 255 where pos is past qn.
__device__ __forceinline__ uint4 codes16(const uint8_t* __restrict__ q,
                                         int pos, int qn) {
  return pos < qn ? __ldg(reinterpret_cast<const uint4*>(q + pos))
                  : make_uint4(kFull, kFull, kFull, kFull);
}

// Codes [kb, kb + 16) of the group's query, every lane: lane t of the group
// holds codes [16 (kb / 16 + t'), +16) in `ahead`, reloaded every 16 G
// steps (t' counted from the reload).
template <int G>
__device__ __forceinline__ void hand_out(uint4& ahead, uint32_t (&c)[4],
                                         const uint8_t* __restrict__ q,
                                         int kb, int qn, int t) {
  if ((kb & (16 * G - 1)) == 0) ahead = codes16(q, kb + 16 * t, qn);
  const int src = (kb >> 4) & (G - 1);
  c[0] = __shfl_sync(kFull, ahead.x, src, G);
  c[1] = __shfl_sync(kFull, ahead.y, src, G);
  c[2] = __shfl_sync(kFull, ahead.z, src, G);
  c[3] = __shfl_sync(kFull, ahead.w, src, G);
}

// The matched count of one pair a group (every lane of the warp calls it;
// qn = 0 for a group without a pair): the representative's planes tl / th
// (rnet bases), the query's codes q (qn of them, 16-byte aligned).  Slot j
// of the group (lane j / K's word j % K) holds word base + j.  Without
// kBand, base = 0 (clustering: G K >= ceil(rnet / 32)).  With kBand,
// nGIA's band of half-width `shift` >= 0 words, 2 shift + 1 <= G K: base
// = iw - shift for query word iw = k / 32, so every 32 steps slot 0's word
// leaves the band for good (its zero bits are counted then), the words
// move down a slot (by a shuffle down the group between lanes) and the
// top slot takes a fresh all-ones word, whose planes the top lane loaded
// one slide ahead.  Returns the group's count in every lane.
template <int G, int K, bool kBand>
__device__ int group_lcs(const uint32_t* __restrict__ tl,
                         const uint32_t* __restrict__ th, int rnet,
                         const uint8_t* __restrict__ q, int qn, int shift) {
  constexpr int kSlots = G * K;
  const int lane = threadIdx.x & 31;
  const int t = lane & (G - 1);
  const bool top_lane = t == G - 1;
  const uint32_t lbit = 1u << lane;
  const int wr = (rnet + 31) >> 5;
  const int top = kBand ? 2 * shift : kSlots - 1;  // the highest live slot
  int base = kBand ? -shift : 0;
  uint32_t r[K], pl[K], ph[K];
  bool live[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int j = t * K + i, w = base + j;
    const bool in = w >= 0 && w < wr;
    live[i] = in && j <= top;
    pl[i] = in ? __ldg(tl + w) : 0u;
    ph[i] = in ? __ldg(th + w) : 0u;
    r[i] = 0xFFFFFFFFu;
  }
  uint32_t nl = 0, nh = 0;  // the planes of word base + kSlots (kBand)
  if (kBand && top_lane && base + kSlots >= 0 && base + kSlots < wr) {
    nl = __ldg(tl + base + kSlots);
    nh = __ldg(th + base + kSlots);
  }
  int zeros = 0;
  const int kmax = __reduce_max_sync(kFull, qn);
  uint4 ahead = make_uint4(kFull, kFull, kFull, kFull);
  for (int kb = 0; kb < kmax; kb += 16) {
    uint32_t c[4];
    hand_out<G>(ahead, c, q, kb, qn, t);
    if (kBand && kb != 0 && (kb & 31) == 0) {
      if (t == 0 && live[0]) zeros += __popc(~r[0] & mask(rnet, base));
      const uint32_t r0 = __shfl_down_sync(kFull, r[0], 1, G);
      const uint32_t l0 = __shfl_down_sync(kFull, pl[0], 1, G);
      const uint32_t h0 = __shfl_down_sync(kFull, ph[0], 1, G);
#pragma unroll
      for (int i = 0; i + 1 < K; ++i) {
        r[i] = r[i + 1];
        pl[i] = pl[i + 1];
        ph[i] = ph[i + 1];
      }
      r[K - 1] = top_lane ? 0xFFFFFFFFu : r0;
      pl[K - 1] = top_lane ? nl : l0;
      ph[K - 1] = top_lane ? nh : h0;
      ++base;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const int j = t * K + i, w = base + j;
        live[i] = j <= top && w >= 0 && w < wr;
      }
      const int w = base + kSlots;
      const bool next = top_lane && w >= 0 && w < wr;
      nl = next ? __ldg(tl + w) : 0u;
      nh = next ? __ldg(th + w) : 0u;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const uint32_t b = (c[i >> 2] >> (8 * (i & 3))) & 0xFFu;
      const uint32_t ql = plane(b, 0), qh = plane(b, 1);
      uint32_t m[K];
#pragma unroll
      for (int k = 0; k < K; ++k) m[k] = match(pl[k], ph[k], ql, qh);
      step<G, K>(r, m, live, b != 255u && kb + i < qn, lbit);
    }
  }
#pragma unroll
  for (int i = 0; i < K; ++i)
    if (live[i]) zeros += __popc(~r[i] & mask(rnet, base + t * K + i));
  return group_sum<G>(zeros);
}

// One query step over words [lo, hi] of a row in memory, lane l taking
// words [lo + l K, lo + l K + K): a first pass finds the lane's block's
// carry out and whether its sum is all ones, the lookahead gives each
// block its carry in, and a second pass writes the words.  One pair a
// warp; every lane calls it.
__device__ __forceinline__ void wide_step(uint32_t* row,
                                          const uint32_t* __restrict__ tl,
                                          const uint32_t* __restrict__ th,
                                          int lo, int hi, int K, uint32_t ql,
                                          uint32_t qh) {
  const int lane = threadIdx.x & 31;
  const int w0 = lo + lane * K, w1 = min(w0 + K, hi + 1);
  uint32_t c = 0;
  bool ones = w0 < w1;
  for (int w = w0; w < w1; ++w) {
    const uint32_t r = row[w];
    const unsigned long long s =
        static_cast<unsigned long long>(r) +
        (r & match(__ldg(tl + w), __ldg(th + w), ql, qh)) + c;
    c = static_cast<uint32_t>(s >> 32);
    ones = ones && static_cast<uint32_t>(s) == 0xFFFFFFFFu;
  }
  c = (carries(__ballot_sync(kFull, c != 0), __ballot_sync(kFull, ones),
               carriers<32>()) >> lane) & 1u;
  for (int w = w0; w < w1; ++w) {
    const uint32_t r = row[w];
    const uint32_t m = match(__ldg(tl + w), __ldg(th + w), ql, qh);
    const unsigned long long s =
        static_cast<unsigned long long>(r) + (r & m) + c;
    c = static_cast<uint32_t>(s >> 32);
    row[w] = static_cast<uint32_t>(s) | (r & ~m);
  }
}

// The matched count of one pair a warp with its row in memory (`row`, its
// ceil(rnet / 32) words); every lane of the warp calls it, qn = 0 and
// rnet = 0 for none.  Without kBand the whole row; with kBand nGIA's band
// [iw - shift, iw + shift] clipped to the row.  Words outside the band
// keep their value, so the count is taken over the row at the end.
// Returns the count in every lane.
template <bool kBand>
__device__ int wide_lcs(const uint32_t* __restrict__ tl,
                        const uint32_t* __restrict__ th, int rnet,
                        const uint8_t* __restrict__ q, int qn, int shift,
                        uint32_t* row) {
  const int lane = threadIdx.x & 31;
  const int wr = (rnet + 31) >> 5;
  for (int w = lane; w < wr; w += 32) row[w] = 0xFFFFFFFFu;
  const int K = ((kBand ? 2 * shift + 1 : wr) + 31) >> 5;
  int lo = 0, hi = wr - 1;
  uint4 ahead = make_uint4(kFull, kFull, kFull, kFull);
  for (int kb = 0; kb < qn; kb += 16) {
    uint32_t c[4];
    hand_out<32>(ahead, c, q, kb, qn, lane);
    if (kBand && (kb & 31) == 0) {
      lo = max(0, (kb >> 5) - shift);
      hi = min(wr - 1, (kb >> 5) + shift);
    }
    __syncwarp();  // the lanes' words move with the band
    for (int i = 0; i < 16 && kb + i < qn; ++i) {
      const uint32_t b = (c[i >> 2] >> (8 * (i & 3))) & 0xFFu;
      if (b != 255u) wide_step(row, tl, th, lo, hi, K, plane(b, 0),
                               plane(b, 1));
    }
  }
  __syncwarp();
  int zeros = 0;
  for (int w = lane; w < wr; w += 32) zeros += __popc(~row[w] & mask(rnet, w));
  __syncwarp();  // the row's slot is the warp's next pair's
  return group_sum<32>(zeros);
}

// The matched count of one pair a thread, for a block with many pairs (a
// throughput-bound launch: the latency of one pair's chain no longer
// sets the time): this thread's row in shared memory, word w at row[w *
// stride]; the representative's match masks of code c, word w at mt[c *
// mw + w] (shared, computed once a block); the query's codes 16 at a time;
// each step a serial carry chain over the row's words (kBand: over the
// band's [iw - shift, iw + shift] clipped to the row, no carry in at its
// lowest, none out of its highest).
template <bool kBand>
__device__ int thread_lcs(const uint32_t* mt, int mw, int rnet,
                          const uint8_t* __restrict__ q, int qn, int shift,
                          uint32_t* row, int stride) {
  const int wr = (rnet + 31) >> 5;
  for (int w = 0; w < wr; ++w) row[w * stride] = 0xFFFFFFFFu;
  int lo = 0, hi = wr - 1;
  for (int kb = 0; kb < qn; kb += 16) {
    const uint4 c4 = codes16(q, kb, qn);
    const uint32_t c[4] = {c4.x, c4.y, c4.z, c4.w};
    if (kBand && (kb & 31) == 0) {
      lo = max(0, (kb >> 5) - shift);
      hi = min(wr - 1, (kb >> 5) + shift);
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const uint32_t b = (c[i >> 2] >> (8 * (i & 3))) & 0xFFu;
      if (kb + i >= qn) break;
      if (b == 255u) continue;
      const uint32_t* m = mt + (b & 3u) * mw;
      uint32_t carry = 0;
      for (int w = lo; w <= hi; ++w) {
        const uint32_t r = row[w * stride];
        const unsigned long long t =
            static_cast<unsigned long long>(r) + (r & m[w]) + carry;
        carry = static_cast<uint32_t>(t >> 32);
        row[w * stride] = static_cast<uint32_t>(t) | (r & ~m[w]);
      }
    }
  }
  int zeros = 0;
  for (int w = 0; w < wr; ++w)
    zeros += __popc(~row[w * stride] & mask(rnet, w));
  return zeros;
}

// The representative's match masks of each code for thread_lcs: mt[c * mw
// + w] over its wr words, the block's threads together (the caller syncs).
__device__ __forceinline__ void match_table(uint32_t* mt, int mw,
                                            const uint32_t* __restrict__ tl,
                                            const uint32_t* __restrict__ th,
                                            int wr, int threads) {
  for (int i = threadIdx.x; i < 4 * wr; i += threads) {
    const int c = i / wr, w = i - c * wr;
    mt[c * mw + w] = match(__ldg(tl + w), __ldg(th + w), plane(c, 0),
                           plane(c, 1));
  }
}

// Exclusive prefix of n over the block's threads (kWarps warps), and the
// block's total in `total`: a survivor list's offsets (two lists' at once
// where n packs two counts in its halves).
template <int kWarps>
__device__ __forceinline__ int block_offset(int n, int* sums, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int v = n;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) sums[warp] = v;
  __syncthreads();
  int base = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int x = sums[w];
    if (w < warp) base += x;
    total += x;
  }
  return base + v - n;
}

// The blocks of `kernel` (threads a block, smem bytes of dynamic shared
// memory) the current card holds at once, cached per (kernel, device,
// smem).  First raises the kernel's dynamic shared-memory cap to smem
// where it is lower: the default cap is 48 KB less the kernel's static
// shared memory, so a launch past it needs the opt-in whatever part of
// the 48 KB is dynamic.  The cap only ever rises, so a cached smem stays
// within it.  Returns the first CUDA error met.
template <typename Kernel>
inline cudaError_t wave_blocks(Kernel kernel, int threads, size_t smem,
                               int& blocks) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, size_t>, int> cache;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const auto key =
      std::make_tuple(reinterpret_cast<const void*>(kernel), dev, smem);
  const std::lock_guard<std::mutex> hold(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    blocks = it->second;
    return cudaSuccess;
  }
  cudaFuncAttributes attr;
  if ((e = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess) return e;
  if (smem > static_cast<size_t>(attr.maxDynamicSharedSizeBytes) &&
      (e = cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem))) != cudaSuccess)
    return e;
  int sms = 0, per_sm = 0;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)) != cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  blocks = sms * per_sm;
  cache.emplace(key, blocks);
  return cudaSuccess;
}

// Job columns a block (a multiple of 32, 32 to max_chunk) for a launch of
// S rows of J columns: the fewest that keep the grid within the `wave`
// blocks the card holds at once (wave_blocks), so that every LCS pair
// starts in the first wave.
inline int chunk_for(int wave, int S, int J, int max_chunk) {
  const long long row_blocks =
      std::max(1LL, static_cast<long long>(wave) / S);
  const long long c = (J + row_blocks - 1) / row_blocks;
  return static_cast<int>(
      std::min<long long>(max_chunk, std::max(32LL, (c + 31) / 32 * 32)));
}

// A block's dynamic shared memory: with thread_min, the match masks [4,
// max_words] and a thread's row ([max_words, threads]); else a warp's row
// (max_words words, threads / 32 of them), none where the rows are in a
// scratch.
inline size_t smem_bytes(int max_words, int thread_min, bool scratch,
                         int threads) {
  return sizeof(uint32_t) * max_words *
         (thread_min > 0 ? 4 + threads : scratch ? 0 : threads / 32);
}

// A launch's shape for `kernel` (threads a block) over S rows of J
// columns: its shared memory, its columns a block (chunk_for) and its
// thread_min, which drops to 0 where even blocks of 32 columns fill less
// than a wave: a launch whose time one pair's chain sets, not the work,
// where a thread's serial chain loses to a lane group's (PERF.md §6,
// tools/lcs_variants.py --sweep).  Returns the first CUDA error met.
template <typename Kernel>
inline cudaError_t launch_shape(Kernel kernel, int threads, int S, int J,
                                int max_words, bool scratch, int max_chunk,
                                int& thread_min, size_t& smem, int& chunk) {
  int wave = 0;
  smem = smem_bytes(max_words, thread_min, scratch, threads);
  cudaError_t e = wave_blocks(kernel, threads, smem, wave);
  if (e != cudaSuccess) return e;
  if (thread_min > 0 && static_cast<long long>(S) * ((J + 31) / 32) < wave) {
    thread_min = 0;
    smem = smem_bytes(max_words, 0, scratch, threads);
    if ((e = wave_blocks(kernel, threads, smem, wave)) != cudaSuccess)
      return e;
  }
  chunk = chunk_for(wave, S, J, max_chunk);
  return cudaSuccess;
}

}  // namespace bitlcs
