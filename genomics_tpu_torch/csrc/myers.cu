// Myers bit-vector semiglobal edit distance, one thread per pattern/text
// pair, for Hopper (sm_90a).
//
// Replaces the Pallas kernel _myers_kernel of genomics_tpu/ops/myers.py:161
// (through myers_batch_tpu :280); the semantics are myers_batch's
// (myers.py:41-137), the search variant of Myers 1999: the pattern aligns
// globally, the text's prefix and suffix are free.  Per text step j:
//   Ev = the pattern's match mask of text code c (0-3; 4 = N and any other
//        code below 255 match nothing)
//   Xh = (((Ev & Pv) + Pv) ^ Pv) | Ev   (a W-word add, carries word to word)
//   Xv = Ev | Mv;  Ph = Mv | ~(Xh | Pv);  Mh = Pv & Xh
//   score += bit topb of Ph - bit topb of Mh, in word lastw = (plen-1)/32
//   Ph, Mh shift left one bit across words, shift-in 0
//   Pv = Mh | ~(Xv | Ph);  Mv = Ph & Xv
// A step leaves the state as it is where c == 255 or j >= tlen (an
// interior 255 too), but j still counts.  Pv starts all ones, Mv 0, score
// and best at plen, best_end at -1; best takes a strictly smaller score,
// so the leftmost end wins; final is the score after the last active step.
//
// Layout, read in place: eq [B, 4, W] 32-bit words (a pair's 4W words
// contiguous; `es` = 2 reads the low words of int64 masks), texts [B, Lt]
// uint8 rows `ts` bytes apart at any alignment.  W = 1..8 (patterns up to
// 256 bases; 150-bp reads need W = 5) keeps the W words of Pv / Mv and the
// 4W eq words in registers, unrolled; a larger W keeps Pv / Mv in a [2W,
// B] scratch and reads eq per step.
//
// Bound: integer work, 11 operations per pattern word and text step (the
// eq select, Ev & Pv, the carrying add, Xh, Xv, Ph, Mh, two funnel shifts,
// Pv, Mv; a three-input bitwise function counts once) and 10 per step (the
// 255 and tlen tests, the score bit, the best update); chip_smoke.py
// derives them.  The texts are read once.  The first design read each
// text byte where its step needed it, so every step waited on a load: at
// 16,384 pairs (128 blocks of 128 threads on 132 SMs) no other warp hid
// the wait.  Here a block stages its pairs' next kChunk text bytes in
// shared memory with 16-byte cp.async copies of the aligned words that
// hold them, one chunk ahead of the steps, and a step reads its byte from
// shared memory; blocks of 64 pairs timed 2-4% faster than 128.  The
// step itself is one pass over the words (carries by add-with-carry,
// shifts by funnel shifts, the score bit by a mask, where the first design
// compared, shifted and tested word by word) under a branch on c != 255 &&
// j < tlen, which is the same across a warp wherever its texts have no pad
// inside; predicated selects instead cost 2W a step and made the `ed`
// stage's compute-bound launch slower (tools/kernel_variants.py --kernels
// myers, PERF.md section 6).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;    // pairs a block
constexpr int kChunk = 32;      // text bytes a pair a stage
// aligned 16-byte words that hold kChunk bytes at any alignment
constexpr int kWords = kChunk / 16 + 1;

// One word of the step, for the words kept in the scratch: updates pv /
// mv in place, carries the adder's and the two shifts' bits to the next
// word, and records the score bits where w == lastw.
__device__ __forceinline__ void word_step(uint32_t ev, uint32_t& pv,
                                          uint32_t& mv, uint32_t& cin,
                                          uint32_t& cbp, uint32_t& cbm,
                                          bool is_last, uint32_t topb,
                                          int& dscore) {
  const uint32_t a = ev & pv;
  const uint32_t s_lo = a + pv;
  const uint32_t s = s_lo + cin;
  cin = static_cast<uint32_t>(s_lo < a) | static_cast<uint32_t>(s < s_lo);
  const uint32_t xh = (s ^ pv) | ev;
  const uint32_t xv = ev | mv;
  const uint32_t ph = mv | ~(xh | pv);
  const uint32_t mh = pv & xh;
  if (is_last)
    dscore = static_cast<int>((ph >> topb) & 1u) -
             static_cast<int>((mh >> topb) & 1u);
  const uint32_t ph1 = (ph << 1) | cbp;
  const uint32_t mh1 = (mh << 1) | cbm;
  cbp = ph >> 31;
  cbm = mh >> 31;
  pv = mh1 | ~(xv | ph1);
  mv = ph1 & xv;
}

// One step over the WR words of a pattern held in registers: the W-word
// add as a chain of 32-bit adds with carry, the shifts across words as
// funnel shifts, the score bits picked by the one-bit mask tm of word
// lastw (0 in every other word); returns the score's change.
template <int WR>
__device__ __forceinline__ int step_words(const uint32_t (&ev)[WR],
                                          uint32_t (&pv)[WR],
                                          uint32_t (&mv)[WR],
                                          const uint32_t (&tm)[WR]) {
  uint32_t ph[WR], mh[WR], xv[WR], carry = 0u, accp = 0u, accm = 0u;
#pragma unroll
  for (int w = 0; w < WR; ++w) {
    const uint64_t sum = static_cast<uint64_t>(ev[w] & pv[w]) + pv[w] + carry;
    carry = static_cast<uint32_t>(sum >> 32);
    const uint32_t xh = (static_cast<uint32_t>(sum) ^ pv[w]) | ev[w];
    xv[w] = ev[w] | mv[w];
    ph[w] = mv[w] | ~(xh | pv[w]);
    mh[w] = pv[w] & xh;
    accp |= ph[w] & tm[w];
    accm |= mh[w] & tm[w];
  }
#pragma unroll
  for (int w = 0; w < WR; ++w) {
    const uint32_t ph1 = w ? __funnelshift_l(ph[w - 1], ph[w], 1) : ph[0] << 1;
    const uint32_t mh1 = w ? __funnelshift_l(mh[w - 1], mh[w], 1) : mh[0] << 1;
    pv[w] = mh1 | ~(xv[w] | ph1);
    mv[w] = ph1 & xv[w];
  }
  return static_cast<int>(accp != 0u) - static_cast<int>(accm != 0u);
}

__device__ __forceinline__ uint32_t select_eq(int c, uint32_t e0, uint32_t e1,
                                              uint32_t e2, uint32_t e3) {
  return c == 0 ? e0 : c == 1 ? e1 : c == 2 ? e2 : c == 3 ? e3 : 0u;
}

__device__ __forceinline__ void copy16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// Stage text bytes [c0, c0 + kChunk) of the block's n pairs: pair p's
// aligned 16-byte words from the one holding byte c0 on, those that hold a
// byte below `cols`, into stage[p * kWords ...].  Consecutive threads copy
// consecutive words of a pair.
__device__ __forceinline__ void stage_chunk(uint4* stage,
                                            const uint8_t* rows, size_t ts,
                                            int n, int c0, int cols) {
  const int end = min(c0 + kChunk, cols);
  for (int x = threadIdx.x; x < n * kWords; x += kThreads) {
    const int p = x / kWords, w = x % kWords;
    const uint8_t* first = rows + static_cast<size_t>(p) * ts + c0;
    const uintptr_t base = reinterpret_cast<uintptr_t>(first) & ~uintptr_t(15);
    const uintptr_t word = base + 16 * w;
    if (word < reinterpret_cast<uintptr_t>(first) + (end - c0))
      copy16(stage + p * kWords + w, reinterpret_cast<const void*>(word));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// WR > 0: WR words in registers; WR == 0: `W` words in `state`.
template <int WR>
__global__ void __launch_bounds__(kThreads)
myers_kernel(const uint32_t* __restrict__ eq,    // [B, 4, W] words, x es
             int es,
             const uint8_t* __restrict__ texts,  // [B, Lt], rows ts apart
             long long ts,
             const int* __restrict__ plen,       // [B]
             const int* __restrict__ tlen,       // [B]
             int B, int W, int Lt,
             uint32_t* __restrict__ state,       // [2W, B] (WR == 0)
             int* __restrict__ out_best, int* __restrict__ out_end,
             int* __restrict__ out_final) {
  __shared__ uint4 stage[2][kThreads * kWords];
  __shared__ int block_cols;
  const int b0 = blockIdx.x * kThreads;
  const int b = b0 + threadIdx.x;
  const bool mine = b < B;
  const int n = min(kThreads, B - b0);
  const size_t sB = static_cast<size_t>(B);
  const int m = mine ? plen[b] : 0;
  const int lastw = (m - 1) >> 5;  // floor: -1 for an empty pattern
  const uint32_t topb = static_cast<uint32_t>(m - 1) & 31u;
  const int tl = mine ? min(tlen[b], Lt) : 0;
  if (threadIdx.x == 0) block_cols = 0;
  __syncthreads();
  if (tl > 0) atomicMax(&block_cols, tl);
  constexpr int NR = WR > 0 ? WR : 1;
  uint32_t pv[NR], mv[NR], e[4][NR], tm[NR];
  const uint32_t* my_eq = eq + static_cast<size_t>(b) * 4 * W * es;
  if constexpr (WR > 0) {
#pragma unroll
    for (int w = 0; w < NR; ++w) {
      pv[w] = ~0u;
      mv[w] = 0u;
      tm[w] = w == lastw ? 1u << topb : 0u;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        e[k][w] = mine ? my_eq[(k * W + w) * es] : 0u;
    }
  } else if (mine) {
    for (int w = 0; w < W; ++w) {
      state[static_cast<size_t>(w) * sB + b] = ~0u;
      state[static_cast<size_t>(W + w) * sB + b] = 0u;
    }
  }
  __syncthreads();
  const int cols = block_cols;
  const uint8_t* rows = texts + static_cast<size_t>(b0) * ts;
  const size_t sts = static_cast<size_t>(ts);
  // my chunk's first byte sits this far into my first staged word
  const int skew = static_cast<int>(
      reinterpret_cast<uintptr_t>(rows + threadIdx.x * sts) & 15);
  int score = m, best = m, best_end = -1;
  if (cols > 0) stage_chunk(stage[0], rows, sts, n, 0, cols);
  for (int c0 = 0, buf = 0; c0 < cols; c0 += kChunk, buf ^= 1) {
    if (c0 + kChunk < cols)
      stage_chunk(stage[buf ^ 1], rows, sts, n, c0 + kChunk, cols);
    else
      asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    // (c0 + skew) & 15 == skew for every chunk: kChunk is a multiple of 16
    const uint8_t* mine_bytes =
        reinterpret_cast<const uint8_t*>(stage[buf] + threadIdx.x * kWords) +
        skew;
#pragma unroll 4
    for (int jj = 0; jj < kChunk; ++jj) {
      const int j = c0 + jj;
      const int c = mine_bytes[jj];
      if (c == 255 || j >= tl) continue;   // the state stays, j counts
      int dscore = 0;
      if constexpr (WR > 0) {
        uint32_t ev[NR];
#pragma unroll
        for (int w = 0; w < NR; ++w)
          ev[w] = select_eq(c, e[0][w], e[1][w], e[2][w], e[3][w]);
        dscore = step_words<NR>(ev, pv, mv, tm);
      } else {
        uint32_t cin = 0u, cbp = 0u, cbm = 0u;
        for (int w = 0; w < W; ++w) {
          const uint32_t ev = c < 4 ? my_eq[(c * W + w) * es] : 0u;
          uint32_t& p = state[static_cast<size_t>(w) * sB + b];
          uint32_t& q = state[static_cast<size_t>(W + w) * sB + b];
          uint32_t pw = p, qw = q;
          word_step(ev, pw, qw, cin, cbp, cbm, w == lastw, topb, dscore);
          p = pw;
          q = qw;
        }
      }
      score += dscore;
      if (score < best) {
        best = score;
        best_end = j;
      }
    }
    __syncthreads();   // every thread is done with stage[buf]
  }
  if (mine) {
    out_best[b] = best;
    out_end[b] = best_end;
    out_final[b] = score;
  }
}

template <int WR>
void launch(dim3 grid, cudaStream_t st, const uint32_t* eq, int es,
            const uint8_t* texts, long long ts, const int* plen,
            const int* tlen, int B, int W, int Lt, uint32_t* state, int* best,
            int* end, int* fin) {
  myers_kernel<WR><<<grid, kThreads, 0, st>>>(eq, es, texts, ts, plen, tlen,
                                              B, W, Lt, state, best, end,
                                              fin);
}

}  // namespace

// eq: the [B, 4, W] uint32 masks (word w of symbol k's mask of pair b at
// 32-bit word (b * 4W + k * W + w) * es: es 1 for 32-bit masks, 2 for the
// low words of int64 ones); texts: [B, Lt] uint8 2-bit codes (255 = pad),
// row b at texts + b * ts bytes; plen / tlen [B] int32; state [2W, B]
// uint32 scratch, read only for W > 8 (may be null otherwise); best / end
// / final [B] int32.  Launches on `stream` without synchronising; returns
// cudaGetLastError().
extern "C" int myers_launch(const void* eq, int es, const void* texts,
                            long long ts, const void* plen, const void* tlen,
                            int B, int W, int Lt, void* state, void* best,
                            void* end, void* fin, void* stream) {
  if (W < 1 || (es != 1 && es != 2) || (W > 8 && state == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((B + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto e = static_cast<const uint32_t*>(eq);
  auto t = static_cast<const uint8_t*>(texts);
  auto pl = static_cast<const int*>(plen);
  auto tl = static_cast<const int*>(tlen);
  auto s = static_cast<uint32_t*>(state);
  auto bo = static_cast<int*>(best);
  auto en = static_cast<int*>(end);
  auto fi = static_cast<int*>(fin);
  switch (W) {
    case 1: launch<1>(grid, st, e, es, t, ts, pl, tl, B, W, Lt, s, bo, en, fi); break;
    case 2: launch<2>(grid, st, e, es, t, ts, pl, tl, B, W, Lt, s, bo, en, fi); break;
    case 3: launch<3>(grid, st, e, es, t, ts, pl, tl, B, W, Lt, s, bo, en, fi); break;
    case 4: launch<4>(grid, st, e, es, t, ts, pl, tl, B, W, Lt, s, bo, en, fi); break;
    case 5: launch<5>(grid, st, e, es, t, ts, pl, tl, B, W, Lt, s, bo, en, fi); break;
    case 6: launch<6>(grid, st, e, es, t, ts, pl, tl, B, W, Lt, s, bo, en, fi); break;
    case 7: launch<7>(grid, st, e, es, t, ts, pl, tl, B, W, Lt, s, bo, en, fi); break;
    case 8: launch<8>(grid, st, e, es, t, ts, pl, tl, B, W, Lt, s, bo, en, fi); break;
    default: launch<0>(grid, st, e, es, t, ts, pl, tl, B, W, Lt, s, bo, en, fi);
  }
  return static_cast<int>(cudaGetLastError());
}
