// Local WITH_START reverse pass (GASAL2 local kernel, :441-511) for Hopper
// (sm_90a): G threads per alignment that share its strips.
//
// Replaces the Pallas kernel genomics_tpu/ops/pallas_align.py
// _local_start_kernel (:1515), reached through local_start_tpu (:1600):
// the local DP re-run on the reversed, word-aligned prefixes that end at
// the forward pass's end cell, returning the recorded cell as
// (cprime, sstrip, r0): its reversed query column, its strip and its row
// inside the strip.  The caller turns them into starts (with the
// reference's skewed target start) and reports 0 where the forward score
// is 0.
//
// Specification: genomics_tpu/core/golds.py _local_start_pass.  The DP and
// the walk are local_sw.cu's END mode on the reversed inputs: 8-row target
// strips, query columns left to right inside a strip, the 8 rows down
// inside a column, the per-column carry between strips in a [Lq, B] int32
// scratch, coalesced with b innermost.  The max is tracked with a strict
// '>' in visit order, so the first cell attaining it is recorded.  The
// reference stops after the column segment (the 8 cells of one column
// inside one strip) at which the running max reaches the forward score;
// the pair's threads here really stop there.  The TPU kernel runs every
// strip and emulates that stop with a masked, keyed selection; the result
// is the same cell.  With a forward score of 0 the first segment already
// reaches it.
//
// The extents.  The inputs hold N4 past each pair's reversed prefix, whose
// 8-padded extents (qr8 columns, tr8 rows) the caller already has.  A
// padding cell scores at most its diagonal neighbour (n_score <= 0), or
// a gap off a cell visited before it, so it never raises the running
// max: it can neither be recorded nor trigger the stop, and the columns
// past qr8 feed no column below qr8.  Given the extents (qext, text), a
// pair's column loop ends at qr8 and its strip loop at tr8 / 8, which
// leaves every output equal and, at bench.py's shape, cuts the cells to
// 0.706 of the full Lq x Lt walk.  Without them the walk is the full one.
//
// Bound: integer ALU work per cell (about 15 operations, as END) over the
// cells up to the stop: qr8 columns per strip.  What the first design
// lost against it (PERF.md section 6): idle lanes (a warp runs as long as
// its slowest pair; at bench.py's shape its lanes did 0.296 of the
// columns their warps ran), the padding columns and strips, the loads at
// each column's top, and one thread's serial walk where a launch gives
// the SMs few warps.  Here the walk ends at the extents; the wrapper
// launches the pairs ordered by qr8 x tr8 (cuda_align.local_start_order:
// Q's and T's columns gathered, and slot i of them holding pair order[i],
// whose forward score and extents the kernel reads and whose outputs it
// writes in place; 0.934 of the columns there); each column's query code
// and carry are loaded one column ahead, as local_sw.cu does; and G
// threads share a pair's strips (local_start_split_kernel<G>, G = 4, or 8
// where 4 B threads would give an SM too few warps: cuda_align.split_group,
// the rule on B and the card's SM count that semiglobal_sw.cu and
// local_sw.cu's 16-bit modes share).
//
// The strip split: G consecutive lanes of a warp run one pair.  Thread g
// takes strips g, g + G, g + 2G, ... in rounds of G strips, one column
// behind thread g - 1, from which it receives the row above's (H, E) and
// the query code of its column by __shfl_up_sync; thread 0 reads the
// carry that thread G - 1 wrote in the round before.  Each thread tracks
// its own strip's best (a strict '>') and stops after the segment at which
// that reaches the forward score: every earlier strip's max is below it,
// so that is where the reference stops.  A thread whose earlier neighbour
// stopped stops too (__ballot_sync).  At the round's end the G strips'
// bests are combined in visit order, the first strip that stopped ending
// the walk.  A round runs the warp's longest column loop plus G - 1
// steps.  One thread a pair, the first design's layout, and two threads
// were slower at every launch measured (tools/kernel_variants.py builds
// them).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN4 = 14;  // 4-bit code of N (and of padding)
constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const uint8_t* Q;  // [Lq, B] reversed query
  const uint8_t* T;  // [Lt, B] reversed target
  const int* fwd;    // [B] forward score
  const int* qext;   // [B] qr8, or null: Lq columns
  const int* text;   // [B] tr8, or null: Lt rows
  const int* order;  // [B]: slot i of Q, T and the carries holds pair
                     // order[i] (its forward score, extents and
                     // outputs); null: pair i
  int B, Lq, Lt, match, mismatch, n_score, goe, ge;
  int* gH;           // [Lq, B] scratch
  int* gE;           // [Lq, B] scratch
  int* col;          // [B] cprime
  int* strip;        // [B] sstrip
  int* row;          // [B] r0
};

// The 8 cells of one query column inside a strip, rows down: diag is H of
// the row above at the column before, e the row above's E at this column;
// hp / f hold the strip's column before and take this one.  The best is
// replaced where a cell is strictly greater, its row going to brow.
// Returns the strip's last row's E.
__device__ __forceinline__ int column(const Args& a, const int (&tc)[8],
                                      int (&hp)[8], int (&f)[8], int qc,
                                      int diag, int e, int& best, int& brow) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    int sub = (qc == tc[c]) ? a.match : -a.mismatch;
    if (qc == kN4 || tc[c] == kN4) sub = a.n_score;
    const int tmp = diag + sub;
    const int u = f[c];
    const int h = max(max(tmp, u), max(e, 0));
    if (h > best) {
      best = h;
      brow = c;
    }
    const int tmpg = tmp - a.goe;
    f[c] = max(tmpg, u - a.ge);
    e = max(tmpg, e - a.ge);
    diag = hp[c];
    hp[c] = h;
  }
  return e;
}

__device__ __forceinline__ int columns_of(const Args& a, int p) {
  return a.qext ? min(a.qext[p], a.Lq) : a.Lq;
}

__device__ __forceinline__ int strips_of(const Args& a, int p) {
  return (a.text ? min(a.text[p], a.Lt) : a.Lt) >> 3;
}

__device__ __forceinline__ void put(const Args& a, int p, int col, int strip,
                                    int row) {
  a.col[p] = col;
  a.strip[p] = strip;
  a.row[p] = row;
}

template <int G>
__global__ void __launch_bounds__(kThreads) local_start_split_kernel(const Args a) {
  static_assert(G > 1 && 32 % G == 0, "a pair's threads share a warp");
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31, g = lane % G, first = lane - g;
  const int b = tid / G;
  const bool live = b < a.B;  // no early return: every lane shuffles
  const int p = live && a.order ? a.order[b] : b;
  const size_t sB = static_cast<size_t>(a.B);
  const int target = live ? a.fwd[p] : 0;
  const int ncol = live ? columns_of(a, p) : 0;
  const int nstrip = ncol ? strips_of(a, p) : 0;
  const int wcol = static_cast<int>(__reduce_max_sync(kFull, ncol));
  int best = -1, bcol = 0, bstrip = 0, brow = 0;
  bool done = nstrip == 0;
  for (int r = 0; __any_sync(kFull, !done); ++r) {
    const int s = r * G + g;
    const bool mine = !done && s < nstrip;
    int tc[8], hp[8], f[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      tc[c] = mine ? a.T[static_cast<size_t>(s * 8 + c) * sB + b] : 0;
      hp[c] = 0;
      f[c] = 0;
    }
    int lbest = -1, lcol = 0, lrow = 0;  // this strip's best
    bool found = false, stopped = !mine;
    int oh = 0, oe = 0, oq = 0;  // what this thread sent on, a column ago
    int diag0 = 0;
    // thread 0's query code and carry of the next column, loaded ahead
    int qn = 0, hn = 0, en = 0;
    if (g == 0 && mine) {
      qn = a.Q[b];
      hn = s ? a.gH[b] : 0;
      en = s ? a.gE[b] : 0;
    }
    for (int k = 0; k < wcol + G - 1; ++k) {
      int rh = __shfl_up_sync(kFull, oh, 1, G);
      int re = __shfl_up_sync(kFull, oe, 1, G);
      int rq = __shfl_up_sync(kFull, oq, 1, G);
      const int j = k - g;
      if (g == 0) {
        rh = hn;
        re = en;
        rq = qn;
        if (mine && j + 1 < ncol) {
          const size_t at = static_cast<size_t>(j + 1) * sB + b;
          qn = a.Q[at];
          hn = s ? a.gH[at] : 0;
          en = s ? a.gE[at] : 0;
        }
      }
      if (!stopped && j >= 0) {
        const int top = lbest;
        oe = column(a, tc, hp, f, rq, diag0, re, lbest, lrow);
        oh = hp[7];
        oq = rq;
        if (lbest > top) lcol = j;
        if (g == G - 1) {
          const size_t at = static_cast<size_t>(j) * sB + b;
          a.gH[at] = oh;
          a.gE[at] = oe;
        }
        found = lbest >= target;
        stopped = found || j + 1 == ncol;
      }
      diag0 = rh;  // H of the row above at column j, the next one's diag
      // a strip before this one stopped the walk: this one is past it
      const unsigned stops = __ballot_sync(kFull, found) >> first;
      if (stops & ((1u << g) - 1)) stopped = true;
      __syncwarp();  // thread G-1's carry writes before thread 0's reads
    }
    // the round's strips in visit order
    bool ended = false;
#pragma unroll
    for (int h = 0; h < G; ++h) {
      const int m = __shfl_sync(kFull, lbest, first + h);
      const int mc = __shfl_sync(kFull, lcol, first + h);
      const int mr = __shfl_sync(kFull, lrow, first + h);
      const bool mf = __shfl_sync(kFull, static_cast<int>(found), first + h);
      if (!done && !ended) {
        if (m > best) {
          best = m;
          bcol = mc;
          bstrip = r * G + h;
          brow = mr;
        }
        ended = mf;
      }
    }
    done = done || ended || (r + 1) * G >= nstrip;
  }
  if (live && g == 0) put(a, p, bcol, bstrip, brow);
}

}  // namespace

// n_score: what a pairing with N scores (0, or -n_penalty).  qext / text
// may be null (the full Lq columns / Lt rows); order may be null (slot i
// of Q and T holds pair i), else slot i holds pair order[i], whose
// forward score and extents are read and whose outputs are written at
// order[i]; group: threads per pair, 4 or 8.  Launches on `stream`
// without synchronising; returns cudaGetLastError().
extern "C" int local_start_launch(const void* Q, const void* T, const void* fwd,
                                  const void* qext, const void* text,
                                  const void* order, int B, int Lq, int Lt,
                                  int match, int mismatch, int n_score,
                                  int goe, int ge, int group, void* gH,
                                  void* gE, void* col, void* strip, void* row,
                                  void* stream) {
  const Args a{static_cast<const uint8_t*>(Q), static_cast<const uint8_t*>(T),
               static_cast<const int*>(fwd), static_cast<const int*>(qext),
               static_cast<const int*>(text), static_cast<const int*>(order),
               B, Lq, Lt, match, mismatch,
               n_score, goe, ge, static_cast<int*>(gH), static_cast<int*>(gE),
               static_cast<int*>(col), static_cast<int*>(strip),
               static_cast<int*>(row)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long threads = static_cast<long long>(B) * group;
  const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads));
  switch (group) {
    case 4: local_start_split_kernel<4><<<grid, kThreads, 0, st>>>(a); break;
    case 8: local_start_split_kernel<8><<<grid, kThreads, 0, st>>>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
