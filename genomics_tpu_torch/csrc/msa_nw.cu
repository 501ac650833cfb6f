// Center-star MSA's pairwise NW (CDP/STAR): the affine fill of every
// (center, sequence) pair, many threads a pair, and its backtrack to gap
// counts, a warp a pair, for Hopper (sm_90a).
//
// Fill: replaces the jnp nw_matrices_batch of genomics_tpu/models/msa.py:103
// (jnp, not Pallas), the reference's cuda_nw_3d (CDP/STAR/cuda-nw.cu:117-187)
// on nw.cc:25-94's recurrence, MATCH 0 / MISMATCH -1 or a score table,
// GAP_START 0, GAP_EXTEND -1 (GSE = GAP_START + GAP_EXTEND):
//   Y[i][j] = max(GSE + M[i-1][j], GAP_EXTEND + Y[i-1][j])
//   X[i][j] = max(GSE + M[i][j-1], GAP_EXTEND + X[i][j-1])
//   M[i][j] = max(M[i-1][j-1] + s(center[i-1], seq[j-1]), X[i][j], Y[i][j])
// with msa.py:114-156's MIN_SCORE (-32700) boundaries: M row 0 is 0 at
// j = 0 and MIN_SCORE elsewhere, M column 0 is MIN_SCORE for i >= 1, Y row
// 0 is MIN_SCORE and X[i][0] is MIN_SCORE (Y's column 0 is never read).
// The JAX function's x-chain as a prefix scan is this recurrence
// rewritten (GSE <= GAP_EXTEND lets M's x-term absorb), so the values are
// equal.  The matrices are laid out pair-innermost, M [m+1][n_pad+1][B],
// the layout the backtrack reads; each pair is filled only to its own
// length, and the cells past it are never written.  The wrapper pads B to
// a multiple of 8 with pairs of length 0 (models/msa.py fill_args).
//
// The fill's design.  A block takes kPairs = 8 pairs, and cuts each
// pair's m rows into strips of kRows rows, one thread a strip.  A warp
// holds 8 pairs x 4 strips (lane = 8 g + p: strip g, pair p), so at every
// (i, j) its 8 lanes of one strip store 8 neighbouring words, one whole
// aligned 32-byte sector (with B odd, groups that straddle two sectors
// made the fill 3.5x slower on an H100: PERF.md).  The strips run
// as a skewed wavefront along the columns: strip g of warp w computes
// column t + 1 - (w kLag + g) at step t, its kRows cells top to bottom.
// Y and the cell above run down the column in registers; each row's X
// and left cell stay in the thread's registers from column to column.
// The strip's last row (M, Y) and the column's sequence code go to the
// strip below: inside a warp by __shfl_up_sync one step later, and from
// a warp's strip 3 to the next warp's strip 0 through a ring of 2 kChunk
// steps in shared memory, one chunk later (the block meets at a barrier
// every kChunk steps, so kLag = kChunk + 3).  Warp 0's strip 0 reads the
// ring that the block's first 8 kChunk threads fill a chunk ahead: the
// sequence bytes (read once) and the row above, MIN_SCORE in row 0.  So
// the fill keeps no Y scratch and loads no row above per cell: global
// memory sees the M stores, the sequence bytes, the center's codes once
// a strip, and the compact table through __ldg.  A block runs up to
// kMaxStrips strips at once; a longer center runs in rounds of `strips`
// strips, each round starting from the cube's row above it, which the
// round before wrote: with GAP_START >= 0 a cell's Y never exceeds its
// M, so the row below it has Y = GSE + M whatever the Y above, and the
// round's first strip takes Y above = M above (one row of reads a round).
//
// Scores: DNA compares the bytes.  With a table, the wrapper maps the
// bytes that occur in the call (every one, padding and bytes the matrix
// does not name included: those score 0) to a compact alphabet of A codes
// and hands over the [A, A] table, which both kernels read through __ldg:
// a protein call's 21 to 25 codes, the pad's included, take at most 2.5
// KB, which stays in the SM's read-only cache, and any A up to 256 takes
// the same path.  The
// full [256, 256] table is 256 KB, more than a block's shared memory, and
// a lookup of it through the cache would pull a sector for each of a
// warp's scattered (center, sequence) byte pairs.
//
// Backtrack: replaces the jnp backtrack_batch of msa.py:160, the
// reference's cuda_backtrack_3d (cuda-nw.cu:219-249) on nw.cc:96-150: from
// (m, slen) each step takes the diagonal where s + M[i-1][j-1] == M[i][j],
// else the least k = 1, 2, ... of a vertical run (M[i-k][j] + GAP_START +
// k GAP_EXTEND == M[i][j], tested first) or a horizontal one, adding k to
// so[j] (vertical) or space[i] (horizontal).  The first hit in that order is
// the JAX kv <= kh rule; a walk that finds no run at any k stops.  It reads
// the fill's matrices in place, [m+1][n_pad+1][P] with the pair pitch P
// passed apart from the pair count B, so the fill's pad pairs are never
// walked.
//
// The backtrack's design.  A walk is a chain of dependent reads, each word
// in a sector of its own (the cube is pair-innermost), so it is bound by
// the latency of a load, not by bytes.  kLanes lanes take a pair and walk
// it in rounds of parallel loads.  A diagonal round: lane t, for t <
// kDiag and t <= min(i, j), takes the cell (i-t, j-t) that t diagonal
// steps would reach and loads its diagonal word d_t (where t < min(i, j))
// with the two bytes of its score, and its k = 1 vertical and horizontal
// words.  Lane t's diagonal holds where s_t + d_t == d_{t-1} (d_{-1} the
// current cell, d_{t-1} from lane t - 1 by shuffle); a ballot's first
// failure f gives the diagonal steps taken, and lane f's k = 1 tests,
// against d_{f-1}, give the gap step there in the same round (with
// GAP_START = 0 every gap of a fill's matrix is a chain of k = 1 steps).
// So a round takes up to kDiag diagonal steps and the gap step that ends
// them, one load's latency.  Only where k = 1 fails do gap rounds follow:
// lane t tests k = base + t + 1 (base from 1) for t < kRun, vertical and
// horizontal words at once; two ballots give the least k, vertical first
// at equal k; a longer run takes further rounds (base += kRun), and a
// search past max(i, j) ends the walk.  Lane 0 alone updates so and space.
// The groups of a warp run their rounds in lockstep, each on its own
// pair.  Rounds a pair: about its gap events + its diagonal steps / kDiag;
// the words a round loads past its first failure are loaded in vain
// (chip_smoke.py prints the words loaded beside the words a one-thread
// walk needs).
//
// Bounds: the fill writes the pairs' own cells, sum over pairs of (m+1)
// (slen+1) 4 bytes, over 3.35 TB/s (its 11 integer operations a cell over
// the INT32 peak are below that); the wavefront's ramp adds (strips / 4 -
// 1) kLag + 3 steps to the n steps of a round.  The backtrack's floor is
// the words a one-thread walk reads over 3.35 TB/s at 32 bytes each (one
// sector a word); its critical path is the most rounds of any pair, a
// load latency each.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMatch = 0, kMismatch = -1;
constexpr int kGapStart = 0, kGapExtend = -1;
constexpr int kGSE = kGapStart + kGapExtend;
constexpr int kMinScore = -32700;
constexpr int kLanes = 32;       // the backtrack: lanes a pair
constexpr int kDiag = 32;        // diagonal words a round (lanes 0 .. kDiag-1)
constexpr int kRun = 32;         // gap lengths k a round (lanes 0 .. kRun-1)
constexpr int kWalkThreads = 256;   // the backtrack's block
constexpr int kPairs = 8;        // the fill: pairs a block, a sector of int32
constexpr int kGroups = 32 / kPairs;   // strips a warp
constexpr int kRows = 8;         // rows a strip
constexpr int kChunk = 8;        // steps between the block's barriers
constexpr int kMaxStrips = 96;   // strips a round: 768 threads, 80 registers
constexpr int kLag = kChunk + kGroups - 1;   // warp w + 1 behind warp w
static_assert(kGapStart >= 0, "a round starts from the M row above it");
static_assert(32 % kLanes == 0 && kDiag <= kLanes && kRun <= kLanes &&
                  kWalkThreads % 32 == 0,
              "a pair's lanes in one warp");

// the fill's shared rings: warp w's strip 0 reads ring w, written by warp
// w - 1's strip 3 (ring 0: by the loaders); [warps][2 kChunk][kPairs] each
struct Rings {
  int* m;
  int* y;
  int* c;
  __device__ int at(int w, int step, int p) const {
    return (w * 2 * kChunk + step % (2 * kChunk)) * kPairs + p;
  }
};

template <bool kTable>
__global__ void __launch_bounds__(kPairs * kMaxStrips)
msa_fill_kernel(const uint8_t* __restrict__ center,
                const uint8_t* __restrict__ seqs,   // [n_pad][B]
                const int* __restrict__ slens, const int* __restrict__ table,
                int A, int* __restrict__ M, int m, int n_pad, int B,
                int strips, int rounds) {
  extern __shared__ int smem[];
  const int warps = strips / kGroups;
  const int ring_words = warps * 2 * kChunk * kPairs;
  const Rings ring{smem, smem + ring_words, smem + 2 * ring_words};
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int p = lane % kPairs, g = lane / kPairs;
  const int strip = w * kGroups + g;
  const int b0 = blockIdx.x * kPairs, b = b0 + p;
  const size_t sB = static_cast<size_t>(B);
  const size_t rs = static_cast<size_t>(n_pad + 1) * sB;
  const int n = b < B ? slens[b] : -1;
  int nmax = 0;
  for (int q = 0; q < kPairs && b0 + q < B; ++q)
    nmax = max(nmax, slens[b0 + q]);
  const int lag = w * kLag + g;
  const int steps = nmax + (warps - 1) * kLag + kGroups - 1;
  const int chunks = (steps + kChunk - 1) / kChunk;
  // the loaders: the first kPairs kChunk threads, one (pair, step) each,
  // fill ring 0 a chunk ahead: for step t, column t + 1
  const bool loader = tid < kPairs * kChunk;
  const int lp = tid % kPairs, lk = tid / kPairs, lb = b0 + lp;
  const int ln = loader && lb < B ? slens[lb] : -1;

  for (int r = 0; r < rounds; ++r) {
    const int top = r * strips * kRows;        // the row above the round
    const int i0 = top + strip * kRows + 1;    // the strip's first row
    const bool live = n >= 0 && i0 <= m;
    auto load = [&](int j, int& lm, int& ly, int& lc) {
      if (j > ln) return;
      lc = seqs[(j - 1) * sB + lb];
      if (r == 0) {
        lm = ly = kMinScore;
        M[j * sB + lb] = kMinScore;   // row 0
      } else {
        lm = ly = __ldcg(M + top * rs + j * sB + lb);
      }
    };
    int lm = 0, ly = 0, lc = 0;
    if (loader) {
      load(lk + 1, lm, ly, lc);
      const int o = ring.at(0, lk + kChunk, lp);
      ring.m[o] = lm;
      ring.y[o] = ly;
      ring.c[o] = lc;
    }
    int code[kRows], left[kRows], x[kRows];
#pragma unroll
    for (int h = 0; h < kRows; ++h) {
      const int i = i0 + h;
      code[h] = i <= m ? (kTable ? center[i - 1] * A : center[i - 1]) : 0;
      left[h] = kMinScore;   // M[i][0]
      x[h] = kMinScore;      // X[i][0]
      if (live && i <= m) M[i * rs + b] = kMinScore;
    }
    if (r == 0 && strip == 0 && n >= 0) M[b] = 0;
    int diag = i0 == 1 ? 0 : kMinScore;   // M[i0 - 1][0]
    int om = 0, oy = 0, oc = 0;   // the strip's last row at the last step
    __syncthreads();
    for (int c = 0; c < chunks; ++c) {
      if (loader) load((c + 1) * kChunk + lk + 1, lm, ly, lc);
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const int t = c * kChunk + k;
        int im = __shfl_up_sync(0xffffffffu, om, kPairs);
        int iy = __shfl_up_sync(0xffffffffu, oy, kPairs);
        int ic = __shfl_up_sync(0xffffffffu, oc, kPairs);
        if (g == 0) {
          const int o = ring.at(w, t + kChunk, p);
          im = ring.m[o];
          iy = ring.y[o];
          ic = ring.c[o];
        }
        const int j = t + 1 - lag;
        if (live && j >= 1 && j <= n) {
          int* cell = M + static_cast<size_t>(i0) * rs + j * sB + b;
          int up = im, y = iy, d = diag;
#pragma unroll
          for (int h = 0; h < kRows; ++h) {
            const int s = kTable ? __ldg(table + code[h] + ic)
                                 : (ic == code[h] ? kMatch : kMismatch);
            y = max(kGSE + up, kGapExtend + y);
            x[h] = max(kGSE + left[h], kGapExtend + x[h]);
            const int v = max(max(d + s, x[h]), y);
            d = left[h];
            left[h] = v;
            up = v;
            if (i0 + h <= m) cell[h * rs] = v;
          }
          diag = im;
          om = up;
          oy = y;
          oc = ic;
        }
        if (g == kGroups - 1 && w + 1 < warps) {
          const int o = ring.at(w + 1, t, p);
          ring.m[o] = om;
          ring.y[o] = oy;
          ring.c[o] = oc;
        }
      }
      if (loader) {
        const int o = ring.at(0, c * kChunk + lk, lp);
        ring.m[o] = lm;
        ring.y[o] = ly;
        ring.c[o] = lc;
      }
      __syncthreads();
    }
  }
}

template <bool kTable>
__global__ void __launch_bounds__(kWalkThreads)
msa_backtrack_kernel(const int* __restrict__ M,
                     const uint8_t* __restrict__ center,
                     const uint8_t* __restrict__ seqs,   // [n_pad][B]
                     const int* __restrict__ slens,
                     const int* __restrict__ table, int A,
                     int* __restrict__ space, int* __restrict__ so, int m,
                     int n_pad, int P, int B) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int u = lane % kLanes, g0 = lane - u;   // lane in the group, its first
  const unsigned group = (kLanes == 32 ? kAll : (1u << (kLanes & 31)) - 1)
                         << g0;
  const int b = (blockIdx.x * kWalkThreads + threadIdx.x) / kLanes;
  const size_t sP = static_cast<size_t>(P), sB = static_cast<size_t>(B);
  const size_t rs = static_cast<size_t>(n_pad + 1) * sP;
  const int* Mb = M + b;
  int* sp = space + b * static_cast<size_t>(m + 1);
  int* sob = so + b * static_cast<size_t>(n_pad + 1);
  int i = m, j = 0, cur = 0, base = 0;
  bool diag = true, live = b < B;
  if (live) {
    j = slens[b];
    cur = Mb[i * rs + j * sP];
    live = i != 0 || j != 0;
  }
  while (__any_sync(kAll, live)) {
    // the round's loads.  Diagonal: lane u at the cell (i-u, j-u) that u
    // diagonal steps reach, the diagonal word d (v0) and its score, and
    // the k = 1 vertical (v1) and horizontal (v2) words there.  Gap: the
    // vertical (v1) and horizontal (v2) words of k = base + u + 1.
    int v0 = 0, v1 = 0, v2 = 0, s = 0;
    bool p0 = false, p1 = false, p2 = false;
    const int mn = min(i, j);
    const int k = diag ? 1 : base + u + 1;
    const int iu = diag ? i - u : i, ju = diag ? j - u : j;
    const int run = kGapStart + kGapExtend * k;
    if (live && (diag ? u < kDiag && u <= mn : u < kRun)) {
      if (diag && u < mn) {
        const int ci = center[iu - 1];
        const int sj = seqs[(ju - 1) * sB + b];
        s = kTable ? __ldg(table + ci * A + sj)
                   : (ci == sj ? kMatch : kMismatch);
        v0 = Mb[(iu - 1) * rs + (ju - 1) * sP];
        p0 = true;
      }
      if (k <= iu) {
        v1 = Mb[(iu - k) * rs + ju * sP];
        p1 = true;
      }
      if (k <= ju) {
        v2 = Mb[iu * rs + (ju - k) * sP];
        p2 = true;
      }
    }
    // the cell's own score: the current one, or lane u - 1's diagonal word
    const int left = __shfl_up_sync(kAll, v0, 1, kLanes);
    const int here = diag && u > 0 ? left : cur;
    p0 = p0 && s + v0 == here;
    p1 = p1 && v1 + run == here;
    p2 = p2 && v2 + run == here;
    const unsigned b0 = (__ballot_sync(kAll, p0) & group) >> g0;
    const unsigned b1 = (__ballot_sync(kAll, p1) & group) >> g0;
    const unsigned b2 = (__ballot_sync(kAll, p2) & group) >> g0;
    // diagonal: the steps that held (f), then lane f's k = 1 gap step;
    // gap: the least k, vertical first
    const int f = ~b0 ? __ffs(~b0) - 1 : 32;
    const unsigned hit = b1 | b2;
    const int q = diag ? f : (hit ? __ffs(hit) - 1 : 0);
    const int dv = __shfl_sync(kAll, v0, g0 + max(f, 1) - 1);
    const int gv = __shfl_sync(kAll, p1 ? v1 : v2, g0 + min(q, kLanes - 1));
    if (!live) continue;
    if (diag) {
      if (f > 0) {
        i -= f;
        j -= f;
        cur = dv;
      }
      if (f < kDiag) {   // the diagonal failed at (i, j): lane f's k = 1
        if ((b1 >> f) & 1) {
          if (u == 0) sob[j] += 1;
          i -= 1;
          cur = gv;
        } else if ((b2 >> f) & 1) {
          if (u == 0) sp[i] += 1;
          j -= 1;
          cur = gv;
        } else {   // k >= 2 in gap rounds, or no run at all
          diag = false;
          base = 1;
          if (base >= max(i, j)) live = false;
        }
      }
    } else if (hit) {
      const int kk = base + q + 1;
      if ((b1 >> q) & 1) {
        if (u == 0) sob[j] += kk;
        i -= kk;
      } else {
        if (u == 0) sp[i] += kk;
        j -= kk;
      }
      cur = gv;
      diag = true;
    } else {
      base += kRun;
      if (base >= max(i, j)) live = false;   // no run at any k
    }
    live = live && (i != 0 || j != 0);
  }
}

}  // namespace

// The fill: rounds of `strips` strips (a multiple of 4, at least kChunk
// so that the loaders exist), as few rounds as kMaxStrips allows, the
// strips shared evenly between them; ceil(B / 8) blocks of 8 strips
// threads.
extern "C" int msa_nw_launch(const void* center, const void* seqs,
                             const void* slens, const void* table, int A,
                             void* M, int m, int n_pad, int B, void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int need = max(1, (m + kRows - 1) / kRows);
  const int rounds = (need + kMaxStrips - 1) / kMaxStrips;
  int strips = max((need + rounds - 1) / rounds, kChunk);
  strips = (strips + kGroups - 1) / kGroups * kGroups;
  const int smem = static_cast<int>(sizeof(int)) * 3 * (strips / kGroups) *
                   2 * kChunk * kPairs;
  const int blocks = (B + kPairs - 1) / kPairs;
  const uint8_t* c = static_cast<const uint8_t*>(center);
  const uint8_t* q = static_cast<const uint8_t*>(seqs);
  const int* sl = static_cast<const int*>(slens);
  int* Mp = static_cast<int*>(M);
  const auto kernel = table == nullptr ? msa_fill_kernel<false>
                                       : msa_fill_kernel<true>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<blocks, strips * kPairs, smem, s>>>(
      c, q, sl, static_cast<const int*>(table), A, Mp, m, n_pad, B, strips,
      rounds);
  return static_cast<int>(cudaGetLastError());
}

// The backtrack: B pairs, kLanes lanes each, in blocks of kWalkThreads;
// M's pair pitch P (>= B) apart from B, so pads are never walked.
extern "C" int msa_nw_backtrack_launch(const void* M, const void* center,
                                       const void* seqs, const void* slens,
                                       const void* table, int A, void* space,
                                       void* so, int m, int n_pad, int P,
                                       int B, void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long threads = static_cast<long>(B) * kLanes;
  const int blocks = static_cast<int>((threads + kWalkThreads - 1) /
                                      kWalkThreads);
  const int* Mp = static_cast<const int*>(M);
  const uint8_t* c = static_cast<const uint8_t*>(center);
  const uint8_t* q = static_cast<const uint8_t*>(seqs);
  const int* sl = static_cast<const int*>(slens);
  int* sp = static_cast<int*>(space);
  int* sop = static_cast<int*>(so);
  if (table == nullptr)
    msa_backtrack_kernel<false><<<blocks, kWalkThreads, 0, s>>>(
        Mp, c, q, sl, nullptr, 0, sp, sop, m, n_pad, P, B);
  else
    msa_backtrack_kernel<true><<<blocks, kWalkThreads, 0, s>>>(
        Mp, c, q, sl, static_cast<const int*>(table), A, sp, sop, m, n_pad,
        P, B);
  return static_cast<int>(cudaGetLastError());
}
