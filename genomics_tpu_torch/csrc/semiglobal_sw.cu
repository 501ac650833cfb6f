// Semiglobal affine-gap alignment (GASAL2 semi_global kernel) for Hopper
// (sm_90a): G threads per alignment that share its strips.
//
// Replaces the Pallas kernels
//   mode END  genomics_tpu/ops/pallas_gs.py _semiglobal_kernel_intertask
//             (:181): score, qend, tend, all 16 HEAD x TAIL combinations;
//   mode TB   genomics_tpu/ops/pallas_align.py _semiglobal_kernel (:1325)
//             with traceback: END plus one packed int32 of 4-bit
//             direction nibbles per (strip, query column), the sqb layout
//             [Lt/8, Lq, B] that tb_walk.cu reads.
// The TPU's lanes / inter-task split exists for its vector layout only;
// here one kernel serves every batch size.
//
// Specification: genomics_tpu/core/golds.py semiglobal_align (the
// emulation of semiglobal_kernel_template.h:40-230, forward pass).  The
// walk is local_sw.cu's: 8-row target strips, query columns left to right
// inside a strip, the 8 rows down inside a column, the per-column carry
// between strips (gH/gE) in a [Lq, B] int32 scratch with b innermost.  The
// core is GASAL2's *optimized* one (:17-28): f opens from the h to the
// LEFT, e from the h ABOVE, and the diagonal p[] carries the h above plus
// nothing else — so, unlike local_sw.cu, the diagonal of row c at column 0
// is its own strip init and not H(row c-1, -1), and p[8] is kept apart
// from the left h[8].  Boundaries, reference quirks included:
//   HEAD_Q: H(-1, j) = E(-1, j) = 0; else H(-1, j) = 0 if j == 0 else
//           -(gapo + ge*j) and E(-1, j) = MINUS_INF;
//   HEAD_T: H(i, -1) = diag(i, 0) = 0; else H(i, -1) = -(gapo + ge*i)
//           and diag(i, 0) = 0 if i == 0 else -(gapo + ge*i);
//   f = MINUS_INF at the start of every strip.
// Substitution uses the LOCAL macro: N scores 0 (or -n_penalty).
// The ends keep the reference's quirks:
//   - the inits are swapped: qend = tlen, tend = qlen (:63-64);
//   - TAIL_T: column qlen-1, rows < tlen, the first max in visit order
//     (strict '>'); tend = that row if the score ever beat MINUS_INF;
//   - TAIL_Q: the pair's own padded bottom row ceil(tlen/8)*8 - 1 (the
//     reference pads each pair to whole words), columns < qlen, the
//     leftmost value beating the score so far (TAIL_T's, or MINUS_INF);
//     that row is the last row of its strip, so its leftmost maximum is
//     kept while that strip runs and merged at the end; then
//     tend = qlen wherever qend != tlen (:205-210);
//   - without a TAIL the score stays MINUS_INF.
// TB nibbles follow the JAX TB kernel's bookkeeping (pallas_align.py:
// 1379-1389): f_ext compares against this cell's f, e_ext against this
// cell's e (the e the cell used), not the pre-update chains of the local
// core; f_ext = !(tmp - goe > f - ge) is taken as f >= tmp - gapo, and
// e_ext the same way.
//
// Bound: integer ALU work per cell (about 14 operations in END, 24 in TB)
// plus, in TB, the nibble-cube writes (4 bytes per 8 cells).
//
// What the first design lost against it (PERF.md section 6): each
// column's query code and carry were loaded at the column's top, the
// maxima were separate adds and compares, TAIL_T's test sat in every
// cell, END walked every padded column and strip, and one thread a pair
// in 128-thread blocks left SMs idle at the engine's launches (27 and 130
// blocks for 132 SMs).  Here:
//   - thread 0 of a pair loads the next column's query code and carry
//     before computing its own (the boundary values where s == 0);
//   - the cell takes Hopper's DPX maxima: __vimax3_s32 (no relu: SEMI_
//     GLOBAL has no 0 floor) for h, __viaddmax_s32 for the f and e
//     chains, with each row's H kept as H - gap_oe so that no chain
//     forms its own open;
//   - TAIL_T's capture is a column-level branch on j == qlen - 1 over
//     the column's 8 rows, a strict '>' in row order;
//   - END walks each pair only to its extents: columns < qlen and strips
//     <= s_bottom = ceil(tlen/8) - 1.  The DP flows right and down and
//     the outputs read only cells inside those extents (TAIL_T's column
//     and TAIL_Q's padded row), so no cell past them feeds one that is
//     read.  A pair without a TAIL flag walks nothing and writes the
//     reference's constants.  TB walks everything: it writes every word
//     of the cube, as the plain version does;
//   - G threads share a pair's strips (semiglobal_sw_kernel<MODE, G>,
//     G of 4 or 8 chosen by cuda_align.split_group, a rule on B and the
//     card's SM count).  Thread g takes strips g, g + G, ... in
//     rounds of G strips, one column behind thread g - 1, from which it
//     receives the row above's (H, E) and the query code of its column by
//     __shfl_up_sync; thread 0 reads the carry that thread G - 1 wrote in
//     the round before.  TAIL_T's strips are combined in visit order at
//     each round's end (strict '>', an earlier strip keeps a tie), and
//     TAIL_Q's row is the one thread's whose strip is s_bottom (none
//     where tlen is 0: that row reads 0, as in the plain version).  A round
//     runs the warp's longest column loop plus G - 1 steps.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN4 = 14;  // 4-bit code of N (and of padding)
constexpr int kMinusInf = -32768;
constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;
enum Mode { END = 0, TB = 1 };

struct Args {
  const uint8_t* Q;   // [Lq, B]
  const uint8_t* T;   // [Lt, B]
  const int* qlen;    // [B]
  const int* tlen;    // [B]
  int B, Lq, Lt, match, mismatch, n_score, gapo, ge;
  bool head_q, head_t, tail_q, tail_t;
  int* gH;            // [Lq, B] scratch
  int* gE;            // [Lq, B] scratch
  int* score;         // [B]
  int* qend;          // [B]
  int* tend;          // [B]
  int* tb;            // [Lt/8, Lq, B] (TB)
};

// The 8 cells of one query column inside a strip, rows down.  p holds
// each row's diagonal (H of the row above at the column before; the
// strip's init at column 0) and takes the h above; hg holds H(row, j-1) -
// gap_oe and takes this column's; f the f chains.  hup / e: H and E of the
// row above the strip at this column.  Returns the strip's last row's E;
// TB's nibbles go to word.
template <int MODE>
__device__ __forceinline__ int column(const Args& a, const int (&tc)[8],
                                      int (&p)[8], int (&hg)[8], int (&f)[8],
                                      int qc, int hup, int e, uint32_t& word) {
  const int goe = a.gapo + a.ge;
  int hab = hup, phd = hup - goe;  // the h above, and it less gap_oe
  word = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    int sub = (qc == tc[c]) ? a.match : -a.mismatch;
    if (qc == kN4 || tc[c] == kN4) sub = a.n_score;
    const int tmp = p[c] + sub;
    const int fc = __viaddmax_s32(f[c], -a.ge, hg[c]);
    e = __viaddmax_s32(e, -a.ge, phd);
    const int h = __vimax3_s32(tmp, fc, e);
    if (MODE == TB) {
      const int tg = tmp - a.gapo;
      const uint32_t d = (h == tmp) ? static_cast<uint32_t>(sub) >> 31
                                    : (h == fc ? 3u : 2u);
      word |= (d | (e >= tg ? 4u : 0u) | (fc >= tg ? 8u : 0u)) << (4 * c);
    }
    f[c] = fc;
    p[c] = hab;
    hab = h;
    phd = h - goe;
    hg[c] = phd;
  }
  return e;
}

template <int MODE, int G>
__global__ void __launch_bounds__(kThreads) semiglobal_sw_kernel(const Args a) {
  static_assert(G >= 2 && 32 % G == 0, "a pair's threads share a warp");
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31, g = lane % G, first = lane - g;
  const int b = tid / G;
  const bool live = b < a.B;  // no early return: every lane shuffles
  const size_t sB = static_cast<size_t>(a.B);
  const int Lq = a.Lq, goe = a.gapo + a.ge;
  const int ql = live ? a.qlen[b] : 1, tl = live ? a.tlen[b] : 1;
  const int s_bottom = (tl + 7) / 8 - 1;  // strip of TAIL_Q's padded row
  // the walk: TB everything, END the pair's extents (nothing without a TAIL)
  int ncol = MODE == TB ? Lq : (a.tail_q || a.tail_t ? min(ql, Lq) : 0);
  if (!live) ncol = 0;
  const int nstrip = ncol > 0 ? (MODE == TB ? a.Lt >> 3
                                            : min(s_bottom + 1, a.Lt >> 3))
                              : 0;
  const int wcol = __reduce_max_sync(kFull, ncol);
  int best_t = kMinusInf, row_t = tl;  // TAIL_T: score and row
  int best_q = INT_MIN, col_q = 0;     // TAIL_Q: leftmost row maximum
  for (int r = 0; __any_sync(kFull, r * G < nstrip); ++r) {
    const int s = r * G + g;
    const bool mine = s < nstrip;
    int tc[8], p[8], hg[8], f[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int row = s * 8 + c;
      const int edge = -(a.gapo + a.ge * row);
      tc[c] = mine ? a.T[static_cast<size_t>(row) * sB + b] : 0;
      hg[c] = (a.head_t ? 0 : edge) - goe;
      p[c] = (a.head_t || row == 0) ? 0 : edge;
      f[c] = kMinusInf;
    }
    int sbest = kMinusInf, srow = tl;  // TAIL_T in this strip
    // thread 0's query code and carry of the next column, loaded ahead
    // (the boundary values where no strip has run)
    int qn = 0, hn = 0, en = 0;
    auto load = [&](int j) {
      const size_t at = static_cast<size_t>(j) * sB + b;
      qn = a.Q[at];
      if (s) {
        hn = a.gH[at];
        en = a.gE[at];
      } else if (a.head_q) {
        hn = en = 0;
      } else {
        hn = j ? -(a.gapo + a.ge * j) : 0;
        en = kMinusInf;
      }
    };
    if (g == 0 && mine) load(0);
    int oh = 0, oe = 0, oq = 0;  // what this thread sent on, a column ago
    for (int k = 0; k < wcol + G - 1; ++k) {
      int rh = hn, re = en, rq = qn;
      const int uh = __shfl_up_sync(kFull, oh, 1, G);
      const int ue = __shfl_up_sync(kFull, oe, 1, G);
      const int uq = __shfl_up_sync(kFull, oq, 1, G);
      if (g) {
        rh = uh;
        re = ue;
        rq = uq;
      }
      const int j = k - g;
      if (g == 0 && mine && j + 1 < ncol) load(j + 1);
      if (mine && j >= 0 && j < ncol) {
        uint32_t word;
        oe = column<MODE>(a, tc, p, hg, f, rq, rh, re, word);
        oh = hg[7] + goe;
        oq = rq;
        const size_t at = static_cast<size_t>(j) * sB + b;
        if (g == G - 1 && s + 1 < nstrip) {
          a.gH[at] = oh;
          a.gE[at] = oe;
        }
        if (MODE == TB)
          a.tb[(static_cast<size_t>(s) * Lq + j) * sB + b] = static_cast<int>(word);
        if (a.tail_t && j == ql - 1) {
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int h = hg[c] + goe;
            if (s * 8 + c < tl && h > sbest) {
              sbest = h;
              srow = s * 8 + c;
            }
          }
        }
        if (a.tail_q && s == s_bottom && j < ql && oh > best_q) {
          best_q = oh;
          col_q = j;
        }
      }
      __syncwarp();  // thread G-1's carry writes before thread 0's reads
    }
    // TAIL_T: the round's strips in visit order
#pragma unroll
    for (int h = 0; h < G; ++h) {
      const int m = __shfl_sync(kFull, sbest, first + h);
      const int mr = __shfl_sync(kFull, srow, first + h);
      if (m > best_t) {
        best_t = m;
        row_t = mr;
      }
    }
  }
  // TAIL_Q's row ran in the thread whose strip is s_bottom.  An empty
  // target has none (s_bottom -1): its row reads 0 at every column, as
  // the plain version's row does before any is taken, so column 0 holds
  // the leftmost maximum
  const int src = first + max(s_bottom, 0) % G;
  best_q = __shfl_sync(kFull, best_q, src);
  col_q = __shfl_sync(kFull, col_q, src);
  if (s_bottom < 0 && ql > 0) {
    best_q = 0;
    col_q = 0;
  }
  if (!live || g) return;
  int score = a.tail_t ? best_t : kMinusInf;
  int qend = tl;
  int tend = (a.tail_t && best_t > kMinusInf) ? row_t : ql;
  if (a.tail_q) {
    if (best_q > score) {
      score = best_q;
      qend = col_q;
    }
    if (qend != tl) tend = ql;
  }
  a.score[b] = score;
  a.qend[b] = qend;
  a.tend[b] = tend;
}

template <int MODE>
int launch(int group, const Args& a, cudaStream_t st) {
  const long long threads = static_cast<long long>(a.B) * group;
  const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads));
  switch (group) {
    case 4: semiglobal_sw_kernel<MODE, 4><<<grid, kThreads, 0, st>>>(a); break;
    case 8: semiglobal_sw_kernel<MODE, 8><<<grid, kThreads, 0, st>>>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mode: 0 END, 1 TB.  flags: bit0 HEAD_Q, bit1 HEAD_T, bit2 TAIL_Q,
// bit3 TAIL_T.  group: threads per pair, 4 or 8.  n_score: what a
// pairing with N scores (0, or -n_penalty).  Launches on `stream` without
// synchronising; returns cudaGetLastError().
extern "C" int semiglobal_sw_launch(int mode, int flags, int group,
                                    const void* Q, const void* T,
                                    const void* qlen, const void* tlen, int B,
                                    int Lq, int Lt, int match, int mismatch,
                                    int n_score, int gapo, int ge, void* gH,
                                    void* gE, void* score, void* qend,
                                    void* tend, void* tb, void* stream) {
  if ((mode != END && mode != TB) || flags < 0 || flags > 15)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const uint8_t*>(Q), static_cast<const uint8_t*>(T),
               static_cast<const int*>(qlen), static_cast<const int*>(tlen),
               B, Lq, Lt, match, mismatch, n_score, gapo, ge,
               (flags & 1) != 0, (flags & 2) != 0, (flags & 4) != 0,
               (flags & 8) != 0,
               static_cast<int*>(gH), static_cast<int*>(gE),
               static_cast<int*>(score), static_cast<int*>(qend),
               static_cast<int*>(tend), static_cast<int*>(tb)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return mode == END ? launch<END>(group, a, st) : launch<TB>(group, a, st);
}
