// Semiglobal affine-gap alignment (GASAL2 semi_global kernel), one thread
// per alignment, for Hopper (sm_90a), templated on the HEAD/TAIL skips.
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
// core.
//
// Bound: integer ALU work per cell (about 14 operations in END, 24 in TB)
// plus, in TB, the nibble-cube writes (4 bytes per 8 cells).  This first
// design is the simple one: DPX __vimax3_s32, packed 16-bit cells and
// shared-memory carries are left to later work.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN4 = 14;  // 4-bit code of N (and of padding)
constexpr int kMinusInf = -32768;
constexpr int kThreads = 128;
enum Mode { END = 0, TB = 1 };

struct Args {
  const uint8_t* Q;   // [Lq, B]
  const uint8_t* T;   // [Lt, B]
  const int* qlen;    // [B]
  const int* tlen;    // [B]
  int B, Lq, Lt, match, mismatch, n_score, gapo, ge;
  int* gH;            // [Lq, B] scratch
  int* gE;            // [Lq, B] scratch
  int* score;         // [B]
  int* qend;          // [B]
  int* tend;          // [B]
  int* tb;            // [Lt/8, Lq, B] (TB)
};

template <int MODE, bool HEAD_Q, bool HEAD_T, bool TAIL_Q, bool TAIL_T>
__global__ void __launch_bounds__(kThreads) semiglobal_sw_kernel(const Args a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const size_t sB = static_cast<size_t>(a.B);
  const int Lq = a.Lq, gapo = a.gapo, ge = a.ge, goe = gapo + ge;
  const int ql = a.qlen[b], tl = a.tlen[b];
  const int jl = ql - 1;                 // TAIL_T's column
  const int s_bottom = (tl + 7) / 8 - 1;  // strip of TAIL_Q's padded row
  int best_t = kMinusInf, row_t = tl;    // TAIL_T: score and row
  int best_q = INT_MIN, col_q = 0;       // TAIL_Q: leftmost row maximum
  const int n_strips = a.Lt >> 3;
  for (int s = 0; s < n_strips; ++s) {
    int tc[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) tc[c] = a.T[static_cast<size_t>(s * 8 + c) * sB + b];
    int hl[8], f[8], p[8];  // H(row c, j-1), f chain, diag of the next column
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int row = s * 8 + c;
      hl[c] = HEAD_T ? 0 : -(gapo + ge * row);
      p[c] = (HEAD_T || row == 0) ? 0 : -(gapo + ge * row);
      f[c] = kMinusInf;
    }
    for (int j = 0; j < Lq; ++j) {
      const size_t at = static_cast<size_t>(j) * sB + b;
      const int qc = a.Q[at];
      int hup, e;  // H and e of the row above the strip
      if (s) {
        hup = a.gH[at];
        e = a.gE[at];
      } else if (HEAD_Q) {
        hup = e = 0;
      } else {
        hup = j ? -(gapo + ge * j) : 0;
        e = kMinusInf;
      }
      int phd = hup - goe;  // prev_hm_diff: the h above, less gap_oe
      uint32_t word = 0;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        int sub = (qc == tc[c]) ? a.match : -a.mismatch;
        if (qc == kN4 || tc[c] == kN4) sub = a.n_score;
        const int fc = max(hl[c] - goe, f[c] - ge);
        const int tmp = p[c] + sub;
        e = max(phd, e - ge);
        const int h = max(max(tmp, fc), e);
        if (MODE == TB) {
          const int d = (h == tmp) ? (sub >= 0 ? 0 : 1) : (h == fc ? 3 : 2);
          const int f_ext = tmp - goe > fc - ge ? 0 : 1;
          const int e_ext = tmp - goe > e - ge ? 0 : 1;
          word |= static_cast<uint32_t>(d | (e_ext << 2) | (f_ext << 3)) << (4 * c);
        }
        if (TAIL_T && j == jl && s * 8 + c < tl && h > best_t) {
          best_t = h;
          row_t = s * 8 + c;
        }
        f[c] = fc;
        p[c] = phd + goe;
        phd = h - goe;
        hl[c] = h;
      }
      a.gH[at] = hl[7];
      a.gE[at] = e;
      if (TAIL_Q && s == s_bottom && j < ql && hl[7] > best_q) {
        best_q = hl[7];
        col_q = j;
      }
      if (MODE == TB) a.tb[(static_cast<size_t>(s) * Lq + j) * sB + b] = static_cast<int>(word);
    }
  }
  int score = TAIL_T ? best_t : kMinusInf;
  int qend = tl;
  int tend = (TAIL_T && best_t > kMinusInf) ? row_t : ql;
  if (TAIL_Q) {
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

// The template dispatch: one flag at a time, from the HEAD_Q end.
template <int MODE, bool HQ, bool HT, bool TQ, bool TT>
void launch(const Args& a, cudaStream_t st) {
  const dim3 grid((a.B + kThreads - 1) / kThreads), block(kThreads);
  semiglobal_sw_kernel<MODE, HQ, HT, TQ, TT><<<grid, block, 0, st>>>(a);
}

template <int MODE, bool HQ, bool HT, bool TQ>
void pick_tail_t(bool tt, const Args& a, cudaStream_t st) {
  tt ? launch<MODE, HQ, HT, TQ, true>(a, st) : launch<MODE, HQ, HT, TQ, false>(a, st);
}

template <int MODE, bool HQ, bool HT>
void pick_tail_q(bool tq, bool tt, const Args& a, cudaStream_t st) {
  tq ? pick_tail_t<MODE, HQ, HT, true>(tt, a, st)
     : pick_tail_t<MODE, HQ, HT, false>(tt, a, st);
}

template <int MODE, bool HQ>
void pick_head_t(bool ht, bool tq, bool tt, const Args& a, cudaStream_t st) {
  ht ? pick_tail_q<MODE, HQ, true>(tq, tt, a, st)
     : pick_tail_q<MODE, HQ, false>(tq, tt, a, st);
}

template <int MODE>
void pick_head_q(bool hq, bool ht, bool tq, bool tt, const Args& a, cudaStream_t st) {
  hq ? pick_head_t<MODE, true>(ht, tq, tt, a, st)
     : pick_head_t<MODE, false>(ht, tq, tt, a, st);
}

}  // namespace

// mode: 0 END, 1 TB.  flags: bit0 HEAD_Q, bit1 HEAD_T, bit2 TAIL_Q,
// bit3 TAIL_T.  n_score: what a pairing with N scores (0, or -n_penalty).
// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int semiglobal_sw_launch(int mode, int flags, const void* Q,
                                    const void* T, const void* qlen,
                                    const void* tlen, int B, int Lq, int Lt,
                                    int match, int mismatch, int n_score,
                                    int gapo, int ge, void* gH, void* gE,
                                    void* score, void* qend, void* tend,
                                    void* tb, void* stream) {
  if ((mode != END && mode != TB) || flags < 0 || flags > 15)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const uint8_t*>(Q), static_cast<const uint8_t*>(T),
               static_cast<const int*>(qlen), static_cast<const int*>(tlen),
               B, Lq, Lt, match, mismatch, n_score, gapo, ge,
               static_cast<int*>(gH), static_cast<int*>(gE),
               static_cast<int*>(score), static_cast<int*>(qend),
               static_cast<int*>(tend), static_cast<int*>(tb)};
  const bool hq = flags & 1, ht = flags & 2, tq = flags & 4, tt = flags & 8;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == END)
    pick_head_q<END>(hq, ht, tq, tt, a, st);
  else
    pick_head_q<TB>(hq, ht, tq, tt, a, st);
  return static_cast<int>(cudaGetLastError());
}
