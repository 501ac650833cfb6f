// Semiglobal WITH_START reverse pass (GASAL2 semi_global kernel,
// semiglobal_kernel_template.h:227-384), one thread per alignment, for
// Hopper (sm_90a), templated on the HEAD/TAIL skips.
//
// Replaces the Pallas kernel genomics_tpu/ops/pallas_gs.py
// _semiglobal_start_kernel (:364), reached through
// semiglobal_start_intertask (:496): the semiglobal DP re-run on the
// plain-reversed query and the reversed target suffix that starts at
// strip gend_reg of the reversed target, returning (tstart, qstart).
//
// Specification: genomics_tpu/core/golds.py _semiglobal_start_pass.  The
// core and the walk are semiglobal_sw.cu's (GASAL2's optimized core, 8-row
// strips, the per-column carry in a [Lq, B] int32 scratch), with these
// differences, reference quirks included:
//   - the penalized boundaries count rows from the suffix start: row r of
//     the inputs is row r for H(r, -1) = -(gapo + ge*r) and the diagonal
//     of column 0, while TAIL_T records the absolute reversed row
//     r + row_off;
//   - E(-1, j) = MINUS_INF under both HEAD_Q settings;
//   - a strip runs while the max is below the forward score and while its
//     rows are below row_count.  The max only changes at column qlen-1,
//     so the reference's word-granularity exit lands at a strip's end: a
//     thread runs the strip that reaches the score to its end and stops;
//   - maxXY_x starts at the forward qend (it is never reset);
//   - TAIL_Q scans the carry the last processed strip left (the init
//     boundary if none ran), columns < qlen, for a value beating the max,
//     leftmost first; then the row becomes qlen wherever x != tlen;
//   - MINUS_INF is -32768, GASAL2's SHRT_MIN.
// Output: tstart = tlen-1 - row, qstart = qlen-1 - x.
//
// Bound: integer ALU work per cell (about 14 operations, as END) over the
// strips up to the one that reaches the score.
//
// The first design (semiglobal_sw.cu's column loop) ran at 30% of that
// bound, and most of what it lost was idle lanes: a warp runs as many
// strips as its longest pair, and at bench.py's shape its lanes did 0.585
// of the strips the warps ran.  The wrapper (cuda_align.by_row_count)
// therefore launches the pairs ordered by row_count, which bounds each
// pair's strips (0.967 there).  In the kernel, TAIL_T's capture, which
// the first design tested in every cell though only column qlen-1 can
// take it, is one pass over the column's eight rows after that column,
// in row order; and the next column's query code and carry are loaded
// before this column is computed (the init boundary where s == 0, which
// is where no strip has run), with no branch on whether a strip ran.
// nvcc already forms the DPX maxima (VIADDMNMX) from these max()
// expressions; writing them as __viaddmax_s32 / __vimax3_s32 made the
// kernel slower (PERF.md section 6, tools/kernel_variants.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN4 = 14;  // 4-bit code of N
constexpr int kMinusInf = -32768;
constexpr int kThreads = 128;

struct Args {
  const uint8_t* Q;     // [Lq, B] reversed query (code 0 past qlen)
  const uint8_t* T;     // [Lt, B] reversed target suffix
  const int* qlen;      // [B]
  const int* tlen;      // [B]
  const int* row_off;   // [B] 8 * gend_reg
  const int* row_count; // [B] rows of the suffix
  const int* fwd_score; // [B]
  const int* fwd_qend;  // [B]
  int B, Lq, Lt, match, mismatch, n_score, gapo, ge;
  int* gH;              // [Lq, B] scratch
  int* gE;              // [Lq, B] scratch
  int* tstart;          // [B]
  int* qstart;          // [B]
};

template <bool HEAD_Q, bool HEAD_T, bool TAIL_Q, bool TAIL_T>
__global__ void __launch_bounds__(kThreads) semiglobal_start_kernel(const Args a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const size_t sB = static_cast<size_t>(a.B);
  const int Lq = a.Lq, gapo = a.gapo, ge = a.ge, goe = gapo + ge;
  const int ql = a.qlen[b], tl = a.tlen[b];
  const int roff = a.row_off[b], rcnt = a.row_count[b];
  const int fsc = a.fwd_score[b];
  const int jl = ql - 1;       // TAIL_T's column
  int best = kMinusInf, row = 0;
  bool carried = false;        // has a strip written the carry?
  const int n_strips = a.Lt >> 3;
  for (int s = 0; s < n_strips && best < fsc && s * 8 < rcnt; ++s) {
    const bool keep = s * 8 + 7 < rcnt;  // the strip's last row is live
    int tc[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) tc[c] = a.T[static_cast<size_t>(s * 8 + c) * sB + b];
    int hl[8], f[8], p[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int r = s * 8 + c;
      hl[c] = HEAD_T ? 0 : -(gapo + ge * r);
      p[c] = (HEAD_T || r == 0) ? 0 : -(gapo + ge * r);
      f[c] = kMinusInf;
    }
    // column 0's query code and carry (the boundary where no strip ran:
    // carried is s > 0 inside this loop); each column loads the next
    // one's before computing its own
    int qn = a.Q[b];
    int hn = s ? a.gH[b] : 0;
    int en = s ? a.gE[b] : kMinusInf;
    for (int j = 0; j < Lq; ++j) {
      const size_t at = static_cast<size_t>(j) * sB + b;
      const int qc = qn, hup = hn;
      int e = en;
      if (j + 1 < Lq) {
        qn = a.Q[at + sB];
        hn = s ? a.gH[at + sB] : (HEAD_Q ? 0 : -(gapo + ge * (j + 1)));
        en = s ? a.gE[at + sB] : kMinusInf;
      }
      const int e0 = e;
      int phd = hup - goe;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        int sub = (qc == tc[c]) ? a.match : -a.mismatch;
        if (qc == kN4 || tc[c] == kN4) sub = a.n_score;
        const int fc = max(hl[c] - goe, f[c] - ge);
        const int tmp = p[c] + sub;
        e = max(phd, e - ge);
        const int h = max(max(tmp, fc), e);
        f[c] = fc;
        p[c] = phd + goe;
        phd = h - goe;
        hl[c] = h;
      }
      // TAIL_T's column, once: its rows in order, as the cells were visited
      if (TAIL_T && j == jl) {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int r = s * 8 + c;
          if (r < rcnt && r + roff < tl && hl[c] > best) {
            best = hl[c];
            row = r + roff;
          }
        }
      }
      a.gH[at] = keep ? hl[7] : hup;
      a.gE[at] = keep ? e : e0;
    }
    carried = true;
  }
  int x = a.fwd_qend[b];
  if (TAIL_Q) {
    for (int j = 0; j < Lq; ++j) {
      const int v = carried ? a.gH[static_cast<size_t>(j) * sB + b]
                            : ((HEAD_Q || j == 0) ? 0 : -(gapo + ge * j));
      if (j < ql && v > best) {
        best = v;
        x = j;
      }
    }
    if (x != tl) row = ql;
  }
  a.tstart[b] = (tl - 1) - row;
  a.qstart[b] = (ql - 1) - x;
}

// The template dispatch: one flag at a time, from the HEAD_Q end.
template <bool HQ, bool HT, bool TQ, bool TT>
void launch(const Args& a, cudaStream_t st) {
  const dim3 grid((a.B + kThreads - 1) / kThreads), block(kThreads);
  semiglobal_start_kernel<HQ, HT, TQ, TT><<<grid, block, 0, st>>>(a);
}

template <bool HQ, bool HT, bool TQ>
void pick_tail_t(bool tt, const Args& a, cudaStream_t st) {
  tt ? launch<HQ, HT, TQ, true>(a, st) : launch<HQ, HT, TQ, false>(a, st);
}

template <bool HQ, bool HT>
void pick_tail_q(bool tq, bool tt, const Args& a, cudaStream_t st) {
  tq ? pick_tail_t<HQ, HT, true>(tt, a, st) : pick_tail_t<HQ, HT, false>(tt, a, st);
}

template <bool HQ>
void pick_head_t(bool ht, bool tq, bool tt, const Args& a, cudaStream_t st) {
  ht ? pick_tail_q<HQ, true>(tq, tt, a, st) : pick_tail_q<HQ, false>(tq, tt, a, st);
}

}  // namespace

// flags: bit0 HEAD_Q, bit1 HEAD_T, bit2 TAIL_Q, bit3 TAIL_T.  n_score: what
// a pairing with N scores (0, or -n_penalty).  Launches on `stream`
// without synchronising; returns cudaGetLastError().
extern "C" int semiglobal_start_launch(int flags, const void* Q, const void* T,
                                       const void* qlen, const void* tlen,
                                       const void* row_off,
                                       const void* row_count,
                                       const void* fwd_score,
                                       const void* fwd_qend, int B, int Lq,
                                       int Lt, int match, int mismatch,
                                       int n_score, int gapo, int ge, void* gH,
                                       void* gE, void* tstart, void* qstart,
                                       void* stream) {
  if (flags < 0 || flags > 15) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const uint8_t*>(Q), static_cast<const uint8_t*>(T),
               static_cast<const int*>(qlen), static_cast<const int*>(tlen),
               static_cast<const int*>(row_off), static_cast<const int*>(row_count),
               static_cast<const int*>(fwd_score), static_cast<const int*>(fwd_qend),
               B, Lq, Lt, match, mismatch, n_score, gapo, ge,
               static_cast<int*>(gH), static_cast<int*>(gE),
               static_cast<int*>(tstart), static_cast<int*>(qstart)};
  const bool hq = flags & 1, ht = flags & 2, tq = flags & 4, tt = flags & 8;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  hq ? pick_head_t<true>(ht, tq, tt, a, st) : pick_head_t<false>(ht, tq, tt, a, st);
  return static_cast<int>(cudaGetLastError());
}
