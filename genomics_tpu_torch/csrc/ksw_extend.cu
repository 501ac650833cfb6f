// Seed extension, bwa-mem's ksw_extend as GASAL2's ksw kernel has it, one
// thread per extension, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of genomics_tpu/ops/pallas_ksw.py:
//   mode END    _ksw_kernel_intertask (:188, through _ksw_align_intertask
//               :332) and the lanes kernel _ksw_kernel (:45, through
//               _ksw_align_lanes :149): score, qend, tend.
//   mode SCORE  _ksw_kernel_intertask with score_only (the
//               ksw_align_scores_tpu fast path, :315): the score alone;
//               WITH_N=false drops the N compare (has_n=False contract).
// The TPU's lanes / inter-task split exists for its vector layout only;
// here one kernel serves every batch size.
//
// Specification: genomics_tpu/core/golds.py ksw_align, the transcription
// of the reference's per-thread walk (ksw_kernel_template.h:46-203).  Each
// thread really walks its own window [beg, end) of each target row and
// really stops at the row whose max m is 0; the TPU masks every slot over
// the union of the live windows (pallas_ksw.py:275-283), which is not
// carried over.  The row state eh[].h / eh[].e lives in two [Lq+1, B]
// int32 scratch arrays with b innermost, so a warp's accesses coalesce
// while its threads stand on the same column.  Per row, in the reference's
// order: eh[j].h takes H(i, j-1) and eh[end] the row's last h1 with e = 0;
// the max column mj is the LAST one attaining the row max (m <= h);
// gscore takes h1 with '<=' when the window reached qlen, before the
// m == 0 break; then the max, and the window shrinks over the NEW eh
// values: beg to the first active cell of [beg, end), end to two past the
// last active cell of [beg, end] (capped at qlen).  Both scans are folded
// into the walk as running first/last indices.  zdrop is hard-coded 0 in
// the reference (disabled); the clip rule is PEN_CLIP5.
//
// Bound: integer ALU work per window cell (about 24 operations in END, 19
// in SCORE without the N compare), counted as one per add, max, compare or
// select.  What sets the time is the eh scratch instead, 16 bytes read and
// written per cell: once the threads' windows part, the threads of a warp
// stand on different columns, so every eh load and store touches a line of
// its own (PERF.md's findings measure this).  This first design is the
// simple one: eh in shared memory or registers, DPX __viaddmax_s32 and
// strip-batched rows are left to later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN4 = 14;  // 4-bit code of N (and of padding)
constexpr int kThreads = 128;
enum Mode { SCORE = 0, END = 1 };

template <int MODE, bool WITH_N>
__global__ void __launch_bounds__(kThreads)
ksw_extend_kernel(const uint8_t* __restrict__ Q,    // [Lq, B]
                  const uint8_t* __restrict__ T,    // [Lt, B]
                  const int* __restrict__ qlen,     // [B]
                  const int* __restrict__ tlen,     // [B]
                  const int* __restrict__ h0v,      // [B] seed scores
                  int B, int Lq, int Lt, int match, int mismatch, int n_score,
                  int goe, int ge,
                  int* __restrict__ ehh,            // [Lq + 1, B] scratch
                  int* __restrict__ ehe,            // [Lq + 1, B] scratch
                  int* __restrict__ out_score,      // [B]
                  int* __restrict__ out_qend,       // [B] (END)
                  int* __restrict__ out_tend)       // [B] (END)
{
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = static_cast<size_t>(B);
  const int ql = min(qlen[b], Lq), tl = min(tlen[b], Lt), h0 = h0v[b];

  // first row (ksw_kernel_template.h:79-83): eh[0].h = h0,
  // eh[1].h = max(h0 - goe, 0), then eh[j].h = eh[j-1].h - ge while
  // eh[j-1].h > ge; e = 0.  Only [0, qlen] is ever read.
  int v = h0;
  for (int j = 0; j <= ql; ++j) {
    if (j == 1) v = h0 > goe ? h0 - goe : 0;
    else if (j > 1) v = v > ge ? v - ge : 0;
    ehh[static_cast<size_t>(j) * sB + b] = v;
    ehe[static_cast<size_t>(j) * sB + b] = 0;
  }

  int beg = 0, end = ql;
  int mx = h0, max_i = -1, max_j = -1, max_ie = -1, gscore = -1;
  for (int i = 0; i < tl; ++i) {
    const int tc = T[static_cast<size_t>(i) * sB + b];
    int f = 0, m = 0, mj = -1;
    int h1 = beg == 0 ? max(h0 - (goe + ge * i), 0) : 0;
    int first = end, last = -1;  // active cells of the new eh[]
    for (int j = beg; j < end; ++j) {
      const size_t at = static_cast<size_t>(j) * sB + b;
      int M = ehh[at];
      int e = ehe[at];
      const int hleft = h1;  // H(i, j-1)
      ehh[at] = hleft;
      const int qc = Q[at];
      int sub = (qc == tc) ? match : -mismatch;
      if (WITH_N && (qc == kN4 || tc == kN4)) sub = n_score;
      M = M ? M + sub : 0;
      const int h = max(max(M, e), f);
      h1 = h;
      if (MODE == END) {
        if (m <= h) {
          mj = j;
          m = h;
        }
      } else {
        m = max(m, h);
      }
      const int t = max(M - goe, 0);
      e = max(e - ge, t);
      ehe[at] = e;
      f = max(f - ge, t);
      if ((hleft | e) != 0) {
        first = min(first, j);
        last = j;
      }
    }
    ehh[static_cast<size_t>(end) * sB + b] = h1;
    ehe[static_cast<size_t>(end) * sB + b] = 0;
    if (h1 != 0) last = end;
    if (end == ql && gscore <= h1) {
      max_ie = i;
      gscore = h1;
    }
    if (m == 0) break;
    if (m > mx) {
      mx = m;
      max_i = i;
      max_j = mj;
    }
    beg = first;
    end = min(max(last, beg - 1) + 2, ql);
  }
  const bool clip = gscore <= 0 || gscore <= mx - 5;  // PEN_CLIP5
  out_score[b] = clip ? mx : gscore;
  if (MODE == END) {
    out_qend[b] = clip ? max_j + 1 : ql;
    out_tend[b] = clip ? max_i + 1 : max_ie + 1;
  }
}

}  // namespace

// mode: 0 SCORE, 1 END.  with_n = 0 is taken in SCORE mode only.  n_score:
// what a pairing with N scores (0, or -n_penalty).  Lengths are clamped to
// Lq / Lt.  Launches on `stream` without synchronising; returns
// cudaGetLastError().
extern "C" int ksw_extend_launch(int mode, int with_n, const void* Q,
                                 const void* T, const void* qlen,
                                 const void* tlen, const void* h0, int B,
                                 int Lq, int Lt, int match, int mismatch,
                                 int n_score, int goe, int ge, void* ehh,
                                 void* ehe, void* score, void* qend,
                                 void* tend, void* stream) {
  const dim3 grid((B + kThreads - 1) / kThreads), block(kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto q = static_cast<const uint8_t*>(Q);
  auto t = static_cast<const uint8_t*>(T);
  auto ql = static_cast<const int*>(qlen);
  auto tl = static_cast<const int*>(tlen);
  auto h = static_cast<const int*>(h0);
  auto hh = static_cast<int*>(ehh);
  auto ee = static_cast<int*>(ehe);
  auto s = static_cast<int*>(score);
  auto qe = static_cast<int*>(qend);
  auto te = static_cast<int*>(tend);
  if (mode == SCORE && with_n) {
    ksw_extend_kernel<SCORE, true><<<grid, block, 0, st>>>(
        q, t, ql, tl, h, B, Lq, Lt, match, mismatch, n_score, goe, ge, hh, ee,
        s, qe, te);
  } else if (mode == SCORE) {
    ksw_extend_kernel<SCORE, false><<<grid, block, 0, st>>>(
        q, t, ql, tl, h, B, Lq, Lt, match, mismatch, n_score, goe, ge, hh, ee,
        s, qe, te);
  } else if (mode == END && with_n) {
    ksw_extend_kernel<END, true><<<grid, block, 0, st>>>(
        q, t, ql, tl, h, B, Lq, Lt, match, mismatch, n_score, goe, ge, hh, ee,
        s, qe, te);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
