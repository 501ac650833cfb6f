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
// carried over: it would compute masked cells.  Per row, in the
// reference's order: eh[j].h takes H(i, j-1) and eh[end] the row's last h1
// with e = 0; the max column mj is the LAST one attaining the row max
// (m <= h); gscore takes h1 with '<=' when the window reached qlen, before
// the m == 0 break; then the max, and the window shrinks over the NEW eh
// values: beg to the first active cell of [beg, end), end to two past the
// last active cell of [beg, end] (capped at qlen).  Both scans are folded
// into the walk as running first/last indices.  zdrop is hard-coded 0 in
// the reference (disabled); the clip rule is PEN_CLIP5.
//
// Where the row state lives.  Once the threads' windows part, the threads
// of a warp stand on different columns, so any layout of eh[] in device
// memory gives every access a line of its own (the first design kept it
// in [Lq+1, B] scratch and ran at 187x its bound).  Here the layout is
// the launcher's `shared` flag, set by the wrapper from Lq alone
// (ops/cuda_align.py ksw_layout):
//   shared  each block keeps its threads' (h, e) rows as int2 in dynamic
//           shared memory, [Lq+1][blockDim], and their query codes beside
//           them as bytes, [Lq+1][blockDim] (copied once from the thread's
//           own [B, Lq] row).  Column j of thread tid is the 32-bit word
//           2 (j blockDim + tid), whose bank, with blockDim a multiple of
//           16, is 2 tid mod 32 whatever j is: a warp's 8-byte access is
//           free of bank conflicts wherever its threads stand.  A cell
//           costs one 8-byte shared load, one 8-byte shared store and a
//           byte load.  Each thread touches only its own column, so no
//           __syncthreads() is needed.  The wrapper takes the most
//           threads (a multiple of 32, at most 256) whose 9 (Lq + 1)
//           bytes each fit the 232,448 bytes a block may have: at Lq 152,
//           160 threads and 220,320 bytes, one block and 5 warps per SM.
//   global  past Lq 806, where 32 threads no longer fit, the rows live in
//           a [B, Lq+1] int2 scratch, thread-major, so that each thread
//           streams its own lines through L1, and the query is read from
//           the thread's own row; 128 threads a block.
// The next cell's (h, e) and query code are loaded before this cell is
// computed, to cover the load's latency with a few warps per SM.  The
// cell's maxima use the DPX forms (__viaddmax_s32 for max(x + y, z),
// __vimax3_s32 for h).
//
// Bound: integer ALU work per window cell, about 24 operations in END and
// 19 in SCORE without the N compare, counted as one per add, max, compare
// or select; a warp runs as long as its longest window, so lanes idle
// where a related and an unrelated pair share it.  ptxas (-Xptxas -v,
// build/kernels/ksw_extend.log): 40-48 registers, no spills, so at Lq 152
// shared memory, not registers, sets the occupancy: one block of 160
// threads, 5 warps per SM.  On an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py phase 5, 65,536 extensions of 152 x 152 from h0 = 30,
// the launch alone): END 2.16 ms and SCORE 1.88 ms in the shared layout,
// 5.4x and 5.9x their bounds, and 9.64 / 8.43 ms with the global layout
// forced.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN4 = 14;  // 4-bit code of N (and of padding)
constexpr int kMaxThreads = 256;
constexpr int kGlobalThreads = 128;
constexpr int kMaxShared = 232448;  // the most a block may have on sm_90
enum Mode { SCORE = 0, END = 1 };

template <int MODE, bool WITH_N, bool SHARED>
__global__ void __launch_bounds__(kMaxThreads)
ksw_extend_kernel(const uint8_t* __restrict__ Q,    // [B, Lq]
                  const uint8_t* __restrict__ T,    // [B, Lt]
                  const int* __restrict__ qlen,     // [B]
                  const int* __restrict__ tlen,     // [B]
                  const int* __restrict__ h0v,      // [B] seed scores
                  int B, int Lq, int Lt, int match, int mismatch, int n_score,
                  int goe, int ge,
                  int2* __restrict__ ehg,           // [B, Lq + 1] (global)
                  int* __restrict__ out_score,      // [B]
                  int* __restrict__ out_qend,       // [B] (END)
                  int* __restrict__ out_tend)       // [B] (END)
{
  extern __shared__ int2 smem[];
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const uint8_t* qrow = Q + static_cast<size_t>(b) * Lq;
  const uint8_t* trow = T + static_cast<size_t>(b) * Lt;
  const int ql = min(qlen[b], Lq), tl = min(tlen[b], Lt), h0 = h0v[b];

  // this thread's column: eh[j * es], query code qc[j * es]
  int2* eh;
  const uint8_t* qc;
  int es;
  if (SHARED) {
    es = blockDim.x;
    eh = smem + threadIdx.x;
    uint8_t* qs = reinterpret_cast<uint8_t*>(smem + static_cast<size_t>(Lq + 1) * es)
                  + threadIdx.x;
    for (int j = 0; j < ql; ++j) qs[j * es] = qrow[j];
    qc = qs;
  } else {
    es = 1;
    eh = ehg + static_cast<size_t>(b) * (Lq + 1);
    qc = qrow;
  }

  // first row (ksw_kernel_template.h:79-83): eh[0].h = h0,
  // eh[1].h = max(h0 - goe, 0), then eh[j].h = eh[j-1].h - ge while
  // eh[j-1].h > ge; e = 0.  Only [0, qlen] is ever read.
  int v = h0;
  for (int j = 0; j <= ql; ++j) {
    if (j == 1) v = h0 > goe ? h0 - goe : 0;
    else if (j > 1) v = v > ge ? v - ge : 0;
    eh[j * es] = make_int2(v, 0);
  }

  int beg = 0, end = ql;
  int mx = h0, max_i = -1, max_j = -1, max_ie = -1, gscore = -1;
  for (int i = 0; i < tl; ++i) {
    const int tc = trow[i];
    const bool tn = WITH_N && tc == kN4;
    int f = 0, m = 0, mj = -1;
    int h1 = beg == 0 ? max(h0 - (goe + ge * i), 0) : 0;
    int first = end, last = -1;  // active cells of the new eh[]
    // the next cell's state, loaded one cell ahead: eh[end] always
    // exists; the query code is clamped in the global layout, whose row
    // may end the tensor
    int2 cn = eh[beg * es];
    int qn = qc[SHARED ? beg * es : min(beg, Lq - 1)];
    for (int j = beg; j < end; ++j) {
      const int2 c = cn;
      const int q = qn;
      cn = eh[(j + 1) * es];
      qn = qc[SHARED ? (j + 1) * es : min(j + 1, Lq - 1)];
      const int hleft = h1;  // H(i, j-1)
      int sub = (q == tc) ? match : -mismatch;
      if (WITH_N && (q == kN4 || tn)) sub = n_score;
      const int M = c.x ? c.x + sub : 0;
      const int h = __vimax3_s32(M, c.y, f);
      h1 = h;
      if (MODE == END) {
        if (m <= h) {
          mj = j;
          m = h;
        }
      } else {
        m = max(m, h);
      }
      const int t = __viaddmax_s32(M, -goe, 0);
      const int e = __viaddmax_s32(c.y, -ge, t);
      f = __viaddmax_s32(f, -ge, t);
      eh[j * es] = make_int2(hleft, e);
      if ((hleft | e) != 0) {
        first = min(first, j);
        last = j;
      }
    }
    eh[end * es] = make_int2(h1, 0);
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

template <int MODE, bool WITH_N, bool SHARED>
int launch(int threads, size_t shared, const uint8_t* q, const uint8_t* t,
           const int* ql, const int* tl, const int* h, int B, int Lq, int Lt,
           int match, int mismatch, int n_score, int goe, int ge, int2* eh,
           int* s, int* qe, int* te, cudaStream_t st) {
  auto kernel = ksw_extend_kernel<MODE, WITH_N, SHARED>;
  if (SHARED) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<(B + threads - 1) / threads, threads, shared, st>>>(
      q, t, ql, tl, h, B, Lq, Lt, match, mismatch, n_score, goe, ge, eh, s,
      qe, te);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mode: 0 SCORE, 1 END.  with_n = 0 is taken in SCORE mode only.  n_score:
// what a pairing with N scores (0, or -n_penalty).  Q [B, Lq] and T
// [B, Lt] row-major; lengths are clamped to Lq / Lt.  shared = 1 keeps the
// rows in shared memory (eh unused; threads a multiple of 32, at most 256,
// whose 9 (Lq + 1) bytes each fit 232,448); shared = 0 takes eh, a
// [B, Lq + 1] int2 scratch, Lq >= 1 and 128 threads a block (threads
// must say so).  Launches on `stream` without synchronising; returns
// cudaFuncSetAttribute's error, else cudaGetLastError().
extern "C" int ksw_extend_launch(int mode, int with_n, int shared, int threads,
                                 const void* Q, const void* T,
                                 const void* qlen, const void* tlen,
                                 const void* h0, int B, int Lq, int Lt,
                                 int match, int mismatch, int n_score, int goe,
                                 int ge, void* eh, void* score, void* qend,
                                 void* tend, void* stream) {
  const size_t smem = shared ? static_cast<size_t>(Lq + 1) * threads * 9 : 0;
  if (shared ? (threads < 32 || threads > kMaxThreads || threads % 32 ||
                smem > kMaxShared)
             : threads != kGlobalThreads || eh == nullptr || Lq < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto q = static_cast<const uint8_t*>(Q);
  auto t = static_cast<const uint8_t*>(T);
  auto ql = static_cast<const int*>(qlen);
  auto tl = static_cast<const int*>(tlen);
  auto h = static_cast<const int*>(h0);
  auto e = static_cast<int2*>(eh);
  auto s = static_cast<int*>(score);
  auto qe = static_cast<int*>(qend);
  auto te = static_cast<int*>(tend);
#define KSW_LAUNCH(M, N, S)                                                  \
  launch<M, N, S>(threads, smem, q, t, ql, tl, h, B, Lq, Lt, match, mismatch, \
                  n_score, goe, ge, e, s, qe, te, st)
  if (mode == SCORE && with_n)
    return shared ? KSW_LAUNCH(SCORE, true, true) : KSW_LAUNCH(SCORE, true, false);
  if (mode == SCORE)
    return shared ? KSW_LAUNCH(SCORE, false, true) : KSW_LAUNCH(SCORE, false, false);
  if (mode == END && with_n)
    return shared ? KSW_LAUNCH(END, true, true) : KSW_LAUNCH(END, true, false);
#undef KSW_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
