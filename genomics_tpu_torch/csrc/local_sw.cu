// Local affine-gap Smith-Waterman (GASAL2 local kernel), one thread per
// alignment, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of genomics_tpu/ops/pallas_align.py:
//   mode SCORE  _local_kernel_intertask_score (:482): running max only;
//               WITH_N=false drops the N compare (has_n=False contract).
//   mode END    _local_kernel_intertask (:221) and the lanes kernel
//               _local_kernel (:116): score + (qend, tend).
//   mode TB     _local_kernel_intertask_tb (:717) and _local_kernel with
//               traceback: END + one packed int32 of 4-bit direction
//               nibbles per (strip, query column), the sqb layout
//               [Lt/8, Lq, B] that tb_walk.cu reads.
//   mode SECOND _local_kernel_intertask_second (:321): END + GASAL2's
//               inline second best (score2, qend2, tend2), through its own
//               entry point local_sw_second_launch (it reads the lengths).
// The TPU's lanes / inter-task split exists for its vector layout only;
// here one kernel serves every batch size.
//
// Specification: genomics_tpu/core/golds.py local_align (the emulation of
// local_kernel_template.h:72-519).  Walk 8-row target strips; inside a
// strip go query column by column, and inside a column down the 8 rows.
// H of the previous column and the query-direction gap chain f live in
// registers; the per-column carry between strips (gH/gE, GASAL2's
// global[] array) is a [Lq, B] int32 scratch, coalesced with b innermost.
// Inputs are time-major [L, B] uint8.  Tie-break: strict '>' in visit
// order, so the earliest cell with the best score wins; ends stay 0 when
// the best score is 0.  f seeds 0 at every strip: h = max(tmp, f, e, 0)
// is the same under any seed <= 0, and seed 0 gives the nibbles of the
// JAX TB kernel and the golds.
//
// SECOND keeps the reference's state per cell, in visit order (:147-163):
// a cell inside the pair's own 8-padded extent (column < qr8, row < tr8)
// is the new second best iff score2 < h < the primary max, the primary
// max already updated by this cell; after each query column inside the
// extent, qend2 = column iff prev_score2 < the PRIMARY max (a reference
// quirk, kept), then prev_score2 = max(prev_score2, score2).  Cells
// beyond the extent take part in the DP but never in the second best.
//
// Bound: integer ALU work per cell (about 12 operations in SCORE, 15 in
// END, 25 in TB, 20 in SECOND) plus, in TB, the nibble-cube writes (4
// bytes per 8 cells, the only device-memory traffic that grows with the
// cell count besides the gH/gE carry).  This first design is the simple
// one: DPX __vimax3_s32, packed 16-bit cells and shared-memory carries are
// left to later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN4 = 14;  // 4-bit code of N (and of padding)
constexpr int kThreads = 128;
enum Mode { SCORE = 0, END = 1, TB = 2, SECOND = 3 };

template <int MODE, bool WITH_N>
__global__ void __launch_bounds__(kThreads)
local_sw_kernel(const uint8_t* __restrict__ Q,  // [Lq, B]
                const uint8_t* __restrict__ T,  // [Lt, B]
                int B, int Lq, int Lt, int match, int mismatch, int n_score,
                int goe, int ge,
                int* __restrict__ gH,           // [Lq, B] scratch
                int* __restrict__ gE,           // [Lq, B] scratch
                int* __restrict__ out_score,    // [B]
                int* __restrict__ out_qend,     // [B] (END, TB)
                int* __restrict__ out_tend,     // [B] (END, TB)
                int* __restrict__ tb,           // [Lt/8, Lq, B] (TB)
                const int* __restrict__ qlen,   // [B] (SECOND)
                const int* __restrict__ tlen,   // [B] (SECOND)
                int* __restrict__ out_score2,   // [B] (SECOND)
                int* __restrict__ out_qend2,    // [B] (SECOND)
                int* __restrict__ out_tend2)    // [B] (SECOND)
{
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = static_cast<size_t>(B);
  int best = 0, qend = 0, tend = 0;
  // SECOND: the pair's 8-padded extent and the second-best state
  int qr8 = 0, tr8 = 0, best2 = 0, prev2 = 0, qend2 = 0, tend2 = 0;
  if (MODE == SECOND) {
    qr8 = (qlen[b] + 7) / 8 * 8;
    tr8 = (tlen[b] + 7) / 8 * 8;
  }
  const int n_strips = Lt >> 3;
  for (int s = 0; s < n_strips; ++s) {
    int tc[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) tc[c] = T[static_cast<size_t>(s * 8 + c) * sB + b];
    int hp[8], f[8];  // H(row c, j-1) and the f chain of row c
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      hp[c] = 0;
      f[c] = 0;
    }
    int diag0 = 0;  // H(strip row -1, j-1): the previous column's carry
    for (int j = 0; j < Lq; ++j) {
      const size_t at = static_cast<size_t>(j) * sB + b;
      const int qc = Q[at];
      const int hcol = s ? gH[at] : 0;
      int e = s ? gE[at] : 0;
      int diag = diag0;
      uint32_t word = 0;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        int sub = (qc == tc[c]) ? match : -mismatch;
        if (WITH_N && (qc == kN4 || tc[c] == kN4)) sub = n_score;
        const int tmp = diag + sub;
        const int u = f[c];
        const int h = max(max(tmp, u), max(e, 0));
        if (MODE == SCORE) {
          best = max(best, h);
        } else if (h > best) {
          best = h;
          qend = j;
          tend = s * 8 + c;
        }
        if (MODE == SECOND && j < qr8 && s * 8 + c < tr8 && best2 < h && h < best) {
          best2 = h;
          tend2 = s * 8 + c;
        }
        const int tmpg = tmp - goe;
        if (MODE == TB) {
          // direction from the pre-update chains (pallas_align.py:776-787)
          const int d = (h == tmp) ? (sub >= 0 ? 0 : 1) : (h == u ? 3 : 2);
          const int f_ext = tmpg > u - ge ? 0 : 1;
          const int e_ext = tmpg > e - ge ? 0 : 1;
          word |= static_cast<uint32_t>(d | (e_ext << 2) | (f_ext << 3)) << (4 * c);
        }
        f[c] = max(tmpg, u - ge);
        e = max(tmpg, e - ge);
        diag = hp[c];
        hp[c] = h;
      }
      diag0 = hcol;
      gH[at] = hp[7];
      gE[at] = e;
      if (MODE == SECOND) {
        if (prev2 < best && j < qr8 && s * 8 < tr8) qend2 = j;
        prev2 = max(prev2, best2);
      }
      if (MODE == TB) tb[(static_cast<size_t>(s) * Lq + j) * sB + b] = static_cast<int>(word);
    }
  }
  out_score[b] = best;
  if (MODE != SCORE) {
    out_qend[b] = qend;
    out_tend[b] = tend;
  }
  if (MODE == SECOND) {
    out_score2[b] = best2;
    out_qend2[b] = qend2;
    out_tend2[b] = tend2;
  }
}

}  // namespace

// mode: 0 SCORE, 1 END, 2 TB.  with_n = 0 is taken in SCORE mode only.
// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int local_sw_launch(int mode, int with_n, const void* Q, const void* T,
                               int B, int Lq, int Lt, int match, int mismatch,
                               int n_score, int goe, int ge, void* gH, void* gE,
                               void* score, void* qend, void* tend, void* tb,
                               void* stream) {
  const dim3 grid((B + kThreads - 1) / kThreads), block(kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto q = static_cast<const uint8_t*>(Q);
  auto t = static_cast<const uint8_t*>(T);
  auto h = static_cast<int*>(gH);
  auto e = static_cast<int*>(gE);
  auto s = static_cast<int*>(score);
  auto qe = static_cast<int*>(qend);
  auto te = static_cast<int*>(tend);
  auto w = static_cast<int*>(tb);
  if (mode == SCORE && with_n) {
    local_sw_kernel<SCORE, true><<<grid, block, 0, st>>>(
        q, t, B, Lq, Lt, match, mismatch, n_score, goe, ge, h, e, s, qe, te, w,
        nullptr, nullptr, nullptr, nullptr, nullptr);
  } else if (mode == SCORE) {
    local_sw_kernel<SCORE, false><<<grid, block, 0, st>>>(
        q, t, B, Lq, Lt, match, mismatch, n_score, goe, ge, h, e, s, qe, te, w,
        nullptr, nullptr, nullptr, nullptr, nullptr);
  } else if (mode == END && with_n) {
    local_sw_kernel<END, true><<<grid, block, 0, st>>>(
        q, t, B, Lq, Lt, match, mismatch, n_score, goe, ge, h, e, s, qe, te, w,
        nullptr, nullptr, nullptr, nullptr, nullptr);
  } else if (mode == TB && with_n) {
    local_sw_kernel<TB, true><<<grid, block, 0, st>>>(
        q, t, B, Lq, Lt, match, mismatch, n_score, goe, ge, h, e, s, qe, te, w,
        nullptr, nullptr, nullptr, nullptr, nullptr);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// SECOND (with N): END plus the second best, for pairs of lengths
// qlen/tlen [B] int32.  Launches on `stream` without synchronising;
// returns cudaGetLastError().
extern "C" int local_sw_second_launch(const void* Q, const void* T,
                                      const void* qlen, const void* tlen,
                                      int B, int Lq, int Lt, int match,
                                      int mismatch, int n_score, int goe, int ge,
                                      void* gH, void* gE, void* score,
                                      void* qend, void* tend, void* score2,
                                      void* qend2, void* tend2, void* stream) {
  const dim3 grid((B + kThreads - 1) / kThreads), block(kThreads);
  local_sw_kernel<SECOND, true><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(Q), static_cast<const uint8_t*>(T), B, Lq, Lt,
      match, mismatch, n_score, goe, ge, static_cast<int*>(gH),
      static_cast<int*>(gE), static_cast<int*>(score), static_cast<int*>(qend),
      static_cast<int*>(tend), nullptr, static_cast<const int*>(qlen),
      static_cast<const int*>(tlen), static_cast<int*>(score2),
      static_cast<int*>(qend2), static_cast<int*>(tend2));
  return static_cast<int>(cudaGetLastError());
}
