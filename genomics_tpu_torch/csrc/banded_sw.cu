// Banded local alignment (GASAL2's gasal_banded_tiled_kernel), one thread
// per alignment, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of genomics_tpu/ops/pallas_ksw.py:
//   mode END    _banded_kernel_intertask (:453, through
//               _banded_align_intertask :574) and the lanes kernel
//               _banded_kernel (:392, through _banded_align_lanes :635):
//               score, qend, tend.
//   mode SCORE  _banded_kernel_intertask with score_only (the
//               banded_align_scores_tpu fast path, :559): the score alone;
//               WITH_N=false drops the N compare (has_n=False contract: the
//               wrapper first remaps the N4 padding to the 16/17 sentinels,
//               which the TPU path does not do).
// The TPU's lanes / inter-task split exists for its vector layout only;
// here one kernel serves every batch size.
//
// Specification: genomics_tpu/core/golds.py banded_align, the emulation of
// banded.h:10-140.  With qr = ceil(qlen/8), tr = ceil(tlen/8) and
// k_other = tr - (qr - k_band), each thread walks its own strips of 8
// target rows, ib < tr, and in strip ib the query tiles
// [max(0, ib - k_other + 1), min(k_band + ib, qr)), query columns in order
// and the strip's 8 rows down inside a column.  The strip's h[8]/f[8]/p[8]
// (banded.h:72-131) are registers reset to 0 at every strip.  The core is
// h-based: f opens from the h to the left, e from the h above.  The
// per-column carry between strips (GASAL2's global[] array) is a [Lq, B]
// int32 scratch pair that starts at zero and is written only in band, so
// a column that leaves the band keeps its stale value for later strips
// (a reference quirk, kept).  Rows and columns of the band past a length
// read the N4 padding.  The max is tracked with a strict '>' in visit
// order, so the earliest cell attaining it gives the ends; they stay 0
// when the score is 0.
//
// Bound: integer ALU work per band cell (about 19 operations in END, 13
// in SCORE without the N compare), counted as one per add, max, compare or
// select; the carry scratch moves 16 bytes per band column and strip.
// This first design is the simple one: DPX __vimax3_s32, packed 16-bit
// cells and shared-memory carries are left to later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN4 = 14;  // 4-bit code of N (and of padding)
constexpr int kThreads = 128;
enum Mode { SCORE = 0, END = 1 };

template <int MODE, bool WITH_N>
__global__ void __launch_bounds__(kThreads)
banded_sw_kernel(const uint8_t* __restrict__ Q,  // [Lq, B], Lq % 8 == 0
                 const uint8_t* __restrict__ T,  // [Lt, B], Lt % 8 == 0
                 const int* __restrict__ qlen,   // [B]
                 const int* __restrict__ tlen,   // [B]
                 int B, int Lq, int Lt, int k_band, int match, int mismatch,
                 int n_score, int goe, int ge,
                 int* __restrict__ gH,           // [Lq, B] scratch
                 int* __restrict__ gE,           // [Lq, B] scratch
                 int* __restrict__ out_score,    // [B]
                 int* __restrict__ out_qend,     // [B] (END)
                 int* __restrict__ out_tend)     // [B] (END)
{
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = static_cast<size_t>(B);
  const int qr = (min(qlen[b], Lq) + 7) >> 3;
  const int tr = (min(tlen[b], Lt) + 7) >> 3;
  const int k_other = tr - (qr - k_band);
  for (int j = 0; j < qr * 8; ++j) {
    gH[static_cast<size_t>(j) * sB + b] = 0;
    gE[static_cast<size_t>(j) * sB + b] = 0;
  }
  int best = 0, qend = 0, tend = 0;
  for (int s = 0; s < tr; ++s) {
    int tc[8], h[8], f[8], p[8];  // row c of the strip: banded.h's [c + 1]
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      tc[c] = T[static_cast<size_t>(s * 8 + c) * sB + b];
      h[c] = 0;
      f[c] = 0;
      p[c] = 0;
    }
    const int j_lo = max(0, s - k_other + 1) * 8;
    const int j_hi = min(k_band + s, qr) * 8;
    for (int j = j_lo; j < j_hi; ++j) {
      const size_t at = static_cast<size_t>(j) * sB + b;
      const int qc = Q[at];
      int up = gH[at];  // H of the row above in this column
      int e = gE[at];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        int sub = (qc == tc[c]) ? match : -mismatch;
        if (WITH_N && (qc == kN4 || tc[c] == kN4)) sub = n_score;
        f[c] = max(h[c] - goe, f[c] - ge);
        int hm = max(max(p[c] + sub, f[c]), 0);
        e = max(up - goe, e - ge);
        hm = max(hm, e);
        if (MODE == END) {
          if (hm > best) {
            best = hm;
            qend = j;
            tend = s * 8 + c;
          }
        } else {
          best = max(best, hm);
        }
        p[c] = up;
        h[c] = hm;
        up = hm;
      }
      gH[at] = h[7];
      gE[at] = e;
    }
  }
  out_score[b] = best;
  if (MODE == END) {
    out_qend[b] = qend;
    out_tend[b] = tend;
  }
}

}  // namespace

// mode: 0 SCORE, 1 END.  with_n = 0 is taken in SCORE mode only.  n_score:
// what a pairing with N scores (0, or -n_penalty).  Lengths are clamped to
// Lq / Lt.  Launches on `stream` without synchronising; returns
// cudaGetLastError().
extern "C" int banded_sw_launch(int mode, int with_n, const void* Q,
                                const void* T, const void* qlen,
                                const void* tlen, int B, int Lq, int Lt,
                                int k_band, int match, int mismatch,
                                int n_score, int goe, int ge, void* gH,
                                void* gE, void* score, void* qend, void* tend,
                                void* stream) {
  if ((Lq | Lt) & 7) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((B + kThreads - 1) / kThreads), block(kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto q = static_cast<const uint8_t*>(Q);
  auto t = static_cast<const uint8_t*>(T);
  auto ql = static_cast<const int*>(qlen);
  auto tl = static_cast<const int*>(tlen);
  auto h = static_cast<int*>(gH);
  auto e = static_cast<int*>(gE);
  auto s = static_cast<int*>(score);
  auto qe = static_cast<int*>(qend);
  auto te = static_cast<int*>(tend);
  if (mode == SCORE && with_n) {
    banded_sw_kernel<SCORE, true><<<grid, block, 0, st>>>(
        q, t, ql, tl, B, Lq, Lt, k_band, match, mismatch, n_score, goe, ge, h,
        e, s, qe, te);
  } else if (mode == SCORE) {
    banded_sw_kernel<SCORE, false><<<grid, block, 0, st>>>(
        q, t, ql, tl, B, Lq, Lt, k_band, match, mismatch, n_score, goe, ge, h,
        e, s, qe, te);
  } else if (mode == END && with_n) {
    banded_sw_kernel<END, true><<<grid, block, 0, st>>>(
        q, t, ql, tl, B, Lq, Lt, k_band, match, mismatch, n_score, goe, ge, h,
        e, s, qe, te);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
