// Local WITH_START reverse pass (GASAL2 local kernel, :441-511), one
// thread per alignment, for Hopper (sm_90a).
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
// scratch.  The max is tracked with a strict '>' in visit order, so the
// first cell attaining it is recorded.  The reference stops after the
// column segment (the 8 cells of one column inside one strip) at which the
// running max reaches the forward score; a thread here really stops
// there.  The TPU kernel runs every strip and emulates that stop with a
// masked, keyed selection; the result is the same cell.  With a forward
// score of 0 the first segment already reaches it.  Columns past the
// pair's own extent hold N4 padding: such a cell scores at most its
// diagonal neighbour, which was visited first, so it never becomes the
// max and the loop needs no length.
//
// Bound: integer ALU work per cell (about 15 operations, as END) over the
// cells up to the stop, which lies at the alignment's start: on a read
// aligned end to end that is most of the reversed prefix.  The simple
// design of local_sw.cu; DPX and packed 16-bit cells are left to later
// work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN4 = 14;  // 4-bit code of N (and of padding)
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
local_start_kernel(const uint8_t* __restrict__ Q,  // [Lq, B] reversed query
                   const uint8_t* __restrict__ T,  // [Lt, B] reversed target
                   const int* __restrict__ fwd,    // [B] forward score
                   int B, int Lq, int Lt, int match, int mismatch,
                   int n_score, int goe, int ge,
                   int* __restrict__ gH,           // [Lq, B] scratch
                   int* __restrict__ gE,           // [Lq, B] scratch
                   int* __restrict__ out_col,      // [B] cprime
                   int* __restrict__ out_strip,    // [B] sstrip
                   int* __restrict__ out_row)      // [B] r0
{
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = static_cast<size_t>(B);
  const int target = fwd[b];
  int best = -1, bcol = 0, bstrip = 0, brow = 0;  // h >= 0: cell 0 is taken
  const int n_strips = Lt >> 3;
  for (int s = 0; s < n_strips; ++s) {
    int tc[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) tc[c] = T[static_cast<size_t>(s * 8 + c) * sB + b];
    int hp[8], f[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      hp[c] = 0;
      f[c] = 0;
    }
    int diag0 = 0;
    for (int j = 0; j < Lq; ++j) {
      const size_t at = static_cast<size_t>(j) * sB + b;
      const int qc = Q[at];
      const int hcol = s ? gH[at] : 0;
      int e = s ? gE[at] : 0;
      int diag = diag0;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        int sub = (qc == tc[c]) ? match : -mismatch;
        if (qc == kN4 || tc[c] == kN4) sub = n_score;
        const int tmp = diag + sub;
        const int u = f[c];
        const int h = max(max(tmp, u), max(e, 0));
        if (h > best) {
          best = h;
          bcol = j;
          bstrip = s;
          brow = c;
        }
        const int tmpg = tmp - goe;
        f[c] = max(tmpg, u - ge);
        e = max(tmpg, e - ge);
        diag = hp[c];
        hp[c] = h;
      }
      diag0 = hcol;
      gH[at] = hp[7];
      gE[at] = e;
      if (best >= target) goto done;  // the column segment reached it
    }
  }
done:
  out_col[b] = bcol;
  out_strip[b] = bstrip;
  out_row[b] = brow;
}

}  // namespace

// n_score: what a pairing with N scores (0, or -n_penalty).  Launches on
// `stream` without synchronising; returns cudaGetLastError().
extern "C" int local_start_launch(const void* Q, const void* T, const void* fwd,
                                  int B, int Lq, int Lt, int match, int mismatch,
                                  int n_score, int goe, int ge, void* gH,
                                  void* gE, void* col, void* strip, void* row,
                                  void* stream) {
  const dim3 grid((B + kThreads - 1) / kThreads), block(kThreads);
  local_start_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(Q), static_cast<const uint8_t*>(T),
      static_cast<const int*>(fwd), B, Lq, Lt, match, mismatch, n_score, goe,
      ge, static_cast<int*>(gH), static_cast<int*>(gE), static_cast<int*>(col),
      static_cast<int*>(strip), static_cast<int*>(row));
  return static_cast<int>(cudaGetLastError());
}
