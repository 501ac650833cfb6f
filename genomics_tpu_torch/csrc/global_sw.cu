// Global affine-gap Needleman-Wunsch (GASAL2 global kernel), one thread
// per alignment, for Hopper (sm_90a).
//
// Replaces the Pallas kernels
//   mode SCORE  genomics_tpu/ops/pallas_gs.py _global_kernel_intertask
//               (:65): the score H(tlen-1, qlen-1);
//   mode TB     genomics_tpu/ops/pallas_align.py _global_kernel (:1201)
//               with traceback: the score plus one packed int32 of 4-bit
//               direction nibbles per (strip, query column), the sqb
//               layout [Lt/8, Lq, B] that tb_walk.cu reads.
// The ends are (qlen-1, tlen-1) by definition; the wrapper writes them.
// The TPU's lanes / inter-task split exists for its vector layout only;
// here one kernel serves every batch size.
//
// Specification: genomics_tpu/core/golds.py global_align (the emulation of
// global.h:31-303), the same walk as local_sw.cu: 8-row target strips,
// query columns left to right inside a strip, the 8 rows down inside a
// column, H of the previous column and the f chain in registers, the
// per-column carry between strips (gH/gE, GASAL2's global[] array) in a
// [Lq, B] int32 scratch, coalesced with b innermost.  What differs from
// the local core: no 0-clamp, and the boundaries of global.h, reference
// quirks included —
//   H(-1, j) = 0 if j == 0 else -(gapo + ge*j), E(-1, j) = MINUS_INF;
//   H(i, -1) = -(gapo + ge*(i+1))                 (the u counter);
//   diag(i, 0) = 0 if i == 0 else -(gapo + ge*i)  (the r counter);
//   f = MINUS_INF at the start of every strip, so f chains down from
//   MINUS_INF in int32 (no 16-bit wrap, as in the JAX package).
// Substitution uses GASAL2's *global* macro: N is an ordinary base
// (N == N scores +match), unless n_penalty is set.  The pair's padding
// cells are computed like any other; the TB cube holds every cell of
// the bucket, because the walk starts one cell past the end.
//
// Bound: integer ALU work per cell, about 10 operations in SCORE and 20
// in TB, counted as one per add, max, compare or select, plus, in TB, the
// nibble-cube writes (4 bytes per 8 cells).
//
// What held the first design at 4.4x SCORE (PERF.md's findings, from
// tools/sass_report.py and tools/tb_variants.py on an H100) was not the
// cell: its SASS was as long as semiglobal_sw.cu's TB cell, which took
// 1.3x its END kernel.  It was (1) the score's cell taken by a compare
// and select in every cell, and (2) each column's query code and carry
// loaded at the column's top and used a few instructions later, so each
// column waited on device memory.  Here the score's cell is taken once,
// after column jl of strip il / 8, and the next column's loads are
// issued before this column is computed.  The cell takes Hopper's DPX
// maxima where the SASS has them: __vimax3_s32 (VIMNMX3) for h and
// __viaddmax_s32 (VIADDMNMX) for the gap chains, and the extension bits
// compare the pre-update chains with tmp - gapo (tmp - goe > u - ge is
// u < tmp - gapo), so no u - ge or e - ge is formed.  Taking the
// direction bits from __vibmax_s32's predicates made the column longer:
// on sm_90 it compiles to a compare and a select, so it is not used.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN4 = 14;  // 4-bit code of N (and of padding)
constexpr int kMinusInf = -32768;
constexpr int kThreads = 128;
enum Mode { SCORE = 0, TB = 1 };

template <int MODE, bool N_PENALTY>
__global__ void __launch_bounds__(kThreads)
global_sw_kernel(const uint8_t* __restrict__ Q,  // [Lq, B]
                 const uint8_t* __restrict__ T,  // [Lt, B]
                 const int* __restrict__ qlen,   // [B]
                 const int* __restrict__ tlen,   // [B]
                 int B, int Lq, int Lt, int match, int mismatch, int n_pen,
                 int gapo, int ge,
                 int* __restrict__ gH,           // [Lq, B] scratch
                 int* __restrict__ gE,           // [Lq, B] scratch
                 int* __restrict__ out_score,    // [B]
                 int* __restrict__ tb)           // [Lt/8, Lq, B] (TB)
{
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = static_cast<size_t>(B);
  const int goe = gapo + ge;
  const int jl = qlen[b] - 1, il = tlen[b] - 1;  // the score's cell
  const int sl = il >> 3, cl = il & 7;
  int score = 0;
  const int n_strips = Lt >> 3;
  for (int s = 0; s < n_strips; ++s) {
    int tc[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) tc[c] = T[static_cast<size_t>(s * 8 + c) * sB + b];
    int hp[8], f[8];  // H(row c, j-1) and the f chain of row c
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      hp[c] = -(gapo + ge * (s * 8 + c + 1));
      f[c] = kMinusInf;
    }
    int diag0 = s ? -(gapo + ge * s * 8) : 0;  // diag(strip row 0, col 0)
    // column 0's query code and carry from the strip above; each column
    // loads the next one's before computing its own
    int qn = Q[b];
    int hn = s ? gH[b] : 0;
    int en = s ? gE[b] : kMinusInf;
    for (int j = 0; j < Lq; ++j) {
      const size_t at = static_cast<size_t>(j) * sB + b;
      const int qc = qn, hcol = hn;
      int e = en;
      if (j + 1 < Lq) {
        qn = Q[at + sB];
        hn = s ? gH[at + sB] : -(gapo + ge * (j + 1));
        en = s ? gE[at + sB] : kMinusInf;
      }
      int diag = diag0;
      uint32_t word = 0;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        int sub = (qc == tc[c]) ? match : -mismatch;
        if (N_PENALTY && (qc == kN4 || tc[c] == kN4)) sub = -n_pen;
        const int tmp = diag + sub;
        const int u = f[c];
        const int tmpg = tmp - goe;
        const int h = __vimax3_s32(tmp, u, e);
        if (MODE == TB) {
          // direction from the pre-update chains (pallas_align.py:1233-
          // 1240); f_ext = !(tmp - goe > u - ge) = (u >= tmp - gapo)
          const int tg = tmp - gapo;
          const uint32_t d = (h == tmp) ? static_cast<uint32_t>(sub) >> 31
                                        : (h == u ? 3u : 2u);
          word |= (d | (e >= tg ? 4u : 0u) | (u >= tg ? 8u : 0u)) << (4 * c);
        }
        f[c] = __viaddmax_s32(u, -ge, tmpg);
        e = __viaddmax_s32(e, -ge, tmpg);
        diag = hp[c];
        hp[c] = h;
      }
      if (j == jl && s == sl) {
#pragma unroll
        for (int c = 0; c < 8; ++c)
          if (c == cl) score = hp[c];
      }
      diag0 = hcol;
      gH[at] = hp[7];
      gE[at] = e;
      if (MODE == TB) tb[(static_cast<size_t>(s) * Lq + j) * sB + b] = static_cast<int>(word);
    }
  }
  out_score[b] = score;
}

}  // namespace

// mode: 0 SCORE, 1 TB.  with_n_penalty = 0 takes the global macro (N is
// an ordinary base).  Launches on `stream` without synchronising; returns
// cudaGetLastError().
extern "C" int global_sw_launch(int mode, int with_n_penalty, const void* Q,
                                const void* T, const void* qlen,
                                const void* tlen, int B, int Lq, int Lt,
                                int match, int mismatch, int n_penalty,
                                int gapo, int ge, void* gH, void* gE,
                                void* score, void* tb, void* stream) {
  const dim3 grid((B + kThreads - 1) / kThreads), block(kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto q = static_cast<const uint8_t*>(Q);
  auto t = static_cast<const uint8_t*>(T);
  auto ql = static_cast<const int*>(qlen);
  auto tl = static_cast<const int*>(tlen);
  auto h = static_cast<int*>(gH);
  auto e = static_cast<int*>(gE);
  auto s = static_cast<int*>(score);
  auto w = static_cast<int*>(tb);
  const bool npen = with_n_penalty != 0;
  if (mode == SCORE && npen) {
    global_sw_kernel<SCORE, true><<<grid, block, 0, st>>>(
        q, t, ql, tl, B, Lq, Lt, match, mismatch, n_penalty, gapo, ge, h, e, s, w);
  } else if (mode == SCORE) {
    global_sw_kernel<SCORE, false><<<grid, block, 0, st>>>(
        q, t, ql, tl, B, Lq, Lt, match, mismatch, n_penalty, gapo, ge, h, e, s, w);
  } else if (mode == TB && npen) {
    global_sw_kernel<TB, true><<<grid, block, 0, st>>>(
        q, t, ql, tl, B, Lq, Lt, match, mismatch, n_penalty, gapo, ge, h, e, s, w);
  } else if (mode == TB) {
    global_sw_kernel<TB, false><<<grid, block, 0, st>>>(
        q, t, ql, tl, B, Lq, Lt, match, mismatch, n_penalty, gapo, ge, h, e, s, w);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
