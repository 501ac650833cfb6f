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
// Bound: integer ALU work per cell (about 10 operations in SCORE, 20 in
// TB) plus, in TB, the nibble-cube writes (4 bytes per 8 cells).  This
// first design is the simple one: DPX __vimax3_s32, packed 16-bit cells
// and shared-memory carries are left to later work.

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
    const int cl = (il >> 3) == s ? (il & 7) : -1;
    for (int j = 0; j < Lq; ++j) {
      const size_t at = static_cast<size_t>(j) * sB + b;
      const int qc = Q[at];
      const int hcol = s ? gH[at] : (j ? -(gapo + ge * j) : 0);
      int e = s ? gE[at] : kMinusInf;
      int diag = diag0;
      uint32_t word = 0;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        int sub = (qc == tc[c]) ? match : -mismatch;
        if (N_PENALTY && (qc == kN4 || tc[c] == kN4)) sub = -n_pen;
        const int tmp = diag + sub;
        const int u = f[c];
        const int h = max(max(tmp, u), e);
        if (j == jl && c == cl) score = h;
        const int tmpg = tmp - goe;
        if (MODE == TB) {
          // direction from the pre-update chains (pallas_align.py:1233-1240)
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
