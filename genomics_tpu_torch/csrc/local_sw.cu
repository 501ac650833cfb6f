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
//   mode SCORE16 _local_kernel_intertask_score16 (:557): SCORE with every
//               DP quantity in signed 16 bits, no N compare (the has_n=False
//               contract: the wrapper has remapped the pads to 16/17).
//   mode END16  _local_kernel_intertask16 (:636): END (N-aware) with every
//               DP quantity in signed 16 bits; the ends stay int32.
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
// cell count besides the gH/gE carry).
//
// What held the first design's TB mode at 4.9x its END mode, for 1.7x the
// work (PERF.md's findings, from tools/sass_report.py and
// tools/kernel_variants.py on an H100), was not the cell: it was each
// column's query code and carry, loaded at the column's top and used a
// few instructions later, as in global_sw.cu's first design.  With the
// loads there, a mode's time depended on how nvcc scheduled its column:
// SCORE took 2.3 ms or, with only its maxima written differently (nvcc
// then unrolled the column loop by two), 10.6.  Here every mode loads
// the next column's code and carry before computing its own (the
// boundary values where s == 0); that alone took TB from 11.0 to 2.4 ms.
// The cell takes Hopper's DPX maxima: __vimax3_s32_relu
// (VIMNMX3) for h and __viaddmax_s32 (VIADDMNMX) for the gap chains, and
// TB's extension bits compare the pre-update chains with tmp - gapo, so
// no u - ge or e - ge is formed.  The best tracking (strict '>', the
// earliest cell in visit order) is LOCAL's own work and stays in every
// cell.
//
// SCORE16 / END16 (local_sw16_kernel) run one thread per two adjacent
// pairs (2k, 2k+1): H, E, f, diag and best of both pairs sit packed as
// s16x2 in one 32-bit register, so each SIMD or DPX instruction does two
// cells' work, and the gH/gE carry is a [Lq, ceil(B/2)] packed scratch,
// half the int32 modes' bytes.  Bound: the work of SCORE and END, 12 and
// 15 operations per cell, at two cells to a packed lane-operation: 6 per
// cell in SCORE16; in END16 13 packed (all but the qend and tend selects)
// and those two in int32 per pair, 8.5.  The substitution takes 4
// instructions here (xor, min.u16x2 to 0 / 1 per half, one multiply,
// add.s16x2), since __vcmpeq2 is a sequence on sm_90.  END16 replaces the
// best only where h is strictly greater (__vibmax_s16x2's predicates), so
// the earliest cell in strip order keeps it, as the JAX kernel's key
// ((ib * Lq + j) * 8 + c) does.  The packed adds wrap: the results are
// right only in range, which the wrapper checks (match * Lq against the
// JAX gates, and the gap and mismatch terms); there every value equals
// the int32 modes' bit for bit: h >= 0 and tmp >= -mismatch (or the N
// score), so f and e floor at -(mismatch + goe + ge).  An odd B's last
// thread pairs its pair with a dummy of codes 16 / 17 (all mismatches,
// score 0) whose outputs are not written.  A simple packed kernel first:
// tuning is later work (PERF.md section 6).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN4 = 14;  // 4-bit code of N (and of padding)
constexpr int kThreads = 128;
enum Mode { SCORE = 0, END = 1, TB = 2, SECOND = 3, SCORE16 = 4, END16 = 5 };

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
  const int gapo = goe - ge;
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
    // column 0's query code and carry from the strip above; each column
    // loads the next one's before computing its own
    int qn = Q[b];
    int hn = s ? gH[b] : 0;
    int en = s ? gE[b] : 0;
    for (int j = 0; j < Lq; ++j) {
      const size_t at = static_cast<size_t>(j) * sB + b;
      const int qc = qn, hcol = hn;
      int e = en;
      if (j + 1 < Lq) {
        qn = Q[at + sB];
        hn = s ? gH[at + sB] : 0;
        en = s ? gE[at + sB] : 0;
      }
      int diag = diag0;
      uint32_t word = 0;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        int sub = (qc == tc[c]) ? match : -mismatch;
        if (WITH_N && (qc == kN4 || tc[c] == kN4)) sub = n_score;
        const int tmp = diag + sub;
        const int u = f[c];
        const int tmpg = tmp - goe;
        const int h = __vimax3_s32_relu(tmp, u, e);
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
        if (MODE == TB) {
          // direction from the pre-update chains (pallas_align.py:776-
          // 787); f_ext = !(tmp - goe > u - ge) = (u >= tmp - gapo)
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

__device__ __forceinline__ uint32_t pack2(int x) {
  return (static_cast<uint32_t>(x) & 0xFFFFu) * 0x10001u;
}

// Packed 16-bit PTX instructions, one SASS instruction each on sm_90
// (VIADD.16x2, VIMNMX.S16x2 / .U16x2); the substitution is built from
// them because __vcmpeq2 compiles to a sequence there (it is used only
// for the N masks, once per column and strip).
__device__ __forceinline__ uint32_t add2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("add.s16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ uint32_t max2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("max.s16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ uint32_t minu2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("min.u16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ int lo16(uint32_t x) {
  return static_cast<int16_t>(x & 0xFFFFu);
}

__device__ __forceinline__ int hi16(uint32_t x) {
  return static_cast<int16_t>(x >> 16);
}

// SCORE16 (ENDS = false) and END16 (ENDS = true): the SCORE / END walk
// above on two pairs at once, every DP quantity packed s16x2 (low half
// pair 2k, high half pair 2k+1).
template <bool ENDS>
__global__ void __launch_bounds__(kThreads)
local_sw16_kernel(const uint8_t* __restrict__ Q,  // [Lq, B]
                  const uint8_t* __restrict__ T,  // [Lt, B]
                  int B, int Lq, int Lt, int match, int mismatch, int n_score,
                  int goe, int ge,
                  uint32_t* __restrict__ gH,      // [Lq, ceil(B/2)] scratch
                  uint32_t* __restrict__ gE,      // [Lq, ceil(B/2)] scratch
                  int* __restrict__ out_score,    // [B]
                  int* __restrict__ out_qend,     // [B] (END16)
                  int* __restrict__ out_tend)     // [B] (END16)
{
  const int P = (B + 1) >> 1;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= P) return;
  const int b = 2 * k;
  const bool two = b + 1 < B;
  const size_t sB = static_cast<size_t>(B), sP = static_cast<size_t>(P);
  // sub = match2 + ne * (-(match + mismatch)) per half, ne = 0 / 1: each
  // half's product fits in 16 bits, so one 32-bit multiply does both
  const uint32_t match2 = pack2(match);
  const uint32_t miss = static_cast<uint32_t>(-(match + mismatch)) & 0xFFFFu;
  const uint32_t nsc2 = pack2(n_score), n42 = pack2(kN4);
  const uint32_t ngoe2 = pack2(-goe), nge2 = pack2(-ge);
  // the f chains start each strip at the TPU kernels' int16 -inf, -4096
  // (pallas_align.py:588, :653); any seed <= 0 gives the same H
  const uint32_t nbig2 = pack2(-4096);
  uint32_t best = 0;
  int qend0 = 0, tend0 = 0, qend1 = 0, tend1 = 0;
  // column j's codes of both pairs and its carry
  auto load = [&](int j, int s, uint32_t& qc, uint32_t& hcol, uint32_t& e) {
    const uint8_t* col = Q + static_cast<size_t>(j) * sB + b;
    qc = col[0] | static_cast<uint32_t>(two ? col[1] : 16) << 16;
    const size_t at = static_cast<size_t>(j) * sP + k;
    hcol = s ? gH[at] : 0;
    e = s ? gE[at] : 0;
  };
  const int n_strips = Lt >> 3;
  for (int s = 0; s < n_strips; ++s) {
    uint32_t tc[8], tn[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const uint8_t* row = T + static_cast<size_t>(s * 8 + c) * sB + b;
      tc[c] = row[0] | static_cast<uint32_t>(two ? row[1] : 17) << 16;
      tn[c] = ENDS ? __vcmpeq2(tc[c], n42) : 0;
    }
    uint32_t hp[8], f[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      hp[c] = 0;
      f[c] = nbig2;
    }
    uint32_t diag0 = 0;
    // With half the int32 modes' threads, a warp that waits for its
    // column's loads finds few others to run: the next two columns' loads
    // are in flight while this one computes.
    uint32_t qc1, hcol1, e1, qc2, hcol2, e2;
    load(0, s, qc1, hcol1, e1);
    load(min(1, Lq - 1), s, qc2, hcol2, e2);
    for (int j = 0; j < Lq; ++j) {
      const uint32_t qc = qc1, hcol = hcol1;
      uint32_t e = e1;
      qc1 = qc2;
      hcol1 = hcol2;
      e1 = e2;
      load(min(j + 2, Lq - 1), s, qc2, hcol2, e2);
      const uint32_t qn = ENDS ? __vcmpeq2(qc, n42) : 0;
      const size_t at = static_cast<size_t>(j) * sP + k;
      uint32_t diag = diag0;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const uint32_t ne = minu2(qc ^ tc[c], 0x00010001u);
        uint32_t sub = add2(match2, ne * miss);
        if (ENDS) {
          const uint32_t nm = qn | tn[c];
          sub = (sub & ~nm) | (nsc2 & nm);
        }
        const uint32_t tmp = add2(diag, sub);
        const uint32_t h = __vimax3_s16x2_relu(tmp, f[c], e);
        if (ENDS) {
          bool keep_hi, keep_lo;  // best >= h: a tie keeps the earlier cell
          best = __vibmax_s16x2(best, h, &keep_hi, &keep_lo);
          qend0 = keep_lo ? qend0 : j;
          tend0 = keep_lo ? tend0 : s * 8 + c;
          qend1 = keep_hi ? qend1 : j;
          tend1 = keep_hi ? tend1 : s * 8 + c;
        } else {
          best = max2(best, h);
        }
        const uint32_t tmpg = add2(tmp, ngoe2);
        f[c] = __viaddmax_s16x2(f[c], nge2, tmpg);
        e = __viaddmax_s16x2(e, nge2, tmpg);
        diag = hp[c];
        hp[c] = h;
      }
      diag0 = hcol;
      gH[at] = hp[7];
      gE[at] = e;
    }
  }
  out_score[b] = lo16(best);
  if (ENDS) {
    out_qend[b] = qend0;
    out_tend[b] = tend0;
  }
  if (two) {
    out_score[b + 1] = hi16(best);
    if (ENDS) {
      out_qend[b + 1] = qend1;
      out_tend[b + 1] = tend1;
    }
  }
}

}  // namespace

// mode: 0 SCORE, 1 END, 2 TB, 4 SCORE16, 5 END16.  SCORE takes with_n 0
// or 1, SCORE16 only 0, the others only 1.  The 16-bit modes' gH/gE are
// [Lq, ceil(B/2)] 32-bit words (one thread per two pairs).
// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int local_sw_launch(int mode, int with_n, const void* Q, const void* T,
                               int B, int Lq, int Lt, int match, int mismatch,
                               int n_score, int goe, int ge, void* gH, void* gE,
                               void* score, void* qend, void* tend, void* tb,
                               void* stream) {
  const dim3 grid((B + kThreads - 1) / kThreads), block(kThreads);
  const dim3 grid16((B + 2 * kThreads - 1) / (2 * kThreads));
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
  } else if (mode == SCORE16 && !with_n) {
    local_sw16_kernel<false><<<grid16, block, 0, st>>>(
        q, t, B, Lq, Lt, match, mismatch, n_score, goe, ge,
        static_cast<uint32_t*>(gH), static_cast<uint32_t*>(gE), s, qe, te);
  } else if (mode == END16 && with_n) {
    local_sw16_kernel<true><<<grid16, block, 0, st>>>(
        q, t, B, Lq, Lt, match, mismatch, n_score, goe, ge,
        static_cast<uint32_t*>(gH), static_cast<uint32_t*>(gE), s, qe, te);
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
