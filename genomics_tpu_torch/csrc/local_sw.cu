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
// SCORE16 / END16 (local_sw16_kernel) run G threads per two adjacent
// pairs (2k, 2k+1): H, E, f, diag and best of both pairs sit packed as
// s16x2 in one 32-bit register, so each SIMD or DPX instruction does two
// cells' work, and the gH/gE carry between a thread group's rounds is a
// [Lq, ceil(B/2)] packed scratch, half the int32 modes' bytes.  Bound:
// the work of SCORE and END, 12 and 15 operations per cell, at two cells
// to a packed lane-operation: 6 per cell in SCORE16; in END16 13 packed
// (all but the qend and tend selects) and those two in int32 per pair,
// 8.5.  The substitution takes 4
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
// score 0) whose outputs are not written.
//
// What the first 16-bit design lost (PERF.md section 6): one thread per
// two pairs in 128-thread blocks gave a launch half the int32 modes'
// warps, so below about 16k pairs it left SMs idle (14 blocks for 132 SMs
// at 3,382 pairs) and ran each pair pair's strips in one serial chain:
// END16 took 1.06-1.40x END's time there.  Here G threads share a pair
// pair's strips (G of 4 or 8 by cuda_align.split_group, a rule on
// ceil(B/2) and the card's SM count: 4 at bench.py's 65,536 pairs, 8 at
// the engine's and the align CLI's launches), the carry between the
// strips of a round passes by shuffle, each pair pair's codes come in as
// one 16-bit load where B is even, and each thread loads one column
// ahead.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN4 = 14;  // 4-bit code of N (and of padding)
constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;
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

// Two pairs' codes at p (p[0] low, p[1] high) widened to s16x2 halves:
// one 16-bit load where B is even (p is then 2-byte aligned), else two
// byte loads, the high half the dummy's code where the pair has no
// partner.
__device__ __forceinline__ uint32_t codes2(const uint8_t* p, bool even,
                                           bool two, uint32_t dummy) {
  if (even)
    return __byte_perm(*reinterpret_cast<const uint16_t*>(p), 0, 0x4140);
  return p[0] | (two ? p[1] : dummy) << 16;
}

// SCORE16 (ENDS = false) and END16 (ENDS = true): the SCORE / END walk
// above on two pairs at once, every DP quantity packed s16x2 (low half
// pair 2k, high half pair 2k+1), G packed threads sharing the pair pair's
// strips as local_start.cu's threads share a pair's: thread g takes
// strips g, g + G, ... in rounds of G, one column behind thread g - 1,
// from which it receives the packed (H, E) of the row above and the
// packed query codes by __shfl_up_sync; thread 0 loads the next column's
// codes and carry one column ahead and reads the carry that thread G - 1
// wrote in the round before.  Each thread tracks its strip's packed best
// (and, in END16, each half's cell); at a round's end the G strips are
// combined in visit order, each half by a scalar strict '>', so an
// earlier strip keeps a tie, as within a strip an earlier cell does.
template <bool ENDS, int G>
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
  static_assert(G >= 2 && 32 % G == 0, "a pair pair's threads share a warp");
  const int P = (B + 1) >> 1;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31, g = lane % G, first = lane - g;
  const int k = tid / G;
  const bool live = k < P;  // no early return: every lane shuffles
  const int b = 2 * k;
  const bool two = b + 1 < B, even = !(B & 1);
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
  const int nstrip = live ? Lt >> 3 : 0;
  uint32_t best = 0;
  int qend0 = 0, tend0 = 0, qend1 = 0, tend1 = 0;
  for (int r = 0; __any_sync(kFull, r * G < nstrip); ++r) {
    const int s = r * G + g;
    const bool mine = s < nstrip;
    uint32_t tc[8], tn[8], hp[8], f[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      tc[c] = mine ? codes2(T + static_cast<size_t>(s * 8 + c) * sB + b, even,
                            two, 17)
                   : 0;
      tn[c] = ENDS ? __vcmpeq2(tc[c], n42) : 0;
      hp[c] = 0;
      f[c] = nbig2;
    }
    // this strip's packed best and, in END16, each half's cell
    uint32_t sbest = 0;
    int sq0 = 0, st0 = 0, sq1 = 0, st1 = 0;
    uint32_t diag0 = 0;
    // thread 0's codes and carry of the next column, loaded ahead
    uint32_t qn = 0, hn = 0, en = 0;
    auto load = [&](int j) {
      qn = codes2(Q + static_cast<size_t>(j) * sB + b, even, two, 16);
      const size_t at = static_cast<size_t>(j) * sP + k;
      hn = s ? gH[at] : 0;
      en = s ? gE[at] : 0;
    };
    if (g == 0 && mine) load(0);
    uint32_t oh = 0, oe = 0, oq = 0;  // what this thread sent on, a column ago
    for (int kk = 0; kk < Lq + G - 1; ++kk) {
      uint32_t rh = hn, e = en, qc = qn;
      const uint32_t uh = __shfl_up_sync(kFull, oh, 1, G);
      const uint32_t ue = __shfl_up_sync(kFull, oe, 1, G);
      const uint32_t uq = __shfl_up_sync(kFull, oq, 1, G);
      if (g) {
        rh = uh;
        e = ue;
        qc = uq;
      }
      const int j = kk - g;
      if (g == 0 && mine && j + 1 < Lq) load(j + 1);
      if (mine && j >= 0 && j < Lq) {
        const uint32_t qnm = ENDS ? __vcmpeq2(qc, n42) : 0;
        uint32_t diag = diag0;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const uint32_t ne = minu2(qc ^ tc[c], 0x00010001u);
          uint32_t sub = add2(match2, ne * miss);
          if (ENDS) {
            const uint32_t nm = qnm | tn[c];
            sub = (sub & ~nm) | (nsc2 & nm);
          }
          const uint32_t tmp = add2(diag, sub);
          const uint32_t h = __vimax3_s16x2_relu(tmp, f[c], e);
          if (ENDS) {
            bool keep_hi, keep_lo;  // sbest >= h: a tie keeps the earlier cell
            sbest = __vibmax_s16x2(sbest, h, &keep_hi, &keep_lo);
            sq0 = keep_lo ? sq0 : j;
            st0 = keep_lo ? st0 : s * 8 + c;
            sq1 = keep_hi ? sq1 : j;
            st1 = keep_hi ? st1 : s * 8 + c;
          } else {
            sbest = max2(sbest, h);
          }
          const uint32_t tmpg = add2(tmp, ngoe2);
          f[c] = __viaddmax_s16x2(f[c], nge2, tmpg);
          e = __viaddmax_s16x2(e, nge2, tmpg);
          diag = hp[c];
          hp[c] = h;
        }
        diag0 = rh;
        oh = hp[7];
        oe = e;
        oq = qc;
        if (g == G - 1 && s + 1 < nstrip) {
          const size_t at = static_cast<size_t>(j) * sP + k;
          gH[at] = oh;
          gE[at] = oe;
        }
      }
      __syncwarp();  // thread G-1's carry writes before thread 0's reads
    }
    // the round's strips in visit order, each half on its own: strictly
    // greater replaces, so an earlier strip keeps a tie
    int blo = lo16(best), bhi = hi16(best);
#pragma unroll
    for (int h = 0; h < G; ++h) {
      const int src = first + h;
      const uint32_t m = __shfl_sync(kFull, sbest, src);
      if (ENDS) {
        const int mq0 = __shfl_sync(kFull, sq0, src);
        const int mt0 = __shfl_sync(kFull, st0, src);
        const int mq1 = __shfl_sync(kFull, sq1, src);
        const int mt1 = __shfl_sync(kFull, st1, src);
        if (lo16(m) > blo) {
          blo = lo16(m);
          qend0 = mq0;
          tend0 = mt0;
        }
        if (hi16(m) > bhi) {
          bhi = hi16(m);
          qend1 = mq1;
          tend1 = mt1;
        }
      } else {
        blo = max(blo, lo16(m));
        bhi = max(bhi, hi16(m));
      }
    }
    best = (static_cast<uint32_t>(blo) & 0xFFFFu) | static_cast<uint32_t>(bhi) << 16;
  }
  if (!live || g) return;
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

template <bool ENDS>
int launch16(int group, const uint8_t* q, const uint8_t* t, int B, int Lq,
             int Lt, int match, int mismatch, int n_score, int goe, int ge,
             uint32_t* h, uint32_t* e, int* s, int* qe, int* te,
             cudaStream_t st) {
  const long long threads = static_cast<long long>((B + 1) / 2) * group;
  const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads));
#define LOCAL16(G)                                                           \
  local_sw16_kernel<ENDS, G><<<grid, kThreads, 0, st>>>(                     \
      q, t, B, Lq, Lt, match, mismatch, n_score, goe, ge, h, e, s, qe, te)
  switch (group) {
    case 4: LOCAL16(4); break;
    case 8: LOCAL16(8); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LOCAL16
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mode: 0 SCORE, 1 END, 2 TB, 4 SCORE16, 5 END16.  SCORE takes with_n 0
// or 1, SCORE16 only 0, the others only 1.  group: threads per pair (1)
// in the int32 modes, per two pairs (4 or 8) in the 16-bit ones,
// whose gH/gE are [Lq, ceil(B/2)] 32-bit words.
// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int local_sw_launch(int mode, int with_n, int group, const void* Q,
                               const void* T, int B, int Lq, int Lt, int match,
                               int mismatch, int n_score, int goe, int ge,
                               void* gH, void* gE, void* score, void* qend,
                               void* tend, void* tb, void* stream) {
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
  if (mode == SCORE16 && !with_n)
    return launch16<false>(group, q, t, B, Lq, Lt, match, mismatch, n_score,
                           goe, ge, static_cast<uint32_t*>(gH),
                           static_cast<uint32_t*>(gE), s, qe, te, st);
  if (mode == END16 && with_n)
    return launch16<true>(group, q, t, B, Lq, Lt, match, mismatch, n_score,
                          goe, ge, static_cast<uint32_t*>(gH),
                          static_cast<uint32_t*>(gE), s, qe, te, st);
  if (group != 1) return static_cast<int>(cudaErrorInvalidValue);
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
