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
// per-column carry between strips (GASAL2's global[] array) starts at zero
// and is written only in band, so a column that leaves the band keeps its
// stale value (a reference quirk, kept).  Rows and columns of the band
// past a length read the N4 padding.  The max is tracked with a strict '>'
// in visit order, so the earliest cell attaining it gives the ends; they
// stay 0 when the score is 0.
//
// Where the carry lives.  A pair's band starts at its own column, so once
// a warp's bands part, its threads stand on different columns, and the
// first design's [Lq, B] scratch gave every access a line of its own (it
// ran at 5-7.6x its bound).  Both ends of the band only move right from
// one strip to the next, so the live columns form a window: a column is
// read only from the strip after the one that first reached it (before
// that it reads zero, which is how the zero start is kept with no zeroing
// pass) and never after it left the band.  The window is at most
// min(qr, (2 k_band - 1 + tr) / 2) tiles wide (its width at strip ib is
// at most min(k_band + k_other - 1, qr) = min(2 k_band - 1 + tr - qr,
// qr)), so the carry is a ring of `ring` columns, column j in slot
// j mod ring, which the wrapper sizes from the shape and the band alone
// (ops/cuda_align.py banded_ring: 104 of 152 columns at bench.py's
// shape).  Its layout is the launcher's `shared` flag, a rule on the ring
// (banded_layout):
//   shared  each block of 32 threads keeps its threads' (h, e) ring as
//           int2 in dynamic shared memory, [ring][32].  Column j of thread
//           tid is the 32-bit word 2 (slot 32 + tid), whose bank is
//           2 tid mod 32 whatever the slot: a warp's 8-byte access is free
//           of bank conflicts wherever its threads stand.  A block is one
//           warp, so an SM holds as many as its shared memory fits (8 at
//           bench.py's shape, 256 threads) and a launch of any size
//           spreads over every SM.  Each thread touches only its own
//           column, so no __syncthreads() is needed.
//   global  where 32 threads' rings do not fit the 232,448 bytes a block
//           may have (ring > 908), the ring lives in a [B, ring] int2
//           scratch, thread-major, so that each thread streams its own
//           lines through L1; 128 threads a block.
// Each thread reads its query's 8-code tiles from its own [B, Lq] row
// through L1, which leaves the shared memory to the rings, and the next
// tile's 8 carries and query codes are loaded before this tile is
// computed.  A warp runs as
// long as its longest band, and at bench.py's shape its lanes do 0.55 of
// the band tiles it runs; on inputs ordered by band tiles beforehand they
// did 1.0 and the kernel took 0.68x the time, but the ordering's own
// small launches (the tiles, the argsort, the gathers) cost more than it
// saved, and at the engine's launches the lanes already do 0.80-0.96.  So
// the pairs run in the caller's order.  PERF.md section 6 has the
// variants' times (tools/kernel_variants.py).
//
// Bound: integer ALU work per band cell (about 19 operations in END, 13
// in SCORE without the N compare), counted as one per add, max, compare or
// select.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN4 = 14;  // 4-bit code of N (and of padding)
constexpr int kSharedThreads = 32;
constexpr int kGlobalThreads = 128;
constexpr int kMaxShared = 232448;  // the most a block may have on sm_90
enum Mode { SCORE = 0, END = 1 };

struct Args {
  const uint8_t* Q;  // [B, Lq], Lq % 8 == 0
  const uint8_t* T;  // [B, Lt], Lt % 8 == 0
  const int* qlen;   // [B]
  const int* tlen;   // [B]
  int B, Lq, Lt, k_band, match, mismatch, n_score, goe, ge, ring;
  int2* ehg;         // [B, ring] (global layout)
  int* score;        // [B]
  int* qend;         // [B] (END)
  int* tend;         // [B] (END)
};

__device__ __forceinline__ int code(uint2 w, int x) {
  return ((x < 4 ? w.x : w.y) >> (8 * (x & 3))) & 0xff;
}

template <int MODE, bool WITH_N, bool SHARED>
__global__ void __launch_bounds__(SHARED ? kSharedThreads : kGlobalThreads)
banded_sw_kernel(const Args a) {
  extern __shared__ int2 smem[];
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const int Lq = a.Lq, ring = a.ring, goe = a.goe, ge = a.ge;
  const uint2* qt = reinterpret_cast<const uint2*>(a.Q + static_cast<size_t>(b) * Lq);
  const uint2* trow = reinterpret_cast<const uint2*>(a.T + static_cast<size_t>(b) * a.Lt);
  const int qr = (min(a.qlen[b], Lq) + 7) >> 3;
  const int tr = (min(a.tlen[b], a.Lt) + 7) >> 3;
  const int k_other = tr - (qr - a.k_band);
  // this thread's carry of ring slot j: eh[j * es]
  const int es = SHARED ? kSharedThreads : 1;
  int2* eh = SHARED ? smem + threadIdx.x : a.ehg + static_cast<size_t>(b) * ring;

  int best = 0, qend = 0, tend = 0;
  int seen = 0;  // tiles any earlier strip reached: the rest read zero
  for (int s = 0; s < tr; ++s) {
    const uint2 tw = trow[s];
    int tc[8], h[8], f[8], p[8];  // row c of the strip: banded.h's [c + 1]
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      tc[c] = code(tw, c);
      h[c] = 0;
      f[c] = 0;
      p[c] = 0;
    }
    const int lo = max(0, s - k_other + 1), hi = min(a.k_band + s, qr);
    int slot = (lo * 8) % ring;
    int2 cn[8];
    uint2 qn = make_uint2(0, 0);
    if (lo < hi) {
      qn = qt[lo];
#pragma unroll
      for (int x = 0; x < 8; ++x)
        cn[x] = lo < seen ? eh[(slot + x) * es] : make_int2(0, 0);
    }
    for (int k = lo; k < hi; ++k) {
      int2 cc[8];
#pragma unroll
      for (int x = 0; x < 8; ++x) cc[x] = cn[x];
      const uint2 qw = qn;
      const int here = slot;
      slot = slot + 8 == ring ? 0 : slot + 8;
      if (k + 1 < hi) {
        qn = qt[k + 1];
#pragma unroll
        for (int x = 0; x < 8; ++x)
          cn[x] = k + 1 < seen ? eh[(slot + x) * es] : make_int2(0, 0);
      }
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const int qc = code(qw, x);
        int up = cc[x].x;  // H of the row above in this column
        int e = cc[x].y;
        const int top = best;
        int brow = 0;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          int sub = (qc == tc[c]) ? a.match : -a.mismatch;
          if (WITH_N && (qc == kN4 || tc[c] == kN4)) sub = a.n_score;
          f[c] = max(h[c] - goe, f[c] - ge);
          int hm = max(max(p[c] + sub, f[c]), 0);
          e = max(up - goe, e - ge);
          hm = max(hm, e);
          if (MODE == END) {
            if (hm > best) {
              best = hm;
              brow = c;
            }
          } else {
            best = max(best, hm);
          }
          p[c] = up;
          h[c] = hm;
          up = hm;
        }
        if (MODE == END && best > top) {
          qend = k * 8 + x;
          tend = s * 8 + brow;
        }
        eh[(here + x) * es] = make_int2(h[7], e);
      }
    }
    seen = max(seen, hi);
  }
  a.score[b] = best;
  if (MODE == END) {
    a.qend[b] = qend;
    a.tend[b] = tend;
  }
}

template <int MODE, bool WITH_N, bool SHARED>
int launch(const Args& a, size_t shared, cudaStream_t st) {
  auto kernel = banded_sw_kernel<MODE, WITH_N, SHARED>;
  if (SHARED) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = SHARED ? kSharedThreads : kGlobalThreads;
  kernel<<<(a.B + threads - 1) / threads, threads, shared, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mode: 0 SCORE, 1 END.  with_n = 0 is taken in SCORE mode only.  n_score:
// what a pairing with N scores (0, or -n_penalty).  Q [B, Lq] and T
// [B, Lt] row-major, Lq and Lt multiples of 8; lengths are clamped to
// Lq / Lt.  ring: the carry's columns, a positive multiple of
// 8 that covers every pair's widest band window.  shared = 1 keeps the
// rings in shared memory, 32 threads a block (eh unused; 32 x 8 ring
// bytes must fit 232,448); shared = 0 takes eh, a [B, ring] int2 scratch,
// and 128 threads a block.  Launches on `stream` without synchronising;
// returns cudaFuncSetAttribute's error, else cudaGetLastError().
extern "C" int banded_sw_launch(int mode, int with_n, int shared,
                                const void* Q, const void* T,
                                const void* qlen, const void* tlen, int B,
                                int Lq, int Lt,
                                int k_band, int match, int mismatch,
                                int n_score, int goe, int ge, int ring,
                                void* eh, void* score, void* qend, void* tend,
                                void* stream) {
  const size_t smem =
      shared ? static_cast<size_t>(8 * ring) * kSharedThreads : 0;
  if ((Lq | Lt | ring) & 7 || ring < 8 ||
      (shared ? smem > kMaxShared : eh == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const uint8_t*>(Q), static_cast<const uint8_t*>(T),
               static_cast<const int*>(qlen), static_cast<const int*>(tlen),
               B, Lq, Lt, k_band, match, mismatch, n_score, goe, ge, ring,
               static_cast<int2*>(eh),
               static_cast<int*>(score), static_cast<int*>(qend),
               static_cast<int*>(tend)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BANDED_LAUNCH(M, N)                                                 \
  (shared ? launch<M, N, true>(a, smem, st) : launch<M, N, false>(a, smem, st))
  if (mode == SCORE && with_n) return BANDED_LAUNCH(SCORE, true);
  if (mode == SCORE) return BANDED_LAUNCH(SCORE, false);
  if (mode == END && with_n) return BANDED_LAUNCH(END, true);
#undef BANDED_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
