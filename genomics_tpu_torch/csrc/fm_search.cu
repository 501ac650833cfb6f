// Batched exact FM-index backward search, one thread per query, for Hopper
// (sm_90a).
//
// Replaces _bs_jit of genomics_tpu/ops/fm_search.py:121 with its device
// rank _rank (:93), which jnp runs on the TPU (no Pallas kernel): the
// mapper's fmdev seeder sends every fixed-interval seed of every read and
// strand through it in one launch.  For each query, from its last symbol
// back, L steps of
//   lo, hi <- C[s + 1] + occ(s, lo), C[s + 1] + occ(s, hi)
// with s = the query's code & 3 at k = qlen - 1 - t (clipped to L - 1),
// while k >= 0 and hi > lo; a query whose range empties, or whose qlen is
// spent, keeps its lo and hi.  Starting range (0, n).
//
// The index (`ops/fm_search.build_device_index`): the BWT as two bit-planes
// p0 / p1 of W = ceil(n / 32) uint32 words (bit b of word w is the low /
// high bit of the 2-bit code at position 32w + b), occurrence checkpoints
// ckpt [4, NB] int32 every 128 positions, C [6] int32, and the sentinel's
// row `primary`, stored as 'A' in the planes and counted in no checkpoint.
// occ(s, i) = ckpt[s][i / 128] + the popcount of the positions of block
// i / 128 below i whose code is s (4 words, each masked to the positions
// below i), minus one for 'A' where the sentinel lies in the block below i.
// A word that starts at or past position i adds nothing and is not read,
// so the last block's words past W - 1 (i = n, n not a multiple of 128)
// are never touched.
//
// Bound: integer work.  Per active step, two ranks; a rank at i reads the
// ceil((i mod 128) / 32) words of its block that start below i (0 to 4;
// none for lo = 0, every query's first step).  Per word a three-input
// function for the plane match, the mask (a subtract, a shift and a
// clamp), the AND and the popcount, and the add (7); per rank the block
// index, the checkpoint's address and the sentinel's test (5); per step
// the two tests of the loop, the code's address, its mask and the two adds
// of C (6): words x 7 + ranks x 5 + steps x 6, counted by
// ops/fm_search.backward_search_plain(stats=) and chip_smoke.py's
// FM_OPS_PER_WORD / _RANK / _STEP.  The planes of a 12 Mbp genome (3 MB)
// and its checkpoints (0.4 MB) stay in the 50 MB L2, so the bytes the
// launch must move from device memory are the queries, qlen and the
// results.  A step's two ranks touch the checkpoint words of two blocks
// and two 16-byte runs of plane words in each plane, 2-6 sectors of 32
// bytes, all read through __ldg; lo and hi of one query fall in one block
// once the range has narrowed to under 128 rows, so their sectors are
// shared from then on.  This is the simple design: one thread a query with
// its loads in series, dependent from step to step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;            // queries a block
constexpr int kRate = 128;               // positions a checkpoint block
constexpr int kWords = kRate / 32;       // plane words a block

// occ(s, i): occurrences of code s (0-3) among BWT positions [0, i).
__device__ __forceinline__ int occ(const uint32_t* __restrict__ p0,
                                   const uint32_t* __restrict__ p1, int W,
                                   const int* __restrict__ ckpt, int NB,
                                   int primary, int s, int i) {
  const int k = i / kRate;
  int cnt = __ldg(ckpt + s * NB + k);
  const uint32_t f0 = (s & 1) ? 0u : 0xFFFFFFFFu;
  const uint32_t f1 = (s & 2) ? 0u : 0xFFFFFFFFu;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    const int w = k * kWords + j;
    const int rem = i - w * 32;
    if (rem <= 0 || w >= W) break;
    const uint32_t eq = (__ldg(p0 + w) ^ f0) & (__ldg(p1 + w) ^ f1);
    const uint32_t m = rem >= 32 ? 0xFFFFFFFFu : (1u << rem) - 1u;
    cnt += __popc(eq & m);
  }
  if (s == 0 && primary >= k * kRate && primary < i) --cnt;
  return cnt;
}

__global__ void __launch_bounds__(kThreads)
fm_search_kernel(const uint32_t* __restrict__ p0,
                 const uint32_t* __restrict__ p1, int W,
                 const int* __restrict__ ckpt, int NB,
                 const int* __restrict__ C, int primary, int n,
                 const uint8_t* __restrict__ queries, int L, long long qs,
                 const int* __restrict__ qlen, int S, int* __restrict__ lo_out,
                 int* __restrict__ hi_out) {
  const int q = blockIdx.x * kThreads + threadIdx.x;
  if (q >= S) return;
  const uint8_t* row = queries + static_cast<long long>(q) * qs;
  const int ql = qlen[q];
  int lo = 0, hi = n;
  for (int t = 0; t < L; ++t) {
    const int k = ql - 1 - t;
    if (k < 0 || hi <= lo) break;
    const int s = row[min(k, L - 1)] & 3;
    const int c = __ldg(C + s + 1);
    lo = c + occ(p0, p1, W, ckpt, NB, primary, s, lo);
    hi = c + occ(p0, p1, W, ckpt, NB, primary, s, hi);
  }
  lo_out[q] = lo;
  hi_out[q] = hi;
}

}  // namespace

// p0 / p1: [W] uint32 bit-planes; ckpt: [4, NB] int32; C: [6] int32;
// primary: the sentinel's row; n: BWT length (text + sentinel); queries:
// [S, L] uint8 codes (only the low 2 bits are read), row q at queries + q
// * qs bytes; qlen: [S] int32; lo / hi: [S] int32 SA ranges (hi <= lo: no
// match).  S must be at least 1.  Launches on `stream` without
// synchronising; returns cudaGetLastError().
extern "C" int fm_search_launch(const void* p0, const void* p1, int W,
                                const void* ckpt, int NB, const void* C,
                                int primary, int n, const void* queries,
                                int L, long long qs, const void* qlen, int S,
                                void* lo, void* hi, void* stream) {
  if (S < 1 || L < 0 || W < 1 || NB < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((S + kThreads - 1) / kThreads);
  fm_search_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(p0), static_cast<const uint32_t*>(p1), W,
      static_cast<const int*>(ckpt), NB, static_cast<const int*>(C), primary,
      n, static_cast<const uint8_t*>(queries), L, qs,
      static_cast<const int*>(qlen), S, static_cast<int*>(lo),
      static_cast<int*>(hi));
  return static_cast<int>(cudaGetLastError());
}
