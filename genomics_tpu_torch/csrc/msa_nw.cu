// Center-star MSA's pairwise NW (CDP/STAR): the affine fill of every
// (center, sequence) pair and its backtrack to gap counts, one thread a
// pair, for Hopper (sm_90a).
//
// Fill: replaces the jnp nw_matrices_batch of genomics_tpu/models/msa.py:103
// (jnp, not Pallas), the reference's cuda_nw_3d (CDP/STAR/cuda-nw.cu:117-187)
// on nw.cc:25-94's recurrence, MATCH 0 / MISMATCH -1 or a score table,
// GAP_START 0, GAP_EXTEND -1 (GSE = GAP_START + GAP_EXTEND):
//   Y[i][j] = max(GSE + M[i-1][j], GAP_EXTEND + Y[i-1][j])
//   X[i][j] = max(GSE + M[i][j-1], GAP_EXTEND + X[i][j-1])
//   M[i][j] = max(M[i-1][j-1] + s(center[i-1], seq[j-1]), X[i][j], Y[i][j])
// with msa.py:114-156's MIN_SCORE (-32700) boundaries: M row 0 is 0 at
// j = 0 and MIN_SCORE elsewhere, M column 0 is MIN_SCORE for i >= 1, Y row
// 0 is MIN_SCORE and X[i][0] is MIN_SCORE (Y's column 0 is never read).
// The JAX function's x-chain as a prefix scan is this recurrence
// rewritten (GSE <= GAP_EXTEND lets M's x-term absorb), so the values are
// equal.  Each thread fills its pair only to the pair's own length; the
// cells past it are never read.  The matrices are laid out pair-innermost,
// M [m+1][n_pad+1][B], so a warp's 32 stores at one (i, j) are one 128-byte
// line (the reference's per-thread pitched slab makes each store its own
// sector); the Y row lives in an [n_pad+1][B] scratch laid out the same way,
// L2-resident.  Loads of the row above, Y and the sequence's bytes run
// kAhead columns ahead of the cells that use them.
//
// Scores: DNA compares the bytes.  With a table, the wrapper maps the
// bytes that occur in the call (every one, padding and bytes the matrix
// does not name included: those score 0) to a compact alphabet of A codes
// and hands over the [A, A] table, which both kernels read through __ldg:
// a protein call's 21 to 25 codes, the pad's included, take at most 2.5
// KB, which stays in the SM's read-only cache, and any A up to 256 takes
// the same path.  The
// full [256, 256] table is 256 KB, more than a block's shared memory, and
// a lookup of it through the cache would pull a sector for each of a
// warp's scattered (center, sequence) byte pairs.
//
// Backtrack: replaces the jnp backtrack_batch of msa.py:160, the
// reference's cuda_backtrack_3d (cuda-nw.cu:219-249) on nw.cc:96-150: from
// (m, slen) each step takes the diagonal where s + M[i-1][j-1] == M[i][j],
// else the least k = 1, 2, ... of a vertical run (M[i-k][j] + GAP_START +
// k GAP_EXTEND == M[i][j], tested first) or a horizontal one, adding k to
// so[j] (vertical) or space[i] (horizontal).  The first hit in that order is
// the JAX kv <= kh rule.  It reads the matrices in place (no transposed
// copy, msa.py:178-179); a walk that finds no run at any k stops (no
// matrix of the fill leads there).
//
// Bounds: the fill writes the pairs' own cells, sum over pairs of (m+1)
// (slen+1) 4 bytes, over 3.35 TB/s (its 11 integer operations a cell over
// the INT32 peak are below that); the backtrack is a chain of dependent
// scattered reads, one 32-byte sector a word, so its floor is the words
// read over 3.35 TB/s at 32 bytes each.  One thread a pair in 32-thread
// blocks spreads the pairs over the SMs: 1,024 pairs fill 32 of 132 SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMatch = 0, kMismatch = -1;
constexpr int kGapStart = 0, kGapExtend = -1;
constexpr int kGSE = kGapStart + kGapExtend;
constexpr int kMinScore = -32700;
constexpr int kThreads = 32;   // pairs a block
constexpr int kAhead = 8;      // columns loaded ahead

template <bool kTable>
__global__ void __launch_bounds__(kThreads)
msa_fill_kernel(const uint8_t* __restrict__ center,
                const uint8_t* __restrict__ seqs,   // [n_pad][B]
                const int* __restrict__ slens, const int* __restrict__ table,
                int A, int* __restrict__ M, int* __restrict__ Y, int m,
                int n_pad, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int n = slens[b];
  const size_t sB = static_cast<size_t>(B);
  const size_t rs = static_cast<size_t>(n_pad + 1) * sB;
  int* Mb = M + b;
  int* Yb = Y + b;
  const uint8_t* sb = seqs + b;

  Mb[0] = 0;
  for (int j = 1; j <= n; ++j) {
    Mb[j * sB] = kMinScore;
    Yb[j * sB] = kMinScore;
  }
  for (int i = 1; i <= m; ++i) {
    const int ci = center[i - 1];
    const int* trow = kTable ? table + ci * A : nullptr;
    const int* up = Mb + (i - 1) * rs;
    int* cur = Mb + i * rs;
    int diag = up[0];
    int left = kMinScore;
    int x = kMinScore;
    cur[0] = kMinScore;
    int nu[kAhead], ny[kAhead];
    uint8_t ns[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int j = 1 + k;
      if (j <= n) {
        nu[k] = up[j * sB];
        ny[k] = Yb[j * sB];
        ns[k] = sb[(j - 1) * sB];
      }
    }
    for (int jb = 1; jb <= n; jb += kAhead) {
      int cu[kAhead], cy[kAhead];
      uint8_t cs[kAhead];
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        cu[k] = nu[k];
        cy[k] = ny[k];
        cs[k] = ns[k];
      }
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        const int j = jb + kAhead + k;
        if (j <= n) {
          nu[k] = up[j * sB];
          ny[k] = Yb[j * sB];
          ns[k] = sb[(j - 1) * sB];
        }
      }
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        const int j = jb + k;
        if (j <= n) {
          const int y = max(kGSE + cu[k], kGapExtend + cy[k]);
          x = max(kGSE + left, kGapExtend + x);
          const int s = kTable ? __ldg(trow + cs[k])
                               : (cs[k] == ci ? kMatch : kMismatch);
          const int v = max(max(diag + s, y), x);
          cur[j * sB] = v;
          Yb[j * sB] = y;
          diag = cu[k];
          left = v;
        }
      }
    }
  }
}

template <bool kTable>
__global__ void __launch_bounds__(kThreads)
msa_backtrack_kernel(const int* __restrict__ M,
                     const uint8_t* __restrict__ center,
                     const uint8_t* __restrict__ seqs,   // [n_pad][B]
                     const int* __restrict__ slens,
                     const int* __restrict__ table, int A,
                     int* __restrict__ space, int* __restrict__ so, int m,
                     int n_pad, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = static_cast<size_t>(B);
  const size_t rs = static_cast<size_t>(n_pad + 1) * sB;
  const int* Mb = M + b;
  int* sp = space + b * static_cast<size_t>(m + 1);
  int* sob = so + b * static_cast<size_t>(n_pad + 1);
  int i = m, j = slens[b];
  int cur = Mb[i * rs + j * sB];
  while (i != 0 || j != 0) {
    if (i > 0 && j > 0) {
      const int ci = center[i - 1];
      const int sj = seqs[(j - 1) * sB + b];
      const int s = kTable ? __ldg(table + ci * A + sj)
                           : (ci == sj ? kMatch : kMismatch);
      const int d = Mb[(i - 1) * rs + (j - 1) * sB];
      if (s + d == cur) {
        --i;
        --j;
        cur = d;
        continue;
      }
    }
    const int kmax = max(i, j);
    bool moved = false;
    for (int k = 1; k <= kmax; ++k) {
      const int run = kGapStart + kGapExtend * k;
      if (i >= k) {
        const int v = Mb[(i - k) * rs + j * sB];
        if (v + run == cur) {
          sob[j] += k;
          i -= k;
          cur = v;
          moved = true;
          break;
        }
      }
      if (j >= k) {
        const int h = Mb[i * rs + (j - k) * sB];
        if (h + run == cur) {
          sp[i] += k;
          j -= k;
          cur = h;
          moved = true;
          break;
        }
      }
    }
    if (!moved) break;
  }
}

}  // namespace

extern "C" int msa_nw_launch(const void* center, const void* seqs,
                             const void* slens, const void* table, int A,
                             void* M, void* Y, int m, int n_pad, int B,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (B + kThreads - 1) / kThreads;
  const uint8_t* c = static_cast<const uint8_t*>(center);
  const uint8_t* q = static_cast<const uint8_t*>(seqs);
  const int* sl = static_cast<const int*>(slens);
  int* Mp = static_cast<int*>(M);
  int* Yp = static_cast<int*>(Y);
  if (table == nullptr)
    msa_fill_kernel<false><<<blocks, kThreads, 0, s>>>(
        c, q, sl, nullptr, 0, Mp, Yp, m, n_pad, B);
  else
    msa_fill_kernel<true><<<blocks, kThreads, 0, s>>>(
        c, q, sl, static_cast<const int*>(table), A, Mp, Yp, m, n_pad, B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int msa_nw_backtrack_launch(const void* M, const void* center,
                                       const void* seqs, const void* slens,
                                       const void* table, int A, void* space,
                                       void* so, int m, int n_pad, int B,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (B + kThreads - 1) / kThreads;
  const int* Mp = static_cast<const int*>(M);
  const uint8_t* c = static_cast<const uint8_t*>(center);
  const uint8_t* q = static_cast<const uint8_t*>(seqs);
  const int* sl = static_cast<const int*>(slens);
  int* sp = static_cast<int*>(space);
  int* sop = static_cast<int*>(so);
  if (table == nullptr)
    msa_backtrack_kernel<false><<<blocks, kThreads, 0, s>>>(
        Mp, c, q, sl, nullptr, 0, sp, sop, m, n_pad, B);
  else
    msa_backtrack_kernel<true><<<blocks, kThreads, 0, s>>>(
        Mp, c, q, sl, static_cast<const int*>(table), A, sp, sop, m, n_pad,
        B);
  return static_cast<int>(cudaGetLastError());
}
