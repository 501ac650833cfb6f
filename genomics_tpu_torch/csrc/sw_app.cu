// The SW app's windowed local DP (CDP/SW): each window's rows cut into
// stripes, one block a stripe, sweeping the columns in tiles, for Hopper
// (sm_90a).
//
// Replaces the jnp sw_matrix_batch of genomics_tpu/models/sw.py:24 (jnp,
// not Pallas); the recurrence is the reference's alignKernel
// (CDP/SW/main.cu:117-173) over the full matrix:
//   H[i][j] = max(H[i-1][j-1] + (x[i-1] == win[j-1]), H[i-1][j] - 1,
//                 H[i][j-1] - 1, 0),  row 0 and column 0 zero,
// over every column of the [W, L] windows, padding bytes (0) included, as
// the JAX function treats them.  Outputs: H [W, n+1, L+1] int32 and each
// window's largest cell, best [W] int32, so the host pulls back only the
// winning window's matrix.
//
// Design.  With the up and diagonal terms b[j] = max(H[i-1][j] - 1,
// H[i-1][j-1] + delta, 0) >= 0, the left-gap chain from a tile's left
// edge c0 is
//   H[i][j] = max(max_{c0 <= k <= j}(b[k] + k), H[i][c0-1] + c0 - 1) - j
// (sw.py:40-44's identity with the tile's edge in place of column 0; at
// c0 = 1 the seed is 0, below every b[k] + k).  A window's n rows are cut
// into stripes of kRows rows, one block a stripe, and a block sweeps the
// window's columns in tiles of kTile columns, thread t owning kCols
// consecutive ones.  Each row of a tile is one block-wide max-scan: a
// thread's running max of b[j] + j over its columns, a warp-shuffle scan
// and the warps' totals in shared memory after one barrier (double-
// buffered by the row's parity, so one barrier a row).  A thread keeps
// the row above at its columns in registers; the cell left of its first
// column is its own exclusive prefix minus that column, so no thread
// hands a value to another.  The tile's rows go to a stage in shared
// memory, and the block writes them to H in 16-byte stores at 16-byte
// aligned addresses (scalar stores at each row's ends): the stripe's last
// row first, then, after a barrier, it publishes the tiles done in the
// stripe's progress flag with a release store, then the other rows.  The stripe below waits on that flag with acquire (one
// thread, then a barrier) and reads its row above, the last row of the
// stripe above at the tile's columns and the corner at c0 - 1, from H
// itself: no global scratch.  A row's seed for the next tile, its cell at
// the tile's last column, stays in shared memory.
//
// Forward progress: blocks take stripes from an atomic ticket (flags[0])
// in stripe-major order (stripe s of every window, then stripe s + 1), so
// a stripe's ticket is taken after the ticket of the stripe above it, by
// a running block, and every wait is on a block that runs or is done, for
// any number of resident blocks.  Stripe-major order also keeps every
// window's pipeline going at once.  The grid is at most the card's
// resident blocks.  best: stripe 0 of a window zeroes best[w] before its
// first release, and every block folds its largest cell into it with
// atomicMax after its last tile (all cells are >= 0); every other
// stripe's fold comes after an acquire that chains back to that release.
//
// Bound: H written, W (n+1)(L+1) 4 bytes over 3.35 TB/s (about 10 integer
// operations a cell are below that).  The critical path is a window's
// ceil(L / kTile) + ceil(n / kRows) - 1 tile steps of one block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;           // a block: a stripe
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 2048;             // columns a tile
constexpr int kCols = kTile / kThreads; // columns a thread
constexpr int kRows = 12;               // rows a stripe
static_assert(kTile % kThreads == 0 && kCols >= 1, "whole columns a thread");
static_assert(kRows <= kThreads, "a thread a row writes column 0");

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__global__ void __launch_bounds__(kThreads)
sw_stripe_kernel(const uint8_t* __restrict__ x,
                 const uint8_t* __restrict__ windows, int* __restrict__ H,
                 int* __restrict__ best, int* __restrict__ flags, int n,
                 int W, int L, int stripes) {
  extern __shared__ __align__(16) int stage[];   // [kRows][kTile]
  __shared__ __align__(16) int warp_total[2][kWarps];
  __shared__ int carry[kRows];
  __shared__ int ticket;
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
  const size_t L1 = static_cast<size_t>(L) + 1;
  const int tiles = (L + kTile - 1) / kTile;
  const int total = W * stripes;
  int* progress = flags + 1;
  for (;;) {
    if (t == 0) ticket = atomicAdd(flags, 1);
    __syncthreads();
    const int k = ticket;
    __syncthreads();   // every thread has read the ticket
    if (k >= total) return;
    const int w = k % W, s = k / W;
    const int i0 = s * kRows + 1;                 // the stripe's first row
    const int rows = max(0, min(kRows, n + 1 - i0));
    int* Hw = H + static_cast<size_t>(w) * (n + 1) * L1;
    const uint8_t* win = windows + static_cast<size_t>(w) * L;
    const int* above = Hw + (i0 - 1) * L1;        // the stripe above's last row
    if (s == 0) {
      for (int j = t; j <= L; j += kThreads) Hw[j] = 0;   // row 0
      if (t == 0) best[w] = 0;
    }
    if (t < rows) Hw[(i0 + t) * L1] = 0;          // column 0
    if (t < kRows) carry[t] = 0;                  // H[i][0]: the first seed
    int xr[kRows];
#pragma unroll
    for (int h = 0; h < kRows; ++h) xr[h] = h < rows ? x[i0 + h - 1] : 0;
    int mx = 0;
    for (int c = 0; c < (rows ? tiles : 0); ++c) {
      const int c0 = c * kTile + 1;
      const int j0 = c0 + t * kCols;              // the thread's first column
      if (s > 0 && t == 0)
        while (ld_acquire(progress + k - W) <= c) __nanosleep(64);
      __syncthreads();   // the tile of the stripe above is published
      int up[kCols], wb[kCols];
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        const int j = j0 + q;
        up[q] = s > 0 && j <= L ? __ldcg(above + j) : 0;
        wb[q] = j <= L ? win[j - 1] : 0;
      }
      int dg = s > 0 && j0 > 1 && j0 <= L + 1 ? __ldcg(above + j0 - 1) : 0;
#pragma unroll
      for (int h = 0; h < kRows; ++h) {
        if (h >= rows) break;
        const int seed = carry[h] + c0 - 1;   // H[i][c0 - 1] + c0 - 1
        int inc[kCols];
        int run = 0, d = dg;
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
          const int b = max(max(up[q] - 1, d + (wb[q] == xr[h] ? 1 : 0)), 0);
          d = up[q];
          run = max(run, b + j0 + q);
          inc[q] = run;
        }
        // the max over the threads before this one (every b[j] + j >= 1,
        // so 0 is the scan's identity)
        int incl = run;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int v = __shfl_up_sync(0xffffffffu, incl, off);
          if (lane >= off) incl = max(incl, v);
        }
        const int before = __shfl_up_sync(0xffffffffu, incl, 1);
        if (lane == 31) warp_total[h & 1][wid] = incl;
        __syncthreads();
        int prefix = max(seed, lane == 0 ? 0 : before);
        if constexpr (kWarps % 4 == 0) {   // the warps before this one
          const int4* wt = reinterpret_cast<const int4*>(warp_total[h & 1]);
#pragma unroll
          for (int q = 0; q < kWarps / 4; ++q) {
            const int4 v = wt[q];
            if (4 * q < wid) prefix = max(prefix, v.x);
            if (4 * q + 1 < wid) prefix = max(prefix, v.y);
            if (4 * q + 2 < wid) prefix = max(prefix, v.z);
            if (4 * q + 3 < wid) prefix = max(prefix, v.w);
          }
        } else {
#pragma unroll
          for (int q = 0; q < kWarps; ++q)
            if (q < wid) prefix = max(prefix, warp_total[h & 1][q]);
        }
        int* srow = stage + h * kTile + t * kCols;
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
          const int v = max(inc[q], prefix) - (j0 + q);
          up[q] = v;
          srow[q] = v;
          if (j0 + q <= L) mx = max(mx, v);
        }
        dg = prefix - (j0 - 1);   // H[i][j0 - 1], the next row's diagonal
        if (t == kThreads - 1) carry[h] = up[kCols - 1];   // the next seed
      }
      __syncthreads();   // the tile's rows staged
      // row h's columns c0 .. ce out: 16-byte stores where aligned
      const int ce = min(c0 + kTile - 1, L);
      auto write_row = [&](int h) {
        int* g = Hw + (i0 + h) * L1;
        const int* sr = stage + h * kTile;   // sr[c - c0]: column c
        const int mis = static_cast<int>(
            (reinterpret_cast<uintptr_t>(g + c0) >> 2) & 3);
        const int a = c0 + ((4 - mis) & 3);      // the first aligned column
        const int groups = ce >= a ? (ce - a + 1) / 4 : 0;
        for (int u = t; u < groups; u += kThreads) {
          const int col = a + 4 * u;
          const int* v = sr + (col - c0);
          *reinterpret_cast<int4*>(g + col) = make_int4(v[0], v[1], v[2], v[3]);
        }
        const int e = t < 4 ? c0 + t : a + 4 * groups + t - 4;
        if (t < 8 && e <= ce && (t < 4 ? e < a : true)) g[e] = sr[e - c0];
      };
      // the stripe's last row, the one the stripe below reads, first;
      // published before the other rows go out
      write_row(rows - 1);
      __syncthreads();
      if (t == 0) st_release(progress + k, c + 1);
      for (int h = 0; h + 1 < rows; ++h) write_row(h);
      __syncthreads();   // the stage is free
    }
    // the block's largest cell into best[w]
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane == 0) warp_total[0][wid] = mx;
    __syncthreads();
    if (t == 0) {
      int m = 0;
      for (int q = 0; q < kWarps; ++q) m = max(m, warp_total[0][q]);
      if (m > 0) atomicMax(best + w, m);
    }
  }
}

}  // namespace

// Two launches a call, whatever n and L: the flags' memset and the
// kernel.  `flags` holds W stripes + 1 ints, stripes = max(1, ceil(n /
// kRows)) (n = 0: one stripe a window, which writes row 0 and best): the
// ticket, then each stripe's progress in ticket order.  The grid is the
// card's resident blocks (at most one a stripe), or max_grid where that
// is positive and fewer (for tests of the ticket).
extern "C" int sw_app_launch(const void* x, const void* windows, void* H,
                             void* best, void* flags, int n, int W, int L,
                             int max_grid, void* stream) {
  if (W == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int stripes = max(1, (n + kRows - 1) / kRows);
  const int total = W * stripes;
  cudaError_t err = cudaMemsetAsync(flags, 0, sizeof(int) * (total + 1), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the resident blocks, asked once a device (the first call of a CUDA
  // graph's capture is made before it)
  constexpr int smem = static_cast<int>(sizeof(int)) * kRows * kTile;
  static int resident[64] = {};
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    // set whatever the size: past 48 KB less the static shared memory a
    // launch needs it
    if ((err = cudaFuncSetAttribute(
             sw_stripe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             smem)) != cudaSuccess)
      return static_cast<int>(err);
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, sw_stripe_kernel, kThreads, smem)) != cudaSuccess)
      return static_cast<int>(err);
    resident[dev] = max(1, sms * per_sm);
  }
  int grid = max(1, min(total, resident[dev]));
  if (max_grid > 0) grid = min(grid, max_grid);
  sw_stripe_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(windows),
      static_cast<int*>(H), static_cast<int*>(best), static_cast<int*>(flags),
      n, W, L, stripes);
  return static_cast<int>(cudaGetLastError());
}
