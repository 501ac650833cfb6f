// The SW app's windowed local DP (CDP/SW), one block per window, for
// Hopper (sm_90a).
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
// Design: rows in sequence, each row across the block.  With the up and
// diagonal terms b[j] = max(H[i-1][j] - 1, H[i-1][j-1] + delta, 0) >= 0,
// the left-gap chain is H[i][j] = max_{k <= j}(b[k] + k) - j (the decayed
// zero boundary never wins; sw.py:40-44 uses the same identity), a
// block-wide inclusive max-scan of b[j] + j.  Thread t owns a segment of
// C consecutive columns (C odd, so the threads' strided reads of the row
// in shared memory hit distinct banks): pass 1 takes b[j] + j and its
// running max over the segment in place of the row above (each thread
// first reads the one value of its left neighbour's segment that it
// needs), a warp-shuffle scan and one of the warps' totals give each
// segment the max of the segments before it, pass 2 applies it and
// subtracts j, pass 3 writes the row to H coalesced and folds the max.
// The row (L + 1 int32) and the window's bytes live in shared memory
// while they fit in the wrapper's budget, else the row lives in a [W, L
// + 1] global scratch (L2-resident) and the bytes are read from the
// windows.
//
// Bound: H written, W (n+1)(L+1) 4 bytes over 3.35 TB/s (about 7 integer
// operations a cell are below that).  One block per window: 100 windows
// of the app's default 3 x 1,000 bp fill 100 of 132 SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
sw_app_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ windows,
              int* __restrict__ H, int* __restrict__ best, int* scratch, int n,
              int L, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_total[kWarps];
  const int w = blockIdx.x, t = threadIdx.x;
  const int lane = t & 31, wid = t >> 5;
  const size_t L1 = static_cast<size_t>(L) + 1;
  int* row;
  const uint8_t* win;
  if constexpr (kShared) {
    row = reinterpret_cast<int*>(smem);
    uint8_t* ws = smem + 4 * L1;
    for (int j = t; j < L; j += kThreads) ws[j] = windows[w * static_cast<size_t>(L) + j];
    win = ws;
  } else {
    row = scratch + w * L1;
    win = windows + w * static_cast<size_t>(L);
  }
  int* Hw = H + w * static_cast<size_t>(n + 1) * L1;
  for (int j = t; j <= L; j += kThreads) {
    row[j] = 0;
    Hw[j] = 0;
  }
  const int j0 = t * C + 1;
  const int j1 = min(j0 + C - 1, L);   // empty where j0 > L
  int mx = 0;
  __syncthreads();

  for (int i = 1; i <= n; ++i) {
    const uint8_t xc = x[i - 1];
    int diag = j0 <= L ? row[j0 - 1] : 0;   // H[i-1][j0-1]
    __syncthreads();
    // pass 1: running max of b[j] + j over the segment, in place
    int run = 0;
    for (int j = j0; j <= j1; ++j) {
      const int up = row[j];
      const int b = max(max(up - 1, diag + (win[j - 1] == xc ? 1 : 0)), 0);
      diag = up;
      run = max(run, b + j);
      row[j] = run;
    }
    // the max over the segments before this one (every b[j] + j >= 1,
    // so 0 is the scan's identity)
    int incl = run;
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl = max(incl, v);
    }
    const int before_lane = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 31) warp_total[wid] = incl;
    __syncthreads();
    int prefix = lane == 0 ? 0 : before_lane;
    for (int k = 0; k < wid; ++k) prefix = max(prefix, warp_total[k]);
    // pass 2: H[i][j] = max(the segment's running max, prefix) - j
    for (int j = j0; j <= j1; ++j) row[j] = max(row[j], prefix) - j;
    __syncthreads();
    // pass 3: the row out, coalesced (column 0 stays 0)
    int* Hrow = Hw + i * L1;
    for (int j = t; j <= L; j += kThreads) {
      const int v = row[j];
      Hrow[j] = v;
      mx = max(mx, v);
    }
  }

  // the window's max over the block
  for (int off = 16; off > 0; off >>= 1)
    mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  __syncthreads();
  if (lane == 0) warp_total[wid] = mx;
  __syncthreads();
  if (t == 0) {
    int m = 0;
    for (int k = 0; k < kWarps; ++k) m = max(m, warp_total[k]);
    best[w] = m;
  }
}

}  // namespace

extern "C" int sw_app_launch(const void* x, const void* windows, void* H,
                             void* best, void* scratch, int n, int W, int L,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // columns a thread: ceil(L / kThreads), made odd
  int C = (L + kThreads - 1) / kThreads;
  if (C % 2 == 0) C += 1;
  if (C < 1) C = 1;
  const uint8_t* xp = static_cast<const uint8_t*>(x);
  const uint8_t* wp = static_cast<const uint8_t*>(windows);
  if (scratch == nullptr) {
    const int bytes = 4 * (L + 1) + L;
    cudaError_t err = cudaFuncSetAttribute(
        sw_app_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    sw_app_kernel<true><<<W, kThreads, bytes, s>>>(
        xp, wp, static_cast<int*>(H), static_cast<int*>(best), nullptr, n, L,
        C);
  } else {
    sw_app_kernel<false><<<W, kThreads, 0, s>>>(
        xp, wp, static_cast<int*>(H), static_cast<int*>(best),
        static_cast<int*>(scratch), n, L, C);
  }
  return static_cast<int>(cudaGetLastError());
}
