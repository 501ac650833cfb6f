// The NW app's full score matrix (CDP/NW), a tiled anti-diagonal
// wavefront, for Hopper (sm_90a).
//
// Replaces the jnp nw_matrix of genomics_tpu/models/nw.py:51 (jnp, not
// Pallas); the recurrence is the reference's (CDP/NW/main.cu:10-27):
//   M[q][r] = max(M[q-1][r-1] + sub, M[q-1][r] + INSERTION,
//                 M[q][r-1] + DELETION),
//   sub = MATCH (+1) where query[q] == reference[r], else MISMATCH (-1);
//   INSERTION = DELETION = -1;  M[-1][r] = (r+1) DELETION,
//   M[q][-1] = (q+1) INSERTION, and the diagonal at r = 0 is q INSERTION.
// The output is the [N, N] int32 matrix, row q, column r.
//
// Design, the reference's kernels 1-3: the matrix is cut into kTile x
// kTile tiles, and the tiles of one tile diagonal (a + b = d) are
// independent once the diagonals before it are done, so the entry point
// makes one launch per tile diagonal, 2 ceil(N / kTile) - 1 launches, one
// block (one warp) per tile.  A tile's edges come from global memory: the
// row above it and the column left of it, both written by earlier
// launches, or the boundary.  Inside the tile the warp sweeps its own
// anti-diagonals, thread t owning tile row t: at step s it computes column
// s - t from the cells above and above-left (thread t - 1's, in the shared
// tile) and its own cell to the left (a register).  A __syncwarp per step
// orders the shared tile; the finished tile is written row by row, 128
// bytes a row, coalesced.
//
// Bound: the N^2 int32 output written, N^2 4 bytes over 3.35 TB/s (about
// 6 integer operations a cell are below that).  The 2N / kTile launches
// cost several microseconds each at N = 32,768: chip_smoke.py prints the
// launch count beside the kernel time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;   // tile side; one warp a tile
constexpr int kMatch = 1, kMismatch = -1, kInsertion = -1, kDeletion = -1;

__global__ void __launch_bounds__(kTile)
nw_tile_kernel(const uint8_t* __restrict__ ref, const uint8_t* __restrict__ qry,
               int* __restrict__ out, int N, int d, int a_lo) {
  __shared__ int tile[kTile][kTile + 1];
  __shared__ int top[kTile + 1];   // top[0]: (q0-1, r0-1); top[1+c]: (q0-1, r0+c)
  __shared__ int left_edge[kTile]; // (q0+t, r0-1)
  __shared__ uint8_t rseg[kTile];
  const int t = threadIdx.x;
  const int a = a_lo + blockIdx.x;
  const int b = d - a;
  const int q0 = a * kTile, r0 = b * kTile;
  const int q = q0 + t, r = r0 + t;
  const size_t n = static_cast<size_t>(N);

  // the edges: written by earlier launches, or the boundary
  if (q0 == 0)
    top[1 + t] = (r + 1) * kDeletion;
  else
    top[1 + t] = r < N ? out[(q0 - 1) * n + r] : 0;
  if (r0 == 0)
    left_edge[t] = (q + 1) * kInsertion;
  else
    left_edge[t] = q < N ? out[q * n + r0 - 1] : 0;
  if (t == 0) {
    if (r0 == 0)
      top[0] = q0 * kInsertion;
    else if (q0 == 0)
      top[0] = r0 * kDeletion;
    else
      top[0] = out[(q0 - 1) * n + r0 - 1];
  }
  rseg[t] = r < N ? ref[r] : 0;
  const uint8_t qc = q < N ? qry[q] : 0;
  __syncwarp();

  // the tile's anti-diagonals: cells past N compute values no cell of
  // the matrix reads, and are not written
  int left = left_edge[t];
  for (int s = 0; s < 2 * kTile - 1; ++s) {
    const int c = s - t;
    if (c >= 0 && c < kTile) {
      const int up = t == 0 ? top[c + 1] : tile[t - 1][c];
      const int dg = t == 0 ? top[c] : (c == 0 ? left_edge[t - 1]
                                               : tile[t - 1][c - 1]);
      const int sub = rseg[c] == qc ? kMatch : kMismatch;
      const int v = max(max(up + kInsertion, dg + sub), left + kDeletion);
      tile[t][c] = v;
      left = v;
    }
    __syncwarp();
  }

  // write the tile out, one row at a time, thread t at column r0 + t
  if (r < N) {
    for (int k = 0; k < kTile && q0 + k < N; ++k)
      out[(q0 + k) * n + r] = tile[k][t];
  }
}

}  // namespace

extern "C" int nw_app_launch(const void* reference, const void* query,
                             void* out, int N, void* stream) {
  const int nt = (N + kTile - 1) / kTile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int d = 0; d < 2 * nt - 1; ++d) {
    const int a_lo = d - nt + 1 > 0 ? d - nt + 1 : 0;
    const int a_hi = d < nt - 1 ? d : nt - 1;
    nw_tile_kernel<<<a_hi - a_lo + 1, kTile, 0, s>>>(
        static_cast<const uint8_t*>(reference),
        static_cast<const uint8_t*>(query), static_cast<int*>(out), N, d,
        a_lo);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
