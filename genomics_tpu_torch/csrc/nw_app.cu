// The NW app's full score matrix (CDP/NW): stripes of rows, one warp a
// stripe, each stripe waiting on the one above through a progress flag,
// for Hopper (sm_90a).
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
// Design.  The rows are cut into stripes of kStripe = 32 kRows rows, and
// one warp computes a stripe from column 0 to column N - 1: lane t owns
// the stripe's rows t kRows .. t kRows + kRows - 1 and computes column
// s - t at step s, its kRows cells top to bottom, their left cells and
// query bytes in registers.  The cell above its first row and that
// column's reference byte come, packed into one word, from lane t - 1's
// last row at step s - 1 (__shfl_up_sync); lane 0 takes them from the
// stripe above's last row, which that stripe has written to the output,
// loaded 32 columns at a time, kLead steps before their use.  Each lane
// stages its cells in a shared ring of kRing columns; once lane 31 has
// finished a chunk of kChunk columns, the warp writes the chunk's rows
// out as whole row segments (kChunk consecutive words of a row, 128 bytes
// at kChunk = 32, in 16-byte stores where N is a multiple of 4) and
// lane 0 publishes the columns done in the stripe's progress flag with a
// release store (after __syncwarp, so ordered after the warp's stores).
// Lane 0 of the stripe below reads the flag with acquire semantics and
// waits on it before the warp loads the next 32 columns of the row above.
// So a call is one kernel launch and one memset of the flags, whatever N.
// A warp runs its steps in blocks of 32, fully unrolled wherever every
// lane's column lies in [1, N): there the range tests, the shuffle's
// source lane and the chunk's end are constants, which took a step from
// about 360 to about 205 cycles on an H100 (PERF.md).
//
// Forward progress: warps take stripes from an atomic ticket (flags[0]),
// not from blockIdx, and a warp that finishes its stripe takes the next
// ticket.  A stripe's ticket is taken only by a running warp after the
// ticket of the stripe above it, so every wait is on a warp that is
// running or done, for any N and any number of resident warps.  The grid
// is at most the card's resident blocks.
//
// Bound: the N^2 int32 output written, N^2 4 bytes over 3.35 TB/s (about
// 7 integer operations a cell are below that); the row above each stripe
// is read again, 1 / kStripe of the output.  The pipeline's depth adds
// (N / kStripe) times the lag of one stripe behind the one above (its 31
// lanes' skew, a chunk, and the row above's columns loaded ahead) to the
// N steps of one stripe.  Packing holds |M| < 2^23: N up to 4,194,303.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kRows = 4;                // rows a lane
constexpr int kStripe = 32 * kRows;     // rows a stripe (a warp)
constexpr int kChunk = 32;              // columns a write-out and a flag
constexpr int kRing = 64;               // columns of the shared ring
constexpr int kLead = 4;                // steps from a load above to its use
constexpr int kMatch = 1, kMismatch = -1, kInsertion = -1, kDeletion = -1;
static_assert(kChunk % 4 == 0 && 32 % kChunk == 0 && kRing >= kChunk + 31 &&
              (kRing & (kRing - 1)) == 0, "ring must hold a chunk + skew");
static_assert(kLead >= 1 && kLead <= 32, "the row above: 32 columns a load");

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

// a cell's score and a reference byte in one word
__device__ __forceinline__ int pack(int m, int byte) {
  return static_cast<int>(static_cast<unsigned>(m) << 8) | byte;
}

__global__ void __launch_bounds__(32)
nw_stripe_kernel(const uint8_t* __restrict__ ref,
                 const uint8_t* __restrict__ qry, int* __restrict__ out,
                 int* __restrict__ flags, int N, int stripes) {
  extern __shared__ int ring[];   // [kStripe][kRing]
  const int t = threadIdx.x;
  const size_t n = static_cast<size_t>(N);
  int* progress = flags + 1;
  const int steps = N + 31;   // lane 31 finishes column N - 1 at N + 30
  for (;;) {
    int k = 0;
    if (t == 0) k = atomicAdd(flags, 1);
    k = __shfl_sync(0xffffffffu, k, 0);
    if (k >= stripes) return;
    const int q0 = k * kStripe;
    const int qt = q0 + t * kRows;
    int qc[kRows], left[kRows];
#pragma unroll
    for (int h = 0; h < kRows; ++h) {
      qc[h] = qt + h < N ? qry[qt + h] : 0;
      left[h] = 0;
    }
    // the row above the stripe, column c < N: the boundary, or the stripe
    // above's last row once its flag covers c
    int seen = 0;
    auto wait_for = [&](int cols) {
      if (k > 0 && t == 0) {
        while (seen < cols) {
          seen = ld_acquire(progress + k - 1);
          if (seen < cols) __nanosleep(64);
        }
      }
      __syncwarp();
    };
    auto above = [&](int c) {
      const int m = q0 == 0 ? (c + 1) * kDeletion
                            : __ldcg(out + (q0 - 1) * n + c);
      return pack(m, ref[c]);
    };
    wait_for(min(32, N));
    int cur = t < N ? above(t) : 0, nxt = 0;
    int carry = 0, diag = 0;
    // step s (u: s & 31); `steady`: every lane's column in [1, N) and a
    // chunk ends only where u + 2 is a multiple of kChunk, so the range
    // tests fold away in the blocks of 32 steps that unroll it
    auto step = [&](const int s, const int u, auto steady_type) {
      constexpr bool steady = decltype(steady_type)::value;
      if (u == 0 && s) cur = nxt;
      // kLead steps ahead: the next 32 columns of the row above
      if (u == 32 - kLead && s + kLead < N) {
        wait_for(min(s + kLead + 32, N));
        nxt = s + kLead + t < N ? above(s + kLead + t) : 0;
      }
      const int from_above = __shfl_sync(0xffffffffu, cur, u);
      const int from_lane = __shfl_up_sync(0xffffffffu, carry, 1);
      const int in = t == 0 ? from_above : from_lane;
      const int j = s - t;
      if (steady || (j >= 0 && j < N)) {
        const int up0 = in >> 8, rc = in & 255;
        if (!steady && j == 0) {
          diag = qt * kInsertion;
#pragma unroll
          for (int h = 0; h < kRows; ++h) left[h] = (qt + h + 1) * kInsertion;
        }
        int d = diag, up = up0;
        int* col = ring + t * kRows * kRing + (j & (kRing - 1));
#pragma unroll
        for (int h = 0; h < kRows; ++h) {
          const int sub = rc == qc[h] ? kMatch : kMismatch;
          const int v = max(max(d + sub, left[h] + kDeletion),
                            up + kInsertion);
          d = left[h];
          left[h] = v;
          up = v;
          col[h * kRing] = v;
        }
        diag = up0;
        carry = pack(up, rc);
      }
      // lane 31 has finished column `done`: write out its chunk once whole
      const int done = s - 31;
      if (steady ? (u + 2) % kChunk == 0
                 : done >= 0 && done < N &&
                       ((done + 1) % kChunk == 0 || done == N - 1)) {
        __syncwarp();
        const int c0 = done - done % kChunk, w = done + 1 - c0;
        if (w == kChunk && N % 4 == 0) {
          // a whole chunk: 16-byte stores, kChunk / 4 lanes a row
          constexpr int kLanes = kChunk / 4;
          const int c = c0 + 4 * (t % kLanes);
          for (int r = t / kLanes; r < kStripe && q0 + r < N;
               r += 32 / kLanes)
            *reinterpret_cast<int4*>(out + (q0 + r) * n + c) =
                *reinterpret_cast<const int4*>(ring + r * kRing +
                                               (c & (kRing - 1)));
        } else if (t % kChunk < w) {
          const int c = c0 + t % kChunk;
          for (int r = t / kChunk; r < kStripe && q0 + r < N;
               r += 32 / kChunk)
            out[(q0 + r) * n + c] = ring[r * kRing + (c & (kRing - 1))];
        }
        // the warp's stores, then the flag (release: ordered after them)
        __syncwarp();
        if (t == 0) st_release(progress + k, done + 1);
      }
    };
    for (int s = 0; s < steps;) {
      if ((s & 31) == 0 && s >= 32 && s + 32 <= N) {
#pragma unroll
        for (int u = 0; u < 32; ++u)
          step(s + u, u, std::true_type{});
        s += 32;
      } else {
        step(s, s & 31, std::false_type{});
        ++s;
      }
    }
  }
}

}  // namespace

// Two launches a call, whatever N: the flags' memset and the kernel.
// `flags` holds stripes + 1 ints: the ticket, then each stripe's progress.
// The grid is the card's resident blocks (at most one a stripe), or
// max_grid where that is positive and fewer (for tests of the ticket).
extern "C" int nw_app_launch(const void* reference, const void* query,
                             void* out, void* flags, int N, int max_grid,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int stripes = (N + kStripe - 1) / kStripe;
  cudaError_t err = cudaMemsetAsync(flags, 0, sizeof(int) * (stripes + 1), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the resident blocks, asked once a device (the first call of a CUDA
  // graph's capture is made before it)
  constexpr int smem = static_cast<int>(sizeof(int)) * kStripe * kRing;
  static int resident[64] = {};
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (smem > 48 * 1024 &&
        (err = cudaFuncSetAttribute(
             nw_stripe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             smem)) != cudaSuccess)
      return static_cast<int>(err);
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, nw_stripe_kernel, 32, smem)) != cudaSuccess)
      return static_cast<int>(err);
    resident[dev] = max(1, sms * per_sm);
  }
  int grid = max(1, min(stripes, resident[dev]));
  if (max_grid > 0) grid = min(grid, max_grid);
  nw_stripe_kernel<<<grid, 32, smem, s>>>(
      static_cast<const uint8_t*>(reference),
      static_cast<const uint8_t*>(query), static_cast<int*>(out),
      static_cast<int*>(flags), N, stripes);
  return static_cast<int>(cudaGetLastError());
}
