// Traceback walk over the DP kernels' direction nibbles, straight to
// byte-CIGARs, one thread per alignment, for Hopper (sm_90a).
//
// Replaces genomics_tpu/ops/tb_walk.py tb_walk_device (:29), a jnp walk
// (no Pallas kernel) that runs every lane in lockstep and gathers one word
// per lane per step, and the host decoder native/cigar.cpp decode_one
// (:32-129) that the JAX engine runs after it.  Each thread runs
// decode_one's state machine (the transcription of GASAL2's get_tb.h:
// 5-149) for its own alignment: op_select/op_shift gap-chain tracking, X/M
// from the substitution bit, and in LOCAL mode the score stop.  It starts
// at the caller's cell (tend, qend) — for GLOBAL one cell past the end,
// (tlen, qlen), a reference quirk — and reads the sqb cube [Lt/8, Lq, B]
// that local_sw.cu, global_sw.cu and semiglobal_sw.cu write in TB mode (a
// cell outside the cube reads 0, an M).  GLOBAL and SEMI_GLOBAL walk
// alike: no score stop, down to row or column -1.
//
// Output, pair-major: the walk's runs as decode_one's bytes op | run << 2
// (0=M 1=X 2=D 3=I, a run split at 63: 63, 63, ..., the rest), then for
// GLOBAL, and for SEMI_GLOBAL where that HEAD is not skipped, the leading D
// pad of i + 1 rows and the I pad of j + 1 columns, split the same way;
// n_ops; and the starts (LOCAL: the final (j, i); GLOBAL: 0; SEMI_GLOBAL:
// 0 under a pad, else max(final + 1, 0)).  A thread packs its bytes four
// to a 32-bit store; the bytes of a row past n_ops, but for the rest of
// its last word, are not written.  The walk is capped at T = Lq + Lt
// steps, which hold every walk the engines start (a walk that starts
// outside the cube moves diagonally until it is inside; from inside,
// (i, j) takes at most i + j + 1 steps), so a row needs at most T bytes of
// runs and two pads of (max(Lq, Lt) + 1) / 63 + 1 bytes.
//
// Bound: a chain of dependent loads.  Each step reads one int32 at an
// address the step before decides, in a cube far larger than L2 with B
// innermost, so each word read pulls a 32-byte sector for 4 useful bytes.
// The first design waited one trip to memory a step.  This one keeps a
// window of the cube's words: the words of columns j .. j - K + 1 (K =
// kWindow) in word rows i >> 3 and (i >> 3) - 1, loaded together as up to
// 2K independent loads, enough for a diagonal run of K steps, a D run down
// to the row below and an I run of K columns; the walk refills the window
// where it leaves it.  The window sits in shared memory, each thread's own
// slots (thread innermost, so a warp's reads never conflict), and a step
// reads its word by the column and row it stands in: one copy of the step
// serves every column.  tools/kernel_variants.py --kernels tb_walk times
// the alternatives (PERF.md section 6): K of 4 and 16; only each column's
// diagonal word (kDiagonal), which refills at every indel; windows sized
// by the last one's use (kAdaptive); the window in registers, the columns
// unrolled (tools/tb_walk_registers.cu); G lanes a pair that share a
// window by shuffles (tools/tb_walk_lanes.cu); pairs after the first
// taken from a counter (both tools sources), which changes nothing where
// every walk of a launch is resident at once.  This design won at the
// engine's launches.  Where most walks are full of gaps (bench.py's
// unrelated random pairs under GLOBAL), a window loads words the walk
// never reads, the walk is bound by those sectors, and the first design's
// one word a step is faster.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWindow = 8;          // K: columns a window holds
constexpr bool kDiagonal = false;   // load only each column's diagonal word
constexpr bool kAdaptive = false;   // size each window by the last one's use

struct Args {
  const int* tb;      // [Lt/8, Lq, B]
  const int* score;   // [B] (LOCAL)
  const int* qend;    // [B] start column
  const int* tend;    // [B] start row
  int B, Lq, Lt8, width;
  int local, pad_d, pad_i;
  int match, mismatch, goe, ge;
  uint8_t* cigars;    // [B, width], width % 4 == 0
  int* n_ops;         // [B]
  int* qstart;        // [B]
  int* tstart;        // [B]
};

// A pair's row of cigars, filled four bytes to a store.  Bytes past the
// row's `cap` words are counted and not written, as decode_one counts past
// its max_ops: only a start past max(Lq, Lt) makes any.
struct Row {
  uint32_t* words;
  int cap;
  uint32_t acc = 0;
  int n = 0;

  __device__ __forceinline__ void put(uint32_t byte) {
    acc |= byte << (8 * (n & 3));
    if ((++n & 3) == 0) {
      if ((n >> 2) <= cap) words[(n >> 2) - 1] = acc;
      acc = 0;
    }
  }
  __device__ __forceinline__ void pad(int op, int len) {
    for (; len > 0; len -= 63) put(op | min(len, 63) << 2);
  }
  __device__ __forceinline__ void flush() {
    if ((n & 3) && (n >> 2) < cap) words[n >> 2] = acc;
  }
};

template <int K, bool DIAG, bool ADAPT>
__device__ __forceinline__ void walk_pair(const Args& a, int b,
                                          uint32_t (*win)[kThreads]) {
  const int t = threadIdx.x;
  const size_t sB = static_cast<size_t>(a.B);
  const size_t plane = static_cast<size_t>(a.Lq) * sB;
  const int T = a.Lq + a.Lt8 * 8;
  const int total = a.local ? a.score[b] : 0;
  int i = a.tend[b], j = a.qend[b];
  int op_shift = 0, op_select = 3, curr = 0;
  int prev = 0, run = 0;   // the last step's op, and the open run's length
  int steps = 0;
  Row row{reinterpret_cast<uint32_t*>(a.cigars + static_cast<size_t>(b) *
                                                     a.width), a.width / 4};
  bool active = i >= 0 && j >= 0;
  int n = K;   // columns the next window loads
  while (active) {
    // the window: columns j0 .. j0 - n + 1 in word rows r0 and r0 - 1 at
    // slots 2k and 2k + 1 (DIAG: the word row of the diagonal cell (i0 - k,
    // j0 - k) alone, at slot k)
    const int i0 = i, r0 = i >> 3, j0 = j;
    uint32_t w0[K], w1[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int jj = j0 - k;
      const bool col = k < n && jj >= 0 && jj < a.Lq;
      const int ra = DIAG ? (i0 - k) >> 3 : r0;
      const int* at = a.tb + static_cast<size_t>(col ? jj : 0) * sB + b;
      w0[k] = (col && ra >= 0 && ra < a.Lt8)
                  ? static_cast<uint32_t>(__ldg(at + ra * plane)) : 0u;
      if (!DIAG)
        w1[k] = (col && r0 >= 1 && r0 - 1 < a.Lt8)
                    ? static_cast<uint32_t>(__ldg(at + (r0 - 1) * plane))
                    : 0u;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (DIAG) {
        win[k][t] = w0[k];
      } else {
        win[2 * k][t] = w0[k];
        win[2 * k + 1][t] = w1[k];
      }
    }
    // the walk, in column j0 - k, until it leaves the window: a D stays
    // in its column, anything else moves to the next
    while (active) {
      const int k = j0 - j;
      if (k == n) break;
      uint32_t word;
      if (DIAG) {
        if ((i >> 3) != ((i0 - k) >> 3)) break;
        word = win[k][t];
      } else {
        const int rr = r0 - (i >> 3);
        if (rr > 1) break;
        word = win[2 * k + rr][t];
      }
      const int cell = (word >> (4 * (i & 7))) & 0xF;
      const int op = (cell >> op_shift) & op_select;
      const int fill = (op == 0 || op_select == 3) ? op : op_shift;
      const bool reset = op == 0 || (op == 1 && op_select == 3);
      const bool to_gap = op >= 2 && op_select == 3;
      op_shift = reset ? 0 : (to_gap ? op : op_shift);
      op_select = reset ? 3 : 1;
      if (fill == prev && run < 63) {
        ++run;
      } else {
        if (run) row.put(prev | run << 2);
        run = 1;
      }
      ++steps;
      if (a.local) {
        // local score reconstruction (decode_one:80-93); the stop leaves
        // i/j AT the stop cell
        curr += fill >= 2 ? (prev != fill ? -a.goe : -a.ge)
                          : (fill == 1 ? -a.mismatch : a.match);
        if (curr == total) {
          prev = fill;
          active = false;
          break;
        }
      }
      prev = fill;
      i -= fill != 3;
      j -= fill != 2;
      active = i >= 0 && j >= 0 && steps < T;
    }
    // a window used up doubles the next; one left early shrinks it to
    // twice the columns the walk went through
    if (ADAPT) n = min(K, max(1, 2 * (j0 - j)));
  }
  if (run) row.put(prev | run << 2);
  if (!a.local) {
    if (a.pad_d) row.pad(2, i + 1);
    if (a.pad_i) row.pad(3, j + 1);
  }
  row.flush();
  a.n_ops[b] = row.n;
  a.qstart[b] = a.local ? j : (a.pad_i ? 0 : max(j + 1, 0));
  a.tstart[b] = a.local ? i : (a.pad_d ? 0 : max(i + 1, 0));
}

template <int K, bool DIAG, bool ADAPT>
__global__ void __launch_bounds__(kThreads) tb_walk_kernel(const Args a) {
  __shared__ uint32_t win[DIAG ? K : 2 * K][kThreads];
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b < a.B) walk_pair<K, DIAG, ADAPT>(a, b, win);
}

}  // namespace

// algo: 0 LOCAL (score stop), 1 GLOBAL, 2 SEMI_GLOBAL; pad_d / pad_i:
// SEMI_GLOBAL's leading D / I pads (its target / query HEAD not skipped),
// ignored otherwise.  cigars [B, width] uint8 with width % 4 == 0 and
// width >= Lq + Lt + 8 + 2 ((max(Lq, Lt) + 1) / 63 + 1).  Launches on
// `stream` without synchronising; returns cudaGetLastError().
extern "C" int tb_walk_launch(int algo, int pad_d, int pad_i, const void* tb,
                              const void* score, const void* qend,
                              const void* tend, int B, int Lq, int Lt8,
                              int width, int match, int mismatch, int goe,
                              int ge, void* cigars, void* n_ops, void* qstart,
                              void* tstart, void* stream) {
  if (algo < 0 || algo > 2 || width % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const int*>(tb), static_cast<const int*>(score),
               static_cast<const int*>(qend), static_cast<const int*>(tend),
               B, Lq, Lt8, width, algo == 0, algo == 1 || pad_d,
               algo == 1 || pad_i, match, mismatch, goe, ge,
               static_cast<uint8_t*>(cigars), static_cast<int*>(n_ops),
               static_cast<int*>(qstart), static_cast<int*>(tstart)};
  tb_walk_kernel<kWindow, kDiagonal, kAdaptive>
      <<<(B + kThreads - 1) / kThreads, kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
