// Design A of the traceback walk to byte-CIGARs with its window in
// registers (genomics_tpu_torch/csrc/tb_walk.cu holds the port's design
// and the contract): the words of columns j0 .. j0 - K + 1 in word rows r0
// and r0 - 1 (or, kDiagonal, each column's diagonal word) in 2K registers,
// the columns unrolled so that a word is picked by a select.  A thread's
// column sets which unrolled copy of the step it runs, so the threads of
// a warp that stand in different columns run their copies one after the
// other.  kAdaptive sizes each window by the last one's use; kCounter has
// a thread whose walk ends take its next pair from a per-launch counter.
// Built and timed by tools/kernel_variants.py --kernels tb_walk, never by
// the port: it exports tb_walk.cu's entry point.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ int next_pair;   // the pairs taken from the counter (kCounter)

constexpr int kThreads = 128;
constexpr int kWindow = 8;          // K: columns a window holds
constexpr bool kDiagonal = false;   // load only each column's diagonal word
constexpr bool kCounter = false;    // later pairs from a per-launch counter
constexpr bool kAdaptive = true;    // size each window by the last one's use

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

// A pair's row of cigars, filled four bytes to a store.
struct Row {
  uint32_t* words;
  uint32_t acc = 0;
  int n = 0;

  __device__ __forceinline__ void put(uint32_t byte) {
    acc |= byte << (8 * (n & 3));
    if ((++n & 3) == 0) {
      words[(n >> 2) - 1] = acc;
      acc = 0;
    }
  }
  __device__ __forceinline__ void pad(int op, int len) {
    for (; len > 0; len -= 63) put(op | min(len, 63) << 2);
  }
  __device__ __forceinline__ void flush() {
    if (n & 3) words[n >> 2] = acc;
  }
};

template <int K, bool DIAG, bool ADAPT>
__device__ __forceinline__ void walk_pair(const Args& a, int b) {
  const size_t sB = static_cast<size_t>(a.B);
  const size_t plane = static_cast<size_t>(a.Lq) * sB;
  const int T = a.Lq + a.Lt8 * 8;
  const int total = a.local ? a.score[b] : 0;
  int i = a.tend[b], j = a.qend[b];
  int op_shift = 0, op_select = 3, curr = 0;
  int prev = 0, run = 0;   // the last step's op, and the open run's length
  int steps = 0;
  Row row{reinterpret_cast<uint32_t*>(a.cigars + static_cast<size_t>(b) *
                                                     a.width)};
  bool active = i >= 0 && j >= 0;
  int n = K;   // columns the next window loads
  while (active) {
    // the window: columns j0 .. j0 - n + 1 in word rows r0 and r0 - 1 (or,
    // DIAG, the word row of the diagonal cell (i0 - k, j0 - k) alone)
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
    int used = 0;   // columns the walk went through
#pragma unroll
    for (int k = 0; k < K; ++k) {
      // the walk is in column j0 - k: a D stays in it, anything else
      // moves to the next
      if (k == n) break;
      while (active) {
        uint32_t word;
        if (DIAG) {
          if ((i >> 3) != ((i0 - k) >> 3)) break;
          word = w0[k];
        } else {
          const int rr = r0 - (i >> 3);
          if (rr > 1) break;
          word = rr ? w1[k] : w0[k];
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
          // local score reconstruction (decode_one:80-93); the stop
          // leaves i/j AT the stop cell
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
        if (fill != 2) break;
      }
      if (!active || j != j0 - k - 1) break;   // done, or refill
      used = k + 1;
    }
    // a window used up doubles the next; one left early shrinks it to
    // twice what was used
    if (ADAPT) n = min(K, max(1, 2 * used));
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

template <int K, bool DIAG, bool ADAPT, bool COUNTER>
__global__ void __launch_bounds__(kThreads) tb_walk_kernel(const Args a) {
  int b = blockIdx.x * kThreads + threadIdx.x;
  if (!COUNTER) {
    if (b < a.B) walk_pair<K, DIAG, ADAPT>(a, b);
    return;
  }
  // a thread whose walk ends takes the next pair not yet taken
  const int first = gridDim.x * kThreads;
  while (b < a.B) {
    walk_pair<K, DIAG, ADAPT>(a, b);
    b = first + atomicAdd(&next_pair, 1);
  }
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
  auto kernel = tb_walk_kernel<kWindow, kDiagonal, kAdaptive, kCounter>;
  int blocks = (B + kThreads - 1) / kThreads;
  if (kCounter) {
    void* counter = nullptr;
    cudaGetSymbolAddress(&counter, next_pair);
    cudaMemsetAsync(counter, 0, sizeof(int), static_cast<cudaStream_t>(stream));
    // as many blocks as stay resident: the rest of the pairs come from
    // the counter
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                  0);
    blocks = min(blocks, max(1, sms * per_sm));
  }
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
