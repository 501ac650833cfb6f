// Design B of the traceback walk to byte-CIGARs (genomics_tpu_torch/csrc/
// tb_walk.cu holds design A and the contract): G lanes a pair.  The G lanes
// of a pair load a window of G columns x 2 word rows in one round, lane g
// the words of column j0 - g in word rows r0 and r0 - 1; every lane then
// runs the pair's walk in step, taking the word it needs from its column's
// lane by __shfl_sync, and lane 0 writes the bytes.  The window is refilled
// where the walk leaves it.  With kCounter, a group whose walk ends takes
// its next pair from a per-launch counter.  Built and timed by
// tools/kernel_variants.py --kernels tb_walk (kGroup 4, 8 or 32), never by
// the port: it exports tb_walk.cu's entry point.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ int next_pair;   // the pairs taken from the counter (kCounter)

constexpr int kThreads = 128;
constexpr int kGroup = 8;          // G: lanes a pair, columns a window
constexpr bool kCounter = false;   // later pairs from a per-launch counter

struct Args {
  const int* tb;
  const int* score;
  const int* qend;
  const int* tend;
  int B, Lq, Lt8, width;
  int local, pad_d, pad_i;
  int match, mismatch, goe, ge;
  uint8_t* cigars;
  int* n_ops;
  int* qstart;
  int* tstart;
};

struct Row {
  uint32_t* words;
  bool writer;
  uint32_t acc = 0;
  int n = 0;

  __device__ __forceinline__ void put(uint32_t byte) {
    acc |= byte << (8 * (n & 3));
    if ((++n & 3) == 0) {
      if (writer) words[(n >> 2) - 1] = acc;
      acc = 0;
    }
  }
  __device__ __forceinline__ void pad(int op, int len) {
    for (; len > 0; len -= 63) put(op | min(len, 63) << 2);
  }
  __device__ __forceinline__ void flush() {
    if (writer && (n & 3)) words[n >> 2] = acc;
  }
};

template <int G>
__device__ __forceinline__ void walk_pair(const Args& a, int b, int lane,
                                          unsigned mask) {
  const size_t sB = static_cast<size_t>(a.B);
  const size_t plane = static_cast<size_t>(a.Lq) * sB;
  const int T = a.Lq + a.Lt8 * 8;
  const int total = a.local ? a.score[b] : 0;
  int i = a.tend[b], j = a.qend[b];
  int op_shift = 0, op_select = 3, curr = 0;
  int prev = 0, run = 0, steps = 0;
  Row row{reinterpret_cast<uint32_t*>(a.cigars + static_cast<size_t>(b) *
                                                     a.width), lane == 0};
  bool active = i >= 0 && j >= 0;
  while (active) {
    const int r0 = i >> 3, j0 = j;
    const int jj = j0 - lane;
    const bool col = jj >= 0 && jj < a.Lq;
    const int* at = a.tb + static_cast<size_t>(col ? jj : 0) * sB + b;
    const uint32_t w0 = (col && r0 < a.Lt8)
                            ? static_cast<uint32_t>(__ldg(at + r0 * plane))
                            : 0u;
    const uint32_t w1 = (col && r0 >= 1 && r0 - 1 < a.Lt8)
                            ? static_cast<uint32_t>(__ldg(at + (r0 - 1) * plane))
                            : 0u;
    while (active) {
      const int k = j0 - j, rr = r0 - (i >> 3);
      if (k >= G || rr > 1) break;   // the same in every lane: refill
      const uint32_t word = __shfl_sync(mask, rr ? w1 : w0, k, G);
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
  }
  if (run) row.put(prev | run << 2);
  if (!a.local) {
    if (a.pad_d) row.pad(2, i + 1);
    if (a.pad_i) row.pad(3, j + 1);
  }
  row.flush();
  if (lane == 0) {
    a.n_ops[b] = row.n;
    a.qstart[b] = a.local ? j : (a.pad_i ? 0 : max(j + 1, 0));
    a.tstart[b] = a.local ? i : (a.pad_d ? 0 : max(i + 1, 0));
  }
}

template <int G, bool COUNTER>
__global__ void __launch_bounds__(kThreads) tb_walk_kernel(const Args a) {
  const int lane = threadIdx.x % G;
  const unsigned mask =
      G == 32 ? 0xffffffffu
              : ((1u << G) - 1) << ((threadIdx.x & 31) & ~(G - 1));
  int b = (blockIdx.x * kThreads + threadIdx.x) / G;
  const int first = gridDim.x * (kThreads / G);
  while (b < a.B) {   // b is the same in every lane of a group
    walk_pair<G>(a, b, lane, mask);
    if (!COUNTER) break;
    int nb = 0;
    if (lane == 0) nb = first + atomicAdd(&next_pair, 1);
    b = __shfl_sync(mask, nb, 0, G);
  }
}

}  // namespace

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
  auto kernel = tb_walk_kernel<kGroup, kCounter>;
  const int per_block = kThreads / kGroup;
  int blocks = (B + per_block - 1) / per_block;
  if (kCounter) {
    void* counter = nullptr;
    cudaGetSymbolAddress(&counter, next_pair);
    cudaMemsetAsync(counter, 0, sizeof(int), static_cast<cudaStream_t>(stream));
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
