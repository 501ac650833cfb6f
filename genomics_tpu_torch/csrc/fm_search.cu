// Batched exact FM-index backward search for Hopper (sm_90a): one 32-byte
// record a rank, a suffix table for the first steps, QPT queries a thread.
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
// The index (`ops/fm_search.build_device_index`): one record of 8 int32 a
// block of 64 BWT positions, 32 bytes, one sector: the counts occ(s, 64k)
// of s = 0-3 before the block (the sentinel, stored as 'A', counted in
// none), then the block's low bit-plane as two words and its high
// bit-plane as two (bit b of word w: the low / high bit of the code at
// position 64k + 32w + b).  occ(s, i) = the count of s in record i / 64 +
// the popcount of the positions of the block below i whose code is s,
// minus one for 'A' where the sentinel lies in the block below i.  The
// records run to i = n (NB = ceil(n / 64) + 1), zero planes past n.
//
// The suffix table: for each of the 4^tk strings x of tk codes (key = sum
// x[m] 4^(tk-1-m)), the (lo, hi) the steps reach after searching x alone,
// a range that emptied early kept as the loop keeps it; a query with tk
// <= qlen <= L starts from the entry of its last tk codes, tk steps in.
// It is built by this kernel with tk = 0 (`ops/fm_search.suffix_table`;
// tk = min(10, floor(log4 n)): 8 MB at 10, which an L2 of 50 MB holds
// beside a 12 Mbp genome's 6 MB of records).
//
// What bounds a search is its chain of dependent L2 loads, two ranks a
// step.  So a rank is one sector (two 16-byte loads of one record), the
// table takes the first tk steps of the chain in one 8-byte load, and a
// thread runs QPT = 1, 2 or 4 queries' chains side by side (the fewest
// that put the launch in one wave of resident threads; 4 beyond, the
// threads looping over the rest), so every chain of the launch is in
// flight at once.
//
// Bound: integer work (the records and table stay in L2, so the bytes the
// launch must move from device memory are the queries, qlen, the table's
// and records' first reads and the results).  Per active step: the loop's
// tests (4), the code's address, load mask and its two selects f0 / f1
// (4), C's address and the two adds (3), and the step counter (1): 12;
// per rank: the block index and the record's address (2), the count's
// select (3), the plane match and the mask below i on two words (6), the
// two popcounts and their adds (3), the sentinel's test and subtract (4):
// 18; per table lookup, per code of the key its address, its mask and the
// shift-or (3), and the lookup's test and address (3).  Counted by
// ops/fm_search.backward_search_plain(stats=) and chip_smoke.py's
// FM_OPS_PER_STEP / _RANK / _KEY / _LOOKUP.  The L2 sector floor: a
// sector a rank and a lookup.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "bitlcs.cuh"   // bitlcs::wave_blocks

namespace {

constexpr int kThreads = 256;            // threads a block
constexpr int kRate = 64;                // positions a record

// occ(s, i): occurrences of code s (0-3) among BWT positions [0, i).
__device__ __forceinline__ int occ(const int4* __restrict__ rec, int primary,
                                   int s, uint64_t f0, uint64_t f1, int i) {
  const int k = i / kRate;
  const int4 cnt = __ldg(rec + 2 * k);
  const int4 pl = __ldg(rec + 2 * k + 1);
  int c = s == 0 ? cnt.x : s == 1 ? cnt.y : s == 2 ? cnt.z : cnt.w;
  const uint64_t p0 = static_cast<uint32_t>(pl.x) |
                      static_cast<uint64_t>(static_cast<uint32_t>(pl.y)) << 32;
  const uint64_t p1 = static_cast<uint32_t>(pl.z) |
                      static_cast<uint64_t>(static_cast<uint32_t>(pl.w)) << 32;
  const uint64_t below = (1ull << (i % kRate)) - 1ull;
  c += __popcll((p0 ^ f0) & (p1 ^ f1) & below);
  if (s == 0 && primary >= k * kRate && primary < i) --c;
  return c;
}

template <int QPT>
__global__ void __launch_bounds__(kThreads)
fm_search_kernel(const int4* __restrict__ rec, const int* __restrict__ C,
                 int primary, int n, const int2* __restrict__ table, int tk,
                 const uint8_t* __restrict__ queries, int L, long long qs,
                 const int* __restrict__ qlen, int S, int* __restrict__ lo_out,
                 int* __restrict__ hi_out) {
  const int threads = gridDim.x * kThreads;
  for (int first = blockIdx.x * kThreads + threadIdx.x; first < S;
       first += threads * QPT) {
    int lo[QPT], hi[QPT], ql[QPT], t[QPT];
    const uint8_t* row[QPT];
#pragma unroll
    for (int u = 0; u < QPT; ++u) {
      const int q = first + u * threads;
      row[u] = queries + static_cast<long long>(q < S ? q : 0) * qs;
      ql[u] = q < S ? __ldg(qlen + q) : 0;
      lo[u] = 0;
      hi[u] = n;
      t[u] = q < S ? 0 : L;               // a slot past S takes no step
      if (tk > 0 && q < S && ql[u] >= tk && ql[u] <= L) {
        int key = 0;
        for (int m = ql[u] - tk; m < ql[u]; ++m)
          key = key << 2 | (__ldg(row[u] + m) & 3);
        const int2 e = __ldg(table + key);
        lo[u] = e.x;
        hi[u] = e.y;
        t[u] = tk;
      }
    }
    for (bool more = true; more;) {
      more = false;
#pragma unroll
      for (int u = 0; u < QPT; ++u) {
        const int k = ql[u] - 1 - t[u];
        if (t[u] >= L || k < 0 || hi[u] <= lo[u]) continue;
        const int s = __ldg(row[u] + min(k, L - 1)) & 3;
        const uint64_t f0 = (s & 1) ? 0ull : ~0ull;
        const uint64_t f1 = (s & 2) ? 0ull : ~0ull;
        const int c = __ldg(C + s + 1);
        lo[u] = c + occ(rec, primary, s, f0, f1, lo[u]);
        hi[u] = c + occ(rec, primary, s, f0, f1, hi[u]);
        ++t[u];
        more = true;
      }
    }
#pragma unroll
    for (int u = 0; u < QPT; ++u) {
      const int q = first + u * threads;
      if (q < S) {
        lo_out[q] = lo[u];
        hi_out[q] = hi[u];
      }
    }
  }
}

}  // namespace

// rec: [NB, 8] int32 records (16-byte aligned); C: [6] int32; primary: the
// sentinel's row; n: BWT length (text + sentinel); table: [4^tk] int2
// (lo, hi) (unread where tk = 0); queries: [S, L] uint8 codes (only the
// low 2 bits are read), row q at queries + q * qs bytes; qlen: [S] int32;
// lo / hi: [S] int32 SA ranges (hi <= lo: no match).  S must be at least
// 1, tk 0-15.  Launches on `stream` without synchronising; returns the
// first CUDA error.
extern "C" int fm_search_launch(const void* rec, int NB, const void* C,
                                int primary, int n, const void* table, int tk,
                                const void* queries, int L, long long qs,
                                const void* qlen, int S, void* lo, void* hi,
                                void* stream) {
  if (S < 1 || L < 0 || NB < 1 || tk < 0 || tk > 15 || (tk && !table))
    return static_cast<int>(cudaErrorInvalidValue);
  int wave = 0;   // blocks the card holds at once (every QPT's shape)
  const cudaError_t e =
      bitlcs::wave_blocks(fm_search_kernel<4>, kThreads, 0, wave);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long resident = static_cast<long long>(wave) * kThreads;
  const int qpt = S <= resident ? 1 : S <= 2 * resident ? 2 : 4;
  const long long blocks = std::min<long long>(
      (S + static_cast<long long>(qpt) * kThreads - 1) / (qpt * kThreads),
      wave);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* r = static_cast<const int4*>(rec);
  const auto* c = static_cast<const int*>(C);
  const auto* tb = static_cast<const int2*>(table);
  const auto* qu = static_cast<const uint8_t*>(queries);
  const auto* ql = static_cast<const int*>(qlen);
  auto* l = static_cast<int*>(lo);
  auto* h = static_cast<int*>(hi);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (qpt == 1)
    fm_search_kernel<1><<<grid, kThreads, 0, st>>>(r, c, primary, n, tb, tk,
                                                   qu, L, qs, ql, S, l, h);
  else if (qpt == 2)
    fm_search_kernel<2><<<grid, kThreads, 0, st>>>(r, c, primary, n, tb, tk,
                                                   qu, L, qs, ql, S, l, h);
  else
    fm_search_kernel<4><<<grid, kThreads, 0, st>>>(r, c, primary, n, tb, tk,
                                                   qu, L, qs, ql, S, l, h);
  return static_cast<int>(cudaGetLastError());
}
