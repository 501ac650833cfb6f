// The bit-parallel LCS word step shared by cluster_lcs.cu and ngia_lcs.cu
// (kernel_dynamic of CDP/CLUSTER/func.cu:641-660 and its nGIA variant).
//
// A text (the representative) is two bit-planes of 32-base words: bit b of
// word w of `low` / `high` is the low / high bit of the 2-bit code of base
// 32w + b.  A query base c updates the row, a big integer of words that
// starts all ones, as
//   row <- (row + (row & match)) | (row & ~match)
// with match the text positions whose code is c.  The carry of the add runs
// from word to word upward; the matched count is the zero bits of the row
// below the text's net length.
#pragma once

#include <stdint.h>

namespace bitlcs {

// The text positions of word (tl, th) whose code equals the query base:
// ql / qh are all ones where the base's low / high bit is set.
__device__ __forceinline__ uint32_t match(uint32_t tl, uint32_t th,
                                          uint32_t ql, uint32_t qh) {
  return ~((tl ^ ql) | (th ^ qh));
}

// All ones where bit `bit` of base code b is set.
__device__ __forceinline__ uint32_t plane(uint32_t b, int bit) {
  return 0u - ((b >> bit) & 1u);
}

// One word of the row's update: returns the new word and replaces `carry`
// (0 or 1) by the word's carry out.
__device__ __forceinline__ uint32_t step(uint32_t r, uint32_t m,
                                         uint32_t& carry) {
  const unsigned long long t =
      static_cast<unsigned long long>(r) + (r & m) + carry;
  carry = static_cast<uint32_t>(t >> 32);
  return static_cast<uint32_t>(t) | (r & ~m);
}

// The bits of word w that lie below a text of `tnet` bases.
__device__ __forceinline__ uint32_t mask(int tnet, int w) {
  const int bits = tnet - 32 * w;
  return bits >= 32 ? 0xFFFFFFFFu : bits <= 0 ? 0u : (1u << bits) - 1u;
}

}  // namespace bitlcs
