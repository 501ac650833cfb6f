// Traceback walk over the DP kernels' direction nibbles, one thread per
// alignment, for Hopper (sm_90a).
//
// Replaces genomics_tpu/ops/tb_walk.py tb_walk_device (:29), a jnp walk
// (no Pallas kernel) that runs every lane in lockstep and gathers one word
// per lane per step, and, for GLOBAL and SEMI_GLOBAL, the walk half of the
// host decoder native/cigar.cpp decode_one (algo 1 and 2, :32-129).  Each
// thread runs decode_one's state machine (the transcription of GASAL2's
// get_tb.h:5-149) for its own alignment and stops as soon as that
// alignment is done: op_select/op_shift gap-chain tracking, X/M from the
// substitution bit, and in LOCAL mode the score-stop.  It starts at the
// caller's cell (tend, qend) — for GLOBAL one cell past the end, (tlen,
// qlen), a reference quirk — reads the sqb cube [Lt/8, Lq, B] that
// local_sw.cu, global_sw.cu and semiglobal_sw.cu write in TB mode (a cell
// outside the cube reads 0), and emits the walk-order op stream [T, B]
// uint8 (0=M 1=X 2=D 3=I, 255 after the walk ends) plus the final (j, i).
// GLOBAL and SEMI_GLOBAL walk alike: no score-stop, down to row or column
// -1.  Their leading D/I pads and starts follow from the final (j, i) and
// are added on the host with the run-length encode.
//
// The stream holds T = Lq + Lt steps, as tb_walk_device's does, and no
// walk the engines start needs more: a cell outside the cube reads 0, an
// M, so a walk that starts outside (GLOBAL's (tlen, qlen) when the pair
// fills its bucket, or SEMI_GLOBAL's TAIL_T quirk row qlen) moves
// diagonally until it is inside, and from inside, (i, j) takes at most
// i + j + 1 steps.  With a start column <= Lq that is at most Lq + Lt.
//
// Bound: scattered 4-byte reads of the nibble cube, one per step, and a
// serial dependency from each step to the next; the integer work per step
// is small.  This first design is the simple one.  The speedups left to
// later work for the DP kernel (DPX __vimax3_s32, packed 16-bit cells,
// shared-memory carries; see local_sw.cu) have no counterpart here; the
// walk's own are staging the cube's words in shared memory and packing
// the op stream four ops to a word.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr uint8_t kStop = 255;

__global__ void __launch_bounds__(kThreads)
tb_walk_kernel(int score_stop,                 // 1: LOCAL, 0: GLOBAL/SEMI_GLOBAL
               const int* __restrict__ tb,     // [Lt/8, Lq, B]
               const int* __restrict__ score,  // [B] (LOCAL)
               const int* __restrict__ qend,   // [B] start column
               const int* __restrict__ tend,   // [B] start row
               int B, int Lq, int Lt8, int match, int mismatch, int goe, int ge,
               uint8_t* __restrict__ ops,      // [Lq + Lt, B]
               int* __restrict__ qfin,         // [B] final j
               int* __restrict__ tfin)         // [B] final i
{
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = static_cast<size_t>(B);
  const int Lt = Lt8 * 8;
  const int T = Lq + Lt;
  const int total = score_stop ? score[b] : 0;
  int i = tend[b], j = qend[b];
  int op_shift = 0, op_select = 3, curr = 0, prev_op = 0;
  int s = 0;
  bool active = i >= 0 && j >= 0;
  while (active && s < T) {
    int cell = 0;
    if (i < Lt && j < Lq) {
      const uint32_t word =
          static_cast<uint32_t>(tb[(static_cast<size_t>(i >> 3) * Lq + j) * sB + b]);
      cell = (word >> (4 * (i & 7))) & 0xF;
    }
    const int op = (cell >> op_shift) & op_select;
    const int fill = (op == 0 || op_select == 3) ? op : op_shift;
    const bool reset = op == 0 || (op == 1 && op_select == 3);
    const bool to_gap = op >= 2 && op_select == 3;
    op_shift = reset ? 0 : (to_gap ? op : op_shift);
    op_select = reset ? 3 : 1;
    ops[static_cast<size_t>(s) * sB + b] = static_cast<uint8_t>(fill);
    ++s;
    if (score_stop) {
      // local score reconstruction (decode_one:80-93)
      curr += fill >= 2 ? (prev_op != fill ? -goe : -ge)
                        : (fill == 1 ? -mismatch : match);
      prev_op = fill;
      if (curr == total) break;  // the score stop leaves i/j AT the stop cell
    }
    i -= fill != 3;
    j -= fill != 2;
    active = i >= 0 && j >= 0;
  }
  for (; s < T; ++s) ops[static_cast<size_t>(s) * sB + b] = kStop;
  qfin[b] = j;
  tfin[b] = i;
}

}  // namespace

// algo: 0 LOCAL (score-stop), 1 GLOBAL, 2 SEMI_GLOBAL.  Launches on
// `stream` without synchronising; returns cudaGetLastError().
extern "C" int tb_walk_launch(int algo, const void* tb, const void* score,
                              const void* qend, const void* tend, int B, int Lq,
                              int Lt8, int match, int mismatch, int goe, int ge,
                              void* ops, void* qfin, void* tfin, void* stream) {
  if (algo < 0 || algo > 2) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((B + kThreads - 1) / kThreads), block(kThreads);
  tb_walk_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      algo == 0, static_cast<const int*>(tb), static_cast<const int*>(score),
      static_cast<const int*>(qend), static_cast<const int*>(tend), B, Lq, Lt8,
      match, mismatch, goe, ge, static_cast<uint8_t*>(ops),
      static_cast<int*>(qfin), static_cast<int*>(tfin));
  return static_cast<int>(cudaGetLastError());
}
