#!/usr/bin/env python3
"""What the redesigned kernels' times are made of: one-change variants of
csrc/local_sw.cu, csrc/semiglobal_start.cu, csrc/local_start.cu,
csrc/banded_sw.cu, csrc/semiglobal_sw.cu, the two PairHMM kernels
(csrc/pairhmm_intertask.cu, csrc/pairhmm_wavefront.cu), csrc/tb_walk.cu
and csrc/myers.cu timed side by side on one card.

    python3 tools/kernel_variants.py --parent DIR [--kernels K,...]
                                     [--rounds N] [--out DIR]
    python3 tools/kernel_variants.py --kernels groups [--rounds N]

DIR is an unpacked checkout of the commit before the kernels' redesign
(`git archive <commit> | tar -x -C DIR`, into a directory .gitignore
lists): for local_sw and semiglobal_start the parent of their redesign
(299c71f), for local_start and banded_sw the parent of theirs (7e5a43d),
for semiglobal_sw and local_sw16 (local_sw.cu's 16-bit SCORE16 / END16)
the parent of theirs (7fb004a), for pairhmm (both PairHMM kernels) the
parent of theirs (604c0a0), for tb_walk and myers the parent of theirs
(32913d8; only DIR/genomics_tpu_torch/csrc is read).  --kernels picks the
families (default
semiglobal_sw,local_sw16); the family groups needs no DIR (below).  The
script builds, with the port's nvcc flags:

  local_sw-parent          DIR's local_sw.cu, the first design
  local_sw-parent-ahead    that, with the next column's query code and
                           carry loaded one column ahead
  local_sw-parent-bits     that, with TB's extension bits compared against
                           tmp - gapo (no u - ge, e - ge formed)
  local_sw-parent-dpx      that, with the DPX maxima (__vimax3_s32_relu,
                           __viaddmax_s32)
  local_sw-this-top        this tree's local_sw.cu with the loads back at
                           the top of each column
  local_sw-this            this tree's local_sw.cu
  semiglobal_start-parent  DIR's semiglobal_start.cu, the first design
  semiglobal_start-parent-ahead  that, loading one column ahead (the
                           boundary values where no strip has run)
  semiglobal_start-parent-tailt  that, with TAIL_T's capture taken once
                           after column qlen-1 instead of in every cell
  semiglobal_start-parent-dpx    that, with the DPX maxima
  semiglobal_start-this-top      this tree's with the loads at the top
  semiglobal_start-this-dpx      this tree's with the DPX maxima
  semiglobal_start-this    this tree's semiglobal_start.cu
  semiglobal_start-this-64 the same with 64 threads a block
  local_start-parent       DIR's local_start.cu, the first design
  local_start-parent-ahead that, with the next column's query code and
                           carry loaded one column ahead
  local_start-this-g1      this tree's local_start.cu with a kernel of
                           one thread a pair beside it (group 1): its
                           walk to the extents, its loads one column
                           ahead, the first design's thread layout
  local_start-this-g1-top  that, with the loads back at each column's top
  local_start-this-g2      this tree's local_start.cu taking 2 threads a
                           pair too
  banded_sw-parent         DIR's banded_sw.cu, the first design ([Lq, B]
                           carry scratch, zeroed per pair)
  banded_sw-this-top       this tree's banded_sw.cu with each tile's
                           carries and query codes loaded at its top
  banded_sw-this-128       this tree's with 128 threads a shared-layout
                           block instead of one warp
  semiglobal_sw-parent     DIR's semiglobal_sw.cu, the first design
  semiglobal_sw-parent-ahead   that, loading the next column's query
                           code and carry one column ahead
  semiglobal_sw-parent-dpx that, with the DPX maxima (__vimax3_s32,
                           __viaddmax_s32)
  semiglobal_sw-parent-tailt   that, with TAIL_T's capture once a column
  semiglobal_sw-parent-extents that, with END walking each pair only to
                           its extents (columns < qlen, strips <= s_bottom)
  semiglobal_sw-parent-32  that, with one-warp (32-thread) blocks
  semiglobal_sw-this-full  this tree's with END over every column and
                           strip
  semiglobal_sw-this-top   this tree's with thread 0's loads at each
                           column's top
  semiglobal_sw-this-32    this tree's with one-warp blocks
  local_sw16-parent        DIR's local_sw.cu, the first 16-bit design
  local_sw16-parent-load16 that, with one 16-bit load of each pair pair's
                           codes (the timed launches have even B)
  local_sw16-parent-32     that, with one-warp blocks
  local_sw16-this-bytes    this tree's with two byte loads
  local_sw16-this-32       this tree's with one-warp blocks
  local_sw16-this-shared   this tree's with the carry between a thread
                           group's rounds in shared memory instead of the
                           [Lq, ceil(B/2)] device scratch
  pairhmm-intertask-parent DIR's pairhmm_intertask.cu, the first design
                           (one thread a pair, [R8, B] / [C, B] inputs)
  pairhmm-intertask-parent-last  that, with the last row's sum taken once
                           a column by the strip that holds it
  pairhmm-wavefront-parent DIR's pairhmm_wavefront.cu, the first design
                           (one warp a pair, one row a lane)
  pairhmm-wavefront-parent-ahead  that, with lane 0's row-above loads one
                           step ahead
  pairhmm-*-this-top       this tree's with each lane's haplotype byte
                           loaded at its step, not one ahead
  pairhmm-*-this-unroll2   this tree's with the step loop unrolled twice
  pairhmm-*-this-64        this tree's in 64-thread blocks
  tb_walk-parent           DIR's tb_walk.cu, the first design (one load a
                           step, the [Lq + Lt, B] op stream), alone and
                           with the host encode that followed it
  tb_walk-smem-*           this tree's tb_walk.cu (design A, the window in
                           shared memory) at K of 4, 8 and 16 over two word
                           rows (rows2) and 8, 16 and 32 diagonal words
                           (diag), fixed or sized by use (adapt), and two
                           in 32-thread blocks (T32)
  tb_walk-reg-*            tools/tb_walk_registers.cu: design A with the
                           window in registers, columns unrolled, with and
                           without a pair counter
  tb_walk-lanes-G*         tools/tb_walk_lanes.cu: design B, G lanes a
                           pair sharing a window by shuffles, G of 4, 8 and
                           32, with and without a pair counter
  myers-parent             DIR's myers.cu, the first design, alone on its
                           batch-innermost copies and with its wrapper's
                           transposes
  myers-T*-C*              this tree's myers.cu at 128 and 64 threads a
                           block and 32 or 64 text bytes a stage
  myers-this-predicated    this tree's with the step's state update by
                           predicated selects, not a branch
  myers-this-word-step     this tree's with the first design's step, one
                           word at a time

and launches them with CUDA events, the launches alone, in turns (every
variant forward, then backward).  local_sw and semiglobal_start run at
bench.py's shape (65,536 pairs of 152 x 152, half related): local_sw in
SCORE (pads remapped, no N compare), END, TB and SECOND; semiglobal_start
at NONE/BOTH (the fullest tracking), fed the semiglobal_sw END kernel's
forward result, in the launch's order and with the pairs ordered by
row_count as the port launches them (cuda_align.by_row_count: the
argsort, the gathers and the inverse scatter counted; this tree's kernel
also on inputs sorted beforehand), and the parent and the two block sizes
also at 10,000 pairs of 216 x 328.  local_start (fed the local_sw END
kernel's forward result) and banded_sw (band 4, END and SCORE without the
N compare) run at bench.py's shape and at the engine's own launches (the
20,000 GASAL2-shaped pairs of chip_smoke.gasal_pairs in the engine's
buckets), each variant with one change against the next: the first
design in the launch's order and ordered (local_start by qr8 x tr8,
banded_sw by band tiles; the ordering counted), its loads one column
ahead, this tree's walk at one thread a pair over the full Lq x Lt and
to the extents in the launch's order, ordered, with its loads at the
top, and at 2, 4 and 8 threads a pair (4 also in the launch's order;
the port takes 4 or 8 by cuda_align.split_group); banded_sw's
shared carry in the launch's
order (the port's launch), ordered by band tiles or by tlen (the key,
the argsort, the gathers and the scatter counted) and on inputs sorted
beforehand, as a ring of the full Lq instead of banded_ring's, with each
tile's loads at its top, with 128-thread blocks, and with the global
layout forced.  Every
reading is the mean of a few launches; --rounds passes (default 2) give
each variant 2 x rounds readings, their mean and their spread.  Every
variant's output is compared word for word with the plain version's
(LOCAL: scores, ends, cube; SEMI_GLOBAL starts under all 16 HEAD x TAIL
flags; the start cells; BANDED scores and ends; SEMI_GLOBAL scores, ends
and cube; the 16-bit scores and ends); the script exits 1 if any
disagrees.  semiglobal_sw (END and TB) and local_sw16 (SCORE16 on the
pads remapped, END16) run at bench.py's shape (NONE/BOTH), at the
engine's launches (glocal's TARGET/TARGET) and, local_sw16 only, at the
align CLI's launches (the first 5,000 pairs' buckets): each variant
above, this tree at 4 and 8 threads a pair (pair pair) and
through the wrapper (cuda_align.split_group's), and this tree's int32
SCORE / END beside SCORE16 / END16.  The family groups times this tree's
local_start, semiglobal_sw END / TB and SCORE16 / END16 at 4 and 8
threads a pair (pair pair) over launch sizes of 2,048-32,768 pairs (pair
pairs) at 216 x 328 and 152 x 152, each held to the plain version, and
prints from which size 4 is no slower than 8: the data behind
cuda_align.split_group's boundary (SPLIT_MIN_THREADS_PER_SM).  It also prints the lanes' share of the work
(chip_smoke.lane_share) in the launch's order and under each key.  The
family pairhmm times both PairHMM kernels at chip_smoke.py's PairHMM
launches (run_all.py's 16,384 x 128 x 128, the 65,536-pair region
launch, a 256-pair candidate launch, 1, 7 and 64 pairs of 250 x 500):
the first designs (the inter-task one also with its wrapper's
transposes), their variants, this tree at every lanes x rows shape in
its rule's handover layout and the global one, this tree's variants at
the rule's shape and the other kernel's rule on the same launch, each
held to the plain version bit for bit, with the serial steps of a pair.
The family tb_walk times every walk variant at bench.py's shape
(LOCAL, GLOBAL and SEMI_GLOBAL NONE/BOTH on the TB kernels' cubes) and at
the engine's two launches (glocal's TARGET/TARGET), each held to the
plain version's bytes, n_ops and starts; myers times its variants at
run_all.py's 16,384 x 96 x 152 and the `ed` stage's 65,536 150 bp reads
against 200 bp windows, held to the plain version.
The variant sources go to --out (default chiprun_out/kernel_variants), for
tools/sass_report.py --src.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import itertools
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import (  # noqa: E402
    BENCH_B,
    BENCH_BAND,
    band_windows,
    BENCH_L,
    PAIRS,
    cuda_ms,
    engine_batches,
    gasal_pairs,
    has_ns,
    lane_share,
    nvidia_smi,
    random_codes,
)
from genomics_tpu_torch import _build  # noqa: E402
from genomics_tpu_torch.core.scoring import (  # noqa: E402
    AlgoType,
    AlignmentParams,
    SemiGlobalSkip,
)
from genomics_tpu_torch.ops import cuda_align, scan_align_full  # noqa: E402
from genomics_tpu_torch.ops.scan_align import (  # noqa: E402
    banded_align_batch,
    local_align_batch,
    local_align_batch16,
    semiglobal_align_batch,
)
from tools.tb_variants import build_variants, edit  # noqa: E402

# local_sw.cu: the first design's column loads, at the column's top
LOCAL_TOP = """    for (int j = 0; j < Lq; ++j) {
      const size_t at = static_cast<size_t>(j) * sB + b;
      const int qc = Q[at];
      const int hcol = s ? gH[at] : 0;
      int e = s ? gE[at] : 0;
"""
LOCAL_AHEAD = """    int qn = Q[b];
    int hn = s ? gH[b] : 0;
    int en = s ? gE[b] : 0;
    for (int j = 0; j < Lq; ++j) {
      const size_t at = static_cast<size_t>(j) * sB + b;
      const int qc = qn, hcol = hn;
      int e = en;
      if (j + 1 < Lq) {
        qn = Q[at + sB];
        hn = s ? gH[at + sB] : 0;
        en = s ? gE[at + sB] : 0;
      }
"""
LOCAL_BITS = """          const int d = (h == tmp) ? (sub >= 0 ? 0 : 1) : (h == u ? 3 : 2);
          const int f_ext = tmpg > u - ge ? 0 : 1;
          const int e_ext = tmpg > e - ge ? 0 : 1;
          word |= static_cast<uint32_t>(d | (e_ext << 2) | (f_ext << 3)) << (4 * c);
"""
LOCAL_BITS_TG = """          const int tg = tmp - (goe - ge);
          const uint32_t d = (h == tmp) ? static_cast<uint32_t>(sub) >> 31
                                        : (h == u ? 3u : 2u);
          word |= (d | (e >= tg ? 4u : 0u) | (u >= tg ? 8u : 0u)) << (4 * c);
"""
LOCAL_MAX = [("        const int h = max(max(tmp, u), max(e, 0));\n",
              "        const int h = __vimax3_s32_relu(tmp, u, e);\n"),
             ("        f[c] = max(tmpg, u - ge);\n        e = max(tmpg, e - ge);\n",
              "        f[c] = __viaddmax_s32(u, -ge, tmpg);\n"
              "        e = __viaddmax_s32(e, -ge, tmpg);\n")]

# semiglobal_start.cu
SEMI_TOP = """    for (int j = 0; j < Lq; ++j) {
      const size_t at = static_cast<size_t>(j) * sB + b;
      const int qc = a.Q[at];
      int hup, e;
      if (carried) {
        hup = a.gH[at];
        e = a.gE[at];
      } else {
        hup = (HEAD_Q || j == 0) ? 0 : -(gapo + ge * j);
        e = kMinusInf;
      }
"""
SEMI_AHEAD = """    int qn = a.Q[b];
    int hn = s ? a.gH[b] : 0;
    int en = s ? a.gE[b] : kMinusInf;
    for (int j = 0; j < Lq; ++j) {
      const size_t at = static_cast<size_t>(j) * sB + b;
      const int qc = qn;
      int hup = hn, e = en;
      if (j + 1 < Lq) {
        qn = a.Q[at + sB];
        hn = s ? a.gH[at + sB] : (HEAD_Q ? 0 : -(gapo + ge * (j + 1)));
        en = s ? a.gE[at + sB] : kMinusInf;
      }
"""
# this tree's loads ahead, up to its e0
SEMI_THIS_AHEAD = """    int qn = a.Q[b];
    int hn = s ? a.gH[b] : 0;
    int en = s ? a.gE[b] : kMinusInf;
    for (int j = 0; j < Lq; ++j) {
      const size_t at = static_cast<size_t>(j) * sB + b;
      const int qc = qn, hup = hn;
      int e = en;
      if (j + 1 < Lq) {
        qn = a.Q[at + sB];
        hn = s ? a.gH[at + sB] : (HEAD_Q ? 0 : -(gapo + ge * (j + 1)));
        en = s ? a.gE[at + sB] : kMinusInf;
      }
"""
SEMI_CELL_CAPTURE = """        const int r = s * 8 + c;
        if (TAIL_T && j == jl && r < rcnt && r + roff < tl && h > best) {
          best = h;
          row = r + roff;
        }
"""
SEMI_COLUMN_END = """        hl[c] = h;
      }
      a.gH[at] = keep ? hl[7] : hup0;
"""
SEMI_ONCE_CAPTURE = """        hl[c] = h;
      }
      if (TAIL_T && j == jl) {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int r = s * 8 + c;
          if (r < rcnt && r + roff < tl && hl[c] > best) {
            best = hl[c];
            row = r + roff;
          }
        }
      }
      a.gH[at] = keep ? hl[7] : hup0;
"""
SEMI_MAX = [("        const int fc = max(hl[c] - goe, f[c] - ge);\n",
             "        const int fc = __viaddmax_s32(f[c], -ge, hl[c] - goe);\n"),
            ("        e = max(phd, e - ge);\n        const int h = max(max(tmp, fc), e);\n",
             "        e = __viaddmax_s32(e, -ge, phd);\n"
             "        const int h = __vimax3_s32(tmp, fc, e);\n")]
# local_start.cu: the first design's column loads, at the column's top
START_TOP = """    for (int j = 0; j < Lq; ++j) {
      const size_t at = static_cast<size_t>(j) * sB + b;
      const int qc = Q[at];
      const int hcol = s ? gH[at] : 0;
      int e = s ? gE[at] : 0;
"""
START_AHEAD = """    int qn = Q[b];
    int hn = s ? gH[b] : 0;
    int en = s ? gE[b] : 0;
    for (int j = 0; j < Lq; ++j) {
      const size_t at = static_cast<size_t>(j) * sB + b;
      const int qc = qn, hcol = hn;
      int e = en;
      if (j + 1 < Lq) {
        qn = Q[at + sB];
        hn = s ? gH[at + sB] : 0;
        en = s ? gE[at + sB] : 0;
      }
"""
# local_start.cu: one thread a pair (group 1; the kernel below, this
# tree's walk and loads in the first design's thread layout), and two
START_ONE_THREAD = """__global__ void __launch_bounds__(kThreads) local_start_kernel(const Args a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const int p = a.order ? a.order[b] : b;
  const size_t sB = static_cast<size_t>(a.B);
  const int target = a.fwd[p];
  const int ncol = columns_of(a, p), nstrip = ncol ? strips_of(a, p) : 0;
  int best = -1, bcol = 0, bstrip = 0, brow = 0;  // h >= 0: cell 0 is taken
  for (int s = 0; s < nstrip; ++s) {
    int tc[8], hp[8], f[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      tc[c] = a.T[static_cast<size_t>(s * 8 + c) * sB + b];
      hp[c] = 0;
      f[c] = 0;
    }
    // column 0's query code and carry; each column loads the next one's
    // before computing its own
    int qn = a.Q[b];
    int hn = s ? a.gH[b] : 0;
    int en = s ? a.gE[b] : 0;
    int diag0 = 0;
    for (int j = 0; j < ncol; ++j) {
      const size_t at = static_cast<size_t>(j) * sB + b;
      const int qc = qn, hcol = hn, e0 = en;
      if (j + 1 < ncol) {
        qn = a.Q[at + sB];
        hn = s ? a.gH[at + sB] : 0;
        en = s ? a.gE[at + sB] : 0;
      }
      const int top = best;
      const int e = column(a, tc, hp, f, qc, diag0, e0, best, brow);
      if (best > top) {
        bcol = j;
        bstrip = s;
      }
      diag0 = hcol;
      a.gH[at] = hp[7];
      a.gE[at] = e;
      if (best >= target) goto done;  // the column segment reached it
    }
  }
done:
  put(a, p, bcol, bstrip, brow);
}

"""
START_SPLIT = "template <int G>\n__global__ void __launch_bounds__(kThreads) local_start_split_kernel"
START_CASE4 = "    case 4: local_start_split_kernel<4><<<grid, kThreads, 0, st>>>(a); break;\n"
START_CASE1 = "    case 1: local_start_kernel<<<grid, kThreads, 0, st>>>(a); break;\n"
START_CASE2 = "    case 2: local_start_split_kernel<2><<<grid, kThreads, 0, st>>>(a); break;\n"
START_THIS_AHEAD = """    int qn = a.Q[b];
    int hn = s ? a.gH[b] : 0;
    int en = s ? a.gE[b] : 0;
    int diag0 = 0;
    for (int j = 0; j < ncol; ++j) {
      const size_t at = static_cast<size_t>(j) * sB + b;
      const int qc = qn, hcol = hn, e0 = en;
      if (j + 1 < ncol) {
        qn = a.Q[at + sB];
        hn = s ? a.gH[at + sB] : 0;
        en = s ? a.gE[at + sB] : 0;
      }
"""
START_THIS_TOP = """    int diag0 = 0;
    for (int j = 0; j < ncol; ++j) {
      const size_t at = static_cast<size_t>(j) * sB + b;
      const int qc = a.Q[at];
      const int hcol = s ? a.gH[at] : 0;
      const int e0 = s ? a.gE[at] : 0;
"""
# banded_sw.cu: the next tile's carries and query codes loaded ahead, or
# each tile's at its top
BAND_TOP = """    int slot = (lo * 8) % ring;
    for (int k = lo; k < hi; ++k) {
      // the tile's 8 carries (zero where no earlier strip reached it) and
      // query codes, loaded together at its top
      int2 cc[8];
#pragma unroll
      for (int x = 0; x < 8; ++x)
        cc[x] = k < seen ? eh[(slot + x) * es] : make_int2(0, 0);
      const uint2 qw = qt[k];
      const int here = slot;
      slot = slot + 8 == ring ? 0 : slot + 8;
"""
BAND_AHEAD = """    int slot = (lo * 8) % ring;
    int2 cn[8];
    uint2 qn = make_uint2(0, 0);
    if (lo < hi) {
      qn = qt[lo];
#pragma unroll
      for (int x = 0; x < 8; ++x)
        cn[x] = lo < seen ? eh[(slot + x) * es] : make_int2(0, 0);
    }
    for (int k = lo; k < hi; ++k) {
      int2 cc[8];
#pragma unroll
      for (int x = 0; x < 8; ++x) cc[x] = cn[x];
      const uint2 qw = qn;
      const int here = slot;
      slot = slot + 8 == ring ? 0 : slot + 8;
      if (k + 1 < hi) {
        qn = qt[k + 1];
#pragma unroll
        for (int x = 0; x < 8; ++x)
          cn[x] = k + 1 < seen ? eh[(slot + x) * es] : make_int2(0, 0);
      }
"""
# 128 threads a shared-layout block instead of 32
BAND_WARP_BLOCKS = "constexpr int kSharedThreads = 32;\n"

# semiglobal_sw.cu, the first design (7fb004a): its column loads at the
# top, loaded one column ahead instead (the boundary values where s == 0)
SG_TOP = """    for (int j = 0; j < Lq; ++j) {
      const size_t at = static_cast<size_t>(j) * sB + b;
      const int qc = a.Q[at];
      int hup, e;  // H and e of the row above the strip
      if (s) {
        hup = a.gH[at];
        e = a.gE[at];
      } else if (HEAD_Q) {
        hup = e = 0;
      } else {
        hup = j ? -(gapo + ge * j) : 0;
        e = kMinusInf;
      }
"""
SG_AHEAD = """    int qn = a.Q[b];
    int hn = s ? a.gH[b] : 0;
    int en = s ? a.gE[b] : (HEAD_Q ? 0 : kMinusInf);
    for (int j = 0; j < Lq; ++j) {
      const size_t at = static_cast<size_t>(j) * sB + b;
      const int qc = qn;
      int hup = hn, e = en;
      if (j + 1 < Lq) {
        qn = a.Q[at + sB];
        hn = s ? a.gH[at + sB] : (HEAD_Q ? 0 : -(gapo + ge * (j + 1)));
        en = s ? a.gE[at + sB] : (HEAD_Q ? 0 : kMinusInf);
      }
"""
# its maxima as DPX
SG_MAX = [("        const int fc = max(hl[c] - goe, f[c] - ge);\n",
           "        const int fc = __viaddmax_s32(f[c], -ge, hl[c] - goe);\n"),
          ("        e = max(phd, e - ge);\n        const int h = max(max(tmp, fc), e);\n",
           "        e = __viaddmax_s32(e, -ge, phd);\n"
           "        const int h = __vimax3_s32(tmp, fc, e);\n")]
# TAIL_T's capture once a column instead of in every cell
SG_CELL_CAPTURE = """        if (TAIL_T && j == jl && s * 8 + c < tl && h > best_t) {
          best_t = h;
          row_t = s * 8 + c;
        }
"""
SG_COLUMN_END = """        hl[c] = h;
      }
      a.gH[at] = hl[7];
"""
SG_ONCE_CAPTURE = """        hl[c] = h;
      }
      if (TAIL_T && j == jl) {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          if (s * 8 + c < tl && hl[c] > best_t) {
            best_t = hl[c];
            row_t = s * 8 + c;
          }
        }
      }
      a.gH[at] = hl[7];
"""
# END walked to each pair's extents
SG_EXTENTS = [("  const int n_strips = a.Lt >> 3;\n",
               "  const int n_strips = MODE == TB ? a.Lt >> 3\n"
               "      : (TAIL_Q || TAIL_T) ? min(s_bottom + 1, a.Lt >> 3) : 0;\n"),
              (SG_TOP.splitlines(True)[0],
               "    for (int j = 0; j < (MODE == TB ? Lq : min(ql, Lq)); ++j) {\n")]
# this tree's semiglobal_sw.cu: END over every column and strip
SG_THIS_EXTENTS = """  int ncol = MODE == TB ? Lq : (a.tail_q || a.tail_t ? min(ql, Lq) : 0);
  if (!live) ncol = 0;
  const int nstrip = ncol > 0 ? (MODE == TB ? a.Lt >> 3
                                            : min(s_bottom + 1, a.Lt >> 3))
                              : 0;
"""
SG_THIS_FULL = """  int ncol = Lq;
  if (!live) ncol = 0;
  const int nstrip = ncol > 0 ? a.Lt >> 3 : 0;
"""
# ... and with thread 0's loads at each column's top
SG_THIS_LOADS = [("    if (g == 0 && mine) load(0);\n", ""),
                 ("      int rh = hn, re = en, rq = qn;\n",
                  "      if (g == 0 && mine && k < ncol) load(k);\n"
                  "      int rh = hn, re = en, rq = qn;\n"),
                 ("      if (g == 0 && mine && j + 1 < ncol) load(j + 1);\n", "")]
# local_sw.cu's 16-bit kernel, the first design: one 16-bit load of each
# pair pair's codes (even B only, as every timed launch has)
L16_BYTES = [("    qc = col[0] | static_cast<uint32_t>(two ? col[1] : 16) << 16;\n",
              "    qc = two ? __byte_perm(*reinterpret_cast<const uint16_t*>(col), 0, 0x4140)\n"
              "             : col[0] | 16u << 16;\n"),
             ("      tc[c] = row[0] | static_cast<uint32_t>(two ? row[1] : 17) << 16;\n",
              "      tc[c] = two ? __byte_perm(*reinterpret_cast<const uint16_t*>(row), 0, 0x4140)\n"
              "                  : row[0] | 17u << 16;\n")]
# this tree's: two byte loads instead of one 16-bit load
L16_THIS_LOAD = ("  if (even)\n    return __byte_perm",
                 "  if (false)\n    return __byte_perm")
# this tree's: the carry between a thread group's rounds in shared memory
# ([Lq] H and E words per pair pair of the block) instead of the [Lq,
# ceil(B/2)] device scratch; 2 Lq 128 / G words a block, under 48 KB at
# the rule's groups of the timed launches
L16_THIS_SHARED = [
    ("  const int nstrip = live ? Lt >> 3 : 0;\n",
     "  const int nstrip = live ? Lt >> 3 : 0;\n"
     "  extern __shared__ uint32_t carry[];\n"
     "  const int ppb = blockDim.x / G, slot = threadIdx.x / G;\n"
     "  uint32_t* sH = carry + slot;\n"
     "  uint32_t* sE = carry + Lq * ppb + slot;\n"),
    ("      hn = s ? gH[at] : 0;\n      en = s ? gE[at] : 0;\n",
     "      hn = s ? sH[j * ppb] : 0;\n      en = s ? sE[j * ppb] : 0;\n"),
    ("          gH[at] = oh;\n          gE[at] = oe;\n",
     "          sH[j * ppb] = oh;\n          sE[j * ppb] = oe;\n"),
    ("  local_sw16_kernel<ENDS, G><<<grid, kThreads, 0, st>>>(",
     "  local_sw16_kernel<ENDS, G><<<grid, kThreads, 8 * Lq * (kThreads / G), st>>>(")]
SPLIT_KERNELS = ("semiglobal_sw", "local_sw16")
SPLIT_GROUPS = (4, 8)   # what cuda_align.split_group takes
# --kernels groups: launch sizes, in pairs (local_start, semiglobal_sw)
# or pair pairs (the 16-bit local_sw modes), and shapes
GROUP_SWEEP_N = (2048, 4096, 6144, 8192, 10240, 12288, 14336, 16384, 20480,
                 24576, 32768)
GROUP_SWEEP_SHAPES = ((216, 328), (BENCH_L, BENCH_L))

# the first designs' entry points: local_start_launch(Q, T, fwd, B, Lq,
# Lt, match, mismatch, n_score, goe, ge, gH, gE, col, strip, row, stream)
# and banded_sw_launch(mode, with_n, Q, T, qlen, tlen, B, Lq, Lt, k_band,
# match, mismatch, n_score, goe, ge, gH, gE, score, qend, tend, stream),
# time-major [L, B] inputs
_vp, _ci = ctypes.c_void_p, ctypes.c_int
PARENT_SIGNATURES = {
    "local_start": (_vp,) * 3 + (_ci,) * 8 + (_vp,) * 6,
    "banded_sw": (_ci, _ci) + (_vp,) * 4 + (_ci,) * 9 + (_vp,) * 6,
}
# local_sw_launch and semiglobal_sw_launch before they took a group (the
# third argument): every first design here, 299c71f's and 7fb004a's
for _key in (("local_sw", "local_sw_launch"),
             ("semiglobal_sw", "semiglobal_sw_launch")):
    _sig = cuda_align._SIGNATURES[_key]
    PARENT_SIGNATURES[_key[0]] = _sig[:2] + _sig[3:]


def ungrouped(args: tuple) -> tuple:
    """Launch arguments of this tree's local_sw / semiglobal_sw as a first
    design's entry point takes them: without the group."""
    return args[:2] + args[3:]
THREADS = "constexpr int kThreads = 128;\n"
ENGINE_START_B = 10_000   # about one engine start launch (216 x 328)
CLI_CHUNK = 5000          # models/aligner.py's chunk (GASAL2's STREAM_BATCH_SIZE)


def edits(src: str, pairs) -> str:
    for old, new in pairs:
        src = edit(src, old, new)
    return src


def pr9_variants(parent: Path) -> dict[str, str]:
    """{"<kernel>-<variant>": source} of local_sw's and
    semiglobal_start's variants."""
    csrc = parent / "genomics_tpu_torch" / "csrc"
    lp = (csrc / "local_sw.cu").read_text()
    sp = (csrc / "semiglobal_start.cu").read_text()
    lt = (_build.CSRC / "local_sw.cu").read_text()
    st = (_build.CSRC / "semiglobal_start.cu").read_text()
    return {
        "local_sw-parent": lp,
        "local_sw-parent-ahead": edit(lp, LOCAL_TOP, LOCAL_AHEAD),
        "local_sw-parent-bits": edit(lp, LOCAL_BITS, LOCAL_BITS_TG),
        "local_sw-parent-dpx": edits(lp, LOCAL_MAX),
        "local_sw-this-top": edit(lt, LOCAL_AHEAD, LOCAL_TOP),
        "local_sw-this": lt,
        "semiglobal_start-parent": sp,
        "semiglobal_start-parent-ahead": edit(sp, SEMI_TOP, SEMI_AHEAD),
        "semiglobal_start-parent-tailt": edits(sp, [
            (SEMI_CELL_CAPTURE, ""), (SEMI_COLUMN_END, SEMI_ONCE_CAPTURE)]),
        "semiglobal_start-parent-dpx": edits(sp, SEMI_MAX),
        "semiglobal_start-this-top": edit(st, SEMI_THIS_AHEAD, SEMI_TOP),
        "semiglobal_start-this-dpx": edits(st, SEMI_MAX),
        "semiglobal_start-this": st,
        "semiglobal_start-this-64": edit(st, THREADS,
                                         THREADS.replace("128", "64")),
    }


def start_band_variants(parent: Path) -> dict[str, str]:
    """{"<kernel>-<variant>": source} of local_start's and banded_sw's
    variants that need a source of their own."""
    csrc = parent / "genomics_tpu_torch" / "csrc"
    lp = (csrc / "local_start.cu").read_text()
    bp = (csrc / "banded_sw.cu").read_text()
    lt = (_build.CSRC / "local_start.cu").read_text()
    bt = (_build.CSRC / "banded_sw.cu").read_text()
    one_thread = edits(lt, [(START_SPLIT, START_ONE_THREAD + START_SPLIT),
                            (START_CASE4, START_CASE1 + START_CASE4)])
    return {
        "local_start-parent": lp,
        "local_start-parent-ahead": edit(lp, START_TOP, START_AHEAD),
        "local_start-this-g1": one_thread,
        "local_start-this-g1-top": edit(one_thread, START_THIS_AHEAD,
                                        START_THIS_TOP),
        "local_start-this-g2": edit(lt, START_CASE4, START_CASE2 + START_CASE4),
        "banded_sw-parent": bp,
        "banded_sw-this-top": edit(bt, BAND_AHEAD, BAND_TOP),
        "banded_sw-this-128": edit(bt, BAND_WARP_BLOCKS,
                                   BAND_WARP_BLOCKS.replace("32", "128")),
    }


def split_variants(parent: Path) -> dict[str, str]:
    """{"<kernel>-<variant>": source} of semiglobal_sw's and of the 16-bit
    local_sw modes' (family local_sw16) variants."""
    csrc = parent / "genomics_tpu_torch" / "csrc"
    sp = (csrc / "semiglobal_sw.cu").read_text()
    lp = (csrc / "local_sw.cu").read_text()
    st = (_build.CSRC / "semiglobal_sw.cu").read_text()
    lt = (_build.CSRC / "local_sw.cu").read_text()
    warp = THREADS.replace("128", "32")
    return {
        "semiglobal_sw-parent": sp,
        "semiglobal_sw-parent-ahead": edit(sp, SG_TOP, SG_AHEAD),
        "semiglobal_sw-parent-dpx": edits(sp, SG_MAX),
        "semiglobal_sw-parent-tailt": edits(sp, [
            (SG_CELL_CAPTURE, ""), (SG_COLUMN_END, SG_ONCE_CAPTURE)]),
        "semiglobal_sw-parent-extents": edits(sp, SG_EXTENTS),
        "semiglobal_sw-parent-32": edit(sp, THREADS, warp),
        "semiglobal_sw-this-full": edit(st, SG_THIS_EXTENTS, SG_THIS_FULL),
        "semiglobal_sw-this-top": edits(st, SG_THIS_LOADS),
        "semiglobal_sw-this-32": edit(st, THREADS, warp),
        "local_sw16-parent": lp,
        "local_sw16-parent-load16": edits(lp, L16_BYTES),
        "local_sw16-parent-32": edit(lp, THREADS, warp),
        "local_sw16-this-bytes": edit(lt, *L16_THIS_LOAD),
        "local_sw16-this-32": edit(lt, THREADS, warp),
        "local_sw16-this-shared": edits(lt, L16_THIS_SHARED),
    }


def entry(lib: ctypes.CDLL, key: tuple, sig: tuple | None = None):
    fn = getattr(lib, key[1])
    fn.argtypes = list(sig or cuda_align._SIGNATURES[key])
    fn.restype = ctypes.c_int
    return fn


def runner(fn, args, dev):
    """A launch of fn on args (tensors as their pointers) on dev's stream;
    returns args, whose last entries are the outputs."""
    ptrs = [x.data_ptr() if isinstance(x, torch.Tensor) else x for x in args]

    def run():
        err = fn(*ptrs, torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"{fn.__name__} failed: CUDA error {err}")
        return args
    return run


def second_args(Q, T, ql, tl, P):
    """local_sw_second_launch's arguments but the stream."""
    Lq, B = Q.shape
    out = [torch.empty(B, dtype=torch.int32, device=Q.device) for _ in range(6)]
    gH, gE = cuda_align._carry("local_sw", Q, T)
    return (Q, T, ql, tl, B, Lq, T.shape[0], P.match, P.mismatch,
            cuda_align._n_score(P), P.gap_oe, P.gap_extend, gH, gE, *out)


def sorted_start(fn, args, dev):
    """fn on args with the pairs ordered by row_count, as
    cuda_align.launch_semiglobal_start orders them: the argsort, the
    gathers and the inverse scatter of the starts inside the call."""
    def run():
        ordered, order = cuda_align.by_row_count(args)
        runner(fn, ordered, dev)()
        return [torch.empty_like(x).index_copy_(0, order, x)
                for x in ordered[-2:]]
    return run


def in_turns(fns: dict, reps: int, rounds: int) -> dict:
    """{name: [readings]}: each fn's mean ms over reps launches, the fns
    read forward then backward, `rounds` times."""
    ms = {k: [] for k in fns}
    for _ in range(rounds):
        for k in list(fns) + list(fns)[::-1]:
            ms[k].append(cuda_ms(fns[k], reps))
    return ms


def report(ms: dict, ref: str, what: str, smi: str):
    """One line per variant: the mean of its readings, their spread and
    the ratio of the means to `ref`'s."""
    base = np.mean(ms[ref])
    for k, v in ms.items():
        print(f"{k}: {np.mean(v):.4f} ms (readings {min(v):.4f}-"
              f"{max(v):.4f}; {np.mean(v) / base:.3f}x {ref}), {what}, "
              f"on {smi}", flush=True)


class Checks:
    """Word-for-word comparisons of each variant's output with the plain
    version's; `bad` lists the ones that differ."""

    def __init__(self):
        self.bad = []

    def __call__(self, name, got, want):
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            self.bad.append(name)


def bench_batch(dev):
    """bench.py's shape as chip_smoke.py phase 5 makes it: (q, t, qlen,
    tlen) on dev."""
    qn, tn, qln, tln = random_codes(np.random.default_rng(0), BENCH_B,
                                    BENCH_L, BENCH_L, 0.0)
    return [torch.from_numpy(x).to(dev) for x in (qn, tn, qln, tln)]


def time_local_sw(libs, srcs, dev, smi, rounds, check):
    """local_sw: every mode of every variant against the plain version,
    timed in SCORE, END, TB and SECOND."""
    q, t, ql, tl = bench_batch(dev)
    Q, T = q.T.contiguous(), t.T.contiguous()
    Qs, Ts = (cuda_align._pads_to_sentinels(x, c) for x, c in ((Q, 16), (T, 17)))
    P = AlignmentParams()
    plain = local_align_batch(q, t, P, with_tb=True)
    plain2 = scan_align_full.local_align_second_batch(q, t, ql, tl, P)
    local = {}
    for name in (n for n in srcs if n.startswith("local_sw-")):
        old = "parent" in name   # 299c71f's entry point takes no group
        launch = entry(libs[name], ("local_sw", "local_sw_launch"),
                       PARENT_SIGNATURES["local_sw"] if old else None)
        second = entry(libs[name], ("local_sw", "local_sw_second_launch"))
        for mode in ("score", "end", "tb"):
            a = (cuda_align.local_launch_args(mode, Qs, Ts, P, False)
                 if mode == "score" else
                 cuda_align.local_launch_args(mode, Q, T, P, True))
            local[f"{name} {mode}"] = runner(launch, ungrouped(a) if old
                                             else a, dev)
        local[f"{name} second"] = runner(second, second_args(Q, T, ql, tl, P),
                                         dev)
        for mode, want in (("score", plain[:1]), ("end", plain[:3]),
                           ("tb", plain)):
            check(f"{name} {mode}", local[f"{name} {mode}"]()[-4:], want)
        check(f"{name} second", local[f"{name} second"]()[-6:], plain2)
    torch.cuda.synchronize()
    del plain, plain2
    report(in_turns(local, 5, rounds), "local_sw-parent end",
           f"B={BENCH_B} {BENCH_L}x{BENCH_L}", smi)


def time_semiglobal_start(libs, srcs, dev, smi, rounds, check):
    """semiglobal_start: all 16 flags, each fed the forward END result,
    timed at NONE/BOTH in the launch's order and sorted; the parent and
    both block sizes at an engine start launch's size."""
    q, t, ql, tl = bench_batch(dev)
    PS = AlignmentParams(algo=AlgoType.SEMI_GLOBAL)
    skips = [SemiGlobalSkip.NONE, SemiGlobalSkip.QUERY,
             SemiGlobalSkip.TARGET, SemiGlobalSkip.BOTH]
    semi = [n for n in srcs if n.startswith("semiglobal_start")]
    timed = {}
    for head, tail in itertools.product(skips, skips):
        fwd = cuda_align.semiglobal_align(q, t, ql, tl, PS, head=head,
                                          tail=tail)
        rev = scan_align_full.semiglobal_start_inputs(q, t, ql, tl,
                                                      fwd.target_end)
        per = (ql, tl, *rev[2:], fwd.score, fwd.query_end)
        flags = scan_align_full.skip_flags(head, tail)
        want = scan_align_full._semiglobal_start_core(
            *rev[:2], *per, PS, **flags, count_strips=True)
        for name in semi:
            fn = entry(libs[name], ("semiglobal_start",
                                    "semiglobal_start_launch"))
            a = cuda_align.semiglobal_start_launch_args(
                rev[0].T, rev[1].T, *per, PS, **flags)
            run = runner(fn, a, dev)
            check(f"{name} {head.name}/{tail.name}", run()[-2:], want[:2])
            if (head, tail) == (SemiGlobalSkip.NONE, SemiGlobalSkip.BOTH):
                timed[name] = run
                srt = timed[f"{name} sorted"] = sorted_start(fn, a, dev)
                check(f"{name} sorted", srt(), want[:2])
                if name == "semiglobal_start-this":
                    ordered, _ = cuda_align.by_row_count(a)
                    timed[f"{name} on sorted inputs"] = runner(fn, ordered,
                                                               dev)
                    strips = want[2]
                    order = torch.argsort(a[6])
                    print(f"semiglobal_start NONE/BOTH: lanes' share of "
                          f"the strips {lane_share(strips):.4f} in the "
                          f"launch's order, "
                          f"{lane_share(strips[order]):.4f} sorted by "
                          f"row_count; {int(strips.sum())} strips",
                          flush=True)
    torch.cuda.synchronize()
    report(in_turns(timed, 10, rounds), "semiglobal_start-parent",
           f"NONE/BOTH, B={BENCH_B} {BENCH_L}x{BENCH_L}", smi)

    # the block size at an engine start launch's size
    qn, tn, qln, tln = random_codes(np.random.default_rng(1), ENGINE_START_B,
                                    216, 328, 0.0)
    q, t = torch.from_numpy(qn).to(dev), torch.from_numpy(tn).to(dev)
    ql, tl = torch.from_numpy(qln).to(dev), torch.from_numpy(tln).to(dev)
    sg = dict(head=SemiGlobalSkip.NONE, tail=SemiGlobalSkip.BOTH)
    fwd = cuda_align.semiglobal_align(q, t, ql, tl, PS, **sg)
    rev = scan_align_full.semiglobal_start_inputs(q, t, ql, tl, fwd.target_end)
    per = (ql, tl, *rev[2:], fwd.score, fwd.query_end)
    flags = scan_align_full.skip_flags(**sg)
    want = scan_align_full._semiglobal_start_core(*rev[:2], *per, PS, **flags)
    small = {}
    for name in ("semiglobal_start-parent", "semiglobal_start-this",
                 "semiglobal_start-this-64"):
        fn = entry(libs[name], ("semiglobal_start", "semiglobal_start_launch"))
        a = cuda_align.semiglobal_start_launch_args(rev[0].T, rev[1].T, *per,
                                                    PS, **flags)
        small[name] = runner(fn, a, dev)
        small[f"{name} sorted"] = sorted_start(fn, a, dev)
        check(f"{name} B={ENGINE_START_B}", small[name]()[-2:], want)
        check(f"{name} sorted B={ENGINE_START_B}", small[f"{name} sorted"](),
              want)
    report(in_turns(small, 20, rounds), "semiglobal_start-parent",
           f"NONE/BOTH, B={ENGINE_START_B} 216x328", smi)


def start_work(strip, col, qr8, Lq=None):
    """Columns each pair's start walk runs up to its stop (the recorded
    cell lies in the stop's column segment when the forward score is
    reached): strip x qr8 (or Lq, the full walk) + col + 1."""
    return strip.long() * (qr8.long() if Lq is None else Lq) + col + 1


def parent_start_ordered(fn, args, qr8, tr8, dev):
    """The first design's local_start on `args` (its entry point's
    order) with the pairs ordered by qr8 x tr8, as the port orders them:
    the argsort, the gathers and the scatter back inside the call."""
    def run():
        order = torch.argsort(qr8 * tr8, descending=True)
        outs = [torch.empty_like(x) for x in args[-3:]]
        runner(fn, (args[0].index_select(1, order),
                    args[1].index_select(1, order), args[2][order],
                    *args[3:-3], *outs), dev)()
        return [torch.empty_like(x).index_copy_(0, order, x) for x in outs]
    return run


def local_start_family(libs, dev, batch, smi, rounds, check, what, reps):
    """local_start's variants on one batch (q, t, qlen, tlen) fed the
    local_sw END kernel's forward result, timed in turns."""
    P = AlignmentParams()
    q, t, ql, tl = batch
    fwd = cuda_align.local_align(q, t, P)
    rq, rt, qr8, tr8 = scan_align_full.local_start_inputs(
        q, t, ql, tl, fwd.query_end, fwd.target_end)
    score = fwd.score
    want = scan_align_full._local_start_core(rq, rt, score, P)
    Q, T = rq.T.contiguous(), rt.T.contiguous()
    lib = lambda name: entry(libs[name], ("local_start", "local_start_launch"))
    full = cuda_align.local_start_launch_args(Q, T, score, P, group=1)
    ext = {g: cuda_align.local_start_launch_args(Q, T, score, P, qr8, tr8,
                                                 group=g) for g in (1, 2, 4, 8)}
    old = (Q, T, score, *full[6:14], *full[15:])   # the first design's order
    runs = {}
    for name in ("local_start-parent", "local_start-parent-ahead"):
        fn = entry(libs[name], ("local_start", "local_start_launch"),
                   PARENT_SIGNATURES["local_start"])
        runs[name] = runner(fn, old, dev)
        runs[f"{name} ordered"] = parent_start_ordered(fn, old, qr8, tr8, dev)
    one = lib("local_start-this-g1")
    runs["local_start-this-g1 full"] = runner(one, full, dev)
    runs["local_start-this-g1 unordered"] = runner(one, ext[1], dev)
    for name in ("local_start-this-g1", "local_start-this-g1-top"):
        runs[name] = (lambda fn=lib(name): runner(
            fn, cuda_align.local_start_order(ext[1]), dev)())
    runs["local_start-this-g2"] = lambda: runner(
        lib("local_start-this-g2"), cuda_align.local_start_order(ext[2]), dev)()
    for g in (4, 8):
        runs[f"local_start-this-g{g}"] = (
            lambda a=ext[g]: cuda_align.launch_local_start(a))
    this = entry(_build.library("local_start"),
                 ("local_start", "local_start_launch"))
    runs["local_start-this-g4 unordered"] = runner(this, ext[4], dev)
    for name, run in runs.items():
        check(f"{name} {what}", list(run())[-3:], want)
    torch.cuda.synchronize()
    # the lanes' share of the work under each ordering key, at the pairs a
    # warp of the port's threads a pair
    work = start_work(want[1], want[0], qr8)
    wp = 32 // cuda_align.split_group(Q.shape[1], cuda_align._sm_count(0))
    keys = {"launch order": None, "qr8 x tr8 (launched)": qr8 * tr8,
            "tr8": tr8, "the forward score": score, "the true stop": work}
    print(f"local_start {what}: lanes' share of the columns to the stop at "
          f"{wp} pairs a warp: "
          + ", ".join(f"{k} {lane_share(work if v is None else work[torch.argsort(v, descending=True)], wp):.4f}"
                      for k, v in keys.items())
          + f"; {int(work.sum())} columns to the extents, "
          f"{int(start_work(want[1], want[0], qr8, Q.shape[0]).sum())} "
          f"over the full Lq; the wrapper's threads a pair {32 // wp}",
          flush=True)
    report(in_turns(runs, reps, rounds), "local_start-parent", what, smi)


def parent_banded_ordered(fn, args, key, dev):
    """The first design's banded_sw on `args` (its entry point's order,
    time-major inputs) with the pairs ordered by key(), most first: the
    key, the argsort, the gathers and the scatter back inside the call."""
    def run():
        order = torch.argsort(key(), descending=True)
        outs = [torch.empty_like(x) for x in args[-3:]]
        runner(fn, (*args[:2], args[2].index_select(1, order),
                    args[3].index_select(1, order), args[4][order],
                    args[5][order], *args[6:-3], *outs), dev)()
        return [torch.empty_like(x).index_copy_(0, order, x) for x in outs]
    return run


def banded_ordered(fn, args, key, dev):
    """banded_sw on `banded_launch_args`'s arguments with the pairs
    ordered by key(), most first: the gathers of the [B, L] rows and the
    lengths and the scatter back inside the call (the key too, unless it
    is a tensor: then the inputs are gathered beforehand and only the
    scatter is timed)."""
    def gathered(order):
        return (*args[:3], *(x.index_select(0, order) for x in args[3:7]),
                *args[7:-3], *(None if x is None else torch.empty_like(x)
                               for x in args[-3:]))

    pre = None
    if isinstance(key, torch.Tensor):
        order = torch.argsort(key, descending=True)
        pre = gathered(order)

    def run():
        if pre is None:
            o = torch.argsort(key(), descending=True)
            a = gathered(o)
        else:
            o, a = order, pre
        runner(fn, a, dev)()
        return [None if x is None else torch.empty_like(x).index_copy_(0, o, x)
                for x in a[-3:]]
    return run


def banded_family(libs, dev, batch, smi, rounds, check, what, reps):
    """banded_sw's variants on one batch at a band of BENCH_BAND tiles,
    END and SCORE (without the N compare where the batch holds no N),
    timed in turns."""
    PB = AlignmentParams(algo=AlgoType.BANDED)
    q, t, ql, tl = batch
    B, Lq = q.shape
    Lt = t.shape[1]
    want = banded_align_batch(q, t, ql, tl, PB, BENCH_BAND)
    # SCORE drops the N compare only on a batch without Ns, as the engine
    qs, ts, score_n = cuda_align._no_n_inputs(q, t, has_ns(q, t, ql, tl))
    windows = band_windows(ql.cpu().numpy(), tl.cpu().numpy(), BENCH_BAND)
    work = torch.from_numpy(windows.sum(1)).to(dev)
    ring = cuda_align.banded_ring(Lq, Lt, BENCH_BAND)
    print(f"banded_sw {what}: lanes' share of the band tiles "
          f"{lane_share(work):.4f} in the launch's order, "
          f"{lane_share(work[torch.argsort(work, descending=True)]):.4f} "
          f"ordered by band tiles; {int(work.sum())} tiles; widest window "
          f"{8 * int(windows.max())} of {Lq} columns, the ring {ring}",
          flush=True)
    this = entry(_build.library("banded_sw"), ("banded_sw", "banded_sw_launch"))

    def tiles():   # the band tiles on the device, as the key costs there
        qr, tr = (ql + 7) // 8, (tl + 7) // 8
        ib = torch.arange(Lt // 8, device=dev)[None, :]
        lo = (ib - (tr - qr + BENCH_BAND)[:, None] + 1).clamp_min(0)
        hi = torch.minimum(ib + BENCH_BAND, qr[:, None])
        return torch.where(ib < tr[:, None], (hi - lo).clamp_min(0), 0).sum(1)
    runs = {}
    for mode in ("end", "score"):
        a, b, with_n = (q, t, True) if mode == "end" else (qs, ts, score_n)
        exp = want[:3] if mode == "end" else want[:1]
        # the first design: time-major inputs, [Lq, B] carries
        Qt, Tt = a.T.contiguous(), b.T.contiguous()
        gH, gE = cuda_align._carry("banded_sw", Qt, Tt)
        outs = [torch.empty(B, dtype=torch.int32, device=dev)
                for _ in range(3)]
        old = (int(mode == "end"), int(with_n), Qt, Tt, ql, tl, B, Lq, Lt,
               BENCH_BAND, PB.match, PB.mismatch, 0, PB.gap_oe,
               PB.gap_extend, gH, gE, *outs)
        fn = entry(libs["banded_sw-parent"], ("banded_sw", "banded_sw_launch"),
                   PARENT_SIGNATURES["banded_sw"])
        runs[f"banded_sw-parent {mode}"] = runner(fn, old, dev)
        runs[f"banded_sw-parent {mode} by tiles"] = parent_banded_ordered(
            fn, old, tiles, dev)
        args = cuda_align.banded_launch_args(mode, a, b, ql, tl, PB,
                                             BENCH_BAND, with_n)
        runs[f"banded_sw-this {mode}"] = (
            lambda x=args: cuda_align.launch_banded(x))
        runs[f"banded_sw-this {mode} by tiles"] = banded_ordered(
            this, args, tiles, dev)
        runs[f"banded_sw-this {mode} by tlen"] = banded_ordered(
            this, args, lambda: tl, dev)
        runs[f"banded_sw-this {mode} on sorted inputs"] = banded_ordered(
            this, args, work, dev)
        for variant, kw in (("ring Lq", dict(ring=Lq)),
                            ("global", dict(force_global=True))):
            va = cuda_align.banded_launch_args(mode, a, b, ql, tl, PB,
                                               BENCH_BAND, with_n, **kw)
            runs[f"banded_sw-this {mode} {variant}"] = (
                lambda x=va: cuda_align.launch_banded(x))
        for name in ("banded_sw-this-top", "banded_sw-this-128"):
            runs[f"{name} {mode}"] = runner(
                entry(libs[name], ("banded_sw", "banded_sw_launch")), args,
                dev)
        for name, run in runs.items():
            if f" {mode}" in name:
                check(f"{name} {what}", list(run())[-3:][:len(exp)], exp)
    torch.cuda.synchronize()
    report(in_turns(runs, reps, rounds), "banded_sw-parent end", what, smi)


def split_family(libs, dev, batch, smi, rounds, check, what, reps, skips):
    """semiglobal_sw END and TB under `skips` (head, tail) and the 16-bit
    local_sw modes (SCORE16 on the pads remapped, END16), each variant
    with one change against the next: the first design, its one-change
    variants and 32-thread blocks, this tree at every group and through
    the wrapper (the rule's group), this tree with END over every column
    and strip, with its loads at each column's top, with two byte loads,
    and with one-warp blocks at the rule's group; int32 SCORE / END of
    this tree beside them.  Timed in turns, every output held to the
    plain version; prints the lanes' share of END's work at the
    extents."""
    q, t, ql, tl = batch
    B = q.shape[0]
    Q, T = q.T.contiguous(), t.T.contiguous()
    sms = cuda_align._sm_count(0)
    head, tail = skips
    PS = AlignmentParams(algo=AlgoType.SEMI_GLOBAL)
    P = AlignmentParams()
    runs, runs16 = {}, {}
    if "semiglobal_sw-parent" in libs:
        for with_tb in (False, True):
            m = "tb" if with_tb else "end"
            want = semiglobal_align_batch(q, t, ql, tl, PS, head=head,
                                          tail=tail, with_tb=with_tb)
            args = {g: cuda_align.semiglobal_launch_args(
                Q, T, ql, tl, PS, head, tail, with_tb, group=g)
                for g in SPLIT_GROUPS}
            rule = cuda_align.split_group(B, sms)
            for name in (n for n in libs if n.startswith("semiglobal_sw-")):
                old = "parent" in name
                fn = entry(libs[name], ("semiglobal_sw", "semiglobal_sw_launch"),
                           PARENT_SIGNATURES["semiglobal_sw"] if old else None)
                if name == "semiglobal_sw-this-full" and with_tb:
                    continue   # TB walks everything already
                runs[f"{name} {m}"] = runner(
                    fn, ungrouped(args[4]) if old else args[rule], dev)
            for g in SPLIT_GROUPS:
                runs[f"semiglobal_sw-this {m} G={g}"] = (
                    lambda a=args[g]: cuda_align.launch_semiglobal(a))
            for name, run in runs.items():
                if name.startswith("semiglobal_sw") and f" {m}" in name:
                    check(f"{name} {what}", list(run())[-4:][:4 if with_tb
                                                             else 3],
                          want[:4 if with_tb else 3])
        # the lanes' share of END's work at the extents: strips x columns
        # per pair, at 32 / G pairs a warp
        tails = tail != SemiGlobalSkip.NONE
        work = (torch.clamp(ql, max=Q.shape[0]).long()
                * torch.clamp((tl + 7) // 8, max=T.shape[0] // 8).long()
                * int(tails))
        wp = 32 // cuda_align.split_group(B, sms)
        by = torch.argsort(work, descending=True)
        print(f"semiglobal_sw {what}, {head.name}/{tail.name}: END's lanes' "
              f"share of the columns x strips to the extents at {wp} pairs "
              f"a warp {lane_share(work, wp):.4f} in the pairs' order, "
              f"{lane_share(work[by], wp):.4f} were they ordered; "
              f"{int(work.sum())} of {B * Q.shape[0] * (T.shape[0] // 8)} "
              f"column-strips", flush=True)
    if "local_sw16-parent" in libs:
        Qs, Ts = (cuda_align._pads_to_sentinels(x, c) for x, c in ((Q, 16),
                                                                  (T, 17)))
        plain = local_align_batch16(Qs.T, Ts.T, P, ends=False)[:1]
        plain16 = local_align_batch16(q, t, P)[:3]
        rule = cuda_align.split_group((B + 1) // 2, sms)
        for m, (a, b, with_n), want in (
                ("score16", (Qs, Ts, False), plain),
                ("end16", (Q, T, True), plain16)):
            args = {g: cuda_align.local_launch_args(m, a, b, P, with_n,
                                                    group=g)
                    for g in SPLIT_GROUPS}
            for name in (n for n in libs if n.startswith("local_sw16-")):
                old = "parent" in name
                fn = entry(libs[name], ("local_sw", "local_sw_launch"),
                           PARENT_SIGNATURES["local_sw"] if old else None)
                runs16[f"{name} {m}"] = runner(
                    fn, ungrouped(args[4]) if old else args[rule], dev)
            for g in SPLIT_GROUPS:
                runs16[f"local_sw16-this {m} G={g}"] = (
                    lambda x=args[g]: cuda_align.launch_local(x))
            i32 = cuda_align.local_launch_args(m[:-2], a, b, P, with_n)
            runs16[f"local_sw-this {m[:-2]} (int32)"] = (
                lambda x=i32: cuda_align.launch_local(x))
            for name, run in runs16.items():
                if name.startswith("local_sw") and (f" {m}" in name or
                                                    f" {m[:-2]} (" in name):
                    check(f"{name} {what}", list(run())[-4:][:len(want)],
                          want)
    torch.cuda.synchronize()
    if runs:
        report(in_turns(runs, reps, rounds), "semiglobal_sw-parent end",
               f"{what}, {head.name}/{tail.name}", smi)
    if runs16:
        report(in_turns(runs16, reps, rounds), "local_sw16-parent score16",
               what, smi)


GROUP_KEYS = ("local_start", "semiglobal_sw.end", "semiglobal_sw.tb",
              "local_sw.score16", "local_sw.end16")


def group_times(batch, cuts, smi, rounds, check) -> dict:
    """{label: {"<key> G=<g>": ms}}: GROUP_KEYS at 4 and 8 threads a
    pair (pair pair) on the first n pairs of `batch` (q, t, qlen, tlen on
    the card) for each (n, n16, label) of `cuts` (n16 the 16-bit modes'
    pairs), through the launch helpers; launches alone in turns, every
    output held to the plain version (computed once on the largest cut:
    each pair's result is its own)."""
    P, PS = AlignmentParams(), AlignmentParams(algo=AlgoType.SEMI_GLOBAL)
    gl = (SemiGlobalSkip.TARGET, SemiGlobalSkip.TARGET)
    q, t, ql, tl = batch
    top, top16 = max(c[0] for c in cuts), max(c[1] for c in cuts)
    Q, T = q.T.contiguous(), t.T.contiguous()
    Qs, Ts = (cuda_align._pads_to_sentinels(x, c) for x, c in ((Q, 16),
                                                             (T, 17)))
    fwd = cuda_align.local_align(q[:top], t[:top], P)
    rq, rt, qr8, tr8 = scan_align_full.local_start_inputs(
        q[:top], t[:top], ql[:top], tl[:top], fwd.query_end, fwd.target_end)
    want = {
        "local_start": scan_align_full._local_start_core(rq, rt, fwd.score, P),
        "semiglobal_sw.end": semiglobal_align_batch(
            q[:top], t[:top], ql[:top], tl[:top], PS, *gl)[:3],
        "semiglobal_sw.tb": semiglobal_align_batch(
            q[:top], t[:top], ql[:top], tl[:top], PS, *gl, with_tb=True),
        "local_sw.score16": local_align_batch16(
            Qs[:, :top16].T, Ts[:, :top16].T, P, ends=False)[:1],
        "local_sw.end16": local_align_batch16(q[:top16], t[:top16], P)[:3],
    }
    out = {}
    for n, n16, label in cuts:
        runs = {}
        for g in SPLIT_GROUPS:
            a = cuda_align.local_start_launch_args(
                rq[:n].T, rt[:n].T, fwd.score[:n], P, qr8[:n], tr8[:n],
                group=g)
            runs[f"local_start G={g}"] = (
                lambda a=a: cuda_align.launch_local_start(a))
            for with_tb in (False, True):
                a = cuda_align.semiglobal_launch_args(
                    Q[:, :n], T[:, :n], ql[:n], tl[:n], PS, *gl, with_tb,
                    group=g)
                runs[f"semiglobal_sw.{'tb' if with_tb else 'end'} G={g}"] = (
                    lambda a=a: cuda_align.launch_semiglobal(a))
            for m, (a, b, with_n) in (("score16", (Qs, Ts, False)),
                                      ("end16", (Q, T, True))):
                a = cuda_align.local_launch_args(m, a[:, :n16], b[:, :n16],
                                                 P, with_n, group=g)
                runs[f"local_sw.{m} G={g}"] = (
                    lambda a=a: cuda_align.launch_local(a))
        for name, run in runs.items():
            key = name.split()[0]
            exp = [x[..., :n16 if key.startswith("local_sw") else n]
                   for x in want[key]]
            got = list(run())
            got = got[-3:] if key == "local_start" else got[:len(exp)]
            check(f"{name} groups {label}", got, exp)
        torch.cuda.synchronize()
        out[label] = {k: float(np.mean(v))
                      for k, v in in_turns(runs, 10, rounds).items()}
        print(f"groups at {label}: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in out[label].items())
            + f", on {smi}", flush=True)
    return out


def group_sweep(dev, smi, rounds, check):
    """split_group's data: GROUP_KEYS (semiglobal_sw at glocal's
    TARGET/TARGET) at 4 and 8 threads a pair (pair pair) over
    GROUP_SWEEP_N launch sizes at each of GROUP_SWEEP_SHAPES, and at the
    engine's own launches (chip_smoke.engine_batches of the 20,000
    GASAL2-shaped pairs).  Prints each launch's times and, per mode and
    shape, the least size from which 4 is no slower than 8 at every
    larger one, beside the least size at which split_group takes 4 on
    this card."""
    sms = cuda_align._sm_count(0)
    rule4 = next(n for n in itertools.count(1)
                 if cuda_align.split_group(n, sms) == 4)
    for lq, lt in GROUP_SWEEP_SHAPES:
        top = max(GROUP_SWEEP_N)
        batch = [torch.from_numpy(x).to(dev) for x in random_codes(
            np.random.default_rng(11), 2 * top, lq, lt, 0.0)]
        cuts = [(n, 2 * n, f"{n} pairs ({n} pair pairs) {lq}x{lt}, "
                 f"split_group {cuda_align.split_group(n, sms)}")
                for n in GROUP_SWEEP_N]
        times = group_times(batch, cuts, smi, rounds, check)
        for key in GROUP_KEYS:
            four = [n for n, _, label in cuts if all(
                times[lb][f"{key} G=4"] <= times[lb][f"{key} G=8"]
                for m, _, lb in cuts if m >= n)]
            print(f"groups {key} {lq}x{lt}: 4 no slower than 8 from "
                  f"{four[0] if four else None} pairs (pair pairs) on; "
                  f"split_group takes 4 from {rule4} on {sms} SMs, on {smi}",
                  flush=True)
    qs, ts = gasal_pairs(np.random.default_rng(0), PAIRS)
    for (lq, lt), arrays in engine_batches(qs, ts).items():
        B = len(arrays[0])
        batch = [torch.from_numpy(x).to(dev) for x in arrays]
        group_times(batch, [(B, B, f"B={B} {lq}x{lt} (an engine launch), "
                             f"split_group {cuda_align.split_group(B, sms)}"
                             f" / {cuda_align.split_group((B + 1) // 2, sms)}"
                             " (16-bit)")], smi, rounds, check)


# --kernels pairhmm: csrc/pairhmm_intertask.cu and pairhmm_wavefront.cu
# (csrc/pairhmm.cuh's template) against their first designs (DIR =
# 604c0a0): pairhmm_intertask_launch(reads [R8, B], haps [C, B], rlen,
# clen, 5 params [R8, B], B, R, R8, C, sM, sI, sD [C, B], out, stream) and
# pairhmm_wavefront_launch(reads [B, R], haps [B, C], rlen, clen, 5 params
# [B, R], B, R, C, sM, sI, sD [B, C], out, stream)
PH_PARENT_SIGNATURES = {
    "intertask": (_vp,) * 9 + (_ci,) * 4 + (_vp,) * 5,
    "wavefront": (_vp,) * 9 + (_ci,) * 3 + (_vp,) * 5,
}
# the first inter-task design with its last-row test taken once a column by
# the strip that holds row rlen - 1, not in every cell
PH_PARENT_LAST = [
    ("        if (r0 + i == last) acc = __fadd_rn(acc, __fadd_rn(Mn, In));\n",
     ""),
    ("    const bool first = r0 == 0, more = r0 + 8 < rows;\n",
     "    const bool first = r0 == 0, more = r0 + 8 < rows;\n"
     "    const int il = last - r0;\n"
     "    const bool has_last = il >= 0 && il < 8;\n"),
    ("      if (more) {  // row r0+7 is the next strip's row above\n",
     "      if (has_last) {\n"
     "        float m = Ml[0], i0 = Il[0];\n"
     "#pragma unroll\n"
     "        for (int i = 1; i < 8; ++i)\n"
     "          if (il == i) {\n"
     "            m = Ml[i];\n"
     "            i0 = Il[i];\n"
     "          }\n"
     "        acc = __fadd_rn(acc, __fadd_rn(m, i0));\n"
     "      }\n"
     "      if (more) {  // row r0+7 is the next strip's row above\n")]
# the first wavefront with lane 0's row-above loads one step ahead
PH_PARENT_AHEAD = [
    ("    float dM = 0.f, dI = 0.f, dD = (first && lane == 0) ? d0 : 0.f;\n",
     "    float dM = 0.f, dI = 0.f, dD = (first && lane == 0) ? d0 : 0.f;\n"
     "    float nM = 0.f, nI = 0.f, nD = first ? d0 : 0.f;\n"
     "    if (lane == 0 && !first && cols > 0) {\n"
     "      nM = sM[colp];\n"
     "      nI = sI[colp];\n"
     "      nD = sD[colp];\n"
     "    }\n"),
    ("""      if (lane == 0) {
        const bool in = c < cols;
        uM = (first || !in) ? 0.f : sM[colp + c];
        uI = (first || !in) ? 0.f : sI[colp + c];
        uD = first ? d0 : (in ? sD[colp + c] : 0.f);
      }
""", """      if (lane == 0) {
        uM = nM;
        uI = nI;
        uD = nD;
        if (!first) {
          const bool in = c + 1 < cols;
          nM = in ? sM[colp + c + 1] : 0.f;
          nI = in ? sI[colp + c + 1] : 0.f;
          nD = in ? sD[colp + c + 1] : 0.f;
        }
      }
""")]
# this tree's template with each lane's haplotype byte loaded at its step
PH_THIS_TOP = [
    ("      const int h = hn;\n"
     "      if (mine && c + 1 >= 0 && c + 1 < cols) hn = hap[c + 1];\n",
     "      const int h = (mine && c >= 0 && c < cols) ? hap[c] : 0;\n")]
# this tree's template with its step loop unrolled twice
PH_STEP_LOOP = "    for (int k = 0; k < steps; ++k) {\n"
PH_THIS_UNROLL2 = [(PH_STEP_LOOP, "#pragma unroll 2\n" + PH_STEP_LOOP)]
# this tree's template in 64-thread blocks (half the shared handover a block)
PH_THIS_64 = [("constexpr int kThreads = 128;\n",
               "constexpr int kThreads = 64;\n")]
PH_THIS_VARIANTS = {"top": PH_THIS_TOP, "unroll2": PH_THIS_UNROLL2,
                    "64": PH_THIS_64}


def with_header(src: str) -> str:
    """A csrc/pairhmm_*.cu source with csrc/pairhmm.cuh pasted in place of
    its #include, so that a variant builds on its own."""
    cuh = (_build.CSRC / "pairhmm.cuh").read_text()
    return edit(src, '#include "pairhmm.cuh"\n', edit(cuh, "#pragma once\n",
                                                      ""))


def pairhmm_variants(parent: Path) -> dict[str, str]:
    """{"pairhmm-<kernel>-<variant>": source} of the two PairHMM kernels'
    variants."""
    csrc = parent / "genomics_tpu_torch" / "csrc"
    out = {}
    for k in ("intertask", "wavefront"):
        first = (csrc / f"pairhmm_{k}.cu").read_text()
        this = with_header((_build.CSRC / f"pairhmm_{k}.cu").read_text())
        out[f"pairhmm-{k}-parent"] = first
        if k == "intertask":
            out[f"pairhmm-{k}-parent-last"] = edits(first, PH_PARENT_LAST)
        else:
            out[f"pairhmm-{k}-parent-ahead"] = edits(first, PH_PARENT_AHEAD)
        for v, change in PH_THIS_VARIANTS.items():
            out[f"pairhmm-{k}-this-{v}"] = edits(this, change)
    return out


def parent_pairhmm_args(kernel: str, t, p) -> tuple:
    """The first design's entry point's arguments but the stream for
    inputs t, p: the inter-task kernel's [R8, B] / [C, B] copies (made
    here, outside any timing) or the wavefront's inputs as they are, its
    three scratch rows and the [B] output, last."""
    from genomics_tpu_torch.ops import cuda_pairhmm

    reads, haps, rlen, clen = t
    B, R = reads.shape
    C = haps.shape[1]
    params = [p[k] for k in cuda_pairhmm.PARAMS]
    f32 = dict(dtype=torch.float32, device=reads.device)
    out = torch.empty(B, **f32)
    if kernel == "wavefront":
        return (reads, haps, rlen, clen, *params, B, R, C,
                *(torch.empty((B, C), **f32) for _ in range(3)), out)
    R8 = (R + 7) // 8 * 8
    pad = lambda x: torch.nn.functional.pad(x.T, (0, 0, 0, R8 - R))
    return (pad(reads).contiguous(), haps.T.contiguous(), rlen, clen,
            *(pad(x).contiguous() for x in params), B, R, R8, C,
            *(torch.empty((C, B), **f32) for _ in range(3)), out)


def pairhmm_family(libs, dev, smi, rounds, check):
    """Both PairHMM kernels at the launches chip_smoke.py phase 5 times
    (run_all.py's 16,384 x 128 x 128, the 65,536-pair region launch, a
    256-pair candidate launch, 1, 7 and 64 pairs of 250 x 500): the first
    design (its inter-task wrapper's transposes and pads counted too), its
    one-change variant, this tree at every group (inter-task) or rows a
    lane (wavefront), in the rule's handover layout and the global one, at
    the rule's shape with the byte loads at each step and with the last
    row tested in every cell, and the other kernel of this tree on the
    same launch; launches alone, in turns, each held to the plain version
    bit for bit."""
    from chip_smoke import (F32_OPS_PER_CELL, bound, fp32_peak,
                            pairhmm_steps, pairhmm_timing_launches,
                            region_records)
    from genomics_tpu_torch.ops import cuda_pairhmm, scan_pairhmm

    f_peak = fp32_peak()
    sms = cuda_align._sm_count(dev.index or 0)
    _, flat = region_records(0)
    for label, (t, p, kern) in pairhmm_timing_launches(dev, flat, 0).items():
        B, R = t[0].shape
        C = t[1].shape[1]
        want = scan_pairhmm.forward_prepared(*t, p)
        cells = int((t[2].long() * t[3].long()).sum())
        b_ms, b_by = bound(F32_OPS_PER_CELL * cells,
                           B * (R + C + 5 * 4 * R + 3 * 4), f_peak)
        reps = 10 if B * R * C > 1e9 else 50
        for k in (x.split(".")[1] for x in kern):
            runs, steps = {}, {}
            first = parent_pairhmm_args(k, t, p)
            for name in (n for n in libs
                         if n.startswith(f"pairhmm-{k}-parent")):
                fn = entry(libs[name], (f"pairhmm_{k}", f"pairhmm_{k}_launch"),
                           PH_PARENT_SIGNATURES[k])
                runs[name] = runner(fn, first, dev)
            steps[f"pairhmm-{k}-parent"] = (pairhmm_steps(1, 8, R, C)
                                            if k == "intertask" else
                                            pairhmm_steps(32, 1, R, C))
            if k == "intertask":
                def parent_wrapper(fn=entry(
                        libs["pairhmm-intertask-parent"],
                        ("pairhmm_intertask", "pairhmm_intertask_launch"),
                        PH_PARENT_SIGNATURES[k])):
                    return runner(fn, parent_pairhmm_args(k, t, p), dev)()
                runs["pairhmm-intertask-parent (with its transposes)"] = \
                    parent_wrapper
            shapes = (cuda_pairhmm.INTERTASK_SHAPES if k == "intertask"
                      else [(32, r) for r in cuda_pairhmm.WAVEFRONT_ROWS])
            sig = getattr(cuda_pairhmm, f"_{k.upper()}_ARGS")
            rule = (cuda_pairhmm.intertask_shape(R, B, sms) if k == "intertask"
                    else (32, cuda_pairhmm.wavefront_rows(R)))
            for g, r in shapes:
                mark = " (the rule)" if (g, r) == rule else ""
                for force in (False, True):
                    kind = cuda_pairhmm.handover_layout(R, C, g, r)
                    if force and kind == "none":
                        continue
                    lay = (cuda_pairhmm.intertask_layout(
                        *t, p, shape=(g, r), force_global=force)
                        if k == "intertask" else cuda_pairhmm.wavefront_layout(
                            *t, p, rows_per_lane=r, force_global=force))
                    name = (f"pairhmm-{k}-this G={g} K={r} "
                            f"{'global' if force else kind}{mark}")
                    runs[name] = functools.partial(
                        getattr(cuda_pairhmm, f"launch_{k}"), lay)
                    steps[name] = pairhmm_steps(g, r, R, C)
                    if mark and not force:
                        for v in PH_THIS_VARIANTS:
                            runs[f"pairhmm-{k}-this-{v}{mark}"] = runner(
                                entry(libs[f"pairhmm-{k}-this-{v}"],
                                      (f"pairhmm_{k}", f"pairhmm_{k}_launch"),
                                      sig), lay, dev)
            other = "wavefront" if k == "intertask" else "intertask"
            runs[f"pairhmm-{other}-this at this launch (its rule)"] = (
                lambda o=other: getattr(
                    cuda_pairhmm, "pairhmm_forward_prepared" if o ==
                    "wavefront" else "pairhmm_forward_intertask_prepared")(
                        *t, p))
            for name, run in runs.items():
                got = run()
                got = got[-1] if isinstance(got, tuple) else got
                check(f"{name} {label}", [got.view(torch.int32)],
                      [want.view(torch.int32)])
            torch.cuda.synchronize()
            print(f"pairhmm {k} at {label}: bound {b_ms:.6f} ms by {b_by} "
                  f"({cells} cells x {F32_OPS_PER_CELL} f32 op); serial "
                  "steps a pair " + ", ".join(
                      f"{n.split(' ')[0] if 'parent' in n else n}: {v}"
                      for n, v in steps.items()), flush=True)
            report(in_turns(runs, reps, rounds), f"pairhmm-{k}-parent",
                   f"pairhmm {k} at {label}", smi)


# --kernels tb_walk,myers: csrc/tb_walk.cu and csrc/myers.cu against their
# first designs (DIR = 32913d8): tb_walk_launch(algo, tb, score, qend,
# tend, B, Lq, Lt8, match, mismatch, goe, ge, ops [Lq + Lt, B], qfin, tfin,
# stream), the op stream the host then encodes, and myers_launch(eq [4W,
# B], texts [Lt, B], plen, tlen, B, W, Lt, state, best, end, final,
# stream), batch-innermost copies of the inputs
WALK_PARENT_ARGS = (_ci,) + (_vp,) * 4 + (_ci,) * 7 + (_vp,) * 4
MYERS_PARENT_ARGS = (_vp,) * 4 + (_ci,) * 3 + (_vp,) * 5
# design A, the window in shared memory (csrc/tb_walk.cu: kWindow,
# kDiagonal, kAdaptive, kThreads) or in registers
# (tools/tb_walk_registers.cu: those and kCounter)
WALK_SMEM = [dict(kWindow=k, kDiagonal=diag, kAdaptive=adapt)
             for diag, ks in ((False, (4, 8, 16)), (True, (8, 16, 32)))
             for k in ks for adapt in (False, True)] + [
    dict(kWindow=8, kDiagonal=False, kAdaptive=False, kThreads=32),
    dict(kWindow=16, kDiagonal=True, kAdaptive=True, kThreads=32)]
WALK_REGISTERS = [dict(kWindow=k, kDiagonal=diag, kAdaptive=False,
                       kCounter=counter)
                  for k, diag in ((4, False), (8, False), (8, True))
                  for counter in (False, True)]
WALK_LANES = [(4, False), (8, False), (32, False), (8, True)]   # B: kGroup, kCounter
# the L2's fetch granularity at 32 bytes (a word read pulls one sector, not
# two) around a launch: restored once the launch is made, or once the
# kernel has run (the stream synchronised, then restored)
FETCH32 = ("  size_t fetch = 0;\n"
           "  cudaDeviceGetLimit(&fetch, cudaLimitMaxL2FetchGranularity);\n"
           "  cudaDeviceSetLimit(cudaLimitMaxL2FetchGranularity, 32);\n")
FETCH_BACK = "  cudaDeviceSetLimit(cudaLimitMaxL2FetchGranularity, fetch);\n"
FETCH_SYNC = ("  cudaStreamSynchronize(static_cast<cudaStream_t>(stream));\n"
              + FETCH_BACK)
WALK_PARENT_RETURN = "      static_cast<int*>(qfin), static_cast<int*>(tfin));\n"
WALK_LAUNCH = "  tb_walk_kernel<kWindow, kDiagonal, kAdaptive>\n"
WALK_RETURN = "         static_cast<cudaStream_t>(stream)>>>(a);\n"
WALK_PARENT_LAUNCH = "  tb_walk_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(\n"
MYERS_THREADS = (128, 64)
MYERS_CHUNKS = (32, 64)
# myers.cu's step with predicated selects in place of its branch on
# `active`, and one word at a time as the first design stepped (word_step:
# the carry and the shifted-out bits by compares and shifts, the score
# bits of word lastw by a test in every word)
MYERS_BRANCH = """      if (c == 255 || j >= tl) continue;   // the state stays, j counts
      int dscore = 0;
      if constexpr (WR > 0) {
        uint32_t ev[NR];
#pragma unroll
        for (int w = 0; w < NR; ++w)
          ev[w] = select_eq(c, e[0][w], e[1][w], e[2][w], e[3][w]);
        dscore = step_words<NR>(ev, pv, mv, tm);
      } else {
"""
MYERS_PREDICATED = [(MYERS_BRANCH, """      const bool active = c != 255 && j < tl;
      int dscore = 0;
      if constexpr (WR > 0) {
        uint32_t ev[NR], p[NR], q[NR];
#pragma unroll
        for (int w = 0; w < NR; ++w) {
          ev[w] = select_eq(c, e[0][w], e[1][w], e[2][w], e[3][w]);
          p[w] = pv[w];
          q[w] = mv[w];
        }
        dscore = step_words<NR>(ev, p, q, tm);
        dscore = active ? dscore : 0;
#pragma unroll
        for (int w = 0; w < NR; ++w) {
          pv[w] = active ? p[w] : pv[w];
          mv[w] = active ? q[w] : mv[w];
        }
      } else if (active) {
""")]
MYERS_WORD_STEP = [("        dscore = step_words<NR>(ev, pv, mv, tm);\n", """        uint32_t cin = 0u, cbp = 0u, cbm = 0u;
#pragma unroll
        for (int w = 0; w < NR; ++w)
          word_step(ev[w], pv[w], mv[w], cin, cbp, cbm, w == lastw, topb,
                    dscore);
""")]


def set_consts(src: str, **values) -> str:
    """src with each `constexpr <type> <name> = ...;` set to values[name]."""
    for name, v in values.items():
        m = re.search(rf"constexpr (\w+) {name} = [^;]+;", src)
        v = str(v).lower() if isinstance(v, bool) else str(v)
        src = edit(src, m.group(0), f"constexpr {m.group(1)} {name} = {v};")
    return src


def walk_myers_variants(parent: Path) -> dict[str, str]:
    """{"<kernel>-<variant>": source} of the walk's and Myers' variants:
    the first designs, design A at each window (two rows or the diagonal
    word), each with the counter, design B at each group with and without
    the counter, Myers at each block size and chunk."""
    csrc = parent / "genomics_tpu_torch" / "csrc"
    wt = (_build.CSRC / "tb_walk.cu").read_text()
    lanes = (ROOT / "tools" / "tb_walk_lanes.cu").read_text()
    mt = (_build.CSRC / "myers.cu").read_text()
    regs = (ROOT / "tools" / "tb_walk_registers.cu").read_text()
    out = {"tb_walk-parent": (csrc / "tb_walk.cu").read_text(),
           "myers-parent": (csrc / "myers.cu").read_text()}
    for kind, src, shapes in (("smem", wt, WALK_SMEM),
                              ("reg", regs, WALK_REGISTERS)):
        for c in shapes:
            name = (f"tb_walk-{kind}-{'diag' if c['kDiagonal'] else 'rows2'}"
                    f"-K{c['kWindow']}{'-adapt' if c['kAdaptive'] else ''}"
                    f"{'-counter' if c.get('kCounter') else ''}"
                    f"{'-T32' if c.get('kThreads') == 32 else ''}")
            out[name] = set_consts(src, **c)
    out["tb_walk-smem-rows2-K8-fetch32"] = edits(wt, [
        (WALK_LAUNCH, FETCH32 + WALK_LAUNCH),
        (WALK_RETURN, WALK_RETURN + FETCH_BACK)])
    out["tb_walk-smem-rows2-K8-sync"] = edits(wt, [
        (WALK_RETURN, WALK_RETURN + FETCH_SYNC.split("\n")[0] + "\n")])
    out["tb_walk-smem-rows2-K8-fetch32-sync"] = edits(wt, [
        (WALK_LAUNCH, FETCH32 + WALK_LAUNCH),
        (WALK_RETURN, WALK_RETURN + FETCH_SYNC)])
    out["tb_walk-smem-diag-K8-adapt-fetch32"] = edits(
        set_consts(wt, kDiagonal=True, kAdaptive=True), [
            (WALK_LAUNCH, FETCH32 + WALK_LAUNCH),
            (WALK_RETURN, WALK_RETURN + FETCH_BACK)])
    out["tb_walk-parent-fetch32-sync"] = edits(out["tb_walk-parent"], [
        (WALK_PARENT_LAUNCH, FETCH32 + WALK_PARENT_LAUNCH),
        (WALK_PARENT_RETURN, WALK_PARENT_RETURN + FETCH_SYNC)])
    for g, counter in WALK_LANES:
        out[f"tb_walk-lanes-G{g}{'-counter' if counter else ''}"] = (
            set_consts(lanes, kGroup=g, kCounter=counter))
    for threads in MYERS_THREADS:
        for chunk in MYERS_CHUNKS:
            out[f"myers-T{threads}-C{chunk}"] = set_consts(
                mt, kThreads=threads, kChunk=chunk)
    out["myers-this-predicated"] = edits(mt, MYERS_PREDICATED)
    out["myers-this-word-step"] = edits(mt, MYERS_WORD_STEP)
    return out


def walk_cases(dev) -> dict:
    """{label: {mode: walk_cigars' arguments}}: bench.py's shape and the
    engine's two launches, LOCAL, GLOBAL and SEMI_GLOBAL on the TB
    kernels' cubes (bench.py's NONE/BOTH; glocal's TARGET/TARGET at the
    engine's launches), as chip_smoke.py phase 5 makes them."""
    from genomics_tpu_torch.runtime.dispatch import walk_start

    P = AlignmentParams()
    PG = AlignmentParams(algo=AlgoType.GLOBAL)
    PS = AlignmentParams(algo=AlgoType.SEMI_GLOBAL)
    batches = {f"B={BENCH_B} {BENCH_L}x{BENCH_L}": (
        bench_batch(dev), (SemiGlobalSkip.NONE, SemiGlobalSkip.BOTH))}
    qs, ts = gasal_pairs(np.random.default_rng(0), PAIRS)
    for (lq, lt), arrays in engine_batches(qs, ts).items():
        batches[f"B={len(arrays[0])} {lq}x{lt} (an engine launch)"] = (
            [torch.from_numpy(x).to(dev) for x in arrays],
            (SemiGlobalSkip.TARGET, SemiGlobalSkip.TARGET))
    out = {}
    for label, ((q, t, ql, tl), (head, tail)) in batches.items():
        r_l = cuda_align.local_align(q, t, P, with_tb=True)
        r_g = cuda_align.global_align(q, t, ql, tl, PG, with_tb=True)
        r_s = cuda_align.semiglobal_align(q, t, ql, tl, PS, head=head,
                                          tail=tail, with_tb=True)
        i0, j0 = walk_start(AlgoType.SEMI_GLOBAL, tail, r_s, ql, tl)
        out[label] = {
            "local": (r_l.tb, r_l.score, r_l.query_end, r_l.target_end, P,
                      "local"),
            "global": (r_g.tb, r_g.score, ql, tl, PG, "global"),
            "semiglobal": (r_s.tb, r_s.score, j0, i0, PS, "semiglobal",
                           bool(head & SemiGlobalSkip.QUERY),
                           bool(head & SemiGlobalSkip.TARGET))}
    return out


def walk_family(libs, dev, smi, rounds, check):
    """Every walk variant at each case of walk_cases: the first design's
    op stream as a launch alone (held to tb_walk_plain's) and with the
    host encode that followed it (held to the plain version's bytes),
    then each variant's launch alone on walk_launch_args' outputs, held
    to the plain version's bytes, n_ops and starts; launches alone, in
    turns."""
    from chip_smoke import walk_err
    from genomics_tpu_torch.ops import tb_walk

    for label, modes in walk_cases(dev).items():
        reps = 10 if label.startswith(f"B={BENCH_B}") else 20
        for mode, a in modes.items():
            want = tb_walk.walk_cigars_plain(*a)
            plain_ops = tb_walk.tb_walk_plain(*a[:6])
            tb, score, qend, tend, p = a[:5]
            Lt8, Lq, B = tb.shape
            ops = torch.empty((Lq + 8 * Lt8, B), dtype=torch.uint8, device=dev)
            qfin, tfin = (torch.empty(B, dtype=torch.int32, device=dev)
                          for _ in range(2))
            first = (tb_walk._ALGOS[mode], tb, score, qend, tend, B, Lq, Lt8,
                     p.match, p.mismatch, p.gap_oe, p.gap_extend, ops, qfin,
                     tfin)
            runs = {}
            for name in (n for n in libs if n.startswith("tb_walk-parent")):
                runs[name] = runner(entry(libs[name], (
                    "tb_walk", "tb_walk_launch"), WALK_PARENT_ARGS), first,
                    dev)
                runs[name]()
                check(f"{name} {mode} {label}", [ops, qfin, tfin],
                      list(plain_ops))

            def parent_encoded(run=runs["tb_walk-parent"], a=a):
                run()
                return tb_walk.cigars_from_walk(
                    ops.cpu().numpy(), qfin.cpu().numpy(),
                    tfin.cpu().numpy(), mode, *a[6:])
            enc = parent_encoded()
            check(f"tb_walk-parent + host encode {mode} {label}",
                  [torch.from_numpy(x) for x in enc[1:]],
                  [w.cpu() for w in want[1:]])
            lay = tb_walk.walk_launch_args(*a)
            for name in (n for n in libs if n.startswith("tb_walk-")
                         and not n.startswith("tb_walk-parent")):
                fn = entry(libs[name], ("tb_walk", "tb_walk_launch"),
                           tb_walk._ARGS)

                def run(go=runner(fn, lay, dev)):
                    return go()[-4:]
                runs[name] = run
                if walk_err(run(), want):
                    check.bad.append(f"{name} {mode} {label}")
            torch.cuda.synchronize()
            ms = in_turns(runs, reps, rounds)
            ms["tb_walk-parent + host encode"] = [
                cuda_ms(parent_encoded, 1) for _ in range(2)]
            report(ms, "tb_walk-parent", f"walk {mode} at {label}", smi)


def myers_family(libs, dev, smi, rounds, check):
    """Myers at run_all.py's 16,384 x 96 x 152 (W = 3) and the `ed`
    stage's 65,536 reads against 200 bp windows (W = 5): the first
    design as a launch alone on its batch-innermost copies and with the
    wrapper's transposes, each block size and chunk of this tree as a
    launch alone and this tree's wrapper; held to the plain version."""
    from chip_smoke import ED_PAIRS, MY_B, MY_LP, MY_LT, ed_pairs
    from genomics_tpu_torch.ops import myers

    r5 = np.random.default_rng(0)
    pats = r5.integers(0, 4, (MY_B, MY_LP)).astype(np.uint8)
    cases = {f"B={MY_B} Lp {MY_LP} Lt {MY_LT} (run_all.py)": [
        torch.from_numpy(x).to(dev) for x in (
            myers.build_eq_masks(pats, np.full(MY_B, MY_LP, np.int32), 3),
            np.full(MY_B, MY_LP, np.int32),
            r5.integers(0, 4, (MY_B, MY_LT)).astype(np.uint8),
            np.full(MY_B, MY_LT, np.int32))]}
    reads, wins = ed_pairs(np.random.default_rng(5), ED_PAIRS)
    cases[f"B={ED_PAIRS} 150 x 200 (the ed stage)"] = [
        torch.from_numpy(x).to(dev) for x in myers.encode_batch(reads, wins)]
    for label, m in cases.items():
        want = myers.myers_batch_plain(*m)
        eq, plen, texts, tlen = m
        B, _, W = eq.shape
        Lt = texts.shape[1]

        def parent_args():
            return (eq.view(torch.int32).permute(1, 2, 0).reshape(4 * W, B)
                    .contiguous(), texts.T.contiguous(), plen, tlen, B, W, Lt,
                    None, *(torch.empty(B, dtype=torch.int32, device=dev)
                            for _ in range(3)))
        fn = entry(libs["myers-parent"], ("myers", "myers_launch"),
                   MYERS_PARENT_ARGS)
        runs = {"myers-parent": runner(fn, parent_args(), dev),
                "myers-parent (with its wrapper's transposes)":
                    lambda fn=fn: runner(fn, parent_args(), dev)()}
        lay = myers.myers_layout(*m)
        for name in (n for n in libs if n.startswith(("myers-T",
                                                       "myers-this"))):
            runs[name] = runner(entry(libs[name], ("myers", "myers_launch"),
                                      myers._ARGS), lay, dev)
        runs["myers this tree's wrapper"] = lambda m=m: myers.myers_batch(*m)
        for name, run in runs.items():
            check(f"{name} {label}", list(run())[-3:], list(want))
        torch.cuda.synchronize()
        report(in_turns(runs, 50, rounds), "myers-parent", f"myers at {label}",
               smi)


def engine_families(libs, kernels, dev, smi, rounds, check):
    """The families that run at bench.py's shape, the engine's launches
    and (local_sw16) the align CLI's: semiglobal_sw, local_sw16,
    local_start and banded_sw."""
    batches = {f"B={BENCH_B} {BENCH_L}x{BENCH_L}": bench_batch(dev)}
    qs, ts = gasal_pairs(np.random.default_rng(0), PAIRS)
    for (lq, lt), arrays in engine_batches(qs, ts).items():
        batches[f"B={len(arrays[0])} {lq}x{lt} (an engine launch)"] = [
            torch.from_numpy(x).to(dev) for x in arrays]
    cli = {}   # the align CLI's launches: one chunk of CLI_CHUNK pairs
    if "local_sw16" in kernels:
        for (lq, lt), arrays in engine_batches(qs[:CLI_CHUNK],
                                               ts[:CLI_CHUNK]).items():
            cli[f"B={len(arrays[0])} {lq}x{lt} (a CLI chunk's launch)"] = [
                torch.from_numpy(x).to(dev) for x in arrays]
    for what, batch in (batches | cli).items():
        reps = 10 if what.startswith(f"B={BENCH_B}") else 20
        if set(SPLIT_KERNELS) & set(kernels):
            # bench.py's SEMI_GLOBAL skips at its shape, glocal's at the
            # engine's launches; the CLI's launches run LOCAL only
            skips = ((SemiGlobalSkip.NONE, SemiGlobalSkip.BOTH)
                     if what.startswith(f"B={BENCH_B}") else
                     (SemiGlobalSkip.TARGET, SemiGlobalSkip.TARGET))
            fam = {k: v for k, v in libs.items()
                   if k.split("-")[0] in SPLIT_KERNELS
                   and not (what in cli and k.startswith("semiglobal"))}
            split_family(fam, dev, batch, smi, rounds, check, what,
                         reps, skips)
        if what in cli:
            continue
        if "local_start" in kernels:
            local_start_family(libs, dev, batch, smi, rounds, check,
                               what, reps)
        if "banded_sw" in kernels:
            banded_family(libs, dev, batch, smi, rounds, check, what,
                          reps)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="needed by every family but groups")
    ap.add_argument("--kernels", default="semiglobal_sw,local_sw16",
                    help="comma-separated families: local_sw, "
                         "semiglobal_start, local_start, banded_sw, "
                         "semiglobal_sw, local_sw16, groups, pairhmm, "
                         "tb_walk, myers")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "kernel_variants"))
    ap.add_argument("--rounds", type=int, default=2,
                    help="forward-and-backward passes over the variants")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    kernels = args.kernels.split(",")
    if set(kernels) - {"groups"} and not args.parent:
        ap.error("--parent is needed by every family but groups")
    srcs = {}
    if {"local_sw", "semiglobal_start"} & set(kernels):
        srcs |= pr9_variants(Path(args.parent))
    if {"local_start", "banded_sw"} & set(kernels):
        srcs |= start_band_variants(Path(args.parent))
    if set(SPLIT_KERNELS) & set(kernels):
        srcs |= split_variants(Path(args.parent))
    if "pairhmm" in kernels:
        srcs |= pairhmm_variants(Path(args.parent))
    if {"tb_walk", "myers"} & set(kernels):
        srcs |= walk_myers_variants(Path(args.parent))
    srcs = {k: v for k, v in srcs.items() if k.split("-")[0] in kernels}
    out = Path(args.out)
    build_variants(srcs, out)
    libs = {name: ctypes.CDLL(str(out / f"{name}.so")) for name in srcs}
    smi = nvidia_smi()
    dev = torch.device("cuda", 0)
    check = Checks()
    if "local_sw" in kernels:
        time_local_sw(libs, srcs, dev, smi, args.rounds, check)
    if "semiglobal_start" in kernels:
        time_semiglobal_start(libs, srcs, dev, smi, args.rounds, check)
    if "groups" in kernels:
        group_sweep(dev, smi, args.rounds, check)
    if "pairhmm" in kernels:
        pairhmm_family(libs, dev, smi, args.rounds, check)
    if "tb_walk" in kernels:
        walk_family(libs, dev, smi, args.rounds, check)
    if "myers" in kernels:
        myers_family(libs, dev, smi, args.rounds, check)
    if {"local_start", "banded_sw", *SPLIT_KERNELS} & set(kernels):
        engine_families(libs, kernels, dev, smi, args.rounds, check)
    print(json.dumps({"all equal to the plain versions": not check.bad,
                      "disagree": check.bad}), flush=True)
    return 1 if check.bad else 0


if __name__ == "__main__":
    sys.exit(main())
