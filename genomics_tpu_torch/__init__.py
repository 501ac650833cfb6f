"""genomics_tpu_torch — the PyTorch + CUDA port of genomics_tpu.

The JAX package `genomics_tpu` stays the reference; this package gives
the same results on an NVIDIA Hopper card and never imports JAX.  So far
it ports `AlignEngine` (all five GASAL2 algorithms: bucketing, the DP
kernels, the traceback walk and the byte-CIGARs) with the GASAL2 facade
over it (`models.aligner`, the CLI's `align`), the PairHMM likelihoods,
Myers edit distance, the NW / SW / MSA apps and the read mapper with
its indexes.

Layer map (the JAX package's names):
  core/      encoding, scoring parameters, batch containers, the
             pure-Python golds
  index/     q-gram, FM, bidirectional and set-BWT indexes (host numpy)
  ops/       plain PyTorch versions and the wrappers of the CUDA kernels
  csrc/      the hand-written CUDA kernels, built at first use (_build.py)
  runtime/   bucketed batched dispatch; the native library's loader
  models/    the GASAL2 facade, PairHMM, the apps, the mapper and MAPQ
  utils/     FASTA / FASTQ, SAM and BAM IO
  device.py  the device policy: the card unless told, no CPU fallback
"""

from genomics_tpu_torch.core.scoring import (  # noqa: F401
    AlignmentParams,
    AlgoType,
    SemiGlobalSkip,
)
from genomics_tpu_torch.core.batch import PairBatch, SeqBatch  # noqa: F401
from genomics_tpu_torch.runtime.dispatch import AlignEngine, AlignmentJob  # noqa: F401
