"""genomics_tpu_torch — the PyTorch + CUDA port of genomics_tpu.

The JAX package `genomics_tpu` stays the reference; this package gives
the same results on an NVIDIA Hopper card and never imports JAX.  So far
it ports the LOCAL, GLOBAL and SEMI_GLOBAL paths of `AlignEngine`:
bucketing, the DP kernels (scores, ends, traceback nibbles), the
traceback walk and the byte-CIGARs.

Layer map (the JAX package's names):
  core/     encoding, scoring parameters, the pure-Python golds
  ops/      plain PyTorch versions and the wrappers of the CUDA kernels
  csrc/     the hand-written CUDA kernels, built at first use (_build.py)
  runtime/  bucketed batched dispatch
"""

from genomics_tpu_torch.core.scoring import (  # noqa: F401
    AlignmentParams,
    AlgoType,
    SemiGlobalSkip,
)
from genomics_tpu_torch.runtime.dispatch import AlignEngine, AlignmentJob  # noqa: F401
