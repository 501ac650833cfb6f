"""Indexing structures, host numpy as in the JAX package (reference:
CDP/NvB/nvbio/{qgram,fmindex,sufsort}, nvSetBWT):

  qgram     q-gram (seed) index: build + batched lookup
  fmindex   BWT/FM-index: backward search, locate, inexact and
            bidirectional search (its device search is ops/fm_search)
  wavelet   wavelet tree (rank over a small alphabet)
  setbwt    FM-index over a read set, and the nvFM-server query loop
  bloom     Bloom filter of the error corrector's trusted k-mers
"""
from genomics_tpu_torch.index.qgram import QGramIndex  # noqa: F401
from genomics_tpu_torch.index.fmindex import FMIndex  # noqa: F401
