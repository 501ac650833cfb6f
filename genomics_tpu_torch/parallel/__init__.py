"""Distributed layer on `torch.distributed`: the port's counterpart of
`genomics_tpu/parallel/`.

Replaces the reference's MPI communication (nGIA,
CDP/CLUSTER/cluster/src/func.cu:237-318,520: Gather + min-reduce + Bcast
each round, a final Gather) and the multi-GPU cudaSetDevice loops
(CDP/STAR/cuda-nw.cu:358-431) with a process group over a `data` axis:
each rank holds a contiguous block of the reads on its own device, the
representatives come from all-reduces, and the results from
all-gathers (NCCL between cards, gloo between CPU processes)."""

from genomics_tpu_torch.parallel.mesh import (  # noqa: F401
    data_mesh,
    shard_batch,
    sharded_align_scores,
    sharded_pipeline_step,
)
