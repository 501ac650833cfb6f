"""The data mesh and the sharded pipeline step on `torch.distributed`: the
port's counterpart of `genomics_tpu/parallel/mesh.py`.

Alignment work is embarrassingly parallel across pairs, so the one axis
that matters is `data`: each rank of the process group holds a contiguous
block of the pairs on its own device, runs the same kernels the
single-device entry points launch (`ops.cuda_align`, `ops.cuda_pairhmm`,
`ops.myers`), and the global statistics are all-reduces (the JAX
package's psum / pmax / pmin under shard_map).  A `DataMesh` stands in for
`jax.sharding.Mesh` as the `mesh=` argument of every mesh-taking function
(`models.ngia.cluster_distributed`, `models.msa.msa`).

The TPU pads each shard to 128 lanes and its lengths to a multiple of 8
(`_pad_pair_shard`); here one kernel covers every batch size, so only the
lengths are padded (with N4), where the card's DP kernels walk 8-row
strips.  One field depends on the lane padding: the JAX package's
`tb_checksum` sums the direction nibbles of its padding lanes too, so its
value changes with the mesh's size; the port's sums the real pairs' only
(ROADMAP C23).

Inputs: a numpy array is the global batch (the same on every rank) and is
block-sharded here (`multihost.put_global`); a tensor is this rank's block
already (what `shard_batch` returns).  Per-pair outputs are this rank's
block (`multihost.fetch` gathers them); the globals are 0-d tensors,
the same on every rank.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from genomics_tpu_torch.core.encoding import N4
from genomics_tpu_torch.core.scoring import AlignmentParams
from genomics_tpu_torch.device import checked_device
from genomics_tpu_torch.ops import cuda_align, cuda_pairhmm, myers, scan_align
from genomics_tpu_torch.ops import scan_pairhmm
from genomics_tpu_torch.parallel import multihost

KSW_H0 = 30            # mesh.py:179: the pipeline's seed score
BAND_WIDTH_TILES = 4   # mesh.py:182
# the 4-bit codes' 2-bit map of mesh.py:211-215 and :310-314 (A4 -> 0,
# C4 -> 1, G4 -> 2, T4 -> 3, anything else 255)
_TWO_BIT = torch.full((256,), 255, dtype=torch.uint8)
for _code, _two in ((1, 0), (3, 1), (7, 2), (4, 3)):
    _TWO_BIT[_code] = _two
_NO_BEST = torch.iinfo(torch.int32).min   # an empty block's best score


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """This process's place in the process group: the world `size`, its
    `rank` and its `device` (the rank's card, or the CPU)."""
    size: int
    rank: int
    device: torch.device

    def block(self, n: int) -> tuple[int, int]:
        """[lo, hi) of this rank's rows of an n-row batch."""
        return multihost.block(n, self.size, self.rank)


def data_mesh(n_devices: int | None = None, device="cuda") -> DataMesh:
    """The 1-D `data` mesh of the process group (world size 1 without one):
    this rank on cuda:{rank % device_count} for device="cuda", or the CPU.
    `n_devices`, where given, must be the group's size: the process group
    is the mesh."""
    dev = checked_device(device)
    size, rank = ((dist.get_world_size(), dist.get_rank())
                  if dist.is_initialized() else (1, 0))
    if n_devices is not None and n_devices != size:
        raise ValueError(f"a mesh of {n_devices} devices needs a process "
                         f"group of that size; this one has {size}")
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return DataMesh(size, rank, dev)


def shard_batch(mesh: DataMesh, *arrays):
    """Each host array's block for this rank, on its device."""
    return tuple(multihost.put_global(mesh, a) for a in arrays)


def _local(mesh: DataMesh, x) -> torch.Tensor:
    """A numpy array is the global batch: its block; a tensor is the block
    already (moved to the mesh's device)."""
    if isinstance(x, np.ndarray):
        return multihost.put_global(mesh, x)
    return torch.as_tensor(x).to(mesh.device)


def _pad_len8(x: torch.Tensor) -> torch.Tensor:
    """[b, L] codes padded with N4 to L a multiple of 8 (the card's DP
    kernels walk 8-row strips; the JAX shard pads the same way)."""
    pad = (-x.shape[1]) % 8
    if not pad:
        return x.contiguous()
    return torch.cat([x, x.new_full((x.shape[0], pad), N4)], dim=1)


def _global_best(mesh: DataMesh, score: torch.Tensor):
    """(the best score over every rank, the lowest rank holding it): the
    nGIA representative pattern, a max then a min all-reduce."""
    local = (score.max() if score.numel() else
             torch.tensor(_NO_BEST, device=score.device)).to(torch.int32)
    best = multihost.all_reduce(local.clone(), "max")
    owner = torch.where(local == best,
                        torch.tensor(mesh.rank, device=score.device),
                        torch.tensor(1 << 30, device=score.device))
    return best, multihost.all_reduce(owner.to(torch.int32), "min")


def sharded_align_scores(mesh: DataMesh, q, t, params: AlignmentParams,
                         use_pallas: bool = True, has_n: bool | None = None):
    """Data-parallel local alignment scores: each rank's block through the
    score-only kernel (`cuda_align.local_align_scores`; the plain version
    with use_pallas=False), then the global best by an all-reduce.

    `has_n=False` asserts the batch has no in-sequence N (padding N is
    fine), which lets the kernel drop its N compare; None detects it on
    the host when the inputs are host arrays, else assumes True
    (mesh.py:106-128).  Returns (this rank's [b] int32 scores, the global
    best as a 0-d int32 tensor)."""
    if has_n is None:
        has_n = (bool((q == N4).any() or (t == N4).any())
                 if isinstance(q, np.ndarray) and isinstance(t, np.ndarray)
                 else True)
    q, t = _local(mesh, q), _local(mesh, t)
    if use_pallas:
        score = cuda_align.local_align_scores(q, t, params, has_n=has_n)
    else:
        score = scan_align.local_align_batch(q, t, params).score
    best = score.max() if score.numel() else torch.tensor(
        _NO_BEST, device=q.device)
    return score, multihost.all_reduce(best.to(torch.int32), "max")


def _eq_masks(q2: torch.Tensor, W: int) -> torch.Tensor:
    """[b, Lq] 2-bit codes (255 matches nothing) -> [b, 4, W] int64 match
    masks, on q2's device (mesh.py:196-205)."""
    b, Lq = q2.shape
    words = q2.new_full((b, W * 32), 255)
    words[:, :Lq] = q2
    wview = words.view(b, W, 32).long()
    shifts = torch.arange(32, device=q2.device, dtype=torch.int64)
    return torch.stack([((wview == s).long() << shifts).sum(dim=2)
                        for s in range(4)], dim=1)


def two_bit(codes: torch.Tensor) -> torch.Tensor:
    """4-bit codes -> 2-bit (A4 -> 0, C4 -> 1, G4 -> 2, T4 -> 3, else
    255), on the codes' device."""
    return _TWO_BIT.to(codes.device)[codes.long()]


def sharded_pipeline_step(mesh: DataMesh, q, t, qlen, tlen, reads, haps,
                          rlen, clen, bq, iq, dq,
                          params: AlignmentParams, use_pallas: bool = True,
                          q2bit=None) -> dict:
    """The multi-rank step: on each rank's block, local_sw END, SCORE
    (has_n=False; SCORE16 where the scores fit int16) and TB, global_sw,
    ksw_extend from h0 = 30, banded_sw over 4 tiles, Myers on the 2-bit
    codes, and PairHMM through the wavefront and the inter-task kernels;
    then the global best, its owner and the summed likelihood by
    all-reduces (mesh.py:132-316).  `use_pallas=False` runs the plain
    versions, with Myers' best and the checksum 0 and the inter-task
    likelihood the plain one, as the JAX package's does.

    Returns the 12-key dict of mesh.py:147-160: per-pair [b] tensors of
    this rank's block and 0-d globals."""
    q, t, qlen, tlen, reads, haps, rlen, clen, bq, iq, dq = (
        _local(mesh, x) for x in (q, t, qlen, tlen, reads, haps, rlen,
                                  clen, bq, iq, dq))
    q2bit = two_bit(q) if q2bit is None else _local(mesh, q2bit)
    b = q.shape[0]
    if use_pallas:
        qp, tp = _pad_len8(q), _pad_len8(t)
        sw_score = cuda_align.local_align(qp, tp, params).score
        sw_fast = cuda_align.local_align_scores(qp, tp, params, has_n=False)
        tb = cuda_align.local_align(qp, tp, params, with_tb=True).tb
        tb_checksum = (tb & 0xF).sum(dtype=torch.int64)
        nw_score = cuda_align.global_align(qp, tp, qlen, tlen, params).score
        h0 = torch.full((b,), KSW_H0, dtype=torch.int32, device=q.device)
        ksw_score = cuda_align.ksw_align(qp, tp, qlen, tlen, h0,
                                         params).score
        banded_score = cuda_align.banded_align(qp, tp, qlen, tlen, params,
                                               BAND_WIDTH_TILES).score
        # the 2-bit query against the 2-bit target (mesh.py:188-226)
        eq = _eq_masks(q2bit, (q.shape[1] + 31) // 32)
        myers_best = myers.myers_batch(eq, qlen, two_bit(tp), tlen)[0]
        lik = cuda_pairhmm.pairhmm_forward(reads, haps, rlen, clen, bq, iq,
                                           dq)
        lik2 = cuda_pairhmm.pairhmm_forward_intertask_prepared(
            reads, haps, rlen, clen,
            scan_pairhmm.prepare_params(bq, iq, dq))
    else:
        sw_score = scan_align.local_align_batch(q, t, params).score
        sw_fast = sw_score
        nw_score = scan_align.global_align_batch(q, t, qlen, tlen,
                                                 params).score
        h0 = torch.full((b,), KSW_H0, dtype=torch.int32, device=q.device)
        ksw_score = scan_align.ksw_align_batch(q, t, qlen, tlen, h0,
                                               params).score
        banded_score = scan_align.banded_align_batch(
            q, t, qlen, tlen, params, BAND_WIDTH_TILES).score
        myers_best = torch.zeros(b, dtype=torch.int32, device=q.device)
        tb_checksum = torch.zeros((), dtype=torch.int64, device=q.device)
        lik = scan_pairhmm.pairhmm_forward_batch(reads, haps, rlen, clen,
                                                 bq, iq, dq)
        lik2 = lik
    best, owner = _global_best(mesh, sw_score)
    total = multihost.all_reduce(lik.sum(dtype=torch.float32), "sum")
    return {
        "sw_score": sw_score,
        "sw_score_fast": sw_fast,
        "nw_score": nw_score,
        "ksw_score": ksw_score,
        "banded_score": banded_score,
        "myers_best": myers_best,
        "likelihood": lik,
        "likelihood_intertask": lik2,
        "tb_checksum": multihost.all_reduce(tb_checksum, "sum"),
        "global_best_sw": best,
        "global_best_owner": owner,
        "total_likelihood": total,
    }
