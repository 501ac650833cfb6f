"""Multi-process helpers on `torch.distributed`: the port's counterpart of
`genomics_tpu/parallel/multihost.py`.

The reference's only distributed component is nGIA's MPI ring
(CDP/CLUSTER/cluster/src/func.cu:10-26: MPI_Init and the rank -> GPU
binding; 306-318: the per-round Gather / min / Bcast; 520: the final
Gather).  Here every process is one rank of a process group, holds a
contiguous block of the batch on its own device, and the collectives are
`torch.distributed`'s:

- `initialize(...)`      the MPI_Init analog: `init_process_group` with
                         the backend given, or the device's (NCCL for
                         the card, gloo for the CPU); a backend that
                         cannot start raises, nothing switches to another
- `put_global(mesh, a)`  host numpy (the same on every rank) -> this
                         rank's axis-0 block on the rank's device, the
                         block shard of the JAX package's P("data")
- `fetch(x)`             this rank's block -> the whole array as host
                         numpy on every rank (all-gather; the MPI_Gather
                         of func.cu:520)
- `all_reduce(x, op)`    psum / pmax / pmin

Without a process group every helper acts on one rank (world size 1):
the collectives are then the identity.  With one (even of world size 1,
as `chip_smoke.py` runs NCCL) every collective goes through it.
"""
from __future__ import annotations

import datetime

import numpy as np
import torch
import torch.distributed as dist

from genomics_tpu_torch.device import checked_device

# init_process_group's and every collective's timeout (seconds): a rank
# that dies raises on the others instead of hanging them
TIMEOUT_S = 300
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, backend: str | None = None,
               device="cuda") -> None:
    """Join (or start) the process group: `init_method` (e.g.
    "file:///tmp/rdv" or "tcp://localhost:29500"; None reads the env://
    variables), `world_size` and `rank` as `init_process_group` takes
    them.  The backend is `backend`, or "nccl" for a CUDA `device` and
    "gloo" for the CPU; with NCCL the rank's card becomes the current
    device.  Raises where the backend cannot start."""
    dev = checked_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    if dev.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def block(n: int, size: int, rank: int) -> tuple[int, int]:
    """[lo, hi) of `rank`'s contiguous block of n rows over `size` ranks:
    blocks of ceil(n / size) rows, the last ones shorter (or empty)."""
    step = -(-n // size) if n else 0
    lo = min(rank * step, n)
    return lo, min(lo + step, n)


def put_global(mesh, arr, axis: str | None = "data") -> torch.Tensor:
    """Host array (the same on every rank) -> this rank's axis-0 block of
    it on the mesh's device (`block`); `axis=None` replicates the whole
    array."""
    arr = np.asarray(arr)
    if axis is not None:
        lo, hi = block(arr.shape[0], mesh.size, mesh.rank)
        arr = arr[lo:hi]
    return torch.from_numpy(np.ascontiguousarray(arr)).to(mesh.device)


def all_reduce(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """`x` reduced over the ranks ("sum", "max" or "min"), in place;
    returns it."""
    if dist.is_initialized():
        dist.all_reduce(x, op=_OPS[op])
    return x


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """Every rank's `x` (any axis-0 length) concatenated in rank order, on
    x's device: the lengths are gathered first and each block padded to
    the longest."""
    if not dist.is_initialized():
        return x
    size = dist.get_world_size()
    n = torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device)
    ns = [torch.empty_like(n) for _ in range(size)]
    dist.all_gather(ns, n)
    ns = [int(v) for v in ns]
    top = max(ns)
    pad = x.new_zeros((top, *x.shape[1:]))
    pad[:x.shape[0]] = x
    parts = [torch.empty_like(pad) for _ in range(size)]
    dist.all_gather(parts, pad.contiguous())
    return torch.cat([p[:k] for p, k in zip(parts, ns)])


def fetch(x) -> np.ndarray:
    """This rank's block -> the whole array as host numpy on every rank,
    all-gathered over the process group (the MPI_Gather of func.cu:520);
    a 0-d tensor (a global, the same on every rank) is the rank's own
    copy."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    if x.dim() == 0:
        return x.cpu().numpy()
    return all_gather(x).cpu().numpy()
