"""NW application (reference: CDP/NW): square NxN global alignment with
MATCH=+1, MISMATCH=INS=DEL=-1 linear gaps, full-matrix output.  The
counterpart of `genomics_tpu/models/nw.py`.

`nw_matrix` takes the plain version (a row scan, the left-gap chain a
`torch.cummax`, line for line `nw.py:51-86`) for tensors on the CPU and
launches `csrc/nw_app.cu` (replacing the jnp `nw_matrix`, nw.py:51) for
tensors on a CUDA device; any other device raises.  The kernel cuts the
rows into stripes of STRIPE rows, one warp a stripe walking the columns
left to right, each stripe waiting on a progress flag of the one above
(stripes taken from an atomic ticket): a call is one memset of the flags
and one kernel launch, whatever N (`launches_per_call`).

Also the app's query generator (main.cu:41-62 mutation model), verify
(main.cu:29-39) and driver.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from genomics_tpu_torch import _build
from genomics_tpu_torch.core import golds
from genomics_tpu_torch.device import checked_device, on_cpu

MATCH, MISMATCH, INSERTION, DELETION = 1, -1, -1, -1
STRIPE = 128   # csrc/nw_app.cu's kStripe: rows a warp

# Kernel launches; the wrapper adds one where it calls the kernel's entry
# point, which makes `launches_per_call` CUDA launches.
LAUNCHES = {"nw_app": 0}

_vp, _ci = ctypes.c_void_p, ctypes.c_int
# reference, query, out, flags [stripes + 1], N, max_grid, stream
_ARGS = (_vp, _vp, _vp, _vp, _ci, _ci, _vp)


def generate_query(reference: np.ndarray, rng: np.random.Generator):
    """The app's mutated-query generator: 80% match / 10% ins / 10% del
    (main.cu:41-62), byte alphabet."""
    N = len(reference)
    out = np.empty(N, np.uint8)
    r = q = 0
    while r < N and q < N:
        p = rng.random()
        if p < 0.80:
            out[q] = reference[r]
            q += 1
            r += 1
        elif p < 0.90:
            out[q] = rng.integers(0, 256)
            q += 1
        else:
            r += 1
    while q < N:
        out[q] = rng.integers(0, 256)
        q += 1
    return out


def launches_per_call(N: int) -> int:
    """CUDA launches of one `nw_matrix` call on the card: the flags'
    memset and the kernel (none at N = 0)."""
    return 2 if N else 0


def nw_matrix_plain(reference: torch.Tensor, query: torch.Tensor):
    """The plain version of `nw_matrix`, on the inputs' device: one row
    at a time, the left-gap chain as a running max (nw.py:51-86)."""
    N = reference.shape[0]
    dev = reference.device
    ridx = torch.arange(N, dtype=torch.int32, device=dev)
    rdel = ridx * DELETION
    out = torch.empty((N, N), dtype=torch.int32, device=dev)
    # boundaries: matrix[-1][r] = (r+1)*DELETION; matrix[q][-1] = (q+1)*INSERTION
    prev = (ridx + 1) * DELETION  # virtual row -1
    diag_shift = torch.empty(N, dtype=torch.int32, device=dev)
    for q in range(N):
        sub = torch.where(query[q] == reference, MATCH, MISMATCH)
        top = prev + INSERTION
        # topleft: matrix[q-1][r-1], boundary q*INSERTION at r == 0
        diag_shift[0] = q * INSERTION
        diag_shift[1:] = prev[:-1]
        best = torch.maximum(top, diag_shift + sub)
        # left-gap prefix: m[r] = max(best[r], m[r-1] + DELETION), with
        # m[-1] = (q+1)*INSERTION.  Via v[r] = m[r] - r*DELETION:
        # v = max(cummax(best - r*D), (q+1)*I + D)
        seed = (q + 1) * INSERTION + DELETION
        v = torch.cummax(best - rdel, 0).values.clamp_min_(seed)
        out[q] = v + rdel
        prev = out[q]
    return out


def nw_matrix(reference: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Full [N, N] int32 score matrix (row q, col r) of two [N] uint8
    sequences, on their device: the output the app's verify() checks
    elementwise."""
    if reference.dim() != 1 or query.shape != reference.shape:
        raise ValueError(f"reference and query must be [N] of one length; "
                         f"got {tuple(reference.shape)}, {tuple(query.shape)}")
    if reference.dtype != torch.uint8 or query.dtype != torch.uint8:
        raise TypeError(f"reference and query must be uint8; got "
                        f"{reference.dtype}, {query.dtype}")
    if query.device != reference.device:
        raise ValueError(f"inputs on {reference.device} and {query.device}")
    if on_cpu(reference):
        return nw_matrix_plain(reference, query)
    N = reference.shape[0]
    out = torch.empty((N, N), dtype=torch.int32, device=reference.device)
    if N:
        launch_nw(reference.contiguous(), query.contiguous(), out)
    return out


def launch_nw(reference, query, out, flags=None, grid=None):
    """Call csrc/nw_app.cu's entry point (N > 0) on contiguous inputs and
    count it; fills `out`.  `flags`, an int32 buffer of `flag_words(N)`
    (allocated here if None), is zeroed by the call; `grid` caps the
    kernel's blocks, one warp each (card tests: fewer warps than stripes,
    so that warps take more than one ticket)."""
    N = reference.shape[0]
    if flags is None:
        flags = torch.empty(flag_words(N), dtype=torch.int32,
                            device=out.device)
    _build.launch("nw_app", "nw_app_launch", _ARGS, out.device, reference,
                  query, out, flags, N, grid or 0)
    LAUNCHES["nw_app"] += 1
    return out


def flag_words(N: int) -> int:
    """The kernel's flags: the stripes' ticket and each stripe's progress."""
    return -(-N // STRIPE) + 1


def verify(matrix_cpu: np.ndarray, matrix_gpu: np.ndarray) -> bool:
    """Elementwise check, first mismatch reported (main.cu:29-39)."""
    if np.array_equal(matrix_cpu, matrix_gpu):
        return True
    q, r = np.argwhere(matrix_cpu != matrix_gpu)[0]
    print(
        f"Mismatch at q = {q}, r = {r} "
        f"(CPU result = {matrix_cpu[q, r]}, GPU result = {matrix_gpu[q, r]})"
    )
    return False


def run(N: int = 256, seed: int = 0, verify_against_cpu: bool = True,
        device="cuda"):
    """The app's driver: random reference, mutated query, the DP on
    `device` (the card unless told), optional CPU-gold verification.
    Returns the final score."""
    dev = checked_device(device)
    rng = np.random.default_rng(seed)
    reference = rng.integers(0, 256, N).astype(np.uint8)
    query = generate_query(reference, rng)
    mat = nw_matrix(torch.from_numpy(reference).to(dev),
                    torch.from_numpy(query).to(dev)).cpu().numpy()
    if verify_against_cpu:
        if not verify(golds.nw_cpu(reference, query), mat):
            raise AssertionError("device matrix does not match nw_cpu")
    return int(mat[-1, -1])
